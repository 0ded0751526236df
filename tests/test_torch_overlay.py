"""The port's CoW overlay tenants against the reference's, on the CPU.

The same base image is built in both packages, and one reference tenant
and one port tenant (``device="cpu"``) run the same path-based step
sequences: the handmade overlay cases and seeded random sequences of
``tests/test_overlay.py``. Every step's result or errno, the merged
``readdir`` listings (inos included: both packages tag base inos alike),
``ov_stats``, the checksum counters, the upper images and the base
image's bytes must be equal.
The reference is bound to the port's blockhash (``blockhash_np``) at each
of its binding sites, so journal commit records match byte for byte.
"""

from __future__ import annotations

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.services as R_svc  # noqa: E402
import repro.fs.crashsim as R_crashsim  # noqa: E402
import repro.fs.mounts as R_mounts  # noqa: E402
import repro_torch.fs.mounts as T_mounts  # noqa: E402
from repro.core.interface import FsError as R_FsError  # noqa: E402
from repro_torch.core.interface import FsError as T_FsError  # noqa: E402
from test_overlay import HANDMADE, gen_steps  # noqa: E402
from test_torch_fs_slice import _image, _norm, _ref_binding  # noqa: E402


@pytest.fixture
def bound(monkeypatch):
    """Bind the reference to blockhash wherever it makes a kernel binding:
    its mounts, its crash simulator, and ``repro.core.services`` (which
    the overlay imports at mount time for the base image)."""
    for mod in (R_svc, R_mounts, R_crashsim):
        monkeypatch.setattr(mod, "kernel_binding", _ref_binding)


def _images(fs_kind):
    return (R_mounts.build_base_image(fs_kind),
            T_mounts.build_base_image(fs_kind, device="cpu"))


def _tenants(images, fs_kind):
    ref_img, port_img = images
    return (R_mounts.overlay_tenant(ref_img, fs_kind),
            T_mounts.overlay_tenant(port_img, fs_kind, device="cpu"))


def _apply(view, step, fs_error):
    op, args = step[0], step[1:]
    try:
        return ("ok", _norm(getattr(view, op)(*args)))
    except fs_error as e:
        return ("err", int(e.errno))


def _listing(view, path="/"):
    """The merged tree by readdir: (path, ino, kind) of every entry, and
    each file's bytes."""
    m = view.m
    out = []
    for name, ino, kind in sorted(m.call("readdir", view._walk(path))):
        full = f"{path.rstrip('/')}/{name}"
        attr = m.call("getattr", ino)
        out.append((full, ino, _norm(kind)))
        if attr.is_dir:
            out.extend(_listing(view, full))
        else:
            out.append(m.call("read", ino, 0, attr.size))
    return out


def _assert_alike(fs_kind, step_lists, *, n_tenants=1):
    """Reference and port tenants over images built alike run the same
    steps; then listings, overlay counters, upper images and the base
    images are compared."""
    images = _images(fs_kind)
    assert np.array_equal(_image(images[0]), _image(images[1]))
    base0 = [(_image(img).copy(), img.writes) for img in images]
    pairs = [_tenants(images, fs_kind) for _ in range(n_tenants)]
    try:
        for t, ((ref, port), steps) in enumerate(zip(pairs, step_lists)):
            for i, step in enumerate(steps):
                want = _apply(ref.view, step, R_FsError)
                got = _apply(port.view, step, T_FsError)
                assert got == want, f"tenant {t} step {i} {step!r}"
            assert _listing(port.view) == _listing(ref.view)
            assert port.mount.module.ov_stats == ref.mount.module.ov_stats
    finally:
        for ref, port in pairs:
            ref.close()
            port.close()
    for ref, port in pairs:
        assert np.array_equal(_image(port.dev), _image(ref.dev))
        assert port.services.counters == ref.services.counters
        assert (port.mount.module.base.ks.counters
                == ref.mount.module.base.ks.counters)
    for img, (data0, writes0) in zip(images, base0):
        assert img.writes == writes0
        assert np.array_equal(_image(img), data0)


@pytest.mark.parametrize("fs_kind", ["xv6", "ext4like"])
@pytest.mark.parametrize("case", range(len(HANDMADE)))
def test_handmade_sequences_match_reference(bound, fs_kind, case):
    _assert_alike(fs_kind, [HANDMADE[case]])


@pytest.mark.parametrize("fs_kind", ["xv6", "ext4like"])
@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5])
def test_seeded_random_sequences_match_reference(bound, fs_kind, seed):
    _assert_alike(fs_kind, [gen_steps(random.Random(seed), 60)])


@pytest.mark.parametrize("fs_kind,seed,nsteps",
                         [("xv6", 38729, 32), ("ext4like", 1979033485, 50)])
def test_saved_hypothesis_example_matches_reference(bound, fs_kind, seed,
                                                    nsteps):
    """The examples on which the reference overlay and a full copy
    disagree (ROADMAP Queue 3: a shrinking truncate keeps its blocks, so
    a later grow reads the cut-off bytes back on the full copy): the
    port's overlay must give exactly the reference overlay's answers."""
    _assert_alike(fs_kind, [gen_steps(random.Random(seed), nsteps)])


def test_many_tenants_one_image_match_reference(bound):
    """Four tenants per package share one image, each running its own
    seeded sequence: each port tenant matches its reference tenant, so no
    tenant sees another's writes, and the images stay untouched."""
    _assert_alike("xv6", [gen_steps(random.Random(s), 40)
                          for s in (11, 12, 13, 14)], n_tenants=4)


def test_cold_remount_matches_reference(bound):
    """Unmount a tenant's upper and mount it again over a fresh lazy view:
    whiteouts and copy-ups survive in both packages alike."""
    import repro.core.registry as R_reg
    import repro.fs.blockdev as R_dev
    import repro.fs.overlay as R_ov
    import repro.fs.posix as R_posix
    import repro_torch.core.registry as T_reg
    import repro_torch.core.services as T_svc
    import repro_torch.fs.blockdev as T_dev
    import repro_torch.fs.overlay as T_ov
    import repro_torch.fs.posix as T_posix

    images = _images("xv6")
    ref, port = _tenants(images, "xv6")
    for mf in (ref, port):
        mf.view.unlink("/etc/motd")
        mf.view.write_file("/etc/hostname", b"tenant-own\n")
        mf.view.mkdir("/etc/new")
        mf.mount.unmount()

    views = []
    for dev_mod, ov, reg, posix, binding, image, upper in (
            (R_dev, R_ov, R_reg, R_posix, _ref_binding, images[0], ref.dev),
            (T_dev, T_ov, T_reg, T_posix,
             lambda d: T_svc.kernel_binding(d, device="cpu"), images[1],
             port.dev)):
        lazy = dev_mod.LazyBlockDevice(image, n_blocks=image.n_blocks,
                                       immutable_base=True)
        fs = ov.OverlayFilesystem(ov.OverlayOptions(kind="xv6",
                                                    base_dev=lazy))
        m = reg.mount("overlay-remount", binding(upper), module=fs)
        views.append((m, posix.PosixView(m)))
    try:
        for m, v in views:
            assert not v.exists("/etc/motd")
            assert v.read_file("/etc/hostname") == b"tenant-own\n"
            assert (v.read_file("/usr/share/words")
                    == b"alpha beta gamma delta\n" * 64)
        assert _listing(views[1][1]) == _listing(views[0][1])
    finally:
        for m, _ in views:
            m.unmount()
    assert np.array_equal(_image(port.dev), _image(ref.dev))


def test_overlay_tenant_on_cpu_never_resolves_cuda(monkeypatch):
    """A ``device="cpu"`` tenant binds its upper AND its base image to the
    CPU: no binding on the tenant's path may fall back to the default
    device, which is CUDA (and raises on a host without one)."""
    import repro_torch.core.services as T_svc

    asked = []
    real = T_svc.resolve_device

    def spy(device=None):
        asked.append(device)
        return real(device)

    monkeypatch.setattr(T_svc, "resolve_device", spy)
    image = T_mounts.build_base_image("xv6", device="cpu")
    mf = T_mounts.overlay_tenant(image, "xv6", device="cpu", prov=True)
    try:
        assert mf.services.device == torch.device("cpu")
        assert mf.mount.module.inner.base.ks.device == torch.device("cpu")
        assert mf.view.read_file("/etc/motd") == b"welcome to the base image\n"
        mf.view.write_file("/etc/motd", b"mine\n")
    finally:
        mf.close()
    assert asked and all(d == "cpu" or d == torch.device("cpu")
                         for d in asked), asked
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T_mounts.overlay_tenant(image, "xv6")
