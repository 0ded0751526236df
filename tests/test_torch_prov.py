"""The port's provenance layer against the reference's, on the CPU.

Op streams run on ``prov=True`` mounts of both packages, and the layer is
wrapped onto and unwrapped from live mounts with ``wrap_layer`` and
``unwrap_layer``. Records carry ``ts = ks.time()``, the pid and the
executing thread, and their JSON length moves the on-disk log, so both
packages' ``KernelServices.time`` is pinned to one constant and both run
in the test's thread: then ``read_provenance()`` records, results and
device images must be identical. The port's version of the reference's
prov-window test (``tests/test_upgrade_torture.py``) runs on port mounts.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.services as R_svc  # noqa: E402
import repro.fs.crashsim as R_crashsim  # noqa: E402
import repro.fs.mounts as R_mounts  # noqa: E402
import repro_torch.core.services as T_svc  # noqa: E402
import repro_torch.fs.mounts as T_mounts  # noqa: E402
from repro.core.upgrade import unwrap_layer as R_unwrap  # noqa: E402
from repro.core.upgrade import wrap_layer as R_wrap  # noqa: E402
from repro.fs.prov import ProvFilesystem as R_Prov  # noqa: E402
from repro_torch.core.interface import Errno, FsError  # noqa: E402
from repro_torch.core.upgrade import UpgradeError, unwrap_layer, wrap_layer  # noqa: E402
from repro_torch.fs.prov import PROV_LOG_NAME, ProvFilesystem  # noqa: E402
from test_torch_fs_slice import (PORT, REF, _image, _ref_binding,  # noqa: E402
                                 apply, op_stream)

TS = 1.7e9


@pytest.fixture
def pinned(monkeypatch):
    """The reference bound to blockhash at each of its binding sites, and
    both packages' record timestamps pinned."""
    for mod in (R_svc, R_mounts, R_crashsim):
        monkeypatch.setattr(mod, "kernel_binding", _ref_binding)
    for svc in (R_svc, T_svc):
        monkeypatch.setattr(svc.KernelServices, "time", lambda self: TS)


@pytest.mark.parametrize("kind", ["bento", "ext4like", "overlay-bento"])
def test_prov_mount_op_stream_matches_reference(pinned, kind):
    ref = R_mounts.make_mount(kind, 4096, prov=True)
    port = T_mounts.make_mount(kind, 4096, device="cpu", prov=True)
    assert isinstance(port.mount.module, ProvFilesystem)
    ops = op_stream(seed=20 + len(kind))
    assert apply(PORT, port, ops) == apply(REF, ref, ops)
    recs = port.view.read_provenance()
    assert recs == ref.view.read_provenance()
    assert {r["op"] for r in recs} >= {"mkdir", "create", "write", "rename"}
    assert all(r["ts"] == TS for r in recs)
    assert PROV_LOG_NAME not in port.view.listdir("/")
    ref.close()
    port.close()
    assert np.array_equal(_image(port.dev), _image(ref.dev))


def _live_swaps(mf, wrap, unwrap, prov_cls):
    """plain → prov → plain → prov on a live mount; returns what the
    layer logged in each prov window and the swaps' generations."""
    v = mf.view
    v.mkdir("/d")
    v.write_file("/d/plain0", b"p" * 5000)
    wrap(mf.mount, prov_cls)
    v.create("/d/b0")
    v.write_file("/d/b0", b"B" * 9000, create=False)
    v.mkdir("/d/sub")
    v.rename("/d/b0", "/d/sub/b1")
    v.unlink("/d/plain0")
    first = v.read_provenance()
    unwrap(mf.mount)
    v.write_file("/d/plain1", b"q" * 300)
    wrap(mf.mount, prov_cls)
    v.create("/d/b2")
    v.truncate("/d/sub/b1", 100)
    second = v.read_provenance()
    unwrap(mf.mount)
    return first, second, mf.mount.generation


@pytest.mark.parametrize("kind", ["bento", "ext4like"])
def test_live_wrap_unwrap_matches_reference(pinned, kind):
    ref = R_mounts.make_mount(kind, 4096)
    port = T_mounts.make_mount(kind, 4096, device="cpu")
    got = _live_swaps(port, wrap_layer, unwrap_layer, ProvFilesystem)
    want = _live_swaps(ref, R_wrap, R_unwrap, R_Prov)
    assert got == want
    first, second, _ = got
    assert [r["op"] for r in first] == \
        ["create", "write", "mkdir", "rename", "unlink"]
    # the second window adopts the durable log and appends after it
    assert second[:len(first)] == first
    assert [r["op"] for r in second[len(first):]] == ["create", "truncate"]
    ref.close()
    port.close()
    assert np.array_equal(_image(port.dev), _image(ref.dev))


def _swap_on(mf):
    if mf.kind == "fuse":
        res = mf.mount.wrap_prov()
        return res["pause_s"], res["generation"]
    stats = wrap_layer(mf.mount, ProvFilesystem)
    return stats["total_s"], mf.mount.generation


def _swap_off(mf):
    if mf.kind == "fuse":
        return mf.mount.unwrap_prov()["pause_s"]
    return unwrap_layer(mf.mount)["total_s"]


@pytest.mark.parametrize("kind", ["bento", "ext4like", "fuse"])
def test_swap_captures_exactly_the_prov_window(kind):
    """Phase A (plain) → wrap → phase B (prov) → unwrap → phase C (plain):
    the log holds exactly phase B's mutations, in execution order, on the
    port's in-process mounts and through its FUSE daemon alike."""
    mf = T_mounts.make_mount(kind, n_blocks=4096, device="cpu")
    v = mf.view
    v.mkdir("/d")

    v.create("/d/a0")
    v.write_file("/d/a0", b"A" * 2048, create=False)
    with pytest.raises(FsError):
        v.read_provenance()  # no layer mounted yet

    pause_on, _ = _swap_on(mf)
    v.create("/d/b0")
    v.write_file("/d/b0", b"B" * 2048, create=False)
    v.mkdir("/d/sub")
    v.rename("/d/b0", "/d/sub/b1")
    v.unlink("/d/a0")
    live = v.read_provenance()
    pause_off = _swap_off(mf)

    v.create("/d/c0")
    with pytest.raises(FsError):
        v.read_provenance()

    _swap_on(mf)  # the authoritative read: re-wrap adopts the durable log
    recs = v.read_provenance()
    _swap_off(mf)
    assert [r["op"] for r in recs] == \
        ["create", "write", "mkdir", "rename", "unlink"]
    assert [r.get("name") for r in recs] == ["b0", "", "sub", "b0", "a0"]
    assert recs[3]["newname"] == "b1"
    assert [(r["op"], r.get("name")) for r in live] == \
        [(r["op"], r.get("name")) for r in recs]
    assert not any(r.get("name") in ("a0", "c0") and r["op"] == "create"
                   for r in recs)
    assert PROV_LOG_NAME not in v.listdir("/d")
    assert pause_on < 5.0 and pause_off < 5.0
    mf.close()


def test_double_wrap_refused_cleanly():
    """Wrapping an already-wrapped port mount is refused before the gate
    freezes, and the mounted layer keeps serving."""
    mf = T_mounts.make_mount("bento", n_blocks=2048, device="cpu")
    wrap_layer(mf.mount, ProvFilesystem)
    gen = mf.mount.generation
    with pytest.raises(UpgradeError):
        wrap_layer(mf.mount, ProvFilesystem)
    assert mf.mount.generation == gen
    mf.view.create("/still")
    assert mf.view.read_provenance()[-1]["name"] == "still"
    with pytest.raises(FsError) as ei:
        mf.view.create(f"/{PROV_LOG_NAME}")
    assert ei.value.errno == Errno.EINVAL
    mf.close()
