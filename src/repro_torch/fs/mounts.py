"""The benchmark mount matrix — paper Table 2 made executable.

  bento    xv6 through the Bento typed boundary, kernel binding,
           group commit + writepages-batched install (inherits the FUSE
           kernel module's optimizations, like the paper's Bento).
  vfs      the same xv6 logic called directly (no capability checks, no op
           gate), write-through cache, per-operation commit — the
           "just written for this evaluation" C baseline.
  fuse     xv6 in a subprocess behind full serialization (userspace).
  ext4like the optimized commercial-grade baseline.

Every in-process kind checksums through the kernel binding on
``device``: the CUDA blockhash kernel on a CUDA device (the default), its
plain PyTorch version on ``"cpu"``. An overlay tenant's base image
checksums on its upper's device. The ``fuse`` kind's daemon runs the
userspace binding (zlib crc32 over a file-backed device), launches no
kernel and ignores ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core.interface import FS_OPS as _FS_OPS, execute_batch
from repro_torch.core.registry import mount as bento_mount
from repro_torch.core.services import kernel_binding
from repro_torch.device import DeviceLike
from repro_torch.fs.blockdev import LazyBlockDevice, MemBlockDevice
from repro_torch.fs.ext4like import Ext4LikeFileSystem
from repro_torch.fs.fusebridge import FuseMount
from repro_torch.fs.overlay import OverlayFilesystem, OverlayOptions
from repro_torch.fs.posix import PosixView
from repro_torch.fs.xv6 import Xv6FileSystem, Xv6Options, mkfs


class DirectMount:
    """VFS-direct baseline: raw calls into the fs object — no dispatch table,
    no gate, no capability discipline (the unsafe fast path). Also no
    multi-submitter drain: every ``submit`` is its own dispatch, which is
    exactly what "4 threads sharing the scalar path" means in the
    benchmark matrix."""

    def __init__(self, fs):
        self.module = fs
        self.generation = 1
        self.name = "vfs-direct"
        for op in _FS_OPS:
            setattr(self, op, getattr(fs, op))

    def call(self, op, *a, **k):
        return getattr(self.module, op)(*a, **k)

    def submit(self, entries):
        # Same batched surface as Mount.submit, minus the gate (this is the
        # no-discipline baseline): the fs still gets its vectorized paths
        # and chains (SQE_LINK) keep their cancel-on-failure semantics.
        return execute_batch(self.module.submit_batch, list(entries))

    def unmount(self) -> None:
        self.module.flush()
        self.module.destroy()


@dataclasses.dataclass
class MountedFs:
    kind: str
    mount: Any
    view: PosixView
    services: Any = None
    dev: Any = None  # the backing device (in-process kinds; fault injection)

    def close(self) -> None:
        self.mount.unmount()


def make_mount(kind: str, n_blocks: int = 16384, *,
               device: DeviceLike = None, backing_path: str = None,
               reuse: bool = False, prov: bool = False) -> MountedFs:
    """Build one matrix entry, checksumming on ``device`` (CUDA when
    unset; raises if there is none). ``backing_path``/``reuse`` apply to
    the fuse kind only: an explicit backing file location, and whether to
    remount it as-is (skip mkfs; daemon-side journal recovery runs) — the
    FUSE crash-torture path (repro_torch.fs.crashsim.FuseCrashSim).
    ``prov=True`` mounts the module wrapped in the provenance layer from
    the start (the torture/benchmark baseline; the live-swap path goes
    through ``repro_torch.core.upgrade.wrap_layer`` instead).

    ``dedup-bento`` / ``dedup-ext4like`` mount the same modules with the
    content-addressed blockstore enabled (repro_torch.fs.blockstore) —
    plain kinds stay bit-identical to the pre-blockstore format.

    ``overlay-bento`` / ``overlay-ext4like`` mount a CoW overlay tenant
    (repro_torch.fs.overlay): a small writable upper over a freshly
    built, default-populated base image. Sharing ONE image across many
    tenants (the provisioning story) goes through ``build_base_image`` +
    ``overlay_tenant`` instead."""
    def _wrap(fs):
        if not prov:
            return fs
        from repro_torch.fs.prov import ProvFilesystem
        return ProvFilesystem(fs)

    if kind.startswith("overlay-"):
        fs_kind = {"bento": "xv6", "ext4like": "ext4like"}[
            kind[len("overlay-"):]]
        image = build_base_image(fs_kind, device=device)
        return overlay_tenant(image, fs_kind, kind=kind,
                              n_blocks=n_blocks, prov=prov, device=device)

    dedup = kind.startswith("dedup-")
    base_kind = kind[len("dedup-"):] if dedup else kind

    if base_kind == "bento":
        dev = MemBlockDevice(n_blocks)
        ks = kernel_binding(dev, device=device)
        mkfs(ks)
        fs = _wrap(Xv6FileSystem(Xv6Options(group_commit=True,
                                            batched_install=True,
                                            dedup=dedup)))
        m = bento_mount("xv6", ks, module=fs)
        return MountedFs(kind, m, PosixView(m), ks, dev)
    if base_kind == "vfs" and not dedup:
        dev = MemBlockDevice(n_blocks)
        ks = kernel_binding(dev, device=device, writeback="through")
        mkfs(ks)
        fs = _wrap(Xv6FileSystem(Xv6Options(group_commit=False,
                                            batched_install=False)))
        fs.init(ks.superblock(), ks)
        m = DirectMount(fs)
        return MountedFs(kind, m, PosixView(m), ks, dev)
    if base_kind == "fuse" and not dedup:
        m = FuseMount(n_blocks=n_blocks,
                      fs_kind="prov-xv6" if prov else "xv6",
                      backing_path=backing_path, reuse=reuse)
        return MountedFs(kind, m, PosixView(m))
    if base_kind == "ext4like":
        dev = MemBlockDevice(n_blocks)
        ks = kernel_binding(dev, device=device)
        mkfs(ks)
        opts = Xv6Options(group_commit=True, batched_install=True,
                          dedup=dedup)
        fs = _wrap(Ext4LikeFileSystem(opts))
        m = bento_mount("ext4like", ks, module=fs)
        return MountedFs(kind, m, PosixView(m), ks, dev)
    raise KeyError(kind)


# --- CoW overlay provisioning (repro_torch.fs.overlay) ------------------------------


def default_base_populate(view: PosixView) -> None:
    """The deterministic tree the default base image carries: a few dirs
    and files with recognizable content, enough to exercise every merge
    rule (lookup-through, copy-up, whiteouts, nested dirs)."""
    view.mkdir("/etc")
    view.mkdir("/usr")
    view.mkdir("/usr/share")
    view.write_file("/etc/hostname", b"golden\n")
    view.write_file("/etc/motd", b"welcome to the base image\n")
    view.write_file("/usr/share/words", b"alpha beta gamma delta\n" * 64)
    view.write_file("/readme", b"base readme\n")


def build_base_image(fs_kind: str = "xv6", n_blocks: int = 8192,
                     populate=None, *,
                     device: DeviceLike = None) -> MemBlockDevice:
    """Build ONE golden base image: mkfs, run ``populate(view)`` (default
    tree when None), unmount cleanly, checksumming on ``device``. The
    returned device is the shared read-only artifact every tenant's
    ``LazyBlockDevice`` fetches from — the clean unmount matters, because
    an immutable base may never need journal recovery writes."""
    dev = MemBlockDevice(n_blocks)
    ks = kernel_binding(dev, device=device)
    mkfs(ks)
    cls = Ext4LikeFileSystem if fs_kind == "ext4like" else Xv6FileSystem
    fs = cls(Xv6Options(group_commit=True, batched_install=True))
    m = bento_mount("base-image", ks, module=fs)
    (populate or default_base_populate)(PosixView(m))
    m.unmount()
    return dev


def overlay_tenant(image: MemBlockDevice, fs_kind: str = "xv6", *,
                   kind: str = None, n_blocks: int = 4096,
                   ninodes: int = 1024, prov: bool = False,
                   device: DeviceLike = None) -> MountedFs:
    """Provision ONE tenant over a shared base image: a fresh small
    upper device (mkfs'd) plus a per-tenant lazy immutable view of the
    image — O(metadata), never a data copy. Upper and base checksum on
    ``device``. ``MountedFs.dev`` is the UPPER device (the writable side
    fault injection arms)."""
    upper_dev = MemBlockDevice(n_blocks)
    ks = kernel_binding(upper_dev, device=device)
    # a tenant upper holds deltas, not a whole tree: a smaller inode table
    # keeps provisioning (per-tenant mkfs) O(small metadata)
    mkfs(ks, ninodes=ninodes, nlog=64)
    lazy = LazyBlockDevice(image, n_blocks=image.n_blocks,
                           device_id="lazy-base", immutable_base=True)
    fs = OverlayFilesystem(OverlayOptions(kind=fs_kind, base_dev=lazy))
    if prov:
        from repro_torch.fs.prov import ProvFilesystem
        fs = ProvFilesystem(fs)
    m = bento_mount(kind or f"overlay-{fs_kind}", ks, module=fs)
    return MountedFs(kind or f"overlay-{fs_kind}", m, PosixView(m), ks,
                     upper_dev)


ALL_KINDS = ("bento", "vfs", "fuse", "ext4like")
DEDUP_KINDS = ("dedup-bento", "dedup-ext4like")
OVERLAY_KINDS = ("overlay-bento", "overlay-ext4like")
