"""The benchmark mount matrix — paper Table 2 made executable.

  bento    xv6 through the Bento typed boundary, kernel binding,
           group commit + writepages-batched install (inherits the FUSE
           kernel module's optimizations, like the paper's Bento).
  vfs      the same xv6 logic called directly (no capability checks, no op
           gate), write-through cache, per-operation commit — the
           "just written for this evaluation" C baseline.
  ext4like the optimized commercial-grade baseline.

Every kind checksums through the kernel binding on ``device``: the CUDA
blockhash kernel on a CUDA device (the default), its plain PyTorch
version on ``"cpu"``. The ``fuse`` and ``overlay-*`` kinds and
``prov=True`` are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core.interface import FS_OPS as _FS_OPS, execute_batch
from repro_torch.core.registry import mount as bento_mount
from repro_torch.core.services import kernel_binding
from repro_torch.device import DeviceLike
from repro_torch.fs.blockdev import MemBlockDevice
from repro_torch.fs.ext4like import Ext4LikeFileSystem
from repro_torch.fs.posix import PosixView
from repro_torch.fs.xv6 import Xv6FileSystem, Xv6Options, mkfs

_NOT_PORTED = {
    "fuse": "the fuse kind waits for fs/fusebridge.py "
            "(ROADMAP.md Queue 1 item 4)",
    "overlay-bento": "overlay kinds wait for fs/overlay.py "
                     "(ROADMAP.md Queue 1 item 2)",
    "overlay-ext4like": "overlay kinds wait for fs/overlay.py "
                        "(ROADMAP.md Queue 1 item 2)",
}


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
               device: DeviceLike = None, prov: bool = False) -> MountedFs:
    """Build one matrix entry on a fresh ``MemBlockDevice``, checksumming
    on ``device`` (CUDA when unset; raises if there is none).

    ``dedup-bento`` / ``dedup-ext4like`` mount the same modules with the
    content-addressed blockstore enabled (repro_torch.fs.blockstore) —
    plain kinds stay bit-identical to the pre-blockstore format."""
    if prov:
        raise NotImplementedError(
            "prov=True waits for fs/prov.py (ROADMAP.md Queue 1 item 3)")
    if kind in _NOT_PORTED:
        raise NotImplementedError(_NOT_PORTED[kind])

    dedup = kind.startswith("dedup-")
    base_kind = kind[len("dedup-"):] if dedup else kind

    if base_kind == "bento":
        dev = MemBlockDevice(n_blocks)
        ks = kernel_binding(dev, device=device)
        mkfs(ks)
        fs = Xv6FileSystem(Xv6Options(group_commit=True,
                                      batched_install=True, dedup=dedup))
        m = bento_mount("xv6", ks, module=fs)
        return MountedFs(kind, m, PosixView(m), ks, dev)
    if base_kind == "vfs" and not dedup:
        dev = MemBlockDevice(n_blocks)
        ks = kernel_binding(dev, device=device, writeback="through")
        mkfs(ks)
        fs = Xv6FileSystem(Xv6Options(group_commit=False,
                                      batched_install=False))
        fs.init(ks.superblock(), ks)
        m = DirectMount(fs)
        return MountedFs(kind, m, PosixView(m), ks, dev)
    if base_kind == "ext4like":
        dev = MemBlockDevice(n_blocks)
        ks = kernel_binding(dev, device=device)
        mkfs(ks)
        opts = Xv6Options(group_commit=True, batched_install=True,
                          dedup=dedup)
        fs = Ext4LikeFileSystem(opts)
        m = bento_mount("ext4like", ks, module=fs)
        return MountedFs(kind, m, PosixView(m), ks, dev)
    raise KeyError(kind)


ALL_KINDS = ("bento", "vfs", "ext4like")
DEDUP_KINDS = ("dedup-bento", "dedup-ext4like")
