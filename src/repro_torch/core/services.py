"""Kernel Services API (BentoKS, paper §4.5–4.7).

Extensions never touch raw devices or kernel structures; they call these
methods with capability proof. Two bindings expose the SAME API (paper §4.9
— same code in kernel and userspace):

* ``kernel_binding``   — blockhash checksums: the CUDA kernel on a CUDA
                         device, its plain PyTorch version on ``"cpu"``,
* ``userspace_binding`` — file-backed device, zlib crc32.

Swap the binding, not the file system.
"""

from __future__ import annotations

import functools
import threading
import time as _time
import zlib
from typing import Callable, List, Optional

from repro_torch.core.capability import (BlockDeviceCap, CapabilityError,
                                         SuperBlockCap, mint_blockdev,
                                         mint_superblock)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fs.blockdev import BlockDevice
from repro_torch.fs.buffercache import BufferCache, BufferHead


class _SbState:
    """Kernel-side superblock object wrapped by SuperBlockCap."""

    def __init__(self, dev: BlockDevice, cache: BufferCache):
        self.block_size = dev.block_size
        self.n_blocks = dev.n_blocks
        self.device_id = dev.device_id
        self.cache = cache


class KernelServices:
    """What a Bento file system may do to the kernel."""

    def __init__(self, dev: BlockDevice, *, checksum: Callable[[bytes], int],
                 checksum_batch: Optional[Callable] = None,
                 writeback: str = "delayed", cache_capacity: int = 4096,
                 binding: str = "kernel", device=None):
        self._dev = dev
        self.binding = binding
        # the torch device a kernel binding checksums on (None for the
        # userspace binding): an overlay binds its base image to the same
        self.device = device
        self._cache = BufferCache(dev, capacity=cache_capacity,
                                  writeback=writeback)
        self._sb_state = _SbState(dev, self._cache)
        self._checksum = checksum
        self._checksum_batch = checksum_batch
        self._log: List[str] = []
        # Batching observability: the fs_micro --batched acceptance check
        # reads these (one checksum_batch launch per flushed batch, bulk
        # bread instead of per-block bread).
        self.counters = {"checksum_calls": 0, "checksum_batch_calls": 0,
                         "checksum_blocks": 0, "bread_many_calls": 0,
                         "bread_many_blocks": 0}
        # counter increments are read-modify-writes; concurrent read units
        # (parallel multi-submitter drain) share them
        self._counter_lock = threading.Lock()

    # --- capabilities ---------------------------------------------------------------
    def superblock(self) -> SuperBlockCap:
        return mint_superblock(self._sb_state)

    def blockdev_cap(self) -> BlockDeviceCap:
        return mint_blockdev(self._dev)

    @staticmethod
    def _cache_of(sb: SuperBlockCap) -> BufferCache:
        if not isinstance(sb, SuperBlockCap):
            raise CapabilityError("sb_bread requires a SuperBlockCap")
        return sb._raw().cache

    # --- block I/O (the sb_bread family, §4.5) -----------------------------------------
    def sb_bread(self, sb: SuperBlockCap, blockno: int) -> BufferHead:
        return self._cache_of(sb).bread(blockno)

    def sb_bread_many(self, sb: SuperBlockCap, blocknos,
                      fetched=None) -> List[BufferHead]:
        """Batched sb_bread: one cache pass for a whole submission batch.
        Heads come back in request order; each must still be released
        (brelse / context exit) — ownership rules are per-buffer.
        ``fetched`` collects device-fetched blocknos for verified reads."""
        blocknos = list(blocknos)
        with self._counter_lock:
            self.counters["bread_many_calls"] += 1
            self.counters["bread_many_blocks"] += len(blocknos)
        return self._cache_of(sb).bread_many(blocknos, fetched=fetched)

    def sb_brelse_many(self, sb: SuperBlockCap,
                       heads: List[BufferHead]) -> None:
        """Batched brelse: release a bread_many batch's heads under one
        cache-lock acquisition instead of one per head."""
        self._cache_of(sb).brelse_many(heads)

    def sb_getblk_zero(self, sb: SuperBlockCap, blockno: int) -> BufferHead:
        return self._cache_of(sb).getblk_zero(blockno)

    def bwrite_sync(self, sb: SuperBlockCap, bh: BufferHead) -> None:
        self._cache_of(sb).write_now(bh)

    def flush(self, sb: SuperBlockCap, blocknos: Optional[List[int]] = None) -> int:
        """Batched writeback — the `writepages` analogue."""
        return self._cache_of(sb).flush(blocknos)

    def n_dirty(self, sb: SuperBlockCap) -> int:
        return self._cache_of(sb).n_dirty

    def sb_invalidate_blocks(self, sb: SuperBlockCap, blocknos) -> None:
        """Drop specific cached blocks (no writeback) so the next read
        refetches the device — the journal's chain-member rollback path."""
        self._cache_of(sb).invalidate_blocks(blocknos)

    # --- misc services -----------------------------------------------------------------
    def create_lock(self) -> threading.RLock:
        return threading.RLock()

    def checksum(self, data: bytes) -> int:
        with self._counter_lock:
            self.counters["checksum_calls"] += 1
        return self._checksum(data)

    def checksum_batch(self, blocks) -> List[int]:
        """Checksum many blocks in one call — the journal commit path uses
        this so the blockhash kernel launches once per transaction, not
        once per block."""
        blocks = list(blocks)
        with self._counter_lock:
            self.counters["checksum_batch_calls"] += 1
            self.counters["checksum_blocks"] += len(blocks)
        if self._checksum_batch is not None:
            return self._checksum_batch(blocks)
        return [self._checksum(b) for b in blocks]

    def time(self) -> float:
        return _time.time()

    def log_warn(self, msg: str) -> None:
        self._log.append(msg)

    # --- teardown ----------------------------------------------------------------------
    def unmount_checks(self) -> None:
        self._cache.flush()
        self._cache.assert_no_leaks()


def _crc32_zlib(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def kernel_binding(dev: BlockDevice, *, device: DeviceLike = None,
                   **kw) -> KernelServices:
    """Kernel-mode services: blockhash checksums on ``device`` (CUDA when
    unset; raises if there is none). A CUDA device launches the CUDA
    kernel, ``"cpu"`` runs the plain PyTorch version. The probe at bind
    time builds and checks the kernel here rather than at the first
    commit, and a failure raises. The kernel's modules load here, not
    with this one, so the userspace binding never loads ``torch``."""
    from repro_torch.kernels.blockhash import ops as bh_ops
    from repro_torch.kernels.blockhash.ref import blockhash_np

    device = resolve_device(device)
    got = bh_ops.checksum(b"probe", device=device)  # probe at bind time
    if got != blockhash_np(b"probe"):
        raise RuntimeError(f"blockhash probe on {device} gave {got:#010x}, "
                           f"expected {blockhash_np(b'probe'):#010x}")
    return KernelServices(
        dev, checksum=functools.partial(bh_ops.checksum, device=device),
        checksum_batch=functools.partial(bh_ops.checksum_batch, device=device),
        binding="kernel", device=device, **kw)


def userspace_binding(dev: BlockDevice, **kw) -> KernelServices:
    return KernelServices(dev, checksum=_crc32_zlib, binding="userspace", **kw)
