"""Block devices.

Four backends with one interface:

* ``MemBlockDevice`` — host-memory numpy array ("kernel mode" binding; the
  disk is hardware, not compute, so host memory is the honest stand-in).
* ``FileBlockDevice`` — file-backed ("userspace mode" binding, used by the
  FUSE bridge subprocess; O_DIRECT-style full-block transfers only).
* ``TorchBlockDevice`` — the image as a uint8 tensor on a torch device
  (the GPU by default), updated in place.
* ``LazyBlockDevice`` — sparse local store over a remote *provider*:
  blocks are fetched on first read (container cold-start / overlay base
  images — see the materialization protocol below).

All I/O is whole blocks; partial writes are the caller's read-modify-write
(exactly the buffer-cache contract).

Materialization protocol (``LazyBlockDevice``)
----------------------------------------------
A lazy device's local store starts empty except a per-block *valid* bitmap
(all clear). The bitmap is LOCAL DISK STATE — it survives remounts exactly
like data does, and every transition is a counted device write so the
crash-injection harness can lose power between any two steps:

1. ``read_block``/``read_many`` on an invalid block fetches the content
   from the provider (``read_many`` fetches the whole miss run in ONE
   provider round-trip — ``provider_round_trips`` counts interface
   crossings, the cold-start currency).
2. The fetched bytes land in the local store — a counted, torn-capable
   device write. If power dies here (or mid-transfer, leaving a torn
   prefix), the valid bit is still clear: the half-materialized block is
   NEVER visible, and a cold remount simply re-fetches from the provider.
3. The valid bit is set — a second counted write. Only after this commit
   point does the local copy shadow the provider.

``write_block`` always lands locally (the provider is never written) and
sets the valid bit with the data in one counted write, so a local write
permanently shadows the base content. A torn local write to a
still-invalid block leaves the bit clear — the torn prefix is unreachable
and the next read re-fetches, which is "the write never happened": the
same all-or-nothing story the journal gives torn metadata.

Blocks at or beyond ``base_blocks`` have no provider backing: they read
as zeros until written (a sparse local extension — the tenant's own
territory). ``immutable_base=True`` additionally rejects every write
inside the base range, which is how an overlay mount enforces that the
shared base image can never be dirtied by a tenant.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Optional

import numpy as np

from repro_torch.device import DeviceLike, resolve_device

BLOCK_SIZE = 4096


class BlockDeviceError(Exception):
    pass


class BlockDevice:
    """Interface + common checks."""

    block_size: int
    n_blocks: int
    device_id: str

    def read_block(self, blockno: int) -> bytes:
        raise NotImplementedError

    def read_many(self, blocknos) -> "list[bytes]":
        """Vectorized read. The base implementation is a loop; devices
        with a real batch path (``LazyBlockDevice``) override it to serve
        the whole run in one provider round-trip. The buffer cache routes
        its miss runs here."""
        return [self.read_block(b) for b in blocknos]

    def write_block(self, blockno: int, data: bytes) -> None:
        raise NotImplementedError

    def sync(self) -> None:
        pass

    def _check(self, blockno: int, data: Optional[bytes] = None) -> None:
        if not (0 <= blockno < self.n_blocks):
            raise BlockDeviceError(f"block {blockno} out of range 0..{self.n_blocks}")
        if data is not None and len(data) != self.block_size:
            raise BlockDeviceError(
                f"partial write ({len(data)} != {self.block_size}) — "
                "read-modify-write through the buffer cache")

    # --- fault injection (crash-recovery property tests) --------------------------
    fail_after_writes: int = -1  # -1 disabled; else raise after N writes
    fail_torn_bytes: int = -1    # >= 0: the DYING write lands this many
    #   bytes before power dies (a torn block — what a real power cut does
    #   to an in-flight sector transfer; the journal's per-block checksums
    #   must catch it at recovery). Backends that pass a torn_writer to
    #   _maybe_fail honour it (MemBlockDevice and FileBlockDevice both do).
    _writes_seen: int = 0

    def _maybe_fail(self, torn_writer: Optional[Callable[[int], None]]
                    = None) -> None:
        """Write-stream fault injection: count down to the armed crash
        point, then die. ``torn_writer(nbytes)``, when the backend
        provides one and ``fail_torn_bytes`` is armed, lands a partial
        block before the power-loss exception — the torn-write case."""
        if self.fail_after_writes >= 0:
            if self._writes_seen >= self.fail_after_writes:
                if torn_writer is not None and self.fail_torn_bytes >= 0:
                    torn_writer(min(self.fail_torn_bytes, self.block_size))
                raise BlockDeviceError("injected crash: device lost power")
            self._writes_seen += 1


class MemBlockDevice(BlockDevice):
    def __init__(self, n_blocks: int, block_size: int = BLOCK_SIZE,
                 device_id: str = "mem0"):
        self.block_size = block_size
        self.n_blocks = n_blocks
        self.device_id = device_id
        self._data = np.zeros((n_blocks, block_size), dtype=np.uint8)
        self._lock = threading.Lock()
        self.reads = 0
        self.writes = 0

    def read_block(self, blockno: int) -> bytes:
        self._check(blockno)
        with self._lock:
            self.reads += 1
            return self._data[blockno].tobytes()

    def write_block(self, blockno: int, data: bytes) -> None:
        self._check(blockno, data)
        with self._lock:

            def torn(nbytes: int) -> None:
                # the dying write lands a prefix of the block — what a real
                # power cut does to an in-flight sector transfer
                self._data[blockno, :nbytes] = np.frombuffer(
                    data[:nbytes], dtype=np.uint8)

            self._maybe_fail(torn)
            self.writes += 1
            self._data[blockno] = np.frombuffer(data, dtype=np.uint8)

    def snapshot(self) -> "MemBlockDevice":
        """Copy-on-crash snapshot for recovery tests."""
        dev = MemBlockDevice(self.n_blocks, self.block_size, self.device_id)
        dev._data = self._data.copy()
        return dev

    @classmethod
    def from_image(cls, arr: np.ndarray,
                   device_id: str = "mem0") -> "MemBlockDevice":
        """A device holding a copy of ``arr``, a (n_blocks, block_size)
        uint8 image such as another device's ``_data`` — so a mount can
        open (and recover) an image written elsewhere."""
        arr = _check_image(arr)
        dev = cls(arr.shape[0], arr.shape[1], device_id)
        dev._data = arr.copy()
        return dev


class LazyBlockDevice(BlockDevice):
    """Sparse local store over a remote provider (lazy materialization).

    ``provider`` is one of:

    * another ``BlockDevice`` (its ``read_many`` is the batch fetch path),
    * a callable ``fn(blockno) -> bytes`` (generator-style provider; give
      it a ``fetch_many(blocknos) -> list[bytes]`` attribute to batch), or
    * a content map via :meth:`content_provider` — blockno -> BlockStore
      hash, resolved through a content-addressed index.

    See the module docstring for the crash-ordered materialization
    protocol. ``provider_round_trips`` / ``provider_blocks_fetched`` are
    the cold-start counters ``benchmarks/fs_coldstart.py`` asserts on.
    """

    def __init__(self, provider, n_blocks: int,
                 block_size: int = BLOCK_SIZE, device_id: str = "lazy0",
                 base_blocks: Optional[int] = None,
                 immutable_base: bool = False):
        self.block_size = block_size
        self.n_blocks = n_blocks
        self.device_id = device_id
        if isinstance(provider, BlockDevice):
            if provider.block_size != block_size:
                raise BlockDeviceError("provider block size mismatch")
            if base_blocks is None:
                base_blocks = min(provider.n_blocks, n_blocks)
            self._fetch_batch = provider.read_many
        else:
            if base_blocks is None:
                base_blocks = n_blocks
            batch = getattr(provider, "fetch_many", None)
            self._fetch_batch = (batch if batch is not None
                                 else lambda bs: [provider(b) for b in bs])
        if base_blocks > n_blocks:
            raise BlockDeviceError("base range exceeds device size")
        self.provider = provider
        self.base_blocks = base_blocks
        self.immutable_base = immutable_base
        self._data = np.zeros((n_blocks, block_size), dtype=np.uint8)
        self._valid = np.zeros(n_blocks, dtype=bool)
        self._lock = threading.RLock()
        self.reads = 0
        self.writes = 0
        self.provider_round_trips = 0
        self.provider_blocks_fetched = 0

    @classmethod
    def content_provider(cls, store, src_dev, hashes):
        """Provider resolving blocks through a BlockStore content index:
        ``hashes`` maps blockno -> content hash; each fetch reads ANY
        source block carrying that hash (content-addressed, so they are
        all the same bytes)."""
        def fetch(blockno: int) -> bytes:
            h = hashes[blockno]
            owners = store._by_hash.get(h)
            if not owners:
                raise BlockDeviceError(f"content hash {h:#x} not in store")
            return src_dev.read_block(next(iter(owners)))
        return fetch

    def materialized(self, blockno: int) -> bool:
        return bool(self._valid[blockno])

    @property
    def n_materialized(self) -> int:
        return int(self._valid.sum())

    def _fetch(self, blocknos) -> None:
        """One provider round-trip for ``blocknos``, then the two-step
        local commit per block: data write (torn-capable), then valid-bit
        set — each a counted device write, so power loss can land between
        them and must leave the block invisible (protocol steps 2–3)."""
        datas = self._fetch_batch(blocknos)
        self.provider_round_trips += 1
        self.provider_blocks_fetched += len(blocknos)
        for blockno, data in zip(blocknos, datas):
            if len(data) != self.block_size:
                raise BlockDeviceError(
                    f"provider returned {len(data)} bytes for block {blockno}")

            def torn(nbytes: int, _b=blockno, _d=data) -> None:
                self._data[_b, :nbytes] = np.frombuffer(_d[:nbytes],
                                                        dtype=np.uint8)

            self._maybe_fail(torn)  # step 2: data lands locally
            self.writes += 1
            self._data[blockno] = np.frombuffer(data, dtype=np.uint8)
            self._maybe_fail()      # step 3: valid-bit commit point
            self.writes += 1
            self._valid[blockno] = True

    def read_block(self, blockno: int) -> bytes:
        self._check(blockno)
        with self._lock:
            self.reads += 1
            if not self._valid[blockno] and blockno < self.base_blocks:
                self._fetch([blockno])
            return self._data[blockno].tobytes()

    def read_many(self, blocknos) -> "list[bytes]":
        if not isinstance(blocknos, list):
            blocknos = list(blocknos)
        for b in blocknos:
            self._check(b)
        with self._lock:
            self.reads += len(blocknos)
            missing = [b for b in dict.fromkeys(blocknos)
                       if not self._valid[b] and b < self.base_blocks]
            if missing:
                self._fetch(missing)
            return [self._data[b].tobytes() for b in blocknos]

    def prefetch(self, blocknos) -> int:
        """Materialize ``blocknos`` (one provider round-trip) without
        returning data; returns how many blocks were actually fetched."""
        with self._lock:
            missing = [b for b in dict.fromkeys(blocknos)
                       if not self._valid[b] and b < self.base_blocks]
            if missing:
                self._fetch(missing)
            return len(missing)

    def write_block(self, blockno: int, data: bytes) -> None:
        self._check(blockno, data)
        if self.immutable_base and blockno < self.base_blocks:
            raise BlockDeviceError(
                f"block {blockno} is in the immutable base range")
        with self._lock:

            def torn(nbytes: int) -> None:
                # torn prefix lands; the valid bit is NOT set here, so a
                # torn write to a never-materialized block stays invisible
                # (the next read re-fetches the base content)
                self._data[blockno, :nbytes] = np.frombuffer(
                    data[:nbytes], dtype=np.uint8)

            self._maybe_fail(torn)
            self.writes += 1
            self._data[blockno] = np.frombuffer(data, dtype=np.uint8)
            self._valid[blockno] = True

    def snapshot(self) -> "LazyBlockDevice":
        """Copy-on-crash snapshot: local store + valid bitmap copied, the
        provider (immutable by contract) shared."""
        dev = LazyBlockDevice(self.provider, self.n_blocks, self.block_size,
                              self.device_id, base_blocks=self.base_blocks,
                              immutable_base=self.immutable_base)
        dev._fetch_batch = self._fetch_batch
        dev._data = self._data.copy()
        dev._valid = self._valid.copy()
        return dev


class FileBlockDevice(BlockDevice):
    """File-backed device (userspace binding). Whole-block pread/pwrite."""

    def __init__(self, path: str, n_blocks: int, block_size: int = BLOCK_SIZE,
                 device_id: str = "file0"):
        self.block_size = block_size
        self.n_blocks = n_blocks
        self.device_id = device_id
        self.path = path
        flags = os.O_RDWR | os.O_CREAT
        self._fd = os.open(path, flags, 0o644)
        os.ftruncate(self._fd, n_blocks * block_size)
        self._lock = threading.Lock()
        self.reads = 0
        self.writes = 0

    def read_block(self, blockno: int) -> bytes:
        self._check(blockno)
        with self._lock:
            self.reads += 1
            return os.pread(self._fd, self.block_size, blockno * self.block_size)

    def write_block(self, blockno: int, data: bytes) -> None:
        self._check(blockno, data)
        with self._lock:
            # the dying write may TEAR: a prefix of the block lands, the
            # rest never does (fail_torn_bytes) — the FUSE daemon's
            # crash-torture path proves recovery detects this via the
            # journal's per-block checksums
            self._maybe_fail(lambda n: os.pwrite(
                self._fd, data[:n], blockno * self.block_size))
            self.writes += 1
            os.pwrite(self._fd, data, blockno * self.block_size)

    def sync(self) -> None:
        os.fsync(self._fd)

    def close(self) -> None:
        os.close(self._fd)


class TorchBlockDevice(BlockDevice):
    """The image as a (n_blocks, block_size) uint8 tensor on ``device``
    (CUDA when unset; raises if there is none), updated IN PLACE: a block
    write copies the block to the device and overwrites its row.

    Slow by design — every block read is one device->host copy and every
    write one host->device copy; it exists to keep the whole storage
    substrate on the GPU.
    """

    def __init__(self, n_blocks: int, block_size: int = BLOCK_SIZE,
                 device_id: str = "torch0", *, device: DeviceLike = None):
        import torch

        self.block_size = block_size
        self.n_blocks = n_blocks
        self.device_id = device_id
        self._data = torch.zeros((n_blocks, block_size), dtype=torch.uint8,
                                 device=resolve_device(device))
        self._lock = threading.Lock()
        self.reads = 0
        self.writes = 0

    @classmethod
    def from_image(cls, arr: np.ndarray, device: DeviceLike = None,
                   device_id: str = "torch0") -> "TorchBlockDevice":
        """A device holding a copy of ``arr``, a (n_blocks, block_size)
        uint8 image such as a ``MemBlockDevice``'s ``_data``."""
        import torch

        arr = _check_image(arr)
        dev = cls(arr.shape[0], arr.shape[1], device_id, device=device)
        dev._data.copy_(torch.from_numpy(arr.copy()))
        return dev

    def read_block(self, blockno: int) -> bytes:
        self._check(blockno)
        with self._lock:
            self.reads += 1
            return self._data[blockno].cpu().numpy().tobytes()

    def write_block(self, blockno: int, data: bytes) -> None:
        import torch

        self._check(blockno, data)
        with self._lock:
            self._maybe_fail()
            self.writes += 1
            self._data[blockno].copy_(
                torch.frombuffer(bytearray(data), dtype=torch.uint8))


def _check_image(arr: np.ndarray) -> np.ndarray:
    arr = np.asarray(arr)
    if arr.dtype != np.uint8 or arr.ndim != 2:
        raise BlockDeviceError(
            f"an image is a (n_blocks, block_size) uint8 array, got "
            f"{arr.dtype} of shape {arr.shape}")
    return arr
