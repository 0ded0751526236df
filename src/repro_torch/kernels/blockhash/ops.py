"""Host-facing checksum API used by the kernel-services binding.

A CUDA device launches the CUDA kernel (``kernel.py``), once per call; a
CPU device runs the plain PyTorch version (``ref.py``). Results are
Python ints in [0, 2^32), as the reference package returns them.

A journal commit hashes up to 63 blocks of 4096 bytes, so the kernel
itself takes about a launch's latency and the call around it is the cost.
The words come from one ``b"".join`` of the blocks (each zero-padded to
whole words; the pad is empty for the journal's and the blockstore's
4096-byte blocks). On a CUDA device each call goes through that device's
``_Staging``: reusable pinned host buffers, which the kernel reads and
writes in place, and one call into the library that launches and waits.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Dict, Iterable, List, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.blockhash import kernel as K
from repro_torch.kernels.blockhash import ref


@functools.lru_cache(maxsize=16)
def _pows(wpb: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(ref.powers(wpb).view(np.int32)).to(device)


def blockhash_batch(words: torch.Tensor, pows: torch.Tensor) -> torch.Tensor:
    """(nblocks, wpb) int32 words -> (nblocks,) int32 hashes, on the
    words' device: the CUDA kernel for a CUDA tensor, the plain version
    for a CPU tensor."""
    if words.is_cuda:
        return K.blockhash_batch(words, pows)
    if words.device.type == "cpu":
        return ref.blockhash(words, pows)
    raise ValueError(f"no blockhash path for device {words.device}")


def _words(blocks: Sequence[bytes]) -> np.ndarray:
    """(n, wpb) uint32 words of the blocks, each zero-padded to whole
    words, from one join (a read-only view of the joined bytes). No
    blocks, or blocks of different word counts, raise ValueError, as the
    reference's ``np.stack`` does."""
    sizes = [len(b) for b in blocks]
    if not sizes or (min(sizes) + 3) // 4 != (max(sizes) + 3) // 4:
        raise ValueError(f"checksum_batch takes one or more blocks of one "
                         f"word count, got lengths {sorted(set(sizes))}")
    joined = b"".join(b + b"\0" * (-len(b) % 4) for b in blocks)
    return np.frombuffer(joined, dtype=np.uint32).reshape(
        len(sizes), (sizes[0] + 3) // 4)


class _Staging:
    """One CUDA device's reusable buffers for ``checksum_batch``: pinned
    host words and hashes, which the kernel reads and writes through the
    device's mapping of pinned memory, each grown by doubling. Its lock
    serialises the device's callers (parallel drains can reach
    ``checksum_batch`` from several threads) and is held across the wait
    for the kernel, so no caller rewrites the words while the kernel reads
    them. ``stamps`` holds the host clock at the start of the last call
    and at the end of each of its ``STAGES``: ``chip_smoke.py`` splits a
    call's time with it."""

    MIN_WORDS = 64 * 1024  # one commit: 63 blocks of 1024 words
    STAGES = ("words", "lock", "stage", "device", "convert")

    def __init__(self, device: torch.device):
        self.device = device
        self.lock = threading.Lock()
        self.words_cap = self.blocks_cap = 0
        self.stamps = ()

    def _reserve(self, nblocks: int, nwords: int) -> None:
        if nwords > self.words_cap:
            cap = max(nwords, 2 * self.words_cap, self.MIN_WORDS)
            self.host_words = torch.empty(cap, dtype=torch.int32,
                                          pin_memory=True)
            self.host_u32 = self.host_words.numpy().view(np.uint32)
            self.words_cap = cap
        if nblocks > self.blocks_cap:
            cap = max(nblocks, 2 * self.blocks_cap, 64)
            self.host_out = torch.empty(cap, dtype=torch.int32,
                                        pin_memory=True)
            self.out_u32 = self.host_out.numpy().view(np.uint32)
            self.blocks_cap = cap

    def hash(self, blocks: Sequence[bytes]) -> List[int]:
        """The blocks' hashes: one launch over the pinned words, then a
        wait (one library call)."""
        t0 = time.perf_counter()
        words = _words(blocks)
        n, wpb = words.shape
        if wpb == 0:  # the kernel takes wpb >= 1
            raise ValueError("blockhash kernel needs blocks of at least one "
                             "byte")
        t1 = time.perf_counter()
        with self.lock:
            t2 = time.perf_counter()
            self._reserve(n, words.size)
            np.copyto(self.host_u32[:words.size].reshape(n, wpb), words)
            t3 = time.perf_counter()
            with torch.cuda.device(self.device):  # the library's device
                K.hash_pinned(self.host_words.data_ptr(),
                              _pows(wpb, self.device).data_ptr(),
                              self.host_out.data_ptr(), n, wpb,
                              torch.cuda.current_stream().cuda_stream)
            t4 = time.perf_counter()
            out = self.out_u32[:n].tolist()
            self.stamps = (t0, t1, t2, t3, t4, time.perf_counter())
        return out


_stagings: Dict[torch.device, _Staging] = {}
_stagings_lock = threading.Lock()


def staging(device: torch.device) -> _Staging:
    """The ``_Staging`` of a CUDA device with an index (made once)."""
    st = _stagings.get(device)
    if st is None:
        with _stagings_lock:
            st = _stagings.setdefault(device, _Staging(device))
    return st


def checksum_batch(blocks: Iterable[bytes], *,
                   device: DeviceLike = None) -> List[int]:
    """Checksum many blocks of one word count in one kernel launch."""
    dev = resolve_device(device)
    blocks = list(blocks)
    if dev.type == "cuda":
        return staging(dev).hash(blocks)
    words = _words(blocks)
    out = blockhash_batch(torch.from_numpy(words.view(np.int32).copy()),
                          _pows(words.shape[1], dev))
    # int32 bit patterns -> u32 values: about half the hashes are negative
    # as int32, and the journal packs them with struct "<I"
    return out.numpy().view(np.uint32).tolist()


def checksum(data: bytes, *, device: DeviceLike = None) -> int:
    """Checksum one block (journal commit-record entries)."""
    return checksum_batch([data], device=device)[0]
