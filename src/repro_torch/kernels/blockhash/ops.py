"""Host-facing checksum API used by the kernel-services binding.

A CUDA device launches the CUDA kernel (``kernel.py``), once per call; a
CPU device runs the plain PyTorch version (``ref.py``). Results are
Python ints in [0, 2^32), as the reference package returns them.
"""

from __future__ import annotations

import functools
from typing import Iterable, List

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


def _words(blocks: Iterable[bytes]) -> torch.Tensor:
    """Zero-pad each block to whole words and join them into one
    (n, wpb) int32 tensor (a fresh, writable array: np.stack copies)."""
    arrs = []
    for data in blocks:
        pad = (-len(data)) % 4
        arrs.append(np.frombuffer(data + b"\0" * pad, dtype=np.uint32))
    return torch.from_numpy(np.stack(arrs).view(np.int32))


def checksum_batch(blocks, *, device: DeviceLike = None) -> List[int]:
    """Checksum many equal-length blocks in one kernel launch."""
    dev = resolve_device(device)
    words = _words(blocks).to(dev)
    out = blockhash_batch(words, _pows(words.shape[1], dev))
    # int32 bit patterns -> u32 values: about half the hashes are negative
    # as int32, and the journal packs them with struct "<I"
    return [x & 0xFFFFFFFF for x in out.tolist()]


def checksum(data: bytes, *, device: DeviceLike = None) -> int:
    """Checksum one block (journal commit-record entries)."""
    return checksum_batch([data], device=device)[0]
