"""Plain versions of the journal block-checksum kernel.

Polynomial hash over u32 words: h = sum_i word_i * P^(n-1-i)  (mod 2^32),
P = 0x01000193 (FNV prime). ``blockhash`` is the plain PyTorch version the
CPU path runs and the CUDA kernel is held against; ``blockhash_np`` is the
numpy oracle on raw bytes.
"""

from __future__ import annotations

import numpy as np
import torch

PRIME = np.uint32(0x01000193)


def powers(n: int) -> np.ndarray:
    """[P^(n-1), ..., P^1, P^0] mod 2^32, by doubling: the first k powers
    times P^k are the next k (uint32 products wrap mod 2^32), so a shard
    file of millions of words takes log2(n) vector steps."""
    asc = np.ones(1, dtype=np.uint32)  # P^0 .. P^(k-1)
    step = int(PRIME)  # P^k
    while len(asc) < n:
        asc = np.concatenate([asc, asc * np.uint32(step)])
        step = (step * step) & 0xFFFFFFFF
    return asc[:n][::-1].copy()


def blockhash(words: torch.Tensor, pows: torch.Tensor) -> torch.Tensor:
    """words: (n, wpb) int32, pows: (wpb,) int32 -> (n,) int32.

    Both hold u32 bit patterns in int32 (torch has little uint32
    arithmetic), and so does the result. The sign-extended int32 product
    is exact in int64 and congruent to the u32 product mod 2^32; masking
    each product to its low 32 bits keeps the sum of a row of fewer than
    2^31 words below 2^63, so nothing overflows before the final mask."""
    prod = (words.to(torch.int64) * pows.to(torch.int64)) & 0xFFFFFFFF
    h = prod.sum(dim=-1) & 0xFFFFFFFF
    return torch.where(h >= 2**31, h - 2**32, h).to(torch.int32)


def blockhash_np(data: bytes) -> int:
    pad = (-len(data)) % 4
    arr = np.frombuffer(data + b"\0" * pad, dtype=np.uint32)
    p = powers(len(arr))
    return int(np.sum(arr.astype(np.uint64) * p.astype(np.uint64)) & 0xFFFFFFFF)
