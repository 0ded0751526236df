"""ctypes binding of the CUDA blockhash kernel (``csrc/blockhash.cu``).

The Hopper counterpart of the Pallas ``blockhash_batch``: one launch
hashes a whole batch of blocks. The library builds on the first call on a
CUDA device (``repro_torch.kernels._build``); importing this module needs
no ``nvcc``. ``launches()`` counts the launches this process made, so a
run can show that its checksums went through the kernel.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build

_count_lock = threading.Lock()
_launches = 0
_entry = None


def launches() -> int:
    """Kernel launches made by ``blockhash_batch`` in this process."""
    return _launches


def reset_launches() -> None:
    global _launches
    with _count_lock:
        _launches = 0


def _launcher():
    global _entry
    if _entry is None:
        fn = _build.library("blockhash").blockhash_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _entry = fn
    return _entry


def blockhash_batch(words: torch.Tensor, pows: torch.Tensor) -> torch.Tensor:
    """words: (nblocks, wpb) int32, pows: (wpb,) int32, both contiguous on
    one CUDA device -> (nblocks,) int32. The int32 tensors carry u32 bit
    patterns. Launches once on the current stream and does not wait."""
    global _launches
    if not (words.is_cuda and pows.device == words.device):
        raise ValueError(f"blockhash kernel needs words and pows on one CUDA "
                         f"device, got {words.device} and {pows.device}")
    if words.dtype != torch.int32 or pows.dtype != torch.int32:
        raise TypeError(f"blockhash kernel takes int32 views of u32 words, "
                        f"got {words.dtype} and {pows.dtype}")
    if words.dim() != 2 or pows.shape != (words.shape[1],):
        raise ValueError(f"blockhash kernel takes (nblocks, wpb) words and "
                         f"(wpb,) pows, got {tuple(words.shape)} and "
                         f"{tuple(pows.shape)}")
    n, wpb = words.shape
    if not (1 <= n < 2**31 and 1 <= wpb < 2**31):
        raise ValueError(f"blockhash kernel needs 1 <= nblocks, wpb < 2^31, "
                         f"got {n} and {wpb}")
    if not (words.is_contiguous() and pows.is_contiguous()):
        raise ValueError("blockhash kernel needs contiguous words and pows")
    out = torch.empty(n, dtype=torch.int32, device=words.device)
    launch = _launcher()
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(words.data_ptr(), pows.data_ptr(), out.data_ptr(),
                    n, wpb, stream)
    if rc != 0:
        raise RuntimeError(f"blockhash kernel launch failed: CUDA error {rc}")
    with _count_lock:
        _launches += 1
    return out
