"""ctypes binding of the CUDA flash attention forward
(``csrc/flash_attention.cu``).

The Hopper counterpart of the Pallas ``flash_attention_fwd``: one launch
computes the whole (B, Hq, Sq) output, one thread block per (query tile,
head, batch) walking the key tiles with the online softmax: bf16 inputs on
the tensor cores (``mma.sync``, tiles of 128 rows), float32 on the CUDA
cores (tiles of 64). The
library builds on the first call on a CUDA device
(``repro_torch.kernels._build``); importing this module needs no
``nvcc``. ``launches()`` counts the launches this process made, so a run
can show that its prefills went through the kernel.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build

_count_lock = threading.Lock()
_launches = 0
_entry = None

SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may have
MAX_D = 128
BQ = BKV = 64  # query rows of a block, keys of a tile (as in the source)
BQ_TC = 128  # query rows of a block of the bf16 tensor-core kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def launches() -> int:
    """Kernel launches made by ``flash_attention_fwd`` in this process."""
    return _launches


def reset_launches() -> None:
    global _launches
    with _count_lock:
        _launches = 0


def smem_bytes(D: int, esize: int) -> int:
    """Dynamic shared memory of one block (``bf16_smem_bytes`` and
    ``smem_floats`` in the source). bf16 (``esize`` 2): the q tile of
    ``BQ_TC`` rows and two stages of a key and a value tile, in bf16, D
    padded to a multiple of 16, rows 8 elements longer. float32: q and k
    transposed with padded rows, v, and p transposed, in float32."""
    if esize == 2:
        return (BQ_TC + 4 * BKV) * (-(-D // 16) * 16 + 8) * 2
    qs, ks = BQ + 4, BKV + 1
    p_offset = (D * qs + D * ks + BKV * D + 3) // 4 * 4
    return 4 * (p_offset + BKV * qs)


def _launcher():
    global _entry
    if _entry is None:
        fn = _build.library("flash_attention").flash_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _entry = fn
    return _entry


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); all float32 or all
    bfloat16, contiguous on one CUDA device; Hq a multiple of Hkv, D at most
    128. The causal mask is top-left aligned (query i sees keys 0..i).
    Returns (B, Sq, Hq, D) in q's dtype, a new tensor. Launches once on the
    current stream and does not wait."""
    global _launches
    dev = q.device
    ins = {"q": q, "k": k, "v": v}
    if not q.is_cuda or any(t.device != dev for t in ins.values()):
        raise ValueError("flash attention kernel needs q, k, v on one CUDA "
                         "device, got " + ", ".join(
                             f"{n} on {t.device}" for n, t in ins.items()))
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention kernel takes q, k, v all float32 "
                        f"or all bfloat16, got {[t.dtype for t in ins.values()]}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash attention kernel takes (B, S, H, D) q, k, v, "
                         f"got {tuple(q.shape)} and {tuple(k.shape)}")
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Skv, Hkv, D) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash attention kernel shapes disagree: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    if min(B, Sq, Skv, Hq, Hkv) < 1 or Hq % Hkv or not 1 <= D <= MAX_D \
            or B > 65535 or Hq > 65535:
        raise ValueError(f"flash attention kernel shape out of range (Hq a "
                         f"multiple of Hkv, D up to {MAX_D}): "
                         f"{(B, Sq, Skv, Hq, Hkv, D)}")
    if window < 0 or not softcap >= 0:
        raise ValueError(f"flash attention kernel takes window >= 0 and "
                         f"softcap >= 0, got {window} and {softcap}")
    if not all(t.is_contiguous() for t in ins.values()):
        raise ValueError("flash attention kernel needs contiguous inputs")
    o = torch.empty_like(q)
    launch = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    B, Sq, Skv, Hq, Hkv, D, int(bool(causal)), int(window),
                    float(softcap), _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA "
                           f"error {rc}")
    with _count_lock:
        _launches += 1
    return o
