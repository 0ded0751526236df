"""ctypes binding of the CUDA WKV6 kernel (``csrc/wkv6.cu``).

The Hopper counterpart of the Pallas ``wkv6_chunked``: one launch scans a
whole (B, S, H) batch chunk by chunk, with one thread block per (batch,
head) carrying its (K, V) state. The library builds on the first call on a
CUDA device (``repro_torch.kernels._build``); importing this module needs
no ``nvcc``. ``launches()`` counts the launches this process made, so a
run can show that its prefills went through the kernel.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

from repro_torch.kernels import _build

_count_lock = threading.Lock()
_launches = 0
_entry = None

SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may have
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def launches() -> int:
    """Kernel launches made by ``wkv6_chunked`` in this process."""
    return _launches


def reset_launches() -> None:
    global _launches
    with _count_lock:
        _launches = 0


def smem_bytes(K: int, V: int, chunk: int) -> int:
    """Dynamic shared memory of one block (``smem_floats`` in the source)."""
    return 4 * (4 * chunk * (K + 1) + chunk * V + chunk * (chunk + 1)
                + K * V + chunk + K)


def _launcher():
    global _entry
    if _entry is None:
        fn = _build.library("wkv6").wkv6_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _entry = fn
    return _entry


def wkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor, state: torch.Tensor, *,
                 chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, w: (B, S, H, K) and v: (B, S, H, V), all float32 or all
    bfloat16; u: (H, K) in their dtype or float32; state: (B, H, K, V)
    float32. All contiguous on one CUDA device, S a multiple of ``chunk``.
    Returns (y (B, S, H, V) f32, state_out (B, H, K, V) f32), new tensors.
    Launches once on the current stream and does not wait."""
    global _launches
    dev = r.device
    ins = {"r": r, "k": k, "v": v, "w": w, "u": u, "state": state}
    if not r.is_cuda or any(t.device != dev for t in ins.values()):
        raise ValueError("wkv6 kernel needs all inputs on one CUDA device, "
                         "got " + ", ".join(f"{n} on {t.device}"
                                            for n, t in ins.items()))
    if r.dtype not in _DTYPES or any(t.dtype != r.dtype for t in (k, v, w)):
        raise TypeError(f"wkv6 kernel takes r, k, v, w all float32 or all "
                        f"bfloat16, got {[t.dtype for t in (r, k, v, w)]}")
    if u.dtype not in (r.dtype, torch.float32) or state.dtype != torch.float32:
        raise TypeError(f"wkv6 kernel takes u in {r.dtype} or float32 and a "
                        f"float32 state, got {u.dtype} and {state.dtype}")
    if r.dim() != 4:
        raise ValueError(f"wkv6 kernel takes (B, S, H, K) r, got "
                         f"{tuple(r.shape)}")
    B, S, H, K = r.shape
    V = v.shape[-1]
    want = {"k": (B, S, H, K), "w": (B, S, H, K), "v": (B, S, H, V),
            "u": (H, K), "state": (B, H, K, V)}
    bad = {n: tuple(ins[n].shape) for n, s in want.items()
           if tuple(ins[n].shape) != s}
    if bad:
        raise ValueError(f"wkv6 kernel shapes disagree with r "
                         f"{tuple(r.shape)}: {bad}")
    if chunk < 1 or S % chunk:
        raise ValueError(f"wkv6 kernel needs S ({S}) a multiple of the chunk "
                         f"({chunk}); models.rwkv.wkv6_chunked zero-pads")
    if min(B, S, H, K, V) < 1 or B * H >= 2**31:
        raise ValueError(f"wkv6 kernel shape out of range: {(B, S, H, K, V)}")
    if smem_bytes(K, V, chunk) > SMEM_LIMIT:
        raise ValueError(f"wkv6 kernel needs {smem_bytes(K, V, chunk)} bytes "
                         f"of shared memory at K={K}, V={V}, chunk={chunk}; "
                         f"a block has {SMEM_LIMIT}")
    if not all(t.is_contiguous() for t in ins.values()):
        raise ValueError("wkv6 kernel needs contiguous inputs")
    uf = u.to(torch.float32)  # exact; (H, K) is small
    y = torch.empty((B, S, H, V), dtype=torch.float32, device=dev)
    sout = torch.empty((B, H, K, V), dtype=torch.float32, device=dev)
    launch = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                    uf.data_ptr(), state.data_ptr(), y.data_ptr(),
                    sout.data_ptr(), B, S, H, K, V, chunk,
                    _DTYPES[r.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {rc}")
    with _count_lock:
        _launches += 1
    return y, sout
