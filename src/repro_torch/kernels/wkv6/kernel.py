"""ctypes binding of the CUDA WKV6 kernel (``csrc/wkv6.cu``).

The Hopper counterpart of the Pallas ``wkv6_chunked``: one launch scans a
whole (B, S, H) batch chunk by chunk, with one thread block per (batch,
head) carrying its (K, V) state. bf16 inputs with K and V multiples of 8
run on the tensor cores (``mma.sync``, float32 operands split into bf16
high + remainder), float32 inputs and other bf16 widths on the CUDA cores
in float32. The library builds on the first call on a CUDA device
(``repro_torch.kernels._build``); importing this module needs no
``nvcc``. ``launches()`` counts the launches this process made, so a
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


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def tensor_core_smem_bytes(K: int, V: int, chunk: int) -> int:
    """Dynamic shared memory of one block of the bf16 tensor-core kernel
    (``TcLayout`` in the source), K, V and the chunk padded to multiples of
    16: the state transposed in f32 (rows of K + 8 floats), Li and Le in
    f32 (rows of K + 4), u, the chunk's decay and the sums of its segments
    of 8 tokens; two stages of r, k, w, v and the split r exp(Le), kd and
    k~ in bf16 (rows 8 elements longer); tmp split in bf16 (rows of chunk
    + 8); the table of a segment's 36 pairs, padded to 48 bytes."""
    kp, vp, cp = _pad16(K), _pad16(V), _pad16(chunk)
    ks, vs = kp + 8, vp + 8
    return (4 * (vp * (kp + 8) + 2 * cp * (kp + 4) + 2 * kp + cp // 8 * kp)
            + 2 * (2 * (3 * cp * ks + cp * vs) + 6 * cp * ks
                   + 2 * cp * (cp + 8))
            + 48)


def uses_tensor_cores(K: int, V: int, chunk: int, esize: int) -> bool:
    """Whether the launch picks the tensor-core kernel: bf16 inputs
    (``esize`` 2), K and V multiples of 8 (rows that cp.async moves in
    16-byte pieces), and tiles that fit a block (``takes_tc`` in the
    source)."""
    return (esize == 2 and K % 8 == 0 and V % 8 == 0
            and tensor_core_smem_bytes(K, V, chunk) <= SMEM_LIMIT)


def smem_bytes(K: int, V: int, chunk: int, esize: int = 4) -> int:
    """Dynamic shared memory of one block of the kernel the launch picks:
    ``tensor_core_smem_bytes`` where ``uses_tensor_cores``; else the
    CUDA-core kernel's (``smem_floats`` in the source), the same for both
    dtypes since it widens every input to float32."""
    if uses_tensor_cores(K, V, chunk, esize):
        return tensor_core_smem_bytes(K, V, chunk)
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
    need = smem_bytes(K, V, chunk, r.element_size())
    if need > SMEM_LIMIT:
        raise ValueError(f"wkv6 kernel needs {need} bytes of shared memory "
                         f"at K={K}, V={V}, chunk={chunk}, {r.dtype}; a "
                         f"block has {SMEM_LIMIT}")
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
