"""ctypes binding of the CUDA SSD kernel (``csrc/ssd.cu``).

The Hopper counterpart of the Pallas ``ssd_chunked``: one launch scans a
whole (b, S, H) batch chunk by chunk. bf16 inputs run on the tensor cores
(``mma.sync``), one thread block per (batch, pair of heads) carrying
their (P, N) states; float32 inputs on the CUDA cores, one block per
(batch, head). The library builds on the first call on a
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
MAX_CHUNK = 256  # the CUDA-core kernel's scan runs a token per thread
HEADS_PER_BLOCK = 2  # the tensor-core kernel's: C.B^T is shared by them
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def launches() -> int:
    """Kernel launches made by ``ssd_chunked`` in this process."""
    return _launches


def reset_launches() -> None:
    global _launches
    with _count_lock:
        _launches = 0


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def tensor_core_smem_bytes(P: int, N: int, chunk: int) -> int:
    """Dynamic shared memory of one block of the bf16 tensor-core kernel
    (``bf16_smem_bytes`` in the source): x of ``HEADS_PER_BLOCK`` heads, B
    and C in bf16 with rows 8 elements longer, the heads' states in f32
    with rows of N + 8 floats, and four f32 vectors of the chunk per head;
    P, N and the chunk padded to multiples of 16."""
    pp, np_, cp = _pad16(P), _pad16(N), _pad16(chunk)
    g = HEADS_PER_BLOCK
    return (2 * (g * cp * (pp + 8) + 2 * cp * (np_ + 8))
            + 4 * (g * pp * (np_ + 8) + g * 4 * cp))


def smem_bytes(P: int, N: int, chunk: int, esize: int) -> int:
    """Dynamic shared memory of one block of the kernel the launch picks:
    the tensor-core kernel for bf16 inputs (``esize`` 2) where its padded
    tiles fit a block; else (float32, or bf16 tiles too wide) the
    CUDA-core kernel (``smem_bytes`` in the source): x, B and C of a chunk
    in the input's dtype, M, the state and four per-token vectors in
    float32."""
    if esize == 2 and tensor_core_smem_bytes(P, N, chunk) <= SMEM_LIMIT:
        return tensor_core_smem_bytes(P, N, chunk)
    return (esize * (chunk * P + 2 * chunk * N)
            + 4 * (chunk * chunk + N * P + 4 * chunk + 32))


def _launcher():
    global _entry
    if _entry is None:
        fn = _build.library("ssd").ssd_launch
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _entry = fn
    return _entry


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, A_log: torch.Tensor, D: torch.Tensor,
                state: torch.Tensor, *, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, S, H, P) and B, C: (b, S, N), all float32 or all bfloat16;
    dt: (b, S, H) float32; A_log, D: (H,) in any float dtype (widened to
    float32 here); state: (b, H, P, N) float32. All contiguous on one CUDA
    device; S a multiple of ``chunk``, ``chunk`` a multiple of 8 and at most
    256, P and N multiples of 4. Returns (y (b, S, H, P) f32, state_out
    (b, H, P, N) f32), new tensors. Launches once on the current stream and
    does not wait."""
    global _launches
    dev = x.device
    ins = {"x": x, "dt": dt, "B": B, "C": C, "A_log": A_log, "D": D,
           "state": state}
    if not x.is_cuda or any(t.device != dev for t in ins.values()):
        raise ValueError("ssd kernel needs all inputs on one CUDA device, "
                         "got " + ", ".join(f"{n} on {t.device}"
                                            for n, t in ins.items()))
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd kernel takes x, B, C all float32 or all "
                        f"bfloat16, got {[t.dtype for t in (x, B, C)]}")
    if dt.dtype != torch.float32 or state.dtype != torch.float32:
        raise TypeError(f"ssd kernel takes a float32 dt and state, got "
                        f"{dt.dtype} and {state.dtype}")
    if not (A_log.is_floating_point() and D.is_floating_point()):
        raise TypeError(f"ssd kernel takes float A_log and D, got "
                        f"{A_log.dtype} and {D.dtype}")
    if x.dim() != 4:
        raise ValueError(f"ssd kernel takes (b, S, H, P) x, got "
                         f"{tuple(x.shape)}")
    b, S, H, P = x.shape
    N = B.shape[-1]
    want = {"dt": (b, S, H), "B": (b, S, N), "C": (b, S, N), "A_log": (H,),
            "D": (H,), "state": (b, H, P, N)}
    bad = {n: tuple(ins[n].shape) for n, s in want.items()
           if tuple(ins[n].shape) != s}
    if bad:
        raise ValueError(f"ssd kernel shapes disagree with x "
                         f"{tuple(x.shape)}: {bad}")
    if chunk < 8 or chunk % 8 or chunk > MAX_CHUNK or S % chunk:
        raise ValueError(f"ssd kernel needs a chunk that is a multiple of 8 "
                         f"up to {MAX_CHUNK} ({chunk}) and S ({S}) a multiple "
                         f"of it; models.mamba2.ssd_chunked zero-pads S")
    if min(b, S, H) < 1 or P % 4 or N % 4 or min(P, N) < 4 or b * H >= 2**31:
        raise ValueError(f"ssd kernel shape out of range (P and N multiples "
                         f"of 4): {(b, S, H, P, N)}")
    need = smem_bytes(P, N, chunk, x.element_size())
    if need > SMEM_LIMIT:
        raise ValueError(f"ssd kernel needs {need} bytes of shared memory at "
                         f"P={P}, N={N}, chunk={chunk}, {x.dtype}; a block "
                         f"has {SMEM_LIMIT}")
    if not all(t.is_contiguous() for t in ins.values()):
        raise ValueError("ssd kernel needs contiguous inputs")
    a32 = A_log.to(torch.float32)  # (H,): exact for bf16 parameters
    d32 = D.to(torch.float32)
    y = torch.empty((b, S, H, P), dtype=torch.float32, device=dev)
    sout = torch.empty((b, H, P, N), dtype=torch.float32, device=dev)
    launch = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(x.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(),
                    a32.data_ptr(), d32.data_ptr(), state.data_ptr(),
                    y.data_ptr(), sout.data_ptr(), b, S, H, P, N, chunk,
                    _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"ssd kernel launch failed: CUDA error {rc}")
    with _count_lock:
        _launches += 1
    return y, sout
