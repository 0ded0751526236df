"""WKV6 dispatch: the CUDA kernel (``kernel.py``) or the plain PyTorch
version (``ref.py``), the counterpart of ``repro/kernels/wkv6/ops.py``."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.wkv6 import kernel as K
from repro_torch.kernels.wkv6 import ref


def wkv6(r, k, v, w, u, state, *, chunk: int = 32,
         use_kernel: Optional[bool] = None):
    """Shapes as in ``ref.wkv6``; returns (y f32, state_out f32).

    ``use_kernel=None`` launches the CUDA kernel for CUDA tensors and runs
    the plain version for CPU tensors; ``True`` asks for the kernel (and
    raises on CPU tensors); ``False`` runs the plain version. The kernel
    has no backward yet: its path refuses inputs that require grad, which
    the plain version differentiates natively."""
    if use_kernel is None:
        use_kernel = r.is_cuda
        if not use_kernel and r.device.type != "cpu":
            raise ValueError(f"no wkv6 path for device {r.device}")
    if use_kernel:
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (r, k, v, w, u, state)):
            raise NotImplementedError(
                "the wkv6 kernel has no backward yet (ROADMAP Queue 1 "
                "item 8, the ssm/hybrid training slice); run under "
                "torch.no_grad() or use_kernel=False")
        return K.wkv6_chunked(r, k, v, w, u, state, chunk=chunk)
    return ref.wkv6(r, k, v, w, u, state, chunk=chunk)
