"""SSD dispatch: the CUDA kernel (``kernel.py``) or the plain PyTorch
version (``ref.py``), the counterpart of ``repro/kernels/ssd/ops.py``."""

from __future__ import annotations

from typing import Optional

from repro_torch.kernels.ssd import kernel as K
from repro_torch.kernels.ssd import ref


def ssd(x, dt, B, C, A_log, D, state, *, chunk: int = 128,
        use_kernel: Optional[bool] = None):
    """Shapes as in ``ref.ssd``; returns (y f32, state_out f32).

    ``use_kernel=None`` launches the CUDA kernel for CUDA tensors and runs
    the plain version for CPU tensors; ``True`` asks for the kernel (and
    raises on CPU tensors); ``False`` runs the plain version."""
    if use_kernel is None:
        use_kernel = x.is_cuda
        if not use_kernel and x.device.type != "cpu":
            raise ValueError(f"no ssd path for device {x.device}")
    if use_kernel:
        return K.ssd_chunked(x, dt, B, C, A_log, D, state, chunk=chunk)
    return ref.ssd(x, dt, B, C, A_log, D, state, chunk=chunk)
