"""SSD dispatch: the CUDA kernel (``kernel.py``) or the plain PyTorch
version (``ref.py``), the counterpart of ``repro/kernels/ssd/ops.py``.

The kernel path is differentiable through ``_SSD``: its forward is the
CUDA kernel, its backward recomputes the scan through ``ref.ssd`` and
differentiates that. The reference's Pallas kernel has no VJP of its own:
its gradient is ``jax.grad`` of the jnp path it runs off the TPU, the same
function. The recompute is that design, not a fallback: the forward never
runs the plain version in the kernel's place. A hand-written backward
kernel is ROADMAP Queue 2 step B."""

from __future__ import annotations

from typing import Optional

from repro_torch.kernels import _autograd
from repro_torch.kernels.ssd import kernel as K
from repro_torch.kernels.ssd import ref


# Forward: the CUDA kernel on contiguous inputs. Backward: the gradients of
# ``ref.ssd`` at the saved inputs against the incoming (gy, gstate), under
# the profiler range ``ssd_recompute_bwd``.
_SSD = _autograd.recompute_function(
    "_SSD", "ssd_recompute_bwd",
    lambda *a, **kw: K.ssd_chunked(*a, **kw), ref.ssd)


def ssd(x, dt, B, C, A_log, D, state, *, chunk: int = 128,
        use_kernel: Optional[bool] = None):
    """Shapes as in ``ref.ssd``; returns (y f32, state_out f32).

    ``use_kernel=None`` launches the CUDA kernel for CUDA tensors and runs
    the plain version for CPU tensors (native autograd); ``True`` asks for
    the kernel (and raises on CPU tensors); ``False`` runs the plain
    version."""
    if use_kernel is None:
        use_kernel = x.is_cuda
        if not use_kernel and x.device.type != "cpu":
            raise ValueError(f"no ssd path for device {x.device}")
    if use_kernel:
        return _SSD.apply({"chunk": chunk}, x, dt, B, C, A_log, D, state)
    return ref.ssd(x, dt, B, C, A_log, D, state, chunk=chunk)
