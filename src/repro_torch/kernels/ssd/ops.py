"""SSD dispatch: the CUDA kernel (``kernel.py``) or the plain PyTorch
version (``ref.py``), the counterpart of ``repro/kernels/ssd/ops.py``.

The kernel path is differentiable through ``_SSD``: its forward is the
CUDA kernel, its backward recomputes the scan through ``ref.ssd`` and
differentiates that. The reference's Pallas kernel has no VJP of its own:
its gradient is ``jax.grad`` of the jnp path it runs off the TPU, the same
function. The recompute is that design, not a fallback: the forward never
runs the plain version in the kernel's place. A hand-written backward
kernel is ROADMAP Queue 2 step B.

The kernel's launch is the PyTorch operator
``torch.ops.repro_torch.ssd_chunked``: on real tensors it is the launch
and nothing else; on meta tensors (``launch.dryrun``) its fake
implementation allocates what the launch allocates and launches nothing;
``FlopCounterMode`` counts it as the plain version's FLOPs
(``kernels._flops``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.device import takes_kernels
from repro_torch.kernels import _autograd, _flops
from repro_torch.kernels.ssd import kernel as K
from repro_torch.kernels.ssd import ref


@torch.library.custom_op("repro_torch::ssd_chunked", mutates_args=())
def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, A_log: torch.Tensor, D: torch.Tensor,
                state: torch.Tensor,
                chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``kernel.ssd_chunked``: one launch of the CUDA kernel."""
    return K.ssd_chunked(x, dt, B, C, A_log, D, state, chunk=chunk)


@ssd_chunked.register_fake
def _(x, dt, B, C, A_log, D, state, chunk):
    # the launch's allocations: A_log and D widened to f32, y and the new
    # state
    b, S, H, P = x.shape
    N = B.shape[-1]
    A_log.to(torch.float32)
    D.to(torch.float32)
    return (x.new_empty((b, S, H, P), dtype=torch.float32),
            x.new_empty((b, H, P, N), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.ssd_chunked)
def _(x, dt, B, C, A_log, D, state, chunk, *, out_shape=None, **kw):
    return _flops.chunked_flops(ref.ssd, (x, dt, B, C, A_log, D, state),
                                (1, 1, 1, 1, -1, -1, -1), chunk)


# Forward: the kernel's operator on contiguous inputs. Backward: the
# gradients of ``ref.ssd`` at the saved inputs against the incoming (gy,
# gstate), under the profiler range ``ssd_recompute_bwd``.
_SSD = _autograd.recompute_function(
    "_SSD", "ssd_recompute_bwd",
    lambda *a, chunk: ssd_chunked(*a, int(chunk)), ref.ssd)


def ssd(x, dt, B, C, A_log, D, state, *, chunk: int = 128,
        use_kernel: Optional[bool] = None):
    """Shapes as in ``ref.ssd``; returns (y f32, state_out f32).

    ``use_kernel=None`` launches the CUDA kernel for CUDA tensors (and
    takes its operator for meta tensors: ``device.takes_kernels``) and runs
    the plain version for CPU tensors (native autograd); ``True`` asks for
    the kernel (and raises on CPU tensors); ``False`` runs the plain
    version."""
    if use_kernel is None:
        use_kernel = takes_kernels(x)
        if not use_kernel and x.device.type != "cpu":
            raise ValueError(f"no ssd path for device {x.device}")
    if use_kernel:
        return _SSD.apply({"chunk": chunk}, x, dt, B, C, A_log, D, state)
    return ref.ssd(x, dt, B, C, A_log, D, state, chunk=chunk)
