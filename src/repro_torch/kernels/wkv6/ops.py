"""WKV6 dispatch: the CUDA kernel (``kernel.py``) or the plain PyTorch
version (``ref.py``), the counterpart of ``repro/kernels/wkv6/ops.py``.

The kernel path is differentiable through ``_WKV6``: its forward is the
CUDA kernel, its backward recomputes the scan through ``ref.wkv6`` and
differentiates that. The reference's Pallas kernel has no VJP of its own:
its gradient is ``jax.grad`` of the jnp path it runs off the TPU, the same
function. The recompute is that design, not a fallback: the forward never
runs the plain version in the kernel's place. A hand-written backward
kernel is ROADMAP Queue 2 step B.

The kernel's launch is the PyTorch operator
``torch.ops.repro_torch.wkv6_chunked``: on real tensors it is the launch
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
from repro_torch.kernels.wkv6 import kernel as K
from repro_torch.kernels.wkv6 import ref


@torch.library.custom_op("repro_torch::wkv6_chunked", mutates_args=())
def wkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
                 chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``kernel.wkv6_chunked``: one launch of the CUDA kernel."""
    return K.wkv6_chunked(r, k, v, w, u, state, chunk=chunk)


@wkv6_chunked.register_fake
def _(r, k, v, w, u, state, chunk):
    # the launch's allocations: u widened to f32, y and the new state
    B, S, H, K_ = r.shape
    V = v.shape[-1]
    u.to(torch.float32)
    return (r.new_empty((B, S, H, V), dtype=torch.float32),
            r.new_empty((B, H, K_, V), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.wkv6_chunked)
def _(r, k, v, w, u, state, chunk, *, out_shape=None, **kw):
    return _flops.chunked_flops(ref.wkv6, (r, k, v, w, u, state),
                                (1, 1, 1, 1, -1, -1), chunk)


# Forward: the kernel's operator on contiguous inputs. Backward: the
# gradients of ``ref.wkv6`` at the saved inputs against the incoming (gy,
# gstate), under the profiler range ``wkv6_recompute_bwd``.
_WKV6 = _autograd.recompute_function(
    "_WKV6", "wkv6_recompute_bwd",
    lambda *a, chunk: wkv6_chunked(*a, int(chunk)), ref.wkv6)


def wkv6(r, k, v, w, u, state, *, chunk: int = 32,
         use_kernel: Optional[bool] = None):
    """Shapes as in ``ref.wkv6``; returns (y f32, state_out f32).

    ``use_kernel=None`` launches the CUDA kernel for CUDA tensors (and
    takes its operator for meta tensors: ``device.takes_kernels``) and runs
    the plain version for CPU tensors (native autograd); ``True`` asks for
    the kernel (and raises on CPU tensors); ``False`` runs the plain
    version."""
    if use_kernel is None:
        use_kernel = takes_kernels(r)
        if not use_kernel and r.device.type != "cpu":
            raise ValueError(f"no wkv6 path for device {r.device}")
    if use_kernel:
        return _WKV6.apply({"chunk": chunk}, r, k, v, w, u, state)
    return ref.wkv6(r, k, v, w, u, state, chunk=chunk)
