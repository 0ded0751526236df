"""Flash attention dispatch: the CUDA kernel (``kernel.py``) or the plain
PyTorch version (``ref.py``), the counterpart of
``repro/kernels/flash_attention/ops.py``.

The kernel path is differentiable through ``_FlashAttention``: its forward
is the CUDA kernel, its backward recomputes the attention through
``ref.attention`` and differentiates that, the design of the reference's
``custom_vjp`` (whose ``_bwd`` runs ``jax.vjp`` of ``ref.attention``). The
recompute is that design, not a fallback: the forward never runs the plain
version in the kernel's place. A hand-written backward kernel is ROADMAP
Queue 2 step B.

The kernel's launch is the PyTorch operator
``torch.ops.repro_torch.flash_attention_fwd``: on real tensors it is the
launch and nothing else; on meta tensors (``launch.dryrun``) its fake
implementation allocates what the launch allocates and launches nothing;
``FlopCounterMode`` counts it as the plain version's FLOPs
(``kernels._flops``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.device import takes_kernels
from repro_torch.kernels import _autograd, _flops
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ref


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=())
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, window: int,
                        softcap: float) -> torch.Tensor:
    """``kernel.flash_attention_fwd``: one launch of the CUDA kernel."""
    return K.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                 softcap=softcap)


@flash_attention_fwd.register_fake
def _(q, k, v, causal, window, softcap):
    return torch.empty_like(q)  # the launch's one allocation


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _(q, k, v, causal, window, softcap, *, out_shape=None, **kw):
    return _flops.plain_flops(ref.attention, (q, k, v), causal=causal,
                              window=window, softcap=softcap)


# Forward: the kernel's operator on contiguous q, k, v. Backward: the
# gradients of ``ref.attention`` at the saved inputs, under the profiler
# range ``flash_recompute_bwd``.
_FlashAttention = _autograd.recompute_function(
    "_FlashAttention", "flash_recompute_bwd",
    lambda q, k, v, *, causal, window, softcap: flash_attention_fwd(
        q, k, v, bool(causal), int(window), float(softcap)),
    ref.attention)


def flash_attention(q, k, v, causal=True, window=0, softcap=0.0,
                    use_kernel: Optional[bool] = None):
    """q: (B,Sq,Hq,D); k,v: (B,Skv,Hkv,D). Returns (B,Sq,Hq,D) in q's dtype.

    ``use_kernel=None`` launches the CUDA kernel for CUDA tensors (and
    takes its operator for meta tensors: ``device.takes_kernels``) and runs
    the plain version for CPU tensors (native autograd); ``True`` asks for
    the kernel (and raises on CPU tensors); ``False`` runs the plain
    version."""
    if use_kernel is None:
        use_kernel = takes_kernels(q)
        if not use_kernel and q.device.type != "cpu":
            raise ValueError(f"no flash attention path for device {q.device}")
    if use_kernel:
        return _FlashAttention.apply(
            {"causal": causal, "window": window, "softcap": softcap},
            q, k, v)
    return ref.attention(q, k, v, causal=causal, window=window,
                         softcap=softcap)
