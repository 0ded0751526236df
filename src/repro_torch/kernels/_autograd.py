"""The kernels' autograd Functions (``flash_attention.ops._FlashAttention``,
``wkv6.ops._WKV6``, ``ssd.ops._SSD``), one design: the forward is the CUDA
kernel, the backward runs the plain version again at the saved inputs and
differentiates it against the outputs' incoming gradients, under a named
range (``repro_torch.ranges``)."""

from __future__ import annotations

import torch

from repro_torch import ranges


def recompute_grads(name, plain, saved, needs, out_grads):
    """Gradients of ``plain(*saved)`` (one output or a tuple) against
    ``out_grads``, for the inputs that ``needs`` (``ctx.needs_input_grad``)
    marks, each in its input's dtype; None for the others. An output
    gradient may be None (an output the caller dropped); an input that no
    used output reaches gets zeros."""
    pairs = [(i, g) for i, g in enumerate(out_grads) if g is not None]
    if not any(needs) or not pairs:
        return [None] * len(saved)
    with torch.enable_grad(), ranges.named(name):
        inputs = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
        outs = plain(*inputs)
        if isinstance(outs, torch.Tensor):
            outs = (outs,)
        pairs = [(outs[i], g) for i, g in pairs if outs[i].requires_grad]
        wanted = [t for t, n in zip(inputs, needs) if n]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wanted,
                                       [g for _, g in pairs],
                                       allow_unused=True)
                   if pairs else [None] * len(wanted))
    grads = []
    for t, n in zip(inputs, needs):
        if not n:
            grads.append(None)
            continue
        g = next(got)
        grads.append(torch.zeros_like(t) if g is None else g.to(t.dtype))
    return grads


def recompute_function(cls_name, name, kernel, plain):
    """A ``torch.autograd.Function`` named ``cls_name`` whose
    ``apply(kw, *tensors)`` returns ``kernel(*tensors, **kw)`` on
    contiguous tensors and whose backward is ``recompute_grads`` of
    ``plain(*tensors, **kw)`` under the profiler range ``name``. ``kw``
    holds the non-tensor arguments. The profiler records the forward under
    ``cls_name``, so ``name`` must differ from it: the range then times
    the backward alone."""

    def forward(ctx, kw, *tensors):
        tensors = tuple(t.contiguous() for t in tensors)
        ctx.save_for_backward(*tensors)
        ctx.kw = kw
        ctx.set_materialize_grads(False)
        return kernel(*tensors, **kw)

    def backward(ctx, *out_grads):
        grads = recompute_grads(name, lambda *a: plain(*a, **ctx.kw),
                                ctx.saved_tensors, ctx.needs_input_grad[1:],
                                out_grads)
        return (None, *grads)

    return type(cls_name, (torch.autograd.Function,),
                {"forward": staticmethod(forward),
                 "backward": staticmethod(backward)})
