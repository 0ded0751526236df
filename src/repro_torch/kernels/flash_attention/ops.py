"""Flash attention dispatch: the CUDA kernel (``kernel.py``) or the plain
PyTorch version (``ref.py``), the counterpart of
``repro/kernels/flash_attention/ops.py``.

The kernel path is differentiable through ``_FlashAttention``: its forward
is the CUDA kernel, its backward recomputes the attention through
``ref.attention`` and differentiates that, the design of the reference's
``custom_vjp`` (whose ``_bwd`` runs ``jax.vjp`` of ``ref.attention``). The
recompute is that design, not a fallback: the forward never runs the plain
version in the kernel's place. A hand-written backward kernel is ROADMAP
Queue 2 step B."""

from __future__ import annotations

from typing import Optional

from repro_torch.kernels import _autograd
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ref


# Forward: the CUDA kernel on contiguous q, k, v. Backward: the gradients of
# ``ref.attention`` at the saved inputs, under the profiler range
# ``flash_recompute_bwd``.
_FlashAttention = _autograd.recompute_function(
    "_FlashAttention", "flash_recompute_bwd",
    lambda *a, **kw: K.flash_attention_fwd(*a, **kw), ref.attention)


def flash_attention(q, k, v, causal=True, window=0, softcap=0.0,
                    use_kernel: Optional[bool] = None):
    """q: (B,Sq,Hq,D); k,v: (B,Skv,Hkv,D). Returns (B,Sq,Hq,D) in q's dtype.

    ``use_kernel=None`` launches the CUDA kernel for CUDA tensors and runs
    the plain version for CPU tensors (native autograd); ``True`` asks for
    the kernel (and raises on CPU tensors); ``False`` runs the plain
    version."""
    if use_kernel is None:
        use_kernel = q.is_cuda
        if not use_kernel and q.device.type != "cpu":
            raise ValueError(f"no flash attention path for device {q.device}")
    if use_kernel:
        return _FlashAttention.apply(
            {"causal": causal, "window": window, "softcap": softcap},
            q, k, v)
    return ref.attention(q, k, v, causal=causal, window=window,
                         softcap=softcap)
