"""Flash attention dispatch: the CUDA kernel (``kernel.py``) or the plain
PyTorch version (``ref.py``), the counterpart of
``repro/kernels/flash_attention/ops.py``.

The reference wraps its kernel in a ``custom_vjp`` whose backward
recomputes through ``ref.attention``. That backward belongs to the
training slice (ROADMAP Queue 1 item 8); until it lands, the kernel path
refuses inputs that require grad rather than return an output that
autograd cannot differentiate."""

from __future__ import annotations

from typing import Optional

from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ref


def flash_attention(q, k, v, causal=True, window=0, softcap=0.0,
                    use_kernel: Optional[bool] = None):
    """q: (B,Sq,Hq,D); k,v: (B,Skv,Hkv,D). Returns (B,Sq,Hq,D) in q's dtype.

    ``use_kernel=None`` launches the CUDA kernel for CUDA tensors and runs
    the plain version for CPU tensors; ``True`` asks for the kernel (and
    raises on CPU tensors); ``False`` runs the plain version."""
    if use_kernel is None:
        use_kernel = q.is_cuda
        if not use_kernel and q.device.type != "cpu":
            raise ValueError(f"no flash attention path for device {q.device}")
    if use_kernel:
        if any(t.requires_grad for t in (q, k, v)):
            raise NotImplementedError(
                "the flash attention kernel has no backward yet (ROADMAP "
                "Queue 1 item 8, training); run under torch.no_grad() or "
                "use_kernel=False")
        return K.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                     softcap=softcap)
    return ref.attention(q, k, v, causal=causal, window=window,
                         softcap=softcap)
