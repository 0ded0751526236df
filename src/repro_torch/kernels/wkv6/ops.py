"""WKV6 dispatch: the CUDA kernel (``kernel.py``) or the plain PyTorch
version (``ref.py``), the counterpart of ``repro/kernels/wkv6/ops.py``.

The kernel path is differentiable through ``_WKV6``: its forward is the
CUDA kernel, its backward recomputes the scan through ``ref.wkv6`` and
differentiates that. The reference's Pallas kernel has no VJP of its own:
its gradient is ``jax.grad`` of the jnp path it runs off the TPU, the same
function. The recompute is that design, not a fallback: the forward never
runs the plain version in the kernel's place. A hand-written backward
kernel is ROADMAP Queue 2 step B."""

from __future__ import annotations

from typing import Optional

from repro_torch.kernels import _autograd
from repro_torch.kernels.wkv6 import kernel as K
from repro_torch.kernels.wkv6 import ref


# Forward: the CUDA kernel on contiguous inputs. Backward: the gradients of
# ``ref.wkv6`` at the saved inputs against the incoming (gy, gstate), under
# the profiler range ``wkv6_recompute_bwd``.
_WKV6 = _autograd.recompute_function(
    "_WKV6", "wkv6_recompute_bwd",
    lambda *a, **kw: K.wkv6_chunked(*a, **kw), ref.wkv6)


def wkv6(r, k, v, w, u, state, *, chunk: int = 32,
         use_kernel: Optional[bool] = None):
    """Shapes as in ``ref.wkv6``; returns (y f32, state_out f32).

    ``use_kernel=None`` launches the CUDA kernel for CUDA tensors and runs
    the plain version for CPU tensors (native autograd); ``True`` asks for
    the kernel (and raises on CPU tensors); ``False`` runs the plain
    version."""
    if use_kernel is None:
        use_kernel = r.is_cuda
        if not use_kernel and r.device.type != "cpu":
            raise ValueError(f"no wkv6 path for device {r.device}")
    if use_kernel:
        return _WKV6.apply({"chunk": chunk}, r, k, v, w, u, state)
    return ref.wkv6(r, k, v, w, u, state, chunk=chunk)
