"""Gradient compression with error feedback, the counterpart of
``repro/distributed/compression.py``.

Two compressors, both stateless maths plus a persistent residual (error
feedback: the quantisation error enters the next step again, which keeps
convergence):

  * int8 symmetric quantisation (4x against f32, 2x against bf16 on the
    wire),
  * top-k magnitude sparsification (a k-fraction of the values and their
    indices).

``compressed_psum_int8`` is the data-parallel mean inside
``spmd.shard_map``: quantise with a scale agreed through ``pmax``, sum
the int8 payloads in int32, dequantise. Rounding is half to even in both
packages (``torch.round``, ``jnp.round``).
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.distributed import spmd
from repro_torch.models import params as P

# --- int8 error feedback ---------------------------------------------------------


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded once, on every device: on CUDA, a tensor divided
    by a host scalar is multiplied by the scalar's rounded reciprocal,
    one ulp off the quotient the reference's division gives."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = _div(torch.clamp(x.abs().max(), min=1e-12), 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return q.to(dtype) * scale.to(dtype)


def ef_compress_int8(x: torch.Tensor, residual: torch.Tensor):
    """Returns (q, scale, new_residual); x and residual of one shape, f32."""
    xc = x + residual
    q, scale = quantize_int8(xc)
    deq = dequantize_int8(q, scale)
    return q, scale, xc - deq


# --- top-k error feedback --------------------------------------------------------


def ef_compress_topk(x: torch.Tensor, residual: torch.Tensor,
                     k_frac: float = 0.01):
    xc = (x + residual).reshape(-1)
    k = max(1, int(xc.numel() * k_frac))
    _, idx = torch.topk(xc.abs(), k)
    picked = xc[idx]
    sparse = torch.zeros_like(xc).index_put((idx,), picked)
    new_residual = (xc - sparse).reshape(x.shape)
    return (picked, idx), new_residual


def decompress_topk(payload, shape) -> torch.Tensor:
    vals, idx = payload
    n = 1
    for s in shape:
        n *= int(s)
    out = torch.zeros(n, dtype=vals.dtype, device=vals.device)
    return out.index_put((idx,), vals).reshape(tuple(shape))


# --- the collective --------------------------------------------------------------


def compressed_psum_int8(x: torch.Tensor, axis_name) -> torch.Tensor:
    """Inside ``spmd.shard_map``: the int8-quantised mean over
    ``axis_name`` with a scale agreed beforehand, so the int8 payload
    itself crosses the wire; scale = pmax(|x|)/127."""
    gmax = spmd.pmax(x.abs().max(), axis_name)
    scale = _div(torch.clamp(gmax, min=1e-12), 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    n = spmd.psum(1, axis_name)
    s = spmd.psum(q.to(torch.int32), axis_name)
    return _div(s.float() * scale, n).to(x.dtype)


# --- the tree-level API ----------------------------------------------------------


def init_residuals(tree) -> Any:
    return P.tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                            device=x.device), tree)


def compress_tree_int8(grads, residuals):
    """Every leaf through ``ef_compress_int8``. Returns the trees of
    (q, scale, new residual)."""
    out = P.tree_map(lambda g, r: ef_compress_int8(g.float(), r), grads,
                     residuals)  # a tree of (q, scale, residual) leaves
    return tuple(P.tree_map(lambda t, i=i: t[i], out) for i in range(3))


def decompress_tree_int8(qs, scales, dtype=torch.float32):
    return P.tree_map(lambda q, s: dequantize_int8(q, s, dtype), qs, scales)
