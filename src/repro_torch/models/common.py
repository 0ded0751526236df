"""Shared model components: RMS norm, RoPE, MLP, embedding, logits.

The cross-entropy loss waits for the training slice (ROADMAP Queue 1
item 8)."""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.models import params as P


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.float()).to(dt)


def rms_norm_specs(d: int) -> P.TensorSpec:
    return P.dense((d,), (None,), init="ones")


# --- RoPE -------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)  # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S) int. The head splits into
    halves (not interleaved pairs), as the reference splits it."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)  # (D/2,)
    angles = positions[..., None].float() * freqs  # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --- MLP ----------------------------------------------------------------------


def mlp_specs(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict:
    ff = d_ff or cfg.d_ff
    return {
        "w_gate": P.dense((cfg.d_model, ff), ("fsdp", "mlp")),
        "w_up": P.dense((cfg.d_model, ff), ("fsdp", "mlp")),
        "w_down": P.dense((ff, cfg.d_model), ("mlp", "fsdp")),
    }


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in the activations' dtype (the reference pins the product's
    output type to it)."""
    return x @ w.to(x.dtype)


def mlp_apply(w: Dict, x: torch.Tensor, ctx: ShardingCtx,
              act: str = "silu") -> torch.Tensor:
    gate = matmul(x, w["w_gate"])
    up = matmul(x, w["w_up"])
    gate = ctx.constrain(gate, ("batch", "seq_inner", "mlp")[: gate.ndim])
    # jax.nn.gelu defaults to the tanh approximation
    h = (F.silu(gate) if act == "silu" else F.gelu(gate, approximate="tanh")) * up
    out = matmul(h, w["w_down"])
    return ctx.constrain(out, ("batch", "seq", "embed")[: out.ndim])


# --- Embedding / logits ---------------------------------------------------------


def embed_specs(cfg: ModelConfig) -> Dict:
    d = {"embedding": P.dense((cfg.vocab_size, cfg.d_model), ("vocab", "fsdp"),
                              init="embed")}
    if not cfg.tie_embeddings:
        d["unembed"] = P.dense((cfg.d_model, cfg.vocab_size), ("fsdp", "vocab"))
    return d


def embed_tokens(w: Dict, tokens: torch.Tensor, ctx: ShardingCtx,
                 dtype: torch.dtype) -> torch.Tensor:
    # gather, then cast: the same values as casting the table first, without
    # a copy of the whole table when the dtypes differ
    x = w["embedding"][tokens].to(dtype)
    return ctx.constrain(x, ("batch", "seq", "embed"))


def logits_fn(w: Dict, x: torch.Tensor, ctx: ShardingCtx) -> torch.Tensor:
    """Logits in the activations' dtype (the reference pins the product's
    output type to it)."""
    if "unembed" in w:
        logits = matmul(x, w["unembed"])
    else:
        logits = matmul(x, w["embedding"].T)
    return ctx.constrain(logits, ("batch", "seq", "vocab")[: logits.ndim])


def compute_dtype(run: RunConfig) -> torch.dtype:
    return P.torch_dtype(run.compute_dtype)
