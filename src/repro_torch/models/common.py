"""Shared model components: RMS norm, RoPE, MLP, embedding, logits and the
cross-entropy loss."""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.models import params as P


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float, *,
             mean_square: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RMS norm over the last dim. ``mean_square``: where ``x`` and
    ``scale`` are a block of the features (a cell of a decode_flash
    decode step), each row's mean square over all of them (float32)."""
    dt = x.dtype
    x = x.float()
    var = (torch.mean(torch.square(x), dim=-1, keepdim=True)
           if mean_square is None else mean_square)
    return ((x * torch.rsqrt(var + eps)) * scale.float()).to(dt)


def sum_squares(x: torch.Tensor) -> torch.Tensor:
    """Each row's sum of squares over the last dim, in float32."""
    return torch.sum(torch.square(x.float()), dim=-1, keepdim=True)


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
    """The MLP, or, on a tensor-parallel cell's columns of ``w_gate`` and
    ``w_up`` and rows of ``w_down``, its partial sum, which the block's
    exit sums over ``model`` (``distributed.tensor_parallel``)."""
    gate = matmul(x, w["w_gate"])
    up = matmul(x, w["w_up"])
    gate = ctx.constrain(gate, ("batch", "seq_inner", "mlp")[: gate.ndim])
    out = matmul(gated(gate, up, act), w["w_down"])
    return ctx.constrain(out, ("batch", "seq", "embed")[: out.ndim])


def gated(gate: torch.Tensor, up: torch.Tensor, act: str = "silu"
          ) -> torch.Tensor:
    """act(gate) * up: the MLP's hidden layer."""
    # jax.nn.gelu defaults to the tanh approximation
    return (F.silu(gate) if act == "silu"
            else F.gelu(gate, approximate="tanh")) * up


# --- Embedding / logits / loss ---------------------------------------------------


def embed_specs(cfg: ModelConfig) -> Dict:
    d = {"embedding": P.dense((cfg.vocab_size, cfg.d_model), ("vocab", "fsdp"),
                              init="embed")}
    if not cfg.tie_embeddings:
        d["unembed"] = P.dense((cfg.d_model, cfg.vocab_size), ("fsdp", "vocab"))
    return d


def embed_tokens(w: Dict, tokens: torch.Tensor, ctx: ShardingCtx,
                 dtype: torch.dtype, vocab_lo: Optional[int] = None
                 ) -> torch.Tensor:
    """The tokens' rows of the table. ``vocab_lo``: the table is a
    tensor-parallel cell's rows from ``vocab_lo`` on, and a token outside
    them gives a row of zeros (the cells' sum over ``model`` is the
    lookup)."""
    table = w["embedding"]
    if vocab_lo is not None:
        idx = tokens.long() - vocab_lo
        inside = (idx >= 0) & (idx < table.shape[0])
        x = table[idx.clamp(0, table.shape[0] - 1)].to(dtype)
        return torch.where(inside[..., None], x, torch.zeros((), dtype=dtype,
                                                             device=x.device))
    # gather, then cast: the same values as casting the table first, without
    # a copy of the whole table when the dtypes differ
    x = table[tokens].to(dtype)
    return ctx.constrain(x, ("batch", "seq", "embed"))


def logits_fn(w: Dict, x: torch.Tensor, ctx: ShardingCtx) -> torch.Tensor:
    """Logits in the activations' dtype (the reference pins the product's
    output type to it)."""
    if "unembed" in w:
        logits = matmul(x, w["unembed"])
    else:
        logits = matmul(x, w["embedding"].T)
    return ctx.constrain(logits, ("batch", "seq", "vocab")[: logits.ndim])


def xent_loss(logits: torch.Tensor, labels: torch.Tensor,
              z_loss: float = 1e-4):
    """Cross-entropy over (B, S, V) against labels (B, S), reduced in
    float32. Returns (mean_loss, aux): aux carries the mean negative
    log-likelihood and the z-loss (z_loss x logsumexp^2) for logging."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return xent_of(lse, label_logit, z_loss)


def vocab_parts(w: Dict, x: torch.Tensor, labels: torch.Tensor,
                vocab_lo: int):
    """A tensor-parallel cell's share of ``xent_loss`` over its vocabulary
    rows from ``vocab_lo`` on: the logsumexp of its logits (float32) and
    the label's logit where the label is one of its rows, else 0. No
    (B, S, V) tensor leaves the cell."""
    logits = logits_fn(w, x, ShardingCtx.null()).float()
    lse = torch.logsumexp(logits, dim=-1)
    n = logits.shape[-1]
    idx = labels.long() - vocab_lo
    inside = (idx >= 0) & (idx < n)
    label = torch.gather(logits, -1, idx.clamp(0, n - 1)[..., None])[..., 0]
    return lse, torch.where(inside, label, torch.zeros_like(label))


def xent_of(lse: torch.Tensor, label_logit: torch.Tensor,
            z_loss: float = 1e-4):
    """``xent_loss`` from the whole vocabulary's logsumexp and label
    logits (B, S), float32."""
    nll = lse - label_logit
    zl = z_loss * torch.square(lse)
    loss = torch.mean(nll + zl)
    return loss, {"nll": torch.mean(nll), "z_loss": torch.mean(zl)}


def compute_dtype(run: RunConfig) -> torch.dtype:
    return P.torch_dtype(run.compute_dtype)
