"""Shared model components: RMS norm, embedding, logits.

RoPE, the MLP and the cross-entropy loss wait for the slices that need
them (ROADMAP Queue 1 item 8)."""

from __future__ import annotations

from typing import Dict

import torch

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
        logits = x @ w["unembed"].to(x.dtype)
    else:
        logits = x @ w["embedding"].to(x.dtype).T
    return ctx.constrain(logits, ("batch", "seq", "vocab")[: logits.ndim])


def compute_dtype(run: RunConfig) -> torch.dtype:
    return P.torch_dtype(run.compute_dtype)
