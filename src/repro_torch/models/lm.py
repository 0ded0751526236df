"""Model API over the families the port builds so far.

The reference's entry points for ``family == "dense"`` (smollm,
h2o-danube), ``"moe"`` (olmoe), ``"ssm"`` (rwkv6) and ``"hybrid"``
(zamba2). The VLM and audio families raise ``NotImplementedError``: their
port is ROADMAP Queue 1 item 8.

  param_specs(cfg)                   declarative parameter tree
  input_specs(cfg, shape)            batch stand-ins per ShapeSpec
  loss_fn(cfg, run, ctx, params, batch)      -> (loss, metrics)
  cache_specs(cfg, shape)            decode-state tree
  prefill_fn(...) / decode_fn(...)   serving programs
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeSpec
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.models import mamba2 as MB
from repro_torch.models import params as P
from repro_torch.models import rwkv as RW
from repro_torch.models import transformer as T
from repro_torch.models.common import (compute_dtype, embed_specs, embed_tokens,
                                       logits_fn, rms_norm, rms_norm_specs,
                                       xent_loss)

Q_CHUNK = 1024
PORTED = ("dense", "moe", "ssm", "hybrid")


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            f"(ROADMAP Queue 1 item 8); the port builds families 'dense' "
            f"(smollm, h2o-danube), 'moe' (olmoe), 'ssm' (rwkv6) and "
            f"'hybrid' (zamba2)")


def param_specs(cfg: ModelConfig) -> Dict:
    _require_ported(cfg)
    if cfg.family in ("dense", "moe"):
        stack = T.stack_specs(cfg)
    elif cfg.family == "ssm":
        stack = RW.stack_specs(cfg)
    else:
        stack = MB.stack_specs(cfg)
    return {"embed": embed_specs(cfg), "stack": stack,
            "final_ln": rms_norm_specs(cfg.d_model)}


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, P.TensorSpec]:
    _require_ported(cfg)
    B, S = shape.global_batch, shape.seq_len

    def tok(s):
        return P.dense(s, ("batch", "seq")[: len(s)], init="zeros",
                       dtype="int32")

    if shape.kind == "train":
        return {"tokens": tok((B, S)), "labels": tok((B, S))}
    if shape.kind == "prefill":
        return {"tokens": tok((B, S))}
    return {"tokens": tok((B, 1)),
            "pos": P.dense((), (), init="zeros", dtype="int32")}


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    B, S = tokens.shape
    return torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)


def _backbone(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx, params, batch,
              tokens):
    _require_ported(cfg)
    dt = compute_dtype(run)
    x = embed_tokens(params["embed"], tokens, ctx, dt)
    w = params["stack"]
    if cfg.family in ("dense", "moe"):
        x, aux = T.stack_apply(cfg, run, ctx, w, x, _positions(tokens),
                               q_chunk=Q_CHUNK)
    elif cfg.family == "ssm":
        x, aux = RW.stack_apply(cfg, run, ctx, w, x, chunk=cfg.scan_chunk)
    else:
        x, aux = MB.stack_apply(cfg, run, ctx, w, x, _positions(tokens),
                                chunk=cfg.scan_chunk)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return x, aux


def loss_fn(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx, params, batch):
    """Teacher-forced cross-entropy (plus the stack's auxiliary loss).
    Returns (loss, metrics), both float32."""
    x, aux = _backbone(cfg, run, ctx, params, batch, batch["tokens"])
    logits = logits_fn(params["embed"], x, ctx)
    loss, metrics = xent_loss(logits, batch["labels"])
    loss = loss + aux
    metrics["aux_loss"] = aux
    metrics["loss"] = loss
    return loss, metrics


def cache_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict:
    _require_ported(cfg)
    B, S = shape.global_batch, shape.seq_len
    if cfg.family in ("dense", "moe"):
        return T.stack_cache_specs(cfg, B, S)
    if cfg.family == "ssm":
        return RW.state_specs(cfg, B)
    return MB.hybrid_cache_specs(cfg, B, S)


def prefill_fn(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx, params, batch):
    """Full-sequence prefill. Returns (last_token_logits (B, V), cache)."""
    _require_ported(cfg)
    dt = compute_dtype(run)
    tokens = batch["tokens"]
    x = embed_tokens(params["embed"], tokens, ctx, dt)
    w = params["stack"]
    if cfg.family in ("dense", "moe"):
        x, cache = T.stack_prefill(cfg, run, ctx, w, x, _positions(tokens),
                                   q_chunk=Q_CHUNK)
    elif cfg.family == "ssm":
        x, cache = RW.stack_prefill(cfg, run, ctx, w, x, chunk=cfg.scan_chunk)
    else:
        x, cache = MB.stack_prefill(cfg, run, ctx, w, x, _positions(tokens),
                                    chunk=cfg.scan_chunk)
    x = rms_norm(x[:, -1:], params["final_ln"], cfg.norm_eps)
    logits = logits_fn(params["embed"], x, ctx)[:, 0]
    return logits, cache


def decode_fn(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx, params, cache,
              batch):
    """One decode step. batch: {tokens (B,1), pos}: ``pos`` a Python int.
    Returns (logits, cache)."""
    _require_ported(cfg)
    dt = compute_dtype(run)
    x = embed_tokens(params["embed"], batch["tokens"], ctx, dt)
    w = params["stack"]
    if cfg.family in ("dense", "moe"):
        x, cache = T.stack_decode(cfg, run, ctx, w, cache, x, batch["pos"])
    elif cfg.family == "ssm":
        x, cache = RW.stack_decode(cfg, run, ctx, w, cache, x)
    else:
        x, cache = MB.stack_decode(cfg, run, ctx, w, cache, x, batch["pos"])
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    logits = logits_fn(params["embed"], x, ctx)[:, 0]
    return logits, cache
