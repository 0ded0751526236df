"""Model API over the families the port builds so far.

The reference's entry points for serving and the teacher-forced forward,
for ``family == "ssm"`` (rwkv6). Every other family raises
``NotImplementedError``: its port is ROADMAP Queue 1 item 8.

  param_specs(cfg)                   declarative parameter tree
  cache_specs(cfg, shape)            decode-state tree
  prefill_fn(...) / decode_fn(...)   serving programs
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeSpec
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.models import rwkv as RW
from repro_torch.models.common import (compute_dtype, embed_specs, embed_tokens,
                                       logits_fn, rms_norm, rms_norm_specs)


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            f"(ROADMAP Queue 1 item 8); the port builds family 'ssm' (rwkv6)")


def param_specs(cfg: ModelConfig) -> Dict:
    _require_ported(cfg)
    return {"embed": embed_specs(cfg), "stack": RW.stack_specs(cfg),
            "final_ln": rms_norm_specs(cfg.d_model)}


def _backbone(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx, params, batch,
              tokens):
    _require_ported(cfg)
    dt = compute_dtype(run)
    x = embed_tokens(params["embed"], tokens, ctx, dt)
    x, aux = RW.stack_apply(cfg, run, ctx, params["stack"], x,
                            chunk=cfg.scan_chunk)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return x, aux


def cache_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict:
    _require_ported(cfg)
    return RW.state_specs(cfg, shape.global_batch)


def prefill_fn(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx, params, batch):
    """Full-sequence prefill. Returns (last_token_logits (B, V), cache)."""
    _require_ported(cfg)
    dt = compute_dtype(run)
    x = embed_tokens(params["embed"], batch["tokens"], ctx, dt)
    x, cache = RW.stack_prefill(cfg, run, ctx, params["stack"], x,
                                chunk=cfg.scan_chunk)
    x = rms_norm(x[:, -1:], params["final_ln"], cfg.norm_eps)
    logits = logits_fn(params["embed"], x, ctx)[:, 0]
    return logits, cache


def decode_fn(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx, params, cache,
              batch):
    """One decode step. batch: {tokens (B,1), pos ()}. Returns (logits, cache)."""
    _require_ported(cfg)
    dt = compute_dtype(run)
    x = embed_tokens(params["embed"], batch["tokens"], ctx, dt)
    x, cache = RW.stack_decode(cfg, run, ctx, params["stack"], cache, x)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    logits = logits_fn(params["embed"], x, ctx)[:, 0]
    return logits, cache
