"""Serving programs: prefill and single-token decode (greedy head)."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.models import lm


def make_prefill_step(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx):
    def prefill_step(params, batch):
        with torch.inference_mode():
            logits, cache = lm.prefill_fn(cfg, run, ctx, params, batch)
            next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, cache

    return prefill_step


def make_decode_step(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx):
    def decode_step(params, cache, batch):
        with torch.inference_mode():
            logits, cache = lm.decode_fn(cfg, run, ctx, params, cache, batch)
            next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, cache

    return decode_step
