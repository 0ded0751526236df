"""One transformer block (attention + MLP), the counterpart of the single
blocks of ``repro/models/transformer.py``: specs, the teacher-forced
forward, the prefill that also returns the block's (k, v), and one decode
step against a KV cache. The zamba2 stack applies it as its weight-tied
shared block. The dense, MoE and VLM stacks and the cross-attention block
wait for their slices (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.models import attention as A
from repro_torch.models.common import (matmul, mlp_apply, mlp_specs, rms_norm,
                                       rms_norm_specs)


def block_specs(cfg: ModelConfig, *, moe: bool) -> Dict:
    if moe:
        raise NotImplementedError(
            f"{cfg.name}: MoE blocks are not ported yet (ROADMAP Queue 1 "
            f"item 8)")
    return {
        "ln1": rms_norm_specs(cfg.d_model),
        "attn": A.attn_specs(cfg),
        "ln2": rms_norm_specs(cfg.d_model),
        "mlp": mlp_specs(cfg),
    }


def _attend(cfg: ModelConfig, ctx: ShardingCtx, w, x, positions, q_chunk):
    """The attention half: (x + attn(x), k, v)."""
    B, S, _ = x.shape
    h = rms_norm(x, w["ln1"], cfg.norm_eps)
    q = A.project_q(cfg, w["attn"], h, positions, ctx)
    k, v = A.project_kv(cfg, w["attn"], h, positions, ctx)
    o = A.attention_auto(q, k, v, causal=cfg.causal, window=cfg.sliding_window,
                         softcap=cfg.attn_logit_softcap, q_chunk=q_chunk, ctx=ctx)
    o = matmul(o.reshape(B, S, cfg.q_dim), w["attn"]["wo"])
    return x + ctx.constrain(o, ("batch", "seq", "embed")), k, v


def _mlp_residual(cfg: ModelConfig, ctx: ShardingCtx, w, x):
    h2 = rms_norm(x, w["ln2"], cfg.norm_eps)
    return x + mlp_apply(w["mlp"], h2, ctx, cfg.act)


def block_apply(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx, w, x,
                positions, *, q_chunk: int = 1024):
    x, _, _ = _attend(cfg, ctx, w, x, positions, q_chunk)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _mlp_residual(cfg, ctx, w, x), aux


def block_decode(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx, w, x, ck,
                 cv, pos: int):
    """One-token decode through one block. x: (B,1,d); ck/cv: (B,Sc,Hkv,D);
    ``pos`` the token's position, a Python int."""
    B = x.shape[0]
    posv = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    h = rms_norm(x, w["ln1"], cfg.norm_eps)
    q = A.project_q(cfg, w["attn"], h, posv, ctx)
    k, v = A.project_kv(cfg, w["attn"], h, posv, ctx)
    ck, cv = A.cache_update(ck, cv, k, v, pos, window=cfg.sliding_window)
    o = A.decode_attention(q, ck, cv, pos, window=cfg.sliding_window,
                           softcap=cfg.attn_logit_softcap)
    o = matmul(o.reshape(B, 1, cfg.q_dim), w["attn"]["wo"])
    return _mlp_residual(cfg, ctx, w, x + o), ck, cv


def block_prefill(cfg, run, ctx, w, x, positions, *, q_chunk=1024):
    """Like block_apply but also returns this layer's (k, v) for the cache."""
    x, k, v = _attend(cfg, ctx, w, x, positions, q_chunk)
    return _mlp_residual(cfg, ctx, w, x), k, v
