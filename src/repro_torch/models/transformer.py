"""Decoder-only transformer blocks and the dense stack, the counterpart of
``repro/models/transformer.py``.

A block (attention + MLP, or attention + MoE layer): specs, the
teacher-forced forward, the prefill that also returns the block's (k, v),
and one decode step against a KV cache; the zamba2 stack applies it as its
weight-tied shared block. The dense and MoE stacks keep the reference's
stacked ``(L, ...)`` parameters and run their layers through
``scan_utils.grouped_scan`` (remat per layer under ``run.remat ==
"block"``). The VLM family's cross-attention super-blocks wait for their
slice (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.models import attention as A
from repro_torch.models import moe as M
from repro_torch.models import params as P
from repro_torch.models.common import (matmul, mlp_apply, mlp_specs, rms_norm,
                                       rms_norm_specs)


def block_specs(cfg: ModelConfig, *, moe: bool) -> Dict:
    s = {
        "ln1": rms_norm_specs(cfg.d_model),
        "attn": A.attn_specs(cfg),
        "ln2": rms_norm_specs(cfg.d_model),
    }
    if moe:
        s["moe"] = M.moe_specs(cfg)
    else:
        s["mlp"] = mlp_specs(cfg)
    return s


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


def _mlp_residual(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx, w, x):
    """The second half: (x + mlp(x) or x + moe(x), the MoE aux loss or
    None)."""
    h2 = rms_norm(x, w["ln2"], cfg.norm_eps)
    if "moe" in w:
        y, aux = M.moe_apply(cfg, ctx, w["moe"], h2, impl=run.moe_impl)
        return x + y, aux
    return x + mlp_apply(w["mlp"], h2, ctx, cfg.act), None


def block_apply(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx, w, x,
                positions, *, q_chunk: int = 1024):
    """Returns (x, aux_loss): the MoE layer's, or 0."""
    x, _, _ = _attend(cfg, ctx, w, x, positions, q_chunk)
    x, aux = _mlp_residual(cfg, run, ctx, w, x)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


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
    x, _ = _mlp_residual(cfg, run, ctx, w, x + o)
    return x, ck, cv


def block_prefill(cfg, run, ctx, w, x, positions, *, q_chunk=1024):
    """Like block_apply but also returns this layer's (k, v) for the cache."""
    x, k, v = _attend(cfg, ctx, w, x, positions, q_chunk)
    x, _ = _mlp_residual(cfg, run, ctx, w, x)
    return x, k, v


# --- stacks -----------------------------------------------------------------------


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family == "vlm":
        raise NotImplementedError(
            f"{cfg.name}: the VLM stack (cross-attention super-blocks) is "
            f"not ported yet (ROADMAP Queue 1 item 8)")


def stack_specs(cfg: ModelConfig) -> Dict:
    _require_dense(cfg)
    return {"layers": P.stack_tree(cfg.num_layers,
                                   block_specs(cfg, moe=cfg.is_moe))}


def stack_apply(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx, w, x,
                positions, *, q_chunk=1024):
    """Full-sequence forward. Returns (x, aux_loss)."""
    from repro_torch.models.scan_utils import grouped_scan

    _require_dense(cfg)

    def one_layer(carry, wl):
        x, aux = carry
        x, a = block_apply(cfg, run, ctx, wl, x, positions, q_chunk=q_chunk)
        return (x, aux + a.float()), None

    aux0 = torch.zeros((), dtype=torch.float32, device=x.device)
    (x, aux), _ = grouped_scan(one_layer, (x, aux0), w["layers"],
                               cfg.num_layers, run.scan_group,
                               run.remat == "block")
    return x, aux


def stack_cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> Dict:
    _require_dense(cfg)
    base = A.cache_specs(cfg, batch, A.effective_cache_len(cfg, cache_len))
    return P.stack_tree(cfg.num_layers, base)


def stack_decode(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx, w, cache,
                 x, pos: int):
    """One-token decode at position ``pos`` (a Python int). Returns
    (x, new_cache)."""
    _require_dense(cfg)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        x, ck, cv = block_decode(cfg, run, ctx, P.layer(w["layers"], i), x,
                                 cache["k"][i], cache["v"][i], pos)
        ks.append(ck)
        vs.append(cv)
    return x, {"k": torch.stack(ks), "v": torch.stack(vs)}


def stack_prefill(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx, w, x,
                  positions, *, q_chunk=1024):
    """Full-sequence forward that also builds the KV cache, each layer's
    (k, v) trimmed to the cache (a sliding window's ring layout) and
    stored in bfloat16. Returns (x, cache)."""
    _require_dense(cfg)
    eff = A.effective_cache_len(cfg, x.shape[1])

    def trim(k):
        if cfg.sliding_window > 0:
            return A.ring_layout(k, cfg.sliding_window)
        return k[:, -eff:] if eff < k.shape[1] else k

    ks, vs = [], []
    for i in range(cfg.num_layers):
        x, k, v = block_prefill(cfg, run, ctx, P.layer(w["layers"], i), x,
                                positions, q_chunk=q_chunk)
        ks.append(trim(k).to(torch.bfloat16))
        vs.append(trim(v).to(torch.bfloat16))
    return x, {"k": torch.stack(ks), "v": torch.stack(vs)}
