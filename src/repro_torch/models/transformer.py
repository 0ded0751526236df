"""Decoder-only transformer blocks and stacks (dense / MoE / VLM families),
the counterpart of ``repro/models/transformer.py``.

A block (attention + MLP, or attention + MoE layer): specs, the
teacher-forced forward, the prefill that also returns the block's (k, v),
and one decode step against a KV cache; the zamba2 stack applies it as its
weight-tied shared block. The dense and MoE stacks keep the reference's
stacked ``(L, ...)`` parameters and run their layers through
``scan_utils.grouped_scan`` (remat per layer under ``run.remat ==
"block"``). The VLM family stacks super-blocks of ``cross_attn_every``
layers ([p-1 self layers, 1 gated cross-attention layer] x groups,
llama-3.2 style): its self leaves are stacked twice, ``(groups, p-1,
...)``, and under block remat each self layer is checkpointed inside a
checkpoint of its group, as the reference nests them.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

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
                 cv, pos: int, *, use_flash: bool = False):
    """One-token decode through one block. x: (B,1,d); ck/cv: (B,Sc,Hkv,D);
    ``pos`` the token's position, a Python int. ``use_flash`` on a mesh:
    the sequence-sharded ``flash_decode`` over the cache."""
    B = x.shape[0]
    posv = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    h = rms_norm(x, w["ln1"], cfg.norm_eps)
    q = A.project_q(cfg, w["attn"], h, posv, ctx)
    k, v = A.project_kv(cfg, w["attn"], h, posv, ctx)
    ck, cv = A.cache_update(ck, cv, k, v, pos, window=cfg.sliding_window)
    if use_flash and ctx.mesh is not None:
        o = A.flash_decode(q, ck, cv, pos, ctx.mesh,
                           softcap=cfg.attn_logit_softcap,
                           window=cfg.sliding_window)
    else:
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


# --- cross-attention block (VLM) ---------------------------------------------------


def cross_block_specs(cfg: ModelConfig) -> Dict:
    return {
        "ln1": rms_norm_specs(cfg.d_model),
        "xattn": A.attn_specs(cfg, cross=True),
        "gate_attn": P.dense((), (), init="zeros"),
        "ln2": rms_norm_specs(cfg.d_model),
        "mlp": mlp_specs(cfg),
        "gate_mlp": P.dense((), (), init="zeros"),
    }


def _gated_mlp(cfg: ModelConfig, ctx: ShardingCtx, w, x, o):
    """x + tanh(gate_attn) o, then its gated MLP residual."""
    x = x + torch.tanh(w["gate_attn"]).to(x.dtype) * o
    h2 = rms_norm(x, w["ln2"], cfg.norm_eps)
    return x + torch.tanh(w["gate_mlp"]).to(x.dtype) * mlp_apply(
        w["mlp"], h2, ctx, cfg.act)


def cross_block_apply(cfg: ModelConfig, ctx: ShardingCtx, w, x, img):
    h = rms_norm(x, w["ln1"], cfg.norm_eps)
    return _gated_mlp(cfg, ctx, w, x, A.cross_attention(cfg, w["xattn"], h,
                                                        img, ctx))


def cross_block_decode(cfg: ModelConfig, ctx: ShardingCtx, w, x, img_k, img_v):
    h = rms_norm(x, w["ln1"], cfg.norm_eps)
    return _gated_mlp(cfg, ctx, w, x, A.cross_decode(cfg, w["xattn"], h,
                                                     img_k, img_v))


# --- stacks -----------------------------------------------------------------------


def _vlm_groups(cfg: ModelConfig) -> Tuple[int, int]:
    """(groups, self layers a group)."""
    p = cfg.cross_attn_every
    if not (p > 1 and cfg.num_layers % p == 0):
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers do not split "
                         f"into super-blocks of {p}")
    return cfg.num_layers // p, p - 1


def stack_specs(cfg: ModelConfig) -> Dict:
    if cfg.family == "vlm":
        g, s = _vlm_groups(cfg)
        self_specs = P.stack_tree(s, block_specs(cfg, moe=False))
        return {"self": P.stack_tree(g, self_specs),
                "cross": P.stack_tree(g, cross_block_specs(cfg))}
    return {"layers": P.stack_tree(cfg.num_layers,
                                   block_specs(cfg, moe=cfg.is_moe))}


def stack_apply(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx, w, x,
                positions, *, img: Optional[torch.Tensor] = None,
                q_chunk=1024):
    """Full-sequence forward. Returns (x, aux_loss)."""
    from repro_torch.models.scan_utils import grouped_scan

    remat = run.remat == "block"

    def one_layer(carry, wl):
        x, aux = carry
        x, a = block_apply(cfg, run, ctx, wl, x, positions, q_chunk=q_chunk)
        return (x, aux + a.float()), None

    aux0 = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "vlm":
        g, s = _vlm_groups(cfg)

        def one_group(carry, wg):
            for i in range(s):
                wl = P.layer(wg["self"], i)
                carry, _ = (checkpoint(one_layer, carry, wl,
                                       use_reentrant=False)
                            if remat else one_layer(carry, wl))
            x, aux = carry
            return cross_block_apply(cfg, ctx, wg["cross"], x, img), aux

        carry = (x, aux0)
        for j in range(g):
            wg = P.layer(w, j)
            carry = (checkpoint(one_group, carry, wg, use_reentrant=False)
                     if remat else one_group(carry, wg))
        return carry

    (x, aux), _ = grouped_scan(one_layer, (x, aux0), w["layers"],
                               cfg.num_layers, run.scan_group, remat)
    return x, aux


def stack_cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> Dict:
    base = A.cache_specs(cfg, batch, A.effective_cache_len(cfg, cache_len))
    if cfg.family == "vlm":
        g, s = _vlm_groups(cfg)
        img_kv = (batch, cfg.num_image_tokens, cfg.num_kv_heads, cfg.head_dim)
        logical = ("batch", "img_seq", "cache_heads", "head_dim")
        cross = {name: P.dense(img_kv, logical, init="zeros",
                               dtype="bfloat16")
                 for name in ("img_k", "img_v")}
        return {"self": P.stack_tree(g, P.stack_tree(s, base)),
                "cross": P.stack_tree(g, cross)}
    return P.stack_tree(cfg.num_layers, base)


def _decode_layers(cfg, run, ctx, w, cache, x, pos: int, n: int, use_flash):
    """``n`` stacked self layers' decode step; their new (k, v) stacked."""
    ks, vs = [], []
    for i in range(n):
        x, ck, cv = block_decode(cfg, run, ctx, P.layer(w, i), x,
                                 cache["k"][i], cache["v"][i], pos,
                                 use_flash=use_flash)
        ks.append(ck)
        vs.append(cv)
    return x, {"k": torch.stack(ks), "v": torch.stack(vs)}


def stack_decode(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx, w, cache,
                 x, pos: int, *, use_flash: bool = False):
    """One-token decode at position ``pos`` (a Python int). Returns
    (x, new_cache); the VLM's image KV is kept as it is. ``use_flash``:
    the self layers' attention through ``flash_decode`` on a mesh."""
    if cfg.family == "vlm":
        g, s = _vlm_groups(cfg)
        new_self = []
        for j in range(g):
            wg, cg = P.layer(w, j), P.layer(cache["self"], j)
            x, kv = _decode_layers(cfg, run, ctx, wg["self"], cg, x, pos, s,
                                   use_flash)
            new_self.append(kv)
            cx = P.layer(cache["cross"], j)
            x = cross_block_decode(cfg, ctx, wg["cross"], x, cx["img_k"],
                                   cx["img_v"])
        return x, {"self": P.stack_layers(new_self), "cross": cache["cross"]}
    return _decode_layers(cfg, run, ctx, w["layers"], cache, x, pos,
                          cfg.num_layers, use_flash)


def stack_prefill(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx, w, x,
                  positions, *, img: Optional[torch.Tensor] = None,
                  q_chunk=1024):
    """Full-sequence forward that also builds the KV cache, each layer's
    (k, v) trimmed to the cache (a sliding window's ring layout) and
    stored in bfloat16; the VLM's image KV of each cross layer is the
    image embeddings' projection, stored in bfloat16. Returns (x, cache)."""
    eff = A.effective_cache_len(cfg, x.shape[1])

    def trim(k):
        if cfg.sliding_window > 0:
            return A.ring_layout(k, cfg.sliding_window)
        return k[:, -eff:] if eff < k.shape[1] else k

    def prefill_layers(x, wl_tree, n):
        ks, vs = [], []
        for i in range(n):
            x, k, v = block_prefill(cfg, run, ctx, P.layer(wl_tree, i), x,
                                    positions, q_chunk=q_chunk)
            ks.append(trim(k).to(torch.bfloat16))
            vs.append(trim(v).to(torch.bfloat16))
        return x, {"k": torch.stack(ks), "v": torch.stack(vs)}

    if cfg.family == "vlm":
        g, s = _vlm_groups(cfg)
        B, T = img.shape[:2]
        self_c, cross_c = [], []
        for j in range(g):
            wg = P.layer(w, j)
            x, kv = prefill_layers(x, wg["self"], s)
            self_c.append(kv)
            x = cross_block_apply(cfg, ctx, wg["cross"], x, img)
            xw = wg["cross"]["xattn"]
            cross_c.append({
                name: matmul(img, xw[wn]).reshape(
                    B, T, cfg.num_kv_heads, cfg.head_dim).to(torch.bfloat16)
                for name, wn in (("img_k", "wk"), ("img_v", "wv"))})
        return x, {"self": P.stack_layers(self_c),
                   "cross": P.stack_layers(cross_c)}
    return prefill_layers(x, w["layers"], cfg.num_layers)
