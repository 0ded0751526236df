"""Whisper-style encoder-decoder (audio family), the counterpart of
``repro/models/audio.py``.

The conv frontend is a stub, as in the reference: ``lm.input_specs()``
provides precomputed frame embeddings (B, encoder_seq, d_model). The
backbone is whole: a bidirectional encoder (rope on its positions, its
self-attention through the flash kernel on CUDA tensors and
``attention_dense`` on CPU tensors), then a causal decoder whose layers
attend to their own tokens (``attention_auto``) and to the encoder states
(``attention.cross_attention``). Every MLP is gelu, whatever ``cfg.act``
says, as the reference passes it. Under ``run.remat == "block"`` each
encoder and decoder layer is checkpointed. Parameters keep the reference's
stacked ``(L, ...)`` leaves.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.models import attention as A
from repro_torch.models import params as P
from repro_torch.models.common import (matmul, mlp_apply, mlp_specs, rms_norm,
                                       rms_norm_specs)
from repro_torch.models.scan_utils import grouped_scan


def enc_layer_specs(cfg: ModelConfig) -> Dict:
    return {
        "ln1": rms_norm_specs(cfg.d_model),
        "attn": A.attn_specs(cfg),
        "ln2": rms_norm_specs(cfg.d_model),
        "mlp": mlp_specs(cfg),
    }


def dec_layer_specs(cfg: ModelConfig) -> Dict:
    return {
        "ln1": rms_norm_specs(cfg.d_model),
        "attn": A.attn_specs(cfg),
        "lnx": rms_norm_specs(cfg.d_model),
        "xattn": A.attn_specs(cfg, cross=True),
        "ln2": rms_norm_specs(cfg.d_model),
        "mlp": mlp_specs(cfg),
    }


def stack_specs(cfg: ModelConfig) -> Dict:
    return {
        "encoder": P.stack_tree(cfg.encoder_layers, enc_layer_specs(cfg)),
        "enc_ln": rms_norm_specs(cfg.d_model),
        "decoder": P.stack_tree(cfg.num_layers, dec_layer_specs(cfg)),
    }


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def _enc_layer(cfg, run, ctx, w, x, positions):
    B, S, _ = x.shape
    h = rms_norm(x, w["ln1"], cfg.norm_eps)
    q = A.project_q(cfg, w["attn"], h, positions, ctx)
    k, v = A.project_kv(cfg, w["attn"], h, positions, ctx)
    o = A.attention_full(q, k, v)
    x = x + matmul(o.reshape(B, S, cfg.q_dim), w["attn"]["wo"])
    h2 = rms_norm(x, w["ln2"], cfg.norm_eps)
    return x + mlp_apply(w["mlp"], h2, ctx, act="gelu")


def encode(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx, w, frames):
    """frames: (B, T_enc, d) stub embeddings -> encoder states."""
    B, S, _ = frames.shape
    positions = _positions(B, S, frames.device)

    def body(x, wl):
        return _enc_layer(cfg, run, ctx, wl, x, positions), None

    x, _ = grouped_scan(body, frames, w["encoder"], cfg.encoder_layers, 0,
                        run.remat == "block")
    return rms_norm(x, w["enc_ln"], cfg.norm_eps)


def _self_attend(cfg, ctx, w, x, positions, q_chunk):
    """The decoder layer's causal self-attention half: (x + attn, k, v)."""
    B, S, _ = x.shape
    h = rms_norm(x, w["ln1"], cfg.norm_eps)
    q = A.project_q(cfg, w["attn"], h, positions, ctx)
    k, v = A.project_kv(cfg, w["attn"], h, positions, ctx)
    o = A.attention_auto(q, k, v, causal=True, q_chunk=q_chunk, ctx=ctx)
    return x + matmul(o.reshape(B, S, cfg.q_dim), w["attn"]["wo"]), k, v


def _cross_mlp(cfg, ctx, w, x, enc):
    hx = rms_norm(x, w["lnx"], cfg.norm_eps)
    x = x + A.cross_attention(cfg, w["xattn"], hx, enc, ctx)
    h2 = rms_norm(x, w["ln2"], cfg.norm_eps)
    return x + mlp_apply(w["mlp"], h2, ctx, act="gelu")


def _dec_layer(cfg, run, ctx, w, x, enc, positions, *, q_chunk=1024):
    x, _, _ = _self_attend(cfg, ctx, w, x, positions, q_chunk)
    return _cross_mlp(cfg, ctx, w, x, enc)


def decode_train(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx, w, x,
                 enc, positions, *, q_chunk=1024):
    def body(x, wl):
        return _dec_layer(cfg, run, ctx, wl, x, enc, positions,
                          q_chunk=q_chunk), None

    x, _ = grouped_scan(body, x, w["decoder"], cfg.num_layers, 0,
                        run.remat == "block")
    return x


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> Dict:
    self_kv = A.cache_specs(cfg, batch, cache_len)
    cross_shape = (batch, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim)
    logical = ("batch", "img_seq", "cache_heads", "head_dim")
    cross = {name: P.dense(cross_shape, logical, init="zeros",
                           dtype="bfloat16") for name in ("ck", "cv")}
    return P.stack_tree(cfg.num_layers, {**self_kv, **cross})


def prefill(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx, w, tokens_x,
            frames, positions, *, q_chunk=1024):
    """Returns (x, cache): each decoder layer's self KV and its cross KV
    (the encoder states' projection), all in bfloat16, stacked."""
    enc = encode(cfg, run, ctx, w, frames)
    B, T = enc.shape[:2]
    x, layers = tokens_x, []
    for i in range(cfg.num_layers):
        wl = P.layer(w["decoder"], i)
        x, k, v = _self_attend(cfg, ctx, wl, x, positions, q_chunk)
        x = _cross_mlp(cfg, ctx, wl, x, enc)
        ck, cv = (matmul(enc, wl["xattn"][wn]).reshape(
            B, T, cfg.num_kv_heads, cfg.head_dim) for wn in ("wk", "wv"))
        layers.append({name: t.to(torch.bfloat16) for name, t in
                       (("k", k), ("v", v), ("ck", ck), ("cv", cv))})
    return x, P.stack_layers(layers)


def decode_step(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx, w, cache,
                x, pos: int, *, use_flash: bool = False):
    """One-token decode at position ``pos`` (a Python int). Returns
    (x, new_cache); the cross KV is kept as it is. ``use_flash``: the self
    attention through ``flash_decode`` on a mesh, with no softcap or
    window, as in the reference."""
    B = x.shape[0]
    posv = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        wl = P.layer(w["decoder"], i)
        h = rms_norm(x, wl["ln1"], cfg.norm_eps)
        q = A.project_q(cfg, wl["attn"], h, posv, ctx)
        k, v = A.project_kv(cfg, wl["attn"], h, posv, ctx)
        ck, cv = A.cache_update(cache["k"][i], cache["v"][i], k, v, pos)
        if use_flash and ctx.mesh is not None:
            o = A.flash_decode(q, ck, cv, pos, ctx.mesh)
        else:
            o = A.decode_attention(q, ck, cv, pos)
        x = x + matmul(o.reshape(B, 1, cfg.q_dim), wl["attn"]["wo"])
        hx = rms_norm(x, wl["lnx"], cfg.norm_eps)
        x = x + A.cross_decode(cfg, wl["xattn"], hx, cache["ck"][i],
                               cache["cv"][i])
        h2 = rms_norm(x, wl["ln2"], cfg.norm_eps)
        x = x + mlp_apply(wl["mlp"], h2, ctx, act="gelu")
        ks.append(ck)
        vs.append(cv)
    return x, {"k": torch.stack(ks), "v": torch.stack(vs),
               "ck": cache["ck"], "cv": cache["cv"]}
