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

Each training layer is written once, as ``models.transformer``'s halves
(the encoder's attention bidirectional, every MLP gelu; the decoder's
cross half the VLM's without its gates, on the encoder's output):
``_enc_segments`` and ``_dec_segments``. ``encode`` and ``decode_train``
run them on ``tensor_parallel.INLINE``; in a cell of the partitioned
training step ``stack_segments`` runs them on the cell's tape,
tensor-parallel over ``model``, the encoder's output entering each cross
layer. The serve programs, ``prefill_segments`` and ``decode_segments``,
are the same halves (a decode step's self half
``transformer.attn_decode_half``, its cross half over the cached cross
KV): on ``INLINE`` for ``models.lm``'s ``prefill_fn`` and ``decode_fn``,
in a cell of the partitioned serve (``serve.step``) on its heads, its
cache shard and the cross KV of its kv heads.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.models import attention as A
from repro_torch.models import params as P
from repro_torch.models import transformer as T
from repro_torch.models.common import mlp_specs, rms_norm, rms_norm_specs
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


def _enc_segments(cfg, run, ctx, tc, wl, x, adds, positions):
    """One encoder layer on the tape of ``tc``: ``transformer``'s halves,
    the attention bidirectional, the MLP gelu. Returns (x, adds)."""
    x, adds = T._attn_half(cfg, ctx, tc, wl, x, adds, positions, 1024,
                           causal=False)
    x, adds, _ = T._mlp_half(cfg, run, ctx, tc, wl, x, adds, act="gelu")
    return x, adds


def _enc_layer(cfg, run, ctx, w, x, positions):
    return T._resid(*_enc_segments(cfg, run, ctx, tp.INLINE, lambda: w, x,
                                   (), positions))


def encode(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx, w, frames):
    """frames: (B, T_enc, d) stub embeddings -> encoder states."""
    B, S, _ = frames.shape
    positions = _positions(B, S, frames.device)

    def body(x, wl):
        return _enc_layer(cfg, run, ctx, wl, x, positions), None

    x, _ = grouped_scan(body, frames, w["encoder"], cfg.encoder_layers, 0,
                        run.remat == "block")
    return rms_norm(x, w["enc_ln"], cfg.norm_eps)


def _cross_mlp_segments(cfg, run, ctx, tc, wl, x, adds, enc, **kv):
    """The decoder layer's cross half on the encoder states ``enc`` (or,
    in a decode step, the cached cross KV ``(ck, cv)``) and its gelu MLP
    half, on the tape of ``tc``. Returns (x, adds), with ``kv``
    (``transformer._xattn_half``'s keyword) (x, adds, (ck, cv))."""
    x, adds, *cache = T._xattn_half(cfg, ctx, tc, wl, x, adds, enc, "lnx",
                                    **kv)
    x, adds, _ = T._mlp_half(cfg, run, ctx, tc, wl, x, adds, act="gelu")
    return (x, adds, *cache)


def _dec_segments(cfg, run, ctx, tc, wl, x, adds, enc, positions, q_chunk):
    """One decoder layer on the tape of ``tc``. Returns (x, adds)."""
    x, adds = T._attn_half(cfg, ctx, tc, wl, x, adds, positions, q_chunk)
    return _cross_mlp_segments(cfg, run, ctx, tc, wl, x, adds, enc)


def _dec_layer(cfg, run, ctx, w, x, enc, positions, *, q_chunk=1024):
    return T._resid(*_dec_segments(cfg, run, ctx, tp.INLINE, lambda: w, x,
                                   (), enc, positions, q_chunk))


def decode_train(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx, w, x,
                 enc, positions, *, q_chunk=1024):
    def body(x, wl):
        return _dec_layer(cfg, run, ctx, wl, x, enc, positions,
                          q_chunk=q_chunk), None

    x, _ = grouped_scan(body, x, w["decoder"], cfg.num_layers, 0,
                        run.remat == "block")
    return x


def stack_segments(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx, tc, w,
                   x, frames, positions, *, q_chunk=1024):
    """The encoder on ``frames``, ``enc_ln``, then the decoder from the
    leaf ``x``, on the tape of ``tc`` (a
    ``distributed.tensor_parallel.Cell``): each layer's halves as local
    segments with the collectives of the model-local ones between them;
    the decoder's cross halves read the encoder's output as a segment
    input (``transformer._xattn_half``), so its gradient, summed over the
    cells and the cross layers, reaches the encoder. Returns (x, adds):
    the last residual and the terms still to add to it. On ``INLINE``:
    ``encode`` and ``decode_train``, their per-layer remat included."""
    if tc is tp.INLINE:
        enc = encode(cfg, run, ctx, w, frames)
        return decode_train(cfg, run, ctx, w, x, enc, positions,
                            q_chunk=q_chunk), ()
    B, S, _ = frames.shape
    enc_positions = _positions(B, S, frames.device)
    e, adds = frames, ()
    for i in range(cfg.encoder_layers):
        e, adds = _enc_segments(cfg, run, ctx, tc,
                                lambda i=i: P.layer(w["encoder"], i), e,
                                adds, enc_positions)
    enc, = tc.tape.run(lambda e, *a: (rms_norm(T._resid(e, a), w["enc_ln"],
                                               cfg.norm_eps),), e, *adds)
    adds = ()
    for i in range(cfg.num_layers):
        x, adds = _dec_segments(cfg, run, ctx, tc,
                                lambda i=i: P.layer(w["decoder"], i), x,
                                adds, enc, positions, q_chunk)
    return x, adds


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> Dict:
    self_kv = A.cache_specs(cfg, batch, cache_len)
    cross_shape = (batch, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim)
    logical = ("batch", "img_seq", "cache_heads", "head_dim")
    cross = {name: P.dense(cross_shape, logical, init="zeros",
                           dtype="bfloat16") for name in ("ck", "cv")}
    return P.stack_tree(cfg.num_layers, {**self_kv, **cross})


def prefill_segments(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx, tc,
                     stack, x, frames, positions, q_chunk: int, *,
                     cut: Optional[A.CacheCut] = None):
    """The prefill on the tape of ``tc``: the encoder on ``frames``
    (``stack("encoder", i)`` layer ``i``'s leaves), ``enc_ln``
    (``stack("enc_ln")``; the encoder's output whole in every cell once
    the exits have summed it), then each decoder layer
    (``stack("decoder", i)``): its self half, whose k and v form the
    layer's self cache (in a serve cell its shard,
    ``attention.cache_rest``), its cross half over the encoder's output,
    which gives the cross KV of the cell's kv heads, and its MLP half.
    Returns (x, adds, cache): each layer's self KV and cross KV in
    bfloat16, stacked (L, ...)."""
    B, S, _ = frames.shape
    enc_positions = _positions(B, S, frames.device)
    e, adds = frames, ()
    for i in range(cfg.encoder_layers):
        wi = stack("encoder", i)
        e, adds = _enc_segments(cfg, run, ctx, tc, lambda: wi, e, adds,
                                enc_positions)
    ln = stack("enc_ln")
    enc, = tc.tape.run(lambda e, *a: (rms_norm(T._resid(e, a), ln,
                                               cfg.norm_eps),), e, *adds)
    form = T._cache_form(cfg)
    adds, layers = (), []
    for i in range(cfg.num_layers):
        wi = stack("decoder", i)
        x, adds, (k, v) = T._attn_half(cfg, ctx, tc, lambda: wi, x, adds,
                                       positions, q_chunk, kv=form)
        if cut is not None:
            k, v = A.cache_rest(tc.tape, k, cut), A.cache_rest(tc.tape, v, cut)
        x, adds, (ck, cv) = _cross_mlp_segments(cfg, run, ctx, tc,
                                                lambda: wi, x, adds, enc,
                                                kv=T._bf16)
        layers.append({"k": k, "v": v, "ck": ck, "cv": cv})
    return x, adds, P.stack_layers(layers)


def decode_segments(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx, tc,
                    stack, cache, x, pos: int, *,
                    cut: Optional[A.CacheCut] = None,
                    use_flash: bool = False):
    """One-token decode at position ``pos`` (a Python int) on the tape of
    ``tc`` (``stack`` as in ``prefill_segments``): each decoder layer's
    self half (``transformer.attn_decode_half``; ``use_flash``:
    ``flash_decode`` on a mesh), its cross half over the cached cross KV,
    which stays as it is, and its MLP half. Returns (x, adds, the new
    cache)."""
    adds, ks, vs = (), [], []
    for i in range(cfg.num_layers):
        wi, cl = stack("decoder", i), P.layer(cache, i)
        x, adds, ck, cv = T.attn_decode_half(
            cfg, ctx, tc, lambda: wi, x, adds, cl["k"], cl["v"], pos,
            cut=cut, use_flash=use_flash)
        x, adds = _cross_mlp_segments(cfg, run, ctx, tc, lambda: wi, x, adds,
                                      (cl["ck"], cl["cv"]))
        ks.append(ck)
        vs.append(cv)
    return x, adds, {"k": torch.stack(ks), "v": torch.stack(vs),
                     "ck": cache["ck"], "cv": cache["cv"]}
