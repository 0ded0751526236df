"""Unified model API over all families, the counterpart of
``repro/models/lm.py``.

Every architecture exposes the same entry points, the reference's, for
``family == "dense"`` (smollm, h2o-danube, llama3, qwen1.5), ``"moe"``
(olmoe, llama4-scout), ``"vlm"`` (llama-3.2-vision: the batch carries
``image_embeds``), ``"ssm"`` (rwkv6), ``"hybrid"`` (zamba2) and
``"audio"`` (whisper: the batch carries ``frame_embeds``):

  param_specs(cfg)                   declarative parameter tree
  input_specs(cfg, shape)            batch stand-ins per ShapeSpec
  loss_fn(cfg, run, ctx, params, batch)      -> (loss, metrics)
  loss_segments(cfg, run, ctx, cell, params, batch)   the loss on a
                                     tape: a tensor-parallel step
                                     cell's, or INLINE
  cache_specs(cfg, shape)            decode-state tree
  prefill_fn(...) / decode_fn(...)   serving programs
  prefill_segments(...) / decode_segments(...)   the serving programs
                                     on a tape: a partitioned serve
                                     cell's, or INLINE
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeSpec
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.models import audio as AU
from repro_torch.models import mamba2 as MB
from repro_torch.models import params as P
from repro_torch.models import rwkv as RW
from repro_torch.models import transformer as T
from repro_torch.models.common import (compute_dtype, embed_specs, embed_tokens,
                                       logits_fn, rms_norm, rms_norm_specs,
                                       vocab_parts, xent_loss, xent_of)

Q_CHUNK = 1024


def param_specs(cfg: ModelConfig) -> Dict:
    if cfg.family in ("dense", "moe", "vlm"):
        stack = T.stack_specs(cfg)
    elif cfg.family == "ssm":
        stack = RW.stack_specs(cfg)
    elif cfg.family == "hybrid":
        stack = MB.stack_specs(cfg)
    elif cfg.family == "audio":
        stack = AU.stack_specs(cfg)
    else:
        raise ValueError(cfg.family)
    return {"embed": embed_specs(cfg), "stack": stack,
            "final_ln": rms_norm_specs(cfg.d_model)}


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, P.TensorSpec]:
    B, S = shape.global_batch, shape.seq_len

    def tok(s):
        return P.dense(s, ("batch", "seq")[: len(s)], init="zeros",
                       dtype="int32")

    if shape.kind == "train":
        batch = {"tokens": tok((B, S)), "labels": tok((B, S))}
    elif shape.kind == "prefill":
        batch = {"tokens": tok((B, S))}
    else:  # decode
        batch = {"tokens": tok((B, 1)),
                 "pos": P.dense((), (), init="zeros", dtype="int32")}
    if cfg.family == "vlm" and shape.kind != "decode":
        batch["image_embeds"] = P.dense(
            (B, cfg.num_image_tokens, cfg.d_model),
            ("batch", "img_seq", "embed"), dtype="bfloat16")
    if cfg.family == "audio" and shape.kind != "decode":
        batch["frame_embeds"] = P.dense(
            (B, cfg.encoder_seq, cfg.d_model),
            ("batch", "img_seq", "embed"), dtype="bfloat16")
    return batch


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    B, S = tokens.shape
    return torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)


def _backbone(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx, params, batch,
              tokens):
    dt = compute_dtype(run)
    x = embed_tokens(params["embed"], tokens, ctx, dt)
    positions = _positions(tokens)
    w = params["stack"]
    if cfg.family in ("dense", "moe"):
        x, aux = T.stack_apply(cfg, run, ctx, w, x, positions,
                               q_chunk=Q_CHUNK)
    elif cfg.family == "vlm":
        img = batch["image_embeds"].to(dt)
        x, aux = T.stack_apply(cfg, run, ctx, w, x, positions, img=img,
                               q_chunk=Q_CHUNK)
    elif cfg.family == "ssm":
        x, aux = RW.stack_apply(cfg, run, ctx, w, x, chunk=cfg.scan_chunk)
    elif cfg.family == "hybrid":
        x, aux = MB.stack_apply(cfg, run, ctx, w, x, positions,
                                chunk=cfg.scan_chunk)
    elif cfg.family == "audio":
        enc = AU.encode(cfg, run, ctx, w, batch["frame_embeds"].to(dt))
        x = AU.decode_train(cfg, run, ctx, w, x, enc, positions,
                            q_chunk=Q_CHUNK)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        raise ValueError(cfg.family)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return x, aux


def _total(loss, metrics, auxes):
    """(loss, nll, z_loss, aux_loss): the cross-entropy's ``loss`` and
    ``metrics`` plus the stack's aux losses, summed in order."""
    aux = torch.zeros((), dtype=torch.float32, device=loss.device)
    for a in auxes:  # the layers' in order, as the stack sums them
        aux = aux + a.float()
    return loss + aux, metrics["nll"], metrics["z_loss"], aux


def _metrics(loss, nll, zl, aux):
    return loss, {"nll": nll, "z_loss": zl, "aux_loss": aux, "loss": loss}


def _embedded(cfg: ModelConfig, ctx: ShardingCtx, tc, params, tokens, dt):
    """(the cell's first vocabulary row or None, the tokens' embeddings)
    on the tape of ``tc``: where the vocabulary is model-local a partial
    lookup of the cell's rows and an exit."""
    tape, plan = tc.tape, tc.plan
    lo = tc.block(cfg.vocab_size)[0] if plan.vocab else None
    x, = tape.run(lambda: (embed_tokens(params["embed"], tokens, ctx, dt,
                                        vocab_lo=lo),))
    return lo, (tape.exit(x) if plan.vocab else x)


def loss_fn(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx, params, batch):
    """Teacher-forced cross-entropy (plus the stack's auxiliary loss).
    Returns (loss, metrics), both float32: ``loss_segments`` on
    ``tensor_parallel.INLINE`` (plain calls)."""
    return loss_segments(cfg, run, ctx, tp.INLINE, params, batch)


def loss_segments(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx, tc,
                  params, batch):
    """``loss_fn`` on the tape of ``tc`` (a
    ``distributed.tensor_parallel.Cell``: a cell of the partitioned
    training step, or ``INLINE``): the embedding, the stack
    (``transformer.stack_segments``, the VLM's cross layers on the
    batch's ``image_embeds``; ``audio.stack_segments`` on its
    ``frame_embeds``; ``rwkv.stack_segments``; ``mamba2.stack_segments``,
    zamba2's Mamba2 layers and shared block) and the loss head as local
    segments and the collectives between them. Vocabulary-parallel where the
    vocabulary is model-local: the lookup a partial sum (rows outside
    the cell's give 0), the logits the cell's columns, each row's
    logsumexp from the cells' by their ``pmax`` and a ``psum`` of the
    exponentials, beside the label logits', so no (B, S, V) tensor
    leaves a cell. Returns (loss, metrics), leaves of the last segment;
    on a ``Tape``, ``tc.tape.backward(loss)`` then fills the parameters'
    ``.grad``."""
    tape, plan = tc.tape, tc.plan
    dt = compute_dtype(run)
    tokens, labels = batch["tokens"], batch["labels"]
    positions = _positions(tokens)
    lo, x = _embedded(cfg, ctx, tc, params, tokens, dt)
    w = params["stack"]
    auxes = []
    if cfg.family == "audio":
        x, adds = AU.stack_segments(cfg, run, ctx, tc, w, x,
                                    batch["frame_embeds"].to(dt), positions,
                                    q_chunk=Q_CHUNK)
    elif cfg.family == "ssm":
        x, adds = RW.stack_segments(cfg, run, ctx, tc, w, x,
                                    chunk=cfg.scan_chunk)
    elif cfg.family == "hybrid":
        x, adds = MB.stack_segments(cfg, run, ctx, tc, w, x, positions,
                                    chunk=cfg.scan_chunk)
    else:
        img = batch["image_embeds"].to(dt) if cfg.family == "vlm" else None
        x, adds, auxes = T.stack_segments(cfg, run, ctx, tc, w, x, positions,
                                          img=img, q_chunk=Q_CHUNK)

    def final(x, *a):
        return (rms_norm(T._resid(x, a), params["final_ln"], cfg.norm_eps),)

    if plan.vocab:
        h, = tape.run(final, x, *adds)
        lse, label = tape.run(lambda h: vocab_parts(params["embed"], h, labels,
                                                    lo), tape.enter(h))
        top = tape.pmax(lse)
        parts, = tape.run(lambda lse, label: (torch.stack(
            [torch.exp(lse - top), label]),), lse, label)
        outs = tape.run(lambda parts, *a: _total(*xent_of(
            top + torch.log(parts[0]), parts[1]), a), tape.exit(parts),
            *auxes)
    else:
        def whole(x, *rest):
            a, auxes = rest[:len(adds)], rest[len(adds):]
            h, = final(x, *a)
            return _total(*xent_loss(logits_fn(params["embed"], h, ctx),
                                     labels), auxes)

        outs = tape.run(whole, x, *adds, *auxes)
    return _metrics(*outs)


def cache_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict:
    B, S = shape.global_batch, shape.seq_len
    if cfg.family in ("dense", "moe", "vlm"):
        return T.stack_cache_specs(cfg, B, S)
    if cfg.family == "ssm":
        return RW.state_specs(cfg, B)
    if cfg.family == "hybrid":
        return MB.hybrid_cache_specs(cfg, B, S)
    if cfg.family == "audio":
        return AU.cache_specs(cfg, B, S)
    raise ValueError(cfg.family)


def prefill_fn(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx, params, batch):
    """Full-sequence prefill. Returns (last_token_logits (B, V), cache):
    ``prefill_segments`` on ``tensor_parallel.INLINE``."""
    return prefill_segments(cfg, run, ctx, tp.INLINE, params, batch)


def _last_logits(cfg: ModelConfig, ctx: ShardingCtx, tc, params, x, adds):
    """The last token's logits (B, V) from the stack's last residual and
    the terms still to add to it: the cell's vocabulary columns where the
    vocabulary is model-local. In a decode_flash decode step
    (``Plan.decode_2d``) the norm and the product of the cell's block of
    the features, the partial logits summed over the feature axes."""
    tape, plan = tc.tape, tc.plan
    if plan.decode_2d:
        _, h = T._normed_on(tc, x, adds, lambda: params["final_ln"],
                            cfg.norm_eps)
        lg, = tape.run(lambda h: (logits_fn(params["embed"], h[:, -1:],
                                            ctx)[:, 0],), h)
        return tape.exit(lg, plan.features)

    def head(x, *a):
        h = rms_norm(T._resid(x, a)[:, -1:], params["final_ln"], cfg.norm_eps)
        return (logits_fn(params["embed"], h, ctx)[:, 0],)

    return tape.run(head, x, *adds)[0]


def stack_leaves(w):
    """``stack(*path)`` over the stack's leaves ``w``: the subtree at
    ``path``, a key for each dict and an index into each stacked axis
    (``stack("layers", i)``; the VLM's ``stack("self", j, i)``,
    ``stack("cross", j)``; whisper's ``stack("encoder", i)``,
    ``stack("enc_ln")``, ``stack("decoder", i)``)."""
    def stack(*path):
        t = w
        for k in path:
            t = P.layer(t, k) if isinstance(k, int) else t[k]
        return t

    return stack


def prefill_segments(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx, tc,
                     params, batch, *, stack=None, cut=None):
    """``prefill_fn`` on the tape of ``tc`` (a cell of the partitioned
    serve, ``serve.step``, or ``INLINE``): the embedding (a partial
    lookup and an exit where the vocabulary is model-local), the stack
    (``transformer.prefill_segments``, the VLM's
    ``transformer.vlm_prefill_segments`` over the batch's
    ``image_embeds``, whisper's ``audio.prefill_segments`` over its
    ``frame_embeds``, ``rwkv.prefill_segments``,
    ``mamba2.prefill_segments``; the leaves at a path ``stack(*path)``,
    by default ``stack_leaves(params["stack"])``; ``cut`` the cell's
    ``attention.CacheCut``) and the last token's logits. Returns
    (logits, cache): the cell's vocabulary columns and cache shard in a
    serve cell."""
    dt = compute_dtype(run)
    tokens = batch["tokens"]
    _, x = _embedded(cfg, ctx, tc, params, tokens, dt)
    if stack is None:
        stack = stack_leaves(params["stack"])
    positions = _positions(tokens)
    if cfg.family == "vlm":
        x, adds, cache = T.vlm_prefill_segments(
            cfg, run, ctx, tc, stack, x, positions,
            batch["image_embeds"].to(dt), Q_CHUNK, cut=cut)
    elif cfg.family == "audio":
        x, adds, cache = AU.prefill_segments(
            cfg, run, ctx, tc, stack, x, batch["frame_embeds"].to(dt),
            positions, Q_CHUNK, cut=cut)
    elif cfg.family == "ssm":
        x, adds, cache = RW.prefill_segments(cfg, run, ctx, tc, stack, x,
                                             chunk=cfg.scan_chunk)
    elif cfg.family == "hybrid":
        x, adds, cache = MB.prefill_segments(cfg, run, ctx, tc, stack, x,
                                             positions, chunk=cfg.scan_chunk,
                                             cut=cut)
    else:
        x, adds, cache = T.prefill_segments(
            cfg, run, ctx, tc, lambda i: stack("layers", i), x, positions,
            Q_CHUNK, cfg.num_layers, cut=cut)
    return _last_logits(cfg, ctx, tc, params, x, adds), cache


def decode_fn(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx, params, cache,
              batch):
    """One decode step. batch: {tokens (B,1), pos}: ``pos`` a Python int.
    Returns (logits, cache): ``decode_segments`` on
    ``tensor_parallel.INLINE``.

    The ``decode_flash`` ruleset on a mesh takes the sequence-sharded
    ``flash_decode`` in every self attention (rwkv6 has none); without a
    mesh the dense decode, as in the reference."""
    return decode_segments(cfg, run, ctx, tp.INLINE, params, cache, batch)


def decode_segments(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx, tc,
                    params, cache, batch, *, stack=None, cut=None):
    """``decode_fn`` on the tape of ``tc``, as ``prefill_segments``:
    ``cache`` the whole cache, or the cell's shard of it. Returns
    (logits, cache)."""
    dt = compute_dtype(run)
    _, x = _embedded(cfg, ctx, tc, params, batch["tokens"], dt)
    if stack is None:
        stack = stack_leaves(params["stack"])
    pos, use_flash = batch["pos"], run.sharding_rules == "decode_flash"
    if cfg.family == "vlm":
        x, adds, cache = T.vlm_decode_segments(
            cfg, run, ctx, tc, stack, cache, x, pos, cut=cut,
            use_flash=use_flash)
    elif cfg.family == "audio":
        x, adds, cache = AU.decode_segments(
            cfg, run, ctx, tc, stack, cache, x, pos, cut=cut,
            use_flash=use_flash)
    elif cfg.family == "ssm":
        x, adds, cache = RW.decode_segments(cfg, run, ctx, tc, stack, cache,
                                            x)
    elif cfg.family == "hybrid":
        x, adds, cache = MB.decode_segments(cfg, run, ctx, tc, stack, cache,
                                            x, pos, cut=cut,
                                            use_flash=use_flash)
    else:
        x, adds, cache = T.decode_segments(
            cfg, run, ctx, tc, lambda i: stack("layers", i), cache, x, pos,
            cfg.num_layers, cut=cut, use_flash=use_flash)
    return _last_logits(cfg, ctx, tc, params, x, adds), cache
