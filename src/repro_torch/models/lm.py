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
  cache_specs(cfg, shape)            decode-state tree
  prefill_fn(...) / decode_fn(...)   serving programs
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeSpec
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.models import audio as AU
from repro_torch.models import mamba2 as MB
from repro_torch.models import params as P
from repro_torch.models import rwkv as RW
from repro_torch.models import transformer as T
from repro_torch.models.common import (compute_dtype, embed_specs, embed_tokens,
                                       logits_fn, rms_norm, rms_norm_specs,
                                       xent_loss)

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
    """Full-sequence prefill. Returns (last_token_logits (B, V), cache)."""
    dt = compute_dtype(run)
    tokens = batch["tokens"]
    x = embed_tokens(params["embed"], tokens, ctx, dt)
    positions = _positions(tokens)
    w = params["stack"]
    if cfg.family in ("dense", "moe"):
        x, cache = T.stack_prefill(cfg, run, ctx, w, x, positions,
                                   q_chunk=Q_CHUNK)
    elif cfg.family == "vlm":
        img = batch["image_embeds"].to(dt)
        x, cache = T.stack_prefill(cfg, run, ctx, w, x, positions, img=img,
                                   q_chunk=Q_CHUNK)
    elif cfg.family == "ssm":
        x, cache = RW.stack_prefill(cfg, run, ctx, w, x, chunk=cfg.scan_chunk)
    elif cfg.family == "hybrid":
        x, cache = MB.stack_prefill(cfg, run, ctx, w, x, positions,
                                    chunk=cfg.scan_chunk)
    elif cfg.family == "audio":
        x, cache = AU.prefill(cfg, run, ctx, w, x,
                              batch["frame_embeds"].to(dt), positions,
                              q_chunk=Q_CHUNK)
    else:
        raise ValueError(cfg.family)
    x = rms_norm(x[:, -1:], params["final_ln"], cfg.norm_eps)
    logits = logits_fn(params["embed"], x, ctx)[:, 0]
    return logits, cache


def decode_fn(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx, params, cache,
              batch):
    """One decode step. batch: {tokens (B,1), pos}: ``pos`` a Python int.
    Returns (logits, cache).

    The ``decode_flash`` ruleset on a mesh takes the sequence-sharded
    ``flash_decode`` in every self attention (rwkv6 has none); without a
    mesh the dense decode, as in the reference."""
    dt = compute_dtype(run)
    x = embed_tokens(params["embed"], batch["tokens"], ctx, dt)
    pos = batch["pos"]
    use_flash = run.sharding_rules == "decode_flash"
    w = params["stack"]
    if cfg.family in ("dense", "moe", "vlm"):
        x, cache = T.stack_decode(cfg, run, ctx, w, cache, x, pos,
                                  use_flash=use_flash)
    elif cfg.family == "ssm":
        x, cache = RW.stack_decode(cfg, run, ctx, w, cache, x)
    elif cfg.family == "hybrid":
        x, cache = MB.stack_decode(cfg, run, ctx, w, cache, x, pos,
                                   use_flash=use_flash)
    elif cfg.family == "audio":
        x, cache = AU.decode_step(cfg, run, ctx, w, cache, x, pos,
                                  use_flash=use_flash)
    else:
        raise ValueError(cfg.family)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    logits = logits_fn(params["embed"], x, ctx)[:, 0]
    return logits, cache
