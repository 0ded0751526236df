"""GQA attention: prefill (dense, chunked online-softmax, or the flash
kernel) and decode against a KV cache (ring buffer under a sliding window).

The counterpart of ``repro/models/attention.py``. ``attention_auto`` sends
every CUDA tensor to the CUDA flash kernel (``kernels/flash_attention``),
which masks the tails of both lengths and so takes any length; CPU tensors
take the reference's paths off the TPU (chunked from 2048 query tokens,
dense below). Sequence-sharded decode (``flash_decode``) and
cross-attention wait for their own slices (ROADMAP Queue 1 items 8-9).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.models import params as P
from repro_torch.models.common import apply_rope, matmul

NEG_INF = -1e30


# --- parameter specs -----------------------------------------------------------


def attn_specs(cfg: ModelConfig, *, cross: bool = False) -> Dict[str, P.TensorSpec]:
    d = cfg.d_model
    specs = {
        "wq": P.dense((d, cfg.q_dim), ("fsdp", "heads")),
        "wk": P.dense((d, cfg.kv_dim), ("fsdp", "kv_heads")),
        "wv": P.dense((d, cfg.kv_dim), ("fsdp", "kv_heads")),
        "wo": P.dense((cfg.q_dim, d), ("heads", "fsdp")),
    }
    if cfg.qkv_bias and not cross:
        specs["bq"] = P.dense((cfg.q_dim,), ("heads",), init="zeros")
        specs["bk"] = P.dense((cfg.kv_dim,), ("kv_heads",), init="zeros")
        specs["bv"] = P.dense((cfg.kv_dim,), ("kv_heads",), init="zeros")
    return specs


def project_q(cfg: ModelConfig, w, x, positions, ctx: ShardingCtx, *, rope=True):
    dt = x.dtype
    q = matmul(x, w["wq"])
    if "bq" in w:
        q = q + w["bq"].to(dt)
    B, S = x.shape[:2]
    q = q.reshape(B, S, cfg.num_heads, cfg.head_dim)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
    return ctx.constrain(q, ("batch", "seq_inner", "heads", "head_dim"))


def project_kv(cfg: ModelConfig, w, x, positions, ctx: ShardingCtx, *, rope=True):
    dt = x.dtype
    k = matmul(x, w["wk"])
    v = matmul(x, w["wv"])
    if "bk" in w:
        k = k + w["bk"].to(dt)
        v = v + w["bv"].to(dt)
    B, S = x.shape[:2]
    k = k.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    if rope:
        k = apply_rope(k, positions, cfg.rope_theta)
    k = ctx.constrain(k, ("batch", "seq_inner", "kv_heads", "head_dim"))
    v = ctx.constrain(v, ("batch", "seq_inner", "kv_heads", "head_dim"))
    return k, v


# --- core attention math ---------------------------------------------------------


def _split_groups(q: torch.Tensor, num_kv: int) -> torch.Tensor:
    """(B,S,Hq,D) -> (B,S,Hkv,G,D)."""
    B, S, Hq, D = q.shape
    return q.reshape(B, S, num_kv, Hq // num_kv, D)


def _mask(sq: int, skv: int, q_offset, *, causal: bool, window: int,
          device=None) -> torch.Tensor:
    """(sq, skv) boolean mask of allowed positions."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(skv, device=device)[None, :]
    m = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        m &= kpos <= qpos
    if window > 0:
        m &= kpos > (qpos - window)
    return m


def attention_dense(q, k, v, *, causal=True, window=0, softcap=0.0, q_offset=0):
    """Reference full-materialization GQA attention. q:(B,Sq,Hq,D) k/v:(B,Skv,Hkv,D)."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = _split_groups(q, Hkv)  # (B,Sq,Hkv,G,D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float()
    scores = scores / math.sqrt(D)
    if softcap > 0:
        scores = softcap * torch.tanh(scores / softcap)
    m = _mask(Sq, k.shape[1], q_offset, causal=causal, window=window,
              device=q.device)
    scores = torch.where(m[None, None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    return out.reshape(B, Sq, Hq, D)


def attention_chunked(q, k, v, *, causal=True, window=0, softcap=0.0,
                      q_chunk=1024, ctx: Optional[ShardingCtx] = None):
    """Softmax attention, one query chunk at a time.

    Temp memory is O(q_chunk x Skv) instead of O(Sq x Skv). For SWA the kv
    range per chunk is sliced to [chunk_end - window - q_chunk, chunk_end],
    as the reference slices it when window % q_chunk == 0.
    """
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    if Sq % q_chunk != 0:
        return attention_dense(q, k, v, causal=causal, window=window, softcap=softcap)
    n_chunks = Sq // q_chunk
    qg = _split_groups(q, Hkv).reshape(B, n_chunks, q_chunk, Hkv, Hq // Hkv, D)
    use_window_slice = causal and window > 0 and window % q_chunk == 0
    outs = []
    for i in range(n_chunks):
        if use_window_slice:
            span = min(window + q_chunk, k.shape[1])
            # lax.dynamic_slice clamps the start so the slice stays in range
            start = min(max(i * q_chunk + q_chunk - (window + q_chunk), 0),
                        k.shape[1] - span)
            kc, vc, kv_off = k[:, start:start + span], v[:, start:start + span], start
        else:
            kc, vc, kv_off = k, v, 0
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg[:, i], kc).float() / math.sqrt(D)
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        qpos = torch.arange(q_chunk, device=q.device)[:, None] + i * q_chunk
        kpos = torch.arange(kc.shape[1], device=q.device)[None, :] + kv_off
        m = torch.ones(s.shape[-2:], dtype=torch.bool, device=q.device)
        if causal:
            m &= kpos <= qpos
        if window > 0:
            m &= kpos > (qpos - window)
        s = torch.where(m[None, None, None], s, NEG_INF)
        p = torch.softmax(s, dim=-1).to(q.dtype)
        outs.append(torch.einsum("bhgqk,bkhd->bqhgd", p, vc))
    return torch.stack(outs, dim=1).reshape(B, Sq, Hq, D)


def attention_auto(q, k, v, *, causal=True, window=0, softcap=0.0, q_chunk=1024,
                   ctx: Optional[ShardingCtx] = None):
    """Backend dispatch: the CUDA flash kernel for CUDA tensors, at any
    length (the reference's TPU kernel needs a block of 128, 256 or 512 to
    divide both; this one masks the tails). CPU tensors take the plain paths,
    chunked at and beyond 2048 query tokens (bounds the scores temp at
    q_chunk x Skv), dense below."""
    if q.is_cuda:
        return fa.flash_attention(q, k, v, causal, window, softcap)
    if q.shape[1] >= 2048 and q.shape[1] % q_chunk == 0:
        return attention_chunked(q, k, v, causal=causal, window=window,
                                 softcap=softcap, q_chunk=q_chunk, ctx=ctx)
    return attention_dense(q, k, v, causal=causal, window=window, softcap=softcap)


# --- KV cache / decode -------------------------------------------------------------


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> Dict[str, P.TensorSpec]:
    shp = (batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
    logical = ("cache_batch", "cache_seq", "cache_heads", "head_dim")
    return {
        "k": P.dense(shp, logical, init="zeros", dtype="bfloat16"),
        "v": P.dense(shp, logical, init="zeros", dtype="bfloat16"),
    }


def effective_cache_len(cfg: ModelConfig, seq_len: int) -> int:
    # SWA caches are always window-sized ring buffers (decode continues past
    # the prefill length; index = pos %% window).
    if cfg.sliding_window > 0:
        return cfg.sliding_window
    return seq_len


def ring_layout(kv: torch.Tensor, window: int) -> torch.Tensor:
    """(B, S, H, D) full-prefill kv -> (B, window, H, D) ring-buffer layout
    where position p sits at index p %% window (zero-padded when S < window)."""
    S = kv.shape[1]
    if window <= 0:
        return kv
    if S < window:
        return torch.nn.functional.pad(kv, (0, 0, 0, 0, 0, window - S))
    tail = kv[:, -window:]
    return torch.roll(tail, shifts=S % window, dims=1)


def cache_update(cache_k, cache_v, k_new, v_new, pos: int, *, window=0):
    """Insert one token at ``pos`` (ring-buffer for SWA). k_new: (B,1,Hkv,D).
    Returns new tensors, as the reference does; ``pos`` must lie inside the
    cache (the reference's dynamic_update_slice would clamp it silently)."""
    cache_len = cache_k.shape[1]
    idx = pos % cache_len if window > 0 else pos
    if not 0 <= idx < cache_len:
        raise IndexError(f"decode position {pos} is past the KV cache "
                         f"({cache_len} slots); pad the cache for generation")
    ck, cv = cache_k.clone(), cache_v.clone()
    ck[:, idx] = k_new[:, 0].to(ck.dtype)
    cv[:, idx] = v_new[:, 0].to(cv.dtype)
    return ck, cv


def decode_attention(q, cache_k, cache_v, pos: int, *, window=0, softcap=0.0):
    """One-token attention against the cache. q: (B,1,Hq,D)."""
    B, _, Hq, D = q.shape
    Hkv = cache_k.shape[2]
    S = cache_k.shape[1]
    qg = _split_groups(q, Hkv)[:, 0]  # (B,Hkv,G,D)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, cache_k.to(q.dtype)).float()
    s = s / math.sqrt(D)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    kpos = torch.arange(S, device=q.device)
    if window > 0:
        valid = kpos < min(pos + 1, S)  # ring buffer: all slots valid once full
    else:
        valid = kpos <= pos
    s = torch.where(valid[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bhgk,bkhd->bhgd", p, cache_v.to(q.dtype))
    return out.reshape(B, 1, Hq, D)
