"""GQA attention: prefill (dense, chunked online-softmax, or the flash
kernel) and decode against a KV cache (ring buffer under a sliding window).

The counterpart of ``repro/models/attention.py``. ``attention_auto`` sends
every CUDA tensor to the CUDA flash kernel (``kernels/flash_attention``),
which masks the tails of both lengths and so takes any length; CPU tensors
take the reference's paths off the TPU (chunked from 2048 query tokens,
dense below). Cross-attention (the VLM's image layers, whisper's
decoder) takes q from the stream and k, v from the encoder states, with no
rope and no mask: CUDA tensors go through the flash kernel, CPU tensors
through ``attention_dense``, as the reference computes it; its decode step
against the cached encoder KV stays plain on every device.
``flash_decode`` is the sequence-sharded decode of the ``decode_flash``
ruleset: torch ops inside ``distributed.spmd.shard_map``, as the
reference writes it in ``jnp`` inside ``shard_map``. A cell of the
partitioned serve (``serve.step``) holds its shard of the KV cache as
the rules cut it (``CacheCut``): ``cache_rest`` lays a prefill's k and v
out so, ``cell_decode`` writes a token into it and attends over it, the
partials of a sequence cut combined as ``flash_decode``'s are
(``decode_partial``, ``combine_partials``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import takes_kernels
from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.launch.mesh import mesh_axis_sizes
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
    """q (B, S, H, D): H the heads of ``wq``'s columns, all of them or a
    tensor-parallel cell's own (``distributed.tensor_parallel``)."""
    q = heads_of(cfg, biased(matmul(x, w["wq"]), w, "bq"), positions, rope)
    return ctx.constrain(q, ("batch", "seq_inner", "heads", "head_dim"))


def project_kv(cfg: ModelConfig, w, x, positions, ctx: ShardingCtx, *, rope=True):
    """k, v (B, S, Hkv, D): Hkv the heads of ``wk``'s columns."""
    k = heads_of(cfg, biased(matmul(x, w["wk"]), w, "bk"), positions, rope)
    v = heads_of(cfg, biased(matmul(x, w["wv"]), w, "bv"), positions, False)
    k = ctx.constrain(k, ("batch", "seq_inner", "kv_heads", "head_dim"))
    v = ctx.constrain(v, ("batch", "seq_inner", "kv_heads", "head_dim"))
    return k, v


def biased(y: torch.Tensor, w, name: str) -> torch.Tensor:
    """A projection ``y`` plus the bias ``w[name]``, where ``w`` has one,
    in ``y``'s dtype."""
    return y + w[name].to(y.dtype) if name in w else y


def heads_of(cfg: ModelConfig, y: torch.Tensor, positions, rope: bool
             ) -> torch.Tensor:
    """A projection (B, S, H x D) as heads (B, S, H, D), roped at
    ``positions`` with ``rope``."""
    B, S = y.shape[:2]
    y = y.reshape(B, S, y.shape[-1] // cfg.head_dim, cfg.head_dim)
    return apply_rope(y, positions, cfg.rope_theta) if rope else y


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
    """Backend dispatch: the CUDA flash kernel for CUDA tensors (its
    operator for the dry-run's meta tensors: ``device.takes_kernels``), at any
    length (the reference's TPU kernel needs a block of 128, 256 or 512 to
    divide both; this one masks the tails). CPU tensors take the plain paths,
    chunked at and beyond 2048 query tokens (bounds the scores temp at
    q_chunk x Skv), dense below."""
    if takes_kernels(q):
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


def decode_partial(q, cache_k, cache_v, pos: int, base: int, total: int, *,
                   window=0, softcap=0.0):
    """One block of a cache's slots, ``[base, base + n)`` of ``total``
    (the cache's whole length), against one token's q (B,1,Hq,D): the
    block's unnormalised output (B,Hkv,G,D), the log-sum-exp of its scores
    and their exponentials' sum (B,Hkv,G), for ``combine_partials``."""
    n, Hkv = cache_k.shape[1], cache_k.shape[2]
    D = q.shape[-1]
    qg = _split_groups(q, Hkv)[:, 0]
    s = torch.einsum("bhgd,bkhd->bhgk", qg, cache_k.to(q.dtype)).float()
    s = s / math.sqrt(D)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    kpos = torch.arange(n, device=q.device) + base
    if window > 0:
        valid = kpos < min(pos + 1, total)
    else:
        valid = kpos <= pos
    s = torch.where(valid[None, None, None], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    # guard all-masked shards
    m_safe = torch.clamp(m, min=NEG_INF / 2)
    e = torch.exp(s - m_safe)
    denom = e.sum(dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", e.to(q.dtype), cache_v.to(q.dtype))
    lse = m_safe[..., 0] + torch.log(torch.clamp(denom, min=1e-30))
    return o, lse, denom


def combine_partials(o, lse, denom, dtype, pmax, psum):
    """The blocks' partials (``decode_partial``) combined over a group by
    their log-sum-exp: ``pmax`` and ``psum`` its collectives. Returns the
    attention output (B,Hkv,G,D) in ``dtype``."""
    g_max = pmax(lse)
    w = torch.exp(lse - g_max)  # (B,Hkv,G)
    o = o * (w / torch.clamp(denom, min=1e-30))[..., None].to(dtype)
    o = psum(o.float())
    z = psum(w)
    return (o / z[..., None]).to(dtype)


def flash_decode(q, cache_k, cache_v, pos: int, mesh, *, axis="model",
                 softcap=0.0, window=0, q_replicated=True):
    """Sequence-sharded decode attention (flash-decoding), the reference's
    line for line. ``pos`` is a Python int.

    The KV cache is batch-sharded over the batch axes ("pod", "data") and
    seq-sharded over ``axis``; each shard computes a partial (out, lse)
    (``decode_partial``) and the results combine by the log-sum-exp trick
    through ``pmax`` and ``psum`` (``combine_partials``), one small
    collective instead of gathering the cache.

    ``q_replicated=True`` (the decode_flash ruleset): single-token
    activations are replicated over the batch axes, so each shard slices
    the batch rows of its cache shard, attends locally, and an
    ``all_gather`` replicates the output again.
    """
    S = cache_k.shape[1]
    sizes = mesh_axis_sizes(mesh)
    shard_len = S // sizes[axis]
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)

    def per_shard(q_, ck_, cv_):
        if q_replicated and batch_axes:
            b_loc = ck_.shape[0]
            bidx = spmd.axis_index(batch_axes[0])
            for a in batch_axes[1:]:  # row-major over the joint batch axes
                bidx = bidx * sizes[a] + spmd.axis_index(a)
            q_ = q_[bidx * b_loc:(bidx + 1) * b_loc]
        B_loc, _, Hq_, D_ = q_.shape  # per-shard shapes (batch is sharded)
        base = spmd.axis_index(axis) * shard_len
        o = combine_partials(
            *decode_partial(q_, ck_, cv_, pos, base, S, window=window,
                            softcap=softcap), q_.dtype,
            lambda t: spmd.pmax(t, axis), lambda t: spmd.psum(t, axis))
        o = o.reshape(B_loc, 1, Hq_, D_)
        if q_replicated and batch_axes:
            for a in reversed(batch_axes):  # tiny: (B,1,Hq,D)
                o = spmd.all_gather(o, a, axis=0)
        return o

    spec_q = (None,) if q_replicated or not batch_axes else (batch_axes,)
    spec_kv = (batch_axes if batch_axes else None, axis)
    fn = spmd.shard_map(per_shard, mesh, in_specs=(spec_q, spec_kv, spec_kv),
                        out_specs=spec_q)
    return fn(q, cache_k, cache_v)


# --- the KV cache in a cell of the partitioned serve -------------------------------
# A cell of the partitioned serve (``serve.step``) computes on its batch
# rows and, where the plan keeps attention model-local, on its own heads;
# its shard of the cache rests as the rules cut it: the batch over the
# data axes, and over ``model`` the sequence (``cache_seq``), else the kv
# heads (``cache_heads``), else nothing. Its collectives go through the
# cell's tape (``distributed.tensor_parallel.Forward``).


@dataclasses.dataclass(frozen=True)
class CacheCut:
    """Where a serve cell's cache shard lies over ``model``: ``dim`` the
    dim of a layer's (B, S, Hkv, D) cache that ``model`` cuts (1 the
    sequence, 2 the kv heads, None neither) into ``size`` blocks, of which
    the cell holds block ``index``; ``local``: the cell computes with its
    own kv heads (model-local attention), not with all of them; ``conv``:
    ``model`` cuts the channels of a Mamba2 layer's (B, K-1, channels)
    conv state into ``size`` even blocks (``models.mamba2``); ``rows``:
    in a decode_flash decode step, whose activations hold every row, the
    mesh axes that cut the cache's rows (``cell_decode`` attends on the
    cell's rows and gathers the output over them)."""

    dim: Optional[int]
    size: int
    index: int
    local: bool
    conv: bool = False
    rows: Tuple[str, ...] = ()

    def block(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The cell's block of ``t`` cut over ``model`` along ``dim``."""
        n = t.shape[dim] // self.size
        return t.narrow(dim, self.index * n, n)


def cache_rest(tape, kv: torch.Tensor, cut: CacheCut) -> torch.Tensor:
    """The cell's shard of a layer's cache at rest, from ``kv`` (B, S, H,
    D): its batch rows over the whole sequence, its own kv heads where
    attention is model-local, else all of them. Cut over the sequence, a
    model-local cell's heads cross the group (each cell its sequence
    block of every head: one all-to-all); else the block is a copy, so
    that the layer's whole ``kv`` is freed after the layer."""
    if cut.dim == 1:
        if not cut.local:
            return cut.block(kv, 1).clone()
        B, S, H, D = kv.shape
        n = cut.size
        blocks = kv.reshape(B, n, S // n, H, D).movedim(1, 0)
        # each cell receives its sequence block of every cell's heads
        got = tape.all_to_all(blocks, "model", 0, 2)  # (B, S/n, n, H, D)
        return got.reshape(B, S // n, n * H, D)
    if cut.dim == 2:
        return kv if cut.local else cut.block(kv, 2)
    return tape.all_gather(kv, "model", 2) if cut.local else kv


def _heads_gathered(tape, cut: CacheCut, *ts):
    """One token's tensors (B, 1, H_i, D) of the cell's heads, each with
    every cell's heads in group order: one all-gather for all of them."""
    sizes = [t.shape[2] for t in ts]
    B, _, _, D = ts[0].shape
    got = tape.all_gather(torch.cat(ts, dim=2), "model", 2)
    got = got.reshape(B, 1, cut.size, sum(sizes), D)
    return tuple(part.reshape(B, 1, cut.size * h, D)
                 for part, h in zip(got.split(sizes, dim=3), sizes))


def cell_decode(tape, q, k, v, cache_k, cache_v, pos: int, cut: CacheCut, *,
                window=0, softcap=0.0):
    """One token's attention in a serve cell against its cache shard: q
    (B,1,Hq',D) and the new k, v (B,1,Hkv',D) of the cell's heads (its
    own where attention is model-local, else all). The token is written
    into the cache (at ``pos``, or ``pos`` mod the window in a ring) by the
    cell whose block holds that slot, with every kv head; cut over the
    sequence, each cell attends over its block and the group combines the
    partials (``combine_partials``). Where ``cut.rows`` cut the cache's
    rows and q, k, v hold every row (decode_flash), the cell attends on
    its rows and the output is gathered over ``cut.rows``, as
    ``flash_decode`` with ``q_replicated`` does. Returns (the output of
    the cell's q heads, the cache shard's k, v)."""
    if not cut.rows:
        return _shard_decode(tape, q, k, v, cache_k, cache_v, pos, cut,
                             window=window, softcap=softcap)
    n = cache_k.shape[0]
    lo = spmd.axis_index(cut.rows) * n
    o, cache_k, cache_v = _shard_decode(
        tape, *(t.narrow(0, lo, n) for t in (q, k, v)), cache_k, cache_v,
        pos, cut, window=window, softcap=softcap)
    return tape.all_gather(o, cut.rows, 0), cache_k, cache_v


def _shard_decode(tape, q, k, v, cache_k, cache_v, pos: int, cut: CacheCut,
                  *, window=0, softcap=0.0):
    """``cell_decode`` on q, k, v of the cache shard's rows."""
    local = cut.local
    if cut.dim == 1:
        if local:  # one token: every head in every cell
            q, k, v = _heads_gathered(tape, cut, q, k, v)
        n = cache_k.shape[1]
        total = n * cut.size
        idx = pos % total if window > 0 else pos
        if not 0 <= idx < total:
            raise IndexError(f"decode position {pos} is past the KV cache "
                             f"({total} slots); pad the cache for "
                             f"generation")
        base = cut.index * n
        if base <= idx < base + n:
            cache_k, cache_v = cache_update(cache_k, cache_v, k, v,
                                            idx - base)
        B, _, Hq, D = q.shape
        o = combine_partials(
            *decode_partial(q, cache_k, cache_v, pos, base, total,
                            window=window, softcap=softcap), q.dtype,
            tape.pmax, tape.exit).reshape(B, 1, Hq, D)
        return (cut.block(o, 2) if local else o), cache_k, cache_v
    if cut.dim == 2:
        if not local:  # the cache's kv heads and their q heads
            q, k, v = (cut.block(t, 2) for t in (q, k, v))
        cache_k, cache_v = cache_update(cache_k, cache_v, k, v, pos,
                                        window=window)
        o = decode_attention(q, cache_k, cache_v, pos, window=window,
                             softcap=softcap)
        return (o if local else tape.all_gather(o, "model", 2)), \
            cache_k, cache_v
    if local:
        k, v = _heads_gathered(tape, cut, k, v)
    cache_k, cache_v = cache_update(cache_k, cache_v, k, v, pos,
                                    window=window)
    ck, cv = ((cut.block(cache_k, 2), cut.block(cache_v, 2)) if local
              else (cache_k, cache_v))
    o = decode_attention(q, ck, cv, pos, window=window, softcap=softcap)
    return o, cache_k, cache_v


# --- cross attention ------------------------------------------------------------


def attention_full(q, k, v):
    """Non-causal attention with no window or softcap, Skv free: the flash
    kernel for CUDA tensors, ``attention_dense`` (the reference's path) for
    CPU tensors, whatever their length."""
    if takes_kernels(q):
        return fa.flash_attention(q, k, v, causal=False)
    return attention_dense(q, k, v, causal=False)


def cross_kv(cfg: ModelConfig, w, enc):
    """(k, v) (B, T, H_kv, D) of enc (B, T, d) on the kv heads of ``w``'s
    columns: all of them, or a tensor-parallel cell's own. A serve
    caches them; the reference projects them again beside the cross
    attention, and so does the port."""
    B, T = enc.shape[:2]
    return tuple(matmul(enc, w[name]).reshape(B, T, -1, cfg.head_dim)
                 for name in ("wk", "wv"))


def cross_attention(cfg: ModelConfig, w, x, enc, ctx: ShardingCtx):
    """q from x (B,S,d); kv from enc (B,T,d). No causal mask, no rope.
    The heads are those of ``w``'s columns: all of them, or a
    tensor-parallel cell's own (then the output is a partial sum)."""
    B, S = x.shape[:2]
    q = matmul(x, w["wq"]).reshape(B, S, -1, cfg.head_dim)
    k, v = cross_kv(cfg, w, enc)
    q = ctx.constrain(q, ("batch", "seq", "heads", "head_dim"))
    out = attention_full(q, k, v)
    return matmul(out.reshape(B, S, -1), w["wo"])


def cross_decode(cfg: ModelConfig, w, x, ck, cv):
    """Decode-time cross attention against the precomputed encoder KV
    (stored in bfloat16, cast back to the activations' dtype). The heads
    are those of ``w``'s columns and of ``ck``, ``cv``: all of them, or a
    serve cell's own (then the output is a partial sum)."""
    dt = x.dtype
    B = x.shape[0]
    q = matmul(x, w["wq"]).reshape(B, 1, -1, cfg.head_dim)
    out = attention_dense(q, ck.to(dt), cv.to(dt), causal=False)
    return matmul(out.reshape(B, 1, -1), w["wo"])
