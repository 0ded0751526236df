"""Decoder-only transformer blocks and stacks (dense / MoE / VLM families),
the counterpart of ``repro/models/transformer.py``.

A block (attention + MLP, or attention + MoE layer): specs, the
teacher-forced forward (``block_apply``: the segmented stack's layer, the
same code as in a cell of the partitioned training step, on
``tensor_parallel.INLINE``), the prefill that also returns the block's
(k, v), and one decode step against a KV cache (``layer_prefill`` and
``layer_decode``: the serve stack's layers, the same code in a cell of
the partitioned serve and on ``INLINE``); the zamba2 stack applies it as
its weight-tied shared block. The dense and MoE stacks keep the
reference's stacked ``(L, ...)`` parameters and run their layers through
``scan_utils.grouped_scan`` (remat per layer under ``run.remat ==
"block"``). The VLM family stacks super-blocks of ``cross_attn_every``
layers ([p-1 self layers, 1 gated cross-attention layer] x groups,
llama-3.2 style): its self leaves are stacked twice, ``(groups, p-1,
...)``, and under block remat each self layer is checkpointed inside a
checkpoint of its group, as the reference nests them. Its serve
programs are ``vlm_prefill_segments`` and ``vlm_decode_segments``: the
self caches stacked ``(groups, p-1, ...)``, the cross KV ``(groups,
...)``, as the reference's.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.models import attention as A
from repro_torch.models import moe as M
from repro_torch.models import params as P
from repro_torch.models.common import (gated, matmul, mlp_apply, mlp_specs,
                                       rms_norm, rms_norm_specs, sum_squares)


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


def _attention_out(cfg: ModelConfig, ctx: ShardingCtx, wa, h, positions,
                   q_chunk, causal: bool = True,
                   kv_block: Optional[Tuple[int, int]] = None):
    """(attn(h) through ``wo``, k, v) of the heads ``wa`` holds: all of
    them, or a tensor-parallel cell's own (then a partial sum). ``causal``
    False: bidirectional, with no window or softcap, whatever ``cfg``
    says (whisper's encoder, ``attention_full``). ``kv_block``: ``wa``
    holds the cell's q heads and every kv head (``Plan.qheads``), and
    the q heads read the kv heads ``[lo, hi)``; k and v of every kv head
    are returned."""
    B, S, _ = h.shape
    q = A.project_q(cfg, wa, h, positions, ctx)
    k, v = A.project_kv(cfg, wa, h, positions, ctx)
    ka, va = (k, v) if kv_block is None else (
        t[:, :, kv_block[0]:kv_block[1]] for t in (k, v))
    if causal:
        o = A.attention_auto(q, ka, va, causal=cfg.causal,
                             window=cfg.sliding_window,
                             softcap=cfg.attn_logit_softcap, q_chunk=q_chunk,
                             ctx=ctx)
    else:
        o = A.attention_full(q, ka, va)
    return matmul(o.reshape(B, S, -1), wa["wo"]), k, v


def block_apply(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx, w, x,
                positions, *, q_chunk: int = 1024):
    """Returns (x, aux_loss): the MoE layer's, or 0. The segmented
    stack's layer (``layer_segments``) on ``tensor_parallel.INLINE``."""
    x, adds, aux = layer_segments(cfg, run, ctx, tp.INLINE, lambda: w, x, (),
                                  positions, q_chunk)
    x = _resid(x, adds)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


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


def _gated(gate, o):
    """tanh(gate) o, in ``o``'s dtype."""
    return torch.tanh(gate).to(o.dtype) * o


def cross_block_apply(cfg: ModelConfig, ctx: ShardingCtx, w, x, img):
    """The gated cross-attention layer: the segmented stack's cross half
    (``cross_segments``) on ``tensor_parallel.INLINE``."""
    x, adds = cross_segments(cfg, ctx, tp.INLINE, lambda: w, x, (), img)
    return _resid(x, adds)


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


# --- the segmented stack: tensor parallelism over "model" ----------------------------
# The dense, MoE and VLM training stacks, written once for both callers
# (whisper's, ``models.audio``, reuses the halves): each
# half of a layer is a segment ahead of its entry (the residual sum, the
# norm and, for the MoE, the routing: replicated work, rule (a)) and a
# segment of the layer's own work, whose output the next segment adds to
# the residual stream. In a cell of the partitioned training step
# (``train.step``) the segments run on a ``distributed.tensor_parallel.Tape``
# with an entry and an exit around the work of a model-local half (the
# cell's heads, columns or experts); a half gathered whole over ``model``
# has no collective there. Outside the step (``block_apply``,
# ``cross_block_apply``) the same halves run on ``tensor_parallel.INLINE``:
# plain calls, no collective.


def _resid(x, adds):
    """``x`` plus the terms a layer's half left to add: its output and,
    after a MoE layer, its shared MLP's."""
    if not adds:
        return x
    y = adds[0].reshape(x.shape)
    for a in adds[1:]:
        y = y + a.reshape(x.shape)
    return x + y


def _normed(x, adds, scale, eps: float):
    """The replicated head of a half: (the residual stream, its norm)."""
    x = _resid(x, adds)
    return x, rms_norm(x, scale, eps)


def _normed_on(tc, x, adds, scale: Callable, eps: float):
    """``_normed`` on the tape of ``tc``, its scale ``scale()``: one
    segment; in a decode_flash decode step (``Plan.decode_2d``), on the
    cell's block of the features, each row's sum of squares totalled over
    the feature axes between two segments and the scale's block."""
    tape, plan = tc.tape, tc.plan
    if not plan.decode_2d:
        return tape.run(lambda x, *a: _normed(x, a, scale(), eps), x,
                        *adds)

    def squares(x, *a):
        x = _resid(x, a)
        return x, sum_squares(x)

    x, ss = tape.run(squares, x, *adds)
    ss = tape.total(ss, plan.features)
    h, = tape.run(lambda x, ss: (rms_norm(
        x, tc.feature_block(scale()), eps,
        mean_square=ss / scale().shape[-1]),), x, ss)
    return x, h


def _same(t):
    return t


def _attn_half(cfg, ctx, tc, wl, x, adds, positions, q_chunk, *,
               causal: bool = True, kv: Optional[Callable] = None):
    """The attention half of a layer (``causal``: ``_attention_out``'s).
    Returns (x, adds): the residual stream and what the next segment adds
    to it; with ``kv`` (a serve's prefill) also the cell's k and v, each
    passed through ``kv`` in the local segment: (x, adds, (k, v))."""
    tape = tc.tape
    local = tc.plan.attn or tc.plan.qheads
    kv_block = tc.kv_heads(cfg) if tc.plan.qheads else None
    x, h = tape.run(lambda x, *a: _normed(x, a, wl()["ln1"], cfg.norm_eps),
                    x, *adds)

    def work(h):
        o, k, v = _attention_out(cfg, ctx, wl()["attn"], h, positions,
                                 q_chunk, causal, kv_block)
        return (o,) if kv is None else (o, kv(k), kv(v))

    part, *cache = tape.run(work, tape.enter(h) if local else h)
    out = (tape.exit(part) if local else part,)
    return (x, out) if kv is None else (x, out, tuple(cache))


def _mlp_half(cfg, run, ctx, tc, wl, x, adds, *, act: Optional[str] = None):
    """The dense MLP half, its activation ``act`` (default ``cfg.act``;
    whisper's is gelu whatever ``cfg.act`` says). Returns (x, adds,
    aux=None)."""
    tape = tc.tape
    local = tc.plan.mlp
    x, h = _normed_on(tc, x, adds, lambda: wl()["ln2"], cfg.norm_eps)
    if tc.plan.decode_2d:  # the gate and up products of the cell's features
        gu, = tape.run(lambda h: (_products(h, wl()["mlp"], (
            "w_gate", "w_up")),), h)
        gu = tape.exit(gu, tc.plan.features)
        part, = tape.run(lambda gu: (matmul(gated(
            *gu.chunk(2, dim=-1), act or cfg.act), wl()["mlp"]["w_down"]),),
            gu)
    else:
        part, = tape.run(lambda h: (mlp_apply(wl()["mlp"], h, ctx,
                                              act or cfg.act),),
                         tape.enter(h) if local else h)
    return x, (tape.exit(part) if local else part,), None


def _products(h, w, names):
    """``h`` times each leaf ``w[name]``, side by side on the last dim:
    in a decode_flash decode step the partial products of the cell's block
    of the features, which one exit sums over the feature axes."""
    return torch.cat([matmul(h, w[name]) for name in names], dim=-1)


def _xattn_half(cfg, ctx, tc, wl, x, adds, src, ln: str, *,
                kv: Optional[Callable] = None):
    """The cross-attention half of a layer (its leaves ``wl()["xattn"]``,
    its norm ``wl()[ln]``): the norm ahead of the entry (rule (a)); q from
    the cell's heads of the entered stream, k and v from ``src`` on its
    kv heads, out through its rows of ``wo`` and the exit. ``src`` is a
    segment input: a batch input (the VLM's image embeddings, no
    gradient) as it is; an activation (whisper's encoder output) entered
    where the half is model-local, so its gradient sums over the cells;
    or, in a decode step, the cached cross KV ``(ck, cv)`` of the cell's
    kv heads (``attention.cross_decode``). Returns (x, adds); with ``kv``
    (a serve's prefill) also the cross KV of the cell's kv heads, each
    passed through ``kv`` in the local segment: (x, adds, (k, v))."""
    tape = tc.tape
    local = tc.plan.xattn
    x, h = tape.run(lambda x, *a: _normed(x, a, wl()[ln], cfg.norm_eps),
                    x, *adds)
    cached = isinstance(src, tuple)
    srcs = src if cached else (src,)
    if local:
        h = tape.enter(h)
        srcs = tuple(tape.enter(t) if t.requires_grad else t for t in srcs)

    def work(h, *srcs):
        wx = wl()["xattn"]
        if cached:
            return (A.cross_decode(cfg, wx, h, *srcs),)
        o = A.cross_attention(cfg, wx, h, srcs[0], ctx)
        if kv is None:
            return (o,)
        k, v = A.cross_kv(cfg, wx, srcs[0])
        return o, kv(k), kv(v)

    part, *cache = tape.run(work, h, *srcs)
    out = (tape.exit(part) if local else part,)
    return (x, out) if kv is None else (x, out, tuple(cache))


def _moe_whole(cfg, run, ctx, tc, wl, x, adds):
    """The MoE half outside the partitioned step: ``moe.moe_apply``
    (whose a2a on a mesh with a ``model`` axis is its own ``shard_map``).
    Returns (x, adds, aux)."""
    x, h = _normed(x, adds, wl()["ln2"], cfg.norm_eps)
    y, aux = M.moe_apply(cfg, ctx, wl()["moe"], h, impl=run.moe_impl)
    return x, (y,), aux


def _moe_half(cfg, run, ctx, tc, wl, x, adds):
    """The MoE half in a step cell, dense dispatch: the routing whole in
    the replicated segment (its aux loss counted once: rule (b)); the
    routing weights enter the expert segment beside the activations, so
    their gradient is summed over ``model``. Where a token group crosses
    an edge between the data cells (``moe.moe_groups``), the cells gather
    the microbatch's router logits over the batch axes and route every
    group of it, as the reference routes its global microbatch: each
    keeps its own rows' routing and the aux loss of all the groups.
    Returns (x, adds, aux)."""
    from repro_torch.distributed import spmd

    tape, plan = tc.tape, tc.plan
    if plan.decode_2d:
        return _moe_2d(cfg, ctx, tc, wl, x, adds)
    B, S, d = x.shape
    T = B * S
    batch = plan.batch_axes
    group, spans = M.moe_groups(T, spmd.axis_size(batch) if batch else 1)
    lo = spmd.axis_index(batch) * T if spans else 0
    pieces = M.group_pieces(lo, T, group)
    shared_here = cfg.shared_expert and not plan.shared

    def wm():
        return wl()["moe"]

    def pre(x, *a):
        x, h = _normed(x, a, wl()["ln2"], cfg.norm_eps)
        logits = M.router_logits(wm(), h.reshape(T, d), pieces)
        out = [x, h, *((logits,) if spans else
                       M.route_logits(cfg, logits, group))]
        if shared_here:
            out.append(mlp_apply(wm()["shared"], h, ctx, cfg.act))
        return out

    x, h, *rest = tape.run(pre, x, *adds)
    if spans:
        logits = tape.all_gather(rest.pop(0), batch, 0, replicated=False)

        def route(lg):
            w, ids, slot, keep, aux = M.route_logits(cfg, lg, group)
            return (*(t[lo:lo + T] for t in (w, ids, slot, keep)), aux)

        routed = list(tape.run(route, logits))
    else:
        routed, rest = rest[:5], rest[5:]
    w, ids, slot, keep, aux = routed
    enter = tape.enter if plan.experts else _same
    h_in, w_in = enter(h), enter(w)
    first = tc.block(cfg.num_experts)[0] if plan.experts else 0

    def experts(h, w, ids, slot, keep):
        y = M.experts_apply(cfg, wm(), h.reshape(T, d), w, ids, slot, keep,
                            first, group, pieces).reshape(B, S, d)
        if cfg.shared_expert and plan.shared:
            y = y + mlp_apply(wm()["shared"], h, ctx, cfg.act)
        return (y,)

    part, = tape.run(experts, h_in, w_in, ids, slot, keep)
    y = tape.exit(part) if plan.experts else part
    return x, (y, *rest), aux


def _moe_2d(cfg, ctx, tc, wl, x, adds):
    """The MoE half of a decode_flash decode step, dense dispatch, on the
    cell's block of the features (``Plan.decode_2d``; every row in every
    cell, one token group): the router's partial logits of the cell's
    experts summed over the feature axes and gathered over ``model``, so
    that every cell routes every token alike; the dispatch of the cell's
    features, its experts' gate and up products and the shared MLP's
    (where it has one) summed over the feature axes in one exit; ``w_down``
    onto the cell's features, the combine and the shared MLP's rows
    summed over ``model`` where they are the cell's own. Returns (x,
    adds, aux)."""
    tape, plan = tc.tape, tc.plan
    x, h = _normed_on(tc, x, adds, lambda: wl()["ln2"], cfg.norm_eps)
    B, S, db = h.shape
    T = B * S
    group, _ = M.moe_groups(T, 1)
    pieces = M.group_pieces(0, T, group)

    def wm():
        return wl()["moe"]

    lg, = tape.run(lambda h: (M.router_logits(wm(), h.reshape(T, db),
                                              pieces),), h)
    lg = tape.exit(lg, plan.features)
    if plan.experts:
        lg = tape.all_gather(lg, tp.AXIS, 1)
    w, ids, slot, keep, aux = tape.run(
        lambda lg: M.route_logits(cfg, lg, group), lg)
    first = tc.block(cfg.num_experts)[0] if plan.experts else 0
    shared = cfg.shared_expert

    def ups(h, w, ids, slot, keep):
        combine, gu = M.experts_up(cfg, wm(), h.reshape(T, db), w, ids,
                                   slot, keep, first, group, pieces)
        parts = [gu.reshape(-1)]
        if shared:
            parts.append(_products(h, wm()["shared"],
                                   ("w_gate", "w_up")).reshape(-1))
        return combine, torch.cat(parts)

    combine, flat = tape.run(ups, h, w, ids, slot, keep)
    flat = tape.exit(flat, plan.features)

    def downs(combine, flat):
        """(the sum of the outputs that are partial sums over ``model``,
        the sum of the others), each None where there is none."""
        n = (len(pieces) * combine.shape[1] * combine.shape[2] * 2
             * wm()["w_gate"].shape[-1])
        parts = [(M.experts_down(wm(), flat[:n], combine, pieces).reshape(
            B, S, db), plan.experts)]
        if shared:
            gu = flat[n:].reshape(B, S, -1)
            parts.append((matmul(gated(*gu.chunk(2, dim=-1), cfg.act),
                                 wm()["shared"]["w_down"]), plan.shared))
        return [functools.reduce(torch.add, ts) if ts else None
                for ts in ([t for t, mine in parts if mine],
                           [t for t, mine in parts if not mine])]

    part, rest = tape.run(downs, combine, flat)
    out = (None if part is None else tape.exit(part), rest)
    return x, tuple(t for t in out if t is not None), aux


def _a2a_half(cfg, run, ctx, tc, wl, x, adds):
    """The MoE half in a step cell, expert-parallel (``moe_a2a``) on the
    step's own ``model`` axis: the activations and the router enter
    (each rank routes its slice of the tokens, so the router's gradient
    is a partial sum), the all-to-all pair moves the buckets, the
    all-gather rejoins the ranks' slices, and the ranks' aux losses are
    summed by an exit and averaged. Returns (x, adds, aux)."""
    from repro_torch.models import moe_a2a as MA

    tape, plan = tc.tape, tc.plan
    n = plan.size
    if n > 1 and not plan.experts:
        raise ValueError(f"{cfg.num_experts} experts do not split over "
                         f"{n} model ranks")
    B, S, d = x.shape
    T = B * S
    shared_here = cfg.shared_expert and not plan.shared

    def wm():
        return wl()["moe"]

    def pre(x, *a):
        x, h = _normed(x, a, wl()["ln2"], cfg.norm_eps)
        out = [x, h, wm()["router"]]
        if shared_here:
            out.append(mlp_apply(wm()["shared"], h, ctx, cfg.act))
        return out

    x, h, router, *rest = tape.run(pre, x, *adds)
    m = tc.index()

    def route(h, router):
        send, packing, aux = MA.a2a_route(cfg, n, m, h.reshape(T, d), router)
        out = [send, *packing, aux]
        if cfg.shared_expert and plan.shared:
            out.append(mlp_apply(wm()["shared"], h, ctx, cfg.act))
        return out

    outs = tape.run(route, tape.enter(h), tape.enter(router))
    send, packing, aux, shared = outs[0], outs[1:6], outs[6], outs[7:]
    recv = tape.all_to_all(send, "model", 0, 0)
    ye, = tape.run(lambda r: (MA.a2a_experts(
        r, wm()["w_gate"], wm()["w_up"], wm()["w_down"]),), recv)
    back = tape.all_to_all(ye, "model", 0, 0)
    y_m, = tape.run(lambda b, *p: (MA.a2a_combine(b, *p, T // n),), back,
                    *packing)
    y = tape.all_gather(y_m, "model", 0)
    aux, = tape.run(lambda a: (a / n * cfg.router_aux_loss,),
                    tape.exit(aux))
    shared = [tape.exit(s) for s in shared]
    return x, (y, *shared, *rest), aux


def layer_segments(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx, tc, wl,
                   x, adds, positions, q_chunk: int):
    """One dense or MoE layer, or a VLM self layer, on the tape of ``tc``
    (a ``distributed.tensor_parallel.Cell``), its leaves read by
    ``wl()``. Returns (x, adds, aux): the residual stream, the terms
    still to add to it (``_resid``), the MoE layer's aux loss or None."""
    x, adds = _attn_half(cfg, ctx, tc, wl, x, adds, positions, q_chunk)
    return _ffn_half(cfg, run, ctx, tc)(cfg, run, ctx, tc, wl, x, adds)


def _ffn_half(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx, tc):
    """A dense or MoE layer's second half on the tape of ``tc``."""
    if not cfg.is_moe:
        return _mlp_half
    if tc is tp.INLINE:
        return _moe_whole
    if run.moe_impl == "a2a" and "model" in ctx.mesh.axis_names:
        return _a2a_half
    return _moe_half


# --- the serve stack's layers: prefill and decode on a tape ---------------------------
# The dense, MoE and VLM serve programs (and whisper's, ``models.audio``,
# from these halves, and zamba2's shared block, ``models.mamba2``),
# written once for both callers: in a cell of the partitioned serve
# (``serve.step``) the layers run on a
# ``distributed.tensor_parallel.Forward`` tape with the cell's own heads,
# columns, experts and cache shard (``cut``, an ``attention.CacheCut``;
# the cross KV of the cell's kv heads where the cross attention is
# model-local, else all of them); outside it (``models.lm.prefill_fn``,
# ``decode_fn``) on ``tensor_parallel.INLINE`` with the whole cache
# (``cut`` None). A forward tape records nothing, so a decode step's
# cache write and attention run in the cell's own code, between the
# collectives they need.


def _cache_form(cfg: ModelConfig) -> Callable:
    """A prefill's k or v as the cache keeps it: a sliding window's in its
    ring layout, in bfloat16."""
    def form(k):
        if cfg.sliding_window > 0:
            k = A.ring_layout(k, cfg.sliding_window)
        return k.to(torch.bfloat16)

    return form


def _bf16(t):
    """A cross KV as the cache keeps it: in bfloat16."""
    return t.to(torch.bfloat16)


def layer_prefill(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx, tc, wl,
                  x, adds, positions, q_chunk: int, *, kv: Callable = _same,
                  cut: Optional[A.CacheCut] = None):
    """One dense or MoE layer's (or a VLM self layer's) prefill on the
    tape of ``tc``, its leaves read by ``wl()``: ``layer_segments``'
    halves, the attention's k and v passed through ``kv``
    (``_cache_form``) and, in a serve cell, laid out as its cache shard
    (``attention.cache_rest``). Returns (x, adds, k, v)."""
    x, adds, (k, v) = _attn_half(cfg, ctx, tc, wl, x, adds, positions,
                                 q_chunk, kv=kv)
    if cut is not None:
        k, v = A.cache_rest(tc.tape, k, cut), A.cache_rest(tc.tape, v, cut)
    x, adds, _ = _ffn_half(cfg, run, ctx, tc)(cfg, run, ctx, tc, wl, x, adds)
    return x, adds, k, v


def attn_decode_half(cfg: ModelConfig, ctx: ShardingCtx, tc, wl, x, adds, ck,
                     cv, pos: int, *, cut: Optional[A.CacheCut] = None,
                     use_flash: bool = False):
    """The self-attention half of a decode step on the tape of ``tc``
    against the layer's cache ``ck``, ``cv``: the norm, q, k and v of the
    cell's heads, the token written into the whole cache (``cut`` None;
    ``use_flash`` on a mesh: ``flash_decode``) or into a serve cell's
    shard of it (``attention.cell_decode``) and attended over, ``wo`` and
    the exit. In a decode_flash decode step (``Plan.decode_2d``) q, k and
    v come from the cell's block of the features (``_qkv_2d``), the cell
    attends on its rows and its sequence block with every head, and its
    columns of the whole output go into its rows of ``wo``. Returns (x,
    adds, ck, cv)."""
    tape, plan = tc.tape, tc.plan
    local = plan.qcols if plan.decode_2d else plan.attn
    x, h = _normed_on(tc, x, adds, lambda: wl()["ln1"], cfg.norm_eps)
    B = x.shape[0]

    def qkv(h):
        posv = torch.full((B, 1), pos, dtype=torch.int32, device=h.device)
        wa = wl()["attn"]
        return (A.project_q(cfg, wa, h, posv, ctx),
                *A.project_kv(cfg, wa, h, posv, ctx))

    if plan.decode_2d:
        q, k, v = _qkv_2d(cfg, tc, wl, h, pos)
    else:
        q, k, v = tape.run(qkv, tape.enter(h) if local else h)
    window, softcap = cfg.sliding_window, cfg.attn_logit_softcap
    if cut is not None:
        o, ck, cv = A.cell_decode(tape, q, k, v, ck, cv, pos, cut,
                                  window=window, softcap=softcap)
    else:
        ck, cv = A.cache_update(ck, cv, k, v, pos, window=window)
        if use_flash and ctx.mesh is not None:
            o = A.flash_decode(q, ck, cv, pos, ctx.mesh, softcap=softcap,
                               window=window)
        else:
            o = A.decode_attention(q, ck, cv, pos, window=window,
                                   softcap=softcap)

    def out(o):
        wo = wl()["attn"]["wo"]
        o = o.reshape(B, 1, -1)
        if plan.decode_2d and local:  # the cell's rows of wo
            o = o.narrow(-1, tc.index() * wo.shape[0], wo.shape[0])
        return (matmul(o, wo),)

    part, = tape.run(out, o)
    return x, (tape.exit(part) if local else part,), ck, cv


def _qkv_2d(cfg: ModelConfig, tc, wl, h, pos: int):
    """q of every head and k, v of every kv head of one token from the
    cell's block ``h`` of its features (``Plan.decode_2d``): the partial
    products with the cell's columns of ``wq`` and every column of ``wk``
    and ``wv`` summed over the feature axes in one exit, the biases added
    to the sums, q's columns gathered over ``model`` where ``wq``'s are
    cut there (``Plan.qcols``: they need not fall on heads)."""
    tape = tc.tape

    def wa():
        return wl()["attn"]

    y, = tape.run(lambda h: (_products(h, wa(), ("wq", "wk", "wv")),), h)
    y = tape.exit(y, tc.plan.features)

    def split(y):
        nq, nkv = wa()["wq"].shape[1], wa()["wk"].shape[1]
        q, k, v = y.split((nq, nkv, nkv), dim=-1)
        return (A.biased(q, wa(), "bq"), A.biased(k, wa(), "bk"),
                A.biased(v, wa(), "bv"))

    q, k, v = tape.run(split, y)
    if tc.plan.qcols:
        q = tape.all_gather(q, tp.AXIS, 2)

    def heads(q, k, v):
        posv = torch.full(q.shape[:2], pos, dtype=torch.int32,
                          device=q.device)
        return (A.heads_of(cfg, q, posv, True), A.heads_of(cfg, k, posv, True),
                A.heads_of(cfg, v, posv, False))

    return tape.run(heads, q, k, v)


def layer_decode(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx, tc, wl,
                 x, adds, ck, cv, pos: int, *,
                 cut: Optional[A.CacheCut] = None, use_flash: bool = False):
    """One dense or MoE layer's (or a VLM self layer's) decode step on
    the tape of ``tc``: the self-attention half (``attn_decode_half``)
    and the MLP or MoE half. Returns (x, adds, ck, cv)."""
    x, adds, ck, cv = attn_decode_half(cfg, ctx, tc, wl, x, adds, ck, cv, pos,
                                       cut=cut, use_flash=use_flash)
    x, adds, _ = _ffn_half(cfg, run, ctx, tc)(cfg, run, ctx, tc, wl, x, adds)
    return x, adds, ck, cv


def prefill_segments(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx, tc,
                     layer: Callable, x, positions, q_chunk: int, n: int, *,
                     cut: Optional[A.CacheCut] = None, adds=()):
    """``n`` layers' prefill on the tape of ``tc`` from the residual ``x``
    and the terms ``adds`` still to add to it, layer ``i``'s leaves
    ``layer(i)`` (taken once a layer: a serve cell gathers them there).
    Returns (x, adds, cache): the cache's k and v stacked (L, ...), in a
    serve cell its shard."""
    ks, vs = [], []
    form = _cache_form(cfg)
    for i in range(n):
        wi = layer(i)
        x, adds, k, v = layer_prefill(cfg, run, ctx, tc, lambda: wi, x, adds,
                                      positions, q_chunk, kv=form, cut=cut)
        ks.append(k)
        vs.append(v)
    return x, adds, {"k": torch.stack(ks), "v": torch.stack(vs)}


def decode_segments(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx, tc,
                    layer: Callable, cache, x, pos: int, n: int, *,
                    cut: Optional[A.CacheCut] = None,
                    use_flash: bool = False, adds=()):
    """``n`` layers' decode step on the tape of ``tc`` (``layer`` and
    ``adds`` as in ``prefill_segments``). Returns (x, adds, the new
    cache)."""
    ks, vs = [], []
    for i in range(n):
        wi = layer(i)
        x, adds, ck, cv = layer_decode(cfg, run, ctx, tc, lambda: wi, x, adds,
                                       cache["k"][i], cache["v"][i], pos,
                                       cut=cut, use_flash=use_flash)
        ks.append(ck)
        vs.append(cv)
    return x, adds, {"k": torch.stack(ks), "v": torch.stack(vs)}


def cross_segments(cfg: ModelConfig, ctx: ShardingCtx, tc, wc, x, adds, img,
                   **kv):
    """The VLM's gated cross-attention layer on the tape of ``tc``, its
    leaves read by ``wc()``: the cross half (``_xattn_half``) over the
    image embeddings ``img`` (batch input, no gradient), or in a decode
    step over the cached image KV ``(img_k, img_v)``; then
    ``tanh(gate_attn)`` in a segment of its own after the exit (in the
    local segment each cell's gradient of the gate would be a partial sum
    that nothing adds up), the MLP half as a self layer's, and
    ``tanh(gate_mlp)`` after its exit. Returns (x, adds), with ``kv``
    (``_xattn_half``'s keyword) (x, adds, (k, v))."""
    tape = tc.tape
    x, (part,), *cache = _xattn_half(cfg, ctx, tc, wc, x, adds, img, "ln1",
                                     **kv)
    o, = tape.run(lambda o: (_gated(wc()["gate_attn"], o),), part)
    x, (m,), _ = _mlp_half(cfg, None, ctx, tc, wc, x, (o,))
    m, = tape.run(lambda m: (_gated(wc()["gate_mlp"], m),), m)
    return (x, (m,), *cache)


def vlm_prefill_segments(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx,
                         tc, stack: Callable, x, positions, img,
                         q_chunk: int, *, cut: Optional[A.CacheCut] = None):
    """The VLM's prefill on the tape of ``tc``: each super-block's self
    layers (``prefill_segments``; ``stack("self", j, i)`` the leaves of
    group ``j``'s self layer ``i``), then its cross layer
    (``cross_segments``, ``stack("cross", j)``) over the image embeddings
    ``img``, which also gives the layer's image KV of the cell's kv heads
    in bfloat16. Returns (x, adds, cache): the self caches stacked (g, s,
    ...), the image KV (g, ...); in a serve cell their shards."""
    g, s = _vlm_groups(cfg)
    adds, self_c, cross_c = (), [], []
    for j in range(g):
        x, adds, kv = prefill_segments(
            cfg, run, ctx, tc, lambda i: stack("self", j, i), x, positions,
            q_chunk, s, cut=cut, adds=adds)
        self_c.append(kv)
        wc = stack("cross", j)
        x, adds, (k, v) = cross_segments(cfg, ctx, tc, lambda: wc, x, adds,
                                         img, kv=_bf16)
        cross_c.append({"img_k": k, "img_v": v})
    return x, adds, {"self": P.stack_layers(self_c),
                     "cross": P.stack_layers(cross_c)}


def vlm_decode_segments(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx,
                        tc, stack: Callable, cache, x, pos: int, *,
                        cut: Optional[A.CacheCut] = None,
                        use_flash: bool = False):
    """The VLM's decode step on the tape of ``tc`` (``stack`` as in
    ``vlm_prefill_segments``): each super-block's self layers
    (``decode_segments``), then its cross layer over the cached image KV,
    which stays as it is. Returns (x, adds, the new cache)."""
    g, s = _vlm_groups(cfg)
    adds, new_self = (), []
    for j in range(g):
        x, adds, kv = decode_segments(
            cfg, run, ctx, tc, lambda i: stack("self", j, i),
            P.layer(cache["self"], j), x, pos, s, cut=cut,
            use_flash=use_flash, adds=adds)
        new_self.append(kv)
        wc, cx = stack("cross", j), P.layer(cache["cross"], j)
        x, adds = cross_segments(cfg, ctx, tc, lambda: wc, x, adds,
                                 (cx["img_k"], cx["img_v"]))
    return x, adds, {"self": P.stack_layers(new_self),
                     "cross": cache["cross"]}


def stack_segments(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx, tc, w,
                   x, positions, *, img: Optional[torch.Tensor] = None,
                   q_chunk: int = 1024):
    """The dense, MoE or VLM stack on the tape of ``tc``, from the leaf
    ``x`` (the VLM's super-blocks: ``cross_attn_every - 1`` self layers,
    then a cross layer on the image embeddings ``img``). Returns (x,
    adds, auxes): the last residual, the terms still to add to it
    (``_resid``), each MoE layer's aux loss. On ``INLINE`` the stack is
    ``stack_apply``'s, grouped and nested remat included."""
    if tc is tp.INLINE:
        x, aux = stack_apply(cfg, run, ctx, w, x, positions, img=img,
                             q_chunk=q_chunk)
        return x, (), [aux]
    adds, auxes = (), []
    if cfg.family == "vlm":
        g, s = _vlm_groups(cfg)
        for j in range(g):
            for i in range(s):
                def wl(i=i, j=j):
                    return P.layer(P.layer(w["self"], j), i)

                x, adds, _ = layer_segments(cfg, run, ctx, tc, wl, x, adds,
                                            positions, q_chunk)
            x, adds = cross_segments(cfg, ctx, tc,
                                     lambda j=j: P.layer(w["cross"], j), x,
                                     adds, img)
        return x, adds, auxes
    for i in range(cfg.num_layers):
        def wl(i=i):
            return P.layer(w["layers"], i)

        x, adds, aux = layer_segments(cfg, run, ctx, tc, wl, x, adds,
                                      positions, q_chunk)
        if aux is not None:
            auxes.append(aux)
    return x, adds, auxes
