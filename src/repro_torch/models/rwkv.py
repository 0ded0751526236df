"""RWKV6 (Finch): attention-free LM with data-dependent decay linear attention.

WKV6 recurrence per head (state S in R^{dk x dv}):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)

Prefill uses the exact chunked scan of ``kernels.wkv6``: the CUDA kernel
for tensors on the card, its plain version for tensors on the CPU. Decode
runs the single-token recurrence ``wkv6_step`` in plain PyTorch, as the
reference does. The layers keep the reference's stacked ``(L, ...)``
parameter layout; the teacher-forced stack runs through
``scan_utils.grouped_scan`` (the run's remat and scan group), prefill and
decode loop over the layer index, as the reference scans them without
remat.

A layer's training forward is written as segments (``layer_segments``):
in a cell of the partitioned training step they run on the cell's tape,
tensor-parallel over ``model`` (the time mix on the cell's WKV heads,
the channel mix on its columns; ``distributed.tensor_parallel``'s rules
(a) and (c)); outside it (``layer_apply``) on
``tensor_parallel.INLINE``, plain calls. The serve programs are the same
halves (``layer_serve``: ``prefill_segments``, ``decode_segments``), each
also giving its part of the layer's state: on ``INLINE`` for
``models.lm``'s ``prefill_fn`` and ``decode_fn``, in a cell of the
partitioned serve (``serve.step``) on its heads and columns, from and
into its shard of the state (the WKV state of its heads; the token
shifts whole).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.models import params as P
from repro_torch.models import transformer as T
from repro_torch.models.common import rms_norm, rms_norm_specs
from repro_torch.models.scan_utils import grouped_scan

LORA_MIX = 32
LORA_DECAY = 64


def _num_heads(cfg: ModelConfig) -> int:
    return cfg.d_model // cfg.wkv_head_dim


# --- WKV6 core ---------------------------------------------------------------------


def wkv6_chunked(r, k, v, w, u, state, *, chunk: int):
    """r,k,w: (B,S,H,K); v: (B,S,H,V); u: (H,K); state: (B,H,K,V).

    Returns (y (B,S,H,V) f32, state_out f32). Exact chunked form, through
    ``kernels.wkv6.ops``, which picks the path by the tensors' device.
    """
    S = r.shape[1]
    if S % chunk:
        # zero-pad to a chunk multiple: k=0 contributes nothing to y or the
        # kv sum; the returned state is only exact when S % chunk == 0
        # (prefill callers guarantee that).
        pad = chunk - S % chunk
        padf = lambda z: F.pad(z, (0, 0, 0, 0, 0, pad))
        y, st = wkv6_chunked(padf(r), padf(k), padf(v), padf(w), u, state,
                             chunk=chunk)
        return y[:, :S], st
    return wkv_ops.wkv6(r, k, v, w, u, state, chunk=chunk)


def wkv6_step(r, k, v, w, u, state):
    """Single-token recurrence. r,k,w: (B,H,K); v: (B,H,V); state: (B,H,K,V)."""
    r, k, v, w = (x.float() for x in (r, k, v, w))
    decay = torch.exp(-torch.exp(w))
    kv = k[..., :, None] * v[..., None, :]  # (B,H,K,V)
    y = torch.einsum("bhk,bhkv->bhv", r,
                     state + u.float()[None, :, :, None] * kv)
    state = decay[..., None] * state + kv
    return y, state


# --- blocks -------------------------------------------------------------------------


def time_mix_specs(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    H = _num_heads(cfg)
    K = cfg.wkv_head_dim
    return {
        "ln": rms_norm_specs(d),
        "mu_base": P.dense((d,), (None,), init="zeros"),
        "mu_rkvwg": P.dense((5, d), (None, None), init="zeros"),
        "lora_A": P.dense((d, 5 * LORA_MIX), ("fsdp", None), scale=0.1),
        "lora_B": P.dense((5, LORA_MIX, d), (None, None, "fsdp"), scale=0.1),
        "wr": P.dense((d, d), ("fsdp", "heads")),
        "wk": P.dense((d, d), ("fsdp", "heads")),
        "wv": P.dense((d, d), ("fsdp", "heads")),
        "wg": P.dense((d, d), ("fsdp", "heads")),
        "w0": P.dense((d,), (None,), init="zeros"),
        "wlora_A": P.dense((d, LORA_DECAY), ("fsdp", None), scale=0.1),
        "wlora_B": P.dense((LORA_DECAY, d), (None, "fsdp"), scale=0.1),
        "u": P.dense((H, K), (None, None), init="zeros"),
        "ln_x": rms_norm_specs(d),
        "wo": P.dense((d, d), ("heads", "fsdp")),
    }


def channel_mix_specs(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    return {
        "ln": rms_norm_specs(d),
        "mu_k": P.dense((d,), (None,), init="zeros"),
        "mu_r": P.dense((d,), (None,), init="zeros"),
        "wk": P.dense((d, cfg.d_ff), ("fsdp", "mlp")),
        "wv": P.dense((cfg.d_ff, d), ("mlp", "fsdp")),
        "wr": P.dense((d, d), ("fsdp", None)),
    }


def layer_specs(cfg: ModelConfig) -> Dict:
    return {"tmix": time_mix_specs(cfg), "cmix": channel_mix_specs(cfg)}


def _ddlerp(w, x, xx):
    """Data-dependent token-shift interpolation -> 5 mixed streams (r,k,v,w,g)."""
    dt = x.dtype
    dx = xx - x
    base = x + dx * w["mu_base"].to(dt)
    lora = torch.tanh(base @ w["lora_A"].to(dt))
    lora = lora.reshape(lora.shape[:-1] + (5, LORA_MIX))
    delta = torch.einsum("...lk,lkd->...ld", lora, w["lora_B"].to(dt))
    mixed = x[..., None, :] + dx[..., None, :] * (w["mu_rkvwg"].to(dt) + delta)
    return [mixed[..., i, :] for i in range(5)]


def _decay(w, xw):
    dt = xw.dtype
    lora = torch.tanh(xw @ w["wlora_A"].to(dt)) @ w["wlora_B"].to(dt)
    return w["w0"].to(dt) + lora  # ww; decay = exp(-exp(ww))


def _split_heads(x, H, K):
    return x.reshape(x.shape[:-1] + (H, K))


def _tmix_streams(w, x, xx, eps: float):
    """The time mix's replicated work: the norms of x and of its shift
    ``xx``, the token-shift interpolation with its LoRA and the decay.
    Returns (xr, xk, xv, xg, ww), each (B, S, d)."""
    h = rms_norm(x, w["ln"], eps)
    hh = rms_norm(xx, w["ln"], eps)
    xr, xk, xv, xw, xg = _ddlerp(w, h, hh)
    return xr, xk, xv, xg, _decay(w, xw)


def _tmix_heads(cfg: ModelConfig, ctx: ShardingCtx, w, xr, xk, xv, xg, ww,
                u, *, chunk, wkv=None):
    """WKV6 on the heads of ``w``'s columns (all of them, or a
    tensor-parallel cell's own, whose ``ww`` and ``u`` the caller cuts
    alike): the chunked scan from the zero state, or, given their state
    ``wkv`` (B, H, K, K), one token's recurrence ``wkv6_step`` (a decode
    step). Returns (y, g, state): y (B, S, H K) in the activations'
    dtype, the gate g on the same channels."""
    B, S, _ = xr.shape
    K = cfg.wkv_head_dim
    H = w["wr"].shape[1] // K
    dt = xr.dtype
    r = _split_heads(xr @ w["wr"].to(dt), H, K)
    k = _split_heads(xk @ w["wk"].to(dt), H, K)
    v = _split_heads(xv @ w["wv"].to(dt), H, K)
    g = F.silu(xg @ w["wg"].to(dt))
    ww = _split_heads(ww, H, K)
    if wkv is not None:
        y, state = wkv6_step(r[:, 0], k[:, 0], v[:, 0], ww[:, 0], u, wkv)
        return y.reshape(B, 1, H * K).to(dt), g, state
    r = ctx.constrain(r, ("batch", "seq_inner", "heads", "head_dim"))
    k = ctx.constrain(k, ("batch", "seq_inner", "heads", "head_dim"))
    state = torch.zeros((B, H, K, K), dtype=torch.float32, device=xr.device)
    y, state = wkv6_chunked(r, k, v, ww, u, state, chunk=chunk)
    return y.reshape(B, S, H * K).to(dt), g, state


def _cmix_streams(w, x, xx, eps: float):
    """The channel mix's token-shift mixes: (xk, xr)."""
    dt = x.dtype
    h = rms_norm(x, w["ln"], eps)
    hh = rms_norm(xx, w["ln"], eps)
    dx = hh - h
    return h + dx * w["mu_k"].to(dt), h + dx * w["mu_r"].to(dt)


def _cmix_value(ctx: ShardingCtx, w, xk):
    """relu(xk wk)^2 wv over ``w``'s columns of ``wk`` and rows of ``wv``
    (all, or a cell's: then a partial sum)."""
    dt = xk.dtype
    k = torch.square(F.relu(xk @ w["wk"].to(dt)))
    k = ctx.constrain(k, ("batch", "seq_inner", "mlp"))
    return k @ w["wv"].to(dt)


def _rgate(w, xr):
    """The receptance gate, over the whole ``wr`` (not cut over ``model``)."""
    return torch.sigmoid(xr @ w["wr"].to(xr.dtype))


def _shift(x):
    """xx_t = x_{t-1} (zeros at t=0)."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _tmix_half(cfg: ModelConfig, ctx: ShardingCtx, tc, wl, x, adds, chunk,
               *, state=None, serve: bool = False):
    """The time mix on the tape of ``tc``, its leaves read by
    ``wl()["tmix"]``. The replicated segment: the residual sum, the
    token shift, the norms, the mixes with their LoRA and the decay (rule
    (a)), and the bonus ``u`` and ``ln_x``'s scale passed out as they
    are. Where the time mix is model-local, the five streams enter, and
    so do ``u`` and the scale, which the cell reads on its heads; the
    cell's segment runs WKV6 on its H/m heads and takes each row's sum of
    squares of its channels of y, which exits and enters at once (rule
    (c)): ``ln_x`` normalises over all of ``d``. Then the norm, the gate
    and the cell's rows of ``wo``, through the exit. Returns (x, adds).

    A serve's prefill (``serve``) or decode step (``state``: the layer's
    state, the cell's shard of it, whose ``last_tmix`` is the token
    shift and whose ``wkv`` holds the cell's heads) also returns the
    WKV state of the cell's heads and ``last_tmix``, the last token of
    the summed residual: (x, adds, wkv, last_tmix)."""
    tape = tc.tape
    local = tc.plan.attn
    K, d, eps = cfg.wkv_head_dim, cfg.d_model, cfg.norm_eps
    serve = serve or state is not None

    def w():
        return wl()["tmix"]

    def pre(x, *a):
        x = T._resid(x, a)
        xx = (_shift(x) if state is None
              else state["last_tmix"][:, None, :].to(x.dtype))
        last = (x[:, -1],) if serve else ()
        return (x, *last, *_tmix_streams(w(), x, xx, eps), w()["u"],
                w()["ln_x"])

    x, *streams, u, scale = tape.run(pre, x, *adds)
    last = (streams.pop(0),) if serve else ()
    lo, hi = tc.block(_num_heads(cfg)) if local else (0, _num_heads(cfg))
    cols = slice(lo * K, hi * K)
    step = {} if state is None else {"wkv": state["wkv"]}  # a decode's

    def heads(xr, xk, xv, xg, ww, u):
        y, g, st = _tmix_heads(cfg, ctx, w(), xr, xk, xv, xg, ww[..., cols],
                               u[lo:hi], chunk=chunk, **step)
        kept = (st,) if serve else ()
        if not local:
            return (y, g, *kept)
        return (y, g, *kept,
                torch.sum(torch.square(y.float()), -1, keepdim=True))

    if not local:
        y, g, *kept = tape.run(heads, *streams, u)
        part, = tape.run(lambda y, g, s: ((rms_norm(y, s, eps) * g)
                                          @ w()["wo"].to(y.dtype),),
                         y, g, scale)
        return (x, (part,), *kept, *last)
    y, g, *kept, squares = tape.run(heads, *(tape.enter(t) for t in streams),
                                    tape.enter(u))
    squares = tape.total(squares)

    def out(y, g, squares, s):
        # rms_norm over all of d, from the group's sum of squares
        ynorm = (y.float() * torch.rsqrt(squares / d + eps)
                 * s[cols].float()).to(y.dtype)
        return ((ynorm * g) @ w()["wo"].to(y.dtype),)

    part, = tape.run(out, y, g, squares, tape.enter(scale))
    return (x, (tape.exit(part),), *kept, *last)


def _cmix_half(cfg: ModelConfig, ctx: ShardingCtx, tc, wl, x, adds, *,
               last=None, serve: bool = False):
    """The channel mix on the tape of ``tc``, its leaves read by
    ``wl()["cmix"]``: the replicated segment (the residual sum, the
    shift, the norms, the mixes and the receptance gate, whose ``wr`` is
    not cut over ``model``), xk entering the cell's columns of ``wk`` and
    rows of ``wv`` where those are model-local, the exit, and the gate
    multiplying the exited sum in a segment of its own (rule (a)).
    Returns (x, adds). A serve's prefill (``serve``) or decode step
    (``last``: the layer's ``last_cmix``, the token shift) also returns
    ``last_cmix``, the last token of the residual with the time mix's
    exit summed into it: (x, adds, last_cmix)."""
    tape = tc.tape
    local = tc.plan.mlp
    serve = serve or last is not None

    def w():
        return wl()["cmix"]

    def pre(x, *a):
        x = T._resid(x, a)
        xx = _shift(x) if last is None else last[:, None, :].to(x.dtype)
        xk, xr = _cmix_streams(w(), x, xx, cfg.norm_eps)
        return (x, xk, _rgate(w(), xr), *((x[:, -1],) if serve else ()))

    x, xk, rgate, *kept = tape.run(pre, x, *adds)
    part, = tape.run(lambda xk: (_cmix_value(ctx, w(), xk),),
                     tape.enter(xk) if local else xk)
    y, = tape.run(lambda r, v: (ctx.constrain(r * v, ("batch", "seq",
                                                      "embed")),),
                  rgate, tape.exit(part) if local else part)
    return (x, (y,), *kept)


def layer_segments(cfg: ModelConfig, run, ctx: ShardingCtx, tc, wl, x, adds,
                   *, chunk):
    """One layer on the tape of ``tc`` (a
    ``distributed.tensor_parallel.Cell``), its leaves read by ``wl()``.
    Returns (x, adds): the residual stream and the terms still to add to
    it (``transformer._resid``)."""
    x, adds = _tmix_half(cfg, ctx, tc, wl, x, adds, chunk)
    return _cmix_half(cfg, ctx, tc, wl, x, adds)


def layer_apply(cfg, run, ctx, w, x, *, chunk):
    """``layer_segments`` on ``tensor_parallel.INLINE``."""
    x, adds = layer_segments(cfg, run, ctx, tp.INLINE, lambda: w, x, (),
                             chunk=chunk)
    return T._resid(x, adds)


def layer_serve(cfg: ModelConfig, run, ctx: ShardingCtx, tc, wl, x, adds, *,
                chunk, state=None):
    """One layer's prefill (``state`` None: the scan from the zero state)
    or decode step (from ``state``, the layer's state or a serve cell's
    shard of it) on the tape of ``tc``, its leaves read by ``wl()``: the
    time mix and the channel mix of ``layer_segments``, each also giving
    its part of the layer's new state. Returns (x, adds, state): the WKV
    state of the cell's heads (all of them on ``INLINE``), ``last_tmix``
    and ``last_cmix`` whole."""
    x, adds, wkv, last_tmix = _tmix_half(cfg, ctx, tc, wl, x, adds, chunk,
                                         state=state, serve=True)
    x, adds, last_cmix = _cmix_half(
        cfg, ctx, tc, wl, x, adds,
        last=None if state is None else state["last_cmix"], serve=True)
    return x, adds, {"wkv": wkv, "last_tmix": last_tmix,
                     "last_cmix": last_cmix}


def layer_prefill(cfg, run, ctx, w, x, *, chunk):
    """Like layer_apply but returns decode state (wkv state + last-token
    xs): ``layer_serve`` on ``tensor_parallel.INLINE``."""
    x, adds, state = layer_serve(cfg, run, ctx, tp.INLINE, lambda: w, x, (),
                                 chunk=chunk)
    return T._resid(x, adds), state


def layer_decode(cfg, run, ctx, w, x, state):
    """x: (B,1,d); state: {wkv (B,H,K,V), last_tmix (B,d), last_cmix (B,d)}:
    ``layer_serve`` on ``tensor_parallel.INLINE``."""
    x, adds, state = layer_serve(cfg, run, ctx, tp.INLINE, lambda: w, x, (),
                                 chunk=0, state=state)
    return T._resid(x, adds), state


# --- stacked -------------------------------------------------------------------------


def stack_specs(cfg: ModelConfig) -> Dict:
    return {"layers": P.stack_tree(cfg.num_layers, layer_specs(cfg))}


def state_specs(cfg: ModelConfig, batch: int) -> Dict:
    H, K = _num_heads(cfg), cfg.wkv_head_dim
    per_layer = {
        "wkv": P.dense((batch, H, K, K), ("batch", "heads", None, None),
                       init="zeros", dtype="float32"),
        "last_tmix": P.dense((batch, cfg.d_model), ("batch", "embed"),
                             init="zeros", dtype="bfloat16"),
        "last_cmix": P.dense((batch, cfg.d_model), ("batch", "embed"),
                             init="zeros", dtype="bfloat16"),
    }
    return P.stack_tree(cfg.num_layers, per_layer)


def stack_apply(cfg, run, ctx, w, x, *, chunk):
    """Full-sequence forward through ``scan_utils.grouped_scan``: groups
    of ``run.scan_group`` layers, each layer and each group rematerialised
    under ``run.remat == "block"``. Returns (x, aux_loss 0)."""
    def body(x, wl):
        return layer_apply(cfg, run, ctx, wl, x, chunk=chunk), None

    x, _ = grouped_scan(body, x, w["layers"], cfg.num_layers, run.scan_group,
                        run.remat == "block")
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def stack_segments(cfg, run, ctx, tc, w, x, *, chunk):
    """The stack on the tape of ``tc`` from the leaf ``x``, layer by
    layer. Returns (x, adds). On ``INLINE``: ``stack_apply``, its scan
    group and remat included."""
    if tc is tp.INLINE:
        return stack_apply(cfg, run, ctx, w, x, chunk=chunk)[0], ()
    adds = ()
    for i in range(cfg.num_layers):
        x, adds = layer_segments(cfg, run, ctx, tc,
                                 lambda i=i: P.layer(w["layers"], i), x,
                                 adds, chunk=chunk)
    return x, adds


def prefill_segments(cfg, run, ctx, tc, stack, x, *, chunk):
    """The prefill on the tape of ``tc`` (a cell of the partitioned
    serve, ``serve.step``, or ``INLINE``), layer ``i``'s leaves
    ``stack("layers", i)`` (taken once a layer: a serve cell gathers them
    there). Returns (x, adds, state): the layers' states stacked (L, ...),
    in a serve cell its shard (the WKV state of its heads)."""
    adds, states = (), []
    for i in range(cfg.num_layers):
        wi = stack("layers", i)
        x, adds, st = layer_serve(cfg, run, ctx, tc, lambda: wi, x, adds,
                                  chunk=chunk)
        states.append(st)
    return x, adds, P.stack_layers(states)


def decode_segments(cfg, run, ctx, tc, stack, state, x):
    """One decode step on the tape of ``tc`` from ``state`` (the whole
    state, or a serve cell's shard of it; ``stack`` as in
    ``prefill_segments``). Returns (x, adds, the new state)."""
    adds, states = (), []
    for i in range(cfg.num_layers):
        wi = stack("layers", i)
        x, adds, st = layer_serve(cfg, run, ctx, tc, lambda: wi, x, adds,
                                  chunk=0, state=P.layer(state, i))
        states.append(st)
    return x, adds, P.stack_layers(states)

