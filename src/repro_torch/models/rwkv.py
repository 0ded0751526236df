"""RWKV6 (Finch): attention-free LM with data-dependent decay linear attention.

WKV6 recurrence per head (state S in R^{dk x dv}):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)

Prefill uses the exact chunked scan of ``kernels.wkv6``: the CUDA kernel
for tensors on the card, its plain version for tensors on the CPU. Decode
runs the single-token recurrence ``wkv6_step`` in plain PyTorch, as the
reference does. The layers keep the reference's stacked ``(L, ...)``
parameter layout; its ``lax.scan`` over layers is a loop over the layer
index here.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.models import params as P
from repro_torch.models.common import rms_norm, rms_norm_specs

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


def time_mix_apply(cfg: ModelConfig, ctx: ShardingCtx, w, x, xx, state, *, chunk):
    """x: (B,S,d); xx: token-shifted x; state: (B,H,K,V) or None (from 0)."""
    B, S, d = x.shape
    H, K = _num_heads(cfg), cfg.wkv_head_dim
    h = rms_norm(x, w["ln"], cfg.norm_eps)
    hh = rms_norm(xx, w["ln"], cfg.norm_eps)
    xr, xk, xv, xw, xg = _ddlerp(w, h, hh)
    dt = x.dtype
    r = _split_heads(xr @ w["wr"].to(dt), H, K)
    k = _split_heads(xk @ w["wk"].to(dt), H, K)
    v = _split_heads(xv @ w["wv"].to(dt), H, K)
    g = F.silu(xg @ w["wg"].to(dt))
    ww = _split_heads(_decay(w, xw), H, K)
    r = ctx.constrain(r, ("batch", "seq_inner", "heads", "head_dim"))
    k = ctx.constrain(k, ("batch", "seq_inner", "heads", "head_dim"))
    if state is None:
        state = torch.zeros((B, H, K, K), dtype=torch.float32, device=x.device)
    y, state = wkv6_chunked(r, k, v, ww, w["u"], state, chunk=chunk)
    y = y.reshape(B, S, d).to(dt)
    y = rms_norm(y, w["ln_x"], cfg.norm_eps)  # stand-in for per-head groupnorm
    out = (y * g) @ w["wo"].to(dt)
    return ctx.constrain(out, ("batch", "seq", "embed")), state


def channel_mix_apply(cfg: ModelConfig, ctx: ShardingCtx, w, x, xx):
    dt = x.dtype
    h = rms_norm(x, w["ln"], cfg.norm_eps)
    hh = rms_norm(xx, w["ln"], cfg.norm_eps)
    dx = hh - h
    xk = h + dx * w["mu_k"].to(dt)
    xr = h + dx * w["mu_r"].to(dt)
    k = torch.square(F.relu(xk @ w["wk"].to(dt)))
    k = ctx.constrain(k, ("batch", "seq_inner", "mlp"))
    v = k @ w["wv"].to(dt)
    rgate = torch.sigmoid(xr @ w["wr"].to(dt))
    return ctx.constrain(rgate * v, ("batch", "seq", "embed"))


def _shift(x):
    """xx_t = x_{t-1} (zeros at t=0)."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def layer_apply(cfg, run, ctx, w, x, *, chunk):
    xx = _shift(x)
    y, _ = time_mix_apply(cfg, ctx, w["tmix"], x, xx, None, chunk=chunk)
    x = x + y
    xx2 = _shift(x)
    x = x + channel_mix_apply(cfg, ctx, w["cmix"], x, xx2)
    return x


def layer_prefill(cfg, run, ctx, w, x, *, chunk):
    """Like layer_apply but returns decode state (wkv state + last-token xs)."""
    xx = _shift(x)
    y, wkv_state = time_mix_apply(cfg, ctx, w["tmix"], x, xx, None, chunk=chunk)
    last_tmix = x[:, -1]
    x = x + y
    xx2 = _shift(x)
    last_cmix = x[:, -1]
    x = x + channel_mix_apply(cfg, ctx, w["cmix"], x, xx2)
    state = {"wkv": wkv_state, "last_tmix": last_tmix, "last_cmix": last_cmix}
    return x, state


def layer_decode(cfg, run, ctx, w, x, state):
    """x: (B,1,d); state: {wkv (B,H,K,V), last_tmix (B,d), last_cmix (B,d)}."""
    B, _, d = x.shape
    H, K = _num_heads(cfg), cfg.wkv_head_dim
    xt = x[:, 0]
    xx = state["last_tmix"][:, None, :].to(x.dtype)
    wt = w["tmix"]
    h = rms_norm(x, wt["ln"], cfg.norm_eps)
    hh = rms_norm(xx, wt["ln"], cfg.norm_eps)
    xr, xk, xv, xw, xg = _ddlerp(wt, h, hh)
    dt = x.dtype
    r = _split_heads(xr @ wt["wr"].to(dt), H, K)[:, 0]
    k = _split_heads(xk @ wt["wk"].to(dt), H, K)[:, 0]
    v = _split_heads(xv @ wt["wv"].to(dt), H, K)[:, 0]
    g = F.silu(xg @ wt["wg"].to(dt))
    ww = _split_heads(_decay(wt, xw), H, K)[:, 0]
    y, wkv = wkv6_step(r, k, v, ww, wt["u"], state["wkv"])
    y = y.reshape(B, 1, d).to(dt)
    y = rms_norm(y, wt["ln_x"], cfg.norm_eps)
    x = x + (y * g) @ wt["wo"].to(dt)
    # channel mix
    xx2 = state["last_cmix"][:, None, :].to(x.dtype)
    new_last_cmix = x[:, 0]
    x = x + channel_mix_apply(cfg, ctx, w["cmix"], x, xx2)
    return x, {"wkv": wkv, "last_tmix": xt, "last_cmix": new_last_cmix}


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
    for i in range(cfg.num_layers):
        x = layer_apply(cfg, run, ctx, P.layer(w["layers"], i), x, chunk=chunk)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def stack_prefill(cfg, run, ctx, w, x, *, chunk):
    states = []
    for i in range(cfg.num_layers):
        x, st = layer_prefill(cfg, run, ctx, P.layer(w["layers"], i), x,
                              chunk=chunk)
        states.append(st)
    return x, P.stack_layers(states)


def stack_decode(cfg, run, ctx, w, state, x):
    states = []
    for i in range(cfg.num_layers):
        x, st = layer_decode(cfg, run, ctx, P.layer(w["layers"], i), x,
                             P.layer(state, i))
        states.append(st)
    return x, P.stack_layers(states)
