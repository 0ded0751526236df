"""Mamba2 (SSD) blocks and the Zamba2 hybrid stack.

SSD recurrence per head (state h in R^{P x N}, scalar decay per head/step):
    a_t = exp(A * dt_t)            A = -exp(A_log) < 0
    h_t = a_t h_{t-1} + dt_t * x_t B_t^T
    y_t = h_t C_t + D * x_t

Prefill uses the exact chunked scan of ``kernels.ssd``: the CUDA kernel
for tensors on the card, its plain version for tensors on the CPU. Decode
runs the single-token recurrence ``ssd_step`` in plain PyTorch, as the
reference does. Zamba2 = Mamba2 backbone + one weight-tied transformer
block applied after every ``shared_attn_every``-th layer. The layers keep
the reference's stacked ``(L, ...)`` parameter layout. The
teacher-forced stack runs through ``scan_utils.grouped_scan`` (the run's
remat and scan group); prefill and decode loop over the layer index, as
the reference scans them without remat. The reference's ``lax.cond``
around the shared block is a Python ``if`` on that index.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models import attention as A
from repro_torch.models import params as P
from repro_torch.models import transformer as T
from repro_torch.models.common import rms_norm, rms_norm_specs
from repro_torch.models.scan_utils import grouped_scan


def dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // cfg.ssm_head_dim
    return d_inner, H, cfg.ssm_head_dim, cfg.ssm_state


# --- SSD core -----------------------------------------------------------------------


def ssd_chunked(x, dt, B, C, A_log, D, state, *, chunk: int):
    """x: (b,S,H,P); dt: (b,S,H); B,C: (b,S,N); state: (b,H,P,N).

    Returns (y (b,S,H,P) f32, state_out f32), through ``kernels.ssd.ops``,
    which picks the path by the tensors' device. S is zero-padded to a
    multiple of the chunk first, so the kernel sees whole chunks only; a
    padded step has dt = 0, so it leaves the state as it was and the
    returned state is exact.
    """
    S = x.shape[1]
    if S % chunk:
        pad = chunk - S % chunk
        p3 = lambda z: F.pad(z, (0, 0) * (z.dim() - 2) + (0, pad))
        y, st = ssd_chunked(p3(x), p3(dt), p3(B), p3(C), A_log, D, state,
                            chunk=chunk)
        return y[:, :S], st
    return ssd_ops.ssd(x.contiguous(), dt.contiguous(), B.contiguous(),
                       C.contiguous(), A_log, D, state, chunk=chunk)


def ssd_step(x, dt, B, C, A_log, D, state):
    """One token. x: (b,H,P); dt: (b,H); B,C: (b,N); state: (b,H,P,N)."""
    x, dt, B, C = (z.float() for z in (x, dt, B, C))
    a = torch.exp(dt * (-torch.exp(A_log.float()))[None, :])  # (b,H)
    upd = (dt[..., None] * x)[..., None] * B[:, None, None, :]  # (b,H,P,N)
    state = a[..., None, None] * state + upd
    y = torch.einsum("bhpn,bn->bhp", state, C) + x * D.float()[None, :, None]
    return y, state


# --- Mamba2 block ---------------------------------------------------------------------


def mamba_specs(cfg: ModelConfig) -> Dict:
    d_inner, H, Pd, N = dims(cfg)
    K = cfg.ssm_conv_width
    conv_ch = d_inner + 2 * N
    return {
        "ln": rms_norm_specs(cfg.d_model),
        "w_in": P.dense((cfg.d_model, 2 * d_inner + 2 * N + H), ("fsdp", "mlp")),
        "conv_w": P.dense((K, conv_ch), ("conv_k", None), scale=0.5),
        "conv_b": P.dense((conv_ch,), (None,), init="zeros"),
        "A_log": P.dense((H,), (None,), init="zeros"),
        "D": P.dense((H,), (None,), init="ones"),
        "dt_bias": P.dense((H,), (None,), init="zeros"),
        "norm_gate": rms_norm_specs(d_inner),
        "w_out": P.dense((d_inner, cfg.d_model), ("mlp", "fsdp")),
    }


def _split_proj(cfg: ModelConfig, z):
    d_inner, H, Pd, N = dims(cfg)
    gate, xin, B, C, dt = torch.split(z, [d_inner, d_inner, N, N, H], dim=-1)
    return gate, xin, B, C, dt


def _causal_conv(x, w, b):
    """Depthwise causal conv. x: (b,S,ch); w: (K,ch)."""
    K = w.shape[0]
    S = x.shape[1]
    out = torch.zeros_like(x)
    for i in range(K):
        shift = K - 1 - i
        xi = F.pad(x, (0, 0, shift, 0))[:, :S] if shift else x
        out = out + xi * w[i][None, None, :]
    return out + b[None, None, :]


def _conv_step(x_t, conv_state, w, b):
    """x_t: (b,ch); conv_state: (b,K-1,ch) holding previous inputs."""
    full = torch.cat([conv_state, x_t[:, None, :]], dim=1)  # (b,K,ch)
    out = torch.einsum("bkc,kc->bc", full, w) + b[None, :]
    return out, full[:, 1:]


def _in_proj(cfg, w, x):
    """norm, in-projection and causal conv: (gate, xin, B, C, dt f32,
    conv_in)."""
    d_inner, H, Pd, N = dims(cfg)
    dt_comp = x.dtype
    h = rms_norm(x, w["ln"], cfg.norm_eps)
    z = h @ w["w_in"].to(dt_comp)
    gate, xin, B, C, dtr = _split_proj(cfg, z)
    conv_in = torch.cat([xin, B, C], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, w["conv_w"].to(dt_comp),
                                   w["conv_b"].to(dt_comp)))
    xin, B, C = torch.split(conv_out, [d_inner, N, N], dim=-1)
    dt = F.softplus(dtr.float() + w["dt_bias"].float())
    return gate, xin, B, C, dt, conv_in


def _out_proj(cfg, w, y, gate, dt_comp):
    y = rms_norm(y.to(dt_comp) * F.silu(gate), w["norm_gate"], cfg.norm_eps)
    return y @ w["w_out"].to(dt_comp)


def mamba_apply(cfg, ctx: ShardingCtx, w, x, *, chunk):
    out, _ = mamba_prefill(cfg, ctx, w, x, chunk=chunk)
    return out


def mamba_prefill(cfg, ctx, w, x, *, chunk):
    b, S, _ = x.shape
    d_inner, H, Pd, N = dims(cfg)
    K = cfg.ssm_conv_width
    gate, xin, B, C, dt, conv_in = _in_proj(cfg, w, x)
    # the last K-1 conv inputs, zero-padded on the left when S < K-1
    conv_state = F.pad(conv_in, (0, 0, K - 1, 0))[:, -(K - 1):] \
        if S >= K - 1 else F.pad(conv_in, (0, 0, K - 1 - S, 0))
    y, ssm = ssd_chunked(xin.reshape(b, S, H, Pd), dt, B, C, w["A_log"], w["D"],
                         torch.zeros((b, H, Pd, N), dtype=torch.float32,
                                     device=x.device), chunk=chunk)
    out = _out_proj(cfg, w, y.reshape(b, S, d_inner), gate, x.dtype)
    # a copy: a view would keep the whole padded conv input alive with the
    # state (60 MB a layer at the serve's shape)
    state = {"ssm": ssm, "conv": conv_state.to(torch.bfloat16, copy=True)}
    return ctx.constrain(out, ("batch", "seq", "embed")), state


def mamba_decode(cfg, ctx, w, x, state):
    """x: (b,1,d); state: {ssm (b,H,P,N), conv (b,K-1,ch)}."""
    b = x.shape[0]
    d_inner, H, Pd, N = dims(cfg)
    dt_comp = x.dtype
    h = rms_norm(x, w["ln"], cfg.norm_eps)[:, 0]
    z = h @ w["w_in"].to(dt_comp)
    gate, xin, B, C, dtr = _split_proj(cfg, z)
    conv_in = torch.cat([xin, B, C], dim=-1)
    conv_out, conv_state = _conv_step(conv_in, state["conv"].to(dt_comp),
                                      w["conv_w"].to(dt_comp),
                                      w["conv_b"].to(dt_comp))
    conv_out = F.silu(conv_out)
    xin, B, C = torch.split(conv_out, [d_inner, N, N], dim=-1)
    dt = F.softplus(dtr.float() + w["dt_bias"].float())
    y, ssm = ssd_step(xin.reshape(b, H, Pd), dt, B, C, w["A_log"], w["D"],
                      state["ssm"])
    out = _out_proj(cfg, w, y.reshape(b, d_inner), gate, dt_comp)[:, None, :]
    return out, {"ssm": ssm, "conv": conv_state.to(torch.bfloat16)}


def mamba_state_specs(cfg: ModelConfig, batch: int) -> Dict:
    d_inner, H, Pd, N = dims(cfg)
    K = cfg.ssm_conv_width
    return {
        "ssm": P.dense((batch, H, Pd, N), ("batch", "heads", None, None),
                       init="zeros", dtype="float32"),
        "conv": P.dense((batch, K - 1, d_inner + 2 * N), ("batch", None, "mlp"),
                        init="zeros", dtype="bfloat16"),
    }


# --- Zamba2 hybrid stack ----------------------------------------------------------------


def n_shared_applications(cfg: ModelConfig) -> int:
    e = cfg.shared_attn_every
    return 0 if e <= 0 else sum(1 for i in range(cfg.num_layers) if i % e == e - 1)


def stack_specs(cfg: ModelConfig) -> Dict:
    specs = {"layers": P.stack_tree(cfg.num_layers, mamba_specs(cfg))}
    if cfg.shared_attn_every > 0:
        specs["shared"] = T.block_specs(cfg, moe=False)  # weight-tied, NOT stacked
    return specs


def _is_attn_layer(cfg: ModelConfig, i: int) -> bool:
    e = cfg.shared_attn_every
    return e > 0 and i % e == e - 1


def stack_apply(cfg, run: RunConfig, ctx, w, x, positions, *, chunk):
    """Full-sequence forward through ``scan_utils.grouped_scan``, as the
    reference's: the layer index is scanned beside the layers' weights,
    and the weight-tied shared block, which the body captures and does not
    scan, runs after each layer where ``_is_attn_layer`` holds; under
    remat it is rematerialised with its layer. Returns (x, aux_loss 0)."""
    shared = w.get("shared")

    def body(x, inp):
        x = x + mamba_apply(cfg, ctx, inp["layer"], x, chunk=chunk)
        if shared is not None and _is_attn_layer(cfg, int(inp["index"])):
            x, _ = T.block_apply(cfg, run, ctx, shared, x, positions)
        return x, None

    # the index as Python ints (a range, sliced as the layers are): no
    # tensor is read back, so a trace on fake tensors can take the branch
    xs = {"index": range(cfg.num_layers), "layer": w["layers"]}
    x, _ = grouped_scan(body, x, xs, cfg.num_layers, run.scan_group,
                        run.remat == "block")
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def hybrid_cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> Dict:
    specs = {"mamba": P.stack_tree(cfg.num_layers, mamba_state_specs(cfg, batch))}
    napp = n_shared_applications(cfg)
    if napp:
        att = A.cache_specs(cfg, batch, A.effective_cache_len(cfg, cache_len))
        specs["attn"] = P.stack_tree(napp, att)
    return specs


def stack_prefill(cfg, run: RunConfig, ctx, w, x, positions, *, chunk):
    """Returns (x, {"mamba": per-layer states stacked (L, ...), "attn": the
    shared block's k, v per application (napp, B, cache, Hkv, D) bf16})."""
    shared = w.get("shared")
    S = x.shape[1]
    eff = A.effective_cache_len(cfg, S)
    states, ks, vs = [], [], []
    for i in range(cfg.num_layers):
        dx, st = mamba_prefill(cfg, ctx, P.layer(w["layers"], i), x, chunk=chunk)
        x = x + dx
        states.append(st)
        if shared is not None and _is_attn_layer(cfg, i):
            x, k, v = T.block_prefill(cfg, run, ctx, shared, x, positions)
            ks.append(k[:, -eff:].to(torch.bfloat16))
            vs.append(v[:, -eff:].to(torch.bfloat16))
    cache = {"mamba": P.stack_layers(states)}
    if n_shared_applications(cfg):
        cache["attn"] = {"k": torch.stack(ks), "v": torch.stack(vs)}
    return x, cache


def stack_decode(cfg, run: RunConfig, ctx, w, cache, x, pos: int, *,
                 use_flash: bool = False):
    """One token through the stack; ``pos`` is its position, a Python int.
    Returns (x, the new cache). ``use_flash``: the shared attention through
    ``flash_decode`` on a mesh."""
    shared = w.get("shared")
    states, ks, vs = [], [], []
    for i in range(cfg.num_layers):
        dx, st = mamba_decode(cfg, ctx, P.layer(w["layers"], i), x,
                              P.layer(cache["mamba"], i))
        x = x + dx
        states.append(st)
        if shared is not None and _is_attn_layer(cfg, i):
            app = i // cfg.shared_attn_every
            x, ck, cv = T.block_decode(cfg, run, ctx, shared, x,
                                       cache["attn"]["k"][app],
                                       cache["attn"]["v"][app], pos,
                                       use_flash=use_flash)
            ks.append(ck)
            vs.append(cv)
    out = {"mamba": P.stack_layers(states)}
    if "attn" in cache:
        out["attn"] = {"k": torch.stack(ks), "v": torch.stack(vs)}
    return x, out
