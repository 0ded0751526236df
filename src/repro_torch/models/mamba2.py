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

A layer's training forward is written as segments (``layer_segments``):
in a cell of the partitioned training step they run on the cell's tape,
tensor-parallel over ``model`` (the Mamba2 block on the cell's SSD heads
and its rows of ``w_out``, ``w_in`` gathered inside the tape; the shared
block's attention on its heads and its MLP on its columns;
``distributed.tensor_parallel``'s rules (a) and (c)); outside it
(``layer_apply``, ``stack_apply``) on ``tensor_parallel.INLINE``, plain
calls. The serve programs (``prefill_segments``, ``decode_segments``)
are the same halves, each also giving its part of the cache: on
``INLINE`` for ``models.lm``'s ``prefill_fn`` and ``decode_fn``, in a
cell of the partitioned serve (``serve.step``) on its heads and columns,
from and into its shard of the cache (the SSD state of its heads, its
even block of the conv state's channels, the shared block's k and v as
the dense cache is cut). A decode step's mixer is ``_mixer_step``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.distributed import spmd
from repro_torch.distributed import tensor_parallel as tp
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


def _pick(w, ranges):
    """``w``'s last-dim ``ranges`` side by side: ``w`` itself where they
    are all of it, in order."""
    ends = [0] + [b for _, b in ranges]
    if [a for a, _ in ranges] == ends[:-1] and ends[-1] == w.shape[-1]:
        return w
    return torch.cat([w[..., a:b] for a, b in ranges], dim=-1)


def _mixer(cfg, w, h, lo: int, hi: int, *, chunk):
    """The Mamba2 mixer of heads ``[lo, hi)`` (all H: the whole layer)
    from the normed ``h``, its leaves read from ``w``: the in-projection
    through their gate, x and dt columns of ``w_in`` and the B and C
    columns, which every head shares; the depthwise causal conv on their
    x channels and on B and C; SSD from the zero state. Returns (y *
    silu(gate) (b, S, (hi - lo) P) in h's dtype, the SSD state, the conv
    input)."""
    d_inner, H, Pd, N = dims(cfg)
    b, S, _ = h.shape
    n = hi - lo
    dt_comp = h.dtype
    bc = 2 * d_inner + 2 * N
    z = h @ _pick(w["w_in"], ((lo * Pd, hi * Pd),
                              (d_inner + lo * Pd, d_inner + hi * Pd),
                              (2 * d_inner, bc), (bc + lo, bc + hi))
                  ).to(dt_comp)
    gate, xin, B, C, dtr = torch.split(z, [n * Pd, n * Pd, N, N, n], dim=-1)
    conv_in = torch.cat([xin, B, C], dim=-1)
    ch = ((lo * Pd, hi * Pd), (d_inner, d_inner + 2 * N))
    conv_out = F.silu(_causal_conv(conv_in, _pick(w["conv_w"], ch).to(dt_comp),
                                   _pick(w["conv_b"], ch).to(dt_comp)))
    xin, B, C = torch.split(conv_out, [n * Pd, N, N], dim=-1)
    dt = F.softplus(dtr.float() + w["dt_bias"][lo:hi].float())
    y, ssm = ssd_chunked(xin.reshape(b, S, n, Pd), dt, B, C,
                         w["A_log"][lo:hi], w["D"][lo:hi],
                         torch.zeros((b, n, Pd, N), dtype=torch.float32,
                                     device=h.device), chunk=chunk)
    return y.reshape(b, S, n * Pd).to(dt_comp) * F.silu(gate), ssm, conv_in


def _mixer_step(cfg, w, h, lo: int, hi: int, ssm, conv):
    """One token of the Mamba2 mixer of heads ``[lo, hi)`` from the
    normed ``h`` (b, 1, d), its leaves read from ``w``: the token's conv
    input on every channel (the x of all heads, B and C: each cell keeps
    its block of the shifted conv state, whatever heads it runs) from
    ``w_in``'s x, B and C columns, beside the heads' gate and dt columns;
    the depthwise conv of the heads' x channels and of B and C over
    ``conv`` (b, K-1, d_inner + 2N), the previous inputs of every
    channel, and the token's; ``ssd_step`` from the heads' state ``ssm``.
    Returns (y * silu(gate) (b, 1, (hi - lo) P) in h's dtype, the SSD
    state, the shifted conv state (b, K-1, d_inner + 2N))."""
    d_inner, H, Pd, N = dims(cfg)
    b = h.shape[0]
    n = hi - lo
    dt_comp = h.dtype
    bc = 2 * d_inner + 2 * N
    z = h[:, 0] @ _pick(w["w_in"], ((lo * Pd, hi * Pd), (d_inner, bc),
                                    (bc + lo, bc + hi))).to(dt_comp)
    gate, conv_in, dtr = torch.split(z, [n * Pd, d_inner + 2 * N, n], dim=-1)
    full = torch.cat([conv.to(dt_comp), conv_in[:, None, :]], dim=1)
    ch = ((lo * Pd, hi * Pd), (d_inner, d_inner + 2 * N))
    conv_out = F.silu(torch.einsum("bkc,kc->bc", _pick(full, ch),
                                   _pick(w["conv_w"], ch).to(dt_comp))
                      + _pick(w["conv_b"], ch).to(dt_comp)[None, :])
    xin, B, C = torch.split(conv_out, [n * Pd, N, N], dim=-1)
    dt = F.softplus(dtr.float() + w["dt_bias"][lo:hi].float())
    y, ssm = ssd_step(xin.reshape(b, n, Pd), dt, B, C, w["A_log"][lo:hi],
                      w["D"][lo:hi], ssm)
    yg = y.reshape(b, n * Pd).to(dt_comp) * F.silu(gate)
    return yg[:, None, :], ssm, full[:, 1:]


def _out_proj(cfg, yg, scale, w_out):
    """The gated norm over all of d_inner and the out-projection."""
    return rms_norm(yg, scale, cfg.norm_eps) @ w_out.to(yg.dtype)


def _conv_rest(cfg, conv_in, cut):
    """The conv state at rest: the last K-1 conv inputs of ``conv_in``
    (b, S, d_inner + 2N; a prefill's, or a decode step's shifted state),
    zero-padded on the left where S < K-1; in a serve cell whose conv
    state ``model`` cuts (``cut.conv``) its even block of the channels. A
    bfloat16 copy: a view would keep the whole conv input alive with the
    state (60 MB a layer at the serve's shape)."""
    K = cfg.ssm_conv_width
    tail = F.pad(conv_in[:, -(K - 1):], (0, 0, K - 1, 0))[:, -(K - 1):]
    if cut is not None and cut.conv:
        tail = cut.block(tail, 2)
    return tail.to(torch.bfloat16, copy=True)


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


# the leaves the Mamba2 mixer reads on a cell's heads or channels that
# are not cut over ``model``: they leave the replicated segment and enter
# the cell's (rule (a)), so their gradients sum over the group
ENTERED = ("conv_w", "conv_b", "dt_bias", "A_log", "D")


def _mamba_half(cfg: ModelConfig, ctx: ShardingCtx, tc, wl, x, adds, chunk, *,
                state=None, serve: bool = False, cut=None):
    """The Mamba2 block on the tape of ``tc``, its leaves read by
    ``wl()``. The replicated segment: the residual sum and ``ln``, with
    ``w_in``, the ``ENTERED`` leaves and ``norm_gate``'s scale passed out
    as they are. Where the blocks are model-local (``Plan.ssd``) the cell
    gathers ``w_in`` (its even block at rest) over ``model`` inside the
    tape, one all-gather whose transpose reduce-scatters the cells'
    partial gradients, and the normed stream and the ``ENTERED`` leaves
    enter; the cell's segment runs the mixer on its H/m heads (B and C
    projected and convolved in every cell: replicated work) and takes
    each row's sum of squares of its channels of y * silu(gate), which
    exits and enters at once (rule (c)): the gated norm spans all of
    d_inner. Then the norm with the scale's channels of the cell and its
    rows of ``w_out``, through the exit. Returns (x, adds).

    A serve's prefill (``serve``) or decode step (``state``: the layer's
    state, a serve cell's shard of it) also returns the SSD state of the
    cell's heads and the conv state at rest: (x, adds, ssm, conv). The
    conv state's even block of channels (``cut.conv``: ``model`` cuts it)
    is not the cell's heads' x, B and C: a prefill computes the conv
    input of every channel for the last K-1 tokens from the gathered
    ``w_in``, a decode step gathers the conv state over ``model`` inside
    the tape (``_mixer_step``; the one cache leaf a cell gathers) and
    keeps its block of the shifted one."""
    tape = tc.tape
    local = tc.plan.ssd
    d_inner, H, Pd, N = dims(cfg)
    K, eps = cfg.ssm_conv_width, cfg.norm_eps
    serve = serve or state is not None

    def pre(x, *a):
        x = T._resid(x, a)
        w = wl()
        return (x, rms_norm(x, w["ln"], eps), w["w_in"],
                *(w[n] for n in ENTERED), w["norm_gate"])

    x, h, w_in, *mix, scale = tape.run(pre, x, *adds)
    lo, hi = tc.block(H) if local else (0, H)
    conv = ()
    if state is not None:
        conv = (state["conv"],)
        if cut is not None and cut.conv:  # every cell's channels
            with spmd.labelled("conv"):
                conv = (tape.all_gather(conv[0], tp.AXIS, 2),)

    def heads(h, w_in, *rest):
        mix, conv = rest[:len(ENTERED)], rest[len(ENTERED):]
        w = {**wl(), "w_in": w_in, **dict(zip(ENTERED, mix))}
        if state is not None:
            yg, ssm, shifted = _mixer_step(cfg, w, h, lo, hi, state["ssm"],
                                           conv[0])
            kept = (ssm, _conv_rest(cfg, shifted, cut))
        else:
            yg, ssm, conv_in = _mixer(cfg, w, h, lo, hi, chunk=chunk)
            if serve and local:  # every channel's conv input, K-1 tokens
                conv_in = h[:, -(K - 1):] @ w_in[
                    :, d_inner:2 * d_inner + 2 * N].to(h.dtype)
            kept = (ssm, _conv_rest(cfg, conv_in, cut)) if serve else ()
        if not local:
            return (yg, *kept)
        return (yg, *kept, torch.sum(torch.square(yg.float()), -1,
                                     keepdim=True))

    if not local:
        yg, *kept = tape.run(heads, h, w_in, *mix, *conv)
        part, = tape.run(lambda yg, s: (_out_proj(cfg, yg, s,
                                                  wl()["w_out"]),), yg, scale)
        return (x, (part,), *kept)
    yg, *kept, squares = tape.run(
        heads, tape.enter(h), tape.all_gather(w_in, tp.AXIS, 1,
                                              replicated=False),
        *(tape.enter(t) for t in mix), *conv)
    squares = tape.total(squares)
    cols = slice(lo * Pd, hi * Pd)

    def out(yg, squares, s):
        # rms_norm over all of d_inner, from the group's sum of squares
        y = (yg.float() * torch.rsqrt(squares / d_inner + eps)
             * s[cols].float()).to(yg.dtype)
        return (y @ wl()["w_out"].to(yg.dtype),)

    part, = tape.run(out, yg, squares, tape.enter(scale))
    return (x, (tape.exit(part),), *kept)


def layer_segments(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx, tc, wl,
                   ws, x, adds, positions, index: int, *, chunk):
    """Layer ``index`` on the tape of ``tc`` (a
    ``distributed.tensor_parallel.Cell``), its leaves read by ``wl()``:
    the Mamba2 block, then, where ``_is_attn_layer`` holds, the
    weight-tied shared block (``transformer.layer_segments`` on the
    leaves ``ws()``: its attention and MLP halves, model-local by the
    plan's ``attn`` and ``mlp``; its gradient accumulates over its
    applications in each leaf's ``.grad``; attention in query chunks of
    1024, ``transformer.block_apply``'s). Returns (x, adds)."""
    x, adds = _mamba_half(cfg, ctx, tc, wl, x, adds, chunk)
    if ws is not None and _is_attn_layer(cfg, index):
        x, adds, _ = T.layer_segments(cfg, run, ctx, tc, ws, x, adds,
                                      positions, 1024)
    return x, adds


def layer_apply(cfg, run, ctx, w, shared, x, positions, index: int, *, chunk):
    """``layer_segments`` on ``tensor_parallel.INLINE``."""
    x, adds = layer_segments(cfg, run, ctx, tp.INLINE, lambda: w,
                             None if shared is None else lambda: shared, x,
                             (), positions, index, chunk=chunk)
    return T._resid(x, adds)


def stack_apply(cfg, run: RunConfig, ctx, w, x, positions, *, chunk):
    """Full-sequence forward through ``scan_utils.grouped_scan``, as the
    reference's: the layer index is scanned beside the layers' weights,
    and the weight-tied shared block, which the body captures and does not
    scan, runs after each layer where ``_is_attn_layer`` holds; under
    remat it is rematerialised with its layer. Returns (x, aux_loss 0)."""
    shared = w.get("shared")

    def body(x, inp):
        return layer_apply(cfg, run, ctx, inp["layer"], shared, x, positions,
                           int(inp["index"]), chunk=chunk), None

    # the index as Python ints (a range, sliced as the layers are): no
    # tensor is read back, so a trace on fake tensors can take the branch
    xs = {"index": range(cfg.num_layers), "layer": w["layers"]}
    x, _ = grouped_scan(body, x, xs, cfg.num_layers, run.scan_group,
                        run.remat == "block")
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def stack_segments(cfg, run, ctx, tc, w, x, positions, *, chunk):
    """The stack on the tape of ``tc`` from the leaf ``x``, layer by
    layer. Returns (x, adds). On ``INLINE``: ``stack_apply``, its scan
    group and remat included."""
    if tc is tp.INLINE:
        return stack_apply(cfg, run, ctx, w, x, positions, chunk=chunk)[0], ()
    ws = (lambda: w["shared"]) if "shared" in w else None
    adds = ()
    for i in range(cfg.num_layers):
        x, adds = layer_segments(cfg, run, ctx, tc,
                                 lambda i=i: P.layer(w["layers"], i), ws, x,
                                 adds, positions, i, chunk=chunk)
    return x, adds


def hybrid_cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> Dict:
    specs = {"mamba": P.stack_tree(cfg.num_layers, mamba_state_specs(cfg, batch))}
    napp = n_shared_applications(cfg)
    if napp:
        att = A.cache_specs(cfg, batch, A.effective_cache_len(cfg, cache_len))
        specs["attn"] = P.stack_tree(napp, att)
    return specs


def _shared_form(cfg: ModelConfig, S: int):
    """A prefill's k or v of the shared block as its cache keeps it: the
    last ``effective_cache_len`` tokens, in bfloat16, as the reference
    writes them."""
    eff = A.effective_cache_len(cfg, S)
    return lambda k: k[:, -eff:].to(torch.bfloat16)


def prefill_segments(cfg, run: RunConfig, ctx, tc, stack, x, positions, *,
                     chunk, cut=None):
    """The prefill on the tape of ``tc`` (a cell of the partitioned
    serve, ``serve.step``, or ``INLINE``): each layer's Mamba2 block
    (``stack("layers", i)`` its leaves), then, where ``_is_attn_layer``
    holds, the weight-tied shared block (``transformer.layer_prefill`` on
    ``stack("shared")``, taken at each application: a serve cell gathers
    it there), whose k and v form the application's cache (in a serve
    cell its shard, ``attention.cache_rest`` by ``cut``, a
    ``attention.CacheCut``, which also says whether ``model`` cuts the
    conv state). Returns (x, adds, cache): {"mamba": the layers' SSD and
    conv states stacked (L, ...), "attn": the shared block's k, v per
    application (napp, B, cache, Hkv, D) bf16}; in a serve cell its
    shard."""
    form = _shared_form(cfg, x.shape[1])
    adds, states, ks, vs = (), [], [], []
    for i in range(cfg.num_layers):
        wi = stack("layers", i)
        x, adds, ssm, conv = _mamba_half(cfg, ctx, tc, lambda: wi, x, adds,
                                         chunk, serve=True, cut=cut)
        states.append({"ssm": ssm, "conv": conv})
        if _is_attn_layer(cfg, i):
            ws = stack("shared")
            x, adds, k, v = T.layer_prefill(cfg, run, ctx, tc, lambda: ws, x,
                                            adds, positions, 1024, kv=form,
                                            cut=cut)
            ks.append(k)
            vs.append(v)
    cache = {"mamba": P.stack_layers(states)}
    if ks:
        cache["attn"] = {"k": torch.stack(ks), "v": torch.stack(vs)}
    return x, adds, cache


def decode_segments(cfg, run: RunConfig, ctx, tc, stack, cache, x, pos: int,
                    *, cut=None, use_flash: bool = False):
    """One token at position ``pos`` (a Python int) on the tape of ``tc``
    from ``cache`` (the whole cache, or a serve cell's shard of it;
    ``stack`` and ``cut`` as in ``prefill_segments``): each layer's Mamba2
    block from its state, the shared block's self attention against its
    application's cache (``transformer.layer_decode``; ``use_flash``:
    ``flash_decode`` on a mesh). Returns (x, adds, the new cache)."""
    adds, states, ks, vs = (), [], [], []
    for i in range(cfg.num_layers):
        wi = stack("layers", i)
        x, adds, ssm, conv = _mamba_half(cfg, ctx, tc, lambda: wi, x, adds,
                                         0, state=P.layer(cache["mamba"], i),
                                         cut=cut)
        states.append({"ssm": ssm, "conv": conv})
        if _is_attn_layer(cfg, i):
            app = i // cfg.shared_attn_every
            ws = stack("shared")
            x, adds, ck, cv = T.layer_decode(
                cfg, run, ctx, tc, lambda: ws, x, adds,
                cache["attn"]["k"][app], cache["attn"]["v"][app], pos,
                cut=cut, use_flash=use_flash)
            ks.append(ck)
            vs.append(cv)
    out = {"mamba": P.stack_layers(states)}
    if ks:
        out["attn"] = {"k": torch.stack(ks), "v": torch.stack(vs)}
    return x, adds, out

