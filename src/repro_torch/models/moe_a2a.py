"""Expert-parallel MoE through ``spmd.shard_map`` and ``all_to_all``, the
counterpart of ``repro/models/moe_a2a.py``, line for line.

The dense dispatch (``models/moe``) builds a (g, E, C) combine tensor for
every token group; this path moves each token's row explicitly:

  1. each rank of the ``model`` axis routes its 1/n slice of the local
     tokens (routing is replicated work otherwise),
  2. sort-based packing (no one-hot products): assignments sorted by
     expert, packed into per-expert capacity buckets (E, C, d),
  3. one ``all_to_all`` over the model axis delivers each rank its
     experts' buckets; the expert FFNs run as local grouped products,
  4. the reverse ``all_to_all`` and a scatter-add combine; one
     ``all_gather`` rejoins the ranks' token slices.

Capacity semantics (drops beyond C) follow the reference's: an
assignment past its expert's C slots is dropped. ``a2a_route``,
``a2a_experts`` and ``a2a_combine`` are the body's local parts: the
``shard_map`` cell puts them together with ``spmd``'s collectives, a
cell of the partitioned training step with a tape's
(``models.transformer._a2a_half``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.launch.mesh import mesh_axis_sizes
from repro_torch.models.common import mlp_apply
from repro_torch.models.moe import CAPACITY_FACTOR


def _pair_capacity(t_m: int, cfg: ModelConfig) -> int:
    c = math.ceil(t_m * cfg.experts_per_token * CAPACITY_FACTOR
                  / cfg.num_experts)
    return max(8, ((c + 7) // 8) * 8)


def a2a_route(cfg: ModelConfig, n: int, m: int, xt, router):
    """Rank ``m`` of ``n``: routes its slice of the tokens ``xt`` (T, d)
    and packs them by expert. Returns the buckets (n, e_loc, C, d) for
    the all-to-all, the packing (``a2a_combine``'s arguments after
    ``back``) and the rank's aux loss (float32)."""
    dt = xt.dtype
    T, d = xt.shape
    t_m = T // n
    C = _pair_capacity(t_m, cfg)
    E, k = cfg.num_experts, cfg.experts_per_token
    dev = xt.device
    x_m = xt[m * t_m:(m + 1) * t_m]  # (t_m, d)

    # 1) route
    logits = torch.matmul(x_m, router.to(dt)).float()
    probs = torch.softmax(logits, dim=-1)
    wk, ids = torch.topk(probs, k, dim=-1)  # (t_m, k)
    wk = wk / torch.clamp(wk.sum(dim=-1, keepdim=True), min=1e-9)

    # 2) sort-based packing into (E, C, d)
    flat_e = ids.reshape(-1)  # (t_m*k,)
    flat_t = torch.arange(t_m, device=dev).repeat_interleave(k)
    flat_w = wk.reshape(-1).float()
    order = torch.argsort(flat_e, stable=True)
    se, st_, sw = flat_e[order], flat_t[order], flat_w[order]
    # position within expert = index - start offset of that expert
    # bincount by an index_add (the same integers): its output's size
    # does not hang on the data, so the dry-run can trace it on meta
    # tensors
    counts = torch.zeros(E, dtype=se.dtype, device=dev).index_add_(
        0, se, torch.ones_like(se))
    starts = torch.cumsum(counts, dim=0) - counts
    pos = torch.arange(t_m * k, device=dev) - starts[se]
    keep = pos < C
    slot = torch.where(keep, pos, C)  # C = spill row (dropped)
    send = torch.zeros((E, C + 1, d), dtype=dt, device=dev).index_put(
        (se, slot), xt[st_ + m * t_m])
    send = send[:, :C].reshape(n, E // n, C, d)

    # aux load-balance loss (Switch) of this rank's tokens
    frac = counts.float() / torch.clamp(counts.sum(), min=1)
    aux = E * torch.sum(frac * probs.mean(dim=0))
    return send, (se, st_, sw, slot, keep), aux


def a2a_experts(recv, w_gate, w_up, w_down):
    """recv (n_src, e_loc, C, d), the buckets of this rank's experts from
    every rank -> their outputs (n_src, e_loc, C, d) for the reverse
    all-to-all: grouped products, fully local."""
    n, e_loc, C, d = recv.shape
    dt = recv.dtype
    x = recv.movedim(0, 1).reshape(e_loc, n * C, d)
    h = F.silu(torch.einsum("ecd,edf->ecf", x, w_gate.to(dt)))
    h = h * torch.einsum("ecd,edf->ecf", x, w_up.to(dt))
    ye = torch.einsum("ecf,efd->ecd", h, w_down.to(dt))
    return ye.reshape(e_loc, n, C, d).movedim(1, 0)


def a2a_combine(back, se, st_, sw, slot, keep, t_m: int):
    """back (n, e_loc, C, d), this rank's tokens' expert outputs ->
    its slice of the layer's output (t_m, d), by a scatter-add."""
    n, e_loc, C, d = back.shape
    back = back.reshape(n * e_loc, C, d)
    picked = back[se, torch.clamp(slot, 0, C - 1)]
    picked = torch.where(keep[:, None], picked, torch.zeros_like(picked))
    contrib = picked.float() * sw[:, None]
    y_m = torch.zeros((t_m, d), dtype=torch.float32,
                      device=back.device).index_add(0, st_, contrib)
    return y_m.to(back.dtype)


def moe_a2a_apply(cfg: ModelConfig, ctx: ShardingCtx, w, x: torch.Tensor):
    """x: (B, S, d) with B sharded over the batch axes. Returns (y, aux)."""
    mesh = ctx.mesh
    if mesh is None or "model" not in mesh.axis_names:
        raise ValueError("moe_a2a_apply runs on a mesh with a 'model' axis")
    n_exp_shards = mesh_axis_sizes(mesh)["model"]
    if cfg.num_experts % n_exp_shards:
        raise ValueError(f"{cfg.num_experts} experts do not split over "
                         f"{n_exp_shards} model ranks")
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)

    def local_moe(xb, router, w_gate, w_up, w_down):
        # xb: (B_loc, S, d); expert weights: (e_loc, ...) the local shard
        B_loc, S, d = xb.shape
        n = n_exp_shards
        send, packing, aux = a2a_route(cfg, n, spmd.axis_index("model"),
                                       xb.reshape(B_loc * S, d), router)
        # 3) a2a: each rank its e_loc experts' buckets, by source rank
        recv = spmd.all_to_all(send, "model", split_axis=0, concat_axis=0)
        ye = a2a_experts(recv, w_gate, w_up, w_down)
        # 4) reverse a2a + combine
        back = spmd.all_to_all(ye, "model", split_axis=0, concat_axis=0)
        y_m = a2a_combine(back, *packing, B_loc * S // n)
        # rejoin the rank slices
        y = spmd.all_gather(y_m, "model", axis=0)
        # the aux loss averaged over the ranks
        return y.reshape(B_loc, S, d), spmd.pmean(aux, "model")

    bspec = (batch_axes if batch_axes else None, None, None)
    fn = spmd.shard_map(
        local_moe, mesh,
        in_specs=(bspec, (None, None), ("model", None, None),
                  ("model", None, None), ("model", None, None)),
        out_specs=(bspec, ()))
    y, aux = fn(x, w["router"], w["w_gate"], w["w_up"], w["w_down"])
    if cfg.shared_expert:
        y = y + mlp_apply(w["shared"], x, ctx, cfg.act)
    return y, aux * cfg.router_aux_loss
