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
assignment past its expert's C slots is dropped.
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


def moe_a2a_apply(cfg: ModelConfig, ctx: ShardingCtx, w, x: torch.Tensor):
    """x: (B, S, d) with B sharded over the batch axes. Returns (y, aux)."""
    mesh = ctx.mesh
    if mesh is None or "model" not in mesh.axis_names:
        raise ValueError("moe_a2a_apply runs on a mesh with a 'model' axis")
    n_exp_shards = mesh_axis_sizes(mesh)["model"]
    if cfg.num_experts % n_exp_shards:
        raise ValueError(f"{cfg.num_experts} experts do not split over "
                         f"{n_exp_shards} model ranks")
    e_loc = cfg.num_experts // n_exp_shards
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)

    def local_moe(xb, router, w_gate, w_up, w_down):
        # xb: (B_loc, S, d); expert weights: (e_loc, ...) the local shard
        dt = xb.dtype
        B_loc, S, d = xb.shape
        T = B_loc * S
        m = spmd.axis_index("model")
        t_m = T // n_exp_shards
        C = _pair_capacity(t_m, cfg)
        E, k = cfg.num_experts, cfg.experts_per_token
        dev = xb.device

        xt = xb.reshape(T, d)
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
        send = send[:, :C]  # (E, C, d)

        # 3) a2a: (E, C, d) -> each rank its e_loc experts
        recv = spmd.all_to_all(send.reshape(n_exp_shards, e_loc, C, d),
                               "model", split_axis=0, concat_axis=0)
        # recv: (n_src, e_loc, C, d) -> (e_loc, n_src*C, d)
        recv = recv.movedim(0, 1).reshape(e_loc, n_exp_shards * C, d)

        # expert FFNs: grouped products, fully local
        h = F.silu(torch.einsum("ecd,edf->ecf", recv, w_gate.to(dt)))
        h = h * torch.einsum("ecd,edf->ecf", recv, w_up.to(dt))
        ye = torch.einsum("ecf,efd->ecd", h, w_down.to(dt))

        # 4) reverse a2a + combine
        ye = ye.reshape(e_loc, n_exp_shards, C, d).movedim(1, 0)
        back = spmd.all_to_all(ye, "model", split_axis=0, concat_axis=0)
        back = back.reshape(E, C, d)  # my tokens' expert outputs
        picked = back[se, torch.clamp(slot, 0, C - 1)]
        picked = torch.where(keep[:, None], picked, torch.zeros_like(picked))
        contrib = picked.float() * sw[:, None]
        y_m = torch.zeros((t_m, d), dtype=torch.float32,
                          device=dev).index_add(0, st_, contrib)

        # rejoin the rank slices
        y = spmd.all_gather(y_m.to(dt), "model", axis=0)
        # aux load-balance loss (Switch), averaged over the ranks
        frac = counts.float() / torch.clamp(counts.sum(), min=1)
        mean_prob = probs.mean(dim=0)
        aux = E * torch.sum(frac * mean_prob)
        aux = spmd.pmean(aux, "model")
        return y.reshape(B_loc, S, d), aux

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
