"""Mixture-of-Experts layer: a top-k router and capacity-based dispatch
(GShard), the counterpart of ``repro/models/moe.py``.

The dense dispatch/combine einsums stay products (``torch.einsum``), as
the reference leaves them to XLA outside any Pallas kernel. Tokens are
routed in groups of ``MOE_GROUP`` so the (g, E, C) combine tensor stays
bounded whatever the sequence length: at olmoe-1b-7b's 64 experts and a
full group it is (4096, 64, 640) float32, 671 MB. ``impl="a2a"`` on a
mesh with a ``model`` axis takes the expert-parallel path of
``models/moe_a2a`` (``spmd.shard_map`` and ``all_to_all`` over that
axis), as the reference does.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch import ranges
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.models import params as P
from repro_torch.models.common import mlp_apply, mlp_specs

MOE_GROUP = 4096
CAPACITY_FACTOR = 1.25


def moe_specs(cfg: ModelConfig) -> Dict[str, P.TensorSpec]:
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    specs = {
        "router": P.dense((d, E), ("fsdp", "experts"), scale=0.1),
        "w_gate": P.dense((E, d, ff), ("experts", "fsdp", "expert_mlp")),
        "w_up": P.dense((E, d, ff), ("experts", "fsdp", "expert_mlp")),
        "w_down": P.dense((E, ff, d), ("experts", "expert_mlp", "fsdp")),
    }
    if cfg.shared_expert:
        specs["shared"] = mlp_specs(cfg, d_ff=cfg.d_ff)
    return specs


def capacity(group: int, cfg: ModelConfig) -> int:
    """Slots an expert has for a group of ``group`` tokens: the reference's
    rounding (up to a multiple of 128 above 8, at least 4 below)."""
    c = int(math.ceil(group * cfg.experts_per_token * CAPACITY_FACTOR
                      / cfg.num_experts))
    return max(8, ((c + 127) // 128) * 128) if c > 8 else max(c, 4)


def _route(cfg: ModelConfig, logits: torch.Tensor):
    """logits (g, E) -> weights (g, k), ids (g, k), router probs (g, E)."""
    probs = torch.softmax(logits.float(), dim=-1)
    w, ids = torch.topk(probs, cfg.experts_per_token, dim=-1)
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)  # olmoe renorm
    return w, ids, probs


def _combine_tensor(cfg: ModelConfig, w, ids, C: int):
    """(g, E, C) combine weights (GShard): the slot of each assignment is
    its rank among the expert's assignments in priority order, every
    token's k=0 choice first, then its k=1 choice, and so on (a cumsum over
    the k-major flattening); an assignment whose slot is C or more is
    dropped. The reference sums k one-hot products of (g, E, C); since a
    token's k experts differ, each cell holds at most one assignment, so
    the port writes the same values into their cells, without k temporaries
    of the combine tensor's size."""
    g, k = ids.shape
    E = cfg.num_experts
    onehot = F.one_hot(ids, E).float()  # (g, k, E)
    flat = onehot.transpose(0, 1).reshape(k * g, E)
    pos = (torch.cumsum(flat, dim=0) - flat).reshape(k, g, E)
    slot = (pos * onehot.transpose(0, 1)).sum(dim=-1).T.long()  # (g, k)
    keep = slot < C
    # a dropped assignment writes 0 into slot 0 of its expert (where the
    # reference's one_hot gives a zero row): mask before indexing
    rows = torch.arange(g, device=ids.device)[:, None].expand(g, k)
    combine = torch.zeros((g, E, C), dtype=torch.float32, device=w.device)
    return combine.index_put((rows, ids, torch.where(keep, slot, 0)),
                             w * keep, accumulate=True)


def _moe_group_apply(cfg: ModelConfig, ctx: ShardingCtx, wts, xg):
    """xg: (g, d) one token group -> (y (g, d), aux). Its four parts run
    under the ranges (``repro_torch.ranges``) ``moe_route``,
    ``moe_dispatch``, ``moe_experts`` and ``moe_combine``, which a trace
    reads."""
    dt = xg.dtype
    g = xg.shape[0]
    C = capacity(g, cfg)
    with ranges.named("moe_route"):
        logits = xg @ wts["router"].to(dt)  # (g, E)
        w, ids, probs = _route(cfg, logits)
        combine = _combine_tensor(cfg, w, ids, C)  # (g, E, C) f32
        combine = ctx.constrain(combine, ("batch", "experts", "capacity"))
        kept = combine > 0
    with ranges.named("moe_dispatch"):
        xe = torch.einsum("gec,gd->ecd", kept.to(dt), xg)
        xe = ctx.constrain(xe, ("experts", "capacity", "embed"))
    with ranges.named("moe_experts"):
        h = F.silu(torch.einsum("ecd,edf->ecf", xe, wts["w_gate"].to(dt)))
        h = h * torch.einsum("ecd,edf->ecf", xe, wts["w_up"].to(dt))
        h = ctx.constrain(h, ("experts", "capacity", "expert_mlp"))
        ye = torch.einsum("ecf,efd->ecd", h, wts["w_down"].to(dt))
        ye = ctx.constrain(ye, ("experts", "capacity", "embed"))
    with ranges.named("moe_combine"):
        y = torch.einsum("gec,ecd->gd", combine.to(dt), ye)
        # load-balancing aux loss (Switch): E * sum_e(frac_tokens_e *
        # mean_prob_e)
        frac = kept.sum(dim=2).float().mean(dim=0) / cfg.experts_per_token
        aux = cfg.num_experts * torch.sum(frac * probs.mean(dim=0))
    return y, aux


def moe_apply(cfg: ModelConfig, ctx: ShardingCtx, wts, x,
              impl: str = "dense"):
    """x: (B, S, d) -> (y, aux_loss). ``impl="a2a"`` on a mesh with a
    ``model`` axis takes the expert-parallel ``moe_a2a_apply``; otherwise
    the dense path runs, as in the reference."""
    if impl == "a2a" and ctx.mesh is not None and \
            "model" in ctx.mesh.axis_names:
        from repro_torch.models.moe_a2a import moe_a2a_apply
        return moe_a2a_apply(cfg, ctx, wts, x)
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    group = min(MOE_GROUP, T)
    if T % group != 0:
        group = T
    outs = [_moe_group_apply(cfg, ctx, wts, xc) for xc in xf.split(group)]
    # the groups' aux losses averaged (one group: its own, exactly)
    y = torch.cat([o[0] for o in outs]).reshape(B, S, d)
    aux = torch.stack([o[1] for o in outs]).mean()
    if cfg.shared_expert:
        y = y + mlp_apply(wts["shared"], x, ctx, cfg.act)
    return y, aux * cfg.router_aux_loss
