"""Mixture-of-Experts layer: a top-k router and capacity-based dispatch
(GShard), the counterpart of ``repro/models/moe.py``.

The dense dispatch/combine einsums stay products (``torch.einsum``), as
the reference leaves them to XLA outside any Pallas kernel. Tokens are
routed in groups of ``MOE_GROUP`` so the (g, E, C) combine tensor stays
bounded whatever the sequence length: at olmoe-1b-7b's 64 experts and a
full group it is (4096, 64, 640) float32, 671 MB. ``impl="a2a"`` on a
mesh with a ``model`` axis takes the expert-parallel path of
``models/moe_a2a`` (``spmd.shard_map`` and ``all_to_all`` over that
axis), as the reference does. Inside a cell of the partitioned training
step the layer runs in parts instead (``moe_groups``, ``router_logits``,
``route_logits``, ``experts_apply``; the a2a's ``a2a_route``,
``a2a_experts``, ``a2a_combine`` on the step's own ``model`` axis, no
nested ``shard_map``), put together by ``models.transformer``'s
segmented stack with the collectives between them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

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


def _slots(cfg: ModelConfig, ids, C: int):
    """(slot, keep) of each assignment (g, k) (GShard): its rank among
    the expert's assignments in priority order, every token's k=0 choice
    first, then its k=1 choice, and so on (a cumsum over the k-major
    flattening); an assignment whose slot is C or more is dropped."""
    g, k = ids.shape
    onehot = F.one_hot(ids, cfg.num_experts).float()  # (g, k, E)
    flat = onehot.transpose(0, 1).reshape(k * g, cfg.num_experts)
    pos = (torch.cumsum(flat, dim=0) - flat).reshape(k, g, cfg.num_experts)
    slot = (pos * onehot.transpose(0, 1)).sum(dim=-1).T.long()  # (g, k)
    return slot, slot < C


def _combine_of(w, ids, slot, keep, lo: int, n: int, C: int):
    """(g, n, C) combine weights of experts ``[lo, lo + n)``. The
    reference sums k one-hot products of (g, E, C); since a token's k
    experts differ, each cell holds at most one assignment, so the port
    writes the same values into their cells, without k temporaries of the
    combine tensor's size. An assignment dropped, or to another expert,
    writes 0 into cell (0, 0) (where the reference's one_hot gives a zero
    row): masked before indexing."""
    g, k = ids.shape
    mine = keep & (ids >= lo) & (ids < lo + n)
    rows = torch.arange(g, device=ids.device)[:, None].expand(g, k)
    combine = torch.zeros((g, n, C), dtype=torch.float32, device=w.device)
    return combine.index_put(
        (rows, torch.where(mine, ids - lo, 0), torch.where(mine, slot, 0)),
        w * mine, accumulate=True)


def _combine_tensor(cfg: ModelConfig, w, ids, C: int):
    """(g, E, C) combine weights: ``_slots``, then ``_combine_of`` every
    expert."""
    slot, keep = _slots(cfg, ids, C)
    return _combine_of(w, ids, slot, keep, 0, cfg.num_experts, C)


def _aux_of(cfg: ModelConfig, ids, kept, probs):
    """The load-balancing aux loss (Switch) of one group: E * sum_e
    (frac_tokens_e * mean_prob_e), ``kept`` (g, k) the assignments that
    hold a slot and a weight above 0 (the combine tensor's cells above
    0)."""
    counts = torch.zeros(cfg.num_experts, dtype=torch.float32,
                         device=ids.device).index_add_(
        0, ids.reshape(-1), kept.reshape(-1).float())
    frac = counts / ids.shape[0] / cfg.experts_per_token
    return cfg.num_experts * torch.sum(frac * probs.mean(dim=0))


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
    xf = x.reshape(B * S, d)
    group, _ = moe_groups(B * S, 1)
    pieces = group_pieces(0, B * S, group)
    w, ids, slot, keep, aux = route_logits(
        cfg, router_logits(wts, xf, pieces), group)
    y = experts_apply(cfg, wts, xf, w, ids, slot, keep, 0, group,
                      pieces).reshape(B, S, d)
    if cfg.shared_expert:
        y = y + mlp_apply(wts["shared"], x, ctx, cfg.act)
    return y, aux


# --- the layer's parts -------------------------------------------------------------
# ``moe_apply`` runs them in turn; ``models.transformer``'s segmented stack
# runs the routing whole in every cell of a ``model`` group, ahead of its
# entry, and the experts on the cell's own (``distributed.tensor_parallel``).
# Each token group's routing, dispatch, expert products and combine run
# under the ranges (``repro_torch.ranges``) ``moe_route``, ``moe_dispatch``,
# ``moe_experts`` and ``moe_combine``, which a trace reads.


def moe_groups(tokens: int, n_batch: int) -> Tuple[int, bool]:
    """The reference's token group where ``n_batch`` data cells hold
    ``tokens`` tokens each, the cells' rows in order: (the group's size
    over the whole batch, whether a group crosses an edge between cells:
    then the cells gather their router logits and route every group)."""
    total = tokens * n_batch
    group = min(MOE_GROUP, total)
    if total % group:
        group = total
    return group, tokens % group != 0


def group_pieces(lo: int, tokens: int, group: int) -> List[int]:
    """The sizes of the pieces that the tokens ``[lo, lo + tokens)`` of
    the whole batch make when cut at each group's edge (a cell's rows of
    each group it holds a part of)."""
    pieces, t = [], lo
    while t < lo + tokens:
        end = min((t // group + 1) * group, lo + tokens)
        pieces.append(end - t)
        t = end
    return pieces


def router_logits(wts, x, pieces: List[int]):
    """x: (T, d) -> (T, E) router logits, a piece at a time (``pieces``:
    ``group_pieces``), in the activations' dtype."""
    return torch.cat([xg @ wts["router"].to(x.dtype)
                      for xg in x.split(pieces)])


def route_logits(cfg: ModelConfig, logits, group: int):
    """Every group's routing of (T, E) logits: the weights (T, k) in
    float32, expert ids, slots, ``keep`` and the aux loss (the groups'
    mean, times ``router_aux_loss``)."""
    parts = []
    for lg in logits.split(group):
        with ranges.named("moe_route"):
            w, ids, probs = _route(cfg, lg)
            slot, keep = _slots(cfg, ids, capacity(group, cfg))
            parts.append((w, ids, slot, keep,
                          _aux_of(cfg, ids, keep & (w > 0), probs)))
    w, ids, slot, keep = (torch.cat([p[i] for p in parts]) for i in range(4))
    # the groups' aux losses averaged (one group: its own, exactly)
    aux = torch.stack([p[4] for p in parts]).mean()
    return w, ids, slot, keep, aux * cfg.router_aux_loss


def experts_up(cfg: ModelConfig, wts, x, w, ids, slot, keep, lo: int,
               group: int, pieces: List[int]):
    """``experts_apply`` up to the experts' hidden layer, for a cell of a
    decode_flash decode step whose ``x`` (T, d') is its block of the
    features: (the combine weights (T, n, C) of the experts ``wts`` holds,
    from ``lo`` on; each piece's gate and up products side by side,
    (pieces, n, C, 2 ff), partial sums over the feature blocks). The
    pieces are whole groups of ``group`` tokens."""
    dt = x.dtype
    n, C = wts["w_gate"].shape[0], capacity(group, cfg)
    with ranges.named("moe_dispatch"):
        combine = _combine_of(w, ids, slot, keep, lo, n, C)
        xes = [torch.einsum("gec,gd->ecd", (cg > 0).to(dt), xg)
               for cg, xg in zip(combine.split(pieces), x.split(pieces))]
    with ranges.named("moe_experts"):
        return combine, torch.stack([torch.cat(
            [torch.einsum("ecd,edf->ecf", xe, wts[k].to(dt))
             for k in ("w_gate", "w_up")], dim=-1) for xe in xes])


def experts_down(wts, gu, combine, pieces: List[int]):
    """(T, d'): ``experts_apply``'s output from ``experts_up``'s
    ``combine`` and its products ``gu`` summed over the feature blocks:
    ``w_down`` onto the block ``wts`` holds of each token's features."""
    dt = gu.dtype
    gu = gu.reshape(len(pieces), *combine.shape[1:], -1)
    with ranges.named("moe_experts"):
        yes = [torch.einsum("ecf,efd->ecd", F.silu(g) * u,
                            wts["w_down"].to(dt))
               for g, u in (t.chunk(2, dim=-1) for t in gu)]
    with ranges.named("moe_combine"):
        return torch.cat([torch.einsum("gec,ecd->gd", cg.to(dt), ye)
                          for cg, ye in zip(combine.split(pieces), yes)])


def experts_apply(cfg: ModelConfig, wts, x, w, ids, slot, keep, lo: int,
                  group: int, pieces: List[int]):
    """(T, d): the output of the experts ``wts`` holds (from ``lo`` on)
    for the tokens ``x`` (T, d) routed to them, a piece of a group of
    ``group`` at a time (``pieces``: ``group_pieces``); the rest of each
    token's experts add in the other cells of its ``model`` group."""
    dt = x.dtype
    n, C = wts["w_gate"].shape[0], capacity(group, cfg)
    out = []
    for xg, wg, ig, sg, kg in zip(*(t.split(pieces) for t in
                                    (x, w, ids, slot, keep))):
        with ranges.named("moe_dispatch"):
            combine = _combine_of(wg, ig, sg, kg, lo, n, C)
            xe = torch.einsum("gec,gd->ecd", (combine > 0).to(dt), xg)
        with ranges.named("moe_experts"):
            h = F.silu(torch.einsum("ecd,edf->ecf", xe, wts["w_gate"].to(dt)))
            h = h * torch.einsum("ecd,edf->ecf", xe, wts["w_up"].to(dt))
            ye = torch.einsum("ecf,efd->ecd", h, wts["w_down"].to(dt))
        with ranges.named("moe_combine"):
            out.append(torch.einsum("gec,ecd->gd", combine.to(dt), ye))
    return torch.cat(out)
