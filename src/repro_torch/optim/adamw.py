"""AdamW with dtype-configurable moments and an Adafactor-style factored
second moment, the port's copy of ``repro/optim/adamw.py``.

The state mirrors the parameter tree (so its sharding follows the same
logical-axis rules) and is declared through ``TensorSpec`` like the
parameters. ``OptState`` has the reference's name and fields, so a
checkpoint of the trainer's state has the reference's tree structure and
restores in either package. The update runs under ``torch.no_grad()`` on
float32 copies of each leaf, as the reference computes it. Inside a cell
of the partitioned step (``train.step``) it runs on the cell's shards:
``cells`` then gives the whole tree's clip norm and each leaf's means
over whole dims, as GSPMD computes them.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.device import DeviceLike
from repro_torch.models import params as P


class OptState(NamedTuple):
    step: Any  # scalar int32
    mu: Any  # first moment (param-shaped tree)
    nu: Any  # second moment (param-shaped, or factored dict per leaf)
    master: Any = None  # optional fp32 master copy (RunConfig.master_weights)


def _factorable(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 8 and shape[-2] >= 8


def _nu_spec(spec: P.TensorSpec, run: RunConfig):
    if run.factored_second_moment and _factorable(spec.shape):
        row = P.TensorSpec(spec.shape[:-1], spec.logical[:-1], init="zeros",
                           dtype="float32")
        col = P.TensorSpec(spec.shape[:-2] + spec.shape[-1:],
                           spec.logical[:-2] + spec.logical[-1:], init="zeros",
                           dtype="float32")
        return {"_factored_row": row, "_factored_col": col}
    return P.TensorSpec(spec.shape, spec.logical, init="zeros",
                        dtype=run.moment_dtype)


def adamw_init_specs(param_specs, run: RunConfig) -> OptState:
    """Declarative optimizer-state specs mirroring the param specs."""
    mu = P.map_specs(
        lambda s: P.TensorSpec(s.shape, s.logical, init="zeros",
                               dtype=run.moment_dtype), param_specs)
    nu = P.map_specs(lambda s: _nu_spec(s, run), param_specs)
    step = P.TensorSpec((), (), init="zeros", dtype="int32")
    master = None
    if run.master_weights:
        master = P.map_specs(
            lambda s: P.TensorSpec(s.shape, s.logical, init=s.init,
                                   scale=s.scale, dtype="float32"), param_specs)
    return OptState(step=step, mu=mu, nu=nu, master=master)


def state_from_reference(state, device: DeviceLike = None) -> OptState:
    """The reference's ``OptState`` (numpy leaves, factored ``nu`` dicts,
    ``master`` or None) as the port's, leaf for leaf on ``device``."""
    return OptState(*(P.from_reference(f, device) if f is not None else None
                      for f in state))


def cosine_schedule(step: torch.Tensor, base_lr: float, warmup: int = 200,
                    total: int = 10_000) -> torch.Tensor:
    step = step.float()
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    progress = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    return base_lr * warm * 0.5 * (1.0 + torch.cos(math.pi * progress))


B1, B2, EPS = 0.9, 0.95, 1e-8


def _is_factored(nu_leaf) -> bool:
    return isinstance(nu_leaf, dict) and "_factored_row" in nu_leaf


def _mean(t, dim: int, of: int, keepdim: bool = False):
    """The mean of ``t`` over ``dim``, which runs over the leaf's dim
    ``of`` (a cell's shard needs it to find the mesh axes that cut it)."""
    return torch.mean(t, dim=dim, keepdim=keepdim)


def _update_leaf(g, p, mu, nu, lr, wd, step, scale, mean=_mean):
    """One leaf's update; ``scale`` is the clip factor, ``mean`` the mean
    over a dim of the leaf (``_mean``'s signature). The arithmetic is
    the reference's, op for op; temporaries the leaf owns are updated in
    place, so the largest leaf's update holds a few copies of it at once,
    not a dozen (a (8, 4096, 14336) f32 leaf is 1.9 GB)."""
    g32 = (g * scale.to(g.dtype)).float()
    mu_new = mu.float() * B1
    mu_new += (1 - B1) * g32
    if _is_factored(nu):
        row = nu["_factored_row"].float()
        col = nu["_factored_col"].float()
        g2 = torch.square(g32) + 1e-30
        row_new = B2 * row + (1 - B2) * mean(g2, -1, -1)
        col_new = B2 * col + (1 - B2) * mean(g2, -2, -2)
        r = row_new / torch.clamp(mean(row_new, -1, -2, keepdim=True),
                                  min=1e-30)
        v_hat = r[..., None] * col_new[..., None, :]
        nu_new = {"_factored_row": row_new, "_factored_col": col_new}
    else:
        v_hat = nu.float() * B2
        v_hat += (1 - B2) * torch.square(g32)
        nu_new = v_hat.to(nu.dtype)
    del g32
    # bias correction
    t = step.float() + 1.0
    upd = mu_new / (1 - B1 ** t)
    denom = v_hat / (1 - B2 ** t)
    del v_hat
    upd /= denom.sqrt_().add_(EPS)
    del denom
    p32 = p.float()
    if p.dim() >= 2:  # decoupled weight decay on matrices only
        upd += wd * p32
    p_new = (p32 - lr * upd).to(p.dtype)
    return p_new, mu_new.to(mu.dtype), nu_new


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in P.leaves(tree)))


def adamw_update(grads, params, state: OptState, run: RunConfig, cells=None):
    """One AdamW step with global-norm clipping. Returns (params, state,
    stats); every tree is new, nothing is updated in place. ``cells``:
    the trees hold one cell's shards, and ``cells.global_norm(grads)``
    and ``cells.means`` (a tree of ``_mean``-like functions, one a
    parameter) give what the whole leaves would."""
    with torch.no_grad():
        if cells is None:
            gnorm = global_norm(grads)
            means = P.tree_map(lambda _: _mean, grads)
        else:
            gnorm, means = cells.global_norm(grads), cells.means
        if run.grad_clip > 0:
            scale = torch.clamp(run.grad_clip / torch.clamp(gnorm, min=1e-12),
                                max=1.0)
        else:
            scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
        lr = cosine_schedule(state.step, run.learning_rate)
        # master_weights: the optimizer math runs on the fp32 master; the
        # params are re-derived by casting
        src = state.master if state.master is not None else params
        out = P.tree_map(
            lambda g, p, mu, nu, mean: _update_leaf(
                g, p, mu, nu, lr, run.weight_decay, state.step, scale, mean),
            grads, src, state.mu, state.nu, means)
        new_src, mu, nu = (P.tree_map(lambda o: o[i], out) for i in range(3))
        if state.master is not None:
            master = new_src
            new_params = P.tree_map(lambda m, p: m.to(p.dtype), master, params)
        else:
            master, new_params = None, new_src
        stats = {"grad_norm": gnorm, "lr": lr}
        return new_params, OptState(step=state.step + 1, mu=mu, nu=nu,
                                    master=master), stats
