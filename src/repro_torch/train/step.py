"""Training step: gradient accumulation over microbatches, clipping, AdamW.

The counterpart of ``repro/train/step.py``. ``make_train_step`` closes
over the configs and the sharding context; the returned function runs on
the device of the tensors it is given and returns new parameter and
optimizer-state trees (nothing is updated in place). Gradients are taken
with autograd with respect to the parameters cast once to the compute
dtype, and accumulated in ``run.grad_accum_dtype``.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.models import lm, params as P
from repro_torch.optim.adamw import OptState, adamw_update


def data_parallel_size(ctx: ShardingCtx) -> int:
    if ctx.mesh is None:
        return 1
    sizes = dict(zip(ctx.mesh.axis_names, ctx.mesh.devices.shape))
    dp = sizes.get("data", 1)
    if "pod" in sizes:
        dp *= sizes["pod"]
    return dp


def num_accum_steps(run: RunConfig, ctx: ShardingCtx, global_batch: int) -> int:
    if run.microbatch_per_data_shard <= 0:
        return 1
    dp = data_parallel_size(ctx)
    micro_global = run.microbatch_per_data_shard * dp
    if global_batch % micro_global != 0:
        return 1
    return max(1, global_batch // micro_global)


def make_train_step(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx,
                    global_batch: int):
    n_accum = num_accum_steps(run, ctx, global_batch)
    accum_dt = P.torch_dtype(run.grad_accum_dtype)
    compute_dt = P.torch_dtype(run.compute_dtype)

    def grad_fn(params_c, batch):
        """(loss, metrics), grads of ``loss_fn`` at the cast params."""
        flat = list(P.leaves(params_c))
        with torch.enable_grad():
            loss, metrics = lm.loss_fn(cfg, run, ctx, params_c, batch)
            grads = torch.autograd.grad(loss, flat)
        it = iter(grads)
        return (loss.detach(), metrics), P.tree_map(lambda _: next(it),
                                                    params_c)

    def _cast_params(params):
        # Mixed precision: one cast of the fp32 master BEFORE the
        # microbatch loop, so the cast is hoisted out of the accumulation.
        # Each cast leaf is a leaf of the autograd graph.
        def cast(p):
            if p.is_floating_point() and p.dtype != compute_dt:
                p = p.to(compute_dt)
            return p.detach().requires_grad_(p.is_floating_point())
        return P.tree_map(cast, params)

    def train_step(params, opt_state: OptState, batch: Dict):
        params_c = _cast_params(params)
        if n_accum == 1:
            (loss, metrics), grads = grad_fn(params_c, batch)
        else:
            micro = {k: v.reshape((n_accum, v.shape[0] // n_accum)
                                  + v.shape[1:])
                     for k, v in batch.items() if v.dim() >= 1}
            grads = P.tree_map(lambda p: torch.zeros(p.shape, dtype=accum_dt,
                                                     device=p.device), params)
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=batch["tokens"].device)
            # the step's own accumulator is summed into in place: one
            # accum-dtype copy of the gradients, not two at each add
            for i in range(n_accum):
                (loss, _), g = grad_fn(params_c, {k: v[i]
                                                  for k, v in micro.items()})
                P.tree_map(lambda a, b: a.add_(b.to(accum_dt)), grads, g)
                del g
                loss_sum = loss_sum + loss.float()
            P.tree_map(lambda g: g.div_(n_accum), grads)
            loss = loss_sum / n_accum
            metrics = {"loss": loss}
        del params_c
        params, opt_state, stats = adamw_update(grads, params, opt_state, run)
        metrics = dict(metrics)
        metrics.update(stats)
        metrics = {k: v.detach().float() for k, v in metrics.items()}
        return params, opt_state, metrics

    return train_step


def make_eval_step(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx):
    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = lm.loss_fn(cfg, run, ctx, params, batch)
        return {k: v.float() for k, v in metrics.items()}

    return eval_step
