"""Training step: gradient accumulation over microbatches, clipping, AdamW.

The counterpart of ``repro/train/step.py``. ``make_train_step`` closes
over the configs and the sharding context; the returned function runs on
the device of the tensors it is given and returns new parameter and
optimizer-state trees (nothing is updated in place). Gradients are taken
with autograd with respect to the parameters cast once to the compute
dtype, and accumulated in ``run.grad_accum_dtype``.

With a mesh the step is partitioned over it, as the reference's
``jax.jit`` under GSPMD partitions it: parameters and optimizer state
arrive as ``sharding.MeshArray``s, each mesh cell holding its FSDP x
model shard of every leaf, and the step is one ``spmd.shard_map`` over
the whole mesh. Each cell casts its parameter shards to the compute
dtype and all-gathers each leaf over the mesh axes its spec cuts, but
``model`` for a model-local leaf (``distributed.tensor_parallel``: the
attention's heads, the MLP's columns and rows, the experts and the
vocabulary, rwkv6's WKV heads and channel-mix columns, zamba2's Mamba2
``w_in`` and ``w_out``, where their cut falls on such units; the cell
gathers ``w_in`` over ``model`` inside its tape), and runs the model on
its share of the batch (cut over the ``batch`` rule's axes; in
microbatches, each cell's microbatch i is its block of the global
microbatch i, as in the reference) tensor-parallel over ``model`` on a
``tensor_parallel.Tape`` (``lm.loss_segments``), whose backward runs the
collectives' transposes in the cell's code. Each cell keeps of each
gradient the shard it owns, averaged over the cells that cut the batch (a
reduce-scatter in the accumulation dtype): a model-local leaf's
gradient is its own block already; the cells of one ``model`` group see
the same batch rows, so over the other axes that do not cut the batch
a gathered leaf's gradient is sliced, not summed. AdamW then updates
each cell's shards (``optim.adamw``'s ``cells``).
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.distributed import spmd
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import MeshSharding, ShardingCtx
from repro_torch.launch.mesh import mesh_axis_sizes
from repro_torch.models import lm, params as P
from repro_torch.optim.adamw import OptState, adamw_init_specs, adamw_update


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

    def grad_fn(params_c, batch, plan=None):
        """(loss, metrics), grads of ``loss_fn`` at the cast params; with
        a segmented ``plan``, of ``lm.loss_segments`` on a tape."""
        if plan is not None and plan.segmented:
            return _taped_grads(cfg, run, ctx, plan, params_c, batch)
        flat = list(P.leaves(params_c))
        with torch.enable_grad():
            loss, metrics = lm.loss_fn(cfg, run, ctx, params_c, batch)
            grads = torch.autograd.grad(loss, flat)
        it = iter(grads)
        return (loss.detach(), metrics), P.tree_map(lambda _: next(it),
                                                    params_c)

    def cast(p):
        if p.is_floating_point() and p.dtype != compute_dt:
            p = p.to(compute_dt)
        return p

    def _cast_params(params):
        # Mixed precision: one cast of the fp32 master BEFORE the
        # microbatch loop, so the cast is hoisted out of the accumulation.
        # Each cast leaf is a leaf of the autograd graph.
        return P.tree_map(lambda p: as_leaf(cast(p)), params)

    def loss_and_grads(params_c, batch, plan=None):
        """((loss, metrics), grads) of ``batch`` in ``n_accum``
        microbatches, the gradients averaged in the accumulation dtype."""
        if n_accum == 1:
            return grad_fn(params_c, batch, plan)
        micro = {k: v.reshape((n_accum, v.shape[0] // n_accum)
                              + v.shape[1:])
                 for k, v in batch.items() if v.dim() >= 1}
        grads = P.tree_map(lambda p: torch.zeros(p.shape, dtype=accum_dt,
                                                 device=p.device), params_c)
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
        # the step's own accumulator is summed into in place: one
        # accum-dtype copy of the gradients, not two at each add
        for i in range(n_accum):
            (loss, _), g = grad_fn(params_c, {k: v[i]
                                              for k, v in micro.items()},
                                   plan)
            P.tree_map(lambda a, b: a.add_(b.to(accum_dt)), grads, g)
            del g
            loss_sum = loss_sum + loss.float()
        P.tree_map(lambda g: g.div_(n_accum), grads)
        loss = loss_sum / n_accum
        return (loss, {"loss": loss}), grads

    if ctx.mesh is not None:
        return _partitioned(cfg, run, ctx, global_batch, n_accum, cast,
                            loss_and_grads)

    def train_step(params, opt_state: OptState, batch: Dict):
        params_c = _cast_params(params)
        (loss, metrics), grads = loss_and_grads(params_c, batch)
        del params_c
        params, opt_state, stats = adamw_update(grads, params, opt_state, run)
        metrics = dict(metrics)
        metrics.update(stats)
        metrics = {k: v.detach().float() for k, v in metrics.items()}
        return params, opt_state, metrics

    return train_step


def _taped_grads(cfg, run, ctx, plan, params_c, batch):
    """(loss, metrics), grads of one cell's ``lm.loss_segments`` on a
    ``tensor_parallel.Tape`` (remat per segment under block remat)."""
    cell = tp.Cell(tp.Tape(remat=run.remat == "block"), plan)
    with torch.enable_grad():
        loss, metrics = lm.loss_segments(cfg, run, ctx, cell, params_c,
                                         batch)
        cell.tape.backward(loss)

    def grad(p):
        g, p.grad = p.grad, None
        return torch.zeros_like(p) if g is None else g

    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), P.tree_map(grad, params_c)


def as_leaf(p: torch.Tensor) -> torch.Tensor:
    """``p`` as a leaf of a new autograd graph."""
    return p.detach().requires_grad_(p.is_floating_point())


def _names(entry):
    return () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))


def _padded(spec, ndim: int) -> list:
    return list(spec) + [None] * (ndim - len(spec))


class CellLayout:
    """One cell's view of the partitioned state inside the step: the
    mesh axes that cut each leaf, the collectives that gather a
    parameter and reduce its gradient, and what ``adamw_update`` needs of
    the whole tree (``global_norm``, ``means``)."""

    def __init__(self, mesh, tensor_specs, param_specs, batch_axes):
        self.mesh = mesh
        self.sizes = mesh_axis_sizes(mesh)
        self.param_specs = param_specs
        self.batch_axes = tuple(a for a in batch_axes if self.sizes[a] > 1)
        self.dp = 1
        for a in self.batch_axes:
            self.dp *= self.sizes[a]
        self.means = P.tree_map(
            lambda ts, spec: self._mean_of(_padded(spec, len(ts.shape))),
            tensor_specs, param_specs)

    def _cuts(self, entry) -> int:
        n = 1
        for a in _names(entry):
            n *= self.sizes[a]
        return n

    def gather(self, x: torch.Tensor, spec, local: bool = False
               ) -> torch.Tensor:
        """The leaf from this cell's shard: an all-gather over each dim's
        axes; for a model-local leaf, over all but ``model`` (the cell
        computes with its own ``model`` shard)."""
        for dim, entry in enumerate(_local_spec(spec, local)):
            if self._cuts(entry) > 1:
                x = spmd.all_gather(x, entry, axis=dim)
        return x

    def reduce(self, g: torch.Tensor, spec, local: bool = False
               ) -> torch.Tensor:
        """This cell's shard of the gradient averaged over the cells that
        cut the batch, from its gradient of the leaf ``gather`` gave it:
        the dims cut only by other axes are sliced here (the cells that
        share this cell's batch rows hold the same gradient), the rest
        reduce-scattered (or all-reduced, where no batch axis cuts the
        leaf); a model-local leaf's ``model`` dim is the cell's own
        already."""
        spec = _local_spec(spec, local)
        index = MeshSharding(self.mesh, spec).devices_indices_map(
            g.shape)[spmd.position()]
        by_batch = [bool(set(_names(e)) & set(self.batch_axes))
                    for e in _padded(spec, g.dim())]
        local = tuple(slice(None) if b else sl
                      for sl, b in zip(index, by_batch))
        rest = tuple(sl if b else slice(None)
                     for sl, b in zip(index, by_batch))
        x = g[local]
        if not self.batch_axes:
            return x.clone()
        return spmd.psum_block(x, self.batch_axes, rest) / self.dp

    def batch_mean(self, x: torch.Tensor) -> torch.Tensor:
        """A per-cell mean over its batch rows as the mean over the
        whole batch."""
        if not self.batch_axes:
            return x
        return spmd.psum(x, self.batch_axes) / self.dp

    def _owns(self, spec) -> bool:
        """Whether this cell counts its block of a leaf laid out by
        ``spec``: the first of the cells that hold copies of it."""
        used = {a for e in spec for a in _names(e)}
        return all(spmd.axis_index(a) == 0 for a in self.sizes
                   if a not in used)

    def global_norm(self, grads) -> torch.Tensor:
        """The whole tree's norm: each block's squares counted once, in
        the cell that owns it, summed over the mesh."""
        squares = []
        P.tree_map(lambda g, s: squares.append(torch.sum(torch.square(
            g.float()))) if self._owns(s) else None, grads, self.param_specs)
        total = sum(squares) if squares else torch.zeros(
            (), dtype=torch.float32, device=next(P.leaves(grads)).device)
        if self.mesh.devices.size > 1:
            total = spmd.psum(total, tuple(self.mesh.axis_names))
        return torch.sqrt(total)

    def _mean_of(self, entries):
        """``optim.adamw._mean`` for a leaf whose dims mesh axes cut as
        ``entries`` says: over a cut dim, the cell's partial sums summed
        over those axes (as GSPMD computes a mean over a sharded dim)."""
        def mean(t, dim: int, of: int, keepdim: bool = False):
            entry = entries[of]
            n = self._cuts(entry)
            if n == 1:
                return torch.mean(t, dim=dim, keepdim=keepdim)
            part = torch.sum(t, dim=dim, keepdim=keepdim)
            return spmd.psum(part, entry) / (t.shape[dim] * n)

        return mean


def _local_spec(spec, local: bool) -> tuple:
    """``spec`` without its ``model`` cut, for a model-local leaf."""
    if not local:
        return tuple(spec)
    return tuple(None if e == tp.AXIS else e for e in spec)


def _partitioned(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx,
                 global_batch: int, n_accum: int, cast, loss_and_grads):
    """The step over ``ctx.mesh``; see the module's docstring. The
    returned function takes ``MeshArray`` (or whole) parameter and state
    trees and a whole batch, and returns ``MeshArray`` trees and the
    metrics as whole scalars. ``.cell`` is the function one cell runs on
    its shards (``spmd.one_cell`` traces it), ``.in_specs(batch)`` its
    arguments' spec trees, ``.plan`` its ``tensor_parallel.Plan``. Each
    leaf's gather runs under its dotted path as ``spmd.labelled``."""
    mesh = ctx.mesh
    accum_dt = P.torch_dtype(run.grad_accum_dtype)
    pspecs = lm.param_specs(cfg)
    param_specs = P.map_specs(lambda s: ctx.spec(s.logical, s.shape), pspecs)
    opt_specs = P.map_specs(lambda s: ctx.spec(s.logical, s.shape),
                            adamw_init_specs(pspecs, run))
    _check_factored(pspecs, param_specs, opt_specs)
    batch_spec = ctx.spec(("batch",), (global_batch,))
    layout = CellLayout(mesh, pspecs, param_specs,
                        _names(batch_spec[0]) if batch_spec else ())
    plan = tp.plan_for(cfg, pspecs, param_specs, layout.sizes,
                       layout.batch_axes)
    local = tp.local_leaves(plan, pspecs)
    names = tp.paths(pspecs)

    def gathered(p, s, loc, name):
        with spmd.labelled(name):
            return as_leaf(layout.gather(cast(p), s, loc))

    def cell(params, opt_state: OptState, batch: Dict):
        params_c = P.tree_map(gathered, params, param_specs, local, names)
        (loss, metrics), grads = loss_and_grads(params_c, batch, plan)
        del params_c
        grads = P.tree_map(lambda g, s, loc: layout.reduce(g.to(accum_dt), s,
                                                           loc),
                           grads, param_specs, local)
        metrics = {k: layout.batch_mean(v.detach()) for k, v in
                   metrics.items()}
        params, opt_state, stats = adamw_update(grads, params, opt_state, run,
                                                cells=layout)
        metrics.update(stats)
        return params, opt_state, {k: v.float() for k, v in metrics.items()}

    def in_specs(batch):
        """The spec trees of the step's arguments, for ``batch``."""
        return (param_specs, opt_specs,
                {k: batch_spec if v.dim() else () for k, v in batch.items()})

    def train_step(params, opt_state: OptState, batch: Dict):
        if n_accum > 1 and layout.dp > 1:
            batch = _by_microbatch(batch, n_accum, layout.dp)
        step = spmd.shard_map(cell, mesh, in_specs=in_specs(batch),
                              out_specs=(param_specs, opt_specs, ()),
                              keep=True)
        params, opt_state, metrics = step(params, opt_state, batch)
        # each metric is the same scalar in every cell
        return params, opt_state, {k: v.shards[0] for k, v in metrics.items()}

    train_step.cell = cell
    train_step.in_specs = in_specs
    train_step.plan = plan
    return train_step


def _by_microbatch(batch: Dict, n_accum: int, dp: int) -> Dict:
    """The batch's rows reordered so that data cell c's microbatch i is
    block c of global microbatch i, as in the reference, whose microbatch
    i is rows ``[i B / n_accum, (i + 1) B / n_accum)`` of the whole batch
    cut over the data cells (each cell cuts its microbatches out of its
    own rows). The loss is a mean over rows, so only the rows that a MoE
    token group routes together, and the a2a's per-cell routing, see the
    order."""
    def rows(v):
        return v.reshape((n_accum, dp, v.shape[0] // (n_accum * dp))
                         + v.shape[1:]).transpose(0, 1).reshape(v.shape)

    return {k: rows(v) if v.dim() else v for k, v in batch.items()}


def _trim(entries) -> tuple:
    entries = list(entries)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def _check_factored(pspecs, param_specs, opt_specs: OptState) -> None:
    """A factored second moment's row and column statistics are computed
    on the parameter's shard: their own specs must cut as the
    parameter's dims do (they do for every arch and ruleset; a layout
    that differs raises)."""
    def check(ts, spec, nu):
        if not isinstance(nu, dict):
            return
        full = _padded(spec, len(ts.shape))
        if (nu["_factored_row"], nu["_factored_col"]) != (
                _trim(full[:-1]), _trim(full[:-2] + full[-1:])):
            raise NotImplementedError(
                f"factored second moment laid out as {nu} against the "
                f"parameter's {spec}")

    P.tree_map(check, pspecs, param_specs, opt_specs.nu)


def make_eval_step(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx):
    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = lm.loss_fn(cfg, run, ctx, params, batch)
        return {k: v.float() for k, v in metrics.items()}

    return eval_step
