"""Each cell's program: assemble (fn, stand-in args, out_shardings, donate)
per (arch x shape x mesh x ruleset) cell, the counterpart of
``repro/launch/programs.py``, shared by the dry-run and the trainer.

The reference's ``ShapeDtypeStruct`` stand-ins are tensors that hold no
data here (``models.params.fake_tree``): each argument has the shape and
dtype the program takes and nothing behind it. On the meta device (the
default) calling ``fn`` on them traces the card's program (the CUDA
kernels through their operators, whose meta implementations allocate
their outputs and launch nothing) on any host, which is what
``launch.dryrun`` does; ``device="cpu"`` gives fake CPU tensors of a
``FakeTensorMode`` (``op_analysis.analyze`` enters it), on which ``fn``
traces the plain path. A real run materialises tensors of the same
shapes and dtypes.

On a mesh the train program is the partitioned step (``train.step``),
and so are the serve programs under the ``baseline`` and ``moe_a2a``
rules, and the dense and MoE families' under ``decode_flash``
(``serve.step.partitioned``): ``fn`` takes the whole stand-ins and runs
every mesh cell, ``cell`` holds what one device runs, the step's
per-cell function and stand-ins of the first cell's shards, which
``launch.dryrun`` traces alone (``spmd.one_cell``), and ``plan`` its
tensor-parallel plan. The other serve programs on a mesh (the ``seqpar``
rules; the other families under ``decode_flash``) run the model whole
(``cell`` None).

A fake CUDA tensor would name the card itself, but PyTorch built without
CUDA cannot trace one through indexing or autograd (both ask for the CUDA
device guard, which such a build lacks), so the card's path is traced on
meta tensors on every host.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeSpec
from repro_torch.distributed.sharding import MeshSharding, ShardingCtx
from repro_torch.models import lm, params as P
from repro_torch.optim.adamw import adamw_init_specs
from repro_torch.serve.step import (make_decode_step, make_prefill_step,
                                    partitioned)
from repro_torch.train.step import make_train_step


@dataclasses.dataclass
class Program:
    name: str
    fn: Callable
    args: Tuple[Any, ...]  # meta/fake-tensor trees (dry-run); also the
    # template for materialization in real runs
    out_shardings: Any
    donate_argnums: Tuple[int, ...]
    meta: Dict[str, Any]
    # each argument's MeshSharding tree (None without a mesh)
    arg_shardings: Tuple[Any, ...] = ()
    # a partitioned program: (one cell's function, stand-ins of the first
    # cell's shards of the arguments); None otherwise
    cell: Optional[Tuple[Callable, Tuple[Any, ...]]] = None
    # a partitioned program's distributed.tensor_parallel.Plan
    plan: Optional[Any] = None


def _ns_tree(spec_tree, ctx: ShardingCtx):
    """Each spec's ``MeshSharding`` under ``ctx``'s rules; None without a
    mesh."""
    if ctx.mesh is None:
        return None
    return P.map_specs(lambda s: ctx.sharding(s.logical, s.shape), spec_tree)


def _first_cell(args, specs, mesh, mode):
    """Stand-ins of mesh position 0's shards of ``args`` (trees of
    stand-ins) laid out by ``specs`` (the step's spec trees): new tensors
    of the shards' shapes, so that a trace counts a shard's bytes, not
    the whole's."""
    def shard(t, spec):
        if t.dim() == 0:  # a host scalar (the decode position), as it is
            return t
        index = MeshSharding(mesh, spec).devices_indices_map(t.shape)[0]
        shape = [len(range(*sl.indices(d))) for sl, d in zip(index, t.shape)]
        with contextlib.nullcontext() if mode is None else mode:
            return torch.empty(shape, dtype=t.dtype, device=t.device)

    return tuple(P.tree_map(shard, arg, spec)
                 for arg, spec in zip(args, specs))


def _decode_at_host_pos(step):
    """The port's decode step reads the position as a Python int (its
    masks and cache index stay on the host): a 0-d tensor position is
    read once here."""
    @functools.wraps(step)  # its attributes too (a partitioned step's)
    def decode_step(params, cache, batch):
        pos = batch["pos"]
        if isinstance(pos, torch.Tensor):
            batch = {**batch, "pos": int(pos)}
        return step(params, cache, batch)

    return decode_step


def build_program(cfg: ModelConfig, run: RunConfig, shape: ShapeSpec,
                  ctx: ShardingCtx, *, device="meta") -> Program:
    """The cell's program over stand-ins on ``device``: meta tensors (the
    card's path, the default) or fake tensors of a new ``FakeTensorMode``
    on another device (its path)."""
    mode = None if torch.device(device).type == "meta" else FakeTensorMode()
    pspecs = lm.param_specs(cfg)
    batch_specs = lm.input_specs(cfg, shape)
    meta = {
        "arch": cfg.name, "shape": shape.name, "kind": shape.kind,
        "params": P.count_params(pspecs),
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
    }

    def fake(specs, dtype):
        return P.fake_tree(specs, ctx, dtype, device=device, mode=mode)

    if shape.kind == "train":
        ospecs = adamw_init_specs(pspecs, run)
        (params, ps), (opt, os_), (batch, bs) = (
            fake(pspecs, run.param_dtype), fake(ospecs, "float32"),
            fake(batch_specs, "int32"))
        fn = make_train_step(cfg, run, ctx, shape.global_batch)
        out_shardings = (_ns_tree(pspecs, ctx), _ns_tree(ospecs, ctx), None)
        args = (params, opt, batch)
        cell = None if ctx.mesh is None else (
            fn.cell, _first_cell(args, fn.in_specs(batch), ctx.mesh, mode))
        return Program("train_step", fn, args, out_shardings, (0, 1), meta,
                       (ps, os_, bs), cell, getattr(fn, "plan", None))

    # Serving: bf16 weights.
    params, ps = fake(pspecs, run.compute_dtype)
    batch, bs = fake(batch_specs, "int32")
    cache_specs = lm.cache_specs(cfg, shape)
    out_shardings = (None, _ns_tree(cache_specs, ctx))
    if shape.kind == "prefill":
        fn = make_prefill_step(cfg, run, ctx)
        name, args, shardings, donate = ("prefill_step", (params, batch),
                                         (ps, bs), ())
    else:
        assert shape.kind == "decode"
        cache, cs = fake(cache_specs, run.compute_dtype)
        fn = _decode_at_host_pos(make_decode_step(cfg, run, ctx))
        name, args, shardings, donate = ("serve_step", (params, cache, batch),
                                         (ps, cs, bs), (1,))
    cell = plan = None
    if partitioned(cfg, run, ctx):  # one spmd.shard_map over the mesh
        cell = (fn.cell_at(*args),
                _first_cell(args, fn.in_specs(*args), ctx.mesh, mode))
        plan = fn.plan_at(*args)
    return Program(name, fn, args, out_shardings, donate, meta, shardings,
                   cell, plan)


def input_specs(cfg: ModelConfig, shape: ShapeSpec, ctx: ShardingCtx):
    """Meta-tensor stand-ins for every model input of this cell (shardable,
    no device allocation), and their shardings (None without a mesh)."""
    return P.fake_tree(lm.input_specs(cfg, shape), ctx, "int32")
