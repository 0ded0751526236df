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

A fake CUDA tensor would name the card itself, but PyTorch built without
CUDA cannot trace one through indexing or autograd (both ask for the CUDA
device guard, which such a build lacks), so the card's path is traced on
meta tensors on every host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeSpec
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.models import lm, params as P
from repro_torch.optim.adamw import adamw_init_specs
from repro_torch.serve.step import make_decode_step, make_prefill_step
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


def _ns_tree(spec_tree, ctx: ShardingCtx):
    """Each spec's ``MeshSharding`` under ``ctx``'s rules; None without a
    mesh."""
    if ctx.mesh is None:
        return None
    return P.map_specs(lambda s: ctx.sharding(s.logical, s.shape), spec_tree)


def _decode_at_host_pos(step):
    """The port's decode step reads the position as a Python int (its
    masks and cache index stay on the host): a 0-d tensor position is
    read once here."""
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
        return Program("train_step", fn, (params, opt, batch), out_shardings,
                       (0, 1), meta, (ps, os_, bs))

    # Serving: bf16 weights.
    params, ps = fake(pspecs, run.compute_dtype)
    batch, bs = fake(batch_specs, "int32")
    cache_specs = lm.cache_specs(cfg, shape)
    out_shardings = (None, _ns_tree(cache_specs, ctx))
    if shape.kind == "prefill":
        fn = make_prefill_step(cfg, run, ctx)
        return Program("prefill_step", fn, (params, batch), out_shardings,
                       (), meta, (ps, bs))

    assert shape.kind == "decode"
    cache, cs = fake(cache_specs, run.compute_dtype)
    fn = _decode_at_host_pos(make_decode_step(cfg, run, ctx))
    return Program("serve_step", fn, (params, cache, batch), out_shardings,
                   (1,), meta, (ps, cs, bs))


def input_specs(cfg: ModelConfig, shape: ShapeSpec, ctx: ShardingCtx):
    """Meta-tensor stand-ins for every model input of this cell (shardable,
    no device allocation), and their shardings (None without a mesh)."""
    return P.fake_tree(lm.input_specs(cfg, shape), ctx, "int32")
