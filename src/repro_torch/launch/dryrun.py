"""Dry-run: trace every (arch x shape x mesh) cell of the port's programs
on tensors that hold no data, prove memory fit on an H100, and extract
roofline terms. The counterpart of ``repro/launch/dryrun.py``, which
lowers and compiles each cell on 512 fake host devices for a TPU v5e.

The port has no compiler: ``launch.programs`` builds each cell's program
over meta tensors, on which the model code takes the card's path (each
CUDA kernel through its operator, which allocates its outputs and
launches nothing), and ``launch.op_analysis`` runs it once and reads the
dispatched operators: FLOPs, dot bytes, collectives, kernel calls and the
peak of live tensor storages. Nothing is allocated on any device and no
GPU is needed.

Mesh kinds:

  * ``card``: one H100 running the program whole, as the port runs it;
  * ``single`` (16 x 16 ``data``, ``model``) and ``multi`` (2 x 16 x 16
    ``pod``, ``data``, ``model``), the reference's meshes. Per-device
    argument bytes are the largest shard of each leaf under the ruleset
    (``MeshSharding.devices_indices_map``). Activations and temporaries
    are the traced peak of one data cell's share of the batch at full
    model width, on a mesh of that cell's ``model`` axis: the port does
    not partition activations over ``model``, so the term is an upper
    bound. The collectives are the ones the port issues over ``model`` (the
    a2a MoE's all-to-alls, ``flash_decode``'s reductions); a program that
    issues one over the data axes (``flash_decode``'s gather of its output
    under ``decode_flash``) is refused, since one data cell's trace cannot
    count it. The gathers and reduce-scatters that GSPMD inserts into the
    reference's programs have no counterpart, because the port does not
    partition its programs.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
        --shape train_4k --mesh card --smoke
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all  # every cell
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch.configs import SHAPES_BY_NAME, registry
from repro_torch.configs.base import ModelConfig, RunConfig, ShapeSpec
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.launch import op_analysis
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.programs import Program, build_program
from repro_torch.launch.serve import pad_cache
from repro_torch.models import lm, params as P
from repro_torch.serve.step import make_decode_step

# One H100 SXM at 700 W (NVIDIA's data sheet): dense bf16 tensor-core rate,
# HBM rate and size, NVLink each way.
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12  # bytes/s
HBM_BYTES = 80e9
NVLINK_BW = 450e9  # bytes/s each way

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
NOT_ISSUED = ("the all-gathers and reduce-scatters that GSPMD inserts into "
              "the reference's partitioned programs: the port does not "
              "partition its programs (ShardingCtx.constrain is the "
              "identity)")


def _meta_mesh(shape, axes):
    """A virtual mesh of meta devices (no device behind any cell)."""
    n = math.prod(shape)
    return make_mesh(shape, axes, [torch.device("meta")] * n)


def argument_bytes(prog: Program) -> int:
    """Bytes of the program's arguments on one device: each leaf whole,
    or, with a mesh, its largest shard under its ``MeshSharding``."""
    total = 0
    for args, shardings in zip(prog.args, prog.arg_shardings):
        if shardings is None:
            total += sum(t.numel() * t.element_size()
                         for t in P.leaves(args))
            continue
        for t, sh in zip(P.leaves(args), P.leaves(shardings)):
            shape = tuple(t.shape)
            cells = sh.devices_indices_map(shape).values()
            total += t.element_size() * max(
                math.prod(len(range(*s.indices(d))) for s, d in zip(idx, shape))
                for idx in cells)
    return total


def local_shape(cfg: ModelConfig, shape: ShapeSpec, ctx: ShardingCtx
                ) -> ShapeSpec:
    """The shape of one data cell's share of the batch: the global batch
    cut as the ruleset cuts the inputs' ``batch`` axis."""
    spec = lm.input_specs(cfg, shape)["tokens"]
    idx = ctx.sharding(spec.logical, spec.shape).devices_indices_map(
        spec.shape)[0]
    b = len(range(*idx[0].indices(shape.global_batch)))
    return ShapeSpec(shape.name, shape.kind, shape.seq_len, b)


def generate_program(cfg: ModelConfig, run: RunConfig, batch: int,
                     prompt: int, gen: int) -> Program:
    """The serve launcher's ``generate`` on the card's path, as a program
    over meta tensors: a prefill of ``batch`` x ``prompt``, the KV cache
    padded for ``gen`` tokens, then two greedy decode steps (the second
    one steady), each holding the previous cache until it returns, as
    ``generate`` does."""
    ctx = ShardingCtx.null()
    pre = build_program(cfg, run, ShapeSpec("prefill", "prefill", prompt,
                                            batch), ctx)
    decode = make_decode_step(cfg, run, ctx)

    def generate(params, inputs):
        tok, cache = pre.fn(params, inputs)
        cache = pad_cache(cfg, cache, gen)
        for i in range(2):
            tok, cache = decode(params, cache, {"tokens": tok[:, None],
                                                "pos": prompt + i})
        return tok

    meta = dict(pre.meta, shape=f"generate_{batch}x{prompt}+{gen}",
                kind="generate")
    return Program("generate", generate, pre.args, None, (), meta,
                   pre.arg_shardings)


def roofline(summary: op_analysis.Summary) -> Dict[str, float]:
    return {"compute_s": summary.dot_flops / PEAK_FLOPS,
            "memory_s": summary.dot_bytes / HBM_BW,
            "collective_s": summary.collective_wire_bytes / NVLINK_BW}


def run_cell(arch: str, shape_name: str, mesh_kind: str, ruleset: str,
             out_dir: str, smoke: bool = False,
             run_overrides: Optional[dict] = None) -> dict:
    bundle = registry.get(arch)
    shape = SHAPES_BY_NAME[shape_name]
    cell_id = f"{arch}__{shape_name}__{mesh_kind}__{ruleset}"
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
              "ruleset": ruleset, "ok": False}

    reason = bundle.skip_reason(shape_name)
    if reason:
        result.update(skipped=True, reason=reason, ok=True)
        _write(out_dir, cell_id, result)
        print(f"SKIP {cell_id}: {reason}")
        return result

    cfg = bundle.smoke if smoke else bundle.model
    run = bundle.run_for(shape_name).replace(sharding_rules=ruleset)
    if run_overrides:
        run = run.replace(**run_overrides)
        result["run_overrides"] = dict(run_overrides)

    t0 = time.time()
    try:
        if mesh_kind == "card":
            n_chips, ctx = 1, ShardingCtx.null()
            prog = trace_prog = build_program(cfg, run, shape, ctx)
            cell_shape = shape
        else:
            grid, axes = MESHES[mesh_kind]
            n_chips = math.prod(grid)
            ctx = ShardingCtx.for_mesh(_meta_mesh(grid, axes), ruleset)
            prog = build_program(cfg, run, shape, ctx)
            # one data cell: the model axis alone, at its share of the batch
            cell_grid = tuple(n if a == "model" else 1
                              for n, a in zip(grid, axes))
            cell_ctx = ShardingCtx.for_mesh(_meta_mesh(cell_grid, axes),
                                            ruleset)
            cell_shape = local_shape(cfg, shape, ctx)
            trace_prog = build_program(cfg, run, cell_shape, cell_ctx)
        summary = op_analysis.analyze(trace_prog.fn, *trace_prog.args)
        if mesh_kind != "card" and any(
                d["one_cell_groups"] for d in summary.per_op.values()):
            # a collective over an axis that the one-data-cell trace cuts
            # to one cell (decode_flash's gather over the data axes): its
            # bytes on the whole mesh are not in this trace
            raise RuntimeError(
                f"the program issues collectives over the data axes "
                f"({summary.per_op}), which the trace of one data cell "
                f"runs over one cell: not counted, so the cell is refused")
        trace_s = time.time() - t0
        arg_b = argument_bytes(prog)
        act_b = summary.peak_bytes - argument_bytes(dataclasses.replace(
            trace_prog, arg_shardings=(None,) * len(trace_prog.args)))
        live_b = arg_b + act_b
        terms = roofline(summary)
        result.update(
            ok=True, n_chips=n_chips, program=prog.name, meta=prog.meta,
            traced_batch=cell_shape.global_batch, trace_s=round(trace_s, 2),
            per_device_bytes={
                "arguments": arg_b, "activations_and_temps": act_b,
                "live_peak_est": live_b,
                "activations_upper_bound": mesh_kind != "card"},
            fits_80gb=bool(live_b <= HBM_BYTES),
            ops={"dot_flops": summary.dot_flops,
                 "dot_bytes": summary.dot_bytes,
                 "collective_wire_bytes": summary.collective_wire_bytes,
                 "collective_op_bytes": summary.collective_op_bytes,
                 "per_op": summary.per_op,
                 "kernel_calls": summary.kernel_calls},
            collectives_not_issued=None if mesh_kind == "card" else NOT_ISSUED,
            hardware={"card": "H100 SXM, 700 W", "peak_bf16_flops": PEAK_FLOPS,
                      "hbm_bytes_per_s": HBM_BW, "hbm_bytes": HBM_BYTES,
                      "nvlink_bytes_per_s": NVLINK_BW},
            roofline_terms_s=terms,
            dominant=max(terms, key=terms.get),
        )
        print(f"OK {cell_id}: chips={n_chips} "
              f"live={live_b / 2**30:.2f}GiB/dev "
              f"compute={terms['compute_s'] * 1e3:.2f}ms "
              f"memory={terms['memory_s'] * 1e3:.2f}ms "
              f"collective={terms['collective_s'] * 1e3:.2f}ms "
              f"kernels={summary.kernel_calls} [trace {trace_s:.0f}s]")
    except Exception as e:  # noqa: BLE001 — record the failure, it's a bug
        result.update(ok=False, error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
        print(f"FAIL {cell_id}: {type(e).__name__}: {str(e)[:400]}")
    _write(out_dir, cell_id, result)
    return result


def _write(out_dir: str, cell_id: str, result: dict) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, cell_id + ".json"), "w") as f:
        json.dump(result, f, indent=1, default=float)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="card",
                    choices=["card", "single", "multi", "both"])
    ap.add_argument("--ruleset", default="baseline")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CI fast path)")
    ap.add_argument("--all", action="store_true",
                    help="every cell, every mesh kind")
    ap.add_argument("--microbatch", type=int, default=-1,
                    help="override RunConfig.microbatch_per_data_shard")
    ap.add_argument("--scan-group", type=int, default=-1)
    ap.add_argument("--remat", default="")
    ap.add_argument("--moe-impl", default="")
    args = ap.parse_args()
    overrides = {}
    if args.microbatch >= 0:
        overrides["microbatch_per_data_shard"] = args.microbatch
    if args.scan_group >= 0:
        overrides["scan_group"] = args.scan_group
    if args.remat:
        overrides["remat"] = args.remat
    if args.moe_impl:
        overrides["moe_impl"] = args.moe_impl

    archs = registry.arch_ids() if args.arch == "all" or args.all else [args.arch]
    shapes = list(SHAPES_BY_NAME) if args.shape == "all" or args.all else [args.shape]
    meshes = (["card", "single", "multi"] if args.all else
              ["single", "multi"] if args.mesh == "both" else [args.mesh])

    failures = 0
    for a in archs:
        for s in shapes:
            for m in meshes:
                r = run_cell(a, s, m, args.ruleset, args.out, smoke=args.smoke,
                             run_overrides=overrides)
                failures += 0 if r.get("ok") else 1
    if failures:
        raise SystemExit(f"{failures} dry-run cells FAILED")


if __name__ == "__main__":
    main()
