#!/usr/bin/env python3
"""The first-moment check of ``chip_smoke.py``'s ``train_mesh_olmoe``
phase, and its power, on the card.

    python3 moment_probe.py

olmoe-1b-7b at the phase's size (4 layers, 8 x 2048, 4 steps, the
bundle's RunConfig, bf16 compute) and at its f32 hold's (2 layers,
8 x 1024, 2 steps, f32 compute), on a virtual (2, 2) mesh of the card
with the dense dispatch and with the a2a (ruleset ``moe_a2a``), each
against its unpartitioned counterpart as the phase runs it
(``chip_smoke.state_copy``, ``mesh_state_gaps``); then the same
partitioned run with a fault planted in its backward: an entry
(``tensor_parallel.Tape.enter``) whose backward passes each cell's
partial gradient on without the ``model`` psum. Prints a JSON line a
run: the parameters' gap (largest element over max(1, max|p|)), the
first moments' (each leaf's gap norm over its norm, the phase's check
against ``MESH_MOMENT_TOL``; and its largest element over the leaf's
largest), the three leaves with the largest norm gap, and whether the
check passes. The sound runs must pass it and the planted ones fail it.
Needs a GPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import subprocess
import sys

import chip_smoke as C


def leaf_gaps(t, want, names) -> list:
    """(norm gap, largest-element gap, leaf) of each first-moment leaf."""
    from repro_torch.models import params as P

    out = []
    for got, w, name in zip(P.leaves(t.opt_state.mu), want["mu"], names,
                            strict=True):
        d = got.gather() - w
        out.append(((d.norm() / w.norm().clamp(min=1e-30)).item(),
                    (d.abs().max() / w.abs().max().clamp(min=1e-30)).item(),
                    name))
    return out


def main() -> int:
    sys.path.insert(0, str(C.SRC))
    import torch

    from repro_torch.configs import registry
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.launch.mesh import make_elastic_mesh
    from repro_torch.models import lm, moe
    from repro_torch.models import params as P
    from repro_torch.train.trainer import Trainer

    if not torch.cuda.is_available():
        print("moment_probe.py needs a GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", torch.cuda.current_device())
    bundle = registry.get("olmoe-1b-7b")
    mesh = make_elastic_mesh(2, 2, devices=[dev] * 4)
    gb = C.TRAIN_SHAPE["global_batch"]
    cut = C.TRAIN_MESH_OLMOE["f32_hold"]
    sizes = {"bf16": (C.TRAIN_MESH_OLMOE["layers"], C.TRAIN_SHAPE["seq"],
                      C.TRAIN_MESH_OLMOE["warmup"]
                      + C.TRAIN_MESH_OLMOE["steps"], "bfloat16"),
             "f32_hold": (cut["layers"], cut["seq"], cut["steps"],
                          "float32")}
    dropped = []
    plain = C.plain_a2a_moe(4, dropped)

    @contextlib.contextmanager
    def plain_a2a():
        orig = moe.moe_apply
        moe.moe_apply = lambda cfg_, ctx, w, x, impl="dense": plain(
            cfg_, ctx, w, x)
        try:
            yield
        finally:
            moe.moe_apply = orig

    @contextlib.contextmanager
    def planted():
        orig = tp.Tape.enter
        tp.Tape.enter = lambda self, x, axis=tp.AXIS: self._collective(
            x, tp._leaf(x), lambda g: g)
        try:
            yield
        finally:
            tp.Tape.enter = orig

    def freed():
        gc.collect()
        torch.cuda.empty_cache()

    for size, (layers, seq, steps, dtype) in sizes.items():
        cfg = dataclasses.replace(bundle.model, num_layers=layers)
        names = list(P.leaves(tp.paths(lm.param_specs(cfg))))
        for impl, ruleset, plain_ctx in (
                ("dense", "baseline", contextlib.nullcontext),
                ("a2a", "moe_a2a", plain_a2a)):
            run = bundle.run.replace(moe_impl=impl, compute_dtype=dtype)

            def trained(m, **kw):
                t = Trainer(cfg, run, global_batch=gb, seq_len=seq, seed=0,
                            mesh=m, data=C.OneBatch(SyntheticLM(
                                cfg, gb, seq, seed=0)), device=dev, **kw)
                t.train(steps)
                return t

            freed()
            with plain_ctx():
                t = trained(None)
            want = C.state_copy(t)
            del t
            freed()
            for fault, ctx in (("none", contextlib.nullcontext),
                               ("entry_without_psum", planted)):
                with ctx():
                    t = trained(mesh, ruleset=ruleset)
                gaps = C.mesh_state_gaps(t, want)
                worst = sorted(leaf_gaps(t, want, names), reverse=True)[:3]
                del t
                freed()
                print(json.dumps({
                    "size": size, "layers": layers, "seq": seq,
                    "steps": steps, "compute_dtype": dtype, "impl": impl,
                    "fault": fault, "param_max_rel_err": gaps["params"],
                    "moment_rel_err": gaps["mu"],
                    "moment_max_rel_err": gaps["mu_max"],
                    "worst_leaves": worst, "bound": C.MESH_MOMENT_TOL,
                    "check_passes": C.state_held(gaps)}), flush=True)
            del want
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(json.dumps({"card": smi.stdout.strip()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
