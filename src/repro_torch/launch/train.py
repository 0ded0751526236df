"""Training launcher CLI.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --smoke --device cpu --steps 50 --batch 8 --seq 128 --ckpt-every 10

``--device`` defaults to cuda and fails without a GPU. ``--data-mesh N``
trains partitioned over a ``(N, 1)`` ("data", "model") mesh of this
host's first N CUDA devices, as the reference's does over its devices,
and raises where there are fewer; ``--virtual-mesh N`` trains over a
``(N, 1)`` mesh of ``--device`` N times (one card, or the CPU, standing
in for every cell). With ``--ckpt-every`` the checkpoints go to a port
``bento`` mount whose journal commits hash on the same device. The CUDA allocator grows its
segments in place (``device.configure_allocator``) unless
``PYTORCH_CUDA_ALLOC_CONF`` says otherwise.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

from repro_torch.configs import registry
from repro_torch.device import configure_allocator, resolve_device
from repro_torch.fs.mounts import make_mount
from repro_torch.launch.mesh import make_elastic_mesh, make_host_mesh
from repro_torch.train.trainer import Trainer


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--data-mesh", type=int, default=0,
                    help=">0: train partitioned over that many CUDA devices "
                         "(a (N, 1) data x model mesh)")
    ap.add_argument("--virtual-mesh", type=int, default=0,
                    help=">0: train partitioned over a (N, 1) mesh of "
                         "--device N times")
    ap.add_argument("--ruleset", default="baseline")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    configure_allocator()
    dev = resolve_device(args.device)
    bundle = registry.get(args.arch)
    cfg = bundle.smoke if args.smoke else bundle.model
    run = bundle.run.replace(microbatch_per_data_shard=0)
    if args.data_mesh and args.virtual_mesh:
        ap.error("--data-mesh and --virtual-mesh exclude each other")
    mesh = None
    if args.data_mesh:
        mesh = make_host_mesh(args.data_mesh, 1)
    elif args.virtual_mesh:
        mesh = make_elastic_mesh(args.virtual_mesh, 1,
                                 devices=[dev] * args.virtual_mesh)

    mf = None
    ckpt_view = None
    if args.ckpt_every:
        mf = make_mount("bento", n_blocks=65536, device=dev)
        ckpt_view = mf.view

    t = Trainer(cfg, run, global_batch=args.batch, seq_len=args.seq,
                mesh=mesh, ruleset=args.ruleset, ckpt_view=ckpt_view,
                ckpt_every=args.ckpt_every, device=dev)
    t0 = time.time()
    t.train(args.steps)
    wall = time.time() - t0
    first, last = t.metrics_log[0], t.metrics_log[-1]
    print(f"arch={cfg.name} device={dev} steps={args.steps} wall={wall:.1f}s "
          f"loss {first['loss']:.4f} -> {last['loss']:.4f} "
          f"({args.steps * args.batch * args.seq / wall:.0f} tok/s)")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(t.metrics_log, f, indent=1)
    if mf is not None:
        mf.close()


if __name__ == "__main__":
    main()
