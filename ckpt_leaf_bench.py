#!/usr/bin/env python3
"""Save and restore one bf16 checkpoint leaf through a bento mount and
print JSON lines: the port on ``--device`` (CUDA when unset; it raises
without one), or, as a separate mode, the JAX reference on the host's
CPU.

    PYTHONPATH=src python ckpt_leaf_bench.py --rows 4096 --cols 14336 \
        --grid 2x2 --targets 1x2,4x2
    PYTHONPATH=src python ckpt_leaf_bench.py --device cpu
    PYTHONPATH=src JAX_PLATFORMS=cpu python ckpt_leaf_bench.py \
        --package repro --rows 16384 --cols 4096 --grid 2x1

The leaf is random bits from ``--seed``, cut into a (data, model) shard
grid (``--grid``) on a bento mount of ``--n-blocks`` blocks with the
default buffer cache (4096 blocks, 16 MiB) and the default pipeline
depth. In the port the leaf lies on ``--device``, the mount's shard
checksums and restore hashes run there (the CUDA blockhash kernel on a
card), and the leaf is restored whole and onto each ``--targets`` mesh
(a virtual mesh of that one device). ``--package repro`` runs the
reference on the JAX CPU backend, where its kernel binding hashes with
crc32 on the host, and restores whole only. Each line names where it ran and gives seconds,
MB/s, the restore's metered host peak and its fetch/assemble split, or
the error a restore raised (the reference's ``bread_many`` EIO on leaves
over the cache).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def _grid(text: str):
    d, m = (int(x) for x in text.split("x"))
    return d, m


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=["repro", "repro_torch"],
                    default="repro_torch",
                    help="repro: the JAX reference, on the host's CPU")
    ap.add_argument("--device", default=None,
                    help="port only: torch device (default: cuda)")
    ap.add_argument("--rows", type=int, default=4096)
    ap.add_argument("--cols", type=int, default=14336)
    ap.add_argument("--grid", default="2x2")
    ap.add_argument("--targets", default="1x2,4x2",
                    help="port only: meshes to restore onto")
    ap.add_argument("--n-blocks", type=int, default=65536)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    bits = np.random.default_rng(args.seed).integers(
        0, 1 << 16, size=(args.rows, args.cols), dtype=np.uint16)
    mb = bits.nbytes / 1e6
    d, m = _grid(args.grid)
    axes = {"data": d, "model": m}
    sync = lambda: None  # noqa: E731
    if args.package == "repro":
        if args.device is not None:
            ap.error("--device is the port's; the reference runs on the CPU")
        import ml_dtypes

        from repro import checkpoint as ckpt
        from repro.distributed.resharding import ShardGrid
        from repro.fs.mounts import make_mount

        mf = make_mount("bento", n_blocks=args.n_blocks)
        tree = {"w": bits.view(ml_dtypes.bfloat16)}
        targets = {"whole": None}
        load_kw = {}
        where = "cpu (the JAX reference)"
    else:
        import torch

        from repro_torch import checkpoint as ckpt
        from repro_torch.device import resolve_device
        from repro_torch.distributed.resharding import ShardGrid
        from repro_torch.distributed.sharding import MeshSharding
        from repro_torch.fs.mounts import make_mount
        from repro_torch.launch.mesh import make_elastic_mesh

        dev = resolve_device(args.device)
        if dev.type == "cuda":
            sync = lambda: torch.cuda.synchronize(dev)  # noqa: E731
        mf = make_mount("bento", n_blocks=args.n_blocks, device=dev)
        tree = {"w": torch.from_numpy(bits.view(np.int16)).view(
            torch.bfloat16).to(dev)}
        targets = {"whole": None}
        for t in filter(None, args.targets.split(",")):
            td, tm = _grid(t)
            mesh = make_elastic_mesh(td, tm, devices=[dev] * (td * tm))
            targets[t] = {"w": MeshSharding(mesh, ("data", "model"))}
        load_kw = {"device": dev}
        where = str(dev)
        if dev.type == "cuda":
            where += f" ({torch.cuda.get_device_name(dev)})"
    ks = mf.services
    grid = {"w": ShardGrid.from_spec(bits.shape, ("data", "model"), axes)}
    t0 = time.perf_counter()
    ckpt.save(mf.view, "/ck", tree, step=0, checksum=ks.checksum,
              shardings=grid)
    save_s = time.perf_counter() - t0
    print(json.dumps({"package": args.package, "device": where,
                      "shape": list(bits.shape),
                      "grid": args.grid, "mb": mb, "save_s": save_s,
                      "save_mb_per_s": mb / save_s}), flush=True)
    for name, target in targets.items():
        stats = {}
        t0 = time.perf_counter()
        try:
            ckpt.load(mf.view, "/ck", tree, checksum=ks.checksum,
                      checksum_batch=ks.checksum_batch, sharding_tree=target,
                      stats=stats, **load_kw)
            sync()
        except Exception as e:  # noqa: BLE001 — reported, not hidden
            print(json.dumps({"restore": name, "error": f"{type(e).__name__}"
                              f": {e}"}), flush=True)
            continue
        dt = time.perf_counter() - t0
        print(json.dumps({
            "restore": name, "restore_s": dt, "restore_mb_per_s": mb / dt,
            "host_peak_bytes": stats["leaves"][0]["peak_bytes"],
            "fetch_s": stats["pipeline"]["fetch_s"],
            "assemble_s": stats["pipeline"]["assemble_s"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
