"""End-to-end training on the PyTorch/CUDA port: train a ~100M-class
model (SmolLM-135M smoke or full config) for a few hundred steps with
FS-backed data shards, failure injection, checkpoint/restart, and
deterministic resume. The counterpart of ``examples/train_small_lm.py``.

    PYTHONPATH=src python examples/train_small_lm_torch.py --steps 200
    PYTHONPATH=src python examples/train_small_lm_torch.py --steps 50 --full  # real 135M
    PYTHONPATH=src python examples/train_small_lm_torch.py --device cpu --steps 17 --fail-at 7

The data shards, the checkpoints and their journal commits live on a
Bento mount whose checksums run on ``--device`` (on the GPU: the CUDA
blockhash kernel).
"""

import argparse
import time

from repro_torch.configs import registry
from repro_torch.data.pipeline import FsShardReader, SyntheticLM, write_shards
from repro_torch.device import resolve_device
from repro_torch.fs.mounts import make_mount
from repro_torch.train.trainer import Trainer, WorkerFailure


class FsDataset:
    """Adapter: serve training batches from Bento-FS shards."""

    def __init__(self, view, cfg, global_batch, seq_len, n_shards=8):
        base = SyntheticLM(cfg, global_batch, seq_len, seed=1234)
        write_shards(view, base, n_shards=n_shards)
        self.reader = FsShardReader(view)

    def batch(self, step: int):
        return self.reader.read(step)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="train the real 135M config")
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="inject a node failure at this step")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    bundle = registry.get("smollm-135m")
    cfg = bundle.model if args.full else bundle.smoke
    run = bundle.run.replace(microbatch_per_data_shard=0, learning_rate=6e-4)

    mf = make_mount("bento", n_blocks=65536, device=dev)
    data = FsDataset(mf.view, cfg, args.batch, args.seq)

    armed = {"on": args.fail_at >= 0}

    def failure_hook(step):
        if armed["on"] and step == args.fail_at:
            armed["on"] = False
            raise WorkerFailure(f"injected node loss at step {step}")

    t = Trainer(cfg, run, global_batch=args.batch, seq_len=args.seq,
                ckpt_view=mf.view, ckpt_every=max(args.steps // 10, 1),
                failure_hook=failure_hook if args.fail_at >= 0 else None,
                data=data, device=dev)
    t0 = time.time()
    t.train(args.steps)
    wall = time.time() - t0
    ls = [m["loss"] for m in t.metrics_log]
    toks = args.steps * args.batch * args.seq
    print(f"{cfg.name}: {args.steps} steps in {wall:.1f}s "
          f"({toks/wall:,.0f} tok/s on {dev}) loss {ls[0]:.3f} -> {ls[-1]:.3f} "
          f"recoveries={t.recoveries} shard_retries={data.reader.retries}")
    assert ls[-1] < ls[0], "training must reduce loss"
    mf.close()
    return {"losses": ls, "recoveries": t.recoveries,
            "shard_retries": data.reader.retries}


if __name__ == "__main__":
    main()
