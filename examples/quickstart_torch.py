"""Quickstart on the PyTorch/CUDA port: the whole system in ~70 lines.

Mount a journaled Bento file system, train a small LM whose checkpoints
flow through it, hot-upgrade the file system mid-run (paper §4.8), and
serve a few greedy tokens from the trained weights: the counterpart of
``examples/quickstart.py``, through ``repro_torch`` alone.

    PYTHONPATH=src python examples/quickstart_torch.py                # the GPU
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu   # the host

On the GPU every journal commit is checksummed by the CUDA blockhash
kernel and every prefill's attention runs the CUDA flash kernel;
``--device cpu`` runs their plain versions. ``main`` returns what it
printed, for callers that check it.
"""

import argparse

import torch

from repro_torch.configs import registry
from repro_torch.core.upgrade import upgrade
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.fs.ext4like import Ext4LikeFileSystem
from repro_torch.fs.mounts import make_mount
from repro_torch.launch.serve import pad_cache
from repro_torch.serve.step import make_decode_step, make_prefill_step
from repro_torch.train.trainer import Trainer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    bundle = registry.get("smollm-135m")
    cfg = bundle.smoke  # reduced config: runs on the host in seconds
    run = bundle.run.replace(microbatch_per_data_shard=0, learning_rate=1e-3)

    # 1. storage: journaled xv6 behind the Bento typed boundary
    mf = make_mount("bento", n_blocks=32768, device=dev)
    gen0 = mf.mount.generation
    print(f"mounted {mf.mount.name} (generation {gen0}) on {dev}")

    # 2. train with checkpoints through the fs
    t = Trainer(cfg, run, global_batch=8, seq_len=64,
                ckpt_view=mf.view, ckpt_every=5, seed=0, device=dev)
    t.train(15)
    losses = [m["loss"] for m in t.metrics_log]
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f} over {len(losses)} steps")
    ckpts = mf.view.listdir("/ckpt")
    print("checkpoints:", ckpts)

    # 3. hot-upgrade the mounted fs (xv6 -> ext4like) without unmounting
    stats = upgrade(mf.mount, Ext4LikeFileSystem(),
                    migrate=lambda s, o, n: {**s, "dirindex": {}})
    gen1 = mf.mount.generation
    print(f"online upgrade: {stats['total_s']*1e3:.1f} ms pause, "
          f"generation {gen1}")
    assert mf.view.listdir("/ckpt")  # data survives

    # 4. serve greedily from the trained weights: a 16-token prompt, the
    # KV cache padded for 8 tokens, 7 decode steps
    ctx = ShardingCtx.null()
    prefill = make_prefill_step(cfg, run, ctx)
    decode = make_decode_step(cfg, run, ctx)
    prompt = torch.ones((1, 16), dtype=torch.int32, device=dev)
    tok, cache = prefill(t.params, {"tokens": prompt})
    cache = pad_cache(cfg, cache, 8)
    out = [int(tok[0])]
    for i in range(7):
        tok, cache = decode(t.params, cache,
                            {"tokens": tok[:, None], "pos": 16 + i})
        out.append(int(tok[0]))
    print("generated:", out)
    mf.close()
    print("OK")
    return {"generations": (gen0, gen1), "losses": losses,
            "checkpoints": ckpts, "generated": out}


if __name__ == "__main__":
    main()
