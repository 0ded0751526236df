"""Batched serving on the PyTorch/CUDA port: prefill a batch of prompts,
then run a greedy continuous decode loop with per-step latency stats —
across model families (dense / SSM / hybrid take different cache paths
through the same API). The counterpart of ``examples/serve_batched.py``.

    PYTHONPATH=src python examples/serve_batched_torch.py --arch rwkv6-7b
    PYTHONPATH=src python examples/serve_batched_torch.py --arch smollm-135m --gen 32
    PYTHONPATH=src python examples/serve_batched_torch.py --device cpu

The reduced (smoke) config of the arch, parameters and prompts drawn from
a generator seeded with 0 on the device (the reference draws them from
``PRNGKey(0)``: the numbers differ). Each step's time ends when its
tokens are on the host.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.launch.serve import pad_cache, stub_embeds
from repro_torch.models import lm, params as P
from repro_torch.serve.step import make_decode_step, make_prefill_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    bundle = registry.get(args.arch)
    cfg, run = bundle.smoke, bundle.run
    ctx = ShardingCtx.null()
    g = torch.Generator(device=dev).manual_seed(0)
    params = P.materialize(lm.param_specs(cfg), g, dev,
                           dtype=run.compute_dtype)
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (args.batch, args.prompt_len),
                                     generator=g, device=dev,
                                     dtype=torch.int32),
             **stub_embeds(cfg, args.batch, dev)}

    prefill = make_prefill_step(cfg, run, ctx)
    decode = make_decode_step(cfg, run, ctx)

    t0 = time.perf_counter()
    tok, cache = prefill(params, batch)
    outs = [tok.cpu().numpy()]
    t_prefill = time.perf_counter() - t0

    # transformer-family caches need room for generated tokens (ssm/hybrid
    # states are fixed-size; SWA ring buffers stay window-sized)
    cache = pad_cache(cfg, cache, args.gen)

    lat = []
    for i in range(args.gen - 1):
        t1 = time.perf_counter()
        tok, cache = decode(params, cache, {"tokens": tok[:, None],
                                            "pos": args.prompt_len + i})
        outs.append(tok.cpu().numpy())
        lat.append(time.perf_counter() - t1)
    ids = np.stack(outs, axis=1)

    lat_ms = np.array(lat[1:]) * 1e3  # the first step warms up
    print(f"{cfg.name}: batch={args.batch} device={dev} "
          f"prefill={t_prefill*1e3:.0f}ms "
          f"decode p50={np.percentile(lat_ms, 50):.1f}ms "
          f"p99={np.percentile(lat_ms, 99):.1f}ms/token "
          f"throughput={args.batch / np.mean(lat_ms) * 1e3:,.0f} tok/s")
    print("generated ids:", list(ids.shape))
    return {"arch": cfg.name, "ids": ids}


if __name__ == "__main__":
    main()
