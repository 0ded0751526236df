"""Serving launcher: batched prefill + greedy decode loop.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
        --smoke --device cpu --batch 4 --prompt-len 32 --gen 16

Parameters and prompt tokens are drawn on the device from a generator
seeded with 0, as the reference draws them from ``PRNGKey(0)`` (the numbers
differ). ``--device`` defaults to cuda and fails without a GPU.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.models import lm, params as P
from repro_torch.serve.step import make_decode_step, make_prefill_step


def pad_cache(cfg: ModelConfig, cache, gen: int):
    """Room for ``gen`` generated tokens in the prompt-sized KV cache that
    prefill returns, as ``repro/launch/serve.py`` pads it: the sequence
    axis (third from last) of every k and v grows by ``gen`` zero slots.
    A sliding-window ring buffer keeps its size, and a recurrent state
    (rwkv6's, the Mamba2 layers') has no sequence axis."""
    if cfg.sliding_window > 0 or cfg.family != "hybrid" or "attn" not in cache:
        return cache

    def pad_seq(x):  # (..., S, H, D) -> (..., S + gen, H, D)
        return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, gen))

    return {"mamba": cache["mamba"],
            "attn": {"k": pad_seq(cache["attn"]["k"]),
                     "v": pad_seq(cache["attn"]["v"])}}


def generate(cfg: ModelConfig, run: RunConfig, prm, tokens: torch.Tensor,
             gen: int) -> Tuple[np.ndarray, Dict[str, float]]:
    """Prefill ``tokens`` (B, S), then decode greedily until ``gen`` tokens
    are out. Returns the generated ids (B, gen) and the host-clock times:
    each step ends when its tokens are on the host."""
    ctx = ShardingCtx.null()
    prefill = make_prefill_step(cfg, run, ctx)
    decode = make_decode_step(cfg, run, ctx)
    prompt_len = tokens.shape[1]

    t0 = time.perf_counter()
    tok, cache = prefill(prm, {"tokens": tokens})
    cache = pad_cache(cfg, cache, gen)
    out_tokens = [tok.cpu().numpy()]
    t_prefill = time.perf_counter() - t0

    t0 = time.perf_counter()
    for i in range(gen - 1):
        # a Python int: nothing of the step's masks lands on another device
        pos = prompt_len + i
        tok, cache = decode(prm, cache, {"tokens": tok[:, None], "pos": pos})
        out_tokens.append(tok.cpu().numpy())
    t_decode = time.perf_counter() - t0
    return np.stack(out_tokens, axis=1), {
        "prefill_s": t_prefill,
        "decode_s_per_token": t_decode / max(gen - 1, 1)}


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    bundle = registry.get(args.arch)
    cfg = bundle.smoke if args.smoke else bundle.model
    run = bundle.run

    g = torch.Generator(device=dev).manual_seed(0)
    prm = P.materialize(lm.param_specs(cfg), g, dev, dtype=run.compute_dtype)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=g, device=dev, dtype=torch.int32)
    gen, times = generate(cfg, run, prm, tokens, args.gen)
    print(f"arch={cfg.name} batch={args.batch} device={dev} "
          f"prefill={times['prefill_s']*1e3:.0f}ms "
          f"decode={times['decode_s_per_token']*1e3:.1f}ms/tok")
    print("generated token ids (first row):", gen[0][:16].tolist())


if __name__ == "__main__":
    main()
