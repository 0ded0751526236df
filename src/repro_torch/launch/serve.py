"""Serving launcher: batched prefill + greedy decode loop.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama-3.2-vision-11b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
        --smoke --device cpu --batch 4 --prompt-len 32 --gen 16

Parameters and prompt tokens are drawn on the device from a generator
seeded with 0, as the reference draws them from ``PRNGKey(0)`` (the numbers
differ); the VLM's image embeddings and whisper's frame embeddings are the
reference's stub, 0.02 everywhere, in bfloat16. ``--device`` defaults to
cuda and fails without a GPU.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig, RunConfig, ShapeSpec
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import MeshArray, ShardingCtx, resharded
from repro_torch.models import lm, params as P
from repro_torch.serve.step import (laid_out, make_decode_step,
                                    make_prefill_step, partitioned)


def pad_cache(cfg: ModelConfig, cache, gen: int,
              ctx: Optional[ShardingCtx] = None):
    """Room for ``gen`` generated tokens in the prompt-sized KV cache that
    prefill returns, as ``repro/launch/serve.py`` pads it: the sequence
    axis (third from last) of every self-attention k and v grows by ``gen``
    zero slots. A sliding-window ring buffer keeps its size, the cross
    attention's KV (the VLM's image KV, whisper's encoder KV) its length,
    and a recurrent state (rwkv6's, the Mamba2 layers') has no sequence
    axis. A partitioned serve's cache (``MeshArray`` leaves, laid out by
    the rules of ``ctx``, the serve's context: ``serve.step.partitioned``;
    the baseline rules where it is None) comes back laid out by the
    decode program's specs under those rules on the cache's own mesh,
    each cell's shard of the self k and v (zamba2's shared block's too)
    made from the prefill's shards that overlap it
    (``sharding.resharded``): the padded length moves the sequence blocks'
    edges; the cross KV's and the recurrent states' shards stay as they
    are."""
    def pad_seq(x):  # (..., S, H, D) -> (..., S + gen, H, D)
        return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, gen))

    # where the self k and v sit in the cache tree
    key = {"vlm": "self", "hybrid": "attn"}.get(cfg.family)
    if cfg.sliding_window > 0 or cfg.family == "ssm" or (
            key is not None and key not in cache):
        return cache
    kv = cache[key] if key else cache
    k = kv["k"]
    if isinstance(k, MeshArray):
        ctx = ShardingCtx(k.sharding.mesh, (ctx or ShardingCtx.null()).rules)
        specs = lm.cache_specs(cfg, ShapeSpec("decode", "decode",
                                              k.shape[-3] + gen, k.shape[-4]))
        specs = specs[key] if key else specs

        def grow(name):
            spec = specs[name]
            return resharded(kv[name], ctx.sharding(spec.logical, spec.shape),
                             spec.shape)
    else:
        def grow(name):
            return pad_seq(kv[name])

    grown = {name: grow(name) for name in ("k", "v")}
    if cfg.family == "vlm":
        return {"self": grown, "cross": cache["cross"]}
    if cfg.family == "hybrid":
        return {"mamba": cache["mamba"], "attn": grown}
    return {**grown, **{name: cache[name] for name in ("ck", "cv")
                        if name in cache}}


def stub_embeds(cfg: ModelConfig, batch: int,
                device: torch.device) -> Dict[str, torch.Tensor]:
    """The reference serve's stub frontend: image embeddings (VLM) or
    frame embeddings (audio), 0.02 everywhere, in bfloat16; none for the
    other families."""
    shapes = {"vlm": ("image_embeds", cfg.num_image_tokens),
              "audio": ("frame_embeds", cfg.encoder_seq)}
    if cfg.family not in shapes:
        return {}
    name, n = shapes[cfg.family]
    return {name: torch.full((batch, n, cfg.d_model), 0.02,
                             dtype=torch.bfloat16, device=device)}


def generate(cfg: ModelConfig, run: RunConfig, prm,
             batch: Dict[str, torch.Tensor], gen: int,
             ctx: Optional[ShardingCtx] = None
             ) -> Tuple[np.ndarray, Dict[str, float]]:
    """Prefill ``batch`` (its ``tokens`` (B, S), and the VLM's
    ``image_embeds`` or whisper's ``frame_embeds``), then decode greedily
    until ``gen`` tokens are out. Returns the generated ids (B, gen) and
    the host-clock times: each step ends when its tokens are on the host.
    ``ctx`` (``ShardingCtx.null()`` by default): with a mesh the serve
    steps are ``serve.step``'s for it, partitioned over it under the
    ``baseline`` and ``moe_a2a`` rules, and the dense and MoE families'
    under ``decode_flash`` (``serve.step.partitioned``), whose weights
    are laid out over it first where they are whole tensors; the VLM's
    and whisper's embeddings are cut over the data axes inside the
    steps."""
    ctx = ShardingCtx.null() if ctx is None else ctx
    prefill = make_prefill_step(cfg, run, ctx)
    decode = make_decode_step(cfg, run, ctx)
    if partitioned(cfg, run, ctx):
        prm = laid_out(cfg, ctx, prm)
    prompt_len = batch["tokens"].shape[1]

    t0 = time.perf_counter()
    tok, cache = prefill(prm, batch)
    cache = pad_cache(cfg, cache, gen, ctx)
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
    batch = {"tokens": tokens, **stub_embeds(cfg, args.batch, dev)}
    gen, times = generate(cfg, run, prm, batch, args.gen)
    print(f"arch={cfg.name} batch={args.batch} device={dev} "
          f"prefill={times['prefill_s']*1e3:.0f}ms "
          f"decode={times['decode_s_per_token']*1e3:.1f}ms/tok")
    print("generated token ids (first row):", gen[0][:16].tolist())


if __name__ == "__main__":
    main()
