#!/usr/bin/env python3
"""The blocks live at the CUDA allocator's peak of one program of the port,
with the C++ and Python frames that allocated them, on the card.

    PYTHONPATH=src python peak_blocks.py attention olmoe_prefill

``attention``: one forward and recompute backward of the flash kernel's
autograd Function at the VLM's cross attention training microbatch (4,
2048, 6404, 32 over 8 heads of 128, non-causal, bf16) and at smollm's
self attention (4, 2048, 9 over 3 heads of 64, causal). ``olmoe_prefill``:
one prefill of olmoe-1b-7b at serve_olmoe's shape (4 x 1024), seeded
random weights. Each prints the peak above what was allocated before,
the number of live blocks at that moment, and the largest of them with
the frames of their allocation (``torch.cuda.memory._record_memory_history``
with C++ stacks, replayed). This is how ``launch.op_analysis._card_scratch``
was found: what PyTorch's CUDA kernels allocate out of the dispatcher's
sight. Needs a GPU; prints JSON lines.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KEEP = ("at::native", "autograd", "repro_torch", "Backward")


def live_at_peak(fn, top: int = 8) -> dict:
    """Runs ``fn()`` under the allocator's history and replays it: the
    peak, and the largest blocks live at it with their frames."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.memory._record_memory_history(max_entries=1_000_000,
                                             stacks="all")
    try:
        fn()
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    live, total, best, best_live = {}, 0, 0, {}
    for ev in snap["device_traces"][0]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
            total += ev["size"]
            if total > best:
                best, best_live = total, dict(live)
        elif ev["action"] == "free_completed" and ev["addr"] in live:
            total -= live.pop(ev["addr"])["size"]
    rows = [{"size": e["size"],
             "frames": [f"{Path(f['filename']).name}:{f['line']}:"
                        f"{f['name'][:90]}" for f in e.get("frames", [])
                        if any(k in f["name"] or k in f["filename"]
                               for k in KEEP)][:8]}
            for e in sorted(best_live.values(), key=lambda e: -e["size"])[:top]]
    return {"peak_above_base": torch.cuda.max_memory_allocated() - base,
            "replay_peak": best, "live_blocks": len(best_live), "top": rows}


def attention() -> dict:
    import torch

    from repro_torch.kernels.flash_attention import ops as fa

    out = {}
    for name, (B, Sq, Skv, Hq, Hkv, D, causal) in {
            "vlm_cross": (4, 2048, 6404, 32, 8, 128, False),
            "smollm_self": (4, 2048, 2048, 9, 3, 64, True)}.items():
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn(B, S, H, D, device="cuda", generator=g)
                   .to(torch.bfloat16).requires_grad_()
                   for S, H in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv)))

        def step():
            o = fa.flash_attention(q, k, v, causal=causal)
            torch.autograd.grad(o.float().sum(), [q, k, v])

        res = live_at_peak(step)
        res["scores_bytes"] = B * Hq * Sq * Skv * 4
        res["scores_sized_live"] = sum(r["size"] >= res["scores_bytes"]
                                       for r in res["top"])
        out[name] = res
    return out


def olmoe_prefill() -> dict:
    import torch

    from repro_torch.configs import registry
    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.models import lm, params as P
    from repro_torch.serve.step import make_prefill_step

    b = registry.get("olmoe-1b-7b")
    cfg, run = b.model, b.run
    g = torch.Generator(device="cuda").manual_seed(0)
    prm = P.materialize(lm.param_specs(cfg), g, "cuda",
                        dtype=run.compute_dtype)
    tokens = torch.randint(0, cfg.vocab_size, (4, 1024), generator=g,
                           device="cuda", dtype=torch.int32)
    prefill = make_prefill_step(cfg, run, ShardingCtx.null())
    prefill(prm, {"tokens": tokens})  # warm
    return {"olmoe_prefill": live_at_peak(
        lambda: prefill(prm, {"tokens": tokens}), top=4)}


def main(argv) -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("peak_blocks.py runs from the root of a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: peak_blocks.py reads the card's allocator",
              file=sys.stderr)
        return 1
    from repro_torch.kernels._build import build_all

    build_all(("flash_attention",))
    probes = {"attention": attention, "olmoe_prefill": olmoe_prefill}
    for name in argv or list(probes):
        for key, res in probes[name]().items():
            print(json.dumps({"probe": key, **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
