"""The port's named ranges (``repro_torch.ranges``) and its CUDA allocator
setting, on the CPU.

A range is a profiler range, and, while a ``timed`` block that names it is
open, one call with its span (the host clock here, CUDA events on the
card). The card's profiled serves and training steps read the recompute
backwards' and the MoE layer's ranges this way and hold their calls:
one a backward of a kernel's Function, and one a token group in each
forward of a MoE layer, as many forwards as the layer's attention has.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import device as D  # noqa: E402
from repro_torch import ranges  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.distributed.sharding import ShardingCtx  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import attention, lm, moe  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from test_torch_dense import plain_forward_as_kernel  # noqa: E402,F401

MOE_RANGES = ("moe_route", "moe_dispatch", "moe_experts", "moe_combine")
CPU = torch.device("cpu")


def test_a_range_is_a_profiler_range_timed_only_inside_timed():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with ranges.named("outside"):
            pass
        with ranges.timed(["a"], "cpu") as got:
            for _ in range(3):
                with ranges.named("a"):
                    torch.ones(64).sum()
            with ranges.named("b"):
                pass
        with ranges.named("a"):
            pass
    counts = {e.key: e.count for e in prof.key_averages()}
    assert (counts["outside"], counts["a"], counts["b"]) == (1, 4, 1)
    assert set(got) == {"a"} and got["a"]["calls"] == 3
    assert got["a"]["span_us"] > 0


def test_count_calls_counts_while_open_and_puts_the_functions_back():
    import types
    mod = types.SimpleNamespace(f=lambda x: x + 1, g=lambda x: 2 * x)
    real_f = mod.f
    with ranges.count_calls(mod, ("f", "g")) as calls:
        assert (mod.f(1), mod.f(2), mod.g(3)) == (2, 3, 6)
        assert calls == {"f": 2, "g": 1}
        calls.update(f=0)
        mod.f(0)
        assert calls == {"f": 1, "g": 1}
    assert mod.f is real_f
    mod.f(0)
    assert calls == {"f": 1, "g": 1}
    with pytest.raises(KeyError):
        with ranges.count_calls(mod, ("f",)):
            raise KeyError("inside")
    assert mod.f is real_f


def test_nested_timed_blocks_each_see_their_own_names():
    with ranges.timed(["a", "b"], "cpu") as outer:
        with ranges.named("a"):
            pass
        with ranges.timed(["b"], "cpu") as inner:
            with ranges.named("a"):
                with ranges.named("b"):
                    pass
    assert {k: v["calls"] for k, v in outer.items()} == {"a": 2, "b": 1}
    assert {k: v["calls"] for k, v in inner.items()} == {"b": 1}
    assert ranges._open == []


def test_a_failing_range_still_closes():
    with ranges.timed(["a"], "cpu") as got:
        with pytest.raises(ValueError):
            with ranges.named("a"):
                raise ValueError("inside")
    assert got["a"]["calls"] == 1


def test_the_recompute_range_counts_the_backwards_alone(
        plain_forward_as_kernel):
    rng = np.random.default_rng(0)
    args = [torch.from_numpy(rng.standard_normal((1, 32, 2, 16),
                                                 dtype=np.float32))
            for _ in range(3)]
    with ranges.timed(["flash_recompute_bwd"], "cpu") as got:
        for _ in range(2):  # two forwards, then one backward
            leaves = [a.clone().requires_grad_() for a in args]
            loss = fa_ops.flash_attention(*leaves, use_kernel=True).sum()
        loss.backward()
    assert len(plain_forward_as_kernel) == 2  # the backward launches none
    assert got["flash_recompute_bwd"]["calls"] == 1


def _olmoe(seed=0):
    cfg = registry.get("olmoe-1b-7b").smoke
    run = registry.get("olmoe-1b-7b").run.replace(compute_dtype="float32")
    prm = P.materialize(lm.param_specs(cfg),
                        torch.Generator().manual_seed(seed), CPU)
    return cfg, run, prm


@pytest.mark.parametrize("group", [4096, 16])
def test_moe_ranges_one_call_a_group_in_each_layer_forward(
        group, plain_forward_as_kernel, monkeypatch):
    """A training step's loss and backward under the bundle's block remat
    (the attention through the flash Function, its kernel's place taken by
    the counted plain forward), then a prefill: each MoE range runs once a
    token group in every forward of a MoE layer, as often as the layer's
    attention forward, the remat's included."""
    def through_function(q, k, v, **kw):
        return fa_ops.flash_attention(q, k, v, kw["causal"], kw["window"],
                                      kw["softcap"], use_kernel=True)

    monkeypatch.setattr(attention, "attention_auto", through_function)
    monkeypatch.setattr(moe, "MOE_GROUP", group)
    cfg, run, prm = _olmoe()
    Bn, S = 2, 24
    groups = Bn * S // min(group, Bn * S)
    toks = torch.randint(0, cfg.vocab_size, (Bn, S + 1),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    p = P.tree_map(lambda x: x.detach().requires_grad_(), prm)
    ctx = ShardingCtx.null()
    with ranges.timed(MOE_RANGES, "cpu") as got:
        loss, _ = lm.loss_fn(cfg, run, ctx, p, batch)
        loss.backward()
    forwards = len(plain_forward_as_kernel)
    assert forwards == 2 * cfg.num_layers
    assert {r: v["calls"] for r, v in got.items()} == \
        {r: forwards * groups for r in MOE_RANGES}

    with ranges.timed(MOE_RANGES, "cpu") as got, torch.inference_mode():
        lm.prefill_fn(cfg, run, ctx, prm, {"tokens": batch["tokens"]})
    assert {r: v["calls"] for r, v in got.items()} == \
        {r: cfg.num_layers * groups for r in MOE_RANGES}


def test_configure_allocator_sets_expandable_segments_unless_set(
        monkeypatch):
    monkeypatch.delenv("PYTORCH_CUDA_ALLOC_CONF", raising=False)
    assert D.configure_allocator() == "expandable_segments:True"
    assert os.environ["PYTORCH_CUDA_ALLOC_CONF"] == D.ALLOC_CONF
    monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF", "max_split_size_mb:512")
    assert D.configure_allocator() == "max_split_size_mb:512"
    assert os.environ["PYTORCH_CUDA_ALLOC_CONF"] == "max_split_size_mb:512"


def test_configure_allocator_refuses_once_cuda_has_started(monkeypatch):
    monkeypatch.delenv("PYTORCH_CUDA_ALLOC_CONF", raising=False)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="before CUDA starts"):
        D.configure_allocator()
    assert "PYTORCH_CUDA_ALLOC_CONF" not in os.environ


def test_the_train_cli_sets_the_allocator(monkeypatch, capsys):
    monkeypatch.delenv("PYTORCH_CUDA_ALLOC_CONF", raising=False)
    train_cli.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu",
                    "--steps", "1", "--batch", "2", "--seq", "16"])
    assert os.environ["PYTORCH_CUDA_ALLOC_CONF"] == D.ALLOC_CONF
    assert "steps=1" in capsys.readouterr().out
