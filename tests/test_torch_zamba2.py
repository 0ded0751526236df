"""The port's zamba2 serving path (Mamba2 layers on the SSD scan, a
weight-tied attention block every few layers) against the reference on
the CPU.

The reference's parameters are drawn once with numpy from a fixed seed,
every leaf random, handed to ``repro`` as jnp arrays and carried into the
port by ``params.from_reference``, the unstacked shared block included.
Prefill logits and caches, and teacher-forced decode steps after the
cache is padded for generation, must then agree within 1e-4 x
max(1, max|ref|) in float32; the conv state and the KV cache, which both
packages store in bfloat16, to one bfloat16 rounding. The port's own
prefill+decode must agree with its forward within 5e-3, as
tests/test_models_consistency.py holds the reference.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import registry as jax_registry  # noqa: E402
from repro.distributed.sharding import ShardingCtx as JaxCtx  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.models import params as jax_params  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.distributed.sharding import ShardingCtx  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention, lm, params as P  # noqa: E402
from repro_torch.models.common import logits_fn  # noqa: E402
from test_torch_rwkv import assert_close, random_reference_params  # noqa: E402

ARCH = "zamba2-7b"
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
JCTX, CTX = JaxCtx.null(), ShardingCtx.null()
B, S_GEN = 2, 3
CHUNK = registry.get(ARCH).smoke.scan_chunk  # 16


def jax_pad_cache(cache, gen):
    """The reference's pad for generation (repro/launch/serve.py:58-77)."""
    def pad_seq(x):
        padw = [(0, 0)] * x.ndim
        padw[-3] = (0, gen)
        return jnp.pad(x, padw)

    return {"mamba": cache["mamba"],
            "attn": {"k": pad_seq(cache["attn"]["k"]),
                     "v": pad_seq(cache["attn"]["v"])}}


def cache_items(cache):
    yield "mamba ssm", cache["mamba"]["ssm"]
    yield "mamba conv", cache["mamba"]["conv"]
    yield "attn k", cache["attn"]["k"]
    yield "attn v", cache["attn"]["v"]


def assert_same_rounding(got, want, what, rel=1e-4):
    """Both packages keep the conv state and the KV cache in bfloat16, even
    in a float32 run: each element is the rounding of a float32 value, and
    the two float32 values must agree within rel x max(1, max|ref|). Where
    such a pair straddles a rounding boundary, the roundings differ by one
    bfloat16 ulp more; so each element may differ by the float32 tolerance
    plus one ulp of its magnitude, and such flips must be rare."""
    assert got.dtype == torch.bfloat16, what
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    diff = np.abs(got - want)
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    bound = rel * max(1.0, float(np.max(np.abs(want)))) + ulp
    assert (diff <= bound).all(), f"{what}: {int((diff > bound).sum())} " \
        f"elements differ by more than the f32 tolerance and one bf16 ulp"
    assert (diff > 0).mean() <= 1e-2, f"{what}: {(diff > 0).mean():.2%} differ"


def check_caches(pcache, jcache, when):
    for (what, got), (_, want) in zip(cache_items(pcache), cache_items(jcache)):
        assert got.dtype == P.torch_dtype(str(want.dtype)), what
        if got.dtype == torch.bfloat16:
            assert_same_rounding(got, want, f"{when} {what}")
        else:
            assert_close(got, want, 1e-4, f"{when} {what}")


def both_params(seed=0):
    cfg = jax_registry.get(ARCH).smoke
    np_params = random_reference_params(cfg, seed)
    jprm = P.tree_map(lambda a: jnp.asarray(a, jnp.float32), np_params)
    return jprm, P.from_reference(np_params, device="cpu")


@pytest.mark.parametrize("prompt", [2 * CHUNK, 2 * CHUNK - 5])
def test_f32_prefill_and_decode_match_reference(prompt, monkeypatch):
    """Prefill at a prompt that is a multiple of the chunk and at one that
    is not (the scan's zero-pad), then S_GEN teacher-forced decode steps
    after both packages pad the attention cache for generation. On CPU
    tensors the shared block takes the dense path, as the reference does
    off the TPU: the flash path must not be reached."""
    def no_flash(*a, **kw):
        raise AssertionError("attention_auto took the flash path on the CPU")

    monkeypatch.setattr(attention.fa, "flash_attention", no_flash)
    jb, pb = jax_registry.get(ARCH), registry.get(ARCH)
    cfg, pcfg = jb.smoke, pb.smoke
    jrun = jb.run.replace(compute_dtype="float32")
    prun = pb.run.replace(compute_dtype="float32")
    jprm, pprm = both_params()
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, prompt + S_GEN), dtype=np.int32)

    jl, jcache = jax_lm.prefill_fn(cfg, jrun, JCTX, jprm,
                                   {"tokens": jnp.asarray(toks[:, :prompt])})
    pl, pcache = lm.prefill_fn(pcfg, prun, CTX, pprm,
                               {"tokens": torch.from_numpy(toks[:, :prompt])})
    assert_close(pl, jl, 1e-4, "prefill logits")
    check_caches(pcache, jcache, "prefill")

    jcache = jax_pad_cache(jcache, S_GEN)
    pcache = serve.pad_cache(pcfg, pcache, S_GEN)
    assert pcache["attn"]["k"].shape[2] == prompt + S_GEN
    for i in range(S_GEN):
        t = prompt + i
        jl, jcache = jax_lm.decode_fn(
            cfg, jrun, JCTX, jprm, jcache,
            {"tokens": jnp.asarray(toks[:, t:t + 1]), "pos": jnp.int32(t)})
        pl, pcache = lm.decode_fn(
            pcfg, prun, CTX, pprm, pcache,
            {"tokens": torch.from_numpy(toks[:, t:t + 1]), "pos": t})
        assert_close(pl, jl, 1e-4, f"decode {i} logits")
        check_caches(pcache, jcache, f"decode {i}")


def test_decode_past_an_unpadded_cache_raises():
    """Without the pad, the first decode step writes past the cache. The
    reference's dynamic_update_slice would clamp the index silently; the
    port refuses."""
    b = registry.get(ARCH)
    cfg, run = b.smoke, b.run.replace(compute_dtype="float32")
    _, prm = both_params(seed=3)
    toks = torch.zeros((B, CHUNK), dtype=torch.int32)
    _, cache = lm.prefill_fn(cfg, run, CTX, prm, {"tokens": toks})
    with pytest.raises(IndexError, match="pad the cache"):
        lm.decode_fn(cfg, run, CTX, prm, cache,
                     {"tokens": toks[:, :1], "pos": CHUNK})
    padded = serve.pad_cache(cfg, cache, 4)
    assert padded["mamba"] is cache["mamba"]
    assert padded["attn"]["k"].shape == (2, B, CHUNK + 4, cfg.num_kv_heads,
                                         cfg.head_dim)
    assert not padded["attn"]["v"][:, :, CHUNK:].any()


def test_prefill_decode_matches_own_forward():
    """Serving equals the teacher-forced forward (the port's counterpart of
    test_models_consistency.test_prefill_decode_matches_forward)."""
    b = registry.get(ARCH)
    cfg, run = b.smoke, b.run.replace(compute_dtype="float32")
    _, prm = both_params(seed=2)
    prompt, gen = 2 * CHUNK, 4
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, prompt + gen), dtype=np.int32))
    x, _ = lm._backbone(cfg, run, CTX, prm, {"tokens": toks}, toks)
    full = logits_fn(prm["embed"], x, CTX)
    logits, cache = lm.prefill_fn(cfg, run, CTX, prm,
                                  {"tokens": toks[:, :prompt]})
    cache = serve.pad_cache(cfg, cache, gen)
    got = [logits]
    for i in range(gen - 1):
        t = prompt + i
        logits, cache = lm.decode_fn(cfg, run, CTX, prm, cache,
                                     {"tokens": toks[:, t:t + 1],
                                      "pos": t})
        got.append(logits)
    want = full[:, prompt - 1:prompt - 1 + gen]
    assert_close(torch.stack(got, dim=1), want, 5e-3, "decode vs forward")


def test_generate_is_the_reference_greedy_decode():
    """``serve.generate`` on the carried weights gives the ids of a greedy
    argmax loop over the reference (prefill, pad, decode)."""
    jb, pb = jax_registry.get(ARCH), registry.get(ARCH)
    cfg = jb.smoke
    jrun = jb.run.replace(compute_dtype="float32")
    prun = pb.run.replace(compute_dtype="float32")
    jprm, pprm = both_params(seed=6)
    prompt, gen = 2 * CHUNK - 3, 4
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, prompt),
                                             dtype=np.int32)
    ids, times = serve.generate(pb.smoke, prun, pprm, torch.from_numpy(toks),
                                gen)
    jl, jcache = jax_lm.prefill_fn(cfg, jrun, JCTX, jprm,
                                   {"tokens": jnp.asarray(toks)})
    jcache = jax_pad_cache(jcache, gen)
    tok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
    want = [np.asarray(tok)]
    for i in range(gen - 1):
        jl, jcache = jax_lm.decode_fn(cfg, jrun, JCTX, jprm, jcache,
                                      {"tokens": tok[:, None],
                                       "pos": jnp.int32(prompt + i)})
        tok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
        want.append(np.asarray(tok))
    assert ids.shape == (B, gen) and ids.dtype == np.int32
    np.testing.assert_array_equal(ids, np.stack(want, axis=1))
    assert times["prefill_s"] > 0 and times["decode_s_per_token"] > 0


def test_param_and_cache_specs_keep_the_reference_key_paths():
    """The same tree as the reference, the unstacked ``stack/shared``
    block included, and ``from_reference`` carries every leaf of it."""
    pcfg, jcfg = registry.get(ARCH).smoke, jax_registry.get(ARCH).smoke

    def flat(t, prefix=()):
        if isinstance(t, dict):
            return {p: s for k, v in t.items() for p, s in
                    flat(v, prefix + (k,)).items()}
        return {prefix: (t.shape, t.logical, t.init, t.scale, t.dtype)}

    specs = flat(lm.param_specs(pcfg))
    assert specs == flat(jax_lm.param_specs(jcfg))
    assert specs[("stack", "shared", "attn", "wq")][0] == (64, 64)  # no L axis
    shape = registry.get(ARCH).shapes[0]
    assert flat(lm.cache_specs(pcfg, shape)) == flat(
        jax_lm.cache_specs(jcfg, jax_registry.get(ARCH).shapes[0]))
    np_params = random_reference_params(jcfg, seed=4)
    carried = P.from_reference(np_params, device="cpu")
    for path in specs:
        want, got = np_params, carried
        for key in path:
            want, got = want[key], got[key]
        assert np.array_equal(got.numpy(), want), path


def test_full_zamba2_7b_param_count():
    cfg = registry.get(ARCH).model
    n = P.count_params(lm.param_specs(cfg))
    assert n == jax_params.count_params(
        jax_lm.param_specs(jax_registry.get(ARCH).model)) == 6_751_130_832
    assert cfg.param_count() == n
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.shared_attn_every, cfg.scan_chunk,
            cfg.ssm_state, cfg.ssm_head_dim) == (
                81, 3584, 32, 32, 112, 14336, 6, 128, 64, 64)


def test_serve_cli_runs_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "20",
         "--gen", "4"], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("arch=zamba2-7b-smoke batch=2 device=cpu")
    ids = json.loads(lines[1].split(":", 1)[1])
    assert len(ids) == 4 and all(0 <= i < 256 for i in ids)
