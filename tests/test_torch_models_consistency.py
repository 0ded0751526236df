"""Cross-path consistency for every architecture in the port, the
counterpart of tests/test_models_consistency.py, each case held against
the reference at the same parameters; and the ``decode_flash`` decode on
virtual meshes against the reference's on fake host devices.

For each of the ten arch ids the smoke config's parameters are drawn with
numpy by the reference's init rules (zeros, ones, normal leaves at
``scale / sqrt(fan_in)``), except the VLM's gates, drawn away from 0 so
its cross layers count; the stub embeddings are drawn from the seed at
SyntheticLM's scale (0.02). In float32, x max(1, max|ref|): the port's
teacher-forced logits and its prefill logits agree with the reference's
within 1e-4; each teacher-forced decode step, started from the
reference's cache (a rounding that lands one bfloat16 ulp apart in the two
packages' caches would move the next logits by more), within 2e-4: the
step rounds its own token's key and value into the bfloat16 cache before
it attends to them, and at zamba2-7b's first step of this draw one such
rounding moves the logits by 1.08e-4 of their scale; and the
port's own prefill plus decode steps reproduce its forward within 5e-3,
the reference test's bound, or, where the reference's own serving path
lies further than that from its forward at these parameters (its bfloat16
KV cache; smollm-135m at 5.6e-3 with this draw), within that gap plus
1e-3.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import registry as jax_registry  # noqa: E402
from repro.distributed.sharding import ShardingCtx as JaxCtx  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.distributed.sharding import ShardingCtx  # noqa: E402
from repro_torch import ranges  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.mesh import make_elastic_mesh  # noqa: E402
from repro_torch.models import attention, common, lm, params as P  # noqa: E402
from test_torch_rwkv import assert_close  # noqa: E402
from test_torch_spmd import run_reference  # noqa: E402
from test_torch_vlm import with_gates  # noqa: E402

ARCHS = jax_registry.arch_ids()
JCTX, CTX = JaxCtx.null(), ShardingCtx.null()
CPU = torch.device("cpu")
B, S_PROMPT, S_GEN = 2, 16, 4


def init_rule_params(cfg, seed):
    """The reference's parameter tree drawn by its init rules, as numpy
    float32, the VLM's gates drawn from the seed."""
    rng = np.random.default_rng(seed)

    def draw(spec):
        if spec.init == "zeros":
            return np.zeros(spec.shape, np.float32)
        if spec.init == "ones":
            return np.ones(spec.shape, np.float32)
        fan_in = spec.shape[-1] if spec.init == "embed" else (
            spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1])
        x = rng.standard_normal(spec.shape).astype(np.float32)
        return x * np.float32(spec.scale / np.sqrt(fan_in))

    return with_gates(P.tree_map(draw, jax_lm.param_specs(cfg)), seed)


def stub_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    n = {"vlm": ("image_embeds", cfg.num_image_tokens),
         "audio": ("frame_embeds", cfg.encoder_seq)}
    if cfg.family not in n:
        return {}
    name, length = n[cfg.family]
    return {name: (0.02 * rng.standard_normal((B, length, cfg.d_model))
                   ).astype(np.float32)}


def both(arch, seed=0):
    jcfg, pcfg = jax_registry.get(arch).smoke, registry.get(arch).smoke
    run = registry.get(arch).run.replace(compute_dtype="float32")
    jrun = jax_registry.get(arch).run.replace(compute_dtype="float32")
    np_params = init_rule_params(jcfg, seed)
    return (jcfg, pcfg, jrun, run, P.tree_map(jnp.asarray, np_params),
            P.from_reference(np_params, device=CPU))


def carry(jcache):
    return P.from_reference(P.tree_map(np.asarray, jcache), device=CPU)


def jax_pad(cfg, jcache):
    """The reference's own pad for generation, through the port's
    ``pad_cache`` on the carried cache (tests/test_torch_vlm.py and
    tests/test_torch_audio.py hold it to the reference's)."""
    padded = serve.pad_cache(cfg, carry(jcache), S_GEN)
    return P.tree_map(lambda t: jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16) if t.dtype == torch.bfloat16 else jnp.asarray(
            t.numpy()), padded)


def gap(got, want):
    """max|got - want| / max(1, max|want|)."""
    return (float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
            / max(1.0, float(np.max(np.abs(np.asarray(want))))))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch):
    jcfg, cfg, jrun, run, jprm, prm = both(arch)
    S = S_PROMPT + S_GEN
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S),
                                             dtype=np.int32)
    extra = stub_inputs(cfg, 2)
    batch = {"tokens": torch.from_numpy(toks),
             **{k: torch.from_numpy(v) for k, v in extra.items()}}
    jb = {"tokens": jnp.asarray(toks),
          **{k: jnp.asarray(v) for k, v in extra.items()}}

    with torch.no_grad():
        x, _ = lm._backbone(cfg, run, CTX, prm, batch, batch["tokens"])
        full = common.logits_fn(prm["embed"], common.rms_norm(
            x, prm["final_ln"], cfg.norm_eps), CTX)
    jx, _ = jax_lm._backbone(jcfg, jrun, JCTX, jprm, jb, jb["tokens"])
    jfull = jax_common.logits_fn(jprm["embed"], jax_common.rms_norm(
        jx, jprm["final_ln"], jcfg.norm_eps), JCTX)
    assert_close(full, jfull, 1e-4, f"{arch} teacher-forced logits")

    # the port's serving path on its own, and the reference's
    logits, cache = lm.prefill_fn(cfg, run, CTX, prm, {
        **batch, "tokens": batch["tokens"][:, :S_PROMPT]})
    jl, jcache = jax_lm.prefill_fn(jcfg, jrun, JCTX, jprm, {
        **jb, "tokens": jb["tokens"][:, :S_PROMPT]})
    assert_close(logits, jl, 1e-4, f"{arch} prefill logits")
    cache, jcache = serve.pad_cache(cfg, cache, S_GEN), jax_pad(cfg, jcache)
    got, jgot = [logits], [jl]
    for i in range(S_GEN - 1):
        t = S_PROMPT + i
        step = {"tokens": batch["tokens"][:, t:t + 1], "pos": t}
        from_ref, _ = lm.decode_fn(cfg, run, CTX, prm, carry(jcache), step)
        logits, cache = lm.decode_fn(cfg, run, CTX, prm, cache, step)
        jl, jcache = jax_lm.decode_fn(jcfg, jrun, JCTX, jprm, jcache, {
            "tokens": jb["tokens"][:, t:t + 1], "pos": jnp.int32(t)})
        assert_close(from_ref, jl, 2e-4, f"{arch} decode {i} logits")
        got.append(logits)
        jgot.append(jl)
    want = full[:, S_PROMPT - 1:S_PROMPT - 1 + S_GEN]
    port_gap = gap(torch.stack(got, dim=1), want)
    ref_gap = gap(jnp.stack(jgot, axis=1), jfull[:, S_PROMPT - 1:S - 1])
    assert port_gap <= max(5e-3, ref_gap + 1e-3), (arch, port_gap, ref_gap)


def test_swa_ring_buffer_decode():
    """Decode 8 tokens past the sliding window (the ring buffer wraps), each
    step from the same cache as the reference's step: the same logits."""
    arch = "h2o-danube-3-4b"
    jcfg, cfg, jrun, run, jprm, prm = both(arch)
    S = cfg.sliding_window
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, S),
                                             dtype=np.int32)
    _, jcache = jax_lm.prefill_fn(jcfg, jrun, JCTX, jprm,
                                  {"tokens": jnp.asarray(toks)})
    for i in range(8):
        one = np.ones((1, 1), np.int32)
        pcache = P.from_reference(P.tree_map(np.asarray, jcache), device=CPU)
        logits, pcache = lm.decode_fn(cfg, run, CTX, prm, pcache,
                                      {"tokens": torch.from_numpy(one),
                                       "pos": S + i})
        jl, jcache = jax_lm.decode_fn(jcfg, jrun, JCTX, jprm, jcache,
                                      {"tokens": jnp.asarray(one),
                                       "pos": jnp.int32(S + i)})
        assert pcache["k"].shape[2] == S
        assert bool(torch.isfinite(logits).all())
        assert_close(logits, jl, 1e-4, f"decode {i} past the window")


def test_chunked_attention_equals_dense():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 2048, 4, 32, generator=g)
    k, v = (torch.randn(2, 2048, 2, 32, generator=g) for _ in range(2))
    for window in (0, 512):
        dense = attention.attention_dense(q, k, v, causal=True, window=window)
        chunked = attention.attention_chunked(q, k, v, causal=True,
                                              window=window, q_chunk=512)
        torch.testing.assert_close(chunked, dense, atol=2e-5, rtol=0)


FLASH_MESHES = ((2, 1), (1, 2))
FLASH_PROMPT, FLASH_PAD = 8, 8  # a 16-slot cache: 2 shards of 8

REF_DECODE_FLASH = """
from repro.configs import registry
from repro.distributed.sharding import ShardingCtx
from repro.launch.mesh import make_elastic_mesh
from repro.models import lm
for arch, (params, cache, tokens, pos) in inp["archs"].items():
    bundle = registry.get(arch)
    cfg = bundle.smoke
    run = bundle.run.replace(compute_dtype="float32",
                             sharding_rules="decode_flash")
    for d, m in inp["meshes"]:
        ctx = ShardingCtx.for_mesh(make_elastic_mesh(d, m), "decode_flash")
        step = jax.jit(lambda p, c, t, s, ctx=ctx: lm.decode_fn(
            cfg, run, ctx, p, c, {"tokens": t, "pos": s})[0])
        out[f"{arch}/{d}x{m}"] = step(params, cache, tokens, jnp.int32(pos))
"""


def flash_inputs(arch):
    """The parameters, the reference's prefill cache of FLASH_PROMPT
    tokens padded by FLASH_PAD (numpy), and the first decode step."""
    jcfg, cfg, jrun, run, jprm, prm = both(arch)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                             (B, FLASH_PROMPT), dtype=np.int32)
    extra = {k: jnp.asarray(v) for k, v in stub_inputs(cfg, 3).items()}
    _, jcache = jax_lm.prefill_fn(jcfg, jrun, JCTX, jprm,
                                  {"tokens": jnp.asarray(toks), **extra})
    cache = serve.pad_cache(cfg, carry(jcache), FLASH_PAD)
    np_cache = P.tree_map(lambda t: np.asarray(
        jnp.asarray(t.float().numpy()).astype(jnp.bfloat16))
        if t.dtype == torch.bfloat16 else t.numpy(), cache)
    np_params = P.tree_map(np.asarray, jprm)
    return (cfg, run, prm, cache), (np_params, np_cache, toks[:, :1],
                                    FLASH_PROMPT)


@pytest.fixture(scope="module")
def decode_flash_cases():
    """Each arch's port inputs, and the reference's decode step under
    ``decode_flash`` on each mesh of FLASH_MESHES, every arch, on 2 fake
    host devices in one subprocess."""
    cases = {arch: flash_inputs(arch) for arch in ARCHS}
    inp = {"archs": {arch: c[1] for arch, c in cases.items()},
           "meshes": FLASH_MESHES}
    return cases, run_reference(REF_DECODE_FLASH, inp, 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_flash_on_a_mesh_matches_reference(arch, decode_flash_cases):
    """The ``decode_flash`` ruleset on a virtual (2, 1) and (1, 2) mesh
    takes the sequence-sharded flash_decode in every self attention (as
    many calls as the dense decode makes to ``decode_attention``, and
    none to it; rwkv6 has none): the logits of the reference's step on
    the same meshes, within 1e-4, from the same cache. The ``baseline``
    ruleset on the same mesh decodes densely, and so does
    ``decode_flash`` with no mesh: both give the null context's
    logits."""
    cases, ref = decode_flash_cases
    (cfg, run, prm, cache), (_, _, tok, pos) = cases[arch]
    with ranges.count_calls(attention, ("decode_attention",
                                        "flash_decode")) as calls:
        step = {"tokens": torch.from_numpy(tok), "pos": pos}
        flash_run = run.replace(sharding_rules="decode_flash")
        want, _ = lm.decode_fn(cfg, run, CTX, prm, cache, step)
        n_attn = calls["decode_attention"]
        assert (n_attn == 0) == (cfg.family == "ssm"), (arch, n_attn)
        for d, m in FLASH_MESHES:
            mesh = make_elastic_mesh(d, m, devices=[CPU] * (d * m))
            calls.update(decode_attention=0, flash_decode=0)
            got, _ = lm.decode_fn(cfg, flash_run,
                                  ShardingCtx.for_mesh(mesh, "decode_flash"),
                                  prm, cache, step)
            assert calls == {"decode_attention": 0, "flash_decode": n_attn}
            assert_close(got, ref[f"{arch}/{d}x{m}"], 1e-4,
                         f"{arch} decode_flash on ({d}, {m})")
            base, _ = lm.decode_fn(cfg, run,
                                   ShardingCtx.for_mesh(mesh, "baseline"),
                                   prm, cache, step)
            assert torch.equal(base, want)
        dense, _ = lm.decode_fn(cfg, flash_run, CTX, prm, cache, step)
        assert torch.equal(dense, want)
