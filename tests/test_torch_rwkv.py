"""The port's rwkv6 serving path against the reference on the CPU.

The reference's parameters are drawn once with numpy from a fixed seed,
every leaf random (the zero-initialised ``u``, ``mu_*`` and ``w0`` too, so
that no term of the model is zero), handed to ``repro`` as jnp arrays and
carried into the port by ``params.from_reference``. Prefill logits and
cache, and teacher-forced decode steps, must then agree within the stated
tolerances: 1e-4 x max(1, max|ref|) in float32, 2e-2 for a layer in
bfloat16 (the repo's bf16 tolerance, tests/test_kernels.py), and the port's own
prefill+decode against its forward within 5e-3, as
tests/test_models_consistency.py holds the reference.
"""

from __future__ import annotations

import dataclasses
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
from repro.models import rwkv as jax_rwkv  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.distributed.sharding import ShardingCtx  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm, params as P, rwkv  # noqa: E402
from repro_torch.models.common import logits_fn  # noqa: E402

ARCH = "rwkv6-7b"
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
JCTX, CTX = JaxCtx.null(), ShardingCtx.null()
B, S_PROMPT, S_GEN = 2, 32, 3  # the smoke config's chunk is 16


def random_reference_params(cfg, seed=0):
    """The reference's parameter tree as numpy float32, every leaf drawn:
    normal leaves with the reference's std, zeros-initialised leaves small
    around 0, ones-initialised (norm scales) small around 1."""
    rng = np.random.default_rng(seed)

    def draw(spec):
        x = rng.standard_normal(spec.shape).astype(np.float32)
        if spec.init == "zeros":
            return 0.1 * x
        if spec.init == "ones":
            return 1.0 + 0.05 * x
        fan_in = spec.shape[-1] if spec.init == "embed" else (
            spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1])
        return x * np.float32(spec.scale / np.sqrt(fan_in))

    return P.tree_map(draw, jax_lm.param_specs(cfg))


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def assert_close(got, want, rel, what):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    scale = max(1.0, float(np.max(np.abs(want))))
    assert err <= rel * scale, f"{what}: max|diff| {err} > {rel} x {scale}"


def run_both(compute_dtype, n_decode=S_GEN):
    """Prefill then ``n_decode`` teacher-forced decode steps in both
    packages; returns [(what, port value, reference value), ...]."""
    jb, pb = jax_registry.get(ARCH), registry.get(ARCH)
    cfg, pcfg = jb.smoke, pb.smoke
    jrun = jb.run.replace(compute_dtype=compute_dtype)
    prun = pb.run.replace(compute_dtype=compute_dtype)
    np_params = random_reference_params(cfg)
    jprm = P.tree_map(lambda a: jnp.asarray(a, compute_dtype), np_params)
    pprm = P.from_reference(np_params, device="cpu", dtype=compute_dtype)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S_PROMPT + n_decode), dtype=np.int32)

    out = []
    jl, jcache = jax_lm.prefill_fn(cfg, jrun, JCTX, jprm,
                                   {"tokens": jnp.asarray(toks[:, :S_PROMPT])})
    pl, pcache = lm.prefill_fn(pcfg, prun, CTX, pprm,
                               {"tokens": torch.from_numpy(toks[:, :S_PROMPT])})
    out.append(("prefill logits", pl, jl))
    for key in ("wkv", "last_tmix", "last_cmix"):
        out.append((f"prefill cache {key}", pcache[key], jcache[key]))
    for i in range(n_decode):
        t = S_PROMPT + i
        jl, jcache = jax_lm.decode_fn(
            cfg, jrun, JCTX, jprm, jcache,
            {"tokens": jnp.asarray(toks[:, t:t + 1]), "pos": jnp.int32(t)})
        pl, pcache = lm.decode_fn(
            pcfg, prun, CTX, pprm, pcache,
            {"tokens": torch.from_numpy(toks[:, t:t + 1]),
             "pos": t})
        out.append((f"decode {i} logits", pl, jl))
        for key in ("wkv", "last_tmix", "last_cmix"):
            out.append((f"decode {i} cache {key}", pcache[key], jcache[key]))
    return out


def test_f32_prefill_and_decode_match_reference():
    for what, got, want in run_both("float32"):
        assert_close(got, want, 1e-4, what)


def test_bf16_layer_matches_reference():
    """One rwkv6 layer in bfloat16 (prefill, then one decode step) within
    the repo's bf16 tolerance, 2e-2 x max(1, max|ref|).

    The whole model is not held to 2e-2 in bf16: XLA on the CPU rounds a
    bf16 sigmoid after each step of 1/(1+exp(-x)), where PyTorch rounds
    once, and such 1-ulp differences grow through random layers to 2-3 %
    of the logits, as far as each package's own bf16 run is from its f32
    run (3-5 %). Layer 0's wkv state, whose inputs are bit-identical in
    both, agrees to float32 rounding."""
    jb, pb = jax_registry.get(ARCH), registry.get(ARCH)
    cfg = jb.smoke
    layer0 = P.tree_map(lambda a: a[0],
                      random_reference_params(cfg)["stack"]["layers"])
    jw = P.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), layer0)
    pw = P.from_reference(layer0, device="cpu", dtype="bfloat16")
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, S_PROMPT, cfg.d_model)).astype(np.float32)
    x1 = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)

    jy, jst = jax_rwkv.layer_prefill(cfg, jb.run, JCTX, jw,
                                     jnp.asarray(x, jnp.bfloat16),
                                     chunk=cfg.scan_chunk)
    py, pst = rwkv.layer_prefill(pb.smoke, pb.run, CTX, pw, bf(x),
                                 chunk=cfg.scan_chunk)
    assert py.dtype == torch.bfloat16
    assert_close(pst["wkv"], jst["wkv"], 1e-5, "layer 0 wkv state")
    jd, jst = jax_rwkv.layer_decode(cfg, jb.run, JCTX, jw,
                                    jnp.asarray(x1, jnp.bfloat16), jst)
    pd, pst2 = rwkv.layer_decode(pb.smoke, pb.run, CTX, pw, bf(x1), pst)
    assert_close(py, jy, 2e-2, "prefill output")
    assert_close(pd, jd, 2e-2, "decode output")
    for key in ("wkv", "last_tmix", "last_cmix"):
        assert_close(pst2[key], jst[key], 2e-2, f"decode state {key}")


def test_prefill_decode_matches_own_forward():
    """Serving equals the teacher-forced forward (the port's counterpart of
    test_models_consistency.test_prefill_decode_matches_forward)."""
    b = registry.get(ARCH)
    cfg, run = b.smoke, b.run.replace(compute_dtype="float32")
    prm = P.from_reference(random_reference_params(b.smoke, seed=2),
                           device="cpu")
    S_gen = 4
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, S_PROMPT + S_gen), dtype=np.int32))
    x, _ = lm._backbone(cfg, run, CTX, prm, {"tokens": toks}, toks)
    full = logits_fn(prm["embed"], x, CTX)
    logits, cache = lm.prefill_fn(cfg, run, CTX, prm,
                                  {"tokens": toks[:, :S_PROMPT]})
    got = [logits]
    for i in range(S_gen - 1):
        t = S_PROMPT + i
        logits, cache = lm.decode_fn(cfg, run, CTX, prm, cache,
                                     {"tokens": toks[:, t:t + 1],
                                      "pos": t})
        got.append(logits)
    want = full[:, S_PROMPT - 1:S_PROMPT - 1 + S_gen]
    assert_close(torch.stack(got, dim=1), want, 5e-3, "decode vs forward")


def test_full_rwkv6_7b_param_count():
    cfg = registry.get(ARCH).model
    n = P.count_params(lm.param_specs(cfg))
    assert n == jax_params.count_params(
        jax_lm.param_specs(jax_registry.get(ARCH).model)) == 7_576_621_056
    assert cfg.param_count() == n
    assert (cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size,
            cfg.d_model // cfg.wkv_head_dim, cfg.scan_chunk,
            cfg.tie_embeddings) == (32, 4096, 14336, 65536, 64, 32, False)


def test_param_specs_keep_the_reference_key_paths():
    cfg = registry.get(ARCH).smoke

    def flat(t, prefix=()):
        if isinstance(t, dict):
            return {p: s for k, v in t.items() for p, s in
                    flat(v, prefix + (k,)).items()}
        return {prefix: (t.shape, t.logical, t.init, t.scale, t.dtype)}

    assert flat(lm.param_specs(cfg)) == flat(
        jax_lm.param_specs(jax_registry.get(ARCH).smoke))
    assert flat(lm.cache_specs(cfg, registry.get(ARCH).shapes[0])) == flat(
        jax_lm.cache_specs(jax_registry.get(ARCH).smoke,
                           jax_registry.get(ARCH).shapes[0]))


def test_registry_matches_reference():
    assert registry.arch_ids() == jax_registry.arch_ids()


@pytest.mark.parametrize("arch", jax_registry.arch_ids())
def test_bundle_equals_reference(arch):
    assert (dataclasses.asdict(registry.get(arch))
            == dataclasses.asdict(jax_registry.get(arch)))


@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2-7b", "whisper-small",
                                  "olmoe-1b-7b", "llama-3.2-vision-11b"])
def test_unported_families_raise(arch):
    """No family raises any more: the dense (smollm), MoE (olmoe), hybrid
    (zamba2), VLM (llama-3.2-vision) and audio (whisper) families build,
    their parameter specs counting what the reference's count."""
    cfg = registry.get(arch).smoke
    n = P.count_params(lm.param_specs(cfg))
    assert n == cfg.param_count() == jax_registry.get(arch).smoke.param_count()
    assert n > 0


def test_materialize_init_rules():
    cfg = registry.get(ARCH).smoke
    specs = lm.param_specs(cfg)
    a = P.materialize(specs, torch.Generator().manual_seed(7), "cpu",
                      dtype="bfloat16")
    b = P.materialize(specs, torch.Generator().manual_seed(7), "cpu",
                      dtype="bfloat16")
    assert all(torch.equal(x, y) for x, y in
               zip(P.leaves(a), P.leaves(b)))  # one seed, one tree
    tmix = a["stack"]["layers"]["tmix"]
    assert tmix["u"].dtype == torch.bfloat16
    assert not tmix["u"].any() and not tmix["w0"].any()
    assert (tmix["ln"] == 1).all()
    # normal leaves: std = scale / sqrt(fan_in), fan_in the second-to-last
    # axis (the last for the embedding)
    wk = a["stack"]["layers"]["cmix"]["wk"].float()  # (L, 64, 128)
    assert abs(wk.std().item() * np.sqrt(64) - 1) < 0.05
    emb = a["embed"]["embedding"].float()  # (256, 64), fan_in 64
    assert abs(emb.std().item() * np.sqrt(64) - 1) < 0.05
    lora = tmix["lora_A"].float()  # scale 0.1
    assert abs(lora.std().item() * np.sqrt(64) / 0.1 - 1) < 0.1


def test_from_reference_carries_bf16_bits():
    x = np.random.default_rng(5).standard_normal((3, 4)).astype(np.float32)
    jx = np.asarray(jnp.asarray(x, jnp.bfloat16))
    t = P.from_reference({"a": {"b": jx}}, device="cpu")["a"]["b"]
    assert t.dtype == torch.bfloat16
    assert torch.equal(t, torch.from_numpy(x).to(torch.bfloat16))


def test_default_device_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    specs = lm.param_specs(registry.get(ARCH).smoke)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.materialize(specs, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", ARCH, "--smoke"])


def test_serve_cli_runs_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "16",
         "--gen", "4"], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("arch=rwkv6-7b-smoke batch=2 device=cpu")
    ids = json.loads(lines[1].split(":", 1)[1])
    assert len(ids) == 4 and all(0 <= i < 256 for i in ids)


def test_generate_greedy_is_argmax_of_prefill():
    b = registry.get(ARCH)
    cfg, run = b.smoke, b.run.replace(compute_dtype="float32")
    prm = P.from_reference(random_reference_params(cfg, seed=6), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, S_PROMPT), dtype=np.int32))
    ids, times = serve.generate(cfg, run, prm, {"tokens": toks}, 3)
    logits, _ = lm.prefill_fn(cfg, run, CTX, prm, {"tokens": toks})
    assert ids.shape == (B, 3) and ids.dtype == np.int32
    assert (ids[:, 0] == logits.argmax(-1).numpy()).all()
    assert times["prefill_s"] > 0 and times["decode_s_per_token"] > 0
