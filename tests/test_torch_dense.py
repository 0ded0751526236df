"""The port's dense stack (smollm-135m, h2o-danube-3-4b's sliding window),
its loss and gradients, the flash attention backward and the WKV6/SSD
kernel paths' gradients, against the reference on the CPU.

The reference's parameters are drawn once with numpy from a fixed seed,
every leaf random, handed to ``repro`` as jnp arrays and carried into the
port by ``params.from_reference``. In float32, prefill logits, decode
logits, the loss and every gradient leaf must agree within 1e-4 x
max(1, max|ref|); the KV caches, which both packages store in bfloat16,
to one bfloat16 rounding; the port's own prefill+decode with its forward
within 5e-3, as tests/test_models_consistency.py holds the reference. The
flash backward's dq, dk and dv agree with ``jax.grad`` of the reference's
``custom_vjp`` (its Pallas kernel in interpret mode) within 1e-3, the
tolerance of tests/test_kernels.py.
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
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import registry as jax_registry  # noqa: E402
from repro.distributed.sharding import ShardingCtx as JaxCtx  # noqa: E402
from repro.kernels.flash_attention import ops as jax_fa  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.models import params as jax_params  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.distributed.sharding import ShardingCtx  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.wkv6 import ops as wkv_ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention, common, lm, params as P  # noqa: E402
from test_torch_rwkv import assert_close, random_reference_params  # noqa: E402
from test_torch_zamba2 import assert_same_rounding  # noqa: E402

SMOLLM, DANUBE = "smollm-135m", "h2o-danube-3-4b"
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
JCTX, CTX = JaxCtx.null(), ShardingCtx.null()
B, S_GEN = 2, 3


def both_params(arch, seed=0):
    cfg = jax_registry.get(arch).smoke
    np_params = random_reference_params(cfg, seed)
    jprm = P.tree_map(lambda a: jnp.asarray(a, jnp.float32), np_params)
    return jprm, P.from_reference(np_params, device="cpu")


def runs(arch):
    return (jax_registry.get(arch).run.replace(compute_dtype="float32"),
            registry.get(arch).run.replace(compute_dtype="float32"))


def jax_pad_cache(cfg, cache, gen):
    """The reference's pad for generation (repro/launch/serve.py:58-66)."""
    if cfg.sliding_window > 0:
        return cache

    def pad_seq(x):
        padw = [(0, 0)] * x.ndim
        padw[-3] = (0, gen)
        return jnp.pad(x, padw)

    return {"k": pad_seq(cache["k"]), "v": pad_seq(cache["v"])}


def check_caches(pcache, jcache, when):
    for name in ("k", "v"):
        got, want = pcache[name], jcache[name]
        assert got.shape == want.shape, (when, name, got.shape, want.shape)
        assert_same_rounding(got, want, f"{when} {name}")


# --- serving -----------------------------------------------------------------


@pytest.mark.parametrize("arch,prompt", [
    (SMOLLM, 24), (SMOLLM, 23),  # an odd prompt length
    (DANUBE, 45),  # past the window (32): the prefill's ring layout rolls
    (DANUBE, 21)])  # short of it: the ring is zero-padded to the window
def test_f32_prefill_and_decode_match_reference(arch, prompt):
    """Prefill, then S_GEN teacher-forced decode steps after both packages
    pad the KV cache for generation (a sliding-window ring keeps its
    size)."""
    jb, pb = jax_registry.get(arch), registry.get(arch)
    cfg, pcfg = jb.smoke, pb.smoke
    jrun, prun = runs(arch)
    jprm, pprm = both_params(arch)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, prompt + S_GEN), dtype=np.int32)

    jl, jcache = jax_lm.prefill_fn(cfg, jrun, JCTX, jprm,
                                   {"tokens": jnp.asarray(toks[:, :prompt])})
    pl, pcache = lm.prefill_fn(pcfg, prun, CTX, pprm,
                               {"tokens": torch.from_numpy(toks[:, :prompt])})
    assert_close(pl, jl, 1e-4, "prefill logits")
    check_caches(pcache, jcache, "prefill")
    want_len = cfg.sliding_window or prompt
    assert pcache["k"].shape == (cfg.num_layers, B, want_len,
                                 cfg.num_kv_heads, cfg.head_dim)

    jcache = jax_pad_cache(cfg, jcache, S_GEN)
    pcache = serve.pad_cache(pcfg, pcache, S_GEN)
    assert pcache["k"].shape[2] == (cfg.sliding_window or prompt + S_GEN)
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


@pytest.mark.parametrize("arch,prompt", [(SMOLLM, 16), (SMOLLM, 15),
                                         (DANUBE, 40)])
def test_prefill_decode_matches_own_forward(arch, prompt):
    """Serving equals the teacher-forced forward (the port's counterpart of
    test_models_consistency.test_prefill_decode_matches_forward, which
    draws the weights by the init rules: with every leaf random, the
    bf16 KV cache moves the reference's own logits by 5 % of their
    scale)."""
    b = registry.get(arch)
    cfg, run = b.smoke, b.run.replace(compute_dtype="float32")
    prm = P.materialize(lm.param_specs(cfg), torch.Generator().manual_seed(0),
                        "cpu")
    gen = 4
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, prompt + gen), dtype=np.int32))
    x, _ = lm._backbone(cfg, run, CTX, prm, {"tokens": toks}, toks)
    full = common.logits_fn(prm["embed"], x, CTX)
    logits, cache = lm.prefill_fn(cfg, run, CTX, prm,
                                  {"tokens": toks[:, :prompt]})
    cache = serve.pad_cache(cfg, cache, gen)
    got = [logits]
    for i in range(gen - 1):
        t = prompt + i
        logits, cache = lm.decode_fn(cfg, run, CTX, prm, cache,
                                     {"tokens": toks[:, t:t + 1], "pos": t})
        got.append(logits)
    want = full[:, prompt - 1:prompt - 1 + gen]
    assert_close(torch.stack(got, dim=1), want, 5e-3, "decode vs forward")


def test_generate_is_the_reference_greedy_decode():
    """``serve.generate`` on the carried smollm weights gives the ids of a
    greedy argmax loop over the reference (prefill, pad, decode)."""
    jb, pb = jax_registry.get(SMOLLM), registry.get(SMOLLM)
    cfg = jb.smoke
    jrun, prun = runs(SMOLLM)
    jprm, pprm = both_params(SMOLLM, seed=6)
    prompt, gen = 13, 4
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, prompt),
                                             dtype=np.int32)
    ids, _ = serve.generate(pb.smoke, prun, pprm,
                          {"tokens": torch.from_numpy(toks)}, gen)
    jl, jcache = jax_lm.prefill_fn(cfg, jrun, JCTX, jprm,
                                   {"tokens": jnp.asarray(toks)})
    jcache = jax_pad_cache(cfg, jcache, gen)
    tok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
    want = [np.asarray(tok)]
    for i in range(gen - 1):
        jl, jcache = jax_lm.decode_fn(cfg, jrun, JCTX, jprm, jcache,
                                      {"tokens": tok[:, None],
                                       "pos": jnp.int32(prompt + i)})
        tok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
        want.append(np.asarray(tok))
    np.testing.assert_array_equal(ids, np.stack(want, axis=1))


def flat_specs(t, prefix=()):
    if isinstance(t, dict):
        return {p: s for k, v in t.items() for p, s in
                flat_specs(v, prefix + (k,)).items()}
    return {prefix: (t.shape, t.logical, t.init, t.scale, t.dtype)}


@pytest.mark.parametrize("arch", [SMOLLM, DANUBE])
def test_specs_keep_the_reference_key_paths(arch):
    """Parameter, cache and input specs: the reference's trees, key path
    for key path."""
    pcfg, jcfg = registry.get(arch).smoke, jax_registry.get(arch).smoke
    assert flat_specs(lm.param_specs(pcfg)) == flat_specs(
        jax_lm.param_specs(jcfg))
    for pshape, jshape in zip(registry.get(arch).shapes,
                              jax_registry.get(arch).shapes):
        assert flat_specs(lm.cache_specs(pcfg, pshape)) == flat_specs(
            jax_lm.cache_specs(jcfg, jshape))
        assert flat_specs(lm.input_specs(pcfg, pshape)) == flat_specs(
            jax_lm.input_specs(jcfg, jshape))


def test_full_smollm_135m_param_count():
    cfg = registry.get(SMOLLM).model
    n = P.count_params(lm.param_specs(cfg))
    assert n == jax_params.count_params(
        jax_lm.param_specs(jax_registry.get(SMOLLM).model)) == 134_515_008
    assert cfg.param_count() == n
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.tie_embeddings) == (
                30, 576, 9, 3, 64, 1536, 49152, True)


def test_moe_and_vlm_stacks_raise_naming_their_item():
    """The VLM and audio families, the last to raise, build since their
    slice (tests/test_torch_vlm.py, tests/test_torch_audio.py): their
    parameter specs count what the reference's count, smoke and whole."""
    for arch in ("llama-3.2-vision-11b", "whisper-small"):
        for which in ("smoke", "model"):
            cfg = getattr(registry.get(arch), which)
            jcfg = getattr(jax_registry.get(arch), which)
            n = P.count_params(lm.param_specs(cfg))
            assert n == cfg.param_count() == jcfg.param_count() > 0


def test_serve_cli_runs_smollm_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", SMOLLM,
         "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "20",
         "--gen", "4"], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("arch=smollm-135m-smoke batch=2 device=cpu")
    ids = json.loads(lines[1].split(":", 1)[1])
    assert len(ids) == 4 and all(0 <= i < 256 for i in ids)


# --- the flash attention backward ------------------------------------------------

GRAD_CASES = [  # (B, Sq, Skv, Hq, Hkv, D, causal, window, softcap)
    (1, 128, 128, 2, 2, 64, True, 0, 0.0),  # tests/test_kernels.py's case
    (2, 256, 256, 4, 2, 64, True, 0, 0.0),  # GQA
    (2, 256, 256, 4, 4, 64, False, 0, 0.0),  # not causal
    (1, 512, 512, 4, 2, 64, True, 128, 0.0),  # window
    (1, 256, 256, 4, 2, 112, True, 0, 5.0),  # softcap
]


def qkv_inputs(B, Sq, Skv, Hq, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    n = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return n(B, Sq, Hq, D), n(B, Skv, Hkv, D), n(B, Skv, Hkv, D)


@pytest.fixture
def plain_forward_as_kernel(monkeypatch):
    """The CUDA kernel's place taken by the plain forward, counted, so the
    Function runs on CPU tensors."""
    calls = []

    def fwd(q, k, v, *, causal, window, softcap):
        assert all(t.is_contiguous() for t in (q, k, v))
        calls.append(q.shape)
        return fa_ref.attention(q, k, v, causal=causal, window=window,
                                softcap=softcap)

    monkeypatch.setattr(FK, "flash_attention_fwd", fwd)
    return calls


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,causal,window,softcap",
                         GRAD_CASES)
def test_flash_backward_matches_reference_custom_vjp(
        B, Sq, Skv, Hq, Hkv, D, causal, window, softcap,
        plain_forward_as_kernel):
    qkv = qkv_inputs(B, Sq, Skv, Hq, Hkv, D)
    g = np.random.default_rng(1).standard_normal((B, Sq, Hq, D)).astype(
        np.float32)

    def f(q, k, v):
        out = jax_fa.flash_attention(q, k, v, causal, window, softcap, True)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, qkv))
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in qkv)
    out = fa_ops.flash_attention(q, k, v, causal, window, softcap,
                                 use_kernel=True)
    assert out.grad_fn is not None and len(plain_forward_as_kernel) == 1
    out.backward(torch.from_numpy(g))
    for name, got, w in zip("qkv", (q.grad, k.grad, v.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-3,
                                   err_msg=f"d{name}")
    assert len(plain_forward_as_kernel) == 1  # the backward recomputes
    # through the plain version, not the kernel


def test_flash_backward_takes_a_strided_input_and_bf16(
        plain_forward_as_kernel):
    """A transposed (non-contiguous) q is made contiguous for the kernel;
    bf16 gradients come out bf16 and equal autograd through the plain
    version."""
    qkv = qkv_inputs(1, 64, 64, 4, 2, 32, seed=3)
    q0 = torch.from_numpy(qkv[0]).to(torch.bfloat16)
    k0, v0 = (torch.from_numpy(a).to(torch.bfloat16) for a in qkv[1:])
    qs = q0.transpose(1, 2).contiguous().transpose(1, 2)
    assert not qs.is_contiguous()
    grads = []
    for use_kernel in (True, False):
        q, k, v = (t.clone().requires_grad_() for t in (qs, k0, v0))
        out = fa_ops.flash_attention(q, k, v, True, 16, 0.0,
                                     use_kernel=use_kernel)
        (out.float() ** 2).sum().backward()
        grads.append([t.grad for t in (q, k, v)])
    for got, want in zip(*grads):
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, want)


# --- the loss --------------------------------------------------------------------


def test_xent_loss_matches_reference():
    rng = np.random.default_rng(4)
    logits = (3 * rng.standard_normal((2, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (2, 7), dtype=np.int32)
    want, want_aux = jax_common.xent_loss(jnp.asarray(logits),
                                          jnp.asarray(labels))
    got, aux = common.xent_loss(torch.from_numpy(logits),
                                torch.from_numpy(labels))
    assert got.dtype == torch.float32
    assert_close(got, want, 1e-6, "loss")
    for k in ("nll", "z_loss"):
        assert_close(aux[k], want_aux[k], 1e-6, k)
    # bf16 logits are reduced in f32
    got16, _ = common.xent_loss(torch.from_numpy(logits).bfloat16(),
                                torch.from_numpy(labels))
    assert got16.dtype == torch.float32


def jax_grads_by_path(cfg, run, jprm, batch):
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: jax_lm.loss_fn(cfg, run, JCTX, p, batch),
        has_aux=True)(jprm)
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    return loss, metrics, {tuple(k.key for k in path): g for path, g in flat}


def port_loss_and_grads(cfg, run, pprm, batch):
    pprm = P.tree_map(lambda t: t.requires_grad_(), pprm)
    loss, metrics = lm.loss_fn(cfg, run, CTX, pprm, batch)
    loss.backward()
    return loss, metrics, pprm


def check_loss_and_grads(arch, seq, seed=0):
    jb, pb = jax_registry.get(arch), registry.get(arch)
    jrun, prun = runs(arch)
    jprm, pprm = both_params(arch, seed)
    toks = np.random.default_rng(seed + 10).integers(
        0, jb.smoke.vocab_size, (B, seq + 1), dtype=np.int32)
    np_batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jloss, jmet, jgrads = jax_grads_by_path(
        jb.smoke, jrun, jprm, {k: jnp.asarray(v) for k, v in np_batch.items()})
    loss, met, prm = port_loss_and_grads(
        pb.smoke, prun, pprm,
        {k: torch.from_numpy(v) for k, v in np_batch.items()})
    assert loss.dtype == torch.float32
    assert_close(loss.detach(), jloss, 1e-4, "loss")
    assert set(met) == set(jmet)
    for k in met:
        assert_close(met[k].detach(), jmet[k], 1e-4, k)
    n = 0
    for path, want in jgrads.items():
        got = prm
        for key in path:
            got = got[key]
        assert got.grad is not None, path
        assert_close(got.grad, want, 1e-4, f"grad {path}")
        n += 1
    assert n == len(list(P.leaves(prm)))


@pytest.mark.parametrize("attn", ["jnp", "pallas_interpret"])
def test_smollm_loss_and_every_gradient_match_reference(attn, monkeypatch):
    """The reference on its jnp attention, and with its Pallas flash kernel
    in interpret mode under its custom_vjp (a sequence of 128 tokens, so a
    flash block divides it)."""
    if attn == "pallas_interpret":
        monkeypatch.setenv("REPRO_ATTN", "pallas_interpret")
    check_loss_and_grads(SMOLLM, 128 if attn == "pallas_interpret" else 40)


def test_smollm_loss_through_the_flash_function_matches_reference(
        plain_forward_as_kernel, monkeypatch):
    """The port's attention through its autograd Function (the kernel's
    place taken by the plain forward) under block remat: the same loss and
    gradients; each layer's forward runs twice (the remat recomputes it)."""
    def through_function(q, k, v, **kw):
        return fa_ops.flash_attention(q, k, v, kw["causal"], kw["window"],
                                      kw["softcap"], use_kernel=True)

    monkeypatch.setattr(attention, "attention_auto", through_function)
    check_loss_and_grads(SMOLLM, 40, seed=5)
    cfg = registry.get(SMOLLM).smoke
    assert registry.get(SMOLLM).run.remat == "block"
    assert len(plain_forward_as_kernel) == 2 * cfg.num_layers


@pytest.mark.parametrize("arch,seq", [("rwkv6-7b", 32), ("zamba2-7b", 32)])
def test_ssm_and_hybrid_loss_and_gradients_on_the_cpu(arch, seq):
    """rwkv6 and zamba2 train on the CPU through the plain versions of
    their kernels (native autograd)."""
    check_loss_and_grads(arch, seq)


# --- the kernel paths' backward ------------------------------------------------


def _wkv6_args(requires_grad):
    g = torch.Generator().manual_seed(0)
    r, k, w = (torch.randn(1, 32, 2, 8, generator=g) for _ in range(3))
    v = torch.randn(1, 32, 2, 8, generator=g)
    u = torch.randn(2, 8, generator=g).requires_grad_(requires_grad)
    return (r, k, v, w, u, torch.zeros(1, 2, 8, 8)), {"chunk": 16}


def _ssd_args(requires_grad):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 32, 2, 8, generator=g).requires_grad_(requires_grad)
    dt = torch.rand(1, 32, 2, generator=g)
    Bm, Cm = (torch.randn(1, 32, 4, generator=g) for _ in range(2))
    return (x, dt, Bm, Cm, torch.zeros(2), torch.ones(2),
            torch.zeros(1, 2, 8, 4)), {"chunk": 16}


@pytest.mark.parametrize("fn,args,kernel,plain", [
    (wkv_ops.wkv6, _wkv6_args, "repro_torch.kernels.wkv6.kernel.wkv6_chunked",
     "repro_torch.kernels.wkv6.ref.wkv6"),
    (ssd_ops.ssd, _ssd_args, "repro_torch.kernels.ssd.kernel.ssd_chunked",
     "repro_torch.kernels.ssd.ref.ssd")])
def test_kernel_paths_carry_a_grad_fn_and_the_plain_gradients(
        fn, args, kernel, plain, monkeypatch):
    """The kernel path takes an input that requires grad: its output has a
    ``grad_fn`` (the autograd Function), and its gradient is the plain
    version's. On CPU tensors the kernel itself refuses (with or without
    grad), so here its place is taken by the plain forward, counted: one
    launch, none in the backward. The plain version differentiates
    natively."""
    import importlib

    a, kw = args(True)
    with pytest.raises(ValueError, match="CUDA|cuda"):
        fn(*a, use_kernel=True, **kw)
    with torch.no_grad():
        with pytest.raises(ValueError, match="CUDA|cuda"):
            fn(*a, use_kernel=True, **kw)
    mod_name, _, attr = kernel.rpartition(".")
    pmod, _, pattr = plain.rpartition(".")
    plain_fn = getattr(importlib.import_module(pmod), pattr)
    calls = []

    def counted(*t, chunk):
        calls.append(chunk)
        return plain_fn(*t, chunk=chunk)

    monkeypatch.setattr(importlib.import_module(mod_name), attr, counted)
    leaf = next(t for t in a if t.requires_grad)
    y, st = fn(*a, use_kernel=True, **kw)
    assert y.grad_fn is not None and st.grad_fn is not None
    (y.sum() + st.sum()).backward()
    assert calls == [16]
    got = leaf.grad.clone()
    leaf.grad = None
    y, st = fn(*a, **kw)  # CPU tensors: the plain version
    (y.sum() + st.sum()).backward()
    assert torch.isfinite(leaf.grad).all()
    assert torch.allclose(got, leaf.grad, rtol=0, atol=1e-6)
