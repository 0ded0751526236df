"""The port's VLM family (llama-3.2-vision-11b) against the reference on the
CPU: cross attention and its decode step, one super-block, the smoke
model's prefill, decode, loss and gradients, the parameter counts, the
flash launches under nested remat and trainer checkpoints across the two
packages.

Parameters are drawn once with numpy from a fixed seed, every leaf
random, handed to ``repro`` as jnp arrays and carried into the port by
``params.from_reference``. The gates are zeros-initialised in both
packages, and tanh(0) = 0 hides the cross layers, so each test draws them
from the seed, away from 0, into the numpy tree both packages get; the
image embeddings are drawn from the seed too, at unit scale, so that the
cross layers move the logits by far more than the tolerance. Tolerances,
x max(1, max|ref|), in float32: prefill and decode logits, the loss and
every gradient 1e-4; the caches, stored in bfloat16 by both, one bfloat16
rounding; the cross attention 2e-5; checkpoints bit for bit (those of
tests/test_torch_dense.py and tests/test_torch_moe.py).
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
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

import repro.fs.mounts as R_mounts  # noqa: E402
import repro_torch.fs.mounts as T_mounts  # noqa: E402
from repro.configs import registry as jax_registry  # noqa: E402
from repro.distributed.sharding import ShardingCtx as JaxCtx  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro.train.trainer import Trainer as JaxTrainer  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.distributed.sharding import ShardingCtx  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention, lm, transformer  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402
from test_torch_checkpoint import _port_view_of, _ref_view_of  # noqa: E402
from test_torch_dense import (flat_specs, jax_grads_by_path,  # noqa: E402,F401
                              plain_forward_as_kernel, port_loss_and_grads)
from test_torch_fs_slice import _image, _ref_binding  # noqa: E402
from test_torch_rwkv import assert_close, random_reference_params  # noqa: E402
from test_torch_train import carried_state, paired  # noqa: E402
from test_torch_zamba2 import assert_same_rounding  # noqa: E402

ARCH = "llama-3.2-vision-11b"
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
JCTX, CTX = JaxCtx.null(), ShardingCtx.null()
B = 2
# the smoke config (2 super-blocks of 1 self layer and 1 cross layer) and
# one with 2 self layers a super-block, so both stacked axes have length 2
SHAPES = {"smoke": {}, "p3": {"num_layers": 6, "cross_attn_every": 3}}


@pytest.fixture(autouse=True)
def bound(monkeypatch):
    """The reference's bento mounts hash with the same blockhash as the
    port's (its kernel binding swapped for ``blockhash_np``)."""
    monkeypatch.setattr(R_mounts, "kernel_binding", _ref_binding)


def configs(arch=ARCH, shape="smoke"):
    jcfg = dataclasses.replace(jax_registry.get(arch).smoke, **SHAPES[shape])
    pcfg = dataclasses.replace(registry.get(arch).smoke, **SHAPES[shape])
    return jcfg, pcfg


def runs(arch=ARCH, **kw):
    return (jax_registry.get(arch).run.replace(compute_dtype="float32", **kw),
            registry.get(arch).run.replace(compute_dtype="float32", **kw))


def with_gates(np_params, seed, gate=None):
    """The cross layers' gates (zeros-initialised leaves, 0-d a layer) set
    to ``gate``, or drawn from ``seed`` with magnitudes in [0.5, 1.5] and
    random signs; every other leaf as it is."""
    rng = np.random.default_rng(seed + 100)

    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if path[-1] not in ("gate_attn", "gate_mlp"):
            return tree
        if gate is not None:
            return np.full(tree.shape, gate, np.float32)
        g = rng.uniform(0.5, 1.5, tree.shape) * rng.choice([-1, 1], tree.shape)
        return g.astype(np.float32)

    return walk(np_params)


def both_params(jcfg, seed=0, gate=None):
    np_params = with_gates(random_reference_params(jcfg, seed), seed, gate)
    jprm = P.tree_map(lambda a: jnp.asarray(a, jnp.float32), np_params)
    return jprm, P.from_reference(np_params, device="cpu")


def embeds(cfg, n, seed, scale=1.0):
    """(B, n, d) stub embeddings drawn from ``seed``, float32."""
    rng = np.random.default_rng(seed + 200)
    return (scale * rng.standard_normal((B, n, cfg.d_model))).astype(
        np.float32)


def tree_items(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_items(v, path + (k,))
    else:
        yield path, tree


def check_caches(pcache, jcache, when):
    """Every cache leaf at the reference's shape and dtype, each within
    one bfloat16 rounding of the reference's."""
    want = dict(tree_items(jcache))
    got = dict(tree_items(pcache))
    assert set(got) == set(want), when
    for path, w in want.items():
        g = got[path]
        assert tuple(g.shape) == tuple(w.shape), (when, path)
        assert g.dtype == P.torch_dtype(str(w.dtype)) == torch.bfloat16
        assert_same_rounding(g, w, f"{when} {path}")


def jax_pad_cache(cache, gen):
    """The reference's pad for generation (repro/launch/serve.py:67-70)."""
    def pad_seq(x):
        padw = [(0, 0)] * x.ndim
        padw[-3] = (0, gen)
        return jnp.pad(x, padw)

    return {"self": {"k": pad_seq(cache["self"]["k"]),
                     "v": pad_seq(cache["self"]["v"])},
            "cross": cache["cross"]}


# --- cross attention ---------------------------------------------------------


@pytest.mark.parametrize("Hq,Hkv,S,T", [(4, 2, 7, 16), (4, 4, 12, 5)])
def test_cross_attention_and_decode_match_reference(Hq, Hkv, S, T):
    """q from the stream, k and v from the encoder states: no rope, no
    mask, Skv != Sq; the decode step against the bfloat16 KV, cast back."""
    jcfg, pcfg = (dataclasses.replace(c, num_heads=Hq, num_kv_heads=Hkv)
                  for c in configs())
    rng = np.random.default_rng(Hq * 10 + S)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    d, qd, kd = jcfg.d_model, jcfg.q_dim, jcfg.kv_dim
    w = {"wq": n(d, qd) / 8, "wk": n(d, kd) / 8, "wv": n(d, kd) / 8,
         "wo": n(qd, d) / 8}
    x, enc = n(B, S, d), n(B, T, d)
    jw, pw = P.tree_map(jnp.asarray, w), P.tree_map(torch.from_numpy, w)
    want = jax_attention.cross_attention(jcfg, jw, jnp.asarray(x),
                                         jnp.asarray(enc), JCTX)
    got = attention.cross_attention(pcfg, pw, torch.from_numpy(x),
                                    torch.from_numpy(enc), CTX)
    assert_close(got, want, 2e-5, "cross attention")

    kv = (B, T, Hkv, jcfg.head_dim)
    ck = np.asarray(jnp.asarray((enc @ w["wk"]).reshape(kv), jnp.bfloat16))
    cv = np.asarray(jnp.asarray((enc @ w["wv"]).reshape(kv), jnp.bfloat16))
    want = jax_attention.cross_decode(jcfg, jw, jnp.asarray(x[:, :1]),
                                      jnp.asarray(ck), jnp.asarray(cv))
    pck, pcv = (P.from_reference(a, device="cpu") for a in (ck, cv))
    assert pck.dtype == torch.bfloat16
    got = attention.cross_decode(pcfg, pw, torch.from_numpy(x[:, :1]), pck,
                                 pcv)
    assert_close(got, want, 2e-5, "cross decode")


@pytest.mark.parametrize("remat", ["block", "none"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_super_blocks_match_reference(shape, remat):
    """The stack of super-blocks ([p-1 self layers, 1 gated cross layer] x
    groups) and one cross block alone, with and without the nested remat."""
    jcfg, pcfg = configs(shape=shape)
    jrun, prun = runs(remat=remat)
    jprm, pprm = both_params(jcfg, seed=1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 9, jcfg.d_model)).astype(np.float32)
    img = embeds(jcfg, jcfg.num_image_tokens, 2)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (B, 9))
    jx, _ = jax_transformer.stack_apply(
        jcfg, jrun, JCTX, jprm["stack"], jnp.asarray(x), jnp.asarray(pos),
        img=jnp.asarray(img))
    px, aux = transformer.stack_apply(
        pcfg, prun, CTX, pprm["stack"], torch.from_numpy(x),
        torch.from_numpy(pos.copy()), img=torch.from_numpy(img))
    assert_close(px, jx, 1e-4, "stack")
    assert aux.dtype == torch.float32 and float(aux) == 0.0
    jw = jax.tree.map(lambda t: t[0], jprm["stack"]["cross"])
    pw = P.layer(pprm["stack"]["cross"], 0)
    want = jax_transformer.cross_block_apply(jcfg, JCTX, jw, jnp.asarray(x),
                                             jnp.asarray(img))
    got = transformer.cross_block_apply(pcfg, CTX, pw, torch.from_numpy(x),
                                        torch.from_numpy(img))
    assert_close(got, want, 1e-4, "cross block")


# --- serving -----------------------------------------------------------------


def carry(jcache):
    """The reference's cache as the port's, bit for bit."""
    return P.from_reference(P.tree_map(np.asarray, jcache), device="cpu")


@pytest.mark.parametrize("shape,prompt", [("smoke", 24), ("smoke", 23),
                                          ("p3", 17)])
def test_f32_prefill_and_decode_match_reference(shape, prompt):
    """Prefill, then 3 teacher-forced decode steps after both packages pad
    the self KV cache (the image KV keeps its length). Each package rounds
    its f32 keys to the bfloat16 cache, and a pair that straddles a
    rounding boundary lands one ulp apart, which moves the next step's
    logits by more than their tolerance: so each decode step of the port
    starts from the reference's cache of the step before, carried bit for
    bit, and its logits and new cache are held against the reference's
    step."""
    jcfg, pcfg = configs(shape=shape)
    jrun, prun = runs()
    jprm, pprm = both_params(jcfg)
    gen = 3
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (B, prompt + gen), dtype=np.int32)
    img = embeds(jcfg, jcfg.num_image_tokens, 1)
    jl, jcache = jax_lm.prefill_fn(jcfg, jrun, JCTX, jprm, {
        "tokens": jnp.asarray(toks[:, :prompt]), "image_embeds": jnp.asarray(img)})
    pl, pcache = lm.prefill_fn(pcfg, prun, CTX, pprm, {
        "tokens": torch.from_numpy(toks[:, :prompt]),
        "image_embeds": torch.from_numpy(img)})
    assert_close(pl, jl, 1e-4, "prefill logits")
    check_caches(pcache, jcache, "prefill")
    g, s = transformer._vlm_groups(pcfg)
    assert pcache["self"]["k"].shape == (g, s, B, prompt, pcfg.num_kv_heads,
                                         pcfg.head_dim)
    assert pcache["cross"]["img_k"].shape == (
        g, B, pcfg.num_image_tokens, pcfg.num_kv_heads, pcfg.head_dim)
    assert serve.pad_cache(pcfg, pcache, gen)["self"]["k"].shape[3] == \
        prompt + gen

    padded = serve.pad_cache(pcfg, carry(jcache), gen)
    jcache = jax_pad_cache(jcache, gen)
    for (path, got), (_, want) in zip(tree_items(padded),
                                      tree_items(carry(jcache))):
        assert torch.equal(got, want), path
    for i in range(gen):
        t = prompt + i
        pl, pcache = lm.decode_fn(
            pcfg, prun, CTX, pprm, carry(jcache),
            {"tokens": torch.from_numpy(toks[:, t:t + 1]), "pos": t})
        jl, jcache = jax_lm.decode_fn(
            jcfg, jrun, JCTX, jprm, jcache,
            {"tokens": jnp.asarray(toks[:, t:t + 1]), "pos": jnp.int32(t)})
        assert_close(pl, jl, 1e-4, f"decode {i} logits")
        check_caches(pcache, jcache, f"decode {i}")


def test_cross_path_moves_the_logits():
    """With the gates at 0 the cross layers add nothing (tanh(0) = 0): the
    same prefill with the drawn gates differs by far more than the
    tolerance, and the port agrees with the reference in both."""
    jcfg, pcfg = configs()
    jrun, prun = runs()
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (B, 16),
                                             dtype=np.int32)
    img = embeds(jcfg, jcfg.num_image_tokens, 3)
    logits = {}
    for gate in (None, 0.0):
        jprm, pprm = both_params(jcfg, seed=4, gate=gate)
        jl, _ = jax_lm.prefill_fn(jcfg, jrun, JCTX, jprm, {
            "tokens": jnp.asarray(toks), "image_embeds": jnp.asarray(img)})
        pl, _ = lm.prefill_fn(pcfg, prun, CTX, pprm, {
            "tokens": torch.from_numpy(toks),
            "image_embeds": torch.from_numpy(img)})
        assert_close(pl, jl, 1e-4, f"logits, gates {gate}")
        logits[gate] = pl
    scale = max(1.0, logits[0.0].abs().max().item())
    moved = (logits[None] - logits[0.0]).abs().max().item()
    assert moved > 100 * 1e-4 * scale, (moved, scale)


def test_generate_is_the_reference_greedy_decode():
    """``serve.generate`` with the image embeddings in the batch gives the
    ids of a greedy argmax loop over the reference."""
    jcfg, pcfg = configs()
    jrun, prun = runs()
    jprm, pprm = both_params(jcfg, seed=6)
    prompt, gen = 13, 4
    toks = np.random.default_rng(7).integers(0, jcfg.vocab_size, (B, prompt),
                                             dtype=np.int32)
    img = embeds(jcfg, jcfg.num_image_tokens, 7)
    ids, _ = serve.generate(pcfg, prun, pprm, {
        "tokens": torch.from_numpy(toks),
        "image_embeds": torch.from_numpy(img)}, gen)
    jl, jcache = jax_lm.prefill_fn(jcfg, jrun, JCTX, jprm, {
        "tokens": jnp.asarray(toks), "image_embeds": jnp.asarray(img)})
    jcache = jax_pad_cache(jcache, gen)
    tok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
    want = [np.asarray(tok)]
    for i in range(gen - 1):
        jl, jcache = jax_lm.decode_fn(jcfg, jrun, JCTX, jprm, jcache,
                                      {"tokens": tok[:, None],
                                       "pos": jnp.int32(prompt + i)})
        tok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
        want.append(np.asarray(tok))
    np.testing.assert_array_equal(ids, np.stack(want, axis=1))


# --- the loss and its gradients ------------------------------------------------


def check_loss_and_grads(arch, shape="smoke", seq=24, seed=0, run_kw=None):
    """The loss, its metrics and every gradient leaf against ``jax.grad``
    of the reference's loss, on one numpy batch with the stub embeddings
    drawn from the seed."""
    jcfg, pcfg = configs(arch, shape)
    jrun, prun = runs(arch, **(run_kw or {}))
    jprm, pprm = both_params(jcfg, seed)
    toks = np.random.default_rng(seed + 10).integers(
        0, jcfg.vocab_size, (B, seq + 1), dtype=np.int32)
    np_batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if jcfg.family == "vlm":
        np_batch["image_embeds"] = embeds(jcfg, jcfg.num_image_tokens, seed)
    if jcfg.family == "audio":
        np_batch["frame_embeds"] = embeds(jcfg, jcfg.encoder_seq, seed)
    jloss, jmet, jgrads = jax_grads_by_path(
        jcfg, jrun, jprm, {k: jnp.asarray(v) for k, v in np_batch.items()})
    loss, met, prm = port_loss_and_grads(
        pcfg, prun, pprm, {k: torch.from_numpy(v) for k, v in np_batch.items()})
    assert loss.dtype == torch.float32
    assert_close(loss.detach(), jloss, 1e-4, "loss")
    assert set(met) == set(jmet)
    for k in met:
        assert_close(met[k].detach(), jmet[k], 1e-4, k)
    for path, want in jgrads.items():
        got = prm
        for key in path:
            got = got[key]
        assert got.grad is not None, path
        assert_close(got.grad, want, 1e-4, f"grad {path}")
    assert len(jgrads) == len(list(P.leaves(prm)))


@pytest.mark.parametrize("shape", list(SHAPES))
def test_loss_and_every_gradient_match_reference(shape):
    """Every leaf, the gates and the doubly stacked self layers included."""
    check_loss_and_grads(ARCH, shape)


def through_function(q, k, v, *, causal=True, window=0, softcap=0.0, **_):
    """``attention_auto``'s place: the flash Function on CPU tensors."""
    return fa_ops.flash_attention(q, k, v, causal, window, softcap,
                                  use_kernel=True)


def vlm_train_launches(cfg) -> int:
    """Flash launches in one microbatch's forward and backward under the
    nested remat: each group's forward (its p-1 self layers and its cross
    layer), the group's recompute (all of them: the cross layer closes the
    group and holds saved tensors), then each self layer's own recompute;
    the Function's backward recomputes through the plain version."""
    g, s = transformer._vlm_groups(cfg)
    return g * ((s + 1) + (s + 1) + s)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_loss_through_the_flash_function_matches_reference(
        shape, plain_forward_as_kernel, monkeypatch):
    """Self and cross attention through the flash Function (the kernel's
    place taken by the counted plain forward) under the bundle's block
    remat: the same loss and gradients, and the launches the card's
    train_vlm phase asserts, g (3 (p-1) + 2) a microbatch."""
    monkeypatch.setattr(attention, "attention_auto", through_function)
    monkeypatch.setattr(attention, "attention_full",
                        lambda q, k, v: through_function(
                            q, k, v, causal=False, window=0, softcap=0.0))
    check_loss_and_grads(ARCH, shape, seed=5)
    _, pcfg = configs(shape=shape)
    assert registry.get(ARCH).run.remat == "block"
    assert len(plain_forward_as_kernel) == vlm_train_launches(pcfg)
    g, s = transformer._vlm_groups(pcfg)
    assert vlm_train_launches(pcfg) == g * (3 * s + 2)
    full = registry.get(ARCH).model
    assert vlm_train_launches(dataclasses.replace(full, num_layers=5)) == 14


def test_prefill_launches_once_per_attention(plain_forward_as_kernel,
                                             monkeypatch):
    """A prefill launches flash once a self layer and once a cross layer
    (32 + 8 = 40 for the whole model); a decode step none."""
    monkeypatch.setattr(attention, "attention_auto", through_function)
    monkeypatch.setattr(attention, "attention_full",
                        lambda q, k, v: through_function(
                            q, k, v, causal=False, window=0, softcap=0.0))
    jcfg, pcfg = configs(shape="p3")
    _, prun = runs()
    _, pprm = both_params(jcfg)
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, pcfg.vocab_size, (B, 10), dtype=np.int32))
    batch = {"tokens": toks, "image_embeds": torch.from_numpy(
        embeds(jcfg, jcfg.num_image_tokens, 8))}
    _, cache = lm.prefill_fn(pcfg, prun, CTX, pprm, batch)
    assert len(plain_forward_as_kernel) == pcfg.num_layers
    cache = serve.pad_cache(pcfg, cache, 1)
    lm.decode_fn(pcfg, prun, CTX, pprm, cache, {"tokens": toks[:, :1],
                                                "pos": 10})
    assert len(plain_forward_as_kernel) == pcfg.num_layers


# --- specs and counts ------------------------------------------------------------


def test_specs_keep_the_reference_key_paths():
    jcfg, pcfg = configs()
    assert flat_specs(lm.param_specs(pcfg)) == flat_specs(
        jax_lm.param_specs(jcfg))
    for pshape, jshape in zip(registry.get(ARCH).shapes,
                              jax_registry.get(ARCH).shapes):
        assert flat_specs(lm.cache_specs(pcfg, pshape)) == flat_specs(
            jax_lm.cache_specs(jcfg, jshape))
        assert flat_specs(lm.input_specs(pcfg, pshape)) == flat_specs(
            jax_lm.input_specs(jcfg, jshape))


@pytest.mark.parametrize("layers,count", [(40, 9_775_157_264),
                                          (5, 2_141_237_250),
                                          (10, 3_231_797_252)])
def test_param_counts_match_reference(layers, count):
    """The whole model, the card's training depth (one super-block) and
    depth 10."""
    jcfg = dataclasses.replace(jax_registry.get(ARCH).model,
                               num_layers=layers)
    pcfg = dataclasses.replace(registry.get(ARCH).model, num_layers=layers)
    assert pcfg.param_count() == jcfg.param_count() == count
    assert pcfg.active_param_count() == jcfg.active_param_count() == count


# --- the entry points and trainer checkpoints -------------------------------------


def test_serve_cli_runs_on_the_cpu():
    """The serve CLI with the reference's stub image embeddings (the train
    CLI's VLM batch is SyntheticLM's, as the trainers' test below runs
    it)."""
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "20",
         "--gen", "4"], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("arch=llama-3.2-vision-smoke batch=2 "
                               "device=cpu")
    ids = json.loads(lines[1].split(":", 1)[1])
    assert len(ids) == 4 and all(0 <= i < 256 for i in ids)


def both_trainers(arch=ARCH, global_batch=8, **kw):
    """A reference trainer and a port trainer on the same smoke config and
    data (SyntheticLM draws the stub embeddings), the bundle's microbatch
    size kept: for the VLM 2 microbatches of 4, the embeddings sliced with
    the tokens."""
    jb, pb = jax_registry.get(arch), registry.get(arch)
    jrun = jb.run.replace(compute_dtype="float32", learning_rate=1e-3)
    prun = pb.run.replace(compute_dtype="float32", learning_rate=1e-3)
    jkw = {k: v for k, v in kw.items() if k != "port_view"}
    jt = JaxTrainer(jb.smoke, jrun, global_batch=global_batch, seq_len=16,
                    seed=3, **jkw)
    pkw = dict(jkw)
    if "port_view" in kw:
        pkw["ckpt_view"] = kw["port_view"]
    pt = Trainer(pb.smoke, prun, global_batch=global_batch, seq_len=16,
                 seed=3, device="cpu", **pkw)
    return jt, pt


def check_trainers_agree(arch, n_accum):
    from repro_torch.train.step import num_accum_steps

    jt, pt = both_trainers(arch)
    assert num_accum_steps(pt.run, pt.ctx, 8) == n_accum
    pt.restore_state(carried_state(jt))
    jt.train(2)
    pt.train(2)
    np.testing.assert_allclose([m["loss"] for m in pt.metrics_log],
                               [m["loss"] for m in jt.metrics_log],
                               rtol=0, atol=1e-4)
    for path, got, want in paired(pt.params, jt.params):
        assert_close(got, want, 1e-4, f"params {path}")


def check_checkpoint_crosses(arch, direction):
    """A trainer checkpoint saved by one package restores in the other,
    every parameter and optimizer leaf bit for bit (the 0-d gates and the
    doubly stacked self leaves included)."""
    if direction == "reference_to_port":
        jmf = R_mounts.make_mount("bento", n_blocks=32768)
        jt, _ = both_trainers(arch, ckpt_view=jmf.view, ckpt_every=2)
        jt.train(2)
        jmf.close()
        view, _ks = _port_view_of(_image(jmf.dev))
        _, pt = both_trainers(arch, port_view=view)
        assert pt.restore_checkpoint() and pt.step_idx == 2
    else:
        pmf = T_mounts.make_mount("bento", n_blocks=32768, device="cpu")
        _, pt = both_trainers(arch, port_view=pmf.view, ckpt_every=2)
        pt.train(2)
        pmf.close()
        view, _ks = _ref_view_of(_image(pmf.dev))
        jt, _ = both_trainers(arch, ckpt_view=view)
        assert jt.restore_checkpoint() and jt.step_idx == 2
    for tree_p, tree_j in ((pt.params, jt.params), (pt.opt_state, jt.opt_state)):
        for path, got, want in paired(tree_p, tree_j):
            assert np.array_equal(got.numpy(), np.asarray(want)), path


def test_reference_and_port_trainers_give_the_same_losses():
    check_trainers_agree(ARCH, 2)


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_trainer_checkpoint_crosses_packages(direction):
    check_checkpoint_crosses(ARCH, direction)
