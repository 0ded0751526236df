"""The port's audio family (whisper-small) against the reference on the CPU:
one encoder layer and one decoder layer, the encoder and the decoder stack
under their per-layer remat, the smoke model's prefill, decode, loss and
gradients, the parameter counts, the flash launches and trainer
checkpoints across the two packages.

Parameters and the stub frame embeddings are drawn with numpy from fixed
seeds and handed to both packages (``params.from_reference``), as in
tests/test_torch_vlm.py, with its tolerances: x max(1, max|ref|), in
float32, 1e-4 for the layers, logits, the loss and every gradient; one
bfloat16 rounding for the caches; checkpoints bit for bit. Every MLP of
the model is gelu while ``cfg.act`` says silu, as the reference has it.
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

from repro.configs import registry as jax_registry  # noqa: E402
from repro.models import audio as jax_audio  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention, audio, lm  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from test_torch_dense import flat_specs, plain_forward_as_kernel  # noqa: E402,F401
from test_torch_rwkv import assert_close  # noqa: E402
from test_torch_vlm import (CTX, JCTX, B, bound, both_params,  # noqa: E402,F401
                            carry, check_caches, check_checkpoint_crosses,
                            check_loss_and_grads, check_trainers_agree,
                            configs, embeds, runs, through_function,
                            tree_items)

ARCH = "whisper-small"
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def both(arch=ARCH):
    jcfg, pcfg = configs(arch)
    jrun, prun = runs(arch)
    jprm, pprm = both_params(jcfg, seed=1)
    return jcfg, pcfg, jrun, prun, jprm, pprm


def positions(S):
    return np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()


def test_encoder_and_decoder_layers_match_reference():
    """One bidirectional encoder layer (rope on its positions, gelu) and
    one decoder layer (causal self-attention, cross attention to the
    encoder states, gelu)."""
    jcfg, pcfg, jrun, prun, jprm, pprm = both()
    assert pcfg.act == "silu"  # the layers take gelu all the same
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, jcfg.encoder_seq, jcfg.d_model)).astype(
        np.float32)
    jw = jax.tree.map(lambda t: t[0], jprm["stack"]["encoder"])
    pw = P.layer(pprm["stack"]["encoder"], 0)
    pos = positions(jcfg.encoder_seq)
    want = jax_audio._enc_layer(jcfg, jrun, JCTX, jw, jnp.asarray(x),
                                jnp.asarray(pos))
    got = audio._enc_layer(pcfg, prun, CTX, pw, torch.from_numpy(x),
                           torch.from_numpy(pos))
    assert_close(got, want, 1e-4, "encoder layer")

    y = rng.standard_normal((B, 11, jcfg.d_model)).astype(np.float32)
    jw = jax.tree.map(lambda t: t[1], jprm["stack"]["decoder"])
    pw = P.layer(pprm["stack"]["decoder"], 1)
    want = jax_audio._dec_layer(jcfg, jrun, JCTX, jw, jnp.asarray(y),
                                jnp.asarray(x), jnp.asarray(positions(11)))
    got = audio._dec_layer(pcfg, prun, CTX, pw, torch.from_numpy(y),
                           torch.from_numpy(x), torch.from_numpy(positions(11)))
    assert_close(got, want, 1e-4, "decoder layer")


@pytest.mark.parametrize("remat", ["block", "none"])
def test_encode_and_decode_train_match_reference(remat):
    jcfg, pcfg = configs(ARCH)
    jrun, prun = runs(ARCH, remat=remat)
    jprm, pprm = both_params(jcfg, seed=2)
    frames = embeds(jcfg, jcfg.encoder_seq, 2)
    jenc = jax_audio.encode(jcfg, jrun, JCTX, jprm["stack"],
                            jnp.asarray(frames))
    penc = audio.encode(pcfg, prun, CTX, pprm["stack"],
                        torch.from_numpy(frames))
    assert_close(penc, jenc, 1e-4, "encoder states")
    y = np.random.default_rng(4).standard_normal(
        (B, 13, jcfg.d_model)).astype(np.float32)
    want = jax_audio.decode_train(jcfg, jrun, JCTX, jprm["stack"],
                                  jnp.asarray(y), jenc,
                                  jnp.asarray(positions(13)))
    got = audio.decode_train(pcfg, prun, CTX, pprm["stack"],
                             torch.from_numpy(y), penc,
                             torch.from_numpy(positions(13)))
    assert_close(got, want, 1e-4, "decoder")


def jax_pad_cache(cache, gen):
    """The reference's pad for generation (repro/launch/serve.py:71-73)."""
    def pad_seq(x):
        padw = [(0, 0)] * x.ndim
        padw[-3] = (0, gen)
        return jnp.pad(x, padw)

    return {"k": pad_seq(cache["k"]), "v": pad_seq(cache["v"]),
            "ck": cache["ck"], "cv": cache["cv"]}


@pytest.mark.parametrize("prompt", [24, 23])
def test_f32_prefill_and_decode_match_reference(prompt):
    """Prefill, then 3 teacher-forced decode steps after both packages pad
    the self KV cache (the encoder's cross KV keeps its 32 frames); each
    decode step of the port starts from the reference's cache, as in
    tests/test_torch_vlm.py."""
    jcfg, pcfg, jrun, prun, jprm, pprm = both()
    gen = 3
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (B, prompt + gen), dtype=np.int32)
    frames = embeds(jcfg, jcfg.encoder_seq, 1)
    jl, jcache = jax_lm.prefill_fn(jcfg, jrun, JCTX, jprm, {
        "tokens": jnp.asarray(toks[:, :prompt]),
        "frame_embeds": jnp.asarray(frames)})
    pl, pcache = lm.prefill_fn(pcfg, prun, CTX, pprm, {
        "tokens": torch.from_numpy(toks[:, :prompt]),
        "frame_embeds": torch.from_numpy(frames)})
    assert_close(pl, jl, 1e-4, "prefill logits")
    check_caches(pcache, jcache, "prefill")
    assert pcache["k"].shape == (pcfg.num_layers, B, prompt,
                                 pcfg.num_kv_heads, pcfg.head_dim)
    assert pcache["ck"].shape == (pcfg.num_layers, B, pcfg.encoder_seq,
                                  pcfg.num_kv_heads, pcfg.head_dim)
    assert serve.pad_cache(pcfg, pcache, gen)["k"].shape[2] == prompt + gen

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


def test_loss_and_every_gradient_match_reference():
    check_loss_and_grads(ARCH)


def whisper_train_launches(cfg) -> int:
    """Flash launches in one microbatch's forward and backward under
    per-layer remat: each encoder layer's self-attention and each decoder
    layer's self and cross attention, in the forward and in the layer's
    recompute; the Function's backward recomputes through the plain
    version."""
    return 2 * (cfg.encoder_layers + 2 * cfg.num_layers)


@pytest.fixture
def attention_through_function(monkeypatch, plain_forward_as_kernel):
    monkeypatch.setattr(attention, "attention_auto", through_function)
    monkeypatch.setattr(attention, "attention_full",
                        lambda q, k, v: through_function(
                            q, k, v, causal=False, window=0, softcap=0.0))
    return plain_forward_as_kernel


def test_loss_through_the_flash_function_matches_reference(
        attention_through_function):
    """The encoder's, the decoder's and the cross attention through the
    flash Function (the kernel's place taken by the counted plain
    forward) under block remat: the same loss and gradients, and the
    launches the card's train_whisper phase asserts."""
    check_loss_and_grads(ARCH, seed=5)
    _, pcfg = configs(ARCH)
    assert registry.get(ARCH).run.remat == "block"
    assert len(attention_through_function) == whisper_train_launches(pcfg)
    assert whisper_train_launches(registry.get(ARCH).model) == 72


def test_prefill_launches_once_per_attention(attention_through_function):
    """A prefill launches flash once an encoder layer, and twice a decoder
    layer (its self and its cross attention): 12 + 24 = 36 for the whole
    model; a decode step none."""
    jcfg, pcfg, _, prun, _, pprm = both()
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, pcfg.vocab_size, (B, 10), dtype=np.int32))
    batch = {"tokens": toks, "frame_embeds": torch.from_numpy(
        embeds(jcfg, jcfg.encoder_seq, 8))}
    _, cache = lm.prefill_fn(pcfg, prun, CTX, pprm, batch)
    want = pcfg.encoder_layers + 2 * pcfg.num_layers
    assert len(attention_through_function) == want
    cache = serve.pad_cache(pcfg, cache, 1)
    lm.decode_fn(pcfg, prun, CTX, pprm, cache, {"tokens": toks[:, :1],
                                                "pos": 10})
    assert len(attention_through_function) == want
    full = registry.get(ARCH).model
    assert full.encoder_layers + 2 * full.num_layers == 36


def test_specs_keep_the_reference_key_paths():
    jcfg, pcfg = configs(ARCH)
    assert flat_specs(lm.param_specs(pcfg)) == flat_specs(
        jax_lm.param_specs(jcfg))
    for pshape, jshape in zip(registry.get(ARCH).shapes,
                              jax_registry.get(ARCH).shapes):
        assert flat_specs(lm.cache_specs(pcfg, pshape)) == flat_specs(
            jax_lm.cache_specs(jcfg, jshape))
        assert flat_specs(lm.input_specs(pcfg, pshape)) == flat_specs(
            jax_lm.input_specs(jcfg, jshape))


@pytest.mark.parametrize("which", ["model", "smoke"])
def test_param_counts_match_reference(which):
    jcfg = getattr(jax_registry.get(ARCH), which)
    pcfg = getattr(registry.get(ARCH), which)
    assert pcfg.param_count() == jcfg.param_count()
    if which == "model":
        assert pcfg.param_count() == 334_516_224
        assert (pcfg.encoder_layers, pcfg.num_layers, pcfg.encoder_seq,
                pcfg.d_model, pcfg.num_heads, pcfg.num_kv_heads,
                pcfg.head_dim, pcfg.d_ff, pcfg.vocab_size) == (
                    12, 12, 1500, 768, 12, 12, 64, 3072, 51865)


def test_serve_and_train_clis_run_on_the_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "20",
         "--gen", "4"], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("arch=whisper-small-smoke batch=2 device=cpu")
    ids = json.loads(lines[1].split(":", 1)[1])
    assert len(ids) == 4 and all(0 <= i < 256 for i in ids)
    out = tmp_path / "metrics.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--steps", "2", "--batch", "4",
         "--seq", "16", "--metrics-out", str(out)], env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    log = json.loads(out.read_text())
    assert [m["step"] for m in log] == [0, 1]
    assert all(np.isfinite(m["loss"]) for m in log)


def test_serve_stub_is_the_reference_constant():
    """The serve CLI's stub frames: 0.02 everywhere in bfloat16, the
    reference's ``0.02 * ones``."""
    cfg = registry.get(ARCH).smoke
    stub = serve.stub_embeds(cfg, 2, torch.device("cpu"))
    want = np.asarray(0.02 * jnp.ones((2, cfg.encoder_seq, cfg.d_model),
                                      jnp.bfloat16))
    assert list(stub) == ["frame_embeds"]
    got = stub["frame_embeds"]
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), want.astype(np.float32))
    vlm = registry.get("llama-3.2-vision-11b").smoke
    assert serve.stub_embeds(vlm, 2, torch.device("cpu"))[
        "image_embeds"].shape == (2, vlm.num_image_tokens, vlm.d_model)
    assert serve.stub_embeds(registry.get("smollm-135m").smoke, 2,
                             torch.device("cpu")) == {}


def test_reference_and_port_trainers_give_the_same_losses():
    check_trainers_agree(ARCH, 1)


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_trainer_checkpoint_crosses_packages(direction):
    check_checkpoint_crosses(ARCH, direction)


def test_every_mlp_is_gelu():
    """``cfg.act`` plays no part: the config says silu, every MLP runs
    gelu, so setting it to gelu leaves the logits as they are, and they
    agree with the reference's."""
    jcfg, pcfg, jrun, prun, jprm, pprm = both()
    toks = np.random.default_rng(9).integers(0, jcfg.vocab_size, (B, 12),
                                             dtype=np.int32)
    frames = embeds(jcfg, jcfg.encoder_seq, 9)
    batch = {"tokens": torch.from_numpy(toks),
             "frame_embeds": torch.from_numpy(frames)}
    got, _ = lm.prefill_fn(pcfg, prun, CTX, pprm, batch)
    gelu = dataclasses.replace(pcfg, act="gelu")
    assert torch.equal(lm.prefill_fn(gelu, prun, CTX, pprm, batch)[0], got)
    want, _ = jax_lm.prefill_fn(jcfg, jrun, JCTX, jprm, {
        "tokens": jnp.asarray(toks), "frame_embeds": jnp.asarray(frames)})
    assert_close(got, want, 1e-4, "prefill logits")
