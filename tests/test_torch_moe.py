"""The port's MoE family (olmoe-1b-7b) against the reference on the CPU:
the MoE layer (router, GShard capacity dispatch, aux loss), the smoke
model's prefill, decode, loss and gradients, its parameter counts, the
a2a refusal and trainer checkpoints across the two packages.

Inputs and parameters are drawn with numpy from fixed seeds and handed to
both packages. ``torch.topk`` and ``lax.top_k`` may order ties apart, so
each comparison first holds the chosen expert ids equal. Tolerances, x
max(1, max|ref|), in float32: the layer's output and aux loss 2e-5;
prefill and decode logits, the loss and every gradient 1e-4 (those of
tests/test_torch_dense.py); the KV caches, stored in bfloat16 by both,
to one bfloat16 rounding; checkpoints bit for bit.
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
from repro.models import lm as jax_lm  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models import registry as jax_model_registry  # noqa: E402
from repro.train.trainer import Trainer as JaxTrainer  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.distributed.sharding import ShardingCtx  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.mesh import make_elastic_mesh  # noqa: E402
from repro_torch.models import attention, lm, moe  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models import registry as model_registry  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402
from test_torch_checkpoint import _port_view_of, _ref_view_of  # noqa: E402
from test_torch_dense import (both_params, check_caches,  # noqa: E402,F401
                              check_loss_and_grads, flat_specs,
                              jax_pad_cache, plain_forward_as_kernel, runs)
from test_torch_fs_slice import _image, _ref_binding  # noqa: E402
from test_torch_rwkv import assert_close  # noqa: E402
from test_torch_train import carried_state, paired  # noqa: E402

ARCH = "olmoe-1b-7b"
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
JCTX, CTX = JaxCtx.null(), ShardingCtx.null()
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def bound(monkeypatch):
    """The reference's bento mounts hash with the same blockhash as the
    port's (its kernel binding swapped for ``blockhash_np``)."""
    monkeypatch.setattr(R_mounts, "kernel_binding", _ref_binding)


def configs():
    return jax_registry.get(ARCH).smoke, registry.get(ARCH).smoke


def layer_inputs(cfg, T, seed=0, shared=0.0):
    """One MoE layer's weights and a (1, T, d) input, drawn with numpy.
    ``shared`` mixes one common vector into every token, so the router
    sends most tokens to the same experts and capacity drops some."""
    rng = np.random.default_rng(seed)
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    w = {"router": n(d, E) * 0.5, "w_gate": n(E, d, ff) / np.sqrt(d),
         "w_up": n(E, d, ff) / np.sqrt(d), "w_down": n(E, ff, d) / np.sqrt(ff)}
    x = n(1, T, d) + shared * n(1, 1, d) * 4
    return w, x


def route_both(jcfg, pcfg, w, x):
    """Each package's router over the tokens of each routing group: the
    chosen expert ids must be equal before anything else is compared."""
    g = min(moe.MOE_GROUP, x.shape[1])
    for xg in np.split(x.reshape(-1, x.shape[-1]), x.shape[1] // g):
        _, jids, _ = jax_moe._route(jcfg, jnp.asarray(xg @ w["router"]))
        _, pids, _ = moe._route(pcfg, torch.from_numpy(xg @ w["router"]))
        np.testing.assert_array_equal(pids.numpy(), np.asarray(jids))


def moe_both(jcfg, pcfg, w, x):
    jy, jaux = jax_moe.moe_apply(jcfg, JCTX, P.tree_map(jnp.asarray, w),
                                 jnp.asarray(x))
    py, paux = moe.moe_apply(pcfg, CTX, P.tree_map(torch.from_numpy, w),
                             torch.from_numpy(x))
    return (py, paux), (jy, jaux)


def test_capacity_matches_reference():
    for cfg_j, cfg_p in ((jax_registry.get(ARCH).smoke, registry.get(ARCH).smoke),
                         (jax_registry.get(ARCH).model, registry.get(ARCH).model)):
        for g in (1, 2, 4, 7, 8, 16, 32, 100, 1024, 4096):
            assert moe.capacity(g, cfg_p) == jax_moe.capacity(g, cfg_j), g
    assert moe.capacity(4096, registry.get(ARCH).model) == 640
    assert moe.capacity(4, registry.get(ARCH).model) == 4  # a decode step


@pytest.mark.parametrize("T,shared,group", [
    (32, 0.0, None),  # one group, room for every assignment
    (16, 1.0, None),  # capacity 5 a group: the common direction drops some
    (64, 0.3, 16),  # four MOE_GROUP groups (capacity 5 each, drops), the
    # aux loss their mean
])
def test_moe_layer_matches_reference(T, shared, group, monkeypatch):
    jcfg, pcfg = configs()
    if group:
        monkeypatch.setattr(jax_moe, "MOE_GROUP", group)
        monkeypatch.setattr(moe, "MOE_GROUP", group)
    w, x = layer_inputs(jcfg, T, seed=T, shared=shared)
    route_both(jcfg, pcfg, w, x)
    (py, paux), (jy, jaux) = moe_both(jcfg, pcfg, w, x)
    assert py.dtype == torch.float32 and paux.dtype == torch.float32
    assert_close(py, jy, 2e-5, "y")
    assert_close(paux, jaux, 2e-5, "aux loss")
    g = group or T
    C = moe.capacity(g, pcfg)
    kept = []
    for xg in np.split(x[0], T // g):
        wts, ids, _ = moe._route(pcfg, torch.from_numpy(xg @ w["router"]))
        comb = moe._combine_tensor(pcfg, wts, ids, C)
        jc = jax_moe._combine_tensor(jcfg, *map(jnp.asarray, (wts.numpy(),
                                                              ids.numpy())), C)
        np.testing.assert_array_equal(comb.numpy(), np.asarray(jc))
        kept.append(int((comb > 0).sum()))
    if shared:  # capacity 5 a group of 16: tokens were dropped
        assert sum(kept) < T * pcfg.experts_per_token
    else:
        assert sum(kept) == T * pcfg.experts_per_token


def test_moe_layer_gradients_match_reference():
    """Through a capacity that drops tokens: the gradient of every weight
    and of the input."""
    jcfg, pcfg = configs()
    w, x = layer_inputs(jcfg, 16, seed=3, shared=1.0)
    g = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)

    def jloss(wts, xx):
        y, aux = jax_moe.moe_apply(jcfg, JCTX, wts, xx)
        return jnp.sum(y * g) + aux

    jgw, jgx = jax.grad(jloss, argnums=(0, 1))(P.tree_map(jnp.asarray, w),
                                               jnp.asarray(x))
    pw = P.tree_map(lambda a: torch.from_numpy(a).requires_grad_(), w)
    px = torch.from_numpy(x).requires_grad_()
    y, aux = moe.moe_apply(pcfg, CTX, pw, px)
    ((y * torch.from_numpy(g)).sum() + aux).backward()
    assert_close(px.grad, jgx, 1e-4, "dx")
    for k in w:
        assert_close(pw[k].grad, jgw[k], 1e-4, f"d{k}")


def test_a2a_refuses_on_a_model_axis_and_is_dense_elsewhere():
    jcfg, pcfg = configs()
    w, x = layer_inputs(jcfg, 32)
    pw = P.tree_map(torch.from_numpy, w)
    mesh_ctx = ShardingCtx.for_mesh(make_elastic_mesh(1, 2, devices=[CPU] * 2))
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        moe.moe_apply(pcfg, mesh_ctx, pw, torch.from_numpy(x), impl="a2a")
    y_a2a, _ = moe.moe_apply(pcfg, CTX, pw, torch.from_numpy(x), impl="a2a")
    y, _ = moe.moe_apply(pcfg, CTX, pw, torch.from_numpy(x))
    assert torch.equal(y_a2a, y)


# --- the model -----------------------------------------------------------------


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


@pytest.mark.parametrize("which", ["model", "smoke"])
def test_param_counts_match_reference(which):
    jcfg = getattr(jax_registry.get(ARCH), which)
    pcfg = getattr(registry.get(ARCH), which)
    for active in (False, True):
        assert model_registry.param_count(pcfg, active) == \
            jax_model_registry.param_count(jcfg, active)
    assert pcfg.param_count() == jcfg.param_count()
    assert pcfg.active_param_count() == jcfg.active_param_count()
    if which == "model":
        assert (pcfg.param_count(), pcfg.active_param_count()) == (
            6_919_096_320, 1_281_951_744)
        # the card's training phase: the depth cut to 4
        cut = dataclasses.replace(pcfg, num_layers=4)
        assert cut.param_count() == 1_884_309_504


def test_dense_param_count_has_no_active_share():
    cfg = registry.get("smollm-135m").model
    assert cfg.active_param_count() == cfg.param_count() == 134_515_008


@pytest.mark.parametrize("prompt", [24, 23])
def test_f32_prefill_and_decode_match_reference(prompt):
    """Prefill, then 3 teacher-forced decode steps (each routes B tokens
    with capacity 4) after both packages pad the KV cache."""
    jcfg, pcfg = configs()
    jrun, prun = runs(ARCH)
    jprm, pprm = both_params(ARCH)
    B, gen = 2, 3
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (B, prompt + gen), dtype=np.int32)
    jl, jcache = jax_lm.prefill_fn(jcfg, jrun, JCTX, jprm,
                                   {"tokens": jnp.asarray(toks[:, :prompt])})
    pl, pcache = lm.prefill_fn(pcfg, prun, CTX, pprm,
                               {"tokens": torch.from_numpy(toks[:, :prompt])})
    assert_close(pl, jl, 1e-4, "prefill logits")
    check_caches(pcache, jcache, "prefill")
    jcache = jax_pad_cache(jcfg, jcache, gen)
    pcache = serve.pad_cache(pcfg, pcache, gen)
    assert pcache["k"].shape[2] == prompt + gen
    for i in range(gen):
        t = prompt + i
        jl, jcache = jax_lm.decode_fn(
            jcfg, jrun, JCTX, jprm, jcache,
            {"tokens": jnp.asarray(toks[:, t:t + 1]), "pos": jnp.int32(t)})
        pl, pcache = lm.decode_fn(
            pcfg, prun, CTX, pprm, pcache,
            {"tokens": torch.from_numpy(toks[:, t:t + 1]), "pos": t})
        assert_close(pl, jl, 1e-4, f"decode {i} logits")
        check_caches(pcache, jcache, f"decode {i}")


def test_loss_and_every_gradient_match_reference():
    """The reference on its jnp attention; the loss carries the routers'
    aux loss."""
    check_loss_and_grads(ARCH, 40)


def test_loss_through_the_flash_function_matches_reference(
        plain_forward_as_kernel, monkeypatch):
    """Attention through the flash Function (the kernel's place taken by
    the counted plain forward) under the bundle's block remat: the same
    loss and gradients; 2 launches a layer (the forward and the remat's),
    the count the card's train_olmoe phase asserts."""
    def through_function(q, k, v, **kw):
        return fa_ops.flash_attention(q, k, v, kw["causal"], kw["window"],
                                      kw["softcap"], use_kernel=True)

    monkeypatch.setattr(attention, "attention_auto", through_function)
    check_loss_and_grads(ARCH, 40, seed=5)
    b = registry.get(ARCH)
    assert (b.run.remat, b.run.scan_group) == ("block", 0)
    assert len(plain_forward_as_kernel) == 2 * b.smoke.num_layers


# --- the entry points and trainer checkpoints -------------------------------------


def test_serve_and_train_clis_run_olmoe_on_the_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "20",
         "--gen", "4"], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("arch=olmoe-1b-7b-smoke batch=2 device=cpu")
    ids = json.loads(lines[1].split(":", 1)[1])
    assert len(ids) == 4 and all(0 <= i < 256 for i in ids)
    out = tmp_path / "metrics.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--steps", "3", "--batch", "4",
         "--seq", "32", "--metrics-out", str(out)], env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    log = json.loads(out.read_text())
    assert [m["step"] for m in log] == [0, 1, 2]
    assert all(m["aux_loss"] > 0 for m in log)


def both_trainers(**kw):
    jb, pb = jax_registry.get(ARCH), registry.get(ARCH)
    jrun = jb.run.replace(compute_dtype="float32", microbatch_per_data_shard=0,
                          learning_rate=1e-3)
    prun = pb.run.replace(compute_dtype="float32", microbatch_per_data_shard=0,
                          learning_rate=1e-3)
    jkw = {k: v for k, v in kw.items() if k != "port_view"}
    jt = JaxTrainer(jb.smoke, jrun, global_batch=4, seq_len=32, seed=3, **jkw)
    pkw = dict(jkw)
    if "port_view" in kw:
        pkw["ckpt_view"] = kw["port_view"]
    pt = Trainer(pb.smoke, prun, global_batch=4, seq_len=32, seed=3,
                 device="cpu", **pkw)
    return jt, pt


def test_reference_and_port_trainers_give_the_same_losses():
    jt, pt = both_trainers()
    pt.restore_state(carried_state(jt))
    jt.train(3)
    pt.train(3)
    np.testing.assert_allclose([m["loss"] for m in pt.metrics_log],
                               [m["loss"] for m in jt.metrics_log],
                               rtol=0, atol=1e-4)
    for path, got, want in paired(pt.params, jt.params):
        assert_close(got, want, 1e-4, f"params {path}")


def test_reference_trainer_checkpoint_restores_in_port():
    jmf = R_mounts.make_mount("bento", n_blocks=32768)
    jt, _ = both_trainers(ckpt_view=jmf.view, ckpt_every=2)
    jt.train(2)
    jmf.close()
    view, _ks = _port_view_of(_image(jmf.dev))
    _, pt = both_trainers(port_view=view)
    assert pt.restore_checkpoint() and pt.step_idx == 2
    for tree_p, tree_j in ((pt.params, jt.params), (pt.opt_state, jt.opt_state)):
        for path, got, want in paired(tree_p, tree_j):
            assert np.array_equal(got.numpy(), np.asarray(want)), path


def test_port_trainer_checkpoint_restores_in_reference():
    pmf = T_mounts.make_mount("bento", n_blocks=32768, device="cpu")
    _, pt = both_trainers(port_view=pmf.view, ckpt_every=2)
    pt.train(2)
    pmf.close()
    view, _ks = _ref_view_of(_image(pmf.dev))
    jt, _ = both_trainers(ckpt_view=view)
    assert jt.restore_checkpoint() and jt.step_idx == 2
    for tree_p, tree_j in ((pt.params, jt.params), (pt.opt_state, jt.opt_state)):
        for path, got, want in paired(tree_p, tree_j):
            assert np.array_equal(got.numpy(), np.asarray(want)), path
