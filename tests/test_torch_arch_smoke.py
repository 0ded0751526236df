"""Every architecture of the registry in the port against the reference on
the CPU: the port's counterpart of tests/test_arch_smoke.py, each case held
against ``repro`` at the same parameters.

For each of the ten arch ids, the smoke config's parameters are drawn once
with numpy from a fixed seed, every leaf random (the VLM's gates too, so
its cross layers count), and handed to both packages; the batch is the
reference test's (tokens and labels all ones, the stub embeddings 0.02
everywhere). In float32 the forward loss and its metrics, then one
training step's loss, gradient norm, new parameters and optimizer state
agree within 1e-4 x max(1, |ref|), the tolerance of
tests/test_torch_train.py; in the bundle's own bfloat16 compute the port's
loss is finite, as the reference test asks of the reference.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import registry as jax_registry  # noqa: E402
from repro.distributed.sharding import ShardingCtx as JaxCtx  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.models import params as jax_params  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.train.step import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.distributed.sharding import ShardingCtx  # noqa: E402
from repro_torch.models import lm, params as P  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import step as train_step  # noqa: E402
from test_torch_rwkv import assert_close, random_reference_params  # noqa: E402
from test_torch_train import paired  # noqa: E402

ARCHS = jax_registry.arch_ids()
JCTX, CTX = JaxCtx.null(), ShardingCtx.null()
CPU = torch.device("cpu")
B, S = 2, 32


def np_batch(cfg):
    """tests/test_arch_smoke.py's batch, as numpy (the embeddings in
    bfloat16, ml_dtypes' type)."""
    batch = {"tokens": np.ones((B, S), np.int32),
             "labels": np.ones((B, S), np.int32)}
    stub = {"vlm": ("image_embeds", cfg.num_image_tokens),
            "audio": ("frame_embeds", cfg.encoder_seq)}
    if cfg.family in stub:
        name, n = stub[cfg.family]
        batch[name] = np.asarray(0.02 * jnp.ones((B, n, cfg.d_model),
                                                 jnp.bfloat16))
    return batch


def both_batches(cfg):
    nb = np_batch(cfg)
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            P.from_reference(nb, device=CPU))


def both_runs(arch, **kw):
    return (jax_registry.get(arch).run.replace(compute_dtype="float32", **kw),
            registry.get(arch).run.replace(compute_dtype="float32", **kw))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss(arch):
    jcfg, pcfg = jax_registry.get(arch).smoke, registry.get(arch).smoke
    jrun, prun = both_runs(arch)
    np_params = random_reference_params(jcfg, seed=0)
    jprm = P.tree_map(jnp.asarray, np_params)
    pprm = P.from_reference(np_params, device=CPU)
    jb, pb = both_batches(jcfg)
    jloss, jmet = jax_lm.loss_fn(jcfg, jrun, JCTX, jprm, jb)
    with torch.no_grad():
        loss, met = lm.loss_fn(pcfg, prun, CTX, pprm, pb)
    assert loss.shape == () and loss.dtype == torch.float32
    assert_close(loss, jloss, 1e-4, f"{arch} loss")
    assert set(met) == set(jmet)
    for k in met:
        assert_close(met[k], jmet[k], 1e-4, f"{arch} {k}")
    assert met["nll"] > 0

    # the bundle's own compute dtype (bfloat16), parameters in it too
    run = registry.get(arch).run
    prm16 = P.tree_map(lambda t: t.to(P.torch_dtype(run.compute_dtype)),
                       pprm)
    with torch.no_grad():
        loss16, met16 = lm.loss_fn(pcfg, run, CTX, prm16, pb)
    assert bool(torch.isfinite(loss16)), f"{arch}: non-finite loss"
    assert met16["nll"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step(arch):
    """One step of the trainer's step function (no accumulation, as the
    reference test runs it) past the warm-up: the metrics, every new
    parameter and every optimizer-state leaf."""
    jcfg, pcfg = jax_registry.get(arch).smoke, registry.get(arch).smoke
    jrun, prun = both_runs(arch, microbatch_per_data_shard=0)
    np_params = random_reference_params(jcfg, seed=1)
    jp = P.tree_map(jnp.asarray, np_params)
    jo = jax_params.materialize(
        jax_adamw.adamw_init_specs(jax_lm.param_specs(jcfg), jrun),
        jax.random.PRNGKey(1), dtype="float32")
    jo = jo._replace(step=jnp.int32(300))
    pp = P.from_reference(np_params, CPU)
    po = adamw.state_from_reference(jax.device_get(jo), CPU)
    jb, pb = both_batches(jcfg)
    jp2, jo2, jm = jax_make_train_step(jcfg, jrun, JCTX, B)(jp, jo, jb)
    pp2, po2, pm = train_step.make_train_step(pcfg, prun, CTX, B)(pp, po, pb)
    assert set(pm) == set(jm)
    for k in pm:
        assert pm[k].dtype == torch.float32
        assert_close(pm[k], jm[k], 1e-4, f"{arch} {k}")
    assert pm["grad_norm"] > 0, f"{arch}: zero gradient"
    for path, got, want in paired(pp2, jp2):
        assert got.shape == want.shape and got.dtype == torch.float32
        assert_close(got, want, 1e-4, f"{arch} params {path}")
    for path, got, want in paired(po2, jo2):
        assert_close(got, want, 1e-4, f"{arch} state {path}")


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_reference(arch):
    jb, pb = jax_registry.get(arch), registry.get(arch)
    for which in ("model", "smoke"):
        jcfg, pcfg = getattr(jb, which), getattr(pb, which)
        assert pcfg.param_count() == jcfg.param_count() > 0, which
        assert pcfg.active_param_count() == jcfg.active_param_count()
        assert 0 < pcfg.active_param_count() <= pcfg.param_count()
        if pcfg.is_moe:
            assert pcfg.active_param_count() < pcfg.param_count()
