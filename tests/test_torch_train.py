"""The port's training path against the reference on the CPU: AdamW, the
training step with and without gradient accumulation, the trainer's
train -> fail -> recover -> upgrade -> restore -> serve story on a port
``bento`` mount, elastic rescale, state transfer, and trainer checkpoints
across the two packages.

Parameters and optimizer states are made once (numpy, or the reference's
own init) and carried into the port by ``params.from_reference`` and
``adamw.state_from_reference``. Tolerances, in float32: the optimizer
within 1e-6 x max(1, |ref|) element by element; the training step's loss,
metrics and updated parameters within 1e-4 x max(1, max|ref|); the two
trainers' losses over 5 steps within 1e-4; checkpoints bit for bit, with
the reference's treedef text for ``OptState``.
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

import repro.fs.mounts as R_mounts  # noqa: E402
import repro_torch.fs.mounts as T_mounts  # noqa: E402
from repro.configs import registry as jax_registry  # noqa: E402
from repro.configs.base import RunConfig as JaxRunConfig  # noqa: E402
from repro.distributed.sharding import ShardingCtx as JaxCtx  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.models import params as jax_params  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.train.step import make_train_step as jax_make_train_step  # noqa: E402
from repro.train.trainer import Trainer as JaxTrainer  # noqa: E402
from repro_torch.checkpoint import store as T_store  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.core.upgrade import transfer_state, upgrade  # noqa: E402
from repro_torch.distributed.sharding import ShardingCtx, gathered  # noqa: E402
from repro_torch.fs.ext4like import Ext4LikeFileSystem  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.mesh import make_elastic_mesh  # noqa: E402
from repro_torch.models import lm, params as P  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve.step import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.train import step as train_step  # noqa: E402
from repro_torch.train.trainer import Trainer, WorkerFailure  # noqa: E402
from test_torch_checkpoint import _port_view_of, _ref_view_of  # noqa: E402
from test_torch_fs_slice import _image, _ref_binding  # noqa: E402
from test_torch_rwkv import assert_close, random_reference_params  # noqa: E402

ARCH = "smollm-135m"
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
CPU = torch.device("cpu")


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jax.device_get(x), np.float32)


def close_each(got, want, rel, what):
    """|got - want| <= rel x max(1, |want|), element by element."""
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = rel * np.maximum(1.0, np.abs(want))
    assert (np.abs(got - want) <= bound).all(), \
        f"{what}: max|diff| {np.max(np.abs(got - want))}"


def paired(port, ref, path=()):
    """(path, port leaf, reference leaf) over two trees of dicts and
    OptStates, whatever the key order."""
    if isinstance(ref, dict):
        assert set(port) == set(ref), path
        for k in ref:
            yield from paired(port[k], ref[k], path + (k,))
    elif isinstance(ref, tuple):
        assert port._fields == ref._fields
        for name in ref._fields:
            yield from paired(getattr(port, name), getattr(ref, name),
                              path + (name,))
    elif ref is None:
        assert port is None, path
    else:
        yield path, port, ref


@pytest.fixture(autouse=True)
def bound(monkeypatch):
    """The reference's bento mounts hash with the same blockhash as the
    port's (its kernel binding swapped for ``blockhash_np``)."""
    monkeypatch.setattr(R_mounts, "kernel_binding", _ref_binding)


# --- the optimizer ------------------------------------------------------------------

OPT_CASES = {  # tests/test_optim.py's configurations
    "plain": (dict(learning_rate=0.05, weight_decay=0.0, grad_clip=0.0),
              (8, 8), 1.0),
    "decay_and_clip": (dict(learning_rate=0.05), (8, 8), 1.0),
    "factored": (dict(factored_second_moment=True), (16, 32), 1.0),
    "master": (dict(param_dtype="bfloat16", master_weights=True,
                    learning_rate=0.05, weight_decay=0.0), (8, 8), 1e-3),
    "clip_and_schedule": (dict(grad_clip=1.0), (8, 8), 1e6),
}


def opt_setup(kw, shape):
    """The reference's _setup (tests/test_optim.py), carried into the port."""
    jrun = JaxRunConfig(**kw)
    specs = {"w": jax_params.dense(shape, (None, None)),
             "b": jax_params.dense((shape[1],), (None,), init="zeros")}
    jp = jax_params.materialize(specs, jax.random.PRNGKey(0),
                                dtype=jrun.param_dtype)
    jo = jax_params.materialize(jax_adamw.adamw_init_specs(specs, jrun),
                                jax.random.PRNGKey(1), dtype="float32")
    if jrun.master_weights:  # the master tracks the params, as the test sets
        jo = jax_adamw.OptState(jo.step, jo.mu, jo.nu, jax.tree.map(
            lambda p: p.astype(jnp.float32), jp))
    pp = P.from_reference(jax.device_get(jp), CPU)
    po = adamw.state_from_reference(jax.device_get(jo), CPU)
    return jrun, RunConfig(**kw), jp, jo, pp, po


@pytest.mark.parametrize("start", [0, 300])  # in the warmup, past it
@pytest.mark.parametrize("n_steps", [1, 4])
@pytest.mark.parametrize("case", list(OPT_CASES))
def test_adamw_update_matches_reference(case, n_steps, start):
    kw, shape, gscale = OPT_CASES[case]
    jrun, prun, jp, jo, pp, po = opt_setup(kw, shape)
    jo = jo._replace(step=jnp.int32(start))
    po = po._replace(step=torch.tensor(start, dtype=torch.int32))
    rng = np.random.default_rng(5)
    for i in range(n_steps):
        g = {k: (gscale * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in pp.items()}
        jp, jo, jstats = jax_adamw.adamw_update(
            {k: jnp.asarray(v) for k, v in g.items()}, jp, jo, jrun)
        pp, po, pstats = adamw.adamw_update(
            {k: torch.from_numpy(v) for k, v in g.items()}, pp, po, prun)
        for k in ("grad_norm", "lr"):
            close_each(pstats[k], jstats[k], 1e-6, f"step {i} {k}")
    assert int(po.step) == int(jo.step) == start + n_steps
    for path, got, want in paired(pp, jp):
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
        if got.dtype == torch.bfloat16:  # the same f32 master, cast
            close_each(got, want, 2 ** -8, f"params {path}")
        else:
            close_each(got, want, 1e-6, f"params {path}")
    for path, got, want in paired(po, jo):
        close_each(got, want, 1e-6, f"state {path}")
    if case == "factored":
        assert set(po.nu["w"]) == {"_factored_row", "_factored_col"}
        assert po.nu["w"]["_factored_row"].shape == (shape[0],)
    if case == "master":
        assert torch.equal(pp["w"], po.master["w"].to(torch.bfloat16))


def test_cosine_schedule_matches_reference():
    for step in (0, 1, 100, 200, 201, 5000, 9999, 10_000, 12_000):
        close_each(adamw.cosine_schedule(torch.tensor(step, dtype=torch.int32),
                                         1e-3),
                   jax_adamw.cosine_schedule(jnp.int32(step), 1e-3), 1e-6,
                   f"lr at {step}")


def test_adamw_minimizes_quadratic():
    """tests/test_optim.py's quadratic, on the port alone."""
    run = RunConfig(learning_rate=0.05, weight_decay=0.0, grad_clip=0.0)
    g = torch.Generator().manual_seed(2)
    params = {"w": torch.randn(8, 8, generator=g), "b": torch.zeros(8)}
    state = P.materialize(adamw.adamw_init_specs(
        {"w": P.dense((8, 8), (None, None)), "b": P.dense((8,), (None,))},
        run), g, CPU)
    target = torch.randn(8, 8, generator=g)

    def loss(p):
        return torch.mean((p["w"] - target) ** 2) + torch.mean(p["b"] ** 2)

    l0 = float(loss(params))
    for _ in range(200):
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        grads = dict(zip(p, torch.autograd.grad(loss(p), list(p.values()))))
        params, state, _ = adamw.adamw_update(grads, params, state, run)
    assert float(loss(params)) < 0.01 * l0


# --- the training step --------------------------------------------------------------


@pytest.mark.parametrize("micro", [0, 2])  # 1 and 2 accumulation steps
def test_train_step_matches_reference(micro):
    jb, pb = jax_registry.get(ARCH), registry.get(ARCH)
    cfg = jb.smoke
    jrun = jb.run.replace(compute_dtype="float32",
                          microbatch_per_data_shard=micro)
    prun = pb.run.replace(compute_dtype="float32",
                          microbatch_per_data_shard=micro)
    gb, seq = 4, 32
    n_accum = train_step.num_accum_steps(prun, ShardingCtx.null(), gb)
    assert n_accum == (2 if micro else 1)
    np_params = random_reference_params(cfg, seed=8)
    jp = P.tree_map(jnp.asarray, np_params)
    jo = jax_params.materialize(
        jax_adamw.adamw_init_specs(jax_lm.param_specs(cfg), jrun),
        jax.random.PRNGKey(1), dtype="float32")
    jo = jo._replace(step=jnp.int32(300))  # past the warmup: a real step
    pp = P.from_reference(np_params, CPU)
    po = adamw.state_from_reference(jax.device_get(jo), CPU)
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (gb, seq + 1),
                                             dtype=np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jfn = jax_make_train_step(cfg, jrun, JaxCtx.null(), gb)
    jp2, jo2, jm = jfn(jp, jo, {k: jnp.asarray(v) for k, v in batch.items()})
    pfn = train_step.make_train_step(pb.smoke, prun, ShardingCtx.null(), gb)
    pp2, po2, pm = pfn(pp, po, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    assert set(pm) == set(jm)
    for k in pm:
        assert pm[k].dtype == torch.float32
        assert_close(pm[k], jm[k], 1e-4, k)
    for path, got, want in paired(pp2, jp2):
        assert_close(got, want, 1e-4, f"params {path}")
    for path, got, want in paired(po2, jo2):
        assert_close(got, want, 1e-4, f"state {path}")
    # nothing was updated in place
    for path, got, want in paired(pp, np_params):
        assert np.array_equal(got.numpy(), want), path


def test_eval_step_reports_the_loss_without_a_graph():
    b = registry.get(ARCH)
    cfg, run = b.smoke, b.run.replace(compute_dtype="float32")
    prm = P.materialize(lm.param_specs(cfg), torch.Generator().manual_seed(0),
                        CPU)
    toks = torch.randint(0, cfg.vocab_size, (2, 17),
                         generator=torch.Generator().manual_seed(1))
    m = train_step.make_eval_step(cfg, run, ShardingCtx.null())(
        prm, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    assert set(m) == {"loss", "nll", "z_loss", "aux_loss"}
    assert all(v.grad_fn is None and v.dtype == torch.float32
               for v in m.values())
    assert abs(float(m["loss"]) - float(m["nll"]) - float(m["z_loss"])) < 1e-5


# --- the trainer --------------------------------------------------------------------


def test_end_to_end_train_fail_upgrade_serve():
    """tests/test_system.py's story on the port, on the CPU: train with a
    checkpoint every 3 steps on a port bento mount, survive a failure at
    step 6, hot-upgrade the mounted fs from xv6 to ext4like, restore step
    12 in a second trainer and serve from its weights."""
    b = registry.get(ARCH)
    cfg = b.smoke
    run = b.run.replace(microbatch_per_data_shard=0, learning_rate=1e-3)
    mf = T_mounts.make_mount("bento", n_blocks=32768, device="cpu")
    armed = {"on": True}

    def failure_hook(step):
        if step == 6 and armed["on"]:
            armed["on"] = False
            raise WorkerFailure("rack power glitch")

    t = Trainer(cfg, run, global_batch=8, seq_len=64, ckpt_view=mf.view,
                ckpt_every=3, failure_hook=failure_hook, seed=3, device="cpu")
    t.train(12)
    losses = [m["loss"] for m in t.metrics_log]
    assert t.recoveries == 1
    assert t.step_idx == 12
    # the failure comes before step 6 runs; the recovery restores step 6's
    # checkpoint, so no step runs twice
    assert [m["step"] for m in t.metrics_log] == list(range(12))
    assert losses[-1] < losses[0], (losses[0], losses[-1])

    def migrate(state, _o, _n):
        state.setdefault("dirindex", {})
        return state

    stats = upgrade(mf.mount, Ext4LikeFileSystem(), migrate=migrate)
    assert stats["total_s"] < 5.0

    t2 = Trainer(cfg, run, global_batch=8, seq_len=64, ckpt_view=mf.view,
                 seed=3, device="cpu")
    assert t2.restore_checkpoint()
    assert t2.step_idx == 12
    for path, got, want in paired(t2.params, t.params):
        assert torch.equal(got, want), path
    for path, got, want in paired(t2.opt_state, t.opt_state):
        assert torch.equal(got, want), path

    ctx = ShardingCtx.null()
    prefill = make_prefill_step(cfg, run, ctx)
    decode = make_decode_step(cfg, run, ctx)
    tok, cache = prefill(t2.params, {"tokens": torch.ones((2, 16),
                                                          dtype=torch.int32)})
    cache = serve.pad_cache(cfg, cache, 8)
    assert cache["k"].shape[2] == 24
    for i in range(4):
        tok, cache = decode(t2.params, cache,
                            {"tokens": tok[:, None], "pos": 16 + i})
        assert tok.shape == (2,)
    mf.close()


def test_elastic_rescale_roundtrip():
    """Extract -> rebuild (null ctx -> a virtual (2, 2) mesh on the CPU)
    -> restore: the run carries on as an uninterrupted one."""
    b = registry.get(ARCH)
    run = b.run.replace(microbatch_per_data_shard=0)
    t = Trainer(b.smoke, run, global_batch=4, seq_len=32, device="cpu")
    t.train(3)
    mesh = make_elastic_mesh(2, 2, devices=[CPU] * 4)
    t.elastic_rescale(mesh)
    assert t.step_idx == 3 and t.mesh is mesh
    assert t.param_shardings["embed"]["embedding"].spec == ("model", "data")
    t.train(5)
    assert t.metrics_log[-1]["loss"] > 0
    t2 = Trainer(b.smoke, run, global_batch=4, seq_len=32, device="cpu")
    t2.train(5)
    assert abs(t2.metrics_log[-1]["loss"] - t.metrics_log[-1]["loss"]) < 1e-3


def test_trainer_module_state_transfer():
    """tests/test_upgrade.py's transfer_state between two trainers."""
    b = registry.get(ARCH)
    run = b.run.replace(microbatch_per_data_shard=0)
    t1 = Trainer(b.smoke, run, global_batch=2, seq_len=16, device="cpu")
    t1.train(3)
    t2 = Trainer(b.smoke, run, global_batch=2, seq_len=16, seed=99,
                 device="cpu")
    transfer_state(t1, t2)
    assert t2.step_idx == 3
    m = t2.train(5)
    assert m["loss"] > 0
    m1 = t1.train(5)
    assert abs(m1["loss"] - m["loss"]) < 1e-4


def test_trainer_and_cli_default_to_cuda():
    b = registry.get(ARCH)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(b.smoke, b.run, global_batch=2, seq_len=16)
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--steps", "1"], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr


def test_train_cli_runs_on_the_cpu(tmp_path):
    out = tmp_path / "metrics.json"
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--steps", "4", "--batch", "4",
         "--seq", "32", "--ckpt-every", "2", "--virtual-mesh", "2",
         "--metrics-out", str(out)], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("arch=smollm-135m-smoke device=cpu steps=4")
    log = json.loads(out.read_text())
    assert [m["step"] for m in log] == [0, 1, 2, 3]


# --- across the packages ------------------------------------------------------------


def carried_state(jt: JaxTrainer):
    """A reference trainer's state as the port's, leaf for leaf."""
    st = jt.extract_state()
    return {"params": P.from_reference(st["params"], CPU),
            "opt_state": adamw.state_from_reference(st["opt_state"], CPU),
            "step": st["step"], "seed": st["seed"]}


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
    jt.train(5)
    pt.train(5)
    jl = [m["loss"] for m in jt.metrics_log]
    pl = [m["loss"] for m in pt.metrics_log]
    assert len(jl) == len(pl) == 5
    np.testing.assert_allclose(pl, jl, rtol=0, atol=1e-4)
    for path, got, want in paired(pt.params, jt.params):
        assert_close(got, want, 1e-4, f"params {path}")


def _ckpt_tree_text(trainer) -> str:
    return str(T_store._flatten({"params": trainer.params,
                                 "opt": trainer.opt_state})[1])


def test_reference_trainer_checkpoint_restores_in_port():
    jmf = R_mounts.make_mount("bento", n_blocks=32768)
    jt, _ = both_trainers(ckpt_view=jmf.view, ckpt_every=3)
    jt.train(3)
    jmf.close()
    view, _ks = _port_view_of(_image(jmf.dev))
    _, pt = both_trainers(port_view=view)
    assert pt.restore_checkpoint() and pt.step_idx == 3
    man = json.loads(view.read_file("/ckpt/step_00000003/manifest.json"))
    want_td = str(jax.tree_util.tree_structure(
        {"params": jt.params, "opt": jt.opt_state}))
    assert "CustomNode(namedtuple[OptState]" in want_td
    assert man["treedef"] == want_td == _ckpt_tree_text(pt)
    assert isinstance(pt.opt_state, adamw.OptState)
    for path, got, want in paired(pt.params, jt.params):
        assert np.array_equal(got.numpy(), np.asarray(want)), path
    for path, got, want in paired(pt.opt_state, jt.opt_state):
        assert np.array_equal(got.numpy(), np.asarray(want)), path


def test_port_trainer_checkpoint_restores_in_reference():
    pmf = T_mounts.make_mount("bento", n_blocks=32768, device="cpu")
    _, pt = both_trainers(port_view=pmf.view, ckpt_every=3)
    pt.train(3)
    pmf.close()
    view, _ks = _ref_view_of(_image(pmf.dev))
    jt, _ = both_trainers(ckpt_view=view)
    assert jt.restore_checkpoint() and jt.step_idx == 3
    assert str(jax.tree_util.tree_structure(
        {"params": jt.params, "opt": jt.opt_state})) == _ckpt_tree_text(pt)
    for path, got, want in paired(pt.params, jt.params):
        assert np.array_equal(got.numpy(), np.asarray(want)), path
    for path, got, want in paired(pt.opt_state, jt.opt_state):
        assert np.array_equal(got.numpy(), np.asarray(want)), path


@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("factored", [False, True])
def test_optstate_treedef_text_matches_reference(master, factored):
    """The port's OptState flattens in field order with None as an empty
    subtree, renders as the reference's ``CustomNode(namedtuple[...])``,
    unflattens to the port's class. Its sharding trees keep a None field
    an empty subtree, so they have as many leaves as the state: the
    reference takes the field as a leaf, one more than its state has."""
    kw = dict(master_weights=master, factored_second_moment=factored)
    specs = {"w": P.dense((8, 16), (None, None)), "b": P.dense((16,), (None,))}
    jspecs = {"w": jax_params.dense((8, 16), (None, None)),
              "b": jax_params.dense((16,), (None,))}
    pstate = P.materialize(adamw.adamw_init_specs(specs, RunConfig(**kw)),
                           torch.Generator().manual_seed(0), CPU)
    jstate = jax_params.materialize(
        jax_adamw.adamw_init_specs(jspecs, JaxRunConfig(**kw)),
        jax.random.PRNGKey(0))
    for ptree, jtree in ((pstate, jstate),
                         ({"params": {"w": 1}, "opt": pstate},
                          {"params": {"w": 1}, "opt": jstate})):
        leaves, td = T_store._flatten(ptree)
        jleaves, jtd = jax.tree.flatten(jtree)
        assert str(td) == str(jax.tree_util.tree_structure(jtree))
        assert [tuple(np.shape(x)) for x in leaves] == [
            tuple(np.shape(x)) for x in jleaves]
        back = td.unflatten(leaves)
        assert T_store._flatten(back)[0] == leaves
        shard_leaves = T_store._flatten_shardings(ptree)
        assert len(shard_leaves) == len(leaves)
        assert len(jax.tree.flatten(jtree, is_leaf=lambda v: v is None)[0]
                   ) == len(leaves) + (not master)
    assert isinstance(td.unflatten(leaves)["opt"], adamw.OptState)


def test_mesh_trainer_checkpoint_saves_where_the_reference_raises():
    """A trainer on a mesh saves its state cut by the mesh's shardings and
    restores it onto another mesh's cells (compared gathered whole).
    Without master weights the reference's sharding tree has
    one leaf more than its state (OptState.master = None taken as a leaf)
    and its save raises; the port's repair (ROADMAP Queue 3)."""
    from repro.launch.mesh import make_host_mesh

    jb, pb = jax_registry.get(ARCH), registry.get(ARCH)
    run = pb.run.replace(microbatch_per_data_shard=0)
    jmf = R_mounts.make_mount("bento", n_blocks=8192)
    jt = JaxTrainer(jb.smoke, jb.run.replace(microbatch_per_data_shard=0),
                    global_batch=4, seq_len=16, mesh=make_host_mesh(1, 1),
                    ckpt_view=jmf.view)
    with pytest.raises(ValueError, match="35 leaves, model has 34"):
        jt.save_checkpoint()
    jmf.close()

    mf = T_mounts.make_mount("bento", n_blocks=32768, device="cpu")
    mesh = make_elastic_mesh(2, 2, devices=[CPU] * 4)
    t = Trainer(pb.smoke, run, global_batch=4, seq_len=16, mesh=mesh,
                ckpt_view=mf.view, ckpt_every=2, device="cpu")
    t.train(2)
    man = json.loads(mf.view.read_file("/ckpt/step_00000002/manifest.json"))
    assert man["extra"] == {"mesh_axes": {"data": 2, "model": 2},
                            "ruleset": "baseline"}
    assert max(len(r["shards"]) for r in man["leaves"]) == 4  # cut 2 x 2
    t2 = Trainer(pb.smoke, run, global_batch=4, seq_len=16,
                 mesh=make_elastic_mesh(1, 2, devices=[CPU] * 2),
                 ckpt_view=mf.view, device="cpu")
    assert t2.restore_checkpoint() and t2.step_idx == 2
    for path, got, want in paired(gathered(t2.params), gathered(t.params)):
        assert torch.equal(got, want), path
    for path, got, want in paired(gathered(t2.opt_state),
                                  gathered(t.opt_state)):
        assert torch.equal(got, want), path
    mf.close()


@pytest.mark.parametrize("group,remat", [(0, False), (0, True), (2, True),
                                         (3, True), (4, True)])
def test_grouped_scan_matches_reference(group, remat):
    """The layer loop (flat, grouped in 2 or 3 with two-level remat, and a
    group that does not divide the depth) against the reference's
    ``lax.scan``: the carry, the stacked outputs and the gradient of the
    stacked weights."""
    from repro.models.scan_utils import grouped_scan as jax_grouped_scan
    from repro_torch.models.scan_utils import grouped_scan

    rng = np.random.default_rng(12)
    w = rng.standard_normal((6, 4, 4)).astype(np.float32) * 0.5
    x0 = rng.standard_normal((2, 4)).astype(np.float32)

    def jbody(c, x):
        h = jnp.tanh(c @ x["a"])
        return h, {"h": h.sum(-1)}

    def jloss(wa):
        c, ys = jax_grouped_scan(jbody, jnp.asarray(x0), {"a": wa}, 6, group,
                                 remat)
        return c.sum() + ys["h"].sum(), (c, ys["h"])

    (_, (jc, jys)), jg = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(w))

    def body(c, x):
        h = torch.tanh(c @ x["a"])
        return h, {"h": h.sum(-1)}

    wa = torch.from_numpy(w).requires_grad_()
    c, ys = grouped_scan(body, torch.from_numpy(x0), {"a": wa}, 6, group,
                         remat)
    (c.sum() + ys["h"].sum()).backward()
    assert_close(c.detach(), jc, 1e-5, "carry")
    assert_close(ys["h"].detach(), jys, 1e-5, "stacked outputs")
    assert_close(wa.grad, jg, 1e-5, "gradient")
