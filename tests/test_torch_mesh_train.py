"""The port's trainer partitioned over its mesh, on virtual CPU meshes,
against the reference's trainer under GSPMD on fake host devices.

The reference runs in one subprocess on 4 fake host devices
(``test_torch_spmd.run_reference``): smollm-135m's smoke config, f32
compute, the factored second moment and global-norm clipping on, on the
meshes (2, 2), (4, 1) and (1, 2), each from the same initial state, which
the port carries over. Held:

  * every parameter and optimizer leaf of the port's trainer is a
    ``MeshArray`` whose tensor at each mesh position has the shape the
    reference's device there holds (exact);
  * the losses of 3 steps within 1e-4, and the parameters and optimizer
    state after them within 1e-4 x max(1, max|ref|) a leaf: the
    tolerances of ``test_torch_train.py``'s trainer differential.

In the port alone: the parameters after 3 steps on (1, 1), (2, 1), (1, 2)
and (2, 2) within 1e-5 of each other, relative to a leaf's largest value
(a gradient summed over ``model``, or a block counted twice in the clip
norm, moves them by far more); rwkv6 on (2, 1) and zamba2 on (2, 1), (1, 2)
and (2, 2) against (1, 1);
the flash launches of a partitioned step; each cell's bytes at rest
against the dry-run's; checkpoints: the files of a partitioned trainer
byte for byte those of its whole leaves at the same grid, restores
across the packages and elastic rescales bit for bit; and the error of a
mesh over devices the host lacks. Against the reference too: olmoe's MoE
token groups that span data cells, on (2, 2) in two microbatches and on
(4, 1) at 8 x 1024 (a group over 2 of the 4 cells), in a second
subprocess. The tensor parallelism over ``model``
inside the step, olmoe's a2a MoE included, is held in
``test_torch_tensor_parallel.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.fs.mounts as R_mounts  # noqa: E402
import repro_torch.fs.mounts as T_mounts  # noqa: E402
from repro.configs import registry as jax_registry  # noqa: E402
from repro.train.trainer import Trainer as JaxTrainer  # noqa: E402
from repro_torch import checkpoint as T_ck  # noqa: E402
from repro_torch.checkpoint import store as T_store  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.distributed import tensor_parallel  # noqa: E402
from repro_torch.distributed.sharding import (MeshArray, ShardingCtx,  # noqa: E402
                                              gathered)
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.launch import dryrun, programs  # noqa: E402
from repro_torch.launch.mesh import (make_elastic_mesh, make_host_mesh,  # noqa: E402
                                     make_mesh)
from repro_torch.models import attention, moe, params as P  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import step as train_step  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402
from test_torch_checkpoint import _port_view_of, _ref_view_of  # noqa: E402
from test_torch_fs_slice import _image, _ref_binding  # noqa: E402
from test_torch_rwkv import assert_close  # noqa: E402
from test_torch_spmd import SRC, run_reference  # noqa: E402

ARCH = "smollm-135m"
CPU = torch.device("cpu")
MESHES = ((2, 2), (4, 1), (1, 2))
RUN = dict(compute_dtype="float32", factored_second_moment=True,
           learning_rate=1e-3, grad_clip=1.0)
BATCH, SEQ, SEED, STEPS = 8, 16, 3, 3


@pytest.fixture(autouse=True)
def bound(monkeypatch):
    """The reference's bento mounts hash with the same blockhash as the
    port's (its kernel binding swapped for ``blockhash_np``)."""
    monkeypatch.setattr(R_mounts, "kernel_binding", _ref_binding)


def virtual(d: int, m: int):
    return make_elastic_mesh(d, m, devices=[CPU] * (d * m))


def port_run(arch=ARCH, **kw):
    return registry.get(arch).run.replace(**{**RUN, **kw})


def trainer(mesh, arch=ARCH, remat=None, **kw):
    b = registry.get(arch)
    run = port_run(arch)
    if remat is not None:
        run = run.replace(remat=remat)
    return Trainer(b.smoke, run, global_batch=BATCH, seq_len=SEQ,
                   seed=SEED, mesh=mesh, device="cpu", **kw)


def leaves(t):
    return T_store._flatten({"params": t.params, "opt": t.opt_state})[0]


def whole_state(t):
    return T_store._flatten({"params": gathered(t.params),
                             "opt": gathered(t.opt_state)})[0]


# --- against the reference on fake host devices ----------------------------------------

REF_TRAIN = """
from repro.configs import registry
from repro.launch.mesh import make_host_mesh
from repro.train.trainer import Trainer
b = registry.get(inp["arch"])
run = b.run.replace(**inp["run"])
for d, m in inp["meshes"]:
    mesh = make_host_mesh(d, m)
    t = Trainer(b.smoke, run, global_batch=inp["batch"], seq_len=inp["seq"],
                seed=inp["seed"], mesh=mesh)
    if "init" not in out:
        st = t.extract_state()
        out["init"] = {"params": st["params"], "opt": st["opt_state"]}

    def shapes(leaf):
        by_dev = {s.device: list(s.data.shape) for s in leaf.addressable_shards}
        return [by_dev[dv] for dv in mesh.devices.flat]
    out[f"{d}x{m}/shapes"] = json.dumps([shapes(leaf) for leaf in jax.tree.leaves(
        {"params": t.params, "opt": t.opt_state})])
    t.train(inp["steps"])
    out[f"{d}x{m}/losses"] = np.array([m_["loss"] for m_ in t.metrics_log])
    st = t.extract_state()
    out[f"{d}x{m}/final"] = {"params": st["params"], "opt": st["opt_state"]}
"""


@pytest.fixture(scope="module")
def reference():
    body = "import json\n" + REF_TRAIN
    return run_reference(body, {"arch": ARCH, "run": RUN, "meshes": MESHES,
                                "batch": BATCH, "seq": SEQ, "seed": SEED,
                                "steps": STEPS}, 4)


def carried(init):
    return {"params": P.from_reference(init["params"], CPU),
            "opt_state": adamw.state_from_reference(init["opt"], CPU),
            "step": 0, "seed": SEED}


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_partitioned_trainer_matches_reference_on_its_mesh(reference,
                                                           mesh_shape):
    d, m = mesh_shape
    key = f"{d}x{m}"
    t = trainer(virtual(d, m))
    t.restore_state(carried(reference["init"]))
    got = leaves(t)
    assert all(isinstance(x, MeshArray) for x in got)
    assert [[list(s.shape) for s in x.shards] for x in got] == json.loads(
        str(reference[f"{key}/shapes"]))
    t.train(STEPS)
    np.testing.assert_allclose([x["loss"] for x in t.metrics_log],
                               reference[f"{key}/losses"], rtol=0, atol=1e-4)
    want = jax.tree.leaves(reference[f"{key}/final"])
    have = whole_state(t)
    assert len(have) == len(want)
    for i, (g, w) in enumerate(zip(have, want)):
        assert_close(g, w, 1e-4, f"{key} leaf {i}")


# --- the port's own mesh invariance --------------------------------------------------------


def relative_gap(a_tree, b_tree) -> float:
    """The largest per-leaf max|a - b| / max|b|."""
    gap = 0.0
    for a, b in zip(P.leaves(a_tree), P.leaves(b_tree)):
        scale = b.abs().max().item() or 1.0
        gap = max(gap, (a - b).abs().max().item() / scale)
    return gap


@pytest.mark.parametrize("arch,meshes", [
    (ARCH, ((2, 1), (1, 2), (2, 2))),
    ("rwkv6-7b", ((2, 1),)),
    ("zamba2-7b", ((2, 1), (1, 2), (2, 2)))])
def test_parameters_do_not_depend_on_the_mesh(arch, meshes):
    """Clipping (the smoke's gradient norms are above 1) and the factored
    second moment on; 3 steps from one seed."""
    base = trainer(virtual(1, 1), arch)
    base.train(STEPS)
    assert base.metrics_log[0]["grad_norm"] > RUN["grad_clip"]
    want = gathered(base.params)
    for d, m in meshes:
        t = trainer(virtual(d, m), arch)
        t.train(STEPS)
        gap = relative_gap(gathered(t.params), want)
        assert gap <= 1e-5, (arch, (d, m), gap)
        for metric in ("loss", "grad_norm"):  # grad_norm: the clip norm
            np.testing.assert_allclose(
                [x[metric] for x in t.metrics_log],
                [x[metric] for x in base.metrics_log], rtol=1e-5)


def test_unpartitioned_trainer_and_a_one_cell_mesh_agree():
    """mesh=None runs today's step; a (1, 1) mesh the partitioned one, to
    the same parameters."""
    a, b = trainer(None), trainer(virtual(1, 1))
    assert not isinstance(a.params["embed"]["embedding"], MeshArray)
    assert isinstance(b.params["embed"]["embedding"], MeshArray)
    a.train(2)
    b.train(2)
    assert relative_gap(gathered(b.params), a.params) <= 1e-6


@pytest.fixture
def counted_flash(monkeypatch):
    """The kernel's place taken by the plain forward, counted, and the
    model's attention sent through the flash Function, as on the card."""
    calls = []

    def fwd(q, k, v, *, causal, window, softcap):
        calls.append(tuple(q.shape))
        return fa_ref.attention(q, k, v, causal=causal, window=window,
                                softcap=softcap)

    def through_function(q, k, v, **kw):
        return fa_ops.flash_attention(q, k, v, kw["causal"], kw["window"],
                                      kw["softcap"], use_kernel=True)

    monkeypatch.setattr(FK, "flash_attention_fwd", fwd)
    monkeypatch.setattr(attention, "attention_auto", through_function)
    return calls


def partitioned_flash_launches(cfg, run, mesh_shape, global_batch) -> int:
    """Flash launches of one partitioned step: every cell runs each
    layer's forward and its rematerialised forward once a microbatch."""
    d, m = mesh_shape
    n_accum = train_step.num_accum_steps(
        run, ShardingCtx.for_mesh(virtual(d, m)), global_batch)
    return d * m * n_accum * 2 * cfg.num_layers


def test_partitioned_step_launches_flash_in_every_cell(counted_flash):
    b = registry.get(ARCH)
    run = b.run  # bf16 compute, block remat, microbatches of 4
    t = Trainer(b.smoke, run, global_batch=BATCH, seq_len=SEQ, seed=SEED,
                mesh=virtual(2, 2), device="cpu")
    t.train(1)
    want = partitioned_flash_launches(b.smoke, run, (2, 2), BATCH)
    assert len(counted_flash) == want == 4 * 1 * 2 * b.smoke.num_layers
    # each cell's microbatch: its data cell's 4 rows
    assert set(counted_flash) == {(BATCH // 2, SEQ, b.smoke.num_heads,
                                   b.smoke.head_dim)}


def cell_bytes(t, pos: int) -> int:
    return sum(x.shards[pos].numel() * x.shards[pos].element_size()
               for x in leaves(t))


def test_each_cell_holds_the_dry_runs_argument_bytes():
    b = registry.get(ARCH)
    t = trainer(virtual(2, 2))
    mesh = make_mesh((2, 2), ("data", "model"), [torch.device("meta")] * 4)
    prog = programs.build_program(
        b.smoke, port_run(), ShapeSpec("t", "train", SEQ, BATCH),
        ShardingCtx.for_mesh(mesh))
    state = dataclasses.replace(prog, args=prog.args[:2],
                                arg_shardings=prog.arg_shardings[:2])
    want = dryrun.argument_bytes(state)
    assert [cell_bytes(t, p) for p in range(4)] == [want] * 4
    whole = sum(x.nbytes for x in leaves(t))
    assert whole / 4 < want < whole


def test_dry_run_counts_the_partitioned_steps_collectives(tmp_path):
    """The 16 x 16 mesh: the step's first cell traced alone; its
    all-gathers (one a cut dim of a parameter, but the ``model`` dim of
    a leaf the cell keeps as its own ``model`` shard), reduce-scatters
    (one a parameter the data axis cuts) and all-reduces are counted."""
    r = dryrun.run_cell(ARCH, "train_4k", "single", "baseline",
                        str(tmp_path), smoke=True)
    assert r["ok"] and r["collectives_not_issued"] is None
    cfg = registry.get(ARCH).smoke
    mesh = dryrun._meta_mesh((16, 16), ("data", "model"))
    ctx = ShardingCtx.for_mesh(mesh)
    pspecs = train_step.lm.param_specs(cfg)
    specs = [ctx.spec(s.logical, s.shape) for s in P.leaves(pspecs)]
    plan = tensor_parallel.plan_for(
        cfg, pspecs, P.map_specs(lambda s: ctx.spec(s.logical, s.shape),
                                 pspecs), {"data": 16, "model": 16},
        ("data",))
    local = P.leaves(tensor_parallel.local_leaves(plan, pspecs))
    assert plan.mlp and plan.vocab and not plan.attn
    per_op = r["ops"]["per_op"]
    assert per_op["all-gather"]["count"] == sum(
        e is not None and not (loc and e == "model")
        for s, loc in zip(specs, local, strict=True) for e in s)
    assert per_op["reduce-scatter"]["count"] == sum(
        any(e == "data" for e in s) for s in specs)
    assert per_op["all-reduce"]["count"] >= 2  # the clip norm, the loss
    assert r["ops"]["collective_wire_bytes"] > 0


# --- checkpoints -----------------------------------------------------------------------------


def files_under(view, root: str) -> dict:
    return {name: view.read_file(f"{root}/{name}")
            for name in sorted(view.listdir(root))}


def test_partitioned_checkpoint_files_are_those_of_whole_leaves():
    """The same state saved from its mesh cells and saved whole at the
    same grid: the same files, byte for byte."""
    mf = T_mounts.make_mount("bento", n_blocks=32768, device="cpu")
    t = trainer(virtual(2, 2), ckpt_view=mf.view)
    t.train(2)
    t.save_checkpoint()
    st = t.extract_state()
    mf2 = T_mounts.make_mount("bento", n_blocks=32768, device="cpu")
    T_ck.save(mf2.view, "/ckpt/step_00000002",
              {"params": st["params"], "opt": st["opt_state"]}, step=2,
              shardings=t._ckpt_shardings(),
              extra={"mesh_axes": {"data": 2, "model": 2},
                     "ruleset": "baseline"})
    got = files_under(mf.view, "/ckpt/step_00000002")
    assert len(got) > 1 + len(leaves(t))  # some leaves cut in several files
    assert got == files_under(mf2.view, "/ckpt/step_00000002")
    mf.close()
    mf2.close()


def ref_trainer(**kw):
    jb = jax_registry.get(ARCH)
    return JaxTrainer(jb.smoke, jb.run.replace(**RUN), global_batch=BATCH,
                      seq_len=SEQ, seed=SEED, **kw)


def test_partitioned_checkpoint_restores_in_reference():
    pmf = T_mounts.make_mount("bento", n_blocks=32768, device="cpu")
    pt = trainer(virtual(2, 2), ckpt_view=pmf.view, ckpt_every=2)
    pt.train(2)
    pmf.close()
    view, _ks = _ref_view_of(_image(pmf.dev))
    jt = ref_trainer(ckpt_view=view)
    assert jt.restore_checkpoint() and jt.step_idx == 2
    want = jax.tree.leaves({"params": jt.params, "opt": jt.opt_state})
    for got, w in zip(whole_state(pt), want, strict=True):
        assert np.array_equal(got.numpy(), np.asarray(w))


def test_reference_checkpoint_restores_onto_a_mesh():
    jmf = R_mounts.make_mount("bento", n_blocks=32768)
    jt = ref_trainer(ckpt_view=jmf.view, ckpt_every=2)
    jt.train(2)
    jmf.close()
    view, _ks = _port_view_of(_image(jmf.dev))
    pt = trainer(virtual(2, 2), ckpt_view=view)
    assert pt.restore_checkpoint() and pt.step_idx == 2
    assert all(isinstance(x, MeshArray) for x in leaves(pt))
    want = jax.tree.leaves({"params": jt.params, "opt": jt.opt_state})
    for got, w in zip(whole_state(pt), want, strict=True):
        assert np.array_equal(got.numpy(), np.asarray(w))
    pt.train(3)  # and trains on from there
    assert pt.step_idx == 3


def test_elastic_rescale_keeps_the_state_bit_exact():
    """(2, 2) -> (4, 1) -> (1, 1): after each rescale, and after each
    restore of the (2, 2) checkpoint onto the new cells, the gathered
    state is the one saved."""
    mf = T_mounts.make_mount("bento", n_blocks=32768, device="cpu")
    t = trainer(virtual(2, 2), ckpt_view=mf.view)
    t.train(2)
    t.save_checkpoint()
    before = whole_state(t)
    for d, m in ((4, 1), (1, 1)):
        t.elastic_rescale(virtual(d, m))
        assert [x.sharding.mesh for x in leaves(t)] == [t.mesh] * len(before)
        assert all(torch.equal(a, b) for a, b in zip(whole_state(t), before))
        assert t.restore_checkpoint() and t.step_idx == 2
        assert all(len(x.shards) == d * m for x in leaves(t))
        assert all(torch.equal(a, b) for a, b in zip(whole_state(t), before))
    t.train(3)
    assert t.step_idx == 3
    mf.close()


def test_a2a_trainer_checkpoints_and_rescales_bit_exact():
    """olmoe's a2a MoE partitioned over (2, 2) (ruleset ``moe_a2a``):
    saved, rescaled to (1, 2) and to (1, 4), restored onto each bit for
    bit, and trained on from there."""
    b = registry.get("olmoe-1b-7b")
    run = b.run.replace(**RUN, moe_impl="a2a")
    mf = T_mounts.make_mount("bento", n_blocks=32768, device="cpu")
    t = Trainer(b.smoke, run, global_batch=BATCH, seq_len=SEQ, seed=SEED,
                mesh=virtual(2, 2), ruleset="moe_a2a", ckpt_view=mf.view,
                device="cpu")
    t.train(2)
    t.save_checkpoint()
    before = whole_state(t)
    for d, m in ((1, 2), (1, 4)):
        t.elastic_rescale(virtual(d, m), ruleset="moe_a2a")
        assert all(torch.equal(a, w) for a, w in zip(whole_state(t), before))
        assert t.restore_checkpoint() and t.step_idx == 2
        assert all(torch.equal(a, w) for a, w in zip(whole_state(t), before))
    t.train(3)
    assert t.step_idx == 3 and np.isfinite(t.metrics_log[-1]["loss"])
    mf.close()


@pytest.mark.parametrize("arch,mesh_shape", [("smollm-135m", (2, 2)),
                                             ("olmoe-1b-7b", (1, 2))])
def test_tape_without_remat_gives_the_remat_steps_parameters(arch,
                                                             mesh_shape):
    """``remat="none"``: each segment keeps its graph instead of running
    again in the backward, to the same parameters."""
    kept, rerun = (trainer(virtual(*mesh_shape), arch, remat=r)
                   for r in ("none", "block"))
    kept.train(STEPS)
    rerun.train(STEPS)
    assert relative_gap(gathered(kept.params), gathered(rerun.params)) <= 1e-6


# --- errors ------------------------------------------------------------------------------------


def test_a_mesh_over_devices_the_host_lacks_raises():
    with pytest.raises(RuntimeError, match="need 2 devices"):
        make_host_mesh(2, 1)
    env = {**os.environ, "PYTHONPATH": SRC}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--steps", "1", "--data-mesh", "2"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "need 2 devices" in proc.stderr


# --- MoE token groups across the data cells ------------------------------------------

# olmoe's smoke config: on (2, 2) in two microbatches of 2 rows a data
# cell, a token group of 64 is global microbatch i, over both data cells;
# on (4, 1) at 8 x 1024, a group of 4096 spans 2 of the 4 data cells
GROUP_CASES = {"microbatches": ((2, 2), SEQ, {"microbatch_per_data_shard": 2}),
               "some_cells": ((4, 1), 1024, {"microbatch_per_data_shard": 0})}

REF_GROUPS = """
from repro.configs import registry
from repro.launch.mesh import make_host_mesh
from repro.train.trainer import Trainer
b = registry.get(inp["arch"])
for key, ((d, m), seq, run_kw) in inp["cases"].items():
    run = b.run.replace(**inp["run"], **run_kw)
    t = Trainer(b.smoke, run, global_batch=inp["batch"], seq_len=seq,
                seed=inp["seed"], mesh=make_host_mesh(d, m))
    st = t.extract_state()
    out[f"{key}/init"] = {"params": st["params"], "opt": st["opt_state"]}
    t.train(inp["steps"])
    out[f"{key}/losses"] = np.array([m_["loss"] for m_ in t.metrics_log])
    st = t.extract_state()
    out[f"{key}/final"] = {"params": st["params"], "opt": st["opt_state"]}
"""


@pytest.fixture(scope="module")
def group_reference():
    return run_reference(REF_GROUPS, {
        "arch": "olmoe-1b-7b", "run": RUN, "cases": GROUP_CASES,
        "batch": BATCH, "seed": SEED, "steps": STEPS}, 4)


@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_moe_groups_across_the_data_cells_match_reference(group_reference,
                                                          case):
    """The rows routed together are the reference's token groups of its
    global microbatch: each data cell's microbatch i is block i of the
    global one (``step._by_microbatch``), and a group that crosses an
    edge between cells is routed from the gathered router logits."""
    (d, m), seq, run_kw = GROUP_CASES[case]
    b = registry.get("olmoe-1b-7b")
    run = b.run.replace(**RUN, **run_kw)
    t = Trainer(b.smoke, run, global_batch=BATCH, seq_len=seq, seed=SEED,
                mesh=virtual(d, m), device="cpu")
    n_accum = train_step.num_accum_steps(run, t.ctx, BATCH)
    assert n_accum == (2 if case == "microbatches" else 1)
    tokens = BATCH // n_accum // d * seq  # a data cell's microbatch
    group, spans = moe.moe_groups(tokens, d)
    assert spans and group == (tokens * d if case == "microbatches"
                               else 2 * tokens)
    t.restore_state(carried(group_reference[f"{case}/init"]))
    t.train(STEPS)
    np.testing.assert_allclose([x["loss"] for x in t.metrics_log],
                               group_reference[f"{case}/losses"], rtol=0,
                               atol=1e-4)
    want = jax.tree.leaves(group_reference[f"{case}/final"])
    have = whole_state(t)
    assert len(have) == len(want)
    for i, (g, w) in enumerate(zip(have, want)):
        assert_close(g, w, 1e-4, f"{case} leaf {i}")


def test_train_cli_trains_on_a_virtual_mesh(tmp_path):
    out = tmp_path / "metrics.json"
    env = {**os.environ, "PYTHONPATH": SRC}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--steps", "3", "--batch", "4",
         "--seq", "32", "--virtual-mesh", "2", "--metrics-out", str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    log = json.loads(out.read_text())
    assert [x["step"] for x in log] == [0, 1, 2]
    assert all(np.isfinite(x["loss"]) for x in log)
