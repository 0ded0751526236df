"""Tensor parallelism over ``model`` in the port's partitioned training
step (``distributed.tensor_parallel``, ``models.transformer``'s segmented
stack), on virtual CPU meshes, against the reference's trainer under
GSPMD on fake host devices.

The reference runs in one subprocess on 4 fake host devices
(``test_torch_spmd.run_reference``): olmoe-1b-7b's smoke config, f32
compute, the factored second moment and global-norm clipping on, the
dense dispatch on (2, 2), (1, 2) and (1, 4) and the expert-parallel a2a
(``moe_impl="a2a"``, ruleset ``moe_a2a``) on (1, 2) and (2, 2), each
from the same initial state, which the port carries over. Held: each
cell's shapes at rest (exact), the losses of 3 steps within 1e-4, the
parameters and optimizer state after them within 1e-4 x max(1,
max|ref|) a leaf (``test_torch_mesh_train.py``'s tolerances).

The VLM (llama-3.2-vision-11b's smoke config: 4 layers in super-blocks
of a self and a cross layer, 4 q and 2 kv heads), its gates drawn away
from 0, on (2, 2) and (1, 2), against the reference the same way: each
cell computes with its own heads of the self and the cross attention,
its MLP columns and its vocabulary rows.

whisper-small's, rwkv6-7b's and zamba2-7b's smoke configs on (2, 2) and
(1, 2), the same way: whisper's encoder and decoder on each cell's heads
(its encoder's output entering each decoder cross layer), MLP columns and
vocabulary; rwkv6's time mix on each cell's WKV heads (its ``ln_x`` over
all of ``d`` from the group's sum of squares), its channel mix on the
cell's columns, the vocabulary; zamba2's Mamba2 blocks on each cell's SSD
heads (``w_in`` gathered inside the tape, the gated norm over all of
``d_inner`` from the group's sum of squares) and rows of ``w_out``, its
weight-tied shared block's attention on the cell's heads and its MLP on
its columns, the vocabulary.

In the port: the exact set of leaves each cell gathers over ``model``
(``spmd.observe`` with labels), the flash calls' shapes in each cell (the
VLM's self and cross attention on the cell's heads), the plan of the
whole VLM for a ``model`` axis of 2 and 4, the token groups' pieces,
``spmd``'s refusal of a collective inside an autograd backward, a
checkpoint's recompute or a tape's local segment, the dry-run's counts of
the ``model``-axis collectives, and five planted breaches, each of which
the reference differential refuses: replicated work (a norm) after an
entry (rule (a)), the MoE's replicated aux loss summed over ``model``
(rule (b)), an entry whose backward does not sum, and, in the VLM's
cross layer, a gate multiplied inside the local segment (rule (a)) and
an entry whose backward does not sum; and five more: whisper's cross
layer reading the encoder's output by closure, its entries without their
psum; rwkv6's receptance gate multiplied ahead of the channel mix's exit
(rule (a)), the sum of squares of ``ln_x`` exited with no entry after it
(rule (c)), the bonus ``u`` read by closure in the cell's segment; and
four of zamba2's: the gathered ``w_in``'s gradient sliced (each cell's
partial, as where a cell reads the whole leaf by closure), ``conv_w``
read by closure in the cell's segment, the gated norm's sum of squares
exited with no entry after it, the shared block's norm after its entry.
"""

from __future__ import annotations

import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.distributed import spmd  # noqa: E402
from repro_torch.distributed import tensor_parallel as tp  # noqa: E402
from repro_torch.distributed.sharding import (MeshArray, MeshSharding,  # noqa: E402
                                              ShardingCtx, gathered)
from repro_torch.launch import dryrun, op_analysis  # noqa: E402
from repro_torch.launch.programs import build_program  # noqa: E402
from repro_torch.models import attention as A, lm, moe  # noqa: E402
from repro_torch.models import mamba2 as MB  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models import rwkv as RW  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import rms_norm  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402
from test_torch_mesh_train import (BATCH, RUN, SEED, SEQ, STEPS,  # noqa: E402
                                   carried, counted_flash, leaves, virtual,
                                   whole_state)
from test_torch_rwkv import assert_close  # noqa: E402
from test_torch_spmd import run_reference  # noqa: E402

MOE = "olmoe-1b-7b"
VLM = "llama-3.2-vision-11b"
AUDIO, SSM, HYBRID = "whisper-small", "rwkv6-7b", "zamba2-7b"
CASES = (("dense", (2, 2)), ("dense", (1, 2)), ("dense", (1, 4)),
         ("a2a", (1, 2)), ("a2a", (2, 2)))

REF_TRAIN = """
import json
from repro.configs import registry
from repro.launch.mesh import make_host_mesh
from repro.train.trainer import Trainer
b = registry.get(inp["arch"])
for impl, (d, m) in inp["cases"]:
    run = b.run.replace(moe_impl=impl, **inp["run"])
    mesh = make_host_mesh(d, m)
    t = Trainer(b.smoke, run, global_batch=inp["batch"], seq_len=inp["seq"],
                seed=inp["seed"], mesh=mesh,
                ruleset="moe_a2a" if impl == "a2a" else "baseline")
    key = f"{impl}/{d}x{m}"
    if "init" not in out:
        st = t.extract_state()
        out["init"] = {"params": st["params"], "opt": st["opt_state"]}

    def shapes(leaf):
        by_dev = {s.device: list(s.data.shape) for s in leaf.addressable_shards}
        return [by_dev[dv] for dv in mesh.devices.flat]
    out[f"{key}/shapes"] = json.dumps([shapes(leaf) for leaf in jax.tree.leaves(
        {"params": t.params, "opt": t.opt_state})])
    t.train(inp["steps"])
    out[f"{key}/losses"] = np.array([m_["loss"] for m_ in t.metrics_log])
    st = t.extract_state()
    out[f"{key}/final"] = {"params": st["params"], "opt": st["opt_state"]}
"""


@pytest.fixture(scope="module")
def reference():
    return run_reference(REF_TRAIN, {
        "arch": MOE, "run": RUN, "cases": CASES, "batch": BATCH, "seq": SEQ,
        "seed": SEED, "steps": STEPS}, 4)


def moe_trainer(impl: str, mesh, **run_kw):
    b = registry.get(MOE)
    run = b.run.replace(**{**RUN, "moe_impl": impl, **run_kw})
    return Trainer(b.smoke, run, global_batch=BATCH, seq_len=SEQ, seed=SEED,
                   mesh=mesh, device="cpu",
                   ruleset="moe_a2a" if impl == "a2a" else "baseline")


def trained_against(reference, impl, mesh_shape) -> list:
    """The port's trainer on the case's mesh from the reference's initial
    state, 3 steps; the leaves whose gap exceeds the tolerance (the loss
    as leaf -1), each with its gap."""
    d, m = mesh_shape
    return gaps_after(moe_trainer(impl, virtual(d, m)), reference,
                      f"{impl}/{d}x{m}")


# A first moment's gap norm over its norm, a leaf: a gradient that only
# a fault in the backward changes may be too small for the parameters'
# absolute 1e-4 to see (the VLM's gates, whose first moments are about
# 1e-5 and whose parameters Adam's sign-like first steps move alike
# whatever the gradient's size); the sound runs stay well inside the
# bound and the planted faults far outside it.
MOMENT_TOL = 1e-3


def moment_gaps(t, final) -> list:
    """(leaf, gap) of each first-moment leaf of ``t`` whose gap's norm to
    the reference's ``final`` state exceeds MOMENT_TOL of its norm."""
    want = jax.tree.leaves(final["opt"].mu)
    got = list(P.leaves(gathered(t.opt_state.mu)))
    bad = []
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        w = torch.as_tensor(np.asarray(w))
        gap = ((g - w).norm() / w.norm().clamp(min=1e-30)).item()
        if gap > MOMENT_TOL:
            bad.append((("mu", i), gap))
    return bad


def gaps_after(t, reference, key) -> list:
    """``t`` trained 3 steps from the reference's initial state: the
    leaves whose gap to the reference's case ``key`` exceeds the
    tolerance (the loss as leaf -1), each with its gap, and the first
    moments' (``moment_gaps``)."""
    t.restore_state(carried(reference["init"]))
    t.train(STEPS)
    bad = []
    loss_gap = np.abs(np.array([x["loss"] for x in t.metrics_log])
                      - reference[f"{key}/losses"]).max()
    if loss_gap > 1e-4:
        bad.append((-1, float(loss_gap)))
    want = jax.tree.leaves(reference[f"{key}/final"])
    for i, (g, w) in enumerate(zip(whole_state(t), want, strict=True)):
        w = torch.as_tensor(np.asarray(w))
        gap = ((g - w).abs().max() / max(1.0, w.abs().max().item())).item()
        if gap > 1e-4:
            bad.append((i, gap))
    return bad + moment_gaps(t, reference[f"{key}/final"])


@pytest.mark.parametrize("impl,mesh_shape", CASES)
def test_moe_trainer_matches_reference_on_its_mesh(reference, impl,
                                                   mesh_shape):
    d, m = mesh_shape
    key = f"{impl}/{d}x{m}"
    t = moe_trainer(impl, virtual(d, m))
    assert t._step_fn.plan.experts and t._step_fn.plan.attn
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


# --- what a cell gathers over model, and computes -------------------------------------


def gathered_over_model(t) -> tuple:
    """({cell: the labels of the leaves it all-gathered over ``model``},
    {cell: the shapes of the tensors its tape all-gathered over ``model``,
    in order}) in one step of ``t``."""
    seen, taped = {}, {}

    def note(op, out, n, cell, *, axes, label):
        if op == "all-gather" and "model" in axes:
            if label is None:
                taped.setdefault(cell, []).append(tuple(out.shape))
            else:
                seen.setdefault(cell, set()).add(label)

    with spmd.observe(note):
        t.train(t.step_idx + 1)
    return seen, taped


def _w_in_gathers():
    """zamba2's smoke: each cell gathers each layer's ``w_in`` (64 x 296)
    in its tape, once a microbatch (one: 4 rows a data cell)."""
    cfg = registry.get(HYBRID).smoke
    d_inner, H, _, N = MB.dims(cfg)
    return [(cfg.d_model, 2 * d_inner + 2 * N + H)] * cfg.num_layers


@pytest.mark.parametrize("arch,want,repeated", [
    (MOE, {"stack.layers.moe.router"}, []),
    ("smollm-135m", {f"stack.layers.attn.{w}"
                     for w in ("wq", "wk", "wv", "wo")}, ["attention"]),
    (VLM, set(), []), (AUDIO, set(), []), (SSM, set(), []),
    (HYBRID, set(), [])])
def test_cells_gather_over_model_only_the_leaves_they_repeat(arch, want,
                                                             repeated):
    """olmoe: only its router (which the routing needs whole); smollm: its
    attention (3 heads, 1 kv head do not split over 2 cells); the VLM,
    whisper, rwkv6 and zamba2: nothing (their attention, time mix or
    Mamba2 blocks, MLPs or channel mix and vocabulary split, and no other
    leaf is cut over ``model``). The step gathers no leaf over ``model``
    for zamba2: its cells gather ``w_in`` inside their tapes, a layer at a
    time, and nothing else."""
    b = registry.get(arch)
    t = Trainer(b.smoke, b.run.replace(**RUN), global_batch=BATCH,
                seq_len=SEQ, seed=SEED, mesh=virtual(2, 2), device="cpu")
    seen, got = gathered_over_model(t)
    assert {c: seen.get(c, set()) for c in range(4)} == {
        c: want for c in range(4)}
    taped = _w_in_gathers() if arch == HYBRID else []
    assert {c: got.get(c, []) for c in range(4)} == {
        c: taped for c in range(4)}
    plan = t._step_fn.plan
    assert plan.repeated(b.smoke) == repeated


def test_flash_runs_on_each_cells_own_heads(counted_flash):
    b = registry.get(MOE)
    run = b.run  # bf16 compute, block remat
    t = Trainer(b.smoke, run, global_batch=BATCH, seq_len=SEQ, seed=SEED,
                mesh=virtual(2, 2), device="cpu")
    t.train(1)
    cfg = b.smoke
    # 4 cells x 1 microbatch x the layers' forward and recompute
    assert len(counted_flash) == 4 * 1 * 2 * cfg.num_layers
    assert set(counted_flash) == {(BATCH // 2, SEQ, cfg.num_heads // 2,
                                   cfg.head_dim)}


@pytest.fixture
def counted_cross_flash(counted_flash, monkeypatch):
    """``counted_flash`` with the cross attention's flash Function too,
    each call's (q shape, k shape) kept."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    calls = []

    def fwd(q, k, v, *, causal, window, softcap):
        calls.append((tuple(q.shape), tuple(k.shape), causal))
        return fa_ref.attention(q, k, v, causal=causal, window=window,
                                softcap=softcap)

    monkeypatch.setattr(FK, "flash_attention_fwd", fwd)
    monkeypatch.setattr(A, "attention_full", lambda q, k, v: (
        fa_ops.flash_attention(q, k, v, False, 0, 0.0, use_kernel=True)))
    return calls


def test_vlm_flash_runs_on_each_cells_own_heads(counted_cross_flash):
    """The VLM on (2, 2) with its bundle's run (bf16 compute, block
    remat): each cell's self attention (causal) and cross attention (over
    the image tokens) on its data cell's rows, its 2 of the 4 q heads and
    1 of the 2 kv heads, once forward and once in the tape's recompute."""
    b = registry.get(VLM)
    cfg = b.smoke
    t = Trainer(cfg, b.run, global_batch=BATCH, seq_len=SEQ, seed=SEED,
                mesh=virtual(2, 2), device="cpu")
    t.train(1)
    q = (BATCH // 2, SEQ, cfg.num_heads // 2, cfg.head_dim)
    kv = cfg.num_kv_heads // 2
    self_call = (q, (BATCH // 2, SEQ, kv, cfg.head_dim), True)
    cross_call = (q, (BATCH // 2, cfg.num_image_tokens, kv, cfg.head_dim),
                  False)
    g, s = T._vlm_groups(cfg)
    # 4 cells x 1 microbatch x (the forward and the recompute) a layer
    assert sorted(counted_cross_flash) == sorted(
        [self_call] * (4 * 2 * g * s) + [cross_call] * (4 * 2 * g))


@pytest.mark.parametrize("m", [2, 4])
def test_plan_makes_the_whole_vlm_model_local(m):
    """llama-3.2-vision-11b at its published widths (32 q and 8 kv heads,
    d_ff 14336, vocabulary 128256) over ``model`` of 2 and 4: the self
    and cross attention, the MLPs and the vocabulary are the cell's own,
    and nothing repeats; over 16 its 8 kv heads do not split."""
    cfg = registry.get(VLM).model
    for size, local in ((m, True), (16, False)):
        plan, leaves = whole_plan(cfg, size)
        assert (plan.attn, plan.xattn) == (local, local)
        assert plan.mlp and plan.vocab and plan.segmented
        assert plan.repeated(cfg) == (
            [] if local else ["attention", "cross attention"])
        assert all(leaves["stack"]["cross"]["xattn"][w] == local
                   and leaves["stack"]["self"]["attn"][w] == local
                   for w in ("wq", "wk", "wv", "wo"))
        assert not any(leaves["stack"]["cross"][w] for w in (
            "gate_attn", "gate_mlp", "ln1", "ln2"))


def test_token_group_pieces_cut_at_each_groups_edge():
    """A cell's rows of each group it holds a part of: within a cell, a
    group over some cells, a group whose edge falls inside a cell."""
    assert moe.moe_groups(8192, 2) == (4096, False)
    assert moe.group_pieces(8192, 8192, 4096) == [4096, 4096]
    assert moe.moe_groups(2048, 4) == (4096, True)
    assert moe.group_pieces(2048, 2048, 4096) == [2048]
    assert moe.moe_groups(32, 2) == (64, True)
    assert moe.moe_groups(6144, 2) == (4096, True)
    assert moe.group_pieces(6144, 6144, 4096) == [2048, 4096]
    assert moe.group_pieces(0, 6144, 4096) == [4096, 2048]
    assert moe.moe_groups(3000, 4) == (12000, True)


# --- the guard --------------------------------------------------------------------------


def on_two_cells(body):
    mesh = virtual(1, 2)
    x = torch.arange(4.0).reshape(2, 2)
    return spmd.shard_map(body, mesh, in_specs=(("model",),),
                          out_specs=("model",))(x)


class _PsumBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return spmd.psum(g, "model")  # planted: a collective in a backward


def test_a_collective_in_a_backward_raises():
    def body(x):
        x = x.clone().requires_grad_()
        y = _PsumBackward.apply(x).sum()
        return torch.autograd.grad(y, x)[0]

    with pytest.raises(spmd.SpmdError, match="autograd backward"):
        on_two_cells(body)


def test_a_collective_in_a_checkpoint_recompute_raises():
    from torch.utils.checkpoint import checkpoint

    def body(x):
        x = x.clone().requires_grad_()
        # the forward's psum runs in the cell; its recompute, to give the
        # sine the input it saved, in the backward
        y = checkpoint(lambda t: torch.sin(spmd.psum(t * t, "model")), x,
                       use_reentrant=False).sum()
        return torch.autograd.grad(y, x)[0]

    with pytest.raises(spmd.SpmdError, match="recompute"):
        on_two_cells(body)


def test_a_collective_in_a_tape_segment_raises():
    def body(x):
        tape = tp.Tape(remat=True)
        tape.run(lambda t: (spmd.psum(t, "model"),), x)
        return x

    with pytest.raises(spmd.SpmdError, match="local segment"):
        on_two_cells(body)
    with pytest.raises(spmd.SpmdError, match="inside shard_map only"):
        spmd.psum(torch.ones(2), "model")


def test_tape_transposes_against_autograd_of_the_whole():
    """Two cells of a (1, 2) mesh: an entry, each cell's columns and rows
    of a two-layer product, an exit; the gradients of the tape's backward
    against autograd of the whole product."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 4, generator=gen)
    w1 = torch.randn(4, 6, generator=gen)
    w2 = torch.randn(6, 4, generator=gen)
    s = torch.randn(4, generator=gen)

    def whole():
        p = [t.clone().requires_grad_() for t in (s, w1, w2)]
        h = (x * p[0]) @ p[1]
        loss = torch.tanh(torch.relu(h) @ p[2]).square().sum()
        return torch.autograd.grad(loss, p)

    def body(s_, w1_, w2_):
        tape = tp.Tape(remat=True)
        p = [t.clone().requires_grad_() for t in (s_, w1_, w2_)]
        h, = tape.run(lambda: (x * p[0],))
        part, = tape.run(lambda h: (torch.relu(h @ p[1]) @ p[2],),
                         tape.enter(h))
        loss, = tape.run(lambda y: (torch.tanh(y).square().sum(),),
                         tape.exit(part))
        tape.backward(loss)
        return tuple(t.grad for t in p)

    got = spmd.shard_map(body, virtual(1, 2),
                         in_specs=((), (None, "model"), ("model",)),
                         out_specs=((), (None, "model"), ("model",)))(
        s, w1, w2)
    for g, w in zip(got, whole()):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


# --- planted breaches --------------------------------------------------------------------


def attn_half_norm_after_entry(cfg, ctx, tc, wl, x, adds, positions,
                               q_chunk):
    """Rule (a) broken: the attention's norm in each cell's local
    segment, after the entry (its scale's gradient a partial sum)."""
    tape = tc.tape
    x, = tape.run(lambda x, *a: (T._resid(x, a),), x, *adds)
    part, = tape.run(lambda h: (T._attention_out(
        cfg, ctx, wl()["attn"], rms_norm(h, wl()["ln1"], cfg.norm_eps),
        positions, q_chunk)[0],), tape.enter(x))
    return x, (tape.exit(part),)


def summed_aux(half):
    """Rule (b) broken: the replicated aux loss summed over ``model``."""
    def breached(cfg, run, ctx, tc, wl, x, adds):
        x, adds, aux = half(cfg, run, ctx, tc, wl, x, adds)
        return x, adds, tc.tape.exit(aux)
    return breached


def enter_without_psum(self, x, axis=tp.AXIS):
    """An entry whose backward passes each cell's partial gradient on."""
    return self._collective(x, tp._leaf(x), lambda g: g)


@pytest.mark.parametrize("breach", ["norm_after_entry", "aux_summed",
                                    "entry_without_psum"])
def test_planted_breaches_fail_the_reference_differential(
        reference, monkeypatch, breach):
    impl, mesh_shape = "dense", (1, 2)
    assert trained_against(reference, impl, mesh_shape) == []
    if breach == "norm_after_entry":
        monkeypatch.setattr(T, "_attn_half", attn_half_norm_after_entry)
    elif breach == "aux_summed":
        monkeypatch.setattr(T, "_moe_half", summed_aux(T._moe_half))
    else:
        monkeypatch.setattr(tp.Tape, "enter", enter_without_psum)
    bad = trained_against(reference, impl, mesh_shape)
    assert bad, breach
    if breach == "aux_summed":  # the loss itself counts the aux twice
        assert bad[0][0] == -1


# --- the VLM against the reference --------------------------------------------------------

VLM_MESHES = ((2, 2), (1, 2))

REF_VLM = """
import json
from repro.configs import registry
from repro.launch.mesh import make_host_mesh
from repro.train.trainer import Trainer
b = registry.get(inp["arch"])
run = b.run.replace(**inp["run"])
rng = np.random.default_rng(inp["seed"])
for d, m in inp["meshes"]:
    mesh = make_host_mesh(d, m)
    t = Trainer(b.smoke, run, global_batch=inp["batch"], seq_len=inp["seq"],
                seed=inp["seed"], mesh=mesh)
    key = f"{d}x{m}"
    if "init" not in out:
        st = t.extract_state()
        # the gates drawn away from 0, where tanh shuts the cross layers
        cross = st["params"]["stack"]["cross"]
        for name in ("gate_attn", "gate_mlp"):
            shape = np.shape(cross[name])
            cross[name] = (rng.uniform(0.5, 1.5, shape) * rng.choice(
                [-1, 1], shape)).astype(np.float32)
        out["init"] = {"params": st["params"], "opt": st["opt_state"]}
    t.restore_state({"params": out["init"]["params"],
                     "opt_state": out["init"]["opt"], "step": 0,
                     "seed": inp["seed"]})

    def shapes(leaf):
        by_dev = {s.device: list(s.data.shape) for s in leaf.addressable_shards}
        return [by_dev[dv] for dv in mesh.devices.flat]
    out[f"{key}/shapes"] = json.dumps([shapes(leaf) for leaf in jax.tree.leaves(
        {"params": t.params, "opt": t.opt_state})])
    t.train(inp["steps"])
    out[f"{key}/losses"] = np.array([m_["loss"] for m_ in t.metrics_log])
    st = t.extract_state()
    out[f"{key}/final"] = {"params": st["params"], "opt": st["opt_state"]}
"""


@pytest.fixture(scope="module")
def vlm_reference():
    return run_reference(REF_VLM, {
        "arch": VLM, "run": RUN, "meshes": VLM_MESHES, "batch": BATCH,
        "seq": SEQ, "seed": SEED, "steps": STEPS}, 4)


def vlm_trainer(mesh):
    b = registry.get(VLM)
    return Trainer(b.smoke, b.run.replace(**RUN), global_batch=BATCH,
                   seq_len=SEQ, seed=SEED, mesh=mesh, device="cpu")


@pytest.mark.parametrize("mesh_shape", VLM_MESHES)
def test_vlm_trainer_matches_reference_on_its_mesh(vlm_reference,
                                                   mesh_shape):
    """(2, 2): one microbatch a data cell; (1, 2): the bundle's two."""
    d, m = mesh_shape
    key = f"{d}x{m}"
    t = vlm_trainer(virtual(d, m))
    plan = t._step_fn.plan
    assert plan.attn and plan.xattn and plan.mlp and plan.vocab
    t.restore_state(carried(vlm_reference["init"]))
    assert [[list(s.shape) for s in x.shards] for x in leaves(t)] == \
        json.loads(str(vlm_reference[f"{key}/shapes"]))
    t.train(STEPS)
    np.testing.assert_allclose([x["loss"] for x in t.metrics_log],
                               vlm_reference[f"{key}/losses"], rtol=0,
                               atol=1e-4)
    want = jax.tree.leaves(vlm_reference[f"{key}/final"])
    have = whole_state(t)
    assert len(have) == len(want)
    for i, (g, w) in enumerate(zip(have, want)):
        assert_close(g, w, 1e-4, f"{key} leaf {i}")
    assert moment_gaps(t, vlm_reference[f"{key}/final"]) == []


CROSS = T.cross_segments


def cross_gate_in_local_segment(cfg, ctx, tc, wc, x, adds, img):
    """Rule (a) broken: ``tanh(gate_attn)`` multiplied in each cell's
    local segment, ahead of the exit (its gradient a partial sum)."""
    tape = tc.tape
    x, h = tape.run(lambda x, *a: T._normed(x, a, wc()["ln1"], cfg.norm_eps),
                    x, *adds)
    part, = tape.run(lambda h: (T._gated(wc()["gate_attn"], A.cross_attention(
        cfg, wc()["xattn"], h, img, ctx)),), tape.enter(h))
    x, (y,), _ = T._mlp_half(cfg, None, ctx, tc, wc, x, (tape.exit(part),))
    y, = tape.run(lambda y: (T._gated(wc()["gate_mlp"], y),), y)
    return x, (y,)


def cross_entry_without_psum(cfg, ctx, tc, wc, x, adds, img):
    """The cross layer's entries pass each cell's partial gradient on."""
    tc.tape.enter = types.MethodType(enter_without_psum, tc.tape)
    try:
        return CROSS(cfg, ctx, tc, wc, x, adds, img)
    finally:
        del tc.tape.enter


@pytest.mark.parametrize("breach", [cross_gate_in_local_segment,
                                    cross_entry_without_psum])
def test_vlm_planted_breaches_fail_the_reference_differential(
        vlm_reference, monkeypatch, breach):
    assert gaps_after(vlm_trainer(virtual(1, 2)), vlm_reference, "1x2") == []
    monkeypatch.setattr(T, "cross_segments", breach)
    assert gaps_after(vlm_trainer(virtual(1, 2)), vlm_reference, "1x2")


# --- whisper and rwkv6 against the reference ------------------------------------------

FAMILY_MESHES = ((2, 2), (1, 2))
FAMILIES = (AUDIO, SSM, HYBRID)

REF_FAMILIES = """
import json
from repro.configs import registry
from repro.launch.mesh import make_host_mesh
from repro.train.trainer import Trainer
for arch in inp["archs"]:
    b = registry.get(arch)
    run = b.run.replace(**inp["run"])
    for d, m in inp["meshes"]:
        mesh = make_host_mesh(d, m)
        t = Trainer(b.smoke, run, global_batch=inp["batch"],
                    seq_len=inp["seq"], seed=inp["seed"], mesh=mesh)
        key = f"{arch}/{d}x{m}"
        if f"{arch}/init" not in out:
            st = t.extract_state()
            out[f"{arch}/init"] = {"params": st["params"],
                                   "opt": st["opt_state"]}

        def shapes(leaf):
            by_dev = {s.device: list(s.data.shape)
                      for s in leaf.addressable_shards}
            return [by_dev[dv] for dv in mesh.devices.flat]
        out[f"{key}/shapes"] = json.dumps([shapes(leaf) for leaf in
                                           jax.tree.leaves({"params": t.params,
                                                            "opt": t.opt_state})])
        t.train(inp["steps"])
        out[f"{key}/losses"] = np.array([m_["loss"] for m_ in t.metrics_log])
        st = t.extract_state()
        out[f"{key}/final"] = {"params": st["params"], "opt": st["opt_state"]}
"""


@pytest.fixture(scope="module")
def family_reference():
    """whisper's, rwkv6's and zamba2's smoke configs in the reference's
    trainer on FAMILY_MESHES, keyed ``{arch}/{d}x{m}``."""
    ref = run_reference(REF_FAMILIES, {
        "archs": FAMILIES, "run": RUN, "meshes": FAMILY_MESHES,
        "batch": BATCH, "seq": SEQ, "seed": SEED, "steps": STEPS}, 4)
    return {arch: {**{k.split("/", 1)[1]: v for k, v in ref.items()
                      if k.startswith(arch + "/")}}
            for arch in FAMILIES}


def family_trainer(arch, mesh, run=None):
    b = registry.get(arch)
    return Trainer(b.smoke, run or b.run.replace(**RUN), global_batch=BATCH,
                   seq_len=SEQ, seed=SEED, mesh=mesh, device="cpu")


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("mesh_shape", FAMILY_MESHES)
def test_family_trainer_matches_reference_on_its_mesh(family_reference, arch,
                                                      mesh_shape):
    """Each cell computes with its own heads (whisper's encoder, decoder
    and cross attention; rwkv6's WKV heads; zamba2's SSD heads and its
    shared block's attention), MLP or channel-mix columns and vocabulary
    rows: the shapes at rest (zamba2's ``w_in`` the cell's even block of
    its columns), the losses of 3 steps, every leaf after them and the
    first moments' gaps. rwkv6 and zamba2 on (1, 2): the bundles' two
    microbatches."""
    d, m = mesh_shape
    key = f"{d}x{m}"
    ref = family_reference[arch]
    t = family_trainer(arch, virtual(d, m))
    plan = t._step_fn.plan
    assert plan.segmented and plan.attn and plan.mlp and plan.vocab
    assert plan.xattn == (arch == AUDIO)
    assert plan.ssd == (arch == HYBRID)
    t.restore_state(carried(ref["init"]))
    assert [[list(s.shape) for s in x.shards] for x in leaves(t)] == \
        json.loads(str(ref[f"{key}/shapes"]))
    t.train(STEPS)
    np.testing.assert_allclose([x["loss"] for x in t.metrics_log],
                               ref[f"{key}/losses"], rtol=0, atol=1e-4)
    want = jax.tree.leaves(ref[f"{key}/final"])
    have = whole_state(t)
    assert len(have) == len(want)
    for i, (g, w) in enumerate(zip(have, want)):
        assert_close(g, w, 1e-4, f"{arch} {key} leaf {i}")
    assert moment_gaps(t, ref[f"{key}/final"]) == []


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("m", [2, 4])
def test_plan_makes_the_smoke_families_model_local(arch, m):
    """whisper's (4 heads, d_ff 128, vocabulary 256), rwkv6's (4 WKV
    heads of 16, d_ff 128, vocabulary 256) and zamba2's (8 SSD heads of
    16, a shared block of 4 heads, d_ff 128, vocabulary 256) smoke
    configs over ``model`` of 2 and 4: every group is the cell's own,
    nothing repeats; the leaves that are not cut over ``model`` (norms,
    rwkv6's mixes, LoRAs, decay, bonus, the channel mix's ``wr``, the
    Mamba2 conv, decay, skip and dt bias) are not local. zamba2's 296
    ``w_in`` columns (gate 128, x 128, B and C 16 each, dt 8) are cut
    evenly: at 148 over 2, at 74, 148 and 222 over 4, inside the gate and
    x blocks and on no head's border."""
    cfg = registry.get(arch).smoke
    plan, leaves_ = whole_plan(cfg, m)
    assert plan.segmented and plan.attn and plan.mlp and plan.vocab
    assert plan.xattn == (arch == AUDIO)
    assert plan.ssd == (arch == HYBRID)
    assert plan.repeated(cfg) == []
    st = leaves_["stack"]
    if arch == HYBRID:
        assert {n for n, v in st["layers"].items() if v} == set(tp.MAMBA)
        assert all(all(st["shared"][g].values()) for g in ("attn", "mlp"))
        assert not (st["shared"]["ln1"] or st["shared"]["ln2"])
        d_inner, H, Pd, N = MB.dims(cfg)
        mesh = dryrun._meta_mesh((2, m), ("data", "model"))
        ts = lm.param_specs(cfg)["stack"]["layers"]["w_in"]
        spec = ShardingCtx.for_mesh(mesh).spec(ts.logical, ts.shape)
        n = ts.shape[-1]
        assert n == 2 * d_inner + 2 * N + H == 296
        at = MeshSharding(mesh, spec).devices_indices_map(ts.shape)
        cols = [at[i][2] for i in range(m)]  # data cell 0's model cells
        assert [(c.start, c.stop) for c in cols] == [
            (i * n // m, (i + 1) * n // m) for i in range(m)]
        assert all(c % Pd and c < 2 * d_inner for c in range(n // m, n,
                                                             n // m))
    elif arch == AUDIO:
        for part, groups in (("encoder", ("attn", "mlp")),
                             ("decoder", ("attn", "xattn", "mlp"))):
            assert all(all(st[part][g].values()) for g in groups)
            assert not any(st[part][n] for n in st[part]
                           if n.startswith("ln"))
        assert st["enc_ln"] is False
    else:
        tm, cm = st["layers"]["tmix"], st["layers"]["cmix"]
        assert {n for n, v in tm.items() if v} == set(tp.TMIX)
        assert {n for n, v in cm.items() if v} == set(tp.CMIX)


def whole_plan(cfg, m: int, data: int = 2):
    """``plan_for`` and ``local_leaves`` of ``cfg`` on a (data, m) mesh of
    meta devices (specs only)."""
    mesh = dryrun._meta_mesh((data, m), ("data", "model"))
    ctx = ShardingCtx.for_mesh(mesh)
    pspecs = lm.param_specs(cfg)
    plan = tp.plan_for(cfg, pspecs, P.map_specs(
        lambda s: ctx.spec(s.logical, s.shape), pspecs),
        {"data": data, "model": m}, ("data",))
    return plan, tp.local_leaves(plan, pspecs)


@pytest.mark.parametrize("arch,m,repeated", [
    (AUDIO, 2, ["embedding and logits"]), (AUDIO, 4, ["embedding and logits"]),
    (SSM, 2, []), (SSM, 4, []), (SSM, 128, ["time mix"]),
    (HYBRID, 2, []), (HYBRID, 4, []), (HYBRID, 16, []),
    (HYBRID, 32, ["mamba2"])])
def test_plan_of_the_full_families(arch, m, repeated):
    """At the published widths (specs only): whisper-small's 12 heads and
    3072 MLP columns split over 2 and 4, its vocabulary of 51865 over
    neither, so the embedding and logits repeat in every cell (GSPMD
    replicates them too); rwkv6-7b's 64 WKV heads, 14336 channel-mix
    columns and 65536 rows split, and over 128 its heads do not;
    zamba2-7b's 112 SSD heads and 14576 ``w_in`` columns split over 2, 4
    and 16, its shared block's 32 heads, 14336 MLP columns and 32000 rows
    over 32 too, but over 32 neither its SSD heads nor ``w_in`` do, so
    the Mamba2 blocks repeat (``w_in`` and ``w_out`` gathered whole)."""
    cfg = registry.get(arch).model
    plan, leaves_ = whole_plan(cfg, m)
    assert plan.segmented and plan.repeated(cfg) == repeated
    assert plan.vocab == (arch != AUDIO)
    assert leaves_["embed"]["embedding"] == plan.vocab
    if arch == HYBRID:
        assert plan.attn and plan.mlp and plan.ssd == (m != 32)
        assert leaves_["stack"]["layers"]["w_in"] == plan.ssd


@pytest.fixture
def counted_wkv6(monkeypatch):
    """The WKV6 kernel's place taken by the plain forward, counted with
    its (r shape, chunk), and the model's scan sent through the kernel's
    Function, as on the card."""
    import functools

    from repro_torch.kernels.wkv6 import kernel as WK
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    from repro_torch.kernels.wkv6 import ref as wkv_ref

    calls = []

    def fwd(r, k, v, w, u, state, *, chunk):
        calls.append((tuple(r.shape), chunk))
        return wkv_ref.wkv6(r, k, v, w, u, state, chunk=chunk)

    monkeypatch.setattr(WK, "wkv6_chunked", fwd)
    monkeypatch.setattr(wkv_ops, "wkv6", functools.partial(wkv_ops.wkv6,
                                                           use_kernel=True))
    return calls


def test_whisper_flash_runs_on_each_cells_own_heads(counted_cross_flash):
    """whisper on (2, 2) with its bundle's run (bf16 compute, block
    remat): each cell's encoder attention (bidirectional, over the stub
    frames), decoder self attention (causal) and cross attention (over
    the frames) on its data cell's rows and its 2 of the 4 heads, once
    forward and once in the tape's recompute."""
    cfg = registry.get(AUDIO).smoke
    t = family_trainer(AUDIO, virtual(2, 2), registry.get(AUDIO).run)
    t.train(1)
    rows, h, D, T_ = BATCH // 2, cfg.num_heads // 2, cfg.head_dim, \
        cfg.encoder_seq
    enc = ((rows, T_, h, D), (rows, T_, h, D), False)
    dec = ((rows, SEQ, h, D), (rows, SEQ, h, D), True)
    cross = ((rows, SEQ, h, D), (rows, T_, h, D), False)
    # 4 cells x 1 microbatch x (the forward and the recompute)
    assert sorted(counted_cross_flash) == sorted(
        [enc] * (4 * 2 * cfg.encoder_layers)
        + [dec, cross] * (4 * 2 * cfg.num_layers))


def test_rwkv6_wkv6_runs_on_each_cells_own_heads(counted_wkv6):
    """rwkv6 on (2, 2) with its bundle's run (bf16 compute, block remat,
    microbatches of 4 rows a data cell: one): each cell's time mix on its
    data cell's rows and its 2 of the 4 WKV heads, once forward and once
    in the tape's recompute."""
    cfg = registry.get(SSM).smoke
    t = family_trainer(SSM, virtual(2, 2), registry.get(SSM).run)
    t.train(1)
    K = cfg.wkv_head_dim
    shape = (BATCH // 2, SEQ, cfg.d_model // K // 2, K)
    assert counted_wkv6 == [(shape, cfg.scan_chunk)] * (
        4 * 1 * 2 * cfg.num_layers)


@pytest.fixture
def counted_ssd(counted_flash, monkeypatch):
    """``counted_flash`` (each call's q shape), and the SSD kernel's place
    taken by the plain forward, counted with its (x shape, B shape,
    chunk), the model's scan sent through the kernel's Function, as on
    the card. Returns (ssd calls, flash calls)."""
    import functools

    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ref as ssd_ref

    calls = []

    def fwd(x, dt, B, C, A_log, D, state, *, chunk):
        calls.append((tuple(x.shape), tuple(B.shape), chunk))
        return ssd_ref.ssd(x, dt, B, C, A_log, D, state, chunk=chunk)

    monkeypatch.setattr(SK, "ssd_chunked", fwd)
    monkeypatch.setattr(ssd_ops, "ssd", functools.partial(ssd_ops.ssd,
                                                          use_kernel=True))
    return calls, counted_flash


def test_zamba2_ssd_and_flash_run_on_each_cells_own_heads(counted_ssd):
    """zamba2 on (2, 2) with its bundle's run (bf16 compute, block remat,
    microbatches of 4 rows a data cell: one): each cell's SSD on its data
    cell's rows and its 4 of the 8 SSD heads, B and C whole, once a layer;
    its shared block's attention on its 2 of the 4 heads, once an
    application; each once forward and once in the tape's recompute."""
    ssd_calls, flash_calls = counted_ssd
    cfg = registry.get(HYBRID).smoke
    t = family_trainer(HYBRID, virtual(2, 2), registry.get(HYBRID).run)
    t.train(1)
    rows = BATCH // 2
    _, H, Pd, N = MB.dims(cfg)
    assert ssd_calls == [((rows, SEQ, H // 2, Pd), (rows, SEQ, N),
                          cfg.scan_chunk)] * (4 * 1 * 2 * cfg.num_layers)
    assert flash_calls == [(rows, SEQ, cfg.num_heads // 2, cfg.head_dim)] * (
        4 * 1 * 2 * MB.n_shared_applications(cfg))


# planted breaches of whisper's, rwkv6's and zamba2's layers

XATTN = T._xattn_half


def xattn_src_by_closure(cfg, ctx, tc, wl, x, adds, src, ln):
    """whisper's cross half reading the encoder's output by closure, not
    entered: its gradient in each cell is that cell's heads' part, and
    nothing sums it over ``model``."""
    tape = tc.tape
    x, h = tape.run(lambda x, *a: T._normed(x, a, wl()[ln], cfg.norm_eps),
                    x, *adds)
    part, = tape.run(lambda h: (A.cross_attention(cfg, wl()["xattn"], h, src,
                                                  ctx),), tape.enter(h))
    return x, (tape.exit(part),)


def xattn_entry_without_psum(cfg, ctx, tc, wl, x, adds, src, ln):
    """The cross half's entries (the stream's and the encoder output's)
    pass each cell's partial gradient on."""
    tc.tape.enter = types.MethodType(enter_without_psum, tc.tape)
    try:
        return XATTN(cfg, ctx, tc, wl, x, adds, src, ln)
    finally:
        del tc.tape.enter


def cmix_gate_before_exit(cfg, ctx, tc, wl, x, adds):
    """Rule (a) broken: rwkv6's receptance gate multiplied in each cell's
    segment, ahead of the exit (its gradient a partial sum)."""
    tape = tc.tape

    def w():
        return wl()["cmix"]

    def pre(x, *a):
        x = T._resid(x, a)
        xk, xr = RW._cmix_streams(w(), x, RW._shift(x), cfg.norm_eps)
        return x, xk, RW._rgate(w(), xr)

    x, xk, rgate = tape.run(pre, x, *adds)
    part, = tape.run(lambda xk, r: (r * RW._cmix_value(ctx, w(), xk),),
                     tape.enter(xk), rgate)
    return x, (tape.exit(part),)


def exit_without_entry(self, x, axis=tp.AXIS):
    """Rule (c) broken: the group's sum with no entry after it, so each
    cell's sum of squares gets only its own gradient of the total."""
    return self.exit(x, axis)


HEADS = RW._tmix_heads


def u_by_closure(cfg, ctx, w, xr, xk, xv, xg, ww, u, *, chunk):
    """The bonus ``u`` read by closure in the cell's segment, its rows of
    the gathered leaf: its gradient each cell's part, not summed."""
    from repro_torch.distributed import spmd

    H = w["wr"].shape[1] // cfg.wkv_head_dim
    lo = spmd.axis_index("model") * H
    return HEADS(cfg, ctx, w, xr, xk, xv, xg, ww, w["u"][lo:lo + H],
                 chunk=chunk)


ALL_GATHER = tp.Tape.all_gather


def w_in_gradient_sliced(self, x, axis, dim=0, *, replicated=True):
    """zamba2's gathered ``w_in`` taken as if every cell used it whole and
    alike: its gradient's block sliced, not the cells' partial sums
    reduce-scattered (what a cell reading the step's whole gathered leaf
    by closure gets, whose gradient the step slices)."""
    return ALL_GATHER(self, x, axis, dim, replicated=True)


# zamba2's ``conv_w`` left out of the leaves that enter the cell's
# segment: the mixer reads it by closure, on the cell's channels and B and
# C, and its gradient is each cell's part, not summed
conv_w_by_closure = tuple(n for n in MB.ENTERED if n != "conv_w")


@pytest.mark.parametrize("arch,breach", [
    (AUDIO, "xattn_src_by_closure"), (AUDIO, "xattn_entry_without_psum"),
    (SSM, "cmix_gate_before_exit"), (SSM, "exit_without_entry"),
    (SSM, "u_by_closure"), (HYBRID, "w_in_gradient_sliced"),
    (HYBRID, "conv_w_by_closure"), (HYBRID, "exit_without_entry"),
    (HYBRID, "attn_half_norm_after_entry")])
def test_family_planted_breaches_fail_the_reference_differential(
        family_reference, monkeypatch, arch, breach):
    ref = family_reference[arch]
    assert gaps_after(family_trainer(arch, virtual(1, 2)), ref, "1x2") == []
    target = {"xattn_src_by_closure": (T, "_xattn_half"),
              "xattn_entry_without_psum": (T, "_xattn_half"),
              "cmix_gate_before_exit": (RW, "_cmix_half"),
              "exit_without_entry": (tp.Tape, "total"),
              "u_by_closure": (RW, "_tmix_heads"),
              "w_in_gradient_sliced": (tp.Tape, "all_gather"),
              "conv_w_by_closure": (MB, "ENTERED"),
              "attn_half_norm_after_entry": (T, "_attn_half")}[breach]
    monkeypatch.setattr(*target, globals()[breach])
    assert gaps_after(family_trainer(arch, virtual(1, 2)), ref, "1x2"), breach


# --- the dry-run's collectives ---------------------------------------------------------------


def cell_trace(arch, **run_kw):
    """One cell of a (2, 2) mesh of meta devices traced alone
    (``dryrun``'s trace of a partitioned step) at the smoke config."""
    b = registry.get(arch)
    mesh = dryrun._meta_mesh((2, 2), ("data", "model"))
    ctx = ShardingCtx.for_mesh(mesh, "moe_a2a" if run_kw else "baseline")
    prog = build_program(b.smoke, b.run.replace(**run_kw),
                         ShapeSpec("t", "train", SEQ, BATCH), ctx)
    fn, args = prog.cell
    return op_analysis.analyze(spmd.one_cell(fn, mesh), *args).per_axes


def count(per_axes, key) -> int:
    return per_axes.get(key, {"count": 0})["count"]


def test_dry_run_counts_the_model_axis_collectives():
    """smollm: each layer's MLP exit and entry (its attention repeats);
    olmoe: each layer's attention exit and entry and its experts' exit
    and two entries (the activations', the routing weights'), or, with
    the a2a, its two all-to-alls each way, its all-gather, the entries of
    the activations and the router and the aux loss's exit; whisper: each
    encoder layer's attention and MLP exits and entries, each decoder
    layer's too and its cross attention's exit and two entries (the
    stream's, the encoder output's); rwkv6: each layer's time mix (the
    five streams', ``u``'s and ``ln_x``'s scale's entries, the sum of
    squares' exit and entry, the exit) and channel mix (an entry, an
    exit); zamba2: each Mamba2 layer's entries (the normed stream's, the
    five leaves of ``mamba2.ENTERED``, the gated norm's scale's), its sum
    of squares' exit and entry and its exit, 10 all-reduces, and its
    ``w_in`` gathered in the tape, one all-gather and, backward, one
    reduce-scatter; each application of the shared block its attention's
    and MLP's exits and entries, 4; so 10 L + 4 n_app + 4 in all; every
    step one exit of the embedding and three of the loss head (the final
    norm's entry, the logsumexps' max and the sum of their exponentials
    beside the label logits). The parameters' all-gathers over
    ``model``: smollm's four attention leaves, olmoe's router; whisper,
    rwkv6 and zamba2 none (zamba2's L are its tapes' ``w_in``)."""
    L = registry.get("smollm-135m").smoke.num_layers
    per = cell_trace("smollm-135m")
    assert count(per, "all-reduce over model") == 2 * L + 4
    assert count(per, "all-gather over model") == 4
    assert count(per, "all-to-all over model") == 0
    L = registry.get(MOE).smoke.num_layers
    per = cell_trace(MOE)
    assert count(per, "all-reduce over model") == 5 * L + 4
    assert count(per, "all-gather over model") == 1
    per = cell_trace(MOE, moe_impl="a2a")
    assert count(per, "all-reduce over model") == 5 * L + 4
    assert count(per, "all-to-all over model") == 4 * L
    assert count(per, "all-gather over model") == L + 1
    cfg = registry.get(AUDIO).smoke
    per = cell_trace(AUDIO)
    assert count(per, "all-reduce over model") == (
        4 * cfg.encoder_layers + 7 * cfg.num_layers + 4)
    assert count(per, "all-gather over model") == 0
    L = registry.get(SSM).smoke.num_layers
    per = cell_trace(SSM)
    assert count(per, "all-reduce over model") == 12 * L + 4
    assert count(per, "all-gather over model") == 0
    assert count(per, "all-to-all over model") == 0
    cfg = registry.get(HYBRID).smoke
    L, n_app = cfg.num_layers, MB.n_shared_applications(cfg)
    per = cell_trace(HYBRID)
    assert count(per, "all-reduce over model") == 10 * L + 4 * n_app + 4
    assert count(per, "all-gather over model") == L
    assert count(per, "reduce-scatter over model") == L
    assert count(per, "all-to-all over model") == 0


def test_dry_run_activation_term_is_the_cells_own_where_nothing_repeats():
    """On the reference's 16 x 16 mesh: olmoe-1b-7b splits its 16 heads,
    64 experts and 50304 rows of vocabulary over 16; smollm-135m's 9
    heads do not split, so its attention repeats; so do the VLM's self
    and cross attention (8 kv heads), which split over the 4 of a (64, 4)
    mesh of the same 256 chips, where nothing of the VLM repeats.
    rwkv6-7b splits its 64 WKV heads, 14336 channel-mix columns and 65536
    rows over 16; so does zamba2-7b its 112 SSD heads, 14576 ``w_in``
    columns, the shared block's 32 heads and 14336 MLP columns and its
    32000 rows; whisper-small's 12 heads do not split over 16 but do
    over 4, and its vocabulary of 51865 over neither: its term stays an
    upper bound."""
    shape = ShapeSpec("t", "train", 4096, 256)
    single = dryrun.MESHES["single"]
    quad = ((64, 4), ("data", "model"))
    for arch, grid, want in (
            (MOE, single, []), ("smollm-135m", single, ["attention"]),
            (VLM, single, ["attention", "cross attention"]),
            (VLM, quad, []), (SSM, single, []), (HYBRID, single, []),
            (AUDIO, single, ["attention", "cross attention",
                             "embedding and logits"]),
            (AUDIO, quad, ["embedding and logits"])):
        b = registry.get(arch)
        prog = build_program(b.model, b.run, shape,
                             ShardingCtx.for_mesh(dryrun._meta_mesh(*grid)))
        assert prog.fn.plan.repeated(b.model) == want
