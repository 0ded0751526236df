"""The port's single-controller ``shard_map`` and its collectives
(``repro_torch.distributed.spmd``) on virtual meshes of the CPU, and the
public ``make_mesh``.

Each collective is held against its definition computed on whole
tensors (exact: the sums add in cell order), forward and gradient: the
gradient through ``psum`` is the sum of the cotangents, through
``ppermute`` the reverse hand-off. A cell that raises re-raises in the
caller within a timeout, cells that disagree on a collective all raise,
and the caller's grad mode, inference mode and autocast hold in every
cell. ``run_reference`` runs a script of the reference package on fake
host devices in a subprocess (as ``tests/test_pipeline.py`` does); the
other ``test_torch_*`` files of the mesh-parallel paths use it.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.distributed import spmd  # noqa: E402
from repro_torch.launch.mesh import make_elastic_mesh, make_mesh  # noqa: E402

CPU = torch.device("cpu")
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))

_PRELUDE = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={n}"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp, numpy as np
with open(sys.argv[1], "rb") as f:
    inp = pickle.load(f)
out = {{}}
"""
_EPILOGUE = """
with open(sys.argv[2], "wb") as f:
    pickle.dump(jax.tree.map(np.asarray, out), f)
"""


def run_reference(body: str, inp: dict, n_devices: int) -> dict:
    """Runs ``body`` in a subprocess with ``n_devices`` fake host devices:
    it reads the dict ``inp`` (numpy arrays and plain values) and fills
    the dict ``out``, whose leaves come back as numpy arrays."""
    env = {**os.environ, "PYTHONPATH": SRC}
    env.pop("XLA_FLAGS", None)
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.pkl"), os.path.join(tmp, "out.pkl")
        with open(src, "wb") as f:
            pickle.dump(inp, f)
        script = _PRELUDE.format(n=n_devices) + body + _EPILOGUE
        proc = subprocess.run([sys.executable, "-c", script, src, dst],
                              env=env, capture_output=True, text=True,
                              timeout=600)
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
        with open(dst, "rb") as f:
            return pickle.load(f)


def virtual(shape, axes):
    n = int(np.prod(shape))
    return make_mesh(shape, axes, [CPU] * n)


MESH = virtual((2, 2), ("data", "model"))
# every cell's tensor: one slice of a (2, 2, 3, 4) whole, by (data, model)
WHOLE = torch.arange(2 * 2 * 3 * 4, dtype=torch.float32).reshape(2, 2, 3, 4)


def per_cell(fn, whole=WHOLE, out_spec=("data", "model")):
    """``fn`` run on each cell's (3, 4) slice; the cells' (3, 4) results
    stacked back into (2, 2, 3, 4)."""
    def body(x):
        return fn(x[0, 0])[None, None]
    return spmd.shard_map(body, MESH, in_specs=(("data", "model"),),
                          out_specs=out_spec)(whole)


@pytest.mark.parametrize("axis", ["data", "model", ("data", "model")])
def test_reductions_match_their_definition(axis):
    names = (axis,) if isinstance(axis, str) else axis
    dims = tuple(("data", "model").index(a) for a in names)
    want_sum = WHOLE.sum(dim=dims, keepdim=True).expand_as(WHOLE)
    assert torch.equal(per_cell(lambda x: spmd.psum(x, axis)), want_sum)
    assert torch.equal(per_cell(lambda x: spmd.pmean(x, axis)),
                       want_sum / np.prod([2 for _ in names]))
    want_max = WHOLE.amax(dim=dims, keepdim=True).expand_as(WHOLE)
    assert torch.equal(per_cell(lambda x: spmd.pmax(x, axis)), want_max)


def test_axis_index_and_group_size():
    def body(x):
        i = (spmd.axis_index("data"), spmd.axis_index("model"),
             spmd.axis_index(("data", "model")),
             spmd.axis_index(("model", "data")), spmd.psum(1, "model"))
        return torch.tensor(i)[None, None]
    got = spmd.shard_map(body, MESH, in_specs=((),),
                         out_specs=("data", "model"))(torch.zeros(()))
    want = [[[d, m, 2 * d + m, 2 * m + d, 2] for m in range(2)]
            for d in range(2)]
    assert got.tolist() == want


@pytest.mark.parametrize("axis", [0, 1])
def test_all_gather_matches_its_definition(axis):
    def body(x):
        return spmd.all_gather(x[0, 0], "model", axis=axis)[None]
    got = spmd.shard_map(body, MESH, in_specs=(("data", "model"),),
                         out_specs=("data",))(WHOLE)
    for d in range(2):
        assert torch.equal(got[d], torch.cat([WHOLE[d, m] for m in range(2)],
                                             axis))


@pytest.mark.parametrize("split,concat", [(0, 0), (0, 1), (1, 0), (1, 2),
                                          (2, 1)])
def test_all_to_all_matches_its_definition(split, concat):
    mesh = virtual((4,), ("model",))
    shape = [3, 5, 6]
    shape[split] = 4
    x = torch.randn(4, *shape, generator=torch.Generator().manual_seed(0))
    got = spmd.shard_map(
        lambda xs: spmd.all_to_all(xs[0], "model", split, concat)[None],
        mesh, in_specs=(("model",),), out_specs=("model",))(x)
    for i in range(4):  # index i of every source, stacked in source order
        want = torch.stack([x[j].select(split, i) for j in range(4)], concat)
        assert torch.equal(got[i], want)


def test_all_to_all_needs_the_group_size_at_split_axis():
    mesh = virtual((4,), ("model",))
    with pytest.raises(ValueError, match="group's 4"):
        spmd.shard_map(lambda xs: spmd.all_to_all(xs[0], "model", 0, 0)[None],
                       mesh, in_specs=(("model",),),
                       out_specs=("model",))(torch.zeros(4, 8, 2))


def test_ppermute_hands_off_and_fills_zeros():
    perm = [(0, 1), (1, 2), (2, 3)]  # nothing reaches cell 0
    mesh = virtual((4,), ("pod",))
    x = torch.arange(8.).reshape(4, 2)
    got = spmd.shard_map(lambda xs: spmd.ppermute(xs, "pod", perm), mesh,
                         in_specs=(("pod",),), out_specs=("pod",))(x)
    assert got.tolist() == [[0, 0], [0, 1], [2, 3], [4, 5]]


def test_gradients_are_the_transposes():
    """psum's gradient is the sum of the cotangents over the group; a
    ring ppermute's is the reverse hand-off."""
    mesh = virtual((4,), ("pod",))
    g = torch.Generator().manual_seed(1)
    x = torch.randn(4, 3, generator=g, requires_grad=True)
    w = torch.randn(4, 3, generator=g)
    ring = [(i, (i + 1) % 4) for i in range(4)]
    y = spmd.shard_map(
        lambda xs: spmd.ppermute(spmd.psum(xs, "pod") * xs, "pod", ring),
        mesh, in_specs=(("pod",),), out_specs=("pod",))(x)
    (y * w).sum().backward()
    xd = x.detach().requires_grad_()
    want = torch.roll(xd.sum(0, keepdim=True) * xd, 1, dims=0)
    (want * w).sum().backward()
    assert torch.allclose(y, want, atol=1e-6, rtol=1e-6)
    assert torch.allclose(x.grad, xd.grad, atol=1e-6, rtol=1e-6)


def test_sums_repeat_in_cell_order():
    mesh = virtual((4,), ("data",))
    x = torch.randn(4, 1000, generator=torch.Generator().manual_seed(2))
    fn = spmd.shard_map(lambda xs: spmd.psum(xs[0], "data"), mesh,
                        in_specs=(("data",),), out_specs=())
    want = ((x[0] + x[1]) + x[2]) + x[3]
    for _ in range(3):
        assert torch.equal(fn(x), want)


def test_shards_are_views_and_outputs_reassemble():
    x = torch.arange(24.).reshape(4, 6)
    seen = []

    def body(xs):
        seen.append(xs.data_ptr())
        return xs * 2

    got = spmd.shard_map(body, MESH, in_specs=(("model", "data"),),
                         out_specs=("model", "data"))(x)
    assert torch.equal(got, x * 2)
    base, esize = x.data_ptr(), x.element_size()
    assert sorted((p - base) // esize for p in seen) == [0, 3, 12, 15]


def test_a_dim_the_axes_do_not_divide_raises():
    fn = spmd.shard_map(lambda xs: xs, MESH, in_specs=(("data",),),
                        out_specs=("data",))
    with pytest.raises(ValueError, match="do not divide"):
        fn(torch.zeros(3, 2))
    with pytest.raises(ValueError, match="no mesh axis"):
        spmd.shard_map(lambda xs: xs, MESH, in_specs=(("pod",),),
                       out_specs=())(torch.zeros(4))


def test_a_raising_cell_reraises_in_the_caller():
    def body(xs):
        if spmd.axis_index("model") == 1:
            raise KeyError("cell 1")
        return spmd.psum(spmd.psum(xs, "model"), "data")

    result = {}

    def caller():
        try:
            spmd.shard_map(body, MESH, in_specs=((),), out_specs=())(
                torch.ones(2))
        except KeyError as e:
            result["raised"] = e

    t = threading.Thread(target=caller)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive(), "shard_map hung on a failed cell"
    assert str(result["raised"]) == "'cell 1'"


def test_cells_that_disagree_on_a_collective_raise():
    def body(xs):
        if spmd.axis_index("data") == 0:
            return spmd.psum(xs, "model")
        return spmd.pmax(xs, "model")

    with pytest.raises(spmd.SpmdError, match="disagree"):
        spmd.shard_map(body, MESH, in_specs=((),), out_specs=())(torch.ones(2))
    with pytest.raises(RuntimeError, match="inside shard_map"):
        spmd.psum(torch.ones(2), "model")


def test_the_callers_thread_state_holds_in_every_cell():
    def body(xs):
        state = (torch.is_grad_enabled(), torch.is_inference_mode_enabled(),
                 torch.is_autocast_enabled("cpu"))
        return torch.tensor(state)[None]

    mesh = virtual((4,), ("data",))
    fn = spmd.shard_map(body, mesh, in_specs=((),), out_specs=("data",))
    with torch.no_grad():
        assert fn(torch.ones(1)).tolist() == [[False, False, False]] * 4
    assert fn(torch.ones(1)).tolist() == [[True, False, False]] * 4
    with torch.inference_mode():
        assert fn(torch.ones(1)).tolist() == [[False, True, False]] * 4
    with torch.autocast("cpu", dtype=torch.bfloat16):
        assert fn(torch.ones(1)).tolist() == [[True, False, True]] * 4
        y = spmd.shard_map(lambda a, b: a @ b, mesh, in_specs=((), ()),
                           out_specs=())(torch.ones(2, 2), torch.ones(2, 2))
        assert y.dtype == torch.bfloat16


def test_make_mesh_takes_any_axes():
    pod = make_mesh((3,), ("pod",), [CPU] * 3)
    assert pod.axis_names == ("pod",) and pod.devices.shape == (3,)
    dm = make_mesh((2, 2), ("data", "model"), [CPU] * 5)
    assert dm.devices.shape == (2, 2)
    el = make_elastic_mesh(1, 4, devices=[CPU] * 4)
    assert (el.axis_names, el.devices.shape) == (("data", "model"), (1, 4))
    with pytest.raises(ValueError, match="differ in rank"):
        make_mesh((2, 2), ("pod",), [CPU] * 4)
    with pytest.raises(RuntimeError, match="need 4 devices"):
        make_mesh((4,), ("pod",), [CPU] * 3)


# --- MeshArray arguments and outputs, psum_block, one_cell ---------------------------------


def test_mesh_array_arguments_pass_uncopied_and_outputs_stay_in_cells():
    """A MeshArray laid out as the in-spec says gives each cell its own
    tensor (the same storage); with ``keep`` each cell's result is the
    output's shard at its position, not reassembled."""
    from repro_torch.distributed.sharding import MeshSharding, place

    x = place(WHOLE, MeshSharding(MESH, ("data", "model")))
    seen, made = [None] * 4, [None] * 4

    def body(xs):
        pos = spmd.position()
        seen[pos] = xs.data_ptr()
        made[pos] = xs * 2
        return made[pos]

    out = spmd.shard_map(body, MESH, in_specs=(("data", "model"),),
                         out_specs=("data", "model"), keep=True)(x)
    assert seen == [t.data_ptr() for t in x.shards]
    assert all(a is b for a, b in zip(out.shards, made))
    assert out.shape == tuple(WHOLE.shape)
    assert out.sharding == MeshSharding(MESH, ("data", "model"))
    assert torch.equal(out.gather(), WHOLE * 2)


def test_mesh_array_laid_out_otherwise_raises():
    from repro_torch.distributed.sharding import MeshSharding, place

    x = place(WHOLE, MeshSharding(MESH, ("model", "data")))
    with pytest.raises(ValueError, match="in-spec"):
        spmd.shard_map(lambda t: t, MESH, in_specs=(("data", "model"),),
                       out_specs=("data", "model"))(x)


def test_place_and_gather_round_trip_with_replicated_copies():
    """Positions that replicate a block hold copies of their own."""
    from repro_torch.distributed.sharding import MeshSharding, place

    x = place(WHOLE, MeshSharding(MESH, (None, "model")))
    assert [tuple(t.shape) for t in x.shards] == [(2, 1, 3, 4)] * 4
    assert torch.equal(x.shards[0], x.shards[2])
    assert x.shards[0].data_ptr() != x.shards[2].data_ptr()
    assert torch.equal(x.gather(), WHOLE)
    assert [(p, idx) for p, idx, _ in x.addressable_shards][1] == (
        1, (slice(None), slice(1, 2), slice(None), slice(None)))


def test_psum_block_is_each_cells_block_of_the_sum():
    """Over "data", each cell sums the members' blocks at its own index:
    a reduce-scatter where the index cuts, an all-reduce where it does
    not; the observer names each."""
    seen = []

    def body(x, cut):
        blk = (slice(spmd.axis_index("data") * 2,
                     spmd.axis_index("data") * 2 + 2),) if cut else ()
        return spmd.psum_block(x[0, 0], "data", blk)[None, None]

    for cut, out_spec in ((True, ("data", "model")),
                          (False, ("data", "model"))):
        whole = torch.arange(2 * 2 * 4 * 3, dtype=torch.float32).reshape(
            2, 2, 4, 3)
        with spmd.observe(lambda op, out, n, cell, **kw: seen.append((op, n))):
            got = spmd.shard_map(lambda x: body(x, cut), MESH,
                                 in_specs=(("data", "model"),),
                                 out_specs=out_spec)(whole)
        total = whole.sum(dim=0)  # (2, 4, 3): by model
        for d in range(2):
            for m in range(2):
                want = total[m, 2 * d:2 * d + 2] if cut else total[m]
                assert torch.equal(got[d, m], want)
    assert set(seen) == {("reduce-scatter", 2), ("all-reduce", 2)}


def test_one_cell_runs_one_cell_with_the_mesh_group_sizes():
    """``one_cell``: the function runs in the caller's thread as the cell
    at ``pos``; collectives see the mesh's group sizes and this cell's
    deposit for every member."""
    mesh = virtual((4, 2), ("data", "model"))
    seen = []

    def cell(x):
        assert spmd.position() == 3 and spmd.axis_index("data") == 1
        return spmd.all_gather(x, "data"), spmd.psum(x, "model")

    with spmd.observe(lambda op, out, n, c, **kw: seen.append((op, n, c))):
        g, s = spmd.one_cell(cell, mesh, pos=3)(torch.ones(2))
    assert tuple(g.shape) == (8,) and torch.equal(s, torch.full((2,), 2.0))
    assert seen == [("all-gather", 4, 3), ("all-reduce", 2, 3)]
