"""The port's reshard planner, sharding rules, meshes and ``MeshCap``
against the reference's, on the CPU.

The planner cases of ``test_reshard.py`` run on both packages' functions
and must agree op for op. The elastic differential saves one tree on a
("data", "model") = (2, 2) mesh and restores it onto the same, a halved
(1, 2) and a doubled (4, 2) mesh: the reference on 8 fake host devices in
its own subprocess (as ``RESHARD_SCRIPT`` does), the port on virtual
meshes of the CPU. Values, each mesh position's index map and every
leaf's metered host peak must be equal. The sharding rules resolve the
rwkv6-7b and zamba2-7b parameter specs to the same specs as the
reference's under every ruleset and mesh. Tolerance: exact everywhere.
"""

from __future__ import annotations

import copy
import json
import os
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.capability as R_cap  # noqa: E402
import repro.distributed.resharding as R  # noqa: E402
import repro.distributed.sharding as R_sh  # noqa: E402
import repro_torch.core.capability as T_cap  # noqa: E402
import repro_torch.distributed.resharding as T  # noqa: E402
import repro_torch.distributed.sharding as T_sh  # noqa: E402
from repro_torch import checkpoint as T_ck  # noqa: E402
from repro_torch.fs.mounts import make_mount  # noqa: E402
from repro_torch.launch import mesh as T_mesh  # noqa: E402

# --- the planner, held against the reference's -------------------------------

GRID_CASES = [
    ((8, 8), ("d", "m"), {"d": 2, "m": 2}),
    ((7, 5), ("d", None), {"d": 3}),              # uneven
    ((16,), (("d", "m"),), {"d": 2, "m": 3}),     # axis tuple
    ((4, 6, 8), (None, "m", "d"), {"d": 4, "m": 2}),
    ((5, 3), ("d", "m"), {"d": 4, "m": 2}),       # uneven + empty cells
    ((9,), ("d",), {"d": 1}),                     # single-cell grid
    ((), (), {}),                                 # scalar
]


def _ops(ops):
    return [(op.src, op.src_slice, op.dst_slice) for op in ops]


@pytest.mark.parametrize("shape,spec,axes", GRID_CASES)
def test_grids_match_reference(shape, spec, axes):
    t = T.ShardGrid.from_spec(shape, spec, axes)
    r = R.ShardGrid.from_spec(shape, spec, axes)
    assert (t.shape, t.spec, t.axes) == (r.shape, r.spec, r.axes)
    assert (t.grid, t.n_shards) == (r.grid, r.n_shards)
    assert t.indices() == r.indices()
    assert [t.coords(j) for j in range(t.n_shards)] == \
        [r.coords(j) for j in range(r.n_shards)]
    rec = json.loads(json.dumps(t.to_manifest()))
    assert rec == r.to_manifest()
    assert T.ShardGrid.from_manifest(shape, rec) == t


@pytest.mark.parametrize("src_case", GRID_CASES[:-1])
@pytest.mark.parametrize("dst_axes", [{"x": 2}, {"x": 3, "y": 2}])
def test_plans_match_reference(src_case, dst_axes):
    shape, spec, axes = src_case
    names = list(dst_axes)
    dst_spec = tuple(names[i % len(names)] if i % 2 == 0 else None
                     for i in range(len(shape)))
    t_src = T.ShardGrid.from_spec(shape, spec, axes)
    r_src = R.ShardGrid.from_spec(shape, spec, axes)
    t_plans = T.plan_reshard(t_src.indices(),
                             T.ShardGrid.from_spec(shape, dst_spec, dst_axes))
    r_plans = R.plan_reshard(r_src.indices(),
                             R.ShardGrid.from_spec(shape, dst_spec, dst_axes))
    assert [_ops(p) for p in t_plans] == [_ops(p) for p in r_plans]
    for t_p, r_p in zip(t_plans, r_plans):
        assert T.plan_volume(t_p) == R.plan_volume(r_p)
        for budget in (16, 64, 1 << 20):
            assert [_ops(c) for c in T.chunk_ops(t_p, 4, budget, max_ops=3)] \
                == [_ops(c) for c in R.chunk_ops(r_p, 4, budget, max_ops=3)]


def test_index_helpers_match_reference():
    assert T.normalize_index((slice(2, 6), slice(None)), (8, 10)) == \
        R.normalize_index((slice(2, 6), slice(None)), (8, 10)) == \
        ((2, 6), (0, 10))
    src = [((0, 4), (0, 6)), ((4, 8), (0, 6))]
    cell = ((2, 6), (0, 3))
    t_ops = T.shift_ops(T.plan_target_shard(src, cell), cell)
    r_ops = R.shift_ops(R.plan_target_shard(src, cell), cell)
    assert _ops(t_ops) == _ops(r_ops)
    assert _ops(T.plan_target_shard([()], ())) == [(0, (), ())]
    assert T.index_volume(()) == R.index_volume(()) == 1
    assert T.op_bytes(t_ops[0], 4) == R.op_bytes(r_ops[0], 4)


# --- sharding rules: the rwkv6 and zamba2 parameter specs ----------------------


def _duck_mesh(shape, axes):
    """What the rules read of a mesh: axis names and the devices' shape."""
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))


MESHES = [((16, 16), ("data", "model")), ((2, 2), ("data", "model")),
          ((1, 2), ("data", "model")), ((4, 2), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


def _spec_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_leaves(tree[k], path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-7b"])
@pytest.mark.parametrize("ruleset", sorted(R_sh.RULESETS))
def test_parameter_specs_resolve_as_reference(arch, ruleset):
    from repro.configs import registry as R_reg
    from repro.models import lm as R_lm
    from repro_torch.configs import registry as T_reg
    from repro_torch.models import lm as T_lm

    assert sorted(T_sh.RULESETS) == sorted(R_sh.RULESETS)
    assert T_sh.RULESETS[ruleset] == R_sh.RULESETS[ruleset]
    r_specs = dict(_spec_leaves(R_lm.param_specs(R_reg.get(arch).model)))
    t_specs = dict(_spec_leaves(T_lm.param_specs(T_reg.get(arch).model)))
    assert sorted(r_specs) == sorted(t_specs)
    n = 0
    for shape, axes in MESHES:
        mesh = _duck_mesh(shape, axes)
        r_ctx = R_sh.ShardingCtx.for_mesh(mesh, ruleset)
        t_ctx = T_sh.ShardingCtx.for_mesh(mesh, ruleset)
        for path, t in t_specs.items():
            r = r_specs[path]
            assert (t.shape, t.logical) == (r.shape, r.logical), path
            want = tuple(R_sh.resolve_spec(r.logical, r.shape, mesh,
                                           R_sh.RULESETS[ruleset]))
            assert T_sh.resolve_spec(t.logical, t.shape, mesh,
                                     T_sh.RULESETS[ruleset]) == want
            assert t_ctx.spec(t.logical, t.shape) == \
                tuple(r_ctx.spec(r.logical, r.shape)) == want
            n += any(e is not None for e in want)
    assert n > 0  # some specs actually shard


def test_null_context_keeps_the_serve_path():
    ctx = T_sh.ShardingCtx.null()
    x = torch.ones(3)
    assert ctx.mesh is None and ctx.constrain(x, ("batch",)) is x
    assert ctx.rules is T_sh.BASELINE
    with pytest.raises(ValueError):
        ctx.spec(("batch",), (4,))


# --- meshes and MeshCap --------------------------------------------------------


def test_meshes_need_their_devices_and_virtual_meshes_take_one():
    mesh = T_mesh.make_elastic_mesh(4, 2, devices=[torch.device("cpu")] * 8)
    assert mesh.axis_names == ("data", "model")
    assert mesh.devices.shape == (4, 2)
    assert T_mesh.mesh_axis_sizes(mesh) == {"data": 4, "model": 2}
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    with pytest.raises(RuntimeError, match="need 8 devices, have 3"):
        T_mesh.make_elastic_mesh(4, 2, devices=["cpu"] * 3)
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="need 2 devices"):
            T_mesh.make_host_mesh(1, 2)
        with pytest.raises(RuntimeError, match="need 2 devices"):
            T_mesh.make_elastic_mesh(2, 1)
    if torch.cuda.device_count() < 256:
        with pytest.raises(RuntimeError, match="need 256 devices"):
            T_mesh.make_production_mesh()


def test_mesh_cap_grants_and_refusals_as_reference():
    mesh = T_mesh.make_elastic_mesh(2, 4, devices=["cpu"] * 8)
    duck = _duck_mesh((2, 4), ("data", "model"))
    t_cap, r_cap = T_cap.mint_mesh(mesh), R_cap.mint_mesh(duck)
    assert t_cap.axis_names == r_cap.axis_names == ("data", "model")
    assert t_cap.shape == r_cap.shape == (2, 4)
    ctx = t_cap.sharding_ctx("seqpar")
    assert ctx.mesh is mesh and ctx.rules == T_sh.SEQPAR
    assert ctx.spec(("batch", "seq", "embed"), (8, 16, 32)) == tuple(
        r_cap.sharding_ctx("seqpar").spec(("batch", "seq", "embed"),
                                          (8, 16, 32)))
    for cap_mod in (T_cap, R_cap):
        with pytest.raises(cap_mod.CapabilityError):
            cap_mod.MeshCap(mesh)
    for cap in (t_cap, r_cap):
        with pytest.raises(Exception):
            pickle.dumps(cap)
        with pytest.raises(Exception):
            copy.deepcopy(cap)
    t_cap._revoke()
    with pytest.raises(T_cap.CapabilityError, match="revocation"):
        t_cap.axis_names
    with pytest.raises(T_cap.CapabilityError):
        t_cap.sharding_ctx()
    import repro_torch.core as T_core
    assert T_core.MeshCap is T_cap.MeshCap


# --- the elastic differential: mesh A -> {A, halved, doubled} --------------------

SPECS = {"w": ("data", "model"), "e": ("model", None), "b": ("data",),
         "r": (), "s": ()}
TOPOS = {"same": (2, 2), "halved": (1, 2), "doubled": (4, 2)}


def _host():
    rng = np.random.default_rng(3)
    return {"w": rng.normal(size=(64, 32)).astype(np.float32),
            "e": rng.normal(size=(32, 16)).astype(np.float32),
            "b": rng.normal(size=(256,)).astype(np.float32),
            "r": rng.normal(size=(8, 8)).astype(np.float32),
            "s": np.float32(3.5)}


REF_SCRIPT = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import checkpoint as ckpt
from repro.fs.mounts import make_mount
from repro.launch.mesh import make_elastic_mesh

SPECS = json.loads(sys.argv[1])
TOPOS = json.loads(sys.argv[2])
rng = np.random.default_rng(3)
host = {"w": rng.normal(size=(64, 32)).astype(np.float32),
        "e": rng.normal(size=(32, 16)).astype(np.float32),
        "b": rng.normal(size=(256,)).astype(np.float32),
        "r": rng.normal(size=(8, 8)).astype(np.float32),
        "s": np.float32(3.5)}

def spec(k):
    return P(*[tuple(e) if isinstance(e, list) else e for e in SPECS[k]])

def slices(idx):
    return [None if s.start is None and s.stop is None else [s.start, s.stop]
            for s in idx]

mesh_a = make_elastic_mesh(2, 2)
sh_a = {k: NamedSharding(mesh_a, spec(k)) for k in host}
tree = {k: jax.device_put(jnp.asarray(v), sh_a[k]) for k, v in host.items()}
mf = make_mount("bento", n_blocks=16384)
cks = mf.services.checksum
man = ckpt.save(mf.view, "/ck/s1", tree, step=1, checksum=cks, shardings=sh_a)
like = {k: jnp.zeros(host[k].shape, host[k].dtype) for k in host}
out = {"shards": [len(r["shards"]) for r in man["leaves"]], "topos": {}}
for name, (d, m) in TOPOS.items():
    mesh_b = make_elastic_mesh(d, m)
    sh_b = {k: NamedSharding(mesh_b, spec(k)) for k in host}
    for depth in (0, 2):
        stats = {}
        back, _ = ckpt.load(mf.view, "/ck/s1", like, checksum=cks,
                            sharding_tree=sh_b, stats=stats,
                            pipeline_depth=depth)
        for k in host:
            assert (np.asarray(jax.device_get(back[k])) == host[k]).all()
        out["topos"][f"{name}/{depth}"] = {
            "leaves": stats["leaves"],
            "dmap": {k: [slices(back[k].sharding.devices_indices_map(
                host[k].shape)[dev]) for dev in mesh_b.devices.flat]
                for k in host}}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_run():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "src"))
    proc = subprocess.run(
        [sys.executable, "-c", REF_SCRIPT, json.dumps(SPECS),
         json.dumps(TOPOS)], env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stdout[-1500:] + proc.stderr[-1500:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _slices(idx):
    return [None if s.start is None and s.stop is None else [s.start, s.stop]
            for s in idx]


@pytest.mark.parametrize("topo", sorted(TOPOS))
@pytest.mark.parametrize("depth", [0, 2])
def test_elastic_restore_matches_reference(reference_run, topo, depth):
    host = _host()
    cpu8 = [torch.device("cpu")] * 8
    mesh_a = T_mesh.make_elastic_mesh(2, 2, devices=cpu8)
    sh_a = {k: T_sh.MeshSharding(mesh_a, SPECS[k]) for k in host}
    mf = make_mount("bento", n_blocks=16384, device="cpu")
    cks = mf.services.checksum
    man = T_ck.save(mf.view, "/ck/s1",
                    {k: torch.from_numpy(np.array(v)) for k, v in host.items()},
                    step=1, checksum=cks, shardings=sh_a)
    assert [len(r["shards"]) for r in man["leaves"]] == \
        reference_run["shards"] == [2, 2, 1, 1, 4]
    d, m = TOPOS[topo]
    mesh_b = T_mesh.make_elastic_mesh(d, m, devices=cpu8)
    sh_b = {k: T_sh.MeshSharding(mesh_b, SPECS[k]) for k in host}
    like = {k: torch.zeros(v.shape) for k, v in host.items()}
    stats = {}
    back, _ = T_ck.load(mf.view, "/ck/s1", like, checksum=cks,
                        checksum_batch=mf.services.checksum_batch,
                        sharding_tree=sh_b, stats=stats,
                        pipeline_depth=depth, device="cpu")
    want = reference_run["topos"][f"{topo}/{depth}"]
    for k, v in host.items():
        assert np.array_equal(back[k].numpy(), v)
        dmap = sh_b[k].devices_indices_map(v.shape)
        assert [_slices(dmap[p]) for p in range(mesh_b.devices.size)] == \
            want["dmap"][k], k
    # the tree is below the store's inline threshold, so both packages
    # restore without a prefetch thread and their peaks repeat exactly
    assert sum(s["full_bytes"] for s in stats["leaves"]) < \
        T_ck.store._INLINE_BYTES
    assert stats["leaves"] == want["leaves"]
    strict = [s for s in stats["leaves"]
              if s["streamed"] and s["max_target_bytes"] < s["full_bytes"]]
    assert len(strict) >= 2
    assert all(s["peak_bytes"] < s["full_bytes"] for s in strict)
    mf.close()
