"""The port's expert-parallel MoE (``models/moe_a2a``) against the
reference's ``moe_a2a_apply``.

The MoE layer's weights and a (2, 32, d) input are drawn with numpy from
a seed and handed to both packages, float32. olmoe-1b-7b's smoke config
and llama4-scout's (a shared expert), and the reference's capacity-drop
case (the router biased by 10 toward expert 0, so an expert's C slots
overflow): y and aux within 1e-5 x max(1, max|ref|), the gradients of
every weight and of x against ``jax.grad`` within 1e-4 x max(1,
max|ref|). On a (1, 1) mesh the reference runs in this process; on
(1, 4) and (2, 2) meshes (the experts split 4 and 2 ways, the batch 2
ways on (2, 2)) in one subprocess on 4 fake host devices
(``test_torch_spmd.run_reference``, the reference under ``jax.jit``),
the port on virtual meshes of the CPU. The port's a2a path is also held
to its own dense dispatch within the reference's 2e-2 (y) and 1e-3 (aux)
(tests/test_moe_a2a.py).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import registry as jax_registry  # noqa: E402
from repro.distributed.sharding import ShardingCtx as JaxCtx  # noqa: E402
from repro.launch.mesh import make_elastic_mesh as jax_mesh  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models.moe_a2a import moe_a2a_apply as jax_a2a  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.distributed.sharding import ShardingCtx  # noqa: E402
from repro_torch.launch.mesh import make_elastic_mesh  # noqa: E402
from repro_torch.models import moe, moe_a2a  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from test_torch_rwkv import assert_close  # noqa: E402
from test_torch_spmd import run_reference  # noqa: E402

CPU = torch.device("cpu")
OLMOE, SCOUT = "olmoe-1b-7b", "llama4-scout-17b-a16e"
CASES = {  # name: (arch, mesh (data, model), router bias toward expert 0)
    "olmoe_1x4": (OLMOE, (1, 4), 0.0),
    "olmoe_2x2": (OLMOE, (2, 2), 0.0),
    "scout_1x4": (SCOUT, (1, 4), 0.0),
    "scout_2x2": (SCOUT, (2, 2), 0.0),
    "olmoe_drops_1x4": (OLMOE, (1, 4), 10.0),
}
GRAD_CASE = "olmoe_2x2"


def layer_inputs(arch, seed, bias=0.0):
    """The layer's weights (moe_specs' tree, at its init scale) and x, the
    cotangent g of y, numpy float32."""
    cfg = jax_registry.get(arch).smoke
    rng = np.random.default_rng(seed)

    def draw(spec):
        x = rng.standard_normal(spec.shape).astype(np.float32)
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        return x * np.float32(spec.scale / np.sqrt(fan_in))

    w = P.tree_map(draw, jax_moe.moe_specs(cfg))
    w["router"][:, 0] += np.float32(bias)
    x = (0.5 * rng.standard_normal((2, 32, cfg.d_model))).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    return w, x, g


def port_a2a(arch, mesh_shape, w, x, grads=None):
    cfg = registry.get(arch).smoke
    d, m = mesh_shape
    ctx = ShardingCtx.for_mesh(make_elastic_mesh(d, m, devices=[CPU] * (d * m)))
    pw = P.tree_map(lambda a: torch.from_numpy(a).requires_grad_(), w)
    px = torch.from_numpy(x).requires_grad_()
    y, aux = moe.moe_apply(cfg, ctx, pw, px, impl="a2a")
    if grads is None:
        return y.detach(), aux.detach()
    ((y * torch.from_numpy(grads)).sum() + aux).backward()
    return px.grad, P.tree_map(lambda a: a.grad, pw)


def check_grads(gx, gw, jgx, jgw):
    assert_close(gx, jgx, 1e-4, "dx")
    want = dict(zip(flat_keys(jgw), P.leaves(jgw)))
    got = dict(zip(flat_keys(gw), P.leaves(gw)))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert_close(got[k], v, 1e-4, f"d{k}")


def flat_keys(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat_keys(v, f"{prefix}{k}/")
        else:
            yield prefix + k


REF = """
from repro.configs import registry
from repro.distributed.sharding import ShardingCtx
from repro.launch.mesh import make_elastic_mesh
from repro.models.moe_a2a import moe_a2a_apply
for name, (arch, (d, m), w, x, g) in inp["cases"].items():
    cfg = registry.get(arch).smoke
    ctx = ShardingCtx.for_mesh(make_elastic_mesh(d, m))
    fwd = jax.jit(lambda w, x: moe_a2a_apply(cfg, ctx, w, x))
    out[name] = fwd(w, x)
    if name == inp["grad_case"]:
        def loss(w, x):
            y, aux = moe_a2a_apply(cfg, ctx, w, x)
            return jnp.sum(y * g) + aux
        out["grads"] = jax.jit(jax.grad(loss, argnums=(0, 1)))(w, x)
"""


@pytest.fixture(scope="module")
def reference():
    cases = {}
    for seed, (name, (arch, mesh, bias)) in enumerate(CASES.items()):
        w, x, g = layer_inputs(arch, seed, bias)
        cases[name] = (arch, mesh, w, x, g)
    return cases, run_reference(REF, {"cases": cases,
                                      "grad_case": GRAD_CASE}, 4)


@pytest.mark.parametrize("name", sorted(CASES))
def test_a2a_matches_reference_on_several_cells(reference, name):
    cases, ref = reference
    arch, mesh, w, x, _ = cases[name]
    y, aux = port_a2a(arch, mesh, w, x)
    assert_close(y, ref[name][0], 1e-5, f"{name} y")
    assert_close(aux, ref[name][1], 1e-5, f"{name} aux")


def test_a2a_gradients_match_reference_on_several_cells(reference):
    cases, ref = reference
    arch, mesh, w, x, g = cases[GRAD_CASE]
    gx, gw = port_a2a(arch, mesh, w, x, grads=g)
    jgw, jgx = ref["grads"]
    check_grads(gx, gw, jgx, jgw)


@pytest.mark.parametrize("arch,bias", [(OLMOE, 0.0), (SCOUT, 0.0),
                                       (OLMOE, 10.0)])
def test_a2a_on_one_cell_matches_reference_with_gradients(arch, bias):
    w, x, g = layer_inputs(arch, 7, bias)
    cfg = jax_registry.get(arch).smoke
    ctx = JaxCtx.for_mesh(jax_mesh(1, 1))
    jw, jx = P.tree_map(jnp.asarray, w), jnp.asarray(x)
    jy, jaux = jax.jit(lambda w, x: jax_a2a(cfg, ctx, w, x))(jw, jx)
    y, aux = port_a2a(arch, (1, 1), w, x)
    assert_close(y, jy, 1e-5, "y")
    assert_close(aux, jaux, 1e-5, "aux")

    def loss(w, x):
        y, aux = jax_a2a(cfg, ctx, w, x)
        return jnp.sum(y * g) + aux

    jgw, jgx = jax.jit(jax.grad(loss, argnums=(0, 1)))(jw, jx)
    gx, gw = port_a2a(arch, (1, 1), w, x, grads=g)
    check_grads(gx, gw, jgx, jgw)


@pytest.mark.parametrize("arch", [OLMOE, SCOUT])
@pytest.mark.parametrize("mesh", [(1, 1), (1, 4), (2, 2)])
def test_a2a_matches_the_ports_dense_dispatch(arch, mesh):
    w, x, _ = layer_inputs(arch, 3)
    cfg = registry.get(arch).smoke
    y, aux = port_a2a(arch, mesh, w, x)
    y_dense, aux_dense = moe.moe_apply(
        cfg, ShardingCtx.null(), P.tree_map(torch.from_numpy, w),
        torch.from_numpy(x), impl="dense")
    assert float((y - y_dense).abs().max()) <= 2e-2
    assert abs(float(aux) - float(aux_dense)) < 1e-3


def test_pair_capacity_matches_reference():
    from repro.models.moe_a2a import _pair_capacity as jax_cap
    for arch in (OLMOE, SCOUT, "olmoe-1b-7b"):
        for t_m in (1, 7, 16, 1024, 4096):
            cfg, jcfg = registry.get(arch).model, jax_registry.get(arch).model
            assert moe_a2a._pair_capacity(t_m, cfg) == jax_cap(t_m, jcfg)
