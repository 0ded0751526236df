"""The port's gradient compression (``distributed/compression``) against
the reference's, on numpy inputs from a seed.

int8 with error feedback (over 3 steps of a gradient tree, each step's
residual fed to the next) and top-k with error feedback: the int8 codes
and the top-k indices exactly, the scales, values and residuals to one
float32 ulp (both round half to even). ``compressed_psum_int8`` inside
``shard_map`` over a ("data",) mesh: exactly, on 1 cell with the
reference in this process and on 4 cells with the reference on 4 fake
host devices in a subprocess (``test_torch_spmd.run_reference``, under
``jax.jit``), the port on a virtual mesh of the CPU; and within one
quantisation step of the plain mean.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.distributed import compression as R  # noqa: E402
from repro_torch.distributed import compression as T  # noqa: E402
from repro_torch.distributed import spmd  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from test_torch_spmd import run_reference  # noqa: E402

CPU = torch.device("cpu")
SHAPES = {"w": (16, 33), "b": (33,), "e": {"k": (4, 8, 8), "s": ()}}


def grads(seed):
    rng = np.random.default_rng(seed)
    return P.tree_map(lambda s: np.asarray(rng.standard_normal(s) * 10.0 ** float(
        rng.integers(-3, 2)), np.float32), SHAPES)


def flat(tree, prefix=""):
    """{key path: leaf}: the two packages order a dict's leaves apart."""
    out = {}
    for k, v in tree.items():
        out.update(flat(v, f"{prefix}{k}/") if isinstance(v, dict)
                   else {prefix + k: v})
    return out


def pairs(tree, jtree):
    a, b = flat(tree), flat(jtree)
    assert a.keys() == b.keys()
    return [(a[k], b[k]) for k in sorted(a)]


def ulp_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


def test_int8_error_feedback_over_three_steps_matches_reference():
    res = T.init_residuals(P.tree_map(torch.from_numpy, grads(0)))
    jres = R.init_residuals(P.tree_map(jnp.asarray, grads(0)))
    for step in range(3):
        g = grads(step + 1)
        qs, scales, res = T.compress_tree_int8(
            P.tree_map(torch.from_numpy, g), res)
        jqs, jscales, jres = R.compress_tree_int8(
            P.tree_map(jnp.asarray, g), jres)
        for a, b in pairs(qs, jqs):
            assert a.dtype == torch.int8
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in pairs(scales, jscales):
            ulp_close(a.numpy(), b)
        for a, b in pairs(res, jres):
            ulp_close(a.numpy(), b)
        deq = T.decompress_tree_int8(qs, scales)
        jdeq = R.decompress_tree_int8(jqs, jscales)
        for a, b in pairs(deq, jdeq):
            ulp_close(a.numpy(), b)


def test_quantize_rounds_half_to_even():
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 63.5])
    q, scale = T.quantize_int8(x)
    jq, jscale = R.quantize_int8(jnp.asarray(x.numpy()))
    assert float(scale) == float(jscale) == 1.0
    assert q.tolist() == np.asarray(jq).tolist() == [127, 0, 2, 2, 0, -2, 64]


@pytest.mark.parametrize("k_frac", [0.01, 0.1, 0.5])
def test_topk_error_feedback_matches_reference(k_frac):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((40, 25)).astype(np.float32)
    r = (0.1 * rng.standard_normal((40, 25))).astype(np.float32)
    (vals, idx), res = T.ef_compress_topk(torch.from_numpy(x),
                                          torch.from_numpy(r), k_frac)
    (jvals, jidx), jres = R.ef_compress_topk(jnp.asarray(x), jnp.asarray(r),
                                             k_frac)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    ulp_close(vals.numpy(), jvals)
    ulp_close(res.numpy(), jres)
    dense = T.decompress_topk((vals, idx), (40, 25))
    ulp_close(dense.numpy(), R.decompress_topk((jvals, jidx), (40, 25)))


def port_psum(xs, n):
    mesh = make_mesh((n,), ("data",), [CPU] * n)
    return spmd.shard_map(lambda x: T.compressed_psum_int8(x[0], "data"),
                          mesh, in_specs=(("data",),),
                          out_specs=())(torch.from_numpy(xs)).numpy()


REF = """
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as PS
from repro.distributed.compression import compressed_psum_int8
mesh = jax.make_mesh((4,), ("data",))
fn = shard_map(lambda x: compressed_psum_int8(x[0], "data"), mesh=mesh,
               in_specs=(PS("data"),), out_specs=PS(), check_rep=False)
out["mean"] = jax.jit(fn)(inp["xs"])
"""


def cells(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 24, 7)) *
            np.array([1.0, 0.01, 3.0, 0.5][:n])[:, None, None]
            ).astype(np.float32)


def test_compressed_psum_on_four_cells_matches_reference():
    xs = cells(7, 4)
    want = run_reference(REF, {"xs": xs}, 4)["mean"]
    got = port_psum(xs, 4)
    np.testing.assert_array_equal(got, want)
    step = np.abs(xs).max() / 127.0  # the agreed scale
    assert np.abs(got - xs.mean(0)).max() <= step


def test_compressed_psum_on_one_cell_matches_reference():
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as PS

    xs = cells(8, 1)
    mesh = jax.make_mesh((1,), ("data",))
    fn = shard_map(lambda x: R.compressed_psum_int8(x[0], "data"), mesh=mesh,
                   in_specs=(PS("data"),), out_specs=PS(), check_rep=False)
    want = np.asarray(jax.jit(fn)(jnp.asarray(xs)))
    got = port_psum(xs, 1)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got - xs[0]).max() <= np.abs(xs).max() / 127.0 / 2
