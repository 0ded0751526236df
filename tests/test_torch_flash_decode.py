"""The port's sequence-sharded ``flash_decode`` against the reference's.

The same q and KV cache, drawn with numpy from a seed, through
``repro.models.attention.flash_decode`` and the port's, in float32,
within 1e-5: on a (1, 1) mesh with the reference in this process; on
(1, 4) and (2, 2) meshes with the reference on 4 fake host devices in
one subprocess (``test_torch_spmd.run_reference``) and the port on
virtual meshes of the CPU. The cases put ``pos`` in the first, a middle
and the last of 4 cache shards (the other shards fully masked, or none),
take h2o-danube3's smoke sliding window (32, a ring-buffer cache) with a
softcap before and after the ring fills, and slice the batch rows of
the joint ("data",) axis under ``q_replicated`` on (2, 2), and not.
The reference runs under ``jax.jit`` (one compile a case; eager
``shard_map`` takes seconds a call on the CPU).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.launch.mesh import make_elastic_mesh as jax_mesh  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro_torch.launch.mesh import make_elastic_mesh  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from test_torch_spmd import run_reference  # noqa: E402

CPU = torch.device("cpu")
B, HQ, HKV, D = 2, 4, 2, 8
TOL = 1e-5

# (mesh (data, model), cache length, pos, window, softcap, q_replicated)
CASES = {
    "pos_first_shard": ((1, 4), 16, 2, 0, 0.0, True),
    "pos_middle_shard": ((1, 4), 16, 9, 0, 0.0, True),
    "pos_last_shard": ((1, 4), 16, 15, 0, 0.0, True),
    "window_softcap_filling": ((1, 4), 32, 5, 32, 20.0, True),
    "window_softcap_full_ring": ((1, 4), 32, 40, 32, 20.0, True),
    "q_replicated_2x2": ((2, 2), 16, 6, 0, 0.0, True),
    "q_sharded_2x2": ((2, 2), 16, 6, 0, 0.0, False),
}


def inputs(S, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, HQ, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, HKV, D)).astype(np.float32)
            for _ in range(2))
    return q, k, v


def port(case, q, k, v):
    (data, model), _, pos, window, softcap, q_rep = case
    mesh = make_elastic_mesh(data, model, devices=[CPU] * (data * model))
    return attention.flash_decode(
        *map(torch.from_numpy, (q, k, v)), pos, mesh, softcap=softcap,
        window=window, q_replicated=q_rep).numpy()


REF = """
from repro.launch.mesh import make_elastic_mesh
from repro.models.attention import flash_decode
for name, ((data, model), S, pos, window, softcap, q_rep) in inp["cases"].items():
    q, k, v = inp["arrays"][name]
    mesh = make_elastic_mesh(data, model)
    fn = jax.jit(lambda q, k, v, pos: flash_decode(
        q, k, v, pos, mesh, softcap=softcap, window=window,
        q_replicated=q_rep))
    out[name] = fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   jnp.int32(pos))
"""


@pytest.fixture(scope="module")
def reference():
    arrays = {name: inputs(c[1], seed) for seed, (name, c) in
              enumerate(CASES.items())}
    return arrays, run_reference(REF, {"cases": CASES, "arrays": arrays}, 4)


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_decode_matches_reference_on_several_cells(reference, name):
    arrays, want = reference
    got = port(CASES[name], *arrays[name])
    assert got.shape == (B, 1, HQ, D)
    np.testing.assert_allclose(got, want[name], atol=TOL, rtol=0)


@pytest.mark.parametrize("pos,window,softcap", [(9, 0, 0.0), (40, 32, 20.0)])
def test_flash_decode_on_one_cell_matches_reference_and_dense(pos, window,
                                                              softcap):
    S = 32 if window else 16
    q, k, v = inputs(S, 11)
    got = port(((1, 1), S, pos, window, softcap, True), q, k, v)
    mesh = jax_mesh(1, 1)
    want = jax.jit(lambda q, k, v, pos: jax_attention.flash_decode(
        q, k, v, pos, mesh, softcap=softcap, window=window))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(pos))
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=0)
    dense = attention.decode_attention(*map(torch.from_numpy, (q, k, v)),
                                       pos, window=window, softcap=softcap)
    np.testing.assert_allclose(got, dense.numpy(), atol=TOL, rtol=0)
