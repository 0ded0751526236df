"""The port's GPipe pipeline (``distributed/pipeline``) against the
reference's ``pipeline_apply``, and against the sequential stack.

The reference's own case (tests/test_pipeline.py): S 4 stages of L/S = 2
tanh layers each (L 8, d 16), M 6 microbatches of 2, weights and inputs
drawn with numpy from a seed. On a ("pod",) mesh of 4 cells the
reference runs in a subprocess on 4 fake host devices
(``test_torch_spmd.run_reference``, under ``jax.jit``) and the port on a
virtual mesh of the CPU; on 1 cell the reference runs in this process.
Float32: the outputs within 1e-5, the gradients of the stage weights
and of the inputs within 1e-4 (the reference test's bounds), of the
reference and of the port's sequential stack; ``bubble_fraction``
exactly. Every stage applies its layers at every tick, bubbles included.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.distributed import pipeline as jax_pipeline  # noqa: E402
from repro_torch.distributed import pipeline  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from test_torch_spmd import run_reference  # noqa: E402

CPU = torch.device("cpu")
L, M, MB, D = 8, 6, 2, 16


def draw(seed=0):
    rng = np.random.default_rng(seed)
    ws = (0.2 * rng.standard_normal((L, D, D))).astype(np.float32)
    xs = rng.standard_normal((M, MB, D)).astype(np.float32)
    return ws, xs


def stage_fn(w_stage, x):
    for w in w_stage:
        x = torch.tanh(x @ w)
    return x


def port(ws, xs, S):
    """The pipelined outputs and the gradients of sum(out ** 2) w.r.t.
    the (L, D, D) weights and the inputs; calls counted a stage."""
    mesh = make_mesh((S,), ("pod",), [CPU] * S)
    w = torch.from_numpy(ws).requires_grad_()
    x = torch.from_numpy(xs).requires_grad_()
    calls = []

    def counted(p, xx):
        calls.append(1)
        return stage_fn(p, xx)

    out = pipeline.pipeline_apply(counted, w.reshape(S, L // S, D, D), x,
                                  mesh, axis="pod")
    (out ** 2).sum().backward()
    return out.detach(), w.grad, x.grad, len(calls)


def sequential(ws, xs):
    w = torch.from_numpy(ws).requires_grad_()
    x = torch.from_numpy(xs).requires_grad_()
    out = stage_fn(w, x)
    (out ** 2).sum().backward()
    return out.detach(), w.grad, x.grad


REF = """
from repro.distributed.pipeline import pipeline_apply, bubble_fraction

S, L, D = inp["S"], inp["L"], inp["D"]
mesh = jax.make_mesh((S,), ("pod",))

def stage_fn(w_stage, x):
    def body(x, w):
        return jnp.tanh(x @ w), None
    return jax.lax.scan(body, x, w_stage)[0]

def loss(ws, xs):
    out = pipeline_apply(stage_fn, ws.reshape(S, L // S, D, D), xs, mesh,
                         axis="pod")
    return jnp.sum(out ** 2), out

(_, out["out"]), (out["dw"], out["dx"]) = jax.jit(jax.value_and_grad(
    loss, argnums=(0, 1), has_aux=True))(inp["ws"], inp["xs"])
out["bubble"] = np.float64(bubble_fraction(4, 6))
"""


@pytest.fixture(scope="module")
def reference():
    ws, xs = draw()
    return ws, xs, run_reference(REF, {"ws": ws, "xs": xs, "S": 4, "L": L,
                                       "D": D}, 4)


def test_pipeline_matches_reference_on_four_stages(reference):
    ws, xs, ref = reference
    got, dw, dx, calls = port(ws, xs, 4)
    np.testing.assert_allclose(got.numpy(), ref["out"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(dw.numpy(), ref["dw"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(dx.numpy(), ref["dx"], atol=1e-4, rtol=0)
    assert calls == 4 * (M + 4 - 1)  # every stage, every tick
    assert pipeline.bubble_fraction(4, 6) == float(ref["bubble"]) == 3 / 9


@pytest.mark.parametrize("S", [1, 2, 4])
def test_pipeline_matches_the_sequential_stack(S):
    ws, xs = draw(1)
    got, dw, dx, calls = port(ws, xs, S)
    want, want_dw, want_dx = sequential(ws, xs)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(dw.numpy(), want_dw.numpy(), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(dx.numpy(), want_dx.numpy(), atol=1e-4,
                               rtol=0)
    assert calls == S * (M + S - 1)


def test_pipeline_on_one_stage_matches_reference_in_process():
    ws, xs = draw(2)
    mesh = jax.make_mesh((1,), ("pod",))

    def jstage(w_stage, x):
        for i in range(w_stage.shape[0]):
            x = jnp.tanh(x @ w_stage[i])
        return x

    def loss(w, x):
        o = jax_pipeline.pipeline_apply(jstage, w.reshape(1, L, D, D), x,
                                        mesh, axis="pod")
        return jnp.sum(o ** 2), o

    (_, want), (jdw, jdx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(jnp.asarray(ws), jnp.asarray(xs))
    got, dw, dx, _ = port(ws, xs, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), atol=1e-4, rtol=0)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), atol=1e-4, rtol=0)
    assert jax_pipeline.bubble_fraction(1, 6) == \
        pipeline.bubble_fraction(1, 6) == 0.0
