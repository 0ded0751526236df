"""The port's Mamba2 SSD chunked scan against the reference on the CPU.

The same seeded numpy inputs go through ``repro``'s plain jnp version, its
Pallas kernel in interpret mode, its model-level ``ssd_chunked`` (zero-pad
path) and the port's counterparts, within the reference's own tolerance
(atol 2e-4, ``tests/test_kernels.py``). The CUDA kernel itself is held
against the port's plain version on the card by ``chip_smoke.py``.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.ssd import kernel as jax_kernel  # noqa: E402
from repro.kernels.ssd import ref as jax_ref  # noqa: E402
from repro.models import mamba2 as jax_mamba2  # noqa: E402
from repro_torch.kernels.ssd import kernel as K  # noqa: E402
from repro_torch.kernels.ssd import ops, ref  # noqa: E402
from repro_torch.models import mamba2  # noqa: E402

ATOL = 2e-4
SHAPES = [  # (b, S, H, P, N, C), as tests/test_kernels.py sweeps the kernel
    (2, 128, 3, 16, 8, 32),
    (1, 256, 2, 64, 64, 128),
    (1, 64, 1, 8, 8, 64),  # a single chunk
]


def inputs(b, S, H, P, N, seed=0):
    """x, dt, B, C, A_log, D, state as float32 numpy arrays, drawn with the
    scales of tests/test_kernels.py (dt through a softplus, D random here
    so that its term is not the identity)."""
    rng = np.random.default_rng(seed)
    n = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    dt = np.logaddexp(0.0, n(b, S, H)).astype(np.float32)
    return (n(b, S, H, P), dt, n(b, S, N) * 0.5, n(b, S, N) * 0.5,
            n(H) * 0.3, 1.0 + 0.1 * n(H), n(b, H, P, N) * 0.1)


def port(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol, rtol=0)


@pytest.mark.parametrize("b,S,H,P,N,C", SHAPES)
def test_ops_matches_pallas_interpret_and_reference_ref(b, S, H, P, N, C):
    xs = inputs(b, S, H, P, N)
    y, st = ops.ssd(*port(*xs), chunk=C)  # CPU tensors: the plain version
    assert y.dtype == st.dtype == torch.float32
    assert y.shape == (b, S, H, P) and st.shape == (b, H, P, N)
    y_k, st_k = jax_kernel.ssd_chunked(*map(jnp.asarray, xs), chunk=C,
                                       interpret=True)
    close(y, y_k)
    close(st, st_k)
    y_r, st_r = jax_ref.ssd(*map(jnp.asarray, xs), chunk=C)
    close(y, y_r)
    close(st, st_r)


def test_bf16_inputs_match_reference():
    """bf16 x, B, C and parameters (the serve's dtypes; dt and the state
    stay f32) are widened exactly on both sides, so the tolerance stays
    the f32 one."""
    xs = inputs(2, 64, 2, 16, 8, seed=2)
    bf = lambda a: torch.from_numpy(a.copy()).to(torch.bfloat16)
    x, B, C, A_log, D = (bf(xs[i]) for i in (0, 2, 3, 4, 5))
    dt, state = port(xs[1], xs[6])
    y, st = ref.ssd(x, dt, B, C, A_log, D, state, chunk=16)
    jb = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
    y_r, st_r = jax_ref.ssd(jb(x), jnp.asarray(xs[1]), jb(B), jb(C), jb(A_log),
                            jb(D), jnp.asarray(xs[6]), chunk=16)
    close(y, y_r)
    close(st, st_r)


def test_chunked_equals_stepwise():
    """The port's ssd_step, token by token, equals its chunked scan (the
    counterpart of test_kernels.py's cross-oracle check)."""
    b, S, H, P, N = 1, 32, 2, 8, 4
    x, dt, B, C, A_log, D, _ = port(*inputs(b, S, H, P, N, seed=5))
    h = torch.zeros((b, H, P, N))
    y_chunk, h_chunk = ref.ssd(x, dt, B, C, A_log, D, h, chunk=8)
    ys, st = [], h
    for t in range(S):
        y, st = mamba2.ssd_step(x[:, t], dt[:, t], B[:, t], C[:, t], A_log, D,
                                st)
        ys.append(y)
    close(y_chunk, torch.stack(ys, dim=1))
    close(h_chunk, st)


@pytest.mark.parametrize("S,C", [(40, 16), (7, 32), (33, 32)])
def test_zero_pad_path_matches_reference(S, C):
    """S % chunk != 0: both packages zero-pad to a chunk multiple before the
    scan. A padded step has dt = 0, so y and the state are both exact."""
    xs = inputs(2, S, 2, 8, 8, seed=4)
    y, st = mamba2.ssd_chunked(*port(*xs), chunk=C)
    y_ref, st_ref = jax_mamba2.ssd_chunked(*map(jnp.asarray, xs), chunk=C)
    assert y.shape == (2, S, 2, 8)
    close(y, y_ref)
    close(st, st_ref)
    y_full, st_full = ref.ssd(*port(*xs), chunk=S)  # one chunk, no padding
    close(y, y_full)
    close(st, st_full)


def test_use_kernel_dispatch():
    xs = port(*inputs(1, 32, 1, 8, 8, seed=6))
    want = ref.ssd(*xs, chunk=16)
    for use_kernel in (None, False):
        got = ops.ssd(*xs, chunk=16, use_kernel=use_kernel)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="CUDA"):
        ops.ssd(*xs, chunk=16, use_kernel=True)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never gives way to the plain version: CPU
    tensors are refused before anything is built, and the count stays."""
    before = K.launches()
    with pytest.raises(ValueError, match="CUDA"):
        K.ssd_chunked(*port(*inputs(1, 32, 1, 8, 8)), chunk=16)
    assert K.launches() == before


def test_kernel_shared_memory_fits_the_serve_shape():
    """One block holds a chunk's x, B and C in their dtype, M and the state
    in f32: 130 KB at the serve's P=N=64, C=128 in bf16, 178 KB in f32,
    under the H100's 227 KB."""
    assert K.smem_bytes(64, 64, 128, 2) == 133248
    assert K.smem_bytes(64, 64, 128, 4) == 182400
    for _, _, _, p, n, c in SHAPES:
        assert K.smem_bytes(p, n, c, 4) <= K.SMEM_LIMIT
    assert K.smem_bytes(64, 64, 256, 2) > K.SMEM_LIMIT
