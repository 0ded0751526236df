"""The port's WKV6 chunked scan against the reference on the CPU.

The same seeded numpy inputs go through ``repro``'s plain jnp version, its
Pallas kernel in interpret mode, its model-level ``wkv6_chunked`` (zero-pad
path) and the port's counterparts, within the reference's own tolerance
(atol 1e-4, ``tests/test_kernels.py``). The CUDA kernel itself is held
against the port's plain version on the card by ``chip_smoke.py``.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.wkv6 import kernel as jax_kernel  # noqa: E402
from repro.kernels.wkv6 import ref as jax_ref  # noqa: E402
from repro.models import rwkv as jax_rwkv  # noqa: E402
from repro_torch.kernels.wkv6 import kernel as K  # noqa: E402
from repro_torch.kernels.wkv6 import ops, ref  # noqa: E402
from repro_torch.models import rwkv  # noqa: E402

ATOL = 1e-4
SHAPES = [  # (B, S, H, K, V, C), as tests/test_kernels.py sweeps the kernel
    (2, 64, 3, 16, 16, 16),
    (1, 128, 2, 32, 32, 32),
    (1, 64, 1, 8, 8, 64),  # a single chunk
]


def inputs(B, S, H, K, V, seed=0):
    """r, k, v, w, u, state as float32 numpy arrays, drawn with the scales
    of tests/test_kernels.py."""
    rng = np.random.default_rng(seed)
    n = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return (n(B, S, H, K) * 0.5, n(B, S, H, K) * 0.5, n(B, S, H, V),
            n(B, S, H, K) * 0.3, n(H, K) * 0.3, n(B, H, K, V) * 0.1)


def port(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol, rtol=0)


@pytest.mark.parametrize("B,S,H,K,V,C", SHAPES)
def test_plain_version_matches_reference_ref(B, S, H, K, V, C):
    xs = inputs(B, S, H, K, V)
    y, st = ref.wkv6(*port(*xs), chunk=C)
    y_ref, st_ref = jax_ref.wkv6(*map(jnp.asarray, xs), chunk=C)
    assert y.dtype == st.dtype == torch.float32
    assert y.shape == (B, S, H, V) and st.shape == (B, H, K, V)
    close(y, y_ref)
    close(st, st_ref)


@pytest.mark.parametrize("B,S,H,K,V,C", SHAPES)
def test_plain_version_matches_pallas_interpret(B, S, H, K, V, C):
    xs = inputs(B, S, H, K, V, seed=1)
    y, st = ops.wkv6(*port(*xs), chunk=C)  # CPU tensors: the plain version
    y_k, st_k = jax_kernel.wkv6_chunked(*map(jnp.asarray, xs), chunk=C,
                                        interpret=True)
    close(y, y_k)
    close(st, st_k)


def test_bf16_inputs_match_reference():
    """bf16 r/k/v/w/u (the serve's dtypes) are widened exactly to f32 on
    both sides, so the tolerance stays the f32 one."""
    xs = inputs(2, 64, 2, 16, 16, seed=2)
    bf = [torch.from_numpy(a.copy()).to(torch.bfloat16) for a in xs[:5]]
    state = torch.from_numpy(xs[5].copy())
    y, st = ref.wkv6(*bf, state, chunk=16)
    as_np = [t.float().numpy() for t in bf]
    y_ref, st_ref = jax_ref.wkv6(*(jnp.asarray(a, jnp.bfloat16) for a in as_np),
                                 jnp.asarray(xs[5]), chunk=16)
    close(y, y_ref)
    close(st, st_ref)


def test_stepwise_recurrence_matches_chunked():
    """The port's wkv6_step, token by token, equals its chunked scan (the
    counterpart of test_kernels.py's cross-oracle check)."""
    B, S, H, K = 1, 32, 2, 8
    r, k, v, w, u, _ = port(*inputs(B, S, H, K, K, seed=3))
    s = torch.zeros((B, H, K, K))
    y_chunk, s_chunk = ref.wkv6(r, k, v, w, u, s, chunk=8)
    ys, st = [], s
    for t in range(S):
        y, st = rwkv.wkv6_step(r[:, t], k[:, t], v[:, t], w[:, t], u, st)
        ys.append(y)
    close(y_chunk, torch.stack(ys, dim=1))
    close(s_chunk, st)


@pytest.mark.parametrize("S,C", [(40, 16), (7, 32), (33, 32)])
def test_zero_pad_path_matches_reference(S, C):
    """S % chunk != 0: both packages zero-pad to a chunk multiple. y is
    exact; the state has decayed over the padding in both, so it agrees
    too (prefill callers keep S a multiple of the chunk)."""
    xs = inputs(2, S, 2, 8, 8, seed=4)
    y, st = rwkv.wkv6_chunked(*port(*xs), chunk=C)
    y_ref, st_ref = jax_rwkv.wkv6_chunked(*map(jnp.asarray, xs), chunk=C)
    assert y.shape == (2, S, 2, 8)
    close(y, y_ref)
    close(st, st_ref)


def test_use_kernel_dispatch():
    xs = port(*inputs(1, 32, 1, 8, 8, seed=5))
    want = ref.wkv6(*xs, chunk=16)
    for use_kernel in (None, False):
        got = ops.wkv6(*xs, chunk=16, use_kernel=use_kernel)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="CUDA"):
        ops.wkv6(*xs, chunk=16, use_kernel=True)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never gives way to the plain version: CPU
    tensors are refused before anything is built, and the count stays."""
    before = K.launches()
    with pytest.raises(ValueError, match="CUDA"):
        K.wkv6_chunked(*port(*inputs(1, 32, 1, 8, 8)), chunk=16)
    assert K.launches() == before


def test_kernel_shared_memory_fits_the_serve_shape():
    """One block holds a chunk and the state: 62.5 KB at the serve's
    C=32, K=V=64, under the H100's 227 KB, and the test shapes fit too."""
    assert K.smem_bytes(64, 64, 32) == 62464
    for _, _, _, k, v, c in SHAPES:
        assert K.smem_bytes(k, v, c) <= K.SMEM_LIMIT
    assert K.smem_bytes(128, 128, 128) > K.SMEM_LIMIT
