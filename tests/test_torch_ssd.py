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
from repro_torch.kernels import _build  # noqa: E402
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
    """bf16 (the tensor-core kernel): x of two heads, B and C in bf16 with
    rows padded by 16 bytes, the two states and four per-token vectors in
    f32: 112 KiB at the serve's P=N=64, C=128, so two blocks share an SM,
    as the design relies on. f32 (the CUDA-core kernel): a chunk's x, B, C
    and M, the state: 178 KB, one block. M is never stored in the bf16
    kernel, so a chunk of 256 fits there and not in f32."""
    assert K.smem_bytes(64, 64, 128, 2) == 114688
    assert K.smem_bytes(64, 64, 128, 4) == 182400
    assert _build.blocks_per_sm(K.smem_bytes(64, 64, 128, 2)) >= 2
    assert _build.blocks_per_sm(K.smem_bytes(64, 64, 128, 4)) == 1
    for _, _, _, p, n, c in SHAPES:
        for esize in (2, 4):
            assert K.smem_bytes(p, n, c, esize) <= K.SMEM_LIMIT
    assert K.smem_bytes(64, 64, 256, 2) <= K.SMEM_LIMIT
    assert K.smem_bytes(64, 64, 256, 4) > K.SMEM_LIMIT


def test_bf16_shapes_too_wide_for_the_tensor_core_tiles_still_fit():
    """Padding P and N to 16 can outgrow a block where today's CUDA-core
    layout fits (a wide P over N = 4); such bf16 shapes take the CUDA-core
    kernel, so no shape that fits it is refused."""
    assert K.tensor_core_smem_bytes(2000, 4, 8) > K.SMEM_LIMIT
    assert K.smem_bytes(2000, 4, 8, 2) == 2 * (8 * 2000 + 2 * 8 * 4) + 4 * (
        64 + 4 * 2000 + 4 * 8 + 32)
    assert K.smem_bytes(2000, 4, 8, 2) <= K.SMEM_LIMIT


def split_round(t):
    """What a float32 operand keeps through the kernel's two products: its
    bf16 high part plus the bf16 rounding of the remainder."""
    hi = t.to(torch.bfloat16).float()
    return hi + (t - hi).to(torch.bfloat16).float()


def bf16_round(t):
    return t.to(torch.bfloat16).float()


def ssd_tensor_core_emulation(x, dt, B, C, A_log, D, state, *, chunk,
                              round_m=split_round):
    """csrc/ssd.cu's bf16 kernel in plain torch: the products of bf16
    inputs (C.B^T, and the B and x sides) exact into float32; M, the
    carried state and the weighted x each rounded as the kernel feeds
    them to the tensor cores (``round_m`` for M, the hi/lo split for the
    other two); float32 everywhere else."""
    b, S, H, P = x.shape
    f32 = torch.float32
    A = -torch.exp(A_log.to(f32))
    h = state.to(f32)
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    ys = []
    for c0 in range(0, S, chunk):
        xx, dd, BB, CC = (t[:, c0:c0 + chunk].to(f32) for t in (x, dt, B, C))
        Li = torch.cumsum(dd * A, dim=1)  # (b, t, H)
        cb = torch.einsum("btn,bsn->bts", CC, BB)
        G = torch.exp(torch.clamp(Li[:, :, None] - Li[:, None], -60.0, 0.0))
        M = torch.where(mask[None, :, :, None],
                        cb[..., None] * G * dd[:, None], 0.0)
        y = torch.einsum("btsh,bshp->bthp", round_m(M), xx)
        ch = torch.einsum("btn,bhpn->bthp", CC, split_round(h))
        y = y + torch.exp(Li)[..., None] * ch + D.to(f32)[:, None] * xx
        wx = (torch.exp(Li[:, -1:] - Li) * dd)[..., None] * xx
        h = torch.exp(Li[:, -1])[..., None, None] * h + torch.einsum(
            "bthp,btn->bhpn", split_round(wx), BB)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def smoke_ssd_inputs(b, S, H, P, N):
    """Inputs drawn as chip_smoke.phase_ssd_kernel draws them, x, B and C
    rounded to bf16 (the serve's dtype)."""
    rng = np.random.default_rng(2026)
    n = lambda *shape: rng.standard_normal(shape, dtype=np.float32)
    arrays = (n(b, S, H, P), np.logaddexp(0, n(b, S, H)).astype(np.float32),
              n(b, S, N) * 0.5, n(b, S, N) * 0.5, n(H) * 0.3,
              1 + 0.1 * n(H), n(b, H, P, N) * 0.1)
    ts = [torch.from_numpy(a) for a in arrays]
    for i in (0, 2, 3):
        ts[i] = ts[i].to(torch.bfloat16)
    return ts


@pytest.mark.parametrize("round_m,holds", [(split_round, True),
                                           (bf16_round, False)])
def test_tensor_core_rounding_holds_the_tolerance(round_m, holds):
    """The bf16 kernel's operand rounding, emulated at the smoke's largest
    shape: with M, the state and the weighted x each split into bf16 high
    + remainder, y and the state stay within 2e-4 x max(1, max|ref|) of
    the plain version, the tolerance chip_smoke.py holds the kernel to;
    one bf16 rounding of M alone does not."""
    args = smoke_ssd_inputs(2, 1024, 8, 64, 64)
    y_ref, st_ref = ref.ssd(*args, chunk=128)
    y, st = ssd_tensor_core_emulation(*args, chunk=128, round_m=round_m)
    errs = [((got - want).abs().max() / max(1.0, want.abs().max())).item()
            for got, want in ((y, y_ref), (st, st_ref))]
    if holds:
        assert max(errs) <= ATOL / 10, errs  # 4e-6 of 2e-4
    else:
        assert errs[0] > ATOL, errs
