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
from repro_torch.kernels import _build  # noqa: E402
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


def test_bf16_tensor_core_layout_fits_two_blocks_an_sm():
    """bf16 with K and V multiples of 8 takes the tensor-core kernel: 107 KB
    of shared memory at the serve's shape, two blocks an H100 SM; float32,
    and bf16 rows that 16-byte copies cannot move, keep the CUDA-core
    kernel and its 62.5 KB."""
    assert K.uses_tensor_cores(64, 64, 32, 2)
    assert K.smem_bytes(64, 64, 32, 2) == K.tensor_core_smem_bytes(
        64, 64, 32) == 107056
    assert _build.blocks_per_sm(K.smem_bytes(64, 64, 32, 2)) == 2
    for k, v, c, esize in ((64, 64, 32, 4), (12, 20, 32, 2), (8, 4, 16, 2)):
        assert not K.uses_tensor_cores(k, v, c, esize)
        assert K.smem_bytes(k, v, c, esize) == K.smem_bytes(k, v, c)
    for _, _, _, k, v, c in SHAPES:  # the test sweep's widths: K = 8 .. 32
        assert K.uses_tensor_cores(k, v, c, 2)


def split_parts(t):
    """A float32 operand as the kernel feeds it to the tensor cores: its
    bf16 high part and the bf16 rounding of the remainder."""
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def one_rounding(t):
    """The alternative the kernel does not take: one bf16 rounding."""
    return t.to(torch.bfloat16).float(), torch.zeros_like(t)


def tensor_core_product(eq, a, b, parts):
    """A product of two float32 operands: hi hi + hi lo + lo hi (three
    mma)."""
    ah, al = parts(a)
    bh, bl = parts(b)
    return (torch.einsum(eq, ah, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, al, bh))


def tensor_core_product_exact_rhs(eq, a, b, parts):
    """A float32 operand times a bf16 input (v), which enters exactly:
    hi b + lo b (two mma)."""
    ah, al = parts(a)
    return torch.einsum(eq, ah, b) + torch.einsum(eq, al, b)


def wkv6_tensor_core_emulation(r, k, v, w, u, state, *, chunk,
                               parts=split_parts, tile=16, seg=8):
    """csrc/wkv6.cu's bf16 kernel in plain torch: the chunk zero-padded to
    mma tiles of 16 tokens (logw = 0 past its end) and cut into segments
    of 8; tmp within a segment per pair in float32, with the u bonus on
    its diagonal; t past s's segment as q k~^T, factored about j, the last
    token of s's segment, each exponent clipped at 0; y = tmp v + (r
    exp(Le)) S and S = exp(Li_last) S + kd^T v. Every float32 operand of
    a product (q, k~, tmp, r exp(Le), S, kd) goes through ``parts``; v
    enters exactly; every exponential but logw's is of x log2 e rounded to
    float32 first, as ex2.approx takes it."""
    B, S, H, K = r.shape
    f32 = torch.float32
    log2e = torch.tensor(1.4426950408889634, dtype=f32)
    ex = lambda x: torch.exp2(x * log2e)
    cp = -(-chunk // tile) * tile
    mask = torch.tril(torch.ones(seg, seg, dtype=torch.bool), -1)
    S_, uf, ys = state.to(f32), u.to(f32), []
    for c0 in range(0, S, chunk):
        pad = lambda t: torch.nn.functional.pad(
            t[:, c0:c0 + chunk].to(f32), (0, 0, 0, 0, 0, cp - chunk))
        rr, kk, vv, ww = map(pad, (r, k, v, w))
        logw = torch.where(torch.arange(cp)[None, :, None, None] < chunk,
                           -torch.exp(ww), 0.0)
        Li = torch.cumsum(logw, dim=1)
        Le = Li - logw
        tmp = torch.zeros(B, cp, cp, H)
        for ti in range(cp // seg):
            ts = slice(ti * seg, (ti + 1) * seg)
            A = ex(torch.clamp(Le[:, ts, None] - Li[:, None, ts], -60.0, 0.0))
            A = torch.where(mask[None, :, :, None, None], A, 0.0)
            diag = torch.einsum("bthk,btshk,bshk->btsh", rr[:, ts], A, kk[:, ts])
            bonus = torch.einsum("bthk,hk,bthk->bht", rr[:, ts], uf, kk[:, ts])
            tmp[:, ts, ts] = diag + torch.diag_embed(bonus).permute(0, 2, 3, 1)
            for si in range(ti):
                ss, j = slice(si * seg, (si + 1) * seg), (si + 1) * seg - 1
                # each exponent clipped at 0, as the reference clips its one
                q = rr[:, ts] * ex(torch.clamp(Le[:, ts] - Li[:, j:j + 1],
                                               max=0.0))
                kt = kk[:, ss] * ex(torch.clamp(Li[:, j:j + 1] - Li[:, ss],
                                                max=0.0))
                tmp[:, ts, ss] = tensor_core_product("bthk,bshk->btsh", q,
                                                     kt, parts)
        y = tensor_core_product_exact_rhs("btsh,bshv->bthv", tmp, vv, parts)
        y = y + tensor_core_product("bthk,bhkv->bthv", rr * ex(Le), S_, parts)
        kd = kk * ex(Li[:, -1:] - Li)
        S_ = ex(Li[:, -1])[..., None] * S_ + tensor_core_product_exact_rhs(
            "bshk,bshv->bhkv", kd, vv, parts)
        ys.append(y[:, :chunk])
    return torch.cat(ys, dim=1), S_


def decay_inputs(B, S, H, K, V, decay):
    """Inputs drawn as chip_smoke.phase_wkv6_kernel draws them (seed 2025),
    r, k, v, w rounded to bf16 (the serve's dtype): the smoke's w ~
    N(0, 0.3); strong decay, w ~ N(2, 1) (exp(-exp(w)) down to exp(-50) a
    token and below); weak decay, w ~ N(-4, 0.5)."""
    rng = np.random.default_rng(2025)
    n = lambda *shape: rng.standard_normal(shape, dtype=np.float32)
    r, k, v = n(B, S, H, K) * 0.5, n(B, S, H, K) * 0.5, n(B, S, H, V)
    w = {"smoke": lambda: n(B, S, H, K) * 0.3,
         "strong": lambda: 2.0 + n(B, S, H, K),
         "weak": lambda: -4.0 + 0.5 * n(B, S, H, K)}[decay]()
    ts = [torch.from_numpy(a) for a in (r, k, v, w, n(H, K) * 0.3,
                                         n(B, H, K, V) * 0.1)]
    return [t.to(torch.bfloat16) for t in ts[:4]] + ts[4:]


@pytest.mark.parametrize("decay", ["smoke", "strong", "weak"])
@pytest.mark.parametrize("parts,holds", [(split_parts, True),
                                         (one_rounding, False)])
def test_tensor_core_rounding_holds_the_tolerance(parts, holds, decay):
    """The bf16 kernel's factoring and operand rounding, emulated at the
    serve's widths (K = V = 64, chunk 32, four segments a chunk): with every
    float32 operand split into bf16 high + remainder, y and the state stay
    within 1e-5 x max(1, max|ref|) of the plain version, a tenth of the
    1e-4 chip_smoke.py holds the kernel to; one bf16 rounding of each
    misses 1e-4. The factored tiles stay finite under strong decay."""
    args = decay_inputs(2, 256, 4, 64, 64, decay)
    y_ref, st_ref = ref.wkv6(*args, chunk=32)
    y, st = wkv6_tensor_core_emulation(*args, chunk=32, parts=parts)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    errs = [((got - want).abs().max() / max(1.0, want.abs().max())).item()
            for got, want in ((y, y_ref), (st, st_ref))]
    if holds:
        assert max(errs) <= ATOL / 10, errs
    else:
        assert errs[0] > ATOL, errs


def test_emulation_pads_a_chunk_to_whole_tiles():
    """A chunk of 24 tokens (two tiles, the last segment padding) and K = 8
    (padded to 16 in the kernel, not here: padding adds only zeros)."""
    args = decay_inputs(1, 96, 2, 8, 16, "smoke")
    y_ref, st_ref = ref.wkv6(*args, chunk=24)
    y, st = wkv6_tensor_core_emulation(*args, chunk=24)
    assert y.shape == y_ref.shape and st.shape == st_ref.shape
    for got, want in ((y, y_ref), (st, st_ref)):
        err = (got - want).abs().max() / max(1.0, want.abs().max())
        assert err <= ATOL / 10, err.item()
