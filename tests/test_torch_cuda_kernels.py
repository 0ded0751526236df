"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where no CUDA device is present (a CUDA
kernel has no CPU or interpret mode). On a machine with one,

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

builds the kernels and runs them. ``chip_smoke.py`` holds every kernel at
the main path's shapes; these tests add the shapes that take the kernels'
padding and fallback branches, which the main path never reaches, and
the blockhash call's shared buffers under concurrent callers and growth.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.blockhash import kernel as BK  # noqa: E402
from repro_torch.kernels.blockhash import ops as bh_ops  # noqa: E402
from repro_torch.kernels.blockhash.ref import blockhash_np  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.flash_attention import ref as flash_ref  # noqa: E402
from repro_torch.kernels.ssd import kernel as SK  # noqa: E402
from repro_torch.kernels.ssd import ref as ssd_ref  # noqa: E402
from repro_torch.kernels.wkv6 import kernel as WK  # noqa: E402
from repro_torch.kernels.wkv6 import ref as wkv6_ref  # noqa: E402

pytestmark = pytest.mark.cuda

FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # atol = rtol, as chip_smoke
SSD_TOL = 2e-4  # x max(1, max|ref|), for y and the state
WKV6_TOL = 1e-4  # x max(1, max|ref|), for y and the state


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [1, 36, 72])
def test_flash_kernel_holds_widths_that_need_padding(cuda, D, dtype):
    """D not a multiple of 16 (zero-padded in shared memory) or of 8 (rows
    copied element by element), with GQA, a window and tails no tile
    divides."""
    rng = np.random.default_rng(D)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               .to(cuda, getattr(torch, dtype))
               for s in ((2, 150, 4, D), (2, 200, 2, D), (2, 200, 2, D)))
    for kw in ({"causal": True}, {"causal": False, "window": 48}):
        got = FK.flash_attention_fwd(q, k, v, **kw).float()
        want = flash_ref.attention(q, k, v, **kw).float()
        tol = FLASH_TOL[dtype]
        assert ((got - want).abs() <= tol + tol * want.abs()).all(), kw


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,S,H,P,N,C", [
    (1, 48, 3, 12, 20, 24),  # P rows of 8-byte units, padded P, N, C
    (2, 64, 2, 4, 4, 8),     # the narrowest shape the wrapper takes
    (1, 16, 2, 2000, 4, 8),  # bf16 tiles too wide: the CUDA-core kernel
])
def test_ssd_kernel_holds_shapes_that_need_padding(cuda, b, S, H, P, N, C,
                                                  dtype):
    rng = np.random.default_rng(P)
    n = lambda *shape: rng.standard_normal(shape, dtype=np.float32)
    arrays = (n(b, S, H, P), np.logaddexp(0, n(b, S, H)).astype(np.float32),
              n(b, S, N) * 0.5, n(b, S, N) * 0.5, n(H) * 0.3,
              1 + 0.1 * n(H), n(b, H, P, N) * 0.1)
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    for i in (0, 2, 3):
        args[i] = args[i].to(getattr(torch, dtype))
    got = SK.ssd_chunked(*args, chunk=C)
    want = ssd_ref.ssd(*args, chunk=C)
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= SSD_TOL * max(1.0, w.abs().max())


@pytest.mark.parametrize("decay", ["smoke", "strong"])
@pytest.mark.parametrize("B,S,H,K,V,C,tensor_cores", [
    (2, 64, 3, 8, 8, 16, True),     # K, V padded to 16, one tile a chunk
    (1, 128, 2, 8, 24, 64, True),   # four tiles a chunk, V padded to 32
    (2, 96, 2, 16, 16, 24, True),   # a chunk padded to 32 tokens
    (1, 64, 2, 12, 20, 32, False),  # K, V not multiples of 8: CUDA cores
])
def test_wkv6_bf16_kernel_holds_shapes_that_need_padding(
        cuda, B, S, H, K, V, C, tensor_cores, decay):
    """The bf16 kernel against the plain version at widths and chunks the
    serve never uses, under the smoke's decay (w ~ N(0, 0.3)) and strong
    decay (w ~ N(2, 1), exp(-exp(w)) down to exp(-50) a token)."""
    assert WK.uses_tensor_cores(K, V, C, 2) == tensor_cores
    rng = np.random.default_rng(K * V + C)
    n = lambda *shape: rng.standard_normal(shape, dtype=np.float32)
    w = n(B, S, H, K) * 0.3 if decay == "smoke" else 2.0 + n(B, S, H, K)
    arrays = (n(B, S, H, K) * 0.5, n(B, S, H, K) * 0.5, n(B, S, H, V), w,
              n(H, K) * 0.3)
    r, k, v, w, u = (torch.from_numpy(a).to(cuda, torch.bfloat16)
                     for a in arrays)
    s0 = torch.from_numpy(n(B, H, K, V) * 0.1).to(cuda)
    got = WK.wkv6_chunked(r, k, v, w, u, s0, chunk=C)
    want = wkv6_ref.wkv6(r, k, v, w, u, s0, chunk=C)
    for g, x in zip(got, want):
        assert torch.isfinite(g).all()
        assert (g - x).abs().max() <= WKV6_TOL * max(1.0, x.abs().max())


def _blocks(rng, n, size=4096):
    return [rng.integers(0, 256, size, dtype=np.uint8).tobytes()
            for _ in range(n)]


def test_checksum_batch_from_8_threads_at_once(cuda):
    """The staging buffers are shared by the device's callers: 8 threads
    at once each get their own blocks' hashes, one launch a call."""
    import threading

    rng = np.random.default_rng(16)
    batches = [_blocks(rng, 1 + 9 * i) for i in range(8)]
    want = [[blockhash_np(b) for b in batch] for batch in batches]
    bh_ops.checksum_batch(batches[0], device=cuda)  # build outside the race
    got, rounds = [None] * 8, 10
    barrier = threading.Barrier(8)

    def run(i):
        barrier.wait()
        got[i] = [bh_ops.checksum_batch(batches[i], device=cuda)
                  for _ in range(rounds)]

    l0 = BK.launches()
    threads = [threading.Thread(target=run, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert got == [[w] * rounds for w in want]
    assert BK.launches() - l0 == 8 * rounds


def test_checksum_batch_staging_grows(cuda):
    """1, 63 and 4096 blocks of 4096 bytes (a probe, a commit, a buffer
    cache), then 63 again and a 4093-byte block: the buffers grow by
    doubling and keep serving smaller calls, every hash exact."""
    rng = np.random.default_rng(17)
    dev = torch.device("cuda", torch.cuda.current_device())
    st = bh_ops.staging(dev)
    for n, size in ((1, 4096), (63, 4096), (4096, 4096), (63, 4096),
                    (1, 4093)):
        blocks = _blocks(rng, n, size)
        l0 = BK.launches()
        got = bh_ops.checksum_batch(blocks, device=cuda)
        assert BK.launches() - l0 == 1
        assert got == [blockhash_np(b) for b in blocks]
        assert st.words_cap >= n * 1024 and st.blocks_cap >= n
    assert st.words_cap >= 4096 * 1024
