"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where no CUDA device is present (a CUDA
kernel has no CPU or interpret mode). On a machine with one,

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

builds the kernels and runs them. ``chip_smoke.py`` holds every kernel at
the main path's shapes; these tests add the shapes that take the kernels'
padding and fallback branches, which the main path never reaches.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.flash_attention import ref as flash_ref  # noqa: E402
from repro_torch.kernels.ssd import kernel as SK  # noqa: E402
from repro_torch.kernels.ssd import ref as ssd_ref  # noqa: E402

pytestmark = pytest.mark.cuda

FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # atol = rtol, as chip_smoke
SSD_TOL = 2e-4  # x max(1, max|ref|), for y and the state


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
