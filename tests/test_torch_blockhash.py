"""The port's blockhash against the reference package's.

On the CPU the port runs the plain PyTorch version of its CUDA kernel
(``repro_torch.kernels.blockhash.ref.blockhash``); it must agree exactly
with the reference's numpy oracle and with the reference's Pallas kernel
run in interpret mode, as ``tests/test_kernels.py`` runs it. The hash is
defined by u32 wraparound, so every comparison is ``==``. The CUDA kernel
itself is held against the plain version on the card by ``chip_smoke.py``.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.blockhash import ops as jax_ops  # noqa: E402
from repro.kernels.blockhash.ref import blockhash_np  # noqa: E402
from repro_torch.kernels.blockhash import kernel as K  # noqa: E402
from repro_torch.kernels.blockhash import ops, ref  # noqa: E402


def _inputs():
    rng = np.random.default_rng(11)
    cases = {"probe": b"probe"}
    for n in (16, 512, 4093, 4096):
        cases[f"rand{n}"] = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    cases["zeros"] = bytes(4096)
    cases["ones"] = b"\xff" * 4096
    return cases


CASES = _inputs()


@pytest.mark.parametrize("name", sorted(CASES))
def test_checksum_matches_reference(name):
    data = CASES[name]
    got = ops.checksum(data, device="cpu")
    assert got == blockhash_np(data)
    assert got == jax_ops.checksum(data, interpret=True)
    assert isinstance(got, int) and 0 <= got < 2**32


@pytest.mark.parametrize("n", [1, 5, 63])
def test_checksum_batch_equals_per_block(n):
    rng = np.random.default_rng(n)
    blocks = [rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
              for _ in range(n)]
    blocks[0] = b"\xff" * 4096
    got = ops.checksum_batch(blocks, device="cpu")
    assert got == [blockhash_np(b) for b in blocks]
    assert got == [ops.checksum(b, device="cpu") for b in blocks]
    assert all(isinstance(x, int) and 0 <= x < 2**32 for x in got)


def test_checksum_batch_matches_pallas_batch():
    rng = np.random.default_rng(3)
    blocks = [rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
              for _ in range(5)]
    assert (ops.checksum_batch(blocks, device="cpu")
            == jax_ops.checksum_batch(blocks, interpret=True))


def test_flipped_byte_changes_hash():
    data = bytearray(CASES["rand4096"])
    h = ops.checksum(bytes(data), device="cpu")
    data[100] ^= 0xFF
    assert ops.checksum(bytes(data), device="cpu") != h


def test_plain_version_wraps_like_u32():
    """The int32 views and the int32 result carry u32 bit patterns: about
    half the hashes are negative as int32 and still convert exactly."""
    rng = np.random.default_rng(5)
    w = rng.integers(0, 2**32, (64, 1024), dtype=np.uint64).astype(np.uint32)
    w[0] = 0xFFFFFFFF
    pows = ref.powers(1024)
    out = ref.blockhash(torch.from_numpy(w.view(np.int32).copy()),
                        torch.from_numpy(pows.view(np.int32).copy()))
    assert out.dtype == torch.int32 and out.shape == (64,)
    want = [int(np.sum(r.astype(np.uint64) * pows.astype(np.uint64))
                & 0xFFFFFFFF) for r in w]
    assert [x & 0xFFFFFFFF for x in out.tolist()] == want
    assert (out < 0).any()


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never gives way to the plain version: a CPU
    tensor is refused, and only ``ops`` picks the plain path, by the
    tensor's device."""
    words = torch.zeros((2, 4), dtype=torch.int32)
    pows = torch.from_numpy(ref.powers(4).view(np.int32).copy())
    with pytest.raises(ValueError):
        K.blockhash_batch(words, pows)
    assert ops.blockhash_batch(words, pows).tolist() == [0, 0]
