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


@pytest.mark.parametrize("nblocks", [1, 63])
@pytest.mark.parametrize("size", [4096, 4093, 5])
def test_joined_words_match_padded_words_and_reference(size, nblocks):
    """The words of one commit's blocks from one join of the padded
    blocks equal the reference's way (pad each block, then ``np.stack``),
    and the hashes equal the reference package's batch."""
    rng = np.random.default_rng(size + nblocks)
    blocks = [rng.integers(0, 256, size, dtype=np.uint8).tobytes()
              for _ in range(nblocks)]
    words = ops._words(blocks)
    padded = np.stack([np.frombuffer(b + b"\0" * (-len(b) % 4), np.uint32)
                       for b in blocks])
    assert words.dtype == padded.dtype == np.uint32
    assert words.shape == (nblocks, -(-size // 4))
    assert np.array_equal(words, padded)
    got = ops.checksum_batch(blocks, device="cpu")
    assert got == jax_ops.checksum_batch(blocks, interpret=True)
    assert got == [blockhash_np(b) for b in blocks]


def test_mixed_lengths_still_raise():
    """Blocks of different word counts have no (n, wpb) array and raise,
    as np.stack does, and so does an empty batch; lengths that pad to one
    word count hash as before."""
    with pytest.raises(ValueError):
        ops.checksum_batch([b"a" * 4096, b"b" * 512], device="cpu")
    with pytest.raises(ValueError):
        ops.checksum_batch([b"a" * 8, b"b" * 4], device="cpu")
    with pytest.raises(ValueError):
        ops.checksum_batch([], device="cpu")
    blocks = [b"c" * 4093, b"d" * 4096]
    assert ops.checksum_batch(blocks, device="cpu") == [
        blockhash_np(b) for b in blocks]


def test_concurrent_callers_get_their_own_hashes():
    """8 threads calling checksum_batch at once, each with its own blocks,
    each get exactly the hashes of their blocks. On the CPU the call keeps
    no state between calls; the CUDA path's shared staging buffers and
    their lock are held to the same check by the card-only
    ``test_checksum_batch_from_8_threads_at_once``."""
    import threading

    rng = np.random.default_rng(8)
    batches = [[rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
                for _ in range(1 + 9 * i)] for i in range(8)]
    want = [[blockhash_np(b) for b in batch] for batch in batches]
    got = [None] * 8
    barrier = threading.Barrier(8)

    def run(i):
        barrier.wait()
        got[i] = [ops.checksum_batch(batches[i], device="cpu")
                  for _ in range(5)]

    threads = [threading.Thread(target=run, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert got == [[w] * 5 for w in want]


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 1023, 1024, 1025, 70001])
def test_powers_by_doubling_equal_the_word_by_word_loop(n):
    """``ref.powers`` builds its table by doubling; it must equal the
    word-by-word recurrence P^(n-1-i) mod 2^32 it replaced."""
    want = np.empty(n, dtype=np.uint32)
    acc = 1
    for i in range(n - 1, -1, -1):
        want[i] = acc
        acc = (acc * int(ref.PRIME)) & 0xFFFFFFFF
    got = ref.powers(n)
    assert got.dtype == np.uint32 and np.array_equal(got, want)
