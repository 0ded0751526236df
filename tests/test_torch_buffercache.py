"""The port's ``BufferCache.bread_many`` against the reference's.

The reference's ``bread_many`` lists a request's misses, then inserts
them one by one; an insert into a full cache may evict a block of the
same request that was a hit when the misses were listed, and that block
then has no bytes to serve: the read fails with ``EIO``. The port pins
the request's hits before it inserts, so an insert evicts only blocks
outside the request. Eviction never writes back, so wherever the
reference completes, both give the same bytes, the same cache contents
and the same device writes; where it fails, the port returns the bytes.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.fs.blockdev as R_dev  # noqa: E402
import repro.fs.buffercache as R_bc  # noqa: E402
import repro.fs.mounts as R_mounts  # noqa: E402
import repro_torch.fs.blockdev as T_dev  # noqa: E402
import repro_torch.fs.buffercache as T_bc  # noqa: E402
import repro_torch.fs.mounts as T_mounts  # noqa: E402
from repro import checkpoint as R_ck  # noqa: E402
from repro.core.interface import FsError as R_FsError  # noqa: E402
from repro_torch import checkpoint as T_ck  # noqa: E402
from repro_torch.distributed.resharding import ShardGrid  # noqa: E402
from test_torch_fs_slice import _image, _ref_binding  # noqa: E402


@pytest.fixture
def bound(monkeypatch):
    monkeypatch.setattr(R_mounts, "kernel_binding", _ref_binding)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


def test_sharded_leaf_beyond_the_cache_restores_in_port_not_reference():
    """One bf16 leaf of 16 MiB (2048 x 4096) saved in 2 shards on a bento
    mount with the default 4096-block (16 MiB) cache, then restored on
    the same mount: the reference's restore raises EIO from
    ``bread_many`` (the save left the cache full of the leaf's blocks),
    the port's returns every bit."""
    import ml_dtypes

    rng = np.random.default_rng(0)
    u16 = rng.integers(0, 1 << 16, size=(2048, 4096), dtype=np.uint16)
    ref = R_mounts.make_mount("bento")
    ref_tree = {"w": u16.view(ml_dtypes.bfloat16)}
    R_ck.save(ref.view, "/ck/s1", ref_tree, step=1, shardings={
        "w": R_ck.store.ShardGrid.from_spec(u16.shape, ("d",), {"d": 2})})
    with pytest.raises(R_FsError, match="EIO"):
        R_ck.load(ref.view, "/ck/s1", ref_tree)

    leaf = torch.from_numpy(u16.view(np.int16)).view(torch.bfloat16)
    mf = T_mounts.make_mount("bento", device="cpu")
    assert mf.services._cache.capacity == 4096
    T_ck.save(mf.view, "/ck/s1", {"w": leaf}, step=1, shardings={
        "w": ShardGrid.from_spec(u16.shape, ("d",), {"d": 2})})
    back, _ = T_ck.load(mf.view, "/ck/s1", {"w": leaf}, device="cpu")
    assert np.array_equal(_bits(back["w"]), u16.view(np.int16))
    mf.close()


def test_dedup_file_beyond_the_cache_reads_in_port_not_reference():
    """ROADMAP Queue 3's case: a 5000-block file on ``dedup-bento``,
    written in two flushed batches, then read in one call. The reference
    raises EIO, the port returns the bytes."""
    n, half = 5000, 2500
    blocks = [(b"%08d" % i) * 512 for i in range(n)]
    ref = R_mounts.make_mount("dedup-bento", n_blocks=16384)
    port = T_mounts.make_mount("dedup-bento", n_blocks=16384, device="cpu")
    for mf in (ref, port):
        for b0 in (0, half):
            mf.view.write_many([("/big", (b0 + i) * 4096, blocks[b0 + i])
                                for i in range(half)], create=True, fsync=True)
    with pytest.raises(R_FsError, match="EIO"):
        ref.view.read_many([("/big", 0, n * 4096)])
    assert port.view.read_many([("/big", 0, n * 4096)])[0] == b"".join(blocks)


def test_checkpoint_within_the_cache_gives_identical_bytes_and_images(bound):
    """A 4 MiB leaf in 2 shards fits the cache: both packages save it to
    identical device images and restore the same bytes."""
    import ml_dtypes

    rng = np.random.default_rng(2)
    u16 = rng.integers(0, 1 << 16, size=(512, 4096), dtype=np.uint16)
    ref = R_mounts.make_mount("bento", n_blocks=8192)
    port = T_mounts.make_mount("bento", n_blocks=8192, device="cpu")
    R_ck.save(ref.view, "/ck/s1", {"w": u16.view(ml_dtypes.bfloat16)},
              step=1, shardings={"w": R_ck.store.ShardGrid.from_spec(
                  u16.shape, ("d",), {"d": 2})})
    leaf = torch.from_numpy(u16.view(np.int16)).view(torch.bfloat16)
    T_ck.save(port.view, "/ck/s1", {"w": leaf}, step=1,
              shardings={"w": ShardGrid.from_spec(u16.shape, ("d",),
                                                  {"d": 2})})
    got_r, _ = R_ck.load(ref.view, "/ck/s1",
                         {"w": u16.view(ml_dtypes.bfloat16)})
    got_t, _ = T_ck.load(port.view, "/ck/s1", {"w": leaf}, device="cpu")
    assert np.array_equal(np.asarray(got_r["w"]).view(np.uint16), u16)
    assert np.array_equal(_bits(got_t["w"]), u16.view(np.int16))
    ref.close()
    port.close()
    assert np.array_equal(_image(port.dev), _image(ref.dev))


def _run(bc_mod, dev_mod, seed: int, capacity: int, n_calls: int,
         big: float, hold: int):
    """A seeded stream of ``bread_many`` calls (overlapping, repeated and
    dirtied blocks, up to ``hold`` heads a call held across calls, a
    share ``big`` of requests up to twice the cache) on a
    ``capacity``-block cache. Returns per call the bytes served and the cache's state after
    it, stopping at the first call that raises."""
    rng = np.random.default_rng(seed)
    dev = dev_mod.MemBlockDevice(64, 64)
    for b in range(64):
        dev.write_block(b, bytes([b]) * 64)
    cache = bc_mod.BufferCache(dev, capacity=capacity, writeback="delayed")
    truth = {b: bytes([b]) * 64 for b in range(64)}
    held, out = [], []
    for i in range(n_calls):
        n = int(rng.integers(1, 2 * capacity if rng.random() < big
                             else capacity // 2))
        req = [int(b) for b in rng.integers(0, 64, n)]
        try:
            heads = cache.bread_many(req)
        except KeyError:
            out.append("raised")
            break
        if any(cache._blocks.get(h.blockno) is not h._buf for h in heads):
            # a miss evicted by its own insert: its head's buffer is no
            # longer the cache's, so a later read loses its writes
            out.append("lost")
            break
        served = [bytes(h.data()) for h in heads]
        assert served == [truth[b] for b in req]
        if rng.random() < 0.3:
            h = heads[0]
            h.data()[:4] = bytes([i % 256]) * 4
            h.mark_dirty()
            truth[h.blockno] = bytes(h.data())
        keep = int(rng.integers(0, hold + 1))
        held.extend(heads[:keep])
        cache.brelse_many(heads[keep:])
        if len(held) > capacity // 2:
            cache.brelse_many(held)
            held = []
        if i % 4 == 3:
            cache.flush()  # writeback: dirty blocks become evictable
        out.append((served, list(cache._blocks), dict(cache._refs),
                    dict(cache._dirty), cache.hits, cache.misses))
    cache.brelse_many(held)
    cache.flush()
    return out, _image(dev).copy()


@pytest.mark.parametrize("capacity,hold", [(80, 2), (16, 0), (16, 2)])
@pytest.mark.parametrize("seed", range(3))
def test_bread_many_matches_reference_wherever_it_completes(seed, capacity,
                                                            hold):
    """Call for call, the same bytes, LRU order, refs, dirty set and
    hit/miss counts as the reference until the reference fails (it
    raises, or a miss it inserts evicts itself when every other block is
    pinned or dirty); the port serves the right bytes all the way. An
    80-block cache holds the 64-block device, so there the reference
    completes and the device images must match too."""
    ref, ref_image = _run(R_bc, R_dev, seed, capacity, 60, 0.1, hold)
    port, image = _run(T_bc, T_dev, seed, capacity, 60, 0.1, hold)
    done = ref[:-1] if ref[-1] in ("raised", "lost") else ref
    assert port[:len(done)] == done
    assert "raised" not in port and "lost" not in port and len(port) == 60
    if capacity >= 64:
        assert len(done) == 60
        assert np.array_equal(image, ref_image)


class _CountingRefs(dict):
    """A refcount table that counts its ``get`` calls (the pin checks of
    ``BufferCache._insert``)."""

    def __init__(self, refs):
        super().__init__(refs)
        self.gets = 0

    def __missing__(self, key):
        return 0

    def get(self, *args):
        self.gets += 1
        return super().get(*args)


@pytest.mark.parametrize("capacity,blocks,held",
                         [(64, 512, 0), (16, 400, 0), (256, 512, 200)])
def test_read_past_the_cache_checks_pins_linearly(capacity, blocks, held):
    """One ``bread_many`` of fresh blocks, ``blocks / capacity`` times
    the cache, into a full cache whose ``held`` least recent blocks are
    still pinned. The reference's ``_insert`` loop rescans the cache for
    an evictable block after each pinned one it skips, and finds none at
    every insert once the read's own pinned blocks fill the cache: pin
    checks quadratic in the read (a 113 MB shard file, 27,648 blocks, did
    not restore in minutes). The port's insert scans once per insert, and
    not at all once ``bread_many`` knows nothing is evictable: its checks
    stay linear, with the same bytes, LRU order, refs and counts as the
    same cache on the reference's loop. The reference serves the same
    bytes."""
    def run(bc_mod, dev_mod, insert_of=None):
        dev = dev_mod.MemBlockDevice(blocks + capacity, 64)
        for b in range(blocks + capacity):
            dev.write_block(b, (b % 251).to_bytes(1, "little") * 64)
        cache = bc_mod.BufferCache(dev, capacity=capacity)
        warm = cache.bread_many(list(range(blocks, blocks + capacity)))
        cache.brelse_many(warm[held:])  # the first `held` stay pinned
        if insert_of is not None:  # that package's loop on this cache
            cache._insert = (lambda blockno, buf, full=False:
                             insert_of._insert(cache, blockno, buf))
        cache._refs = refs = _CountingRefs(cache._refs)
        heads = cache.bread_many(list(range(blocks)))
        out = ([bytes(h.data()) for h in heads], list(cache._blocks),
               dict(refs), cache.hits, cache.misses, refs.gets)
        cache.brelse_many(heads + warm[:held])
        cache.assert_no_leaks()
        return out

    want = [(b % 251).to_bytes(1, "little") * 64 for b in range(blocks)]
    assert run(R_bc, R_dev)[0] == want
    *looped, loop_gets = run(T_bc, T_dev, insert_of=R_bc.BufferCache)
    *port, gets = run(T_bc, T_dev)
    assert port == looped and port[0] == want
    assert len(port[1]) == blocks + held  # grown past capacity, all pinned
    assert loop_gets > blocks * (blocks - capacity) // 2
    assert gets <= 4 * (blocks + capacity)
