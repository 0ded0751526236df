"""The port's data pipeline against the reference's, on the CPU.

``SyntheticLM`` batches must be the reference's arrays exactly, token
shards written through ``write_shards`` must leave the same device image
on a bento mount, and ``FsShardReader`` / ``Prefetcher`` keep the
reference's order, wrap-around and straggler re-dispatch
(``tests/test_data_and_ckpt.py``). Batches stay numpy; a consumer takes
them to torch with ``torch.from_numpy``.
"""

from __future__ import annotations

import time
import types
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.fs.mounts as R_mounts  # noqa: E402
import repro_torch.fs.mounts as T_mounts  # noqa: E402
from repro.configs import registry as R_reg  # noqa: E402
from repro.data import pipeline as R_data  # noqa: E402
from repro_torch.configs import registry as T_reg  # noqa: E402
from repro_torch.data import pipeline as T_data  # noqa: E402
from test_torch_fs_slice import _image, _ref_binding  # noqa: E402


@pytest.mark.parametrize("arch,full,batch,seq", [
    ("smollm-135m", False, 4, 32), ("rwkv6-7b", True, 4, 1024),
    ("llama-3.2-vision-11b", False, 2, 16), ("whisper-small", False, 2, 16)])
def test_synthetic_batches_equal_reference(arch, full, batch, seq):
    pick = (lambda b: b.model) if full else (lambda b: b.smoke)
    r = R_data.SyntheticLM(pick(R_reg.get(arch)), batch, seq, seed=7)
    t = T_data.SyntheticLM(pick(T_reg.get(arch)), batch, seq, seed=7)
    for step in (0, 3, 1000):
        rb, tb = r.batch(step), t.batch(step)
        assert sorted(rb) == sorted(tb)
        for k in rb:
            assert tb[k].dtype == rb[k].dtype and np.array_equal(tb[k], rb[k])
        toks = torch.from_numpy(tb["tokens"])
        assert toks.shape == (batch, seq) and toks.dtype == torch.int32
    assert not np.array_equal(t.batch(0)["tokens"], t.batch(1)["tokens"])


@pytest.fixture
def pinned_zip_clock(monkeypatch):
    """``np.savez`` stamps each zip member with the wall clock; pin the
    clock zipfile reads so two writes give the same bytes."""
    monkeypatch.setattr(zipfile, "time", types.SimpleNamespace(
        time=lambda: 1.7e9, localtime=time.localtime))


def test_write_shards_leaves_the_reference_image(monkeypatch,
                                                 pinned_zip_clock):
    monkeypatch.setattr(R_mounts, "kernel_binding", _ref_binding)
    ref = R_mounts.make_mount("bento", n_blocks=8192)
    port = T_mounts.make_mount("bento", n_blocks=8192, device="cpu")
    R_data.write_shards(ref.view, R_data.SyntheticLM(
        R_reg.get("smollm-135m").smoke, 2, 64, seed=1), n_shards=3)
    ds = T_data.SyntheticLM(T_reg.get("smollm-135m").smoke, 2, 64, seed=1)
    T_data.write_shards(port.view, ds, n_shards=3)
    assert port.view.read_file("/data/shard_00001.npz") == \
        ref.view.read_file("/data/shard_00001.npz")
    rd = T_data.FsShardReader(port.view)
    assert rd.shards == sorted(ref.view.listdir("/data"))
    for i in (0, 1, 2, 5):  # 5 wraps around to shard 2
        got = rd.read(i)
        assert np.array_equal(got["tokens"], ds.batch(i % 3)["tokens"])
        assert np.array_equal(got["labels"], ds.batch(i % 3)["labels"])
    ref.close()
    port.close()
    assert np.array_equal(_image(port.dev), _image(ref.dev))


def test_straggler_is_redispatched():
    mf = T_mounts.make_mount("bento", n_blocks=8192, device="cpu")
    T_data.write_shards(mf.view, T_data.SyntheticLM(
        T_reg.get("smollm-135m").smoke, 2, 32), n_shards=2)
    rd = T_data.FsShardReader(mf.view, timeout_s=0.2)
    orig = rd.view.read_file
    calls = {"n": 0}

    def slow_once(path, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            time.sleep(0.6)  # first attempt straggles past the deadline
        return orig(path, **kw)

    rd.view.read_file = slow_once
    got = rd.read(0)
    assert rd.retries >= 1 and calls["n"] >= 2
    assert "tokens" in got
    mf.close()


def test_unreadable_shard_raises_after_retries():
    mf = T_mounts.make_mount("bento", n_blocks=8192, device="cpu")
    T_data.write_shards(mf.view, T_data.SyntheticLM(
        T_reg.get("smollm-135m").smoke, 2, 32), n_shards=1)
    rd = T_data.FsShardReader(mf.view, max_retries=2)

    def broken(path, **kw):
        raise OSError("device gone")

    rd.view.read_file = broken
    with pytest.raises(RuntimeError, match="unreadable after retries"):
        rd.read(0)
    assert rd.retries == 2
    mf.close()


def test_prefetcher_keeps_order_and_surfaces_errors():
    pf = T_data.Prefetcher(lambda s: {"step": s}, start_step=5)
    for want in (5, 6, 7):
        s, item = pf.next()
        assert s == want and item["step"] == want
    pf.close()

    def fetch(s):
        if s == 1:
            raise ValueError("bad step")
        return s

    pf = T_data.Prefetcher(fetch)
    assert pf.next() == (0, 0)
    with pytest.raises(ValueError, match="bad step"):
        pf.next()
    pf.close()


def test_prefetcher_close_waits_for_its_thread_and_times_out(monkeypatch):
    import threading

    from repro_torch.data import pipeline

    monkeypatch.setattr(pipeline, "CLOSE_TIMEOUT_S", 0.2)
    release = threading.Event()

    def fetch(s):
        if s == 1:
            release.wait()  # a fetch that hangs until released
        return s

    pf = T_data.Prefetcher(fetch)
    assert pf.next() == (0, 0)
    with pytest.raises(TimeoutError, match="still runs"):
        pf.close()
    release.set()
    pf.close()
    assert not pf._thread.is_alive()


def test_prefetcher_over_fs_shards_equals_the_batches():
    mf = T_mounts.make_mount("bento", n_blocks=8192, device="cpu")
    ds = T_data.SyntheticLM(T_reg.get("smollm-135m").smoke, 2, 32, seed=3)
    T_data.write_shards(mf.view, ds, n_shards=4)
    rd = T_data.FsShardReader(mf.view)
    pf = T_data.Prefetcher(rd.read, depth=2)
    for want in range(6):
        s, b = pf.next()
        assert s == want
        assert np.array_equal(b["tokens"], ds.batch(want % 4)["tokens"])
    pf.close()
    mf.close()
