#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Builds the CUDA kernels from ``src/repro_torch/csrc`` (``nvcc``, sm_90a,
into ``build/repro_torch/``), holds every kernel against its plain
PyTorch version on the card, then drives the Bento request path
(``make_mount`` -> ``Mount.submit`` / ``PosixView`` -> xv6 -> journal ->
``KernelServices.checksum_batch`` -> the CUDA blockhash kernel) and checks
each result against the same stream run with ``device="cpu"``, which the
CPU tests hold byte-identical to the JAX reference package. Every phase
asserts and prints one JSON line; the last line is the device record. It
imports nothing of JAX and exits non-zero, printing no result, when no
CUDA device is present or when run outside a checkout.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM, NVIDIA's data sheet: device-memory rate, and the float32 rate
# outside the tensor cores (the table's nearest entry for the kernel's
# integer multiply-adds).
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12

# (nblocks, wpb): the probe, a 16-byte input, a 4093-byte block padded to
# whole words, one full journal commit (nlog=64 holds 63 blocks), one
# buffer cache (4096 blocks, 16 MiB) and the 128 MiB image of the
# fs_macro fileserver mount.
KERNEL_SHAPES = ((1, 2), (1, 4), (1, 1024), (63, 1024), (4096, 1024),
                 (32768, 1024))
HEADLINE_SHAPE = (63, 1024)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _event_ms(run, count: int, reps: int) -> float:
    """Median over ``reps`` of the CUDA-event time of ``run()`` / ``count``."""
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / count)
    return statistics.median(times)


def device_ms(fn, *, count: int = 20, reps: int = 20) -> float:
    """Device time of one ``fn()``: ``count`` calls captured in a CUDA
    graph and replayed, so the host's launch cost is not in the time;
    median of ``reps`` replays after warm-up."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(count):
            fn()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    return _event_ms(graph.replay, count, reps)


def call_ms(fn, *, count: int = 20, reps: int = 20) -> float:
    """Time of one eager ``fn()`` as a caller sees it, host launch cost and
    any copies included: events around ``count`` calls in a row."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(count):
            fn()
    return _event_ms(run, count, reps)


# --- workloads (the shapes of benchmarks/fs_macro.py) ---------------------------------


def fileserver(v, loops: int, root: str = "/srv") -> int:
    """fs_macro.fileserver: 50 files of 64 KiB, write/append/read/stat,
    an unlink every 5th loop and an fsync every 16th."""
    v.makedirs(root)
    blob = b"f" * 65536
    rng = np.random.default_rng(11)
    ops = 0
    for i in range(loops):
        name = f"{root}/file{int(rng.integers(50)):04d}"
        v.write_file(name, blob)
        v.append(name, b"tail" * 256)
        data = v.read_file(name)  # write_file does not truncate
        assert data[:65536] == blob and data.endswith(b"tail" * 256)
        v.stat(name)
        if i % 5 == 4:
            v.unlink(name)
        ops += 5
        if i % 16 == 15:
            v.fsync(name if v.exists(name) else root)
            ops += 1
    return ops


def varmail(v, loops: int, root: str = "/mail") -> int:
    """fs_macro.varmail: the fsync-heavy mail-server loop."""
    v.makedirs(root)
    v.create(f"{root}/op.log")
    msg = b"m" * 8192
    ops = 0
    for i in range(loops):
        name = f"{root}/msg{i % 64:04d}"
        v.write_file(name, msg)
        v.append(f"{root}/op.log", b"delivered %d\n" % i)
        v.fsync(f"{root}/op.log")
        assert v.read_file(name) == msg
        if i % 4 == 3:
            v.unlink(name)
        ops += 4
    return ops


def submit_batches(mf, n_batches: int, *, launches=None):
    """``n_batches`` submissions of 128 writes of 512 bytes over a 64 KiB
    file plus a trailing fsync: each commits as ONE journal transaction,
    so it must cost one checksum_batch call (one kernel launch on CUDA).
    Returns (ops, per-batch checksum_batch calls, per-batch launches)."""
    from repro_torch.core.interface import SubmissionEntry

    v, ks = mf.view, mf.services
    ino = v.create("/batch.dat").ino
    calls, launched = [], []
    for b in range(n_batches):
        entries = [SubmissionEntry(
            "write", (ino, (i * 512) % 65536, bytes([(b + i) % 251]) * 512),
            user_data=i) for i in range(128)]
        entries.append(SubmissionEntry("fsync", (ino,), user_data="fsync"))
        c0 = ks.counters["checksum_batch_calls"]
        l0 = launches() if launches else 0
        comps = mf.mount.submit(entries)
        assert all(c.ok for c in comps), [c.errno for c in comps if not c.ok]
        calls.append(ks.counters["checksum_batch_calls"] - c0)
        launched.append((launches() - l0) if launches else None)
    return n_batches * 129, calls, launched


def image(dev) -> np.ndarray:
    data = dev._data
    return data if isinstance(data, np.ndarray) else data.cpu().numpy()


def checksum_calls(ks) -> int:
    return ks.counters["checksum_batch_calls"] + ks.counters["checksum_calls"]


def time_checksums(ks) -> dict:
    """Accumulate the host time spent in ``ks``'s checksum functions (each
    call returns Python ints, so it has waited for the device) into the
    returned dict's ``"s"``."""
    spent = {"s": 0.0}

    def timed(fn):
        def run(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent["s"] += time.perf_counter() - t0
        return run

    ks._checksum = timed(ks._checksum)
    ks._checksum_batch = timed(ks._checksum_batch)
    return spent


# --- phases ------------------------------------------------------------------------------


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    assert smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}"
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda)
    return card


def phase_kernel():
    """Build, then hold the CUDA blockhash against the plain version on
    the card and against the numpy oracle, exactly, at every shape."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.blockhash import kernel as K
    from repro_torch.kernels.blockhash import ref

    t0 = time.perf_counter()
    _build.build("blockhash")
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.build_log("blockhash").splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", sources=["blockhash"], seconds=build_s, ptxas=ptxas)

    rng = np.random.default_rng(2024)
    dev = torch.device("cuda")
    rows = []
    for n, wpb in KERNEL_SHAPES:
        if (n, wpb) == (1, 2):
            raw = np.frombuffer(b"probe" + b"\0" * 3, dtype=np.uint32)
            w = raw.reshape(1, 2).copy()
        elif (n, wpb) == (1, 1024):
            data = rng.integers(0, 256, 4093, dtype=np.uint8).tobytes()
            w = np.frombuffer(data + b"\0" * 3, dtype=np.uint32)
            w = w.reshape(1, 1024).copy()
        else:
            w = rng.integers(0, 2**32, (n, wpb), dtype=np.uint64)
            w = w.astype(np.uint32)
            w[0] = 0xFFFFFFFF
            w[-1] = 0xFFFFFFFF
        pows_np = ref.powers(wpb)
        words_cpu = torch.from_numpy(w.view(np.int32).copy())
        words = words_cpu.to(dev)
        pows = torch.from_numpy(pows_np.view(np.int32).copy()).to(dev)

        got = K.blockhash_batch(words, pows)
        plain = ref.blockhash(words, pows)
        torch.cuda.synchronize()
        # the numpy oracle, whole array: u64 products summed with u64
        # wraparound keep the low 32 bits exact (ref.blockhash_np's method)
        want = (w.astype(np.uint64) * pows_np.astype(np.uint64)).sum(
            axis=1) & 0xFFFFFFFF
        got_u32 = got.cpu().numpy().view(np.uint32).astype(np.uint64)
        sample = sorted({0, n - 1, *range(0, n, max(1, n // 16))})
        exact = (torch.equal(got, plain)
                 and np.array_equal(got_u32, want)
                 and all(int(got_u32[i]) == ref.blockhash_np(w[i].tobytes())
                         for i in sample))
        max_abs_err = int(np.abs(got_u32.astype(np.int64)
                                 - want.astype(np.int64)).max())
        assert exact, f"blockhash disagrees at {(n, wpb)}"

        ms = device_ms(lambda: K.blockhash_batch(words, pows))
        eager_ms = call_ms(lambda: K.blockhash_batch(words, pows))
        ms_with_copies = call_ms(
            lambda: K.blockhash_batch(words_cpu.to(dev), pows).cpu())
        plain_ms = device_ms(lambda: ref.blockhash(words, pows))
        nbytes = n * wpb * 4 + wpb * 4 + n * 4
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = 2 * n * wpb / CUDA_CORE_OPS_PER_S * 1e3
        row = {"shape": [n, wpb], "exact": exact, "max_abs_err": max_abs_err,
               "ms": ms, "eager_call_ms": eager_ms,
               "ms_with_copies": ms_with_copies,
               "plain_ms": plain_ms, "bytes": nbytes,
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "achieved_GBps": nbytes / (ms * 1e-3) / 1e9}
        rows.append(row)
        emit("kernel", name="blockhash", **row)
        del words, words_cpu, pows, got, plain
    torch.cuda.empty_cache()
    return rows


def phase_bento():
    """The main path: a bento mount on the card, driven by the fileserver
    and varmail mixes and 128-entry Mount.submit batches, with the
    launch counter set to 0 just before and read just after."""
    from repro_torch.fs.mounts import make_mount
    from repro_torch.kernels.blockhash import kernel as K

    def drive(mf, launches=None):
        v = mf.view
        spent = time_checksums(mf.services)
        t0 = time.perf_counter()
        n_fs = fileserver(v, 120)
        t1 = time.perf_counter()
        n_vm = varmail(v, 120)
        t2 = time.perf_counter()
        n_sb, calls, launched = submit_batches(mf, 8, launches=launches)
        t3 = time.perf_counter()
        return {"fileserver_ops_per_s": n_fs / (t1 - t0),
                "varmail_ops_per_s": n_vm / (t2 - t1),
                "submit_ops_per_s": n_sb / (t3 - t2),
                "ops": n_fs + n_vm + n_sb, "wall_s": t3 - t0,
                "checksum_s": spent["s"],
                "checksum_share": spent["s"] / (t3 - t0)}, calls, launched

    mf = make_mount("bento", n_blocks=32768)  # device defaults to cuda
    ks = mf.services
    c0 = checksum_calls(ks)
    K.reset_launches()
    rates, calls, launched = drive(mf, launches=K.launches)
    main_launches = K.launches()
    delta = checksum_calls(ks) - c0
    assert main_launches > 0 and main_launches == delta, (main_launches, delta)
    assert calls == [1] * len(calls) and launched == [1] * len(launched), (
        calls, launched)
    blocks = ks.counters["checksum_blocks"]
    mf.close()

    cpu = make_mount("bento", n_blocks=32768, device="cpu")
    cpu_rates, cpu_calls, _ = drive(cpu)
    cpu.close()
    same = np.array_equal(image(mf.dev), image(cpu.dev))
    assert same, "bento image on cuda differs from the cpu run"
    assert cpu_calls == calls
    emit("bento", launches=main_launches, checksum_batch_calls=delta,
         blocks_per_launch=blocks / max(1, ks.counters["checksum_batch_calls"]),
         launches_per_flushed_batch=launched, image_identical_to_cpu=same,
         cuda=rates, cpu=cpu_rates)
    return main_launches, rates


def phase_trace():
    """Where the time goes on the card: a short fileserver + varmail window
    on a bento mount under ``torch.profiler``; the device's busy time is
    the sum of its kernels' and copies' own times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.fs.mounts import make_mount

    mf = make_mount("bento", n_blocks=32768)
    fileserver(mf.view, 10, root="/warm")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ops = fileserver(mf.view, 40) + varmail(mf.view, 40)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    mf.close()
    by_name = {}
    for e in prof.key_averages():  # device events only: no double count
        us = e.self_device_time_total
        if e.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            by_name[e.key[:60]] = (us, e.count)
    busy_s = sum(us for us, _ in by_name.values()) * 1e-6
    assert busy_s > 0, "the profiler saw no device time"
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    emit("trace", ops=ops, wall_s=wall, device_busy_s=busy_s,
         device_idle_share=1 - busy_s / wall,
         device_top=[{"name": k, "us": us, "count": c}
                     for k, (us, c) in top])


def phase_other_kinds():
    from repro_torch.fs.mounts import make_mount
    from repro_torch.kernels.blockhash import kernel as K

    for kind in ("vfs", "ext4like"):
        mf = make_mount(kind, n_blocks=16384)
        ks = mf.services
        c0, l0 = checksum_calls(ks), K.launches()
        t0 = time.perf_counter()
        ops = fileserver(mf.view, 40) + varmail(mf.view, 40)
        wall = time.perf_counter() - t0
        launches = K.launches() - l0
        assert launches > 0 and launches == checksum_calls(ks) - c0
        mf.close()
        cpu = make_mount(kind, n_blocks=16384, device="cpu")
        fileserver(cpu.view, 40)
        varmail(cpu.view, 40)
        cpu.close()
        same = np.array_equal(image(mf.dev), image(cpu.dev))
        assert same, f"{kind} image on cuda differs from the cpu run"
        emit(kind, launches=launches, ops=ops, ops_per_s=ops / wall,
             launches_per_op=launches / ops, image_identical_to_cpu=same)


def phase_dedup():
    from repro_torch.core.interface import Errno, FsError
    from repro_torch.fs.mounts import make_mount
    from repro_torch.kernels.blockhash import kernel as K

    mf = make_mount("dedup-bento", n_blocks=32768)
    v, ks, fs = mf.view, mf.services, mf.mount.module
    c0, l0 = checksum_calls(ks), K.launches()

    # a 4:1 duplicate corpus (fs_micro --dedup): 24 files of 8 blocks
    # drawn from a pool of 48 unique blocks, in flushed batches of 8 files
    rng = np.random.default_rng(7)
    pool = [rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
            for _ in range(48)]
    files = {f"/d{f:03d}": b"".join(pool[int(rng.integers(48))]
                                    for _ in range(8)) for f in range(24)}
    paths = sorted(files)
    free0 = v.statfs()["free_blocks_est"]
    for i in range(0, len(paths), 8):
        v.write_many([(p, 0, files[p]) for p in paths[i:i + 8]],
                     create=True, fsync=True)
    physical = free0 - v.statfs()["free_blocks_est"]
    saving = 24 * 8 / max(1, physical)
    assert saving >= 2.0, saving

    # corrupt one data block behind the cache: EIO on exactly its file
    solo = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    v.write_file("/solo", solo)
    v.fsync("/solo")
    blk = fs._bmap_ro(fs._iget(v.stat("/solo").ino), 0, {})
    raw = bytearray(mf.dev.read_block(blk))
    raw[:16] = b"torn-by-smoke!!!"
    mf.dev.write_block(blk, bytes(raw))
    ks.sb_invalidate_blocks(fs.sb_cap, [blk])
    got = v.read_many([(p, 0, len(files[p])) for p in paths] + ["/solo"],
                      strict=False)
    bad = [p for p, r in zip(paths + ["/solo"], got)
           if isinstance(r, FsError)]
    assert bad == ["/solo"] and got[-1].errno == Errno.EIO, bad
    assert all(r == files[p] for p, r in zip(paths, got))

    # a file larger than the buffer cache (4096 blocks), read back whole in
    # three verified reads of 2048 blocks: each fetches its blocks from the
    # device and hashes them in one launch. (One read of the whole file
    # fails with EIO in both packages: BufferCache.bread_many evicts hits
    # of its own request while inserting the misses — ROADMAP Queue 3.)
    big_blocks, piece = 6144, 2048
    chunk = 48
    for b0 in range(0, big_blocks, chunk):
        v.write_many([("/big", (b0 + i) * 4096,
                       (b"%08d" % (b0 + i)) * 512) for i in range(chunk)],
                     create=True, fsync=True)
    verified0 = fs._blockstore.stats["verified_blocks"]
    b_calls0, b_blocks0 = (ks.counters["checksum_batch_calls"],
                           ks.counters["checksum_blocks"])
    data = b"".join(v.read_many([("/big", off * 4096, piece * 4096)])[0]
                    for off in range(0, big_blocks, piece))
    assert len(data) == big_blocks * 4096
    assert all(data[i * 4096:i * 4096 + 8] == b"%08d" % i
               for i in range(0, big_blocks, 97))
    verified = fs._blockstore.stats["verified_blocks"] - verified0
    read_calls = ks.counters["checksum_batch_calls"] - b_calls0
    read_blocks = ks.counters["checksum_blocks"] - b_blocks0
    launches = K.launches() - l0
    assert launches > 0 and launches == checksum_calls(ks) - c0
    assert verified >= 1000 and read_calls >= 1, (verified, read_calls)
    emit("dedup-bento", space_saving=saving, eio_files=bad,
         launches=launches, big_file_blocks=big_blocks,
         big_read_verified_blocks=verified, big_read_launches=read_calls,
         big_read_blocks_per_launch=read_blocks / read_calls,
         checksum_blocks_per_call=ks.counters["checksum_blocks"]
         / ks.counters["checksum_batch_calls"])
    mf.close()


def _crash_image(device, point: int, torn: int = -1):
    """On a fresh bento mount: a durable /keep, then /f written and lost
    ``point`` device writes into the fsync that commits it."""
    from repro_torch.fs.blockdev import BlockDeviceError
    from repro_torch.fs.mounts import make_mount

    mf = make_mount("bento", n_blocks=4096, device=device)
    v = mf.view
    v.write_file("/keep", b"k" * 9000)
    v.fsync("/keep")
    v.write_file("/f", bytes(range(256)) * 48)
    mf.dev.fail_after_writes = point
    mf.dev.fail_torn_bytes = torn
    mf.dev._writes_seen = 0
    try:
        v.fsync("/f")
    except BlockDeviceError:
        return image(mf.dev).copy()
    raise AssertionError(f"no crash at write {point}")


def _header_index(device) -> int:
    from repro_torch.fs.mounts import make_mount

    mf = make_mount("bento", n_blocks=4096, device=device)
    v = mf.view
    v.write_file("/keep", b"k" * 9000)
    v.fsync("/keep")
    v.write_file("/f", bytes(range(256)) * 48)
    logstart = mf.mount.module.geo.logstart
    seen = []
    orig = mf.dev.write_block

    def spy(blockno, data):
        seen.append((blockno, any(data[:4])))
        orig(blockno, data)

    mf.dev.write_block = spy
    v.fsync("/f")
    return seen.index((logstart, True))


def _recover(img, device, torch_dev: bool = False):
    from repro_torch.core.services import kernel_binding
    from repro_torch.fs.blockdev import MemBlockDevice, TorchBlockDevice
    from repro_torch.fs.mounts import DirectMount
    from repro_torch.fs.xv6 import Xv6FileSystem, Xv6Options

    dev = (TorchBlockDevice.from_image(img, device=device) if torch_dev
           else MemBlockDevice.from_image(img))
    ks = kernel_binding(dev, device=device)
    fs = Xv6FileSystem(Xv6Options(group_commit=True, batched_install=True))
    fs.init(ks.superblock(), ks)
    return image(dev).copy(), DirectMount(fs), ks


def phase_recovery():
    from repro_torch.core.interface import ROOT_INO
    from repro_torch.fs.mounts import make_mount
    from repro_torch.fs.posix import PosixView
    from repro_torch.kernels.blockhash import kernel as K

    hdr = _header_index("cuda")
    assert hdr == _header_index("cpu") and hdr >= 2
    results = {}
    for case, point, torn in (("after_commit_record", hdr + 1, -1),
                              ("torn_commit_record", hdr, 20)):
        img = _crash_image("cuda", point, torn)
        assert np.array_equal(img, _crash_image("cpu", point, torn))
        l0 = K.launches()
        rec_cuda, m, ks = _recover(img, "cuda")
        launches = K.launches() - l0
        rec_cpu, _, _ = _recover(img, "cpu")
        assert np.array_equal(rec_cuda, rec_cpu), case
        installed = int((rec_cuda != img).any(axis=1).sum())
        if case == "after_commit_record":
            assert installed > 2
            ino = m.lookup(ROOT_INO, "f").ino
            assert m.read(ino, 0, 1 << 14) == bytes(range(256)) * 48
        else:
            assert installed == 0
        # the probe, plus the recovery's one checksum of the journal
        assert launches == 1 + ks.counters["checksum_batch_calls"] >= 2
        results[case] = {"blocks_installed": installed, "launches": launches}

    # an image built by the plain path (device="cpu"; the CPU tests hold
    # it byte-identical to the JAX reference's) opens on the card
    ref = make_mount("ext4like", n_blocks=4096, device="cpu")
    ref.view.makedirs("/etc")
    ref.view.write_file("/etc/motd", b"built on the host\n" * 300)
    ref.close()
    for torch_dev in (False, True):
        _img, m, _ks = _recover(image(ref.dev), "cuda", torch_dev=torch_dev)
        v = PosixView(m)
        assert v.read_file("/etc/motd") == b"built on the host\n" * 300
    emit("recovery", header_write=hdr, cases=results,
         host_image_reads_back_on_card=True)


def phase_upgrade():
    from repro_torch.core.upgrade import upgrade
    from repro_torch.fs.ext4like import Ext4LikeFileSystem
    from repro_torch.fs.mounts import make_mount
    from repro_torch.kernels.blockhash import kernel as K

    def run(device):
        mf = make_mount("bento", n_blocks=16384, device=device)
        v = mf.view
        fileserver(v, 30)
        l0 = K.launches()
        stats = upgrade(mf.mount, Ext4LikeFileSystem(),
                        migrate=lambda s, o, n: {**s, "dirindex": {}})
        assert type(mf.mount.module).__name__ == "Ext4LikeFileSystem"
        l1 = K.launches()
        varmail(v, 30)
        fileserver(v, 20, root="/srv2")
        assert len(v.listdir("/srv")) > 0
        l2 = K.launches()
        mf.close()
        return mf, stats, (l0, l1, l2)

    mf, stats, (l0, l1, l2) = run("cuda")
    cpu, _, _ = run("cpu")
    assert l2 > l1 >= l0
    same = np.array_equal(image(mf.dev), image(cpu.dev))
    assert same, "upgraded image on cuda differs from the cpu run"
    emit("upgrade", pause_ms=stats["total_s"] * 1e3,
         launches_after_upgrade=l2 - l1, image_identical_to_cpu=same)


def phase_torch_device():
    from repro_torch.core.registry import mount as bento_mount
    from repro_torch.core.services import kernel_binding
    from repro_torch.fs.blockdev import MemBlockDevice, TorchBlockDevice
    from repro_torch.fs.posix import PosixView
    from repro_torch.fs.xv6 import Xv6FileSystem, Xv6Options, mkfs

    out = {}
    images = {}
    tdev = TorchBlockDevice(8192)  # the image on the card
    for name, dev in (("torch_block_device", tdev),
                      ("mem_block_device", MemBlockDevice(8192))):
        ks = kernel_binding(dev)
        mkfs(ks)
        m = bento_mount("xv6", ks, module=Xv6FileSystem(Xv6Options(
            group_commit=True, batched_install=True)))
        t0 = time.perf_counter()
        ops = fileserver(PosixView(m), 30)
        m.unmount()
        out[name] = ops / (time.perf_counter() - t0)
        images[name] = image(dev)
    same = np.array_equal(images["torch_block_device"],
                          images["mem_block_device"])
    assert same, "TorchBlockDevice image differs from MemBlockDevice"
    emit("torch_block_device", image_on=str(tdev._data.device),
         ops_per_s=out, image_identical=same)


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke.py runs from the root of a checkout: "
              f"{SRC / 'repro_torch'} is missing", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py measures the port on a GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = phase_device()
    rows = phase_kernel()
    main_launches, _rates = phase_bento()
    phase_trace()
    phase_other_kinds()
    phase_dedup()
    phase_recovery()
    phase_upgrade()
    phase_torch_device()

    head = next(r for r in rows if tuple(r["shape"]) == HEADLINE_SHAPE)
    print(json.dumps({"kernels": [{
        "name": "blockhash", "route": "cuda",
        "source": "src/repro_torch/csrc/blockhash.cu",
        "replaces": "src/repro/kernels/blockhash/kernel.py:26",
        "launches": main_launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "exact": all(r["exact"] for r in rows),
        "shape": list(HEADLINE_SHAPE),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None,
        "shapes": rows}], "card": card,
        "seconds": time.perf_counter() - t_start}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
