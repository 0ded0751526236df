#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Builds the CUDA kernels from ``src/repro_torch/csrc`` (``nvcc``, sm_90a,
into ``build/repro_torch/``), holds every kernel against its plain
PyTorch version on the card, then drives the Bento request path
(``make_mount`` -> ``Mount.submit`` / ``PosixView`` -> xv6 -> journal ->
``KernelServices.checksum_batch`` -> the CUDA blockhash kernel) and checks
each result against the same stream run with ``device="cpu"``, which the
CPU tests hold byte-identical to the JAX reference package. Then it serves
rwkv6-7b at full width and depth (``serve.step`` -> ``models/rwkv`` -> the
CUDA WKV6 kernel for every prefill), checks the prefill against the same
prefill through the plain version, and traces where the time goes. Then it
holds the SSD and flash attention kernels against their plain versions and
serves zamba2-7b at full width and depth the same way (``models/mamba2`` ->
the CUDA SSD kernel in each Mamba2 layer's prefill, the shared attention
block -> the CUDA flash attention kernel). Every phase asserts and prints
JSON lines; the last line is the device record. It
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

# H100 SXM, NVIDIA's data sheet: device-memory rate, the float32 rate
# outside the tensor cores (the table's nearest entry for the blockhash
# kernel's integer multiply-adds), and the tensor cores' dense bf16 rate.
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12
# The card's host link, PCIe Gen5 x16: 128 GB/s both ways on the same data
# sheet, so 64 GB/s for the words that cross it one way.
HOST_LINK_BYTES_PER_S = 64e9

# (nblocks, wpb): the probe, a 16-byte input, a 4093-byte block padded to
# whole words, one full journal commit (nlog=64 holds 63 blocks), one
# buffer cache (4096 blocks, 16 MiB) and the 128 MiB image of the
# fs_macro fileserver mount.
KERNEL_SHAPES = ((1, 2), (1, 4), (1, 1024), (63, 1024), (4096, 1024),
                 (32768, 1024))
HEADLINE_SHAPE = (63, 1024)

SOURCES = ("blockhash", "wkv6", "ssd", "flash_attention")  # csrc/<name>.cu

# (B, S, H, K, V, chunk): the three shapes of tests/test_kernels.py's WKV6
# sweep, then the serve's full width (rwkv6-7b: 64 heads of 64, chunk 32,
# batch 4, prompt 1024).
WKV6_SHAPES = ((2, 64, 3, 16, 16, 16), (1, 128, 2, 32, 32, 32),
               (1, 64, 1, 8, 8, 64), (4, 1024, 64, 64, 64, 32))
WKV6_HEADLINE = ((4, 1024, 64, 64, 64, 32), "bfloat16")
WKV6_TOL = 1e-4  # x max(1, max|ref|), for y and the state
SERVE = {"arch": "rwkv6-7b", "batch": 4, "prompt": 1024, "gen": 32}

# (b, S, H, P, N, chunk): the three shapes of tests/test_kernels.py's SSD
# sweep, then the serve's full width (zamba2-7b: 112 heads, P = N = 64,
# chunk 128, batch 4, prompt 1024).
SSD_SHAPES = ((2, 128, 3, 16, 8, 32), (1, 256, 2, 64, 64, 128),
              (1, 64, 1, 8, 8, 64), (4, 1024, 112, 64, 64, 128))
SSD_HEADLINE = ((4, 1024, 112, 64, 64, 128), "bfloat16")
SSD_TOL = 2e-4  # x max(1, max|ref|), for y and the state
# (B, Sq, Skv, Hq, Hkv, D, causal, window, softcap): the five shapes of
# tests/test_kernels.py's flash sweep, a softcap case at the serve's
# head_dim, lengths no tile divides (Skv != Sq under a window; the serve's
# shared block at a 1000-token prompt), then the serve's shared block
# (zamba2-7b: 32 heads of 112).
FLASH_CASES = ((2, 256, 256, 4, 2, 64, True, 0, 0.0),
               (1, 512, 512, 8, 8, 128, True, 0, 0.0),
               (2, 256, 256, 4, 4, 64, False, 0, 0.0),
               (1, 512, 512, 4, 2, 64, True, 128, 0.0),
               (1, 256, 512, 4, 1, 64, False, 0, 0.0),
               (1, 256, 256, 4, 2, 112, True, 0, 5.0),
               (2, 100, 300, 4, 2, 112, True, 64, 0.0),
               (4, 1000, 1000, 32, 32, 112, True, 0, 0.0),
               (4, 1024, 1024, 32, 32, 112, True, 0, 0.0))
FLASH_HEADLINE = ((4, 1024, 1024, 32, 32, 112, True, 0, 0.0), "bfloat16")
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # atol = rtol, as the tests
# odd_prompt: a prefill whose length neither a flash block (128) nor the
# SSD chunk (128) divides
ZAMBA = {"arch": "zamba2-7b", "batch": 4, "prompt": 1024, "gen": 32,
         "odd_prompt": 1000}


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


def phase_build():
    """Build every CUDA source at once, one nvcc each."""
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all(SOURCES)
    build_s = time.perf_counter() - t0
    ptxas = {name: ptxas_lines(name) for name in SOURCES}
    emit("build", sources=list(SOURCES), seconds=build_s, ptxas=ptxas)


def phase_kernel():
    """Hold the CUDA blockhash against the plain version on the card and
    against the numpy oracle, exactly, at every shape: through the public
    wrapper on words in device memory, and as the main path runs it
    (``ops._Staging.hash``: the kernel reads mapped pinned host words).
    Time both; the main path's way is bounded by the host link."""
    import torch

    from repro_torch.kernels.blockhash import kernel as K
    from repro_torch.kernels.blockhash import ops, ref

    rng = np.random.default_rng(2024)
    dev = torch.device("cuda", torch.cuda.current_device())
    st = ops.staging(dev)
    rows = []
    for n, wpb in KERNEL_SHAPES:
        if (n, wpb) == (1, 2):
            blocks = [b"probe"]
        elif (n, wpb) == (1, 1024):
            blocks = [rng.integers(0, 256, 4093, dtype=np.uint8).tobytes()]
        else:
            w = rng.integers(0, 2**32, (n, wpb), dtype=np.uint64)
            w = w.astype(np.uint32)
            w[0] = 0xFFFFFFFF
            w[-1] = 0xFFFFFFFF
            blocks = [row.tobytes() for row in w]
        w = ops._words(blocks)
        assert w.shape == (n, wpb)
        pows_np = ref.powers(wpb)
        words_cpu = torch.from_numpy(w.view(np.int32).copy())
        words = words_cpu.to(dev)
        pows = torch.from_numpy(pows_np.view(np.int32).copy()).to(dev)

        got = K.blockhash_batch(words, pows)
        plain = ref.blockhash(words, pows)
        pinned = st.hash(blocks)
        torch.cuda.synchronize()
        # the numpy oracle, whole array: u64 products summed with u64
        # wraparound keep the low 32 bits exact (ref.blockhash_np's method)
        want = (w.astype(np.uint64) * pows_np.astype(np.uint64)).sum(
            axis=1) & 0xFFFFFFFF
        got_u32 = got.cpu().numpy().view(np.uint32).astype(np.uint64)
        sample = sorted({0, n - 1, *range(0, n, max(1, n // 16))})
        exact = (torch.equal(got, plain)
                 and np.array_equal(got_u32, want)
                 and pinned == want.tolist()
                 and all(int(got_u32[i]) == ref.blockhash_np(w[i].tobytes())
                         for i in sample))
        max_abs_err = int(np.abs(got_u32.astype(np.int64)
                                 - want.astype(np.int64)).max())
        assert exact, f"blockhash disagrees at {(n, wpb)}"

        # the main path's launch on the words it staged, without its wait
        # (a wait cannot be captured in a CUDA graph); then with the wait,
        # events around 20 calls in a row, the host's launch cost included
        def launch_pinned(wait=False):
            K.hash_pinned(st.host_words.data_ptr(), ops._pows(wpb, dev)
                          .data_ptr(), st.host_out.data_ptr(), n, wpb,
                          torch.cuda.current_stream().cuda_stream, wait)
        ms = device_ms(launch_pinned)
        pinned_call = call_ms(lambda: launch_pinned(wait=True))
        assert st.out_u32[:n].tolist() == want.tolist()
        resident_ms = device_ms(lambda: K.blockhash_batch(words, pows))
        eager_ms = call_ms(lambda: K.blockhash_batch(words, pows))
        ms_with_copies = call_ms(
            lambda: K.blockhash_batch(words_cpu.to(dev), pows).cpu())
        plain_ms = device_ms(lambda: ref.blockhash(words, pows))
        nbytes = n * wpb * 4 + wpb * 4 + n * 4
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = 2 * n * wpb / CUDA_CORE_OPS_PER_S * 1e3
        # the main path's words cross the host link to the card
        link_ms = n * wpb * 4 / HOST_LINK_BYTES_PER_S * 1e3
        row = {"shape": [n, wpb], "exact": exact, "max_abs_err": max_abs_err,
               "ms": ms, "pinned_call_ms": pinned_call,
               "device_resident_ms": resident_ms, "eager_call_ms": eager_ms,
               "ms_with_copies": ms_with_copies,
               "plain_ms": plain_ms, "bytes": nbytes,
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "host_link_bound_ms": max(link_ms, bytes_ms, ops_ms),
               "host_link_share": max(link_ms, bytes_ms, ops_ms) / ms,
               "link_GBps": n * wpb * 4 / (ms * 1e-3) / 1e9,
               "device_resident_GBps": nbytes / (resident_ms * 1e-3) / 1e9}
        if (n, wpb) == HEADLINE_SHAPE:
            row.update(blockhash_call(rng))
        rows.append(row)
        emit("kernel", name="blockhash", **row)
        del words, words_cpu, pows, got, plain
    torch.cuda.empty_cache()
    return rows


def blockhash_call(rng, reps: int = 200, threads: int = 4) -> dict:
    """The host's time for one ``ops.checksum_batch`` at one commit (63
    random blocks of 4096 bytes), as the journal calls it: the median of
    ``reps`` calls on the host clock; the same calls split by stage, from
    the stamps ``ops._Staging.hash`` keeps of its last call (each stage's
    median; ``entry`` is the device lookup before ``hash``, ``return``
    what follows it); the call as the first port made it (per-block padding,
    ``np.stack``, a pageable copy, the checked wrapper, ``.tolist()``) on
    the same blocks; ``threads`` callers at once, each with its own
    blocks, which the staging lock serialises (calls a second, all
    threads together, against one thread's); and ``torch.profiler``'s CPU
    operations over 20 calls."""
    import threading

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.blockhash import kernel as K
    from repro_torch.kernels.blockhash import ops

    def commit():
        return [rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
                for _ in range(HEADLINE_SHAPE[0])]

    blocks = commit()
    want = [ops.ref.blockhash_np(b) for b in blocks]
    dev = torch.device("cuda", torch.cuda.current_device())
    st = ops.staging(dev)
    assert ops.checksum_batch(blocks, device=dev) == want

    def host_ms(fn):
        for _ in range(10):
            fn()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def parent_call():
        words = torch.from_numpy(np.stack([
            np.frombuffer(b + b"\0" * (-len(b) % 4), dtype=np.uint32)
            for b in blocks]).view(np.int32)).to(dev)
        out = K.blockhash_batch(words, ops._pows(words.shape[1], dev))
        return [x & 0xFFFFFFFF for x in out.tolist()]

    assert parent_call() == want
    l0 = K.launches()
    call = host_ms(lambda: ops.checksum_batch(blocks, device=dev))
    assert K.launches() - l0 == reps + 10  # one launch a call
    parent = host_ms(parent_call)

    split = []
    for _ in range(reps):
        t0 = time.perf_counter()
        got = ops.checksum_batch(blocks, device=dev)
        split.append(np.diff([t0, *st.stamps, time.perf_counter()]) * 1e3)
        assert got == want
    split_ms = dict(zip(("entry", *st.STAGES, "return"),
                        np.median(split, axis=0).tolist()))

    batches = [commit() for _ in range(threads)]
    wants = [[ops.ref.blockhash_np(b) for b in bs] for bs in batches]
    barrier = threading.Barrier(threads)
    got = [None] * threads

    def run(i):
        barrier.wait()
        got[i] = [ops.checksum_batch(batches[i], device=dev)
                  for _ in range(reps)]

    workers = [threading.Thread(target=run, args=(i,))
               for i in range(threads)]
    t0 = time.perf_counter()
    for th in workers:
        th.start()
    for th in workers:
        th.join()
    together_s = time.perf_counter() - t0
    assert got == [[w] * reps for w in wants]

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(20):
            ops.checksum_batch(blocks, device=dev)
    top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return {"call_ms": call, "parent_call_ms": parent,
            "call_split_ms": split_ms,
            "calls_per_s_one_thread": 1e3 / call,
            f"calls_per_s_{threads}_threads": threads * reps / together_s,
            "call_profile_top": [
                {"name": e.key[:60], "self_cpu_us_per_call":
                 e.self_cpu_time_total / 20, "count": e.count}
                for e in top[:8]]}


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
         checksum_ms_per_call=rates["checksum_s"] / delta * 1e3,
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


def phase_parallel_drain(threads: int = 4, blocks: int = 512,
                         piece: int = 128, rounds: int = 4):
    """Verified reads from ``threads`` submitters at once on a dedup-bento
    mount, first with the serial drain, then with a pool of ``threads``
    workers (``Mount.enable_parallel_drain``), which runs read-only
    groups on different files at once, so their checksum calls meet at
    the blockhash staging lock. Each submitter reads its own file of
    ``blocks`` blocks in pieces of ``piece``, ``rounds`` times, the files'
    blocks dropped from the buffer cache before each round, so every read
    fetches from the device and hashes what it fetched. (The files
    together stay inside the cache: a request that meets a full cache
    can evict its own hits, the reference's fault in ROADMAP Queue 3.)
    Every read is checked; launches equal checksum calls; the host ms per
    checksum call (the lock's wait included) and the wall time, serial
    against parallel."""
    import threading

    from repro_torch.core.interface import SubmissionEntry
    from repro_torch.fs.mounts import make_mount
    from repro_torch.kernels.blockhash import kernel as K

    mf = make_mount("dedup-bento", n_blocks=32768)
    v, ks, m = mf.view, mf.services, mf.mount
    fs = m.module
    paths = [f"/p{t}" for t in range(threads)]

    def content(t, blk):
        return (b"%4s%012d" % (paths[t].encode(), blk)) * 256

    for t, path in enumerate(paths):
        for b0 in range(0, blocks, 48):
            v.write_many([(path, b * 4096, content(t, b))
                          for b in range(b0, min(b0 + 48, blocks))],
                         create=True, fsync=True)
    # made beforehand, so the readers hold the interpreter lock briefly
    want = {(t, b0): b"".join(content(t, b) for b in range(b0, b0 + piece))
            for t in range(threads) for b0 in range(0, blocks, piece)}
    inos = [v.stat(path).ino for path in paths]
    homes = [fs._bmap_ro(fs._iget(ino), b, {}) for ino in inos
             for b in range(blocks)]
    spent = time_checksums(ks)
    stats = fs._blockstore.stats

    def read_all():
        bad = []

        def run(t, barrier):
            barrier.wait()
            for b0 in range(0, blocks, piece):
                comp, = m.submit([SubmissionEntry(
                    "read", (inos[t], b0 * 4096, piece * 4096))])
                if not comp.ok or comp.result != want[t, b0]:
                    bad.append((t, b0, comp.errno))

        c0, l0, s0 = checksum_calls(ks), K.launches(), spent["s"]
        v0, x0 = stats["verified_blocks"], stats["corruptions_detected"]
        wall = 0.0
        for _ in range(rounds):
            ks.sb_invalidate_blocks(fs.sb_cap, homes)
            barrier = threading.Barrier(threads)
            workers = [threading.Thread(target=run, args=(t, barrier))
                       for t in range(threads)]
            t0 = time.perf_counter()
            for th in workers:
                th.start()
            for th in workers:
                th.join()
            wall += time.perf_counter() - t0
        calls = checksum_calls(ks) - c0
        assert not bad and stats["corruptions_detected"] == x0, (
            bad[:4], stats["corruptions_detected"] - x0)
        assert stats["verified_blocks"] - v0 == rounds * len(homes)
        assert calls > 0 and K.launches() - l0 == calls, (
            calls, K.launches() - l0)
        return {"wall_s": wall, "checksum_calls": calls,
                "verified_blocks": stats["verified_blocks"] - v0,
                "checksum_ms_per_call": (spent["s"] - s0) / calls * 1e3,
                "checksum_share": (spent["s"] - s0) / wall}

    serial = read_all()
    m.enable_parallel_drain(threads)
    parallel = read_all()
    mf.close()
    emit("parallel_drain", threads=threads, file_blocks=blocks, piece=piece,
         rounds=rounds, serial=serial, parallel=parallel)


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



# --- the rwkv6 serve (models/rwkv -> kernels/wkv6 -> csrc/wkv6.cu) ----------------------


def wkv6_work(B, S, H, K, V, C, esize):
    """(bytes, product operations, other operations) of one WKV6 scan, from
    the formulas in csrc/wkv6.cu's header: each input read once (r, k, v,
    w, u in their dtype, the state in f32), each output written once (y
    and the state in f32). The products are the four matrix products: the
    multiply-adds of r and k under the decays, tmp v (the u bonus on tmp's
    diagonal included), (r exp(Le)) S and kd^T v. The rest is logw, the
    cumulative sums, the decays' exponentials and every scaling. An exp, a
    compare, and a multiply-add's two halves count one operation each."""
    P = C * (C - 1) // 2
    products = (2 * P * K                    # r k^T, s < t
                + 2 * P * V + 2 * C * V      # tmp v, the bonus with it
                + 2 * C * K * V              # (r exp(Le)) S
                + 2 * C * K * V)             # kd^T v
    other = (4 * C * K                       # logw = -exp(w), cumsum, Le
             + 5 * P * K                     # sub, clip, exp, times A
             + 3 * C * K                     # sum_k r u k
             + 2 * C * K + C * V             # r exp(Le), add
             + 3 * C * K + K                 # k exp(Li_last - Li), exp(Li_last)
             + 2 * K * V)                    # decay S
    nbytes = ((B * S * H * (3 * K + V) + H * K) * esize
              + B * S * H * V * 4 + 2 * B * H * K * V * 4)
    n = B * H * (S // C)
    return nbytes, n * products, n * other


def wkv6_bound(B, S, H, K, V, C, dtype):
    """The least time of one WKV6 scan: the bytes at the HBM rate, or the
    operations at the peak rate of their type, added: for bf16 inputs the
    products at the tensor cores' bf16 rate and the rest at the CUDA
    cores' float32 rate, for float32 inputs all at the CUDA cores' rate.
    ``earlier_bound_ms`` is the bound the CUDA-core kernel was given:
    every operation at the CUDA cores' rate, whatever the dtype."""
    esize = 2 if dtype == "bfloat16" else 4
    nbytes, products, other = wkv6_work(B, S, H, K, V, C, esize)
    prod_rate = (BF16_TENSOR_OPS_PER_S if dtype == "bfloat16"
                 else CUDA_CORE_OPS_PER_S)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (products / prod_rate + other / CUDA_CORE_OPS_PER_S) * 1e3
    earlier_ms = max(bytes_ms,
                     (products + other) / CUDA_CORE_OPS_PER_S * 1e3)
    return {"bytes": nbytes, "product_ops": products, "other_ops": other,
            "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "earlier_bound_ms": earlier_ms}


def wkv6_inputs(rng, B, S, H, K, V, regime):
    """r, k, v, w, u, state as float32 numpy arrays. ``smoke`` draws w as
    tests/test_kernels.py does (N(0, 0.3): a decay of about 0.37 a token);
    ``strong``, w ~ N(2, 1), decays down to exp(-50) a token or less;
    ``weak``, w ~ N(-4, 0.5), about 0.98 a token."""
    n = lambda *shape: rng.standard_normal(shape, dtype=np.float32)
    r, k, v = n(B, S, H, K) * 0.5, n(B, S, H, K) * 0.5, n(B, S, H, V)
    w = {"smoke": lambda: n(B, S, H, K) * 0.3,
         "strong": lambda: 2.0 + n(B, S, H, K),
         "weak": lambda: -4.0 + 0.5 * n(B, S, H, K)}[regime]()
    return r, k, v, w, n(H, K) * 0.3, n(B, H, K, V) * 0.1


def phase_wkv6_kernel():
    """Hold the CUDA WKV6 scan against the plain version on the card, in
    f32 and bf16, at every shape and, at the serve's shape, under strong
    and weak decay: y and the state each within 1e-4 x max(1, max|ref|)."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.wkv6 import kernel as K
    from repro_torch.kernels.wkv6 import ref

    rng = np.random.default_rng(2025)
    dev = torch.device("cuda")
    cases = [(shape, "smoke") for shape in WKV6_SHAPES] + [
        (WKV6_HEADLINE[0], regime) for regime in ("strong", "weak")]
    rows = []
    for (B, S, H, Kd, V, C), regime in cases:
        arrays = wkv6_inputs(rng, B, S, H, Kd, V, regime)
        big = B * S * H >= 1 << 16
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            r, k, v, w, u = (torch.from_numpy(a).to(dev, dt)
                             for a in arrays[:5])
            s0 = torch.from_numpy(arrays[5]).to(dev)
            y, st = K.wkv6_chunked(r, k, v, w, u, s0, chunk=C)
            y_ref, st_ref = ref.wkv6(r, k, v, w, u, s0, chunk=C)
            torch.cuda.synchronize()
            errs, ok = [], True
            finite = bool(torch.isfinite(y).all() and torch.isfinite(st).all())
            for got, want in ((y, y_ref), (st, st_ref)):
                err = (got - want).abs().max().item()
                ok &= err <= WKV6_TOL * max(1.0, want.abs().max().item())
                errs.append(err)
            assert finite and ok, (f"wkv6 disagrees at {(B, S, H, Kd, V, C)} "
                                   f"{dtype} {regime}: {errs}")
            ms = device_ms(lambda: K.wkv6_chunked(r, k, v, w, u, s0, chunk=C))
            plain_ms = device_ms(lambda: ref.wkv6(r, k, v, w, u, s0, chunk=C),
                                 count=5 if big else 20,
                                 reps=10 if big else 20)
            row = {"shape": [B, S, H, Kd, V, C], "dtype": dtype,
                   "regime": regime,
                   "tensor_cores": K.uses_tensor_cores(Kd, V, C,
                                                       r.element_size()),
                   "max_abs_err": max(errs), "y_err": errs[0],
                   "state_err": errs[1],
                   "y_scale": y_ref.abs().max().item(),
                   "state_scale": st_ref.abs().max().item(),
                   "within_tol": ok, "ms": ms, "plain_ms": plain_ms,
                   **wkv6_bound(B, S, H, Kd, V, C, dtype)}
            row["share_of_bound"] = row["bound_ms"] / ms
            rows.append(row)
            emit("wkv6_kernel", **row)
            del r, k, v, w, u, s0, y, st, y_ref, st_ref
    serve = WKV6_HEADLINE[0][3:]
    emit("wkv6_kernel_build", ptxas=ptxas_lines("wkv6"),
         smem_bytes_serve={"bfloat16": K.smem_bytes(*serve, 2),
                           "float32": K.smem_bytes(*serve, 4)},
         blocks_per_sm_by_smem_serve={
             "bfloat16": _build.blocks_per_sm(K.smem_bytes(*serve, 2)),
             "float32": _build.blocks_per_sm(K.smem_bytes(*serve, 4))})
    torch.cuda.empty_cache()
    return rows


def phase_serve_rwkv6():
    """The model path: rwkv6-7b at full width and depth in bf16, seeded
    random weights on the card, batch 4, a 1024-token prompt and 32
    greedy tokens through serve.step, with the wkv6 count set to 0 just
    before and read after the prefill and after each decode step. Then the
    same prefill through the plain version, in bf16 and in f32, and the
    smoke config on the card against the CPU path, which the CPU tests hold
    to the reference."""
    import functools

    import torch

    from repro_torch.configs import registry
    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.kernels.wkv6 import kernel as K
    from repro_torch.kernels.wkv6 import ops
    from repro_torch.models import lm, params as P
    from repro_torch.serve.step import make_decode_step, make_prefill_step

    bundle = registry.get(SERVE["arch"])
    cfg, run = bundle.model, bundle.run
    ctx = ShardingCtx.null()
    dev = torch.device("cuda")
    B, prompt, gen = SERVE["batch"], SERVE["prompt"], SERVE["gen"]

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(0)
    prm = P.materialize(lm.param_specs(cfg), g, dev, dtype=run.compute_dtype)
    tokens = torch.randint(0, cfg.vocab_size, (B, prompt), generator=g,
                           device=dev, dtype=torch.int32)
    torch.cuda.synchronize()
    materialize_s = time.perf_counter() - t0
    leaves = list(P.leaves(prm))
    n_params = sum(t.numel() for t in leaves)
    assert n_params == 7_576_621_056, n_params
    assert (cfg.num_layers, cfg.d_model) == (32, 4096)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)

    prefill = make_prefill_step(cfg, run, ctx)
    decode = make_decode_step(cfg, run, ctx)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    tok, cache = prefill(prm, {"tokens": tokens})
    ids = [tok.cpu()]
    prefill_cold_s = time.perf_counter() - t0
    prefill_launches = K.launches()
    step_launches = []
    t0 = time.perf_counter()
    for i in range(gen - 1):
        l0 = K.launches()
        tok, cache = decode(prm, cache, {"tokens": tok[:, None],
                                         "pos": prompt + i})
        ids.append(tok.cpu())
        step_launches.append(K.launches() - l0)
    decode_s = time.perf_counter() - t0
    main_launches = K.launches()
    peak = torch.cuda.max_memory_allocated()
    assert prefill_launches == cfg.num_layers, prefill_launches
    assert step_launches == [0] * (gen - 1), step_launches
    ids = torch.stack(ids, dim=1).numpy()
    assert ids.shape == (B, gen) and ((0 <= ids) & (ids < cfg.vocab_size)).all()
    del cache

    def timed_prefill(params, rn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = lm.prefill_fn(cfg, rn, ctx, params, {"tokens": tokens})
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def through_ref(fn):
        """``fn()`` with ``ops.wkv6`` pointed at the plain version."""
        kernel_wkv = ops.wkv6
        ops.wkv6 = functools.partial(kernel_wkv, use_kernel=False)
        l0 = K.launches()
        out = fn()
        ops.wkv6 = kernel_wkv
        assert K.launches() == l0, "the plain prefill launched the kernel"
        return out

    def rel_by_layer(a, b):
        return [((x - y).abs().max() / y.abs().max()).item()
                for x, y in zip(a, b)]

    def logits_err(a, b):
        scale = max(1.0, b.float().abs().max().item())
        return (a.float() - b.float()).abs().max().item(), scale

    # The same bf16 prefill, warm, through the kernel and the plain
    # version. Layer 0's scan sees identical inputs in both, so its state
    # must agree to f32 rounding; from there each layer's y is rounded to
    # bf16, where an f32 difference near a rounding boundary flips an ulp,
    # and 32 random layers amplify such flips. So the logits are held in
    # f32 below, with the same weights, and reported here.
    (logits, cache), prefill_s = timed_prefill(prm, run)
    (logits_ref, cache_ref), prefill_ref_s = through_ref(
        lambda: timed_prefill(prm, run))
    assert logits.shape == (B, cfg.vocab_size)
    assert torch.isfinite(logits).all() and torch.isfinite(logits_ref).all()
    wkv_rel = rel_by_layer(cache["wkv"], cache_ref["wkv"])
    assert wkv_rel[0] <= 1e-4, f"layer 0 wkv state differs: {wkv_rel[0]}"
    bf16_err, bf16_scale = logits_err(logits, logits_ref)
    first_token_repeats = bool(
        (logits.argmax(-1).cpu().numpy() == ids[:, 0]).all())
    del cache, cache_ref

    # The same prefill in f32 (the bf16 weights widened exactly; matmuls
    # in full f32, TF32 off), through the kernel and the plain version:
    # the last-token logits within 2e-2 x max(1, max|logits|).
    assert not torch.backends.cuda.matmul.allow_tf32
    prm32 = P.tree_map(lambda t: t.float(), prm)
    run32 = run.replace(compute_dtype="float32")
    (logits32, cache32), prefill_f32_s = timed_prefill(prm32, run32)
    (logits32_ref, cache32_ref), _ = through_ref(
        lambda: timed_prefill(prm32, run32))
    wkv32_rel = rel_by_layer(cache32["wkv"], cache32_ref["wkv"])
    assert wkv32_rel[0] <= 1e-4, f"layer 0 f32 wkv state: {wkv32_rel[0]}"
    f32_err, f32_scale = logits_err(logits32, logits32_ref)
    assert f32_err <= 2e-2 * f32_scale, (f32_err, f32_scale)
    bf16_vs_f32_err, _ = logits_err(logits, logits32)
    # the kernel moves the bf16 logits less than bf16 itself moves them
    assert bf16_err < bf16_vs_f32_err, (bf16_err, bf16_vs_f32_err)
    del prm32, cache32, cache32_ref, logits_ref, logits32_ref
    torch.cuda.empty_cache()

    # the smoke config in f32, every leaf random, on the card (the CUDA
    # kernel) against the CPU (the plain version)
    smoke, srun = bundle.smoke, run.replace(compute_dtype="float32")
    gcpu = torch.Generator().manual_seed(1)
    sprm = P.materialize(lm.param_specs(smoke), gcpu, "cpu")
    for t in P.leaves(sprm):
        t.add_(0.1 * torch.randn(t.shape, generator=gcpu))
    stoks = torch.randint(0, smoke.vocab_size, (2, 4 * smoke.scan_chunk),
                          generator=gcpu, dtype=torch.int32)
    sprm_dev = P.tree_map(lambda t: t.to(dev), sprm)
    l0 = K.launches()
    with torch.inference_mode():
        s_cpu, _ = lm.prefill_fn(smoke, srun, ctx, sprm, {"tokens": stoks})
        s_dev, _ = lm.prefill_fn(smoke, srun, ctx, sprm_dev,
                                 {"tokens": stoks.to(dev)})
    assert K.launches() - l0 == smoke.num_layers
    smoke_err = (s_dev.cpu() - s_cpu).abs().max().item()
    smoke_scale = max(1.0, s_cpu.abs().max().item())
    assert smoke_err <= 1e-4 * smoke_scale, (smoke_err, smoke_scale)

    emit("serve_rwkv6", arch=cfg.name, layers=cfg.num_layers,
         d_model=cfg.d_model, params=n_params, param_bytes=param_bytes,
         dtype=run.compute_dtype, batch=B, prompt=prompt, gen=gen,
         materialize_s=materialize_s,
         prefill_ms=prefill_s * 1e3, prefill_cold_ms=prefill_cold_s * 1e3,
         prefill_ref_ms=prefill_ref_s * 1e3,
         prefill_f32_ms=prefill_f32_s * 1e3,
         decode_ms_per_token=decode_s / (gen - 1) * 1e3,
         tokens_per_s=B * (gen - 1) / decode_s,
         request_tokens_per_s=B * gen / (prefill_cold_s + decode_s),
         peak_memory_bytes=peak,
         wkv6_launches_per_prefill=prefill_launches,
         wkv6_launches_per_decode_step=max(step_launches),
         generated_ids_row0=ids[0].tolist(),
         first_token_repeats_in_warm_prefill=first_token_repeats,
         wkv_rel_err_by_layer=wkv_rel, logits_bf16_max_abs_err=bf16_err,
         logits_bf16_scale=bf16_scale,
         wkv_rel_err_by_layer_f32=wkv32_rel, logits_f32_max_abs_err=f32_err,
         logits_f32_scale=f32_scale, logits_bf16_vs_f32_err=bf16_vs_f32_err,
         smoke_card_vs_cpu_err=smoke_err)
    return main_launches, prm, tokens


def _device_window(prof) -> dict:
    import torch

    by_name = {}
    for e in prof.key_averages():  # device events only: no double count
        us = e.self_device_time_total
        if e.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            by_name[e.key] = (us, e.count)
    return by_name


def _kernel_kind(name: str) -> str:
    """A device kernel's kind, from its name in the profiler: the port's
    two zamba2 kernels, cuBLAS matrix products (``nvjet``, ``gemv`` and
    the older ``gemm``/``xmma`` names), PyTorch's elementwise and
    reduction kernels, copies, or other."""
    low = name.lower()
    for kind, keys in (("ssd", ("ssd_kernel",)), ("flash", ("flash_fwd",)),
                       ("matmul", ("gemm", "gemv", "xmma", "nvjet", "cutlass",
                                   "cublas")),
                       ("elementwise", ("elementwise",)),
                       ("reduction", ("reduce",)),
                       ("copy", ("memcpy", "memset", "copy"))):
        if any(k in low for k in keys):
            return kind
    return "other"


def phase_serve_trace(prm, tokens):
    """Where the time goes in the serve: one prefill, then 8 decode steps,
    each under ``torch.profiler``; the device's busy time is the sum of
    its kernels' and copies' own times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import registry
    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.serve.step import make_decode_step, make_prefill_step

    bundle = registry.get(SERVE["arch"])
    cfg, run = bundle.model, bundle.run
    ctx = ShardingCtx.null()
    prefill = make_prefill_step(cfg, run, ctx)
    decode = make_decode_step(cfg, run, ctx)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof_p:
        t0 = time.perf_counter()
        tok, cache = prefill(prm, {"tokens": tokens})
        tok.cpu()
        prefill_wall = time.perf_counter() - t0
    with profile(activities=acts) as prof_d:
        t0 = time.perf_counter()
        for i in range(8):
            tok, cache = decode(prm, cache, {"tokens": tok[:, None],
                                             "pos": SERVE["prompt"] + i})
            tok.cpu()
        decode_wall = time.perf_counter() - t0
    out = {}
    for name, prof, wall in (("prefill", prof_p, prefill_wall),
                             ("decode_8_steps", prof_d, decode_wall)):
        by_name = _device_window(prof)
        busy_s = sum(us for us, _ in by_name.values()) * 1e-6
        assert busy_s > 0, f"the profiler saw no device time in {name}"
        wkv_us = sum(us for k, (us, _) in by_name.items() if "wkv6" in k)
        wkv_n = sum(c for k, (_, c) in by_name.items() if "wkv6" in k)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
        out[name] = {"wall_s": wall, "device_busy_s": busy_s,
                     "device_idle_share": 1 - busy_s / wall,
                     "wkv6_us": wkv_us, "wkv6_launches": wkv_n,
                     "wkv6_share_of_device": wkv_us * 1e-6 / busy_s,
                     "device_top": [{"name": k[:80], "us": us, "count": c}
                                    for k, (us, c) in top]}
    assert out["prefill"]["wkv6_launches"] == cfg.num_layers, out["prefill"]
    assert out["decode_8_steps"]["wkv6_launches"] == 0
    emit("serve_trace", **out)


# --- the zamba2 serve (models/mamba2 -> kernels/ssd, kernels/flash_attention) ------------


def bound(nbytes: int, ops: int, dtype: str) -> dict:
    """The least time the card could take: the bytes at the HBM rate, or
    the operations at the peak rate of their type (the tensor cores' bf16
    rate for bf16 inputs, the CUDA cores' float32 rate for float32)."""
    rate = BF16_TENSOR_OPS_PER_S if dtype == "bfloat16" else CUDA_CORE_OPS_PER_S
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / rate * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "peak_ops_per_s": rate}


def ssd_work(b, S, H, P, N, C, esize):
    """(bytes, operations) of one SSD scan: each input read once (x, B, C
    in their dtype; dt, A_log, D and the state in f32), each output written
    once (y and the state in f32); the operations of csrc/ssd.cu's header,
    counting only the C(C+1)/2 pairs s <= t of the C x C products, a
    multiply-add's two halves and an exp one operation each. B and C are
    shared by the heads, so the products C_t . B_s are counted once per
    (batch, chunk), everything else once per (batch, head, chunk)."""
    pairs = C * (C + 1) // 2
    shared = 2 * pairs * N                   # C_t . B_s
    per_head = (2 * C                        # dt * A, cumsum
                + 6 * pairs                  # sub, clip, exp, two products
                + 2 * pairs * P              # M x
                + 4 * C                      # exp(Li), the state's weights
                + 2 * C * N * P + 4 * C * P  # exp(Li) (h C_t), D x, sums
                + C * P + 2 * C * P * N + 2 * P * N)  # the state update
    nbytes = ((b * S * H * P + 2 * b * S * N) * esize + b * S * H * 4
              + 2 * H * 4 + b * S * H * P * 4 + 2 * b * H * P * N * 4)
    return nbytes, b * (S // C) * (shared + H * per_head)


def flash_work(B, Sq, Skv, Hq, Hkv, D, causal, window, softcap, esize):
    """(bytes, operations) of one attention forward: q, k, v read once and
    o written once in their dtype; for every admissible (query, key) pair,
    the two D-long products and five operations of the online softmax
    (scale, max, subtract, exp, sum), two more under a softcap."""
    i = np.arange(Sq)
    hi = np.minimum(i, Skv - 1) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(Sq, int)
    pairs = int(np.maximum(hi - lo + 1, 0).sum())
    ops = B * Hq * pairs * (4 * D + 5 + (2 if softcap > 0 else 0))
    nbytes = (2 * B * Sq * Hq * D + 2 * B * Skv * Hkv * D) * esize
    return nbytes, ops


def ptxas_lines(name: str) -> list:
    from repro_torch.kernels import _build

    return [ln.strip() for ln in _build.build_log(name).splitlines()
            if any(w in ln for w in ("entry function", "registers", "spill"))]


def phase_ssd_kernel():
    """Hold the CUDA SSD scan against the plain version on the card, in
    f32 and bf16, at every shape: y and the state each within
    2e-4 x max(1, max|ref|)."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd import kernel as K
    from repro_torch.kernels.ssd import ref

    rng = np.random.default_rng(2026)
    dev = torch.device("cuda")
    rows = []
    for b, S, H, P, N, C in SSD_SHAPES:
        n = lambda *shape: rng.standard_normal(shape, dtype=np.float32)
        arrays = (n(b, S, H, P), np.logaddexp(0, n(b, S, H)).astype(np.float32),
                  n(b, S, N) * 0.5, n(b, S, N) * 0.5, n(H) * 0.3,
                  1 + 0.1 * n(H), n(b, H, P, N) * 0.1)
        big = b * S * H >= 1 << 16
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            x, Bm, Cm = (torch.from_numpy(arrays[i]).to(dev, dt)
                         for i in (0, 2, 3))
            dts, A_log, D, s0 = (torch.from_numpy(arrays[i]).to(dev)
                                 for i in (1, 4, 5, 6))
            args = (x, dts, Bm, Cm, A_log, D, s0)
            y, st = K.ssd_chunked(*args, chunk=C)
            y_ref, st_ref = ref.ssd(*args, chunk=C)
            torch.cuda.synchronize()
            errs, ok = [], True
            for got, want in ((y, y_ref), (st, st_ref)):
                err = (got - want).abs().max().item()
                ok &= err <= SSD_TOL * max(1.0, want.abs().max().item())
                errs.append(err)
            assert ok, f"ssd disagrees at {(b, S, H, P, N, C)} {dtype}: {errs}"
            ms = device_ms(lambda: K.ssd_chunked(*args, chunk=C))
            plain_ms = device_ms(lambda: ref.ssd(*args, chunk=C),
                                 count=5 if big else 20,
                                 reps=10 if big else 20)
            row = {"shape": [b, S, H, P, N, C], "dtype": dtype,
                   "max_abs_err": max(errs), "y_err": errs[0],
                   "state_err": errs[1], "within_tol": ok, "ms": ms,
                   "plain_ms": plain_ms,
                   **bound(*ssd_work(b, S, H, P, N, C, x.element_size()),
                           dtype)}
            row["share_of_bound"] = row["bound_ms"] / ms
            rows.append(row)
            emit("ssd_kernel", **row)
            del x, Bm, Cm, dts, A_log, D, s0, args, y, st, y_ref, st_ref
    emit("ssd_kernel_build", ptxas=ptxas_lines("ssd"),
         smem_bytes_serve={"bfloat16": K.smem_bytes(64, 64, 128, 2),
                           "float32": K.smem_bytes(64, 64, 128, 4)},
         blocks_per_sm_by_smem_serve={
             "bfloat16": _build.blocks_per_sm(K.smem_bytes(64, 64, 128, 2)),
             "float32": _build.blocks_per_sm(K.smem_bytes(64, 64, 128, 4))})
    torch.cuda.empty_cache()
    return rows


def phase_flash_attention_kernel():
    """Hold the CUDA flash attention against the plain version on the card,
    in f32 and bf16, at every case: |got - want| <= tol + tol |want|, tol
    2e-5 in f32 and 2e-2 in bf16. Where one PyTorch call computes the same
    function (no window, no softcap), time scaled_dot_product_attention on
    the same inputs as the library's yardstick."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ref

    rng = np.random.default_rng(2027)
    dev = torch.device("cuda")
    rows = []
    for case in FLASH_CASES:
        B, Sq, Skv, Hq, Hkv, D, causal, window, softcap = case
        arrays = [rng.standard_normal(s, dtype=np.float32) for s in
                  ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D))]
        kw = {"causal": causal, "window": window, "softcap": softcap}
        for dtype in ("float32", "bfloat16"):
            q, k, v = (torch.from_numpy(a).to(dev, getattr(torch, dtype))
                       for a in arrays)
            out = K.flash_attention_fwd(q, k, v, **kw)
            want = ref.attention(q, k, v, **kw)
            torch.cuda.synchronize()
            tol = FLASH_TOL[dtype]
            diff = (out.float() - want.float()).abs()
            ok = bool((diff <= tol + tol * want.float().abs()).all())
            err = diff.max().item()
            assert out.dtype == q.dtype and ok, \
                f"flash attention disagrees at {case} {dtype}: {err}"
            ms = device_ms(lambda: K.flash_attention_fwd(q, k, v, **kw))
            plain_ms = device_ms(lambda: ref.attention(q, k, v, **kw),
                                 count=5, reps=10)
            library_ms = lib_err = None
            if window == 0 and softcap == 0:
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

                def sdpa():
                    return F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal, enable_gqa=Hq != Hkv)
                lib_err = (sdpa().transpose(1, 2).float()
                           - want.float()).abs().max().item()
                library_ms = device_ms(sdpa)
            row = {"case": list(case), "dtype": dtype, "max_abs_err": err,
                   "within_tol": ok, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, "library_max_abs_err": lib_err,
                   **bound(*flash_work(*case, q.element_size()), dtype)}
            row["share_of_bound"] = row["bound_ms"] / ms
            rows.append(row)
            emit("flash_attention_kernel", **row)
            del q, k, v, out, want, diff
    emit("flash_attention_kernel_build", ptxas=ptxas_lines("flash_attention"),
         smem_bytes_d112={"bfloat16": K.smem_bytes(112, 2),
                          "float32": K.smem_bytes(112, 4)},
         blocks_per_sm_by_smem_d112={
             "bfloat16": _build.blocks_per_sm(K.smem_bytes(112, 2)),
             "float32": _build.blocks_per_sm(K.smem_bytes(112, 4))})
    torch.cuda.empty_cache()
    return rows


def _kernel_counts():
    from repro_torch.kernels.blockhash import kernel as BH
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.kernels.ssd import kernel as SSD
    from repro_torch.kernels.wkv6 import kernel as WKV

    return {"blockhash": BH, "wkv6": WKV, "ssd": SSD, "flash_attention": FA}


def zamba2_trace(cfg, run, prm, tokens) -> dict:
    """Where the time goes in the zamba2 serve: one prefill, then 8 decode
    steps, each under ``torch.profiler``; the device's busy time is the sum
    of its kernels' and copies' own times, and the ssd and flash kernels'
    time and launches are read from it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.launch import serve
    from repro_torch.serve.step import make_decode_step, make_prefill_step

    ctx = ShardingCtx.null()
    prefill = make_prefill_step(cfg, run, ctx)
    decode = make_decode_step(cfg, run, ctx)
    prompt = tokens.shape[1]
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof_p:
        t0 = time.perf_counter()
        tok, cache = prefill(prm, {"tokens": tokens})
        tok.cpu()
        prefill_wall = time.perf_counter() - t0
    cache = serve.pad_cache(cfg, cache, 8)
    with profile(activities=acts) as prof_d:
        t0 = time.perf_counter()
        for i in range(8):
            tok, cache = decode(prm, cache, {"tokens": tok[:, None],
                                             "pos": prompt + i})
            tok.cpu()
        decode_wall = time.perf_counter() - t0
    del cache
    trace = {}
    for name, prof, wall in (("prefill", prof_p, prefill_wall),
                             ("decode_8_steps", prof_d, decode_wall)):
        by_name = _device_window(prof)
        busy_s = sum(us for us, _ in by_name.values()) * 1e-6
        assert busy_s > 0, f"the profiler saw no device time in {name}"
        part = {"wall_s": wall, "device_busy_s": busy_s,
                "device_idle_share": 1 - busy_s / wall}
        for kname, key in (("ssd", "ssd_kernel"), ("flash", "flash_fwd")):
            us = sum(u for k, (u, _) in by_name.items() if key in k)
            part[f"{kname}_us"] = us
            part[f"{kname}_launches"] = sum(
                c for k, (_, c) in by_name.items() if key in k)
            part[f"{kname}_share_of_device"] = us * 1e-6 / busy_s
        kinds = {}
        for k, (us, c) in by_name.items():
            kind = kinds.setdefault(_kernel_kind(k), {"us": 0.0, "count": 0})
            kind["us"] += us
            kind["count"] += c
        part["device_by_kind"] = kinds
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
        part["device_top"] = [{"name": k[:80], "us": us, "count": c}
                              for k, (us, c) in top]
        trace[name] = part
    return trace


def phase_serve_zamba2():
    """The model path: zamba2-7b at full width and depth in bf16, seeded
    random weights on the card, batch 4, a 1024-token prompt and 32 greedy
    tokens through launch/serve.generate, with every kernel count set to 0
    just before and read just after, and the ssd and flash counts read
    after the prefill and after each decode step. Then generate again (the
    same ids), how far the KV cache's length alone moves the bf16 logits, a
    1000-token prefill (both kernels at lengths no block divides), the
    same prefill through the plain versions, in bf16 and in f32, the smoke
    config on the card against the CPU path (which the CPU tests hold to
    the reference), and a profiled prefill and 8 decode steps."""
    import functools

    import torch

    from repro_torch.configs import registry
    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.launch import serve
    from repro_torch.models import lm, params as P
    from repro_torch.serve.step import make_decode_step, make_prefill_step

    kernels = _kernel_counts()
    SSD, FA = kernels["ssd"], kernels["flash_attention"]
    bundle = registry.get(ZAMBA["arch"])
    cfg, run = bundle.model, bundle.run
    ctx = ShardingCtx.null()
    dev = torch.device("cuda")
    B, prompt, gen = ZAMBA["batch"], ZAMBA["prompt"], ZAMBA["gen"]
    napp = cfg.num_layers // cfg.shared_attn_every

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(0)
    prm = P.materialize(lm.param_specs(cfg), g, dev, dtype=run.compute_dtype)
    tokens = torch.randint(0, cfg.vocab_size, (B, prompt), generator=g,
                           device=dev, dtype=torch.int32)
    torch.cuda.synchronize()
    materialize_s = time.perf_counter() - t0
    leaves = list(P.leaves(prm))
    n_params = sum(t.numel() for t in leaves)
    assert n_params == 6_751_130_832, n_params
    assert (cfg.num_layers, cfg.d_model, cfg.head_dim, napp) == (81, 3584, 112, 13)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)

    # the main path: serve.generate (prefill, the KV cache padded for
    # generation, greedy decode), with every count set to 0 just before
    # and read just after
    torch.cuda.reset_peak_memory_stats()
    for mod in kernels.values():
        mod.reset_launches()
    ids, times = serve.generate(cfg, run, prm, tokens, gen)
    main_launches = {name: mod.launches() for name, mod in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    assert main_launches == {"blockhash": 0, "wkv6": 0, "ssd": cfg.num_layers,
                             "flash_attention": napp}, main_launches
    assert ids.shape == (B, gen) and ((0 <= ids) & (ids < cfg.vocab_size)).all()

    # the same steps one at a time, with the ssd and flash counts read
    # after the prefill and after each decode step: the same greedy ids
    prefill = make_prefill_step(cfg, run, ctx)
    decode = make_decode_step(cfg, run, ctx)
    l0 = (SSD.launches(), FA.launches())
    tok, cache = prefill(prm, {"tokens": tokens})
    cache = serve.pad_cache(cfg, cache, gen)
    step_ids = [tok.cpu()]
    prefill_launches = (SSD.launches() - l0[0], FA.launches() - l0[1])
    step_launches = []
    for i in range(gen - 1):
        l0 = (SSD.launches(), FA.launches())
        tok, cache = decode(prm, cache, {"tokens": tok[:, None],
                                         "pos": prompt + i})
        step_ids.append(tok.cpu())
        step_launches.append((SSD.launches() - l0[0], FA.launches() - l0[1]))
    del cache
    assert prefill_launches == (cfg.num_layers, napp), prefill_launches
    assert step_launches == [(0, 0)] * (gen - 1), step_launches
    assert (torch.stack(step_ids, dim=1).numpy() == ids).all()

    # run to run, generate gives the same ids
    ids_again, _ = serve.generate(cfg, run, prm, tokens, gen)
    assert (ids_again == ids).all(), "generate differs from run to run"

    # The KV cache's length alone moves the bf16 logits: one prefill, its
    # cache padded by 4 slots and by gen, the same tokens (generate's ids)
    # fed to both for 3 decode steps. The slots past pos weigh nothing, but
    # the products over the cache run at another length.
    with torch.inference_mode():
        _, cache = lm.prefill_fn(cfg, run, ctx, prm, {"tokens": tokens})
        short, full = (serve.pad_cache(cfg, cache, n) for n in (4, gen))
        del cache
        pad_probe = []
        for i in range(3):
            feed = {"tokens": torch.from_numpy(ids[:, i:i + 1]).to(
                dev, torch.int32), "pos": prompt + i}
            la, short = lm.decode_fn(cfg, run, ctx, prm, short, feed)
            lb, full = lm.decode_fn(cfg, run, ctx, prm, full, feed)
            assert (lb.argmax(-1).cpu().numpy() == ids[:, i + 1]).all()
            top2 = lb.float().topk(2, dim=-1).values
            pad_probe.append({
                "step": i + 1,
                "logits_max_abs_diff": (la.float() - lb.float()).abs().max().item(),
                "argmax_differs_in_rows": (la.argmax(-1) != lb.argmax(-1)
                                           ).nonzero().flatten().tolist(),
                "top2_margin_by_row": (top2[:, 0] - top2[:, 1]).tolist()})
        del short, full, la, lb

    # a prompt that no flash block and no SSD chunk divides goes through
    # both kernels all the same
    odd = ZAMBA["odd_prompt"]
    l0 = (SSD.launches(), FA.launches())
    with torch.inference_mode():
        logits_odd, _ = lm.prefill_fn(cfg, run, ctx, prm,
                                      {"tokens": tokens[:, :odd].contiguous()})
    odd_launches = (SSD.launches() - l0[0], FA.launches() - l0[1])
    assert odd_launches == (cfg.num_layers, napp), odd_launches
    assert torch.isfinite(logits_odd).all()
    del logits_odd

    def timed_prefill(params, rn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = lm.prefill_fn(cfg, rn, ctx, params, {"tokens": tokens})
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def through_ref(fn):
        """``fn()`` with ``ops.ssd`` and ``ops.flash_attention`` pointed at
        the plain versions."""
        kernel_ssd, kernel_fa = ssd_ops.ssd, fa_ops.flash_attention
        ssd_ops.ssd = functools.partial(kernel_ssd, use_kernel=False)
        fa_ops.flash_attention = functools.partial(kernel_fa, use_kernel=False)
        l0 = (SSD.launches(), FA.launches())
        try:
            out = fn()
        finally:
            ssd_ops.ssd, fa_ops.flash_attention = kernel_ssd, kernel_fa
        assert (SSD.launches(), FA.launches()) == l0, \
            "the plain prefill launched a kernel"
        return out

    def rel_by_layer(a, b):
        return [((x - y).abs().max() / y.abs().max()).item()
                for x, y in zip(a, b)]

    def logits_err(a, b):
        scale = max(1.0, b.float().abs().max().item())
        return (a.float() - b.float()).abs().max().item(), scale

    # The same bf16 prefill, warm, through the kernels and the plain
    # versions. Layer 0's scan sees identical inputs in both; from there
    # bf16 rounding of each layer's output amplifies f32 differences, so
    # the logits are held in f32 below and reported here.
    (logits, cache), prefill_s = timed_prefill(prm, run)
    (logits_ref, cache_ref), prefill_ref_s = through_ref(
        lambda: timed_prefill(prm, run))
    assert logits.shape == (B, cfg.vocab_size)
    assert torch.isfinite(logits).all() and torch.isfinite(logits_ref).all()
    ssm_rel = rel_by_layer(cache["mamba"]["ssm"], cache_ref["mamba"]["ssm"])
    assert ssm_rel[0] <= 1e-4, f"layer 0 ssm state differs: {ssm_rel[0]}"
    k_rel = rel_by_layer(cache["attn"]["k"].float(),
                         cache_ref["attn"]["k"].float())
    bf16_err, bf16_scale = logits_err(logits, logits_ref)
    first_token_repeats = bool(
        (logits.argmax(-1).cpu().numpy() == ids[:, 0]).all())
    del cache, cache_ref

    # The same prefill in f32 (the bf16 weights widened exactly; matmuls
    # in full f32, TF32 off), through the kernels and the plain versions:
    # the last-token logits within 2e-2 x max(1, max|logits|).
    assert not torch.backends.cuda.matmul.allow_tf32
    prm32 = P.tree_map(lambda t: t.float(), prm)
    run32 = run.replace(compute_dtype="float32")
    (logits32, cache32), prefill_f32_s = timed_prefill(prm32, run32)
    (logits32_ref, cache32_ref), _ = through_ref(
        lambda: timed_prefill(prm32, run32))
    ssm32_rel = rel_by_layer(cache32["mamba"]["ssm"],
                             cache32_ref["mamba"]["ssm"])
    assert ssm32_rel[0] <= 1e-4, f"layer 0 f32 ssm state: {ssm32_rel[0]}"
    f32_err, f32_scale = logits_err(logits32, logits32_ref)
    assert f32_err <= 2e-2 * f32_scale, (f32_err, f32_scale)
    bf16_vs_f32_err, _ = logits_err(logits, logits32)
    # the kernels move the bf16 logits less than bf16 itself moves them
    assert bf16_err < bf16_vs_f32_err, (bf16_err, bf16_vs_f32_err)
    del prm32, cache32, cache32_ref, logits_ref, logits32_ref
    torch.cuda.empty_cache()

    # the smoke config in f32, every leaf random, on the card (the CUDA
    # kernels) against the CPU (the plain versions); a prompt of 128 tokens
    # is a multiple of the chunk (16) and of a flash block (128), one of
    # 100 of neither
    smoke, srun = bundle.smoke, run.replace(compute_dtype="float32")
    gcpu = torch.Generator().manual_seed(1)
    sprm = P.materialize(lm.param_specs(smoke), gcpu, "cpu")
    for t in P.leaves(sprm):
        t.add_(0.1 * torch.randn(t.shape, generator=gcpu))
    sprm_dev = P.tree_map(lambda t: t.to(dev), sprm)
    smoke_err = {}
    for slen in (128, 100):
        stoks = torch.randint(0, smoke.vocab_size, (2, slen), generator=gcpu,
                              dtype=torch.int32)
        l0 = (SSD.launches(), FA.launches())
        with torch.inference_mode():
            s_cpu, _ = lm.prefill_fn(smoke, srun, ctx, sprm, {"tokens": stoks})
            s_dev, _ = lm.prefill_fn(smoke, srun, ctx, sprm_dev,
                                     {"tokens": stoks.to(dev)})
        assert (SSD.launches() - l0[0], FA.launches() - l0[1]) == (
            smoke.num_layers, smoke.num_layers // smoke.shared_attn_every)
        err = (s_dev.cpu() - s_cpu).abs().max().item()
        scale = max(1.0, s_cpu.abs().max().item())
        assert err <= 1e-4 * scale, (slen, err, scale)
        smoke_err[slen] = err

    trace = zamba2_trace(cfg, run, prm, tokens)
    assert (trace["prefill"]["ssd_launches"],
            trace["prefill"]["flash_launches"]) == (cfg.num_layers, napp)
    assert trace["decode_8_steps"]["ssd_launches"] == 0
    assert trace["decode_8_steps"]["flash_launches"] == 0

    emit("serve_zamba2", arch=cfg.name, layers=cfg.num_layers,
         d_model=cfg.d_model, shared_block_applications=napp, params=n_params,
         param_bytes=param_bytes, dtype=run.compute_dtype, batch=B,
         prompt=prompt, gen=gen, materialize_s=materialize_s,
         prefill_ms=prefill_s * 1e3, prefill_cold_ms=times["prefill_s"] * 1e3,
         prefill_ref_ms=prefill_ref_s * 1e3,
         prefill_f32_ms=prefill_f32_s * 1e3,
         decode_ms_per_token=times["decode_s_per_token"] * 1e3,
         tokens_per_s=B / times["decode_s_per_token"],
         request_tokens_per_s=B * gen / (
             times["prefill_s"] + (gen - 1) * times["decode_s_per_token"]),
         peak_memory_bytes=peak,
         ssd_launches_per_prefill=prefill_launches[0],
         flash_launches_per_prefill=prefill_launches[1],
         launches_per_decode_step=[max(n for n, _ in step_launches),
                                   max(n for _, n in step_launches)],
         main_path_launches=main_launches,
         generated_ids_row0=ids[0].tolist(),
         first_token_repeats_in_warm_prefill=first_token_repeats,
         ssm_rel_err_by_layer=ssm_rel, attn_k_rel_err_by_application=k_rel,
         logits_bf16_max_abs_err=bf16_err, logits_bf16_scale=bf16_scale,
         ssm_rel_err_by_layer_f32=ssm32_rel, logits_f32_max_abs_err=f32_err,
         logits_f32_scale=f32_scale, logits_bf16_vs_f32_err=bf16_vs_f32_err,
         smoke_card_vs_cpu_err=smoke_err, rerun_ids_equal=True,
         cache_pad_probe=pad_probe, odd_prompt=odd,
         odd_prompt_launches=list(odd_launches), trace=trace)
    return main_launches


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
    phase_build()
    rows = phase_kernel()
    main_launches, _rates = phase_bento()
    phase_trace()
    phase_other_kinds()
    phase_dedup()
    phase_parallel_drain()
    phase_recovery()
    phase_upgrade()
    phase_torch_device()
    wkv_rows = phase_wkv6_kernel()
    wkv_launches, prm, tokens = phase_serve_rwkv6()
    phase_serve_trace(prm, tokens)
    del prm, tokens  # the rwkv6 weights (the f32 copy went in its phase)
    torch.cuda.empty_cache()
    ssd_rows = phase_ssd_kernel()
    flash_rows = phase_flash_attention_kernel()
    zamba_launches = phase_serve_zamba2()

    head = next(r for r in rows if tuple(r["shape"]) == HEADLINE_SHAPE)
    wkv_head = next(r for r in wkv_rows
                    if (tuple(r["shape"]), r["dtype"]) == WKV6_HEADLINE
                    and r["regime"] == "smoke")
    ssd_head = next(r for r in ssd_rows
                    if (tuple(r["shape"]), r["dtype"]) == SSD_HEADLINE)
    flash_head = next(r for r in flash_rows
                      if (tuple(r["case"]), r["dtype"]) == FLASH_HEADLINE)
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
        "host_link_bound_ms": head["host_link_bound_ms"],
        "device_resident_ms": head["device_resident_ms"],
        "library_ms": None, "call_ms": head["call_ms"],
        "shapes": rows}, {
        "name": "wkv6", "route": "cuda",
        "source": "src/repro_torch/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/wkv6/kernel.py:72",
        "launches": wkv_launches,
        "max_abs_err": max(r["max_abs_err"] for r in wkv_rows),
        "tolerance": f"{WKV6_TOL} x max(1, max|ref|)",
        "shape": wkv_head["shape"], "dtype": wkv_head["dtype"],
        "ms": wkv_head["ms"], "plain_ms": wkv_head["plain_ms"],
        "bound_ms": wkv_head["bound_ms"], "bound_by": wkv_head["bound_by"],
        "earlier_bound_ms": wkv_head["earlier_bound_ms"],
        "library_ms": None,
        "shapes": wkv_rows}, {
        "name": "ssd", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd/kernel.py:69",
        "launches": zamba_launches["ssd"],
        "max_abs_err": max(r["max_abs_err"] for r in ssd_rows),
        "tolerance": f"{SSD_TOL} x max(1, max|ref|)",
        "shape": ssd_head["shape"], "dtype": ssd_head["dtype"],
        "ms": ssd_head["ms"], "plain_ms": ssd_head["plain_ms"],
        "bound_ms": ssd_head["bound_ms"], "bound_by": ssd_head["bound_by"],
        "library_ms": None,
        "shapes": ssd_rows}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:85",
        "launches": zamba_launches["flash_attention"],
        "max_abs_err": max(r["max_abs_err"] for r in flash_rows),
        "tolerance": {d: f"{t} + {t} |ref|" for d, t in FLASH_TOL.items()},
        "shape": flash_head["case"], "dtype": flash_head["dtype"],
        "ms": flash_head["ms"], "plain_ms": flash_head["plain_ms"],
        "bound_ms": flash_head["bound_ms"],
        "bound_by": flash_head["bound_by"],
        "library_ms": flash_head["library_ms"],
        "shapes": flash_rows}], "card": card,
        "seconds": time.perf_counter() - t_start}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
