"""Scalar vs batched submission through the Bento boundary, on the
PyTorch/CUDA port: the counterpart of ``examples/batched_io_demo.py``.

    PYTHONPATH=src python examples/batched_io_demo_torch.py               # the GPU
    PYTHONPATH=src python examples/batched_io_demo_torch.py --device cpu  # the host

Shows the three ways to talk to a mounted Bento file system:

1. scalar ops        — one gate-crossing, one dispatch per call (§4.3);
2. ``Mount.submit``  — a list of SubmissionEntry records crosses the
   boundary once; per-entry errors come back as errno values;
3. ``BentoQueue``    — the io_uring-style SQ/CQ wrapper: ``prep`` stages,
   ``submit`` crosses, ``drain`` collects completions in order.

The printed counters make the batching visible: gate crossings, bulk
buffer-cache passes, and journal checksum calls per flushed batch (on the
GPU each is one launch of the CUDA blockhash kernel). ``main`` returns
the counts it printed.
"""

import argparse
import time

from repro_torch.core.interface import SubmissionEntry
from repro_torch.core.registry import BentoQueue
from repro_torch.device import resolve_device
from repro_torch.fs.mounts import make_mount

N = 2048
SIZE = 4096


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    mf = make_mount("bento", n_blocks=16384, device=dev)
    v, m, ks = mf.view, mf.mount, mf.services

    data = bytes(range(256)) * (SIZE // 256)
    v.write_file("/demo", data * 1024)   # 4 MiB: larger than trivially warm
    v.fsync("/demo")
    ino = v.stat("/demo").ino
    n_off = 1024

    # --- 1. scalar: one boundary crossing per op ----------------------------
    g0 = m.gate.crossings
    t0 = time.perf_counter()
    for i in range(N):
        v.read_file("/demo", off=(i % n_off) * SIZE, size=SIZE)
    scalar_s = time.perf_counter() - t0
    scalar_crossings = m.gate.crossings - g0
    print(f"scalar : {N} reads, {scalar_crossings} gate crossings, "
          f"{N / scalar_s:,.0f} ops/s")

    # --- 2. submission batches of 256 ---------------------------------------
    BATCH = 256
    g0, b0 = m.gate.crossings, ks.counters["bread_many_calls"]
    t0 = time.perf_counter()
    n_ok = 0
    for b in range(N // BATCH):
        comps = m.submit([
            SubmissionEntry("read", (ino, ((b * BATCH + i) % n_off) * SIZE,
                                     SIZE), user_data=b * BATCH + i)
            for i in range(BATCH)])
        # tally and drop: hoarding every CompletionEntry across batches
        # costs ~40% in GC survivor pressure (why io_uring's CQ is a ring)
        n_ok += sum(1 for c in comps if c.ok)
    batched_s = time.perf_counter() - t0
    assert n_ok == N
    batched = (m.gate.crossings - g0, ks.counters["bread_many_calls"] - b0)
    print(f"batched: {N} reads, {batched[0]} gate crossings, "
          f"{batched[1]} bulk cache passes, "
          f"{N / batched_s:,.0f} ops/s  "
          f"({scalar_s / batched_s:.2f}x)")

    # --- errno isolation: a bad entry doesn't poison its neighbours ---------
    comps = m.submit([
        SubmissionEntry("read", (ino, 0, 8), user_data="good"),
        SubmissionEntry("read", (999999, 0, 8), user_data="bad"),
        SubmissionEntry("read", (ino, 8, 8), user_data="also-good"),
    ])
    mixed = [(c.user_data, "ok" if c.ok else c.errno.name) for c in comps]
    print("mixed  :", mixed)

    # --- 3. BentoQueue + one checksum call per flushed write batch ----------
    q = BentoQueue(m, depth=32)
    c0 = ks.counters["checksum_batch_calls"]
    for i in range(16):
        q.prep("write", ino, i * SIZE, b"Q" * SIZE, user_data=i)
    q.prep("flush", user_data="flush")   # commits the whole batch
    q.submit()
    done = q.drain()
    checksums = ks.counters["checksum_batch_calls"] - c0
    print(f"queue  : {len(done)} completions, {checksums} journal checksum "
          f"launch(es) for the whole write batch")

    mf.close()
    return {"scalar_crossings": scalar_crossings, "batched": batched,
            "mixed": mixed, "queue": (len(done), checksums)}


if __name__ == "__main__":
    main()
