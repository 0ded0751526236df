"""The paper's headline demo on the PyTorch/CUDA port: hot-swap FILE
PROVENANCE onto a running file system (§6) with a measured service
interruption, strip it again, and hot-swap a trainer module mid-run
(§4.8) — the same quiesce -> extract -> migrate -> restore protocol every
time. The counterpart of ``examples/online_upgrade_demo.py``.

    PYTHONPATH=src python examples/online_upgrade_demo_torch.py               # the GPU
    PYTHONPATH=src python examples/online_upgrade_demo_torch.py --device cpu  # the host

Exits nonzero if any claim fails, printing the failed check instead of a
bare traceback.
"""

import argparse
import sys
import threading
import time

from repro_torch.configs import registry
from repro_torch.core.upgrade import transfer_state, unwrap_layer, wrap_layer
from repro_torch.device import resolve_device
from repro_torch.fs.mounts import make_mount
from repro_torch.fs.prov import ProvFilesystem
from repro_torch.train.trainer import Trainer


def prov_hot_swap_under_load(dev):
    print("== 1. hot-swap file provenance onto a live mount (paper §6) ==")
    mf = make_mount("bento", n_blocks=16384, device=dev)
    v = mf.view
    v.makedirs("/w")
    stop = threading.Event()
    ops = {"n": 0, "errors": 0}

    def workload():
        i = 0
        while not stop.is_set():
            try:
                v.write_file(f"/w/f{i % 32}", b"payload" * 512)
                v.read_file(f"/w/f{i % 32}")
                ops["n"] += 2
            except Exception:  # noqa: BLE001 — counted, and checked below
                ops["errors"] += 1
            i += 1

    t = threading.Thread(target=workload, daemon=True)
    t.start()
    time.sleep(0.4)

    wrap = wrap_layer(mf.mount, ProvFilesystem)      # plain -> prov, live
    print(f"  provenance ON : pause {wrap['total_s']*1e3:6.2f} ms "
          f"(quiesce {wrap['quiesce_s']*1e3:.2f} ms) — paper's demo: ~15 ms")
    time.sleep(0.4)
    recs = v.read_provenance()
    sample = [(r["op"], r["name"] or r["ino"]) for r in recs[:3]]
    print(f"  {len(recs)} provenance records so far, e.g. {sample}")

    unwrap = unwrap_layer(mf.mount)                  # prov -> plain, live
    print(f"  provenance OFF: pause {unwrap['total_s']*1e3:6.2f} ms "
          f"(log stays durable for the next wrap)")
    time.sleep(0.2)
    stop.set()
    t.join(5)
    print(f"  {ops['n']} ops during swaps, {ops['errors']} failures")
    assert not t.is_alive(), "the workload did not stop"
    assert ops["errors"] == 0, "a workload op failed during a swap"
    assert ops["n"] > 0, "the workload never ran"
    assert recs, "no provenance records were captured under load"
    assert all(r["op"] in ("create", "write") for r in recs), \
        "unexpected record op in the workload window"
    mf.close()


def trainer_module_upgrade(dev):
    print("== 2. trainer hot-swap (optimizer hyper-upgrade mid-run) ==")
    b = registry.get("smollm-135m")
    run_v1 = b.run.replace(microbatch_per_data_shard=0, learning_rate=3e-4)
    t1 = Trainer(b.smoke, run_v1, global_batch=4, seq_len=32, device=dev)
    t1.train(5)
    print(f"  v1 @ step {t1.step_idx}: loss {t1.metrics_log[-1]['loss']:.4f}")

    # "new release": higher LR schedule — new Trainer, transferred state
    run_v2 = run_v1.replace(learning_rate=1e-3)
    t2 = Trainer(b.smoke, run_v2, global_batch=4, seq_len=32, device=dev)
    t2.VERSION = 2
    transfer_state(t1, t2)  # quiesce/extract/restore — moments preserved
    assert t2.step_idx == 5
    t2.train(10)
    print(f"  v2 @ step {t2.step_idx}: loss {t2.metrics_log[-1]['loss']:.4f} "
          "(optimizer moments survived the swap)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    try:
        prov_hot_swap_under_load(dev)
        trainer_module_upgrade(dev)
    except AssertionError as e:
        print(f"DEMO FAILED: {e}", file=sys.stderr)
        return 1
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
