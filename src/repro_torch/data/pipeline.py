"""Data pipeline: deterministic synthetic LM batches + FS-backed token
shards (read through the Bento file system — the storage stack is a live
substrate, not a demo), with background prefetch and straggler re-dispatch.

The port's own copy of the reference's pipeline: batches are numpy arrays
equal to the reference's, and become tensors only at the consumer
(``torch.from_numpy``).
"""

from __future__ import annotations

import io
import queue
import threading
import time
from typing import Dict, Iterator, List, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


class SyntheticLM:
    """Deterministic tokens: batch for step N is a pure function of
    (seed, N) — resume after restart replays identically (tested)."""

    def __init__(self, cfg: ModelConfig, global_batch: int, seq_len: int,
                 seed: int = 0):
        self.cfg = cfg
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.seed = seed

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        toks = rng.integers(0, self.cfg.vocab_size,
                            (self.global_batch, self.seq_len + 1), dtype=np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.family == "vlm":
            out["image_embeds"] = rng.standard_normal(
                (self.global_batch, self.cfg.num_image_tokens, self.cfg.d_model)
            ).astype(np.float32) * 0.02
        if self.cfg.family == "audio":
            out["frame_embeds"] = rng.standard_normal(
                (self.global_batch, self.cfg.encoder_seq, self.cfg.d_model)
            ).astype(np.float32) * 0.02
        return out


# --- FS-backed shards ---------------------------------------------------------------


def write_shards(view, dataset: SyntheticLM, n_shards: int, root="/data") -> None:
    """Materialize token shards into a Bento fs (one file per shard)."""
    view.makedirs(root)
    for i in range(n_shards):
        b = dataset.batch(i)
        buf = io.BytesIO()
        np.savez(buf, **b)
        view.write_file(f"{root}/shard_{i:05d}.npz", buf.getvalue())
    view.fsync(f"{root}/shard_{n_shards-1:05d}.npz")


class FsShardReader:
    """Reads shards through the Bento FS; failed/slow reads are re-dispatched
    (straggler mitigation at the data tier)."""

    def __init__(self, view, root="/data", timeout_s: float = 5.0,
                 max_retries: int = 3):
        self.view = view
        self.root = root
        self.timeout_s = timeout_s
        self.max_retries = max_retries
        self.shards = sorted(view.listdir(root))
        self.retries = 0

    def read(self, idx: int) -> Dict[str, np.ndarray]:
        name = self.shards[idx % len(self.shards)]
        last_err: Optional[Exception] = None
        for _attempt in range(self.max_retries):
            try:
                raw = self._read_deadline(f"{self.root}/{name}")
                with np.load(io.BytesIO(raw)) as z:
                    return {k: z[k] for k in z.files}
            except Exception as e:  # noqa: BLE001 — retry path
                last_err = e
                self.retries += 1
        raise RuntimeError(f"shard {name} unreadable after retries: {last_err}")

    def _read_deadline(self, path: str) -> bytes:
        box: List = []

        def work():
            box.append(self.view.read_file(path))

        t = threading.Thread(target=work, daemon=True)
        t.start()
        t.join(self.timeout_s)
        if not box:
            raise TimeoutError(f"straggling read: {path}")
        return box[0]


class Prefetcher:
    """Background-thread prefetch queue over any step->batch function."""

    def __init__(self, fetch, start_step: int = 0, depth: int = 2):
        self.fetch = fetch
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        s = self.step
        while not self._stop:
            try:
                item = (s, self.fetch(s))
            except Exception as e:  # noqa: BLE001
                item = (s, e)
            self.q.put(item)
            s += 1

    def next(self):
        s, item = self.q.get()
        if isinstance(item, Exception):
            raise item
        return s, item

    def close(self):
        self._stop = True
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
