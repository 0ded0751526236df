"""Named ranges of the port's hot paths: the kernels' recompute backwards
(``kernels/_autograd.py``) and the MoE layer's parts (``models/moe.py``).

Each range is a ``torch.profiler.record_function`` range, which a profiler
trace shows. While a ``timed`` block is open, the ranges it names are also
timed, one mark at each range's start and end: on a CUDA device an event
recorded on the current stream (so a range reads its span on the stream,
idle included, not the sum of its kernels' times), on the CPU the host
clock. With no ``timed`` block open a range records nothing more than the
profiler's.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterable

import torch

_open = []  # the open ``timed`` blocks: (names, device, {name: [(a, b)]})


def _mark(device: torch.device):
    if device.type == "cuda":
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event
    return time.perf_counter()


@contextlib.contextmanager
def named(name: str):
    """The range ``name``: a profiler range, marked for every open
    ``timed`` block that names it."""
    with torch.profiler.record_function(name):
        blocks = [(dev, marks) for names, dev, marks in _open
                  if name in names]
        starts = [_mark(dev) for dev, _ in blocks]
        try:
            yield
        finally:
            for (dev, marks), start in zip(blocks, starts):
                marks.setdefault(name, []).append((start, _mark(dev)))


@contextlib.contextmanager
def timed(names: Iterable[str], device) -> Dict[str, dict]:
    """Times the ranges in ``names`` while open, on ``device``. Yields a
    dict that on exit (after a synchronise, on a CUDA device) maps each
    name that ran to its ``calls`` and the microseconds they spanned,
    ``span_us``."""
    device = torch.device(device)
    marks = {}
    block = (frozenset(names), device, marks)
    result = {}
    _open.append(block)
    try:
        yield result
    finally:
        _open.remove(block)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        for name, pairs in marks.items():
            if device.type == "cuda":
                us = sum(a.elapsed_time(b) for a, b in pairs) * 1e3
            else:
                us = sum(b - a for a, b in pairs) * 1e6
            result[name] = {"calls": len(pairs), "span_us": us}
