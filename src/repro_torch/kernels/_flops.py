"""FLOP formulas of the kernels' operators (``repro_torch::*`` in each
``kernels/*/ops.py``), for ``torch.utils.flop_counter``.

Each operator counts the FLOPs that ``FlopCounterMode`` counts for its
plain version (``ref.py``) at the same arguments, so that a trace through
the card's path (the operator) and a trace through the plain path count
the same. The plain versions' einsums of three and four operands go to
``bmm`` along a contraction path that ``torch.einsum`` picks from the
operands' sizes (through ``opt_einsum`` where it is installed), so no
closed form matches every shape: the count is taken from the plain
version itself, run once on meta tensors (no data, no device) with every
mode of the caller switched off. For the chunked scans it runs one chunk
and multiplies: every chunk runs the same products at the same shapes.
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence, Tuple

import torch
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils.flop_counter import FlopCounterMode


@functools.lru_cache(maxsize=None)
def _meta_flops(plain: Callable, shapes: Tuple[Tuple[int, ...], ...],
                kw: Tuple[Tuple[str, object], ...]) -> int:
    with _disable_current_modes():
        args = [torch.empty(s, dtype=torch.float32, device="meta")
                for s in shapes]
        with FlopCounterMode(display=False) as counter:
            plain(*args, **dict(kw))
    return int(counter.get_total_flops())


def plain_flops(plain: Callable, shapes: Sequence[Sequence[int]],
                **kw) -> int:
    """``FlopCounterMode``'s count of ``plain(*tensors, **kw)`` on float32
    tensors of ``shapes`` (the count does not depend on the dtype)."""
    return _meta_flops(plain, tuple(tuple(int(d) for d in s) for s in shapes),
                       tuple(sorted(kw.items())))


def chunked_flops(plain: Callable, shapes: Sequence[Sequence[int]],
                  seq_dims: Sequence[int], chunk: int, **kw) -> int:
    """``plain_flops`` of a chunked scan: one chunk's count times the
    number of chunks. ``seq_dims[i]`` is the sequence dim of ``shapes[i]``
    (-1 for an input with none, such as the state)."""
    seq = next(s[d] for s, d in zip(shapes, seq_dims) if d >= 0)
    one = [tuple(chunk if i == d else n for i, n in enumerate(s))
           for s, d in zip(shapes, seq_dims)]
    return seq // chunk * plain_flops(plain, one, chunk=chunk, **kw)
