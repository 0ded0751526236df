"""Grouped loop over layers with two-level rematerialization.

The counterpart of ``repro/models/scan_utils.py``. The reference's
``lax.scan`` over stacked ``(L, ...)`` parameters is a loop over the layer
index here. With remat each layer runs under
``torch.utils.checkpoint.checkpoint``: its activations are dropped after
the forward and recomputed in the backward. Grouping into chunks of
``group`` layers with checkpoints at both levels stores O(L/G + G)
residual-stream slices instead of O(L). In a cell of the partitioned
training step the dense and MoE stacks loop over their layers on a
``distributed.tensor_parallel.Tape`` instead
(``models.transformer.stack_segments``): each layer's halves are
segments, rematerialised one by one, and the tape stores every
segment's inputs; grouped remat is not reproduced there.
"""

from __future__ import annotations

from torch.utils.checkpoint import checkpoint

from repro_torch.models import params as P


def _stack(ys):
    """Per-layer outputs (tensors or dicts of them) stacked along a new
    leading axis, as ``lax.scan`` returns them; None when there are none."""
    return None if ys[0] is None else P.stack_layers(ys)


def _loop(body, carry, xs_tree, n: int, remat: bool):
    ys = []
    for i in range(n):
        x = P.layer(xs_tree, i)
        if remat:
            carry, y = checkpoint(body, carry, x, use_reentrant=False)
        else:
            carry, y = body(carry, x)
        ys.append(y)
    return carry, ys


def grouped_scan(body, carry, xs_tree, n: int, group: int, remat: bool):
    """``body`` over the leading axis ``n`` of ``xs_tree``, optionally in
    groups of ``group``.

    body: (carry, x_slice) -> (carry, y_slice | None). Returns (carry, ys),
    ys stacked along a new leading axis (None when body returns None)."""
    if group <= 1 or n % group != 0:
        carry, ys = _loop(body, carry, xs_tree, n, remat)
        return carry, _stack(ys)

    def outer(c, xg):
        return _loop(body, c, xg, group, remat)

    ys = []
    for j in range(n // group):
        xg = P.tree_map(lambda t: t[j * group:(j + 1) * group], xs_tree)
        if remat:
            carry, yg = checkpoint(outer, carry, xg, use_reentrant=False)
        else:
            carry, yg = outer(carry, xg)
        ys.extend(yg)
    return carry, _stack(ys)
