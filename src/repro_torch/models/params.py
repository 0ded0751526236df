"""Declarative parameter specs, and the tensors made from them.

Each model family declares its parameters once, as a tree (nested dicts) of
``TensorSpec`` with the reference's key paths, shapes, logical axes and
initialisers. From it the port derives:

  * parameters drawn on the target device (``materialize``);
  * the reference's parameters or decode state carried across
    (``from_reference``), key path for key path;
  * exact parameter counts (``count_params``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros | ones | embed
    scale: float = 1.0
    dtype: Optional[str] = None  # None -> the caller's dtype

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} and logical axes "
                             f"{self.logical} differ in rank")


def is_spec(x: Any) -> bool:
    return isinstance(x, TensorSpec)


def tree_map(fn: Callable[[Any], Any], tree):
    """``fn`` applied to every leaf of a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def leaves(tree):
    """The leaves of a tree of nested dicts, in key order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


def layer(tree, i: int):
    """Layer ``i`` of a tree of stacked ``(L, ...)`` tensors (views)."""
    return tree_map(lambda t: t[i], tree)


def stack_layers(trees):
    """Per-layer trees stacked back into one tree of ``(L, ...)`` tensors."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_layers([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def map_specs(fn: Callable[[TensorSpec], Any], tree):
    """``fn`` applied to every spec of a spec tree."""
    def check(spec):
        if not is_spec(spec):
            raise TypeError(f"not a spec tree leaf: {spec!r}")
        return fn(spec)
    return tree_map(check, tree)


def count_params(tree) -> int:
    return int(sum(math.prod(s.shape) for s in leaves(tree)))


def dense(shape: Sequence[int], logical: Sequence[Optional[str]], *, scale=1.0,
          dtype: Optional[str] = None, init="normal") -> TensorSpec:
    return TensorSpec(tuple(shape), tuple(logical), init=init, scale=scale,
                      dtype=dtype)


def stacked(n_layers: int, spec: TensorSpec) -> TensorSpec:
    """Prepend the stacked ``layers`` axis."""
    return TensorSpec((n_layers,) + spec.shape, ("layers",) + spec.logical,
                      init=spec.init, scale=spec.scale, dtype=spec.dtype)


def stack_tree(n_layers: int, tree):
    return map_specs(lambda s: stacked(n_layers, s), tree)


def torch_dtype(name) -> torch.dtype:
    """``"bfloat16"``, ``"float32"``, ... (or a torch dtype) as a torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def materialize(tree, generator: torch.Generator, device: DeviceLike = None,
                dtype="float32") -> Dict:
    """Draw real parameters from the specs, leaf by leaf, on ``device``.

    The reference's init rules (``repro/models/params.py:46-63``): zeros,
    ones, or a normal draw times ``scale / sqrt(fan_in)``, with fan_in the
    last axis for ``embed`` and the second to last otherwise. Each leaf is
    drawn in float32 on the device from ``generator`` (which must live on
    that device) and cast to its dtype there, so a 15 GB model never passes
    through the host. Leaves are drawn in key order, so one seed gives one
    tree; the numbers differ from ``jax.random``'s."""
    dev = resolve_device(device)

    def draw(spec: TensorSpec) -> torch.Tensor:
        dt = torch_dtype(spec.dtype or dtype)
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dt, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt, device=dev)
        fan_in = spec.shape[-1] if spec.init == "embed" else (
            spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1])
        std = spec.scale / math.sqrt(max(fan_in, 1))
        x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return x.mul_(std).to(dt)

    return map_specs(draw, tree)


def _tensor(a, dev: torch.device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # torch tensors share memory with the array
        a = a.copy()
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carry the bits
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=dev, dtype=dtype or t.dtype)


def from_reference(np_tree, device: DeviceLike = None, dtype=None) -> Dict:
    """The reference's parameter or state tree (nested dicts of numpy
    arrays, stacked ``(L, ...)`` leaves as they are) as the port's tree on
    ``device``, key path for key path. ``dtype`` casts every leaf; left
    unset, each leaf keeps its own (bfloat16 included, bit for bit)."""
    dev = resolve_device(device)
    dt = None if dtype is None else torch_dtype(dtype)
    return tree_map(lambda a: _tensor(a, dev, dt), np_tree)
