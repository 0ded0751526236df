"""Single-controller SPMD over a mesh: the port's counterpart of
``jax.experimental.shard_map.shard_map`` and of the ``jax.lax``
collectives its callers use (``axis_index``, ``psum``, ``pmax``,
``pmean``, ``all_gather``, ``all_to_all``, ``ppermute``).

``shard_map(fn, mesh, in_specs, out_specs)(*args)`` cuts each argument by
its spec (``distributed.sharding``'s tuple ``Spec``, applied to every
leaf of the argument's tree) into one shard per mesh cell, runs ``fn``
once per cell, each cell on a thread of its own, and reassembles the
outputs by ``out_specs``: one spec an output, or, where ``fn`` returns a
tuple, a sequence of them. A replicated dim of an output is taken from
the first cell that holds it, as ``check_rep=False`` takes it. A shard
is a view of its argument when the cell's device is the argument's (the
cells of a virtual mesh share one card) and a copy on the cell's device
otherwise. A mesh axis that does not divide the dim it cuts raises, as
``shard_map`` does.

Inside ``fn`` the collectives take a mesh axis name, or a tuple of names
used jointly (row-major, the first name major), as ``jax.lax``'s do. A
collective is a rendezvous: each cell deposits its tensor, waits at a
barrier, and computes its own result from every cell's deposit with
ordinary differentiable torch ops (sums in cell order, so every cell's
copy is the same and a result repeats run to run; ``.to(device)``
between cards). Autograd thus derives the transposes JAX derives: the
gradient through ``ppermute`` is the reverse hand-off, through ``psum``
the sum of the cotangents. Every cell calls the same collectives in the
same order; a cell that calls another one, or returns while the others
wait in one, makes every cell raise. A cell that raises breaks the
barrier, and the caller re-raises its exception.

Each cell thread runs under the caller's thread-local state: grad mode,
inference mode, autocast, the current CUDA device and stream, the
caller's ``TorchDispatchMode`` stack (a ``FakeTensorMode``, and the
FLOP counter and the operator counter of ``launch.op_analysis``, which
would otherwise see none of the cells' work) and its collective observer
(``observe``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
from torch.utils._python_dispatch import (_get_current_dispatch_mode_stack,
                                          _pop_mode, _push_mode)

from repro_torch.launch.mesh import mesh_axis_sizes
from repro_torch.models import params as P

_local = threading.local()


class SpmdError(RuntimeError):
    """The cells of one ``shard_map`` call disagree on a collective."""


@dataclasses.dataclass
class _Run:
    """What the cells of one ``shard_map`` call share."""

    mesh: Any
    coords: List[Dict[str, int]]  # each cell's mesh coordinates, row-major
    barrier: threading.Barrier
    slots: List[Any]


@dataclasses.dataclass
class _Cell:
    run: _Run
    pos: int  # flat, row-major position in mesh.devices


def _coords(mesh) -> List[Dict[str, int]]:
    names, grid = tuple(mesh.axis_names), tuple(mesh.devices.shape)
    out = []
    for pos in range(mesh.devices.size):
        coord, rem = {}, pos
        for a, n in zip(reversed(names), reversed(grid)):
            coord[a] = rem % n
            rem //= n
        out.append(coord)
    return out


def _axes(axis_name) -> Tuple[str, ...]:
    return (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)


def _cell() -> _Cell:
    cell = getattr(_local, "cell", None)
    if cell is None:
        raise RuntimeError("a collective runs inside shard_map only")
    return cell


def _joint(coord: Dict[str, int], sizes: Dict[str, int], axes) -> int:
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + coord[a]
    return idx


def _group(cell: _Cell, axes: Tuple[str, ...]) -> List[int]:
    """The positions of the cells that agree with ``cell`` on every axis
    but ``axes``, in the order of their joint index over ``axes``."""
    sizes = mesh_axis_sizes(cell.run.mesh)
    for a in axes:
        if a not in sizes:
            raise ValueError(f"no mesh axis {a!r} in {tuple(sizes)}")
    mine = cell.run.coords[cell.pos]
    members = [p for p, c in enumerate(cell.run.coords)
               if all(c[a] == mine[a] for a in sizes if a not in axes)]
    return sorted(members,
                  key=lambda p: _joint(cell.run.coords[p], sizes, axes))


def _wait(run: _Run) -> None:
    try:
        run.barrier.wait()
    except threading.BrokenBarrierError:
        raise threading.BrokenBarrierError(
            "another cell of the shard_map call failed") from None


def _exchange(tag, value) -> List[Any]:
    """Deposits ``value``; returns every cell's deposit, by position."""
    cell = _cell()
    run = cell.run
    run.slots[cell.pos] = (tag, value)
    _wait(run)
    got = list(run.slots)
    _wait(run)  # every cell has read the slots: they may be reused
    tags = {t for t, _ in got}
    if len(tags) != 1:
        raise SpmdError("the cells of a shard_map call disagree on the "
                        f"collective: {sorted(map(str, tags))}")
    return [v for _, v in got]


def _to(v, device):
    return v.to(device) if isinstance(v, torch.Tensor) else v


def _device(x):
    return x.device if isinstance(x, torch.Tensor) else None


def _members(name: str, x, axis_name) -> Tuple[List[Any], int]:
    """The group's deposits over ``axis_name``, on ``x``'s device, and
    this cell's index in the group."""
    axes = _axes(axis_name)
    vals = _exchange((name, axes), x)
    cell = _cell()
    group = _group(cell, axes)
    dev = _device(x)
    return [_to(vals[p], dev) for p in group], group.index(cell.pos)


@contextlib.contextmanager
def observe(fn: Callable[[str, torch.Tensor, int, int], None]):
    """Within the block, each collective that a ``shard_map`` cell issues
    calls ``fn(op, result, group_size, cell)``: ``op`` the reference HLO's
    name of it (``all-reduce``, ``all-gather``, ``all-to-all``,
    ``collective-permute``), ``result`` the cell's result, ``cell`` its
    flat position in the mesh. The cells of a call issue the same
    collectives in the same order."""
    prev = getattr(_local, "observer", None)
    _local.observer = fn
    try:
        yield
    finally:
        _local.observer = prev


def _noted(op: str, out, n: int):
    fn = getattr(_local, "observer", None)
    if fn is not None and isinstance(out, torch.Tensor):
        fn(op, out, n, _cell().pos)
    return out


def axis_index(axis_name) -> int:
    """This cell's index along ``axis_name`` (a name or a tuple of names:
    their row-major joint index)."""
    cell = _cell()
    sizes = mesh_axis_sizes(cell.run.mesh)
    return _joint(cell.run.coords[cell.pos], sizes, _axes(axis_name))


def _sum(vals):
    acc = vals[0]
    for v in vals[1:]:  # in cell order: every cell's copy is the same
        acc = acc + v
    return acc


def psum(x, axis_name):
    """The sum over the group (a tensor or a Python number: ``psum(1,
    axis)`` is the group's size)."""
    vals, _ = _members("psum", x, axis_name)
    return _noted("all-reduce", _sum(vals), len(vals))


def pmax(x, axis_name):
    vals, _ = _members("pmax", x, axis_name)
    if not isinstance(x, torch.Tensor):
        return max(vals)
    return _noted("all-reduce", torch.stack(vals).amax(dim=0), len(vals))


def pmean(x, axis_name):
    vals, _ = _members("pmean", x, axis_name)
    return _noted("all-reduce", _sum(vals) / len(vals), len(vals))


def all_gather(x: torch.Tensor, axis_name, *, axis: int = 0) -> torch.Tensor:
    """Every group member's ``x``, in group order, concatenated along dim
    ``axis`` (``jax.lax.all_gather``'s ``tiled=True``)."""
    vals, _ = _members("all_gather", x, axis_name)
    return _noted("all-gather", torch.cat(vals, dim=axis), len(vals))


def all_to_all(x: torch.Tensor, axis_name, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """Index ``i`` of ``x`` along ``split_axis``, whose size is the
    group's, goes to group member ``i``; each member's result holds what
    it received, by source, stacked at ``concat_axis`` with
    ``split_axis`` dropped (``jax.lax.all_to_all``'s ``tiled=False``)."""
    vals, me = _members("all_to_all", x, axis_name)
    n = len(vals)
    if x.shape[split_axis] != n:
        raise ValueError(f"all_to_all needs dim {split_axis} of "
                         f"{tuple(x.shape)} to be the group's {n}")
    return _noted("all-to-all", torch.stack(
        [v.select(split_axis, me) for v in vals], dim=concat_axis), n)


def ppermute(x: torch.Tensor, axis_name, perm: Sequence[Tuple[int, int]]
             ) -> torch.Tensor:
    """``x`` of group member ``src`` handed to member ``dst`` for each
    ``(src, dst)`` of ``perm``; a member no pair sends to gets zeros."""
    vals, me = _members("ppermute", x, axis_name)
    src = [s for s, d in perm if d == me]
    if len(src) > 1 or len({d for _, d in perm}) != len(perm):
        raise ValueError(f"ppermute's pairs send twice to one cell: {perm}")
    return _noted("collective-permute",
                  vals[src[0]] if src else torch.zeros_like(x), len(vals))


# --- the caller's thread-local state ---------------------------------------------


def _caller_state() -> Callable[[], contextlib.ExitStack]:
    """The caller's grad mode, inference mode, autocast, current CUDA
    device and stream, dispatch modes and collective observer, as a
    factory of a context that sets them in another thread."""
    modes = _get_current_dispatch_mode_stack()
    observer = getattr(_local, "observer", None)
    inference = torch.is_inference_mode_enabled()
    grad = torch.is_grad_enabled()
    autocast = [(d, torch.get_autocast_dtype(d)) for d in ("cuda", "cpu")
                if torch.is_autocast_enabled(d)]
    stream = (torch.cuda.current_stream()
              if torch.cuda.is_available() and torch.cuda.is_initialized()
              else None)

    def enter() -> contextlib.ExitStack:
        stack = contextlib.ExitStack()
        stack.enter_context(torch.inference_mode(inference))
        stack.enter_context(torch.set_grad_enabled(grad))
        for d, dtype in autocast:
            stack.enter_context(torch.autocast(d, dtype=dtype))
        if stream is not None:
            stack.enter_context(torch.cuda.device(stream.device))
            stack.enter_context(torch.cuda.stream(stream))
        for mode in modes:  # the same objects, bottom first
            _push_mode(mode)
            stack.callback(_pop_mode)
        stack.enter_context(observe(observer))
        return stack

    return enter


# --- cutting and reassembling ----------------------------------------------------


def _entries(spec, ndim: int, sizes: Dict[str, int]) -> List[Tuple[str, ...]]:
    """A spec's mesh axes for each of ``ndim`` dims (``()`` uncut)."""
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    out, used = [], set()
    for e in list(spec) + [None] * (ndim - len(spec)):
        names = () if e is None else _axes(e)
        for a in names:
            if a not in sizes:
                raise ValueError(f"spec {spec} names no mesh axis {a!r}")
            if a in used:
                raise ValueError(f"spec {spec} uses mesh axis {a!r} twice")
            used.add(a)
        out.append(names)
    return out


def _cuts(names, sizes) -> int:
    n = 1
    for a in names:
        n *= sizes[a]
    return n


def _shard(t, spec, mesh, coords, pos: int):
    if not isinstance(t, torch.Tensor):
        return t
    sizes = mesh_axis_sizes(mesh)
    idx = []
    for dim, names in zip(t.shape, _entries(spec, t.dim(), sizes)):
        n = _cuts(names, sizes)
        if dim % n:
            raise ValueError(f"mesh axes {names} ({n} cells) do not divide "
                             f"a dim of {dim} in {tuple(t.shape)}")
        step = dim // n
        lo = _joint(coords[pos], sizes, names) * step
        idx.append(slice(lo, lo + step))
    return t[tuple(idx)].to(mesh.devices.flat[pos])


def _assemble(outs: List[Any], spec, mesh, coords):
    """One output's global tensor from the cells' shards."""
    first = outs[0]
    if not isinstance(first, torch.Tensor):
        return first
    sizes = mesh_axis_sizes(mesh)
    entries = _entries(spec, first.dim(), sizes)
    blocks = {}
    for pos, o in enumerate(outs):
        key = tuple(_joint(coords[pos], sizes, names) for names in entries)
        blocks.setdefault(key, o)
    dev = first.device

    def build(prefix):
        d = len(prefix)
        if d == len(entries):
            return blocks[prefix].to(dev)
        parts = [build(prefix + (i,)) for i in range(_cuts(entries[d], sizes))]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=d)

    return build(())


def _assemble_tree(outs: List[Any], spec, mesh, coords):
    return P.tree_map(lambda *leaves: _assemble(list(leaves), spec, mesh,
                                                coords), *outs)


def shard_map(fn: Callable, mesh, in_specs: Sequence, out_specs):
    """``fn`` run once per cell of ``mesh`` on its shards of the
    arguments; see the module's docstring."""
    n = mesh.devices.size

    def call(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"{len(args)} arguments, {len(in_specs)} specs")
        coords = _coords(mesh)
        shards = [[P.tree_map(lambda t, s=spec: _shard(t, s, mesh, coords, p),
                              arg) for arg, spec in zip(args, in_specs)]
                  for p in range(n)]
        run = _Run(mesh, coords, threading.Barrier(n), [None] * n)
        enter = _caller_state()
        results: List[Any] = [None] * n
        errors: List[BaseException] = [None] * n

        def body(pos):
            _local.cell = _Cell(run, pos)
            try:
                with enter():
                    results[pos] = fn(*shards[pos])
                    _exchange(("return",), None)
            except BaseException as e:  # re-raised in the caller below
                errors[pos] = e
                run.barrier.abort()
            finally:
                _local.cell = None

        threads = [threading.Thread(target=body, args=(p,),
                                    name=f"shard_map cell {p}")
                   for p in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        failed = [e for e in errors if e is not None]
        if failed:
            first = next((e for e in failed if not isinstance(
                e, threading.BrokenBarrierError)), failed[0])
            raise first
        if isinstance(results[0], (tuple, list)):
            if len(out_specs) != len(results[0]):
                raise ValueError(f"{len(results[0])} outputs, "
                                 f"{len(out_specs)} out_specs")
            return type(results[0])(
                _assemble_tree([r[i] for r in results], spec, mesh, coords)
                for i, spec in enumerate(out_specs))
        return _assemble_tree(results, out_specs, mesh, coords)

    return call
