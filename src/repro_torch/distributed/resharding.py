"""Topology-elastic reshard planning — pure index math, no devices.

A checkpoint saved on mesh A stores each leaf as a GRID of shard files;
restoring onto mesh B (halved, doubled, reshaped) must hand every target
device exactly its slice without ever materializing the full tensor. The
planner here is the deviceless core of that path: ``ShardGrid`` describes
how a leaf was cut (the manifest persists it), and ``plan_target_shard``
intersects source cells with one target index to emit ReadOps — which
source shard files to read and which sub-slices to copy where. The
checkpoint store executes plans over streamed ``read_many`` batches;
everything in this module is testable with plain numpy. It is the
port's own copy of the reference's planner, line for line: the manifests
both packages write carry the same grids.

Index convention: every index is a tuple of per-dimension ``(lo, hi)``
half-open int pairs — scalars use the empty tuple. ``slice``-based index
maps (``MeshSharding.devices_indices_map``) normalize through
:func:`normalize_index` (slices are not even hashable, so the normalized
form doubles as a grouping key).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

Slice1D = Tuple[int, int]                 # [lo, hi)
Index = Tuple[Slice1D, ...]               # one per dim; () for scalars


def normalize_index(index, shape: Sequence[int]) -> Index:
    """Device-index-map entry (tuple of slices) -> ((lo,hi), ...).

    ``slice(None)`` / missing bounds mean the full dimension (replicated
    dims in a PartitionSpec show up this way)."""
    out = []
    for sl, dim in zip(tuple(index), tuple(shape)):
        lo = 0 if sl.start is None else int(sl.start)
        hi = dim if sl.stop is None else int(sl.stop)
        out.append((lo, hi))
    return tuple(out)


def _chunk(dim: int, cuts: int, c: int) -> Slice1D:
    """Cell ``c`` of ``dim`` split ``cuts`` ways — ceil-div tiling, as jax's
    (the last cells may be short or empty on uneven dims)."""
    step = -(-dim // cuts) if cuts else dim
    lo = min(c * step, dim)
    return (lo, min(lo + step, dim))


@dataclasses.dataclass(frozen=True)
class ShardGrid:
    """How one leaf is cut into shard files.

    ``spec`` is the normalized PartitionSpec: one tuple of mesh-axis names
    per dimension (empty = replicated/uncut). ``axes`` carries the sizes
    of every axis the spec references, so the grid is self-contained —
    restoring needs no source Mesh object, just the manifest."""

    shape: Tuple[int, ...]
    spec: Tuple[Tuple[str, ...], ...]
    axes: Tuple[Tuple[str, int], ...]

    @staticmethod
    def trivial(shape: Sequence[int]) -> "ShardGrid":
        shape = tuple(int(d) for d in shape)
        return ShardGrid(shape, tuple(() for _ in shape), ())

    @staticmethod
    def from_spec(shape: Sequence[int], spec, axis_sizes: Dict[str, int]
                  ) -> "ShardGrid":
        """Build from a PartitionSpec-like (entries: None | str | tuple of
        str, trailing Nones implied) + mesh axis sizes."""
        shape = tuple(int(d) for d in shape)
        entries = list(tuple(spec))
        entries += [None] * (len(shape) - len(entries))
        norm = []
        used = []
        for e in entries[:len(shape)]:
            if e is None:
                norm.append(())
            else:
                names = (e,) if isinstance(e, str) else tuple(e)
                norm.append(names)
                used.extend(names)
        axes = tuple(sorted((a, int(axis_sizes[a])) for a in set(used)))
        return ShardGrid(shape, tuple(norm), axes)

    @staticmethod
    def from_sharding(shape: Sequence[int], sharding) -> "ShardGrid":
        """Build from a sharding with ``.mesh.axis_names``,
        ``.mesh.devices.shape`` and ``.spec`` — the port's
        ``MeshSharding`` (save-time entry point)."""
        mesh = sharding.mesh
        sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
        return ShardGrid.from_spec(shape, tuple(sharding.spec), sizes)

    # -- grid geometry -------------------------------------------------

    # cached: the grid is frozen, and save/restore walk these per shard
    @functools.cached_property
    def axis_sizes(self) -> Dict[str, int]:
        return dict(self.axes)

    @functools.cached_property
    def grid(self) -> Tuple[int, ...]:
        """Cuts per dimension (product of the spec'd axis sizes)."""
        sizes = self.axis_sizes
        out = []
        for names in self.spec:
            n = 1
            for a in names:
                n *= sizes[a]
            out.append(n)
        return tuple(out)

    @property
    def n_shards(self) -> int:
        n = 1
        for c in self.grid:
            n *= c
        return n

    def coords(self, j: int) -> Tuple[int, ...]:
        """Shard ``j`` (row-major over the grid) -> per-dim cell coords."""
        out = []
        for cuts in reversed(self.grid):
            out.append(j % cuts)
            j //= cuts
        return tuple(reversed(out))

    def index(self, j: int) -> Index:
        return tuple(_chunk(d, cuts, c) for d, cuts, c in
                     zip(self.shape, self.grid, self.coords(j)))

    def indices(self) -> List[Index]:
        return [self.index(j) for j in range(self.n_shards)]

    # -- manifest round-trip -------------------------------------------

    def to_manifest(self) -> Dict:
        return {"spec": [list(names) for names in self.spec],
                "axes": {a: n for a, n in self.axes}}

    @staticmethod
    def from_manifest(shape: Sequence[int], rec: Dict) -> "ShardGrid":
        return ShardGrid(
            tuple(int(d) for d in shape),
            tuple(tuple(names) for names in rec.get("spec", [])) or
            tuple(() for _ in shape),
            tuple(sorted((a, int(n)) for a, n in
                         rec.get("axes", {}).items())))


@dataclasses.dataclass(frozen=True)
class ReadOp:
    """Copy ``src_slice`` of source shard ``src`` into ``dst_slice`` of
    the target shard's local buffer (both slices are shard-local)."""

    src: int
    src_slice: Index
    dst_slice: Index

    def volume(self) -> int:
        n = 1
        for lo, hi in self.dst_slice:
            n *= hi - lo
        return n


def plan_target_shard(src_indices: Sequence[Index], dst_index: Index
                      ) -> List[ReadOp]:
    """Intersect every source cell with one target index.

    Returns ops in source order; for scalars (empty indices) every source
    cell overlaps, so callers pass a single-cell source grid."""
    ops = []
    for j, src_index in enumerate(src_indices):
        src_loc, dst_loc, empty = [], [], False
        for (slo, shi), (dlo, dhi) in zip(src_index, dst_index):
            lo, hi = max(slo, dlo), min(shi, dhi)
            if lo >= hi:
                empty = True
                break
            src_loc.append((lo - slo, hi - slo))
            dst_loc.append((lo - dlo, hi - dlo))
        if not empty:
            ops.append(ReadOp(j, tuple(src_loc), tuple(dst_loc)))
    return ops


def plan_reshard(src_indices: Sequence[Index], dst_grid: ShardGrid
                 ) -> List[List[ReadOp]]:
    """One read plan per target shard of ``dst_grid``."""
    return [plan_target_shard(src_indices, dst_grid.index(t))
            for t in range(dst_grid.n_shards)]


def shift_ops(ops: Sequence[ReadOp], dst_index: Index) -> List[ReadOp]:
    """Rebase cell-local ``dst_slice``s to global coordinates.

    ``plan_target_shard`` emits destinations relative to the target cell;
    when a restore assembles several cells into ONE host buffer (uneven —
    non-divisible — target grids, where no per-device placement exists),
    each cell's ops shift by the cell's lower corner. Empty ops shift to
    empty ops; short last cells shift like any other."""
    return [ReadOp(op.src, op.src_slice,
                   tuple((lo + base, hi + base)
                         for (lo, hi), (base, _) in
                         zip(op.dst_slice, dst_index)))
            for op in ops]


def op_bytes(op: ReadOp, itemsize: int) -> int:
    """Destination bytes one op materializes (== the sum of its file
    runs' byte lengths: every source element lands exactly once)."""
    return op.volume() * itemsize


def chunk_ops(ops: Sequence[ReadOp], itemsize: int, budget: int,
              max_ops: int = 0) -> List[List[ReadOp]]:
    """Greedy byte-budgeted chunking of a read plan — the unit of overlap
    for the pipelined restore engine. Consecutive ops pack into one chunk
    while their combined destination bytes stay within ``budget`` (and,
    if ``max_ops`` > 0, their count within it); an op bigger than the
    whole budget travels alone, so a chunk's in-flight raw bytes exceed
    the budget only when a SINGLE op already does. Order is preserved:
    concatenating the chunks yields ``ops``."""
    chunks: List[List[ReadOp]] = []
    cur: List[ReadOp] = []
    pend = 0
    for op in ops:
        n = op_bytes(op, itemsize)
        if cur and (pend + n > budget or (max_ops and len(cur) >= max_ops)):
            chunks.append(cur)
            cur, pend = [], 0
        cur.append(op)
        pend += n
    if cur:
        chunks.append(cur)
    return chunks


def plan_volume(ops: Sequence[ReadOp]) -> int:
    return sum(op.volume() for op in ops)


def index_volume(index: Index) -> int:
    n = 1
    for lo, hi in index:
        n *= hi - lo
    return n
