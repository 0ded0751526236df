"""Logical-axis sharding rules (MaxText-style), the port's own copy.

Model code annotates tensors with *logical* axis names; a ruleset maps each
logical axis to an ordered preference list of mesh axes. Resolution is
divisibility-aware and never assigns one mesh axis twice within a spec, so a
single model codebase supports many sharding strategies — the rulesets are
the reference's, entry for entry.

The reference's ``PartitionSpec`` is a plain tuple here (entries ``None``,
a mesh-axis name, or a tuple of names used jointly; trailing ``None``s
trimmed), and its ``NamedSharding`` is :class:`MeshSharding`, whose index
maps follow the same tiling. Logical axes used across the codebase:

  batch        global batch                     -> data (+pod)
  seq          sequence (activations)           -> None (baseline) / model (SP)
  embed        d_model features                 -> None (baseline)
  heads        query heads                      -> model
  kv_heads     kv heads                         -> model (when divisible)
  head_dim     per-head features                -> None
  mlp          feed-forward hidden              -> model
  vocab        vocabulary                       -> model
  experts      MoE expert count                 -> model (expert parallelism)
  expert_mlp   per-expert hidden                -> None
  capacity     MoE per-expert capacity          -> None
  cache_seq    KV-cache sequence                -> model (decode baseline)
  cache_batch  KV-cache batch                   -> data
  layers       stacked-scan leading axis        -> None (never sharded)
  fsdp         weight dim chosen for ZeRO shard -> data (+pod)
  conv_k       conv kernel taps                 -> None
  state        SSM state                        -> None
  img_seq      image/encoder token axis         -> None

A tensor laid out over a mesh is a :class:`MeshArray`, the counterpart
of a ``jax.Array`` under a ``NamedSharding``: one tensor for each mesh
position, on that position's device, holding the slice its
``MeshSharding`` gives it (positions that replicate a block hold copies,
as devices do). ``place`` lays a whole tensor out (``jax.device_put``),
``MeshArray.gather`` assembles it again (``np.asarray`` of a sharded
array). A mesh over real devices puts each shard on its own card; a
virtual one (``launch.mesh.make_mesh`` over copies of one card) keeps
every shard on that card.

``constrain`` returns its tensor unchanged: the partitioned training step
(``train.step``) runs the model once in each mesh cell on that cell's
share of the batch, with its own ``model`` shard of the leaves that
``distributed.tensor_parallel`` keeps local, so an activation inside a
cell is already the cell's own.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

from repro_torch.distributed.resharding import (_chunk, normalize_index,
                                                plan_target_shard)
from repro_torch.launch.mesh import mesh_axis_sizes

Candidates = Tuple[Tuple[str, ...], ...]  # ordered preference: each entry is a
# tuple of mesh axes to use *jointly* for the dim (e.g. ("pod","data")).
Spec = Tuple[Any, ...]  # PartitionSpec counterpart: None | str | tuple of str


def _ruleset(d: Dict[str, Sequence[Sequence[str]]]) -> Dict[str, Candidates]:
    return {k: tuple(tuple(e) for e in v) for k, v in d.items()}


# Baseline: FSDP(data) x TP(model); pod = outer data parallelism.
BASELINE = _ruleset({
    "batch": [("pod", "data"), ("data",)],
    "seq": [],        # residual stream / remat storage (seqpar shards this)
    "seq_inner": [],  # inside attention/MLP blocks: always full-seq
    "embed": [],
    "heads": [("model",)],
    "kv_heads": [("model",)],
    "head_dim": [],
    "mlp": [("model",)],
    "vocab": [("model",)],
    "experts": [("model",)],
    "expert_mlp": [],
    "capacity": [],
    "cache_seq": [("model",)],
    "cache_heads": [("model",)],
    "cache_batch": [("pod", "data"), ("data",)],
    "layers": [],
    "fsdp": [("pod", "data"), ("data",)],
    "conv_k": [],
    "state": [],
    "img_seq": [],
})

# Sequence-parallel variant: activations' seq axis sharded over model between
# blocks.
SEQPAR = dict(BASELINE)
SEQPAR.update(_ruleset({"seq": [("model",)], "seq_inner": [("model",)]}))

# Decode-optimized: single-token activations replicated over the data axis,
# the residual stream's features sharded over data, the KV cache
# seq-sharded over model.
DECODE_FLASH = dict(BASELINE)
DECODE_FLASH.update(_ruleset({
    "batch": [],
    "embed": [("data",)],
    "cache_seq": [("model",)],
    "kv_heads": [],
    "cache_heads": [],
}))

RULESETS: Dict[str, Dict[str, Candidates]] = {
    "baseline": BASELINE,
    "seqpar": SEQPAR,
    "decode_flash": DECODE_FLASH,
    "moe_a2a": BASELINE,
}


def resolve_spec(
    logical: Sequence[Optional[str]],
    shape: Sequence[int],
    mesh,
    rules: Dict[str, Candidates],
) -> Spec:
    """Map logical axes -> spec tuple, first-fit with divisibility checks."""
    if len(logical) != len(shape):
        raise ValueError(f"logical axes {tuple(logical)} and shape "
                         f"{tuple(shape)} differ in rank")
    used: set = set()
    out = []
    axis_sizes = mesh_axis_sizes(mesh)
    for name, dim in zip(logical, shape):
        chosen = None
        if name is not None:
            for cand in rules.get(name, ()):  # each cand: tuple of mesh axes
                if any(a in used or a not in axis_sizes for a in cand):
                    continue
                total = 1
                for a in cand:
                    total *= axis_sizes[a]
                if total > 1 and dim % total == 0:
                    chosen = cand
                    used.update(cand)
                    break
        out.append(chosen if chosen is None else (chosen[0] if len(chosen) == 1 else chosen))
    # Trim trailing Nones for tidier specs.
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class MeshSharding:
    """A tensor laid out over ``mesh`` by ``spec``: the port's counterpart
    of ``NamedSharding``. The index maps are keyed by the device's flat
    position in ``mesh.devices`` (row-major), not by the device itself:
    a virtual mesh holds one card several times."""

    mesh: Any
    spec: Spec

    def _dim_index(self, coord: Dict[str, int], sizes: Dict[str, int],
                   entry, dim: int) -> slice:
        if entry is None:
            return slice(None)
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        cuts, cell = 1, 0
        for a in names:  # the first name is the major one
            cuts *= sizes[a]
            cell = cell * sizes[a] + coord[a]
        if cuts == 1:
            return slice(None)
        lo, hi = _chunk(dim, cuts, cell)
        return slice(lo, hi)

    def devices_indices_map(self, shape: Sequence[int]) -> Dict[int, tuple]:
        """``{flat mesh position: tuple of slices}`` — the slice of a
        tensor of ``shape`` each mesh position holds (``slice(None)`` for
        an uncut dim, as the reference's map gives)."""
        shape = tuple(int(d) for d in shape)
        entries = list(self.spec) + [None] * (len(shape) - len(self.spec))
        sizes = mesh_axis_sizes(self.mesh)
        names = tuple(self.mesh.axis_names)
        out = {}
        grid = tuple(self.mesh.devices.shape)
        for pos in range(self.mesh.devices.size):
            coord, rem = {}, pos
            for a, n in zip(reversed(names), reversed(grid)):
                coord[a] = rem % n
                rem //= n
            out[pos] = tuple(self._dim_index(coord, sizes, e, d)
                             for e, d in zip(entries, shape))
        return out

    def addressable_devices_indices_map(self, shape: Sequence[int]
                                        ) -> Dict[int, tuple]:
        """Every mesh position is addressable from the one process."""
        return self.devices_indices_map(shape)


@dataclasses.dataclass(frozen=True)
class ShardingCtx:
    """Threaded through model code; applies activation constraints.

    mesh=None means no mesh at all: the serve paths' ``null()`` context.
    """

    mesh: Optional[Any]
    rules: Dict[str, Candidates]

    @staticmethod
    def null() -> "ShardingCtx":
        return ShardingCtx(mesh=None, rules=BASELINE)

    @staticmethod
    def for_mesh(mesh, ruleset: str = "baseline") -> "ShardingCtx":
        return ShardingCtx(mesh=mesh, rules=RULESETS[ruleset])

    def spec(self, logical: Sequence[Optional[str]],
             shape: Sequence[int]) -> Spec:
        if self.mesh is None:
            raise ValueError("ShardingCtx.spec needs a mesh")
        return resolve_spec(logical, shape, self.mesh, self.rules)

    def sharding(self, logical, shape) -> MeshSharding:
        return MeshSharding(self.mesh, self.spec(logical, shape))

    def constrain(self, x, logical: Sequence[Optional[str]]):
        """The identity: inside a cell of the partitioned step the
        activations are already local (see the module's docstring)."""
        return x


# --- tensors laid out over a mesh ---------------------------------------------------


class MeshArray:
    """A tensor of ``shape`` and ``dtype`` laid out over a mesh by
    ``sharding``: ``shards[pos]`` is the tensor of flat mesh position
    ``pos``, on that position's device, and holds the slice
    ``sharding.devices_indices_map(shape)[pos]`` of the whole."""

    def __init__(self, shape, dtype, sharding: MeshSharding, shards):
        self.shape = tuple(int(d) for d in shape)
        self.dtype = dtype
        self.sharding = sharding
        self.shards = list(shards)
        if len(self.shards) != sharding.mesh.devices.size:
            raise ValueError(f"{len(self.shards)} shards for a mesh of "
                             f"{sharding.mesh.devices.size} positions")

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def nbytes(self) -> int:
        """The bytes of the whole tensor."""
        n = self.shards[0].element_size()
        for d in self.shape:
            n *= d
        return n

    @property
    def addressable_shards(self):
        """``(position, index, tensor)`` for every mesh position."""
        dmap = self.sharding.devices_indices_map(self.shape)
        return [(pos, dmap[pos], t) for pos, t in enumerate(self.shards)]

    def gather(self, device=None):
        """The whole tensor on ``device`` (the first shard's when unset),
        each block copied from the first position that holds it."""
        import torch

        dev = self.shards[0].device if device is None else torch.device(device)
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        done = set()
        for _pos, index, t in self.addressable_shards:
            key = normalize_index(index, self.shape)
            if key not in done:
                done.add(key)
                out[index].copy_(t)
        return out

    def __repr__(self) -> str:
        return (f"MeshArray(shape={self.shape}, dtype={self.dtype}, "
                f"spec={self.sharding.spec}, "
                f"mesh={tuple(self.sharding.mesh.devices.shape)})")


def place(x, sharding: MeshSharding) -> MeshArray:
    """``x`` (a whole tensor or ndarray) laid out by ``sharding``: each
    mesh position gets a contiguous copy of its slice on its own device."""
    import torch

    if not isinstance(x, torch.Tensor):
        from repro_torch.models import params as P

        x = P.from_reference(x, "cpu")
    x = x.detach()
    dmap = sharding.devices_indices_map(x.shape)
    shards = []
    for pos, dev in enumerate(sharding.mesh.devices.flat):
        part = x[dmap[pos]]
        shards.append(torch.empty(part.shape, dtype=x.dtype,
                                  device=dev).copy_(part))
    return MeshArray(x.shape, x.dtype, sharding, shards)


def gathered(tree, device=None):
    """``tree`` with every ``MeshArray`` leaf gathered whole on ``device``
    (other leaves as they are): what a serve takes from a trainer that
    trained on a mesh."""
    from repro_torch.models import params as P

    return P.tree_map(lambda t: t.gather(device)
                      if isinstance(t, MeshArray) else t, tree)


def resharded(x: MeshArray, sharding: MeshSharding, shape=None) -> MeshArray:
    """``x`` laid out by ``sharding`` as a tensor of ``shape`` (``x``'s by
    default; larger dims hold ``x`` at their start and zeros after it, a
    pad). Each mesh position's tensor is made on its device from the
    blocks of ``x`` that overlap it (``resharding.plan_target_shard``),
    each taken from a position that holds it, the target's own where it
    can: the whole tensor is never assembled anywhere."""
    import torch

    shape = x.shape if shape is None else tuple(int(d) for d in shape)
    holders: Dict[tuple, list] = {}
    for pos, index, _t in x.addressable_shards:
        holders.setdefault(normalize_index(index, x.shape), []).append(pos)
    blocks = list(holders)
    devices = list(sharding.mesh.devices.flat)
    shards = []
    for pos, index in sharding.devices_indices_map(shape).items():
        dst = normalize_index(index, shape)
        dev = devices[pos]
        out = torch.zeros([hi - lo for lo, hi in dst], dtype=x.dtype,
                          device=dev)
        for op in plan_target_shard(blocks, dst):
            have = holders[blocks[op.src]]
            src = pos if pos in have else next(
                (p for p in have if x.shards[p].device == torch.device(dev)),
                have[0])
            out[tuple(slice(lo, hi) for lo, hi in op.dst_slice)].copy_(
                x.shards[src][tuple(slice(lo, hi)
                                    for lo, hi in op.src_slice)])
        shards.append(out)
    return MeshArray(shape, x.dtype, sharding, shards)
