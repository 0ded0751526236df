"""Checkpointing through the Bento file system — shard-native v2 format.

The port's own copy of the reference's store: the same manifests, the
same shard files byte for byte, the same restore engine. Pytrees (nested
dicts, lists and tuples of ``torch.Tensor``, numpy arrays and Python
scalars) serialize SHARD-PER-FILE with a JSON manifest carrying shapes,
numpy dtype names, tree structure (rendered as the reference renders its
``PyTreeDef``), the per-leaf shard grid (logical spec + mesh axis sizes)
and per-shard checksums (the kernel-services hash — the CUDA blockhash
kernel in the kernel binding on a card). Save/restore round-trips through
the journaled xv6/ext4like store, so checkpoint durability inherits the
journal's crash-atomicity (manifest written last = commit point), and the
grid makes the checkpoint topology-elastic: restore onto a DIFFERENT mesh
plans per-target-shard reads (repro_torch.distributed.resharding) and
executes them as streamed offset reads over ``read_many``, re-slicing in
flight — a full leaf is never materialized on the restoring host.

A tensor on the card is sliced on the card and each shard copied to the
host on its own; a ``MeshArray`` leaf (``distributed.sharding``) writes
each block of the grid from the first mesh position that holds it. A
restore fills, one target cell at a time, each host buffer dropped after
its copy, either one tensor per leaf on ``device`` (CUDA when unset), or,
for a ``MeshSharding`` target, a ``MeshArray``: each mesh position's own
tensor on its own device (on a virtual mesh, one card several times,
``launch.mesh``, copies on that card).

v1 manifests (whole-leaf files, no shard records) keep loading through
the same machinery as a 1-shard grid.

Pipelined restore (the overlap engine)
--------------------------------------
``load`` runs at a configurable ``pipeline_depth`` (default 2, env
``REPRO_CKPT_PIPELINE_DEPTH``):

* depth 0 — the serial two-pass reference path: a whole-file checksum
  pre-pass over every shard the plan touches, then budget-bounded offset
  reads filling each target buffer. Checksummed bytes cross the
  fs boundary twice.
* depth 1 — single-pass folded verification, inline: the restore is
  compiled into an ordered task list where the FIRST op touching a
  checksummed shard fetches the whole file once, hashes it (one
  ``checksum_batch`` launch per fetched chunk when the batched hash is
  given) and serves that op's slices straight from the fetched bytes;
  later ops on a verified shard are plain offset reads. Every byte
  crosses once.
* depth >= 2 — the same task list with a prefetch thread: the NEXT
  task's ``read_many`` is issued through that thread's own dedicated
  ``SubmitterQueue`` (PosixView submitter queues are thread-local)
  while the main thread verifies and assembles the current buffer and
  copies it to the device. Assembly stays strict FIFO, so results are
  byte-identical at every depth and failures (checksum mismatch, read
  errors) surface exactly where the serial path raises them —
  speculatively fetched bytes after a failure are dropped, never
  assembled.

Peak-budget protocol: per-leaf materialized HOST bytes stay METERED at
every depth. Each assembly unit's serial read budget (~half its target
buffer) is split into ``budget/depth`` chunks, and admission is a
counted token window of ``depth`` tokens where a task's weight is
``ceil(bytes/chunk)`` capped at ``depth`` — in-flight raw bytes never
exceed the SERIAL budget (an oversized whole-file unit runs exclusive),
buffers allocate lazily in their unit's first assembly step and release
in its finalize step, so the pipelined per-leaf peak stays within the
serial peak while the window keeps up to ``depth`` fetches in flight.
Save gets the symmetric write-behind: shard batches drain on one FIFO
worker thread (device write ORDER unchanged) while the main thread
serializes the next leaf, joined — first error re-raised — BEFORE the
manifest commit, so the manifest-last crash protocol is untouched.
"""

from __future__ import annotations

import io
import json
import os
import queue
import threading
import time
import warnings
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.core.interface import Errno, FsError
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.resharding import (
    Index, ShardGrid, chunk_ops, index_volume, normalize_index,
    plan_target_shard, plan_volume, shift_ops,
)
from repro_torch.distributed.sharding import MeshArray, MeshSharding
from repro_torch.fs.posix import PosixView

MANIFEST = "manifest.json"
FORMAT_VERSION = 2

# Shards cross the boundary in bounded submission batches: one crossing per
# ~chunk instead of per file, without buffering the whole checkpoint
# (serialized bytes would otherwise double peak memory on save).
_BATCH_BYTES = 64 << 20
_BATCH_FILES = 64

# dtypes numpy has no type of its own for: stored as integer views of the
# same width, the manifest naming the real dtype (the reference's format).
_WIRE_DTYPES = {"bfloat16": np.uint16, "float8_e4m3fn": np.uint8,
                "float8_e5m2": np.uint8}
# the signed twin torch.from_numpy takes for each wire dtype
_WIRE_SIGNED = {np.dtype(np.uint16): np.int16, np.dtype(np.uint8): np.uint8}

# Pipeline depth: 0 = serial two-pass reference, 1 = folded single-pass
# inline, >= 2 = prefetch thread `depth` window tokens ahead.
_DEPTH_ENV = "REPRO_CKPT_PIPELINE_DEPTH"
_DEFAULT_DEPTH = 2

# Restores smaller than this run the task list inline even at depth >= 2:
# the prefetch thread's spawn + queue traffic costs more than overlapping
# a handful of tiny fetches could recover. Tests that pin worker-thread
# behavior on small fixtures monkeypatch this to 0.
_INLINE_BYTES = 16 << 10


def _resolve_depth(arg: Optional[int]) -> int:
    if arg is None:
        try:
            arg = int(os.environ.get(_DEPTH_ENV, _DEFAULT_DEPTH))
        except ValueError:
            arg = _DEFAULT_DEPTH
    return max(0, int(arg))


class _WriteBehind:
    """Write-behind lane for save: shard batches drain through ONE FIFO
    worker thread (with its own thread-local ``SubmitterQueue``) while
    the main thread serializes the next leaf. The queue is bounded to
    ``depth`` batches so serialization runs at most that far ahead of
    the device; the single worker keeps device write order identical to
    the synchronous path, and ``close()`` joins and re-raises the first
    write error BEFORE the manifest commit — the manifest-last crash
    protocol sees exactly the same device-write sequence."""

    def __init__(self, view: PosixView, depth: int):
        self._view = view
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._err: Optional[BaseException] = None
        self._t = threading.Thread(target=self._run,
                                   name="ckpt-write-behind", daemon=True)
        self._t.start()

    def _run(self) -> None:
        while True:
            batch = self._q.get()
            if batch is None:
                return
            if self._err is None:
                try:
                    self._view.write_many(batch)
                except BaseException as e:  # noqa: BLE001 — close re-raises
                    self._err = e

    def put(self, batch) -> None:
        if self._err is not None:
            self.close()  # drains the worker and raises the write error
        self._q.put(batch)

    def close(self) -> None:
        self._q.put(None)
        self._t.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def abandon(self) -> None:
        """Teardown on a serialization error without masking it."""
        try:
            self._q.put(None)
            self._t.join(timeout=30)
        except Exception:  # noqa: BLE001 — best-effort cleanup
            pass


class _TreeDef:
    """Structure of a pytree of dicts (keys sorted), lists, tuples,
    NamedTuples (the optimizer's ``OptState``: fields in order) and
    ``None`` (an empty subtree); anything else is a leaf. ``str`` renders
    it exactly as the reference renders its ``PyTreeDef``, which the
    manifest stores and ``load`` compares as text."""

    __slots__ = ("kind", "keys", "children", "cls")

    def __init__(self, kind: str, keys=(), children=(), cls=None):
        self.kind, self.keys, self.children, self.cls = kind, keys, children, cls

    def _render(self) -> str:
        kids = [c._render() for c in self.children]
        if self.kind == "leaf":
            return "*"
        if self.kind == "none":
            return "None"
        if self.kind == "dict":
            return "{" + ", ".join(f"{k!r}: {c}" for k, c in
                                   zip(self.keys, kids)) + "}"
        if self.kind == "list":
            return "[" + ", ".join(kids) + "]"
        if self.kind == "namedtuple":
            return (f"CustomNode(namedtuple[{self.cls.__name__}], ["
                    + ", ".join(kids) + "])")
        return "(" + ", ".join(kids) + ("," if len(kids) == 1 else "") + ")"

    def __str__(self) -> str:
        return f"PyTreeDef({self._render()})"

    def unflatten(self, leaves):
        it = iter(leaves)

        def build(td):
            if td.kind == "leaf":
                return next(it)
            if td.kind == "none":
                return None
            kids = [build(c) for c in td.children]
            if td.kind == "dict":
                return dict(zip(td.keys, kids))
            if td.kind == "namedtuple":
                return td.cls(*kids)
            return kids if td.kind == "list" else tuple(kids)
        return build(self)


def _flatten(tree, none_is_leaf: bool = False):
    """``(leaves, treedef)`` in the reference's leaf order: dict keys
    sorted, lists, tuples and NamedTuples in order. ``none_is_leaf``
    keeps a ``None`` as a leaf, except a NamedTuple's ``None`` field,
    which stays an empty subtree (an absent part of the state, such as
    ``OptState.master`` without master weights)."""
    leaves: List = []

    def walk(x, none_leaf: bool) -> _TreeDef:
        if x is None and not none_leaf:
            return _TreeDef("none")
        if type(x) is dict:
            keys = tuple(sorted(x))
            return _TreeDef("dict", keys,
                            tuple(walk(x[k], none_is_leaf) for k in keys))
        if type(x) in (list, tuple):
            return _TreeDef("list" if type(x) is list else "tuple",
                            children=tuple(walk(v, none_is_leaf) for v in x))
        if isinstance(x, tuple) and hasattr(type(x), "_fields"):
            return _TreeDef("namedtuple", children=tuple(
                walk(v, False) for v in x), cls=type(x))
        leaves.append(x)
        return _TreeDef("leaf")
    treedef = walk(tree, none_is_leaf)
    return leaves, treedef


def _flatten_shardings(tree) -> List:
    """Flatten a per-leaf sharding/grid tree. None entries mean "this leaf
    is unsharded" and must stay leaves, not collapse as empty subtrees.
    A NamedTuple's None field is the one exception: it mirrors an absent
    part of the saved tree (the reference takes it as a leaf too, so a
    trainer on a mesh without master weights cannot save there: ROADMAP
    Queue 3)."""
    return _flatten(tree, none_is_leaf=True)[0]


def _dtype_name(x) -> str:
    """numpy's name for the dtype of a tensor or array (``"bfloat16"``,
    ``"float32"``), as the manifest records it."""
    return str(x.dtype).removeprefix("torch.")


def _np_dtype(dtype_s: str) -> np.dtype:
    """The host dtype a leaf travels in: its wire dtype for the dtypes
    numpy lacks (same width, so byte offsets and sizes are the real
    dtype's)."""
    if dtype_s in _WIRE_DTYPES:
        return np.dtype(_WIRE_DTYPES[dtype_s])
    return np.dtype(dtype_s)


def _serialize(arr: np.ndarray) -> bytes:
    # numpy can't serialize bf16/fp8: save a same-width integer view and
    # record the real dtype in the manifest.
    wire = arr.view(_WIRE_DTYPES[str(arr.dtype)]) \
        if str(arr.dtype) in _WIRE_DTYPES else arr
    if not wire.flags["C_CONTIGUOUS"]:  # ascontiguousarray promotes 0-d
        wire = np.ascontiguousarray(wire)
    buf = io.BytesIO()
    np.save(buf, wire)
    return buf.getvalue()


def _host_wire(t) -> np.ndarray:
    """A host tensor as a numpy array in its wire dtype (no copy)."""
    import torch

    name = _dtype_name(t)
    if name in _WIRE_DTYPES:
        wire = np.dtype(_WIRE_DTYPES[name])
        return t.view(getattr(torch, str(np.dtype(_WIRE_SIGNED[wire]))))\
            .numpy().view(wire)
    return t.numpy()


def _host_tensor(buf: np.ndarray, dtype_s: str):
    """A host buffer in its wire dtype as a torch tensor of ``dtype_s``,
    sharing its memory (the caller copies it to the device)."""
    import torch

    with warnings.catch_warnings():
        # read-only buffers (a verified file served in place) are only
        # ever copied from
        warnings.filterwarnings("ignore", message=".*not writable.*")
        if dtype_s in _WIRE_DTYPES:
            t = torch.from_numpy(buf.view(_WIRE_SIGNED[buf.dtype]))
            return t.view(getattr(torch, dtype_s))
        return torch.from_numpy(buf)


class _Placed:
    """One restored leaf, allocated at the first cell and filled one
    target cell at a time from host buffers: a tensor of the manifest's
    dtype on ``device``, or, for a ``MeshSharding`` ``target``, a
    ``MeshArray`` whose positions each hold their own tensor on their
    own device (each buffer copied once to every position whose block it
    covers)."""

    def __init__(self, shape, dtype_s: str, device, target=None):
        self.shape, self.dtype_s, self.device = tuple(shape), dtype_s, device
        self.target = target if isinstance(target, MeshSharding) else None
        if self.target is not None:  # each position's block
            dmap = self.target.devices_indices_map(self.shape)
            self.blocks = [normalize_index(dmap[p], self.shape)
                           for p in range(len(dmap))]
        self.t = None

    def result(self):
        """The leaf, allocated at the first use."""
        if self.t is None:
            import torch

            dt = getattr(torch, self.dtype_s)
            if self.target is None:
                self.t = torch.empty(self.shape, dtype=dt, device=self.device)
            else:
                self.t = MeshArray(self.shape, dt, self.target, [
                    torch.empty(tuple(hi - lo for lo, hi in b), dtype=dt,
                                device=d)
                    for b, d in zip(self.blocks,
                                    self.target.mesh.devices.flat)])
        return self.t

    def put(self, index: Index, buf: np.ndarray) -> None:
        t, src = self.result(), _host_tensor(buf, self.dtype_s)
        if self.target is None:
            if index:
                t[tuple(slice(lo, hi) for lo, hi in index)].copy_(src)
            else:
                t.copy_(src)
            return
        for block, shard in zip(self.blocks, t.shards):
            if all(lo <= blo and bhi <= hi for (lo, hi), (blo, bhi)
                   in zip(index, block)):
                shard.copy_(src[tuple(slice(blo - lo, bhi - lo) for
                                      (lo, _), (blo, bhi)
                                      in zip(index, block))])

    def whole(self, buf: np.ndarray):
        self.put(tuple((0, d) for d in self.shape), buf)
        return self.t


def _resolve_grid(shape, leaf, sharding) -> ShardGrid:
    """Per-leaf shard grid: an explicit ShardGrid (virtual grids — crash
    torture and single-device tests shard without devices), a
    MeshSharding, else one shard."""
    if isinstance(sharding, ShardGrid):
        if sharding.shape != tuple(shape):
            raise ValueError(
                f"ShardGrid shape {sharding.shape} != leaf shape {shape}")
        grid = sharding
    elif isinstance(sharding, MeshSharding):
        grid = ShardGrid.from_sharding(shape, sharding)
    else:
        grid = ShardGrid.trivial(shape)
    return grid if grid.n_shards > 1 else ShardGrid.trivial(shape)


def _held_by(leaf: MeshArray, block: Index):
    """The part of ``leaf`` at ``block`` from the first mesh position
    whose shard holds all of it, or None."""
    for _pos, index, t in leaf.addressable_shards:
        have = normalize_index(index, leaf.shape)
        if all(lo <= blo and bhi <= hi for (lo, hi), (blo, bhi)
               in zip(have, block)):
            return t[tuple(slice(blo - lo, bhi - lo) for (lo, _), (blo, bhi)
                           in zip(have, block))]
    return None


def _shard_arrays(leaf, grid: ShardGrid):
    """Yield ``(j, shard ndarray)``. A tensor is sliced where it lies (on
    the card) and each shard made contiguous there, then copied to the
    host on its own: a sharded leaf never crosses whole. A ``MeshArray``
    gives each block from the first position that holds it (gathered
    once, where no position holds a whole block)."""
    import torch

    whole = None
    for j in range(grid.n_shards):
        sl = tuple(slice(lo, hi) for lo, hi in grid.index(j))
        if isinstance(leaf, MeshArray):
            piece = _held_by(leaf, grid.index(j))
            if piece is None:
                whole = leaf.gather() if whole is None else whole
                piece = whole[sl] if sl else whole
            yield j, _host_wire(piece.detach().contiguous().cpu())
        elif isinstance(leaf, torch.Tensor):
            piece = leaf.detach()[sl] if sl else leaf.detach()
            yield j, _host_wire(piece.contiguous().cpu())
        else:
            yield j, np.ascontiguousarray(leaf[sl]) if sl else leaf


def _first_leaf_names(root: str, gen: int):
    sfx = f"_g{gen}" if gen else ""
    # both naming lines: v1 whole-leaf files and v2 shard files — a
    # crashed attempt from either format must not be overwritten short
    return (f"{root}/leaf_00000{sfx}.npy", f"{root}/leaf_00000_s000{sfx}.npy")


def save(view: PosixView, root: str, tree, *, step: int,
         checksum=None, extra: Optional[Dict] = None,
         shardings=None, pipeline_depth: Optional[int] = None) -> Dict:
    """Save ``tree`` shard-per-file. ``shardings``: optional pytree
    matching ``tree`` of MeshSharding | ShardGrid | None deciding each
    leaf's grid (default: one shard). ``checksum`` (e.g.
    ``KernelServices.checksum``) hashes each shard file once.
    ``pipeline_depth`` >= 2 (the default, see ``_DEPTH_ENV``) drains
    shard batches write-behind while the next leaf serializes; 0/1 keep
    the fully synchronous path. Device write order and the manifest-last
    commit protocol are identical either way."""
    depth = _resolve_depth(pipeline_depth)
    leaves, treedef = _flatten(tree)
    grids = None
    if shardings is not None:
        grids = _flatten_shardings(shardings)
        if len(grids) != len(leaves):
            raise ValueError(
                f"shardings tree has {len(grids)} leaves, model has "
                f"{len(leaves)} — incompatible trees")
    manifest_path = f"{root}/{MANIFEST}"
    # Re-saves bump a GENERATION tag baked into the shard names, so the new
    # files never overwrite the ones the LIVE manifest references — the
    # old checkpoint (manifest AND data) stays fully intact until the
    # manifest swap commits, and stale-generation shards are collected
    # after it. Without this, a crash mid-shard-write would tear the
    # previous good checkpoint's data under its still-live manifest.
    # ONE read probes for an existing checkpoint and fetches its gen in
    # the same round trip; re-saves (the trainer's steady state) skip
    # the makedirs walk entirely
    gen, old_exists = 0, False
    try:
        raw_old = view.read_file(manifest_path)
        old_exists = True
        try:
            gen = int(json.loads(raw_old).get("gen", 0)) + 1
        except ValueError:
            gen = 1  # old manifest torn: start a fresh line
    except FsError as e:
        if e.errno == Errno.ENOENT:
            view.makedirs(root)  # first save at this root
        else:
            # present but unreadable — treat like a torn manifest so the
            # commit still goes through the tmp+rename swap, never a
            # direct overwrite of whatever is on disk
            old_exists, gen = True, 1
    # whatever suggested the tag, probe past any shard names a CRASHED
    # attempt already occupies (its swap never committed, so the live
    # manifest still names the previous gen): fresh writes must never
    # land on a stale same-name file — a shorter overwrite would keep
    # the old tail, because write never truncates
    while leaves and any(
            not isinstance(st, FsError)
            for st in view.stat_many(list(_first_leaf_names(root, gen)),
                                     strict=False)):
        gen += 1
    suffix = f"_g{gen}" if gen else ""
    manifest = {
        "version": FORMAT_VERSION,
        "step": step,
        "gen": gen,
        "treedef": str(treedef),
        "n_leaves": len(leaves),
        "leaves": [],
        "extra": extra or {},
    }
    # symmetric with load's inline shortcut: a checkpoint this small
    # finishes before the drain thread would even start paying off
    est_bytes = sum(getattr(l, "nbytes", 16) for l in leaves)
    sink = (_WriteBehind(view, depth)
            if depth >= 2 and est_bytes >= _INLINE_BYTES else None)
    items, pending_bytes = [], 0
    try:
        for i, leaf in enumerate(leaves):
            if not (hasattr(leaf, "shape") and hasattr(leaf, "dtype")):
                leaf = np.asarray(leaf)  # python scalars
            shape = tuple(int(d) for d in leaf.shape)
            grid = _resolve_grid(shape, leaf, grids[i] if grids else None)
            rec = {"shape": list(shape), "dtype": _dtype_name(leaf),
                   "shards": []}
            rec.update(grid.to_manifest())
            for j, shard in _shard_arrays(leaf, grid):
                raw = _serialize(shard)
                path = f"{root}/leaf_{i:05d}_s{j:03d}{suffix}.npy"
                items.append((path, raw))
                pending_bytes += len(raw)
                rec["shards"].append({
                    "path": path,
                    "coords": list(grid.coords(j)),
                    "index": [[lo, hi] for lo, hi in grid.index(j)],
                    # payload position inside the .npy — lets restore
                    # stream sub-shard slices as offset reads without
                    # parsing headers
                    "data_off": len(raw) - shard.nbytes,
                    "checksum": checksum(raw) if checksum else None,
                })
                if len(items) >= _BATCH_FILES \
                        or pending_bytes >= _BATCH_BYTES:
                    if sink is not None:
                        sink.put(items)
                    else:
                        view.write_many(items)
                    items, pending_bytes = [], 0
            manifest["leaves"].append(rec)
    except BaseException:
        if sink is not None:
            sink.abandon()
        raise
    # The manifest is the commit point, enforced by the manifest's own
    # linked chain: shard batches (including the final one) are plain
    # batches — strict mode raises a failing write's real errno before the
    # manifest submission ever happens — and then the manifest's
    # create→write→flush CHAIN commits everything. Since the chain-aware
    # journal reservation landed, a chain is one bounded journal
    # transaction (crash-atomic, sized by capacity), so bulk shard data
    # must NOT be chained — only the small manifest chain is, and its
    # flush commits any still-pending shard blocks with it (one transaction
    # when they fit together; begin_chain pre-commits them first when they
    # don't, which is equally safe — they are invisible without the
    # manifest). A crash at any device write before that commit leaves no
    # manifest at all — the aborted save is invisible to latest_step;
    # after it, manifest AND every shard it names are durable together.
    #
    # Re-saves over an EXISTING checkpoint never touch the live manifest
    # (or, thanks to the generation tag, its shards): the new manifest is
    # committed under a tmp name, then swapped in with one journaled
    # rename-overwrite (+fsync to make the swap durable). The old
    # checkpoint stays fully intact until the rename transaction commits,
    # so the previous good one survives a crash at ANY device write of a
    # re-save — the old truncate-then-rewrite path had a window where
    # neither version did. Both properties are enumerated per crash point
    # by fs.crashsim.torture_ckpt_shards (v2 sharded re-saves).
    raw_manifest = json.dumps(manifest).encode()
    if sink is not None:
        # join the write-behind lane — a failed shard write raises its
        # real errno HERE, before the manifest submission ever happens,
        # exactly like the synchronous path's strict write_many
        try:
            if items:
                sink.put(items)
        finally:
            sink.close()
    elif items:
        view.write_many(items)
    try:
        if not old_exists:
            _commit_manifest(view, manifest_path, raw_manifest)
        else:
            tmp_path = f"{root}/.{MANIFEST}.tmp"
            try:
                if view.exists(tmp_path):  # stale tmp of a crashed re-save
                    view.unlink(tmp_path)
                _commit_manifest(view, tmp_path, raw_manifest)
                view.rename(tmp_path, manifest_path)
                view.fsync(manifest_path)  # commit the swap's journal txn
            except FsError:
                # failed re-save: drop the tmp husk — the OLD manifest is
                # still the live checkpoint, untouched
                try:
                    if view.exists(tmp_path):
                        view.unlink(tmp_path)
                except FsError:
                    pass
                raise
    except FsError:
        # a manifest created whose WRITE then failed is an empty husk —
        # remove it so the aborted save is indistinguishable from no save
        try:
            if view.exists(manifest_path) \
                    and view.stat(manifest_path).size == 0:
                view.unlink(manifest_path)
        except FsError:
            pass
        raise
    # the swap is durable: collect shard files the live manifest no longer
    # references (prior generations + orphans of crashed attempts). Pure
    # garbage collection — a crash skipping it just leaves dead files the
    # next successful save sweeps up.
    live = {s["path"].rsplit("/", 1)[-1]
            for rec in manifest["leaves"] for s in rec["shards"]}
    stale = [f"{root}/{name}" for name in view.listdir(root)
             if name.startswith("leaf_") and name not in live]
    if stale:
        try:
            view.unlink_many(stale, strict=False)
        except FsError:
            pass
    return manifest


def _commit_manifest(view: PosixView, path: str, raw: bytes) -> None:
    """Create ``path`` and make ``raw`` durable in it: a chained
    create→write→flush when it fits one journal transaction
    (crash-atomic), else the ENOSPC refusal falls back to an unchained
    write + fsync — a torn fresh file reads as "no checkpoint" (and for a
    re-save the tear hits only the TMP name, never the live manifest), and
    a genuinely full device just raises ENOSPC again here."""
    try:
        view.create_and_write_many([(path, raw)], fsync=True)
    except FsError as e:
        if e.errno != Errno.ENOSPC:
            raise
        view.write_file(path, raw)
        view.fsync(path)


# --- restore ----------------------------------------------------------------


def _leaf_name(rec: Dict) -> str:
    return rec["shards"][0]["path"].rsplit("/", 1)[-1]


def _normalize_rec(rec: Dict) -> Dict:
    """v1 whole-leaf records load through the v2 machinery as a 1-shard
    grid covering the full leaf."""
    if "shards" in rec:
        return rec
    shape = rec["shape"]
    return {"shape": shape, "dtype": rec["dtype"],
            "spec": [[] for _ in shape], "axes": {},
            "shards": [{"path": rec["path"], "coords": [0] * len(shape),
                        "index": [[0, int(d)] for d in shape],
                        "checksum": rec.get("checksum")}]}


def _validate_manifest(manifest: Dict, leaves_like, treedef) -> List[Dict]:
    """n_leaves + treedef + per-leaf dtype/shape against ``like_tree`` —
    an incompatible tree must fail loudly naming the first bad leaf, not
    silently unflatten into the wrong structure."""
    if manifest["n_leaves"] != len(leaves_like):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, model expects "
            f"{len(leaves_like)} — incompatible trees")
    saved_td = manifest.get("treedef")
    if saved_td is not None and saved_td != str(treedef):
        raise ValueError(
            "checkpoint tree structure does not match the model:\n"
            f"  checkpoint: {saved_td}\n"
            f"  model:      {treedef}")
    recs = [_normalize_rec(rec) for rec in manifest["leaves"]]
    for i, (rec, like) in enumerate(zip(recs, leaves_like)):
        if not (hasattr(like, "shape") and hasattr(like, "dtype")):
            like = np.asarray(like)
        if _dtype_name(like) != rec["dtype"]:
            raise ValueError(
                f"leaf {i} ({_leaf_name(rec)}): checkpoint dtype "
                f"{rec['dtype']} != model dtype {_dtype_name(like)}")
        if list(tuple(like.shape)) != list(rec["shape"]):
            raise ValueError(
                f"leaf {i} ({_leaf_name(rec)}): checkpoint shape "
                f"{tuple(rec['shape'])} != model shape "
                f"{tuple(like.shape)}")
    return recs


class _Peak:
    """Host-side materialized-byte ledger for one leaf restore: raw read
    bytes + assembly buffers in flight (the thing the reshard path must
    keep strictly below full-tensor size for sharded targets).
    Thread-safe: the pipelined engine's prefetch worker adds raw bytes
    at fetch time while the main thread subtracts after assembly."""

    def __init__(self):
        self.cur = 0
        self.peak = 0
        self._lock = threading.Lock()

    def add(self, n: int) -> None:
        with self._lock:
            self.cur += n
            self.peak = max(self.peak, self.cur)

    def sub(self, n: int) -> None:
        with self._lock:
            self.cur -= n


def _hash_batch(checksum_batch, raws) -> List[int]:
    """``checksum_batch`` over files of any sizes, in order: one call
    (one kernel launch on a card) per distinct word count among them,
    since a batched hash takes blocks of one word count (an even grid's
    shards are one call)."""
    groups: Dict[int, List[int]] = {}
    for k, raw in enumerate(raws):
        groups.setdefault((len(raw) + 3) // 4, []).append(k)
    out: List[int] = [0] * len(raws)
    for ks in groups.values():
        for k, h in zip(ks, checksum_batch([raws[k] for k in ks])):
            out[k] = h
    return out


def _verify_shards(view: PosixView, srecs, src_idx, need, checksum,
                   peak: _Peak, itemsize: int, full_bytes: int):
    """Whole-file checksum pass over the shards a restore will touch,
    BEFORE assembly buffers exist: read chunks are byte-budgeted (sized
    from the manifest's index extents) and dropped right after hashing,
    so verification never stacks up toward full-tensor bytes."""
    todo = [j for j in sorted(need)
            if srecs[j].get("checksum") is not None]
    est = {j: index_volume(src_idx[j]) * itemsize + 512 for j in todo}
    budget = max(1, min(_BATCH_BYTES, full_bytes // 2))
    while todo:
        chunk, pend = [], 0
        while todo and (not chunk or (pend + est[todo[0]] <= budget
                                      and len(chunk) < _BATCH_FILES)):
            pend += est[todo[0]]
            chunk.append(todo.pop(0))
        raws = view.read_many([srecs[j]["path"] for j in chunk])
        total = sum(len(r) for r in raws)
        peak.add(total)
        bad = None
        for j, raw in zip(chunk, raws):
            if bad is None and checksum(raw) != srecs[j]["checksum"]:
                bad = srecs[j]["path"]
        peak.sub(total)
        if bad is not None:
            raise IOError(f"checksum mismatch in shard {bad}")


def _file_runs(src_index: Index, src_slice: Index, dtype: np.dtype):
    """Contiguous byte runs of ``src_slice`` inside its shard's .npy
    payload (C order): yields ``(payload_off, nbytes, outer_coords,
    piece_shape)``. Runs coalesce over the largest fully-covered suffix
    of dims, so a slice wanting the whole shard is ONE run."""
    s_shape = tuple(hi - lo for lo, hi in src_index)
    ext = tuple(hi - lo for lo, hi in src_slice)
    ndim = len(s_shape)
    # strides (in elements) of the shard array
    strides = [1] * ndim
    for d in range(ndim - 2, -1, -1):
        strides[d] = strides[d + 1] * s_shape[d + 1]
    # t = first dim of the contiguous tail: every dim AFTER t is fully
    # covered, so dim t's extent rides along in one run
    t = ndim - 1
    while t > 0 and ext[t] == s_shape[t] \
            and src_slice[t][0] == 0:
        t -= 1
    if ndim == 0:
        yield 0, dtype.itemsize, (), ()
        return
    tail = 1
    for d in range(t + 1, ndim):
        tail *= s_shape[d]
    run_elems = ext[t] * tail
    piece_shape = ext[t:]
    if run_elems == 0 or any(e == 0 for e in ext):
        return
    for outer in np.ndindex(*ext[:t]):
        off = src_slice[t][0] * strides[t]
        for d, c in enumerate(outer):
            off += (src_slice[d][0] + c) * strides[d]
        yield (off * dtype.itemsize, run_elems * dtype.itemsize,
               outer, piece_shape)


def _flat_dst(buf: np.ndarray, dst_slice: Index):
    """Flat view of ``buf[dst_slice]`` when the slab is C-contiguous
    (the slice covers every dim after the first), else None."""
    for d, (lo, hi) in enumerate(dst_slice[1:], 1):
        if (lo, hi) != (0, buf.shape[d]):
            return None
    return buf[tuple(slice(lo, hi) for lo, hi in dst_slice)].reshape(-1)


def _fill_buffer(view: PosixView, buf: np.ndarray, ops, srecs, src_idx,
                 dtype: np.dtype, peak: _Peak) -> int:
    """Execute one target shard's read plan as budget-bounded batches of
    OFFSET reads (the streamed ``read_many`` path): raw bytes in flight
    stay under ~half the target buffer, so assembly peaks at ~1.5x the
    target shard — never the full leaf. A single run bigger than the
    budget (target shard == whole source shard, the identity-transfer
    case) lands on a contiguous slab of ``buf`` and is itself read in
    budget-sized flat pieces. Returns crossings issued."""
    budget = max(1, min(_BATCH_BYTES, buf.nbytes // 2 or buf.itemsize))
    specs, places, pend, crossings = [], [], 0, 0

    def flush():
        nonlocal specs, places, pend, crossings
        if not specs:
            return
        raws = view.read_many(specs)
        crossings += 1
        total = sum(len(r) for r in raws)
        peak.add(total)
        for raw, (dst_view, outer, piece_shape) in zip(raws, places):
            piece = np.frombuffer(raw, dtype=dtype).reshape(piece_shape)
            if outer == ():
                dst_view[...] = piece
            else:
                dst_view[outer] = piece
        peak.sub(total)
        specs, places, pend = [], [], 0

    for op in ops:
        s = srecs[op.src]
        if "data_off" not in s:
            # no payload offset recorded (hand-written manifest): fall
            # back to one whole-file read for this shard
            raw = view.read_file(s["path"])
            crossings += 1
            peak.add(len(raw))
            arr = np.load(io.BytesIO(raw)).view(dtype)
            buf[tuple(slice(lo, hi) for lo, hi in op.dst_slice)] = \
                arr[tuple(slice(lo, hi) for lo, hi in op.src_slice)]
            peak.sub(len(raw))
            continue
        sl = tuple(slice(lo, hi) for lo, hi in op.dst_slice)
        # 0-d: buf[()] yields a scalar copy, not a view — use buf[...]
        dst_view = buf[sl] if sl else buf[...]
        for off, nbytes, outer, piece_shape in _file_runs(
                src_idx[op.src], op.src_slice, dtype):
            if outer == () and nbytes > budget:
                flat = _flat_dst(buf, op.dst_slice) if sl else None
                if flat is not None:
                    # one run would peak at buf + run: stream it instead
                    step = max(dtype.itemsize,
                               budget // dtype.itemsize * dtype.itemsize)
                    base, done = s["data_off"] + off, 0
                    while done < nbytes:
                        n = min(step, nbytes - done)
                        raw = view.read_many([(s["path"], base + done, n)])[0]
                        crossings += 1
                        peak.add(len(raw))
                        e0 = done // dtype.itemsize
                        flat[e0:e0 + n // dtype.itemsize] = \
                            np.frombuffer(raw, dtype=dtype)
                        peak.sub(len(raw))
                        done += n
                    continue
            specs.append((s["path"], s["data_off"] + off, nbytes))
            places.append((dst_view, outer, piece_shape))
            pend += nbytes
            if pend >= budget or len(specs) >= 4 * _BATCH_FILES:
                flush()
    flush()
    return crossings


def _restore_streamed(view: PosixView, rec: Dict, target, checksum,
                      peak: _Peak, info: Dict, device):
    """Multi-shard leaf restore: plan per target shard, stream slices."""
    shape = tuple(rec["shape"])
    placed = _Placed(shape, rec["dtype"], device, target)
    dtype = _np_dtype(rec["dtype"])
    srecs = rec["shards"]
    src_idx = [tuple((int(lo), int(hi)) for lo, hi in s["index"])
               for s in srecs]
    if isinstance(target, ShardGrid):
        # Uneven (non-divisible) target grids: the reference's
        # NamedSharding refuses non-divisible tilings outright, so
        # elastic restores onto uneven meshes carry a ShardGrid target
        # instead. Every — possibly short or empty — cell gets its own
        # reshard plan (exercising remainder slicing) and lands, shifted
        # to global coordinates, in ONE full-shape host buffer; the
        # result is copied to the device whole. max_target_bytes == full_bytes marks the
        # leaf exempt from the strict sub-full peak budget (there is no
        # per-device placement to stream into).
        if target.shape != shape:
            raise ValueError(
                f"target grid shape {target.shape} != leaf shape {shape}")
        full = tuple((0, d) for d in shape)
        cells = [c for c in target.indices() if index_volume(c) > 0]
        ops: List = []
        for cell in cells:
            cops = plan_target_shard(src_idx, cell)
            if plan_volume(cops) != index_volume(cell):
                raise IOError(
                    f"shard records cover {plan_volume(cops)} of "
                    f"{index_volume(cell)} elements for slice {cell} of "
                    f"{_leaf_name(rec)} — incomplete checkpoint")
            ops.extend(shift_ops(cops, cell))
        info["n_target_groups"] = len(cells)
        info["max_target_bytes"] = index_volume(full) * dtype.itemsize
        if checksum:
            need = {op.src for op in ops}
            _verify_shards(view, srecs, src_idx, need, checksum, peak,
                           dtype.itemsize, index_volume(full)
                           * dtype.itemsize)
        buf = np.empty(shape, dtype)
        peak.add(buf.nbytes)
        _fill_buffer(view, buf, ops, srecs, src_idx, dtype, peak)
        leaf = placed.whole(buf)
        peak.sub(buf.nbytes)
        return leaf
    if isinstance(target, MeshSharding):
        dmap = target.addressable_devices_indices_map(shape)
        groups: Dict[Index, list] = {}
        for dev, idx in dmap.items():
            groups.setdefault(normalize_index(idx, shape), []).append(dev)
        plans = {di: plan_target_shard(src_idx, di) for di in groups}
        need = {op.src for ops in plans.values() for op in ops}
    else:
        full = tuple((0, d) for d in shape)
        plans = {full: plan_target_shard(src_idx, full)}
        groups = {full: None}
        need = {op.src for op in plans[full]}
    info["n_target_groups"] = len(groups)
    info["max_target_bytes"] = max(
        (index_volume(di) * dtype.itemsize for di in groups), default=0)
    if checksum:
        full_bytes = index_volume(
            tuple((0, d) for d in shape)) * dtype.itemsize
        _verify_shards(view, srecs, src_idx, need, checksum, peak,
                       dtype.itemsize, full_bytes)
    for di in sorted(groups):
        ops = plans[di]
        if plan_volume(ops) != index_volume(di):
            raise IOError(
                f"shard records cover {plan_volume(ops)} of "
                f"{index_volume(di)} elements for slice {di} of "
                f"{_leaf_name(rec)} — incomplete checkpoint")
        buf = np.empty(tuple(hi - lo for lo, hi in di), dtype)
        peak.add(buf.nbytes)
        _fill_buffer(view, buf, ops, srecs, src_idx, dtype, peak)
        # one copy per mesh position of the group
        placed.put(di, buf)
        del buf
        peak.sub(index_volume(di) * dtype.itemsize)
    return placed.result()


# --- pipelined restore engine ----------------------------------------------


class _Task:
    """One pipelined-restore work unit: ``specs`` (``read_many`` specs;
    may be empty for pure-assembly steps like unit finalizers) are
    fetched — possibly ahead, on the prefetch thread — then
    ``on_ready(raws)`` runs on the main thread in strict FIFO order.
    ``peak`` (optional) meters the fetched raw bytes from fetch until
    assembly finishes; ``weight`` is the number of tokens the task
    occupies in ``win`` — its leaf's admission window — while in
    flight. Windows are PER LEAF (plus one shared window for the
    simple-batch tasks): an oversized fetch runs exclusive within its
    own leaf, bounding that leaf's metered peak, without stalling the
    prefetch of the NEXT leaf behind the current leaf's assembly —
    that cross-leaf overlap is where the restore pipeline's win
    actually comes from."""

    __slots__ = ("specs", "on_ready", "peak", "weight", "win")

    def __init__(self, specs, on_ready, peak=None, weight=1, win=None):
        self.specs = specs
        self.on_ready = on_ready
        self.peak = peak
        self.weight = weight
        self.win = win


class _Window:
    """Counted-token admission window — the pipeline's byte budget.

    ``depth`` tokens total, ONE window per leaf; a unit-weight task
    carries at most one chunk budget of raw bytes, so a leaf's in-flight
    raw stays <= depth x chunk == the unit's SERIAL read budget. An
    oversized task weighs ``depth`` and runs exclusive — within its own
    leaf only, so it never blocks another leaf's prefetch. ``abort()``
    wakes a blocked producer when the consumer dies mid-restore."""

    def __init__(self, depth: int):
        self._depth = depth
        self._avail = depth
        self._cv = threading.Condition()
        self._aborted = False

    def acquire(self, weight: int) -> bool:
        weight = min(weight, self._depth)
        with self._cv:
            while self._avail < weight and not self._aborted:
                self._cv.wait()
            if self._aborted:
                return False
            self._avail -= weight
            return True

    def release(self, weight: int) -> None:
        weight = min(weight, self._depth)
        with self._cv:
            self._avail += weight
            self._cv.notify_all()

    def abort(self) -> None:
        with self._cv:
            self._aborted = True
            self._cv.notify_all()


def _run_inline(view: PosixView, tasks: List[_Task], timing: Dict) -> None:
    """depth-1 execution: the task list runs on the calling thread —
    single-pass folded verification without prefetch."""
    for t in tasks:
        t0 = time.perf_counter()
        raws = view.read_many(t.specs) if t.specs else []
        timing["fetch_s"] += time.perf_counter() - t0
        total = sum(len(r) for r in raws)
        if t.peak is not None:
            t.peak.add(total)
        kept = 0
        try:
            t0 = time.perf_counter()
            kept = t.on_ready(raws) or 0
            timing["assemble_s"] += time.perf_counter() - t0
        finally:
            if t.peak is not None:
                t.peak.sub(total - kept)


def _run_pipelined(view: PosixView, tasks: List[_Task], depth: int,
                   timing: Dict) -> None:
    """depth>=2 execution: a prefetch worker fetches ahead under the
    token window (its ``read_many`` submissions ride the worker thread's
    own thread-local ``SubmitterQueue``); the main thread assembles in
    FIFO order, so failures surface exactly where the serial path would
    raise them and speculatively fetched bytes after a failure are
    dropped, never assembled."""
    fallback = _Window(depth)
    for t in tasks:
        if t.win is None:
            t.win = fallback
    wins = {id(t.win): t.win for t in tasks}.values()
    results: "queue.Queue" = queue.Queue()
    stop = threading.Event()

    def worker():
        for t in tasks:
            if not t.win.acquire(t.weight) or stop.is_set():
                return
            try:
                t0 = time.perf_counter()
                raws = view.read_many(t.specs) if t.specs else []
                timing["fetch_s"] += time.perf_counter() - t0
            except BaseException as e:  # noqa: BLE001 — re-raised on main
                results.put((t, e, 0))
                return
            total = sum(len(r) for r in raws)
            if t.peak is not None:
                t.peak.add(total)
            results.put((t, raws, total))

    th = threading.Thread(target=worker, name="ckpt-prefetch", daemon=True)
    th.start()
    try:
        for _ in tasks:
            t, payload, total = results.get()
            if isinstance(payload, BaseException):
                raise payload
            kept = 0
            try:
                t0 = time.perf_counter()
                kept = t.on_ready(payload) or 0
                timing["assemble_s"] += time.perf_counter() - t0
            finally:
                if t.peak is not None:
                    t.peak.sub(total - kept)
                t.win.release(t.weight)
    except BaseException:
        stop.set()
        for w in wins:
            w.abort()
        raise
    finally:
        th.join(timeout=30)


def _flat_ok(ushape, dst_slice: Index) -> bool:
    """True when ``buf[dst_slice]`` is C-contiguous (the slice covers
    every dim after the first) — the shape-only twin of ``_flat_dst``."""
    return all((lo, hi) == (0, ushape[d])
               for d, (lo, hi) in enumerate(dst_slice[1:], 1))


def _unit_tasks(view: PosixView, srecs, src_idx, dtype: np.dtype, ops,
                di: Index, depth: int, peak: _Peak, checksum,
                checksum_batch, verified: set, finalize,
                memo=None) -> List[_Task]:
    """Compile ONE assembly unit (one target buffer) into tasks.

    Folded verification: the first op touching a checksummed shard in
    ``verified``-order becomes a whole-file unit — fetched once, hashed
    (one ``checksum_batch`` launch per fetched chunk) and that op's
    slices served straight from the fetched bytes; later ops on a
    verified shard are plain offset reads. The buffer allocates lazily
    in the unit's first assembly step; the trailing zero-spec task runs
    ``finalize(buf)`` and releases the buffer's peak bytes.

    ``memo`` (built by ``_leaf_tasks`` when depth >= 2) retains the most
    recently fetched whole-file shard so that LATER units reading the
    same shard assemble straight from RAM instead of re-fetching slices
    through the store — the retained bytes stay on the peak ledger, and
    a zero-spec drop task queued before the next memoized fetch keeps at
    most one retained shard live at a time."""
    itemsize = dtype.itemsize
    ushape = tuple(hi - lo for lo, hi in di)
    unit_full = tuple((0, hi - lo) for lo, hi in di)
    ubytes = index_volume(di) * itemsize
    serial_budget = max(1, min(_BATCH_BYTES, ubytes // 2 or itemsize))
    chunk = max(itemsize, serial_budget // max(1, depth))
    state = {"buf": None, "buf_bytes": 0}
    tasks: List[_Task] = []

    def buf() -> np.ndarray:
        if state["buf"] is None:
            state["buf"] = np.empty(ushape, dtype)
            state["buf_bytes"] = state["buf"].nbytes
            peak.add(state["buf_bytes"])
        return state["buf"]

    def weigh(est: int) -> int:
        return min(depth, max(1, -(-est // chunk)))

    # whole-file units: first-touch verification + no-data_off shards
    wf = {"entries": [], "est": 0}  # entries: (path, expected, apply)

    def flush_wf():
        entries = wf["entries"]
        if not entries:
            return
        est = wf["est"]
        wf["entries"], wf["est"] = [], 0

        def on_ready(raws, entries=entries):
            need = [k for k, e in enumerate(entries) if e[1] is not None]
            if need:
                if checksum_batch is not None:
                    got = _hash_batch(checksum_batch,
                                      [raws[k] for k in need])
                else:
                    got = [checksum(raws[k]) for k in need]
                for k, g in zip(need, got):
                    if g != entries[k][1]:
                        raise IOError(
                            f"checksum mismatch in shard {entries[k][0]}")
            kept = 0
            for raw, (_path, _exp, apply) in zip(raws, entries):
                kept += apply(raw)
            return kept

        tasks.append(_Task([e[0] for e in entries], on_ready,
                           peak=peak, weight=weigh(est)))

    def add_wf(op, s, expected, memoize=False):
        vol = index_volume(src_idx[op.src])
        est = vol * itemsize + 512
        if wf["entries"] and wf["est"] + est > chunk:
            flush_wf()
        s_shape = tuple(hi - lo for lo, hi in src_idx[op.src])

        def apply(raw, op=op, s=s, s_shape=s_shape, vol=vol,
                  memoize=memoize):
            if "data_off" in s:
                arr = np.frombuffer(raw, dtype=dtype,
                                    offset=s["data_off"],
                                    count=vol).reshape(s_shape)
            else:
                arr = np.load(io.BytesIO(raw)).view(dtype)
            src = arr[tuple(slice(lo, hi) for lo, hi in op.src_slice)]
            if memoize:
                # retain the decoded shard for later units of this
                # leaf; its bytes stay on the ledger until the drop
                # task (or the leaf-end cleanup) releases them
                if "data_off" in s:
                    kept = len(raw)  # arr aliases raw
                else:
                    kept = 0  # np.load copied; raw itself is free
                    peak.add(arr.nbytes)
                memo["src"], memo["arr"] = op.src, arr
                memo["bytes"] = len(raw) if "data_off" in s else arr.nbytes
                b = buf()
                b[tuple(slice(lo, hi) for lo, hi in op.dst_slice)] = src
                return kept
            if state["buf"] is None and op.dst_slice == unit_full:
                # identity serve: the verified file IS the buffer
                # (zero copy) — exact coverage means no other op writes
                # this unit, so the read-only view is safe. Returning
                # len(raw) keeps the raw's bytes on the ledger until
                # the finalize step instead of end-of-assembly.
                state["buf"] = src
                state["buf_bytes"] = len(raw)
                return len(raw)
            b = buf()
            b[tuple(slice(lo, hi) for lo, hi in op.dst_slice)] = src
            return 0

        wf["entries"].append((s["path"], expected, apply))
        wf["est"] += est

    # offset-read runs (verified / checksum-free shards with data_off)
    run = {"specs": [], "places": [], "pend": 0}

    def flush_runs():
        specs, places = run["specs"], run["places"]
        if not specs:
            return
        est = run["pend"]
        run["specs"], run["places"], run["pend"] = [], [], 0

        def on_ready(raws, places=places):
            b = buf()
            for raw, pl in zip(raws, places):
                if pl[0] == "flat":
                    _k, dsl, e0, n = pl
                    flat = b[tuple(slice(lo, hi) for lo, hi in dsl)] \
                        .reshape(-1)
                    flat[e0:e0 + n] = np.frombuffer(raw, dtype=dtype)
                else:
                    _k, dsl, outer, pshape = pl
                    sl = tuple(slice(lo, hi) for lo, hi in dsl)
                    dst = b[sl] if sl else b[...]
                    piece = np.frombuffer(raw, dtype=dtype).reshape(pshape)
                    if outer == ():
                        dst[...] = piece
                    else:
                        dst[outer] = piece

        tasks.append(_Task(specs, on_ready, peak=peak, weight=weigh(est)))

    def add_runs(op, s):
        for off, nbytes, outer, pshape in _file_runs(
                src_idx[op.src], op.src_slice, dtype):
            if outer == () and nbytes > chunk \
                    and _flat_ok(ushape, op.dst_slice):
                # an oversized contiguous run streams as its own chain
                # of flat-slab tasks instead of one giant fetch
                flush_runs()
                step = max(itemsize, chunk // itemsize * itemsize)
                base, done_b = s["data_off"] + off, 0
                while done_b < nbytes:
                    n = min(step, nbytes - done_b)
                    run["specs"].append((s["path"], base + done_b, n))
                    run["places"].append(
                        ("flat", op.dst_slice, done_b // itemsize,
                         n // itemsize))
                    run["pend"] += n
                    flush_runs()
                    done_b += n
                continue
            run["specs"].append((s["path"], s["data_off"] + off, nbytes))
            run["places"].append(("nd", op.dst_slice, outer, pshape))
            run["pend"] += nbytes
            if run["pend"] >= chunk or len(run["specs"]) >= 4 * _BATCH_FILES:
                flush_runs()

    def add_memo(op):
        def on_ready(_raws, op=op):
            if memo["src"] != op.src:
                raise IOError(
                    f"restore memo lost shard {op.src} mid-leaf")
            src = memo["arr"][
                tuple(slice(lo, hi) for lo, hi in op.src_slice)]
            b = buf()
            sl = tuple(slice(lo, hi) for lo, hi in op.dst_slice)
            if sl:
                b[sl] = src
            else:
                b[...] = src

        tasks.append(_Task([], on_ready))

    # chunk_ops bounds each op-group's destination bytes; flushing both
    # accumulators at group boundaries keeps every task within roughly
    # one chunk budget of raw bytes (whole-file units excepted — their
    # weight covers the full file)
    for group in chunk_ops(ops, itemsize, chunk, max_ops=4 * _BATCH_FILES):
        for op in group:
            s = srecs[op.src]
            if memo is not None and op.src == memo["psrc"]:
                add_memo(op)  # served from the retained shard, no fetch
                continue
            first = (checksum is not None
                     and s.get("checksum") is not None
                     and op.src not in verified)
            if first or "data_off" not in s:
                if first:
                    verified.add(op.src)
                if memo is not None and op.src in memo["worthy"]:
                    # the old retained shard must leave the ledger
                    # before this exclusive whole-file fetch starts;
                    # the drop task's window token enforces that order
                    flush_wf()
                    if memo["psrc"] is not None:
                        tasks.append(_Task([], memo["drop"]))
                    add_wf(op, s, s["checksum"] if first else None,
                           memoize=True)
                    flush_wf()
                    memo["psrc"] = op.src
                else:
                    add_wf(op, s, s["checksum"] if first else None)
            else:
                add_runs(op, s)
        flush_wf()
        flush_runs()

    def fin(_raws):
        b = buf()
        finalize(b)
        state["buf"] = None  # copied to the device: the host buffer goes
        peak.sub(state["buf_bytes"])

    # the finalizer holds one token of ITS OWN leaf's window: the same
    # leaf's next unit must not fetch while this unit's buffer (possibly
    # an aliased whole-file raw) is still on the peak ledger — but other
    # leaves' windows are untouched, so their prefetch overlaps this
    # leaf's copy to the device
    tasks.append(_Task([], fin))
    return tasks


def _leaf_tasks(view: PosixView, rec: Dict, target, checksum,
                checksum_batch, depth: int, peak: _Peak, info: Dict,
                done, device) -> List[_Task]:
    """Compile one multi-shard leaf's restore into an ordered task list;
    ``done(leaf)`` fires from the last finalize with the assembled
    array. FIFO execution means at most one of the leaf's unit buffers
    is ever live, exactly like the serial path."""
    shape = tuple(rec["shape"])
    dtype = _np_dtype(rec["dtype"])
    itemsize = dtype.itemsize
    srecs = rec["shards"]
    src_idx = [tuple((int(lo), int(hi)) for lo, hi in s["index"])
               for s in srecs]
    full = tuple((0, d) for d in shape)

    def check(ops, di):
        if plan_volume(ops) != index_volume(di):
            raise IOError(
                f"shard records cover {plan_volume(ops)} of "
                f"{index_volume(di)} elements for slice {di} of "
                f"{_leaf_name(rec)} — incomplete checkpoint")

    tasks: List[_Task] = []
    verified: set = set()

    def memo_plan(unit_ops, max_unit_bytes):
        """Shards fetched whole (first-touch verify / no data_off) that
        MORE units will read again are worth retaining in RAM — if the
        retained bytes plus a unit buffer still fit well under the full
        tensor, so the metered-peak discipline survives."""
        if depth < 2:
            return None  # depth 1 has no budget headroom for a memo
        full_b = index_volume(full) * itemsize
        counts: Dict[int, int] = {}
        for ops in unit_ops:
            for op in ops:
                counts[op.src] = counts.get(op.src, 0) + 1
        worthy = set()
        for src, n in counts.items():
            s = srecs[src]
            wf_first = ((checksum is not None
                         and s.get("checksum") is not None)
                        or "data_off" not in s)
            # +512 covers the npy header, which rides the ledger as
            # part of len(raw) and dominates for tiny shards
            sb = index_volume(src_idx[src]) * itemsize + 512
            if n > 1 and wf_first and sb + 2 * max_unit_bytes <= full_b:
                worthy.add(src)
        if not worthy:
            return None
        m = {"psrc": None, "src": None, "arr": None, "bytes": 0,
             "worthy": worthy}

        def drop(_raws=None):
            if m["arr"] is not None:
                peak.sub(m["bytes"])
                m["src"] = m["arr"] = None
                m["bytes"] = 0

        m["drop"] = drop
        return m

    placed = _Placed(shape, rec["dtype"], device, target)
    if isinstance(target, MeshSharding):
        dmap = target.addressable_devices_indices_map(shape)
        groups: Dict[Index, list] = {}
        for dev, idx in dmap.items():
            groups.setdefault(normalize_index(idx, shape), []).append(dev)
        info["n_target_groups"] = len(groups)
        info["max_target_bytes"] = max(
            (index_volume(di) * itemsize for di in groups), default=0)
        dis = sorted(groups)
        unit_ops = []
        for di in dis:
            ops = plan_target_shard(src_idx, di)
            check(ops, di)
            unit_ops.append(ops)
        memo = memo_plan(unit_ops, info["max_target_bytes"])
        for u_i, di in enumerate(dis):

            def finalize(b, di=di, last=(u_i == len(dis) - 1)):
                # one copy per mesh position of the group
                placed.put(di, b)
                if last:
                    done(placed.result())

            tasks += _unit_tasks(view, srecs, src_idx, dtype,
                                 unit_ops[u_i], di, depth, peak,
                                 checksum, checksum_batch, verified,
                                 finalize, memo=memo)
        if memo is not None:
            tasks.append(_Task([], memo["drop"]))
    elif isinstance(target, ShardGrid):
        # uneven target grids: same protocol as the serial branch — all
        # cells plan separately, shift into ONE full-shape host buffer
        if target.shape != shape:
            raise ValueError(
                f"target grid shape {target.shape} != leaf shape {shape}")
        cells = [c for c in target.indices() if index_volume(c) > 0]
        ops = []
        for cell in cells:
            cops = plan_target_shard(src_idx, cell)
            check(cops, cell)
            ops.extend(shift_ops(cops, cell))
        info["n_target_groups"] = len(cells)
        info["max_target_bytes"] = index_volume(full) * itemsize
        tasks += _unit_tasks(view, srecs, src_idx, dtype, ops, full,
                             depth, peak, checksum, checksum_batch,
                             verified, lambda b: done(placed.whole(b)))
    else:
        ops = plan_target_shard(src_idx, full)
        check(ops, full)
        info["n_target_groups"] = 1
        info["max_target_bytes"] = index_volume(full) * itemsize
        tasks += _unit_tasks(
            view, srecs, src_idx, dtype, ops, full, depth, peak,
            checksum, checksum_batch, verified,
            lambda b: done(placed.whole(b)))
    return tasks


def _build_tasks(view: PosixView, recs, shardings, checksum,
                 checksum_batch, depth: int, out, note,
                 device) -> List[_Task]:
    """Compile the whole restore into one ordered task list: single-shard
    leaves batch v1-style (one crossing per ~``_BATCH_FILES`` whole
    files, one hash launch per fetched chunk); multi-shard leaves expand
    through the reshard plan compiler. Every multi-shard leaf gets its
    OWN admission window (simple batches share one): an oversized fetch
    is exclusive only within its leaf, so leaf N+1 prefetches while
    leaf N assembles."""
    tasks: List[_Task] = []
    simple_win = _Window(depth)
    batch = {"idx": [], "est": 0}

    def flush_simple():
        idxs = batch["idx"]
        if not idxs:
            return
        est = batch["est"]
        batch["idx"], batch["est"] = [], 0

        def on_ready(raws, idxs=idxs):
            got = None
            if checksum is not None and checksum_batch is not None:
                need = [k for k, i in enumerate(idxs)
                        if recs[i]["shards"][0].get("checksum") is not None]
                if need:
                    got = dict(zip(
                        need, _hash_batch(checksum_batch,
                                          [raws[k] for k in need])))
            for k, (i, raw) in enumerate(zip(idxs, raws)):
                rec, s = recs[i], recs[i]["shards"][0]
                peak = _Peak()
                peak.add(len(raw))
                if checksum and s.get("checksum") is not None:
                    g = got[k] if got is not None else checksum(raw)
                    if g != s["checksum"]:
                        raise IOError(
                            f"checksum mismatch in shard {s['path']}")
                arr = np.load(io.BytesIO(raw))  # the wire dtype
                if list(arr.shape) != list(rec["shape"]):
                    raise IOError(f"shape mismatch in {s['path']}")
                peak.add(arr.nbytes)
                # a 1-shard source lands whole, or in every mesh
                # position's slice of it
                out[i] = _Placed(arr.shape, rec["dtype"], device,
                                 shardings[i]).whole(arr)
                peak.sub(len(raw) + arr.nbytes)
                note(i, rec, peak, streamed=False)

        tasks.append(_Task(
            [recs[i]["shards"][0]["path"] for i in idxs], on_ready,
            weight=min(depth, max(1, -(-est // _BATCH_BYTES))),
            win=simple_win))

    for i, rec in enumerate(recs):
        if len(rec["shards"]) == 1:
            batch["idx"].append(i)
            batch["est"] += index_volume(
                tuple((0, int(d)) for d in rec["shape"])) \
                * _np_dtype(rec["dtype"]).itemsize + 512
            if len(batch["idx"]) >= _BATCH_FILES:
                flush_simple()
        else:
            peak, info = _Peak(), {}

            def done(leaf, i=i, rec=rec, peak=peak, info=info):
                out[i] = leaf
                note(i, rec, peak, streamed=True, info=info)

            lts = _leaf_tasks(view, rec, shardings[i], checksum,
                              checksum_batch, depth, peak, info, done,
                              device)
            leaf_win = _Window(depth)
            for t in lts:
                t.win = leaf_win
            tasks += lts
    flush_simple()
    return tasks


def load(view: PosixView, root: str, like_tree, *, checksum=None,
         checksum_batch=None, sharding_tree=None,
         stats: Optional[Dict] = None,
         pipeline_depth: Optional[int] = None, device: DeviceLike = None):
    """Restore into the structure of ``like_tree`` (tensors, arrays or
    scalars: only their shapes and dtypes are read), each leaf a tensor
    on ``device`` (CUDA when unset; raises without one); optionally
    assemble each leaf under the matching sharding from ``sharding_tree``
    (MeshSharding | ShardGrid | None: elastic rescale onto a different
    mesh — multi-shard leaves restore via the streamed reshard plan, one
    target cell at a time, never materializing the full tensor on the
    host; an uneven ShardGrid target assembles one full host array per
    leaf). A leaf with a MeshSharding target comes back a ``MeshArray``,
    each mesh position's tensor on that position's device.
    ``stats`` (a dict, mutated) collects per-leaf peak/full byte counts
    plus a ``pipeline`` record (depth, fetch/assemble seconds, overlap
    ratio). ``pipeline_depth`` selects the engine (see the module
    docstring); ``checksum_batch`` (optional, e.g.
    ``KernelServices.checksum_batch``) hashes each fetched chunk in one
    launch on the folded-verification paths."""
    t_start = time.perf_counter()
    device = resolve_device(device)
    depth = _resolve_depth(pipeline_depth)
    manifest = json.loads(view.read_file(f"{root}/{MANIFEST}"))
    leaves_like, treedef = _flatten(like_tree)
    recs = _validate_manifest(manifest, leaves_like, treedef)
    shardings: List[Any] = [None] * len(leaves_like)
    if sharding_tree is not None:
        shardings = _flatten_shardings(sharding_tree)
        if len(shardings) != len(leaves_like):
            raise ValueError(
                f"sharding tree has {len(shardings)} leaves, model has "
                f"{len(leaves_like)} — incompatible trees")
    out: List[Any] = [None] * len(recs)
    leaf_stats: List[Dict] = []

    def note(i, rec, peak, streamed, info=None):
        full = index_volume(tuple(
            (0, d) for d in rec["shape"])) * _np_dtype(rec["dtype"]).itemsize
        leaf_stats.append({"leaf": i, "peak_bytes": peak.peak,
                           "full_bytes": full,
                           "n_src_shards": len(rec["shards"]),
                           "streamed": streamed, **(info or {})})

    timing = {"fetch_s": 0.0, "assemble_s": 0.0}
    if depth <= 0:
        _load_serial(view, recs, shardings, checksum, out, note, device)
    else:
        tasks = _build_tasks(view, recs, shardings, checksum,
                             checksum_batch, depth, out, note, device)
        total = sum(
            index_volume(tuple((0, d) for d in r["shape"]))
            * _np_dtype(r["dtype"]).itemsize for r in recs)
        if depth == 1 or total < _INLINE_BYTES:
            # a restore this small has nothing worth prefetching — the
            # worker thread's spawn/teardown and lock traffic would cost
            # more than any overlap buys, so the SAME task list (folded
            # verification included) runs on the calling thread
            _run_inline(view, tasks, timing)
        else:
            _run_pipelined(view, tasks, depth, timing)
    if stats is not None:
        stats["leaves"] = sorted(leaf_stats, key=lambda s: s["leaf"])
        stats["version"] = manifest.get("version", 1)
        wall = max(time.perf_counter() - t_start, 1e-9)
        busy = timing["fetch_s"] + timing["assemble_s"]
        stats["pipeline"] = {
            "depth": depth,
            "fetch_s": timing["fetch_s"],
            "assemble_s": timing["assemble_s"],
            "wall_s": wall,
            # fraction of the wall the fetch and assemble phases ran
            # concurrently — 0 by construction for depth <= 1
            "overlap_ratio": max(0.0, busy - wall) / wall,
        }
    return treedef.unflatten(out), manifest


def _load_serial(view: PosixView, recs, shardings, checksum, out,
                 note, device) -> None:
    """The depth-0 reference path: serial two-pass restore (whole-file
    verify pre-pass, then offset-read fill), kept verbatim as the
    overlap-off baseline the pipelined engine is differentially tested
    and benchmarked against."""
    # single-shard leaves batch v1-style: one crossing per ~_BATCH_FILES
    # whole files; multi-shard leaves go through the streamed plan
    pend: List[int] = []

    def flush_simple():
        raws = view.read_many([recs[i]["shards"][0]["path"] for i in pend])
        for i, raw in zip(pend, raws):
            rec, s = recs[i], recs[i]["shards"][0]
            peak = _Peak()
            peak.add(len(raw))
            if checksum and s.get("checksum") is not None \
                    and checksum(raw) != s["checksum"]:
                raise IOError(f"checksum mismatch in shard {s['path']}")
            arr = np.load(io.BytesIO(raw))  # the wire dtype
            if list(arr.shape) != list(rec["shape"]):
                raise IOError(f"shape mismatch in {s['path']}")
            peak.add(arr.nbytes)
            # a 1-shard source lands whole, or in every mesh position's
            # slice of it
            out[i] = _Placed(arr.shape, rec["dtype"], device,
                             shardings[i]).whole(arr)
            peak.sub(len(raw) + arr.nbytes)
            note(i, rec, peak, streamed=False)
        pend.clear()

    for i, rec in enumerate(recs):
        if len(rec["shards"]) == 1:
            pend.append(i)
            if len(pend) >= _BATCH_FILES:
                flush_simple()
        else:
            peak, info = _Peak(), {}
            out[i] = _restore_streamed(view, rec, shardings[i], checksum,
                                       peak, info, device)
            note(i, rec, peak, streamed=True, info=info)
    if pend:
        flush_simple()


def latest_step(view: PosixView, base: str) -> Optional[int]:
    """Newest step with a PARSEABLE manifest — an empty or torn manifest
    (crash inside the save's final commit window) is treated as no
    checkpoint, so restart falls back to the previous good step."""
    if not view.exists(base):
        return None
    steps = []
    for name in view.listdir(base):
        if name.startswith("step_"):
            try:
                json.loads(view.read_file(f"{base}/{name}/{MANIFEST}"))
                steps.append(int(name.split("_")[1]))
            except (FsError, ValueError, IndexError):
                continue
    return max(steps) if steps else None
