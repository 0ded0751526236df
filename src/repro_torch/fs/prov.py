"""File provenance as a stackable Bento layer (paper §6, the headline demo).

The paper's signature move is adding provenance tracking to a RUNNING
kernel file system with milliseconds of interruption: Bento-prov wraps
xv6, intercepts every operation, and logs who touched what — installed by
the online-upgrade path, not a remount. ``ProvFilesystem`` is that layer
for this repo: a ``BentoFilesystem`` that owns no disk format of its own,
delegates every scalar and batched/chained op to an INNER module
(xv6/ext4like), and appends one plain-value record per successful mutation
to an on-device log::

    {"op", "ino", "parent", "name", "pid", "submitter", "ts", ...}

Design rules, in order of importance:

* **The log is journal-protected and ordered.** Records are appended
  through the inner module's own ``write`` path, so they stage into the
  SAME write-ahead journal as the mutations they describe. Records are
  always staged AFTER their mutation on the same thread, and a journal
  commit installs the whole pending set atomically — so a committed record
  can never describe an uncommitted mutation: the log never references an
  inode or name the recovered file system doesn't explain.

* **Namespace mutations commit with their record in ONE transaction.**
  Scalar create/mkdir/unlink/rmdir/rename run inside a chain-scoped
  journal reservation (``Journal.begin_chain``) that also covers the
  record append: after a crash, the mutation and its record are durable
  together or not at all (old-XOR-new), proven per crash point by
  ``repro_torch.fs.crashsim.torture_prov``. SQE_LINK chains get the same
  guarantee through the existing chain hooks — ``chain_begin`` forwards to
  the inner fs with the record footprint added to the reservation (the
  ``extra_blocks`` log-allocation hook), so one journal transaction spans
  the chain's data AND its provenance.

* **Every dispatch shape composes.** ``submit_batch`` delegates whole
  entry runs to the inner module (its vectorized ``_many`` paths, write
  coalescing and cross-submitter coalescing survive intact), then appends
  one combined record batch; chain members arriving one-at-a-time from
  ``execute_batch`` are detected via ``journal.in_chain_here`` and their
  appends are bracketed with the member-undo scope so a failed append
  rolls back cleanly mid-chain.

* **The log hides from the namespace.** It lives at a reserved root name
  (``PROV_LOG_NAME``), created lazily on first record; the layer filters
  it from ``lookup``/``readdir`` and refuses direct mutation, so wrapped
  and plain mounts expose identical trees. Downgrading strips the layer
  but leaves the log durable — the next wrap adopts it and keeps
  appending (sequence numbers are line positions, so history stays
  monotonic across plain→prov→plain cycles).

Install/remove on a live mount via ``repro_torch.core.upgrade``::

    wrap_layer(mount, ProvFilesystem)   # plain -> prov, no remount
    unwrap_layer(mount)                 # prov -> plain

Queries cross the boundary as the ``read_provenance`` op (scalar, batched
and FUSE dispatch all carry it), surfaced to applications as
``PosixView.read_provenance``.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.capability import SuperBlockCap
from repro_torch.core.interface import (Attr, BentoFilesystem,
                                        CompletionEntry, Errno, FileKind,
                                        FsError, ROOT_INO, SubmissionEntry)

# Reserved root name of the on-device log. Hidden by the layer; visible as
# an ordinary file if the image is mounted plain (documented, harmless).
PROV_LOG_NAME = ".bento-prov"
# Rotation scratch file: the compacted log is built here, then atomically
# swapped over PROV_LOG_NAME via rename-overwrite (old-XOR-new retention).
PROV_LOG_TMP = ".bento-prov.new"

# Ops that mutate state and therefore earn a record.
PROV_MUTATING_OPS = frozenset({
    "create", "mkdir", "unlink", "rmdir", "rename", "write", "truncate"})

# Per-record upper bound for reservation estimates (json line incl. names).
_REC_BYTES_EST = 224


class ProvFilesystem(BentoFilesystem):
    """Stackable provenance layer over any journaled BentoFilesystem."""

    NAME = "prov"
    VERSION = 1

    # Rotation threshold: once the log exceeds this many bytes, _append
    # compacts it to the newest half of its records (0 disables). Long
    # torture runs otherwise grow the log without bound.
    ROTATE_BYTES = 256 * 1024

    def __init__(self, inner: BentoFilesystem):
        self.inner = inner
        self.ks = None
        self._log_ino = 0       # 0: not yet discovered/created (lazy)
        self._log_size = 0
        # byte offset of each complete record line, maintained across
        # appends so incremental queries read only the log's suffix; None
        # until the first full scan (or after a dropped append resync)
        self._line_index: Optional[List[int]] = None
        # seq of the log's first retained line (> 0 after a rotation
        # dropped history; recovered from the head marker line on rescan)
        self._seq_base = 0
        self.rotate_bytes = self.ROTATE_BYTES
        self._plock = threading.RLock()  # serializes append/size bookkeeping
        self.prov_stats = {"records": 0, "append_errors": 0, "appends": 0,
                           "rotations": 0, "rotate_errors": 0}

    # the benchmark/torture tooling reaches for module.journal / .opts —
    # keep those windows open through the layer
    @property
    def journal(self):
        return getattr(self.inner, "journal", None)

    @property
    def opts(self):
        return getattr(self.inner, "opts", None)

    @property
    def stats(self):
        return getattr(self.inner, "stats", {})

    # --- lifecycle -------------------------------------------------------------
    def init(self, sb: SuperBlockCap, services) -> None:
        self.inner.init(sb, services)
        self.ks = services
        self._discover_log()

    def destroy(self) -> None:
        self.inner.destroy()

    def _discover_log(self) -> None:
        """Adopt an existing on-device log (remount, re-wrap after a
        downgrade); creation stays lazy so attaching the layer writes
        nothing — the upgrade pause stays read-only."""
        try:
            attr = self.inner.lookup(ROOT_INO, PROV_LOG_NAME)
            self._log_ino, self._log_size = attr.ino, attr.size
        except FsError:
            self._log_ino, self._log_size = 0, 0
        self._line_index = None

    def _ensure_log(self) -> None:
        if self._log_ino == 0:
            attr = self.inner.create(ROOT_INO, PROV_LOG_NAME)
            self._log_ino, self._log_size = attr.ino, attr.size

    # --- §4.8 state transfer: layer-aware passthrough ----------------------------
    def extract_state(self) -> Dict:
        st = dict(self.inner.extract_state())
        st["prov"] = {"log_ino": self._log_ino, "log_size": self._log_size,
                      "seq_base": self._seq_base,
                      "rotate_bytes": self.rotate_bytes,
                      "stats": dict(self.prov_stats)}
        return st

    def restore_state(self, state: Dict, from_version: int) -> None:
        inner_state = {k: v for k, v in state.items() if k != "prov"}
        self.inner.restore_state(inner_state, from_version)
        p = state.get("prov")
        if p:  # prov -> prov upgrade: carry the layer's own state
            self._log_ino = int(p.get("log_ino", 0))
            self._log_size = int(p.get("log_size", 0))
            self._seq_base = int(p.get("seq_base", 0))
            self.rotate_bytes = int(p.get("rotate_bytes", self.ROTATE_BYTES))
            self.prov_stats.update(p.get("stats", {}))
        else:  # plain -> prov wrap: bootstrap from the device
            self._discover_log()

    def state_schema(self) -> Tuple[str, ...]:
        return tuple(self.inner.state_schema()) + ("prov",)

    def optional_state_keys(self) -> Tuple[str, ...]:
        # the layer can bootstrap from the device when wrapping a plain
        # module whose extract never emitted "prov"
        return tuple(self.inner.optional_state_keys()) + ("prov",)

    # --- the record pipeline -----------------------------------------------------
    def _rec(self, op: str, *, ino: int = 0, parent: int = 0, name: str = "",
             sub: Optional[str] = None, **extra) -> Dict[str, Any]:
        # submitter precedence: the entry's declared identity (SQPOLL-style
        # queues stamp it), else the run identity the inner fs is currently
        # draining for, else the executing thread — a guess, but an honest
        # one, and the only option for direct scalar calls
        if sub is None:
            sub = getattr(self.inner, "_current_submitter", None)
        if sub is None:
            sub = f"tid:{threading.get_ident()}"
        r = {"op": op, "ino": ino, "parent": parent, "name": name,
             "pid": os.getpid(), "submitter": sub,
             "ts": self.ks.time() if self.ks is not None else 0.0}
        r.update(extra)
        return r

    def _append(self, records: List[Dict[str, Any]]) -> None:
        """Append records to the on-device log via the inner write path
        (journal-staged). A failed append (journal pressure) degrades to a
        counted, warned drop — it never fails the mutation it describes,
        which already happened; inside a chain it is bracketed with the
        member-undo scope so partial staging rolls back instead of leaving
        a torn line in the chain transaction."""
        if not records:
            return
        lines = [json.dumps(r, separators=(",", ":")).encode() + b"\n"
                 for r in records]
        data = b"".join(lines)
        j = self.journal
        # lock order: inner fs lock BEFORE the layer's append lock, always —
        # the scalar path already holds _oplock (txn scope) when it reaches
        # here, while inner.write would re-acquire it inside _plock; taking
        # it first keeps one global order (oplock -> plock) and no deadlock
        oplock = getattr(self.inner, "_oplock", None) or contextlib.nullcontext()
        with oplock, self._plock:
            try:
                self._ensure_log()
                bracket = j is not None and j.in_chain_here
                if bracket:
                    j.chain_member_begin()
                try:
                    self.inner.write(self._log_ino, self._log_size, data)
                except BaseException:
                    if bracket:
                        j.chain_member_abort()
                    raise
                if bracket:
                    j.chain_member_end()
                if self._line_index is not None:
                    pos = self._log_size
                    for ln in lines:
                        self._line_index.append(pos)
                        pos += len(ln)
                self._log_size += len(data)
                self.prov_stats["records"] += len(records)
                self.prov_stats["appends"] += 1
                self._maybe_rotate()
            except FsError as e:
                self.prov_stats["append_errors"] += 1
                self._line_index = None  # torn tail: rebuild on next read
                if self._log_ino:
                    try:  # resync size after any rollback
                        self._log_size = self.inner.getattr(self._log_ino).size
                    except FsError:
                        pass
                if self.ks is not None:
                    self.ks.log_warn(f"prov: record append dropped: {e}")

    def _maybe_rotate(self) -> None:
        """Compact the log once it exceeds ``rotate_bytes``: keep the newest
        half of its records behind a ``_rotate`` marker line carrying the
        first kept record's absolute seq, so sequence numbers stay monotonic
        across rotations. The compacted log is built at a scratch name and
        swapped in with rename-overwrite — ONE journal transaction replaces
        old with new, so a crash mid-rotation leaves either the full old
        log or the compacted one, never a torn mix (old-XOR-new). Skipped
        inside chain scopes (a rotation is many transactions) and counted
        in ``prov_stats["rotations"]``. Callers hold oplock + _plock."""
        j = self.journal
        if (self.rotate_bytes <= 0 or self._log_size <= self.rotate_bytes
                or self._log_ino == 0
                or (j is not None and j.in_chain_here)):
            return
        if self._line_index is None:
            self._rescan()
        idx = self._line_index
        if idx is None or len(idx) < 2:
            return
        keep_from = len(idx) // 2
        new_base = self._seq_base + keep_from
        start = idx[keep_from]
        marker = json.dumps({"op": "_rotate", "base": new_base},
                            separators=(",", ":")).encode() + b"\n"
        try:
            tail = self.inner.read(self._log_ino, start,
                                   self._log_size - start)
            try:  # adopt a stray scratch file from a crashed rotation
                attr = self.inner.lookup(ROOT_INO, PROV_LOG_TMP)
                self.inner.truncate(attr.ino, 0)
            except FsError:
                attr = self.inner.create(ROOT_INO, PROV_LOG_TMP)
            self.inner.write(attr.ino, 0, marker + tail)
            # the atomic cutover: displaces (and frees) the old log inode
            self.inner.rename(ROOT_INO, PROV_LOG_TMP, ROOT_INO,
                              PROV_LOG_NAME)
        except FsError as e:
            self.prov_stats["rotate_errors"] += 1
            if self.ks is not None:
                self.ks.log_warn(f"prov: rotation skipped: {e}")
            return
        self._log_ino = attr.ino
        self._log_size = len(marker) + len(tail)
        self._seq_base = new_base
        self._line_index = None  # offsets all shifted: rebuild lazily
        self.prov_stats["rotations"] += 1

    def _append_blocks(self, n_records: int) -> int:
        """Journal-blocks upper bound for appending ``n_records`` (the
        reservation padding for chain scopes), via the inner fs's
        log-allocation hook; +6 when the log file itself must be created
        inside the same transaction."""
        if n_records == 0:
            return 0
        est = self.inner.estimate_append_blocks(n_records * _REC_BYTES_EST)
        if self._log_ino == 0:  # lazy log creation joins the transaction
            est += getattr(self.inner, "_CHAIN_OP_BLOCKS", {}).get("create", 6)
        return est

    @contextlib.contextmanager
    def _txn_scope(self, op: str):
        """One journal transaction spanning a scalar namespace mutation AND
        its provenance record (the old-XOR-new guarantee). Reuses the chain
        reservation machinery: commits requested inside the scope defer to
        its close, so neither the group-commit heuristic nor the per-op
        commit policy can tear mutation from record. No-ops when a chain
        scope is already open on THIS thread (the chain IS the transaction)
        or when the combined footprint could never fit (degrades to
        record-after ordering, which still keeps the log explainable)."""
        j = self.journal
        oplock = getattr(self.inner, "_oplock", None)
        if j is None or oplock is None:
            yield
            return
        # take the fs lock BEFORE inspecting chain state — and ask about
        # THIS thread's chain scope specifically (in_chain_here): with
        # sharded lock domains another thread's chain can be open
        # concurrently, and it must not suppress our one-txn scope
        oplock.acquire()
        opened = False
        try:
            if not j.in_chain_here:
                est = (getattr(self.inner, "_CHAIN_OP_BLOCKS", {})
                       .get(op, 16) + self._append_blocks(1))
                try:
                    j.begin_chain(est)
                    opened = True
                except FsError:
                    pass  # tiny journal: fall back to ordered-append only
            yield
        finally:
            if opened:
                j.end_chain()
            oplock.release()

    # --- namespace guards (the log hides from the tree) ---------------------------
    @staticmethod
    def _guard_name(parent: int, name) -> bool:
        return parent == ROOT_INO and name in (PROV_LOG_NAME, PROV_LOG_TMP)

    def _guard_entry(self, e: SubmissionEntry) -> Optional[Errno]:
        """Errno for entries that touch the reserved log name (None for the
        overwhelmingly common clean case)."""
        kw = e.kwargs or {}

        def arg(i, k):
            return e.args[i] if len(e.args) > i else kw.get(k)

        if e.op in ("lookup", "unlink", "rmdir"):
            if self._guard_name(arg(0, "parent"), arg(1, "name")):
                return Errno.ENOENT
        elif e.op in ("create", "mkdir"):
            if self._guard_name(arg(0, "parent"), arg(1, "name")):
                return Errno.EINVAL
        elif e.op == "rename":
            if self._guard_name(arg(0, "parent"), arg(1, "name")):
                return Errno.ENOENT
            if self._guard_name(arg(2, "newparent"), arg(3, "newname")):
                return Errno.EINVAL
        return None

    # --- scalar ops ----------------------------------------------------------------
    # reads delegate straight through; namespace mutations run in a
    # one-transaction scope with their record; data mutations record after
    # (ordered staging keeps the log explainable without capping write size)

    def getattr(self, ino: int) -> Attr:
        return self.inner.getattr(ino)

    def lookup(self, parent: int, name: str) -> Attr:
        if self._guard_name(parent, name):
            raise FsError(Errno.ENOENT, name)
        return self.inner.lookup(parent, name)

    def readdir(self, ino: int) -> List[Tuple[str, int, FileKind]]:
        out = self.inner.readdir(ino)
        if ino == ROOT_INO:
            out = [e for e in out
                   if e[0] not in (PROV_LOG_NAME, PROV_LOG_TMP)]
        return out

    def read(self, ino: int, off: int, size: int) -> bytes:
        return self.inner.read(ino, off, size)

    def statfs(self) -> Dict[str, int]:
        return self.inner.statfs()

    def fsync(self, ino: int) -> None:
        self.inner.fsync(ino)

    def flush(self) -> None:
        self.inner.flush()

    def create(self, parent: int, name: str) -> Attr:
        if self._guard_name(parent, name):
            raise FsError(Errno.EINVAL, f"{name} is reserved")
        with self._txn_scope("create"):
            attr = self.inner.create(parent, name)
            self._append([self._rec("create", ino=attr.ino, parent=parent,
                                    name=name)])
        return attr

    def mkdir(self, parent: int, name: str) -> Attr:
        if self._guard_name(parent, name):
            raise FsError(Errno.EINVAL, f"{name} is reserved")
        with self._txn_scope("mkdir"):
            attr = self.inner.mkdir(parent, name)
            self._append([self._rec("mkdir", ino=attr.ino, parent=parent,
                                    name=name)])
        return attr

    def unlink(self, parent: int, name: str) -> None:
        if self._guard_name(parent, name):
            raise FsError(Errno.ENOENT, name)
        with self._txn_scope("unlink"):
            self.inner.unlink(parent, name)
            self._append([self._rec("unlink", parent=parent, name=name)])

    def rmdir(self, parent: int, name: str) -> None:
        if self._guard_name(parent, name):
            raise FsError(Errno.ENOENT, name)
        with self._txn_scope("rmdir"):
            self.inner.rmdir(parent, name)
            self._append([self._rec("rmdir", parent=parent, name=name)])

    def rename(self, parent: int, name: str, newparent: int,
               newname: str) -> None:
        if self._guard_name(parent, name):
            raise FsError(Errno.ENOENT, name)
        if self._guard_name(newparent, newname):
            raise FsError(Errno.EINVAL, f"{newname} is reserved")
        with self._txn_scope("rename"):
            self.inner.rename(parent, name, newparent, newname)
            self._append([self._rec("rename", parent=parent, name=name,
                                    newparent=newparent, newname=newname)])

    def write(self, ino: int, off: int, data: bytes) -> int:
        n = self.inner.write(ino, off, data)
        self._append([self._rec("write", ino=ino, off=off, len=n)])
        return n

    def truncate(self, ino: int, size: int) -> None:
        self.inner.truncate(ino, size)
        self._append([self._rec("truncate", ino=ino, size=size)])

    # --- batched boundary -----------------------------------------------------------
    def submit_batch(self, entries) -> List[CompletionEntry]:
        """Delegate whole runs to the inner module (its vectorized fast
        paths are the point of the batched boundary), then append one
        combined record batch for the successful mutations — completion
        order IS log order. Two kinds of entry never reach the inner
        module: ones touching the reserved log name complete with their
        guard errno, and ``read_provenance`` entries are answered by THIS
        layer (the inner module would refuse the op it knows nothing
        about), so the batched query path works like the scalar one."""
        if not isinstance(entries, list):
            entries = list(entries)
        if any(e.op == "read_provenance"
               or self._guard_entry(e) is not None for e in entries):
            comps: List[CompletionEntry] = []
            for e in entries:  # rare path: per-entry, guards interleaved
                if e.op == "read_provenance":
                    comps.append(self._dispatch_one(e))
                    continue
                g = self._guard_entry(e)
                if g is not None:
                    comps.append(CompletionEntry(e.user_data, errno=g))
                else:
                    comps.extend(self._delegate_run([e]))
            return comps
        return self._delegate_run(entries)

    def _delegate_run(self, entries: List[SubmissionEntry]
                      ) -> List[CompletionEntry]:
        comps = self.inner.submit_batch(entries)
        recs = []
        for e, c in zip(entries, comps):
            if c.errno is not None:
                continue
            if e.op in PROV_MUTATING_OPS:
                recs.append(self._rec_for_entry(e, c))
            elif e.op == "readdir":
                # the log-hiding filter must hold on the batched path too
                ino = e.args[0] if e.args else (e.kwargs or {}).get("ino")
                if ino == ROOT_INO:
                    c.result = [t for t in c.result
                                if t[0] not in (PROV_LOG_NAME, PROV_LOG_TMP)]
        self._append(recs)
        return comps

    def _rec_for_entry(self, e: SubmissionEntry,
                       c: CompletionEntry) -> Dict[str, Any]:
        kw = e.kwargs or {}
        sub = getattr(e, "submitter", None)  # the entry's declared identity

        def arg(i, k, default=0):
            v = e.args[i] if len(e.args) > i else kw.get(k, default)
            return v

        if e.op in ("create", "mkdir"):
            return self._rec(e.op, ino=c.result.ino, parent=arg(0, "parent"),
                             name=arg(1, "name", ""), sub=sub)
        if e.op in ("unlink", "rmdir"):
            return self._rec(e.op, parent=arg(0, "parent"),
                             name=arg(1, "name", ""), sub=sub)
        if e.op == "rename":
            return self._rec("rename", parent=arg(0, "parent"),
                             name=arg(1, "name", ""),
                             newparent=arg(2, "newparent"),
                             newname=arg(3, "newname", ""), sub=sub)
        if e.op == "write":
            return self._rec("write", ino=arg(0, "ino"), off=arg(1, "off"),
                             len=c.result, sub=sub)
        return self._rec("truncate", ino=arg(0, "ino"), size=arg(1, "size"),
                         sub=sub)

    # --- chain hooks: one txn spans data + provenance --------------------------------
    def chain_begin(self, entries) -> Optional[Errno]:
        if self.journal is None:  # non-journaled inner: plain forwarding
            return self.inner.chain_begin(entries)
        n_mut = sum(1 for e in entries if e.op in PROV_MUTATING_OPS)
        return self.inner.chain_begin(
            entries, extra_blocks=self._append_blocks(n_mut))

    def chain_end(self) -> None:
        self.inner.chain_end()

    # --- lock-domain hooks: scheduling delegates to the inner fs ---------------------
    def group_footprint(self, entries):
        """Parallel-drain footprint — the inner module's own estimate.
        Every mutating group carries the inner fs's ALLOC domain, which
        also serializes this layer's log appends (the log inode is not in
        any footprint, but only ALLOC holders write it); read_provenance
        is unknown to the inner estimator and maps to None, the global
        exclusive lock."""
        fn = getattr(self.inner, "group_footprint", None)
        return fn(entries) if fn is not None else None

    def domain_scope(self, footprint):
        return self.inner.domain_scope(footprint)

    # --- the query op -----------------------------------------------------------------
    def _rescan(self) -> None:
        """Full-log scan rebuilding the line-offset index and the seq base
        (a head ``_rotate`` marker, when present, supplies the base and is
        itself absorbed — never indexed, never returned)."""
        raw = self.inner.read(self._log_ino, 0, self._log_size)
        offsets: List[int] = []
        base = 0
        pos = 0
        for i, line in enumerate(raw.split(b"\n")[:-1]):  # complete lines
            if i == 0:
                try:
                    r = json.loads(line)
                except ValueError:
                    r = None
                if isinstance(r, dict) and r.get("op") == "_rotate":
                    base = int(r.get("base", 0))
                    pos += len(line) + 1
                    continue
            offsets.append(pos)
            pos += len(line) + 1
        self._line_index = offsets
        self._seq_base = base

    def read_provenance(self, since: int = 0, offset: int = 0,
                        limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """Records with ``seq >= since`` in append (== execution) order;
        ``offset`` skips that many records of the selection and ``limit``
        caps the page size, so a consumer can walk an arbitrarily large log
        in bounded payloads (``since=last_seq+1`` between polls, or fixed
        ``since`` with a sliding ``offset``). Reads through the journal
        overlay, so records of not-yet-committed mutations are visible to a
        live query — durability follows the data's fsync, exactly like the
        mutations themselves. The line-offset index (kept current by
        ``_append``, rebuilt after drops/rotation) turns any page into ONE
        ranged read of exactly the lines requested. Records dropped by
        rotation are simply absent: a ``since`` below the retained base
        returns from the oldest survivor. Unparseable lines (a dropped
        append's torn tail) are skipped, never fatal."""
        if offset < 0 or (limit is not None and limit < 0):
            raise FsError(Errno.EINVAL, "negative offset/limit")
        oplock = getattr(self.inner, "_oplock", None) or contextlib.nullcontext()
        with oplock, self._plock:  # same order as _append: oplock -> plock
            if self._log_ino == 0:
                self._discover_log()
            if self._log_ino == 0:
                return []
            if self._line_index is None:
                self._rescan()
            idx, base = self._line_index, self._seq_base
            pos = max(since - base, 0) + offset
            end = len(idx) if limit is None else min(pos + limit, len(idx))
            if pos >= end:
                return []
            start_b = idx[pos]
            end_b = idx[end] if end < len(idx) else self._log_size
            raw = self.inner.read(self._log_ino, start_b, end_b - start_b)
            out = []
            for i, line in enumerate(raw.split(b"\n")[:-1]):
                try:
                    r = json.loads(line)
                except ValueError:
                    continue
                r["seq"] = base + pos + i
                out.append(r)
            return out
