"""The xv6 file system on the Bento file-operations API.

Faithful to the paper's evaluation vehicle: journaling (data=journal, like
the paper's ext4 mount), 12 direct + indirect + double-indirect addressing
(their 4 GB-file extension), locks around inode/block allocation (their
race fix), fixed-size directory entries.

One implementation, policy-parameterized, mounted three ways by the
benchmark matrix (see repro_torch.fs.mounts):
  * bento  — group commit + batched (`writepages`) install,
  * vfs    — per-operation commit + synchronous install ("the VFS baseline
             was just written for this evaluation" — paper §6),
  * fuse   — same code behind a subprocess serialization bridge.

Domain-lock protocol (killing the big fs lock)
----------------------------------------------
The paper ports xv6 by "adding locks" — one big fs lock. This module
shards it into LOCK DOMAINS, the way multi-queue block drivers shard a
single request lock by CPU:

  * the namespace is striped by inode number (``LockDomainTable``:
    N_STRIPES per-stripe locks), and
  * three special domains name the state every mutator shares: ``ALLOC``
    (block/inode allocator + journal staging), ``BLOCKSTORE`` (the dedup
    index), ``PROV`` (a stacked provenance log).

``group_footprint(entries)`` maps one dispatch group to the frozenset of
domains it can touch — computed from the submission entries alone, the
same shape inspection ``estimate_chain_blocks`` uses — or ``None`` when
the entries cannot prove a bound (rename/unlink rewrite foreign stripes,
PrevResult-fed arguments resolve at run time, statfs scans the world).
A parallel drainer (core.interface.execute_multi_batch with a worker
pool) runs each group inside ``domain_scope(footprint)``: global-SHARED
plus the footprint's stripe/special locks for a provable footprint,
global-EXCLUSIVE for ``None``. Scalar callers and every pre-existing
code path still ``with self._oplock`` — outside a scope that takes
global-EXCLUSIVE (the old big-lock semantics, reentrant); inside a scope
it is a no-op because the scope already holds everything the footprint
needs.

Soundness hangs on one invariant: EVERY mutating footprint includes
``ALLOC``, so at most one dispatch group stages journal blocks at any
moment — ``Journal`` commit stays the only global serialization point,
member-abort rollback can never clobber a concurrent group's staging,
and inode-table read-modify-writes are serialized without a lock of
their own. Read-only groups on disjoint stripes run fully concurrently.
"""

from __future__ import annotations

import contextlib
import dataclasses
import struct
import threading
from typing import Dict, FrozenSet, List, Optional, Tuple

from repro_torch.core.capability import SuperBlockCap
from repro_torch.core.interface import (Attr, BentoFilesystem, CompletionEntry,
                                  Errno, FileKind, FsError, PrevResult,
                                  ROOT_INO, SubmissionEntry)
from repro_torch.fs import layout as L
from repro_torch.fs.blockstore import BlockStore, DEDUP_TABLE_NAME
from repro_torch.fs.journal import Journal, JournalFull


MAXOP_BLOCKS = 16  # journal blocks one (sub-)operation may touch


@dataclasses.dataclass(frozen=True)
class Xv6Options:
    group_commit: bool = True  # False: commit at end of every operation
    batched_install: bool = True  # writepages-style journal install
    commit_threshold: float = 0.75  # commit when journal this full
    dedup: bool = False  # content-addressed data plane (repro_torch.fs.blockstore)


def mkfs(services, ninodes: int = 4096, nlog: int = 64) -> None:
    """Format the device: superblock, journal, inode table, bitmap, root."""
    sb_cap = services.superblock()
    n = sb_cap.n_blocks
    geo = L.geometry(n, ninodes=ninodes, nlog=nlog)
    with services.sb_getblk_zero(sb_cap, 0) as bh:
        bh.data()[:] = geo.pack()
        services.bwrite_sync(sb_cap, bh)
    # zero journal + inode table + bitmap
    for b in range(geo.logstart, geo.datastart):
        with services.sb_getblk_zero(sb_cap, b) as bh:
            services.bwrite_sync(sb_cap, bh)
    # mark metadata blocks used in the bitmap
    used = geo.datastart
    for b in range(used):
        _bitmap_set(services, sb_cap, geo, b, True)
    # root directory inode
    root = L.DiskInode(type=L.T_DIR, nlink=2, size=0)
    _write_inode_raw(services, sb_cap, geo, ROOT_INO, root)


def _bitmap_set(services, sb_cap, geo: L.SuperBlock, blockno: int, used: bool):
    bmblock = geo.bmapstart + blockno // (L.BSIZE * 8)
    bit = blockno % (L.BSIZE * 8)
    with services.sb_bread(sb_cap, bmblock) as bh:
        buf = bh.data()
        if used:
            buf[bit // 8] |= 1 << (bit % 8)
        else:
            buf[bit // 8] &= ~(1 << (bit % 8))
        services.bwrite_sync(sb_cap, bh)


def _write_inode_raw(services, sb_cap, geo, ino: int, di: L.DiskInode) -> None:
    blk = geo.inodestart + ino // L.IPB
    off = (ino % L.IPB) * L.INODE_SIZE
    with services.sb_bread(sb_cap, blk) as bh:
        bh.data()[off: off + L.INODE_SIZE] = di.pack()
        services.bwrite_sync(sb_cap, bh)


class _SharedExclusiveLock:
    """Writer-preferring shared/exclusive lock. Exclusive mode is
    reentrant per owning thread (the scalar paths nest ``_oplock``
    acquisitions: chain scope -> member dispatch -> scalar op). Shared
    mode is taken exactly once per domain scope and never re-entered —
    while a footprint is installed the ``_oplock`` handle's acquire is a
    no-op."""

    __slots__ = ("_lk", "_cond", "_readers", "_writer", "_depth",
                 "_waiting", "_parked")

    def __init__(self):
        # a plain Lock (not the Condition's default RLock) and direct
        # acquire/release: the uncontended exclusive round trip is THE
        # scalar-path hot lock (it replaced a bare RLock), so every
        # Python frame here is paid by every fs op
        self._lk = threading.Lock()
        self._cond = threading.Condition(self._lk)
        self._readers = 0
        self._writer = None   # owning tid while exclusive
        self._depth = 0       # exclusive reentrancy depth
        self._waiting = 0     # parked writers (block NEW readers)
        self._parked = 0      # threads inside a cond.wait (gate notify)

    def acquire_shared(self) -> None:
        lk = self._lk
        lk.acquire()
        try:
            if self._writer == threading.get_ident():
                self._depth += 1  # exclusive is stronger: just nest
                return
            while self._writer is not None or self._waiting:
                self._parked += 1
                try:
                    self._cond.wait()
                finally:
                    self._parked -= 1
            self._readers += 1
        finally:
            lk.release()

    def release_shared(self) -> None:
        lk = self._lk
        lk.acquire()
        try:
            if self._writer == threading.get_ident():
                self._depth -= 1
                return
            self._readers -= 1
            if not self._readers and self._parked:
                self._cond.notify_all()
        finally:
            lk.release()

    def acquire_exclusive(self) -> None:
        tid = threading.get_ident()
        lk = self._lk
        lk.acquire()
        if self._writer is None and not self._readers:
            # uncontended fast path (no cond bookkeeping, no waiters to
            # defer to — writers never queue behind parked writers)
            self._writer = tid
            self._depth = 1
            lk.release()
            return
        try:
            if self._writer == tid:
                self._depth += 1
                return
            self._waiting += 1
            try:
                while self._writer is not None or self._readers:
                    self._parked += 1
                    try:
                        self._cond.wait()
                    finally:
                        self._parked -= 1
            finally:
                self._waiting -= 1
            self._writer = tid
            self._depth = 1
        finally:
            lk.release()

    def release_exclusive(self) -> None:
        lk = self._lk
        lk.acquire()
        self._depth -= 1
        if not self._depth:
            self._writer = None
            if self._parked:
                self._cond.notify_all()
        lk.release()


class LockDomainTable:
    """Sharded fs-lock domains — the multi-queue answer to the paper's
    one big lock. The namespace is striped by inode number; three special
    domains name the state every mutator shares:

      * ``ALLOC``      — block/inode allocator + journal staging. Every
                         mutating footprint includes it, so at most one
                         dispatch group stages journal blocks at a time
                         and ``Journal`` commit stays the only global
                         serialization point.
      * ``BLOCKSTORE`` — the dedup index + batch scope (dedup mounts).
      * ``PROV``       — a stacked provenance layer's log (repro_torch.fs.prov).

    A dispatch group either presents a *footprint* (frozenset of domain
    keys: acquire global-SHARED plus those locks, in one fixed order) or
    ``None`` (acquire global-EXCLUSIVE — the old big-lock behaviour).
    Non-overlapping footprints run concurrently; anything the estimator
    cannot pin falls back to exclusive and serializes with everyone."""

    N_STRIPES = 16
    ALLOC = "alloc"
    BLOCKSTORE = "blockstore"
    PROV = "prov"
    _SPECIALS = (ALLOC, BLOCKSTORE, PROV)

    def __init__(self, n_stripes: int = N_STRIPES):
        self.n_stripes = n_stripes
        self.shared_excl = _SharedExclusiveLock()
        self._stripes = [threading.RLock() for _ in range(n_stripes)]
        self._special = {name: threading.RLock() for name in self._SPECIALS}

    def stripe(self, ino: int) -> int:
        """Domain key for one inode's namespace stripe."""
        return ino % self.n_stripes

    def _lock(self, key):
        return (self._special[key] if isinstance(key, str)
                else self._stripes[key])

    @staticmethod
    def _order(key):
        # one global acquisition order: special domains first (by name),
        # then stripes ascending — all scopes sort the same way, so two
        # overlapping footprints can never deadlock on each other
        return (0, key) if isinstance(key, str) else (1, key)

    @contextlib.contextmanager
    def scope(self, footprint, tls):
        """Bracket ONE dispatch unit. ``tls`` is the ``_oplock`` handle's
        thread-local state: installing the footprint there turns every
        ``_oplock`` acquire inside the unit into a no-op (this scope
        already holds all the locks the footprint names)."""
        if footprint is None:
            self.shared_excl.acquire_exclusive()
            try:
                yield
            finally:
                self.shared_excl.release_exclusive()
            return
        self.shared_excl.acquire_shared()
        held = []
        try:
            for key in sorted(footprint, key=self._order):
                lk = self._lock(key)
                lk.acquire()
                held.append(lk)
            prev = getattr(tls, "domains", None)
            tls.domains = footprint
            try:
                yield
            finally:
                tls.domains = prev
        finally:
            for lk in reversed(held):
                lk.release()
            self.shared_excl.release_shared()


class _DomainTls(threading.local):
    # class default makes the per-op check a plain attribute load —
    # getattr-with-default on a bare threading.local costs an extra
    # dict probe on EVERY acquire/release of the hot big-lock path
    domains = None


class _DomainLockHandle:
    """Drop-in for the old ``threading.RLock`` big fs lock. Outside a
    domain scope, ``acquire``/``release`` take the table's global
    EXCLUSIVE mode — one lock, the big-lock semantics (and reentrant,
    which the scalar paths and repro_torch.fs.prov rely on). Inside a domain
    scope (a parallel-drain worker with a footprint installed) they are
    no-ops: the scope holds global-shared plus every stripe and special
    domain the unit's footprint names, so the unchanged fs code bodies
    run already-locked."""

    __slots__ = ("_table", "_tls", "_se")

    def __init__(self, table: LockDomainTable):
        self._table = table
        self._tls = _DomainTls()
        self._se = table.shared_excl

    @property
    def installed_domains(self):
        """The footprint installed for THIS thread (None outside scopes)."""
        return self._tls.domains

    def acquire(self) -> bool:
        if self._tls.domains is None:
            self._se.acquire_exclusive()
        return True

    def release(self) -> None:
        if self._tls.domains is None:
            self._se.release_exclusive()

    # __enter__/__exit__ inline the uncontended-exclusive fast path: the
    # `with self._oplock:` bracket replaced a bare C RLock on EVERY fs op,
    # so each avoided Python frame here is a measurable share of scalar
    # throughput (the slow paths defer to _SharedExclusiveLock unchanged)

    def __enter__(self):
        if self._tls.domains is None:
            se = self._se
            lk = se._lk
            lk.acquire()
            if se._writer is None and not se._readers:
                se._writer = threading.get_ident()
                se._depth = 1
                lk.release()
            else:
                lk.release()
                se.acquire_exclusive()
        return self

    def __exit__(self, *exc) -> None:
        if self._tls.domains is None:
            se = self._se
            lk = se._lk
            lk.acquire()
            se._depth -= 1
            if not se._depth:
                se._writer = None
                if se._parked:
                    se._cond.notify_all()
            lk.release()


class Xv6FileSystem(BentoFilesystem):
    NAME = "xv6"
    VERSION = 1

    def __init__(self, options: Xv6Options = Xv6Options()):
        self.opts = options
        self.ks = None
        self.sb_cap: Optional[SuperBlockCap] = None
        self.geo: Optional[L.SuperBlock] = None
        self.journal: Optional[Journal] = None
        # big fs lock (paper: added locks) — sharded into lock domains;
        # plain acquire() is the global-exclusive mode (see module doc)
        self._domains = LockDomainTable()
        self._oplock = _DomainLockHandle(self._domains)
        self._alloc_lock = threading.RLock()
        self._stats_lock = threading.Lock()  # read units race on counters
        self._icache: Dict[int, L.DiskInode] = {}
        self._free_hint = 0
        self._free_inode_hint = 2
        self.stats = {"ops": 0, "commits_forced": 0}
        self._blockstore: Optional[BlockStore] = None
        self._current_submitter = None  # stamped per run by submit_batch
        # dedup widens the per-write metadata footprint (CoW copy block +
        # index-table blocks) — reservations must cover it
        self._chain_write_overhead = (self._CHAIN_WRITE_OVERHEAD
                                      + (3 if options.dedup else 0))

    # --- lifecycle -----------------------------------------------------------------
    def init(self, sb: SuperBlockCap, services) -> None:
        self.ks = services
        self.sb_cap = sb
        with services.sb_bread(sb, 0) as bh:
            self.geo = L.SuperBlock.unpack(bytes(bh.data()))
        if self.geo.magic != L.FSMAGIC:
            raise FsError(Errno.EINVAL, "bad magic: not an xv6 filesystem")
        self.journal = Journal(services, sb, self.geo,
                               batched_install=self.opts.batched_install)
        # after any journal rollback (op-scope overflow or chain-member
        # abort) the in-memory caches may reflect the rolled-back staging
        self.journal.rollback_listener = self._after_journal_rollback
        self.journal.recover()
        if self.opts.dedup:
            self._blockstore = BlockStore(self)
            self._blockstore.attach()

    def destroy(self) -> None:
        if self.journal:
            self.journal.commit()
        if self.ks and self.sb_cap:
            self.ks.flush(self.sb_cap)

    # --- §4.8 state transfer ------------------------------------------------------------
    def extract_state(self) -> Dict:
        self._dedup_drain()  # settle the index before quiescing
        self.flush()  # quiesced by the runtime; drain to a clean point
        state = {
            "icache": {ino: dataclasses.asdict(di)
                       for ino, di in self._icache.items()},
            "free_hint": self._free_hint,
            "free_inode_hint": self._free_inode_hint,
            "journal": self.journal.extract_state(),
            "stats": dict(self.stats),
        }
        if self._blockstore is not None:
            state["dedup"] = self._blockstore.extract_state()
        return state

    def restore_state(self, state: Dict, from_version: int) -> None:
        self._icache = {int(k): L.DiskInode(**v)
                        for k, v in state.get("icache", {}).items()}
        self._free_hint = state.get("free_hint", 0)
        self._free_inode_hint = state.get("free_inode_hint", 2)
        self.journal.restore_state(state.get("journal", {}))
        self.stats.update(state.get("stats", {}))
        if self._blockstore is not None and "dedup" in state:
            self._blockstore.restore_state(state["dedup"])

    def state_schema(self) -> Tuple[str, ...]:
        base = ("icache", "free_hint", "free_inode_hint", "journal", "stats")
        return base + ("dedup",) if self.opts.dedup else base

    def optional_state_keys(self) -> Tuple[str, ...]:
        # a dedup mount can absorb state from a plain predecessor (the
        # index reloads from the device) and vice versa
        return ("dedup",)

    # --- journal-aware block IO -----------------------------------------------------------
    def _bread(self, blockno: int):
        bh = self.ks.sb_bread(self.sb_cap, blockno)
        pend = self.journal.pending_get(blockno)
        if pend is not None and bytes(bh.data()) != pend:
            bh.data()[:] = pend
        return bh

    def _log(self, blockno: int, data: bytes) -> None:
        self.journal.log_write(blockno, data)

    def _begin_op(self) -> None:
        """Reserve journal space for one (sub-)operation — commits the
        running transaction first if it could not absorb MAXOP_BLOCKS more
        (xv6 begin_op), so operations are never torn across commits.

        Inside a chain scope this is a no-op: ``chain_begin`` already
        reserved the WHOLE chain's footprint, and a mid-chain commit here
        would tear the chain across two transactions. The check is
        per-thread (``in_chain_here``): another thread's open chain must
        not suppress THIS operation's reservation."""
        if self.journal.in_chain_here:
            return
        if len(self.journal._pending) + MAXOP_BLOCKS >= self.journal.capacity:
            self.stats["commits_forced"] += 1
            self.journal.commit()
        self.journal.begin_op_scope()  # overflow rolls back to this point

    def _end_op(self, mutated: bool) -> None:
        with self._stats_lock:  # concurrent read units share the counter
            self.stats["ops"] += 1
        if not mutated:
            return
        store = self._blockstore
        if store is not None and store.compaction_due():
            # churn (unlinks/truncates) left whole index blocks dead:
            # punch them inside THIS op's transaction, before any commit
            # below — the same crash-atomicity as the mutation itself
            store._maybe_compact()
        if self.journal.in_chain_here:
            # per-op commit policy (the VFS baseline) defers to end_chain —
            # one transaction per chain; the group-commit threshold
            # heuristic simply waits until the chain closes.
            if not self.opts.group_commit:
                self.journal.commit()
            return
        if not self.opts.group_commit:
            self.journal.commit()
        elif len(self.journal._pending) >= int(
                self.journal.capacity * self.opts.commit_threshold):
            self.stats["commits_forced"] += 1
            self.journal.commit()

    # --- chain-scoped reservation (SQE_LINK chains as one journal txn) --------------
    #
    # ``execute_batch`` calls chain_begin/chain_end around every chain
    # group. The estimate is an upper bound computed from the submission
    # entries (data blocks + per-op metadata overhead); absorption makes
    # the real footprint smaller. The fs lock is held for the WHOLE chain
    # scope so no concurrent op can slip a commit between two members (the
    # members re-enter it, it is reentrant).

    _CHAIN_WRITE_OVERHEAD = 4  # inode + bitmap + up to 2 indirect blocks
    _CHAIN_OP_BLOCKS = {
        # rename may also truncate a displaced target (dirent swap + two
        # parent inodes + displaced inode + bitmap blocks of freed data)
        "create": 6, "mkdir": 8, "unlink": 6, "rmdir": 8, "rename": 12,
        "getattr": 0, "lookup": 0, "read": 0, "readdir": 0, "statfs": 0,
        "fsync": 0, "flush": 0,
    }

    def _chain_entry_blocks(self, e: SubmissionEntry) -> int:
        if e.op == "write":
            kw = e.kwargs or {}
            off = e.args[1] if len(e.args) > 1 else kw.get("off")
            data = e.args[2] if len(e.args) > 2 else kw.get("data")
            if not isinstance(data, (bytes, bytearray)):
                return MAXOP_BLOCKS  # PrevResult/malformed payload: worst case
            start = off % L.BSIZE if isinstance(off, int) else 0
            nblocks = (start + len(data) + L.BSIZE - 1) // L.BSIZE
            return nblocks + self._chain_write_overhead
        return self._CHAIN_OP_BLOCKS.get(e.op, MAXOP_BLOCKS)

    def estimate_chain_blocks(self, entries) -> int:
        """Journal-blocks upper bound for a chain, from its entries."""
        return sum(self._chain_entry_blocks(e) for e in entries)

    def estimate_append_blocks(self, nbytes: int) -> int:
        """Journal-blocks upper bound for appending ``nbytes`` to an
        existing file — the log-block allocation hook a stacked layer
        (repro_torch.fs.prov) uses to size the provenance records it will add to
        a reservation. Data blocks (+1 for a straddled boundary) plus this
        fs's per-write metadata overhead; subclasses with costlier write
        paths inherit their own ``_CHAIN_WRITE_OVERHEAD``."""
        return (nbytes + L.BSIZE - 1) // L.BSIZE + 1 + self._chain_write_overhead

    def chain_begin(self, entries, extra_blocks: int = 0):
        """Reserve ONE journal transaction for a whole chain group.
        ``extra_blocks`` is the stacked-layer hook: a wrapper that will
        stage additional blocks inside the same transaction (provenance
        records) adds its footprint to the reservation, so the atomicity
        estimate covers BOTH layers or the chain is refused up front."""
        est = self.estimate_chain_blocks(entries) + extra_blocks
        self._oplock.acquire()
        try:
            self.journal.begin_chain(est)
        except JournalFull as e:
            self._oplock.release()
            return e.errno  # ENOSPC before anything was staged
        except BaseException:
            # e.g. a device error inside the pre-chain commit: the scope
            # never opened, so execute_batch will not call chain_end —
            # release here or the fs lock leaks
            self._oplock.release()
            raise
        if self._blockstore is not None:
            self._blockstore.batch_begin()
        return None

    def chain_end(self) -> None:
        try:
            store = self._blockstore
            if store is not None and store.batch_dec() == 0:
                # dedup pass INSIDE the chain transaction: sharing rewrites
                # commit atomically with the writes that produced them
                store.flush_pending()
            self.journal.end_chain()  # runs any deferred (in-chain) commit
        finally:
            self._oplock.release()

    # --- lock-domain footprints (parallel multi-submitter drain) --------------------
    #
    # The parallel drainer keys its scheduling off these: two dispatch
    # groups whose footprints are disjoint run concurrently on worker
    # threads, overlapping (or unprovable) ones keep their submission
    # order. Computed from the entries alone — the same shape inspection
    # estimate_chain_blocks uses — never from live fs state.

    def _entry_domains(self, e: SubmissionEntry) -> Optional[set]:
        """Domain keys one submission entry can touch; None = not
        provable from the entry (global exclusive)."""
        if e.kwargs:
            return None  # kwargs entries keep scalar dispatch: not proven
        args = e.args
        if any(isinstance(a, PrevResult) for a in args):
            return None  # the target inode resolves at run time
        op = e.op
        if op in ("read", "getattr", "readdir", "lookup"):
            # read-only on one inode (lookup: the parent directory)
            if not args or not isinstance(args[0], int):
                return None
            doms = {self._domains.stripe(args[0])}
        elif op in ("write", "truncate", "fsync", "create", "mkdir"):
            # mutators: the op's stripe (create/mkdir: the parent's) plus
            # ALLOC — the invariant that keeps journal staging serial
            if not args or not isinstance(args[0], int):
                return None
            doms = {self._domains.stripe(args[0]), LockDomainTable.ALLOC}
        elif op == "flush":
            doms = {LockDomainTable.ALLOC}
        else:
            # unlink/rmdir/rename free inodes and rewrite foreign
            # stripes, statfs scans the world, unknown ops prove nothing
            return None
        if self._blockstore is not None:
            # every dispatch on a dedup mount opens a blockstore batch
            # scope (shared depth counter, pending set, verify stats)
            doms.add(LockDomainTable.BLOCKSTORE)
        return doms

    def group_footprint(self, entries) -> Optional[FrozenSet]:
        """Footprint of ONE dispatch group (union over its entries), or
        None when any entry needs the global exclusive lock."""
        out: set = set()
        for e in entries:
            d = self._entry_domains(e)
            if d is None:
                return None
            out |= d
        return frozenset(out)

    def domain_scope(self, footprint):
        """Context manager a parallel drainer wraps around one dispatch
        group: acquires the footprint's locks (or global exclusive for
        None) and installs the footprint thread-locally so the unchanged
        ``with self._oplock`` bodies inside run as no-ops."""
        return self._domains.scope(footprint, self._oplock._tls)

    # --- inodes ---------------------------------------------------------------------------
    def _iget(self, ino: int) -> L.DiskInode:
        if not (0 < ino < self.geo.ninodes):
            raise FsError(Errno.ESTALE, f"bad ino {ino}")
        di = self._icache.get(ino)
        if di is None:
            blk = self.geo.inodestart + ino // L.IPB
            off = (ino % L.IPB) * L.INODE_SIZE
            with self._bread(blk) as bh:
                di = L.DiskInode.unpack(bytes(bh.data()), off)
            self._icache[ino] = di
        return di

    def _iupdate(self, ino: int, di: L.DiskInode) -> None:
        self._icache[ino] = di
        blk = self.geo.inodestart + ino // L.IPB
        off = (ino % L.IPB) * L.INODE_SIZE
        with self._bread(blk) as bh:
            bh.data()[off: off + L.INODE_SIZE] = di.pack()
            self._log(blk, bytes(bh.data()))

    def _ialloc(self, kind: int) -> int:
        with self._alloc_lock:  # paper: lock around inode allocation
            start = self._free_inode_hint
            for delta in range(self.geo.ninodes - 2):
                ino = 2 + (start - 2 + delta) % (self.geo.ninodes - 2)
                di = self._iget(ino)
                if di.type == L.T_FREE:
                    ndi = L.DiskInode(type=kind, nlink=1)
                    self._iupdate(ino, ndi)
                    self._free_inode_hint = ino + 1
                    return ino
            raise FsError(Errno.ENOSPC, "out of inodes")

    # --- block allocator ----------------------------------------------------------------------
    def _balloc(self) -> int:
        with self._alloc_lock:  # paper: lock around block allocation
            total = self.geo.size
            bits_per = L.BSIZE * 8
            start = max(self._free_hint, self.geo.datastart)
            for delta in range(total - self.geo.datastart):
                b = self.geo.datastart + (start - self.geo.datastart + delta) % (
                    total - self.geo.datastart)
                bmblock = self.geo.bmapstart + b // bits_per
                bit = b % bits_per
                with self._bread(bmblock) as bh:
                    buf = bh.data()
                    if not (buf[bit // 8] >> (bit % 8)) & 1:
                        buf[bit // 8] |= 1 << (bit % 8)
                        self._log(bmblock, bytes(buf))
                        self._free_hint = b + 1
                        # zero the block (journaled)
                        self._log(b, bytes(L.BSIZE))
                        return b
            raise FsError(Errno.ENOSPC, "device full")

    def _bfree_raw(self, b: int) -> None:
        """Clear the bitmap bit — the physical free, no refcounting."""
        with self._alloc_lock:
            bits_per = L.BSIZE * 8
            bmblock = self.geo.bmapstart + b // bits_per
            bit = b % bits_per
            with self._bread(bmblock) as bh:
                buf = bh.data()
                buf[bit // 8] &= ~(1 << (bit % 8))
                self._log(bmblock, bytes(buf))
            self._free_hint = min(self._free_hint, b)

    def _bfree(self, b: int) -> None:
        """Drop a reference to ``b``. On dedup mounts a shared block just
        loses one index reference (staged in this op's transaction); the
        bitmap bit clears only with the LAST reference."""
        if self._blockstore is not None and not self._blockstore.release(b):
            return
        self._bfree_raw(b)

    # --- bmap: logical file block -> device block ----------------------------------------------
    def _bmap(self, ino: int, di: L.DiskInode, bn: int, alloc: bool) -> int:
        NI = L.NINDIRECT
        if bn < L.NDIRECT:
            if di.addrs[bn] == 0:
                if not alloc:
                    return 0
                di.addrs[bn] = self._balloc()
                self._iupdate(ino, di)
            return di.addrs[bn]
        bn -= L.NDIRECT
        if bn < NI:
            return self._indirect(ino, di, L.NDIRECT, bn, alloc)
        bn -= NI
        if bn < NI * NI:
            # double indirect
            if di.addrs[L.NDIRECT + 1] == 0:
                if not alloc:
                    return 0
                di.addrs[L.NDIRECT + 1] = self._balloc()
                self._iupdate(ino, di)
            l1 = di.addrs[L.NDIRECT + 1]
            l2 = self._ind_entry(l1, bn // NI, alloc)
            if l2 == 0:
                return 0
            return self._ind_entry(l2, bn % NI, alloc)
        raise FsError(Errno.EFBIG, "file too large")

    def _indirect(self, ino: int, di: L.DiskInode, slot: int, idx: int,
                  alloc: bool) -> int:
        if di.addrs[slot] == 0:
            if not alloc:
                return 0
            di.addrs[slot] = self._balloc()
            self._iupdate(ino, di)
        return self._ind_entry(di.addrs[slot], idx, alloc)

    def _ind_entry(self, indblock: int, idx: int, alloc: bool) -> int:
        import struct
        with self._bread(indblock) as bh:
            buf = bh.data()
            (val,) = struct.unpack_from("<I", buf, idx * 4)
            if val == 0 and alloc:
                val = self._balloc()
                # NB: _balloc may journal this ind block via pending overlay;
                # re-read through the overlay before mutating.
                pend = self.journal.pending_get(indblock)
                if pend is not None:
                    buf[:] = pend
                struct.pack_into("<I", buf, idx * 4, val)
                self._log(indblock, bytes(buf))
        return val

    def _bmap_install(self, ino: int, di: L.DiskInode, bn: int, blk: int) -> None:
        """Point logical block bn at device block blk (journaled) — extent
        preallocation (ext4like) and the blockstore's CoW remapping both
        rewrite existing mappings through this."""
        import struct
        NI = L.NINDIRECT
        if bn < L.NDIRECT:
            di.addrs[bn] = blk
            self._iupdate(ino, di)
            return
        bnn = bn - L.NDIRECT
        if bnn < NI:
            if di.addrs[L.NDIRECT] == 0:
                di.addrs[L.NDIRECT] = self._balloc()
                self._iupdate(ino, di)
            self._ind_set(di.addrs[L.NDIRECT], bnn, blk)
            return
        bnn -= NI
        if di.addrs[L.NDIRECT + 1] == 0:
            di.addrs[L.NDIRECT + 1] = self._balloc()
            self._iupdate(ino, di)
        l2 = self._ind_entry(di.addrs[L.NDIRECT + 1], bnn // NI, alloc=True)
        self._ind_set(l2, bnn % NI, blk)

    def _ind_set(self, indblock: int, idx: int, val: int) -> None:
        import struct
        with self._bread(indblock) as bh:
            buf = bh.data()
            struct.pack_into("<I", buf, idx * 4, val)
            self._log(indblock, bytes(buf))

    def _bmap_clear(self, ino: int, di: L.DiskInode, bn: int) -> None:
        """Punch a hole: drop logical block bn's device mapping
        (journaled). The caller owns freeing the device block — the
        blockstore's index compaction uses this to return fully-dead
        table blocks to the allocator."""
        self._bmap_install(ino, di, bn, 0)

    def _write_block_target(self, ino: int, di: L.DiskInode, bn: int) -> int:
        """Resolve (and allocate) the device block a data write must land
        on. On dedup mounts the blockstore interposes: a shared block is
        CoW-broken to a private copy first, the stored hash is invalidated
        in this same transaction, and the block queues for the batch-end
        dedup pass."""
        b = self._bmap(ino, di, bn, alloc=True)
        if self._blockstore is not None and di.type == L.T_FILE:
            b = self._blockstore.note_write(ino, di, bn, b)
        return b

    # --- batched boundary: vectorized fast paths ------------------------------------------------
    #
    # One submission batch = one fs-lock acquisition, one journal-overlay
    # snapshot, one bulk buffer-cache pass (sb_bread_many). submit_batch
    # coalesces same-op runs into the *_many methods below; results lists
    # carry FsError values in failing slots (per-entry errno isolation).

    _MANY_OPS = {"read": "read_many", "write": "write_many",
                 "getattr": "getattr_many", "lookup": "lookup_many",
                 "create": "create_many", "mkdir": "mkdir_many",
                 "unlink": "unlink_many"}

    # read-only vectorized ops coalesce across submitter stamps: nothing
    # on a read path consumes the attribution (the blockstore and the
    # provenance layer stamp mutations only), so a multi-submitter drain
    # can fuse every submitter's reads into ONE cache pass
    _RO_MANY_OPS = frozenset({"read", "getattr", "lookup"})

    # chain members that can stage journal blocks (and so need the member
    # undo bracket); read-only members and commit-only members (fsync/flush
    # defer their commit to end_chain) skip the two journal-lock round
    # trips — measurable on the chained create→write hot path
    _CHAIN_MUTATING_OPS = frozenset({
        "create", "mkdir", "unlink", "rmdir", "rename", "write", "truncate"})

    def submit_batch(self, entries) -> List[CompletionEntry]:
        if not isinstance(entries, list):
            entries = list(entries)
        store = self._blockstore
        if store is not None:
            store.batch_begin()
        try:
            return self._submit_batch_scoped(entries)
        finally:
            if store is not None:
                self._dedup_batch_end()

    def _submit_batch_scoped(self, entries) -> List[CompletionEntry]:
        if self.journal is not None and self.journal.in_chain_here \
                and any(e.op in self._CHAIN_MUTATING_OPS for e in entries):
            # chain-member dispatch on the chain-owning thread
            # (execute_batch sends members one at a time; a CONCURRENT
            # submitter sees in_chain_here False and takes the plain path,
            # blocking on the fs lock the chain holds): bracket the
            # member's journal staging so a reservation estimate miss
            # (PrevResult-fed payload larger than guessed → JournalFull →
            # ENOSPC) rolls back cleanly — an ENOSPC member stages
            # NOTHING, so a later group commit can never make a torn
            # member durable.
            self.journal.chain_member_begin()
            comps = self._submit_batch_runs(entries)
            if any(c.errno == Errno.ENOSPC for c in comps):
                self.journal.chain_member_abort()  # fires rollback_listener
            else:
                self.journal.chain_member_end()
            return comps
        return self._submit_batch_runs(entries)

    def _after_journal_rollback(self) -> None:
        """Journal rollback listener: in-memory caches may hold the
        rolled-back staging (e.g. a torn write's inflated inode size) —
        drop them; they rebuild through the restored journal overlay.
        Subclasses layer their derived indexes in ``_invalidate_caches_
        after_abort``."""
        self._icache.clear()
        if self._blockstore is not None and self._blockstore._table_blocks:
            # refcounts/hashes staged by the rolled-back transaction are
            # gone from the journal overlay: rebuild from what survived
            self._blockstore.reload()
        self._invalidate_caches_after_abort()

    def _invalidate_caches_after_abort(self) -> None:
        """Subclass hook: drop derived in-memory state after a journal
        rollback (see ext4like's directory index)."""

    def _dedup_batch_end(self) -> None:
        """Close one batch scope; at depth zero, run the deferred dedup
        pass — in the open chain transaction if one is active, else in a
        trailing reservation of its own. Also fires on pure-churn batches
        (no pending writes, but deletions left the index over the
        tombstone threshold) so compaction keeps up with unlink storms."""
        store = self._blockstore
        if store.batch_dec() != 0 or not (store.pending
                                          or store.compaction_due()):
            return
        with self._oplock:
            if self.journal.in_chain_here:
                store.flush_pending()
            else:
                self._begin_op()
                store.flush_pending()
                self._end_op(True)

    def _dedup_drain(self) -> None:
        """Settle any still-pending dedup work (quiesce/extract path)."""
        store = self._blockstore
        if store is None or not store.pending:
            return
        with self._oplock:
            if not self.journal.in_chain_here:
                self._begin_op()
                store.flush_pending()
                self._end_op(True)

    def _submit_batch_runs(self, entries) -> List[CompletionEntry]:
        comps: List[CompletionEntry] = []
        comps_append = comps.append
        many_ops_get = self._MANY_OPS.get
        i, n = 0, len(entries)
        try:
            while i < n:
                # keyword-style entries keep scalar dispatch (the *_many
                # paths are positional); coalesce only positional same-op
                # runs — and, for mutating ops, only entries stamped with
                # the same submitter, so per-submitter attribution stays
                # exact (read-only runs fuse across stamps: _RO_MANY_OPS)
                head = entries[i]
                sub = getattr(head, "submitter", None)
                self._current_submitter = sub
                op = head.op
                many = many_ops_get(op) if not head.kwargs else None
                if many is None:
                    comps_append(self._dispatch_one(head))
                    i += 1
                    continue
                any_sub = op in self._RO_MANY_OPS
                j = i + 1
                while j < n:
                    e = entries[j]
                    if (e.op != op or e.kwargs
                            or not (any_sub
                                    or getattr(e, "submitter", None) == sub)):
                        break
                    j += 1
                run = entries[i:j]
                results = getattr(self, many)([e.args for e in run])
                for e, r in zip(run, results):
                    if isinstance(r, FsError):
                        comps_append(CompletionEntry(e.user_data, errno=r.errno))
                    else:
                        comps_append(CompletionEntry(e.user_data, result=r))
                i = j
        finally:
            self._current_submitter = None
        return comps

    def _bmap_ro(self, di: L.DiskInode, bn: int, ind_cache: Dict[int, bytes]) -> int:
        """Read-only bmap sharing one indirect-block cache across a batch
        (the scalar _bmap takes a cache-lock round trip per indirect hop)."""
        NI = L.NINDIRECT
        if bn < L.NDIRECT:
            return di.addrs[bn]
        bn -= L.NDIRECT
        if bn < NI:
            l1 = di.addrs[L.NDIRECT]
            return self._ind_ro(l1, bn, ind_cache) if l1 else 0
        bn -= NI
        if bn < NI * NI:
            l1 = di.addrs[L.NDIRECT + 1]
            if not l1:
                return 0
            l2 = self._ind_ro(l1, bn // NI, ind_cache)
            return self._ind_ro(l2, bn % NI, ind_cache) if l2 else 0
        raise FsError(Errno.EFBIG, "file too large")

    _IND_FMT = struct.Struct("<%dI" % L.NINDIRECT)
    _IND_ONE = struct.Struct("<I")

    def _ind_raw(self, indblock: int, ind_cache: Dict[int, bytes]) -> bytes:
        raw = ind_cache.get(indblock)
        if raw is None:
            with self._bread(indblock) as bh:
                raw = bytes(bh.data())
            ind_cache[indblock] = raw
        return raw

    def _ind_ro(self, indblock: int, idx: int,
                ind_cache: Dict[int, bytes]) -> int:
        return self._IND_ONE.unpack_from(
            self._ind_raw(indblock, ind_cache), idx * 4)[0]

    def _ind_tuple(self, indblock: int,
                   ind_cache: Dict[int, bytes]) -> Tuple[int, ...]:
        """Decode a whole indirect block to a tuple in one struct call —
        pays off only when MANY entries get indexed (a vectorized batch
        reuses it thousands of times); a one-off lookup uses ``_ind_ro``'s
        single-record decode instead (~30x cheaper for one entry)."""
        return self._IND_FMT.unpack(self._ind_raw(indblock, ind_cache))

    def read_many(self, reqs) -> List:
        """Vectorized read: plan every request's block segments first, then
        fetch all distinct data blocks in ONE buffer-cache pass and slice.
        Returns bytes per request, FsError in failing slots."""
        out: List = []
        with self._oplock:
            pend = self.journal.pending_snapshot()
            ind_cache: Dict[int, Tuple[int, ...]] = {}
            plans: List = []
            needed = set()
            # hot loop: bind everything the per-request body touches once —
            # the planning pass runs tens of thousands of times per drain
            BSIZE, NDIRECT, T_DIR = L.BSIZE, L.NDIRECT, L.T_DIR
            L1_END = NDIRECT + L.NINDIRECT
            bmap_ro, iget = self._bmap_ro, self._iget
            ind_tuple = self._ind_tuple
            plans_append, needed_add = plans.append, needed.add
            inodes: Dict[int, L.DiskInode] = {}
            inodes_get = inodes.get
            # whole-L1 decode costs ~30 single-record decodes: eager only
            # when the batch is big enough to amortize it (a scalar read
            # routed through here as a run of one must not pay it)
            eager_l1 = len(reqs) >= 4
            for args in reqs:
                try:
                    ino, off, size = args
                    if not isinstance(off, int) or not isinstance(size, int):
                        raise TypeError("read args are (ino, int off, int size)")
                    ent = inodes_get(ino)
                    if ent is None:
                        di = iget(ino)
                        if di.type == T_DIR:
                            raise FsError(Errno.EISDIR, str(ino))
                        l1 = di.addrs[NDIRECT]
                        # resolve the whole L1 indirect block once per
                        # distinct inode, not once per request
                        inodes[ino] = ent = (
                            di, ind_tuple(l1, ind_cache)
                            if l1 and eager_l1 else None)
                    di, l1ents = ent
                    segs = []
                    dsize = di.size
                    if off < dsize and size > 0:
                        if size > dsize - off:
                            size = dsize - off
                        addrs = di.addrs
                        segs_append = segs.append
                        while size > 0:
                            bn, boff = divmod(off, BSIZE)
                            nn = BSIZE - boff
                            if nn > size:
                                nn = size
                            if bn < NDIRECT:
                                b = addrs[bn]
                            elif bn < L1_END and l1ents is not None:
                                b = l1ents[bn - NDIRECT]
                            else:
                                b = bmap_ro(di, bn, ind_cache)
                            segs_append((b, boff, nn))
                            if b and b not in pend:
                                needed_add(b)
                            off += nn
                            size -= nn
                    plans_append(segs)
                except FsError as e:
                    plans_append(e)
                except (TypeError, ValueError):
                    plans_append(FsError(Errno.EINVAL, "bad read args"))
            fetched: List[int] = []
            try:
                heads = self.ks.sb_bread_many(self.sb_cap, sorted(needed),
                                              fetched=fetched)
            except Exception as e:  # device error: fail the batch's reads
                # as per-entry EIO — errors never cross as exceptions
                io_err = FsError(Errno.EIO, f"batched bread failed: {e}")
                with self._stats_lock:
                    self.stats["ops"] += len(reqs)
                return [p if isinstance(p, FsError) else io_err
                        for p in plans]
            bad = ()
            try:
                bufs = {bh.blockno: bh.data() for bh in heads}
                # verified reads: blocks that came off the DEVICE this pass
                # (cache hits were verified when first fetched; journal-
                # pending overlays are newer than their stored hash) are
                # re-hashed in ONE batched launch against the index
                bad = (self._blockstore.verify_fetched(bufs, fetched)
                       if self._blockstore is not None else ())
                out_append, pend_get = out.append, pend.get
                for segs in plans:
                    if isinstance(segs, FsError):
                        out_append(segs)
                        continue
                    if bad and any(b in bad for b, _, _ in segs):
                        out_append(FsError(
                            Errno.EIO, "blockstore: checksum mismatch"))
                        continue
                    if len(segs) == 1:  # aligned single-block read: no
                        b, boff, nn = segs[0]  # chunk list round trip
                        if b == 0:
                            out_append(bytes(nn))
                        else:
                            src = pend_get(b) or bufs[b]
                            out_append(bytes(src[boff: boff + nn]))
                        continue
                    chunks = []
                    for b, boff, nn in segs:
                        if b == 0:
                            chunks.append(bytes(nn))  # hole
                        else:
                            src = pend_get(b) or bufs[b]
                            chunks.append(bytes(src[boff: boff + nn]))
                    out_append(b"".join(chunks))
            finally:
                self.ks.sb_brelse_many(self.sb_cap, heads)
            if bad:
                # a corrupt fetch must not linger as a trusted cache hit:
                # evict so every later read refetches and re-verifies (EIO
                # stays sticky until the device matches the index again)
                self.ks.sb_invalidate_blocks(self.sb_cap, sorted(bad))
            with self._stats_lock:
                self.stats["ops"] += len(reqs)
        return out

    def _scalar_many(self, op: str, reqs) -> List:
        """Scalar loop under ONE fs-lock acquisition with per-entry errno
        capture — the shared body of the non-read vectorized paths.
        Arg-shape errors complete as EINVAL (pre-call bind check);
        implementation exceptions propagate, like scalar dispatch."""
        fn = getattr(self, op)
        out: List = []
        with self._oplock:
            for args in reqs:
                if not isinstance(args, tuple) \
                        or not self._entry_fits(op, args, None):
                    out.append(FsError(Errno.EINVAL, f"bad {op} args"))
                    continue
                try:
                    out.append(fn(*args))
                except FsError as e:
                    out.append(e)
        return out

    def write_many(self, reqs) -> List:
        """Batched write: one fs-lock acquisition; writes land in the open
        group-commit transaction, so a following fsync/flush entry commits
        the whole batch with one journal transaction (and one checksum_batch
        launch). Returns bytes-written per request, FsError where failed.
        On dedup mounts the whole batch shares ONE batch-end dedup pass
        (one blockhash launch), like submit_batch dispatch."""
        store = self._blockstore
        if store is None:
            return self._scalar_many("write", reqs)
        store.batch_begin()
        try:
            return self._scalar_many("write", reqs)
        finally:
            self._dedup_batch_end()

    def getattr_many(self, reqs) -> List:
        return self._scalar_many("getattr", reqs)

    def lookup_many(self, reqs) -> List:
        return self._scalar_many("lookup", reqs)

    # --- batched metadata: vectorized create/unlink ---------------------------------
    #
    # The scalar create/unlink rescan the parent directory once per call
    # (O(dir) each, O(dir^2) for a bulk phase). The vectorized paths scan
    # each touched directory ONCE per batch into a slot map that is kept
    # current as the batch mutates it — same allocation and placement
    # decisions as the scalar ops (first-fit holes, append at tail), so
    # batched and scalar execution produce identical trees.

    def _dir_scan_state(self, dino: int, pdi: L.DiskInode) -> Dict:
        """One-scan directory state for a batch: ``names`` maps name ->
        (bn, off, ino) like ``_dirlookup`` hits; ``holes`` lists free slots
        in scan order (the scalar first-fit order). Subclasses with a live
        index return it directly (repro_torch.fs.ext4like)."""
        import collections
        names: Dict[str, Tuple[int, int, int]] = {}
        holes = collections.deque()
        for bn, off, e_ino, name in self._dir_entries(dino, pdi):
            if e_ino == L.WHITEOUT_INO:
                continue  # delete marker: not a live name, not a free slot
            if e_ino != 0:
                names.setdefault(name, (bn, off, e_ino))
            else:
                holes.append((bn, off))
        return {"names": names, "holes": holes}

    def _create_many_common(self, reqs, kind: int) -> List:
        op = "mkdir" if kind == L.T_DIR else "create"
        out: List = []
        with self._oplock:
            states: Dict[int, Dict] = {}
            for args in reqs:
                if not isinstance(args, tuple) \
                        or not self._entry_fits(op, args, None):
                    out.append(FsError(Errno.EINVAL, f"bad {op} args"))
                    continue
                parent, name = args
                try:
                    if (not isinstance(name, str) or not name or "/" in name
                            or len(name.encode()) > L.NAME_MAX):
                        raise FsError(Errno.EINVAL, str(name))
                    self._check_reserved(name)
                    self._begin_op()
                    pdi = self._iget(parent)
                    if pdi.type != L.T_DIR:
                        raise FsError(Errno.ENOTDIR, str(parent))
                    st = states.get(parent)
                    if st is None:
                        st = states[parent] = self._dir_scan_state(parent, pdi)
                    if name in st["names"]:
                        raise FsError(Errno.EEXIST, name)
                    ino = self._ialloc(kind)
                    if kind == L.T_DIR:
                        pdi = self._iget(parent)
                        pdi.nlink += 1  # ".." link
                        self._iupdate(parent, pdi)
                        di = self._iget(ino)
                        di.nlink = 2
                        self._iupdate(ino, di)
                    # place the dirent: first-fit hole, else append (the
                    # scalar _dirlink decisions, without its rescan)
                    if st["holes"]:
                        bn, off = st["holes"].popleft()
                    else:
                        pdi = self._iget(parent)
                        bn, off = divmod(pdi.size, L.BSIZE)
                        pdi.size += L.DIRENT_SIZE
                        self._iupdate(parent, pdi)
                    b = self._bmap(parent, self._iget(parent), bn, alloc=True)
                    with self._bread(b) as bh:
                        bh.data()[off: off + L.DIRENT_SIZE] = \
                            L.pack_dirent(ino, name)
                        self._log(b, bytes(bh.data()))
                    st["names"][name] = (bn, off, ino)
                    self._end_op(True)
                    out.append(self._attr(ino, self._iget(ino)))
                except FsError as e:
                    out.append(e)
        return out

    def create_many(self, reqs) -> List:
        """Vectorized create: one fs-lock acquisition, one directory scan
        per touched parent (kept live across the batch), per-entry errno
        isolation. Journal behaviour matches scalar: per-entry begin/end
        reservations inside the open group-commit transaction, so a
        following fsync/flush commits the whole batch with ONE
        checksum_batch launch."""
        return self._create_many_common(reqs, L.T_FILE)

    def mkdir_many(self, reqs) -> List:
        return self._create_many_common(reqs, L.T_DIR)

    def unlink_many(self, reqs) -> List:
        """Vectorized unlink: one fs-lock acquisition and one scan per
        touched parent (the scalar path rescans per name)."""
        out: List = []
        with self._oplock:
            states: Dict[int, Dict] = {}
            for args in reqs:
                if not isinstance(args, tuple) \
                        or not self._entry_fits("unlink", args, None):
                    out.append(FsError(Errno.EINVAL, "bad unlink args"))
                    continue
                parent, name = args
                try:
                    self._check_reserved(name)
                    self._begin_op()
                    pdi = self._iget(parent)
                    st = states.get(parent)
                    if st is None:
                        st = states[parent] = self._dir_scan_state(parent, pdi)
                    hit = st["names"].get(name)
                    if hit is None:
                        raise FsError(Errno.ENOENT, str(name))
                    bn, off, ino = hit
                    di = self._iget(ino)
                    if di.type == L.T_DIR:
                        raise FsError(Errno.EISDIR, str(name))
                    self._dir_unset_raw(parent, bn, off)
                    st["names"].pop(name, None)
                    if st["holes"] is not None:  # None: fs never reuses holes
                        st["holes"].append((bn, off))
                    di.nlink -= 1
                    if di.nlink <= 0:
                        self._itrunc(ino, di)
                        di.type = L.T_FREE
                    self._iupdate(ino, di)
                    self._end_op(True)
                    out.append(None)
                except FsError as e:
                    out.append(e)
        return out

    # --- attrs ------------------------------------------------------------------------------------
    def _attr(self, ino: int, di: L.DiskInode) -> Attr:
        kind = FileKind.DIR if di.type == L.T_DIR else FileKind.FILE
        return Attr(ino=ino, kind=kind, size=di.size, nlink=di.nlink)

    def getattr(self, ino: int) -> Attr:
        with self._oplock:
            di = self._iget(ino)
            if di.type == L.T_FREE:
                raise FsError(Errno.ESTALE, f"free inode {ino}")
            self._end_op(False)
            return self._attr(ino, di)

    # --- directories ---------------------------------------------------------------------------------
    def _dir_entries(self, ino: int, di: L.DiskInode):
        nblocks = (di.size + L.BSIZE - 1) // L.BSIZE
        for bn in range(nblocks):
            b = self._bmap(ino, di, bn, alloc=False)
            if b == 0:
                continue
            with self._bread(b) as bh:
                raw = bytes(bh.data())
            limit = min(L.BSIZE, di.size - bn * L.BSIZE)
            for off in range(0, limit, L.DIRENT_SIZE):
                e_ino, name = L.unpack_dirent(raw, off)
                yield bn, off, e_ino, name

    def _dirlookup(self, dino: int, di: L.DiskInode, name: str):
        # whiteout markers (overlay delete sentinels) are not live entries:
        # the name they carry reads as ENOENT at this level — the overlay
        # inspects them through dir_entry_state instead
        for bn, off, e_ino, e_name in self._dir_entries(dino, di):
            if e_ino != 0 and e_ino != L.WHITEOUT_INO and e_name == name:
                return bn, off, e_ino
        return None

    def _dirlink(self, dino: int, name: str, ino: int) -> None:
        di = self._iget(dino)
        # reuse a hole if any; a whiteout marker for the SAME name is
        # flipped in place instead (one slot write replaces the delete
        # marker with the live entry — create-over-whiteout is atomic and
        # the directory never holds two slots for one name). Foreign
        # whiteouts are NOT holes: evicting another name's delete marker
        # would resurrect base content under an overlay.
        slot = None
        for bn, off, e_ino, e_name in self._dir_entries(dino, di):
            if e_ino == L.WHITEOUT_INO and e_name == name:
                self._dir_set(dino, bn, off, ino, name)
                return
            if e_ino == 0 and slot is None:
                slot = (bn, off)
        if slot is None:
            bn = di.size // L.BSIZE
            off = di.size % L.BSIZE
            slot = (bn, off)
            di.size += L.DIRENT_SIZE
            self._iupdate(dino, di)
        b = self._bmap(dino, di, slot[0], alloc=True)
        with self._bread(b) as bh:
            bh.data()[slot[1]: slot[1] + L.DIRENT_SIZE] = L.pack_dirent(ino, name)
            self._log(b, bytes(bh.data()))

    def _dir_unset_raw(self, dino: int, bn: int, off: int) -> None:
        """Clear one dirent slot on disk (journal-logged) — no index
        maintenance; subclasses layer theirs in ``_dir_unset``."""
        di = self._iget(dino)
        b = self._bmap(dino, di, bn, alloc=False)
        with self._bread(b) as bh:
            bh.data()[off: off + L.DIRENT_SIZE] = bytes(L.DIRENT_SIZE)
            self._log(b, bytes(bh.data()))

    def _dir_unset(self, dino: int, bn: int, off: int) -> None:
        self._dir_unset_raw(dino, bn, off)

    def _dir_set_raw(self, dino: int, bn: int, off: int, ino: int,
                     name: str) -> None:
        """Rewrite one existing dirent slot in place (journal-logged) —
        rename-overwrite's atomic replace: the target name flips from the
        displaced inode to the moved one in a single slot write, so even
        inside the transaction there is never a missing-name window."""
        di = self._iget(dino)
        b = self._bmap(dino, di, bn, alloc=False)
        with self._bread(b) as bh:
            bh.data()[off: off + L.DIRENT_SIZE] = L.pack_dirent(ino, name)
            self._log(b, bytes(bh.data()))

    def _dir_set(self, dino: int, bn: int, off: int, ino: int,
                 name: str) -> None:
        self._dir_set_raw(dino, bn, off, ino, name)

    # --- whiteout primitives (overlay mounts — see fs/overlay.py) -------------------
    # Plain mounts never create whiteouts; these exist so the overlay can
    # record "name deleted here" in a writable upper directory, masking the
    # same name in the immutable base. All mutations are journal-logged and
    # join the caller's open op/chain transaction.

    def dir_entry_state(self, dino: int, name: str):
        """Raw three-way dirent probe: ``("present", ino)`` for a live
        entry, ``("whiteout", None)`` for a delete marker, ``None`` when
        the name has no slot. Unlike ``lookup``, whiteouts are REPORTED,
        not skipped — the overlay's merge logic needs the distinction."""
        with self._oplock:
            di = self._iget(dino)
            if di.type != L.T_DIR:
                raise FsError(Errno.ENOTDIR, str(dino))
            out = None
            for _, _, e_ino, e_name in self._dir_entries(dino, di):
                if e_ino != 0 and e_name == name:
                    out = (("whiteout", None) if e_ino == L.WHITEOUT_INO
                           else ("present", e_ino))
                    break
            self._end_op(False)
            return out

    def dir_whiteouts(self, dino: int) -> List[str]:
        """Names carrying a delete marker in ``dino`` (readdir-merge and
        rmdir-purge input for the overlay)."""
        with self._oplock:
            di = self._iget(dino)
            if di.type != L.T_DIR:
                raise FsError(Errno.ENOTDIR, str(dino))
            out = [name for _, _, e_ino, name in self._dir_entries(dino, di)
                   if e_ino == L.WHITEOUT_INO]
            self._end_op(False)
            return out

    def dir_set_whiteout(self, dino: int, name: str) -> None:
        """Install a delete marker for ``name``. A live entry's slot is
        flipped in place (ONE slot write — no window where the name is
        missing but not yet masked; the caller owns the displaced inode's
        links), an existing marker is left alone, otherwise a slot is
        allocated like ``_dirlink``."""
        with self._oplock:
            self._begin_op()
            di = self._iget(dino)
            if di.type != L.T_DIR:
                raise FsError(Errno.ENOTDIR, str(dino))
            for bn, off, e_ino, e_name in self._dir_entries(dino, di):
                if e_ino != 0 and e_name == name:
                    if e_ino != L.WHITEOUT_INO:
                        self._dir_set(dino, bn, off, L.WHITEOUT_INO, name)
                    self._end_op(True)
                    return
            self._dirlink(dino, name, L.WHITEOUT_INO)
            self._end_op(True)

    def dir_clear_whiteout(self, dino: int, name: str) -> None:
        """Remove ``name``'s delete marker, leaving a reusable hole (no-op
        when none exists). Rename-over-base uses it when the moved name
        stops masking base content."""
        with self._oplock:
            self._begin_op()
            di = self._iget(dino)
            mutated = False
            for bn, off, e_ino, e_name in self._dir_entries(dino, di):
                if e_ino == L.WHITEOUT_INO and e_name == name:
                    self._dir_unset(dino, bn, off)
                    mutated = True
                    break
            self._end_op(mutated)

    def exchange(self, parent: int, name: str, newparent: int,
                 newname: str) -> None:
        """RENAME_EXCHANGE analogue: atomically swap two existing entries
        (both must resolve — ENOENT otherwise). Two in-place slot rewrites
        inside one journal reservation, so neither name ever dangles: even
        mid-transaction each slot always holds one of the two inodes, and
        a crash recovers to both-old or both-new. Directories may swap
        with files; a cross-directory dir swap re-homes both ".."
        back-links."""
        self._check_reserved(name)
        self._check_reserved(newname)
        with self._oplock:
            self._begin_op()
            pdi = self._iget(parent)
            if pdi.type != L.T_DIR:
                raise FsError(Errno.ENOTDIR, str(parent))
            ndi = self._iget(newparent)
            if ndi.type != L.T_DIR:
                raise FsError(Errno.ENOTDIR, str(newparent))
            a = self._dirlookup(parent, pdi, name)
            if a is None:
                raise FsError(Errno.ENOENT, name)
            b = self._dirlookup(newparent, ndi, newname)
            if b is None:
                raise FsError(Errno.ENOENT, newname)
            abn, aoff, aino = a
            bbn, boff, bino = b
            if aino == bino or (parent == newparent and name == newname):
                self._end_op(False)
                return
            adi = self._iget(aino)
            bdi = self._iget(bino)
            if parent != newparent:
                # swapping directories across parents moves each subtree
                # under the other parent — the cycle check applies both ways
                if adi.type == L.T_DIR:
                    self._assert_not_in_subtree(aino, newparent)
                if bdi.type == L.T_DIR:
                    self._assert_not_in_subtree(bino, parent)
            self._dir_set(parent, abn, aoff, bino, name)
            self._dir_set(newparent, bbn, boff, aino, newname)
            if parent != newparent and adi.type != bdi.type:
                # ".." re-homing nets out unless exactly one side is a dir
                gain = 1 if bdi.type == L.T_DIR else -1
                pdi = self._iget(parent)
                pdi.nlink += gain
                self._iupdate(parent, pdi)
                ndi = self._iget(newparent)
                ndi.nlink -= gain
                self._iupdate(newparent, ndi)
            self._end_op(True)

    def lookup(self, parent: int, name: str) -> Attr:
        with self._oplock:
            pdi = self._iget(parent)
            if pdi.type != L.T_DIR:
                raise FsError(Errno.ENOTDIR, str(parent))
            hit = self._dirlookup(parent, pdi, name)
            self._end_op(False)
            if hit is None:
                raise FsError(Errno.ENOENT, name)
            ino = hit[2]
            return self._attr(ino, self._iget(ino))

    def readdir(self, ino: int) -> List[Tuple[str, int, FileKind]]:
        with self._oplock:
            di = self._iget(ino)
            if di.type != L.T_DIR:
                raise FsError(Errno.ENOTDIR, str(ino))
            out = []
            hide = (DEDUP_TABLE_NAME if (self._blockstore is not None
                                         and ino == ROOT_INO) else None)
            for _, _, e_ino, name in self._dir_entries(ino, di):
                if e_ino != 0 and e_ino != L.WHITEOUT_INO:
                    if name == hide:
                        continue
                    edi = self._iget(e_ino)
                    kind = FileKind.DIR if edi.type == L.T_DIR else FileKind.FILE
                    out.append((name, e_ino, kind))
            self._end_op(False)
            return out

    def _check_reserved(self, name: str) -> None:
        """The blockstore's index file is fs-internal: user operations may
        neither create, remove, nor rename over it."""
        if self._blockstore is not None and name == DEDUP_TABLE_NAME:
            raise FsError(Errno.EPERM, name)

    def _create_common(self, parent: int, name: str, kind: int,
                       _internal: bool = False) -> Attr:
        if len(name.encode()) > L.NAME_MAX or not name or "/" in name:
            raise FsError(Errno.EINVAL, name)
        if not _internal:
            self._check_reserved(name)
        with self._oplock:
            self._begin_op()
            pdi = self._iget(parent)
            if pdi.type != L.T_DIR:
                raise FsError(Errno.ENOTDIR, str(parent))
            if self._dirlookup(parent, pdi, name) is not None:
                raise FsError(Errno.EEXIST, name)
            ino = self._ialloc(kind)
            if kind == L.T_DIR:
                pdi = self._iget(parent)
                pdi.nlink += 1  # ".." link
                self._iupdate(parent, pdi)
                di = self._iget(ino)
                di.nlink = 2
                self._iupdate(ino, di)
            self._dirlink(parent, name, ino)
            self._end_op(True)
            return self._attr(ino, self._iget(ino))

    def create(self, parent: int, name: str) -> Attr:
        return self._create_common(parent, name, L.T_FILE)

    def mkdir(self, parent: int, name: str) -> Attr:
        return self._create_common(parent, name, L.T_DIR)

    def _itrunc(self, ino: int, di: L.DiskInode) -> None:
        import struct
        NI = L.NINDIRECT
        for i in range(L.NDIRECT):
            if di.addrs[i]:
                self._bfree(di.addrs[i])
                di.addrs[i] = 0
        if di.addrs[L.NDIRECT]:
            with self._bread(di.addrs[L.NDIRECT]) as bh:
                raw = bytes(bh.data())
            for i in range(NI):
                (v,) = struct.unpack_from("<I", raw, i * 4)
                if v:
                    self._bfree(v)
            self._bfree(di.addrs[L.NDIRECT])
            di.addrs[L.NDIRECT] = 0
        if di.addrs[L.NDIRECT + 1]:
            with self._bread(di.addrs[L.NDIRECT + 1]) as bh:
                raw1 = bytes(bh.data())
            for i in range(NI):
                (l2,) = struct.unpack_from("<I", raw1, i * 4)
                if l2:
                    with self._bread(l2) as bh:
                        raw2 = bytes(bh.data())
                    for j in range(NI):
                        (v,) = struct.unpack_from("<I", raw2, j * 4)
                        if v:
                            self._bfree(v)
                    self._bfree(l2)
            self._bfree(di.addrs[L.NDIRECT + 1])
            di.addrs[L.NDIRECT + 1] = 0
        di.size = 0
        self._iupdate(ino, di)

    def unlink(self, parent: int, name: str) -> None:
        self._check_reserved(name)
        with self._oplock:
            self._begin_op()
            pdi = self._iget(parent)
            hit = self._dirlookup(parent, pdi, name)
            if hit is None:
                raise FsError(Errno.ENOENT, name)
            bn, off, ino = hit
            di = self._iget(ino)
            if di.type == L.T_DIR:
                raise FsError(Errno.EISDIR, name)
            self._dir_unset(parent, bn, off)
            di.nlink -= 1
            if di.nlink <= 0:
                self._itrunc(ino, di)
                di.type = L.T_FREE
            self._iupdate(ino, di)
            self._end_op(True)

    def rmdir(self, parent: int, name: str) -> None:
        self._check_reserved(name)
        with self._oplock:
            self._begin_op()
            pdi = self._iget(parent)
            hit = self._dirlookup(parent, pdi, name)
            if hit is None:
                raise FsError(Errno.ENOENT, name)
            bn, off, ino = hit
            di = self._iget(ino)
            if di.type != L.T_DIR:
                raise FsError(Errno.ENOTDIR, name)
            if any(e_ino != 0 for _, _, e_ino, _ in self._dir_entries(ino, di)):
                raise FsError(Errno.ENOTEMPTY, name)
            self._dir_unset(parent, bn, off)
            self._itrunc(ino, di)
            di.type = L.T_FREE
            di.nlink = 0
            self._iupdate(ino, di)
            pdi = self._iget(parent)
            pdi.nlink -= 1
            self._iupdate(parent, pdi)
            self._end_op(True)

    def _assert_not_in_subtree(self, ino: int, newparent: int) -> None:
        """EINVAL when ``newparent`` lives inside the directory being
        moved — without this check the rename would detach the subtree
        into an unreachable cycle (POSIX EINVAL)."""
        stack = [ino]
        while stack:
            d = stack.pop()
            if d == newparent:
                raise FsError(Errno.EINVAL, "rename into own subtree")
            ddi = self._iget(d)
            for _, _, e_ino, _ in self._dir_entries(d, ddi):
                if e_ino != 0 and e_ino != L.WHITEOUT_INO \
                        and self._iget(e_ino).type == L.T_DIR:
                    stack.append(e_ino)

    def rename(self, parent: int, name: str, newparent: int, newname: str) -> None:
        """POSIX rename, overwrite included: an existing ``newname`` is
        atomically REPLACED, never refused EEXIST — files replace files,
        directories replace EMPTY directories (ENOTEMPTY otherwise;
        ENOTDIR/EISDIR on kind mismatch). The displaced inode drops its
        link (blocks freed when it reaches zero) inside the SAME journal
        reservation as the dirent swap, so a crash at any device write
        recovers to either the complete old mapping or the complete new
        one — ``newname`` always resolves, the displaced inode's blocks
        are freed exactly when the swap is durable (enumerated per crash
        point by tests/test_crash_torture.py)."""
        if (not isinstance(newname, str) or not newname or "/" in newname
                or len(newname.encode()) > L.NAME_MAX):
            raise FsError(Errno.EINVAL, str(newname))
        self._check_reserved(name)
        self._check_reserved(newname)
        with self._oplock:
            self._begin_op()
            pdi = self._iget(parent)
            if pdi.type != L.T_DIR:
                raise FsError(Errno.ENOTDIR, str(parent))
            hit = self._dirlookup(parent, pdi, name)
            if hit is None:
                raise FsError(Errno.ENOENT, name)
            bn, off, ino = hit
            ndi = self._iget(newparent)
            if ndi.type != L.T_DIR:
                raise FsError(Errno.ENOTDIR, str(newparent))
            if parent == newparent and name == newname:
                self._end_op(False)  # POSIX: rename onto itself is a no-op
                return
            sdi = self._iget(ino)
            if sdi.type == L.T_DIR and newparent != parent:
                self._assert_not_in_subtree(ino, newparent)
            existing = self._dirlookup(newparent, ndi, newname)
            if existing is not None:
                ebn, eoff, eino = existing
                edi = self._iget(eino)
                if edi.type == L.T_DIR and sdi.type != L.T_DIR:
                    raise FsError(Errno.EISDIR, newname)
                if edi.type != L.T_DIR and sdi.type == L.T_DIR:
                    raise FsError(Errno.ENOTDIR, newname)
                if edi.type == L.T_DIR and any(
                        e_ino != 0
                        for _, _, e_ino, _ in self._dir_entries(eino, edi)):
                    raise FsError(Errno.ENOTEMPTY, newname)
                # atomic replace: rewrite the target's slot to the moved
                # inode, clear the source slot, drop the displaced link —
                # all staged into this op's one journal transaction
                self._dir_unset(parent, bn, off)
                self._dir_set(newparent, ebn, eoff, ino, newname)
                if edi.type == L.T_DIR:
                    # displaced empty dir: its synthetic self-link pair
                    # dies with it, and newparent loses the ".." back-link
                    edi.nlink = 0
                    self._itrunc(eino, edi)
                    edi.type = L.T_FREE
                    self._iupdate(eino, edi)
                    ndi = self._iget(newparent)
                    ndi.nlink -= 1
                    self._iupdate(newparent, ndi)
                else:
                    edi.nlink -= 1
                    if edi.nlink <= 0:
                        self._itrunc(eino, edi)
                        edi.type = L.T_FREE
                    self._iupdate(eino, edi)
            else:
                self._dir_unset(parent, bn, off)
                self._dirlink(newparent, newname, ino)
            if sdi.type == L.T_DIR and parent != newparent:
                # a moved directory re-homes its ".." back-link
                pdi = self._iget(parent)
                pdi.nlink -= 1
                self._iupdate(parent, pdi)
                ndi = self._iget(newparent)
                ndi.nlink += 1
                self._iupdate(newparent, ndi)
            self._end_op(True)

    # --- file data ------------------------------------------------------------------------------------
    def read(self, ino: int, off: int, size: int) -> bytes:
        with self._oplock:
            di = self._iget(ino)
            if di.type == L.T_DIR:
                raise FsError(Errno.EISDIR, str(ino))
            if off >= di.size:
                return b""
            size = min(size, di.size - off)
            out = bytearray()
            while size > 0:
                bn, boff = divmod(off, L.BSIZE)
                n = min(L.BSIZE - boff, size)
                b = self._bmap(ino, di, bn, alloc=False)
                if b == 0:
                    out += bytes(n)  # hole
                else:
                    with self._bread(b) as bh:
                        out += bh.data()[boff: boff + n]
                off += n
                size -= n
            self._end_op(False)
            return bytes(out)

    def write(self, ino: int, off: int, data: bytes) -> int:
        with self._oplock:
            di = self._iget(ino)
            if di.type == L.T_DIR:
                raise FsError(Errno.EISDIR, str(ino))
            if (off + len(data) + L.BSIZE - 1) // L.BSIZE > L.MAXFILE_BLOCKS:
                raise FsError(Errno.EFBIG, str(ino))
            pos, n = off, len(data)
            written = 0
            blocks_in_subop = MAXOP_BLOCKS  # force reservation on first block
            meta = self._chain_write_overhead  # bitmap/inode/ind (+dedup)
            while written < n:
                if blocks_in_subop + meta >= MAXOP_BLOCKS:
                    self._begin_op()
                    blocks_in_subop = 0
                bn, boff = divmod(pos, L.BSIZE)
                chunk = min(L.BSIZE - boff, n - written)
                b = self._write_block_target(ino, di, bn)
                if boff == 0 and chunk == L.BSIZE:
                    self._log(b, bytes(data[written: written + chunk]))
                else:
                    with self._bread(b) as bh:
                        buf = bh.data()
                        buf[boff: boff + chunk] = data[written: written + chunk]
                        self._log(b, bytes(buf))
                blocks_in_subop += 1
                pos += chunk
                written += chunk
                # keep size durable per sub-op so a crash between sub-ops
                # leaves a consistent (shorter) file
                if pos > di.size:
                    di.size = pos
                    self._iupdate(ino, di)
            store = self._blockstore
            if store is not None and store.batch_depth == 0:
                # scalar (unbatched) write: dedup pass in THIS transaction
                store.flush_pending()
            self._end_op(True)
            return written

    def truncate(self, ino: int, size: int) -> None:
        with self._oplock:
            self._begin_op()
            di = self._iget(ino)
            if size == 0:
                self._itrunc(ino, di)
            elif size < di.size:
                di.size = size  # lazy: keep blocks (xv6-style simplicity)
                self._iupdate(ino, di)
            else:
                di.size = size
                self._iupdate(ino, di)
            self._end_op(True)

    def fsync(self, ino: int) -> None:
        with self._oplock:
            self.journal.commit()
            self._end_op(False)

    def flush(self) -> None:
        with self._oplock:
            self.journal.commit()
            self.ks.flush(self.sb_cap)

    def statfs(self) -> Dict[str, int]:
        with self._oplock:
            # settle any deferred dedup pass FIRST: pending CoW/refcount
            # state makes the bitmap transiently stale, which is exactly
            # how the crashsim free-block audit used to drift on dedup
            # mounts (fs/crashsim.py torture_rename invariant)
            self._dedup_drain()
            with self._alloc_lock:  # a stable bitmap snapshot
                # count zero bits only for block numbers < geo.size: the
                # last bitmap block's trailing padding bits are zero but
                # name no real block, and counting them inflated the
                # estimate by the pad width on small devices
                free = 0
                for bm in range(self.geo.bmapstart, self.geo.datastart):
                    with self._bread(bm) as bh:
                        raw = bytes(bh.data())
                    limit = self.geo.size - (bm - self.geo.bmapstart) \
                        * L.BSIZE * 8
                    if limit <= 0:
                        break
                    if limit < L.BSIZE * 8:
                        nbytes, rem = divmod(limit, 8)
                        raw = raw[:nbytes + 1] if rem else raw[:nbytes]
                        if rem:  # mask off bits past the last real block
                            raw = raw[:-1] + bytes(
                                [raw[-1] | (0xFF << rem) & 0xFF])
                    free += sum(8 - bin(byte).count("1") for byte in raw)
            total_data = self.geo.size - self.geo.datastart
            self._end_op(False)
            out = {"block_size": L.BSIZE, "total_blocks": self.geo.size,
                   "data_blocks": total_data, "free_blocks_est": free,
                   "journal_commits": self.journal.commits}
            if self._blockstore is not None:
                extras = self._blockstore.statfs_extras()
                out.update(extras)
                # dedup-aware estimate: free_blocks_est stays PHYSICAL
                # (bitmap truth — the crash audits rely on it); the
                # logical view adds back what sharing saved, so a
                # capacity planner sees how much namespace the device
                # can still absorb. Both are asserted against a full
                # inode walk in tests/test_blockstore.py.
                out["free_blocks_logical_est"] = (
                    free + extras.get("dedup_saved_blocks", 0))
            return out
