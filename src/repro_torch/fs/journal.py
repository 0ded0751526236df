"""Write-ahead journal (xv6 ``log.c`` semantics, with checksums).

Transactions collect dirty block numbers; ``commit`` writes the data into
the journal area, then a checksummed header (the commit record), then
installs the blocks to their home locations, then clears the header. After
a crash, ``recover`` replays any committed-but-uninstalled transaction.
Absorption (same block logged twice in one txn) is implemented, as is group
commit (several ops per transaction until fsync or the log fills).

The per-block checksum in the commit record uses the kernel-services
checksum (the CUDA blockhash in the kernel binding) — torn journal writes are
detected at recovery.

Chain transactions
------------------

Single operations reserve journal space per (sub-)operation via the fs's
``_begin_op``.  A linked SQE chain (``SQE_LINK`` — e.g. create →
write(PrevResult) → fsync) is a larger atomicity unit: ALL of its members'
``log_write``s must land in ONE transaction, or a crash between two
commits leaves a half-applied chain on disk.  ``begin_chain`` /
``end_chain`` make the chain the reservation unit:

* ``begin_chain(estimated_blocks)`` — sizing rule: the caller estimates the
  chain's whole journal footprint from its *submission entries* (data
  blocks plus per-op metadata overhead, an upper bound).  If the estimate
  exceeds the journal's total capacity the chain can NEVER fit and
  ``JournalFull`` (an ``FsError`` carrying ``ENOSPC``) is raised *before a
  single block is staged* — the ENOSPC-before-staging rule: the caller
  fails the chain's first member with ``ENOSPC`` and cancels the rest, so
  an unserviceable chain leaves no trace in the transaction.  If the chain
  fits but not next to the currently pending blocks, the open transaction
  is committed first (a legal pre-chain boundary).
* while a chain is open, ``commit`` is REFUSED: it is deferred (recorded)
  instead of executed, so neither an in-chain fsync/flush nor a group-
  commit heuristic can tear the chain across two commit records.
* ``end_chain`` closes the scope and executes the deferred commit, if one
  was requested — the whole chain becomes durable atomically.

A crash at any device write therefore leaves either the whole chain
installed after ``recover`` or none of it.

Concurrent reservations (sharded lock domains)
----------------------------------------------

The parallel multi-submitter drain (``core.registry`` +
``fs/xv6.LockDomainTable``) dispatches non-overlapping groups on worker
threads, so more than one chain scope can be OPEN at once — one per
thread. The chain scope is therefore per-thread state
(``_chain_scopes[tid]``), and the journal stays the ONLY global
serialization point:

* ``begin_chain`` admits a new reservation only while the pending
  transaction plus every ACTIVE reservation still fits capacity; when
  other chains hold reservations it waits for them to close instead of
  forcing a commit (commit mid-chain would tear them);
* ``commit`` defers while the CALLING thread holds a chain scope (the
  single-thread rule, unchanged) or while ANY open chain has staged
  blocks — committing then would split that chain across two commit
  records. The deferred commit runs when the last scope closes.
* the mutating side above the journal serializes on the allocation
  domain (``fs/xv6.LockDomainTable``), so at most one chain with staged
  blocks exists at a time — member-abort rollback can never clobber a
  concurrent chain's staging. Read-only chains stage nothing and run
  fully concurrent.
"""

from __future__ import annotations

import struct
import threading
from typing import Dict, List, Optional

from repro_torch.core.capability import SuperBlockCap
from repro_torch.core.interface import Errno, FsError
from repro_torch.fs.layout import BSIZE, SuperBlock

_HDR_FMT_HEAD = "<III"  # magic, n, seq
_HDR_MAGIC = 0x4A524E4C  # "JRNL"


class JournalFull(FsError):
    """Operation/chain footprint exceeds the journal.

    An ``FsError`` (errno ``ENOSPC``) so the batched boundary's errno-
    isolation path turns it into a per-entry completion instead of letting
    it escape ``submit_batch`` as a raw exception."""

    def __init__(self, msg: str = ""):
        super().__init__(Errno.ENOSPC, msg)


class _ChainScope:
    """One thread's open chain reservation: its size (for admission of
    further concurrent chains), its member undo log, and whether any of
    its blocks are already staged (a staged chain pins ``commit``)."""

    __slots__ = ("est", "member_undo", "staged")

    def __init__(self, est: int):
        self.est = est
        self.member_undo: Optional[Dict[int, Optional[bytes]]] = None
        self.staged = False


class Journal:
    def __init__(self, services, sb_cap: SuperBlockCap, sb: SuperBlock,
                 *, batched_install: bool = False):
        self.ks = services
        self.sb_cap = sb_cap
        self.sb = sb
        self.capacity = sb.nlog - 1  # minus header block
        self.batched_install = batched_install  # writepages-style install
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)  # chain-scope transitions
        self._pending: Dict[int, bytes] = {}  # home blockno -> data (absorbed)
        self._seq = 0
        # chain scopes are PER-THREAD: the parallel drain runs independent
        # chains on worker threads concurrently (each serialized above the
        # journal by its lock domains); tid -> scope
        self._chain_scopes: Dict[int, _ChainScope] = {}
        self._chain_deferred = False  # a commit was requested mid-chain
        self._op_undo: Dict[int, Optional[Dict[int, Optional[bytes]]]] = {}
        # called after any undo-rollback so the fs can drop in-memory
        # state (inode cache, dir indexes) derived from the rolled-back
        # staging; set by the fs at init
        self.rollback_listener = None
        self.commits = 0
        self.blocks_logged = 0
        self.chains = 0          # chain reservations taken
        self.chain_precommits = 0  # commits forced to make room for a chain

    @property
    def room(self) -> int:
        """Blocks the open transaction can still absorb — the blockstore's
        dedup pass bounds its per-transaction staging with this."""
        return self.capacity - len(self._pending)

    # --- write path ---------------------------------------------------------------
    def log_write(self, blockno: int, data: bytes) -> None:
        """Stage a block into the current transaction (absorbs duplicates).

        NB: never commits mid-operation — ops reserve space via the fs's
        ``_begin_op`` (xv6 ``begin_op`` semantics) or, for a linked chain,
        via ``begin_chain``, so a crash can only land between whole
        operations/chains, keeping each one atomic."""
        with self._lock:
            tid = threading.get_ident()
            scope = self._chain_scopes.get(tid)
            # undo entry BEFORE the overflow check: callers mutate the
            # cache buffer first, so even a refused log_write must leave
            # its block invalidatable by the rollback
            undo = (scope.member_undo if scope is not None
                    else self._op_undo.get(tid))
            if undo is not None and blockno not in undo:
                undo[blockno] = self._pending.get(blockno)
            if len(self._pending) >= self.capacity and blockno not in self._pending:
                if scope is None:
                    # overflow outside a chain: roll the current op scope
                    # back NOW, so the ENOSPC that reaches the caller means
                    # "this (sub-)op staged nothing" — a later group commit
                    # can never install a torn op (in-chain overflows roll
                    # back in chain_member_abort instead)
                    self._rollback_locked(self._op_undo.get(tid))
                    self._op_undo[tid] = None
                raise JournalFull(
                    f"operation overflowed the journal ({self.capacity} blocks) "
                    "— missing _begin_op/begin_chain reservation")
            self._pending[blockno] = bytes(data)
            if scope is not None:
                scope.staged = True

    def commit(self) -> None:
        with self._lock:
            if threading.get_ident() in self._chain_scopes or \
                    any(s.staged for s in self._chain_scopes.values()):
                # Refused mid-chain: a chain must land in ONE transaction,
                # so neither the chain's own thread nor a concurrent
                # committer may split an open chain's staged blocks across
                # two commit records. Recorded and executed by the LAST
                # end_chain. (A concurrent commit while only empty chain
                # scopes are open proceeds — nothing of theirs can tear.)
                self._chain_deferred = True
                return
            self._commit_locked()

    # --- chain-scoped reservation (linked SQE chains) ------------------------------
    @property
    def in_chain(self) -> bool:
        """Some thread holds an open chain scope (any thread)."""
        return bool(self._chain_scopes)

    @property
    def in_chain_here(self) -> bool:
        """Chain scope open AND owned by the calling thread. The member-
        bracketing fast path in ``submit_batch`` checks this BEFORE taking
        the fs lock — a concurrent submitter on another thread must see
        False, or it would clobber the owner's member undo log."""
        return threading.get_ident() in self._chain_scopes

    def begin_chain(self, estimated_blocks: int) -> None:
        """Open a chain scope sized for ``estimated_blocks`` journal blocks
        (an upper bound computed from the chain's submission entries).

        Raises ``JournalFull`` (ENOSPC) BEFORE anything is staged when the
        chain can never fit the journal; commits the open transaction first
        when the chain fits but not alongside the pending blocks. While
        OTHER threads hold chain reservations the open transaction cannot
        be committed out from under them, so an admission that does not fit
        waits for those scopes to close instead."""
        with self._lock:
            tid = threading.get_ident()
            if tid in self._chain_scopes:
                raise RuntimeError("nested begin_chain — chains may not nest")
            if estimated_blocks > self.capacity:
                raise JournalFull(
                    f"chain needs ~{estimated_blocks} journal blocks, "
                    f"capacity is {self.capacity} — cannot be made atomic")
            while True:
                reserved = sum(s.est for s in self._chain_scopes.values())
                if len(self._pending) + reserved + estimated_blocks \
                        <= self.capacity:
                    break
                if not self._chain_scopes:
                    # alone: a pre-chain commit is a legal boundary
                    self.chain_precommits += 1
                    self._commit_locked()
                    break
                self._cv.wait()  # concurrent scopes close via end_chain
            self._chain_scopes[tid] = _ChainScope(estimated_blocks)
            self.chains += 1

    def end_chain(self) -> None:
        """Close the calling thread's chain scope; when the LAST scope
        closes, run the commit an in-chain fsync/flush deferred (the whole
        chain becomes durable atomically)."""
        with self._lock:
            self._chain_scopes.pop(threading.get_ident(), None)
            if not self._chain_scopes and self._chain_deferred:
                self._chain_deferred = False
                self._commit_locked()
            self._cv.notify_all()

    # Per-MEMBER bracketing inside a chain scope: the reservation estimate
    # is an upper bound only for literal payloads (a PrevResult-fed write's
    # size is unknowable at begin_chain), so a member may still overflow
    # mid-staging. The undo log scopes that damage to the member: abort
    # restores every block the member touched, so an ENOSPC member stages
    # NOTHING — earlier (successful) members' blocks stay, matching
    # io_uring link semantics, and no torn member can ever be committed.
    def chain_member_begin(self) -> None:
        with self._lock:
            scope = self._chain_scopes.get(threading.get_ident())
            if scope is not None:
                scope.member_undo = {}

    def chain_member_end(self) -> None:
        with self._lock:
            scope = self._chain_scopes.get(threading.get_ident())
            if scope is not None:
                scope.member_undo = None

    def chain_member_abort(self) -> None:
        with self._lock:
            scope = self._chain_scopes.get(threading.get_ident())
            if scope is None:
                return
            undo, scope.member_undo = scope.member_undo, None
            self._rollback_locked(undo)

    # --- op-scoped undo (non-chain reservations) ------------------------------------
    def begin_op_scope(self) -> None:
        """Arm the undo log for one (sub-)operation's staging — called by
        the fs's ``_begin_op``. An overflow before the next scope rolls
        back to this point, so ENOSPC always means "nothing staged by the
        failing (sub-)op" on the scalar and unchained paths too. The scope
        is per-thread, like the chain scopes."""
        with self._lock:
            self._op_undo[threading.get_ident()] = {}

    def _rollback_locked(self, undo: Optional[Dict[int, Optional[bytes]]]
                         ) -> None:
        for blockno, prior in (undo or {}).items():
            if prior is None:
                self._pending.pop(blockno, None)
            else:
                self._pending[blockno] = prior
        # ops mutate CACHE buffers in place before logging; drop the
        # scope's blocks so reads refetch the device and re-overlay the
        # (restored) pending state, and let the fs drop derived caches
        if undo:
            self.ks.sb_invalidate_blocks(self.sb_cap, list(undo))
            if self.rollback_listener is not None:
                self.rollback_listener()

    def pending_get(self, blockno: int):
        """Read-through overlay: committed-but-unstaged data visible to
        readers (xv6 pins these buffers; we overlay instead)."""
        with self._lock:
            return self._pending.get(blockno)

    def pending_snapshot(self) -> Dict[int, bytes]:
        """One-lock copy of the overlay for batched readers: a vectorized
        read path consults this dict instead of taking the journal lock
        once per block."""
        with self._lock:
            return dict(self._pending)

    def _commit_locked(self) -> None:
        if not self._pending:
            return
        items = sorted(self._pending.items())
        assert len(items) <= self.capacity
        # 1) write data blocks into the journal area
        for i, (_home, data) in enumerate(items):
            with self.ks.sb_getblk_zero(self.sb_cap, self.sb.logstart + 1 + i) as bh:
                bh.data()[:] = data
                self.ks.bwrite_sync(self.sb_cap, bh)
        # 2) commit record (header with checksums) — the commit point
        # (batched: one kernel launch per transaction)
        sums = self.ks.checksum_batch([data for _h, data in items])
        hdr = struct.pack(_HDR_FMT_HEAD, _HDR_MAGIC, len(items), self._seq)
        for (home, _data), cks in zip(items, sums):
            hdr += struct.pack("<II", home, cks)
        with self.ks.sb_getblk_zero(self.sb_cap, self.sb.logstart) as bh:
            bh.data()[: len(hdr)] = hdr
            self.ks.bwrite_sync(self.sb_cap, bh)
        # 3) install to home locations
        if self.batched_install:
            # writepages-style: stage dirty, one sorted batched flush.
            for home, data in items:
                with self.ks.sb_getblk_zero(self.sb_cap, home) as bh:
                    bh.data()[:] = data
                    bh.mark_dirty()
            self.ks.flush(self.sb_cap, [h for h, _ in items])
        else:
            for home, data in items:
                with self.ks.sb_getblk_zero(self.sb_cap, home) as bh:
                    bh.data()[:] = data
                    self.ks.bwrite_sync(self.sb_cap, bh)
        # 4) clear the header
        with self.ks.sb_getblk_zero(self.sb_cap, self.sb.logstart) as bh:
            self.ks.bwrite_sync(self.sb_cap, bh)
        self.commits += 1
        self.blocks_logged += len(items)
        self._seq += 1
        self._pending.clear()

    # --- recovery -------------------------------------------------------------------
    def recover(self) -> int:
        """Replay a committed transaction found in the journal. Returns the
        number of blocks installed (0 if log was clean or torn)."""
        with self.ks.sb_bread(self.sb_cap, self.sb.logstart) as bh:
            raw = bytes(bh.data())
        magic, n, _seq = struct.unpack_from(_HDR_FMT_HEAD, raw)
        if magic != _HDR_MAGIC or n == 0 or n > self.capacity:
            return 0
        entries = []
        off = struct.calcsize(_HDR_FMT_HEAD)
        for i in range(n):
            home, cks = struct.unpack_from("<II", raw, off + 8 * i)
            entries.append((home, cks))
        # verify checksums against journal data blocks (torn-write detection)
        datas = []
        raws = []
        for i, (home, _cks) in enumerate(entries):
            with self.ks.sb_bread(self.sb_cap, self.sb.logstart + 1 + i) as bh:
                raws.append(bytes(bh.data()))
        sums = self.ks.checksum_batch(raws)
        for (home, cks), data, got in zip(entries, raws, sums):
            if got != cks:
                return 0  # torn commit: discard
            datas.append((home, data))
        for home, data in datas:
            with self.ks.sb_getblk_zero(self.sb_cap, home) as bh:
                bh.data()[:] = data
                self.ks.bwrite_sync(self.sb_cap, bh)
        with self.ks.sb_getblk_zero(self.sb_cap, self.sb.logstart) as bh:
            self.ks.bwrite_sync(self.sb_cap, bh)
        return n

    # --- upgrade support (§4.8) --------------------------------------------------------
    def extract_state(self) -> Dict:
        with self._lock:
            return {"pending": dict(self._pending), "seq": self._seq}

    def restore_state(self, state: Dict) -> None:
        with self._lock:
            self._pending = dict(state.get("pending", {}))
            self._seq = int(state.get("seq", 0))
            # chains never span an upgrade (the gate drains whole batches,
            # and a chain lives inside one batch) — reset defensively
            self._chain_scopes = {}
            self._chain_deferred = False
            self._op_undo = {}
