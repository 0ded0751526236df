"""BlockStore: a content-addressed data plane for the Bento file systems.

Every file data block written through a ``dedup`` mount is hashed with the
``kernels/blockhash`` CUDA kernel — ONE batched launch per flushed write
batch, threaded through the same chain/batch scope hooks the submission
queues established — and recorded in an on-device hash→(block, refcount)
index. The index buys three production features on top of the paper's
"fast kernel-quality fs" claim:

* **Dedup (copy-on-write sharing).** A write whose final block content
  already exists on disk takes a *reference* to the existing block instead
  of keeping its own copy; the duplicate block is freed in the same
  journal transaction that rewrites the map. Tenants sharing
  mostly-identical data (checkpoints, container bases) pay for one copy.
* **CoW break-before-mutate.** A write that lands on a block with
  ``refcount > 1`` first allocates a private copy, carries the old
  content over, and repoints only the writing file — the other references
  never observe the mutation.
* **Verified reads.** ``read_many`` re-hashes every device-fetched block
  in one batched launch and compares against the index; a mismatch
  surfaces as an ``EIO``-carrying ``FsError`` on exactly the affected
  entries, turning silent device corruption (torn writes, bit rot) into a
  detected error instead of returned garbage.

On-disk index and crash safety
------------------------------

The index lives in a reserved root file (``.bento-dedup``, hidden from
``readdir`` and guarded against unlink/rename): one 8-byte record per
data-region block — ``<IHH`` = (hash u32, refcount u16, flags u16, flag
bit0 = hash-valid). Records are mutated through the fs's ``_bread`` /
``_log`` primitives, so every index mutation is STAGED INTO THE JOURNAL
and commits with the operation that caused it. The invariants, proven at
every power-loss point by ``crashsim.torture_dedup``:

* **Refcount-in-txn.** Refcount changes (take a reference, drop one,
  break sharing) stage in the same journal transaction as the block-map
  change they describe. A crash at any device write recovers to an index
  whose refcounts EXACTLY equal the number of file-map references — no
  leaked blocks, no double frees, ever.
* **Hash-valid-in-txn.** A write *invalidates* the target block's stored
  hash in the same transaction as the data, and *revalidates* it only in
  (or after) the transaction that made the new content durable. A valid
  hash therefore always matches the durable content — verified reads can
  never false-positive across a crash.
* **Sharing rewrites are atomic.** The dedup pass (map repoint + refcount
  increment + duplicate free) stages as one transaction: inside the chain
  transaction for chained writes, the trailing transaction of the batch
  otherwise. A crash between the data transaction and a deferred dedup
  pass simply leaves the blocks unshared (and their hashes invalid) —
  consistent, just not yet deduplicated.

Hash collisions never corrupt: the 32-bit polynomial hash only nominates
dedup *candidates*; sharing happens after a byte compare (ZFS
``dedup=verify`` discipline). The in-memory maps (refcounts, hash index)
are a cache of the on-device table, reloaded from the (rolled-back)
device state after any journal rollback, and carried across live
upgrades via ``extract_state``/``restore_state`` under the optional
``"dedup"`` key.

Index compaction under churn
----------------------------

The table is direct-mapped (one record slot per data-region block), so
sustained create/delete churn leaves *tombstones*: table blocks whose
records are all dead (``refcount == 0``) but which still hold device
blocks. When the ratio of fully-dead table blocks to materialized ones
crosses ``_COMPACT_TOMBSTONE_RATIO``, the batch-end pass PUNCHES them:
the logical→device mapping is cleared and the block returned to the
allocator, staged in the same journal transaction as the churn that
exposed them (crash at any point recovers to either state, proven by
``crashsim.torture_dedup``'s churn sweep). A record landing on a punched
slot later *rematerializes* the table block (fresh zeroed allocation, in
that record's transaction). ``reload`` re-derives the table-block map
from the index inode, so rollbacks and crash recovery see holes exactly
as the device does.
"""

from __future__ import annotations

import struct
import threading
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core.interface import Errno, FsError, ROOT_INO
from repro_torch.fs import layout as L

DEDUP_TABLE_NAME = ".bento-dedup"

_REC_FMT = "<IHH"  # hash, refcount, flags
_REC_SIZE = 8
_F_VALID = 0x1
_MAX_REFS = 0xFFFF
# journal blocks one dedup-pass item may stage (table + inode + indirect +
# bitmap); the pass defers items when the open transaction has less room
_ITEM_MARGIN = 8
# punch fully-dead table blocks once they exceed this fraction of the
# materialized table (see "Index compaction under churn" above)
_COMPACT_TOMBSTONE_RATIO = 0.25


class BlockStore:
    """Content-addressed index attached to one fs instance.

    All mutating entry points run under the owning fs's op lock with an
    open journal reservation — the store itself takes no locks beyond a
    thread-local batch-depth counter.
    """

    def __init__(self, fs):
        self.fs = fs
        self.table_ino: Optional[int] = None
        self._table_blocks: List[int] = []  # lbn -> device block (0 = punched)
        self._live_per_lbn: List[int] = []  # live (rc>0) records per table block
        # table blocks whose last live record DIED (vs never-populated
        # ones): only these are tombstones — punching the preallocated
        # but never-used tail of the table would just churn remats
        self._dead_churned: Set[int] = set()
        self._n_live_blocks = 0  # table blocks with any live record
        # in-memory cache of the on-device table
        self.refcnt: Dict[int, int] = {}
        self.hashval: Dict[int, int] = {}      # blockno -> hash (valid only)
        self._by_hash: Dict[int, Set[int]] = {}
        # blocks written this batch, awaiting the dedup pass:
        # blockno -> (ino, lbn, submitter)
        self.pending: Dict[int, Tuple[int, int, object]] = {}
        self._tls = threading.local()
        self.stats = {
            "hash_launches": 0, "hashed_blocks": 0, "dedup_hits": 0,
            "cow_breaks": 0, "dedup_deferred": 0, "verify_launches": 0,
            "verified_blocks": 0, "corruptions_detected": 0,
            "compactions": 0, "remats": 0,
            "by_submitter": {},
        }

    # --- batch scope (threaded through submit_batch / chain hooks) ------------------
    @property
    def batch_depth(self) -> int:
        return getattr(self._tls, "depth", 0)

    def batch_begin(self) -> None:
        self._tls.depth = self.batch_depth + 1

    def batch_dec(self) -> int:
        d = max(self.batch_depth - 1, 0)
        self._tls.depth = d
        return d

    # --- attach / bootstrap ----------------------------------------------------------
    def _n_entries(self) -> int:
        geo = self.fs.geo
        return geo.size - geo.datastart

    def attach(self) -> None:
        """Find or create the on-device table, then load it. Called at
        mount (after journal recovery): the create+zero bootstrap goes
        through the ordinary journaled write path, chunked into sub-op
        transactions, so a crash mid-bootstrap recovers to either a
        complete table or a retryable shorter one."""
        fs = self.fs
        table_bytes = self._n_entries() * _REC_SIZE
        root_di = fs._iget(ROOT_INO)
        hit = fs._dirlookup(ROOT_INO, root_di, DEDUP_TABLE_NAME)
        if hit is None:
            attr = fs._create_common(ROOT_INO, DEDUP_TABLE_NAME, L.T_FILE,
                                     _internal=True)
            self.table_ino = attr.ino
            fs.write(self.table_ino, 0, bytes(table_bytes))
        else:
            self.table_ino = hit[2]
            di = fs._iget(self.table_ino)
            if di.size < table_bytes:  # crash mid-bootstrap: finish the zero
                fs.write(self.table_ino, di.size, bytes(table_bytes - di.size))
        fs.journal.commit()
        self.reload()

    def reload(self) -> None:
        """Rebuild the in-memory maps from the on-device table (through
        the journal overlay). Also the rollback path: after an aborted
        chain member / op the overlay shows pre-transaction state, so a
        reload drops exactly the rolled-back index mutations. The
        table-block map is RE-DERIVED from the index inode each time —
        compaction punches holes into it (and rematerialization fills
        them), and both may be the thing that just rolled back."""
        fs = self.fs
        di = fs._iget(self.table_ino)
        nlbn = (self._n_entries() * _REC_SIZE + L.BSIZE - 1) // L.BSIZE
        cache: Dict[int, bytes] = {}
        self._table_blocks = [fs._bmap_ro(di, i, cache) for i in range(nlbn)]
        refcnt: Dict[int, int] = {}
        hashval: Dict[int, int] = {}
        by_hash: Dict[int, Set[int]] = {}
        datastart = fs.geo.datastart
        per_blk = L.BSIZE // _REC_SIZE
        live = [0] * nlbn
        for lbn, tb in enumerate(self._table_blocks):
            if tb == 0:
                continue  # punched: every record in range is dead
            with fs._bread(tb) as bh:
                raw = bytes(bh.data())
            base = datastart + lbn * per_blk
            for i, (h, rc, fl) in enumerate(struct.iter_unpack(_REC_FMT, raw)):
                if rc == 0:
                    continue
                b = base + i
                if b >= fs.geo.size:
                    break
                refcnt[b] = rc
                live[lbn] += 1
                if fl & _F_VALID:
                    hashval[b] = h
                    by_hash.setdefault(h, set()).add(b)
        self.refcnt = refcnt
        self.hashval = hashval
        self._by_hash = by_hash
        self._live_per_lbn = live
        self._n_live_blocks = sum(1 for n in live if n > 0)
        # churn history is transition-derived; the device can't tell a
        # churned-dead block from a never-used one, so pressure restarts
        self._dead_churned = set()
        self.pending.clear()

    # --- on-device record mutation (journaled: same txn as the caller's op) ----------
    def _entry_write(self, b: int, h: int, rc: int, valid: bool) -> None:
        fs = self.fs
        idx = b - fs.geo.datastart
        lbn, off = divmod(idx * _REC_SIZE, L.BSIZE)
        tb = self._table_blocks[lbn]
        if tb == 0:
            if rc == 0:
                return  # dead record on a punched block: already gone
            tb = self._remat_table_block(lbn)
        with fs._bread(tb) as bh:
            buf = bh.data()
            struct.pack_into(_REC_FMT, buf, off, h & 0xFFFFFFFF, rc,
                             _F_VALID if valid else 0)
            fs._log(tb, bytes(buf))
        # mirror into the in-memory cache (and the per-block live counts
        # compaction keys off)
        was_live = b in self.refcnt
        old_h = self.hashval.pop(b, None)
        if old_h is not None:
            peers = self._by_hash.get(old_h)
            if peers is not None:
                peers.discard(b)
                if not peers:
                    self._by_hash.pop(old_h, None)
        if rc == 0:
            self.refcnt.pop(b, None)
        else:
            self.refcnt[b] = rc
            if valid:
                self.hashval[b] = h
                self._by_hash.setdefault(h, set()).add(b)
        if was_live != (rc > 0) and self._live_per_lbn:
            if rc > 0:
                if self._live_per_lbn[lbn] == 0:
                    self._n_live_blocks += 1
                self._live_per_lbn[lbn] += 1
                self._dead_churned.discard(lbn)
            else:
                self._live_per_lbn[lbn] -= 1
                if self._live_per_lbn[lbn] == 0:
                    self._n_live_blocks -= 1
                    self._dead_churned.add(lbn)

    def _remat_table_block(self, lbn: int) -> int:
        """A record is landing on a punched (compacted-away) table block:
        materialize a fresh zeroed block for it, journaled in the current
        transaction like any other index mutation."""
        fs = self.fs
        nb = fs._balloc()  # stages the bitmap bit AND zeroed content
        di = fs._iget(self.table_ino)
        fs._bmap_install(self.table_ino, di, lbn, nb)
        self._table_blocks[lbn] = nb
        self.stats["remats"] += 1
        return nb

    # --- write-path hook --------------------------------------------------------------
    def note_write(self, ino: int, di, bn: int, b: int) -> int:
        """Called by the fs for every file data block about to be
        (re)written, inside the op's journal scope. Breaks CoW sharing,
        invalidates the stored hash (same txn as the data — the
        hash-valid-in-txn invariant), and registers the block for the
        batch-end dedup pass. Returns the block the write must target."""
        if ino == self.table_ino:
            return b  # the index never indexes itself
        fs = self.fs
        rc = self.refcnt.get(b)
        if rc is not None and rc > 1:
            # CoW break: private copy first, mutate the copy
            nb = fs._balloc()
            old = self._content(b)
            fs._log(nb, old)
            h = self.hashval.get(b)
            self._entry_write(b, h if h is not None else 0, rc - 1,
                              h is not None)
            self._entry_write(nb, 0, 1, False)
            fs._bmap_install(ino, di, bn, nb)
            self.stats["cow_breaks"] += 1
            b = nb
        elif rc is None:
            self._entry_write(b, 0, 1, False)  # start tracking
        elif b in self.hashval:
            self._entry_write(b, 0, 1, False)  # content changing: invalidate
        self.pending[b] = (ino, bn, self._submitter())
        return b

    def _submitter(self):
        sub = getattr(self.fs, "_current_submitter", None)
        return sub if sub is not None else f"tid:{threading.get_ident()}"

    def _content(self, b: int) -> bytes:
        pend = self.fs.journal.pending_get(b)
        if pend is not None:
            return pend
        with self.fs._bread(b) as bh:
            return bytes(bh.data())

    # --- free-path hook ---------------------------------------------------------------
    def release(self, b: int) -> bool:
        """Drop one reference; returns True when the caller should really
        free the block (last reference, or untracked metadata block)."""
        rc = self.refcnt.get(b)
        if rc is None:
            return True
        if rc > 1:
            h = self.hashval.get(b)
            self._entry_write(b, h if h is not None else 0, rc - 1,
                              h is not None)
            return False
        self._entry_write(b, 0, 0, False)
        self.pending.pop(b, None)
        return True

    # --- the batch-end dedup pass -------------------------------------------------------
    def flush_pending(self) -> None:
        """Hash every block the batch wrote in ONE kernel launch, then
        share duplicates copy-on-write style. Runs under the fs lock with
        an open journal scope (the chain transaction for chained writes,
        a trailing reservation otherwise); items that would overflow the
        open transaction stay pending for the next pass. Piggybacks the
        tombstone compaction check: churn that killed whole table blocks
        gets them punched in this same transaction."""
        self._dedup_pass()
        self._maybe_compact()

    def _dedup_pass(self) -> None:
        if not self.pending:
            return
        fs = self.fs
        items = []
        for b, (ino, bn, sub) in list(self.pending.items()):
            # staleness: the batch may have re-freed / re-targeted the block
            if self.refcnt.get(b) != 1:
                self.pending.pop(b, None)
                continue
            try:
                di = fs._iget(ino)
            except FsError:
                self.pending.pop(b, None)
                continue
            if di.type != L.T_FILE or fs._bmap_ro(di, bn, {}) != b:
                self.pending.pop(b, None)
                continue
            items.append((b, ino, bn, sub, self._content(b)))
        if not items:
            self.pending.clear()
            return
        sums = fs.ks.checksum_batch([it[4] for it in items])
        self.stats["hash_launches"] += 1
        self.stats["hashed_blocks"] += len(items)
        journal = fs.journal
        for i, ((b, ino, bn, sub, content), h) in enumerate(zip(items, sums)):
            if journal.room < _ITEM_MARGIN:
                # transaction nearly full: leave the tail pending (counted)
                self.stats["dedup_deferred"] += len(items) - i
                return
            self.pending.pop(b, None)
            target = None
            for c in self._by_hash.get(h, ()):
                if (c != b and self.refcnt.get(c, 0) > 0
                        and self.refcnt[c] < _MAX_REFS
                        and self._content(c) == content):
                    target = c
                    break
            if target is not None:
                di = fs._iget(ino)
                fs._bmap_install(ino, di, bn, target)
                self._entry_write(target, h, self.refcnt[target] + 1, True)
                self._entry_write(b, 0, 0, False)
                fs._bfree_raw(b)
                self.stats["dedup_hits"] += 1
                per = self.stats["by_submitter"].setdefault(
                    str(sub), {"blocks": 0, "dedup_hits": 0})
                per["dedup_hits"] += 1
            else:
                self._entry_write(b, h, 1, True)
            per = self.stats["by_submitter"].setdefault(
                str(sub), {"blocks": 0, "dedup_hits": 0})
            per["blocks"] += 1

    # --- index compaction under churn ----------------------------------------------------
    def compaction_due(self) -> bool:
        """Tombstone pressure: CHURNED fully-dead table blocks (blocks
        whose last live record died — never-populated preallocated blocks
        don't count) as a fraction of the USED index (dead + still-live
        blocks) crossed the punch threshold. O(1): the counts are
        maintained incrementally by ``_entry_write`` — this runs on every
        mutating op's epilogue."""
        dead = len(self._dead_churned)
        if dead == 0:
            return False
        return dead / (dead + self._n_live_blocks) > _COMPACT_TOMBSTONE_RATIO

    def _maybe_compact(self) -> None:
        """Punch every fully-dead table block back to the allocator,
        journaled in the caller's open transaction: clear the index
        inode's mapping, free the device block, leave a hole sentinel in
        the in-memory map. Stops early when the open transaction runs
        low on room — the rest punch on a later pass (``compaction_due``
        stays true until they do)."""
        if not self.compaction_due():
            return
        fs = self.fs
        di = fs._iget(self.table_ino)
        for lbn in sorted(self._dead_churned):
            tb = self._table_blocks[lbn]
            if tb == 0 or self._live_per_lbn[lbn] != 0:
                self._dead_churned.discard(lbn)
                continue
            if fs.journal.room < _ITEM_MARGIN:
                return
            fs._bmap_clear(self.table_ino, di, lbn)
            fs._bfree_raw(tb)
            self._table_blocks[lbn] = 0
            self._dead_churned.discard(lbn)
            self.stats["compactions"] += 1

    # --- verified reads ------------------------------------------------------------------
    def verify_fetched(self, bufs: Dict[int, bytes], fetched) -> Set[int]:
        """Bulk-verify device-fetched blocks against stored hashes (one
        batched launch); returns the set of corrupt block numbers."""
        cand = [b for b in fetched if b in self.hashval]
        if not cand:
            return set()
        sums = self.fs.ks.checksum_batch([bytes(bufs[b]) for b in cand])
        self.stats["verify_launches"] += 1
        self.stats["verified_blocks"] += len(cand)
        bad = {b for b, got in zip(cand, sums) if got != self.hashval[b]}
        if bad:
            self.stats["corruptions_detected"] += len(bad)
            self.fs.ks.log_warn(
                f"blockstore: checksum mismatch on blocks {sorted(bad)}")
        return bad

    # --- observability / state transfer ---------------------------------------------------
    def shared_refs(self) -> int:
        return sum(rc - 1 for rc in self.refcnt.values() if rc > 1)

    def statfs_extras(self) -> Dict[str, int]:
        return {
            "dedup_tracked_blocks": len(self.refcnt),
            "dedup_shared_refs": self.shared_refs(),
            # statfs accounting (the free-block estimate folds these in):
            # device blocks the index itself occupies, and data blocks
            # CoW sharing saves (rc-1 per shared block) — what free space
            # would gain if every share were broken
            "dedup_index_blocks": sum(1 for tb in self._table_blocks if tb),
            "dedup_saved_blocks": self.shared_refs(),
            "dedup_hits": self.stats["dedup_hits"],
            "dedup_cow_breaks": self.stats["cow_breaks"],
            "dedup_hash_launches": self.stats["hash_launches"],
            "dedup_verify_launches": self.stats["verify_launches"],
            "dedup_corruptions_detected": self.stats["corruptions_detected"],
            "dedup_compactions": self.stats["compactions"],
            "dedup_remats": self.stats["remats"],
        }

    def extract_state(self) -> Dict:
        return {
            "table_ino": self.table_ino,
            "table_blocks": list(self._table_blocks),
            "refcnt": dict(self.refcnt),
            "hashval": dict(self.hashval),
            "stats": {k: (dict(v) if isinstance(v, dict) else v)
                      for k, v in self.stats.items()},
        }

    def restore_state(self, state: Dict) -> None:
        self.table_ino = state.get("table_ino", self.table_ino)
        blocks = state.get("table_blocks")
        if blocks:
            self._table_blocks = [int(b) for b in blocks]
        self.refcnt = {int(k): int(v)
                       for k, v in state.get("refcnt", {}).items()}
        self.hashval = {int(k): int(v)
                        for k, v in state.get("hashval", {}).items()}
        self._by_hash = {}
        for b, h in self.hashval.items():
            self._by_hash.setdefault(h, set()).add(b)
        # recompute the compaction live counts from the restored refcounts
        per_blk = L.BSIZE // _REC_SIZE
        datastart = self.fs.geo.datastart
        live = [0] * len(self._table_blocks)
        for b in self.refcnt:
            live[(b - datastart) // per_blk] += 1
        self._live_per_lbn = live
        self._n_live_blocks = sum(1 for n in live if n > 0)
        self._dead_churned = set()
        st = state.get("stats")
        if st:
            self.stats.update({k: (dict(v) if isinstance(v, dict) else v)
                               for k, v in st.items()})
        self.pending.clear()
