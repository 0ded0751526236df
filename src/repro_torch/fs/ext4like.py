"""Ext4-like optimized baseline (the paper's "commercial grade" reference).

Same on-disk format as the xv6 fs (so the benchmarks isolate *implementation
quality*, like the paper's ext4 data=journal comparison isolates it from
journaling mode), plus the optimizations a production file system has and
xv6 lacks:

  * extent-style allocation: contiguous multi-block runs claimed in one
    bitmap scan (one journaled bitmap block per run instead of per block),
  * an in-memory directory hash index (ext4 htree analogue) instead of
    linear dirent scans,
  * write coalescing: full-block appends skip the read-modify-write,
  * a larger journal with the same group commit + batched install.

Simplifications vs real ext4 are documented in DESIGN.md.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from repro_torch.core.interface import Errno, FsError
from repro_torch.fs import layout as L
from repro_torch.fs.xv6 import Xv6FileSystem, Xv6Options


class Ext4LikeFileSystem(Xv6FileSystem):
    NAME = "ext4like"
    VERSION = 1

    def __init__(self, options: Xv6Options = Xv6Options(group_commit=True,
                                                        batched_install=True)):
        super().__init__(options)
        # dir index: dino -> {name: (bn, off, ino)}
        self._dirindex: Dict[int, Dict[str, Tuple[int, int, int]]] = {}

    # Chain reservations (see Xv6FileSystem.chain_begin): this fs's write
    # path extent-preallocates per sub-op, touching up to 6 metadata blocks
    # (bitmap runs + inode + indirect chain) per reservation — write()
    # below derives its per-reservation data budget from this same
    # constant, so estimate and staging can never drift apart.
    _CHAIN_WRITE_OVERHEAD = 6

    def _invalidate_caches_after_abort(self) -> None:
        # the live dir index may reflect rolled-back staging; it rebuilds
        # lazily through the restored journal overlay
        self._dirindex.clear()

    # --- extent allocator -------------------------------------------------------------
    def _balloc_run(self, want: int) -> List[int]:
        """Allocate up to ``want`` contiguous blocks with one bitmap pass."""
        with self._alloc_lock:
            bits_per = L.BSIZE * 8
            total = self.geo.size
            start = max(self._free_hint, self.geo.datastart)
            b = start
            run: List[int] = []
            scanned = 0
            bm_cache: Dict[int, bytearray] = {}
            while scanned < total - self.geo.datastart and len(run) < want:
                if b >= total:
                    b = self.geo.datastart
                    run = []
                bmno = self.geo.bmapstart + b // bits_per
                if bmno not in bm_cache:
                    with self._bread(bmno) as bh:
                        bm_cache[bmno] = bytearray(bh.data())
                buf = bm_cache[bmno]
                bit = b % bits_per
                if (buf[bit // 8] >> (bit % 8)) & 1:
                    run = []
                else:
                    run.append(b)
                b += 1
                scanned += 1
            if not run:
                raise FsError(Errno.ENOSPC, "device full")
            # mark the run used; journal each touched bitmap block once
            touched = set()
            for blk in run:
                bmno = self.geo.bmapstart + blk // bits_per
                buf = bm_cache[bmno]
                bit = blk % bits_per
                buf[bit // 8] |= 1 << (bit % 8)
                touched.add(bmno)
            for bmno in touched:
                with self._bread(bmno) as bh:
                    bh.data()[:] = bm_cache[bmno]
                    self._log(bmno, bytes(bh.data()))
            for blk in run:
                self._log(blk, bytes(L.BSIZE))  # zero (journaled)
            self._free_hint = run[-1] + 1
            return run

    def _balloc(self) -> int:
        return self._balloc_run(1)[0]

    # --- write path with extent preallocation ----------------------------------------------
    def write(self, ino: int, off: int, data: bytes) -> int:
        from repro_torch.fs.xv6 import MAXOP_BLOCKS

        with self._oplock:
            di = self._iget(ino)
            if di.type == L.T_DIR:
                raise FsError(Errno.EISDIR, str(ino))
            end_bn = (off + len(data) + L.BSIZE - 1) // L.BSIZE
            if end_bn > L.MAXFILE_BLOCKS:
                raise FsError(Errno.EFBIG, str(ino))
            pos, n = off, len(data)
            written = 0
            # data blocks per journal reservation (metadata budget shared
            # with the chain estimator; dedup widens it)
            per_sub = max(MAXOP_BLOCKS - self._chain_write_overhead, 4)
            while written < n:
                self._begin_op()
                # extent-preallocate this sub-op's missing blocks as one run
                first_bn = pos // L.BSIZE
                last_bn = min(end_bn, first_bn + per_sub)
                missing = [bn for bn in range(first_bn, last_bn)
                           if self._bmap(ino, di, bn, alloc=False) == 0]
                if missing:
                    run: list = []
                    need = len(missing)
                    while need > 0:
                        got = self._balloc_run(need)
                        run.extend(got)
                        need -= len(got)
                    for bn, blk in zip(missing, run):
                        self._bmap_install(ino, di, bn, blk)
                sub_blocks = 0
                while written < n and sub_blocks < per_sub:
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
                    sub_blocks += 1
                    pos += chunk
                    written += chunk
                if pos > di.size:
                    di.size = pos
                    self._iupdate(ino, di)
            store = self._blockstore
            if store is not None and store.batch_depth == 0:
                store.flush_pending()  # scalar write: dedup in this txn
            self._end_op(True)
            return written

    # _bmap_install/_ind_set moved to Xv6FileSystem: the blockstore's CoW
    # remapping shares them with extent preallocation.

    # --- directory hash index ---------------------------------------------------------------
    def _index(self, dino: int, di: L.DiskInode) -> Dict[str, Tuple[int, int, int]]:
        idx = self._dirindex.get(dino)
        if idx is None:
            idx = {}
            for bn, off, e_ino, name in self._dir_entries(dino, di):
                if e_ino != 0:
                    idx[name] = (bn, off, e_ino)
            self._dirindex[dino] = idx
        return idx

    def _dirlookup(self, dino: int, di: L.DiskInode, name: str):
        hit = self._index(dino, di).get(name)
        if hit is not None and hit[2] == L.WHITEOUT_INO:
            return None  # overlay delete marker: the name reads as absent
        return hit if hit is not None else None

    def _dirlink(self, dino: int, name: str, ino: int) -> None:
        di = self._iget(dino)
        idx = self._index(dino, di)
        hit = idx.get(name)
        if hit is not None and hit[2] == L.WHITEOUT_INO:
            # create-over-whiteout flips the delete marker's slot in place
            # (same rule as xv6's scan path): one slot write, no duplicate
            # whiteout+live records for the name
            self._dir_set(dino, hit[0], hit[1], ino, name)
            return
        # append at end (holes tracked lazily via index rebuild)
        bn = di.size // L.BSIZE
        off = di.size % L.BSIZE
        di.size += L.DIRENT_SIZE
        self._iupdate(dino, di)
        b = self._bmap(dino, di, bn, alloc=True)
        with self._bread(b) as bh:
            bh.data()[off: off + L.DIRENT_SIZE] = L.pack_dirent(ino, name)
            self._log(b, bytes(bh.data()))
        idx[name] = (bn, off, ino)

    def _dir_unset(self, dino: int, bn: int, off: int) -> None:
        super()._dir_unset(dino, bn, off)
        idx = self._dirindex.get(dino)
        if idx is not None:
            for name, (b2, o2, _) in list(idx.items()):
                if b2 == bn and o2 == off:
                    del idx[name]
                    break

    def _dir_set(self, dino: int, bn: int, off: int, ino: int,
                 name: str) -> None:
        # rename-overwrite's in-place slot rewrite: whatever name occupied
        # this slot leaves the index, the new binding enters it
        super()._dir_set(dino, bn, off, ino, name)
        idx = self._dirindex.get(dino)
        if idx is not None:
            for nm, (b2, o2, _) in list(idx.items()):
                if b2 == bn and o2 == off:
                    del idx[nm]
                    break
            idx[name] = (bn, off, ino)

    def _dir_scan_state(self, dino: int, pdi) -> Dict:
        """Batched-metadata dir state — the LIVE hash index itself, so the
        batch's inserts/removes keep it current with zero extra scans
        (bulk dirindex maintenance). ``holes`` is None: this fs's scalar
        ``_dirlink`` always appends, and the batch must place dirents the
        same way."""
        return {"names": self._index(dino, pdi), "holes": None}

    # --- batched fast paths ------------------------------------------------------------------
    # read_many is inherited from Xv6FileSystem (already vectorized); the
    # overrides below add what the dir index and write coalescing buy a
    # batch that the base class can't know about.

    def lookup_many(self, reqs) -> List:
        """Vectorized lookup: one fs-lock acquisition, pure hash-index hits
        (no per-name dirent scan, no scalar re-dispatch)."""
        out: List = []
        with self._oplock:
            for args in reqs:
                try:
                    parent, name = args
                    pdi = self._iget(parent)
                    if pdi.type != L.T_DIR:
                        raise FsError(Errno.ENOTDIR, str(parent))
                    hit = self._index(parent, pdi).get(name)
                    if hit is None or hit[2] == L.WHITEOUT_INO:
                        raise FsError(Errno.ENOENT, name)
                    ino = hit[2]
                    out.append(self._attr(ino, self._iget(ino)))
                except FsError as e:
                    out.append(e)
                except (TypeError, ValueError):
                    out.append(FsError(Errno.EINVAL, "bad lookup args"))
            with self._stats_lock:  # concurrent lookup units share this
                self.stats["ops"] += len(reqs)  # count per entry, like scalar
        return out

    def write_many(self, reqs) -> List:
        """Batched write with coalescing: adjacent entries that continue the
        same inode's byte range merge into one write() (one extent
        preallocation + journal pass for the merged run, the batch analogue
        of this class's full-block append coalescing). If a merged run
        fails (e.g. ENOSPC partway), it is retried entry by entry so each
        entry still gets its own result — per-entry errno isolation holds
        even through the fast path. Dedup mounts share one batch-end
        dedup pass across the whole call."""
        store = self._blockstore
        if store is not None:
            store.batch_begin()
        try:
            return self._write_many_runs(reqs)
        finally:
            if store is not None:
                self._dedup_batch_end()

    def _write_many_runs(self, reqs) -> List:
        out: List = []
        with self._oplock:
            i, n = 0, len(reqs)
            while i < n:
                try:
                    ino, off, data = reqs[i]
                    if (not isinstance(data, (bytes, bytearray))
                            or not isinstance(off, int)):
                        raise TypeError("write args are (ino, int off, bytes)")
                    end = off + len(data)
                except (TypeError, ValueError):
                    out.append(FsError(Errno.EINVAL, "bad write args"))
                    i += 1
                    continue
                j = i + 1
                parts = [data]
                while j < n:
                    nxt = reqs[j]
                    if (not isinstance(nxt, tuple) or len(nxt) != 3
                            or nxt[0] != ino or nxt[1] != end
                            or not isinstance(nxt[2], (bytes, bytearray))):
                        break
                    parts.append(nxt[2])
                    end += len(nxt[2])
                    j += 1
                try:
                    self.write(ino, off, b"".join(parts) if len(parts) > 1
                               else parts[0])
                    out.extend(len(p) for p in parts)
                    # scalar write counted the merged run as one op; keep
                    # stats['ops'] meaning entries, like the other paths
                    with self._stats_lock:
                        self.stats["ops"] += len(parts) - 1
                except FsError as e:
                    if len(parts) == 1:
                        out.append(e)
                    else:
                        # merged run failed: retry per entry (idempotent
                        # rewrites) so isolation survives the fast path
                        out.extend(self._scalar_many("write", reqs[i:j]))
                i = j
        return out

    # --- state transfer keeps the index -----------------------------------------------------
    def extract_state(self) -> Dict:
        st = super().extract_state()
        st["dirindex"] = {d: dict(v) for d, v in self._dirindex.items()}
        return st

    def restore_state(self, state: Dict, from_version: int) -> None:
        super().restore_state(state, from_version)
        self._dirindex = {int(d): dict(v)
                          for d, v in state.get("dirindex", {}).items()}

    def state_schema(self):
        return super().state_schema() + ("dirindex",)

    def optional_state_keys(self):
        # a lazily-rebuilt cache: an upgrade FROM plain xv6 (which never
        # emits it) legally starts with an empty index — declaring it
        # optional keeps the schema honest without forcing a migrate hook
        return super().optional_state_keys() + ("dirindex",)
