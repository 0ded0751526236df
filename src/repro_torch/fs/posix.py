"""POSIX-style path API over a mounted Bento file system.

This is the application-facing layer the benchmarks, the checkpoint store
and the examples use; it performs path walking + dentry caching on top of
the inode-granular file-operations API (like the kernel side of VFS does).

Two call surfaces share the dentry cache:

* scalar calls (``read_file``, ``write_file``, ``stat``, …) — unchanged:
  one gate-crossing and one dispatch per operation;
* plural forms (``read_many`` / ``write_many`` / ``stat_many`` /
  ``create_many`` / ``unlink_many`` / ``create_and_write_many``) — resolve
  paths through the dentry cache, then cross the module boundary ONCE per
  batch via ``mount.submit`` (preadv/pwritev over io_uring). Per-entry
  failures come back as in-list ``FsError`` values when ``strict=False``;
  by default a failure raises, matching the scalar API (after the whole
  batch ran — the batched forms never stop halfway through a submission).

Path walking in the plural forms is batched too: every path advances one
component per round, and each round's dentry-cache MISSES are resolved
with a single ``lookup`` submission (one gate crossing per dcache-miss
level, instead of one per missing component per path). Cache hits never
cross the boundary, so a warm walk still costs zero submissions.

Submissions ride a THREAD-LOCAL ``SubmitterQueue``: N threads sharing one
PosixView (or N views over one mount) stage into N per-thread SQs, and the
mount's drainer carries every queue pending at drain time across the
boundary in one gate crossing (io_uring SQPOLL-style — see
``repro_torch.core.registry``). One thread sees exactly the old behaviour; many
threads see crossings ≪ submissions.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.interface import (Attr, Errno, FsError, PrevResult, ROOT_INO,
                                  SQE_DRAIN, SQE_LINK, SubmissionEntry)


class PosixView:
    def __init__(self, mount, dentry_cache: bool = True):
        self.m = mount
        self._dcache: Dict[Tuple[int, str], int] = {}
        self._use_dcache = dentry_cache
        self._tls = threading.local()

    def _submit(self, entries: List[SubmissionEntry]):
        """Cross the boundary once for ``entries`` via this thread's
        SubmitterQueue (created on first use). The queue is drained to
        empty every call, so the completions returned are exactly this
        batch's, in submission order."""
        q = getattr(self._tls, "sq", None)
        if q is None:
            from repro_torch.core.registry import SubmitterQueue
            q = self._tls.sq = SubmitterQueue(self.m)
        q.stage(entries)
        q.submit()
        return q.drain()

    # --- path walking -------------------------------------------------------------
    def _walk(self, path: str) -> int:
        ino = ROOT_INO
        for part in self._parts(path):
            key = (ino, part)
            hit = self._dcache.get(key) if self._use_dcache else None
            if hit is not None:
                ino = hit
                continue
            attr = self.m.lookup(ino, part)
            if self._use_dcache:
                self._dcache[key] = attr.ino
            ino = attr.ino
        return ino

    @staticmethod
    def _parts(path: str) -> List[str]:
        return [p for p in path.split("/") if p]

    def _split(self, path: str) -> Tuple[int, str]:
        parts = self._parts(path)
        if not parts:
            raise FsError(Errno.EINVAL, path)
        parent = ROOT_INO
        for p in parts[:-1]:
            parent = self._walk_one(parent, p)
        return parent, parts[-1]

    def _walk_one(self, parent: int, name: str) -> int:
        key = (parent, name)
        hit = self._dcache.get(key) if self._use_dcache else None
        if hit is not None:
            return hit
        ino = self.m.lookup(parent, name).ino
        if self._use_dcache:
            self._dcache[key] = ino
        return ino

    def _invalidate(self, parent: int, name: str) -> None:
        self._dcache.pop((parent, name), None)

    # --- API ------------------------------------------------------------------------
    def create(self, path: str) -> Attr:
        parent, name = self._split(path)
        attr = self.m.create(parent, name)
        if self._use_dcache:
            self._dcache[(parent, name)] = attr.ino
        return attr

    def mkdir(self, path: str) -> Attr:
        parent, name = self._split(path)
        attr = self.m.mkdir(parent, name)
        if self._use_dcache:
            self._dcache[(parent, name)] = attr.ino
        return attr

    def makedirs(self, path: str) -> None:
        parts = self._parts(path)
        cur = ""
        for p in parts:
            cur += "/" + p
            try:
                self.mkdir(cur)
            except FsError as e:
                if e.errno != Errno.EEXIST:
                    raise

    def unlink(self, path: str) -> None:
        parent, name = self._split(path)
        self.m.unlink(parent, name)
        self._invalidate(parent, name)

    def rmdir(self, path: str) -> None:
        parent, name = self._split(path)
        self.m.rmdir(parent, name)
        self._invalidate(parent, name)

    def rename(self, old: str, new: str) -> None:
        p1, n1 = self._split(old)
        p2, n2 = self._split(new)
        self.m.rename(p1, n1, p2, n2)
        self._invalidate(p1, n1)
        self._invalidate(p2, n2)

    def listdir(self, path: str) -> List[str]:
        ino = self._walk(path)
        return [name for name, _, _ in self.m.readdir(ino)]

    def stat(self, path: str) -> Attr:
        return self.m.getattr(self._walk(path))

    def exists(self, path: str) -> bool:
        try:
            self._walk(path)
            return True
        except FsError:
            return False

    def write_file(self, path: str, data: bytes, *, off: int = 0,
                   create: bool = True) -> int:
        try:
            ino = self._walk(path)
        except FsError as e:
            if e.errno != Errno.ENOENT or not create:
                raise
            ino = self.create(path).ino
        return self.m.write(ino, off, data)

    def append(self, path: str, data: bytes) -> int:
        try:
            ino = self._walk(path)
            size = self.m.getattr(ino).size
        except FsError:
            ino = self.create(path).ino
            size = 0
        return self.m.write(ino, size, data)

    def read_file(self, path: str, off: int = 0, size: int = -1) -> bytes:
        ino = self._walk(path)
        if size < 0:
            size = self.m.getattr(ino).size - off
        return self.m.read(ino, off, max(size, 0))

    def truncate(self, path: str, size: int) -> None:
        self.m.truncate(self._walk(path), size)

    def fsync(self, path: str) -> None:
        self.m.fsync(self._walk(path))

    def statfs(self) -> Dict[str, int]:
        return self.m.statfs()

    def read_provenance(self, since: int = 0, offset: int = 0,
                        limit: Optional[int] = None) -> List[Dict]:
        """Query the mounted provenance layer (paper §6): plain-value
        records for every mutation with ``seq >= since``, in execution
        order. ``offset``/``limit`` paginate within that selection (the
        whole triple rides the submission payload, so batched and FUSE
        dispatch paginate identically). Raises ``FsError(EINVAL)`` when no
        provenance layer is mounted — feature-probe with a try/except,
        like an ioctl."""
        return self.m.read_provenance(since, offset, limit)

    # --- batched API (one boundary crossing per batch) ----------------------------
    @staticmethod
    def _unwrap(comps, strict: bool):
        if strict:
            return [c.unwrap() for c in comps]
        return [c.result if c.ok else FsError(c.errno, str(c.user_data))
                for c in comps]

    def _walk_many(self, paths: Sequence[str], *, strict: bool,
                   create: bool = False) -> List:
        """Resolve each path to an ino with a *batched* walk, repeats
        walked once. All paths advance one component per round; a round's
        dcache misses become ONE ``lookup`` submission (scalar fallback
        never happens — a cold walk of N paths costs one submission per
        tree level, not one per component). With ``create=True``, final-
        component ENOENT misses become one trailing ``create`` batch,
        riding the fs's vectorized create path. In strict mode the first
        failing path's error raises — after the batch's walk and creates
        completed (the batched forms never stop mid-submission); otherwise
        the failing slot holds its FsError and the rest proceed."""
        uniq = list(dict.fromkeys(paths))
        parts = {p: self._parts(p) for p in uniq}
        res: Dict[str, Union[int, FsError]] = {}
        cur = {p: ROOT_INO for p in uniq}
        pending = list(uniq)
        level = 0
        while pending:
            nxt = []
            for p in pending:
                if len(parts[p]) == level:
                    res[p] = cur[p]
                else:
                    nxt.append(p)
            pending = nxt
            if not pending:
                break
            # dcache pass for this level; misses grouped by (parent, name)
            need: Dict[Tuple[int, str], List[str]] = {}
            for p in pending:
                key = (cur[p], parts[p][level])
                hit = self._dcache.get(key) if self._use_dcache else None
                if hit is not None:
                    cur[p] = hit
                else:
                    need.setdefault(key, []).append(p)
            if need:
                comps = self._submit(
                    [SubmissionEntry("lookup", k, user_data=k) for k in need])
                to_create: Dict[Tuple[int, str], List[str]] = {}
                for c in comps:
                    key = c.user_data
                    if c.ok:
                        ino = c.result.ino
                        if self._use_dcache:
                            self._dcache[key] = ino
                        for p in need[key]:
                            cur[p] = ino
                        continue
                    for p in need[key]:
                        if (create and c.errno == Errno.ENOENT
                                and len(parts[p]) == level + 1):
                            to_create.setdefault(key, []).append(p)
                        else:
                            res[p] = FsError(c.errno, key[1])
                if to_create:
                    ccomps = self._submit(
                        [SubmissionEntry("create", k, user_data=k)
                         for k in to_create])
                    for c in ccomps:
                        key = c.user_data
                        if c.ok:
                            ino = c.result.ino
                            if self._use_dcache:
                                self._dcache[key] = ino
                            for p in to_create[key]:
                                cur[p] = ino
                        else:
                            for p in to_create[key]:
                                res[p] = FsError(c.errno, key[1])
                pending = [p for p in pending if p not in res]
            level += 1
        if strict:
            for p in paths:
                if isinstance(res[p], FsError):
                    raise res[p]
        return [res[p] for p in paths]

    def _split_many(self, paths: Sequence[str], *, strict: bool) -> List:
        """Batched ``_split``: resolve every path's parent directory with
        one batched walk. Returns (parent_ino | FsError, name) per path."""
        pairs: List = [None] * len(paths)
        walk_idx: List[int] = []
        walk_paths: List[str] = []
        for i, p in enumerate(paths):
            parts = self._parts(p)
            if not parts:
                err = FsError(Errno.EINVAL, p)
                if strict:
                    raise err
                pairs[i] = (err, None)
            else:
                walk_idx.append(i)
                walk_paths.append("/".join(parts[:-1]))
                pairs[i] = (None, parts[-1])
        resolved = self._walk_many(walk_paths, strict=strict)
        for i, r in zip(walk_idx, resolved):
            pairs[i] = (r, pairs[i][1])
        return pairs

    def _submit_sparse(self, resolved: List, entry_for, strict: bool) -> List:
        """Submit entries for the slots that resolved; failed slots keep
        their FsError in place (per-entry isolation end to end)."""
        idxs = [i for i, r in enumerate(resolved)
                if not isinstance(r, FsError)]
        results = self._unwrap(self._submit([entry_for(i) for i in idxs]),
                               strict)
        out = list(resolved)
        for i, res in zip(idxs, results):
            out[i] = res
        return out

    def read_many(self, specs: Sequence[Union[str, Tuple[str, int, int]]],
                  *, strict: bool = True) -> List:
        """Read many (path | (path, off, size)) specs in one submission.

        A bare path (or size < 0) means "the rest of the file": sizes for
        those are resolved with one batched getattr round first, so a full-
        file batch costs two boundary crossings total, not 2N.
        """
        norm: List[Tuple[str, int, int]] = [
            (s, 0, -1) if isinstance(s, str) else (s[0], s[1], s[2])
            for s in specs]
        resolved = self._walk_many([p for p, _, _ in norm], strict=strict)
        sized = sorted({r for (_, _, sz), r in zip(norm, resolved)
                        if sz < 0 and not isinstance(r, FsError)})
        if sized:
            attrs = self._submit([SubmissionEntry("getattr", (ino,),
                                                   user_data=ino)
                                   for ino in sized])
            size_of = {}
            for c in attrs:
                if c.ok:
                    size_of[c.user_data] = c.result.size
                elif strict:
                    c.unwrap()
                else:
                    size_of[c.user_data] = FsError(c.errno, "getattr")
            for i, ((p, off, sz), r) in enumerate(zip(norm, resolved)):
                if sz < 0 and not isinstance(r, FsError):
                    s = size_of[r]
                    if isinstance(s, FsError):
                        resolved[i] = s
                    else:
                        norm[i] = (p, off, max(s - off, 0))
        if not any(isinstance(r, FsError) for r in resolved):
            # common case: everything resolved — build the entries in one
            # comprehension instead of a per-slot closure call
            return self._unwrap(
                self._submit([SubmissionEntry("read", (r, off, sz),
                                              user_data=p)
                              for r, (p, off, sz) in zip(resolved, norm)]),
                strict)
        return self._submit_sparse(
            resolved,
            lambda i: SubmissionEntry("read",
                                      (resolved[i], norm[i][1], norm[i][2]),
                                      user_data=norm[i][0]),
            strict)

    def write_many(self, items: Sequence[Union[Tuple[str, bytes],
                                               Tuple[str, int, bytes]]],
                   *, create: bool = True, fsync: bool = False,
                   strict: bool = True, chain: bool = False) -> List:
        """Write many (path, data) / (path, off, data) items in one
        submission; with ``fsync=True`` a trailing flush entry commits the
        whole batch as one journal transaction (one checksum launch).

        ``chain=True`` links every entry (SQE_LINK): writes execute in
        order and stop at the first failure — the rest complete
        ``ECANCELED``, and the trailing flush (when ``fsync``) is the chain
        tail, so nothing commits unless EVERY write succeeded (the
        checkpoint store's manifest-commit ordering). A chain is also ONE
        journal transaction (crash-atomic: after a crash either every
        write is installed or none — see ``repro_torch.fs.journal``), which
        bounds it by journal capacity: a chain whose estimated footprint
        can never fit completes ENOSPC-first/ECANCELED-rest, so keep
        chained batches small (they are an atomicity unit, not a bulk-data
        path). A cancelled flush raises the first failing member's real
        errno in strict mode; with ``strict=False`` the per-entry slots
        tell the story (FsError / ECANCELED values) and nothing raises.
        Chained execution is member-by-member, so it trades the coalescing
        fast path for the ordering + atomicity guarantees."""
        norm = [(it[0], 0, it[1]) if len(it) == 2 else it for it in items]
        resolved = self._walk_many([p for p, _, _ in norm], strict=strict,
                                   create=create)
        idxs = [i for i, r in enumerate(resolved)
                if not isinstance(r, FsError)]
        flags = SQE_LINK if chain else 0
        entries = [SubmissionEntry("write",
                                   (resolved[i], norm[i][1], norm[i][2]),
                                   user_data=norm[i][0], flags=flags)
                   for i in idxs]
        if fsync:
            # chained: the flush is the chain TAIL (cancelled if any write
            # failed); unchained: SQE_DRAIN documents the barrier — the
            # flush runs only after every write completed
            entries.append(SubmissionEntry("flush", (), user_data="<flush>",
                                           flags=0 if chain else SQE_DRAIN))
        comps = self._submit(entries)
        if fsync:
            flush = comps[-1]
            comps = comps[:-1]
            if flush.errno == Errno.ECANCELED:
                # the chain stopped before the commit — that is requested
                # behaviour, not a commit failure. strict: surface the ROOT
                # cause (the first failing member), never the cancellation;
                # strict=False: the per-entry results carry the story.
                if strict:
                    for c in comps:
                        if c.errno not in (None, Errno.ECANCELED):
                            raise FsError(c.errno, str(c.user_data))
            else:
                flush.unwrap()  # a genuinely failed commit is never ignorable
        results = self._unwrap(comps, strict)
        out = list(resolved)
        for i, res in zip(idxs, results):
            out[i] = res
        return out

    def _meta_many(self, op: str, paths: Sequence[str], strict: bool,
                   on_success) -> List:
        """Shared body of the batched metadata forms: batched parent walk,
        ONE ``op`` submission, per-success dcache action, merged results."""
        pairs = self._split_many(paths, strict=strict)
        idxs = [i for i, (parent, _) in enumerate(pairs)
                if not isinstance(parent, FsError)]
        comps = self._submit(
            [SubmissionEntry(op, (pairs[i][0], pairs[i][1]),
                             user_data=paths[i]) for i in idxs]) \
            if idxs else []
        for i, c in zip(idxs, comps):
            if c.ok:
                on_success(pairs[i][0], pairs[i][1], c.result)
        results = self._unwrap(comps, strict)
        out = [p if isinstance(p, FsError) else None for p, _ in pairs]
        for i, r in zip(idxs, results):
            out[i] = r
        return out

    def create_many(self, paths: Sequence[str], *, strict: bool = True) -> List:
        """Create many files: one batched parent walk, then ONE ``create``
        submission riding the fs's vectorized create path (one gate
        crossing, one directory scan per touched parent). Returns the new
        Attr per slot."""
        def cache(parent, name, attr):
            if self._use_dcache:
                self._dcache[(parent, name)] = attr.ino
        return self._meta_many("create", paths, strict, cache)

    def unlink_many(self, paths: Sequence[str], *, strict: bool = True) -> List:
        """Unlink many paths: one batched parent walk, then ONE ``unlink``
        submission (the fs scans each touched directory once for the whole
        batch). Slots hold None on success."""
        return self._meta_many(
            "unlink", paths, strict,
            lambda parent, name, _res: self._invalidate(parent, name))

    def create_and_write_many(self, items: Sequence[Tuple[str, bytes]],
                              *, fsync: bool = False,
                              strict: bool = True) -> List:
        """Chained create→write per (path, data) item, all in ONE
        submission: each item's write is linked onto its create (SQE_LINK)
        and consumes the fresh ino via ``PrevResult("ino")`` — if the
        create fails, the write completes ECANCELED instead of running.
        With ``fsync=True`` one trailing (unchained) flush entry commits
        every item as ONE journal transaction — one checksum_batch launch
        for the whole batch, the batched analogue of per-file
        create+write+fsync. Returns bytes-written per item; a failed
        item's slot holds its first failing member's FsError."""
        paths = [p for p, _ in items]
        pairs = self._split_many(paths, strict=strict)
        idxs = [i for i, (parent, _) in enumerate(pairs)
                if not isinstance(parent, FsError)]
        entries: List[SubmissionEntry] = []
        for i in idxs:
            parent, name = pairs[i]
            entries.append(SubmissionEntry("create", (parent, name),
                                           user_data=(i, "create"),
                                           flags=SQE_LINK))
            entries.append(SubmissionEntry("write",
                                           (PrevResult("ino"), 0,
                                            items[i][1]),
                                           user_data=(i, "write")))
        if fsync and entries:
            # drain barrier: the commit waits for every chain in the batch
            entries.append(SubmissionEntry("flush", (), user_data="<flush>",
                                           flags=SQE_DRAIN))
        comps = self._submit(entries) if entries else []
        if fsync and entries:
            comps[-1].unwrap()
            comps = comps[:-1]
        out: List = [p if isinstance(p, FsError) else None
                     for p, _ in pairs]
        for c in comps:
            i, stage = c.user_data
            if stage == "create":
                if c.ok:
                    if self._use_dcache:
                        self._dcache[(pairs[i][0], pairs[i][1])] = \
                            c.result.ino
                else:
                    out[i] = FsError(c.errno, paths[i])
            elif c.ok:  # write
                out[i] = c.result
            elif not isinstance(out[i], FsError):
                out[i] = FsError(c.errno, paths[i])
        if strict:
            for r in out:
                if isinstance(r, FsError):
                    raise r
        return out

    def stat_many(self, paths: Sequence[str], *, strict: bool = True) -> List:
        resolved = self._walk_many(paths, strict=strict)
        return self._submit_sparse(
            resolved,
            lambda i: SubmissionEntry("getattr", (resolved[i],),
                                      user_data=paths[i]),
            strict)
