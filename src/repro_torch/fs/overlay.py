"""CoW overlay mounts: one immutable base image, many writable tenants.

``OverlayFilesystem`` merges TWO complete file systems into one POSIX
view, overlayfs-style:

* the **base** — a read-only image every tenant shares, mounted over a
  ``LazyBlockDevice`` with ``immutable_base=True`` (blocks materialize
  from the golden image on first read, writes to the base range are
  refused at the device — see ``repro_torch.fs.blockdev``);
* the **upper** — a small writable fs private to the tenant, holding
  every mutation: new files, copied-up base files, and *whiteouts*
  (``layout.WHITEOUT_INO`` dirents) recording "this base name is
  deleted here".

Provisioning a tenant therefore costs O(metadata): mkfs of the tiny
upper plus a lazy view of the base — never a copy of the base data
(``benchmarks/fs_coldstart.py`` asserts the ratio).

Merge rules (the overlayfs classics):

* lookup is upper-first: a live upper entry wins, a whiteout masks the
  base name (ENOENT), otherwise the base entry shows through with its
  ino tagged ``BASE_BIT`` so data ops know which layer to read;
* readdir is the union minus whiteouted names; an *opaque* upper dir
  (one carrying a whiteout named ``OPAQUE_MARK`` — set when a deleted
  base dir's name is recreated) hides the base dir wholesale;
* deleting a base-backed name writes a whiteout; deleting an upper name
  that also exists in base does both IN ONE journal transaction, so no
  crash point can resurrect the base version under a deleted name;
* writing a base file copies it up first: content is streamed into a
  hidden ``COWTMP_PREFIX`` name (invisible to the merged view; leftovers
  are reaped at mount), then ONE transaction renames it over the real
  name and applies the triggering op — at every crash point the name
  shows either the base bytes or the complete copy, never a torn blend;
* renaming a base-backed DIRECTORY (or displacing one) refuses with
  ``EXDEV``, exactly like kernel overlayfs — directories move by copy
  at a higher layer, not by the fs.

All upper mutations ride the upper's journal; multi-step overlay ops
(unlink+whiteout, mkdir+opaque, copy-up rename+write) reuse the chain
reservation machinery (``journal.begin_chain``) so each is one
crash-atomic transaction — ``repro_torch.fs.crashsim.torture_overlay``
enumerates every device write to prove it. The base journal recovers
write-free on a clean image, so an immutable base mounts repeatedly.

The overlay is itself a ``BentoFilesystem``: it mounts through the
registry, speaks the batched boundary, transfers state across live
upgrades (§4.8) and — because it leaves ``inner`` unset — can be
wrapped by the provenance layer (``repro_torch.fs.prov``) like any plain
module, with the provenance log landing in the tenant's upper.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.interface import (Attr, BentoFilesystem, Errno,
                                        FileKind, FsError, ROOT_INO)
from repro_torch.fs import layout as L
from repro_torch.fs.xv6 import Xv6FileSystem, Xv6Options

# Tag bit for inos served from the base layer: upper inos are bounded by
# ninodes (thousands), so bit 30 can never collide, and the tagged value
# still fits the u32 dirent field with room below WHITEOUT_INO.
BASE_BIT = 1 << 30

# Reserved upper names. OPAQUE_MARK is stored AS A WHITEOUT inside a
# directory (never a live entry), so plain readdir/lookup already hide
# it; COWTMP_PREFIX names are live upper files mid-copy-up, filtered
# from the merged view and reaped at mount.
OPAQUE_MARK = ".bento-opq"
COWTMP_PREFIX = ".bento-cowtmp."

# journal-blocks slack added to every chain reservation for the overlay's
# piggybacked mutations (a whiteout slot, an opacity marker)
_CHAIN_SLACK = 8


@dataclasses.dataclass
class OverlayOptions:
    """One tenant's recipe: which fs flavour runs the layers, and the
    (lazy, immutable) device holding the shared base image."""

    kind: str = "xv6"  # "xv6" | "ext4like" — class of BOTH layers
    base_dev: Any = None  # BlockDevice of the base image (per-tenant lazy view)
    upper_options: Optional[Xv6Options] = None


def _fs_class(kind: str):
    if kind == "xv6":
        return Xv6FileSystem
    if kind == "ext4like":
        from repro_torch.fs.ext4like import Ext4LikeFileSystem
        return Ext4LikeFileSystem
    raise KeyError(kind)


class OverlayFilesystem(BentoFilesystem):
    """Merged view of a writable upper fs over an immutable base fs.

    ``inner`` stays None on purpose: to the upgrade machinery this is a
    PLAIN module (wrap_layer may stack provenance on top); ``upper`` and
    ``base`` are composition, not layering — neither alone presents the
    merged namespace.
    """

    NAME = "overlay"
    VERSION = 1

    def __init__(self, opts: OverlayOptions = OverlayOptions()):
        self.opts = opts
        self.upper: Optional[Xv6FileSystem] = None
        self.base: Optional[Xv6FileSystem] = None
        self.ks = None
        # merge maps — SESSION state (rebuilt from disk at init, carried
        # across live upgrades via extract_state, lost on cold remount):
        self._mirror: Dict[int, int] = {}    # upper dir ino -> base dir ino
        self._rmirror: Dict[int, int] = {}   # base dir ino -> upper dir ino
        self._base_parent: Dict[int, Tuple[int, str]] = {}  # bino -> (bdino, name)
        self._redirect: Dict[int, int] = {}  # tagged base ino -> upper ino
        self.ov_stats = {"copy_ups": 0, "copy_up_bytes": 0,
                         "mirror_dirs": 0, "whiteouts": 0}

    # --- lifecycle -------------------------------------------------------------
    def init(self, sb, services) -> None:
        if self.opts.base_dev is None:
            raise FsError(Errno.EINVAL, "overlay needs a base device")
        cls = _fs_class(self.opts.kind)
        self.ks = services
        self.upper = cls(self.opts.upper_options
                         or Xv6Options(group_commit=True,
                                       batched_install=True))
        self.upper.init(sb, services)
        # the base gets its own internal binding over the (immutable,
        # lazily materialized) image device, checksumming on the upper's
        # device; recovery on a clean image is write-free, so mounting
        # never violates immutability
        from repro_torch.core.services import kernel_binding
        bks = kernel_binding(self.opts.base_dev,
                             device=services.device)
        self.base = cls(Xv6Options(group_commit=True, batched_install=True))
        self.base.init(bks.superblock(), bks)
        self._mirror.clear()
        self._rmirror.clear()
        self._base_parent.clear()
        self._redirect.clear()
        self._rebuild_mirrors()
        self._cleanup_tmp()

    def destroy(self) -> None:
        if self.upper is not None:
            self.upper.destroy()
        # base: nothing to destroy — no mutation ever reached it, and a
        # flush against the immutable device would be refused anyway

    # --- §4.8 state transfer ------------------------------------------------------
    def extract_state(self) -> Dict:
        state = self.upper.extract_state()
        state["overlay"] = {
            "mirror": dict(self._mirror),
            "base_parent": {k: list(v) for k, v in self._base_parent.items()},
            "redirect": dict(self._redirect),
            "ov_stats": dict(self.ov_stats),
        }
        return state

    def restore_state(self, state: Dict, from_version: int) -> None:
        ov = state.get("overlay")
        self.upper.restore_state(
            {k: v for k, v in state.items() if k != "overlay"}, from_version)
        if ov is not None:
            self._mirror = {int(k): v for k, v in ov["mirror"].items()}
            self._rmirror = {v: k for k, v in self._mirror.items()}
            self._base_parent = {int(k): (v[0], v[1])
                                 for k, v in ov["base_parent"].items()}
            self._redirect = {int(k): v for k, v in ov["redirect"].items()}
            self.ov_stats.update(ov.get("ov_stats", {}))
        else:  # plain predecessor: bootstrap the merge maps from disk
            self._rebuild_mirrors()

    def _schema_upper(self):
        # wrap_layer probes the schema on a FRESH (un-init'd) instance;
        # xv6/ext4like schemas depend only on options, so a throwaway
        # built from opts answers identically to the mounted upper
        if self.upper is not None:
            return self.upper
        return _fs_class(self.opts.kind)(
            self.opts.upper_options or Xv6Options(group_commit=True,
                                                  batched_install=True))

    def state_schema(self) -> Tuple[str, ...]:
        return self._schema_upper().state_schema() + ("overlay",)

    def optional_state_keys(self) -> Tuple[str, ...]:
        return self._schema_upper().optional_state_keys() + ("overlay",)

    # --- forwarding the stacked-layer contract (prov wraps THIS module) ----------
    @property
    def journal(self):
        return getattr(self.upper, "journal", None)

    @property
    def stats(self):
        return getattr(self.upper, "stats", {})

    @property
    def _oplock(self):
        return self.upper._oplock

    @property
    def _CHAIN_OP_BLOCKS(self):
        return self.upper._CHAIN_OP_BLOCKS

    @property
    def _current_submitter(self):
        return getattr(self.upper, "_current_submitter", None)

    def estimate_append_blocks(self, nbytes: int) -> int:
        return self.upper.estimate_append_blocks(nbytes)

    def chain_begin(self, entries, extra_blocks: int = 0):
        """Reserve the chain on the UPPER journal, widened by the
        overlay's piggybacked mutations: whiteout/opacity slots, plus a
        full copy-up (create + content + rename) for every chained
        write/truncate that targets a not-yet-copied base file — those
        all land inside the chain's one transaction."""
        extra = extra_blocks + _CHAIN_SLACK
        for e in entries:
            if e.op in ("write", "truncate"):
                kw = e.kwargs or {}
                ino = e.args[0] if e.args else kw.get("ino")
                if isinstance(ino, int) and (ino & BASE_BIT) \
                        and ino not in self._redirect:
                    try:
                        sz = self.base.getattr(ino & ~BASE_BIT).size
                    except FsError:
                        sz = 0
                    extra += (self.upper.estimate_append_blocks(sz)
                              + self.upper._CHAIN_OP_BLOCKS.get("create", 6)
                              + self.upper._CHAIN_OP_BLOCKS.get("rename", 12))
        return self.upper.chain_begin(entries, extra_blocks=extra)

    def chain_end(self) -> None:
        self.upper.chain_end()

    # --- one-transaction scope for multi-step overlay mutations -------------------
    @contextlib.contextmanager
    def _txn(self, op: str, extra_blocks: int = 0):
        """Everything inside runs as ONE upper-journal transaction (the
        prov idiom): no-ops when this thread already holds a chain scope
        (the chain IS the transaction); degrades to per-op commits when
        the reservation can never fit — multi-step ops then lose their
        crash atomicity only on journals too small to ever hold them."""
        up = self.upper
        j = up.journal
        up._oplock.acquire()
        opened = False
        try:
            if j is not None and not j.in_chain_here:
                est = (up._CHAIN_OP_BLOCKS.get(op, 16)
                       + _CHAIN_SLACK + extra_blocks)
                try:
                    j.begin_chain(est)
                    opened = True
                except FsError:
                    pass
            yield
        finally:
            if opened:
                j.end_chain()
            up._oplock.release()

    # --- ino namespace ------------------------------------------------------------
    def _resolve(self, ino: int) -> Tuple[str, int]:
        """Map a caller-visible ino to its layer: copied-up/mirrored
        tagged inos follow the redirect to their upper twin."""
        if ino & BASE_BIT:
            up = self._redirect.get(ino)
            if up is not None:
                return "upper", up
            return "base", ino & ~BASE_BIT
        return "upper", ino

    @staticmethod
    def _tag(a: Attr) -> Attr:
        return dataclasses.replace(a, ino=a.ino | BASE_BIT)

    def _dir_pair(self, dino: int) -> Tuple[Optional[int], Optional[int]]:
        """(upper dino | None, base dino | None) for a merged directory."""
        layer, real = self._resolve(dino)
        if layer == "upper":
            return real, self._mirror.get(real)
        return None, real

    def _opaque(self, u: int) -> bool:
        return OPAQUE_MARK in self.upper.dir_whiteouts(u)

    def _base_entry(self, u: Optional[int], b: Optional[int],
                    name: str) -> Optional[int]:
        """Base ino contributing ``name`` to this merged dir, or None
        (no base side, name decided by an upper slot, or opaque dir)."""
        if b is None:
            return None
        if u is not None:
            if self.upper.dir_entry_state(u, name) is not None:
                return None  # live upper entry masks; whiteout deletes
            if self._opaque(u):
                return None
        st = self.base.dir_entry_state(b, name)
        return st[1] if st is not None and st[0] == "present" else None

    @staticmethod
    def _hidden(name: str) -> bool:
        return name == OPAQUE_MARK or name.startswith(COWTMP_PREFIX)

    def _check_overlay_name(self, name, creating: bool) -> None:
        if isinstance(name, str) and self._hidden(name):
            raise FsError(Errno.EPERM if creating else Errno.ENOENT, name)

    # --- mount-time reconstruction -------------------------------------------------
    def _rebuild_mirrors(self) -> None:
        """Re-derive the upper-dir <-> base-dir pairing from disk: walk
        upper dirs from the root, pairing each with the same-named base
        dir, stopping at opaque dirs (their base twin is dead). The
        pairing is pure convention — same path, both dirs — so a cold
        remount always reconstructs the same merge the live maps held."""
        stack = [(ROOT_INO, ROOT_INO)]
        while stack:
            u, b = stack.pop()
            if self._opaque(u):
                continue  # recreated-after-delete: base side stays hidden
            self._mirror[u] = b
            self._rmirror[b] = u
            bkids = {name: (ino, kind)
                     for name, ino, kind in self.base.readdir(b)}
            for name, uino, kind in self.upper.readdir(u):
                hit = bkids.get(name)
                if kind == FileKind.DIR and hit is not None \
                        and hit[1] == FileKind.DIR:
                    stack.append((uino, hit[0]))

    def _cleanup_tmp(self) -> None:
        """Reap copy-up temporaries a crash stranded (they were never
        visible — the merged view filters the prefix)."""
        stack = [ROOT_INO]
        while stack:
            u = stack.pop()
            for name, ino, kind in self.upper.readdir(u):
                if kind == FileKind.DIR:
                    stack.append(ino)
                elif name.startswith(COWTMP_PREFIX):
                    self.upper.unlink(u, name)

    # --- copy-up machinery ----------------------------------------------------------
    def _ensure_dir_mirror(self, b: int) -> int:
        """Writable twin of base dir ``b``: mkdir the ancestor chain in
        the upper as needed. Each mkdir is its own (journaled) op —
        a crash mid-chain leaves empty mirror dirs whose names the merge
        resolves identically, so the view never changes half-way."""
        u = self._rmirror.get(b)
        if u is not None:
            return u
        loc = self._base_parent.get(b)
        if loc is None:
            raise FsError(Errno.ESTALE, f"unknown base dir {b}")
        bparent, name = loc
        up = self._ensure_dir_mirror(bparent)
        a = self.upper.mkdir(up, name)
        self._mirror[a.ino] = b
        self._rmirror[b] = a.ino
        self._redirect[b | BASE_BIT] = a.ino
        self.ov_stats["mirror_dirs"] += 1
        return a.ino

    def _copy_up(self, tagged: int, limit: Optional[int] = None) -> int:
        """Materialize a base FILE into the upper under its own name and
        return the upper ino. Content streams into a hidden temp name in
        per-chunk transactions (crash: invisible leftover, reaped at
        mount); the final rename is left to the CALLER's transaction so
        it commits atomically with the op that forced the copy-up."""
        bino = tagged & ~BASE_BIT
        loc = self._base_parent.get(bino)
        if loc is None:
            raise FsError(Errno.ESTALE, f"unknown base file {bino}")
        bparent, name = loc
        a = self.base.getattr(bino)
        if a.is_dir:
            raise FsError(Errno.EISDIR, name)
        u = self._ensure_dir_mirror(bparent)
        tmp = f"{COWTMP_PREFIX}{bino}"
        if self.upper.dir_entry_state(u, tmp) is not None:
            self.upper.unlink(u, tmp)  # stale leftover from a crashed try
        ta = self.upper.create(u, tmp)
        nbytes = a.size if limit is None else min(a.size, limit)
        chunk = 16 * L.BSIZE
        for off in range(0, nbytes, chunk):
            n = min(chunk, nbytes - off)
            self.upper.write(ta.ino, off, self.base.read(bino, off, n))
        # caller's txn: flip the name from base-backed to the full copy
        self.upper.rename(u, tmp, u, name)
        self._redirect[tagged] = ta.ino
        self.ov_stats["copy_ups"] += 1
        self.ov_stats["copy_up_bytes"] += nbytes
        return ta.ino

    # --- namespace ops ---------------------------------------------------------------
    def getattr(self, ino: int) -> Attr:
        layer, real = self._resolve(ino)
        if layer == "upper":
            return self.upper.getattr(real)
        return self._tag(self.base.getattr(real))

    def lookup(self, parent: int, name: str) -> Attr:
        self._check_overlay_name(name, creating=False)
        with self.upper._oplock:
            u, b = self._dir_pair(parent)
            if u is not None:
                st = self.upper.dir_entry_state(u, name)
                if st is not None:
                    if st[0] == "whiteout":
                        raise FsError(Errno.ENOENT, name)
                    return self.upper.getattr(st[1])
                if b is not None and self._opaque(u):
                    b = None
            if b is not None:
                a = self.base.lookup(b, name)  # ENOENT/ENOTDIR propagate
                self._base_parent[a.ino] = (b, name)
                return self._tag(a)
            if u is None:
                # pure-base parent without a base side cannot happen; a
                # FILE parent must still errno like the plain fs
                raise FsError(Errno.ENOENT, name)
            # parent may be a file: dir_entry_state above raised ENOTDIR
            raise FsError(Errno.ENOENT, name)

    def readdir(self, ino: int) -> List[Tuple[str, int, FileKind]]:
        with self.upper._oplock:
            u, b = self._dir_pair(ino)
            out: List[Tuple[str, int, FileKind]] = []
            names = set()
            masked = set()
            if u is not None:
                for name, e_ino, kind in self.upper.readdir(u):
                    if self._hidden(name):
                        continue
                    names.add(name)
                    out.append((name, e_ino, kind))
                masked = set(self.upper.dir_whiteouts(u))
                if b is not None and self._opaque(u):
                    b = None
            if b is not None:
                for name, bino, kind in self.base.readdir(b):
                    if name in names or name in masked or self._hidden(name):
                        continue
                    self._base_parent[bino] = (b, name)
                    out.append((name, bino | BASE_BIT, kind))
            return out

    def _upper_parent_for(self, parent: int) -> Tuple[int, Optional[int]]:
        """Writable dino for a mutation under ``parent`` (mirroring a
        pure-base dir on demand) plus the base twin."""
        u, b = self._dir_pair(parent)
        if u is None:
            # raises ENOTDIR via base if parent is a file, ESTALE if unknown
            bdi = self.base.getattr(b)
            if not bdi.is_dir:
                raise FsError(Errno.ENOTDIR, str(parent))
            u = self._ensure_dir_mirror(b)
        return u, self._mirror.get(u)

    def _create_common(self, parent: int, name: str, mkdir: bool) -> Attr:
        self._check_overlay_name(name, creating=True)
        with self.upper._oplock:
            u, b = self._dir_pair(parent)
            st = (self.upper.dir_entry_state(u, name)
                  if u is not None else None)
            if st is not None and st[0] == "present":
                raise FsError(Errno.EEXIST, name)
            if st is None and self._base_entry(u, b, name) is not None:
                raise FsError(Errno.EEXIST, name)
            u, b = self._upper_parent_for(parent)
            was_whiteout = st is not None  # st can only be a whiteout here
            base_dir_under = False
            if was_whiteout and mkdir and b is not None:
                bst = self.base.dir_entry_state(b, name)
                base_dir_under = (bst is not None and bst[0] == "present"
                                  and self.base.getattr(bst[1]).is_dir)
            with self._txn("mkdir" if mkdir else "create"):
                a = (self.upper.mkdir if mkdir else self.upper.create)(u, name)
                if base_dir_under:
                    # recreating a deleted base dir's name: the new dir
                    # must NOT merge with the dead base dir after a
                    # remount — mark it opaque in the same transaction
                    self.upper.dir_set_whiteout(a.ino, OPAQUE_MARK)
            return a

    def create(self, parent: int, name: str) -> Attr:
        return self._create_common(parent, name, mkdir=False)

    def mkdir(self, parent: int, name: str) -> Attr:
        return self._create_common(parent, name, mkdir=True)

    def unlink(self, parent: int, name: str) -> None:
        self._check_overlay_name(name, creating=False)
        with self.upper._oplock:
            u, b = self._dir_pair(parent)
            st = (self.upper.dir_entry_state(u, name)
                  if u is not None else None)
            if st is not None:
                if st[0] == "whiteout":
                    raise FsError(Errno.ENOENT, name)
                shadowed = self._base_shadow(u, b, name)
                with self._txn("unlink"):
                    self.upper.unlink(u, name)  # EISDIR on dirs, like plain
                    if shadowed is not None:
                        # base still has the name: mask it in the SAME
                        # transaction or a crash between the two writes
                        # would resurrect the base version
                        self.upper.dir_set_whiteout(u, name)
                        self.ov_stats["whiteouts"] += 1
                self._drop_redirects(st[1])
                return
            bino = self._base_entry(u, b, name)
            if bino is None:
                raise FsError(Errno.ENOENT, name)
            if self.base.getattr(bino).is_dir:
                raise FsError(Errno.EISDIR, name)
            u2, _ = self._upper_parent_for(parent)
            with self._txn("unlink"):
                self.upper.dir_set_whiteout(u2, name)
            self.ov_stats["whiteouts"] += 1
            self._redirect.pop(bino | BASE_BIT, None)

    def _base_shadow(self, u, b, name) -> Optional[int]:
        """Base ino that would SHOW THROUGH if the upper entry vanished
        (ignores the live upper slot, honours opacity)."""
        if b is None:
            return None
        if u is not None and self._opaque(u):
            return None
        st = self.base.dir_entry_state(b, name)
        return st[1] if st is not None and st[0] == "present" else None

    def _drop_redirects(self, upper_ino: int) -> None:
        for t, up in list(self._redirect.items()):
            if up == upper_ino:
                del self._redirect[t]

    def rmdir(self, parent: int, name: str) -> None:
        self._check_overlay_name(name, creating=False)
        with self.upper._oplock:
            u, b = self._dir_pair(parent)
            st = (self.upper.dir_entry_state(u, name)
                  if u is not None else None)
            if st is not None:
                if st[0] == "whiteout":
                    raise FsError(Errno.ENOENT, name)
                child = st[1]
                cdi = self.upper.getattr(child)
                if not cdi.is_dir:
                    raise FsError(Errno.ENOTDIR, name)
                cb = self._mirror.get(child)
                wh = [n for n in self.upper.dir_whiteouts(child)]
                if self.upper.readdir(child):
                    raise FsError(Errno.ENOTEMPTY, name)
                if cb is not None:
                    live = {n for n, _, _ in self.base.readdir(cb)}
                    if live - set(wh):
                        raise FsError(Errno.ENOTEMPTY, name)
                shadowed = self._base_shadow(u, b, name)
                with self._txn("rmdir", extra_blocks=2 * len(wh) + 2):
                    for n in wh:  # purge markers so the plain rmdir sees empty
                        self.upper.dir_clear_whiteout(child, n)
                    self.upper.rmdir(u, name)
                    if shadowed is not None:
                        self.upper.dir_set_whiteout(u, name)
                        self.ov_stats["whiteouts"] += 1
                if cb is not None:
                    self._mirror.pop(child, None)
                    self._rmirror.pop(cb, None)
                    self._redirect.pop(cb | BASE_BIT, None)
                return
            bino = self._base_entry(u, b, name)
            if bino is None:
                raise FsError(Errno.ENOENT, name)
            ba = self.base.getattr(bino)
            if not ba.is_dir:
                raise FsError(Errno.ENOTDIR, name)
            if self.base.readdir(bino):
                raise FsError(Errno.ENOTEMPTY, name)
            u2, _ = self._upper_parent_for(parent)
            with self._txn("rmdir"):
                self.upper.dir_set_whiteout(u2, name)
            self.ov_stats["whiteouts"] += 1

    def rename(self, parent: int, name: str,
               newparent: int, newname: str) -> None:
        self._check_overlay_name(name, creating=False)
        self._check_overlay_name(newname, creating=True)
        with self.upper._oplock:
            su, sb_ = self._dir_pair(parent)
            sst = (self.upper.dir_entry_state(su, name)
                   if su is not None else None)
            if sst is not None and sst[0] == "whiteout":
                raise FsError(Errno.ENOENT, name)
            src_base = None
            src_is_dir = False
            if sst is None:
                src_base = self._base_entry(su, sb_, name)
                if src_base is None:
                    raise FsError(Errno.ENOENT, name)
                self._base_parent[src_base] = (sb_, name)
                if self.base.getattr(src_base).is_dir:
                    # a base-backed directory cannot move: its children
                    # live below, in the read-only layer (overlayfs EXDEV)
                    raise FsError(Errno.EXDEV, name)
            else:
                src_is_dir = self.upper.getattr(sst[1]).is_dir
                if src_is_dir and sst[1] in self._mirror:
                    raise FsError(Errno.EXDEV, name)  # merged dir: same rule
            du, db = self._dir_pair(newparent)
            dst_upper = (self.upper.dir_entry_state(du, newname)
                         if du is not None else None)
            base_dir_under_dst = False
            if dst_upper is not None and dst_upper[0] == "present":
                ddi = self.upper.getattr(dst_upper[1])
                if ddi.is_dir and dst_upper[1] in self._mirror:
                    raise FsError(Errno.EXDEV, newname)  # displacing merged
            else:
                dst_base = self._base_entry(du, db, newname)
                if dst_base is not None \
                        and self.base.getattr(dst_base).is_dir:
                    raise FsError(Errno.EXDEV, newname)  # displacing base dir
                if dst_upper is not None and db is not None:
                    # destination is a whiteout masking the base: if the
                    # dead base name was a DIR and a DIR is moving in, the
                    # newcomer must go opaque or a remount's mirror walk
                    # would pair it with the deleted base dir
                    bst = self.base.dir_entry_state(db, newname)
                    base_dir_under_dst = (
                        bst is not None and bst[0] == "present"
                        and self.base.getattr(bst[1]).is_dir)
            # below here everything is upper-resolvable: copy up a base
            # file source, mirror the destination parent, then ONE plain
            # upper rename (overwrite semantics included) plus the
            # overlay's masking writes, all in one transaction
            du2, db2 = self._upper_parent_for(newparent)
            if src_base is not None:
                su, sb_ = self._upper_parent_for(parent)
            src_shadow = self._base_shadow(su, sb_, name)
            dst_shadow_file = None
            if dst_upper is not None and dst_upper[0] == "present":
                dst_shadow_file = dst_upper[1]
            extra = 0
            if src_base is not None:
                extra = (self.upper.estimate_append_blocks(
                             self.base.getattr(src_base).size)
                         + self.upper._CHAIN_OP_BLOCKS.get("create", 6))
            moved_in_place = (su == du2 and name == newname)
            with self._txn("rename", extra_blocks=extra):
                if src_base is not None:
                    self._copy_up(src_base | BASE_BIT)
                self.upper.rename(su, name, du2, newname)
                if src_shadow is not None and not moved_in_place:
                    # the source name vanished from the upper but still
                    # exists below: mask it in the same transaction
                    self.upper.dir_set_whiteout(su, name)
                    self.ov_stats["whiteouts"] += 1
                if base_dir_under_dst and src_is_dir \
                        and not moved_in_place:
                    moved = self.upper.dir_entry_state(du2, newname)
                    self.upper.dir_set_whiteout(moved[1], OPAQUE_MARK)
            if dst_shadow_file is not None and not moved_in_place:
                self._drop_redirects(dst_shadow_file)

    # --- data ops ----------------------------------------------------------------------
    def read(self, ino: int, off: int, size: int) -> bytes:
        layer, real = self._resolve(ino)
        if layer == "upper":
            return self.upper.read(real, off, size)
        return self.base.read(real, off, size)

    def write(self, ino: int, off: int, data: bytes) -> int:
        layer, real = self._resolve(ino)
        if layer == "upper":
            return self.upper.write(real, off, data)
        with self.upper._oplock:
            with self._txn("write",
                           extra_blocks=self.upper.estimate_append_blocks(
                               self.base.getattr(real).size + len(data))):
                up = self._copy_up(ino)
                return self.upper.write(up, off, data)

    def truncate(self, ino: int, size: int) -> None:
        layer, real = self._resolve(ino)
        if layer == "upper":
            return self.upper.truncate(real, size)
        with self.upper._oplock:
            with self._txn("write",
                           extra_blocks=self.upper.estimate_append_blocks(
                               min(self.base.getattr(real).size, size))):
                # only the surviving prefix is worth copying
                up = self._copy_up(ino, limit=size)
                return self.upper.truncate(up, size)

    def fsync(self, ino: int) -> None:
        layer, real = self._resolve(ino)
        if layer == "upper":
            self.upper.fsync(real)
        # base inos: immutable and already durable — nothing to sync

    def flush(self) -> None:
        self.upper.flush()

    def statfs(self) -> Dict[str, int]:
        return self.upper.statfs()

    def read_provenance(self, since: int = 0, offset: int = 0,
                        limit: Optional[int] = None):
        return self.upper.read_provenance(since, offset, limit)
