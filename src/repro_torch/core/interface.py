"""The Bento module boundary (paper §4.3), batched.

Two interfaces cross the boundary:

* ``BentoModule`` — the generic versioned-extension contract every substrate
  implements (file systems, model modules, optimizers, data pipelines):
  ``extract_state`` / ``restore_state`` make online upgrade, checkpoint,
  elastic rescale and failure recovery one protocol (§4.8).

* ``BentoFilesystem`` — the file-operations API, a port of the FUSE
  low-level API augmented with the SuperBlock capability (§4.3): inode-
  granular operations, plain values in/out, no kernel structures exposed.
  Ownership of arguments never transfers: ``bytes`` in/out are immutable
  (a shared borrow), capabilities are held, never owned.

The native shape of the boundary is a *batch*, io_uring style. Callers
build a list of ``SubmissionEntry(op, args, user_data)`` records and hand
them across the boundary once; they get back one ``CompletionEntry`` per
submission, in submission order. Two rules make the batch a faithful
extension of the paper's single-op design rather than a new protocol:

* plain values only — entries and completions carry ints/bytes/strs, the
  same no-kernel-structures rule as scalar ops (§4.3);
* errors never cross as exceptions — a failing entry (fs error or
  malformed entry) completes with an ``errno`` and does not poison its
  neighbours, exactly like a CQE's ``res`` field. ``FsError`` still
  exists for the scalar convenience methods. Only genuine implementation
  exceptions (bugs) propagate, as they do through scalar dispatch.

``BentoFilesystem.submit_batch`` is the override hook: the default loops
scalar ops with per-entry errno capture, so every module is batchable;
modules that can do better (vectorized reads that hit the buffer cache
once, one journal transaction per batch, one checksum kernel launch per
commit) override it — see ``repro_torch.fs.xv6``.

Entries may also be *chained*, io_uring ``IOSQE_LINK`` style: an entry
whose ``flags`` carry ``SQE_LINK`` links the NEXT entry into its chain, so
entry N+1 runs only if entry N completed without an errno. The first
failure in a chain cancels every remaining member, which complete with
``Errno.ECANCELED`` (never silently dropped — one completion per
submission always holds). Chain semantics live ABOVE ``submit_batch``, in
``execute_batch``: dispatch layers (``Mount.submit``, the VFS-direct
baseline, the FUSE daemon) route batches through it, modules never see the
flags. A chained entry may use ``PrevResult`` placeholders in its args to
consume an earlier chain member's result (e.g. the ino of a just-created
file: create → write(PrevResult("ino"), ...) → fsync), the io_uring
fixed-file trick generalized to plain values. Because a whole submission
executes under ONE gate crossing (see ``repro_torch.core.registry``), an online
upgrade's table swap can never land between two members of a chain: chains
are atomic with respect to module generations, like batches (§4.8).

Chains are also atomic with respect to CRASHES: ``execute_batch`` wraps
every chain group in the module's ``chain_begin``/``chain_end`` hooks, and
journaled modules use them to reserve the whole chain as ONE journal
transaction (sized from the submission entries; a chain that can never fit
completes ENOSPC-first/ECANCELED-rest before staging anything) — see
``repro_torch.fs.journal`` for the transaction semantics and
``repro_torch.fs.crashsim`` for the exhaustive crash-point proof. ``SQE_DRAIN``
marks a barrier entry that runs only after every prior entry in the batch
completed, documenting ordering for mixed chain/unchained batches.

Concurrent submitters compose through ``execute_multi_batch``: many
per-thread submissions drain under one gate crossing (io_uring
SQPOLL-style — see ``repro_torch.core.registry``), with chains grouped per
submitter and unchained runs coalesced across submitters. When the module
exposes lock-domain hooks (``group_footprint``/``domain_scope`` — the
sharded replacement for the big fs lock, see ``repro_torch.fs.xv6``) and the
drain is handed a worker ``pool``, non-overlapping dispatch groups
execute concurrently instead of serially, multi-queue block-driver style.
"""

from __future__ import annotations

import abc
import concurrent.futures
import dataclasses
import enum
import inspect
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from repro_torch.core.capability import SuperBlockCap


class Errno(enum.IntEnum):
    EPERM = 1   # mutating fs-internal reserved names (the dedup index)
    ENOENT = 2
    EIO = 5
    EEXIST = 17
    EXDEV = 18  # overlay: rename would cross the base/upper "device" line
    ENOTDIR = 20
    EISDIR = 21
    EINVAL = 22
    EFBIG = 27
    ENOSPC = 28
    ENOTEMPTY = 39
    ETIME = 62  # linked timeout fired: its chain's deadline passed
    ESTALE = 116
    ECANCELED = 125  # chained entry cancelled: an earlier link failed


class FsError(Exception):
    def __init__(self, errno: Errno, msg: str = ""):
        super().__init__(f"{errno.name}: {msg}")
        self.errno = errno


class FileKind(enum.IntEnum):
    FILE = 1
    DIR = 2


@dataclasses.dataclass
class Attr:
    """Plain-value attribute record — no shared kernel structures (§4.3)."""

    ino: int
    kind: FileKind
    size: int
    nlink: int
    mtime: float = 0.0

    @property
    def is_dir(self) -> bool:
        return self.kind == FileKind.DIR


ROOT_INO = 1


# --- batched boundary records (io_uring-shaped, §4.3 plain values) ---------------

# The file-operations table, in canonical order — the ONE list every
# dispatch surface derives from (``Mount``'s function table, the
# VFS-direct baseline, the FUSE client/daemon). ``init``/``destroy`` are
# lifecycle-only and ``submit_batch`` itself may not nest.
FS_OPS = ("getattr", "lookup", "create", "mkdir", "unlink", "rmdir", "rename",
          "readdir", "read", "write", "truncate", "fsync", "flush", "statfs",
          "read_provenance")

# Ops that may appear in a submission batch.
BATCHABLE_OPS = frozenset(FS_OPS)


# SubmissionEntry.flags bits (io_uring IOSQE_* analogues).
SQE_LINK = 0x1   # link the NEXT entry into this entry's chain
SQE_LINK_TIMEOUT = 0x4  # this entry is a deadline guard for its chain
#   (io_uring IOSQE_IO_LINK + link-timeout SQE): args=(monotonic_deadline,)
#   where the deadline is a ``time.monotonic()`` timestamp. The entry is
#   never dispatched to the module; conventionally its op is
#   "link_timeout" (rejected EINVAL by modules, so a stray flagless copy
#   fails loudly). If the deadline has already passed when the chain
#   DRAINS, the whole chain is refused before anything is staged: the
#   timeout entry completes ``Errno.ETIME`` and every other member
#   ``ECANCELED``. If the deadline passes between members (this executor
#   is synchronous, so that is the only other observation point), the
#   remaining members are cancelled the same way. Otherwise the chain
#   runs to completion and the timeout entry completes with result 0,
#   io_uring's "timeout cancelled because the link finished first". A
#   guard is invisible to ``PrevResult`` data flow: ``back`` counts REAL
#   members only, so an op right after the guard still reads the op
#   right before it with the default back=1. The
#   flag is only meaningful inside a chain — a bare flagged entry reaches
#   the module as an ordinary op and EINVALs on the conventional opname.
SQE_DRAIN = 0x2  # barrier: run only after ALL prior entries in the batch
#   completed (io_uring IOSQE_IO_DRAIN). In this synchronous executor every
#   entry already completes before the next starts; the observable effect is
#   that a drain entry starts a NEW dispatch group, so a module's vectorized
#   coalescing (same-op runs, write merging) never crosses the barrier. This
#   is how a mixed batch documents ordering: "everything before the drain —
#   including any chain, whatever its fate — is complete before this runs."
#   A drain flag on a LATER chain member is redundant and ignored: chains
#   are already ordered and are never severed by a barrier.


@dataclasses.dataclass(frozen=True)
class PrevResult:
    """Placeholder argument inside a *chained* entry: replaced at execution
    time by the result of the chain member ``back`` entries earlier (1 =
    the immediately preceding entry). ``attr`` optionally projects a named
    attribute of that result (e.g. ``PrevResult("ino")`` after a create).

    Only ``execute_batch`` resolves these, and only inside a chain; a
    placeholder that reaches dispatch unresolved (unchained entry, or
    ``back`` pointing before the chain start) completes with ``EINVAL``.
    The referenced member always succeeded — a failed link would already
    have cancelled this entry."""

    attr: Optional[str] = None
    back: int = 1


@dataclasses.dataclass(slots=True)
class SubmissionEntry:
    """One SQE: which op, its plain-value args, an opaque cookie the
    caller uses to match the completion (never interpreted by the fs), and
    link flags (``SQE_LINK`` chains the next entry — see ``execute_batch``).

    Treat as immutable once submitted (not ``frozen=True`` only because a
    frozen __init__ costs ~3x on the hot path — batches are built in
    bulk)."""

    op: str
    args: Tuple[Any, ...] = ()
    kwargs: Optional[Dict[str, Any]] = None  # None == {} (skips an alloc)
    user_data: Any = None
    flags: int = 0
    # who staged this entry — stamped by the submission queue (SQPOLL
    # drain) from the registered submitter identity, so provenance records
    # and dedup index stats attribute work to the real submitter instead
    # of guessing from the dispatching thread. None: direct/anonymous
    # submission.
    submitter: Optional[str] = None


@dataclasses.dataclass(slots=True)
class CompletionEntry:
    """One CQE: the submission's cookie plus result XOR errno."""

    user_data: Any
    result: Any = None
    errno: Optional[Errno] = None

    @property
    def ok(self) -> bool:
        return self.errno is None

    def unwrap(self):
        """Scalar-shim helper: re-raise the errno the way the scalar API
        would have (the only place batch errors become exceptions again)."""
        if self.errno is not None:
            raise FsError(self.errno, f"batched {self.user_data!r}")
        return self.result


def split_chains(entries: List["SubmissionEntry"]
                 ) -> List[Tuple[bool, List["SubmissionEntry"]]]:
    """Group a batch into ``(is_chain, members)`` runs. A chain is a
    maximal run of SQE_LINK entries plus the first entry after them (the
    chain's tail); a trailing SQE_LINK at batch end simply ends the chain
    there, like an io_uring link that reaches the submit boundary. An
    SQE_DRAIN entry always STARTS a group (the barrier: every prior group
    completes first); a drain inside a chain never severs it."""
    groups: List[Tuple[bool, List[SubmissionEntry]]] = []
    i, n = 0, len(entries)
    while i < n:
        j = i
        if entries[i].flags & SQE_LINK:
            while j < n and entries[j].flags & SQE_LINK:
                j += 1
            j = min(j + 1, n)  # include the tail entry
            groups.append((True, entries[i:j]))
        else:
            while j < n and not (entries[j].flags & SQE_LINK) \
                    and not (j > i and entries[j].flags & SQE_DRAIN):
                j += 1
            groups.append((False, entries[i:j]))
        i = j
    return groups


def _resolve_placeholders(entry: "SubmissionEntry",
                          done: List["CompletionEntry"]):
    """Substitute PrevResult args from the chain's completions so far.
    Returns a substituted entry, or a CompletionEntry(EINVAL) when a
    placeholder is unresolvable (bad ``back`` / missing attribute)."""
    def sub(v):
        if not isinstance(v, PrevResult):
            return v
        if v.back < 1 or v.back > len(done):
            raise LookupError(f"PrevResult back={v.back} escapes the chain")
        r = done[-v.back].result
        return getattr(r, v.attr) if v.attr else r

    try:
        args = tuple(sub(a) for a in entry.args)
        kwargs = ({k: sub(v) for k, v in entry.kwargs.items()}
                  if entry.kwargs else None)
    except (LookupError, AttributeError):
        return CompletionEntry(entry.user_data, errno=Errno.EINVAL)
    if args == entry.args and kwargs == entry.kwargs:
        return entry
    return SubmissionEntry(entry.op, args, kwargs, entry.user_data,
                           entry.flags, entry.submitter)


def _run_chain(submit_batch, group, chain_begin, chain_end
               ) -> List["CompletionEntry"]:
    """Execute ONE chain group member-by-member under the module's chain
    reservation scope — the single implementation of the SQE_LINK rules
    (including SQE_LINK_TIMEOUT deadline guards) shared by
    ``execute_batch`` and ``execute_multi_batch``."""
    has_timeout = any(e.flags & SQE_LINK_TIMEOUT for e in group)
    deadline = None
    if has_timeout:
        ds = [e.args[0] for e in group
              if e.flags & SQE_LINK_TIMEOUT and e.args
              and isinstance(e.args[0], (int, float))
              and not isinstance(e.args[0], bool)]
        deadline = min(ds) if ds else None
        if deadline is not None and time.monotonic() >= deadline:
            # expired before the drain reached this chain: refuse it whole
            # with nothing staged (no chain_begin, no journal reservation)
            return [CompletionEntry(e.user_data, errno=(
                        Errno.ETIME if e.flags & SQE_LINK_TIMEOUT
                        else Errno.ECANCELED)) for e in group]
    members = ([e for e in group if not (e.flags & SQE_LINK_TIMEOUT)]
               if has_timeout else group)
    if chain_begin is not None:
        err = chain_begin(members)
        if err is not None:  # chain can never fit: nothing was staged
            return ([CompletionEntry(group[0].user_data, errno=err)]
                    + [CompletionEntry(e.user_data, errno=Errno.ECANCELED)
                       for e in group[1:]])
    done: List[CompletionEntry] = []
    # guards are timers, not data producers: PrevResult resolves against
    # the completions of REAL members only, so ``back=1`` after a guard
    # still names the op before it (io_uring's timeout SQE is likewise
    # invisible to the data flow of its link chain)
    data_done: List[CompletionEntry] = []
    expired = False
    try:
        for e in group:
            is_guard = bool(e.flags & SQE_LINK_TIMEOUT)
            # every entry (guards included) observes the clock at its
            # position: a guard reached after the deadline passed reports
            # ETIME itself rather than letting a later member's ECANCELED
            # contradict a "timer cancelled" completion
            if not expired and deadline is not None \
                    and time.monotonic() >= deadline:
                expired = True
            if is_guard:
                if expired:
                    done.append(CompletionEntry(e.user_data,
                                                errno=Errno.ETIME))
                elif done and not done[-1].ok:
                    done.append(CompletionEntry(e.user_data,
                                                errno=Errno.ECANCELED))
                elif not (e.args and isinstance(e.args[0], (int, float))
                          and not isinstance(e.args[0], bool)):
                    done.append(CompletionEntry(e.user_data,
                                                errno=Errno.EINVAL))
                else:  # the chain beat its deadline: timeout cancelled
                    done.append(CompletionEntry(e.user_data, result=0))
                continue
            if expired or (done and not done[-1].ok):
                done.append(CompletionEntry(e.user_data,
                                            errno=Errno.ECANCELED))
                continue
            resolved = _resolve_placeholders(e, data_done)
            if isinstance(resolved, CompletionEntry):
                done.append(resolved)
            else:
                done.append(submit_batch([resolved])[0])
            data_done.append(done[-1])
    finally:
        if chain_end is not None:
            chain_end()
    return done


def execute_batch(submit_batch, entries) -> List["CompletionEntry"]:
    """Chain-aware batch executor — the one implementation of SQE_LINK
    (and SQE_DRAIN barriers).

    Unchained runs go to ``submit_batch`` whole, keeping the module's
    vectorized fast paths (a drain entry starts a fresh run, so coalescing
    never crosses the barrier); chained runs execute member-by-member
    (each member may depend on the previous one's result via
    ``PrevResult``), and the first failing member cancels the rest of its
    chain with ``ECANCELED``. Callers hold whatever gate/lock makes the
    whole batch atomic — this function never re-enters dispatch.

    Chains are *reserved* as one journal transaction: when the module
    behind ``submit_batch`` exposes the ``chain_begin``/``chain_end``
    hooks (see ``BentoFilesystem``), every chain group runs inside that
    scope, so all members' journal writes land in a single commit — a
    crash at any device write leaves the whole chain installed or none of
    it. A chain whose estimated footprint can never fit the journal is
    refused up front: its FIRST member completes with the errno
    ``chain_begin`` returned (``ENOSPC``) *before any block is staged* and
    the rest complete ``ECANCELED`` — a raw ``JournalFull`` never escapes
    the boundary. All three dispatch layers (``Mount.submit``, the
    VFS-direct baseline, the FUSE daemon) share this path."""
    if not isinstance(entries, list):
        entries = list(entries)
    if not any(e.flags & (SQE_LINK | SQE_DRAIN) for e in entries):
        return submit_batch(entries)  # fast path: no chains/barriers staged
    owner = getattr(submit_batch, "__self__", None)
    chain_begin = getattr(owner, "chain_begin", None)
    chain_end = getattr(owner, "chain_end", None)
    comps: List[CompletionEntry] = []
    for is_chain, group in split_chains(entries):
        if is_chain:
            comps.extend(_run_chain(submit_batch, group, chain_begin,
                                    chain_end))
        else:
            comps.extend(submit_batch(group))
    return comps


def execute_multi_batch(submit_batch, segments, pool=None
                        ) -> List[List["CompletionEntry"]]:
    """Multi-submitter batch executor: each *segment* is one submitter's
    submission, and the whole call runs under ONE gate crossing held by
    the caller (the drain of the SQPOLL-style multi-queue design — see
    ``repro_torch.core.registry``).

    Two rules extend the single-batch semantics to concurrent submitters:

    * chains are grouped PER SEGMENT — a trailing ``SQE_LINK`` in one
      submitter's segment ends its chain at the segment boundary, exactly
      like an io_uring link reaching the submit boundary; it can never
      link into another submitter's first entry;
    * adjacent *unchained* runs from different segments coalesce into one
      ``submit_batch`` call, so the module's vectorized fast paths (bulk
      cache passes, one directory scan per parent, write merging)
      amortize ACROSS submitters — the throughput half of the design. A
      segment-internal ``SQE_DRAIN`` barrier still starts a fresh run, so
      per-submitter ordering documentation survives the merge.

    Entries execute in segment-major order (each segment's internal order
    preserved); concurrent submissions have no mutual ordering contract.
    Returns one completion list per segment, each in submission order.

    With a worker ``pool`` (any ``concurrent.futures`` executor) and a
    module exposing the lock-domain hooks (``group_footprint`` /
    ``domain_scope`` — see ``repro_torch.fs.xv6``), the drain schedules
    NON-OVERLAPPING dispatch groups onto the pool concurrently instead of
    draining serially, multi-queue block-driver style: each group's
    footprint (the set of lock domains its entries touch, computed by the
    same estimator machinery ``chain_begin`` sizes transactions with) is
    consulted, a group waits for every earlier group it could overlap
    (same submitter, shared domain, or an unanalyzable ``None`` footprint
    — which overlaps everything), and each group runs under
    ``domain_scope(footprint)`` so the module's sharded domain locks
    stand in for the big fs lock. Journal commit remains the only global
    serialization point. Per-segment completion order, chain atomicity
    and errno discipline are identical to the serial drain; unchained
    runs do NOT coalesce across submitters in parallel mode (they may
    land on different workers). Falls back to the serial drain when the
    hooks are absent or no footprint is analyzable."""
    segments = [s if isinstance(s, list) else list(s) for s in segments]
    if len(segments) == 1:
        return [execute_batch(submit_batch, segments[0])]
    owner = getattr(submit_batch, "__self__", None)
    chain_begin = getattr(owner, "chain_begin", None)
    chain_end = getattr(owner, "chain_end", None)
    flat: List[Tuple[int, bool, List[SubmissionEntry]]] = []
    for si, entries in enumerate(segments):
        for is_chain, group in split_chains(entries):
            flat.append((si, is_chain, group))
    if pool is not None:
        par = _execute_multi_parallel(submit_batch, owner, chain_begin,
                                      chain_end, segments, flat, pool)
        if par is not None:
            return par
    out: List[List[CompletionEntry]] = [[] for _ in segments]
    i, n = 0, len(flat)
    while i < n:
        si, is_chain, group = flat[i]
        if is_chain:
            out[si].extend(_run_chain(submit_batch, group, chain_begin,
                                      chain_end))
            i += 1
            continue
        # coalesce adjacent unchained groups (across submitters) into one
        # dispatch; a group opening with a DRAIN barrier starts its own
        run = [(si, group)]
        j = i + 1
        while j < n and not flat[j][1] \
                and not (flat[j][2][0].flags & SQE_DRAIN):
            run.append((flat[j][0], flat[j][2]))
            j += 1
        comps = submit_batch([e for _, g in run for e in g])
        k = 0
        for rsi, g in run:
            out[rsi].extend(comps[k:k + len(g)])
            k += len(g)
        i = j
    return out


def _execute_multi_parallel(submit_batch, owner, chain_begin, chain_end,
                            segments, flat, pool
                            ) -> Optional[List[List["CompletionEntry"]]]:
    """Footprint-scheduled parallel drain over a worker pool.

    Returns ``None`` when the module lacks the lock-domain hooks or no
    group has an analyzable footprint — the caller then falls back to the
    serial drain, which is byte-identical to the pre-sharding behaviour.

    Scheduling is a dependency DAG over the flattened dispatch groups:
    group *j* waits on every earlier group *i* that (a) belongs to the
    same segment (per-submitter order is a contract), or (b) has an
    overlapping footprint — with ``None`` (unanalyzable) treated as
    overlapping everything, so such groups act as barriers and run under
    the table's global exclusive bracket. The DRAINER thread runs this
    loop and never executes module code itself; workers never touch the
    op gate (the drainer's single crossing brackets the whole drain) and
    never wait on futures, so the pool cannot deadlock on itself. The
    first implementation exception stops new scheduling, lets in-flight
    groups finish, and re-raises — poisoning the drain exactly like the
    serial path."""
    group_footprint = getattr(owner, "group_footprint", None)
    domain_scope = getattr(owner, "domain_scope", None)
    if group_footprint is None or domain_scope is None:
        return None
    fps = [group_footprint(group) for _, _, group in flat]
    if all(fp is None for fp in fps):
        return None  # every group would serialize anyway: serial drain wins
    n = len(flat)
    ndeps = [0] * n
    dependents: List[List[int]] = [[] for _ in range(n)]
    for j in range(n):
        sj, fj = flat[j][0], fps[j]
        for i in range(j):
            if flat[i][0] == sj or fps[i] is None or fj is None \
                    or (fps[i] & fj):
                ndeps[j] += 1
                dependents[i].append(j)
    results: List[Optional[List[CompletionEntry]]] = [None] * n

    def run_unit(u: int) -> List[CompletionEntry]:
        _, is_chain, group = flat[u]
        with domain_scope(fps[u]):
            if is_chain:
                return _run_chain(submit_batch, group, chain_begin,
                                  chain_end)
            return submit_batch(group)

    ready = [u for u in range(n) if ndeps[u] == 0]
    in_flight: Dict[Any, int] = {}
    first_exc: Optional[BaseException] = None
    while in_flight or (ready and first_exc is None):
        if first_exc is None:
            for u in ready:
                in_flight[pool.submit(run_unit, u)] = u
            ready = []
        done, _ = concurrent.futures.wait(
            in_flight, return_when=concurrent.futures.FIRST_COMPLETED)
        for f in done:
            u = in_flight.pop(f)
            try:
                results[u] = f.result()
            except BaseException as e:  # a module bug, not an fs errno
                if first_exc is None:
                    first_exc = e
                continue
            for v in dependents[u]:
                ndeps[v] -= 1
                if ndeps[v] == 0:
                    ready.append(v)
    if first_exc is not None:
        raise first_exc
    out: List[List[CompletionEntry]] = [[] for _ in segments]
    for u in range(n):
        out[flat[u][0]].extend(results[u])
    return out


class BentoModule(abc.ABC):
    """Versioned extension: the §4.8 state-transfer contract."""

    NAME: str = "module"
    VERSION: int = 1

    def extract_state(self) -> Dict[str, Any]:
        """Serialize transferable in-memory state before an upgrade.

        Called only after the runtime has quiesced the module (no in-flight
        operations, no outstanding mutable borrows)."""
        return {}

    def restore_state(self, state: Dict[str, Any], from_version: int) -> None:
        """Install state extracted from ``from_version`` of this module."""
        del state, from_version

    def state_schema(self) -> Tuple[str, ...]:
        """Keys this version emits/accepts — checked at upgrade time."""
        return ()

    def optional_state_keys(self) -> Tuple[str, ...]:
        """Subset of ``state_schema`` this version can synthesize when the
        outgoing module never emitted it — the layer-aware half of the
        schema check. A stackable layer (``repro_torch.fs.prov``) lists its own
        keys here so a PLAIN module can be upgraded into the layered one
        without a migrate hook: the layer bootstraps its private state and
        forwards everything else to its inner module. Keys NOT listed stay
        strictly required, so a genuinely incomplete transfer still fails
        loudly."""
        return ()


class BentoFilesystem(BentoModule):
    """File-operations API (FUSE low-level port + SuperBlock capability)."""

    # --- lifecycle -------------------------------------------------------------
    @abc.abstractmethod
    def init(self, sb: SuperBlockCap, services: "KernelServices") -> None:
        """Mount-time: the runtime lends the superblock capability and the
        kernel-services API. The fs must not stash raw kernel objects."""

    def destroy(self) -> None:
        pass

    # --- inode ops ---------------------------------------------------------------
    @abc.abstractmethod
    def getattr(self, ino: int) -> Attr: ...

    @abc.abstractmethod
    def lookup(self, parent: int, name: str) -> Attr: ...

    @abc.abstractmethod
    def create(self, parent: int, name: str) -> Attr: ...

    @abc.abstractmethod
    def mkdir(self, parent: int, name: str) -> Attr: ...

    @abc.abstractmethod
    def unlink(self, parent: int, name: str) -> None: ...

    @abc.abstractmethod
    def rmdir(self, parent: int, name: str) -> None: ...

    @abc.abstractmethod
    def rename(self, parent: int, name: str, newparent: int, newname: str) -> None: ...

    @abc.abstractmethod
    def readdir(self, ino: int) -> List[Tuple[str, int, FileKind]]: ...

    # --- data ops -------------------------------------------------------------------
    @abc.abstractmethod
    def read(self, ino: int, off: int, size: int) -> bytes: ...

    @abc.abstractmethod
    def write(self, ino: int, off: int, data: bytes) -> int: ...

    @abc.abstractmethod
    def truncate(self, ino: int, size: int) -> None: ...

    @abc.abstractmethod
    def fsync(self, ino: int) -> None: ...

    def flush(self) -> None:
        """Write back everything (unmount / upgrade barrier)."""

    @abc.abstractmethod
    def statfs(self) -> Dict[str, int]: ...

    # --- stackable layers (provenance query op) ---------------------------------
    # A stackable module (see ``repro_torch.fs.prov``) wraps another
    # BentoFilesystem and sets ``inner``; dispatch layers never care, but
    # the upgrade path uses it to wrap/unwrap layers onto a live mount.
    inner: Optional["BentoFilesystem"] = None

    def read_provenance(self, since: int = 0, offset: int = 0,
                        limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """Query the provenance log (paper §6): plain-value records, each
        carrying at least ``seq``/``op``/``ino``/``parent``/``name``/``ts``,
        for records with ``seq >= since``. ``offset``/``limit`` paginate
        within that selection (submission payloads stay bounded however
        large the log grows). Part of the file-operations API so it crosses
        every dispatch layer (scalar, batched, FUSE) like any other op;
        modules without a provenance layer refuse it with ``EINVAL``, the
        way an unknown ioctl would be."""
        del since, offset, limit
        raise FsError(Errno.EINVAL, "no provenance layer mounted")

    # --- batched boundary ------------------------------------------------------
    _SIG_CACHE: Dict[Tuple[type, str], tuple] = {}

    # basic value shapes checked pre-call for the data ops, so a malformed
    # entry completes EINVAL while a TypeError from inside a correctly-
    # called op (an implementation bug) propagates loudly, like scalar
    # dispatch. ``bound`` is a plain {param: value} mapping.
    _VALUE_CHECKS = {
        "write": lambda bound: (isinstance(bound.get("data"),
                                           (bytes, bytearray))
                                and isinstance(bound.get("off"), int)),
        "read": lambda bound: (isinstance(bound.get("off"), int)
                               and isinstance(bound.get("size"), int)),
    }

    def _entry_fits(self, op: str, args, kwargs) -> bool:
        """Does (args, kwargs) form a well-shaped call of ``op``? Checked
        BEFORE dispatch: arity/keywords via a precomputed shape of the
        signature (``inspect.signature`` binding per entry was the single
        hottest line of batched dispatch), plus the per-op basic value
        shapes above. An unresolved ``PrevResult`` placeholder (legal
        only inside a chain, where ``execute_batch`` substitutes it
        before dispatch) never fits."""
        if any(isinstance(a, PrevResult) for a in args) or \
                (kwargs and any(isinstance(v, PrevResult)
                                for v in kwargs.values())):
            return False
        key = (type(self), op)
        meta = self._SIG_CACHE.get(key)
        if meta is None:
            sig = inspect.signature(getattr(self, op))
            simple = all(p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                                    inspect.Parameter.POSITIONAL_OR_KEYWORD)
                         for p in sig.parameters.values())
            if simple:
                names = tuple(sig.parameters)
                required = sum(1 for p in sig.parameters.values()
                               if p.default is inspect.Parameter.empty)
                meta = (names, required)
            else:  # kw-only / varargs: keep real binding semantics
                meta = (None, sig)
            self._SIG_CACHE[key] = meta
        names, required = meta
        if names is None:
            try:
                bound = required.bind(*args, **(kwargs or {})).arguments
            except TypeError:
                return False
        else:
            if len(args) > len(names):
                return False
            bound = dict(zip(names, args))
            if kwargs:
                for k, v in kwargs.items():
                    if k not in names or k in bound:
                        return False
                    bound[k] = v
            if sum(1 for n in names[:required] if n in bound) < required:
                return False
        check = self._VALUE_CHECKS.get(op)
        return check is None or check(bound)

    def _dispatch_one(self, entry: SubmissionEntry) -> CompletionEntry:
        """Run one entry with per-entry errno capture: malformed entries
        and FsErrors become errnos; implementation exceptions propagate."""
        if (entry.op not in BATCHABLE_OPS
                or not self._entry_fits(entry.op, entry.args, entry.kwargs)):
            return CompletionEntry(entry.user_data, errno=Errno.EINVAL)
        try:
            fn = getattr(self, entry.op)
            return CompletionEntry(entry.user_data,
                                   result=fn(*entry.args,
                                             **(entry.kwargs or {})))
        except FsError as e:
            return CompletionEntry(entry.user_data, errno=e.errno)

    def submit_batch(self, entries: Iterable[SubmissionEntry]
                     ) -> List[CompletionEntry]:
        """Process a submission batch; completions in submission order.

        Default: scalar dispatch with per-entry errno isolation, so every
        module speaks the batched boundary. Override for vectorized fast
        paths (amortize locks, cache passes, journal commits, checksum
        launches across the batch) — completion order must be preserved.
        """
        return [self._dispatch_one(e) for e in entries]

    # --- chain reservation hooks -------------------------------------------------
    def chain_begin(self, entries: List[SubmissionEntry],
                    extra_blocks: int = 0) -> Optional[Errno]:
        """Called by ``execute_batch`` before a chain group executes; the
        module reserves whatever makes the WHOLE chain one atomicity unit
        (journaled modules size one journal transaction from the entries —
        see ``repro_torch.fs.xv6``). ``extra_blocks`` is the stacked-layer hook:
        a wrapper that stages additional blocks inside the same
        transaction (provenance records) adds its footprint here. Return
        an ``Errno`` (``ENOSPC``) to refuse the chain before anything is
        staged: the first member completes with it, the rest
        ``ECANCELED``. Default: no reservation needed."""
        del entries, extra_blocks
        return None

    def estimate_append_blocks(self, nbytes: int) -> int:
        """Journal-blocks upper bound for appending ``nbytes`` to an
        existing file — part of the stackable-layer contract (a wrapper
        sizes the records it will stage through this module's write path).
        Journaled modules override with their real write-path overhead
        (see ``repro_torch.fs.xv6``); the default is a generous generic bound."""
        return nbytes // 4096 + 4

    def chain_end(self) -> None:
        """Close the scope ``chain_begin`` opened (always called, even when
        a member failed mid-chain). Default: nothing to release."""


# Filled in by repro_torch.core.services at import time (cycle-free forward ref).
KernelServices = Any
