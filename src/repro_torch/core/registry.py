"""Module registration, mount table, and the batched dispatch gate
(paper §4.2, §5.2).

File systems register a *factory*; mounting instantiates the module, mints
its capabilities, and captures a function table (the function-pointer
struct of §5.2). Dispatch goes through the table + an operation gate so the
online-upgrade path (core.upgrade) can quiesce in-flight operations and
atomically swap the table — applications keep their mount handle across the
swap.

Two dispatch surfaces cross the gate:

* ``Mount.call(op, ...)`` — the scalar path: one gate-crossing, one table
  lookup, one module call per operation (the paper's §4.3 shape).
* ``Mount.submit(entries)`` — the batched path: the gate is entered ONCE
  for the whole batch, then the module's ``submit_batch`` runs every entry.
  Upgrade quiesce therefore drains whole batches atomically: a table swap
  can never land between two entries of one batch, so a batch's
  completions all come from the same module generation (§4.8 guarantee,
  extended to batches). ``BentoQueue`` is the io_uring-style SQ/CQ
  convenience wrapper over ``Mount.submit``.

``Mount.submit`` is *multi-submitter* (io_uring SQPOLL-style): each call
is one submission, and instead of every thread racing for its own gate
crossing, submissions queue on the mount and the first thread to claim the
drainer role carries EVERYTHING pending across the boundary in one
crossing (``execute_multi_batch``): chains stay within their submission,
unchained runs coalesce across submitters, completions route back to each
submitter with per-entry errnos. Uncontended, this degenerates to exactly
the old behaviour (one crossing per submission); under N contending
threads, crossings collapse toward one per drain (``mq_drains`` vs
``mq_submissions`` — the benchmark tripwire). ``SubmitterQueue`` is the
per-thread SQ handle (``Mount.submitter_queue()``).

The gate tracks per-thread depth: a module op that re-enters dispatch on
the same thread (nested ``call``/``submit``) joins its outer crossing
instead of deadlocking against a concurrent ``freeze``.

Domain-lock protocol (parallel drain)
-------------------------------------
A drain normally executes its dispatch groups serially under the module's
big fs lock. ``Mount.enable_parallel_drain(workers)`` (or
``start_sqpoll(parallel=N)``) attaches a small worker pool, and the drain
instead hands NON-OVERLAPPING groups to the pool concurrently
(``execute_multi_batch(..., pool=...)``): the module's
``group_footprint`` hook maps each group's submission entries to the set
of lock domains it touches (per-inode stripes plus ALLOC / BLOCKSTORE /
PROV specials — the multi-queue analogue of per-hctx locks), groups wait
only for earlier groups they overlap, and each runs under the module's
``domain_scope`` so sharded domain locks replace the single ``_oplock``
acquisition. The protocol's invariants, enforced by the fs side (see
``repro_torch.fs.xv6``):

* every MUTATING footprint contains ALLOC, so at most one group stages
  journal blocks at a time — ``Journal`` commit stays the only global
  serialization point and member-abort rollback can never clobber a
  concurrent chain's staging;
* a ``None`` footprint (kwargs, ``PrevResult`` args, ops the estimator
  does not model) overlaps everything: the group becomes a barrier and
  runs under the table's global exclusive bracket — exactly the old
  big-lock behaviour;
* workers never touch the op gate: the drainer's single crossing
  brackets the whole drain, so upgrade quiesce still drains whole rounds
  atomically. Worker threads that re-enter dispatch from module code are
  recognized (``_drain_tids``) and join the crossing directly, like the
  drainer itself.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Deque, Dict, Iterable, List, Optional

from repro_torch.core.interface import (BentoFilesystem, CompletionEntry, Errno,
                                  FS_OPS, FsError, SQE_LINK, SubmissionEntry,
                                  execute_batch, execute_multi_batch)

_FS_REGISTRY: Dict[str, Callable[[], BentoFilesystem]] = {}


def register_bento(name: str, factory: Callable[[], BentoFilesystem]) -> None:
    _FS_REGISTRY[name] = factory


def registered() -> Dict[str, Callable[[], BentoFilesystem]]:
    return dict(_FS_REGISTRY)


class OpGate:
    """Reader-writer gate: operations enter as readers; quiesce takes the
    writer side and drains in-flight ops (paper §4.8 upgrade barrier).

    Re-entrant per thread: a thread already inside the gate (an op that
    dispatches a nested op) bumps a thread-local depth instead of waiting —
    otherwise a nested ``enter`` during ``freeze`` would deadlock: freeze
    waits for the outer op to exit while the inner enter waits for thaw.
    ``crossings`` counts outermost entries only, so a submitted batch is
    exactly one crossing (the batching win, measured in benchmarks).
    """

    def __init__(self):
        self._lock = threading.Condition()
        self._active = 0
        self._frozen = False
        self._depth = threading.local()
        self.crossings = 0

    def enter(self) -> None:
        depth = getattr(self._depth, "v", 0)
        if depth > 0:  # nested on this thread: already counted as active
            self._depth.v = depth + 1
            return
        with self._lock:
            while self._frozen:
                self._lock.wait()
            self._active += 1
            self.crossings += 1
        self._depth.v = 1

    def exit(self) -> None:
        depth = getattr(self._depth, "v", 1)
        if depth > 1:
            self._depth.v = depth - 1
            return
        self._depth.v = 0
        with self._lock:
            self._active -= 1
            if self._active == 0:
                self._lock.notify_all()

    def freeze(self) -> None:
        with self._lock:
            self._frozen = True
            while self._active > 0:
                self._lock.wait()

    def thaw(self) -> None:
        with self._lock:
            self._frozen = False
            self._lock.notify_all()


_FS_OPS = FS_OPS + ("submit_batch",)  # the table also carries the batch door


class _PendingSubmission:
    """One submitter's staged entries waiting for a drain, plus the slot
    its completions (or the drain's implementation exception) come back
    through."""

    __slots__ = ("entries", "comps", "error")

    def __init__(self, entries: List[SubmissionEntry]):
        self.entries = entries
        self.comps: Optional[List[CompletionEntry]] = None
        self.error: Optional[BaseException] = None


class Mount:
    """A mounted Bento file system: function table + op gate + capabilities."""

    def __init__(self, name: str, module: BentoFilesystem, services):
        self.name = name
        self.services = services
        self.gate = OpGate()
        self._lock = threading.Lock()
        self.module: Optional[BentoFilesystem] = None
        self.table: Dict[str, Callable] = {}
        self.generation = 0
        # multi-submitter queue state (SQPOLL-style drain-on-submit).
        # Two condition variables over ONE lock: submitters park on
        # _mq_cv (completions / drainer-role changes), the SQPOLL poller
        # parks on _mq_work_cv (new-work signal) — so a submission's
        # notify wakes exactly the poller instead of broadcasting to
        # every waiting submitter (a thundering herd per submission)
        _mq_lock = threading.Lock()
        self._mq_cv = threading.Condition(_mq_lock)
        self._mq_work_cv = threading.Condition(_mq_lock)
        self._mq_pending: List[_PendingSubmission] = []
        self._mq_draining = False
        self._mq_drainer_tid: Optional[int] = None
        self._sqpoll: Optional[threading.Thread] = None
        self._sqpoll_run = False
        self._sqpoll_idle_s = 0.0
        self._sqpoll_idle_base_s = 0.0
        self._sqpoll_adaptive = False
        self._tls = threading.local()
        # parallel drain (sharded lock domains — see module docstring)
        self._drain_pool = None
        self._drain_tids: set = set()
        self.mq_submissions = 0  # submit() calls routed through the queue
        self.mq_drains = 0       # gate crossings that drained pending SQs
        self.mq_gather_skips = 0  # gather windows skipped: backlog present
        self._install(module)

    def _install(self, module: BentoFilesystem) -> None:
        sb = self.services.superblock()
        module.init(sb, self.services)
        self.module = module
        # Capture the function table — dispatch never touches the module
        # object directly after this point (mirrors the VFS fn-pointer struct).
        self.table = {op: getattr(module, op) for op in _FS_OPS}
        self.generation += 1

    # --- dispatch -------------------------------------------------------------------
    def call(self, op: str, *args, **kw):
        fn = self.table.get(op)
        if fn is None:
            raise FsError(Errno.EINVAL, f"no such op {op}")
        if self._drain_tids and threading.get_ident() in self._drain_tids:
            # parallel-drain worker re-entering dispatch: the drainer's
            # crossing brackets this thread (see submit()); entering the
            # gate here could deadlock against a pending freeze
            return fn(*args, **kw)
        self.gate.enter()
        try:
            return fn(*args, **kw)
        finally:
            self.gate.exit()

    def submit(self, entries: Iterable[SubmissionEntry]) -> List[CompletionEntry]:
        """Batched dispatch, multi-submitter: each call is ONE submission.

        The calling thread appends its submission to the mount's pending
        queue; the first thread to find the drainer role free takes it and
        drains EVERYTHING pending — its own submission plus any that other
        threads staged meanwhile — in one gate crossing via
        ``execute_multi_batch`` (``mq_drains`` counts those crossings,
        ``mq_submissions`` the calls; uncontended they are equal, under
        contention drains ≪ submissions). Threads whose submissions ride
        someone else's drain just wait for their completions.

        The table is read once inside the crossing, so every entry of a
        drain executes against the same module generation even if an
        upgrade is waiting to swap it (it drains these batches first).
        Chains (SQE_LINK) are grouped per submission — never spanning
        submitters, never split across a drain — so a table swap can never
        land between two members of a chain either: a chain's completions
        all come from one module generation.
        """
        if not isinstance(entries, list):
            entries = list(entries)
        tid = threading.get_ident()
        if self._mq_drainer_tid == tid:
            # nested dispatch from inside a module op on the drainer
            # thread: join the outer crossing (the gate is reentrant) —
            # queueing on ourselves would deadlock
            self.gate.enter()
            try:
                return execute_batch(self.table["submit_batch"], entries)
            finally:
                self.gate.exit()
        if self._drain_tids and tid in self._drain_tids:
            # nested dispatch from a parallel-drain worker, which executes
            # module code on the drainer's behalf: the drainer's crossing
            # already brackets this thread's work, and its gate depth here
            # is 0 — entering would deadlock against a freeze waiting for
            # the drainer (which waits for this worker). Run direct.
            return execute_batch(self.table["submit_batch"], entries)
        sub = _PendingSubmission(entries)
        with self._mq_cv:
            self._mq_pending.append(sub)
            self.mq_submissions += 1
            if self._sqpoll is not None:
                self._mq_work_cv.notify()  # wake the poller (it waits; the
                #   opportunistic drainer polls the queue and needs none)
            while sub.comps is None and sub.error is None \
                    and self._mq_draining:
                self._mq_cv.wait()
            if sub.comps is not None or sub.error is not None:
                if sub.error is not None:
                    raise sub.error
                return sub.comps
            # drainer role is free and our submission is still pending
            # (also the recovery path: a drainer that died re-raising a
            # module bug leaves the role free, and a waiter picks it up)
            self._mq_draining = True
            self._mq_drainer_tid = threading.get_ident()
        try:
            self._drain_pending()
        finally:
            with self._mq_cv:
                self._mq_draining = False
                self._mq_drainer_tid = None
                self._mq_cv.notify_all()
        if sub.error is not None:
            raise sub.error
        return sub.comps

    def _drain_pending(self) -> int:
        """Drainer role: swallow everything pending in one gate crossing,
        repeating until the queue is empty (submissions that arrive while
        a drain executes ride the NEXT crossing, not their own). Returns
        the number of submissions carried — the SQPOLL poller feeds it to
        ``_adapt_idle``."""
        carried = 0
        while True:
            with self._mq_cv:
                batch, self._mq_pending = self._mq_pending, []
            if not batch:
                return carried
            carried += len(batch)
            self.mq_drains += 1
            self.gate.enter()
            try:
                segs = execute_multi_batch(self.table["submit_batch"],
                                           [s.entries for s in batch],
                                           pool=self._drain_pool)
            except BaseException as e:
                # an implementation exception (a bug — fs errors cross as
                # errnos) poisons the whole drain: deliver it to every
                # waiter and re-raise in the drainer, like scalar dispatch
                with self._mq_cv:
                    for s in batch:
                        s.error = e
                    self._mq_cv.notify_all()
                raise
            finally:
                self.gate.exit()
            with self._mq_cv:
                for s, comps in zip(batch, segs):
                    s.comps = comps
                self._mq_cv.notify_all()

    def enable_parallel_drain(self, workers: int = 4) -> None:
        """Attach a small worker pool to the drain: dispatch groups with
        non-overlapping lock-domain footprints execute concurrently
        (``execute_multi_batch(..., pool=...)`` — see the module
        docstring for the protocol). Idempotent; ``workers <= 0`` detaches
        and shuts the pool down, restoring the serial drain. Worker
        threads register their tids so nested dispatch from module code
        running on a worker joins the drainer's crossing instead of
        queueing on itself."""
        if workers <= 0:
            pool, self._drain_pool = self._drain_pool, None
            if pool is not None:
                pool.shutdown(wait=True)
                # dead workers' tids could be recycled for unrelated
                # threads, which would then bypass the gate — forget them
                self._drain_tids.clear()
            return
        if self._drain_pool is not None:
            return
        import concurrent.futures as _cf

        def _register_worker():
            self._drain_tids.add(threading.get_ident())

        self._drain_pool = _cf.ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix=f"drain-{self.name}",
            initializer=_register_worker)

    def submitter_queue(self, depth: int = 256,
                        submitter: Optional[str] = None) -> "SubmitterQueue":
        """The calling thread's SubmitterQueue over this mount, created on
        first use — the per-thread SQ of the multi-submitter design.
        ``submitter`` names the identity stamped onto staged entries
        (first call wins; default ``tid:<owner>``)."""
        q = getattr(self._tls, "sq", None)
        if q is None:
            q = self._tls.sq = SubmitterQueue(self, depth,
                                              submitter=submitter)
        return q

    # --- dedicated SQPOLL drainer (io_uring IORING_SETUP_SQPOLL analogue) ------
    def start_sqpoll(self, idle_us: int = 500, adaptive: bool = True,
                     parallel: int = 0) -> None:
        """Hand the drainer role to a dedicated thread: submitters only
        append and wait, the poller drains everything pending in one gate
        crossing per round. ``idle_us`` is the ``sq_thread_idle``
        analogue — a short gather window after work first appears, letting
        concurrent submitters pile on before the crossing (worth real
        coalescing under an interpreter whose threads otherwise hand off
        in 5 ms slices). Opportunistic drain-on-submit resumes after
        ``stop_sqpoll``; uncontended callers should prefer that default —
        the poller adds the gather window to every submission's latency.

        ``adaptive`` shrinks that latency tax when traffic turns out to be
        uncontended: a drain that carried ≤ 1 submission paid the gather
        window for nothing, so the window HALVES (down to zero); a full
        drain (≥ 2 submissions actually coalesced) restores the configured
        window — see ``_adapt_idle``.

        ``parallel`` > 0 additionally attaches a worker pool of that size
        (``enable_parallel_drain``) so each round's non-overlapping
        dispatch groups execute concurrently."""
        if parallel > 0:
            self.enable_parallel_drain(parallel)
        with self._mq_cv:
            if self._sqpoll is not None:
                return
            # an opportunistic drainer may be mid-flight: wait for it to
            # release the role (its finally notifies) — installing the
            # poller over a live drainer would leave two drainers racing
            while self._mq_draining:
                self._mq_cv.wait()
            self._sqpoll_run = True
            self._sqpoll_adaptive = adaptive
            self._sqpoll_idle_base_s = max(idle_us, 0) / 1e6
            self._sqpoll_idle_s = self._sqpoll_idle_base_s
            self._mq_draining = True  # the poller owns the role for good
            self._sqpoll = threading.Thread(
                target=self._sqpoll_loop, name=f"sqpoll-{self.name}",
                daemon=True)
            self._sqpoll.start()

    def stop_sqpoll(self) -> None:
        """Retire the poller (drains whatever is pending first) and return
        to opportunistic drain-on-submit."""
        with self._mq_cv:
            if self._sqpoll is None:
                return
            self._sqpoll_run = False
            poller = self._sqpoll
            self._mq_work_cv.notify_all()  # the poller parks on work-cv
        poller.join()  # its finally released the role

    def _adapt_idle(self, carried: int) -> None:
        """Adaptive ``sq_thread_idle``: drains that carry ≤ 1 submission
        prove nobody piled on during the gather window, so latency-
        sensitive lone submitters stop paying it — the window halves each
        such drain (snapping to 0 below 1 µs). The first drain that really
        coalesces (≥ 2 submissions) restores the configured window, so
        bursty traffic gets its coalescing back immediately. A window
        decayed to 0 never busy-spins: an idle poller parks on the
        condition variable, not the gather sleep. Pure state transition on
        (window, carried) — deterministic to unit-test."""
        if not self._sqpoll_adaptive or self._sqpoll_idle_base_s <= 0:
            return
        if carried <= 1:
            self._sqpoll_idle_s /= 2
            if self._sqpoll_idle_s < 1e-6:
                self._sqpoll_idle_s = 0.0
        else:
            self._sqpoll_idle_s = self._sqpoll_idle_base_s

    def _sqpoll_loop(self) -> None:
        me = threading.current_thread()
        self._mq_drainer_tid = threading.get_ident()
        import time as _t
        try:
            while True:
                with self._mq_cv:
                    # Starvation fix: submissions that arrived DURING the
                    # previous drain are a backlog, not fresh traffic —
                    # they already waited a whole drain, and sleeping the
                    # gather window again before serving them starves
                    # them for (window + drain) per round. Only sleep
                    # when work appeared while we were genuinely idle
                    # (parked on the cv), i.e. when the wait loop ran.
                    backlog = bool(self._mq_pending)
                    while not self._mq_pending and self._sqpoll_run:
                        backlog = False
                        self._mq_work_cv.wait(timeout=0.05)
                    if not self._sqpoll_run and not self._mq_pending:
                        return
                if self._sqpoll_idle_s > 0:
                    if backlog:
                        self.mq_gather_skips += 1
                    else:
                        _t.sleep(self._sqpoll_idle_s)  # gather (GIL off)
                carried = self._drain_pending()
                if carried:
                    self._adapt_idle(carried)
        finally:
            # normal retirement AND death-by-module-bug both release the
            # drainer role here, or every later submit would wait forever
            # on a poller that no longer exists; opportunistic
            # drain-on-submit resumes (the bug itself was already
            # delivered to that round's waiters by _drain_pending)
            with self._mq_cv:
                if self._sqpoll is me:
                    self._sqpoll = None
                    self._sqpoll_run = False
                    self._mq_draining = False
                    self._mq_drainer_tid = None
                    self._mq_cv.notify_all()

    def __getattr__(self, op: str):
        if op in _FS_OPS:
            return lambda *a, **k: self.call(op, *a, **k)
        raise AttributeError(op)

    def unmount(self) -> None:
        self.enable_parallel_drain(0)  # retire drain workers first
        self.gate.freeze()
        try:
            self.module.flush()
            self.module.destroy()
            self.services.unmount_checks()
        finally:
            self.gate.thaw()


class BentoQueue:
    """io_uring-style submission/completion queue over a mount handle.

    ``prep`` stages entries in the submission queue; ``submit`` crosses the
    boundary once for everything staged (auto-submitting when the queue
    reaches ``depth``); completions accumulate in the completion queue and
    drain via ``drain`` in submission order. Not thread-safe: like an
    io_uring, one queue belongs to one submitter (make one per thread —
    the mount underneath is the shared, thread-safe object).
    """

    def __init__(self, mount, depth: int = 256,
                 submitter: Optional[str] = None):
        if depth <= 0:
            raise ValueError("queue depth must be positive")
        self.mount = mount
        self.depth = depth
        # the identity stamped onto every staged entry (None: anonymous) —
        # provenance records and dedup stats attribute work to it instead
        # of guessing from whichever thread happens to hold the drainer
        # role when the entry executes
        self.submitter = submitter
        self._sq: List[SubmissionEntry] = []
        self._cq: Deque[CompletionEntry] = collections.deque()

    def prep(self, op: str, *args, user_data: Any = None, flags: int = 0,
             **kwargs) -> None:
        """Stage one submission; auto-submits a full queue. Pass
        ``flags=SQE_LINK`` to chain the NEXT prepped entry onto this one;
        auto-submit is deferred while a chain is open (a link must never be
        severed by a batch boundary — an explicit ``submit`` mid-chain,
        like io_uring's, ends the chain at the boundary instead)."""
        self.prep_entry(SubmissionEntry(op, args, kwargs or None, user_data,
                                        flags))

    def prep_entry(self, entry: SubmissionEntry) -> None:
        """Stage a pre-built entry (callers that assemble entries
        directly, e.g. the PosixView batched forms); same auto-submit and
        chain-deferral rules as ``prep``."""
        if self.submitter is not None and entry.submitter is None:
            entry.submitter = self.submitter
        self._sq.append(entry)
        if len(self._sq) >= self.depth and not (entry.flags & SQE_LINK):
            self.submit()

    def stage(self, entries: Iterable[SubmissionEntry]) -> None:
        """Stage many pre-built entries WITHOUT auto-submitting: the
        caller owns the submit boundary (a batch that must cross the
        boundary whole stages here and calls ``submit`` once)."""
        if self.submitter is None:
            self._sq.extend(entries)
            return
        for e in entries:
            if e.submitter is None:
                e.submitter = self.submitter
            self._sq.append(e)

    def submit(self) -> int:
        """Submit everything staged (one gate-crossing); returns the number
        of completions now waiting."""
        if self._sq:
            batch, self._sq = self._sq, []
            self._cq.extend(self.mount.submit(batch))
        return len(self._cq)

    def drain(self) -> List[CompletionEntry]:
        """Take all waiting completions (submission order)."""
        out = list(self._cq)
        self._cq.clear()
        return out

    def __len__(self) -> int:
        return len(self._sq)


class SubmitterQueue(BentoQueue):
    """A per-thread submission queue, io_uring SQPOLL-style: ``submit()``
    publishes the staged entries as ONE submission to the mount's shared
    drain, where whichever thread holds the drainer role carries them
    across the boundary — under contention many submitters' queues cross
    in one gate crossing (see ``Mount.submit``).

    Thread-affine by construction: obtain one per thread via
    ``Mount.submitter_queue()`` (or construct directly); never share an
    instance across threads — the mount underneath is the shared,
    thread-safe object. ``submits``/``entries_submitted`` count what this
    submitter pushed, pairing with the mount's ``mq_drains`` to show the
    coalescing ratio."""

    def __init__(self, mount, depth: int = 256,
                 submitter: Optional[str] = None):
        self.owner_tid = threading.get_ident()
        # default identity: the OWNING thread, fixed at construction — the
        # real submitter even when another thread's drain executes the work
        super().__init__(mount, depth,
                         submitter or f"tid:{self.owner_tid}")
        self.submits = 0
        self.entries_submitted = 0

    def submit(self) -> int:
        if self._sq:
            self.submits += 1
            self.entries_submitted += len(self._sq)
        return super().submit()


def mount(name: str, services, module: Optional[BentoFilesystem] = None) -> Mount:
    if module is None:
        factory = _FS_REGISTRY.get(name)
        if factory is None:
            raise KeyError(f"no registered bento fs {name!r}")
        module = factory()
    return Mount(name, module, services)
