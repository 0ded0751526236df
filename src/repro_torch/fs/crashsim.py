"""Exhaustive crash-point torture harness (CrashMonkey-style enumeration).

"Bento and the Art of Repeated Research" argues that crash-consistency
claims must be re-verifiable by systematic, repeatable infrastructure, not
ad-hoc spot checks. This module is that infrastructure for the journaled
file systems in this repo:

* a *golden run* first measures a workload's total device-write footprint;
* the workload is then re-executed once per crash point N = 0..total with
  power loss injected after the Nth device write (N = 0: the very first
  write never lands; N = total: the no-crash control) — EVERY device-write
  crash point is enumerated, not a sampled subset;
* after each crash the device is remounted cold — fresh buffer cache,
  fresh fs instance, ``Journal.recover()`` runs at init — and an invariant
  callback judges the recovered state.

Each iteration rebuilds the device from scratch (mkfs + the caller's
``setup``, flushed durable before the write counter starts), so every
crash point replays an identical write stream: the sweep is deterministic
and a failure names the exact write it crashed on.

The canonical sweep — a linked create → write(PrevResult) → fsync chain
that must be all-or-nothing after recovery (the chain-transaction
guarantee of ``repro_torch.fs.journal``) — is built in, used by the test tree
and runnable standalone as a CI smoke::

    PYTHONPATH=src python -m repro_torch.fs.crashsim --quick

``--quick`` bounds the sweep to a stratified subset of crash points
(first/last + an even stride) so it fits a CI smoke budget; without it
every crash point runs. Every mount checksums through the kernel binding
on ``device`` (``--device``): the CUDA blockhash kernel when unset, its
plain PyTorch version with ``--device cpu``. The FUSE torture runs the
daemon's userspace binding (crc32) and takes no device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, List, Optional, Sequence

from repro_torch.core.services import kernel_binding
from repro_torch.device import DeviceLike
from repro_torch.fs.blockdev import (BlockDeviceError, LazyBlockDevice,
                                     MemBlockDevice)
from repro_torch.fs.mounts import DirectMount
from repro_torch.fs.posix import PosixView
from repro_torch.fs.xv6 import mkfs


@dataclasses.dataclass
class CrashCtx:
    """What a workload/setup callback gets to drive: a freshly formatted
    device behind a DirectMount (same chain executor and journal path as
    the gated mounts, none of the gate noise)."""

    dev: MemBlockDevice
    ks: object
    fs: object
    mount: DirectMount
    view: PosixView


@dataclasses.dataclass
class Recovered:
    """Post-crash, post-recovery state handed to invariants/callers."""

    crash_point: int   # writes that LANDED before power loss
    total_writes: int  # the workload's full footprint (golden run)
    crashed: bool      # False only for the N == total control iteration
    dev: MemBlockDevice
    ks: object
    fs: object
    mount: DirectMount
    view: PosixView


def quick_points(total: int, n: int = 12) -> List[int]:
    """Bounded, stratified crash-point subset: first, last, no-crash
    control, and an even stride in between — the CI smoke budget."""
    if total + 1 <= n:
        return list(range(total + 1))
    stride = max(1, (total + n - 1) // n)
    return sorted(set(range(0, total + 1, stride)) | {0, 1, total - 1, total})


class CrashSim:
    """Deterministic crash-point sweeps over a journaled Bento fs."""

    def __init__(self, fs_factory: Callable[[], object], *,
                 n_blocks: int = 2048, ninodes: int = 256, nlog: int = 32,
                 writeback: str = "delayed",
                 device_factory: Optional[Callable[[], object]] = None,
                 format_device: bool = True, device: DeviceLike = None):
        self.fs_factory = fs_factory
        self.n_blocks = n_blocks
        self.ninodes = ninodes
        self.nlog = nlog
        self.writeback = writeback
        # non-default devices (a LazyBlockDevice over a golden image) plug
        # in here; format_device=False skips mkfs for devices whose
        # provider already carries a formatted image
        self.device_factory = device_factory
        self.format_device = format_device
        # the torch device every mount's kernel binding checksums on
        self.device = device

    # --- plumbing -------------------------------------------------------------------
    def _mount(self, dev: MemBlockDevice) -> CrashCtx:
        """Cold mount: fresh services (fresh cache) + fresh fs instance;
        the fs's init runs journal recovery."""
        ks = kernel_binding(dev, device=self.device,
                            writeback=self.writeback)
        fs = self.fs_factory()
        fs.init(ks.superblock(), ks)
        m = DirectMount(fs)
        return CrashCtx(dev, ks, fs, m, PosixView(m))

    def boot(self, setup: Optional[Callable[[CrashCtx], None]] = None
             ) -> CrashCtx:
        """The canonical cold-boot recipe (public — tests use it for
        non-crash setups too): fresh device + mkfs + mount + durable
        setup, write counter armed at zero so crash points index workload
        writes only."""
        dev = (MemBlockDevice(self.n_blocks) if self.device_factory is None
               else self.device_factory())
        if self.format_device:
            ks = kernel_binding(dev, device=self.device,
                                writeback=self.writeback)
            mkfs(ks, ninodes=self.ninodes, nlog=self.nlog)
        ctx = self._mount(dev)
        if setup is not None:
            setup(ctx)
            ctx.fs.flush()  # setup is durable regardless of the crash point
        dev._writes_seen = 0
        return ctx

    # --- public API -----------------------------------------------------------------
    def measure(self, workload: Callable[[CrashCtx], None], *,
                setup: Optional[Callable[[CrashCtx], None]] = None) -> int:
        """Golden run: the workload's device-write footprint (no crash)."""
        ctx = self.boot(setup)
        ctx.dev.fail_after_writes = 1 << 30  # arm the counter, never fire
        workload(ctx)
        total = ctx.dev._writes_seen
        ctx.dev.fail_after_writes = -1
        return total

    def run_one(self, workload: Callable[[CrashCtx], None], point: int, *,
                total: Optional[int] = None,
                setup: Optional[Callable[[CrashCtx], None]] = None
                ) -> Recovered:
        """One iteration: crash after ``point`` device writes, power back
        on, remount cold (recovery runs), return the recovered state."""
        ctx = self.boot(setup)
        ctx.dev.fail_after_writes = point
        crashed = False
        try:
            workload(ctx)
        except BlockDeviceError:
            crashed = True
        ctx.dev.fail_after_writes = -1  # power back on
        rec = self._mount(ctx.dev)
        return Recovered(point, -1 if total is None else total, crashed,
                         rec.dev, rec.ks, rec.fs, rec.mount, rec.view)

    def sweep(self, workload: Callable[[CrashCtx], None],
              invariant: Callable[[Recovered], None], *,
              setup: Optional[Callable[[CrashCtx], None]] = None,
              points: Optional[Sequence[int]] = None,
              quick: bool = False) -> int:
        """Enumerate crash points and assert the invariant at each.

        ``points`` overrides the enumeration; ``quick`` bounds it via
        ``quick_points``. Default: EVERY point, 0..total inclusive (the
        last is the no-crash control). Returns the number of points swept;
        an invariant failure re-raises naming the crash point."""
        total = self.measure(workload, setup=setup)
        if points is None:
            points = quick_points(total) if quick else range(total + 1)
        for point in points:
            rec = self.run_one(workload, point, total=total, setup=setup)
            try:
                invariant(rec)
            except AssertionError as e:
                raise AssertionError(
                    f"invariant violated at crash point {point}/{total} "
                    f"(crashed={rec.crashed}): {e}") from e
        return len(list(points))


# --- FUSE daemon torture: the file-backed device, across processes ---------------


@dataclasses.dataclass
class FuseRecovered:
    """Post-crash state of the daemon path: a FRESH daemon remounted the
    survived backing file (journal recovery ran daemon-side at init)."""

    crash_point: int
    total_writes: int
    crashed: bool
    mount: object   # FuseMount over the recovered image
    view: PosixView


class FuseCrashSim:
    """Crash-point sweeps THROUGH the FUSE daemon (the userspace binding's
    file-backed device — the path no in-process harness can reach).

    Power loss is injected in the daemon's ``FileBlockDevice`` over the
    ``__ctl__`` side-channel (optionally TEARING the dying write mid-block
    via ``torn_bytes`` — the journal checksums must catch that), the
    daemon is then SIGKILLed without any flush, and the backing file is
    remounted by a fresh daemon with mkfs skipped, so ``Journal.recover``
    runs against exactly what survived. Same golden-run/enumerate/remount
    protocol as ``CrashSim``; each iteration costs two daemon processes,
    so sweeps here favour ``quick=True``."""

    def __init__(self, *, n_blocks: int = 2048, fs_kind: str = "xv6",
                 torn_bytes: int = -1):
        self.n_blocks = n_blocks
        self.fs_kind = fs_kind
        self.torn_bytes = torn_bytes

    def _boot(self, setup):
        """Fresh backing file + daemon + durable setup, injection counter
        armed at zero so crash points index workload writes only."""
        import os
        import tempfile

        from repro_torch.fs.fusebridge import FuseMount

        tmpdir = tempfile.mkdtemp(prefix="fusecrash_")
        backing = os.path.join(tmpdir, "disk.img")
        m = FuseMount(n_blocks=self.n_blocks, fs_kind=self.fs_kind,
                      backing_path=backing)
        view = PosixView(m)
        if setup is not None:
            setup(view)
            m.call("flush")  # setup durable regardless of the crash point
        m.ctl("fail_after_writes", 1 << 30, self.torn_bytes)  # arm counter
        return tmpdir, backing, m, view

    @staticmethod
    def _cleanup(tmpdir) -> None:
        import shutil

        shutil.rmtree(tmpdir, ignore_errors=True)

    def measure(self, workload, *, setup=None) -> int:
        tmpdir, _backing, m, view = self._boot(setup)
        try:
            workload(view, m)
            return m.ctl("writes_seen")
        finally:
            m.kill()
            self._cleanup(tmpdir)

    def run_one(self, workload, point: int, *, total: int = -1, setup=None):
        """One iteration: boot fresh, arm the crash at ``point``, run the
        workload (daemon-side power loss surfaces client-side as
        RuntimeError), kill -9 the daemon, remount the survived image."""
        from repro_torch.fs.fusebridge import FuseMount

        tmpdir, backing, m, view = self._boot(setup)
        m.ctl("fail_after_writes", point, self.torn_bytes)
        crashed = False
        try:
            workload(view, m)
        except (RuntimeError, EOFError, OSError):
            crashed = True  # the daemon's device lost power mid-op
        m.kill()
        m2 = FuseMount(n_blocks=self.n_blocks, fs_kind=self.fs_kind,
                       backing_path=backing, reuse=True)
        rec = FuseRecovered(point, total, crashed, m2, PosixView(m2))
        rec._tmpdir = tmpdir  # cleaned by sweep/caller via finish()
        return rec

    def finish(self, rec: FuseRecovered) -> None:
        rec.mount.kill()
        self._cleanup(rec._tmpdir)

    def sweep(self, workload, invariant, *, setup=None, points=None,
              quick: bool = True) -> int:
        total = self.measure(workload, setup=setup)
        if points is None:
            points = quick_points(total) if quick else range(total + 1)
        for point in points:
            rec = self.run_one(workload, point, total=total, setup=setup)
            try:
                invariant(rec)
            except AssertionError as e:
                raise AssertionError(
                    f"fuse invariant violated at crash point {point}/{total}"
                    f" (crashed={rec.crashed}): {e}") from e
            finally:
                self.finish(rec)
        return len(list(points))


def torture_fuse(*, payload_blocks: int = 1, quick: bool = True,
                 torn_bytes: int = -1, fs_kind: str = "xv6") -> int:
    """Sweep a chained create→write(PrevResult)→fsync THROUGH the daemon:
    all-or-nothing must hold across a real process kill + file-backed
    remount (and with ``torn_bytes`` armed, across a torn final write)."""
    from repro_torch.core.interface import PrevResult, SQE_LINK, SubmissionEntry

    payload = b"F" * (payload_blocks * 4096 + 17)

    def workload(view, m):
        comps = m.submit([
            SubmissionEntry("create", (1, "f"), user_data="c",
                            flags=SQE_LINK),
            SubmissionEntry("write", (PrevResult("ino"), 0, payload),
                            user_data="w", flags=SQE_LINK),
            SubmissionEntry("fsync", (PrevResult("ino", back=2),),
                            user_data="s"),
        ])
        bad = [(c.user_data, c.errno) for c in comps if not c.ok]
        assert not bad, f"chain failed without a crash: {bad}"

    def invariant(rec: FuseRecovered) -> None:
        if rec.view.exists("/f"):
            got = rec.view.read_file("/f")
            assert got == payload, (
                f"half-applied chain through the daemon: /f has {len(got)}B"
                f" (expected {len(payload)}B or no file)")
        else:
            assert rec.crashed, "no crash, yet /f is missing"
        rec.view.statfs()
        rec.view.listdir("/")

    sim = FuseCrashSim(fs_kind=fs_kind, torn_bytes=torn_bytes)
    return sim.sweep(workload, invariant, quick=quick)


# --- the canonical chain torture (acceptance sweep + CI smoke) -------------------


def chain_workload(payload: bytes, name: str = "f"
                   ) -> Callable[[CrashCtx], None]:
    """The PR's headline unit: a linked create → write(PrevResult("ino"))
    → fsync chain submitted as one batch."""
    from repro_torch.core.interface import PrevResult, SQE_LINK, SubmissionEntry

    def run(ctx: CrashCtx) -> None:
        comps = ctx.mount.submit([
            SubmissionEntry("create", (1, name), user_data="c",
                            flags=SQE_LINK),
            SubmissionEntry("write", (PrevResult("ino"), 0, payload),
                            user_data="w", flags=SQE_LINK),
            SubmissionEntry("fsync", (PrevResult("ino", back=2),),
                            user_data="s"),
        ])
        bad = [(c.user_data, c.errno) for c in comps if not c.ok]
        assert not bad, f"chain failed without a crash: {bad}"

    return run


def all_or_nothing(payload: bytes, path: str = "/f"
                   ) -> Callable[[Recovered], None]:
    """After recovery the chain is indivisible: the file either does not
    exist at all, or exists with the COMPLETE payload — a dirent without
    data, a short file, or a torn tail all fail. The no-crash control
    (crashed=False) must see the file. General fs consistency (statfs,
    readdir) must hold at every point."""

    def invariant(rec: Recovered) -> None:
        if rec.view.exists(path):
            got = rec.view.read_file(path)
            assert got == payload, (
                f"half-applied chain: {path} exists with {len(got)}B "
                f"(expected {len(payload)}B or no file)")
        else:
            assert rec.crashed, f"no crash, yet {path} is missing"
        rec.view.statfs()
        rec.view.listdir("/")

    return invariant


def _fs_factory(kind: str):
    from repro_torch.fs.ext4like import Ext4LikeFileSystem
    from repro_torch.fs.xv6 import Xv6FileSystem, Xv6Options

    return {
        "xv6": lambda: Xv6FileSystem(Xv6Options()),
        "ext4like": lambda: Ext4LikeFileSystem(),
    }[kind]


def torture_chain(kind: str = "xv6", *, payload_blocks: int = 2,
                  quick: bool = False, device: DeviceLike = None) -> int:
    """Sweep the canonical chain on one fs kind; returns points swept."""
    payload = b"C" * (payload_blocks * 4096 + 17)  # off-block tail: torn shows
    sim = CrashSim(_fs_factory(kind), device=device)
    return sim.sweep(chain_workload(payload), all_or_nothing(payload),
                     quick=quick)


def torture_rename(kind: str = "xv6", *, quick: bool = False,
                   device: DeviceLike = None) -> int:
    """Sweep a rename ONTO an existing name (the POSIX overwrite path):
    after recovery at every crash point, the new name must still resolve
    (to the old content before the swap committed, to the moved content
    after), the old name must be gone exactly when the swap is durable,
    and the displaced inode's blocks must be freed with it — both
    end-states' free-block counts are golden-measured first, so block
    leaks fail the sweep, not just torn names."""
    a, b = b"A" * (2 * 4096 + 7), b"B" * (3 * 4096 + 3)

    def setup(ctx: CrashCtx) -> None:
        ctx.view.write_file("/old", a)
        ctx.view.write_file("/new", b)

    def workload(ctx: CrashCtx) -> None:
        ctx.view.rename("/old", "/new")
        ctx.view.fsync("/new")

    sim = CrashSim(_fs_factory(kind), device=device)
    # golden free-block counts for the two legal end states
    ctx = sim.boot(setup)
    free_before = ctx.view.statfs()["free_blocks_est"]
    workload(ctx)
    free_after = ctx.view.statfs()["free_blocks_est"]

    def invariant(rec: Recovered) -> None:
        new_data = rec.view.read_file("/new")  # /new must ALWAYS resolve
        free = rec.view.statfs()["free_blocks_est"]
        if rec.view.exists("/old"):
            assert rec.crashed, "no crash, yet the rename did not happen"
            assert rec.view.read_file("/old") == a
            assert new_data == b, "target clobbered before the swap committed"
            assert free == free_before, \
                f"block leak pre-swap: {free} != {free_before}"
        else:
            assert new_data == a, "old name gone but target not the moved file"
            assert free == free_after, \
                f"displaced blocks not freed: {free} != {free_after}"
        rec.view.listdir("/")

    return sim.sweep(workload, invariant, setup=setup, quick=quick)


# --- sharded-checkpoint torture: old XOR complete-new, shard files and all -------


def torture_ckpt_shards(kind: str = "xv6", *, quick: bool = False,
                        device: DeviceLike = None) -> int:
    """Sweep a v2 SHARDED checkpoint re-save (shard-per-file + manifest
    rename swap, repro_torch.checkpoint.store) over a LIVE previous
    checkpoint: after power loss at every device write, a cold remount
    must restore either the previous checkpoint or the COMPLETE new one —
    every shard file present, every per-shard checksum clean, never a mix
    of generations and never zero restorable checkpoints. Every shard is
    hashed on ``device``, and the restores land there."""
    import numpy as np

    from repro_torch.checkpoint import store
    from repro_torch.device import resolve_device
    from repro_torch.distributed.resharding import ShardGrid

    device = resolve_device(device)
    grid = ShardGrid.from_spec((8, 8), ("d", "m"), {"d": 2, "m": 2})
    old_tree = {"w": np.arange(64, dtype=np.float32).reshape(8, 8),
                "b": np.full((6,), 3.0, np.float32)}
    new_tree = {"w": old_tree["w"] + 100.0,
                "b": np.full((6,), 7.0, np.float32)}
    like = {"w": np.zeros((8, 8), np.float32),
            "b": np.zeros((6,), np.float32)}
    grids = {"w": grid, "b": None}

    def setup(ctx: CrashCtx) -> None:
        store.save(ctx.view, "/ckpt/step_1", old_tree, step=1,
                   checksum=ctx.ks.checksum, shardings=grids)

    def workload(ctx: CrashCtx) -> None:
        store.save(ctx.view, "/ckpt/step_1", new_tree, step=1,
                   checksum=ctx.ks.checksum, shardings=grids)

    def invariant(rec: Recovered) -> None:
        # a live manifest must exist at every point (the old one until the
        # swap commits, the new one after) and load must verify EVERY
        # shard file's checksum on the way in
        assert store.latest_step(rec.view, "/ckpt") == 1, \
            "no restorable checkpoint after the crash"
        got, man = store.load(rec.view, "/ckpt/step_1", like,
                              checksum=rec.ks.checksum, device=device)
        wrec = [r for r in man["leaves"] if r["shape"] == [8, 8]][0]
        assert len(wrec["shards"]) == 4, \
            f"live manifest names {len(wrec['shards'])} shards, not 4"
        w, b = got["w"].cpu().numpy(), got["b"].cpu().numpy()
        if np.array_equal(w, new_tree["w"]):
            assert np.array_equal(b, new_tree["b"]), \
                "mixed generations restored: new w, old b"
        else:
            assert np.array_equal(w, old_tree["w"]), "w is neither gen"
            assert np.array_equal(b, old_tree["b"]), \
                "mixed generations restored: old w, new b"
            assert rec.crashed, "no crash, yet the re-save is not live"
        rec.view.statfs()

    sim = CrashSim(_fs_factory(kind), nlog=64, device=device)
    return sim.sweep(workload, invariant, setup=setup, quick=quick)


# --- provenance-log torture: the log must always be explainable ------------------


def _prov_factory(kind: str):
    from repro_torch.fs.prov import ProvFilesystem

    base = _fs_factory(kind)
    return lambda: ProvFilesystem(base())


def torture_prov(kind: str = "xv6", *, quick: bool = False,
                 device: DeviceLike = None) -> int:
    """Sweep a scripted mutation sequence through the provenance layer:
    after power loss at EVERY device write, the recovered log must never
    reference an inode or name the recovered file system doesn't explain.

    For namespace ops the layer commits mutation + record in ONE journal
    transaction (old-XOR-new), which makes the invariant exact and
    bidirectional: replaying the recovered log's namespace records over
    the durable setup state must reproduce the recovered tree EXACTLY —
    a record without its mutation, a mutation without its record, or a
    reordering all fail the sweep. File content is checked one-directional
    for writes (record durable ⇒ data durable)."""
    payload = b"W" * (4096 + 33)

    def setup(ctx: CrashCtx) -> None:
        ctx.view.write_file("/seed", b"s" * 4096)

    def workload(ctx: CrashCtx) -> None:
        # fsyncs split the stream into several journal transactions, so
        # the sweep sees genuine PREFIX states (ops 1..k durable), not
        # just all-or-nothing of one group commit
        v = ctx.view
        v.create("/a")
        v.write_file("/a", payload, create=False)
        v.fsync("/a")
        v.mkdir("/d")
        v.rename("/seed", "/d/renamed")
        v.fsync("/d")
        v.create("/b")
        v.unlink("/a")
        v.fsync("/b")

    # records the durable setup leaves in the log (identical every boot)
    sim = CrashSim(_prov_factory(kind), device=device)
    ctx0 = sim.boot(setup)
    n_setup = len(ctx0.fs.read_provenance())

    def invariant(rec: Recovered) -> None:
        recs = rec.fs.read_provenance()[n_setup:]
        # replay namespace records over the setup namespace: {path: ino}
        dirs = {"/": 1}
        names = {"/seed": None}
        for r in recs:
            if r["op"] == "create":
                parent = "/" if r["parent"] == 1 else "/d"
                names[f"{parent.rstrip('/')}/{r['name']}"] = r["ino"]
            elif r["op"] == "mkdir":
                dirs[f"/{r['name']}"] = r["ino"]
            elif r["op"] == "unlink":
                names.pop(f"/{r['name']}", None)
            elif r["op"] == "rename":
                ino = names.pop(f"/{r['name']}")
                names[f"/d/{r['newname']}"] = ino
        # bidirectional namespace equality (old-XOR-new per record)
        got_root = set(rec.view.listdir("/"))
        want_root = ({p[1:] for p in names if p.count("/") == 1}
                     | {d[1:] for d in dirs if d != "/"})
        assert got_root == want_root, \
            f"log does not explain the tree: fs={got_root} log={want_root}"
        for d, dino in dirs.items():
            if d == "/":
                continue
            assert rec.view.stat(d).ino == dino, f"{d}: wrong ino"
            got_d = set(rec.view.listdir(d))
            want_d = {p.split("/")[-1] for p in names
                      if p.startswith(d + "/")}
            assert got_d == want_d, f"{d} mismatch: {got_d} != {want_d}"
        for path, ino in names.items():
            if ino is not None:
                assert rec.view.stat(path).ino == ino, f"{path}: wrong ino"
        # writes: record durable ⇒ data durable (never the reverse claim)
        if any(r["op"] == "write" and r.get("len") == len(payload)
               for r in recs) and "/a" in names:
            assert rec.view.read_file("/a") == payload, "write record " \
                "durable but its data is not"
        rec.view.statfs()

    return sim.sweep(workload, invariant, setup=setup, quick=quick)


def torture_prov_chain(kind: str = "xv6", *, quick: bool = False,
                       device: DeviceLike = None) -> int:
    """The chained shape: one journal transaction must span the chain's
    data AND its provenance records — after recovery the file and its
    create/write records exist together or not at all."""
    payload = b"Q" * (2 * 4096 + 17)
    sim = CrashSim(_prov_factory(kind), nlog=64, device=device)

    def invariant(rec: Recovered) -> None:
        recs = rec.fs.read_provenance()
        have_file = rec.view.exists("/f")
        have_recs = [r["op"] for r in recs if r.get("name") == "f"
                     or (r["op"] == "write" and r.get("len") == len(payload))]
        if have_file:
            assert rec.view.read_file("/f") == payload, "half-applied chain"
            assert have_recs == ["create", "write"], \
                f"chain durable without its records: {have_recs}"
        else:
            assert rec.crashed, "no crash, yet /f is missing"
            assert not have_recs, \
                f"records durable without their chain: {have_recs}"
        rec.view.listdir("/")

    return sim.sweep(chain_workload(payload), invariant, quick=quick)


# --- dedup-index torture: the content-addressed plane must stay exact ------------


def _dedup_factory(kind: str):
    from repro_torch.fs.ext4like import Ext4LikeFileSystem
    from repro_torch.fs.xv6 import Xv6FileSystem, Xv6Options

    return {
        "xv6": lambda: Xv6FileSystem(Xv6Options(dedup=True)),
        "ext4like": lambda: Ext4LikeFileSystem(Xv6Options(dedup=True)),
    }[kind]


def _dedup_audit(rec: Recovered) -> None:
    """The refcount-exact audit. Walk EVERY inode on the recovered image
    and rebuild, from the metadata alone, the per-block reference map the
    dedup index claims to maintain; then require exact agreement:

    * index == walk, block for block and count for count — a stale entry,
      a missed decrement, or a lost CoW break all fail;
    * bitmap == reachability — every allocated data block is reachable
      from some inode (no leaks) and every reachable block is allocated
      (no double-frees), shared blocks counted once;
    * every VALID index hash matches its block's recomputed checksum — a
      hash that survived a crash it shouldn't have fails here.

    Because index records journal in the same transaction as the write
    that caused them, all three must hold at every crash point."""
    import repro_torch.fs.layout as L

    fs, store, geo = rec.fs, rec.fs._blockstore, rec.fs.geo
    refs: dict = {}      # data block -> walked reference count (files only)
    reachable: set = set()
    for ino in range(1, geo.ninodes):
        di = fs._iget(ino)
        if di.type not in (L.T_FILE, L.T_DIR):
            continue
        counted = di.type == L.T_FILE and ino != store.table_ino
        cache: dict = {}
        for bn in range((di.size + L.BSIZE - 1) // L.BSIZE):
            b = fs._bmap_ro(di, bn, cache)
            if b == 0:
                continue
            reachable.add(b)
            if counted:
                refs[b] = refs.get(b, 0) + 1
        l1, l2 = di.addrs[L.NDIRECT], di.addrs[L.NDIRECT + 1]
        if l1:
            reachable.add(l1)
        if l2:
            reachable.add(l2)
            with fs._bread(l2) as bh:
                raw = bytes(bh.data())
            for k in range(L.NINDIRECT):
                p = int.from_bytes(raw[4 * k: 4 * k + 4], "little")
                if p:
                    reachable.add(p)

    idx = {b: rc for b, rc in store.refcnt.items() if rc > 0}
    if idx != refs:
        only_i = {b: idx[b] for b in set(idx) - set(refs)}
        only_w = {b: refs[b] for b in set(refs) - set(idx)}
        diff = {b: (idx[b], refs[b]) for b in set(idx) & set(refs)
                if idx[b] != refs[b]}
        raise AssertionError(
            f"dedup index not refcount-exact: index-only={only_i} "
            f"walk-only={only_w} count-mismatch={diff}")

    bits_per = L.BSIZE * 8
    allocated = set()
    for bm in range(geo.bmapstart, geo.datastart):
        with fs._bread(bm) as bh:
            raw = bytes(bh.data())
        base = (bm - geo.bmapstart) * bits_per
        for byte_i, byte in enumerate(raw):
            if not byte:
                continue
            for bit in range(8):
                if byte >> bit & 1:
                    b = base + byte_i * 8 + bit
                    if geo.datastart <= b < geo.size:
                        allocated.add(b)
    leaked = allocated - reachable
    dangling = reachable - allocated
    assert not leaked, \
        f"block leak (allocated, unreachable): {sorted(leaked)[:8]}"
    assert not dangling, \
        f"double-free (reachable, not allocated): {sorted(dangling)[:8]}"

    hashed = sorted(store.hashval)
    if hashed:
        contents = []
        for b in hashed:
            with fs._bread(b) as bh:
                contents.append(bytes(bh.data()))
        for b, h in zip(hashed, fs.ks.checksum_batch(contents)):
            assert store.refcnt.get(b, 0) > 0, \
                f"valid hash on unreferenced block {b}"
            assert h == store.hashval[b], f"stale hash on block {b}"
    rec.view.statfs()
    rec.view.listdir("/")


def torture_dedup(kind: str = "xv6", *, quick: bool = False,
                  device: DeviceLike = None) -> int:
    """Sweep a dup-heavy write → CoW overwrite → unlink sequence on a
    dedup mount and run the refcount-exact audit (``_dedup_audit``) after
    power loss at every device write. The workload crosses every index
    transition: fresh tracking, sharing (dedup hit), a copy-on-write
    break of a shared block, and reference release down to a physical
    free — each staged in the same journal transaction as its cause, so
    the recovered index can never drift from the recovered metadata."""
    D, U = b"D" * 4096, b"u" * 4096

    def setup(ctx: CrashCtx) -> None:
        ctx.view.write_file("/base", D * 2)  # durable dup source

    def workload(ctx: CrashCtx) -> None:
        v = ctx.view
        v.write_file("/c1", D * 2)       # full dup: shares with /base
        v.fsync("/c1")
        v.write_file("/c2", D + U)       # half dup, half unique
        v.fsync("/c2")
        v.write_file("/c1", b"X" * 4096, off=0, create=False)  # CoW break
        v.fsync("/c1")
        v.unlink("/c2")                  # shared ref drops, unique frees
        v.fsync("/base")

    sim = CrashSim(_dedup_factory(kind), device=device)
    return sim.sweep(workload, _dedup_audit, setup=setup, quick=quick)


def torture_dedup_churn(kind: str = "xv6", *, quick: bool = False,
                        device: DeviceLike = None) -> int:
    """Sweep sustained create/delete churn that drives the dedup index
    through COMPACTION (a fully-dead table block punched back to the
    allocator) and REMATERIALIZATION (a record landing on the punched
    hole), with the refcount-exact audit at every power-loss point.

    Geometry: one table block maps 512 consecutive data blocks, so the
    durable setup probes where allocation currently sits (root dir and
    the index file itself claim the first few data blocks) and plants a
    distinct-block filler that UNDERSHOOTS table block 0's record range
    by a small margin — metadata blocks (indirects, dir growth) carry no
    refcount and never keep a table block alive, so exact alignment is
    unnecessary. The workload's churn file then spans the boundary into
    table block 1 and is the only thing live there, so emptying it
    (punch fires inside the unlink transaction) and re-writing across
    the boundary (remat fires inside the write transaction) exercise
    both transitions. Every block's content is unique — self-dedup
    would collapse the ranges. The golden run asserts both transitions
    actually happen — a sweep that never compacts proves nothing."""
    per_blk = 4096 // 8  # records per table block (_REC_SIZE == 8)

    def _blocks(tag: int, n: int) -> bytes:
        # n blocks, each 4096B of globally-unique content (no self-dedup)
        return b"".join((tag + i).to_bytes(4, "big") * 1024
                        for i in range(n))

    filler_len = [0]

    def setup(ctx: CrashCtx) -> None:
        v, store = ctx.view, ctx.fs._blockstore
        v.write_file("/probe", _blocks(9 << 24, 1))
        v.fsync("/probe")
        idx = max(store.refcnt) - ctx.fs.geo.datastart
        filler_len[0] = per_blk - 1 - idx - 16  # 16-record undershoot
        v.write_file("/filler", _blocks(0, filler_len[0]))
        v.fsync("/filler")

    def workload(ctx: CrashCtx) -> None:
        v = ctx.view
        v.write_file("/churn", _blocks(1 << 16, 96))  # spans into block 1
        v.fsync("/churn")
        v.unlink("/churn")                  # last live records die: punch
        v.fsync("/filler")
        v.write_file("/re", _blocks(2 << 16, 64))  # back into hole: remat
        v.fsync("/re")

    sim = CrashSim(_dedup_factory(kind), n_blocks=2048, nlog=64,
                   device=device)
    # prove the golden run crosses both transitions
    ctx = sim.boot(setup)
    workload(ctx)
    st = ctx.fs._blockstore.stats
    assert st["compactions"] > 0, "churn workload never compacted"
    assert st["remats"] > 0, "churn workload never rematerialized"

    def invariant(rec: Recovered) -> None:
        _dedup_audit(rec)
        assert rec.view.read_file("/filler") == _blocks(0, filler_len[0])

    return sim.sweep(workload, invariant, setup=setup, quick=quick)


# --- parallel-drain torture: sharded lock domains vs the serial drain -------------


def torture_parallel(kind: str = "xv6", *, quick: bool = False,
                     dedup: bool = False, workers: int = 4,
                     device: DeviceLike = None) -> int:
    """The tentpole's proof: drive a multi-submitter drain — one mutating
    submitter (a linked create→write→fsync chain) plus three read-only
    submitters on disjoint inode stripes — through the footprint-scheduled
    PARALLEL executor at every power-loss point, and require that

    * the recovered device image is BYTE-IDENTICAL to the serial drain's
      at the same crash point (mutations are ALLOC-serialized and reads
      write nothing, so the device write stream — and therefore every
      crash point — must be exactly the serial drain's), and
    * the chain stays all-or-nothing and the read targets stay intact,
      under both executors.

    ``dedup=True`` runs the same sweep on a dedup mount, where every
    footprint carries the BLOCKSTORE domain — the degenerate
    fully-serialized schedule must ALSO match the serial drain."""
    import concurrent.futures as _cf

    from repro_torch.core.interface import (PrevResult, SQE_LINK,
                                            SubmissionEntry,
                                            execute_multi_batch)

    payload = b"P" * (2 * 4096 + 9)
    seed = b"r" * (4096 + 11)

    def setup(ctx: CrashCtx) -> None:
        for i in range(4):
            ctx.view.write_file(f"/r{i}", seed)

    def make_workload(pool):
        def run(ctx: CrashCtx) -> None:
            inos = [ctx.view.stat(f"/r{i}").ino for i in range(4)]
            mut = [
                SubmissionEntry("create", (1, "f"), user_data="c",
                                flags=SQE_LINK),
                SubmissionEntry("write", (PrevResult("ino"), 0, payload),
                                user_data="w", flags=SQE_LINK),
                SubmissionEntry("fsync", (PrevResult("ino", back=2),),
                                user_data="s"),
            ]
            readers = [[SubmissionEntry("read", (ino, 0, len(seed)))
                        for ino in inos] for _ in range(3)]
            segs = execute_multi_batch(ctx.fs.submit_batch, [mut] + readers,
                                       pool=pool)
            bad = [(c.user_data, c.errno) for c in segs[0] if not c.ok]
            assert not bad, f"chain failed without a crash: {bad}"
            for seg in segs[1:]:
                for c in seg:
                    assert c.ok and c.result == seed, "reader saw bad data"
        return run

    factory = _dedup_factory(kind) if dedup else _fs_factory(kind)
    sim = CrashSim(factory, device=device)
    serial, chk = make_workload(None), all_or_nothing(payload)
    total = sim.measure(serial, setup=setup)
    points = quick_points(total) if quick else range(total + 1)
    pool = _cf.ThreadPoolExecutor(max_workers=workers)
    try:
        parallel = make_workload(pool)
        for point in points:
            rp = sim.run_one(parallel, point, total=total, setup=setup)
            rs = sim.run_one(serial, point, total=total, setup=setup)
            try:
                assert rp.crashed == rs.crashed, \
                    f"crash divergence: par={rp.crashed} ser={rs.crashed}"
                assert (rp.dev._data.tobytes() == rs.dev._data.tobytes()), \
                    "parallel drain produced a different device image"
                for rec in (rp, rs):
                    chk(rec)
                    for i in range(4):
                        assert rec.view.read_file(f"/r{i}") == seed, \
                            f"/r{i} damaged by a concurrent-domain drain"
            except AssertionError as e:
                raise AssertionError(
                    f"parallel-drain invariant violated at crash point "
                    f"{point}/{total}: {e}") from e
    finally:
        pool.shutdown(wait=False)
    return len(list(points))


# --- lazy-materialization + overlay tortures (repro_torch.fs.blockdev / .overlay) ------


def _golden_image(kind: str, populate, *, n_blocks: int = 2048,
                  ninodes: int = 256, nlog: int = 32,
                  device: DeviceLike = None) -> MemBlockDevice:
    """A formatted, populated, CLEANLY unmounted image at the CrashSim
    geometry — the provider a ``LazyBlockDevice`` fetches from. The clean
    unmount matters: a provider image must never need recovery writes."""
    dev = MemBlockDevice(n_blocks)
    ks = kernel_binding(dev, device=device)
    mkfs(ks, ninodes=ninodes, nlog=nlog)
    fs = _fs_factory(kind)()
    fs.init(ks.superblock(), ks)
    m = DirectMount(fs)
    populate(PosixView(m))
    m.unmount()
    return dev


def torture_lazy(kind: str = "xv6", *, quick: bool = False,
                 device: DeviceLike = None) -> int:
    """Sweep a read-then-mutate workload on an fs mounted directly ON a
    ``LazyBlockDevice`` over a golden image, with power loss at every
    LOCAL device write — which includes both halves of the 2-step
    materialization protocol (data landing, valid-bit commit), so crash
    points land BETWEEN them. The invariant: a half-materialized block is
    NEVER visible — after remounting the SAME device (local store and
    valid bitmap survive, like a disk), base content reads back exactly
    (invalid blocks re-fetch from the provider), the mutation chain stays
    all-or-nothing, and the provider image is never written."""
    base_payload = b"G" * (3 * 4096 + 41)

    def populate(view: PosixView) -> None:
        view.write_file("/base", base_payload)

    image = _golden_image(kind, populate, device=device)
    image_writes0 = image.writes
    image_bytes0 = image._data.tobytes()

    new_payload = b"L" * (2 * 4096 + 17)
    run_chain = chain_workload(new_payload)

    def workload(ctx: CrashCtx) -> None:
        # the read MATERIALIZES /base's blocks: counted local writes, so
        # the sweep enumerates power loss inside the fetch protocol
        got = ctx.view.read_file("/base")
        assert got == base_payload, "golden read failed without a crash"
        run_chain(ctx)

    chk = all_or_nothing(new_payload)

    def invariant(rec: Recovered) -> None:
        assert isinstance(rec.dev, LazyBlockDevice)
        got = rec.view.read_file("/base")
        assert got == base_payload, (
            f"half-materialized base content visible: /base has "
            f"{len(got)}B, {sum(a != b for a, b in zip(got, base_payload))}"
            f" bytes differ")
        chk(rec)
        assert image.writes == image_writes0, \
            "the provider image took a write"

    sim = CrashSim(
        _fs_factory(kind), format_device=False, device=device,
        device_factory=lambda: LazyBlockDevice(
            image, n_blocks=image.n_blocks, device_id="lazy-torture"))
    n = sim.sweep(workload, invariant, quick=quick)
    assert image._data.tobytes() == image_bytes0, \
        "the provider image was dirtied during the sweep"
    return n


def torture_overlay(kind: str = "xv6", *, quick: bool = False,
                    device: DeviceLike = None) -> int:
    """Sweep the overlay-specific multi-step mutations — whiteout,
    create-over-whiteout, copy-up overwrite, copy-up + rename — on a CoW
    tenant (writable upper, lazy immutable base) with power loss at every
    UPPER device write. At every point the merged view must show each
    name old-XOR-new (a deleted base name never resurrects half-way, a
    copied-up file is never torn between base and upper content, a
    renamed name never exists on both sides), no copy-up temp file is
    ever visible, and the shared base image stays byte-identical."""
    from repro_torch.fs.mounts import build_base_image
    from repro_torch.fs.overlay import COWTMP_PREFIX, OverlayFilesystem, \
        OverlayOptions

    image = build_base_image(kind, n_blocks=2048, device=device)
    image_writes0 = image.writes
    image_bytes0 = image._data.tobytes()

    BASE_MOTD = b"welcome to the base image\n"
    BASE_HOST = b"golden\n"
    BASE_README = b"base readme\n"
    BASE_WORDS = b"alpha beta gamma delta\n" * 64
    NEW_MOTD = b"tenant motd, reborn over the whiteout\n"
    NEW_HOST = b"tenant-hostname-longer-than-the-golden-one\n"

    def factory():
        lazy = LazyBlockDevice(image, n_blocks=image.n_blocks,
                               device_id="lazy-base", immutable_base=True)
        return OverlayFilesystem(OverlayOptions(kind=kind, base_dev=lazy))

    def workload(ctx: CrashCtx) -> None:
        v = ctx.view
        v.unlink("/etc/motd")                   # whiteout over a base name
        v.write_file("/etc/motd", NEW_MOTD)     # create over the whiteout
        v.write_file("/etc/hostname", NEW_HOST)  # copy-up overwrite
        v.rename("/readme", "/readme2")         # copy-up + move + whiteout
        ctx.fs.flush()

    def invariant(rec: Recovered) -> None:
        v = rec.view
        # unlink → recreate: base content XOR gone XOR empty-new XOR new
        # (write_file is create-then-write, so the fresh empty file is a
        # legal intermediate; a torn HYBRID of base and new is not)
        if v.exists("/etc/motd"):
            motd = v.read_file("/etc/motd")
            assert motd in (BASE_MOTD, b"", NEW_MOTD), \
                f"torn whiteout/recreate: /etc/motd = {motd!r}"
        else:
            assert rec.crashed, "no crash, yet /etc/motd is missing"
        # copy-up overwrite is ONE transaction: old XOR new content
        host = v.read_file("/etc/hostname")
        assert host in (BASE_HOST, NEW_HOST), \
            f"half-copied-up file visible: /etc/hostname = {host!r}"
        # copy-up + rename + source whiteout is ONE transaction: exactly
        # one of the two names resolves, with the COMPLETE content
        src, dst = v.exists("/readme"), v.exists("/readme2")
        assert src != dst, (
            "rename not atomic: /readme and /readme2 " +
            ("both visible" if src else "both missing"))
        assert v.read_file("/readme2" if dst else "/readme") == BASE_README
        if not rec.crashed:  # control: every step must be durable
            assert dst and motd == NEW_MOTD and host == NEW_HOST, \
                "no crash, yet the workload's end state is not visible"
        # a half-copied-up temp name must never appear in any listing
        for d in ("/", "/etc"):
            tmp = [n for n in v.listdir(d) if n.startswith(COWTMP_PREFIX)]
            assert not tmp, f"copy-up temp visible in {d}: {tmp}"
        # untouched base names still merge intact (re-fetch path)
        assert v.read_file("/usr/share/words") == BASE_WORDS
        # the shared base image is immutable — never even one write
        assert image.writes == image_writes0, "base image took a write"
        assert image._data.tobytes() == image_bytes0, "base image dirtied"
        v.statfs()

    sim = CrashSim(factory, nlog=64, device=device)
    return sim.sweep(workload, invariant, quick=quick)


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true",
                    help="bounded crash-point subset (CI smoke)")
    ap.add_argument("--kind", default="both",
                    choices=["xv6", "ext4like", "both"])
    ap.add_argument("--payload-blocks", type=int, default=2)
    ap.add_argument("--fuse", action="store_true",
                    help="also torture the FUSE daemon's file-backed "
                         "device (subprocess per point — slower)")
    ap.add_argument("--torn-bytes", type=int, default=-1,
                    help="with --fuse: tear the dying write after this "
                         "many bytes instead of losing it whole")
    ap.add_argument("--dedup", action="store_true",
                    help="also torture the content-addressed dedup plane "
                         "(refcount-exact index audit at every point) and "
                         "the index compaction/remat path under churn")
    ap.add_argument("--no-parallel", action="store_true",
                    help="skip the parallel-drain differential sweep")
    ap.add_argument("--lazy", action="store_true",
                    help="also torture the lazy-materialization protocol "
                         "(power loss inside the 2-step block fetch)")
    ap.add_argument("--overlay", action="store_true",
                    help="also torture CoW overlay tenants (whiteouts, "
                         "copy-up, rename — old-XOR-new at every point)")
    ap.add_argument("--ckpt", action="store_true",
                    help="also torture the v2 sharded checkpoint re-save "
                         "(old XOR complete-new at every point, shard "
                         "files and checksums included)")
    ap.add_argument("--device", default=None,
                    help="torch device the kernel binding checksums on "
                         "(default: cuda)")
    args = ap.parse_args()
    kinds = ["xv6", "ext4like"] if args.kind == "both" else [args.kind]
    mode = "quick subset" if args.quick else "exhaustive"
    for kind in kinds:
        n = torture_chain(kind, payload_blocks=args.payload_blocks,
                          quick=args.quick, device=args.device)
        print(f"crashsim {kind}: create→write(PrevResult)→fsync chain "
              f"all-or-nothing at {n} crash points ({mode}) — OK")
        n = torture_rename(kind, quick=args.quick, device=args.device)
        print(f"crashsim {kind}: rename-overwrite old-XOR-new (+blocks "
              f"freed) at {n} crash points ({mode}) — OK")
        n = torture_prov(kind, quick=args.quick, device=args.device)
        print(f"crashsim {kind}: provenance log explains the recovered fs "
              f"at {n} crash points ({mode}) — OK")
        n = torture_prov_chain(kind, quick=args.quick, device=args.device)
        print(f"crashsim {kind}: chain txn spans data + provenance records "
              f"at {n} crash points ({mode}) — OK")
        if not args.no_parallel:
            n = torture_parallel(kind, quick=args.quick, device=args.device)
            print(f"crashsim {kind}: parallel drain byte-identical to "
                  f"serial at {n} crash points ({mode}) — OK")
        if args.lazy:
            n = torture_lazy(kind, quick=args.quick, device=args.device)
            print(f"crashsim {kind}: no half-materialized block visible, "
                  f"provider untouched at {n} crash points ({mode}) — OK")
        if args.overlay:
            n = torture_overlay(kind, quick=args.quick, device=args.device)
            print(f"crashsim {kind}: overlay whiteout/copy-up/rename "
                  f"old-XOR-new at {n} crash points ({mode}) — OK")
        if args.ckpt:
            n = torture_ckpt_shards(kind, quick=args.quick,
                                    device=args.device)
            print(f"crashsim {kind}: sharded checkpoint re-save old-XOR-"
                  f"complete-new at {n} crash points ({mode}) — OK")
        if args.dedup:
            n = torture_dedup(kind, quick=args.quick, device=args.device)
            print(f"crashsim {kind}: dedup index refcount-exact (+no "
                  f"leaks, hashes fresh) at {n} crash points ({mode}) — OK")
            n = torture_dedup_churn(kind, quick=args.quick, device=args.device)
            print(f"crashsim {kind}: index compaction punch + remat under "
                  f"churn at {n} crash points ({mode}) — OK")
            n = torture_parallel(kind, quick=args.quick, dedup=True,
                                 device=args.device)
            print(f"crashsim {kind}: dedup-mount parallel drain matches "
                  f"serial at {n} crash points ({mode}) — OK")
    if args.fuse:
        n = torture_fuse(quick=True, torn_bytes=args.torn_bytes)
        torn = (f", torn at {args.torn_bytes}B" if args.torn_bytes >= 0
                else "")
        print(f"crashsim fuse: daemon-side chain all-or-nothing at {n} "
              f"crash points (quick subset{torn}) — OK")


if __name__ == "__main__":
    main()
