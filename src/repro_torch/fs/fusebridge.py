"""FUSE baseline: the file system in a separate *daemon process*
("userspace"), every operation marshalled over a unix socket — a real
address-space crossing with real serialization cost, not a simulated sleep.

Mirrors the paper's FUSE setup: the same fs code, userspace services
binding (file-backed block device, whole-file fsync — the paper's "no way
to sync parts of a file" penalty), and per-operation request/response
messages through the kernel boundary (here: a unix socket with
length-prefixed pickle frames + a context switch per op).

The daemon is a plain ``subprocess`` running ``python -m
repro_torch.fs.fusebridge`` — no multiprocessing fork/spawn games, so it is
safe to start from a multithreaded PyTorch parent. Its userspace binding
launches no kernel, and the modules on its path load ``torch`` only when a
kernel binding or a ``TorchBlockDevice`` is made, so the daemon starts
without it.

Multi-submitter: each client THREAD gets its own channel (socket
connection), so submissions from many threads are in flight at once, and
the daemon drains every channel with a readable ``submit_batch`` request
per service round into ONE ``execute_multi_batch`` call — the SQPOLL-style
drain of ``repro_torch.core.registry``, carried across the address-space
boundary. Chains stay within their channel's submission; unchained runs
coalesce across channels into the fs's vectorized paths. Scalar ops ride
the same per-thread channels (multi-queue /dev/fuse): a service round
collects every readable channel's scalar request, so N scalar callers
no longer serialize behind one connection's request/response turn.

Crash torture: a ``__ctl__`` side-channel arms write-stream fault
injection in the daemon's FileBlockDevice (power loss after the Nth
device write, optionally tearing the dying write mid-block), and
``FuseMount.kill()`` is the power-cut analogue — SIGKILL, no flush, the
backing file left exactly as the last completed write left it. Remounting
with ``reuse=True`` skips mkfs so daemon-side journal recovery runs
against the survived image (see ``repro_torch.fs.crashsim.FuseCrashSim``).
"""

from __future__ import annotations

import os
import pickle
import selectors
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, List, Optional

from repro_torch.core.interface import (Errno, FS_OPS as _FS_OPS, FsError,
                                        execute_multi_batch)


def _send(sock: socket.socket, obj: Any) -> None:
    raw = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(struct.pack("<I", len(raw)) + raw)


def _recv(sock: socket.socket) -> Any:
    hdr = _recv_exact(sock, 4)
    (n,) = struct.unpack("<I", hdr)
    return pickle.loads(_recv_exact(sock, n))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise EOFError("fuse daemon connection closed")
        buf += chunk
    return buf


def _send_quiet(sock: socket.socket, obj: Any) -> None:
    """Best-effort reply: a channel whose client vanished mid-drain must
    not take the daemon (and every other channel) down with it. A reply
    that won't SERIALIZE (an op returning an unpicklable object) is a
    programming error on the daemon side — before this guard it
    propagated out of the service loop and killed every channel; now the
    client gets an ``error`` frame naming the failure instead of EOF."""
    try:
        _send(sock, obj)
    except OSError:
        pass
    except Exception as e:  # noqa: BLE001 — pickle/struct failures
        _log_exc(f"unserializable reply ({type(obj).__name__})")
        try:
            _send(sock, ("error", f"unserializable daemon reply: "
                                  f"{type(e).__name__}: {e}"))
        except Exception:  # noqa: BLE001 — client gone too: nothing owed
            pass


def _log_exc(context: str) -> None:
    """Daemon-side error log: programming errors are NEVER swallowed
    silently — the traceback lands on stderr (the client holds the pipe),
    and the offending channel is failed, not the whole daemon."""
    import traceback

    print(f"fusebridge: {context}", file=sys.stderr)
    traceback.print_exc(file=sys.stderr)
    sys.stderr.flush()


def _make_fs(fs_kind: str, opts):
    """Module factory for the daemon's mount matrix. ``prov-<kind>``
    wraps the base fs in the provenance layer at mount time (the
    re-mount/crash-recovery path; live swaps go through the ``wrap_prov``
    ctl instead); ``dedup-<kind>`` enables the content-addressed
    blockstore (prefixes compose: ``prov-dedup-xv6``)."""
    import dataclasses as _dc

    from repro_torch.fs.ext4like import Ext4LikeFileSystem
    from repro_torch.fs.prov import ProvFilesystem
    from repro_torch.fs.xv6 import Xv6FileSystem

    base_kind = fs_kind[len("prov-"):] if fs_kind.startswith("prov-") \
        else fs_kind
    if base_kind.startswith("dedup-"):
        base_kind = base_kind[len("dedup-"):]
        opts = _dc.replace(opts, dedup=True)
    fs = (Ext4LikeFileSystem(opts) if base_kind == "ext4like"
          else Xv6FileSystem(opts))
    return ProvFilesystem(fs) if fs_kind.startswith("prov-") else fs


def _swap_module(ks, state, new_fs) -> dict:
    """Daemon-side hot swap: the single-threaded service loop IS the op
    gate (a ctl request is never concurrent with a drain), so the swap is
    extract → init → restore → install, same protocol as
    ``repro_torch.core.upgrade`` behind the real gate. Returns the measured
    pause — the daemon's analogue of the upgrade timing stats."""
    import time as _time

    from repro_torch.core.upgrade import _extracted_state

    old = state["fs"]
    t0 = _time.perf_counter()
    st = _extracted_state(old, new_fs, None, True)
    new_fs.init(ks.superblock(), ks)
    new_fs.restore_state(st, old.VERSION)
    state["fs"] = new_fs
    state["generation"] += 1
    old.destroy()
    return {"pause_s": _time.perf_counter() - t0,
            "generation": state["generation"],
            "module": type(new_fs).__name__}


def _handle_ctl(dev, stats, ks, state, args) -> Any:
    """The daemon side-channel: crash-torture fault injection, drain
    counters, and the live provenance wrap/unwrap (values only — the
    client never touches daemon objects)."""
    from repro_torch.core.upgrade import _fresh_like
    from repro_torch.fs.prov import ProvFilesystem

    cmd = args[0]
    if cmd == "fail_after_writes":
        dev.fail_after_writes = int(args[1])
        dev.fail_torn_bytes = int(args[2]) if len(args) > 2 else -1
        dev._writes_seen = 0
        return None
    if cmd == "writes_seen":
        return dev._writes_seen
    if cmd == "stats":
        return dict(stats, generation=state["generation"],
                    module=type(state["fs"]).__name__)
    if cmd == "generation":
        return state["generation"]
    if cmd == "wrap_prov":
        old = state["fs"]
        if isinstance(old, ProvFilesystem):
            raise FsError(Errno.EEXIST, "provenance layer already mounted")
        return _swap_module(ks, state, ProvFilesystem(_fresh_like(old)))
    if cmd == "unwrap_prov":
        old = state["fs"]
        if getattr(old, "inner", None) is None:
            raise FsError(Errno.EINVAL, "no layer to unwrap")
        return _swap_module(ks, state, _fresh_like(old.inner))
    raise FsError(Errno.EINVAL, f"unknown ctl {cmd!r}")


def serve(sock_path: str, backing_path: str, n_blocks: int, fs_kind: str,
          do_mkfs: bool = True) -> None:
    """Daemon main: userspace binding + the same fs code, serving any
    number of client channels. ``do_mkfs=False`` remounts an existing
    image (journal recovery runs in the fs's init)."""
    from repro_torch.core.services import userspace_binding
    from repro_torch.fs.blockdev import FileBlockDevice
    from repro_torch.fs.xv6 import Xv6Options, mkfs

    dev = FileBlockDevice(backing_path, n_blocks)
    ks = userspace_binding(dev)
    if do_mkfs:
        mkfs(ks)
    # userspace policy: synchronous installs, whole-file fsync
    opts = Xv6Options(group_commit=True, batched_install=False)
    fs = _make_fs(fs_kind, opts)
    fs.init(ks.superblock(), ks)
    # the live module rides in a holder so the wrap/unwrap ctl can swap it
    # between service rounds (the loop is the gate: no request in flight)
    state = {"fs": fs, "generation": 1}

    # drain observability (read via __ctl__ "stats"): drains counts service
    # rounds that executed submit_batch traffic, batch_requests the client
    # submissions they carried — requests ≫ drains is the multi-channel win.
    # scalar_requests counts one-op calls the same way (they ride per-thread
    # channels too), multi_channel_scalar_rounds the service rounds that
    # collected scalars from more than one channel at once.
    stats = {"drains": 0, "batch_requests": 0, "multi_channel_drains": 0,
             "scalar_requests": 0, "multi_channel_scalar_rounds": 0}

    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(sock_path)
    srv.listen(64)
    sel = selectors.DefaultSelector()
    sel.register(srv, selectors.EVENT_READ)
    channels: List[socket.socket] = []
    shutdown = False

    def drop(conn):
        try:
            sel.unregister(conn)
        except (KeyError, ValueError):
            pass  # already failed earlier this round
        conn.close()
        if conn in channels:
            channels.remove(conn)

    try:
        while not shutdown:
            events = sel.select(timeout=1.0)
            batch_reqs = []   # (conn, entries): drained together this round
            scalar_reqs = []  # (conn, op, args, kw): served one at a time
            for key, _ in events:
                if key.fileobj is srv:
                    conn, _ = srv.accept()
                    sel.register(conn, selectors.EVENT_READ)
                    channels.append(conn)
                    continue
                conn = key.fileobj
                try:
                    msg = _recv(conn)
                except (EOFError, OSError):
                    drop(conn)
                    continue
                except Exception:  # noqa: BLE001 — poisoned frame
                    # an undecodable frame used to propagate OUT of the
                    # service loop and kill the daemon — every other
                    # channel died with an unexplained EOF. Fail only the
                    # channel that sent the poison.
                    _log_exc("undecodable frame — failing the channel")
                    _send_quiet(conn, ("error", "undecodable request "
                                                "frame — channel failed"))
                    drop(conn)
                    continue
                if msg is None:
                    shutdown = True
                    break
                try:
                    op, args, kw = msg
                except (TypeError, ValueError):
                    _log_exc(f"malformed request {type(msg).__name__} — "
                             "failing the channel")
                    _send_quiet(conn, ("error", "malformed request (want "
                                                "(op, args, kw)) — "
                                                "channel failed"))
                    drop(conn)
                    continue
                if op == "submit_batch":
                    batch_reqs.append((conn, args[0]))
                else:
                    scalar_reqs.append((conn, op, args, kw))
            if batch_reqs:
                # ONE boundary crossing for every channel's pending
                # submission: chains grouped per channel, cancellation and
                # PrevResult substitution daemon-side, so a chained batch
                # still costs its channel one round trip.
                stats["drains"] += 1
                stats["batch_requests"] += len(batch_reqs)
                if len(batch_reqs) > 1:
                    stats["multi_channel_drains"] += 1
                try:
                    segs = execute_multi_batch(
                        state["fs"].submit_batch,
                        [ents for _, ents in batch_reqs])
                except FsError as e:
                    # whole-drain refusal (reservation/validation): a real
                    # errno every submitter understands — channels live on
                    for conn, _ in batch_reqs:
                        _send_quiet(conn, ("fs_error", int(e.errno)))
                except Exception as e:  # noqa: BLE001 — programming error
                    # NOT an fs refusal: daemon-side state may be torn
                    # mid-drain. Log it, surface it to every involved
                    # client, then FAIL those channels — continuing to
                    # serve them would pretend the drain half-happened.
                    _log_exc("programming error in multi-batch drain — "
                             "failing the involved channels")
                    for conn, _ in batch_reqs:
                        _send_quiet(conn, ("error",
                                           f"{type(e).__name__}: {e}"))
                        drop(conn)
                else:
                    if any(e.op in ("fsync", "flush")
                           for _, ents in batch_reqs for e in ents):
                        dev.sync()  # whole-file sync penalty, once per drain
                    for (conn, _), comps in zip(batch_reqs, segs):
                        _send_quiet(conn, ("ok", comps))
            if scalar_reqs:
                stats["scalar_requests"] += len(scalar_reqs)
                if len({id(c) for c, _, _, _ in scalar_reqs}) > 1:
                    stats["multi_channel_scalar_rounds"] += 1
            for conn, op, args, kw in scalar_reqs:
                try:
                    if op == "__ctl__":
                        _send_quiet(conn, ("ok", _handle_ctl(dev, stats, ks,
                                                             state, args)))
                        continue
                    if op == "fsync":
                        # paper: the file interface can't sync parts of a
                        # file — the whole backing file syncs per fsync.
                        state["fs"].journal.commit()
                        dev.sync()
                        _send_quiet(conn, ("ok", None))
                        continue
                    res = getattr(state["fs"], op)(*args, **kw)
                    _send_quiet(conn, ("ok", res))
                except FsError as e:
                    _send_quiet(conn, ("fs_error", int(e.errno)))
                except Exception as e:  # noqa: BLE001 — programming error
                    # narrow contract: FsError -> errno above; anything
                    # else is a bug (unknown op, bad arg types, daemon
                    # state corruption). Log the traceback, surface it to
                    # the caller, and fail the channel — the old handler
                    # replied "error" and kept serving a connection whose
                    # op may have half-applied.
                    _log_exc(f"programming error in scalar op {op!r} — "
                             "failing the channel")
                    _send_quiet(conn, ("error", f"{type(e).__name__}: {e}"))
                    drop(conn)
    finally:
        try:
            state["fs"].destroy()
            dev.close()
        except Exception:  # noqa: BLE001 — teardown after injected crash
            pass
        for conn in channels:
            conn.close()
        srv.close()


class FuseMount:
    """Client-side mount handle: same call surface as core.registry.Mount.

    Scalar calls AND ``submit`` both ride a per-THREAD channel (the
    multi-queue /dev/fuse clone of the multi-submitter design), so
    concurrent scalar callers stop funneling through one connection:
    each thread has one request in flight on its own socket and the
    daemon collects every readable channel per service round
    (``mq_submissions`` counts this client's submissions — daemon-side
    drain/scalar counts come back via ``ctl("stats")``). The primary
    socket opened at mount is reserved for the shutdown sentinel."""

    def __init__(self, n_blocks: int = 16384, fs_kind: str = "xv6",
                 backing_path: Optional[str] = None, reuse: bool = False):
        self._tmpdir = tempfile.mkdtemp(prefix="fusebridge_")
        if backing_path is None:
            backing_path = os.path.join(self._tmpdir, "disk.img")
        self.backing_path = backing_path
        sock_path = os.path.join(self._tmpdir, "fuse.sock")
        self._sock_path = sock_path
        env = dict(os.environ)
        src_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = src_root + os.pathsep + env.get("PYTHONPATH", "")
        self._proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.fs.fusebridge", sock_path,
             backing_path, str(n_blocks), fs_kind,
             "reuse" if reuse else "mkfs"],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        self._sock = self._connect(deadline_s=30)
        self.generation = 1
        self.name = f"fuse-{fs_kind}"
        self._tls = threading.local()
        self._channels: List[socket.socket] = [self._sock]
        self._chan_lock = threading.Lock()
        self.mq_submissions = 0

    def _connect(self, deadline_s: float) -> socket.socket:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        deadline = time.time() + deadline_s
        while True:
            try:
                sock.connect(self._sock_path)
                return sock
            except (FileNotFoundError, ConnectionRefusedError):
                if self._proc.poll() is not None:
                    err = self._proc.stderr.read().decode()[-2000:]
                    raise RuntimeError(f"fuse daemon died at startup: {err}")
                if time.time() > deadline:
                    raise TimeoutError("fuse daemon did not come up")
                time.sleep(0.02)

    def _channel(self) -> socket.socket:
        """This thread's private daemon connection (created on first
        use): the per-thread SQ of the multi-submitter design, carried
        over the address-space boundary. Scalar ops and submissions
        share it — one in-flight request per thread by construction, so
        no lock is needed."""
        ch = getattr(self._tls, "ch", None)
        if ch is None:
            ch = self._connect(deadline_s=10)
            with self._chan_lock:
                self._channels.append(ch)
            self._tls.ch = ch
        return ch

    def call(self, op: str, *args, **kw) -> Any:
        ch = self._channel()
        _send(ch, (op, args, kw))
        status, payload = _recv(ch)
        if status == "ok":
            return payload
        if status == "fs_error":
            raise FsError(Errno(payload))
        raise RuntimeError(payload)

    def ctl(self, *args) -> Any:
        """Crash-torture side-channel (see ``_handle_ctl``): e.g.
        ``ctl("fail_after_writes", n, torn_bytes)`` / ``ctl("stats")``."""
        return self.call("__ctl__", *args)

    def wrap_prov(self) -> Any:
        """Hot-swap the provenance layer onto the daemon's live fs — the
        paper's §6 demo carried across the address-space boundary. The
        swap lands between two service rounds (never mid-drain) and the
        returned dict reports the daemon-side pause. Bumps
        ``generation`` like the in-process upgrade does."""
        res = self.ctl("wrap_prov")
        self.generation = res["generation"]
        return res

    def unwrap_prov(self) -> Any:
        """Strip the daemon's provenance layer (the reverse demo)."""
        res = self.ctl("unwrap_prov")
        self.generation = res["generation"]
        return res

    def submit(self, entries):
        # The batched boundary is where FUSE hurts least: one socket
        # round-trip (two context switches) per submission — and when many
        # threads submit at once, the daemon serves all their channels in
        # one drain. Per-entry errors ride inside the completions, so the
        # daemon's fs_error path is never taken for a batch.
        ch = self._channel()
        self.mq_submissions += 1
        _send(ch, ("submit_batch", (list(entries),), {}))
        status, payload = _recv(ch)
        if status == "ok":
            return payload
        if status == "fs_error":
            raise FsError(Errno(payload))
        raise RuntimeError(payload)

    def __getattr__(self, op: str):
        if op in _FS_OPS:
            return lambda *a, **k: self.call(op, *a, **k)
        raise AttributeError(op)

    def _close_channels(self) -> None:
        with self._chan_lock:
            for ch in self._channels:
                try:
                    ch.close()
                except OSError:
                    pass
            self._channels.clear()

    def _cleanup_tmpdir(self, keep_backing: bool = False) -> None:
        for f in ("disk.img", "fuse.sock"):
            p = os.path.join(self._tmpdir, f)
            if os.path.exists(p) and not (keep_backing and f == "disk.img"):
                os.unlink(p)
        try:
            os.rmdir(self._tmpdir)
        except OSError:
            pass  # backing file kept inside: leave the dir for its owner

    def unmount(self) -> None:
        try:
            self.call("flush")
            _send(self._sock, None)
        except (BrokenPipeError, EOFError, OSError):
            pass
        self._close_channels()
        try:
            self._proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self._proc.terminate()
        self._cleanup_tmpdir()

    def kill(self) -> None:
        """Power-cut analogue: SIGKILL the daemon — no flush, no graceful
        shutdown — leaving the backing file exactly as the last completed
        device write left it. The socket tempdir is cleaned; the backing
        file survives for a ``reuse=True`` remount (crash torture)."""
        self._proc.kill()
        try:
            self._proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass
        self._close_channels()
        self._cleanup_tmpdir(keep_backing=True)


if __name__ == "__main__":
    serve(sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4],
          do_mkfs=(len(sys.argv) < 6 or sys.argv[5] != "reuse"))
