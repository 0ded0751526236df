"""The port's FUSE daemon against the reference's, on the CPU.

Both daemons run the userspace binding (zlib crc32 over a file-backed
device) and launch no kernel, so one op stream through the reference's
and the port's ``FuseMount`` must give equal results and leave
byte-identical backing files. The daemon's error contract
(``tests/test_fusebridge_errors.py``), ``make_mount("fuse", prov=True)``
and the live wrap and unwrap of provenance over the control channel are
held on the port's daemon.
"""

from __future__ import annotations

import os
import pathlib
import socket
import struct
import subprocess
import sys
import threading

import pytest

torch = pytest.importorskip("torch")

import repro.fs.mounts as R_mounts  # noqa: E402
import repro_torch.fs.mounts as T_mounts  # noqa: E402
from repro_torch.core.interface import Errno, FsError  # noqa: E402
from repro_torch.fs.fusebridge import _recv, _send  # noqa: E402
from test_torch_fs_slice import PORT, REF, apply, op_stream  # noqa: E402

N_BLOCKS = 2048


def test_op_stream_and_backing_file_match_reference(tmp_path):
    ref = R_mounts.make_mount("fuse", N_BLOCKS,
                              backing_path=str(tmp_path / "ref.img"))
    port = T_mounts.make_mount("fuse", N_BLOCKS,
                               backing_path=str(tmp_path / "port.img"))
    assert port.mount._proc.args[2] == "repro_torch.fs.fusebridge"
    ops = op_stream(seed=31, n_steps=60)
    got, want = apply(PORT, port, ops), apply(REF, ref, ops)
    assert got == want
    assert sum(r[0] == "err" for r in want) > 0  # errnos were exercised
    stats = port.mount.ctl("stats")
    assert stats["drains"] > 0 and stats["scalar_requests"] > 0
    ref.close()
    port.close()
    port_img = (tmp_path / "port.img").read_bytes()
    assert len(port_img) == N_BLOCKS * 4096
    assert port_img == (tmp_path / "ref.img").read_bytes()


def test_daemon_starts_without_torch():
    """The daemon's path loads no torch: its binding launches no kernel,
    and a daemon boots at every crash point of ``FuseCrashSim``."""
    src = pathlib.Path(T_mounts.__file__).resolve().parents[2]
    code = ("import sys, repro_torch.fs.fusebridge, "
            "repro_torch.core.services, repro_torch.fs.prov, "
            "repro_torch.fs.ext4like\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'repro')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(src)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.fixture
def mf():
    m = T_mounts.make_mount("fuse", n_blocks=N_BLOCKS)
    yield m
    m.close()


def _raw_channel(mount) -> socket.socket:
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.connect(mount._sock_path)
    sock.settimeout(10)
    return sock


def test_fs_error_stays_errno(mf):
    with pytest.raises(FsError) as ei:
        mf.mount.call("lookup", 1, "does-not-exist")
    assert ei.value.errno == Errno.ENOENT


def test_poisoned_op_surfaces_and_fails_only_its_channel(mf):
    mf.view.write_file("/keep", b"before the poison")
    errs = []

    def poison():
        try:
            mf.mount.call("definitely_not_an_op")
        except Exception as e:  # noqa: BLE001 — collected for assertion
            errs.append(e)

    t = threading.Thread(target=poison)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive(), "poisoned op hung instead of surfacing"
    assert len(errs) == 1 and isinstance(errs[0], RuntimeError)
    assert "AttributeError" in str(errs[0])
    assert mf.view.read_file("/keep") == b"before the poison"
    assert mf.mount.ctl("stats")["generation"] == 1


def test_undecodable_frame_fails_channel_not_daemon(mf):
    mf.view.write_file("/alive", b"yes")
    raw = _raw_channel(mf.mount)
    try:
        raw.sendall(struct.pack("<I", 9) + b"\x93garbage!")
        status, payload = _recv(raw)
        assert status == "error" and "undecodable" in payload
        assert raw.recv(1) == b""
    finally:
        raw.close()
    assert mf.view.read_file("/alive") == b"yes"


def test_malformed_message_fails_channel_not_daemon(mf):
    raw = _raw_channel(mf.mount)
    try:
        _send(raw, {"not": "a request"})
        status, payload = _recv(raw)
        assert status == "error" and "malformed" in payload
        assert raw.recv(1) == b""
    finally:
        raw.close()
    assert mf.mount.ctl("stats")["drains"] >= 0


def test_unpicklable_scalar_args_fail_loudly(mf):
    """Run from its own thread, so only that thread's channel is failed
    and the unmount's flush still has a live channel."""
    errs = []

    def bad_args():
        try:
            mf.mount.call("read", object=None)
        except Exception as e:  # noqa: BLE001 — collected for assertion
            errs.append(e)

    t = threading.Thread(target=bad_args)
    t.start()
    t.join(timeout=30)
    assert len(errs) == 1 and isinstance(errs[0], RuntimeError)
    assert "TypeError" in str(errs[0]) or "AttributeError" in str(errs[0])


def test_prov_fuse_mount_and_ctl_swaps():
    """``make_mount("fuse", prov=True)`` runs the daemon's module wrapped
    from the start; on a plain fuse mount the ``wrap_prov`` and
    ``unwrap_prov`` ctls swap the layer inside the daemon, and a second
    wrap or an unwrap of a plain module is refused with an errno."""
    mf = T_mounts.make_mount("fuse", n_blocks=N_BLOCKS, prov=True)
    try:
        assert mf.mount.ctl("stats")["module"] == "ProvFilesystem"
        mf.view.create("/logged")
        assert mf.view.read_provenance()[-1]["name"] == "logged"
    finally:
        mf.close()

    mf = T_mounts.make_mount("fuse", n_blocks=N_BLOCKS)
    try:
        v = mf.view
        with pytest.raises(FsError) as ei:
            mf.mount.unwrap_prov()
        assert ei.value.errno == Errno.EINVAL
        res = mf.mount.wrap_prov()
        assert res["module"] == "ProvFilesystem" and res["generation"] == 2
        assert mf.mount.generation == 2
        with pytest.raises(FsError) as ei:
            mf.mount.wrap_prov()
        assert ei.value.errno == Errno.EEXIST
        v.create("/during")
        res = mf.mount.unwrap_prov()
        assert res["module"] == "Xv6FileSystem" and res["generation"] == 3
        v.create("/after")
        with pytest.raises(FsError):
            v.read_provenance()
        mf.mount.wrap_prov()
        names = [r["name"] for r in v.read_provenance()
                 if r["op"] == "create"]
        assert names == ["during"]
        assert mf.mount.ctl("stats")["generation"] == 4
    finally:
        mf.close()
