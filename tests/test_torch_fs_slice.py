"""The port's file-system slice against the reference package, on the CPU.

For each mount kind the port has, one seeded op stream runs through
``PosixView`` and ``Mount.submit`` batches on a reference mount and on a
port mount (``device="cpu"``); results, errnos and the device images must
be identical. The reference mount is bound to the same blockhash the port
uses (``blockhash_np``) by swapping its ``kernel_binding`` for the test —
on the CPU it would otherwise checksum with zlib crc32 — so journal
commit records and dedup hashes match byte for byte. Crash images move
between the packages through ``from_image`` and must recover alike.
"""

from __future__ import annotations

import dataclasses
import enum
import sys
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.interface as R_if  # noqa: E402
import repro.core.services as R_svc  # noqa: E402
import repro.fs.blockdev as R_dev  # noqa: E402
import repro.fs.ext4like as R_ext4  # noqa: E402
import repro.fs.mounts as R_mounts  # noqa: E402
import repro.fs.xv6 as R_xv6  # noqa: E402
import repro_torch.core.interface as T_if  # noqa: E402
import repro_torch.core.services as T_svc  # noqa: E402
import repro_torch.fs.blockdev as T_dev  # noqa: E402
import repro_torch.fs.ext4like as T_ext4  # noqa: E402
import repro_torch.fs.mounts as T_mounts  # noqa: E402
import repro_torch.fs.xv6 as T_xv6  # noqa: E402
from repro.core.upgrade import upgrade as R_upgrade  # noqa: E402
from repro.kernels.blockhash.ref import blockhash_np  # noqa: E402
from repro_torch.core.registry import mount as T_bento_mount  # noqa: E402
from repro_torch.core.upgrade import upgrade as T_upgrade  # noqa: E402
from repro_torch.fs.posix import PosixView as T_PosixView  # noqa: E402
from repro_torch.kernels.blockhash import ops as T_bh_ops  # noqa: E402

KINDS = ("bento", "vfs", "ext4like", "dedup-bento", "dedup-ext4like")
N_BLOCKS = 4096


def _ref_binding(dev, **kw):
    return R_svc.KernelServices(
        dev, checksum=blockhash_np,
        checksum_batch=lambda blocks: [blockhash_np(b) for b in blocks],
        binding="kernel", **kw)


def _port_binding(dev, **kw):
    return T_svc.kernel_binding(dev, device="cpu", **kw)


REF = types.SimpleNamespace(
    name="repro", iface=R_if, dev=R_dev, xv6=R_xv6, ext4=R_ext4,
    upgrade=R_upgrade, binding=_ref_binding, DirectMount=R_mounts.DirectMount)
PORT = types.SimpleNamespace(
    name="repro_torch", iface=T_if, dev=T_dev, xv6=T_xv6, ext4=T_ext4,
    upgrade=T_upgrade, binding=_port_binding, DirectMount=T_mounts.DirectMount)


@pytest.fixture
def mounts(monkeypatch):
    """``mounts(kind)`` -> (reference mount, port mount), both fresh."""
    monkeypatch.setattr(R_mounts, "kernel_binding", _ref_binding)

    def make(kind, n_blocks=N_BLOCKS):
        return (R_mounts.make_mount(kind, n_blocks),
                T_mounts.make_mount(kind, n_blocks, device="cpu"))
    return make


def _image(dev) -> np.ndarray:
    data = dev._data
    return data.cpu().numpy() if isinstance(data, torch.Tensor) else data


def _norm(x):
    """Package-neutral form of a result: enums by name, dataclasses and
    sequences as tuples."""
    if isinstance(x, enum.Enum):
        return x.name
    if dataclasses.is_dataclass(x):
        return tuple(_norm(getattr(x, f.name))
                     for f in dataclasses.fields(x))
    if isinstance(x, (list, tuple)):
        return tuple(_norm(y) for y in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _norm(v)) for k, v in x.items()))
    return x


# --- the op stream -----------------------------------------------------------------

DIRS = ("/d0", "/d1", "/d0/sub")
FILES = tuple(f"{d}/f{i}" for d in DIRS for i in range(3))


def op_stream(seed: int, n_steps: int = 90):
    """A seeded list of (op, args) covering mkdir, create, write, append,
    read, stat, rename-overwrite, truncate, unlink, fsync, a batch of
    writes through ``Mount.submit`` and a linked create→write→fsync chain.
    Block-sized payloads come from a small pool, so dedup mounts find
    duplicates."""
    rng = np.random.default_rng(seed)
    pool = [rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
            for _ in range(4)]

    def payload():
        nblk = int(rng.integers(1, 5))
        body = b"".join(pool[int(rng.integers(len(pool)))]
                        for _ in range(nblk))
        return body[:len(body) - int(rng.integers(0, 3)) * 1000]

    def path():
        return FILES[int(rng.integers(len(FILES)))]

    ops = [("mkdir", (d,)) for d in DIRS]
    kinds = ["create", "write", "write", "append", "read", "stat", "rename",
             "truncate", "unlink", "fsync", "batch", "chain", "mkdir"]
    for step in range(n_steps):
        op = kinds[int(rng.integers(len(kinds)))]
        if op == "write":
            ops.append((op, (path(), int(rng.integers(0, 3)) * 4096,
                             payload())))
        elif op == "append":
            ops.append((op, (path(), payload()[:1500])))
        elif op == "rename":
            ops.append((op, (path(), path())))
        elif op == "truncate":
            ops.append((op, (path(), int(rng.integers(0, 9000)))))
        elif op == "batch":
            ops.append((op, tuple((path(), int(rng.integers(0, 4)) * 4096,
                                   payload()) for _ in range(4))))
        elif op == "chain":
            ops.append((op, (DIRS[int(rng.integers(len(DIRS)))],
                             f"c{step}", payload())))
        elif op == "mkdir":
            ops.append((op, (f"/d1/m{step}",)))
        else:
            ops.append((op, (path(),)))
    ops.append(("batch", tuple((f, 0, pool[i % len(pool)])
                               for i, f in enumerate(FILES))))
    return ops


def apply(pkg, mf, ops):
    """Run ``ops`` on ``mf``; returns the normalized results and errnos."""
    I = pkg.iface
    v = mf.view
    out = []
    for op, args in ops:
        try:
            if op == "batch":
                entries = []
                for i, (p, off, data) in enumerate(args):
                    try:
                        ino = v.stat(p).ino
                    except I.FsError:
                        ino = v.create(p).ino
                    entries.append(I.SubmissionEntry("write", (ino, off, data),
                                                     user_data=i))
                comps = mf.mount.submit(entries)
                res = [(c.user_data, c.result, c.errno) for c in comps]
            elif op == "chain":
                parent, name, data = args
                comps = mf.mount.submit([
                    I.SubmissionEntry("create", (v.stat(parent).ino, name),
                                      user_data="c", flags=I.SQE_LINK),
                    I.SubmissionEntry("write", (I.PrevResult("ino"), 0, data),
                                      user_data="w", flags=I.SQE_LINK),
                    I.SubmissionEntry("fsync", (I.PrevResult("ino", back=2),),
                                      user_data="s"),
                ])
                res = [(c.user_data, c.result, c.errno) for c in comps]
            elif op == "write":
                res = v.write_file(args[0], args[2], off=args[1])
            elif op == "read":
                res = v.read_file(*args)
            else:
                res = getattr(v, op)(*args)
            out.append(("ok", _norm(res)))
        except I.FsError as e:
            out.append(("err", e.errno.name))
    out.append(("statfs", _norm(v.statfs())))
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_op_stream_matches_reference(mounts, kind):
    ref, port = mounts(kind)
    ops = op_stream(seed=KINDS.index(kind) + 1)
    got_ref = apply(REF, ref, ops)
    got_port = apply(PORT, port, ops)
    assert got_port == got_ref
    assert sum(r[0] == "err" for r in got_ref) > 0  # errnos were exercised
    ks = port.services
    assert ks.counters["checksum_batch_calls"] > 0
    ref.close()
    port.close()
    assert np.array_equal(_image(port.dev), _image(ref.dev))


@pytest.mark.parametrize("kind", KINDS)
def test_shrink_then_grow_matches_reference(mounts, kind):
    """A truncate that shrinks a file, then a grow by truncate and by a
    write past the end: the port gives the reference's bytes, free
    counts and device image (the reference keeps a shrunk file's blocks,
    ROADMAP Queue 3, and the port keeps them alike)."""
    bs = R_xv6.L.BSIZE
    ref, port = mounts(kind)
    got = []
    for mf in (ref, port):
        v = mf.view
        v.write_file("/f", b"A" * bs + b"B" * bs + b"C" * bs)
        full = v.statfs()["free_blocks_est"]
        v.truncate("/f", 6)
        freed = v.statfs()["free_blocks_est"] - full
        v.truncate("/f", 2 * bs + 100)
        grown = v.read_file("/f")
        v.truncate("/f", 3)
        v.write_file("/f", b"z", off=bs + 7, create=False)
        written = v.read_file("/f")
        got.append((freed, grown, written))
    assert got[1] == got[0]
    assert len(got[0][1]) == 2 * bs + 100 and got[0][2][:3] == b"AAA"
    ref.close()
    port.close()
    assert np.array_equal(_image(port.dev), _image(ref.dev))


# --- crash recovery across the packages ------------------------------------------------

_OPTS = dict(group_commit=True, batched_install=True)


def _crash(pkg, mf, point: int, torn: int = -1) -> np.ndarray:
    """Write /f on a mount with a durable /keep, then lose power ``point``
    device writes into the fsync that commits it; returns the image."""
    v = mf.view
    v.write_file("/keep", b"k" * 9000)
    v.fsync("/keep")
    v.write_file("/f", bytes(range(256)) * 48)
    mf.dev.fail_after_writes = point
    mf.dev.fail_torn_bytes = torn
    mf.dev._writes_seen = 0
    with pytest.raises(pkg.dev.BlockDeviceError):
        v.fsync("/f")
    return _image(mf.dev).copy()


def _recover(pkg, image: np.ndarray):
    """Cold-mount ``image`` in ``pkg`` (init runs journal recovery);
    returns the recovered image and a direct mount of the file system."""
    if pkg is PORT:
        dev = T_dev.MemBlockDevice.from_image(image)
    else:
        dev = R_dev.MemBlockDevice(image.shape[0], image.shape[1])
        dev._data = image.copy()
    ks = pkg.binding(dev)
    fs = pkg.xv6.Xv6FileSystem(pkg.xv6.Xv6Options(**_OPTS))
    fs.init(ks.superblock(), ks)
    return _image(dev).copy(), pkg.DirectMount(fs)


def _header_write_index(mf) -> int:
    """Index, among the device writes of the fsync that commits /f, of the
    journal commit record (the header write that carries the magic)."""
    v = mf.view
    v.write_file("/keep", b"k" * 9000)
    v.fsync("/keep")
    v.write_file("/f", bytes(range(256)) * 48)
    logstart = mf.mount.module.geo.logstart
    seen = []
    orig = mf.dev.write_block

    def spy(blockno, data):
        seen.append((blockno, any(data[:4])))
        orig(blockno, data)

    mf.dev.write_block = spy
    v.fsync("/f")
    return seen.index((logstart, True))


@pytest.mark.parametrize("case", ["after_commit_record", "torn_commit_record"])
def test_crash_images_recover_alike(mounts, case):
    ref0, port0 = mounts("bento", 2048)
    hdr = _header_write_index(port0)
    assert hdr == _header_write_index(ref0)
    assert hdr >= 2  # the commit journals several blocks
    ref, port = mounts("bento", 2048)
    if case == "after_commit_record":
        point, torn = hdr + 1, -1
    else:  # the commit record lands torn: magic and count, first entry only
        point, torn = hdr, 20
    img_ref = _crash(REF, ref, point, torn)
    img_port = _crash(PORT, port, point, torn)
    assert np.array_equal(img_port, img_ref)

    results = {}
    for img_from, img in (("ref", img_ref), ("port", img_port)):
        for pkg in (REF, PORT):
            results[img_from, pkg.name] = _recover(pkg, img)
    images = [r[0] for r in results.values()]
    for other in images[1:]:
        assert np.array_equal(other, images[0])
    installed = np.flatnonzero((images[0] != img_port).any(axis=1))
    if case == "after_commit_record":
        assert len(installed) > 2  # the committed blocks were installed
        for (_src, name), (_img, m) in results.items():
            pkg = PORT if name == "repro_torch" else REF
            ino = m.lookup(pkg.iface.ROOT_INO, "f").ino
            assert m.read(ino, 0, 1 << 14) == bytes(range(256)) * 48
    else:
        assert len(installed) == 0  # a torn commit record is discarded


# --- the launch contract, the upgrade, the device -------------------------------------


def test_one_checksum_batch_per_flushed_batch(monkeypatch):
    mf = T_mounts.make_mount("bento", 4096, device="cpu")
    v, ks = mf.view, mf.services
    v.write_file("/f", b"z" * (64 * 4096))
    v.fsync("/f")
    dispatches = []
    real = T_bh_ops.blockhash_batch

    def counting(words, pows):
        dispatches.append(words.shape)
        return real(words, pows)

    monkeypatch.setattr(T_bh_ops, "blockhash_batch", counting)
    for _ in range(3):
        c0, d0 = ks.counters["checksum_batch_calls"], len(dispatches)
        v.write_many([("/f", i * 4096, b"w" * 4096) for i in range(8)],
                     create=False, fsync=True)
        assert ks.counters["checksum_batch_calls"] - c0 == 1
        assert len(dispatches) - d0 == 1
    mf.close()


def test_online_upgrade_keeps_data_and_binding(mounts):
    ref, port = mounts("bento")
    for pkg, mf in ((REF, ref), (PORT, port)):
        v = mf.view
        v.makedirs("/ckpt")
        v.write_file("/ckpt/a", b"A" * 10000)
        v.fsync("/ckpt/a")
        ks = mf.services
        pkg.upgrade(mf.mount, pkg.ext4.Ext4LikeFileSystem(),
                    migrate=lambda s, o, n: {**s, "dirindex": {}})
        assert type(mf.mount.module).__name__ == "Ext4LikeFileSystem"
        assert mf.mount.module.ks is ks and ks.binding == "kernel"
        assert v.read_file("/ckpt/a") == b"A" * 10000
        c0 = ks.counters["checksum_batch_calls"]
        v.write_file("/ckpt/b", b"B" * 5000)
        v.fsync("/ckpt/b")
        assert ks.counters["checksum_batch_calls"] > c0
        assert v.listdir("/ckpt") == ["a", "b"]
    ref.close()
    port.close()
    assert np.array_equal(_image(port.dev), _image(ref.dev))


def _xv6_on(dev):
    ks = T_svc.kernel_binding(dev, device="cpu")
    T_xv6.mkfs(ks)
    fs = T_xv6.Xv6FileSystem(T_xv6.Xv6Options(**_OPTS))
    m = T_bento_mount("xv6", ks, module=fs)
    return m, T_PosixView(m)


def test_torch_block_device_matches_mem_device():
    images = []
    for dev in (T_dev.TorchBlockDevice(1024, device="cpu"),
                T_dev.MemBlockDevice(1024)):
        m, v = _xv6_on(dev)
        v.makedirs("/srv")
        for i in range(6):
            v.write_file(f"/srv/file{i % 4}", bytes([i]) * 20000)
            v.append(f"/srv/file{i % 4}", b"tail" * 256)
            assert v.read_file(f"/srv/file{i % 4}")[:3] == bytes([i]) * 3
        v.unlink("/srv/file0")
        v.fsync("/srv")
        m.unmount()
        images.append(_image(dev))
    assert images[0].dtype == np.uint8
    assert np.array_equal(images[0], images[1])
    round_trip = T_dev.TorchBlockDevice.from_image(images[1], device="cpu")
    assert np.array_equal(_image(round_trip), images[1])


def test_torch_block_device_counts_under_threads():
    """The parallel drain and the SQPOLL thread share one device: the
    in-place image and its read/write counters survive many threads."""
    dev = T_dev.TorchBlockDevice(64, device="cpu")
    n_threads, rounds = 16, 200
    errors = []
    start = threading.Barrier(n_threads)

    def worker(t):
        try:
            start.wait(timeout=60)
            for r in range(rounds):
                blk = (t * 4 + r) % 64
                dev.write_block(blk, bytes([t]) * dev.block_size)
                dev.read_block(blk)
        except Exception as e:  # reported by the assertion below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads) and errors == []
    assert dev.reads == dev.writes == n_threads * rounds
    for blk in range(64):  # every block holds one thread's whole write
        assert len(set(dev.read_block(blk))) == 1


def test_default_device_is_cuda_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T_mounts.make_mount("bento")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T_bh_ops.checksum(b"probe")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T_dev.TorchBlockDevice(8)


@pytest.mark.parametrize("kind", ["fuse", "overlay-bento",
                                  "overlay-ext4like", "nope"])
def test_every_reference_kind_mounts(kind):
    """The port mounts every kind of ``repro.fs.mounts`` on the CPU (the
    fuse daemon needs no device), plain and under the provenance layer;
    an unknown kind still raises ``KeyError``."""
    assert set(T_mounts.ALL_KINDS + T_mounts.DEDUP_KINDS
               + T_mounts.OVERLAY_KINDS) == set(
        R_mounts.ALL_KINDS + R_mounts.DEDUP_KINDS + R_mounts.OVERLAY_KINDS)
    if kind == "nope":
        with pytest.raises(KeyError):
            T_mounts.make_mount(kind, 1024, device="cpu")
        return
    for prov in (False, True):
        mf = T_mounts.make_mount(kind, 1024, device="cpu", prov=prov)
        try:
            module = (mf.mount.ctl("stats")["module"] if kind == "fuse"
                      else type(mf.mount.module).__name__)
            assert (module == "ProvFilesystem") == prov
            mf.view.write_file("/f", b"x" * 5000)
            assert mf.view.read_file("/f") == b"x" * 5000
            if prov:
                assert mf.view.read_provenance()[-1]["op"] == "write"
        finally:
            mf.close()
