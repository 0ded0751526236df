"""The port's checkpoint store against the reference's, on the CPU.

Trees of float32, bfloat16 and 0-d leaves, made from a numpy seed, go
through ``repro.checkpoint`` (jax arrays) and ``repro_torch.checkpoint``
(torch tensors, ``device="cpu"``) on bento mounts whose kernel binding
hashes with the same blockhash (the reference's ``kernel_binding`` is
swapped for ``blockhash_np``, as in ``test_torch_fs_slice.py``). A
checkpoint written by either package restores in the other bit for bit,
the two packages write the same manifest and the same device image, and
the reference's own store cases give the port the same results and the
same error messages. Tolerance: exact everywhere.
"""

from __future__ import annotations

import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

import repro.fs.blockdev as R_dev  # noqa: E402
import repro.fs.mounts as R_mounts  # noqa: E402
import repro.fs.xv6 as R_xv6  # noqa: E402
import repro_torch.core.services as T_svc  # noqa: E402
import repro_torch.fs.blockdev as T_dev  # noqa: E402
import repro_torch.fs.mounts as T_mounts  # noqa: E402
import repro_torch.fs.xv6 as T_xv6  # noqa: E402
from repro import checkpoint as R_ck  # noqa: E402
from repro.checkpoint import store as R_store  # noqa: E402
from repro.core.registry import mount as R_bento_mount  # noqa: E402
from repro.distributed.resharding import ShardGrid as R_Grid  # noqa: E402
from repro.fs.posix import PosixView as R_PosixView  # noqa: E402
from repro_torch import checkpoint as T_ck  # noqa: E402
from repro_torch.checkpoint import store as T_store  # noqa: E402
from repro_torch.core.registry import mount as T_bento_mount  # noqa: E402
from repro_torch.distributed.resharding import ShardGrid as T_Grid  # noqa: E402
from repro_torch.fs.posix import PosixView as T_PosixView  # noqa: E402
from test_torch_fs_slice import _image, _ref_binding  # noqa: E402

N_BLOCKS = 4096


@pytest.fixture(autouse=True)
def bound(monkeypatch):
    monkeypatch.setattr(R_mounts, "kernel_binding", _ref_binding)


# --- the same trees in both packages ----------------------------------------


def _source(seed: int = 11):
    """numpy sources: float32 arrays, bfloat16 as uint16 bits, a 0-d."""
    rng = np.random.default_rng(seed)

    def bf16(shape):
        return rng.normal(size=shape).astype(np.float32) \
            .astype(ml_dtypes.bfloat16).view(np.uint16)
    return {
        "w": rng.normal(size=(8, 6)).astype(np.float32),
        "b": bf16((12,)),
        "s": np.float32(2.5),
        "blocks": [{"k": rng.normal(size=(4, 4)).astype(np.float32)},
                   {"k": bf16((2, 3))}],
        "pair": (np.arange(5, dtype=np.int32), bf16((3,))),
    }


_BF16 = {("b",), ("blocks", 1, "k"), ("pair", 1)}


def _map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def _ref_tree(src):
    return _map(lambda p, a: jnp.asarray(
        a.view(ml_dtypes.bfloat16) if p in _BF16 else a), src)


def _port_tree(src):
    def conv(p, a):
        a = np.array(a)
        if p in _BF16:
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(a)
    return _map(conv, src)


def _grids(G):
    return {"w": G.from_spec((8, 6), ("d", "m"), {"d": 2, "m": 3}),
            "b": G.from_spec((12,), ("d",), {"d": 2}),
            "s": None,
            "blocks": [{"k": G.from_spec((4, 4), ("d",), {"d": 2})},
                       {"k": None}],
            "pair": (G.from_spec((5,), ("d",), {"d": 3}), None)}


def _bits(x) -> np.ndarray:
    """A restored leaf of either package as numpy, bfloat16 as its bits."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(jax.device_get(x))
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _assert_tree_bits(got, src):
    got_l = jax.tree.leaves(_map(lambda p, x: _bits(x), got))
    want = jax.tree.leaves(src)
    assert len(got_l) == len(want)
    for g, w in zip(got_l, want):
        assert g.dtype == np.asarray(w).dtype and g.shape == np.shape(w)
        assert np.array_equal(g, w)


_OPTS = dict(group_commit=True, batched_install=True)


def _ref_view_of(image):
    dev = R_dev.MemBlockDevice(image.shape[0], image.shape[1])
    dev._data = image.copy()
    ks = _ref_binding(dev)
    fs = R_xv6.Xv6FileSystem(R_xv6.Xv6Options(**_OPTS))
    return R_PosixView(R_bento_mount("xv6", ks, module=fs)), ks


def _port_view_of(image):
    dev = T_dev.MemBlockDevice.from_image(image)
    ks = T_svc.kernel_binding(dev, device="cpu")
    fs = T_xv6.Xv6FileSystem(T_xv6.Xv6Options(**_OPTS))
    return T_PosixView(T_bento_mount("xv6", ks, module=fs)), ks


def _mounts():
    return (R_mounts.make_mount("bento", N_BLOCKS),
            T_mounts.make_mount("bento", N_BLOCKS, device="cpu"))


# --- the tree structure the manifest records --------------------------------


@pytest.mark.parametrize("tree", [
    {"b": 1, "a": 2}, [1, (2, 3)], (1,), 1, None, {"a": None, "b": 1},
    {}, [], (), {"x": {"y": [1, None]}}, {1: 1, 2: [3]},
    {"stack": {"wk": 1, "ln": (2, 3)}, "embed": [4]}])
def test_treedef_text_and_leaf_order_match_reference(tree):
    leaves, td = T_store._flatten(tree)
    want_leaves, want_td = jax.tree.flatten(tree)
    assert str(td) == str(want_td)
    assert leaves == want_leaves
    assert td.unflatten(leaves) == jax.tree.unflatten(want_td, leaves)
    shardings = T_store._flatten_shardings(tree)
    assert shardings == jax.tree.flatten(tree, is_leaf=lambda v: v is None)[0]


# --- the format contract, both directions ------------------------------------


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_reference_checkpoint_restores_in_port(depth):
    src = _source()
    ref, _ = _mounts()
    R_ck.save(ref.view, "/ck/s1", _ref_tree(src), step=1,
              checksum=ref.services.checksum, shardings=_grids(R_Grid))
    ref.close()
    view, ks = _port_view_of(_image(ref.dev))
    got, man = T_ck.load(view, "/ck/s1", _port_tree(src),
                         checksum=ks.checksum,
                         checksum_batch=ks.checksum_batch,
                         pipeline_depth=depth, device="cpu")
    _assert_tree_bits(got, src)
    assert man["version"] == 2


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_port_checkpoint_restores_in_reference(depth):
    src = _source()
    _, port = _mounts()
    T_ck.save(port.view, "/ck/s1", _port_tree(src), step=1,
              checksum=port.services.checksum, shardings=_grids(T_Grid))
    port.close()
    view, ks = _ref_view_of(_image(port.dev))
    got, _ = R_ck.load(view, "/ck/s1", _ref_tree(src),
                       checksum=ks.checksum, checksum_batch=ks.checksum_batch,
                       pipeline_depth=depth)
    _assert_tree_bits(got, src)


def test_same_tree_gives_same_manifests_and_device_image():
    """A save and a re-save (generation 1) of the same tree: identical
    manifests, shard names and device images."""
    src = _source()
    ref, port = _mounts()
    mans = []
    for step in (1, 2):
        a = R_ck.save(ref.view, "/ck/s", _ref_tree(src), step=step,
                      checksum=ref.services.checksum,
                      shardings=_grids(R_Grid))
        b = T_ck.save(port.view, "/ck/s", _port_tree(src), step=step,
                      checksum=port.services.checksum,
                      shardings=_grids(T_Grid))
        assert a == b
        mans.append(b)
    assert mans[1]["gen"] == 1
    assert sorted(ref.view.listdir("/ck/s")) == sorted(port.view.listdir("/ck/s"))
    ref.close()
    port.close()
    assert np.array_equal(_image(port.dev), _image(ref.dev))


def test_npy_header_bytes_match_reference():
    src = _source()
    for name, r, t in [("f32", src["w"], torch.from_numpy(src["w"])),
                       ("bf16", src["b"].view(ml_dtypes.bfloat16),
                        _port_tree(src)["b"]),
                       ("0-d", src["s"], torch.tensor(2.5))]:
        want = R_store._serialize(np.asarray(r))
        got = T_store._serialize(T_store._host_wire(t))
        assert got == want, name


# --- the reference's own cases, held against the reference ------------------


def _both_raise(exc, ref_call, port_call):
    with pytest.raises(exc) as r:
        ref_call()
    with pytest.raises(exc) as t:
        port_call()
    assert str(t.value) == str(r.value)
    return str(t.value)


def test_corrupted_shard_names_the_exact_file_in_both():
    src = _source()
    ref, port = _mounts()
    for mf, ck, tree, G in ((ref, R_ck, _ref_tree(src), R_Grid),
                            (port, T_ck, _port_tree(src), T_Grid)):
        man = ck.save(mf.view, "/ck/s1", tree, step=1,
                      checksum=mf.services.checksum, shardings=_grids(G))
        victim = man["leaves"][6]["shards"][3]["path"]
        raw = bytearray(mf.view.read_file(victim))
        raw[-1] ^= 0xFF
        mf.view.write_file(victim, bytes(raw), off=0, create=False)
    for depth in (0, 1, 2):
        msg = _both_raise(
            IOError,
            lambda: R_ck.load(ref.view, "/ck/s1", _ref_tree(src),
                              checksum=ref.services.checksum,
                              pipeline_depth=depth),
            lambda: T_ck.load(port.view, "/ck/s1", _port_tree(src),
                              checksum=port.services.checksum,
                              pipeline_depth=depth, device="cpu"))
        assert msg == f"checksum mismatch in shard {victim}"


def _rewrite_manifest(mf, path, edit):
    man = json.loads(mf.view.read_file(path))
    edit(man)
    raw = json.dumps(man).encode()
    old_len = mf.view.stat(path).size
    mf.view.write_file(path, raw + b" " * (old_len - len(raw)), off=0,
                       create=False)


def test_missing_shard_record_fails_as_incomplete_in_both():
    src = _source()
    ref, port = _mounts()
    R_ck.save(ref.view, "/ck/s1", _ref_tree(src), step=1,
              shardings=_grids(R_Grid))
    T_ck.save(port.view, "/ck/s1", _port_tree(src), step=1,
              shardings=_grids(T_Grid))
    for mf in (ref, port):
        _rewrite_manifest(mf, "/ck/s1/manifest.json",
                          lambda m: m["leaves"][6]["shards"].pop())
    for depth in (0, 2):
        msg = _both_raise(
            IOError,
            lambda: R_ck.load(ref.view, "/ck/s1", _ref_tree(src),
                              pipeline_depth=depth),
            lambda: T_ck.load(port.view, "/ck/s1", _port_tree(src),
                              pipeline_depth=depth, device="cpu"))
        assert "incomplete checkpoint" in msg


def test_records_without_data_off_load_whole_files():
    src = _source()
    _, port = _mounts()
    T_ck.save(port.view, "/ck/s1", _port_tree(src), step=1,
              shardings=_grids(T_Grid))

    def drop(man):
        for rec in man["leaves"]:
            for s in rec["shards"]:
                s.pop("data_off", None)
    _rewrite_manifest(port, "/ck/s1/manifest.json", drop)
    for depth in (0, 1, 2):
        got, _ = T_ck.load(port.view, "/ck/s1", _port_tree(src),
                           pipeline_depth=depth, device="cpu")
        _assert_tree_bits(got, src)


def test_v1_manifest_loads_and_resaves_as_reference():
    """A hand-written v1 checkpoint (whole-leaf files, bf16 as its uint16
    wire view) loads as a 1-shard grid; the v2 re-save over it probes
    past the v1 names, with the same manifest as the reference's."""
    w = np.arange(24, dtype=np.float32).reshape(4, 6)
    b16 = np.arange(5, dtype=np.float32).astype(ml_dtypes.bfloat16)
    ref, port = _mounts()
    for mf in (ref, port):
        cks = mf.services.checksum
        mf.view.makedirs("/ck/step_1")
        leaves = []
        for i, (arr, dtype_s) in enumerate([(b16, "bfloat16"),
                                            (w, "float32")]):
            buf = io.BytesIO()
            np.save(buf, arr.view(np.uint16) if dtype_s == "bfloat16"
                    else arr)
            raw = buf.getvalue()
            path = f"/ck/step_1/leaf_{i:05d}.npy"
            mf.view.write_file(path, raw)
            leaves.append({"path": path, "shape": list(arr.shape),
                           "dtype": dtype_s, "checksum": cks(raw)})
        manifest = {"step": 1, "gen": 0,
                    "treedef": "PyTreeDef({'b': *, 'w': *})",
                    "n_leaves": 2, "leaves": leaves, "extra": {}}
        mf.view.write_file("/ck/step_1/manifest.json",
                           json.dumps(manifest).encode())
    like = {"b": torch.zeros(5, dtype=torch.bfloat16),
            "w": torch.zeros(4, 6)}
    stats = {}
    got, _ = T_ck.load(port.view, "/ck/step_1", like,
                       checksum=port.services.checksum, stats=stats,
                       device="cpu")
    assert stats["version"] == 1
    assert np.array_equal(got["w"].numpy(), w)
    assert np.array_equal(_bits(got["b"]), b16.view(np.uint16))
    assert T_ck.latest_step(port.view, "/ck") == 1
    rlike = {"b": jnp.zeros((5,), jnp.bfloat16), "w": jnp.zeros((4, 6))}
    want = R_ck.save(ref.view, "/ck/step_1", rlike, step=1,
                     checksum=ref.services.checksum)
    man2 = T_ck.save(port.view, "/ck/step_1", like, step=1,
                     checksum=port.services.checksum)
    assert man2 == want and man2["gen"] >= 1 and man2["version"] == 2


def test_generation_discipline_matches_reference():
    src = _source()
    ref, port = _mounts()
    for mf, ck, tree, G in ((ref, R_ck, _ref_tree(src), R_Grid),
                            (port, T_ck, _port_tree(src), T_Grid)):
        ck.save(mf.view, "/ck/s", tree, step=0, shardings=_grids(G))
        man = ck.save(mf.view, "/ck/s", tree, step=0, shardings=_grids(G))
        assert man["gen"] == 1
    names = sorted(n for n in port.view.listdir("/ck/s")
                   if n.startswith("leaf_"))
    assert names == sorted(n for n in ref.view.listdir("/ck/s")
                           if n.startswith("leaf_"))
    assert len(names) == 16 and all(n.endswith("_g1.npy") for n in names)


@pytest.mark.parametrize("case", ["treedef", "dtype", "shape", "count"])
def test_incompatible_trees_fail_with_the_reference_messages(case):
    ref, port = _mounts()
    saved = {"a": np.zeros((3, 2), np.float32), "b": np.ones(4, np.float32)}
    like = {
        "treedef": {"a": np.zeros((3, 2), np.float32),
                    "c": np.ones(4, np.float32)},
        "dtype": {"a": np.zeros((3, 2), np.float32),
                  "b": np.ones(4, np.int32)},
        "shape": {"a": np.zeros((2, 3), np.float32),
                  "b": np.ones(4, np.float32)},
        "count": {"a": np.zeros((3, 2), np.float32)},
    }[case]
    R_ck.save(ref.view, "/ck/s", saved, step=0)
    T_ck.save(port.view, "/ck/s", {k: torch.from_numpy(v)
                                   for k, v in saved.items()}, step=0)
    port_like = {k: torch.from_numpy(v) for k, v in like.items()}
    _both_raise(ValueError, lambda: R_ck.load(ref.view, "/ck/s", like),
                lambda: T_ck.load(port.view, "/ck/s", port_like,
                                  device="cpu"))


# --- uneven targets, peaks, the pipeline --------------------------------------


def _strip(stats):
    return [dict(s) for s in stats["leaves"]]


def _plan(stats):
    return [{k: v for k, v in s.items() if k != "peak_bytes"}
            for s in stats["leaves"]]


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_uneven_grid_targets_restore_as_reference(depth):
    src = _source()
    ref, port = _mounts()

    def targets(G):
        t = _grids(G)
        t["w"] = G.from_spec((8, 6), ("d", None), {"d": 3})  # 3,3,2
        t["b"] = G.from_spec((12,), ("d",), {"d": 5})  # 3,3,3,3,<empty>
        t["pair"] = (G.from_spec((5,), ("d",), {"d": 4}), None)
        return t
    R_ck.save(ref.view, "/ck/u", _ref_tree(src), step=1,
              checksum=ref.services.checksum, shardings=_grids(R_Grid))
    T_ck.save(port.view, "/ck/u", _port_tree(src), step=1,
              checksum=port.services.checksum, shardings=_grids(T_Grid))
    rs, ts = {}, {}
    R_ck.load(ref.view, "/ck/u", _ref_tree(src),
              checksum=ref.services.checksum, sharding_tree=targets(R_Grid),
              stats=rs, pipeline_depth=depth)
    got, _ = T_ck.load(port.view, "/ck/u", _port_tree(src),
                       checksum=port.services.checksum,
                       sharding_tree=targets(T_Grid), stats=ts,
                       pipeline_depth=depth, device="cpu")
    _assert_tree_bits(got, src)
    assert _strip(ts) == _strip(rs)
    by_leaf = {s["leaf"]: s for s in ts["leaves"]}
    assert by_leaf[0]["n_target_groups"] == 4  # b: the empty cell drops
    assert by_leaf[6]["n_target_groups"] == 3  # w: 3, 3, 2


def _overlap_source():
    rng = np.random.default_rng(7)
    return {"w": rng.normal(size=(64, 48)).astype(np.float32),
            "b": rng.normal(size=(4096,)).astype(np.float32),
            "s": np.float32(1.25)}


def _overlap_grids(G):
    return {"w": G.from_spec((64, 48), ("d", "m"), {"d": 2, "m": 3}),
            "b": G.from_spec((4096,), ("d",), {"d": 4}), "s": None}


def test_peak_accounting_matches_reference_at_every_depth():
    """Per-leaf target groups, stream flags and byte counts equal the
    reference's at depths 0, 1, 2 and 4, and so do the metered host
    peaks of the engines without a prefetch thread (depths 0 and 1); a
    prefetching restore's peak depends on how far its thread runs ahead,
    so there each depth's peak is held within depth x the serial
    engine's, as the reference holds its own."""
    src = _overlap_source()
    ref, port = _mounts()
    R_ck.save(ref.view, "/ck/ov", {k: jnp.asarray(v) for k, v in src.items()},
              step=1, checksum=ref.services.checksum,
              shardings=_overlap_grids(R_Grid))
    tree = {k: torch.from_numpy(np.array(v)) for k, v in src.items()}
    T_ck.save(port.view, "/ck/ov", tree, step=1,
              checksum=port.services.checksum,
              shardings=_overlap_grids(T_Grid))
    serial = None
    for depth in (0, 1, 2, 4):
        rs, ts = {}, {}
        R_ck.load(ref.view, "/ck/ov", src, checksum=ref.services.checksum,
                  checksum_batch=ref.services.checksum_batch, stats=rs,
                  pipeline_depth=depth)
        got, _ = T_ck.load(port.view, "/ck/ov", tree,
                           checksum=port.services.checksum,
                           checksum_batch=port.services.checksum_batch,
                           stats=ts, pipeline_depth=depth, device="cpu")
        for k in src:
            assert np.array_equal(got[k].numpy(), src[k])
        if depth <= 1:
            assert _strip(ts) == _strip(rs), depth
        assert _plan(ts) == _plan(rs), depth
        assert ts["pipeline"]["depth"] == depth
        if depth == 0:
            serial = {s["leaf"]: s["peak_bytes"] for s in ts["leaves"]}
        for s in ts["leaves"]:
            if s["streamed"]:
                assert s["peak_bytes"] <= max(1, depth) * serial[s["leaf"]]


def test_failed_restore_writes_nothing(monkeypatch):
    """A checksum failure mid-pipelined-restore, prefetches in flight,
    raises the serial engine's error and makes no device write."""
    monkeypatch.setattr(T_store, "_INLINE_BYTES", 0)
    src = _source()
    _, port = _mounts()
    cks, cks_b = port.services.checksum, port.services.checksum_batch
    man = T_ck.save(port.view, "/ck/cr", _port_tree(src), step=1,
                    checksum=cks, shardings=_grids(T_Grid))
    victim = man["leaves"][6]["shards"][0]["path"]
    raw = bytearray(port.view.read_file(victim))
    raw[-1] ^= 0xFF
    port.view.write_file(victim, bytes(raw), off=0, create=False)
    port.view.fsync(victim)
    w0 = port.dev.writes
    for depth in (0, 2, 4):
        with pytest.raises(IOError, match=f"checksum mismatch in shard "
                                          f"{victim}"):
            T_ck.load(port.view, "/ck/cr", _port_tree(src), checksum=cks,
                      checksum_batch=cks_b, pipeline_depth=depth,
                      device="cpu")
    assert port.dev.writes == w0


def test_pipeline_depth_env_default(monkeypatch):
    assert T_store._DEPTH_ENV == R_store._DEPTH_ENV
    monkeypatch.setenv(T_store._DEPTH_ENV, "3")
    assert T_store._resolve_depth(None) == 3
    assert T_store._resolve_depth(0) == 0
    monkeypatch.delenv(T_store._DEPTH_ENV)
    assert T_store._resolve_depth(None) == T_store._DEFAULT_DEPTH == 2
    assert T_store._resolve_depth(-5) == 0


def test_load_defaults_to_cuda_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    _, port = _mounts()
    T_ck.save(port.view, "/ck/s", {"a": torch.zeros(3)}, step=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T_ck.load(port.view, "/ck/s", {"a": torch.zeros(3)})


# --- MeshArray leaves (a trainer partitioned over its mesh) -----------------------------


def test_mesh_array_leaves_save_and_restore_as_whole_leaves():
    """A tree of ``MeshArray``s over a virtual (2, 2) CPU mesh saves the
    same files as its whole tensors at the same grids (a MeshSharding,
    the leaf's own; a ShardGrid no position holds whole; one shard), and
    a restore onto a (4, 1) mesh fills each position's own tensor with
    its slice, from multi-shard and single-shard sources alike."""
    from repro_torch.distributed.sharding import MeshArray, MeshSharding, place
    from repro_torch.launch.mesh import make_elastic_mesh

    cpu = torch.device("cpu")
    src = _source()
    whole = {"w": torch.from_numpy(src["w"]),
             "b": torch.from_numpy(src["b"].view(np.int16)).view(torch.bfloat16),
             "s": torch.tensor(2.5)}
    mesh = make_elastic_mesh(2, 2, devices=[cpu] * 4)
    own = {"w": MeshSharding(mesh, ("data", "model")),
           "b": MeshSharding(mesh, ("model",)), "s": MeshSharding(mesh, ())}
    cells = {k: place(v, own[k]) for k, v in whole.items()}
    for grids in (own, {"w": T_Grid.from_spec(tuple(whole["w"].shape),
                                              ("x", "y"), {"x": 4, "y": 1}),
                        "b": own["b"], "s": None}):
        mfs = [T_mounts.make_mount("bento", N_BLOCKS, device="cpu")
               for _ in range(2)]
        for mf, tree in zip(mfs, (cells, whole)):
            T_ck.save(mf.view, "/ck/s1", tree, step=1, shardings=grids)
        a, b = (_image(mf.dev) for mf in mfs)
        assert np.array_equal(a, b)
    target = make_elastic_mesh(4, 1, devices=[cpu] * 4)
    sh = {"w": MeshSharding(target, ("data", "model")),
          "b": MeshSharding(target, ("data",)), "s": MeshSharding(target, ())}
    back, _ = T_ck.load(mfs[1].view, "/ck/s1", whole, sharding_tree=sh,
                        device="cpu")
    for k, v in whole.items():
        assert isinstance(back[k], MeshArray) and back[k].sharding == sh[k]
        for _pos, idx, t in back[k].addressable_shards:
            assert torch.equal(t, v[idx]), k
        assert torch.equal(back[k].gather(), v)
