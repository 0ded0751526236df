"""The port's crash simulator against the reference's, on the CPU.

Each torture runs quick on the port (``device="cpu"``) and on the
reference, which is bound to the port's blockhash at each of its binding
sites: both must sweep the same number of crash points, and every
point's invariant must hold in the port. For the chain and provenance
workloads each crash point's recovered image must be byte-identical
across the packages (provenance timestamps pinned).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.services as R_svc  # noqa: E402
import repro.fs.crashsim as R_cs  # noqa: E402
import repro.fs.mounts as R_mounts  # noqa: E402
import repro_torch.core.services as T_svc  # noqa: E402
import repro_torch.fs.crashsim as T_cs  # noqa: E402
from test_torch_fs_slice import _ref_binding  # noqa: E402


@pytest.fixture
def bound(monkeypatch):
    for mod in (R_svc, R_mounts, R_cs):
        monkeypatch.setattr(mod, "kernel_binding", _ref_binding)
    for svc in (R_svc, T_svc):
        monkeypatch.setattr(svc.KernelServices, "time", lambda self: 1.7e9)


@pytest.mark.parametrize("name,kw", [
    ("torture_chain", {}), ("torture_rename", {}), ("torture_prov", {}),
    ("torture_prov_chain", {}), ("torture_dedup", {}),
    ("torture_lazy", {}), ("torture_overlay", {}),
    ("torture_parallel", {}), ("torture_parallel", {"dedup": True}),
    ("torture_ckpt_shards", {})])
def test_torture_sweeps_as_many_points_as_reference(bound, name, kw):
    got = getattr(T_cs, name)("xv6", quick=True, device="cpu", **kw)
    want = getattr(R_cs, name)("xv6", quick=True, **kw)
    assert got == want and got > 5


def test_fuse_torture_sweeps_as_many_points_as_reference():
    """Through the daemons: power loss injected in the file-backed device,
    the daemon killed, the image remounted by a fresh daemon."""
    got = T_cs.torture_fuse(quick=True)
    assert got == R_cs.torture_fuse(quick=True) and got > 5


def _sweep_images(cs, sim, workload, setup):
    total = sim.measure(workload, setup=setup)
    out = []
    for point in cs.quick_points(total):
        rec = sim.run_one(workload, point, total=total, setup=setup)
        out.append((point, rec.crashed, rec.dev._data.copy()))
    return total, out


def _prov_workload(ctx):
    v = ctx.view
    v.create("/a")
    v.write_file("/a", b"W" * 5000, create=False)
    v.fsync("/a")
    v.mkdir("/d")
    v.rename("/a", "/d/a")
    v.fsync("/d")


@pytest.mark.parametrize("workload", ["chain", "prov"])
def test_recovered_images_match_reference_at_every_point(bound, workload):
    from repro.fs.prov import ProvFilesystem as R_Prov
    from repro.fs.xv6 import Xv6FileSystem as R_Xv6, Xv6Options as R_Opts
    from repro_torch.fs.prov import ProvFilesystem as T_Prov
    from repro_torch.fs.xv6 import Xv6FileSystem as T_Xv6, \
        Xv6Options as T_Opts

    if workload == "chain":
        payload = b"C" * (2 * 4096 + 17)
        ref_sim = R_cs.CrashSim(lambda: R_Xv6(R_Opts()))
        port_sim = T_cs.CrashSim(lambda: T_Xv6(T_Opts()), device="cpu")
        runs = ((R_cs, ref_sim, R_cs.chain_workload(payload), None),
                (T_cs, port_sim, T_cs.chain_workload(payload), None))
    else:
        def setup(ctx):
            ctx.view.write_file("/seed", b"s" * 4096)
        ref_sim = R_cs.CrashSim(lambda: R_Prov(R_Xv6(R_Opts())))
        port_sim = T_cs.CrashSim(lambda: T_Prov(T_Xv6(T_Opts())),
                                 device="cpu")
        runs = ((R_cs, ref_sim, _prov_workload, setup),
                (T_cs, port_sim, _prov_workload, setup))
    (ref_total, ref_pts), (port_total, port_pts) = [
        _sweep_images(*run) for run in runs]
    assert port_total == ref_total
    assert len(port_pts) == len(ref_pts) > 5
    assert any(c for _, c, _ in port_pts) and not port_pts[-1][1]
    for (p, c, img), (rp, rc, rimg) in zip(port_pts, ref_pts):
        assert (p, c) == (rp, rc)
        assert np.array_equal(img, rimg), f"crash point {p}/{port_total}"


def _recorded_sweep(monkeypatch, cs, run):
    """``run()`` with ``cs.CrashSim.run_one`` recording each point's
    (crash point, crashed, recovered image); returns (points, records)."""
    seen = []
    real = cs.CrashSim.run_one

    def run_one(self, *args, **kw):
        rec = real(self, *args, **kw)
        seen.append((rec.crash_point, rec.crashed, _image_of(rec.dev)))
        return rec

    monkeypatch.setattr(cs.CrashSim, "run_one", run_one)
    points = run()
    monkeypatch.setattr(cs.CrashSim, "run_one", real)
    return points, seen


def _image_of(dev) -> np.ndarray:
    data = dev._data
    return (data.cpu().numpy() if isinstance(data, torch.Tensor)
            else data).copy()


def test_ckpt_shards_recover_to_reference_images(bound, monkeypatch):
    """The sharded-checkpoint re-save swept quick on xv6: the same crash
    points, the same crashed/not verdicts and, at every point, the same
    recovered image as the reference (manifests, shard files and their
    checksums byte for byte)."""
    got = _recorded_sweep(monkeypatch, T_cs, lambda: T_cs.torture_ckpt_shards(
        "xv6", quick=True, device="cpu"))
    want = _recorded_sweep(monkeypatch, R_cs, lambda: R_cs.torture_ckpt_shards(
        "xv6", quick=True))
    assert got[0] == want[0] == len(got[1]) == len(want[1]) > 5
    assert any(c for _, c, _ in got[1])
    for (p, c, img), (rp, rc, rimg) in zip(got[1], want[1]):
        assert (p, c) == (rp, rc)
        assert np.array_equal(img, rimg), f"crash point {p}"
