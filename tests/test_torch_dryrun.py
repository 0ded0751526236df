"""The port's dry-run (``repro_torch.launch.dryrun``), its operator analysis
(``launch.op_analysis``) and the kernels' operators that make it see the
card's path.

  * Each kernel operator's FLOP formula equals ``FlopCounterMode``'s count
    of its plain version (``ref.py``) at the same arguments: causal,
    windowed and GQA flash attention (with a softcap), WKV6, SSD.
  * On meta tensors the operators' meta implementations allocate what the
    launch allocates, launch nothing (``launches()`` unchanged) and never
    call ``ref`` (a spy that raises takes its place).
  * ``op_analysis`` counts the work and the collectives of every cell of
    a ``shard_map``: the dispatch modes of the caller and its collective
    observer are carried into the cell threads (a (1, 4) toy program, and
    olmoe-1b-7b's a2a MoE on a (1, 4) mesh against the MoE layer's own
    FLOP count on 4 ranks); a mesh cell whose collectives the one-cell
    trace cannot count is refused.
  * Per-device argument bytes on a (2, 2) mesh against the reference's
    ``compiled.memory_analysis().argument_size_in_bytes`` (4 fake host
    devices in one subprocess, ``test_torch_spmd.run_reference``): equal.
  * The CLI on this host: a card cell exits 0 with one ``OK``, a skipped
    cell exits 0 with ``SKIP``; the peak of live storages against a hand
    count, and the card path's count of the CUDA softmax backward's
    scratch.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.configs import SHAPES_BY_NAME, registry  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.distributed import spmd  # noqa: E402
from repro_torch.distributed.sharding import ShardingCtx  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.ssd import kernel as SK  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd import ref as ssd_ref  # noqa: E402
from repro_torch.kernels.wkv6 import kernel as WK  # noqa: E402
from repro_torch.kernels.wkv6 import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.wkv6 import ref as wkv_ref  # noqa: E402
from repro_torch.launch import dryrun, op_analysis, programs  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import moe_a2a  # noqa: E402
from test_torch_spmd import SRC, run_reference  # noqa: E402

META = torch.device("meta")
# (B, Sq, Skv, Hq, Hkv, D, causal, window, softcap)
FLASH = [(2, 40, 40, 4, 4, 16, True, 0, 0.0),
         (1, 64, 64, 6, 2, 32, True, 16, 0.0),
         (2, 24, 56, 8, 2, 8, False, 0, 30.0)]
WKV6 = [(2, 64, 3, 8, 4, 32), (1, 96, 2, 16, 16, 16)]  # B, S, H, K, V, chunk
SSD = [(2, 64, 3, 8, 4, 16), (1, 48, 2, 4, 8, 8)]  # b, S, H, P, N, chunk


def counted(fn, *args, **kw):
    with FlopCounterMode(display=False) as fc:
        fn(*args, **kw)
    return fc.get_total_flops()


def flash_args(B, Sq, Skv, Hq, Hkv, D, device=META):
    return (torch.empty(B, Sq, Hq, D, device=device),
            torch.empty(B, Skv, Hkv, D, device=device),
            torch.empty(B, Skv, Hkv, D, device=device))


def wkv6_args(B, S, H, K, V, device=META):
    rkw = [torch.empty(B, S, H, K, device=device) for _ in range(3)]
    return (rkw[0], rkw[1], torch.empty(B, S, H, V, device=device), rkw[2],
            torch.empty(H, K, device=device),
            torch.empty(B, H, K, V, device=device))


def ssd_args(b, S, H, P, N, device=META):
    return (torch.empty(b, S, H, P, device=device),
            torch.empty(b, S, H, device=device),
            torch.empty(b, S, N, device=device),
            torch.empty(b, S, N, device=device),
            torch.empty(H, device=device), torch.empty(H, device=device),
            torch.empty(b, H, P, N, device=device))


@pytest.mark.parametrize("case", FLASH)
def test_flash_formula_is_the_plain_count(case):
    *shape, causal, window, softcap = case
    args = flash_args(*shape)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = counted(fa_ref.attention, *flash_args(*shape, device="cpu"), **kw)
    got = counted(fa_ops.flash_attention_fwd, *args, causal, window,
                  softcap)
    assert got == want > 0
    # the card's path on meta tensors: the operator, counted as the plain
    assert counted(fa_ops.flash_attention, *args, **kw) == want


@pytest.mark.parametrize("case", WKV6)
def test_wkv6_formula_is_the_plain_count(case):
    *shape, chunk = case
    want = counted(wkv_ref.wkv6, *wkv6_args(*shape, device="cpu"),
                   chunk=chunk)
    got = counted(wkv_ops.wkv6_chunked, *wkv6_args(*shape), chunk)
    assert got == want > 0
    assert counted(wkv_ops.wkv6, *wkv6_args(*shape), chunk=chunk) == want


@pytest.mark.parametrize("case", SSD)
def test_ssd_formula_is_the_plain_count(case):
    *shape, chunk = case
    want = counted(ssd_ref.ssd, *ssd_args(*shape, device="cpu"), chunk=chunk)
    got = counted(ssd_ops.ssd_chunked, *ssd_args(*shape), chunk)
    assert got == want > 0
    assert counted(ssd_ops.ssd, *ssd_args(*shape), chunk=chunk) == want


def test_meta_implementations_launch_nothing_and_never_run_ref(monkeypatch):
    """The card's path on meta tensors: each operator's meta
    implementation gives the launch's outputs (shapes, dtypes) with no
    launch counted and no plain version run (each ``ref`` replaced by a
    spy that raises), forward and through the autograd Functions."""
    def spy(*a, **kw):
        raise AssertionError("the plain version ran in the forward")

    for mod, name in ((fa_ref, "attention"), (wkv_ref, "wkv6"),
                      (ssd_ref, "ssd")):
        monkeypatch.setattr(mod, name, spy)
    before = (FK.launches(), WK.launches(), SK.launches())
    q, k, v = flash_args(2, 40, 40, 4, 2, 16)
    q.requires_grad_()
    o = fa_ops.flash_attention(q, k.to(torch.bfloat16).float(), v)
    assert (o.shape, o.dtype, o.device) == (q.shape, q.dtype, META)
    assert o.grad_fn is not None
    y, s = wkv_ops.wkv6(*wkv6_args(2, 64, 3, 8, 4), chunk=32)
    assert (y.shape, s.shape, y.dtype) == ((2, 64, 3, 4), (2, 3, 8, 4),
                                          torch.float32)
    xb = [t.to(torch.bfloat16) if t.dim() == 4 else t
          for t in ssd_args(2, 64, 3, 8, 4)]
    y, s = ssd_ops.ssd(*xb, chunk=16)
    assert (y.shape, s.shape, y.dtype) == ((2, 64, 3, 8), (2, 3, 8, 4),
                                          torch.float32)
    assert (FK.launches(), WK.launches(), SK.launches()) == before


def test_cells_count_their_work_and_collectives():
    """A (1, 4) shard_map: each cell's matmul is counted (the caller's
    modes run in every cell thread), the psum once a device with the
    reference's ring factor, and every cell's tensors in the peak."""
    mesh = make_mesh((1, 4), ("data", "model"), [META] * 4)
    w = torch.empty(16, 32, device=META)

    def cell(x, w):
        return spmd.psum(x @ w, "model")

    fn = spmd.shard_map(cell, mesh, in_specs=((None, "model"),
                                              ("model", None)),
                        out_specs=())
    x = torch.empty(8, 16, device=META)
    s = op_analysis.analyze(fn, x, w)
    assert s.dot_flops == 4 * 2 * 8 * 4 * 32
    assert s.dot_bytes == 4 * 4 * (8 * 4 + 4 * 32 + 8 * 32)
    out_b = 8 * 32 * 4
    assert s.per_op == {"all-reduce": {"count": 1, "bytes": out_b,
                                       "wire": 2 * out_b * 3 / 4,
                                       "one_cell_groups": 0}}
    assert s.collective_wire_bytes == 2 * out_b * 3 / 4
    # the arguments, 4 partial products, 4 sums (no views are counted)
    assert s.peak_bytes >= (8 * 16 + 16 * 32) * 4 + 8 * out_b


def test_a2a_program_counts_the_work_of_its_four_cells():
    """olmoe-1b-7b's smoke prefill with the a2a MoE on a (1, 4) mesh: the
    traced FLOPs are the dense-layer FLOPs (the same program with the MoE
    layers' expert work counted apart) plus each MoE layer's work on all
    4 ranks: a router product of every token and the expert FFNs over
    every rank's buckets; each layer's two all-to-alls, one all-gather
    and one all-reduce a device."""
    b = registry.get("olmoe-1b-7b")
    cfg = b.smoke
    run = b.run.replace(moe_impl="a2a")
    mesh = make_mesh((1, 4), ("data", "model"), [META] * 4)
    shape = ShapeSpec("p", "prefill", 64, 2)
    prog = programs.build_program(cfg, run, shape,
                                  ShardingCtx.for_mesh(mesh))
    s = op_analysis.analyze(prog.fn, *prog.args)
    L, d, E, f = cfg.num_layers, cfg.d_model, cfg.num_experts, cfg.d_ff
    T = shape.global_batch * shape.seq_len
    C = moe_a2a._pair_capacity(T // 4, cfg)
    moe = L * (2 * T * d * E + 3 * 2 * E * 4 * C * d * f)
    dense = programs.build_program(cfg, b.run, shape, ShardingCtx.null())
    dense_s = op_analysis.analyze(dense.fn, *dense.args)
    dense_moe = L * _dense_moe_flops(cfg, T)
    assert s.dot_flops == dense_s.dot_flops - dense_moe + moe
    assert {op: d_["count"] for op, d_ in s.per_op.items()} == {
        "all-to-all": 2 * L, "all-gather": L, "all-reduce": L}


def _dense_moe_flops(cfg, T):
    """The dense dispatch's FLOPs in one MoE layer, counted by tracing
    that layer alone."""
    from repro_torch.models import lm, moe
    from repro_torch.models import params as P

    w = P.layer(P.fake_tree(lm.param_specs(cfg), ShardingCtx.null(),
                            "bfloat16")[0]["stack"]["layers"], 0)["moe"]
    x = torch.empty(1, T, cfg.d_model, dtype=torch.bfloat16, device=META)
    return op_analysis.analyze(
        lambda x: moe.moe_apply(cfg, ShardingCtx.null(), w, x)[0],
        x).dot_flops


def test_mesh_cells_refuse_collectives_they_cannot_count(tmp_path):
    """decode_flash on the 16 x 16 mesh gathers its output over the data
    axes, which one data cell's trace runs over one cell: the cell is
    refused (FAIL), not counted short; on one card it runs."""
    r = dryrun.run_cell("smollm-135m", "decode_32k", "single",
                        "decode_flash", str(tmp_path), smoke=True)
    assert not r["ok"] and "data axes" in r["error"]
    r = dryrun.run_cell("smollm-135m", "decode_32k", "card", "decode_flash",
                        str(tmp_path), smoke=True)
    assert r["ok"] and r["n_chips"] == 1


def test_single_mesh_cell_shards_arguments_and_traces_one_data_cell(
        tmp_path):
    """The 16 x 16 mesh: the arguments are the largest shards, the trace
    one data cell's 2 sequences (32 / 16) at full width, its
    activations flagged an upper bound."""
    r = dryrun.run_cell("smollm-135m", "prefill_32k", "single", "baseline",
                        str(tmp_path), smoke=True)
    card = dryrun.run_cell("smollm-135m", "prefill_32k", "card", "baseline",
                           str(tmp_path), smoke=True)
    assert r["ok"] and r["n_chips"] == 256 and r["traced_batch"] == 2
    assert card["traced_batch"] == 32
    pb, cb = r["per_device_bytes"], card["per_device_bytes"]
    assert pb["activations_upper_bound"] and not cb["activations_upper_bound"]
    assert pb["arguments"] < cb["arguments"]
    assert r["ops"]["kernel_calls"] == card["ops"]["kernel_calls"]
    assert r["collectives_not_issued"] and card["collectives_not_issued"] \
        is None
    with open(tmp_path / "smollm-135m__prefill_32k__single__baseline.json"
              ) as f:
        assert json.load(f)["ok"]


REF_ARG_BYTES = """
from repro.configs import registry, SHAPES_BY_NAME
from repro.distributed.sharding import ShardingCtx
from repro.launch.programs import build_program
mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                         ("data", "model"))
ctx = ShardingCtx.for_mesh(mesh, "baseline")
for arch, shape in inp["cells"]:
    b = registry.get(arch)
    prog = build_program(b.smoke, b.run_for(shape), SHAPES_BY_NAME[shape],
                         ctx)
    with mesh:
        c = jax.jit(prog.fn, out_shardings=prog.out_shardings,
                    donate_argnums=prog.donate_argnums
                    ).lower(*prog.args).compile()
    out[arch + "/" + shape] = np.int64(
        c.memory_analysis().argument_size_in_bytes)
"""
ARG_CELLS = [("smollm-135m", "train_4k"), ("smollm-135m", "prefill_32k"),
             ("smollm-135m", "decode_32k"), ("olmoe-1b-7b", "decode_32k"),
             ("zamba2-7b", "prefill_32k"), ("zamba2-7b", "decode_32k")]


def test_argument_bytes_match_reference_on_a_2x2_mesh():
    """Each leaf's largest shard under the rules, summed, is the
    reference's per-device argument size (JAX pads uneven shards to the
    largest: the same bytes)."""
    ref = run_reference(REF_ARG_BYTES, {"cells": ARG_CELLS}, 4)
    mesh = make_mesh((2, 2), ("data", "model"), [META] * 4)
    ctx = ShardingCtx.for_mesh(mesh)
    for arch, shape in ARG_CELLS:
        b = registry.get(arch)
        prog = programs.build_program(b.smoke, b.run_for(shape),
                                      SHAPES_BY_NAME[shape], ctx)
        assert dryrun.argument_bytes(prog) == int(ref[f"{arch}/{shape}"]), \
            (arch, shape)


def test_peak_counts_live_storages():
    """A storage counts from the operator that makes it until its last
    reference goes; a view keeps it; the arguments count from the start."""
    a = torch.empty(64, 64, device=META)  # 16 KiB

    def fn(a):
        b = a @ a          # +16 KiB
        c = b[0]           # a view: nothing
        del b              # the view keeps b's storage
        d = a + 1          # +16 KiB
        del d              # -16 KiB
        return c.sum()     # +4 B

    s = op_analysis.analyze(fn, a)
    assert s.peak_bytes == 3 * 64 * 64 * 4


@pytest.mark.parametrize("strided", [True, False])
def test_card_path_counts_the_softmax_backward_scratch(strided):
    """On the card PyTorch's softmax backward forms ``grad * output`` and
    copies it to a contiguous tensor when it is strided, inside one
    launch: the card's path (meta tensors) counts that scratch at the
    operator, the plain path (fake CPU tensors) does not."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def fn(x, g):
        x = x.detach().requires_grad_()
        y = torch.softmax(x, dim=-1)
        return torch.autograd.grad(y, x, g)

    def args(device, mode=None):
        with mode or contextlib.nullcontext():
            x = torch.empty(4, 8, 16, device=device)
            g = (torch.empty(4, 16, 8, device=device).transpose(1, 2)
                 if strided else torch.empty(4, 8, 16, device=device))
        return x, g

    n = 4 * 8 * 16 * 4
    card = op_analysis.analyze(fn, *args(META)).peak_bytes
    plain = op_analysis.analyze(fn, *args("cpu", FakeTensorMode())).peak_bytes
    assert plain == 4 * n  # x, g, the output, its gradient
    assert card - plain == (2 * n if strided else n)


def test_card_path_counts_the_reductions_cast():
    """On the card a sum whose result type is not its input's (a count of
    a boolean mask, as the MoE layer takes) first casts the whole input
    to the result type: the card's path counts that copy; a bf16 sum to
    float32 reads in place."""
    mask = torch.empty(64, 8, 40, dtype=torch.bool, device=META)
    x = torch.empty(64, 8, 40, dtype=torch.bfloat16, device=META)
    n = 64 * 8 * 40
    counted = op_analysis.analyze(lambda m: m.sum(dim=2), mask).peak_bytes
    assert counted == n + 64 * 8 * 8 + n * 8  # the mask, the sum, the cast
    bf = op_analysis.analyze(
        lambda t: t.sum(dim=2, dtype=torch.float32), x).peak_bytes
    assert bf == 2 * n + 64 * 8 * 4


def _cli(*args):
    env = {**os.environ, "PYTHONPATH": SRC}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                           *args], env=env, capture_output=True, text=True,
                          timeout=600)


def test_cli_card_cell_and_skipped_cell(tmp_path):
    out = _cli("--arch", "smollm-135m", "--shape", "train_4k", "--mesh",
               "card", "--smoke", "--out", str(tmp_path))
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert out.stdout.count("OK ") == 1, out.stdout
    with open(tmp_path / "smollm-135m__train_4k__card__baseline.json") as f:
        r = json.load(f)
    L = registry.get("smollm-135m").smoke.num_layers
    # 64 microbatches of 4, each layer's flash forward and remat forward
    assert r["ops"]["kernel_calls"] == {"flash_attention_fwd": 64 * 2 * L}
    assert r["fits_80gb"] and r["dominant"] in r["roofline_terms_s"]
    assert math.isclose(r["roofline_terms_s"]["compute_s"],
                        r["ops"]["dot_flops"] / dryrun.PEAK_FLOPS)
    out = _cli("--arch", "smollm-135m", "--shape", "long_500k",
               "--out", str(tmp_path))
    assert out.returncode == 0, out.stderr[-1500:]
    assert "SKIP" in out.stdout
