"""The WKV6 and SSD kernel paths' backward, and rwkv6/zamba2 training
through them, against the reference on the CPU.

``_WKV6`` and ``_SSD`` (the kernels' autograd Functions) run with the
CUDA kernel's place taken by the plain forward, counted, so they run on
CPU tensors; their backward recomputes through the plain version. They are
held against ``jax.grad`` of the reference's ``ops.wkv6`` / ``ops.ssd``
with ``use_kernel=False`` (the reference's Pallas kernels have no VJP: its
gradient is that of its jnp path). Inputs are drawn with numpy from fixed
seeds. Tolerances, x max(1, max|ref|): the forward's values 1e-4 (WKV6)
and 2e-4 (SSD), the repo's kernel tolerances (tests/test_kernels.py);
float32 gradients 1e-3. bf16 gradients come out bf16 in both packages,
each the rounding of a float32 gradient: they may differ by that 1e-3 and
one bf16 ulp. The stacks: rwkv6 and zamba2's smoke configs at a depth
that the scan group divides more than once, trained with the reference's
two-level remat, give the reference's loss and every gradient within
1e-4, through the plain versions and through the Functions.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import registry as jax_registry  # noqa: E402
from repro.kernels.ssd import ops as jax_ssd_ops  # noqa: E402
from repro.kernels.wkv6 import ops as jax_wkv_ops  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.ssd import kernel as SK  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd import ref as ssd_ref  # noqa: E402
from repro_torch.kernels.wkv6 import kernel as WK  # noqa: E402
from repro_torch.kernels.wkv6 import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.wkv6 import ref as wkv_ref  # noqa: E402
from repro_torch.models import attention, mamba2, rwkv  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from test_torch_dense import (jax_grads_by_path,  # noqa: E402
                              port_loss_and_grads)
from test_torch_rwkv import assert_close, random_reference_params  # noqa: E402

GRAD_TOL = 1e-3
FWD_TOL = {"wkv6": 1e-4, "ssd": 2e-4}


def wkv6_inputs(B, S, H, K, seed=0):
    """tests/test_kernels.py's draws: r, k x 0.5, w x 0.3, u x 0.3, the
    state x 0.1; v (B, S, H, K) too."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    return [0.5 * n(B, S, H, K), 0.5 * n(B, S, H, K), n(B, S, H, K),
            0.3 * n(B, S, H, K), 0.3 * n(H, K), 0.1 * n(B, H, K, K)]


def ssd_inputs(b, S, H, Pd, N, seed=0):
    """tests/test_kernels.py's draws: dt a softplus, B and C x 0.5, A_log
    x 0.3, the state x 0.1; D drawn around 1 so its gradient is not
    trivial."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    return [n(b, S, H, Pd), np.log1p(np.exp(n(b, S, H))).astype(np.float32),
            0.5 * n(b, S, N), 0.5 * n(b, S, N), 0.3 * n(H),
            1.0 + 0.1 * n(H), 0.1 * n(b, H, Pd, N)]


# name -> (inputs, chunk, jax op, port op, kernel module, plain version,
#          the inputs that reach the kernel in bf16 under bf16 compute)
SCANS = {
    "wkv6": (functools.partial(wkv6_inputs, 2, 64, 3, 16), 16,
             jax_wkv_ops.wkv6, wkv_ops.wkv6, WK, "wkv6_chunked", wkv_ref.wkv6,
             (0, 1, 2, 3)),
    "ssd": (functools.partial(ssd_inputs, 2, 64, 3, 16, 8), 32,
            jax_ssd_ops.ssd, ssd_ops.ssd, SK, "ssd_chunked", ssd_ref.ssd,
            (0, 2, 3)),
}


@pytest.fixture
def plain_scans_as_kernels(monkeypatch):
    """Each scan kernel's place taken by its plain forward, counted, so the
    Functions run on CPU tensors."""
    calls = {name: 0 for name in SCANS}
    for name, (*_, mod, attr, plain, _bf16) in SCANS.items():
        def counted(*t, chunk, _name=name, _plain=plain):
            assert all(x.is_contiguous() for x in t)
            calls[_name] += 1
            return _plain(*t, chunk=chunk)
        monkeypatch.setattr(mod, attr, counted)
    return calls


@pytest.mark.parametrize("uses", ["both", "y", "state"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(SCANS))
def test_scan_function_matches_reference_grad(name, dtype, uses,
                                              plain_scans_as_kernels):
    """Forward values, and the gradient of every input (the state's too)
    against ``jax.grad`` of the reference, with y, state_out or both used:
    an output the caller drops reaches the backward as None."""
    make, chunk, jop, pop, *_rest, bf16_args = SCANS[name]
    arrays = make()
    gy_np = np.random.default_rng(9).standard_normal(
        _out_shape(name, arrays)).astype(np.float32)
    gs_np = np.random.default_rng(10).standard_normal(
        arrays[-1].shape).astype(np.float32)
    low = dtype == "bfloat16"

    def jcast(i, a):
        a = jnp.asarray(a)
        return a.astype(jnp.bfloat16) if low and i in bf16_args else a

    jargs = [jcast(i, a) for i, a in enumerate(arrays)]
    use_y, use_s = uses in ("both", "y"), uses in ("both", "state")

    def jloss(*args):
        y, st = jop(*args, chunk=chunk, use_kernel=False)
        return (use_y * jnp.sum(y * gy_np)) + (use_s * jnp.sum(st * gs_np))

    jy, jst = jop(*jargs, chunk=chunk, use_kernel=False)
    want = jax.grad(jloss, argnums=tuple(range(len(jargs))))(*jargs)

    targs = [torch.from_numpy(a) for a in arrays]
    targs = [(t.to(torch.bfloat16) if low and i in bf16_args else t)
             .requires_grad_() for i, t in enumerate(targs)]
    y, st = pop(*targs, chunk=chunk, use_kernel=True)
    assert y.grad_fn is not None and y.dtype == st.dtype == torch.float32
    assert_close(y.detach(), jy, FWD_TOL[name], "y")
    assert_close(st.detach(), jst, FWD_TOL[name], "state_out")
    outs, grads = [], []
    if use_y:
        outs.append(y)
        grads.append(torch.from_numpy(gy_np))
    if use_s:
        outs.append(st)
        grads.append(torch.from_numpy(gs_np))
    got = torch.autograd.grad(outs, targs, grads)
    assert plain_scans_as_kernels[name] == 1  # the backward recomputes
    # through the plain version, not the kernel
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == targs[i].dtype, (i, g.dtype)
        if g.dtype == torch.bfloat16:
            assert_bf16_close(g, w, GRAD_TOL, f"grad {i}")
        else:
            assert_close(g, w, GRAD_TOL, f"grad {i}")


def assert_bf16_close(got, want, rel, what):
    """Both bf16 gradients are roundings of float32 gradients that agree
    within rel x max(1, max|ref|); where a pair straddles a rounding
    boundary the roundings differ by one bf16 ulp more."""
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    diff = np.abs(got - want)
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    bound = rel * max(1.0, float(np.max(np.abs(want)))) + ulp
    assert (diff <= bound).all(), f"{what}: {int((diff > bound).sum())} " \
        f"elements differ by more than {rel} x scale and one bf16 ulp"


def _out_shape(name, arrays):
    if name == "wkv6":
        return arrays[2].shape  # v: (B, S, H, V)
    return arrays[0].shape  # x: (b, S, H, P)


@pytest.mark.parametrize("name", [*SCANS, "flash"])
def test_recompute_range_times_the_backward_alone(name, monkeypatch,
                                                  plain_scans_as_kernels):
    """The profiler's event under a Function's recompute range name counts
    its backward calls and nothing else (the card's training phases read
    the recompute backwards' device time from it): the forward is recorded
    under the Function's own name."""
    if name == "flash":
        monkeypatch.setattr(FK, "flash_attention_fwd", fa_ref.attention)
        rng = np.random.default_rng(0)
        args = [torch.from_numpy(rng.standard_normal((1, 32, 2, 16),
                                                     dtype=np.float32))
                for _ in range(3)]

        def run(*a):
            return fa_ops.flash_attention(*a, use_kernel=True).sum()
        fn, rng_name = "_FlashAttention", "flash_recompute_bwd"
    else:
        make, chunk, _jop, pop, *_rest = SCANS[name]
        args = [torch.from_numpy(a) for a in make()]

        def run(*a):
            return pop(*a, chunk=chunk, use_kernel=True)[0].sum()
        fn = {"wkv6": "_WKV6", "ssd": "_SSD"}[name]
        rng_name = f"{name}_recompute_bwd"
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):  # two forwards, then one backward
            leaves = [a.clone().requires_grad_() for a in args]
            loss = run(*leaves)
        loss.backward()
    counts = {e.key: e.count for e in prof.key_averages()}
    assert counts.get(rng_name) == 1, counts.get(rng_name)
    assert counts.get(fn) == 2, counts.get(fn)


@pytest.mark.parametrize("name", list(SCANS))
def test_scan_function_grads_only_what_needs_them(name,
                                                  plain_scans_as_kernels):
    """A constant input (the training stacks' zero state, a frozen weight)
    gets no gradient; the others do."""
    make, chunk, _jop, pop, *_ = SCANS[name]
    targs = [torch.from_numpy(a) for a in make()]
    targs[0].requires_grad_()
    y, st = pop(*targs, chunk=chunk, use_kernel=True)
    y.sum().backward()
    assert targs[0].grad is not None and torch.isfinite(targs[0].grad).all()
    assert all(t.grad is None for t in targs[1:])


@pytest.mark.parametrize("name", list(SCANS))
def test_scan_function_has_no_fallback(name, monkeypatch):
    """A kernel (or build) failure reaches the caller: nothing catches it,
    and the plain version never runs in the kernel's place."""
    make, chunk, _jop, pop, mod, attr, plain, _ = SCANS[name]
    plain_calls = []

    def broken(*t, chunk):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(mod, attr, broken)
    ref_mod = wkv_ref if name == "wkv6" else ssd_ref
    monkeypatch.setattr(ref_mod, name, lambda *a, **k: plain_calls.append(1))
    targs = [torch.from_numpy(a).requires_grad_() for a in make()]
    with pytest.raises(RuntimeError, match="nvcc failed"):
        pop(*targs, chunk=chunk, use_kernel=True)
    assert plain_calls == []


# --- the stacks through grouped_scan -------------------------------------------

# arch -> (depth, scan_group): two or more groups, so the group level runs
STACKS = {"rwkv6-7b": (4, 2), "zamba2-7b": (6, 3)}


def stack_configs(arch, **run_kw):
    L, G = STACKS[arch]
    jb, pb = jax_registry.get(arch), registry.get(arch)
    kw = dict(compute_dtype="float32", scan_group=G, remat="block")
    kw.update(run_kw)
    return (dataclasses.replace(jb.smoke, num_layers=L), jb.run.replace(**kw),
            dataclasses.replace(pb.smoke, num_layers=L), pb.run.replace(**kw))


def stack_batch(cfg, seq=32, seed=0):
    toks = np.random.default_rng(seed + 10).integers(
        0, cfg.vocab_size, (2, seq + 1), dtype=np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def port_grads(pcfg, prun, np_params, np_batch):
    pprm = P.from_reference(np_params, device="cpu")
    loss, _, prm = port_loss_and_grads(
        pcfg, prun, pprm, {k: torch.from_numpy(v) for k, v in np_batch.items()})
    return loss.detach(), prm


def check_against_reference(arch, run_kw=None, seed=0):
    """The port's loss and every gradient against the reference's, the
    reference under its own two-level remat."""
    jcfg, jrun, pcfg, prun = stack_configs(arch, **(run_kw or {}))
    np_params = random_reference_params(jcfg, seed)
    np_batch = stack_batch(jcfg, seed=seed)
    jprm = P.tree_map(lambda a: jnp.asarray(a, jnp.float32), np_params)
    jloss, _, jgrads = jax_grads_by_path(
        jcfg, jax_registry.get(arch).run.replace(
            compute_dtype="float32", scan_group=STACKS[arch][1],
            remat="block"),
        jprm, {k: jnp.asarray(v) for k, v in np_batch.items()})
    loss, prm = port_grads(pcfg, prun, np_params, np_batch)
    assert_close(loss, jloss, 1e-4, "loss")
    for path, want in jgrads.items():
        got = prm
        for key in path:
            got = got[key]
        assert got.grad is not None, path
        assert_close(got.grad, want, 1e-4, f"grad {path}")
    assert len(jgrads) == len(list(P.leaves(prm)))
    return loss, prm


@pytest.mark.parametrize("arch", list(STACKS))
def test_stack_runs_grouped_scan_with_the_runs_remat(arch, monkeypatch):
    """The repair: the teacher-forced stack goes through grouped_scan with
    the run's remat and scan group (it was a plain loop that ignored
    both). Through the plain versions, its loss and every gradient equal
    the reference's and the old loop's (no remat); the body runs once a
    layer in the forward, then again in the group's and the layer's
    recompute, which stops after the last layer's input (PyTorch's
    checkpoint early stop): 3 L - L / G times in all."""
    mod = rwkv if arch == "rwkv6-7b" else mamba2
    real = mod.grouped_scan
    seen, body_calls = [], []

    def spy(body, carry, xs, n, group, remat):
        seen.append((n, group, remat))

        def counted(c, x):
            body_calls.append(1)
            return body(c, x)
        return real(counted, carry, xs, n, group, remat)

    monkeypatch.setattr(mod, "grouped_scan", spy)
    L, G = STACKS[arch]
    loss, prm = check_against_reference(arch)
    assert seen == [(L, G, True)]
    assert len(body_calls) == 3 * L - L // G
    if arch == "zamba2-7b":  # the weight-tied block's gradient accumulates
        # over its three applications, under the checkpoints
        assert all(t.grad.abs().max() > 0 for t in P.leaves(prm["stack"]["shared"]))

    seen.clear()
    _j, _jr, pcfg, prun = stack_configs(arch, remat="none", scan_group=0)
    np_params = random_reference_params(stack_configs(arch)[0], 0)
    old_loss, old = port_grads(pcfg, prun, np_params,
                               stack_batch(stack_configs(arch)[0]))
    assert seen == [(L, 0, False)]
    assert_close(loss, old_loss, 1e-6, "loss, remat vs none")
    for a, b in zip(P.leaves(prm), P.leaves(old)):
        assert_close(a.grad, b.grad, 1e-6, "grad, remat vs none")


def through_scan_functions(monkeypatch):
    """The model's scans and attention through the kernel paths (their
    Functions), on CPU tensors."""
    monkeypatch.setattr(wkv_ops, "wkv6",
                        functools.partial(wkv_ops.wkv6, use_kernel=True))
    monkeypatch.setattr(ssd_ops, "ssd",
                        functools.partial(ssd_ops.ssd, use_kernel=True))

    def flash(q, k, v, **kw):
        return fa_ops.flash_attention(q, k, v, kw["causal"], kw["window"],
                                      kw["softcap"], use_kernel=True)
    monkeypatch.setattr(attention, "attention_auto", flash)


@pytest.mark.parametrize("arch,launches", [
    # rwkv6, 4 layers in groups of 2: 4 forwards, 2 x 1 in the groups'
    # recomputes (each stops before its last layer), 4 in the layers'
    ("rwkv6-7b", {"wkv6": 10, "ssd": 0, "flash": 0}),
    # zamba2, 6 layers in groups of 3, the shared block after layers 1, 3
    # and 5: SSD 6 + 2 x 2 + 6; flash 3 + 2 (after layers 1 and 3; 5 ends
    # its group) + 3
    ("zamba2-7b", {"wkv6": 0, "ssd": 16, "flash": 8}),
])
def test_training_through_the_kernel_functions_matches_reference(
        arch, launches, plain_scans_as_kernels, monkeypatch):
    """rwkv6 and zamba2 trained through the kernels' Functions (the
    kernels' places taken by their counted plain forwards) under the
    bundle's block remat with a scan group: the reference's loss and every
    gradient, with the exact launch counts the card's phases assert."""
    through_scan_functions(monkeypatch)
    flash_calls = []

    def fwd(q, k, v, *, causal, window, softcap):
        flash_calls.append(q.shape)
        return fa_ref.attention(q, k, v, causal=causal, window=window,
                                softcap=softcap)
    monkeypatch.setattr(FK, "flash_attention_fwd", fwd)
    check_against_reference(arch, seed=2)
    assert {**plain_scans_as_kernels, "flash": len(flash_calls)} == launches


def test_training_stack_launch_counts_follow_the_group_size(
        plain_scans_as_kernels, monkeypatch):
    """The count the card's training phases assert, at other groupings:
    with no group (flat remat) 2 L, with G layers a group 3 L - L / G, and
    without remat one forward."""
    through_scan_functions(monkeypatch)
    for group, remat, want in ((0, "block", 8), (4, "block", 11),
                               (2, "block", 10), (1, "block", 8),
                               (2, "none", 4)):
        _jc, _jr, pcfg, prun = stack_configs("rwkv6-7b", scan_group=group,
                                             remat=remat)
        np_params = random_reference_params(stack_configs("rwkv6-7b")[0], 1)
        plain_scans_as_kernels["wkv6"] = 0
        port_grads(pcfg, prun, np_params, stack_batch(pcfg))
        assert plain_scans_as_kernels["wkv6"] == want, (group, remat)
