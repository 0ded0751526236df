"""The dense and MoE families' serve programs partitioned over a mesh
under the ``decode_flash`` rules (``serve.step``: a decode step 2-D
tensor parallel on each cell's weight shards, with no weight gathered;
the prefill on the cell's rows), on virtual CPU meshes, against the
reference's GSPMD ``decode_flash`` serve programs on fake host devices.

The reference runs in one subprocess on 4 fake host devices
(``test_torch_spmd.run_reference``): ``jax.jit`` of its prefill step and
decode step with the logits returned beside the next tokens
(``lm.prefill_fn``, ``lm.decode_fn``, whose every self attention is
``flash_decode`` under these rules), its weights, tokens and cache laid
out by ``launch.programs._ns_tree`` under ``ShardingCtx.for_mesh(mesh,
"decode_flash")``. Cases: the smoke configs of smollm-135m (its 3 heads
do not split over 2: the prefill's attention repeats, a decode step
gathers q's columns), h2o-danube-3-4b (its sliding-window ring),
olmoe-1b-7b (the dense dispatch) and llama4-scout (a shared expert), f32
compute, on (2, 2), (1, 2) and (2, 1); batch 4 x prompt 32; prompt 27
on (2, 1) and h2o-danube's ring on (2, 2), which run in both packages,
and prompt 27 on (2, 2), whose 31 slots do not split over ``model``: the
decode step raises ``ValueError`` in both. The weights drawn by the
reference and carried over; the cache padded for 4 generated tokens,
then 3 decode steps fed the same tokens, each from the reference's cache
shards. Held at each step: every cell's shard indices of the k and v
cache, exactly; every cache shard against the reference's device shard
at the same mesh position to one bfloat16 rounding; the logits within
1e-4 x max(1, max|ref|); the next tokens, equal
(``test_torch_mesh_serve.gaps``).

In the port alone: no cell gathers a weight leaf in a decode step (no
collective labelled with a leaf's path, every all-gather one token a
row); ``generate`` on a virtual mesh gives the null context's ids; the
prefill's flash calls run on the cell's 2 rows, on its own q heads and
the kv heads they read where the heads split, and a decode step calls
none; and four planted breaches, each refused by the reference
differential: the q, k and v projections' exit over the feature axes
skipped, a norm's total over them skipped, the new token written into
every cell's sequence block, and the attention output's all-gather over
the data axes replaced by the cell's own rows repeated.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch.configs import registry  # noqa: E402
from repro_torch.distributed import spmd  # noqa: E402
from repro_torch.distributed.sharding import ShardingCtx  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import step as S  # noqa: E402
from test_torch_mesh_serve import (from_reference, gaps,  # noqa: E402
                                   last4)
from test_torch_mesh_train import virtual  # noqa: E402
from test_torch_spmd import run_reference  # noqa: E402

SMOLLM, DANUBE = "smollm-135m", "h2o-danube-3-4b"
OLMOE, SCOUT = "olmoe-1b-7b", "llama4-scout-17b-a16e"
ARCHS = (SMOLLM, DANUBE, OLMOE, SCOUT)
B, PROMPT, GEN, SEED = 4, 32, 4, 7
STEPS = GEN - 1
# (arch, (data, model), prompt)
CASES = tuple((arch, mesh, PROMPT) for arch in ARCHS
              for mesh in ((2, 2), (1, 2), (2, 1))) + (
    (SMOLLM, (2, 1), 27), (OLMOE, (2, 1), 27), (DANUBE, (2, 2), 27))
# 31 slots over the 2 cells of model: refused in both packages
REFUSED = ((SMOLLM, (2, 2), 27), (OLMOE, (2, 2), 27))


def key(case) -> str:
    arch, (d, m), prompt = case
    return f"{arch}/{d}x{m}/{prompt}"


REF_FLASH = """
import dataclasses
import json
from repro.configs import registry
from repro.configs.base import ShapeSpec
from repro.distributed.sharding import ShardingCtx
from repro.launch.mesh import make_host_mesh
from repro.launch.programs import _ns_tree
from repro.models import lm, params as P

def shards(x, shape):
    by_dev = {s.device: (np.asarray(s.data), s.index)
              for s in x.addressable_shards}
    out, idx = [], []
    for dv in x.sharding.mesh.devices.flat:
        data, index = by_dev[dv]
        out.append(data.astype(np.float32))
        idx.append([[0 if sl.start is None else sl.start,
                     d if sl.stop is None else sl.stop]
                    for sl, d in zip(index, shape)])
    return out, json.dumps(idx)

def keep(prefix, cache):
    for name, leaf in cache.items():
        data, idx = shards(leaf, leaf.shape)
        out[f"{prefix}/{name}/shards"] = data
        out[f"{prefix}/{name}/indices"] = idx

def padded(cache):
    # the k and v grow on their sequence axis (third from last)
    padw = [(0, 0)] * 5
    padw[-3] = (0, inp["gen"])
    return {k: np.pad(np.asarray(v), padw) for k, v in cache.items()}

for arch in inp["archs"]:
    cfg = registry.get(arch).smoke
    out[f"{arch}/params"] = P.materialize(
        lm.param_specs(cfg), jax.random.PRNGKey(inp["seed"]),
        dtype="float32")

for arch, (d, m), prompt in inp["cases"]:
    key = f"{arch}/{d}x{m}/{prompt}"
    cfg = registry.get(arch).smoke
    run = registry.get(arch).run.replace(compute_dtype="float32",
                                         sharding_rules="decode_flash")
    mesh = make_host_mesh(d, m)
    ctx = ShardingCtx.for_mesh(mesh, "decode_flash")
    toks = inp["tokens"] % cfg.vocab_size
    params = jax.device_put(out[f"{arch}/params"],
                            _ns_tree(lm.param_specs(cfg), ctx))

    def prefill(p, batch):
        logits, cache = lm.prefill_fn(cfg, run, ctx, p, batch)
        return jnp.argmax(logits, axis=-1).astype(jnp.int32), cache, logits

    def decode(p, cache, batch):
        logits, cache = lm.decode_fn(cfg, run, ctx, p, cache, batch)
        return jnp.argmax(logits, axis=-1).astype(jnp.int32), cache, logits

    pre_shape = ShapeSpec("p", "prefill", prompt, toks.shape[0])
    dec_len = prompt + (0 if cfg.sliding_window else inp["gen"])
    dec_shape = ShapeSpec("d", "decode", dec_len, toks.shape[0])
    pre_ns = _ns_tree(lm.cache_specs(cfg, pre_shape), ctx)
    dec_ns = _ns_tree(lm.cache_specs(cfg, dec_shape), ctx)
    in_ns = _ns_tree(lm.input_specs(cfg, pre_shape), ctx)
    with mesh:
        tok, cache, logits = jax.jit(
            prefill, out_shardings=(None, pre_ns, None))(
            params, jax.device_put({"tokens": toks[:, :prompt]}, in_ns))
    out[f"{key}/prefill/tok"], out[f"{key}/prefill/logits"] = tok, logits
    keep(f"{key}/prefill", cache)
    if not cfg.sliding_window:
        cache = padded(cache)
    cache = jax.device_put(cache, dec_ns)
    keep(f"{key}/padded", cache)
    step = jax.jit(decode, out_shardings=(None, dec_ns, None))
    for i in range(inp["steps"]):
        t = prompt + i
        try:
            with mesh:
                tok, cache, logits = step(params, cache, {
                    "tokens": jnp.asarray(toks[:, t:t + 1]),
                    "pos": jnp.int32(t)})
        except ValueError as e:
            out[f"{key}/refused"] = str(e)
            break
        out[f"{key}/decode{i}/tok"] = tok
        out[f"{key}/decode{i}/logits"] = logits
        keep(f"{key}/decode{i}", cache)
"""


def tokens() -> np.ndarray:
    """The prompts and the tokens fed to the decode steps (a case takes
    them modulo its vocabulary)."""
    return np.random.default_rng(SEED).integers(
        0, 256, (B, PROMPT + STEPS), dtype=np.int32)


@pytest.fixture(scope="module")
def reference():
    return run_reference(REF_FLASH, {
        "archs": ARCHS, "cases": CASES + REFUSED, "seed": SEED,
        "tokens": tokens(), "gen": GEN, "steps": STEPS}, 4)


def setup(case, reference):
    """(cfg, run, ctx, the reference's weights) of ``case``: its arch's
    smoke config under decode_flash on its virtual mesh."""
    arch, (d, m), _ = case
    b = registry.get(arch)
    run = b.run.replace(compute_dtype="float32",
                        sharding_rules="decode_flash")
    ctx = ShardingCtx.for_mesh(virtual(d, m), "decode_flash")
    prm = P.from_reference(reference[f"{arch}/params"], "cpu")
    return b.smoke, run, ctx, prm


def serve_steps(cfg, run, ctx, prm, prompt, feed=None):
    """The partitioned prefill, the cache padded for GEN tokens under the
    decode_flash rules, and STEPS decode steps fed the reference's tokens:
    [(name, next tokens, cache, logits)]; ``feed(name, cache)`` the cache
    the decode step after step ``name`` starts from
    (``test_torch_mesh_serve.serve_steps``')."""
    toks = torch.from_numpy(tokens()) % cfg.vocab_size
    prefill = S.make_prefill_step(cfg, run, ctx)
    decode = S.make_decode_step(cfg, run, ctx)
    if ctx.mesh is not None:
        prm = S.laid_out(cfg, ctx, prm)
    tok, cache, logits = prefill(prm, {"tokens": toks[:, :prompt]},
                                 logits=True)
    out = [("prefill", tok, cache, logits)]
    cache = serve.pad_cache(cfg, cache, GEN, ctx)
    out.append(("padded", None, cache, None))
    for i in range(STEPS):
        t = prompt + i
        if feed is not None:
            cache = feed(out[-1][0], cache)
        tok, cache, logits = decode(prm, cache, {
            "tokens": toks[:, t:t + 1], "pos": t}, logits=True)
        out.append((f"decode{i}", tok, cache, logits))
    return out


@pytest.mark.parametrize("case", CASES, ids=key)
def test_flash_serve_matches_reference_on_its_mesh(reference, case):
    cfg, run, ctx, prm = setup(case, reference)
    assert S.partitioned(cfg, run, ctx)
    steps = serve_steps(cfg, run, ctx, prm, case[2],
                        from_reference(reference, key(case)))
    assert gaps(steps, reference, key(case)) == []
    assert f"{key(case)}/refused" not in reference
    # the cache's rows over data and its slots over model, every kv head
    # in every cell
    (d, m), slots = case[1], steps[-1][2]["k"].shape[-3]
    assert last4(steps[-1][2]["k"]) == (
        "data" if d > 1 else None,
        "model" if m > 1 and slots % m == 0 else None, None, None)


@pytest.mark.parametrize("case", REFUSED, ids=key)
def test_flash_decode_refuses_slots_that_do_not_split(reference, case):
    """31 slots over the 2 cells of ``model``: the reference's
    ``flash_decode`` refuses them, and so does the port's decode step,
    after a prefill held as the reference's."""
    assert "not evenly divisible" in str(reference[f"{key(case)}/refused"])
    cfg, run, ctx, prm = setup(case, reference)
    with pytest.raises(ValueError, match="do not split"):
        serve_steps(cfg, run, ctx, prm, case[2])
    prm = S.laid_out(cfg, ctx, prm)
    toks = torch.from_numpy(tokens()) % cfg.vocab_size
    tok, cache, logits = S.make_prefill_step(cfg, run, ctx)(
        prm, {"tokens": toks[:, :case[2]]}, logits=True)
    assert gaps([("prefill", tok, cache, logits)], reference,
                key(case)) == []


def test_no_cell_gathers_a_weight_in_a_decode_step(reference):
    """In every decode step of olmoe's and smollm's decode_flash serve on
    (2, 2) no collective is a weight's gather (labelled with its path
    by ``serve.step._gathered``), and every all-gather returns one token
    a row: q's columns, the attention output's rows, the router's
    logits; the prefill gathers its layers' weights over the data axes,
    as the baseline's does."""
    for arch in (OLMOE, SMOLLM):
        cfg, run, ctx, prm = setup((arch, (2, 2), PROMPT), reference)
        prm = S.laid_out(cfg, ctx, prm)
        toks = torch.from_numpy(tokens())
        seen = []

        def note(op, out, g, cell, *, axes, label):
            seen.append((op, label, tuple(out.shape), axes))

        with spmd.observe(note):
            _, cache = S.make_prefill_step(cfg, run, ctx)(
                prm, {"tokens": toks[:, :PROMPT]})
        assert any(label and label.startswith("stack") and axes == ("data",)
                   for _, label, _, axes in seen)
        cache = serve.pad_cache(cfg, cache, GEN, ctx)
        seen.clear()
        decode = S.make_decode_step(cfg, run, ctx)
        with spmd.observe(note):
            for i in range(STEPS):
                _, cache = decode(prm, cache, {
                    "tokens": toks[:, PROMPT + i:PROMPT + i + 1],
                    "pos": PROMPT + i})
        assert seen and {label for _, label, _, _ in seen} == {None}
        widest = max(cfg.q_dim, cfg.num_experts)
        gathers = [n for op, _, n, _ in seen if op == "all-gather"]
        assert gathers and all(n[0] == B and int(np.prod(n)) <= B * widest
                               for n in gathers), gathers
        assert {axes for *_, axes in seen} == {("data",), ("model",)}


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_on_a_virtual_mesh_gives_the_null_contexts_ids(reference,
                                                                 arch):
    cfg, run, ctx, prm = setup((arch, (2, 2), PROMPT), reference)
    batch = {"tokens": torch.from_numpy(tokens()[:, :PROMPT])}
    want, _ = serve.generate(cfg, run, prm, batch, 6)
    got, times = serve.generate(cfg, run, prm, batch, 6, ctx)
    assert got.shape == (B, 6) and np.array_equal(got, want)
    assert times["prefill_s"] > 0


@pytest.fixture
def counted_pairs(monkeypatch):
    """The flash kernel's place taken by the plain forward, each call's
    (q, k) shapes counted, and the model's attention sent through the
    flash Function, as on the card."""
    calls = []

    def fwd(q, k, v, *, causal, window, softcap):
        calls.append((tuple(q.shape), tuple(k.shape)))
        return fa_ref.attention(q, k, v, causal=causal, window=window,
                                softcap=softcap)

    def through_function(q, k, v, **kw):
        return fa_ops.flash_attention(q, k, v, kw["causal"], kw["window"],
                                      kw["softcap"], use_kernel=True)

    monkeypatch.setattr(FK, "flash_attention_fwd", fwd)
    monkeypatch.setattr(A, "attention_auto", through_function)
    return calls


@pytest.mark.parametrize("arch,heads", [(OLMOE, "cell"), (SCOUT, "cell"),
                                        (SMOLLM, "all")])
def test_prefill_flash_calls_run_on_the_cells_rows(reference, counted_pairs,
                                                   arch, heads):
    """Every cell of (2, 2) calls flash once a layer in a prefill on its 2
    rows: on its own q heads and the kv heads they read where the q heads
    split over ``model`` (olmoe's 2 of 4 over its 2 of 4 kv heads,
    scout's 2 of 4 over 1 of 2), on every head where they do not
    (smollm's 3 over 1); a decode step calls none."""
    cfg, run, ctx, prm = setup((arch, (2, 2), PROMPT), reference)
    prm = S.laid_out(cfg, ctx, prm)
    prefill = S.make_prefill_step(cfg, run, ctx)
    tok, cache = prefill(prm, {"tokens": torch.from_numpy(
        tokens()[:, :PROMPT])})
    plan = prefill.plan_at({"tokens": torch.zeros(B, PROMPT)})
    assert plan.qheads == (heads == "cell") and not plan.attn
    split = 2 if heads == "cell" else 1
    q = (B // 2, PROMPT, cfg.num_heads // split, cfg.head_dim)
    k = (B // 2, PROMPT, cfg.num_kv_heads // split, cfg.head_dim)
    assert counted_pairs == [(q, k)] * (4 * cfg.num_layers)
    S.make_decode_step(cfg, run, ctx)(prm, serve.pad_cache(
        cfg, cache, GEN, ctx), {"tokens": tok[:, None], "pos": PROMPT})
    assert len(counted_pairs) == 4 * cfg.num_layers


# --- planted breaches -------------------------------------------------------------


def _qkv_exit_over_features_skipped(monkeypatch):
    real = T._qkv_2d

    def breached(cfg, tc, *a, **kw):
        sound = tc.tape.exit
        tc.tape.exit = lambda x, axis="model": (
            x if axis == tc.plan.features else sound(x, axis))
        try:
            return real(cfg, tc, *a, **kw)
        finally:
            del tc.tape.exit

    monkeypatch.setattr(T, "_qkv_2d", breached)


def _norm_total_over_features_skipped(monkeypatch):
    real = T._normed_on

    def breached(tc, *a, **kw):
        if not tc.plan.decode_2d:
            return real(tc, *a, **kw)
        tc.tape.total = lambda x, axis="model": x
        try:
            return real(tc, *a, **kw)
        finally:
            del tc.tape.total

    monkeypatch.setattr(T, "_normed_on", breached)


def _token_written_into_every_block(monkeypatch):
    real = A._shard_decode

    def breached(tape, q, k, v, ck, cv, pos, cut, **kw):
        if cut.dim == 1:
            ck, cv = A.cache_update(ck, cv, k, v, pos % ck.shape[1])
        return real(tape, q, k, v, ck, cv, pos, cut, **kw)

    monkeypatch.setattr(A, "_shard_decode", breached)


def _own_rows_repeated(monkeypatch):
    real = A.cell_decode

    def breached(tape, q, k, v, ck, cv, pos, cut, **kw):
        if not cut.rows:
            return real(tape, q, k, v, ck, cv, pos, cut, **kw)
        n = ck.shape[0]
        lo = spmd.axis_index(cut.rows) * n
        o, ck, cv = A._shard_decode(tape, *(t.narrow(0, lo, n)
                                            for t in (q, k, v)),
                                    ck, cv, pos, cut, **kw)
        return o.repeat(q.shape[0] // n, 1, 1, 1), ck, cv

    monkeypatch.setattr(A, "cell_decode", breached)


@pytest.mark.parametrize("breach", [_qkv_exit_over_features_skipped,
                                    _norm_total_over_features_skipped,
                                    _token_written_into_every_block,
                                    _own_rows_repeated])
@pytest.mark.parametrize("arch", [OLMOE, SMOLLM])
def test_planted_breaches_fail_the_reference_differential(
        reference, monkeypatch, breach, arch):
    """Each breach of the decode_flash decode step is refused by the
    reference differential that the sound code passes
    (``test_flash_serve_matches_reference_on_its_mesh``)."""
    case = (arch, (2, 2), PROMPT)
    cfg, run, ctx, prm = setup(case, reference)
    breach(monkeypatch)
    assert gaps(serve_steps(cfg, run, ctx, prm, PROMPT,
                            from_reference(reference, key(case))),
                reference, key(case))


def test_flash_plan_keeps_every_kv_head_in_every_cell():
    """On the 16 x 16 mesh the decode_flash rules cut ``wq``'s columns and
    ``wo``'s rows over ``model`` and ``wk`` and ``wv`` over the data axis
    alone: attention is local by its q heads where they split (llama3's
    128 heads, each cell's 8 reading one of the 8 kv heads), repeated in
    the prefill where they do not (llama4-scout's 40), never in a decode
    step."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.programs import build_program
    from repro_torch.configs import SHAPES_BY_NAME

    mesh = dryrun._meta_mesh(*dryrun.MESHES["single"])
    ctx = ShardingCtx.for_mesh(mesh, "decode_flash")
    for arch, qheads in (("llama3-405b", True),
                         ("llama4-scout-17b-a16e", False)):
        b = registry.get(arch)
        run = b.run.replace(sharding_rules="decode_flash")
        specs = P.map_specs(lambda s: ctx.spec(s.logical, s.shape),
                            lm.param_specs(b.model))["stack"]["layers"]
        attn = specs["attn"]
        assert attn["wq"] == (None, "data", "model")
        assert attn["wk"] == (None, "data") == attn["wv"]
        pre = build_program(b.model, run, SHAPES_BY_NAME["prefill_32k"], ctx)
        dec = build_program(b.model, run, SHAPES_BY_NAME["decode_32k"], ctx)
        assert pre.plan.qheads == qheads and pre.plan.qcols
        assert ("attention" in pre.plan.repeated(b.model)) != qheads
        assert dec.plan.decode_2d and dec.plan.features == ("data",)
        assert "attention" not in dec.plan.repeated(b.model)


@pytest.mark.parametrize("n", [1, 4])
def test_cache_block_at_rest_does_not_hold_the_layers_whole_kv(n):
    """A prefill cell's sequence block of a layer's k or v, where it keeps
    every kv head (``attention.cache_rest``, ``CacheCut.local`` False), is
    a copy: a view would hold each layer's whole (rows, S, H, D) k and v
    until the stack of the layers' blocks (olmoe-1b-7b's decode_flash
    prefill_32k cell traced 11.16 GiB so, 3.69 with the copy)."""
    kv = torch.randn(n, 8, 2, 4)
    cut = A.CacheCut(1, 2, 1, False)
    got = A.cache_rest(None, kv, cut)
    assert torch.equal(got, kv[:, 4:])
    assert got.untyped_storage().data_ptr() != kv.untyped_storage().data_ptr()
    assert got.untyped_storage().nbytes() == got.numel() * got.element_size()
