"""The port's serve programs partitioned over a mesh (``serve.step``'s
partitioned prefill and decode steps, ``launch.serve.pad_cache`` and
``generate`` on a mesh), on virtual CPU meshes, against the reference's
GSPMD serve programs on fake host devices.

The reference runs in one subprocess on 4 fake host devices
(``test_torch_spmd.run_reference``): ``jax.jit`` of its prefill step and
decode step with the logits returned beside the next tokens
(``lm.prefill_fn``, ``lm.decode_fn`` and the greedy head of
``serve.step``), their arguments and the cache laid out by
``launch.programs._ns_tree`` under ``ShardingCtx.for_mesh``. Cases: the
smoke configs of smollm-135m, h2o-danube-3-4b (its sliding-window ring),
olmoe-1b-7b (the dense dispatch under ``baseline``, and ``moe_impl="a2a"``
under ``moe_a2a``) and llama4-scout (a shared expert), f32 compute, on
(2, 2) and (1, 2); batch 4 x prompt 32, and prompt 27, where the
sequence does not divide and the rules cut the cache's kv heads, or
nothing; the VLM's smoke config (its gates drawn away from 0 in the
reference's weights: at tanh(0) = 0 the cross layers would hide every
fault) on (2, 2), (1, 2) and (1, 4), where its 2 kv heads do not split
and the attention repeats, and at prompt 27; whisper's on (2, 2) and
(1, 2), at prompt 27, and with a vocabulary of 255 rows, which splits
over no axis (whisper-small's 51865 neither): its embedding and logits
repeat in every cell; rwkv6's on (2, 2), (1, 2) and (1, 4); zamba2's on
(2, 2), (1, 2), (1, 4) and at prompt 27, where the SSD pads, and with
``ssm_head_dim`` 64: its 2 SSD heads split over no axis of (1, 4), so the
Mamba2 blocks repeat while the conv state's 160 channels split. The
VLM's image and whisper's frame embeddings are drawn by numpy from a
seed at scale 0.02 and rounded to bfloat16 in both packages, cut over
the data axes by ``lm.input_specs``' specs. The weights drawn by the
reference and carried over; the cache padded for 4 generated tokens (the
reference re-lays it to the decode program's specs with
``jax.device_put``), then 3 decode steps fed the same tokens. Held at
each step: every cell's shard indices of every cache leaf (the self k
and v, the VLM's image KV, whisper's cross KV, the recurrent states),
exactly (``devices_indices_map``); the logits within 1e-4 x max(1,
max|ref|); every cache shard against the reference's device shard at the
same mesh position: a bfloat16 leaf to one rounding
(``assert_same_rounding``), an f32 one (the WKV and SSD states, an f32
run's token shifts) within 1e-4 x max(1, max|ref|); the next tokens,
equal.

In the port alone: the partitioned serve against the port's own
unpartitioned serve in f32; ``generate`` on a virtual mesh giving the
null context's ids; the flash calls of a prefill on each cell's heads
(olmoe's smoke; the VLM's self and cross layers, whisper's encoder,
decoder and cross attention) and on all heads (smollm's, whose 3 heads
do not split), rwkv6's WKV6 and zamba2's SSD and flash calls on each
cell's heads; no decode step gathers a tensor of a cache shard's size
(``spmd.observe``) but zamba2's conv state, and ``pad_cache`` never
assembles the whole cache; and ten planted breaches, each refused by the
reference differential: the attention's exit without its psum, the new
token written into every cell's block, each cell's own argmax without
the group's combine, the cross KV written with every kv head in every
cell, the cross attention's exit in a decode step without its psum,
whisper's encoder output taken before its last exit's sum, rwkv6's
decode ``ln_x`` and zamba2's decode gated norm over the cell's channels
alone, rwkv6's ``last_cmix`` taken before the time mix's exit is summed,
and zamba2's conv state written as the cell's heads' channels.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.distributed import spmd  # noqa: E402
from repro_torch.distributed.sharding import (MeshArray,  # noqa: E402
                                              ShardingCtx, place)
from repro_torch.distributed.resharding import normalize_index  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import mamba2 as MB  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models import rwkv as RW  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import step as S  # noqa: E402
from test_torch_mesh_train import counted_flash, virtual  # noqa: E402,F401
from test_torch_tensor_parallel import (counted_cross_flash,  # noqa: E402,F401
                                        counted_ssd, counted_wkv6)
from test_torch_rwkv import assert_close  # noqa: E402
from test_torch_spmd import run_reference  # noqa: E402
from test_torch_zamba2 import assert_same_rounding  # noqa: E402

SMOLLM, DANUBE = "smollm-135m", "h2o-danube-3-4b"
OLMOE, SCOUT = "olmoe-1b-7b", "llama4-scout-17b-a16e"
VLM, WHISPER = "llama-3.2-vision-11b", "whisper-small"
RWKV, ZAMBA = "rwkv6-7b", "zamba2-7b"
B, PROMPT, GEN, SEED = 4, 32, 4, 5
STEPS = GEN - 1
ODD_VOCAB = 255  # whisper's: split over no axis, as whisper-small's 51865
# zamba2's: 2 SSD heads, which do not split over (1, 4), while the conv
# state's 160 channels do
WIDE_HEADS = {"ssm_head_dim": 64}
# (arch, moe_impl, (data, model), prompt[, vocabulary or the config's
# fields replaced])
CASES = (
    (SMOLLM, "dense", (2, 2), PROMPT), (SMOLLM, "dense", (1, 2), PROMPT),
    (SMOLLM, "dense", (2, 2), 27),
    (DANUBE, "dense", (2, 2), PROMPT), (DANUBE, "dense", (1, 2), PROMPT),
    (OLMOE, "dense", (2, 2), PROMPT), (OLMOE, "dense", (1, 2), PROMPT),
    (OLMOE, "dense", (2, 2), 27),
    (OLMOE, "a2a", (2, 2), PROMPT), (OLMOE, "a2a", (1, 2), PROMPT),
    (SCOUT, "dense", (2, 2), PROMPT), (SCOUT, "dense", (1, 2), PROMPT),
    (VLM, "dense", (2, 2), PROMPT), (VLM, "dense", (1, 2), PROMPT),
    (VLM, "dense", (1, 4), PROMPT), (VLM, "dense", (2, 2), 27),
    (WHISPER, "dense", (2, 2), PROMPT), (WHISPER, "dense", (1, 2), PROMPT),
    (WHISPER, "dense", (2, 2), 27),
    (WHISPER, "dense", (2, 2), PROMPT, ODD_VOCAB),
    (RWKV, "dense", (2, 2), PROMPT), (RWKV, "dense", (1, 2), PROMPT),
    (RWKV, "dense", (1, 4), PROMPT),
    (ZAMBA, "dense", (2, 2), PROMPT), (ZAMBA, "dense", (1, 2), PROMPT),
    (ZAMBA, "dense", (1, 4), PROMPT), (ZAMBA, "dense", (2, 2), 27),
    (ZAMBA, "dense", (1, 4), PROMPT, WIDE_HEADS),
)


def replaced(case) -> dict:
    """The case's config fields replaced: none, its vocabulary, or
    ``WIDE_HEADS``."""
    extra = (case[4:] or ({},))[0]
    return extra if isinstance(extra, dict) else {"vocab_size": extra}


def variant(case) -> str:
    """The case's model: its arch, and each field replaced (a vocabulary
    as ``vocab<n>``)."""
    return case[0] + "".join(
        f"/{'vocab' if k == 'vocab_size' else k}{v}"
        for k, v in sorted(replaced(case).items()))


VARIANTS = [(name, arch, dict(fields)) for name, arch, fields in sorted(
    {(variant(c), c[0], tuple(sorted(replaced(c).items()))) for c in CASES})]


def key(case) -> str:
    arch, impl, (d, m), prompt = case[:4]
    return f"{variant(case)}/{impl}/{d}x{m}/{prompt}"


def config(case):
    """The case's smoke config (its fields replaced where set)."""
    return dataclasses.replace(registry.get(case[0]).smoke, **replaced(case))


def embeds() -> dict:
    """Each arch's stub embeddings (the VLM's image, whisper's frame
    embeddings), drawn at scale 0.02 from the seed in float32; both
    packages round them to bfloat16."""
    rng = np.random.default_rng(SEED + 1)
    out = {}
    for arch in sorted({c[0] for c in CASES}):
        cfg = registry.get(arch).smoke
        n = {"vlm": cfg.num_image_tokens, "audio": cfg.encoder_seq}.get(
            cfg.family)
        if n is not None:
            name = "image_embeds" if cfg.family == "vlm" else "frame_embeds"
            out[arch] = {name: (0.02 * rng.standard_normal(
                (B, n, cfg.d_model))).astype(np.float32)}
    return out


def by_path(tree, prefix=""):
    """(dotted path, leaf) of every leaf of a nested dict."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from by_path(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def at_path(tree, path):
    for k in path.split("."):
        tree = tree[k]
    return tree


def with_leaves(tree, fn, prefix=""):
    """``tree`` with each leaf ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: with_leaves(v, fn, f"{prefix}{k}.")
                for k, v in tree.items()}
    return fn(prefix[:-1], tree)


REF_SERVE = """
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

import dataclasses

def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree

def keep(prefix, cache):
    for path, leaf in leaves(cache):
        data, idx = shards(leaf, leaf.shape)
        out[f"{prefix}/{path}/shards"] = data
        out[f"{prefix}/{path}/indices"] = idx

def padded(tree, name=None):
    # only the self k and v grow, on their sequence axis (third from last)
    if isinstance(tree, dict):
        return {k: padded(v, k) for k, v in tree.items()}
    x = np.asarray(tree)
    if name not in ("k", "v"):
        return x
    padw = [(0, 0)] * x.ndim
    padw[-3] = (0, inp["gen"])
    return np.pad(x, padw)

def config(arch, fields):
    return dataclasses.replace(registry.get(arch).smoke, **fields)

rng = np.random.default_rng(inp["seed"])
for name, arch, fields in inp["variants"]:
    cfg = config(arch, fields)
    params = P.materialize(lm.param_specs(cfg),
                           jax.random.PRNGKey(inp["seed"]), dtype="float32")
    if cfg.family == "vlm":  # the gates drawn away from 0
        cross = params["stack"]["cross"]
        for gate in ("gate_attn", "gate_mlp"):
            shape = np.shape(cross[gate])
            cross[gate] = (rng.uniform(0.5, 1.5, shape) * rng.choice(
                [-1, 1], shape)).astype(np.float32)
    out[f"{name}/params"] = params

for (arch, impl, (d, m), prompt, fields), name, key in zip(
        inp["cases"], inp["names"], inp["keys"]):
    b = registry.get(arch)
    cfg = config(arch, fields)
    run = b.run.replace(compute_dtype="float32", moe_impl=impl)
    mesh = make_host_mesh(d, m)
    ctx = ShardingCtx.for_mesh(mesh, "moe_a2a" if impl == "a2a" else
                               "baseline")
    toks = inp["tokens"] % cfg.vocab_size
    params = jax.device_put(out[f"{name}/params"],
                            _ns_tree(lm.param_specs(cfg), ctx))
    stub = {k: jnp.asarray(v).astype(jnp.bfloat16)
            for k, v in inp["embeds"].get(arch, {}).items()}

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
            params, jax.device_put({"tokens": toks[:, :prompt], **stub},
                                   in_ns))
    out[f"{key}/prefill/tok"], out[f"{key}/prefill/logits"] = tok, logits
    keep(f"{key}/prefill", cache)
    if not cfg.sliding_window:
        cache = padded(cache)
    cache = jax.device_put(cache, dec_ns)
    keep(f"{key}/padded", cache)
    step = jax.jit(decode, out_shardings=(None, dec_ns, None))
    for i in range(inp["steps"]):
        t = prompt + i
        with mesh:
            tok, cache, logits = step(params, cache, {
                "tokens": jnp.asarray(toks[:, t:t + 1]),
                "pos": jnp.int32(t)})
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
    return run_reference(REF_SERVE, {
        "variants": VARIANTS,
        "cases": [(*c[:4], replaced(c)) for c in CASES],
        "names": [variant(c) for c in CASES], "keys": [key(c) for c in CASES],
        "embeds": embeds(), "seed": SEED, "tokens": tokens(), "gen": GEN,
        "steps": STEPS}, 4)


def setup(case, reference):
    """(cfg, run, ctx, the reference's weights laid out over the case's
    virtual mesh)."""
    arch, impl, (d, m), _ = case[:4]
    b = registry.get(arch)
    run = b.run.replace(compute_dtype="float32", moe_impl=impl)
    ctx = ShardingCtx.for_mesh(virtual(d, m),
                               "moe_a2a" if impl == "a2a" else "baseline")
    prm = P.from_reference(reference[f"{variant(case)}/params"], "cpu")
    return config(case), run, ctx, prm


def serve_steps(cfg, run, ctx, prm, prompt, feed=None):
    """The partitioned prefill, the cache padded for GEN tokens, and
    STEPS decode steps fed the same tokens as the reference's: [(name,
    next tokens, cache, logits)]. ``feed(name, cache)``: the cache that
    the decode step after step ``name`` starts from, in place of the
    step's own (a bfloat16 rounding flip in a cache moves the next
    logits past 1e-4; each decode step is held from the same cache)."""
    toks = torch.from_numpy(tokens()) % cfg.vocab_size
    prefill = S.make_prefill_step(cfg, run, ctx)
    decode = S.make_decode_step(cfg, run, ctx)
    if ctx.mesh is not None:
        prm = S.laid_out(cfg, ctx, prm)
    tok, cache, logits = prefill(prm, {"tokens": toks[:, :prompt],
                                       **stub_embeds(cfg)}, logits=True)
    out = [("prefill", tok, cache, logits)]
    cache = serve.pad_cache(cfg, cache, GEN)
    out.append(("padded", None, cache, None))
    for i in range(STEPS):
        t = prompt + i
        if feed is not None:
            cache = feed(out[-1][0], cache)
        tok, cache, logits = decode(prm, cache, {
            "tokens": toks[:, t:t + 1], "pos": t}, logits=True)
        out.append((f"decode{i}", tok, cache, logits))
    return out


def stub_embeds(cfg) -> dict:
    """``embeds()`` of the arch whose smoke config ``cfg`` is (its
    vocabulary aside), in bfloat16."""
    arch = next(c[0] for c in CASES
                if registry.get(c[0]).smoke.name == cfg.name)
    return {k: torch.from_numpy(v).to(torch.bfloat16)
            for k, v in embeds().get(arch, {}).items()}


def from_reference(reference, k):
    """``serve_steps``' ``feed``: the reference's cache after the step,
    each cell's shard its device's, laid out as the port's, in the
    port's dtype of each leaf (the f32 recurrent states of an f32 run)."""
    def feed(name, cache):
        return with_leaves(cache, lambda path, t: MeshArray(
            t.shape, t.dtype, t.sharding,
            [torch.from_numpy(w).to(t.dtype)
             for w in reference[f"{k}/{name}/{path}/shards"]]))

    return feed


def same_leaf(got, want, what):
    """A cache leaf held as its dtype says: a bfloat16 leaf (a KV cache,
    the conv state) to one rounding (``assert_same_rounding``), any other
    (the f32 recurrent states, and the token shifts of an f32 run) within
    1e-4 x max(1, max|want|)."""
    if got.dtype == torch.bfloat16:
        assert_same_rounding(got, want, what)
    else:
        assert_close(got, want, 1e-4, what)


def gaps(steps, reference, k) -> list:
    """What of ``steps`` (``serve_steps``) differs from the reference's
    case ``k``: each failed hold's message."""
    bad = []

    def hold(fn, *args):
        try:
            fn(*args)
        except AssertionError as e:
            bad.append(str(e)[:200])

    for name, tok, cache, logits in steps:
        at = f"{k}/{name}"
        for leaf, got in by_path(cache):
            if not isinstance(got, MeshArray):
                bad.append(f"{at} {leaf}: not a MeshArray")
                continue
            want_idx = json.loads(str(reference[f"{at}/{leaf}/indices"]))
            got_idx = [[list(p) for p in normalize_index(index, got.shape)]
                       for _, index, _ in got.addressable_shards]
            if got_idx != want_idx:
                bad.append(f"{at} {leaf}: indices {got_idx} != {want_idx}")
                continue
            for pos, (g, w) in enumerate(zip(got.shards, reference[
                    f"{at}/{leaf}/shards"], strict=True)):
                hold(same_leaf, g, w, f"{at} {leaf} cell {pos}")
        if logits is None:
            continue
        hold(assert_close, logits, reference[f"{at}/logits"], 1e-4,
             f"{at} logits")
        if not np.array_equal(tok.numpy(), reference[f"{at}/tok"]):
            bad.append(f"{at}: next tokens {tok.tolist()} != "
                       f"{reference[f'{at}/tok'].tolist()}")
    return bad


@pytest.mark.parametrize("case", CASES, ids=key)
def test_partitioned_serve_matches_reference_on_its_mesh(reference, case):
    cfg, run, ctx, prm = setup(case, reference)
    assert S.partitioned(cfg, run, ctx)
    steps = serve_steps(cfg, run, ctx, prm, case[3],
                        from_reference(reference, key(case)))
    assert gaps(steps, reference, key(case)) == []
    # the rules cut the self cache's sequence where it divides, else its
    # kv heads where they divide, else neither; the cross KV's kv heads
    # where they divide; a recurrent state's heads where they divide, the
    # conv state's channels where they divide, the token shifts never
    m = case[2][1]
    kv = S._self_kv(steps[0][2])
    if kv is not None:
        spec = last4(kv)
        if case[3] % m == 0:
            assert spec[1:3] == ("model", None), spec
        elif cfg.num_kv_heads % m == 0:
            assert spec[1:3] == (None, "model"), spec
        else:
            assert "model" not in spec, spec
    for path, t in by_path(steps[0][2]):
        spec = tuple(t.sharding.spec) + (None,) * t.ndim
        dim = {"wkv": 2, "ssm": 2, "conv": 3}.get(path.split(".")[-1])
        if dim is not None:
            assert (spec[dim] == "model") == (t.shape[dim] % m == 0), \
                (path, spec)
        elif path.split(".")[-1].startswith("last_"):
            assert "model" not in spec, (path, spec)
    ck = S._cross_kv(steps[0][2])
    if ck is not None:
        heads = "model" if cfg.num_kv_heads % m == 0 else None
        assert last4(ck)[1:3] == (None, heads), last4(ck)


def last4(t: MeshArray) -> tuple:
    """The spec entries of a cache leaf's (batch, sequence, heads,
    head_dim) dims."""
    return (tuple(t.sharding.spec) + (None,) * t.ndim)[t.ndim - 4:t.ndim]


@pytest.mark.parametrize("case", [c for c in CASES if c[1] == "dense"],
                         ids=key)
def test_partitioned_serve_matches_the_whole_one(reference, case):
    """The partitioned steps against the port's own unpartitioned ones,
    from the same weights and tokens, each decode step from the whole
    serve's cache: logits within 1e-4 x max(1, max|whole|), each cache
    gathered to one bfloat16 rounding, the same next tokens."""
    cfg, run, ctx, prm = setup(case, reference)
    want = serve_steps(cfg, run, ShardingCtx.null(), prm, case[3])
    whole = {name: cache for name, _, cache, _ in want}

    def feed(name, cache):  # the whole serve's cache, laid out as this one
        return with_leaves(cache, lambda path, t: place(
            at_path(whole[name], path), t.sharding))

    got = serve_steps(cfg, run, ctx, prm, case[3], feed)
    for (name, tok, cache, logits), (_, wtok, wcache, wlogits) in zip(
            got, want, strict=True):
        for leaf, t in by_path(cache):
            same_leaf(t.gather(), at_path(wcache, leaf).float(),
                      f"{name} {leaf}")
        if logits is not None:
            assert_close(logits, wlogits, 1e-4, f"{name} logits")
            assert torch.equal(tok, wtok), name


@pytest.mark.parametrize("arch", [SMOLLM, OLMOE, VLM, WHISPER, RWKV, ZAMBA])
def test_generate_on_a_virtual_mesh_gives_the_null_contexts_ids(reference,
                                                                 arch):
    cfg, run, ctx, prm = setup((arch, "dense", (2, 2), PROMPT), reference)
    batch = {"tokens": torch.from_numpy(tokens()[:, :PROMPT]),
             **stub_embeds(cfg)}
    want, _ = serve.generate(cfg, run, prm, batch, 6)
    got, times = serve.generate(cfg, run, prm, batch, 6, ctx)
    assert got.shape == (B, 6) and np.array_equal(got, want)
    assert times["prefill_s"] > 0


@pytest.mark.parametrize("arch,heads", [(OLMOE, "cell"), (SMOLLM, "all")])
def test_prefill_flash_calls_run_on_the_cells_heads(reference, counted_flash,
                                                    arch, heads):
    """Every cell of (2, 2) calls flash once a layer on its 2 rows: on its
    own heads where they split over ``model`` (olmoe's 4 over 2), on all
    of them where they do not (smollm's 3)."""
    cfg, run, ctx, prm = setup((arch, "dense", (2, 2), PROMPT), reference)
    prefill = S.make_prefill_step(cfg, run, ctx)
    prefill(S.laid_out(cfg, ctx, prm),
            {"tokens": torch.from_numpy(tokens()[:, :PROMPT])})
    h = cfg.num_heads // (2 if heads == "cell" else 1)
    assert S.make_prefill_step(cfg, run, ctx).plan_at(
        {"tokens": torch.zeros(B, PROMPT)}).attn == (heads == "cell")
    assert counted_flash == [(B // 2, PROMPT, h, cfg.head_dim)] * (
        4 * cfg.num_layers)


@pytest.mark.parametrize("arch", [VLM, WHISPER])
def test_cross_families_prefill_flash_calls_run_on_the_cells_heads(
        reference, counted_cross_flash, arch):
    """Every cell of (2, 2) calls flash on its 2 rows, its 2 of the 4 q
    heads and its kv heads: the VLM's self layers (causal) and cross
    layers (over the image tokens), whisper's encoder (bidirectional, over
    the frames), its decoder's self (causal) and cross attention (over
    the encoder's output); a decode step calls none."""
    cfg, run, ctx, prm = setup((arch, "dense", (2, 2), PROMPT), reference)
    prm = S.laid_out(cfg, ctx, prm)
    tok, cache = S.make_prefill_step(cfg, run, ctx)(prm, {
        "tokens": torch.from_numpy(tokens()[:, :PROMPT]),
        **stub_embeds(cfg)})
    rows, h, kv, D = B // 2, cfg.num_heads // 2, cfg.num_kv_heads // 2, \
        cfg.head_dim
    q = (rows, PROMPT, h, D)
    self_call = (q, (rows, PROMPT, kv, D), True)
    if cfg.family == "vlm":
        g, s = T._vlm_groups(cfg)
        cross = (q, (rows, cfg.num_image_tokens, kv, D), False)
        want = [self_call] * (4 * g * s) + [cross] * (4 * g)
    else:
        n = cfg.encoder_seq
        enc = ((rows, n, h, D), (rows, n, kv, D), False)
        cross = (q, (rows, n, kv, D), False)
        want = [enc] * (4 * cfg.encoder_layers) + [self_call, cross] * (
            4 * cfg.num_layers)
    assert sorted(counted_cross_flash) == sorted(want)
    S.make_decode_step(cfg, run, ctx)(prm, serve.pad_cache(cfg, cache, 1), {
        "tokens": tok[:, None], "pos": PROMPT})
    assert len(counted_cross_flash) == len(want)


def decode_collectives(case, reference, monkeypatch):
    """(each collective's label and the shape of the tensor it returned
    in STEPS decode steps of ``case``'s partitioned serve: a weight's
    gather labelled with the leaf's path, the conv state's ``conv``, any
    other None (zamba2's gather of ``w_in`` in the tape too); the cache
    padded by ``pad_cache`` with ``MeshArray.gather`` refused)."""
    cfg, run, ctx, prm = setup(case, reference)
    prm = S.laid_out(cfg, ctx, prm)
    toks = torch.from_numpy(tokens())
    _, cache = S.make_prefill_step(cfg, run, ctx)(
        prm, {"tokens": toks[:, :PROMPT], **stub_embeds(cfg)})

    def refuse(*a, **kw):
        raise AssertionError("a MeshArray assembled whole")

    with monkeypatch.context() as mp:
        mp.setattr(MeshArray, "gather", refuse)
        cache = serve.pad_cache(cfg, cache, GEN)
    seen = []

    def note(op, out, g, cell, *, axes, label):
        seen.append((label, tuple(out.shape)))

    decode = S.make_decode_step(cfg, run, ctx)
    with spmd.observe(note):
        for i in range(STEPS):
            decode(prm, cache, {"tokens": toks[:, PROMPT + i:PROMPT + i + 1],
                                "pos": PROMPT + i})
    assert seen, "no collective in a decode step"
    return seen, cache


def largest_and_layer_shard(seen, cache):
    """(the largest tensor an unlabelled collective returned, the
    smallest shard that a cell holds of one layer's cache leaf)."""
    layer_shard = min(t.shards[0].numel() // int(np.prod(t.shape[:-4]))
                      for _, t in by_path(cache))
    return max(int(np.prod(n)) for label, n in seen if label is None), \
        layer_shard


def test_no_cell_gathers_the_whole_cache(reference, monkeypatch):
    """In every decode step each collective that is not a weight's gather
    returns less than one layer's cache shard; ``pad_cache`` re-lays the
    cache without assembling it anywhere."""
    largest, layer_shard = largest_and_layer_shard(*decode_collectives(
        (OLMOE, "dense", (2, 2), PROMPT), reference, monkeypatch))
    assert largest < layer_shard, (largest, layer_shard)


@pytest.mark.parametrize("arch", [VLM, WHISPER])
def test_no_cell_gathers_a_cache_or_the_cross_kv(reference, monkeypatch,
                                                 arch):
    """The cross families as ``test_no_cell_gathers_the_whole_cache``:
    less than one layer's shard of the self cache or of the cross KV,
    whichever is smaller; ``pad_cache`` assembles neither."""
    largest, layer_shard = largest_and_layer_shard(*decode_collectives(
        (arch, "dense", (2, 2), PROMPT), reference, monkeypatch))
    assert largest < layer_shard, (largest, layer_shard)


@pytest.mark.parametrize("arch", [RWKV, ZAMBA])
def test_no_cell_gathers_a_state_or_the_shared_kv(reference, monkeypatch,
                                                  arch):
    """The recurrent families as ``test_no_cell_gathers_the_whole_cache``:
    each collective of a decode step that is neither a weight's gather
    (zamba2's ``w_in`` gathered over ``model`` in the tape among them)
    nor the conv state's returns less than one layer's shard of any cache
    leaf that ``model`` cuts (rwkv6's WKV state; zamba2's SSD state and
    its shared block's k and v); the conv state, the one cache leaf a
    cell gathers, is gathered by every cell once a layer, each time one
    layer's conv state of the cell's rows; ``pad_cache`` assembles
    nothing."""
    case = (arch, "dense", (2, 2), PROMPT)
    cfg = config(case)
    seen, cache = decode_collectives(case, reference, monkeypatch)
    specs = lm.cache_specs(cfg, ShapeSpec("d", "decode", PROMPT + GEN, B))
    cut = {path: t for path, t in by_path(cache)
           if "model" in str(t.sharding.spec) and not path.endswith("conv")}
    assert cut, "no cache leaf cut over model"
    # a stacked leaf's layers: its leading "layers" dims
    layers = {path: int(np.prod([n for n, name in zip(
        at_path(specs, path).shape, at_path(specs, path).logical)
        if name == "layers"])) for path in cut}
    layer_shard = min(t.shards[0].numel() // layers[path]
                      for path, t in cut.items())
    w_in = (lm.param_specs(cfg)["stack"]["layers"]["w_in"].shape[1:]
            if cfg.family == "hybrid" else None)
    largest = max(int(np.prod(n)) for label, n in seen
                  if label is None and n != w_in)
    assert largest < layer_shard, (largest, layer_shard)
    conv = [n for label, n in seen if label == "conv"]
    if cfg.family == "hybrid":
        _, H, Pd, N = MB.dims(cfg)
        one = (B // 2, cfg.ssm_conv_width - 1, H * Pd + 2 * N)
        # each of the 4 cells, each step, each layer
        assert conv == [one] * (4 * STEPS * cfg.num_layers), conv
        assert [n for label, n in seen if n == w_in] == [w_in] * (
            4 * STEPS * cfg.num_layers)
    else:
        assert conv == []
    assert {label for label, _ in seen} <= {None, "conv", "embed",
                                            "final_ln"} | {
        label for label, _ in seen
        if label is not None and label.startswith("stack")}


@pytest.mark.parametrize("arch", [RWKV, ZAMBA])
def test_recurrent_families_kernel_calls_run_on_the_cells_heads(
        reference, counted_wkv6, counted_ssd, arch):
    """Every cell of (2, 2) calls its family's kernels in a prefill on its
    2 rows and its own heads: rwkv6's WKV6 once a layer on 2 of the 4 WKV
    heads; zamba2's SSD once a layer on 4 of the 8 SSD heads (B and C
    whole) and flash once a shared-block application on 2 of its 4
    heads; a decode step calls none."""
    cfg, run, ctx, prm = setup((arch, "dense", (2, 2), PROMPT), reference)
    prm = S.laid_out(cfg, ctx, prm)
    ssd_calls, flash_calls = counted_ssd
    tok, cache = S.make_prefill_step(cfg, run, ctx)(prm, {
        "tokens": torch.from_numpy(tokens()[:, :PROMPT])})
    rows, L = B // 2, cfg.num_layers
    if cfg.family == "ssm":
        K = cfg.wkv_head_dim
        want = ([((rows, PROMPT, cfg.d_model // K // 2, K),
                  cfg.scan_chunk)] * (4 * L), [], [])
    else:
        _, H, Pd, N = MB.dims(cfg)
        want = ([], [((rows, PROMPT, H // 2, Pd), (rows, PROMPT, N),
                      cfg.scan_chunk)] * (4 * L),
                [(rows, PROMPT, cfg.num_heads // 2, cfg.head_dim)] * (
                    4 * MB.n_shared_applications(cfg)))
    got = (list(counted_wkv6), list(ssd_calls), list(flash_calls))
    assert got == want
    S.make_decode_step(cfg, run, ctx)(prm, serve.pad_cache(cfg, cache, 1), {
        "tokens": tok[:, None], "pos": PROMPT})
    assert (list(counted_wkv6), list(ssd_calls), list(flash_calls)) == got


def _attention_exit_without_psum(monkeypatch):
    real = T._attn_half

    def breached(cfg, ctx, tc, *a, **kw):
        tc.tape.exit = lambda x, axis="model": x
        try:
            return real(cfg, ctx, tc, *a, **kw)
        finally:
            del tc.tape.exit

    monkeypatch.setattr(T, "_attn_half", breached)


def _token_written_into_every_block(monkeypatch):
    real = A.cell_decode

    def breached(tape, q, k, v, ck, cv, pos, cut, **kw):
        if cut.dim == 1:
            kk, vv = ((tape.all_gather(t, "model", 2) for t in (k, v))
                      if cut.local else (k, v))
            ck, cv = A.cache_update(ck, cv, kk, vv, pos % ck.shape[1])
        return real(tape, q, k, v, ck, cv, pos, cut, **kw)

    monkeypatch.setattr(A, "cell_decode", breached)


def _own_argmax(monkeypatch):
    def breached(cfg, tc, logits):
        lo = tc.block(cfg.vocab_size)[0] if tc.plan.vocab else 0
        return (torch.argmax(logits, dim=-1) + lo).to(torch.int32)

    monkeypatch.setattr(S, "_greedy", breached)


def _cross_kv_in_every_cell(monkeypatch):
    real = T._xattn_half

    def breached(cfg, ctx, tc, *a, kv=None, **kw):
        out = real(cfg, ctx, tc, *a, kv=kv, **kw)
        if kv is None or not tc.plan.xattn:
            return out
        x, adds, (k, v) = out
        return x, adds, tuple(tc.tape.all_gather(t, "model", 2)
                              for t in (k, v))

    monkeypatch.setattr(T, "_xattn_half", breached)


def _cross_decode_exit_without_psum(monkeypatch):
    real = T._xattn_half

    def breached(cfg, ctx, tc, wl, x, adds, src, *a, **kw):
        if not isinstance(src, tuple):  # a prefill's
            return real(cfg, ctx, tc, wl, x, adds, src, *a, **kw)
        tc.tape.exit = lambda x, axis="model": x
        try:
            return real(cfg, ctx, tc, wl, x, adds, src, *a, **kw)
        finally:
            del tc.tape.exit

    monkeypatch.setattr(T, "_xattn_half", breached)


def _decode_total_skipped(module, name):
    """A breach: ``module.name`` (a half on a tape) in a decode step
    (``state`` or ``last`` given) with ``Tape.total`` the identity: each
    cell's sum of squares of its own channels alone."""
    def breach(monkeypatch):
        real = getattr(module, name)

        def breached(cfg, ctx, tc, *a, **kw):
            if kw.get("state") is None:
                return real(cfg, ctx, tc, *a, **kw)
            tc.tape.total = lambda x, axis="model": x
            try:
                return real(cfg, ctx, tc, *a, **kw)
            finally:
                del tc.tape.total

        monkeypatch.setattr(module, name, breached)

    breach.__name__ = f"_{name}_decode_norm_over_the_cells_channels"
    return breach


def _last_cmix_before_the_time_mix(monkeypatch):
    real = RW._cmix_half

    def breached(cfg, ctx, tc, wl, x, adds, **kw):
        out = real(cfg, ctx, tc, wl, x, adds, **kw)
        if len(out) < 3:
            return out
        return (*out[:2], x[:, -1])  # the residual before the exit's sum

    monkeypatch.setattr(RW, "_cmix_half", breached)


def _conv_of_the_cells_heads(monkeypatch):
    real = MB._conv_rest

    def breached(cfg, conv, cut):
        if cut is None or not cut.conv:
            return real(cfg, conv, cut)
        d_inner, H, Pd, N = MB.dims(cfg)
        n = H // cut.size
        lo = cut.index * n
        mine = MB._pick(conv, ((lo * Pd, (lo + n) * Pd),
                               (d_inner, d_inner + 2 * N)))
        # as many of those channels as the block holds
        return real(cfg, mine, None)[..., :conv.shape[-1] // cut.size]

    monkeypatch.setattr(MB, "_conv_rest", breached)


@pytest.mark.parametrize("breach,arch", [
    (_decode_total_skipped(RW, "_tmix_half"), RWKV),
    (_last_cmix_before_the_time_mix, RWKV),
    (_conv_of_the_cells_heads, ZAMBA),
    (_decode_total_skipped(MB, "_mamba_half"), ZAMBA)],
    ids=lambda b: getattr(b, "__name__", b))
def test_recurrent_planted_breaches_fail_the_reference_differential(
        reference, monkeypatch, breach, arch):
    """Each breach of rwkv6's and zamba2's partitioned serve is refused by
    the reference differential that the sound code passes: rwkv6's
    decode ``ln_x`` and zamba2's decode gated norm over the cell's
    channels alone (no ``Tape.total``), rwkv6's ``last_cmix`` taken
    before the time mix's exit is summed, zamba2's conv state written as
    the cell's heads' x, B and C channels instead of its even block."""
    case = (arch, "dense", (2, 2), PROMPT)
    cfg, run, ctx, prm = setup(case, reference)
    breach(monkeypatch)
    assert gaps(serve_steps(cfg, run, ctx, prm, PROMPT,
                            from_reference(reference, key(case))),
                reference, key(case))


def _encoder_output_before_its_last_sum(monkeypatch):
    from repro_torch.models import audio as AU

    real = AU._enc_segments

    def breached(cfg, run, ctx, tc, *a, **kw):
        tape = tc.tape
        tape.enc_layers = getattr(tape, "enc_layers", 0) + 1
        if tape.enc_layers < cfg.encoder_layers:
            return real(cfg, run, ctx, tc, *a, **kw)
        exits, sound = [], tape.exit

        def exit(x, axis="model"):  # the MLP half's, the layer's last
            exits.append(x)
            return sound(x, axis) if len(exits) == 1 else x

        tape.exit = exit
        try:
            return real(cfg, run, ctx, tc, *a, **kw)
        finally:
            del tape.exit

    monkeypatch.setattr(AU, "_enc_segments", breached)


@pytest.mark.parametrize("breach,arch", [
    (_cross_kv_in_every_cell, VLM), (_cross_kv_in_every_cell, WHISPER),
    (_cross_decode_exit_without_psum, VLM),
    (_cross_decode_exit_without_psum, WHISPER),
    (_encoder_output_before_its_last_sum, WHISPER)])
def test_cross_planted_breaches_fail_the_reference_differential(
        reference, monkeypatch, breach, arch):
    """Each breach of the cross families' partitioned serve is refused by
    the reference differential that the sound code passes
    (``test_partitioned_serve_matches_reference_on_its_mesh``)."""
    case = (arch, "dense", (2, 2), PROMPT)
    cfg, run, ctx, prm = setup(case, reference)
    breach(monkeypatch)
    assert gaps(serve_steps(cfg, run, ctx, prm, PROMPT,
                            from_reference(reference, key(case))),
                reference, key(case))


@pytest.mark.parametrize("breach", [_attention_exit_without_psum,
                                    _token_written_into_every_block,
                                    _own_argmax])
def test_planted_breaches_fail_the_reference_differential(reference,
                                                          monkeypatch,
                                                          breach):
    case = (OLMOE, "dense", (2, 2), PROMPT)
    cfg, run, ctx, prm = setup(case, reference)
    breach(monkeypatch)
    assert gaps(serve_steps(cfg, run, ctx, prm, PROMPT,
                            from_reference(reference, key(case))),
                reference, key(case))


@pytest.mark.parametrize("arch,shape,mesh,ruleset,partitioned", [
    (SMOLLM, "prefill_32k", "single", "baseline", True),
    (DANUBE, "decode_32k", "multi", "baseline", True),
    (OLMOE, "decode_32k", "single", "moe_a2a", True),
    (SCOUT, "prefill_32k", "multi", "baseline", True),
    (SMOLLM, "prefill_32k", "single", "decode_flash", True),
    (OLMOE, "decode_32k", "single", "decode_flash", True),
    ("whisper-small", "prefill_32k", "single", "decode_flash", False),
    ("llama-3.2-vision-11b", "decode_32k", "single", "baseline", True),
    ("llama-3.2-vision-11b", "prefill_32k", "multi", "baseline", True),
    ("whisper-small", "prefill_32k", "multi", "baseline", True),
    ("whisper-small", "decode_32k", "single", "baseline", True),
    ("rwkv6-7b", "decode_32k", "single", "baseline", True),
    ("zamba2-7b", "prefill_32k", "single", "baseline", True),
    (SMOLLM, "prefill_32k", "single", "seqpar", False)])
def test_dryrun_traces_a_partitioned_serve_cell(tmp_path, arch, shape, mesh,
                                                ruleset, partitioned):
    """On the reference's meshes a serve cell of any family under the
    ``baseline`` or ``moe_a2a`` rules, and of the dense and MoE families
    under ``decode_flash``, is traced as its first cell alone: its
    collectives counted by axes, none left unissued; the ``seqpar``
    ruleset, and the other families under ``decode_flash``, still serve
    the model whole in their data cell and name the collectives GSPMD
    would insert."""
    from repro_torch.launch import dryrun

    r = dryrun.run_cell(arch, shape, mesh, ruleset, str(tmp_path),
                        smoke=True)
    assert r["ok"], r.get("error")
    axes = r["ops"]["per_axes"]
    if partitioned:
        assert r["collectives_not_issued"] is None
        assert any(k.endswith("over model") for k in axes), axes
        assert any("data" in k for k in axes), axes
    else:
        assert r["collectives_not_issued"] == dryrun.NOT_ISSUED
        assert r["per_device_bytes"]["repeated_over_model"] == [
            "every block"]
