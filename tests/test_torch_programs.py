"""The port's programs (``repro_torch.launch.programs``) and their
FLOP counts (``launch.op_analysis``) against the reference's
(``repro.launch.programs``, ``repro.launch.hlo_analysis``).

``build_program`` of every arch id's smoke config at ``train_4k``,
``prefill_32k`` and ``decode_32k``: the meta dict, the program's name and
donated arguments, and every argument leaf's key path, shape and dtype,
exactly. The FLOPs: the port's programs traced on meta tensors (the
card's path: each kernel through its operator) and on fake CPU tensors
(the plain path), against ``hlo_analysis.analyze`` of the reference's
compiled program (``jax.jit(fn).lower(*args).compile()``) on one CPU
device, at small shapes of the same kinds (train 4 x 64, prefill 2 x
64, decode 2 x a 64-slot cache). Tolerances, each with its reason:

  * smollm-135m (dense), llama-3.2-vision-11b, whisper-small: the plain
    path exactly (1e-6 relative) in all three kinds; the card's path
    exactly in prefill and decode, and in training it counts the plain
    path plus one forward of the plain attention for each flash call
    that is differentiated (the recompute backward, ``_FlashAttention``),
    which the plain path and the reference, off the TPU, do not run;
  * olmoe-1b-7b: prefill and decode exactly; training counts, on top of
    the reference, the gradient of the dense combine tensor, one (tokens
    x d) by (d x E C) product a layer, which XLA's compiled program does
    not hold (9.2e-2 relative at this shape, 0.14 at 8 x 256; held below
    0.15);
  * rwkv6-7b: prefill and decode exactly; training within 3e-3 (2.4e-3
    at this shape, 6.0e-4 at 8 x 256): the backward of the plain scan's
    einsums of three and four operands, which autograd differentiates
    along the products torch chose and XLA along the ``dot_general`` s
    that ``jnp.einsum`` chose (the forwards count the same);
  * zamba2-7b: the reference's HLO counts the shared block's conditional
    as taken at every layer (``hlo_analysis.py:12-17``); the port runs it
    where it applies. Held: the reference's count less the port's equals
    the skipped applications' FLOPs, ``(L - n_app)`` times one
    application's, within 1e-6 in prefill and decode.
"""

from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import SHAPES_BY_NAME as JAX_SHAPES  # noqa: E402
from repro.configs import registry as jax_registry  # noqa: E402
from repro.configs.base import ShapeSpec as JaxShape  # noqa: E402
from repro.distributed.sharding import ShardingCtx as JaxCtx  # noqa: E402
from repro.launch import hlo_analysis  # noqa: E402
from repro.launch import programs as jax_programs  # noqa: E402
from repro_torch.configs import SHAPES_BY_NAME, registry  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.distributed.sharding import ShardingCtx  # noqa: E402
from repro_torch.launch import op_analysis, programs  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

SHAPES = ("train_4k", "prefill_32k", "decode_32k")
SMALL = {"train": (64, 4), "prefill": (64, 2), "decode": (64, 2)}


def port_leaves(tree, path=()):
    """{key path: leaf} of a tree of dicts and NamedTuples."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(port_leaves(v, path + (str(k),)))
        return out
    if isinstance(tree, tuple) and hasattr(type(tree), "_fields"):
        out = {}
        for k, v in zip(tree._fields, tree):
            out.update(port_leaves(v, path + (k,)))
        return out
    return {} if tree is None else {path: tree}


def jax_leaves(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        out[tuple(str(getattr(k, "key", getattr(k, "name", getattr(
            k, "idx", k)))) for k in path)] = leaf
    return out


def described(leaves, dtype_name):
    return {k: (tuple(v.shape), dtype_name(v.dtype)) for k, v in leaves.items()}


@pytest.mark.parametrize("arch", jax_registry.arch_ids())
def test_programs_match_reference(arch):
    """Meta, name, donated arguments and every argument leaf (key path,
    shape, dtype) of the port's program against the reference's."""
    pb, jb = registry.get(arch), jax_registry.get(arch)
    for name in SHAPES:
        prog = programs.build_program(pb.smoke, pb.run_for(name),
                                      SHAPES_BY_NAME[name],
                                      ShardingCtx.null())
        ref = jax_programs.build_program(jb.smoke, jb.run_for(name),
                                         JAX_SHAPES[name],
                                         JaxCtx(None, {}))
        assert prog.meta == ref.meta
        assert (prog.name, prog.donate_argnums) == (ref.name,
                                                    ref.donate_argnums)
        assert len(prog.args) == len(ref.args)
        for a, r in zip(prog.args, ref.args):
            got = described(port_leaves(a), lambda d: str(d).split(".")[-1])
            want = described(jax_leaves(r), str)
            assert got == want, (arch, name)
            # meta tensors or host scalars: nothing on a device
            assert all(t.is_meta or t.dim() == 0
                       for t in port_leaves(a).values())


def test_input_specs_and_shardings_on_a_mesh():
    """With a mesh each leaf carries its ``MeshSharding`` (the rules'
    spec); the trainer's sharding trees are ``programs._ns_tree``'s."""
    mesh = make_mesh((2, 2), ("data", "model"), [torch.device("cpu")] * 4)
    ctx = ShardingCtx.for_mesh(mesh)
    b = registry.get("smollm-135m")
    shape = SHAPES_BY_NAME["train_4k"]
    batch, shardings = programs.input_specs(b.smoke, shape, ctx)
    assert tuple(batch["tokens"].shape) == (256, 4096)
    assert batch["tokens"].is_meta
    assert shardings["tokens"].spec == ("data",)
    prog = programs.build_program(b.smoke, b.run, shape, ctx)
    assert trainer._ns_tree is programs._ns_tree
    from repro_torch.models import lm

    want = programs._ns_tree(lm.param_specs(b.smoke), ctx)
    assert prog.arg_shardings[0] == want
    assert prog.out_shardings[0] == want


def _small(kind, name="cell"):
    S, B = SMALL[kind]
    return ShapeSpec(name, kind, S, B), JaxShape(name, kind, S, B)


def port_flops(cfg, run, shape, device="meta"):
    prog = programs.build_program(cfg, run, shape, ShardingCtx.null(),
                                  device=device)
    return op_analysis.analyze(prog.fn, *prog.args)


def reference_flops(cfg, run, shape):
    prog = jax_programs.build_program(cfg, run, shape, JaxCtx(None, {}))
    text = jax.jit(prog.fn).lower(*prog.args).compile().as_text()
    return hlo_analysis.analyze(text).dot_flops


def flash_plain_flops(cfg, shape):
    """One plain attention forward of the cfg at the shape's microbatch
    (the flash operator's FLOP formula)."""
    from repro_torch.kernels import _flops
    from repro_torch.kernels.flash_attention import ref

    B, S = shape.global_batch, shape.seq_len
    q = (B, S, cfg.num_heads, cfg.head_dim)
    kv = (B, S, cfg.num_kv_heads, cfg.head_dim)
    return _flops.plain_flops(ref.attention, (q, kv, kv), causal=True,
                              window=cfg.sliding_window, softcap=0.0)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_dense_flops_match_reference(kind):
    """smollm-135m: the plain path's FLOPs are the reference's within
    1e-6; the card's path's too in prefill and decode, and in training
    the plain path's plus one plain attention forward for each flash
    call that the backward differentiates."""
    b, jb = registry.get("smollm-135m"), jax_registry.get("smollm-135m")
    shape, jshape = _small(kind)
    run = b.run.replace(microbatch_per_data_shard=0)
    jrun = jb.run.replace(microbatch_per_data_shard=0)
    want = reference_flops(jb.smoke, jrun, jshape)
    card = port_flops(b.smoke, run, shape)
    plain = port_flops(b.smoke, run, shape, device="cpu")
    assert plain.dot_flops == pytest.approx(want, rel=1e-6)
    assert plain.kernel_calls == {}
    if kind != "train":
        assert card.dot_flops == pytest.approx(want, rel=1e-6)
        assert card.kernel_calls == ({"flash_attention_fwd":
                                      b.smoke.num_layers}
                                     if kind == "prefill" else {})
        return
    # block remat: the forward and its recompute launch, the recompute's
    # is differentiated: one plain forward a layer in the backward
    calls = card.kernel_calls["flash_attention_fwd"]
    assert calls == 2 * b.smoke.num_layers
    extra = calls // 2 * flash_plain_flops(b.smoke, shape)
    assert card.dot_flops == pytest.approx(plain.dot_flops + extra,
                                           rel=1e-9)


@pytest.mark.parametrize("arch,train_rel", [
    ("llama-3.2-vision-11b", 1e-6), ("whisper-small", 1e-6),
    ("olmoe-1b-7b", 0.15), ("rwkv6-7b", 3e-3)])
def test_family_flops_match_reference(arch, train_rel):
    """Prefill and decode exactly on both paths; training on the plain
    path within the tolerance the module's docstring gives its reason
    for, and the card's path at least the plain path's (it adds the
    recompute forwards)."""
    b, jb = registry.get(arch), jax_registry.get(arch)
    for kind in ("prefill", "decode"):
        shape, jshape = _small(kind)
        want = reference_flops(jb.smoke, jb.run, jshape)
        for device in ("meta", "cpu"):
            got = port_flops(b.smoke, b.run, shape, device).dot_flops
            assert got == pytest.approx(want, rel=1e-6), (kind, device)
    shape, jshape = _small("train")
    run = b.run.replace(microbatch_per_data_shard=0)
    want = reference_flops(jb.smoke, jb.run.replace(
        microbatch_per_data_shard=0), jshape)
    plain = port_flops(b.smoke, run, shape, "cpu").dot_flops
    card = port_flops(b.smoke, run, shape).dot_flops
    assert plain == pytest.approx(want, rel=train_rel)
    assert card >= plain


def test_hybrid_flops_are_the_reference_less_its_untaken_conditional():
    """zamba2-7b: the reference counts the shared block at every layer;
    the port at the layers where it applies. The difference is (L -
    n_app) applications, one application's FLOPs taken from the port's
    own count with and without the shared block."""
    from repro_torch.models import mamba2

    b, jb = registry.get("zamba2-7b"), jax_registry.get("zamba2-7b")
    cfg = b.smoke
    napp = mamba2.n_shared_applications(cfg)
    assert 0 < napp < cfg.num_layers
    bare = dataclasses.replace(cfg, shared_attn_every=0)
    for kind in ("prefill", "decode"):
        shape, jshape = _small(kind)
        want = reference_flops(jb.smoke, jb.run, jshape)
        for device in ("meta", "cpu"):
            got = port_flops(cfg, b.run, shape, device).dot_flops
            one = (got - port_flops(bare, b.run, shape, device).dot_flops
                   ) / napp
            assert one > 0
            assert want - got == pytest.approx(
                (cfg.num_layers - napp) * one, rel=1e-6), (kind, device)


def test_kernel_operators_are_traced_through_the_card_path():
    """The card's path on meta tensors reaches each kernel through its
    operator, once a layer (or an application), and launches nothing."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.kernels.wkv6 import kernel as WK

    before = (FK.launches(), SK.launches(), WK.launches())
    for arch, want in (("rwkv6-7b", {"wkv6_chunked": 2}),
                       ("zamba2-7b", None)):
        b = registry.get(arch)
        shape, _ = _small("prefill")
        got = port_flops(b.smoke, b.run, shape).kernel_calls
        if want is None:
            from repro_torch.models import mamba2

            want = {"ssd_chunked": b.smoke.num_layers,
                    "flash_attention_fwd":
                        mamba2.n_shared_applications(b.smoke)}
        assert got == want
    assert (FK.launches(), SK.launches(), WK.launches()) == before
