"""Serving programs: prefill and single-token decode (greedy head).

Without a mesh the programs run the model whole on the tensors they are
given. With a mesh every family under the ``baseline`` or ``moe_a2a``
ruleset is partitioned over it, as the reference's serve programs are
under GSPMD with those rules (``partitioned``): each program is one
``spmd.shard_map`` over the whole mesh, the parameters and the cache are
``sharding.MeshArray``s, each mesh cell holding its FSDP x model shard of
every weight leaf and its shard of every cache leaf as the rules cut it
(``lm.cache_specs``' specs; the batch over the data axes throughout): a
self-attention KV cache (zamba2's shared block's too) over ``model`` by
the sequence, else the kv heads, else nothing; the cross KV of the VLM's
image layers and of whisper's decoder by the kv heads where they divide;
rwkv6's WKV state and the Mamba2 layers' SSD state by their heads, where
they divide (the block then runs on the cell's heads); the Mamba2 conv
state by an even block of its channels; rwkv6's token shifts whole. The
tokens and the VLM's image or whisper's frame embeddings are cut over
the ``batch`` rule's axes. Each cell gathers the leaves of a layer (or
of whisper's ``enc_ln``, or zamba2's shared block at each application)
over the axes their specs cut, but ``model`` for a model-local leaf
(``distributed.tensor_parallel.plan_for``, the training step's plan),
one layer at a time, and runs the model tensor-parallel over ``model``
on a ``tensor_parallel.Forward`` tape (``lm.prefill_segments``,
``lm.decode_segments``): the embedding a partial lookup of its
vocabulary rows, the attention on its heads (its cache shard laid out
by ``attention.cache_rest``, a decode step's attention by
``attention.cell_decode``), the cross attention on its heads (its k and
v from its own columns of ``wk`` and ``wv``: the cross KV shard, never
gathered), rwkv6's time mix and zamba2's Mamba2 blocks on their heads
from and into their state shards (the conv state gathered over
``model`` in a decode step, the one cache leaf a cell gathers), the MLP
and rwkv6's channel mix on their columns, the MoE on its experts (the
token groups across the data cells, the a2a inside the cell), the
logits its vocabulary columns and the greedy token the group's argmax.
The outputs come back as ``MeshArray``s, the cache laid out by
``lm.cache_specs``' shardings.

Under ``decode_flash`` the dense and MoE families (dense dispatch) are
partitioned too. The rules lay the weights out as ``baseline`` does but
for ``wk``, ``wv``, ``bk`` and ``bv``, which ``model`` does not cut; the
cache holds the cell's rows over the data axes, its sequence block over
``model`` and every kv head; the tokens are whole. A decode step is 2-D
tensor parallel and gathers no weight (``Plan.decode_2d``): the rules
keep the weights cut over both axes so that a token's step moves only
activations of one token a row, never the weights, which are 100 MB and
more a layer at full size. Each cell holds the residual stream's block of
features over the data axes (the weights' ``fsdp`` cut), takes its
partial products with its shards and sums them over the data axes (the
projections out of the features, the norms' sums of squares, the
logits) or over ``model`` (those into them, the embedding), gathers q
over ``model``, attends on its rows and its sequence block with every
head, the partials combined by log-sum-exp over ``model`` and the output
gathered over the data axes (``attention.cell_decode`` with
``CacheCut.rows``), as the reference's ``flash_decode`` does; a cache
whose slots do not split over ``model`` is refused, as there. The
prefill does gather each layer's weights over the data axes, as the
baseline's does: its activations are a whole prompt a row, so the
partial sums of the 2-D layout would move the prompt's length times the
bytes a decode step moves, more than the weights. Each cell runs on its
rows of the tokens, its attention on its own q heads and the kv heads
they read where the q heads split over ``model`` (``Plan.qheads``),
and keeps its sequence block of every kv head as its cache: no
all-to-all.

The ``seqpar`` ruleset, and the other families under ``decode_flash``,
run the model whole on whole tensors on a mesh, ``decode_flash``'s
``flash_decode`` its own ``shard_map``: that is the path for them,
chosen by ``partitioned``, not a fallback.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeSpec
from repro_torch.distributed import spmd
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import (BASELINE, DECODE_FLASH,
                                              MeshArray, ShardingCtx, place)
from repro_torch.models import lm, params as P
from repro_torch.models.attention import CacheCut
from repro_torch.train.step import CellLayout, _names, _padded


def partitioned(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx) -> bool:
    """Whether the serve programs of ``cfg`` run partitioned over
    ``ctx.mesh``: every family under ``baseline`` or ``moe_a2a`` (whose
    rules are ``BASELINE``); the dense and MoE families under
    ``decode_flash`` with the dense MoE dispatch."""
    if ctx.mesh is None:
        return False
    if ctx.rules is BASELINE:
        return run.sharding_rules in ("baseline", "moe_a2a")
    return (ctx.rules is DECODE_FLASH and run.sharding_rules == "decode_flash"
            and cfg.family in ("dense", "moe")
            and (not cfg.is_moe or run.moe_impl == "dense"))


def _argmax(logits):
    return torch.argmax(logits, dim=-1).to(torch.int32)


def make_prefill_step(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx):
    """``prefill_step(params, batch, logits=False)`` -> (next tokens, cache)
    and, with ``logits``, the last token's logits too."""
    if partitioned(cfg, run, ctx):
        return _partitioned(cfg, run, ctx, "prefill")

    def prefill_step(params, batch, *, logits: bool = False):
        with torch.inference_mode():
            lg, cache = lm.prefill_fn(cfg, run, ctx, params, batch)
            next_tok = _argmax(lg)
        return (next_tok, cache, lg) if logits else (next_tok, cache)

    return prefill_step


def make_decode_step(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx):
    """``decode_step(params, cache, batch, logits=False)`` -> (next tokens,
    cache) and, with ``logits``, the logits too; ``batch["pos"]`` a Python
    int."""
    if partitioned(cfg, run, ctx):
        return _partitioned(cfg, run, ctx, "decode")

    def decode_step(params, cache, batch, *, logits: bool = False):
        with torch.inference_mode():
            lg, cache = lm.decode_fn(cfg, run, ctx, params, cache, batch)
            next_tok = _argmax(lg)
        return (next_tok, cache, lg) if logits else (next_tok, cache)

    return decode_step


def laid_out(cfg: ModelConfig, ctx: ShardingCtx, params):
    """``params`` with each leaf that is not a ``MeshArray`` laid out over
    ``ctx.mesh`` by its spec under ``ctx``'s rules (``sharding.place``)."""
    shardings = P.map_specs(lambda s: ctx.sharding(s.logical, s.shape),
                            lm.param_specs(cfg))
    return P.tree_map(lambda t, sh: t if isinstance(t, MeshArray)
                      else place(t, sh), params, shardings)


# --- the partitioned programs --------------------------------------------------------


@dataclasses.dataclass
class _Layout:
    """A partitioned serve program's layout over the mesh, for a batch of
    ``B`` rows and a self-attention cache of ``S`` slots: the specs of its
    arguments and outputs, the cells' ``CellLayout``, the tensor-parallel
    plan, where ``model`` cuts the cache (``attention.CacheCut``'s
    ``dim`` and ``conv``), the cache's rows where the step's tokens hold
    every row (``CacheCut.rows``) and whether the cells gather the
    weights (all but a decode_flash decode step)."""

    param_specs: Any
    cache_specs: Any
    batch: Tuple  # the tokens' spec (a prefill's: the cache's rows)
    embeds: Dict[str, Tuple]  # the prefill's image or frame embeddings'
    logits: Tuple
    cells: CellLayout
    plan: tp.Plan
    local: Any
    cut_dim: Optional[int]
    conv: bool
    rows: Tuple[str, ...] = ()
    gather: bool = True


def _self_kv(cache):
    """The self-attention k leaf of a cache tree (the VLM's under
    ``self``, zamba2's shared block's under ``attn``), or None (rwkv6's
    state, zamba2 without a shared block)."""
    for key in ("self", "attn"):
        if key in cache:
            return cache[key]["k"]
    return cache.get("k")


def _cross_kv(cache):
    """The cross KV's k leaf of a cache tree, or None (no cross
    attention)."""
    if "cross" in cache:
        return cache["cross"]["img_k"]
    return cache.get("ck")


# each recurrent state with heads: the plan's flag for the block that
# computes it on the cell's heads
_STATE_HEADS = {"wkv": "attn", "ssm": "ssd"}


def _model_cut(entry) -> bool:
    return tp.AXIS in _names(entry)


def _layout(cfg: ModelConfig, ctx: ShardingCtx, B: int, S: int,
            kind: str) -> _Layout:
    pspecs = lm.param_specs(cfg)

    def specs(tree):
        return P.map_specs(lambda s: ctx.spec(s.logical, s.shape), tree)

    param_specs = specs(pspecs)
    # the cache's rows: the batch rule's but under decode_flash, whose
    # tokens hold every row; a prefill cell takes its rows of them
    rows = ctx.spec(("cache_batch",), (B,))
    flash = ctx.rules is DECODE_FLASH
    batch = ctx.spec(("batch",), (B,)) if kind == "decode" else rows
    cells = CellLayout(ctx.mesh, pspecs, param_specs,
                       _names(rows[0]) if rows else ())
    plan = tp.plan_for(cfg, pspecs, param_specs, cells.sizes,
                       cells.batch_axes, qheads=flash)
    if flash and kind == "decode":
        fsdp = ctx.spec(("fsdp",), (cfg.d_model,))
        plan = dataclasses.replace(plan, decode_2d=True, features=tuple(
            a for a in _names(fsdp[0] if fsdp else None)
            if cells.sizes[a] > 1))
    shape = ShapeSpec("serve", "decode", S, B)
    cache_tensors = lm.cache_specs(cfg, shape)
    cache_specs = specs(cache_tensors)
    convs = []

    def check(ts, spec, path):
        spec = _padded(spec, len(ts.shape))
        by_axis = dict(zip(ts.logical, spec))
        if by_axis.get("batch", by_axis.get("cache_batch")) != (
                rows[0] if rows else None):
            raise NotImplementedError(f"a cache leaf {path} laid out as "
                                      f"{spec} with the batch cut as "
                                      f"{rows}")
        name = path.split(".")[-1]
        flag = _STATE_HEADS.get(name)
        if flag and _model_cut(by_axis["heads"]) != getattr(plan, flag):
            # a cell's heads of the block are its shard of the state
            raise NotImplementedError(f"a state {path} laid out as {spec} "
                                      f"with the block model-local: "
                                      f"{getattr(plan, flag)}")
        if name == "conv":
            convs.append(_model_cut(by_axis["mlp"]))

    P.tree_map(check, cache_tensors, cache_specs, tp.paths(cache_tensors))

    def entries(leaf):  # (..., batch, sequence, heads, head_dim)
        ts = leaf(cache_tensors)
        return _padded(leaf(cache_specs), len(ts.shape))[-4:]

    cut_dim = None
    if _self_kv(cache_tensors) is not None:
        kv = entries(_self_kv)
        cut_dim = next((dim for dim, e in ((1, kv[1]), (2, kv[2]))
                        if _model_cut(e)), None)
    if _cross_kv(cache_tensors) is not None and \
            _model_cut(entries(_cross_kv)[2]) != plan.xattn:
        # a cell's k and v of the cross attention are its cross KV shard
        raise NotImplementedError(f"a cross KV laid out as "
                                  f"{entries(_cross_kv)} with the cross "
                                  f"attention model-local: {plan.xattn}")
    if plan.decode_2d and plan.size > 1 and cut_dim != 1:
        # flash_decode's shard_map cuts the cache's slots over model
        raise ValueError(f"a decode_flash decode step over a cache of {S} "
                         f"slots, which do not split over the "
                         f"{plan.size} cells of {tp.AXIS!r}")
    logits = (batch[0] if batch else None, tp.AXIS) if plan.vocab else batch
    inputs = specs(lm.input_specs(cfg, ShapeSpec("serve", "prefill", S, B)))
    embeds = {k: v for k, v in inputs.items() if k != "tokens"}
    return _Layout(param_specs, cache_specs, batch, embeds, logits, cells,
                   plan, tp.local_leaves(plan, pspecs), cut_dim,
                   any(convs), cells.batch_axes if plan.decode_2d else (),
                   not plan.decode_2d)


def _gathered(lay: _Layout, tree, specs, local, label: str):
    """``tree``'s leaves gathered from the cell's shards (each kept the
    cell's own over ``model`` where it is model-local), labelled for
    ``spmd.observe``; in a decode_flash decode step the cell's shards as
    they are."""
    if not lay.gather:
        return tree
    with spmd.labelled(label):
        return P.tree_map(lay.cells.gather, tree, specs, local)


def _top(lay: _Layout, params) -> Dict:
    """The cell's embedding and final norm, gathered."""
    return {k: _gathered(lay, params[k], lay.param_specs[k], lay.local[k],
                         k) for k in params if k != "stack"}


def _stack(lay: _Layout, params, *path) -> Dict:
    """The leaves at ``path`` in ``params["stack"]`` (``lm.stack_leaves``'
    paths: a key for each dict, an index into each stacked axis, which no
    rule cuts), gathered from the cell's shards: one layer at a time."""
    tree, specs, local = (params["stack"], lay.param_specs["stack"],
                          lay.local["stack"])
    label = "stack"
    for k in path:
        if isinstance(k, int):
            tree = P.layer(tree, k)
            specs = P.tree_map(lambda s: tuple(s)[1:], specs)
            label += f"[{k}]"
        else:
            tree, specs, local = tree[k], specs[k], local[k]
            label += f".{k}"
    return _gathered(lay, tree, specs, local, label)


def _greedy(cfg: ModelConfig, tc, logits):
    """Each row's greedy token, ``torch.argmax`` of the whole row: where
    the cell holds its vocabulary columns, the group's largest value
    (``pmax``), then the lowest index that holds it."""
    if not tc.plan.vocab:
        return _argmax(logits)
    lo = tc.block(cfg.vocab_size)[0]
    top = tc.tape.pmax(logits.amax(dim=-1))
    ids = torch.arange(lo, lo + logits.shape[-1], device=logits.device)
    mine = torch.where(logits == top[:, None], ids, cfg.vocab_size)
    return (-tc.tape.pmax(-mine.amin(dim=-1))).to(torch.int32)


def _partitioned(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx,
                 kind: str):
    """The prefill (``kind`` ``prefill``) or decode step over
    ``ctx.mesh``; see the module's docstring. The step takes
    ``MeshArray`` (or whole) parameters and cache and a whole batch, and
    returns the next tokens whole and the cache as ``MeshArray``s (with
    ``logits``, the logits whole too). ``.cell_at(*args)`` is the
    function one cell runs on its shards for arguments shaped like
    ``args`` (``spmd.one_cell`` traces it), ``.in_specs(*args)`` their
    spec trees, ``.plan_at(*args)`` the ``tensor_parallel.Plan``."""
    mesh = ctx.mesh
    layouts: Dict[Tuple[int, int], _Layout] = {}

    def layout(args) -> _Layout:
        B, S = args[-1]["tokens"].shape
        if kind == "decode":  # the self-attention cache's slots, if any
            kv = _self_kv(args[1])
            S = 1 if kv is None else kv.shape[-3]
        key = (B, S)
        if key not in layouts:
            layouts[key] = _layout(cfg, ctx, B, S, kind)
        return layouts[key]

    def cell_at(*args):
        lay = layout(args)

        def cell(params, *rest):
            batch = rest[-1]
            tc = tp.Cell(tp.Forward(), lay.plan)
            cut = CacheCut(lay.cut_dim, lay.plan.size, tc.index(),
                           lay.plan.attn, lay.conv, lay.rows)
            top = _top(lay, params)

            def stack(*path):
                return _stack(lay, params, *path)

            if kind == "prefill":
                logits, cache = lm.prefill_segments(
                    cfg, run, ctx, tc, top, batch, stack=stack, cut=cut)
            else:
                pos = batch["pos"]
                pos = int(pos) if isinstance(pos, torch.Tensor) else pos
                logits, cache = lm.decode_segments(
                    cfg, run, ctx, tc, top, rest[0],
                    {"tokens": batch["tokens"], "pos": pos}, stack=stack,
                    cut=cut)
            return _greedy(cfg, tc, logits), cache, logits

        return cell

    def in_specs(*args):
        lay = layout(args)
        batch = {"tokens": lay.batch}
        if kind == "prefill":
            return lay.param_specs, {**batch, **lay.embeds}
        return lay.param_specs, lay.cache_specs, {**batch, "pos": ()}

    def step(*args, logits: bool = False):
        lay = layout(args)
        batch = args[-1]
        batch = {k: batch[k] for k in (("tokens", *lay.embeds)
                                       if kind == "prefill"
                                       else ("tokens", "pos"))}
        args = (*args[:-1], batch)
        fn = spmd.shard_map(cell_at(*args), mesh, in_specs=in_specs(*args),
                            out_specs=(lay.batch, lay.cache_specs,
                                       lay.logits), keep=True)
        with torch.inference_mode():
            tok, cache, lg = fn(*args)
        tok = tok.gather()
        return (tok, cache, lg.gather()) if logits else (tok, cache)

    step.cell_at = cell_at
    step.in_specs = in_specs
    step.plan_at = lambda *args: layout(args).plan
    return step
