"""Serving programs: prefill and single-token decode (greedy head).

Without a mesh the programs run the model whole on the tensors they are
given. With a mesh the dense, MoE, VLM and audio families (``family``
``dense``, ``moe``, ``vlm`` or ``audio``) under the ``baseline`` or
``moe_a2a`` ruleset are partitioned over it, as the reference's serve
programs are under GSPMD with those rules (``partitioned``): each
program is one ``spmd.shard_map`` over the whole mesh, the parameters
and the cache are ``sharding.MeshArray``s, each mesh cell holding its
FSDP x model shard of every weight leaf and its shard of the cache as
the rules cut it (a self-attention KV cache: the batch over the data
axes; over ``model`` the sequence, else the kv heads, else nothing; the
cross KV of the VLM's image layers and of whisper's decoder: the batch
over the data axes, the image or encoder sequence whole, the kv heads
over ``model`` where they divide), and the tokens and the VLM's image
or whisper's frame embeddings are cut over the ``batch`` rule's axes.
Each cell gathers the leaves of a layer (or of whisper's ``enc_ln``)
over the axes their specs cut, but ``model`` for a model-local leaf
(``distributed.tensor_parallel.plan_for``, the training step's plan),
one layer at a time, and runs the model tensor-parallel over ``model``
on a ``tensor_parallel.Forward`` tape (``lm.prefill_segments``,
``lm.decode_segments``): the embedding a partial lookup of its
vocabulary rows, the attention on its heads (its cache shard laid out
by ``attention.cache_rest``, a decode step's attention by
``attention.cell_decode``), the cross attention on its heads (its k and
v from its own columns of ``wk`` and ``wv``: the cross KV shard, never
gathered), the MLP on its columns, the MoE on its experts (the token
groups across the data cells, the a2a inside the cell), the logits its
vocabulary columns and the greedy token the group's argmax. The outputs
come back as ``MeshArray``s, the cache laid out by ``lm.cache_specs``'
shardings.

Every other family and ruleset on a mesh (rwkv6, zamba2; ``seqpar`` and
``decode_flash``) runs the model whole on whole tensors, its
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
from repro_torch.distributed.sharding import (BASELINE, MeshArray,
                                              ShardingCtx, place)
from repro_torch.models import lm, params as P
from repro_torch.models.attention import CacheCut
from repro_torch.train.step import CellLayout, _names, _padded


def partitioned(cfg: ModelConfig, run: RunConfig, ctx: ShardingCtx) -> bool:
    """Whether the serve programs of ``cfg`` run partitioned over
    ``ctx.mesh``: the dense, MoE, VLM and audio families under
    ``baseline`` or ``moe_a2a`` (whose rules are ``BASELINE``)."""
    return (ctx.mesh is not None and cfg.family in lm.SEGMENTED_SERVE
            and ctx.rules is BASELINE
            and run.sharding_rules in ("baseline", "moe_a2a"))


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
    ``B`` rows and a cache of ``S`` slots: the specs of its arguments and
    outputs, the cells' ``CellLayout`` and the tensor-parallel plan."""

    param_specs: Any
    cache_specs: Any
    batch: Tuple  # the tokens' spec (the batch rule's)
    embeds: Dict[str, Tuple]  # the prefill's image or frame embeddings'
    logits: Tuple
    cells: CellLayout
    plan: tp.Plan
    local: Any
    cut_dim: Optional[int]


def _self_kv(cache):
    """The self-attention k leaf of a cache tree (the VLM's under
    ``self``)."""
    return cache["self"]["k"] if "self" in cache else cache["k"]


def _cross_kv(cache):
    """The cross KV's k leaf of a cache tree, or None (no cross
    attention)."""
    if "cross" in cache:
        return cache["cross"]["img_k"]
    return cache.get("ck")


def _layout(cfg: ModelConfig, ctx: ShardingCtx, B: int, S: int) -> _Layout:
    pspecs = lm.param_specs(cfg)

    def specs(tree):
        return P.map_specs(lambda s: ctx.spec(s.logical, s.shape), tree)

    param_specs = specs(pspecs)
    batch = ctx.spec(("batch",), (B,))
    cells = CellLayout(ctx.mesh, pspecs, param_specs,
                       _names(batch[0]) if batch else ())
    plan = tp.plan_for(cfg, pspecs, param_specs, cells.sizes,
                       cells.batch_axes)
    shape = ShapeSpec("serve", "decode", S, B)
    cache_tensors = lm.cache_specs(cfg, shape)
    cache_specs = specs(cache_tensors)

    def entries(pick):  # (..., batch, sequence, heads, head_dim)
        return _padded(pick(cache_specs),
                       len(pick(cache_tensors).shape))[-4:]

    # the self cache: stacked (L, ...), the VLM's (groups, layers, ...)
    kv = entries(_self_kv)
    cross = (entries(_cross_kv) if _cross_kv(cache_tensors) is not None
             else None)
    for e in (kv, cross):
        if e is not None and e[0] != (batch[0] if batch else None):
            raise NotImplementedError(f"a cache laid out as {e} with the "
                                      f"batch cut as {batch}")
    if cross is not None and (tp.AXIS in _names(cross[2])) != plan.xattn:
        # a cell's k and v of the cross attention are its cross KV shard
        raise NotImplementedError(f"a cross KV laid out as {cross} with "
                                  f"the cross attention model-local: "
                                  f"{plan.xattn}")
    cut_dim = next((dim for dim, e in ((1, kv[1]), (2, kv[2]))
                    if tp.AXIS in _names(e)), None)
    logits = (batch[0] if batch else None, tp.AXIS) if plan.vocab else batch
    inputs = specs(lm.input_specs(cfg, ShapeSpec("serve", "prefill", S, B)))
    embeds = {k: v for k, v in inputs.items() if k != "tokens"}
    return _Layout(param_specs, cache_specs, batch, embeds, logits, cells,
                   plan, tp.local_leaves(plan, pspecs), cut_dim)


def _gathered(lay: _Layout, tree, specs, local, label: str):
    """``tree``'s leaves gathered from the cell's shards (each kept the
    cell's own over ``model`` where it is model-local), labelled for
    ``spmd.observe``."""
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
        if kind == "decode":
            S = _self_kv(args[1]).shape[-3]
        key = (B, S)
        if key not in layouts:
            layouts[key] = _layout(cfg, ctx, B, S)
        return layouts[key]

    def cell_at(*args):
        lay = layout(args)

        def cell(params, *rest):
            batch = rest[-1]
            tc = tp.Cell(tp.Forward(), lay.plan)
            cut = CacheCut(lay.cut_dim, lay.plan.size, tc.index(),
                           lay.plan.attn)
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
