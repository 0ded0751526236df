"""Tensor parallelism over the ``model`` axis inside the partitioned
training step (``train.step``) and serve programs (``serve.step``):
which parameter leaves a cell computes with as its own ``model`` shard,
and the tape that cuts a cell's forward at its collectives and walks its
backward segment by segment.

The reference partitions its step under GSPMD with the ``BASELINE``
ruleset, which puts ``heads``, ``kv_heads``, ``mlp``, ``vocab`` and
``experts`` on ``model``: each device computes with its own model shard
(Megatron-style tensor parallelism, which XLA derives). ``plan_for``
makes the same decision once per (arch, mesh, ruleset), for every family,
group by group of leaves (``Plan``): a group is *model-local* where its
``model`` cut falls on units the block code takes alone (attention and
the cross attention of the VLM and of whisper's decoder: both head
counts divide by the axis; rwkv6's time mix: its WKV heads; zamba2's
Mamba2 blocks: their SSD heads; the MLP's columns and rows, rwkv6's
channel mix's; the experts; the vocabulary). Every other leaf (norm
scales, the router, the VLM's gates, rwkv6's token-shift mixes, LoRAs,
decay and bonus, the Mamba2 conv, decay, skip and gated norm's scale, a
group whose cut does not fall on such units) is gathered whole over
``model`` as before; its work repeats in every cell of a ``model`` group
where it is a block's own work (``Plan.repeated``), and is replicated
work, the same in every cell, where it is not cut over ``model`` by the
reference's specs either.

Autograd cannot run the collectives' transposes: on the card the engine
runs every cell's CUDA backward in one device thread, where a collective
waits for cells that never come (``spmd`` refuses it). So a ``Tape``
runs a cell's forward as local segments (``run``: a function of explicit
input tensors, its outputs detached leaves) with the collectives between
them in the cell's own code (``enter``, ``exit``, ``total``,
``all_to_all``, ``all_gather``, ``pmax``), and ``backward`` walks the
records in reverse: a segment's backward is ``torch.autograd.backward``
of its outputs against their accumulated ``.grad`` (after re-running it
from its stored inputs, with ``remat``), a collective's is its
transpose, called in the cell's code. Gradients of the parameters
accumulate in their ``.grad``. Outside a step cell the same layer and
loss code runs on ``INLINE``, whose segments are plain calls under
autograd and whose plan keeps no leaf model-local
(``models.transformer.block_apply``, ``models.rwkv.layer_apply``,
``models.mamba2.layer_apply``, ``models.lm.loss_fn``).

Two conventions make the transposes those of Megatron's ``f`` and ``g``:
every cell computes the whole loss of its data rows, identically across
a ``model`` group, and the loss counts once. An entry (``enter``) is the
identity forward and a ``model`` psum backward; an exit (``exit``) a
psum forward and the identity backward; ``all_gather`` over ``model``
(its result used identically by the group) slices its block backward.
Hence the rules the block code keeps: (a) replicated work (the norms,
the router, rwkv6's token shift, mixes and decay) sits ahead of an
entry, or after an exit (the VLM's gates and rwkv6's receptance gate,
which scale the group's sum), so its gradient is the same in every cell
and is not summed; a replicated leaf that a cell's local segment reads
only in part (rwkv6's bonus ``u`` and ``ln_x``'s scale, on the cell's
heads; the Mamba2 conv's weights and bias, ``A_log``, ``D``, ``dt_bias``
and the gated norm's scale, on the cell's heads and channels) leaves the
replicated segment as an output and enters, as the a2a's router does,
so its gradient sums over ``model``; (b) a replicated loss (the MoE's
aux loss) is computed once ahead of an entry, or, where each cell
computes a part, summed through an exit; (c) a replicated value that
each cell computes a part of and then uses differently (rwkv6's
``ln_x`` and the Mamba2 gated norm, RMS norms over all of ``d`` and
``d_inner``, of which a cell holds its heads' channels: each row's sum
of squares) goes through an exit and at once an entry (``Tape.total``):
the group's sum forward, and backward the sum of the cells' gradients of
it, each cell's own being only its channels' part. An activation that
several local segments read (whisper's encoder output, read by every
decoder cross layer) enters each of them: its gradient sums over the
cells at each entry and over the entries in its ``.grad`` before the
segment that made it runs its backward. A leaf that several segments
read by closure (zamba2's weight-tied shared block, applied after every
``shared_attn_every``-th layer) sums their gradients in its ``.grad``.

The partitioned serve programs (``serve.step``) run every family's
layers with the same plan on a ``Forward`` tape: the same segments and
collectives, forward only, nothing recorded. Under the ``decode_flash``
rules, which cut ``wk`` and ``wv`` over no axis but the features', the
dense and MoE serve's attention is model-local by its q heads alone
(``Plan.qheads``: every cell projects every kv head and attends with
those its q heads read), and a decode step is 2-D (``Plan.decode_2d``):
no leaf gathered, the residual stream cut by features over the axes
that cut the weights' ``fsdp`` dim, each product's partial sums exited
over the axes that cut its contracted dim.

zamba2's Mamba2 in-projection ``w_in`` is one leaf whose columns hold
the gate, x, B, C and dt side by side, so its even cut over ``model``
does not fall on a cell's heads. It is model-local all the same: the
cell keeps its even block at rest, and inside the tape gathers the
whole leaf (``all_gather`` with ``replicated=False``, one a layer) and
reads its heads' gate, x and dt columns and the B and C columns, which
every head shares: the gradient each cell computes of the gathered leaf
is a partial sum, which the gather's transpose reduce-scatters, as
GSPMD's reshard does. B and C are projected and convolved in every cell
of the group: replicated work, 2N of the block's columns.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.distributed import spmd

AXIS = "model"


# --- which leaves a cell keeps local ------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Plan:
    """Which groups of leaves are model-local. ``segmented``: the step
    runs the family's loss on a ``Tape`` (every family on a mesh);
    ``size``: the ``model`` axis's."""

    segmented: bool = False
    size: int = 1
    # whisper's encoder's and decoder's; rwkv6's time mix; zamba2's shared
    # block's
    attn: bool = False
    xattn: bool = False  # the VLM's and whisper's cross attention
    # the dense MLP (the VLM's self and cross layers', whisper's encoder
    # and decoder layers', zamba2's shared block's); rwkv6's channel mix
    mlp: bool = False
    ssd: bool = False  # zamba2's Mamba2 blocks (``w_in`` and ``w_out``)
    shared: bool = False  # the MoE's shared MLP
    experts: bool = False
    vocab: bool = False
    batch_axes: Tuple[str, ...] = ()  # the mesh axes that cut the batch
    # the decode_flash rules, which cut ``wk`` and ``wv`` over no axis but
    # the features': ``wq``'s columns and ``wo``'s rows (``bq``) cut over
    # ``model`` (``qcols``); attention model-local by its q heads, every
    # kv head in every cell (``qheads``: the q heads divide by the axis,
    # and each cell's read whole kv heads or one kv head's part)
    qcols: bool = False
    qheads: bool = False
    # a decode_flash decode step: 2-D tensor parallel, no leaf gathered
    # (``serve.step``); the residual stream's features cut over
    # ``features`` (the mesh axes that cut the weights' ``fsdp`` dim)
    decode_2d: bool = False
    features: Tuple[str, ...] = ()

    def repeated(self, cfg) -> List[str]:
        """The blocks whose work repeats in every cell of a ``model``
        group (their leaves gathered whole over it)."""
        if self.size == 1:
            return []
        ssm = cfg.family == "ssm"
        out = ["mamba2"] if cfg.family == "hybrid" and not self.ssd else []
        if not (self.attn or self.qheads or self.decode_2d):
            out.append("time mix" if ssm else "attention")
        if cfg.family in ("vlm", "audio") and not self.xattn:
            out.append("cross attention")
        if cfg.family != "moe" and not self.mlp:
            out.append("channel mix" if ssm else "mlp")
        if cfg.family == "moe":
            if not self.experts:
                out.append("experts")
            if cfg.shared_expert and not self.shared:
                out.append("shared mlp")
        if not self.vocab:
            out.append("embedding and logits")
        return out


def _at(tree, path):
    for k in path:
        if not isinstance(tree, dict) or k not in tree:
            return None
        tree = tree[k]
    return tree


def _model_cut(ts, spec) -> Optional[set]:
    """The logical axes of a leaf that ``model`` cuts alone (None when it
    is cut jointly with another mesh axis)."""
    out = set()
    entries = list(spec) + [None] * (len(ts.shape) - len(spec))
    for name, e in zip(ts.logical, entries):
        names = () if e is None else ((e,) if isinstance(e, str) else tuple(e))
        if AXIS in names:
            if len(names) > 1:
                return None
            out.add(name)
    return out


def _local(pspecs, param_specs, prefix, want: Dict[str, str]) -> bool:
    """Whether every leaf ``prefix + name`` of ``want`` exists and is cut
    by ``model`` on the logical axis ``want[name]`` and on no other."""
    found = False
    for name, axis in want.items():
        ts = _at(pspecs, prefix + (name,))
        if ts is None:
            continue
        found = True
        if _model_cut(ts, _at(param_specs, prefix + (name,))) != {axis}:
            return False
    return found


ATTN = {"wq": "heads", "wk": "kv_heads", "wv": "kv_heads", "wo": "heads",
        "bq": "heads", "bk": "kv_heads", "bv": "kv_heads"}
QCOLS = {"wq": "heads", "wo": "heads", "bq": "heads"}
MLP = {"w_gate": "mlp", "w_up": "mlp", "w_down": "mlp"}
EXPERTS = {"w_gate": "experts", "w_up": "experts", "w_down": "experts"}
TMIX = {"wr": "heads", "wk": "heads", "wv": "heads", "wg": "heads",
        "wo": "heads"}  # rwkv6's time mix
CMIX = {"wk": "mlp", "wv": "mlp"}  # rwkv6's channel mix
MAMBA = {"w_in": "mlp", "w_out": "mlp"}  # zamba2's Mamba2 block
VOCAB = {"embedding": "vocab", "unembed": "vocab"}


def plan_for(cfg, pspecs, param_specs, sizes: Dict[str, int],
             batch_axes: Tuple[str, ...], *, qheads: bool = False) -> Plan:
    """The plan for ``cfg``'s parameters (``pspecs``, the ``TensorSpec``
    tree) laid out by ``param_specs`` over a mesh of axis ``sizes``.
    ``qheads``: the dense and MoE serve under the decode_flash rules,
    whose attention may be model-local by its q heads alone
    (``Plan.qheads``)."""
    m = sizes.get(AXIS, 1)
    if m == 1:
        return Plan(segmented=True, batch_axes=batch_axes)

    def local(group, want):
        return _local(pspecs, param_specs, ("stack",) + group, want)

    vocab = _local(pspecs, param_specs, ("embed",), VOCAB)
    if cfg.family == "ssm":
        heads = cfg.d_model // cfg.wkv_head_dim % m == 0
        return Plan(
            segmented=True, size=m, batch_axes=batch_axes,
            attn=heads and local(("layers", "tmix"), TMIX),
            mlp=local(("layers", "cmix"), CMIX), vocab=vocab)
    heads = cfg.num_heads % m == 0 and cfg.num_kv_heads % m == 0
    if cfg.family == "hybrid":
        ssd_heads = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim % m == 0
        return Plan(
            segmented=True, size=m, batch_axes=batch_axes,
            ssd=ssd_heads and local(("layers",), MAMBA),
            attn=heads and local(("shared", "attn"), ATTN),
            mlp=local(("shared", "mlp"), MLP), vocab=vocab)
    if cfg.family == "audio":
        return Plan(
            segmented=True, size=m, batch_axes=batch_axes,
            attn=heads and local(("encoder", "attn"), ATTN)
            and local(("decoder", "attn"), ATTN),
            xattn=heads and local(("decoder", "xattn"), ATTN),
            mlp=local(("encoder", "mlp"), MLP) and local(("decoder", "mlp"),
                                                          MLP),
            vocab=vocab)
    if cfg.family == "vlm":
        return Plan(
            segmented=True, size=m, batch_axes=batch_axes,
            attn=heads and local(("self", "attn"), ATTN),
            xattn=heads and local(("cross", "xattn"), ATTN),
            mlp=local(("self", "mlp"), MLP) and local(("cross", "mlp"), MLP),
            vocab=vocab)
    qcols = qheads and local(("layers", "attn"), QCOLS)
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    return Plan(
        segmented=True, size=m, batch_axes=batch_axes,
        attn=heads and local(("layers", "attn"), ATTN),
        qcols=qcols, qheads=qcols and hq % m == 0 and (
            hkv % m == 0 or m % hkv == 0),
        mlp=local(("layers", "mlp"), MLP),
        shared=local(("layers", "moe", "shared"), MLP),
        experts=local(("layers", "moe"), EXPERTS),
        vocab=vocab)


def local_leaves(plan: Plan, pspecs):
    """A tree shaped like the parameters: True for each leaf a cell
    computes with as its own ``model`` shard."""
    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if path[:1] == ("embed",):
            return plan.vocab
        if path[:2] == ("stack", "layers") and len(path) == 3:
            return plan.ssd and path[2] in MAMBA
        if path[:2] not in (("stack", "layers"), ("stack", "self"),
                            ("stack", "cross"), ("stack", "encoder"),
                            ("stack", "decoder"), ("stack", "shared")) \
                or len(path) < 4:
            return False
        group, name = path[2], path[3]
        if group == "tmix":
            return plan.attn and name in TMIX
        if group == "cmix":
            return plan.mlp and name in CMIX
        if group == "attn":
            return plan.attn or plan.qheads
        if group == "xattn":
            return plan.xattn
        if group == "mlp":
            return plan.mlp
        if group == "moe":
            if name == "shared":
                return plan.shared
            return plan.experts and name in EXPERTS
        return False

    return walk(pspecs, ())


def paths(tree, prefix: str = ""):
    """A tree shaped like ``tree`` (nested dicts) whose leaves are their
    dotted paths."""
    if isinstance(tree, dict):
        return {k: paths(v, f"{prefix}{k}.") for k, v in tree.items()}
    return prefix[:-1]


# --- the tape ------------------------------------------------------------------------


def _leaf(t):
    """A segment output as a leaf of the autograd graphs that consume it
    (the same storage); other values as they are."""
    if isinstance(t, torch.Tensor) and t.is_floating_point():
        return t.detach().requires_grad_()
    return t


def _same(t):
    return t


def _accumulate(t: torch.Tensor, g: torch.Tensor) -> None:
    g = g.to(t.dtype)
    t.grad = g if t.grad is None else t.grad + g


@dataclasses.dataclass
class _Segment:
    fn: Callable
    inputs: Tuple[Any, ...]
    leaves: Tuple[Any, ...]
    graph: Optional[Tuple[Any, ...]]  # the outputs with their graph (no remat)


@dataclasses.dataclass
class _Collective:
    src: torch.Tensor
    dst: torch.Tensor
    transpose: Callable[[torch.Tensor], torch.Tensor]


class Tape:
    """One cell's forward as local segments and collectives, and its
    backward; see the module's docstring. With ``remat`` a segment's
    forward runs without a graph and stores its inputs, and its backward
    re-runs it first (PR 24's per-layer remat, per segment)."""

    _leaf = staticmethod(_leaf)

    def __init__(self, remat: bool):
        self.remat = remat
        self.records: List[Any] = []

    def run(self, fn: Callable, *inputs) -> Tuple[Any, ...]:
        """``fn(*inputs)``, a tuple of tensors, as leaves. ``fn`` reads
        the parameters by closure and issues no collective."""
        with spmd.local_segment(), torch.set_grad_enabled(not self.remat):
            outs = tuple(fn(*inputs))
        leaves = tuple(self._leaf(o) for o in outs)
        self.records.append(_Segment(fn, inputs, leaves,
                                     None if self.remat else outs))
        return leaves

    def _collective(self, src, dst, transpose):
        if src.requires_grad:
            self.records.append(_Collective(src, dst, transpose))
        return dst

    def enter(self, x: torch.Tensor, axis=AXIS) -> torch.Tensor:
        """``x`` (used whole by every cell of the group) as the input of
        a local computation: the identity forward, a psum of the
        gradient backward."""
        if _size(axis) == 1:
            return x
        return self._collective(x, self._leaf(x),
                                lambda g: spmd.psum(g, axis))

    def exit(self, x: torch.Tensor, axis=AXIS) -> torch.Tensor:
        """The group's sum of its cells' ``x`` (partial sums of one
        replicated value): the gradient passes through as it is."""
        if _size(axis) == 1:
            return x
        return self._collective(x, self._leaf(spmd.psum(x.detach(), axis)),
                                lambda g: g)

    def total(self, x: torch.Tensor, axis=AXIS) -> torch.Tensor:
        """The group's sum of its cells' parts ``x`` of a value that each
        cell then uses in its own way (rule (c)): an exit and at once an
        entry, so the gradient that reaches ``x`` is the group's sum of
        the cells' gradients of the total."""
        return self.enter(self.exit(x, axis), axis)

    def all_to_all(self, x: torch.Tensor, axis, split_axis: int,
                   concat_axis: int) -> torch.Tensor:
        """``spmd.all_to_all``; backward the reverse exchange."""
        y = spmd.all_to_all(x.detach(), axis, split_axis, concat_axis)
        return self._collective(x, self._leaf(y), lambda g: spmd.all_to_all(
            g, axis, concat_axis, split_axis))

    def all_gather(self, x: torch.Tensor, axis, dim: int = 0, *,
                   replicated: bool = True) -> torch.Tensor:
        """``spmd.all_gather`` along ``dim``. Backward: this cell's block
        of the gradient where every cell of the group uses the result
        identically and counts it once (``replicated``), else the group's
        sum of every cell's block (the reduce-scatter, as where each data
        cell's loss counts)."""
        y = spmd.all_gather(x.detach(), axis, axis=dim)
        n = x.shape[dim]

        def transpose(g):
            if replicated:
                i = spmd.axis_index(axis)
                return g.narrow(dim, i * n, n)
            index = [slice(None)] * g.dim()
            index[dim] = slice(spmd.axis_index(axis) * n,
                               (spmd.axis_index(axis) + 1) * n)
            return spmd.psum_block(g, axis, tuple(index))

        return self._collective(x, self._leaf(y), transpose)

    def pmax(self, x: torch.Tensor, axis=AXIS) -> torch.Tensor:
        """The group's elementwise max, no gradient."""
        if _size(axis) == 1:
            return x.detach()
        return spmd.pmax(x.detach(), axis)

    def backward(self, loss: torch.Tensor) -> None:
        """Every parameter's gradient of ``loss`` (a leaf of the last
        segment) into its ``.grad``: the records in reverse, each
        dropped once done."""
        loss.grad = torch.ones_like(loss)
        while self.records:
            rec = self.records.pop()
            if isinstance(rec, _Collective):
                g = rec.dst.grad
                if g is None:  # every cell calls the transpose
                    g = torch.zeros_like(rec.dst)
                rec.dst.grad = None
                _accumulate(rec.src, rec.transpose(g))
                continue
            self._segment_backward(rec)

    def _segment_backward(self, rec: _Segment) -> None:
        wanted = [i for i, t in enumerate(rec.leaves)
                  if isinstance(t, torch.Tensor) and t.grad is not None]
        grads = [rec.leaves[i].grad for i in wanted]
        for t in rec.leaves:
            if isinstance(t, torch.Tensor):
                t.grad = None
        if not wanted:
            return
        outs = rec.graph
        if outs is None:
            with spmd.local_segment(), torch.enable_grad():
                outs = tuple(rec.fn(*rec.inputs))
        pairs = [(outs[i], g) for i, g in zip(wanted, grads)
                 if outs[i].requires_grad]
        if pairs:
            torch.autograd.backward([o for o, _ in pairs],
                                    [g for _, g in pairs])


class Forward(Tape):
    """One cell's forward alone (the partitioned serve, ``serve.step``):
    each segment a plain call, inside which a collective still raises,
    each collective its forward (an entry the identity, an exit and
    ``total`` a psum, ``all_gather`` and ``all_to_all`` plain); nothing
    is recorded and there is no backward."""

    _leaf = staticmethod(_same)

    def __init__(self):
        super().__init__(remat=False)

    def run(self, fn: Callable, *inputs) -> Tuple[Any, ...]:
        with spmd.local_segment():
            return tuple(fn(*inputs))

    def _collective(self, src, dst, transpose):
        return dst

    def backward(self, loss: torch.Tensor) -> None:
        raise TypeError("a forward tape records nothing to differentiate")


def _size(axis) -> int:
    return spmd.axis_size(axis)


class Inline:
    """The tape of the layer code outside a step cell (no mesh, or a
    forward that is not the partitioned step's): each segment a plain
    call under autograd, the model's own backward."""

    @staticmethod
    def run(fn: Callable, *inputs) -> Tuple[Any, ...]:
        return tuple(fn(*inputs))


@dataclasses.dataclass
class Cell:
    """What the block code of one cell reads: its tape and the plan."""

    tape: Tape
    plan: Plan

    def index(self) -> int:
        """This cell's index along ``model``."""
        return spmd.axis_index(AXIS) if self.plan.size > 1 else 0

    def block(self, n: int) -> Tuple[int, int]:
        """This cell's ``[lo, hi)`` of ``n`` units cut over ``model``."""
        k = n // self.plan.size
        lo = self.index() * k
        return lo, lo + k

    def kv_heads(self, cfg) -> Tuple[int, int]:
        """``[lo, hi)`` of the kv heads that this cell's q heads read,
        where attention is model-local by its q heads (``Plan.qheads``)."""
        lo, hi = self.block(cfg.num_heads)
        group = cfg.num_heads // cfg.num_kv_heads
        return lo // group, (hi - 1) // group + 1

    def feature_block(self, t: torch.Tensor) -> torch.Tensor:
        """This cell's block of ``t``'s last dim, the model's features,
        where a decode_flash decode step cuts them (``Plan.features``);
        ``t`` whole where nothing does."""
        axes = self.plan.features
        if not axes:
            return t
        n = t.shape[-1] // spmd.axis_size(axes)
        return t.narrow(-1, spmd.axis_index(axes) * n, n)


# the layer code outside a step cell: no leaf model-local, no collective
INLINE = Cell(Inline(), Plan())
