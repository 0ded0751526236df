"""Pipeline parallelism over the ``pod`` axis (GPipe), the counterpart of
``repro/distributed/pipeline.py``.

``pipeline_apply`` runs a layer stack split into S stages over a mesh
axis: each stage holds L/S layers; microbatches stream through by
``spmd.ppermute`` (the activation handed to the next stage) on the
standard schedule of M + S - 1 ticks (fill and drain). The collectives
are differentiable, so autograd through the pipelined forward is the
pipelined backward (the reverse hand-offs).

Schedule cost: bubble fraction = (S-1)/(M+S-1) for M microbatches.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed import spmd
from repro_torch.launch.mesh import mesh_axis_sizes
from repro_torch.models import params as P


def pipeline_apply(stage_fn: Callable, params_stages, x_microbatches, mesh,
                   axis: str = "pod"):
    """A pipelined forward.

    stage_fn(stage_params, x) -> x            (one stage's layers)
    params_stages: a tree of tensors with leading dim S (stage-sharded
        over ``axis``)
    x_microbatches: (M, mb, ...) microbatch-major inputs, replicated over
        ``axis`` (only stage 0 reads them).

    Returns the (M, mb, ...) outputs of the LAST stage, replicated to every
    stage (a psum of its one-hot contribution). Every stage runs
    ``stage_fn`` at every tick, bubbles included, as the reference does.
    """
    S = mesh_axis_sizes(mesh)[axis]
    M = x_microbatches.shape[0]
    n_ticks = M + S - 1

    def local(params_local, xs):
        p = P.tree_map(lambda a: a[0], params_local)  # (1, ...) -> squeeze
        stage = spmd.axis_index(axis)
        state = torch.zeros_like(xs[0])  # in-flight activation
        done = [None] * M
        perm = [(i, (i + 1) % S) for i in range(S)]
        for t in range(n_ticks):
            # stage 0 ingests microbatch t (when in range)
            injected = xs[t] if stage == 0 and t < M else state
            y = stage_fn(p, injected)
            # the last stage emits finished microbatch t-(S-1)
            if stage == S - 1 and t - (S - 1) >= 0:
                done[t - (S - 1)] = y
            # hand off to the next stage (a ring: last -> first carries
            # garbage, overwritten by the injection)
            state = spmd.ppermute(y, axis, perm)
        if stage == S - 1:
            outs = torch.stack(done)
        else:
            outs = torch.zeros((M,) + tuple(xs.shape[1:]), dtype=xs.dtype,
                               device=xs.device)
        # every stage gets the outputs (psum of one-hot contribution)
        return spmd.psum(outs, axis)

    fn = spmd.shard_map(local, mesh, in_specs=((axis,), ()), out_specs=())
    return fn(params_stages, x_microbatches)


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
