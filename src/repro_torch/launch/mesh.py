"""Device meshes, the port's own.

A ``Mesh`` names the axes of an ndarray of ``torch.device``: what the
checkpoint store and the sharding rules read (``axis_names``,
``devices.shape``). The functions build meshes; none is made when this
module is imported. Single pod: 16x16 = 256 devices ("data", "model").
Multi-pod: 2x16x16 = 512 ("pod", "data", "model").

A mesh over real devices needs as many CUDA devices as it has cells and
raises when there are fewer. A *virtual* mesh passes ``devices``
explicitly, the same card several times: one card then stands in for the
several devices of an elastic restore (halved, same, doubled), as the
reference stands up its meshes over ``--xla_force_host_platform_device_count=8``
fake host devices. The store reads a virtual mesh's cells one by one onto
that one card, and ``distributed.spmd.shard_map`` runs them in turn on it.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    devices: np.ndarray  # of torch.device, one per mesh cell
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} cannot "
                             f"carry axes {self.axis_names}")


def _cuda_devices():
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n)]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1) -> Mesh:
    """Small mesh over this host's CUDA devices (tests/examples)."""
    return make_mesh((data, model), ("data", "model"))


def make_mesh(shape: Sequence[int], axes: Sequence[str], devices=None
              ) -> Mesh:
    """A mesh of ``shape`` with any axes, such as ``("pod",)`` or
    ``("data", "model")``, over ``devices`` (the first cells' worth of
    CUDA devices when unset; raises when there are fewer). Passing the
    same device several times builds a virtual mesh, as
    ``make_elastic_mesh`` does: ``shard_map`` then runs every cell on
    that one device (``distributed.spmd``)."""
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axes)} "
                         f"differ in rank")
    n = int(np.prod(shape))
    devices = _cuda_devices() if devices is None else list(devices)
    if len(devices) < n:
        raise RuntimeError(f"need {n} devices, have {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(tuple(shape)), tuple(axes))


def make_elastic_mesh(data: int = 1, model: int = 1, *, devices=None) -> Mesh:
    """("data", "model") mesh over an explicit device PREFIX — the
    elastic-restore shapes.

    ``devices`` defaults to the first data*model CUDA devices and raises
    when there are fewer. Passing ``[dev] * (data * model)`` builds a
    virtual mesh on one device (``dev`` may be the CPU): the source and
    target meshes of an elastic restore then stand side by side on one
    card."""
    return make_mesh((data, model), ("data", "model"), devices)


def mesh_axis_sizes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.devices.shape))
