"""Sharding context for the model code.

The reference annotates tensors with logical axis names and resolves them
against a device mesh. On one card there is no mesh: ``ShardingCtx.null()``
is the only context, and ``constrain`` returns its tensor unchanged, so the
model code keeps the reference's signatures. DeviceMesh placements are
ROADMAP Queue 1 item 9.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


class ShardingCtx:
    mesh = None

    @staticmethod
    def null() -> "ShardingCtx":
        return ShardingCtx()

    def constrain(self, x: torch.Tensor,
                  logical: Sequence[Optional[str]]) -> torch.Tensor:
        return x
