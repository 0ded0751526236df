from repro_torch.configs.base import (
    ArchBundle,
    LM_SHAPES,
    ModelConfig,
    RunConfig,
    SHAPES_BY_NAME,
    ShapeSpec,
)
from repro_torch.configs.registry import arch_ids, get

__all__ = [
    "ArchBundle",
    "LM_SHAPES",
    "ModelConfig",
    "RunConfig",
    "SHAPES_BY_NAME",
    "ShapeSpec",
    "arch_ids",
    "get",
]
