"""``--arch <id>`` registry over the 10 assigned architectures."""

from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import ArchBundle


def _load() -> Dict[str, ArchBundle]:
    from repro_torch.configs import (
        h2o_danube3_4b,
        llama3_405b,
        llama4_scout_17b_a16e,
        llama32_vision_11b,
        olmoe_1b_7b,
        qwen15_110b,
        rwkv6_7b,
        smollm_135m,
        whisper_small,
        zamba2_7b,
    )

    bundles = [
        llama3_405b.BUNDLE,
        smollm_135m.BUNDLE,
        qwen15_110b.BUNDLE,
        h2o_danube3_4b.BUNDLE,
        olmoe_1b_7b.BUNDLE,
        llama4_scout_17b_a16e.BUNDLE,
        llama32_vision_11b.BUNDLE,
        rwkv6_7b.BUNDLE,
        whisper_small.BUNDLE,
        zamba2_7b.BUNDLE,
    ]
    return {b.arch_id: b for b in bundles}


_REGISTRY: Dict[str, ArchBundle] = {}


def get(arch_id: str) -> ArchBundle:
    global _REGISTRY
    if not _REGISTRY:
        _REGISTRY = _load()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def arch_ids() -> List[str]:
    global _REGISTRY
    if not _REGISTRY:
        _REGISTRY = _load()
    return sorted(_REGISTRY)
