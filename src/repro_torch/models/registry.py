"""Model registry helpers: exact parameter counts from the declarative
specs, the counterpart of ``repro/models/registry.py``."""

from __future__ import annotations

import math

from repro_torch.configs.base import ModelConfig
from repro_torch.models import params as P


def _spec_paths(tree, path=()):
    """(key path, spec) of every leaf of a spec tree, in key order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _spec_paths(v, path + (k,))
    else:
        yield path, tree


def param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """Exact count from the specs; ``active_only`` scales the MoE expert
    weights (``w_gate``/``w_up``/``w_down`` under a ``moe`` key) by k/E,
    as the reference does."""
    from repro_torch.models import lm

    specs = lm.param_specs(cfg)
    total = P.count_params(specs)
    if not active_only or not cfg.is_moe:
        return total
    expert = sum(math.prod(spec.shape) for path, spec in _spec_paths(specs)
                 if "moe" in path
                 and any(k in ("w_gate", "w_up", "w_down") for k in path))
    return total - expert + expert * cfg.experts_per_token // cfg.num_experts
