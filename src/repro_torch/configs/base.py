"""Config system: architecture, shape, mesh and run configuration.

The port's own copy of the reference's configs (pure Python data, equal
field for field). Every assigned architecture is a ``ModelConfig`` built in
its own ``configs/<id>.py`` file; the registry maps ``--arch <id>`` to the
bundle (full config + reduced smoke config + shape set).

Design notes
------------
* Configs are frozen dataclasses — hashable, printable, and safe to close
  over in jitted functions.
* ``ShapeSpec.kind`` selects which program is lowered: ``train`` lowers
  ``train_step``; ``prefill``/``decode`` lower serving programs (one new
  token against a KV cache of ``seq_len`` for decode).
* Sharding decisions live in ``distributed.sharding``, not here; configs
  only carry declarative facts.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Declarative architecture description (one per assigned arch)."""

    name: str
    family: str  # dense | moe | vlm | ssm | audio | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- attention options -------------------------------------------------
    qkv_bias: bool = False  # qwen1.5 style
    sliding_window: int = 0  # 0 = full attention; >0 = SWA window (danube)
    rope_theta: float = 500_000.0
    attn_logit_softcap: float = 0.0

    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1  # 1 = every layer is MoE (olmoe/scout)
    shared_expert: bool = False  # llama4 shared expert
    router_aux_loss: float = 0.01

    # --- VLM (llama-3.2-vision) ---------------------------------------------
    cross_attn_every: int = 0  # >0: every Nth layer is a gated cross-attn layer
    num_image_tokens: int = 0  # stub frontend supplies (B, T_img, d_model)

    # --- audio enc-dec (whisper) ---------------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 0  # stub conv frontend supplies (B, T_enc, d_model)

    # --- SSM / linear attention ----------------------------------------------
    ssm_state: int = 0  # mamba2 state size per head
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    wkv_head_dim: int = 64  # rwkv6 head size
    scan_chunk: int = 128  # chunked-scan block length for ssm/wkv

    # --- hybrid (zamba2) ------------------------------------------------------
    shared_attn_every: int = 0  # >0: weight-tied attn block applied every Nth layer

    # --- misc ----------------------------------------------------------------
    act: str = "silu"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    causal: bool = True

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # Convenience -------------------------------------------------------------
    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm" and self.num_heads == 0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Exact parameter count from the declarative specs (families the
        port's ``models.lm`` does not build yet raise there)."""
        from repro_torch.models import lm, params

        return params.count_params(lm.param_specs(self))


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One benchmark cell's input shape."""

    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_serving(self) -> bool:
        return self.kind in ("prefill", "decode")


TRAIN_4K = ShapeSpec("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeSpec("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeSpec("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeSpec("long_500k", "decode", 524288, 1)

LM_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in LM_SHAPES}


# ---------------------------------------------------------------------------
# Run config (training/serving knobs; the hillclimb edits these, not models)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Execution knobs for a (arch × shape × mesh) cell."""

    # dtypes
    param_dtype: str = "float32"  # master copy
    compute_dtype: str = "bfloat16"
    moment_dtype: str = "float32"  # adam m/v; bf16 for very large archs
    factored_second_moment: bool = False  # adafactor-style v for 405B
    master_weights: bool = False  # fp32 master copy kept in optimizer state

    # batching
    microbatch_per_data_shard: int = 0  # 0 = no gradient accumulation
    grad_accum_dtype: str = "float32"  # bf16 for archs that cannot fit fp32 accum

    # memory policy
    remat: str = "block"  # none | block (remat each scanned layer)
    scan_layers: bool = True
    scan_group: int = 0  # >1: two-level grouped scan (O(L/G + G) remat memory)

    # sharding strategy name (the reference's distributed.sharding.RULESETS)
    sharding_rules: str = "baseline"

    # optimizer
    optimizer: str = "adamw"
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    # distributed extras
    gradient_compression: str = "none"  # none | int8_ef | topk_ef
    pod_axis_mode: str = "dp"  # dp | pipeline
    moe_impl: str = "dense"  # dense (GShard einsum) | a2a (shard_map EP)

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Bundle: what `--arch <id>` resolves to
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ArchBundle:
    arch_id: str
    model: ModelConfig
    smoke: ModelConfig  # reduced same-family config for CPU tests
    shapes: Tuple[ShapeSpec, ...] = LM_SHAPES
    run: RunConfig = RunConfig()
    run_overrides: Tuple[Tuple[str, RunConfig], ...] = ()  # per-shape RunConfig
    skip_shapes: Tuple[Tuple[str, str], ...] = ()  # (shape_name, reason)

    def run_for(self, shape_name: str) -> RunConfig:
        for name, rc in self.run_overrides:
            if name == shape_name:
                return rc
        return self.run

    def skip_reason(self, shape_name: str) -> Optional[str]:
        for name, reason in self.skip_shapes:
            if name == shape_name:
                return reason
        return None
