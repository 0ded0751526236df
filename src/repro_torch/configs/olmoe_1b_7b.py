"""olmoe-1b-7b — MoE, 64 experts top-8 [arXiv:2409.02060; hf].

16L d_model=2048 16H (GQA kv=16) d_ff=1024(per expert) vocab=50304.
"""

from repro_torch.configs.base import ArchBundle, ModelConfig, RunConfig

MODEL = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    num_experts=64,
    experts_per_token=8,
    rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="olmoe-1b-7b-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=64,
    vocab_size=256,
    num_experts=8,
    experts_per_token=2,
    rope_theta=10_000.0,
)

BUNDLE = ArchBundle(
    arch_id="olmoe-1b-7b",
    model=MODEL,
    smoke=SMOKE,
    run=RunConfig(microbatch_per_data_shard=8),
    skip_shapes=(("long_500k", "full-attention MoE — skipped per spec"),),
)
