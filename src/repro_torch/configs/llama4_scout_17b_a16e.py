"""llama4-scout-17b-a16e — MoE 16e top-1 with shared expert, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48L d_model=5120 40H (GQA kv=8) d_ff=8192(per expert) vocab=202048.
Early-fusion multimodality is a frontend stub (text path lowered here).
"""

from repro_torch.configs.base import ArchBundle, ModelConfig, RunConfig

MODEL = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    num_experts=16,
    experts_per_token=1,
    shared_expert=True,
    rope_theta=500_000.0,
)

SMOKE = ModelConfig(
    name="llama4-scout-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=96,
    vocab_size=256,
    num_experts=4,
    experts_per_token=1,
    shared_expert=True,
    rope_theta=500_000.0,
)

BUNDLE = ArchBundle(
    arch_id="llama4-scout-17b-a16e",
    model=MODEL,
    smoke=SMOKE,
    run=RunConfig(moment_dtype="bfloat16", microbatch_per_data_shard=2, scan_group=8),
    skip_shapes=(("long_500k", "global-attention layers are quadratic — skipped per spec"),),
)
