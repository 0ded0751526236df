"""smollm-135m — llama-arch small [hf:HuggingFaceTB/SmolLM-135M; hf].

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.
"""

from repro_torch.configs.base import ArchBundle, ModelConfig, RunConfig

MODEL = ModelConfig(
    name="smollm-135m",
    family="dense",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    rope_theta=10_000.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="smollm-135m-smoke",
    family="dense",
    num_layers=2,
    d_model=48,
    num_heads=3,
    num_kv_heads=1,
    d_ff=128,
    vocab_size=256,
    rope_theta=10_000.0,
    tie_embeddings=True,
)

BUNDLE = ArchBundle(
    arch_id="smollm-135m",
    model=MODEL,
    smoke=SMOKE,
    # 9 heads don't shard over model=16 -> attention runs unsharded per data
    # shard; microbatching keeps its activation temps bounded.
    run=RunConfig(microbatch_per_data_shard=4),
    skip_shapes=(("long_500k", "pure full-attention arch — skipped per spec"),),
)
