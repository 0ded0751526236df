"""llama-3.2-vision-11b — VLM with gated cross-attention image layers
[hf:meta-llama/Llama-3.2-11B-Vision; unverified].

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256; every 5th layer is
a gated cross-attention layer attending to stub-provided patch embeddings.
"""

from repro_torch.configs.base import ArchBundle, ModelConfig, RunConfig

MODEL = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    cross_attn_every=5,
    num_image_tokens=6404,  # 4 tiles x 1601 patch embeddings (stub frontend)
    rope_theta=500_000.0,
)

SMOKE = ModelConfig(
    name="llama-3.2-vision-smoke",
    family="vlm",
    num_layers=4,  # one cross-attn super-block of period 2 x 2
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    cross_attn_every=2,
    num_image_tokens=16,
    rope_theta=500_000.0,
)

BUNDLE = ArchBundle(
    arch_id="llama-3.2-vision-11b",
    model=MODEL,
    smoke=SMOKE,
    run=RunConfig(microbatch_per_data_shard=4),
    skip_shapes=(("long_500k", "full-attention VLM — skipped per spec"),),
)
