"""whisper-small — encoder-decoder audio model, conv frontend stubbed
[arXiv:2212.04356; unverified].

12L(enc)+12L(dec) d_model=768 12H (kv=12, i.e. MHA) d_ff=3072 vocab=51865.
``input_specs()`` provides precomputed frame embeddings (B, 1500, d_model)
per the stub-frontend rule. Decode shapes lower the decoder (self-attn KV
cache + fixed cross-attn KV over the 1500 encoder frames).

Note: 32k/500k decode shapes exceed Whisper's real 448-token context; the
32k cell is lowered as a shape exercise (EXPERIMENTS §Dry-run notes this),
while long_500k is skipped (full attention).
"""

from repro_torch.configs.base import ArchBundle, ModelConfig, RunConfig

MODEL = ModelConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,  # decoder layers
    encoder_layers=12,
    encoder_seq=1500,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    rope_theta=10_000.0,  # we use RoPE in place of learned positions (noted in DESIGN)
)

SMOKE = ModelConfig(
    name="whisper-small-smoke",
    family="audio",
    num_layers=2,
    encoder_layers=2,
    encoder_seq=32,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    rope_theta=10_000.0,
)

BUNDLE = ArchBundle(
    arch_id="whisper-small",
    model=MODEL,
    smoke=SMOKE,
    run=RunConfig(),
    skip_shapes=(("long_500k", "full-attention enc-dec — skipped per spec"),),
)
