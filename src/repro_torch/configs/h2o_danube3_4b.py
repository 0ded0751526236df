"""h2o-danube-3-4b — llama+mistral mix with sliding-window attention
[arXiv:2401.16818; unverified].

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000.
SWA makes decode state O(window) — runs long_500k.
"""

from repro_torch.configs.base import ArchBundle, ModelConfig, RunConfig

MODEL = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    sliding_window=4096,
    rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="h2o-danube-3-4b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=160,
    vocab_size=256,
    sliding_window=32,
    rope_theta=10_000.0,
)

BUNDLE = ArchBundle(
    arch_id="h2o-danube-3-4b",
    model=MODEL,
    smoke=SMOKE,
    run=RunConfig(microbatch_per_data_shard=4, scan_group=6),
)
