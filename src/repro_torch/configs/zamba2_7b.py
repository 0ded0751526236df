"""zamba2-7b — hybrid Mamba2 backbone + weight-tied shared attention blocks
[arXiv:2411.15242; unverified].

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000 ssm_state=64.
A single weight-tied transformer block is applied every 6th layer (13
applications over 81 layers), mirroring Zamba2's shared-block design.
SSM decode state is O(1) in sequence length — runs long_500k (the shared
attention blocks keep a KV cache; with 32 kv heads it shards cleanly).
"""

from repro_torch.configs.base import ArchBundle, ModelConfig, RunConfig

MODEL = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    shared_attn_every=6,
    scan_chunk=128,
    rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="zamba2-7b-smoke",
    family="hybrid",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_expand=2,
    ssm_conv_width=4,
    shared_attn_every=2,
    scan_chunk=16,
    rope_theta=10_000.0,
)

BUNDLE = ArchBundle(
    arch_id="zamba2-7b",
    model=MODEL,
    smoke=SMOKE,
    run=RunConfig(microbatch_per_data_shard=4, scan_group=9),
)
