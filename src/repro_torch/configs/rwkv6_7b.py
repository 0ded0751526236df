"""rwkv6-7b (Finch) — attention-free, data-dependent decay linear attention
[arXiv:2404.05892; hf].

32L d_model=4096 d_ff=14336 vocab=65536. wkv head dim 64 -> 64 heads.
Attention-free: decode state is O(1) in sequence length — runs long_500k.
"""

from repro_torch.configs.base import ArchBundle, ModelConfig, RunConfig

MODEL = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=0,  # attention-free
    num_kv_heads=0,
    head_dim=64,  # wkv head size
    d_ff=14336,
    vocab_size=65536,
    wkv_head_dim=64,
    # chunk=32 keeps the exact per-channel decay tensor (B,C,C,H,K) bounded
    scan_chunk=32,
)

SMOKE = ModelConfig(
    name="rwkv6-7b-smoke",
    family="ssm",
    num_layers=2,
    d_model=64,
    num_heads=0,
    num_kv_heads=0,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    wkv_head_dim=16,
    scan_chunk=16,
)

BUNDLE = ArchBundle(
    arch_id="rwkv6-7b",
    model=MODEL,
    smoke=SMOKE,
    run=RunConfig(microbatch_per_data_shard=4, scan_group=8),
)
