"""llama3-405b — dense GQA, 128k vocab [arXiv:2407.21783; unverified].

126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256.
"""

from repro_torch.configs.base import ArchBundle, ModelConfig, RunConfig

MODEL = ModelConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    rope_theta=500_000.0,
)

SMOKE = ModelConfig(
    name="llama3-405b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    rope_theta=500_000.0,
)

# 405B does not fit fp32 Adam (+fp32 master) on 256 x 16GB chips: bf16
# weights (TPU MXU accumulates fp32 internally; cross-shard reduces in bf16
# like Megatron), bf16 first moment, factored second moment, microbatch=1
# with accumulation. An fp32-master-in-optstate option exists
# (RunConfig.master_weights) and is exercised in tests; it pushes this cell
# past 16 GB on a single pod, so the flagship cell runs pure-bf16 — see
# EXPERIMENTS.md §Dry-run for the accounting.
_RUN = RunConfig(
    param_dtype="bfloat16",
    moment_dtype="bfloat16",
    factored_second_moment=True,
    microbatch_per_data_shard=1,
    grad_accum_dtype="bfloat16",
    scan_group=6,  # 126 = 21x6: balances remat slices vs per-group gathered weights
)

BUNDLE = ArchBundle(
    arch_id="llama3-405b",
    model=MODEL,
    smoke=SMOKE,
    run=_RUN,
    skip_shapes=(("long_500k", "pure full-attention arch; 500k decode is quadratic-cache — skipped per spec"),),
)
