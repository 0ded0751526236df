from repro_torch.distributed.resharding import (
    ReadOp, ShardGrid, normalize_index, plan_reshard, plan_target_shard,
)
from repro_torch.distributed.sharding import (RULESETS, MeshSharding,
                                              ShardingCtx, resolve_spec)

__all__ = ["RULESETS", "MeshSharding", "ShardingCtx", "resolve_spec",
           "ShardGrid", "ReadOp", "normalize_index", "plan_reshard",
           "plan_target_shard"]
