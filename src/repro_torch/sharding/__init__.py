"""Row-sharded entity tables: layout, gather plans, the simulated
exchange."""
from repro_torch.sharding.embedding import (
    SIM_EXCHANGES, ShardedGatherPlan, ShardedTableLayout, plan_local_gather,
    plan_local_gather_device, plan_unique_gather, shard_table,
    sharded_gather, unshard_table,
)

__all__ = ["SIM_EXCHANGES", "ShardedGatherPlan", "ShardedTableLayout",
           "plan_local_gather", "plan_local_gather_device",
           "plan_unique_gather", "shard_table", "sharded_gather",
           "unshard_table"]
