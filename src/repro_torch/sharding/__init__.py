"""Row-sharded entity tables: layout, host gather plans, fused gather."""
from repro_torch.sharding.embedding import (
    ShardedTableLayout, plan_local_gather, plan_unique_gather, shard_table,
    sharded_gather, unshard_table,
)

__all__ = ["ShardedTableLayout", "plan_local_gather", "plan_unique_gather",
           "shard_table", "sharded_gather", "unshard_table"]
