"""Row-sharded entity tables: layout, gather plans, the simulated and the
multi-process exchanges, and the int8 table."""
from repro_torch.sharding.embedding import (
    INT8_QMAX, PLAN_BATCH_KEYS, SIM_EXCHANGES, SPMD_EXCHANGES, TABLE_DTYPES,
    ModelAxis, QuantizedTableLayout, ShardedGatherPlan, ShardedTableLayout,
    convert_table_layout, dequantize_rows,
    dequantize_table, plan_local_gather, plan_local_gather_device,
    plan_unique_gather, quantize_rows, quantize_table, shard_table,
    sharded_dequant_gather, sharded_gather, unshard_table,
)

__all__ = ["INT8_QMAX", "PLAN_BATCH_KEYS", "SIM_EXCHANGES",
           "SPMD_EXCHANGES", "TABLE_DTYPES", "ModelAxis",
           "QuantizedTableLayout", "ShardedGatherPlan", "ShardedTableLayout",
           "convert_table_layout", "dequantize_rows", "dequantize_table", "plan_local_gather",
           "plan_local_gather_device", "plan_unique_gather", "quantize_rows",
           "quantize_table", "shard_table", "sharded_dequant_gather",
           "sharded_gather", "unshard_table"]
