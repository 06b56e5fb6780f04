"""Row-sharded entity tables: layout, gather plans, the simulated
exchange, and the int8 table."""
from repro_torch.sharding.embedding import (
    INT8_QMAX, SIM_EXCHANGES, TABLE_DTYPES, QuantizedTableLayout,
    ShardedGatherPlan, ShardedTableLayout, convert_table_layout,
    dequantize_rows,
    dequantize_table, plan_local_gather, plan_local_gather_device,
    plan_unique_gather, quantize_rows, quantize_table, shard_table,
    sharded_dequant_gather, sharded_gather, unshard_table,
)

__all__ = ["INT8_QMAX", "SIM_EXCHANGES", "TABLE_DTYPES",
           "QuantizedTableLayout", "ShardedGatherPlan", "ShardedTableLayout",
           "convert_table_layout", "dequantize_rows", "dequantize_table", "plan_local_gather",
           "plan_local_gather_device", "plan_unique_gather", "quantize_rows",
           "quantize_table", "shard_table", "sharded_dequant_gather",
           "sharded_gather", "unshard_table"]
