"""Kernels: ``kge_score_tiled_kernel`` against its contract (q, the
candidates and the bias vectors read once, the ``(slots, rows)`` scores
written once; the ``(slots, rows)`` bias of known tails read only where the
cell filters) for each shard of each traced step, over its device time
(%)."""
from kgebench.yardstick import work
from kgebench.yardstick.readers import roofline


def read(facts):
    b, c, d = facts["slots"], facts["rows_per_shard"], facts["dim"]
    per_step = facts["table_shards"]
    calls = [(work.kge_score_bytes(b, c, d, facts["filtered"]),
              work.kge_score_ops(b, c, d))]
    return roofline(facts, ("kge_score_tiled_kernel",),
                    calls * per_step * len(facts.get("traced_queries", ())))
