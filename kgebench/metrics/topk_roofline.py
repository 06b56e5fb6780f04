"""Kernels: the top-k kernels (``topk_stream_kernel``, and
``topk_select_kernel`` where k is large) against their contract: each
shard's ``(slots, rows)`` scores read and its k winners written, then the
merge of the shards' winners; over their summed device time (%)."""
from kgebench.yardstick import work
from kgebench.yardstick.readers import roofline


def read(facts):
    b, c, k = facts["slots"], facts["rows_per_shard"], facts["k"]
    s, kp = facts["table_shards"], min(facts["k"], facts["rows_per_shard"])
    step = [(work.topk_scores_bytes(b, c, kp), work.topk_scores_ops(b, c))
            ] * s + [(work.topk_scores_bytes(b, s * kp, k, with_ids=True),
                      work.topk_scores_ops(b, s * kp))]
    return roofline(facts, ("topk_stream_kernel", "topk_select_kernel"),
                    step * len(facts.get("traced_queries", ())))
