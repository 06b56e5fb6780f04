"""Offline preprocessing (port of ``repro/training/preprocessing.py``;
paper §3.2): partition → expand → pad.

``preprocess_graph`` turns a training KG into a ``PreprocessedGraph``: the
self-sufficient partitions, the padded full-graph batch and the
replication factor (paper Eq. 7). The mini-batch budgets and CSRs and the
row-sharded table layout are not ported yet and raise.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.core import (
    KnowledgeGraph, expand_all, pad_partitions, partition_graph,
    replication_factor,
)
from repro_torch.core.expansion import (
    PaddedPartitionBatch, SelfSufficientPartition,
)
from repro_torch.roadmap import not_ported


@dataclasses.dataclass
class PreprocessedGraph:
    """Everything downstream of offline preprocessing (full-graph mode)."""

    train_kg: KnowledgeGraph
    partitions: List[SelfSufficientPartition]
    padded: PaddedPartitionBatch
    replication_factor: float

    @property
    def num_partitions(self) -> int:
        return len(self.partitions)


def preprocess_graph(
    train_kg: KnowledgeGraph,
    *,
    num_trainers: int,
    strategy: str = "vertex_cut",
    num_hops: int = 2,
    seed: int = 0,
    batch_size: Optional[int] = None,
    num_negatives: int = 1,
    sampler: str = "constraint",
    num_table_shards: int = 1,
) -> PreprocessedGraph:
    """Partition ``train_kg`` and make every partition self-sufficient.
    ``num_negatives`` and ``sampler`` size the mini-batch budgets in the
    reference; the full-graph mode does not read them."""
    if batch_size is not None:
        raise not_ported(f"batch_size={batch_size} (edge mini-batches)",
                         "minibatch")
    if num_table_shards > 1:
        raise not_ported(f"num_table_shards={num_table_shards}",
                         "sharded_table")
    parts = partition_graph(train_kg, num_trainers, strategy, seed=seed)
    partitions = expand_all(train_kg, parts, num_hops)
    return PreprocessedGraph(
        train_kg=train_kg,
        partitions=partitions,
        padded=pad_partitions(partitions),
        replication_factor=replication_factor(train_kg, parts),
    )
