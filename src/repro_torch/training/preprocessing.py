"""Offline preprocessing (port of ``repro/training/preprocessing.py``;
paper §3.2): partition → expand → pad → budgets.

``preprocess_graph`` turns a training KG into a ``PreprocessedGraph``: the
self-sufficient partitions, the padded full-graph batch, the replication
factor (paper Eq. 7), in mini-batch mode the comp-graph budgets and the
per-partition in-edge CSRs, and the entity table's row-block layout when
it is sharded.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.core import (
    BatchBudget, KnowledgeGraph, expand_all, pad_partitions,
    partition_graph, plan_budgets, replication_factor,
)
from repro_torch.core.expansion import (
    PaddedPartitionBatch, SelfSufficientPartition,
)
from repro_torch.core.minibatch import _PartitionCSR
from repro_torch.sharding.embedding import ShardedTableLayout


@dataclasses.dataclass
class PreprocessedGraph:
    """Everything downstream of offline preprocessing."""

    train_kg: KnowledgeGraph
    partitions: List[SelfSufficientPartition]
    padded: PaddedPartitionBatch
    replication_factor: float
    # mini-batch mode only:
    budget: Optional[BatchBudget] = None
    csrs: Optional[List[_PartitionCSR]] = None
    # the entity table's layout when it is row-sharded; None = dense
    table_layout: Optional[ShardedTableLayout] = None

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

    With ``batch_size`` set, also probes the comp-graph budgets (against
    the positive↔negative pairing the mini-batch iterator uses) and builds
    the per-partition in-edge CSRs. With ``num_table_shards > 1``, derives
    the entity table's ``ShardedTableLayout``."""
    parts = partition_graph(train_kg, num_trainers, strategy, seed=seed)
    partitions = expand_all(train_kg, parts, num_hops)
    pre = PreprocessedGraph(
        train_kg=train_kg,
        partitions=partitions,
        padded=pad_partitions(partitions),
        replication_factor=replication_factor(train_kg, parts),
        table_layout=(
            ShardedTableLayout(train_kg.num_entities, num_table_shards)
            if num_table_shards > 1 else None),
    )
    if batch_size is not None:
        pre.budget = plan_budgets(
            partitions, batch_size, num_negatives, num_hops, seed=seed,
            sampler=sampler)
        pre.csrs = [_PartitionCSR(p) for p in partitions]
    return pre
