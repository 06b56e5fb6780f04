"""Host graph side: triplet store, partitioning, neighbourhood expansion,
padding, the device-side negative samplers and the host edge
mini-batches."""
from repro_torch.core.expansion import (
    PaddedPartitionBatch, SelfSufficientPartition, expand_all,
    expand_partition, pad_partitions, verify_self_sufficiency,
)
from repro_torch.core.graph import (
    KnowledgeGraph, make_synthetic_kg, split_train_valid_test, triplet_set,
)
from repro_torch.core.minibatch import (
    BatchBudget, EdgeMiniBatch, build_comp_graph, build_edge_minibatch,
    iterate_edge_minibatches, negatives_of_positives, plan_budgets,
    sample_epoch_negatives, stack_minibatches,
)
from repro_torch.core.negative import (
    constraint_based_negatives, corrupt_triplets,
    global_closed_world_negatives, mix_pos_neg,
)
from repro_torch.core.partition import (
    PARTITIONERS, EdgePartition, core_vertices, edge_cut_partition,
    load_balance, partition_graph, random_partition, replication_factor,
    vertex_cut_partition,
)

__all__ = [
    "KnowledgeGraph", "make_synthetic_kg", "split_train_valid_test",
    "triplet_set", "EdgePartition", "PARTITIONERS", "core_vertices",
    "edge_cut_partition", "load_balance", "partition_graph",
    "random_partition", "replication_factor", "vertex_cut_partition",
    "PaddedPartitionBatch", "SelfSufficientPartition", "expand_all",
    "expand_partition", "pad_partitions", "verify_self_sufficiency",
    "constraint_based_negatives", "corrupt_triplets",
    "global_closed_world_negatives", "mix_pos_neg", "BatchBudget",
    "EdgeMiniBatch", "build_comp_graph", "build_edge_minibatch",
    "iterate_edge_minibatches", "negatives_of_positives", "plan_budgets",
    "sample_epoch_negatives", "stack_minibatches",
]
