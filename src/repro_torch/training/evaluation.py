"""Evaluation-time encoding + filtered ranking (port of
``repro/training/evaluation.py``; paper §4.3).

The encoder pass STREAMS over self-sufficient partitions: each partition
is encoded with ``encode_partition`` and its CORE vertices are scattered
into the global embedding matrix. Core vertices carry their full
``num_hops`` receptive field inside the partition (the self-sufficiency
invariant), so the streamed embeddings equal a full-graph encode. With a
row-sharded entity table the encoder gathers through the in-graph plan.
Ranking then goes through ``repro_torch.eval.ranking``: dense, or sharded
over the table's row blocks when the table is sharded or int8. Under the
multi-process step (``model_axis``) every rank encodes with its own row
block through the real exchange and ranks its own block
(``eval.sharded.make_sharded_rank_step``).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch

from repro_torch.core import (
    KnowledgeGraph, expand_all, pad_partitions, partition_graph,
)
from repro_torch.core.expansion import (
    PaddedPartitionBatch, SelfSufficientPartition,
)
from repro_torch.data.pipeline import eval_partition_batches
from repro_torch.eval.ranking import evaluate_both_directions
from repro_torch.eval.sharded import make_sharded_rank_step
from repro_torch.models.kge import KGEConfig, encode_partition
from repro_torch.sharding.embedding import ModelAxis


def _device_of(params: Mapping) -> torch.device:
    return next(iter(params["layers"][0].parameters())).device


@torch.no_grad()
def encode_all_entities(
    params: Mapping,
    kge_cfg: KGEConfig,
    train_kg: KnowledgeGraph,
    num_hops: int,
    features: Optional[torch.Tensor] = None,
    partitions: Optional[Sequence[SelfSufficientPartition]] = None,
    padded: Optional[PaddedPartitionBatch] = None,
    model_axis: Optional[ModelAxis] = None,
) -> torch.Tensor:
    """``(N, d)`` embeddings of every entity, on the parameters' device,
    streamed partition by partition; core rows only are scattered (a
    support vertex at the receptive-field boundary is core elsewhere).
    Without ``partitions``/``padded`` the graph is one partition. Isolated
    entities keep zero rows. ``model_axis``: the parameters hold this
    rank's row block of the table (the multi-process step); every rank of
    the axis gets the same embeddings."""
    if padded is None:
        if partitions is None:
            partitions = expand_all(
                train_kg, partition_graph(train_kg, 1, "random", seed=0),
                num_hops)
        padded = pad_partitions(partitions)
    dev = _device_of(params)
    v_idx = torch.arange(padded.padded_vertices, device=dev)
    out: Optional[torch.Tensor] = None
    for i, part in enumerate(eval_partition_batches(padded, dev)):
        h = encode_partition(params, kge_cfg, part, features=features,
                             model_axis=model_axis)
        if out is None:
            out = torch.zeros((train_kg.num_entities, h.shape[1]),
                              dtype=torch.float32, device=dev)
        core = part["vertex_mask"] & (
            v_idx < int(padded.num_core_vertices[i]))
        out[part["local_to_global"][core]] = h[core]
    if out is None:
        raise ValueError("no partitions to encode")
    return out


def evaluate_split(
    params: Mapping,
    kge_cfg: KGEConfig,
    splits: Dict[str, KnowledgeGraph],
    split: str,
    num_hops: int,
    decoder: str,
    features: Optional[torch.Tensor] = None,
    partitions: Optional[Sequence[SelfSufficientPartition]] = None,
    padded: Optional[PaddedPartitionBatch] = None,
    model_axis: Optional[ModelAxis] = None,
) -> Dict[str, float]:
    """Filtered MRR / Hits@k on ``split`` (both directions, paper
    protocol), keys prefixed with the split's name; with a row-sharded
    entity table the ranking is sharded over its row blocks, and with an
    int8 table it ranks over the quantized embeddings. With ``model_axis``
    (the multi-process step) the encode gathers through the real exchange
    and the ranking runs on the axis's ranks, each over its own row block
    of the embeddings: the same metrics on every rank, exactly the
    simulated ones."""
    emb = encode_all_entities(
        params, kge_cfg, splits["train"].with_inverse_relations(), num_hops,
        features=features, partitions=partitions, padded=padded,
        model_axis=model_axis)
    decoder_params = {k: v.detach() for k, v in params["decoder"].items()}
    learned = kge_cfg.rgcn.feature_dim is None
    num_shards = kge_cfg.num_table_shards if learned else 1
    rank_step = None
    if model_axis is not None:
        num_shards = model_axis.size
        rank_step = make_sharded_rank_step(model_axis, decoder=decoder)
    metrics = evaluate_both_directions(
        emb, decoder_params, splits[split],
        [splits["train"], splits["valid"], splits["test"]],
        num_relations_base=splits["train"].num_relations, decoder=decoder,
        num_shards=num_shards,
        table_dtype=kge_cfg.rgcn.table_dtype if learned else "fp32",
        device=emb.device, rank_step=rank_step)
    return {f"{split}_{k}": v for k, v in metrics.items()}
