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
multi-process step (``model_axis``) every rank streams every partition
through the real exchange (the encoder's gathers are collective over the
axis), keeps only the core rows of its own row block of the embeddings
(:func:`encode_entity_block`: no ``(N, d)`` tensor exists on the rank)
and ranks that block (``eval.sharded.make_sharded_rank_step``).
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
from repro_torch.sharding.embedding import ModelAxis, ShardedTableLayout


def _device_of(params: Mapping) -> torch.device:
    return next(iter(params["layers"][0].parameters())).device


def _padded_partitions(train_kg: KnowledgeGraph, num_hops: int,
                       partitions, padded) -> PaddedPartitionBatch:
    """The padded batch the encode streams: ``padded``, or the
    partitions padded, or the graph as one partition."""
    if padded is None:
        if partitions is None:
            partitions = expand_all(
                train_kg, partition_graph(train_kg, 1, "random", seed=0),
                num_hops)
        padded = pad_partitions(partitions)
    return padded


@torch.no_grad()
def _encode_rows(params: Mapping, kge_cfg: KGEConfig,
                 train_kg: KnowledgeGraph, num_hops: int, features,
                 partitions, padded, model_axis: Optional[ModelAxis],
                 lo: int, rows: int) -> torch.Tensor:
    """Rows ``[lo, lo + rows)`` of the ``(N, d)`` embeddings (zeros past
    ``N``), streamed partition by partition: each partition's core rows
    that fall in the range are written, the last partition written
    winning a row that several hold."""
    padded = _padded_partitions(train_kg, num_hops, partitions, padded)
    dev = _device_of(params)
    v_idx = torch.arange(padded.padded_vertices, device=dev)
    out: Optional[torch.Tensor] = None
    for i, part in enumerate(eval_partition_batches(padded, dev)):
        h = encode_partition(params, kge_cfg, part, features=features,
                             model_axis=model_axis)
        if out is None:
            out = torch.zeros((rows, h.shape[1]), dtype=torch.float32,
                              device=dev)
        local = part["local_to_global"] - lo
        mine = part["vertex_mask"] & (
            v_idx < int(padded.num_core_vertices[i])) & (local >= 0) & (
            local < rows)
        out[local[mine]] = h[mine]
    if out is None:
        raise ValueError("no partitions to encode")
    return out


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
    return _encode_rows(params, kge_cfg, train_kg, num_hops, features,
                        partitions, padded, model_axis, 0,
                        train_kg.num_entities)


def encode_entity_block(
    params: Mapping,
    kge_cfg: KGEConfig,
    train_kg: KnowledgeGraph,
    num_hops: int,
    model_axis: ModelAxis,
    features: Optional[torch.Tensor] = None,
    partitions: Optional[Sequence[SelfSufficientPartition]] = None,
    padded: Optional[PaddedPartitionBatch] = None,
) -> torch.Tensor:
    """This rank's ``(1, rows, d)`` row block of the embeddings of
    :func:`encode_all_entities` on the model axis ``model_axis``: rows
    ``[m·rows, (m+1)·rows)`` of the ``(N, d)`` matrix, ``m`` the rank's
    index and ``rows = ceil(N / S)`` (``sharding.embedding.
    ShardedTableLayout``), zeros on the layout's padded tail. Every rank
    of the axis streams every partition in the same order (the encoder's
    gathers exchange rows over it) and writes only the core rows that
    fall in its block, so the last partition written wins a core row
    shared by several, as in the whole matrix: each row holds the bits
    the whole matrix holds there. No tensor with the dimension ``N``
    exists on the rank."""
    rows = ShardedTableLayout(train_kg.num_entities,
                              model_axis.size).rows_per_shard
    return _encode_rows(params, kge_cfg, train_kg, num_hops, features,
                        partitions, padded, model_axis,
                        model_axis.index * rows, rows)[None]


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
    and each rank of the axis keeps and ranks only its own row block of
    the embeddings (:func:`encode_entity_block`): the same metrics on
    every rank, exactly the simulated ones."""
    train_kg = splits["train"].with_inverse_relations()
    kw = dict(features=features, partitions=partitions, padded=padded)
    learned = kge_cfg.rgcn.feature_dim is None
    num_shards = kge_cfg.num_table_shards if learned else 1
    rank_step = None
    if model_axis is None:
        emb = encode_all_entities(params, kge_cfg, train_kg, num_hops, **kw)
    else:
        emb = encode_entity_block(params, kge_cfg, train_kg, num_hops,
                                  model_axis, **kw)
        num_shards = model_axis.size
        rank_step = make_sharded_rank_step(model_axis, decoder=decoder)
    decoder_params = {k: v.detach() for k, v in params["decoder"].items()}
    metrics = evaluate_both_directions(
        emb, decoder_params, splits[split],
        [splits["train"], splits["valid"], splits["test"]],
        num_relations_base=splits["train"].num_relations, decoder=decoder,
        num_shards=num_shards,
        table_dtype=kge_cfg.rgcn.table_dtype if learned else "fp32",
        device=emb.device, rank_step=rank_step,
        num_entities=train_kg.num_entities)
    return {f"{split}_{k}": v for k, v in metrics.items()}
