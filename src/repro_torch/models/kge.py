"""Full GNN-based KGE model: RGCN encoder + decoder (port of
``repro/models/kge.py``; paper Fig. 1).

:class:`KGEModel` holds every parameter under the reference's tree names
(``entity_embedding``, ``layers.<i>.<name>``, ``decoder.<name>``) and reads
like that tree (``params["layers"]``), so the functions below mirror the
reference's signatures. With ``num_table_shards > 1`` the entity table is
the row-sharded ``(S, rows, d)`` stack of ``repro_torch.sharding``.

Two execution shapes:

* ``minibatch_loss`` — edge mini-batch (Algorithm 1): comp-graph arrays
  from ``repro_torch.core.minibatch``, vertex inputs gathered from the
  global table (through the batch's host gather plan when the table is
  sharded), RGCN, the batch triplets scored, BCE loss.
* ``fullgraph_loss`` — the full-edge-batch step on one padded partition
  (the paper's FB15k-237 setting) with constraint-based negatives drawn on
  the device. It is split in two: :func:`fullgraph_negatives` draws, and
  :func:`fullgraph_scored_loss` encodes and scores given the negatives, so
  a test can hand the second half the reference's draws.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from repro_torch.core.negative import (
    constraint_based_negatives, global_closed_world_negatives, mix_pos_neg,
)
from repro_torch.kernels.ops import EdgePlans, gather_rows
from repro_torch.kernels.rgcn_message import SegmentPlan
from repro_torch.models import decoders
from repro_torch.models.rgcn import (
    RGCNConfig, TreeModule, glorot, init_rgcn_layers, rgcn_encode,
    rgcn_layers,
)
from repro_torch.sharding.embedding import (
    ShardedTableLayout, plan_local_gather_device, shard_table,
    sharded_gather,
)


@dataclasses.dataclass(frozen=True)
class KGEConfig:
    rgcn: RGCNConfig
    # registry name or Decoder instance (paper Eq. 4 default); resolved
    # only through repro_torch.models.decoders.get_decoder
    decoder: Union[str, decoders.Decoder] = "distmult"
    num_negatives: int = 1      # paper: 1 on ogbl-citation2
    negative_sampler: str = "constraint"   # "constraint" | "global"

    @property
    def decoder_impl(self) -> decoders.Decoder:
        return decoders.get_decoder(self.decoder)

    @property
    def num_entities(self) -> int:
        return self.rgcn.num_entities

    @property
    def num_table_shards(self) -> int:
        return self.rgcn.num_table_shards

    def table_layout(self) -> Optional[ShardedTableLayout]:
        """The entity table's row-block layout, ``None`` when it is dense
        (one shard, or a feature-mode model without a table)."""
        if self.rgcn.feature_dim is not None or self.num_table_shards <= 1:
            return None
        return ShardedTableLayout(self.num_entities, self.num_table_shards)


class KGEModel(TreeModule):
    """Every parameter of the model, zero-initialised; fill it with
    :func:`init_kge_params` or ``repro_torch.convert.kge_model_from_jax``."""

    def __init__(self, cfg: KGEConfig, device=None):
        super().__init__()
        r = cfg.rgcn
        if r.feature_dim is None:
            layout = cfg.table_layout()
            rows = ((r.num_entities,) if layout is None else
                    (layout.num_shards, layout.rows_per_shard))
            self.entity_embedding = nn.Parameter(torch.zeros(
                rows + (r.hidden_dim,), dtype=torch.float32, device=device))
        self.layers = rgcn_layers(r, device)
        self.decoder = nn.ParameterDict({
            name: nn.Parameter(torch.zeros(shape, dtype=torch.float32,
                                           device=device))
            for name, shape in cfg.decoder_impl.param_shapes(
                r.num_relations, r.hidden_dim).items()})


@torch.no_grad()
def init_kge_params(rng: np.random.Generator, cfg: KGEConfig,
                    device=None) -> KGEModel:
    """A :class:`KGEModel` drawn from ``rng``: Glorot-normal entity table
    and layers (in the reference's order), then the decoder's own init. A
    row-sharded table holds the same draw as the dense one, zero-padded,
    so sharded and dense models start bitwise equal."""
    model = KGEModel(cfg, device)
    if "entity_embedding" in model:
        table = torch.from_numpy(
            glorot(rng, (cfg.num_entities, cfg.rgcn.hidden_dim)))
        layout = cfg.table_layout()
        if layout is not None:
            table = shard_table(table, layout)
        model.entity_embedding.copy_(table)
    init_rgcn_layers(model.layers, rng)
    dec = decoders.init_decoder_params(rng, cfg.decoder,
                                       cfg.rgcn.num_relations,
                                       cfg.rgcn.hidden_dim)
    for name, value in dec.items():
        model.decoder[name].copy_(value)
    return model


def vertex_input(params: Mapping, cfg: KGEConfig,
                 gather_global: torch.Tensor,
                 features: Optional[torch.Tensor],
                 shard_local_ids: Optional[torch.Tensor] = None,
                 shard_owned: Optional[torch.Tensor] = None,
                 shard_inverse: Optional[torch.Tensor] = None,
                 plans: Optional[Mapping[str, torch.Tensor]] = None
                 ) -> torch.Tensor:
    """The per-vertex model input: learned embedding rows (transductive)
    or precomputed features (ogbl-citation2 style).

    With a row-sharded ``(S, rows, d)`` entity table the dense gather
    becomes the simulated shard-local gather + exchange, driven by the
    batch's host plan (``shard_local_ids`` / ``shard_owned``, plus
    ``shard_inverse`` when deduplicated) or, without one (full-graph and
    evaluation), by the identical in-graph plan. Every combination is
    bitwise the dense gather, gradients included. The training path does
    not wait per gather for the gather kernels' bad-slot flag: the trainer
    reads it once per step.

    With ``table_dtype="int8"`` every entity-table gather quantizes the
    fp32 master and gathers through the straight-through int8 gather; a
    dense ``(N, d)`` master is gathered as a one-shard stack, so the int8
    values do not depend on the shard count.

    ``plans`` may hold the packed scatter plan of the table's gradient
    (``plan_table``: into the table's rows, the flat ``S·rows`` of a
    stacked one), as the resident full-graph batch carries a dense
    table's."""
    plans = plans or {}

    def table_plan(rows):
        return (SegmentPlan.unpack(plans["plan_table"], rows)
                if "plan_table" in plans else None)

    if cfg.rgcn.feature_dim is None:
        table = params["entity_embedding"]
        table_dtype = cfg.rgcn.table_dtype
        if table.dim() == 2 and table_dtype == "int8":
            table = table[None]
        if table.dim() == 3:
            if shard_local_ids is None:
                shard_local_ids, shard_owned = plan_local_gather_device(
                    table.shape[0], table.shape[1], gather_global)
            return sharded_gather(table, shard_local_ids, shard_owned,
                                  exchange=cfg.rgcn.gather_exchange,
                                  inverse=shard_inverse, check=False,
                                  table_dtype=table_dtype,
                                  plan=table_plan(table.shape[0] *
                                                  table.shape[1]))
        return gather_rows(table, gather_global,
                           table_plan(table.shape[0]))
    if features is None:
        raise ValueError("a feature-mode model needs features")
    return torch.index_select(features, 0, gather_global)


def _masked(x: torch.Tensor, vertex_mask: torch.Tensor) -> torch.Tensor:
    return torch.where(vertex_mask[:, None], x, torch.zeros_like(x))


def _encode(params: Mapping, cfg: KGEConfig, part: Mapping[str, torch.Tensor],
            features: Optional[torch.Tensor],
            generator: Optional[torch.Generator], train: bool
            ) -> torch.Tensor:
    x = vertex_input(params, cfg, part["local_to_global"], features,
                     part.get("shard_local_ids"), part.get("shard_owned"),
                     part.get("shard_inverse"), plans=part)
    edges = (part["src"], part["rel"], part["dst"], part["edge_mask"])
    return rgcn_encode(params, cfg.rgcn, _masked(x, part["vertex_mask"]),
                       *edges, dropout_generator=generator, train=train,
                       plans=EdgePlans.from_batch(part, *edges, x.shape[0],
                                                  cfg.rgcn.num_relations))


# ====================================================================== #
# Edge mini-batch loss (Algorithm 1 inner loop)
# ====================================================================== #
def minibatch_loss(params: Mapping, cfg: KGEConfig,
                   batch: Mapping[str, torch.Tensor],
                   features: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Loss on one padded ``EdgeMiniBatch`` (fields as tensors; batches
    of a sharded-table pipeline also carry their gather plan). Dropout is
    drawn from ``generator``; without one the encoder runs without it.
    Scatter plans a batch carries (``plan_src``, ``plan_dst``,
    ``plan_rel``, ``plan_table``) are used; the pipelines ship none, so
    the step builds each at first use (chip_smoke.py phase 6b times
    both)."""
    x = vertex_input(params, cfg, batch["gather_global"], features,
                     batch.get("shard_local_ids"), batch.get("shard_owned"),
                     batch.get("shard_inverse"), plans=batch)
    edges = (batch["comp_src"], batch["comp_rel"], batch["comp_dst"],
             batch["comp_mask"])
    h = rgcn_encode(params, cfg.rgcn, _masked(x, batch["vertex_mask"]),
                    *edges, dropout_generator=generator,
                    train=generator is not None,
                    plans=EdgePlans.from_batch(batch, *edges, x.shape[0],
                                               cfg.rgcn.num_relations))
    scores = decoders.score_triplets(params["decoder"], cfg.decoder, h,
                                     batch["triplets"])
    mask = batch["triplet_mask"].to(torch.float32)
    loss = decoders.bce_loss(scores, batch["labels"], mask)
    pos = (batch["labels"] > 0.5).to(torch.float32)
    aux = {
        "loss": loss,
        "pos_score_mean": torch.sum(scores * mask * pos)
        / torch.clamp_min(torch.sum(mask * pos), 1.0),
        "neg_score_mean": torch.sum(scores * mask * (1 - pos))
        / torch.clamp_min(torch.sum(mask * (1 - pos)), 1.0),
    }
    return loss, aux


# ====================================================================== #
# Full-graph loss on a padded self-sufficient partition
# ====================================================================== #
def positive_triplets(part: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """``(E, 3)`` local (s, r, t) of every padded edge of the partition."""
    return torch.stack([part["src"], part["rel"], part["dst"]], dim=1)


def fullgraph_negatives(cfg: KGEConfig, part: Mapping[str, torch.Tensor],
                        generator: torch.Generator) -> torch.Tensor:
    """``(E * s, 3)`` local negatives of one padded partition, drawn on the
    device from its core vertices (or, for the ``global`` ablation, from
    every local vertex)."""
    pos = positive_triplets(part)
    if cfg.negative_sampler == "global":
        neg, _ = global_closed_world_negatives(
            generator, pos, cfg.num_negatives,
            int(part["local_to_global"].shape[0]))
    else:
        neg, _ = constraint_based_negatives(
            generator, pos, cfg.num_negatives,
            int(part["num_core_vertices"]))
    return neg


def fullgraph_scored_loss(params: Mapping, cfg: KGEConfig,
                          part: Mapping[str, torch.Tensor],
                          neg: torch.Tensor,
                          generator: Optional[torch.Generator] = None,
                          features: Optional[torch.Tensor] = None,
                          train: bool = True
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Encode the partition (dropout drawn from ``generator`` when
    training), score its core edges and the given negatives, BCE loss."""
    h = _encode(params, cfg, part, features, generator, train)
    trip, labels = mix_pos_neg(positive_triplets(part), neg)
    core = part["core_edge_mask"].to(torch.float32)
    mask = torch.cat([core] * (1 + cfg.num_negatives))
    scores = decoders.score_triplets(params["decoder"], cfg.decoder, h, trip)
    loss = decoders.bce_loss(scores, labels, mask)
    return loss, {"loss": loss}


def fullgraph_loss(params: Mapping, cfg: KGEConfig,
                   part: Mapping[str, torch.Tensor],
                   generator: torch.Generator,
                   features: Optional[torch.Tensor] = None,
                   train: bool = True
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-edge-batch loss on one padded partition: negatives first, then
    dropout, both from ``generator``."""
    neg = fullgraph_negatives(cfg, part, generator)
    return fullgraph_scored_loss(params, cfg, part, neg, generator,
                                 features, train)


def encode_partition(params: Mapping, cfg: KGEConfig,
                     part: Mapping[str, torch.Tensor],
                     features: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Embed every local vertex of a partition (evaluation: no dropout)."""
    return _encode(params, cfg, part, features, None, False)
