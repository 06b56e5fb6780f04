"""Candidate-axis-sharded scoring and ranking over the row-sharded entity
table (port of the single-device part of ``repro/eval/sharded.py``).

Shard ``s`` owns table rows ``[s·rows, (s+1)·rows)``. Its ``(B, rows)``
score block is the ``kge_score`` kernel over its own prepared rows, and its
filter-bias block comes straight from the CSR index's column-range form,
``-inf`` on layout-padded tail rows — the dense ``(B, N)`` score or bias
matrix never exists. Ranking sums each shard's counts of candidates
scoring above and equal to the true tail, whose score is read from the
owning shard's block, so the metrics are exactly the dense ones.

The ogbl candidate-list protocol rides the same row blocks: each query's
true tail and candidate ids are scattered by owning block
(``plan_local_gather`` on the ``(B, 1 + C)`` id matrix); every shard
scores all lanes from its own block (a lane it does not own reads a
clipped row) with the dense protocol's product shape, the true score is
the owning shard's lane 0, and each shard counts only the candidate lanes
it owns (:func:`sharded_candidate_rank_counts`). Sharding spreads the
table, not the scoring work.

An int8 table is a ``(codes, scales)`` pair: only codes and scales live
on the device, one shard's block is dequantized at a time, and head rows
come through the fused dequantizing gather, so the metrics are exactly
the dense ones over the dequantized table.

Two execution paths, as in the reference: the simulation loops over every
shard's block in one process; a :func:`make_sharded_rank_step` product
runs on the ranks of a model axis (the multi-process step's), each rank
holding its own table block and its own bias block or candidate plan, the
true score and the integer counts summed over the axis with
``all_reduce`` — the simulated counts exactly.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.eval.ranking import (
    CSRFilterIndex, _filter_bias, candidate_lanes, candidate_scores,
    mean_rank, metrics_from_ranks,
)
from repro_torch.kernels.ops import kge_score_padded
from repro_torch.models.decoders import Decoder, get_decoder
from repro_torch.sharding.embedding import (
    TABLE_DTYPES, ModelAxis, ShardedTableLayout, dequantize_rows,
    exchange_rows, plan_local_gather, quantize_rows, shard_table,
    sharded_dequant_gather, sharded_gather,
)

RANK_PROTOCOLS = ("all-entities", "candidates")


def num_table_blocks(table) -> int:
    """Shard count of an ``(S, rows, d)`` fp32 stack or of an int8
    ``(codes, scales)`` pair."""
    return (table[0] if isinstance(table, tuple) else table).shape[0]


def table_block(table, s: int) -> torch.Tensor:
    """Shard ``s``'s fp32 ``(rows, d)`` block; an int8 pair's block is
    dequantized here, transiently — only one shard's rows exist in fp32
    at a time."""
    if isinstance(table, tuple):
        codes, scales = table
        return dequantize_rows(codes[s], scales[s])
    return table[s]


def table_rows(table, local_ids, owned, *, inverse=None) -> torch.Tensor:
    """Rows of an fp32 stack or an int8 ``(codes, scales)`` pair from an
    ``(S, V)`` plan: the fused gather or the fused dequantizing gather,
    both bitwise the dense gather over the (dequantized) table."""
    if isinstance(table, tuple):
        return sharded_dequant_gather(*table, local_ids, owned,
                                      inverse=inverse)
    return sharded_gather(table, local_ids, owned, inverse=inverse)


def shard_filter_bias_block(filter_index, batch: np.ndarray,
                            layout: ShardedTableLayout,
                            shard: int, resolved=None) -> np.ndarray:
    """One shard's ``(B, rows_per_shard)`` filter-bias column block, from
    the index's column-range form, with ``-inf`` on layout-padded tail
    columns so a padded row can neither outrank nor tie a real candidate.
    ``resolved`` is a cached ``CSRFilterIndex.resolve_queries(batch)``."""
    rows = layout.rows_per_shard
    lo, hi = layout.shard_row_span(shard)
    width = hi - lo
    if width == rows:                  # interior shard: no layout padding
        return _filter_bias(filter_index, batch, rows, col_start=lo,
                            resolved=resolved)
    block = np.full((np.asarray(batch).shape[0], rows), -np.inf, np.float32)
    if width:
        block[:, :width] = _filter_bias(filter_index, batch, width,
                                        col_start=lo, resolved=resolved)
    return block


def shard_scores(decoder: Decoder, dec_params, table_block: torch.Tensor,
                 q: torch.Tensor, q_bias: torch.Tensor,
                 bias_block: torch.Tensor, *, prepared=None
                 ) -> torch.Tensor:
    """One shard's ``(B, rows)`` kernel scores from its table block (or its
    cached ``prepared`` candidates) and the shared query rows. Preparation
    is row-local and each score is one fixed-order sum in the kernel, so
    each column is bitwise the matching column of the dense block."""
    cand, c_bias = (prepared if prepared is not None else
                    decoder.prepare_candidates(dec_params, table_block))
    return kge_score_padded(q, cand, bias_block, q_bias, c_bias,
                            epilogue=decoder.epilogue)


def owner_score(values: Sequence[torch.Tensor], owned) -> torch.Tensor:
    """``(B,)`` per-query values read from the shard that owns each query:
    ``values[s]`` is shard ``s``'s ``(B,)`` reading, ``owned[s]`` where it
    owns the query's id. One real value plus zeros, so the sum is that
    value."""
    zero = torch.zeros((), dtype=torch.float32, device=values[0].device)
    return sum(torch.where(owned[s], v, zero) for s, v in enumerate(values))


def entity_counts(scores: Sequence[torch.Tensor], true_score: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-entities protocol: each shard's ``(B, rows)`` scores above and
    equal to ``true_score``, summed over the shards."""
    true = true_score[:, None]
    return (sum((sc > true).sum(1) for sc in scores),
            sum((sc == true).sum(1) for sc in scores))


def candidate_counts(scores: Sequence[torch.Tensor], lane_owned,
                     true_score: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidate protocol: the owned candidate lanes (lane 0, the true
    tail, left out) of each shard's ``(B, 1 + C)`` scores above and equal
    to ``true_score``."""
    true = true_score[:, None]
    greater = sum((lane_owned[s, :, 1:] & (sc[:, 1:] > true)).sum(1)
                  for s, sc in enumerate(scores))
    equal = sum((lane_owned[s, :, 1:] & (sc[:, 1:] == true)).sum(1)
                for s, sc in enumerate(scores))
    return greater, equal


def sharded_rank_counts(decoder: Decoder, dec_params, table,
                        q: torch.Tensor, q_bias: torch.Tensor,
                        bias_blocks: Sequence[torch.Tensor],
                        true_local: torch.Tensor, true_owned: torch.Tensor,
                        prepared: Optional[Sequence] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-query global rank counts from per-shard kernel scores over the
    ``(S, rows, d)`` table (or int8 ``(codes, scales)`` pair, see
    :func:`table_block`): ``(greater, equal, true_score)``. ``equal``
    includes the true candidate's own tie (``mean_rank`` discounts it).
    The true score is read from the owning shard's block, not recomputed,
    so it is bitwise the dense ``scores[b, t]`` and the comparisons agree
    with the dense path at exact ties. ``bias_blocks[s]`` must be ``-inf``
    on layout-padded rows."""
    rows_idx = torch.arange(q.shape[0], device=q.device)
    scores = [shard_scores(decoder, dec_params, table_block(table, s), q,
                           q_bias, bias_blocks[s],
                           prepared=None if prepared is None
                           else prepared[s])
              for s in range(num_table_blocks(table))]
    true_score = owner_score([sc[rows_idx, true_local[s]]
                              for s, sc in enumerate(scores)], true_owned)
    return entity_counts(scores, true_score) + (true_score,)


def sharded_candidate_rank_counts(decoder: Decoder, dec_params, table,
                                  q: torch.Tensor, q_bias: torch.Tensor,
                                  lane_local: torch.Tensor,
                                  lane_owned: torch.Tensor
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """ogbl candidate-list protocol over the ``(S, rows, d)`` table (or
    int8 pair): per-query ``(greater, equal, true_score)`` from the ``(S,
    B, 1 + C)`` scattered plan of :func:`candidate_lanes` (lane 0 the true
    tail). Each shard gathers ``(B, 1 + C, d)`` rows from its own block and
    scores every lane with :func:`candidate_scores`, the dense protocol's
    product shape, so each owned lane's score is the dense score's bits.
    The true score is read from the owning shard's lane 0; lanes a shard
    does not own are masked out of its counts. ``equal`` leaves out the
    true tail, which the lists do not hold (``mean_rank(greater, equal +
    1)``)."""
    scores = [candidate_scores(decoder, dec_params, q, q_bias,
                               table_block(table, s)[lane_local[s]])
              for s in range(num_table_blocks(table))]
    true_score = owner_score([sc[:, 0] for sc in scores],
                             lane_owned[:, :, 0])
    return candidate_counts(scores, lane_owned, true_score) + (true_score,)


def make_sharded_rank_step(axis: ModelAxis, *,
                           decoder: Union[str, Decoder] = "distmult",
                           protocol: str = "all-entities") -> Callable:
    """The rank-count step of one rank of a model axis (the multi-process
    twin of :func:`sharded_rank_counts` / :func:`sharded_candidate_rank_counts`):
    its table argument is this rank's ``(1, rows, d)`` block (or int8
    pair), and its bias block ``(1, B, rows)`` and true-tail plan ``(1,
    B)`` (``"all-entities"``), or its lane plan ``(1, B, 1 + C)``
    (``"candidates"``), are this rank's own. The rank scores its block,
    the true score is summed over the axis (one real value plus zeros),
    then the integer counts: every rank gets the simulated counts exactly.

    ``step(dec_params, table, q, q_bias, bias, true_local, true_owned)``
    or ``step(dec_params, table, q, q_bias, lane_local, lane_owned)``,
    both ``-> (greater, equal, true_score)``."""
    dec = get_decoder(decoder)
    if protocol not in RANK_PROTOCOLS:
        raise ValueError(
            f"unknown protocol {protocol!r}; choose 'all-entities' (score "
            f"every table row) or 'candidates' (ogbl per-row candidate "
            f"lists)")

    def total(x: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(x, group=axis.group)
        return x

    if protocol == "all-entities":
        def step(dec_params, table, q, q_bias, bias, true_local, true_owned):
            sc = shard_scores(dec, dec_params, table_block(table, 0), q,
                              q_bias, bias[0])
            rows_idx = torch.arange(q.shape[0], device=q.device)
            true = total(owner_score([sc[rows_idx, true_local[0]]],
                                     true_owned))
            greater, equal = entity_counts([sc], true)
            return total(greater), total(equal), true
    else:
        def step(dec_params, table, q, q_bias, lane_local, lane_owned):
            sc = candidate_scores(dec, dec_params, q, q_bias,
                                  table_block(table, 0)[lane_local[0]])
            true = total(owner_score([sc[:, 0]], lane_owned[:, :, 0]))
            greater, equal = candidate_counts([sc], lane_owned, true)
            return total(greater), total(equal), true

    step.decoder, step.protocol, step.axis = dec, protocol, axis
    return step


def sharded_ranking_metrics(entity_emb, decoder_params: Dict,
                            test_triplets: np.ndarray, filter_index,
                            num_shards: int,
                            hits_ks: Sequence[int] = (1, 3, 10),
                            batch_size: int = 256,
                            decoder: Union[str, Decoder] = "distmult",
                            candidates: Optional[np.ndarray] = None,
                            table_dtype: str = "fp32",
                            device=None, rank_step=None,
                            num_entities: Optional[int] = None
                            ) -> Dict[str, float]:
    """Filtered MRR / Hits@k with candidate-axis-sharded ranking, the
    ``num_shards > 1`` twin of ``ranking.ranking_metrics``, in either
    protocol: the table is row-sharded once, and per test batch the heads
    are fetched through the sharded gather (bitwise the dense rows).
    All-entities protocol: each shard's filter-bias block is built from
    the CSR index and each shard scores its own rows with one
    ``kge_score`` launch. Candidate protocol (``candidates`` ``(T, C)``):
    each query's true tail and list are scattered by owning block and
    counted by :func:`sharded_candidate_rank_counts`. Returns exactly the
    dense metrics.

    ``table_dtype="int8"`` stores the table as row-wise codes and scales
    (``quantize_rows``): each shard's block is dequantized transiently at
    score time and rows come through the fused dequantizing gather, so
    the metrics are exactly the dense metrics over the dequantized table.

    ``rank_step`` (a :func:`make_sharded_rank_step` of the same decoder and
    protocol, on a model axis of ``num_shards`` ranks) runs the
    multi-process path. ``entity_emb`` is then this rank's ``(1, rows,
    d)`` row block of a table of ``num_entities`` rows
    (``training.evaluation.encode_entity_block``), and no ``(N, d)``
    array reaches the device: the layout comes from ``num_entities``;
    this rank scores against only its own block, bias blocks and plans
    (the int8 codes are its block's, row-wise the whole table's); its
    heads come through its block's masked gather summed over the axis;
    the step sums the counts. In the candidate protocol every rank scores
    all ``B × (1 + C)`` lanes from its block, as the reference does, for
    fixed shapes. With a ``rank_step``, an array of any other shape than
    the block's (a whole matrix among them) is refused; which rank's rows
    a block of the right shape holds is the caller's to get right."""
    if table_dtype not in TABLE_DTYPES:
        raise ValueError(
            f"table_dtype={table_dtype!r} not in {TABLE_DTYPES}")
    dec = get_decoder(decoder)
    protocol = "all-entities" if candidates is None else "candidates"
    if rank_step is not None:
        for what, want, got in (("decoder", dec, rank_step.decoder),
                                ("protocol", protocol, rank_step.protocol),
                                ("shard count", num_shards,
                                 rank_step.axis.size)):
            if want != got:
                raise ValueError(f"rank_step was built for {what} {got!r} "
                                 f"but this ranking runs {want!r}")
    if device is None and isinstance(entity_emb, torch.Tensor):
        device = entity_emb.device
    dev = resolve_device(device)
    dparams = {k: torch.as_tensor(v, dtype=torch.float32).to(dev)
               for k, v in decoder_params.items()}
    if rank_step is None:
        emb = torch.as_tensor(entity_emb, dtype=torch.float32).to(dev)
        layout = ShardedTableLayout(emb.shape[0], num_shards)
        table = shard_table(emb, layout)
        mine = slice(None)                 # every shard, in this process
    else:
        if num_entities is None:
            raise ValueError("a rank_step ranks this rank's row block: "
                             "pass num_entities, the table's rows")
        layout = ShardedTableLayout(num_entities, num_shards)
        shape = tuple(entity_emb.shape)
        if len(shape) != 3 or shape[:2] != (1, layout.rows_per_shard):
            raise ValueError(
                f"a rank_step ranks this rank's (1, "
                f"{layout.rows_per_shard}, d) row block of the "
                f"{num_entities}-row table, got {shape}")
        table = torch.as_tensor(entity_emb, dtype=torch.float32).to(dev)
        i = rank_step.axis.index
        mine = slice(i, i + 1)             # this rank's shard
    if table_dtype == "int8":
        table = quantize_rows(table)
    prepared = None if table_dtype == "int8" or candidates is not None \
        else [dec.prepare_candidates(dparams, block) for block in table]

    def device_plan(ids):
        local, owned = plan_local_gather(layout, ids)
        return (torch.from_numpy(local[mine].astype(np.int64)).to(dev),
                torch.from_numpy(owned[mine]).to(dev))

    def heads(ids):
        rows = table_rows(table, *device_plan(ids))
        if rank_step is None:
            return rows
        return exchange_rows(rows, rank_step.axis, "psum")

    ranks = []
    for lo in range(0, test_triplets.shape[0], batch_size):
        batch = np.asarray(test_triplets[lo: lo + batch_size])
        rel = torch.from_numpy(batch[:, 1].astype(np.int64)).to(dev)
        q, q_bias = dec.prepare_query(dparams, heads(batch[:, 0]), rel)
        if candidates is not None:
            lanes = device_plan(candidate_lanes(
                batch, candidates[lo: lo + batch_size]))
            greater, equal, _ = (
                sharded_candidate_rank_counts(dec, dparams, table, q,
                                              q_bias, *lanes)
                if rank_step is None else
                rank_step(dparams, table, q, q_bias, *lanes))
            ranks.append(mean_rank(greater.cpu().numpy(),
                                   equal.cpu().numpy() + 1))
            continue
        resolved = (filter_index.resolve_queries(batch)
                    if isinstance(filter_index, CSRFilterIndex) else None)
        shards = range(num_shards)[mine]
        bias = torch.stack([torch.from_numpy(shard_filter_bias_block(
            filter_index, batch, layout, s, resolved)) for s in shards]
        ).to(dev)
        true = device_plan(batch[:, 2])
        greater, equal, _ = (
            sharded_rank_counts(dec, dparams, table, q, q_bias, bias,
                                *true, prepared)
            if rank_step is None else
            rank_step(dparams, table, q, q_bias, bias, *true))
        ranks.append(mean_rank(greater.cpu().numpy(), equal.cpu().numpy()))
    return metrics_from_ranks(np.concatenate(ranks), hits_ks)
