"""Candidate-axis-sharded scoring and ranking over the row-sharded entity
table (port of the single-device part of ``repro/eval/sharded.py``).

Shard ``s`` owns table rows ``[s·rows, (s+1)·rows)``. Its ``(B, rows)``
score block is the ``kge_score`` kernel over its own prepared rows, and its
filter-bias block comes straight from the CSR index's column-range form,
``-inf`` on layout-padded tail rows — the dense ``(B, N)`` score or bias
matrix never exists. Ranking sums each shard's counts of candidates
scoring above and equal to the true tail, whose score is read from the
owning shard's block, so the metrics are exactly the dense ones.

An int8 table is a ``(codes, scales)`` pair: only codes and scales live
on the device, one shard's block is dequantized at a time, and head rows
come through the fused dequantizing gather, so the metrics are exactly
the dense ones over the dequantized table.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.eval.ranking import (
    CSRFilterIndex, _filter_bias, mean_rank, metrics_from_ranks,
)
from repro_torch.kernels.ops import kge_score_padded
from repro_torch.models.decoders import Decoder, get_decoder
from repro_torch.sharding.embedding import (
    TABLE_DTYPES, ShardedTableLayout, dequantize_rows, plan_local_gather,
    quantize_rows, shard_table, sharded_dequant_gather, sharded_gather,
)


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
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    true_score = sum(
        torch.where(true_owned[s], sc[rows_idx, true_local[s]], zero)
        for s, sc in enumerate(scores))
    greater = sum((sc > true_score[:, None]).sum(1) for sc in scores)
    equal = sum((sc == true_score[:, None]).sum(1) for sc in scores)
    return greater, equal, true_score


def sharded_ranking_metrics(entity_emb, decoder_params: Dict,
                            test_triplets: np.ndarray, filter_index,
                            num_shards: int,
                            hits_ks: Sequence[int] = (1, 3, 10),
                            batch_size: int = 256,
                            decoder: Union[str, Decoder] = "distmult",
                            table_dtype: str = "fp32",
                            device=None) -> Dict[str, float]:
    """Filtered MRR / Hits@k with candidate-axis-sharded ranking, the
    ``num_shards > 1`` twin of ``ranking.ranking_metrics`` (all-entities
    protocol): the table is row-sharded once; per test batch, each shard's
    filter-bias block is built from the CSR index, the heads are fetched
    through the sharded gather (bitwise the dense rows), and each shard
    scores its own rows with one ``kge_score`` launch. Returns exactly the
    dense metrics.

    ``table_dtype="int8"`` stores the table as row-wise codes and scales
    (``quantize_rows``): each shard's block is dequantized transiently at
    score time and heads come through the fused dequantizing gather, so
    the metrics are exactly the dense metrics over the dequantized
    table."""
    if table_dtype not in TABLE_DTYPES:
        raise ValueError(
            f"table_dtype={table_dtype!r} not in {TABLE_DTYPES}")
    if device is None and isinstance(entity_emb, torch.Tensor):
        device = entity_emb.device
    dev = resolve_device(device)
    dec = get_decoder(decoder)
    emb = torch.as_tensor(entity_emb, dtype=torch.float32).to(dev)
    layout = ShardedTableLayout(emb.shape[0], num_shards)
    dparams = {k: torch.as_tensor(v, dtype=torch.float32).to(dev)
               for k, v in decoder_params.items()}
    if table_dtype == "int8":
        table = quantize_rows(shard_table(emb, layout))
        prepared = None
    else:
        table = shard_table(emb, layout)
        prepared = [dec.prepare_candidates(dparams, table[s])
                    for s in range(num_shards)]

    ranks = []
    for lo in range(0, test_triplets.shape[0], batch_size):
        batch = np.asarray(test_triplets[lo: lo + batch_size])
        h_li, h_ow = plan_local_gather(layout, batch[:, 0])
        h_s = table_rows(table, h_li, h_ow)
        rel = torch.from_numpy(batch[:, 1].astype(np.int64)).to(dev)
        q, q_bias = dec.prepare_query(dparams, h_s, rel)
        t_li, t_ow = plan_local_gather(layout, batch[:, 2])
        resolved = (filter_index.resolve_queries(batch)
                    if isinstance(filter_index, CSRFilterIndex) else None)
        bias_blocks = [torch.from_numpy(shard_filter_bias_block(
            filter_index, batch, layout, s, resolved)).to(dev)
            for s in range(num_shards)]
        greater, equal, _ = sharded_rank_counts(
            dec, dparams, table, q, q_bias, bias_blocks,
            torch.from_numpy(t_li.astype(np.int64)).to(dev),
            torch.from_numpy(t_ow).to(dev), prepared)
        ranks.append(mean_rank(greater.cpu().numpy(), equal.cpu().numpy()))
    return metrics_from_ranks(np.concatenate(ranks), hits_ks)
