"""Candidate-axis-sharded scoring over the row-sharded entity table (port of
the serving subset of ``repro/eval/sharded.py``).

Shard ``s`` owns table rows ``[s·rows, (s+1)·rows)``. Its ``(B, rows)``
score block is the ``kge_score`` kernel over its own prepared rows, and its
filter-bias block comes straight from the CSR index's column-range form,
``-inf`` on layout-padded tail rows — the dense ``(B, N)`` score or bias
matrix never exists.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.eval.ranking import _filter_bias
from repro_torch.kernels.ops import kge_score_padded
from repro_torch.models.decoders import Decoder
from repro_torch.sharding.embedding import ShardedTableLayout


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
