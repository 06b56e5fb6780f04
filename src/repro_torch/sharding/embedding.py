"""Row-sharded embedding tables, the host side and the simulated fused
gather (port of the serving subset of ``repro/sharding/embedding.py``).

* ``ShardedTableLayout`` — ``num_rows`` logical rows in ``num_shards``
  contiguous row blocks of ``rows_per_shard`` (= ceil(num_rows /
  num_shards)), zero-padded to ``padded_rows`` and stored as
  ``(num_shards, rows_per_shard, d)``.
* ``shard_table`` / ``unshard_table`` — dense ``(V, d)`` ⇄ sharded
  ``(S, rows, d)``.
* ``plan_local_gather`` / ``plan_unique_gather`` — host numpy plans: global
  ids → per-shard LOCAL ids + ownership masks, the latter deduplicated and
  bucket-padded with a sentinel no shard owns.
* ``sharded_gather`` — the single-device simulation of the exchange, as the
  fused flat-index gather (``kernels.ops.fused_sharded_gather``): bitwise
  equal to the dense ``table[ids]`` gather.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

TABLE_DTYPES = ("fp32", "int8")


@dataclasses.dataclass(frozen=True)
class ShardedTableLayout:
    """Row-block layout of one embedding table over ``num_shards``."""

    num_rows: int     # logical rows (e.g. num_entities)
    num_shards: int   # shards the table is split over

    def __post_init__(self):
        if self.num_rows < 1 or self.num_shards < 1:
            raise ValueError(
                f"invalid layout: {self.num_rows} rows / "
                f"{self.num_shards} shards")

    @property
    def rows_per_shard(self) -> int:
        return -(-self.num_rows // self.num_shards)   # ceil division

    @property
    def padded_rows(self) -> int:
        return self.num_shards * self.rows_per_shard

    def shard_row_span(self, shard: int) -> Tuple[int, int]:
        """Global row range ``[lo, hi)`` of the REAL rows shard ``shard``
        stores — ``hi - lo < rows_per_shard`` on ragged tail shards, whose
        remaining local rows are layout padding (scored ``-inf``)."""
        lo = shard * self.rows_per_shard
        return lo, max(lo, min(self.num_rows, lo + self.rows_per_shard))


def shard_table(table: torch.Tensor,
                layout: ShardedTableLayout) -> torch.Tensor:
    """Dense ``(num_rows, d)`` → sharded ``(num_shards, rows_per_shard, d)``
    on the table's device (zero-padded tail)."""
    v, d = table.shape
    if v != layout.num_rows:
        raise ValueError(f"table has {v} rows, layout expects "
                         f"{layout.num_rows}")
    pad = layout.padded_rows - v
    if pad:
        table = torch.cat([table, table.new_zeros((pad, d))], dim=0)
    return table.reshape(layout.num_shards, layout.rows_per_shard, d)


def unshard_table(shards: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Sharded ``(S, rows, d)`` → dense ``(num_rows, d)`` (padding rows are
    at the flattened tail, by construction of ``shard_table``)."""
    s, rows, d = shards.shape
    if num_rows > s * rows:
        raise ValueError(f"layout holds {s * rows} rows, need {num_rows}")
    return shards.reshape(s * rows, d)[:num_rows]


# ---------------------------------------------------------------------- #
# Gather planning: global ids -> (per-shard local ids, ownership masks)
# ---------------------------------------------------------------------- #
def plan_local_gather(layout: ShardedTableLayout,
                      global_ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host (numpy) gather plan for ids of shape ``(...,)``: ``(local_ids,
    owned)`` with the shard axis LEADING, ``local_ids[s] = clip(global_ids
    - s * rows, 0, rows - 1)`` (int32) and ``owned[s]`` marking the ids
    shard ``s`` stores. Every valid global id is owned by exactly one
    shard."""
    rows = layout.rows_per_shard
    g = np.asarray(global_ids, dtype=np.int64)
    offsets = (np.arange(layout.num_shards, dtype=np.int64) * rows
               ).reshape((layout.num_shards,) + (1,) * g.ndim)
    local = g[None, ...] - offsets
    owned = (local >= 0) & (local < rows)
    return np.clip(local, 0, rows - 1).astype(np.int32), owned


def plan_unique_gather(
        layout: ShardedTableLayout, global_ids: np.ndarray,
        pad_multiple: int = 64,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Deduplicated host gather plan for ``(V,)`` ids: ``(local_ids (S, U),
    owned (S, U), inverse (V,))`` with ``U`` the unique-id count rounded up
    to ``pad_multiple``. Padding slots carry the sentinel id ``-1`` that no
    shard owns (exact zero rows); ``out[inverse]`` restores the original
    slot order after the gather."""
    g = np.asarray(global_ids, dtype=np.int64)
    if g.ndim != 1:
        raise ValueError(f"plan_unique_gather expects (V,) ids, "
                         f"got {g.shape}")
    uniq, inverse = np.unique(g, return_inverse=True)
    bucket = max(pad_multiple,
                 -(-len(uniq) // pad_multiple) * pad_multiple)
    padded = np.full(bucket, -1, np.int64)
    padded[:len(uniq)] = uniq
    local, owned = plan_local_gather(layout, padded)
    return local, owned, inverse.astype(np.int32)


# ---------------------------------------------------------------------- #
# Simulated exchange: the fused flat-index gather
# ---------------------------------------------------------------------- #
def sharded_gather(table: torch.Tensor, local_ids, owned, *,
                   inverse: Optional[np.ndarray] = None) -> torch.Tensor:
    """Gather ``(V, d)`` rows from the ``(S, rows, d)`` stack with an
    ``(S, V)`` plan (numpy arrays or tensors) through the fused flat-index
    gather — bitwise the dense ``table[ids]`` gather. ``inverse`` (from a
    deduplicated plan) expands the gathered unique rows back to batch
    slots after the gather."""
    from repro_torch.kernels.ops import fused_sharded_gather

    out = fused_sharded_gather(table, torch.as_tensor(local_ids),
                               torch.as_tensor(owned))
    if inverse is None:
        return out
    return out[torch.as_tensor(inverse, dtype=torch.int64).to(out.device)]
