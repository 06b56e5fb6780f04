"""Row-sharded embedding tables, the host side and the simulated
exchange (port of the single-device part of
``repro/sharding/embedding.py``).

* ``ShardedTableLayout`` — ``num_rows`` logical rows in ``num_shards``
  contiguous row blocks of ``rows_per_shard`` (= ceil(num_rows /
  num_shards)), zero-padded to ``padded_rows`` and stored as
  ``(num_shards, rows_per_shard, d)``.
* ``shard_table`` / ``unshard_table`` — dense ``(V, d)`` ⇄ sharded
  ``(S, rows, d)``.
* ``plan_local_gather`` / ``plan_unique_gather`` /
  ``ShardedGatherPlan.for_stacked`` — host numpy plans: global ids →
  per-shard LOCAL ids + ownership masks, optionally deduplicated and
  bucket-padded with a sentinel no shard owns; the input pipeline ships
  them with every mini-batch. ``plan_local_gather_device`` is the
  in-graph twin with the same integer arithmetic, for the paths that
  build their ids on the device (full-graph training, evaluation).
* ``sharded_gather`` — the single-device simulation of the exchange:
  ``"fused"`` (default) is one masked flat-index gather
  (``kernels.ops.fused_sharded_gather``), ``"masked_sum"`` the original
  per-shard take → mask → sum chain. Both are bitwise the dense
  ``table[ids]`` gather, and their gradients bitwise the dense gather's:
  every backward is ``scatter_add_onehot`` over the same slots in the
  same order.
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


def plan_local_gather_device(num_shards: int, rows_per_shard: int,
                             global_ids: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """In-graph twin of :func:`plan_local_gather` for ``(V,)`` ids on their
    device: the same integer arithmetic, so host and device plans are
    equal."""
    g = global_ids.long()
    offsets = (torch.arange(num_shards, dtype=torch.int64, device=g.device)
               * rows_per_shard)[:, None]
    local = g[None, :] - offsets
    owned = (local >= 0) & (local < rows_per_shard)
    return torch.clamp(local, 0, rows_per_shard - 1).int(), owned


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


@dataclasses.dataclass
class ShardedGatherPlan:
    """Host-precomputed per-shard gather indices for one trainer-stacked
    batch: ``local_ids`` / ``owned`` are ``(P, S, V_b)``, trainer axis
    leading. With ``dedup=True`` the plan covers each trainer row's UNIQUE
    ids (bucket-padded with unowned sentinels to a common ``(P, S, U)``)
    and ``inverse`` is the ``(P, V_b)`` expansion map applied after the
    exchange; without dedup ``inverse`` is ``None``."""

    local_ids: np.ndarray   # (P, S, V_b) int32   (V_b = U when deduped)
    owned: np.ndarray       # (P, S, V_b) bool
    inverse: Optional[np.ndarray] = None   # (P, V_b) int32 when deduped

    @classmethod
    def for_stacked(cls, layout: ShardedTableLayout,
                    gather_global: np.ndarray, *, dedup: bool = False,
                    pad_multiple: int = 64) -> "ShardedGatherPlan":
        """Plan for a trainer-stacked ``(P, V_b)`` global-id array."""
        if not dedup:
            local, owned = plan_local_gather(layout, gather_global)
            return cls(local_ids=np.moveaxis(local, 0, 1),
                       owned=np.moveaxis(owned, 0, 1))
        g = np.asarray(gather_global, dtype=np.int64)
        uniqs, inverses = zip(*(np.unique(row, return_inverse=True)
                                for row in g))
        # one bucket size across trainer rows: the stacked plan is
        # rectangular
        bucket = max(pad_multiple,
                     -(-max(len(u) for u in uniqs) // pad_multiple)
                     * pad_multiple)
        padded = np.full((g.shape[0], bucket), -1, np.int64)
        for p, u in enumerate(uniqs):
            padded[p, :len(u)] = u
        local, owned = plan_local_gather(layout, padded)  # (S, P, U)
        return cls(local_ids=np.moveaxis(local, 0, 1),
                   owned=np.moveaxis(owned, 0, 1),
                   inverse=np.stack(inverses).astype(np.int32))


# ---------------------------------------------------------------------- #
# Simulated exchange
# ---------------------------------------------------------------------- #
SIM_EXCHANGES = ("fused", "masked_sum")


def sharded_gather(table: torch.Tensor, local_ids, owned, *,
                   exchange: Optional[str] = None,
                   inverse=None, check: bool = True) -> torch.Tensor:
    """Gather ``(V, d)`` rows from the ``(S, rows, d)`` stack with an
    ``(S, V)`` plan (numpy arrays or tensors), bitwise the dense
    ``table[ids]`` gather, differentiable in ``table``.

    ``exchange="fused"`` (default) is the masked flat-index gather;
    ``"masked_sum"`` takes and masks shard by shard and sums the S
    results. ``inverse`` (from a deduplicated plan) expands the gathered
    unique rows back to batch slots after the exchange, through
    ``gather_rows``. ``check`` as in ``kernels.sharded_gather.fused_gather``:
    the training path passes ``False`` and checks once per step."""
    from repro_torch.kernels.ops import (
        fused_sharded_gather, gather_rows, masked_take,
    )

    exchange = exchange or "fused"
    if exchange not in SIM_EXCHANGES:
        raise ValueError(
            f"unknown sim exchange {exchange!r}: one of {SIM_EXCHANGES}")
    # a plan is resolved where it lies (the host, for numpy plans)
    local_ids, owned = torch.as_tensor(local_ids), torch.as_tensor(owned)
    if exchange == "fused":
        out = fused_sharded_gather(table, local_ids, owned, check=check)
    else:
        local_ids = local_ids.to(table.device)
        owned = owned.to(table.device)
        out = masked_take(table[0], local_ids[0], owned[0], check=check)
        for s in range(1, table.shape[0]):
            out = out + masked_take(table[s], local_ids[s], owned[s],
                                    check=check)
    if inverse is None:
        return out
    return gather_rows(out, torch.as_tensor(inverse).to(out.device))
