"""Row-sharded embedding tables, the host side and the simulated
exchange (port of the single-device part of
``repro/sharding/embedding.py``).

* ``ShardedTableLayout`` — ``num_rows`` logical rows in ``num_shards``
  contiguous row blocks of ``rows_per_shard`` (= ceil(num_rows /
  num_shards)), zero-padded to ``padded_rows`` and stored as
  ``(num_shards, rows_per_shard, d)``.
* ``shard_table`` / ``unshard_table`` — dense ``(V, d)`` ⇄ sharded
  ``(S, rows, d)``; ``convert_table_layout`` the same for numpy tables
  at any pair of shard counts (the checkpoints' conversion).
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
* ``QuantizedTableLayout`` / ``quantize_rows`` / ``dequantize_rows`` —
  the int8 table (``table_dtype="int8"``): int8 codes in ``[-127, 127]``
  plus one fp32 scale per row, the smallest power of two ``>= amax / 127``
  over the whole fp32 range, subnormals included (exactly 0 for an
  all-zero row). ``codes = rint(x / scale)`` is then an exact division and
  ``codes · scale`` an exact product, so quantization is idempotent, the
  round-trip error is at most ``scale / 2`` per element, and dequantizing
  commutes bitwise with every gather. Serving and ranking keep only codes
  and scales (``sharded_dequant_gather``); training keeps the fp32 master
  and gathers through the straight-through
  ``kernels.ops.quantized_sharded_gather``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

TABLE_DTYPES = ("fp32", "int8")
INT8_QMAX = 127          # symmetric code range [-127, 127]
_MIN_SCALE_EXP = -149    # exponent of the smallest positive fp32


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

    def bytes_per_shard(self, dim: int, itemsize: int = 4) -> int:
        """One shard's table bytes, the quantity sharding shrinks."""
        return self.rows_per_shard * dim * itemsize

    def shard_row_span(self, shard: int) -> Tuple[int, int]:
        """Global row range ``[lo, hi)`` of the REAL rows shard ``shard``
        stores — ``hi - lo < rows_per_shard`` on ragged tail shards, whose
        remaining local rows are layout padding (scored ``-inf``)."""
        lo = shard * self.rows_per_shard
        return lo, max(lo, min(self.num_rows, lo + self.rows_per_shard))


@dataclasses.dataclass(frozen=True)
class QuantizedTableLayout(ShardedTableLayout):
    """The int8 table's layout: the same row blocks as
    :class:`ShardedTableLayout`, but a shard holds ``(rows, d)`` int8 codes
    plus ``(rows,)`` fp32 scales, ``(d + 4) / (4 d)`` of the fp32 bytes."""

    def bytes_per_shard(self, dim: int, itemsize: int = 1) -> int:
        """int8 codes (``itemsize=1``) plus one fp32 scale per row."""
        return self.rows_per_shard * (dim * itemsize + 4)


# ---------------------------------------------------------------------- #
# Row-wise symmetric int8 quantization (power-of-two scales)
# ---------------------------------------------------------------------- #
def _bit_length(m: torch.Tensor) -> torch.Tensor:
    """Bits of each non-negative int64 below ``2^32`` (0 for 0), by binary
    search on shifts."""
    n = torch.zeros_like(m)
    for s in (16, 8, 4, 2, 1):
        big = m >= (1 << s)
        n = n + torch.where(big, s, 0)
        m = torch.where(big, m >> s, m)
    return n + (m > 0).long()


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """``2^e`` for non-negative int64 exponents, by a shift."""
    return torch.ones_like(e) << e


def _int_mantissa(mag: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(M, E)`` with ``|x| = M · 2^E`` in integers, for the int64 bit
    patterns ``mag`` of non-negative fp32 values (``M`` carries the
    implicit bit of a normal value)."""
    e, m = mag >> 23, mag & 0x7FFFFF
    return (torch.where(e == 0, m, m | (1 << 23)),
            torch.where(e == 0, -149, e - 150))


def quantize_rows(table: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise symmetric int8 quantization: ``(..., rows, d)`` fp32 →
    ``(codes (..., rows, d) int8, scales (..., rows) f32)`` on the table's
    device, bitwise the reference's ``quantize_rows``.

    Integer arithmetic on the fp32 bit patterns throughout, so no float
    operation ever touches a subnormal and the result does not depend on
    a device's flush-to-zero mode. Per row, with ``amax = M · 2^E`` (``M``
    the integer mantissa, implicit bit included, of bit length ``L``) and
    ``p = E + L - 1``: ``127 · 2^(p-6) >= amax`` iff ``64 M <= 127 ·
    2^(L-1)``, so the scale exponent is ``p - 6`` or ``p - 5``, clamped to
    ``[-149, 127]``. Each code is ``rint(|x| / 2^k)`` by shifting the
    element's integer mantissa, rounding half to even."""
    bits = table.float().contiguous().view(torch.int32).long()
    mag = bits & 0x7FFFFFFF
    # for non-negative fp32 the bit pattern orders like the value
    amax = mag.amax(dim=-1) if mag.shape[-1] else torch.zeros(
        mag.shape[:-1], dtype=torch.int64, device=mag.device)
    big_m, big_e = _int_mantissa(amax)
    length = _bit_length(big_m)
    p = big_e + length - 1
    fits = 64 * big_m <= 127 * _pow2(torch.clamp_min(length - 1, 0))
    k = torch.clamp(torch.where(fits, p - 6, p - 5), _MIN_SCALE_EXP, 127)
    scale_bits = torch.where(k >= -126, (k + 127) << 23,
                             _pow2(torch.clamp(k + 149, 0, 22)))
    scale_bits = torch.where(amax > 0, scale_bits, 0)
    scales = scale_bits.int().view(torch.float32)
    # each element |x| = M · 2^E; its code magnitude rint(M · 2^(E - k))
    # is at most 127, so a left shift is at most 7 and a right shift past
    # 25 leaves less than a half
    elem_m, elem_e = _int_mantissa(mag)
    shift = elem_e - k[..., None]
    left = elem_m << torch.clamp(shift, 0, 7)
    t = torch.clamp(-shift, 1, 25)
    floor = elem_m >> t
    rem = elem_m & (_pow2(t) - 1)
    half = _pow2(t - 1)
    up = (rem > half) | ((rem == half) & ((floor & 1) == 1))
    code = torch.where(shift >= 0, left, floor + up.long())
    codes = torch.clamp(torch.where(bits < 0, -code, code), -INT8_QMAX,
                        INT8_QMAX).to(torch.int8)
    return codes, scales


def dequantize_rows(codes: torch.Tensor,
                    scales: torch.Tensor) -> torch.Tensor:
    """``codes (..., rows, d) int8 × scales (..., rows) f32 → fp32``, one
    exact power-of-two product per element."""
    return codes.float() * scales[..., None]


def quantize_table(table: torch.Tensor) -> Dict[str, torch.Tensor]:
    """A stacked ``(S, rows, d)`` (or dense ``(V, d)``) fp32 table → the
    ``{"codes", "scales"}`` form of the reference's checkpoints and
    servers."""
    codes, scales = quantize_rows(table)
    return {"codes": codes, "scales": scales}


def dequantize_table(quantized: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Inverse of :func:`quantize_table` (same stacked or dense shape)."""
    return dequantize_rows(quantized["codes"], quantized["scales"])


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


def _layout_row_range(shape) -> Tuple[int, int]:
    """Logical row counts a table shape can represent: a dense ``(V, d)``
    is exactly ``V``; a sharded ``(S, rows, d)`` is any ``V`` with
    ``rows == ceil(V / S)`` (the tail padding is less than one shard)."""
    if len(shape) == 2:
        return shape[0], shape[0]
    s, rows = shape[0], shape[1]
    return s * (rows - 1) + 1, s * rows


def convert_table_layout(arr: np.ndarray, target_shape,
                         num_rows: Optional[int] = None) -> np.ndarray:
    """Convert a numpy embedding table between layouts: dense ``(V, d)`` ⇄
    sharded ``(S, rows, d)`` (any shard count). Row blocks are contiguous,
    so flattening a sharded table recovers global row order with the zero
    padding at the tail; the conversion pads or trims that tail. Used by
    ``repro_torch.training.checkpoint`` so that checkpoints restore across
    layouts.

    Only layouts convert: the two shapes must be able to describe the same
    logical row count, else it raises (a checkpoint of another vocabulary
    is never truncated or zero-padded). A sharded shape hides the exact
    count in its tail padding (any ``V`` with ``ceil(V / S) == rows``
    fits), so pass ``num_rows``, the model's true entity count, where it is
    known: without it a mismatch smaller than one shard's padding cannot be
    seen from the shapes."""
    target_shape = tuple(target_shape)
    arr = np.asarray(arr)
    if arr.shape == target_shape:
        return arr
    if arr.ndim not in (2, 3) or len(target_shape) not in (2, 3) or \
            arr.shape[-1] != target_shape[-1]:
        raise ValueError(
            f"cannot convert table layout {arr.shape} -> {target_shape}")
    lo_a, hi_a = _layout_row_range(arr.shape)
    lo_b, hi_b = _layout_row_range(target_shape)
    if num_rows is not None and not (lo_a <= num_rows <= hi_a and
                                     lo_b <= num_rows <= hi_b):
        raise ValueError(
            f"table layouts {arr.shape} / {target_shape} cannot hold "
            f"exactly {num_rows} logical rows ({lo_a}-{hi_a} vs "
            f"{lo_b}-{hi_b}): refusing to truncate or zero-pad real "
            f"embedding rows")
    if max(lo_a, lo_b) > min(hi_a, hi_b):
        raise ValueError(
            f"table layouts {arr.shape} and {target_shape} describe "
            f"disjoint logical row counts ({lo_a}-{hi_a} vs {lo_b}-{hi_b}): "
            f"refusing to truncate or zero-pad real embedding rows")
    d = arr.shape[-1]
    dense = arr.reshape(-1, d)
    need = int(np.prod(target_shape[:-1]))
    if dense.shape[0] < need:
        dense = np.concatenate(
            [dense, np.zeros((need - dense.shape[0], d), dense.dtype)])
    return np.ascontiguousarray(dense[:need].reshape(target_shape))


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


def sharded_dequant_gather(codes: torch.Tensor, scales: torch.Tensor,
                           local_ids, owned, *, inverse=None,
                           check: bool = True) -> torch.Tensor:
    """Gather ``(V, d)`` fp32 rows straight from a quantized stack
    (``codes (S, rows, d)`` int8, ``scales (S, rows)`` f32) with an
    ``(S, V)`` plan, the dequantization fused into the gather
    (``kernels.ops.dequant_sharded_gather``): the serving and ranking
    path, where only codes and scales live on the device. Bitwise the
    dense gather of the dequantized table. No gradient. ``inverse``
    expands a deduplicated plan's rows back to batch slots."""
    from repro_torch.kernels.ops import dequant_sharded_gather

    out = dequant_sharded_gather(codes, scales, torch.as_tensor(local_ids),
                                 torch.as_tensor(owned), check=check)
    if inverse is None:
        return out
    return torch.index_select(
        out, 0, torch.as_tensor(inverse).to(out.device).long())


def sharded_gather(table: torch.Tensor, local_ids, owned, *,
                   exchange: Optional[str] = None,
                   inverse=None, check: bool = True,
                   table_dtype: str = "fp32", plan=None) -> torch.Tensor:
    """Gather ``(V, d)`` rows from the ``(S, rows, d)`` stack with an
    ``(S, V)`` plan (numpy arrays or tensors), bitwise the dense
    ``table[ids]`` gather, differentiable in ``table``.

    ``exchange="fused"`` (default) is the masked flat-index gather;
    ``"masked_sum"`` takes and masks shard by shard and sums the S
    results. ``inverse`` (from a deduplicated plan) expands the gathered
    unique rows back to batch slots after the exchange, through
    ``gather_rows``. ``check`` as in ``kernels.sharded_gather.fused_gather``:
    the training path passes ``False`` and checks once per step.

    ``table_dtype="int8"`` keeps ``table`` the fp32 master and gathers
    through the straight-through ``kernels.ops.quantized_sharded_gather``
    (quantize the master, then the fused dequantizing gather; the backward
    is the fp32 path's scatter-add), so master gradients are bitwise the
    fp32 path's on the dequantized master. Both exchanges coincide for
    int8: a masked-sum chain through the quantizer would have no gradient
    through ``rint``.

    ``plan`` is the backward's scatter plan
    (``kernels.rgcn_message.SegmentPlan``) when the caller has it: of the
    flat rows and ownership into the ``S·rows`` stacked rows (the fused
    exchange and int8; the masked-sum chain plans shard by shard
    itself)."""
    from repro_torch.kernels.ops import (
        fused_sharded_gather, gather_rows, masked_take,
        quantized_sharded_gather,
    )

    if table_dtype not in TABLE_DTYPES:
        raise ValueError(
            f"unknown table_dtype {table_dtype!r}: one of {TABLE_DTYPES}")
    exchange = exchange or "fused"
    if exchange not in SIM_EXCHANGES:
        raise ValueError(
            f"unknown sim exchange {exchange!r}: one of {SIM_EXCHANGES}")
    # a plan is resolved where it lies (the host, for numpy plans)
    local_ids, owned = torch.as_tensor(local_ids), torch.as_tensor(owned)
    if table_dtype == "int8":
        out = quantized_sharded_gather(table, local_ids, owned, check=check,
                                       plan=plan)
    elif exchange == "fused":
        out = fused_sharded_gather(table, local_ids, owned, check=check,
                                   plan=plan)
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
