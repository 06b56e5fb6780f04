"""Per-row top-k selection (port of ``repro/kernels/topk.py``).

Selection contract (the serving ``==``-vs-dense gate depends on it)::

    k rounds of  (max over still-active columns,
                  LOWEST column index among the maxima wins,
                  winner deactivated)

Values come out descending with ties broken toward the lowest index, and
repeated ``-inf`` entries (filtered or layout-padded candidates) drain in
ascending index order — a winner is deactivated, no value is ever rewritten
to ``-inf``. Per-shard top-k plus a merge therefore reproduces the dense
top-k exactly (``repro_torch.serving.kge``).

A round's value is the reference's max over the active columns, in which
+0.0 wins over -0.0: a zero-valued output is +0.0 iff the row holds a +0.0
at or after its winner's position (in the merge form, the position in the
concatenated row), else -0.0. ``jax.lax.top_k``, which orders +0.0 above
-0.0, picks other indices at such ties; the reference's Pallas kernel and
``topk_ref`` do not, and the port follows them.

:func:`topk_scores` launches a CUDA kernel of ``csrc/topk.cu`` for CUDA
tensors and runs :func:`topk_plain` — the literal iterative selection, not
``torch.topk``, whose tie order is not documented — for CPU tensors. For
``k <= STREAM_MAX_K`` it launches ``topk_stream_f32``, one pass over each
row; for larger ``k`` the first kernel ``topk_select_f32_v1`` in passes (a
dispatch by shape between two kernels, not a fallback).
:func:`topk_scores_v1` runs the first kernel at every ``k``, the bitwise
yardstick of the new one. Values are fp32, indices int64.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

TOPK_SEG = 2048          # positions per segment of one first-kernel pass
STREAM_MAX_K = 32        # the streaming kernel's largest register list
STREAM_SPAN = 4096       # positions a streaming block takes at least
STREAM_BLOCKS_PER_SM = 4  # blocks an SM the streaming grid aims at: one
                          # wave (4 fit an SM, by registers)
_MAX_ROWS = 65535        # the kernels' grids have one y-index per row

_SIGNATURES = {
    "topk_select_f32_v1": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p],
    "topk_stream_f32": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
}

# per (CUDA device, stream): the streaming kernel's int32 row tickets, zero
# between launches (the last block of each row resets its own)
_TICKETS = {}
_SMS = {}   # per CUDA device: its SM count


def topk_plain(scores: torch.Tensor, k: int,
               ids: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``k`` rounds of max over the active columns
    (+0.0 above -0.0, as the reference's max), the lowest active column
    among the maxima wins and is deactivated. Returns ``(values (B, k) f32,
    indices (B, k) int64)``; with ``ids`` (``(B, C)`` int64) the indices
    are ``ids`` at the winning columns."""
    scores = scores.float()
    b, c = scores.shape
    col = torch.arange(c, device=scores.device).expand(b, c)
    active = torch.ones((b, c), dtype=torch.bool, device=scores.device)
    neg_inf = torch.tensor(float("-inf"), device=scores.device)
    plus_zero = torch.zeros((), device=scores.device)
    minus_zero = -plus_zero
    is_plus_zero = (scores == 0) & ~torch.signbit(scores)
    vals, idx = [], []
    for _ in range(k):
        cur = torch.where(active, scores, neg_inf)
        m = cur.amax(dim=1)
        m = torch.where(m == 0, torch.where(
            (active & is_plus_zero).any(dim=1), plus_zero, minus_zero), m)
        hit = active & (cur == m[:, None])
        pick = torch.where(hit, col, c).amin(dim=1)
        active &= col != pick[:, None]
        vals.append(m)
        idx.append(pick)
    v = torch.stack(vals, dim=1) if vals else scores[:, :0]
    i = (torch.stack(idx, dim=1) if idx
         else torch.zeros((b, 0), dtype=torch.int64, device=scores.device))
    return v, (i if ids is None else ids.gather(1, i))


def stream_splits(b: int, c: int, sms: int) -> int:
    """Blocks a row for the streaming kernel on a card of ``sms`` SMs: at
    least ``STREAM_SPAN`` positions a block, and no more blocks in all than
    ``STREAM_BLOCKS_PER_SM`` an SM. FB15k-237 S1 (B 8, C 14,541): 4; a
    4-shard block (C 3,636) and the merge: 1; ogbl-citation2 (C 2,927,963)
    on 132 SMs: 66."""
    by_span = -(-c // STREAM_SPAN)
    by_card = -(-(STREAM_BLOCKS_PER_SM * sms) // max(b, 1))
    return max(1, min(by_span, by_card, c))


def _operands(scores: torch.Tensor, k: int,
              ids: Optional[torch.Tensor]) -> Tuple[int, int]:
    """Check a CUDA call's operands; returns ``(B, C)``."""
    if scores.dim() != 2:
        raise ValueError("topk: scores must be 2-D")
    b, c = scores.shape
    _build.require("topk", "scores", scores, torch.float32, (b, c))
    if ids is not None:
        _build.require("topk", "ids", ids, torch.int64, (b, c))
    if not 1 <= k <= c:
        raise ValueError(f"topk: k={k} outside [1, C={c}]")
    if b > _MAX_ROWS or c >= 2 ** 30:
        raise ValueError(f"topk: B={b} must be at most {_MAX_ROWS} and "
                         f"C={c} below 2**30")
    return b, c


def _empty(scores: torch.Tensor, k: int):
    return (torch.empty((0, k), dtype=torch.float32, device=scores.device),
            torch.empty((0, k), dtype=torch.int64, device=scores.device))


def _select_v1(scores: torch.Tensor, k: int, ids: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The first kernel's passes: the top ``k`` of each ``TOPK_SEG``-column
    segment, then the top ``k`` of the concatenated segment winners, until
    one segment is left. Exact by the shard-merge argument: among equal
    values a lower concatenated position is a lower original column.
    Returns ``(values, indices, launches)``."""
    lib = _build.load("topk", _SIGNATURES)
    rows = scores.shape[0]
    vals, n, launches = scores, scores.shape[1], 0
    with torch.cuda.device(scores.device):
        while True:
            # one segment when the row fits, or when k is too large for a
            # pass to shrink the row (then the kernel scans device memory)
            seg = n if (n <= TOPK_SEG or 4 * k > TOPK_SEG) else TOPK_SEG
            k_out = min(k, seg)
            nseg = -(-n // seg)
            out_v = torch.empty((rows, nseg * k_out), dtype=torch.float32,
                                device=scores.device)
            out_i = torch.empty((rows, nseg * k_out), dtype=torch.int64,
                                device=scores.device)
            code = lib.topk_select_f32_v1(
                vals.data_ptr(), None if ids is None else ids.data_ptr(),
                rows, n, seg, k_out, out_v.data_ptr(), out_i.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            _build.check_launch("topk", code)
            launches += 1
            vals, ids = out_v, out_i
            if nseg == 1:
                return vals, ids, launches
            n = nseg * k_out


def _tickets(device: torch.device, rows: int) -> torch.Tensor:
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (device.index, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < rows:
        t = _TICKETS[key] = torch.zeros(max(rows, 64), dtype=torch.int32,
                                        device=device)
    return t


def stream_select(scores: torch.Tensor, k: int,
                  ids: Optional[torch.Tensor], splits: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the streaming kernel on checked CUDA operands (``k
    <= STREAM_MAX_K``) at ``splits`` blocks a row, the spans merged by the
    last block of each row. Returns ``(values, indices)``."""
    b, c = scores.shape
    if not (1 <= k <= STREAM_MAX_K and 1 <= splits <= c):
        raise ValueError(f"topk: the streaming kernel takes 1 <= k <= "
                         f"{STREAM_MAX_K} and 1 <= splits <= C={c}, got "
                         f"k={k}, splits={splits}")
    dev = scores.device
    out_v = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int64, device=dev)
    part_v = torch.empty(b * splits * k if splits > 1 else 0,
                         dtype=torch.float32, device=dev)
    part_p = torch.empty(b * splits * (k + 1) if splits > 1 else 0,
                         dtype=torch.int32, device=dev)
    lib = _build.load("topk", _SIGNATURES)
    with torch.cuda.device(dev):
        tickets = _tickets(dev, b)
        code = lib.topk_stream_f32(
            scores.data_ptr(), None if ids is None else ids.data_ptr(), b, c,
            k, splits, out_v.data_ptr(), out_i.data_ptr(),
            part_v.data_ptr(), part_p.data_ptr(), tickets.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch("topk", code)
    return out_v, out_i


def topk_scores_ops(b: int, c: int) -> int:
    """Operations of a top-k over ``(B, C)`` scores: one comparison a
    score."""
    return b * c


def topk_scores_bytes(b: int, c: int, k: int, with_ids: bool = False) -> int:
    """Bytes a top-k must move: the fp32 scores read, k fp32 values and
    int64 indices a row written; with ``ids`` (the merge) the k winners'
    int64 ids a row read, no more."""
    return 4 * b * c + 12 * b * k + (8 * b * k if with_ids else 0)


def topk_scores(scores: torch.Tensor, k: int,
                ids: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k per row of a ``(B, C)`` fp32 block under the selection
    contract: ``(values (B, k) f32, indices (B, k) int64)``; with ``ids``
    the indices are ``ids`` at the winning columns (the shard merge).
    ``1 <= k <= C`` is the caller's clamp (``ops.topk_padded``).

    On the card, ``k <= STREAM_MAX_K`` takes the streaming kernel, one
    launch of :func:`stream_splits` blocks a row; a larger ``k`` the first
    kernel's passes, one launch each. Fake tensors take the abstract
    branch (the dry run)."""
    if _build.is_abstract(scores, ids):
        from repro_torch.sharding.step_analysis import local_kernel_call
        return local_kernel_call(
            "topk", lambda x, *_: (
                torch.empty((x.shape[0], k), dtype=torch.float32,
                            device=x.device),
                torch.empty((x.shape[0], k), dtype=torch.int64,
                            device=x.device)),
            (scores,) if ids is None else (scores, ids),
            lambda x, *_: topk_scores_ops(*x.shape),
            lambda x, *_: topk_scores_bytes(*x.shape, k, ids is not None))
    if _build.on_cpu("topk", scores, *(() if ids is None else (ids,))):
        return topk_plain(scores, k, ids)
    b, c = _operands(scores, k, ids)
    if b == 0:
        return _empty(scores, k)
    if k > STREAM_MAX_K:
        v, i, launches = _select_v1(scores, k, ids)
    else:
        sms = _SMS.get(scores.device.index)
        if sms is None:
            sms = _SMS[scores.device.index] = torch.cuda.get_device_properties(
                scores.device).multi_processor_count
        v, i = stream_select(scores, k, ids, stream_splits(b, c, sms))
        launches = 1
    topk_scores.launches += launches
    return v, i


topk_scores.launches = 0


def topk_scores_v1(scores: torch.Tensor, k: int,
                   ids: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first port's kernel (k rounds of block reductions over staged
    segments, a long row in passes) on CUDA tensors at every ``k``, kept as
    the bitwise yardstick of :func:`topk_scores`. Not on any path of the
    port; it counts no launches."""
    if _build.on_cpu("topk", scores, *(() if ids is None else (ids,))):
        raise ValueError("topk_scores_v1: CUDA tensors only (the plain "
                         "version is topk_plain)")
    b, _ = _operands(scores, k, ids)
    if b == 0:
        return _empty(scores, k)
    v, i, _ = _select_v1(scores, k, ids)
    return v, i
