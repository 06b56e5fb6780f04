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

:func:`topk_scores` launches the CUDA kernel ``csrc/topk.cu`` for CUDA
tensors and runs :func:`topk_plain` — the literal iterative selection, not
``torch.topk``, whose tie order is not documented — for CPU tensors. Values
are fp32, indices int64.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

TOPK_SEG = 2048          # positions per segment of one kernel pass
_MAX_ROWS = 65535        # the kernel's grid has one y-index per row

_SIGNATURES = {"topk_select_f32": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p]}


def topk_plain(scores: torch.Tensor, k: int,
               ids: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``k`` rounds of max over the active columns,
    the lowest active column among the maxima wins and is deactivated.
    Returns ``(values (B, k) f32, indices (B, k) int64)``; with ``ids``
    (``(B, C)`` int64) the indices are ``ids`` at the winning columns."""
    scores = scores.float()
    b, c = scores.shape
    col = torch.arange(c, device=scores.device).expand(b, c)
    active = torch.ones((b, c), dtype=torch.bool, device=scores.device)
    neg_inf = torch.tensor(float("-inf"), device=scores.device)
    vals, idx = [], []
    for _ in range(k):
        cur = torch.where(active, scores, neg_inf)
        m = cur.amax(dim=1)
        hit = active & (cur == m[:, None])
        pick = torch.where(hit, col, c).amin(dim=1)
        active &= col != pick[:, None]
        vals.append(m)
        idx.append(pick)
    v = torch.stack(vals, dim=1) if vals else scores[:, :0]
    i = (torch.stack(idx, dim=1) if idx
         else torch.zeros((b, 0), dtype=torch.int64, device=scores.device))
    return v, (i if ids is None else ids.gather(1, i))


def _launch(lib, vals, ids, n, seg, k_out):
    rows = vals.shape[0]
    nseg = -(-n // seg)
    out_v = torch.empty((rows, nseg * k_out), dtype=torch.float32,
                        device=vals.device)
    out_i = torch.empty((rows, nseg * k_out), dtype=torch.int64,
                        device=vals.device)
    code = lib.topk_select_f32(
        vals.data_ptr(), None if ids is None else ids.data_ptr(), rows, n,
        seg, k_out, out_v.data_ptr(), out_i.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    _build.check_launch("topk", code)
    topk_scores.launches += 1
    return out_v, out_i, nseg


def topk_scores(scores: torch.Tensor, k: int,
                ids: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k per row of a ``(B, C)`` fp32 block under the selection
    contract: ``(values (B, k) f32, indices (B, k) int64)``; with ``ids``
    the indices are ``ids`` at the winning columns (the shard merge).
    ``1 <= k <= C`` is the caller's clamp (``ops.topk_padded``).

    On the card a long row is reduced in passes: the top ``k`` of each
    ``TOPK_SEG``-column segment, then the top ``k`` of the concatenated
    segment winners, until one segment is left. Exact by the shard-merge
    argument: among equal values a lower concatenated position is a lower
    original column."""
    if _build.on_cpu("topk", scores, *(() if ids is None else (ids,))):
        return topk_plain(scores, k, ids)
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
    if b == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=scores.device),
                torch.empty((0, k), dtype=torch.int64, device=scores.device))
    lib = _build.load("topk", _SIGNATURES)
    vals, n = scores, c
    with torch.cuda.device(scores.device):
        while True:
            # one segment when the row fits, or when k is too large for a
            # pass to shrink the row (then the kernel scans device memory)
            seg = n if (n <= TOPK_SEG or 4 * k > TOPK_SEG) else TOPK_SEG
            k_out = min(k, seg)
            vals, ids, nseg = _launch(lib, vals, ids, n, seg, k_out)
            if nseg == 1:
                return vals, ids
            n = nseg * k_out


topk_scores.launches = 0
