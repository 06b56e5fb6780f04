"""The RGCN edge kernels (port of ``repro/kernels/rgcn_message.py``).

* :func:`basis_message` — per-edge basis projection and coefficient mix,
  ``out[e] = mask[e] · Σ_b coef[e, b] · (h_t[e] @ bases[b])``, never
  materialising the ``(E, B, d_out)`` projections.
* :func:`segment_sum` — the masked segment sum with degree counts,
  ``agg[v] = Σ_{e: seg[e] = v, mask[e]} msg[e]``, ``deg[v]`` = their count.

Each launches its CUDA kernel from ``csrc/rgcn_message.cu`` for CUDA tensors
and runs its plain PyTorch version for CPU tensors. The TPU kernels needed
E and V padded to 128; these take any E and V.

``segment_sum`` sums without float atomics, so two runs give the same
bits: :func:`segment_plan` sorts the edges stably by segment (masked edges
last) and cuts each segment into chunks of ``CHUNK`` edges; the kernel adds
each chunk's rows in ascending edge order, then each segment's chunk sums
in chunk order. The plan is index bookkeeping done with PyTorch calls (the
TPU kernel has no counterpart of it).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

CHUNK = 32          # sorted edges per chunk (one warp); csrc's CHUNK

_SIGNATURES = {
    "basis_message_plan": [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.POINTER(ctypes.c_int)],
    "basis_message_f32": [ctypes.c_void_p] * 5 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p],
    "segment_sum_f32": [ctypes.c_void_p] * 7 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p],
}


def _library():
    return _build.load("rgcn_message", _SIGNATURES)


# ---------------------------------------------------------------------- #
# basis_message
# ---------------------------------------------------------------------- #
def basis_message_plain(h_t: torch.Tensor, coef: torch.Tensor,
                        bases: torch.Tensor,
                        edge_mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``(E, d_in)`` gathered tail states, ``(E, B)``
    coefficients, ``(B, d_in, d_out)`` bases, ``(E,)`` bool mask →
    ``(E, d_out)``; masked edges are exactly 0."""
    if h_t.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    proj = torch.einsum("ed,bdo->ebo", h_t, bases)
    msg = torch.einsum("ebo,eb->eo", proj, coef)
    return torch.where(edge_mask[:, None], msg, torch.zeros_like(msg))


def basis_message_config(d_in: int, d_out: int,
                         num_bases: int) -> Tuple[int, bool]:
    """``(edges per block, bases in shared memory)`` the kernel takes for
    these widths on the current card (the tile is 0 when nothing fits)."""
    flag = ctypes.c_int(0)
    tile = _library().basis_message_plan(d_in, d_out, num_bases,
                                         ctypes.byref(flag))
    return int(tile), bool(flag.value)


def basis_message(h_t: torch.Tensor, coef: torch.Tensor, bases: torch.Tensor,
                  edge_mask: torch.Tensor) -> torch.Tensor:
    """``mask[e] · Σ_b coef[e, b] · (h_t[e] @ bases[b])`` — the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors. Forward only: the
    RGCN layer differentiates the plain formula (``ops.rgcn_message_basis``)."""
    if _build.on_cpu("basis_message", h_t, coef, bases, edge_mask):
        return basis_message_plain(h_t, coef, bases, edge_mask)
    if h_t.dim() != 2 or bases.dim() != 3:
        raise ValueError("basis_message: h_t must be (E, d_in) and bases "
                         "(B, d_in, d_out)")
    e, d_in = h_t.shape
    nb, _, d_out = bases.shape
    f32 = torch.float32
    _build.require("basis_message", "h_t", h_t, f32, (e, d_in))
    _build.require("basis_message", "coef", coef, f32, (e, nb))
    _build.require("basis_message", "bases", bases, f32, (nb, d_in, d_out))
    _build.require("basis_message", "edge_mask", edge_mask, torch.bool, (e,))
    if min(d_in, d_out, nb) < 1:
        raise ValueError(f"basis_message: d_in={d_in}, d_out={d_out} and "
                         f"B={nb} must be positive")
    out = torch.empty((e, d_out), dtype=f32, device=h_t.device)
    if e == 0:
        return out
    lib = _library()
    with torch.cuda.device(h_t.device):
        code = lib.basis_message_f32(
            h_t.data_ptr(), coef.data_ptr(), bases.data_ptr(),
            edge_mask.data_ptr(), out.data_ptr(), e, d_in, d_out, nb,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch("basis_message", code)
    basis_message.launches += 1
    return out


basis_message.launches = 0


# ---------------------------------------------------------------------- #
# segment_sum
# ---------------------------------------------------------------------- #
def segment_key(seg: torch.Tensor, edge_mask: Optional[torch.Tensor],
                num_segments: int) -> torch.Tensor:
    """Each edge's segment as int64, masked edges keyed to the sentinel
    segment ``num_segments`` (no mask: every edge counts)."""
    if edge_mask is None:
        return seg.long()
    return torch.where(edge_mask, seg.long(),
                       torch.full_like(seg, num_segments, dtype=torch.long))


def segment_counts(key: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``(V,)`` int64 count of each segment's edges. ``index_add_`` rather
    than ``torch.bincount``, which reads the largest key back to the host
    on CUDA: a synchronisation in every call."""
    ones = torch.ones_like(key)
    return torch.zeros(num_segments + 1, dtype=torch.long,
                       device=key.device).index_add_(0, key, ones)[
                           :num_segments]


def segment_sum_plain(msg: torch.Tensor, seg: torch.Tensor,
                      edge_mask: torch.Tensor, num_segments: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``(E, d)`` messages, ``(E,)`` segment ids in
    ``[0, V)``, ``(E,)`` bool mask → ``(agg (V, d), deg (V,))``. Masked
    messages go to a sentinel row that is dropped."""
    key = segment_key(seg, edge_mask, num_segments)
    agg = torch.zeros((num_segments + 1, msg.shape[1]), dtype=msg.dtype,
                      device=msg.device).index_add_(0, key, msg)
    deg = segment_counts(key, num_segments).to(msg.dtype)
    return agg[:num_segments], deg


def segment_plan(seg: torch.Tensor, edge_mask: Optional[torch.Tensor],
                 num_segments: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(perm, offsets, chunk_ptr)``: the stable sort of the edges by
    segment (masked edges last), each segment's span ``offsets[v] ..
    offsets[v+1]`` of ``perm``, and its chunks ``chunk_ptr[v] ..
    chunk_ptr[v+1]`` of ``CHUNK`` sorted edges. All int64, on ``seg``'s
    device, with no host synchronisation."""
    key = segment_key(seg, edge_mask, num_segments)
    perm = torch.argsort(key, stable=True)
    counts = segment_counts(key, num_segments)
    zero = torch.zeros(1, dtype=torch.long, device=seg.device)
    offsets = torch.cat([zero, torch.cumsum(counts, 0)])
    chunk_ptr = torch.cat([zero, torch.cumsum((counts + CHUNK - 1) // CHUNK,
                                              0)])
    return perm, offsets, chunk_ptr


def segment_sum_planned(msg: torch.Tensor, perm: torch.Tensor,
                        offsets: torch.Tensor, chunk_ptr: torch.Tensor,
                        num_segments: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel alone on CUDA tensors, given :func:`segment_plan`'s
    output."""
    e, d = msg.shape
    v = int(num_segments)
    f32, i64 = torch.float32, torch.long
    _build.require("segment_sum", "msg", msg, f32, (e, d))
    _build.require("segment_sum", "perm", perm, i64, (e,))
    _build.require("segment_sum", "offsets", offsets, i64, (v + 1,))
    _build.require("segment_sum", "chunk_ptr", chunk_ptr, i64, (v + 1,))
    if d < 1 or v >= 2 ** 31:
        raise ValueError(f"segment_sum: d={d} must be positive and "
                         f"V={v} below 2**31")
    agg = torch.empty((v, d), dtype=f32, device=msg.device)
    deg = torch.empty((v,), dtype=f32, device=msg.device)
    if v == 0:
        return agg, deg
    # chunks: sum over segments of ceil(len / CHUNK) <= E / CHUNK + V
    max_chunks = e // CHUNK + v
    partial = torch.empty((max_chunks, d), dtype=f32, device=msg.device)
    lib = _library()
    with torch.cuda.device(msg.device):
        code = lib.segment_sum_f32(
            msg.data_ptr(), perm.data_ptr(), offsets.data_ptr(),
            chunk_ptr.data_ptr(), agg.data_ptr(), deg.data_ptr(),
            partial.data_ptr(), v, d, max_chunks,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch("segment_sum", code)
    segment_sum.launches += 1
    return agg, deg


def segment_sum(msg: torch.Tensor, seg: torch.Tensor,
                edge_mask: torch.Tensor, num_segments: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(agg (V, d), deg (V,))`` of the masked segment sum — the plan and
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    ``seg`` must lie in ``[0, V)`` on unmasked edges."""
    if _build.on_cpu("segment_sum", msg, seg, edge_mask):
        return segment_sum_plain(msg, seg, edge_mask, num_segments)
    if msg.dim() != 2 or seg.shape != (msg.shape[0],) or \
            edge_mask.shape != seg.shape or edge_mask.dtype != torch.bool:
        raise ValueError("segment_sum: msg must be (E, d), seg (E,) and "
                         "edge_mask (E,) bool")
    perm, offsets, chunk_ptr = segment_plan(seg, edge_mask, num_segments)
    return segment_sum_planned(msg, perm, offsets, chunk_ptr, num_segments)


segment_sum.launches = 0
