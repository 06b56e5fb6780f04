"""The RGCN edge kernels (port of ``repro/kernels/rgcn_message.py``).

* :func:`basis_message` — per-edge basis projection and coefficient mix,
  ``out[e] = mask[e] · Σ_b coef[e, b] · (h_t[e] @ bases[b])``, never
  materialising the ``(E, B, d_out)`` projections.
* :func:`segment_sum` — the masked segment sum with degree counts,
  ``agg[v] = Σ_{e: seg[e] = v, mask[e]} msg[e]``, ``deg[v]`` = their count.

Each launches its CUDA kernel from ``csrc/rgcn_message.cu`` for CUDA tensors
and runs its plain PyTorch version for CPU tensors. The TPU kernels needed
E and V padded to 128; these take any E and V.

``basis_message`` launches the register-tiled kernel; every output is one
fixed chain of ``fmaf`` operations, the same in :func:`basis_message_v1`,
the first kernel, so the two give the same bits.

``segment_sum`` sums without float atomics, so two runs give the same
bits: :func:`segment_plan` sorts the edges stably by segment (masked edges
last) and cuts each segment into chunks of ``CHUNK`` edges; the kernel adds
each chunk's rows in ascending edge order, then each segment's chunk sums
in chunk order. It runs the passes of ``scatter_add_onehot``, which also
write the degree; :func:`segment_sum_v1` runs the first kernel's passes,
the same order and so the same bits. The plan is index bookkeeping (the TPU kernel has no
counterpart of it) and a value of its own, :class:`SegmentPlan`: it
depends on the ids alone, so one plan serves every segment sum and
``scatter_add_onehot`` over the same ids in a step: a mini-batch step
builds each on the card at first use, sorting the keys in the narrowest
integer type that holds them, and the resident full-graph batch carries
its plans, built once on the host (:func:`segment_plan_host`, the same
arrays).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build

CHUNK = 32          # sorted edges per chunk (one warp); csrc's CHUNK

_BASIS_ARGTYPES = [ctypes.c_void_p] * 5 + [
    ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_SIGNATURES = {
    "basis_message_plan": [ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p],
    "basis_message_f32": _BASIS_ARGTYPES,
    "basis_message_f32_v1": _BASIS_ARGTYPES,
    "segment_sum_f32": [ctypes.c_void_p] * 8 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p],
    "segment_sum_f32_v1": [ctypes.c_void_p] * 7 + [
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


_PLAN_FIELDS = ("edges_per_tile", "threads", "column_slices",
                "column_groups_per_slice", "blocks_per_slice",
                "blocks_per_sm", "smem_bytes")


def basis_message_config(d_in: int, d_out: int, num_bases: int,
                         num_edges: int) -> dict:
    """The plan :func:`basis_message` launches for these widths and
    ``num_edges`` edges on the current card: its edge tile, threads per
    block, how the output columns split over blocks (each block holds its
    slice of the bases in shared memory), the persistent grid and the
    shared memory per block."""
    plan = (ctypes.c_int64 * len(_PLAN_FIELDS))()
    code = _library().basis_message_plan(num_edges, d_in, d_out, num_bases,
                                         plan)
    _build.check_launch("basis_message_plan", code)
    return dict(zip(_PLAN_FIELDS, (int(x) for x in plan)))


def _launch_basis(entry: str, h_t, coef, bases, edge_mask):
    """Check the operands and launch the C entry point ``entry``; returns
    ``(out, launched)``."""
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
        return out, False
    lib = _library()
    with torch.cuda.device(h_t.device):
        code = getattr(lib, entry)(
            h_t.data_ptr(), coef.data_ptr(), bases.data_ptr(),
            edge_mask.data_ptr(), out.data_ptr(), e, d_in, d_out, nb,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch("basis_message", code)
    return out, True


def basis_message_ops(e: int, nb: int, d_in: int, d_out: int,
                      n_on: Optional[int] = None) -> int:
    """Operations of the basis message: a ``d_in -> d_out`` product and
    its coefficient for each of ``B`` bases, on the ``n_on`` edges that
    are on (every edge when not given)."""
    return 2 * (e if n_on is None else n_on) * nb * d_out * (d_in + 1)


def basis_message_bytes(e: int, nb: int, d_in: int, d_out: int) -> int:
    """Bytes the basis message must move, fp32: the edges' inputs and
    coefficients, the bases and the mask read, the messages written."""
    return 4 * (e * d_in + e * nb + nb * d_in * d_out + e * d_out) + e


def basis_message(h_t: torch.Tensor, coef: torch.Tensor, bases: torch.Tensor,
                  edge_mask: torch.Tensor) -> torch.Tensor:
    """``mask[e] · Σ_b coef[e, b] · (h_t[e] @ bases[b])`` — the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors. Forward only: the
    RGCN layer's backward is written out in ``ops.rgcn_message_basis``.
    Fake tensors take the abstract branch (the dry run), every edge on."""
    if _build.is_abstract(h_t, coef, bases, edge_mask):
        from repro_torch.sharding.step_analysis import local_kernel_call
        (e, d_in), (nb, _, d_out) = h_t.shape, bases.shape
        return local_kernel_call(
            "basis_message", lambda h, *_: torch.empty(
                (e, d_out), dtype=torch.float32, device=h.device),
            (h_t, coef, bases, edge_mask),
            lambda *_: basis_message_ops(e, nb, d_in, d_out),
            lambda *_: basis_message_bytes(e, nb, d_in, d_out))
    if _build.on_cpu("basis_message", h_t, coef, bases, edge_mask):
        return basis_message_plain(h_t, coef, bases, edge_mask)
    out, launched = _launch_basis("basis_message_f32", h_t, coef, bases,
                                  edge_mask)
    if launched:
        basis_message.launches += 1
    return out


basis_message.launches = 0


def basis_message_v1(h_t: torch.Tensor, coef: torch.Tensor,
                     bases: torch.Tensor,
                     edge_mask: torch.Tensor) -> torch.Tensor:
    """The first port's kernel (a thread per output column and 4 edges of a
    128-edge tile) on CUDA tensors, kept as the bitwise yardstick of
    :func:`basis_message`: both compute every output by the same ``fmaf``
    chain. Not on any path of the port; it counts no launches."""
    if _build.on_cpu("basis_message", h_t, coef, bases, edge_mask):
        raise ValueError("basis_message_v1: CUDA tensors only (the plain "
                         "version is basis_message_plain)")
    return _launch_basis("basis_message_f32_v1", h_t, coef, bases,
                         edge_mask)[0]


# ---------------------------------------------------------------------- #
# segment_sum and its plan
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


class SegmentPlan(NamedTuple):
    """The sort plan of one id array: ``perm`` (E,) the stable sort of the
    slots by id (masked slots last, under the sentinel), ``offsets`` (V+1,)
    each id's span ``offsets[v] .. offsets[v+1]`` of ``perm`` and
    ``chunk_ptr`` (V+1,) its chunks of ``CHUNK`` sorted slots; all int64.

    A plan depends only on the ids, the mask and V, so one plan serves
    every segment sum and scatter-add over the same ids in a step (both
    RGCN layers, forward and backward). A stable sort of the same keys is
    unique, so a plan built on the host (:func:`segment_plan_host`) is the
    card's (:func:`segment_plan`) array for array."""

    perm: torch.Tensor
    offsets: torch.Tensor
    chunk_ptr: torch.Tensor

    @property
    def num_segments(self) -> int:
        return self.offsets.shape[0] - 1

    def pack(self) -> torch.Tensor:
        """One int64 array ``offsets ‖ chunk_ptr ‖ perm``: a plan travels in
        a batch dict as one tensor."""
        return torch.cat([self.offsets, self.chunk_ptr, self.perm])

    @classmethod
    def unpack(cls, packed: torch.Tensor, num_segments: int
               ) -> "SegmentPlan":
        """Views into a :meth:`pack`-ed plan of ``num_segments`` ids."""
        n = num_segments + 1
        return cls(packed[2 * n:], packed[:n], packed[n:2 * n])


def _narrow_key(key: torch.Tensor, num_segments: int) -> torch.Tensor:
    """The keys in the narrowest signed type that holds the sentinel: a
    radix sort of 16 or 32 bits takes 2 or 4 passes where int64 takes 8,
    and gives the same stable permutation."""
    if num_segments < 2 ** 15:
        return key.to(torch.int16)
    if num_segments < 2 ** 31:
        return key.to(torch.int32)
    return key


def segment_plan(seg: torch.Tensor, edge_mask: Optional[torch.Tensor],
                 num_segments: int) -> SegmentPlan:
    """The :class:`SegmentPlan` of ``seg`` (masked edges last), on
    ``seg``'s device, with no host synchronisation."""
    key = segment_key(seg, edge_mask, num_segments)
    perm = torch.argsort(_narrow_key(key, num_segments), stable=True)
    counts = segment_counts(key, num_segments)
    zero = torch.zeros(1, dtype=torch.long, device=seg.device)
    offsets = torch.cat([zero, torch.cumsum(counts, 0)])
    chunk_ptr = torch.cat([zero, torch.cumsum((counts + CHUNK - 1) // CHUNK,
                                              0)])
    return SegmentPlan(perm, offsets, chunk_ptr)


def segment_plan_host(seg: np.ndarray, edge_mask: Optional[np.ndarray],
                      num_segments: int) -> np.ndarray:
    """:func:`segment_plan` in numpy, packed (:meth:`SegmentPlan.pack`):
    the plans the resident full-graph batch carries, built once on the
    host. Keys below 2**16 sort as ``uint16`` (numpy's stable sort is a
    radix sort there), the same permutation as any stable sort."""
    n = num_segments + 1
    key = np.asarray(seg)
    if edge_mask is not None:
        key = np.where(edge_mask, key, num_segments)
    key = key.astype(np.uint16 if num_segments < 2 ** 16 else np.int64,
                     copy=False)
    out = np.empty(2 * n + key.shape[0], np.int64)
    counts = np.bincount(key, minlength=n)[:num_segments]
    out[0] = out[n] = 0
    np.cumsum(counts, out=out[1:n])
    np.cumsum((counts + CHUNK - 1) // CHUNK, out=out[n + 1:2 * n])
    out[2 * n:] = np.argsort(key, kind="stable")
    return out


def check_plan(kernel: str, plan: SegmentPlan, seg: torch.Tensor,
               edge_mask: Optional[torch.Tensor], num_segments: int) -> None:
    """Raise unless ``plan`` is the plan of these ids: on the CUDA path the
    shapes (the plan is trusted), on the CPU path the arrays themselves
    (the plain version takes no plan, so the CPU tests prove that each
    caller hands every call the plan of its own ids)."""
    e = seg.shape[0]
    n = num_segments + 1
    if (tuple(plan.perm.shape) != (e,) or tuple(plan.offsets.shape) != (n,)
            or tuple(plan.chunk_ptr.shape) != (n,)):
        raise ValueError(f"{kernel}: a plan of {plan.perm.shape[0]} slots "
                         f"and {plan.num_segments} segments for {e} slots "
                         f"and {num_segments} segments")
    if seg.device.type != "cpu":
        return
    want = segment_plan(seg, edge_mask, num_segments)
    if not all(torch.equal(a.cpu(), b) for a, b in zip(plan, want)):
        raise ValueError(f"{kernel}: the plan is not the plan of these ids")


def segment_sum_planned(msg: torch.Tensor, perm: torch.Tensor,
                        offsets: torch.Tensor, chunk_ptr: torch.Tensor,
                        num_segments: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel alone on CUDA tensors, given :func:`segment_plan`'s
    output."""
    long_rows = torch.empty_like(offsets)   # the kernel's long segments
    return _segment_launch("segment_sum_f32", segment_sum, msg, perm,
                           offsets, chunk_ptr, num_segments, (long_rows,))


def _segment_launch(entry: str, counter, msg: torch.Tensor,
                    perm: torch.Tensor, offsets: torch.Tensor,
                    chunk_ptr: torch.Tensor, num_segments: int,
                    scratch: Tuple[torch.Tensor, ...] = ()
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the C entry point ``entry`` over a plan, with the pointers of
    ``scratch`` after its own, adding one to ``counter.launches`` when
    given."""
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
        ptrs = [msg.data_ptr(), perm.data_ptr(), offsets.data_ptr(),
                chunk_ptr.data_ptr(), agg.data_ptr(), deg.data_ptr(),
                partial.data_ptr()] + [t.data_ptr() for t in scratch]
        code = getattr(lib, entry)(
            *ptrs, v, d, max_chunks, torch.cuda.current_stream().cuda_stream)
    _build.check_launch("segment_sum", code)
    if counter is not None:
        counter.launches += 1
    return agg, deg


def _segment_operands(msg: torch.Tensor, seg: torch.Tensor,
                      edge_mask: torch.Tensor) -> None:
    if msg.dim() != 2 or seg.shape != (msg.shape[0],) or \
            edge_mask.shape != seg.shape or edge_mask.dtype != torch.bool:
        raise ValueError("segment_sum: msg must be (E, d), seg (E,) and "
                         "edge_mask (E,) bool")


def segment_sum_ops(e: int, d: int, n_on: Optional[int] = None) -> int:
    """Operations of the segment sum: one add an element of the ``n_on``
    edges that are on (every edge when not given)."""
    return (e if n_on is None else n_on) * d


def segment_sum_bytes(e: int, v: int, d: int,
                      n_on: Optional[int] = None) -> int:
    """Bytes the segment sum must move, fp32: the ``n_on`` edges'
    messages read (every edge when not given), 5 bytes an edge of its
    segment and mask, the ``(V, d)`` sums and ``(V,)`` degrees written."""
    n_on = e if n_on is None else n_on
    return 4 * n_on * d + 5 * e + 4 * v * d + 4 * v


def segment_sum(msg: torch.Tensor, seg: torch.Tensor,
                edge_mask: torch.Tensor, num_segments: int,
                plan: Optional[SegmentPlan] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(agg (V, d), deg (V,))`` of the masked segment sum — the CUDA
    kernel for CUDA tensors (over ``plan``, the :func:`segment_plan` of
    ``seg`` and ``edge_mask``, built here when not given), the plain
    version for CPU tensors. ``seg`` must lie in ``[0, V)`` on unmasked
    edges. Fake tensors take the abstract branch (the dry run), every edge
    on."""
    if _build.is_abstract(msg, seg, edge_mask):
        from repro_torch.sharding.step_analysis import local_kernel_call
        e, d = msg.shape
        return local_kernel_call(
            "segment_sum", lambda m, *_: (
                torch.empty((num_segments, d), dtype=torch.float32,
                            device=m.device),
                torch.empty((num_segments,), dtype=torch.float32,
                            device=m.device)),
            (msg, seg, edge_mask), lambda *_: segment_sum_ops(e, d),
            lambda *_: segment_sum_bytes(e, num_segments, d))
    if plan is not None:
        check_plan("segment_sum", plan, seg, edge_mask, num_segments)
    if _build.on_cpu("segment_sum", msg, seg, edge_mask):
        return segment_sum_plain(msg, seg, edge_mask, num_segments)
    _segment_operands(msg, seg, edge_mask)
    if plan is None:
        plan = segment_plan(seg, edge_mask, num_segments)
    return segment_sum_planned(msg, *plan, num_segments)


def segment_sum_v1(msg: torch.Tensor, seg: torch.Tensor,
                   edge_mask: torch.Tensor, num_segments: int,
                   plan: Optional[SegmentPlan] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first port's passes (a warp per chunk found by a binary search,
    a block per segment to combine) on CUDA tensors, kept as the bitwise
    yardstick of :func:`segment_sum`: both add in the same order and count
    the same degree. Not on any path of the port; it counts no
    launches."""
    if _build.on_cpu("segment_sum", msg, seg, edge_mask):
        raise ValueError("segment_sum_v1: CUDA tensors only (the plain "
                         "version is segment_sum_plain)")
    if plan is not None:
        check_plan("segment_sum_v1", plan, seg, edge_mask, num_segments)
    _segment_operands(msg, seg, edge_mask)
    if plan is None:
        plan = segment_plan(seg, edge_mask, num_segments)
    return _segment_launch("segment_sum_f32_v1", None, msg, *plan,
                           num_segments)


segment_sum.launches = 0
