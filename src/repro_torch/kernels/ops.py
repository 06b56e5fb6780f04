"""Public wrappers around the kernels (port of ``repro/kernels/ops.py``):
the fused RGCN message layer, the row gather with a deterministic
backward, the int8 table's gathers, optional arguments, k checks, the
shard merge, the flat-index gather plan and the chunked WKV.

The TPU wrappers padded E, V, B and C to the kernels' 128-row tiles, and
BH to 8 and S to the chunk for the WKV; the CUDA kernels take ragged
shapes, so nothing is padded here and the results are the TPU wrappers'
sliced results.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch.kernels.kge_score import kge_score
from repro_torch.kernels.rgcn_message import (
    SegmentPlan, basis_message, segment_plan, segment_sum,
)
from repro_torch.kernels.sharded_gather import (
    fused_dequant_gather, fused_gather, scatter_add_onehot,
)
from repro_torch.kernels.topk import topk_scores
from repro_torch.kernels.wkv_chunk import (
    BACKWARD_MAX_CHUNK, wkv_chunked, wkv_chunked_backward, wkv_chunked_states,
)
from repro_torch.sharding.embedding import quantize_rows


class _GatherRows(torch.autograd.Function):
    """``table[ids]`` over the leading axis, masked to zero rows where
    ``owned`` is false; its backward scatters the cotangents of the owned
    slots back with :func:`scatter_add_onehot` (over ``plan`` when one is
    given), whose sum order is fixed by the data (no float atomics), so
    gradients are the same bits on every run. Forward: ``index_select``
    without a mask, the ``fused_gather`` kernel (the plain version on the
    CPU) with one."""

    @staticmethod
    def forward(ctx, table, ids, owned, check, plan):
        ctx.table_shape = table.shape
        ctx.plan = plan
        ctx.save_for_backward(ids, owned)
        rows = table.reshape(table.shape[0], -1)
        if owned is None:
            out = torch.index_select(rows, 0, ids)
        else:
            out = fused_gather(rows.contiguous(), ids, owned, check=check)
        return out.reshape(ids.shape + table.shape[1:])

    @staticmethod
    def backward(ctx, g):
        ids, owned = ctx.saved_tensors
        shape = ctx.table_shape
        dt = scatter_add_onehot(g.reshape(ids.shape[0], -1).contiguous(),
                                ids, owned, shape[0], plan=ctx.plan)
        return dt.reshape(shape), None, None, None, None


class _QuantizedGatherRows(_GatherRows):
    """The int8 training gather over a flat ``(R, d)`` fp32 master:
    forward quantizes the master row-wise and runs ``fused_dequant_gather``;
    backward is :class:`_GatherRows`' scatter-add into the master rows
    (straight-through: not the zero-almost-everywhere derivative of
    ``rint``), the reference's ``_fsg_bwd``."""

    @staticmethod
    def forward(ctx, table, ids, owned, check, plan):
        ctx.table_shape = table.shape
        ctx.plan = plan
        ctx.save_for_backward(ids, owned)
        codes, scales = quantize_rows(table)
        return fused_dequant_gather(codes, scales, ids, owned, check=check)


def gather_rows(table: torch.Tensor, ids: torch.Tensor,
                plan: Optional[SegmentPlan] = None) -> torch.Tensor:
    """``table[ids]`` for ``(V,)`` ids over the leading axis of ``table``
    (any trailing shape), with the deterministic
    :func:`scatter_add_onehot` backward — the row gather of every training
    path (entity table, vertex states, relation tables). ``plan``: the
    ``segment_plan`` of ``ids`` (no mask) into ``table``'s rows, when the
    caller has it."""
    return _GatherRows.apply(table, ids.long(), None, True, plan)


def wants_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd will differentiate through an op on ``tensors``:
    a plan for its backward is then worth having."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class EdgePlans:
    """The segment plans of one graph's edge arrays, shared by every layer
    of an encode and by forward and backward: ``src`` (the heads, masked
    edges left out: the segment sum), ``dst`` and ``rel`` (every edge: the
    scatter-adds of the tail-state and relation-row cotangents). Each is
    taken from ``given`` (the resident full-graph batch's, built once on
    the host) or built on the card at first use and kept (a mini-batch
    step's). On the CPU, whose plain versions take no plan, a plan not
    given stays ``None``."""

    def __init__(self, src: torch.Tensor, rel: torch.Tensor,
                 dst: torch.Tensor, edge_mask: torch.Tensor,
                 num_vertices: int, num_relations: int,
                 given: Optional[Dict[str, SegmentPlan]] = None):
        self.ids = {"src": (src, edge_mask, num_vertices),
                    "dst": (dst, None, num_vertices),
                    "rel": (rel, None, num_relations)}
        self._plans = {k: v for k, v in (given or {}).items()
                       if v is not None}

    @classmethod
    def from_batch(cls, batch: Mapping[str, torch.Tensor],
                   src: torch.Tensor, rel: torch.Tensor, dst: torch.Tensor,
                   edge_mask: torch.Tensor, num_vertices: int,
                   num_relations: int) -> "EdgePlans":
        """Plans over these arrays, with the packed ``plan_src``,
        ``plan_dst`` and ``plan_rel`` entries of ``batch`` where it has
        them."""
        sizes = {"src": num_vertices, "dst": num_vertices,
                 "rel": num_relations}
        given = {k: SegmentPlan.unpack(batch[f"plan_{k}"], n)
                 for k, n in sizes.items() if f"plan_{k}" in batch}
        return cls(src, rel, dst, edge_mask, num_vertices, num_relations,
                   given)

    def __getitem__(self, name: str) -> Optional[SegmentPlan]:
        plan = self._plans.get(name)
        if plan is None:
            ids, mask, n = self.ids[name]
            if ids.device.type == "cpu":
                return None
            plan = self._plans[name] = segment_plan(ids, mask, n)
        return plan


class _SegmentSum(torch.autograd.Function):
    """The masked segment sum of the plain RGCN path: forward
    :func:`segment_sum` (the deterministic kernel on the card, the plain
    ``index_add_`` on the CPU); backward the transposed gather
    ``mask[e] · g[seg[e]]``, deterministic by construction. ``deg``
    carries no gradient."""

    @staticmethod
    def forward(ctx, msg, seg, edge_mask, num_segments, plan):
        agg, deg = segment_sum(msg, seg, edge_mask, num_segments, plan=plan)
        ctx.save_for_backward(seg, edge_mask)
        ctx.mark_non_differentiable(deg)
        return agg, deg

    @staticmethod
    def backward(ctx, g, _):
        seg, edge_mask = ctx.saved_tensors
        return _segment_gather(g, seg, edge_mask), None, None, None, None


def _segment_gather(g: torch.Tensor, seg: torch.Tensor,
                    edge_mask: torch.Tensor) -> torch.Tensor:
    """``mask[e] · g[seg[e]]``: the transpose of the masked segment sum
    (a masked edge's id is not read)."""
    idx = torch.where(edge_mask, seg.long(), 0)
    rows = torch.index_select(g, 0, idx)
    return torch.where(edge_mask[:, None], rows, torch.zeros_like(rows))


def segment_sum_op(msg: torch.Tensor, seg: torch.Tensor,
                   edge_mask: torch.Tensor, num_segments: int,
                   plan: Optional[SegmentPlan] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(agg (V, d), deg (V,))`` of the masked segment sum, differentiable
    in ``msg`` with a deterministic backward. ``plan``: the
    ``segment_plan`` of ``seg`` and ``edge_mask``, when the caller has
    it."""
    return _SegmentSum.apply(msg, seg, edge_mask, num_segments, plan)


class _RGCNMessageBasis(torch.autograd.Function):
    """Forward through the two kernels; backward written out by hand (the
    reference differentiates the plain formula, ``_rgcn_bwd``, and XLA
    drops the recomputed forward the gradient never reads; eager PyTorch
    would run it). With ``h_t = h[dst]``, ``c = coeffs[rel]`` and the
    forward's degrees::

        dmsg[e]    = mask[e] · g[src[e]] / max(deg[src[e]], 1)
        t[e, b]    = dmsg[e] @ bases[b]^T
        dh_t[e]    = Σ_b c[e, b] · t[e, b]
        dcoef[e,b] = h_t[e] · t[e, b]      (= (h_t[e] @ bases[b]) · dmsg[e])
        dbases[b]  = h_t^T @ (c[:, b] · dmsg)
        dh         = scatter_add_onehot(dh_t, dst)
        dcoeffs    = scatter_add_onehot(dcoef, rel)

    The dense products are the ones XLA runs outside any Pallas kernel in
    the reference's VJP (``torch.matmul``); the two scatters are the
    deterministic ``scatter_add_onehot`` over the step's shared plans."""

    @staticmethod
    def forward(ctx, h, src, rel, dst, edge_mask, bases, coeffs, plans):
        # the gathers stay outside the kernels, as XLA held them in JAX
        h_t = torch.index_select(h, 0, dst)
        c = torch.index_select(coeffs, 0, rel)
        msg = basis_message(h_t, c, bases.contiguous(), edge_mask)
        agg, deg = segment_sum(msg, src, edge_mask, h.shape[0],
                               plan=None if plans is None else plans["src"])
        ctx.save_for_backward(h_t, c, src, rel, dst, edge_mask, bases, deg)
        ctx.plans = plans
        ctx.sizes = (h.shape[0], coeffs.shape[0])
        return agg / torch.clamp_min(deg, 1.0)[:, None]

    @staticmethod
    def backward(ctx, g):
        h_t, c, src, rel, dst, edge_mask, bases, deg = ctx.saved_tensors
        num_v, num_r = ctx.sizes
        plans = ctx.plans
        nb, d_in, d_out = bases.shape
        e = h_t.shape[0]
        dmsg = _segment_gather(g / torch.clamp_min(deg, 1.0)[:, None], src,
                               edge_mask)
        need_h, need_bases, need_coeffs = (ctx.needs_input_grad[0],
                                           ctx.needs_input_grad[5],
                                           ctx.needs_input_grad[6])
        dh = dbases = dcoeffs = None
        if need_h or need_coeffs:
            # t[e, b, i] = Σ_o dmsg[e, o] · bases[b, i, o]: one product
            t = (dmsg @ bases.permute(2, 0, 1).reshape(d_out, nb * d_in)
                 ).reshape(e, nb, d_in)
        if need_h:
            dh_t = (t * c[:, :, None]).sum(dim=1)
            dh = scatter_add_onehot(
                dh_t, dst.long(), None, num_v,
                plan=None if plans is None else plans["dst"])
        if need_coeffs:
            dcoef = (t * h_t[:, None, :]).sum(dim=2)
            dcoeffs = scatter_add_onehot(
                dcoef, rel.long(), None, num_r,
                plan=None if plans is None else plans["rel"])
        if need_bases:
            # dbases[b] = h_t^T @ (c[:, b] · dmsg): one product for all b
            cm = (c[:, :, None] * dmsg[:, None, :]).reshape(e, nb * d_out)
            dbases = (h_t.T @ cm).reshape(d_in, nb, d_out).permute(1, 0, 2)
        return dh, None, None, None, None, dbases, dcoeffs, None


def rgcn_message_basis(h: torch.Tensor, src: torch.Tensor, rel: torch.Tensor,
                       dst: torch.Tensor, edge_mask: torch.Tensor,
                       bases: torch.Tensor, coeffs: torch.Tensor,
                       plans: Optional[EdgePlans] = None) -> torch.Tensor:
    """Fused RGCN message layer: gather → ``basis_message`` →
    ``segment_sum`` → mean, for ``(V, d_in)`` states ``h``, ``(E,)`` heads
    ``src`` (segments), relations ``rel``, tails ``dst`` and bool
    ``edge_mask``, ``(B, d_in, d_out)`` bases and ``(R, B)`` coefficients →
    ``(V, d_out)``. Differentiable in ``h``, ``bases`` and ``coeffs``.
    ``plans``: the :class:`EdgePlans` of these edge arrays, shared with
    the other layers of the encode."""
    return _RGCNMessageBasis.apply(h, src, rel, dst, edge_mask, bases, coeffs,
                                   plans)


def kge_score_padded(q: torch.Tensor, candidates: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     q_bias: Optional[torch.Tensor] = None,
                     c_bias: Optional[torch.Tensor] = None, *,
                     epilogue: str = "bilinear") -> torch.Tensor:
    """``epilogue(q @ candidates.T + q_bias + c_bias) + bias`` over a
    ``(B, C)`` block; missing biases are zeros."""
    b, c = q.shape[0], candidates.shape[0]

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=q.device)

    return kge_score(
        q.contiguous(), candidates.contiguous(),
        zeros(b, c) if bias is None else bias.contiguous(),
        zeros(b) if q_bias is None else q_bias.contiguous(),
        zeros(c) if c_bias is None else c_bias.contiguous(),
        epilogue=epilogue)


def topk_padded(scores: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values (B, k), indices (B, k))``, values descending, ties broken
    toward the LOWEST index. ``k`` must already be clamped to ``[1, C]``
    (the serving layer owns the vocabulary clamp)."""
    c = scores.shape[1]
    if not 1 <= k <= c:
        raise ValueError(f"k={k} outside [1, C={c}] — clamp before topk")
    return topk_scores(scores.float().contiguous(), k)


def merge_topk(vals: torch.Tensor, ids: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global k-way merge of per-shard winners: top-k over the concatenated
    ``(B, S·k')`` value rows, returning the winners' GLOBAL ids.

    Exact: each shard's list is (value desc, local index asc) and shard row
    blocks cover contiguous ascending global-id ranges, so among equal
    values a lower concat position is always a lower global id."""
    c = vals.shape[1]
    if not 1 <= k <= c:
        raise ValueError(f"k={k} outside [1, C={c}] — clamp before merging")
    return topk_scores(vals.float().contiguous(), k, ids.long().contiguous())


def flat_gather_plan(local_ids: torch.Tensor, owned: torch.Tensor,
                     rows_per_shard: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Collapse an ``(S, V)`` per-shard gather plan into flat rows:
    ``flat[v] = Σ_s owned[s, v] ? s·rows + local[s, v] : 0`` — the slot's
    row in the stacked ``(S·rows, d)`` table — and ``any_owned[v]``, false
    for slots no shard owns (dedup padding), which gather exact zeros."""
    s = local_ids.shape[0]
    offsets = (torch.arange(s, dtype=torch.int64, device=local_ids.device)
               * rows_per_shard).reshape((s,) + (1,) * (local_ids.dim() - 1))
    flat = torch.where(owned, local_ids.long() + offsets, 0).sum(dim=0)
    return flat, owned.any(dim=0)


def fused_sharded_gather(table: torch.Tensor, local_ids: torch.Tensor,
                         owned: torch.Tensor, *, check: bool = True,
                         plan: Optional[SegmentPlan] = None
                         ) -> torch.Tensor:
    """``(V, d)`` rows of an ``(S, rows, d)`` row-sharded stack from an
    ``(S, V)`` per-shard plan: the take → mask → sum exchange as one masked
    row gather, bitwise equal to the chain. The plan is resolved where it
    lies (the host, for the server's numpy plans) and moved to the table's
    device with the two ``(V,)`` arrays.

    Differentiable in ``table``: the backward scatter-adds the cotangents
    into the stacked ``(S·rows, d)`` rows with ``scatter_add_onehot``
    (layout-padding rows get zeros), the reference's ``_fsg_bwd``. The
    flat row of a slot is its global id under the row-block layout, so the
    gradient is bitwise the dense gather's (:func:`gather_rows`). ``check``
    as in ``fused_gather``: serving checks every call, training once per
    step. ``plan``: the ``segment_plan`` of the flat rows and ownership
    into the ``S·rows`` stacked rows, when the caller has it."""
    s, rows, d = table.shape
    flat, any_owned = flat_gather_plan(local_ids, owned, rows)
    flat, any_owned = flat.to(table.device), any_owned.to(table.device)
    if not wants_grad(table):
        # serving and ranking: the stack itself, never a flat view of it
        return fused_gather(table, flat, any_owned, check=check)
    return _GatherRows.apply(table.reshape(s * rows, d), flat, any_owned,
                             check, plan)


def masked_take(table: torch.Tensor, local_ids: torch.Tensor,
                owned: torch.Tensor, *, check: bool = True) -> torch.Tensor:
    """One shard's step of the take → mask → sum chain:
    ``owned[v] ? table[local_ids[v]] : 0`` from a ``(rows, d)`` shard, whose
    backward scatters only the owned slots' cotangents into the shard (an
    unowned slot's masked cotangent is zero, so leaving it out changes no
    value, and each row's sum stays the one the fused gather forms)."""
    return _GatherRows.apply(table, local_ids.long(), owned, check, None)


def dequant_sharded_gather(codes: torch.Tensor, scales: torch.Tensor,
                           local_ids: torch.Tensor, owned: torch.Tensor, *,
                           check: bool = True) -> torch.Tensor:
    """``(V, d)`` fp32 rows of an int8 ``(S, rows, d)`` code stack with
    ``(S, rows)`` scales from an ``(S, V)`` plan: the plan collapsed by
    :func:`flat_gather_plan` (where it lies) and one ``fused_dequant_gather``
    over the stack itself (no flat view of it) — only the V gathered rows
    are ever dequantized. Bitwise the reference's
    dequantize-then-gather (``ref.dequant_gather_ref``). No gradient."""
    flat, any_owned = flat_gather_plan(local_ids, owned, codes.shape[1])
    return fused_dequant_gather(codes, scales, flat.to(codes.device),
                                any_owned.to(codes.device), check=check)


def quantized_sharded_gather(table: torch.Tensor, local_ids: torch.Tensor,
                             owned: torch.Tensor, *, check: bool = True,
                             plan: Optional[SegmentPlan] = None
                             ) -> torch.Tensor:
    """The int8 training gather: ``(V, d)`` rows of the fp32 master stack
    ``(S, rows, d)``, quantized row-wise in the step and gathered through
    ``fused_dequant_gather``. Differentiable in ``table`` with the
    straight-through backward, the same scatter-add as
    :func:`fused_sharded_gather`'s, so master gradients are bitwise the
    fp32 path's on the dequantized master. ``check`` and ``plan`` as in
    :func:`fused_sharded_gather`."""
    s, rows, d = table.shape
    flat, any_owned = flat_gather_plan(local_ids, owned, rows)
    return _QuantizedGatherRows.apply(table.reshape(s * rows, d),
                                      flat.to(table.device),
                                      any_owned.to(table.device), check,
                                      plan)


class _WKVChunked(torch.autograd.Function):
    """The chunked WKV with its gradient: forward :func:`wkv_chunked`,
    backward :func:`wkv_chunked_backward` (the kernel for CUDA tensors,
    autograd through the sequential recurrence for CPU tensors) — the
    reference's pairing of its kernel with the VJP of
    ``ref.wkv_chunk_ref`` (``ops.py:405-416``). With ``keep`` (CUDA
    tensors, a gradient wanted, ``chunk`` within the backward kernel's) the
    forward kernel's scratch, the chunks' entering states among it, is
    saved for the backward, which then does not form them again."""

    @staticmethod
    def forward(ctx, r, k, v, log_decay, u, chunk, keep):
        ctx.chunk = min(chunk, BACKWARD_MAX_CHUNK)
        if keep:
            out, states = wkv_chunked_states(r, k, v, log_decay, u,
                                             chunk=chunk)
            ctx.save_for_backward(r, k, v, log_decay, u, *states)
        else:
            out = wkv_chunked(r, k, v, log_decay, u, chunk=chunk)
            ctx.save_for_backward(r, k, v, log_decay, u)
        return out

    @staticmethod
    def backward(ctx, g):
        r, k, v, log_decay, u, *states = ctx.saved_tensors
        grads = wkv_chunked_backward(r, k, v, log_decay, u, g.contiguous(),
                                     chunk=ctx.chunk,
                                     states=tuple(states) or None)
        return (*grads, None, None)


def wkv_chunked_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   log_decay: torch.Tensor, u: torch.Tensor,
                   chunk: int = 64) -> torch.Tensor:
    """Chunked WKV: ``(BH, S, hd)`` ``r, k, v, log_decay`` and ``(BH, hd)``
    bonus ``u`` → ``(BH, S, hd)`` fp32, through :func:`wkv_chunked` (the
    kernel on the card). Any BH and S: the kernel runs a short last chunk
    where the reference pads S to ``chunk`` and BH to 8 with zeros, which
    gives the same outputs on the real rows. Differentiable in all five
    inputs: the backward is :func:`wkv_chunked_backward`."""
    args = [t.float().contiguous() for t in (r, k, v, log_decay, u)]
    # the forward's states serve the backward only on the card, only when a
    # gradient is taken (not while serving), and only in the backward's
    # chunk
    keep = (args[0].is_cuda and chunk <= BACKWARD_MAX_CHUNK
            and torch.is_grad_enabled()
            and any(t.requires_grad for t in args))
    return _WKVChunked.apply(*args, chunk, keep)
