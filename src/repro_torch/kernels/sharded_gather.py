"""The sharded table's row exchange, forward and backward (port of
``fused_gather``, ``fused_dequant_gather`` and ``scatter_add_onehot`` in
``repro/kernels/sharded_gather.py``).

Exactly one shard owns every id of the row-sharded entity table, so the
shard-local take → mask → sum exchange folds into index arithmetic
(``ops.flat_gather_plan``): ``flat[v]`` is the slot's row in the stacked
``(S · rows, d)`` table and the whole exchange is one masked row gather,

    ``out[v] = any_owned[v] ? table_flat[flat[v]] : 0``

bitwise equal to the chain (each output element is the owner's value).
The int8 table's twin dequantizes the gathered row on the way,

    ``out[v] = any_owned[v] ? codes_flat[flat[v]] · scales_flat[flat[v]] : 0``

one exact fp32 product per element, so it is bitwise the gather of the
dequantized table. The transpose of both is the masked scatter-add

    ``out[r] = Σ_v [flat[v] == r ∧ owned[v]] · g[v]``,

the gradient of the sharded table and of every row gather on the training
path (``ops.gather_rows``).

Each wrapper launches its CUDA kernel from ``csrc/sharded_gather.cu`` for
CUDA tensors and runs its plain version for CPU tensors.
:func:`fused_gather_v1` and :func:`fused_dequant_gather_v1` launch the
first ``fused_gather`` and ``fused_dequant_gather`` kernels (a block per
row), kept as the bitwise yardsticks of the warp-per-rows ones;
:func:`scatter_add_onehot_v1` the first scatter-add passes (the RGCN
segment sum's), the yardstick of ``segment_sum.cuh``'s scatter passes.

* :func:`fused_gather` and :func:`fused_dequant_gather`. A flat id outside
  the table is a broken plan: the plain version raises an ``IndexError``
  on it. The kernel flags the slot in pinned host memory instead; with
  ``check=True`` (serving) the wrapper waits for the gather (one
  synchronisation of the current stream) and raises, with ``check=False``
  (training) it does not wait, and :func:`raise_if_flagged` raises once
  the caller has waited anyway.
* :func:`scatter_add_onehot` sums without float atomics: the slots are
  sorted stably by row (``rgcn_message.segment_plan``, unowned slots under
  a sentinel row) and each row's slots are added in slot order, in chunks,
  by two passes in the RGCN segment sum's order. So two runs give the
  same bits, and a row's sum depends only on which slots hit it and in
  what order. The plan is a value of its own: a caller that scatters over the
  same ids more than once in a step (or holds the plan with a resident
  batch) passes it in, and the call is then the two kernels alone.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rgcn_message import (
    CHUNK, SegmentPlan, check_plan, segment_key, segment_plan,
)

_GATHER_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p]
_DEQUANT_ARGTYPES = [ctypes.c_void_p] + _GATHER_ARGTYPES
_SCATTER_TAIL = [ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]
_SIGNATURES = {
    "fused_gather_f32": _GATHER_ARGTYPES,
    "fused_gather_f32_v1": _GATHER_ARGTYPES,
    "fused_dequant_gather_i8": _DEQUANT_ARGTYPES,
    "fused_dequant_gather_i8_v1": _DEQUANT_ARGTYPES,
    "scatter_add_f32": [ctypes.c_void_p] * 7 + _SCATTER_TAIL,
    "scatter_add_f32_v1": [ctypes.c_void_p] * 6 + _SCATTER_TAIL,
}

# per CUDA device: a pinned host int64 the kernel sets to (slot + 1) when a
# slot's flat id lies outside the table, 0 otherwise
_BAD_SLOT = {}


def _library():
    return _build.load("sharded_gather", _SIGNATURES)


def flat_rows(x: torch.Tensor, flat_ids: torch.Tensor,
              lead: int) -> torch.Tensor:
    """Rows ``flat_ids`` of ``x`` over its ``lead`` leading axes read as
    one: of an ``(R, ...)`` table (``lead`` 1), or of an ``(S, rows, ...)``
    stack (``lead`` 2) as its ``S·rows`` flat rows, indexed by shard and
    row so that no flattened ``(S·rows, ...)`` view of the stack is made
    (the comm audit's replication rule holds serving to that)."""
    if lead == 1:
        return x[flat_ids]
    rows = x.shape[1]
    return x[torch.div(flat_ids, rows, rounding_mode="floor"),
             flat_ids % rows]


def _table_rows(table: torch.Tensor) -> int:
    """Flat rows of an ``(R, d)`` table or an ``(S, rows, d)`` stack."""
    return table.shape[0] * (table.shape[1] if table.dim() == 3 else 1)


def fused_gather_plain(table_flat: torch.Tensor, flat_ids: torch.Tensor,
                       any_owned: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``(R, d)`` table (or ``(S, rows, d)`` stack,
    read as its flat rows), ``(V,)`` int64 flat rows, ``(V,)`` bool
    ownership → ``(V, d)``, zero rows where no shard owns the slot."""
    zero = torch.zeros((), dtype=table_flat.dtype, device=table_flat.device)
    return torch.where(any_owned[:, None],
                       flat_rows(table_flat, flat_ids, table_flat.dim() - 1),
                       zero)


def _bad_slot_flag(device: torch.device) -> torch.Tensor:
    bad = _BAD_SLOT.get(device.index)
    if bad is None:
        bad = _BAD_SLOT[device.index] = torch.zeros(
            1, dtype=torch.int64, pin_memory=True)
    return bad


def _check_flag(kernel: str, bad: torch.Tensor, flat_ids: torch.Tensor,
                rows: int) -> None:
    """After a synchronised launch: raise on (and clear) a flagged slot."""
    slot = int(bad[0]) - 1
    if slot >= 0:
        bad[0] = 0
        raise IndexError(f"{kernel}: slot {slot} has flat id "
                         f"{int(flat_ids[slot])}, outside the table's "
                         f"{rows} rows")


def raise_if_flagged(device: torch.device) -> None:
    """Raise ``IndexError`` if a :func:`fused_gather` or
    :func:`fused_dequant_gather` on ``device`` flagged a flat id outside
    its table, and clear the flag. Reads the pinned flag without
    synchronising: call it once the launches in question have finished
    (the trainer does, after reading the step's loss)."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    bad = _BAD_SLOT.get(device.index)
    if bad is None:
        return
    slot = int(bad[0]) - 1
    if slot >= 0:
        bad[0] = 0
        raise IndexError(f"sharded gather: slot {slot} has a flat id "
                         f"outside the table")


def _gather(entry: str, counter, table_flat: torch.Tensor,
            flat_ids: torch.Tensor, any_owned: torch.Tensor,
            check: bool) -> torch.Tensor:
    """Check the operands and launch the C entry point ``entry`` on CUDA
    tensors, adding one to ``counter.launches`` when given."""
    if table_flat.dim() not in (2, 3) or flat_ids.dim() != 1:
        raise ValueError("fused_gather: table_flat must be 2-D (or a 3-D "
                         "stack) and flat_ids 1-D")
    r, d = _table_rows(table_flat), table_flat.shape[-1]
    v = flat_ids.shape[0]
    _build.require("fused_gather", "table_flat", table_flat, torch.float32,
                   table_flat.shape)
    _build.require("fused_gather", "flat_ids", flat_ids, torch.int64, (v,))
    _build.require("fused_gather", "any_owned", any_owned, torch.bool, (v,))
    out = torch.empty((v, d), dtype=torch.float32, device=table_flat.device)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(table_flat.device):
        bad = _bad_slot_flag(table_flat.device)
        stream = torch.cuda.current_stream()
        code = getattr(lib, entry)(
            table_flat.data_ptr(), flat_ids.data_ptr(), any_owned.data_ptr(),
            out.data_ptr(), r, v, d, bad.data_ptr(), stream.cuda_stream)
        _build.check_launch("fused_gather", code)
        if counter is not None:
            counter.launches += 1
        if not check:
            return out
        stream.synchronize()
    _check_flag("fused_gather", bad, flat_ids, r)
    return out


def fused_gather_bytes(v: int, d: int, n_own: Optional[int] = None) -> int:
    """Bytes a gather of ``V`` slots of ``d`` fp32 columns must move: the
    ``n_own`` owned rows read (every slot when not given), each slot's
    int64 id and bool ownership read, the ``(V, d)`` output written. It
    does no arithmetic."""
    n_own = v if n_own is None else n_own
    return 4 * n_own * d + 9 * v + 4 * v * d


def fused_gather(table_flat: torch.Tensor, flat_ids: torch.Tensor,
                 any_owned: torch.Tensor, *, check: bool = True
                 ) -> torch.Tensor:
    """``out[v] = any_owned[v] ? table_flat[flat_ids[v]] : 0`` — the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors.
    ``table_flat`` is ``(R, d)``, or an ``(S, rows, d)`` stack taken as its
    ``S·rows`` flat rows (the kernel reads the same memory). ``check``:
    wait for the gather and raise on a flat id outside the table (else
    see :func:`raise_if_flagged`). Fake tensors take the abstract branch
    (the dry run), which counts every slot as owned."""
    if _build.is_abstract(table_flat, flat_ids, any_owned):
        from repro_torch.sharding.step_analysis import local_kernel_call
        return local_kernel_call(
            "fused_gather", lambda t, ids, _: torch.empty(
                (ids.shape[0], t.shape[-1]), dtype=t.dtype, device=t.device),
            (table_flat, flat_ids, any_owned), lambda *_: 0,
            lambda t, ids, _: fused_gather_bytes(ids.shape[0], t.shape[-1]))
    if _build.on_cpu("fused_gather", table_flat, flat_ids, any_owned):
        return fused_gather_plain(table_flat, flat_ids, any_owned)
    return _gather("fused_gather_f32", fused_gather, table_flat, flat_ids,
                   any_owned, check)


fused_gather.launches = 0


def fused_gather_v1(table_flat: torch.Tensor, flat_ids: torch.Tensor,
                    any_owned: torch.Tensor, *, check: bool = True
                    ) -> torch.Tensor:
    """The first port's kernel (one block per row) on CUDA tensors, kept as
    the bitwise yardstick of :func:`fused_gather`: both copy each row.
    Not on any path of the port; it counts no launches."""
    if _build.on_cpu("fused_gather", table_flat, flat_ids, any_owned):
        raise ValueError("fused_gather_v1: CUDA tensors only (the plain "
                         "version is fused_gather_plain)")
    return _gather("fused_gather_f32_v1", None, table_flat, flat_ids,
                   any_owned, check)


def fused_dequant_gather_plain(codes_flat: torch.Tensor,
                               scales_flat: torch.Tensor,
                               flat_ids: torch.Tensor,
                               any_owned: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``(R, d)`` int8 codes, ``(R,)`` fp32 scales
    (or an ``(S, rows, d)`` / ``(S, rows)`` stack, read as flat rows),
    ``(V,)`` int64 flat rows, ``(V,)`` bool ownership → ``(V, d)`` fp32,
    zero rows where no shard owns the slot."""
    lead = codes_flat.dim() - 1
    rows = (flat_rows(codes_flat, flat_ids, lead).float()
            * flat_rows(scales_flat, flat_ids, lead)[:, None])
    zero = torch.zeros((), dtype=torch.float32, device=codes_flat.device)
    return torch.where(any_owned[:, None], rows, zero)


def _dequant_gather(entry: str, counter, codes_flat: torch.Tensor,
                    scales_flat: torch.Tensor, flat_ids: torch.Tensor,
                    any_owned: torch.Tensor, check: bool) -> torch.Tensor:
    """Check the operands and launch the C entry point ``entry`` on CUDA
    tensors, adding one to ``counter.launches`` when given."""
    name = "fused_dequant_gather"
    if codes_flat.dim() not in (2, 3) or flat_ids.dim() != 1:
        raise ValueError(f"{name}: codes_flat must be 2-D (or a 3-D stack) "
                         f"and flat_ids 1-D")
    r, d = _table_rows(codes_flat), codes_flat.shape[-1]
    v = flat_ids.shape[0]
    _build.require(name, "codes_flat", codes_flat, torch.int8,
                   codes_flat.shape)
    _build.require(name, "scales_flat", scales_flat, torch.float32,
                   codes_flat.shape[:-1])
    _build.require(name, "flat_ids", flat_ids, torch.int64, (v,))
    _build.require(name, "any_owned", any_owned, torch.bool, (v,))
    out = torch.empty((v, d), dtype=torch.float32, device=codes_flat.device)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(codes_flat.device):
        bad = _bad_slot_flag(codes_flat.device)
        stream = torch.cuda.current_stream()
        code = getattr(lib, entry)(
            codes_flat.data_ptr(), scales_flat.data_ptr(),
            flat_ids.data_ptr(), any_owned.data_ptr(), out.data_ptr(), r, v,
            d, bad.data_ptr(), stream.cuda_stream)
        _build.check_launch(name, code)
        if counter is not None:
            counter.launches += 1
        if not check:
            return out
        stream.synchronize()
    _check_flag(name, bad, flat_ids, r)
    return out


def fused_dequant_gather_ops(v: int, d: int) -> int:
    """Operations of a dequantizing gather: one multiply an output
    element."""
    return v * d


def fused_dequant_gather_bytes(v: int, d: int,
                               n_own: Optional[int] = None) -> int:
    """Bytes a dequantizing gather must move: the ``n_own`` owned rows'
    int8 codes and fp32 scales read (every slot when not given), each
    slot's id and ownership read, the fp32 ``(V, d)`` output written."""
    n_own = v if n_own is None else n_own
    return n_own * d + 4 * n_own + 9 * v + 4 * v * d


def fused_dequant_gather(codes_flat: torch.Tensor, scales_flat: torch.Tensor,
                         flat_ids: torch.Tensor, any_owned: torch.Tensor, *,
                         check: bool = True) -> torch.Tensor:
    """``out[v] = any_owned[v] ? codes_flat[flat_ids[v]] ·
    scales_flat[flat_ids[v]] : 0`` in fp32 — the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. ``codes_flat`` and
    ``scales_flat`` may be an ``(S, rows, d)`` / ``(S, rows)`` stack, as
    in :func:`fused_gather`. ``check`` as in :func:`fused_gather`. Fake
    tensors take the abstract branch, every slot owned."""
    if _build.is_abstract(codes_flat, scales_flat, flat_ids, any_owned):
        from repro_torch.sharding.step_analysis import local_kernel_call
        return local_kernel_call(
            "fused_dequant_gather", lambda c, _, ids, __: torch.empty(
                (ids.shape[0], c.shape[-1]), dtype=torch.float32,
                device=c.device),
            (codes_flat, scales_flat, flat_ids, any_owned),
            lambda c, _, ids, __: fused_dequant_gather_ops(ids.shape[0],
                                                           c.shape[-1]),
            lambda c, _, ids, __: fused_dequant_gather_bytes(ids.shape[0],
                                                             c.shape[-1]))
    if _build.on_cpu("fused_dequant_gather", codes_flat, scales_flat,
                     flat_ids, any_owned):
        return fused_dequant_gather_plain(codes_flat, scales_flat, flat_ids,
                                          any_owned)
    return _dequant_gather("fused_dequant_gather_i8", fused_dequant_gather,
                           codes_flat, scales_flat, flat_ids, any_owned,
                           check)


def fused_dequant_gather_v1(codes_flat: torch.Tensor,
                            scales_flat: torch.Tensor,
                            flat_ids: torch.Tensor, any_owned: torch.Tensor,
                            *, check: bool = True) -> torch.Tensor:
    """The first port's kernel (one block per row) on CUDA tensors, kept as
    the bitwise yardstick of :func:`fused_dequant_gather`: both take each
    element's product with ``__fmul_rn``. Not on any path of the port; it
    counts no launches."""
    if _build.on_cpu("fused_dequant_gather", codes_flat, scales_flat,
                     flat_ids, any_owned):
        raise ValueError("fused_dequant_gather_v1: CUDA tensors only (the "
                         "plain version is fused_dequant_gather_plain)")
    return _dequant_gather("fused_dequant_gather_i8_v1", None, codes_flat,
                           scales_flat, flat_ids, any_owned, check)


fused_dequant_gather.launches = 0


def scatter_add_onehot_plain(g: torch.Tensor, flat_ids: torch.Tensor,
                             owned: Optional[torch.Tensor],
                             num_rows: int) -> torch.Tensor:
    """Plain PyTorch version: ``(V, d)`` cotangents, ``(V,)`` flat rows in
    ``[0, R)`` and bool ownership (``None``: every slot owned) → ``(R, d)``,
    one ``index_add_`` in slot order. Unowned slots go to a sentinel row
    that is dropped."""
    key = segment_key(flat_ids, owned, num_rows)
    out = torch.zeros((num_rows + 1, g.shape[1]), dtype=g.dtype,
                      device=g.device).index_add_(0, key, g)
    return out[:num_rows]


def _scatter_operands(g: torch.Tensor, flat_ids: torch.Tensor,
                      owned: Optional[torch.Tensor], num_rows: int) -> int:
    """Check a CUDA scatter-add's operands; returns R."""
    if g.dim() != 2:
        raise ValueError("scatter_add_onehot: g must be (V, d)")
    v, d = g.shape
    r = int(num_rows)
    _build.require("scatter_add_onehot", "g", g, torch.float32, (v, d))
    _build.require("scatter_add_onehot", "flat_ids", flat_ids, torch.int64,
                   (v,))
    if owned is not None:
        _build.require("scatter_add_onehot", "owned", owned, torch.bool,
                       (v,))
    if d < 1 or r >= 2 ** 31:
        raise ValueError(f"scatter_add_onehot: d={d} must be positive and "
                         f"R={r} below 2**31")
    return r


def scatter_add_onehot_ops(v: int, d: int,
                           n_own: Optional[int] = None) -> int:
    """Operations of the scatter-add: one add an element of the ``n_own``
    owned slots' cotangents (every slot when not given)."""
    return (v if n_own is None else n_own) * d


def scatter_add_onehot_bytes(v: int, r: int, d: int,
                             n_own: Optional[int] = None,
                             owned: bool = True) -> int:
    """Bytes the scatter-add must move, fp32: the ``n_own`` owned slots'
    cotangents read (every slot when not given), each slot's int64 id and,
    with ``owned``, its bool ownership read, the ``(R, d)`` rows
    written."""
    n_own = v if n_own is None else n_own
    return 4 * n_own * d + 8 * v + (v if owned else 0) + 4 * r * d


def scatter_add_onehot(g: torch.Tensor, flat_ids: torch.Tensor,
                       owned: Optional[torch.Tensor], num_rows: int,
                       plan: Optional[SegmentPlan] = None) -> torch.Tensor:
    """``out[r] = Σ_v [flat_ids[v] == r ∧ owned[v]] · g[v]`` over ``(V, d)``
    fp32 cotangents into ``(R, d)`` — the CUDA kernel for CUDA tensors
    (over ``plan``, the ``segment_plan`` of ``flat_ids`` and ``owned``,
    built here when not given), the plain version for CPU tensors.
    ``owned=None`` owns every slot; owned slots' ``flat_ids`` must lie in
    ``[0, R)``. Fake tensors take the abstract branch (the dry run), every
    slot owned."""
    tensors = (g, flat_ids) + (() if owned is None else (owned,))
    if _build.is_abstract(*tensors):
        from repro_torch.sharding.step_analysis import local_kernel_call
        v, d = g.shape
        return local_kernel_call(
            "scatter_add_onehot", lambda g, *_: torch.empty(
                (num_rows, d), dtype=torch.float32, device=g.device),
            tensors, lambda *_: scatter_add_onehot_ops(v, d),
            lambda *_: scatter_add_onehot_bytes(
                v, num_rows, d, owned=owned is not None))
    if plan is not None:
        check_plan("scatter_add_onehot", plan, flat_ids, owned, num_rows)
    if _build.on_cpu("scatter_add_onehot", *tensors):
        return scatter_add_onehot_plain(g, flat_ids, owned, num_rows)
    r = _scatter_operands(g, flat_ids, owned, num_rows)
    if r == 0:
        return torch.empty((0, g.shape[1]), dtype=torch.float32,
                           device=g.device)
    if plan is None:
        plan = segment_plan(flat_ids, owned, r)
    return scatter_add_planned(g, *plan, r)


def scatter_add_onehot_v1(g: torch.Tensor, flat_ids: torch.Tensor,
                          owned: Optional[torch.Tensor], num_rows: int,
                          plan: Optional[SegmentPlan] = None
                          ) -> torch.Tensor:
    """The first port's passes (a warp per chunk found by a binary search,
    a block per row to combine) on CUDA tensors, kept as the bitwise
    yardstick of :func:`scatter_add_onehot`: both add in the same order.
    Not on any path of the port; it counts no launches."""
    tensors = (g, flat_ids) + (() if owned is None else (owned,))
    if _build.on_cpu("scatter_add_onehot", *tensors):
        raise ValueError("scatter_add_onehot_v1: CUDA tensors only (the "
                         "plain version is scatter_add_onehot_plain)")
    if plan is not None:
        check_plan("scatter_add_onehot_v1", plan, flat_ids, owned, num_rows)
    r = _scatter_operands(g, flat_ids, owned, num_rows)
    if r == 0:
        return torch.empty((0, g.shape[1]), dtype=torch.float32,
                           device=g.device)
    if plan is None:
        plan = segment_plan(flat_ids, owned, r)
    return _scatter_launch("scatter_add_f32_v1", None, g, *plan, r)


def scatter_add_planned(g: torch.Tensor, perm: torch.Tensor,
                        offsets: torch.Tensor, chunk_ptr: torch.Tensor,
                        num_rows: int) -> torch.Tensor:
    """The kernel alone on CUDA tensors, given ``segment_plan``'s output
    for the slots' flat rows and ownership."""
    return _scatter_launch("scatter_add_f32", scatter_add_onehot, g, perm,
                           offsets, chunk_ptr, num_rows)


def _scatter_launch(entry: str, counter, g: torch.Tensor, perm: torch.Tensor,
                    offsets: torch.Tensor, chunk_ptr: torch.Tensor,
                    num_rows: int) -> torch.Tensor:
    """Launch the C entry point ``entry`` over a plan, adding one to
    ``counter.launches`` when given."""
    v, d = g.shape
    r = int(num_rows)
    i64 = torch.int64
    _build.require("scatter_add_onehot", "perm", perm, i64, (v,))
    _build.require("scatter_add_onehot", "offsets", offsets, i64, (r + 1,))
    _build.require("scatter_add_onehot", "chunk_ptr", chunk_ptr, i64,
                   (r + 1,))
    out = torch.empty((r, d), dtype=torch.float32, device=g.device)
    # chunks: sum over rows of ceil(hits / CHUNK) <= V / CHUNK + R
    max_chunks = v // CHUNK + r
    partial = torch.empty((max_chunks, d), dtype=torch.float32,
                          device=g.device)
    lib = _library()
    with torch.cuda.device(g.device):
        ptrs = [g.data_ptr(), perm.data_ptr(), offsets.data_ptr(),
                chunk_ptr.data_ptr(), out.data_ptr(), partial.data_ptr()]
        if entry == "scatter_add_f32":   # its list of the long rows
            long_rows = torch.empty(r + 1, dtype=i64, device=g.device)
            ptrs.append(long_rows.data_ptr())
        code = getattr(lib, entry)(
            *ptrs, r, d, max_chunks, torch.cuda.current_stream().cuda_stream)
    _build.check_launch("scatter_add_onehot", code)
    if counter is not None:
        counter.launches += 1
    return out


scatter_add_onehot.launches = 0
