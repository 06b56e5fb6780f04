"""Fused sharded-table row gather (port of ``fused_gather`` in
``repro/kernels/sharded_gather.py``).

Exactly one shard owns every id of the row-sharded entity table, so the
shard-local take → mask → sum exchange folds into index arithmetic
(``ops.flat_gather_plan``): ``flat[v]`` is the slot's row in the stacked
``(S · rows, d)`` table and the whole exchange is one masked row gather,

    ``out[v] = any_owned[v] ? table_flat[flat[v]] : 0``

bitwise equal to the chain (each output element is the owner's value).

:func:`fused_gather` launches the CUDA kernel ``csrc/sharded_gather.cu`` for
CUDA tensors and runs :func:`fused_gather_plain` for CPU tensors. A flat id
outside the table is a broken plan: the plain version raises an
``IndexError`` on it, and so does the kernel's wrapper, which for that waits
for the gather to finish (one synchronisation of the current stream per
call) and reads the slot the kernel flagged.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_SIGNATURES = {"fused_gather_f32": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p]}

# per CUDA device: a pinned host int64 the kernel sets to (slot + 1) when a
# slot's flat id lies outside the table, 0 otherwise
_BAD_SLOT = {}


def fused_gather_plain(table_flat: torch.Tensor, flat_ids: torch.Tensor,
                       any_owned: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``(R, d)`` table, ``(V,)`` int64 flat rows,
    ``(V,)`` bool ownership → ``(V, d)``, zero rows where no shard owns
    the slot."""
    zero = torch.zeros((), dtype=table_flat.dtype, device=table_flat.device)
    return torch.where(any_owned[:, None], table_flat[flat_ids], zero)


def fused_gather(table_flat: torch.Tensor, flat_ids: torch.Tensor,
                 any_owned: torch.Tensor) -> torch.Tensor:
    """``out[v] = any_owned[v] ? table_flat[flat_ids[v]] : 0`` — the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if _build.on_cpu("fused_gather", table_flat, flat_ids, any_owned):
        return fused_gather_plain(table_flat, flat_ids, any_owned)
    if table_flat.dim() != 2 or flat_ids.dim() != 1:
        raise ValueError("fused_gather: table_flat must be 2-D and flat_ids "
                         "1-D")
    r, d = table_flat.shape
    v = flat_ids.shape[0]
    _build.require("fused_gather", "table_flat", table_flat, torch.float32,
                   (r, d))
    _build.require("fused_gather", "flat_ids", flat_ids, torch.int64, (v,))
    _build.require("fused_gather", "any_owned", any_owned, torch.bool, (v,))
    out = torch.empty((v, d), dtype=torch.float32, device=table_flat.device)
    if out.numel() == 0:
        return out
    lib = _build.load("sharded_gather", _SIGNATURES)
    with torch.cuda.device(table_flat.device):
        bad = _BAD_SLOT.get(table_flat.device.index)
        if bad is None:
            bad = _BAD_SLOT[table_flat.device.index] = torch.zeros(
                1, dtype=torch.int64, pin_memory=True)
        stream = torch.cuda.current_stream()
        code = lib.fused_gather_f32(
            table_flat.data_ptr(), flat_ids.data_ptr(), any_owned.data_ptr(),
            out.data_ptr(), r, v, d, bad.data_ptr(), stream.cuda_stream)
        _build.check_launch("fused_gather", code)
        fused_gather.launches += 1
        stream.synchronize()
    slot = int(bad[0]) - 1
    if slot >= 0:
        bad[0] = 0
        raise IndexError(f"fused_gather: slot {slot} has flat id "
                         f"{int(flat_ids[slot])}, outside the table's {r} "
                         f"rows")
    return out


fused_gather.launches = 0
