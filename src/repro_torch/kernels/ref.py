"""Plain PyTorch references for the kernels, under the JAX package's
``repro/kernels/ref.py`` names.

Each kernel's plain version sits beside it in its own module; this module
gives them the reference signatures (optional biases), keeps the original
take → mask → sum exchange chain that the fused gather replaces, and holds
the int8 table's independent oracles (quantization by search over every
fp32 power of two, dequantize-then-gather) and the sequential WKV
recurrence that the chunked WKV refactors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.kge_score import apply_epilogue
from repro_torch.kernels.ops import gather_rows
from repro_torch.kernels.rgcn_message import (
    basis_message_plain as basis_message_ref,
)
from repro_torch.kernels.rgcn_message import segment_sum_plain
from repro_torch.kernels.sharded_gather import scatter_add_onehot_plain
from repro_torch.kernels.topk import topk_plain as topk_ref

__all__ = ["basis_message_ref", "segment_mean_ref", "rgcn_message_ref",
           "kge_score_ref", "topk_ref", "sharded_gather_ref",
           "sharded_scatter_add_ref", "quantize_rows_ref",
           "dequantize_rows_ref", "dequant_gather_ref", "wkv_chunk_ref"]


def segment_mean_ref(msg: torch.Tensor, seg: torch.Tensor,
                     edge_mask: torch.Tensor, num_segments: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked segment sum + counts → ``(agg (V, d), deg (V,))``."""
    return segment_sum_plain(msg, seg, edge_mask, num_segments)


def rgcn_message_ref(h: torch.Tensor, src: torch.Tensor, rel: torch.Tensor,
                     dst: torch.Tensor, edge_mask: torch.Tensor,
                     bases: torch.Tensor, coeffs: torch.Tensor
                     ) -> torch.Tensor:
    """The fused op's formula: gather → basis message → segment MEAN. The
    gathers are ``gather_rows``, so its gradient is deterministic on the
    card."""
    msg = basis_message_ref(gather_rows(h, dst), gather_rows(coeffs, rel),
                            bases, edge_mask)
    agg, deg = segment_mean_ref(msg, src, edge_mask, h.shape[0])
    return agg / torch.clamp_min(deg, 1.0)[:, None]


def kge_score_ref(q: torch.Tensor, candidates: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  q_bias: Optional[torch.Tensor] = None,
                  c_bias: Optional[torch.Tensor] = None,
                  epilogue: str = "bilinear") -> torch.Tensor:
    """``epilogue(q @ candidates.T + q_bias + c_bias) + bias``; a missing
    bias is not added."""
    x = q @ candidates.T
    if q_bias is not None:
        x = x + q_bias[:, None]
    if c_bias is not None:
        x = x + c_bias[None, :]
    out = apply_epilogue(x, epilogue)
    return out if bias is None else out + bias


def sharded_gather_ref(table: torch.Tensor, local_ids: torch.Tensor,
                       owned: torch.Tensor) -> torch.Tensor:
    """The shard-local take → mask → sum chain over an ``(S, rows, d)``
    stack with ``(S, V)`` local ids and ownership masks."""
    g = torch.stack([table[s][local_ids[s]] for s in range(table.shape[0])])
    zero = torch.zeros((), dtype=table.dtype, device=table.device)
    return torch.where(owned[:, :, None], g, zero).sum(dim=0)


def sharded_scatter_add_ref(g: torch.Tensor, flat_ids: torch.Tensor,
                            any_owned: torch.Tensor,
                            num_rows: int) -> torch.Tensor:
    """Transpose of the fused gather: the masked scatter-add of the
    cotangents into the stacked table rows (``scatter_add_onehot``)."""
    return scatter_add_onehot_plain(g, flat_ids.long(), any_owned.bool(),
                                    num_rows)


def quantize_rows_ref(table: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Independent oracle for ``sharding.embedding.quantize_rows``.

    Each row's scale is the SMALLEST ``2^k`` (k in [-149, 127], subnormals
    included) with ``127 · 2^k >= amax(row)``, or 0.0 for an all-zero row;
    codes are ``rint(row / scale)`` clipped to ±127. All integer: k by
    search over a table of every ``127 · 2^k`` built exactly in numpy and
    compared as bit patterns (for non-negative fp32 the bit order is the
    value order; entries past ``2^127`` overflow to +inf, which still
    compares above every finite amax), and each code by shift and
    round-half-even of the element's integer mantissa."""
    k_all = np.arange(-149, 128)
    with np.errstate(over="ignore"):
        thresh = torch.from_numpy(
            (np.float32(127.0) * np.ldexp(np.float32(1.0), k_all))
            .astype(np.float32).view(np.int32).astype(np.int64)
        ).to(table.device)
    pows = torch.from_numpy(np.ldexp(np.float32(1.0), k_all).astype(
        np.float32)).to(table.device)
    bits = table.float().contiguous().view(torch.int32).long()
    mag = bits & 0x7FFFFFFF
    amax_bits = mag.max(dim=-1).values
    idx = torch.argmax((thresh >= amax_bits[..., None]).to(torch.int8),
                       dim=-1)
    k = idx - 149
    zero = torch.zeros((), dtype=torch.float32, device=table.device)
    scale = torch.where(amax_bits > 0, pows[idx], zero)
    # |x| = M · 2^E in integers
    e_f, m_f = mag >> 23, mag & 0x7FFFFF
    big_m = torch.where(e_f == 0, m_f, m_f | (1 << 23))
    big_e = torch.where(e_f == 0, -149, e_f - 150)
    one = torch.ones_like(big_m)
    shift = big_e - k[..., None]
    left = big_m << torch.clamp(shift, 0, 7)
    t = torch.clamp(-shift, 1, 25)
    floor = big_m >> t
    rem = big_m & ((one << t) - 1)
    half = one << (t - 1)
    round_up = (rem > half) | ((rem == half) & ((floor & 1) == 1))
    code_mag = torch.where(shift >= 0, left, floor + round_up.long())
    codes = torch.clamp(torch.where(bits < 0, -code_mag, code_mag),
                        -127, 127).to(torch.int8)
    return codes, scale


def dequantize_rows_ref(codes: torch.Tensor,
                        scales: torch.Tensor) -> torch.Tensor:
    """``codes.float() · scale``, exact (an int8 times a power of two)."""
    return codes.to(torch.float32) * scales[..., None]


def dequant_gather_ref(codes: torch.Tensor, scales: torch.Tensor,
                       local_ids: torch.Tensor,
                       owned: torch.Tensor) -> torch.Tensor:
    """Dequantize the whole ``(S, rows, d)`` stack, then run the original
    exchange chain: the oracle of ``fused_dequant_gather`` /
    ``ops.dequant_sharded_gather``, which must match it bitwise."""
    return sharded_gather_ref(dequantize_rows_ref(codes, scales),
                              local_ids.long(), owned)


def wkv_chunk_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  log_decay: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The sequential WKV recurrence (the RWKV-6 time-mix core) over
    ``(BH, S, hd)`` inputs with ``(BH, hd)`` bonus ``u``, one step at a
    time::

        out_t = r_t · (S_{t-1} + diag(u) k_t^T v_t)
        S_t   = diag(w_t) S_{t-1} + k_t^T v_t,   w_t = exp(log_decay_t)

    The oracle of ``wkv_chunk.wkv_chunked`` and the plain version of its
    chunked form; autograd through it is the plain version of the gradient
    (``wkv_chunk.wkv_chunked_backward_plain``). It runs in fp32, or in
    fp64 for fp64 inputs."""
    bh, s, hd = r.shape
    dt = torch.promote_types(r.dtype, torch.float32)
    r, k, v = r.to(dt), k.to(dt), v.to(dt)
    w = torch.exp(log_decay.to(dt))
    u = u.to(dt)
    state = torch.zeros((bh, hd, hd), dtype=dt, device=r.device)
    outs = []
    for t in range(s):
        kv = k[:, t, :, None] * v[:, t, None, :]
        outs.append(torch.einsum("bk,bkv->bv", r[:, t],
                                 state + u[..., None] * kv))
        state = w[:, t, :, None] * state + kv
    if not outs:
        return torch.zeros_like(r)
    return torch.stack(outs, dim=1)
