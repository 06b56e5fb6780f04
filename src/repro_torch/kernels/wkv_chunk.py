"""Chunked RWKV-6 WKV (port of ``repro/kernels/wkv_chunk.py``).

Per chunk of ``chunk`` time steps, with the log decays ``lw`` cumulated
along time within the chunk and per key column::

    l_exc = cumsum(lw) - lw,   l_inc = l_exc + lw,   l_tot = l_inc[last]
    out   = strict_lower((r e^{l_exc}) (k e^{-l_inc})^T) v
            + (Σ_d r·u·k) v + (r e^{l_exc}) S_in
    S_out = e^{l_tot} ⊙ S_in + (k e^{l_tot - l_inc})^T v

with the ``(hd, hd)`` state ``S`` zero at each row's first chunk. It is the
sequential recurrence ``ref.wkv_chunk_ref`` refactored, exact in real
arithmetic; the e^{±L} factors are the reference's own (no per-chunk
renormalization), so extreme decays overflow here as they do there.

:func:`wkv_chunked` launches the CUDA kernel ``csrc/wkv_chunk.cu`` for CUDA
tensors and runs :func:`wkv_chunked_plain` for CPU tensors. Both take any
BH and any S: the last chunk of a row may be shorter than ``chunk`` (the
TPU kernel needed BH padded to 8 and S to ``chunk``; a zero-padded tail
gives the same outputs on the real rows).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_SIGNATURES = {
    "wkv_chunked_f32": [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p],
}
# the launcher's code for a block above the device's shared memory
# (csrc's WKV_SMEM_TOO_LARGE)
_SMEM_TOO_LARGE = -1


def _library():
    return _build.load("wkv_chunk", _SIGNATURES)


def wkv_chunked_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      log_decay: torch.Tensor, u: torch.Tensor, *,
                      chunk: int = 64) -> torch.Tensor:
    """Plain PyTorch version: the chunked form of the TPU kernel, one
    batched chunk after another. ``(BH, S, hd)`` fp32 ``r, k, v,
    log_decay`` and ``(BH, hd)`` ``u`` → ``(BH, S, hd)`` fp32."""
    bh, s, hd = r.shape
    r, k, v, lw, u = (t.float() for t in (r, k, v, log_decay, u))
    state = torch.zeros((bh, hd, hd), dtype=torch.float32, device=r.device)
    outs = []
    for lo in range(0, s, chunk):
        hi = min(s, lo + chunk)
        rc, kc, vc, lc = (t[:, lo:hi] for t in (r, k, v, lw))
        l_exc = torch.cumsum(lc, dim=1) - lc
        l_inc = l_exc + lc
        l_tot = l_inc[:, -1:]                        # (BH, 1, hd)
        r_t = rc * torch.exp(l_exc)
        k_t = kc * torch.exp(-l_inc)
        scores = torch.tril(r_t @ k_t.transpose(1, 2), diagonal=-1)
        intra = scores @ vc
        bonus = torch.sum(rc * u[:, None, :] * kc, dim=-1, keepdim=True)
        cross = r_t @ state
        outs.append(intra + bonus * vc + cross)
        k_out = kc * torch.exp(l_tot - l_inc)
        state = torch.exp(l_tot[:, 0])[..., None] * state + \
            k_out.transpose(1, 2) @ vc
    if not outs:
        return torch.zeros_like(r)
    return torch.cat(outs, dim=1)


def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_decay: torch.Tensor, u: torch.Tensor, *,
                chunk: int = 64) -> torch.Tensor:
    """Chunked WKV over ``(BH, S, hd)`` fp32 inputs and ``(BH, hd)`` bonus
    ``u`` → ``(BH, S, hd)`` fp32 — the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. Forward only."""
    if _build.on_cpu("wkv_chunked", r, k, v, log_decay, u):
        return wkv_chunked_plain(r, k, v, log_decay, u, chunk=chunk)
    if r.dim() != 3:
        raise ValueError("wkv_chunked: r, k, v and log_decay must be "
                         "(BH, S, hd)")
    bh, s, hd = r.shape
    f32 = torch.float32
    for name, t in (("r", r), ("k", k), ("v", v), ("log_decay", log_decay)):
        _build.require("wkv_chunked", name, t, f32, (bh, s, hd))
    _build.require("wkv_chunked", "u", u, f32, (bh, hd))
    if chunk < 1 or hd < 1:
        raise ValueError(f"wkv_chunked: chunk={chunk} and hd={hd} must be "
                         f"positive")
    lib = _library()
    with torch.cuda.device(r.device):
        out = torch.empty((bh, s, hd), dtype=f32, device=r.device)
        code = lib.wkv_chunked_f32(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), log_decay.data_ptr(),
            u.data_ptr(), out.data_ptr(), bh, s, hd, chunk,
            torch.cuda.current_stream().cuda_stream)
    if code == _SMEM_TOO_LARGE:
        raise ValueError(f"wkv_chunked: one block of hd={hd}, chunk={chunk} "
                         f"needs more shared memory than this card gives a "
                         f"block")
    _build.check_launch("wkv_chunked", code)
    if bh and s:
        wkv_chunked.launches += 1
    return out


wkv_chunked.launches = 0
