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
gives the same outputs on the real rows). :func:`wkv_chunked_v1` launches
the first kernel (a block per row), kept as the bitwise yardstick of the
column-tiled one.

:func:`wkv_chunked_backward` is the gradient: the VJP of the sequential
recurrence, as the reference pairs its kernel with ``jax.vjp`` of
``ref.wkv_chunk_ref``. It launches the CUDA kernel
``wkv_chunked_backward_f32`` for CUDA tensors (hd up to 64) and runs
:func:`wkv_chunked_backward_plain`, autograd through ``ref.wkv_chunk_ref``,
for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_INTS = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
_SIGNATURES = {
    "wkv_chunked_f32": [ctypes.c_void_p] * 9 + _INTS + [ctypes.c_void_p],
    "wkv_chunked_f32_v1": [ctypes.c_void_p] * 6 + _INTS + [ctypes.c_void_p],
    "wkv_chunked_backward_f32": [ctypes.c_void_p] * 12 + _INTS
    + [ctypes.c_void_p],
}
# the launcher's code for a block above the device's shared memory
# (csrc's WKV_SMEM_TOO_LARGE)
_SMEM_TOO_LARGE = -1
# the backward kernel's largest head size (csrc's BWD_MAX_HD) and the steps
# between two of its state checkpoints, which the kernel takes as seg_len
BACKWARD_MAX_HD = 64
BACKWARD_SEGMENT = 16


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


def _launch(entry: str, counter, r: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, log_decay: torch.Tensor, u: torch.Tensor,
            chunk: int) -> torch.Tensor:
    """Check the operands and launch the C entry point ``entry`` on CUDA
    tensors, adding one to ``counter.launches`` when given. The
    chunk-parallel kernels (``counter`` given) get their scratch here."""
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
        args = [r.data_ptr(), k.data_ptr(), v.data_ptr(),
                log_decay.data_ptr(), u.data_ptr(), out.data_ptr()]
        if entry == "wkv_chunked_f32":
            scratch = _scratch(bh, s, hd, chunk, r.device)
            args += [t.data_ptr() for t in scratch]
        code = getattr(lib, entry)(
            *args, bh, s, hd, chunk, torch.cuda.current_stream().cuda_stream)
    if code == _SMEM_TOO_LARGE:
        raise ValueError(f"wkv_chunked: one block of hd={hd}, chunk={chunk} "
                         f"needs more shared memory than this card gives a "
                         f"block")
    _build.check_launch("wkv_chunked", code)
    if counter is not None and bh and s:
        counter.launches += 1
    return out


def _scratch(bh: int, s: int, hd: int, chunk: int, device):
    """The chunk-parallel kernels' scratch, at P = hd rounded up to 4 and
    nch = ceil(S / chunk) chunks a row: r e^{l_exc} (BH, S, P), the
    chunks' deltas, then their entering states (BH, nch, P, P), and
    l_tot (BH, nch, P)."""
    p = -(-hd // 4) * 4
    nch = -(-s // chunk)
    return (torch.empty((bh, s, p), dtype=torch.float32, device=device),
            torch.empty((bh, nch, p, p), dtype=torch.float32, device=device),
            torch.empty((bh, nch, p), dtype=torch.float32, device=device))


def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_decay: torch.Tensor, u: torch.Tensor, *,
                chunk: int = 64) -> torch.Tensor:
    """Chunked WKV over ``(BH, S, hd)`` fp32 inputs and ``(BH, hd)`` bonus
    ``u`` → ``(BH, S, hd)`` fp32 — the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. Forward only."""
    if _build.on_cpu("wkv_chunked", r, k, v, log_decay, u):
        return wkv_chunked_plain(r, k, v, log_decay, u, chunk=chunk)
    return _launch("wkv_chunked_f32", wkv_chunked, r, k, v, log_decay, u,
                   chunk)


wkv_chunked.launches = 0


def wkv_chunked_v1(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   log_decay: torch.Tensor, u: torch.Tensor, *,
                   chunk: int = 64) -> torch.Tensor:
    """The first port's kernel (one block per row) on CUDA tensors, kept as
    the bitwise yardstick of :func:`wkv_chunked`: both compute every output
    by the same fp32 chain. Not on any path of the port; it counts no
    launches. It refuses hd = 128, chunk = 64 (its whole (hd, hd) state
    does not fit a block's shared memory), which :func:`wkv_chunked`
    takes."""
    if _build.on_cpu("wkv_chunked", r, k, v, log_decay, u):
        raise ValueError("wkv_chunked_v1: CUDA tensors only (the plain "
                         "version is wkv_chunked_plain)")
    return _launch("wkv_chunked_f32_v1", None, r, k, v, log_decay, u, chunk)


def wkv_chunked_backward_plain(r: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, log_decay: torch.Tensor,
                               u: torch.Tensor, g: torch.Tensor):
    """Plain PyTorch version of the gradient: autograd through the
    sequential recurrence ``ref.wkv_chunk_ref``, the reference's
    ``_wkv_bwd`` pairing. ``(BH, S, hd)`` ``r, k, v, log_decay``, ``(BH,
    hd)`` ``u`` and the output cotangent ``g`` → ``(dr, dk, dv,
    dlog_decay, du)``, in fp32, or in fp64 for fp64 inputs."""
    from repro_torch.kernels.ref import wkv_chunk_ref
    with torch.enable_grad():
        xs = [t.detach().requires_grad_() for t in (r, k, v, log_decay, u)]
        out = wkv_chunk_ref(*xs)
        if out.numel() == 0:
            return tuple(torch.zeros_like(t) for t in xs)
        return torch.autograd.grad(out, xs, g.to(out.dtype))


def wkv_chunked_backward(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         log_decay: torch.Tensor, u: torch.Tensor,
                         g: torch.Tensor):
    """The gradient of the WKV recurrence for the output cotangent ``g``:
    ``(BH, S, hd)`` fp32 ``r, k, v, log_decay, g`` and ``(BH, hd)`` ``u``
    → ``(dr, dk, dv, dlog_decay, du)`` — the CUDA kernel for CUDA tensors
    (hd up to :data:`BACKWARD_MAX_HD`; deterministic, no float atomics),
    the plain version for CPU tensors. Any BH and S."""
    if _build.on_cpu("wkv_chunked_backward", r, k, v, log_decay, u, g):
        return wkv_chunked_backward_plain(r, k, v, log_decay, u, g)
    if r.dim() != 3:
        raise ValueError("wkv_chunked_backward: r, k, v, log_decay and g "
                         "must be (BH, S, hd)")
    bh, s, hd = r.shape
    f32 = torch.float32
    for name, t in (("r", r), ("k", k), ("v", v), ("log_decay", log_decay),
                    ("g", g)):
        _build.require("wkv_chunked_backward", name, t, f32, (bh, s, hd))
    _build.require("wkv_chunked_backward", "u", u, f32, (bh, hd))
    if not 1 <= hd <= BACKWARD_MAX_HD:
        raise ValueError(f"wkv_chunked_backward: hd={hd} is outside 1 .. "
                         f"{BACKWARD_MAX_HD}: a block holds the whole "
                         f"(hd, hd) state")
    grads = [torch.empty_like(t) for t in (r, k, v, log_decay, u)]
    if bh == 0 or s == 0:
        return tuple(t.zero_() for t in grads)
    lib = _library()
    p = -(-hd // 4) * 4
    nseg = -(-s // BACKWARD_SEGMENT)
    with torch.cuda.device(r.device):
        ckpt = torch.empty((bh, nseg, p, p), dtype=f32, device=r.device)
        code = lib.wkv_chunked_backward_f32(
            *(t.data_ptr() for t in (r, k, v, log_decay, u, g, *grads,
                                     ckpt)),
            bh, s, hd, BACKWARD_SEGMENT,
            torch.cuda.current_stream().cuda_stream)
    if code == _SMEM_TOO_LARGE:
        raise ValueError(f"wkv_chunked_backward: one block of hd={hd}, "
                         f"{BACKWARD_SEGMENT} steps a segment needs more "
                         f"shared memory than this card gives a block")
    _build.check_launch("wkv_chunked_backward", code)
    wkv_chunked_backward.launches += 1
    return tuple(grads)


wkv_chunked_backward.launches = 0
