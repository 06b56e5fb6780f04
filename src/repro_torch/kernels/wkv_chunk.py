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

:func:`wkv_chunked_backward` is the gradient: the VJP of the recurrence,
as the reference pairs its kernel with ``jax.vjp`` of
``ref.wkv_chunk_ref``. For CUDA tensors (hd up to 64) it launches
``wkv_chunked_backward_f32``, which differentiates the chunked form with
the chunks in parallel, from the forward's states when
:func:`wkv_chunked_states` kept them; its plain form is
:func:`wkv_chunked_backward_chunked_plain`. For CPU tensors it runs
:func:`wkv_chunked_backward_plain`, autograd through
``ref.wkv_chunk_ref``. :func:`wkv_chunked_backward_v1` launches the first
backward kernel (a block per row), kept as the yardstick of the
chunk-parallel one.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_INTS = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
_SIGNATURES = {
    "wkv_chunked_f32": [ctypes.c_void_p] * 9 + _INTS + [ctypes.c_void_p],
    "wkv_chunked_f32_v1": [ctypes.c_void_p] * 6 + _INTS + [ctypes.c_void_p],
    "wkv_chunked_backward_f32": [ctypes.c_void_p] * 16 + _INTS
    + [ctypes.c_void_p],
    "wkv_chunked_backward_f32_v1": [ctypes.c_void_p] * 12 + _INTS
    + [ctypes.c_void_p],
}
# the launcher's code for a block above the device's shared memory
# (csrc's WKV_SMEM_TOO_LARGE)
_SMEM_TOO_LARGE = -1
# the backward kernels' largest head size (csrc's BWD_MAX_HD), the
# chunk-parallel backward's largest chunk (BWD_MAX_CHUNK), and the steps
# between two state checkpoints of the first backward kernel, which it
# takes as seg_len
BACKWARD_MAX_HD = 64
BACKWARD_MAX_CHUNK = 64
BACKWARD_SEGMENT = 16


def _library():
    return _build.load("wkv_chunk", _SIGNATURES)


def wkv_chunked_ops(bh: int, s: int, hd: int, chunk: int) -> int:
    """Operations the chunked WKV needs: per chunk of n steps the two
    products over the strict lower triangle, r_t k_t^T and scores v,
    n (n - 1) hd each, and the two with the state, r_t S and k_out^T v,
    2 n hd^2 each."""
    lengths = [min(chunk, s - lo) for lo in range(0, s, chunk)]
    return bh * sum(2 * n * (n - 1) * hd + 4 * n * hd * hd for n in lengths)


def wkv_chunked_bytes(bh: int, s: int, hd: int) -> int:
    """Bytes the forward must move: r, k, v, log_decay and u read, the
    output written, fp32."""
    return 4 * (5 * bh * s * hd + bh * hd)


def wkv_chunked_backward_ops(bh: int, s: int, hd: int) -> float:
    """Operations the WKV gradient needs from its inputs alone, in the
    chunked form at the chunk length K that needs the fewest. Per chunk of
    K steps and row: the chunk's state k^T v, G's r~^T g, and the cross
    terms g S_in^T (dr), v G'^T (dk) and k~ G' (dv), 2 K hd^2 each; the
    decay of the state and of G once a chunk, hd^2 each; inside the chunk
    the five strict-lower products A = r~ k~^T, A^T g, dA = g v^T, dA k~
    and dA^T r~, K (K - 1) hd each. A step so costs 10 hd^2 + 2 hd^2 / K +
    5 (K - 1) hd, least near K = sqrt(2 hd / 5) (K = 1 is the sequential
    recurrence's 12 hd^2). dlw needs no contraction of its own: with L_t
    the cumulative log-decay, the loss sees L_t only through r_{t+1}
    e^{L_t} and k_t e^{-L_t}, so dlw_m is the reverse cumulative sum over
    t >= m of r_{t+1} dr'_{t+1} - k_t dk'_t (dr', dk' without their bonus
    terms), O(hd) a step."""
    per_step = min(10 * hd * hd + 2 * hd * hd / kk + 5 * (kk - 1) * hd
                   for kk in range(1, max(hd, 1) + 1))
    return bh * s * per_step


def wkv_chunked_backward_bytes(bh: int, s: int, hd: int) -> int:
    """Bytes the gradient must move: r, k, v, log_decay, g and u read,
    the five gradients written, fp32."""
    return 4 * (9 * bh * s * hd + 2 * bh * hd)


def _abstract_forward(r, k, v, log_decay, u, chunk: int, keep: bool):
    """The abstract branch of the forward (the dry run): the output and,
    with ``keep``, the scratch, as empty tensors."""
    def make(r, k, v, log_decay, u):
        bh, s, hd = r.shape
        out = torch.empty((bh, s, hd), dtype=torch.float32, device=r.device)
        return (out, *_scratch(bh, s, hd, chunk, r.device)) if keep else out
    from repro_torch.sharding.step_analysis import local_kernel_call
    out = local_kernel_call(
        "wkv_chunked", make, (r, k, v, log_decay, u),
        lambda r, *_: wkv_chunked_ops(*r.shape, chunk),
        lambda r, *_: wkv_chunked_bytes(*r.shape))
    return (out[0], tuple(out[1:])) if keep else out


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
            chunk: int, keep: bool = False):
    """Check the operands and launch the C entry point ``entry`` on CUDA
    tensors, adding one to ``counter.launches`` when given. The
    chunk-parallel kernels (``counter`` given) get their scratch here;
    with ``keep`` it is returned beside the output."""
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
    return (out, scratch) if keep else out


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
    plain version for CPU tensors, the abstract branch for fake ones.
    Forward only."""
    if _build.is_abstract(r, k, v, log_decay, u):
        return _abstract_forward(r, k, v, log_decay, u, chunk, keep=False)
    if _build.on_cpu("wkv_chunked", r, k, v, log_decay, u):
        return wkv_chunked_plain(r, k, v, log_decay, u, chunk=chunk)
    return _launch("wkv_chunked_f32", wkv_chunked, r, k, v, log_decay, u,
                   chunk)


wkv_chunked.launches = 0


def wkv_chunked_states(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       log_decay: torch.Tensor, u: torch.Tensor, *,
                       chunk: int = 64):
    """:func:`wkv_chunked` keeping what its kernel forms for the backward:
    ``(out, states)`` with ``states`` its scratch ``(r e^{l_exc} (BH, S,
    P), the chunks' entering states (BH, nch, P, P), l_tot (BH, nch, P))``
    on CUDA tensors (one ``wkv_chunked`` launch; ``out`` bitwise
    :func:`wkv_chunked`'s), ``None`` with the plain output on CPU
    tensors, the abstract branch's empty ones for fake tensors.
    :func:`wkv_chunked_backward` takes ``states`` in place of forming them
    again."""
    if _build.is_abstract(r, k, v, log_decay, u):
        return _abstract_forward(r, k, v, log_decay, u, chunk, keep=True)
    if _build.on_cpu("wkv_chunked", r, k, v, log_decay, u):
        return wkv_chunked_plain(r, k, v, log_decay, u, chunk=chunk), None
    return _launch("wkv_chunked_f32", wkv_chunked, r, k, v, log_decay, u,
                   chunk, keep=True)


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
        # a row of one step never uses its decay: its gradient is zero
        grads = torch.autograd.grad(out, xs, g.to(out.dtype),
                                    allow_unused=True)
        return tuple(torch.zeros_like(x) if d is None else d
                     for x, d in zip(xs, grads))


def _rev_cumsum(x: torch.Tensor) -> torch.Tensor:
    """``out[:, t] = Σ_{s ≥ t} x[:, s]`` along dim 1."""
    return torch.flip(torch.cumsum(torch.flip(x, [1]), 1), [1])


def wkv_chunked_backward_chunked_plain(r: torch.Tensor, k: torch.Tensor,
                                       v: torch.Tensor,
                                       log_decay: torch.Tensor,
                                       u: torch.Tensor, g: torch.Tensor, *,
                                       chunk: int = 64,
                                       magnitudes: bool = False):
    """Plain PyTorch version of the gradient in the chunked form the CUDA
    kernel computes, one batched chunk after another (as
    :func:`wkv_chunked_plain` is for the forward): ``(dr, dk, dv,
    dlog_decay, du)`` in the inputs' type (fp32 at least).

    Per chunk, with the forward's ``r̃ = r e^{l_exc}``, ``k̃ = k
    e^{-l_inc}``, ``A = strict_lower(r̃ k̃ᵀ)``, its entering state
    ``S_in``, the gradient ``G_out`` of its leaving state ``S_out``
    (zero for the last chunk), ``G' = e^{l_tot} ⊙ G_out`` and ``dA =
    strict_lower(g vᵀ)``::

        dv  = Aᵀ g + (Σ r u k) g + k̃ G'
        dr' = e^{l_exc} ⊙ (dA k̃ + g S_inᵀ),    dr = dr' + u k (g·v)
        dk' = e^{-l_inc} ⊙ (dAᵀ r̃ + v G'ᵀ),    dk = dk' + u r (g·v)
        G_in = G' + r̃ᵀ g                       (the previous chunk's G_out)
        dlw_t = Z + Σ_{s>t} r_s dr'_s − Σ_{s≥t} k_s dk'_s  (s in the chunk)
        du  = Σ_t r_t k_t (g_t·v_t)

    with ``Z = Σ_j G_out[:, j] S_out[:, j]``, the sum over all later
    steps of ``r_{s} dr'_{s} − k_s dk'_s`` taken at the chunk's end.
    ``k̃ G'`` is ``(k e^{l_tot - l_inc}) G_out`` and ``e^{-l_inc} v G'ᵀ``
    is ``e^{l_tot - l_inc} v G_outᵀ`` regrouped.

    With ``magnitudes=True`` every output is instead its sum of |terms|
    along that chain: the same formulas on ``|r|, |k|, |v|, |u|, |g|``
    (every decay factor is already positive), with dlw's ``k dk'`` added
    rather than taken away. It bounds the rounding error of a chain that
    evaluates the formulas in another order or precision."""
    dt = torch.promote_types(r.dtype, torch.float32)
    r, k, v, lw, u, g = (t.to(dt) for t in (r, k, v, log_decay, u, g))
    if magnitudes:
        r, k, v, u, g = (t.abs() for t in (r, k, v, u, g))
    bh, s, hd = r.shape
    state = torch.zeros((bh, hd, hd), dtype=dt, device=r.device)
    chunks, states = [], []
    for lo in range(0, s, chunk):
        hi = min(s, lo + chunk)
        lc = lw[:, lo:hi]
        l_exc = torch.cumsum(lc, dim=1) - lc
        l_inc = l_exc + lc
        l_tot = l_inc[:, -1]                         # (BH, hd)
        e_exc, e_inc = torch.exp(l_exc), torch.exp(-l_inc)
        chunks.append((lo, hi, e_exc, e_inc, torch.exp(l_tot)))
        states.append(state)
        k_out = k[:, lo:hi] * torch.exp(l_tot[:, None] - l_inc)
        state = torch.exp(l_tot)[..., None] * state + \
            k_out.transpose(1, 2) @ v[:, lo:hi]
    states.append(state)
    grads = [torch.zeros_like(t) for t in (r, k, v, lw)]
    dus = []
    gs = torch.zeros((bh, hd, hd), dtype=dt, device=r.device)   # G_out
    sign = 1.0 if magnitudes else -1.0
    for c in range(len(chunks) - 1, -1, -1):
        lo, hi, e_exc, e_inc, e_tot = chunks[c]
        rc, kc, vc, gc = (t[:, lo:hi] for t in (r, k, v, g))
        rt, kt = rc * e_exc, kc * e_inc
        a = torch.tril(rt @ kt.transpose(1, 2), diagonal=-1)
        da = torch.tril(gc @ vc.transpose(1, 2), diagonal=-1)
        gp = e_tot[..., None] * gs                   # G'
        bonus = torch.sum(rc * u[:, None] * kc, dim=-1, keepdim=True)
        gv = torch.sum(gc * vc, dim=-1, keepdim=True)
        grads[2][:, lo:hi] = (a.transpose(1, 2) @ gc + bonus * gc) + kt @ gp
        dr_ = e_exc * (da @ kt + gc @ states[c].transpose(1, 2))
        dk_ = e_inc * (da.transpose(1, 2) @ rt + vc @ gp.transpose(1, 2))
        grads[0][:, lo:hi] = dr_ + u[:, None] * kc * gv
        grads[1][:, lo:hi] = dk_ + u[:, None] * rc * gv
        dus.append(torch.sum(rc * kc * gv, dim=1))
        z = torch.sum(gs * states[c + 1], dim=-1)    # (BH, hd)
        x, y = rc * dr_, kc * dk_
        after = torch.cat([_rev_cumsum(x)[:, 1:], torch.zeros_like(x[:, :1])],
                          dim=1)
        grads[3][:, lo:hi] = z[:, None] + after + sign * _rev_cumsum(y)
        gs = gp + rt.transpose(1, 2) @ gc
    du = torch.zeros_like(u)
    for part in reversed(dus):                       # in chunk order
        du = du + part
    return (*grads, du)


def _backward_operands(r, k, v, log_decay, u, g):
    """Check the backward's operands; returns (BH, S, hd)."""
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
                         f"{BACKWARD_MAX_HD}: a block's products tile the "
                         f"(hd, hd) state in 16 x 16 tiles of 4 x 4")
    return bh, s, hd


def wkv_chunked_backward(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         log_decay: torch.Tensor, u: torch.Tensor,
                         g: torch.Tensor, *, chunk: int = 64, states=None):
    """The gradient of the WKV recurrence for the output cotangent ``g``:
    ``(BH, S, hd)`` fp32 ``r, k, v, log_decay, g`` and ``(BH, hd)`` ``u``
    → ``(dr, dk, dv, dlog_decay, du)`` — the CUDA kernel for CUDA tensors,
    the plain version (:func:`wkv_chunked_backward_plain`) for CPU
    tensors. Any BH and S.

    On the card it differentiates the chunked form in chunks of ``chunk``
    steps (1 .. :data:`BACKWARD_MAX_CHUNK`; hd up to
    :data:`BACKWARD_MAX_HD`; deterministic, no float atomics), the chunks
    in parallel (:func:`wkv_chunked_backward_chunked_plain` is its plain
    form). ``states``: the forward's scratch from
    :func:`wkv_chunked_states` of the same inputs and ``chunk``; without
    it the call runs the forward's kernel first for them, a launch it does
    not count. CPU tensors ignore ``chunk`` and ``states``; fake ones
    take the abstract branch, which counts the gradient's own operations
    (as the launch count, it leaves out a forward run for the states)."""
    if _build.is_abstract(r, k, v, log_decay, u, g):
        from repro_torch.sharding.step_analysis import local_kernel_call
        return local_kernel_call(
            "wkv_chunked_backward",
            lambda *xs: tuple(torch.empty_like(t) for t in xs[:5]),
            (r, k, v, log_decay, u, g),
            lambda r, *_: wkv_chunked_backward_ops(*r.shape),
            lambda r, *_: wkv_chunked_backward_bytes(*r.shape))
    if _build.on_cpu("wkv_chunked_backward", r, k, v, log_decay, u, g):
        return wkv_chunked_backward_plain(r, k, v, log_decay, u, g)
    bh, s, hd = _backward_operands(r, k, v, log_decay, u, g)
    if not 1 <= chunk <= BACKWARD_MAX_CHUNK:
        raise ValueError(f"wkv_chunked_backward: chunk={chunk} is outside "
                         f"1 .. {BACKWARD_MAX_CHUNK}")
    grads = [torch.empty_like(t) for t in (r, k, v, log_decay, u)]
    if bh == 0 or s == 0:
        return tuple(t.zero_() for t in grads)
    p = -(-hd // 4) * 4
    nch = -(-s // chunk)
    f32 = torch.float32
    if states is None:
        _, states = _launch("wkv_chunked_f32", None, r, k, v, log_decay, u,
                            chunk, keep=True)
    else:
        for name, t, shape in zip(
                ("r e^{l_exc}", "states", "l_tot"), states,
                ((bh, s, p), (bh, nch, p, p), (bh, nch, p))):
            _build.require("wkv_chunked_backward", name, t, f32, shape)
            if t.device != r.device:
                raise ValueError(f"wkv_chunked_backward: {name} lies on "
                                 f"{t.device}, the inputs on {r.device}")
    lib = _library()
    with torch.cuda.device(r.device):
        gbuf = torch.empty((bh, nch, p, p), dtype=f32, device=r.device)
        dpart = torch.empty((bh, nch, p), dtype=f32, device=r.device)
        code = lib.wkv_chunked_backward_f32(
            *(t.data_ptr() for t in (r, k, v, log_decay, u, g, *grads,
                                     *states, gbuf, dpart)),
            bh, s, hd, chunk, torch.cuda.current_stream().cuda_stream)
    if code == _SMEM_TOO_LARGE:
        raise ValueError(f"wkv_chunked_backward: one block of hd={hd}, "
                         f"chunk={chunk} needs more shared memory than this "
                         f"card gives a block")
    _build.check_launch("wkv_chunked_backward", code)
    wkv_chunked_backward.launches += 1
    return tuple(grads)


wkv_chunked_backward.launches = 0


def wkv_chunked_backward_v1(r: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, log_decay: torch.Tensor,
                            u: torch.Tensor, g: torch.Tensor):
    """The first backward kernel (a block per row walking its steps back
    from state checkpoints every :data:`BACKWARD_SEGMENT` steps) on CUDA
    tensors, kept as the yardstick of :func:`wkv_chunked_backward`: the
    chip smoke run times the two together and holds each to its bound of
    the fp64 plain gradient. Not on any path of the port; it counts no
    launches."""
    if _build.on_cpu("wkv_chunked_backward", r, k, v, log_decay, u, g):
        raise ValueError("wkv_chunked_backward_v1: CUDA tensors only (the "
                         "plain version is wkv_chunked_backward_plain)")
    bh, s, hd = _backward_operands(r, k, v, log_decay, u, g)
    grads = [torch.empty_like(t) for t in (r, k, v, log_decay, u)]
    if bh == 0 or s == 0:
        return tuple(t.zero_() for t in grads)
    lib = _library()
    p = -(-hd // 4) * 4
    nseg = -(-s // BACKWARD_SEGMENT)
    with torch.cuda.device(r.device):
        ckpt = torch.empty((bh, nseg, p, p), dtype=torch.float32,
                           device=r.device)
        code = lib.wkv_chunked_backward_f32_v1(
            *(t.data_ptr() for t in (r, k, v, log_decay, u, g, *grads,
                                     ckpt)),
            bh, s, hd, BACKWARD_SEGMENT,
            torch.cuda.current_stream().cuda_stream)
    if code == _SMEM_TOO_LARGE:
        raise ValueError(f"wkv_chunked_backward_v1: one block of hd={hd}, "
                         f"{BACKWARD_SEGMENT} steps a segment needs more "
                         f"shared memory than this card gives a block")
    _build.check_launch("wkv_chunked_backward_v1", code)
    return tuple(grads)
