"""The recurrent layers of the LM substrate (port of
``repro/nn/recurrent.py``): RWKV-6 "Finch" time mixing (token shift, the
data-dependent decay and the WKV recurrence), and the RG-LRU of
RecurrentGemma / Griffin (:func:`rglru_apply`, :func:`rglru_decode`).

Three forms of the full-sequence time mix, one semantics, each the others'
plain version; they differ only in how the WKV core runs over the
``(B·H, S, hd)`` heads:

* :func:`rwkv_apply` — the sequential recurrence, one token at a time
  (``kernels.ref.wkv_chunk_ref``);
* :func:`rwkv_apply_chunked` — the chunked form in plain PyTorch
  (``kernels.wkv_chunk.wkv_chunked_plain``), for S a multiple of the chunk;
* :func:`rwkv_apply_kernel` — the chunked form through
  ``kernels.ops.wkv_chunked_op``: the CUDA kernel on the card.

Decoding is the single-step recurrence with explicit state
(:func:`rwkv_decode`). As in the reference, ``ln_x`` is an RMSNorm over all
of d and the token-shift interpolation is the "lite" ddlerp (static ``mu``).

The RG-LRU has no kernel: its scan is a loop over the sequence in plain
PyTorch, fp32, as the reference's ``lax.scan``.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.kernels.wkv_chunk import wkv_chunked_plain
from repro_torch.nn.layers import (
    Shape, dense_init, full, gelu_tanh, normal, rmsnorm, rmsnorm_params,
)
from repro_torch.sharding.context import head_parallel, shard_activation

State = Dict[str, torch.Tensor]


def rwkv_params(generator, d: int, head_dim: int, *, lora_rank: int = 64,
                lead: Shape = (), device="cpu",
                dtype=torch.float32) -> Dict:
    """The time-mix parameters, stacked ``lead`` deep: token-shift ``mu_*``
    = 0.5, projections ``w_*`` (dense init), the decay
    ``w_t = exp(-exp(w0 + tanh(x A) B))`` with ``w0 = -6``, the bonus
    ``u = normal · 0.1`` per head and ``ln_x``."""
    h = d // head_dim

    def dense(d_in, d_out):
        return dense_init(generator, d_in, d_out, lead=lead, device=device,
                          dtype=dtype)

    p = {f"mu_{n}": full(lead + (d,), 0.5, device, dtype)
         for n in ("r", "k", "v", "w", "g")}
    p.update({f"w_{n}": dense(d, d) for n in ("r", "k", "v", "g")})
    p["decay_w0"] = full(lead + (d,), -6.0, device, dtype)
    p["decay_A"] = dense(d, lora_rank)
    p["decay_B"] = dense(lora_rank, d)
    p["bonus_u"] = (normal(generator, lead + (h, head_dim), device) * 0.1
                    ).to(dtype)
    p["w_o"] = dense(d, d)
    p["ln_x"] = rmsnorm_params(d, lead=lead, device=device, dtype=dtype)
    return p


def token_shift(x: torch.Tensor) -> torch.Tensor:
    """``(B, S, d)`` → the previous position's row, zeros at position 0."""
    return _pad_front(x, 1)[:, :-1]


def _pad_front(x: torch.Tensor, n: int) -> torch.Tensor:
    """``(B, S, w)`` → ``(B, n + S, w)``, ``n`` rows of zeros first: a
    concatenation, not ``F.pad``, whose sharding rule in torch 2.11 drops
    a ``DTensor``'s placements on a 3-D mesh (the dry run's two pods)."""
    return torch.cat([x.new_zeros((x.shape[0], n) + tuple(x.shape[2:])),
                      x], dim=1)


def _rwkv_mix_logw(p: Dict, x: torch.Tensor, x_prev: torch.Tensor
                   ) -> Tuple[torch.Tensor, ...]:
    """``(r, k, v, g, log_decay)`` from the token-shift interpolations."""
    def mix(mu):
        return x + (x_prev - x) * mu
    r = mix(p["mu_r"]) @ p["w_r"]
    k = mix(p["mu_k"]) @ p["w_k"]
    v = mix(p["mu_v"]) @ p["w_v"]
    g = mix(p["mu_g"]) @ p["w_g"]
    wx = mix(p["mu_w"])
    # the LoRA's hidden pinned as the activations are (on a mesh: its
    # partial sums reduced there, not where DTensor's search puts them)
    log_decay = -torch.exp(
        p["decay_w0"].float()
        + torch.tanh(shard_activation(wx.float() @ p["decay_A"].float()))
        @ p["decay_B"].float())
    return r, k, v, g, log_decay


def _rwkv_mix(p: Dict, x: torch.Tensor, x_prev: torch.Tensor
              ) -> Tuple[torch.Tensor, ...]:
    """``(r, k, v, g, decay)`` with ``decay = exp(log_decay)``."""
    r, k, v, g, logw = _rwkv_mix_logw(p, x, x_prev)
    return r, k, v, g, torch.exp(logw)


WKV = Callable[..., torch.Tensor]


def _time_mix(p: Dict, x: torch.Tensor, head_dim: int,
              wkv: WKV) -> torch.Tensor:
    """The full-sequence time mix ``(B, S, d)`` → ``(B, S, d)`` with the
    WKV core ``wkv(r, k, v, log_decay, u)`` over ``(B·H, S, hd)`` heads
    (``u`` broadcast over the batch)."""
    r, k, v, g, logw = _rwkv_mix_logw(p, x, token_shift(x))
    out = head_parallel(functools.partial(_wkv_heads, wkv=wkv),
                        (r, k, v, logw, p["bonus_u"]),
                        ("b.h", "b.h", "b.h", "b.h", "h."), "b.h",
                        heads=x.shape[-1] // head_dim)
    out = rmsnorm(p["ln_x"], out.to(x.dtype))
    out = out * F.silu(g)
    return out @ p["w_o"]


def _wkv_heads(r, k, v, logw, u, *, wkv: WKV) -> torch.Tensor:
    """The WKV core over the ``(B·H, S, hd)`` heads of ``(B, S, H·hd)``
    inputs (``u`` ``(H, hd)``), back to ``(B, S, H·hd)`` fp32: the time
    mix's region per (batch row, head), run by ``head_parallel`` on each
    device's own rows and heads."""
    b, s, d = r.shape
    h, head_dim = u.shape

    def flat(t):
        return t.reshape(b, s, h, head_dim).transpose(1, 2) \
            .reshape(b * h, s, head_dim).float()

    u = u.float()[None].expand(b, h, head_dim).reshape(b * h, head_dim)
    out = wkv(flat(r), flat(k), flat(v), flat(logw), u)
    return out.reshape(b, h, s, head_dim).transpose(1, 2).reshape(b, s, d)


def rwkv_apply(p: Dict, x: torch.Tensor, head_dim: int) -> torch.Tensor:
    """The time mix with the sequential WKV recurrence, per head (state
    ``S``: ``(hd_k, hd_v)``)::

        out_t = r_t · (S_{t-1} + diag(u) k_t^T v_t)
        S_t   = diag(w_t) S_{t-1} + k_t^T v_t
    """
    return _time_mix(p, x, head_dim, ref.wkv_chunk_ref)


def rwkv_apply_chunked(p: Dict, x: torch.Tensor, head_dim: int,
                       chunk: int = 64) -> torch.Tensor:
    """The time mix with the chunked WKV in plain PyTorch; S must be a
    multiple of ``chunk``, as in the reference."""
    if x.shape[1] % chunk:
        raise ValueError(f"S={x.shape[1]} is not a multiple of "
                         f"chunk={chunk}")
    return _time_mix(p, x, head_dim,
                     functools.partial(wkv_chunked_plain, chunk=chunk))


def rwkv_apply_kernel(p: Dict, x: torch.Tensor, head_dim: int,
                      chunk: int = 64) -> torch.Tensor:
    """The time mix with the chunked WKV through ``ops.wkv_chunked_op``
    (the CUDA kernel for CUDA tensors; any S)."""
    return _time_mix(p, x, head_dim,
                     functools.partial(ops.wkv_chunked_op, chunk=chunk))


def rwkv_decode(p: Dict, x: torch.Tensor, state: State, head_dim: int
                ) -> Tuple[torch.Tensor, State]:
    """Single-token step. ``state = {"wkv": (B, H, hd, hd), "x_prev":
    (B, d)}``; ``x`` is ``(B, 1, d)``. Returns ``(out (B, 1, d), new
    state)``."""
    x_t = x[:, 0]
    r, k, v, g, decay = _rwkv_mix(p, x_t, state["x_prev"])
    out, new_wkv = head_parallel(
        _wkv_step, (r, k, v, decay, p["bonus_u"], state["wkv"]),
        ("bh", "bh", "bh", "bh", "h.", "bh.."), ("bh", "bh.."),
        heads=x.shape[-1] // head_dim)
    out = rmsnorm(p["ln_x"], out.to(x.dtype))
    out = out * F.silu(g)
    return (out @ p["w_o"])[:, None, :], {"wkv": new_wkv, "x_prev": x_t}


def _wkv_step(r, k, v, decay, u, wkv):
    """One WKV step of ``(B, H·hd)`` inputs and the ``(B, H, hd, hd)``
    state: ``(out (B, H·hd) fp32, new state)``, per (batch row, head)."""
    b, h, head_dim = wkv.shape[0], u.shape[0], u.shape[1]

    def heads(t):
        return t.reshape(b, h, head_dim).float()
    r_, k_, v_, w_ = heads(r), heads(k), heads(v), heads(decay)
    u = u.float()
    kv = k_[..., :, None] * v_[..., None, :]
    out = torch.einsum("bhk,bhkv->bhv", r_, wkv + u[None, :, :, None] * kv)
    new_wkv = w_[..., :, None] * wkv + kv
    return out.reshape(b, h * head_dim), new_wkv


def rwkv_init_state(b: int, d: int, head_dim: int, *, lead: Shape = (),
                    device="cpu", dtype=torch.float32) -> State:
    """Zero state, stacked ``lead`` deep: the fp32 WKV state and the
    token-shift row in ``dtype`` (the reference's ``rwkv_init_state``)."""
    h = d // head_dim
    return {"wkv": torch.zeros(lead + (b, h, head_dim, head_dim),
                               device=device),
            "x_prev": torch.zeros(lead + (b, d), device=device,
                                  dtype=dtype)}


# ====================================================================== #
# RG-LRU (RecurrentGemma / Griffin)
# ====================================================================== #
def rglru_params(generator, d: int, lru_width: int, *, conv_width: int = 4,
                 lead: Shape = (), device="cpu", dtype=torch.float32) -> Dict:
    """The input branch ``w_x`` and gate branch ``w_y`` (d, w), the causal
    depthwise conv ``conv_w`` (cw, w) = normal · 0.1, the recurrence gates
    (w, w), ``log_lambda`` = linspace(0.5, 4, w) (``a = exp(-8
    softplus(Λ) sigmoid(rec_gate))``) and ``w_o`` (w, d), stacked ``lead``
    deep."""
    w = lru_width

    def dense(d_in, d_out):
        return dense_init(generator, d_in, d_out, lead=lead, device=device,
                          dtype=dtype)

    return {
        "w_x": dense(d, w),
        "w_y": dense(d, w),
        "conv_w": (normal(generator, lead + (conv_width, w), device) * 0.1
                   ).to(dtype),
        "w_input_gate": dense(w, w),
        "w_rec_gate": dense(w, w),
        "log_lambda": torch.linspace(0.5, 4.0, w, device=device).expand(
            lead + (w,)).to(dtype).clone(),
        "w_o": dense(w, d),
    }


_RG_C = 8.0


def _rglru_gates(p: Dict, xw: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-step decay ``a`` and input scale ``sqrt(1 - a²) · i_gate``
    of ``xw (..., w)``, fp32."""
    x32 = xw.float()
    i_gate = torch.sigmoid(x32 @ p["w_input_gate"].float())
    r_gate = torch.sigmoid(x32 @ p["w_rec_gate"].float())
    log_a = -_RG_C * F.softplus(p["log_lambda"].float()) * r_gate
    a = torch.exp(log_a)
    # the sqrt(1 - a^2) normalizer, computed stably from log a
    norm = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2 * log_a), 1e-12))
    return a, norm * i_gate


def lru_scan(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t h_{t-1} + v_t`` from ``h_{-1} = 0`` over the sequence
    axis 1 of ``(B, S, w)`` fp32 inputs, one step at a time; returns every
    ``h_t``, ``(B, S, w)`` fp32."""
    h = torch.zeros_like(v[:, 0])
    hs = []
    for t in range(v.shape[1]):
        h = a[:, t] * h + v[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)


def rglru_apply(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """The recurrent block over a whole sequence, ``(B, S, d)`` → ``(B, S,
    d)``: the causal conv (width cw) of ``x w_x``, the gated LRU scan in
    fp32 (:func:`lru_scan`), cast back to ``x``'s dtype, times the
    tanh-GELU gate ``gelu(x w_y)``, then ``@ w_o``."""
    s = x.shape[1]
    xw = x @ p["w_x"]                                     # (B, S, w)
    gate = gelu_tanh(x @ p["w_y"])
    cw = p["conv_w"].shape[0]
    pad = _pad_front(xw, cw - 1)
    conv = sum(pad[:, i:i + s] * p["conv_w"][i] for i in range(cw))
    a, scale = _rglru_gates(p, conv)                      # (B, S, w) each
    h = lru_scan(a, scale * conv.float()).to(x.dtype)
    return (h * gate) @ p["w_o"]


def rglru_decode(p: Dict, x: torch.Tensor, state: State
                 ) -> Tuple[torch.Tensor, State]:
    """Single-step RG-LRU: ``x (B, 1, d)``, ``state = {"h": (B, w) fp32,
    "conv": (B, cw - 1, w)}`` (the last cw - 1 conv inputs). Returns
    ``(out (B, 1, d), new state)``."""
    x_t = x[:, 0]
    xw = x_t @ p["w_x"]                                   # (B, w)
    gate = gelu_tanh(x_t @ p["w_y"])
    hist = torch.cat([state["conv"], xw[:, None, :]], dim=1)
    conv = torch.einsum("bcw,cw->bw", hist, p["conv_w"])
    a, scale = _rglru_gates(p, conv)
    h = a * state["h"] + scale * conv.float()
    out = (h.to(x.dtype) * gate) @ p["w_o"]
    return out[:, None, :], {"h": h, "conv": hist[:, 1:]}


def rglru_init_state(b: int, lru_width: int, conv_width: int = 4, *,
                     lead: Shape = (), device="cpu",
                     dtype=torch.float32) -> State:
    """Zero state, stacked ``lead`` deep: ``h`` fp32 and the conv history
    in ``dtype``."""
    return {"h": torch.zeros(lead + (b, lru_width), device=device),
            "conv": torch.zeros(lead + (b, conv_width - 1, lru_width),
                                device=device, dtype=dtype)}
