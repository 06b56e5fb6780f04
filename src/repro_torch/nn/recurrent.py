"""RWKV-6 "Finch" time mixing (port of the RWKV half of
``repro/nn/recurrent.py``): token shift, the data-dependent decay and the
WKV recurrence.

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
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.kernels.wkv_chunk import wkv_chunked_plain
from repro_torch.nn.layers import (
    Shape, dense_init, full, normal, rmsnorm, rmsnorm_params,
)

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
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


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
    log_decay = -torch.exp(
        p["decay_w0"].float()
        + torch.tanh(wx.float() @ p["decay_A"].float())
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
    b, s, d = x.shape
    h = d // head_dim
    r, k, v, g, logw = _rwkv_mix_logw(p, x, token_shift(x))

    def flat(t):
        return t.reshape(b, s, h, head_dim).transpose(1, 2) \
            .reshape(b * h, s, head_dim).float()

    u = p["bonus_u"].float()[None].expand(b, h, head_dim) \
        .reshape(b * h, head_dim)
    out = wkv(flat(r), flat(k), flat(v), flat(logw), u)
    out = out.reshape(b, h, s, head_dim).transpose(1, 2).reshape(b, s, d)
    out = rmsnorm(p["ln_x"], out.to(x.dtype))
    out = out * F.silu(g)
    return out @ p["w_o"]


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
    b, _, d = x.shape
    h = d // head_dim
    x_t = x[:, 0]
    r, k, v, g, decay = _rwkv_mix(p, x_t, state["x_prev"])

    def heads(t):
        return t.reshape(b, h, head_dim).float()
    r_, k_, v_, w_ = heads(r), heads(k), heads(v), heads(decay)
    u = p["bonus_u"].float()
    kv = k_[..., :, None] * v_[..., None, :]
    out = torch.einsum("bhk,bhkv->bhv", r_,
                       state["wkv"] + u[None, :, :, None] * kv)
    new_wkv = w_[..., :, None] * state["wkv"] + kv
    out = out.reshape(b, d).to(x.dtype)
    out = rmsnorm(p["ln_x"], out)
    out = out * F.silu(g)
    return (out @ p["w_o"])[:, None, :], {"wkv": new_wkv, "x_prev": x_t}


def rwkv_init_state(b: int, d: int, head_dim: int, *, lead: Shape = (),
                    device="cpu", dtype=torch.float32) -> State:
    """Zero state, stacked ``lead`` deep: the fp32 WKV state and the
    token-shift row in ``dtype`` (the reference's ``rwkv_init_state``)."""
    h = d // head_dim
    return {"wkv": torch.zeros(lead + (b, h, head_dim, head_dim),
                               device=device),
            "x_prev": torch.zeros(lead + (b, d), device=device,
                                  dtype=dtype)}
