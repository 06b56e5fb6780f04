"""Building blocks of the LM substrate (port of ``repro/nn/layers.py``):
the initializers, RMSNorm and LayerNorm, rotary embeddings (RoPE and
Qwen2-VL's M-RoPE), the MLPs and the logit soft cap.

Compute follows the input's dtype; norm statistics and rotary angles are
fp32, as in the reference. Parameters are plain nested dicts of tensors. An
initializer draws from an explicit ``torch.Generator`` on ``device``; with
``lead`` it draws a stack of ``lead`` independent copies (the reference's
``vmap`` over a scanned layer group). On the ``meta`` device nothing is
drawn: only shapes exist.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Shape = Tuple[int, ...]


def normal(generator: Optional[torch.Generator], shape: Shape,
           device) -> torch.Tensor:
    """Standard normal fp32 draws of ``shape`` from ``generator`` (which
    must live on ``device``); shapes only on the ``meta`` device."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, device="meta")
    return torch.randn(shape, generator=generator, device=device)


def full(shape: Shape, value: float, device,
         dtype=torch.float32) -> torch.Tensor:
    return torch.full(shape, value, dtype=dtype, device=device)


def dense_init(generator, d_in: int, d_out: int, *, lead: Shape = (),
               device="cpu", dtype=torch.float32) -> torch.Tensor:
    """``normal · sqrt(2 / (d_in + d_out))`` of shape ``lead + (d_in,
    d_out)``."""
    scale = (2.0 / (d_in + d_out)) ** 0.5
    return (normal(generator, lead + (d_in, d_out), device) * scale
            ).to(dtype)


def embed_init(generator, vocab: int, d: int, *, device="cpu",
               dtype=torch.float32) -> torch.Tensor:
    """``normal · d^-1/2`` of shape ``(vocab, d)``."""
    return (normal(generator, (vocab, d), device) * d ** -0.5).to(dtype)


def rmsnorm_params(d: int, *, lead: Shape = (), device="cpu",
                   dtype=torch.float32) -> Dict[str, torch.Tensor]:
    return {"scale": full(lead + (d,), 1.0, device, dtype)}


def rmsnorm(p: Dict[str, torch.Tensor], x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """``x · rsqrt(mean(x²) + eps) · scale`` over the last axis, with the
    statistics in fp32."""
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * p["scale"].float()).to(x.dtype)


def layernorm_params(d: int, *, lead: Shape = (), device="cpu",
                     dtype=torch.float32) -> Dict[str, torch.Tensor]:
    return {"scale": full(lead + (d,), 1.0, device, dtype),
            "bias": full(lead + (d,), 0.0, device, dtype)}


def layernorm(p: Dict[str, torch.Tensor], x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """``(x - mean) · rsqrt(var + eps) · scale + bias`` over the last axis,
    with the statistics in fp32."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * p["scale"].float() + p["bias"].float()).to(x.dtype)


# ---------------------------------------------------------------------- #
# Rotary embeddings — standard RoPE and Qwen2-VL's M-RoPE
# ---------------------------------------------------------------------- #
def rope_frequencies(head_dim: int, base: float,
                     device=None) -> torch.Tensor:
    """``(head_dim/2,)`` fp32 inverse frequencies ``base^(-i / half)``."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (base ** exps)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """The half-split rotation of ``x`` (..., S, H, hd) by ``angles``
    (..., S, hd/2), in fp32, cast back to ``x``'s dtype."""
    angles = angles[..., None, :]                          # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               base: float = 10000.0) -> torch.Tensor:
    """``x``: ``(..., S, H, hd)``; ``positions``: integer, broadcastable to
    ``(..., S)``. Half-split convention (rotate_half), as Llama, GLM and
    Qwen use it."""
    inv = rope_frequencies(x.shape[-1], base, device=x.device)
    return _rotate(x, positions[..., None].float() * inv)


def m_rope_sections(half: int) -> Tuple[int, int, int]:
    """Qwen2-VL's default ``(t, h, w)`` split of the half rotary dim, in the
    ratio 1 : 1.5 : 1.5 (``(16, 24, 24)`` at hd = 128)."""
    t = half // 4
    h_sec = (half - t) // 2
    return t, h_sec, half - t - h_sec


def apply_m_rope(x: torch.Tensor, positions_3d: torch.Tensor,
                 base: float = 10000.0,
                 sections: Optional[Tuple[int, int, int]] = None
                 ) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: the rotary dim is split into (temporal,
    height, width) sections, each rotated by its own position stream.
    ``x``: ``(B, S, H, hd)``; ``positions_3d``: ``(B, S, 3)`` integer.
    ``sections`` are in half-dim units and must sum to hd/2 (default
    :func:`m_rope_sections`)."""
    half = x.shape[-1] // 2
    if sections is None:
        sections = m_rope_sections(half)
    if sum(sections) != half:
        raise ValueError(f"sections {sections} do not sum to {half}")
    inv = rope_frequencies(x.shape[-1], base, device=x.device)
    sec_id = torch.tensor([i for i, n in enumerate(sections)
                           for _ in range(n)], device=x.device)  # (half,)
    # per frequency index, the position stream of its section
    pos = positions_3d.float()[..., sec_id]                # (B, S, half)
    return _rotate(x, pos * inv)


# ---------------------------------------------------------------------- #
# MLPs
# ---------------------------------------------------------------------- #
def mlp_params(generator, d: int, d_ff: int, glu: bool, *,
               lead: Shape = (), device="cpu",
               dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """``w_in`` (d, d_ff), ``w_out`` (d_ff, d) and, for a gated unit,
    ``w_gate`` (d, d_ff), stacked ``lead`` deep."""
    def dense(d_in, d_out):
        return dense_init(generator, d_in, d_out, lead=lead, device=device,
                          dtype=dtype)
    p = {"w_out": dense(d_ff, d), "w_in": dense(d, d_ff)}
    if glu:
        p["w_gate"] = dense(d, d_ff)
    return p


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """The tanh form of GELU. ``jax.nn.gelu`` defaults to it
    (``approximate=True``), so the reference's "gelu" is this form too, not
    ``F.gelu``'s default erf form."""
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {"silu": F.silu, "gelu": gelu_tanh, "gelu_tanh": gelu_tanh}


def mlp_apply(p: Dict[str, torch.Tensor], x: torch.Tensor,
              act: str = "silu") -> torch.Tensor:
    """``act(x w_gate) · (x w_in)`` (GeGLU / SwiGLU) or ``act(x w_in)``,
    then ``@ w_out``."""
    a = ACTIVATIONS[act]
    h = x @ p["w_in"]
    if "w_gate" in p:
        h = a(x @ p["w_gate"]) * h
    else:
        h = a(h)
    return h @ p["w_out"]


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """``cap · tanh(x / cap)``, or ``x`` when ``cap`` is None."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)
