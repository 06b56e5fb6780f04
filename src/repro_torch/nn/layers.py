"""Building blocks of the LM substrate (port of the RWKV half of
``repro/nn/layers.py``): the initializers and RMSNorm.

Parameters are plain nested dicts of tensors, as in the reference. An
initializer draws from an explicit ``torch.Generator`` on ``device``; with
``lead`` it draws a stack of ``lead`` independent copies (the reference's
``vmap`` over a scanned layer group). On the ``meta`` device nothing is
drawn: only shapes exist.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

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
