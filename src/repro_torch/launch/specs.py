"""Analytic model FLOPs of the LM substrate (port of
``repro/launch/specs.py:27-145``: ``InputShape`` and ``model_flops``).

Parameter counts come from the port's own parameter shapes, made on the
``meta`` device (nothing is allocated).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.nn.transformer import ArchConfig, init_params, leaves


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str        # train | prefill | decode



def _param_counts(cfg: ArchConfig) -> Tuple[float, float]:
    """``(total, active)`` parameter counts; active excludes the embedding
    and the LM head (the 6ND convention). The reference's discount of
    routed experts applies to MoE layers, which the port does not have
    yet."""
    total = active = 0.0
    for name, t in leaves(init_params(cfg, generator=None, device="meta")):
        n = float(t.numel())
        total += n
        if name.split(".")[0] not in ("embed", "lm_head"):
            active += n
    return total, active


def model_flops(cfg: ArchConfig, shape: InputShape) -> float:
    """Analytic useful FLOPs per step: ``6·N_active·tokens`` (train),
    ``2·N_active·tokens`` (prefill), ``2·N_active·B`` (decode). The
    reference's attention terms are zero for every architecture the port
    runs (RWKV has no attention layers)."""
    _, active = _param_counts(cfg)
    b, s = shape.global_batch, shape.seq_len
    if shape.mode == "train":
        return 6.0 * active * b * s
    if shape.mode == "prefill":
        return 2.0 * active * b * s
    return 2.0 * active * b
