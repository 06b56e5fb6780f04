"""Analytic model FLOPs of the LM substrate (port of
``repro/launch/specs.py:27-158``: ``InputShape``, ``model_flops`` and
``_attention_layer_count``).

Parameter counts come from the port's own parameter shapes, made on the
``meta`` device (nothing is allocated).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.nn.transformer import (
    ArchConfig, init_params, leaves, stack_plan,
)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str        # train | prefill | decode



def _param_counts(cfg: ArchConfig) -> Tuple[float, float]:
    """``(total, active)`` parameter counts; active excludes the embedding
    and the LM head (the 6ND convention) and counts the routed experts'
    stacks (``moe.w_in``, ``moe.w_gate``, ``moe.w_out``, expert axis
    ``num_experts`` long) at their ``top_k / num_experts`` use. The
    reference discounts every leaf of 3 or more dimensions under ``moe``
    with those names, so also the stacked shared experts (deepseek) and
    dense branch (arctic), which every token uses: its active count is
    1.834 B for deepseek-v2-lite-16b and 11.52 B for arctic-480b, where
    this one's is 2.242 B and 15.13 B (ROADMAP, known faults on the
    reference side). For every other architecture the two are equal."""
    total = active = 0.0
    for name, t in leaves(init_params(cfg, generator=None, device="meta")):
        n = float(t.numel())
        total += n
        parts = name.split(".")
        if parts[0] in ("embed", "lm_head"):
            continue
        if parts[-2:-1] == ["moe"] and parts[-1] in (
                "w_in", "w_gate", "w_out") and t.shape[-3] == cfg.num_experts:
            n *= cfg.top_k / max(cfg.num_experts, 1)
        active += n
    return total, active


def model_flops(cfg: ArchConfig, shape: InputShape) -> float:
    """Analytic useful FLOPs per step: ``6·N_active·tokens`` (train),
    ``2·N_active·tokens`` (prefill), ``2·N_active·B`` (decode), plus the
    attention terms of the reference: the causal half of the ``S²``
    scores and values per attention layer in training and prefill (the
    window is not counted there), and in decode the product over the
    ``min(S, sliding_window)`` cached keys (the hybrid's local window is
    not counted either, as in the reference)."""
    _, active = _param_counts(cfg)
    b, s = shape.global_batch, shape.seq_len
    hd = cfg.resolved_head_dim
    attn_layers = _attention_layer_count(cfg)
    if shape.mode == "train":
        flops = 6.0 * active * b * s
        flops += 6.0 * b * s * s * cfg.num_heads * hd * attn_layers * 0.5
        return flops
    if shape.mode == "prefill":
        return (2.0 * active * b * s +
                2.0 * b * s * s * cfg.num_heads * hd * attn_layers * 0.5)
    window = cfg.sliding_window or s
    kv_len = min(s, window)
    return (2.0 * active * b +
            4.0 * b * kv_len * cfg.num_heads * hd * attn_layers)


def _attention_layer_count(cfg: ArchConfig) -> int:
    """The stack's attention layers (a hybrid's ``attn`` blocks), and the
    encoder's layers of an encoder-decoder."""
    n = 0
    for kind, cnt, _ in stack_plan(cfg):
        if kind == "pattern":
            n += cnt * sum(1 for k in cfg.hybrid_pattern if k == "attn")
        elif kind in ("dense", "moe", "dec", "enc"):
            n += cnt
    if cfg.arch_type == "encdec":
        n += cfg.encoder_layers
    return n
