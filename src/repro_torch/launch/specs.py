"""Abstract inputs and analytic model FLOPs of the LM substrate (port of
``repro/launch/specs.py``): the input shapes of the dry run, the
long-context rule, abstract parameters, Adam state, batches and caches,
``model_flops`` and the scan trip count.

"Abstract" means ``meta`` tensors: the reference's shapes and dtypes
(bf16 by default, as there), nothing allocated. Modality frontends are
stubs, as in the reference: whisper gets frame embeddings ``(B, 1500,
d)``, qwen2-vl patch embeddings ``(B, S, vision_dim)`` and 3-D M-RoPE
positions.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.nn.transformer import (
    ArchConfig, init_decode_cache, init_params, leaves, stack_plan,
)
from repro_torch.training.optimizer import OptState, adam

PyTree = Any


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str        # train | prefill | decode


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

# long_500k needs sub-quadratic attention: it runs for the SSM, the hybrid
# and the sliding-window dense variant; pure full-attention archs skip it
LONG_CONTEXT_OK = {"rwkv6-3b", "recurrentgemma-9b", "gemma-2b-sw"}


def resolve_arch_for_shape(arch_name: str, shape_name: str
                           ) -> Tuple[Optional[ArchConfig], str]:
    """``(config or None, note)``: gemma-2b substitutes its sliding-window
    variant for long_500k; other full-attention archs skip it."""
    from repro_torch.configs import get_arch
    if shape_name == "long_500k":
        if arch_name == "gemma-2b":
            return get_arch("gemma-2b-sw"), \
                "substituted sliding-window variant (sub-quadratic)"
        if arch_name not in LONG_CONTEXT_OK:
            return None, "skipped: full-attention arch at 500k decode"
    return get_arch(arch_name), ""


def abstract_params(cfg: ArchConfig, dtype=torch.bfloat16) -> PyTree:
    """The parameter tree of ``cfg`` as ``meta`` tensors (every MoE router
    fp32, as ``init_params`` makes it)."""
    return init_params(cfg, generator=None, device="meta", dtype=dtype)


def abstract_opt_state(params: PyTree, optimizer=None) -> OptState:
    """The optimizer's state for ``params`` (default Adam: the step and
    two moments of every leaf, by dotted name), on ``meta``."""
    opt = optimizer or adam(1e-4)
    return opt.init(dict(leaves(params)))


def abstract_batch(cfg: ArchConfig, shape: InputShape
                   ) -> Dict[str, torch.Tensor]:
    """The batch of one step of ``shape.mode`` on ``meta``: int32 tokens
    (and labels for training; decode: one token and its position ``pos``
    a row), bf16 patch embeddings and int32 3-D positions for the VLM,
    bf16 frame embeddings for the encoder-decoder."""
    b, s = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16

    def meta(*dims, dtype=i32):
        return torch.empty(dims, dtype=dtype, device="meta")
    if shape.mode in ("train", "prefill"):
        batch: Dict[str, torch.Tensor] = {"tokens": meta(b, s)}
        if shape.mode == "train":
            batch["labels"] = meta(b, s)
        if cfg.arch_type == "vlm":
            batch["vision_embeds"] = meta(b, s, cfg.vision_dim, dtype=bf16)
            batch["positions"] = meta(b, s, 3)
        if cfg.arch_type == "encdec":
            batch["audio_frames"] = meta(b, cfg.encoder_frames, cfg.d_model,
                                         dtype=bf16)
        return batch
    batch = {"tokens": meta(b, 1), "pos": meta(b)}
    if cfg.m_rope:
        batch["positions_3d"] = meta(b, 1, 3)
    return batch


def abstract_cache(cfg: ArchConfig, shape: InputShape,
                   dtype=torch.bfloat16) -> PyTree:
    """The decode cache for ``shape`` on ``meta``."""
    return init_decode_cache(cfg, shape.global_batch, shape.seq_len,
                             device="meta", dtype=dtype)



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


def scan_trip_count(cfg: ArchConfig) -> int:
    """Largest scanned group's length: the reference's loop multiplier."""
    return max((n for _, n, scanned in stack_plan(cfg) if scanned),
               default=1)
