"""Step functions of the LM substrate (port of ``repro/launch/steps.py``).

``prefill_step`` — the full-sequence forward (inference prefill) → the
last position's logits. ``serve_step`` — ONE new token against the
recurrent state, greedy-sampled (argmax, the first index on ties). The
training step is not ported yet.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.nn.transformer import ArchConfig, decode_step, prefill
from repro_torch.roadmap import not_ported

PyTree = Any


def make_train_step(cfg: ArchConfig, optimizer=None) -> Callable:
    raise not_ported("make_train_step (LM training)", "lm_train")


def make_prefill_step(cfg: ArchConfig) -> Callable:
    def prefill_step(params: PyTree, batch: Dict[str, torch.Tensor]
                     ) -> torch.Tensor:
        last_logits, _ = prefill(params, cfg, batch["tokens"])
        return last_logits
    return prefill_step


def make_serve_step(cfg: ArchConfig) -> Callable:
    def serve_step(params: PyTree, cache: PyTree,
                   batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, PyTree]:
        logits, cache = decode_step(params, cfg, batch["tokens"], cache)
        return torch.argmax(logits[:, -1], dim=-1), cache
    return serve_step
