"""Step functions of the LM substrate (port of ``repro/launch/steps.py``).

``loss_and_grads`` — the loss, its aux and every leaf's gradient.
``train_step`` — those, then one optimizer step, in place.
``prefill_step`` — the full-sequence forward (inference prefill) → the
last position's logits; the batch may hold ``positions``,
``vision_embeds`` and ``audio_frames``. ``serve_step`` — ONE new token at
``batch["pos"]`` (and ``batch["positions_3d"]`` under M-RoPE) against the
KV cache and recurrent state, greedy-sampled (argmax, the first index on
ties).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.nn.transformer import (
    ArchConfig, decode_step, leaves, loss_fn, map_tree, prefill,
)
from repro_torch.training.optimizer import Optimizer, OptState

PyTree = Any


def loss_and_grads(params: PyTree, cfg: ArchConfig,
                   batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                              Dict[str, torch.Tensor]]:
    """``(loss, aux, grads)`` of one :func:`loss_fn` call: the loss and its
    aux metrics detached, ``grads`` every leaf's gradient by its dotted
    name (``leaves``). ``params`` is left as it was."""
    live = map_tree(params, lambda t: t.detach().requires_grad_())
    loss, aux = loss_fn(live, cfg, batch)
    names, xs = zip(*leaves(live))
    del live
    grads = dict(zip(names, torch.autograd.grad(loss, xs)))
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


def make_train_step(cfg: ArchConfig, optimizer: Optimizer) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "nll", "moe_aux"})``: :func:`loss_and_grads`, then
    ``optimizer.update_in_place`` leaf by leaf. ``opt_state`` is
    ``optimizer.init`` of the flat tree ``dict(leaves(params))``. The
    reference's jitted step donates parameters and moments
    (``launch/train.py:107``); here they are updated in place and returned,
    and each gradient is freed once its leaf is applied, so parameters,
    gradients and moments (4 × 12.3 GB for ``rwkv6-3b`` in fp32) are the
    step's only full-size state."""

    def train_step(params: PyTree, opt_state: OptState,
                   batch: Dict[str, torch.Tensor]
                   ) -> Tuple[PyTree, OptState, Dict[str, torch.Tensor]]:
        loss, aux, grads = loss_and_grads(params, cfg, batch)
        opt_state = optimizer.update_in_place(grads, opt_state,
                                              dict(leaves(params)))
        return params, opt_state, {"loss": loss, **aux}
    return train_step


def make_prefill_step(cfg: ArchConfig) -> Callable:
    def prefill_step(params: PyTree, batch: Dict[str, torch.Tensor]
                     ) -> torch.Tensor:
        last_logits, _ = prefill(
            params, cfg, batch["tokens"], positions=batch.get("positions"),
            vision_embeds=batch.get("vision_embeds"),
            audio_frames=batch.get("audio_frames"))
        return last_logits
    return prefill_step


def make_serve_step(cfg: ArchConfig) -> Callable:
    def serve_step(params: PyTree, cache: PyTree,
                   batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, PyTree]:
        logits, cache = decode_step(params, cfg, batch["tokens"], cache,
                                    batch["pos"],
                                    positions_3d=batch.get("positions_3d"))
        return torch.argmax(logits[:, -1], dim=-1), cache
    return serve_step
