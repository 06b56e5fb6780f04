"""Optimizers and LR schedules (port of ``repro.training.optimizer``).

Plain functions on dictionaries of tensors (name → tensor), with the
reference's optax-like interface: ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)``, then
``apply_updates``. They are written out rather than taken from
``torch.optim`` so that an update is the reference's formula term by
term.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

Params = Dict[str, torch.Tensor]
LearningRate = Union[float, Callable[[torch.Tensor], torch.Tensor]]


class OptState(NamedTuple):
    step: torch.Tensor          # int32 scalar
    mu: Optional[Params]        # first moment (Adam) / momentum (SGD)
    nu: Optional[Params]        # second moment (Adam) or None


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], OptState]
    update: Callable[[Params, OptState, Params], Tuple[Params, OptState]]


def _lr_at(learning_rate: LearningRate, step: torch.Tensor) -> torch.Tensor:
    if callable(learning_rate):
        return learning_rate(step)
    return torch.tensor(learning_rate, dtype=torch.float32,
                        device=step.device)


def _step0(params: Params) -> torch.Tensor:
    dev = next(iter(params.values())).device if params else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def global_norm(tree: Params) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.values()))


def adam(learning_rate: LearningRate, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0,
         grad_clip_norm: Optional[float] = None) -> Optimizer:
    """Adam / AdamW, the reference's update::

        m' = b1 m + (1 - b1) g;   v' = b2 v + (1 - b2) g g
        u  = -lr · (m' / (1 - b1^t)) / (sqrt(v' / (1 - b2^t)) + eps)
    """

    def init(params: Params) -> OptState:
        return OptState(step=_step0(params),
                        mu={k: torch.zeros_like(v) for k, v in params.items()},
                        nu={k: torch.zeros_like(v) for k, v in params.items()})

    def update(grads: Params, state: OptState, params: Params
               ) -> Tuple[Params, OptState]:
        if grad_clip_norm is not None:
            scale = torch.clamp_max(
                grad_clip_norm / (global_norm(grads) + 1e-9), 1.0)
            grads = {k: g * scale for k, g in grads.items()}
        step = state.step + 1
        t = step.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, device=t.device), t)
        bc2 = 1 - torch.pow(torch.tensor(b2, device=t.device), t)
        lr = _lr_at(learning_rate, step)
        updates, mu, nu = {}, {}, {}
        for k, g in grads.items():
            m, v, p = state.mu[k], state.nu[k], params[k]
            gf = g.float()
            mu[k] = m2 = b1 * m + (1 - b1) * gf
            nu[k] = v2 = b2 * v + (1 - b2) * gf * gf
            delta = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
            if weight_decay:
                delta = delta + weight_decay * p.float()
            updates[k] = (-lr * delta).to(p.dtype)
        return updates, OptState(step=step, mu=mu, nu=nu)

    return Optimizer(init=init, update=update)


def sgd(learning_rate: LearningRate, momentum: float = 0.0) -> Optimizer:
    def init(params: Params) -> OptState:
        mu = ({k: torch.zeros_like(v) for k, v in params.items()}
              if momentum else None)
        return OptState(step=_step0(params), mu=mu, nu=None)

    def update(grads: Params, state: OptState, params: Params
               ) -> Tuple[Params, OptState]:
        step = state.step + 1
        lr = _lr_at(learning_rate, step)
        if momentum:
            mu = {k: momentum * state.mu[k] + g for k, g in grads.items()}
            updates = {k: -lr * m for k, m in mu.items()}
        else:
            mu = None
            updates = {k: -lr * g for k, g in grads.items()}
        return updates, OptState(step=step, mu=mu, nu=None)

    return Optimizer(init=init, update=update)


def apply_updates(params: Params, updates: Params) -> Params:
    return {k: p + updates[k] for k, p in params.items()}


# ---------------------------------------------------------------------- #
# Schedules
# ---------------------------------------------------------------------- #
def constant_schedule(lr: float) -> Callable:
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device)


def warmup_cosine_schedule(peak_lr: float, warmup_steps: int,
                           total_steps: int,
                           end_lr: float = 0.0) -> Callable:
    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps) /
                           max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = end_lr + 0.5 * (peak_lr - end_lr) * (
            1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup_steps, warm, cos)
    return schedule
