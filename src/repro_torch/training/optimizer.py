"""Optimizers and LR schedules (port of ``repro.training.optimizer``).

Plain functions on dictionaries of tensors (name → tensor), with the
reference's optax-like interface: ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)``, then
``apply_updates``. They are written out rather than taken from
``torch.optim`` so that an update is the reference's formula term by
term.

``update_in_place(grads, state, params) -> state`` is the same update
applied leaf by leaf into the parameters and the moments themselves, each
gradient dropped from ``grads`` once its leaf is applied: the port's
counterpart of the reference's donated train step (``donate_argnums``).
It computes every leaf by the same function as ``update``, so its bits are
``update`` + ``apply_updates``'s, and its temporaries are one leaf's, where
``update`` makes new moments and updates for the whole tree.
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
    update_in_place: Callable[[Params, OptState, Params], OptState]


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


def _clip_scale(grads: Params, grad_clip_norm: Optional[float]
                ) -> Optional[torch.Tensor]:
    """The factor the gradients are scaled by so that their global norm is
    at most ``grad_clip_norm`` (None: no clipping)."""
    if grad_clip_norm is None:
        return None
    return torch.clamp_max(grad_clip_norm / (global_norm(grads) + 1e-9), 1.0)


def _in_place(leaf: Callable, scalars: Callable, grad_clip_norm=None
              ) -> Callable:
    """``update_in_place`` of an optimizer whose update is ``leaf(g, m, v,
    p, *scalars(state)) -> (m', v', u)`` on every leaf, with ``scalars(state)
    -> (step, *values shared by every leaf)``."""

    @torch.no_grad()
    def update_in_place(grads: Params, state: OptState, params: Params
                        ) -> OptState:
        scale = _clip_scale(grads, grad_clip_norm)
        step, *shared = scalars(state)
        for k in list(grads):
            g = grads.pop(k)
            if scale is not None:
                g = g * scale
            m = None if state.mu is None else state.mu[k]
            v = None if state.nu is None else state.nu[k]
            m2, v2, u = leaf(g, m, v, params[k], *shared)
            del g
            params[k].add_(u)
            for old, new in ((m, m2), (v, v2)):
                if old is not None:
                    old.copy_(new)
        return OptState(step=step, mu=state.mu, nu=state.nu)

    return update_in_place


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

    def scalars(state: OptState):
        step = state.step + 1
        t = step.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, device=t.device), t)
        bc2 = 1 - torch.pow(torch.tensor(b2, device=t.device), t)
        return step, bc1, bc2, _lr_at(learning_rate, step)

    def leaf(g, m, v, p, bc1, bc2, lr):
        gf = g.float()
        m2 = b1 * m + (1 - b1) * gf
        v2 = b2 * v + (1 - b2) * gf * gf
        delta = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
        if weight_decay:
            delta = delta + weight_decay * p.float()
        return m2, v2, (-lr * delta).to(p.dtype)

    def update(grads: Params, state: OptState, params: Params
               ) -> Tuple[Params, OptState]:
        scale = _clip_scale(grads, grad_clip_norm)
        if scale is not None:
            grads = {k: g * scale for k, g in grads.items()}
        step, *shared = scalars(state)
        updates, mu, nu = {}, {}, {}
        for k, g in grads.items():
            mu[k], nu[k], updates[k] = leaf(g, state.mu[k], state.nu[k],
                                            params[k], *shared)
        return updates, OptState(step=step, mu=mu, nu=nu)

    return Optimizer(init=init, update=update,
                     update_in_place=_in_place(leaf, scalars,
                                               grad_clip_norm))


def sgd(learning_rate: LearningRate, momentum: float = 0.0) -> Optimizer:
    def init(params: Params) -> OptState:
        mu = ({k: torch.zeros_like(v) for k, v in params.items()}
              if momentum else None)
        return OptState(step=_step0(params), mu=mu, nu=None)

    def scalars(state: OptState):
        step = state.step + 1
        return step, _lr_at(learning_rate, step)

    def leaf(g, m, v, p, lr):
        if momentum:
            m2 = momentum * m + g
            return m2, None, -lr * m2
        return None, None, -lr * g

    def update(grads: Params, state: OptState, params: Params
               ) -> Tuple[Params, OptState]:
        step, lr = scalars(state)
        updates, mu = {}, ({} if momentum else None)
        for k, g in grads.items():
            m2, _, updates[k] = leaf(g, state.mu[k] if momentum else None,
                                     None, params[k], lr)
            if momentum:
                mu[k] = m2
        return updates, OptState(step=step, mu=mu, nu=None)

    return Optimizer(init=init, update=update,
                     update_in_place=_in_place(leaf, scalars))


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
