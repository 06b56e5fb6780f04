"""Data-parallel training step, simulated on one device (port of
``make_simulated_train_step`` in ``repro/training/distributed.py``; paper
§2.2, Algorithm 1).

Each of the P trainers computes the loss and gradient of its own
partition; the gradients are averaged (the AllReduce of Algorithm 1 line
8) and one optimizer step updates the shared parameters. The reference
vmaps the trainers; here a loop over the leading trainer axis does it, one
trainer's graph alive at a time. The reported loss (and every auxiliary
metric) is the mean over trainers, as in the reference.

The batch is any dict of tensors stacked on a leading trainer axis: the
resident full-graph batch, or a stacked edge mini-batch with its gather
plan.

Per-trainer randomness: the reference folds the epoch into a PRNG key and
splits it per trainer (``split_trainer_keys``), then folds in the batch
index on the mini-batch path. :func:`trainer_generators` is the port's
schedule — one ``torch.Generator`` per (seed, epoch[, step], trainer),
seeded through numpy's ``SeedSequence`` so the streams are independent and
reproducible.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.training.optimizer import OptState, Optimizer

# loss_fn(params, batch_slice, generator) -> (loss, aux)
LossFn = Callable[[nn.Module, Dict[str, torch.Tensor], torch.Generator],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def trainer_generators(seed: int, num_trainers: int, epoch: int,
                       device: torch.device, step: Optional[int] = None
                       ) -> List[torch.Generator]:
    """One generator per trainer for ``epoch`` (and mini-batch ``step``),
    on ``device``."""
    entropy = [seed, epoch] + ([] if step is None else [step])
    states = np.random.SeedSequence(entropy).spawn(num_trainers)
    gens = []
    for s in states:
        g = torch.Generator(device=device)
        g.manual_seed(int(s.generate_state(1, np.uint64)[0] >> 1))
        gens.append(g)
    return gens


def trainer_slice(batch: Mapping[str, torch.Tensor],
                  i: int) -> Dict[str, torch.Tensor]:
    """Trainer ``i``'s slice of a batch stacked on the trainer axis."""
    return {k: v[i] for k, v in batch.items()}


def make_simulated_train_step(loss_fn: LossFn, optimizer: Optimizer
                              ) -> Callable:
    """``step(model, opt_state, batch, generators) -> (opt_state,
    metrics)``: per-trainer loss and gradients, their mean, one optimizer
    step. The model's parameters are updated in place (``p += u`` under
    ``no_grad``, the reference's ``apply_updates``)."""

    def step(model: nn.Module, opt_state: OptState,
             batch: Mapping[str, torch.Tensor],
             generators: Sequence[torch.Generator]):
        names, params = zip(*model.named_parameters())
        num = len(generators)
        total = None
        losses, aux_sums = [], {}
        for i, gen in enumerate(generators):
            loss, aux = loss_fn(model, trainer_slice(batch, i), gen)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(params, torch.autograd.grad(
                         loss, params, allow_unused=True))]
            total = list(grads) if total is None else [
                a + g for a, g in zip(total, grads)]
            losses.append(loss.detach())
            for k, v in aux.items():
                aux_sums[k] = aux_sums.get(k, 0) + v.detach()
        grads = {n: g / num for n, g in zip(names, total)}
        current = {n: p.detach() for n, p in zip(names, params)}
        updates, opt_state = optimizer.update(grads, opt_state, current)
        with torch.no_grad():
            for n, p in zip(names, params):
                p.add_(updates[n])
        metrics = {"loss": torch.stack(losses).mean(),
                   **{k: v / num for k, v in aux_sums.items()}}
        return opt_state, metrics

    return step
