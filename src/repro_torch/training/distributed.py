"""Data-parallel training step (port of ``repro/training/distributed.py``;
paper §2.2, Algorithm 1), simulated in one process or real over
``torch.distributed``.

Each of the P trainers computes the loss and gradient of its own
partition; the gradients are averaged (the AllReduce of Algorithm 1 line
8) and one optimizer step updates the shared parameters. The reference
vmaps the trainers; here a loop over the leading trainer axis does it, one
trainer's graph alive at a time. The reported loss (and every auxiliary
metric) is the mean over trainers, as in the reference.

* :func:`make_simulated_train_step` — every trainer in one process.
* :func:`make_spmd_train_step` — one process per rank of a
  ``launch.mesh.ProcessMesh`` (the paper's own system is PyTorch DDP over
  a Gloo AllReduce): each rank runs its block of trainers, the data axis
  gathers every trainer's gradients (``all_gather``) and each rank adds
  them in trainer order, as the simulated loop does, so the two steps are
  bitwise equal (an ``all_reduce`` would add in its own order). The
  entity table's row blocks stay on their model ranks, with their Adam
  moments; the losses gather their rows through the real exchange
  (``sharding.embedding.exchanged_gather``).

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
import torch.distributed as dist
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


def trainer_grads(loss_fn: LossFn, model: nn.Module,
                  batch: Mapping[str, torch.Tensor],
                  generators: Sequence[torch.Generator]):
    """Each trainer's ``(loss, aux, grads)`` in trainer order: ``grads``
    one tensor per parameter of ``model``, zeros for a parameter the loss
    does not reach."""
    params = [p for _, p in model.named_parameters()]
    for i, gen in enumerate(generators):
        loss, aux = loss_fn(model, trainer_slice(batch, i), gen)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, torch.autograd.grad(
                     loss, params, allow_unused=True))]
        yield (loss.detach(), {k: v.detach() for k, v in aux.items()},
               grads)


def mean_step(model: nn.Module, optimizer: Optimizer, opt_state: OptState,
              per_trainer) -> Tuple[OptState, Dict[str, torch.Tensor]]:
    """The gradients of every trainer (``(loss, aux, grads)`` in trainer
    order) added left to right and divided by their count, then one
    optimizer step, in place (``Optimizer.update_in_place``: the
    parameters and the moments keep their storage across a step, so no
    second copy of them, the entity table block's among them, outlives it,
    ``analysis.contracts``' in-place audit); the metrics are the trainers'
    means."""
    names, params = zip(*model.named_parameters())
    total, losses, aux_sums, num = None, [], {}, 0
    for loss, aux, grads in per_trainer:
        total = list(grads) if total is None else [
            a + g for a, g in zip(total, grads)]
        losses.append(loss)
        for k, v in aux.items():
            aux_sums[k] = aux_sums.get(k, 0) + v
        num += 1
    grads = {n: g / num for n, g in zip(names, total)}
    current = {n: p.detach() for n, p in zip(names, params)}
    opt_state = optimizer.update_in_place(grads, opt_state, current)
    metrics = {"loss": torch.stack(losses).mean(),
               **{k: v / num for k, v in aux_sums.items()}}
    return opt_state, metrics


def make_simulated_train_step(loss_fn: LossFn, optimizer: Optimizer
                              ) -> Callable:
    """``step(model, opt_state, batch, generators) -> (opt_state,
    metrics)``: per-trainer loss and gradients, their mean, one optimizer
    step (:func:`mean_step`)."""

    def step(model: nn.Module, opt_state: OptState,
             batch: Mapping[str, torch.Tensor],
             generators: Sequence[torch.Generator]):
        return mean_step(model, optimizer, opt_state,
                         trainer_grads(loss_fn, model, batch, generators))

    return step


def make_spmd_train_step(loss_fn: LossFn, optimizer: Optimizer,
                         data_group) -> Callable:
    """The multi-process step: ``step(model, opt_state, batch,
    generators)`` on every rank, ``batch`` and ``generators`` this rank's
    block of trainers (``ProcessMesh.trainers``), ``model`` this rank's
    parameters (the entity table's row block among them), ``data_group``
    the ranks of this rank's model index.

    Each rank flattens each of its trainers' gradients, loss and aux
    metrics into one vector, and ``all_gather`` over the data group lays
    them out in trainer order on every rank; :func:`mean_step` then adds
    them as the simulated step does, so the step is bitwise the simulated
    one (the table block's gradients are this block's rows of the
    simulated table's). The metrics are the means over all trainers,
    equal on every rank."""

    def step(model: nn.Module, opt_state: OptState,
             batch: Mapping[str, torch.Tensor],
             generators: Sequence[torch.Generator]):
        shapes = [p.shape for _, p in model.named_parameters()]
        sizes = [int(np.prod(s)) for s in shapes]
        keys = None
        rows = []
        for loss, aux, grads in trainer_grads(loss_fn, model, batch,
                                              generators):
            keys = sorted(aux)
            rows.append(torch.cat([g.reshape(-1) for g in grads] + [
                loss.reshape(1)] + [aux[k].reshape(1) for k in keys]))
        local = torch.stack(rows)
        world = dist.get_world_size(data_group)
        gathered = local.new_empty((world * local.shape[0],
                                    local.shape[1]))
        dist.all_gather_into_tensor(gathered, local, group=data_group)
        n = sum(sizes)

        def unpack(row):
            grads = [g.reshape(s) for g, s in zip(
                torch.split(row[:n], sizes), shapes)]
            aux = {k: row[n + 1 + j] for j, k in enumerate(keys)}
            return row[n], aux, grads

        return mean_step(model, optimizer, opt_state,
                         (unpack(row) for row in gathered))

    return step
