"""Negative sampling (port of ``repro/core/negative.py``; paper §3.3.1).

Two samplers:

* ``constraint_based`` — the paper's: corrupt head or tail with entities
  drawn ONLY from the partition's core vertices (locally closed world).
  Core vertices come first in a self-sufficient partition's local id space,
  so the draw is a plain ``randint(0, num_core_vertices)``.
* ``global_closed_world`` — the baseline: corrupt with any entity id below
  the given limit.

Both draw on the triplets' device from an explicit ``torch.Generator``
(which must live on that device). The reference draws with JAX's threefry,
which a generator cannot reproduce: tests hand both packages the same
draws instead.
"""
from __future__ import annotations

from typing import Tuple

import torch


def corrupt_triplets(
    generator: torch.Generator,
    triplets: torch.Tensor,       # (B, 3) int local (s, r, t)
    num_negatives: int,           # s in the paper
    candidate_limit: int,         # draw ids from [0, limit)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``num_negatives`` corruptions per positive.

    Returns (neg_triplets (B*s, 3), neg_is_head_corrupt (B*s,) bool). Each
    negative corrupts head OR tail (Bernoulli 0.5), replacing it with a
    uniform draw from ``[0, candidate_limit)``."""
    b = triplets.shape[0]
    s = num_negatives
    dev = triplets.device
    corrupt_head = torch.rand((b, s), generator=generator, device=dev) < 0.5
    repl = torch.randint(0, max(int(candidate_limit), 1), (b, s),
                         generator=generator, device=dev,
                         dtype=triplets.dtype)
    pos = triplets[:, None, :].expand(b, s, 3)
    neg_src = torch.where(corrupt_head, repl, pos[..., 0])
    neg_dst = torch.where(corrupt_head, pos[..., 2], repl)
    neg = torch.stack([neg_src, pos[..., 1], neg_dst], dim=-1)
    return neg.reshape(b * s, 3), corrupt_head.reshape(b * s)


def constraint_based_negatives(
    generator: torch.Generator, triplets: torch.Tensor, num_negatives: int,
    num_core_vertices: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The paper's sampler: candidates are this partition's core vertices,
    local ids ``[0, num_core_vertices)``."""
    return corrupt_triplets(generator, triplets, num_negatives,
                            num_core_vertices)


def global_closed_world_negatives(
    generator: torch.Generator, triplets: torch.Tensor, num_negatives: int,
    num_entities: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Baseline sampler over every id below ``num_entities``."""
    return corrupt_triplets(generator, triplets, num_negatives, num_entities)


def mix_pos_neg(pos: torch.Tensor, neg: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Concatenate positives and negatives with 1/0 labels (paper Eq. 3:
    |T| = p * (s + 1) training examples)."""
    trip = torch.cat([pos, neg], dim=0)
    labels = torch.cat([
        torch.ones(pos.shape[0], dtype=torch.float32, device=pos.device),
        torch.zeros(neg.shape[0], dtype=torch.float32, device=pos.device)])
    return trip, labels
