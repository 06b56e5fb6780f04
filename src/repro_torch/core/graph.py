"""Knowledge-graph triplet store (port of the part of
``repro/core/graph.py`` the filter index needs).

The graph lives on the host as numpy arrays. A knowledge graph is a set of
triplets (s, r, t): head entity, relation type, tail entity, all dense
int32 ids.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class KnowledgeGraph:
    """Triplet store.

    Attributes:
      src:  (E,) int32 head entity per edge.
      rel:  (E,) int32 relation type per edge.
      dst:  (E,) int32 tail entity per edge.
      num_entities: N.
      num_relations: R (before adding inverse relations).
      features: optional (N, F) float32 input features.
    """

    src: np.ndarray
    rel: np.ndarray
    dst: np.ndarray
    num_entities: int
    num_relations: int
    features: Optional[np.ndarray] = None

    def __post_init__(self):
        self.src = np.asarray(self.src, dtype=np.int32)
        self.rel = np.asarray(self.rel, dtype=np.int32)
        self.dst = np.asarray(self.dst, dtype=np.int32)
        if not (self.src.shape == self.rel.shape == self.dst.shape):
            raise ValueError("src/rel/dst must have identical shapes")

    def triplets(self) -> np.ndarray:
        """(E, 3) int32 array of (s, r, t)."""
        return np.stack([self.src, self.rel, self.dst], axis=1)

    def with_inverse_relations(self) -> "KnowledgeGraph":
        """Add (t, r + R, s) for every (s, r, t)."""
        return KnowledgeGraph(
            src=np.concatenate([self.src, self.dst]),
            rel=np.concatenate([self.rel, self.rel + self.num_relations]),
            dst=np.concatenate([self.dst, self.src]),
            num_entities=self.num_entities,
            num_relations=2 * self.num_relations,
            features=self.features,
        )
