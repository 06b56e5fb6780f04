"""Knowledge-graph container (port of ``repro/core/graph.py``).

The graph lives on the host as numpy arrays: partitioning and expansion
are offline CPU steps, and the training step only ever sees the padded
index arrays derived from them. A knowledge graph is a set of triplets
(s, r, t): head entity, relation type, tail entity, all dense int32 ids.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class KnowledgeGraph:
    """Triplet store with adjacency indexes.

    Attributes:
      src:  (E,) int32 head entity per edge.
      rel:  (E,) int32 relation type per edge.
      dst:  (E,) int32 tail entity per edge.
      num_entities: N.
      num_relations: R (before adding inverse relations).
      features: optional (N, F) float32 input features; None => learned
        entity embeddings (transductive, like FB15k-237).
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
        self._csr: Optional[Tuple[np.ndarray, np.ndarray]] = None

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    def triplets(self) -> np.ndarray:
        """(E, 3) int32 array of (s, r, t)."""
        return np.stack([self.src, self.rel, self.dst], axis=1)

    def with_inverse_relations(self) -> "KnowledgeGraph":
        """Add (t, r + R, s) for every (s, r, t), so message passing flows
        both ways."""
        return KnowledgeGraph(
            src=np.concatenate([self.src, self.dst]),
            rel=np.concatenate([self.rel, self.rel + self.num_relations]),
            dst=np.concatenate([self.dst, self.src]),
            num_entities=self.num_entities,
            num_relations=2 * self.num_relations,
            features=self.features,
        )

    def degrees(self) -> np.ndarray:
        """(N,) total (in + out) degree."""
        deg = np.zeros(self.num_entities, dtype=np.int64)
        np.add.at(deg, self.src, 1)
        np.add.at(deg, self.dst, 1)
        return deg

    def _build_csr(self) -> Tuple[np.ndarray, np.ndarray]:
        """Undirected incidence CSR: for each vertex, the edge ids touching
        it (cached)."""
        if self._csr is not None:
            return self._csr
        e = self.num_edges
        endpoints = np.concatenate([self.src, self.dst])
        edge_ids = np.concatenate(
            [np.arange(e, dtype=np.int64), np.arange(e, dtype=np.int64)])
        order = np.argsort(endpoints, kind="stable")
        sorted_v = endpoints[order]
        sorted_e = edge_ids[order]
        indptr = np.zeros(self.num_entities + 1, dtype=np.int64)
        counts = np.bincount(sorted_v, minlength=self.num_entities)
        np.cumsum(counts, out=indptr[1:])
        self._csr = (indptr, sorted_e)
        return self._csr

    def incident_edges(self, vertices: np.ndarray) -> np.ndarray:
        """Edge ids incident (as src OR dst) to any vertex in
        ``vertices``."""
        indptr, sorted_e = self._build_csr()
        vertices = np.asarray(vertices, dtype=np.int64)
        if vertices.size == 0:
            return np.zeros(0, dtype=np.int64)
        spans = [sorted_e[indptr[v]: indptr[v + 1]] for v in vertices]
        return np.unique(np.concatenate(spans))

    def in_edges(self, vertices: np.ndarray) -> np.ndarray:
        """Edge ids whose src is in ``vertices``: an edge (s, r, t) carries
        h_t into the update of h_s, so the edges feeding a vertex v are
        those with src == v."""
        vset = np.zeros(self.num_entities, dtype=bool)
        vset[np.asarray(vertices, dtype=np.int64)] = True
        return np.nonzero(vset[self.src])[0].astype(np.int64)

    def subgraph(self, edge_ids: np.ndarray) -> "KnowledgeGraph":
        """Sub-KG on a subset of edges, KEEPING global entity ids."""
        edge_ids = np.asarray(edge_ids, dtype=np.int64)
        return KnowledgeGraph(
            src=self.src[edge_ids],
            rel=self.rel[edge_ids],
            dst=self.dst[edge_ids],
            num_entities=self.num_entities,
            num_relations=self.num_relations,
            features=self.features,
        )


def triplet_set(kg: KnowledgeGraph) -> set:
    """Set of (s, r, t) tuples."""
    return set(map(tuple, kg.triplets().tolist()))


def make_synthetic_kg(
    num_entities: int,
    num_relations: int,
    num_edges: int,
    seed: int = 0,
    feature_dim: Optional[int] = None,
    power: float = 1.2,
) -> KnowledgeGraph:
    """Synthetic KG with a skewed (Zipf-like) degree distribution, drawn
    with the reference's numpy calls in the reference's order, so the same
    seed gives the same graph."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, num_entities + 1, dtype=np.float64) ** power
    w /= w.sum()
    src = rng.choice(num_entities, size=num_edges, p=w).astype(np.int32)
    dst = rng.choice(num_entities, size=num_edges, p=w).astype(np.int32)
    # avoid self loops (re-draw once; leftovers shifted)
    loops = src == dst
    dst[loops] = (dst[loops] + 1 + rng.integers(0, num_entities - 1,
                                                loops.sum())) % num_entities
    rel = rng.integers(0, num_relations, size=num_edges).astype(np.int32)
    trip = np.unique(np.stack([src, rel, dst], axis=1), axis=0)
    features = None
    if feature_dim is not None:
        features = rng.normal(0, 1, (num_entities, feature_dim)).astype(
            np.float32)
    return KnowledgeGraph(
        src=trip[:, 0], rel=trip[:, 1], dst=trip[:, 2],
        num_entities=num_entities, num_relations=num_relations,
        features=features,
    )


def split_train_valid_test(
    kg: KnowledgeGraph, valid_frac: float = 0.05, test_frac: float = 0.05,
    seed: int = 0,
) -> Dict[str, KnowledgeGraph]:
    """Random triplet split in the FB15k-237 style."""
    rng = np.random.default_rng(seed)
    e = kg.num_edges
    perm = rng.permutation(e)
    n_valid = int(e * valid_frac)
    n_test = int(e * test_frac)
    return {
        "train": kg.subgraph(perm[n_valid + n_test:]),
        "valid": kg.subgraph(perm[:n_valid]),
        "test": kg.subgraph(perm[n_valid:n_valid + n_test]),
    }
