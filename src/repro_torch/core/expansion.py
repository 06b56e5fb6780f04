"""Neighborhood expansion (port of ``repro/core/expansion.py``; paper
§3.2.2): make partitions self-sufficient.

An ``n``-layer GNN needs, for every vertex it must embed, the full ``n``-hop
in-neighborhood.  After vertex-cut partitioning some of that neighborhood
lives in other partitions ("boundary edges").  Expansion copies the missing
*support vertices* and *support edges* into the partition so that training
NEVER communicates neighbor state across partitions — the paper's central
self-sufficiency invariant.

Message-passing convention (matches ``repro_torch.models.rgcn``): an edge
``(s, r, t)`` carries ``h_t`` into the update of ``h_s``; i.e. the in-edges of
a vertex ``v`` are the edges with ``src == v``.  Inverse relations are added
upstream (``KnowledgeGraph.with_inverse_relations``) so information flows both
ways, exactly as RGCN does.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.graph import KnowledgeGraph
from repro_torch.core.partition import EdgePartition, core_vertices


@dataclasses.dataclass
class SelfSufficientPartition:
    """A localized, self-sufficient partition.

    All arrays use LOCAL vertex ids ``0..num_local_vertices-1``;
    ``local_to_global`` maps back.  Core entities come first in the local id
    space (``local id < num_core_vertices`` ⇔ core vertex) which makes the
    constraint-based negative sampler a plain ``randint``.
    """

    # Local message-passing graph (core + support edges).
    src: np.ndarray          # (E_loc,) int32 local ids
    rel: np.ndarray          # (E_loc,) int32
    dst: np.ndarray          # (E_loc,) int32 local ids
    # Which local edges are core (positive training edges).
    core_edge_mask: np.ndarray  # (E_loc,) bool
    # Id maps.
    local_to_global: np.ndarray  # (V_loc,) int64
    num_core_vertices: int
    num_core_edges: int
    # Provenance.
    partition_id: int = 0
    num_hops: int = 2

    @property
    def num_local_vertices(self) -> int:
        return int(self.local_to_global.shape[0])

    @property
    def num_local_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def num_support_edges(self) -> int:
        return self.num_local_edges - self.num_core_edges

    def core_edges_local(self) -> np.ndarray:
        """(E_core, 3) local-id (s, r, t) of positive training triplets."""
        m = self.core_edge_mask
        return np.stack([self.src[m], self.rel[m], self.dst[m]], axis=1)


def expand_partition(
    kg: KnowledgeGraph,
    part: EdgePartition,
    num_hops: int,
    partition_id: int = 0,
) -> SelfSufficientPartition:
    """Expand one partition to include the ``num_hops``-hop in-neighborhood
    of every core vertex (paper §3.2.2, Fig. 4)."""
    core_v = core_vertices(kg, part)

    needed = np.zeros(kg.num_edges, dtype=bool)
    needed[part.core_edge_ids] = True

    frontier = core_v
    for _ in range(num_hops):
        in_eids = kg.in_edges(frontier)          # edges with src in frontier
        new = in_eids[~needed[in_eids]]
        if new.size == 0:
            break
        needed[new] = True
        frontier = np.unique(kg.dst[new])

    all_eids = np.nonzero(needed)[0]
    src_g = kg.src[all_eids]
    rel_g = kg.rel[all_eids]
    dst_g = kg.dst[all_eids]
    core_mask = np.zeros(kg.num_edges, dtype=bool)
    core_mask[part.core_edge_ids] = True
    core_edge_mask = core_mask[all_eids]

    # Local id space: core vertices first (stable order), then supports.
    support_v = np.setdiff1d(
        np.unique(np.concatenate([src_g, dst_g])), core_v, assume_unique=False)
    local_to_global = np.concatenate([core_v, support_v]).astype(np.int64)
    g2l = np.full(kg.num_entities, -1, dtype=np.int64)
    g2l[local_to_global] = np.arange(local_to_global.shape[0])

    return SelfSufficientPartition(
        src=g2l[src_g].astype(np.int32),
        rel=rel_g.astype(np.int32),
        dst=g2l[dst_g].astype(np.int32),
        core_edge_mask=core_edge_mask,
        local_to_global=local_to_global,
        num_core_vertices=int(core_v.shape[0]),
        num_core_edges=int(part.core_edge_ids.shape[0]),
        partition_id=partition_id,
        num_hops=num_hops,
    )


def expand_all(
    kg: KnowledgeGraph,
    parts: Sequence[EdgePartition],
    num_hops: int,
) -> List[SelfSufficientPartition]:
    return [
        expand_partition(kg, p, num_hops, partition_id=i)
        for i, p in enumerate(parts)
    ]


# ====================================================================== #
# Fixed-shape padding: one stacked batch for all trainers
# ====================================================================== #
@dataclasses.dataclass
class PaddedPartitionBatch:
    """All partitions padded to common (V_max, E_max) and stacked on a
    leading trainer axis (the simulated trainers loop over it).

    Padded vertices map to a sink row (embedding row V_max-1 is real but
    masked); padded edges have ``edge_mask == False`` and src=dst=0, rel=0 so
    gathers stay in range.
    """

    src: np.ndarray              # (P, E_max) int32
    rel: np.ndarray              # (P, E_max) int32
    dst: np.ndarray              # (P, E_max) int32
    edge_mask: np.ndarray        # (P, E_max) bool   — real message edges
    core_edge_mask: np.ndarray   # (P, E_max) bool   — real AND core
    local_to_global: np.ndarray  # (P, V_max) int64  — padded with 0
    vertex_mask: np.ndarray      # (P, V_max) bool
    num_core_vertices: np.ndarray  # (P,) int32
    num_core_edges: np.ndarray     # (P,) int32

    @property
    def num_partitions(self) -> int:
        return int(self.src.shape[0])

    @property
    def padded_vertices(self) -> int:
        return int(self.local_to_global.shape[1])

    @property
    def padded_edges(self) -> int:
        return int(self.src.shape[1])

    def padding_waste(self) -> float:
        """Fraction of padded edge slots that are padding."""
        return 1.0 - float(self.edge_mask.mean())


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_partitions(
    parts: Sequence[SelfSufficientPartition],
    edge_align: int = 128,
    vertex_align: int = 8,
    max_vertices: Optional[int] = None,
    max_edges: Optional[int] = None,
) -> PaddedPartitionBatch:
    """Pad every partition to shared maxima. The 128-aligned edges are the
    reference's layout (its TPU kernels tile edges by 128); the CUDA kernels
    take any edge count, and the alignment is kept so that both packages
    build the same arrays."""
    v_max = max(p.num_local_vertices for p in parts)
    e_max = max(p.num_local_edges for p in parts)
    v_max = _round_up(max(v_max, max_vertices or 0), vertex_align)
    e_max = _round_up(max(e_max, max_edges or 0), edge_align)
    n = len(parts)

    out = PaddedPartitionBatch(
        src=np.zeros((n, e_max), np.int32),
        rel=np.zeros((n, e_max), np.int32),
        dst=np.zeros((n, e_max), np.int32),
        edge_mask=np.zeros((n, e_max), bool),
        core_edge_mask=np.zeros((n, e_max), bool),
        local_to_global=np.zeros((n, v_max), np.int64),
        vertex_mask=np.zeros((n, v_max), bool),
        num_core_vertices=np.zeros(n, np.int32),
        num_core_edges=np.zeros(n, np.int32),
    )
    for i, p in enumerate(parts):
        e, v = p.num_local_edges, p.num_local_vertices
        out.src[i, :e] = p.src
        out.rel[i, :e] = p.rel
        out.dst[i, :e] = p.dst
        out.edge_mask[i, :e] = True
        out.core_edge_mask[i, :e] = p.core_edge_mask
        out.local_to_global[i, :v] = p.local_to_global
        out.vertex_mask[i, :v] = True
        out.num_core_vertices[i] = p.num_core_vertices
        out.num_core_edges[i] = p.num_core_edges
    return out


def verify_self_sufficiency(
    kg: KnowledgeGraph, part: SelfSufficientPartition,
) -> bool:
    """Invariant check (used by property tests): every vertex reachable in
    ``num_hops`` message-passing steps from a core vertex has ALL its
    in-edges of the remaining depth present locally.

    Concretely: for hop d = 0..n-1, every global in-edge of every vertex at
    BFS depth d from the core set must be a local edge."""
    local_edges = set(
        zip(part.local_to_global[part.src].tolist(),
            part.rel.tolist(),
            part.local_to_global[part.dst].tolist())
    )
    frontier = set(part.local_to_global[:part.num_core_vertices].tolist())
    for _ in range(part.num_hops):
        next_frontier = set()
        fr = np.fromiter(frontier, dtype=np.int64) if frontier else \
            np.zeros(0, np.int64)
        eids = kg.in_edges(fr)
        for eid in eids:
            trip = (int(kg.src[eid]), int(kg.rel[eid]), int(kg.dst[eid]))
            if trip not in local_edges:
                return False
            next_frontier.add(trip[2])
        frontier = next_frontier
    return True
