"""Edge mini-batch training support (port of ``repro/core/minibatch.py``;
paper §3.3.2, Fig. 5, Algorithm 1).

Per epoch (Algorithm 1):
  1. ``negativeSampler(gPartition)`` — sample ``s`` negatives per core edge
     from the partition's core vertices (host numpy).
  2. Batch over positive+negative edges.
  3. ``getComputeGraph(batch, gPartition)`` — the n-hop computational graph
     of the batch endpoints, so every embedding needed to score the batch
     can be computed locally.

All of it is host numpy and, on the same seed, gives arrays equal to the
reference's: the negatives are host draws, and the budgets are fixed
shapes (measured maxima plus slack, aligned), so every batch of a run has
the same shapes.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.expansion import SelfSufficientPartition


# ====================================================================== #
# Host-side negative sampling (Algorithm 1 line 3)
# ====================================================================== #
def sample_epoch_negatives(
    rng: np.random.Generator,
    part: SelfSufficientPartition,
    num_negatives: int,
    sampler: str = "constraint",
) -> np.ndarray:
    """Negatives for one epoch: corrupt head or tail of each core edge with a
    uniform draw from the partition's CORE vertices (``constraint``, local ids
    [0, num_core_vertices)) or from ALL local vertices (``global`` — the
    closed-world ablation restricted to the partition's address space, the
    same restriction ``fullgraph_loss`` applies).  Returns (E_core * s, 3)
    int32."""
    if sampler not in ("constraint", "global"):
        raise ValueError(f"unknown negative sampler {sampler!r}")
    pos = part.core_edges_local()
    e = pos.shape[0]
    s = num_negatives
    if e == 0 or s == 0:
        return np.zeros((0, 3), np.int32)
    hi = part.num_core_vertices if sampler == "constraint" \
        else part.num_local_vertices
    pos_rep = np.repeat(pos, s, axis=0)
    corrupt_head = rng.random(e * s) < 0.5
    repl = rng.integers(0, max(hi, 1), size=e * s).astype(np.int32)
    neg = pos_rep.copy()
    neg[corrupt_head, 0] = repl[corrupt_head]
    neg[~corrupt_head, 2] = repl[~corrupt_head]
    return neg


# ====================================================================== #
# Computational graph construction (getComputeGraph)
# ====================================================================== #
class _PartitionCSR:
    """In-edge CSR over partition-local ids: for vertex v, the local edge ids
    with ``src == v`` (the edges feeding v's update)."""

    def __init__(self, part: SelfSufficientPartition):
        n = part.num_local_vertices
        order = np.argsort(part.src, kind="stable")
        self.sorted_eids = order.astype(np.int64)
        self.indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(part.src, minlength=n), out=self.indptr[1:])
        self.dst = part.dst

    def in_edges_of(self, vertices: np.ndarray) -> np.ndarray:
        """Concatenated in-edge spans of ``vertices`` (span order follows the
        input order).  Vectorized: one ``np.repeat``-based gather instead of a
        Python loop over per-vertex slices."""
        v = np.asarray(vertices, dtype=np.int64)
        if v.size == 0:
            return np.zeros(0, np.int64)
        starts = self.indptr[v]
        counts = self.indptr[v + 1] - starts
        total = int(counts.sum())
        if total == 0:
            return np.zeros(0, np.int64)
        # index i of the output belongs to the span whose cumulative start
        # offset was repeated into slot i; shift by the span's CSR start.
        out_offsets = np.cumsum(counts) - counts
        idx = (np.arange(total, dtype=np.int64)
               - np.repeat(out_offsets, counts)
               + np.repeat(starts, counts))
        return self.sorted_eids[idx]


def build_comp_graph(
    part: SelfSufficientPartition,
    seed_vertices: np.ndarray,
    num_hops: int,
    csr: Optional[_PartitionCSR] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """n-hop computational graph of ``seed_vertices`` inside the partition.

    Returns (vertex_ids, edge_ids) — partition-local ids of every vertex and
    edge needed to embed the seeds with an ``num_hops``-layer GNN.
    """
    csr = csr or _PartitionCSR(part)
    need_edge = np.zeros(part.num_local_edges, dtype=bool)
    seen_v = np.zeros(part.num_local_vertices, dtype=bool)
    seeds = np.unique(np.asarray(seed_vertices, dtype=np.int64))
    seen_v[seeds] = True
    frontier = seeds
    for _ in range(num_hops):
        eids = csr.in_edges_of(frontier)
        eids = eids[~need_edge[eids]]
        if eids.size == 0:
            break
        need_edge[eids] = True
        nxt = np.unique(part.dst[eids].astype(np.int64))
        frontier = nxt[~seen_v[nxt]]
        seen_v[nxt] = True
    return np.nonzero(seen_v)[0], np.nonzero(need_edge)[0]


# ====================================================================== #
# Fixed-shape mini-batch
# ====================================================================== #
@dataclasses.dataclass
class EdgeMiniBatch:
    """One padded edge mini-batch.  All ids are BATCH-LOCAL; ``gather_ids``
    maps batch-local vertex ids to partition-local ids (for the embedding /
    feature gather)."""

    gather_ids: np.ndarray    # (V_b,) int32 partition-local vertex ids
    gather_global: np.ndarray  # (V_b,) int32 GLOBAL entity ids (for the
                               # shared embedding/feature table gather)
    vertex_mask: np.ndarray   # (V_b,) bool
    comp_src: np.ndarray      # (E_b,) int32 batch-local
    comp_rel: np.ndarray      # (E_b,) int32
    comp_dst: np.ndarray      # (E_b,) int32 batch-local
    comp_mask: np.ndarray     # (E_b,) bool
    triplets: np.ndarray      # (T_b, 3) int32 batch-local (s, r, t)
    labels: np.ndarray        # (T_b,) float32 1=positive 0=negative
    triplet_mask: np.ndarray  # (T_b,) bool


def _pad1(x: np.ndarray, n: int, fill=0) -> np.ndarray:
    out = np.full((n,) + x.shape[1:], fill, dtype=x.dtype)
    out[: x.shape[0]] = x[:n]
    return out


def build_edge_minibatch(
    part: SelfSufficientPartition,
    triplets: np.ndarray,       # (T, 3) partition-local
    labels: np.ndarray,         # (T,)
    num_hops: int,
    max_vertices: int,
    max_edges: int,
    max_triplets: int,
    csr: Optional[_PartitionCSR] = None,
) -> EdgeMiniBatch:
    """Build one padded mini-batch: comp graph over the triplet endpoints,
    relabeled to batch-local ids."""
    seeds = np.unique(triplets[:, [0, 2]].reshape(-1))
    verts, eids = build_comp_graph(part, seeds, num_hops, csr)
    if verts.shape[0] > max_vertices or eids.shape[0] > max_edges:
        raise ValueError(
            f"comp graph ({verts.shape[0]} v, {eids.shape[0]} e) exceeds "
            f"budget ({max_vertices} v, {max_edges} e); raise the budget "
            f"(measured maxima are auto-derived by plan_budgets)")
    # batch-local relabel
    p2b = np.full(part.num_local_vertices, -1, dtype=np.int64)
    p2b[verts] = np.arange(verts.shape[0])
    t = triplets.shape[0]
    bt = np.stack(
        [p2b[triplets[:, 0]], triplets[:, 1].astype(np.int64),
         p2b[triplets[:, 2]]], axis=1)
    assert (bt[:, [0, 2]] >= 0).all(), "triplet endpoint missing in comp graph"

    return EdgeMiniBatch(
        gather_ids=_pad1(verts.astype(np.int32), max_vertices),
        gather_global=_pad1(
            part.local_to_global[verts].astype(np.int32), max_vertices),
        vertex_mask=_pad1(np.ones(verts.shape[0], bool), max_vertices,
                          fill=False),
        comp_src=_pad1(p2b[part.src[eids]].astype(np.int32), max_edges),
        comp_rel=_pad1(part.rel[eids], max_edges),
        comp_dst=_pad1(p2b[part.dst[eids]].astype(np.int32), max_edges),
        comp_mask=_pad1(np.ones(eids.shape[0], bool), max_edges, fill=False),
        triplets=_pad1(bt.astype(np.int32), max_triplets),
        labels=_pad1(labels.astype(np.float32)[:max_triplets], max_triplets),
        triplet_mask=_pad1(np.ones(t, bool), max_triplets, fill=False),
    )


def _round_up(x: int, m: int) -> int:
    return max(m, ((x + m - 1) // m) * m)


@dataclasses.dataclass
class BatchBudget:
    max_vertices: int
    max_edges: int
    max_triplets: int


def negatives_of_positives(
    neg: np.ndarray, take: np.ndarray, num_negatives: int,
) -> np.ndarray:
    """Rows of the epoch negative table belonging to positive edges ``take``
    — the pairing ``iterate_edge_minibatches`` uses (``s`` consecutive rows
    per positive)."""
    if neg.shape[0] == 0:
        return np.zeros((0, 3), np.int32)
    rows = (take[:, None] * num_negatives +
            np.arange(num_negatives)[None, :]).reshape(-1)
    return neg[rows]


def plan_budgets(
    parts: Sequence[SelfSufficientPartition],
    batch_size: int,
    num_negatives: int,
    num_hops: int,
    seed: int = 0,
    probe_batches: int = 4,
    slack: float = 1.25,
    sampler: str = "constraint",
) -> BatchBudget:
    """Probe a few random batches per partition to size the fixed budgets
    (then add slack and 128-align).  This replaces DGL's dynamic allocation:
    budgets are a compile-time contract.

    Probes pair each sampled positive with ITS OWN epoch negatives (the
    ``s``-consecutive-rows pairing ``iterate_edge_minibatches`` uses), not
    with the first ``batch*s`` rows of the epoch table — the latter probes a
    different seed set than training ever builds and can under-measure the
    comp-graph budget."""
    rng = np.random.default_rng(seed)
    v_hi, e_hi = 1, 1
    t_hi = batch_size * (1 + num_negatives)
    for part in parts:
        csr = _PartitionCSR(part)
        pos = part.core_edges_local()
        neg = sample_epoch_negatives(rng, part, num_negatives, sampler)
        for _ in range(probe_batches):
            take = rng.choice(pos.shape[0],
                              size=min(batch_size, pos.shape[0]),
                              replace=False)
            batch_pos = pos[take]
            batch_neg = negatives_of_positives(neg, take, num_negatives)
            seeds = np.unique(
                np.concatenate([batch_pos[:, [0, 2]].reshape(-1),
                                batch_neg[:, [0, 2]].reshape(-1)]))
            verts, eids = build_comp_graph(part, seeds, num_hops, csr)
            v_hi = max(v_hi, verts.shape[0])
            e_hi = max(e_hi, eids.shape[0])
    return BatchBudget(
        max_vertices=_round_up(int(v_hi * slack), 8),
        max_edges=_round_up(int(e_hi * slack), 128),
        max_triplets=_round_up(t_hi, 128),
    )


def num_edge_minibatches(part: SelfSufficientPartition,
                         batch_size: int) -> int:
    """The batches :func:`iterate_edge_minibatches` yields for ``part`` in
    an epoch: ``ceil(core edges / batch_size)``, known before any is
    built."""
    return -(-int(np.count_nonzero(part.core_edge_mask)) // batch_size)


def iterate_edge_minibatches(
    rng: np.random.Generator,
    part: SelfSufficientPartition,
    batch_size: int,
    num_negatives: int,
    num_hops: int,
    budget: BatchBudget,
    csr: Optional[_PartitionCSR] = None,
    sampler: str = "constraint",
) -> Iterator[EdgeMiniBatch]:
    """One epoch of Algorithm 1 on one partition: epoch negatives, shuffled
    positive batches, each with its ``s`` negatives and comp graph."""
    csr = csr or _PartitionCSR(part)
    pos = part.core_edges_local()
    e = pos.shape[0]
    neg = sample_epoch_negatives(rng, part, num_negatives, sampler)
    perm = rng.permutation(e)
    for lo in range(0, e, batch_size):
        take = perm[lo: lo + batch_size]
        batch_pos = pos[take]
        # negatives of these positives (s per positive, epoch-sampled)
        batch_neg = negatives_of_positives(neg, take, num_negatives)
        trip = np.concatenate([batch_pos, batch_neg], axis=0)
        labels = np.concatenate(
            [np.ones(batch_pos.shape[0], np.float32),
             np.zeros(batch_neg.shape[0], np.float32)])
        yield build_edge_minibatch(
            part, trip, labels, num_hops,
            budget.max_vertices, budget.max_edges, budget.max_triplets, csr)


def stack_minibatches(batches: Sequence[EdgeMiniBatch]) -> EdgeMiniBatch:
    """Stack one mini-batch per partition on a leading trainer axis — the
    array sharded over the ``data`` mesh axis in the SPMD step."""
    def s(name):
        return np.stack([getattr(b, name) for b in batches], axis=0)
    return EdgeMiniBatch(**{
        f.name: s(f.name) for f in dataclasses.fields(EdgeMiniBatch)})
