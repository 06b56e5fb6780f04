"""Filtered link-prediction evaluation (port of ``repro/eval/ranking.py``:
the all-entities protocol and the ogbl candidate-list protocol, dense or
sharded; paper §4.2, Eq. 5-6).

Filtered link prediction masks every candidate that forms a KNOWN positive.
The filter is a ``CSRFilterIndex``: known (s, r) pairs as a sorted int64 key
array plus a CSR ``indptr`` into one flat ``tails`` array, built with one
lexsort and applied with one searchsorted + one scatter per batch. Its
COLUMN-RANGE ``bias`` builds one block of the bias straight from CSR, which
is how the sharded serving path gets per-shard bias blocks without the
dense ``(B, N)`` matrix. ``build_filter_index`` keeps the dict-of-sets
reference form. The index is host numpy.

Ranking scores each batch of queries against every entity through the
``kge_score`` kernel (``Decoder.rank_scores``) with the batch's filter bias
and counts, per query, the candidates scoring above and equal to the true
tail: ``rank = 1 + #greater + 0.5 · #equal`` (ties excluding the true
tail itself), the reference's tie-aware mean rank.

The ogbl candidate-list protocol (ogbl-citation2's: each test edge comes
with its own list of negative tails, which excludes the true one) scores
each query against its true tail and its ``(C,)`` list only: the gathered
``(B, 1 + C, d)`` rows in the decoder's query form, one batched product
plus the rank-1 biases (:func:`candidate_scores`), then the epilogue. The
reference computes this product outside its Pallas kernel, and so does
the port.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.graph import KnowledgeGraph
from repro_torch.device import resolve_device
from repro_torch.kernels.kge_score import apply_epilogue
from repro_torch.models.decoders import Decoder, get_decoder

# Additive score mask for filtered-out candidates: large-negative rather
# than -inf so a filtered candidate loses cleanly without inf-inf NaNs; pad
# rows (never real candidates) use -inf.
FILTER_BIAS = -1e9


def build_filter_index(graphs: Iterable[KnowledgeGraph]) -> Dict:
    """(s, r) -> set of known-true tails, over all splits — the
    per-triplet reference form the CSR index is tested against."""
    idx: Dict = {}
    for g in graphs:
        for s, r, t in g.triplets():
            idx.setdefault((int(s), int(r)), set()).add(int(t))
    return idx


@dataclasses.dataclass(frozen=True)
class CSRFilterIndex:
    """Vectorized ``(s, r) → known tails`` filter index in CSR form.

    ``keys`` holds every known (s, r) pair encoded as ``s * num_relations
    + r`` (int64, sorted, unique); ``tails[indptr[k]:indptr[k+1]]`` are the
    known-true tails of ``keys[k]`` (deduplicated).
    """

    keys: np.ndarray        # (K,) int64, sorted unique s * num_relations + r
    indptr: np.ndarray      # (K + 1,) int64
    tails: np.ndarray       # (nnz,) int32, grouped by key
    num_relations: int      # key encoding stride (covers inverse relations)

    @classmethod
    def build(cls, graphs: Iterable[KnowledgeGraph],
              num_relations: Optional[int] = None) -> "CSRFilterIndex":
        """Build from all splits' triplets with one lexsort (duplicates —
        across splits or within one — are dropped)."""
        graphs = list(graphs)
        if num_relations is None:
            num_relations = max(
                [int(g.num_relations) for g in graphs], default=1)
        if graphs:
            cat = np.concatenate([g.triplets() for g in graphs], axis=0)
        else:
            cat = np.zeros((0, 3), np.int32)
        key = cat[:, 0].astype(np.int64) * num_relations + cat[:, 1]
        tail = cat[:, 2].astype(np.int32)
        order = np.lexsort((tail, key))
        key, tail = key[order], tail[order]
        if key.size:
            keep = np.ones(key.size, bool)
            keep[1:] = (key[1:] != key[:-1]) | (tail[1:] != tail[:-1])
            key, tail = key[keep], tail[keep]
        ukeys, starts = np.unique(key, return_index=True)
        indptr = np.concatenate(
            [starts, [key.size]]).astype(np.int64)
        return cls(keys=ukeys, indptr=indptr, tails=tail,
                   num_relations=int(num_relations))

    @property
    def num_pairs(self) -> int:
        return int(self.keys.shape[0])

    def _check_rel(self, r) -> None:
        # s * num_relations + r is injective only for r < num_relations:
        # an out-of-range relation would silently hit another pair's tails
        r = np.asarray(r)
        if np.any(r >= self.num_relations) or np.any(r < 0):
            raise ValueError(
                f"query relation id outside [0, {self.num_relations}) — "
                f"build the index over the same (inverse-augmented) "
                f"relation vocabulary it is queried with")

    def _stride(self) -> int:
        """Exclusive upper bound on stored tail ids (cached): a column
        range reaching it covers every tail."""
        cached = getattr(self, "_stride_cache", None)
        if cached is None:
            cached = int(self.tails.max()) + 1 if self.tails.size else 1
            object.__setattr__(self, "_stride_cache", cached)
        return cached

    def _range_index(self) -> np.ndarray:
        """``aug[i] = segment(i) * stride + tails[i]``: globally
        non-decreasing, so each query's in-range tail span is two
        ``searchsorted``s. Built on the first sub-range query and
        cached."""
        cached = getattr(self, "_range_cache", None)
        if cached is not None:
            return cached
        seg = np.repeat(np.arange(self.num_pairs, dtype=np.int64),
                        np.diff(self.indptr))
        aug = seg * self._stride() + self.tails
        object.__setattr__(self, "_range_cache", aug)
        return aug

    def resolve_queries(
            self, triplets: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Per-row key positions for a batch: ``(pos, found)`` with
        ``keys[pos[i]]`` the row's (s, r) key where ``found[i]``. Shared by
        every column-range ``bias`` block of the batch."""
        trip = np.asarray(triplets)
        b = trip.shape[0]
        if b == 0 or self.num_pairs == 0:
            return (np.zeros(b, np.int64), np.zeros(b, bool))
        self._check_rel(trip[:, 1])
        q = trip[:, 0].astype(np.int64) * self.num_relations + trip[:, 1]
        pos = np.searchsorted(self.keys, q)
        pos_c = np.minimum(pos, self.num_pairs - 1)
        found = (pos < self.num_pairs) & (self.keys[pos_c] == q)
        return pos_c, found

    def tails_of(self, s: int, r: int) -> np.ndarray:
        """Known tails of one (s, r) pair (empty if absent)."""
        self._check_rel(r)
        q = np.int64(s) * self.num_relations + r
        k = int(np.searchsorted(self.keys, q))
        if k >= self.num_pairs or self.keys[k] != q:
            return np.zeros(0, np.int32)
        return self.tails[self.indptr[k]: self.indptr[k + 1]]

    def bias(self, triplets: np.ndarray, num_cols: int,
             col_start: int = 0,
             resolved: Optional[Tuple[np.ndarray, np.ndarray]] = None
             ) -> np.ndarray:
        """(B, num_cols) float32 filter bias covering global candidate
        columns ``[col_start, col_start + num_cols)``: ``FILTER_BIAS`` on
        every known tail of each row's (s, r), 0 elsewhere — and 0 on the
        row's own true tail (serving passes the sentinel ``t = -1``, so
        every known tail is filtered). Columns at or beyond the vocabulary
        stay 0; a caller with padded rows there masks them itself.
        ``resolved`` is a cached ``resolve_queries`` result."""
        trip = np.asarray(triplets)
        b = trip.shape[0]
        out = np.zeros((b, num_cols), np.float32)
        if b == 0 or num_cols == 0 or self.num_pairs == 0:
            return out
        pos_c, found = (self.resolve_queries(trip) if resolved is None
                        else resolved)
        if col_start <= 0 and col_start + num_cols >= self._stride():
            # full range: spans come straight off indptr
            starts = np.where(found, self.indptr[pos_c], 0)
            counts = np.where(found, self.indptr[pos_c + 1] - starts, 0)
        else:
            # each query's IN-RANGE tail span via the augmented range index
            stride, aug = self._stride(), self._range_index()
            lo_q = min(max(col_start, 0), stride)
            hi_q = min(max(col_start + num_cols, 0), stride)
            starts = np.searchsorted(aug, pos_c * stride + lo_q)
            ends = np.searchsorted(aug, pos_c * stride + hi_q)
            counts = np.where(found, ends - starts, 0)
            starts = np.where(found, starts, 0)
        total = int(counts.sum())
        if total:
            rows = np.repeat(np.arange(b), counts)
            csum = np.concatenate([[0], np.cumsum(counts)[:-1]])
            flat = np.repeat(starts - csum, counts) + np.arange(total)
            out[rows, self.tails[flat] - col_start] = FILTER_BIAS
        t = trip[:, 2]
        in_range = (t >= col_start) & (t < col_start + num_cols)
        out[np.nonzero(in_range)[0], t[in_range] - col_start] = 0.0
        return out


FilterIndex = Union[Dict, CSRFilterIndex]


def _filter_bias(filter_index: FilterIndex, batch: np.ndarray,
                 num_cols: int, col_start: int = 0,
                 resolved=None) -> np.ndarray:
    """(B, num_cols) bias covering global candidate columns
    ``[col_start, col_start + num_cols)`` from either index form."""
    if isinstance(filter_index, CSRFilterIndex):
        return filter_index.bias(batch, num_cols, col_start, resolved)
    bias = np.zeros((batch.shape[0], num_cols), np.float32)
    for i, (s, r, t) in enumerate(batch):
        known = filter_index.get((int(s), int(r)), ())
        for k in known:
            if k != int(t) and col_start <= k < col_start + num_cols:
                bias[i, k - col_start] = FILTER_BIAS
    return bias


# ====================================================================== #
# Filtered ranking (paper §4.2, Eq. 5-6)
# ====================================================================== #
def mean_rank(greater, equal_incl_true) -> np.ndarray:
    """Tie-aware rank from candidate counts: ``1 + #greater + 0.5 · (#equal
    − 1)``, where ``equal_incl_true`` counts the true candidate's own
    tie."""
    return 1.0 + np.asarray(greater, np.float64) \
        + 0.5 * (np.asarray(equal_incl_true, np.float64) - 1.0)


def metrics_from_ranks(ranks: np.ndarray,
                       hits_ks: Sequence[int]) -> Dict[str, float]:
    ranks = np.asarray(ranks, np.float64)
    out = {"mrr": float(np.mean(1.0 / ranks))}
    for k in hits_ks:
        out[f"hits@{k}"] = float(np.mean(ranks <= k))
    return out


def _as_device_tensor(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).to(device)


def candidate_lanes(batch: np.ndarray, candidates: np.ndarray
                    ) -> np.ndarray:
    """``(B, 1 + C)`` int64 ids scored per query in the candidate
    protocol: the true tail in lane 0, then the row's candidate list. The
    true score comes out of the same product as the candidates', so a
    candidate whose row equals the true tail's ties it exactly."""
    return np.concatenate([np.asarray(batch)[:, 2:3],
                           np.asarray(candidates)], axis=1).astype(np.int64)


def candidate_scores(decoder: Decoder, dec_params: Dict, q: torch.Tensor,
                     q_bias: torch.Tensor, rows: torch.Tensor
                     ) -> torch.Tensor:
    """``(B, C)`` scores of prepared queries ``q (B, d)`` / ``q_bias
    (B,)`` against each query's own ``(B, C, d)`` candidate rows: the
    reference's ``einsum("bd,bcd->bc")`` plus the rank-1 biases, then the
    epilogue, in full fp32 on the card (TF32 off). A score depends only on
    its query and its row, so every caller of one ``(B, C)`` shape gets
    the same bits for the same pair (the sharded protocol relies on it)."""
    if q.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    cand, c_bias = decoder.prepare_candidates(dec_params, rows)
    return apply_epilogue(torch.einsum("bd,bcd->bc", q, cand)
                          + q_bias[:, None] + c_bias, decoder.epilogue)


def ranking_metrics(entity_emb, decoder_params: Dict,
                    test_triplets: np.ndarray, filter_index: FilterIndex,
                    hits_ks: Sequence[int] = (1, 3, 10),
                    candidates: Optional[np.ndarray] = None,
                    batch_size: int = 256,
                    decoder: Union[str, Decoder] = "distmult",
                    num_shards: int = 1, table_dtype: str = "fp32",
                    device=None, rank_step=None,
                    num_entities: Optional[int] = None) -> Dict[str, float]:
    """Filtered MRR / Hits@k, tail-corruption direction. All-entities
    protocol (``candidates=None``): every batch of ``batch_size`` queries
    is one ``kge_score`` launch over all N candidates in the decoder's
    query form, with the batch's filter bias built on the host. ogbl
    candidate-list protocol (``candidates``, ``(T, C)`` negative tail ids
    per test triplet, the true tail not among them): each query against
    its own list (:func:`candidate_scores`), no filter. ``device`` defaults
    to the table's own when it is a tensor, else to ``cuda``.
    ``num_shards > 1`` ranks candidate-axis-sharded over the row-sharded
    table (``repro_torch.eval.sharded``), in either protocol, with exactly
    the dense metrics. An int8 table always takes the sharded path, one
    shard included: its block-at-a-time dequantization keeps the fp32
    table off the device, and the metrics are exactly the dense ones over
    the dequantized table. So does a ``rank_step``
    (``eval.sharded.make_sharded_rank_step``): the ranks of its model axis
    rank together, each over its own row block, which is then
    ``entity_emb`` (``(1, rows, d)``, of a table of ``num_entities``
    rows)."""
    if num_shards > 1 or table_dtype != "fp32" or rank_step is not None:
        from repro_torch.eval.sharded import sharded_ranking_metrics
        return sharded_ranking_metrics(
            entity_emb, decoder_params, test_triplets, filter_index,
            max(num_shards, 1), hits_ks=hits_ks, batch_size=batch_size,
            decoder=decoder, candidates=candidates, table_dtype=table_dtype,
            device=device, rank_step=rank_step, num_entities=num_entities)
    if device is None and isinstance(entity_emb, torch.Tensor):
        device = entity_emb.device
    dev = resolve_device(device)
    dec = get_decoder(decoder)
    emb = _as_device_tensor(entity_emb, dev)
    n = emb.shape[0]
    dparams = {k: _as_device_tensor(v, dev)
               for k, v in decoder_params.items()}
    # the candidate side is row-local: prepared once for all entities, or,
    # in the candidate protocol, per batch from the gathered rows
    prepared = (dec.prepare_candidates(dparams, emb)
                if candidates is None else None)
    ranks = []
    for lo in range(0, test_triplets.shape[0], batch_size):
        batch = np.asarray(test_triplets[lo: lo + batch_size])
        idx = torch.from_numpy(batch.astype(np.int64)).to(dev)
        if candidates is not None:
            ids = torch.from_numpy(candidate_lanes(
                batch, candidates[lo: lo + batch_size])).to(dev)
            q, q_bias = dec.prepare_query(dparams, emb[idx[:, 0]],
                                          idx[:, 1])
            scores = candidate_scores(dec, dparams, q, q_bias, emb[ids])
            true = scores[:, :1]
            greater = (scores[:, 1:] > true).sum(1)
            equal = (scores[:, 1:] == true).sum(1)
            # the lists exclude the true tail: add its own tie back
            ranks.append(mean_rank(greater.cpu().numpy(),
                                   equal.cpu().numpy() + 1))
            continue
        bias = torch.from_numpy(_filter_bias(filter_index, batch, n)).to(dev)
        scores = dec.rank_scores(dparams, emb[idx[:, 0]], idx[:, 1], emb,
                                 bias, prepared=prepared)
        true = scores[torch.arange(batch.shape[0], device=dev), idx[:, 2]]
        greater = (scores > true[:, None]).sum(1)
        # the true candidate's own column always ties (bias 0 there)
        equal = (scores == true[:, None]).sum(1)
        ranks.append(mean_rank(greater.cpu().numpy(), equal.cpu().numpy()))
    return metrics_from_ranks(np.concatenate(ranks), hits_ks)


def evaluate_both_directions(
    entity_emb, decoder_params: Dict, test_kg: KnowledgeGraph,
    filter_graphs: Sequence[KnowledgeGraph], num_relations_base: int,
    hits_ks: Sequence[int] = (1, 3, 10),
    decoder: Union[str, Decoder] = "distmult", num_shards: int = 1,
    table_dtype: str = "fp32", device=None,
    rank_step=None, num_entities: Optional[int] = None) -> Dict[str, float]:
    """Mean of tail corruption on (s, r, t) and on the inverse triplets
    (t, r + R, s), i.e. head corruption. The decoder's relation tables
    cover the doubled vocabulary; one CSR filter index over all splits
    (inverse relations included) serves both directions. With a
    ``rank_step`` ``entity_emb`` is this rank's ``(1, rows, d)`` row block
    of a ``num_entities``-row table (:func:`ranking_metrics`)."""
    fidx = CSRFilterIndex.build(
        [g.with_inverse_relations() for g in filter_graphs])
    kw = dict(decoder=decoder, num_shards=num_shards,
              table_dtype=table_dtype, device=device, rank_step=rank_step,
              num_entities=num_entities)
    m_fwd = ranking_metrics(entity_emb, decoder_params, test_kg.triplets(),
                            fidx, hits_ks, **kw)
    inv = np.stack([test_kg.dst, test_kg.rel + num_relations_base,
                    test_kg.src], axis=1)
    m_inv = ranking_metrics(entity_emb, decoder_params, inv, fidx, hits_ks,
                            **kw)
    return {k: 0.5 * (m_fwd[k] + m_inv[k]) for k in m_fwd}
