"""Sharded top-k link-prediction serving (port of ``repro/serving/kge.py``).

* ``ShardedKGEServer`` — candidate-axis-sharded scoring plus per-shard
  top-k. The entity table is row-sharded once; each shard's ``(B, rows/S)``
  score block comes from the ``kge_score`` kernel over the shard's prepared
  rows (cached at construction), is reduced to ``(B, k')`` at once by the
  ``topk`` kernel, and the ``S · k'`` winners are merged with one more
  top-k — the dense ``(B, N)`` score matrix never exists.

* Exactness: merged indices EXACTLY equal the dense top-k for every
  decoder at any shard count. (1) Preparation is row-local and each score
  is one fixed-order sum, so each shard's block is bitwise the matching
  dense columns; (2) the selection (max over active columns, LOWEST index
  wins ties, winner deactivated) does no arithmetic; (3) shard row blocks
  are contiguous ascending id ranges and per-shard lists are lowest-local-
  index ordered, so among equal merged values a lower concat position is a
  lower global id. Per-shard ``k' = min(k, rows/S)`` suffices.

* Filtered serving: per-shard bias blocks from the column-range
  ``CSRFilterIndex`` form with the sentinel true tail ``t = -1``, so EVERY
  known tail of ``(h, r)`` is filtered. Layout-padded rows are ``-inf``.

* ``KGEServeEngine`` — dynamic batching: queued requests fill a fixed
  ``slots``-wide batch (pad slots repeat a dummy query), every step computes
  the engine-wide ``max_k``, and each request gets its own leading ``k``
  columns. Responses attach to the submitted ``KGEQuery`` objects.

* Hot-entity cache: ``cache_size > 0`` keeps an LRU of head-embedding rows
  on the host and gathers only the misses through the sharded gather
  (deduplicated, bucket-padded). Cached rows are the gather's own output,
  so the cache changes latency, never bits.

* int8 tables (``table_dtype="int8"``): only the codes and the per-row
  scales live on the device. Each request dequantizes one shard's block at
  a time and prepares its candidates there; heads come through the fused
  dequantizing gather. Dequantization is one exact product per element,
  so the answers are exactly the dense top-k over the dequantized table.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.device import resolve_device
from repro_torch.eval.ranking import CSRFilterIndex
from repro_torch.eval.sharded import shard_filter_bias_block, shard_scores
from repro_torch.kernels.ops import merge_topk, topk_padded
from repro_torch.eval.sharded import table_block, table_rows
from repro_torch.models.decoders import Decoder, get_decoder
from repro_torch.sharding.embedding import (
    TABLE_DTYPES, ShardedTableLayout, plan_local_gather, plan_unique_gather,
    quantize_rows, shard_table,
)


class ShardedKGEServer:
    """Top-k tails over the row-sharded entity table, for any registered
    decoder; peak score memory is one ``(B, rows/S)`` block per shard.

    ``entity_emb`` is the ``(N, d)`` table and ``decoder_params`` the
    decoder's parameter dictionary (numpy arrays or tensors; see
    ``repro_torch.convert.from_jax``). ``filter_index`` (a
    ``CSRFilterIndex`` or the dict form) enables ``filtered=True``;
    ``cache_size`` bounds the head-embedding LRU (0 disables it).
    ``table_dtype="int8"`` keeps only row-wise int8 codes and fp32 scales
    on the device. Runs on ``device`` (default ``cuda``)."""

    def __init__(self, entity_emb, decoder_params,
                 decoder: Union[str, Decoder] = "distmult", *,
                 num_shards: int = 1, filter_index=None,
                 cache_size: int = 0, table_dtype: str = "fp32",
                 device=None):
        if table_dtype not in TABLE_DTYPES:
            raise ValueError(
                f"table_dtype={table_dtype!r} not in {TABLE_DTYPES}")
        self.device = resolve_device(device)
        self.decoder = get_decoder(decoder)
        self.table_dtype = table_dtype
        emb = torch.as_tensor(entity_emb, dtype=torch.float32)
        self.num_entities, self.dim = emb.shape
        self.layout = ShardedTableLayout(self.num_entities, num_shards)
        self.params = {name: torch.as_tensor(p).to(self.device, copy=True)
                       for name, p in decoder_params.items()}
        self.filter_index = filter_index
        if table_dtype == "int8":
            # only codes and scales are kept; candidates are prepared per
            # request from one dequantized shard block at a time
            self.table = quantize_rows(shard_table(emb.to(self.device),
                                                   self.layout))
            self._prepared = None
        else:
            self.table = shard_table(emb.to(self.device, copy=True),
                                     self.layout)
            self._prepared = [
                self.decoder.prepare_candidates(self.params, self.table[s])
                for s in range(self.layout.num_shards)]
        # per-shard base bias: -inf on layout-padded tail columns, 0 on
        # real rows — shared by every unfiltered batch
        rows = self.layout.rows_per_shard
        pad = np.zeros((self.layout.num_shards, rows), np.float32)
        for s in range(self.layout.num_shards):
            lo, hi = self.layout.shard_row_span(s)
            pad[s, hi - lo:] = -np.inf
        self._pad_bias = torch.from_numpy(pad).to(self.device)
        # the unfiltered (S, B, rows) bias stack, built once per batch
        # width on the device: the values are the broadcast pad bias
        self._unfiltered_bias: Dict[int, torch.Tensor] = {}
        self._cache_size = int(cache_size)
        self._cache: "collections.OrderedDict[int, np.ndarray]" = \
            collections.OrderedDict()
        self.cache_hits = 0
        self.cache_misses = 0

    @property
    def table_bytes(self) -> int:
        """Device bytes of the stored table: the ``(S, rows, d)`` fp32
        stack, or int8 codes plus fp32 scales."""
        parts = self.table if isinstance(self.table, tuple) else (
            self.table,)
        return sum(t.numel() * t.element_size() for t in parts)

    # ------------------------------------------------------------------ #
    # head-embedding fetch (sharded gather + optional LRU)
    # ------------------------------------------------------------------ #
    def head_embeddings(self, heads: np.ndarray) -> torch.Tensor:
        """``(B, d)`` head rows via the sharded gather (the dequantizing
        one for int8) — bitwise the dense ``emb[heads]`` rows. With ``cache_size > 0`` only cache misses
        touch the gather (deduplicated and bucket-padded)."""
        heads = np.asarray(heads, np.int64)
        if self._cache_size <= 0:
            li, ow = plan_local_gather(self.layout, heads)
            return table_rows(self.table, li, ow)
        uniq = np.unique(heads)
        missing = np.array([e for e in uniq if int(e) not in self._cache],
                           np.int64)
        self.cache_hits += len(uniq) - len(missing)
        self.cache_misses += len(missing)
        if len(missing):
            li, ow, inv = plan_unique_gather(self.layout, missing)
            rows = table_rows(self.table, li, ow, inverse=inv)
            for e, row in zip(missing, rows.cpu().numpy()):
                self._cache[int(e)] = row
        for e in uniq:                       # LRU touch, then evict
            self._cache.move_to_end(int(e))
        while len(self._cache) > self._cache_size:
            self._cache.popitem(last=False)
        # rows evicted by this very batch (more unique heads than entries)
        # are fetched again next time; assemble from the pre-evict snapshot
        rows_by_id = {int(e): self._cache.get(int(e)) for e in uniq}
        if any(v is None for v in rows_by_id.values()):
            # batch larger than the cache: gather the batch directly
            li, ow = plan_local_gather(self.layout, heads)
            return table_rows(self.table, li, ow)
        host = np.stack([rows_by_id[int(e)] for e in heads])
        return torch.from_numpy(host).to(self.device)

    # ------------------------------------------------------------------ #
    # sharded top-k
    # ------------------------------------------------------------------ #
    def _bias_stack(self, heads: np.ndarray, rels: np.ndarray,
                    filtered: bool) -> torch.Tensor:
        """The batch's ``(S, B, rows)`` per-shard bias stack (``-inf`` on
        layout padding; ``FILTER_BIAS`` on known tails when filtered)."""
        b = heads.shape[0]
        if not filtered:
            stack = self._unfiltered_bias.get(b)
            if stack is None:
                stack = self._pad_bias[:, None, :].expand(
                    self.layout.num_shards, b,
                    self.layout.rows_per_shard).contiguous()
                self._unfiltered_bias[b] = stack
                tracing.count("serve.server.bias_built")
            return stack
        if self.filter_index is None:
            raise ValueError(
                "filtered=True needs a filter_index at construction")
        batch = np.stack(
            [heads.astype(np.int64), rels.astype(np.int64),
             np.full(b, -1, np.int64)], axis=1)
        resolved = (self.filter_index.resolve_queries(batch)
                    if isinstance(self.filter_index, CSRFilterIndex)
                    else None)
        bias = np.stack([
            shard_filter_bias_block(
                self.filter_index, batch, self.layout, s, resolved)
            for s in range(self.layout.num_shards)])
        tracing.count("serve.server.bias_built")
        return torch.from_numpy(bias).to(self.device)

    def topk_tails(self, heads: np.ndarray, rels: np.ndarray, k: int = 10,
                   *, filtered: bool = False
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """``(scores (B, k) f32, tails (B, k) int64)`` — ``k`` clamped to
        the vocabulary, values descending, ties broken toward the lowest
        entity id; exactly the dense top-k over the decoder's full score
        matrix, which is never materialized.

        ``filtered=True`` masks every known tail of each row's
        ``(head, relation)`` pair."""
        if k < 1:
            raise ValueError(f"k={k} must be >= 1")
        k = min(int(k), self.num_entities)
        heads = np.asarray(heads)
        rels = np.asarray(rels)
        with tracing.span("serve.server.bias"):
            bias = self._bias_stack(heads, rels, filtered)
        with tracing.span("serve.server.heads"):
            h = self.head_embeddings(heads)
        with tracing.span("serve.server.query"):
            rel = torch.from_numpy(rels.astype(np.int64)).to(self.device)
            q, q_bias = self.decoder.prepare_query(self.params, h, rel)

        rows = self.layout.rows_per_shard
        kp = min(k, rows)    # per-shard k': enough for any global winner
        vals_parts, ids_parts = [], []
        for s in range(self.layout.num_shards):
            with tracing.span("serve.server.score"):
                scores = shard_scores(self.decoder, self.params,
                                      table_block(self.table, s), q, q_bias,
                                      bias[s],
                                      prepared=None if self._prepared is None
                                      else self._prepared[s])
                v, i = topk_padded(scores, kp)
                vals_parts.append(v)
                ids_parts.append(i + s * rows)   # local → global id
        with tracing.span("serve.server.merge"):
            mv, mi = merge_topk(torch.cat(vals_parts, dim=1),
                                torch.cat(ids_parts, dim=1), k)
        with tracing.span("serve.server.fetch"):   # waits for the card
            return mv.cpu().numpy(), mi.cpu().numpy()


# ---------------------------------------------------------------------- #
# Dynamic request batching
# ---------------------------------------------------------------------- #
@dataclasses.dataclass
class KGEQuery:
    """One ``(head, relation, ?)`` request; ``scores``/``tails`` attach to
    THIS object when its batch completes."""

    request_id: int
    head: int
    relation: int
    k: int = 10
    scores: Optional[np.ndarray] = None   # (k',) descending
    tails: Optional[np.ndarray] = None    # (k',) global entity ids
    done: bool = False


ADMISSION_POLICIES = ("fifo", "smallest-k-first")


class KGEServeEngine:
    """Dynamic batching front-end over a :class:`ShardedKGEServer`:
    requests are admitted up to ``slots`` per step into one fixed-width
    batch (pad slots repeat a dummy query and are dropped), each step
    computes ``max_k`` columns, and each request receives its own leading
    ``min(k, N)`` columns. ``policy="smallest-k-first"`` batches cheap
    requests first; responses stay attached to their own request."""

    def __init__(self, server: ShardedKGEServer, *, slots: int = 8,
                 max_k: int = 10, filtered: bool = False,
                 policy: str = "fifo"):
        if policy not in ADMISSION_POLICIES:
            raise ValueError(f"unknown admission policy {policy!r}: "
                             f"one of {ADMISSION_POLICIES}")
        self.server = server
        self.slots = int(slots)
        self.max_k = min(int(max_k), server.num_entities)
        self.filtered = filtered
        self.policy = policy
        self._queue: "collections.deque[KGEQuery]" = collections.deque()
        self._next_id = 0

    def submit(self, head: int, relation: int, k: int = 10,
               request_id: Optional[int] = None) -> KGEQuery:
        """Enqueue one query; returns the (pending) request object."""
        if k < 1:
            raise ValueError(f"k={k} must be >= 1")
        if min(int(k), self.server.num_entities) > self.max_k:
            raise ValueError(
                f"k={k} exceeds the engine's max_k={self.max_k} — raise "
                f"max_k at construction")
        if request_id is None:
            request_id = self._next_id
        self._next_id = max(self._next_id, request_id) + 1
        req = KGEQuery(request_id, int(head), int(relation), int(k))
        self._queue.append(req)
        return req

    @property
    def pending(self) -> int:
        return len(self._queue)

    def step(self) -> List[KGEQuery]:
        """Admit one batch (≤ ``slots`` requests, per ``policy``), answer
        it, and return the completed requests."""
        if not self._queue:
            return []
        with tracing.span("serve.engine.step"):
            with tracing.span("serve.engine.admit"):
                tracing.count("serve.engine.queue_depth", len(self._queue))
                if self.policy == "smallest-k-first":
                    reqs = sorted(self._queue, key=lambda r: (
                        r.k, r.request_id))[:self.slots]
                    for r in reqs:
                        self._queue.remove(r)
                else:
                    reqs = [self._queue.popleft()
                            for _ in range(min(self.slots, len(self._queue)))]
                # fixed-width batch: pad slots repeat a dummy query (entity
                # and relation 0 always exist) and are dropped below
                heads = np.zeros(self.slots, np.int64)
                rels = np.zeros(self.slots, np.int64)
                for i, r in enumerate(reqs):
                    heads[i] = r.head
                    rels[i] = r.relation
                tracing.count("serve.engine.admitted", len(reqs))
                tracing.count("serve.engine.pad_slots",
                              self.slots - len(reqs))
            scores, tails = self.server.topk_tails(
                heads, rels, self.max_k, filtered=self.filtered)
            with tracing.span("serve.engine.answer"):
                for i, r in enumerate(reqs):
                    kk = min(r.k, self.server.num_entities)
                    r.scores = scores[i, :kk]
                    r.tails = tails[i, :kk]
                    r.done = True
            return reqs

    def run(self) -> List[KGEQuery]:
        """Drain the queue; returns every completed request in completion
        order."""
        out: List[KGEQuery] = []
        while self._queue:
            out.extend(self.step())
        return out
