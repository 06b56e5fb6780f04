"""KGE serving CLI: the sharded top-k engine under a request stream
(port of ``repro/launch/serve.py``).

Stands up a :class:`repro_torch.serving.ShardedKGEServer` over a synthetic
entity table and decoder parameters (both drawn from numpy generators
seeded by ``--seed``), wraps it in the dynamic-batching
:class:`repro_torch.serving.KGEServeEngine`, and drives a Zipf-skewed query
stream through it — printing p50/p99 request latency and QPS, the
engine's phases and counts (the spans and counters of
:mod:`repro_torch.tracing`, recorded over the stream), and the
sharded == dense top-k equality check (over the dequantized table with
``--table-dtype int8``). The process exits non-zero when the check fails.
Runs on the GPU unless ``--device cpu`` is given.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --table-shards 4
  PYTHONPATH=src python -m repro_torch.launch.serve --decoder rotate \
      --filtered --cache-size 256 --requests 200
  PYTHONPATH=src python -m repro_torch.launch.serve --table-shards 4 \
      --table-dtype int8 --filtered --cache-size 256
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    from repro_torch.models.decoders import registered_decoders

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--entities", type=int, default=5000)
    ap.add_argument("--relations", type=int, default=16)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--decoder", default="distmult",
                    choices=registered_decoders())
    ap.add_argument("--table-shards", type=int, default=1,
                    help="row-shard the entity table over this many "
                         "candidate-axis shards (the (B, N) score matrix "
                         "is never materialized for any value)")
    ap.add_argument("--topk", type=int, default=10,
                    help="engine-wide max k (per-request k is clamped to "
                         "it)")
    ap.add_argument("--slots", type=int, default=8,
                    help="dynamic-batching width — requests per step")
    ap.add_argument("--policy", default="fifo",
                    choices=("fifo", "smallest-k-first"),
                    help="admission policy (smallest-k-first decouples "
                         "completion from submission order)")
    ap.add_argument("--filtered", action="store_true",
                    help="filter known tails via the column-range "
                         "CSRFilterIndex bias (serving sentinel t=-1)")
    ap.add_argument("--table-dtype", default="fp32",
                    choices=("fp32", "int8"),
                    help="entity-table storage: int8 keeps only row-wise "
                         "int8 codes and fp32 power-of-two scales on the "
                         "device and dequantizes one shard block at a time")
    ap.add_argument("--cache-size", type=int, default=0,
                    help="hot-entity head-embedding LRU entries "
                         "(0 disables; bits never change)")
    ap.add_argument("--requests", type=int, default=100)
    ap.add_argument("--zipf", type=float, default=1.3,
                    help="head-entity skew of the query stream")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the server runs; cuda raises when no GPU is "
                         "available")
    return ap.parse_args(argv)


def build_server(args: argparse.Namespace):
    """``(server, emb, params)``: the server over a synthetic ``(N, d)``
    table drawn from ``--seed`` (as ``repro.launch.serve`` draws it) and
    decoder parameters from a second numpy stream of the same seed."""
    from repro_torch.core.graph import KnowledgeGraph
    from repro_torch.eval.ranking import CSRFilterIndex
    from repro_torch.models.decoders import init_decoder_params
    from repro_torch.serving import ShardedKGEServer

    rng = np.random.default_rng(args.seed)
    emb = rng.normal(scale=0.1, size=(args.entities, args.dim)
                     ).astype(np.float32)
    params = init_decoder_params(np.random.default_rng((args.seed, 1)),
                                 args.decoder, args.relations, args.dim)
    filter_index = None
    if args.filtered:
        e = max(args.entities * 4, 64)   # synthetic known-triplet store
        g = KnowledgeGraph(src=rng.integers(0, args.entities, e),
                           rel=rng.integers(0, args.relations, e),
                           dst=rng.integers(0, args.entities, e),
                           num_entities=args.entities,
                           num_relations=args.relations)
        filter_index = CSRFilterIndex.build([g])
    server = ShardedKGEServer(
        emb, params, args.decoder, num_shards=args.table_shards,
        filter_index=filter_index, cache_size=args.cache_size,
        table_dtype=args.table_dtype, device=args.device)
    return server, emb, params


def check_equal_dense(server, emb: np.ndarray, params,
                      args: argparse.Namespace) -> bool:
    """The serving contract: sharded top-k == dense top-k (over the
    dequantized table for ``--table-dtype int8``: dequantization is an
    exact product, so equality stays exact). The dense reference scores
    all N columns in one block through the same ``kge_score`` path and
    selects with the plain top-k."""
    from repro_torch.kernels.topk import topk_plain
    from repro_torch.models.decoders import get_decoder
    from repro_torch.sharding.embedding import dequantize_rows, quantize_rows

    rng = np.random.default_rng(args.seed + 1)
    heads = rng.integers(0, args.entities, args.slots)
    rels = rng.integers(0, args.relations, args.slots)
    k = min(args.topk, args.entities)
    table = torch.from_numpy(emb).to(server.device)
    if args.table_dtype == "int8":
        table = dequantize_rows(*quantize_rows(table))
    dense = get_decoder(args.decoder).rank_scores(
        server.params, table[torch.from_numpy(heads).to(server.device)],
        torch.from_numpy(rels).to(server.device), table)
    _, want = topk_plain(dense, k)
    _, got = server.topk_tails(heads, rels, k)
    return bool((got == want.cpu().numpy()).all())


def run(args: argparse.Namespace) -> Dict[str, float]:
    """Serve the request stream and check sharded == dense. Returns the
    latency numbers, the stored table's device bytes and
    ``equal_dense``."""
    from repro_torch import tracing
    from repro_torch.device import resolve_device
    from repro_torch.serving import KGEServeEngine

    resolve_device(args.device)      # no GPU and no --device cpu: raise now
    server, emb, params = build_server(args)
    engine = KGEServeEngine(server, slots=args.slots, max_k=args.topk,
                            filtered=args.filtered, policy=args.policy)
    print(f"[serve] {args.decoder} over {args.entities} entities, "
          f"{args.table_shards}-shard table "
          f"(rows/shard={server.layout.rows_per_shard}), "
          f"slots={args.slots}, max_k={engine.max_k}, "
          f"device={server.device}"
          + (", int8 table" if args.table_dtype == "int8" else "")
          + (", filtered" if args.filtered else "")
          + (f", cache={args.cache_size}" if args.cache_size else "")
          + f"; table {server.table_bytes} bytes")

    rng = np.random.default_rng(args.seed + 2)
    heads = np.minimum(rng.zipf(args.zipf, args.requests) - 1,
                       args.entities - 1)
    rels = rng.integers(0, args.relations, args.requests)

    # warmup: builds the kernels and the fixed-width batch buffers once
    engine.submit(int(heads[0]), int(rels[0]), k=engine.max_k)
    engine.run()

    lat = []
    tracing.reset()
    t_start = time.perf_counter()
    with tracing.recording():
        for lo in range(0, args.requests, args.slots):
            for i in range(lo, min(lo + args.slots, args.requests)):
                engine.submit(int(heads[i]), int(rels[i]), k=engine.max_k)
            t0 = time.perf_counter()
            done = engine.run()     # answers on the host: synchronous
            dt = time.perf_counter() - t0
            lat.extend([dt] * len(done))     # batch-synchronous latency
    wall = time.perf_counter() - t_start
    lat_ms = np.sort(np.array(lat) * 1e3)
    out = {"requests": args.requests, "wall_s": wall,
           "qps": args.requests / wall,
           "p50_ms": float(np.percentile(lat_ms, 50)),
           "p99_ms": float(np.percentile(lat_ms, 99)),
           "cache_hits": server.cache_hits,
           "cache_misses": server.cache_misses,
           "table_bytes": server.table_bytes}
    print(f"[serve] {args.requests} requests in {wall:.2f}s — "
          f"{out['qps']:.1f} QPS, "
          f"p50={out['p50_ms']:.2f}ms p99={out['p99_ms']:.2f}ms")
    print("[serve] the engine's phases and counts (repro_torch.tracing):\n"
          + tracing.table(tracing.snapshot()))
    if args.cache_size:
        tot = server.cache_hits + server.cache_misses
        print(f"[serve] head cache: {server.cache_hits}/{tot} hits "
              f"({server.cache_hits / max(tot, 1):.0%})")
    out["equal_dense"] = check_equal_dense(server, emb, params, args)
    print(f"[serve] sharded top-k == dense top-k: {out['equal_dense']}")
    return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    result = run(parse_args(argv))
    if not result["equal_dense"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
