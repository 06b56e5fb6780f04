"""The inputs a run draws from its seed and hands, the same, to the program
and to the reference: the knowledge graph of a training cell and its
splits, the entity table of a serving cell, and the request stream.

The graph is the stand-in the repository trains on (no dataset is fetched):
a Zipf-like degree distribution over the published entity count, relations
uniform, duplicates removed until the splits hold the published counts,
then a random valid / test split. The draws are
numpy's, in a fixed order, so one seed gives one graph.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def synthetic_graph(num_entities: int, num_relations: int, num_triples: int,
                    seed: int, power: float = 1.2,
                    feature_dim: Optional[int] = None) -> Dict:
    """``{"src", "rel", "dst", "features"}`` of a skewed random graph of
    exactly ``num_triples`` distinct triples, self loops moved off: triples
    are drawn in rounds until that many distinct ones were seen, and the
    first ``num_triples`` of them in draw order are kept."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, num_entities + 1, dtype=np.float64) ** power
    w /= w.sum()
    keys = np.zeros(0, np.int64)
    distinct = 0
    while distinct < num_triples:
        m = int(1.25 * (num_triples - distinct)) + 1024
        src = rng.choice(num_entities, size=m, p=w).astype(np.int64)
        dst = rng.choice(num_entities, size=m, p=w).astype(np.int64)
        loops = src == dst
        dst[loops] = (dst[loops] + 1 + rng.integers(
            0, num_entities - 1, loops.sum())) % num_entities
        rel = rng.integers(0, num_relations, size=m).astype(np.int64)
        keys = np.concatenate([keys, (src * num_relations + rel)
                               * num_entities + dst])
        _, first = np.unique(keys, return_index=True)
        distinct = first.shape[0]
    kept = np.sort(keys[np.sort(first)[:num_triples]])
    features = None
    if feature_dim is not None:
        features = rng.normal(0, 1, (num_entities, feature_dim)).astype(
            np.float32)
    src, rest = np.divmod(kept, num_relations * num_entities)
    rel, dst = np.divmod(rest, num_entities)
    return {"src": src.astype(np.int32), "rel": rel.astype(np.int32),
            "dst": dst.astype(np.int32), "features": features}


def split_graph(graph: Dict, counts: Dict[str, int],
                seed: int) -> Dict[str, Dict]:
    """``{"train", "valid", "test"}``, each ``{"src", "rel", "dst"}``: a
    random permutation of the triples cut into ``counts["valid"]``,
    ``counts["test"]`` and the rest for training."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(graph["src"].shape[0])
    n_valid, n_test = counts["valid"], counts["test"]
    cuts = {"train": perm[n_valid + n_test:], "valid": perm[:n_valid],
            "test": perm[n_valid:n_valid + n_test]}
    return {name: {k: graph[k][ids] for k in ("src", "rel", "dst")}
            for name, ids in cuts.items()}


def graph_splits(data: Dict, seed: int) -> Dict[str, Dict]:
    """The splits of the configuration's ``data`` block drawn from
    ``seed``: ``train_triples``, ``valid_triples`` and ``test_triples``
    distinct triples."""
    counts = {name: data[f"{name}_triples"]
              for name in ("train", "valid", "test")}
    graph = synthetic_graph(
        data["entities"], data["relations"], sum(counts.values()), seed,
        power=data["degree_power"], feature_dim=data.get("feature_dim"))
    splits = split_graph(graph, counts, seed)
    splits["features"] = graph["features"]
    return splits


def with_inverses(split: Dict, num_relations: int) -> Dict:
    """``(t, r + R, s)`` added after every ``(s, r, t)``."""
    return {"src": np.concatenate([split["src"], split["dst"]]),
            "rel": np.concatenate([split["rel"],
                                   split["rel"] + num_relations]),
            "dst": np.concatenate([split["dst"], split["src"]])}


def open_loop_arrivals(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Arrival times in ``[0, seconds)`` of a Poisson stream of ``rate``
    per second, conditioned on its count: ``round(rate * seconds)`` times,
    uniform and sorted, so every seed offers the same number of requests,
    at other moments."""
    n = int(round(rate * seconds))
    rng = np.random.default_rng([seed, 1])
    return np.sort(rng.uniform(0.0, seconds, n))


def zipf_queries(n: int, num_entities: int, num_relations: int,
                 exponent: float, seed: int):
    """``(heads, relations)`` of ``n`` requests: heads Zipf(``exponent``)
    over the entity ids, clipped to the last id, relations uniform."""
    rng = np.random.default_rng([seed, 2])
    heads = np.minimum(rng.zipf(exponent, n) - 1, num_entities - 1)
    rels = rng.integers(0, num_relations, n)
    return heads.astype(np.int64), rels.astype(np.int64)
