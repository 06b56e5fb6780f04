"""The plain preprocessing a training cell's set-up must derive (paper
§3.2): the streaming vertex-cut partition (HDRF with a balance cap), each
partition's self-sufficient 2-hop expansion, and the padded batch stacked on
the trainer axis.

A frozen copy of the algorithms as the port documents them, written against
plain numpy arrays, so the benchmark works the partition and the expansion
out again and holds the program's to them; it imports nothing of the program.
An edge ``(s, r, t)`` carries ``h_t`` into ``h_s``: the in-edges of ``v`` are
the edges with ``src == v``. Local ids put core vertices first.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def degrees(src: np.ndarray, dst: np.ndarray, n: int) -> np.ndarray:
    deg = np.zeros(n, dtype=np.int64)
    np.add.at(deg, src, 1)
    np.add.at(deg, dst, 1)
    return deg


def vertex_cut(src: np.ndarray, dst: np.ndarray, n: int, parts: int,
               seed: int, balance_slack: float = 1.05, lam: float = 1.0,
               chunk_size: int = 4096) -> np.ndarray:
    """Each edge's partition: edges streamed in a seeded random order,
    each to the partition maximising the replication gain of its endpoints
    (weighted towards the lower-degree one) plus the balance term, never
    to one at the cap of ``balance_slack · E / P`` edges. The gains of a
    chunk of edges are scored at once and rescored only for the vertices
    whose replica set changed inside the chunk; the arithmetic of each edge
    is the one the algorithm states."""
    e = src.shape[0]
    if parts == 1:
        return np.zeros(e, dtype=np.int32)
    rng = np.random.default_rng(seed)
    order = rng.permutation(e)
    deg = degrees(src, dst, n).astype(np.float64)
    replicas = np.zeros((n, parts), dtype=bool)
    dirty = np.zeros(n, dtype=bool)
    load = np.zeros(parts, dtype=np.int64)
    cap = int(np.ceil(balance_slack * e / parts))
    assign = np.empty(e, dtype=np.int32)
    for lo in range(0, e, chunk_size):
        chunk = order[lo: lo + chunk_size]
        us = src[chunk].astype(np.int64)
        vs = dst[chunk].astype(np.int64)
        du, dv = deg[us], deg[vs]
        theta_u = du / (du + dv + 1e-9)
        theta_v = 1.0 - theta_u
        w_u = 1.0 + (1.0 - theta_u)
        w_v = 1.0 + (1.0 - theta_v)
        g_u_blk = replicas[us] * w_u[:, None]
        g_v_blk = replicas[vs] * w_v[:, None]
        dirty[us] = False
        dirty[vs] = False
        maxload, minload = int(load.max()), int(load.min())
        n_capped = int((load >= cap).sum())
        for j in range(chunk.shape[0]):
            u, v = us[j], vs[j]
            g_u = replicas[u] * w_u[j] if dirty[u] else g_u_blk[j]
            g_v = replicas[v] * w_v[j] if dirty[v] else g_v_blk[j]
            bal = lam * (maxload - load) / (1e-9 + maxload - minload + 1.0)
            score = g_u + g_v + bal
            if n_capped:
                score[load >= cap] = -np.inf
            best = int(np.argmax(score))
            assign[chunk[j]] = best
            old = int(load[best])
            load[best] = old + 1
            maxload = max(maxload, old + 1)
            if old == minload and not (load == minload).any():
                minload += 1
            if old + 1 == cap:
                n_capped += 1
            if not replicas[u, best]:
                replicas[u, best] = True
                dirty[u] = True
            if not replicas[v, best]:
                replicas[v, best] = True
                dirty[v] = True
    return assign


def expand(src: np.ndarray, rel: np.ndarray, dst: np.ndarray, n: int,
           core_ids: np.ndarray, hops: int) -> Dict:
    """One partition made self-sufficient: its core edges plus every
    in-edge of the ``hops``-hop in-neighbourhood of its core vertices, in
    global edge order, with local ids (core vertices first, ascending;
    then the support vertices, ascending)."""
    core_v = np.unique(np.concatenate([src[core_ids], dst[core_ids]]))
    needed = np.zeros(src.shape[0], dtype=bool)
    needed[core_ids] = True
    frontier = core_v
    for _ in range(hops):
        vset = np.zeros(n, dtype=bool)
        vset[frontier] = True
        in_eids = np.nonzero(vset[src])[0]
        new = in_eids[~needed[in_eids]]
        if new.size == 0:
            break
        needed[new] = True
        frontier = np.unique(dst[new])
    eids = np.nonzero(needed)[0]
    core_mask = np.zeros(src.shape[0], dtype=bool)
    core_mask[core_ids] = True
    s, t = src[eids], dst[eids]
    support_v = np.setdiff1d(np.unique(np.concatenate([s, t])), core_v)
    l2g = np.concatenate([core_v, support_v]).astype(np.int64)
    g2l = np.full(n, -1, dtype=np.int64)
    g2l[l2g] = np.arange(l2g.shape[0])
    return {"src": g2l[s].astype(np.int32), "rel": rel[eids].astype(np.int32),
            "dst": g2l[t].astype(np.int32), "core": core_mask[eids],
            "l2g": l2g, "num_core_vertices": int(core_v.shape[0]),
            "num_core_edges": int(core_ids.shape[0])}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad(parts: List[Dict], edge_align: int = 128,
        vertex_align: int = 8) -> Dict[str, np.ndarray]:
    """The partitions stacked on a trainer axis, padded to the largest's
    edges (a multiple of 128) and vertices (of 8): padded edges are
    ``(0, 0, 0)`` and off, padded vertices map to entity 0 and are off."""
    e_max = _round_up(max(p["src"].shape[0] for p in parts), edge_align)
    v_max = _round_up(max(p["l2g"].shape[0] for p in parts), vertex_align)
    k = len(parts)
    out = {"src": np.zeros((k, e_max), np.int32),
           "rel": np.zeros((k, e_max), np.int32),
           "dst": np.zeros((k, e_max), np.int32),
           "edge_mask": np.zeros((k, e_max), bool),
           "core_edge_mask": np.zeros((k, e_max), bool),
           "local_to_global": np.zeros((k, v_max), np.int64),
           "vertex_mask": np.zeros((k, v_max), bool),
           "num_core_vertices": np.zeros(k, np.int32),
           "num_core_edges": np.zeros(k, np.int32)}
    for i, p in enumerate(parts):
        e, v = p["src"].shape[0], p["l2g"].shape[0]
        for key in ("src", "rel", "dst"):
            out[key][i, :e] = p[key]
        out["edge_mask"][i, :e] = True
        out["core_edge_mask"][i, :e] = p["core"]
        out["local_to_global"][i, :v] = p["l2g"]
        out["vertex_mask"][i, :v] = True
        out["num_core_vertices"][i] = p["num_core_vertices"]
        out["num_core_edges"][i] = p["num_core_edges"]
    return out


def preprocess(train: Dict, n: int, parts: int, hops: int,
               seed: int) -> Dict[str, np.ndarray]:
    """The padded batch of ``train`` (inverse edges included) over
    ``parts`` vertex-cut partitions, each expanded by ``hops``."""
    src, rel, dst = train["src"], train["rel"], train["dst"]
    assign = vertex_cut(src, dst, n, parts, seed)
    return pad([expand(src, rel, dst, n,
                       np.nonzero(assign == i)[0].astype(np.int64), hops)
                for i in range(parts)])
