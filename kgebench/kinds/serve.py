"""Traffic kind ``serve``: ``(head, relation, ?)`` queries into the port's
``KGEServeEngine``, over a ``ShardedKGEServer`` whose entity table and
relation diagonals are drawn on the card from the seed (they stand for an
encoded table).

The traffic file gives the arrivals, one of two:

* ``rate_qps``: an open loop at that fixed rate. Requests are due at times
  drawn from the seed (``inputs.open_loop_arrivals``: the same count for
  every seed); each is submitted once due, and its latency runs from when it
  was due to when its answer is on the host, so a stall delays the requests
  behind it. After the window every request due in it is waited for, a
  minute at most.
* ``backlog``: saturated by construction. Every request is due at the
  window's start, and the loop keeps ``backlog`` of them submitted and not
  yet answered, so each engine step admits full batches whatever the
  engine's pace: the rate answered is the capacity. Requests are drawn for
  ``max_qps`` over the window, far above any capacity; at the window's
  close submitting stops and the requests submitted are answered.

and ``slots``, ``k``, ``zipf`` (the heads' exponent; relations are
uniform), ``policy``, ``warmup_seconds`` (full batches before the window,
until the host and the card run at their steady pace), ``trace_steps`` and
``host_trace_steps`` (with ``--trace 1``, the window's first engine steps
profiled for device activity alone, then the next with the host's
operations too), ``sample`` (requests drawn from the seed whose answers are
judged against the reference, where due in the window) and ``limits``.
One process, one thread: the loop submits what is due, then runs one engine
step, whose answers come back to the host.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Callable, Dict

import numpy as np

from kgebench import inputs
from kgebench.cell import Cell, Outcome, collector_paused
from kgebench.reference import serve as ref_serve
from kgebench.yardstick.trace import TracedWindows, warm_profiler

SOURCES = ("kge_score", "topk", "sharded_gather")
DRAIN_S = 60.0


def draw_table(cell: Cell):
    """``(table (N, d), rel_diag (R, d))`` fp32, drawn on the device from
    the seed in two calls: unit normal rows, diagonals of variance
    ``1 / d``, so a score has unit variance."""
    import torch
    serve, model = cell.config["serve"], cell.config["model"]
    n, r, d = serve["entities"], serve["relations"], model["hidden_dim"]
    gen = torch.Generator(device=cell.device)
    gen.manual_seed(cell.seed)
    table = torch.randn((n, d), generator=gen, device=cell.device)
    rel = torch.randn((r, d), generator=gen, device=cell.device)
    return table, rel / math.sqrt(d)


def arrivals(traffic: Dict, seconds: float, seed: int) -> np.ndarray:
    """When each request is due, in seconds from the window's start."""
    if "backlog" in traffic:
        return np.zeros(int(round(traffic["max_qps"] * seconds)))
    return inputs.open_loop_arrivals(traffic["rate_qps"], seconds, seed)


def requests(cell: Cell, n_ent: int, n_rel: int):
    """``(due, heads, rels, sample)`` of the cell's request stream: the
    same for the program and the reference."""
    tr = cell.traffic
    due = arrivals(tr, cell.seconds, cell.seed)
    n = due.shape[0]
    heads, rels = inputs.zipf_queries(n, n_ent, n_rel, tr["zipf"], cell.seed)
    sample = np.sort(np.random.default_rng([cell.seed, 3]).choice(
        n, size=min(int(tr["sample"]), n), replace=False))
    return due, heads, rels, sample


def judge(table, rel, heads: np.ndarray, rels: np.ndarray,
          served_vals, served_ids, k: int) -> Dict[str, float]:
    """The compared numbers of served answers against the reference's:
    ``invalid_answers`` (rows with fewer than k ids, an id out of range or
    twice), ``topk_rank_gap`` (the widest gap by which the j-th served
    tail's exact score lies below the reference's j-th best, over the
    query's best exact score in magnitude) and ``topk_value_gap`` (the
    widest gap between a served value and its tail's exact score, on the
    same scale)."""
    n_ent = table.shape[0]
    bad = np.array([len(s) != k or len(set(s.tolist())) != k or
                    int(s.min()) < 0 or int(s.max()) >= n_ent
                    for s in served_ids], dtype=bool)
    ok = ~bad
    if not ok.any():
        return {"invalid_answers": float(bad.sum()),
                "topk_rank_gap": math.inf, "topk_value_gap": math.inf}
    _, ref_ids = ref_serve.topk(table, rel, heads[ok], rels[ok], k)
    ref_exact = -np.sort(-ref_serve.scores_at(table, rel, heads[ok],
                                              rels[ok], ref_ids), axis=1)
    ids = np.stack([s for s, b in zip(served_ids, bad) if not b])
    vals = np.stack([v for v, b in zip(served_vals, bad) if not b])
    got = ref_serve.scores_at(table, rel, heads[ok], rels[ok], ids)
    scale = np.abs(ref_exact).max(axis=1, keepdims=True)
    return {"invalid_answers": float(bad.sum()),
            "topk_rank_gap": float(
                (np.maximum(ref_exact - got, 0) / scale).max()),
            "topk_value_gap": float((np.abs(vals - got) / scale).max())}


def control(cell: Cell) -> Dict[str, float]:
    """The precision control: the reference, with TF32 products, in the
    program's place, judged on the cell's sampled requests."""
    table, rel = draw_table(cell)
    _, heads, rels, sample = requests(cell, table.shape[0], rel.shape[0])
    k = int(cell.traffic["k"])
    vals, ids = ref_serve.topk(table, rel, heads[sample], rels[sample], k,
                               tf32=True)
    return judge(table, rel, heads[sample], rels[sample], vals, list(ids),
                 k)


def run(cell: Cell) -> Outcome:
    import torch
    clock, dev, tr = cell.clock, cell.device, cell.traffic
    k, slots = int(tr["k"]), int(tr["slots"])
    backlog = int(tr.get("backlog", 0))
    with clock.part("import the port"):
        from repro_torch.kernels import _build
        from repro_torch.serving.kge import KGEServeEngine, ShardedKGEServer
    if dev.type == "cuda":
        with clock.part("kernels (build or load)"):
            _build.build(SOURCES)
    with clock.part("weights (drawn on the device)"):
        table, rel = draw_table(cell)
    with clock.part("server (table copy, prepared candidates)"):
        server = ShardedKGEServer(
            table, {"rel_diag": rel}, cell.config["model"]["decoder"],
            num_shards=cell.config["serve"]["table_shards"],
            table_dtype=cell.config["serve"]["table_dtype"], device=dev)
        engine = KGEServeEngine(server, slots=slots, max_k=k,
                                filtered=cell.config["serve"]["filtered"],
                                policy=tr["policy"])
    n_ent, n_rel = table.shape[0], rel.shape[0]
    rows = server.layout.rows_per_shard
    with clock.part("request stream"):
        arrive, heads, rels, sample = requests(cell, n_ent, n_rel)
    n = arrive.shape[0]
    # plain Python lists and a set: the loop touches one element at a time
    due, head_l, rel_l = arrive.tolist(), heads.tolist(), rels.tolist()
    with clock.part(f"warm-up ({tr['warmup_seconds']} s of full steps)"):
        t_w, j = time.perf_counter(), 0
        while j == 0 or time.perf_counter() - t_w < tr["warmup_seconds"]:
            for _ in range(slots):
                engine.submit(head_l[j % n], rel_l[j % n], k,
                              request_id=n + j)
                j += 1
            engine.step()
    keep = set(sample.tolist())
    answers = {}
    finish = [math.nan] * n
    step_host_s, step_queries, traced_queries = [], [], []
    in_flight = backlog if backlog else math.inf
    if cell.trace:
        with clock.part("profiler start-up"):
            warm_profiler(dev)

    # ---- the window ----
    with collector_paused():
        i, last = 0, n
        t0 = clock.window_started()
        tw = (TracedWindows(dev, int(tr["trace_steps"]),
                            int(tr["host_trace_steps"]))
              if cell.trace else None)
        while True:
            now = time.perf_counter() - t0
            if backlog and now >= cell.seconds:
                last = i                # submitting stops at the close
            while i < last and due[i] <= now and \
                    engine.pending < in_flight:
                engine.submit(head_l[i], rel_l[i], k, request_id=i)
                i += 1
            if engine.pending:
                s0 = time.perf_counter()
                done = engine.step()
                t = time.perf_counter()
                if tw is None or not tw.active:
                    step_host_s.append(t - s0)
                step_queries.append(len(done))
                for r in done:
                    finish[r.request_id] = t - t0
                    if r.request_id in keep:
                        answers[r.request_id] = (r.scores, r.tails)
                if tw is not None:
                    if tw.stage == 0:
                        traced_queries.append(len(done))
                    tw.tick()
            elif i < last:
                wait = due[i] - (time.perf_counter() - t0)
                if wait > 2e-3:
                    time.sleep(wait - 1e-3)
            else:
                break
            if now > cell.seconds + DRAIN_S:
                break
        if tw is not None:
            tw.close()
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    # the requests due in the window: every one of an open loop, the ones
    # submitted in it under a backlog
    finish = np.array(finish[:last])
    latency_ms = (finish - arrive[:last]) * 1e3
    answered = np.isfinite(finish)
    in_window = int((finish <= cell.seconds).sum())
    qps = in_window / cell.seconds
    p95 = float(np.percentile(latency_ms[answered], 95)) if answered.any() \
        else math.inf
    offered = (f"a backlog of {backlog}" if backlog
               else f"{tr['rate_qps']} per s")
    print(f"[window] {last} requests due ({offered}); "
          f"{in_window} answered in the {cell.seconds} s window "
          f"({qps:.1f} per s), {int(answered.sum())} in all; latency "
          f"median {np.median(latency_ms[answered]):.4f} ms, p95 "
          f"{p95:.4f} ms over {int(answered.sum())} requests; "
          f"{len(step_queries)} engine steps, "
          f"{np.mean(step_queries):.2f} queries a step", flush=True)

    # ---- free the program's state, then the reference ----
    del engine, server
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    # a sampled request due in the window and never answered counts as a
    # wrong answer
    judged = sample[sample < last]
    empty = (np.zeros(0, np.float32), np.zeros(0, np.int64))
    vals = [answers.get(j, empty)[0] for j in judged]
    ids = [answers.get(j, empty)[1] for j in judged]
    numbers = judge(table, rel, heads[judged], rels[judged], vals, ids, k)
    print(f"[reference] {len(answers)} of {len(judged)} sampled answers "
          f"judged in {time.perf_counter() - t_ref:.3f} s", flush=True)
    limits = tr["limits"]
    checks = [(name, value, limits[name]) for name, value in numbers.items()]
    facts = {"trace": tw.summary if tw is not None else None,
             "numbers": numbers,
             "traced_queries": traced_queries,
             "slots": slots, "k": k, "dim": table.shape[1],
             "entities": n_ent,
             "filtered": cell.config["serve"]["filtered"],
             "table_shards": cell.config["serve"]["table_shards"],
             "rows_per_shard": rows, "step_host_s": step_host_s}
    e2e = {"serve_queries_per_s": qps, "serve_p95_ms": p95}
    return Outcome(end_to_end=e2e, facts=facts, checks=checks, attempted=last,
                   failed=int((~answered).sum()),
                   memory_peak_bytes=int(memory_peak))


# ---- faults planted in the program, each of which ``correct`` catches ----

def _answer_altered() -> Callable[[], None]:
    """Each answer's last tail replaced by the next entity id."""
    from repro_torch.serving import kge
    real = kge.ShardedKGEServer.topk_tails

    def topk_tails(self, *a, **k):
        scores, tails = real(self, *a, **k)
        tails = tails.copy()
        tails[:, -1] = (tails[:, -1] + 1) % self.num_entities
        return scores, tails

    kge.ShardedKGEServer.topk_tails = topk_tails
    return lambda: setattr(kge.ShardedKGEServer, "topk_tails", real)


def _half_candidates() -> Callable[[], None]:
    """The second half of each shard's candidates is never scored (its
    scores read -inf), so the top-k is over the rest."""
    from repro_torch.serving import kge
    real = kge.shard_scores

    def shard_scores(*a, **k):
        s = real(*a, **k)
        s[:, s.shape[1] // 2:] = -np.inf
        return s

    kge.shard_scores = shard_scores
    return lambda: setattr(kge, "shard_scores", real)


def _half_batch() -> Callable[[], None]:
    """Each engine step answers the first half of the requests it
    admitted; the rest are dropped and never answered."""
    from repro_torch.serving import kge
    real = kge.KGEServeEngine.step

    def step(self):
        done = real(self)
        for r in done[(len(done) + 1) // 2:]:
            r.done, r.scores, r.tails = False, None, None
        return done[:(len(done) + 1) // 2]

    kge.KGEServeEngine.step = step
    return lambda: setattr(kge.KGEServeEngine, "step", real)


def _stale_answers() -> Callable[[], None]:
    """Each step after the first answers with the previous step's answers
    (the server's state never moves on)."""
    from repro_torch.serving import kge
    real = kge.ShardedKGEServer.topk_tails
    last: Dict[int, tuple] = {}

    def topk_tails(self, *a, **k):
        out = real(self, *a, **k)
        prev = last.get(id(self), out)
        last[id(self)] = out
        return prev

    kge.ShardedKGEServer.topk_tails = topk_tails
    return lambda: setattr(kge.ShardedKGEServer, "topk_tails", real)


# ``FAULTS[name]()`` plants one by replacing a function of the port and
# returns the function that takes it out again (calibration runs and tests
# only; a benchmark run plants nothing). A cell on one chip has no exchange
# between chips to leave out.
FAULTS = {"answer_altered": _answer_altered,
          "half_candidates": _half_candidates,
          "half_batch": _half_batch,
          "stale_answers": _stale_answers}
