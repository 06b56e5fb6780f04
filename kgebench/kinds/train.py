"""Traffic kind ``train``: the port's ``KGETrainer`` driven step after
step through its own epoch call, ``train_epoch``.

The traffic file gives ``warmup_steps`` (set-up's first steps, the ones the
reference follows), ``warmup_seconds`` (more steps, until the host and the
card run at their steady pace), ``limits`` (of the compared numbers) and
``train``, any ``TrainConfig`` field over the configuration's
(``batch_size``, ``pipeline``, ``num_table_shards``, ...). With ``--trace
1`` the window's first ``trace_steps`` steps are profiled for device
activity alone, the next ``host_trace_steps`` with the host's operations
too.

Set-up builds one trainer from the seed's graph and drives its first steps;
those steps' readings are held against the plain reference's, in float64
and in float32 (``follow_both``), computed after the window from the same
graph and seed, with the partition and the expansion worked out again: the first gradient (from Adam's first
moment after one step) and the parameters' change after step 1 are
compared; the losses and the change after all the steps are printed.
"""
from __future__ import annotations

import dataclasses
import gc
import statistics
import time
from typing import Callable, Dict, List

import numpy as np

from kgebench import inputs
from kgebench.cell import Cell, Outcome, collector_paused
from kgebench.reference import preprocess as ref_pre
from kgebench.reference import train as ref_train
from kgebench.yardstick import work
from kgebench.yardstick.trace import TracedWindows, warm_profiler

SOURCES = ("rgcn_message", "sharded_gather")   # the CUDA sources it runs
# a leaf whose reference gradient is under this share of the median leaf's
# moves by round-off alone under Adam: its change is not compared
STILL_LEAF = 1e-3


def train_config(cell: Cell):
    from repro_torch.training.trainer import TrainConfig
    merged = {**cell.config["model"], **cell.config["recipe"],
              **cell.config["program"], **cell.traffic.get("train", {}),
              "seed": cell.seed}
    names = {f.name for f in dataclasses.fields(TrainConfig)}
    return TrainConfig(**{k: v for k, v in merged.items() if k in names})


def knowledge_graphs(splits: Dict, data: Dict):
    from repro_torch.core import KnowledgeGraph
    return {name: KnowledgeGraph(
        src=splits[name]["src"], rel=splits[name]["rel"],
        dst=splits[name]["dst"], num_entities=data["entities"],
        num_relations=data["relations"], features=splits["features"])
        for name in ("train", "valid", "test")}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves) -> List[float]:
    """Each leaf's ``|prog - ref|`` over the larger of the leaf's reference
    norm and the median leaf's."""
    median = statistics.median(ref.values())
    return [abs(prog[k] - ref[k]) / max(ref[k], median) for k in leaves]


def gaps(got: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers of the first steps' readings (``losses``, ``grad_norms``
    of step 1, ``step1_change_norms`` after step 1 and ``change_norms``
    after the steps) against the reference's: the worst step's relative
    loss gap, the worst leaf's gap of the first gradient, the worst leaf's
    gap of the change after step 1, and the median and worst leaf's gaps of
    the change after the steps. The last two are a lottery at full size: a
    ReLU input within rounding of nought takes the other side in steps 2
    and 3 on some seeds, and Adam, which moves every element by about its
    step whatever its gradient's size, turns that into a change of whole
    steps in small elements. A leaf that the reference's first gradient
    leaves under ``STILL_LEAF`` of the median leaf's is left out of the
    changes."""
    median = statistics.median(ref["grad_norms"].values())
    moving = [k for k, g in ref["grad_norms"].items()
              if g >= STILL_LEAF * median]
    change = leaf_gaps(got["change_norms"], ref["change_norms"], moving)
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in
                            zip(got["losses"], ref["losses"])),
            "grad_gap": max(leaf_gaps(got["grad_norms"], ref["grad_norms"],
                                      ref["grad_norms"])),
            "step1_change_gap": max(leaf_gaps(
                got["step1_change_norms"], ref["step1_change_norms"],
                moving)),
            "change_gap": statistics.median(change),
            "change_gap_worst_leaf": max(change)}


def follow_both(padded: Dict[str, np.ndarray], cell: Cell, steps: int,
                features) -> List[Dict]:
    """The reference's first ``steps`` steps in float64 and in float32, the
    configuration's precision. At full size either precision meets, on a
    few seeds, a rounding event the other does not (the first gradient's
    worst leaf moves by 2e-5-4e-5, near what TF32 moves it by), and the
    float32 program shares it with one reference or the other: it is held
    to the nearer."""
    import torch
    data, model = cell.config["data"], cell.config["model"]
    args = (padded, model, cell.config["recipe"], data["entities"],
            2 * data["relations"], cell.seed, steps, cell.device)
    return [ref_train.follow(*args, features=features, dtype=dtype)
            for dtype in (torch.float64, torch.float32)]


def nearest_gaps(got: Dict, refs: List[Dict]) -> Dict[str, float]:
    """Each of ``gaps``' numbers against the nearer of the references."""
    each = [gaps(got, ref) for ref in refs]
    return {name: min(g[name] for g in each) for name in each[0]}


def mismatches(padded, want: Dict[str, np.ndarray]) -> int:
    """Entries of the program's padded batch that differ from the
    reference's (a field of another shape counts all its entries)."""
    out = 0
    for key, w in want.items():
        got = np.asarray(getattr(padded, key))
        out += (int(np.count_nonzero(got != w)) if got.shape == w.shape
                else max(got.size, w.size))
    return out


def run(cell: Cell) -> Outcome:
    import torch
    clock, dev = cell.clock, cell.device
    data, model = cell.config["data"], cell.config["model"]
    cfg = None
    with clock.part("import the port"):
        from repro_torch.kernels import _build
        from repro_torch.training import trainer as trainer_mod
        cfg = train_config(cell)
    with clock.part("graph"):
        splits = inputs.graph_splits(data, cell.seed)
        kgs = knowledge_graphs(splits, data)
    if dev.type == "cuda":
        with clock.part("kernels (build or load)"):
            _build.build(SOURCES)
    timed = {}

    def span(name, fn):
        def wrapped(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                timed[name] = timed.get(name, 0.0) + time.perf_counter() - t0
        return wrapped

    with clock.part("trainer (preprocessing, weights, resident batch)"):
        real = (trainer_mod.preprocess_graph, trainer_mod.init_kge_params)
        trainer_mod.preprocess_graph = span("preprocessing", real[0])
        trainer_mod.init_kge_params = span("weights", real[1])
        try:
            trainer = trainer_mod.KGETrainer(kgs, cfg, device=dev)
        finally:
            trainer_mod.preprocess_graph, trainer_mod.init_kge_params = real
    for name, s in timed.items():
        print(f"[setup]   of which {name}: {s:.3f} s", flush=True)

    # ---- set-up's steps: the ones the reference follows ----
    warm = int(cell.traffic["warmup_steps"])
    with clock.part(f"warm-up ({warm} steps)"):
        start = {n: p.detach().clone()
                 for n, p in trainer.params.named_parameters()}
        losses, grad_norms, step1 = [], None, None
        for _ in range(warm):
            losses.append(trainer.train_epoch()["loss"])
            if grad_norms is None:
                grad_norms = {n: float(m.norm()) / (1 - ref_train.ADAM["b1"])
                              for n, m in trainer.opt_state.mu.items()}
                step1 = {n: float((p.detach() - start[n]).norm())
                         for n, p in trainer.params.named_parameters()}
        change_norms = {n: float((p.detach() - start[n]).norm())
                        for n, p in trainer.params.named_parameters()}
        del start
    with clock.part(f"warm-up ({cell.traffic['warmup_seconds']} s more)"):
        t_w = time.perf_counter()
        while time.perf_counter() - t_w < cell.traffic["warmup_seconds"]:
            trainer.train_epoch()

    padded = trainer.pre.padded
    core_per_step = int(padded.core_edge_mask.sum())
    on = padded.edge_mask.sum(axis=1)
    real_v = padded.vertex_mask.sum(axis=1)
    core = padded.core_edge_mask.sum(axis=1)
    d, nb = model["hidden_dim"], model["num_bases"]
    dims = [((model.get("feature_dim") or d) if i == 0 else d, d)
            for i in range(model["num_hops"])]
    step_calls = [(padded.padded_edges, nb, d_in, d_out, int(on[t]))
                  for d_in, d_out in dims for t in range(len(on))]
    step_ops = work.kge_train_step_ops(
        zip(on.tolist(), real_v.tolist(), core.tolist()), dims, nb, d,
        model["num_negatives"])

    if cell.trace:
        with clock.part("profiler start-up"):
            warm_profiler(dev)

    # ---- the window: whole steps, back to back ----
    with collector_paused():
        window: List[Dict] = []
        traced = 0
        t0 = clock.window_started()
        tw = (TracedWindows(dev, int(cell.traffic["trace_steps"]),
                            int(cell.traffic["host_trace_steps"]))
              if cell.trace else None)
        while True:
            window.append(trainer.train_epoch())
            if tw is not None:
                traced += tw.stage == 0
                tw.tick()
            if time.perf_counter() - t0 >= cell.seconds and \
                    (tw is None or not tw.active):
                break
        elapsed = time.perf_counter() - t0
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    steps = len(window)
    rate = steps * core_per_step / elapsed
    wait = [r["t_get_compute_graph"] + r["t_warmup"] for r in window]
    print(f"[window] {steps} steps of {core_per_step} core edges in "
          f"{elapsed:.3f} s; step mean {elapsed / steps * 1e3:.3f} ms; "
          f"last loss {window[-1]['loss']:.6f}", flush=True)
    failed = sum(1 for r in window if not np.isfinite(r["loss"]))

    # ---- free the program's state, then the reference ----
    del trainer
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    train_inv = inputs.with_inverses(splits["train"], data["relations"])
    want = ref_pre.preprocess(train_inv, data["entities"],
                              cfg.num_trainers, cfg.num_hops, cell.seed)
    t_pre = time.perf_counter() - t_ref
    refs = follow_both(want, cell, warm, splits["features"])
    print(f"[reference] {time.perf_counter() - t_ref:.3f} s (preprocessing "
          f"{t_pre:.3f} s, then {warm} steps in float64 and in float32); "
          f"losses {refs[0]['losses']} against the program's {losses}",
          flush=True)
    numbers = {"expansion_mismatch": float(mismatches(padded, want)),
               **nearest_gaps({"losses": losses, "grad_norms": grad_norms,
                               "step1_change_norms": step1,
                               "change_norms": change_norms}, refs)}
    limits = cell.traffic["limits"]
    checks = [(n, v, limits[n]) for n, v in numbers.items() if n in limits]
    print("[reference] not compared: " + ", ".join(
        f"{n} {v!r}" for n, v in numbers.items() if n not in limits),
        flush=True)
    facts = {"trace": tw.summary if tw is not None else None,
             "numbers": numbers, "steps_traced": traced, "basis_message_calls": step_calls,
             "step_ops": step_ops,
             "pipeline_wait_s_per_step": float(np.mean(wait))}
    return Outcome(end_to_end={"train_edges_per_s": rate}, facts=facts,
                   checks=checks, attempted=steps, failed=failed,
                   memory_peak_bytes=int(memory_peak))


def control(cell: Cell) -> Dict[str, float]:
    """The precision control: the reference's first steps in float32 with
    TF32 products, in the program's place, against the reference's own
    (``follow_both``), on the graph the cell's run draws from the seed."""
    import torch
    data, model = cell.config["data"], cell.config["model"]
    recipe = cell.config["recipe"]
    splits = inputs.graph_splits(data, cell.seed)
    padded = ref_pre.preprocess(
        inputs.with_inverses(splits["train"], data["relations"]),
        data["entities"], recipe["num_trainers"], model["num_hops"],
        cell.seed)
    steps = int(cell.traffic["warmup_steps"])
    args = (padded, model, recipe, data["entities"], 2 * data["relations"],
            cell.seed, steps, cell.device)
    low = ref_train.follow(*args, features=splits["features"],
                           dtype=torch.float32, tf32=True)
    refs = follow_both(padded, cell, steps, splits["features"])
    return {"expansion_mismatch": 0.0, **nearest_gaps(low, refs)}


# ---- faults planted in the program, each of which ``correct`` catches ----

def _state_unchanged() -> Callable[[], None]:
    """Every step computes its gradients and reports its loss, and leaves
    the parameters and the optimizer's state as they were."""
    from repro_torch.training import distributed as d
    real = d.mean_step

    def mean_step(model, optimizer, opt_state, per_trainer):
        frozen = dataclasses.replace(
            optimizer, update_in_place=lambda grads, state, params: state)
        return real(model, frozen, opt_state, per_trainer)

    d.mean_step = mean_step
    return lambda: setattr(d, "mean_step", real)


def _expansion_altered() -> Callable[[], None]:
    """Set-up's preprocessing partitions the graph from another seed than
    the run's (a partition and expansion the reference does not derive)."""
    from repro_torch.training import trainer as t
    real = t.preprocess_graph

    def preprocess_graph(kg, **kw):
        return real(kg, **{**kw, "seed": kw["seed"] + 1})

    t.preprocess_graph = preprocess_graph
    return lambda: setattr(t, "preprocess_graph", real)


def _half_batch() -> Callable[[], None]:
    """The second half of the trainers' partitions is left out and the
    gradients' mean is taken over the first half."""
    from repro_torch.training import distributed as d
    real = d.trainer_grads

    def trainer_grads(loss_fn, model, batch, generators):
        return real(loss_fn, model, batch,
                    generators[:max(1, len(generators) // 2)])

    d.trainer_grads = trainer_grads
    return lambda: setattr(d, "trainer_grads", real)


# ``FAULTS[name]()`` plants one by replacing a function of the port and
# returns the function that takes it out again (calibration runs and tests
# only; a benchmark run plants nothing). A cell on one chip has no exchange
# between chips to leave out: its trainers' gradients are summed in one
# process, and ``half_batch`` leaves trainers out of that sum.
FAULTS = {"state_unchanged": _state_unchanged,
          "half_batch": _half_batch,
          "expansion_altered": _expansion_altered}
