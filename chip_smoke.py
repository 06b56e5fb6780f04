#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--out results.json]

Phases, each of which fails the run on error:

1. Build: compile the five CUDA sources from ``src/repro_torch/csrc`` with
   ``nvcc -Xptxas -v`` for ``sm_90a`` (one process per source, all at once).
2. Kernel vs plain: each of the eight kernels against its plain PyTorch
   version on the card, with its time, its plain version's time, one
   PyTorch library call's time (where one computes the function) and the
   least time the card could take:
   kge_score, topk and fused_gather at the serving shapes;
   fused_dequant_gather at the serving shapes over tables quantized on the
   card, and at the 4-shard mini-batch table gather (V = 17,200 into
   14,544 x 75 int8): bitwise the plain version, unowned slots exactly 0,
   two runs bitwise equal, a flat id outside the table raises, a table of
   subnormal and zero scales comes through bitwise; quantize_rows on the
   card bitwise the CPU's (FB15k-237 table, subnormal table); basis_message
   and segment_sum at the full-graph FB15k-237 training shape (one padded
   partition of 4: E = 377,984 edges, V = 13,760 vertices, d = 75, B = 2)
   and at edge cases (ragged E, an all-masked tile, empty segments,
   unsorted segments, d_in != d_out, bases over 48 KB and over the card's
   shared memory); scatter_add_onehot at the shapes of one mini-batch of
   the mini-batch path (the 4-shard table gradient V = 17,200 into
   R = 14,544, the vertex-state gather backward E = 472,448 into 17,200,
   the relation-coefficient backward into 474 rows) and at edge cases (all
   slots unowned, one row hit by every slot, R not a multiple of 128,
   V = 0): within 2 gamma_n sum|g| of the plain version, rows no owned
   slot hits exactly 0, two runs bitwise equal, the 4-shard table gradient
   bitwise the dense one; wkv_chunked at the rwkv6-3b prefill shape
   (BH = 4 x 40 heads, S = 2,048, hd = chunk = 64) and at edge cases
   (S ragged, BH = 1, S < chunk, chunk = 16, hd = 8, 16, 32) against the
   plain chunked form and the sequential oracle: finite, two runs bitwise
   equal, and a block above the card's shared memory refused.
3. Serving, FB15k-237 width (N=14,541, R=474, d=75): 200 Zipf(1.3) requests
   through ``repro_torch.launch.serve`` with distmult and transe at 1 and 4
   table shards, filtered, cache 256, 8 slots, k=10; sharded == dense.
4. Serving, ogbl-citation2 width (N=2,927,963, R=2, d=32): distmult, 1
   shard, unfiltered, 64 requests; sharded == dense.
   Phases 3-4 again with --table-dtype int8 (FB15k-237 width as above;
   ogbl-citation2 width at 4 shards): sharded == dense over the
   dequantized table; the stored table's device bytes, int8 against fp32.
5. Launch counts of the serving path (phases 3-4): kge_score, topk and
   fused_gather each launched by the fp32 runs, kge_score, topk and
   fused_dequant_gather by the int8 runs.
6. Training, full-graph FB15k-237 at full width through
   ``repro_torch.launch.train`` (--arch rgcn-fb15k237 --use-kernel
   --trainers 4 --epochs 3 --scale 1.0: d=75, dropout 0.2), then the
   filtered test evaluation; launch counts of that path (basis_message,
   segment_sum, scatter_add_onehot and kge_score each launched). The same
   run without --use-kernel (the plain encoder on the card) must give the
   same per-epoch losses within rtol=1e-3, atol=1e-4, and the kernel and
   plain encoders the same embeddings of the trained model. Two runs of
   one full-graph step from the same state give bitwise-equal losses and
   parameters.
6b. Training, edge mini-batches at full width: --batch-size 4096
   --table-shards 4 --pipeline async --use-kernel, one epoch (24 steps of
   4 trainers), then the filtered test evaluation with 4-shard ranking;
   launch counts of that path (fused_gather, scatter_add_onehot,
   basis_message, segment_sum and kge_score each launched). Against it,
   one epoch each with --table-shards 1, --pipeline serial and
   --gather-dedup must give bitwise-equal per-step losses and final
   parameters, and one without --use-kernel per-step losses within
   rtol=1e-3, atol=1e-4; the 4-shard ranking metrics == the dense ranking
   from the same embeddings; two runs of one mini-batch step from the same
   state give bitwise-equal losses and parameters.
6c. Training, edge mini-batches with the int8 table at full width: phase
   6b's main run with --table-dtype int8; launch counts of that path
   (fused_dequant_gather, scatter_add_onehot, basis_message, segment_sum
   and kge_score each launched). Against it, --table-shards 1 and
   --gather-dedup must give bitwise-equal per-step losses and final
   parameters; two runs of one int8 step are bitwise equal; one step's
   loss and gradients, the master table's included, are bitwise the fp32
   path's on the dequantized master; 4-shard int8 ranking == 1-shard int8
   ranking, and |MRR(int8) - MRR(fp32)| <= 0.02 on the same embeddings.
7. Profile under ``torch.profiler``: one rwkv6-3b prefill (with the WKV
   kernel's share of it) and one steady decode step; steady serving steps
   of each serving
   configuration (int8 at 4 shards included), one steady full-graph step
   (kernel and plain encoder), one evaluation encode and one steady
   mini-batch step each of the fp32 and int8 tables: host time per step,
   the card's busy time, the idle share and the device operations that
   took the most time; and the async pipeline's exposed wait and overlap
   fraction over the mini-batch epoch.
8. LM serving, rwkv6-3b at full width (run before phase 7's profiles):
   fp32 weights from a CUDA generator, TF32 off. (a) ``make_prefill_step``
   at B = 4, S = 2,048 with the WKV kernel against the plain chunked form
   (last logits within LM_LOGIT_TOL), its time and model-FLOP rate; (b) a
   64-token prompt through ``decode_step`` ends at the kernel prefill's
   last logits, and a steady decode step's time against reading the
   weights; (c) ``ServeEngine(slots=4, max_seq=64)`` answers 8 greedy
   requests, all done and none truncated; (d) wkv_chunked launched 32
   times per prefill forward and never while decoding. Cut against the
   reference's ``prefill_32k`` shape: B = 4 (not 32), S = 2,048 (not
   32,768); the model's depth and widths are whole.

Then one JSON line with the kernels, the ``nvidia-smi`` name and power
limit, and as the last line ``{"ok": true, "device": {...}}``. Without a
CUDA device, or without the repository beside it, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
U32 = 2.0 ** -24            # unit roundoff of fp32

FB15K = dict(entities=14541, relations=474, dim=75)      # configs RGCN_FB15K237
CITATION2 = dict(entities=2927963, relations=2, dim=32)  # configs RGCN_CITATION2
SLOTS, K = 8, 10

TRAIN_ARGV = ["--arch", "rgcn-fb15k237", "--trainers", "4", "--epochs", "3",
              "--scale", "1.0", "--device", "cuda"]
MB_ARGV = ["--arch", "rgcn-fb15k237", "--trainers", "4", "--epochs", "1",
           "--scale", "1.0", "--batch-size", "4096", "--device", "cuda"]
MB_MAIN = ["--table-shards", "4", "--pipeline", "async", "--use-kernel"]
MB_GATES = {   # runs held against the main one: bitwise, or within LOSS_TOL
    "S1": ["--table-shards", "1", "--pipeline", "async", "--use-kernel"],
    "serial": ["--table-shards", "4", "--pipeline", "serial",
               "--use-kernel"],
    "dedup": MB_MAIN + ["--gather-dedup"],
    "plain": ["--table-shards", "4", "--pipeline", "async"],
}
INT8 = ["--table-dtype", "int8"]
MB_INT8_GATES = {   # int8 runs held bitwise against the int8 main run
    "S1": MB_GATES["S1"] + INT8,
    "dedup": MB_GATES["dedup"] + INT8,
}
# |MRR(int8) - MRR(fp32)| on the same embeddings; the reference's bound,
# QUANT_MRR_DRIFT_LIMIT in benchmarks/pipeline_bench.py:203
QUANT_MRR_DRIFT_LIMIT = 0.02
LOSS_TOL = dict(rtol=1e-3, atol=1e-4)   # kernel vs plain per-epoch losses
EMB_TOL = dict(rtol=1e-4, atol=1e-5)    # kernel vs plain encoder outputs

# phase 8: rwkv6-3b at full width (configs/rwkv6_3b.py), cut against the
# reference's prefill_32k shape (B = 32, S = 32,768; launch/specs.py:35) to
# B = 4, S = 2,048: the full fp32 logits the prefill forms are then 2.1 GB
# instead of 275 GB. Depth and widths are the model's own (32 layers).
LM_ARCH, LM_B, LM_S = "rwkv6-3b", 4, 2048
LM_DECODE_PROMPT = 64                      # phase 8b: tokens through decode
LM_SERVE = dict(slots=4, max_seq=64, requests=8, max_prompt=16,
                new_tokens=16)              # phase 8c
# Last-position logits of two fp32 evaluations of the 32-layer stack that
# differ only in summation order (the kernel's fmaf chains against cuBLAS's
# blocking, or the chunked form against the per-token recurrence): each
# layer meets the reference's own per-layer gate for these forms
# (rtol=1e-3, tests/test_perf_variants.py:27-28) with a wide margin, and
# the logits (|x| about 1) sit behind 32 such layers and the head.
LM_LOGIT_TOL = dict(rtol=1e-3, atol=1e-3)
# the WKV kernel against its sequential oracle: the reference's gate
# (tests/test_kernels.py:186-187)
WKV_TOL = dict(rtol=1e-4, atol=1e-4)
WKV_ULPS_PER_STEP = 8    # against the plain chunked form: see check_wkv

# each kernel's pallas_call in the JAX package
REPLACES = {
    "kge_score": "src/repro/kernels/kge_score.py:95",
    "topk": "src/repro/kernels/topk.py:98",
    "fused_gather": "src/repro/kernels/sharded_gather.py:87",
    "fused_dequant_gather": "src/repro/kernels/sharded_gather.py:136",
    "basis_message": "src/repro/kernels/rgcn_message.py:79",
    "segment_sum": "src/repro/kernels/rgcn_message.py:152",
    "scatter_add_onehot": "src/repro/kernels/sharded_gather.py:195",
    "wkv_chunked": "src/repro/kernels/wkv_chunk.py:85",
}
SOURCES = {
    "kge_score": "src/repro_torch/csrc/kge_score.cu",
    "topk": "src/repro_torch/csrc/topk.cu",
    "fused_gather": "src/repro_torch/csrc/sharded_gather.cu",
    "fused_dequant_gather": "src/repro_torch/csrc/sharded_gather.cu",
    "basis_message": "src/repro_torch/csrc/rgcn_message.cu",
    "segment_sum": "src/repro_torch/csrc/rgcn_message.cu",
    "scatter_add_onehot": "src/repro_torch/csrc/sharded_gather.cu",
    "wkv_chunked": "src/repro_torch/csrc/wkv_chunk.cu",
}
SERVING_KERNELS = ("kge_score", "topk", "fused_gather")
TRAINING_KERNELS = ("basis_message", "segment_sum", "scatter_add_onehot",
                    "kge_score")
MINIBATCH_KERNELS = ("fused_gather", "scatter_add_onehot", "basis_message",
                     "segment_sum", "kge_score")
SERVING_INT8_KERNELS = ("kge_score", "topk", "fused_dequant_gather")
MINIBATCH_INT8_KERNELS = ("fused_dequant_gather", "scatter_add_onehot",
                          "basis_message", "segment_sum", "kge_score")


def log(msg: str) -> None:
    print(msg, flush=True)


def launch_counts():
    """Each kernel wrapper's launch count."""
    from repro_torch.kernels import KERNELS
    return {n: w.launches for n, w in KERNELS.items()}


def reset_counts():
    from repro_torch.kernels import KERNELS
    for w in KERNELS.values():
        w.launches = 0


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` single-call times taken with CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def short_name(name: str) -> str:
    """A device operation's name without its namespace prefix, template
    arguments and signature."""
    name = name.replace("(anonymous namespace)::", "")
    for cut in ("(", "<"):
        name = name.split(cut)[0]
    return name.strip()


def device_activity(prof):
    """``(busy_us, {name: us}, count)`` of a profile's device-side activity
    (kernels and copies): the union of their intervals, each short name's
    summed duration, and the number of device events."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end, by_name = 0.0, float("-inf"), {}
    for lo, hi, name in spans:
        key = short_name(name)
        by_name[key] = by_name.get(key, 0.0) + (hi - lo)
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy, by_name, len(spans)


def profiled(fn, reps: int, windows: int = 10, host: bool = True):
    """One complete ``torch.profiler`` window of ``reps`` calls of ``fn``:
    ``{"busy_us", "by_name", "count", "wall_us"}``, the wall time on the
    host clock ending in a synchronise. ``host=False`` records device
    activity only, which costs the host less.

    The profiler on the card can deliver a window that misses device
    events or holds a few extra ones (windows of one 0.3 ms kernel once
    held 1 % of its events; windows of one serving stream held 148, 150,
    148, 148 events). Every window of the same calls launches the same
    device work, so windows are taken until two of them deliver the same
    number of device events, and the first of those is returned; after
    ``windows`` windows without such a pair it raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    seen = []
    for _ in range(windows):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA] + (
                [ProfilerActivity.CPU] if host else [])) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        busy, by_name, count = device_activity(prof)
        for w in seen:
            if count > 0 and w["count"] == count:
                return w
        seen.append(dict(busy_us=busy, by_name=by_name, count=count,
                         wall_us=wall_us))
    raise RuntimeError(f"torch.profiler gave no two windows with the same "
                       f"device activity in {windows} (device events per "
                       f"window: {[w['count'] for w in seen]}), so no "
                       f"device time can be given")


def device_ms(fn, reps: int = 10) -> float:
    """Device time per call of ``fn``: the busy time of everything it runs
    on the card, from a complete ``torch.profiler`` window of ``reps``
    calls (:func:`profiled`)."""
    fn()
    return profiled(fn, reps)["busy_us"] / reps / 1e3


def step_profile(fn, steps: int = 1, top: int = 8):
    """Host time per call of ``fn`` (``steps`` calls ending in a
    synchronise), the card's busy time per call, the idle share and the
    device operations that took the most time, from a complete profiler
    window of device activity."""
    w = profiled(fn, steps, host=False)
    names = sorted(w["by_name"].items(), key=lambda kv: -kv[1])[:top]
    return dict(step_ms=w["wall_us"] / steps / 1e3,
                device_ms_per_step=w["busy_us"] / steps / 1e3,
                idle_share=1.0 - w["busy_us"] / w["wall_us"],
                device_events=w["count"],
                top_device_ms_per_step={n: t / steps / 1e3
                                        for n, t in names})


def timed(fn, reps: int = 20, warmup: int = 3):
    """``(ms, call_ms)``: ``ms`` is the device time per call from the
    profiler; ``call_ms`` the CUDA-event time of one call, host overhead
    included."""
    return device_ms(fn, max(2, reps // 2)), time_ms(fn, reps, warmup)


def max_abs_diff(got, want) -> float:
    """Largest ``|got - want|`` over all entries, 0 where they are equal
    (equal infinities included)."""
    import torch
    diff = (got.double() - want.double()).abs()
    diff = torch.where(got == want, torch.zeros_like(diff), diff)
    return float(diff.max()) if diff.numel() else 0.0


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------- #
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------- #
def score_tolerance(q, cand, q_bias, c_bias, x_plain, out_plain, epilogue):
    """Elementwise bound on |kernel - plain| for ``kge_score``.

    Both sides compute x = sum_j q_j c_j + q_bias + c_bias in fp32, in
    different orders (the kernel: a sequential fmaf chain; cuBLAS: its own
    blocking), so each is within gamma_{d+2} * S of the exact x, with
    S = sum_j |q_j c_j| + |q_bias| + |c_bias| and gamma_n = n u / (1 - n u):
    tol_x = 2 gamma_{d+2} S. ``neg_l2`` maps x through sqrt, whose slope
    1 / (2 sqrt(a)) amplifies tol_x near zero distance; since
    |sqrt(a) - sqrt(b)| <= min(|a-b| / sqrt(min(a, b)), sqrt(|a-b|)), the
    bound there is min(tol_x / sqrt(a_lo), sqrt(tol_x)) with a_lo the
    smallest a the plain x allows. Two ulps of the output cover the
    rounding of the epilogue and of the post-epilogue bias."""
    import torch
    d = q.shape[1]
    gamma = (d + 2) * U32 / (1 - (d + 2) * U32)
    s = (q.double().abs() @ cand.double().abs().T
         + q_bias.double().abs()[:, None] + c_bias.double().abs()[None, :])
    tol = 2 * gamma * s
    if epilogue == "neg_l2":
        a_lo = torch.clamp_min(x_plain.double() - tol, 0.0) + 1e-9
        tol = torch.minimum(tol / torch.sqrt(a_lo), torch.sqrt(tol))
    ulp = torch.abs(torch.nextafter(out_plain, torch.full_like(
        out_plain, float("inf"))) - out_plain).double()
    return tol + 2 * torch.nan_to_num(ulp, nan=0.0, posinf=0.0)


def timings(kernel, plain, library, b_ms, b_by):
    """The timing keys of one kernel at one shape (see :func:`timed`)."""
    ms, call_ms = timed(kernel)
    plain_ms, plain_call_ms = timed(plain)
    lib_ms, lib_call_ms = timed(library)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by, call_ms=call_ms,
                plain_call_ms=plain_call_ms, library_call_ms=lib_call_ms)


def report(name, shape, st, library):
    log(f"[phase 2] {name} {shape}: {st['ms']:.4f} ms "
        f"({st['call_ms']:.4f} ms per call), plain "
        f"{st['plain_ms']:.4f} ms, {library} {st['library_ms']:.4f} ms, "
        f"bound {st['bound_ms']:.6f} ms ({st['bound_by']})")


def check_kge_score(dev, rng, widths):
    """Both epilogues, a bias of 0 / -1e9 / -inf, at each width's
    (C, d[, B]) (B: the serving slots unless given); returns (max |err|
    over finite scores, per-width times)."""
    import torch
    from repro_torch.kernels.kge_score import kge_score, kge_score_plain
    torch.backends.cuda.matmul.allow_tf32 = False
    max_err, stats = 0.0, {}
    for label, c, d, *batch in widths:
        b = batch[0] if batch else SLOTS
        u = torch.from_numpy(rng.normal(0, .1, (b, d)).astype(np.float32)
                             ).to(dev)
        cand = torch.from_numpy(rng.normal(0, .1, (c, d)).astype(np.float32)
                                ).to(dev)
        cand[:b] = u            # zero-distance pairs: the sqrt's worst case
        choice = rng.choice(3, size=(b, c), p=[.8, .1, .1])
        bias = torch.from_numpy(np.choose(choice, [
            np.float32(0), np.float32(-1e9), np.float32(-np.inf)]).astype(
                np.float32)).to(dev)
        for epilogue in ("bilinear", "neg_l2"):
            if epilogue == "neg_l2":   # TransE's norm-expansion query form
                q, qb = -2.0 * u, (u * u).sum(1)
                cb = (cand * cand).sum(1)
            else:
                q, qb, cb = u, torch.zeros(b, device=dev), \
                    torch.zeros(c, device=dev)
            got = kge_score(q, cand, bias, qb, cb, epilogue=epilogue)
            want = kge_score_plain(q, cand, bias, qb, cb, epilogue=epilogue)
            torch.cuda.synchronize()
            x_plain = q @ cand.T + qb[:, None] + cb[None, :]
            fin = torch.isfinite(want)
            if not torch.equal(fin, torch.isfinite(got)) or not torch.equal(
                    got[~fin], want[~fin]):
                raise AssertionError(f"kge_score {label} {epilogue}: "
                                     f"non-finite entries differ")
            err = (got.double() - want.double()).abs()
            tol = score_tolerance(q, cand, qb, cb, x_plain, want, epilogue)
            bad = fin & (err > tol)
            if bool(bad.any()):
                i = int(torch.nonzero(bad)[0, 1])
                raise AssertionError(
                    f"kge_score {label} {epilogue}: {int(bad.sum())} scores "
                    f"outside the bound, e.g. column {i}: err "
                    f"{float(err[bad].max())} > tol {float(tol[bad].min())}")
            max_err = max(max_err, float(err[fin].max()))
        # times: the neg_l2 epilogue (TransE), these inputs
        nbytes = 4 * (b * d + c * d + b + c + 2 * b * c)
        stats[label] = dict(B=b, C=c, d=d, **timings(
            lambda: kge_score(q, cand, bias, qb, cb, epilogue="neg_l2"),
            lambda: kge_score_plain(q, cand, bias, qb, cb,
                                    epilogue="neg_l2"),
            lambda: torch.matmul(q, cand.T),
            *bound_ms(nbytes, 2 * b * c * d)))
        report("kge_score", f"{label} (B={b}, C={c}, d={d})",
               stats[label], "matmul")
    return max_err, stats


def check_topk(dev, rng, widths):
    """Exact ties, -1e9 and all--inf rows, k=10; the merge form with ids.
    Values and indices must be bitwise the plain version's; returns (max
    |kernel - plain| over values and indices, per-width times)."""
    import torch
    from repro_torch.kernels.topk import topk_plain, topk_scores
    max_err, stats = 0.0, {}
    for label, c, _ in widths:
        s = (rng.integers(0, 64, (SLOTS, c)) / 8.0).astype(np.float32)
        s[1] = -np.inf                        # all--inf row
        s[2, rng.random(c) < .999] = -np.inf  # mostly -inf: drains by index
        s[3, rng.random(c) < .5] = -1e9       # filtered candidates
        scores = torch.from_numpy(s).to(dev)
        ids = torch.from_numpy(
            rng.permutation(c).astype(np.int64)[None].repeat(SLOTS, 0)
        ).to(dev)
        for with_ids in (None, ids):
            gv, gi = topk_scores(scores, K, with_ids)
            wv, wi = topk_plain(scores, K, with_ids)
            torch.cuda.synchronize()
            if not (torch.equal(gv.view(torch.int32), wv.view(torch.int32))
                    and torch.equal(gi, wi)):
                raise AssertionError(f"topk {label} (ids={with_ids is not None})"
                                     f": kernel != plain")
            max_err = max(max_err, max_abs_diff(gv, wv), max_abs_diff(gi, wi))
        stats[label] = dict(C=c, k=K, **timings(
            lambda: topk_scores(scores, K), lambda: topk_plain(scores, K),
            lambda: torch.topk(scores, K),
            *bound_ms(4 * SLOTS * c + 12 * SLOTS * K, SLOTS * c)))
        report("topk", f"{label} (B={SLOTS}, C={c}, k={K})", stats[label],
               "torch.topk")
    return max_err, stats


def check_fused_gather(dev, rng, widths, mbs):
    """Duplicate ids and unowned slots at the serving batch (8) and the
    dedup bucket (64), and the mini-batch path's table gather (``mbs``);
    the output must be bitwise the plain version's, and a flat id outside
    the table must raise as in the plain version. Returns (max |kernel -
    plain|, per-width times)."""
    import torch
    from repro_torch.kernels.sharded_gather import (
        fused_gather, fused_gather_plain,
    )
    max_err, stats = 0.0, {}
    for label, c, d in widths:
        table = torch.from_numpy(rng.normal(0, .1, (c, d)).astype(np.float32)
                                 ).to(dev)
        for v in (SLOTS, 64):
            flat = rng.integers(0, c, v)
            flat[1] = flat[0]                 # duplicate id
            owned = rng.random(v) < .75
            owned[0] = True
            flat_t = torch.from_numpy(flat.astype(np.int64)).to(dev)
            owned_t = torch.from_numpy(owned).to(dev)
            got = fused_gather(table, flat_t, owned_t)
            want = fused_gather_plain(table, flat_t, owned_t)
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"fused_gather {label} V={v}: "
                                     f"kernel != plain")
            max_err = max(max_err, max_abs_diff(got, want))
        bad = flat_t.clone()
        bad[3] = c                            # a broken plan: one past the end
        try:
            fused_gather(table, bad, owned_t)
        except IndexError:
            pass
        else:
            raise AssertionError(f"fused_gather {label}: a flat id outside "
                                 f"the table did not raise")
        # times at the serving batch: 8 head rows
        flat_t, owned_t = flat_t[:SLOTS], owned_t[:SLOTS]
        n_own = int(owned_t.sum())
        stats[label] = dict(V=SLOTS, d=d, **timings(
            lambda: fused_gather(table, flat_t, owned_t),
            lambda: fused_gather_plain(table, flat_t, owned_t),
            lambda: torch.index_select(table, 0, flat_t),
            *bound_ms(4 * n_own * d + 9 * SLOTS + 4 * SLOTS * d, 0)))
        report("fused_gather", f"{label} (V={SLOTS}, d={d})", stats[label],
               "index_select")
    # the mini-batch path: one trainer's 4-shard table gather, unchecked
    from repro_torch.kernels.ops import flat_gather_plan
    lay = mbs["layout"]
    table = torch.from_numpy(rng.normal(0, .1, (lay.padded_rows, 75)).astype(
        np.float32)).to(dev)
    flat, owned = flat_gather_plan(torch.from_numpy(mbs["local"]),
                                   torch.from_numpy(mbs["owned"]),
                                   lay.rows_per_shard)
    flat_t, owned_t = flat.to(dev), owned.to(dev)
    got = fused_gather(table, flat_t, owned_t, check=False)
    want = fused_gather_plain(table, flat_t, owned_t)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError("fused_gather minibatch_S4: kernel != plain")
    v, n_own = flat.shape[0], int(owned.sum())
    stats["minibatch_S4"] = dict(V=v, d=75, **timings(
        lambda: fused_gather(table, flat_t, owned_t, check=False),
        lambda: fused_gather_plain(table, flat_t, owned_t),
        lambda: torch.index_select(table, 0, flat_t),
        *bound_ms(4 * n_own * 75 + 9 * v + 4 * v * 75, 0)))
    report("fused_gather", f"minibatch_S4 (V={v}, R={lay.padded_rows}, "
           f"d=75)", stats["minibatch_S4"], "index_select")
    return max_err, stats


def subnormal_table(rng, rows, d):
    """A table whose rows take the smallest scales (2^-149 … 2^-127), with
    all-zero rows between: a flush-to-zero anywhere would zero them."""
    x = (rng.choice([-1.0, 1.0], (rows, d)) * rng.uniform(1, 2, (rows, d))
         * np.exp2(rng.integers(-149, -120, (rows, 1)).astype(np.float64))
         ).astype(np.float32)
    x[::5] = 0.0
    return x


def check_fused_dequant_gather(dev, rng, widths, mbs):
    """fused_dequant_gather at the serving batch (8) and dedup bucket (64)
    over the FB15k-237 and ogbl-citation2 tables quantized on the card, and
    at the mini-batch path's 4-shard table gather (``mbs``): bitwise the
    plain version, unowned slots exactly 0, two runs bitwise equal, a flat
    id outside the table raises; a table of subnormal and zero scales comes
    through bitwise and nonzero. ``quantize_rows`` on the card is bitwise
    the CPU's for the FB15k-237 table and the subnormal table. Returns
    (max |kernel - plain|, per-width times, table bytes per width)."""
    import torch
    from repro_torch.kernels.ops import flat_gather_plan
    from repro_torch.kernels.sharded_gather import (
        fused_dequant_gather, fused_dequant_gather_plain,
    )
    from repro_torch.sharding import quantize_rows

    def same(a, b):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        return torch.equal(a.cpu(), b.cpu())

    def run_both(codes, scales, flat_t, owned_t, label, check=True):
        got = fused_dequant_gather(codes, scales, flat_t, owned_t,
                                   check=check)
        got2 = fused_dequant_gather(codes, scales, flat_t, owned_t,
                                    check=check)
        want = fused_dequant_gather_plain(codes, scales, flat_t, owned_t)
        torch.cuda.synchronize()
        if not (same(got, want) and same(got, got2)):
            raise AssertionError(f"fused_dequant_gather {label}: kernel != "
                                 f"plain, or two runs differ")
        if not bool((got[~owned_t].view(torch.int32) == 0).all()):
            raise AssertionError(f"fused_dequant_gather {label}: an unowned "
                                 f"slot is not exactly 0")
        return got, want

    def bound(v, n_own, d):
        # owned slots' codes and scales, every slot's id and ownership,
        # the output; one multiply per output element
        return bound_ms(n_own * d + 4 * n_own + 9 * v + 4 * v * d, v * d)

    def library(codes, scales, flat_t, owned_t):
        # several PyTorch calls: index_select twice, the cast, the product
        # and the where (no one call computes this function)
        rows = (codes.index_select(0, flat_t).float()
                * scales.index_select(0, flat_t)[:, None])
        return torch.where(owned_t[:, None], rows, 0.0)

    max_err, stats, table_bytes = 0.0, {}, {}
    for label, c, d in widths:
        table = torch.from_numpy(rng.normal(0, .1, (c, d)).astype(np.float32)
                                 ).to(dev)
        codes, scales = quantize_rows(table)
        table_bytes[label] = dict(int8=codes.numel() + 4 * scales.numel(),
                                  fp32=4 * table.numel())
        if c <= 100_000:          # the CPU quantizer at FB15k-237 width
            cc, cs = quantize_rows(table.cpu())
            if not (same(codes, cc) and same(scales, cs)):
                raise AssertionError(f"quantize_rows {label}: card != CPU")
        del table
        for v in (SLOTS, 64):
            flat = rng.integers(0, c, v)
            flat[1] = flat[0]                 # duplicate id
            flat[2] = c - 1                   # the last row
            owned = rng.random(v) < .75
            owned[:3] = True
            flat_t = torch.from_numpy(flat.astype(np.int64)).to(dev)
            owned_t = torch.from_numpy(owned).to(dev)
            got, want = run_both(codes, scales, flat_t, owned_t,
                                 f"{label} V={v}")
            max_err = max(max_err, max_abs_diff(got, want))
        bad = flat_t.clone()
        bad[3] = c                            # a broken plan: one past the end
        try:
            fused_dequant_gather(codes, scales, bad, owned_t)
        except IndexError:
            pass
        else:
            raise AssertionError(f"fused_dequant_gather {label}: a flat id "
                                 f"outside the table did not raise")
        flat_t, owned_t = flat_t[:SLOTS], owned_t[:SLOTS]
        n_own = int(owned_t.sum())
        stats[label] = dict(V=SLOTS, d=d, **timings(
            lambda: fused_dequant_gather(codes, scales, flat_t, owned_t),
            lambda: fused_dequant_gather_plain(codes, scales, flat_t,
                                               owned_t),
            lambda: library(codes, scales, flat_t, owned_t),
            *bound(SLOTS, n_own, d)))
        report("fused_dequant_gather", f"{label} (V={SLOTS}, d={d})",
               stats[label], "index_select, cast, mul, where")
    # subnormal and zero scales
    x = subnormal_table(rng, 4096, 75)
    codes, scales = quantize_rows(torch.from_numpy(x).to(dev))
    cc, cs = quantize_rows(torch.from_numpy(x))
    if not (same(codes, cc) and same(scales, cs)):
        raise AssertionError("quantize_rows subnormal table: card != CPU")
    flat_t = torch.from_numpy(rng.integers(0, 4096, 2048)).to(dev)
    owned_t = torch.ones(2048, dtype=torch.bool, device=dev)
    got, _ = run_both(codes, scales, flat_t, owned_t, "subnormal scales")
    want = (cc.float() * cs[:, None])[flat_t.cpu()]
    nonzero = want != 0
    if not (same(got, want) and bool((got.cpu()[nonzero] != 0).all())
            and bool(nonzero.any())):
        raise AssertionError("fused_dequant_gather: subnormal rows flushed")
    log(f"[phase 2] fused_dequant_gather: subnormal scales "
        f"{float(cs[cs > 0].min()):.3g} … {float(cs.max()):.3g} and "
        f"{int((cs == 0).sum())} zero rows bitwise through the card; "
        f"quantize_rows on the card == CPU")
    # the mini-batch path: one trainer's 4-shard int8 table gather
    lay = mbs["layout"]
    master = torch.from_numpy(rng.normal(0, .1, (lay.padded_rows, 75))
                              .astype(np.float32)).to(dev)
    codes, scales = quantize_rows(master)
    flat, owned = flat_gather_plan(torch.from_numpy(mbs["local"]),
                                   torch.from_numpy(mbs["owned"]),
                                   lay.rows_per_shard)
    flat_t, owned_t = flat.to(dev), owned.to(dev)
    got, want = run_both(codes, scales, flat_t, owned_t, "minibatch_S4",
                         check=False)
    max_err = max(max_err, max_abs_diff(got, want))
    v, n_own = flat.shape[0], int(owned.sum())
    stats["minibatch_S4"] = dict(V=v, d=75, **timings(
        lambda: fused_dequant_gather(codes, scales, flat_t, owned_t,
                                     check=False),
        lambda: fused_dequant_gather_plain(codes, scales, flat_t, owned_t),
        lambda: library(codes, scales, flat_t, owned_t),
        *bound(v, n_own, 75)))
    stats["minibatch_S4"]["quantize_ms"], _ = timed(
        lambda: quantize_rows(master))
    report("fused_dequant_gather", f"minibatch_S4 (V={v}, R="
           f"{lay.padded_rows}, d=75)", stats["minibatch_S4"],
           "index_select, cast, mul, where")
    log(f"[phase 2] quantize_rows of the 4-shard master ({lay.padded_rows} x "
        f"75): {stats['minibatch_S4']['quantize_ms']:.4f} ms")
    return max_err, stats, table_bytes


def training_partition():
    """The host arrays of one padded partition of the full-graph training
    run: FB15k-237 width at scale 1.0, vertex-cut into 4 trainers, 2 hops
    (the partition the kernels see in phase 6)."""
    from repro_torch.data import synthetic_fb15k
    from repro_torch.training.preprocessing import preprocess_graph
    kg = synthetic_fb15k(scale=1.0, seed=0)["train"].with_inverse_relations()
    pad = preprocess_graph(kg, num_trainers=4, num_hops=2, seed=0).padded
    return dict(src=pad.src[0], rel=pad.rel[0], dst=pad.dst[0],
                mask=pad.edge_mask[0], V=pad.padded_vertices,
                E=pad.padded_edges, R=kg.num_relations)


def gamma(n):
    """gamma_n = n u / (1 - n u), the fp32 bound on a sum of n terms."""
    return n * U32 / (1 - n * U32)


def check_basis_message(dev, rng, part, mbs):
    """The training shapes (one partition's gathers at d=75, B=2, and one
    mini-batch's) and the edge cases; returns (max |err|, per-shape times,
    edge-case configs).

    Both sides compute sum_b c_b sum_i h_i W_bio in fp32 in different
    orders (the kernel: fixed fmaf chains; the plain einsums: cuBLAS's
    blocking), so each is within gamma_{d_in+B} * S of the exact value with
    S = sum_b |c_b| sum_i |h_i W_bio|; the bound is twice that. Masked
    edges must be exactly 0 on both."""
    import torch
    from repro_torch.kernels.rgcn_message import (
        basis_message, basis_message_config, basis_message_plain,
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    v, e, r = part["V"], part["E"], part["R"]
    cases = [("train", v, e, 75, 75, 2, part["dst"], part["rel"],
              part["mask"]),
             ("minibatch", mbs["V"], mbs["E"], 75, 75, 2, mbs["dst"],
              mbs["rel"], mbs["mask"]),
             ("ragged", v, 1000, 75, 75, 2, None, None, None),
             ("d_in!=d_out", v, 777, 128, 75, 3, None, None, None),
             ("bases>48KB", v, 2000, 128, 128, 2, None, None, None),
             ("bases>smem", v, 513, 256, 256, 2, None, None, None)]
    max_err, stats, configs = 0.0, {}, {}
    for label, v, ne, d_in, d_out, nb, dst, rel, mask in cases:
        if dst is None:
            dst = rng.integers(0, v, ne)
            rel = rng.integers(0, r, ne)
            mask = rng.random(ne) < .9
            mask[:128] = False                 # an all-masked tile
        h = torch.from_numpy(rng.normal(0, 1, (v, d_in)).astype(np.float32)
                             ).to(dev)
        coeffs = torch.from_numpy(rng.normal(0, .1, (r, nb)).astype(
            np.float32)).to(dev)
        w = torch.from_numpy(rng.normal(0, (2 / (d_in + d_out)) ** .5, (
            nb, d_in, d_out)).astype(np.float32)).to(dev)
        h_t = h[torch.from_numpy(np.asarray(dst, np.int64)).to(dev)]
        coef = coeffs[torch.from_numpy(np.asarray(rel, np.int64)).to(dev)]
        m = torch.from_numpy(np.asarray(mask, bool)).to(dev)
        got = basis_message(h_t, coef, w, m)
        want = basis_message_plain(h_t, coef, w, m)
        torch.cuda.synchronize()
        if not (bool((got[~m] == 0).all()) and bool((want[~m] == 0).all())):
            raise AssertionError(f"basis_message {label}: a masked edge is "
                                 f"not exactly 0")
        s = torch.einsum("eb,ebo->eo", coef.double().abs(), torch.einsum(
            "ed,bdo->ebo", h_t.double().abs(), w.double().abs()))
        tol = 2 * gamma(d_in + nb) * s
        err = (got.double() - want.double()).abs()
        if bool((err > tol).any()):
            raise AssertionError(
                f"basis_message {label}: {int((err > tol).sum())} outputs "
                f"outside the bound, worst err {float(err.max())}")
        max_err = max(max_err, float(err.max()))
        tile, in_smem = basis_message_config(d_in, d_out, nb)
        configs[label] = dict(E=ne, d_in=d_in, d_out=d_out, B=nb,
                              edges_per_block=tile, bases_in_smem=in_smem)
        log(f"[phase 2] basis_message {label} (E={ne}, d_in={d_in}, "
            f"d_out={d_out}, B={nb}; {tile} edges per block, bases in "
            f"{'shared' if in_smem else 'global'} memory): max err "
            f"{float(err.max()):.3g}")
        if label in ("train", "minibatch"):
            n_on = int(m.sum())
            nbytes = 4 * (ne * d_in + ne * nb + nb * d_in * d_out
                          + ne * d_out) + ne
            ops = 2 * n_on * nb * d_out * (d_in + 1)
            stats[label] = dict(E=ne, d=d_in, B=nb, **timings(
                lambda: basis_message(h_t, coef, w, m),
                lambda: basis_message_plain(h_t, coef, w, m),
                lambda: torch.einsum("ebo,eb->eo", torch.einsum(
                    "ed,bdo->ebo", h_t, w), coef),
                *bound_ms(nbytes, ops)))
            report("basis_message", f"{label} (E={ne}, d={d_in}, B={nb})",
                   stats[label], "einsum pair")
    return max_err, stats, configs


def check_segment_sum(dev, rng, part, mbs):
    """The training shapes (one partition's heads and mask, and one
    mini-batch's, d=75) and the edge cases; deg must be ==, agg within 2 gamma_n sum|msg| of the plain
    version (n = the segment's length: both add the same terms in other
    orders), and two runs bitwise equal. Returns (max |err|, times)."""
    import torch
    from repro_torch.kernels.rgcn_message import (
        segment_key, segment_plan, segment_sum, segment_sum_plain,
        segment_sum_planned,
    )
    v, e = part["V"], part["E"]
    cases = [("train", e, v, 75, part["src"], part["mask"]),
             ("minibatch", mbs["E"], mbs["V"], 75, mbs["src"], mbs["mask"]),
             ("ragged unsorted", 1000, 300, 75, None, None),
             ("sorted", 4000, 500, 32, "sorted", None),
             ("hub + empty", 70000, 2000, 75, "hub", None)]
    max_err, stats = 0.0, {}
    for label, ne, nv, d, seg, mask in cases:
        if seg is None or isinstance(seg, str):
            kind = seg
            seg = rng.integers(0, nv // 2, ne)    # upper half stays empty
            if kind == "sorted":
                seg = np.sort(seg)
            if kind == "hub":
                seg[rng.random(ne) < .6] = 7      # one 42,000-edge segment
            mask = rng.random(ne) < .9
            mask[:128] = False
        msg = torch.from_numpy(rng.normal(0, 1, (ne, d)).astype(np.float32)
                               ).to(dev)
        seg_t = torch.from_numpy(np.asarray(seg, np.int32)).to(dev)
        m = torch.from_numpy(np.asarray(mask, bool)).to(dev)
        agg, deg = segment_sum(msg, seg_t, m, nv)
        agg2, deg2 = segment_sum(msg, seg_t, m, nv)
        pagg, pdeg = segment_sum_plain(msg, seg_t, m, nv)
        torch.cuda.synchronize()
        if not (torch.equal(agg.view(torch.int32), agg2.view(torch.int32))
                and torch.equal(deg, deg2)):
            raise AssertionError(f"segment_sum {label}: two runs differ")
        if not torch.equal(deg, pdeg):
            raise AssertionError(f"segment_sum {label}: deg != plain")
        key = segment_key(seg_t, m, nv)
        s = torch.zeros((nv + 1, d), dtype=torch.float64,
                        device=dev).index_add_(0, key, msg.double().abs())
        tol = 2 * gamma(deg.double())[:, None] * s[:nv]
        err = (agg.double() - pagg.double()).abs()
        if bool((err > tol).any()):
            raise AssertionError(
                f"segment_sum {label}: {int((err > tol).sum())} sums outside "
                f"the bound, worst err {float(err.max())}")
        max_err = max(max_err, float(err.max()))
        log(f"[phase 2] segment_sum {label} (E={ne}, V={nv}, d={d}, longest "
            f"segment {int(deg.max())}): max err {float(err.max()):.3g}, "
            f"deg ==, two runs bitwise equal")
        if label in ("train", "minibatch"):
            plan = segment_plan(seg_t, m, nv)
            n_on = int(m.sum())
            nbytes = 4 * n_on * d + 5 * ne + 4 * nv * d + 4 * nv
            st = dict(E=ne, V=nv, d=d, longest_segment=int(deg.max()),
                      **timings(
                          lambda: segment_sum(msg, seg_t, m, nv),
                          lambda: segment_sum_plain(msg, seg_t, m, nv),
                          lambda: torch.zeros((nv + 1, d), device=dev)
                          .index_add_(0, key, msg),
                          *bound_ms(nbytes, n_on * d)))
            st["kernel_ms"], _ = timed(
                lambda: segment_sum_planned(msg, *plan, nv))
            st["plan_ms"], _ = timed(lambda: segment_plan(seg_t, m, nv))
            stats[label] = st
            report("segment_sum", f"{label} (E={ne}, V={nv}, d={d})", st,
                   "index_add_")
            log(f"[phase 2] segment_sum {label}: kernels alone "
                f"{st['kernel_ms']:.4f} ms, the sort plan (argsort, "
                f"index_add_ counts, cumsum) {st['plan_ms']:.4f} ms")
    return max_err, stats


def minibatch_arrays():
    """The host arrays of one mini-batch of the mini-batch path (phase
    6b): FB15k-237 width at scale 1.0, 4 trainers, batch 4096, the 4-shard
    table's gather plan; trainer 0's slice of the first batch."""
    from repro_torch.data import synthetic_fb15k
    from repro_torch.data.pipeline import SerialMinibatchPipeline, host_batch
    from repro_torch.training.preprocessing import preprocess_graph
    kg = synthetic_fb15k(scale=1.0, seed=0)["train"].with_inverse_relations()
    pre = preprocess_graph(kg, num_trainers=4, num_hops=2, seed=0,
                           batch_size=4096, num_table_shards=4)
    pipe = SerialMinibatchPipeline(
        pre.partitions, batch_size=4096, num_negatives=1, num_hops=2,
        budget=pre.budget, seed=0, csrs=pre.csrs,
        table_layout=pre.table_layout)
    mb = next(iter(pipe.epoch_batches(1)))
    hb = host_batch(mb, pre.table_layout)
    return dict(gather_global=mb.gather_global[0],
                local=hb["shard_local_ids"][0], owned=hb["shard_owned"][0],
                src=mb.comp_src[0], dst=mb.comp_dst[0], rel=mb.comp_rel[0],
                mask=mb.comp_mask[0],
                trip_rel=mb.triplets[0][:, 1], N=kg.num_entities,
                R=kg.num_relations, layout=pre.table_layout,
                V=pre.budget.max_vertices, E=pre.budget.max_edges,
                T=pre.budget.max_triplets,
                comp_vertices=int(mb.vertex_mask[0].sum()))


def check_scatter_add(dev, rng, mbs):
    """scatter_add_onehot at the mini-batch path's shapes and the edge
    cases. Both sides add each row's owned hits in fp32, in other orders
    (the kernel: chunks of 32 in slot order, then the chunk sums; the
    plain index_add_: atomics), so each is within gamma_n sum|g| of the
    exact sum (n = the row's hits) and the bound is twice that. Rows no
    owned slot hits must be exactly 0, two runs bitwise equal, and the
    4-shard table gradient bitwise the dense one. Returns (max |err|,
    per-shape times)."""
    import torch
    from repro_torch.kernels.ops import flat_gather_plan
    from repro_torch.kernels.rgcn_message import segment_key, segment_plan
    from repro_torch.kernels.sharded_gather import (
        scatter_add_onehot, scatter_add_onehot_plain, scatter_add_planned,
    )
    lay = mbs["layout"]
    flat_s, own_s = flat_gather_plan(torch.from_numpy(mbs["local"]),
                                     torch.from_numpy(mbs["owned"]),
                                     lay.rows_per_shard)
    ragged_owned = rng.random(5000) < .7
    cases = [
        ("table_grad", flat_s.numpy(), own_s.numpy(), lay.padded_rows, 75),
        ("h_dst", mbs["dst"], None, mbs["V"], 75),
        ("coeffs_rel", mbs["rel"], None, mbs["R"], 2),
        ("rel_diag", mbs["trip_rel"], None, mbs["R"], 75),
        ("all unowned", rng.integers(0, 1000, 1000), np.zeros(1000, bool),
         1000, 75),
        ("one row", np.full(40000, 5), None, 300, 75),
        ("ragged R", rng.integers(0, 1001, 5000), ragged_owned, 1001, 33),
        ("V=0", np.zeros(0, np.int64), np.zeros(0, bool), 1000, 75),
    ]
    max_err, stats = 0.0, {}
    for label, flat, owned, r, d in cases:
        v = flat.shape[0]
        g = torch.from_numpy(rng.normal(0, 1, (v, d)).astype(np.float32)
                             ).to(dev)
        flat_t = torch.from_numpy(np.asarray(flat, np.int64)).to(dev)
        own_t = None if owned is None else torch.from_numpy(
            np.asarray(owned, bool)).to(dev)
        got = scatter_add_onehot(g, flat_t, own_t, r)
        got2 = scatter_add_onehot(g, flat_t, own_t, r)
        want = scatter_add_onehot_plain(g, flat_t, own_t, r)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), got2.view(torch.int32)):
            raise AssertionError(f"scatter_add_onehot {label}: two runs "
                                 f"differ")
        key = segment_key(flat_t, own_t, r)
        hits = torch.zeros(r + 1, dtype=torch.float64, device=dev
                           ).index_add_(0, key, torch.ones(
                               v, dtype=torch.float64, device=dev))[:r]
        if not (bool((got[hits == 0] == 0).all()) and
                bool((want[hits == 0] == 0).all())):
            raise AssertionError(f"scatter_add_onehot {label}: a row no "
                                 f"owned slot hits is not exactly 0")
        absum = torch.zeros((r + 1, d), dtype=torch.float64, device=dev
                            ).index_add_(0, key, g.double().abs())[:r]
        tol = 2 * gamma(hits)[:, None] * absum
        err = (got.double() - want.double()).abs()
        if bool((err > tol).any()):
            raise AssertionError(
                f"scatter_add_onehot {label}: {int((err > tol).sum())} sums "
                f"outside the bound, worst err {float(err.max())}")
        e_max = float(err.max()) if err.numel() else 0.0
        max_err = max(max_err, e_max)
        longest = int(hits.max()) if hits.numel() else 0
        log(f"[phase 2] scatter_add_onehot {label} (V={v}, R={r}, d={d}, "
            f"longest row {longest}): max err {e_max:.3g}, non-hit rows 0, "
            f"two runs bitwise equal")
        if label == "table_grad":
            dense = scatter_add_onehot(
                g, torch.from_numpy(mbs["gather_global"].astype(np.int64)
                                    ).to(dev), None, mbs["N"])
            if not torch.equal(dense.view(torch.int32),
                               got[:mbs["N"]].view(torch.int32)):
                raise AssertionError("scatter_add_onehot: the 4-shard table "
                                     "gradient != the dense one")
            log("[phase 2] scatter_add_onehot: 4-shard table gradient "
                "bitwise the dense gather's")
        if label in ("table_grad", "h_dst", "coeffs_rel"):
            n_own = int(hits.sum())
            nbytes = 4 * n_own * d + 8 * v + (v if owned is not None else 0) \
                + 4 * r * d
            plan = segment_plan(flat_t, own_t, r)
            st = dict(V=v, R=r, d=d, longest_row=longest, **timings(
                lambda: scatter_add_onehot(g, flat_t, own_t, r),
                lambda: scatter_add_onehot_plain(g, flat_t, own_t, r),
                lambda: torch.zeros((r + 1, d), device=dev)
                .index_add_(0, key, g),
                *bound_ms(nbytes, n_own * d)))
            st["kernel_ms"], _ = timed(
                lambda: scatter_add_planned(g, *plan, r))
            st["plan_ms"], _ = timed(lambda: segment_plan(flat_t, own_t, r))
            stats[label] = st
            report("scatter_add_onehot", f"{label} (V={v}, R={r}, d={d})",
                   st, "index_add_")
            log(f"[phase 2] scatter_add_onehot {label}: kernels alone "
                f"{st['kernel_ms']:.4f} ms, the sort plan "
                f"{st['plan_ms']:.4f} ms")
    return max_err, stats


def wkv_inputs(dev, rng, bh, s, hd):
    """r, k, v, log_decay, u on the card, drawn as the reference's kernel
    tests draw them (tests/test_kernels.py:176-183)."""
    import torch

    def card(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    r, k, v = (card(rng.normal(size=(bh, s, hd)) * 0.5) for _ in range(3))
    lw = card(-np.exp(rng.normal(size=(bh, s, hd)) * 0.3 - 3))
    u = card(rng.normal(size=(bh, hd)) * 0.1)
    return r, k, v, lw, u


def wkv_ops(bh, s, hd, chunk):
    """FLOP the chunked WKV needs: per chunk of n steps the two products
    over the strict lower triangle, r_t k_t^T and scores v, n (n - 1) hd
    each, and the two with the state, r_t S and k_out^T v, 2 n hd^2 each."""
    lengths = [min(chunk, s - lo) for lo in range(0, s, chunk)]
    return bh * sum(2 * n * (n - 1) * hd + 4 * n * hd * hd for n in lengths)


def check_wkv(dev, rng):
    """wkv_chunked at the rwkv6-3b prefill shape (BH = 4 batch rows x 40
    heads, S = 2,048, hd = chunk = 64) and at edge cases (S ragged, BH = 1,
    S shorter than the chunk, chunk = 16, hd = 8, 16, 32). Every output
    finite; two runs bitwise equal; within the reference's gate of the
    sequential oracle ``ref.wkv_chunk_ref``; and within
    WKV_ULPS_PER_STEP * chunk ulps of each row's largest output of the
    plain chunked form (the same factorization: each output is a sum of
    at most chunk + 2 hd + 1 terms in another order, and the state's
    rounding decays with it). A block above the card's shared memory
    (hd = 128, chunk = 64) raises ValueError. Returns (max |kernel - plain
    chunked|, per-case errors with the times at the prefill shape)."""
    import torch
    from repro_torch.kernels.ref import wkv_chunk_ref
    from repro_torch.kernels.wkv_chunk import wkv_chunked, wkv_chunked_plain
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = [("prefill", LM_B * 40, LM_S, 64, 64),
             ("S ragged", 7, 1000, 64, 64), ("BH=1", 1, 300, 64, 64),
             ("S<chunk", 4, 10, 64, 64), ("chunk=16", 12, 200, 64, 16),
             ("hd=8", 5, 77, 8, 16), ("hd=16", 9, 130, 16, 32),
             ("hd=32", 3, 96, 32, 64)]
    max_err, stats = 0.0, {}
    for label, bh, s, hd, chunk in cases:
        x = wkv_inputs(dev, rng, bh, s, hd)
        got = wkv_chunked(*x, chunk=chunk)
        got2 = wkv_chunked(*x, chunk=chunk)
        plain = wkv_chunked_plain(*x, chunk=chunk)
        seq = wkv_chunk_ref(*x)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"wkv_chunked {label}: non-finite output")
        if not torch.equal(got.view(torch.int32), got2.view(torch.int32)):
            raise AssertionError(f"wkv_chunked {label}: two runs differ")
        err = (got.double() - plain.double()).abs().amax(dim=(1, 2))
        tol = WKV_ULPS_PER_STEP * chunk * U32 * \
            plain.double().abs().amax(dim=(1, 2))
        if bool((err > tol).any()):
            i = int(torch.argmax(err / tol))
            raise AssertionError(
                f"wkv_chunked {label}: row {i} |kernel - plain chunked| "
                f"{float(err[i])} > {float(tol[i])}")
        torch.testing.assert_close(got, seq, **WKV_TOL)
        max_err = max(max_err, float(err.max()))
        seq_err = max_abs_diff(got, seq)
        stats[label] = dict(BH=bh, S=s, hd=hd, chunk=chunk,
                            max_abs_err=float(err.max()),
                            bound_share=float((err / tol).max()),
                            max_abs_err_vs_sequential=seq_err)
        log(f"[phase 2] wkv_chunked {label} (BH={bh}, S={s}, hd={hd}, "
            f"chunk={chunk}): max |kernel - plain chunked| "
            f"{float(err.max()):.3g} (largest share of its bound "
            f"{float((err / tol).max()):.3f}), max |kernel - sequential| "
            f"{seq_err:.3g}; finite, two runs bitwise equal")
        if label == "prefill":
            nbytes = 4 * (5 * bh * s * hd + bh * hd)
            b_ms, b_by = bound_ms(nbytes, wkv_ops(bh, s, hd, chunk))
            ms, call_ms = timed(lambda: wkv_chunked(*x, chunk=chunk))
            plain_ms, plain_call_ms = timed(
                lambda: wkv_chunked_plain(*x, chunk=chunk))
            # the oracle's 2,048 steps are some 14,000 device operations a
            # call, too many for the profiler's windows: CUDA events only
            seq_call_ms = time_ms(lambda: wkv_chunk_ref(*x), reps=3,
                                  warmup=1)
            stats[label].update(
                ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                plain_call_ms=plain_call_ms, sequential_call_ms=seq_call_ms,
                library_ms=None, bound_ms=b_ms, bound_by=b_by)
            log(f"[phase 2] wkv_chunked {label}: {ms:.4f} ms ({call_ms:.4f} "
                f"ms per call), plain chunked {plain_ms:.4f} ms, sequential "
                f"{seq_call_ms:.1f} ms per call, no single library call; "
                f"bound "
                f"{b_ms:.6f} ms ({b_by})")
        del x, got, got2, plain, seq
    x = wkv_inputs(dev, rng, 2, 64, 128)
    try:
        wkv_chunked(*x, chunk=64)
    except ValueError as e:
        log(f"[phase 2] wkv_chunked hd=128, chunk=64 refused: {e}")
    else:
        raise AssertionError("wkv_chunked: a block above the card's shared "
                             "memory did not raise")
    return max_err, stats


# ---------------------------------------------------------------------- #
# phase 8: rwkv6-3b prefill and greedy serving at full width
# ---------------------------------------------------------------------- #
def lm_requests(rng, vocab):
    """LM_SERVE's requests: prompts of 1 to max_prompt tokens (both ends
    present), new_tokens each."""
    from repro_torch.serving import Request
    c = LM_SERVE
    lens = rng.integers(1, c["max_prompt"] + 1, c["requests"])
    lens[:2] = (1, c["max_prompt"])
    return [Request(i, rng.integers(1, vocab, int(n)),
                    max_new_tokens=c["new_tokens"])
            for i, n in enumerate(lens)]


def run_lm(dev, rng):
    """Phase 8: rwkv6-3b at full width, fp32 weights from a CUDA generator
    (seed 0), TF32 off. (a) make_prefill_step at B = 4, S = 2,048 with
    rwkv_mode="chunked_kernel" against "chunked" (plain): last-position
    logits within LM_LOGIT_TOL. (b) a 64-token prompt through decode_step
    (no kernel) ends at the kernel prefill's last logits within
    LM_LOGIT_TOL. (c) ServeEngine(slots=4, max_seq=64) answers 8 greedy
    requests (prompts of 1-16 tokens, 16 new tokens): all done, none
    truncated. (d) wkv_chunked launched 32 times per prefill forward and
    never while decoding. Returns (results, state for phase 7)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.specs import InputShape, model_flops
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.nn import transformer as T
    from repro_torch.serving import ServeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(LM_ARCH)
    kcfg = dataclasses.replace(cfg, rwkv_mode="chunked_kernel")
    pcfg = dataclasses.replace(cfg, rwkv_mode="chunked")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = T.init_params(cfg, generator=torch.Generator(device=dev)
                           .manual_seed(0), device=dev)
    torch.cuda.synchronize()
    res = dict(init_s=time.perf_counter() - t0,
               params=T.count_params(params),
               param_bytes=sum(t.numel() * t.element_size()
                               for _, t in T.leaves(params)))
    if res["params"] != 3_073_313_280:
        raise AssertionError(f"{LM_ARCH}: {res['params']} parameters")
    log(f"[phase 8] {LM_ARCH}: {res['params']:,} fp32 parameters "
        f"({res['param_bytes'] / 1e9:.2f} GB) drawn on the card in "
        f"{res['init_s']:.2f} s")
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (LM_B, LM_S))
                           ).to(dev)
    batch = {"tokens": tok}
    prefill_k, prefill_p = make_prefill_step(kcfg), make_prefill_step(pcfg)
    windows = {}
    with torch.inference_mode():
        # (a) the main path: one kernel prefill, counts around exactly it
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        lk = prefill_k(params, batch)
        torch.cuda.synchronize()
        windows["prefill"] = launch_counts()
        res["prefill_peak_bytes"] = torch.cuda.max_memory_allocated()
        lp = prefill_p(params, batch)
        torch.cuda.synchronize()
        for name, x in (("kernel", lk), ("plain", lp)):
            if tuple(x.shape) != (LM_B, cfg.vocab_size) or \
                    not bool(torch.isfinite(x).all()):
                raise AssertionError(f"{name} prefill logits: shape "
                                     f"{tuple(x.shape)} or not finite")
        res["prefill_max_abs_diff"] = max_abs_diff(lk, lp)
        torch.testing.assert_close(lk, lp, **LM_LOGIT_TOL)
        res["prefill_argmax_agree"] = int(
            (lk.argmax(-1) == lp.argmax(-1)).sum())
        res["prefill_ms"] = time_ms(lambda: prefill_k(params, batch),
                                    reps=3, warmup=1)
        res["plain_prefill_ms"] = time_ms(lambda: prefill_p(params, batch),
                                          reps=3, warmup=1)
        res["prefill_flop"] = model_flops(
            cfg, InputShape("prefill", LM_S, LM_B, "prefill"))
        res["prefill_tflops"] = res["prefill_flop"] / res["prefill_ms"] / 1e9
        log(f"[phase 8a] prefill B={LM_B}, S={LM_S}: kernel == plain "
            f"chunked last logits within {LM_LOGIT_TOL} (max |diff| "
            f"{res['prefill_max_abs_diff']:.3g}, argmax agrees in "
            f"{res['prefill_argmax_agree']} of {LM_B}); kernel "
            f"{res['prefill_ms']:.1f} ms = {res['prefill_tflops']:.2f} "
            f"TFLOP/s of model FLOPs ({res['prefill_flop']:.4g}), plain "
            f"{res['plain_prefill_ms']:.1f} ms; peak memory "
            f"{res['prefill_peak_bytes'] / 1e9:.2f} GB")
        # (b) a prompt through decode_step against the kernel prefill
        n = LM_DECODE_PROMPT
        tok_b = tok[:, :n].contiguous()
        reset_counts()
        want = prefill_k(params, {"tokens": tok_b})
        torch.cuda.synchronize()
        windows["prefill_b"] = launch_counts()
        cache = T.init_decode_cache(cfg, LM_B, device=dev)
        reset_counts()
        for t in range(n):
            logits, cache = T.decode_step(params, cfg, tok_b[:, t:t + 1],
                                          cache)
        torch.cuda.synchronize()
        windows["decode"] = launch_counts()
        res["decode_max_abs_diff"] = max_abs_diff(logits[:, 0], want)
        torch.testing.assert_close(logits[:, 0], want, **LM_LOGIT_TOL)
        res["decode_argmax_agree"] = int(
            (logits[:, 0].argmax(-1) == want.argmax(-1)).sum())
        serve_step = make_serve_step(cfg)
        step_batch = {"tokens": tok_b[:, -1:]}
        res["decode_step_ms"] = time_ms(
            lambda: serve_step(params, cache, step_batch), reps=10,
            warmup=2)
        res["decode_floor_ms"] = res["param_bytes"] / HBM_BYTES_PER_S * 1e3
        log(f"[phase 8b] {n} tokens through decode_step == the kernel "
            f"prefill's last logits within {LM_LOGIT_TOL} (max |diff| "
            f"{res['decode_max_abs_diff']:.3g}, argmax agrees in "
            f"{res['decode_argmax_agree']} of {LM_B}); a steady decode step "
            f"{res['decode_step_ms']:.3f} ms against the "
            f"{res['decode_floor_ms']:.3f} ms of reading the weights")
    # (c) greedy serving through the engine (its own inference mode)
    reqs = lm_requests(rng, cfg.vocab_size)
    engine = ServeEngine(cfg, params, slots=LM_SERVE["slots"],
                         max_seq=LM_SERVE["max_seq"])
    reset_counts()
    t0 = time.perf_counter()
    engine.run(reqs)
    torch.cuda.synchronize()
    res["serve_s"] = time.perf_counter() - t0
    windows["serve"] = launch_counts()
    for r in reqs:
        if not (r.done and not r.truncated and
                len(r.output) == LM_SERVE["new_tokens"] and
                all(0 <= x < cfg.vocab_size for x in r.output)):
            raise AssertionError(f"request {r.request_id}: done={r.done}, "
                                 f"truncated={r.truncated}, {r.output}")
    res["serve_tokens"] = {r.request_id: r.output for r in reqs}
    log(f"[phase 8c] ServeEngine(slots={LM_SERVE['slots']}, max_seq="
        f"{LM_SERVE['max_seq']}): {len(reqs)} requests (prompts "
        f"{sorted(len(r.prompt) for r in reqs)} tokens) all done, none "
        f"truncated, {LM_SERVE['new_tokens']} tokens each, in "
        f"{res['serve_s']:.2f} s; request 0 -> {reqs[0].output}")
    # (d) the launch counts of the path
    for label, forwards in (("prefill", 1), ("prefill_b", 1), ("decode", 0),
                            ("serve", 0)):
        got = windows[label]
        want_n = cfg.num_layers * forwards
        others = {k: v for k, v in got.items() if k != "wkv_chunked" and v}
        if got["wkv_chunked"] != want_n or others:
            raise AssertionError(f"phase 8 {label}: launches {got}, "
                                 f"expected wkv_chunked {want_n} only")
    res["launches"] = windows
    log(f"[phase 8d] wkv_chunked launches: {windows['prefill']['wkv_chunked']}"
        f" in the S={LM_S} prefill, {windows['prefill_b']['wkv_chunked']} in "
        f"the S={n} prefill, {windows['decode']['wkv_chunked']} in {n} decode "
        f"steps, {windows['serve']['wkv_chunked']} in the engine's run")
    state = dict(params=params, batch=batch, prefill=prefill_k,
                 serve_step=serve_step, cache=cache, step_batch=step_batch)
    return res, state


def profile_lm(state):
    """Phase 7 for the LM path: one kernel prefill and one steady decode
    step — host time, the card's busy time, the idle share, the top device
    operations and the WKV kernel's share of the prefill."""
    import torch
    out = {}
    with torch.inference_mode():
        w = profiled(lambda: state["prefill"](state["params"], state["batch"]),
                     1, host=False)
        wkv_us = sum(t for n, t in w["by_name"].items()
                     if n.startswith("wkv_chunk"))
        top = sorted(w["by_name"].items(), key=lambda kv: -kv[1])[:8]
        out["lm_prefill"] = dict(
            step_ms=w["wall_us"] / 1e3, device_ms_per_step=w["busy_us"] / 1e3,
            idle_share=1.0 - w["busy_us"] / w["wall_us"],
            device_events=w["count"], wkv_ms=wkv_us / 1e3,
            wkv_share=wkv_us / w["busy_us"],
            top_device_ms_per_step={n: t / 1e3 for n, t in top})
        out["lm_decode_step"] = step_profile(
            lambda: state["serve_step"](state["params"], state["cache"],
                                        state["step_batch"]))
    return out


# ---------------------------------------------------------------------- #
# phase 6: the training path through its entry point
# ---------------------------------------------------------------------- #
def train_once(argv):
    """``repro_torch.launch.train`` with ``argv``: train, then the test
    evaluation. Returns its result and the kernel launches the run
    made."""
    from repro_torch.launch import train
    reset_counts()
    t0 = time.perf_counter()
    out = train.main(argv)
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = launch_counts()
    return out


def param_bits(trainer):
    """Every parameter's bits, the entity table dense (a sharded table
    unsharded to its real rows)."""
    import torch
    from repro_torch.sharding import unshard_table
    out = {}
    for name, p in trainer.params.named_parameters():
        t = p.detach()
        if name == "entity_embedding" and t.dim() == 3:
            t = unshard_table(t, trainer.train_kg.num_entities)
        out[name] = t.contiguous().view(torch.int32)
    return out


def bitwise_mismatch(a, b):
    """Names of the parameters whose bits differ between two trainers."""
    import torch
    pa, pb = param_bits(a), param_bits(b)
    return [n for n in pa if not torch.equal(pa[n], pb[n])]


def two_runs_bitwise(trainer, batch, generators_fn):
    """Two runs of one step of ``trainer`` on ``batch`` from the same
    parameters and optimizer state: the losses and the parameters after
    the step must be bitwise equal. Returns the loss."""
    import torch
    params = [p for _, p in trainer.params.named_parameters()]
    saved = [p.detach().clone() for p in params]
    state = trainer.opt_state
    runs = []
    for _ in range(2):
        with torch.no_grad():
            for p, s in zip(params, saved):
                p.copy_(s)
        trainer.opt_state = state
        loss = trainer.step(batch, generators_fn())
        runs.append((loss, param_bits(trainer)))
    (l1, p1), (l2, p2) = runs
    bad = [n for n in p1 if not torch.equal(p1[n], p2[n])]
    if l1 != l2 or bad:
        raise AssertionError(f"two runs of one step differ: losses {l1!r} "
                             f"{l2!r}, parameters {bad}")
    return l1


def int8_grads_equal_fp32_on_dequant(trainer, batch):
    """One mini-batch loss of trainer 0 (no dropout) through the int8
    gather, against the fp32 path with the master replaced by its
    dequantized self: the loss and every gradient, the master table's
    included, must be bitwise equal (the straight-through backward is the
    fp32 path's scatter-add). Returns the loss."""
    import dataclasses
    import torch
    from repro_torch.models.kge import minibatch_loss
    from repro_torch.sharding import dequantize_rows, quantize_rows
    from repro_torch.training.distributed import trainer_slice
    part = trainer_slice(batch, 0)
    cfg8 = trainer.kge_cfg
    cfg32 = dataclasses.replace(cfg8, rgcn=dataclasses.replace(
        cfg8.rgcn, table_dtype="fp32"))
    names, params = zip(*trainer.params.named_parameters())
    table = trainer.params.entity_embedding
    saved = table.detach().clone()
    loss8, _ = minibatch_loss(trainer.params, cfg8, part)
    g8 = torch.autograd.grad(loss8, params)
    try:
        with torch.no_grad():
            table.copy_(dequantize_rows(*quantize_rows(saved)))
        loss32, _ = minibatch_loss(trainer.params, cfg32, part)
        g32 = torch.autograd.grad(loss32, params)
    finally:
        with torch.no_grad():
            table.copy_(saved)
    bad = [n for n, a, b in zip(names, g8, g32)
           if not torch.equal(a.view(torch.int32), b.view(torch.int32))]
    if loss8.item() != loss32.item() or bad:
        raise AssertionError(f"int8 vs fp32 on the dequantized master: "
                             f"losses {loss8.item()!r} {loss32.item()!r}, "
                             f"gradients differ in {bad}")
    return loss8.item()


def first_batch(trainer, epoch):
    """The first device batch the trainer's pipeline gives for ``epoch``
    (the pipeline is closed after it)."""
    it = trainer.pipeline.device_batches(epoch)
    batch = next(iter(it))
    close = getattr(it, "close", None)
    if close is not None:
        close()
    return batch


def plain_twin(trainer):
    """The trainer's encoder config with the plain message passing."""
    import dataclasses
    cfg = trainer.kge_cfg
    return dataclasses.replace(cfg, rgcn=dataclasses.replace(
        cfg.rgcn, use_kernel=False))


# ---------------------------------------------------------------------- #
# phases 3-4: the serving path through its entry points
# ---------------------------------------------------------------------- #
def serve_argv(width, decoder, shards, requests, filtered, cache_size,
               table_dtype="fp32"):
    return (["--entities", str(width["entities"]),
             "--relations", str(width["relations"]),
             "--dim", str(width["dim"]), "--decoder", decoder,
             "--table-shards", str(shards), "--slots", str(SLOTS),
             "--topk", str(K), "--requests", str(requests), "--zipf", "1.3",
             "--cache-size", str(cache_size), "--seed", "0",
             "--table-dtype", table_dtype, "--device", "cuda"]
            + (["--filtered"] if filtered else []))


def serve_once(width, decoder, shards, requests, *, filtered, cache_size,
               table_dtype="fp32"):
    from repro_torch.kernels import KERNELS
    from repro_torch.launch import serve
    argv = serve_argv(width, decoder, shards, requests, filtered, cache_size,
                      table_dtype)
    before = {n: w.launches for n, w in KERNELS.items()}
    out = serve.run(serve.parse_args(argv))
    if not out["equal_dense"]:
        raise AssertionError(f"{decoder} S={shards} {table_dtype}: sharded "
                             f"!= dense")
    # the run's top-k calls: warmup step, one per batch, one in the check;
    # the check's dense block is one more kge_score launch
    calls = 1 + -(-requests // SLOTS) + 1
    delta = {n: w.launches - before[n] for n, w in KERNELS.items()}
    out["launches"] = delta
    out["launches_per_step"] = {
        n: (delta[n] - (n == "kge_score")) / calls for n in delta}
    return out


def profile_serving(width, decoder, shards, *, filtered, cache_size,
                    table_dtype="fp32", steps: int = 10):
    """Where a serving step's time goes (phase 7): :func:`step_profile` of
    ``steps`` steady engine steps. The profiled stream is played once
    before the windows, so every window meets the same cache state and
    launches the same work."""
    from repro_torch.launch import serve
    from repro_torch.serving import KGEServeEngine
    args = serve.parse_args(
        serve_argv(width, decoder, shards, 0, filtered, cache_size,
                   table_dtype))
    server, _, _ = serve.build_server(args)
    engine = KGEServeEngine(server, slots=SLOTS, max_k=K, filtered=filtered)
    rng = np.random.default_rng(3)
    heads = np.minimum(rng.zipf(1.3, SLOTS * steps) - 1,
                       width["entities"] - 1)
    rels = rng.integers(0, width["relations"], heads.size)

    def stream():
        for i in range(steps):
            for j in range(i * SLOTS, (i + 1) * SLOTS):
                engine.submit(int(heads[j]), int(rels[j]), k=K)
            engine.run()

    stream()
    p = step_profile(stream, top=6)
    for key in ("step_ms", "device_ms_per_step"):
        p[key] /= steps
    p["top_device_ms_per_step"] = {
        n: t / steps for n, t in p["top_device_ms_per_step"].items()}
    return p


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every result to this JSON file")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import KERNELS, _build
    from repro_torch.training.evaluation import encode_all_entities

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = nvidia_smi()
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # phase 1: build
    t0 = time.perf_counter()
    logs = _build.build(ptxas_info=True)
    build_s = time.perf_counter() - t0
    log(f"[phase 1] built {sorted(logs)} with nvcc in {build_s:.1f} s")
    ptxas = {name: [line.strip() for line in text.splitlines()
                    if "registers" in line or "spill" in line
                    or "smem" in line]
             for name, text in logs.items()}
    for name, lines in ptxas.items():
        for line in lines:
            log(f"[phase 1] {name}: {line}")

    # phase 2: kernel vs plain at the serving and training shapes
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    part = training_partition()
    log(f"[phase 2] training partition: V={part['V']}, E={part['E']} "
        f"({int(part['mask'].sum())} real edges), R={part['R']}; "
        f"preprocessing {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mbs = minibatch_arrays()
    log(f"[phase 2] mini-batch: budgets V={mbs['V']}, E={mbs['E']}, "
        f"T={mbs['T']}; the first batch's comp graph holds "
        f"{mbs['comp_vertices']} vertices and {int(mbs['mask'].sum())} "
        f"edges; preprocessing {time.perf_counter() - t0:.1f} s")
    n, d = FB15K["entities"], FB15K["dim"]
    rank_rows = mbs["layout"].rows_per_shard
    widths = [("fb15k237_S1", n, d), ("fb15k237_S4", -(-n // 4), d),
              ("citation2_S1", CITATION2["entities"], CITATION2["dim"]),
              ("rank_S4", rank_rows, d, 256)]
    gather_widths = [("fb15k237", n, d),
                     ("citation2", CITATION2["entities"], CITATION2["dim"])]
    phase2 = {"kge_score": check_kge_score(dev, rng, widths),
              "topk": check_topk(dev, rng, widths[:3]),
              "fused_gather": check_fused_gather(dev, rng, gather_widths,
                                                 mbs)}
    fdg_err, fdg_stats, table_bytes = check_fused_dequant_gather(
        dev, rng, gather_widths, mbs)
    phase2["fused_dequant_gather"] = (fdg_err, fdg_stats)
    bm_err, bm_stats, bm_configs = check_basis_message(dev, rng, part, mbs)
    phase2["basis_message"] = (bm_err, bm_stats)
    phase2["segment_sum"] = check_segment_sum(dev, rng, part, mbs)
    phase2["scatter_add_onehot"] = check_scatter_add(dev, rng, mbs)
    phase2["wkv_chunked"] = check_wkv(dev, rng)
    log("[phase 2] kge_score and basis_message within their stated bounds; "
        "topk, fused_gather and fused_dequant_gather bitwise equal to their "
        "plain versions; "
        "segment_sum deg == plain, agg within its bound, runs bitwise "
        "equal; scatter_add_onehot within its bound, non-hit rows 0, runs "
        "bitwise equal; wkv_chunked within its bounds of the plain chunked "
        "form and the sequential oracle, finite, runs bitwise equal")

    # phases 3-4: the serving path; counts read around exactly these runs
    reset_counts()
    runs = {}
    for decoder in ("distmult", "transe"):
        for shards in (1, 4):
            runs[f"fb15k237_{decoder}_S{shards}"] = serve_once(
                FB15K, decoder, shards, 200, filtered=True, cache_size=256)
    log("[phase 3] FB15k-237 width: sharded == dense for distmult and "
        "transe at 1 and 4 shards")
    runs["citation2_distmult_S1"] = serve_once(
        CITATION2, "distmult", 1, 64, filtered=False, cache_size=0)
    log("[phase 4] ogbl-citation2 width: sharded == dense")
    serve_launches = launch_counts()

    # phase 5: every kernel of the serving path launched during phases 3-4
    missing = [k for k in SERVING_KERNELS if serve_launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the serving path: "
                             f"{missing}")
    log(f"[phase 5] launches during phases 3-4: {serve_launches}")
    # phases 3-4 with the int8 table; counts read around exactly these
    reset_counts()
    for decoder in ("distmult", "transe"):
        for shards in (1, 4):
            runs[f"fb15k237_{decoder}_S{shards}_int8"] = serve_once(
                FB15K, decoder, shards, 200, filtered=True, cache_size=256,
                table_dtype="int8")
    runs["citation2_distmult_S4_int8"] = serve_once(
        CITATION2, "distmult", 4, 64, filtered=False, cache_size=0,
        table_dtype="int8")
    serve_int8_launches = launch_counts()
    missing = [k for k in SERVING_INT8_KERNELS if serve_int8_launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the int8 serving "
                             f"path: {missing}")
    log("[phases 3-4] int8 table: sharded == dense over the dequantized "
        "table for distmult and transe at 1 and 4 shards (FB15k-237 width) "
        "and at 4 shards (ogbl-citation2 width)")
    log(f"[phase 5] launches during the int8 serving runs: "
        f"{serve_int8_launches}")
    for fp32_run, int8_run in (("fb15k237_distmult_S4",
                                "fb15k237_distmult_S4_int8"),
                               ("citation2_distmult_S1",
                                "citation2_distmult_S4_int8")):
        b32, b8 = runs[fp32_run]["table_bytes"], runs[int8_run]["table_bytes"]
        log(f"[phases 3-4] device table bytes: {int8_run} {b8} against "
            f"{fp32_run} {b32} ({b8 / b32:.4f}x)")
    rows_c2 = -(-CITATION2["entities"] // 4)
    log(f"[phase 4] int8 citation2 S4: one transient dequantized block of "
        f"{rows_c2} x {CITATION2['dim']} fp32 = "
        f"{rows_c2 * CITATION2['dim'] * 4 / 1e6:.1f} MB")
    for label, r in runs.items():
        log(f"[serve] {label}: p50 {r['p50_ms']:.3f} ms, p99 "
            f"{r['p99_ms']:.3f} ms, {r['qps']:.1f} QPS, launches per step "
            f"{r['launches_per_step']}")

    # phase 6: the training path (counts reset and read inside train_once)
    train = {}
    for label, extra in (("kernel", ["--use-kernel"]), ("plain", [])):
        res = train_once(TRAIN_ARGV + extra)
        train[label] = res
        log(f"[phase 6] {label} run: losses "
            f"{[h['loss'] for h in res['history']]}, epoch times "
            f"{[round(h['t_epoch'], 4) for h in res['history']]} s, "
            f"{res['wall_s']:.1f} s in all; {res['metrics']}")
    train_launches = train["kernel"]["launches"]
    missing = [k for k in TRAINING_KERNELS if train_launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the training path: "
                             f"{missing}")
    epochs = len(train["kernel"]["history"])
    log(f"[phase 6] launches during the kernel run ({epochs} steps + one "
        f"evaluation): {train_launches}; the plain run launched "
        f"{train['plain']['launches']}")
    losses = {k: np.array([h["loss"] for h in r["history"]])
              for k, r in train.items()}
    if not np.isfinite(losses["kernel"]).all():
        raise AssertionError(f"training losses not finite: {losses}")
    np.testing.assert_allclose(losses["kernel"], losses["plain"], **LOSS_TOL)
    trainer = train["kernel"]["trainer"]
    emb_k = trainer.encode_all_entities()
    emb_p = encode_all_entities(trainer.params, plain_twin(trainer),
                                trainer.train_kg, trainer.cfg.num_hops,
                                partitions=trainer.partitions,
                                padded=trainer.padded)
    if emb_k.shape != (FB15K["entities"], FB15K["dim"]) or \
            not bool(torch.isfinite(emb_k).all()):
        raise AssertionError(f"bad embeddings {tuple(emb_k.shape)}")
    emb_err = max_abs_diff(emb_k, emb_p)
    torch.testing.assert_close(emb_k, emb_p, **EMB_TOL)
    for k in ("test_mrr", "test_hits@1", "test_hits@3", "test_hits@10"):
        if not 0.0 <= train["kernel"]["metrics"][k] <= 1.0:
            raise AssertionError(f"metric {k} out of range")
    log(f"[phase 6] kernel == plain losses within {LOSS_TOL}; encoders "
        f"agree within {EMB_TOL} (max |diff| {emb_err:.3g})")
    fg_loss = two_runs_bitwise(trainer, first_batch(trainer, epochs + 1),
                               lambda: trainer.step_generators(epochs + 1,
                                                               0))
    log(f"[phase 6] two runs of one full-graph step (kernel encoder): "
        f"loss {fg_loss!r} and every parameter bitwise equal")

    # phase 6b: the mini-batch path; counts reset and read inside train_once
    mb = {"main": train_once(MB_ARGV + MB_MAIN)}
    mb_launches = mb["main"]["launches"]
    for label, extra in MB_GATES.items():
        mb[label] = train_once(MB_ARGV + extra)
    for label, r in mb.items():
        h = r["history"][0]
        log(f"[phase 6b] {label} run: {h['num_batches']} steps, mean loss "
            f"{h['loss']!r}, device step {h['t_device_step']:.3f} s, host "
            f"exposed {h['t_get_compute_graph']:.3f} s of "
            f"{h['t_host_build']:.3f} s built (overlap "
            f"{h['overlap_fraction']:.3f}), {r['wall_s']:.1f} s in all; "
            f"{r['metrics']}")
    missing = [k for k in MINIBATCH_KERNELS if mb_launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the mini-batch "
                             f"path: {missing}")
    log(f"[phase 6b] launches during the main run: {mb_launches}")
    main_tr = mb["main"]["trainer"]
    main_losses = mb["main"]["history"][0]["losses"]
    if not (len(main_losses) > 1 and np.isfinite(main_losses).all()):
        raise AssertionError(f"mini-batch losses: {main_losses}")
    for label in ("S1", "serial", "dedup"):
        got = mb[label]["history"][0]["losses"]
        bad = bitwise_mismatch(main_tr, mb[label]["trainer"])
        if got != main_losses or bad:
            raise AssertionError(f"mini-batch {label} != main: losses "
                                 f"{got} vs {main_losses}, params {bad}")
    np.testing.assert_allclose(mb["plain"]["history"][0]["losses"],
                               main_losses, **LOSS_TOL)
    log("[phase 6b] per-step losses and final parameters bitwise equal for "
        "--table-shards 1 and 4, --pipeline serial and async, with and "
        f"without --gather-dedup; kernel vs plain encoder within {LOSS_TOL}")
    from repro_torch.eval.ranking import evaluate_both_directions
    emb_mb = main_tr.encode_all_entities()
    if emb_mb.shape != (FB15K["entities"], FB15K["dim"]) or \
            not bool(torch.isfinite(emb_mb).all()):
        raise AssertionError(f"bad embeddings {tuple(emb_mb.shape)}")
    splits = main_tr.splits
    rank_args = (emb_mb, {k: v.detach() for k, v in
                          main_tr.params["decoder"].items()}, splits["test"],
                 [splits[k] for k in ("train", "valid", "test")],
                 splits["train"].num_relations)
    sharded_m = evaluate_both_directions(*rank_args, num_shards=4)
    dense_m = evaluate_both_directions(*rank_args, num_shards=1)
    if sharded_m != dense_m or {f"test_{k}": v for k, v in
                                sharded_m.items()} != mb["main"]["metrics"]:
        raise AssertionError(f"4-shard ranking {sharded_m} != dense "
                             f"{dense_m} (run: {mb['main']['metrics']})")
    log(f"[phase 6b] 4-shard ranking == dense ranking: {dense_m}")
    mb_batch = first_batch(main_tr, 2)
    mb_loss = two_runs_bitwise(main_tr, mb_batch,
                               lambda: main_tr.step_generators(2, 0))
    log(f"[phase 6b] two runs of one mini-batch step: loss {mb_loss!r} and "
        f"every parameter bitwise equal")

    # phase 6c: the int8 mini-batch path; counts reset and read inside
    # train_once
    mb8 = {"main": train_once(MB_ARGV + MB_MAIN + INT8)}
    mb8_launches = mb8["main"]["launches"]
    for label, extra in MB_INT8_GATES.items():
        mb8[label] = train_once(MB_ARGV + extra)
    for label, r in mb8.items():
        h = r["history"][0]
        log(f"[phase 6c] int8 {label} run: {h['num_batches']} steps, mean "
            f"loss {h['loss']!r}, device step {h['t_device_step']:.3f} s, "
            f"host exposed {h['t_get_compute_graph']:.3f} s of "
            f"{h['t_host_build']:.3f} s built (overlap "
            f"{h['overlap_fraction']:.3f}), {r['wall_s']:.1f} s in all; "
            f"{r['metrics']}")
    missing = [k for k in MINIBATCH_INT8_KERNELS if mb8_launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the int8 mini-batch "
                             f"path: {missing}")
    log(f"[phase 6c] launches during the int8 main run: {mb8_launches}")
    main8 = mb8["main"]["trainer"]
    main8_losses = mb8["main"]["history"][0]["losses"]
    if not (len(main8_losses) > 1 and np.isfinite(main8_losses).all()):
        raise AssertionError(f"int8 mini-batch losses: {main8_losses}")
    for label in MB_INT8_GATES:
        got = mb8[label]["history"][0]["losses"]
        bad = bitwise_mismatch(main8, mb8[label]["trainer"])
        if got != main8_losses or bad:
            raise AssertionError(f"int8 mini-batch {label} != main: losses "
                                 f"{got} vs {main8_losses}, params {bad}")
    log("[phase 6c] int8: per-step losses and final parameters bitwise equal "
        "for --table-shards 1 and 4, with and without --gather-dedup")
    emb8 = main8.encode_all_entities()
    if emb8.shape != (FB15K["entities"], FB15K["dim"]) or \
            not bool(torch.isfinite(emb8).all()):
        raise AssertionError(f"bad embeddings {tuple(emb8.shape)}")
    splits = main8.splits
    rank_args = (emb8, {k: v.detach() for k, v in
                        main8.params["decoder"].items()}, splits["test"],
                 [splits[k] for k in ("train", "valid", "test")],
                 splits["train"].num_relations)
    int8_s4 = evaluate_both_directions(*rank_args, num_shards=4,
                                       table_dtype="int8")
    int8_s1 = evaluate_both_directions(*rank_args, num_shards=1,
                                       table_dtype="int8")
    fp32_m = evaluate_both_directions(*rank_args, num_shards=1)
    if int8_s4 != int8_s1 or {f"test_{k}": v for k, v in
                              int8_s4.items()} != mb8["main"]["metrics"]:
        raise AssertionError(f"int8 4-shard ranking {int8_s4} != 1-shard "
                             f"{int8_s1} (run: {mb8['main']['metrics']})")
    drift = abs(int8_s4["mrr"] - fp32_m["mrr"])
    if drift > QUANT_MRR_DRIFT_LIMIT:
        raise AssertionError(f"|MRR(int8) - MRR(fp32)| = {drift} > "
                             f"{QUANT_MRR_DRIFT_LIMIT}")
    log(f"[phase 6c] int8 4-shard ranking == 1-shard: {int8_s4}; fp32 "
        f"ranking of the same embeddings {fp32_m}; |MRR drift| {drift!r} <= "
        f"{QUANT_MRR_DRIFT_LIMIT}")
    mb8_batch = first_batch(main8, 2)
    mb8_loss = two_runs_bitwise(main8, mb8_batch,
                                lambda: main8.step_generators(2, 0))
    log(f"[phase 6c] two runs of one int8 mini-batch step: loss "
        f"{mb8_loss!r} and every parameter bitwise equal")
    st_loss = int8_grads_equal_fp32_on_dequant(main8, mb8_batch)
    log(f"[phase 6c] one int8 step's loss {st_loss!r} and every gradient, "
        f"the master table's included, bitwise the fp32 path's on the "
        f"dequantized master")

    # phase 8: rwkv6-3b prefill and greedy serving at full width; counts
    # reset and read inside run_lm around each part of the path
    lm, lm_state = run_lm(dev, rng)
    lm_launches = {n: sum(w[n] for w in lm["launches"].values())
                   for n in KERNELS}

    # phase 7: where a steady step's time goes
    profiles = profile_lm(lm_state)
    for label, p in profiles.items():
        extra = (f", wkv_chunked {p['wkv_ms']:.3f} ms = "
                 f"{p['wkv_share']:.4f} of device busy"
                 if "wkv_ms" in p else "")
        log(f"[phase 7] {label}: {p['step_ms']:.3f} ms, device busy "
            f"{p['device_ms_per_step']:.3f} ms, idle share "
            f"{p['idle_share']:.3f}{extra}; top "
            f"{p['top_device_ms_per_step']}")
    del lm_state
    configs = [(f"fb15k237_{dec}_S{sh}", FB15K, dec, sh, True, 256)
               for dec in ("distmult", "transe") for sh in (1, 4)]
    configs.append(("citation2_distmult_S1", CITATION2, "distmult", 1,
                    False, 0))
    configs = [c + ("fp32",) for c in configs] + [
        ("fb15k237_distmult_S4_int8", FB15K, "distmult", 4, True, 256,
         "int8"),
        ("citation2_distmult_S4_int8", CITATION2, "distmult", 4, False, 0,
         "int8")]
    for label, width, dec, sh, filt, cache, dtype in configs:
        p = profile_serving(width, dec, sh, filtered=filt, cache_size=cache,
                            table_dtype=dtype)
        profiles[label] = p
        log(f"[phase 7] serve {label}: {p['step_ms']:.3f} ms per step, "
            f"device busy {p['device_ms_per_step']:.3f} ms, idle share "
            f"{p['idle_share']:.3f}; top {p['top_device_ms_per_step']}")
    for label in ("kernel", "plain"):
        tr = train[label]["trainer"]
        p = step_profile(tr.train_epoch)
        profiles[f"train_step_{label}"] = p
        log(f"[phase 7] train step ({label} encoder): {p['step_ms']:.3f} ms, "
            f"device busy {p['device_ms_per_step']:.3f} ms, idle share "
            f"{p['idle_share']:.3f}; top {p['top_device_ms_per_step']}")
    p = step_profile(trainer.encode_all_entities)
    profiles["eval_encode_kernel"] = p
    log(f"[phase 7] eval encode (kernel encoder): {p['step_ms']:.3f} ms, "
        f"device busy {p['device_ms_per_step']:.3f} ms, idle share "
        f"{p['idle_share']:.3f}; top {p['top_device_ms_per_step']}")
    gens = main_tr.step_generators(2, 0)
    p = step_profile(lambda: main_tr.step(mb_batch, gens))
    profiles["minibatch_step_kernel"] = p
    log(f"[phase 7] mini-batch step (4-shard table, kernel encoder): "
        f"{p['step_ms']:.3f} ms, device busy {p['device_ms_per_step']:.3f} "
        f"ms, idle share {p['idle_share']:.3f}; top "
        f"{p['top_device_ms_per_step']}")
    gens8 = main8.step_generators(2, 0)
    p = step_profile(lambda: main8.step(mb8_batch, gens8))
    profiles["minibatch_step_int8"] = p
    log(f"[phase 7] int8 mini-batch step (4-shard table, kernel encoder): "
        f"{p['step_ms']:.3f} ms, device busy {p['device_ms_per_step']:.3f} "
        f"ms, idle share {p['idle_share']:.3f}; top "
        f"{p['top_device_ms_per_step']}")
    h = mb["main"]["history"][0]
    profiles["minibatch_pipeline"] = {
        k: h[k] for k in ("num_batches", "t_get_compute_graph",
                          "t_host_build", "t_warmup", "overlap_fraction",
                          "t_device_step", "t_epoch")}
    log(f"[phase 7] async pipeline over the main epoch: exposed wait "
        f"{h['t_get_compute_graph']:.4f} s of {h['t_host_build']:.4f} s "
        f"built, overlap {h['overlap_fraction']:.4f}, warm-up "
        f"{h['t_warmup']:.4f} s; {h['num_batches']} steps, "
        f"{1e3 * h['t_device_step'] / h['num_batches']:.2f} ms per step")

    kernels = []
    # each kernel's head shape: the mini-batch path's where it runs there
    heads = {"kge_score": "rank_S4", "topk": "citation2_S1",
             "fused_gather": "minibatch_S4",
             "fused_dequant_gather": "minibatch_S4",
             "basis_message": "minibatch", "segment_sum": "minibatch",
             "scatter_add_onehot": "table_grad", "wkv_chunked": "prefill"}
    for name, head_shape in heads.items():
        max_err, stats = phase2[name]
        head = stats[head_shape]
        by_path = {"serve": serve_launches[name],
                   "serve_int8": serve_int8_launches[name],
                   "train": train_launches[name],
                   "minibatch": mb_launches[name],
                   "minibatch_int8": mb8_launches[name],
                   "lm": lm_launches[name]}
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=sum(by_path.values()),
            launches_by_path=by_path, max_abs_err=max_err, ms=head["ms"],
            plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=head["library_ms"],
            widths=stats))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": card, "build_s": build_s, "ptxas": ptxas,
                       "kernels": kernels, "basis_message_configs": bm_configs,
                       "serve": runs,
                       "train": {k: {"history": r["history"],
                                     "metrics": r["metrics"],
                                     "launches": r["launches"],
                                     "wall_s": r["wall_s"]}
                                 for k, r in train.items()},
                       "minibatch": {k: {"history": r["history"],
                                         "metrics": r["metrics"],
                                         "launches": r["launches"],
                                         "wall_s": r["wall_s"]}
                                     for k, r in mb.items()},
                       "minibatch_int8": {k: {"history": r["history"],
                                              "metrics": r["metrics"],
                                              "launches": r["launches"],
                                              "wall_s": r["wall_s"]}
                                          for k, r in mb8.items()},
                       "int8_table_bytes": table_bytes,
                       "int8_ranking": {"S4": int8_s4, "S1": int8_s1,
                                        "fp32": fp32_m, "mrr_drift": drift},
                       "fullgraph_two_run_loss": fg_loss,
                       "minibatch_two_run_loss": mb_loss,
                       "minibatch_int8_two_run_loss": mb8_loss,
                       "embedding_max_abs_diff": emb_err,
                       "lm": lm,
                       "profile": profiles,
                       "total_s": time.perf_counter() - t_start}, f, indent=1)
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
