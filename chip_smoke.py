#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--out results.json]

Phases, each of which fails the run on error:

1. Build: compile the five CUDA sources from ``src/repro_torch/csrc`` with
   ``nvcc -Xptxas -v`` for ``sm_90a`` (one process per source, all at
   once); each kernel's registers, shared memory and spills.
2. Kernel vs plain: each of the nine kernels (the eight TPU kernels'
   ports and the WKV gradient) against its plain PyTorch
   version on the card, with its time, its plain version's time, one
   PyTorch library call's time (where one computes the function) and the
   least time the card could take; the eight ports, each redesigned,
   also bitwise against their first kernels (``*_v1``), timed beside them:
   kge_score, topk and fused_gather at the serving shapes, kge_score also
   at the mini-batch ranking shape (B = 256) and, register-tiled, bitwise
   the first kernel (kge_score_v1, timed beside it) there and at edge
   shapes (ragged B and C, d = 1, d = MAX_DIM, B = 1, C below one tile);
   fused_gather and fused_dequant_gather (one kernel body, a warp per
   group of rows) bitwise fused_gather_v1 / fused_dequant_gather_v1 and
   their plain versions at edge shapes (d from 1 to 1,000, float4 and
   char4 rows, a source off its alignment, V = 1, ragged V, groups of
   several rows; two runs bitwise equal); fused_gather at the serving
   shapes and the mini-batch table gather (V = 17,200 into 14,544 x 75);
   fused_dequant_gather at the serving shapes over tables quantized on the
   card, and at the 4-shard mini-batch table gather (V = 17,200 into
   14,544 x 75 int8): bitwise the plain version and
   fused_dequant_gather_v1 (timed beside it), unowned slots exactly 0,
   two runs bitwise equal, a flat id outside the table raises, a table of
   subnormal and zero scales comes through bitwise; quantize_rows on the
   card bitwise the CPU's (FB15k-237 table, subnormal table); basis_message
   and segment_sum at the full-graph FB15k-237 training shape (one padded
   partition of 4: E = 377,984 edges, V = 13,760 vertices, d = 75, B = 2),
   at the mini-batch shape and at edge cases (ragged E, an all-masked
   tile, empty segments, unsorted segments, d_in != d_out, bases over 48 KB
   and over the card's shared memory), basis_message (register-tiled)
   bitwise basis_message_v1 at all six of its cases and timed beside it at
   the two training shapes, with each case's tile, grid and column split;
   segment_sum (on the scatter's passes) bitwise segment_sum_v1, deg ==,
   at all its cases (d = 1, 4, 128, 150 and segments of 64 and 65 chunks
   among them), timed beside it with each pass's time at the mini-batch
   shape; topk (one streaming pass) bitwise topk_scores_v1 and the plain
   version, values and indices, at the serving widths, the shard merge (B
   8, C 40, ids) and edge shapes (k = 1, k = C, k at each register
   bucket's edge and above the largest, C = 1, C < 32, C not a multiple of
   4, a row off 16-byte alignment, B = 1, ties across span boundaries,
   signed-zero ties), at forced span counts, two runs bitwise equal, its
   launches per call logged;
   scatter_add_onehot at the shapes of one mini-batch of
   the mini-batch path (the 4-shard table gradient V = 17,200 into
   R = 14,544, the vertex-state gather backward E = 472,448 into 17,200,
   the relation-coefficient backward into 474 rows, the decoder's
   relation-diagonal, head and tail backwards) and at edge cases (all
   slots unowned, one row hit by every slot, a row of 100,000 hits, R not
   a multiple of 128, V not a multiple of 32, d = 1, 4, 128, V = 0):
   bitwise scatter_add_onehot_v1 (timed beside it, each pass's time at
   the vertex-state gradient), within 2 gamma_n sum|g| of the plain
   version, rows no owned
   slot hits exactly 0, two runs bitwise equal, the 4-shard table gradient
   bitwise the dense one; at the training shapes scatter_add_onehot and
   segment_sum given the plan built on the host (as the pipelines build
   it) bitwise the unplanned calls, timed with and without it;
   wkv_chunked at the rwkv6-3b prefill shape
   (BH = 4 x 40 heads, S = 2,048, hd = chunk = 64) and at edge cases
   (S ragged, BH = 1, S < chunk, chunk = 16, hd = 8, 16, 32) bitwise
   wkv_chunked_v1 (timed beside it, each pass's time at the prefill shape)
   and against the plain chunked form and the sequential oracle: finite,
   two runs bitwise equal; hd = 128, which the first kernel refuses,
   against the plain form and the oracle; the output bitwise whether or
   not the kernel's states are kept (wkv_chunked_states); and a block
   above the card's shared memory (hd = 256) refused.
   wkv_chunked_backward (the gradient, chunk-parallel) at the rwkv6-3b
   training shape (BH = 2 x 40 heads, S = 2,048, hd = chunk = 64) and at
   ragged shapes (S ragged, S < chunk, chunk = 16, hd = 8, 16, 30, 32, a
   strong decay of about -0.5 a step, S = 4,096) against the chunked plain gradient
   taken in fp64 from the same fp32 inputs, within the bound derived
   beside WKV_BWD_CHUNKED_EXTRA, and within the reference's gate of the
   fp64 sequential gradient (autograd through the oracle); two runs
   bitwise equal and bitwise the call given the forward's states; the
   first kernel (wkv_chunked_backward_v1) within its bound (beside
   WKV_BWD_EXTRA) and timed beside it at the training shape, slower;
   hd = 128 refused.
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
   parameters, on the kernel path and on the default path (no
   --use-kernel); the kernel path's steady t_device_step (epochs 2-3) is
   no larger than the plain path's.
6b. Training, edge mini-batches at full width: --batch-size 4096
   --table-shards 4 --pipeline async --use-kernel, one epoch (24 steps of
   4 trainers), then the filtered test evaluation with 4-shard ranking;
   launch counts of that path (fused_gather, scatter_add_onehot,
   basis_message, segment_sum and kge_score each launched). Against it,
   one epoch each with --table-shards 1, --pipeline serial and
   --gather-dedup must give bitwise-equal per-step losses and final
   parameters, and one without --use-kernel per-step losses within
   rtol=1e-3, atol=1e-4; on the serial pipeline the kernel path's epoch
   t_device_step no larger than the plain path's; the default path at
   --table-shards 1 and on the serial pipeline bitwise the default path
   at 4 shards, async; the 4-shard
   ranking metrics == the dense ranking from the same embeddings; two runs
   of one mini-batch step from the same state give bitwise-equal losses
   and parameters, kernel and default path; the scatter plans a step
   builds on the card: their count, bytes and device time; then, on the
   default and the kernel path, async epochs with the plans built in the
   step (the port's), on the card with the copy and on the host (numpy,
   held bitwise against the card's on one batch), alternated: four
   epochs each, the host's two.
6c. Training, edge mini-batches with the int8 table at full width: phase
   6b's main run with --table-dtype int8; launch counts of that path
   (fused_dequant_gather, scatter_add_onehot, basis_message, segment_sum
   and kge_score each launched). Against it, --table-shards 1 and
   --gather-dedup must give bitwise-equal per-step losses and final
   parameters; two runs of one int8 step are bitwise equal; one step's
   loss and gradients, the master table's included, are bitwise the fp32
   path's on the dequantized master; 4-shard int8 ranking == 1-shard int8
   ranking, and |MRR(int8) - MRR(fp32)| <= 0.02 on the same embeddings.
6d. Resume from a checkpoint: phase 6b's main configuration (without and
   with --table-dtype int8) trains epochs 1-2 without a break; a second
   run trains epoch 1 and saves a checkpoint (``KGETrainer.
   save_checkpoint``); a new trainer restores it (``KGETrainer.restore``)
   and trains epoch 2, at 4 table shards and at 1: per-step losses and
   final parameters bitwise the unbroken run's; the checkpoint's bytes,
   the save and restore times and the resumed runs' launch counts.
6e. Training, ogbl-citation2 at RGCN_CITATION2's widths (128-d features,
   hidden 32, 2 bases, 2 hops, dropout 0.2, distmult): --arch
   rgcn-citation2 --batch-size 118000 --trainers 4 --epochs 1 --scale
   0.045 (the smallest scale at which every trainer's epoch holds two full
   118,000-edge batches) with --use-kernel on the async pipeline, then the
   filtered test evaluation; launch counts of that path (basis_message,
   segment_sum, scatter_add_onehot and kge_score each launched). Against
   it, the run without --use-kernel within rtol=1e-3, atol=1e-4 per step,
   and the serial pipeline bitwise (losses and parameters); two runs of
   one step bitwise on both paths; a steady step's time, device busy and
   idle share; the ogbl candidate-list protocol over the trained
   embeddings (1,000 negatives per test edge from default_rng(0)) at 4
   shards == dense; and phase 2's checks at the batch's shapes:
   basis_message 128 -> 32 and 32 -> 32 (B = 2), segment_sum and the
   vertex-state scatter_add_onehot at d = 32, each against its plain
   version and bitwise its first kernel, timed. The three runs share one
   preprocessing of the graph.
6f. Each rank's own pipeline first: phase 6b's mini-batch pipeline,
   serial and async, built as data rank i of a 4 x 1 mesh (i = 0..3, no
   process group), each rank's first 8 batches bitwise the whole
   pipeline's block and its step count the whole's (the serial rank's
   epoch run to its end); each rank's host build and wall time per step
   beside the whole's. Then the multi-process step on a NCCL process
   group of world size 1 in this process (``file://`` rendezvous under
   ``build/``; a 1 x 1 mesh, the 4 trainers grouped on the one rank):
   phase 6b's configuration with a 1-shard table and --use-kernel, fp32
   and int8, through ``repro_torch.launch.train --spmd``: two steps'
   losses, parameters and Adam moments bitwise the simulated step's
   (--no-spmd), the test evaluation (each rank's row block of the
   embeddings, the rank step) equal, make_sharded_rank_step over the
   rank's row block == the simulated counts in both ranking protocols
   and at both table dtypes;
   the real and the simulated step times, alternated; launch counts of
   the spmd runs. Then checkpoints under spmd, fp32 and int8: two epochs
   under --spmd without a break, against epoch 1, ``save_checkpoint`` and
   a fresh --spmd trainer that restores it and trains epoch 2: per-step
   losses, parameters and Adam moments bitwise; the file's arrays and
   manifest == the --no-spmd trainer's after epoch 1; its bytes, the save
   and restore seconds, the resumed run's launches.
6g. The comm audit on the card (``repro_torch.analysis``), on phase 6f's
   group: ``serve[topk]`` and ``serve[topk,int8]`` at FB15k-237 width
   (filtered) and ogbl-citation2 width (N = 2,927,963), S = 4, 8 queries,
   k = 10, under the recorder: no collective, no output with the
   dimension N (no dense (B, N) score matrix), int8 no float32 image of
   the table; the train step (psum_scatter, fp32 and int8, --use-kernel),
   the test evaluation (``eval[all-entities]``, fp32) and the rank step
   (both protocols, V 14,541, d 75, B 256) at phase 6f's configuration
   on its one-rank group: collectives recorded, all on
   one-rank groups, parameters and moments updated in place, the
   replication rule that names the rank's own block refused by name;
   every program's outputs bitwise with the recorder on and off; a probe
   whose (V, d) buffer exists only in its backward fails the audit. One
   line a program (recorded collectives, rules, violations, launches).
   The group is destroyed before phase 8.
7. Profile under ``torch.profiler``: one rwkv6-3b prefill (with the WKV
   kernel's share of it) and one steady decode step; steady serving steps
   of each serving
   configuration (int8 at 4 shards included), one steady full-graph step
   (kernel and plain encoder), one evaluation encode and one steady
   mini-batch step each of the fp32 (kernel and plain encoder) and int8
   tables: host time per step, the card's busy time, the idle share, the
   sort kernels' time (the plans a step builds: a mini-batch step's all,
   a full-graph step's those of the triplet gathers) and
   the device operations that took the most time; and the async pipeline's exposed wait and overlap
   fraction over the mini-batch epoch.
8. LM serving, rwkv6-3b at full width (run before phase 7's profiles):
   fp32 weights from a CUDA generator, TF32 off. (a) ``make_prefill_step``
   at B = 4, S = 2,048 with the WKV kernel against the plain chunked form
   (last logits within LM_LOGIT_TOL), its time and model-FLOP rate; (b) a
   64-token prompt through ``decode_step`` ends at the kernel prefill's
   last logits, and a steady decode step's time against reading the
   weights; (c) ``ServeEngine(slots=4, max_seq=64)`` answers 8 greedy
   requests, all done and none truncated; (d) wkv_chunked launched 32
   times per prefill forward and never while decoding; (e) the same weights
   rounded to bf16, the reference's default dtype: the bf16 kernel prefill
   within the reference's own bf16 error (its plain chunked bf16 prefill's
   largest |bf16 - fp32| logit) of the plain bf16 prefill, so within twice
   it of the fp32 run, and the 64-token prompt through a bf16 decode_step
   likewise against the bf16 prefill of that prompt; the bf16 prefill's
   time and model-FLOP rate against 989 TFLOP/s, a bf16 decode step's
   time. Cut against the reference's ``prefill_32k`` shape: B = 4 (not 32), S = 2,048 (not
   32,768); the model's depth and widths are whole. Then, after phase 7
   has released the phase-8 weights, (f) LM training at full width: fp32
   weights drawn on the card (seed 0), remat on (the config's); one
   step's loss and gradients of ``loss_fn`` with the WKV kernels against
   the plain chunked form (loss within LM_TRAIN_LOSS_RTOL, every leaf
   within LM_TRAIN_GRAD_REL_L2); three ``make_train_step`` Adam steps on
   ``TokenStream`` batches at B = 2, S = 2,048: finite losses, each step's
   time on CUDA events and its model-FLOP rate against the 67 TFLOP/s
   fp32 peak, wkv_chunked launched 64 times a step (forward and the remat
   recompute) and wkv_chunked_backward 32, nothing else, and the peak
   device memory under the card's 80 GB; then one more step profiled
   (device busy, idle share, the WKV kernels' time, the WKV backward's
   device ms a step, the top operations).

Then one JSON line with the kernels, the ``nvidia-smi`` name and power
limit, and as the last line ``{"ok": true, "device": {...}}``. Without a
CUDA device, or without the repository beside it, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
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
    "plain_S1": ["--table-shards", "1", "--pipeline", "async"],
    "plain_serial": ["--table-shards", "4", "--pipeline", "serial"],
}
INT8 = ["--table-dtype", "int8"]
MB_INT8_GATES = {   # int8 runs held bitwise against the int8 main run
    "S1": MB_GATES["S1"] + INT8,
    "dedup": MB_GATES["dedup"] + INT8,
}
# phase 6d: where the resume runs write their checkpoints (removed after)
CHECKPOINT_DIR = os.path.join(ROOT, "build", "chip_smoke_checkpoints")
# |MRR(int8) - MRR(fp32)| on the same embeddings; the reference's bound,
# QUANT_MRR_DRIFT_LIMIT in benchmarks/pipeline_bench.py:203
QUANT_MRR_DRIFT_LIMIT = 0.02
# phase 6b: where an async epoch's scatter plans are built (plan_placements)
PLACEMENT = {"step": "in the step, at first use (the port's)",
             "copy": "on the card with the copy, on the copy stream",
             "host": "on the host (numpy, in the collator)"}
# phase 6e: ogbl-citation2 at RGCN_CITATION2's widths (128-d features,
# hidden 32, 2 bases, 2 hops, dropout 0.2, distmult) and its 118,000-edge
# mini-batches, 4 trainers, one epoch. The scale is the smallest of the
# synthetic stand-in (in steps of 0.001) at which every trainer's epoch
# holds two full batches: each trainer's partition then has 237,334 core
# edges (train edges and their inverses), at 0.044 fewer than 236,000.
C2_BATCH = 118_000
C2_ARGV = ["--arch", "rgcn-citation2", "--trainers", "4", "--epochs", "1",
           "--scale", "0.045", "--batch-size", str(C2_BATCH),
           "--device", "cuda"]
C2_MAIN = ["--use-kernel"]                     # async pipeline (default)
C2_GATES = {"plain": [], "serial": ["--use-kernel", "--pipeline", "serial"]}
C2_NEGATIVES = 1000     # ogbl-citation2's negatives per test edge
C2_KERNELS = ("basis_message", "segment_sum", "scatter_add_onehot",
              "kge_score")
# phase 6f: the multi-process step at world size 1 (phase 6b's
# configuration with a 1-shard table): its rendezvous file (removed after)
SPMD_RENDEZVOUS = os.path.join(ROOT, "build", "chip_smoke_rendezvous")
SPMD_ARGV = MB_ARGV + ["--table-shards", "1", "--use-kernel"]
SPMD_KERNELS = ("scatter_add_onehot", "basis_message", "segment_sum",
                "kge_score")
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
# wkv_chunked_backward against the plain gradient taken in fp64 from the
# same fp32 inputs: |kernel - plain| <= gamma_n * M elementwise, with M the
# plain gradient of the inputs' absolute values (|r|, |k|, |v|, |u|, |g|,
# the same decays) in fp64, which is each output's sum of |terms|, and
# gamma_n = n u / (1 - n u), n = 4 S + 2 P + 8 (P = hd rounded up to 4).
# Every output is one chain of fp32 roundings: the state or G carried over
# at most S steps (a product and an fmaf a step), each step's decay e^{lw}
# within 2 u of exact (at most S of them in a product), the sum over 4
# columns in a thread and P / 4 partials, and the bonus term's chain of hd
# fmafs and two products; the fp64 side's own error is below 2^-40 M.
WKV_BWD_EXTRA = 8
# The chunk-parallel backward (wkv_chunked_backward) against the chunked
# plain gradient taken in fp64 from the same fp32 inputs: |kernel - plain|
# <= gamma_n * M elementwise, M = wkv_chunked_backward_chunked_plain(...,
# magnitudes=True) in fp64, each output's sum of |terms| along the chunked
# chain, and per row n = 4 (K + 1) L + 3 K + 3 P + 3 nch + 16 (K the chunk,
# P = hd rounded up to 4, nch = ceil(S / K), L the row's largest sum over
# its steps of |lw| of one column). The roundings: the longest fmaf chain,
# dlw's, runs through S_in or G (a chunk's K-step contraction, then one
# fmaf a chunk over at most nch chunks), dr' or dk' (K + P terms), r dr'
# and the in-chunk sum (K + 5 terms), at most 3 K + P + nch + 9 roundings,
# which 3 K + 3 P + 3 nch covers with room; each decay factor e^{l} has its
# exponent from a cumulative sum of at most K + 1 terms, off by at most
# (K + 1) u times their |sum|, and a path meets at most three such factors
# inside its chunk and those of the chunks it is carried over, whose
# exponents add to at most L: 4 (K + 1) u L in all; expf's 2 ulp a factor
# (at most 3 + nch of them) and the products that apply them are the 16
# and the rest of 3 nch. The fp64 side's own error is below 2^-40 M.
# This bounds the rounding of an fp32 chain, not its precision: L is the
# whole row's, though a term carried over chunks is damped by the same
# decays, so at the training shape the kernel reads about 1e-4 of it (on
# an NVIDIA H100 80GB HBM3, 700.00 W), and products in TF32 (some 8,192
# times fp32's unit roundoff) might read below 1. The reference's gate
# against the fp64 sequential gradient is the one that fails a lower
# precision (dlog_decay reads 0.33 of it in fp32 at S = 2,048 there).
WKV_BWD_CHUNKED_EXTRA = 16
# phase 8f: rwkv6-3b training cut against the reference's train_4k shape
# (B = 256, S = 4,096; launch/specs.py:34) to B = 2, S = 2,048 on one card:
# the fp32 parameters, gradients and Adam moments take 49.2 GB of its 80,
# and the logits (B S 65,536 fp32) and the blocks' inputs grow with B S.
LM_TRAIN_B, LM_TRAIN_S, LM_TRAIN_STEPS = 2, 2048, 3
LM_TRAIN_LR = 3e-3     # the reference's --lr default (launch/train.py)
# phase 8f (a): the loss and each gradient leaf of one step, the WKV
# kernels against the plain chunked form, fp32 through 32 layers in other
# summation orders: the reference's loss gate for the chunked form
# (rel 1e-4, tests/test_perf_variants.py:52), and each leaf within 1e-3
# of the plain one in relative L2 norm (a wrong term in any of the five
# WKV gradients moves a leaf by O(1)); the elementwise share of the
# reference's per-layer gradient gate (rtol 5e-3, atol 1e-4) is printed.
LM_TRAIN_LOSS_RTOL = 1e-4
LM_TRAIN_GRAD_REL_L2 = 1e-3
# phase 8f (b): the first step's change of every leaf of at most this many
# elements (the vectors, decay_A and decay_B: 11.7 M) against the
# dict-wide adam update + apply_updates of (a)'s kernel gradients. Adam's
# first step is -lr g / (|g| + eps), about lr sign(g) an element, so two
# gradients a few ulps apart may still flip the sign of an element whose
# gradient is near 0, by 2 lr: 1e-2 in relative L2 allows some 25 flips
# in decay_A's 5.2 M elements, and a wrong learning rate, moment or sign
# misses it by 10x or more.
LM_TRAIN_HELD_NUMEL = 1 << 23
LM_TRAIN_UPDATE_REL_L2 = 1e-2
LM_TRAIN_PEAK_PREDICTED_GB = (63.5, 65.0)     # PERF.md's prediction for 8f
CARD_BYTES = 80e9

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
    # no pallas_call: the reference's VJP of the sequential oracle
    "wkv_chunked_backward": "src/repro/kernels/ops.py:408",
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
    "wkv_chunked_backward": "src/repro_torch/csrc/wkv_chunk.cu",
}
SERVING_KERNELS = ("kge_score", "topk", "fused_gather")
TRAINING_KERNELS = ("basis_message", "segment_sum", "scatter_add_onehot",
                    "kge_score")
MINIBATCH_KERNELS = ("fused_gather", "scatter_add_onehot", "basis_message",
                     "segment_sum", "kge_score")
SERVING_INT8_KERNELS = ("kge_score", "topk", "fused_dequant_gather")
MINIBATCH_INT8_KERNELS = ("fused_dequant_gather", "scatter_add_onehot",
                          "basis_message", "segment_sum", "kge_score")
EVAL_KERNELS = ("kge_score",)   # launched by the evaluation, not a step


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


# the host-side CUDA runtime and driver calls that put work on the card:
# kernel launches, copies and memsets
LAUNCH_API = re.compile(r"^cu\w*(Launch\w*Kernel|Memcpy|Memset)")
# untimed one-element launches before and after each profiler window's
# calls: the tracer has lost up to 24 of a window's last device records
PAD_LAUNCHES = 64
# profiler windows taken, and how many were incomplete
WINDOWS = {"taken": 0, "incomplete": 0}


def device_activity(prof, pad: int = 0):
    """``(busy_us, {name: us}, count, lost)`` of a profile's device-side
    activity (kernels and copies), leaving out the ``pad`` first and last
    host calls that put work on the card (:data:`LAUNCH_API`) and their
    device events: the union of the events' intervals, each short name's
    summed duration, the number of events, and the names of the other
    host calls that have no device event of their correlation id (empty
    in a complete window)."""
    from torch.autograd import DeviceType
    events = prof.events()
    calls = sorted((e for e in events if e.device_type == DeviceType.CPU
                    and LAUNCH_API.match(e.name)),
                   key=lambda e: e.time_range.start)
    if len(calls) < 2 * pad + 1:
        raise RuntimeError(f"the profiler recorded {len(calls)} host calls "
                           f"that put work on the card, fewer than the "
                           f"window's {2 * pad} padding launches and one")
    padding = {e.id for e in calls[:pad] + calls[len(calls) - pad:]}
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and e.id not in padding]
    ids = {e.id for e in device}
    lost = [e.name for e in calls[pad:len(calls) - pad] if e.id not in ids]
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in device)
    busy, end, by_name = 0.0, float("-inf"), {}
    for lo, hi, name in spans:
        key = short_name(name)
        by_name[key] = by_name.get(key, 0.0) + (hi - lo)
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy, by_name, len(spans), lost


def profiled(fn, reps: int, windows: int = 10, host: bool = True):
    """One complete ``torch.profiler`` window of ``reps`` calls of ``fn``:
    ``{"busy_us", "by_name", "count", "wall_us"}``, the wall time on the
    host clock ending in a synchronise. ``host=False`` records no host
    operations, which costs the host less.

    The tracer records every CUDA runtime and driver call that puts work
    on the card (:data:`LAUNCH_API`) and the device event it made, under
    one correlation id. It can lose device events: after phase 6b's
    trainers, windows lost up to 24 of their last events, the same number
    in every retake (windows of a three-pass scatter-add read 0.0225 ms
    where complete ones read 0.17 ms). So each window starts and ends
    with :data:`PAD_LAUNCHES` untimed launches, which are left out of its
    numbers; it is complete when every call of ``fn`` that put work on the
    card has its device event, and an incomplete window is taken again.
    After ``windows`` windows without a complete one it raises, and the
    phase that asked fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    marker = torch.zeros(1, device="cuda")
    seen = []
    for _ in range(windows):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA] + (
                [ProfilerActivity.CPU] if host else [])) as prof:
            for _ in range(PAD_LAUNCHES):
                marker.add_(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
            for _ in range(PAD_LAUNCHES):
                marker.add_(1)
            torch.cuda.synchronize()
        busy, by_name, count, lost = device_activity(prof, PAD_LAUNCHES)
        WINDOWS["taken"] += 1
        if count > 0 and not lost:
            return dict(busy_us=busy, by_name=by_name, count=count,
                        wall_us=wall_us)
        WINDOWS["incomplete"] += 1
        seen.append((count, lost))
    raise RuntimeError(
        f"torch.profiler gave no complete window in {windows} (device "
        f"events, host calls without one, per window: "
        f"{[(c, len(x)) for c, x in seen]}; lost in the last: "
        f"{sorted(set(seen[-1][1]))[:4]}), so no device time can be given")


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
    sort_us = sum(t for n, t in w["by_name"].items() if "sort" in n.lower())
    return dict(step_ms=w["wall_us"] / steps / 1e3,
                device_ms_per_step=w["busy_us"] / steps / 1e3,
                idle_share=1.0 - w["busy_us"] / w["wall_us"],
                device_events=w["count"],
                sort_ms_per_step=sort_us / steps / 1e3,
                top_device_ms_per_step={n: t / steps / 1e3
                                        for n, t in names})


def timed(fn, reps: int = 20, warmup: int = 3):
    """``(ms, call_ms)``: ``ms`` is the device time per call from a
    complete profiler window (:func:`profiled`); ``call_ms`` the
    CUDA-event time of one call, host overhead included."""
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


def score_inputs(dev, rng, b, c, d):
    """Queries, candidates (the first rows equal to the queries:
    zero-distance pairs, the sqrt's worst case) and a bias of 0 / -1e9 /
    -inf."""
    import torch
    u = torch.from_numpy(rng.normal(0, .1, (b, d)).astype(np.float32)
                         ).to(dev)
    cand = torch.from_numpy(rng.normal(0, .1, (c, d)).astype(np.float32)
                            ).to(dev)
    n = min(b, c)
    cand[:n] = u[:n]
    choice = rng.choice(3, size=(b, c), p=[.8, .1, .1])
    bias = torch.from_numpy(np.choose(choice, [
        np.float32(0), np.float32(-1e9), np.float32(-np.inf)]).astype(
            np.float32)).to(dev)
    return u, cand, bias


def score_operands(u, cand, epilogue):
    """``(q, q_bias, c_bias)`` of the epilogue's query form (TransE's norm
    expansion for neg_l2)."""
    import torch
    if epilogue == "neg_l2":
        return -2.0 * u, (u * u).sum(1), (cand * cand).sum(1)
    return (u, torch.zeros(u.shape[0], device=u.device),
            torch.zeros(cand.shape[0], device=u.device))


def same_bits(a, b) -> bool:
    import torch
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def check_kge_score_v1(dev, rng):
    """The register-tiled kge_score against the first kernel
    (``kge_score_v1``) bit for bit at the edge shapes: ragged B and C,
    d = 1, d = MAX_DIM, B = 1, C below one tile, both tile shapes (B <= 8
    and B > 8, with an odd and an even ceil(B / 8)), both epilogues.
    Returns the shapes checked."""
    from repro_torch.kernels.kge_score import (
        MAX_DIM, kge_score, kge_score_v1,
    )
    cases = [(13, 1001, 75), (1, 3636, 75), (8, 5, 75), (300, 77, 1),
             (9, 700, MAX_DIM), (256, 50, MAX_DIM), (65, 129, 33),
             (3, 64, 32), (8, 14541, 75), (100, 1, 17),
             # an odd ceil(B / 8) (ragged last eval batches, 20 slots)
             (17, 1001, 75), (20, 3636, 75), (24, 129, 75), (40, 700, 33),
             (50, 5, 75)]
    for b, c, d in cases:
        u, cand, bias = score_inputs(dev, rng, b, c, d)
        for epilogue in ("bilinear", "neg_l2"):
            q, qb, cb = score_operands(u, cand, epilogue)
            got = kge_score(q, cand, bias, qb, cb, epilogue=epilogue)
            want = kge_score_v1(q, cand, bias, qb, cb, epilogue=epilogue)
            if not same_bits(got, want):
                raise AssertionError(f"kge_score B={b} C={c} d={d} "
                                     f"{epilogue}: tiled != first kernel")
    log(f"[phase 2] kge_score: the tiled kernel == the first kernel bit for "
        f"bit at (B, C, d) {cases}, both epilogues")
    return cases


def check_kge_score(dev, rng, widths):
    """Both epilogues, a bias of 0 / -1e9 / -inf, at each width's
    (C, d[, B]) (B: the serving slots unless given); the tiled kernel
    within the stated bound of the plain version and bitwise the first
    kernel (``kge_score_v1``), whose time is taken beside it. Returns (max
    |err| over finite scores, per-width times)."""
    import torch
    from repro_torch.kernels.kge_score import (
        kge_score, kge_score_plain, kge_score_v1,
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    max_err, stats = 0.0, {}
    for label, c, d, *batch in widths:
        b = batch[0] if batch else SLOTS
        u, cand, bias = score_inputs(dev, rng, b, c, d)
        for epilogue in ("bilinear", "neg_l2"):
            q, qb, cb = score_operands(u, cand, epilogue)
            got = kge_score(q, cand, bias, qb, cb, epilogue=epilogue)
            want = kge_score_plain(q, cand, bias, qb, cb, epilogue=epilogue)
            first = kge_score_v1(q, cand, bias, qb, cb, epilogue=epilogue)
            torch.cuda.synchronize()
            if not same_bits(got, first):
                raise AssertionError(f"kge_score {label} {epilogue}: tiled "
                                     f"kernel != first kernel")
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
        st = stats[label] = dict(B=b, C=c, d=d, **timings(
            lambda: kge_score(q, cand, bias, qb, cb, epilogue="neg_l2"),
            lambda: kge_score_plain(q, cand, bias, qb, cb,
                                    epilogue="neg_l2"),
            lambda: torch.matmul(q, cand.T),
            *bound_ms(nbytes, 2 * b * c * d)))
        st["first_kernel_ms"], _ = timed(
            lambda: kge_score_v1(q, cand, bias, qb, cb, epilogue="neg_l2"))
        report("kge_score", f"{label} (B={b}, C={c}, d={d})", st, "matmul")
        log(f"[phase 2] kge_score {label}: the first kernel "
            f"{st['first_kernel_ms']:.4f} ms, the tiled one {st['ms']:.4f} "
            f"ms ({st['first_kernel_ms'] / st['ms']:.2f}x); bitwise equal")
    return max_err, stats


def same_topk(a, b) -> bool:
    """Two ``(values, indices)`` pairs equal: values bit for bit (-0.0 is
    not +0.0), indices exactly."""
    import torch
    return same_bits(a[0], b[0]) and torch.equal(a[1], b[1])


def signed_zero_row(rng, c):
    """A row of -0.0 with +0.0, -inf and -1e9 scattered in, a few 1.0 in
    front: its top entries tie at zero with both signs."""
    s = np.full(c, -0.0, np.float32)
    s[rng.random(c) < .2] = -np.inf
    s[rng.random(c) < .1] = np.float32(-1e9)
    s[rng.random(c) < 2.0 / c] = 0.0
    s[rng.integers(0, c, 3)] = 1.0
    return s


def topk_edge_cases(dev, rng):
    """The streaming kernel (at its own plan and at forced spans) and
    topk_scores at every k
    against the first kernel (topk_scores_v1) and the plain version, bit
    for bit: k = 1, k = C, k at each register bucket's edge and one above
    the largest (the first kernel's passes), C = 1, C < 32, C not a
    multiple of 4, a row that starts off 16-byte alignment, B = 1, ties
    across span boundaries, signed-zero ties within and across spans, and
    two runs bitwise equal. Returns the cases checked."""
    import torch
    from repro_torch.kernels.topk import (
        STREAM_MAX_K, stream_select, topk_plain, topk_scores, topk_scores_v1,
    )

    def grid_scores(b, c, lo=0, hi=64):
        return (rng.integers(lo, hi, (b, c)) / 8.0).astype(np.float32)

    cases = []
    for b, c, k in ((8, 1, 1), (3, 7, 7), (8, 31, 4), (8, 1001, 8),
                    (1, 14541, 10), (8, 14541, 1), (8, 3636, 16),
                    (8, 3636, 17), (2, 5000, 32), (8, 3636, 33),
                    (4, 40, 40), (8, 14541, 100)):
        cases.append((f"B={b} C={c} k={k}", grid_scores(b, c), k, None))
    # a row 4 bytes past 16-byte alignment (its float4 loads start later)
    cases.append(("misaligned C=14541", grid_scores(8, 14541), 10, "skew"))
    # every entry tied: ties across every span boundary drain by position
    cases.append(("all tied C=1000", np.full((4, 1000), 0.5, np.float32),
                  10, [1, 3, 7, 16]))
    cases.append(("ties across spans C=14541",
                  grid_scores(8, 14541, 60, 64), 32, [2, 4, 5, 13]))
    z = np.stack([signed_zero_row(rng, 14541) for _ in range(8)])
    z[0, :] = -0.0
    z[0, 14000] = 0.0            # one +0.0 in the last span
    z[1, :] = -0.0               # no +0.0 at all
    z[2, :] = -0.0
    z[2, 0] = 0.0                # a +0.0 first, then only -0.0
    cases.append(("signed zeros C=14541", z, 10, [1, 2, 4, 9]))
    cases.append(("signed zeros C=3636", z[:, :3636].copy(), 32, [1, 3]))
    cases.append(("signed zeros C=40 (merge)", z[:, :40].copy(), 10, [1, 3]))
    for label, s, k, spans in cases:
        b, c = s.shape
        if spans == "skew":
            buf = torch.empty(b * c + 1, device=dev)
            scores = buf[1:].view(b, c)
            scores.copy_(torch.from_numpy(s))
            spans = None
        else:
            scores = torch.from_numpy(s).to(dev)
        ids = torch.from_numpy(np.stack([rng.permutation(c) for _ in range(b)]
                                        ).astype(np.int64)).to(dev)
        for with_ids in (None, ids):
            want = topk_plain(scores, k, with_ids)
            first = topk_scores_v1(scores, k, with_ids)
            got = topk_scores(scores, k, with_ids)
            again = topk_scores(scores, k, with_ids)
            torch.cuda.synchronize()
            tag = f"topk {label} (ids={with_ids is not None})"
            if not same_topk(first, want):
                raise AssertionError(f"{tag}: the first kernel != plain")
            if not same_topk(got, want):
                raise AssertionError(f"{tag}: kernel != plain")
            if not same_topk(got, again):
                raise AssertionError(f"{tag}: two runs differ")
            if k <= STREAM_MAX_K:
                for n_sp in spans or ():
                    if not same_topk(stream_select(scores, k, with_ids, n_sp),
                                     want):
                        raise AssertionError(
                            f"{tag}: {n_sp} spans: kernel != plain")
    labels = [c[0] for c in cases]
    log(f"[phase 2] topk: the streaming kernel (forced spans too) and "
        f"topk_scores == the first kernel == plain bit for bit, with and "
        f"without ids, two runs equal, at {labels}")
    return labels


def check_topk(dev, rng, widths):
    """Exact ties, -1e9 and all--inf rows, a row of signed-zero ties, k=10,
    at each serving width (B = the serving slots) and the shard merge (B
    8, C = 4 shards x k, with ids), then the edge cases. The kernel must
    be bitwise the first kernel (``topk_scores_v1``, timed beside it) and
    the plain version, values and indices; launches per call logged; the
    streaming kernel's span count measured against others. Returns
    (max |kernel - plain| over values and indices, per-width times, edge
    cases)."""
    import torch
    from repro_torch.kernels.topk import (
        stream_select, stream_splits, topk_plain, topk_scores, topk_scores_v1,
    )
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    max_err, stats = 0.0, {}
    shapes = [(label, c) for label, c, _ in widths] + [("merge_S4", 4 * K)]
    for label, c in shapes:
        s = (rng.integers(0, 64, (SLOTS, c)) / 8.0).astype(np.float32)
        s[1] = -np.inf                        # all--inf row
        s[2, rng.random(c) < .999] = -np.inf  # mostly -inf: drains by index
        s[3, rng.random(c) < .5] = -1e9       # filtered candidates
        s[4] = signed_zero_row(rng, c)        # signed-zero ties
        scores = torch.from_numpy(s).to(dev)
        ids = torch.from_numpy(
            rng.permutation(c).astype(np.int64)[None].repeat(SLOTS, 0)
        ).to(dev)
        for with_ids in (None, ids):
            got = topk_scores(scores, K, with_ids)
            first = topk_scores_v1(scores, K, with_ids)
            want = topk_plain(scores, K, with_ids)
            torch.cuda.synchronize()
            tag = f"topk {label} (ids={with_ids is not None})"
            if not same_topk(got, want):
                raise AssertionError(f"{tag}: kernel != plain")
            if not same_topk(first, got):
                raise AssertionError(f"{tag}: kernel != first kernel")
            max_err = max(max_err, max_abs_diff(got[0], want[0]),
                          max_abs_diff(got[1], want[1]))
        # the shape the serving path calls: the merge carries ids
        call_ids = ids if label == "merge_S4" else None
        before = topk_scores.launches
        topk_scores(scores, K, call_ids)
        launches = topk_scores.launches - before
        splits = stream_splits(SLOTS, c, sms)
        st = stats[label] = dict(C=c, k=K, launches_per_call=launches,
                                 splits=splits, **timings(
            lambda: topk_scores(scores, K, call_ids),
            lambda: topk_plain(scores, K, call_ids),
            lambda: torch.topk(scores, K),
            # the merge reads the ids of its k winners a row, no more
            *bound_ms(4 * SLOTS * c + 12 * SLOTS * K
                      + (8 * SLOTS * K if call_ids is not None else 0),
                      SLOTS * c)))
        st["first_kernel_ms"], _ = timed(
            lambda: topk_scores_v1(scores, K, call_ids))
        report("topk", f"{label} (B={SLOTS}, C={c}, k={K})", st,
               "torch.topk")
        if label.startswith("citation2"):
            # the streaming kernel's worst case: rows sorted ascending, so
            # every entry beats its warp's bar and goes through a flush
            up = torch.sort(torch.from_numpy(rng.normal(0, 1, (SLOTS, c))
                                             .astype(np.float32)), 1)[0]
            up = up.to(dev)
            if not same_topk(topk_scores(up, K), topk_scores_v1(up, K)):
                raise AssertionError("topk ascending rows: kernel != first "
                                     "kernel")
            st["ascending_ms"], _ = timed(lambda: topk_scores(up, K))
            st["ascending_first_kernel_ms"], _ = timed(
                lambda: topk_scores_v1(up, K))
            log(f"[phase 2] topk {label}, rows sorted ascending: "
                f"{st['ascending_ms']:.4f} ms, the first kernel "
                f"{st['ascending_first_kernel_ms']:.4f} ms; bitwise equal")
        # other span counts
        alt = {}
        for n_sp in sorted({1, 2, 4, 8, splits // 2, splits, 2 * splits}):
            if 1 <= n_sp <= c:
                alt[n_sp], _ = timed(lambda: stream_select(
                    scores, K, call_ids, n_sp))
        st["spans_ms"] = alt
        log(f"[phase 2] topk {label}: {launches} launch(es) a call, "
            f"{splits} span(s) a row; the first kernel "
            f"{st['first_kernel_ms']:.4f} ms, the streaming one "
            f"{st['ms']:.4f} ms ({st['first_kernel_ms'] / st['ms']:.2f}x, "
            f"{st['ms'] / st['bound_ms']:.1f}x its bound); by spans a row "
            f"(ms): {({k_: round(v, 5) for k_, v in alt.items()})}; bitwise "
            f"equal")
    return max_err, stats, topk_edge_cases(dev, rng)


def check_gathers_v1(dev, rng):
    """The warp-per-rows fused_gather and fused_dequant_gather (one kernel
    body) against their first kernels (``fused_gather_v1``,
    ``fused_dequant_gather_v1``) and their plain versions bit for bit at
    edge shapes: d from 1 to past one pass of a warp's loads, vector units
    (d % 4 == 0: float4 rows, char4 code rows) and a source off its
    alignment (a table 4 bytes off 16, a code base one byte off 4: scalar
    units), V = 1, V ragged against the rows per warp and V large enough
    for groups of several rows, unowned slots; two runs bitwise equal.
    Returns the shapes checked."""
    import torch
    from repro_torch.kernels.sharded_gather import (
        fused_dequant_gather, fused_dequant_gather_plain,
        fused_dequant_gather_v1, fused_gather, fused_gather_plain,
        fused_gather_v1,
    )
    from repro_torch.sharding import quantize_rows
    cases = [(1000, d, v, aligned) for d in (1, 4, 32, 33, 75, 300, 1000)
             for v in (1, 5, 777, 5000, 40001) for aligned in (True, False)]
    for r, d, v, aligned in cases:
        x = torch.from_numpy(rng.normal(0, .1, r * d + 1).astype(np.float32)
                             ).to(dev)
        table = (x[:-1] if aligned else x[1:]).view(r, d)
        codes0, scales = quantize_rows(table)
        buf = torch.empty(r * d + 1, dtype=torch.int8, device=dev)
        codes = (buf[:-1] if aligned else buf[1:]).view(r, d)
        codes.copy_(codes0)
        flat = torch.from_numpy(rng.integers(0, r, v).astype(np.int64)
                                ).to(dev)
        owned = torch.from_numpy(rng.random(v) < .75).to(dev)
        for name, kernel, first, plain, src in (
                ("fused_gather", fused_gather, fused_gather_v1,
                 fused_gather_plain, (table,)),
                ("fused_dequant_gather", fused_dequant_gather,
                 fused_dequant_gather_v1, fused_dequant_gather_plain,
                 (codes, scales))):
            got = kernel(*src, flat, owned)
            if not (same_bits(got, kernel(*src, flat, owned))
                    and same_bits(got, first(*src, flat, owned))
                    and same_bits(got, plain(*src, flat, owned))):
                raise AssertionError(f"{name} R={r} d={d} V={v} aligned="
                                     f"{aligned}: != first kernel or "
                                     f"plain, or two runs differ")
    log(f"[phase 2] fused_gather and fused_dequant_gather: the warp-per-rows "
        f"kernels == the first kernels == plain bit for bit, two runs "
        f"equal, at (R, d, V, aligned source) {cases}")
    return cases


def check_fused_gather(dev, rng, widths, mbs):
    """Duplicate ids and unowned slots at the serving batch (8) and the
    dedup bucket (64), and the mini-batch path's table gather (``mbs``);
    the output must be bitwise the plain version's and the first kernel's
    (``fused_gather_v1``, timed beside it), and a flat id outside the
    table must raise as in the plain version. Returns (max |kernel -
    plain|, per-width times)."""
    import torch
    from repro_torch.kernels.sharded_gather import (
        fused_gather, fused_gather_plain, fused_gather_v1,
    )

    def same_all(label, table, flat_t, owned_t, check=True):
        got = fused_gather(table, flat_t, owned_t, check=check)
        want = fused_gather_plain(table, flat_t, owned_t)
        first = fused_gather_v1(table, flat_t, owned_t, check=check)
        torch.cuda.synchronize()
        if not same_bits(got, want):
            raise AssertionError(f"fused_gather {label}: kernel != plain")
        if not same_bits(got, first):
            raise AssertionError(f"fused_gather {label}: kernel != first "
                                 f"kernel")
        return max_abs_diff(got, want)

    def first_kernel_time(label, st, fn):
        st["first_kernel_ms"], _ = timed(fn)
        log(f"[phase 2] fused_gather {label}: the first kernel "
            f"{st['first_kernel_ms']:.5f} ms, the warp-per-rows one "
            f"{st['ms']:.5f} ms ({st['first_kernel_ms'] / st['ms']:.2f}x); "
            f"bitwise equal")

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
            max_err = max(max_err, same_all(f"{label} V={v}", table, flat_t,
                                            owned_t))
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
        st = stats[label] = dict(V=SLOTS, d=d, **timings(
            lambda: fused_gather(table, flat_t, owned_t),
            lambda: fused_gather_plain(table, flat_t, owned_t),
            lambda: torch.index_select(table, 0, flat_t),
            *bound_ms(4 * n_own * d + 9 * SLOTS + 4 * SLOTS * d, 0)))
        report("fused_gather", f"{label} (V={SLOTS}, d={d})", st,
               "index_select")
        first_kernel_time(label, st,
                          lambda: fused_gather_v1(table, flat_t, owned_t))
    # the mini-batch path: one trainer's 4-shard table gather, unchecked
    from repro_torch.kernels.ops import flat_gather_plan
    lay = mbs["layout"]
    table = torch.from_numpy(rng.normal(0, .1, (lay.padded_rows, 75)).astype(
        np.float32)).to(dev)
    flat, owned = flat_gather_plan(torch.from_numpy(mbs["local"]),
                                   torch.from_numpy(mbs["owned"]),
                                   lay.rows_per_shard)
    flat_t, owned_t = flat.to(dev), owned.to(dev)
    max_err = max(max_err, same_all("minibatch_S4", table, flat_t, owned_t,
                                    check=False))
    v, n_own = flat.shape[0], int(owned.sum())
    st = stats["minibatch_S4"] = dict(V=v, d=75, **timings(
        lambda: fused_gather(table, flat_t, owned_t, check=False),
        lambda: fused_gather_plain(table, flat_t, owned_t),
        lambda: torch.index_select(table, 0, flat_t),
        *bound_ms(4 * n_own * 75 + 9 * v + 4 * v * 75, 0)))
    report("fused_gather", f"minibatch_S4 (V={v}, R={lay.padded_rows}, "
           f"d=75)", st, "index_select")
    first_kernel_time("minibatch_S4", st, lambda: fused_gather_v1(
        table, flat_t, owned_t, check=False))
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
    plain version and the first kernel (``fused_dequant_gather_v1``, timed
    beside it), unowned slots exactly 0, two runs bitwise equal, a flat
    id outside the table raises; a table of subnormal and zero scales comes
    through bitwise and nonzero. ``quantize_rows`` on the card is bitwise
    the CPU's for the FB15k-237 table and the subnormal table. Returns
    (max |kernel - plain|, per-width times, table bytes per width)."""
    import torch
    from repro_torch.kernels.ops import flat_gather_plan
    from repro_torch.kernels.sharded_gather import (
        fused_dequant_gather, fused_dequant_gather_plain,
        fused_dequant_gather_v1,
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
        first = fused_dequant_gather_v1(codes, scales, flat_t, owned_t,
                                        check=check)
        torch.cuda.synchronize()
        if not (same(got, want) and same(got, got2)):
            raise AssertionError(f"fused_dequant_gather {label}: kernel != "
                                 f"plain, or two runs differ")
        if not same(got, first):
            raise AssertionError(f"fused_dequant_gather {label}: kernel != "
                                 f"first kernel")
        if not bool((got[~owned_t].view(torch.int32) == 0).all()):
            raise AssertionError(f"fused_dequant_gather {label}: an unowned "
                                 f"slot is not exactly 0")
        return got, want

    def bound(v, n_own, d):
        # owned slots' codes and scales, every slot's id and ownership,
        # the output; one multiply per output element
        return bound_ms(n_own * d + 4 * n_own + 9 * v + 4 * v * d, v * d)

    def first_kernel_time(label, st, fn):
        st["first_kernel_ms"], _ = timed(fn)
        log(f"[phase 2] fused_dequant_gather {label}: the first kernel "
            f"{st['first_kernel_ms']:.5f} ms, the warp-per-rows one "
            f"{st['ms']:.5f} ms ({st['first_kernel_ms'] / st['ms']:.2f}x); "
            f"bitwise equal")

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
        first_kernel_time(label, stats[label],
                          lambda: fused_dequant_gather_v1(codes, scales,
                                                          flat_t, owned_t))
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
    first_kernel_time("minibatch_S4", stats["minibatch_S4"],
                      lambda: fused_dequant_gather_v1(
                          codes, scales, flat_t, owned_t, check=False))
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


def check_basis_message(dev, rng, part, mbs, c2=None):
    """The training shapes (one partition's gathers at d=75, B=2, and one
    mini-batch's) and the edge cases, or with ``c2`` (phase 6e's
    :func:`citation2_arrays`) the ogbl-citation2 mini-batch's two layers
    (128 -> 32 and 32 -> 32, B=2) only; returns (max |err|, per-shape
    times, each case's plan).

    The kernel must be bitwise the first kernel (``basis_message_v1``,
    timed beside it at the training shapes): both compute every output by
    the same fmaf chain. Both sides of the plain comparison compute
    sum_b c_b sum_i h_i W_bio in fp32 in different orders (the kernel:
    fixed fmaf chains; the plain einsums: cuBLAS's blocking), so each is
    within gamma_{d_in+B} * S of the exact value with S = sum_b |c_b|
    sum_i |h_i W_bio|; the bound is twice that. Masked edges must be
    exactly 0 on both."""
    import torch
    from repro_torch.kernels.rgcn_message import (
        basis_message, basis_message_config, basis_message_plain,
        basis_message_v1,
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
    if c2 is not None:
        cases = [(f"citation2_{d_in}to32", c2["V"], c2["E"], d_in, 32, 2,
                  c2["dst"], c2["rel"], c2["mask"]) for d_in in (128, 32)]
    timed_labels = ("train", "minibatch", "citation2_128to32",
                    "citation2_32to32")
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
        first = basis_message_v1(h_t, coef, w, m)
        torch.cuda.synchronize()
        if not same_bits(got, first):
            raise AssertionError(f"basis_message {label}: kernel != first "
                                 f"kernel")
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
        plan = basis_message_config(d_in, d_out, nb, ne)
        configs[label] = dict(E=ne, d_in=d_in, d_out=d_out, B=nb, **plan)
        log(f"[phase 2] basis_message {label} (E={ne}, d_in={d_in}, "
            f"d_out={d_out}, B={nb}; {plan['edges_per_tile']}-edge tiles, "
            f"{plan['threads']} threads, {plan['column_slices']} column "
            f"slice(s) of {4 * plan['column_groups_per_slice']}, "
            f"{plan['blocks_per_slice']} blocks per slice, "
            f"{plan['blocks_per_sm']} per SM, {plan['smem_bytes']} bytes of "
            f"shared memory): bitwise the first kernel, max err "
            f"{float(err.max()):.3g}")
        if label in timed_labels:
            n_on = int(m.sum())
            nbytes = 4 * (ne * d_in + ne * nb + nb * d_in * d_out
                          + ne * d_out) + ne
            ops = 2 * n_on * nb * d_out * (d_in + 1)
            st = stats[label] = dict(E=ne, d=d_in, d_out=d_out, B=nb,
                                     **timings(
                lambda: basis_message(h_t, coef, w, m),
                lambda: basis_message_plain(h_t, coef, w, m),
                lambda: torch.einsum("ebo,eb->eo", torch.einsum(
                    "ed,bdo->ebo", h_t, w), coef),
                *bound_ms(nbytes, ops)))
            st["first_kernel_ms"], _ = timed(
                lambda: basis_message_v1(h_t, coef, w, m))
            report("basis_message", f"{label} (E={ne}, d={d_in} -> {d_out}, "
                   f"B={nb})", st, "einsum pair")
            log(f"[phase 2] basis_message {label}: the first kernel "
                f"{st['first_kernel_ms']:.4f} ms, the tiled one "
                f"{st['ms']:.4f} ms ({st['first_kernel_ms'] / st['ms']:.2f}x"
                f", {st['ms'] / st['bound_ms']:.2f}x its bound); bitwise "
                f"equal")
    return max_err, stats, configs


def check_segment_sum(dev, rng, part, mbs, c2=None):
    """The training shapes (one partition's heads and mask, and one
    mini-batch's, d=75; with ``c2`` only the ogbl-citation2 mini-batch's,
    d=32) and the edge cases (d = 1, 4, 128, 150, a hub and
    empty segments, segments of exactly WARP_COMBINE_MAX = 64 and 65
    chunks, the edge of the scatter passes' one-warp combine). agg must be
    bitwise the first kernel's (``segment_sum_v1``, timed beside it, with
    each pass's device time at the mini-batch shape: both add in the same
    order) and deg == it and the plain version's; agg within 2 gamma_n
    sum|msg| of the plain version (n = the segment's length: both add the
    same terms in other orders), and two runs bitwise equal. Returns (max
    |err|, times, the cases checked)."""
    import torch
    from repro_torch.kernels.rgcn_message import (
        CHUNK, SegmentPlan, segment_key, segment_plan, segment_plan_host,
        segment_sum, segment_sum_plain, segment_sum_planned, segment_sum_v1,
    )
    v, e = part["V"], part["E"]
    cases = [("train", e, v, 75, part["src"], part["mask"]),
             ("minibatch", mbs["E"], mbs["V"], 75, mbs["src"], mbs["mask"]),
             ("ragged unsorted", 1000, 300, 75, None, None),
             ("sorted", 4000, 500, 32, "sorted", None),
             ("hub + empty", 70000, 2000, 75, "hub", None),
             ("d=1", 9000, 300, 1, None, None),
             ("d=4", 9000, 300, 4, None, None),
             ("d=128", 9000, 300, 128, None, None),
             ("d=150", 9000, 300, 150, None, None),
             ("64 and 65 chunks", 64 * CHUNK + 65 * CHUNK + 500, 40, 75,
              "64/65", None)]
    if c2 is not None:
        cases = [("citation2", c2["E"], c2["V"], 32, c2["src"], c2["mask"])]
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
            if kind == "64/65":   # unmasked: 64 x 32 and 65 x 32 edges
                seg = rng.permutation(np.concatenate([
                    np.full(64 * CHUNK, 3), np.full(65 * CHUNK, 11),
                    rng.integers(12, nv, 500)]))
                mask = np.ones(ne, bool)
        msg = torch.from_numpy(rng.normal(0, 1, (ne, d)).astype(np.float32)
                               ).to(dev)
        msg[::7] = -0.0        # rows of -0.0: the sum order shows in signs
        seg_t = torch.from_numpy(np.asarray(seg, np.int32)).to(dev)
        m = torch.from_numpy(np.asarray(mask, bool)).to(dev)
        agg, deg = segment_sum(msg, seg_t, m, nv)
        agg2, deg2 = segment_sum(msg, seg_t, m, nv)
        fagg, fdeg = segment_sum_v1(msg, seg_t, m, nv)
        pagg, pdeg = segment_sum_plain(msg, seg_t, m, nv)
        torch.cuda.synchronize()
        if not (same_bits(agg, fagg) and torch.equal(deg, fdeg)):
            raise AssertionError(f"segment_sum {label}: kernel != first "
                                 f"kernel")
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
            f"segment {int(deg.max())}): bitwise the first kernel, deg ==, "
            f"max err {float(err.max()):.3g}, two runs bitwise equal")
        if label in ("train", "minibatch", "citation2"):
            # the main paths hand the call the plan built on the host with
            # the batch: planned == unplanned, bit for bit
            t0 = time.perf_counter()
            packed = segment_plan_host(np.asarray(seg, np.int64),
                                       np.asarray(mask, bool), nv)
            host_ms = (time.perf_counter() - t0) * 1e3
            plan = SegmentPlan.unpack(torch.from_numpy(packed).to(dev), nv)
            pagg, pdeg = segment_sum(msg, seg_t, m, nv, plan=plan)
            if not (same_bits(pagg, agg) and torch.equal(pdeg, deg)):
                raise AssertionError(f"segment_sum {label}: planned != "
                                     f"unplanned")
            n_on = int(m.sum())
            nbytes = 4 * n_on * d + 5 * ne + 4 * nv * d + 4 * nv
            st = dict(E=ne, V=nv, d=d, longest_segment=int(deg.max()),
                      **timings(
                          lambda: segment_sum(msg, seg_t, m, nv, plan=plan),
                          lambda: segment_sum_plain(msg, seg_t, m, nv),
                          lambda: torch.zeros((nv + 1, d), device=dev)
                          .index_add_(0, key, msg),
                          *bound_ms(nbytes, n_on * d)))
            st["kernel_ms"], _ = timed(
                lambda: segment_sum_planned(msg, *plan, nv))
            st["first_kernel_ms"], _ = timed(
                lambda: segment_sum_v1(msg, seg_t, m, nv, plan=plan))
            st["unplanned_ms"], _ = timed(
                lambda: segment_sum(msg, seg_t, m, nv))
            st["plan_ms"], _ = timed(lambda: segment_plan(seg_t, m, nv))
            st["host_plan_ms"] = host_ms
            stats[label] = st
            report("segment_sum", f"{label} (E={ne}, V={nv}, d={d})", st,
                   "index_add_")
            log(f"[phase 2] segment_sum {label}: planned == unplanned "
                f"bitwise; kernels alone {st['kernel_ms']:.4f} ms, the first "
                f"kernel {st['first_kernel_ms']:.4f} ms "
                f"({st['first_kernel_ms'] / st['kernel_ms']:.2f}x, "
                f"{st['kernel_ms'] / st['bound_ms']:.2f}x the bound), with "
                f"the plan built on the card {st['unplanned_ms']:.4f} ms (the "
                f"plan {st['plan_ms']:.4f} ms); the host plan {host_ms:.2f} "
                f"ms of host time")
            if label == "minibatch":
                # each pass's device time, the new passes and the first's
                reps = 10
                for key_, fn in (
                        ("passes_ms", lambda: segment_sum_planned(
                            msg, *plan, nv)),
                        ("first_kernel_passes_ms", lambda: segment_sum_v1(
                            msg, seg_t, m, nv, plan=plan))):
                    fn()
                    w = profiled(fn, reps)
                    st[key_] = {n: us / reps / 1e3
                                for n, us in w["by_name"].items()}
                log(f"[phase 2] segment_sum minibatch by pass, ms: "
                    f"{st['passes_ms']}; the first kernel's "
                    f"{st['first_kernel_passes_ms']}")
    return max_err, stats, [c[0] for c in cases]


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
                trip_head=mb.triplets[0][:, 0], trip_rel=mb.triplets[0][:, 1],
                trip_tail=mb.triplets[0][:, 2], N=kg.num_entities,
                R=kg.num_relations, layout=pre.table_layout,
                V=pre.budget.max_vertices, E=pre.budget.max_edges,
                T=pre.budget.max_triplets,
                comp_vertices=int(mb.vertex_mask[0].sum()))


def check_scatter_add(dev, rng, mbs, c2=None):
    """scatter_add_onehot at the mini-batch path's shapes (the table
    gradient, the vertex-state gradient h_dst, the relation coefficients,
    and the decoder's three: the relation diagonals and the head and tail
    gathers from V) and the edge cases; with ``c2`` only the
    ogbl-citation2 mini-batch's vertex-state gradient (d=32). The kernel must be bitwise the
    first kernel (``scatter_add_onehot_v1``, timed beside it, with each
    pass's device time at h_dst): both add in the same order. Both sides
    of the plain comparison add each row's owned hits in fp32, in other
    orders (the kernel: chunks of 32 in slot order, then the chunk sums;
    the plain index_add_: atomics), so each is within gamma_n sum|g| of
    the exact sum (n = the row's hits) and the bound is twice that. Rows
    no owned slot hits must be exactly 0, two runs bitwise equal, and the
    4-shard table gradient bitwise the dense one. Returns (max |err|,
    per-shape times)."""
    import torch
    from repro_torch.kernels.ops import flat_gather_plan
    from repro_torch.kernels.rgcn_message import (
        SegmentPlan, segment_key, segment_plan, segment_plan_host,
    )
    from repro_torch.kernels.sharded_gather import (
        scatter_add_onehot, scatter_add_onehot_plain, scatter_add_onehot_v1,
        scatter_add_planned,
    )
    lay = mbs["layout"]
    flat_s, own_s = flat_gather_plan(torch.from_numpy(mbs["local"]),
                                     torch.from_numpy(mbs["owned"]),
                                     lay.rows_per_shard)
    ragged_owned = rng.random(5000) < .7
    timed_cases = ("table_grad", "h_dst", "coeffs_rel", "rel_diag",
                   "trip_head", "trip_tail")
    cases = [
        ("table_grad", flat_s.numpy(), own_s.numpy(), lay.padded_rows, 75),
        ("h_dst", mbs["dst"], None, mbs["V"], 75),
        ("coeffs_rel", mbs["rel"], None, mbs["R"], 2),
        ("rel_diag", mbs["trip_rel"], None, mbs["R"], 75),
        ("trip_head", mbs["trip_head"], None, mbs["V"], 75),
        ("trip_tail", mbs["trip_tail"], None, mbs["V"], 75),
        ("all unowned", rng.integers(0, 1000, 1000), np.zeros(1000, bool),
         1000, 75),
        ("one row", np.full(40000, 5), None, 300, 75),
        ("one row of 100,000", np.full(100000, 3), None, 10, 75),
        ("ragged R", rng.integers(0, 1001, 5000), ragged_owned, 1001, 33),
        ("V%32 != 0", rng.integers(0, 500, 4001), rng.random(4001) < .8,
         500, 75),
        ("d=1", rng.integers(0, 300, 9000), None, 300, 1),
        ("d=4", rng.integers(0, 300, 9000), None, 300, 4),
        ("d=128", rng.integers(0, 300, 9000), None, 300, 128),
        ("V=0", np.zeros(0, np.int64), np.zeros(0, bool), 1000, 75),
    ]
    if c2 is not None:
        cases = [("citation2_h_dst", c2["dst"], None, c2["V"], 32)]
        timed_cases = ("citation2_h_dst",)
    max_err, stats = 0.0, {}
    for label, flat, owned, r, d in cases:
        v = flat.shape[0]
        g = torch.from_numpy(rng.normal(0, 1, (v, d)).astype(np.float32)
                             ).to(dev)
        g[::7] = -0.0          # rows of -0.0: the sum order shows in signs
        flat_t = torch.from_numpy(np.asarray(flat, np.int64)).to(dev)
        own_t = None if owned is None else torch.from_numpy(
            np.asarray(owned, bool)).to(dev)
        got = scatter_add_onehot(g, flat_t, own_t, r)
        got2 = scatter_add_onehot(g, flat_t, own_t, r)
        first = scatter_add_onehot_v1(g, flat_t, own_t, r)
        want = scatter_add_onehot_plain(g, flat_t, own_t, r)
        torch.cuda.synchronize()
        if not same_bits(got, first):
            raise AssertionError(f"scatter_add_onehot {label}: kernel != "
                                 f"first kernel")
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
            f"longest row {longest}): bitwise the first kernel, max err "
            f"{e_max:.3g}, non-hit rows 0, two runs bitwise equal")
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
        if label in timed_cases:
            # the main paths hand the call the plan built on the host with
            # the batch: planned == unplanned, bit for bit
            t0 = time.perf_counter()
            packed = segment_plan_host(np.asarray(flat, np.int64), owned, r)
            host_ms = (time.perf_counter() - t0) * 1e3
            plan = SegmentPlan.unpack(torch.from_numpy(packed).to(dev), r)
            if not same_bits(scatter_add_onehot(g, flat_t, own_t, r,
                                                plan=plan), got):
                raise AssertionError(f"scatter_add_onehot {label}: planned "
                                     f"!= unplanned")
            n_own = int(hits.sum())
            nbytes = 4 * n_own * d + 8 * v + (v if owned is not None else 0) \
                + 4 * r * d
            st = dict(V=v, R=r, d=d, longest_row=longest, **timings(
                lambda: scatter_add_onehot(g, flat_t, own_t, r, plan=plan),
                lambda: scatter_add_onehot_plain(g, flat_t, own_t, r),
                lambda: torch.zeros((r + 1, d), device=dev)
                .index_add_(0, key, g),
                *bound_ms(nbytes, n_own * d)))
            st["kernel_ms"], _ = timed(
                lambda: scatter_add_planned(g, *plan, r))
            st["first_kernel_ms"], _ = timed(
                lambda: scatter_add_onehot_v1(g, flat_t, own_t, r,
                                              plan=plan))
            st["unplanned_ms"], _ = timed(
                lambda: scatter_add_onehot(g, flat_t, own_t, r))
            st["plan_ms"], _ = timed(lambda: segment_plan(flat_t, own_t, r))
            st["host_plan_ms"] = host_ms
            stats[label] = st
            report("scatter_add_onehot", f"{label} (V={v}, R={r}, d={d})",
                   st, "index_add_")
            log(f"[phase 2] scatter_add_onehot {label}: planned == unplanned "
                f"bitwise; kernels alone {st['kernel_ms']:.4f} ms, the first "
                f"kernel {st['first_kernel_ms']:.4f} ms "
                f"({st['first_kernel_ms'] / st['kernel_ms']:.2f}x, "
                f"{st['kernel_ms'] / st['bound_ms']:.2f}x the bound), with "
                f"the plan built on the card {st['unplanned_ms']:.4f} ms (the "
                f"plan {st['plan_ms']:.4f} ms); the host plan {host_ms:.2f} "
                f"ms of host time")
            if label == "h_dst":
                # each pass's device time, the new passes and the first's
                reps = 10
                for key_, fn in (
                        ("passes_ms", lambda: scatter_add_planned(
                            g, *plan, r)),
                        ("first_kernel_passes_ms",
                         lambda: scatter_add_onehot_v1(
                             g, flat_t, own_t, r, plan=plan))):
                    fn()
                    w = profiled(fn, reps)
                    st[key_] = {n: us / reps / 1e3
                                for n, us in w["by_name"].items()}
                log(f"[phase 2] scatter_add_onehot h_dst by pass, ms: "
                    f"{st['passes_ms']}; the first kernel's "
                    f"{st['first_kernel_passes_ms']}")
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
    finite; bitwise the first kernel (``wkv_chunked_v1``, timed beside it
    at the prefill shape): both compute every output by the same fp32
    chain; two runs bitwise equal; within the reference's gate of the
    sequential oracle ``ref.wkv_chunk_ref``; and within
    WKV_ULPS_PER_STEP * chunk ulps of each row's largest output of the
    plain chunked form (the same factorization: each output is a sum of
    at most chunk + 2 hd + 1 terms in another order, and the state's
    rounding decays with it). hd = 128, chunk = 64, which the first
    kernel's whole state does not let into a block's shared memory (it
    raises ValueError), the chunk-parallel kernels take: it is held against
    the plain chunked form and the oracle alone. A block above the card's
    shared memory (hd = 256, chunk = 64) raises ValueError. Returns (max
    |kernel - plain chunked|, per-case errors with the times at the
    prefill shape, each pass's device time among them)."""
    import torch
    from repro_torch.kernels.ref import wkv_chunk_ref
    from repro_torch.kernels.wkv_chunk import (
        wkv_chunked, wkv_chunked_plain, wkv_chunked_states, wkv_chunked_v1,
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = [("prefill", LM_B * 40, LM_S, 64, 64),
             ("S ragged", 7, 1000, 64, 64), ("BH=1", 1, 300, 64, 64),
             ("S<chunk", 4, 10, 64, 64), ("chunk=16", 12, 200, 64, 16),
             ("hd=8", 5, 77, 8, 16), ("hd=16", 9, 130, 16, 32),
             ("hd=32", 3, 96, 32, 64), ("hd=128", 6, 300, 128, 64)]
    max_err, stats = 0.0, {}
    for label, bh, s, hd, chunk in cases:
        x = wkv_inputs(dev, rng, bh, s, hd)
        got = wkv_chunked(*x, chunk=chunk)
        got2 = wkv_chunked(*x, chunk=chunk)
        kept, states = wkv_chunked_states(*x, chunk=chunk)
        plain = wkv_chunked_plain(*x, chunk=chunk)
        seq = wkv_chunk_ref(*x)
        torch.cuda.synchronize()
        if label == "hd=128":
            try:
                wkv_chunked_v1(*x, chunk=chunk)
            except ValueError as e:
                log(f"[phase 2] wkv_chunked_v1 hd=128, chunk=64 refused: "
                    f"{e}")
            else:
                raise AssertionError("wkv_chunked_v1: hd=128, chunk=64 did "
                                     "not raise")
            versus = "the first kernel refuses it"
        else:
            if not same_bits(got, wkv_chunked_v1(*x, chunk=chunk)):
                raise AssertionError(f"wkv_chunked {label}: kernel != first "
                                     f"kernel")
            versus = "bitwise the first kernel"
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"wkv_chunked {label}: non-finite output")
        if not torch.equal(got.view(torch.int32), got2.view(torch.int32)):
            raise AssertionError(f"wkv_chunked {label}: two runs differ")
        if not same_bits(got, kept):
            raise AssertionError(f"wkv_chunked {label}: the output differs "
                                 f"when the states are kept")
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
            f"chunk={chunk}): {versus}; max |kernel - plain chunked| "
            f"{float(err.max()):.3g} (largest share of its bound "
            f"{float((err / tol).max()):.3f}), max |kernel - sequential| "
            f"{seq_err:.3g}; finite, two runs bitwise equal, bitwise "
            f"whether or not the states are kept")
        if label == "prefill":
            nbytes = 4 * (5 * bh * s * hd + bh * hd)
            b_ms, b_by = bound_ms(nbytes, wkv_ops(bh, s, hd, chunk))
            ms, call_ms = timed(lambda: wkv_chunked(*x, chunk=chunk))
            v1_ms, _ = timed(lambda: wkv_chunked_v1(*x, chunk=chunk))
            plain_ms, plain_call_ms = timed(
                lambda: wkv_chunked_plain(*x, chunk=chunk))
            # the oracle's 2,048 steps are some 14,000 device operations a
            # call, too many for the profiler's windows: CUDA events only
            seq_call_ms = time_ms(lambda: wkv_chunk_ref(*x), reps=3,
                                  warmup=1)
            reps = 5
            passes = profiled(lambda: wkv_chunked(*x, chunk=chunk), reps)
            stats[label]["passes_ms"] = {
                n: us / reps / 1e3 for n, us in passes["by_name"].items()}
            stats[label].update(
                ms=ms, call_ms=call_ms, first_kernel_ms=v1_ms,
                plain_ms=plain_ms, plain_call_ms=plain_call_ms,
                sequential_call_ms=seq_call_ms, library_ms=None,
                bound_ms=b_ms, bound_by=b_by)
            log(f"[phase 2] wkv_chunked {label}: {ms:.4f} ms ({call_ms:.4f} "
                f"ms per call), the first kernel {v1_ms:.4f} ms "
                f"({v1_ms / ms:.2f}x, {ms / b_ms:.2f}x its bound), plain "
                f"chunked {plain_ms:.4f} ms, sequential {seq_call_ms:.1f} "
                f"ms per call, no single library call; bound {b_ms:.6f} ms "
                f"({b_by}); by pass, ms: {stats[label]['passes_ms']}")
        del x, got, got2, kept, states, plain, seq
    x = wkv_inputs(dev, rng, 2, 64, 256)
    try:
        wkv_chunked(*x, chunk=64)
    except ValueError as e:
        log(f"[phase 2] wkv_chunked hd=256, chunk=64 refused: {e}")
    else:
        raise AssertionError("wkv_chunked: a block above the card's shared "
                             "memory did not raise")
    return max_err, stats


def wkv_bwd_ops(bh, s, hd):
    """FLOP the WKV gradient needs from its inputs alone, in the chunked
    form at the chunk length K that needs the fewest. Per chunk of K steps
    and row: the chunk's state k^T v, G's r~^T g, and the cross terms
    g S_in^T (dr), v G'^T (dk) and k~ G' (dv), 2 K hd^2 each; the decay of
    the state and of G once a chunk, hd^2 each; inside the chunk the five
    strict-lower products A = r~ k~^T, A^T g, dA = g v^T, dA k~ and
    dA^T r~, K (K - 1) hd each. A step so costs 10 hd^2 + 2 hd^2 / K +
    5 (K - 1) hd, least near K = sqrt(2 hd / 5) (K = 1 is the sequential
    recurrence's 12 hd^2). dlw needs no contraction of its own: with L_t
    the cumulative log-decay, the loss sees L_t only through r_{t+1}
    e^{L_t} and k_t e^{-L_t}, so dlw_m is the reverse cumulative sum over
    t >= m of r_{t+1} dr'_{t+1} - k_t dk'_t (dr', dk' without their bonus
    terms), O(hd) a step."""
    per_step = min(10 * hd * hd + 2 * hd * hd / kk + 5 * (kk - 1) * hd
                   for kk in range(1, max(hd, 1) + 1))
    return bh * s * per_step


def wkv_bwd_gamma(lw, chunk, hd):
    """Per row of ``lw`` (BH, S, hd), gamma_n = n u / (1 - n u) of the
    chunk-parallel backward's longest chain of fp32 roundings, n = 4 (K +
    1) L + 3 K + 3 P + 3 nch + WKV_BWD_CHUNKED_EXTRA (see there)."""
    import torch
    s = lw.shape[1]
    lam = lw.double().abs().sum(dim=1).amax(dim=1)          # (BH,)
    n = (4 * (chunk + 1) * lam + 3 * chunk + 3 * (-(-hd // 4) * 4)
         + 3 * (-(-s // chunk)) + WKV_BWD_CHUNKED_EXTRA)
    return n, n * U32 / (1 - n * U32)


def check_wkv_backward(dev, rng):
    """wkv_chunked_backward (the chunk-parallel kernel) at the rwkv6-3b
    training shape (BH = 2 batch rows x 40 heads, S = 2,048, hd = chunk =
    64) and at ragged shapes, chunk 16, hd 8, 16, 30, 32, a strong decay
    (lw about -0.5 a step) and S = 4,096, the reference's training length
    (launch/specs.py:34). Each output elementwise within gamma_n
    (wkv_bwd_gamma, derived beside WKV_BWD_CHUNKED_EXTRA) times its sum
    of |terms| (``wkv_chunked_backward_chunked_plain(..., magnitudes=
    True)`` in fp64) of the fp64 chunked plain gradient of the same fp32
    inputs, and within the reference's gradient gate (rtol 5e-3, atol
    1e-4; its largest share printed, the first kernel's beside it) of the
    fp64 sequential gradient (autograd through the oracle); every output
    finite; two runs bitwise equal, and bitwise the call given the
    forward's states
    (``wkv_chunked_states``, as the autograd op passes them). The first
    kernel (``wkv_chunked_backward_v1``) within its own bound of the fp64
    sequential gradient (WKV_BWD_EXTRA), and timed beside the new one at
    the training shape, which must be faster. hd = 128 refused. Returns
    (max |kernel - chunked plain|, per-case errors with the times at the
    training shape)."""
    import torch
    from repro_torch.kernels.wkv_chunk import (
        wkv_chunked_backward, wkv_chunked_backward_chunked_plain,
        wkv_chunked_backward_plain, wkv_chunked_backward_v1,
        wkv_chunked_states,
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = [("train", LM_TRAIN_B * 40, LM_TRAIN_S, 64, 64, None),
             ("S ragged", 7, 1000, 64, 64, None),
             ("BH=1, S<chunk", 1, 13, 64, 64, None),
             ("chunk=16", 12, 200, 64, 16, None),
             ("hd=8", 5, 77, 8, 16, None), ("hd=16", 9, 130, 16, 32, None),
             ("hd=30", 4, 50, 30, 16, None), ("hd=32", 3, 96, 32, 64, None),
             ("strong decay", 8, 512, 64, 64, 0.5),
             ("S 4,096", 8, 4096, 64, 64, None)]
    names = ("dr", "dk", "dv", "dlog_decay", "du")
    max_err, stats = 0.0, {}
    for label, bh, s, hd, chunk, strong in cases:
        x = list(wkv_inputs(dev, rng, bh, s, hd))
        if strong is not None:
            x[3] = torch.from_numpy(np.asarray(
                -strong * np.exp(rng.normal(size=(bh, s, hd)) * 0.1),
                np.float32)).to(dev)
        g = torch.from_numpy(rng.normal(size=(bh, s, hd)).astype(
            np.float32)).to(dev)
        got = wkv_chunked_backward(*x, g, chunk=chunk)
        got2 = wkv_chunked_backward(*x, g, chunk=chunk)
        _, states = wkv_chunked_states(*x, chunk=chunk)
        got_s = wkv_chunked_backward(*x, g, chunk=chunk, states=states)
        first = wkv_chunked_backward_v1(*x, g)
        x64, g64 = [t.double() for t in x], g.double()
        want = wkv_chunked_backward_chunked_plain(*x64, g64, chunk=chunk)
        mag = wkv_chunked_backward_chunked_plain(*x64, g64, chunk=chunk,
                                                 magnitudes=True)
        seq = wkv_chunked_backward_plain(*x64, g64)
        r, k, v, lw, u = x64
        mag_seq = wkv_chunked_backward_plain(r.abs(), k.abs(), v.abs(), lw,
                                             u.abs(), g64.abs())
        torch.cuda.synchronize()
        n, gamma = wkv_bwd_gamma(x[3], chunk, hd)
        n1 = 4 * s + 2 * (-(-hd // 4) * 4) + WKV_BWD_EXTRA
        gamma1 = n1 * U32 / (1 - n1 * U32)
        case = dict(BH=bh, S=s, hd=hd, chunk=chunk,
                    n_max=float(n.max()), gamma_max=float(gamma.max()),
                    first_kernel_gamma=gamma1)
        for name, a, a2, a_s, f, b, m, q, mq in zip(
                names, got, got2, got_s, first, want, mag, seq, mag_seq):
            for what, t in (("kernel", a), ("first kernel", f)):
                if not bool(torch.isfinite(t).all()):
                    raise AssertionError(f"wkv_chunked_backward {label}: "
                                         f"{what}'s {name} not finite")
            if not same_bits(a, a2):
                raise AssertionError(f"wkv_chunked_backward {label}: two "
                                     f"runs differ in {name}")
            if not same_bits(a, a_s):
                raise AssertionError(f"wkv_chunked_backward {label}: {name} "
                                     f"given the forward's states differs")
            gm = gamma.view(-1, *([1] * (a.dim() - 1)))
            for what, t, ref, bound in (
                    ("kernel", a, b, gm * m),
                    ("first kernel", f, q, gamma1 * mq)):
                err = (t.double() - ref).abs()
                tol = bound + 1e-30
                if bool((err > tol).any()):
                    i = int(torch.argmax(err / tol))
                    raise AssertionError(
                        f"wkv_chunked_backward {label}: {what}'s {name} "
                        f"element {i} |{what} - plain fp64| "
                        f"{float(err.flatten()[i])} > "
                        f"{float(tol.flatten()[i])}")
                if what == "kernel":
                    case[name] = dict(max_abs_err=float(err.max()),
                                      bound_share=float((err / tol).max()))
                    max_err = max(max_err, float(err.max()))
                else:
                    case[name]["first_kernel_bound_share"] = float(
                        (err / tol).max())
            share, share1 = (float(((t.double() - q).abs()
                                    / (1e-4 + 5e-3 * q.abs())).max())
                             for t in (a, f))
            case[name]["reference_gate_share"] = share
            case[name]["first_kernel_reference_gate_share"] = share1
            if share > 1.0:
                raise AssertionError(
                    f"wkv_chunked_backward {label}: {name} outside the "
                    f"reference's gate (rtol 5e-3, atol 1e-4) of the fp64 "
                    f"sequential gradient, share {share}")
        stats[label] = case
        log(f"[phase 2] wkv_chunked_backward {label} (BH={bh}, S={s}, "
            f"hd={hd}, chunk={chunk}): within gamma_n (n up to "
            f"{case['n_max']:.0f}, gamma {case['gamma_max']:.3g}) of each "
            f"output's sum |terms| of the fp64 chunked plain gradient, "
            f"largest share of the bound "
            + ", ".join(f"{nm} {case[nm]['bound_share']:.2e}"
                        for nm in names)
            + "; of the reference's gate against the fp64 sequential "
            "gradient " + ", ".join(
                f"{nm} {case[nm]['reference_gate_share']:.2e}"
                for nm in names)
            + f"; finite, two runs bitwise equal, bitwise the call given "
            f"the forward's states; the first kernel within gamma_{n1} of "
            f"the sequential sums, largest share "
            + ", ".join(f"{nm} {case[nm]['first_kernel_bound_share']:.2e}"
                        for nm in names)
            + ", of the reference's gate " + ", ".join(
                f"{nm} {case[nm]['first_kernel_reference_gate_share']:.2e}"
                for nm in names))
        if label == "train":
            nbytes = 4 * (9 * bh * s * hd + 2 * bh * hd)
            b_ms, b_by = bound_ms(nbytes, wkv_bwd_ops(bh, s, hd))
            ms, call_ms = timed(lambda: wkv_chunked_backward(
                *x, g, chunk=chunk, states=states))
            v1_ms, v1_call_ms = timed(lambda: wkv_chunked_backward_v1(*x, g))
            alone_ms, alone_call_ms = timed(lambda: wkv_chunked_backward(
                *x, g, chunk=chunk))
            reps = 5
            passes = profiled(lambda: wkv_chunked_backward(
                *x, g, chunk=chunk, states=states), reps)
            # autograd through 2,048 steps: too many device operations for
            # the profiler's windows, CUDA events only
            plain_ms = time_ms(lambda: wkv_chunked_backward_plain(*x, g),
                               reps=2, warmup=1)
            chunked_plain_ms = time_ms(
                lambda: wkv_chunked_backward_chunked_plain(*x, g,
                                                           chunk=chunk),
                reps=3, warmup=1)
            case.update(ms=ms, call_ms=call_ms, first_kernel_ms=v1_ms,
                        first_kernel_call_ms=v1_call_ms,
                        first_kernel_bitwise=False, without_states_ms=alone_ms,
                        without_states_call_ms=alone_call_ms,
                        passes_ms={nm: us / reps / 1e3 for nm, us
                                   in passes["by_name"].items()},
                        plain_ms=plain_ms, chunked_plain_ms=chunked_plain_ms,
                        library_ms=None, bound_ms=b_ms, bound_by=b_by)
            log(f"[phase 2] wkv_chunked_backward {label}: {ms:.4f} ms given "
                f"the forward's states ({call_ms:.4f} ms per call, "
                f"{ms / b_ms:.2f}x its bound), {alone_ms:.4f} ms forming "
                f"them itself; the first kernel {v1_ms:.4f} ms "
                f"({v1_ms / ms:.2f}x); by pass, ms: {case['passes_ms']}; "
                f"plain (autograd through the sequential oracle, fp32) "
                f"{plain_ms:.1f} ms per call, chunked plain (fp32) "
                f"{chunked_plain_ms:.2f} ms per call, no single library "
                f"call; bound {b_ms:.6f} ms ({b_by})")
            if not ms < v1_ms:
                raise AssertionError(f"wkv_chunked_backward: {ms} ms, not "
                                     f"faster than the first kernel's "
                                     f"{v1_ms} ms")
        del x, g, got, got2, got_s, first, want, mag, seq, mag_seq, states
    x = wkv_inputs(dev, rng, 2, 16, 128)
    try:
        wkv_chunked_backward(*x, x[0])
    except ValueError as e:
        log(f"[phase 2] wkv_chunked_backward hd=128 refused: {e}")
    else:
        raise AssertionError("wkv_chunked_backward: hd=128 did not raise")
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
                           .manual_seed(0), device=dev, dtype=torch.float32)
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
        cache = T.init_decode_cache(cfg, LM_B, device=dev,
                                    dtype=torch.float32)
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
        # (e) bf16, the reference's default dtype: the same weights rounded
        bf16, params16 = run_lm_bf16(params, cfg, prefill_k, prefill_p,
                                     batch, lk, tok_b, want, step_batch,
                                     windows)
        res.update(bf16)
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
    for label, forwards in (("prefill", 1), ("prefill_b", 1),
                            ("prefill_bf16", 1), ("decode", 0), ("serve", 0)):
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
    state = dict(params=params, params16=params16, batch=batch,
                 prefill=prefill_k, serve_step=serve_step, cache=cache,
                 step_batch=step_batch)
    return res, state


def run_lm_bf16(params, cfg, prefill_k, prefill_p, batch, lk, tok_b, want,
                step_batch, windows):
    """Phase 8e: the fp32 weights rounded to bf16 (what
    ``init_params(dtype=torch.bfloat16)`` draws from the same generator),
    the WKV core fp32 inside, as in the reference. The gate is the one of
    tests/test_torch_lm.py::test_bf16_forward_logits_allclose_jax_bf16:
    the port's bf16 logits against a reference bf16 evaluation within that
    reference's own bf16 error at these inputs, its largest |bf16 - fp32|
    logit. Prefill: the kernel against the plain chunked form in bf16,
    within e = max|plain bf16 - fp32 kernel|, and so within 2 e of the fp32
    run's last logits. Decode: the prompt through decode_step in bf16
    against the bf16 kernel prefill of the same prompt, within e_b =
    max|bf16 prefill - fp32 prefill| of that prompt, and so within 2 e_b
    of the fp32 prefill. Times: the bf16 prefill (CUDA events, 3 calls
    after 1 warm-up) and its model-FLOP rate against 989 TFLOP/s, a steady
    bf16 decode step against reading 6.15 GB of weights. Returns (results,
    the bf16 weights for phase 7)."""
    import torch
    from repro_torch.launch.specs import InputShape, model_flops
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.nn import transformer as T
    dev = lk.device
    p16 = T.map_tree(params, lambda t: t.to(torch.bfloat16))
    res = dict(bf16_param_bytes=sum(t.numel() * t.element_size()
                                    for _, t in T.leaves(p16)))
    reset_counts()
    lk16 = prefill_k(p16, batch)
    torch.cuda.synchronize()
    windows["prefill_bf16"] = launch_counts()
    lp16 = prefill_p(p16, batch)
    torch.cuda.synchronize()
    for name, x in (("kernel", lk16), ("plain", lp16)):
        if x.dtype != torch.bfloat16 or tuple(x.shape) != tuple(lk.shape) \
                or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"bf16 {name} prefill logits: {x.dtype} "
                                 f"{tuple(x.shape)} or not finite")
    e_ref = max_abs_diff(lp16.float(), lk)
    res.update(bf16_prefill_ref_err=e_ref,
               bf16_prefill_vs_plain=max_abs_diff(lk16.float(), lp16.float()),
               bf16_prefill_vs_fp32=max_abs_diff(lk16.float(), lk),
               bf16_prefill_argmax_agree=int(
                   (lk16.argmax(-1) == lk.argmax(-1)).sum()))
    if not (res["bf16_prefill_vs_plain"] <= e_ref and
            res["bf16_prefill_vs_fp32"] <= 2 * e_ref):
        raise AssertionError(f"bf16 prefill: |kernel - plain| "
                             f"{res['bf16_prefill_vs_plain']}, |kernel - "
                             f"fp32| {res['bf16_prefill_vs_fp32']}, the "
                             f"reference's bf16 error {e_ref}")
    res["bf16_prefill_ms"] = time_ms(lambda: prefill_k(p16, batch), reps=3,
                                     warmup=1)
    flop = model_flops(cfg, InputShape("prefill", LM_S, LM_B, "prefill"))
    res["bf16_prefill_tflops"] = flop / res["bf16_prefill_ms"] / 1e9
    log(f"[phase 8e] bf16 prefill B={LM_B}, S={LM_S}: kernel vs plain "
        f"chunked bf16 {res['bf16_prefill_vs_plain']:.4g} <= the reference's "
        f"bf16 error {e_ref:.4g}; vs the fp32 run "
        f"{res['bf16_prefill_vs_fp32']:.4g} <= {2 * e_ref:.4g}; argmax "
        f"agrees with fp32 in {res['bf16_prefill_argmax_agree']} of {LM_B}; "
        f"{res['bf16_prefill_ms']:.1f} ms = {res['bf16_prefill_tflops']:.2f} "
        f"TFLOP/s of model FLOPs, {res['bf16_prefill_tflops'] / 989:.3f} of "
        f"the 989 TFLOP/s bf16 dense peak")
    del lp16
    want16 = prefill_k(p16, {"tokens": tok_b})
    e_b = max_abs_diff(want16.float(), want)
    cache = T.init_decode_cache(cfg, LM_B, device=dev, dtype=torch.bfloat16)
    for t in range(tok_b.shape[1]):
        logits, cache = T.decode_step(p16, cfg, tok_b[:, t:t + 1], cache)
    torch.cuda.synchronize()
    got = logits[:, 0]
    res.update(bf16_decode_ref_err=e_b,
               bf16_decode_vs_prefill=max_abs_diff(got.float(),
                                                   want16.float()),
               bf16_decode_vs_fp32=max_abs_diff(got.float(), want),
               bf16_decode_argmax_agree=int(
                   (got.argmax(-1) == want.argmax(-1)).sum()))
    if not (got.dtype == torch.bfloat16 and
            res["bf16_decode_vs_prefill"] <= e_b and
            res["bf16_decode_vs_fp32"] <= 2 * e_b):
        raise AssertionError(f"bf16 decode: {got.dtype}, |decode - bf16 "
                             f"prefill| {res['bf16_decode_vs_prefill']}, "
                             f"|decode - fp32| {res['bf16_decode_vs_fp32']}, "
                             f"the prefill's bf16 error {e_b}")
    serve_step = make_serve_step(cfg)
    res["bf16_decode_step_ms"] = time_ms(
        lambda: serve_step(p16, cache, step_batch), reps=10, warmup=2)
    res["bf16_decode_floor_ms"] = (res["bf16_param_bytes"] / HBM_BYTES_PER_S
                                   * 1e3)
    log(f"[phase 8e] bf16: {tok_b.shape[1]} tokens through decode_step vs "
        f"the bf16 kernel prefill {res['bf16_decode_vs_prefill']:.4g} <= its "
        f"bf16 error {e_b:.4g}; vs the fp32 prefill "
        f"{res['bf16_decode_vs_fp32']:.4g} <= {2 * e_b:.4g}; argmax agrees "
        f"with fp32 in {res['bf16_decode_argmax_agree']} of {LM_B}; a steady "
        f"bf16 decode step {res['bf16_decode_step_ms']:.3f} ms against the "
        f"{res['bf16_decode_floor_ms']:.3f} ms of reading "
        f"{res['bf16_param_bytes'] / 1e9:.2f} GB of weights")
    return res, p16


def profile_lm(state):
    """Phase 7 for the LM path: one kernel prefill (fp32 and bf16) and one
    steady decode step — host time, the card's busy time, the idle share,
    the top device operations and the WKV kernel's share of the
    prefill."""
    import torch
    out = {}
    with torch.inference_mode():
        for label, key in (("lm_prefill", "params"),
                           ("lm_prefill_bf16", "params16")):
            w = profiled(lambda: state["prefill"](state[key], state["batch"]),
                         1, host=False)
            # the WKV kernels' passes: wkv_local_kernel, wkv_scan_kernel,
            # wkv_cross_kernel (template kernels' names start "void ")
            wkv_us = sum(t for n, t in w["by_name"].items() if "wkv_" in n)
            top = sorted(w["by_name"].items(), key=lambda kv: -kv[1])[:8]
            out[label] = dict(
                step_ms=w["wall_us"] / 1e3,
                device_ms_per_step=w["busy_us"] / 1e3,
                idle_share=1.0 - w["busy_us"] / w["wall_us"],
                device_events=w["count"], wkv_ms=wkv_us / 1e3,
                wkv_share=wkv_us / w["busy_us"],
                top_device_ms_per_step={n: t / 1e3 for n, t in top})
        out["lm_decode_step"] = step_profile(
            lambda: state["serve_step"](state["params"], state["cache"],
                                        state["step_batch"]))
    return out


def first_update_check(optimizer, grads, start, params):
    """Each leaf of ``grads``: ``params`` after the first train step
    against ``start`` + ``optimizer.update`` (the dict-wide form) of
    ``grads`` from ``start``, the difference relative to the update's L2
    norm within
    LM_TRAIN_UPDATE_REL_L2. Returns the largest relative L2, its leaf and
    the share of elements whose bits agree."""
    import torch
    want, _ = optimizer.update(grads, optimizer.init(start), start)
    worst, worst_name, same, total = 0.0, "", 0, 0
    for name, u in want.items():
        expect = start[name] + u
        same += int((params[name].view(torch.int32)
                     == expect.view(torch.int32)).sum())
        total += u.numel()
        rel = float((params[name] - expect).norm()
                    / u.norm().clamp_min(1e-30))
        if rel >= worst:
            worst, worst_name = rel, name
    out = dict(leaves=len(want), elements=total, worst_rel_l2=worst,
               worst_leaf=worst_name, bitwise_share=same / max(total, 1))
    if worst > LM_TRAIN_UPDATE_REL_L2:
        raise AssertionError(f"phase 8f: the first step moved {worst_name} "
                             f"{worst} in relative L2 from adam.update "
                             f"of the same gradients")
    log(f"[phase 8f] the first step's change of {len(want)} leaves "
        f"({total} elements) against adam.update + apply_updates of (a)'s "
        f"gradients: largest relative L2 {worst:.3g} ({worst_name}, gate "
        f"{LM_TRAIN_UPDATE_REL_L2}), bits equal in {out['bitwise_share']:.6f}"
        f" of the elements")
    return out


def run_lm_train(dev, card):
    """Phase 8f: rwkv6-3b training at full width (32 layers, d 2,560,
    3,073,313,280 fp32 parameters drawn on the card from seed 0, remat on),
    TF32 off. (a) one step's loss and gradients, the WKV kernels
    ("chunked_kernel") against the plain chunked form, within
    LM_TRAIN_LOSS_RTOL and LM_TRAIN_GRAD_REL_L2. (b) LM_TRAIN_STEPS
    make_train_step Adam steps on TokenStream batches (B = 2, S = 2,048,
    seed 0): finite losses, each step's time on CUDA events and its
    model-FLOP rate; the first step's change of the small leaves against
    adam.update of (a)'s gradients (first_update_check). (c) each step launches wkv_chunked 64 times (32
    layers, each recomputed in the backward) and wkv_chunked_backward 32
    times, and no other kernel. (d) the peak device memory of the steps,
    under the card's 80 GB, printed beside PERF.md's prediction. Then one
    more step under the profiler: device busy, idle share, the WKV
    kernels' time and the top device operations."""
    import dataclasses
    import gc
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenStream
    from repro_torch.launch.specs import InputShape, model_flops
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.nn import transformer as T
    from repro_torch.training.optimizer import adam
    torch.backends.cuda.matmul.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_arch(LM_ARCH)
    if not cfg.remat:
        raise AssertionError(f"{LM_ARCH}: remat is off")
    kcfg = dataclasses.replace(cfg, rwkv_mode="chunked_kernel")
    pcfg = dataclasses.replace(cfg, rwkv_mode="chunked")
    res = dict(allocated_before_bytes=torch.cuda.memory_allocated())
    params = T.init_params(cfg, generator=torch.Generator(device=dev)
                           .manual_seed(0), device=dev, dtype=torch.float32)
    res["params"] = T.count_params(params)
    if res["params"] != 3_073_313_280:
        raise AssertionError(f"{LM_ARCH}: {res['params']} parameters")
    stream = TokenStream(cfg.vocab_size, LM_TRAIN_B, LM_TRAIN_S, seed=0)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in next(stream)
                .items()} for _ in range(LM_TRAIN_STEPS)]
    # (a) kernel against plain, one step's loss and gradients
    lk, _, gk = loss_and_grads(params, kcfg, batches[0])
    lp, _, gp = loss_and_grads(params, pcfg, batches[0])
    torch.cuda.synchronize()
    res["grad_loss_kernel"], res["grad_loss_plain"] = float(lk), float(lp)
    if not (np.isfinite(res["grad_loss_kernel"]) and abs(
            res["grad_loss_kernel"] - res["grad_loss_plain"])
            <= LM_TRAIN_LOSS_RTOL * abs(res["grad_loss_plain"])):
        raise AssertionError(f"phase 8f: loss kernel {float(lk)!r} vs "
                             f"plain {float(lp)!r}")
    held = {n: g.clone() for n, g in gk.items()
            if g.numel() <= LM_TRAIN_HELD_NUMEL}
    worst, worst_name, gate_share = 0.0, "", 0.0
    for name in list(gk):       # leaf by leaf, each freed after
        a, b = gk.pop(name), gp.pop(name)
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"phase 8f: gradient {name} not finite")
        d = a - b
        rel = float(d.norm() / b.norm().clamp_min(1e-30))
        gate_share = max(gate_share, float(
            (d.abs_() / (1e-4 + 5e-3 * b.abs())).max()))
        if rel >= worst:
            worst, worst_name = rel, name
        del a, b, d
        if rel > LM_TRAIN_GRAD_REL_L2:
            raise AssertionError(f"phase 8f: gradient {name} kernel vs "
                                 f"plain relative L2 {rel} > "
                                 f"{LM_TRAIN_GRAD_REL_L2}")
    del gk, gp
    res.update(grad_worst_leaf=worst_name, grad_worst_rel_l2=worst,
               grad_reference_gate_share=gate_share)
    log(f"[phase 8f] one step at B={LM_TRAIN_B}, S={LM_TRAIN_S}: loss kernel "
        f"{res['grad_loss_kernel']!r} vs plain chunked "
        f"{res['grad_loss_plain']!r} (rel {LM_TRAIN_LOSS_RTOL}); every "
        f"gradient leaf within relative L2 {LM_TRAIN_GRAD_REL_L2} (largest "
        f"{worst:.3g}, {worst_name}); largest elementwise share of the "
        f"reference's per-layer gate (rtol 5e-3, atol 1e-4) {gate_share:.3g}")
    # (b)-(d) the main path: make_train_step, counts around each step
    gc.collect()
    torch.cuda.empty_cache()
    optimizer = adam(LM_TRAIN_LR)
    opt_state = optimizer.init(dict(T.leaves(params)))
    step = make_train_step(kcfg, optimizer)
    start_of = {n: t.clone() for n, t in T.leaves(params) if n in held}
    flop = model_flops(cfg, InputShape("train", LM_TRAIN_S, LM_TRAIN_B,
                                       "train"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i, batch in enumerate(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        reset_counts()
        start.record()
        params, opt_state, m = step(params, opt_state, batch)
        end.record()
        end.synchronize()
        counts = launch_counts()
        ms = start.elapsed_time(end)
        steps.append(dict(loss=float(m["loss"]), nll=float(m["nll"]),
                          moe_aux=float(m["moe_aux"]), ms=ms,
                          tflops=flop / ms / 1e9, launches=counts))
        others = {k: v for k, v in counts.items()
                  if k not in ("wkv_chunked", "wkv_chunked_backward") and v}
        if (counts["wkv_chunked"] != 2 * cfg.num_layers
                or counts["wkv_chunked_backward"] != cfg.num_layers
                or others):
            raise AssertionError(f"phase 8f step {i}: launches {counts}, "
                                 f"expected wkv_chunked "
                                 f"{2 * cfg.num_layers} and "
                                 f"wkv_chunked_backward {cfg.num_layers}")
        if not np.isfinite(steps[-1]["loss"]):
            raise AssertionError(f"phase 8f step {i}: loss "
                                 f"{steps[-1]['loss']}")
        if i == 0:
            res["first_update"] = first_update_check(
                optimizer, held, start_of, dict(T.leaves(params)))
            del held, start_of
        log(f"[phase 8f] step {i}: loss {steps[-1]['loss']:.6f}, "
            f"{ms:.1f} ms = {steps[-1]['tflops']:.2f} TFLOP/s of model "
            f"FLOPs ({flop:.4g} a step), {steps[-1]['tflops'] / 67:.3f} of "
            f"the 67 TFLOP/s fp32 peak; launches wkv_chunked "
            f"{counts['wkv_chunked']}, wkv_chunked_backward "
            f"{counts['wkv_chunked_backward']}; {card}")
    peak = torch.cuda.max_memory_allocated()
    if int(opt_state.step) != LM_TRAIN_STEPS or peak >= CARD_BYTES:
        raise AssertionError(f"phase 8f: optimizer step "
                             f"{int(opt_state.step)}, peak {peak} bytes")
    lo, hi = LM_TRAIN_PEAK_PREDICTED_GB
    res.update(steps=steps, flop_per_step=flop, peak_bytes=peak,
               param_bytes=sum(t.numel() * t.element_size()
                               for _, t in T.leaves(params)))
    log(f"[phase 8f] {LM_TRAIN_STEPS} make_train_step steps: losses "
        f"{[round(x['loss'], 6) for x in steps]}, step ms "
        f"{[round(x['ms'], 1) for x in steps]}; peak device memory "
        f"{peak / 1e9:.2f} GB (predicted {lo}-{hi} GB; parameters "
        f"{res['param_bytes'] / 1e9:.2f} GB, with gradients and two "
        f"moments {4 * res['param_bytes'] / 1e9:.2f} GB) of the card's "
        f"{CARD_BYTES / 1e9:.0f} GB; {card}")
    # where a step's time goes: one more step, on the next batch, under the
    # profiler (not one of the counted steps)
    extra = {k: torch.from_numpy(v).to(dev) for k, v in next(stream).items()}
    w = profiled(lambda: step(params, opt_state, extra), 1, host=False)
    top = sorted(w["by_name"].items(), key=lambda kv: -kv[1])[:8]
    res["profile"] = dict(
        step_ms=w["wall_us"] / 1e3, device_ms_per_step=w["busy_us"] / 1e3,
        idle_share=1.0 - w["busy_us"] / w["wall_us"],
        device_events=w["count"],
        wkv_ms={n: t / 1e3 for n, t in w["by_name"].items() if "wkv_" in n},
        # the backward's four passes: wkv_bwd_gx_kernel, wkv_bwd_scan_kernel,
        # wkv_bwd_local_kernel, wkv_bwd_du_kernel
        wkv_backward_ms=sum(t for n, t in w["by_name"].items()
                            if "wkv_bwd_" in n) / 1e3,
        top_device_ms_per_step={n: t / 1e3 for n, t in top})
    log(f"[phase 8f] a profiled step: {res['profile']['step_ms']:.1f} ms, "
        f"device busy {res['profile']['device_ms_per_step']:.1f} ms, idle "
        f"share {res['profile']['idle_share']:.4f}, {w['count']} device "
        f"events; WKV kernels, ms: {res['profile']['wkv_ms']}, the "
        f"backward's {res['profile']['wkv_backward_ms']:.2f} ms a step; top "
        f"{res['profile']['top_device_ms_per_step']}")
    del params, opt_state, step, batches, extra
    gc.collect()
    torch.cuda.empty_cache()
    return res


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
    state = trainer.opt_state
    # the step updates the parameters and the Adam moments in place
    tensors = [p for _, p in trainer.params.named_parameters()] + [
        t for part in (state.mu, state.nu) for t in part.values()]
    saved = [t.detach().clone() for t in tensors]
    runs = []
    for _ in range(2):
        with torch.no_grad():
            for t, s in zip(tensors, saved):
                t.copy_(s)
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


def step_plans(batch, num_relations, layout):
    """Every trainer's packed scatter plans of a stacked mini-batch, built
    where the batch lies from its own ids (``segment_plan``): the
    comp-graph edges' and the sharded table gradient's (flat ``S·rows``
    rows). A step builds these at first use; the placements below also
    ship them with the batch."""
    import torch
    from repro_torch.kernels.ops import flat_gather_plan
    from repro_torch.kernels.rgcn_message import segment_plan
    per = []
    v = batch["gather_global"].shape[1]
    for i in range(batch["comp_src"].shape[0]):
        flat, own = flat_gather_plan(batch["shard_local_ids"][i],
                                     batch["shard_owned"][i],
                                     layout.rows_per_shard)
        per.append({
            "plan_src": segment_plan(batch["comp_src"][i],
                                     batch["comp_mask"][i], v),
            "plan_dst": segment_plan(batch["comp_dst"][i], None, v),
            "plan_rel": segment_plan(batch["comp_rel"][i], None,
                                     num_relations),
            "plan_table": segment_plan(flat, own, layout.padded_rows)})
    return {k: torch.stack([p[k].pack() for p in per]) for k in per[0]}


def plan_cost(trainer, batch):
    """The scatter plans one mini-batch step builds on the card at first
    use (every trainer's edge arrays and table gradient): their count,
    bytes and device time per step."""
    lay, r = trainer.pipeline.table_layout, trainer.train_kg.num_relations
    plans = step_plans(batch, r, lay)
    return dict(plans=sum(p.shape[0] for p in plans.values()),
                bytes=sum(p.numel() * 8 for p in plans.values()),
                device_ms=device_ms(lambda: step_plans(batch, r, lay),
                                    reps=4))


def plan_placements(trainer, rounds=4):
    """The async mini-batch epoch with the step's scatter plans built in
    three places, alternated on one trainer (parameters carry on from
    epoch to epoch): ``step``, the port's own (the pipeline ships none and
    the step builds each on the card at first use); ``copy``, on the card
    with the batch's copy, on the copy stream; ``host``, numpy
    (``segment_plan_host``) in the collator, copied with the batch.
    ``rounds`` epochs each of the first two, two of the third. First the
    host plans of one batch are held bitwise against the card's. Returns
    each placement's epochs: t_epoch, t_device_step, host build and wall
    s."""
    import types
    import torch
    from repro_torch.data import pipeline as P
    from repro_torch.kernels.ops import flat_gather_plan
    from repro_torch.kernels.rgcn_message import segment_plan_host
    pipe = trainer.pipeline
    lay, r = pipe.table_layout, trainer.train_kg.num_relations
    if lay is None or pipe.dedup_gather:
        raise AssertionError("plan_placements takes a sharded table's "
                             "gather without dedup")

    def host_plans(h):
        per = []
        for i in range(h["comp_src"].shape[0]):
            p = P.edge_plans_host(h["comp_src"][i], h["comp_rel"][i],
                                  h["comp_dst"][i], h["comp_mask"][i],
                                  h["gather_global"].shape[1], r)
            flat, own = flat_gather_plan(
                torch.from_numpy(h["shard_local_ids"][i]),
                torch.from_numpy(h["shard_owned"][i]), lay.rows_per_shard)
            p["plan_table"] = segment_plan_host(flat.numpy(), own.numpy(),
                                                lay.padded_rows)
            per.append(p)
        return {k: np.stack([p[k] for p in per]) for k in per[0]}

    def host_batch_planned(self, mb):
        h = P.host_batch(mb, lay, False)
        h.update(host_plans(h))
        return h

    base = P.BatchTransfer

    class PlanningTransfer(base):
        def put(self, arrays):
            tensors, event = super().put(arrays)
            if self.stream is None:      # the CPU
                tensors.update(step_plans(tensors, r, lay))
                return tensors, event
            with torch.cuda.device(self.device), \
                    torch.cuda.stream(self.stream):
                tensors.update(step_plans(tensors, r, lay))
                event.record(self.stream)
            return tensors, event

    def use(name):
        pipe.__dict__.pop("_host_batch", None)
        P.BatchTransfer = PlanningTransfer if name == "copy" else base
        if name == "host":
            pipe._host_batch = types.MethodType(host_batch_planned, pipe)

    it = pipe.epoch_batches(1)
    mb0 = next(iter(it))
    it.close()
    dev = P.to_device_batch(mb0, pipe.device, lay)
    want = step_plans(dev, r, lay)
    got = host_plans(P.host_batch(mb0, lay, False))
    bad = [k for k, v in got.items()
           if not np.array_equal(v, want[k].cpu().numpy())]
    if sorted(got) != sorted(want) or bad:
        raise AssertionError(f"host plans != card plans: {bad}")
    order = (["step", "host", "copy", "copy", "host", "step"]
             + ["step", "copy", "copy", "step"] * (rounds // 2 - 1))
    out = {k: [] for k in ("step", "copy", "host")}
    try:
        for name in order:
            use(name)
            t0 = time.perf_counter()
            rec = trainer.train_epoch()
            out[name].append(dict(t_epoch=rec["t_epoch"],
                                  t_device_step=rec["t_device_step"],
                                  t_host_build=rec["t_host_build"],
                                  wall_s=time.perf_counter() - t0))
    finally:
        use("step")
    return out


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


def resume_exact(table_opts):
    """Phase 6d for one table dtype (``table_opts``: none, or ``INT8``):
    run A trains epochs 1-2 of phase 6b's main configuration without a
    break; run B trains epoch 1 and saves a checkpoint; a new trainer on
    the card restores B's checkpoint and trains epoch 2, once at 4 table
    shards and once at 1 (the 4-shard table restored into 1). Each resumed
    epoch's per-step losses and final parameters must be bitwise A's.
    Launch counts are read around each resumed run (restore and epoch,
    no evaluation).
    Returns the checkpoint's bytes, the save time and each resumed run's
    restore time, epoch time and launches."""
    import shutil
    import torch
    from repro_torch.launch import train

    def make(opts):
        return train.make_trainer(train.parse_args(MB_ARGV + opts +
                                                   table_opts))
    a = make(MB_MAIN)
    hist = [a.train_epoch() for _ in range(2)]
    a.close()
    b = make(MB_MAIN)
    b.train_epoch()
    b.close()
    directory = os.path.join(CHECKPOINT_DIR, "int8" if table_opts
                             else "fp32")
    shutil.rmtree(directory, ignore_errors=True)
    t0 = time.perf_counter()
    path = b.save_checkpoint(directory)
    out = dict(save_s=time.perf_counter() - t0, checkpoint_bytes=(
        os.path.getsize(path)
        + os.path.getsize(path.replace(".npz", ".json"))),
        losses=hist[1]["losses"], runs={})
    del b
    for label, opts in (("S4", MB_MAIN), ("S1", MB_GATES["S1"])):
        c = make(opts)
        reset_counts()
        t0 = time.perf_counter()
        epoch = c.restore(path)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        rec = c.train_epoch()
        launches = launch_counts()
        c.close()
        bad = bitwise_mismatch(a, c)
        if epoch != 1 or rec["epoch"] != 2 or \
                rec["losses"] != hist[1]["losses"] or bad or \
                int(c.opt_state.step) != int(a.opt_state.step):
            raise AssertionError(
                f"resume {table_opts} into {label}: epoch {epoch}, losses "
                f"{rec['losses']} vs {hist[1]['losses']}, parameters {bad}")
        out["runs"][label] = dict(restore_s=restore_s,
                                  t_epoch=rec["t_epoch"], launches=launches)
        del c
    shutil.rmtree(directory, ignore_errors=True)
    return out


@contextlib.contextmanager
def shared_preprocessing():
    """Within the block, trainers built for the same graph and
    preprocessing arguments share one ``preprocess_graph`` result (it is
    deterministic, and a trainer only reads it): phase 6e's three runs
    preprocess the citation2 graph once."""
    from repro_torch.training import trainer as trainer_mod
    real, memo = trainer_mod.preprocess_graph, {}

    def cached(kg, **kw):
        key = (kg.num_entities, kg.num_edges, tuple(sorted(kw.items())))
        if key not in memo:
            memo[key] = real(kg, **kw)
        return memo[key]

    trainer_mod.preprocess_graph = cached
    try:
        yield
    finally:
        trainer_mod.preprocess_graph = real


def citation2_arrays(trainer):
    """Trainer 0's slice of the first mini-batch of the citation2 run
    (host arrays): the shapes phase 2 holds the kernels at for 6e."""
    it = trainer.pipeline.epoch_batches(1)
    mb = next(iter(it))
    it.close()
    budget = trainer.budget
    return dict(src=mb.comp_src[0], dst=mb.comp_dst[0], rel=mb.comp_rel[0],
                mask=mb.comp_mask[0], V=budget.max_vertices,
                E=budget.max_edges, comp_edges=int(mb.comp_mask[0].sum()))


def candidate_lists(test, num_entities, rng):
    """ogbl-style lists: ``C2_NEGATIVES`` uniform tail ids per test edge,
    the true tail replaced by its successor (the lists exclude it)."""
    cands = rng.integers(0, num_entities,
                         (test.shape[0], C2_NEGATIVES)).astype(np.int32)
    tails = test[:, 2:3]
    return np.where(cands == tails, (tails + 1) % num_entities,
                    cands).astype(np.int32)


def run_citation2(dev, part, mbs, phase2):
    """Phase 6e: ogbl-citation2 training at RGCN_CITATION2's widths
    through ``repro_torch.launch.train`` (the kernel path, async, is the
    main run; the plain encoder and the serial pipeline beside it), the
    test evaluation, the candidate-list protocol at 1 and 4 shards, and
    phase 2's checks at the batch's shapes (merged into ``phase2``).
    Returns the phase's results."""
    import torch
    from repro_torch.eval.ranking import CSRFilterIndex, ranking_metrics

    t_phase = time.perf_counter()
    with shared_preprocessing():
        runs = {"main": train_once(C2_ARGV + C2_MAIN)}
        for label, extra in C2_GATES.items():
            runs[label] = train_once(C2_ARGV + extra)
    main = runs["main"]["trainer"]
    splits = main.splits
    batches = [-(-p.core_edges_local().shape[0] // C2_BATCH)
               for p in main.partitions]
    full = [p.core_edges_local().shape[0] // C2_BATCH
            for p in main.partitions]
    feat = main.features
    log(f"[phase 6e] ogbl-citation2 stand-in at scale "
        f"{C2_ARGV[C2_ARGV.index('--scale') + 1]}: "
        f"{splits['train'].num_entities} entities, "
        f"{splits['train'].num_edges} train / {splits['test'].num_edges} "
        f"test edges, features {tuple(feat.shape)} "
        f"({feat.numel() * 4 / 1e6:.1f} MB); batches per trainer {batches} "
        f"({full} full); budgets V={main.budget.max_vertices} "
        f"E={main.budget.max_edges} T={main.budget.max_triplets}")
    if min(full) < 2:
        raise AssertionError(f"citation2: a trainer's epoch holds fewer "
                             f"than two full {C2_BATCH}-edge batches")
    launches = runs["main"]["launches"]
    missing = [k for k in C2_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the citation2 "
                             f"path: {missing}")
    for label, r in runs.items():
        h = r["history"][0]
        log(f"[phase 6e] {label} run: {h['num_batches']} steps, losses "
            f"{h['losses']}, t_epoch {h['t_epoch']:.3f} s, device step "
            f"{h['t_device_step']:.3f} s, host exposed "
            f"{h['t_get_compute_graph']:.3f} s of {h['t_host_build']:.3f} s "
            f"(overlap {h['overlap_fraction']:.3f}), {r['wall_s']:.1f} s in "
            f"all; {r['metrics']}")
    log(f"[phase 6e] launches during the main run (1 epoch + the test "
        f"evaluation): {launches}; the plain run launched "
        f"{runs['plain']['launches']}")
    losses = runs["main"]["history"][0]["losses"]
    if not (len(losses) >= 2 and np.isfinite(losses).all()):
        raise AssertionError(f"citation2 losses: {losses}")
    np.testing.assert_allclose(runs["plain"]["history"][0]["losses"],
                               losses, **LOSS_TOL)
    serial = runs["serial"]
    bad = bitwise_mismatch(main, serial["trainer"])
    if serial["history"][0]["losses"] != losses or bad:
        raise AssertionError(f"citation2 serial != async: losses "
                             f"{serial['history'][0]['losses']} vs {losses},"
                             f" params {bad}")
    for k in ("test_mrr", "test_hits@1", "test_hits@3", "test_hits@10"):
        if not 0.0 <= runs["main"]["metrics"][k] <= 1.0:
            raise AssertionError(f"citation2 metric {k} out of range")
    log(f"[phase 6e] kernel == plain per-step losses within {LOSS_TOL}; "
        f"serial == async losses and parameters bitwise")
    # phase 2 at this batch's shapes, before the step profiles below (a
    # kernel timed after them once came back with events missing)
    c2 = citation2_arrays(main)
    log(f"[phase 2] citation2 mini-batch: budgets V={c2['V']}, E={c2['E']}; "
        f"the first batch's comp graph holds {c2['comp_edges']} edges")
    rng = np.random.default_rng(1)
    for name, check in (("basis_message", check_basis_message),
                        ("segment_sum", check_segment_sum)):
        err, stats, _ = check(dev, rng, part, mbs, c2=c2)
        phase2[name][1].update(stats)
        phase2[name] = (max(phase2[name][0], err), phase2[name][1])
    err, stats = check_scatter_add(dev, rng, mbs, c2=c2)
    phase2["scatter_add_onehot"][1].update(stats)
    phase2["scatter_add_onehot"] = (max(phase2["scatter_add_onehot"][0],
                                        err), phase2["scatter_add_onehot"][1])
    batch = first_batch(main, 2)
    two_run = two_runs_bitwise(main, batch,
                               lambda: main.step_generators(2, 0))
    plain = runs["plain"]["trainer"]
    plain_batch = first_batch(plain, 2)
    two_run_plain = two_runs_bitwise(plain, plain_batch,
                                     lambda: plain.step_generators(2, 0))
    log(f"[phase 6e] two runs of one step: kernel path loss {two_run!r}, "
        f"default path loss {two_run_plain!r}; every parameter bitwise "
        f"equal")
    # a steady step of each path (the first run of the phase also pays
    # for the process's first use of these shapes)
    prof = {}
    for label, tr, b in (("kernel", main, batch), ("plain", plain,
                                                   plain_batch)):
        gens = tr.step_generators(2, 0)
        p = prof[label] = step_profile(lambda: tr.step(b, gens))
        log(f"[phase 6e] steady step ({label} path): {p['step_ms']:.3f} ms, "
            f"device busy {p['device_ms_per_step']:.3f} ms, idle share "
            f"{p['idle_share']:.3f}, sort kernels "
            f"{p['sort_ms_per_step']:.4f} ms; top "
            f"{p['top_device_ms_per_step']}")
    del batch, plain_batch

    # the ogbl protocol over the trained embeddings, 1 and 4 shards
    emb = main.encode_all_entities()
    if emb.shape != (splits["train"].num_entities, main.cfg.hidden_dim) or \
            not bool(torch.isfinite(emb).all()):
        raise AssertionError(f"bad citation2 embeddings {tuple(emb.shape)}")
    test = splits["test"].triplets()
    cands = candidate_lists(test, emb.shape[0], np.random.default_rng(0))
    dparams = {k: v.detach() for k, v in main.params["decoder"].items()}
    fidx = CSRFilterIndex.build([])
    ogbl, ogbl_s = {}, {}
    for shards in (1, 4):
        reset_counts()
        t0 = time.perf_counter()
        ogbl[shards] = ranking_metrics(emb, dparams, test, fidx,
                                       candidates=cands, num_shards=shards,
                                       device=dev)
        torch.cuda.synchronize()
        ogbl_s[shards] = time.perf_counter() - t0
    if ogbl[4] != ogbl[1]:
        raise AssertionError(f"citation2 candidate protocol: 4 shards "
                             f"{ogbl[4]} != dense {ogbl[1]}")
    log(f"[phase 6e] candidate-list protocol ({test.shape[0]} test edges x "
        f"{C2_NEGATIVES} negatives, rng 0): 4-shard == dense {ogbl[1]}; "
        f"{ogbl_s[1]:.3f} s dense, {ogbl_s[4]:.3f} s at 4 shards")

    seconds = time.perf_counter() - t_phase
    log(f"[phase 6e] {seconds:.1f} s in all")
    return dict(runs={k: {"history": r["history"], "metrics": r["metrics"],
                          "launches": r["launches"], "wall_s": r["wall_s"]}
                      for k, r in runs.items()},
                launches=launches, two_run_loss=two_run,
                two_run_plain_loss=two_run_plain, profile=prof,
                ogbl=ogbl, ogbl_s=ogbl_s, batches=batches, seconds=seconds)


def spmd_resume(argv):
    """Phase 6f, checkpoints under spmd, for one table dtype: ``argv``
    (phase 6f's configuration) under --spmd trains epochs 1-2 without a
    break; a second --spmd trainer trains epoch 1 and saves a checkpoint;
    a fresh --spmd trainer restores it and trains epoch 2: per-step
    losses, parameters, Adam moments and the step counter bitwise the
    unbroken run's. The checkpoint's arrays and manifest == those of the
    --no-spmd trainer after epoch 1. Launch counts are read around the
    resumed run (restore and epoch). Returns the checkpoint's bytes, the
    save and restore seconds, the resumed epoch's time and launches."""
    import shutil
    import torch
    from repro_torch.launch import spmd_check, train

    def make(extra):
        return train.make_trainer(train.parse_args(argv + extra))

    directory = os.path.join(CHECKPOINT_DIR, "spmd")
    shutil.rmtree(directory, ignore_errors=True)
    with shared_preprocessing():
        a = make(["--spmd"])
        hist = [a.train_epoch() for _ in range(2)]
        a.close()
        b = make(["--spmd"])
        b.train_epoch()
        b.close()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = b.save_checkpoint(os.path.join(directory, "spmd"))
        save_s = time.perf_counter() - t0
        del b
        c = make(["--spmd"])
        reset_counts()
        t0 = time.perf_counter()
        epoch = c.restore(path)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        rec = c.train_epoch()
        launches = launch_counts()
        c.close()
        bad = spmd_check.tree_mismatches(a, c)
        if epoch != 1 or rec["epoch"] != 2 or \
                rec["losses"] != hist[1]["losses"] or bad:
            raise AssertionError(
                f"spmd resume: epoch {epoch}, losses {rec['losses']} vs "
                f"{hist[1]['losses']}, state {bad}")
        del a, c
        sim = make(["--no-spmd"])
        sim.train_epoch()
        sim.close()
        sim_path = sim.save_checkpoint(os.path.join(directory, "sim"))
        del sim
    bad = spmd_check.checkpoint_mismatches(path, sim_path)
    if bad:
        raise AssertionError(f"spmd checkpoint != --no-spmd's: {bad}")
    out = dict(checkpoint_bytes=(
        os.path.getsize(path) + os.path.getsize(path.replace(".npz",
                                                             ".json"))),
        save_s=save_s, restore_s=restore_s, t_epoch=rec["t_epoch"],
        launches=launches, losses=hist[1]["losses"])
    shutil.rmtree(directory, ignore_errors=True)
    return out


RANK_PIPELINE_STEPS = 8      # phase 6f: steps each per-rank pipeline is held
RANK_PIPELINE_DATA = 4       # phase 6f: a 4 x 1 mesh, one trainer a rank


def per_rank_pipelines(trainer, card):
    """Phase 6f, each rank builds only its own trainers' batches: phase
    6b's mini-batch pipeline (``trainer``'s partitions, budgets, 4-shard
    table layout), serial and async, built whole and as data rank ``i``
    of a 4 x 1 mesh (``BatchShardings(4, 1, i, 0)``, no process group),
    ``i`` in 0..3. Each rank's first 8 device batches bitwise ``select``
    of the whole pipeline's; each rank's step count (``num_steps``, and
    the serial rank's host epoch run to its end) == the whole's. Host
    build per steady step (``PipelineStats.host_build_s``: the partition
    batches this process built) and wall time per step (build, stack,
    plan and copy) of each, whole and per rank. Returns them."""
    import torch
    from repro_torch.data.pipeline import BatchShardings, make_input_pipeline
    pre, cfg = trainer.pre, trainer.cfg
    steps = RANK_PIPELINE_STEPS

    def pipe(kind, shardings=None):
        return make_input_pipeline(
            kind, pre.partitions, batch_size=cfg.batch_size,
            num_negatives=cfg.num_negatives, num_hops=cfg.num_hops,
            budget=pre.budget, seed=cfg.seed, sampler=cfg.negative_sampler,
            csrs=pre.csrs, prefetch=cfg.prefetch,
            table_layout=pre.table_layout, dedup_gather=cfg.gather_dedup,
            device=trainer.device, shardings=shardings)

    def window(p):
        t0 = time.perf_counter()
        it = p.device_batches(1)
        got = [b for _, b in zip(range(steps), it)]
        it.close()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = p.last_stats
        return got, {"build_ms": 1e3 * st.host_build_s / max(
            st.num_batches - 1, 1), "wall_ms": 1e3 * wall / len(got),
            "num_steps": p.num_steps}

    out = {}
    for kind in ("serial", "async"):
        whole, w = window(pipe(kind))
        res = {"whole": w, "ranks": []}
        for i in range(RANK_PIPELINE_DATA):
            sh = BatchShardings(RANK_PIPELINE_DATA, 1, i, 0)
            p = pipe(kind, sh)
            got, r = window(p)
            if len(got) != len(whole) or r["num_steps"] != w["num_steps"]:
                raise AssertionError(f"rank {i} {kind} pipeline: "
                                     f"{len(got)} batches, {r['num_steps']}"
                                     f" steps; whole {w['num_steps']}")
            for step, (g, b) in enumerate(zip(got, whole)):
                b = sh.select(b)
                bad = sorted(k for k in b if k not in g or not torch.equal(
                    g[k], b[k]))
                if bad or set(g) != set(b):
                    raise AssertionError(f"rank {i} {kind} step {step}: "
                                         f"{bad} differ from the whole "
                                         f"pipeline's block")
            if kind == "serial":
                r["epoch_steps"] = sum(1 for _ in p.epoch_batches(1))
                if r["epoch_steps"] != w["num_steps"]:
                    raise AssertionError(
                        f"rank {i}'s epoch took {r['epoch_steps']} steps, "
                        f"the whole stream's {w['num_steps']}")
            res["ranks"].append(r)
        out[kind] = res
        log(f"[phase 6f] {kind} pipeline as data rank i of a "
            f"{RANK_PIPELINE_DATA} x 1 mesh (no process group): the first "
            f"{steps} batches bitwise the whole pipeline's block, "
            f"{w['num_steps']} steps an epoch on every rank; host build "
            f"per step, ms: whole {w['build_ms']:.3f}, ranks "
            f"{[round(x['build_ms'], 3) for x in res['ranks']]}; wall per "
            f"step (build, stack, plan, copy), ms: whole "
            f"{w['wall_ms']:.3f}, ranks "
            f"{[round(x['wall_ms'], 3) for x in res['ranks']]}; {card}")
    return out


def backward_probe(dev):
    """Phase 6g's probe: an autograd function that doubles its input and
    whose backward also makes a ``(V, d)`` buffer (FB15k-237's table
    shape) that its forward never makes, run forward and backward on the
    card under the recorder. Returns the audit of a contract forbidding
    that shape (it must fail) and whether the backward ran on another
    thread than the caller's."""
    import threading
    import torch
    from repro_torch.analysis import CommContract, CommRecorder, audit_trace
    threads = []

    class TableInBackward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x * 2

        @staticmethod
        def backward(ctx, g):
            threads.append(threading.get_ident())
            full = torch.zeros((FB15K["entities"], FB15K["dim"]),
                               dtype=g.dtype, device=g.device)
            return g * 2 + full[:g.shape[0], :g.shape[1]]

    x = torch.ones((4, 8), device=dev, requires_grad=True)
    with CommRecorder() as rec:
        torch.autograd.grad(TableInBackward.apply(x).sum(), x)
    torch.cuda.synchronize()
    report = audit_trace(rec.trace, CommContract(
        "backward probe", (),
        forbidden_suffixes=((FB15K["entities"], FB15K["dim"]),)))
    return report, any(t != threading.get_ident() for t in threads)


AUDIT_SERVE_KERNELS = {"fp32": SERVING_KERNELS, "int8": SERVING_INT8_KERNELS}
AUDIT_TRAIN_KERNELS = ("basis_message", "segment_sum", "scatter_add_onehot")
AUDIT_RANK_KERNELS = {"all-entities": ("kge_score",), "candidates": ()}
AUDIT_EVAL_KERNELS = ("basis_message", "segment_sum", "kge_score")


def run_comm_audit(dev, card):
    """Phase 6g: the comm audit on the card (``repro_torch.analysis``).
    ``serve[topk]`` and ``serve[topk,int8]`` at FB15k-237 width
    (filtered) and ogbl-citation2 width (unfiltered), S = 4, 8 queries,
    k = 10: no collective, no dimension V (no dense (B, N) score matrix),
    int8 no float32 table image. On the one-rank NCCL group of phase 6f,
    at its configuration: the train step (psum_scatter, fp32 and int8,
    --use-kernel), the fp32 trainer's test evaluation
    (``eval[all-entities]``) and the rank step in both protocols (V
    14,541, d 75, B 256, 50 candidates), each holding that it recorded collectives, all
    on one-rank groups, and the in-place rule; the replication rule
    naming the rank's own block is refused by name. Every program runs
    once recorded and once not, its outputs bitwise equal. A probe whose
    (V, d) buffer exists only in its backward must fail the audit (the
    recorder sees the backward's thread). Launch counts are read around
    each program. Any violation fails the run."""
    from repro_torch.analysis import programs
    from repro_torch.launch import serve, train

    out, t_phase = {"programs": {}}, time.perf_counter()

    def keep(label, report, launches, want):
        row = report.as_row()
        row["launches"] = launches
        row["bitwise"] = not any("changed the program's outputs" in v
                                 for v in report.violations)
        out["programs"][label] = row
        missing = [k for k in want if launches[k] == 0]
        log(f"[phase 6g] {label}: {'ok' if report.ok else 'FAIL'}; "
            f"recorded {[(r['kind'], r['ranks'], r['count'], r['wire_bytes']) for r in row['recorded']]}; "
            f"rules {[(r['rule'], r['count'], r['wire_bytes']) for r in row['rules']]}; "
            f"violations {report.violations}; refused {row['refused']}; "
            f"in place {row['in_place']} of {row['min_in_place']}; "
            f"recorder on == off bitwise: {row['bitwise']}; launches "
            f"{launches}; {card}")
        if not report.ok or missing:
            raise AssertionError(f"phase 6g {label}: violations "
                                 f"{report.violations}, kernels never "
                                 f"launched {missing}")

    rng = np.random.default_rng(7)
    for wlabel, width, filtered in (("fb15k237", FB15K, True),
                                    ("citation2", CITATION2, False)):
        for dtype in ("fp32", "int8"):
            args = serve.parse_args(serve_argv(width, "distmult", 4, 0,
                                               filtered, 0, dtype))
            server, _, _ = serve.build_server(args)
            heads = rng.integers(0, width["entities"], SLOTS)
            rels = rng.integers(0, width["relations"], SLOTS)
            name = "serve[topk,int8]" if dtype == "int8" else "serve[topk]"
            reset_counts()
            report = programs.audit_server(server, heads, rels, K,
                                           filtered=filtered, name=name)
            keep(f"{name} {wlabel} S4", report, launch_counts(),
                 AUDIT_SERVE_KERNELS[dtype])
            del server
    with shared_preprocessing():
        for dtype in ("fp32", "int8"):
            tr = train.make_trainer(train.parse_args(
                SPMD_ARGV + ["--table-dtype", dtype, "--spmd"]))
            name = "train[psum_scatter" + (",int8]" if dtype == "int8"
                                           else "]")
            reset_counts()
            report = programs.audit_trainer_step(tr, name)
            keep(name, report, launch_counts(), AUDIT_TRAIN_KERNELS)
            tr.close()
            if dtype == "fp32":
                # the test evaluation, each rank over its own row block
                reset_counts()
                report = programs.audit_trainer_eval(tr)
                keep("eval[all-entities]", report, launch_counts(),
                     AUDIT_EVAL_KERNELS)
    cfg = programs.AuditConfig(
        num_trainers=4, num_table_shards=1, eval_dim=FB15K["dim"],
        eval_batch=256, eval_relations=FB15K["relations"],
        num_candidates=50, rank_entities=FB15K["entities"])
    for protocol in programs.RANK_PROTOCOLS:
        reset_counts()
        report = programs.audit_rank_step(protocol, tr.mesh, cfg, dev)
        keep(f"rank[{protocol}]", report, launch_counts(),
             AUDIT_RANK_KERNELS[protocol])
    del tr

    probe, other_thread = backward_probe(dev)
    if probe.ok:
        raise AssertionError("phase 6g: the recorder missed the (V, d) "
                             "buffer made in a backward")
    out["backward_probe"] = dict(violations=probe.violations,
                                 backward_on_other_thread=other_thread)
    log(f"[phase 6g] backward probe: the recorder saw the (V, d) buffer "
        f"made only in the backward ({probe.violations[0]}); the backward "
        f"ran on {'another' if other_thread else 'the calling'} thread")
    out["launches"] = {n: sum(r["launches"][n] for r in
                              out["programs"].values())
                       for n in launch_counts()}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[phase 6g] {len(out['programs'])} programs within contract; "
        f"{out['seconds']:.1f} s in all")
    return out


def run_spmd(dev, card, mb_trainer):
    """Phase 6f: each rank's own pipeline first (:func:`per_rank_pipelines`
    on ``mb_trainer``, phase 6b's main trainer; no process group). Then
    the multi-process step on a NCCL process group of world size 1 in
    this process (a 1 x 1 mesh: 4 trainers grouped on the one rank, a
    1-shard table), phase 6b's configuration with --use-kernel, fp32 and
    int8, through ``repro_torch.launch.train --spmd``, against the same
    configuration on the simulated step: per-step losses, parameters and
    Adam moments bitwise, the test evaluation equal, and
    ``make_sharded_rank_step`` over the rank's row block == the simulated
    counts in both protocols; then checkpoints under spmd
    (:func:`spmd_resume`), fp32 and int8. Launch counts are read around
    the spmd runs' steps and evaluation. Phase 6g (:func:`run_comm_audit`)
    runs on the same group, which is destroyed before returning."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import spmd_check, train

    t_phase = time.perf_counter()
    pipelines = per_rank_pipelines(mb_trainer, card)
    os.makedirs(os.path.dirname(SPMD_RENDEZVOUS), exist_ok=True)
    if os.path.exists(SPMD_RENDEZVOUS):
        os.remove(SPMD_RENDEZVOUS)
    dist.init_process_group("nccl", init_method=f"file://{SPMD_RENDEZVOUS}",
                            world_size=1, rank=0)
    out = {"rank_pipelines": pipelines}
    try:
        for dtype in ("fp32", "int8"):
            argv = SPMD_ARGV + ["--table-dtype", dtype]
            with shared_preprocessing():
                real = train.make_trainer(train.parse_args(argv + ["--spmd"]))
                sim = train.make_trainer(train.parse_args(argv +
                                                          ["--no-spmd"]))
            if real.mesh is None or real.mesh.shape != {"data": 1,
                                                        "model": 1}:
                raise AssertionError("--spmd built no 1 x 1 process mesh")
            reset_counts()
            r_steps = spmd_check.run_steps(real, 2)
            torch.cuda.synchronize()
            metrics = real.evaluate("test")
            launches = launch_counts()
            s_steps = spmd_check.run_steps(sim, 2)
            for tr in (real, sim):
                tr.close()
            bad = spmd_check.state_mismatches(real, sim)
            if r_steps["losses"] != s_steps["losses"] or bad:
                raise AssertionError(
                    f"spmd {dtype}: losses {r_steps['losses']} vs "
                    f"{s_steps['losses']}, state {bad}")
            sim_metrics = sim.evaluate("test")
            if metrics != sim_metrics:
                raise AssertionError(f"spmd {dtype} evaluation {metrics} != "
                                     f"simulated {sim_metrics}")
            # step times, alternated: real, simulated, simulated, real
            times = {"real": [], "sim": []}
            for label in ("real", "sim", "sim", "real"):
                tr = real if label == "real" else sim
                times[label].append(spmd_check.run_steps(tr, 4)["step_s"])
                tr.close()
            out[dtype] = dict(losses=r_steps["losses"], metrics=metrics,
                              launches=launches, step_s=times)
            log(f"[phase 6f] {dtype} table, 1 x 1 NCCL mesh: per-step losses "
                f"{r_steps['losses']}, parameters and Adam moments bitwise "
                f"the simulated step's; evaluation == simulated {metrics}; "
                f"step time real {[round(1e3 * x, 3) for x in times['real']]}"
                f" ms, simulated {[round(1e3 * x, 3) for x in times['sim']]}"
                f" ms; launches {launches}")
        rank = spmd_check.compare_rank_steps(real, sim)
        log(f"[phase 6f] make_sharded_rank_step over the rank's row block "
            f"== simulated counts, all-entities and candidate protocols, "
            f"fp32 and int8 tables: {rank}")
        out["rank_steps"] = rank
        del real, sim
        for dtype in ("fp32", "int8"):
            r = out[f"resume_{dtype}"] = spmd_resume(
                SPMD_ARGV + ["--table-dtype", dtype])
            missing = [k for k in SPMD_KERNELS
                       if k not in EVAL_KERNELS and r["launches"][k] == 0]
            if missing:
                raise AssertionError(f"kernels never launched on the "
                                     f"resumed spmd {dtype} run: {missing}")
            log(f"[phase 6f] {dtype} table under --spmd: epoch 2 restored "
                f"from an epoch-1 checkpoint ({r['checkpoint_bytes']} "
                f"bytes, saved in {r['save_s']:.3f} s, restored in "
                f"{r['restore_s']:.3f} s): per-step losses, parameters and "
                f"Adam moments bitwise the unbroken run's; the file == the "
                f"--no-spmd trainer's; epoch {r['t_epoch']:.3f} s; launches "
                f"{r['launches']}; {card}")
        out["audit"] = run_comm_audit(dev, card)
    finally:
        dist.destroy_process_group()
        if os.path.exists(SPMD_RENDEZVOUS):
            os.remove(SPMD_RENDEZVOUS)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[phase 6f] {out['seconds']:.1f} s in all")
    return out


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


def kernel_name(symbol: str) -> str:
    """The last name of a mangled nested symbol (``_ZN...``), with its
    template arguments as mangled: ``basis_message_kernel``,
    ``gather_rows_kernelIffLb1EE``."""
    rest, names = symbol[3:] if symbol.startswith("_ZN") else "", []
    while rest[:1].isdigit():
        digits = len(rest) - len(rest.lstrip("0123456789"))
        n = int(rest[:digits])
        names.append(rest[digits:digits + n])
        rest = rest[digits + n:]
    if not names:
        return symbol
    if rest.startswith("I"):
        return names[-1] + rest[:rest.find("EE") + 2]
    return names[-1]


def ptxas_lines(log_text: str):
    """``-Xptxas -v``'s registers, shared memory and spills, each line
    prefixed with the kernel it is about."""
    out, name = [], "?"
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = kernel_name(m.group(1))
        elif "registers" in line or "spill" in line or "smem" in line:
            out.append(f"{name}: {line.strip()}")
    return out


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
    ptxas = {name: ptxas_lines(text) for name, text in logs.items()}
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
    kge_v1_cases = check_kge_score_v1(dev, rng)
    gather_v1_cases = check_gathers_v1(dev, rng)
    phase2 = {"kge_score": check_kge_score(dev, rng, widths)}
    topk_err, topk_stats, topk_cases = check_topk(dev, rng, widths[:3])
    phase2 |= {"topk": (topk_err, topk_stats),
              "fused_gather": check_fused_gather(dev, rng, gather_widths,
                                                 mbs)}
    fdg_err, fdg_stats, table_bytes = check_fused_dequant_gather(
        dev, rng, gather_widths, mbs)
    phase2["fused_dequant_gather"] = (fdg_err, fdg_stats)
    bm_err, bm_stats, bm_configs = check_basis_message(dev, rng, part, mbs)
    phase2["basis_message"] = (bm_err, bm_stats)
    seg_err, seg_stats, seg_cases = check_segment_sum(dev, rng, part, mbs)
    phase2["segment_sum"] = (seg_err, seg_stats)
    phase2["scatter_add_onehot"] = check_scatter_add(dev, rng, mbs)
    phase2["wkv_chunked"] = check_wkv(dev, rng)
    phase2["wkv_chunked_backward"] = check_wkv_backward(dev, rng)
    log("[phase 2] kge_score and basis_message within their stated bounds; "
        "topk, fused_gather and fused_dequant_gather bitwise equal to their "
        "plain versions; kge_score, topk, fused_gather, "
        "fused_dequant_gather, basis_message, segment_sum, "
        "scatter_add_onehot and wkv_chunked bitwise equal to their first "
        "kernels; "
        "segment_sum deg == plain, agg within its bound, runs bitwise "
        "equal; scatter_add_onehot within its bound, non-hit rows 0, runs "
        "bitwise equal; wkv_chunked within its bounds of the plain chunked "
        "form and the sequential oracle, finite, runs bitwise equal; "
        "wkv_chunked_backward within its bound of the fp64 chunked plain "
        "gradient and the reference's gate of the fp64 sequential one, "
        "finite, runs bitwise equal, faster than its first kernel")

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
    plain_tr = train["plain"]["trainer"]
    fg_plain_loss = two_runs_bitwise(
        plain_tr, first_batch(plain_tr, epochs + 1),
        lambda: plain_tr.step_generators(epochs + 1, 0))
    log(f"[phase 6] two runs of one full-graph step (default path, no "
        f"--use-kernel): loss {fg_plain_loss!r} and every parameter bitwise "
        f"equal")
    # the kernel path's steady step is no slower than the plain path's
    fg_step = {k: float(np.mean([h["t_device_step"]
                                 for h in r["history"][1:]]))
               for k, r in train.items()}
    log(f"[phase 6] steady full-graph t_device_step (epochs 2-{epochs}): "
        f"kernel {1e3 * fg_step['kernel']:.2f} ms, plain "
        f"{1e3 * fg_step['plain']:.2f} ms")
    if fg_step["kernel"] > fg_step["plain"]:
        raise AssertionError(f"full-graph: the kernel path's step "
                             f"{fg_step['kernel']} s > the plain path's "
                             f"{fg_step['plain']} s")

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
    # the default path (no --use-kernel): 1 shard == 4 shards and serial
    # == async, bitwise
    plain_losses = mb["plain"]["history"][0]["losses"]
    for label in ("plain_S1", "plain_serial"):
        got = mb[label]["history"][0]["losses"]
        bad = bitwise_mismatch(mb["plain"]["trainer"], mb[label]["trainer"])
        if got != plain_losses or bad:
            raise AssertionError(f"mini-batch default path {label} != "
                                 f"plain: losses {got} vs {plain_losses}, "
                                 f"params {bad}")
    log("[phase 6b] default path (no --use-kernel): per-step losses and "
        "final parameters bitwise equal for --table-shards 1 and 4, "
        "--pipeline serial and async")
    # the kernel path's epoch device step against the plain path's, both
    # on the serial pipeline (on the async one both steps wait on the
    # host, whose threads build the next batches: its pair is printed)
    mb_step = {k: mb[k]["history"][0]["t_device_step"]
               for k in ("serial", "plain_serial", "main", "plain")}
    log(f"[phase 6b] mini-batch epoch t_device_step, serial pipeline: "
        f"kernel {mb_step['serial']:.3f} s, plain "
        f"{mb_step['plain_serial']:.3f} s; async pipeline: kernel "
        f"{mb_step['main']:.3f} s, plain {mb_step['plain']:.3f} s")
    if mb_step["serial"] > mb_step["plain_serial"]:
        raise AssertionError(f"mini-batch: the kernel path's epoch device "
                             f"step {mb_step['serial']} s > the plain "
                             f"path's {mb_step['plain_serial']} s")
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
    plain_mb = mb["plain"]["trainer"]
    mb_plain_loss = two_runs_bitwise(plain_mb, first_batch(plain_mb, 2),
                                     lambda: plain_mb.step_generators(2, 0))
    log(f"[phase 6b] two runs of one mini-batch step (default path): loss "
        f"{mb_plain_loss!r} and every parameter bitwise equal")
    plans = plan_cost(main_tr, mb_batch)
    log(f"[phase 6b] scatter plans of one mini-batch step "
        f"({plans['plans']} id arrays, {plans['bytes'] / 1e6:.2f} MB), "
        f"built by the step on the card at first use: "
        f"{plans['device_ms']:.4f} ms of device time per step")
    # where the plans are built, on the default path and the kernel path:
    # the async epoch with each placement, alternated
    placements = {}
    for label, tr in (("plain", mb["plain"]["trainer"]), ("kernel", main_tr)):
        placements[label] = plan_placements(tr)
        for name, runs in placements[label].items():
            log(f"[phase 6b] {label} path, async epoch with the plans built "
                f"{PLACEMENT[name]}: t_epoch "
                f"{[round(x['t_epoch'], 3) for x in runs]} s, device step "
                f"{[round(x['t_device_step'], 3) for x in runs]} s, host "
                f"build {[round(x['t_host_build'], 3) for x in runs]} s, "
                f"wall {[round(x['wall_s'], 3) for x in runs]} s")
    log("[phase 6b] host-built plans == card-built plans, bitwise, on one "
        "batch of each path")

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

    # phase 6d: exact resume from a checkpoint, fp32 and int8 tables;
    # counts reset and read inside resume_exact around each resumed run
    resume = {}
    for label, opts, path_kernels in (
            ("fp32", [], MINIBATCH_KERNELS),
            ("int8", INT8, MINIBATCH_INT8_KERNELS)):
        # the resumed main run (4 shards) is the path; the 1-shard one,
        # whose dense table has no sharded gather, a bitwise gate
        r = resume[label] = resume_exact(opts)
        launches = r["runs"]["S4"]["launches"]
        missing = [k for k in path_kernels
                   if k not in EVAL_KERNELS and launches[k] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the resumed "
                                 f"{label} run: {missing}")
        log(f"[phase 6d] {label} table: epoch 2 restored from an epoch-1 "
            f"checkpoint ({r['checkpoint_bytes']} bytes, saved in "
            f"{r['save_s']:.3f} s) into 4 and 1 table shards: per-step "
            f"losses and final parameters bitwise the unbroken run's; "
            f"restore {r['runs']['S4']['restore_s']:.3f} / "
            f"{r['runs']['S1']['restore_s']:.3f} s, epoch "
            f"{r['runs']['S4']['t_epoch']:.3f} / "
            f"{r['runs']['S1']['t_epoch']:.3f} s; launches "
            f"{r['runs']['S4']['launches']} / "
            f"{r['runs']['S1']['launches']}; {card}")

    # phase 6e: ogbl-citation2 at full width (counts reset and read inside
    # train_once around the main run), with phase 2 at its shapes
    c2 = run_citation2(dev, part, mbs, phase2)
    # phase 6f: the multi-process step on a NCCL group of one rank (counts
    # reset and read inside run_spmd around the spmd runs)
    spmd = run_spmd(dev, card, main_tr)
    for label in ("fp32", "int8"):
        missing = [k for k in SPMD_KERNELS
                   if spmd[label]["launches"][k] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the spmd "
                                 f"{label} path: {missing}")

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
            f"{p['idle_share']:.3f}, sort kernels "
            f"{p['sort_ms_per_step']:.4f} ms; top "
            f"{p['top_device_ms_per_step']}")
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
        f"ms, idle share {p['idle_share']:.3f}, sort kernels "
        f"{p['sort_ms_per_step']:.4f} ms (every plan of the step); top "
        f"{p['top_device_ms_per_step']}")
    plain_mb = mb["plain"]["trainer"]
    gens_p = plain_mb.step_generators(2, 0)
    p = step_profile(lambda: plain_mb.step(mb_batch, gens_p))
    profiles["minibatch_step_plain"] = p
    log(f"[phase 7] mini-batch step (4-shard table, plain encoder): "
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

    # phase 8f: LM training at full width, once phase 7 has released the
    # phase-8 weights; counts reset and read inside run_lm_train around
    # each step
    lm_train = run_lm_train(dev, card)
    lm_train_launches = {n: sum(st["launches"][n] for st in lm_train["steps"])
                         for n in KERNELS}

    kernels = []
    # each kernel's head shape: the mini-batch path's where it runs there
    heads = {"kge_score": "rank_S4", "topk": "citation2_S1",
             "fused_gather": "minibatch_S4",
             "fused_dequant_gather": "minibatch_S4",
             "basis_message": "minibatch", "segment_sum": "minibatch",
             "scatter_add_onehot": "h_dst", "wkv_chunked": "prefill",
             "wkv_chunked_backward": "train"}
    for name, head_shape in heads.items():
        max_err, stats = phase2[name]
        head = stats[head_shape]
        by_path = {"serve": serve_launches[name],
                   "serve_int8": serve_int8_launches[name],
                   "train": train_launches[name],
                   "minibatch": mb_launches[name],
                   "minibatch_int8": mb8_launches[name],
                   "resume": resume["fp32"]["runs"]["S4"]["launches"][name],
                   "resume_int8":
                       resume["int8"]["runs"]["S4"]["launches"][name],
                   "citation2": c2["launches"][name],
                   "spmd": spmd["fp32"]["launches"][name],
                   "spmd_int8": spmd["int8"]["launches"][name],
                   "spmd_resume": spmd["resume_fp32"]["launches"][name],
                   "spmd_resume_int8":
                       spmd["resume_int8"]["launches"][name],
                   "audit": spmd["audit"]["launches"][name],
                   "lm": lm_launches[name],
                   "lm_train": lm_train_launches[name]}
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=sum(by_path.values()),
            launches_by_path=by_path, max_abs_err=max_err, ms=head["ms"],
            plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=head["library_ms"],
            widths=stats))
        if "first_kernel_ms" in head:   # held against it in phase 2
            kernels[-1]["first_kernel"] = dict(
                name=f"{KERNELS[name].__name__}_v1",
                ms=head["first_kernel_ms"],
                bitwise=head.get("first_kernel_bitwise", True))
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
                       "fullgraph_plain_two_run_loss": fg_plain_loss,
                       "minibatch_two_run_loss": mb_loss,
                       "minibatch_plain_two_run_loss": mb_plain_loss,
                       "fullgraph_steady_step_s": fg_step,
                       "minibatch_epoch_device_step_s": mb_step,
                       "minibatch_plans": plans,
                       "minibatch_plan_placements": placements,
                       "kge_score_first_kernel_cases": kge_v1_cases,
                       "gather_first_kernel_cases": gather_v1_cases,
                       "topk_edge_cases": topk_cases,
                       "segment_sum_cases": seg_cases,
                       "minibatch_int8_two_run_loss": mb8_loss,
                       "resume": resume,
                       "citation2": c2, "spmd": spmd,
                       "embedding_max_abs_diff": emb_err,
                       "lm": lm, "lm_train": lm_train,
                       "profile": profiles,
                       "total_s": time.perf_counter() - t_start}, f, indent=1)
    log(f"[profiler] {WINDOWS['taken']} windows, {WINDOWS['incomplete']} "
        f"of them incomplete and taken again")
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
