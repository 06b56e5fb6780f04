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
9. The dense decoder LMs and the RG-LRU hybrid at full width (after phase
   8f has freed its memory), fp32 weights drawn on the card from seed 0,
   TF32 off, each model freed before the next; none of the nine kernels is
   on these paths (attention, RoPE, the MLPs and the RG-LRU are plain
   PyTorch). (a) glm4-9b, 40 layers: the prefill at B = 4, S = 2,048 (the
   chunked attention ``_mea``), its time and model-FLOP rate against 67
   TFLOP/s; a 64-token prompt through ``decode_step`` ends at the
   prefill's last logits within LM_LOGIT_TOL; a steady decode step against
   reading the weights; ``ServeEngine(slots=4, max_seq=64)`` answers 8
   greedy requests, all done; the weights rounded to bf16: the bf16
   prefill against 989 TFLOP/s, the prompt through a bf16 decode_step
   within twice the bf16 prefill's own error of the bf16 prefill and of the
   fp32 one, a bf16 decode step's time; phase 7 profiles the bf16 prefill and a bf16 decode
   step (busy, idle share, the attention core's share, the top
   operations). (b) ``_mea`` against ``_sdpa`` within MEA_TOL at layer 0
   of glm4-9b (B 4, S 2,048) and at gemma-2b-sw's head layout (B 1, S
   8,192, window 4,096), each one's time and
   ``F.scaled_dot_product_attention``'s as a yardstick (on no path). (c)
   gemma-2b and gemma-2b-sw, 18 layers: bitwise equal at S = 2,048; at B =
   1, S = 8,192 finite, equal below the window and different past it; with
   the window set to 64, a 96-token prompt through the 64-row ring-buffer
   cache ends at the windowed prefill within LM_LOGIT_TOL. (d) qwen3-32b
   and qwen2.5-32b at full width, depth cut to 8 of 64 layers (131 GB of
   fp32 weights each whole): the prefill at B = 1, S = 2,048, a 64-token
   prompt through decode against it. (e) recurrentgemma-9b, 38 layers: the
   prefill at B = 2, S = 4,096 (past the local window) with the RG-LRU
   scan's share, a 64-token prompt through decode against it, 8 requests
   through ServeEngine. (f) gemma-2b training, fp32, remat on, B = 1, S =
   2,048: three ``make_train_step`` Adam steps on ``TokenStream`` batches,
   finite losses, each step's time and model-FLOP rate, the peak device
   memory under 80 GB. (g) no kernel launched in phase 9.
10. The MoE family at full width (after phase 9 has freed its memory),
   weights drawn on the card from seed 0, TF32 off for fp32; the router's
   top-k is topk_scores, one launch a MoE layer and call, and the experts,
   both dispatches and MLA are plain PyTorch. (a) deepseek-v2-lite-16b, 27
   layers (1 dense, 26 MoE; MLA, 64 experts top-6 and 2 shared), fp32,
   dense dispatch: the prefill at B = 1, S = 2,048 (MLA on ``_mea``), its
   time and model-FLOP rate against 67 TFLOP/s (low by design: dense
   dispatch computes every expert for every token); exactly 26 topk_scores
   launches per prefill and per decode step and no other kernel; a
   64-token prompt at B = 4 through decode_step ends at the prefill's last
   logits within LM_LOGIT_TOL; a steady decode step against reading the
   weights; ServeEngine answers 8 greedy requests, all done. (b) the same
   weights under capacity dispatch: at the config's factor 1.25 the
   prefill's time and two prefills bitwise equal; at a factor with room
   for every pair (CAPACITY_ROOM times the largest expert load of the 1.25
   run; every layer checked to drop nothing) within LM_LOGIT_TOL of (a)'s
   dense prefill. (c) the fp32 tree freed, the bf16 tree drawn from the
   same generator (routers fp32): the bf16 prefill's time against 989
   TFLOP/s; with every run on the fp32 prefill's experts, the prompt
   through a bf16 decode_step within twice the bf16 prefill's own error
   of the bf16 prefill and of the fp32 one; with the experts free, each
   token of the first MoE layer that the bf16 prefill or decode routes
   otherwise than the fp32 prefill has its k-th minus (k+1)-th gap within
   the change of its router logits, a bf16-sized change (at most
   BF16_ROUTER_SPREAD of the logits' range); a bf16 decode step's time;
   phase 7's profile of the bf16 prefill with the dense dispatch's
   experts' share (one layer's experts profiled alone, times 26). (d) arctic-480b at full width (128
   experts top-2 and a dense residual FFN), depth cut: 1 of 35 layers in
   fp32 (prefill at B = 1, S = 1,024; decode == prefill; capacity with
   room for every pair == dense dispatch), then 2 layers in bf16 (prefill,
   a decode step at B = 4 against reading the weights, ServeEngine answers
   4 requests). (e) deepseek-v2-lite-16b training at full width, its dense
   and one MoE layer, fp32, remat on, B = 1, S = 1,024: three
   make_train_step Adam steps, finite losses, moe_aux finite and above 0,
   a non-zero router gradient, each step's time and the peak memory.
   Then, after the counts are read, topk_scores against topk_plain and
   timed beside torch.topk on the router probabilities of every shape
   phase 10 gave it (deepseek's and arctic's prefill and B = 4 decode
   rows among them).
11. The multimodal backbones at full width and depth, fp32, TF32 off, no
   kernel launched. (a) whisper-large-v3 (32 encoder and 32 decoder
   layers): the prefill at B = 4, S = 448 over frame embeddings (4, 1,500,
   1,280) drawn from the seed, its time; a 64-token prompt through
   decode_step, the cache's encoder_out the encoder's output of the same
   frames, == the prefill within LM_LOGIT_TOL, once recomputing the cross
   k and v and once with them cached (cache_cross_kv); ServeEngine answers
   8 requests (zero frames, the reference's serving). (b) qwen2-vl-7b: the
   prefill at B = 2, S = 2,048 with vision embeddings drawn from the seed
   and 3-D positions (M-RoPE on ``_mea``), its time and model-FLOP rate;
   a 64-token prompt through decode_step at positions_3d = t == the
   prefill; ServeEngine answers 8 requests. (c) no kernel launched in
   phase 11.

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
# phase 9: the dense decoder LMs and the RG-LRU hybrid at full width, fp32
# weights drawn on the card from seed 0, TF32 off. No kernel of the port is
# on these paths: attention, RoPE, the MLPs and the RG-LRU are plain
# PyTorch, as the reference computes them in plain jnp.
BF16_OPS_PER_S = 989e12     # H100 SXM bf16 dense peak at 700 W
# (a) glm4-9b at full width and depth, cut against the reference's
# prefill_32k shape (B = 32, S = 32,768) to B = 4, S = 2,048, which takes
# the chunked attention (_mea, from S = 2,048 on): the fp32 weights are
# 37.6 GB and the prefill's full fp32 logits 5.0 GB
DENSE_ARCH, DENSE_B, DENSE_S = "glm4-9b", 4, 2048
# (b) _mea against _sdpa: the reference's gate for the pair
# (tests/test_attention.py:27-28)
MEA_TOL = dict(rtol=2e-4, atol=2e-5)
SW_S = 8192          # (b), (c): gemma-2b-sw past its 4,096-token window
# (c) the window-sized decode cache as a ring buffer: gemma-2b-sw at full
# width with its window set to 64, a 96-token prompt
RING_WINDOW, RING_PROMPT = 64, 96
# (d) qwen3-32b and qwen2.5-32b at full width, 8 of their 64 layers: each
# whole model is 131 GB of fp32 weights, more than the card's 80 GB
QWEN_DEPTH, QWEN_B, QWEN_S = 8, 1, 2048
# (e) recurrentgemma-9b at full width and depth, S past its 2,048 window
HYBRID_ARCH, HYBRID_B, HYBRID_S = "recurrentgemma-9b", 2, 4096
# (f) gemma-2b training at full width and depth, fp32, remat on (the
# config's), against the reference's train_4k shape (B = 256, S = 4,096)
GEMMA_TRAIN_B, GEMMA_TRAIN_S, GEMMA_TRAIN_STEPS = 1, 2048, 3
# phase 10: the MoE family at full width, fp32 weights drawn on the card
# from seed 0, TF32 off. The router's top-k is the one kernel of the port
# on its path (topk_scores, one launch a MoE layer and call); the experts,
# the dispatch and MLA are plain PyTorch, as the reference computes them
# in plain jnp. (a)-(c) deepseek-v2-lite-16b at full depth (27 layers: 1
# dense, 26 MoE; 62.8 GB of fp32 weights), cut against the reference's
# prefill_32k shape (B = 32, S = 32,768) to B = 1, S = 2,048, which takes
# MLA's chunked attention (_mea): dense dispatch's (T, E, d_ff) and (E, T,
# d) fp32 temporaries are then ~4 GB a layer
MOE_ARCH, MOE_B, MOE_S = "deepseek-v2-lite-16b", 1, 2048
MOE_PREFILL_PREDICTED_S = (1.4, 2.2)   # PERF.md's prediction for 10a
# (b) capacity dispatch at the config's factor (1.25), and at a factor with
# room for every pair: a factor of E (one slot a pair, cap = T k)
# would add ~26 GB of (E, C, ·) fp32 buffers a layer to the 62.8 GB of
# weights, so the factor is set from the experts' largest load in the 1.25
# run, with CAPACITY_ROOM times room, and every layer of the ample run is
# checked to drop nothing
CAPACITY_ROOM = 2.0
# (c) bf16 routing against fp32 in the first MoE layer: a token can take
# another expert only where the change of its router logits (up to the
# row's constant) spans its gap between the k-th and (k+1)-th expert; the
# slack covers the fp32 softmax's rounding in the log-probabilities. The
# change itself must be bf16-sized: at most 16 units of bf16 rounding
# (2^-8 each) of the token's logits' range, where a router fault (another
# layer's router, a wrong input) moves the logits by their own size
ROUTER_LOG_SLACK = 1e-5
BF16_ROUTER_SPREAD = 2.0 ** -4
# (d) arctic-480b at full width (13.61 G parameters a layer; 954 GB of
# bf16 weights whole): 1 of its 35 layers in fp32 (56.3 GB with the
# embeddings), 2 in bf16 (55.4 GB), prefill at B = 1, S = 1,024
ARCTIC_ARCH, ARCTIC_S = "arctic-480b", 1024
ARCTIC_DEPTH_FP32, ARCTIC_DEPTH_BF16, ARCTIC_REQUESTS = 1, 2, 4
# (e) MoE training: deepseek-v2-lite-16b at full width, its dense layer
# and one MoE layer, fp32, remat on, B = 1, S = 1,024, three Adam steps
MOE_TRAIN_DEPTH, MOE_TRAIN_B, MOE_TRAIN_S, MOE_TRAIN_STEPS = 2, 1, 1024, 3
# phase 11: the multimodal backbones at full width and depth, fp32, no
# kernel of the port on their paths. (a) whisper-large-v3 (32 encoder and
# 32 decoder layers; 6.1 GB): prefill at B = 4 over 448 decoder tokens
# (the model's text context) and 1,500 frames drawn from the seed
WHISPER_ARCH, WHISPER_B, WHISPER_S = "whisper-large-v3", 4, 448
# (b) qwen2-vl-7b (28 layers; 30.5 GB): prefill at B = 2, S = 2,048 with
# vision embeddings drawn from the seed and 3-D positions (M-RoPE on _mea)
VLM_ARCH, VLM_B, VLM_S = "qwen2-vl-7b", 2, 2048

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
        kge_score, kge_score_bytes, kge_score_ops, kge_score_plain,
        kge_score_v1,
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
        st = stats[label] = dict(B=b, C=c, d=d, **timings(
            lambda: kge_score(q, cand, bias, qb, cb, epilogue="neg_l2"),
            lambda: kge_score_plain(q, cand, bias, qb, cb,
                                    epilogue="neg_l2"),
            lambda: torch.matmul(q, cand.T),
            *bound_ms(kge_score_bytes(b, c, d), kge_score_ops(b, c, d))))
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
        stream_select, stream_splits, topk_plain, topk_scores,
        topk_scores_bytes, topk_scores_ops, topk_scores_v1,
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
            *bound_ms(topk_scores_bytes(SLOTS, c, K, call_ids is not None),
                      topk_scores_ops(SLOTS, c))))
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
        fused_gather, fused_gather_bytes, fused_gather_plain, fused_gather_v1,
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
            *bound_ms(fused_gather_bytes(SLOTS, d, n_own), 0)))
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
        *bound_ms(fused_gather_bytes(v, 75, n_own), 0)))
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
        fused_dequant_gather, fused_dequant_gather_bytes,
        fused_dequant_gather_ops, fused_dequant_gather_plain,
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
        return bound_ms(fused_dequant_gather_bytes(v, d, n_own),
                        fused_dequant_gather_ops(v, d))

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
        basis_message, basis_message_bytes, basis_message_config,
        basis_message_ops, basis_message_plain, basis_message_v1,
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
            nbytes = basis_message_bytes(ne, nb, d_in, d_out)
            ops = basis_message_ops(ne, nb, d_in, d_out, n_on)
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
        segment_sum, segment_sum_bytes, segment_sum_ops, segment_sum_plain,
        segment_sum_planned, segment_sum_v1,
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
            st = dict(E=ne, V=nv, d=d, longest_segment=int(deg.max()),
                      **timings(
                          lambda: segment_sum(msg, seg_t, m, nv, plan=plan),
                          lambda: segment_sum_plain(msg, seg_t, m, nv),
                          lambda: torch.zeros((nv + 1, d), device=dev)
                          .index_add_(0, key, msg),
                          *bound_ms(segment_sum_bytes(ne, nv, d, n_on),
                                    segment_sum_ops(ne, d, n_on))))
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
        scatter_add_onehot, scatter_add_onehot_bytes, scatter_add_onehot_ops,
        scatter_add_onehot_plain, scatter_add_onehot_v1, scatter_add_planned,
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
            nbytes = scatter_add_onehot_bytes(v, r, d, n_own,
                                              owned is not None)
            st = dict(V=v, R=r, d=d, longest_row=longest, **timings(
                lambda: scatter_add_onehot(g, flat_t, own_t, r, plan=plan),
                lambda: scatter_add_onehot_plain(g, flat_t, own_t, r),
                lambda: torch.zeros((r + 1, d), device=dev)
                .index_add_(0, key, g),
                *bound_ms(nbytes, scatter_add_onehot_ops(v, d, n_own))))
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
        wkv_chunked, wkv_chunked_bytes, wkv_chunked_ops, wkv_chunked_plain,
        wkv_chunked_states, wkv_chunked_v1,
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
            b_ms, b_by = bound_ms(wkv_chunked_bytes(bh, s, hd),
                                  wkv_chunked_ops(bh, s, hd, chunk))
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
        wkv_chunked_backward, wkv_chunked_backward_bytes,
        wkv_chunked_backward_chunked_plain, wkv_chunked_backward_ops,
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
            b_ms, b_by = bound_ms(wkv_chunked_backward_bytes(bh, s, hd),
                                  wkv_chunked_backward_ops(bh, s, hd))
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
    stats["margin"] = check_wkv_backward_margin(dev, rng)
    return max_err, stats


WKV_BWD_MARGIN_SHAPE = (16 * 40, 4096, 64)   # BH (B 16 x 40 heads), S, hd
WKV_BWD_MARGIN_ROWS = 64      # rows of the fp64 sequential gradient at once
WKV_BWD_MARGIN_FAULT = 0.5    # a larger share of the gate is a fault


def check_wkv_backward_margin(dev, rng):
    """dlog_decay's margin at the reference's training length: the
    kernel's gradient (chunk 64) at BH = 640 (16 batch rows of rwkv6-3b's
    40 heads; the train_4k batch is 256 rows), S = 4,096, against the
    fp64 sequential gradient (autograd through the oracle), which is
    computed WKV_BWD_MARGIN_ROWS rows at a time so that its saved states
    stay bounded. Every output within the reference's gradient gate (rtol
    5e-3, atol 1e-4); each output's largest share of the gate printed. A
    dlog_decay share above WKV_BWD_MARGIN_FAULT is a fault (ROADMAP,
    Queue 3): it is logged as one, and the phase fails only past the
    gate itself."""
    import torch
    from repro_torch.kernels.wkv_chunk import (
        wkv_chunked_backward, wkv_chunked_backward_plain,
    )
    bh, s, hd = WKV_BWD_MARGIN_SHAPE
    t0 = time.perf_counter()
    x = wkv_inputs(dev, rng, bh, s, hd)
    g = torch.from_numpy(rng.normal(size=(bh, s, hd)).astype(
        np.float32)).to(dev)
    got = wkv_chunked_backward(*x, g, chunk=64)
    names = ("dr", "dk", "dv", "dlog_decay", "du")
    share = dict.fromkeys(names, 0.0)
    for lo in range(0, bh, WKV_BWD_MARGIN_ROWS):
        rows = slice(lo, lo + WKV_BWD_MARGIN_ROWS)
        want = wkv_chunked_backward_plain(
            *(t[rows].double() for t in x), g[rows].double())
        for name, a, w in zip(names, got, want):
            if not bool(torch.isfinite(a[rows]).all()):
                raise AssertionError(f"wkv_chunked_backward margin: {name} "
                                     f"not finite")
            gate = 1e-4 + 5e-3 * w.abs()
            share[name] = max(share[name], float(
                ((a[rows].double() - w).abs() / gate).max()))
        del want
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    fault = share["dlog_decay"] > WKV_BWD_MARGIN_FAULT
    log(f"[phase 2] wkv_chunked_backward margin (BH={bh}, S={s}, hd={hd}, "
        f"chunk=64; the fp64 sequential gradient {WKV_BWD_MARGIN_ROWS} rows "
        f"at a time): largest share of the reference's gate "
        + ", ".join(f"{n} {share[n]:.3f}" for n in names)
        + f"; dlog_decay {share['dlog_decay']:.3f} of the gate "
        + ("ABOVE" if fault else "within")
        + f" the fault line {WKV_BWD_MARGIN_FAULT}; {seconds:.1f} s")
    worst = max(share, key=share.get)
    if share[worst] > 1.0:
        raise AssertionError(f"wkv_chunked_backward margin: {worst} outside "
                             f"the reference's gate, share {share[worst]}")
    return dict(BH=bh, S=s, hd=hd, reference_gate_share=share,
                fault=fault, seconds=seconds)


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
        cache = T.init_decode_cache(cfg, LM_B, n, device=dev,
                                    dtype=torch.float32)
        reset_counts()
        for t in range(n):
            logits, cache = T.decode_step(params, cfg, tok_b[:, t:t + 1],
                                          cache, torch.full((LM_B,), t,
                                                            device=dev))
        torch.cuda.synchronize()
        windows["decode"] = launch_counts()
        res["decode_max_abs_diff"] = max_abs_diff(logits[:, 0], want)
        torch.testing.assert_close(logits[:, 0], want, **LM_LOGIT_TOL)
        res["decode_argmax_agree"] = int(
            (logits[:, 0].argmax(-1) == want.argmax(-1)).sum())
        serve_step = make_serve_step(cfg)
        step_batch = {"tokens": tok_b[:, -1:],
                      "pos": torch.full((LM_B,), n - 1, device=dev)}
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
    cache = T.init_decode_cache(cfg, LM_B, tok_b.shape[1], device=dev,
                                dtype=torch.bfloat16)
    for t in range(tok_b.shape[1]):
        logits, cache = T.decode_step(p16, cfg, tok_b[:, t:t + 1], cache,
                                      torch.full((LM_B,), t, device=dev))
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


def step_argument_bytes(params, opt_state, batch) -> int:
    """Bytes of what a train step is given: the parameters, the optimizer's
    step and moments, and the batch, as allocated on the card."""
    import torch
    from repro_torch.nn import transformer as T
    tensors = [t for _, t in T.leaves(params)] + [opt_state.step]
    for moments in (opt_state.mu, opt_state.nu):
        tensors += list((moments or {}).values())
    tensors += list(batch.values())
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def counted_flops(fn) -> int:
    """The aten FLOPs ``FlopCounterMode`` counts around one more, untimed
    call of ``fn`` (a train step; a hand-written kernel's ctypes launch is
    no aten op and is not counted)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        fn()
    torch.cuda.synchronize()
    return int(fc.get_total_flops())


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
    res["argument_bytes"] = step_argument_bytes(params, opt_state,
                                                batches[0])
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
    res["flop_counter"] = counted_flops(lambda: step(params, opt_state,
                                                     extra))
    del params, opt_state, step, batches, extra
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------- #
# phase 9: the dense decoder LMs and the RG-LRU hybrid at full width
# ---------------------------------------------------------------------- #
def release():
    """Free what the last model left on the card."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def draw_lm(cfg, dev, label, bf16=False):
    """``cfg``'s weights drawn on the card from a CUDA generator of seed 0,
    fp32 (or bf16: the fp32 draw rounded, the MoE routers kept fp32);
    returns ``(params, {"params", "param_bytes", "init_s"})``."""
    import torch
    from repro_torch.nn import transformer as T
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = T.init_params(cfg, generator=torch.Generator(device=dev)
                           .manual_seed(0), device=dev,
                           dtype=torch.bfloat16 if bf16 else torch.float32)
    torch.cuda.synchronize()
    res = dict(params=T.count_params(params), init_s=time.perf_counter() - t0,
               param_bytes=sum(t.numel() * t.element_size()
                               for _, t in T.leaves(params)))
    moe = (f", {cfg.num_experts} experts top-{cfg.top_k} of d_ff "
           f"{cfg.d_ff_expert}" if cfg.num_experts else "")
    log(f"[phase {label}] {cfg.name} at full width ({cfg.num_layers} layers, "
        f"d {cfg.d_model}, {cfg.num_heads} heads / {cfg.num_kv_heads} kv of "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}{moe}, V {cfg.vocab_size}): "
        f"{res['params']:,} {'bf16' if bf16 else 'fp32'} parameters "
        f"({res['param_bytes'] / 1e9:.2f} GB) drawn on the card in "
        f"{res['init_s']:.2f} s")
    return params, res


def finite_logits(x, shape, label):
    import torch
    if tuple(x.shape) != tuple(shape) or not bool(torch.isfinite(x).all()):
        raise AssertionError(f"{label}: logits {tuple(x.shape)} (expected "
                             f"{tuple(shape)}) or not finite")


def timed_prefill(params, cfg, batch, label, card, reps=2, bf16=False):
    """The main path's prefill once (its last logits checked), then its time
    on CUDA events (``reps`` calls), its model-FLOP rate against the fp32
    (bf16) peak and the peak device memory of the first call."""
    import torch
    from repro_torch.launch.specs import InputShape, model_flops
    from repro_torch.launch.steps import make_prefill_step
    prefill = make_prefill_step(cfg)
    b, s = batch["tokens"].shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    last = prefill(params, batch)
    torch.cuda.synchronize()
    finite_logits(last, (b, cfg.vocab_size), f"{label} {cfg.name} prefill")
    res = dict(prefill_peak_bytes=torch.cuda.max_memory_allocated(),
               prefill_ms=time_ms(lambda: prefill(params, batch), reps=reps,
                                  warmup=0),
               prefill_flop=model_flops(cfg, InputShape("prefill", s, b,
                                                        "prefill")))
    res["prefill_tflops"] = res["prefill_flop"] / res["prefill_ms"] / 1e9
    peak = BF16_OPS_PER_S if bf16 else FP32_OPS_PER_S
    log(f"[phase {label}] {cfg.name} {'bf16' if bf16 else 'fp32'} prefill "
        f"B={b}, S={s}: {res['prefill_ms']:.1f} ms = "
        f"{res['prefill_tflops']:.2f} TFLOP/s of model FLOPs "
        f"({res['prefill_flop']:.4g}), {res['prefill_tflops'] * 1e12 / peak:.3f} "
        f"of the {peak / 1e12:.0f} TFLOP/s {'bf16' if bf16 else 'fp32'} "
        f"peak; peak memory {res['prefill_peak_bytes'] / 1e9:.2f} GB; {card}")
    return last, res


def fill_cross_kv(params, cfg, cache):
    """Each decoder layer's cross-attention k and v of the cache's
    ``encoder_out`` into its ``cross_kv`` (``cache_cross_kv``), as the
    reference's cached-decode test fills them."""
    from repro_torch.nn import attention as A
    from repro_torch.nn import transformer as T
    kv = cache["groups"][0]["cross_kv"]
    for i in range(cfg.num_layers):
        lp = T.layer_params(params["groups"][0], i)
        for k, v in A.cross_kv_cache(
                lp["cross_attn"], cache["encoder_out"],
                num_kv_heads=cfg.num_heads,
                head_dim=cfg.resolved_head_dim).items():
            kv[k][i] = v


def position_inputs(cfg, b, t, dev):
    """A decode step's M-RoPE positions: ``t`` on all three streams."""
    import torch
    return ({"positions_3d": torch.full((b, 1, 3), t, device=dev)}
            if cfg.m_rope else {})


def decode_prompt(params, cfg, tok, encoder_out=None):
    """The prompt ``tok`` (B, P) through ``decode_step`` from an empty cache
    of P positions in the weights' dtype (the encoder-decoder's attending to
    ``encoder_out``, its cross k and v cached under ``cache_cross_kv``):
    ``(last logits (B, V), cache)``."""
    import torch
    from repro_torch.nn import transformer as T
    b, n = tok.shape
    cache = T.init_decode_cache(cfg, b, n, device=tok.device,
                                dtype=params["embed"].dtype)
    if encoder_out is not None:
        cache["encoder_out"] = encoder_out
        if cfg.cache_cross_kv:
            fill_cross_kv(params, cfg, cache)
    for t in range(n):
        logits, cache = T.decode_step(
            params, cfg, tok[:, t:t + 1], cache,
            torch.full((b,), t, device=tok.device),
            **position_inputs(cfg, b, t, tok.device))
    return logits[:, 0], cache


def decode_against_prefill(params, cfg, tok, label, card, audio_frames=None):
    """A prompt through ``decode_step`` ends at the prefill's last logits of
    that prompt within LM_LOGIT_TOL (fp32; the encoder-decoder's prefill of
    ``audio_frames``, its decode attending to the encoder's output of the
    same frames); then one steady decode step (``make_serve_step`` at the
    prompt's last position) on CUDA events, against reading the weights
    once. Returns ``(results, the prefill's last logits)``."""
    import torch
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.nn import transformer as T
    batch, encoder_out = {"tokens": tok}, None
    if audio_frames is not None:
        batch["audio_frames"] = audio_frames
        encoder_out = T.encode(params, cfg, audio_frames)
    want = make_prefill_step(cfg)(params, batch)
    got, cache = decode_prompt(params, cfg, tok, encoder_out)
    torch.cuda.synchronize()
    res = dict(decode_max_abs_diff=max_abs_diff(got, want),
               decode_argmax_agree=int((got.argmax(-1) == want.argmax(-1))
                                       .sum()))
    torch.testing.assert_close(got, want, **LM_LOGIT_TOL)
    b, n = tok.shape
    step = make_serve_step(cfg)
    batch = {"tokens": tok[:, -1:],
             "pos": torch.full((b,), n - 1, device=tok.device),
             **position_inputs(cfg, b, n - 1, tok.device)}
    res["decode_step_ms"] = time_ms(lambda: step(params, cache, batch),
                                    reps=10, warmup=2)
    nbytes = sum(t.numel() * t.element_size() for _, t in T.leaves(params))
    res["decode_floor_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"[phase {label}] {cfg.name}: {n} tokens through decode_step == the "
        f"prefill's last logits within {LM_LOGIT_TOL} (max |diff| "
        f"{res['decode_max_abs_diff']:.3g}, argmax agrees in "
        f"{res['decode_argmax_agree']} of {b}); a steady decode step "
        f"{res['decode_step_ms']:.3f} ms against the "
        f"{res['decode_floor_ms']:.3f} ms of reading "
        f"{nbytes / 1e9:.2f} GB of weights; {card}")
    return res, want


def serve_requests(cfg, params, rng, label, count=None):
    """ServeEngine(slots=4, max_seq=64) answers LM_SERVE's 8 greedy
    requests (the first ``count`` of them): all done, none truncated."""
    import torch
    from repro_torch.serving import ServeEngine
    reqs = lm_requests(rng, cfg.vocab_size)[:count]
    engine = ServeEngine(cfg, params, slots=LM_SERVE["slots"],
                         max_seq=LM_SERVE["max_seq"])
    t0 = time.perf_counter()
    engine.run(reqs)
    torch.cuda.synchronize()
    res = dict(serve_s=time.perf_counter() - t0,
               serve_tokens={r.request_id: r.output for r in reqs})
    for r in reqs:
        if not (r.done and not r.truncated and
                len(r.output) == LM_SERVE["new_tokens"] and
                all(0 <= x < cfg.vocab_size for x in r.output)):
            raise AssertionError(f"{cfg.name} request {r.request_id}: "
                                 f"done={r.done}, truncated={r.truncated}, "
                                 f"{r.output}")
    log(f"[phase {label}] {cfg.name} ServeEngine(slots={LM_SERVE['slots']}, "
        f"max_seq={LM_SERVE['max_seq']}): {len(reqs)} requests (prompts "
        f"{sorted(len(r.prompt) for r in reqs)} tokens) all done, none "
        f"truncated, {LM_SERVE['new_tokens']} tokens each, in "
        f"{res['serve_s']:.2f} s; request 0 -> {reqs[0].output}")
    return res


def mea_against_sdpa(q, k, v, window, label, card):
    """Phase 9b: ``_mea`` (the chunked online softmax of the prefill from
    S = 2,048 on) against ``_sdpa`` (the whole score matrix) on the same
    causal q, k, v, at the reference's gate MEA_TOL; each one's time, and
    ``F.scaled_dot_product_attention`` of the same function (k and v
    repeated to every query head, the mask given) timed once as a
    yardstick: it is on no path of the port."""
    import torch
    import torch.nn.functional as F
    from repro_torch.nn import attention as A
    b, s, h, hd = q.shape
    mask = A.causal_mask(s, s, window, device=q.device)
    got = A._mea(q, k, v, causal=True, window=window)
    want = A._sdpa(q, k, v, mask)
    torch.cuda.synchronize()
    res = dict(max_abs_err=max_abs_diff(got, want), gate_share=float(
        ((got - want).abs() / (MEA_TOL["atol"] + MEA_TOL["rtol"]
                               * want.abs())).max()))
    torch.testing.assert_close(got, want, **MEA_TOL)
    del got, want
    res["mea_ms"] = time_ms(lambda: A._mea(q, k, v, causal=True,
                                           window=window), reps=3, warmup=1)
    res["sdpa_ms"] = time_ms(lambda: A._sdpa(q, k, v, mask), reps=3,
                             warmup=1)
    group = h // k.shape[2]
    qh = q.transpose(1, 2)
    kh, vh = (t.repeat_interleave(group, dim=2).transpose(1, 2)
              for t in (k, v))

    def library():
        if window is None:
            return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
        return F.scaled_dot_product_attention(qh, kh, vh,
                                              attn_mask=mask[0, 0])
    res["library_ms"] = time_ms(library, reps=3, warmup=1)
    log(f"[phase 9b] {label} (B={b}, S={s}, {h} heads / {k.shape[2]} kv of "
        f"{hd}, window {window}): _mea == _sdpa within {MEA_TOL} (max |diff| "
        f"{res['max_abs_err']:.3g}, {res['gate_share']:.3g} of the gate); "
        f"_mea {res['mea_ms']:.2f} ms, _sdpa {res['sdpa_ms']:.2f} ms, "
        f"F.scaled_dot_product_attention (a yardstick, on no path) "
        f"{res['library_ms']:.2f} ms; {card}")
    return res


def layer0_qkv(params, cfg, tok):
    """Layer 0's roped q, k, v of ``tok``, as its attention computes them."""
    from repro_torch.nn import attention as A
    from repro_torch.nn import transformer as T
    from repro_torch.nn.layers import apply_rope, rmsnorm
    lp = T.layer_params(params["groups"][0], 0)
    x = rmsnorm(lp["norm1"], T.embed_tokens(params, cfg, tok))
    q, k, v = A._project_qkv(lp["attn"], x, cfg.num_heads, cfg.num_kv_heads,
                             cfg.resolved_head_dim)
    pos = T.default_positions(cfg, tok)
    return (apply_rope(q, pos, cfg.rope_base),
            apply_rope(k, pos, cfg.rope_base), v)


def profile_dense_bf16(p16, cfg, batch, decode, cache):
    """Phase 7 for the dense path: one glm4-9b bf16 prefill and one steady
    bf16 decode step — host time, device busy, the idle share, the top
    device operations and attention's share of the busy time. The
    attention core runs the same GEMM and elementwise kernels as the rest
    of the step, so its share is taken from one layer's core (the prefill's
    ``_mea`` on layer 0's q, k, v; the decode step's cache write, mask and
    ``_sdpa`` over the cache) profiled alone, times the layers."""
    import torch
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.nn import attention as A
    prefill = make_prefill_step(cfg)
    out = {}
    w = profiled(lambda: prefill(p16, batch), 1, host=False)
    q, k, v = layer0_qkv(p16, cfg, batch["tokens"])
    core = profiled(lambda: A._mea(q, k, v, causal=True, window=None), 1,
                    host=False)["busy_us"] * cfg.num_layers
    del q, k, v
    top = sorted(w["by_name"].items(), key=lambda kv: -kv[1])[:8]
    out["glm4_prefill_bf16"] = dict(
        step_ms=w["wall_us"] / 1e3, device_ms_per_step=w["busy_us"] / 1e3,
        idle_share=1.0 - w["busy_us"] / w["wall_us"],
        device_events=w["count"], attention_ms=core / 1e3,
        attention_share=core / w["busy_us"],
        top_device_ms_per_step={n: t / 1e3 for n, t in top})
    step, step_batch = decode
    p = step_profile(lambda: step(p16, cache, step_batch))
    kc = cache["groups"][0]["attn"]["k"][0].clone()
    vc = cache["groups"][0]["attn"]["v"][0].clone()
    b, rows, kv, hd = kc.shape
    gen = torch.Generator(device=kc.device).manual_seed(0)
    q1 = torch.randn((b, 1, cfg.num_heads, hd), generator=gen,
                     device=kc.device).to(kc.dtype)
    k1, v1 = (torch.randn((b, 1, kv, hd), generator=gen, device=kc.device)
              .to(kc.dtype) for _ in range(2))
    pos = step_batch["pos"]

    def decode_core():
        A._ring_write(kc, k1, pos)
        A._ring_write(vc, v1, pos)
        valid = A.ring_valid(rows, pos)
        return A._sdpa(q1, kc, vc, valid[:, None, None, :])
    core = profiled(decode_core, 1, host=False)["busy_us"] * cfg.num_layers
    p.update(attention_ms=core / 1e3,
             attention_share=core / 1e3 / p["device_ms_per_step"])
    out["glm4_decode_step_bf16"] = p
    return out


def run_glm4(dev, rng, card):
    """Phase 9a (and 9b at one of its layers): glm4-9b at full width and
    depth, fp32. The prefill at B = 4, S = 2,048 (the _mea branch): its time
    and model-FLOP rate against 67 TFLOP/s; layer 0's attention, _mea
    against _sdpa (9b); a 64-token prompt through decode_step ends at the
    prefill's last logits; a steady decode step against reading the
    weights; ServeEngine answers 8 greedy requests. Then the weights
    rounded to bf16: the bf16 prefill's time against 989 TFLOP/s, the
    prompt through a bf16 decode_step within 2 e_b of the bf16 prefill of
    the prompt and of the fp32 one, e_b the bf16 prefill's own error (its
    largest |bf16 - fp32| logit): phase 8e holds rwkv6-3b's bf16 decode
    within e_b of its bf16 prefill, but glm4-9b's reads 1.03 e_b there
    (0.015625 against 0.01522, NVIDIA H100 80GB HBM3, 700.00 W), its own
    bf16 error being 1.11 e_b: the decode rounds the outputs of 4-row GEMMs
    where the prefill rounds 256-row ones. A bf16 decode step's time. Returns (results, phase 7's
    profiles)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.nn import transformer as T
    cfg = get_arch(DENSE_ARCH)
    params, res = draw_lm(cfg, dev, "9a")
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (DENSE_B, DENSE_S))).to(dev)
    batch = {"tokens": tok}
    tok_b = tok[:, :LM_DECODE_PROMPT].contiguous()
    with torch.inference_mode():
        last, r = timed_prefill(params, cfg, batch, "9a", card)
        res.update(r)
        res["mea_layer0"] = mea_against_sdpa(
            *layer0_qkv(params, cfg, tok), None,
            f"{cfg.name} layer 0's q, k, v", card)
        release()
        r, want = decode_against_prefill(params, cfg, tok_b, "9a", card)
        res.update(r)
    res.update(serve_requests(cfg, params, rng, "9a"))
    p16 = T.map_tree(params, lambda t: t.to(torch.bfloat16))
    with torch.inference_mode():
        last16, r = timed_prefill(p16, cfg, batch, "9a", card, reps=3,
                                  bf16=True)
        res.update({f"bf16_{k}": v for k, v in r.items()})
        if last16.dtype != torch.bfloat16:
            raise AssertionError(f"bf16 prefill logits are {last16.dtype}")
        res["bf16_prefill_vs_fp32"] = max_abs_diff(last16.float(), last)
        res["bf16_prefill_argmax_agree"] = int(
            (last16.argmax(-1) == last.argmax(-1)).sum())
        want16 = make_prefill_step(cfg)(p16, {"tokens": tok_b})
        e_b = max_abs_diff(want16.float(), want)
        got16, cache16 = decode_prompt(p16, cfg, tok_b)
        torch.cuda.synchronize()
        # the two bf16 runs round the outputs of other GEMM shapes (4 rows
        # a step against the prompt's 256), so each carries a bf16 error of
        # its own: they are held within twice the prefill's, as each is
        # held within twice it of the fp32 prefill
        gap = (got16.double() - want16.double()).abs()
        res.update(bf16_decode_ref_err=e_b,
                   bf16_decode_vs_prefill=max_abs_diff(got16.float(),
                                                       want16.float()),
                   bf16_decode_over_ref_err=int((gap > e_b).sum()),
                   bf16_decode_vs_fp32=max_abs_diff(got16.float(), want))
        if not (got16.dtype == torch.bfloat16 and
                res["bf16_decode_vs_prefill"] <= 2 * e_b and
                res["bf16_decode_vs_fp32"] <= 2 * e_b):
            raise AssertionError(
                f"bf16 decode: {got16.dtype}, |decode - bf16 prefill| "
                f"{res['bf16_decode_vs_prefill']}, |decode - fp32| "
                f"{res['bf16_decode_vs_fp32']}, the prefill's bf16 error "
                f"{e_b}")
        step = make_serve_step(cfg)
        step_batch = {"tokens": tok_b[:, -1:],
                      "pos": torch.full((DENSE_B,), LM_DECODE_PROMPT - 1,
                                        device=dev)}
        res["bf16_decode_step_ms"] = time_ms(
            lambda: step(p16, cache16, step_batch), reps=10, warmup=2)
        res["bf16_decode_floor_ms"] = (res["param_bytes"] / 2
                                       / HBM_BYTES_PER_S * 1e3)
        log(f"[phase 9a] bf16: prefill vs the fp32 run "
            f"{res['bf16_prefill_vs_fp32']:.4g} (argmax agrees in "
            f"{res['bf16_prefill_argmax_agree']} of {DENSE_B}); "
            f"{LM_DECODE_PROMPT} tokens through decode_step vs the bf16 "
            f"prefill {res['bf16_decode_vs_prefill']:.4g} <= twice its bf16 "
            f"error {e_b:.4g} (above it at "
            f"{res['bf16_decode_over_ref_err']} of {got16.numel()} logits), "
            f"vs the fp32 prefill {res['bf16_decode_vs_fp32']:.4g} <= "
            f"{2 * e_b:.4g}; a steady bf16 decode step "
            f"{res['bf16_decode_step_ms']:.3f} ms against the "
            f"{res['bf16_decode_floor_ms']:.3f} ms of reading the weights; "
            f"{card}")
        del params, last, want
        release()
        profiles = profile_dense_bf16(p16, cfg, batch, (step, step_batch),
                                      cache16)
    for label, p in profiles.items():
        log(f"[phase 7] {label}: {p['step_ms']:.3f} ms, device busy "
            f"{p['device_ms_per_step']:.3f} ms, idle share "
            f"{p['idle_share']:.3f}, attention core {p['attention_ms']:.3f} "
            f"ms = {p['attention_share']:.3f} of device busy; top "
            f"{p['top_device_ms_per_step']}; {card}")
    return res, profiles


def run_mea_sliding(dev, card):
    """Phase 9b at gemma-2b-sw's head layout (8 heads, kv 1, hd 256), B = 1,
    S = 8,192 with its 4,096-token window, on q, k, v drawn from a CUDA
    generator."""
    import torch
    from repro_torch.configs import get_arch
    cfg = get_arch("gemma-2b-sw")
    gen = torch.Generator(device=dev).manual_seed(0)
    hd = cfg.resolved_head_dim
    q = torch.randn((1, SW_S, cfg.num_heads, hd), generator=gen, device=dev)
    k, v = (torch.randn((1, SW_S, cfg.num_kv_heads, hd), generator=gen,
                        device=dev) for _ in range(2))
    with torch.inference_mode():
        return mea_against_sdpa(q, k, v, cfg.sliding_window,
                                f"{cfg.name}'s head layout", card)


def run_gemma(dev, rng, card):
    """Phase 9c: gemma-2b and gemma-2b-sw at full width and depth, fp32, on
    the same weights. At S = 2,048 the window is not reached: the two
    forwards' logits are bitwise equal. At B = 1, S = 8,192 both are finite,
    the first 4,096 positions' logits bitwise equal (their queries' blocks
    see the same keys) and the rest differ. Then the ring buffer: with the
    window set to 64, a 96-token prompt through decode_step's 64-row cache
    ends at the windowed prefill's last logits within LM_LOGIT_TOL."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.nn import transformer as T
    cfg, sw = get_arch("gemma-2b"), get_arch("gemma-2b-sw")
    params, res = draw_lm(cfg, dev, "9c")
    with torch.inference_mode():
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                            (2, DENSE_S))).to(dev)
        full, full_sw = (T.forward(params, c, tok) for c in (cfg, sw))
        finite_logits(full, (2, DENSE_S, cfg.vocab_size), "gemma-2b")
        if not torch.equal(full, full_sw):
            raise AssertionError(f"gemma-2b-sw at S={DENSE_S} is not gemma-2b "
                                 f"bitwise: {max_abs_diff(full_sw, full)}")
        del full, full_sw
        release()
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                            (1, SW_S))).to(dev)
        full, full_sw = (T.forward(params, c, tok) for c in (cfg, sw))
        for name, x in (("gemma-2b", full), ("gemma-2b-sw", full_sw)):
            finite_logits(x, (1, SW_S, cfg.vocab_size), f"{name} S={SW_S}")
        w = sw.sliding_window
        res.update(long_head_bitwise=bool(torch.equal(full[:, :w],
                                                      full_sw[:, :w])),
                   long_tail_max_abs_diff=max_abs_diff(full[:, w:],
                                                       full_sw[:, w:]))
        if not (res["long_head_bitwise"] and res["long_tail_max_abs_diff"]
                > 0):
            raise AssertionError(f"S={SW_S}: positions below the window "
                                 f"bitwise {res['long_head_bitwise']}, past "
                                 f"it max |diff| "
                                 f"{res['long_tail_max_abs_diff']}")
        del full, full_sw
        release()
        batch = {"tokens": tok}
        res["sw_prefill_ms"] = time_ms(
            lambda: make_prefill_step(sw)(params, batch), reps=2, warmup=1)
        log(f"[phase 9c] gemma-2b-sw == gemma-2b bitwise at B=2, S={DENSE_S} "
            f"(the window not reached); at B=1, S={SW_S} both finite, the "
            f"first {w} positions bitwise, past them max |diff| "
            f"{res['long_tail_max_abs_diff']:.4g}; the windowed prefill "
            f"{res['sw_prefill_ms']:.1f} ms; {card}")
        ring = dataclasses.replace(sw, sliding_window=RING_WINDOW)
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                            (2, RING_PROMPT))).to(dev)
        want = make_prefill_step(ring)(params, {"tokens": tok})
        unwindowed = make_prefill_step(cfg)(params, {"tokens": tok})
        got, cache = decode_prompt(params, ring, tok)
        rows = cache["groups"][0]["attn"]["k"].shape[2]
        res.update(ring_rows=rows, ring_max_abs_diff=max_abs_diff(got, want),
                   ring_window_matters=max_abs_diff(unwindowed, want))
        if rows != RING_WINDOW:
            raise AssertionError(f"the windowed cache has {rows} rows")
        torch.testing.assert_close(got, want, **LM_LOGIT_TOL)
        log(f"[phase 9c] ring buffer: window {RING_WINDOW}, {RING_PROMPT} "
            f"tokens through decode_step's {rows}-row cache == the windowed "
            f"prefill's last logits within {LM_LOGIT_TOL} (max |diff| "
            f"{res['ring_max_abs_diff']:.3g}; the unwindowed prefill is "
            f"{res['ring_window_matters']:.3g} away); {card}")
    del params
    release()
    return res


def run_qwen(dev, rng, card):
    """Phase 9d: qwen3-32b (qk-norm) and qwen2.5-32b (the QKV bias) at full
    width with 8 of their 64 layers (rope_base 1e6): the prefill at B = 1,
    S = 2,048, and a 64-token prompt through decode_step against the
    prefill of that prompt."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    out = {}
    for name in ("qwen3-32b", "qwen2.5-32b"):
        cfg = dataclasses.replace(get_arch(name), num_layers=QWEN_DEPTH)
        params, res = draw_lm(cfg, dev, "9d")
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                            (QWEN_B, QWEN_S))).to(dev)
        with torch.inference_mode():
            _, r = timed_prefill(params, cfg, {"tokens": tok}, "9d", card)
            res.update(r)
            r, _ = decode_against_prefill(
                params, cfg, tok[:, :LM_DECODE_PROMPT].contiguous(), "9d",
                card)
            res.update(r)
        out[name] = res
        del params
        release()
    return out


def run_hybrid(dev, rng, card):
    """Phase 9e: recurrentgemma-9b at full width and depth (12 x (rec, rec,
    attn), then rec, rec; local window 2,048), fp32. The prefill at B = 2,
    S = 4,096, so that the window applies: its time and model-FLOP rate, and
    the RG-LRU scan's share (one layer's ``lru_scan`` at the prefill's
    shape on CUDA events, times the 26 recurrent layers); a 64-token prompt
    through decode_step against the prefill of that prompt; ServeEngine
    answers 8 greedy requests."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.nn import recurrent as rec
    from repro_torch.nn import transformer as T
    cfg = get_arch(HYBRID_ARCH)
    params, res = draw_lm(cfg, dev, "9e")
    n_rec = sum(n * (sum(k == "rec" for k in cfg.hybrid_pattern)
                     if kind == "pattern" else kind == "rec")
                for kind, n, _ in T.stack_plan(cfg))
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (HYBRID_B, HYBRID_S))).to(dev)
    with torch.inference_mode():
        _, r = timed_prefill(params, cfg, {"tokens": tok}, "9e", card,
                             reps=1)
        res.update(r)
        gen = torch.Generator(device=dev).manual_seed(0)
        shape = (HYBRID_B, HYBRID_S, cfg.lru_width)
        a = torch.rand(shape, generator=gen, device=dev)
        v = torch.randn(shape, generator=gen, device=dev)
        res["scan_ms"] = time_ms(lambda: rec.lru_scan(a, v), reps=2,
                                 warmup=1)
        del a, v
        res.update(recurrent_layers=n_rec, scan_share=n_rec * res["scan_ms"]
                   / res["prefill_ms"])
        log(f"[phase 9e] the RG-LRU scan ({HYBRID_S} steps of a (B={HYBRID_B}"
            f", w={cfg.lru_width}) state, two kernels a step): "
            f"{res['scan_ms']:.1f} ms a layer, x {n_rec} recurrent layers = "
            f"{res['scan_share']:.3f} of the prefill's "
            f"{res['prefill_ms']:.1f} ms; {card}")
        r, _ = decode_against_prefill(
            params, cfg, tok[:, :LM_DECODE_PROMPT].contiguous(), "9e", card)
        res.update(r)
    res.update(serve_requests(cfg, params, rng, "9e"))
    del params
    release()
    return res


def run_gemma_train(dev, card):
    """Phase 9f: gemma-2b training at full width and depth, fp32 weights
    drawn on the card (seed 0), remat on (the config's): GEMMA_TRAIN_STEPS
    ``make_train_step`` Adam steps on ``TokenStream`` batches at B = 1,
    S = 2,048, finite losses, each step's time on CUDA events and its
    model-FLOP rate against 67 TFLOP/s, and the peak device memory, under
    the card's 80 GB."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenStream
    from repro_torch.launch.specs import InputShape, model_flops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.nn import transformer as T
    from repro_torch.training.optimizer import adam
    cfg = get_arch("gemma-2b")
    if not cfg.remat:
        raise AssertionError("gemma-2b: remat is off")
    params, res = draw_lm(cfg, dev, "9f")
    optimizer = adam(LM_TRAIN_LR)
    opt_state = optimizer.init(dict(T.leaves(params)))
    step = make_train_step(cfg, optimizer)
    stream = TokenStream(cfg.vocab_size, GEMMA_TRAIN_B, GEMMA_TRAIN_S, seed=0)
    flop = model_flops(cfg, InputShape("train", GEMMA_TRAIN_S,
                                       GEMMA_TRAIN_B, "train"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(GEMMA_TRAIN_STEPS):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in next(stream).items()}
        if i == 0:
            res["argument_bytes"] = step_argument_bytes(params, opt_state,
                                                        batch)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt_state, m = step(params, opt_state, batch)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        steps.append(dict(loss=float(m["loss"]), ms=ms,
                          tflops=flop / ms / 1e9))
        if not np.isfinite(steps[-1]["loss"]):
            raise AssertionError(f"phase 9f step {i}: loss "
                                 f"{steps[-1]['loss']}")
        log(f"[phase 9f] gemma-2b step {i}: loss {steps[-1]['loss']:.6f}, "
            f"{ms:.1f} ms = {steps[-1]['tflops']:.2f} TFLOP/s of model FLOPs "
            f"({flop:.4g} a step), {steps[-1]['tflops'] / 67:.3f} of the 67 "
            f"TFLOP/s fp32 peak; {card}")
    peak = torch.cuda.max_memory_allocated()
    if int(opt_state.step) != GEMMA_TRAIN_STEPS or peak >= CARD_BYTES:
        raise AssertionError(f"phase 9f: optimizer step "
                             f"{int(opt_state.step)}, peak {peak} bytes")
    res.update(steps=steps, flop_per_step=flop, peak_bytes=peak)
    extra = {k: torch.from_numpy(v).to(dev) for k, v in next(stream).items()}
    res["flop_counter"] = counted_flops(lambda: step(params, opt_state,
                                                     extra))
    log(f"[phase 9f] {GEMMA_TRAIN_STEPS} steps at B={GEMMA_TRAIN_B}, "
        f"S={GEMMA_TRAIN_S}: losses {[round(x['loss'], 6) for x in steps]}; "
        f"peak device memory {peak / 1e9:.2f} GB (parameters "
        f"{res['param_bytes'] / 1e9:.2f} GB, with gradients and two moments "
        f"{4 * res['param_bytes'] / 1e9:.2f} GB) of the card's "
        f"{CARD_BYTES / 1e9:.0f} GB; {card}")
    del params, opt_state, step
    release()
    return res


def run_lm9(dev, rng, card):
    """Phase 9, after phase 8f has freed its memory: (a) glm4-9b, (b) _mea
    against _sdpa, (c) gemma-2b and gemma-2b-sw, (d) the two 32B archs at
    depth 8, (e) recurrentgemma-9b, (f) gemma-2b training, each model freed
    before the next is drawn; (g) none of the nine kernels is launched in
    all of it. Returns (results, phase 7's profiles of 9a)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    release()
    reset_counts()
    t0 = time.perf_counter()
    res = {}
    res["glm4"], profiles = run_glm4(dev, rng, card)
    release()
    res["mea_sliding"] = run_mea_sliding(dev, card)
    release()
    res["gemma"] = run_gemma(dev, rng, card)
    res["qwen"] = run_qwen(dev, rng, card)
    res["hybrid"] = run_hybrid(dev, rng, card)
    res["gemma_train"] = run_gemma_train(dev, card)
    counts = launch_counts()
    if any(counts.values()):
        raise AssertionError(f"phase 9 launched kernels: {counts}")
    res.update(launches=counts, seconds=time.perf_counter() - t0)
    log(f"[phase 9g] no kernel launched in phase 9 ({res['seconds']:.1f} s): "
        f"{counts}")
    return res, profiles


# ---------------------------------------------------------------------- #
# phase 10: the MoE family; phase 11: the multimodal backbones
# ---------------------------------------------------------------------- #
def counted(fn):
    """``fn()`` and the kernel launches it made, read as the difference of
    the counts around it (the phase's own counts keep running)."""
    import torch
    before = launch_counts()
    out = fn()
    torch.cuda.synchronize()
    after = launch_counts()
    return out, {n: after[n] - before[n] for n in after}


def moe_layers(cfg):
    return cfg.num_layers - cfg.first_k_dense


def check_topk_launches(launches, cfg, what):
    """One ``topk_scores`` launch a MoE layer, and no other kernel."""
    want = {n: (moe_layers(cfg) if n == "topk" else 0) for n in launches}
    if launches != want:
        raise AssertionError(f"{cfg.name} {what}: launches {launches}, "
                             f"expected {want}")


@contextlib.contextmanager
def routed(pick):
    """Each MoE call's experts replaced by ``pick(call, idx)`` (``call``
    counts the MoE calls from 0, ``idx`` the router's own top-k) while the
    block runs, the weights gathered from the call's probabilities and
    renormalized as the router does; the router's top-k kernel still
    runs."""
    import torch
    from repro_torch.nn import moe as M
    route = M._route
    calls = iter(range(1 << 62))

    def pinned(p, x, top_k):
        probs, _, idx = route(p, x, top_k)
        idx = pick(next(calls), idx)
        vals = torch.gather(probs, -1, idx)
        return probs, vals / vals.sum(-1, keepdim=True), idx
    M._route = pinned
    try:
        yield
    finally:
        M._route = route


def expert_loads(record, num_experts):
    """``routed`` that keeps each MoE call's experts and appends its
    largest expert load (the pairs routed to one expert) to ``record``."""
    import torch
    return routed(lambda i, idx: record.append(int(torch.bincount(
        idx.reshape(-1), minlength=num_experts).max())) or idx)


@contextlib.contextmanager
def router_inputs(keep):
    """Each MoE call's router probabilities ``(T, E)`` handed to
    ``keep(probs, k)`` as they reach ``topk_padded``, which then runs on
    them as before (its launches are counted as the path's own)."""
    from repro_torch.nn import moe as M
    topk = M.topk_padded

    def recording(probs, k):
        keep(probs, k)
        return topk(probs, k)
    M.topk_padded = recording
    try:
        yield
    finally:
        M.topk_padded = topk


def flip_gaps(idx32, idx16, p32, p16, k):
    """The tokens whose expert sets differ between two runs of one MoE
    layer (``idx`` ``(T, k)``, router probabilities ``p`` ``(T, E)``):
    for each, the fp32 run's gap between its k-th and (k+1)-th
    probability, the same gap in log-probability (= in logits), and the
    spread (largest minus smallest) over its experts of the change in
    log-probability from the fp32 run to the other, which is the change
    in the logits up to the row's constant. An expert a of the fp32 set
    gives way to an expert b only if the logits' change lifts b over a:
    ``log_gap <= spread``, whatever the cause of the change."""
    import torch
    flips = (idx32.sort(-1).values != idx16.sort(-1).values).any(-1)
    top = p32.sort(-1, descending=True).values
    l32, l16 = p32.double().log(), p16.double().log()
    delta = l16 - l32
    spread = delta.max(-1).values - delta.min(-1).values
    ranked = l32.sort(-1, descending=True).values
    log_gap = ranked[:, k - 1] - ranked[:, k]
    rel = spread / (l32.max(-1).values - l32.min(-1).values)
    return dict(tokens=int(flips.sum()),
                prob_gap=(top[:, k - 1] - top[:, k])[flips].tolist(),
                log_gap=log_gap[flips].tolist(),
                spread=spread[flips].tolist(),
                median_log_gap_all=float(log_gap.median()),
                largest_spread_all=float(spread.max()),
                largest_relative_spread=float(rel.max()))


def flipped(routes, want):
    """Tokens whose expert set differs from ``want``'s, per MoE layer."""
    return [int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
            for a, b in zip(routes, want)]


def ample_capacity(cfg, params, batch, label, card):
    """Capacity dispatch with room for every pair against dense dispatch's
    last logits: the factor from the config's-factor run's largest expert
    load, ``CAPACITY_ROOM`` times over, and every MoE call of the ample run
    checked to have dropped nothing."""
    import dataclasses
    import torch
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.nn import moe as M
    b, s = batch["tokens"].shape
    t, k, e = b * s, cfg.top_k, cfg.num_experts
    loads = []
    with expert_loads(loads, e):
        make_prefill_step(dataclasses.replace(cfg, moe_dispatch="capacity"))(
            params, batch)
    factor = CAPACITY_ROOM * max(loads) * e / (t * k)
    ample = dataclasses.replace(cfg, moe_dispatch="capacity",
                                moe_capacity_factor=factor)
    cap = M.capacity(t, k, e, factor)
    loads_ample = []
    with expert_loads(loads_ample, e):
        got = make_prefill_step(ample)(params, batch)
    if max(loads_ample) > cap or len(loads_ample) != moe_layers(cfg):
        raise AssertionError(f"{label}: the ample run dropped pairs (loads "
                             f"{loads_ample}, capacity {cap})")
    res = dict(capacity_loads_1_25=loads, ample_factor=factor,
               ample_capacity=cap, ample_loads=loads_ample,
               default_capacity=M.capacity(t, k, e, cfg.moe_capacity_factor))
    return got, res


def run_deepseek(dev, rng, card):
    """Phase 10 (a)-(c): deepseek-v2-lite-16b at full width and depth.
    (a) fp32, dense dispatch: the prefill at B = 1, S = 2,048 (its time,
    model-FLOP rate against 67 TFLOP/s, peak memory; 26 topk launches); a
    64-token prompt at B = 4 through decode_step ends at the prefill's
    last logits within LM_LOGIT_TOL; a steady decode step (26 topk
    launches) against reading the weights; ServeEngine answers 8 greedy
    requests. (b) the same weights under capacity dispatch: at the
    config's factor 1.25 the prefill's time and two prefills bitwise; with
    room for every pair (ample_capacity) within LM_LOGIT_TOL of (a)'s
    dense prefill. (c) the fp32 tree freed, the bf16 tree drawn from the
    same generator (routers fp32): the bf16 prefill's time against 989
    TFLOP/s; the prompt through a bf16 decode_step within twice the bf16
    prefill's own error (e_b, its largest |bf16 - fp32| logit) of the bf16
    prefill and of the fp32 one, as phase 9a holds glm4-9b, with every run
    on the fp32 prefill's experts (``routed``): in bf16 the randomly drawn
    routers' near-ties pick other experts at up to half of the tokens of
    a layer (NVIDIA H100 80GB HBM3, 700.00 W: 5 to 126 of 256 in the bf16
    prefill, 7 to 138 in the bf16 decode, against the fp32 prefill), so
    that two bf16 runs with free routing differ by which experts they took
    (the free runs' differences are printed beside the flips); in the
    first MoE layer of the free bf16 prefill and decode, each token that
    takes other experts than the fp32 prefill has its k-th minus (k+1)-th
    gap within the change of its router logits, and that change is
    bf16-sized (``flip_gaps``, BF16_ROUTER_SPREAD); a bf16
    decode step's
    time; phase 7's profile of the bf16 prefill with the dense dispatch's
    experts' share (one MoE layer's experts and combine profiled alone,
    times the 26 layers)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.nn import moe as M
    from repro_torch.nn import transformer as T
    cfg = get_arch(MOE_ARCH)
    params, res = draw_lm(cfg, dev, "10a")
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (MOE_B, MOE_S))).to(dev)
    batch = {"tokens": tok}
    tok_b = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (LM_B, LM_DECODE_PROMPT))).to(dev)
    prefill = make_prefill_step(cfg)
    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats()
        last, launches = counted(lambda: prefill(params, batch))
        check_topk_launches(launches, cfg, "prefill")
        finite_logits(last, (MOE_B, cfg.vocab_size), "10a prefill")
        res["prefill_launches"] = launches
        _, r = timed_prefill(params, cfg, batch, "10a", card)
        res.update(r)
        release()
        r, want = decode_against_prefill(params, cfg, tok_b, "10a", card)
        res.update(r)
        routes32, probs32 = [], []   # the fp32 prefill's experts, probs
        with routed(lambda i, idx: routes32.append(idx) or idx), \
                router_inputs(lambda p, k: probs32.append(p.clone())):
            make_prefill_step(cfg)(params, {"tokens": tok_b})
        cache = T.init_decode_cache(cfg, LM_B, 8, device=dev,
                                    dtype=torch.float32)
        step = make_serve_step(cfg)
        _, launches = counted(lambda: step(params, cache, {
            "tokens": tok_b[:, :1],
            "pos": torch.zeros(LM_B, dtype=torch.long, device=dev)}))
        check_topk_launches(launches, cfg, "decode step")
        res["decode_step_launches"] = launches
        log(f"[phase 10a] topk_scores launches: {launches['topk']} per "
            f"decode step and {res['prefill_launches']['topk']} per prefill "
            f"({moe_layers(cfg)} MoE layers), no other kernel")
    res.update(serve_requests(cfg, params, rng, "10a"))
    with torch.inference_mode():
        cap = dataclasses.replace(cfg, moe_dispatch="capacity")
        first = make_prefill_step(cap)(params, batch)
        again = make_prefill_step(cap)(params, batch)
        res.update(capacity_bitwise=bool(torch.equal(first, again)),
                   capacity_vs_dense=max_abs_diff(first, last),
                   capacity_prefill_ms=time_ms(
                       lambda: make_prefill_step(cap)(params, batch), reps=2,
                       warmup=0))
        if not res["capacity_bitwise"]:
            raise AssertionError(f"10b: two capacity prefills differ by "
                                 f"{max_abs_diff(first, again)}")
        del first, again
        got, r = ample_capacity(cfg, params, batch, "10b", card)
        res.update(r)
        res["dropping_layers"] = sum(load > res["default_capacity"]
                                     for load in res["capacity_loads_1_25"])
        res["ample_vs_dense"] = max_abs_diff(got, last)
        torch.testing.assert_close(got, last, **LM_LOGIT_TOL)
        log(f"[phase 10b] capacity dispatch, factor "
            f"{cfg.moe_capacity_factor} ({res['default_capacity']} slots an "
            f"expert; largest loads {max(res['capacity_loads_1_25'])}): "
            f"prefill {res['capacity_prefill_ms']:.1f} ms against dense "
            f"dispatch's {res['prefill_ms']:.1f} ms, two prefills bitwise "
            f"equal, {res['capacity_vs_dense']:.4g} from dense (pairs "
            f"dropped in {res['dropping_layers']} of "
            f"{len(res['capacity_loads_1_25'])} layers); factor "
            f"{res['ample_factor']:.3f} ({res['ample_capacity']} slots, "
            f"nothing dropped in any of {len(res['ample_loads'])} layers) "
            f"== dense within {LM_LOGIT_TOL} (max |diff| "
            f"{res['ample_vs_dense']:.3g}); {card}")
        del got, last
    del params, cache
    release()
    p16, r = draw_lm(cfg, dev, "10c", bf16=True)
    res["bf16_param_bytes"] = r["param_bytes"]
    routers = {t.dtype for n, t in T.leaves(p16) if n.endswith(".router")}
    if routers != {torch.float32}:
        raise AssertionError(f"bf16 tree's routers are {routers}")
    with torch.inference_mode():
        last16, r = timed_prefill(p16, cfg, batch, "10c", card, reps=3,
                                  bf16=True)
        res.update({f"bf16_{k}": v for k, v in r.items()})
        del last16
        # free routing: every bf16 run picks its own experts
        n = moe_layers(cfg)
        free = {"prefill": [], "decode": []}
        free_p = {"prefill": [], "decode": []}
        with routed(lambda i, idx: free["prefill"].append(idx) or idx), \
                router_inputs(lambda p, k: free_p["prefill"].append(p.clone())):
            want16 = make_prefill_step(cfg)(p16, {"tokens": tok_b})
        with routed(lambda i, idx: free["decode"].append(idx) or idx), \
                router_inputs(lambda p, k: free_p["decode"].append(p.clone())):
            got16, _ = decode_prompt(p16, cfg, tok_b)

        def by_layer(calls, layer):   # the decode's calls, prompt order
            return torch.stack(calls[layer::n], 1).reshape(
                LM_B * LM_DECODE_PROMPT, -1)
        steps = [by_layer(free["decode"], layer) for layer in range(n)]
        # the first MoE layer's flips against the fp32 prefill: each one's
        # gap between the k-th and (k+1)-th expert, against the change in
        # its router logits in that run
        gaps = {"prefill": flip_gaps(routes32[0], free["prefill"][0],
                                     probs32[0], free_p["prefill"][0],
                                     cfg.top_k),
                "decode": flip_gaps(routes32[0], steps[0], probs32[0],
                                    by_layer(free_p["decode"], 0),
                                    cfg.top_k)}
        del free_p
        res["bf16_first_layer_flips"] = gaps
        for run, g in gaps.items():
            wide = [(a, b) for a, b in zip(g["log_gap"], g["spread"])
                    if a > b + ROUTER_LOG_SLACK]
            if wide or g["largest_relative_spread"] > BF16_ROUTER_SPREAD:
                raise AssertionError(
                    f"10c bf16 {run}, first MoE layer: flips whose gap "
                    f"exceeds the logits' change {wide}, or a change "
                    f"{g['largest_relative_spread']} of the logits' range "
                    f"above {BF16_ROUTER_SPREAD}")
            log(f"[phase 10c] bf16 {run}, first MoE layer: {g['tokens']} of "
                f"{LM_B * LM_DECODE_PROMPT} tokens take other experts than "
                f"the fp32 prefill; their k-th minus (k+1)-th probability "
                f"gaps {[float(f'{x:.3g}') for x in g['prob_gap']]} (log "
                f"{[float(f'{x:.3g}') for x in g['log_gap']]}) each <= the "
                f"change of their logits' spread "
                f"{[float(f'{x:.3g}') for x in g['spread']]}; every token's "
                f"median log gap {g['median_log_gap_all']:.4g}, the largest "
                f"change {g['largest_spread_all']:.4g} = "
                f"{g['largest_relative_spread']:.4g} of its logits' range "
                f"(<= {BF16_ROUTER_SPREAD}); {card}")
        res.update(
            bf16_free_ref_err=max_abs_diff(want16.float(), want),
            bf16_free_decode_vs_prefill=max_abs_diff(got16.float(),
                                                     want16.float()),
            bf16_free_decode_vs_fp32=max_abs_diff(got16.float(), want),
            bf16_prefill_flips=flipped(free["prefill"], routes32),
            bf16_decode_flips=flipped(steps, routes32))
        # pinned routing: every run takes the fp32 prefill's experts, so
        # that what is compared is the arithmetic in bf16
        with routed(lambda i, idx: routes32[i]):
            want16 = make_prefill_step(cfg)(p16, {"tokens": tok_b})
        with routed(lambda i, idx: routes32[i % n].reshape(
                LM_B, LM_DECODE_PROMPT, -1)[:, i // n]):
            got16, cache16 = decode_prompt(p16, cfg, tok_b)
        e_b = max_abs_diff(want16.float(), want)
        res.update(bf16_decode_ref_err=e_b,
                   bf16_decode_vs_prefill=max_abs_diff(got16.float(),
                                                       want16.float()),
                   bf16_decode_vs_fp32=max_abs_diff(got16.float(), want))
        if not (got16.dtype == torch.bfloat16 and
                res["bf16_decode_vs_prefill"] <= 2 * e_b and
                res["bf16_decode_vs_fp32"] <= 2 * e_b):
            raise AssertionError(f"10c bf16 decode: {got16.dtype}, "
                                 f"{res['bf16_decode_vs_prefill']}, "
                                 f"{res['bf16_decode_vs_fp32']}, e_b {e_b}")
        log(f"[phase 10c] bf16 routing: of the prompt's "
            f"{LM_B * LM_DECODE_PROMPT} tokens, the bf16 prefill picks "
            f"other experts than the fp32 prefill at "
            f"{res['bf16_prefill_flips']} a MoE layer and the bf16 decode "
            f"at {res['bf16_decode_flips']}; with the "
            f"experts free, bf16 decode vs the bf16 prefill "
            f"{res['bf16_free_decode_vs_prefill']:.4g}, vs the fp32 prefill "
            f"{res['bf16_free_decode_vs_fp32']:.4g}, the bf16 prefill's own "
            f"error {res['bf16_free_ref_err']:.4g}; {card}")
        step_batch = {"tokens": tok_b[:, -1:],
                      "pos": torch.full((LM_B,), LM_DECODE_PROMPT - 1,
                                        device=dev)}
        res["bf16_decode_step_ms"] = time_ms(
            lambda: step(p16, cache16, step_batch), reps=10, warmup=2)
        res["bf16_decode_floor_ms"] = (res["bf16_param_bytes"]
                                       / HBM_BYTES_PER_S * 1e3)
        log(f"[phase 10c] bf16, every run on the fp32 prefill's experts: "
            f"{LM_DECODE_PROMPT} tokens through decode_step vs the bf16 prefill "
            f"{res['bf16_decode_vs_prefill']:.4g}, vs the fp32 prefill "
            f"{res['bf16_decode_vs_fp32']:.4g}, each <= twice the bf16 "
            f"prefill's own error {e_b:.4g}; a steady bf16 decode step "
            f"{res['bf16_decode_step_ms']:.3f} ms against the "
            f"{res['bf16_decode_floor_ms']:.3f} ms of reading the weights; "
            f"{card}")
        del cache16
        w = profiled(lambda: prefill(p16, batch), 1, host=False)
        lp = T.layer_params(p16["groups"][1], 0)["moe"]
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn((MOE_B * MOE_S, cfg.d_model), generator=gen,
                        device=dev).to(torch.bfloat16)
        combine = torch.rand((MOE_B * MOE_S, cfg.num_experts), generator=gen,
                             device=dev).to(torch.bfloat16)

        def experts():
            y = M._experts(lp, x[None], cfg.mlp_act)
            return torch.einsum("etd,te->td", y, combine)
        core = profiled(experts, 1, host=False)["busy_us"] * moe_layers(cfg)
    top = sorted(w["by_name"].items(), key=lambda kv: -kv[1])[:8]
    profile = dict(step_ms=w["wall_us"] / 1e3,
                   device_ms_per_step=w["busy_us"] / 1e3,
                   idle_share=1.0 - w["busy_us"] / w["wall_us"],
                   device_events=w["count"], experts_ms=core / 1e3,
                   experts_share=core / w["busy_us"],
                   top_device_ms_per_step={n: t / 1e3 for n, t in top})
    log(f"[phase 7] {cfg.name} bf16 prefill (B={MOE_B}, S={MOE_S}): "
        f"{profile['step_ms']:.1f} ms, device busy "
        f"{profile['device_ms_per_step']:.1f} ms, idle share "
        f"{profile['idle_share']:.3f}; dense dispatch's experts and combine "
        f"{profile['experts_ms']:.1f} ms = {profile['experts_share']:.3f} of "
        f"device busy ({moe_layers(cfg)} layers x one layer alone); top "
        f"{profile['top_device_ms_per_step']}; {card}")
    del p16
    release()
    return res, profile


def run_arctic(dev, rng, card):
    """Phase 10 (d): arctic-480b at full width; every layer is an MoE
    layer, so its depth is cut. 1 of 35 layers in fp32: the prefill at
    B = 1, S = 1,024 (time; 1 topk launch); a 64-token prompt through
    decode_step == the prefill within LM_LOGIT_TOL; capacity dispatch with
    room for every pair == dense dispatch. Then 2 layers in bf16 (routers
    fp32): the prefill's time, a decode step at B = 4 against reading the
    weights, ServeEngine answers 4 requests."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import make_prefill_step
    base = get_arch(ARCTIC_ARCH)
    out = {}
    for depth, bf16 in ((ARCTIC_DEPTH_FP32, False), (ARCTIC_DEPTH_BF16, True)):
        cfg = dataclasses.replace(base, num_layers=depth)
        label = f"10d {depth} of {base.num_layers} layers"
        params, res = draw_lm(cfg, dev, label, bf16=bf16)
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                            (1, ARCTIC_S))).to(dev)
        batch = {"tokens": tok}
        tok_b = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (LM_B, LM_DECODE_PROMPT))).to(dev)
        with torch.inference_mode():
            last, launches = counted(
                lambda: make_prefill_step(cfg)(params, batch))
            check_topk_launches(launches, cfg, f"{label} prefill")
            _, r = timed_prefill(params, cfg, batch, label, card, bf16=bf16)
            res.update(r)
            release()
            if bf16:
                from repro_torch.launch.steps import make_serve_step
                from repro_torch.nn import transformer as T
                cache = T.init_decode_cache(cfg, LM_B, LM_DECODE_PROMPT,
                                            device=dev, dtype=torch.bfloat16)
                step = make_serve_step(cfg)
                step_batch = {"tokens": tok_b[:, :1],
                              "pos": torch.zeros(LM_B, dtype=torch.long, device=dev)}
                res["decode_step_ms"] = time_ms(
                    lambda: step(params, cache, step_batch), reps=10,
                    warmup=2)
                res["decode_floor_ms"] = (res["param_bytes"]
                                          / HBM_BYTES_PER_S * 1e3)
                log(f"[phase {label}] bf16 decode step at B={LM_B}: "
                    f"{res['decode_step_ms']:.3f} ms against the "
                    f"{res['decode_floor_ms']:.3f} ms of reading "
                    f"{res['param_bytes'] / 1e9:.2f} GB of weights; {card}")
                del cache
            else:
                r, _ = decode_against_prefill(params, cfg, tok_b, label,
                                              card)
                res.update(r)
                got, r = ample_capacity(cfg, params, batch, label, card)
                res.update(r)
                res["ample_vs_dense"] = max_abs_diff(got, last)
                torch.testing.assert_close(got, last, **LM_LOGIT_TOL)
                log(f"[phase {label}] capacity dispatch, factor "
                    f"{res['ample_factor']:.3f} ({res['ample_capacity']} "
                    f"slots an expert, largest loads {res['ample_loads']}) "
                    f"== dense dispatch within {LM_LOGIT_TOL} (max |diff| "
                    f"{res['ample_vs_dense']:.3g}); {card}")
                del got
            del last
        if bf16:
            res.update(serve_requests(cfg, params, rng, label,
                                      ARCTIC_REQUESTS))
        out[f"depth_{depth}_{'bf16' if bf16 else 'fp32'}"] = res
        del params
        release()
    return out


def run_moe_train(dev, card):
    """Phase 10 (e): deepseek-v2-lite-16b training at full width, its dense
    layer and one MoE layer, fp32 weights drawn on the card (seed 0), remat
    on: MOE_TRAIN_STEPS ``make_train_step`` Adam steps on ``TokenStream``
    batches at B = 1, S = 1,024: finite losses, ``moe_aux`` finite and above
    0, a non-zero router gradient (one ``loss_and_grads`` of the first
    batch), each step's time on CUDA events and the peak device memory."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenStream
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.nn import transformer as T
    from repro_torch.training.optimizer import adam
    cfg = dataclasses.replace(get_arch(MOE_ARCH), num_layers=MOE_TRAIN_DEPTH)
    if not cfg.remat:
        raise AssertionError(f"{cfg.name}: remat is off")
    params, res = draw_lm(cfg, dev, "10e")
    stream = TokenStream(cfg.vocab_size, MOE_TRAIN_B, MOE_TRAIN_S, seed=0)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in next(stream).items()}
               for _ in range(MOE_TRAIN_STEPS)]
    _, aux, grads = loss_and_grads(params, cfg, batches[0])
    router = [g for n, g in grads.items() if n.endswith(".router")]
    res["router_grad_max"] = max(float(g.abs().max()) for g in router)
    del grads
    if not (len(router) == 1 and res["router_grad_max"] > 0):
        raise AssertionError(f"10e router gradients: {len(router)} leaves, "
                             f"largest |g| {res['router_grad_max']}")
    optimizer = adam(LM_TRAIN_LR)
    opt_state = optimizer.init(dict(T.leaves(params)))
    step = make_train_step(cfg, optimizer)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i, batch in enumerate(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt_state, m = step(params, opt_state, batch)
        end.record()
        end.synchronize()
        steps.append(dict(loss=float(m["loss"]), moe_aux=float(m["moe_aux"]),
                          ms=start.elapsed_time(end)))
        if not (np.isfinite(steps[-1]["loss"]) and
                np.isfinite(steps[-1]["moe_aux"]) and
                steps[-1]["moe_aux"] > 0):
            raise AssertionError(f"10e step {i}: {steps[-1]}")
    peak = torch.cuda.max_memory_allocated()
    if int(opt_state.step) != MOE_TRAIN_STEPS or peak >= CARD_BYTES:
        raise AssertionError(f"10e: optimizer step {int(opt_state.step)}, "
                             f"peak {peak} bytes")
    res.update(steps=steps, peak_bytes=peak)
    log(f"[phase 10e] {cfg.name}, {MOE_TRAIN_DEPTH} of 27 layers (dense + "
        f"MoE), fp32, remat on, B={MOE_TRAIN_B}, S={MOE_TRAIN_S}: losses "
        f"{[round(x['loss'], 6) for x in steps]}, moe_aux "
        f"{[round(x['moe_aux'], 6) for x in steps]}, step times "
        f"{[round(x['ms'], 1) for x in steps]} ms; the router's gradient "
        f"non-zero (largest |g| {res['router_grad_max']:.3g}); peak device "
        f"memory {peak / 1e9:.2f} GB; {card}")
    del params, opt_state, step
    release()
    return res


def router_topk(inputs, card):
    """Row 7 (topk_scores) on the MoE path's own router probabilities:
    ``inputs`` maps each (T, E, k) that phase 10 gave ``topk_padded`` to
    the first probabilities it saw there (deepseek's prefill, prompt,
    training and B = 4 decode rows at E 64, k 6; arctic's at E 128, k 2,
    which take the kernel's other template). At each shape: the kernel
    against topk_plain (values bitwise, indices ==), each timed beside
    torch.topk, with the byte bound (the probabilities read once, the
    values and int64 indices written once). Run after phase 10's counts
    are read: these launches are on no path."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import topk as K
    want = set()
    for name, rows in ((MOE_ARCH, MOE_B * MOE_S), (ARCTIC_ARCH, ARCTIC_S)):
        cfg = get_arch(name)
        want |= {(t, cfg.num_experts, cfg.top_k) for t in (rows, LM_B)}
    if not want <= set(inputs):
        raise AssertionError(f"router shapes {sorted(want - set(inputs))} "
                             f"never reached topk_padded in phase 10")
    out = {}
    with torch.inference_mode():
        for (t, e, k), probs in sorted(inputs.items()):
            label = f"T {t} x E {e}, k {k}"
            if not same_topk(K.topk_scores(probs, k), K.topk_plain(probs, k)):
                raise AssertionError(f"topk_scores at the router's shape "
                                     f"{label} differs from topk_plain")
            b_ms, b_by = bound_ms(K.topk_scores_bytes(t, e, k),
                                  K.topk_scores_ops(t, e))
            res = out[label] = dict(
                bound_ms=b_ms, bound_by=b_by,
                ms=time_ms(lambda: K.topk_scores(probs, k)),
                plain_ms=time_ms(lambda: K.topk_plain(probs, k)),
                library_ms=time_ms(lambda: torch.topk(probs, k)))
            log(f"[phase 10] topk_scores on the router's probabilities "
                f"({label}): == topk_plain; {res['ms']:.4f} ms (CUDA events, "
                f"one call), plain {res['plain_ms']:.4f} ms, torch.topk "
                f"{res['library_ms']:.4f} ms, bound {b_ms:.5f} ms ({b_by}); "
                f"{card}")
    return out


def run_lm10(dev, rng, card):
    """Phase 10, after phase 9 has freed its memory: (a)-(c) deepseek, (d)
    arctic, (e) MoE training; topk_scores the only kernel launched. Then
    topk_scores against topk_plain and timed on the router probabilities
    of every shape the phase gave it (``router_topk``)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    release()
    reset_counts()
    t0 = time.perf_counter()
    res, inputs = {}, {}
    with router_inputs(lambda p, k: inputs.setdefault(
            (*p.shape, k), p.detach().clone())):
        res["deepseek"], profile = run_deepseek(dev, rng, card)
        res["arctic"] = run_arctic(dev, rng, card)
        res["train"] = run_moe_train(dev, card)
    counts = launch_counts()
    if counts["topk"] == 0 or any(v for n, v in counts.items()
                                  if n != "topk"):
        raise AssertionError(f"phase 10 launches: {counts}")
    res.update(launches=counts, seconds=time.perf_counter() - t0)
    log(f"[phase 10] {res['seconds']:.1f} s; launches {counts}")
    res["router_topk"] = router_topk(inputs, card)
    return res, profile


def run_whisper(dev, rng, card):
    """Phase 11 (a): whisper-large-v3 at full width and depth, fp32. The
    prefill at B = 4, S = 448 over frame embeddings (4, 1,500, 1,280) drawn
    from the seed: its time; a 64-token prompt through decode_step, with
    the cache's encoder_out the encoder's output of the same frames, ==
    the prefill within LM_LOGIT_TOL, once recomputing the cross k and v
    each step and once with them cached (cache_cross_kv); ServeEngine
    answers 8 requests (zero frames, the reference's serving)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    cfg = get_arch(WHISPER_ARCH)
    params, res = draw_lm(cfg, dev, "11a")
    gen = torch.Generator(device=dev).manual_seed(0)
    frames = torch.randn((WHISPER_B, cfg.encoder_frames, cfg.d_model),
                         generator=gen, device=dev)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (WHISPER_B, WHISPER_S))).to(dev)
    with torch.inference_mode():
        _, r = timed_prefill(params, cfg, {"tokens": tok,
                                           "audio_frames": frames},
                             "11a", card)
        res.update(r)
        tok_b = tok[:, :LM_DECODE_PROMPT].contiguous()
        for c, label in ((cfg, "recomputed"),
                         (dataclasses.replace(cfg, cache_cross_kv=True),
                          "cached")):
            r, _ = decode_against_prefill(params, c, tok_b,
                                          f"11a cross k, v {label}", card,
                                          audio_frames=frames)
            res[f"cross_kv_{label}"] = r
    res.update(serve_requests(cfg, params, rng, "11a"))
    del params, frames
    release()
    return res


def run_vlm(dev, rng, card):
    """Phase 11 (b): qwen2-vl-7b at full width and depth, fp32. The prefill
    at B = 2, S = 2,048 with vision embeddings drawn from the seed and 3-D
    positions (time, then a 32-wide grid's row and column: M-RoPE on
    _mea): its time and model-FLOP rate against 67 TFLOP/s; a 64-token
    prompt through decode_step at positions_3d = t == the prefill (default
    positions) within LM_LOGIT_TOL; ServeEngine answers 8 requests."""
    import torch
    from repro_torch.configs import get_arch
    cfg = get_arch(VLM_ARCH)
    params, res = draw_lm(cfg, dev, "11b")
    gen = torch.Generator(device=dev).manual_seed(0)
    vision = 0.5 * torch.randn((VLM_B, VLM_S, cfg.vision_dim), generator=gen,
                               device=dev)
    t = torch.arange(VLM_S, device=dev)
    positions = torch.stack([t, t // 32, t % 32], -1)[None].expand(
        VLM_B, VLM_S, 3)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (VLM_B, VLM_S))).to(dev)
    with torch.inference_mode():
        _, r = timed_prefill(params, cfg, {"tokens": tok,
                                           "vision_embeds": vision,
                                           "positions": positions},
                             "11b", card)
        res.update(r)
        release()
        r, _ = decode_against_prefill(
            params, cfg, tok[:LM_B, :LM_DECODE_PROMPT].contiguous(), "11b",
            card)
        res.update(r)
    res.update(serve_requests(cfg, params, rng, "11b"))
    del params, vision
    release()
    return res


def run_lm11(dev, rng, card):
    """Phase 11, after phase 10 has freed its memory: (a) whisper, (b)
    qwen2-vl; (c) no kernel launched."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    release()
    reset_counts()
    t0 = time.perf_counter()
    res = {"whisper": run_whisper(dev, rng, card),
           "vlm": run_vlm(dev, rng, card)}
    counts = launch_counts()
    if any(counts.values()):
        raise AssertionError(f"phase 11 launched kernels: {counts}")
    res.update(launches=counts, seconds=time.perf_counter() - t0)
    log(f"[phase 11c] no kernel launched in phase 11 ({res['seconds']:.1f} "
        f"s): {counts}")
    return res


# ---------------------------------------------------------------------- #
# phase 12: the RGAT encoder; phase 13: the dry run against the card
# ---------------------------------------------------------------------- #
RGAT_REL_DIMS = 16
RGAT_TOL = dict(rtol=1e-4, atol=1e-5)   # tests/test_torch_rgat.py's
# every gradient leaf in relative L2 norm, as phase 8f holds its leaves:
# the weight gradients sum all 13,760 vertices' rows in other orders on
# the card and the CPU (fp32 GEMMs), which RGAT_TOL, set at the tests' 150
# vertices, does not cover elementwise; a wrong term moves a leaf by O(1)
RGAT_GRAD_REL_L2 = 1e-4
# launches of one encode + backward of a 2-layer RGAT (models/rgat.py): a
# layer's two segment sums (the softmax's denominator, the aggregation)
# run the segment_sum kernel, and its four gathers with a gradient (W h at
# the heads and the tails, the relation features, the denominator at the
# heads) each one scatter_add_onehot in the backward; the gathers' forward
# is index_select and the segment sums' backward a gather, no kernel
RGAT_LAUNCHES = {"segment_sum": 4, "scatter_add_onehot": 8}


def rgat_run(params, cfg, x, edges, proj, plans):
    """One encode and the gradient of ``sum(h * proj)``: ``[h, every layer
    leaf's gradient (in tree order), x's gradient]``."""
    import torch
    from repro_torch.models import rgat_encode
    live = {"layers": [{k: v.detach().clone().requires_grad_()
                        for k, v in lp.items()} for lp in params["layers"]]}
    xl = x.detach().clone().requires_grad_()
    h = rgat_encode(live, cfg, xl, *edges, plans=plans)
    (h * proj).sum().backward()
    return [h.detach()] + [v.grad for lp in live["layers"]
                           for v in lp.values()] + [xl.grad]


def run_rgat(dev, part, card):
    """Phase 12: the RGAT encoder (models/rgat.py) on the card at the
    training phases' width: phase 2's partition 0 of the FB15k-237
    stand-in (scale 1.0, 4 trainers, V 13,760, E 377,984), d 75, 16
    relation dims, 2 layers, weights drawn on the host from seed 0 and
    handed to both devices through the converter. The encode and the
    gradient of a fixed random projection of its output: (a) the card
    against the plain CPU run, the encode within the CPU parity test's
    tolerance and every gradient leaf within RGAT_GRAD_REL_L2 in relative
    L2 norm; (b) two card runs bitwise; (c) the launches
    of one run == RGAT_LAUNCHES; then the device ms of the encode and of
    encode + backward."""
    import torch
    from repro_torch.convert import rgat_params_from_jax, rgat_params_to_jax
    from repro_torch.kernels.ops import EdgePlans
    from repro_torch.models import RGATConfig, init_rgat_params, rgat_encode
    from repro_torch.models.rgcn import RGCNConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    release()
    t0 = time.perf_counter()
    v, d = part["V"], FB15K["dim"]
    cfg = RGATConfig(base=RGCNConfig(
        num_entities=v, num_relations=part["R"], hidden_dim=d, num_layers=2,
        feature_dim=d), num_rel_dims=RGAT_REL_DIMS)
    tree = rgat_params_to_jax(init_rgat_params(np.random.default_rng(0),
                                               cfg))
    rng = np.random.default_rng(12)
    x = rng.normal(size=(v, d)).astype(np.float32)
    proj = rng.normal(size=(v, d)).astype(np.float32)
    arrays = [part[k] for k in ("src", "rel", "dst")]

    def on(device):
        edges = [torch.from_numpy(np.asarray(a, np.int64)).to(device)
                 for a in arrays] + [torch.from_numpy(
                     np.asarray(part["mask"], bool)).to(device)]
        return (rgat_params_from_jax(tree, cfg, device=device),
                torch.from_numpy(x).to(device), edges,
                torch.from_numpy(proj).to(device))
    p_cpu, x_cpu, e_cpu, proj_cpu = on("cpu")
    want = rgat_run(p_cpu, cfg, x_cpu, e_cpu, proj_cpu, None)
    params, xd, edges, projd = on(dev)

    def plans():
        return EdgePlans(*edges, v, part["R"])
    reset_counts()
    got = rgat_run(params, cfg, xd, edges, projd, plans())
    torch.cuda.synchronize()
    counts = launch_counts()
    again = rgat_run(params, cfg, xd, edges, projd, plans())
    names = ["h"] + [f"layers.{i}.{k}" for i, lp in
                     enumerate(params["layers"]) for k in lp] + ["x"]
    worst, share, rel = {}, {}, {}
    for name, a, b, w in zip(names, got, again, want):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"phase 12: {name} not finite")
        if not torch.equal(a, b):
            raise AssertionError(f"phase 12: two runs differ at {name}")
        a = a.cpu()
        worst[name] = max_abs_diff(a, w)
        share[name] = float(((a - w).abs() / (RGAT_TOL["atol"] + RGAT_TOL[
            "rtol"] * w.abs())).max())
        rel[name] = float((a - w).norm() / w.norm().clamp_min(1e-30))
    grads = {k: v for k, v in rel.items() if k != "h"}
    if share["h"] > 1 or max(grads.values()) > RGAT_GRAD_REL_L2:
        raise AssertionError(f"phase 12: card against CPU: the encode's "
                             f"share of {RGAT_TOL} {share['h']}, the "
                             f"gradients' relative L2 {grads} (gate "
                             f"{RGAT_GRAD_REL_L2})")
    others = {k: n for k, n in counts.items()
              if n != RGAT_LAUNCHES.get(k, 0)}
    if others:
        raise AssertionError(f"phase 12: launches {counts}, predicted "
                             f"{RGAT_LAUNCHES}")
    fwd_ms = device_ms(lambda: rgat_encode(params, cfg, xd, *edges,
                                           plans=plans()))
    both_ms = device_ms(lambda: rgat_run(params, cfg, xd, edges, projd,
                                         plans()))
    res = dict(V=v, E=part["E"], d=d, launches=counts,
               max_abs_err=worst, tolerance_share=share, rel_l2=rel,
               encode_ms=fwd_ms,
               encode_backward_ms=both_ms, backward_ms=both_ms - fwd_ms,
               seconds=time.perf_counter() - t0)
    log(f"[phase 12] RGAT at V={v}, E={part['E']}, d={d}, 2 layers: the "
        f"encode within {RGAT_TOL} of the plain CPU run (share "
        f"{share['h']:.3g}), every gradient leaf within relative L2 "
        f"{RGAT_GRAD_REL_L2} (largest {max(grads.values()):.3g}, "
        f"{max(grads, key=grads.get)}; elementwise share of {RGAT_TOL} up "
        f"to {max(share.values()):.3g}, largest |diff| "
        f"{max(worst.values()):.3g}), "
        f"two runs bitwise; launches {counts} == predicted "
        f"{RGAT_LAUNCHES}; device ms: encode {fwd_ms:.3f}, encode + "
        f"backward {both_ms:.3f} (backward {both_ms - fwd_ms:.3f}); "
        f"{res['seconds']:.1f} s; {card}")
    del params, xd, edges, projd, got, again
    release()
    return res


def check_dry_record(label, rec, card_run, launches, kernel_ops):
    """Phase 13's gates for one 1 x 1 record against its phase's card run:
    argument bytes and aten FLOPs ``==``, and every kernel's calls ==
    ``launches`` (a step's, counted on the card) and operations == its
    formula times them (``kernel_ops``: name -> formula of one call)."""
    if rec["memory"]["argument_bytes"] != card_run["argument_bytes"]:
        raise AssertionError(f"phase 13 {label}: argument bytes "
                             f"{rec['memory']['argument_bytes']} vs the "
                             f"card's {card_run['argument_bytes']}")
    if rec["aten_flops_per_device"] != card_run["flop_counter"]:
        raise AssertionError(f"phase 13 {label}: aten FLOPs "
                             f"{rec['aten_flops_per_device']} vs "
                             f"FlopCounterMode's {card_run['flop_counter']}")
    calls = {k: v["calls"] for k, v in rec["kernels"].items()}
    want_calls = {k: n for k, n in launches.items() if n}
    if calls != want_calls:
        raise AssertionError(f"phase 13 {label}: kernel calls {calls} vs "
                             f"the card's launches {want_calls}")
    for name, k in rec["kernels"].items():
        if k["ops"] != k["calls"] * kernel_ops[name]:
            raise AssertionError(f"phase 13 {label}: {name} ops {k['ops']} "
                                 f"vs {k['calls']} x {kernel_ops[name]}")


# rwkv6-3b decode_32k on the 16 x 16 fake mesh: the record's collective
# bytes a device, the same under every torch release the port runs on
# (tests/test_torch_dryrun.py::test_cli_full_size_record holds it on the
# CPU)
DRYRUN_DECODE_32K_COLLECTIVE_BYTES = 426853632


def run_dryrun_check(lm_train, gemma_train, card):
    """Phase 13: the 1 x 1 dry-run record (launch/dryrun.py, a fake process
    group of one rank, nothing on the card) of phase 8f's step (rwkv6-3b,
    B 2, S 2,048, fp32, remat, chunked_kernel) and of phase 9f's (gemma-2b,
    B 1, S 2,048, fp32), held against what those phases measured: (a) the
    record's argument bytes == the bytes of the parameters, Adam state and
    batch on the card before the first step; (b) its aten FLOPs ==
    FlopCounterMode around one more step on the card; (c) its kernel
    calls == the launches of a counted step and its kernel operations ==
    the formula times them. Printed as findings: the traced peak beside
    max_memory_allocated, the roofline's time (an analysis under H100
    figures) beside the measured step. Then the CLI's combination of
    tests/test_torch_dryrun.py at full size (rwkv6-3b, decode_32k, the
    16 x 16 mesh), its record's time, and its collective bytes ==
    DRYRUN_DECODE_32K_COLLECTIVE_BYTES."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.wkv_chunk import (
        wkv_chunked_backward_ops, wkv_chunked_ops,
    )
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import fake_process_group, make_fake_mesh
    from repro_torch.launch.specs import InputShape
    from repro_torch.training.optimizer import adam
    t0 = time.perf_counter()
    rwkv = dataclasses.replace(get_arch(LM_ARCH), rwkv_mode="chunked_kernel")
    hd = rwkv.rwkv_head_dim
    bh = LM_TRAIN_B * rwkv.d_model // hd
    cases = {
        "8f": (rwkv, InputShape("train", LM_TRAIN_S, LM_TRAIN_B, "train"),
               lm_train, lm_train["steps"][0]["launches"],
               {"wkv_chunked": wkv_chunked_ops(bh, LM_TRAIN_S, hd,
                                               rwkv.rwkv_chunk),
                "wkv_chunked_backward": wkv_chunked_backward_ops(
                    bh, LM_TRAIN_S, hd)}),
        "9f": (get_arch("gemma-2b"),
               InputShape("train", GEMMA_TRAIN_S, GEMMA_TRAIN_B, "train"),
               gemma_train, {}, {}),
    }
    res = {}
    with fake_process_group(1):
        mesh = make_fake_mesh((1, 1), ("data", "model"))
        for label, (cfg, shape, run, launches, ops) in cases.items():
            t1 = time.perf_counter()
            rec = D.dry_run(cfg, shape, mesh, dtype=torch.float32,
                            optimizer=adam(LM_TRAIN_LR))
            check_dry_record(label, rec, run, launches, ops)
            step_ms = min(st["ms"] for st in run["steps"])
            roof_ms = 1e3 * max(v for k, v in rec["roofline"].items()
                                if k.endswith("_s"))
            res[label] = dict(record=rec, trace_s=time.perf_counter() - t1,
                              step_ms=step_ms, roofline_ms=roof_ms,
                              peak_bytes=run["peak_bytes"])
            log(f"[phase 13] {label} ({cfg.name}, B={shape.global_batch}, "
                f"S={shape.seq_len}, fp32): the 1 x 1 record's argument "
                f"bytes {rec['memory']['argument_bytes']} == the card's, "
                f"aten FLOPs {rec['aten_flops_per_device']:.6g} == "
                f"FlopCounterMode's, kernel calls {rec['kernels'] and {k: v['calls'] for k, v in rec['kernels'].items()}} "
                f"== a step's launches and their operations == the "
                f"formula times them; traced in "
                f"{res[label]['trace_s']:.1f} s ({rec['traces']}). "
                f"Findings: traced peak "
                f"{rec['memory']['traced_peak_bytes'] / 1e9:.2f} GB beside "
                f"max_memory_allocated {run['peak_bytes'] / 1e9:.2f} GB; the "
                f"roofline's {roof_ms:.1f} ms (an analysis under H100 bf16 "
                f"figures, {rec['roofline']['dominant']}-bound) beside the "
                f"measured step's {step_ms:.1f} ms; {card}")
    t1 = time.perf_counter()
    cli = D.lower_one("rwkv6-3b", "decode_32k", "single")
    if cli["status"] != "ok" or cli["chips"] != 256:
        raise AssertionError(f"phase 13: the CLI's combination gave {cli}")
    if cli["collective_bytes_per_device"] != \
            DRYRUN_DECODE_32K_COLLECTIVE_BYTES:
        raise AssertionError(
            f"phase 13: rwkv6-3b decode_32k on 16 x 16 counts "
            f"{cli['collective_bytes_per_device']} collective bytes a device "
            f"under torch {torch.__version__}, not "
            f"{DRYRUN_DECODE_32K_COLLECTIVE_BYTES} "
            f"(tests/test_torch_dryrun.py holds the same on the CPU): "
            f"{cli['collective_detail']}")
    res["cli"] = dict(record=cli, seconds=time.perf_counter() - t1)
    log(f"[phase 13] rwkv6-3b decode_32k on the 16 x 16 fake mesh: "
        f"{cli['t_trace_s']:.1f} s traced ({res['cli']['seconds']:.1f} s in "
        f"all), dominant {cli['roofline']['dominant']}, "
        f"{cli['flops_per_device']:.4g} FLOPs and "
        f"{cli['collective_bytes_per_device']:.4g} collective bytes per "
        f"device (an analysis); phase 13 took "
        f"{time.perf_counter() - t0:.1f} s")
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
    # phase 9: the dense decoder LMs and the hybrid at full width; counts
    # reset before and read after the whole phase, which launches none
    lm9, profiles9 = run_lm9(dev, rng, card)
    profiles.update(profiles9)
    # phase 10: the MoE family; counts reset before and read after the
    # whole phase, whose one kernel is the router's topk
    lm10, profiles["moe_prefill_bf16"] = run_lm10(dev, rng, card)
    # phase 11: the multimodal backbones; counts reset before and read
    # after the whole phase, which launches none
    lm11 = run_lm11(dev, rng, card)
    # phase 12: the RGAT encoder; counts reset before and read after its
    # one main run
    rgat = run_rgat(dev, part, card)
    # phase 13: the dry run against phases 8f and 9f; it launches nothing
    dry = run_dryrun_check(lm_train, lm9["gemma_train"], card)

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
                   "lm_train": lm_train_launches[name],
                   "lm_dense_hybrid": lm9["launches"][name],
                   "lm_moe": lm10["launches"][name],
                   "lm_multimodal": lm11["launches"][name],
                   "rgat": rgat["launches"][name]}
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
                       "lm": lm, "lm_train": lm_train, "lm9": lm9,
                       "lm10": lm10, "lm11": lm11, "rgat": rgat,
                       "dryrun": dry,
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
