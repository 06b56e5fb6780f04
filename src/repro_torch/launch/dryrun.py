"""The dry run on fake process meshes (port of ``repro/launch/dryrun.py``):
for every architecture x input shape x production mesh (16 x 16, and 2 x
16 x 16 with a ``pod`` axis), trace one step of the port on abstract
tensors laid out by the sharding rules, and write what it would cost each
device. No card is needed and nothing is allocated on one.

Run:  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
          [--arch all] [--shape all] [--mesh single,multi] \\
          [--out experiments/dryrun_torch.jsonl] [--force] \\
          [--sharding 2d|1d] [--override k=v,...]

Results are appended one JSON record a line as each combination ends;
keys ``(arch, shape, mesh)`` already recorded ``ok`` or ``skipped`` are
skipped unless ``--force``. The exit code is 1 when any combination
records ``error``.

The reference jits and compiles each step under XLA's SPMD partitioner on
512 forced host devices and reads the compiled program. Here the mesh is a
``DeviceMesh`` over a fake process group (``launch/mesh.py``), parameters,
Adam state, batch and cache are ``DTensor``s placed by
``sharding/rules.py``, the activations are pinned by
``sharding/context.py``, and ``sharding/step_analysis.py`` counts the
traced step per device, loop-aware. A record is an analysis of a traced
program under the NVIDIA H100 80GB HBM3's figures, not a measurement. Its
keys, against the reference's:

* ``flops_per_device`` = ``aten_flops_per_device`` (the reference's
  ``hlo_flops_per_device``) + ``kernel_ops_per_device`` (the hand-written
  kernels' operations from their formulas); ``bytes_per_device`` likewise;
* ``collective_bytes_per_device`` and ``collective_detail`` as there;
* ``memory``: ``argument_bytes`` (per-device shard bytes of parameters,
  optimizer state, batch and cache), ``read_argument_bytes`` (those the
  step reads: the reference's ``argument_bytes``, as ``jax.jit`` drops an
  argument its program does not use), ``output_bytes``, ``alias_bytes``
  (outputs updated in place: parameters and moments in training, the
  cache in decode) and ``traced_peak_bytes`` where the reference has
  ``temp_bytes``;
* ``reshards``: the ops ``DTensor`` could not shard, whose inputs the
  trace gathered (``step_analysis.ReshardMode``);
* ``t_trace_s`` in place of ``t_lower_s`` and ``t_compile_s``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.launch import specs as S
from repro_torch.launch.mesh import (
    HBM_BW, NET_BW, PEAK_FLOPS_BF16, fake_process_group, make_fake_mesh,
    production_mesh_shape,
)
from repro_torch.launch.steps import (
    make_prefill_step, make_serve_step, make_train_step,
)
from repro_torch.nn.transformer import ArchConfig, leaves, stack_plan
from repro_torch.sharding import rules as R
from repro_torch.sharding import step_analysis as A
from repro_torch.sharding.context import mesh_context
from repro_torch.training.optimizer import adam

# every architecture of the port's registry the reference assigns
ASSIGNED = ["glm4-9b", "qwen3-32b", "whisper-large-v3", "rwkv6-3b",
            "gemma-2b", "recurrentgemma-9b", "arctic-480b", "qwen2-vl-7b",
            "qwen2.5-32b", "deepseek-v2-lite-16b"]

ANALYSIS = ("an analysis of the traced step under NVIDIA H100 80GB HBM3 "
            "figures, not a measurement")


# ---------------------------------------------------------------------- #
# One traced step
# ---------------------------------------------------------------------- #
def _place(tree, specs: Dict[str, R.Spec], mesh, prefix: str = ""):
    """``tree`` with every ``meta`` leaf replaced by its ``DTensor``."""
    if isinstance(tree, dict):
        return {k: _place(v, specs, mesh, f"{prefix}{k}.")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_place(v, specs, mesh, f"{prefix}{i}.")
                for i, v in enumerate(tree)]
    return A.on_mesh(tree, specs[prefix[:-1]], mesh)


def _locals(tree) -> List[torch.Tensor]:
    from torch.distributed.tensor import DTensor
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in A.tensor_leaves(tree)]


def trace_step(cfg: ArchConfig, shape: S.InputShape, mesh, *,
               sharding_mode: str = "2d", dtype=torch.bfloat16,
               optimizer=None) -> Dict[str, Any]:
    """Trace one step of ``shape.mode`` for ``cfg`` at ``shape`` on
    ``mesh`` (a ``DeviceMesh`` on a fake group): the per-device counts of
    ``step_analysis.StepCounter``, with ``output_bytes``, ``alias_bytes``
    and the ops that needed a reshard."""
    from torch.distributed.tensor.experimental import implicit_replication
    optimizer = optimizer or adam(1e-4)
    params_m = S.abstract_params(cfg, dtype)
    p_sh = R.param_shardings(params_m, mesh, mode=sharding_mode)
    batch_m = S.abstract_batch(cfg, shape)
    b_sh = R.batch_shardings(batch_m, mesh)
    if shape.mode == "decode":
        cache_m = S.abstract_cache(cfg, shape, dtype=dtype)
        c_sh = R.cache_shardings(cache_m, mesh)
    counter, reshard = A.StepCounter(), A.ReshardMode()
    with counter, implicit_replication(), mesh_context(mesh):
        params = _place(params_m, p_sh, mesh)
        batch = {k: A.on_mesh(v, b_sh[k], mesh) for k, v in batch_m.items()}
        if shape.mode == "train":
            opt_state = optimizer.init(dict(leaves(params)))
            args: Tuple = (params, opt_state, batch)
            step = make_train_step(cfg, optimizer)
        elif shape.mode == "prefill":
            args = (params, batch)
            step = make_prefill_step(cfg)
        else:
            cache = _place(cache_m, c_sh, mesh)
            args = (params, cache, batch)
            step = make_serve_step(cfg)
        counter.watch(_locals(args))
        with counter.step() as counts, reshard:
            out = step(*args)
        locs = _locals(out)
        counts["output_bytes"] = float(sum(A.tensor_bytes(t) for t in locs))
        counts["alias_bytes"] = float(sum(
            A.tensor_bytes(t) for t in locs
            if id(t.untyped_storage()) in counter.watched))
        counts["read_argument_bytes"] = float(counter.read_bytes)
    counts["reshards"] = dict(reshard.reshards)
    return counts


# ---------------------------------------------------------------------- #
# Loop-aware: depth cuts, extrapolated
# ---------------------------------------------------------------------- #
def _scanned(cfg: ArchConfig) -> Dict[str, int]:
    """The scanned groups' trip counts: the decoder stack's, and the
    encoder's of an encoder-decoder."""
    out = {}
    for kind, n, scanned in stack_plan(cfg):
        if scanned:
            out["stack"] = n
    if cfg.arch_type == "encdec":
        out["encoder"] = cfg.encoder_layers
    return out


def with_depth(cfg: ArchConfig, stack: Optional[int] = None,
               encoder: Optional[int] = None) -> ArchConfig:
    """``cfg`` with its scanned stack group ``stack`` deep (a hybrid's
    pattern repeated ``stack`` times, its remainder kept; an MoE model's
    first dense layers kept) and an encoder-decoder's encoder ``encoder``
    deep."""
    kw = {}
    if stack is not None:
        if cfg.arch_type == "hybrid":
            pattern = cfg.hybrid_pattern or ("rec", "rec", "attn")
            kw["num_layers"] = stack * len(pattern) \
                + cfg.num_layers % len(pattern)
        elif cfg.arch_type == "moe":
            kw["num_layers"] = cfg.first_k_dense + stack
        else:
            kw["num_layers"] = stack
    if encoder is not None:
        kw["encoder_layers"] = encoder
    return dataclasses.replace(cfg, **kw)


BASE_DEPTH = 2      # the first layer of a group differs (its input's
#                     placement), so a group is traced 2 and 3 deep


def analyze(cfg: ArchConfig, shape: S.InputShape, mesh, *,
            sharding_mode: str = "2d", dtype=torch.bfloat16,
            optimizer=None, full: bool = False) -> Dict[str, Any]:
    """Loop-aware per-device counts of one step: traced whole with
    ``full``, else with each scanned group cut to 2 and 3 layers and
    extrapolated linearly to its trip count (``step_analysis.extrapolate``);
    the sequence at its whole length either way. ``traces`` says how."""
    kw = dict(sharding_mode=sharding_mode, dtype=dtype, optimizer=optimizer)
    groups = {k: n for k, n in _scanned(cfg).items() if n > BASE_DEPTH + 1}
    if full or not groups:
        counts = trace_step(cfg, shape, mesh, **kw)
        counts["traces"] = "whole"
        return counts
    reshards: Dict[str, int] = {}

    def at(depths):
        c = trace_step(with_depth(cfg, **depths), shape, mesh, **kw)
        for op, n in c.pop("reshards").items():
            reshards[op] = max(reshards.get(op, 0), n)
        return c
    base = {k: BASE_DEPTH for k in groups}
    steps = [(at({**base, k: BASE_DEPTH + 1}), n - BASE_DEPTH)
             for k, n in groups.items()]
    counts = A.extrapolate(at(base), steps)
    counts["traces"] = ", ".join(
        f"{k} at {BASE_DEPTH} and {BASE_DEPTH + 1} of {n} layers"
        for k, n in groups.items()) + ", extrapolated"
    counts["reshards"] = reshards
    return counts


def argument_bytes(cfg: ArchConfig, shape: S.InputShape, mesh, *,
                   sharding_mode: str = "2d", dtype=torch.bfloat16,
                   optimizer=None) -> int:
    """Per-device bytes of the step's arguments at full size, from the
    rules' shard shapes: parameters (and Adam's step and moments in
    training), batch and, in decode, the cache."""
    params = S.abstract_params(cfg, dtype)
    p_sh = R.param_shardings(params, mesh, mode=sharding_mode)
    total = sum(R.spec_bytes(p_sh[n], t, mesh) for n, t in leaves(params))
    if shape.mode == "train":
        opt = S.abstract_opt_state(params, optimizer)
        total += opt.step.element_size()
        for moments in (opt.mu, opt.nu):
            if moments is not None:
                total += sum(R.spec_bytes(p_sh[n], t, mesh)
                             for n, t in moments.items())
    batch = S.abstract_batch(cfg, shape)
    total += sum(R.spec_bytes(R.spec_for_batch_leaf(tuple(t.shape), mesh),
                              t, mesh) for t in batch.values())
    if shape.mode == "decode":
        cache = S.abstract_cache(cfg, shape, dtype=dtype)
        c_sh = R.cache_shardings(cache, mesh)
        total += sum(R.spec_bytes(c_sh[n], t, mesh)
                     for n, t in leaves(cache))
    return total


def _costs(counts: Dict, n_chips: int, t_trace: float) -> Dict[str, Any]:
    """The cost fields every record has, from a trace's counts."""
    kernel_ops = sum(k["ops"] for k in counts["kernels"].values())
    kernel_bytes = sum(k["bytes"] for k in counts["kernels"].values())
    return {
        "status": "ok",
        "chips": n_chips,
        "analysis": ANALYSIS,
        "t_trace_s": round(t_trace, 2),
        "flops_per_device": counts["flops"] + kernel_ops,
        "aten_flops_per_device": counts["flops"],
        "kernel_ops_per_device": kernel_ops,
        "bytes_per_device": counts["bytes"] + kernel_bytes,
        "aten_bytes_per_device": counts["bytes"],
        "kernel_bytes_per_device": kernel_bytes,
        "kernels": counts["kernels"],
        "collective_bytes_per_device": sum(
            v["bytes"] for v in counts["collectives"].values()),
        "collective_detail": counts["collectives"],
        "roofline": A.roofline(counts, PEAK_FLOPS_BF16, HBM_BW, NET_BW),
    }


def record(cfg: ArchConfig, shape: S.InputShape, mesh, counts: Dict,
           arg_bytes: int, t_trace: float) -> Dict[str, Any]:
    """The record's cost fields from ``analyze``'s counts."""
    n_chips = math.prod(R.mesh_axes(mesh).values())
    rec = _costs(counts, n_chips, t_trace)
    mf = S.model_flops(cfg, shape)
    rec.update({
        "traces": counts["traces"],
        "scan_trip_count": S.scan_trip_count(cfg),
        "reshards": counts["reshards"],
        "memory": {"argument_bytes": arg_bytes,
                   "read_argument_bytes": counts["read_argument_bytes"],
                   "output_bytes": counts["output_bytes"],
                   "alias_bytes": counts["alias_bytes"],
                   "traced_peak_bytes": counts["peak_bytes"]},
        "model_flops_global": mf,
        "model_flops_per_device": mf / n_chips,
        "useful_flops_ratio": (mf / n_chips) / rec["flops_per_device"]
        if rec["flops_per_device"] else None,
    })
    return rec


def dry_run(cfg: ArchConfig, shape: S.InputShape, mesh, *,
            sharding_mode: str = "2d", dtype=torch.bfloat16,
            optimizer=None, full: bool = False) -> Dict[str, Any]:
    """The cost fields of one combination on ``mesh``, any ``cfg``,
    ``shape`` and ``dtype`` (``chip_smoke.py`` phase 13 holds a 1 x 1
    record against the card)."""
    t0 = time.time()
    counts = analyze(cfg, shape, mesh, sharding_mode=sharding_mode,
                     dtype=dtype, optimizer=optimizer, full=full)
    args = argument_bytes(cfg, shape, mesh, sharding_mode=sharding_mode,
                          dtype=dtype, optimizer=optimizer)
    return record(cfg, shape, mesh, counts, args, time.time() - t0)


# ---------------------------------------------------------------------- #
# The CLI's combinations
# ---------------------------------------------------------------------- #
def _apply_overrides(cfg: ArchConfig, overrides: str) -> ArchConfig:
    """``--override "k=v,k=v"`` → ``dataclasses.replace`` on the config."""
    if not overrides:
        return cfg
    fields = {f.name: f for f in dataclasses.fields(cfg)}
    kw = {}
    for item in overrides.split(","):
        k, v = item.split("=", 1)
        ftype = str(fields[k].type)
        if ftype == "int":
            v = int(v)
        elif ftype == "float":
            v = float(v)
        elif ftype == "bool":
            v = v.lower() in ("1", "true")
        kw[k] = v
    return dataclasses.replace(cfg, **kw)


def lower_one(arch_name: str, shape_name: str, mesh_kind: str,
              sharding_mode: str = "2d", overrides: str = "") -> Dict:
    """Trace and analyze one combination; returns the record."""
    if arch_name == "rgcn-citation2":
        if shape_name != "kg_train":
            return {"arch": arch_name, "shape": shape_name,
                    "mesh": mesh_kind, "status": "skipped",
                    "note": "rgcn uses its own kg_train shape", "mode": "-"}
        return lower_rgcn(mesh_kind, overrides)
    shape = S.INPUT_SHAPES[shape_name]
    cfg, note = S.resolve_arch_for_shape(arch_name, shape_name)
    rec: Dict = {
        "arch": arch_name, "shape": shape_name, "mesh": mesh_kind,
        "mode": shape.mode, "sharding": sharding_mode, "note": note,
        "overrides": overrides, "status": "skipped",
    }
    if cfg is None:
        return rec
    cfg = _apply_overrides(cfg, overrides)
    dims, names = production_mesh_shape(mesh_kind)
    with fake_process_group(math.prod(dims)):
        mesh = make_fake_mesh(dims, names)
        rec.update(dry_run(cfg, shape, mesh, sharding_mode=sharding_mode))
    return rec


def lower_rgcn(mesh_kind: str, overrides: str = "") -> Dict:
    """The paper's own configuration at pod scale: one self-sufficient
    ogbl-citation2 partition per rank (V 262,144, E 1,048,576, features
    128, hidden 32), RGCN + DistMult + constraint-based negatives, the
    port's multi-process step (``training/distributed.py``
    ``make_spmd_train_step``) over every rank of the fake group as the
    data axis. The step gathers every trainer's gradients
    (``all_gather``, bitwise the simulated step) where the reference
    averages them with one ``pmean``: at result size (the reference's
    convention) the gathered rows of every rank are ``n_chips / 2`` times
    the all-reduce's twice-the-buffer, a known difference that grows with
    the trainer count (ROADMAP, Queue 3 K)."""
    dims, _ = production_mesh_shape(mesh_kind)
    n_chips = math.prod(dims)
    t0 = time.time()
    with fake_process_group(n_chips):
        counts, arg_bytes = trace_rgcn(n_chips, overrides)
    return {
        "arch": "rgcn-citation2", "shape": "kg_train", "mesh": mesh_kind,
        "mode": "train", "overrides": overrides,
        "note": f"paper's own config: {n_chips} self-sufficient "
                "partitions, V_max=262144 E_max=1048576 per partition; "
                "gradients all_gather'ed (bitwise the simulated step): "
                f"{n_chips // 2}x the reference's pmean bytes "
                "(ROADMAP Queue 3 K)",
        **_costs(counts, n_chips, time.time() - t0),
        "memory": {"argument_bytes": arg_bytes,
                   "traced_peak_bytes": counts["peak_bytes"]},
        "model_flops_global": 0.0, "model_flops_per_device": 0.0,
        "useful_flops_ratio": None,
    }


RGCN_V_MAX, RGCN_E_MAX, RGCN_FEAT, RGCN_HID = 262_144, 1_048_576, 128, 32


def trace_rgcn(n_chips: int, overrides: str = "") -> Tuple[Dict, int]:
    """One multi-process step of the paper's configuration on this rank
    of a fake group of ``n_chips`` ranks, one trainer (partition) a rank:
    ``(counts, argument bytes)`` of ``step_analysis.StepCounter``.
    ``overrides`` containing ``dtype=bf16`` ships features and parameters
    in bf16, as the reference's variant."""
    import torch.distributed as dist
    from repro_torch.core.negative import constraint_based_negatives
    from repro_torch.core.negative import mix_pos_neg
    from repro_torch.models import decoders
    from repro_torch.models.kge import KGEConfig, KGEModel
    from repro_torch.models.rgcn import RGCNConfig, rgcn_encode
    from repro_torch.training.distributed import make_spmd_train_step
    bf16 = "dtype=bf16" in overrides
    dt = torch.bfloat16 if bf16 else torch.float32
    cfg = KGEConfig(rgcn=RGCNConfig(
        num_entities=2_927_963, num_relations=2, hidden_dim=RGCN_HID,
        num_layers=2, num_bases=2, feature_dim=RGCN_FEAT, dropout=0.0))

    def loss_fn(model, b, generator):
        h = rgcn_encode(model, cfg.rgcn, b["features"], b["src"], b["rel"],
                        b["dst"], b["edge_mask"])
        pos = torch.stack([b["src"], b["rel"], b["dst"]], dim=1)
        neg, _ = constraint_based_negatives(generator, pos, 1, RGCN_V_MAX)
        trip, labels = mix_pos_neg(pos, neg)
        core = b["core_edge_mask"].to(torch.float32)
        scores = decoders.score_triplets(model["decoder"], cfg.decoder, h,
                                         trip)
        loss = decoders.bce_loss(scores, labels, torch.cat([core, core]))
        return loss, {}
    counter = A.StepCounter()
    with counter:
        model = KGEModel(cfg, device="cpu")
        if bf16:
            for p in model.parameters():
                p.data = p.data.to(dt)
        optimizer = adam(1e-2)
        opt_state = optimizer.init({n: p.detach()
                                    for n, p in model.named_parameters()})
        e, v = RGCN_E_MAX, RGCN_V_MAX
        batch = {
            "src": torch.empty((1, e), dtype=torch.int64),
            "rel": torch.empty((1, e), dtype=torch.int64),
            "dst": torch.empty((1, e), dtype=torch.int64),
            "edge_mask": torch.empty((1, e), dtype=torch.bool),
            "core_edge_mask": torch.empty((1, e), dtype=torch.bool),
            "features": torch.empty((1, v, RGCN_FEAT), dtype=dt),
        }
        args = (list(model.parameters()), opt_state, batch)
        arg_bytes = sum(A.tensor_bytes(t) for t in A.tensor_leaves(args))
        step = make_spmd_train_step(loss_fn, optimizer, dist.group.WORLD)
        with counter.step() as counts:
            step(model, opt_state, batch, [torch.Generator()])
    return counts, arg_bytes


def load_done(path: str) -> Dict:
    done = {}
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    done[(r["arch"], r["shape"], r["mesh"])] = r
                except (ValueError, KeyError):
                    pass
    return done


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single,multi")
    ap.add_argument("--out", default="experiments/dryrun_torch.jsonl")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--sharding", default="2d", choices=["2d", "1d"])
    ap.add_argument("--override", default="",
                    help="ArchConfig overrides, e.g. rwkv_mode=chunked")
    args = ap.parse_args(argv)

    archs = ASSIGNED if args.arch == "all" else args.arch.split(",")
    shapes = (list(S.INPUT_SHAPES) if args.shape == "all"
              else args.shape.split(","))
    meshes = args.mesh.split(",")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done = {} if args.force else load_done(args.out)
    failures = 0
    with open(args.out, "a") as out:
        for arch in archs:
            for shape in shapes:
                for mesh_kind in meshes:
                    key = (arch, shape, mesh_kind)
                    prev = done.get(key)
                    if prev and prev.get("status") in ("ok", "skipped"):
                        continue
                    t0 = time.time()
                    try:
                        rec = lower_one(arch, shape, mesh_kind,
                                        sharding_mode=args.sharding,
                                        overrides=args.override)
                    except Exception as e:   # recorded, the sweep goes on
                        rec = {"arch": arch, "shape": shape,
                               "mesh": mesh_kind, "status": "error",
                               "error": f"{type(e).__name__}: {e}",
                               "traceback": traceback.format_exc()[-2000:]}
                        failures += 1
                    out.write(json.dumps(rec) + "\n")
                    out.flush()
                    dom = rec.get("roofline", {}).get("dominant", "-")
                    print(f"[{time.strftime('%H:%M:%S')}] {arch:>22s} "
                          f"{shape:>12s} {mesh_kind:>6s} "
                          f"{rec['status']:>7s} dom={dom} "
                          f"({time.time() - t0:.0f}s)", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
