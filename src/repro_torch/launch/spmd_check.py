"""The multi-process step against the simulated step, on every rank.

    PYTHONPATH=src python -m repro_torch.launch.spmd_check \\
        --init-method file:///tmp/rendezvous --world-size 2 --rank 0 \\
        [--device cpu] [--table-shards 1] [--cli]

Run one process per rank (the same command with ``--rank`` 0 .. W-1, or
under ``torchrun`` without the three process-group flags): on the cards
over NCCL, one card per rank (``LOCAL_RANK``, else the rank), or with
``--device cpu`` on the CPU over gloo (``chip_smoke.py`` phase 6f runs the
same functions on one card). Each rank joins the process group, builds
the ``data`` × ``model`` process mesh with a model axis of
``--table-shards`` ranks, and for every exchange (``psum_scatter``, ``psum``, ``alltoall``; one run for
a dense fp32 table, which has no exchange) and both table dtypes trains a
few steps of the FB15k-237 stand-in on the multi-process step and, in the
same process, on the simulated step; then it holds them together:

* per-step losses equal, and every parameter and Adam moment bitwise the
  simulated one (this rank's row block of the entity table), also with
  the deduplicated gather plan (each rank pads its own trainers' rows to
  their own bucket) and, on a mesh with a data axis, over a whole epoch
  (each rank builds only its own trainers' batches and stops at the
  whole stream's step count);
* the test evaluation (the encode through the exchange, each rank
  keeping and ranking its own row block of the embeddings) equal to the
  simulated one;
* ``eval.sharded.make_sharded_rank_step`` over the rank's row block
  (bitwise those rows of the simulated encode) equal to the simulated
  counts in the all-entities and the candidate-list protocols;
* with ``--cli``, ``launch.train`` (``--spmd``) printing the losses and
  metrics of the same command on the simulated step.

It exits non-zero at the first difference, and prints ``SPMD_CHECK_OK``
with the cases it held on success. The functions are the same checks
``chip_smoke.py`` runs on the card. With ``--train-from DIR`` it runs no
check: it trains the cases of ``DIR`` from the parameters there and
reports the losses (:func:`train_from`), for a caller to hold against
another implementation. With ``--resume DIR`` it holds only checkpoints
under spmd (:func:`check_resume`): a resumed run bitwise the unbroken
one, the file ``==`` the simulated trainer's, and a simulated checkpoint
at twice the table shards resumed on the mesh; the files stay under
``DIR`` for the caller.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import re
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import ROW_BLOCK, backend_for
from repro_torch.sharding.embedding import SPMD_EXCHANGES


def state_mismatches(real, sim) -> List[str]:
    """Names of the parameters, Adam moments and step counter of the
    multi-process trainer ``real`` whose bits differ from the simulated
    trainer ``sim``'s: a leaf placed as a row block (``real.param_specs``,
    ``real.opt_specs``) against this rank's block of ``sim``'s."""
    i = real.mesh.model_index

    def own(spec, t):
        return t[i:i + 1] if spec == ROW_BLOCK else t

    pairs = [(f"params/{n}", p, own(real.param_specs[n], q))
             for (n, p), (_, q) in zip(real.params.named_parameters(),
                                       sim.params.named_parameters())]
    for part in ("mu", "nu"):
        a, b = getattr(real.opt_state, part), getattr(sim.opt_state, part)
        specs = getattr(real.opt_specs, part)
        pairs += [(f"opt/{part}/{n}", a[n], own(specs[n], b[n])) for n in a]
    pairs.append(("opt/step", real.opt_state.step, sim.opt_state.step))
    bad = []
    for name, a, b in pairs:
        a, b = a.detach(), b.detach()
        if a.shape != b.shape or not torch.equal(
                a.reshape(-1).view(torch.uint8),
                b.reshape(-1).view(torch.uint8)):
            bad.append(name)
    return bad


def run_steps(trainer, steps: Optional[int]) -> Dict:
    """``steps`` updates of ``trainer`` (mini-batch: the first steps of
    epoch 1, or all of them with ``None``; full-graph: one per epoch): the
    losses and the mean step time (host clock, ending in the loss on the
    host)."""
    losses, t = [], 0.0

    def one(batch, epoch, j):
        nonlocal t
        gens = trainer.step_generators(epoch, j)
        t0 = time.perf_counter()
        losses.append(trainer.step(batch, gens))
        t += time.perf_counter() - t0

    if trainer.cfg.batch_size is None:
        for epoch in range(1, steps + 1):
            for batch in trainer.pipeline.device_batches(epoch):
                one(batch, epoch, 0)
    else:
        it = trainer.pipeline.device_batches(1)
        for j, batch in enumerate(it):
            if j == steps:
                break
            one(batch, 1, j)
        it.close()
    return {"losses": losses, "step_s": t / max(len(losses), 1)}


DEDUP_STEPS = 4


def plan_widths(trainer, steps: int) -> List[int]:
    """The gather plan's width (the deduplicated bucket) of each of the
    first ``steps`` batches of epoch 1 of ``trainer``'s pipeline (none for
    a dense table, which has no plan)."""
    it = trainer.pipeline.device_batches(1)
    widths = [int(b["shard_local_ids"].shape[-1])
              for _, b in zip(range(steps), it) if "shard_local_ids" in b]
    it.close()
    return widths


def zip_shortest_steps(trainer, epoch: int = 1) -> int:
    """The epoch's step count as the whole batch stream gives it: the
    zip-shortest over every partition's own stream, built here (the
    count a rank's pipeline computes from the partition sizes must be
    this one)."""
    pipe = trainer.pipeline
    return len(list(zip(*(pipe.partition_stream(epoch, i)
                          for i in range(len(pipe.partitions))))))


def compare_training(splits, cfg, device,
                     steps: Optional[int] = 2) -> Dict:
    """``cfg`` trained ``steps`` steps (``None``: mini-batch epoch 1
    whole) on the multi-process step (every rank of the initialised
    group) and on the simulated step (in this process): losses equal, the
    state bitwise (:func:`state_mismatches`), and the test evaluations
    equal. Raises ``AssertionError`` on a difference; returns the losses,
    step times, metrics and the trainers."""
    from repro_torch.training import KGETrainer

    real = KGETrainer(splits, dataclasses.replace(cfg, spmd=True),
                      device=device)
    sim = KGETrainer(splits, dataclasses.replace(
        cfg, spmd=False, gather_exchange=None), device=device)
    if real.mesh is None:
        raise AssertionError("spmd=True built no process mesh")
    out = {"real": run_steps(real, steps), "sim": run_steps(sim, steps)}
    for tr in (real, sim):
        tr.close()
    bad = state_mismatches(real, sim)
    if out["real"]["losses"] != out["sim"]["losses"] or bad:
        raise AssertionError(
            f"real != simulated step: losses {out['real']['losses']} vs "
            f"{out['sim']['losses']}, state {bad}")
    out["metrics"] = real.evaluate("test")
    sim_metrics = sim.evaluate("test")
    if out["metrics"] != sim_metrics:
        raise AssertionError(f"spmd evaluation {out['metrics']} != "
                             f"simulated {sim_metrics}")
    out["trainers"] = (real, sim)
    return out


def compare_rank_steps(real, sim, num_candidates: int = 50,
                       seed: int = 0) -> Dict:
    """``make_sharded_rank_step`` on ``real``'s model axis over its row
    block of the embeddings (``real.encode_entity_block()``, bitwise
    those rows of ``sim``'s whole matrix) against the simulated sharded
    ranking of ``sim``'s embeddings, in both protocols (the candidate
    lists drawn from ``numpy.random.default_rng(seed)``), at both table
    dtypes: the metrics equal. Returns them."""
    from repro_torch.eval.ranking import CSRFilterIndex
    from repro_torch.eval.sharded import (
        make_sharded_rank_step, sharded_ranking_metrics,
    )
    from repro_torch.sharding.embedding import (
        ShardedTableLayout, shard_table,
    )
    axis = real.mesh.model_axis
    emb = sim.encode_all_entities()
    block = real.encode_entity_block()
    whole = shard_table(emb, ShardedTableLayout(emb.shape[0], axis.size))
    if not torch.equal(block.view(torch.int32),
                       whole[axis.index:axis.index + 1].view(torch.int32)):
        raise AssertionError(f"the rank's row block {axis.index} of the "
                             f"embeddings != those rows of the simulated "
                             f"encode")
    dparams = {k: v.detach() for k, v in sim.params["decoder"].items()}
    splits = sim.splits
    test = splits["test"].triplets()
    fidx = CSRFilterIndex.build([splits[k].with_inverse_relations()
                                 for k in ("train", "valid", "test")])
    cands = np.random.default_rng(seed).integers(
        0, emb.shape[0], (test.shape[0], num_candidates)).astype(np.int32)
    out = {}
    for protocol, extra in (("all-entities", {}),
                            ("candidates", {"candidates": cands})):
        step = make_sharded_rank_step(axis, decoder=sim.cfg.decoder,
                                      protocol=protocol)
        for dtype in ("fp32", "int8"):
            kw = dict(decoder=sim.cfg.decoder, table_dtype=dtype, **extra)
            got = sharded_ranking_metrics(block, dparams, test, fidx,
                                          axis.size, rank_step=step,
                                          num_entities=emb.shape[0], **kw)
            want = sharded_ranking_metrics(emb, dparams, test, fidx,
                                           axis.size, **kw)
            if got != want:
                raise AssertionError(f"rank step {protocol} {dtype}: {got} "
                                     f"!= simulated {want}")
            out[f"{protocol}_{dtype}"] = got
    return out


def tree_mismatches(a, b) -> List[str]:
    """Paths of the checkpoint trees (``KGETrainer._checkpoint_tree``: the
    parameters, Adam moments and step counter) of trainers ``a`` and ``b``
    whose bits differ."""
    from repro_torch.training.checkpoint import tree_leaves_with_path
    pa = dict(tree_leaves_with_path(a._checkpoint_tree()))
    pb = dict(tree_leaves_with_path(b._checkpoint_tree()))
    bad = sorted(set(pa) ^ set(pb))
    for k in sorted(set(pa) & set(pb)):
        x, y = pa[k].detach(), pb[k].detach()
        if x.shape != y.shape or not torch.equal(
                x.reshape(-1).view(torch.uint8),
                y.reshape(-1).view(torch.uint8)):
            bad.append(k)
    return bad


def checkpoint_mismatches(path: str, other: str) -> List[str]:
    """The arrays (by key) and manifest fields of two checkpoints that are
    not ``==``, dtypes included."""
    from repro_torch.training.checkpoint import read_metadata
    with np.load(path) as z, np.load(other) as w:
        a, b = dict(z), dict(w)
    bad = sorted(set(a) ^ set(b))
    bad += [k for k in sorted(set(a) & set(b)) if a[k].dtype != b[k].dtype
            or not np.array_equal(a[k], b[k])]
    if read_metadata(path) != read_metadata(other):
        bad.append("manifest")
    return bad


def compare_resume(splits, cfg, device, directory: str) -> Dict:
    """Checkpoints under spmd: ``cfg`` on the multi-process step trained two
    epochs without a break, against epoch 1, ``save_checkpoint`` into
    ``directory/spmd`` and a new spmd trainer that restores it and trains
    epoch 2: epoch 2's per-step losses and the state after it bitwise
    (:func:`tree_mismatches`). The checkpoint ``==`` the simulated
    trainer's at epoch 1 (arrays and manifest). For an fp32 table also: a
    simulated trainer at twice the table shards saves epoch 1, and a new
    spmd trainer restores it (the layout converted) and trains epoch 2
    bitwise the unbroken run. Raises ``AssertionError`` on a difference;
    returns the losses, the spmd checkpoint's path and bytes."""
    from repro_torch.training import KGETrainer

    rank = dist.get_rank()
    real = dataclasses.replace(cfg, spmd=True)
    sim = dataclasses.replace(cfg, spmd=False, gather_exchange=None)

    def run(config, epochs, restore=None, save=None):
        tr = KGETrainer(splits, config, device=device)
        try:
            if restore is not None:
                tr.restore(restore)
            hist = tr.fit(epochs)
            path = tr.save_checkpoint(save) if save is not None else None
        finally:
            tr.close()
        return tr, hist, path

    unbroken, hist, _ = run(real, 2)
    want = hist[1]["losses"]
    _, _, path = run(real, 1, save=os.path.join(directory, "spmd"))
    resumed, got, _ = run(real, 1, restore=path)
    bad = tree_mismatches(unbroken, resumed)
    if got[0]["losses"] != want or got[0]["epoch"] != 2 or bad:
        raise AssertionError(f"resumed spmd epoch 2 {got[0]['losses']} != "
                             f"unbroken {want}; state {bad}")
    _, _, sim_path = run(sim, 1, save=os.path.join(directory,
                                                   f"sim_rank{rank}"))
    bad = checkpoint_mismatches(path, sim_path)
    if bad:
        raise AssertionError(f"spmd checkpoint != simulated: {bad}")
    out = {"losses": want, "path": path, "bytes": os.path.getsize(path)}
    if cfg.table_dtype == "fp32":
        wide = dataclasses.replace(sim, num_table_shards=2 *
                                   cfg.num_table_shards)
        _, _, wide_path = run(wide, 1, save=os.path.join(
            directory, f"sim_wide_rank{rank}"))
        resumed, got, _ = run(real, 1, restore=wide_path)
        bad = tree_mismatches(unbroken, resumed)
        if got[0]["losses"] != want or bad:
            raise AssertionError(
                f"a {wide.num_table_shards}-shard simulated checkpoint "
                f"resumed on the spmd step: {got[0]['losses']} != {want}; "
                f"state {bad}")
        out["wide_losses"] = got[0]["losses"]
    return out


def check_resume(device: torch.device, table_shards: int,
                 directory: str) -> Dict:
    """:func:`compare_resume` at the fp32 and int8 tables on the
    initialised process group."""
    from repro_torch.data import synthetic_fb15k
    from repro_torch.training import TrainConfig

    splits = synthetic_fb15k(scale=0.01, seed=3)
    base = TrainConfig(num_trainers=4, hidden_dim=8, batch_size=256,
                       epochs=2, seed=0, num_table_shards=table_shards,
                       pipeline="serial")
    return {dtype: compare_resume(
        splits, dataclasses.replace(base, table_dtype=dtype), device,
        os.path.join(directory, dtype)) for dtype in ("fp32", "int8")}


def cli_lines(argv: Sequence[str]) -> List[str]:
    """The loss and metric lines ``launch.train`` prints for ``argv`` (the
    times cut out); this rank prints them only if it is rank 0."""
    from repro_torch.launch import train as train_cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_cli.main(list(argv))
    return [re.sub(r" t=.*", "", line) for line in buf.getvalue().splitlines()
            if "loss=" in line or line.startswith("[eval] {")]


def check_all(device: torch.device, table_shards: int, cli: bool) -> Dict:
    """Every case of this module on the initialised process group."""
    from repro_torch.data import synthetic_fb15k
    from repro_torch.training import TrainConfig

    splits = synthetic_fb15k(scale=0.01, seed=3)
    base = TrainConfig(num_trainers=4, hidden_dim=8, batch_size=256,
                       epochs=1, seed=0, num_table_shards=table_shards)
    cases = {}
    for dtype in ("fp32", "int8"):
        exchanges = SPMD_EXCHANGES
        if dtype == "fp32" and table_shards == 1:
            exchanges = (None,)          # a dense table has no exchange
        for ex in exchanges:
            cfg = dataclasses.replace(base, table_dtype=dtype,
                                      gather_exchange=ex)
            res = compare_training(splits, cfg, device)
            cases[f"minibatch_{dtype}_{ex}"] = res["real"]["losses"]
    # the deduplicated plan: each rank pads its trainers' rows to their
    # own bucket, the simulated step to every trainer's. On a graph large
    # enough, and batches small enough, for the buckets of a rank's
    # trainers and of all trainers to differ within the first steps
    dedup = dataclasses.replace(base, gather_dedup=True, num_hops=1,
                                batch_size=16)
    res = compare_training(synthetic_fb15k(scale=0.05, seed=3), dedup,
                           device, steps=DEDUP_STEPS)
    cases["dedup_fp32"] = res["real"]["losses"]
    cases["dedup_buckets"] = {k: plan_widths(tr, DEDUP_STEPS) for k, tr in
                              zip(("rank", "whole"), res["trainers"])}
    if res["trainers"][0].mesh.data > 1:
        # a whole epoch: every rank stops at the step count of the whole
        # stream, whatever its own partitions hold
        res = compare_training(splits, base, device, steps=None)
        want = zip_shortest_steps(res["trainers"][1])
        got = len(res["real"]["losses"])
        if got != want:
            raise AssertionError(f"the spmd epoch took {got} steps, the "
                                 f"whole stream has {want}")
        cases["epoch_fp32"] = res["real"]["losses"]
    res = compare_training(splits, dataclasses.replace(
        base, batch_size=None, use_kernel=True), device)
    cases["fullgraph_fp32_kernel"] = res["real"]["losses"]
    cases["rank_steps"] = compare_rank_steps(*res["trainers"])
    if cli:
        argv = ["--device", device.type, "--arch", "rgcn-fb15k237",
                "--scale", "0.01", "--trainers", "2", "--batch-size", "64",
                "--table-shards", str(table_shards), "--hidden-dim", "8",
                "--epochs", "1"]
        real, sim = cli_lines(argv + ["--spmd"]), cli_lines(
            argv + ["--no-spmd"])
        if real != sim:
            raise AssertionError(f"CLI --spmd {real} != --no-spmd {sim}")
        cases["cli"] = real
    return cases


def train_from(directory: str, device: torch.device) -> Dict:
    """The cases of ``directory/config.json`` (``{"data": synthetic_fb15k
    arguments, "cases": {label: TrainConfig fields}}``), each trained one
    epoch on the multi-process step from the parameters in
    ``directory/{label}_init.npz`` (flat, the port's names, the entity
    table whole), with fresh Adam moments. This rank's parameters after
    the epoch go to ``directory/{label}_rank{rank}.npz``. Returns each
    case's epoch loss and batch count. The initial parameters come from
    another implementation (the reference's trainer, in its test), which
    then holds the results within its tolerance."""
    from repro_torch import convert
    from repro_torch.data import synthetic_fb15k
    from repro_torch.launch.mesh import place_row_blocks
    from repro_torch.training import KGETrainer, TrainConfig

    with open(os.path.join(directory, "config.json")) as f:
        spec = json.load(f)
    splits = synthetic_fb15k(**spec["data"])
    out = {}
    for label, fields in spec["cases"].items():
        tr = KGETrainer(splits, TrainConfig(**fields), device=device)
        if tr.mesh is None:
            raise AssertionError(f"{label}: no process mesh")
        with np.load(os.path.join(directory, f"{label}_init.npz")) as z:
            tr.params = convert.kge_model_from_jax(dict(z), tr.kge_cfg,
                                                   device=device)
        place_row_blocks(tr.params, tr.param_specs, tr.mesh)
        tr.opt_state = tr.optimizer.init(
            {n: p.detach() for n, p in tr.params.named_parameters()})
        rec = tr.train_epoch()
        tr.close()
        np.savez(os.path.join(directory, f"{label}_rank{dist.get_rank()}"),
                 **{n: p.detach().cpu().numpy()
                    for n, p in tr.params.named_parameters()})
        out[label] = {"loss": rec["loss"], "num_batches": rec["num_batches"]}
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--init-method", default="env://")
    ap.add_argument("--world-size", type=int, default=None)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--table-shards", type=int, default=1)
    ap.add_argument("--cli", action="store_true",
                    help="also hold launch.train --spmd against --no-spmd")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--train-from", metavar="DIR", default=None,
                    help="instead of the checks, train the cases of "
                         "DIR/config.json from given parameters "
                         "(train_from)")
    ap.add_argument("--resume", metavar="DIR", default=None,
                    help="instead of the checks, hold checkpoints under "
                         "spmd (check_resume), written under DIR")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        local = os.environ.get("LOCAL_RANK", args.rank or 0)
        device = torch.device("cuda", int(local) % torch.cuda.device_count())
        torch.cuda.set_device(device)
    kw = {} if args.world_size is None else dict(
        world_size=args.world_size, rank=args.rank)
    dist.init_process_group(backend_for(device),
                            init_method=args.init_method, **kw)
    try:
        if args.train_from:
            cases = train_from(args.train_from, device)
        elif args.resume:
            cases = check_resume(device, args.table_shards, args.resume)
        else:
            cases = check_all(device, args.table_shards, args.cli)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print("SPMD_CHECK_OK " + json.dumps(
        {"rank": args.rank, "world": args.world_size,
         "table_shards": args.table_shards, "cases": cases}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
