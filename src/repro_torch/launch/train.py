"""Training CLI (port of ``repro/launch/train.py``): KGE and LM training.

``--arch rgcn-fb15k237`` runs the paper's distributed KGE training
(partition → expand → full edge batch, or edge mini-batches with
``--batch-size``, per trainer → gradient mean → Adam) at a ``--scale`` of
the synthetic FB15k-237 stand-in (or real files under ``--data-root``),
then the filtered test evaluation. ``--table-shards`` row-shards the
entity table (the simulated exchange, ``--gather-exchange fused`` or
``masked_sum``; ``--gather-dedup`` dedupes mini-batch gather plans), and
the ranking is then sharded over its row blocks. ``--table-dtype int8``
trains the fp32 master through the quantized gather and ranks over the
int8 table (sharded ranking, one shard included). ``--arch
rgcn-citation2`` trains the ogbl-citation2 stand-in in feature mode
(128-d input features, edge mini-batches of 4,096 unless ``--batch-size``
says otherwise; a sharded or int8 table is refused, as the reference
refuses it). Every other ``--arch`` trains the LM (:func:`train_lm`):
any of the reference's architectures reduced (``--reduced`` is always
on, as in the reference), ``--steps`` Adam steps of ``--batch`` x
``--seq`` ``TokenStream`` tokens (qwen2-vl with the reference's zero
vision embeddings and 3-D positions, whisper with its zero frame
embeddings). The flags are the reference's, plus
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain versions).

Under ``torchrun`` every rank runs this module: it joins the process group
torchrun describes (NCCL on ``cuda``, one card per rank, gloo on
``cpu``), and with more than one rank, or with ``--spmd``, trains on the
multi-process step over a ``data`` × ``model`` process mesh (model axis
``--table-shards``, ``--gather-exchange psum_scatter`` (default), ``psum``
or ``alltoall``), bitwise the simulated step. Only rank 0 prints.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch rgcn-fb15k237 \\
      --use-kernel --trainers 4 --epochs 3 --scale 1.0
  PYTHONPATH=src python -m repro_torch.launch.train --arch rgcn-fb15k237 \\
      --scale 1.0 --trainers 4 --batch-size 4096 --table-shards 4 \\
      --pipeline async --use-kernel --epochs 1
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch rgcn-fb15k237 --use-kernel --scale 0.01 --epochs 1 \\
      --trainers 2 --hidden-dim 16 --batch-size 64 --table-shards 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch rgcn-fb15k237 \
      --scale 1.0 --trainers 4 --batch-size 4096 --table-shards 4 \
      --table-dtype int8 --use-kernel --epochs 1
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --arch rgcn-citation2 --scale 0.0003 --trainers 2 --epochs 1 \
      --hidden-dim 8 --batch-size 256
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
      --device cpu --spmd --arch rgcn-fb15k237 --scale 0.01 --trainers 2 \
      --batch-size 64 --table-shards 2 --hidden-dim 8 --epochs 1
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --arch rwkv6-3b --steps 3 --batch 2 --seq 16
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time
from typing import Dict, Iterator, List, Optional, Sequence


# --arch -> the dataset it trains on (the reference's two KGE settings)
DATASETS = {"rgcn-fb15k237": "fb15k-237", "rgcn-citation2": "ogbl-citation2"}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    from repro_torch.models.decoders import registered_decoders

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--trainers", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--steps", type=int, default=20,
                    help="LM training steps")
    ap.add_argument("--batch", type=int, default=4,
                    help="LM sequences per step")
    ap.add_argument("--seq", type=int, default=64,
                    help="LM tokens per sequence")
    ap.add_argument("--lr", type=float, default=3e-3,
                    help="LM Adam learning rate")
    ap.add_argument("--batch-size", type=int, default=-1,
                    help="edge mini-batch size (default: full edge "
                         "batch)")
    ap.add_argument("--scale", type=float, default=0.01)
    ap.add_argument("--strategy", default="vertex_cut",
                    choices=("vertex_cut", "edge_cut", "random"))
    ap.add_argument("--pipeline", default="async",
                    choices=("async", "serial"),
                    help="host input pipeline for mini-batch training")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="per-partition prefetch queue depth")
    ap.add_argument("--table-shards", type=int, default=1,
                    help="row-shard the entity table over this many "
                         "shards (1 = dense)")
    ap.add_argument("--sharded-transfer", action="store_true",
                    help="copy each batch per rank of the mesh (always on "
                         "under --spmd; on the simulated step the 1 x 1 "
                         "mesh, bitwise the plain copy)")
    ap.add_argument("--gather-dedup", action="store_true",
                    help="dedupe sharded-gather plans per trainer row in "
                         "the collator (bitwise-identical output)")
    ap.add_argument("--spmd", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="the multi-process step over torch.distributed "
                         "(run under torchrun; default: on when there is "
                         "more than one rank and the mesh fits; --no-spmd "
                         "keeps the simulated step)")
    ap.add_argument("--gather-exchange", default=None,
                    choices=("fused", "masked_sum", "psum", "psum_scatter",
                             "alltoall"),
                    help="sharded-gather exchange layout (simulated step: "
                         "fused (default) or masked_sum; multi-process "
                         "step: psum_scatter (default), psum or alltoall)")
    ap.add_argument("--table-dtype", default="fp32",
                    choices=("fp32", "int8"),
                    help="entity-table storage: int8 keeps the fp32 "
                         "master for Adam and gathers it quantized")
    ap.add_argument("--decoder", default="distmult",
                    choices=registered_decoders(),
                    help="KGE scoring function (the paper trains distmult)")
    ap.add_argument("--num-negatives", type=int, default=1,
                    help="negative samples per positive edge (paper: 1)")
    ap.add_argument("--hidden-dim", type=int, default=-1,
                    help="override the config's hidden dim (fb15k-237's "
                         "paper dim is 75)")
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--use-kernel", action="store_true",
                    help="route the RGCN edge compute through the "
                         "basis_message and segment_sum kernels")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu runs the kernels' plain PyTorch versions")
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="train the LM's reduced configuration (always "
                         "on, as in the reference)")
    return ap.parse_args(argv)


def make_trainer(args: argparse.Namespace):
    """The ``KGETrainer`` the CLI trains for ``args`` (raises
    ``NotImplementedError`` for the architectures the port has not
    reached)."""
    from repro_torch import configs
    from repro_torch.data import load_or_synthesize
    from repro_torch.training import KGETrainer

    name = DATASETS[args.arch]
    base = (configs.RGCN_FB15K237 if name == "fb15k-237"
            else configs.RGCN_CITATION2)
    cfg = dataclasses.replace(
        base, num_trainers=args.trainers, epochs=args.epochs,
        batch_size=args.batch_size if args.batch_size > 0 else
        (None if name == "fb15k-237" else 4096),
        strategy=args.strategy, use_kernel=args.use_kernel,
        pipeline=args.pipeline, prefetch=args.prefetch,
        num_table_shards=args.table_shards,
        sharded_transfer=args.sharded_transfer,
        gather_dedup=args.gather_dedup,
        gather_exchange=args.gather_exchange,
        table_dtype=args.table_dtype, spmd=args.spmd,
        decoder=args.decoder, num_negatives=args.num_negatives,
        **({"hidden_dim": args.hidden_dim} if args.hidden_dim > 0 else {}))
    splits = load_or_synthesize(name, data_root=args.data_root,
                                scale=args.scale)
    return KGETrainer(splits, cfg, device=args.device)


@contextlib.contextmanager
def process_group(device: str) -> Iterator[int]:
    """Join the process group ``torchrun`` describes in the environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``), on the backend of
    ``device``, one card per rank (``LOCAL_RANK``) on ``cuda``, and leave
    it at the end; yields this process's rank (0 outside ``torchrun``, or
    when the caller already joined a group, which is left as it is)."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import backend_for

    launched = all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                             "MASTER_ADDR"))
    if dist.is_initialized() or not launched:
        yield dist.get_rank() if dist.is_initialized() else 0
        return
    if device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend_for(torch.device(device)))
    try:
        yield dist.get_rank()
    finally:
        dist.destroy_process_group()


def run(args: argparse.Namespace, verbose: bool = True) -> Dict:
    """Train, then evaluate on the test split; prints the reference's
    per-epoch and ``[eval]`` lines (``verbose``: on rank 0 only). Returns
    the trainer, the per-epoch history and the test metrics."""
    say = print if verbose else (lambda *a, **k: None)
    trainer = make_trainer(args)
    cfg, splits = trainer.cfg, trainer.splits
    pipe = ("full-graph (resident batch)" if cfg.batch_size is None
            else f"{cfg.pipeline} pipeline, batch {cfg.batch_size}")
    if cfg.gather_dedup:
        pipe += ", deduped gather"
    if cfg.gather_exchange:
        pipe += f", {cfg.gather_exchange} exchange"
    if cfg.table_dtype != "fp32":
        pipe += f", {cfg.table_dtype} table"
    say(f"[train] {DATASETS[args.arch]}: {splits['train'].num_edges} "
        f"train edges, {splits['train'].num_entities} entities; "
        f"{cfg.decoder} decoder, {cfg.num_negatives} negatives/edge; "
        f"{cfg.num_trainers} trainers ({cfg.strategy}, {pipe}, "
        f"{cfg.num_table_shards}-shard entity table); d={cfg.hidden_dim}, "
        f"{'kernel' if cfg.use_kernel else 'plain'} message passing on "
        f"{args.device}", flush=True)
    pad, budget = trainer.padded, trainer.budget
    shape = (f"padded partitions V={pad.padded_vertices} "
             f"E={pad.padded_edges}" if budget is None else
             f"mini-batch budgets V={budget.max_vertices} "
             f"E={budget.max_edges} T={budget.max_triplets}")
    step = ("simulated step" if trainer.mesh is None else
            f"spmd step on a {trainer.mesh.shape} process mesh")
    say(f"[train] {step}; RF={trainer.replication_factor:.2f}; {shape}",
        flush=True)
    history = trainer.fit(log_fn=lambda r: say(
        f"  epoch {r['epoch']:3d} loss={r['loss']:.4f} "
        f"t={r['t_epoch']:.2f}s (host exposed "
        f"{r['t_get_compute_graph']:.2f}s of {r['t_host_build']:.2f}s, "
        f"overlap {r['overlap_fraction']:.0%})", flush=True))
    trainer.close()
    t0 = time.perf_counter()
    metrics = trainer.evaluate("test")
    shards = (cfg.num_table_shards if trainer.mesh is None
              else trainer.mesh.model)
    rank_mode = (f"{shards}-shard ranking"
                 if shards > 1 or cfg.table_dtype != "fp32"
                 or trainer.mesh is not None else "dense ranking")
    if cfg.table_dtype != "fp32":
        rank_mode += f" over the {cfg.table_dtype} table"
    say(f"[eval] {cfg.decoder} decoder, {rank_mode}, "
        f"{len(trainer.partitions)}-partition streamed encode, "
        f"{time.perf_counter() - t0:.2f}s")
    say("[eval]", metrics, flush=True)
    return {"trainer": trainer, "history": history, "metrics": metrics}


def train_lm(args: argparse.Namespace) -> List[float]:
    """LM training, the reference's ``train_lm``: ``args.arch`` (reduced),
    fp32 weights drawn from seed 0, ``adam(args.lr)``, ``args.steps`` steps
    of :func:`~repro_torch.launch.steps.make_train_step` on
    ``TokenStream(vocab, args.batch, args.seq)`` batches. Prints the
    reference's step lines and returns every step's loss; raises if the
    last is not finite."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenStream
    from repro_torch.device import resolve_device
    from repro_torch.launch.steps import make_train_step
    from repro_torch.nn import transformer as T
    from repro_torch.training.optimizer import adam

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    params = T.init_params(cfg, generator=torch.Generator(device=dev)
                           .manual_seed(0), device=dev, dtype=torch.float32)
    optimizer = adam(args.lr)
    opt_state = optimizer.init(dict(T.leaves(params)))
    step = make_train_step(cfg, optimizer)
    print(f"[train] {cfg.name}: {T.count_params(params):,.0f} params",
          flush=True)
    stream = TokenStream(cfg.vocab_size, args.batch, args.seq)
    losses: List[float] = []
    for i in range(args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in next(stream).items()}
        if cfg.arch_type == "vlm":
            batch["vision_embeds"] = torch.zeros(
                (args.batch, args.seq, cfg.vision_dim), device=dev)
            batch["positions"] = torch.arange(args.seq, device=dev)[
                None, :, None].expand(args.batch, args.seq, 3)
        if cfg.arch_type == "encdec":
            batch["audio_frames"] = torch.zeros(
                (args.batch, cfg.encoder_frames, cfg.d_model), device=dev)
        t0 = time.perf_counter()
        params, opt_state, metrics = step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if i % max(args.steps // 10, 1) == 0 or i == args.steps - 1:
            print(f"  step {i:4d} loss={losses[-1]:.4f} "
                  f"({time.perf_counter() - t0:.2f}s)", flush=True)
    if not np.isfinite(losses[-1]):
        raise FloatingPointError("training diverged")
    return losses


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    if not args.arch.startswith("rgcn-"):
        return train_lm(args)
    with process_group(args.device) as rank:
        return run(args, verbose=rank == 0)


if __name__ == "__main__":
    main()
