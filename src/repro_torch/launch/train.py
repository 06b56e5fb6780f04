"""KGE training CLI (port of the KGE half of ``repro/launch/train.py``).

``--arch rgcn-fb15k237`` runs the paper's distributed KGE training
(partition → expand → full edge batch, or edge mini-batches with
``--batch-size``, per trainer → gradient mean → Adam) at a ``--scale`` of
the synthetic FB15k-237 stand-in (or real files under ``--data-root``),
then the filtered test evaluation. ``--table-shards`` row-shards the
entity table (the simulated exchange, ``--gather-exchange fused`` or
``masked_sum``; ``--gather-dedup`` dedupes mini-batch gather plans), and
the ranking is then sharded over its row blocks. ``--table-dtype int8``
trains the fp32 master through the quantized gather and ranks over the
int8 table (sharded ranking, one shard included). The flags are the
reference's, plus ``--device`` (default ``cuda``; ``cpu`` runs the
kernels' plain versions). ``--arch rgcn-citation2`` (feature-mode
mini-batches), the LM architectures, and the reference's options the port
has not reached raise ``NotImplementedError`` naming their ROADMAP item.

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
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional, Sequence

from repro_torch.roadmap import not_ported


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    from repro_torch.models.decoders import registered_decoders

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--trainers", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=10)
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
                    help="per-device batch placement (not ported: raises)")
    ap.add_argument("--gather-dedup", action="store_true",
                    help="dedupe sharded-gather plans per trainer row in "
                         "the collator (bitwise-identical output)")
    ap.add_argument("--spmd", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="the multi-device step (not ported: --spmd "
                         "raises; the default and --no-spmd run the "
                         "simulated step)")
    ap.add_argument("--gather-exchange", default=None,
                    choices=("fused", "masked_sum", "psum", "psum_scatter",
                             "alltoall"),
                    help="sharded-gather exchange layout (default fused; "
                         "the spmd layouts need the multi-process step, "
                         "not ported)")
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
    return ap.parse_args(argv)


def make_trainer(args: argparse.Namespace):
    """The ``KGETrainer`` the CLI trains for ``args`` (raises
    ``NotImplementedError`` for the architectures the port has not
    reached)."""
    if args.arch == "rgcn-citation2":
        raise not_ported("--arch rgcn-citation2 (feature-mode edge "
                         "mini-batches)", "citation2")
    if args.arch != "rgcn-fb15k237":
        raise not_ported(f"--arch {args.arch} (LM training)", "lm_train")

    from repro_torch.configs import RGCN_FB15K237
    from repro_torch.data import load_or_synthesize
    from repro_torch.training import KGETrainer

    cfg = dataclasses.replace(
        RGCN_FB15K237, num_trainers=args.trainers, epochs=args.epochs,
        batch_size=args.batch_size if args.batch_size > 0 else None,
        strategy=args.strategy, use_kernel=args.use_kernel,
        pipeline=args.pipeline, prefetch=args.prefetch,
        num_table_shards=args.table_shards,
        sharded_transfer=args.sharded_transfer,
        gather_dedup=args.gather_dedup,
        gather_exchange=args.gather_exchange,
        table_dtype=args.table_dtype, spmd=args.spmd,
        decoder=args.decoder, num_negatives=args.num_negatives,
        **({"hidden_dim": args.hidden_dim} if args.hidden_dim > 0 else {}))
    splits = load_or_synthesize("fb15k-237", data_root=args.data_root,
                                scale=args.scale)
    return KGETrainer(splits, cfg, device=args.device)


def run(args: argparse.Namespace) -> Dict:
    """Train, then evaluate on the test split; prints the reference's
    per-epoch and ``[eval]`` lines. Returns the trainer, the per-epoch
    history and the test metrics."""
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
    print(f"[train] fb15k-237: {splits['train'].num_edges} train edges, "
          f"{splits['train'].num_entities} entities; "
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
    print(f"[train] simulated step; RF={trainer.replication_factor:.2f}; "
          f"{shape}", flush=True)
    history = trainer.fit(log_fn=lambda r: print(
        f"  epoch {r['epoch']:3d} loss={r['loss']:.4f} "
        f"t={r['t_epoch']:.2f}s (host exposed "
        f"{r['t_get_compute_graph']:.2f}s of {r['t_host_build']:.2f}s, "
        f"overlap {r['overlap_fraction']:.0%})", flush=True))
    trainer.close()
    t0 = time.perf_counter()
    metrics = trainer.evaluate("test")
    rank_mode = (f"{cfg.num_table_shards}-shard ranking"
                 if cfg.num_table_shards > 1 or cfg.table_dtype != "fp32"
                 else "dense ranking")
    if cfg.table_dtype != "fp32":
        rank_mode += f" over the {cfg.table_dtype} table"
    print(f"[eval] {cfg.decoder} decoder, {rank_mode}, "
          f"{len(trainer.partitions)}-partition streamed encode, "
          f"{time.perf_counter() - t0:.2f}s")
    print("[eval]", metrics, flush=True)
    return {"trainer": trainer, "history": history, "metrics": metrics}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
