"""End-to-end distributed KGE trainer (port of
``repro/training/trainer.py``; paper Algorithm 1 + §4).

The trainer composes four seams, as the reference does:

* ``training.preprocessing`` — partition → expand → pad → budgets;
* ``data.pipeline`` — the resident full-graph batch, copied to the device
  once, or the serial / async edge mini-batch pipeline;
* ``training.distributed`` — the simulated data-parallel step (per-trainer
  gradients, their mean, one Adam step);
* ``training.evaluation`` — streamed encoding + filtered ranking (sharded
  over the entity table's row blocks when it is sharded).

Everything runs on ``device`` (default ``cuda``). Options of the reference
that the port has not reached raise ``NotImplementedError`` naming their
ROADMAP item (``repro_torch.roadmap``). Timing mirrors the paper's Fig. 6
breakdown: ``t_get_compute_graph`` is the host batch construction left on
the critical path, ``t_host_build`` all of it, ``overlap_fraction`` the
share the pipeline hid behind the device step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import KnowledgeGraph
from repro_torch.data.pipeline import FullGraphPipeline, make_input_pipeline
from repro_torch.device import resolve_device
from repro_torch.kernels.sharded_gather import raise_if_flagged
from repro_torch.models.kge import (
    KGEConfig, fullgraph_loss, init_kge_params, minibatch_loss,
)
from repro_torch.models.rgcn import RGCNConfig
from repro_torch.roadmap import not_ported
from repro_torch.sharding.embedding import SIM_EXCHANGES, TABLE_DTYPES
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.distributed import (
    make_simulated_train_step, trainer_generators,
)
from repro_torch.training.evaluation import (
    encode_all_entities, evaluate_split,
)
from repro_torch.training.preprocessing import (
    PreprocessedGraph, preprocess_graph,
)


@dataclasses.dataclass
class TrainConfig:
    """The reference's training configuration; the fields the port has not
    reached must keep their defaults (see :func:`check_ported`)."""

    num_trainers: int = 4
    strategy: str = "vertex_cut"        # paper's choice; Table 5 ablations
    num_hops: int = 2                   # == RGCN layers
    hidden_dim: int = 32
    num_bases: int = 2
    num_negatives: int = 1
    batch_size: Optional[int] = None    # None => full edge batch (FB15k-237)
    learning_rate: float = 0.01
    dropout: float = 0.2
    epochs: int = 30
    negative_sampler: str = "constraint"  # "constraint" | "global"
    decoder: str = "distmult"
    seed: int = 0
    use_kernel: bool = False
    eval_every: int = 0                 # 0 => only at end
    pipeline: str = "async"             # "async" | "serial" (mini-batch)
    prefetch: int = 2                   # per-partition prefetch queue depth
    num_table_shards: int = 1           # >1: row-shard the entity table
    sharded_transfer: bool = False
    gather_dedup: bool = False          # dedupe mini-batch gather plans
    gather_exchange: Optional[str] = None  # "fused" (default) | "masked_sum"
    table_dtype: str = "fp32"           # "fp32" | "int8": int8 keeps the
    #   fp32 master for Adam; every entity-table gather quantizes it and
    #   runs the fused dequantizing gather, with a straight-through backward
    spmd: Optional[bool] = None         # None/False: the simulated step


def check_ported(cfg: TrainConfig) -> None:
    """Raise ``NotImplementedError`` for every option the port has not
    reached, and ``ValueError`` for an exchange the simulated step does
    not have (the reference's check)."""
    if cfg.spmd:
        raise not_ported("spmd=True (the shard_map step)", "spmd")
    if cfg.sharded_transfer:
        raise not_ported("sharded_transfer (per-device batch placement)",
                         "spmd")
    if cfg.gather_exchange is not None and \
            cfg.gather_exchange not in SIM_EXCHANGES:
        raise ValueError(
            f"gather_exchange={cfg.gather_exchange!r} is not available on "
            f"the simulated step (one of {SIM_EXCHANGES}); leave it None "
            f"for the default")


class KGETrainer:
    """Owns the preprocessed data, the model, the optimizer state, the
    input pipeline and the simulated step."""

    def __init__(self, splits: Dict[str, KnowledgeGraph], cfg: TrainConfig,
                 device=None):
        check_ported(cfg)
        self.cfg = cfg
        self.splits = splits
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False  # IEEE fp32
        train_kg = splits["train"].with_inverse_relations()
        self.train_kg = train_kg
        feat = train_kg.features
        if cfg.num_table_shards > 1 and feat is not None:
            raise ValueError(
                "num_table_shards > 1 requires learned entity embeddings "
                "(feature-mode models have no table to shard)")
        if cfg.table_dtype not in TABLE_DTYPES:
            raise ValueError(
                f"table_dtype={cfg.table_dtype!r} not in {TABLE_DTYPES}")
        if cfg.table_dtype == "int8" and feat is not None:
            raise ValueError(
                "table_dtype='int8' requires learned entity embeddings "
                "(feature-mode models have no table to quantize)")

        # ---- offline preprocessing (paper §3.2) ----
        self.pre: PreprocessedGraph = preprocess_graph(
            train_kg, num_trainers=cfg.num_trainers, strategy=cfg.strategy,
            num_hops=cfg.num_hops, seed=cfg.seed,
            batch_size=cfg.batch_size, num_negatives=cfg.num_negatives,
            sampler=cfg.negative_sampler,
            num_table_shards=cfg.num_table_shards)

        # ---- model ----
        self.kge_cfg = KGEConfig(
            rgcn=RGCNConfig(
                num_entities=train_kg.num_entities,
                num_relations=train_kg.num_relations,
                hidden_dim=cfg.hidden_dim,
                num_layers=cfg.num_hops,
                num_bases=cfg.num_bases,
                feature_dim=None if feat is None else feat.shape[1],
                dropout=cfg.dropout,
                use_kernel=cfg.use_kernel,
                num_table_shards=cfg.num_table_shards,
                gather_exchange=cfg.gather_exchange,
                table_dtype=cfg.table_dtype,
            ),
            decoder=cfg.decoder,
            num_negatives=cfg.num_negatives,
            negative_sampler=cfg.negative_sampler,
        )
        self.params = init_kge_params(np.random.default_rng(cfg.seed),
                                      self.kge_cfg, self.device)
        self.features = (None if feat is None else
                         torch.from_numpy(feat).to(self.device))
        self.optimizer = opt_lib.adam(cfg.learning_rate)
        self.opt_state = self.optimizer.init(
            {n: p.detach() for n, p in self.params.named_parameters()})
        self._seed = cfg.seed + 1           # the reference's PRNGKey(seed+1)
        self._epoch = 0
        self.timings: List[Dict[str, float]] = []

        # ---- step + input pipeline ----
        self._fullgraph = cfg.batch_size is None
        self._step = make_simulated_train_step(
            self._fullgraph_loss if self._fullgraph else
            self._minibatch_loss, self.optimizer)
        if self._fullgraph:
            self.pipeline = FullGraphPipeline(self.pre.padded, self.device)
        else:
            self.pipeline = make_input_pipeline(
                cfg.pipeline, self.pre.partitions,
                batch_size=cfg.batch_size,
                num_negatives=cfg.num_negatives, num_hops=cfg.num_hops,
                budget=self.pre.budget, seed=cfg.seed,
                sampler=cfg.negative_sampler, csrs=self.pre.csrs,
                prefetch=cfg.prefetch, table_layout=self.pre.table_layout,
                dedup_gather=cfg.gather_dedup, device=self.device)

    # ------------------------------------------------------------------ #
    # preprocessing artifacts (stable public surface)
    # ------------------------------------------------------------------ #
    @property
    def partitions(self):
        return self.pre.partitions

    @property
    def padded(self):
        return self.pre.padded

    @property
    def replication_factor(self) -> float:
        return self.pre.replication_factor

    @property
    def budget(self):
        return self.pre.budget

    # ------------------------------------------------------------------ #
    def _fullgraph_loss(self, params, batch, generator):
        return fullgraph_loss(params, self.kge_cfg, batch, generator,
                              features=self.features, train=True)

    def _minibatch_loss(self, params, batch, generator):
        return minibatch_loss(params, self.kge_cfg, batch,
                              features=self.features, generator=generator)

    def step_generators(self, epoch: int, step: int):
        """The trainers' generators of one step: per epoch on the
        full-graph path (one step per epoch), per (epoch, step) on the
        mini-batch path."""
        return trainer_generators(self._seed, self.cfg.num_trainers, epoch,
                                  self.device,
                                  None if self._fullgraph else step)

    def step(self, batch: Dict[str, torch.Tensor], generators) -> float:
        """One update on a trainer-stacked device batch; returns the loss
        on the host. Reading the loss waits for the step, and then the
        sharded gathers' bad-slot flag is read, without another wait."""
        self.opt_state, m = self._step(self.params, self.opt_state, batch,
                                       generators)
        loss = float(m["loss"])
        raise_if_flagged(self.device)
        return loss

    def train_epoch(self) -> Dict[str, float]:
        """One epoch: one full-batch update (every trainer's whole
        partition), or one update per stacked mini-batch; each step's time
        ends with its loss on the host."""
        self._epoch += 1
        t_device, losses, nbatches = 0.0, [], 0
        for batch in self.pipeline.device_batches(self._epoch):
            gens = self.step_generators(self._epoch, nbatches)
            t0 = time.perf_counter()
            losses.append(self.step(batch, gens))
            t_device += time.perf_counter() - t0
            nbatches += 1
        stats = self.pipeline.last_stats
        rec = {
            "epoch": self._epoch,
            "loss": float(np.mean(losses)) if losses else float("nan"),
            "losses": losses,
            "t_get_compute_graph": stats.exposed_wait_s,
            "t_host_build": stats.host_build_s,
            "t_warmup": stats.warmup_s,
            "overlap_fraction": stats.overlap_fraction(),
            "t_device_step": t_device,
            "t_epoch": stats.warmup_s + stats.exposed_wait_s + t_device,
            "num_batches": nbatches,
        }
        self.timings.append(rec)
        return rec

    def fit(self, epochs: Optional[int] = None,
            log_fn=None) -> List[Dict[str, float]]:
        history = []
        for _ in range(epochs or self.cfg.epochs):
            rec = self.train_epoch()
            if self.cfg.eval_every and \
                    self._epoch % self.cfg.eval_every == 0:
                rec.update(self.evaluate("valid"))
            history.append(rec)
            if log_fn:
                log_fn(rec)
        return history

    def close(self) -> None:
        self.pipeline.close()

    def save_checkpoint(self, directory: str, keep: int = 3) -> str:
        raise not_ported("save_checkpoint", "checkpoint")

    def restore(self, path: str) -> int:
        raise not_ported("restore", "checkpoint")

    # ------------------------------------------------------------------ #
    def encode_all_entities(self) -> torch.Tensor:
        """Evaluation-time encoder pass over the TRAINING partitions."""
        return encode_all_entities(
            self.params, self.kge_cfg, self.train_kg, self.cfg.num_hops,
            features=self.features, partitions=self.pre.partitions,
            padded=self.pre.padded)

    def evaluate(self, split: str = "test") -> Dict[str, float]:
        """Filtered MRR / Hits@k on ``split``: streamed partition encoding,
        then ranking through the ``kge_score`` kernel, dense or (with a
        sharded or int8 table) one block per shard with the counts
        summed."""
        return evaluate_split(
            self.params, self.kge_cfg, self.splits, split,
            self.cfg.num_hops, self.cfg.decoder, features=self.features,
            partitions=self.pre.partitions, padded=self.pre.padded)
