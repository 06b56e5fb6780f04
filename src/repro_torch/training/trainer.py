"""End-to-end distributed KGE trainer (port of
``repro/training/trainer.py``; paper Algorithm 1 + §4).

The trainer composes four seams, as the reference does:

* ``training.preprocessing`` — partition → expand → pad → budgets;
* ``data.pipeline`` — the resident full-graph batch, copied to the device
  once with its scatter plans (built once on the host, so no full-graph
  step builds its own), or the serial / async edge mini-batch pipeline
  (each mini-batch step builds its plans on the card, once per id array);
  under ``spmd`` each rank builds only its own trainers' batches;
* ``training.distributed`` — the data-parallel step (per-trainer
  gradients, their mean, one Adam step), simulated in this process or,
  under ``spmd``, real: one process per rank of a ``data`` × ``model``
  process mesh (``launch.mesh``), the entity table's row blocks on the
  model ranks;
* ``training.evaluation`` — streamed encoding + filtered ranking (sharded
  over the entity table's row blocks when it is sharded; under ``spmd``
  each rank encodes and ranks only its own row block).

Everything runs on ``device`` (default ``cuda``). Checkpoints are the
reference's files, also under ``spmd`` (the row blocks gathered to one
file and placed back on the ranks). Timing mirrors the paper's Fig. 6
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

from repro_torch import tracing
from repro_torch.convert import kge_tree
from repro_torch.core import KnowledgeGraph
from repro_torch.data.pipeline import (
    BatchShardings, FullGraphPipeline, PlanSizes, make_input_pipeline,
)
from repro_torch.device import resolve_device
from repro_torch.kernels.sharded_gather import raise_if_flagged
from repro_torch.launch.mesh import (
    ROW_BLOCK, derive_opt_state_specs, fit_spmd_mesh, gather_row_blocks,
    kge_param_specs, make_process_mesh, place_row_blocks, row_block,
    world_size,
)
from repro_torch.models.kge import (
    KGEConfig, fullgraph_loss, init_kge_params, minibatch_loss,
)
from repro_torch.models.rgcn import RGCNConfig
from repro_torch.sharding.embedding import (
    SIM_EXCHANGES, SPMD_EXCHANGES, TABLE_DTYPES,
)
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.checkpoint import (
    checkpoint_path, read_metadata, restore_checkpoint, save_checkpoint,
    tree_leaves_with_path,
)
from repro_torch.training.distributed import (
    make_simulated_train_step, make_spmd_train_step, trainer_generators,
)
from repro_torch.training.evaluation import (
    encode_all_entities, encode_entity_block, evaluate_split,
)
from repro_torch.training.preprocessing import (
    PreprocessedGraph, preprocess_graph,
)


@dataclasses.dataclass
class TrainConfig:
    """The reference's training configuration."""

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
    sharded_transfer: bool = False      # copy batches per rank of a mesh
    #   (BatchShardings): on the simulated step the 1 x 1 mesh of one
    #   process, which copies everything (bitwise the plain copy); always
    #   on under spmd
    gather_dedup: bool = False          # dedupe mini-batch gather plans
    gather_exchange: Optional[str] = None  # "fused" (default) | "masked_sum"
    table_dtype: str = "fp32"           # "fp32" | "int8": int8 keeps the
    #   fp32 master for Adam; every entity-table gather quantizes it and
    #   runs the fused dequantizing gather, with a straight-through backward
    spmd: Optional[bool] = None         # the multi-process step over the
    #   initialised process group (training.distributed.
    #   make_spmd_train_step): None = on when the group has more than one
    #   rank and the mesh fits (launch.mesh.fit_spmd_mesh: model axis ==
    #   num_table_shards, data axis divides num_trainers, every rank used);
    #   True forces it (a 1 x 1 mesh allowed) and raises without a group
    #   that fits; False keeps the simulated step. Both are bitwise equal.


def resolve_spmd(cfg: TrainConfig) -> Optional[tuple]:
    """The ``(data, model)`` mesh of the multi-process step for ``cfg``
    over the initialised process group, or ``None`` for the simulated
    step: ``cfg.spmd`` decides, ``None`` choosing the real step when it
    buys parallelism. ``spmd=True`` without a group that fits raises the
    reference's ``ValueError``."""
    world = world_size()
    fit = fit_spmd_mesh(cfg.num_trainers, cfg.num_table_shards, world)
    if cfg.spmd is None:
        return fit if fit is not None and world > 1 else None
    grouped = torch.distributed.is_initialized()
    if cfg.spmd and (fit is None or not grouped):
        raise ValueError(
            f"spmd=True needs an initialised process group whose ranks "
            f"fit the mesh: {max(cfg.num_table_shards, 1)} model-axis "
            f"ranks for {cfg.num_table_shards} table shards and a data "
            f"axis dividing {cfg.num_trainers} trainers, but the world has "
            f"{world} rank(s)" + ("" if grouped else " (no process group)"))
    return fit if cfg.spmd else None


def check_exchange(cfg: TrainConfig, spmd: bool) -> None:
    """Fail fast on an exchange layout the chosen step does not have (the
    reference's check): the simulated step runs ``SIM_EXCHANGES``, the
    multi-process step ``SPMD_EXCHANGES``."""
    allowed = SPMD_EXCHANGES if spmd else SIM_EXCHANGES
    if cfg.gather_exchange is not None and \
            cfg.gather_exchange not in allowed:
        kind = "spmd" if spmd else "simulated"
        raise ValueError(
            f"gather_exchange={cfg.gather_exchange!r} is not available on "
            f"the {kind} step (one of {allowed}); leave it None for the "
            f"default")


class KGETrainer:
    """Owns the preprocessed data, the model, the optimizer state, the
    input pipeline and the step (simulated, or on this rank of a process
    mesh)."""

    def __init__(self, splits: Dict[str, KnowledgeGraph], cfg: TrainConfig,
                 device=None):
        fit = resolve_spmd(cfg)
        check_exchange(cfg, fit is not None)
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

        # ---- the process mesh: each rank keeps its row block; the specs
        # say where each parameter and optimizer leaf lives (None on the
        # simulated step) ----
        self.mesh = self._model_axis = self.param_specs = None
        self.opt_specs = None
        if fit is not None:
            self.mesh = make_process_mesh(*fit, self.device)
            self._model_axis = self.mesh.model_axis
            self.param_specs = kge_param_specs(self.params, self.mesh.model)
            place_row_blocks(self.params, self.param_specs, self.mesh)
        self.optimizer = opt_lib.adam(cfg.learning_rate)
        self.opt_state = self.optimizer.init(
            {n: p.detach() for n, p in self.params.named_parameters()})
        if self.mesh is not None:
            self.opt_specs = derive_opt_state_specs(self.opt_state,
                                                    self.param_specs)
        self._seed = cfg.seed + 1           # the reference's PRNGKey(seed+1)
        self._epoch = 0
        self.timings: List[Dict[str, float]] = []

        # ---- step + input pipeline ----
        self._fullgraph = cfg.batch_size is None
        loss = (self._fullgraph_loss if self._fullgraph else
                self._minibatch_loss)
        shardings = None
        if self.mesh is not None:
            self._step = make_spmd_train_step(loss, self.optimizer,
                                              self.mesh.data_group)
            shardings = BatchShardings.of(self.mesh)
        else:
            self._step = make_simulated_train_step(loss, self.optimizer)
            if cfg.sharded_transfer:
                shardings = BatchShardings()
        if self._fullgraph:
            # a sharded table's gather is planned in-graph
            plan_sizes = PlanSizes(
                train_kg.num_relations,
                train_kg.num_entities if feat is None and
                cfg.num_table_shards <= 1 else None)
            self.pipeline = FullGraphPipeline(self.pre.padded, self.device,
                                              plan_sizes, shardings)
        else:
            self.pipeline = make_input_pipeline(
                cfg.pipeline, self.pre.partitions,
                batch_size=cfg.batch_size,
                num_negatives=cfg.num_negatives, num_hops=cfg.num_hops,
                budget=self.pre.budget, seed=cfg.seed,
                sampler=cfg.negative_sampler, csrs=self.pre.csrs,
                prefetch=cfg.prefetch, table_layout=self.pre.table_layout,
                dedup_gather=cfg.gather_dedup, device=self.device,
                shardings=shardings)

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
                              features=self.features, train=True,
                              model_axis=self._model_axis)

    def _minibatch_loss(self, params, batch, generator):
        return minibatch_loss(params, self.kge_cfg, batch,
                              features=self.features, generator=generator,
                              model_axis=self._model_axis)

    def step_generators(self, epoch: int, step: int):
        """The trainers' generators of one step: per epoch on the
        full-graph path (one step per epoch), per (epoch, step) on the
        mini-batch path; under spmd this rank's trainers' only (the same
        streams the simulated step gives them)."""
        with tracing.span("train.generators"):
            gens = trainer_generators(self._seed, self.cfg.num_trainers,
                                      epoch, self.device,
                                      None if self._fullgraph else step)
        if self.mesh is None:
            return gens
        return gens[self.mesh.trainers(self.cfg.num_trainers)]

    def step(self, batch: Dict[str, torch.Tensor], generators) -> float:
        """One update on a trainer-stacked device batch; returns the loss
        on the host. Reading the loss waits for the step, and then the
        sharded gathers' bad-slot flag is read, without another wait."""
        with tracing.span("train.step"):
            self.opt_state, m = self._step(self.params, self.opt_state,
                                           batch, generators)
            with tracing.span("train.loss_wait"):   # waits for the card
                loss = float(m["loss"])
            with tracing.span("train.flag_check"):
                raise_if_flagged(self.device)
        return loss

    def train_epoch(self) -> Dict[str, float]:
        """One epoch: one full-batch update (every trainer's whole
        partition), or one update per stacked mini-batch; each step's time
        ends with its loss on the host."""
        self._epoch += 1
        t_step, losses, nbatches = 0.0, [], 0
        for batch in self.pipeline.device_batches(self._epoch):
            gens = self.step_generators(self._epoch, nbatches)
            t0 = time.perf_counter()
            losses.append(self.step(batch, gens))
            t_step += time.perf_counter() - t0
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
            "t_step": t_step,       # host wall time of the step calls
            "t_epoch": stats.warmup_s + stats.exposed_wait_s + t_step,
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

    # ------------------------------------------------------------------ #
    # checkpointing: the parameters, the optimizer state and the trainer's
    # own state (the epoch and the generator seed that the per-epoch
    # generators come from), so that a resumed run draws what the run
    # without a break draws
    # ------------------------------------------------------------------ #
    def _checkpoint_tree(self, whole=None) -> Dict:
        """``{"params", "opt"}`` in the reference trainer's layout (the
        reference's parameter tree, ``mu`` and ``nu`` in it too), the
        leaves the trainer's own tensors. Under spmd ``whole`` maps each
        row-block leaf (this rank's block of the entity table and of its
        moments) to its whole-table form."""
        specs = self.param_specs or {}

        def leaves(named):
            return kge_tree(
                (n, whole(t.detach()) if whole is not None and
                 specs.get(n) == ROW_BLOCK else t.detach())
                for n, t in named)

        return {"params": leaves(self.params.named_parameters()),
                "opt": opt_lib.OptState(
                    step=self.opt_state.step,
                    mu=leaves(self.opt_state.mu.items()),
                    nu=leaves(self.opt_state.nu.items()))}

    def save_checkpoint(self, directory: str, keep: int = 3) -> str:
        """One checkpoint per call, stamped with the current epoch, in the
        reference's format: its ``.npz`` keys are the reference trainer's
        (``params/entity_embedding``, ``opt/mu/layers/0/bases``, ...) and
        the manifest's ``metadata`` holds ``epoch`` and ``key``, the raw
        ``PRNGKey(seed + 1)`` the reference trainer holds (``[0, seed +
        1]``), so either trainer resumes the other's run.

        Under spmd every rank calls it: the entity table's row blocks and
        their Adam moments are gathered over the model group
        (``launch.mesh.gather_row_blocks``), rank 0 (data 0, model 0)
        writes the file the simulated trainer writes and prunes old ones
        (``keep``), and every rank returns its path after a barrier."""
        if not 0 <= self._seed < 2 ** 32:
            raise ValueError(f"seed {self._seed - 1} has no [0, seed + 1] "
                             f"key")
        meta = {"epoch": int(self._epoch), "key": [0, int(self._seed)]}
        if self.mesh is None:
            return save_checkpoint(directory, self._epoch,
                                   self._checkpoint_tree(), metadata=meta,
                                   keep=keep)
        tree = self._checkpoint_tree(
            lambda block: gather_row_blocks(block, self.mesh))
        if self.mesh.rank == 0:
            save_checkpoint(directory, self._epoch, tree, metadata=meta,
                            keep=keep)
        torch.distributed.barrier()
        return checkpoint_path(directory, self._epoch)

    def restore(self, path: str) -> int:
        """Resume from a checkpoint of :meth:`save_checkpoint` (or of the
        reference trainer): the values are copied in place into the
        model's parameters and the optimizer state, whose objects the step
        holds (the entity table converts across layouts and shard counts),
        then the epoch and the generator seed come from the metadata.
        Returns the epoch.

        Under spmd every rank reads the file (across hosts ``path`` must
        be on storage every host sees), converts the table to the
        trainer's layout and shard count, and keeps its own row block of
        the table and of its moments (``launch.mesh.row_block``)."""
        like = self._checkpoint_tree(None if self.mesh is None else (
            lambda block: block.new_empty((self.mesh.model,)
                                          + tuple(block.shape[1:]))))
        step, tree = restore_checkpoint(
            path, like, entity_rows=self.train_kg.num_entities)
        _, meta = read_metadata(path)
        key = meta.get("key")
        if key is not None and (len(key) != 2 or key[0] != 0):
            raise ValueError(
                f"checkpoint key {key}: the port's generators come from "
                f"(seed, epoch, trainer[, step]) and continue only a key "
                f"of the form [0, seed + 1]")
        with torch.no_grad():
            for (_, dst), (_, src) in zip(
                    tree_leaves_with_path(self._checkpoint_tree()),
                    tree_leaves_with_path(tree)):
                if dst.shape != src.shape:
                    # a row-block leaf came back whole: this rank's block
                    src = row_block(src, self.mesh)
                dst.copy_(src)
        self._epoch = int(meta.get("epoch", step))
        if key is not None:
            self._seed = int(key[1])
        return self._epoch

    # ------------------------------------------------------------------ #
    def encode_all_entities(self) -> torch.Tensor:
        """Evaluation-time encoder pass over the TRAINING partitions: the
        ``(N, d)`` embeddings (under spmd on every rank of the model
        axis)."""
        return encode_all_entities(
            self.params, self.kge_cfg, self.train_kg, self.cfg.num_hops,
            features=self.features, partitions=self.pre.partitions,
            padded=self.pre.padded, model_axis=self._model_axis)

    def encode_entity_block(self) -> torch.Tensor:
        """Under spmd, this rank's ``(1, rows, d)`` row block of
        :meth:`encode_all_entities`' embeddings, the only rows the rank
        holds at evaluation (``training.evaluation.encode_entity_block``;
        every rank of the model axis calls it)."""
        if self._model_axis is None:
            raise ValueError("the row block of the embeddings is a rank's "
                             "of the multi-process step; the simulated "
                             "trainer encodes them whole")
        return encode_entity_block(
            self.params, self.kge_cfg, self.train_kg, self.cfg.num_hops,
            self._model_axis, features=self.features,
            partitions=self.pre.partitions, padded=self.pre.padded)

    def evaluate(self, split: str = "test") -> Dict[str, float]:
        """Filtered MRR / Hits@k on ``split``: streamed partition encoding,
        then ranking through the ``kge_score`` kernel, dense or (with a
        sharded or int8 table) one block per shard with the counts
        summed; under spmd each rank encodes and ranks only its own row
        block of the embeddings."""
        return evaluate_split(
            self.params, self.kge_cfg, self.splits, split,
            self.cfg.num_hops, self.cfg.decoder, features=self.features,
            partitions=self.pre.partitions, padded=self.pre.padded,
            model_axis=self._model_axis)
