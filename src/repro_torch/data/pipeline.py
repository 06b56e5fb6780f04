"""Input pipelines (port of ``repro/data/pipeline.py``): host mini-batch
construction decoupled from the device step (paper Fig. 6).

    worker thread (one per partition)
        iterate_edge_minibatches → bounded prefetch queue
    collator
        zip one batch per partition → stack on the trainer axis → gather
        plan (sharded table) → host → device copy
    double buffer
        the copy of batch k+1 runs while the device runs batch k

* ``SerialMinibatchPipeline`` — the reference: builds inline, no overlap.
* ``AsyncMinibatchPipeline`` — one background worker per partition feeding
  a bounded queue, and a collator thread one batch ahead; the stream is
  bitwise the serial one, since each partition owns a deterministic
  per-epoch RNG and the collator zips the queues in partition order.
* ``FullGraphPipeline`` — the full-edge-batch mode (the paper's FB15k-237
  configuration): every padded partition stacked on the trainer axis,
  copied to the device ONCE and reused every epoch.
* ``eval_partition_batches`` — one partition slice of the padded batch at
  a time, for the streamed evaluation encode.

The host → device copy (JAX's double-buffered ``device_put``): the
collator copies each array into pinned host memory and issues a
``non_blocking`` copy on a side CUDA stream, then records an event; the
consumer's stream waits on that event before the step reads the batch,
and ``record_stream`` keeps the allocator from reusing the batch's memory
while the step still reads it. With a row-sharded entity table the
collator also attaches each batch's ``ShardedGatherPlan`` (keys
``shard_local_ids`` / ``shard_owned``, and ``shard_inverse`` when
deduplicated), after checking that every gathered id lies in the table.

Per-rank build (``BatchShardings``, the reference's placement on a
``data`` × ``model`` mesh): on a rank of the multi-process step the
pipeline runs only this rank's trainers' partitions (the data axis's
block, ``ProcessMesh.trainers``), stacks and plans only their rows, and
copies only its own row of the gather plan's shard axis (the model
axis). Each partition's stream depends on (seed, epoch, partition) alone,
so a rank's rows are bitwise those rows of the whole stacked batch; the
ranks of one model group build the same trainers and agree on the
deduplicated plan's bucket without a message (it changes no bit of a
step: padded slots are unowned and ``inverse`` never points at them).
Every partition's batch count is ``ceil(core edges / batch size)``, so
each rank computes the epoch's step count, the zip-shortest over all
partitions, from the partition sizes every rank holds, with no
collective, and stops there even where its own partitions hold more
batches: no rank's collective waits for a step another rank never
takes. On one process (``--sharded-transfer`` on the simulated step) the
mesh is 1 × 1 and the pipeline builds and copies everything: the same
bits, the reference's contract on one device.

Timing contract (``PipelineStats``, the reference's): the steady-state
clock starts at the first consumed batch; ``warmup_s`` is the wait for
it, ``host_build_s`` the build time of consumed batches after it and
``exposed_wait_s`` the wait on the critical path after it.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.expansion import (
    PaddedPartitionBatch, SelfSufficientPartition,
)
from repro_torch.core.minibatch import (
    BatchBudget, EdgeMiniBatch, _PartitionCSR, iterate_edge_minibatches,
    num_edge_minibatches, stack_minibatches,
)
from repro_torch.kernels.rgcn_message import segment_plan_host
from repro_torch.sharding.embedding import (
    PLAN_BATCH_KEYS, ShardedGatherPlan, ShardedTableLayout,
)


@dataclasses.dataclass(frozen=True)
class BatchShardings:
    """What one rank of a ``data`` × ``model`` mesh copies of a stacked
    batch: the trainer axis is split into ``data`` contiguous blocks (the
    reference's ``P(data)``), and the gather plan's shard axis into
    ``model`` blocks as well (``P(data, model)``). ``data_index`` and
    ``model_index`` are this rank's place (``launch.mesh.ProcessMesh``);
    the default is the 1 × 1 mesh of one process, which copies
    everything."""

    data: int = 1
    model: int = 1
    data_index: int = 0
    model_index: int = 0

    @classmethod
    def of(cls, mesh) -> "BatchShardings":
        return cls(mesh.data, mesh.model, mesh.data_index, mesh.model_index)

    def trainers(self, num_partitions: int) -> range:
        """The partitions (trainers) this rank builds and runs: the data
        axis's contiguous block. ``ProcessMesh.trainers`` reads this rule,
        so the step runs exactly the trainers the pipeline built."""
        k = num_partitions // self.data
        return range(self.data_index * k, (self.data_index + 1) * k)

    def check(self, num_partitions: int,
              table_layout: Optional[ShardedTableLayout]) -> None:
        """Fail fast on layouts the mesh cannot split evenly."""
        if num_partitions % self.data:
            raise ValueError(
                f"{num_partitions} partitions cannot be sharded over a "
                f"{self.data}-rank 'data' axis")
        if table_layout is not None and \
                table_layout.num_shards % self.model:
            raise ValueError(
                f"{table_layout.num_shards} table shards cannot be sharded "
                f"over a {self.model}-rank 'model' axis")

    def select(self, arrays: Dict[str, np.ndarray]
               ) -> Dict[str, np.ndarray]:
        """This rank's block of every array stacked over ALL trainers
        (views, no copy): its trainers' rows, then :meth:`select_model`."""
        out = {}
        for key, v in arrays.items():
            r = self.trainers(v.shape[0])
            out[key] = v[r.start:r.stop]
        return self.select_model(out)

    def select_model(self, arrays: Dict[str, np.ndarray]
                     ) -> Dict[str, np.ndarray]:
        """This rank's block of a batch that holds only its own trainers'
        rows (views, no copy): its row of the gather plan's shard axis."""
        out = dict(arrays)
        for key in PLAN_BATCH_KEYS:
            if key in out:
                v = out[key]
                m = v.shape[1] // self.model
                out[key] = v[:, self.model_index * m:
                             (self.model_index + 1) * m]
        return out


@dataclasses.dataclass
class PipelineStats:
    """Per-epoch host-side timing of one pipeline run (the reference's
    contract): ``warmup_s`` is the wait for the first batch,
    ``host_build_s`` / ``exposed_wait_s`` cover the steady state after
    it. On a rank of the multi-process step they count this rank's build
    only: its own trainers' partitions."""

    host_build_s: float = 0.0    # build time of consumed steady-state batches
    exposed_wait_s: float = 0.0  # construction time on the critical path
    warmup_s: float = 0.0        # wait for the first batch (pipeline fill)
    num_batches: int = 0

    def overlap_fraction(self) -> float:
        """Fraction of steady-state host build time hidden behind the
        device step."""
        if self.host_build_s <= 0.0:
            return 0.0
        return max(0.0, 1.0 - self.exposed_wait_s / self.host_build_s)


def padded_fields(padded: PaddedPartitionBatch) -> Dict:
    """The padded batch as a field-name dict of numpy arrays."""
    return {f.name: getattr(padded, f.name)
            for f in dataclasses.fields(padded)}


# per-partition scalars the host reads (the negative sampler's draw limit):
# they stay host tensors, so reading one never waits for the device
HOST_FIELDS = ("num_core_vertices", "num_core_edges")


def to_device(arrays: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """Host numpy arrays → tensors on ``device`` (copied), except the
    ``HOST_FIELDS``, which stay on the host."""
    return {k: torch.as_tensor(v).to("cpu" if k in HOST_FIELDS else device,
                                     copy=True)
            for k, v in arrays.items()}


# ====================================================================== #
# Mini-batch host arrays and their transfer
# ====================================================================== #
def host_batch(mb: EdgeMiniBatch,
               table_layout: Optional[ShardedTableLayout] = None,
               dedup_gather: bool = False) -> Dict[str, np.ndarray]:
    """One stacked mini-batch as a field-name dict of host arrays, with
    its per-shard gather plan when the table is row-sharded (deduplicated
    per trainer row with ``dedup_gather``). A gathered id outside the
    table raises here, before the transfer: the plan clips local ids, so
    the device would never see it."""
    out = {f.name: getattr(mb, f.name) for f in dataclasses.fields(mb)}
    if table_layout is not None:
        g = mb.gather_global
        if g.size and (int(g.min()) < 0 or
                       int(g.max()) >= table_layout.num_rows):
            raise ValueError(
                f"mini-batch gathers entity ids in [{int(g.min())}, "
                f"{int(g.max())}], outside the table's "
                f"{table_layout.num_rows} rows")
        plan = ShardedGatherPlan.for_stacked(table_layout, g,
                                             dedup=dedup_gather)
        out["shard_local_ids"] = plan.local_ids
        out["shard_owned"] = plan.owned
        if plan.inverse is not None:
            out["shard_inverse"] = plan.inverse
    return out


# a transferred batch: its tensors and the copy's event (None on the CPU)
Transferred = Tuple[Dict[str, torch.Tensor], Optional[torch.cuda.Event]]


class BatchTransfer:
    """Host arrays → tensors on ``device``. On a CUDA device the copy goes
    through pinned host memory and a side stream and does not block the
    caller; :meth:`ready` makes the consumer's current stream wait for
    it."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def put(self, arrays: Dict[str, np.ndarray]) -> Transferred:
        if self.stream is None:
            return {k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in arrays.items()}, None
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            tensors = {
                k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                .to(self.device, non_blocking=True)
                for k, v in arrays.items()}
            event = torch.cuda.Event()
            event.record(self.stream)
        return tensors, event

    def ready(self, item: Transferred) -> Dict[str, torch.Tensor]:
        tensors, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in tensors.values():
                t.record_stream(stream)
        return tensors


def to_device_batch(mb: EdgeMiniBatch, device: torch.device,
                    table_layout: Optional[ShardedTableLayout] = None,
                    dedup_gather: bool = False) -> Dict[str, torch.Tensor]:
    """One stacked mini-batch (with its gather plan when the table is
    sharded) as tensors on ``device``, ready for the current stream."""
    transfer = BatchTransfer(device)
    return transfer.ready(transfer.put(
        host_batch(mb, table_layout, dedup_gather)))


# ====================================================================== #
# Mini-batch pipelines (Algorithm 1 inner loop)
# ====================================================================== #
class _MinibatchPipelineBase:
    """Shared state of the serial and async pipelines: the partitions, the
    batch shape, the per-(seed, epoch, partition) streams, the device and
    the sharded table's layout. ``own`` are the partitions this process
    builds (all of them, or its rank's block with ``shardings``);
    ``num_steps`` is the epoch's step count, the fewest batches of any
    partition."""

    def __init__(
        self,
        partitions: Sequence[SelfSufficientPartition],
        batch_size: int,
        num_negatives: int,
        num_hops: int,
        budget: BatchBudget,
        seed: int = 0,
        sampler: str = "constraint",
        csrs: Optional[Sequence[_PartitionCSR]] = None,
        table_layout: Optional[ShardedTableLayout] = None,
        dedup_gather: bool = False,
        device: torch.device = torch.device("cpu"),
        shardings: Optional[BatchShardings] = None,
    ):
        if shardings is not None:
            shardings.check(len(partitions), table_layout)
        self.shardings = shardings
        self.partitions = list(partitions)
        self.own = (range(len(self.partitions)) if shardings is None else
                    shardings.trainers(len(self.partitions)))
        self.num_steps = min(num_edge_minibatches(p, batch_size)
                             for p in self.partitions)
        self.batch_size = batch_size
        self.num_negatives = num_negatives
        self.num_hops = num_hops
        self.budget = budget
        self.seed = seed
        self.sampler = sampler
        self.csrs = list(csrs) if csrs is not None else [
            _PartitionCSR(p) if i in self.own else None
            for i, p in enumerate(self.partitions)]
        self.table_layout = table_layout
        self.dedup_gather = dedup_gather
        self.device = torch.device(device)
        self._stats = PipelineStats()

    @property
    def last_stats(self) -> PipelineStats:
        return self._stats

    def partition_stream(self, epoch: int, i: int) -> Iterator[EdgeMiniBatch]:
        """Partition ``i``'s deterministic batch stream for ``epoch``. The
        RNG derivation is the reference's, so the host draws match it: any
        two pipelines with equal (seed, epoch, i) give equal streams."""
        rng = np.random.default_rng(
            hash((self.seed, epoch, i)) % (2 ** 31))
        return iterate_edge_minibatches(
            rng, self.partitions[i], self.batch_size, self.num_negatives,
            self.num_hops, self.budget, self.csrs[i], self.sampler)

    def _host_batch(self, mb: EdgeMiniBatch) -> Dict[str, np.ndarray]:
        """The arrays this process copies: the stacked batch of its own
        partitions, and with ``shardings`` its row of the plan's shard
        axis."""
        arrays = host_batch(mb, self.table_layout, self.dedup_gather)
        if self.shardings is None:
            return arrays
        return self.shardings.select_model(arrays)

    def close(self) -> None:
        """Workers are per-epoch: nothing to release."""


def _ended(i: int, step: int, steps: int) -> RuntimeError:
    return RuntimeError(f"partition {i}'s stream ended at step {step} of "
                        f"the epoch's {steps}")


class SerialMinibatchPipeline(_MinibatchPipelineBase):
    """Reference implementation: builds each of its partitions' batches
    inline, so all host work is exposed (``overlap_fraction == 0``)."""

    def epoch_batches(self, epoch: int) -> Iterator[EdgeMiniBatch]:
        stats = self._stats = PipelineStats()
        iters = [(i, self.partition_stream(epoch, i)) for i in self.own]
        for step in range(self.num_steps):
            t0 = time.perf_counter()
            mbs = []
            for i, it in iters:
                mb = next(it, None)
                if mb is None:
                    raise _ended(i, step, self.num_steps)
                mbs.append(mb)
            dt = time.perf_counter() - t0
            if stats.num_batches == 0:
                # the serial analogue of pipeline fill: the first batch's
                # build IS its wait
                stats.warmup_s += dt
            else:
                stats.host_build_s += dt
                stats.exposed_wait_s += dt
            stats.num_batches += 1
            yield stack_minibatches(mbs)

    def device_batches(self, epoch: int
                       ) -> Iterator[Dict[str, torch.Tensor]]:
        transfer = BatchTransfer(self.device)
        for mb in self.epoch_batches(epoch):
            yield transfer.ready(transfer.put(self._host_batch(mb)))


class _PipelineError:
    """Sentinel carrying a worker exception to the consumer thread."""

    def __init__(self, exc: BaseException):
        self.exc = exc


_END = object()


def _put(q: "queue.Queue", item, stop: threading.Event) -> bool:
    """Blocking put that gives up when the consumer signalled stop (so
    workers never deadlock on a full queue after early termination)."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.05)
            return True
        except queue.Full:
            continue
    return False


def _get(q: "queue.Queue", stop: threading.Event):
    """Blocking get that resolves to end-of-stream when stop is signalled
    and nothing is left (a producer that aborted on stop puts no
    sentinel)."""
    while True:
        try:
            return q.get(timeout=0.05)
        except queue.Empty:
            if stop.is_set():
                return _END


def _drain(q: "queue.Queue") -> None:
    while True:
        try:
            q.get_nowait()
        except queue.Empty:
            return


class AsyncMinibatchPipeline(_MinibatchPipelineBase):
    """One background worker per partition of its own feeding a bounded
    prefetch queue; ``device_batches`` adds a collator thread that stacks,
    plans and copies the next batch while the device runs the current
    one.

    Yields the bitwise-identical stream to ``SerialMinibatchPipeline``:
    each partition's RNG and batch order live in its own worker, and the
    collator consumes the queues in partition order for the epoch's
    ``num_steps`` steps."""

    def __init__(self, *args, prefetch: int = 2, **kwargs):
        super().__init__(*args, **kwargs)
        if prefetch < 1:
            raise ValueError("prefetch depth must be >= 1")
        self.prefetch = prefetch

    def _start_workers(self, epoch: int, stop: threading.Event):
        queues: List[queue.Queue] = [
            queue.Queue(maxsize=self.prefetch) for _ in self.own]

        def work(j: int, i: int) -> None:
            try:
                it = self.partition_stream(epoch, i)
                while not stop.is_set():
                    t0 = time.perf_counter()
                    try:
                        mb = next(it)
                    except StopIteration:
                        break
                    # the build time travels with the batch: only consumed
                    # batches count toward host_build_s
                    if not _put(queues[j],
                                (mb, time.perf_counter() - t0), stop):
                        return
                _put(queues[j], _END, stop)
            except BaseException as exc:  # propagate into the consumer
                _put(queues[j], _PipelineError(exc), stop)

        threads = [threading.Thread(target=work, args=(j, i),
                                    name=f"pipeline-worker-{i}", daemon=True)
                   for j, i in enumerate(self.own)]
        for t in threads:
            t.start()
        return queues, threads

    @staticmethod
    def _shutdown(stop, queues, threads) -> None:
        stop.set()
        for q in queues:            # unblock workers stuck on a full queue
            _drain(q)
        for t in threads:
            t.join(timeout=5.0)

    def _collate(self, queues, stop: threading.Event):
        """Zip one batch per partition queue (partition order), stacked on
        the trainer axis, for the epoch's ``num_steps`` steps. Yields
        ``(stacked, build_s, wait_s)``."""
        for step in range(self.num_steps):
            mbs = []
            wait = build = 0.0
            for i, q in zip(self.own, queues):
                t0 = time.perf_counter()
                item = _get(q, stop)
                wait += time.perf_counter() - t0
                if isinstance(item, _PipelineError):
                    raise RuntimeError(
                        "input pipeline worker failed") from item.exc
                if item is _END:
                    if stop.is_set():
                        return
                    raise _ended(i, step, self.num_steps)
                mb, dt = item
                build += dt
                mbs.append(mb)
            yield stack_minibatches(mbs), build, wait

    @staticmethod
    def _account(stats: PipelineStats, build: float, wait: float) -> None:
        if stats.num_batches == 0:
            stats.warmup_s += wait
        else:
            stats.host_build_s += build
            stats.exposed_wait_s += wait
        stats.num_batches += 1

    def epoch_batches(self, epoch: int) -> Iterator[EdgeMiniBatch]:
        stats = self._stats = PipelineStats()
        stop = threading.Event()
        queues, threads = self._start_workers(epoch, stop)
        try:
            for mb, build, wait in self._collate(queues, stop):
                self._account(stats, build, wait)
                yield mb
        finally:
            self._shutdown(stop, queues, threads)

    def device_batches(self, epoch: int
                       ) -> Iterator[Dict[str, torch.Tensor]]:
        """Double-buffered host → device path: a collator thread stacks the
        partition batches, attaches the gather plan and issues the copy one
        batch ahead, so the consumer's ``next()`` returns a batch whose
        copy is already queued while the device runs the previous step."""
        stats = self._stats = PipelineStats()
        stop = threading.Event()
        queues, threads = self._start_workers(epoch, stop)
        transfer = BatchTransfer(self.device)
        xfer_q: queue.Queue = queue.Queue(maxsize=2)   # double buffer

        def collate_and_transfer() -> None:
            try:
                for mb, build, _ in self._collate(queues, stop):
                    item = transfer.put(self._host_batch(mb))
                    if not _put(xfer_q, (item, build), stop):
                        return
                _put(xfer_q, _END, stop)
            except BaseException as exc:
                _put(xfer_q, _PipelineError(exc), stop)

        collator = threading.Thread(target=collate_and_transfer,
                                    name="pipeline-collator", daemon=True)
        collator.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = _get(xfer_q, stop)
                wait = time.perf_counter() - t0
                if isinstance(item, _PipelineError):
                    raise RuntimeError(
                        "input pipeline worker failed") from item.exc
                if item is _END:
                    return
                batch, build = item
                # consumed batches only: the collator runs ahead, and
                # batches the consumer never takes must not count
                self._account(stats, build, wait)
                yield transfer.ready(batch)
        finally:
            stop.set()
            _drain(xfer_q)
            collator.join(timeout=5.0)
            self._shutdown(stop, queues, threads)


PIPELINES = {
    "serial": SerialMinibatchPipeline,
    "async": AsyncMinibatchPipeline,
}


def make_input_pipeline(
    kind: str,
    partitions: Sequence[SelfSufficientPartition],
    *,
    batch_size: int,
    num_negatives: int,
    num_hops: int,
    budget: BatchBudget,
    seed: int = 0,
    sampler: str = "constraint",
    csrs: Optional[Sequence[_PartitionCSR]] = None,
    prefetch: int = 2,
    table_layout: Optional[ShardedTableLayout] = None,
    dedup_gather: bool = False,
    device: torch.device = torch.device("cpu"),
    shardings: Optional[BatchShardings] = None,
) -> _MinibatchPipelineBase:
    """A mini-batch input pipeline (``serial`` reference or ``async``
    prefetching) delivering batches on ``device``; ``table_layout`` makes
    every batch carry its gather plan (deduplicated per trainer row with
    ``dedup_gather``); ``shardings`` copies only a rank's block."""
    if kind not in PIPELINES:
        raise ValueError(
            f"unknown pipeline {kind!r}; choose from {sorted(PIPELINES)}")
    kw = dict(batch_size=batch_size, num_negatives=num_negatives,
              num_hops=num_hops, budget=budget, seed=seed, sampler=sampler,
              csrs=csrs, table_layout=table_layout,
              dedup_gather=dedup_gather, device=device, shardings=shardings)
    if kind == "async":
        kw["prefetch"] = prefetch
    return PIPELINES[kind](partitions, **kw)


# ====================================================================== #
# Full-graph pipeline (the paper's FB15k-237 configuration)
# ====================================================================== #
@dataclasses.dataclass(frozen=True)
class PlanSizes:
    """What the resident batch's scatter plans are sized by: the relations
    (rows of a layer's relation table) and the rows of a dense entity
    table (``None``: a feature-mode model or a row-sharded table, whose
    gather the encoder plans in-graph)."""

    num_relations: int
    table_rows: Optional[int] = None


def edge_plans_host(src: np.ndarray, rel: np.ndarray, dst: np.ndarray,
                    edge_mask: np.ndarray, num_vertices: int,
                    num_relations: int) -> Dict[str, np.ndarray]:
    """The packed segment plans of one partition's edges, built on the
    host: the encoder's ``EdgePlans``, ``plan_src`` (heads, masked edges
    left out: the segment sum), ``plan_dst`` and ``plan_rel`` (every edge:
    the scatter-adds of the gathered rows' cotangents)."""
    return {"plan_src": segment_plan_host(src, edge_mask, num_vertices),
            "plan_dst": segment_plan_host(dst, None, num_vertices),
            "plan_rel": segment_plan_host(rel, None, num_relations)}


class FullGraphPipeline:
    """One full-edge batch per epoch, resident on ``device`` (with
    ``shardings``, a rank's block of trainers, the only partitions it
    plans). With a
    row-sharded table the encoder plans the gather in-graph (the plan of
    ``local_to_global`` is the same every epoch). The resident batch also
    carries every partition's edge plans (:func:`edge_plans_host`) and a
    dense table's gradient plan, built once on the host: the edges never
    change, so no step plans them. (A mini-batch's step builds its own, on
    the card: built on the host, the plans slowed the async epoch.)"""

    def __init__(self, padded: PaddedPartitionBatch, device: torch.device,
                 plan_sizes: PlanSizes,
                 shardings: Optional[BatchShardings] = None):
        self.device = torch.device(device)
        h = padded_fields(padded)
        if shardings is not None:
            # this rank's partitions first: only their rows are planned
            shardings.check(padded.num_partitions, None)
            own = shardings.trainers(padded.num_partitions)
            h = {k: v[own.start:own.stop] for k, v in h.items()}
        plans = [edge_plans_host(h["src"][i], h["rel"][i], h["dst"][i],
                                 h["edge_mask"][i],
                                 h["local_to_global"].shape[1],
                                 plan_sizes.num_relations)
                 for i in range(h["src"].shape[0])]
        h.update({k: np.stack([p[k] for p in plans]) for k in plans[0]})
        if plan_sizes.table_rows is not None:
            h["plan_table"] = np.stack([
                segment_plan_host(g, None, plan_sizes.table_rows)
                for g in h["local_to_global"]])
        self._host = h       # no gather plan: nothing on the model axis
        self._device: Optional[Dict[str, torch.Tensor]] = None
        self._stats = PipelineStats()

    @property
    def last_stats(self) -> PipelineStats:
        return self._stats

    def device_batches(self, epoch: int) -> Iterator[Dict[str, torch.Tensor]]:
        """The same batch on the device, copied at the first call only."""
        if self._device is None:
            self._device = to_device(self._host, self.device)
        self._stats = PipelineStats(num_batches=1)
        yield self._device

    def close(self) -> None:
        """Nothing to release."""


def eval_partition_batches(padded: PaddedPartitionBatch,
                           device: torch.device
                           ) -> Iterator[Dict[str, torch.Tensor]]:
    """Per-partition device batches for the evaluation encode: one
    partition slice of the padded batch at a time, so the encoder streams
    partitions instead of one full-graph mega-partition."""
    fields = padded_fields(padded)
    for i in range(padded.num_partitions):
        yield to_device({k: v[i] for k, v in fields.items()}, device)
