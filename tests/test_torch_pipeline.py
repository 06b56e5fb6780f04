"""The port's mini-batch input pipelines (``repro_torch.data.pipeline``)
against the JAX package's, on the CPU.

The host batch stream is a deterministic function of (seed, epoch,
partition): the port's stream — negatives, comp graphs, stacked batches,
gather plans with and without dedup — must be ``np.array_equal`` to the
reference's, and the async pipeline's stream bitwise the serial one's,
on the host and after the transfer.

A rank's pipeline (``BatchShardings`` of a ``data`` × ``model`` mesh, no
process group) builds only its own partitions: its batches are bitwise
the rank's block of the whole pipeline's for a whole epoch (a
deduplicated plan padded to the rank's own bucket), and it stops at the
whole stream's step count even where its own partitions hold more
batches.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import expand_all as j_expand_all
from repro.core import make_synthetic_kg as j_make_synthetic_kg
from repro.core import partition_graph as j_partition_graph
from repro.data.pipeline import SerialMinibatchPipeline as JSerial
from repro.sharding.embedding import ShardedTableLayout as JLayout
from repro_torch.core import (
    expand_all, make_synthetic_kg, partition_graph, plan_budgets,
)
from repro_torch.core.minibatch import num_edge_minibatches
from repro_torch.data.pipeline import (
    AsyncMinibatchPipeline, BatchShardings, PipelineStats,
    SerialMinibatchPipeline, host_batch, make_input_pipeline,
    to_device_batch,
)
from repro_torch.sharding import ShardedTableLayout


def _kgs():
    kw = dict(seed=7)
    return (make_synthetic_kg(300, 10, 2500, **kw).with_inverse_relations(),
            j_make_synthetic_kg(300, 10, 2500, **kw).with_inverse_relations())


@pytest.fixture(scope="module")
def graphs():
    kg, jkg = _kgs()
    parts = expand_all(kg, partition_graph(kg, 2, "vertex_cut", seed=0), 2)
    jparts = j_expand_all(jkg, j_partition_graph(jkg, 2, "vertex_cut",
                                                 seed=0), 2)
    budget = plan_budgets(parts, 32, 1, 2, seed=0)
    return kg, parts, jparts, budget


def _kw(budget, **extra):
    return dict(batch_size=32, num_negatives=1, num_hops=2, budget=budget,
                seed=11, **extra)


def _batches_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.dtype == y.dtype and np.array_equal(x, y), f.name


@pytest.mark.parametrize("num_shards,dedup", [(1, False), (2, False),
                                              (4, True)])
def test_stream_and_plans_equal_reference(graphs, num_shards, dedup):
    """Host batches and their gather plans equal the reference's, epoch by
    epoch (the stream seed ``hash((seed, epoch, i)) % 2**31`` is
    copied)."""
    kg, parts, jparts, budget = graphs
    layout = (ShardedTableLayout(kg.num_entities, num_shards)
              if num_shards > 1 else None)
    jlayout = (JLayout(kg.num_entities, num_shards)
               if num_shards > 1 else None)
    port = SerialMinibatchPipeline(parts, **_kw(budget), table_layout=layout,
                                   dedup_gather=dedup)
    ref = JSerial(jparts, **_kw(budget), table_layout=jlayout,
                  dedup_gather=dedup)
    for epoch in (1, 2):
        got = list(port.epoch_batches(epoch))
        want = list(ref.epoch_batches(epoch))
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            _batches_equal(g, w)
        if layout is not None:
            from repro.sharding.embedding import ShardedGatherPlan
            hb = host_batch(got[0], layout, dedup)
            plan = ShardedGatherPlan.for_stacked(
                jlayout, want[0].gather_global, dedup=dedup)
            np.testing.assert_array_equal(hb["shard_local_ids"],
                                          plan.local_ids)
            np.testing.assert_array_equal(hb["shard_owned"], plan.owned)
            if dedup:
                np.testing.assert_array_equal(hb["shard_inverse"],
                                              plan.inverse)


@pytest.mark.parametrize("num_shards,dedup", [(1, False), (2, True)])
def test_async_equals_serial_on_host_and_device(graphs, num_shards, dedup):
    kg, parts, _, budget = graphs
    layout = (ShardedTableLayout(kg.num_entities, num_shards)
              if num_shards > 1 else None)
    kw = dict(_kw(budget), table_layout=layout, dedup_gather=dedup)
    serial = SerialMinibatchPipeline(parts, **kw)
    asynch = AsyncMinibatchPipeline(parts, prefetch=2, **kw)
    for epoch in (1, 3):
        hs = list(serial.epoch_batches(epoch))
        ha = list(asynch.epoch_batches(epoch))
        assert len(hs) == len(ha) > 0
        for a, b in zip(hs, ha):
            _batches_equal(a, b)
    ds = list(serial.device_batches(2))
    da = list(asynch.device_batches(2))
    assert len(ds) == len(da) > 0
    for a, b in zip(ds, da):
        assert set(a) == set(b)
        assert ("shard_local_ids" in a) == (layout is not None)
        assert ("shard_inverse" in a) == dedup
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    for hb, db in zip(serial.epoch_batches(2), ds):
        for f in dataclasses.fields(hb):
            np.testing.assert_array_equal(db[f.name].numpy(),
                                          getattr(hb, f.name))


def test_stream_is_deterministic_per_epoch(graphs):
    _, parts, _, budget = graphs
    p1 = AsyncMinibatchPipeline(parts, **_kw(budget))
    p2 = AsyncMinibatchPipeline(parts, **_kw(budget))
    for a, b in zip(p1.epoch_batches(5), p2.epoch_batches(5)):
        _batches_equal(a, b)
    e1 = next(iter(p1.epoch_batches(1)))
    e2 = next(iter(p1.epoch_batches(2)))
    assert not np.array_equal(e1.triplets, e2.triplets)


@pytest.mark.parametrize("device_path", [False, True])
def test_worker_error_propagates(graphs, device_path):
    _, parts, _, budget = graphs
    pipe = AsyncMinibatchPipeline(parts, **_kw(budget))
    pipe.partition_stream = lambda epoch, i: (_ for _ in ()).throw(
        RuntimeError("boom"))
    it = pipe.device_batches(1) if device_path else pipe.epoch_batches(1)
    with pytest.raises(RuntimeError, match="pipeline worker failed") as ei:
        list(it)
    causes, exc = [], ei.value
    while exc is not None:
        causes.append(str(exc))
        exc = exc.__cause__
    assert "boom" in causes


def test_async_stats_and_early_stop(graphs):
    _, parts, _, budget = graphs
    pipe = make_input_pipeline("async", parts, **_kw(budget))
    n = sum(1 for _ in pipe.device_batches(1))
    stats = pipe.last_stats
    assert stats.num_batches == n > 1
    assert stats.host_build_s > 0 and stats.warmup_s > 0
    assert 0.0 <= stats.overlap_fraction() <= 1.0
    # a consumer that stops early leaves no worker blocked
    it = pipe.device_batches(2)
    next(it)
    it.close()
    assert pipe.last_stats.num_batches == 1
    assert PipelineStats(host_build_s=1.0,
                         exposed_wait_s=0.25).overlap_fraction() == 0.75


def test_factory_rejects_bad_options(graphs):
    _, parts, _, budget = graphs
    with pytest.raises(ValueError, match="unknown pipeline"):
        make_input_pipeline("turbo", parts, **_kw(budget))
    with pytest.raises(ValueError, match="prefetch"):
        make_input_pipeline("async", parts, prefetch=0, **_kw(budget))
    assert isinstance(make_input_pipeline("serial", parts, **_kw(budget)),
                      SerialMinibatchPipeline)


def test_out_of_table_ids_raise_before_the_transfer(graphs):
    kg, parts, _, budget = graphs
    mb = next(iter(SerialMinibatchPipeline(
        parts, **_kw(budget)).epoch_batches(1)))
    layout = ShardedTableLayout(kg.num_entities, 2)
    batch = to_device_batch(mb, torch.device("cpu"), layout)
    assert batch["shard_local_ids"].shape[:2] == (2, 2)
    mb.gather_global[0, 0] = kg.num_entities
    with pytest.raises(ValueError, match="outside the table"):
        to_device_batch(mb, torch.device("cpu"), layout)


# ---------------------------------------------------------------------- #
# A rank's pipeline: only its own partitions
# ---------------------------------------------------------------------- #
# (num_hops, batch_size): the default, and a shape whose deduplicated
# buckets differ between a rank's trainers and all four (1-hop
# neighbourhoods of 8-edge batches: unique counts near a bucket's edge)
SHAPES = {"default": (2, 64), "dedup": (1, 8)}


@pytest.fixture(scope="module")
def graphs4():
    kg, _ = _kgs()
    out = {}
    for label, (hops, bs) in SHAPES.items():
        parts = expand_all(kg, partition_graph(kg, 4, "vertex_cut", seed=0),
                           hops)
        out[label] = (parts, plan_budgets(parts, bs, 1, hops, seed=0))
    return kg, out


def _pipe(kind, parts, budget, shardings=None, shape="default", **kw):
    hops, bs = SHAPES[shape]
    return make_input_pipeline(kind, parts, batch_size=bs, num_negatives=1,
                               num_hops=hops, budget=budget, seed=11,
                               shardings=shardings, **kw)


@pytest.mark.parametrize("kind", ["serial", "async"])
@pytest.mark.parametrize("data,plan", [
    (2, None), (4, None), (2, "sharded"), (4, "sharded"), (2, "dedup"),
    (4, "dedup")])
def test_rank_pipeline_is_the_whole_pipelines_block(graphs4, kind, data,
                                                    plan):
    """Rank (d, m) of a ``data`` × ``model`` mesh, without a process
    group: every batch of a whole epoch bitwise ``select`` of the whole
    pipeline's (a row-sharded plan split over a 2-rank model axis too).
    A deduplicated plan is padded to the rank's own bucket: its columns
    are the whole plan's first ones, and the whole plan's further columns
    are unowned padding."""
    kg, shapes = graphs4
    shape = "dedup" if plan == "dedup" else "default"
    parts, budget = shapes[shape]
    model = 2 if plan == "sharded" else 1
    kw = dict(shape=shape) if plan is None else dict(
        shape=shape, table_layout=ShardedTableLayout(kg.num_entities, 2),
        dedup_gather=plan == "dedup")
    whole = list(_pipe(kind, parts, budget, **kw).device_batches(1))
    assert len(whole) == min(num_edge_minibatches(p, SHAPES[shape][1])
                             for p in parts) > 1
    narrower = 0
    for d in range(data):
        for m in range(model):
            sh = BatchShardings(data, model, d, m)
            pipe = _pipe(kind, parts, budget, sh, **kw)
            assert list(pipe.own) == list(sh.trainers(4))
            got = list(pipe.device_batches(1))
            assert len(got) == len(whole)
            for g, w in zip(got, whole):
                w = sh.select(w)
                assert set(g) == set(w)
                for k in g:
                    a, b = g[k], w[k]
                    if plan == "dedup" and k in ("shard_local_ids",
                                                 "shard_owned"):
                        # the sentinel id -1: no shard owns it, local 0
                        u = a.shape[-1]
                        narrower += u < b.shape[-1]
                        assert not w["shard_owned"][..., u:].any()
                        assert not w["shard_local_ids"][..., u:].any()
                        b = b[..., :u]
                    assert a.dtype == b.dtype and torch.equal(a, b), k
    if plan == "dedup":
        assert narrower > 0      # some rank's bucket is its own


def test_rank_pipeline_stops_at_the_global_step_count(graphs4):
    """Partitions whose batch counts differ: every rank, serial and
    async, yields the whole stream's zip-shortest count, a rank whose own
    partitions hold more batches included."""
    _, shapes = graphs4
    parts, budget = shapes["default"]
    sizes = [int(p.core_edge_mask.sum()) for p in parts]
    bs = next(b for b in range(16, 129) if len(
        {-(-n // b) for n in sizes}) > 1)
    counts = [num_edge_minibatches(p, bs) for p in parts]
    pipe_kw = dict(_kw(budget), batch_size=bs)
    whole = len(list(zip(*(SerialMinibatchPipeline(
        parts, **pipe_kw).partition_stream(1, i) for i in range(4)))))
    assert whole == min(counts) > 0
    assert any(n > whole for n in counts)
    for kind in ("serial", "async"):
        for d in range(4):
            pipe = make_input_pipeline(kind, parts, shardings=BatchShardings(
                4, 1, d, 0), **pipe_kw)
            assert pipe.num_steps == whole
            assert sum(1 for _ in pipe.epoch_batches(1)) == whole, (kind, d)
            assert pipe.last_stats.num_batches == whole


@pytest.mark.parametrize("kind", ["serial", "async"])
def test_rank_pipeline_streams_only_its_own_partitions(graphs4, kind):
    parts, budget = graphs4[1]["default"]
    for data in (2, 4):
        for d in range(data):
            pipe = _pipe(kind, parts, budget, BatchShardings(data, 1, d, 0))
            seen, stream = [], pipe.partition_stream

            def wrapped(epoch, i, stream=stream, seen=seen):
                seen.append(i)
                return stream(epoch, i)

            pipe.partition_stream = wrapped
            for it in (pipe.epoch_batches(1), pipe.device_batches(2)):
                assert sum(1 for _ in it) == pipe.num_steps
            k = 4 // data
            assert sorted(seen) == sorted(2 * list(range(d * k,
                                                         (d + 1) * k)))
