"""The port's mini-batch input pipelines (``repro_torch.data.pipeline``)
against the JAX package's, on the CPU.

The host batch stream is a deterministic function of (seed, epoch,
partition): the port's stream — negatives, comp graphs, stacked batches,
gather plans with and without dedup — must be ``np.array_equal`` to the
reference's, and the async pipeline's stream bitwise the serial one's,
on the host and after the transfer.
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
from repro_torch.data.pipeline import (
    AsyncMinibatchPipeline, PipelineStats, SerialMinibatchPipeline,
    host_batch, make_input_pipeline, to_device_batch,
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
