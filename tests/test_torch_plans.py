"""The scatter plans of the port (``kernels.rgcn_message.SegmentPlan``) on
the CPU: a plan built on the host with numpy is the card's
``segment_plan`` array for array; a planned ``scatter_add_onehot`` or
``segment_sum`` is bitwise the unplanned call, and a plan of other ids is
refused; the resident full-graph batch carries the plans of its own ids,
every partition's, and a training step checks every plan it is handed;
mini-batches carry none (their step builds its own on the card). (The kernels that read the plans run only on the card;
chip_smoke.py holds planned against unplanned there, bitwise.)
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (
    expand_all, make_synthetic_kg, partition_graph, plan_budgets,
)
from repro_torch.data import synthetic_fb15k
from repro_torch.data.pipeline import (
    AsyncMinibatchPipeline, FullGraphPipeline, SerialMinibatchPipeline,
)
from repro_torch.kernels import ops
from repro_torch.kernels.rgcn_message import (
    CHUNK, SegmentPlan, segment_plan, segment_plan_host, segment_sum,
)
from repro_torch.kernels.sharded_gather import scatter_add_onehot
from repro_torch.sharding import ShardedTableLayout
from repro_torch.training import KGETrainer, TrainConfig
from repro_torch.training.distributed import trainer_slice


def ids_case(case):
    """(ids, mask or None, number of rows) of one plan case."""
    rng = np.random.default_rng(3)
    if case == "masked":
        ids = rng.integers(0, 50, 700)
        return ids, rng.random(700) < .7, 100       # upper half never hit
    if case == "unmasked hub":
        ids = rng.integers(0, 20, 500)
        ids[rng.random(500) < .5] = 4               # 4 chunks and more
        return ids, None, 20
    if case == "wide keys":                         # above 2**16 rows
        return rng.integers(0, 70000, 300), rng.random(300) < .5, 70000
    if case == "all masked":
        return rng.integers(0, 10, 64), np.zeros(64, bool), 10
    return np.zeros(0, np.int64), np.zeros(0, bool), 5      # no slots


CASES = ["masked", "unmasked hub", "wide keys", "all masked", "empty"]


@pytest.mark.parametrize("case", CASES)
def test_host_plan_equals_device_plan(case):
    """segment_plan_host (numpy, uint16 radix keys below 2**16) equals
    segment_plan (torch) array for array: masked slots under the sentinel
    after every row's slots, each row's slots in ascending order, its
    chunks of CHUNK."""
    ids, mask, rows = ids_case(case)
    packed = segment_plan_host(ids, mask, rows)
    host = SegmentPlan.unpack(torch.from_numpy(packed), rows)
    dev = segment_plan(torch.from_numpy(ids),
                       None if mask is None else torch.from_numpy(mask), rows)
    for a, b in zip(host, dev):
        assert a.dtype == b.dtype == torch.int64 and torch.equal(a, b)
    assert torch.equal(dev.pack(), torch.from_numpy(packed))
    owned = np.ones(len(ids), bool) if mask is None else mask
    n_owned = int(owned.sum())
    assert int(host.offsets[-1]) == n_owned
    perm = host.perm.numpy()
    assert sorted(perm) == list(range(len(ids)))
    assert not owned[perm[n_owned:]].any()          # the sentinel's slots
    counts = np.diff(host.offsets.numpy())
    for v in np.nonzero(counts)[0][:50]:
        span = perm[host.offsets[v]:host.offsets[v + 1]]
        assert (ids[span] == v).all() and (np.diff(span) > 0).all()
    np.testing.assert_array_equal(np.diff(host.chunk_ptr.numpy()),
                                  -(-counts // CHUNK))


@pytest.mark.parametrize("case", CASES)
def test_planned_calls_equal_unplanned_bitwise(case):
    """On the CPU a planned call is the plain version after the plan is
    checked against its ids: the same bits as the unplanned call."""
    ids, mask, rows = ids_case(case)
    rng = np.random.default_rng(4)
    g = torch.from_numpy(rng.normal(size=(len(ids), 6)).astype(np.float32))
    idt = torch.from_numpy(ids)
    mt = None if mask is None else torch.from_numpy(mask)
    plan = SegmentPlan.unpack(torch.from_numpy(
        segment_plan_host(ids, mask, rows)), rows)
    got = scatter_add_onehot(g, idt, mt, rows, plan=plan)
    want = scatter_add_onehot(g, idt, mt, rows)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    m = torch.ones(len(ids), dtype=torch.bool) if mt is None else mt
    seg_plan = segment_plan(idt, m, rows)
    (a, da), (b, db) = (segment_sum(g, idt, m, rows, plan=seg_plan),
                        segment_sum(g, idt, m, rows))
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(da, db)


def test_a_plan_of_other_ids_is_refused():
    ids, mask, rows = ids_case("masked")
    g = torch.zeros((len(ids), 3))
    idt, mt = torch.from_numpy(ids), torch.from_numpy(mask)
    other = segment_plan(torch.from_numpy(np.roll(ids, 1)), mt, rows)
    with pytest.raises(ValueError, match="not the plan of these ids"):
        scatter_add_onehot(g, idt, mt, rows, plan=other)
    unmasked = segment_plan(idt, None, rows)
    with pytest.raises(ValueError, match="not the plan of these ids"):
        segment_sum(g, idt, mt, rows, plan=unmasked)
    wrong_rows = segment_plan(idt, mt, rows + 1)
    with pytest.raises(ValueError, match="segments"):
        scatter_add_onehot(g, idt, mt, rows, plan=wrong_rows)
    # a packed plan survives stacking and slicing on a trainer axis
    stacked = torch.stack([unmasked.pack(), other.pack()])
    got = SegmentPlan.unpack(stacked[1], rows)
    assert all(torch.equal(a, b) for a, b in zip(got, other))


@pytest.fixture(scope="module")
def graphs():
    kg = make_synthetic_kg(300, 10, 2500, seed=7).with_inverse_relations()
    parts = expand_all(kg, partition_graph(kg, 2, "vertex_cut", seed=0), 2)
    budget = plan_budgets(parts, 32, 1, 2, seed=0)
    return kg, parts, budget


@pytest.mark.parametrize("kind", ["serial", "async"])
@pytest.mark.parametrize("num_shards,dedup", [(1, False), (2, False),
                                              (2, True)])
def test_minibatch_batches_carry_no_plans(graphs, kind, num_shards, dedup):
    """A mini-batch's scatter plans are built by its step (on the card, at
    first use, each shared by the layers that scatter over its ids), not
    shipped with the batch: built on the host they slowed the async epoch
    (chip_smoke.py phase 6b). No device batch of either pipeline carries a
    ``plan_*`` key, and the serial and async streams are equal."""
    kg, parts, budget = graphs
    layout = (ShardedTableLayout(kg.num_entities, num_shards)
              if num_shards > 1 else None)
    kw = dict(batch_size=32, num_negatives=1, num_hops=2, budget=budget,
              seed=11, table_layout=layout, dedup_gather=dedup)
    cls = SerialMinibatchPipeline if kind == "serial" else \
        AsyncMinibatchPipeline
    batches = list(cls(parts, **kw).device_batches(1))
    assert len(batches) > 1
    for batch, serial in zip(batches,
                             SerialMinibatchPipeline(parts, **kw)
                             .device_batches(1)):
        assert not [k for k in batch if k.startswith("plan_")]
        assert ("shard_inverse" in batch) == dedup
        assert set(batch) == set(serial)
        assert all(torch.equal(batch[k], serial[k]) for k in batch)


@pytest.mark.parametrize("name", ["src", "dst", "rel"])
def test_edge_plans_take_the_batch_plans(name):
    """EdgePlans hands every layer the packed plan a batch carries for an
    edge array (the resident full-graph batch's); on the CPU an array with
    no plan in the batch gets none (the plain versions take none)."""
    rng = np.random.default_rng(5)
    v, r, e = 40, 6, 300
    src, dst = (torch.from_numpy(rng.integers(0, v, e)) for _ in range(2))
    rel = torch.from_numpy(rng.integers(0, r, e))
    mask = torch.from_numpy(rng.random(e) < .8)
    ids = {"src": (src, mask, v), "dst": (dst, None, v),
           "rel": (rel, None, r)}[name]
    want = segment_plan(*ids)
    plans = ops.EdgePlans.from_batch({f"plan_{name}": want.pack()}, src,
                                     rel, dst, mask, v, r)
    assert all(torch.equal(a, b) for a, b in zip(plans[name], want))
    assert all(plans[k] is None for k in ("src", "dst", "rel") if k != name)


def test_full_graph_pipeline_requires_plan_sizes():
    """The resident batch always carries its plans: the pipeline is not
    made without the sizes they are built to."""
    tr = KGETrainer(synthetic_fb15k(scale=0.01, seed=3), TrainConfig(
        num_trainers=2, epochs=1, hidden_dim=8), device="cpu")
    with pytest.raises(TypeError, match="plan_sizes"):
        FullGraphPipeline(tr.padded, torch.device("cpu"))


@pytest.mark.parametrize("num_shards", [1, 2])
def test_full_graph_batch_carries_its_plans(num_shards):
    """The resident full-graph batch carries every partition's edge plans
    and, for a dense table, its gradient plan, built once on the host (a
    sharded table's gather is planned in-graph)."""
    tr = KGETrainer(synthetic_fb15k(scale=0.01, seed=3), TrainConfig(
        num_trainers=2, epochs=1, hidden_dim=8,
        num_table_shards=num_shards), device="cpu")
    batch = next(iter(tr.pipeline.device_batches(1)))
    r, n = tr.train_kg.num_relations, tr.train_kg.num_entities
    assert ("plan_table" in batch) == (num_shards == 1)
    for i in range(2):
        b = trainer_slice(batch, i)
        v = b["local_to_global"].shape[0]
        want = {"plan_src": segment_plan(b["src"], b["edge_mask"], v),
                "plan_dst": segment_plan(b["dst"], None, v),
                "plan_rel": segment_plan(b["rel"], None, r)}
        if num_shards == 1:
            want["plan_table"] = segment_plan(b["local_to_global"], None, n)
        for k, w in want.items():
            assert torch.equal(b[k], w.pack()), k
    assert isinstance(tr.pipeline, FullGraphPipeline)


def stacked_plans(batch, num_relations, layout):
    """Every trainer's packed plans of a mini-batch, built from its own ids
    (``segment_plan``), stacked as a batch carries them: the comp-graph
    edges' and the sharded table gradient's (flat ``S·rows`` rows)."""
    per = []
    for i in range(batch["comp_src"].shape[0]):
        b = trainer_slice(batch, i)
        v = b["gather_global"].shape[0]
        flat, any_owned = ops.flat_gather_plan(
            b["shard_local_ids"], b["shard_owned"], layout.rows_per_shard)
        per.append({
            "plan_src": segment_plan(b["comp_src"], b["comp_mask"], v),
            "plan_dst": segment_plan(b["comp_dst"], None, v),
            "plan_rel": segment_plan(b["comp_rel"], None, num_relations),
            "plan_table": segment_plan(flat, any_owned,
                                       layout.padded_rows)})
    return {k: torch.stack([p[k].pack() for p in per]) for k in per[0]}


@pytest.mark.parametrize("path", ["fullgraph", "minibatch"])
def test_training_step_checks_every_plan_it_is_handed(path):
    """A training step reads the plans a batch carries (the resident
    full-graph batch's; a mini-batch's when it is handed them): with the
    batch's own plans it trains to the loss it reaches without them (each
    planned call checks its plan on the CPU), and a plan of other ids in
    the batch is refused."""
    cfg = dict(num_trainers=2, epochs=1, hidden_dim=8, seed=1)
    if path == "minibatch":
        cfg.update(batch_size=32, num_table_shards=2)
    tr = KGETrainer(synthetic_fb15k(scale=0.01, seed=3),
                    TrainConfig(**cfg), device="cpu")
    batch = next(iter(tr.pipeline.device_batches(1)))
    if path == "minibatch":
        bare = dict(batch)
        batch = dict(batch, **stacked_plans(
            batch, tr.train_kg.num_relations, tr.pre.table_layout))
        loss_bare, loss_planned = (
            tr._minibatch_loss(tr.params, trainer_slice(b, 0),
                               tr.step_generators(1, 0)[0])[0].item()
            for b in (bare, batch))
        assert loss_bare == loss_planned
    loss = tr.step(batch, tr.step_generators(1, 0))
    assert np.isfinite(loss)
    for key in ("plan_dst", "plan_rel", "plan_src", "plan_table"):
        bad = dict(batch)
        bad[key] = torch.flip(batch[key], dims=(0,))     # trainer 1's plans
        with pytest.raises(ValueError, match="plan"):
            tr.step(bad, tr.step_generators(1, 0))
