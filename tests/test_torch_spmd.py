"""The multi-process step over ``torch.distributed`` (gloo ranks on the
CPU) against the simulated step.

Each spawn starts one ``python -m repro_torch.launch.spmd_check`` process
per rank with a ``file://`` rendezvous under the test's ``tmp_path`` and
joins them with a deadline that fails the test instead of hanging it. On
every rank of the ``data`` × ``model`` mesh the module trains a few steps
for every exchange (``psum_scatter``, ``psum``, ``alltoall``) at the fp32
and int8 tables, and a full-graph run through the kernel encoder, and
holds the losses, the parameters and the Adam moments bitwise against the
simulated step (also with the deduplicated gather plan, each rank's
bucket its own trainers', and over a whole epoch on a mesh with a data
axis, each rank building only its own trainers' batches), the test
evaluation (each rank ranking its own row block of the embeddings),
``make_sharded_rank_step`` in both ranking protocols, and (``--cli``)
``launch.train --spmd`` against ``--no-spmd``. The meshes: 2 ranks as (2,
1) and (1, 2), 4 ranks as (2, 2). Against the reference: 2 ranks as (1,
2) and as (2, 1) from ``repro.KGETrainer``'s initial parameters
(``--train-from``), within ``rtol=1e-3, atol=1e-4`` of its spmd trainer
on two forced host devices.

Checkpoints under spmd (``--resume``): 2 ranks as (1, 2) and 4 as (2,
2), a resumed run bitwise the unbroken one, the file == the simulated
trainer's, and the reference's trainer restoring the file.

In this process: the mesh rule, the placement, the per-rank batch
selection, a deduplicated plan's bucket changing no bit of a trainer's
loss and gradients, ``--sharded-transfer`` on the simulated step, the
errors (``spmd=True`` without a process group, a whole matrix given to
the rank step's ranking) and a checkpoint round trip on a 1-rank gloo
group.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from repro.data import synthetic_fb15k as j_synthetic_fb15k
from repro.training import KGETrainer as JKGETrainer
from repro.training import TrainConfig as JTrainConfig

from repro_torch.data import synthetic_fb15k
from repro_torch.data.pipeline import BatchShardings
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import spmd_check
from repro_torch.sharding import SPMD_EXCHANGES
from repro_torch.training import KGETrainer, TrainConfig
from repro_torch.training.checkpoint import tree_leaves_with_path
from repro_torch.training.optimizer import adam, sgd

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
# per spawn, all ranks together: a spawn takes about 7 s alone, and the
# deadline only turns a hang into a failure
DEADLINE_S = 150.0


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs: its tensors are small,
    the suite runs on several workers at once, and their spinning thread
    pools crowd each other out (a step here took 100 times as long under
    load as alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def spawn(tmp_path, world, table_shards, cli=False, extra=()):
    """Run the check on ``world`` gloo ranks; returns each rank's report."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               OMP_NUM_THREADS="1")
    init = f"file://{tmp_path}/rendezvous"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.spmd_check",
         "--device", "cpu", "--init-method", init, "--world-size",
         str(world), "--rank", str(r), "--table-shards", str(table_shards)]
        + (["--cli"] if cli else []) + list(extra),
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    outs = []
    end = time.monotonic() + DEADLINE_S
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(0.1, end - time.monotonic()))
            outs.append((p.returncode, out))
    except subprocess.TimeoutExpired:
        pytest.fail(f"{world} ranks did not finish in {DEADLINE_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    reports = []
    for rc, out in outs:
        assert rc == 0, out[-4000:]
        line = [x for x in out.splitlines() if x.startswith("SPMD_CHECK_OK")]
        assert len(line) == 1, out[-4000:]
        reports.append(json.loads(line[0].split(" ", 1)[1]))
    return reports


@pytest.mark.parametrize("world,table_shards", [(2, 1), (2, 2), (4, 2)])
def test_real_step_bitwise_simulated_over_gloo(tmp_path, world,
                                               table_shards):
    reports = spawn(tmp_path, world, table_shards, cli=world == 2)
    assert [r["rank"] for r in reports] == list(range(world))
    cases = reports[0]["cases"]
    want = {f"minibatch_int8_{ex}" for ex in SPMD_EXCHANGES}
    want |= ({"minibatch_fp32_None"} if table_shards == 1 else
             {f"minibatch_fp32_{ex}" for ex in SPMD_EXCHANGES})
    want |= {"fullgraph_fp32_kernel", "rank_steps"}
    assert want <= set(cases)
    # every rank saw the same losses and metrics
    assert all(r["cases"]["rank_steps"] == cases["rank_steps"] and
               r["cases"]["fullgraph_fp32_kernel"] ==
               cases["fullgraph_fp32_kernel"] for r in reports)
    # the exchanges move the same rows: one trajectory per table dtype
    for dtype in ("fp32", "int8"):
        runs = [v for k, v in cases.items() if k.startswith(
            f"minibatch_{dtype}")]
        assert all(v == runs[0] and len(v) == 2 for v in runs)
    assert set(cases["rank_steps"]) == {
        f"{p}_{d}" for p in ("all-entities", "candidates")
        for d in ("fp32", "int8")}
    # the deduplicated plan (a sharded table's): on the (2, 2) mesh some
    # rank's own bucket is narrower than all trainers' at some step, and
    # the step is bitwise
    assert len(cases["dedup_fp32"]) == spmd_check.DEDUP_STEPS
    assert all(r["cases"]["dedup_fp32"] == cases["dedup_fp32"]
               for r in reports)
    buckets = [r["cases"]["dedup_buckets"] for r in reports]
    assert all(b["whole"] == buckets[0]["whole"] for b in buckets)
    narrower = any(a < w for b in buckets
                   for a, w in zip(b["rank"], b["whole"]))
    assert narrower == (table_shards > 1 and world // table_shards > 1)
    # a whole epoch on a mesh with a data axis, at the whole stream's
    # step count (held inside the check), its first steps the 2-step runs'
    if world // table_shards > 1:
        epoch = cases["epoch_fp32"]
        assert len(epoch) > 2 and all(r["cases"]["epoch_fp32"] == epoch
                                      for r in reports)
        assert epoch[:2] == cases[next(k for k in cases if k.startswith(
            "minibatch_fp32"))]
    else:
        assert "epoch_fp32" not in cases
    if world == 2:
        assert len(cases["cli"]) == 2 and "test_mrr" in cases["cli"][1]
        assert reports[1]["cases"]["cli"] == []      # rank 1 prints nothing


# The reference's trainer on two forced host devices (a (1, 2) mesh): its
# initial parameters, flattened to the port's names, and its parameters
# after one epoch go to DIR; its epoch losses to stdout.
_REFERENCE_SCRIPT = """
import json, sys
import jax, numpy as np
assert jax.device_count() == 2, jax.devices()
from repro.data import synthetic_fb15k
from repro.training import KGETrainer, TrainConfig
from repro_torch.convert import flatten_tree
directory = sys.argv[1]
spec = json.load(open(directory + "/config.json"))
splits = synthetic_fb15k(**spec["data"])
out = {}
for label, fields in spec["cases"].items():
    tr = KGETrainer(splits, TrainConfig(**fields))
    s = fields["num_table_shards"]
    assert tr._spmd and dict(tr.mesh.shape) == {"data": 2 // s, "model": s}
    def save(name):
        np.savez(f"{directory}/{label}_{name}", **flatten_tree(
            jax.tree_util.tree_map(np.asarray, tr.params)))
    save("init")
    rec = tr.train_epoch()
    save("final")
    tr.close()
    out[label] = {"loss": rec["loss"], "num_batches": rec["num_batches"]}
print("REFERENCE " + json.dumps(out))
"""
LOSS_TOL = dict(rtol=1e-3, atol=1e-4)


def test_real_step_near_reference_over_gloo(tmp_path):
    """The multi-process step on 2 gloo ranks as a (1, 2) mesh, with the
    ``psum_scatter`` exchange at the fp32 and int8 tables, and as a (2, 1)
    mesh (a dense table, each rank building and running one trainer's
    batches), against ``repro.KGETrainer(spmd=True)`` on a forced 2-device
    mesh from the reference's initial parameters at dropout 0: each
    rank's epoch loss, and its parameters (its row block of a sharded
    entity table), within ``rtol=1e-3, atol=1e-4`` of the reference's,
    and moved from the start by more than that."""
    base = dict(num_trainers=2, epochs=1, hidden_dim=8, batch_size=64,
                num_negatives=1, learning_rate=0.01, seed=0, dropout=0.0,
                num_table_shards=2, gather_exchange="psum_scatter",
                spmd=True)
    cases = {d: dict(base, table_dtype=d) for d in ("fp32", "int8")}
    cases["fp32_data2"] = dict(base, num_table_shards=1,
                               gather_exchange=None)
    spec = {"data": {"scale": 0.01, "seed": 3}, "cases": cases}
    (tmp_path / "config.json").write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               JAX_PLATFORMS="cpu", XLA_FLAGS=(os.environ.get(
                   "XLA_FLAGS", "") + " --xla_force_host_platform_device_"
                   "count=2").strip())
    try:
        proc = subprocess.run(
            [sys.executable, "-c", _REFERENCE_SCRIPT, str(tmp_path)],
            env=env, capture_output=True, text=True, timeout=DEADLINE_S)
    except subprocess.TimeoutExpired:
        pytest.fail(f"the reference did not finish in {DEADLINE_S} s")
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    line = [x for x in proc.stdout.splitlines() if x.startswith("REFERENCE")]
    want = json.loads(line[0].split(" ", 1)[1])
    reports = spawn(tmp_path, 2, 2, extra=["--train-from", str(tmp_path)])
    for r, report in enumerate(reports):
        got = report["cases"]
        assert set(got) == set(want) == set(cases)
        for label in want:
            sharded = cases[label]["num_table_shards"] > 1
            assert got[label]["num_batches"] == want[label]["num_batches"]
            np.testing.assert_allclose(got[label]["loss"],
                                       want[label]["loss"], **LOSS_TOL)
            assert got[label]["loss"] == reports[0]["cases"][label]["loss"]
            with np.load(tmp_path / f"{label}_init.npz") as z:
                start = dict(z)
            with np.load(tmp_path / f"{label}_final.npz") as z:
                final = dict(z)
            with np.load(tmp_path / f"{label}_rank{r}.npz") as z:
                mine = dict(z)
            assert set(mine) == set(final)
            for name, p in mine.items():
                # a row-sharded entity table: this rank's block
                block = (lambda a: a[r:r + 1]) if sharded and \
                    name == "entity_embedding" else (lambda a: a)
                assert not np.allclose(p, block(start[name]), **LOSS_TOL), \
                    (label, name)
                np.testing.assert_allclose(p, block(final[name]),
                                           err_msg=f"{label} {name}",
                                           **LOSS_TOL)


# ---------------------------------------------------------------------- #
# In this process
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("trainers,shards,world,want", [
    (4, 1, 1, (1, 1)), (4, 1, 2, (2, 1)), (4, 2, 2, (1, 2)),
    (4, 2, 4, (2, 2)), (4, 4, 4, (1, 4)), (2, 1, 4, None),
    (3, 1, 2, None), (4, 4, 2, None), (6, 2, 6, (3, 2)),
])
def test_fit_spmd_mesh(trainers, shards, world, want):
    assert mesh_lib.fit_spmd_mesh(trainers, shards, world) == want


def test_importing_the_mesh_starts_no_process_group():
    import importlib
    importlib.reload(mesh_lib)
    assert not dist.is_initialized()
    assert mesh_lib.world_size() == 1
    assert mesh_lib.backend_for(torch.device("cpu")) == "gloo"
    assert mesh_lib.backend_for(torch.device("cuda")) == "nccl"


def test_placement_specs_and_row_blocks():
    tr = KGETrainer(synthetic_fb15k(scale=0.01, seed=3), TrainConfig(
        num_trainers=2, hidden_dim=8, batch_size=64, num_table_shards=2),
        device="cpu")
    specs = mesh_lib.kge_param_specs(tr.params, 2)
    assert specs["entity_embedding"] == mesh_lib.ROW_BLOCK
    assert all(v == mesh_lib.REPLICATED for k, v in specs.items()
               if k != "entity_embedding")
    with pytest.raises(ValueError, match="model axis has 4 ranks"):
        mesh_lib.kge_param_specs(tr.params, 4)
    opt = mesh_lib.derive_opt_state_specs(tr.opt_state, specs)
    assert opt.step == mesh_lib.REPLICATED and opt.mu == specs == opt.nu
    plain = sgd(0.1).init({"entity_embedding": torch.zeros(2)})
    assert mesh_lib.derive_opt_state_specs(plain, specs).mu is None
    moments = adam(0.1).init({"w": torch.zeros(2)})
    assert mesh_lib.derive_opt_state_specs(moments, specs).mu == {
        "w": mesh_lib.REPLICATED}
    full = tr.params.entity_embedding.detach().clone()
    fake = mesh_lib.ProcessMesh(1, 2, 1, None, None)
    assert (fake.data_index, fake.model_index) == (0, 1)
    assert fake.trainers(4) == slice(0, 4)
    mesh_lib.place_row_blocks(tr.params, specs, fake)
    assert torch.equal(tr.params.entity_embedding, full[1:2])
    tr.close()


def test_batch_shardings_select_this_ranks_blocks():
    rng = np.random.default_rng(0)
    arrays = {"src": rng.integers(0, 9, (4, 5)),
              "shard_local_ids": rng.integers(0, 9, (4, 2, 5)),
              "shard_owned": rng.random((4, 2, 5)) < .5,
              "num_core_vertices": np.arange(4)}
    assert all(v is arrays[k] or np.array_equal(v, arrays[k])
               for k, v in BatchShardings().select(arrays).items())
    got = BatchShardings(2, 2, 1, 0).select(arrays)
    np.testing.assert_array_equal(got["src"], arrays["src"][2:])
    np.testing.assert_array_equal(got["shard_local_ids"],
                                  arrays["shard_local_ids"][2:, :1])
    np.testing.assert_array_equal(got["shard_owned"],
                                  arrays["shard_owned"][2:, :1])
    np.testing.assert_array_equal(got["num_core_vertices"], [2, 3])
    from repro_torch.sharding import ShardedTableLayout
    with pytest.raises(ValueError, match="3 partitions"):
        BatchShardings(2, 1).check(3, None)
    with pytest.raises(ValueError, match="3 table shards"):
        BatchShardings(1, 2).check(2, ShardedTableLayout(10, 3))


@pytest.mark.parametrize("table_dtype,exchange", [
    ("fp32", "fused"), ("fp32", "masked_sum"), ("int8", None)])
def test_dedup_bucket_changes_no_bit(table_dtype, exchange):
    """A deduplicated gather plan padded to a wider bucket (64 more
    columns of the sentinel id, which no shard owns and ``inverse`` never
    points at) gives every trainer bitwise the same loss, aux metrics and
    gradients: so a rank may pad its own trainers' rows to their own
    bucket, with no message to agree on one."""
    from repro_torch.analysis.programs import first_batch
    from repro_torch.training.distributed import trainer_grads
    tr = KGETrainer(synthetic_fb15k(scale=0.01, seed=3), TrainConfig(
        num_trainers=2, hidden_dim=8, batch_size=64, num_table_shards=2,
        gather_dedup=True, gather_exchange=exchange,
        table_dtype=table_dtype, pipeline="serial"), device="cpu")
    batch = first_batch(tr)
    tr.close()
    ids, owned = batch["shard_local_ids"], batch["shard_owned"]
    pad = ids.shape[:-1] + (64,)
    wide = dict(batch, shard_local_ids=torch.cat(
        [ids, torch.zeros(pad, dtype=ids.dtype)], -1), shard_owned=torch.cat(
        [owned, torch.zeros(pad, dtype=torch.bool)], -1))

    def bits(b):
        out = []
        for loss, aux, grads in trainer_grads(tr._minibatch_loss, tr.params,
                                              b, tr.step_generators(1, 0)):
            out += [loss, *(aux[k] for k in sorted(aux)), *grads]
        return [t.reshape(-1).view(torch.int32) for t in out]

    narrow, padded = bits(batch), bits(wide)
    assert len(narrow) == len(padded)
    assert all(torch.equal(a, b) for a, b in zip(narrow, padded))


def test_rank_step_ranking_refuses_a_whole_matrix(one_rank_group):
    """``sharded_ranking_metrics`` with a ``rank_step`` ranks this rank's
    row block of a ``num_entities``-row table: a whole ``(N, d)`` matrix,
    a block of the wrong rows or a missing ``num_entities`` is refused,
    not sliced."""
    from repro_torch.eval.ranking import CSRFilterIndex
    from repro_torch.eval.sharded import (
        make_sharded_rank_step, sharded_ranking_metrics,
    )
    from repro_torch.sharding.embedding import ModelAxis
    group = dist.new_group([0])
    step = make_sharded_rank_step(ModelAxis(group, 0, 1))
    rng = np.random.default_rng(0)
    emb = torch.from_numpy(rng.standard_normal((30, 4)).astype(np.float32))
    dparams = {"rel_diag": rng.standard_normal((3, 4)).astype(np.float32)}
    test = np.stack([rng.integers(0, 30, 8), rng.integers(0, 3, 8),
                     rng.integers(0, 30, 8)], 1)
    fidx = CSRFilterIndex.build([])
    kw = dict(rank_step=step, device="cpu")
    for table, n, match in ((emb, 30, "row block"),
                            (emb[None, :20], 30, "row block"),
                            (emb[None], None, "num_entities")):
        with pytest.raises(ValueError, match=match):
            sharded_ranking_metrics(table, dparams, test, fidx, 1,
                                    num_entities=n, **kw)
    # the block of a one-rank axis is the whole table: the simulated
    # ranking's metrics
    assert sharded_ranking_metrics(emb[None], dparams, test, fidx, 1,
                                   num_entities=30, **kw) == \
        sharded_ranking_metrics(emb, dparams, test, fidx, 1, device="cpu")


@pytest.mark.parametrize("batch_size", [None, 64])
def test_sharded_transfer_on_the_simulated_step_is_bitwise(batch_size):
    splits = synthetic_fb15k(scale=0.01, seed=3)
    runs = []
    for transfer in (False, True):
        tr = KGETrainer(splits, TrainConfig(
            num_trainers=2, hidden_dim=8, batch_size=batch_size, epochs=1,
            num_table_shards=2, sharded_transfer=transfer,
            pipeline="serial"), device="cpu")
        runs.append((tr, [h["losses"] for h in tr.fit()]))
        tr.close()
    (a, la), (b, lb) = runs
    assert la == lb and a.mesh is None and b.mesh is None
    for (n, p), (_, q) in zip(a.params.named_parameters(),
                              b.params.named_parameters()):
        assert torch.equal(p, q), n


def test_spmd_true_without_a_process_group_raises():
    splits = synthetic_fb15k(scale=0.01, seed=3)
    with pytest.raises(ValueError, match="spmd=True needs an initialised "
                                         "process group"):
        KGETrainer(splits, TrainConfig(spmd=True), device="cpu")
    # None and False keep the simulated step
    for spmd in (None, False):
        tr = KGETrainer(splits, TrainConfig(num_trainers=2, hidden_dim=8,
                                            spmd=spmd), device="cpu")
        assert tr.mesh is None


@pytest.fixture
def one_rank_group(tmp_path):
    """A gloo process group of one rank in this process."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_one_rank_mesh_steps_and_refuses_checkpoints(one_rank_group,
                                                     tmp_path):
    """On a 1 x 1 mesh: the real step == the simulated one for the int8
    table (its exchange runs on the one rank), spmd=None stays simulated
    on one rank, an exchange the spmd step lacks is refused, and a
    checkpoint under spmd (refused before checkpoints of the spmd step
    were ported) round-trips: the file == the simulated trainer's, and a
    new spmd trainer restores it (epoch and seed scrambled first) to every
    parameter, Adam moment and the step counter bitwise, the epoch and
    the seed."""
    splits = synthetic_fb15k(scale=0.01, seed=3)
    cfg = TrainConfig(num_trainers=2, hidden_dim=8, batch_size=64,
                      table_dtype="int8", gather_exchange="alltoall")
    out = spmd_check.compare_training(splits, cfg, torch.device("cpu"))
    real, sim = out["trainers"]
    assert real.mesh.shape == {"data": 1, "model": 1}
    assert len(out["real"]["losses"]) == 2
    assert KGETrainer(splits, dataclasses.replace(cfg, gather_exchange=None),
                      device="cpu").mesh is None
    with pytest.raises(ValueError, match="not available on the spmd step"):
        KGETrainer(splits, dataclasses.replace(cfg, spmd=True,
                                               gather_exchange="fused"),
                   device="cpu")
    path = real.save_checkpoint(str(tmp_path / "spmd"))
    assert path == str(tmp_path / "spmd" / "ckpt_00000000.npz")
    sim_path = sim.save_checkpoint(str(tmp_path / "sim"))
    assert spmd_check.checkpoint_mismatches(path, sim_path) == []
    fresh = KGETrainer(splits, dataclasses.replace(cfg, spmd=True),
                       device="cpu")
    fresh._epoch, fresh._seed = 5, 999
    assert fresh.restore(path) == 0 and fresh._seed == real._seed
    assert spmd_check.tree_mismatches(fresh, real) == []
    fresh.close()


@pytest.mark.parametrize("world,table_shards", [(2, 2), (4, 2)])
def test_spmd_checkpoints_over_gloo(tmp_path, world, table_shards):
    """Checkpoints under spmd on every rank (``spmd_check --resume``, fp32
    and int8): epoch 2 resumed from an epoch-1 checkpoint bitwise the
    unbroken run, the file == the simulated trainer's, and an fp32
    checkpoint of the simulated trainer at 4 shards resumed on the 2-shard
    mesh bitwise too. Here: the ranks agree, the spmd file == each rank's
    simulated file, and the reference's trainer restores the spmd file
    (the cross-package restore) to its arrays bitwise."""
    directory = tmp_path / "ckpt"
    reports = spawn(tmp_path, world, table_shards,
                    extra=["--resume", str(directory)])
    cases = reports[0]["cases"]
    assert all(r["cases"] == cases for r in reports)
    assert set(cases) == {"fp32", "int8"}
    assert cases["fp32"]["wide_losses"] == cases["fp32"]["losses"]
    for dtype, case in cases.items():
        path = case["path"]
        assert path == str(directory / dtype / "spmd" / "ckpt_00000001.npz")
        for r in range(world):
            sim = directory / dtype / f"sim_rank{r}" / "ckpt_00000001.npz"
            assert spmd_check.checkpoint_mismatches(path, str(sim)) == []
        jtr = JKGETrainer(j_synthetic_fb15k(scale=0.01, seed=3),
                          JTrainConfig(num_trainers=4, hidden_dim=8,
                                       batch_size=256, seed=0,
                                       num_table_shards=table_shards,
                                       table_dtype=dtype))
        assert jtr.restore(path) == 1
        restored = dict(tree_leaves_with_path(jax.tree_util.tree_map(
            np.asarray, {"params": jtr.params, "opt": jtr.opt_state})))
        jtr.close()
        with np.load(path) as z:
            arrays = dict(z)
        assert set(restored) == set(arrays)
        for k, a in arrays.items():
            assert restored[k].dtype == a.dtype and \
                np.array_equal(restored[k], a), (dtype, k)
