"""The comm audit of the port (``repro_torch.analysis``,
``repro_torch.launch.audit``) against the reference's
(``repro.analysis``, ``tests/test_analysis.py``).

Four layers:

* units: ``group_axes`` on rank lists `==` the reference's on the same
  groups; a green trace passes every audit; the report row and table;
* must-fail traces, the counterparts of ``TestAuditViolations``: a stray
  all-gather, a count overflow, a byte overshoot, a replicated ``(V, d)``
  output, a forbidden dimension, a missing required collective, a
  parameter not updated in place, a collective with no group, a recorder
  that saw nothing; and a ``(V, d)`` buffer made only in a backward,
  recorded live;
* the recorder changes nothing: one train step and one test evaluation
  (a one-rank gloo group in this process) and one serve call, bitwise
  with and without it;
* the evaluation program's must-fail trace: the ``(N, d)`` buffer the
  evaluation held before each rank kept only its row block (the whole
  encode, recorded live) is refused by ``eval[all-entities]``'s contract;
* the CLI spawned over gloo (2 ranks on ``psum_scatter``, 4 ranks on the
  full sweep): every program ok on every rank, and each exchange rule's
  bytes `==` the reference's ``expected_bytes`` for the same program
  (``python -m repro.launch.audit --devices 4``); the two differences
  (the data axis gathers, ``rank[candidates]`` sends three all-reduces)
  and ``eval[all-entities]``, which the reference does not have, pinned
  by their own closed forms.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.analysis import group_axes as ref_group_axes
from repro.analysis.contracts import AuditReport as RefAuditReport
from repro.analysis.contracts import CommContract as RefCommContract
from repro_torch.analysis import (
    AuditReport, Collective, CollectiveRule, CommContract, CommRecorder,
    Trace, audit_trace, format_report_table, group_axes,
)
from repro_torch.analysis import programs
from repro_torch.data import synthetic_fb15k
from repro_torch.launch import audit as audit_cli
from repro_torch.training import KGETrainer, TrainConfig

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
DEADLINE_S = 150.0
MESH_2X2 = (("data", 2), ("model", 2))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs (its tensors are small
    and the suite runs on several workers at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


# ---------------------------------------------------------------------- #
# group classification
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("ranks,groups,want", [
    ((0, 1), ((0, 1), (2, 3)), {"model"}),        # minor is model
    ((2, 3), ((0, 1), (2, 3)), {"model"}),
    ((0, 2), ((0, 2), (1, 3)), {"data"}),         # major is data
    ((1, 3), ((0, 2), (1, 3)), {"data"}),
    ((0, 1, 2, 3), ((0, 1, 2, 3),), {"data", "model"}),   # flat spans all
    ((0,), ((0,), (1,), (2,), (3,)), set()),      # singletons span none
    ((3,), ((0,), (1,), (2,), (3,)), set()),
])
def test_group_axes_matches_the_reference(ranks, groups, want):
    assert group_axes(ranks, MESH_2X2) == want
    assert group_axes(ranks, MESH_2X2) == ref_group_axes(groups, MESH_2X2)


# ---------------------------------------------------------------------- #
# hand-built traces: the green path and the must-fail cases
# ---------------------------------------------------------------------- #
def coll(kind, ranks, shape, factor=1.0):
    size = int(np.prod(shape)) * 4
    return Collective(kind=kind, op=f"c10d.{kind}", ranks=ranks,
                      result_bytes=size, wire_bytes=factor * size,
                      shapes=(tuple(shape),))


def green_trace():
    """One psum_scatter-style exchange on the model axis plus a gradient
    all-reduce on the data axis (the reference's green module), the
    parameter kept in place."""
    return Trace(
        collectives=[coll("reduce-scatter", (0, 1), (1, 124, 8)),
                     coll("all-gather", (0, 1), (1, 248, 8)),
                     coll("all-reduce", (0, 2), (1, 100, 8), 2.0)],
        outputs={("aten.mul.Tensor", torch.float32, (1, 100, 8)): 3,
                 ("aten.empty.memory_format", torch.float32, ()): 1},
        in_place={"params/entity_embedding": (64, 64)})


def contract(**overrides):
    base = dict(
        name="snippet", mesh_axes=MESH_2X2,
        rules=(CollectiveRule("reduce-scatter", ("model",),
                              expected_bytes=124 * 8 * 4.0),
               CollectiveRule("all-gather", ("model",),
                              expected_bytes=248 * 8 * 4.0),
               CollectiveRule("all-reduce", ("data",),
                              expected_bytes=2.0 * 100 * 8 * 4)),
        forbidden_suffixes=((200, 8),),
        min_in_place=("params/entity_embedding",))
    base.update(overrides)
    return CommContract(**base)


def test_green_trace_passes_every_audit():
    report = audit_trace(green_trace(), contract())
    assert report.ok, report.violations
    assert [r.count for r in report.rule_results] == [1, 1, 1]
    assert report.n_in_place == 1


def test_report_row_has_the_references_keys():
    row = audit_trace(green_trace(), contract()).as_row()
    assert row["ok"] and row["violations"] == []
    assert row["wire_bytes"] == row["expected_bytes"] \
        == 124 * 8 * 4 + 248 * 8 * 4 + 2 * 100 * 8 * 4
    ref = RefAuditReport("p", RefCommContract("p", MESH_2X2)).as_row()
    donation = {"aliased", "donor", "min_donated"}
    port_only = {"in_place", "min_in_place", "refused", "recorded"}
    assert set(row) == (set(ref) - donation) | port_only
    assert row["rules"][0].keys() == {"rule", "count", "wire_bytes",
                                      "expected_bytes"}
    assert {(r["kind"], tuple(r["ranks"]), r["count"])
            for r in row["recorded"]} == {
        ("reduce-scatter", (0, 1), 1), ("all-gather", (0, 1), 1),
        ("all-reduce", (0, 2), 1)}


def test_degenerate_collective_ignored():
    # a group of one rank moves no bytes: not a stray even with an empty
    # whitelist, but it is recorded
    trace = Trace(collectives=[coll("all-reduce", (3,), (1, 100, 8), 2.0)])
    report = audit_trace(trace, contract(rules=(), min_in_place=(),
                                         min_recorded=1))
    assert report.ok, report.violations
    assert report.as_row()["recorded"][0]["ranks"] == [3]


def test_format_table():
    good = audit_trace(green_trace(), contract())
    moved = green_trace()
    moved.in_place = {"params/entity_embedding": (64, 128)}
    bad = audit_trace(moved, contract())
    refused = audit_trace(green_trace(), contract(
        refused=("replication: the block is the table",)))
    table = format_report_table([good, bad, refused])
    assert "OK" in table and "FAIL" in table
    assert "!! snippet: not updated in place: params/entity_embedding" \
        in table
    assert "-- snippet: refused on this mesh: replication" in table


def violations_of(trace, **overrides):
    report = audit_trace(trace, contract(**overrides))
    assert not report.ok
    return report


def test_stray_all_gather_rejected():
    trace = green_trace()
    trace.collectives.append(coll("all-gather", (0, 2), (1, 248, 8)))
    report = violations_of(trace)
    assert any("stray collective: all-gather" in v and "data" in v
               for v in report.violations)
    assert len(report.stray) == 1


def test_stray_c10d_op_rejected():
    # an op outside the whitelist's kinds keeps its own name
    trace = green_trace()
    trace.collectives.append(coll("c10d.broadcast_.default", (0, 1), (8,)))
    report = violations_of(trace)
    assert any("stray collective: c10d.broadcast_" in v
               for v in report.violations)


def test_count_overflow_rejected():
    trace = green_trace()
    trace.collectives.append(coll("reduce-scatter", (0, 1), (1, 124, 8)))
    report = violations_of(trace)
    assert any("count 2 outside [1, 1]" in v for v in report.violations)


def test_byte_overshoot_rejected():
    # the reduce-scatter result claims the FULL row block instead of the
    # 1/S shard: double the closed-form budget
    trace = green_trace()
    trace.collectives[0] = coll("reduce-scatter", (0, 1), (1, 248, 8))
    report = violations_of(trace)
    assert any("wire bytes 7936 vs closed-form 3968" in v
               for v in report.violations)


def test_replicated_table_buffer_rejected():
    trace = green_trace()
    trace.outputs[("aten.zeros.default", torch.float32, (200, 8))] = 1
    report = violations_of(trace)
    assert any("replicated buffer (200, 8)" in v for v in report.violations)


def test_forbidden_dim_rejected():
    trace = green_trace()
    trace.outputs[("aten.view.default", torch.float32, (7, 200))] = 1
    report = violations_of(trace, forbidden_suffixes=(),
                           forbidden_dims=(200,))
    assert any("replicated buffer (7, 200)" in v for v in report.violations)


def test_forbidden_f32_suffix_spares_int8():
    trace = green_trace()
    trace.outputs[("aten.view.default", torch.int8, (2, 100, 8))] = 1
    assert audit_trace(trace, contract(
        forbidden_f32_suffixes=((2, 100, 8),))).ok
    trace.outputs[("aten.mul.Tensor", torch.float32, (2, 100, 8))] = 1
    report = violations_of(trace, forbidden_f32_suffixes=((2, 100, 8),))
    assert any("(2, 100, 8) torch.float32" in v for v in report.violations)


def test_missing_required_collective_rejected():
    trace = green_trace()
    del trace.collectives[0]
    report = violations_of(trace)
    assert any("reduce-scatter@model: count 0 outside [1, 1]" in v
               for v in report.violations)


def test_parameter_not_updated_in_place_rejected():
    trace = green_trace()
    trace.in_place = {"params/entity_embedding": (64, 128)}
    report = violations_of(trace)
    assert any("not updated in place: params/entity_embedding" in v
               for v in report.violations)
    report = violations_of(green_trace(), min_in_place=(
        "params/entity_embedding", "opt/mu/entity_embedding"))
    assert any("opt/mu/entity_embedding was not watched" in v
               for v in report.violations)


def test_collective_without_a_group_rejected():
    trace = green_trace()
    trace.collectives.append(coll("all-reduce", None, (4,), 2.0))
    report = violations_of(trace)
    assert any("no process group found" in v for v in report.violations)


def test_recorder_that_saw_nothing_rejected():
    report = violations_of(Trace(), rules=(), min_in_place=(),
                           min_recorded=1)
    assert any("the recorder saw nothing" in v for v in report.violations)


class _TableInBackward(torch.autograd.Function):
    """Doubles its input; its backward also makes a ``(200, 8)`` buffer,
    the shape of a replicated table, which the forward never makes."""

    @staticmethod
    def forward(ctx, x):
        return x * 2

    @staticmethod
    def backward(ctx, g):
        full = torch.zeros((200, 8), dtype=g.dtype, device=g.device)
        return g * 2 + full[:g.shape[0]]


def test_backward_buffer_recorded_live():
    """The recorder sees the outputs of a backward: a ``(V, d)`` buffer
    made only there fails the replication audit."""
    x = torch.ones((4, 8), requires_grad=True)
    rules = dict(rules=(), min_in_place=())
    with CommRecorder() as forward_only:
        _TableInBackward.apply(x).sum()
    assert audit_trace(forward_only.trace, contract(**rules)).ok
    with CommRecorder() as rec:
        torch.autograd.grad(_TableInBackward.apply(x).sum(), x)
    report = audit_trace(rec.trace, contract(**rules))
    assert any("replicated buffer (200, 8)" in v and "zeros" in v
               for v in report.violations)


def test_cli_exits_non_zero_on_a_violation(monkeypatch, capsys):
    bad = audit_trace(Trace(), contract(rules=(), min_in_place=(),
                                        min_recorded=1))
    monkeypatch.setattr(programs, "run_audit", lambda **kw: [bad])
    assert audit_cli.main(["--device", "cpu", "--programs", "serve"]) == 1
    assert "audit FAILED" in capsys.readouterr().err


# ---------------------------------------------------------------------- #
# recording changes nothing
# ---------------------------------------------------------------------- #
def test_recorded_collectives_of_a_one_rank_group(tmp_path):
    """The four collectives the port makes, recorded with their kind,
    their group's global ranks and their wire bytes, on a gloo group of
    one rank."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        group = dist.new_group([0])
        x = torch.ones(6)
        out = torch.empty(6)
        with CommRecorder() as rec:
            dist.all_reduce(x, group=group)
            dist.all_gather_into_tensor(out, x)
            dist.reduce_scatter_tensor(out, x, group=group)
            dist.all_to_all_single(out, x, group=group)
            dist.broadcast(x, 0)
    finally:
        dist.destroy_process_group()
    got = [(c.kind, c.ranks, c.wire_bytes) for c in rec.trace.collectives]
    assert got == [("all-reduce", (0,), 48.0), ("all-gather", (0,), 24.0),
                   ("reduce-scatter", (0,), 24.0),
                   ("all-to-all", (0,), 24.0),
                   ("c10d.broadcast_.default", (0,), 24.0)]


def test_recorder_changes_nothing_train_step(tmp_path):
    """One real spmd step (int8 table, so its exchange runs) on a gloo
    group of one rank: ``audit_trainer_step`` runs it recorded and again
    from the same state without the recorder and holds every output
    bitwise; the one-rank contract refuses the replication rule by name
    and still holds the in-place rule and a non-empty record."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        tr = KGETrainer(synthetic_fb15k(scale=0.01, seed=3), TrainConfig(
            num_trainers=2, hidden_dim=8, batch_size=64, table_dtype="int8",
            gather_exchange="psum_scatter", pipeline="serial", spmd=True),
            device="cpu")
        report = programs.audit_trainer_step(tr, "train[one rank,int8]")
        n_params = len(list(tr.params.parameters()))
        tr.close()
    finally:
        dist.destroy_process_group()
    assert report.ok, report.violations
    row = report.as_row()
    # every parameter and its two Adam moments
    assert row["in_place"] == row["min_in_place"] == 3 * n_params
    assert len(row["refused"]) == 1 and "replication" in row["refused"][0]
    kinds = {r["kind"]: r["count"] for r in row["recorded"]}
    # the data group's gather, and the exchange's codes and scales
    assert kinds == {"all-gather": 1 + 2 * 2, "reduce-scatter": 2 * 2}
    assert all(r["ranks"] == [0] for r in row["recorded"])


def _eval_trainer(**kw):
    cfg = programs.AuditConfig()
    return KGETrainer(synthetic_fb15k(scale=programs.EVAL_SCALE, seed=cfg.seed),
                      TrainConfig(num_trainers=cfg.num_trainers,
                                  num_hops=cfg.num_hops,
                                  hidden_dim=cfg.hidden_dim,
                                  batch_size=cfg.batch_size,
                                  pipeline="serial", seed=cfg.seed, **kw),
                      device="cpu")


def test_eval_audit_refuses_the_whole_embedding_matrix():
    """Must fail: the whole ``(N, d)`` embedding matrix that the
    evaluation held on every rank before each kept only its row block
    (``encode_all_entities``, recorded live on a 2-shard table) breaks
    ``eval[all-entities]``'s contract on a 1 x 2 mesh by its replication
    rule."""
    from repro_torch.launch.mesh import ProcessMesh
    tr = _eval_trainer(num_table_shards=2)
    n, d = tr.train_kg.num_entities, tr.cfg.hidden_dim
    with CommRecorder() as rec:
        emb = tr.encode_all_entities()
    tr.close()
    assert tuple(emb.shape) == (n, d)
    contract = programs.eval_contract(tr, "eval[all-entities]",
                                      mesh=ProcessMesh(1, 2, 0, None, None))
    assert contract.forbidden_dims == (n,) and not contract.refused
    report = audit_trace(rec.trace, contract)
    assert any(f"replicated buffer ({n}, {d})" in v
               for v in report.violations), report.violations


def test_eval_audit_on_a_one_rank_group(tmp_path):
    """``eval[all-entities]`` on a gloo group of one rank: the metrics
    bitwise with and without the recorder, the ranking's all-reduces
    recorded on the one-rank group, and the replication rule refused by
    name (the rank's block is the whole table)."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        tr = _eval_trainer(spmd=True)
        report = programs.audit_trainer_eval(tr)
        tr.close()
    finally:
        dist.destroy_process_group()
    assert report.ok, report.violations
    row = report.as_row()
    assert len(row["refused"]) == 1 and "replication" in row["refused"][0]
    t = tr.splits["test"].num_edges
    assert [(r["kind"], r["ranks"], r["count"]) for r in row["recorded"]] \
        == [("all-reduce", [0], 8 * -(-t // programs.EVAL_BATCH))]


def test_hold_unchanged_flags_one_bit():
    report = AuditReport("p", contract())
    a = {"x": torch.tensor([1.0, 2.0])}
    programs._hold_unchanged(report, a, {"x": a["x"].clone()})
    assert report.ok
    b = {"x": torch.tensor([1.0, np.nextafter(np.float32(2), 3)])}
    programs._hold_unchanged(report, a, b)
    assert any("changed the program's outputs: ['x']" in v
               for v in report.violations)


@pytest.mark.parametrize("table_dtype", ["fp32", "int8"])
def test_recorder_changes_nothing_serve_call(table_dtype):
    report = programs.audit_serve_step(table_dtype=table_dtype,
                                       device="cpu")
    assert report.ok, report.violations
    assert report.recorded == {}


# ---------------------------------------------------------------------- #
# the CLI over gloo, and parity with the reference's audit
# ---------------------------------------------------------------------- #
def spawn_audit(directory, world, extra=()):
    """``python -m repro_torch.launch.audit`` on ``world`` gloo ranks;
    returns rank 0's JSON and every rank's output."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               OMP_NUM_THREADS="1")
    out = directory / f"audit{world}.json"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.audit", "--device",
         "cpu", "--quiet", "--init-method", f"file://{directory}/rdv{world}",
         "--world-size", str(world), "--rank", str(r), "--json", str(out)]
        + list(extra), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    end = time.monotonic() + DEADLINE_S
    outs = []
    try:
        for p in procs:
            text, _ = p.communicate(timeout=max(0.1, end - time.monotonic()))
            outs.append((p.returncode, text))
    except subprocess.TimeoutExpired:
        pytest.fail(f"{world} ranks did not finish in {DEADLINE_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return json.loads(out.read_text()) if out.exists() else None, outs


@pytest.fixture(scope="module")
def reference_audit(tmp_path_factory):
    """The reference's audit on a forced 4-device CPU mesh (a 2 x 2 mesh),
    started in the background: its rows by program."""
    d = tmp_path_factory.mktemp("ref_audit")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro.launch.audit", "--devices", "4",
         "--quiet", "--json", str(d / "ref.json")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def rows():
        try:
            text, _ = proc.communicate(timeout=DEADLINE_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            pytest.fail(f"the reference's audit did not finish in "
                        f"{DEADLINE_S} s")
        assert proc.returncode == 0, text[-4000:]
        payload = json.loads((d / "ref.json").read_text())
        return {r["program"]: r for r in payload["comm_audit"]}
    yield rows
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def full_sweep(tmp_path_factory, reference_audit):
    """The port's audit CLI on 4 gloo ranks (a 2 x 2 mesh), every program."""
    return spawn_audit(tmp_path_factory.mktemp("audit4"), 4)


def test_audit_cli_two_rank_mesh(tmp_path):
    # 2 ranks: a 1 x 2 data x model mesh, the data axis degenerate
    payload, outs = spawn_audit(tmp_path, 2, ["--exchanges",
                                              "psum_scatter"])
    assert all(rc == 0 for rc, _ in outs), outs[0][1][-4000:]
    assert payload["world"] == 2
    assert [r["program"] for r in payload["comm_audit"]] == [
        "train[psum_scatter]", "train[psum_scatter,dedup]",
        "train[psum_scatter,int8]", "rank[all-entities]",
        "rank[candidates]", "eval[all-entities]", "serve[topk]",
        "serve[topk,int8]"]
    assert all(r["ok"] for rows in payload["ranks"] for r in rows), \
        payload["ranks"]
    assert "audit ok: 8 programs within contract on each of 2 rank(s)" \
        in outs[0][1]


def test_audit_cli_full_sweep_four_ranks(full_sweep):
    payload, outs = full_sweep
    assert all(rc == 0 for rc, _ in outs), outs[0][1][-4000:]
    assert len(payload["ranks"]) == 4
    for rows in payload["ranks"]:
        assert len(rows) == 12 and all(r["ok"] for r in rows), rows
        for r in rows:
            if r["program"].startswith(("train[", "eval[")):
                assert r["expected_bytes"] > 0
            if r["program"].startswith("train["):
                assert r["in_place"] == r["min_in_place"] > 0
    assert "train[alltoall,dedup] r3" in outs[0][1]
    assert "eval[all-entities] r3" in outs[0][1]
    assert "audit ok: 12 programs" in outs[0][1]


def test_exchange_bytes_equal_the_references(full_sweep, reference_audit):
    """Every model-axis rule's recorded and expected bytes `==` the
    reference's ``expected_bytes`` for the same program (the plans are
    the reference's, so U is); the data axis and the rank programs by
    the port's own closed forms, and ``eval[all-entities]``, which the
    reference does not have, by its own."""
    ref = reference_audit()
    payload, _ = full_sweep
    cfg = programs.AuditConfig()
    assert set(ref) == {r["program"] for r in payload["comm_audit"]} - {
        "eval[all-entities]"}
    for rows in payload["ranks"]:
        for row in rows:
            got = {r["rule"]: r for r in row["rules"]}
            if row["program"] == "eval[all-entities]":
                # model axis only: the encode's exchange per partition,
                # the ranking's all-reduces per test batch and direction
                assert set(got) == {"reduce-scatter@model",
                                    "all-gather@model", "all-reduce@model"}
                assert all(r["wire_bytes"] == r["expected_bytes"] > 0
                           for r in got.values())
                assert got["reduce-scatter@model"]["count"] == \
                    got["all-gather@model"]["count"] == cfg.num_trainers
                continue
            want = {r["rule"]: r for r in ref[row["program"]]["rules"]}
            model = {k for k in want if k.endswith("@model")}
            if row["program"].startswith("train["):
                assert model == {k for k in got if k.endswith("@model")}
                for k in model:
                    assert got[k]["wire_bytes"] == got[k]["expected_bytes"] \
                        == want[k]["expected_bytes"], (row["program"], k)
                # the data axis: one all-gather of each trainer's flat
                # gradients, loss and 3 aux metrics, where the reference
                # all-reduces 2 (grad_bytes + 3·4)
                ref_grad = want["all-reduce@data"]["expected_bytes"] / 2 \
                    - 3 * 4
                assert got["all-gather@data"]["expected_bytes"] == \
                    got["all-gather@data"]["wire_bytes"] == \
                    cfg.num_trainers * (ref_grad + 4 * 4)
                assert got["all-gather@data"]["count"] == 1
            elif row["program"].startswith("rank["):
                # three all-reduces: the f32 true score and two int64
                # counts (the reference: s32 counts; in the candidate
                # protocol two all-reduces, the true score an input)
                b = cfg.eval_batch
                assert got["all-reduce@model"]["count"] == 3
                assert got["all-reduce@model"]["wire_bytes"] == \
                    2 * b * (4 + 8 + 8)
                assert want["all-reduce@model"]["expected_bytes"] == (
                    3 * 2 * b * 4 if row["program"] == "rank[all-entities]"
                    else 2 * 2 * b * 4)
            else:
                assert got == want == {}
