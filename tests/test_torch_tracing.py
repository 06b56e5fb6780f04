"""The port's spans and counters (``repro_torch.tracing``) on the CPU: off
unless a profile is active or ``recording()`` is open, each serving phase
once an engine step in its place, the counts exact, the training phases
once a trainer a step, and the answers and parameters bitwise the same
with recording on and off."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.data import synthetic_fb15k
from repro_torch.models.decoders import init_decoder_params
from repro_torch.serving import KGEServeEngine, ShardedKGEServer
from repro_torch.training import KGETrainer, TrainConfig

SERVER_SPANS = ("serve.server.bias", "serve.server.heads",
                "serve.server.query", "serve.server.score",
                "serve.server.merge", "serve.server.fetch")
ENGINE_SPANS = ("serve.engine.admit", "serve.engine.answer")
SLOTS = 4


@pytest.fixture(autouse=True)
def clean():
    tracing.reset()
    yield
    tracing.reset()


def engine():
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(50, 8)).astype(np.float32)
    params = init_decoder_params(np.random.default_rng(1), "distmult", 3, 8)
    server = ShardedKGEServer(emb, params, "distmult", device="cpu")
    return KGEServeEngine(server, slots=SLOTS, max_k=5)


def serve_two_steps(eng):
    """Six requests: a full step of 4, then 2 and 2 pad slots."""
    for i in range(6):
        eng.submit(i * 7 % 50, i % 3, k=5)
    return [(r.scores.copy(), r.tails.copy()) for r in eng.run()]


def test_off_by_default_records_nothing():
    assert tracing.span("serve.engine.step") is tracing._OFF
    assert tracing.span("train.forward") is tracing._OFF
    with tracing.span("x"):
        tracing.count("y", 3)
    serve_two_steps(engine())
    snap = tracing.snapshot()
    assert snap.spans == {} and snap.counts == {} and snap.totals == {}


def check_serving(snap):
    steps = [s.step for s in snap.spans["serve.engine.step"]]
    assert len(steps) == 2 and len(set(steps)) == 2
    for name in SERVER_SPANS + ENGINE_SPANS:
        assert [s.step for s in snap.spans[name]] == steps, name
    for s in snap.spans["serve.engine.step"]:
        inner = sum(x.host_ms for name in SERVER_SPANS + ENGINE_SPANS
                    for x in snap.spans[name] if x.step == s.step)
        assert 0 < inner <= s.host_ms
    per_step = {n: [n_ for _, n_ in snap.counts[n]] for n in snap.counts}
    assert per_step["serve.engine.queue_depth"] == [6, 2]
    assert per_step["serve.engine.admitted"] == [SLOTS, 2]
    assert per_step["serve.engine.pad_slots"] == [0, SLOTS - 2]
    assert [st for st, _ in snap.counts["serve.engine.admitted"]] == steps
    # the unfiltered bias stack is built once for the width, then cached
    assert snap.totals["serve.server.bias_built"] == 1
    assert snap.dropped == {}


def test_recording_records_each_serving_phase_once_a_step():
    eng = engine()
    with tracing.recording():
        serve_two_steps(eng)
    check_serving(tracing.snapshot())


def test_a_profile_records_the_serving_phases_as_host_ranges():
    eng = engine()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        serve_two_steps(eng)
    check_serving(tracing.snapshot())
    host = {}
    for e in prof.events():
        if e.name.startswith("serve."):
            assert e.device_type == torch.autograd.DeviceType.CPU
            host.setdefault(e.name, []).append(e.time_range)
    assert set(host) == {"serve.engine.step", *SERVER_SPANS, *ENGINE_SPANS}
    for name, ranges in host.items():
        assert len(ranges) == 2, name
        # each phase lies inside the engine step it belongs to
        for r, step in zip(ranges, host["serve.engine.step"]):
            assert step.start <= r.start and r.end <= step.end, name


def test_recording_changes_no_answer():
    off = serve_two_steps(engine())
    with tracing.recording():
        on = serve_two_steps(engine())
    for (vo, io), (vn, in_) in zip(off, on):
        assert np.array_equal(vo.view(np.int32), vn.view(np.int32))
        assert np.array_equal(io, in_)


def trainer():
    cfg = TrainConfig(num_trainers=2, hidden_dim=8, epochs=2, seed=4,
                      use_kernel=True)
    return KGETrainer(synthetic_fb15k(scale=0.01, seed=3), cfg,
                      device="cpu")


def test_training_spans_once_a_trainer_a_step_and_parameters_unchanged():
    plain = trainer()
    plain.fit()
    traced = trainer()
    with tracing.recording():
        traced.fit()
    for (name, a), (_, b) in zip(plain.params.named_parameters(),
                                 traced.params.named_parameters()):
        assert torch.equal(a, b), name
    snap = tracing.snapshot()
    steps = [s.step for s in snap.spans["train.step"]]
    assert len(steps) == 2
    for name in ("train.forward", "train.backward"):
        assert [s.step for s in snap.spans[name]] == [
            st for st in steps for _ in range(2)], name
    # one addition a trainer, then the mean and Adam
    assert [s.step for s in snap.spans["train.update"]] == [
        st for st in steps for _ in range(3)]
    # Adam's scalars, where the host waits for the card, once a step
    for name in ("train.loss_wait", "train.flag_check",
                 "train.scalars_wait"):
        assert [s.step for s in snap.spans[name]] == steps, name
    # the generators are their own outermost span, just before the step's
    assert [s.step for s in snap.spans["train.generators"]] == [
        st - 1 for st in steps]
    assert "train.exchange" not in snap.spans   # one process, no exchange
    report = tracing.table(snap)
    assert "train.forward" in report and "train.update" in report


def test_samples_past_the_bound_are_counted(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SAMPLES", 3)
    with tracing.recording():
        for _ in range(5):
            with tracing.span("s"):
                tracing.count("c", 2)
    snap = tracing.snapshot()
    assert len(snap.spans["s"]) == 3 and len(snap.counts["c"]) == 3
    assert snap.dropped == {"s": 2, "c": 2}
    assert snap.totals == {"c": 10}
    assert "2 samples past the 3 kept" in tracing.table(snap)
