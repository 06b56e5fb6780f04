"""Each traffic kind end to end on the CPU at a tiny size against the plain
reference, with the harness's look for a card skipped: a sound run comes
out correct, and each fault the cell can have, planted in the program under
the run, comes out not correct."""
import time

import pytest
import torch

from kgebench import manifest, run
from kgebench.cell import SetupClock

BENCH = manifest.load()
TINY = {
    "fb15k237.fullgraph": {
        "config": {"data": {"entities": 400, "relations": 8,
                            "train_triples": 2400, "valid_triples": 150,
                            "test_triples": 150},
                   "model": {"hidden_dim": 16},
                   "recipe": {"num_trainers": 4}},
        "traffic": {"warmup_seconds": 0.05}},
    "citation2.serve": {
        "config": {"serve": {"entities": 5000}},
        "traffic": {"max_qps": 20000, "slots": 16, "sample": 64,
                    "warmup_seconds": 0.05}},
    "citation2.serve_tail": {
        "config": {"serve": {"entities": 5000}},
        "traffic": {"rate_qps": 200, "slots": 16, "sample": 64,
                    "warmup_seconds": 0.05}},
}
SEED = 2 ** 31 + 12345       # larger than 32 signed bits hold


def run_tiny(name, seed=SEED):
    return run.run_cell(BENCH, name, seed, 0.5, False, torch.device("cpu"),
                        SetupClock(time.perf_counter()), TINY[name])


@pytest.fixture(autouse=True)
def environment():
    run.prepare_environment()


@pytest.mark.parametrize("name", sorted(TINY))
def test_a_sound_run_is_correct(name):
    out = run_tiny(name)
    assert out.correct, out.checks
    assert out.attempted > 0 and out.failed == 0
    assert set(out.end_to_end) >= {
        m["name"] for m in manifest.end_to_end(BENCH, name)} - {"setup_s"}
    assert all(v <= limit for _, v, limit in out.checks)


def test_the_training_readings_match_the_reference_closely():
    out = run_tiny("fb15k237.fullgraph", seed=7)
    numbers = {n: v for n, v, _ in out.checks}
    assert numbers["expansion_mismatch"] == 0
    assert numbers["grad_gap"] < 1e-5 and numbers["step1_change_gap"] < 1e-5


def kind_of(name):
    return manifest.kind(
        manifest.traffic(manifest.workload(BENCH, name)["traffic"])["kind"])


FAULT_CASES = [(name, fault)
               for name in ("fb15k237.fullgraph", "citation2.serve")
               for fault in kind_of(name).FAULTS]


@pytest.mark.parametrize("name,fault", FAULT_CASES)
def test_a_planted_fault_is_not_correct(name, fault):
    undo = kind_of(name).FAULTS[fault]()
    try:
        out = run_tiny(name)
    finally:
        undo()
    assert not out.correct, (fault, out.checks)
    assert run_tiny(name).correct          # the program is whole again
