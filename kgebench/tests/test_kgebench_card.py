"""On the card (``python3 -m pytest kgebench/tests -m card``): each cell's
precision control, the reference put in the program's place with TF32
products, fails at least one of the cell's limits, and a short run of each
cell at its own size comes out correct. Without a card each test skips."""
import time

import pytest
import torch

from kgebench import manifest, run
from kgebench.cell import Cell, SetupClock

BENCH = manifest.load()
CELLS = [w["name"] for w in BENCH["workloads"]]


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    run.prepare_environment()
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_precision_control_fails_a_limit(name):
    dev = card()
    entry = manifest.workload(BENCH, name)
    traffic = manifest.traffic(entry["traffic"])
    cell = Cell(name, 2 ** 31 + 3, 4.0, False, dev,
                manifest.config(BENCH, entry["config"]), traffic,
                SetupClock(time.perf_counter()))
    numbers = manifest.kind(traffic["kind"]).control(cell)
    limits = traffic["limits"]
    assert any(v > limits[n] for n, v in numbers.items() if n in limits), \
        numbers


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_is_correct(name):
    dev = card()
    out = run.run_cell(BENCH, name, 2 ** 31 + 4, 2.0, False, dev,
                       SetupClock(time.perf_counter()))
    assert out.correct, out.checks
