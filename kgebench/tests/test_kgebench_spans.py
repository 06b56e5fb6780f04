"""The readers of the program's spans and counters (``yardstick/spans.py``
and the four metrics on it) on synthetic snapshots: each gives the median
over steps it defines, and ``None`` where nothing was recorded or the
program has no tracing module."""
import sys

import pytest

import repro_torch
from kgebench import manifest
from kgebench.yardstick import spans
from repro_torch.tracing import Sample, Snapshot

READERS = ("engine_host_ms.serve", "engine_host_ms.tail",
           "engine_queue_depth.tail", "trainer_host_ms")


def serving():
    """Three engine steps (numbers 0-2): step host ms 4, 5, 9; fetch 1,
    1.5, 2; the queue 60, 40, 50 deep at admission."""
    return Snapshot(
        spans={"serve.engine.step": [Sample(0, 4.0), Sample(1, 5.0),
                                     Sample(2, 9.0)],
               "serve.server.fetch": [Sample(0, 1.0), Sample(1, 1.5),
                                      Sample(2, 2.0)]},
        counts={"serve.engine.queue_depth": [(0, 60), (1, 40), (2, 50)]},
        totals={"serve.engine.queue_depth": 150}, dropped={})


def training():
    """Three steps: the generators numbered 0, 2, 4 and the steps 1, 3, 5,
    each with its loss read and Adam's scalars, where the host waits."""
    def at(*ms):
        return [Sample(step, v) for step, v in zip((1, 3, 5), ms)]

    return Snapshot(
        spans={"train.step": at(100.0, 110.0, 104.0),
               "train.generators": [Sample(0, 0.5), Sample(2, 0.7),
                                    Sample(4, 0.6)],
               "train.loss_wait": at(1.0, 2.0, 1.0),
               "train.scalars_wait": at(20.0, 30.0, 25.0)},
        counts={}, totals={}, dropped={})


WANT = {
    # 4 - 1, 5 - 1.5, 9 - 2
    "engine_host_ms.serve": (serving, 3.5),
    "engine_host_ms.tail": (serving, 3.5),
    "engine_queue_depth.tail": (serving, 50.0),
    # 100 + 0.5 - 1 - 20, 110 + 0.7 - 2 - 30, 104 + 0.6 - 1 - 25
    "trainer_host_ms": (training, 78.7),
}


@pytest.mark.parametrize("name", READERS)
def test_each_reader_gives_its_median(name, monkeypatch):
    make, want = WANT[name]
    monkeypatch.setattr(spans, "snapshot", make)
    assert manifest.reader(name).read({}) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_each_reader_gives_none_on_an_empty_snapshot(name, monkeypatch):
    monkeypatch.setattr(spans, "snapshot", lambda: Snapshot({}, {}, {}, {}))
    assert manifest.reader(name).read({}) is None


@pytest.mark.parametrize("name", READERS)
def test_each_reader_gives_none_without_the_tracing_module(name,
                                                           monkeypatch):
    """A program older than its spans (the parent of the change that put
    them in) reads as nothing, and raises nothing."""
    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert spans.snapshot() is None
    assert manifest.reader(name).read({}) is None


def test_every_reader_has_its_entry():
    entries = {m["name"]: m for m in manifest.load()["per_layer"]}
    for name in READERS:
        assert entries[name]["source"] in ("program_span", "program_counter")
        assert entries[name]["workloads"]
