"""Spans and counters inside the port, recorded only while someone looks.

``span(name)`` brackets a phase of the program and
``count(name, n=1)`` counts its work. Both record only while a
``torch.profiler`` profile is active (``torch.autograd.profiler.
_is_profiler_enabled``, the flag Dynamo and Inductor read before they emit
their own ranges) or inside ``recording()``. Otherwise ``span`` returns one
shared no-op context and ``count`` returns at once: two flag reads a call,
so a run that nobody profiles pays nothing measurable.

While on, a span records its host time (``time.perf_counter_ns``) and the
sequence number of its outermost enclosing span, the step, so that a reader
sums a phase within a step and takes the median over steps. Under a profile
it is also a range in the profiler's host timeline, on the device trace's
clock (``torch._C._profiler._RecordFunctionFast``: a function-scope range,
which CUPTI does not mirror onto the device timeline as it mirrors a
``record_function`` user range). A span never touches the card: the device
time of a phase is the profile's, the kernels launched inside its range.

Samples are kept up to ``MAX_SAMPLES`` per name; the rest are counted in
``Snapshot.dropped``, and a counter's ``totals`` count every call. The
state is the process's, and spans nest by the order they open, so open
them from the one thread that drives the steps.
"""
from __future__ import annotations

import contextlib
import dataclasses
import statistics
import time
from typing import Dict, Iterator, List, Tuple

import torch
from torch.autograd import profiler as _profiler

MAX_SAMPLES = 10_000        # kept per span or counter name

_recording = 0              # recording() blocks open
_depth = 0                  # spans open
_step = -1                  # sequence number of the outermost open span
_next_step = 0
_spans: Dict[str, List[Tuple[int, int]]] = {}     # (step, host_ns)
_counts: Dict[str, List[Tuple[int, int]]] = {}
_totals: Dict[str, int] = {}
_dropped: Dict[str, int] = {}


class _Off:
    """The shared context of a span that does not record. Its exit names
    its arguments: packing them into a tuple would cost every call."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None


_OFF = _Off()


def _keep(store: Dict[str, list], name: str, item) -> None:
    kept = store.setdefault(name, [])
    if len(kept) < MAX_SAMPLES:
        kept.append(item)
    else:
        _dropped[name] = _dropped.get(name, 0) + 1


class _Span:
    __slots__ = ("name", "step", "t0", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _depth, _step, _next_step
        if _depth == 0:
            _step, _next_step = _next_step, _next_step + 1
        _depth += 1
        self.step = _step
        self.range = (torch._C._profiler._RecordFunctionFast(self.name)
                      if _profiler._is_profiler_enabled else None)
        if self.range is not None:
            self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        global _depth
        host_ns = time.perf_counter_ns() - self.t0
        if self.range is not None:
            self.range.__exit__(None, None, None)
        _depth -= 1
        _keep(_spans, self.name, (self.step, host_ns))
        return None


def span(name: str):
    """A context that records the phase ``name`` while recording is on."""
    if not (_recording or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name`` while recording is on, in the
    step of the outermost open span (``-1`` outside any)."""
    if not (_recording or _profiler._is_profiler_enabled):
        return
    _totals[name] = _totals.get(name, 0) + n
    _keep(_counts, name, (_step if _depth else -1, n))


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Records spans and counters inside the block, profiled or not."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def reset() -> None:
    """Forgets every sample, count and total."""
    for store in (_spans, _counts, _totals, _dropped):
        store.clear()


@dataclasses.dataclass(frozen=True)
class Sample:
    step: int                   # the outermost enclosing span's number
    host_ms: float


@dataclasses.dataclass(frozen=True)
class Snapshot:
    spans: Dict[str, List[Sample]]
    counts: Dict[str, List[Tuple[int, int]]]    # (step, n) a call
    totals: Dict[str, int]                      # every call's n summed
    dropped: Dict[str, int]                     # calls past MAX_SAMPLES


def snapshot() -> Snapshot:
    """What was recorded so far."""
    return Snapshot(
        spans={name: [Sample(step, host_ns * 1e-6) for step, host_ns in kept]
               for name, kept in _spans.items()},
        counts={n: list(c) for n, c in _counts.items()},
        totals=dict(_totals), dropped=dict(_dropped))


def table(snap: Snapshot) -> str:
    """The operator's summary: per span its count and median host ms,
    then each counter's total."""
    lines = [f"{'span':<24} {'count':>7} {'host ms p50':>12}"]
    for name, samples in sorted(snap.spans.items()):
        lines.append(
            f"{name:<24} {len(samples):>7} "
            f"{statistics.median(s.host_ms for s in samples):>12.4f}")
    for name, total in sorted(snap.totals.items()):
        lines.append(f"{name:<24} {'total':>7} {total:>12}")
    for name, n in sorted(snap.dropped.items()):
        lines.append(f"{name:<24} {n} samples past the {MAX_SAMPLES} kept")
    return "\n".join(lines)
