"""The program's own spans and counters (``repro_torch.tracing``), summed
per step: what the ``program_span`` and ``program_counter`` metrics read.

A traced run records exactly its profiled steps, since the port's spans
record only while a profile is active; the readers take the median over
those steps, so the host-op stage's few slower steps do not move them. A
program without the tracing module, or a snapshot without the span,
gives ``None``.
"""
from __future__ import annotations

import statistics
from typing import Dict, Optional


def snapshot():
    """The port's snapshot, or ``None`` where the port has no tracing."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing.snapshot()


def per_step(snap, name: str) -> Dict[int, float]:
    """``{step: ms}``: the span's host ms summed within each step (the
    outermost enclosing span) that has one."""
    out: Dict[int, float] = {}
    if snap is None:
        return out
    for s in snap.spans.get(name, ()):
        out[s.step] = out.get(s.step, 0.0) + s.host_ms
    return out


def counts_per_step(snap, name: str) -> Dict[int, int]:
    """``{step: n}``: the counter summed within each step."""
    out: Dict[int, int] = {}
    if snap is None:
        return out
    for step, n in snap.counts.get(name, ()):
        out[step] = out.get(step, 0) + n
    return out


def median(values) -> Optional[float]:
    values = list(values)
    return float(statistics.median(values)) if values else None


def engine_host_ms(snap) -> Optional[float]:
    """The median step's host time of ``serve.engine.step`` less its
    ``serve.server.fetch``, where the host waits for the card."""
    fetch = per_step(snap, "serve.server.fetch")
    return median(ms - fetch.get(step, 0.0) for step, ms in
                  per_step(snap, "serve.engine.step").items())


def trainer_host_ms(snap) -> Optional[float]:
    """The median step's host time of ``train.step`` and of the
    ``train.generators`` span just before it (the outermost span numbered
    one less), less its ``train.loss_wait`` and ``train.scalars_wait``,
    where the host waits for the card."""
    gens = per_step(snap, "train.generators")
    waits = [per_step(snap, n) for n in ("train.loss_wait",
                                         "train.scalars_wait")]
    return median(ms + gens.get(step - 1, 0.0)
                  - sum(w.get(step, 0.0) for w in waits)
                  for step, ms in per_step(snap, "train.step").items())
