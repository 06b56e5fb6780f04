"""Serving engine: the requests waiting when a step admits its batch, from
the program's counter ``serve.engine.queue_depth``, median over the traced
steps (requests)."""
from kgebench.yardstick import spans


def read(facts):
    return spans.median(spans.counts_per_step(
        spans.snapshot(), "serve.engine.queue_depth").values())
