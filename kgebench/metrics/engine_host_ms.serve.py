"""Serving engine: the host's own work in one ``KGEServeEngine.step`` at
full batches, from the program's spans: ``serve.engine.step`` less its
``serve.server.fetch`` (the wait for the card), median over the traced
steps (ms)."""
from kgebench.yardstick import spans


def read(facts):
    return spans.engine_host_ms(spans.snapshot())
