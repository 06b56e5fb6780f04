"""Trainer: the host's time to build and enqueue one step, from the
program's spans: ``train.step`` and the ``train.generators`` just before
it, less ``train.loss_wait`` and ``train.scalars_wait`` (the waits for the
card), median over the traced steps (ms)."""
from kgebench.yardstick import spans


def read(facts):
    return spans.trainer_host_ms(spans.snapshot())
