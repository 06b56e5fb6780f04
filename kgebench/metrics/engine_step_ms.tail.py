"""Serving engine: the host time of one ``KGEServeEngine.step`` call (admit,
score, top-k, answers back on the host), timed by the benchmark's clock
around the call and averaged over the window's steps outside the profiled
ones (ms)."""


def read(facts):
    steps = facts.get("step_host_s")
    return 1e3 * sum(steps) / len(steps) if steps else None
