"""Server step: the scoring's operations for the queries the traced steps
answered (``work.serve_step_ops``) over the profiled window, as a percent
of the card's float32 peak."""
from kgebench.yardstick import work
from kgebench.yardstick.readers import peak_share


def read(facts):
    ops = sum(work.serve_step_ops(q, facts["entities"], facts["dim"])
              for q in facts.get("traced_queries", ()))
    return peak_share(facts, ops)
