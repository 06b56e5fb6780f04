"""Training step: the operations the traced steps need
(``work.kge_train_step_ops``) over the profiled window, as a percent of the
card's float32 peak."""
from kgebench.yardstick.readers import peak_share


def read(facts):
    steps = facts.get("steps_traced", 0)
    if not steps:
        return None
    return peak_share(facts, facts["step_ops"] * steps)
