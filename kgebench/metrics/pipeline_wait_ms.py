"""Input pipeline: the exposed wait for batches plus the pipeline's
warm-up, per step, from the program's ``PipelineStats`` (ms)."""


def read(facts):
    wait = facts.get("pipeline_wait_s_per_step")
    return None if wait is None else 1e3 * wait
