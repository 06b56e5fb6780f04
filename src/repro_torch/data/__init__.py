"""KG datasets (real-format loader + synthetic stand-ins) and the
full-graph input pipeline."""
from repro_torch.data.datasets import (
    load_fb15k_format, load_or_synthesize, synthetic_citation2,
    synthetic_fb15k,
)
from repro_torch.data.pipeline import (
    FullGraphPipeline, PipelineStats, eval_partition_batches,
)

__all__ = ["load_fb15k_format", "load_or_synthesize", "synthetic_citation2",
           "synthetic_fb15k", "FullGraphPipeline", "PipelineStats",
           "eval_partition_batches"]
