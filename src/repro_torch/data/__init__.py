"""KG datasets (real-format loader + synthetic stand-ins) and the input
pipelines."""
from repro_torch.data.datasets import (
    load_fb15k_format, load_or_synthesize, synthetic_citation2,
    synthetic_fb15k,
)
from repro_torch.data.pipeline import (
    AsyncMinibatchPipeline, FullGraphPipeline, PipelineStats, PlanSizes,
    SerialMinibatchPipeline, eval_partition_batches, make_input_pipeline,
    to_device_batch,
)

__all__ = ["load_fb15k_format", "load_or_synthesize", "synthetic_citation2",
           "synthetic_fb15k", "AsyncMinibatchPipeline", "FullGraphPipeline",
           "PipelineStats", "PlanSizes", "SerialMinibatchPipeline",
           "eval_partition_batches", "make_input_pipeline",
           "to_device_batch"]
