"""Filter index and candidate-axis-sharded scoring."""
from repro_torch.eval.ranking import (
    FILTER_BIAS, CSRFilterIndex, build_filter_index,
)

__all__ = ["FILTER_BIAS", "CSRFilterIndex", "build_filter_index"]
