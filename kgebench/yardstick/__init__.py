"""The yardstick: the H100's peaks, the work formulas, the reading of the
profiler's trace and what the per-layer readers share."""
