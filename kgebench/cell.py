"""What a traffic kind is handed (:class:`Cell`) and what it hands back
(:class:`Outcome`)."""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import time
from typing import Dict, List, Optional, Tuple


class SetupClock:
    """Set-up time from the process's start to the window's, and its
    parts, each printed on its own line as it ends."""

    def __init__(self, start: float):
        self.start = start
        self.parts: Dict[str, float] = {}
        self.window_start: Optional[float] = None

    @contextlib.contextmanager
    def part(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.parts[name] = self.parts.get(name, 0.0) + dt
            print(f"[setup] {name}: {dt:.3f} s", flush=True)

    def window_started(self) -> float:
        """Marks the end of set-up; returns the window's start."""
        self.window_start = time.perf_counter()
        print(f"[setup] total: {self.setup_s:.3f} s (the parts above, "
              f"and {self.setup_s - sum(self.parts.values()):.3f} s "
              f"between them)", flush=True)
        return self.window_start

    @property
    def setup_s(self) -> float:
        return self.window_start - self.start


@contextlib.contextmanager
def collector_paused():
    """Python's cyclic garbage collector run once, then paused for the
    window (as ``timeit`` does): its full passes over the hundreds of
    thousands of request objects a serving window holds stall the one
    process at moments that differ from run to run. Reference counting
    still frees everything that holds no cycle."""
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


@dataclasses.dataclass
class Cell:
    name: str
    seed: int
    seconds: float
    trace: bool
    device: object              # torch.device
    config: Dict
    traffic: Dict
    clock: SetupClock


@dataclasses.dataclass
class Outcome:
    end_to_end: Dict[str, float]        # the window's metrics by name
    facts: Dict                         # what the per-layer readers read
    checks: List[Tuple[str, float, float]]   # (number, value, limit)
    attempted: int
    failed: int
    memory_peak_bytes: int

    @property
    def correct(self) -> bool:
        """Every compared number finite and within its limit, and nothing
        attempted failed."""
        return self.failed == 0 and all(
            math.isfinite(v) and v <= limit for _, v, limit in self.checks)
