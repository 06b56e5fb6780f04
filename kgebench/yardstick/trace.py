"""A profiled window on the card and its reading: busy time (the union of
the device events' intervals), time and count by kernel name, and the
longest idle stretches by what the host was doing.

The reading of the trace is a copy of the port's ``chip_smoke.py``
``device_activity``: the window starts and ends with untimed one-element
launches, left out of its numbers, because the tracer has been seen to lose
the device events of a window's last launches; a launch whose device event is
missing is counted as lost.
"""
from __future__ import annotations

import bisect
import dataclasses
import re
import time
from typing import Dict, List, Tuple

# host calls of the CUDA runtime and driver that put work on the card
LAUNCH_API = re.compile(r"^cu\w*(Launch\w*Kernel|Memcpy|Memset)")
PAD_LAUNCHES = 64
# idle stretches shorter than this are summed under one name
SHORT_GAP_US = 10.0
SCAN_BACK = 4096


def short_name(name: str) -> str:
    """A device operation's name without return type, namespace, template
    arguments and signature."""
    name = name.replace("(anonymous namespace)::", "")
    for cut in ("(", "<"):
        name = name.split(cut)[0]
    name = name.strip()
    if name.startswith("void "):
        name = name[len("void "):]
    return name.split("::")[-1]


@dataclasses.dataclass
class TraceSummary:
    window_s: float                 # host clock, first call to last sync
    busy_s: float                   # union of device intervals
    seconds_by_name: Dict[str, float]
    count_by_name: Dict[str, int]
    idle_by_host: Dict[str, float]  # idle seconds by the host's op
    lost: int                       # launches without a device event

    def seconds(self, *names: str) -> float:
        return sum(self.seconds_by_name.get(n, 0.0) for n in names)

    def count(self, *names: str) -> int:
        return sum(self.count_by_name.get(n, 0) for n in names)

    def breakdown(self, top: int = 10) -> Dict[str, List]:
        ops = sorted(self.seconds_by_name.items(), key=lambda kv: -kv[1])
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[n, s] for n, s in ops[:top]],
                "idle_gaps": [[n, s] for n, s in gaps[:top]]}


def summarize(prof, window_s: float, pad: int = PAD_LAUNCHES
              ) -> TraceSummary:
    from torch.autograd import DeviceType
    events = prof.events()
    host = [e for e in events if e.device_type == DeviceType.CPU]
    calls = sorted((e for e in host if LAUNCH_API.match(e.name)),
                   key=lambda e: e.time_range.start)
    if len(calls) < 2 * pad + 1:
        raise RuntimeError(
            f"the profiler recorded {len(calls)} host calls that put work "
            f"on the card, fewer than the window's {2 * pad} padding "
            f"launches and one")
    padding = {e.id for e in calls[:pad] + calls[len(calls) - pad:]}
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and e.id not in padding]
    ids = {e.id for e in device}
    lost = sum(1 for e in calls[pad:len(calls) - pad] if e.id not in ids)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in device)
    busy, end, seconds, counts, gaps = 0.0, float("-inf"), {}, {}, []
    for lo, hi, name in spans:
        key = short_name(name)
        seconds[key] = seconds.get(key, 0.0) + (hi - lo) * 1e-6
        counts[key] = counts.get(key, 0) + 1
        if lo > end and end != float("-inf"):
            gaps.append((end, lo))
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return TraceSummary(window_s=window_s, busy_s=busy * 1e-6,
                        seconds_by_name=seconds, count_by_name=counts,
                        idle_by_host=_idle_by_host(gaps, host), lost=lost)


def _idle_by_host(gaps: List[Tuple[float, float]], host) -> Dict[str, float]:
    """Idle seconds between device events, by the innermost host op
    running at each idle stretch's middle."""
    ops = sorted(((e.time_range.start, e.time_range.end, e.name)
                  for e in host if not LAUNCH_API.match(e.name)),
                 key=lambda t: t[0])
    starts = [o[0] for o in ops]
    out: Dict[str, float] = {}
    for lo, hi in gaps:
        if hi - lo < SHORT_GAP_US:
            name = f"(idle stretches under {SHORT_GAP_US:g} us)"
        else:
            name = "(host outside any recorded op)"
            mid = 0.5 * (lo + hi)
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - SCAN_BACK, -1), -1):
                if ops[j][1] >= mid:
                    name = ops[j][2]
                    break
        out[name] = out.get(name, 0.0) + (hi - lo) * 1e-6
    return out


def warm_profiler(device) -> None:
    """Start and stop the profiler once on a trivial launch: its first
    start loads and initialises CUPTI, seconds that belong to set-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    x = torch.zeros(1, device=device)
    with profile(activities=[ProfilerActivity.CUDA]):
        x.add_(1)
        torch.cuda.synchronize(device)


class ProfiledWindow:
    """``with ProfiledWindow(device) as w: ...`` profiles the body's device
    activity between padding launches; ``w.summary``, read after the
    window, parses the trace (seconds for a big one, so never inside a
    measured window). ``host_ops`` also records the host's operations,
    which slows the host: for the idle stretches' attribution only."""

    def __init__(self, device, host_ops: bool = False):
        self.device = device
        self.host_ops = host_ops
        self._prof = None
        self._summary = None

    def _pad(self) -> None:
        import torch
        for _ in range(PAD_LAUNCHES):
            self._marker.add_(1)
        torch.cuda.synchronize(self.device)

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._marker = torch.zeros(1, device=self.device)
        torch.cuda.synchronize(self.device)
        self._prof = profile(activities=[ProfilerActivity.CUDA] + (
            [ProfilerActivity.CPU] if self.host_ops else []))
        self._prof.__enter__()
        self._pad()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self._t0
        self._pad()
        self._prof.__exit__(*exc)
        return False

    @property
    def summary(self) -> TraceSummary:
        if self._summary is None:
            self._summary = summarize(self._prof, self.window_s)
            self._prof = None
        return self._summary


class TracedWindows:
    """The profiled part of a window: its first ``device_units`` units of
    work (steps) with device activity alone, which the per-layer metrics
    read (busy time, idle share, kernel times), then ``host_units`` more
    with the host's operations too, for the idle stretches by host op
    alone. Call ``tick()`` after each unit; the window goes on until
    ``active`` is false; ``summary`` joins the two readings."""

    def __init__(self, device, device_units: int, host_units: int):
        self.plan = [(ProfiledWindow(device), device_units),
                     (ProfiledWindow(device, host_ops=True), host_units)]
        self.units = [0, 0]
        self.stage = 0
        self.plan[0][0].__enter__()

    @property
    def active(self) -> bool:
        return self.stage < len(self.plan)

    def tick(self) -> None:
        if not self.active:
            return
        self.units[self.stage] += 1
        window, units = self.plan[self.stage]
        if self.units[self.stage] >= units:
            window.__exit__(None, None, None)
            self.stage += 1
            if self.active:
                self.plan[self.stage][0].__enter__()

    def close(self) -> None:
        """Ends the window that is open (a run shorter than the plan)."""
        if self.active:
            self.plan[self.stage][0].__exit__(None, None, None)
            self.stage = len(self.plan)

    @property
    def summary(self) -> TraceSummary:
        main = self.plan[0][0].summary
        host = self.plan[1][0].summary if self.units[1] else None
        return dataclasses.replace(
            main, idle_by_host=host.idle_by_host if host else {})
