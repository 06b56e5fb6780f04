"""What the per-layer metrics' readers share: each metric's reader in
``metrics/<name>.py`` is a ``read(facts)`` that returns the metric's value,
or ``None`` where the run gave it nothing to read. ``facts`` is what the
traffic kind recorded, with the profiled window's ``TraceSummary`` under
``"trace"``."""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

from kgebench.yardstick import peaks


def idle_share(facts: Dict) -> Optional[float]:
    """Percent of the profiled window in which nothing ran on the
    device."""
    tr = facts.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def roofline(facts: Dict, kernels: Tuple[str, ...],
             calls: Iterable[Tuple[float, float]]) -> Optional[float]:
    """Percent of the kernels' summed device time that the least time for
    their calls' work (``(bytes, ops)`` a call) would take: one profiled
    launch per call, or the reading is refused."""
    tr = facts.get("trace")
    calls = list(calls)
    if tr is None or not calls or tr.seconds(*kernels) <= 0:
        return None
    if tr.count(*kernels) != len(calls):
        raise ValueError(f"{kernels}: {tr.count(*kernels)} launches in the "
                         f"trace against the {len(calls)} calls the window "
                         f"made (a device event lost, or a launch counted "
                         f"twice): no roofline")
    least = {"bytes": 0.0, "operations": 0.0}
    for b, o in calls:
        s, which = peaks.bound_s(b, o)
        least[which] += s
    print(f"[roofline] {'+'.join(kernels)}: {len(calls)} calls, least "
          f"time {least['bytes']:.6f} s by bytes and "
          f"{least['operations']:.6f} s by operations, device time "
          f"{tr.seconds(*kernels):.6f} s", flush=True)
    return 100.0 * sum(least.values()) / tr.seconds(*kernels)


def peak_share(facts: Dict, ops: float) -> Optional[float]:
    """Percent of the float32 peak that ``ops`` over the profiled window's
    length reach."""
    tr = facts.get("trace")
    if tr is None or tr.window_s <= 0 or ops <= 0:
        return None
    return 100.0 * ops / tr.window_s / peaks.FP32_OPS_PER_S
