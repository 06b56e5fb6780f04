"""Run ``chip_smoke.py`` with every profiler window's records logged, to
see what the tracer loses.

    python3 tools/profiler_windows.py    # from the repository root, on a GPU

For each window it writes one JSON line to
``chiprun_out/profiler_windows.jsonl``: the device events, the host calls
that put work on the card (``chip_smoke.LAUNCH_API``) by name, those with
no device event of their correlation id, and the device events with no
host call (padding included). A window that stays incomplete is logged
and stands in as an empty one, so the run goes on; the counts of windows
taken and incomplete are printed at the end. The times such a run prints
are not measurements.
"""
import collections
import json
import os
import sys

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402

os.makedirs("chiprun_out", exist_ok=True)
LOG = open(os.path.join("chiprun_out", "profiler_windows.jsonl"), "w")
device_activity, profiled = cs.device_activity, cs.profiled


def logged_activity(prof, pad=0):
    from torch.autograd import DeviceType
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    calls = [e for e in events if e.device_type == DeviceType.CPU
             and cs.LAUNCH_API.match(e.name)]
    ids, call_ids = {e.id for e in device}, {e.id for e in calls}
    LOG.write(json.dumps(dict(
        device=len(device), calls=len(calls), pad=pad,
        call_names=collections.Counter(e.name for e in calls),
        calls_without_device=collections.Counter(
            e.name for e in calls if e.id not in ids),
        device_without_call=collections.Counter(
            cs.short_name(e.name)[:50] for e in device
            if e.id not in call_ids))) + "\n")
    LOG.flush()
    return device_activity(prof, pad)


def lenient(fn, reps, windows=10, host=True):
    try:
        return profiled(fn, reps, windows, host)
    except RuntimeError as e:
        LOG.write(json.dumps({"error": str(e)}) + "\n")
        LOG.flush()
        print(f"[windows] {e}", flush=True)
        return dict(busy_us=1.0, by_name={"none": 1.0}, count=1,
                    wall_us=1.0)


cs.device_activity, cs.profiled = logged_activity, lenient
sys.argv = ["chip_smoke.py"]
rc = cs.main()
print(f"[windows] {cs.WINDOWS}", flush=True)
sys.exit(rc)
