"""Run one cell of ``BENCHMARK.json`` once, on the card, and print its
result as the last line of standard output:

    python3 -m kgebench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (``src/`` is put on the path here). Set-up draws
the cell's inputs and weights from the seed and warms every shape up; the
window then measures for ``--seconds``; after it the program's state is
freed and the plain reference judges what the window produced. With
``--trace 0`` the result holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profiled part of the
window. Without a card, or with fewer than the cell asks for, the run fails
and prints no result; so it does if JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Dict, Optional, Sequence  # noqa: E402

from kgebench import manifest  # noqa: E402
from kgebench.cell import Cell, Outcome, SetupClock  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def parse_args(argv: Optional[Sequence[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def prepare_environment(root=manifest.ROOT) -> None:
    """The port on the path, every build and kernel cache at a fixed path
    inside the checkout, and JAX kept out of any library that would load
    it by itself."""
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    # one process with few threads: the host's share of each step is
    # Python's, and idle worker threads spinning beside it only add noise
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    build = root / "build" / "kgebench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that are JAX's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    """The first card's power limit as ``nvidia-smi`` reads it: a card set
    below 700 W runs slower under load."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "--id=0"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(bench: Dict, name: str, seed: int, seconds: float, trace: bool,
             device, clock: SetupClock,
             overrides: Optional[Dict] = None) -> Outcome:
    """Run cell ``name`` on ``device``. ``overrides`` (tests only) replaces
    keys of the configuration's and the traffic's blocks, as
    ``{"config": {block: {key: value}}, "traffic": {key: value}}``."""
    entry = manifest.workload(bench, name)
    config = manifest.config(bench, entry["config"])
    traffic = manifest.traffic(entry["traffic"])
    for block, values in (overrides or {}).get("config", {}).items():
        config[block] = {**config.get(block, {}), **values}
    traffic.update((overrides or {}).get("traffic", {}))
    cell = Cell(name=name, seed=seed, seconds=seconds, trace=trace,
                device=device, config=config, traffic=traffic, clock=clock)
    return manifest.kind(traffic["kind"]).run(cell)


def per_layer_metrics(bench: Dict, name: str, facts: Dict) -> Dict:
    out = {}
    for m in manifest.per_layer(bench, name):
        value = manifest.reader(m["name"]).read(facts)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    bench = manifest.load()
    entry = manifest.workload(bench, args.workload)
    clock = SetupClock(T_START)
    prepare_environment()
    with clock.part("import torch"):
        import torch
        torch.set_num_threads(1)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"kgebench: cell {args.workload} needs {entry['chips']} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f": no result", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    outcome = run_cell(bench, args.workload, args.seed, args.seconds,
                       bool(args.trace), device, clock)
    bad = loaded_forbidden()
    if bad:
        print(f"kgebench: the run loaded {bad}: the benchmark measures the "
              f"port alone; no result", file=sys.stderr)
        return 3
    if args.trace:
        metrics = per_layer_metrics(bench, args.workload, outcome.facts)
    else:
        values = dict(outcome.end_to_end, setup_s=clock.setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in manifest.end_to_end(bench, args.workload)}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": entry["chips"],
           "memory_peak_bytes": outcome.memory_peak_bytes,
           "power_limit": power_limit()}
    result = {"correct": outcome.correct, "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": metrics, "device": dev}
    summary = outcome.facts.get("trace")
    if args.trace and summary is not None:
        dev.update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = summary.breakdown()
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in outcome.checks}
    print(json.dumps(result), flush=True)
    for n, v, lim in outcome.checks:
        print(f"check {n}: {v!r} (limit {lim!r})", file=sys.stderr)
    print(f"correct: {outcome.correct}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
