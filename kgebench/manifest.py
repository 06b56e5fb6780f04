"""``BENCHMARK.json`` and the files it names: each cell's configuration,
traffic mix, the mix's kind and the per-layer metrics' readers, found by
name, so that a new cell, configuration or metric is a new file and a new
entry, never an edit."""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent


def load(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json (one of "
                     f"{[w['name'] for w in bench['workloads']]})")


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def config(bench: Dict, name: str, root: Path = ROOT) -> Dict:
    entry = next(c for c in bench["configs"] if c["name"] == name)
    return _json(root / entry["file"])


def traffic(name: str, here: Path = HERE) -> Dict:
    return _json(here / "traffic" / f"{name}.json")


def kind(name: str):
    """The generator of a traffic kind: ``kinds/<name>.py``."""
    return importlib.import_module(f"kgebench.kinds.{name}")


def reader(metric: str, here: Path = HERE):
    """The reader of a per-layer metric: ``metrics/<metric>.py``, loaded
    by path (a metric's name may hold dots)."""
    path = here / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"kgebench.metrics.{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def end_to_end(bench: Dict, cell: str) -> List[Dict]:
    """The end-to-end metrics a cell reports."""
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def per_layer(bench: Dict, cell: str) -> List[Dict]:
    """The per-layer metrics a cell's traced run reports: those that list
    it, and those without a list that move an end-to-end metric it
    reports."""
    reported = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]
