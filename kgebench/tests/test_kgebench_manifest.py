"""BENCHMARK.json against the benchmark's contract, and the harness finding
a cell, a configuration, a traffic mix and a per-layer metric by name."""
import json
import re
import shutil

import pytest

from kgebench import manifest

BENCH = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(LINE.match(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert BENCH["paths"] == ["kgebench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def _entries():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            yield group, e


@pytest.mark.parametrize("group,entry", list(_entries()),
                         ids=lambda x: x if isinstance(x, str) else x["name"])
def test_names_units_and_keys(group, entry):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}[group]
    extra = set(entry) - keys
    assert extra <= ({"workloads"} if group in ("end_to_end", "per_layer")
                     else set())
    assert keys <= set(entry)
    assert NAME.match(entry["name"])
    for k in ("why", "layer", "source"):
        if k in entry:
            assert LINE.match(entry[k])
    if group in ("end_to_end", "per_layer"):
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    if group == "end_to_end":
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25
    if group == "per_layer":
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
        if entry["name"].endswith("_roofline") or "mfu" in entry["name"]:
            assert entry["unit"] == "%"
    if group == "workloads":
        assert entry["chips"] in (1, 4)
        assert NAME.match(entry["config"]) and NAME.match(entry["traffic"])
    if group == "configs":
        assert len(entry["reduced"]) <= 16
        assert entry["file"].startswith("kgebench/")


def test_names_are_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_configuration_keeps_a_cell_and_its_file():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert (manifest.ROOT / c["file"]).is_file()
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in manifest.end_to_end(BENCH, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.per_layer(BENCH, w["name"])
        assert (manifest.HERE / "traffic" / f"{w['traffic']}.json").is_file()
        kind = manifest.traffic(w["traffic"])["kind"]
        assert hasattr(manifest.kind(kind), "run")


def test_each_per_layer_metric_moves_what_its_cells_report():
    for m in BENCH["per_layer"]:
        cells = m.get("workloads", [w["name"] for w in BENCH["workloads"]])
        for cell in cells:
            reported = {e["name"] for e in manifest.end_to_end(BENCH, cell)}
            assert m["moves"] in reported, (m["name"], cell)
        assert hasattr(manifest.reader(m["name"]), "read")


def perf_md_layers():
    """The first column of PERF.md's table of layers (its section 3)."""
    text = (manifest.ROOT / "PERF.md").read_text()
    section = text.split("\n## 3.", 1)[1].split("\n## ", 1)[0]
    rows = [line.split("|")[1].strip() for line in section.splitlines()
            if line.startswith("|")]
    return set(rows[2:])            # past the header and its rule


def test_metrics_name_a_layer_of_perf_md():
    """Metrics of one layer give its name letter for letter, as PERF.md's
    list of layers has it."""
    layers = perf_md_layers()
    assert {"trainer", "kernels", "device"} <= layers
    for m in BENCH["per_layer"]:
        assert m["layer"] in layers, (m["name"], m["layer"])


def test_a_new_cell_configuration_and_metric_need_only_files(tmp_path):
    """A cell, a configuration, a traffic mix and a per-layer metric added
    as new files and entries, in a copy, are found with no edit."""
    root = tmp_path / "checkout"
    shutil.copytree(manifest.HERE, root / "kgebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    here = root / "kgebench"
    cfg = json.loads((here / "configs" / "rgcn-fb15k237.json").read_text())
    cfg["name"] = "rgcn-fb15k237-wide"
    cfg["model"]["hidden_dim"] = 96
    (here / "configs" / "rgcn-fb15k237-wide.json").write_text(
        json.dumps(cfg))
    mix = json.loads((here / "traffic" / "fullgraph.json").read_text())
    mix["train"]["pipeline"] = "serial"
    (here / "traffic" / "fullgraph_serial.json").write_text(json.dumps(mix))
    (here / "metrics" / "steps_traced.py").write_text(
        "def read(facts):\n    return facts.get('steps_traced')\n")
    bench["configs"].append({
        "name": "rgcn-fb15k237-wide", "source": "https://example.org/x",
        "file": "kgebench/configs/rgcn-fb15k237-wide.json", "reduced": [],
        "why": "a throwaway configuration"})
    bench["workloads"].append({
        "name": "wide.fullgraph", "config": "rgcn-fb15k237-wide",
        "traffic": "fullgraph_serial", "chips": 1, "why": "throwaway"})
    bench["end_to_end"][0]["workloads"].append("wide.fullgraph")
    bench["per_layer"].append({
        "name": "steps_traced", "unit": "steps", "better": "higher",
        "source": "program_counter", "layer": "trainer",
        "moves": "train_edges_per_s", "workloads": ["wide.fullgraph"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    loaded = manifest.load(root)
    entry = manifest.workload(loaded, "wide.fullgraph")
    assert manifest.config(loaded, entry["config"],
                           root)["model"]["hidden_dim"] == 96
    assert manifest.traffic(entry["traffic"], here)["train"]["pipeline"] \
        == "serial"
    names = [m["name"] for m in manifest.per_layer(loaded, "wide.fullgraph")]
    assert names == ["steps_traced"]
    assert manifest.reader("steps_traced", here).read(
        {"steps_traced": 7}) == 7
    assert {m["name"] for m in manifest.end_to_end(
        loaded, "wide.fullgraph")} == {"train_edges_per_s", "setup_s"}
