"""Nothing the benchmark runs imports JAX or the JAX package ``repro``
(top-level names compared whole: ``repro_torch`` is the port), nor reads
the JAX package's benchmarks."""
import ast
import os
import subprocess
import sys
from pathlib import Path

from kgebench import manifest
from kgebench.run import FORBIDDEN

SOURCES = sorted(p for p in manifest.HERE.rglob("*.py")
                 if "__pycache__" not in p.parts)


def test_sources_import_neither_jax_nor_repro():
    for path in SOURCES:
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_sources_read_no_jax_benchmark():
    for path in SOURCES:
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert "BENCH_" not in text and "benchmarks/" not in text, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (manifest.HERE / "reference").glob("*.py"):
        assert "repro_torch" not in path.read_text(), path


def test_a_cpu_run_loads_neither_jax_nor_repro():
    """A tiny cell of each kind run end to end in a fresh interpreter: the
    modules it loaded, by whole top-level name."""
    code = (
        "import sys, time, torch\n"
        "from kgebench import manifest, run\n"
        "from kgebench.cell import SetupClock\n"
        "run.prepare_environment()\n"
        "bench = manifest.load()\n"
        "tiny = {'fb15k237.fullgraph': {'config': {'data': {'entities': 300,"
        " 'relations': 6, 'train_triples': 1600, 'valid_triples': 100,"
        " 'test_triples': 100}, 'model': {'hidden_dim': 8},"
        " 'recipe': {'num_trainers': 2}}, 'traffic': {'warmup_seconds': 0.05}},\n"
        "        'citation2.serve': {'config': {'serve': {'entities': 3000}},"
        " 'traffic': {'max_qps': 2000, 'slots': 8, 'sample': 16,"
        " 'warmup_seconds': 0.05}}}\n"
        "for name, ov in tiny.items():\n"
        "    out = run.run_cell(bench, name, 5, 0.3, False,"
        " torch.device('cpu'), SetupClock(time.perf_counter()), ov)\n"
        "    assert out.correct, (name, out.checks)\n"
        "print('LOADED', run.loaded_forbidden())\n")
    root = manifest.ROOT
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root), str(root / "src")]))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=root, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "LOADED []" in res.stdout, res.stdout[-2000:]


def test_forbidden_names_compare_whole():
    from kgebench import run
    sys.modules.setdefault("repro_torch_lookalike_for_test", sys)
    try:
        assert "repro_torch_lookalike_for_test" not in run.loaded_forbidden()
        assert all(n in FORBIDDEN for n in run.loaded_forbidden())
    finally:
        del sys.modules["repro_torch_lookalike_for_test"]


def test_without_the_port_a_run_fails_and_prints_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    folder, a run exits non-zero with no result line."""
    import shutil
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(manifest.HERE, tmp_path / "kgebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run(
        [sys.executable, "-m", "kgebench.run", "--workload",
         "citation2.serve", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert res.returncode != 0
    assert '"correct"' not in res.stdout
    assert Path(tmp_path / "kgebench").is_dir()
