"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's, on the CPU with no card.

* At ``reduced()`` size, one architecture of each family in each mode on a
  fake 2 x 2 mesh: the record is ``ok``, and the bytes of the arguments
  the step reads ``==`` the reference's compiled program's
  ``memory_analysis().argument_size_in_bytes`` (``_lower`` on
  ``jax.make_mesh((2, 2))`` of 4 forced host devices, with
  ``mesh_context``). Both sides run in background processes, started as
  this module starts.
* On the 2 x 2 mesh the per-device aten FLOPs and collectives ``==``
  what was recorded (``MESH_2X2``), the FLOPs within a stated band of the
  reference's: the mesh counts are ``DTensor``'s propagation, weaker than
  XLA's (ROADMAP Queue 3 N), and a change to them shows.
* At 1 x 1: the aten FLOPs ``==`` the reference's ``analyze_hlo`` FLOPs,
  the reference compiled in this process, within ``FLOPS_RTOL``. The port
  counts every matrix product; ``analyze_hlo`` counts ``dot``s, and XLA
  rewrites some small products as a multiply and a reduce: the WKV
  recurrence's per-step ``r_t · S`` (rwkv6-3b's training step reads
  +0.71 %, 524,288 FLOPs: exactly those products of the forward, 2 BH hd^2
  a step of each layer); the other two combinations are equal.
* The loop-aware counts ``==`` the whole trace at a small depth.
* The CLI: ``rwkv6-3b`` at ``decode_32k`` on the 16 x 16 mesh (full
  size, in a background process) and the ``skipped`` record of glm4-9b
  at ``long_500k``.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
FAMILIES = {"dense": "gemma-2b", "rwkv": "rwkv6-3b",
            "hybrid": "recurrentgemma-9b", "moe": "deepseek-v2-lite-16b",
            "encdec": "whisper-large-v3", "vlm": "qwen2-vl-7b"}
MODES = ("train", "prefill", "decode")
COMBOS = [f"{a}/{m}" for a in FAMILIES.values() for m in MODES]
ONE_DEVICE = ["rwkv6-3b/train", "deepseek-v2-lite-16b/prefill",
              "whisper-large-v3/decode"]
FLOPS_RTOL = 1e-2
# What the fake 2 x 2 mesh's records counted per device when this table
# was recorded: aten FLOPs and {kind: (count, bytes)} of the collectives.
# They are DTensor's propagation, not XLA's partitioner (ROADMAP Queue 3
# N): attention runs replicated on the model axis, so the FLOPs read
# 1.03-2.07x the reference's. A change that moves any of them updates
# this table from ``python tests/test_torch_dryrun.py compare`` and says
# why; the FLOPs never fall below the reference's nor rise above
# MESH_FLOPS_MAX_RATIO of them.
MESH_2X2 = {
    "gemma-2b/train": (19079168, {
        "all-reduce": (61, 13342720),
        "all-gather": (90, 748608),
        "reduce-scatter": (60, 5421976)}),
    "gemma-2b/prefill": (5398528, {
        "all-reduce": (7, 53248),
        "all-gather": (36, 397912),
        "reduce-scatter": (11, 19584)}),
    "gemma-2b/decode": (1353728, {
        "all-reduce": (11, 5664),
        "all-gather": (43, 355216),
        "reduce-scatter": (12, 6208)}),
    "rwkv6-3b/train": (21037056, {
        "all-reduce": (139, 7931904),
        "all-gather": (212, 8754016),
        "reduce-scatter": (70, 3854888)}),
    "rwkv6-3b/prefill": (6455296, {
        "all-reduce": (4, 24576),
        "all-gather": (66, 729176),
        "reduce-scatter": (23, 29200)}),
    "rwkv6-3b/decode": (1572864, {
        "all-reduce": (9, 9248),
        "all-gather": (53, 435728),
        "reduce-scatter": (24, 137472)}),
    "recurrentgemma-9b/train": (31895552, {
        "all-reduce": (149, 24530944),
        "all-gather": (149, 2088384),
        "reduce-scatter": (165, 9579560)}),
    "recurrentgemma-9b/prefill": (9453568, {
        "all-reduce": (15, 110592),
        "all-gather": (48, 550264),
        "reduce-scatter": (27, 53376)}),
    "recurrentgemma-9b/decode": (2367488, {
        "all-reduce": (17, 11824),
        "all-gather": (52, 469008),
        "reduce-scatter": (23, 11072)}),
    "deepseek-v2-lite-16b/train": (19920896, {
        "all-reduce": (132, 15890112),
        "all-gather": (138, 2203296),
        "reduce-scatter": (110, 5819600)}),
    "deepseek-v2-lite-16b/prefill": (5699584, {
        "all-reduce": (9, 24768),
        "all-gather": (47, 334984),
        "reduce-scatter": (16, 27664)}),
    "deepseek-v2-lite-16b/decode": (1729024, {
        "all-reduce": (17, 6608),
        "all-gather": (53, 353240),
        "reduce-scatter": (17, 8256)}),
    "whisper-large-v3/train": (214024192, {
        "all-reduce": (138, 33808384),
        "all-gather": (182, 3336384),
        "reduce-scatter": (119, 13578536)}),
    "whisper-large-v3/prefill": (67158016, {
        "all-reduce": (24, 1519616),
        "all-gather": (75, 1791608),
        "reduce-scatter": (22, 202752)}),
    "whisper-large-v3/decode": (10233856, {
        "all-reduce": (14, 9264),
        "all-gather": (69, 827152),
        "reduce-scatter": (23, 75840)}),
    "qwen2-vl-7b/train": (23035904, {
        "all-reduce": (66, 17508352),
        "all-gather": (117, 1668416),
        "reduce-scatter": (70, 7016472)}),
    "qwen2-vl-7b/prefill": (6651904, {
        "all-reduce": (5, 20480),
        "all-gather": (55, 450136),
        "reduce-scatter": (18, 35840)}),
    "qwen2-vl-7b/decode": (1646592, {
        "all-reduce": (11, 9248),
        "all-gather": (53, 361232),
        "reduce-scatter": (18, 8704)}),
}
MESH_FLOPS_MAX_RATIO = 2.1
# background processes of the port's and the reference's records each,
# the combinations dealt out by mode (the trains are the slowest)
SPLITS = 3


def small_shape(mode):
    from repro_torch.launch.specs import InputShape
    return InputShape("small", 4 if mode != "decode" else 8, 2, mode)


def reference_records(combos, devices):
    """``{combo: argument bytes, analyze_hlo FLOPs}`` of the reference's
    compiled steps at ``reduced()`` size, on a ``(2, 2)`` or ``(1, 1)``
    mesh of forced host devices."""
    import jax
    from repro.configs import get_arch
    from repro.launch import specs as JS
    from repro.launch.dryrun import _lower
    from repro.launch.mesh import _make_mesh
    from repro.sharding.context import mesh_context
    from repro.sharding.hlo_analysis import analyze_hlo
    from repro.sharding.rules import param_shardings
    from repro.training.optimizer import adam
    shape2 = (2, 2) if devices == 4 else (1, 1)
    mesh = _make_mesh(shape2, ("data", "model"), jax.devices()[:devices])
    out = {}
    for combo in combos:
        arch, mode = combo.split("/")
        cfg = get_arch(arch).reduced()
        small = small_shape(mode)
        shape = JS.InputShape(small.name, small.seq_len, small.global_batch,
                              small.mode)
        params = JS.abstract_params(cfg)
        with mesh_context(mesh):
            lowered = _lower(cfg, shape, mesh, params,
                             param_shardings(params, mesh), adam(1e-4))
        compiled = lowered.compile()
        out[combo] = dict(
            argument_bytes=compiled.memory_analysis().argument_size_in_bytes,
            flops=analyze_hlo(compiled.as_text(),
                              loop_trip_count=JS.scan_trip_count(cfg))
            ["flops"])
    return out


def port_records(combos, dims):
    """``{combo: record}`` of the port's dry run at ``reduced()`` size on
    a fake mesh of ``dims``, traced whole."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import fake_process_group, make_fake_mesh
    out = {}
    with fake_process_group(math.prod(dims)):
        mesh = make_fake_mesh(dims, ("data", "model"))
        for combo in combos:
            arch, mode = combo.split("/")
            out[combo] = D.dry_run(get_arch(arch).reduced(),
                                   small_shape(mode), mesh, full=True)
    return out


def _spawn(args, env_extra):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", **env_extra)
    return subprocess.Popen([sys.executable, *args], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


class Background:
    """The background processes of this module, started at once."""

    def __init__(self, tmp):
        self.cli_out = os.path.join(tmp, "cli.jsonl")
        xla = ("--xla_force_host_platform_device_count=4 "
               "--xla_cpu_multi_thread_eigen=false")
        me = os.path.abspath(__file__)
        by_mode = sorted(COMBOS, key=lambda c: MODES.index(c.split("/")[1]))
        shares = [by_mode[i::SPLITS] for i in range(SPLITS)]
        self.procs = {
            **{f"port{i}": _spawn([me, "port", ",".join(c)], {})
               for i, c in enumerate(shares)},
            **{f"ref{i}": _spawn([me, "reference", ",".join(c)],
                                 {"XLA_FLAGS": xla})
               for i, c in enumerate(shares)},
            "one": _spawn([me, "port1", ",".join(ONE_DEVICE)], {}),
            "cli": _spawn(["-m", "repro_torch.launch.dryrun",
                           "--arch", "rwkv6-3b", "--shape", "decode_32k",
                           "--mesh", "single", "--out", self.cli_out,
                           "--force"], {}),
        }
        self._done = {}

    def result(self, name):
        if name not in self._done:
            out, err = self.procs[name].communicate(timeout=600)
            assert self.procs[name].returncode == 0, err[-3000:]
            self._done[name] = out
        return self._done[name]

    def records(self, prefix):
        merged = {}
        for i in range(SPLITS):
            merged.update(json.loads(
                self.result(f"{prefix}{i}").strip().splitlines()[-1]))
        return merged

    def close(self):
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module", autouse=True)
def background(tmp_path_factory):
    bg = Background(str(tmp_path_factory.mktemp("dryrun")))
    yield bg
    bg.close()


# ---------------------------------------------------------------------- #
# in process, while the background runs (first, so that they overlap it)
# ---------------------------------------------------------------------- #
def _cost(c):
    return {k: c[k] for k in ("flops", "bytes", "collectives", "kernels",
                              "output_bytes", "alias_bytes",
                              "read_argument_bytes")}


@pytest.mark.parametrize("arch,dims,over,seq,mode", [
    ("gemma-2b", (2, 2), dict(num_layers=4), 8, "prefill"),
    ("rwkv6-3b", (1, 1), dict(num_layers=4), 8, "prefill"),
])
def test_loop_aware_counts_equal_the_whole_trace(arch, dims, over, seq,
                                                 mode):
    """Depth 2 and 3 extrapolated to the stack's depth, on a 2 x 2 mesh
    and on one device, ``==`` the step traced whole, every count but the
    peak."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import fake_process_group, make_fake_mesh
    from repro_torch.launch.specs import InputShape
    cfg = dataclasses.replace(get_arch(arch).reduced(), **over)
    shape = InputShape("small", seq, 2, mode)
    with fake_process_group(math.prod(dims)):
        mesh = make_fake_mesh(dims, ("data", "model"))
        whole = D.analyze(cfg, shape, mesh, full=True)
        cut = D.analyze(cfg, shape, mesh)
    assert cut["traces"] != "whole" and whole["traces"] == "whole"
    assert _cost(cut) == _cost(whole)


def test_skip_record_for_full_attention_at_500k(tmp_path):
    from repro_torch.launch import dryrun as D
    out = tmp_path / "dry.jsonl"
    assert D.main(["--arch", "glm4-9b", "--shape", "long_500k", "--mesh",
                   "single", "--out", str(out), "--force"]) == 0
    r = json.loads(out.read_text().splitlines()[0])
    assert r["status"] == "skipped"
    assert "full-attention" in r["note"]


def test_extrapolation_is_exact_on_polynomials():
    """One loop and two, each count a polynomial of degree 1 in every
    loop's trip count (no product of two), nested keys and a key only the
    longer trace has."""
    from repro_torch.sharding.step_analysis import extrapolate

    def f(n, e):
        out = {"flops": 7 + 3 * n + 11 * e, "kernels": {}}
        if n > 2:
            out["kernels"]["k"] = {"calls": float(n - 2)}
        return out
    assert extrapolate(f(2, 4), [(f(3, 4), 30)]) == f(32, 4)
    assert extrapolate(f(2, 2), [(f(3, 2), 30), (f(2, 3), 10)]) == f(32, 12)


@pytest.mark.parametrize("combo", ONE_DEVICE)
def test_one_device_flops_equal_the_reference(background, combo):
    """The reference compiled here, on this process's one CPU device; the
    port's record from the background."""
    ref = reference_records([combo], 1)[combo]
    rec = json.loads(background.result("one").strip().splitlines()[-1])[
        combo]
    assert rec["status"] == "ok"
    assert rec["aten_flops_per_device"] == pytest.approx(ref["flops"],
                                                         rel=FLOPS_RTOL)
    assert rec["memory"]["read_argument_bytes"] == ref["argument_bytes"]


# ---------------------------------------------------------------------- #
# from the background
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("combo", COMBOS)
def test_reduced_record_on_a_fake_2x2_mesh(background, combo):
    """Every family in every mode traces ``ok`` on a fake 2 x 2 mesh, and
    the bytes of the arguments its step reads ``==`` the reference's
    compiled program's argument size."""
    rec = background.records("port")[combo]
    ref = background.records("ref")[combo]
    assert rec["status"] == "ok" and rec["chips"] == 4
    assert rec["roofline"]["dominant"] in ("compute", "memory",
                                           "collective")
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["memory"]["read_argument_bytes"] == ref["argument_bytes"]
    assert rec["memory"]["argument_bytes"] >= ref["argument_bytes"]


def _collectives(rec):
    """A record's collectives as ``{kind: (count, bytes)}``, the kinds
    that moved anything."""
    return {k: (int(v["count"]), int(v["bytes"]))
            for k, v in rec["collective_detail"].items() if v["count"]}


@pytest.mark.parametrize("combo", COMBOS)
def test_reduced_mesh_counts_hold_their_record(background, combo):
    """The 2 x 2 records' per-device aten FLOPs and collectives ``==``
    ``MESH_2X2``, and the FLOPs within ``[1 - FLOPS_RTOL,
    MESH_FLOPS_MAX_RATIO]`` of the reference's ``analyze_hlo`` count on
    its 2 x 2 mesh: another op gathered or a pin lost shows here."""
    rec = background.records("port")[combo]
    ref = background.records("ref")[combo]
    assert (rec["aten_flops_per_device"], _collectives(rec)) == \
        MESH_2X2[combo]
    ratio = rec["aten_flops_per_device"] / ref["flops"]
    assert 1 - FLOPS_RTOL <= ratio <= MESH_FLOPS_MAX_RATIO


def test_cli_full_size_record(background):
    background.result("cli")
    recs = [json.loads(line) for line in
            open(background.cli_out).read().splitlines()]
    assert len(recs) == 1
    r = recs[0]
    assert r["status"] == "ok"
    assert r["chips"] == 256
    assert r["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert r["flops_per_device"] > 0
    assert r["bytes_per_device"] > 0
    assert r["collective_bytes_per_device"] >= 0
    assert r["memory"]["argument_bytes"] > 0
    assert "not a measurement" in r["analysis"]


def compare():
    """``python tests/test_torch_dryrun.py compare``: the port's and the
    reference's per-device aten FLOPs and argument bytes of every
    combination on the 2 x 2 mesh and of ``ONE_DEVICE`` on one device, and
    the port's collectives, one line each (not a test)."""
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=4")
    for combos, devices, dims in ((COMBOS, 4, (2, 2)),
                                  (ONE_DEVICE, 1, (1, 1))):
        ref = reference_records(combos, devices)
        port = port_records(combos, dims)
        for combo in combos:
            p, r = port[combo], ref[combo]
            flops = p["aten_flops_per_device"]
            print(f"{dims} {combo}: aten FLOPs {flops:.0f} / "
                  f"{r['flops']:.0f} = {flops / r['flops']:.4f}; read "
                  f"argument bytes "
                  f"{p['memory']['read_argument_bytes']:.0f} / "
                  f"{r['argument_bytes']}; collectives {_collectives(p)}")


if __name__ == "__main__":       # a background process of this module
    which = sys.argv[1]
    if which == "compare":
        compare()
    elif which in ("port", "port1"):
        dims = (2, 2) if which == "port" else (1, 1)
        print(json.dumps(port_records(sys.argv[2].split(","), dims)))
    else:
        print(json.dumps(reference_records(sys.argv[2].split(","), 4)))
