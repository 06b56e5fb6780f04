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
  what was recorded (``MESH_2X2``), the FLOPs between each device's share
  of the reference's step and ``MESH_FLOPS_MAX_RATIO`` times the
  reference's count on its own 2 x 2 mesh, so a change to them shows.
  The reference's count is ``analyze_hlo``'s with fused products inside
  a scanned layer scaled by its trip count (:func:`loop_flops`).
* The regions that run per (batch row, head) — an attention layer, the
  RWKV time mix — run on each device's own rows and heads on the 2 x 2
  mesh: no op gathered, a quarter of the 1 x 1 trace's FLOPs; without a
  mesh the helper is the body, bit for bit. A shard-to-shard move counts
  as one all-to-all at its result size, as the reference counts it.
* At 1 x 1: the aten FLOPs ``==`` the reference's ``analyze_hlo`` FLOPs,
  the reference compiled in this process, within ``FLOPS_RTOL``. The port
  counts every matrix product; ``analyze_hlo`` counts ``dot``s, and XLA
  rewrites some small products as a multiply and a reduce: the WKV
  recurrence's per-step ``r_t · S`` (rwkv6-3b's training step reads
  +0.71 %, 524,288 FLOPs: exactly those products of the forward, 2 BH hd^2
  a step of each layer); the other two combinations are equal.
* The loop-aware counts ``==`` the whole trace at a small depth.
* The CLI: ``rwkv6-3b`` at ``decode_32k`` on the 16 x 16 mesh (full
  size, in a background process; its collective bytes ``==`` the constant
  ``chip_smoke.py`` phase 13 holds on the card's torch) and the
  ``skipped`` record of glm4-9b at ``long_500k``.
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
# The attention core, the WKV and one decode step's WKV run on each
# device's own rows and heads (``sharding.context.head_parallel``), a
# decode step's attention on its own cache rows (``key_parallel``), the
# layers' weights are gathered over data as XLA's partitioner gathers
# them, and the residual pins hold the gradients too. Each combination's
# FLOPs lie between its device's share of the whole step (the
# reference's 1 x 1 count over the 4 devices) and MESH_FLOPS_MAX_RATIO
# times the reference's count on its 2 x 2 mesh (``loop_flops``). Below
# 1.0 of the latter (rwkv6-3b prefill and decode, deepseek decode,
# qwen2-vl prefill) XLA computes a small product whole on the model axis
# that the port splits. A change that moves any of them updates this
# table from ``python tests/test_torch_dryrun.py compare`` and says why;
# MESH_FLOPS_MAX_RATIO only ever falls.
MESH_2X2 = {
    "gemma-2b/train": (15122432, {
        "all-reduce": (41, 137216),
        "all-gather": (22, 1395712),
        "reduce-scatter": (22, 721920)}),
    "gemma-2b/prefill": (4997120, {
        "all-reduce": (5, 20480),
        "all-gather": (23, 1380360)}),
    "gemma-2b/decode": (1253376, {
        "all-reduce": (11, 9344),
        "all-gather": (25, 1379080)}),
    "rwkv6-3b/train": (18612224, {
        "all-reduce": (103, 352256),
        "all-gather": (58, 1832000),
        "reduce-scatter": (66, 891936),
        "all-to-all": (8, 274432)}),
    "rwkv6-3b/prefill": (6160384, {
        "all-reduce": (5, 16384),
        "all-gather": (31, 1717288),
        "reduce-scatter": (2, 16)}),
    "rwkv6-3b/decode": (1540096, {
        "all-reduce": (7, 4112),
        "all-gather": (41, 1714184)}),
    "recurrentgemma-9b/train": (25649152, {
        "all-reduce": (93, 233472),
        "all-gather": (51, 2339328),
        "reduce-scatter": (34, 1153536),
        "all-to-all": (4, 262144)}),
    "recurrentgemma-9b/prefill": (8527872, {
        "all-reduce": (7, 28672),
        "all-gather": (34, 2279944)}),
    "recurrentgemma-9b/decode": (2136064, {
        "all-reduce": (10, 9280),
        "all-gather": (35, 2267016)}),
    "deepseek-v2-lite-16b/train": (15960064, {
        "all-reduce": (83, 910272),
        "all-gather": (58, 1650624),
        "reduce-scatter": (55, 965136)}),
    "deepseek-v2-lite-16b/prefill": (5163008, {
        "all-reduce": (9, 17088),
        "all-gather": (29, 1564712),
        "reduce-scatter": (9, 5120)}),
    "deepseek-v2-lite-16b/decode": (1489920, {
        "all-reduce": (13, 4848),
        "all-gather": (29, 1499400),
        "reduce-scatter": (5, 768)}),
    "whisper-large-v3/train": (146718720, {
        "all-reduce": (89, 568320),
        "all-gather": (36, 2899968),
        "reduce-scatter": (34, 1441792)}),
    "whisper-large-v3/prefill": (48906240, {
        "all-reduce": (11, 159744),
        "all-gather": (37, 2884616)}),
    "whisper-large-v3/decode": (9871360, {
        "all-reduce": (13, 11392),
        "all-gather": (33, 1871880),
        "all-to-all": (2, 32768)}),
    "qwen2-vl-7b/train": (17547264, {
        "all-reduce": (50, 155648),
        "all-gather": (23, 1625600),
        "reduce-scatter": (23, 805888)}),
    "qwen2-vl-7b/prefill": (5849088, {
        "all-reduce": (5, 20480),
        "all-gather": (21, 1608712)}),
    "qwen2-vl-7b/decode": (1449984, {
        "all-reduce": (11, 9344),
        "all-gather": (25, 1576968)}),
}
# the worst ratio read (deepseek-v2-lite-16b train: MLA's latent
# expansion and a few small weight gradients run whole on the model axis)
MESH_FLOPS_MAX_RATIO = 15960064 / 15648768
# background processes of the port's and the reference's records each,
# the combinations dealt out by mode (the trains are the slowest)
SPLITS = 3


def small_shape(mode):
    from repro_torch.launch.specs import InputShape
    return InputShape("small", 4 if mode != "decode" else 8, 2, mode)


def loop_flops(hlo_text, trip):
    """``analyze_hlo``'s FLOPs with each computation a loop body calls (a
    fusion, a ``call``) scaled by the body's trip count, as the body
    itself is. ``analyze_hlo`` scales only the loop bodies: a ``dot``
    that XLA fused inside a scanned layer counts once, not once a layer
    (ROADMAP, known faults on the reference side). At 1 x 1 the two agree
    on every combination here; on the 2 x 2 mesh XLA fuses the decode
    steps' matrix-vector products, and ``analyze_hlo`` reads 0.55-0.93 of
    this count there."""
    from unittest import mock
    from repro.analysis import hlo
    from repro.sharding import hlo_analysis

    class Called(hlo.HloModule):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            todo = list(self.mult.items())
            while todo:
                comp, m = todo.pop()
                for line in self.comps.get(comp, [])[1:]:
                    for callee in hlo._CALLS_RE.findall(line):
                        if self.mult.get(callee, 0.0) < m:
                            self.mult[callee] = m
                            todo.append((callee, m))
    with mock.patch.object(hlo_analysis, "HloModule", Called):
        return hlo_analysis.analyze_hlo(hlo_text, loop_trip_count=trip)[
            "flops"]


def reference_records(combos, devices):
    """``{combo: argument bytes, analyze_hlo FLOPs, loop_flops FLOPs,
    collective_stats}`` of the reference's compiled steps at ``reduced()``
    size, on a ``(2, 2)`` or ``(1, 1)`` mesh of forced host devices."""
    import jax
    from repro.configs import get_arch
    from repro.launch import specs as JS
    from repro.launch.dryrun import _lower
    from repro.launch.mesh import _make_mesh
    from repro.sharding.context import mesh_context
    from repro.sharding.hlo_analysis import analyze_hlo, collective_stats
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
        text, trip = compiled.as_text(), JS.scan_trip_count(cfg)
        out[combo] = dict(
            argument_bytes=compiled.memory_analysis().argument_size_in_bytes,
            flops=analyze_hlo(text, loop_trip_count=trip)["flops"],
            loop_flops=loop_flops(text, trip),
            collectives=collective_stats(text, loop_trip_count=trip))
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


def test_shard_to_shard_move_counts_one_all_to_all():
    """An ``(8, 64, 32)`` fp32 ``DTensor`` on ``("data", "model", None)``
    of the fake 2 x 2 mesh moved to ``[Shard(0), Shard(2)]``: one
    all-to-all of its 16,384-byte result, no all-gather (the ``cpu`` mesh's
    fallback would gather 32,768 bytes)."""
    import torch
    from torch.distributed.tensor import Shard
    from repro_torch.launch.mesh import fake_process_group, make_fake_mesh
    from repro_torch.sharding import step_analysis as A
    with fake_process_group(4):
        mesh = make_fake_mesh((2, 2), ("data", "model"))
        counter = A.StepCounter()
        with counter:
            t = A.on_mesh(torch.empty((8, 64, 32), device="meta"),
                          ("data", "model", None), mesh)
            with counter.step() as counts:
                moved = t.redistribute(mesh, [Shard(0), Shard(2)])
            assert tuple(moved.to_local().shape) == (4, 64, 16)
    assert _collectives(counts["collectives"]) == {"all-to-all": (1, 16384)}


def _region_trace(dims, module, run):
    """``(FLOPs inside module.head_parallel, reshards)`` of ``run(mesh)``
    (one layer on ``DTensor``s) on a fake mesh of ``dims``."""
    from unittest import mock
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch.mesh import fake_process_group, make_fake_mesh
    from repro_torch.sharding import context, step_analysis as A
    inside = []

    def counted(*args, **kwargs):
        before = counter.counts["flops"]
        out = context.head_parallel(*args, **kwargs)
        inside.append(counter.counts["flops"] - before)
        return out
    with fake_process_group(math.prod(dims)):
        mesh = make_fake_mesh(dims, ("data", "model"))
        counter, reshard = A.StepCounter(), A.ReshardMode()
        with counter, implicit_replication(), context.mesh_context(mesh), \
                mock.patch.object(module, "head_parallel", counted):
            args = run.place(mesh)
            with counter.step(), reshard:
                run(*args)
    assert len(inside) == 1
    return inside[0], dict(reshard.reshards)


class _Layer:
    """One reduced layer's parameters and input ``(B 8, S 8, d)`` on a
    mesh, laid out by the rules; calling it runs the layer."""

    def __init__(self, arch, make, apply):
        from repro_torch.configs import get_arch
        self.cfg = get_arch(arch).reduced()
        self.make, self.apply = make, apply

    def place(self, mesh):
        import torch
        from repro_torch.launch.dryrun import _place
        from repro_torch.nn.transformer import leaves
        from repro_torch.sharding import rules as R
        from repro_torch.sharding import step_analysis as A
        params = self.make(self.cfg)
        placed = _place(params, R.param_shardings(params, mesh), mesh)
        for _, t in leaves(placed):
            t.requires_grad_()
        x = torch.empty((8, 8, self.cfg.d_model), device="meta")
        return placed, A.on_mesh(x, R.spec_for_batch_leaf((8, 8, 1), mesh),
                                 mesh)

    def __call__(self, params, x):
        self.apply(self.cfg, params, x).sum().backward()


def _attention_layer():
    import torch
    from repro_torch.nn import attention as AT

    def make(cfg):
        return AT.attn_params(None, cfg.d_model, cfg.num_heads,
                              cfg.num_kv_heads, cfg.resolved_head_dim,
                              device="meta")

    def apply(cfg, p, x):
        positions = torch.arange(x.shape[1])[None].expand(x.shape[0], -1)
        return AT.attention(p, x, num_heads=cfg.num_heads,
                            num_kv_heads=cfg.num_kv_heads,
                            head_dim=cfg.resolved_head_dim,
                            positions=positions)
    return AT, _Layer("gemma-2b", make, apply)


def _time_mix():
    from repro_torch.nn import recurrent as RC

    def make(cfg):
        return RC.rwkv_params(None, cfg.d_model, cfg.rwkv_head_dim,
                              device="meta")

    def apply(cfg, p, x):
        return RC.rwkv_apply(p, x, cfg.rwkv_head_dim)
    return RC, _Layer("rwkv6-3b", make, apply)


@pytest.mark.parametrize("layer,dims", [
    (_attention_layer, (2, 2)), (_time_mix, (2, 2)), (_time_mix, (1, 8))],
    ids=["gemma-2b attention (kv heads 1), 2 x 2",
         "rwkv6-3b time mix, 2 x 2",
         "rwkv6-3b time mix, 1 x 8 (4 heads: the rows split instead)"])
def test_head_parallel_region_runs_a_share_on_a_mesh(layer, dims):
    """One reduced layer with its backward, traced on a fake mesh: no op
    gathered (``reshards`` empty), and the region inside ``head_parallel``
    counts its 1 x 1 FLOPs over the devices, per device (on 1 x 8 the
    model axis does not divide the 4 heads and splits the batch rows)."""
    module, run = layer()
    one, _ = _region_trace((1, 1), module, run)
    share, reshards = _region_trace(dims, module, run)
    assert reshards == {}
    assert one > 0 and share * math.prod(dims) == one


def test_head_parallel_is_the_body_without_a_mesh():
    """No mesh installed: ``head_parallel`` calls the body on the plain
    tensors, the outputs and the gradients bit for bit the body's (the
    attention core with kv heads 1, the WKV over the heads)."""
    import functools
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.nn import attention as AT
    from repro_torch.nn import recurrent as RC
    from repro_torch.sharding.context import head_parallel
    rng = np.random.default_rng(0)

    def leaf(*shape):
        return torch.tensor(rng.normal(size=shape).astype(np.float32),
                            requires_grad=True)
    mask = AT.causal_mask(8, 8)
    cases = [
        (functools.partial(AT._sdpa_local, logit_cap=None),
         (leaf(2, 8, 4, 16), leaf(2, 8, 1, 16), leaf(2, 8, 1, 16), mask),
         ("b.h.", "b.k.", "b.k.", AT.MASK_LAYOUT), dict(heads=4,
                                                         kv_heads=1)),
        (functools.partial(RC._wkv_heads, wkv=ref.wkv_chunk_ref),
         (leaf(2, 8, 32), leaf(2, 8, 32), leaf(2, 8, 32),
          -torch.exp(leaf(2, 8, 32)), leaf(4, 8)),
         ("b.h", "b.h", "b.h", "b.h", "h."), dict(heads=4)),
    ]
    for body, args, layouts, kw in cases:
        leaves = [a for a in args if a.requires_grad]
        got = head_parallel(body, args, layouts, "b.h", **kw)
        g_got = torch.autograd.grad(got.square().sum(), leaves)
        want = body(*args)
        g_want = torch.autograd.grad(want.square().sum(), leaves)
        assert torch.equal(got, want)
        assert all(torch.equal(a, b) for a, b in zip(g_got, g_want))


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
    """A record's collectives (or the reference's ``collective_stats``) as
    ``{kind: (count, bytes)}``, the kinds that moved anything."""
    detail = rec.get("collective_detail", rec)
    return {k: (int(v["count"]), int(v["bytes"]))
            for k, v in detail.items() if v["count"]}


@pytest.mark.parametrize("combo", COMBOS)
def test_reduced_mesh_counts_hold_their_record(background, combo):
    """The 2 x 2 records' per-device aten FLOPs and collectives ``==``
    ``MESH_2X2``; the FLOPs at least the device's share of the
    reference's whole step (its 1 x 1 count over 4, within
    ``FLOPS_RTOL``) and at most ``MESH_FLOPS_MAX_RATIO`` times the
    reference's count on its 2 x 2 mesh (:func:`loop_flops`): another op
    gathered, or a pin lost, shows here."""
    rec = background.records("port")[combo]
    ref = background.records("ref")[combo]
    assert (rec["aten_flops_per_device"], _collectives(rec)) == \
        MESH_2X2[combo]
    flops = rec["aten_flops_per_device"]
    assert ref["share"] * (1 - FLOPS_RTOL) <= flops
    assert flops / ref["loop_flops"] <= MESH_FLOPS_MAX_RATIO


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
    assert r["collective_bytes_per_device"] == \
        chip_smoke_constant("DRYRUN_DECODE_32K_COLLECTIVE_BYTES")
    assert r["memory"]["argument_bytes"] > 0
    assert "not a measurement" in r["analysis"]


def chip_smoke_constant(name):
    """A constant of ``chip_smoke.py`` (at the repository's root), read
    from its source: phase 13 holds the card's record to the same one."""
    import ast
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == name for t in node.targets):
            return ast.literal_eval(node.value)
    raise KeyError(name)


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
            print(f"{dims} {combo}: aten FLOPs {flops:.0f} / loop_flops "
                  f"{r['loop_flops']:.0f} = {flops / r['loop_flops']:.4f} "
                  f"(analyze_hlo {r['flops']:.0f}: "
                  f"{flops / r['flops']:.4f}); read argument bytes "
                  f"{p['memory']['read_argument_bytes']:.0f} / "
                  f"{r['argument_bytes']}; collectives {_collectives(p)}, "
                  f"the reference's {_collectives(r['collectives'])}; "
                  f"reshards {p['reshards']}")


if __name__ == "__main__":       # a background process of this module
    which = sys.argv[1]
    if which == "compare":
        compare()
    elif which in ("port", "port1"):
        dims = (2, 2) if which == "port" else (1, 1)
        print(json.dumps(port_records(sys.argv[2].split(","), dims)))
    else:
        combos = sys.argv[2].split(",")
        recs = reference_records(combos, 4)
        for combo, one in reference_records(combos, 1).items():
            recs[combo]["share"] = one["loop_flops"] / 4
        print(json.dumps(recs))
