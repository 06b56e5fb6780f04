#!/usr/bin/env python3
"""Trials of the sharded-gather kernels (``src/repro_torch/csrc/
sharded_gather.cu``) on one GPU.

    python3 tools/gather_trials.py [--against OTHER/src/repro_torch/csrc]

1. ``fused_dequant_gather_i8`` for variants of ``DQ_UNITS`` (loads in flight
   per lane) and ``FG_WARPS`` (warps a block), each compiled from a copy of
   the source with the two constants replaced (into
   ``build/gather_trials/``), beside the first kernel
   (``fused_dequant_gather_i8_v1``).
2. With ``--against``: ``fused_gather_f32`` and ``fused_dequant_gather_i8``
   of this tree against those of the ``sharded_gather.cu`` in another
   checkout's ``csrc`` directory (a parent commit unpacked with ``git
   archive``), in turns other, tree, tree, other, in one process.

Shapes: the mini-batch path's 4-shard table gather (V = 17,200 slots into
14,544 x 75, the plan of ``chip_smoke.py``'s first mini-batch), the same
plan over a d = 32 table, and serving batches of 8 at FB15k-237 (14,541 x
75) and ogbl-citation2 (2,927,963 x 32) widths. Each time is the device
time per call from ``torch.profiler`` (``chip_smoke.device_ms``, 20
calls), printed with the card's name and power limit. Every variant's
output is checked bitwise against the plain version first.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

VARIANTS = [(4, 4), (2, 4), (3, 4), (6, 4), (8, 4), (4, 8), (4, 2)]
ENTRIES = ("fused_gather_f32", "fused_dequant_gather_i8",
           "fused_dequant_gather_i8_v1")


def compile_all(sources, out_dir):
    """``{key: ctypes library}`` for ``{key: (.cu path, include dir)}``, one
    ``nvcc`` each, all started together."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import sharded_gather as sg
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for key, (cu, include) in sources.items():
        so = os.path.join(out_dir, f"{key}.so")
        procs[key] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", include, "-o", so,
             cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), so)
    libs = {}
    for key, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        lib = ctypes.CDLL(so)
        for name in ENTRIES:
            if hasattr(lib, name):
                fn = getattr(lib, name)
                fn.argtypes = sg._SIGNATURES[name]
                fn.restype = ctypes.c_int
        libs[key] = lib
    return libs


def shapes(dev, rng):
    """``{label: (rows, d, flat ids, ownership)}`` on ``dev``."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.ops import flat_gather_plan
    mbs = cs.minibatch_arrays()
    lay = mbs["layout"]
    flat, owned = flat_gather_plan(torch.from_numpy(mbs["local"]),
                                   torch.from_numpy(mbs["owned"]),
                                   lay.rows_per_shard)
    out = {"mb": (lay.padded_rows, 75, flat.to(dev), owned.to(dev)),
           "mb_d32": (lay.padded_rows, 32, flat.to(dev), owned.to(dev))}
    for label, r, d in (("srv_fb", 14541, 75), ("srv_c2", 2927963, 32)):
        out[label] = (r, d,
                      torch.from_numpy(rng.integers(0, r, 8)).to(dev),
                      torch.from_numpy(rng.random(8) < .75).to(dev))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", help="another checkout's csrc directory")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("gather_trials: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import sharded_gather as sg
    from repro_torch.sharding import quantize_rows

    print(cs.nvidia_smi(), flush=True)
    out_dir = os.path.join(ROOT, "build", "gather_trials")
    os.makedirs(out_dir, exist_ok=True)
    csrc = str(_build.CSRC)
    text = (_build.CSRC / "sharded_gather.cu").read_text()
    sources = {}
    for units, warps in VARIANTS:
        variant = re.sub(r"constexpr int DQ_UNITS = \d+;",
                         f"constexpr int DQ_UNITS = {units};", text)
        variant = re.sub(r"constexpr int FG_WARPS = \d+;",
                         f"constexpr int FG_WARPS = {warps};", variant)
        cu = os.path.join(out_dir, f"u{units}w{warps}.cu")
        with open(cu, "w") as f:
            f.write(variant)
        sources[f"u{units}w{warps}"] = (cu, csrc)
    if args.against:
        sources["tree"] = (os.path.join(csrc, "sharded_gather.cu"), csrc)
        sources["other"] = (os.path.join(args.against, "sharded_gather.cu"),
                            args.against)
    libs = compile_all(sources, out_dir)

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    bad = sg._bad_slot_flag(dev)
    stream = torch.cuda.current_stream().cuda_stream
    for label, (r, d, flat, owned) in shapes(dev, rng).items():
        table = torch.from_numpy(rng.normal(0, .1, (r, d)).astype(
            np.float32)).to(dev)
        codes, scales = quantize_rows(table)
        v = flat.shape[0]
        out = torch.empty((v, d), device=dev)
        fg = (table.data_ptr(), flat.data_ptr(), owned.data_ptr(),
              out.data_ptr(), r, v, d, bad.data_ptr(), stream)
        dq = (codes.data_ptr(), scales.data_ptr(), flat.data_ptr(),
              owned.data_ptr(), out.data_ptr(), r, v, d, bad.data_ptr(),
              stream)
        want = sg.fused_dequant_gather_plain(codes, scales, flat, owned)
        res = {}
        for key in [f"u{u}w{w}" for u, w in VARIANTS]:
            fn = libs[key].fused_dequant_gather_i8
            out.zero_()
            fn(*dq)
            torch.cuda.synchronize()
            if not cs.same_bits(out, want):
                raise AssertionError(f"{label} {key}: != plain")
            res[key] = cs.device_ms(lambda: fn(*dq), 20)
        v1 = libs["u4w4"].fused_dequant_gather_i8_v1
        res["v1"] = cs.device_ms(lambda: v1(*dq), 20)
        print(f"{label} (V={v}, d={d}) fused_dequant_gather_i8 ms: "
              f"{ {k: round(t, 5) for k, t in res.items()} }", flush=True)
        if not args.against:
            continue
        turns = {}
        for entry, call in (("fused_gather_f32", fg),
                            ("fused_dequant_gather_i8", dq)):
            for key in ("other", "tree", "tree", "other"):
                fn = getattr(libs[key], entry)
                turns.setdefault(f"{entry} {key}", []).append(
                    round(cs.device_ms(lambda: fn(*call), 20), 5))
        print(f"{label} (V={v}, d={d}) against {args.against}, ms: {turns}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
