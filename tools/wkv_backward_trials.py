#!/usr/bin/env python3
"""Trials of the chunk-parallel WKV backward (``wkv_chunked_backward``,
``src/repro_torch/csrc/wkv_chunk.cu``) on one GPU, at the rwkv6-3b
training shape: BH 80 (2 batch rows x 40 heads), S 2,048, hd = chunk = 64.

    python3 tools/wkv_backward_trials.py [--against OTHER] [--cuts]

1. The call given the forward's states and the call forming them, with
   each pass's device time (``chip_smoke.timed`` and ``profiled``) and an
   integer digest of the five outputs' bits.
2. ``--against OTHER``, another checkout's root (the parent commit
   unpacked with ``git archive`` into ``build/``): 1 for OTHER and for
   this tree in turns other, tree, tree, other, each in a process of its
   own that imports its own package and builds its own library, and
   whether the digests agree.
3. ``--cuts``: pass C (``wkv_bwd_local_kernel``) built from copies of the
   source (into ``build/wkv_cuts/``), each with one stage cut out, and
   pass C's device time for each, the whole source first and last: what
   each stage costs. A cut copy's outputs are wrong; only its time is
   read.

Every line names the card and its power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BH, S, HD, CHUNK = 80, 2048, 64, 64

# pass C's stages, each cut out by text replacements inside the kernel
CUTS = {
    "products": [("mm4<", "mm4_skip<"),
                 ("lower_product(", "lower_product_skip(")],
    "decay walk": [("for (int a = 0; a < n; ++a) {\n        w = sX",
                    "for (int a = 0; a < 0; ++a) {\n        w = sX")],
    "decay factors": [("for (int x = t; x < n * hd; x += BWD_THREADS) {",
                       "for (int x = t; x < 0; x += BWD_THREADS) {")],
    "Z": [("    if (sout_g != nullptr)\n", "    if (false)\n")],
    "dlw scan and du": [("  if (ci < hd) {\n    float tq",
                         "  if (false) {\n    float tq"),
                        ("  if (ci < hd) {\n    float acc = zs[ci];",
                         "  if (false) {\n    float acc = zs[ci];")],
    "epilogue loads": [(f"{x} = ld_row4(", f"{x} = ld_zero4(")
                       for x in ("r4", "k4", "w4v", "lx4", "gs4")],
    "chunk loads": [("__pipeline_memcpy_async(dst[m], src[m] + gi, 16);",
                     "(void)0;"),
                    ("__pipeline_memcpy_async(dst, gout_g + a * P + c, 16);",
                     "(void)0;")],
}
SKIPS = """template <bool XT, bool YT, typename... Ts>
__device__ __forceinline__ void mm4_skip(Ts...) {}
template <typename... Ts>
__device__ __forceinline__ void lower_product_skip(Ts...) {}
__device__ __forceinline__ float4 ld_zero4(const float*, int64_t, int, int,
                                           int) {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}
"""


def setup(root):
    sys.path[:0] = [os.path.join(root, "src"), root]


def operands():
    import torch
    import chip_smoke as c
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    x = c.wkv_inputs(dev, rng, BH, S, HD)
    g = torch.from_numpy(rng.normal(size=(BH, S, HD)).astype(
        np.float32)).to(dev)
    return x, g


def per_pass(fn, reps=10):
    import chip_smoke as c
    return {k: v / reps / 1e3 for k, v in c.profiled(fn, reps)[
        "by_name"].items()}


def time_tree():
    """Section 1 for the checkout on sys.path."""
    import torch
    import chip_smoke as c
    from repro_torch.kernels.wkv_chunk import (wkv_chunked_backward,
                                               wkv_chunked_states)
    x, g = operands()
    _, st = wkv_chunked_states(*x, chunk=CHUNK)

    def given():
        return wkv_chunked_backward(*x, g, chunk=CHUNK, states=st)
    ms, call_ms = c.timed(given)
    alone_ms, _ = c.timed(lambda: wkv_chunked_backward(*x, g, chunk=CHUNK))
    passes = per_pass(given)
    digest = [int(t.view(torch.int32).long().sum()) for t in given()]
    return dict(ms=ms, call_ms=call_ms, without_states_ms=alone_ms,
                passes_ms=passes, digest=digest)


def cut_times(card):
    """Section 3 for this tree."""
    import chip_smoke as c  # noqa: F401  (sys.path for the package)
    from repro_torch.kernels import _build
    from repro_torch.kernels import wkv_chunk as W
    src = open(os.path.join(ROOT, "src/repro_torch/csrc/wkv_chunk.cu")).read()
    lo = src.index("wkv_bwd_local_kernel(const float* __restrict__ r")
    hi = src.index("// Pass D, a thread per (row, column)")
    at = src.rindex("template <int PC, int NC>", 0, lo)
    head, body, tail = src[:at] + SKIPS + src[at:lo], src[lo:hi], src[hi:]
    out_dir = os.path.join(ROOT, "build", "wkv_cuts")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, name in enumerate(["none", *CUTS]):
        cut = body
        for old, new in CUTS.get(name, []):
            if old not in cut:
                raise SystemExit(f"cut {name!r}: {old!r} not in pass C")
            cut = cut.replace(old, new)
        cu, so = (os.path.join(out_dir, f"cut{i}{e}") for e in (".cu", ".so"))
        with open(cu, "w") as f:
            f.write(head + cut + tail)
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"cut {name!r} does not build:\n{log}")
        lib = ctypes.CDLL(so)
        for fn, argtypes in W._SIGNATURES.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    x, g = operands()
    _, st = W.wkv_chunked_states(*x, chunk=CHUNK)
    for name in ["none", *CUTS, "none"]:
        W._library = lambda lib=libs[name]: lib
        passes = per_pass(lambda: W.wkv_chunked_backward(
            *x, g, chunk=CHUNK, states=st))
        c_ms = next(v for k, v in passes.items() if "local" in k)
        print(json.dumps({"cut": name, "pass_c_ms": c_ms,
                          "call_ms": sum(passes.values()), "card": card}),
              flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", help="another checkout's root")
    ap.add_argument("--cuts", action="store_true")
    ap.add_argument("--root", default=ROOT, help=argparse.SUPPRESS)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    setup(args.root)
    import chip_smoke as c
    if args.one:
        print(json.dumps(time_tree()), flush=True)
        return
    card = c.nvidia_smi()
    if args.against:
        digests = set()
        for label, root in (("other", args.against), ("tree", ROOT),
                            ("tree", ROOT), ("other", args.against)):
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one",
                 "--root", os.path.abspath(root)], cwd=root, text=True,
                capture_output=True)
            if out.returncode:
                raise SystemExit(f"{label} ({root}) failed:\n{out.stderr}")
            res = json.loads(out.stdout.strip().splitlines()[-1])
            digests.add(tuple(res["digest"]))
            print(json.dumps({"turn": label, **res, "card": card}),
                  flush=True)
        print(json.dumps({"bitwise": len(digests) == 1, "card": card}))
    else:
        print(json.dumps({**time_tree(), "card": card}), flush=True)
    if args.cuts:
        cut_times(card)


if __name__ == "__main__":
    main()
