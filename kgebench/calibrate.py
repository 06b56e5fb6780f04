"""The readings a cell's limits are set from, on the card at the cell's own
size: the program's compared numbers over many seeds (the lower reading),
the precision control's (the reference in the program's place, one
precision down: TF32 products where the configuration states float32 with
TF32 off), and each planted fault's (the ``FAULTS`` of the cell's kind):

    python3 -m kgebench.calibrate --workload fb15k237.fullgraph \\
        --seeds 101,102,103 --as program --seconds 1
    python3 -m kgebench.calibrate --workload citation2.serve --seeds 1,2,3 \\
        --as control
    python3 -m kgebench.calibrate --workload fb15k237.fullgraph \\
        --seeds 1,2,3 --as fault:half_batch

One line ``CAL {json}`` per seed, with every compared number. Program and
fault runs are whole runs of the cell (with a short window); a control
needs no window: it reads the reference against itself in the lower
precision, on the inputs the cell's run draws from the seed."""
from __future__ import annotations

import argparse
import json
import time

from kgebench import manifest, run
from kgebench.cell import Cell, SetupClock


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--as", dest="role", default="program",
                    help="program | control | fault:<name>")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args()
    run.prepare_environment()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kgebench.calibrate: no CUDA device")
    dev = torch.device("cuda", 0)
    bench = manifest.load()
    entry = manifest.workload(bench, args.workload)
    kind = manifest.kind(manifest.traffic(entry["traffic"])["kind"])
    undo = (kind.FAULTS[args.role.split(":", 1)[1]]()
            if args.role.startswith("fault:") else None)
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            if args.role == "control":
                cell = Cell(args.workload, seed, args.seconds, False, dev,
                            manifest.config(bench, entry["config"]),
                            manifest.traffic(entry["traffic"]),
                            SetupClock(t0))
                numbers = kind.control(cell)
                correct = None
            else:
                out = run.run_cell(bench, args.workload, seed, args.seconds,
                                   False, dev, SetupClock(t0))
                numbers = out.facts["numbers"]
                correct = out.correct
            print("CAL " + json.dumps({
                "workload": args.workload, "as": args.role, "seed": seed,
                "correct": correct, **numbers,
                "seconds": time.perf_counter() - t0}), flush=True)
            torch.cuda.empty_cache()
    finally:
        if undo is not None:
            undo()


if __name__ == "__main__":
    main()
