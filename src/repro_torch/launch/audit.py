"""Comm-audit CLI: run every multi-process program of the port under the
recorder and check its communication contract on every rank (port of
``repro/launch/audit.py``; see ``docs/torch_analysis.md``).

    PYTHONPATH=src python -m repro_torch.launch.audit \\
        --init-method file:///tmp/rendezvous --world-size 4 --rank R \\
        [--device cpu] [--programs train,rank,eval,serve] \\
        [--exchanges psum_scatter,psum,alltoall] [--dedup both|on|off] \\
        [--json PATH] [--quiet]

Run one process per rank (the same command with ``--rank`` 0 .. W-1, or
under ``torchrun`` without the three process-group flags): on the cards
over NCCL, one card a rank (``LOCAL_RANK``, else the rank), or with
``--device cpu`` over gloo. 2 ranks make a ``1 x 2`` (data x model) mesh,
4 ranks a ``2 x 2`` one, so both axes carry real collectives. Each
program (the spmd train step per gather exchange × dedup and the int8
table, the sharded rank step per protocol, the trainer's test evaluation
over the embeddings' row blocks, the sharded top-k serve step fp32 and
int8) runs once under ``analysis.trace.CommRecorder`` and once
without it, and each rank audits its own trace against the program's
``CommContract`` (collective whitelist per mesh axis, closed-form wire
bytes, replication audit, in-place audit, outputs bitwise unchanged by
the recorder). The serve programs need no process group: ``--programs
serve`` alone runs in one process without one.

The ranks' reports are gathered once the audited programs have run; rank
0 prints the per-program table (every rank's rows) and writes ``--json``.
Every rank exits non-zero if any rank's report has a violation.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    import torch
    import torch.distributed as dist

    from repro_torch.analysis.contracts import format_report_table
    from repro_torch.analysis.programs import comm_audit_rows, run_audit
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import backend_for

    ap = argparse.ArgumentParser(
        description="audit the communication contracts of every "
                    "multi-process program of the port, on every rank")
    ap.add_argument("--programs", default="train,rank,eval,serve",
                    help="comma list of train,rank,eval,serve")
    ap.add_argument("--exchanges", default="",
                    help="comma list of gather-exchange layouts "
                         "(default: every SPMD layout)")
    ap.add_argument("--dedup", default="both",
                    choices=("both", "on", "off"),
                    help="gather-dedup settings to audit (train only)")
    ap.add_argument("--json", default="",
                    help="rank 0 also writes the comm_audit rows here")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress progress lines (the table still prints)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--init-method", default="env://")
    ap.add_argument("--world-size", type=int, default=None)
    ap.add_argument("--rank", type=int, default=None)
    args = ap.parse_args(argv)

    programs = tuple(p for p in args.programs.split(",") if p)
    device = resolve_device(args.device)
    grouped = bool({"train", "rank", "eval"} & set(programs)) or \
        args.world_size is not None or "WORLD_SIZE" in os.environ
    if grouped:
        if device.type == "cuda":
            local = os.environ.get("LOCAL_RANK", args.rank or 0)
            device = torch.device("cuda",
                                  int(local) % torch.cuda.device_count())
            torch.cuda.set_device(device)
        kw = {} if args.world_size is None else dict(
            world_size=args.world_size, rank=args.rank)
        dist.init_process_group(backend_for(device),
                                init_method=args.init_method, **kw)
    rank = dist.get_rank() if grouped else 0
    dedups = {"both": (False, True), "on": (True,),
              "off": (False,)}[args.dedup]
    log = None if args.quiet or rank else \
        (lambda msg: print(f"# {msg}", file=sys.stderr, flush=True))
    try:
        reports = run_audit(
            programs=programs,
            exchanges=tuple(e for e in args.exchanges.split(",") if e)
            or None, dedups=dedups, device=device, log=log)
        per_rank = [reports]
        if grouped:
            per_rank = [None] * dist.get_world_size()
            dist.all_gather_object(per_rank, reports)
    finally:
        if grouped:
            dist.destroy_process_group()

    bad = sorted({f"{r.program}@rank{i}" for i, reps in enumerate(per_rank)
                  for r in reps if not r.ok})
    if rank == 0:
        print(format_report_table([
            dataclasses.replace(r, program=f"{r.program} r{i}")
            for i, reps in enumerate(per_rank) for r in reps]))
        if args.json:
            with open(args.json, "w") as f:
                json.dump({"world": len(per_rank), "device": device.type,
                           "comm_audit": comm_audit_rows(per_rank[0]),
                           "ranks": [comm_audit_rows(reps)
                                     for reps in per_rank]}, f, indent=2)
    if bad:
        print(f"audit FAILED: contract violations in {bad}",
              file=sys.stderr)
        return 1
    if rank == 0:
        print(f"# audit ok: {len(per_rank[0])} programs within contract "
              f"on each of {len(per_rank)} rank(s)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
