"""Run one of ``chip_smoke.py``'s later phases alone: the kernels built,
then phase 10 (the MoE family), 11 (the multimodal backbones), 12 (the
RGAT encoder) or 13 (the dry run against the card: phases 8f and 9f's
training steps first, then their 1 x 1 dry-run records held against
them), each with its own gates, so that a change to one path is checked
on the card without the whole run.

    python3 tools/chip_phase.py 10    # from the repository root, on a GPU

It prints the phase's lines and writes its results to
``chiprun_out/phase<N>.json``; it exits non-zero if a gate fails.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("phase", type=int, choices=(10, 11, 12, 13))
    args = ap.parse_args()
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        print("chip_phase: no CUDA device is available", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    dev, card = torch.device("cuda", 0), cs.nvidia_smi()
    _build.build()
    cs.log(f"[phase 1] built in {time.perf_counter() - t0:.1f} s; {card}")
    rng = np.random.default_rng(0)
    if args.phase == 10:
        res, profile = cs.run_lm10(dev, rng, card)
        res = {"phase10": res, "moe_prefill_bf16": profile}
    elif args.phase == 11:
        res = {"phase11": cs.run_lm11(dev, rng, card)}
    elif args.phase == 12:
        res = {"phase12": cs.run_rgat(dev, cs.training_partition(), card)}
    else:
        lm_train = cs.run_lm_train(dev, card)
        gemma_train = cs.run_gemma_train(dev, card)
        res = {"phase8f": lm_train, "phase9f": gemma_train,
               "phase13": cs.run_dryrun_check(lm_train, gemma_train, card)}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", f"phase{args.phase}.json"),
              "w") as f:
        json.dump(res, f, default=str, indent=1)
    cs.log(f"phase {args.phase} done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
