"""What the port does not do yet, and where ROADMAP.md (Queue 1) lists it.

Every option of the reference that the port has not reached raises
``NotImplementedError`` through :func:`not_ported`, naming its ROADMAP
item, instead of silently doing something else.
"""
from __future__ import annotations

ITEMS = {
    "spmd": "ROADMAP Queue 1 item 2: the multi-process step over "
            "torch.distributed",
    "citation2": "ROADMAP Queue 1 item 4: feature-mode mini-batch training "
                 "(--arch rgcn-citation2) and the ogbl candidate-list "
                 "ranking protocol",
    "lm_train": "ROADMAP Queue 1 item 7a: LM training (loss_fn, "
                "make_train_step, train_lm, TokenStream and the WKV "
                "backward)",
    "rglru": "ROADMAP Queue 1 item 7b: the RG-LRU and recurrentgemma",
    "attention": "ROADMAP Queue 1 item 7c: attention and the dense "
                 "decoder architectures",
    "moe": "ROADMAP Queue 1 item 7d: mixture-of-experts layers",
    "multimodal": "ROADMAP Queue 1 item 7e: whisper and qwen2-vl",
    "dryrun": "ROADMAP Queue 1 item 7f: launch/dryrun.py as a meta-device "
              "dry run",
}


def not_ported(feature: str, key: str) -> NotImplementedError:
    """The error an entry point raises for ``feature``, which belongs to
    the ROADMAP item ``ITEMS[key]``."""
    return NotImplementedError(
        f"{feature} is not ported to repro_torch yet ({ITEMS[key]})")
