"""What the port does not do yet, and where ROADMAP.md (Queue 1) lists it.

Every option of the reference that the port has not reached raises
``NotImplementedError`` through :func:`not_ported`, naming its ROADMAP
item, instead of silently doing something else.
"""
from __future__ import annotations

ITEMS = {
    "checkpoint": "ROADMAP Queue 1 item 1: checkpoints in the reference's "
                  ".npz + JSON manifest format",
    "spmd": "ROADMAP Queue 1 item 2: the multi-process step over "
            "torch.distributed",
    "citation2": "ROADMAP Queue 1 item 4: feature-mode mini-batch training "
                 "(--arch rgcn-citation2) and the ogbl candidate-list "
                 "ranking protocol",
    "lm": "ROADMAP Queue 1 item 7: the LM substrate",
}


def not_ported(feature: str, key: str) -> NotImplementedError:
    """The error an entry point raises for ``feature``, which belongs to
    the ROADMAP item ``ITEMS[key]``."""
    return NotImplementedError(
        f"{feature} is not ported to repro_torch yet ({ITEMS[key]})")
