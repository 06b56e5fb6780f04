"""What the port does not do yet, and where ROADMAP.md (Queue 1) lists it.

Every option of the reference that the port has not reached raises
``NotImplementedError`` through :func:`not_ported`, naming its ROADMAP
item, instead of silently doing something else.
"""
from __future__ import annotations

# every option the entry points reach is ported: what Queue 1 still lists
# (the dry run, RGAT) comes as new modules, not as options that raise
ITEMS: dict = {}


def not_ported(feature: str, key: str) -> NotImplementedError:
    """The error an entry point raises for ``feature``, which belongs to
    the ROADMAP item ``ITEMS[key]``."""
    return NotImplementedError(
        f"{feature} is not ported to repro_torch yet ({ITEMS[key]})")
