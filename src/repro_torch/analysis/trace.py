"""What one program sends and allocates on this rank, recorded as it runs
(the port's counterpart of ``repro/analysis/hlo.py``).

The reference audits the post-optimization HLO text of each jitted
program. The port runs eagerly and has no HLO: :class:`CommRecorder`, a
``TorchDispatchMode``, watches what actually reaches the dispatcher while
a program runs on this rank, and keeps

* every ``c10d`` op (what ``torch.distributed`` sends): its kind on the
  reference's ``COLLECTIVE_KINDS``, the global ranks of its process group
  and its wire bytes;
* the dtype and shape of every other op's outputs, views included, as the
  reference counts every instruction of a top-level computation. The
  outputs a hand-written kernel's ctypes launch fills are allocated by
  ``aten`` ops (``torch.empty``) and are seen too.

Conventions:

* the kinds: ``allreduce_`` is ``all-reduce``; ``_allgather_base_`` and
  the list and coalesced all-gathers ``all-gather``;
  ``_reduce_scatter_base_`` (and its list and coalesced forms)
  ``reduce-scatter``; ``alltoall_base_`` (and ``alltoall_``)
  ``all-to-all``. Any other ``c10d`` op (``broadcast_``, ``send``,
  ``recv_``, ``barrier``, ...) and any op of another collective namespace
  is recorded under its own name: the audit calls it a stray. No
  collective is dropped;
* wire bytes follow the reference's roofline convention: an all-reduce
  moves twice its buffer, every other collective is counted at result
  size (the tensors of the op's first argument, the buffers it writes);
* the process group is found among the op's arguments by type (the boxed
  ``ProcessGroup``), never by position; its ranks are global ranks
  (``torch.distributed.get_process_group_ranks``). A collective whose
  group is not found is recorded with ``ranks=None``, which the audit
  reports as a violation;
* :func:`group_axes` classifies one rank list onto the row-major ``(data,
  model)`` process mesh (``launch.mesh``: rank = ``d · model + m``). A
  group of one rank spans no axis: such a collective moves no bytes and
  is recorded but ignored, as the reference ignores all-singleton replica
  groups.

Dispatch modes are thread-local, but autograd carries them to the threads
its backward runs on, so a backward's outputs and collectives are
recorded too (``tests/test_torch_audit.py`` and ``chip_smoke.py`` phase
6g each hold a buffer made only in a backward). Recording calls each op
exactly as it was called: a program's results are the same bits with the
recorder on and off.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVE_KINDS: Tuple[str, ...] = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute")

# wire-byte convention per kind (multiplier on the result size): a ring
# all-reduce moves ~2x the buffer over the wire; everything else is
# counted at result size
COLLECTIVE_WIRE_FACTOR: Dict[str, float] = {"all-reduce": 2.0}

# c10d op name -> collective kind; any other c10d op is a stray
C10D_KINDS: Dict[str, str] = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather",
    "allgather_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
}

_PROCESS_GROUP = "c10d.ProcessGroup"


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective this rank made."""

    kind: str                       # a COLLECTIVE_KINDS entry, or the op
    op: str                         # e.g. "c10d._allgather_base_.default"
    ranks: Optional[Tuple[int, ...]]  # the group's global ranks; None:
    #   the group was not found
    result_bytes: int
    wire_bytes: float
    shapes: Tuple[Tuple[int, ...], ...] = ()

    @property
    def line(self) -> str:
        return (f"{self.op} over ranks {list(self.ranks or ())} "
                f"{[list(s) for s in self.shapes]}")


@dataclasses.dataclass
class Trace:
    """Everything one program did on this rank: its collectives in
    order, the ``(op, dtype, shape)`` of every op output with its count,
    and the storage of the tensors the program updates in place, before
    and after (``name -> (data_ptr before, data_ptr after)``)."""

    collectives: List[Collective] = dataclasses.field(default_factory=list)
    outputs: Dict[Tuple[str, torch.dtype, Tuple[int, ...]], int] = \
        dataclasses.field(default_factory=dict)
    in_place: Dict[str, Tuple[int, int]] = dataclasses.field(
        default_factory=dict)


def _tensors(x) -> Iterable[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _process_group(values) -> Optional[dist.ProcessGroup]:
    """The process group among an op's arguments, found by type: the boxed
    ``ProcessGroup`` script object the c10d ops take, or a Python one."""
    for v in values:
        if isinstance(v, dist.ProcessGroup):
            return v
        if isinstance(v, torch.ScriptObject) and \
                v._type().qualified_name().endswith(_PROCESS_GROUP):
            return dist.ProcessGroup.unbox(v)
    return None


def group_ranks(values) -> Optional[Tuple[int, ...]]:
    """The global ranks of the process group among ``values`` (an op's
    arguments), or ``None`` when there is none or it is not registered."""
    pg = _process_group(values)
    if pg is None:
        return None
    try:
        return tuple(dist.get_process_group_ranks(pg))
    except (KeyError, ValueError, RuntimeError):
        return None


def collective_of(func, args, kwargs) -> Collective:
    """The record of one collective op call (before it runs)."""
    name = func.name().split("::")[-1]
    kind = C10D_KINDS.get(name, str(func)) \
        if func.namespace == "c10d" else str(func)
    result = list(_tensors(args[0])) if args else []
    size = sum(t.numel() * t.element_size() for t in result)
    factor = COLLECTIVE_WIRE_FACTOR.get(kind, 1.0)
    return Collective(
        kind=kind, op=str(func),
        ranks=group_ranks(list(args) + list(kwargs.values())),
        result_bytes=size, wire_bytes=factor * size,
        shapes=tuple(tuple(t.shape) for t in result))


class CommRecorder(TorchDispatchMode):
    """Records what the program run inside ``with CommRecorder() as rec:``
    does on this rank (module docstring); ``rec.trace`` holds it. Each
    op is called as it was called, so nothing the program computes
    changes."""

    def __init__(self):
        super().__init__()
        self.trace = Trace()
        self._outputs = collections.Counter()
        self._lock = threading.Lock()     # backward threads record too

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if "c10d" in func.namespace:
            rec = collective_of(func, args, kwargs)
            with self._lock:
                self.trace.collectives.append(rec)
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        keys = [(str(func), t.dtype, tuple(t.shape)) for t in _tensors(out)]
        with self._lock:
            self._outputs.update(keys)
        return out

    def __exit__(self, *exc):
        self.trace.outputs = dict(self._outputs)
        return super().__exit__(*exc)


def storage_ptrs(named: Mapping[str, torch.Tensor]) -> Dict[str, int]:
    """``name -> untyped_storage().data_ptr()`` of each tensor: compare
    before and after a program to see what it updated in place."""
    return {n: t.untyped_storage().data_ptr() for n, t in named.items()}


def _unravel(rank: int, sizes: Sequence[int]) -> Tuple[int, ...]:
    coords = []
    for size in reversed(sizes):
        coords.append(rank % size)
        rank //= size
    return tuple(reversed(coords))


def group_axes(ranks: Sequence[int],
               mesh_axes: Sequence[Tuple[str, int]]) -> frozenset:
    """The axes of the row-major ``(name, size)`` process mesh that one
    group's global ``ranks`` span: on a 2 x 2 ``(data, model)`` mesh
    ``(0, 1)`` spans ``{model}`` (its members differ only in the minor
    coordinate), ``(0, 2)`` spans ``{data}`` and ``(0, 1, 2, 3)`` both. A
    group of one rank spans none: the collective moves no bytes."""
    names = [n for n, _ in mesh_axes]
    sizes = [s for _, s in mesh_axes]
    if len(ranks) <= 1:
        return frozenset()
    coords = [_unravel(r, sizes) for r in ranks]
    return frozenset(name for i, name in enumerate(names)
                     if len({c[i] for c in coords}) > 1)
