"""Loop-aware per-device cost of a traced step: FLOPs, HBM bytes,
collectives by kind, kernel calls and the traced peak of live bytes (the
port's counterpart of ``repro/sharding/hlo_analysis.py``).

The reference parses the post-optimization HLO text of the compiled SPMD
program: dots give FLOPs, top-level instructions bytes (operands +
result), collectives their result bytes, and each ``while`` body is
scaled by its trip count. The port has no HLO. It runs the step itself on
abstract tensors: parameters, optimizer state, batch and cache are
``DTensor``s on a ``DeviceMesh`` of a fake process group
(``launch/mesh.py``), each holding a ``FakeTensor`` of its per-device
shard, so nothing is allocated and no card is needed. :class:`StepCounter`
is the ``FakeTensorMode`` the shards live in; every op on a shard passes
through it, and it keeps, per device:

* ``flops``: the FLOPs of ``torch.utils.flop_counter``'s formulas (the
  matrix products, convolutions and attention), on the shards' shapes —
  what ``FlopCounterMode`` counts around the same step on one card;
* ``bytes``: operand + result bytes of every op that is not a view, the
  reference's convention for top-level instructions;
* ``collectives``: the functional collectives ``DTensor`` issues to
  redistribute (a ``Shard(i) -> Shard(j)`` move as the one
  ``_dtensor.shard_dim_alltoall`` a card's mesh issues, not the ``cpu``
  mesh's all-gather and chunk: :func:`card_alltoall`), those a region of
  ``sharding/context.py`` issues itself (a decode step's softmax
  all-reduces), and ``torch.distributed``'s own (a multi-process step's,
  counted as ``analysis/trace.py`` counts them), ``{kind: {count,
  bytes}}`` over the reference's ``COLLECTIVE_KINDS`` at result size,
  twice for an all-reduce (``COLLECTIVE_WIRE_FACTOR``), the reference's
  rule; a group of one rank moves nothing;
* ``kernels``: each hand-written kernel's calls, operations and bytes
  from its module's own formulas (the ``*_ops`` and ``*_bytes`` that
  ``chip_smoke.py``'s bounds use), apart from the aten counts: a kernel
  is a ctypes launch, not an aten op. A wrapper given fake tensors calls
  :func:`local_kernel_call` in place of its kernel;
* ``peak_bytes``: the largest sum of live shard storages while the step
  runs, arguments included — a trace's peak, not the card's allocator.

The regions whose work is independent per (batch row, head) — the
attention core, the WKV — run on each device's local shards
(``sharding.context.head_parallel``), so the reshapes that merge the
batch with the heads never meet a ``DTensor``. Where ``DTensor`` still
has no sharding rule for an op (``argmax`` over vocabulary-split logits,
``unbind`` of a split dim, a view of a product whose merged rows it split
over two axes), :class:`ReshardMode` gathers the op's inputs, first
dropping strided and partial placements, then every split but the batch
split of dim 0, then all of them, as XLA's partitioner inserts a reshard,
and counts it in ``reshards``.

"Loop-aware": the port's layer stacks are Python loops, so a deep model
is traced with each scanned group cut to 2 and 3 layers (the first
layer's input is placed otherwise, so it is not one of the repeated ones)
and each count is extrapolated linearly to the group's trip count
(:func:`extrapolate`), as ``analyze_hlo`` scales a ``while`` body. That
is exact for every count but the peak, which is extrapolated the same way
and so approximate. The sequence is traced at its whole length.
"""
from __future__ import annotations

import collections
import contextlib
import weakref
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import torch
from torch._subclasses.fake_tensor import (
    FakeTensor, FakeTensorMode, unset_fake_temporarily,
)
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.analysis.trace import (
    COLLECTIVE_KINDS, COLLECTIVE_WIRE_FACTOR, collective_of,
)

# functional collective -> the reference's kind
FUNCTIONAL_KINDS: Dict[str, str] = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",     # _dtensor: Shard(i) -> Shard(j)
}
_FUNCTIONAL_NS = ("_c10d_functional", "c10d_functional", "_dtensor")


def tensor_leaves(tree) -> List[torch.Tensor]:
    return [t for t in torch.utils._pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_size(func, args) -> int:
    """Ranks of a functional collective's group: its ``group_size``
    argument, else the size of the group its name resolves to."""
    schema = func._schema.arguments
    for a, v in zip(schema, args):
        if a.name == "group_size":
            return int(v)
    for a, v in zip(schema, args):
        if a.name == "group_name":
            from torch.distributed.distributed_c10d import (
                _resolve_process_group,
            )
            return _resolve_process_group(v).size()
    return 0


def _new_counts() -> Dict[str, Any]:
    return {"flops": 0.0, "bytes": 0.0,
            "collectives": {k: {"count": 0.0, "bytes": 0.0}
                            for k in COLLECTIVE_KINDS},
            "kernels": {}, "peak_bytes": 0.0}


class StepCounter(FakeTensorMode):
    """The fake mode the shards live in; counts what runs on them (see the
    module's docstring). ``counting`` off (while the arguments are made)
    still tracks live storages for the peak."""

    def __init__(self):
        super().__init__(allow_non_fake_inputs=True)
        self.counting = False
        self.counts = _new_counts()
        self.live = 0
        self._storages = WeakIdKeyDictionary()
        self._depth = 0
        self.watched: Dict[int, int] = {}     # storage id -> bytes
        self.read: set = set()

    def reset(self) -> None:
        self.counts = _new_counts()
        self.counts["peak_bytes"] = float(self.live)

    def _freed(self, nbytes: int) -> None:
        self.live -= nbytes

    def _track(self, out) -> None:
        for t in tensor_leaves(out):
            st = t.untyped_storage()
            if st in self._storages:
                continue
            n = st.nbytes()
            self._storages[st] = n
            self.live += n
            weakref.finalize(st, self._freed, n)
        if self.live > self.counts["peak_bytes"]:
            self.counts["peak_bytes"] = float(self.live)

    def _count(self, func, args, kwargs, out) -> None:
        c = self.counts
        ns = func.namespace
        if ns == "c10d":        # torch.distributed's own collectives
            rec = collective_of(func, args, kwargs)
            if rec.kind in c["collectives"] and len(rec.ranks or ()) > 1:
                c["collectives"][rec.kind]["count"] += 1
                c["collectives"][rec.kind]["bytes"] += rec.wire_bytes
            return
        if ns in _FUNCTIONAL_NS:
            kind = FUNCTIONAL_KINDS.get(func._overloadpacket.__name__)
            if kind is None:
                return          # wait_tensor and the like move nothing
            if _group_size(func, args) <= 1:
                return
            size = sum(tensor_bytes(t) for t in tensor_leaves(out))
            c["collectives"][kind]["count"] += 1
            c["collectives"][kind]["bytes"] += \
                size * COLLECTIVE_WIRE_FACTOR.get(kind, 1.0)
            return
        packet = func._overloadpacket
        if packet in flop_registry:
            c["flops"] += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        if not func.is_view:
            outs = tensor_leaves(out)
            if outs:
                c["bytes"] += sum(tensor_bytes(t)
                                  for t in tensor_leaves((args, kwargs)))
                c["bytes"] += sum(tensor_bytes(t) for t in outs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        # the fake mode runs some ops through decompositions the first
        # time it meets them, re-entering here: only the op the step
        # called is counted
        self._depth += 1
        try:
            out = super().__torch_dispatch__(func, types, args, kwargs)
        finally:
            self._depth -= 1
        if out is NotImplemented or self._depth:
            return out
        from torch.distributed.tensor import DTensor
        ins = tensor_leaves((args, kwargs))
        if any(isinstance(t, DTensor) or t.is_meta for t in ins) or any(
                t.is_meta for t in tensor_leaves(out)):
            return out     # a DTensor op, or DTensor inferring a shape
        if not func.is_view:
            self._track(out)
        if self.counting:
            self._count(func, args, kwargs or {}, out)
            self.read.update(sid for sid in (id(t.untyped_storage())
                                             for t in ins)
                             if sid in self.watched)
        return out

    def watch(self, tensors) -> None:
        """Note which of ``tensors`` (the step's arguments' shards) the
        step reads: ``read_bytes`` sums them."""
        for t in tensors:
            st = t.untyped_storage()
            self.watched[id(st)] = st.nbytes()

    @property
    def read_bytes(self) -> int:
        return sum(self.watched[s] for s in self.read)

    def note_kernel(self, name: str, ops: float, nbytes: float) -> None:
        """A kernel's call on this mode's tensors
        (:func:`local_kernel_call`)."""
        if not self.counting:
            return
        k = self.counts["kernels"].setdefault(
            name, {"calls": 0.0, "ops": 0.0, "bytes": 0.0})
        k["calls"] += 1
        k["ops"] += ops
        k["bytes"] += nbytes

    @contextlib.contextmanager
    def step(self):
        """Count what runs inside (kernel calls too), ``DTensor``'s
        shard-to-shard moves as all-to-alls (:func:`card_alltoall`)."""
        self.reset()
        self.counting = True
        try:
            with card_alltoall():
                yield self.counts
        finally:
            self.counting = False


def _shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
    """``DTensor``'s ``Shard(gather_dim) -> Shard(shard_dim)`` move over
    ``mesh_dim`` as a card's mesh issues it: one
    ``_dtensor.shard_dim_alltoall`` on the axis's group."""
    group = mesh.get_group(mesh_dim)
    return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim,
                                                 shard_dim, group.group_name)


@contextlib.contextmanager
def card_alltoall():
    """Inside, a shard-to-shard redistribution on the fake mesh issues the
    all-to-all a card's mesh issues. The fake mesh is a ``cpu`` mesh
    (``launch/mesh.py``), and on one ``DTensor`` falls back to an
    all-gather and a chunk (gloo has no all-to-all): counted so, the move
    would read as an all-gather of ``n`` times its result, where the
    reference counts one all-to-all at its result size."""
    from torch.distributed.tensor import placement_types
    own = placement_types.shard_dim_alltoall
    placement_types.shard_dim_alltoall = _shard_dim_alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = own


# what DTensor raises for an op it cannot shard: no strategy, a
# data-dependent one (``_local_scalar_dense`` on a fake shard), an unbind
# of a split dim, a masked partial it fails to reduce
DTENSOR_ERRORS = (RuntimeError, NotImplementedError, IndexError)


def _relaxed(t, level: int):
    """``t`` with its placements relaxed for :class:`ReshardMode`: level 1
    drops strided splits and partial sums, level 2 keeps only a split of
    dim 0 over ``pod`` / ``data``, level 3 replicates."""
    from torch.distributed.tensor import Replicate, Shard
    names = t.device_mesh.mesh_dim_names or ()
    want = []
    for i, p in enumerate(t.placements):
        plain = type(p) is Shard
        keep = (level == 1 and plain) or (
            level == 2 and plain and p.dim == 0
            and names[i] in ("pod", "data"))
        want.append(p if keep else Replicate())
    if tuple(want) == tuple(t.placements):
        return t
    return t.redistribute(t.device_mesh, want)


def _unsplit(t, dim: int):
    """``t`` with any split of ``dim`` replaced by replication."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor):
        return t
    dim = dim % t.dim()
    want = [Replicate() if p.is_shard() and p.dim == dim else p
            for p in t.placements]
    if tuple(want) == tuple(t.placements):
        return t
    return t.redistribute(t.device_mesh, want)


def _rows(t) -> list:
    """``t``'s placements with every one but a split of dim 0 replaced by
    replication: the layout in which each device holds whole rows."""
    from torch.distributed.tensor import Replicate
    return [p if p.is_shard() and p.dim == 0 else Replicate()
            for p in t.placements]


def _local_rows(tree, first, keep=None):
    """``tree`` with each ``DTensor`` made a local shard laid out as
    ``first``'s rows (:func:`_rows`); ``keep``, if given, stays as it is
    laid out."""
    from torch.distributed.tensor import DTensor
    mesh, rows = first.device_mesh, _rows(first)

    def local(t):
        if t is not keep and tuple(t.placements) != tuple(rows):
            t = t.redistribute(mesh, rows)
        return t.to_local()
    return torch.utils._pytree.tree_map_only(DTensor, local, tree)


def _local_write(func, args, kwargs):
    """A mutating op ``DTensor`` cannot shard (the decode cache's in-place
    row write) run on each device's own shard of its first argument, the
    other operands split as that shard's dim 0 (else replicated): every
    device writes the rows it holds. Returns the first argument."""
    a, k = _local_rows((args, kwargs), args[0], keep=args[0])
    func(*a, **k)
    return args[0]


def local_kernel_call(kernel: str, make, inputs: Sequence, ops, nbytes):
    """A hand-written kernel's call on abstract tensors (the wrappers'
    branch for ``kernels/_build.is_abstract`` inputs), for a kernel whose
    work splits over the rows (dim 0) of its inputs and outputs.
    ``make(*inputs)`` builds the outputs (empty tensors of their shapes and
    dtypes, as ``torch.library.register_fake`` would); a
    :class:`StepCounter` the inputs live in counts the call with
    ``ops(*inputs)`` operations and ``nbytes(*inputs)`` bytes. ``DTensor``
    inputs run on their local shards laid out as the first one's rows
    (:func:`_local_rows`), and the outputs are ``DTensor``s split so."""
    from torch.distributed.tensor import DTensor
    first = next((t for t in inputs if isinstance(t, DTensor)), None)
    local = list(inputs) if first is None else _local_rows(list(inputs),
                                                           first)
    outs = make(*local)
    mode = next((t.fake_mode for t in local if isinstance(t, FakeTensor)),
                None)
    if isinstance(mode, StepCounter):
        mode.note_kernel(kernel, float(ops(*local)), float(nbytes(*local)))
    if first is None:
        return outs
    mesh, rows, n = first.device_mesh, _rows(first), first.shape[0]

    def wrap(o):
        shape = (n,) + tuple(o.shape[1:])
        return DTensor.from_local(o, mesh, rows, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=contiguous_stride(shape))
    if isinstance(outs, torch.Tensor):
        return wrap(outs)
    return type(outs)(wrap(o) if isinstance(o, torch.Tensor) else o
                      for o in outs)


class ReshardMode(TorchDispatchMode):
    """Retries an op on ``DTensor``s that ``DTensor`` cannot shard, with
    its inputs' placements relaxed one level at a time (:func:`_relaxed`);
    a mutating op instead runs shard-local (:func:`_local_write`).
    ``reshards`` counts each op that needed either."""

    def __init__(self):
        super().__init__()
        self.reshards: Dict[str, int] = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        # DTensor's own bookkeeping (shard offsets, index lists) reads
        # small tensors it makes; they are made real, the shards stay fake
        with unset_fake_temporarily():
            if func is torch.ops.aten.gather.default:
                # a gather along a split dim leaves a masked partial sum
                # that DTensor fails to reduce: gather that dim first
                args = (_unsplit(args[0], args[1]),) + tuple(args[1:])
            try:
                return self._plain(func, func(*args, **kwargs))
            except DTENSOR_ERRORS:
                if func._schema.is_mutable:
                    out = _local_write(func, args, kwargs)
                    self.reshards[f"{func} (shard-local)"] += 1
                    return out
                for level in (1, 2, 3):
                    try:
                        a, k = torch.utils._pytree.tree_map_only(
                            DTensor, lambda t: _relaxed(t, level),
                            (args, kwargs))
                        out = func(*a, **k)
                    except DTENSOR_ERRORS:
                        continue
                    self.reshards[f"{func} (level {level})"] += 1
                    return self._plain(func, out)
                raise

    def _plain(self, func, out):
        """``out`` with strided splits (a reshape that merged two split
        dims makes them) gathered at once: ``DTensor`` plans every later
        redistribution of one by a search over placement states, too slow
        for a deep trace."""
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.placement_types import _StridedShard

        def fix(t):
            if any(isinstance(p, _StridedShard) for p in t.placements):
                self.reshards[f"{func} (strided split)"] += 1
                return _relaxed(t, 1)
            return t
        if func._schema.is_mutable:
            return out
        return torch.utils._pytree.tree_map_only(DTensor, fix, out)


# ---------------------------------------------------------------------- #
# Extrapolation over depth
# ---------------------------------------------------------------------- #
def _flat(counts: Mapping, prefix: str = "") -> Dict[str, float]:
    out: Dict[str, float] = {}
    for k, v in counts.items():
        if isinstance(v, Mapping):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = float(v)
    return out


def _unflat(flat: Mapping[str, float]) -> Dict[str, Any]:
    out: Dict[str, Any] = {"kernels": {}}
    for key, v in flat.items():
        node = out
        *path, last = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return out


def extrapolate(base: Mapping, steps: Sequence[Tuple[Mapping, float]]
                ) -> Dict[str, Any]:
    """``base + Σ (trace_i − base) · n_i`` key by key: ``base`` is the
    trace with every loop at its base count, each ``trace_i`` the trace
    with loop ``i`` one step longer and ``n_i`` the steps to add (the trip
    count less the base's). Exact for counts affine in each loop count
    with no product of two of them."""
    b = _flat(base)
    out = dict(b)
    for trace, n in steps:
        t = _flat(trace)
        for key in set(b) | set(t):
            out[key] = out.get(key, 0.0) + (t.get(key, 0.0)
                                             - b.get(key, 0.0)) * n
    return _unflat(out)


# ---------------------------------------------------------------------- #
# Abstract tensors on a mesh
# ---------------------------------------------------------------------- #
def contiguous_stride(shape: Sequence[int]):
    """The strides of a contiguous tensor of ``shape``."""
    out, step = [], 1
    for n in reversed(tuple(shape)):
        out.append(step)
        step *= max(int(n), 1)
    return tuple(reversed(out))


def on_mesh(t: torch.Tensor, spec, mesh, *, requires_grad: bool = False):
    """A ``DTensor`` of ``t``'s shape and dtype laid out by ``spec`` (the
    rules' tuple) on ``mesh``, its local shard an empty tensor of the
    per-device shape; call under the :class:`StepCounter`, which makes it
    fake."""
    from torch.distributed.tensor import DTensor
    from repro_torch.sharding.rules import placements, shard_shape
    shape = tuple(t.shape)
    local = torch.empty(shard_shape(spec, shape, mesh), dtype=t.dtype)
    out = DTensor.from_local(local, mesh, placements(spec, mesh),
                             run_check=False, shape=torch.Size(shape),
                             stride=contiguous_stride(shape))
    return out.requires_grad_() if requires_grad else out


def roofline(counts: Mapping, peak_flops: float, hbm_bw: float,
             link_bw: float) -> Dict[str, Any]:
    """The three-term roofline of a record: compute (aten and kernel
    FLOPs) over the peak, bytes (aten and kernel) over HBM, collective
    bytes over the link; ``dominant`` names the largest."""
    kernel_ops = sum(k["ops"] for k in counts["kernels"].values())
    kernel_bytes = sum(k["bytes"] for k in counts["kernels"].values())
    coll = sum(v["bytes"] for v in counts["collectives"].values())
    terms = {"compute_s": (counts["flops"] + kernel_ops) / peak_flops,
             "memory_s": (counts["bytes"] + kernel_bytes) / hbm_bw,
             "collective_s": coll / link_bw}
    dominant = max(terms, key=terms.get)
    return {**terms, "dominant": dominant.replace("_s", "")}
