"""Activation-sharding context (port of ``repro/sharding/context.py``).

The model code is mesh-agnostic; a caller (the dry run,
``launch/dryrun.py``) installs a ``DeviceMesh`` here, and
:func:`shard_activation` / :func:`shard_logits` redistribute a ``DTensor``
to the reference's ``with_sharding_constraint`` placement: the batch over
data(+pod), the vocabulary over ``model``. :func:`head_parallel` runs a
region whose work is independent per (batch row, head) — the attention
core, the WKV — on each device's own rows and heads. Without an
installed mesh, or given plain tensors, all three call or return their
input unchanged, so every eager path, on the card or on the CPU, runs as
before.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional, Sequence, Tuple, Union

import torch

_STATE: dict = {"mesh": None, "dp": ()}


def install_mesh(mesh) -> None:
    """Install ``mesh`` (a ``DeviceMesh`` with named dimensions) or, with
    None, remove it."""
    if mesh is None:
        _STATE["mesh"] = None
        _STATE["dp"] = ()
        return
    names = mesh.mesh_dim_names
    _STATE["mesh"] = mesh
    _STATE["dp"] = tuple(a for a in ("pod", "data") if a in names)


@contextlib.contextmanager
def mesh_context(mesh):
    prev = (_STATE["mesh"], _STATE["dp"])
    install_mesh(mesh)
    try:
        yield
    finally:
        _STATE["mesh"], _STATE["dp"] = prev


def _size(axis: str) -> int:
    mesh = _STATE["mesh"]
    return int(mesh.mesh.shape[mesh.mesh_dim_names.index(axis)])


def _dp(batch_dim_size: int):
    """The data-parallel axes if they divide the batch dim, else None."""
    dp = _STATE["dp"]
    if _STATE["mesh"] is None or not dp:
        return None
    if batch_dim_size % math.prod(_size(a) for a in dp):
        return None
    return dp if len(dp) > 1 else dp[0]


class _Pin(torch.autograd.Function):
    """A ``DTensor`` redistributed to ``want``, and its gradient too: the
    transpose of ``with_sharding_constraint`` is the same constraint on the
    cotangent, so a pinned activation's gradient is reduced and laid out
    as the activation is, not left as partial sums."""

    @staticmethod
    def forward(ctx, x, mesh, want):
        ctx.mesh, ctx.want = mesh, want
        return x if tuple(x.placements) == want else x.redistribute(mesh,
                                                                    want)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) != ctx.want:
            grad = grad.redistribute(ctx.mesh, ctx.want)
        return grad, None, None


def _constraint(x: torch.Tensor, spec) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from repro_torch.sharding.rules import placements
    mesh = _STATE["mesh"]
    return _Pin.apply(x, mesh, tuple(placements(spec, mesh)))


def shard_activation(h: torch.Tensor, seq_over_model: bool = False
                     ) -> torch.Tensor:
    """``(B, S, d)`` residual-stream pin: the batch over data(+pod);
    optionally the sequence dim over ``model`` (context parallelism)."""
    if _STATE["mesh"] is None:
        return h
    spec = [None] * h.dim()
    spec[0] = _dp(h.shape[0])
    if seq_over_model and h.dim() >= 3 and h.shape[1] % _size("model") == 0:
        spec[1] = "model"
    return _constraint(h, tuple(spec))


def gather_weights(tree):
    """``tree`` (one layer's parameters, or a head's) with every ``DTensor``
    leaf gathered over data(+pod) and kept as it is split over ``model``:
    the all-gather of fully-sharded data parallelism before a layer runs,
    which XLA's partitioner issues for the reference's 2-D rules. Its
    backward reduce-scatters the gradients back to their shards. Without
    a mesh, ``tree`` itself."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = _STATE["mesh"]
    if mesh is None:
        return tree
    dp = _STATE["dp"]

    names = mesh.mesh_dim_names
    m = _size("model") if "model" in names else 1

    def one(t):
        if not isinstance(t, DTensor):
            return t
        want = [Replicate() if a in dp else p
                for a, p in zip(names, t.placements)]
        split = [p.dim for a, p in zip(names, t.placements)
                 if a in dp and p.is_shard()]
        if (split and m > 1 and t.dim() >= 2
                and not t.placements[names.index("model")].is_shard()
                and t.shape[split[0]] % m == 0):
            # a matrix the rules leave whole on model: split there on its
            # fsdp dim, so each device computes a share of the product
            want[names.index("model")] = Shard(split[0])
        if tuple(want) == tuple(t.placements):
            return t
        return t.redistribute(mesh, want)
    return torch.utils._pytree.tree_map(one, tree)


def shard_logits(logits: torch.Tensor) -> torch.Tensor:
    """``(B, S, V)`` or ``(B, V)``: the batch over data(+pod), the
    vocabulary over ``model``."""
    if _STATE["mesh"] is None:
        return logits
    v = logits.shape[-1]
    spec = [None] * logits.dim()
    spec[0] = _dp(logits.shape[0])
    spec[-1] = "model" if v % _size("model") == 0 else None
    return _constraint(logits, tuple(spec))


def head_parallel(body: Callable, args: Sequence, layouts: Sequence,
                  out_layouts: Union[str, Tuple[str, ...]], *, heads: int,
                  kv_heads: Optional[int] = None):
    """``body(*args)`` for a region whose work is independent per (batch
    row, head), run on each device's own rows and heads: what XLA's
    partitioner does with the reference's einsums, where ``DTensor``
    cannot carry a split through a reshape that merges the batch with the
    heads and gathers instead.

    ``layouts`` names each argument's dims, one letter a dim: ``b`` the
    batch, ``h`` the query heads, ``k`` the kv heads, ``.`` anything else
    (a dim that merges heads with the head dim, ``(H·hd)``, is ``h``: the
    heads are its leading factor); None for an argument that is not a
    tensor. ``out_layouts`` names the dims of ``body``'s output, or of each
    output of a tuple. The batch goes over data(+pod) where they divide it;
    the query heads over ``model`` where it divides ``heads``, else the
    batch goes over ``model`` too where it divides the device's rows, and
    otherwise nothing is split over ``model``. The kv heads (``kv_heads``,
    default ``heads``) go over ``model`` with them where it divides them;
    else, when each device's query heads read one kv head (MQA, or GQA
    with a group of at least the device's heads), the kv heads stay whole
    and each device reads its own head of them, as XLA slices a replicated
    operand; otherwise the heads stay whole. A dim of size 1 is never
    split.

    With no mesh installed, or with no ``DTensor`` among ``args``, this is
    ``body(*args)``: the same ops, the same bits. On ``DTensor`` arguments
    it is ``local_map``: the arguments are redistributed to those
    placements, ``body`` runs on the local shards, and its outputs are laid
    out as ``out_layouts`` says. Gradients flow through it; an argument
    that is whole on an axis the work is split over gets a partial sum on
    that axis as its gradient."""
    from torch.distributed.tensor import DTensor
    mesh = _STATE["mesh"]
    if mesh is None or not any(isinstance(a, DTensor) for a in args):
        return body(*args)
    kv = kv_heads or heads
    m = _size("model") if "model" in mesh.mesh_dim_names else 1
    # group % (the device's query heads) == 0: they read one kv head
    slice_kv = kv % m != 0 and heads % m == 0 \
        and (heads // kv) % (heads // m) == 0
    split = "model" if heads % m == 0 and (kv % m == 0 or slice_kv) \
        else None
    batch = _batch(args, layouts)
    rows = _dp(batch)
    if split is None and m > 1 and batch % (m * math.prod(
            _size(a) for a in _axes(rows))) == 0:
        rows = _axes(rows) + ("model",)   # the rows, not the heads, split
    axis_of = {"b": rows, "h": split, "k": None if slice_kv else split}
    kv_dims = [layout.index("k") if layout and "k" in layout else None
               for layout in layouts]

    def local(*xs):
        if slice_kv:
            j = mesh.get_local_rank("model") * (heads // m) // (heads // kv)
            xs = tuple(x.narrow(d, j, 1) if d is not None and x.shape[d] > 1
                       else x for x, d in zip(xs, kv_dims))
        return body(*xs)
    return _local_region(local, args, layouts, out_layouts, axis_of)


def keys_split(t: torch.Tensor, dim: int) -> bool:
    """Whether ``t`` is a ``DTensor`` on the installed mesh whose dim
    ``dim`` (a decode cache's rows) is split over ``model``."""
    from torch.distributed.tensor import DTensor
    mesh = _STATE["mesh"]
    if mesh is None or not isinstance(t, DTensor) \
            or "model" not in mesh.mesh_dim_names:
        return False
    p = t.placements[mesh.mesh_dim_names.index("model")]
    return p.is_shard() and p.dim == dim % t.dim()


def key_parallel(body: Callable, args: Sequence, layouts: Sequence,
                 out_layout: str):
    """One decode step's attention over a cache whose rows ``model``
    splits (:func:`keys_split`), run on each device's own batch rows and
    cache rows, as XLA's partitioner runs the reference's decode step: the
    cache stays where it lies, and the softmax's max and sums and the
    value product are all-reduced over ``model``. ``layouts`` as
    :func:`head_parallel`'s, with ``s`` for the cache's rows (split over
    ``model``; the heads stay whole); ``body(*args, reduce=...)`` gets
    ``reduce(t, op)``, the all-reduce (``"max"`` or ``"sum"``) of a
    partial result over ``model``. Only called on a mesh (a decode step
    has no backward)."""
    import torch.distributed._functional_collectives as funcol
    mesh = _STATE["mesh"]
    axis = (mesh, mesh.mesh_dim_names.index("model"))

    def reduce(t, op):
        return funcol.wait_tensor(funcol.all_reduce(t, op, axis))

    def local(*xs):
        return body(*xs, reduce=reduce)
    return _local_region(local, args, layouts, out_layout,
                         {"b": _dp(_batch(args, layouts)), "s": "model"})


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``. On a mesh, the table is gathered over the data axes
    (:func:`gather_weights`) and, where ``model`` splits its rows, looked
    up vocabulary-parallel, as XLA's partitioner runs the reference's
    gather: each device reads the ids its rows hold, zero elsewhere, and
    the rows are all-reduced over ``model`` (``DTensor``'s own strategy
    for an index into a row-split table changes with the torch release:
    one gathers the whole table)."""
    from torch.distributed.tensor import DTensor
    mesh = _STATE["mesh"]
    if mesh is None or not isinstance(table, DTensor):
        return table[ids]
    table = gather_weights(table)
    if not keys_split(table, 0):
        return table[ids]
    import torch.distributed._functional_collectives as funcol
    axis = (mesh, mesh.mesh_dim_names.index("model"))

    def local(rows, ids):
        first = mesh.get_local_rank("model") * rows.shape[0]
        at = ids - first
        held = (at >= 0) & (at < rows.shape[0])
        out = rows[at.clamp(0, rows.shape[0] - 1)] * held[..., None]
        return funcol.wait_tensor(funcol.all_reduce(out, "sum", axis))
    tail = "." * (ids.dim() - 1)
    return _local_region(local, (table, ids), ("s.", "b" + tail),
                         "b." + tail, {"b": _dp(ids.shape[0]), "s": "model"})


def _batch(args: Sequence, layouts: Sequence) -> int:
    """The batch size: the first ``b`` dim of more than one row."""
    return next((t.shape[layout.index("b")] for t, layout
                 in zip(args, layouts)
                 if layout and "b" in layout
                 and t.shape[layout.index("b")] > 1), 1)


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _local_region(local: Callable, args: Sequence, layouts: Sequence,
                  out_layouts: Union[str, Tuple[str, ...]], axis_of):
    """``local_map`` of ``local`` over ``args``: each dim of a layout goes
    over ``axis_of[letter]`` (None: whole; a dim of size 1 always whole),
    a plain tensor joins as replicated, and an argument whole on an axis
    the work is split over gets a partial-sum gradient there."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.sharding.rules import placements
    mesh = _STATE["mesh"]
    names = mesh.mesh_dim_names
    work = {a for e in axis_of.values() for a in _axes(e)}

    def spec(layout, shape=None):
        return tuple(None if shape is not None and shape[i] == 1
                     else axis_of.get(ch) for i, ch in enumerate(layout))
    in_pl, in_grad, local_args = [], [], []
    for a, layout in zip(args, layouts):
        if not isinstance(a, torch.Tensor):
            in_pl.append(None)
            in_grad.append(None)
            local_args.append(a)
            continue
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * len(names),
                                   run_check=False)
        sp = spec(layout, a.shape)
        held = {x for e in sp for x in _axes(e)}
        pl = tuple(placements(sp, mesh))
        in_pl.append(pl)
        in_grad.append(tuple(Partial() if n in work and n not in held
                             else p for n, p in zip(names, pl)))
        local_args.append(a)
    outs = (out_layouts,) if isinstance(out_layouts, str) else out_layouts
    # one list of placements an output: local_map reads a tuple as one
    # entry an output
    out_pl = tuple(placements(spec(o), mesh) for o in outs)
    return local_map(local, out_pl, in_placements=tuple(in_pl),
                     in_grad_placements=tuple(in_grad), device_mesh=mesh,
                     redistribute_inputs=True)(*local_args)
