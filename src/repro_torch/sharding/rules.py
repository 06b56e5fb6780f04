"""Parameter, batch and cache sharding rules of the LM substrate (port of
``repro/sharding/rules.py:37-224``).

MaxText-style 2-D sharding: every large weight matrix is sharded over the
``fsdp`` axes (``data``, plus ``pod`` on the multi-pod mesh) on one
dimension and over the ``tensor`` axis (``model``) on the other; expert
tensors put the expert dimension on ``model``. Rules go by leaf name,
with the reference's divisibility guard: a dimension that the axis does
not divide is replicated on it.

A spec is a plain tuple with one entry per dimension: ``None``, a mesh
axis name, or a tuple of names (``("pod", "data")``) — what the
reference's ``PartitionSpec`` holds, so the two compare ``==``. A mesh is
anything :func:`mesh_axes` reads: a ``DeviceMesh`` with named dimensions,
or a mapping of axis name to size in mesh order. :func:`placements` turns
a spec into ``DTensor`` placements on a ``DeviceMesh``, :func:`shard_shape`
gives a spec's per-device shape.

The KGE half of the reference module (``kge_param_specs``, the entity
table's row block on the model axis) is ported in ``launch/mesh.py``,
beside the process mesh the multi-process step runs on.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Sequence, Tuple, Union

import torch

from repro_torch.nn.transformer import leaves

PyTree = Any
Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]

# trailing-dims logical rule per leaf name; leading (layer-stack) dims None
_RULES = {
    # embeddings / heads
    "embed": ("tensor", "fsdp"),          # (V, d): vocab on tensor
    "lm_head": ("fsdp", "tensor"),        # (d, V)
    "vision_proj": (None, "fsdp"),
    # attention
    "w_q": ("fsdp", "tensor"),
    "w_k": ("fsdp", "tensor"),
    "w_v": ("fsdp", "tensor"),
    "w_o": ("tensor", "fsdp"),
    "b_q": ("tensor",),
    "b_k": ("tensor",),
    "b_v": ("tensor",),
    # MLA
    "w_dkv": ("fsdp", None),
    "w_krope": ("fsdp", None),
    "w_ukv": (None, "tensor"),
    # MLP (2-D) and MoE experts (3-D, expert dim first)
    "w_in": ("fsdp", "tensor"),
    "w_gate": ("fsdp", "tensor"),
    "w_out": ("tensor", "fsdp"),
    "router": ("fsdp", None),
    # rwkv / rglru
    "w_r": ("fsdp", "tensor"),
    "w_g": ("fsdp", "tensor"),
    "w_x": ("fsdp", "tensor"),
    "w_y": ("fsdp", "tensor"),
    "w_input_gate": ("fsdp", "tensor"),
    "w_rec_gate": ("fsdp", "tensor"),
    "decay_A": ("fsdp", None),
    "decay_B": (None, "fsdp"),
    # KGE tables: rows over the model axis (sharding/embedding.py)
    "entity_embedding": ("tensor", None),
    "rel_diag": ("tensor", None),
    "rel_vec": ("tensor", None),
    "rel_complex": ("tensor", None),
    "rel_phase": ("tensor", None),
}
_EXPERT_RULES = {   # under a "moe" scope, 3-D expert tensors
    "w_in": ("tensor", "fsdp", None),
    "w_gate": ("tensor", "fsdp", None),
    "w_out": ("tensor", None, "fsdp"),
}
# sharded-layout entity table (S, rows, d): shard dim on the model axis
_SHARDED_TABLE_RULES = {
    "entity_embedding": ("tensor", None, None),
}


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` in mesh order, of a ``DeviceMesh`` with named
    dimensions or of a mapping (returned as a dict)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the rules need a mesh with named dimensions")
    return {n: int(s) for n, s in zip(names, mesh.mesh.shape)}


def fsdp_axes(mesh) -> Tuple[str, ...]:
    names = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _axis_size(mesh, logical) -> int:
    axes = mesh_axes(mesh)
    if logical == "fsdp":
        return math.prod(axes[a] for a in fsdp_axes(mesh))
    if logical == "tensor":
        return int(axes["model"])
    return 1


def _resolve(logical, mesh, mode: str = "2d") -> Axis:
    if logical == "fsdp":
        ax = fsdp_axes(mesh)
        return ax if len(ax) > 1 else ax[0]
    if logical == "tensor":
        # "1d": no tensor parallelism, the model axis replicates
        return None if mode == "1d" else "model"
    return None


def spec_for_param(path_names: Sequence[str], shape: Tuple[int, ...],
                   mesh, mode: str = "2d") -> Spec:
    """Sharding spec of one parameter leaf."""
    name = path_names[-1]
    in_moe = "moe" in path_names
    rule = None
    if in_moe and name in _EXPERT_RULES and len(shape) >= 3:
        rule = _EXPERT_RULES[name]
    elif name in _SHARDED_TABLE_RULES and len(shape) == 3:
        rule = _SHARDED_TABLE_RULES[name]
    elif name in _RULES:
        rule = _RULES[name]
    if rule is None or len(shape) < len(rule):
        return ()
    lead = len(shape) - len(rule)
    spec = [None] * lead
    for dim, logical in zip(shape[lead:], rule):
        resolved = _resolve(logical, mesh, mode)
        if resolved is not None and dim % _axis_size(mesh, logical) == 0:
            spec.append(resolved)
        else:
            spec.append(None)
    return tuple(spec)


def _named(tree: PyTree):
    """``(path names, tensor)`` of every leaf, the dotted names of
    ``transformer.leaves`` split at the dots."""
    for name, t in leaves(tree):
        yield tuple(name.split(".")), t


def param_shardings(params: PyTree, mesh, mode: str = "2d"
                    ) -> Dict[str, Spec]:
    """The spec of every parameter leaf by its dotted name (``"2d"``: fsdp
    x tensor; ``"1d"``: fsdp only)."""
    return {".".join(p): spec_for_param(p, tuple(t.shape), mesh, mode)
            for p, t in _named(params)}


def opt_state_shardings(opt_state, param_sh: Mapping[str, Spec], mesh):
    """Adam's moments follow their parameters, the step scalar is
    replicated (an ``OptState`` of specs)."""
    mu = dict(param_sh) if opt_state.mu is not None else None
    nu = dict(param_sh) if opt_state.nu is not None else None
    return type(opt_state)(step=(), mu=mu, nu=nu)


# ---------------------------------------------------------------------- #
# Batch / cache shardings
# ---------------------------------------------------------------------- #
def _dp(mesh) -> Tuple[Axis, int]:
    dp = fsdp_axes(mesh)
    size = math.prod(mesh_axes(mesh)[a] for a in dp)
    return (dp if len(dp) > 1 else dp[0]), size


def spec_for_batch_leaf(shape: Tuple[int, ...], mesh) -> Spec:
    """Token-style inputs: the leading batch dim over the data(+pod)
    axes, when they divide it."""
    lead, dp_size = _dp(mesh)
    if len(shape) >= 1 and shape[0] % dp_size == 0:
        return (lead,) + (None,) * (len(shape) - 1)
    return (None,) * len(shape)


def batch_shardings(batch: Mapping[str, torch.Tensor], mesh
                    ) -> Dict[str, Spec]:
    return {k: spec_for_batch_leaf(tuple(v.shape), mesh)
            for k, v in batch.items()}


def spec_for_cache_leaf(path_names: Sequence[str], shape: Tuple[int, ...],
                        mesh) -> Spec:
    """Decode caches: batch over data(+pod); the long sequence dim over
    ``model`` when divisible (KV-head counts are mostly below 16, so the
    sequence is sharded)."""
    lead, dp_size = _dp(mesh)
    tensor = int(mesh_axes(mesh)["model"])
    name = path_names[-1]
    spec = [None] * len(shape)
    # the batch dim: attn k/v (L, B, S, H, hd) or (B, S, H, hd); c_kv and
    # k_rope (L, B, S, r); states (L, B, ...)
    nd = len(shape)
    b_idx = nd - 4 if name in ("k", "v") else (1 if nd >= 3 else 0)
    if name in ("c_kv", "k_rope"):
        b_idx = nd - 3
    if 0 <= b_idx < nd and shape[b_idx] % dp_size == 0 and shape[b_idx] > 1:
        spec[b_idx] = lead
    # the sequence dim, right after the batch for k/v and c_kv/k_rope
    if name in ("k", "v", "c_kv", "k_rope"):
        s_idx = b_idx + 1
        if shape[s_idx] % tensor == 0:
            spec[s_idx] = "model"
    elif name in ("wkv",):
        # (L, B, H, hd, hd): heads over model when divisible
        if shape[-3] % tensor == 0:
            spec[-3] = "model"
    elif name in ("h", "conv", "x_prev", "cmix_x_prev", "encoder_out"):
        if shape[-1] % tensor == 0:
            spec[-1] = "model"
    return tuple(spec)


def cache_shardings(cache: PyTree, mesh) -> Dict[str, Spec]:
    return {".".join(p): spec_for_cache_leaf(p, tuple(t.shape), mesh)
            for p, t in _named(cache)}


# ---------------------------------------------------------------------- #
# Specs on a DeviceMesh
# ---------------------------------------------------------------------- #
def _axes_of(entry: Axis) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_shape(spec: Spec, shape: Sequence[int], mesh) -> Tuple[int, ...]:
    """Per-device shape of a ``shape`` laid out by ``spec`` (the rules only
    shard dims their axes divide)."""
    axes = mesh_axes(mesh)
    out = []
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        n = math.prod(axes[a] for a in _axes_of(entry))
        if dim % n:
            raise ValueError(f"dim {i} ({dim}) of {tuple(shape)} is not a "
                             f"multiple of {n} (spec {spec})")
        out.append(dim // n)
    return tuple(out)


def placements(spec: Spec, mesh) -> list:
    """``DTensor`` placements of ``spec`` on ``mesh``, one per mesh
    dimension: ``Shard(d)`` where the spec puts that axis on tensor dim
    ``d``, ``Replicate()`` elsewhere. Two axes on one dim shard it in mesh
    order (``("pod", "data")``: ``pod`` major), as the reference lays
    them out."""
    from torch.distributed.tensor import Replicate, Shard
    where: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        for a in _axes_of(entry):
            where[a] = d
    return [Shard(where[a]) if a in where else Replicate()
            for a in mesh_axes(mesh)]


def spec_bytes(spec: Spec, t: torch.Tensor, mesh) -> int:
    """Per-device bytes of ``t`` laid out by ``spec``."""
    return math.prod(shard_shape(spec, tuple(t.shape), mesh)) \
        * t.element_size()
