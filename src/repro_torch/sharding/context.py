"""Activation-sharding context (port of ``repro/sharding/context.py``).

The model code is mesh-agnostic; a caller (the dry run,
``launch/dryrun.py``) installs a ``DeviceMesh`` here, and
:func:`shard_activation` / :func:`shard_logits` redistribute a ``DTensor``
to the reference's ``with_sharding_constraint`` placement: the batch over
data(+pod), the vocabulary over ``model``. Without an installed mesh, or
given a plain tensor, they return their input unchanged, so every eager
path, on the card or on the CPU, runs as before.
"""
from __future__ import annotations

import contextlib
import math

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


def _constraint(x: torch.Tensor, spec) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from repro_torch.sharding.rules import placements
    mesh = _STATE["mesh"]
    want = placements(spec, mesh)
    if tuple(x.placements) == tuple(want):
        return x
    return x.redistribute(mesh, want)


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
