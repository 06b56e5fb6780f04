"""RGCN encoder (Schlichtkrull et al., 2018) in PyTorch (port of
``repro/models/rgcn.py``; paper §2.1).

Message passing (paper Eq. 1)::

    h'_s = sigma( W_0 h_s  +  sum_{(r,t) in N_s} (1/c_s) W_r h_t )

with the basis decomposition ``W_r = sum_b a_rb V_b`` (the paper's), the
block-diagonal decomposition ``W_r = diag(Q_r1 .. Q_rB)``, or full
per-relation matrices.

Parameters live in :class:`RGCNLayer` modules whose parameter names are the
reference's tree keys (``bases``, ``coeffs``, ``blocks``, ``rel_weight``,
``self_weight``); a layer also reads like that tree (``"bases" in lp``,
``lp["bases"]``), so the functions below take a layer module or a plain
dict of tensors alike. With ``use_kernel`` and the basis decomposition the
edge compute goes through ``kernels.ops.rgcn_message_basis`` (the two CUDA
kernels on the card); otherwise through :func:`message_passing_ref`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.kernels.ops import gather_rows


@dataclasses.dataclass(frozen=True)
class RGCNConfig:
    num_entities: int
    num_relations: int        # AFTER adding inverse relations
    hidden_dim: int = 75      # paper: 75 on FB15k-237, 32 on ogbl-citation2
    num_layers: int = 2       # paper: 2-layer RGCN
    num_bases: int = 2        # paper: 2 basis functions
    feature_dim: Optional[int] = None  # None => learned entity embeddings
    decomposition: str = "basis"       # "basis" | "block" | "none"
    num_blocks: int = 4                # for block-diagonal decomposition
    dropout: float = 0.2
    self_loop: bool = True
    use_kernel: bool = False  # route basis edge compute through the kernels
    num_table_shards: int = 1  # >1: entity table stored (S, rows, d), row-
    #   sharded (repro_torch.sharding.embedding); the gather becomes the
    #   simulated shard-local gather + exchange, bitwise the dense gather
    gather_exchange: Optional[str] = None  # simulated exchange layout
    #   ("fused" default, "masked_sum"; sharding.embedding.SIM_EXCHANGES)
    table_dtype: str = "fp32"  # "fp32" | "int8": int8 keeps the fp32
    #   master for Adam and gathers it quantized (straight-through)

    def layer_in_dim(self, layer: int) -> int:
        if layer == 0:
            return self.feature_dim or self.hidden_dim
        return self.hidden_dim


# ====================================================================== #
# Parameters
# ====================================================================== #
def layer_param_shapes(cfg: RGCNConfig,
                       layer: int) -> Dict[str, Tuple[int, ...]]:
    """Name → shape of one layer's parameters, in the reference's order."""
    d_in, d_out = cfg.layer_in_dim(layer), cfg.hidden_dim
    if cfg.decomposition == "basis":
        shapes = {"bases": (cfg.num_bases, d_in, d_out),
                  "coeffs": (cfg.num_relations, cfg.num_bases)}
    elif cfg.decomposition == "block":
        if d_in % cfg.num_blocks or d_out % cfg.num_blocks:
            raise ValueError("dims must divide num_blocks")
        shapes = {"blocks": (cfg.num_relations, cfg.num_blocks,
                             d_in // cfg.num_blocks,
                             d_out // cfg.num_blocks)}
    elif cfg.decomposition == "none":
        shapes = {"rel_weight": (cfg.num_relations, d_in, d_out)}
    else:
        raise ValueError(cfg.decomposition)
    if cfg.self_loop:
        shapes["self_weight"] = (d_in, d_out)
    return shapes


def glorot(rng: np.random.Generator, shape: Sequence[int]) -> np.ndarray:
    """Glorot-normal draw over the last two axes, as float32."""
    fan_in, fan_out = (shape[-2] if len(shape) > 1 else 1), shape[-1]
    scale = np.sqrt(2.0 / (fan_in + fan_out))
    return (rng.standard_normal(tuple(shape)) * scale).astype(np.float32)


class TreeModule(nn.Module):
    """A module that also reads like the reference's parameter tree:
    ``name in m`` and ``m[name]`` for its parameters and submodules."""

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def __getitem__(self, name: str):
        if name not in self:
            raise KeyError(name)
        return getattr(self, name)


class RGCNLayer(TreeModule):
    """One layer's parameters, named as the reference's layer dict."""

    def __init__(self, shapes: Mapping[str, Tuple[int, ...]],
                 device=None):
        super().__init__()
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(
                torch.zeros(shape, dtype=torch.float32, device=device)))


def rgcn_layers(cfg: RGCNConfig, device=None) -> nn.ModuleList:
    """Zero-initialised layers for ``cfg`` (fill them with
    :func:`init_rgcn_layers` or from the reference's tree)."""
    return nn.ModuleList([RGCNLayer(layer_param_shapes(cfg, i), device)
                          for i in range(cfg.num_layers)])


@torch.no_grad()
def init_rgcn_layers(layers: nn.ModuleList, rng: np.random.Generator
                     ) -> None:
    """Glorot-initialise every layer parameter in place, in order."""
    for layer in layers:
        for p in layer.parameters():
            p.copy_(torch.from_numpy(glorot(rng, p.shape)))


# ====================================================================== #
# Message passing
# ====================================================================== #
def relation_matrices(lp: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Materialise ``(R, d_in, d_out)`` from the decomposition (reference
    path; the kernel path never builds these)."""
    if "bases" in lp:
        return torch.einsum("rb,bio->rio", lp["coeffs"], lp["bases"])
    if "blocks" in lp:
        r, nb, bi, bo = lp["blocks"].shape
        w = lp["blocks"].new_zeros((r, nb * bi, nb * bo))
        for b in range(nb):
            w[:, b * bi:(b + 1) * bi, b * bo:(b + 1) * bo] = \
                lp["blocks"][:, b]
        return w
    return lp["rel_weight"]


def message_passing_ref(h: torch.Tensor, src: torch.Tensor,
                        rel: torch.Tensor, dst: torch.Tensor,
                        edge_mask: torch.Tensor,
                        lp: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Plain edge compute + mean aggregation, ``(V, d_out)`` (no self loop
    or activation). An edge ``(s, r, t)`` carries ``W_r h_t`` into ``s``.

    Row gathers are ``kernels.ops.gather_rows``: its backward is the
    deterministic ``scatter_add_onehot``, where advanced indexing's
    backward (``indexing_backward_kernel`` on CUDA) serialises over
    duplicate ids — 474 relation rows gathered for 378k edges — and
    ``index_add_`` adds with float atomics in no fixed order."""
    h_t = gather_rows(h, dst)
    if "bases" in lp:
        # B projections once, then the per-edge coefficient mix
        proj = torch.einsum("ed,bdo->ebo", h_t, lp["bases"])
        msg = torch.einsum("ebo,eb->eo", proj,
                           gather_rows(lp["coeffs"], rel))
    elif "blocks" in lp:
        r, nb, bi, bo = lp["blocks"].shape
        e = h_t.shape[0]
        w_e = gather_rows(lp["blocks"], rel)              # (E, nb, bi, bo)
        msg = torch.einsum("enb,enbo->eno", h_t.reshape(e, nb, bi),
                           w_e).reshape(e, nb * bo)
    else:
        msg = torch.einsum("ed,edo->eo", h_t,
                           gather_rows(lp["rel_weight"], rel))
    msg = torch.where(edge_mask[:, None], msg, torch.zeros_like(msg))
    num_v = h.shape[0]
    agg = msg.new_zeros((num_v, msg.shape[1])).index_add_(0, src, msg)
    deg = msg.new_zeros(num_v).index_add_(0, src, edge_mask.to(msg.dtype))
    return agg / torch.clamp_min(deg, 1.0)[:, None]


def rgcn_layer(h: torch.Tensor, src: torch.Tensor, rel: torch.Tensor,
               dst: torch.Tensor, edge_mask: torch.Tensor,
               lp: Mapping[str, torch.Tensor], cfg: RGCNConfig, *,
               activation: Callable = torch.relu,
               dropout_generator: Optional[torch.Generator] = None
               ) -> torch.Tensor:
    if cfg.use_kernel and "bases" in lp:
        from repro_torch.kernels.ops import rgcn_message_basis
        agg = rgcn_message_basis(h, src, rel, dst, edge_mask, lp["bases"],
                                 lp["coeffs"])
    else:
        agg = message_passing_ref(h, src, rel, dst, edge_mask, lp)
    if cfg.self_loop:
        agg = agg + torch.matmul(h, lp["self_weight"])
    out = activation(agg)
    if dropout_generator is not None and cfg.dropout > 0:
        keep = torch.rand(out.shape, generator=dropout_generator,
                          device=out.device) < (1 - cfg.dropout)
        out = torch.where(keep, out / (1 - cfg.dropout),
                          torch.zeros_like(out))
    return out


def rgcn_encode(params: Mapping, cfg: RGCNConfig,
                vertex_input: torch.Tensor,
                src: torch.Tensor, rel: torch.Tensor, dst: torch.Tensor,
                edge_mask: torch.Tensor, *,
                dropout_generator: Optional[torch.Generator] = None,
                train: bool = False) -> torch.Tensor:
    """All layers of ``params["layers"]`` on a (padded) computational
    graph. The last layer is linear (scores need signed values); with
    ``train`` and a generator every layer's output goes through dropout,
    drawn layer by layer."""
    layers = params["layers"]
    h = vertex_input
    n_layers = len(layers)
    gen = dropout_generator if train else None
    for i, lp in enumerate(layers):
        act = torch.relu if i < n_layers - 1 else (lambda x: x)
        h = rgcn_layer(h, src, rel, dst, edge_mask, lp, cfg, activation=act,
                       dropout_generator=gen)
    return h

