"""Relation-aware graph attention encoder (port of
``repro/models/rgat.py``; paper refs. [26, 30], the authors' companion
models). It shares the RGCN encoder's interface, so it slots into the same
partition / expansion / mini-batch pipeline: the paper's point that the
distributed approach is agnostic to the embedding model.

Per edge ``(s, r, t)``: ``e_srt = LeakyReLU(a · [W h_s ‖ W h_t ‖ w_r])``,
attention is the masked softmax over the edges of head ``s``, and
``h'_s = σ(Σ α_srt · W h_t + W_0 h_s)``.

Written as the RGCN edge compute is (``models/rgcn.py``
``message_passing_ref``): the row gathers ``W h[src]``, ``W h[dst]``,
``rel_feat[rel]`` and the softmax's denominator go through
``kernels.ops.gather_rows`` (deterministic ``scatter_add_onehot``
backward), and both segment sums, the denominator and the aggregation,
through ``kernels.ops.segment_sum_op``, each over the
:class:`~repro_torch.kernels.ops.EdgePlans` of the edges: the same kernels
on the card, no float atomics. The segment max is ``scatter_reduce``'s
``amax``, deterministic, and taken detached: the softmax does not depend
on the constant it subtracts, and the reference's gradient through it
cancels.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import (
    EdgePlans, gather_rows, segment_sum_op, wants_grad,
)
from repro_torch.models.rgcn import RGCNConfig, glorot

NEG = -1e30            # the reference's masked logit
DENOM_FLOOR = 1e-20    # the reference's floor under the denominator
NEGATIVE_SLOPE = 0.2


@dataclasses.dataclass(frozen=True)
class RGATConfig:
    base: RGCNConfig
    num_rel_dims: int = 16     # relation feature size in the attention


def init_rgat_params(rng: np.random.Generator, cfg: RGATConfig,
                     device=None) -> Dict[str, Any]:
    """Glorot-normal parameters in the reference's tree and order: the
    entity table (embedding mode), then per layer ``w``, ``rel_feat``,
    ``attn`` and ``self_weight``, as fp32 tensors on ``device`` (default
    CPU). The draws differ from JAX's; parity tests start both sides from
    the reference's (``convert.rgat_params_from_jax``)."""
    b = cfg.base

    def draw(*shape):
        return torch.tensor(glorot(rng, shape), device=device)
    params: Dict[str, Any] = {}
    if b.feature_dim is None:
        params["entity_embedding"] = draw(b.num_entities, b.hidden_dim)
    layers = []
    for layer in range(b.num_layers):
        d_in, d_out = b.layer_in_dim(layer), b.hidden_dim
        layers.append({
            "w": draw(d_in, d_out),
            "rel_feat": draw(b.num_relations, cfg.num_rel_dims),
            "attn": draw(2 * d_out + cfg.num_rel_dims, 1),
            "self_weight": draw(d_in, d_out),
        })
    params["layers"] = layers
    return params


def _segment_softmax(logits: torch.Tensor, seg: torch.Tensor,
                     mask: torch.Tensor, num_segments: int,
                     plans: Optional[EdgePlans] = None) -> torch.Tensor:
    """Numerically stable softmax over the edges grouped by head vertex
    ``seg``; masked edges get 0. ``plans``: the edges' plans (``seg`` is
    their ``src``)."""
    logits = torch.where(mask, logits, NEG)
    seg_max = torch.zeros(num_segments, dtype=logits.dtype,
                          device=logits.device).scatter_reduce(
        0, seg.long(), logits.detach(), "amax", include_self=False)
    z = torch.exp(logits - torch.index_select(seg_max, 0, seg.long()))
    z = torch.where(mask, z, 0.0)
    denom, _ = segment_sum_op(z[:, None], seg, mask, num_segments,
                              _plan(plans, "src", z))
    denom_e = gather_rows(denom[:, 0], seg, _plan(plans, "src_all", denom))
    return z / torch.clamp_min(denom_e, DENOM_FLOOR)


def _plan(plans: Optional[EdgePlans], name: str, *leaves):
    """``plans[name]`` where a gradient will flow, as the RGCN path."""
    if plans is None or (name != "src" and not wants_grad(*leaves)):
        return None
    return plans[name]


def rgat_layer(h: torch.Tensor, src: torch.Tensor, rel: torch.Tensor,
               dst: torch.Tensor, edge_mask: torch.Tensor,
               lp: Dict[str, torch.Tensor], *,
               activation: Callable = torch.relu,
               plans: Optional[EdgePlans] = None) -> torch.Tensor:
    """One attention layer on a (padded) computational graph."""
    v = h.shape[0]
    if plans is None:
        plans = EdgePlans(src, rel, dst, edge_mask, v,
                          lp["rel_feat"].shape[0])
    wh = h @ lp["w"]                                   # (V, d_out)
    wh_s = gather_rows(wh, src, _plan(plans, "src_all", wh))
    wh_t = gather_rows(wh, dst, _plan(plans, "dst", wh))
    rf = gather_rows(lp["rel_feat"], rel,
                     _plan(plans, "rel", lp["rel_feat"]))   # (E, r)
    feat = torch.cat([wh_s, wh_t, rf], dim=-1)
    logits = F.leaky_relu((feat @ lp["attn"])[:, 0],
                          negative_slope=NEGATIVE_SLOPE)     # (E,)
    alpha = _segment_softmax(logits, src, edge_mask, v, plans)
    msg = torch.where(edge_mask[:, None], alpha[:, None] * wh_t, 0.0)
    agg, _ = segment_sum_op(msg, src, edge_mask, v, plans["src"])
    return activation(agg + h @ lp["self_weight"])


def rgat_encode(params: Dict[str, Any], cfg: RGATConfig,
                vertex_input: torch.Tensor, src: torch.Tensor,
                rel: torch.Tensor, dst: torch.Tensor,
                edge_mask: torch.Tensor, *,
                plans: Optional[EdgePlans] = None,
                **_ignored) -> torch.Tensor:
    """Every layer of ``params["layers"]``, ReLU between them and the last
    one linear: the same call as ``rgcn_encode``. The layers share one set
    of edge plans (``plans``, or made here and built at first use)."""
    h = vertex_input
    layers = params["layers"]
    if plans is None:
        plans = EdgePlans(src, rel, dst, edge_mask, h.shape[0],
                          cfg.base.num_relations)
    for i, lp in enumerate(layers):
        act = torch.relu if i < len(layers) - 1 else (lambda x: x)
        h = rgat_layer(h, src, rel, dst, edge_mask, lp, activation=act,
                       plans=plans)
    return h
