"""Plain PyTorch references for the kernels, under the JAX package's
``repro/kernels/ref.py`` names.

Each kernel's plain version sits beside it in its own module; this module
gives them the reference signatures (optional biases) and keeps the
original take → mask → sum exchange chain that the fused gather replaces.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.kge_score import apply_epilogue
from repro_torch.kernels.ops import gather_rows
from repro_torch.kernels.rgcn_message import (
    basis_message_plain as basis_message_ref,
)
from repro_torch.kernels.rgcn_message import segment_sum_plain
from repro_torch.kernels.sharded_gather import scatter_add_onehot_plain
from repro_torch.kernels.topk import topk_plain as topk_ref

__all__ = ["basis_message_ref", "segment_mean_ref", "rgcn_message_ref",
           "kge_score_ref", "topk_ref", "sharded_gather_ref",
           "sharded_scatter_add_ref"]


def segment_mean_ref(msg: torch.Tensor, seg: torch.Tensor,
                     edge_mask: torch.Tensor, num_segments: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked segment sum + counts → ``(agg (V, d), deg (V,))``."""
    return segment_sum_plain(msg, seg, edge_mask, num_segments)


def rgcn_message_ref(h: torch.Tensor, src: torch.Tensor, rel: torch.Tensor,
                     dst: torch.Tensor, edge_mask: torch.Tensor,
                     bases: torch.Tensor, coeffs: torch.Tensor
                     ) -> torch.Tensor:
    """The fused op's formula: gather → basis message → segment MEAN. The
    gathers are ``gather_rows``, so the gradient of the recompute in
    ``ops.rgcn_message_basis``'s backward is deterministic on the card."""
    msg = basis_message_ref(gather_rows(h, dst), gather_rows(coeffs, rel),
                            bases, edge_mask)
    agg, deg = segment_mean_ref(msg, src, edge_mask, h.shape[0])
    return agg / torch.clamp_min(deg, 1.0)[:, None]


def kge_score_ref(q: torch.Tensor, candidates: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  q_bias: Optional[torch.Tensor] = None,
                  c_bias: Optional[torch.Tensor] = None,
                  epilogue: str = "bilinear") -> torch.Tensor:
    """``epilogue(q @ candidates.T + q_bias + c_bias) + bias``; a missing
    bias is not added."""
    x = q @ candidates.T
    if q_bias is not None:
        x = x + q_bias[:, None]
    if c_bias is not None:
        x = x + c_bias[None, :]
    out = apply_epilogue(x, epilogue)
    return out if bias is None else out + bias


def sharded_gather_ref(table: torch.Tensor, local_ids: torch.Tensor,
                       owned: torch.Tensor) -> torch.Tensor:
    """The shard-local take → mask → sum chain over an ``(S, rows, d)``
    stack with ``(S, V)`` local ids and ownership masks."""
    g = torch.stack([table[s][local_ids[s]] for s in range(table.shape[0])])
    zero = torch.zeros((), dtype=table.dtype, device=table.device)
    return torch.where(owned[:, :, None], g, zero).sum(dim=0)


def sharded_scatter_add_ref(g: torch.Tensor, flat_ids: torch.Tensor,
                            any_owned: torch.Tensor,
                            num_rows: int) -> torch.Tensor:
    """Transpose of the fused gather: the masked scatter-add of the
    cotangents into the stacked table rows (``scatter_add_onehot``)."""
    return scatter_add_onehot_plain(g, flat_ids.long(), any_owned.bool(),
                                    num_rows)
