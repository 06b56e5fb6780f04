"""Mixture-of-experts layer of arctic-480b and deepseek-v2-lite (port of
``repro/nn/moe.py``).

Tokens are routed by a top-k softmax router whose weights and logits are
fp32 whatever the tree's dtype. Two dispatches:

* ``moe_apply`` — dense dispatch: every expert computes every token, and
  combine weights that are zero outside each token's top k select the
  results (the reference's one-hot combine einsums; static shapes);
* ``moe_apply_capacity`` — tokens sorted by expert (a stable sort), each
  expert takes at most ``C`` of them, the rest are dropped, and each token
  sums its kept experts' outputs.

Both support the routed experts, deepseek's shared experts, arctic's
parallel dense FFN and the Switch load-balance auxiliary loss. The
router's top-k goes through ``kernels.ops.topk_padded`` (the ``topk_scores``
kernel on the card; ties to the lowest index, ``lax.top_k``'s rule): only
its indices are taken, and the selected probabilities are gathered from
``probs``, so the router's gradient flows the same way on the CPU and the
card. The reference pins its ``(E, C, d)`` buffer to the ``model`` mesh
axis (``_shard_expert_buffer``); without a mesh that is a no-op, and the
port's mesh context is ROADMAP Queue 1 item 7f.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels.ops import topk_padded
from repro_torch.nn.layers import (
    ACTIVATIONS, Shape, dense_init, mlp_apply, mlp_params,
)


def moe_params(generator, d: int, *, num_experts: int, d_ff_expert: int,
               num_shared: int = 0, dense_residual_ff: int = 0,
               glu: bool = True, lead: Shape = (), device="cpu",
               dtype=torch.float32) -> Dict:
    """``router`` ``(d, E)``, always fp32; the experts stacked ``w_in``,
    ``w_gate`` ``(E, d, ff)`` and ``w_out`` ``(E, ff, d)``; with
    ``num_shared`` the shared experts as one MLP of ``ff · num_shared``,
    with ``dense_residual_ff`` the parallel dense MLP; all stacked ``lead``
    deep."""
    kw = dict(lead=lead, device=device)
    p: Dict = {
        "router": dense_init(generator, d, num_experts, dtype=torch.float32,
                             **kw),
        "w_in": _expert_init(generator, num_experts, d, d_ff_expert,
                             dtype=dtype, **kw),
        "w_out": _expert_init(generator, num_experts, d_ff_expert, d,
                              dtype=dtype, **kw),
    }
    if glu:
        p["w_gate"] = _expert_init(generator, num_experts, d, d_ff_expert,
                                   dtype=dtype, **kw)
    if num_shared:
        p["shared"] = mlp_params(generator, d, d_ff_expert * num_shared, glu,
                                 dtype=dtype, **kw)
    if dense_residual_ff:
        p["dense"] = mlp_params(generator, d, dense_residual_ff, glu,
                                dtype=dtype, **kw)
    return p


def _expert_init(generator, e: int, d_in: int, d_out: int, *,
                 lead: Shape = (), device="cpu",
                 dtype=torch.float32) -> torch.Tensor:
    """``normal · sqrt(2 / (d_in + d_out))`` of shape ``lead + (e, d_in,
    d_out)``, drawn one expert at a time: a single fp32 draw of
    arctic-480b's stack of two layers (35.7 GB) would not fit on an 80 GB
    card beside the bf16 stacks already drawn."""
    out = torch.empty(lead + (e, d_in, d_out), device=device, dtype=dtype)
    if out.device.type == "meta":
        return out
    for i in range(e):
        out[..., i, :, :] = dense_init(generator, d_in, d_out, lead=lead,
                                       device=device, dtype=dtype)
    return out


def _route(p: Dict, x: torch.Tensor, top_k: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``x (T, d)`` → fp32 ``probs (T, E)``, the renormalized top-k
    weights ``(T, k)`` and their experts ``(T, k)`` int64."""
    logits = x.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    _, top_idx = topk_padded(probs.detach(), top_k)
    top_vals = torch.gather(probs, -1, top_idx)
    return probs, top_vals / top_vals.sum(-1, keepdim=True), top_idx


def _experts(p: Dict, xe: torch.Tensor, act: str) -> torch.Tensor:
    """The experts on ``xe`` ``(E, N, d)`` (expert ``e`` on row block
    ``e``), or ``(1, N, d)`` for every expert on the same rows → ``(E, N,
    d)``: one batched product an expert, the rows broadcast without a
    copy. The gate's activation is ``act``; without a gate the reference
    applies SiLU whatever ``act``."""
    e = p["w_in"].shape[0]
    xe = xe.expand(e, -1, -1)
    h_in = torch.bmm(xe, p["w_in"])
    if "w_gate" in p:
        h = ACTIVATIONS[act](torch.bmm(xe, p["w_gate"])) * h_in
    else:
        h = torch.nn.functional.silu(h_in)
    return torch.bmm(h, p["w_out"])


def _branches(p: Dict, out: torch.Tensor, x: torch.Tensor,
              act: str) -> torch.Tensor:
    """``out`` plus the shared experts and the dense branch on ``x``."""
    if "shared" in p:
        out = out + mlp_apply(p["shared"], x, act)
    if "dense" in p:
        out = out + mlp_apply(p["dense"], x, act)
    return out


def moe_apply(p: Dict, x: torch.Tensor, *, top_k: int, act: str = "silu"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x (B, S, d)`` → ``(out (B, S, d), aux)`` by dense dispatch: every
    expert computes every token (the reference's ``bsd,edf->bsef``,
    ``bsef,efd->bsed``, as one batched product an expert), and ``combine``
    ``(B, S, E)``, the renormalized top-k weights at the selected experts
    and 0 elsewhere, cast to the experts' dtype, sums them
    (``bsed,bse->bsd``). ``aux = E · Σ_e mean(probs_e) · mean(combine_e >
    0)``, fp32."""
    b, s, d = x.shape
    e = p["router"].shape[1]
    xf = x.reshape(b * s, d)
    probs, top_vals, top_idx = _route(p, xf, top_k)
    combine = torch.zeros_like(probs).scatter_add(-1, top_idx, top_vals)
    y = _experts(p, xf[None], act)                          # (E, T, d)
    out = torch.einsum("etd,te->td", y, combine.to(y.dtype))
    out = _branches(p, out.reshape(b, s, d), x, act)
    me = probs.mean(0)
    ce = (combine > 0).float().mean(0)
    return out.to(x.dtype), e * torch.sum(me * ce)


def capacity(tokens: int, top_k: int, num_experts: int,
             capacity_factor: float) -> int:
    """Slots an expert: ``ceil(T · k · factor / E)``, at least 8 and
    rounded up to a multiple of 8, as the reference computes it."""
    cap = int(-(-tokens * top_k * capacity_factor // num_experts))
    return max(8, ((cap + 7) // 8) * 8)


def moe_apply_capacity(p: Dict, x: torch.Tensor, *, top_k: int,
                       act: str = "silu", capacity_factor: float = 1.25
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-bounded dispatch: the ``T · k`` (token, expert) pairs
    stably sorted by expert; expert ``e`` takes the first ``C``
    (:func:`capacity`) of its pairs into an ``(E, C, d)`` buffer and the
    rest are dropped. Slots past an expert's count alias other tokens with
    gate 0, as in the reference, so the experts compute them. The
    reference adds every slot into its token with ``segment_sum``; here
    each token gathers its kept pairs' outputs (each already times its
    gate) and sums its ``k`` of them, in a fixed order and without atomics,
    so two runs on the card are bitwise equal. The aliased slots, which add
    ``y · 0`` in the reference, are not gathered. ``aux`` is the dense
    dispatch's divided by ``top_k``."""
    b, s, d = x.shape
    t = b * s
    e = p["router"].shape[1]
    xf = x.reshape(t, d)
    probs, top_vals, top_idx = _route(p, xf, top_k)
    flat_expert = top_idx.reshape(-1)                       # (T·k,)
    flat_gate = top_vals.reshape(-1)
    cap = capacity(t, top_k, e, capacity_factor)

    order = torch.argsort(flat_expert, stable=True)         # group by expert
    sorted_token = order // top_k
    counts = torch.bincount(flat_expert, minlength=e)       # (E,)
    offsets = torch.cumsum(counts, 0) - counts              # exclusive
    lane = torch.arange(cap, device=x.device)
    slot = torch.clamp(offsets[:, None] + lane[None, :], 0, t * top_k - 1)
    valid = lane[None, :] < counts[:, None]                 # (E, C)
    tok = sorted_token[slot]                                # (E, C)
    gate = torch.where(valid, flat_gate[order][slot], 0.0)
    y = _experts(p, xf[tok], act)                           # (E, C, d)
    y = y * gate[..., None].to(y.dtype)

    # each pair's place in the buffer: its rank among its expert's pairs
    rank = torch.empty_like(order)
    rank[order] = torch.arange(t * top_k, device=x.device)
    within = rank - offsets[flat_expert]
    kept = within < cap
    at = flat_expert * cap + torch.clamp(within, max=cap - 1)
    pairs = torch.where(kept[:, None], y.reshape(e * cap, d)[at], 0.0)
    out = pairs.reshape(t, top_k, d).sum(1).reshape(b, s, d)
    out = _branches(p, out, x, act)

    me = probs.mean(0)
    ce = torch.zeros_like(probs).scatter_add(
        -1, top_idx, torch.ones_like(top_vals)).mean(0)
    aux = e * torch.sum(me * ce) / max(top_k, 1)
    return out.to(x.dtype), aux


def moe_apply_decode(p: Dict, x: torch.Tensor, *, top_k: int,
                     act: str = "silu") -> torch.Tensor:
    """Dense dispatch of the decode step's ``(B, 1, d)`` tokens."""
    out, _ = moe_apply(p, x, top_k=top_k, act=act)
    return out
