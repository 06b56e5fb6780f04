"""Attention variants of the LM substrate (port of ``repro/nn/attention.py``).

One GQA implementation covers MQA (kv = 1: gemma, recurrentgemma), GQA
(glm4, qwen), qk-norm (qwen3), the QKV bias (qwen2.5, qwen2-vl), sliding
windows (recurrentgemma's local attention, gemma-2b-sw), M-RoPE (qwen2-vl)
and cross attention (whisper). DeepSeek's MLA (multi-head latent attention,
a compressed KV cache) is its own pair of functions.

Every function is the reference's algorithm step by step in plain PyTorch:
``einsum`` products, ``softmax`` and, from ``MEA_MIN_SEQ`` tokens on, the
reference's chunked online softmax over ``MEA_Q_CHUNK`` x ``MEA_K_CHUNK``
blocks (:func:`_mea`). Scores and the softmax are fp32 whatever the
weights' dtype. Query head ``h`` reads kv head ``h // group``: queries are
grouped as ``(B, S, H_kv, group, hd)``.

Shapes: activations ``(B, S, d)``; caches ``(B, rows, H_kv, hd)``.

The decode cache of a windowed layer may hold fewer rows than the sequence
(``transformer._block_cache``). The port keeps it as a ring buffer: step
``pos`` writes row ``pos % rows``, and a row is valid when the position it
holds lies in ``(pos - window, pos]``. While ``pos < rows`` this is the
reference's computation row for row; past that point decode still equals
:func:`attention` with the window over the whole sequence, where the
reference's clamped write overwrites its last row.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.nn.layers import (
    Shape, apply_m_rope, apply_rope, dense_init, full, rmsnorm,
    rmsnorm_params, softcap,
)
from repro_torch.sharding.context import (
    head_parallel, key_parallel, keys_split, shard_activation,
)

Cache = Dict[str, torch.Tensor]
NEG = -1e30     # the reference's masked score


# ====================================================================== #
# GQA family
# ====================================================================== #
def attn_params(generator, d: int, num_heads: int, num_kv_heads: int,
                head_dim: int, *, qkv_bias: bool = False,
                qk_norm: bool = False, lead: Shape = (), device="cpu",
                dtype=torch.float32) -> Dict:
    """``w_q``, ``w_k``, ``w_v``, ``w_o`` (dense init), the zero QKV biases
    with ``qkv_bias`` and the per-head RMSNorms with ``qk_norm``, stacked
    ``lead`` deep."""
    def dense(d_in, d_out):
        return dense_init(generator, d_in, d_out, lead=lead, device=device,
                          dtype=dtype)
    p = {"w_q": dense(d, num_heads * head_dim),
         "w_k": dense(d, num_kv_heads * head_dim),
         "w_v": dense(d, num_kv_heads * head_dim),
         "w_o": dense(num_heads * head_dim, d)}
    if qkv_bias:
        for name, n in (("b_q", num_heads), ("b_k", num_kv_heads),
                        ("b_v", num_kv_heads)):
            p[name] = full(lead + (n * head_dim,), 0.0, device, dtype)
    if qk_norm:
        for name in ("q_norm", "k_norm"):
            p[name] = rmsnorm_params(head_dim, lead=lead, device=device,
                                     dtype=dtype)
    return p


def _project_qkv(p: Dict, x: torch.Tensor, num_heads: int,
                 num_kv_heads: int, head_dim: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``x @ w_*``, the bias, the split into heads, then the per-head RMS
    qk-norm."""
    b, s, _ = x.shape
    q = x @ p["w_q"]
    k = x @ p["w_k"]
    v = x @ p["w_v"]
    if "b_q" in p:
        q = q + p["b_q"]
        k = k + p["b_k"]
        v = v + p["b_v"]
    q = q.reshape(b, s, num_heads, head_dim)
    k = k.reshape(b, s, num_kv_heads, head_dim)
    v = v.reshape(b, s, num_kv_heads, head_dim)
    if "q_norm" in p:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    return q, k, v


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: Optional[torch.Tensor], *,
          logit_cap: Optional[float] = None) -> torch.Tensor:
    """``q (B, Sq, H, hd)``; ``k``, ``v`` ``(B, Sk, H_kv, ·)``; GQA by
    head-group broadcast. ``mask`` broadcastable to ``(B, H, Sq, Sk)``,
    True = attend. Scores are divided by ``hd ** 0.5``, masked to -1e30 and
    softmaxed in fp32. Returns ``(B, Sq, H · vd)`` in ``q``'s dtype. On a
    mesh each device attends its own rows and heads
    (``sharding.context.head_parallel``)."""
    return head_parallel(
        functools.partial(_sdpa_local, logit_cap=logit_cap),
        (q, k, v, mask), ("b.h.", "b.k.", "b.k.", MASK_LAYOUT), "b.h",
        heads=q.shape[2], kv_heads=k.shape[2])


MASK_LAYOUT = "bh.."     # a mask broadcastable to (B, H, Sq, Sk)


def _sdpa_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                mask: Optional[torch.Tensor], *,
                logit_cap: Optional[float] = None) -> torch.Tensor:
    """:func:`_sdpa` on one device's rows and heads."""
    b, sq, h, hd = q.shape
    hkv = k.shape[2]
    group = h // hkv
    qg = q.reshape(b, sq, hkv, group, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k.float()) / (hd ** 0.5)
    scores = softcap(scores, logit_cap)
    if mask is not None:
        m = torch.broadcast_to(mask, (b, h, sq, scores.shape[-1])) \
            .reshape(b, hkv, group, sq, -1)
        scores = torch.where(m, scores, NEG)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    return out.reshape(b, sq, h * v.shape[-1]).to(q.dtype)


MEA_MIN_SEQ = 2048    # chunked online-softmax attention at and above this
MEA_Q_CHUNK = 1024
MEA_K_CHUNK = 1024


def _mea(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool, window: Optional[int],
         logit_cap: Optional[float] = None, q_chunk: int = MEA_Q_CHUNK,
         k_chunk: int = MEA_K_CHUNK) -> torch.Tensor:
    """Memory-efficient attention: a loop over query blocks x key blocks
    with an online softmax (flash-attention scheduling in plain PyTorch).
    Temporary memory is O(q_chunk · k_chunk) instead of O(S²). Scores are
    multiplied by ``hd ** -0.5`` and masked to -1e30; masked ``p`` are
    zeroed, and the sum ``l`` is floored at 1e-30. Every block pair is
    visited, masked or not, as in the reference's scan. On a mesh each
    device attends its own rows and heads."""
    body = functools.partial(_mea_local, causal=causal, window=window,
                             logit_cap=logit_cap, q_chunk=q_chunk,
                             k_chunk=k_chunk)
    return head_parallel(body, (q, k, v), ("b.h.", "b.k.", "b.k."), "b.h",
                         heads=q.shape[2], kv_heads=k.shape[2])


def _mea_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               causal: bool, window: Optional[int],
               logit_cap: Optional[float], q_chunk: int,
               k_chunk: int) -> torch.Tensor:
    """:func:`_mea` on one device's rows and heads."""
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    vd = v.shape[-1]          # may differ from hd (MLA)
    g = h // hkv
    if sq % q_chunk or sk % k_chunk:
        raise ValueError(f"S_q={sq} and S_k={sk} must be multiples of "
                         f"{q_chunk} and {k_chunk}")
    nq, nk = sq // q_chunk, sk // k_chunk
    scale = hd ** -0.5
    i_q = torch.arange(q_chunk, device=q.device)
    i_k = torch.arange(k_chunk, device=q.device)
    outs = []
    for qi in range(nq):
        q32 = q[:, qi * q_chunk:(qi + 1) * q_chunk].reshape(
            b, q_chunk, hkv, g, hd).float()
        m = torch.full((b, hkv, g, q_chunk), NEG, device=q.device)
        l = torch.zeros((b, hkv, g, q_chunk), device=q.device)
        acc = torch.zeros((b, hkv, g, q_chunk, vd), device=q.device)
        rows = qi * q_chunk + i_q                           # global q index
        for ki in range(nk):
            k_blk = k[:, ki * k_chunk:(ki + 1) * k_chunk]
            v_blk = v[:, ki * k_chunk:(ki + 1) * k_chunk]
            s = torch.einsum("bqhgd,bkhd->bhgqk", q32,
                             k_blk.float()) * scale
            s = softcap(s, logit_cap)
            cols = ki * k_chunk + i_k
            mask = torch.ones((q_chunk, k_chunk), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask &= cols[None, :] <= rows[:, None]
            if window is not None:
                mask &= cols[None, :] > rows[:, None] - window
            s = torch.where(mask, s, NEG)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            p = torch.where(mask, p, 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, v_blk.float())
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]   # (b,hkv,g,qc,vd)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, q_chunk, h * vd))
    return torch.cat(outs, dim=1).to(q.dtype)


def causal_mask(sq: int, sk: int, window: Optional[int] = None,
                device=None) -> torch.Tensor:
    """``(1, 1, Sq, Sk)`` bool: key ``j`` is visible from query ``i`` when
    ``j <= i`` and, with a window, ``j > i - window``."""
    i = torch.arange(sq, device=device)[:, None]
    j = torch.arange(sk, device=device)[None, :]
    m = j <= i
    if window is not None:
        m = m & (j > i - window)
    return m[None, None]


def _rotary(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
            rope_base: float, m_rope: bool
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    rot = apply_m_rope if m_rope else apply_rope
    return rot(q, positions, rope_base), rot(k, positions, rope_base)


def attention(p: Dict, x: torch.Tensor, *, num_heads: int,
              num_kv_heads: int, head_dim: int, positions: torch.Tensor,
              rope_base: float = 10000.0, m_rope: bool = False,
              causal: bool = True, window: Optional[int] = None,
              logit_cap: Optional[float] = None) -> torch.Tensor:
    """Full-sequence attention (training and prefill): ``x (B, S, d)``,
    ``positions (B, S)`` (``(B, S, 3)`` with ``m_rope``). :func:`_mea` when
    ``S >= MEA_MIN_SEQ`` and ``S`` is a multiple of ``MEA_Q_CHUNK``,
    else :func:`_sdpa` with :func:`causal_mask`."""
    q, k, v = _project_qkv(p, x, num_heads, num_kv_heads, head_dim)
    q, k = _rotary(q, k, positions, rope_base, m_rope)
    s = x.shape[1]
    if s >= MEA_MIN_SEQ and s % MEA_Q_CHUNK == 0:
        out = _mea(q, k, v, causal=causal, window=window,
                   logit_cap=logit_cap)
    else:
        mask = causal_mask(s, s, window, device=x.device) if causal else None
        out = _sdpa(q, k, v, mask, logit_cap=logit_cap)
    return out @ p["w_o"]


def _ring_write(buf: torch.Tensor, val: torch.Tensor,
                pos: torch.Tensor) -> torch.Tensor:
    """Write ``val[b, 0]`` into row ``pos[b] % rows`` of ``buf[b]``, in
    place; returns ``buf``."""
    rows = buf.shape[1]
    batch = torch.arange(buf.shape[0], device=buf.device)
    buf[batch, pos % rows] = val[:, 0].to(buf.dtype)
    return buf


def ring_valid(rows: int, pos: torch.Tensor,
               window: Optional[int] = None) -> torch.Tensor:
    """``(B, rows)`` bool: row ``j`` of a ring buffer written at positions
    ``0..pos`` holds position ``pos - ((pos - j) mod rows)``; it is valid
    when that position is ``>= 0`` and, with a window, ``> pos - window``.
    While ``pos < rows`` this is the reference's ``j <= pos``."""
    j = torch.arange(rows, device=pos.device)[None, :]
    held = pos[:, None] - torch.remainder(pos[:, None] - j, rows)
    valid = held >= 0
    if window is not None:
        valid = valid & (held > pos[:, None] - window)
    return valid


def attention_decode(p: Dict, x: torch.Tensor, cache: Cache,
                     pos: torch.Tensor, *, num_heads: int,
                     num_kv_heads: int, head_dim: int,
                     rope_base: float = 10000.0, m_rope: bool = False,
                     positions_3d: Optional[torch.Tensor] = None,
                     window: Optional[Union[int, torch.Tensor]] = None,
                     logit_cap: Optional[float] = None
                     ) -> Tuple[torch.Tensor, Cache]:
    """One-token decode: ``x (B, 1, d)``, ``pos (B,)`` the token's position.
    Writes k and v into row ``pos % rows`` of the cache ``{"k", "v"}``
    (``(B, rows, H_kv, hd)``), in place (the reference's serving step
    donates its cache), and attends over the valid rows
    (:func:`ring_valid`). Returns ``(out (B, 1, d), the cache)``."""
    q, k, v = _project_qkv(p, x, num_heads, num_kv_heads, head_dim)
    q, k = _rotary(q, k, positions_3d if m_rope else pos[:, None],
                   rope_base, m_rope)
    k_cache = _ring_write(cache["k"], k, pos)
    v_cache = _ring_write(cache["v"], v, pos)
    valid = ring_valid(k_cache.shape[1], pos, window)[:, None, None, :]
    if keys_split(k_cache, 1):
        out = key_parallel(
            functools.partial(_attend_keys, logit_cap=logit_cap),
            (q, k_cache, v_cache, valid), ("b...", "bs..", "bs..", "b..s"),
            "b..")
    else:
        out = _sdpa(q, k_cache, v_cache, valid, logit_cap=logit_cap)
    return out @ p["w_o"], {"k": k_cache, "v": v_cache}


def _attend_keys(q, k, v, mask, *, logit_cap, reduce):
    """:func:`_sdpa` on one device's share of the cache rows
    (``sharding.context.key_parallel``): the masked scores' max, the sum
    of their exponentials and the value product are all-reduced over the
    devices that hold the other rows."""
    b, sq, h, hd = q.shape
    hkv = k.shape[2]
    group = h // hkv
    qg = q.reshape(b, sq, hkv, group, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k.float()) / (hd ** 0.5)
    scores = softcap(scores, logit_cap)
    m = torch.broadcast_to(mask, (b, h, sq, scores.shape[-1])) \
        .reshape(b, hkv, group, sq, -1)
    scores = torch.where(m, scores, NEG)
    top = reduce(torch.amax(scores, dim=-1), "max")
    w = torch.exp(scores - top[..., None])
    total = reduce(torch.sum(w, dim=-1), "sum")
    out = reduce(torch.einsum("bhgqk,bkhd->bqhgd", w, v.float()), "sum")
    out = out / total.permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, sq, h * v.shape[-1]).to(q.dtype)


def cross_attention(p: Dict, x: torch.Tensor,
                    kv_source: Optional[torch.Tensor], *, num_heads: int,
                    num_kv_heads: int, head_dim: int,
                    cached_kv: Optional[Cache] = None) -> torch.Tensor:
    """Encoder-decoder cross attention (whisper): no positions on k and v,
    no mask. With ``cached_kv`` (:func:`cross_kv_cache`) the encoder's k
    and v are not recomputed."""
    b, s, _ = x.shape
    q = (x @ p["w_q"]).reshape(b, s, num_heads, head_dim)
    if cached_kv is not None:
        k, v = cached_kv["k"], cached_kv["v"]
    else:
        # the encoder's output as the activations are laid out (a decode
        # cache may hold it otherwise)
        kv = cross_kv_cache(p, shard_activation(kv_source),
                            num_kv_heads=num_kv_heads, head_dim=head_dim)
        k, v = kv["k"], kv["v"]
    return _sdpa(q, k, v, None) @ p["w_o"]


def cross_kv_cache(p: Dict, kv_source: torch.Tensor, *, num_kv_heads: int,
                   head_dim: int) -> Cache:
    """Cross-attention k and v from the encoder's output, once a request."""
    b, se, _ = kv_source.shape
    return {"k": (kv_source @ p["w_k"]).reshape(b, se, num_kv_heads,
                                                head_dim),
            "v": (kv_source @ p["w_v"]).reshape(b, se, num_kv_heads,
                                                head_dim)}


# ====================================================================== #
# MLA — DeepSeek-V2 multi-head latent attention
# ====================================================================== #
def mla_params(generator, d: int, num_heads: int, *, kv_lora_rank: int,
               qk_nope_head_dim: int, qk_rope_head_dim: int,
               v_head_dim: int, lead: Shape = (), device="cpu",
               dtype=torch.float32) -> Dict:
    def dense(d_in, d_out):
        return dense_init(generator, d_in, d_out, lead=lead, device=device,
                          dtype=dtype)
    qd = qk_nope_head_dim + qk_rope_head_dim
    return {"w_q": dense(d, num_heads * qd),
            "w_dkv": dense(d, kv_lora_rank),
            "w_krope": dense(d, qk_rope_head_dim),
            "kv_norm": rmsnorm_params(kv_lora_rank, lead=lead,
                                      device=device, dtype=dtype),
            "w_ukv": dense(kv_lora_rank,
                           num_heads * (qk_nope_head_dim + v_head_dim)),
            "w_o": dense(num_heads * v_head_dim, d)}


def _mla_expand(p: Dict, c_kv: torch.Tensor, num_heads: int,
                qk_nope_head_dim: int, v_head_dim: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The compressed latent ``(B, S, rank)`` → ``k_nope``, ``v``
    ``(B, S, H, ·)``."""
    b, s, _ = c_kv.shape
    kv = (c_kv @ p["w_ukv"]).reshape(b, s, num_heads,
                                     qk_nope_head_dim + v_head_dim)
    return kv[..., :qk_nope_head_dim], kv[..., qk_nope_head_dim:]


def _mla_scores(q_nope, q_rope, k_nope, k_rope, qd):
    """``(q_nope · k_nope + q_rope · k_rope) / qd ** 0.5`` in fp32,
    ``(B, H, Sq, Sk)``; ``k_rope`` ``(B, Sk, r)`` is shared by the
    heads."""
    return (torch.einsum("bqhd,bkhd->bhqk", q_nope.float(),
                         k_nope.float())
            + torch.einsum("bqhr,bkr->bhqk", q_rope.float(),
                           k_rope.float())) * (1.0 / (qd ** 0.5))


def mla_attention(p: Dict, x: torch.Tensor, *, num_heads: int,
                  kv_lora_rank: int, qk_nope_head_dim: int,
                  qk_rope_head_dim: int, v_head_dim: int,
                  positions: torch.Tensor, rope_base: float = 10000.0,
                  causal: bool = True) -> torch.Tensor:
    """Full-sequence MLA (training and prefill). From ``MEA_MIN_SEQ`` on,
    the concatenated form ``[q_nope, q_rope] · [k_nope, k_rope]`` goes
    through :func:`_mea` (the scale is ``qd ** -0.5`` in both forms)."""
    b, s, _ = x.shape
    qd = qk_nope_head_dim + qk_rope_head_dim
    q = (x @ p["w_q"]).reshape(b, s, num_heads, qd)
    q_nope, q_rope = q[..., :qk_nope_head_dim], q[..., qk_nope_head_dim:]
    q_rope = apply_rope(q_rope, positions, rope_base)
    c_kv = rmsnorm(p["kv_norm"], x @ p["w_dkv"])          # (B, S, rank)
    k_rope = apply_rope((x @ p["w_krope"])[:, :, None, :], positions,
                        rope_base)                         # (B, S, 1, r)
    k_nope, v = _mla_expand(p, c_kv, num_heads, qk_nope_head_dim,
                            v_head_dim)
    mea = s >= MEA_MIN_SEQ and s % MEA_Q_CHUNK == 0
    mask = causal_mask(s, s, device=x.device) if causal and not mea \
        else None
    out = _mla_core(q_nope, q_rope, k_nope, k_rope[:, :, 0], v, mask,
                    causal=causal)
    return out.to(x.dtype) @ p["w_o"]


def _mla_core(q_nope, q_rope, k_nope, k_rope, v, mask, *, causal=True):
    """MLA's attention core, ``(B, Sq, H · vd)``: ``k_rope`` ``(B, Sk, r)``
    is shared by the heads, ``mask`` broadcastable to ``(B, H, Sq, Sk)``.
    On a mesh each device attends its own rows and heads."""
    return head_parallel(
        functools.partial(_mla_core_local, causal=causal),
        (q_nope, q_rope, k_nope, k_rope, v, mask),
        ("b.h.", "b.h.", "b.h.", "b..", "b.h.", MASK_LAYOUT), "b.h",
        heads=q_nope.shape[2])


def _mla_core_local(q_nope, q_rope, k_nope, k_rope, v, mask, *, causal):
    """:func:`_mla_core` on one device's rows and heads: from
    ``MEA_MIN_SEQ`` on, the concatenated form ``[q_nope, q_rope] ·
    [k_nope, k_rope]`` through :func:`_mea` (the scale is ``qd ** -0.5``
    in both forms), else the scores, the masked softmax and the value
    product; fp32 (the caller casts)."""
    b, s, h, dn = q_nope.shape
    qd = dn + q_rope.shape[-1]
    if s >= MEA_MIN_SEQ and s % MEA_Q_CHUNK == 0:
        q_cat = torch.cat([q_nope, q_rope], dim=-1)        # (B, S, H, qd)
        k_cat = torch.cat([k_nope, k_rope[:, :, None].expand(
            b, s, h, k_rope.shape[-1])], dim=-1)
        return _mea_local(q_cat, k_cat, v, causal=causal, window=None,
                          logit_cap=None, q_chunk=MEA_Q_CHUNK,
                          k_chunk=MEA_K_CHUNK)
    scores = _mla_scores(q_nope, q_rope, k_nope, k_rope, qd)
    if mask is not None:
        scores = torch.where(mask, scores, NEG)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v.float())
    return out.reshape(b, s, h * v.shape[-1])


def mla_decode(p: Dict, x: torch.Tensor, cache: Cache, pos: torch.Tensor,
               *, num_heads: int, kv_lora_rank: int, qk_nope_head_dim: int,
               qk_rope_head_dim: int, v_head_dim: int,
               rope_base: float = 10000.0) -> Tuple[torch.Tensor, Cache]:
    """One-token MLA decode. The cache is compressed: ``c_kv`` ``(B, S,
    rank)`` and ``k_rope`` ``(B, S, r)``, written at ``pos`` in place; the
    latent is expanded again every step, as in the reference."""
    b = x.shape[0]
    qd = qk_nope_head_dim + qk_rope_head_dim
    q = (x @ p["w_q"]).reshape(b, 1, num_heads, qd)
    q_nope, q_rope = q[..., :qk_nope_head_dim], q[..., qk_nope_head_dim:]
    q_rope = apply_rope(q_rope, pos[:, None], rope_base)
    c_new = rmsnorm(p["kv_norm"], x @ p["w_dkv"])          # (B, 1, rank)
    kr_new = apply_rope((x @ p["w_krope"])[:, :, None, :], pos[:, None],
                        rope_base)[:, :, 0, :]             # (B, 1, r)
    c_cache = _ring_write(cache["c_kv"], c_new, pos)
    kr_cache = _ring_write(cache["k_rope"], kr_new, pos)
    k_nope, v = _mla_expand(p, c_cache, num_heads, qk_nope_head_dim,
                            v_head_dim)
    valid = ring_valid(c_cache.shape[1], pos)[:, None, None, :]
    out = _mla_core(q_nope, q_rope, k_nope, kr_cache, v, valid)
    return out.to(x.dtype) @ p["w_o"], {"c_kv": c_cache, "k_rope": kr_cache}
