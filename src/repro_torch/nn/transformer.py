"""The LM model definition (port of ``repro/nn/transformer.py``).

``ArchConfig`` is the reference's whole configuration record, and the port
runs all of its families: ``"dense"`` decoder LMs (glm4, qwen3, qwen2.5,
gemma), ``"moe"`` (arctic; deepseek-v2-lite with MLA attention and a first
dense layer), ``"rwkv"`` (RWKV-6), the ``"hybrid"`` RG-LRU + local
attention (recurrentgemma), the ``"encdec"`` whisper backbone (an encoder
over precomputed frame embeddings, decoder blocks with cross attention)
and the ``"vlm"`` qwen2-vl backbone (M-RoPE, projected patch embeddings
added to the token embeddings). Parameters are the reference's tree —
``{"embed", "final_norm", "lm_head", "vision_proj", "groups": [group],
"encoder": {"groups", "final_norm"}}`` — as plain dicts of tensors. A
scanned group's leaves are stacked ``(L, ...)`` and a layer is a view into
the stacks; a hybrid's scanned group stacks its repeating pattern
(``{"sub0", "sub1", ...}``, one block kind each), and an unscanned group
is a list of layers. Entry points:

* ``forward`` — full-sequence logits (``train=True`` recomputes each
  scanned block, or pattern body, in the backward when ``cfg.remat``);
* ``loss_fn`` — the next-token cross entropy of a training step, plus the
  MoE load-balance loss;
* ``prefill`` — the last position's logits and their argmax (the cache is
  not written, as in the reference);
* ``decode_step`` — one token at position ``pos`` against the KV cache,
  MLA's compressed cache and the recurrent state.

``rwkv_mode`` picks the time mix's WKV form: ``"sequential"`` (the
default), ``"chunked"`` (plain PyTorch, only when S is a multiple of
``rwkv_chunk``, else sequential) or ``"chunked_kernel"`` (the CUDA kernel on
the card, any S). ``moe_dispatch`` picks the MoE layer's dispatch,
``"dense"`` or ``"capacity"`` (``nn/moe.py``). The reference's
activation and logits pins (``sharding/context.py``: the embeddings, each
group's output, the encoder's output and the logits), with a scanned
layer's input and each branch before its residual add, redistribute the
dry run's ``DTensor``s, and each layer's weights are gathered over the
data axes before it runs; without an installed mesh they return their
input.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.device import resolve_device
from repro_torch.nn import attention as attn
from repro_torch.nn import moe as moe_lib
from repro_torch.nn import recurrent as rec
from repro_torch.nn.layers import (
    Shape, dense_init, embed_init, full, mlp_apply, mlp_params, rmsnorm,
    rmsnorm_params,
)
from repro_torch.sharding.context import (
    embed_lookup, gather_weights, shard_activation, shard_logits,
)

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str            # dense | moe | rwkv | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # attention knobs
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_base: float = 10000.0
    m_rope: bool = False
    sliding_window: Optional[int] = None     # set => sub-quadratic attention
    # mlp
    mlp_act: str = "silu"
    mlp_glu: bool = True
    # moe
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    d_ff_expert: Optional[int] = None
    moe_dense_residual: bool = False         # arctic parallel dense branch
    first_k_dense: int = 0                   # deepseek: first layer(s) dense
    router_aux_coef: float = 0.01
    moe_dispatch: str = "dense"              # "dense" | "capacity" (§Perf)
    moe_capacity_factor: float = 1.25
    # MLA (deepseek)
    use_mla: bool = False
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # rwkv / hybrid
    rwkv_head_dim: int = 64
    rwkv_mode: str = "sequential"  # "sequential" | "chunked" | "chunked_kernel"
    rwkv_chunk: int = 64
    hybrid_pattern: Tuple[str, ...] = ()     # e.g. ("rec","rec","attn")
    lru_width: Optional[int] = None
    conv1d_width: int = 4
    local_window: int = 2048                 # hybrid local-attn window
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_frames: int = 1500
    cache_cross_kv: bool = False   # §Perf: precompute decode cross-K/V
    # vlm
    vision_dim: int = 0
    # misc
    act_seq_shard: bool = False   # §Perf: shard (B,S,d) seq dim over model
    remat_policy: str = "nothing"  # "nothing" | "dots" (§Perf)
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    remat: bool = True
    citation: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: 2 layers, d_model ≤ 512, ≤ 4 experts — same
        family, CPU-runnable."""
        d = min(self.d_model, 256)
        heads = min(self.num_heads, 4)
        kv = max(1, min(self.num_kv_heads, heads))
        hd = 64 if self.head_dim else d // heads
        n_exp = min(self.num_experts, 4) if self.num_experts else 0
        pattern = self.hybrid_pattern
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=len(pattern) if pattern else 2,
            d_model=d, num_heads=heads, num_kv_heads=kv,
            head_dim=hd if self.head_dim else None,
            d_ff=min(self.d_ff, 512),
            d_ff_expert=(min(self.d_ff_expert, 128)
                         if self.d_ff_expert else None),
            vocab_size=min(self.vocab_size, 512),
            num_experts=n_exp,
            top_k=min(self.top_k, max(1, n_exp)) if n_exp else 0,
            num_shared_experts=min(self.num_shared_experts, 1),
            kv_lora_rank=min(self.kv_lora_rank, 64),
            qk_nope_head_dim=min(self.qk_nope_head_dim, 32),
            qk_rope_head_dim=min(self.qk_rope_head_dim, 16),
            v_head_dim=min(self.v_head_dim, 32),
            lru_width=min(self.lru_width, d) if self.lru_width else None,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_frames=min(self.encoder_frames, 32),
            vision_dim=min(self.vision_dim, 64) if self.vision_dim else 0,
            first_k_dense=min(self.first_k_dense, 1),
            sliding_window=(min(self.sliding_window, 64)
                            if self.sliding_window else None),
            local_window=min(self.local_window, 32),
            remat=False,
        )


# ====================================================================== #
# Layer-stack plan: (kind, count, scanned) groups
# ====================================================================== #
def _pattern(cfg: ArchConfig) -> Tuple[str, ...]:
    """The hybrid's repeating block kinds."""
    return cfg.hybrid_pattern or ("rec", "rec", "attn")


def stack_plan(cfg: ArchConfig) -> List[Tuple[str, int, bool]]:
    """``(kind, n_layers, scanned)`` groups covering the decoder stack in
    order: one scanned group of ``dense`` blocks (``vlm`` too), ``dec``
    blocks (``encdec``; its encoder is ``params["encoder"]``) or RWKV
    ``rec`` blocks; for ``moe``, ``first_k_dense`` unscanned ``dense``
    layers, then a scanned group of ``moe`` blocks; for the hybrid, a
    scanned group of whole patterns, then the remainder's kinds one
    unscanned layer each."""
    n = cfg.num_layers
    if cfg.arch_type in ("dense", "vlm"):
        return [("dense", n, True)]
    if cfg.arch_type == "moe":
        first = cfg.first_k_dense
        plan = [("dense", first, False)] if first else []
        return plan + [("moe", n - first, True)]
    if cfg.arch_type == "rwkv":
        return [("rec", n, True)]
    if cfg.arch_type == "hybrid":
        pattern = _pattern(cfg)
        reps, rem = divmod(n, len(pattern))
        plan = [("pattern", reps, True)] if reps else []
        return plan + [(kind, 1, False) for kind in pattern[:rem]]
    if cfg.arch_type == "encdec":
        return [("dec", n, True)]
    raise ValueError(cfg.arch_type)


def _window(cfg: ArchConfig, kind: str) -> Optional[int]:
    """An attention block's window: the hybrid's local window, else the
    config's sliding window (None: full causal attention)."""
    return cfg.local_window if kind == "attn" else cfg.sliding_window


# ====================================================================== #
# Parameters
# ====================================================================== #
def _block_params(generator, cfg: ArchConfig, kind: str, *,
                  lead: Shape = (), device="cpu",
                  dtype=torch.float32) -> Dict:
    """One pre-norm block of ``kind``, stacked ``lead`` deep: ``dense``,
    ``attn`` and ``enc`` (attention + MLP), ``moe`` (attention + the MoE
    layer), ``dec`` (attention, cross attention with its norm, MLP) — the
    attention is MLA under ``cfg.use_mla`` — and ``rec`` (RWKV time mix +
    channel mix, or under ``arch_type="hybrid"`` the RG-LRU + MLP)."""
    d = cfg.d_model
    kw = dict(lead=lead, device=device, dtype=dtype)
    p: Dict = {"norm1": rmsnorm_params(d, **kw),
               "norm2": rmsnorm_params(d, **kw)}
    if kind != "rec":
        if cfg.use_mla:
            p["attn"] = attn.mla_params(
                generator, d, cfg.num_heads, kv_lora_rank=cfg.kv_lora_rank,
                qk_nope_head_dim=cfg.qk_nope_head_dim,
                qk_rope_head_dim=cfg.qk_rope_head_dim,
                v_head_dim=cfg.v_head_dim, **kw)
        else:
            p["attn"] = attn.attn_params(
                generator, d, cfg.num_heads, cfg.num_kv_heads,
                cfg.resolved_head_dim, qkv_bias=cfg.qkv_bias,
                qk_norm=cfg.qk_norm, **kw)
        if kind == "dec":
            p["cross_attn"] = attn.attn_params(
                generator, d, cfg.num_heads, cfg.num_heads,
                cfg.resolved_head_dim, **kw)
            p["norm_cross"] = rmsnorm_params(d, **kw)
        if kind == "moe":
            p["moe"] = moe_lib.moe_params(
                generator, d, num_experts=cfg.num_experts,
                d_ff_expert=cfg.d_ff_expert or cfg.d_ff,
                num_shared=cfg.num_shared_experts,
                dense_residual_ff=cfg.d_ff if cfg.moe_dense_residual else 0,
                glu=cfg.mlp_glu, **kw)
            return p
    elif cfg.arch_type == "rwkv":
        p["rec"] = rec.rwkv_params(generator, d, cfg.rwkv_head_dim, **kw)
        # token-shifted squared-ReLU FFN

        def dense(d_in, d_out):
            return dense_init(generator, d_in, d_out, **kw)
        p["cmix"] = {
            "mu_k": full(lead + (d,), 0.5, device, dtype),
            "mu_r": full(lead + (d,), 0.5, device, dtype),
            "w_k": dense(d, cfg.d_ff),
            "w_v": dense(cfg.d_ff, d),
            "w_r": dense(d, d),
        }
        return p
    else:
        p["rec"] = rec.rglru_params(generator, d, cfg.lru_width or d,
                                    conv_width=cfg.conv1d_width, **kw)
    p["mlp"] = mlp_params(generator, d, cfg.d_ff, cfg.mlp_glu, **kw)
    return p


def init_params(cfg: ArchConfig, *, generator: Optional[torch.Generator],
                device=None, dtype=torch.bfloat16) -> PyTree:
    """The reference's parameter tree for ``cfg`` with its distributions,
    drawn from ``generator`` (a ``torch.Generator`` on ``device``, default
    ``cuda``), in ``dtype``: bfloat16 by default, the reference's default
    (``repro.nn.transformer.init_params``); the values are drawn in fp32
    and rounded, so a bf16 tree is the fp32 tree of the same generator
    rounded to bf16. Every MoE ``router`` is fp32 whatever ``dtype``, as in
    the reference (its router logits are fp32). Pass ``dtype=torch.float32``
    for fp32 weights. The draws differ from JAX's; parity tests start both
    sides from the JAX weights (``repro_torch.convert.lm_params_from_jax``).
    On ``device="meta"`` only the shapes are made (``generator`` may be
    None)."""
    dev = (torch.device("meta") if str(device) == "meta"
           else resolve_device(device))
    kw = dict(device=dev, dtype=dtype)
    params: Dict = {
        "embed": embed_init(generator, cfg.vocab_size, cfg.d_model, **kw),
        "final_norm": rmsnorm_params(cfg.d_model, **kw),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, cfg.d_model,
                                       cfg.vocab_size, **kw)
    if cfg.vision_dim:
        params["vision_proj"] = dense_init(generator, cfg.vision_dim,
                                           cfg.d_model, **kw)
    groups = []
    for kind, n, scanned in stack_plan(cfg):
        if kind == "pattern":
            groups.append({f"sub{i}": _block_params(generator, cfg, kd,
                                                    lead=(n,), **kw)
                           for i, kd in enumerate(_pattern(cfg))})
        elif scanned:
            groups.append(_block_params(generator, cfg, kind, lead=(n,),
                                        **kw))
        else:
            groups.append([_block_params(generator, cfg, kind, **kw)
                           for _ in range(n)])
    params["groups"] = groups
    if cfg.arch_type == "encdec":
        params["encoder"] = {
            "groups": [_block_params(generator, cfg, "enc",
                                     lead=(cfg.encoder_layers,), **kw)],
            "final_norm": rmsnorm_params(cfg.d_model, **kw),
        }
    return params


def layer_params(group: PyTree, i: int) -> PyTree:
    """Layer ``i`` of a stacked group: views into the stacks."""
    if isinstance(group, dict):
        return {k: layer_params(v, i) for k, v in group.items()}
    return group[i]


def unbind_layers(group: PyTree, n: int) -> List[PyTree]:
    """The ``n`` layers of a stacked group, views into the stacks, each
    stack cut by one ``torch.unbind``: its backward stacks the layers'
    gradients once, where indexing each layer (:func:`layer_params`) would
    make a full-size gradient of the stack for every layer."""
    if isinstance(group, dict):
        cut = {k: unbind_layers(v, n) for k, v in group.items()}
        return [{k: cut[k][i] for k in group} for i in range(n)]
    return list(torch.unbind(group, 0))


def map_tree(tree: PyTree, fn) -> PyTree:
    """``tree`` (dicts and lists) with every leaf replaced by ``fn(leaf)``."""
    if isinstance(tree, dict):
        return {k: map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(v, fn) for v in tree]
    return fn(tree)


def leaves(tree: PyTree, prefix: str = ""):
    """``(dotted name, tensor)`` of every leaf, in tree order
    (``groups.0.rec.w_r``, …)."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, value in items:
        name = f"{prefix}{key}"
        if isinstance(value, (dict, list, tuple)):
            yield from leaves(value, name + ".")
        else:
            yield name, value


def count_params(params: PyTree) -> int:
    return int(sum(t.numel() for _, t in leaves(params)))


# ====================================================================== #
# Full sequence
# ====================================================================== #
def _channel_full(p: Dict, h: torch.Tensor) -> torch.Tensor:
    """The RWKV channel mix: a token-shifted squared-ReLU FFN."""
    c = p["cmix"]
    h_prev = rec.token_shift(h)
    k = (h + (h_prev - h) * c["mu_k"]) @ c["w_k"]
    r = torch.sigmoid((h + (h_prev - h) * c["mu_r"]) @ c["w_r"])
    return r * (torch.square(F.relu(k)) @ c["w_v"])


def _rwkv_mix(p: Dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """The RWKV time mix in ``cfg.rwkv_mode``'s form."""
    if cfg.rwkv_mode == "chunked" and x.shape[1] % cfg.rwkv_chunk == 0:
        return rec.rwkv_apply_chunked(p["rec"], x, cfg.rwkv_head_dim,
                                      chunk=cfg.rwkv_chunk)
    if cfg.rwkv_mode == "chunked_kernel":
        return rec.rwkv_apply_kernel(p["rec"], x, cfg.rwkv_head_dim,
                                     chunk=cfg.rwkv_chunk)
    return rec.rwkv_apply(p["rec"], x, cfg.rwkv_head_dim)


def _moe(p: Dict, cfg: ArchConfig, x: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE layer under ``cfg.moe_dispatch``: ``(out, aux)``."""
    if cfg.moe_dispatch == "capacity":
        return moe_lib.moe_apply_capacity(
            p["moe"], x, top_k=cfg.top_k, act=cfg.mlp_act,
            capacity_factor=cfg.moe_capacity_factor)
    return moe_lib.moe_apply(p["moe"], x, top_k=cfg.top_k, act=cfg.mlp_act)


def _cross(p: Dict, cfg: ArchConfig, h: torch.Tensor,
           encoder_out: Optional[torch.Tensor],
           cached_kv: Optional[Dict] = None) -> torch.Tensor:
    """A ``dec`` block's cross attention to the encoder's output."""
    return attn.cross_attention(
        p["cross_attn"], rmsnorm(p["norm_cross"], h), encoder_out,
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_heads,
        head_dim=cfg.resolved_head_dim, cached_kv=cached_kv)


def block_apply(p: Dict, cfg: ArchConfig, h: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                kind: str = "rec",
                encoder_out: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Pre-norm residual block of ``kind`` over the whole sequence: the
    mixer (attention with the block's window, MLA, the RWKV time mix or the
    RG-LRU; an ``enc`` block's attention is not causal), a ``dec`` block's
    cross attention to ``encoder_out``, then the channel half (the RWKV
    channel mix, the MLP or the MoE layer). Returns ``(h, aux)``: ``aux``
    is a ``moe`` block's load-balance loss, None for the other kinds."""
    x = rmsnorm(p["norm1"], h)
    if kind != "rec":
        causal = kind != "enc"
        if cfg.use_mla:
            mix = attn.mla_attention(
                p["attn"], x, num_heads=cfg.num_heads,
                kv_lora_rank=cfg.kv_lora_rank,
                qk_nope_head_dim=cfg.qk_nope_head_dim,
                qk_rope_head_dim=cfg.qk_rope_head_dim,
                v_head_dim=cfg.v_head_dim, positions=positions,
                rope_base=cfg.rope_base, causal=causal)
        else:
            mix = attn.attention(
                p["attn"], x, num_heads=cfg.num_heads,
                num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.resolved_head_dim, positions=positions,
                rope_base=cfg.rope_base, m_rope=cfg.m_rope, causal=causal,
                window=_window(cfg, kind))
    elif cfg.arch_type == "rwkv":
        mix = _rwkv_mix(p, cfg, x)
    else:
        mix = rec.rglru_apply(p["rec"], x)
    # each branch pinned before the residual add: a row-parallel
    # product's partial sums are reduced here (on a mesh; else the branch)
    h = h + shard_activation(mix)
    if kind == "dec":
        h = h + shard_activation(_cross(p, cfg, h, encoder_out))
    x2 = rmsnorm(p["norm2"], h)
    if "moe" in p:
        out, aux = _moe(p, cfg, x2)
        return h + shard_activation(out), aux
    if "cmix" in p:
        return h + shard_activation(_channel_full(p, x2)), None
    out = mlp_apply(p["mlp"], x2, cfg.mlp_act)
    return h + shard_activation(out), None


def _pattern_apply(p: Dict, cfg: ArchConfig, h: torch.Tensor,
                   positions: torch.Tensor
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One repetition of the hybrid's pattern: its blocks in order (none
    of them an MoE block)."""
    for i, kind in enumerate(_pattern(cfg)):
        h, _ = block_apply(p[f"sub{i}"], cfg, h, positions, kind)
    return h, None


def _run_stack(groups: List[PyTree], plan: List[Tuple[str, int, bool]],
               cfg: ArchConfig, h: torch.Tensor, positions: torch.Tensor, *,
               encoder_out: Optional[torch.Tensor] = None,
               remat: bool = False, pin=None
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``h`` through the stack's groups in order: ``(h, the blocks' aux
    summed, None without an MoE block)``, ``pin(h)`` after each group when
    given. With ``remat`` each block of a
    scanned group (each pattern body of the hybrid's) runs under
    ``torch.utils.checkpoint`` and is recomputed in the backward, the
    reference's ``jax.checkpoint`` around its scan body (policy "nothing"):
    only the bodies' inputs are kept for the backward. Unscanned layers are
    not rematerialized, as in the reference. ``pin`` also holds each
    scanned layer's input, as a scan's carry keeps one layout from step
    to step."""
    aux = None
    for gparams, (kind, n, scanned) in zip(groups, plan):
        layers = unbind_layers(gparams, n) if scanned else gparams
        for lp in layers:
            if pin is not None and scanned:
                h = pin(h)      # a scan's carry: one layout every step
            if kind == "pattern":
                fn, args = _pattern_apply, (lp, cfg, h, positions)
            else:
                fn, args = block_apply, (lp, cfg, h, positions, kind,
                                         encoder_out)
            fn = functools.partial(_gathered, fn)
            if remat and scanned:
                # the blocks draw no random numbers: no RNG state to keep
                h, a = torch.utils.checkpoint.checkpoint(
                    fn, *args, use_reentrant=False, preserve_rng_state=False)
            else:
                h, a = fn(*args)
            if a is not None:
                aux = a if aux is None else aux + a
        if pin is not None:
            h = pin(h)
    return h, aux


def _gathered(fn, lp, *args):
    """``fn`` on the layer parameters ``lp`` gathered over the data axes
    (``sharding.context.gather_weights``; under remat the gather is
    recomputed with the layer, as XLA rematerializes it)."""
    return fn(gather_weights(lp), *args)


def embed_tokens(params: PyTree, cfg: ArchConfig, tokens: torch.Tensor,
                 vision_embeds: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """``embed[tokens] · sqrt(d)``, plus ``vision_embeds @ vision_proj``
    when the config has a vision projection and embeddings are given."""
    h = embed_lookup(params["embed"], tokens) * (cfg.d_model ** 0.5)
    if cfg.vision_dim and vision_embeds is not None:
        h = h + vision_embeds @ gather_weights(params["vision_proj"])
    return h


def _head(params: PyTree, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    h = rmsnorm(params["final_norm"], h)
    if cfg.tie_embeddings:
        return h @ gather_weights(params["embed"]).T
    return h @ gather_weights(params["lm_head"])


def default_positions(cfg: ArchConfig, tokens: torch.Tensor
                      ) -> torch.Tensor:
    """``0..S-1`` for every row, ``(B, S)`` (``(B, S, 3)`` for M-RoPE)."""
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    if cfg.m_rope:
        positions = positions[..., None].expand(b, s, 3)
    return positions


def encode(params: PyTree, cfg: ArchConfig, audio_frames: torch.Tensor, *,
           train: bool = False) -> torch.Tensor:
    """The encoder-decoder's encoder: the frame embeddings ``(B, F, d)``
    through the ``enc`` blocks at positions ``0..F-1``, then its final
    norm. ``forward`` runs it first; a decode cache takes its output as
    ``encoder_out``."""
    if audio_frames is None:
        raise ValueError(f"{cfg.name} needs frame embeddings (audio_frames)")
    b, f, _ = audio_frames.shape
    positions = torch.arange(f, device=audio_frames.device)[None].expand(b, f)
    enc = params["encoder"]
    h, _ = _run_stack(enc["groups"], [("enc", cfg.encoder_layers, True)],
                      cfg, audio_frames, positions,
                      remat=cfg.remat and train)
    return shard_activation(rmsnorm(enc["final_norm"], h))


def _forward(params: PyTree, cfg: ArchConfig, tokens: torch.Tensor, *,
             positions: Optional[torch.Tensor] = None,
             vision_embeds: Optional[torch.Tensor] = None,
             audio_frames: Optional[torch.Tensor] = None,
             train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`forward`'s logits and the MoE blocks' aux summed over the
    layers (an fp32 zero without MoE blocks)."""
    if positions is None:
        positions = default_positions(cfg, tokens)
    encoder_out = None
    if cfg.arch_type == "encdec":
        encoder_out = encode(params, cfg, audio_frames, train=train)
    def pin(x):
        return shard_activation(x, seq_over_model=cfg.act_seq_shard)
    h = pin(embed_tokens(params, cfg, tokens, vision_embeds))
    h, aux = _run_stack(params["groups"], stack_plan(cfg), cfg, h,
                        positions, encoder_out=encoder_out,
                        remat=cfg.remat and train, pin=pin)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return shard_logits(_head(params, cfg, h)), aux


def forward(params: PyTree, cfg: ArchConfig, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None,
            vision_embeds: Optional[torch.Tensor] = None,
            audio_frames: Optional[torch.Tensor] = None,
            train: bool = False) -> torch.Tensor:
    """Full-sequence forward: ``(B, S)`` tokens → logits ``(B, S, V)``,
    at ``positions`` (default :func:`default_positions`), with qwen2-vl's
    ``vision_embeds`` ``(B, S, vision_dim)`` added to the embeddings and,
    for the encoder-decoder, the decoder attending to :func:`encode` of
    ``audio_frames`` ``(B, F, d)``. With ``cfg.remat and train`` the
    scanned blocks are recomputed in the backward (:func:`_run_stack`)."""
    return _forward(params, cfg, tokens, positions=positions,
                    vision_embeds=vision_embeds, audio_frames=audio_frames,
                    train=train)[0]


def loss_fn(params: PyTree, cfg: ArchConfig,
            batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy, the body of a training step: ``(total,
    {"nll", "moe_aux"})`` with ``nll`` the mean of ``logsumexp(logits) -
    logits[label]`` in fp32, ``moe_aux`` the MoE blocks' load-balance loss
    summed over the layers (0 without them) and ``total = nll +
    router_aux_coef · moe_aux / num_layers``, as in the reference. The
    batch may hold ``positions``, ``vision_embeds`` and ``audio_frames``."""
    logits, aux = _forward(params, cfg, batch["tokens"],
                           positions=batch.get("positions"),
                           vision_embeds=batch.get("vision_embeds"),
                           audio_frames=batch.get("audio_frames"),
                           train=True)
    logits = logits.float()
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = torch.mean(logz - gold)
    aux = aux.float()
    total = nll + cfg.router_aux_coef * aux / max(cfg.num_layers, 1)
    return total, {"nll": nll, "moe_aux": aux}


def prefill(params: PyTree, cfg: ArchConfig, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None,
            vision_embeds: Optional[torch.Tensor] = None,
            audio_frames: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill forward: ``(last-position logits (B, V), their argmax
    (B,))``. Like the reference it writes no decode cache: serving
    (``ServeEngine``) feeds prompts through ``decode_step``."""
    logits = forward(params, cfg, tokens, positions=positions,
                     vision_embeds=vision_embeds, audio_frames=audio_frames)
    last = logits[:, -1].clone()        # a copy: the full logits go free
    return last, last.argmax(-1)


# ====================================================================== #
# Decode
# ====================================================================== #
def block_decode(p: Dict, cfg: ArchConfig, h: torch.Tensor, cache: Dict,
                 pos: torch.Tensor, kind: str = "rec",
                 encoder_out: Optional[torch.Tensor] = None,
                 positions_3d: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict]:
    """One token through one block of ``kind``: ``h`` ``(B, 1, d)`` at
    positions ``pos`` ``(B,)`` (``positions_3d`` ``(B, 1, 3)`` under
    M-RoPE) and the block's cache → ``(h, new cache)``. An attention block
    writes its KV cache (MLA: its compressed cache) in place; a ``dec``
    block attends to ``encoder_out``, or to the cache's ``cross_kv`` when
    it holds one. An MoE block dispatches as ``cfg.moe_dispatch`` says."""
    new_cache: Dict = {}
    x = rmsnorm(p["norm1"], h)
    if kind == "rec":
        if cfg.arch_type == "rwkv":
            mix, new_cache["rec"] = rec.rwkv_decode(
                p["rec"], x, cache["rec"], cfg.rwkv_head_dim)
        else:
            mix, new_cache["rec"] = rec.rglru_decode(p["rec"], x,
                                                     cache["rec"])
    elif cfg.use_mla:
        mix, new_cache["attn"] = attn.mla_decode(
            p["attn"], x, cache["attn"], pos, num_heads=cfg.num_heads,
            kv_lora_rank=cfg.kv_lora_rank,
            qk_nope_head_dim=cfg.qk_nope_head_dim,
            qk_rope_head_dim=cfg.qk_rope_head_dim,
            v_head_dim=cfg.v_head_dim, rope_base=cfg.rope_base)
    else:
        mix, new_cache["attn"] = attn.attention_decode(
            p["attn"], x, cache["attn"], pos, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
            rope_base=cfg.rope_base, m_rope=cfg.m_rope,
            positions_3d=positions_3d, window=_window(cfg, kind))
    h = h + shard_activation(mix)
    if kind == "dec":
        h = h + shard_activation(_cross(p, cfg, h, encoder_out,
                                        cache.get("cross_kv")))
        if "cross_kv" in cache:
            new_cache["cross_kv"] = cache["cross_kv"]
    x2 = rmsnorm(p["norm2"], h)
    if "moe" in p:
        if cfg.moe_dispatch == "capacity":
            out, _ = _moe(p, cfg, x2)
        else:
            out = moe_lib.moe_apply_decode(p["moe"], x2, top_k=cfg.top_k,
                                           act=cfg.mlp_act)
        return h + shard_activation(out), new_cache
    if "mlp" in p:
        return h + shard_activation(mlp_apply(p["mlp"], x2,
                                                  cfg.mlp_act)), new_cache
    c = p["cmix"]
    x_prev = cache["cmix_x_prev"]
    x2_t = x2[:, 0]
    k = (x2_t + (x_prev - x2_t) * c["mu_k"]) @ c["w_k"]
    r = torch.sigmoid((x2_t + (x_prev - x2_t) * c["mu_r"]) @ c["w_r"])
    out = (r * (torch.square(F.relu(k)) @ c["w_v"]))[:, None]
    new_cache["cmix_x_prev"] = x2_t
    return h + shard_activation(out), new_cache


def _block_cache(cfg: ArchConfig, kind: str, batch: int, seq_len: int, *,
                 lead: Shape = (), device="cpu",
                 dtype=torch.float32) -> Dict:
    """Empty decode cache of one block of ``kind``, stacked ``lead`` deep.
    RWKV: the fp32 WKV state and the two token-shift rows in ``dtype``;
    RG-LRU: its fp32 state and conv history; MLA: the compressed latent
    ``c_kv`` ``(batch, seq_len, rank)`` and the shared rotary key
    ``k_rope`` ``(batch, seq_len, r)``; other attention: k and v ``(batch,
    rows, H_kv, hd)`` in ``dtype``, ``rows = min(seq_len, window)`` for a
    windowed block (a ring buffer, ``attention.attention_decode``); a
    ``dec`` block under ``cfg.cache_cross_kv`` also the encoder's k and v
    ``(batch, encoder_frames, H, hd)``, which the caller fills
    (``attention.cross_kv_cache``)."""
    d = cfg.d_model
    kw = dict(lead=lead, device=device, dtype=dtype)

    def zeros(*shape):
        return torch.zeros(lead + shape, device=device, dtype=dtype)
    if kind == "rec" and cfg.arch_type == "rwkv":
        return {"rec": rec.rwkv_init_state(batch, d, cfg.rwkv_head_dim,
                                           **kw),
                "cmix_x_prev": zeros(batch, d)}
    if kind == "rec":
        return {"rec": rec.rglru_init_state(batch, cfg.lru_width or d,
                                            cfg.conv1d_width, **kw)}
    hd = cfg.resolved_head_dim
    c: Dict = {}
    if kind == "dec" and cfg.cache_cross_kv:
        shape = (batch, cfg.encoder_frames, cfg.num_heads, hd)
        c["cross_kv"] = {"k": zeros(*shape), "v": zeros(*shape)}
    if cfg.use_mla:
        c["attn"] = {"c_kv": zeros(batch, seq_len, cfg.kv_lora_rank),
                     "k_rope": zeros(batch, seq_len, cfg.qk_rope_head_dim)}
        return c
    window = _window(cfg, kind)
    rows = seq_len if window is None else min(seq_len, window)
    shape = (batch, rows, cfg.num_kv_heads, hd)
    c["attn"] = {"k": zeros(*shape), "v": zeros(*shape)}
    return c


def init_decode_cache(cfg: ArchConfig, batch: int, seq_len: int, *,
                      device=None, dtype=torch.bfloat16) -> PyTree:
    """The cache tree matching the stack plan for ``batch`` rows of up to
    ``seq_len`` tokens, each scanned group's leaves stacked ``(L, ...)``
    (RWKV's is O(1) in ``seq_len``); the encoder-decoder's also holds
    ``encoder_out`` ``(batch, encoder_frames, d)``, zeros until the caller
    sets it. Runs on ``device`` (default ``cuda``; ``"meta"`` makes only
    the shapes). ``dtype`` is the KV
    cache's, the conv history's, the token-shift rows' and
    ``encoder_out``'s type, which must be the weights' (a decode step
    multiplies them by the weights; the recurrent states are fp32 whatever
    the weights, as in the reference): bfloat16 by default, as
    :func:`init_params`'s weights and the reference's cache; pass
    ``dtype=torch.float32`` for fp32 weights."""
    dev = (torch.device("meta") if str(device) == "meta"
           else resolve_device(device))
    kw = dict(device=dev, dtype=dtype)
    groups = []
    for kind, n, scanned in stack_plan(cfg):
        lead = (n,) if scanned else ()

        def one():
            if kind == "pattern":
                return {f"sub{i}": _block_cache(cfg, kd, batch, seq_len,
                                                lead=lead, **kw)
                        for i, kd in enumerate(_pattern(cfg))}
            return _block_cache(cfg, kind, batch, seq_len, lead=lead, **kw)
        groups.append(one() if scanned else [one() for _ in range(n)])
    cache: Dict = {"groups": groups}
    if cfg.arch_type == "encdec":
        cache["encoder_out"] = torch.zeros(
            (batch, cfg.encoder_frames, cfg.d_model), **kw)
    return cache


def _copy_into(dst: PyTree, src: PyTree) -> None:
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    elif dst is not src:        # a KV cache is written in place
        dst.copy_(src)


def decode_step(params: PyTree, cfg: ArchConfig, tokens: torch.Tensor,
                cache: PyTree, pos: torch.Tensor, *,
                positions_3d: Optional[torch.Tensor] = None,
                vision_embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, PyTree]:
    """One-token decode: ``tokens (B, 1)`` at positions ``pos (B,)`` (the
    KV cache's write index; the recurrent states need none; M-RoPE's
    rotation takes ``positions_3d`` ``(B, 1, 3)``), with ``vision_embeds``
    ``(B, 1, vision_dim)`` added as in :func:`embed_tokens` → ``(logits
    (B, 1, V), cache)``. The encoder-decoder attends to the cache's
    ``encoder_out``. The cache is updated in place (the reference's
    serving step donates it) and returned."""
    if cfg.m_rope and positions_3d is None:
        raise ValueError(f"{cfg.name}: an M-RoPE decode step needs "
                         f"positions_3d (B, 1, 3)")
    encoder_out = cache.get("encoder_out")
    h = shard_activation(embed_tokens(params, cfg, tokens, vision_embeds))
    for gparams, gcache, (kind, n, scanned) in zip(
            params["groups"], cache["groups"], stack_plan(cfg)):
        for i in range(n):
            lp = layer_params(gparams, i) if scanned else gparams[i]
            lc = layer_params(gcache, i) if scanned else gcache[i]
            kinds = _pattern(cfg) if kind == "pattern" else (kind,)
            if scanned:
                h = shard_activation(h)     # a scan's carry: one layout
            lp = gather_weights(lp)
            for j, kd in enumerate(kinds):
                sub = f"sub{j}" if kind == "pattern" else None
                bp, bc = (lp[sub], lc[sub]) if sub else (lp, lc)
                h, nc = block_decode(bp, cfg, h, bc, pos, kd, encoder_out,
                                     positions_3d)
                _copy_into(bc, nc)
    return shard_logits(_head(params, cfg, h)), cache
