"""The LM model definition (port of the RWKV subset of
``repro/nn/transformer.py``).

``ArchConfig`` is the reference's whole configuration record; of its
architectures the port runs ``arch_type="rwkv"`` (RWKV-6), and every other
family raises ``NotImplementedError`` naming its ROADMAP item. Parameters
are the reference's tree — ``{"embed", "final_norm", "lm_head", "groups":
[group]}`` with each scanned group's leaves stacked ``(L, ...)`` — as plain
dicts of tensors; a layer is a view into the stacks. Entry points:

* ``forward`` — full-sequence logits;
* ``prefill`` — the last position's logits and their argmax (the cache is
  not written, as in the reference);
* ``decode_step`` — one token against the recurrent state.

``rwkv_mode`` picks the time mix's WKV form: ``"sequential"`` (the
default), ``"chunked"`` (plain PyTorch, only when S is a multiple of
``rwkv_chunk``, else sequential) or ``"chunked_kernel"`` (the CUDA kernel on
the card, any S). Without a mesh the reference's activation and logits
sharding pins are no-ops, so there are none here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.nn import recurrent as rec
from repro_torch.nn.layers import (
    Shape, dense_init, embed_init, full, rmsnorm, rmsnorm_params,
)
from repro_torch.roadmap import not_ported

PyTree = Any

# the ROADMAP item of each unported architecture family
_FAMILY_ITEMS = {"dense": "attention", "moe": "moe", "hybrid": "rglru",
                 "encdec": "multimodal", "vlm": "multimodal"}


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



def unported(cfg: ArchConfig) -> NotImplementedError:
    """The error for an architecture family the port does not run yet."""
    return not_ported(f"arch_type={cfg.arch_type!r} ({cfg.name})",
                      _FAMILY_ITEMS.get(cfg.arch_type, "attention"))


# ====================================================================== #
# Parameters
# ====================================================================== #
def _block_params(generator, cfg: ArchConfig, *, lead: Shape = (),
                  device="cpu", dtype=torch.float32) -> Dict:
    """One RWKV block (time mix ``rec`` + channel mix ``cmix``), stacked
    ``lead`` deep."""
    d = cfg.d_model

    def dense(d_in, d_out):
        return dense_init(generator, d_in, d_out, lead=lead, device=device,
                          dtype=dtype)

    return {
        "norm1": rmsnorm_params(d, lead=lead, device=device, dtype=dtype),
        "norm2": rmsnorm_params(d, lead=lead, device=device, dtype=dtype),
        "rec": rec.rwkv_params(generator, d, cfg.rwkv_head_dim, lead=lead,
                               device=device, dtype=dtype),
        # token-shifted squared-ReLU FFN
        "cmix": {
            "mu_k": full(lead + (d,), 0.5, device, dtype),
            "mu_r": full(lead + (d,), 0.5, device, dtype),
            "w_k": dense(d, cfg.d_ff),
            "w_v": dense(cfg.d_ff, d),
            "w_r": dense(d, d),
        },
    }


def stack_plan(cfg: ArchConfig) -> List[Tuple[str, int, bool]]:
    """``(kind, n_layers, scanned)`` groups covering the stack in order:
    for RWKV one scanned group of recurrent blocks. Every entry point goes
    through it, so it is where another family raises."""
    if cfg.arch_type != "rwkv":
        raise unported(cfg)
    return [("rec", cfg.num_layers, True)]


def init_params(cfg: ArchConfig, *, generator: Optional[torch.Generator],
                device=None, dtype=torch.bfloat16) -> PyTree:
    """The reference's parameter tree for ``cfg`` with its distributions,
    drawn from ``generator`` (a ``torch.Generator`` on ``device``, default
    ``cuda``), in ``dtype``: bfloat16 by default, the reference's default
    (``repro.nn.transformer.init_params``); the values are drawn in fp32
    and rounded, so a bf16 tree is the fp32 tree of the same generator
    rounded to bf16. Pass ``dtype=torch.float32`` for fp32 weights. The
    draws differ from JAX's; parity tests start both sides from the JAX
    weights (``repro_torch.convert.lm_params_from_jax``). On
    ``device="meta"`` only the shapes are made (``generator`` may be
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
    params["groups"] = [_block_params(generator, cfg, lead=(n,), **kw)
                        for _, n, _ in stack_plan(cfg)]
    return params


def layer_params(group: PyTree, i: int) -> PyTree:
    """Layer ``i`` of a stacked group: views into the stacks."""
    if isinstance(group, dict):
        return {k: layer_params(v, i) for k, v in group.items()}
    return group[i]


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


def block_apply(p: Dict, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    """Pre-norm residual RWKV block. (The reference's MoE auxiliary loss is
    0 for RWKV blocks, so none is returned.)"""
    xin = rmsnorm(p["norm1"], h)
    if cfg.rwkv_mode == "chunked" and xin.shape[1] % cfg.rwkv_chunk == 0:
        mix = rec.rwkv_apply_chunked(p["rec"], xin, cfg.rwkv_head_dim,
                                     chunk=cfg.rwkv_chunk)
    elif cfg.rwkv_mode == "chunked_kernel":
        mix = rec.rwkv_apply_kernel(p["rec"], xin, cfg.rwkv_head_dim,
                                    chunk=cfg.rwkv_chunk)
    else:
        mix = rec.rwkv_apply(p["rec"], xin, cfg.rwkv_head_dim)
    h = h + mix
    return h + _channel_full(p, rmsnorm(p["norm2"], h))


def embed_tokens(params: PyTree, cfg: ArchConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens] * (cfg.d_model ** 0.5)


def _head(params: PyTree, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    h = rmsnorm(params["final_norm"], h)
    if cfg.tie_embeddings:
        return h @ params["embed"].T
    return h @ params["lm_head"]


def forward(params: PyTree, cfg: ArchConfig,
            tokens: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward: ``(B, S)`` tokens → logits ``(B, S, V)``
    (RWKV has no positional encoding and no auxiliary loss)."""
    h = embed_tokens(params, cfg, tokens)
    for gparams, (_, n, _) in zip(params["groups"], stack_plan(cfg)):
        for i in range(n):
            h = block_apply(layer_params(gparams, i), cfg, h)
    return _head(params, cfg, h)


def prefill(params: PyTree, cfg: ArchConfig, tokens: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill forward: ``(last-position logits (B, V), their argmax
    (B,))``. Like the reference it writes no decode cache: serving
    (``ServeEngine``) feeds prompts through ``decode_step``."""
    logits = forward(params, cfg, tokens)
    last = logits[:, -1].clone()        # a copy: the full logits go free
    return last, last.argmax(-1)


# ====================================================================== #
# Decode
# ====================================================================== #
def block_decode(p: Dict, cfg: ArchConfig, h: torch.Tensor,
                 cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One token through one RWKV block: ``h`` ``(B, 1, d)`` and the
    block's cache → ``(h, new cache)``."""
    new_cache: Dict = {}
    x = rmsnorm(p["norm1"], h)
    mix, new_cache["rec"] = rec.rwkv_decode(p["rec"], x, cache["rec"],
                                            cfg.rwkv_head_dim)
    h = h + mix
    x2 = rmsnorm(p["norm2"], h)
    c = p["cmix"]
    x_prev = cache["cmix_x_prev"]
    x2_t = x2[:, 0]
    k = (x2_t + (x_prev - x2_t) * c["mu_k"]) @ c["w_k"]
    r = torch.sigmoid((x2_t + (x_prev - x2_t) * c["mu_r"]) @ c["w_r"])
    out = (r * (torch.square(F.relu(k)) @ c["w_v"]))[:, None]
    new_cache["cmix_x_prev"] = x2_t
    return h + out, new_cache


def _block_cache(cfg: ArchConfig, batch: int, *, lead: Shape = (),
                 device="cpu", dtype=torch.float32) -> Dict:
    """Empty decode cache of one RWKV block, stacked ``lead`` deep: the
    fp32 WKV state and the two token-shift rows in ``dtype``."""
    return {"rec": rec.rwkv_init_state(batch, cfg.d_model,
                                       cfg.rwkv_head_dim, lead=lead,
                                       device=device, dtype=dtype),
            "cmix_x_prev": torch.zeros(lead + (batch, cfg.d_model),
                                       device=device, dtype=dtype)}


def init_decode_cache(cfg: ArchConfig, batch: int, *,
                      device=None, dtype=torch.bfloat16) -> PyTree:
    """The cache tree matching the stack plan, each scanned group's leaves
    stacked ``(L, ...)``; O(1) in the sequence length, so unlike the
    reference's it takes none. Runs on ``device`` (default ``cuda``).
    ``dtype`` is the token-shift rows' type, which must be the weights'
    (a decode step multiplies them by the weights; the WKV state is fp32
    whatever the weights, as in the reference): bfloat16 by default, as
    :func:`init_params`'s weights and the reference's cache; pass
    ``dtype=torch.float32`` for fp32 weights."""
    dev = resolve_device(device)
    return {"groups": [_block_cache(cfg, batch, lead=(n,), device=dev,
                                    dtype=dtype)
                       for _, n, _ in stack_plan(cfg)]}


def _copy_into(dst: PyTree, src: PyTree) -> None:
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    else:
        dst.copy_(src)


def decode_step(params: PyTree, cfg: ArchConfig, tokens: torch.Tensor,
                cache: PyTree) -> Tuple[torch.Tensor, PyTree]:
    """One-token decode: ``tokens (B, 1)`` → ``(logits (B, 1, V), cache)``.
    The recurrent state needs no write index (the reference's ``pos``).
    The cache is updated in place (the reference's serving step donates
    it) and returned."""
    h = embed_tokens(params, cfg, tokens)
    for gparams, gcache, (_, n, _) in zip(
            params["groups"], cache["groups"], stack_plan(cfg)):
        for i in range(n):
            lc = layer_params(gcache, i)
            h, nc = block_decode(layer_params(gparams, i), cfg, h, lc)
            _copy_into(lc, nc)
    return _head(params, cfg, h), cache
