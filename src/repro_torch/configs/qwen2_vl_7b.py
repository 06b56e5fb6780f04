"""qwen2-vl-7b [vlm] — M-RoPE (temporal/height/width rotary sections),
dynamic-resolution vision tokens.  [arXiv:2409.12191]
(port of ``repro/configs/qwen2_vl_7b.py``)

The ViT encoder is a stub, as in the reference: the language backbone
takes precomputed patch embeddings (``vision_dim`` wide, projected and
added to the token embeddings) and 3-D positions."""
from repro_torch.nn.transformer import ArchConfig

ARCH = ArchConfig(
    name="qwen2-vl-7b", arch_type="vlm",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    d_ff=18944, vocab_size=152064,
    qkv_bias=True, m_rope=True, rope_base=1_000_000.0,
    vision_dim=1280,
    mlp_act="silu", mlp_glu=True, tie_embeddings=False,
    citation="arXiv:2409.12191",
)
