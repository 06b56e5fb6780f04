"""deepseek-v2-lite-16b [moe] — MLA (kv_lora=512, compressed KV cache),
2 shared + 64 routed experts top-6, first layer dense.  [arXiv:2405.04434]
(port of ``repro/configs/deepseek_v2_lite_16b.py``)

The released V2-Lite has 64 routed + 2 shared experts (160 routed is the
full V2); these are the V2-Lite values, as in the reference.
"""
from repro_torch.nn.transformer import ArchConfig

ARCH = ArchConfig(
    name="deepseek-v2-lite-16b", arch_type="moe",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=10944,                      # the single dense layer's FFN
    vocab_size=102400,
    num_experts=64, top_k=6, num_shared_experts=2, d_ff_expert=1408,
    first_k_dense=1,
    use_mla=True, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    mlp_act="silu", mlp_glu=True, tie_embeddings=False,
    citation="arXiv:2405.04434",
)
