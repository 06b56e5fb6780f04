"""arctic-480b [moe] — dense-MoE hybrid: every layer sums a dense FFN
residual branch and a 128-expert top-2 MoE branch.
[hf:Snowflake/snowflake-arctic-base]
(port of ``repro/configs/arctic_480b.py``)"""
from repro_torch.nn.transformer import ArchConfig

ARCH = ArchConfig(
    name="arctic-480b", arch_type="moe",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=4864, vocab_size=32000,
    num_experts=128, top_k=2, d_ff_expert=4864,
    moe_dense_residual=True,
    mlp_act="silu", mlp_glu=True, tie_embeddings=False,
    citation="hf:Snowflake/snowflake-arctic-base",
)
