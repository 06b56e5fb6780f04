"""qwen2.5-32b [dense] — GQA kv=8, QKV bias.  [hf:Qwen/Qwen2.5-0.5B family]
(port of ``repro/configs/qwen2_5_32b.py``)"""
from repro_torch.nn.transformer import ArchConfig

ARCH = ArchConfig(
    name="qwen2.5-32b", arch_type="dense",
    num_layers=64, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=27648, vocab_size=152064,
    qkv_bias=True, rope_base=1_000_000.0, mlp_act="silu", mlp_glu=True,
    tie_embeddings=False,
    citation="hf:Qwen/Qwen2.5-0.5B",
)
