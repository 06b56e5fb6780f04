"""qwen3-32b [dense] — qk_norm, GQA kv=8.  [hf:Qwen/Qwen3-8B family]
(port of ``repro/configs/qwen3_32b.py``)"""
from repro_torch.nn.transformer import ArchConfig

ARCH = ArchConfig(
    name="qwen3-32b", arch_type="dense",
    num_layers=64, d_model=5120, num_heads=64, num_kv_heads=8,
    head_dim=128, d_ff=25600, vocab_size=151936,
    qk_norm=True, rope_base=1_000_000.0, mlp_act="silu", mlp_glu=True,
    tie_embeddings=False,
    citation="hf:Qwen/Qwen3-8B",
)
