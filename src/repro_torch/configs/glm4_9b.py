"""glm4-9b [dense] — RoPE, GQA kv=2.  [hf:THUDM/glm-4-9b]
(port of ``repro/configs/glm4_9b.py``)"""
from repro_torch.nn.transformer import ArchConfig

ARCH = ArchConfig(
    name="glm4-9b", arch_type="dense",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=2,
    d_ff=13696, vocab_size=151552,
    rope_base=10000.0, mlp_act="silu", mlp_glu=True,
    tie_embeddings=False,
    citation="hf:THUDM/glm-4-9b",
)
