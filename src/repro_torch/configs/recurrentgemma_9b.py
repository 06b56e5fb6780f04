"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1:2 pattern
(rec, rec, attn), window 2048, MQA kv=1.  [arXiv:2402.19427]
(port of ``repro/configs/recurrentgemma_9b.py``)"""
from repro_torch.nn.transformer import ArchConfig

ARCH = ArchConfig(
    name="recurrentgemma-9b", arch_type="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
    head_dim=256, d_ff=12288, vocab_size=256000,
    hybrid_pattern=("rec", "rec", "attn"), local_window=2048,
    lru_width=4096, conv1d_width=4,
    mlp_act="gelu_tanh", mlp_glu=True, tie_embeddings=True,
    citation="arXiv:2402.19427",
)
