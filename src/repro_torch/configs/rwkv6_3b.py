"""rwkv6-3b [ssm] — Finch: token shift + data-dependent decay WKV.
Attention-free; decode state is O(1) in sequence length.
[arXiv:2404.05892] (port of ``repro/configs/rwkv6_3b.py``)"""
from repro_torch.nn.transformer import ArchConfig

ARCH = ArchConfig(
    name="rwkv6-3b", arch_type="rwkv",
    num_layers=32, d_model=2560, num_heads=40, num_kv_heads=40,
    d_ff=8960, vocab_size=65536,
    rwkv_head_dim=64, tie_embeddings=False,
    citation="arXiv:2404.05892",
)
