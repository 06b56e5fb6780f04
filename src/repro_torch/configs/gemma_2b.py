"""gemma-2b [dense] — GeGLU, head_dim=256, MQA (kv=1).  [arXiv:2403.08295]
(port of ``repro/configs/gemma_2b.py``)

``ARCH_LONG`` (gemma-2b-sw) is the reference's long-context variant with a
4,096-token sliding window, for the ``long_500k`` decode shape; the paper's
gemma-2b is full attention.
"""
import dataclasses

from repro_torch.nn.transformer import ArchConfig

ARCH = ArchConfig(
    name="gemma-2b", arch_type="dense",
    num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1,
    head_dim=256, d_ff=16384, vocab_size=256000,
    mlp_act="gelu_tanh", mlp_glu=True, rope_base=10000.0,
    tie_embeddings=True,
    citation="arXiv:2403.08295",
)

# long-context variant (long_500k decode): 4096-token sliding window
ARCH_LONG = dataclasses.replace(ARCH, name="gemma-2b-sw",
                                sliding_window=4096)
