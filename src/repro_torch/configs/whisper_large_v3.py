"""whisper-large-v3 [audio enc-dec] — the 32-layer encoder + 32-layer
decoder transformer backbone.  [arXiv:2212.04356]
(port of ``repro/configs/whisper_large_v3.py``)

The conv/mel front end is a stub, as in the reference: the encoder takes
precomputed frame embeddings. The backbone follows the repo-wide
pre-norm/RoPE conventions (Whisper itself uses learned absolute positions
and LayerNorm); the dimensions (d=1280, 20 heads, d_ff=5120,
vocab=51866) are Whisper's.
"""
from repro_torch.nn.transformer import ArchConfig

ARCH = ArchConfig(
    name="whisper-large-v3", arch_type="encdec",
    num_layers=32, d_model=1280, num_heads=20, num_kv_heads=20,
    d_ff=5120, vocab_size=51866,
    encoder_layers=32, encoder_frames=1500,
    mlp_act="gelu", mlp_glu=False, tie_embeddings=True,
    citation="arXiv:2212.04356",
)
