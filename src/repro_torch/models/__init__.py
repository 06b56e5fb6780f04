"""KGE decoders in the canonical query form."""
from repro_torch.models.decoders import (
    Decoder, get_decoder, init_decoder_params, register_decoder,
    registered_decoders, score_against_candidates,
)

__all__ = ["Decoder", "get_decoder", "init_decoder_params",
           "register_decoder", "registered_decoders",
           "score_against_candidates"]
