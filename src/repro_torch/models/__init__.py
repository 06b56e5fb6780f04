"""KGE decoders in the canonical query form, the RGCN encoder, the RGAT
encoder and the full GNN-based KGE model."""
from repro_torch.models.decoders import (
    Decoder, bce_loss, get_decoder, init_decoder_params, register_decoder,
    registered_decoders, score_against_candidates, score_triplets,
)
from repro_torch.models.kge import (
    KGEConfig, KGEModel, encode_partition, fullgraph_loss,
    fullgraph_negatives, fullgraph_scored_loss, init_kge_params,
    minibatch_loss, vertex_input,
)
from repro_torch.models.rgat import (
    RGATConfig, init_rgat_params, rgat_encode, rgat_layer,
)
from repro_torch.models.rgcn import (
    RGCNConfig, RGCNLayer, message_passing_ref, rgcn_encode, rgcn_layer,
)

__all__ = ["Decoder", "bce_loss", "get_decoder", "init_decoder_params",
           "register_decoder", "registered_decoders",
           "score_against_candidates", "score_triplets", "KGEConfig",
           "KGEModel", "encode_partition", "fullgraph_loss",
           "fullgraph_negatives", "fullgraph_scored_loss",
           "init_kge_params", "minibatch_loss", "vertex_input",
           "RGATConfig", "init_rgat_params", "rgat_encode", "rgat_layer",
           "RGCNConfig", "RGCNLayer", "message_passing_ref", "rgcn_encode",
           "rgcn_layer"]
