"""The LM substrate (port of ``repro.nn``: the dense, MoE (with MLA),
RWKV-6, RG-LRU hybrid, encoder-decoder and VLM families)."""
from repro_torch.nn.transformer import (
    ArchConfig, count_params, decode_step, forward, init_decode_cache,
    init_params, loss_fn, prefill, stack_plan,
)

__all__ = ["ArchConfig", "count_params", "decode_step", "forward",
           "init_decode_cache", "init_params", "loss_fn", "prefill",
           "stack_plan"]
