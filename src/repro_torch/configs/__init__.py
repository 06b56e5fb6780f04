"""Configurations (port of ``repro/configs/__init__.py``): the LM
architecture registry and the paper's RGCN link-prediction configurations
(§4.4). The port runs all ten assigned LM architectures and gemma-2b's
long-context variant: the dense ones (glm4-9b, qwen3-32b, qwen2.5-32b,
gemma-2b, gemma-2b-sw), the MoE ones (arctic-480b, deepseek-v2-lite-16b),
``rwkv6-3b``, ``recurrentgemma-9b``, ``whisper-large-v3`` and
``qwen2-vl-7b``. ``UNPORTED`` maps an architecture the port cannot run to
its ROADMAP item (``repro_torch.roadmap``); it is empty."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.arctic_480b import ARCH as ARCTIC_480B
from repro_torch.configs.deepseek_v2_lite_16b import (
    ARCH as DEEPSEEK_V2_LITE_16B,
)
from repro_torch.configs.gemma_2b import ARCH as GEMMA_2B
from repro_torch.configs.gemma_2b import ARCH_LONG as GEMMA_2B_SW
from repro_torch.configs.glm4_9b import ARCH as GLM4_9B
from repro_torch.configs.qwen2_5_32b import ARCH as QWEN2_5_32B
from repro_torch.configs.qwen2_vl_7b import ARCH as QWEN2_VL_7B
from repro_torch.configs.qwen3_32b import ARCH as QWEN3_32B
from repro_torch.configs.recurrentgemma_9b import ARCH as RECURRENTGEMMA_9B
from repro_torch.configs.rwkv6_3b import ARCH as RWKV6_3B
from repro_torch.configs.whisper_large_v3 import ARCH as WHISPER_LARGE_V3
from repro_torch.nn.transformer import ArchConfig
from repro_torch.roadmap import not_ported
from repro_torch.training.trainer import TrainConfig

ARCHS: Dict[str, ArchConfig] = {
    a.name: a for a in [GLM4_9B, QWEN3_32B, QWEN2_5_32B, GEMMA_2B,
                        WHISPER_LARGE_V3, RWKV6_3B, RECURRENTGEMMA_9B,
                        ARCTIC_480B, QWEN2_VL_7B, DEEPSEEK_V2_LITE_16B,
                        GEMMA_2B_SW]}

# an architecture of the reference's the port cannot run, and its ROADMAP
# item (``repro_torch.roadmap.ITEMS``): none
UNPORTED: Dict[str, str] = {}

def get_arch(name: str) -> ArchConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in UNPORTED:
        raise not_ported(f"the {name} architecture", UNPORTED[name])
    raise KeyError(f"unknown arch {name!r}; known: "
                   f"{sorted(set(ARCHS) | set(UNPORTED))}")


RGCN_FB15K237 = TrainConfig(
    num_trainers=8, strategy="vertex_cut", num_hops=2,
    hidden_dim=75, num_bases=2, num_negatives=1,
    batch_size=None,            # full edge batch (paper §4.4)
    learning_rate=0.01, dropout=0.2, epochs=100,
)

RGCN_CITATION2 = TrainConfig(
    num_trainers=8, strategy="vertex_cut", num_hops=2,
    hidden_dim=32, num_bases=2, num_negatives=1,
    batch_size=118_000,         # paper: ~118k edge mini-batch
    learning_rate=0.01, dropout=0.2, epochs=100,
)
