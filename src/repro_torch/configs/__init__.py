"""Configurations (port of ``repro/configs/__init__.py``): the LM
architecture registry and the paper's RGCN link-prediction configurations
(§4.4). Of the ten assigned LM architectures the port runs ``rwkv6-3b``;
asking for another raises ``NotImplementedError`` naming its ROADMAP item
(``repro_torch.roadmap``)."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.rwkv6_3b import ARCH as RWKV6_3B
from repro_torch.nn.transformer import ArchConfig
from repro_torch.roadmap import not_ported
from repro_torch.training.trainer import TrainConfig

ARCHS: Dict[str, ArchConfig] = {RWKV6_3B.name: RWKV6_3B}

# the reference's other architectures and the ROADMAP item each waits for
UNPORTED: Dict[str, str] = {
    "glm4-9b": "attention", "qwen3-32b": "attention",
    "qwen2.5-32b": "attention", "gemma-2b": "attention",
    "gemma-2b-sw": "attention", "whisper-large-v3": "multimodal",
    "qwen2-vl-7b": "multimodal", "recurrentgemma-9b": "rglru",
    "arctic-480b": "moe", "deepseek-v2-lite-16b": "moe",
}

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
