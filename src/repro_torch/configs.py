"""The paper's RGCN link-prediction configurations (port of the KGE half of
``repro/configs/__init__.py``, §4.4). The LM architectures of the reference
registry are not ported yet (``repro_torch.roadmap``)."""
from __future__ import annotations

from repro_torch.training.trainer import TrainConfig

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
