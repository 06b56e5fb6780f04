"""KGE training: preprocessing, the simulated data-parallel step, the
optimizers, checkpoints, evaluation and the trainer."""
from repro_torch.training.checkpoint import (
    latest_checkpoint, restore_checkpoint, save_checkpoint,
)
from repro_torch.training.evaluation import (
    encode_all_entities, encode_entity_block, evaluate_split,
)
from repro_torch.training.optimizer import adam, apply_updates, sgd
from repro_torch.training.preprocessing import (
    PreprocessedGraph, preprocess_graph,
)
from repro_torch.training.trainer import KGETrainer, TrainConfig

__all__ = ["latest_checkpoint", "restore_checkpoint", "save_checkpoint",
           "encode_all_entities", "encode_entity_block", "evaluate_split",
           "adam", "apply_updates", "sgd", "PreprocessedGraph",
           "preprocess_graph", "KGETrainer", "TrainConfig"]
