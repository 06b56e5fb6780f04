"""Serving: the sharded top-k KGE server and its dynamic-batching engine
(port of the KGE half of ``repro.serving``)."""
from repro_torch.serving.kge import KGEQuery, KGEServeEngine, ShardedKGEServer

__all__ = ["KGEQuery", "KGEServeEngine", "ShardedKGEServer"]
