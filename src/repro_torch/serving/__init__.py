"""Serving (port of ``repro.serving``): the LM ``ServeEngine``, the dense
``KGEServer``, and the sharded top-k KGE server with its dynamic-batching
engine."""
from repro_torch.serving.engine import KGEServer, Request, ServeEngine
from repro_torch.serving.kge import KGEQuery, KGEServeEngine, ShardedKGEServer

__all__ = ["KGEQuery", "KGEServeEngine", "KGEServer", "Request",
           "ServeEngine", "ShardedKGEServer"]
