"""Host graph side: the knowledge-graph triplet store."""
from repro_torch.core.graph import KnowledgeGraph

__all__ = ["KnowledgeGraph"]
