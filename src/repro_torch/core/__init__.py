"""Paper contribution: DPQ + MGQE embedding compression (Kang et al.,
WWW'20 Companion), export-and-serve path, in PyTorch.

Public surface:
    EmbeddingConfig   — declarative table description
    Embedding         — init/export/serve
"""
from repro_torch.core.api import Embedding
from repro_torch.core.types import EmbeddingConfig

__all__ = ["Embedding", "EmbeddingConfig"]
