"""Shared helpers for LM arch configs: default MGQE spec for the token
embedding (the paper's technique applied to the LM vocab)."""
from __future__ import annotations

from repro_torch.core.types import EmbeddingConfig


def lm_embedding(vocab_size: int, d_model: int, kind: str = "mgqe",
                 num_subspaces: int = 8) -> EmbeddingConfig:
    """Paper defaults (§3.4): K=256, two tiers (top 10% head), tail K=64."""
    if kind in ("dpq", "mgqe"):
        extra = dict(num_subspaces=num_subspaces, num_centroids=256)
        if kind == "mgqe":
            head = max(1, vocab_size // 10)
            extra.update(tier_boundaries=(head,),
                         tier_num_centroids=(256, 64))
        return EmbeddingConfig(vocab_size=vocab_size, dim=d_model, kind=kind,
                               **extra)
    return EmbeddingConfig(vocab_size=vocab_size, dim=d_model, kind=kind)
