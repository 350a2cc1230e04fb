"""Per-field embedding configs for the recsys models.

Large-vocab fields are compressed with the paper's MGQE (or DPQ, RQ, or
one of the baselines it is compared against); small fields stay full —
quantizing a 100-row table is pure overhead.  The field collection and
EmbeddingBag pooling are the recsys slice in ROADMAP.md.
"""
from __future__ import annotations

from repro_torch.configs.base import RecsysConfig
from repro_torch.core.partition import frequency_boundaries
from repro_torch.core.types import EmbeddingConfig


def field_embedding_config(cfg: RecsysConfig, vocab: int) -> EmbeddingConfig:
    """Per-field embedding spec: MGQE/DPQ for big fields, full for small."""
    kind = cfg.embed_kind
    sharded = cfg.sharded_embedding and vocab >= cfg.mgqe_min_vocab
    kb = cfg.kernel_backend
    if vocab < cfg.mgqe_min_vocab or kind == "full":
        return EmbeddingConfig(vocab_size=vocab, dim=cfg.embed_dim,
                               sharded_rows=sharded, kernel_backend=kb)
    if kind == "dpq":
        return EmbeddingConfig(
            vocab_size=vocab, dim=cfg.embed_dim, kind="dpq",
            num_subspaces=cfg.num_subspaces, num_centroids=cfg.num_centroids,
            sharded_rows=sharded, kernel_backend=kb)
    if kind == "mgqe":
        bounds = frequency_boundaries(vocab, (cfg.tier_head_fraction,))
        return EmbeddingConfig(
            vocab_size=vocab, dim=cfg.embed_dim, kind="mgqe",
            num_subspaces=cfg.num_subspaces, num_centroids=cfg.num_centroids,
            tier_boundaries=bounds,
            tier_num_centroids=(cfg.num_centroids, cfg.tier_tail_centroids),
            sharded_rows=sharded, kernel_backend=kb)
    if kind == "rq":
        # residual quantization: num_subspaces doubles as the stage
        # count M (the same code-bytes-per-row knob as PQ's D)
        return EmbeddingConfig(
            vocab_size=vocab, dim=cfg.embed_dim, kind="rq",
            num_levels=cfg.num_subspaces, num_centroids=cfg.num_centroids,
            sharded_rows=sharded, kernel_backend=kb)
    # baselines for the comparison sweeps (no kernel, so no backend)
    if kind == "lrf":
        return EmbeddingConfig(vocab_size=vocab, dim=cfg.embed_dim,
                               kind="lrf", rank=max(2, cfg.embed_dim // 4))
    if kind == "sq":
        return EmbeddingConfig(vocab_size=vocab, dim=cfg.embed_dim,
                               kind="sq", sq_bits=8)
    if kind == "hash":
        return EmbeddingConfig(vocab_size=vocab, dim=cfg.embed_dim,
                               kind="hash", hash_buckets=max(64, vocab // 4))
    raise ValueError(f"no field embedding for embed_kind {kind!r}")
