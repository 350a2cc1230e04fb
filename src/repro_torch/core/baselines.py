"""Baseline embedding schemes the paper compares against (§3.4).

This slice ports only the full table (FE), the 100% size baseline that
``EmbeddingConfig`` defaults to; low-rank factorization, scalar
quantization and the hashing trick are the baselines slice in
ROADMAP.md.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import EmbeddingConfig


def full_init(gen: torch.Generator, cfg: EmbeddingConfig,
              dtype=torch.float32) -> dict:
    scale = cfg.dim ** -0.5
    return {"emb": torch.randn((cfg.vocab_size, cfg.dim), generator=gen,
                               dtype=dtype, device=gen.device) * scale}
