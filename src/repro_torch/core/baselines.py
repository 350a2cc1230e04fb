"""Baseline embedding schemes the paper compares against (§3.4).

This slice ports only the full table (FE), the 100% size baseline that
``EmbeddingConfig`` defaults to; low-rank factorization, scalar
quantization and the hashing trick are the baselines slice in
ROADMAP.md.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.dpq import row_gather
from repro_torch.core.types import EmbeddingConfig


def full_init(gen: torch.Generator, cfg: EmbeddingConfig,
              dtype=torch.float32) -> dict:
    """The (n, d) table, scaled in place (the peak is one table)."""
    emb = torch.randn((cfg.vocab_size, cfg.dim), generator=gen,
                      dtype=dtype, device=gen.device)
    return {"emb": emb.mul_(cfg.dim ** -0.5)}


def full_lookup(params: dict, ids: torch.Tensor, cfg: EmbeddingConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training-path lookup of the full table: (rows, zero aux)."""
    rows = row_gather(params["emb"], ids, sharded=cfg.sharded_rows)
    return rows, torch.zeros((), dtype=torch.float32, device=rows.device)
