"""Config dataclasses for the recsys family + input-shape specs.

Each architecture file in this package exports ``CONFIG`` (full scale)
and ``smoke_config()`` (reduced, runs on the CPU).  Field for field the
same as the JAX package's, so one set of numbers configures both.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


# ----------------------------------------------------------------------
# RecSys family
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    model: str                      # autoint | deepfm | two_tower | bst
    n_sparse: int = 39
    embed_dim: int = 16
    field_vocab_sizes: Tuple[int, ...] = ()   # len n_sparse
    # embedding compression spec applied to *large* fields
    embed_kind: str = "mgqe"
    mgqe_min_vocab: int = 10_000    # fields smaller than this stay full
    # kernel backend for the export and serving ops (auto | cuda |
    # torch); $REPRO_TORCH_KERNEL_BACKEND overrides "auto"
    kernel_backend: str = "auto"
    # model-parallel row gathers (not ported yet)
    sharded_embedding: bool = False
    num_subspaces: int = 8
    num_centroids: int = 256
    tier_head_fraction: float = 0.1
    tier_tail_centroids: int = 64
    # autoint
    n_attn_layers: int = 3
    n_attn_heads: int = 2
    d_attn: int = 32
    # deepfm / bst / two-tower MLPs
    mlp_dims: Tuple[int, ...] = (400, 400, 400)
    # two-tower
    tower_mlp: Tuple[int, ...] = (1024, 512, 256)
    n_items: int = 10_000_000       # retrieval corpus size
    n_users: int = 50_000_000
    # bst
    seq_len: int = 20
    n_blocks: int = 1
    bst_heads: int = 8
    dtype: str = "float32"


# ----------------------------------------------------------------------
# Input-shape specs
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # rec_train | rec_serve | rec_retrieval
    batch: int = 0
    n_candidates: int = 0


RECSYS_SHAPES = (
    ShapeSpec("train_batch", "rec_train", batch=65536),
    ShapeSpec("serve_p99", "rec_serve", batch=512),
    ShapeSpec("serve_bulk", "rec_serve", batch=262144),
    ShapeSpec("retrieval_cand", "rec_retrieval", batch=1,
              n_candidates=1_000_000),
)
