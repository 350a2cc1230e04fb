"""Public wrapper for the fused EmbeddingBag op (backend-dispatched).

``bag(table, ids, segment_ids, num_bags, weights)`` routes through the
kernel backend dispatch layer (``repro_torch.kernels.dispatch``): the
CUDA kernel for CUDA tensors, the plain PyTorch version for CPU
tensors, or whichever one is pinned.  The kernel's launch is sized
by ``bag_plan`` from the shapes and the card's SM count, so the op
declares no tunables, as the TPU op declared none.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.embedding_bag.embedding_bag import embedding_bag
from repro_torch.kernels.embedding_bag.ref import (embedding_bag_inorder,
                                                   embedding_bag_ref)

dispatch.register_op(
    "embedding_bag",
    cuda=lambda table, ids, seg, num_bags, weights=None: embedding_bag(
        table, ids, seg, num_bags, weights),
    torch=embedding_bag_ref,
    tunables={},
)


def bag(table: torch.Tensor, ids: torch.Tensor, segment_ids: torch.Tensor,
        num_bags: int, weights: Optional[torch.Tensor] = None,
        backend: Optional[str] = None) -> torch.Tensor:
    """Fused CSR embedding-bag pooling (sum mode), backend-dispatched."""
    return dispatch.dispatch("embedding_bag", table, ids, segment_ids,
                             num_bags, weights, backend=backend)


__all__ = ["bag", "embedding_bag", "embedding_bag_inorder",
           "embedding_bag_ref"]
