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

def bag_cost(table, ids, seg, num_bags, weights=None) -> dispatch.OpCost:
    """embedding_bag: each id's row, the ids, segment ids and weights
    read once, the (num_bags, d) sums written; one add a row element
    (two with weights)."""
    nnz, d = ids.numel(), table.shape[1]
    el = table.element_size()
    nbytes = (nnz * d * el + nnz * (ids.element_size() + seg.element_size())
              + (0 if weights is None else nnz * weights.element_size())
              + num_bags * d * el)
    return dispatch.OpCost(nnz * d * (1 if weights is None else 2), nbytes)


dispatch.register_op(
    "embedding_bag",
    cuda=lambda table, ids, seg, num_bags, weights=None: embedding_bag(
        table, ids, seg, num_bags, weights),
    torch=embedding_bag_ref,
    tunables={},
    cost=bag_cost,
)


def bag(table: torch.Tensor, ids: torch.Tensor, segment_ids: torch.Tensor,
        num_bags: int, weights: Optional[torch.Tensor] = None,
        backend: Optional[str] = None) -> torch.Tensor:
    """Fused CSR embedding-bag pooling (sum mode), backend-dispatched."""
    return dispatch.dispatch("embedding_bag", table, ids, segment_ids,
                             num_bags, weights, backend=backend)


__all__ = ["bag", "embedding_bag", "embedding_bag_inorder",
           "embedding_bag_ref"]
