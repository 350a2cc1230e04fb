"""Plain PyTorch versions of the fused EmbeddingBag (gather + weighted
segment sum).

CSR-style ragged multi-hot pooling: ids (nnz,) index rows of the table,
segment_ids (nnz,) assign each id to a bag, sorted ascending; optional
per-id weights.  The result is in the table's dtype, as the TPU
kernel's is; weights are cast to it first and each product is rounded
to it.

* ``embedding_bag_ref``, the op's plain version (its CPU path, and the
  differentiable one on the card, as the JAX package's ``xla``
  reference is): one gather and one segment sum (``index_add``) in
  float32, rounded once to the table's dtype.  The order of the adds is
  the device's: in id order on the CPU, atomics in no fixed order on
  the card.  The CUDA kernel is held to it within float32's rounding
  over a bag (float32), and within one bfloat16 rounding per product
  and add (bfloat16, where the kernel rounds every add).
* ``embedding_bag_inorder``, the kernel's exact order, for checks only:
  each bag from +0.0, its ids in turn, every add rounded to the table's
  dtype (bfloat16 included, as the TPU kernel's ``out_ref[...] +=``
  and JAX's ``segment_sum`` round).  One ``index_add`` per position
  within the bags adds the j-th id of every bag that has one, so no
  call adds twice to a bag and the order holds on any device; the
  kernel agrees with it bit for bit.  It takes as many steps as the
  longest bag has ids.

Outside the contract (``0 <= id < V``): ids are clamped into the table,
as the kernel and the TPU kernel in interpret mode clamp them; the JAX
``xla`` reference (``jnp.take``) gives NaN rows instead.  Segment ids
must lie in ``[0, num_bags)``.
"""
from __future__ import annotations

from typing import Optional

import torch


def _rows(table: torch.Tensor, ids: torch.Tensor,
          weights: Optional[torch.Tensor]) -> torch.Tensor:
    """The gathered (clamped) rows, times the weights, in the table's
    dtype: (nnz, d)."""
    idx = ids.reshape(-1).long().clamp(0, table.shape[0] - 1)
    rows = table.index_select(0, idx)
    if weights is not None:
        rows = rows * weights.to(table.dtype)[:, None]
    return rows


def embedding_bag_ref(table: torch.Tensor, ids: torch.Tensor,
                      segment_ids: torch.Tensor, num_bags: int,
                      weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """table (V, d); ids/segment_ids (nnz,) -> pooled (num_bags, d)."""
    rows = _rows(table, ids, weights)
    out = torch.zeros((num_bags, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    out = out.index_add(0, segment_ids.reshape(-1).long(), rows.float())
    return out.to(table.dtype)


def embedding_bag_inorder(table: torch.Tensor, ids: torch.Tensor,
                          segment_ids: torch.Tensor, num_bags: int,
                          weights: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """``embedding_bag_ref`` summed in the kernel's order and rounding."""
    rows = _rows(table, ids, weights)
    out = torch.zeros((num_bags, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    seg = segment_ids.reshape(-1).long()
    if seg.numel() == 0:
        return out
    # position of each id within its bag (segment ids sorted ascending)
    rank = torch.arange(seg.numel(), device=seg.device) \
        - torch.searchsorted(seg, seg)
    by_rank = torch.argsort(rank, stable=True)
    sizes = torch.bincount(rank).tolist()
    for pos in torch.split(by_rank, sizes):       # the j-th id of each bag
        out = out.index_add(0, seg.index_select(0, pos),
                            rows.index_select(0, pos))
    return out
