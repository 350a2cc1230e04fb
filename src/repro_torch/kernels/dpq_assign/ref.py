"""Plain PyTorch version of nearest-centroid code assignment (DPQ encode).

Mirrors ``repro_torch.core.dpq.assign_codes``: squared-L2 argmin per
subspace with an optional per-item centroid budget ``k_limit`` (the
MGQE shared-variable-K mask).

``dpq_assign_blocked_ref`` is the op's plain serving form: the flat
version materializes the whole (B, D, K) f32 distance tensor, so
blocking over B keeps each (block_b, D, K) slab small.  Rows are
independent, so the blocked form is bit-identical to the flat one;
``block_b`` is the op's autotuned knob on both backends.
"""
from __future__ import annotations

from typing import Optional

import torch


def dpq_assign_ref(e_sub: torch.Tensor, centroids: torch.Tensor,
                   k_limit: Optional[torch.Tensor] = None) -> torch.Tensor:
    """e_sub (B, D, S); centroids (D, K, S); k_limit (B,) -> codes (B, D)
    int32.  Ties go to the first index (torch.argmin's contract)."""
    dots = torch.einsum("bds,dks->bdk", e_sub, centroids)
    c_sq = torch.sum(torch.square(centroids), dim=-1)        # (D, K)
    dist = c_sq[None] - 2.0 * dots                            # (B, D, K)
    if k_limit is not None:
        k = dist.shape[-1]
        slot = torch.arange(k, dtype=torch.int32, device=dist.device)
        mask = slot[None, None, :] >= k_limit[:, None, None]
        dist = dist.masked_fill(mask, float("inf"))
    return torch.argmin(dist, dim=-1).to(torch.int32)


def dpq_assign_blocked_ref(e_sub: torch.Tensor, centroids: torch.Tensor,
                           k_limit: Optional[torch.Tensor] = None,
                           block_b: Optional[int] = None) -> torch.Tensor:
    """Bit-identical to :func:`dpq_assign_ref`, computed over row blocks
    of ``block_b`` (None or >= B: one flat block)."""
    b = e_sub.shape[0]
    if not block_b or block_b >= b:
        return dpq_assign_ref(e_sub, centroids, k_limit)
    outs = [dpq_assign_ref(
        e_sub[i:i + block_b], centroids,
        None if k_limit is None else k_limit[i:i + block_b])
        for i in range(0, b, block_b)]
    return torch.cat(outs, dim=0)
