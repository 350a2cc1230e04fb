"""Plain PyTorch version of nearest-centroid code assignment (DPQ encode).

Mirrors ``repro_torch.core.dpq.assign_codes``: squared-L2 argmin per
subspace with an optional per-item centroid budget ``k_limit`` (the
MGQE shared-variable-K mask).

It computes what the TPU kernel (``src/repro/kernels/dpq_assign/
dpq_assign.py::dpq_assign``) computes for every input dtype: the dots
accumulate in float32 (``preferred_element_type``) and ``||c||^2`` is
taken from the values cast to float32.  bfloat16 inputs are
therefore cast to float32 first; a bfloat16 product is exact in
float32, so this is the kernel's function, not an approximation of it.
(JAX's own ``xla`` route in bfloat16 rounds the dots to bfloat16 and
differs from its Pallas kernel near ties.)

``dpq_assign_blocked_ref`` is the op's plain serving form: the flat
version materializes the whole (B, D, K) f32 distance tensor, so
blocking over B keeps each (block_b, D, K) slab small.  Rows are
independent, so the blocked form is bit-identical to the flat one;
``block_b`` is the op's autotuned knob (the CUDA kernel chooses its own
tiles).
"""
from __future__ import annotations

from typing import Optional

import torch


def _in_f32(x: torch.Tensor) -> torch.Tensor:
    """bfloat16 cast to float32, the TPU kernel's accumulation type."""
    return x.float() if x.dtype == torch.bfloat16 else x


def dpq_assign_ref(e_sub: torch.Tensor, centroids: torch.Tensor,
                   k_limit: Optional[torch.Tensor] = None) -> torch.Tensor:
    """e_sub (B, D, S); centroids (D, K, S); k_limit (B,) -> codes (B, D)
    int32.  Ties go to the first index (torch.argmin's contract)."""
    e_sub, centroids = _in_f32(e_sub), _in_f32(centroids)
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
