"""Plain PyTorch version of the MGQE/DPQ serving decode.

Given per-item codes (B, D) and per-subspace centroid tables (D, K, S),
reconstruct embeddings (B, D*S) by gathering centroid ``codes[b, d]``
in each subspace d and concatenating.  The CPU path of the op, and what
the CUDA kernel is held against on the card.
"""
from __future__ import annotations

import torch


def mgqe_decode_ref(codes: torch.Tensor,
                    centroids: torch.Tensor) -> torch.Tensor:
    """codes (B, D) uint8/int32; centroids (D, K, S) -> (B, D*S) in the
    centroid dtype.  Codes outside [0, K) are clamped, the reference's
    ``mode="clip"`` gather: under mgqe private_k, ids of OTHER tiers
    carry codes >= this tier's K (masked downstream by the tier
    select).  Codes are widened here, inside the op — a uint8 tensor
    used as an index is a boolean mask in torch."""
    b, d = codes.shape
    _, k, s = centroids.shape
    idx = codes.long().clamp(0, k - 1)                       # (B, D)
    sub = torch.arange(d, device=codes.device)[None, :]       # (1, D)
    return centroids[sub, idx].reshape(b, d * s)              # (B, D, S)
