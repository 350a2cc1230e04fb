"""Plain PyTorch versions of the MGQE/DPQ and RQ serving decodes.

``mgqe_decode_ref``: given per-item codes (B, D) and per-subspace
centroid tables (D, K, S), reconstruct embeddings (B, D*S) by gathering
centroid ``codes[b, d]`` in each subspace d and concatenating.

``rq_decode_stages_ref``: given codes (B, M) and M stacked full-width
codebooks (M, K, d), sum the M gathered rows.

The CPU paths of the ops, and what the CUDA kernels are held against on
the card.
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


def rq_decode_stages_ref(codes: torch.Tensor,
                         codebooks: torch.Tensor) -> torch.Tensor:
    """codes (B, M) uint8/int32; stacked codebooks (M, K, d) -> (B, d)
    in the codebook dtype: ``sum_m codebooks[m, codes[:, m]]``.

    Summed as the JAX reference sums: stage 0's row, then stages
    1..M-1 added one at a time (each add rounded to the codebook dtype).
    Codes outside [0, K) are clamped, as the kernel clamps them (codes
    from an export always lie in range).  Widened here, inside the op."""
    m, k, _ = codebooks.shape
    idx = codes.long().clamp(0, k - 1)                         # (B, M)
    out = codebooks[0].index_select(0, idx[:, 0])
    for i in range(1, m):
        out = out + codebooks[i].index_select(0, idx[:, i])
    return out
