"""Plain PyTorch version of the fused unpack-and-decode.

Unpack the (B, W) packed words to (B, D) codes, then the same
per-subspace centroid gather as ``mgqe_decode_ref``.  The CPU path of
the op, and what the CUDA kernel is held against on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.packed_decode.pack import PACK_BITS, unpack_codes


def check_table(centroids: torch.Tensor, bits: int) -> None:
    """Raise unless ``bits`` is packable and every code of that width
    addresses a centroid (K >= 2**bits)."""
    if bits not in PACK_BITS:
        raise ValueError(f"bits must be one of {PACK_BITS}, got {bits}")
    if centroids.dim() != 3 or centroids.shape[1] < 2 ** bits:
        raise ValueError(f"centroids must be (D, K, S) with K >= 2**bits "
                         f"= {2 ** bits}, got {tuple(centroids.shape)}")


def packed_decode_ref(packed: torch.Tensor, centroids: torch.Tensor,
                      bits: int) -> torch.Tensor:
    """packed (B, W) uint8; centroids (D, K, S) -> (B, D*S) in the
    centroid dtype.  The unpacked codes are widened here, inside the op
    (a uint8 tensor used as an index is a boolean mask in torch)."""
    check_table(centroids, bits)
    b = packed.shape[0]
    d, _, s = centroids.shape
    codes = unpack_codes(packed, bits, d).long()              # (B, D)
    sub = torch.arange(d, device=packed.device)[None, :]      # (1, D)
    return centroids[sub, codes].reshape(b, d * s)            # (B, D, S)
