"""Public wrapper for the fused unpack-and-decode op.

``decode(packed, centroids, bits)`` routes through the kernel backend
dispatch layer like every other hot-path op: the CUDA kernel for CUDA
tensors, the plain PyTorch version for CPU tensors, or whichever one is
pinned.  The packed (B, W) uint8 words are what cross the dispatch
boundary — each implementation unpacks them itself, never a call site.
``bits`` is positional, so it is part of the autotune shape bucket:
bits=2 and bits=8 tune apart.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.packed_decode.pack import (PACK_BITS, pack_codes,
                                                    packed_width,
                                                    unpack_codes)
from repro_torch.kernels.packed_decode.packed_decode import (BLOCK_B,
                                                             packed_decode)
from repro_torch.kernels.packed_decode.ref import packed_decode_ref

def packed_decode_cost(packed, cent, bits, block_b=None) -> dispatch.OpCost:
    """packed_decode: the packed codes and the centroids read once, the
    (B, D·S) rows written; no arithmetic."""
    d, _, s = cent.shape
    return dispatch.OpCost(
        0, packed.numel() * packed.element_size()
        + cent.numel() * cent.element_size()
        + packed.shape[0] * d * s * cent.element_size())


dispatch.register_op(
    "packed_decode",
    cuda=lambda packed, cent, bits, block_b=None: packed_decode(
        packed, cent, bits, block_b=block_b),
    torch=lambda packed, cent, bits, block_b=None: packed_decode_ref(
        packed, cent, bits),
    tunables={"block_b": BLOCK_B},
    cost=packed_decode_cost,
)


def decode(packed: torch.Tensor, centroids: torch.Tensor, bits: int,
           block_b: Optional[int] = None,
           backend: Optional[str] = None) -> torch.Tensor:
    """packed (B, W) uint8 -> embeddings (B, D*S) via the dispatched
    fused unpack-and-decode op."""
    return dispatch.dispatch("packed_decode", packed, centroids, bits,
                             block_b=block_b, backend=backend)


__all__ = ["PACK_BITS", "decode", "pack_codes", "packed_decode",
           "packed_decode_ref", "packed_width", "unpack_codes"]
