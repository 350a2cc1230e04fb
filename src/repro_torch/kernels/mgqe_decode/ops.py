"""Public wrapper for the MGQE decode op.

``decode(codes, centroids)`` routes through the kernel backend dispatch
layer (``repro_torch.kernels.dispatch``): the CUDA kernel for CUDA
tensors, the plain PyTorch version for CPU tensors, or whichever one
is pinned — so call sites never branch on backend.  Codes keep their
stored dtype (uint8) up to the op; each implementation widens them
itself.  ``block_b`` left as None resolves through the autotune cache.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.mgqe_decode.mgqe_decode import BLOCK_B, mgqe_decode
from repro_torch.kernels.mgqe_decode.ref import mgqe_decode_ref

dispatch.register_op(
    "mgqe_decode",
    cuda=lambda codes, cent, block_b=None: mgqe_decode(
        codes, cent, block_b=block_b),
    torch=lambda codes, cent, block_b=None: mgqe_decode_ref(codes, cent),
    tunables={"block_b": BLOCK_B},
)


def decode(codes: torch.Tensor, centroids: torch.Tensor,
           block_b: Optional[int] = None,
           backend: Optional[str] = None) -> torch.Tensor:
    """codes (B, D) -> embeddings (B, D*S) via the dispatched op."""
    return dispatch.dispatch("mgqe_decode", codes, centroids,
                             block_b=block_b, backend=backend)


__all__ = ["decode", "mgqe_decode", "mgqe_decode_ref"]
