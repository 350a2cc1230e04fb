"""Public wrapper for the DPQ nearest-centroid assignment op.

``assign`` routes through the kernel backend dispatch layer: the CUDA
kernel for CUDA tensors, the blocked plain version for CPU tensors, or
whichever one is pinned.  The op's one tunable, ``block_b``, is the
plain version's row block (None resolves through the autotune cache);
the kernel chooses its own tiles (``dpq_assign.choose_tiles``), which
a caller pins on the kernel wrapper itself.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.dpq_assign.dpq_assign import dpq_assign
from repro_torch.kernels.dpq_assign.ref import (dpq_assign_blocked_ref,
                                                dpq_assign_ref)

# rows a block of the plain version (bit-identical at every value)
BLOCK_B = dispatch.Tunable(256, (64, 128, 256, 512, 1024))

dispatch.register_op(
    "dpq_assign",
    cuda=lambda e_sub, cent, k_limit=None, block_b=None: dpq_assign(
        e_sub, cent, k_limit),
    torch=lambda e_sub, cent, k_limit=None, block_b=None:
        dpq_assign_blocked_ref(e_sub, cent, k_limit, block_b=block_b),
    tunables={"block_b": BLOCK_B},
)


def assign(e_sub: torch.Tensor, centroids: torch.Tensor,
           k_limit: Optional[torch.Tensor] = None,
           block_b: Optional[int] = None,
           backend: Optional[str] = None) -> torch.Tensor:
    """Nearest-centroid codes (B, D) int32 for subvectors (B, D, S)."""
    return dispatch.dispatch("dpq_assign", e_sub, centroids, k_limit,
                             block_b=block_b, backend=backend)


__all__ = ["assign", "dpq_assign", "dpq_assign_blocked_ref",
           "dpq_assign_ref"]
