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

def assign_cost(e_sub, cent, k_limit=None, block_b=None) -> dispatch.OpCost:
    """dpq_assign: 2·S FLOPs for every centroid a row's budget reaches
    (``k_limit``'s values, all K of them without one or on the meta
    device, where they cannot be read), in the rows' dtype; the rows,
    the centroids and the budgets read once, the (B, D) int32 codes
    written."""
    n, d, s = e_sub.shape
    k = cent.shape[1]
    item = e_sub.element_size()
    if k_limit is None or k_limit.device.type == "meta":
        evaluated = d * n * k
    else:
        evaluated = d * int(k_limit.clamp(min=0, max=k).long().sum())
    nbytes = (n * d * s * item + d * k * s * item + n * d * 4
              + (0 if k_limit is None else n * 4))
    return dispatch.OpCost(2 * s * evaluated, nbytes,
                           dispatch.dtype_name(e_sub))


dispatch.register_op(
    "dpq_assign",
    cuda=lambda e_sub, cent, k_limit=None, block_b=None: dpq_assign(
        e_sub, cent, k_limit),
    torch=lambda e_sub, cent, k_limit=None, block_b=None:
        dpq_assign_blocked_ref(e_sub, cent, k_limit, block_b=block_b),
    tunables={"block_b": BLOCK_B},
    cost=assign_cost,
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
