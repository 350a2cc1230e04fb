"""Public wrappers for the MGQE and RQ decode ops.

``decode(codes, centroids)`` routes through the kernel backend dispatch
layer (``repro_torch.kernels.dispatch``): the CUDA kernel for CUDA
tensors, the plain PyTorch version for CPU tensors, or whichever one
is pinned — so call sites never branch on backend.  Codes keep their
stored dtype (uint8) up to the op; each implementation widens them
itself.  ``block_b`` left as None resolves through the autotune cache.

``decode_stages(codes, codebooks)`` is the residual-quantization form:
codes (B, M) against stacked full-width codebooks (M, K, d), the M-stage
sum done in one kernel pass over whole output rows.  Its one tunable,
``block_b``, is the threads per block, as for ``decode``; the TPU
kernel's ``block_d`` output-column tile has no counterpart.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.mgqe_decode.mgqe_decode import (BLOCK_B,
                                                         RQ_BLOCK_B,
                                                         mgqe_decode,
                                                         rq_decode_stages)
from repro_torch.kernels.mgqe_decode.ref import (mgqe_decode_ref,
                                                 rq_decode_stages_ref)

def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def decode_cost(codes, cent, block_b=None) -> dispatch.OpCost:
    """mgqe_decode: the codes and the centroids read once, the (B, D·S)
    rows written; no arithmetic."""
    b, d = codes.shape
    return dispatch.OpCost(0, _bytes(codes) + _bytes(cent)
                           + b * d * cent.shape[-1] * cent.element_size())


def decode_stages_cost(codes, cbs, block_b=None) -> dispatch.OpCost:
    """rq_decode_stages: the codes and codebooks read once, the (B, d)
    rows written; (M - 1)·d float32 adds a row."""
    b, m = codes.shape
    d = cbs.shape[-1]
    return dispatch.OpCost(b * (m - 1) * d, _bytes(codes) + _bytes(cbs)
                           + b * d * cbs.element_size())


dispatch.register_op(
    "mgqe_decode",
    cuda=lambda codes, cent, block_b=None: mgqe_decode(
        codes, cent, block_b=block_b),
    torch=lambda codes, cent, block_b=None: mgqe_decode_ref(codes, cent),
    tunables={"block_b": BLOCK_B},
    cost=decode_cost,
)

dispatch.register_op(
    "rq_decode_stages",
    cuda=lambda codes, cbs, block_b=None: rq_decode_stages(
        codes, cbs, block_b=block_b),
    torch=lambda codes, cbs, block_b=None: rq_decode_stages_ref(codes, cbs),
    tunables={"block_b": RQ_BLOCK_B},
    cost=decode_stages_cost,
)


def decode(codes: torch.Tensor, centroids: torch.Tensor,
           block_b: Optional[int] = None,
           backend: Optional[str] = None) -> torch.Tensor:
    """codes (B, D) -> embeddings (B, D*S) via the dispatched op."""
    return dispatch.dispatch("mgqe_decode", codes, centroids,
                             block_b=block_b, backend=backend)


def decode_stages(codes: torch.Tensor, codebooks: torch.Tensor,
                  block_b: Optional[int] = None,
                  backend: Optional[str] = None) -> torch.Tensor:
    """codes (B, M) + stacked codebooks (M, K, d) -> (B, d) via the
    dispatched single-pass residual-stage decode."""
    return dispatch.dispatch("rq_decode_stages", codes, codebooks,
                             block_b=block_b, backend=backend)


__all__ = ["decode", "decode_stages", "mgqe_decode", "mgqe_decode_ref",
           "rq_decode_stages", "rq_decode_stages_ref"]
