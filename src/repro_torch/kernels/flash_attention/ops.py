"""Public wrapper: blocked causal/windowed GQA attention.

``attend`` routes through the kernel backend dispatch layer: the CUDA
kernel for CUDA tensors, the plain version for CPU tensors, or
whichever one is pinned.  The plain version is differentiable; the
kernel refuses inputs that require grad (the JAX package's backward,
a recompute through the reference, comes with LM training).
``block_k`` left as None resolves through the autotune cache; the
plain version has no tiles and ignores it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention.flash_attention import (
    BLOCK_K, flash_attention)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

dispatch.register_op(
    "flash_attention",
    cuda=lambda q, k, v, window=1 << 30, block_k=None: flash_attention(
        q, k, v, window=window, block_k=block_k),
    torch=lambda q, k, v, window=1 << 30, block_k=None: flash_attention_ref(
        q, k, v, window=window),
    tunables={"block_k": BLOCK_K},
)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int = 1 << 30, block_k: Optional[int] = None,
           backend: Optional[str] = None) -> torch.Tensor:
    """Blocked causal/windowed GQA attention (train/prefill layout)."""
    return dispatch.dispatch("flash_attention", q, k, v, window=window,
                             block_k=block_k, backend=backend)


__all__ = ["attend", "flash_attention", "flash_attention_ref"]
