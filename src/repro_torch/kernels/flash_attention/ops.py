"""Public wrapper: blocked causal/windowed GQA attention with a
recompute-based backward.

``attend``'s forward routes through the kernel backend dispatch layer:
the CUDA kernel for CUDA tensors, the plain version for CPU tensors, or
whichever one is pinned.  Its backward is the JAX package's
``custom_vjp`` (``src/repro/kernels/flash_attention/ops.py``): it
recomputes attention through the plain version under autograd and
returns that vjp.  The recompute's (B, H, Sq, Skv) float32 scores are
the largest tensors of a training step (4.3 GB at 2 x 4,096 with 32
heads), so the backward takes the KV heads a group at a time, each
group with its g query heads; the groups are independent, so this is
the same function, and one group when the scores fit
``RECOMPUTE_BYTES``.  ``block_k`` left as None resolves through the
autotune cache; the plain version has no tiles and ignores it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention.flash_attention import (
    BLOCK_K, flash_attention)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

def visible_pairs(s: int, window: int) -> int:
    """(query, key) pairs a causal window lets through over S tokens."""
    w = min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def attention_cost(q, k, v, window=1 << 30, block_k=None) -> dispatch.OpCost:
    """flash_attention: 4·hd FLOPs (QKᵀ and PV) for every visible (query,
    key) pair of every head, in q's dtype; q, k and v read once and the
    output (q's shape) written."""
    b, s, h, hd = q.shape
    pairs = visible_pairs(s, int(window)) * b * h
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    return dispatch.OpCost(4 * hd * pairs, nbytes, dispatch.dtype_name(q))


dispatch.register_op(
    "flash_attention",
    cuda=lambda q, k, v, window=1 << 30, block_k=None: flash_attention(
        q, k, v, window=window, block_k=block_k),
    torch=lambda q, k, v, window=1 << 30, block_k=None: flash_attention_ref(
        q, k, v, window=window),
    tunables={"block_k": BLOCK_K},
    cost=attention_cost,
)

# float32 score bytes the backward's recompute may hold for one group
# of KV heads (its autograd keeps about four tensors of that size)
RECOMPUTE_BYTES = 1 << 30


def recompute_groups(b: int, sq: int, skv: int, h: int, hkv: int) -> int:
    """KV heads the backward recomputes at a time: the most that divide
    ``hkv`` and keep a group's (B, g·heads, Sq, Skv) float32 scores
    within ``RECOMPUTE_BYTES`` (at least one)."""
    per_kv_head = b * (h // hkv) * sq * skv * 4
    for n in range(hkv, 0, -1):
        if hkv % n == 0 and n * per_kv_head <= RECOMPUTE_BYTES:
            return n
    return 1


def attention_vjp(q, k, v, window: int, grad_out):
    """(dq, dk, dv) of the plain version at (q, k, v) for ``grad_out``,
    recomputed a group of KV heads at a time (``recompute_groups``)."""
    b, sq, h, _ = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    n = recompute_groups(b, sq, skv, h, hkv)
    grads = [torch.empty_like(t) for t in (q, k, v)]
    for lo in range(0, hkv, n):
        qs, kvs = slice(lo * g, (lo + n) * g), slice(lo, lo + n)
        with torch.enable_grad():
            qkv = [t[:, :, s].detach().requires_grad_(True)
                   for t, s in ((q, qs), (k, kvs), (v, kvs))]
            out = flash_attention_ref(*qkv, window=window)
            parts = torch.autograd.grad(out, qkv, grad_out[:, :, qs])
        for dst, s, part in zip(grads, (qs, kvs, kvs), parts):
            dst[:, :, s] = part
    return tuple(grads)


class _Attend(torch.autograd.Function):
    """The dispatched op forward, the plain version's vjp backward."""

    @staticmethod
    def forward(ctx, q, k, v, window, block_k, backend):
        ctx.window = window
        ctx.save_for_backward(q, k, v)
        return dispatch.dispatch("flash_attention", q, k, v, window=window,
                                 block_k=block_k, backend=backend)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = attention_vjp(q, k, v, ctx.window, grad_out)
        return dq, dk, dv, None, None, None


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int = 1 << 30, block_k: Optional[int] = None,
           backend: Optional[str] = None) -> torch.Tensor:
    """Blocked causal/windowed GQA attention (train/prefill layout),
    differentiable in q, k and v on every route."""
    return _Attend.apply(q, k, v, window, block_k, backend)


__all__ = ["RECOMPUTE_BYTES", "attend", "attention_cost", "attention_vjp",
           "flash_attention", "flash_attention_ref", "recompute_groups",
           "visible_pairs"]
