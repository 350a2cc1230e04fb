"""Plain PyTorch version of blocked causal/windowed GQA attention.

A copy of the JAX package's ``kernels/flash_attention/ref.py``
oracle: one dense softmax over positional masking, key visible iff
``0 <= qpos - kpos < window``.  The op's CPU path, and the yardstick
the CUDA kernel is held against on the card.
"""
from __future__ import annotations

import torch

_NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        window: int = 1 << 30) -> torch.Tensor:
    """q (B, Sq, H, hd); k, v (B, Skv, Hkv, hd); H = Hkv * g.

    Causal: query i attends keys j with 0 <= i - j < window (positions
    are the indices — the oracle assumes q and k start at position 0).
    """
    b, sq, h, hd = q.shape
    _, skv, hkv, _ = k.shape
    g = h // hkv
    qg = q.reshape(b, sq, hkv, g, hd)
    scale = hd ** -0.5
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() * scale
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    delta = qpos - kpos
    mask = (delta >= 0) & (delta < window)
    scores = scores.masked_fill(~mask, _NEG_INF)
    probs = torch.exp(scores - torch.amax(scores, dim=-1, keepdim=True))
    probs = probs / torch.sum(probs, dim=-1, keepdim=True)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(q.shape)
