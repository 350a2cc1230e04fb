"""Rotary position embeddings with a per-layer base frequency.

Gemma-3 interleaves local layers (theta=10k) with global layers
(theta=1M); theta is a plain scalar argument, so one layer function
serves both kinds.
"""
from __future__ import annotations

import torch

from repro_torch.core.api import resolve_device


def rope_freqs(head_dim: int, theta, device="cuda") -> torch.Tensor:
    """(head_dim/2,) inverse frequencies in fp32, on the card unless the
    caller passes ``device="cpu"`` (with no card the default raises)."""
    device = resolve_device(device)
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    # filled on the device: a host scalar moved there would be a copy
    theta = torch.full((), float(theta), dtype=torch.float32, device=device)
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta) -> torch.Tensor:
    """Rotate x (..., seq, heads, head_dim) at integer positions (seq,)
    or (..., seq).  fp32 math, cast back to x.dtype."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)   # (half,)
    angles = positions.float()[..., None] * freqs   # (..., seq, half)
    cos = torch.cos(angles)[..., None, :]           # (..., seq, 1, half)
    sin = torch.sin(angles)[..., None, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
