"""Normalization layers (statistics always computed in fp32).

The init functions put their parameters on the card unless the caller
passes ``device="cpu"``; with no card the default raises
(``core.api.resolve_device``)."""
from __future__ import annotations

import torch

from repro_torch.core.api import resolve_device


def rms_norm_init(dim: int, dtype=torch.float32, device="cuda") -> dict:
    # scale stored as a zero-centered offset: effective gain = 1 + scale
    return {"scale": torch.zeros((dim,), dtype=dtype,
                                 device=resolve_device(device))}


def rms_norm(params: dict, x: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """The mean square accumulates in fp32; the (B, S, d) product
    ``x * inv * gain`` stays in x's dtype, as the JAX package keeps it."""
    xf = x.float()
    var = torch.sum(xf * xf, dim=-1) / x.shape[-1]
    inv = ((var + eps) ** -0.5)[..., None].to(x.dtype)
    gain = 1.0 + params["scale"].to(x.dtype)
    return x * inv * gain


def layer_norm_init(dim: int, dtype=torch.float32, device="cuda") -> dict:
    device = resolve_device(device)
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layer_norm(params: dict, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * (var + eps) ** -0.5
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)
