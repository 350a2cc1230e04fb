"""Weight initializers and the dense layer (parameters as plain dicts,
``{"w": (d_in, d_out), "b": (d_out,)}``, the JAX package's layout)."""
from __future__ import annotations

import torch


def normal(gen: torch.Generator, shape, stddev: float,
           dtype=torch.float32) -> torch.Tensor:
    """N(0, stddev^2) on the generator's device, scaled in place."""
    x = torch.randn(tuple(shape), generator=gen, dtype=dtype,
                    device=gen.device)
    return x.mul_(stddev)


def lecun_normal(gen: torch.Generator, shape, fan_in: int,
                 dtype=torch.float32) -> torch.Tensor:
    return normal(gen, shape, fan_in ** -0.5, dtype=dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = True, dtype=torch.float32) -> dict:
    p = {"w": lecun_normal(gen, (d_in, d_out), d_in, dtype=dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ params["w"].to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    return y
