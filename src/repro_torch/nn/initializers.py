"""Weight initializers and the dense layer (parameters as plain dicts,
``{"w": (d_in, d_out), "b": (d_out,)}``, the JAX package's layout)."""
from __future__ import annotations

import torch


class _MetaGenerator(torch.Generator):
    """A CPU generator whose ``device`` reads meta: an init that draws with
    ``generator=gen, device=gen.device`` then makes meta tensors of its
    shapes and draws nothing (``torch.Generator`` cannot be made on
    meta)."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def generator(device, seed: int = 0) -> torch.Generator:
    """A generator seeded ``seed`` on ``device``; on the meta device, one
    whose draws are shapes alone (``_MetaGenerator``)."""
    device = torch.device(device)
    if device.type == "meta":
        return _MetaGenerator().manual_seed(seed)
    return torch.Generator(device=device).manual_seed(seed)


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
