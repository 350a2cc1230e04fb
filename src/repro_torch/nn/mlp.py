"""Plain MLP stacks (the recsys towers).  The GLU FFN of the LM family
waits for the LM slice in ROADMAP.md."""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.nn import initializers as init

_ACTS = {
    "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
    "silu": torch.nn.functional.silu,
    "relu": torch.relu,
    "tanh": torch.tanh,
}


def mlp_init(gen: torch.Generator, dims: Sequence[int], *, bias: bool = True,
             dtype=torch.float32) -> list:
    """dims = (in, h1, ..., out) -> a list of dense layers."""
    return [init.dense_init(gen, dims[i], dims[i + 1], bias=bias,
                            dtype=dtype)
            for i in range(len(dims) - 1)]


def mlp(params: list, x: torch.Tensor, act: str = "relu",
        final_act: bool = False) -> torch.Tensor:
    for i, layer in enumerate(params):
        x = init.dense(layer, x)
        if i < len(params) - 1 or final_act:
            x = _ACTS[act](x)
    return x
