"""Dense FFN blocks: GeGLU/SwiGLU (LM) and plain MLP stacks (recsys)."""
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


def glu_ffn_init(gen: torch.Generator, d_model: int, d_ff: int,
                 dtype=torch.float32) -> dict:
    s_in, s_ff = d_model ** -0.5, d_ff ** -0.5
    return {
        "w_gate": init.normal(gen, (d_model, d_ff), s_in, dtype),
        "w_up": init.normal(gen, (d_model, d_ff), s_in, dtype),
        "w_down": init.normal(gen, (d_ff, d_model), s_ff, dtype),
    }


def glu_ffn(params: dict, x: torch.Tensor, act: str = "gelu") -> torch.Tensor:
    fn = _ACTS[act]
    gate = fn(x @ params["w_gate"].to(x.dtype))
    up = x @ params["w_up"].to(x.dtype)
    return (gate * up) @ params["w_down"].to(x.dtype)


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
