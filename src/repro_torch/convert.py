"""Carry tables across from numpy: the JAX package's params and
serving artifacts (as numpy arrays) become tensors of the port.

``jax.random`` and ``torch.Generator`` never draw the same numbers, so
a parity check initialises one package, moves the numbers across with
these functions, and runs both packages on identical inputs.  bfloat16
arrays (``ml_dtypes``' numpy type) are carried bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.schemes import get_scheme
from repro_torch.core.schemes.base import torch_dtype, tree_leaves, tree_map
from repro_torch.core.types import EmbeddingConfig


def tensor_from_numpy(a, device) -> torch.Tensor:
    """One numpy array -> a tensor on ``device`` with the same bits."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def params_from_numpy(params: dict, cfg: EmbeddingConfig, device) -> dict:
    """Training params — ``emb`` plus ``centroids`` as one array or a
    per-tier list — as tensors on ``device``.  Every table must already
    be in ``cfg.param_dtype``."""
    out = tree_map(lambda a: tensor_from_numpy(a, device), dict(params))
    want = torch_dtype(cfg.param_dtype)
    bad = [t.dtype for t in tree_leaves(out) if t.dtype != want]
    if bad:
        raise ValueError(f"params hold {bad}, config param_dtype is "
                         f"{cfg.param_dtype}")
    return out


def artifact_from_numpy(artifact: dict, cfg: EmbeddingConfig, device) -> dict:
    """A serving artifact — uint8/int32 codes and the centroids — as
    tensors on ``device``, checked leaf by leaf against the scheme's
    artifact spec."""
    out = tree_map(lambda a: tensor_from_numpy(a, device), dict(artifact))
    got = tree_map(lambda t: (tuple(t.shape), t.dtype), out)
    want = tree_map(lambda t: (tuple(t.shape), t.dtype),
                    get_scheme(cfg).serving_artifact_struct())
    if got != want:
        raise ValueError(f"artifact {got} does not match the spec of "
                         f"{cfg.kind}: {want}")
    return out
