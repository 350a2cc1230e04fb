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
    """Training params of any scheme — a dict of arrays and per-tier
    lists of arrays (``emb`` and ``centroids``, ``codebooks``, ``u`` and
    ``v``) — as tensors on ``device``.  Every table must already be in
    ``cfg.param_dtype``."""
    out = tree_map(lambda a: tensor_from_numpy(a, device), dict(params))
    want = torch_dtype(cfg.param_dtype)
    bad = [t.dtype for t in tree_leaves(out) if t.dtype != want]
    if bad:
        raise ValueError(f"params hold {bad}, config param_dtype is "
                         f"{cfg.param_dtype}")
    return out


def artifact_from_numpy(artifact: dict, cfg: EmbeddingConfig, device) -> dict:
    """A serving artifact of any scheme — codes (per-tier lists of
    packed words, for ``mpe``), codebooks, dense tables — as tensors on
    ``device``, checked leaf by leaf against the scheme's artifact
    spec."""
    out = tree_map(lambda a: tensor_from_numpy(a, device), dict(artifact))
    got = tree_map(lambda t: (tuple(t.shape), t.dtype), out)
    want = tree_map(lambda t: (tuple(t.shape), t.dtype),
                    get_scheme(cfg).serving_artifact_struct())
    if got != want:
        raise ValueError(f"artifact {got} does not match the spec of "
                         f"{cfg.kind}: {want}")
    return out


def mlp_from_numpy(layers, device) -> list:
    """An MLP stack — a list of ``{w, b}`` dicts — as tensors."""
    return [{name: tensor_from_numpy(a, device) for name, a in layer.items()}
            for layer in layers]


def two_tower_params_from_numpy(params: dict, model, device) -> dict:
    """The JAX ``TwoTower`` params (numpy leaves) as the port's: both
    embedding param trees, checked against the model's configs, and both
    MLP stacks."""
    return {
        "user_emb": params_from_numpy(params["user_emb"], model.user_emb.cfg,
                                      device),
        "item_emb": params_from_numpy(params["item_emb"], model.item_emb.cfg,
                                      device),
        "user_mlp": mlp_from_numpy(params["user_mlp"], device),
        "item_mlp": mlp_from_numpy(params["item_mlp"], device),
    }


def flat_pq_artifact_from_numpy(artifact: dict, device) -> dict:
    """A ``flat_pq`` artifact — codes (N, D) uint8/int32 and centroids
    (D, K, S) float32 — as tensors on ``device``."""
    codes = tensor_from_numpy(artifact["codes"], device)
    cent = tensor_from_numpy(artifact["centroids"], device)
    if (codes.dim() != 2 or codes.dtype not in (torch.uint8, torch.int32)
            or cent.dim() != 3 or cent.dtype != torch.float32
            or codes.shape[1] != cent.shape[0]):
        raise ValueError(f"want codes (N, D) uint8/int32 and centroids "
                         f"(D, K, S) float32, got {tuple(codes.shape)} "
                         f"{codes.dtype} and {tuple(cent.shape)} "
                         f"{cent.dtype}")
    return {"codes": codes, "centroids": cent}
