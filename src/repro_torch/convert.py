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
    a = np.array(a, order="C")      # a C-ordered copy, 0-d stays 0-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


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


def deepfm_params_from_numpy(params: dict, model, device) -> dict:
    """The JAX ``DeepFM`` params (numpy leaves) as the port's: every
    field's param tree, checked against that field's config, the 39
    dim-1 ``first_order`` tables, the MLP stack and the bias."""
    return {
        "fields": {f"f{i}": params_from_numpy(params["fields"][f"f{i}"],
                                              e.cfg, device)
                   for i, e in enumerate(model.fields.embs)},
        "first_order": {
            f"f{i}": params_from_numpy(params["first_order"][f"f{i}"],
                                       e.cfg, device)
            for i, e in enumerate(model.first_order)},
        "mlp": mlp_from_numpy(params["mlp"], device),
        "bias": tensor_from_numpy(params["bias"], device),
    }


def autoint_params_from_numpy(params: dict, model, device) -> dict:
    """The JAX ``AutoInt`` params (numpy leaves) as the port's: every
    field's param tree, checked against that field's config, each
    interacting layer's ``wq``/``wk``/``wv``/``wres`` and ``w_out``."""
    return {
        "fields": {f"f{i}": params_from_numpy(params["fields"][f"f{i}"],
                                              e.cfg, device)
                   for i, e in enumerate(model.fields.embs)},
        "layers": [{name: tensor_from_numpy(layer[name], device)
                    for name in ("wq", "wk", "wv", "wres")}
                   for layer in params["layers"]],
        "w_out": mlp_from_numpy([params["w_out"]], device)[0],
    }


def bst_params_from_numpy(params: dict, model, device) -> dict:
    """The JAX ``BST`` params (numpy leaves) as the port's: the item
    table's param tree, checked against its config, ``pos_emb``, each
    block's ``wq``/``wk``/``wv``/``wo``, norms and FFN, and the MLP."""
    def block(p):
        out = {name: tensor_from_numpy(p[name], device)
               for name in ("wq", "wk", "wv", "wo")}
        for ln in ("ln1", "ln2"):
            out[ln] = {k: tensor_from_numpy(p[ln][k], device)
                       for k in ("scale", "bias")}
        out["ffn"] = mlp_from_numpy(p["ffn"], device)
        return out

    return {
        "item_emb": params_from_numpy(params["item_emb"], model.item_emb.cfg,
                                      device),
        "pos_emb": tensor_from_numpy(params["pos_emb"], device),
        "blocks": [block(p) for p in params["blocks"]],
        "mlp": mlp_from_numpy(params["mlp"], device),
    }


def backbone_params_from_numpy(params: dict, model, device) -> dict:
    """The JAX backbone params (GMF, NeuMF or SASRec; numpy leaves) as
    the port's: each embedding table named in ``model.tables`` through
    :func:`params_from_numpy` under its own config, NeuMF's ``mlp``
    through :func:`mlp_from_numpy`, and every other leaf (``w``, the 0-d
    ``b``, ``w_out``, ``pos_emb``, SASRec's ``blocks`` and ``final_ln``)
    carried as it is."""
    if set(params) != set(model.tables + model.dense_keys):
        raise ValueError(f"params hold {sorted(params)}, the model "
                         f"{sorted(model.tables + model.dense_keys)}")
    out = {}
    for name, tree in params.items():
        if name in model.tables:
            out[name] = params_from_numpy(tree, getattr(model, name).cfg,
                                          device)
        elif name == "mlp":
            out[name] = mlp_from_numpy(tree, device)
        else:
            out[name] = tree_map(lambda a: tensor_from_numpy(a, device),
                                 tree)
    return out


def opt_state_from_numpy(opt_state: dict, params: dict, device) -> dict:
    """An optimizer state of the JAX package (numpy leaves: ``step`` and
    the moment trees) as tensors on ``device``; each moment tree must
    mirror ``params`` leaf for leaf, in float32."""
    out = tree_map(lambda a: tensor_from_numpy(a, device), dict(opt_state))
    shapes = [tuple(p.shape) for p in tree_leaves(params)]
    for k, tree in out.items():
        if k == "step":
            if tree.dim() != 0 or tree.dtype != torch.int32:
                raise ValueError(f"step must be a 0-d int32, got "
                                 f"{tuple(tree.shape)} {tree.dtype}")
            continue
        leaves = tree_leaves(tree)
        if ([tuple(t.shape) for t in leaves] != shapes
                or any(t.dtype != torch.float32 for t in leaves)):
            raise ValueError(f"moment tree {k!r} does not mirror the params "
                             f"in float32")
    return out


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


def ivf_pq_artifact_from_numpy(artifact: dict, device,
                               host_staged: bool = False) -> dict:
    """An ``ivf_pq`` artifact — coarse (nlist, d) float32, centroids
    (D, K, S) float32, list_chain (nlist, C) int32, list_codes
    (nlist_ext, cap, D) uint8/int32, list_ids (nlist_ext, cap) int32 —
    as tensors on ``device``; with ``host_staged`` the list tables (the
    index's host leaves) stay on the CPU."""
    host = {"list_chain", "list_codes", "list_ids"} if host_staged else set()
    want = ("coarse", "centroids", "list_chain", "list_codes", "list_ids")
    if set(artifact) != set(want):
        raise ValueError(f"ivf_pq artifact holds {sorted(artifact)}, want "
                         f"{sorted(want)}")
    out = {name: tensor_from_numpy(artifact[name],
                                   "cpu" if name in host else device)
           for name in want}
    coarse, cent = out["coarse"], out["centroids"]
    chain, codes, ids = out["list_chain"], out["list_codes"], out["list_ids"]
    if (coarse.dim() != 2 or coarse.dtype != torch.float32
            or cent.dim() != 3 or cent.dtype != torch.float32
            or coarse.shape[1] != cent.shape[0] * cent.shape[2]
            or chain.dim() != 2 or chain.dtype != torch.int32
            or chain.shape[0] != coarse.shape[0]
            or codes.dim() != 3
            or codes.dtype not in (torch.uint8, torch.int32)
            or codes.shape[2] != cent.shape[0]
            or ids.dtype != torch.int32
            or tuple(ids.shape) != tuple(codes.shape[:2])
            or codes.shape[0] < coarse.shape[0]):
        raise ValueError(
            "want coarse (nlist, D*S) float32, centroids (D, K, S) "
            "float32, list_chain (nlist, C) int32, list_codes (nlist_ext, "
            "cap, D) uint8/int32 and list_ids (nlist_ext, cap) int32, got "
            + ", ".join(f"{name} {tuple(t.shape)} {t.dtype}"
                        for name, t in out.items()))
    return out


def lm_params_from_numpy(params: dict, cfg, device) -> dict:
    """The JAX LM params (numpy leaves) as the port's, leaf for leaf:
    the token embedding through :func:`params_from_numpy`, every other
    leaf — the stacked layers (``layers``, or ``loc``/``glob``/``rem``),
    ``final_norm`` and ``lm_head`` — checked against the model's
    :func:`~repro_torch.models.lm.param_spec` and ``cfg.param_dtype``."""
    from repro_torch.models.lm import param_spec
    spec = param_spec(cfg)
    if set(params) != set(spec) | {"embed"}:
        raise ValueError(f"params hold {sorted(params)}, the model "
                         f"{sorted(set(spec) | {'embed'})}")
    want = torch_dtype(cfg.param_dtype)

    def convert(tree, spec_tree, path):
        if isinstance(spec_tree, dict):
            if set(tree) != set(spec_tree):
                raise ValueError(f"{path}: leaves {sorted(tree)}, want "
                                 f"{sorted(spec_tree)}")
            return {k: convert(tree[k], spec_tree[k], f"{path}.{k}")
                    for k in spec_tree}
        t = tensor_from_numpy(tree, device)
        if tuple(t.shape) != spec_tree[0] or t.dtype != want:
            raise ValueError(f"{path}: {tuple(t.shape)} {t.dtype}, want "
                             f"{spec_tree[0]} {want}")
        return t

    out = {"embed": params_from_numpy(params["embed"], cfg.embedding,
                                      device)}
    out.update({k: convert(params[k], spec[k], k) for k in spec})
    return out
