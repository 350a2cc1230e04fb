"""Multi-Granular Quantized Embeddings (paper §2).

Three variants, all built on dpq.py:

* ``shared_k``  (paper default): one codebook (D, K); items in tier i may
  only use the first K_i centroids.  Implemented as a *masked single
  pass* — per-item ``k_limit = K_tier(id)`` fed to the assignment —
  instead of the paper's dynamic group-split loop (Algorithm 1).

* ``private_k``: tier i owns a private codebook with K_i centroids.
  Static python loop over tiers.

* ``private_d``: tier i owns a private codebook with D_i subspaces of
  dim d/D_i (K fixed).  Static python loop over tiers.

Tier membership is pure arithmetic over frequency-sorted ids
(partition.tier_of_ids) — no membership table.  Ported: init, the
training-path lookup (``lookup_train``, on one device or under a mesh)
and export.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import dpq
from repro_torch.core.partition import tier_of_ids
from repro_torch.core.types import EmbeddingConfig


def _code_dtype(cfg: EmbeddingConfig) -> torch.dtype:
    return torch.uint8 if cfg.num_centroids <= 256 else torch.int32


def _tier_k_limits(cfg: EmbeddingConfig, ids: torch.Tensor) -> torch.Tensor:
    """Per-item centroid budget K_{tier(id)} (int32, same shape as ids)."""
    tiers = tier_of_ids(ids, cfg.tier_boundaries)
    ks = torch.tensor(cfg.tier_num_centroids, dtype=torch.int32,
                      device=ids.device)
    return ks.index_select(0, tiers.reshape(-1)).reshape(tiers.shape)


def k_limit_for_all_rows(cfg: EmbeddingConfig, device) -> torch.Tensor:
    """(n,) per-row K budget on ``device`` — used at code-export time."""
    rows = torch.arange(cfg.vocab_size, dtype=torch.int32, device=device)
    return _tier_k_limits(cfg, rows)


# ----------------------------------------------------------------------
# init
# ----------------------------------------------------------------------

def init(gen: torch.Generator, cfg: EmbeddingConfig,
         dtype=torch.float32) -> dict:
    if cfg.mgqe_variant == "shared_k":
        return dpq.init(gen, cfg.vocab_size, cfg.dim, cfg.num_subspaces,
                        cfg.num_centroids, dtype=dtype)
    params = {"emb": dpq.init_full_table(gen, cfg.vocab_size, cfg.dim,
                                         dtype=dtype)}
    if cfg.mgqe_variant == "private_k":
        # every tier codebook at its own K_i (static shapes per tier)
        params["centroids"] = [
            dpq.init_centroids(gen, cfg.num_subspaces,
                               cfg.tier_num_centroids[i],
                               cfg.subspace_dim, scale=cfg.dim ** -0.5,
                               dtype=dtype)
            for i in range(cfg.num_tiers)]
    else:  # private_d
        params["centroids"] = [
            dpq.init_centroids(gen, cfg.tier_num_subspaces[i],
                               cfg.num_centroids,
                               cfg.dim // cfg.tier_num_subspaces[i],
                               scale=cfg.dim ** -0.5, dtype=dtype)
            for i in range(cfg.num_tiers)]
    return params


# ----------------------------------------------------------------------
# training lookup
# ----------------------------------------------------------------------

def lookup_train(params: dict, ids: torch.Tensor, cfg: EmbeddingConfig,
                 mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (embeddings (..., d), aux_loss scalar).  Under a ``mesh``
    the ids are this rank's data shard of the global ids, and the tier
    budgets key on them, never on rows of the rank's block."""
    if cfg.mgqe_variant == "shared_k":
        k_limit = _tier_k_limits(cfg, ids)
        return dpq.lookup_train(params, ids, k_limit=k_limit, beta=cfg.beta,
                                mesh=mesh, rows=cfg.vocab_size)

    # private variants: static loop over tiers, blend with masks
    e = dpq.row_gather(params["emb"], ids, mesh=mesh, rows=cfg.vocab_size)
    tiers = tier_of_ids(ids, cfg.tier_boundaries)       # (...,)
    out = torch.zeros_like(e)
    aux = torch.zeros((), dtype=torch.float32, device=e.device)
    for i, cent in enumerate(params["centroids"]):
        q_i, _, aux_i = dpq.quantize(e, cent, beta=cfg.beta)
        mask = tiers == i
        out = torch.where(mask[..., None], q_i, out)
        # weight tier aux by the fraction of items in the tier so the
        # total matches the masked-mean of per-item losses
        aux = aux + aux_i * dpq.batch_fraction(mask, mesh)
    return out, aux


# ----------------------------------------------------------------------
# serving export
# ----------------------------------------------------------------------

def export_serving(params: dict, cfg: EmbeddingConfig) -> dict:
    """Discard the full table; keep codes + centroids (paper Fig. 1).

    Every variant assigns codes through ``dpq.export_codes`` under
    ``cfg.kernel_backend``; the private variants run it once per tier
    codebook over every row."""
    device = params["emb"].device
    be = cfg.kernel_backend
    if cfg.mgqe_variant == "shared_k":
        codes = dpq.export_codes(params, k_limit_for_all_rows(cfg, device),
                                 backend=be)
        return {"codes": codes.to(_code_dtype(cfg)),
                "centroids": params["centroids"]}
    if cfg.mgqe_variant == "private_k":
        rows = torch.arange(cfg.vocab_size, dtype=torch.int32, device=device)
        tiers = tier_of_ids(rows, cfg.tier_boundaries)
        codes = torch.zeros((cfg.vocab_size, cfg.num_subspaces),
                            dtype=torch.int32, device=device)
        for i, cent in enumerate(params["centroids"]):
            c_i = dpq.export_codes({"emb": params["emb"], "centroids": cent},
                                   backend=be)
            codes = torch.where((tiers == i)[:, None], c_i, codes)
        return {"codes": codes.to(_code_dtype(cfg)),
                "centroids": params["centroids"]}
    # private_d: ragged D_i per tier — keep per-tier code arrays.
    out = {"codes": [], "centroids": params["centroids"]}
    for cent in params["centroids"]:
        out["codes"].append(
            dpq.export_codes({"emb": params["emb"], "centroids": cent},
                             backend=be).to(_code_dtype(cfg)))
    return out


# The serving decode (kernel + private-variant tier blending) lives on
# the scheme class — core/schemes/mgqe.py ``decode``.
