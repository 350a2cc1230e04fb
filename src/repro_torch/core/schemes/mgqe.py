"""MGQE (paper §2) as a registry plugin over ``repro_torch.core.mgqe``.

The three capacity-allocation variants share one scheme class; the
variant-specific artifact layouts (per-tier codebook lists, per-tier
code tables for ``private_d``) are encoded in :meth:`artifact_spec`,
from which struct and size derive.
"""
from __future__ import annotations

import torch

from repro_torch.core import dpq, mgqe
from repro_torch.core.partition import tier_of_ids
from repro_torch.core.schemes.base import (PIN_TO_CONFIG, ArtifactLeaf,
                                           QuantizedScheme, log2ceil,
                                           register_scheme, torch_dtype)
from repro_torch.core.types import MGQE_VARIANTS


@register_scheme("mgqe")
class MultiGranularQuantizedEmbedding(QuantizedScheme):
    """Multi-granular DPQ: frequent items get more centroids
    (``shared_k``/``private_k``) or more subspaces (``private_d``)."""

    @classmethod
    def validate(cls, cfg):
        if cfg.dim % cfg.num_subspaces != 0:
            raise ValueError(
                f"dim={cfg.dim} not divisible by D={cfg.num_subspaces}")
        if cfg.mgqe_variant not in MGQE_VARIANTS:
            raise ValueError(f"unknown MGQE variant {cfg.mgqe_variant!r}")
        m = len(cfg.tier_boundaries) + 1
        if cfg.mgqe_variant in ("shared_k", "private_k"):
            if len(cfg.tier_num_centroids) != m:
                raise ValueError(
                    f"tier_num_centroids must have {m} entries, got "
                    f"{len(cfg.tier_num_centroids)}")
            ks = cfg.tier_num_centroids
            if any(ks[i] < ks[i + 1] for i in range(len(ks) - 1)):
                raise ValueError("tier_num_centroids must be non-increasing")
            if max(ks) > cfg.num_centroids:
                raise ValueError("tier K_i exceeds num_centroids")
        if cfg.mgqe_variant == "private_d":
            if len(cfg.tier_num_subspaces) != m:
                raise ValueError(
                    f"tier_num_subspaces must have {m} entries, got "
                    f"{len(cfg.tier_num_subspaces)}")
            for d_i in cfg.tier_num_subspaces:
                if cfg.dim % d_i != 0:
                    raise ValueError(
                        f"dim={cfg.dim} not divisible by tier D={d_i}")
        if any(b <= 0 or b >= cfg.vocab_size for b in cfg.tier_boundaries):
            raise ValueError("tier boundaries must lie inside (0, vocab)")
        if any(cfg.tier_boundaries[i] >= cfg.tier_boundaries[i + 1]
               for i in range(len(cfg.tier_boundaries) - 1)):
            raise ValueError("tier boundaries must be strictly ascending")

    @classmethod
    def variants(cls):
        return MGQE_VARIANTS

    @property
    def variant_label(self):
        return self.cfg.mgqe_variant

    # ------------------------------------------------------------ train
    def init(self, gen, dtype):
        return mgqe.init(gen, self.cfg, dtype=dtype)

    def apply(self, params, ids, mesh=None):
        return mgqe.lookup_train(params, ids, self.cfg, mesh=mesh)

    # ------------------------------------------------------------ serve
    def export(self, params):
        return mgqe.export_serving(params, self.cfg)

    def decode(self, artifact, ids, tier_ids=None,
               block_b=PIN_TO_CONFIG):
        """Decode through the dispatched op, blending private-variant
        tiers by mask (tier membership keys on the frequency-sorted id)."""
        cfg = self.cfg
        bb = self.resolve_block_b(block_b)
        if cfg.mgqe_variant == "shared_k":
            return dpq.serving_lookup(artifact["codes"],
                                      artifact["centroids"], ids,
                                      backend=cfg.kernel_backend,
                                      block_b=bb)
        tiers = tier_of_ids(ids if tier_ids is None else tier_ids,
                            cfg.tier_boundaries)
        outs = []
        for i, cent in enumerate(artifact["centroids"]):
            codes_i = (artifact["codes"][i]
                       if isinstance(artifact["codes"], (list, tuple))
                       else artifact["codes"])
            outs.append(dpq.serving_lookup(codes_i, cent, ids,
                                           backend=cfg.kernel_backend,
                                           block_b=bb))
        out = outs[0]
        for i in range(1, len(outs)):
            out = torch.where((tiers == i)[..., None], outs[i], out)
        return out

    # -------------------------------------------------------- structure
    def cold_artifact_spec(self):
        cfg = self.cfg
        n, d, D = cfg.vocab_size, cfg.dim, cfg.num_subspaces
        sizes = cfg.tier_sizes()
        cd = self.code_dtype
        pd = torch_dtype(cfg.param_dtype)
        if cfg.mgqe_variant in ("shared_k", "private_k"):
            # one (n, D) code table; packed width varies per tier
            code_bits = sum(sz * D * log2ceil(k)
                            for sz, k in zip(sizes, cfg.tier_num_centroids))
            codes = ArtifactLeaf((n, D), cd, rows=True,
                                 logical_bits=code_bits)
            if cfg.mgqe_variant == "shared_k":
                cents = ArtifactLeaf(
                    (D, cfg.num_centroids, cfg.subspace_dim), pd)
            else:
                cents = [ArtifactLeaf((D, k_i, cfg.subspace_dim), pd)
                         for k_i in cfg.tier_num_centroids]
            return {"codes": codes, "centroids": cents}
        # private_d: per-tier (n, D_i) code tables.  Paper accounting
        # (§1.1) packs only the rows IN tier i for table i; storage keeps
        # full tables so decode stays one kernel launch per tier.
        return {
            "codes": [
                ArtifactLeaf((n, d_i), cd, rows=True,
                             logical_bits=sz * d_i
                             * log2ceil(cfg.num_centroids))
                for sz, d_i in zip(sizes, cfg.tier_num_subspaces)],
            "centroids": [
                ArtifactLeaf((d_i, cfg.num_centroids, d // d_i), pd)
                for d_i in cfg.tier_num_subspaces],
        }

    def training_param_count(self):
        cfg = self.cfg
        n, d = cfg.vocab_size, cfg.dim
        if cfg.mgqe_variant == "shared_k":
            return n * d + cfg.num_centroids * d
        if cfg.mgqe_variant == "private_k":
            return n * d + d * sum(cfg.tier_num_centroids)
        return n * d + d * cfg.num_centroids * cfg.num_tiers
