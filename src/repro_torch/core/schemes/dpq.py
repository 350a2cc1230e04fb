"""DPQ (paper §1.1) as a registry plugin over ``repro_torch.core.dpq``."""
from __future__ import annotations

from repro_torch.core import dpq
from repro_torch.core.schemes.base import (PIN_TO_CONFIG, ArtifactLeaf,
                                           QuantizedScheme, log2ceil,
                                           register_scheme, torch_dtype)


@register_scheme("dpq")
class DifferentiableProductQuantization(QuantizedScheme):
    """Product quantization learned end-to-end; serving artifact =
    codes (n, D) + centroids (D, K, S)."""

    @classmethod
    def validate(cls, cfg):
        if cfg.dim % cfg.num_subspaces != 0:
            raise ValueError(
                f"dim={cfg.dim} not divisible by D={cfg.num_subspaces}")

    def init(self, gen, dtype):
        cfg = self.cfg
        return dpq.init(gen, cfg.vocab_size, cfg.dim, cfg.num_subspaces,
                        cfg.num_centroids, dtype=dtype)

    def apply(self, params, ids, mesh=None):
        cfg = self.cfg
        return dpq.lookup_train(params, ids, beta=cfg.beta, mesh=mesh,
                                rows=cfg.vocab_size)

    def export(self, params):
        codes = dpq.export_codes(params, backend=self.cfg.kernel_backend)
        return {"codes": codes.to(self.code_dtype),
                "centroids": params["centroids"]}

    def decode(self, artifact, ids, tier_ids=None,
               block_b=PIN_TO_CONFIG):
        cfg = self.cfg
        return dpq.serving_lookup(artifact["codes"], artifact["centroids"],
                                  ids, backend=cfg.kernel_backend,
                                  block_b=self.resolve_block_b(block_b))

    def cold_artifact_spec(self):
        cfg = self.cfg
        return {
            "codes": ArtifactLeaf(
                (cfg.vocab_size, cfg.num_subspaces), self.code_dtype,
                rows=True,
                logical_bits=cfg.vocab_size * cfg.num_subspaces
                * log2ceil(cfg.num_centroids)),
            "centroids": ArtifactLeaf(
                (cfg.num_subspaces, cfg.num_centroids, cfg.subspace_dim),
                torch_dtype(cfg.param_dtype)),
        }

    def training_param_count(self):
        cfg = self.cfg
        return cfg.vocab_size * cfg.dim + cfg.num_centroids * cfg.dim
