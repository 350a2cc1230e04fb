"""Baseline schemes (paper §3.4) as registry plugins.

Thin classes over the functional implementations in
``repro_torch.core.baselines`` — the math stays there; the plugin layer
owns dispatch, artifact specs and size accounting.
"""
from __future__ import annotations

import torch

from repro_torch.core import baselines
from repro_torch.core.schemes.base import (ArtifactLeaf, Scheme,
                                           register_scheme, torch_dtype)


@register_scheme("full")
class FullEmbedding(Scheme):
    """FE — the conventional (n, d) table; the 100% size baseline."""

    def init(self, gen, dtype):
        return baselines.full_init(gen, self.cfg, dtype)

    def apply(self, params, ids, mesh=None):
        return baselines.full_lookup(params, ids, self.cfg, mesh=mesh)

    def export(self, params):
        return params  # nothing to strip

    def serve(self, artifact, ids):
        rows = artifact["emb"].index_select(0, ids.reshape(-1))
        return rows.reshape(tuple(ids.shape) + (self.cfg.dim,))

    def cold_artifact_spec(self):
        cfg = self.cfg
        return {"emb": ArtifactLeaf((cfg.vocab_size, cfg.dim),
                                    torch_dtype(cfg.param_dtype))}

    def training_param_count(self):
        return self.cfg.vocab_size * self.cfg.dim


@register_scheme("lrf")
class LowRankFactorization(Scheme):
    """(n, r) @ (r, d) factorized table."""

    @classmethod
    def validate(cls, cfg):
        if cfg.rank <= 0:
            raise ValueError("lrf embedding needs rank > 0")

    def init(self, gen, dtype):
        return baselines.lrf_init(gen, self.cfg, dtype)

    def apply(self, params, ids, mesh=None):
        return baselines.lrf_lookup(params, ids, self.cfg, mesh=mesh)

    def export(self, params):
        return params

    def serve(self, artifact, ids):
        return baselines.lrf_serving_lookup(artifact, ids, self.cfg)

    def cold_artifact_spec(self):
        cfg = self.cfg
        pd = torch_dtype(cfg.param_dtype)
        return {"u": ArtifactLeaf((cfg.vocab_size, cfg.rank), pd),
                "v": ArtifactLeaf((cfg.rank, cfg.dim), pd)}

    def training_param_count(self):
        cfg = self.cfg
        return cfg.vocab_size * cfg.rank + cfg.rank * cfg.dim


@register_scheme("sq")
class ScalarQuantization(Scheme):
    """Post-training per-dim uniform quantization; trains exactly like
    FE, quantizes at export."""

    @classmethod
    def validate(cls, cfg):
        if not 1 <= cfg.sq_bits <= 32:
            raise ValueError(f"sq_bits must be in [1, 32], got {cfg.sq_bits}")

    def init(self, gen, dtype):
        return baselines.sq_init(gen, self.cfg, dtype)

    def apply(self, params, ids, mesh=None):
        return baselines.sq_lookup(params, ids, self.cfg, mesh=mesh)

    def export(self, params):
        return baselines.sq_export(params, self.cfg)

    def serve(self, artifact, ids):
        return baselines.sq_serving_lookup(artifact, ids, self.cfg)

    @property
    def hot_dtype(self):
        # serve dequantizes against float32 lo/scale (sq_export), so the
        # hot block is float32 regardless of param_dtype
        return torch.float32

    def cold_artifact_spec(self):
        cfg = self.cfg
        qd = torch.uint8 if cfg.sq_bits <= 8 else torch.int32
        # q is stored at uint8/int32 granularity but accounted at
        # sq_bits per element; lo/scale are float32 by construction
        return {
            "q": ArtifactLeaf((cfg.vocab_size, cfg.dim), qd,
                              logical_bits=cfg.vocab_size * cfg.dim
                              * cfg.sq_bits),
            "lo": ArtifactLeaf((cfg.dim,), torch.float32),
            "scale": ArtifactLeaf((cfg.dim,), torch.float32),
        }

    def training_param_count(self):
        return self.cfg.vocab_size * self.cfg.dim


@register_scheme("hash")
class HashingTrick(Scheme):
    """Ids hashed into a smaller table (Weinberger et al. 2009)."""

    @classmethod
    def validate(cls, cfg):
        if cfg.hash_buckets <= 0:
            raise ValueError("hash embedding needs hash_buckets > 0")

    def init(self, gen, dtype):
        return baselines.hash_init(gen, self.cfg, dtype)

    def apply(self, params, ids, mesh=None):
        return baselines.hash_lookup(params, ids, self.cfg, mesh=mesh)

    def export(self, params):
        return params

    def serve(self, artifact, ids):
        return baselines.hash_lookup(artifact, ids, self.cfg)[0]

    def cold_artifact_spec(self):
        cfg = self.cfg
        return {"emb": ArtifactLeaf((cfg.hash_buckets, cfg.dim),
                                    torch_dtype(cfg.param_dtype))}

    def training_param_count(self):
        return self.cfg.hash_buckets * self.cfg.dim
