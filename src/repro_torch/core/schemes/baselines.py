"""Baseline schemes (paper §3.4) as registry plugins.

Only the full table is ported in this slice: it is the config default
and the 100% row of the size table.  ``lrf``/``sq``/``hash`` are the
baselines slice in ROADMAP.md.
"""
from __future__ import annotations

from repro_torch.core import baselines
from repro_torch.core.schemes.base import (ArtifactLeaf, Scheme,
                                           register_scheme, torch_dtype)


@register_scheme("full")
class FullEmbedding(Scheme):
    """FE — the conventional (n, d) table; the 100% size baseline."""

    def init(self, gen, dtype):
        return baselines.full_init(gen, self.cfg, dtype)

    def apply(self, params, ids):
        return baselines.full_lookup(params, ids, self.cfg)

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
