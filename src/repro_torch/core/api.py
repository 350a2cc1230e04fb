"""Unified embedding API — the integration surface for every model.

``Embedding(cfg, device="cuda")`` exposes:

    init(gen)                  -> params dict (training table)
    apply(params, ids, mesh)   -> (rows, aux loss)         # training path
    export(params)             -> serving artifact dict
    serve(artifact, ids, mesh) -> emb                      # serving path
    serving_size_bits()        -> int

Every method dispatches through the scheme plugin registry
(``repro_torch.core.schemes``): the config's ``kind`` resolves to one
Scheme class, so this facade never grows per-kind branches.

The device defaults to the card.  With no card present the constructor
raises; running on the CPU is an explicit ``device="cpu"``.  ``init``
draws from a ``torch.Generator`` on that device (the JAX package's
PRNG keys become generators; the two never give the same numbers, so
parity tests carry one package's tables across with
``repro_torch.convert``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.schemes import Scheme, get_scheme
from repro_torch.core.schemes.base import torch_dtype
from repro_torch.core.types import EmbeddingConfig


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises when it names the card and
    none is present (no silent move to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            f"available; pass device='cpu' to run on the CPU")
    return device


class Embedding:
    def __init__(self, cfg: EmbeddingConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.scheme: Scheme = get_scheme(cfg)

    def generator(self, seed: int = 0) -> torch.Generator:
        """A generator on this embedding's device, seeded."""
        from repro_torch.nn.initializers import generator
        return generator(self.device, seed)

    # ------------------------------------------------------------ train
    def init(self, gen: Optional[torch.Generator] = None,
             dtype: Optional[torch.dtype] = None) -> dict:
        """Training params on the generator's device (default: a
        generator seeded 0 on this embedding's device).  ``dtype``
        defaults to ``cfg.param_dtype``."""
        if gen is None:
            gen = self.generator()
        if gen.device.type != self.device.type:
            raise ValueError(f"generator on {gen.device}, embedding on "
                             f"{self.device}")
        if dtype is None:
            dtype = torch_dtype(self.cfg.param_dtype)
        return self.scheme.init(gen, dtype)

    def apply(self, params: dict, ids: torch.Tensor, mesh=None):
        """Training rows of ``ids`` and the aux loss; with a ``mesh``,
        from this rank's params as the recsys rules place them."""
        return self.scheme.apply(params, ids, mesh=mesh)

    # ------------------------------------------------------------ serve
    def export(self, params: dict) -> dict:
        """Serving artifact (the full table discarded)."""
        return self.scheme.attach_hot_rows(self.scheme.export(params))

    def serve(self, artifact: dict, ids: torch.Tensor, mesh=None,
              model_axis: str = "model", per_rank: bool = False
              ) -> torch.Tensor:
        """Rows of ``ids``; with a ``mesh`` (a sharded_codes config),
        through the sharded gather over this rank's artifact.
        ``per_rank``: ``ids`` are this rank's own and so are the rows,
        through the gather's per-rank form whatever the config's
        ``sharded_codes`` (an LM's token table on a mesh, its codes
        placed by ``sharding/rules.py::lm_artifact_specs``)."""
        if per_rank:
            from repro_torch.sharding.quantized import quantized_gather
            return quantized_gather(artifact, ids, self.cfg,
                                    model_axis=model_axis, mesh=mesh,
                                    per_rank=True)
        if mesh is None:
            return self.scheme.serve(artifact, ids)
        return self.scheme.serve(artifact, ids, mesh=mesh,
                                 model_axis=model_axis)

    # -------------------------------------------------- abstract shapes
    def serving_artifact_struct(self) -> dict:
        """Meta-device tensors shaped like the serving artifact."""
        return self.scheme.serving_artifact_struct()

    # ------------------------------------------------------------ sizes
    def serving_size_bits(self) -> int:
        return self.scheme.serving_size_bits()

    def training_param_count(self) -> int:
        return self.scheme.training_param_count()
