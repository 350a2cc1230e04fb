"""The recsys model registry: ``RecsysConfig.model`` -> model class.

Only the registry of the JAX package's ``launch/cells.py`` is ported;
its dry-run cells (sharded train and serve steps, FLOP counts) wait for
the launch slice in ROADMAP.md.
"""
from __future__ import annotations

from repro_torch.configs.base import RecsysConfig
from repro_torch.models.recsys.deepfm import DeepFM
from repro_torch.models.recsys.two_tower import TwoTower

_RECSYS_MODELS = {"deepfm": DeepFM, "two_tower": TwoTower}
# models of the JAX registry whose port is a later slice
_UNPORTED = ("autoint", "bst")


def recsys_model(cfg: RecsysConfig, device="cuda"):
    """The model of ``cfg.model`` on ``device`` (default: the card)."""
    if cfg.model in _UNPORTED:
        raise NotImplementedError(
            f"recsys model {cfg.model!r} is not ported yet; it waits for "
            f"its slice in ROADMAP.md (ported: "
            f"{', '.join(sorted(_RECSYS_MODELS))})")
    try:
        cls = _RECSYS_MODELS[cfg.model]
    except KeyError:
        raise ValueError(f"unknown recsys model {cfg.model!r}") from None
    return cls(cfg, device=device)
