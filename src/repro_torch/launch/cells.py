"""The recsys model registry: ``RecsysConfig.model`` -> model class.

Only the registry of the JAX package's ``launch/cells.py`` is ported;
its dry-run cells (sharded train and serve steps, FLOP counts) wait for
the launch slice in ROADMAP.md.
"""
from __future__ import annotations

from repro_torch.configs.base import RecsysConfig
from repro_torch.models.recsys.autoint import AutoInt
from repro_torch.models.recsys.bst import BST
from repro_torch.models.recsys.deepfm import DeepFM
from repro_torch.models.recsys.two_tower import TwoTower

_RECSYS_MODELS = {"autoint": AutoInt, "deepfm": DeepFM,
                  "two_tower": TwoTower, "bst": BST}


def recsys_model(cfg: RecsysConfig, device="cuda"):
    """The model of ``cfg.model`` on ``device`` (default: the card)."""
    try:
        cls = _RECSYS_MODELS[cfg.model]
    except KeyError:
        raise ValueError(f"unknown recsys model {cfg.model!r}; known: "
                         f"{', '.join(sorted(_RECSYS_MODELS))}") from None
    return cls(cfg, device=device)


def recsys_tables(model, batch) -> list:
    """(path, Embedding, ids) of every table a recsys model's forward
    reads, with the ids it looks up in ``batch``: a field of deepfm or
    autoint at ``("fields", "f<i>")`` (column i of ``sparse_ids``),
    two-tower's ``("user_emb",)`` and ``("item_emb",)``, bst's
    ``("item_emb",)`` over the history and the target (``BST.ids``).
    ``path`` leads to the table's params; ``serve_ctr`` exports the
    subtree ``params[path[0]]``, so ``path[1:]`` leads to its artifact."""
    if model.cfg.model == "two_tower":
        return [(("user_emb",), model.user_emb, batch["user_ids"]),
                (("item_emb",), model.item_emb, batch["item_ids"])]
    if model.cfg.model == "bst":
        return [(("item_emb",), model.item_emb, model.ids(batch))]
    return [(("fields", f"f{i}"), e, batch["sparse_ids"][:, i])
            for i, e in enumerate(model.fields.embs)]
