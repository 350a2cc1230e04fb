"""The recsys model registry (``RecsysConfig.model`` -> model class) and
MACE's FLOP model and shape resolution, from the JAX package's
``launch/cells.py``, and the batch of a sampled subgraph
(``sampled_graph``, the port's own).  Its dry-run cells (sharded train
and serve steps) wait for the launch slice in ROADMAP.md.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.configs.base import GNNConfig, RecsysConfig, ShapeSpec
from repro_torch.data.graph import sampled_subgraph_sizes
from repro_torch.models.gnn import so3
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


# ======================================================================
# GNN (MACE)
# ======================================================================

def mace_model_flops(cfg: GNNConfig, n_nodes: int, n_edges: int,
                     train: bool = True) -> float:
    """Analytic forward MACs x2 (x3 more for train) for the MACE step."""
    paths = so3.coupling_table(cfg.l_max)
    n_paths = len(paths)
    c = cfg.d_hidden
    s_tot = so3.num_sh(cfg.l_max)
    # per layer
    per_l = 0.0
    # radial MLP: E x (rbf*64 + 64*C*P)
    per_l += n_edges * (cfg.n_rbf * 64 + 64 * c * n_paths)
    # edge TP + pairwise CG: paths ~ E/N x C x S1*S2*S3
    path_cost = sum((2 * l1 + 1) * (2 * l2 + 1) * (2 * l3 + 1)
                    for (l1, l2, l3, _) in paths)
    per_l += n_edges * c * path_cost          # edge TP
    per_l += 2 * n_nodes * c * path_cost      # B2, B3
    # channel mixes: 4 x N x C*C*S
    per_l += 4 * n_nodes * c * c * s_tot
    # readout
    per_l += n_nodes * (c * 64 + 64 * cfg.d_readout)
    fl = cfg.num_layers * per_l * 2.0         # MAC -> 2 FLOPs
    return fl * (3.0 if train else 1.0)


def mace_shape(shape: ShapeSpec) -> Tuple[int, int, int, str, int]:
    """(n_nodes, n_edges, d_feat, task, n_graphs) of a ``GNN_SHAPES``
    entry, as the JAX package's ``mace_cell`` resolves it on one device:
    ``graph_mini`` the fanout sample's sizes at d_feat 128, node
    classification; ``graph_batched`` N·B and E·B, energy; else the
    shape's own sizes, node classification."""
    if shape.kind == "graph_mini":
        n_nodes, n_edges = sampled_subgraph_sizes(shape.batch_nodes,
                                                  shape.fanout)
        return n_nodes, n_edges, 128, "node_class", 0
    if shape.kind == "graph_batched":
        return (shape.n_nodes * shape.batch_graphs,
                shape.n_edges * shape.batch_graphs, 0, "energy",
                shape.batch_graphs)
    return shape.n_nodes, shape.n_edges, shape.d_feat, "node_class", 0


def sampled_graph(g: dict, sub: dict) -> dict:
    """The node-classification batch of a ``NeighborSampler`` sample
    ``sub`` over the graph ``g`` (numpy, as ``random_graph`` gives it):
    the sampled nodes' positions, species, features and labels, the
    sample's local edges, and a ``label_mask`` of 1 on its seeds (the
    first ``n_seeds`` local ids) and 0 elsewhere."""
    ids = sub["node_ids"]
    mask = np.zeros(len(ids), np.float32)
    mask[:sub["n_seeds"]] = 1.0
    return {"positions": g["positions"][ids], "species": g["species"][ids],
            "node_feats": g["node_feats"][ids], "labels": g["labels"][ids],
            "label_mask": mask, "edge_index": sub["edge_index"]}
