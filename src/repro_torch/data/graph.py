"""Graph data: synthetic generators for the four assigned GNN shapes and
a real fanout neighbor sampler (GraphSAGE-style) for minibatch_lg.

Copied line for line from the JAX package (numpy only), so both
packages draw bit-identical graphs and samples from one seed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


# ----------------------------------------------------------------------
# batched small molecules (shape: molecule — 30 nodes, 64 edges, B=128)
# ----------------------------------------------------------------------

def molecule_batch(n_graphs: int = 128, n_atoms: int = 30,
                   n_edges: int = 64, n_species: int = 10,
                   box: float = 6.0, seed: int = 0) -> Dict[str, np.ndarray]:
    """Random molecules with a Lennard-Jones-ish teacher energy so the
    regression task has signal.  Edges: nearest pairs, padded/capped to
    exactly n_edges per graph (static shape)."""
    rng = np.random.default_rng(seed)
    all_pos, all_spec, all_send, all_recv, all_gid, energies = \
        [], [], [], [], [], []
    for g in range(n_graphs):
        pos = rng.uniform(0, box, size=(n_atoms, 3)).astype(np.float32)
        spec = rng.integers(0, n_species, n_atoms)
        d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
        np.fill_diagonal(d, np.inf)
        # pick the n_edges closest directed pairs
        flat = np.argsort(d, axis=None)[:n_edges]
        send, recv = np.unravel_index(flat, d.shape)
        r = np.maximum(d[send, recv], 0.9)   # clamp: keep teacher bounded
        # LJ-style pair energy teacher (+ species affinity term)
        eps = 0.5 + 0.1 * ((spec[send] + spec[recv]) % 3)
        e = np.sum(eps * ((1.2 / r) ** 12 - 2 * (1.2 / r) ** 6)) / n_atoms
        off = g * n_atoms
        all_pos.append(pos)
        all_spec.append(spec)
        all_send.append(send + off)
        all_recv.append(recv + off)
        all_gid.append(np.full(n_atoms, g))
        energies.append(e)
    return {
        "positions": np.concatenate(all_pos).astype(np.float32),
        "species": np.concatenate(all_spec).astype(np.int32),
        "edge_index": np.stack([np.concatenate(all_send),
                                np.concatenate(all_recv)]).astype(np.int32),
        "graph_id": np.concatenate(all_gid).astype(np.int32),
        "n_graphs": n_graphs,
        "energy": np.asarray(energies, np.float32),
    }


# ----------------------------------------------------------------------
# full-batch citation/products-like graphs (synthetic coordinates)
# ----------------------------------------------------------------------

def random_graph(n_nodes: int, n_edges: int, d_feat: int,
                 n_classes: int = 16, seed: int = 0) -> Dict[str, np.ndarray]:
    """Power-law-degree random graph with planted community labels."""
    rng = np.random.default_rng(seed)
    # preferential-attachment-ish: sample endpoints from Zipf over nodes
    def zipf_ids(n):
        u = rng.random(n)
        x = (1.0 - u) ** (-1.0 / 0.35) - 1.0
        return np.minimum(x.astype(np.int64), n_nodes - 1)
    send = zipf_ids(n_edges)
    recv = rng.integers(0, n_nodes, n_edges)
    labels = rng.integers(0, n_classes, n_nodes)
    # features correlate with labels (learnable signal)
    centers = rng.normal(size=(n_classes, d_feat)).astype(np.float32)
    feats = centers[labels] + rng.normal(scale=2.0,
                                         size=(n_nodes, d_feat)).astype(np.float32)
    return {
        "positions": rng.normal(size=(n_nodes, 3)).astype(np.float32),
        "species": (labels % 100).astype(np.int32),
        "node_feats": feats.astype(np.float32),
        "edge_index": np.stack([send, recv]).astype(np.int32),
        "labels": labels.astype(np.int32),
    }


# ----------------------------------------------------------------------
# CSR adjacency + fanout neighbor sampler (minibatch_lg)
# ----------------------------------------------------------------------

@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray      # (N+1,)
    indices: np.ndarray     # (E,)
    n_nodes: int

    @staticmethod
    def from_edge_index(edge_index: np.ndarray, n_nodes: int) -> "CSRGraph":
        send, recv = edge_index
        order = np.argsort(recv, kind="stable")
        sorted_send = send[order]
        counts = np.bincount(recv, minlength=n_nodes)
        indptr = np.zeros(n_nodes + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        return CSRGraph(indptr, sorted_send.astype(np.int64), n_nodes)


class NeighborSampler:
    """GraphSAGE fanout sampling: for seed nodes, sample ``fanout[0]``
    in-neighbors, then ``fanout[1]`` neighbors of those, etc.  Nodes
    with degree < fanout are padded with self-loops so every batch has
    a static shape (TPU requirement)."""

    def __init__(self, graph: CSRGraph, fanout: Tuple[int, ...],
                 seed: int = 0):
        self.g = graph
        self.fanout = fanout
        self.rng = np.random.default_rng(seed)

    def sample(self, seeds: np.ndarray) -> Dict[str, np.ndarray]:
        layers = [seeds.astype(np.int64)]
        sends, recvs = [], []
        frontier = seeds.astype(np.int64)
        for f in self.fanout:
            deg = self.g.indptr[frontier + 1] - self.g.indptr[frontier]
            # sample with replacement; degree-0 nodes self-loop
            offs = self.rng.integers(0, np.maximum(deg, 1)[:, None],
                                     size=(len(frontier), f))
            base = self.g.indptr[frontier][:, None]
            neigh = np.where(deg[:, None] > 0,
                             self.g.indices[np.minimum(
                                 base + offs,
                                 len(self.g.indices) - 1)],
                             frontier[:, None])
            sends.append(neigh.reshape(-1))
            recvs.append(np.repeat(frontier, f))
            frontier = neigh.reshape(-1)
            layers.append(frontier)
        # compact node ids: unique nodes, seeds first
        all_nodes = np.concatenate(layers)
        uniq, inv = np.unique(all_nodes, return_inverse=True)
        # reorder so seeds occupy [0, len(seeds))
        seed_pos = inv[:len(seeds)]
        perm = np.full(len(uniq), -1, np.int64)
        perm[seed_pos] = np.arange(len(seeds))
        rest = np.setdiff1d(np.arange(len(uniq)), seed_pos, assume_unique=False)
        perm[rest] = np.arange(len(seeds), len(uniq))
        # map edges to local ids via searchsorted over the sorted uniq
        send_cat = np.concatenate(sends)
        recv_cat = np.concatenate(recvs)
        send_l = perm[np.searchsorted(uniq, send_cat)]
        recv_l = perm[np.searchsorted(uniq, recv_cat)]
        return {
            "node_ids": uniq[np.argsort(perm)],
            "edge_index": np.stack([send_l, recv_l]).astype(np.int32),
            "n_seeds": len(seeds),
        }


def sampled_subgraph_sizes(batch_nodes: int,
                           fanout: Tuple[int, ...]) -> Tuple[int, int]:
    """Static (n_nodes, n_edges) upper bounds for a fanout sample —
    what the dry-run lowers."""
    nodes, edges, frontier = batch_nodes, 0, batch_nodes
    for f in fanout:
        edges += frontier * f
        frontier = frontier * f
        nodes += frontier
    return nodes, edges
