"""MACE [arXiv:2206.07697]: higher-order equivariant (E(3)-ACE) message
passing — the JAX package's ``models/gnn/mace.py`` in PyTorch.

Per layer:
  1. edge tensor product  phi_e = sum_paths W_r(r_e) . CG . (X_sender (x) Y(r_e))
  2. A-basis              A_i   = segment_sum(phi_e -> receiver)      (scatter!)
  3. higher-order B-basis B2 = CG.(A (x) A), B3 = CG.(B2 (x) A)       (corr. order 3)
  4. message + update     X <- Linear_l(B1,B2,B3) + residual
  5. per-layer readout from the invariant (l=0) channels.

Params are a dict of tensors in the JAX package's layout, so they carry
across leaf for leaf (``convert.mace_params_from_numpy``).  What the
port does its own way:

* **Repeatable message passing.**  Every gather by node id (the
  senders' irreps, the species rows) and every sum by node or graph id
  (the A-basis, the energy) is :func:`gather_rows` or
  :func:`segment_sum`, each the other's backward.  The sum is
  ``index_put_`` with accumulation on the card, which sorts the ids
  first, and ``index_add_`` on the CPU, which adds the rows in id
  order: neither adds atomically (the card's ``index_add_`` and the
  CPU's ``index_put_`` do), so a step run twice gives the same bits
  under the default algorithms on either device.  Ids must lie in range
  (JAX's ``segment_sum`` drops others; here they raise).
* **Contraction order.**  The edge product contracts Y with each path's
  CG first, (E, b) @ (b, a·k), then takes a batched product with the
  sender's irreps, (E, C, a) @ (E, a, k): no (E, C, a, b) tensor
  exists.  The B-basis forms each path's channel-wise outer product
  (N, C, a·b) and multiplies it by the path's CG (a·b, k); the CG needs
  no gradient, so autograd keeps only the path's (N, C, k) product.
* The 15 paths at l_max = 2 stay Python loops of small dense products,
  as in JAX: hundreds of small launches a step.

**On a mesh** (``mesh=``, ``launch/cells.py::mace_cell``) the graph
is this rank's: a contiguous block of the nodes and one of the edges
over every axis, the edges' ids global, and the params whole (the cell
gathers their channel blocks).  A layer all-gathers the node irreps
(every rank's senders may lie in any block; backward, the cotangent
summed and sliced), sums its edges' messages into all N receivers and
keeps its block of the psum (:func:`~repro_torch.sharding.collectives.
psum_scatter`); the losses sum their terms over every rank.  Each rank
then backpropagates the global loss and holds its share of every
gradient.

MGQE applicability: the only categorical table is the species
embedding (vocab ~100) — the paper's technique targets large vocabs,
so MACE runs WITHOUT it (DESIGN.md §4).

Non-geometric graph shapes (Cora-like, ogb-products-like) are run with
synthetic 3D coordinates + a feature projection — the cell exercises
the gather/TP/scatter structure, not chemistry.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import GNNConfig
from repro_torch.core.api import resolve_device
from repro_torch.models.gnn import so3
from repro_torch.nn import initializers as init
from repro_torch.nn.mlp import mlp, mlp_init
from repro_torch.sharding.collectives import (all_gather, all_gather_grad,
                                              psum_scatter, reduce_from)


# ----------------------------------------------------------------------
# radial basis and the receiver sum
# ----------------------------------------------------------------------

def bessel_basis(dist: torch.Tensor, n_rbf: int, r_cut: float) -> torch.Tensor:
    """(E,) -> (E, n_rbf); sin(n pi r / rc) / r with smooth cutoff."""
    d = torch.clamp(dist, min=1e-6)[..., None]
    n = torch.arange(1, n_rbf + 1, dtype=d.dtype, device=d.device)
    rb = math.sqrt(2.0 / r_cut) * torch.sin(n * math.pi * d / r_cut) / d
    # polynomial envelope (p=5) going smoothly to 0 at r_cut
    x = torch.clamp(dist / r_cut, 0.0, 1.0)[..., None]
    env = 1.0 - 10.0 * x ** 3 + 15.0 * x ** 4 - 6.0 * x ** 5
    return rb * env


def _scatter_add(data: torch.Tensor, ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Rows of ``data`` summed by ``ids`` (int64) into ``num_segments``
    rows, in an order fixed by the ids: sorted on the card, in turn on
    the CPU."""
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    if data.is_cuda:
        return out.index_put_((ids,), data, accumulate=True)
    return out.index_add_(0, ids, data)


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, ids, num_segments):
        ctx.save_for_backward(ids)
        return _scatter_add(data, ids, num_segments)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        return grad.index_select(0, ids), None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ids):
        ctx.save_for_backward(ids)
        ctx.num_rows = x.shape[0]
        return x.index_select(0, ids)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        return _scatter_add(grad, ids, ctx.num_rows), None


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Rows of ``data`` summed by ``segment_ids`` into ``num_segments``
    rows; the same bits every time, and so is its backward (a gather)."""
    return _SegmentSum.apply(data, segment_ids.long(), num_segments)


def gather_rows(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``x[ids]`` along the first axis, whose backward is
    :func:`segment_sum`'s sum (the same bits every time)."""
    return _GatherRows.apply(x, ids.long())


class MACE:
    def __init__(self, cfg: GNNConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.paths = so3.coupling_table(cfg.l_max)
        self.n_paths = len(self.paths)
        self.n_sh = so3.num_sh(cfg.l_max)
        self.slices = so3.irrep_slices(cfg.l_max)
        self._cg_cache: Dict[torch.device, List[Tuple]] = {}

    def _cgs(self, device: torch.device) -> List[Tuple[torch.Tensor, ...]]:
        """Each path's float32 CG on ``device`` in the two layouts the
        products take: (b, a·k) for the edge product, (a·b, k) for the
        B-basis."""
        if device not in self._cg_cache:
            out = []
            for _, _, _, cg in self.paths:
                t = torch.as_tensor(cg, dtype=torch.float32, device=device)
                a, b, k = t.shape
                out.append((t.permute(1, 0, 2).reshape(b, a * k),
                            t.reshape(a * b, k)))
            self._cg_cache[device] = out
        return self._cg_cache[device]

    # ------------------------------------------------------------- init
    def init(self, gen: Optional[torch.Generator] = None,
             n_feat: Optional[int] = None) -> Dict:
        """Params on the generator's device (default: seeded 0 on the
        model's device), drawn in order: ``feat_proj`` (with
        ``n_feat``), ``species_emb``, then each layer's leaves."""
        cfg = self.cfg
        c = cfg.d_hidden
        if gen is None:
            gen = init.generator(self.device, 0)
        params: Dict = {}
        if n_feat:
            params["feat_proj"] = init.dense_init(gen, n_feat, c)
        params["species_emb"] = init.normal(gen, (cfg.num_species, c),
                                            c ** -0.5)
        layers = []
        for _ in range(cfg.num_layers):
            layers.append({
                # radial MLP: rbf -> per-channel per-path edge weights
                "radial": mlp_init(gen, (cfg.n_rbf, 64, c * self.n_paths),
                                   bias=False),
                # channel mix of A per l
                "a_mix": init.normal(gen, (cfg.l_max + 1, c, c), c ** -0.5),
                # per-channel per-path weights for B2/B3 contractions
                "u2": init.normal(gen, (c, self.n_paths),
                                  self.n_paths ** -0.5),
                "u3": init.normal(gen, (c, self.n_paths),
                                  self.n_paths ** -0.5),
                # message channel-mix per l for B1/B2/B3
                "m1": init.normal(gen, (cfg.l_max + 1, c, c),
                                  (3 * c) ** -0.5),
                "m2": init.normal(gen, (cfg.l_max + 1, c, c),
                                  (3 * c) ** -0.5),
                "m3": init.normal(gen, (cfg.l_max + 1, c, c),
                                  (3 * c) ** -0.5),
                "readout": mlp_init(gen, (c, 64, cfg.d_readout)),
            })
        params["layers"] = layers
        return params

    # -------------------------------------------------------- helpers
    def _edge_mask(self, dist: torch.Tensor) -> torch.Tensor:
        """1 for an edge of non-zero length, 0 for a self-loop or
        padding edge.  Y(0) is a constant non-rotating vector with a
        non-zero l=2 component — letting it through contaminates the
        A-basis and silently breaks E(3) equivariance.  Samplers pad
        with self-loops, so this mask is a correctness requirement, not
        an optimization."""
        return (dist > 1e-6).to(dist.dtype)

    def _radial(self, layer: Dict, rbf: torch.Tensor,
                edge_mask: torch.Tensor) -> torch.Tensor:
        """Per-edge, per-channel, per-path weights (E, C, P), masked."""
        w_r = mlp(layer["radial"], rbf, act="silu")          # (E, C*P)
        return w_r.reshape(-1, self.cfg.d_hidden, self.n_paths) \
            * edge_mask[:, None, None]

    def _edge_tp(self, x_send: torch.Tensor, y_sh: torch.Tensor,
                 w_r: torch.Tensor, cgs) -> torch.Tensor:
        """phi (E, C, S): the edge tensor product over every path, each
        path's Y contracted with its CG before the sender's irreps."""
        e = x_send.shape[0]
        acc: List[Optional[torch.Tensor]] = [None] * len(self.slices)
        for p, (l1, l2, l3, _) in enumerate(self.paths):
            a, k = 2 * l1 + 1, 2 * l3 + 1
            t = (y_sh[:, self.slices[l2]] @ cgs[p][0]).reshape(e, a, k)
            contrib = torch.bmm(x_send[:, :, self.slices[l1]], t)
            term = contrib * w_r[:, :, p, None]
            acc[l3] = term if acc[l3] is None else acc[l3] + term
        return torch.cat(acc, dim=-1)

    def _mix_per_l(self, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """w (L+1, C, C); x (N, C, S) -> per-l channel mix."""
        outs = [torch.einsum("ncs,cd->nds", x[:, :, sl], w[l])
                for l, sl in enumerate(self.slices)]
        return torch.cat(outs, dim=-1)

    def _pairwise(self, x: torch.Tensor, y: torch.Tensor, u: torch.Tensor,
                  cgs) -> torch.Tensor:
        """CG-contract two irrep features channel-wise.
        x, y (N, C, S); u (C, n_paths) path weights -> (N, C, S)."""
        n, c, _ = x.shape
        acc: List[Optional[torch.Tensor]] = [None] * len(self.slices)
        for p, (l1, l2, l3, _) in enumerate(self.paths):
            outer = x[:, :, self.slices[l1], None] \
                * y[:, :, None, self.slices[l2]]
            contrib = outer.reshape(n, c, -1) @ cgs[p][1]
            term = contrib * u[:, p][None, :, None]
            acc[l3] = term if acc[l3] is None else acc[l3] + term
        return torch.cat(acc, dim=-1)

    def _readout(self, layer: Dict, x: torch.Tensor) -> torch.Tensor:
        """The layer's (N, d_readout) readout of the invariant channels."""
        return mlp(layer["readout"], x[:, :, 0], act="silu").to(torch.float32)

    # -------------------------------------------------------- forward
    def apply(self, params: Dict, graph: Dict, mesh=None) -> Dict:
        """graph: positions (N,3), edge_index (2,E) [send, recv],
        species (N,) and/or node_feats (N,F), optional graph_id (N,)
        with n_graphs.

        Returns {"node_out": (N, d_readout), "energy": per-graph sums}.

        With a ``mesh``, ``graph`` holds this rank's node block and edge
        block (the module docstring) and ``node_out`` is the block's;
        ``energy`` is every graph's, on every rank.  A node whose
        ``graph_id`` is ``n_graphs`` (the cell's padding) adds to no
        graph."""
        cfg = self.cfg
        pos = graph["positions"]
        edges = graph["edge_index"].long()
        send, recv = edges[0], edges[1]
        n = pos.shape[0]
        c = cfg.d_hidden
        cgs = self._cgs(pos.device)
        axes = () if mesh is None else tuple(mesh.axis_names)
        pos_all = pos if mesh is None else all_gather(pos, mesh, axes)
        n_all = pos_all.shape[0]

        h = gather_rows(params["species_emb"], graph["species"])
        if "node_feats" in graph and "feat_proj" in params:
            h = h + init.dense(params["feat_proj"], graph["node_feats"])

        # initial irrep features: invariant channel only
        x = torch.cat([h[:, :, None], h.new_zeros((n, c, self.n_sh - 1))],
                      dim=-1)

        rij = pos_all[recv] - pos_all[send]
        dist = torch.linalg.norm(rij, dim=-1)
        rbf = bessel_basis(dist, cfg.n_rbf, cfg.r_cut)          # (E, n_rbf)
        y_sh = so3.spherical_harmonics(cfg.l_max, rij)          # (E, S)
        edge_mask = self._edge_mask(dist)                       # (E,)

        node_out = torch.zeros((n, cfg.d_readout), dtype=torch.float32,
                               device=pos.device)
        for layer in params["layers"]:
            w_r = self._radial(layer, rbf, edge_mask)            # (E, C, P)
            x_all = x if mesh is None else all_gather_grad(x, mesh, axes)
            x_send = gather_rows(x_all, send)                    # (E, C, S)
            phi = self._edge_tp(x_send, y_sh, w_r, cgs)
            # A-basis: scatter-sum messages to receivers
            a = segment_sum(phi, recv, n_all)                    # (N, C, S)
            if mesh is not None:
                a = psum_scatter(a, mesh, axes)
            a = self._mix_per_l(layer["a_mix"], a)
            # higher-order B-basis (correlation order 3)
            b2 = self._pairwise(a, a, layer["u2"], cgs)
            b3 = self._pairwise(b2, a, layer["u3"], cgs)
            msg = (self._mix_per_l(layer["m1"], a)
                   + self._mix_per_l(layer["m2"], b2)
                   + self._mix_per_l(layer["m3"], b3))
            x = x + msg                                          # residual
            node_out = node_out + self._readout(layer, x)

        out = {"node_out": node_out}
        if "graph_id" in graph:
            g = int(graph["n_graphs"])
            if mesh is None:
                out["energy"] = segment_sum(node_out[:, 0],
                                            graph["graph_id"], g)
            else:
                part = segment_sum(node_out[:, 0], graph["graph_id"],
                                   g + 1)[:g]
                out["energy"] = reduce_from(part, mesh, axes)
        return out

    # ---------------------------------------------------------- losses
    def energy_loss(self, params, graph, mesh=None
                    ) -> Tuple[torch.Tensor, Dict]:
        """Mean squared error of the graphs' energies; on a ``mesh``
        every rank computes it from the summed energies (``graph["energy"]``
        whole there)."""
        out = self.apply(params, graph, mesh)
        err = out["energy"] - graph["energy"]
        loss = torch.mean(torch.square(err))
        return loss, {"loss": loss, "rmse": torch.sqrt(loss)}

    def node_class_loss(self, params, graph, mesh=None
                        ) -> Tuple[torch.Tensor, Dict]:
        """Masked mean cross-entropy and accuracy over the nodes; on a
        ``mesh`` the masked sums are summed over every rank first."""
        out = self.apply(params, graph, mesh)
        logits = out["node_out"]
        labels = graph["labels"].long()
        mask = graph.get("label_mask")
        if mask is None:
            mask = torch.ones(labels.shape, dtype=torch.float32,
                              device=labels.device)
        logz = torch.logsumexp(logits, dim=-1)
        # advanced indexing, not ``gather``: its backward is a sorted
        # index_put_, not an atomic scatter-add
        gold = logits[torch.arange(labels.shape[0], device=labels.device),
                      labels]
        sums = torch.stack([
            torch.sum((logz - gold) * mask), torch.sum(mask),
            torch.sum((torch.argmax(logits, dim=-1) == labels) * mask)])
        if mesh is not None:
            sums = reduce_from(sums, mesh, tuple(mesh.axis_names))
        denom = torch.clamp(sums[1], min=1.0)
        loss = sums[0] / denom
        acc = sums[2] / denom
        return loss, {"loss": loss, "acc": acc}
