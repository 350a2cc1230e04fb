"""Two-tower retrieval [Yi et al. RecSys'19]: user tower + item tower ->
dot product; trained with in-batch sampled softmax + logQ correction.

This is where MGQE's serving story peaks: the item corpus is stored as
PQ codes, and ``retrieval_topk`` scores a BATCH of users against 1M
candidates without ever materializing their vectors (ADC through the
retrieval index registry, ``repro_torch.retrieval``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import RecsysConfig
from repro_torch.core.api import Embedding
from repro_torch.models.recsys.fields import field_embedding_config
from repro_torch.nn.mlp import mlp, mlp_init

# item rows per block of the item tower in ``encode_items``
ENCODE_ROWS = 65536


class TwoTower:
    def __init__(self, cfg: RecsysConfig, device="cuda"):
        self.cfg = cfg
        self.user_emb = Embedding(field_embedding_config(cfg, cfg.n_users),
                                  device=device)
        self.item_emb = Embedding(field_embedding_config(cfg, cfg.n_items),
                                  device=device)
        self.device = self.user_emb.device

    def init(self, gen: torch.Generator = None,
             dtype=torch.float32) -> Dict:
        """Params on the generator's device (default: seeded 0 on the
        model's device), drawn in order: user table, item table, user
        MLP, item MLP."""
        if gen is None:
            gen = self.user_emb.generator()
        dims = (self.cfg.embed_dim,) + tuple(self.cfg.tower_mlp)
        return {
            "user_emb": self.user_emb.init(gen, dtype),
            "item_emb": self.item_emb.init(gen, dtype),
            "user_mlp": mlp_init(gen, dims, dtype=dtype),
            "item_mlp": mlp_init(gen, dims, dtype=dtype),
        }

    # ------------------------------------------------------------ towers
    def user_vec(self, params, user_ids, mesh=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        e, aux = self.user_emb.apply(params["user_emb"], user_ids, mesh=mesh)
        v = mlp(params["user_mlp"], e, act="relu")
        return _l2norm(v), aux

    def item_vec(self, params, item_ids, mesh=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        e, aux = self.item_emb.apply(params["item_emb"], item_ids, mesh=mesh)
        v = mlp(params["item_mlp"], e, act="relu")
        return _l2norm(v), aux

    # ------------------------------------------------------------- train
    def loss(self, params: Dict, batch: Dict, mesh=None
             ) -> Tuple[torch.Tensor, Dict]:
        """In-batch sampled softmax with logQ correction.

        batch: user_ids (B,), item_ids (B,), item_logq (B,) — log of
        each item's sampling probability (its empirical frequency).

        Under a ``mesh`` the batch is this rank's data shard and the
        softmax still runs over the GLOBAL batch's items, as it does
        under the JAX package's GSPMD step: the item vectors and their
        logQ are all-gathered over the data axes (the vectors with a
        backward, ``all_gather_grad``), each user's gold item sits at
        its global position, and the loss is the mean over this rank's
        users (the step weights it by B_local / B_global)."""
        u, aux_u = self.user_vec(params, batch["user_ids"], mesh)
        v, aux_v = self.item_vec(params, batch["item_ids"], mesh)
        logq, gold_at = batch["item_logq"], 0
        if mesh is not None:
            from repro_torch.sharding.collectives import (all_gather,
                                                          all_gather_grad)
            from repro_torch.sharding.gather import (data_axes_of,
                                                     data_shard_index)
            axes = data_axes_of(mesh, "model")
            gold_at = data_shard_index(mesh, axes) * v.shape[0]
            v, logq = all_gather_grad(v, mesh, axes), all_gather(
                logq, mesh, axes)
        logits = (u @ v.T) * INV_TEMPERATURE - logq[None, :]
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.diagonal(logits, offset=gold_at)
        sm = torch.mean(logz - gold)
        loss = sm + aux_u + aux_v
        return loss, {"loss": loss, "softmax": sm, "aux": aux_u + aux_v}

    # ------------------------------------------------------------- serve
    def retrieval_scores(self, params: Dict, user_id: torch.Tensor,
                         cand_vectors: torch.Tensor) -> torch.Tensor:
        """Baseline: query (1,) against precomputed candidate tower
        outputs (N, dim_out) — a dense matvec reading the full matrix."""
        u, _ = self.user_vec(params, user_id)
        return cand_vectors @ u[0]

    def encode_items(self, params: Dict, item_ids: torch.Tensor,
                     rows: int = ENCODE_ROWS) -> torch.Tensor:
        """Item tower outputs (N, dim_out), computed over fixed blocks
        of ``rows`` items.  Every op of the tower works row by row, so
        the result equals one shot; one shot over 1M items would hold
        the quantize distances (1M x D x K f32, 16.4 GB at two-tower's
        D=16, K=256) and their mask at once."""
        return torch.cat([self.item_vec(params, item_ids[i:i + rows])[0]
                          for i in range(0, item_ids.shape[0], rows)])

    def build_index(self, gen: torch.Generator, params: Dict,
                    item_ids: torch.Tensor, index_cfg=None) -> Tuple:
        """Offline: run the item tower over the corpus and build a
        retrieval index over the *tower outputs* through the index
        registry — any registered kind (``flat_pq``, ``ivf_pq``); the
        artifact lies on the outputs' device.  Returns ``(index,
        artifact)``."""
        from repro_torch.retrieval import IndexConfig, get_index
        index = get_index(index_cfg or IndexConfig())
        vecs = self.encode_items(params, item_ids)
        return index, index.build(gen, vecs)

    def retrieval_topk(self, params: Dict, index, artifact: Dict,
                       user_ids: torch.Tensor, k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched top-k retrieval: user_ids (B,) -> (scores (B, k),
        item ids (B, k)) through the index's batched search — one
        user-tower pass + one pass over the code stream for the whole
        batch (``ivf_pq``: the probed lists only).  With no mesh (the
        only case ported) this is ``index.search``, as the JAX
        package's ``sharded_topk`` is."""
        u, _ = self.user_vec(params, user_ids)
        return index.search(artifact, u, k)

    # -------- single-query ADC compat layer (pre-registry callers) ----
    def build_adc_corpus(self, gen: torch.Generator, params: Dict,
                         item_ids: torch.Tensor, num_subspaces: int = 8,
                         num_centroids: int = 256) -> Dict:
        """Offline: PQ-code the corpus tower outputs (exact flat ADC),
        a thin wrapper over ``build_index`` with a ``flat_pq`` config."""
        from repro_torch.retrieval import IndexConfig
        _, artifact = self.build_index(
            gen, params, item_ids,
            IndexConfig(kind="flat_pq", num_subspaces=num_subspaces,
                        num_centroids=num_centroids))
        return artifact

    def retrieval_scores_adc(self, params: Dict, corpus_artifact: Dict,
                             user_id: torch.Tensor) -> torch.Tensor:
        """Score one user against the PQ-coded corpus via the pq_score
        kernel: reads N*D bytes of codes instead of N*dim*4 bytes of
        vectors.  user_id (1,) -> scores (N,)."""
        from repro_torch.retrieval.flat_pq import adc_scores
        u, _ = self.user_vec(params, user_id)
        return adc_scores(corpus_artifact, u[0])


INV_TEMPERATURE = 20.0  # softmax temperature 0.05


def _l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp(norm, min=eps)
