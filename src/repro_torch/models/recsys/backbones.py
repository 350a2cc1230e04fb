"""The paper's three backbone recommenders (§3.2): GMF, NeuMF, SASRec.

Embedding tables (user + item) go through repro_torch.core so every
compression scheme in §3.4 (FE / LRF / SQ / DPQ / MGQE) is a config
switch — these are the models the reproduction experiments train.

Parameters are the JAX package's tree, so
``repro_torch.convert.backbone_params_from_numpy`` carries a JAX model
across leaf for leaf.  Each model names its embedding tables in
``tables``; ``export`` turns the trained tables into serving artifacts
(``dpq_assign`` on the card for DPQ/MGQE), and ``score``/``trunk`` take
those artifacts in place of the training tables to score from the
served rows (``mgqe_decode`` on the card).  SASRec's attention is one
head of width d, plain ``matmul`` and softmax with a pad-aware mask, as
in the JAX package (``n_heads`` is read nowhere there either).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.api import Embedding, resolve_device
from repro_torch.core.partition import frequency_boundaries
from repro_torch.core.types import EmbeddingConfig
from repro_torch.nn import initializers as init
from repro_torch.nn.mlp import mlp, mlp_init
from repro_torch.nn.norm import layer_norm, layer_norm_init


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    model: str                  # gmf | neumf | sasrec
    n_users: int
    n_items: int
    dim: int = 64               # paper: d=64 for all methods
    embed_kind: str = "full"    # fe | lrf | sq | dpq | mgqe ...
    num_subspaces: int = 8      # D (varied for the size sweep)
    num_centroids: int = 256    # K=256 (paper default)
    tier_head_fraction: float = 0.1
    tier_tail_centroids: int = 64
    lrf_rank: int = 16
    sq_bits: int = 8
    # neumf
    mlp_dims: Tuple[int, ...] = (128, 64, 32)
    # sasrec
    maxlen: int = 50
    n_blocks: int = 2
    n_heads: int = 1

    def emb_config(self, vocab: int) -> EmbeddingConfig:
        k = self.embed_kind
        base = dict(vocab_size=vocab, dim=self.dim)
        if k == "full":
            return EmbeddingConfig(**base)
        if k == "lrf":
            return EmbeddingConfig(kind="lrf", rank=self.lrf_rank, **base)
        if k == "sq":
            return EmbeddingConfig(kind="sq", sq_bits=self.sq_bits, **base)
        if k == "hash":
            return EmbeddingConfig(kind="hash", hash_buckets=max(16, vocab // 5),
                                   **base)
        if k == "dpq":
            return EmbeddingConfig(kind="dpq", num_subspaces=self.num_subspaces,
                                   num_centroids=self.num_centroids, **base)
        if k == "mgqe":
            bounds = frequency_boundaries(vocab, (self.tier_head_fraction,))
            return EmbeddingConfig(
                kind="mgqe", num_subspaces=self.num_subspaces,
                num_centroids=self.num_centroids, tier_boundaries=bounds,
                tier_num_centroids=(self.num_centroids,
                                    self.tier_tail_centroids), **base)
        if k == "rq":
            # residual-quantization plugin (core/schemes/rq.py):
            # num_subspaces doubles as the stage count M
            return EmbeddingConfig(
                kind="rq", num_levels=self.num_subspaces,
                num_centroids=self.num_centroids, **base)
        raise ValueError(k)


class _Backbone:
    """What the three models share: the device, the default generator,
    the export of every table and the row lookup (training forward, or
    the served rows of exported artifacts)."""

    # the params' keys: the embedding tables, then every other leaf
    tables: Tuple[str, ...] = ()
    dense_keys: Tuple[str, ...] = ()

    def __init__(self, cfg: BackboneConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)

    def _embedding(self, vocab: int) -> Embedding:
        return Embedding(self.cfg.emb_config(vocab), device=self.device)

    def _gen(self, gen: Optional[torch.Generator]) -> torch.Generator:
        if gen is None:
            gen = init.generator(self.device, 0)
        return gen

    def export(self, params: Dict) -> Dict:
        """Serving artifacts of every table, keyed as the params."""
        return {name: getattr(self, name).export(params[name])
                for name in self.tables}

    def _rows(self, name: str, params: Dict, ids: torch.Tensor,
              artifacts: Optional[Dict]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(rows, aux loss) of table ``name``: the training forward, or,
        with ``artifacts``, the served rows and no aux loss."""
        emb = getattr(self, name)
        if artifacts is None:
            return emb.apply(params[name], ids)
        return (emb.serve(artifacts[name], ids),
                torch.zeros((), dtype=torch.float32, device=ids.device))

    def serving_size_bits(self) -> int:
        return sum(getattr(self, name).serving_size_bits()
                   for name in self.tables)


# ----------------------------------------------------------------------
# GMF (He et al. 2017): weighted elementwise product of user/item vecs.
# ----------------------------------------------------------------------

class GMF(_Backbone):
    tables = ("user_emb", "item_emb")
    dense_keys = ("w", "b")

    def __init__(self, cfg: BackboneConfig, device="cuda"):
        super().__init__(cfg, device)
        self.user_emb = self._embedding(cfg.n_users)
        self.item_emb = self._embedding(cfg.n_items)

    def init(self, gen: Optional[torch.Generator] = None) -> Dict:
        """Params on the generator's device (default: seeded 0 on the
        model's device), drawn in order: user table, item table, w."""
        gen = self._gen(gen)
        return {
            "user_emb": self.user_emb.init(gen),
            "item_emb": self.item_emb.init(gen),
            "w": init.normal(gen, (self.cfg.dim,), self.cfg.dim ** -0.5),
            "b": torch.zeros((), device=gen.device),
        }

    def score(self, params, user_ids, item_ids, artifacts=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        u, au = self._rows("user_emb", params, user_ids, artifacts)
        v, ai = self._rows("item_emb", params, item_ids, artifacts)
        return (u * v) @ params["w"] + params["b"], au + ai

    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        logits, aux = self.score(params, batch["user_ids"],
                                 batch["item_ids"])
        bce = _bce(logits, batch["label"])
        loss = bce + aux
        return loss, {"loss": loss, "bce": bce, "aux": aux}

    def mse_loss(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        """Regression form for the AAR-like relevance task."""
        pred, aux = self.score(params, batch["user_ids"],
                               batch["item_ids"])
        mse = torch.mean(torch.square(pred - batch["label"]))
        loss = mse + aux
        return loss, {"loss": loss, "mse": mse, "aux": aux}


# ----------------------------------------------------------------------
# NeuMF: GMF branch + MLP branch with separate embeddings.
# ----------------------------------------------------------------------

class NeuMF(_Backbone):
    tables = ("user_emb_g", "item_emb_g", "user_emb_m", "item_emb_m")
    dense_keys = ("mlp", "w_out")

    def __init__(self, cfg: BackboneConfig, device="cuda"):
        super().__init__(cfg, device)
        self.user_emb_g = self._embedding(cfg.n_users)
        self.item_emb_g = self._embedding(cfg.n_items)
        self.user_emb_m = self._embedding(cfg.n_users)
        self.item_emb_m = self._embedding(cfg.n_items)

    def init(self, gen: Optional[torch.Generator] = None) -> Dict:
        """Params drawn in order: the four tables, the MLP, w_out."""
        gen = self._gen(gen)
        cfg = self.cfg
        out = {name: getattr(self, name).init(gen) for name in self.tables}
        out["mlp"] = mlp_init(gen, (2 * cfg.dim,) + tuple(cfg.mlp_dims))
        out["w_out"] = init.dense_init(gen, cfg.dim + cfg.mlp_dims[-1], 1)
        return out

    def score(self, params, user_ids, item_ids, artifacts=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        ug, a1 = self._rows("user_emb_g", params, user_ids, artifacts)
        ig, a2 = self._rows("item_emb_g", params, item_ids, artifacts)
        um, a3 = self._rows("user_emb_m", params, user_ids, artifacts)
        im, a4 = self._rows("item_emb_m", params, item_ids, artifacts)
        gmf = ug * ig
        deep = mlp(params["mlp"], torch.cat([um, im], -1), act="relu",
                   final_act=True)
        out = init.dense(params["w_out"], torch.cat([gmf, deep], -1))
        return out[:, 0], a1 + a2 + a3 + a4

    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        logits, aux = self.score(params, batch["user_ids"],
                                 batch["item_ids"])
        bce = _bce(logits, batch["label"])
        loss = bce + aux
        return loss, {"loss": loss, "bce": bce, "aux": aux}


# ----------------------------------------------------------------------
# SASRec (Kang & McAuley 2018): causal self-attention next-item model.
# ----------------------------------------------------------------------

class SASRec(_Backbone):
    tables = ("item_emb",)
    dense_keys = ("pos_emb", "blocks", "final_ln")

    def __init__(self, cfg: BackboneConfig, device="cuda"):
        super().__init__(cfg, device)
        # +1 row: id 0 is the padding item; real items are 1..n_items
        self.item_emb = self._embedding(cfg.n_items + 1)

    def init(self, gen: Optional[torch.Generator] = None) -> Dict:
        """Params drawn in order: the item table, pos_emb, then each
        block's wq, wk, wv and FFN; the norms start at (1, 0)."""
        gen = self._gen(gen)
        cfg = self.cfg
        d = cfg.dim
        item_emb = self.item_emb.init(gen)
        pos_emb = init.normal(gen, (cfg.maxlen, d), 0.02)
        blocks = []
        for _ in range(cfg.n_blocks):
            blocks.append({
                "wq": init.normal(gen, (d, d), d ** -0.5),
                "wk": init.normal(gen, (d, d), d ** -0.5),
                "wv": init.normal(gen, (d, d), d ** -0.5),
                "ln1": layer_norm_init(d, device=gen.device),
                "ln2": layer_norm_init(d, device=gen.device),
                "ffn": mlp_init(gen, (d, d, d)),
            })
        return {
            "item_emb": item_emb,
            "pos_emb": pos_emb,
            "blocks": blocks,
            "final_ln": layer_norm_init(d, device=gen.device),
        }

    def trunk(self, params, seq_ids, artifacts=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """seq_ids (B, L) with 0 = pad -> hidden (B, L, d).  A query row
        whose keys are all pad (a left-padded row's first positions, or
        an all-pad row) gets the uniform softmax JAX gives it: masked
        scores are -1e30, not -inf, which would give NaN."""
        cfg = self.cfg
        e, aux = self._rows("item_emb", params, seq_ids, artifacts)
        x = e * (cfg.dim ** 0.5) + params["pos_emb"][None]
        pad = seq_ids == 0
        l = seq_ids.shape[1]
        causal = torch.tril(torch.ones((l, l), dtype=torch.bool,
                                       device=seq_ids.device))
        mask = causal[None] & (~pad)[:, None, :]
        for p in params["blocks"]:
            h = layer_norm(p["ln1"], x)
            q, k, v = h @ p["wq"], h @ p["wk"], h @ p["wv"]
            scores = torch.einsum("bqd,bkd->bqk", q, k) * (cfg.dim ** -0.5)
            scores = scores.masked_fill(~mask, -1e30)
            probs = torch.softmax(scores, dim=-1)
            x = x + torch.einsum("bqk,bkd->bqd", probs, v)
            x = x + mlp(p["ffn"], layer_norm(p["ln2"], x), act="relu")
        x = layer_norm(params["final_ln"], x)
        x = x * (~pad)[..., None]
        return x, aux

    def score_items(self, params, hidden, item_ids,
                    artifacts=None) -> torch.Tensor:
        """Dot-product scores of hidden states against given items.
        hidden (..., d), item_ids (...,) aligned."""
        e, _ = self._rows("item_emb", params, item_ids, artifacts)
        return torch.sum(hidden * e, dim=-1)

    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        """batch: seq (B, L), pos (B, L), neg (B, L); 0 = pad.

        SASRec's BCE over (positive, sampled-negative) at every valid
        position (Kang & McAuley 2018, eq. 6)."""
        hidden, aux = self.trunk(params, batch["seq"])
        s_pos = self.score_items(params, hidden, batch["pos"])
        s_neg = self.score_items(params, hidden, batch["neg"])
        valid = (batch["pos"] != 0).to(torch.float32)
        zero = torch.zeros_like(s_pos)
        bce = (torch.maximum(s_pos, zero) - s_pos
               + torch.log1p(torch.exp(-torch.abs(s_pos)))
               + torch.maximum(s_neg, zero)
               + torch.log1p(torch.exp(-torch.abs(s_neg))))
        bce = torch.sum(bce * valid) / torch.clamp(torch.sum(valid), min=1.0)
        loss = bce + aux
        return loss, {"loss": loss, "bce": bce, "aux": aux}


def _bce(logits, y):
    y = y.to(torch.float32)
    return torch.mean(torch.maximum(logits, torch.zeros_like(logits))
                      - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def make_backbone(cfg: BackboneConfig, device="cuda"):
    return {"gmf": GMF, "neumf": NeuMF, "sasrec": SASRec}[cfg.model](
        cfg, device=device)
