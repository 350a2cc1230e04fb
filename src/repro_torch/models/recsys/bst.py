"""Behavior Sequence Transformer (Alibaba) [arXiv:1905.06874]:
transformer block over the user's last-N item sequence + target item,
then MLP.  embed_dim=32, seq_len=20, 1 block, 8 heads, MLP 1024-512-256.

Parameters are the JAX package's tree (``item_emb``, ``pos_emb``,
``blocks``, ``mlp``), so ``repro_torch.convert.bst_params_from_numpy``
carries a JAX model across leaf for leaf.  The block's attention (8
heads of width 4 over 21 positions) is plain matmuls and a softmax, as
the JAX package's is einsum outside any Pallas kernel; the item table's
export and serving go through the ported kernels (``dpq_assign``,
``mgqe_decode``: one launch for the whole (B, seq_len + 1) id block).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import RecsysConfig
from repro_torch.core.api import Embedding
from repro_torch.models.recsys.fields import field_embedding_config
from repro_torch.nn import initializers as init
from repro_torch.nn.mlp import mlp, mlp_init
from repro_torch.nn.norm import layer_norm, layer_norm_init


def _block_init(gen: torch.Generator, d: int, dtype=torch.float32) -> dict:
    """wq, wk, wv, wo, then the FFN drawn in that order; the norms start
    at (1, 0)."""
    s = d ** -0.5
    p = {name: init.normal(gen, (d, d), s, dtype)
         for name in ("wq", "wk", "wv", "wo")}
    p["ln1"] = layer_norm_init(d, dtype, device=gen.device)
    p["ln2"] = layer_norm_init(d, dtype, device=gen.device)
    p["ffn"] = mlp_init(gen, (d, 4 * d, d), dtype=dtype)
    return p


def _block(p: dict, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, d = x.shape
    hd = d // n_heads
    h = layer_norm(p["ln1"], x)
    q = (h @ p["wq"]).reshape(b, s, n_heads, hd)
    k = (h @ p["wk"]).reshape(b, s, n_heads, hd)
    v = (h @ p["wv"]).reshape(b, s, n_heads, hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * (hd ** -0.5)
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, d)
    x = x + o @ p["wo"]
    h2 = layer_norm(p["ln2"], x)
    return x + mlp(p["ffn"], h2, act="relu")


class BST:
    def __init__(self, cfg: RecsysConfig, device="cuda"):
        self.cfg = cfg
        self.item_emb = Embedding(field_embedding_config(cfg, cfg.n_items),
                                  device=device)
        self.device = self.item_emb.device

    def init(self, gen: Optional[torch.Generator] = None,
             dtype=torch.float32) -> Dict:
        """Params on the generator's device (default: seeded 0 on the
        model's device), drawn in order: item table, ``pos_emb``, each
        block, the MLP."""
        cfg = self.cfg
        if gen is None:
            gen = self.item_emb.generator()
        s = cfg.seq_len + 1   # history + target
        item_emb = self.item_emb.init(gen, dtype)
        pos_emb = init.normal(gen, (s, cfg.embed_dim), 0.02, dtype)
        blocks = [_block_init(gen, cfg.embed_dim, dtype)
                  for _ in range(cfg.n_blocks)]
        return {
            "item_emb": item_emb,
            "pos_emb": pos_emb,
            "blocks": blocks,
            "mlp": mlp_init(gen, (s * cfg.embed_dim,) + tuple(cfg.tower_mlp)
                            + (1,), dtype=dtype),
        }

    def _trunk(self, params: Dict, seq_e: torch.Tensor) -> torch.Tensor:
        pos = params["pos_emb"]
        if pos.shape[0] != self.cfg.seq_len + 1:
            # the recsys rules' ``emb$`` places a pos_emb of >= 16·model
            # rows row-sharded; its plain broadcast cannot read a block
            raise ValueError(
                f"pos_emb holds {pos.shape[0]} of its "
                f"{self.cfg.seq_len + 1} rows: a row-sharded pos_emb "
                f"is read plainly, which a placed block cannot give")
        x = seq_e + pos[None]
        for p in params["blocks"]:
            x = _block(p, x, self.cfg.bst_heads)
        b = x.shape[0]
        return mlp(params["mlp"], x.reshape(b, -1), act="relu")[:, 0]

    @staticmethod
    def ids(batch: Dict) -> torch.Tensor:
        """hist_ids (B, L) and target_id (B,) -> (B, L + 1)."""
        return torch.cat([batch["hist_ids"], batch["target_id"][:, None]],
                         dim=1)

    def apply(self, params: Dict, batch: Dict, mesh=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """batch: hist_ids (B, L), target_id (B,) -> (logits, aux)."""
        e, aux = self.item_emb.apply(params["item_emb"], self.ids(batch),
                                     mesh=mesh)
        return self._trunk(params, e), aux

    def serve(self, params: Dict, artifact: Dict, batch: Dict,
              mesh=None) -> torch.Tensor:
        """Logits from the item table's served artifact; with a ``mesh``,
        this rank's (``fields.serve_placed``)."""
        from repro_torch.models.recsys.fields import serve_placed
        e = serve_placed(self.item_emb, artifact, self.ids(batch), mesh)
        return self._trunk(params, e)

    def loss(self, params: Dict, batch: Dict, mesh=None
             ) -> Tuple[torch.Tensor, Dict]:
        """Mean binary cross-entropy on the logits, written as the JAX
        package writes it, plus the item table's aux loss.

        Under a ``mesh`` the params are this rank's (``sharding/
        rules.py``) and the batch its data shard: the loss is this
        rank's mean, which the training step weights by B_local /
        B_global (``launch/cells.py``)."""
        logits, aux = self.apply(params, batch, mesh=mesh)
        y = batch["label"].to(torch.float32)
        bce = torch.mean(torch.maximum(logits, torch.zeros_like(logits))
                         - logits * y
                         + torch.log1p(torch.exp(-torch.abs(logits))))
        loss = bce + aux
        return loss, {"loss": loss, "bce": bce, "aux": aux}
