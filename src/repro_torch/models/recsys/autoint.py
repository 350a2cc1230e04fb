"""AutoInt [arXiv:1810.11921]: multi-head self-attention over field
embeddings.  n_sparse=39, embed_dim=16, 3 attn layers, 2 heads, d_attn=32.

Parameters are the JAX package's tree (``fields``, ``layers``,
``w_out``), so ``repro_torch.convert.autoint_params_from_numpy`` carries
a JAX model across leaf for leaf.  The attention over the field axis is
plain matmuls and a softmax, as the JAX package's is einsum outside any
Pallas kernel; the fields' export and serving go through the ported
kernels (``dpq_assign``, ``mgqe_decode``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import RecsysConfig
from repro_torch.models.recsys.fields import FieldEmbeddings
from repro_torch.nn import initializers as init


def _interact_layer_init(gen: torch.Generator, d_in: int, n_heads: int,
                         d_attn: int, dtype=torch.float32) -> dict:
    """wq, wk, wv, wres drawn in that order, N(0, 1/d_in)."""
    s = d_in ** -0.5
    shape = (d_in, n_heads * d_attn)
    return {name: init.normal(gen, shape, s, dtype)
            for name in ("wq", "wk", "wv", "wres")}


def _interact_layer(p: dict, x: torch.Tensor, n_heads: int,
                    d_attn: int) -> torch.Tensor:
    """x (B, F, d_in) -> (B, F, n_heads*d_attn); full bidirectional attn
    over the (tiny) field axis."""
    b, f, _ = x.shape
    q = (x @ p["wq"]).reshape(b, f, n_heads, d_attn)
    k = (x @ p["wk"]).reshape(b, f, n_heads, d_attn)
    v = (x @ p["wv"]).reshape(b, f, n_heads, d_attn)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * (d_attn ** -0.5)
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, f, -1)
    return torch.relu(o + x @ p["wres"])


class AutoInt:
    def __init__(self, cfg: RecsysConfig, device="cuda"):
        self.cfg = cfg
        self.fields = FieldEmbeddings(cfg, device=device)
        self.device = self.fields.device

    def init(self, gen: Optional[torch.Generator] = None,
             dtype=torch.float32) -> Dict:
        """Params on the generator's device (default: seeded 0 on the
        model's device), drawn in order: field tables, each interacting
        layer, ``w_out`` (its bias starts at zero)."""
        cfg = self.cfg
        if gen is None:
            gen = init.generator(self.device, 0)
        d_attn_out = cfg.n_attn_heads * cfg.d_attn
        fields = self.fields.init(gen, dtype)
        layers = []
        d_in = cfg.embed_dim
        for _ in range(cfg.n_attn_layers):
            layers.append(_interact_layer_init(gen, d_in, cfg.n_attn_heads,
                                               cfg.d_attn, dtype))
            d_in = d_attn_out
        return {
            "fields": fields,
            "layers": layers,
            "w_out": init.dense_init(gen, cfg.n_sparse * d_attn_out, 1,
                                     dtype=dtype),
        }

    def _interact(self, params: Dict, x: torch.Tensor) -> torch.Tensor:
        for p in params["layers"]:
            x = _interact_layer(p, x, self.cfg.n_attn_heads, self.cfg.d_attn)
        b = x.shape[0]
        return init.dense(params["w_out"], x.reshape(b, -1))[:, 0]

    def apply(self, params: Dict, batch: Dict, mesh=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """batch["sparse_ids"] (B, F) -> (logits (B,), aux)."""
        x, aux = self.fields.apply(params["fields"], batch["sparse_ids"],
                                   mesh=mesh)
        return self._interact(params, x), aux

    def serve(self, params: Dict, artifacts: Dict, batch: Dict,
              mesh=None) -> torch.Tensor:
        """Logits from the served artifacts; with a ``mesh``, this rank's
        (:meth:`FieldEmbeddings.serve`)."""
        x = self.fields.serve(artifacts, batch["sparse_ids"], mesh=mesh)
        return self._interact(params, x)

    def loss(self, params: Dict, batch: Dict, mesh=None
             ) -> Tuple[torch.Tensor, Dict]:
        """Mean binary cross-entropy on the logits, written as the JAX
        package writes it, plus the fields' aux loss.

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

