"""DeepFM [arXiv:1703.04247]: FM interaction branch + deep MLP sharing
the same field embeddings.  n_sparse=39, embed_dim=10, MLP 400-400-400.

Parameters are the JAX package's tree (``fields``, ``first_order``,
``mlp``, ``bias``), so ``repro_torch.convert.deepfm_params_from_numpy``
carries a JAX model across leaf for leaf.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import RecsysConfig
from repro_torch.core.api import Embedding
from repro_torch.core.types import EmbeddingConfig
from repro_torch.models.recsys.fields import FieldEmbeddings
from repro_torch.nn import initializers as init_lib
from repro_torch.nn.mlp import mlp, mlp_init


class DeepFM:
    def __init__(self, cfg: RecsysConfig, device="cuda"):
        self.cfg = cfg
        self.fields = FieldEmbeddings(cfg, device=device)
        self.device = self.fields.device
        # first-order weights: one scalar per categorical value — these
        # stay full (dim-1 tables are already minimal).
        self.first_order = [
            Embedding(EmbeddingConfig(vocab_size=v, dim=1),
                      device=self.device)
            for v in cfg.field_vocab_sizes]

    def init(self, gen: Optional[torch.Generator] = None,
             dtype=torch.float32) -> Dict:
        """Params on the generator's device (default: seeded 0 on the
        model's device), drawn in order: field tables, first-order
        tables, MLP; the bias starts at zero."""
        cfg = self.cfg
        if gen is None:
            gen = init_lib.generator(self.device, 0)
        d_in = cfg.n_sparse * cfg.embed_dim
        return {
            "fields": self.fields.init(gen, dtype),
            "first_order": {f"f{i}": e.init(gen, dtype=dtype)
                            for i, e in enumerate(self.first_order)},
            "mlp": mlp_init(gen, (d_in,) + tuple(cfg.mlp_dims) + (1,),
                            dtype=dtype),
            "bias": torch.zeros((), dtype=dtype, device=gen.device),
        }

    @staticmethod
    def _fm(x: torch.Tensor) -> torch.Tensor:
        """Second-order FM term via the sum-square trick.
        x: (B, F, d) -> (B,)   0.5 * ((Σv)² − Σv²) summed over d."""
        s = torch.sum(x, dim=1)
        sq = torch.sum(torch.square(x), dim=1)
        return 0.5 * torch.sum(torch.square(s) - sq, dim=-1)

    def _logit(self, params: Dict, x: torch.Tensor,
               fo: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        fm = self._fm(x)
        deep = mlp(params["mlp"], x.reshape(b, -1), act="relu")[:, 0]
        return fm + deep + fo + params["bias"]

    def _first_order(self, params: Dict, ids: torch.Tensor,
                     mesh=None) -> torch.Tensor:
        total = torch.zeros((ids.shape[0],), dtype=torch.float32,
                            device=ids.device)
        for i, e in enumerate(self.first_order):
            o, _ = e.apply(params["first_order"][f"f{i}"], ids[:, i],
                           mesh=mesh)
            total = total + o[:, 0]
        return total

    def apply(self, params: Dict, batch: Dict, mesh=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        ids = batch["sparse_ids"]
        x, aux = self.fields.apply(params["fields"], ids, mesh=mesh)
        fo = self._first_order(params, ids, mesh=mesh)
        return self._logit(params, x, fo), aux

    def serve(self, params: Dict, artifacts: Dict, batch: Dict,
              mesh=None) -> torch.Tensor:
        """Logits from the served artifacts; with a ``mesh``, this rank's
        (``launch/cells.py::recsys_serve_cell``): the fields through
        :meth:`FieldEmbeddings.serve`, the first-order tables (whole
        params under the recsys rules) through the row gather."""
        ids = batch["sparse_ids"]
        x = self.fields.serve(artifacts, ids, mesh=mesh)
        fo = self._first_order(params, ids, mesh=mesh)
        return self._logit(params, x, fo)

    def loss(self, params: Dict, batch: Dict, mesh=None
             ) -> Tuple[torch.Tensor, Dict]:
        """Mean binary cross-entropy on the logits, written as the JAX
        package writes it (``max(z, 0) - z*y + log1p(exp(-|z|))``), plus
        the fields' aux loss.

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
