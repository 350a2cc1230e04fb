"""Multi-field categorical embedding collection + EmbeddingBag.

Large-vocab fields are compressed with the paper's MGQE (or DPQ, RQ, or
one of the baselines it is compared against); small fields stay full —
quantizing a 100-row table is pure overhead.

Sum and mean CSR pooling route through the dispatched ``embedding_bag``
op (the CUDA kernel for tensors on the card: each table row read once,
each bag written once); max mode has no kernel and stays on plain ops,
as it does in the JAX package.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import RecsysConfig
from repro_torch.core.api import Embedding, resolve_device
from repro_torch.core.partition import frequency_boundaries
from repro_torch.core.types import EmbeddingConfig
from repro_torch.kernels.embedding_bag import bag


def field_embedding_config(cfg: RecsysConfig, vocab: int) -> EmbeddingConfig:
    """Per-field embedding spec: MGQE/DPQ for big fields, full for small."""
    kind = cfg.embed_kind
    sharded = cfg.sharded_embedding and vocab >= cfg.mgqe_min_vocab
    kb = cfg.kernel_backend
    if vocab < cfg.mgqe_min_vocab or kind == "full":
        return EmbeddingConfig(vocab_size=vocab, dim=cfg.embed_dim,
                               sharded_rows=sharded, kernel_backend=kb)
    if kind == "dpq":
        return EmbeddingConfig(
            vocab_size=vocab, dim=cfg.embed_dim, kind="dpq",
            num_subspaces=cfg.num_subspaces, num_centroids=cfg.num_centroids,
            sharded_rows=sharded, kernel_backend=kb)
    if kind == "mgqe":
        bounds = frequency_boundaries(vocab, (cfg.tier_head_fraction,))
        return EmbeddingConfig(
            vocab_size=vocab, dim=cfg.embed_dim, kind="mgqe",
            num_subspaces=cfg.num_subspaces, num_centroids=cfg.num_centroids,
            tier_boundaries=bounds,
            tier_num_centroids=(cfg.num_centroids, cfg.tier_tail_centroids),
            sharded_rows=sharded, kernel_backend=kb)
    if kind == "rq":
        # residual quantization: num_subspaces doubles as the stage
        # count M (the same code-bytes-per-row knob as PQ's D)
        return EmbeddingConfig(
            vocab_size=vocab, dim=cfg.embed_dim, kind="rq",
            num_levels=cfg.num_subspaces, num_centroids=cfg.num_centroids,
            sharded_rows=sharded, kernel_backend=kb)
    # baselines for the comparison sweeps (no kernel, so no backend)
    if kind == "lrf":
        return EmbeddingConfig(vocab_size=vocab, dim=cfg.embed_dim,
                               kind="lrf", rank=max(2, cfg.embed_dim // 4))
    if kind == "sq":
        return EmbeddingConfig(vocab_size=vocab, dim=cfg.embed_dim,
                               kind="sq", sq_bits=8)
    if kind == "hash":
        return EmbeddingConfig(vocab_size=vocab, dim=cfg.embed_dim,
                               kind="hash", hash_buckets=max(64, vocab // 4))
    raise ValueError(f"no field embedding for embed_kind {kind!r}")


class FieldEmbeddings:
    """One embedding table per sparse field, on ``device`` (default:
    the card; ``device="cpu"`` runs the plain ops)."""

    def __init__(self, cfg: RecsysConfig, device="cuda"):
        self.cfg = cfg
        if len(cfg.field_vocab_sizes) != cfg.n_sparse:
            raise ValueError(
                f"{len(cfg.field_vocab_sizes)} field vocab sizes for "
                f"n_sparse={cfg.n_sparse} fields")
        self.device = resolve_device(device)
        self.embs: List[Embedding] = [
            Embedding(field_embedding_config(cfg, v), device=self.device)
            for v in cfg.field_vocab_sizes]

    def init(self, gen: torch.Generator,
             dtype: Optional[torch.dtype] = None) -> Dict:
        """Every field's params, drawn from ``gen`` field by field."""
        return {f"f{i}": e.init(gen, dtype=dtype)
                for i, e in enumerate(self.embs)}

    def apply(self, params: Dict, ids: torch.Tensor, mesh=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """ids (B, F) -> ((B, F, d), aux_loss); with a ``mesh``, from this
        rank's params, every table read as its placement left it."""
        outs = []
        aux = torch.zeros((), dtype=torch.float32, device=ids.device)
        for i, e in enumerate(self.embs):
            o, a = e.apply(params[f"f{i}"], ids[:, i], mesh=mesh)
            outs.append(o)
            aux = aux + a
        return torch.stack(outs, dim=1), aux

    def export(self, params: Dict) -> Dict:
        return {f"f{i}": e.export(params[f"f{i}"])
                for i, e in enumerate(self.embs)}

    def serve(self, artifacts: Dict, ids: torch.Tensor, mesh=None
              ) -> torch.Tensor:
        """ids (B, F) -> (B, F, d) from the served artifacts; with a
        ``mesh``, ``ids`` are this rank's data shard and ``artifacts``
        this rank's (``sharding/rules.py::recsys_artifact_specs``): a
        field kept whole is decoded here, a row-split code table read
        through the per-rank quantized gather (``Embedding.serve(...,
        per_rank=True)``), a row-split full table through the row gather
        (``sharding/gather.py``).  The placement decides, as the row
        gather's does."""
        outs = [serve_placed(e, artifacts[f"f{i}"], ids[:, i], mesh)
                for i, e in enumerate(self.embs)]
        return torch.stack(outs, dim=1)

    def artifact_struct(self) -> Dict:
        """Meta-device tensors shaped like the serving artifacts."""
        return {f"f{i}": e.serving_artifact_struct()
                for i, e in enumerate(self.embs)}

    def serving_size_bits(self) -> int:
        return sum(e.serving_size_bits() for e in self.embs)

    def full_size_bits(self) -> int:
        return sum(v * self.cfg.embed_dim * 32
                   for v in self.cfg.field_vocab_sizes)


def serve_placed(emb: Embedding, artifact: Dict, ids: torch.Tensor,
                 mesh=None) -> torch.Tensor:
    """``emb``'s served rows of ``ids`` from ``artifact`` as its placement
    over ``mesh`` left this rank (:meth:`FieldEmbeddings.serve`): whole
    (every rows leaf holds the vocabulary), decoded here; else this
    rank's row block of a code table (per-rank quantized gather) or of
    a full table (the row gather; no other baseline has a split
    path)."""
    rows = emb.cfg.vocab_size
    leaves = [t for name, t in artifact.items()
              if name in ("codes", "emb", "q", "u")
              and isinstance(t, torch.Tensor)]
    if mesh is None or all(t.shape[0] == rows for t in leaves):
        return emb.serve(artifact, ids)
    if emb.scheme.supports_sharded_codes:
        return emb.serve(artifact, ids, mesh=mesh, per_rank=True)
    table = artifact.get("emb")
    if set(artifact) != {"emb"} or table.shape[0] * mesh.shape[
            "model"] != rows:
        raise ValueError(f"a {emb.cfg.kind!r} artifact split over model "
                         f"has no sharded serving path (only a full table "
                         f"of the vocabulary's rows does)")
    from repro_torch.sharding.gather import placed_row_gather
    return placed_row_gather(table, ids, mesh, rows)


# ----------------------------------------------------------------------
# EmbeddingBag: ragged multi-hot pooled lookup.
# ----------------------------------------------------------------------

def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  segment_ids: torch.Tensor, num_bags: int,
                  weights: Optional[torch.Tensor] = None, mode: str = "sum",
                  backend: Optional[str] = None) -> torch.Tensor:
    """CSR-style bag: ids (nnz,), segment_ids (nnz,) sorted ascending,
    -> pooled (num_bags, d).  mode: sum | mean | max.

    sum/mean run through the dispatched fused op (gather + segment sum
    in one pass); max has no fused kernel and stays on plain ops, where
    a bag with no ids is -inf (the identity of max, as JAX's
    ``segment_max`` leaves it).
    """
    if mode == "max":
        rows = table.index_select(0, ids.reshape(-1).long())   # (nnz, d)
        if weights is not None:
            rows = rows * weights[:, None]
        out = torch.full((num_bags, rows.shape[1]), float("-inf"),
                         dtype=rows.dtype, device=rows.device)
        seg = segment_ids.reshape(-1, 1).long().expand_as(rows)
        return out.scatter_reduce(0, seg, rows, reduce="amax")
    pooled = bag(table, ids, segment_ids, num_bags, weights, backend=backend)
    if mode == "mean":
        # counted in the pooled dtype, one rounded add per id, as JAX's
        # segment_sum counts
        ones = torch.ones(ids.shape, dtype=pooled.dtype, device=ids.device)
        counts = torch.zeros((num_bags,), dtype=pooled.dtype,
                             device=ids.device).index_put(
                                 (segment_ids.reshape(-1).long(),), ones,
                                 accumulate=True)
        pooled = pooled / torch.clamp(counts, min=1.0)[:, None]
    return pooled


def embedding_bag_padded(table: torch.Tensor, ids: torch.Tensor,
                         mode: str = "mean") -> torch.Tensor:
    """Dense padded bag: ids (B, L) with -1 padding -> (B, d)."""
    valid = ids >= 0
    safe = torch.where(valid, ids, torch.zeros_like(ids)).long()
    rows = table.index_select(0, safe.reshape(-1)).reshape(
        tuple(ids.shape) + (table.shape[-1],))                # (B, L, d)
    rows = rows * valid[..., None].to(rows.dtype)
    pooled = torch.sum(rows, dim=1)
    if mode == "mean":
        n = torch.clamp(torch.sum(valid, dim=1, keepdim=True), min=1)
        pooled = pooled / n.to(pooled.dtype)
    return pooled
