"""Exact ADC over a PQ-coded corpus — the ``flat_pq`` index kind.

For the retrieval cell (B queries x 1M candidates) the paper's PQ
machinery compresses the *candidate tower outputs*: fit per-subspace
k-means over the corpus vectors once offline, store only codes, and
score queries by LUT summation — ``score(i) = sum_d <q_d,
c_codes[i,d]^(d)>`` — which is exact for the dot product up to
quantization error and never reconstructs a candidate vector
(Jegou et al.'s PQ-ADC).

The hot loop is the ``pq_topk`` / ``pq_score_batched`` kernel family;
the corpus is encoded by the ``dpq_assign`` kernel.  This module owns
the offline coding step (Lloyd's k-means per subspace, plain PyTorch)
and the ``flat_pq`` :class:`~repro_torch.retrieval.base.Index` around
it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.dpq_assign import assign as dpq_assign_op
from repro_torch.kernels.pq_score import (INVALID_ID, score_candidates,
                                          score_candidates_batched,
                                          topk_candidates)
from repro_torch.retrieval.base import Index, IndexConfig, register_index


def initial_centroids(gen: torch.Generator, vectors: torch.Tensor,
                      num_subspaces: int, num_centroids: int) -> torch.Tensor:
    """K distinct random corpus rows per subspace -> (D, K, S).

    Sampled WITHOUT replacement, as the JAX package does: duplicate
    seeds collapse into dead centroids that Lloyd's update can never
    split.  Tiny corpora with n < K sample with replacement."""
    n, d = vectors.shape
    if d % num_subspaces:
        raise ValueError(
            f"dim {d} does not divide into {num_subspaces} subspaces")
    s = d // num_subspaces
    rows = []
    for _ in range(num_subspaces):
        if n < num_centroids:
            rows.append(torch.randint(0, n, (num_centroids,), generator=gen,
                                      device=gen.device))
        else:
            rows.append(torch.randperm(n, generator=gen, device=gen.device
                                       )[:num_centroids])
    idx = torch.stack(rows).to(vectors.device)                # (D, K)
    sub = torch.arange(num_subspaces, device=vectors.device)[:, None]
    return vectors.reshape(n, num_subspaces, s)[idx, sub]     # (D, K, S)


# the largest (rows, K) distance matrix one Lloyd step materialises
# (float32: 256 MB); a larger fit walks its rows in chunks of this many
# elements, so the coarse fit of an IVF index over 1M rows at nlist =
# 1,000 holds ~1 GB of temporaries instead of ~16 GB
LLOYD_CHUNK_ELEMS = 1 << 26


def lloyd(vectors: torch.Tensor, centroids: torch.Tensor,
          iters: int) -> torch.Tensor:
    """``iters`` Lloyd iterations per subspace from ``centroids``
    (D, K, S) over vectors (N, D*S) -> centroids (D, K, S).

    An empty cluster keeps its centroid.  Subspaces are independent,
    so they run one at a time: the peak is one (N, K) distance matrix,
    not D of them.  Past ``LLOYD_CHUNK_ELEMS`` elements that matrix is
    walked in row chunks: the codes are the same, and the per-cluster
    sums add the chunks' partial sums (equal to one shot up to f32
    rounding)."""
    n = vectors.shape[0]
    n_sub, k, s = centroids.shape
    x = vectors.reshape(n, n_sub, s)
    rows = n if n * k <= LLOYD_CHUNK_ELEMS else max(1, LLOYD_CHUNK_ELEMS // k)
    out = []
    for d in range(n_sub):
        xd = x[:, d, :].contiguous()                          # (N, S)
        c = centroids[d]
        for _ in range(iters):
            c_sq = torch.sum(torch.square(c), dim=-1)[None]
            counts = sums = None
            for r0 in range(0, n, rows):
                xr = xd[r0:r0 + rows]
                dist = c_sq - 2.0 * (xr @ c.T)
                codes = torch.argmin(dist, dim=-1)            # (rows,)
                del dist
                onehot = torch.zeros((xr.shape[0], k), dtype=x.dtype,
                                     device=x.device)
                onehot.scatter_(1, codes[:, None], 1.0)
                part_n = torch.sum(onehot, dim=0)             # (K,)
                part_s = onehot.T @ xr                        # (K, S)
                del onehot
                counts = part_n if counts is None else counts + part_n
                sums = part_s if sums is None else sums + part_s
            c = torch.where(counts[:, None] > 0,
                            sums / torch.clamp(counts[:, None], min=1.0), c)
        out.append(c)
    return torch.stack(out)


def fit_pq(gen: torch.Generator, vectors: torch.Tensor, num_subspaces: int,
           num_centroids: int, iters: int = 10) -> torch.Tensor:
    """Per-subspace k-means over corpus vectors.

    vectors (N, d) -> centroids (D, K, S), S = d / D."""
    cent = initial_centroids(gen, vectors, num_subspaces, num_centroids)
    return lloyd(vectors, cent, iters)


def encode_corpus(vectors: torch.Tensor, centroids: torch.Tensor,
                  backend: Optional[str] = None) -> torch.Tensor:
    """vectors (N, d) -> codes (N, D) int32 (dispatched dpq_assign)."""
    n = vectors.shape[0]
    n_sub, _, s = centroids.shape
    e_sub = vectors.reshape(n, n_sub, s).contiguous()
    return dpq_assign_op(e_sub, centroids.contiguous(), backend=backend)


def build_corpus_artifact(gen: torch.Generator, vectors: torch.Tensor,
                          num_subspaces: int = 8, num_centroids: int = 256,
                          iters: int = 10,
                          backend: Optional[str] = None) -> Dict:
    """Offline step: corpus vectors -> {codes, centroids} artifact."""
    cent = fit_pq(gen, vectors, num_subspaces, num_centroids, iters)
    codes = encode_corpus(vectors, cent, backend=backend)
    dtype = torch.uint8 if num_centroids <= 256 else torch.int32
    return {"codes": codes.to(dtype), "centroids": cent}


def adc_scores(artifact: Dict, query: torch.Tensor,
               backend: Optional[str] = None,
               block_n: Optional[int] = None) -> torch.Tensor:
    """query (d,) -> scores (N,) over the coded corpus, through the
    dispatched ``pq_score`` op.  The codes go in at their stored dtype
    (uint8); the op widens them."""
    return score_candidates(query, artifact["centroids"],
                            artifact["codes"],
                            block_n=block_n, backend=backend)


def reconstruction_mse(artifact: Dict, vectors: torch.Tensor) -> torch.Tensor:
    """Mean squared quantization error of the coded corpus."""
    from repro_torch.kernels.mgqe_decode.ref import mgqe_decode_ref
    rec = mgqe_decode_ref(artifact["codes"], artifact["centroids"])
    return torch.mean(torch.square(rec - vectors))


@register_index("flat_pq")
class FlatPQ(Index):
    """Exact batched ADC scan: every candidate scored for every query.

    Recall against the PQ-decoded corpus is 1.0 by construction (the
    scan IS the LUT summation of the decoded codes)."""

    rows_leaves = ("codes",)

    @classmethod
    def validate(cls, cfg: IndexConfig) -> None:
        if cfg.num_subspaces < 1 or cfg.num_centroids < 2:
            raise ValueError(
                f"flat_pq needs num_subspaces >= 1 and num_centroids >= "
                f"2, got {cfg.num_subspaces}/{cfg.num_centroids}")

    def build(self, gen: torch.Generator, vectors: torch.Tensor) -> Dict:
        """Build through the blocked build (retrieval/build.py):
        codebooks fitted on ``cfg.train_sample`` rows, encoding run in
        ``cfg.encode_block``-row blocks (0 = full corpus / one shot).
        The artifact lies on the vectors' device."""
        from repro_torch.retrieval.build import build_flat_artifact
        artifact, _ = build_flat_artifact(gen, vectors, self.cfg)
        return artifact

    def scores(self, artifact: Dict, queries: torch.Tensor) -> torch.Tensor:
        """Full (B, N) score matrix — exactness oracle + small corpora."""
        return score_candidates_batched(
            queries, artifact["centroids"], artifact["codes"],
            block_n=self.cfg.block_n, backend=self.cfg.kernel_backend)

    def search(self, artifact: Dict, queries: torch.Tensor,
               k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        return topk_candidates(
            queries, artifact["centroids"], artifact["codes"], k,
            block_n=self.cfg.block_n, backend=self.cfg.kernel_backend)

    def local_topk(self, artifact: Dict, queries: torch.Tensor, k: int, *,
                   shard: int, num_shards: int):
        """The shard's own ``search`` (``pq_topk``), its local row ids
        made global (padding stays ``INVALID_ID``); the global id is
        also the tiebreak."""
        rows_local = artifact["codes"].shape[0]
        s, i = self.search(artifact, queries, k)
        gids = torch.where(i == INVALID_ID, i, i + shard * rows_local)
        return s, gids, gids
