"""Public wrappers: ADC retrieval scoring against a PQ-coded corpus.

Three dispatched ops (backends ``cuda`` | ``torch``, see dispatch.py):

  ``pq_score``          one LUT (D, K) -> scores (N,)
  ``pq_score_batched``  B LUTs (B, D, K) -> scores (B, N); one pass
                        over the code stream per chunk of queries
  ``pq_topk``           batched scores reduced to the top k per query,
                        (score desc, id asc): the (B, N) score matrix
                        never reaches device memory

All three take the corpus codes at their STORED dtype (uint8 when
K <= 256) and widen them inside the op.  The LUT builds are a plain
product outside any kernel (an einsum), as in the JAX package.
``block_n`` left as None resolves through the autotune cache; its
meaning is each kernel's own (candidates per block of the scoring
kernel, the tile of pq_topk's first pass) and the plain versions
ignore it — every value gives bit-identical results.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.pq_score.pq_score import (SCORE_BLOCK_N,
                                                   TOPK_BLOCK_N, pq_score,
                                                   pq_score_batched, pq_topk)
from repro_torch.kernels.pq_score.ref import (INVALID_ID,
                                              build_lut_batch_ref,
                                              build_lut_ref,
                                              pq_score_batched_ref,
                                              pq_score_ref, pq_topk_ref)

def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def score_cost(lut, codes, block_n=None) -> dispatch.OpCost:
    """pq_score: the codes and the LUT read once, N float32 scores
    written; D float32 adds a candidate."""
    n, d = codes.shape
    return dispatch.OpCost(n * d, _bytes(codes) + _bytes(lut) + n * 4)


def score_batched_cost(luts, codes, block_n=None) -> dispatch.OpCost:
    """pq_score_batched: the codes and the B LUTs read once, B·N float32
    scores written; D adds a (query, candidate)."""
    n, d = codes.shape
    b = luts.shape[0]
    return dispatch.OpCost(b * n * d, _bytes(codes) + _bytes(luts)
                           + b * n * 4)


def topk_cost(luts, codes, k, block_n=None) -> dispatch.OpCost:
    """pq_topk: the scoring's reads and adds, B·k (score, id) pairs
    written (8 bytes each)."""
    n, d = codes.shape
    b = luts.shape[0]
    return dispatch.OpCost(b * n * d, _bytes(codes) + _bytes(luts)
                           + b * k * 8)


dispatch.register_op(
    "pq_score",
    cuda=lambda lut, codes, block_n=None: pq_score(lut, codes,
                                                   block_n=block_n),
    torch=lambda lut, codes, block_n=None: pq_score_ref(lut, codes),
    tunables={"block_n": SCORE_BLOCK_N},
    cost=score_cost,
)

dispatch.register_op(
    "pq_score_batched",
    cuda=lambda luts, codes, block_n=None: pq_score_batched(
        luts, codes, block_n=block_n),
    torch=lambda luts, codes, block_n=None: pq_score_batched_ref(luts,
                                                                 codes),
    tunables={"block_n": SCORE_BLOCK_N},
    cost=score_batched_cost,
)

dispatch.register_op(
    "pq_topk",
    cuda=lambda luts, codes, k, block_n=None: pq_topk(luts, codes, k,
                                                      block_n=block_n),
    torch=lambda luts, codes, k, block_n=None: pq_topk_ref(luts, codes, k),
    tunables={"block_n": TOPK_BLOCK_N},
    cost=topk_cost,
)


def build_lut(query: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Per-query LUT (D, K) — one einsum."""
    return build_lut_ref(query, centroids)


def build_lut_batch(queries: torch.Tensor,
                    centroids: torch.Tensor) -> torch.Tensor:
    """Per-query LUTs (B, D, K) — one einsum for the whole batch."""
    return build_lut_batch_ref(queries, centroids)


def score_candidates(query: torch.Tensor, centroids: torch.Tensor,
                     codes: torch.Tensor, block_n: Optional[int] = None,
                     backend: Optional[str] = None) -> torch.Tensor:
    """Full ADC path: query (d,) + corpus codes (N, D) -> scores (N,)."""
    lut = build_lut(query, centroids).to(torch.float32).contiguous()
    return dispatch.dispatch("pq_score", lut, codes, block_n=block_n,
                             backend=backend)


def score_candidates_batched(queries: torch.Tensor, centroids: torch.Tensor,
                             codes: torch.Tensor,
                             block_n: Optional[int] = None,
                             backend: Optional[str] = None) -> torch.Tensor:
    """Batched ADC: queries (B, d) + codes (N, D) -> scores (B, N)."""
    luts = build_lut_batch(queries, centroids).to(torch.float32).contiguous()
    return dispatch.dispatch("pq_score_batched", luts, codes,
                             block_n=block_n, backend=backend)


def topk_candidates(queries: torch.Tensor, centroids: torch.Tensor,
                    codes: torch.Tensor, k: int,
                    block_n: Optional[int] = None,
                    backend: Optional[str] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched ADC top-k: queries (B, d) + codes (N, D) -> (scores
    (B, k), ids (B, k)); ordering (score desc, id asc)."""
    luts = build_lut_batch(queries, centroids).to(torch.float32).contiguous()
    return dispatch.dispatch("pq_topk", luts, codes, k, block_n=block_n,
                             backend=backend)


__all__ = ["INVALID_ID", "build_lut", "build_lut_batch",
           "build_lut_batch_ref", "build_lut_ref", "pq_score",
           "pq_score_batched", "pq_score_batched_ref", "pq_score_ref",
           "pq_topk", "pq_topk_ref", "score_candidates",
           "score_candidates_batched", "topk_candidates"]
