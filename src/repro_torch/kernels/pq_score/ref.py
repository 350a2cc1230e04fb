"""Plain PyTorch versions of ADC (asymmetric distance computation)
scoring against a PQ-coded corpus.

Per query, ``lut[d, k] = <q_d, c_k^(d)>`` is built once; the score of
candidate n is ``sum_d lut[d, codes[n, d]]`` — the candidate vector is
never reconstructed.  The batched forms take one LUT per query
(B, D, K); ``pq_topk_ref`` reduces to (score, id) top-k pairs under the
ordering contract (score desc, id asc; padding ``(-inf, INVALID_ID)``).

These are the op's CPU path and the yardstick the CUDA kernels in
``csrc/pq_score.cu`` are held to on the card, bit for bit:

  * the score sums one column at a time, in the order d = 0..D-1,
    starting from +0.0 — the order the kernel adds in.  +0.0 is where
    the JAX package's sum starts too: a row of -0.0 terms scores +0.0,
    so no score is -0.0 and the float order below is total;
  * codes are widened here, inside the op (a uint8 tensor used as an
    index is a boolean mask in torch), and clamped to [0, K): codes
    from a build always lie in range, and out of range the port
    clamps, as ``mgqe_decode`` does (the JAX kernel's zero
    contribution and its reference's gather disagree there);
  * the top-k is a stable descending sort, whose order among equal
    scores is the ascending id — ``torch.topk`` leaves it unspecified.

Scores must be finite or ``-inf``; NaN has no place in the order.
"""
from __future__ import annotations

from typing import Tuple

import torch

INVALID_ID = torch.iinfo(torch.int32).max


def build_lut_ref(query: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """query (d,) with d = D*S; centroids (D, K, S) -> lut (D, K)."""
    n_sub, _, s = centroids.shape
    q_sub = query.reshape(n_sub, s)
    return torch.einsum("ds,dks->dk", q_sub, centroids)


def build_lut_batch_ref(queries: torch.Tensor,
                        centroids: torch.Tensor) -> torch.Tensor:
    """queries (B, d); centroids (D, K, S) -> luts (B, D, K)."""
    n_sub, _, s = centroids.shape
    q_sub = queries.reshape(queries.shape[0], n_sub, s)
    return torch.einsum("bds,dks->bdk", q_sub, centroids)


def pq_score_batched_ref(luts: torch.Tensor,
                         codes: torch.Tensor) -> torch.Tensor:
    """luts (B, D, K) f32; codes (N, D) uint8/int32 -> scores (B, N)."""
    _, n_sub, k = luts.shape
    idx = codes.long().clamp(0, k - 1)                    # (N, D)
    acc = torch.zeros((luts.shape[0], idx.shape[0]), dtype=luts.dtype,
                      device=luts.device)                 # (B, N), +0.0
    for d in range(n_sub):
        acc = acc + luts[:, d, :].index_select(1, idx[:, d])
    return acc


def pq_score_ref(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """lut (D, K) f32; codes (N, D) -> scores (N,)."""
    return pq_score_batched_ref(lut[None], codes)[0]


def pq_topk_ref(luts: torch.Tensor, codes: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """luts (B, D, K); codes (N, D) -> (scores (B, k) f32, ids (B, k)
    int32), ordered by (score desc, id asc); k > N pads."""
    scores = pq_score_batched_ref(luts, codes)            # (B, N)
    n = scores.shape[1]
    if k > n:                                             # pad contract
        scores = torch.nn.functional.pad(scores, (0, k - n),
                                         value=float("-inf"))
    pos = torch.arange(scores.shape[1], dtype=torch.int32,
                       device=scores.device)
    ids = torch.where(pos < n, pos, torch.full_like(pos, INVALID_ID))
    top_s, order = torch.sort(scores, dim=1, descending=True, stable=True)
    return top_s[:, :k].contiguous(), ids[order[:, :k]]


__all__ = ["INVALID_ID", "build_lut_batch_ref", "build_lut_ref",
           "pq_score_batched_ref", "pq_score_ref", "pq_topk_ref"]
