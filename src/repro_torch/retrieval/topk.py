"""Deterministic top-k selection and merging for retrieval.

One contract everywhere (kernel, plain version, merges): candidates
sort by **(score desc, tiebreak asc)** under a per-index tiebreak key —
the corpus id for the flat kind (ids ascend along the scored axis, so
a stable descending sort already implements it) — and slots beyond the
number of valid candidates carry ``(-inf, INVALID_ID)``.

That total order is what lets partial top-k lists (per tile, per
shard) merge into exactly the single-pass top-k: per-candidate scores
do not depend on where the candidate axis was cut, and truncating to
k under a total order is associative.

Torch has no two-key sort, so :func:`merge_topk` sorts twice, both
times stably: by the tiebreak ascending, then by the score descending.

Signed zeros follow the JAX package function by function: its
``merge_topk`` (``lax.sort``) holds -0.0 and +0.0 equal, its
``topk_by_position`` (``lax.top_k``) ranks +0.0 first, and so do the
port's (the latter by sorting on :func:`_order_key`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.pq_score import INVALID_ID


def _pad_last(x: torch.Tensor, pad: int, value) -> torch.Tensor:
    return F.pad(x, (0, pad), value=value)


def _order_key(scores: torch.Tensor) -> torch.Tensor:
    """int32 keys that rank float32 scores as ``lax.top_k`` does: with
    their value, and -0.0 below +0.0.  (Negative floats' bits grow with
    the magnitude; flipping all but the sign bit reverses that.)"""
    bits = scores.contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def merge_topk(scores: torch.Tensor, ids: torch.Tensor, k: int,
               tiebreak: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(…, S) candidate pairs -> the top ``k`` under (score desc,
    tiebreak asc); ``tiebreak`` defaults to ``ids``.

    ``ids`` ride along as payload.  Accepts any number of leading batch
    dims; pads with ``(-inf, INVALID_ID)`` when S < k.
    """
    s = scores.to(torch.float32)
    i = ids.to(torch.int32)
    tb = i if tiebreak is None else tiebreak.to(torch.int32)
    pad = k - s.shape[-1]
    if pad > 0:
        s = _pad_last(s, pad, float("-inf"))
        i = _pad_last(i, pad, INVALID_ID)
        tb = _pad_last(tb, pad, INVALID_ID)
    _, by_tb = torch.sort(tb, dim=-1, stable=True)
    s, i = s.gather(-1, by_tb), i.gather(-1, by_tb)
    out_s, by_s = torch.sort(s, dim=-1, descending=True, stable=True)
    return out_s[..., :k], i.gather(-1, by_s)[..., :k]


def topk_by_position(scores: torch.Tensor, ids: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top ``k`` over the last axis carrying explicit ids along:
    -> (scores, positions, ids), all (…, k), ordered by (score desc,
    position asc).  The positions are the tiebreak key for a later
    :func:`merge_topk`; padding (S < k) carries
    ``(-inf, INVALID_ID, INVALID_ID)``.
    """
    s = scores.to(torch.float32)
    i = ids.to(torch.int32)
    n = s.shape[-1]
    pos = torch.arange(n, dtype=torch.int32, device=s.device).expand(s.shape)
    pad = k - n
    if pad > 0:
        s = _pad_last(s, pad, float("-inf"))
        i = _pad_last(i, pad, INVALID_ID)
        pos = _pad_last(pos, pad, INVALID_ID)
    _, sel = torch.sort(_order_key(s), dim=-1, descending=True, stable=True)
    sel = sel[..., :k]
    return s.gather(-1, sel), pos.gather(-1, sel), i.gather(-1, sel)


__all__ = ["INVALID_ID", "merge_topk", "topk_by_position"]
