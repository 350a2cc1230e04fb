"""Frequency-based vocabulary partitioning (paper §2.1).

The framework convention: item ids are *frequency-sorted* — id 0 is the
most frequent item.  ``rank_by_frequency`` produces the remap for raw
datasets; ``frequency_boundaries`` converts fractional tier splits (the
paper's "top 10% = head") into id thresholds.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def rank_by_frequency(counts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Return (remap, inverse) so that ``new_id = remap[old_id]`` is
    frequency-descending (ties broken by old id, deterministically).

    ``inverse[new_id] = old_id``.
    """
    counts = np.asarray(counts)
    # stable argsort on -counts keeps tie order deterministic
    inverse = np.argsort(-counts, kind="stable")
    remap = np.empty_like(inverse)
    remap[inverse] = np.arange(len(counts))
    return remap, inverse


def frequency_boundaries(vocab_size: int,
                         head_fractions: Sequence[float]) -> Tuple[int, ...]:
    """Convert cumulative head fractions to id thresholds.

    ``head_fractions=(0.1,)`` reproduces the paper's default two-tier
    split: V1 = top 10% of items, V2 = the rest.  Returned boundaries
    are strictly ascending and lie in [1, vocab-1].

    Degenerate requests raise: every fraction must lie strictly inside
    (0, 1) — a 0% or 100% head tier is an empty tier, not a rounding
    artifact — and the cumulative fractions must be strictly
    increasing.  The only silent adjustment kept is the rounding nudge:
    two valid fractions that round to the SAME id (tiny vocabularies)
    are separated by one id so every tier stays non-empty.
    """
    fracs = tuple(float(f) for f in head_fractions)
    for f in fracs:
        # `not (0 < f < 1)` also catches NaN (all comparisons False)
        if not 0.0 < f < 1.0:
            raise ValueError(
                f"head fraction {f} outside (0, 1): a 0%/100% tier is "
                f"empty, not a rounding artifact")
    for lo, hi in zip(fracs, fracs[1:]):
        if hi <= lo:
            raise ValueError(
                f"head_fractions must be strictly increasing "
                f"(cumulative), got {fracs}")
    bounds = []
    prev = 0
    for frac in fracs:
        b = int(round(vocab_size * frac))
        # legitimate rounding collision only: nudge into [prev+1, v-1]
        b = max(prev + 1, min(b, vocab_size - 1))
        bounds.append(b)
        prev = b
    # tiny vocab + many fractions can exhaust the id range even after
    # nudging; fail like any other impossible partition
    validate_partition(vocab_size, bounds)
    return tuple(bounds)


def validate_partition(vocab_size: int, boundaries: Sequence[int]) -> None:
    """Raise ValueError unless the partition disjointly covers [0, vocab)."""
    edges = (0,) + tuple(boundaries) + (vocab_size,)
    for lo, hi in zip(edges, edges[1:]):
        if hi <= lo:
            raise ValueError(f"empty/inverted tier [{lo}, {hi})")
    sizes = [hi - lo for lo, hi in zip(edges, edges[1:])]
    # Defensive coverage check (non-numeric/NaN boundaries slip past the
    # pairwise comparisons above).  A ValueError, not an assert — it
    # must survive ``python -O``.
    if sum(sizes) != vocab_size:
        raise ValueError(
            f"tiers cover {sum(sizes)} ids, expected {vocab_size}")


def tier_of_ids(ids, boundaries: Sequence[int]):
    """Vectorized tier index: number of boundaries <= id.

    Works on numpy arrays and torch tensors (a tensor's result stays on
    its device, in its dtype); plain Python lists and scalars are
    coerced to numpy first — ``ids * 0`` on a list is ``[]``, not a
    zero array, so duck-typing them through the array path silently
    returns garbage.
    Pure arithmetic — no table lookup — because ids are frequency-sorted.
    """
    if isinstance(ids, torch.Tensor):
        total = torch.zeros_like(ids)
        for b in boundaries:
            total = total + (ids >= b).to(total.dtype)
        return total
    if not hasattr(ids, "dtype"):
        ids = np.asarray(ids)
    total = ids * 0
    for b in boundaries:
        total = total + (ids >= b).astype(total.dtype)
    return total
