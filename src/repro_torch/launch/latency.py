"""Fixed log-bucket latency histogram for the serving engines.

Latency SLOs are statements about tail percentiles (p99/p999), and a
serving loop that answers millions of lookups cannot keep a float per
request to compute them — the tracker must be O(1) per observation and
O(buckets) in memory, mergeable across engines/threads, and readable at
any moment without touching the recording path's cost model.

``LatencyHistogram`` is the standard fix (HdrHistogram/Prometheus
shape): geometric buckets ``[lo·g^i, lo·g^(i+1))`` so RELATIVE
resolution is constant across six decades of latency — with the
defaults (``lo`` = 1 µs, ``g`` = 2^(1/4), 128 buckets) every readout is
exact to within ~19% of the true sample (one bucket width), covering
1 µs .. ~1 hour.  Recording is an integer increment; percentile readout
walks the cumulative counts; ``merge`` is elementwise addition, so
histograms from independent streams (or a warm/measure split) compose
losslessly at bucket granularity.

Readout convention: ``percentile`` returns the UPPER edge of the bucket
holding the rank-``⌈q·n⌉`` sample — a conservative (never optimistic)
latency bound, which is the side an SLO check must err on.  Empty
histograms read as NaN, never raise: a stream with zero completed
requests has no percentile, and the stats export path must survive it
(`launch/engine.py::EngineStats.as_dict`).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ["LatencyHistogram"]


class LatencyHistogram:
    """Mergeable log-bucket histogram over positive durations (seconds).

    Bucket ``i`` covers ``[lo·g^i, lo·g^(i+1))``; observations below
    ``lo`` land in bucket 0 and observations beyond the last edge land
    in the final bucket (both clamps keep recording total — an SLO
    readout must count every request, however extreme).
    """

    def __init__(self, lo: float = 1e-6, growth: float = 2.0 ** 0.25,
                 n_buckets: int = 128):
        if not (lo > 0 and growth > 1 and n_buckets >= 1):
            raise ValueError(
                f"need lo > 0, growth > 1, n_buckets >= 1; got "
                f"lo={lo}, growth={growth}, n_buckets={n_buckets}")
        self.lo = float(lo)
        self.growth = float(growth)
        self._log_g = math.log(self.growth)
        self.counts = np.zeros(n_buckets, np.int64)

    # ------------------------------------------------------------ record
    @property
    def n_buckets(self) -> int:
        return len(self.counts)

    def bucket_of(self, seconds: float) -> int:
        """Index of the bucket a duration falls into (clamped)."""
        if not seconds > self.lo:        # also catches NaN / negatives
            return 0
        i = int(math.log(seconds / self.lo) / self._log_g)
        return min(i, self.n_buckets - 1)

    def record(self, seconds: float) -> None:
        self.counts[self.bucket_of(seconds)] += 1

    def record_many(self, seconds: Sequence[float]) -> None:
        s = np.asarray(seconds, np.float64)
        if s.size == 0:
            return
        with np.errstate(divide="ignore", invalid="ignore"):
            i = np.floor(np.log(s / self.lo) / self._log_g)
        i = np.where(np.isfinite(i), i, 0)       # <= lo, NaN -> bucket 0
        i = np.clip(i, 0, self.n_buckets - 1).astype(np.int64)
        np.add.at(self.counts, i, 1)

    # ----------------------------------------------------------- readout
    @property
    def count(self) -> int:
        return int(self.counts.sum())

    def bucket_upper(self, i: int) -> float:
        """Upper edge of bucket ``i`` — the conservative readout value."""
        return self.lo * self.growth ** (i + 1)

    def percentile(self, q: float) -> float:
        """Upper-bound latency (seconds) of the ``q``-quantile sample,
        ``q`` in [0, 1].  NaN on an empty histogram — callers printing
        or exporting stats must not crash on a request-free stream."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must lie in [0, 1], got {q}")
        total = self.count
        if total == 0:
            return math.nan
        rank = max(1, math.ceil(q * total))      # 1-based order statistic
        cum = np.cumsum(self.counts)
        return self.bucket_upper(int(np.searchsorted(cum, rank)))

    # convenience for stats export / printing (milliseconds)
    @property
    def p50_ms(self) -> float:
        return self.percentile(0.50) * 1e3

    @property
    def p99_ms(self) -> float:
        return self.percentile(0.99) * 1e3

    @property
    def p999_ms(self) -> float:
        return self.percentile(0.999) * 1e3

    # ------------------------------------------------------------- merge
    def compatible(self, other: "LatencyHistogram") -> bool:
        return (self.lo == other.lo and self.growth == other.growth
                and self.n_buckets == other.n_buckets)

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Elementwise-sum merge (new histogram; operands untouched).
        Exact at bucket granularity: merge(h1, h2) has the bucket
        counts of a histogram fed both sample streams."""
        if not self.compatible(other):
            raise ValueError(
                "cannot merge histograms with different bucket schemes "
                f"(lo {self.lo} vs {other.lo}, growth {self.growth} vs "
                f"{other.growth}, buckets {self.n_buckets} vs "
                f"{other.n_buckets})")
        out = LatencyHistogram(self.lo, self.growth, self.n_buckets)
        out.counts = self.counts + other.counts
        return out

    # ------------------------------------------------------------ export
    def as_dict(self) -> Dict:
        """Compact export: summary percentiles + the nonzero buckets
        (index -> count), enough to reconstruct the histogram."""
        nz = np.nonzero(self.counts)[0]
        return {
            "count": self.count,
            "p50_ms": self.p50_ms,
            "p99_ms": self.p99_ms,
            "p999_ms": self.p999_ms,
            "lo_s": self.lo,
            "growth": self.growth,
            "nonzero_buckets": {int(i): int(self.counts[i]) for i in nz},
        }

    def __repr__(self) -> str:
        if self.count == 0:
            return "LatencyHistogram(empty)"
        return (f"LatencyHistogram(n={self.count}, p50={self.p50_ms:.3f}ms,"
                f" p99={self.p99_ms:.3f}ms, p999={self.p999_ms:.3f}ms)")


def percentile_exact(samples: Sequence[float],
                     q: float) -> Optional[float]:
    """Reference order-statistic percentile (testing aid): the
    rank-⌈q·n⌉ smallest sample, or None when empty — the value a
    histogram readout must upper-bound within one bucket width."""
    s = sorted(samples)
    if not s:
        return None
    return s[max(1, math.ceil(q * len(s))) - 1]
