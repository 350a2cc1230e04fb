"""The port's latency histogram (``repro_torch/launch/latency.py``)
against the JAX package's (``repro/launch/latency.py``), test for test
with ``tests/test_latency_hist.py``.

Both histograms are fed the same seeded samples (numpy, spanning the
buckets' six decades, with NaN, zero, negative and clamped values in
some streams).  The bar is exact: bucket counts equal element for
element, and every percentile readout equal to the float.
"""
import math

import numpy as np
import pytest

from repro.launch.latency import LatencyHistogram as JaxHistogram
from repro.launch.latency import percentile_exact as jax_percentile_exact
from repro_torch.launch.latency import LatencyHistogram, percentile_exact

SEEDS = range(6)
QS = (0.0, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0)


def _samples(seed: int, n: int = 200) -> np.ndarray:
    """Positive durations from 1e-7 s to 100 s (log-uniform), and for odd
    seeds a few values the histogram clamps: 0, -1, NaN, 1e9."""
    rng = np.random.default_rng(seed)
    s = 10.0 ** rng.uniform(-7, 2, n)
    if seed % 2:
        s[:4] = [0.0, -1.0, np.nan, 1e9]
        rng.shuffle(s)
    return s


def _pair(samples):
    t, j = LatencyHistogram(), JaxHistogram()
    t.record_many(samples)
    j.record_many(samples)
    return t, j


# ---------------------------------------------------------- properties

@pytest.mark.parametrize("seed", SEEDS)
def test_percentiles_monotone_in_q(seed):
    """Readouts are monotone in q, and equal to JAX's at every q."""
    t, j = _pair(_samples(seed))
    vals = [t.percentile(q) for q in QS]
    assert all(a <= b for a, b in zip(vals, vals[1:]))
    assert vals == [j.percentile(q) for q in QS]


@pytest.mark.parametrize("seed", SEEDS)
def test_merge_equals_histogram_of_concatenated_streams(seed):
    s1, s2 = _samples(seed), _samples(seed + 100, n=77)
    t1, j1 = _pair(s1)
    t2, j2 = _pair(s2)
    merged, jmerged = t1.merge(t2), j1.merge(j2)
    both, _ = _pair(np.concatenate([s1, s2]))
    np.testing.assert_array_equal(merged.counts, both.counts)
    np.testing.assert_array_equal(merged.counts, jmerged.counts)
    assert merged.count == len(s1) + len(s2)


@pytest.mark.parametrize("seed", SEEDS)
def test_readout_upper_bounds_exact_within_one_bucket(seed):
    samples = [float(x) for x in _samples(seed) if np.isfinite(x)]
    t, j = _pair(samples)
    for q in QS:
        got = t.percentile(q)
        ref = percentile_exact(samples, q)
        assert ref == jax_percentile_exact(samples, q)
        assert got == j.percentile(q)
        assert got >= min(ref, t.bucket_upper(t.n_buckets - 1)) * (1 - 1e-9)
        if t.lo < ref < t.bucket_upper(t.n_buckets - 2):
            assert got <= ref * t.growth * (1 + 1e-9)


# ------------------------------------------------------- deterministic

def test_empty_histogram_reads_nan_not_crash():
    h, j = LatencyHistogram(), JaxHistogram()
    assert math.isnan(h.percentile(0.99))
    assert math.isnan(h.p50_ms) and math.isnan(h.p999_ms)
    assert h.count == 0 and "empty" in repr(h) and repr(h) == repr(j)
    d, jd = h.as_dict(), j.as_dict()
    assert d["count"] == 0 and math.isnan(d["p99_ms"])
    assert d.keys() == jd.keys()


def test_out_of_range_quantile_raises():
    h = LatencyHistogram()
    h.record(1e-3)
    for q in (1.5, -0.1):
        with pytest.raises(ValueError):
            h.percentile(q)


def test_bucket_edges_and_clamps():
    h = LatencyHistogram(lo=1e-6, growth=2.0, n_buckets=4)
    j = JaxHistogram(lo=1e-6, growth=2.0, n_buckets=4)
    for x in (0.0, -1.0, float("nan"), 5e-7, 3e-6, 1.0):
        assert h.bucket_of(x) == j.bucket_of(x)
    assert h.bucket_of(3e-6) == 1 and h.bucket_of(1.0) == 3
    for hist in (h, j):
        hist.record_many([0.0, 3e-6, 1.0, float("nan")])
    assert h.counts.tolist() == j.counts.tolist() == [2, 1, 0, 1]
    assert h.percentile(1.0) == pytest.approx(h.bucket_upper(3))


@pytest.mark.parametrize("seed", SEEDS)
def test_record_many_matches_scalar_record(seed):
    rng = np.random.default_rng(seed)
    samples = rng.lognormal(mean=-6, sigma=2, size=500)
    h1, h2, j = LatencyHistogram(), LatencyHistogram(), JaxHistogram()
    h1.record_many(samples)
    for s in samples:
        h2.record(float(s))
        j.record(float(s))
    np.testing.assert_array_equal(h1.counts, h2.counts)
    np.testing.assert_array_equal(h1.counts, j.counts)
    assert h1.as_dict() == j.as_dict()
    assert repr(h1) == repr(j)


def test_merge_rejects_mismatched_schemes():
    with pytest.raises(ValueError, match="bucket schemes"):
        LatencyHistogram(n_buckets=64).merge(LatencyHistogram(n_buckets=128))
    with pytest.raises(ValueError, match="bucket schemes"):
        LatencyHistogram(lo=1e-6).merge(LatencyHistogram(lo=1e-3))


def test_percentile_exact_reference():
    for fn in (percentile_exact, jax_percentile_exact):
        assert fn([], 0.5) is None
        assert fn([3.0, 1.0, 2.0], 0.5) == 2.0
        assert fn([3.0, 1.0, 2.0], 1.0) == 3.0
        assert fn([3.0, 1.0, 2.0], 0.0) == 1.0
