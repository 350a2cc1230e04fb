"""The port's async serving front-end (``repro_torch/launch/
async_engine.py``) against the JAX package's, test for test with
``tests/test_async_engine.py``.

Three layers: :class:`FlushPolicy` driven on one scripted FAKE clock
beside JAX's (every decision and timeout equal — no threads, no
sleeps); the threaded engine's results against the synchronous engine
on the same requests, bit for bit, and against JAX's async results
(lookups: bit for bit, one exported table carried across with
``repro_torch.convert``; retrieval: ids equal and scores within
``SCORE_TOL``, the bar of ``tests/test_torch_retrieval.py``); and the
shared-stats contract and the background hot-row refresh.

Every wait has a timeout (``Future.result``, ``close``, ``drain``), so a
deadlock fails a test instead of hanging the suite.
"""
import contextlib
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import Embedding as JaxEmbedding
from repro.core import EmbeddingConfig as JaxConfig
from repro.launch import async_engine as jax_async
from repro.launch import engine as jax_engine
from repro.retrieval import IndexConfig as JaxIndexConfig
from repro.retrieval import get_index as jax_get_index
from repro_torch.convert import artifact_from_numpy, flat_pq_artifact_from_numpy
from repro_torch.core import Embedding, EmbeddingConfig
from repro_torch.launch.async_engine import (AsyncEngineStats,
                                             AsyncServingEngine, FlushPolicy,
                                             drive_open_loop)
from repro_torch.launch.engine import (EngineStats, RetrievalEngine,
                                       ServingEngine)
from repro_torch.retrieval import IndexConfig, get_index

WAIT = 60.0              # seconds: every future, drain and close
SCORE_TOL = 1e-5         # retrieval scores, the port's f32 LUT sums


def _dpq_cfg(**kw):
    return JaxConfig(vocab_size=500, dim=16, kind="dpq", num_subspaces=4,
                     num_centroids=8, decode_block_b=32,
                     kernel_backend="xla", **kw)


def _tables(**cfg_kw):
    jcfg = _dpq_cfg(**cfg_kw)
    jemb = JaxEmbedding(jcfg)
    jart = jemb.export(jemb.init(jax.random.PRNGKey(0)))
    cfg = EmbeddingConfig(**dict(dataclasses.asdict(jcfg),
                                 kernel_backend="auto"))
    tart = artifact_from_numpy(jax.tree.map(np.asarray, jart), cfg, "cpu")
    return jemb, jart, Embedding(cfg, device="cpu"), tart


def _serving_engine(hot_rows=0, **kw):
    jemb, jart, temb, tart = _tables(hot_rows=hot_rows)
    return ServingEngine(temb, tart, device="cpu", **kw), temb, tart


@contextlib.contextmanager
def _closing(a: AsyncServingEngine):
    """Run a test body against ``a``, closing it with a timeout."""
    try:
        yield a
    finally:
        a.close(timeout=WAIT)


def _results(a, reqs):
    futs = [a.submit(r) for r in reqs]
    return [f.result(timeout=WAIT) for f in futs]


# ------------------------------------------------- FlushPolicy (fake clock)

def _both(block_rows, max_wait_s):
    return FlushPolicy(block_rows, max_wait_s), \
        jax_async.FlushPolicy(block_rows, max_wait_s)


def _run_script(block_rows, max_wait_s, script):
    """Drive both policies through one script of (op, *args); return
    the port's outputs after checking they equal JAX's."""
    ours, theirs = _both(block_rows, max_wait_s)
    out = []
    for op, *args in script:
        got = getattr(ours, op)(*args)
        assert got == getattr(theirs, op)(*args), (op, args)
        assert (ours.rows, ours.oldest) == (theirs.rows, theirs.oldest)
        out.append(got)
    return out


def test_policy_deadline_fires_only_after_max_wait():
    out = _run_script(8, 1.0, [
        ("decision", 0.0), ("timeout", 0.0), ("on_submit", 2, 10.0),
        ("decision", 10.5), ("timeout", 10.5), ("decision", 10.999),
        ("decision", 11.0), ("on_flush", 11.0), ("decision", 100.0)])
    assert out[0] is None and out[1] is None
    assert out[3] is None and out[4] == pytest.approx(0.5)
    assert out[5] is None and out[6] == "deadline" and out[8] is None


def test_policy_block_full_fires_immediately_and_wins_over_deadline():
    out = _run_script(8, 1.0, [
        ("on_submit", 5, 0.0), ("decision", 0.0), ("on_submit", 3, 0.0),
        ("decision", 0.0), ("decision", 5.0)])
    assert out[1] is None and out[3] == "full" and out[4] == "full"


def test_policy_deadline_clock_starts_when_queue_goes_nonempty():
    out = _run_script(100, 1.0, [
        ("on_submit", 1, 0.0), ("on_submit", 1, 50.0), ("decision", 0.5),
        ("decision", 1.0), ("on_flush", 60.0), ("on_submit", 1, 60.0),
        ("decision", 60.5), ("decision", 61.0)])
    assert out[2] is None and out[3] == "deadline"
    assert out[6] is None and out[7] == "deadline"


def test_policy_drain_only_when_forced_and_nonempty():
    out = _run_script(8, 1.0, [
        ("decision", 0.0, True), ("on_submit", 1, 0.0),
        ("decision", 0.1, True), ("decision", 0.1, False),
        ("decision", 1.0, True)])
    assert out[0] is None and out[2] == "drain"
    assert out[3] is None and out[4] == "deadline"


def test_policy_zero_wait_makes_every_submit_flush_eligible():
    out = _run_script(8, 0.0, [("on_submit", 1, 5.0), ("decision", 5.0),
                               ("timeout", 5.0)])
    assert out[1] == "deadline" and out[2] == 0.0


def test_policy_validates_arguments():
    for cls in (FlushPolicy, jax_async.FlushPolicy):
        with pytest.raises(ValueError):
            cls(block_rows=0, max_wait_s=1.0)
        with pytest.raises(ValueError):
            cls(block_rows=8, max_wait_s=-1.0)


# ----------------------------------------------------- parity with sync

def test_async_results_bit_identical_to_sync_engine():
    """Port async == port sync, bit for bit, and == JAX async."""
    jemb, jart, temb, tart = _tables()
    rng = np.random.default_rng(0)
    reqs = [rng.integers(0, 500, size=rng.integers(1, 9))
            for _ in range(40)]
    ref = ServingEngine(temb, tart, device="cpu")
    refs = [ref.lookup(r).numpy() for r in reqs]
    a = AsyncServingEngine(ServingEngine(temb, tart, device="cpu"),
                           max_wait_us=200.0)
    with _closing(a):
        outs = _results(a, reqs)
    ja = jax_async.AsyncServingEngine(jax_engine.ServingEngine(jemb, jart),
                                      max_wait_us=200.0)
    try:
        jouts = [f.result(timeout=WAIT) for f in [ja.submit(r)
                                                  for r in reqs]]
    finally:
        ja.close(timeout=WAIT)
    for got, want, jgot in zip(outs, refs, jouts):
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
        np.testing.assert_array_equal(got.view(np.int32),
                                      np.asarray(jgot).view(np.int32))


def _corpus(n=600, d=16, seed=0):
    """Well-separated clusters: no near-ties between centroids."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(16, d)) * 2.0
    assign = rng.integers(0, 16, n)
    return (centers[assign] + 0.1 * rng.normal(size=(n, d))
            ).astype(np.float32)


def test_async_retrieval_engine_parity():
    jindex = jax_get_index(JaxIndexConfig(kind="flat_pq", num_subspaces=4,
                                          num_centroids=16, iters=3,
                                          kernel_backend="xla"))
    jart = jindex.build(jax.random.PRNGKey(0), jnp.asarray(_corpus()))
    art = flat_pq_artifact_from_numpy(jax.tree.map(np.asarray, jart), "cpu")
    index = get_index(IndexConfig(num_subspaces=4, num_centroids=16))
    rng = np.random.default_rng(0)
    qs = [rng.standard_normal((rng.integers(1, 4), 16)).astype(np.float32)
          for _ in range(10)]
    ref = RetrievalEngine(index, art, k=5, block_q=8, device="cpu")
    refs = [tuple(t.numpy() for t in ref.search(q)) for q in qs]
    a = AsyncServingEngine(RetrievalEngine(index, art, k=5, block_q=8,
                                           device="cpu"), max_wait_us=200.0)
    with _closing(a):
        outs = _results(a, qs)
    ja = jax_async.AsyncServingEngine(
        jax_engine.RetrievalEngine(jindex, jart, k=5, block_q=8),
        max_wait_us=200.0)
    try:
        jouts = [jax.tree.map(np.asarray, f.result(timeout=WAIT))
                 for f in [ja.submit(q) for q in qs]]
    finally:
        ja.close(timeout=WAIT)
    for (s, i), (ws, wi), (js, ji) in zip(outs, refs, jouts):
        np.testing.assert_array_equal(s.view(np.int32), ws.view(np.int32))
        np.testing.assert_array_equal(i, wi)
        np.testing.assert_array_equal(i, ji)
        np.testing.assert_allclose(s, js, rtol=0, atol=SCORE_TOL)


def test_lookup_is_submit_result_and_1d_query_keeps_shape():
    eng, _, _ = _serving_engine()
    a = AsyncServingEngine(eng, max_wait_us=100.0)
    with _closing(a):
        out = a.lookup(np.asarray([1, 2, 3]), timeout=WAIT)
    assert out.shape == (3, 16) and out.dtype == np.float32


# ------------------------------------------------------- stats contract

def test_async_stats_export_includes_subclass_properties():
    names = AsyncEngineStats.derived_metrics()
    assert names == jax_async.AsyncEngineStats.derived_metrics()
    assert {"p50_ms", "p99_ms", "p999_ms",
            "sustained_lookups_per_s", "hit_rate"} <= set(names)
    assert set(EngineStats.derived_metrics()) <= set(names)
    d = AsyncEngineStats().as_dict()
    jd = jax_async.AsyncEngineStats().as_dict()
    assert d.keys() == jd.keys()
    assert math.isnan(d["p99_ms"])
    assert d["sustained_lookups_per_s"] == 0.0
    assert d["latency"]["count"] == 0


def test_async_counters_and_trigger_split_account_for_every_request():
    eng, _, _ = _serving_engine()
    rng = np.random.default_rng(1)
    reqs = [rng.integers(0, 500, size=4) for _ in range(30)]
    a = AsyncServingEngine(eng, max_wait_us=500.0)
    with _closing(a):
        _results(a, reqs)
        assert a.drain(timeout=WAIT)
        st = a.stats()
    assert st.submitted == 30 and st.requests == 30 and st.lookups == 120
    assert st.latency.count == 30
    assert (st.flushes_full + st.flushes_deadline
            + st.flushes_drain) == st.flushes
    assert st.padded_lookups % 32 == 0
    assert st.p50_ms <= st.p99_ms <= st.p999_ms


def test_drive_open_loop_fills_wall_seconds_and_latency():
    eng, _, _ = _serving_engine()
    rng = np.random.default_rng(2)
    reqs = [rng.integers(0, 500, size=3) for _ in range(20)]
    arrivals = np.arange(20) * 1e-3
    a = AsyncServingEngine(eng, max_wait_us=300.0)
    with _closing(a):
        st = drive_open_loop(a, reqs, arrivals, timeout=WAIT)
    assert st.wall_seconds > 0 and st.sustained_lookups_per_s > 0
    assert st.latency.count == 20 and st.lookups == 60
    a = AsyncServingEngine(eng, max_wait_us=300.0)
    with _closing(a):
        with pytest.raises(ValueError, match="arrival times"):
            drive_open_loop(a, reqs, arrivals[:-1], timeout=WAIT)


def test_submit_after_close_raises():
    eng, _, _ = _serving_engine()
    a = AsyncServingEngine(eng, max_wait_us=100.0)
    a.close(timeout=WAIT)
    with pytest.raises(RuntimeError, match="closed"):
        a.submit(np.asarray([1]))
    a.close(timeout=WAIT)                       # idempotent


# -------------------------------------------------- background refresh

def test_background_refresh_matches_sync_refresh_selection():
    """The refresh installs the set JAX's async engine installs after the
    same requests (the EMA counters bit for bit), and cached results stay
    bit-identical to an uncached engine."""
    jemb, jart, temb, tart = _tables(hot_rows=16)
    eng = ServingEngine(temb, tart, device="cpu")
    base = ServingEngine(temb, tart, hot_rows=0, device="cpu")
    jeng = jax_engine.ServingEngine(jemb, jart)
    hot_ids = np.arange(100, 108)
    rng = np.random.default_rng(3)
    reqs = [np.concatenate([hot_ids, rng.integers(0, 500, size=2)])
            for _ in range(20)]
    a = AsyncServingEngine(eng, max_wait_us=200.0, refresh_every=5)
    ja = jax_async.AsyncServingEngine(jeng, max_wait_us=200.0,
                                      refresh_every=5)
    try:
        # one request at a time: both engines see the same flushes
        for r in reqs:
            a.submit(r).result(timeout=WAIT)
            ja.submit(r).result(timeout=WAIT)
        assert a.drain(timeout=WAIT) and ja.drain(timeout=WAIT)
        np.testing.assert_array_equal(eng._freq.numpy(), jeng._freq)
        a.refresh_now(wait=True)
        ja.refresh_now(wait=True)
        np.testing.assert_array_equal(eng._hot_ids, jeng._hot_ids)
        assert set(hot_ids) <= set(eng._hot_ids.tolist())
        h0 = a.stats().hot_hits
        out = a.lookup(hot_ids, timeout=WAIT)
        assert a.stats().hot_hits - h0 == len(hot_ids)
    finally:
        a.close(timeout=WAIT)
        ja.close(timeout=WAIT)
    np.testing.assert_array_equal(out, base.lookup(hot_ids).numpy())


def test_refresh_every_requires_hot_cache():
    eng, _, _ = _serving_engine()                # hot_rows=0
    with pytest.raises(ValueError, match="hot-row"):
        AsyncServingEngine(eng, refresh_every=4)
    a = AsyncServingEngine(eng)
    with _closing(a):
        with pytest.raises(ValueError, match="hot-row"):
            a.refresh_now()


def test_async_disables_inner_inflush_refresh():
    eng, _, _ = _serving_engine(hot_rows=8, hot_refresh_every=3)
    a = AsyncServingEngine(eng, refresh_every=5)
    with _closing(a):
        assert eng.hot_refresh_every == 0 and eng.hot_track_freq is True
        a.lookup(np.asarray([1, 2]), timeout=WAIT)
    assert eng._freq is not None and float(eng._freq[1]) == 1.0


def test_reset_stats_keeps_shared_instance_wiring():
    eng, _, _ = _serving_engine()
    a = AsyncServingEngine(eng, max_wait_us=100.0)
    with _closing(a):
        a.lookup(np.asarray([1, 2, 3]), timeout=WAIT)
        assert a.stats().lookups == 3
        a.reset_stats()
        assert a.stats().lookups == 0
        assert eng.stats_ is a.stats_
        a.lookup(np.asarray([4]), timeout=WAIT)
        assert a.stats().lookups == 1 and a.stats().latency.count == 1


def test_concurrent_submitters_stress():
    """Eight submitter threads against one engine with a short switch
    interval: every request resolved once, to its own rows, and every
    shared counter exact (a lost update would break one of them)."""
    import sys
    import threading
    eng, temb, tart = _serving_engine(hot_rows=16)
    base = ServingEngine(temb, tart, hot_rows=0, device="cpu")
    rng = np.random.default_rng(11)
    work = [[rng.integers(0, 500, size=rng.integers(1, 9))
             for _ in range(40)] for _ in range(8)]
    got = [[None] * 40 for _ in range(8)]
    a = AsyncServingEngine(eng, max_wait_us=50.0, refresh_every=3)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def submit_all(t):
            futs = [a.submit(r) for r in work[t]]
            for i, f in enumerate(futs):
                got[t][i] = f.result(timeout=WAIT)

        threads = [threading.Thread(target=submit_all, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        assert not any(t.is_alive() for t in threads)
        assert a.drain(timeout=WAIT)
        st = a.stats()
    finally:
        sys.setswitchinterval(old)
        a.close(timeout=WAIT)
    assert st.submitted == st.requests == st.latency.count == 320
    assert st.lookups == sum(len(r) for reqs in work for r in reqs)
    assert (st.flushes_full + st.flushes_deadline
            + st.flushes_drain) == st.flushes
    for reqs, outs in zip(work, got):
        for r, out in zip(reqs, outs):
            np.testing.assert_array_equal(out, base.lookup(r).numpy())
