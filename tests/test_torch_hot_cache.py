"""The port's hot-row cache against the JAX package's, test for test
with ``tests/test_hot_cache.py``: the scheme hook (export attaches the
``hot`` leaf), the engine's hot/cold split, its EngineStats, the EMA
counters and the refresh loop.

Each JAX table is initialised from a PRNG key and exported; the
artifact is carried across with ``repro_torch.convert``, and both
engines serve the same ids on the CPU (JAX on its ``xla`` backend, the
port on the plain PyTorch ops).  The bars:

* the port's cached rows bit-identical to its own uncached rows, for
  every registered scheme, ``lrf`` included, at B = 1, 8 and 256;
* the port's ``hot`` leaf and cached rows against JAX's: bit for bit for
  the gather decodes (dpq, mgqe, mpe, full, hash); within ``SERVE_TOL``
  for ``rq`` (its stage sum) and ``sq`` (``q * scale + lo``, which XLA
  may fuse), the bar of ``tests/test_torch_schemes.py``; within
  ``LRF_TOL`` for ``lrf``, whose JAX rows are a matmul that rounds by
  shape;
* EngineStats counters, the EMA ``freq`` counters and the selected hot
  ids equal to JAX's.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import Embedding as JaxEmbedding
from repro.core import EmbeddingConfig as JaxConfig
from repro.core.schemes import registered_kinds, scheme_class
from repro.launch import engine as jax_engine
from repro_torch.convert import artifact_from_numpy
from repro_torch.core import Embedding, EmbeddingConfig
from repro_torch.launch.engine import ServingEngine, drive_zipf_stream

SERVE_TOL = 1e-6        # rq's stage sum, sq's multiply-add
LRF_TOL = 1e-5          # lrf: a matmul in JAX, a fixed-order sum here
GATHER = {"dpq", "mgqe", "mpe", "full", "hash"}
COUNTERS = ("requests", "lookups", "padded_lookups", "flushes", "hot_hits",
            "decoded_lookups", "hot_refreshes")


def _dpq_cfg(**kw):
    return JaxConfig(vocab_size=500, dim=16, kind="dpq", num_subspaces=4,
                     num_centroids=8, decode_block_b=32,
                     kernel_backend="xla", **kw)


def _port_cfg(jcfg) -> EmbeddingConfig:
    return EmbeddingConfig(**dict(dataclasses.asdict(jcfg),
                                  kernel_backend="auto"))


def _tables(jcfg):
    """(jax emb, jax artifact, port emb, port artifact): one table,
    exported by JAX and carried across."""
    jemb = JaxEmbedding(jcfg)
    jart = jemb.export(jemb.init(jax.random.PRNGKey(0)))
    cfg = _port_cfg(jcfg)
    tart = artifact_from_numpy(jax.tree.map(np.asarray, jart), cfg, "cpu")
    return jemb, jart, Embedding(cfg, device="cpu"), tart


def _engines(jcfg, hot_rows, **hot_kw):
    """(port cached, port uncached, jax cached, jax uncached)."""
    jemb, jart, temb, tart = _tables(jcfg)
    return (ServingEngine(temb, tart, hot_rows=hot_rows, device="cpu",
                          **hot_kw),
            ServingEngine(temb, tart, hot_rows=0, device="cpu"),
            jax_engine.ServingEngine(jemb, jart, hot_rows=hot_rows,
                                     **hot_kw),
            jax_engine.ServingEngine(jemb, jart, hot_rows=0))


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.int32)


def _same(got: torch.Tensor, want: torch.Tensor) -> None:
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _close_to_jax(kind, got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    if kind in GATHER:
        np.testing.assert_array_equal(_bits(got), want.view(np.int32))
    else:
        tol = LRF_TOL if kind == "lrf" else SERVE_TOL
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def _stats_equal(teng, jeng) -> None:
    t, j = teng.stats(), jeng.stats()
    for c in COUNTERS:
        assert getattr(t, c) == getattr(j, c), c
    assert t.hit_rate == j.hit_rate


# -------------------------------------------------------------- parity

def _registry_params():
    return [pytest.param(kind, var,
                         id=kind if var == "-" else f"{kind}-{var}")
            for kind in registered_kinds()
            for var in scheme_class(kind).variants()]


@pytest.mark.parametrize("kind,var", _registry_params())
def test_cached_lookups_bit_identical_every_scheme(kind, var):
    """Every registered scheme: the exported ``hot`` leaf equals JAX's,
    and cached rows are bit-identical to the port's uncached rows at B =
    1, 8 and 256 (``lrf`` too: its serve path does not depend on B), and
    equal JAX's cached rows."""
    jcfg = dataclasses.replace(
        scheme_class(kind).probe_config(var), hot_rows=8,
        kernel_backend="xla")
    jemb, jart, temb, tart = _tables(jcfg)
    cold = {k: v for k, v in tart.items() if k != "hot"}
    hot_leaf = temb.scheme.attach_hot_rows(cold)["hot"]
    assert hot_leaf.shape == (8, jcfg.dim)
    assert hot_leaf.dtype == temb.scheme.hot_dtype
    _close_to_jax(kind, hot_leaf, jart["hot"])
    # the port's own export of the same artifact, and its engines
    port_art = dict(cold, hot=hot_leaf)
    hot_eng = ServingEngine(temb, port_art, device="cpu")   # cfg hot_rows
    cold_eng = ServingEngine(temb, port_art, hot_rows=0, device="cpu")
    jeng = jax_engine.ServingEngine(jemb, jart)
    v = jcfg.vocab_size
    ids = np.asarray([0, 7, 3, 8, v - 1, 0, 20 % v])
    out = hot_eng.lookup(ids)
    _same(out, cold_eng.lookup(ids))
    _close_to_jax(kind, out, jeng.lookup(ids))
    assert hot_eng.stats().hot_hits > 0
    rng = np.random.default_rng(1)
    for b in (1, 8, 256):
        ids = rng.integers(0, v, b)
        ids[0] = 3                                  # a cached id
        _same(hot_eng.lookup(ids), cold_eng.lookup(ids))
    # the cached rows of lrf are its B = 8 block's rows, the cold ones
    # come from flushes of B = 256: equal only with a shape-free sum
    _same(hot_eng.lookup(np.arange(8)), cold_eng.lookup(np.arange(8)))


def test_cached_lookup_bit_identical_with_backend_override():
    """A backend override rebuilds the embedding: the engine re-decodes
    the hot block through its OWN serve path instead of reusing the
    exported leaf, and parity holds, with JAX's overridden engine too."""
    jcfg = _dpq_cfg(hot_rows=64)
    jemb, jart, temb, tart = _tables(jcfg)
    eng = ServingEngine(temb, tart, backend="torch", device="cpu")
    base = ServingEngine(temb, tart, backend="torch", hot_rows=0,
                         device="cpu")
    assert eng._hot_block is not eng.artifact["hot"]
    jeng = jax_engine.ServingEngine(jemb, jart, backend="xla")
    ids = np.asarray([0, 63, 64, 499, 5])
    out = eng.lookup(ids)
    _same(out, base.lookup(ids))
    _close_to_jax("dpq", out, jeng.lookup(ids))


# ---------------------------------------------------------- EngineStats

def test_stats_mixed_hot_cold_flush():
    eng, base, jeng, _ = _engines(_dpq_cfg(), hot_rows=100)
    ids = np.asarray([0, 5, 99, 100, 499, 3, 200])      # 4 hot, 3 cold
    _same(eng.lookup(ids), base.lookup(ids))
    jeng.lookup(ids)
    st = eng.stats()
    assert st.lookups == 7 and st.requests == 1 and st.flushes == 1
    assert st.hot_hits == 4 and st.hit_rate == pytest.approx(4 / 7)
    assert st.padded_lookups == 32 and st.decoded_lookups == 32
    _stats_equal(eng, jeng)


def test_stats_fully_cached_flush_zero_kernel_work():
    """A flush whose real ids are all cached decodes nothing."""
    eng, base, jeng, _ = _engines(_dpq_cfg(), hot_rows=100)
    ids = np.arange(40)
    out = eng.lookup(ids)
    _same(out, base.lookup(ids))
    _close_to_jax("dpq", out, jeng.lookup(ids))
    st = eng.stats()
    assert st.decoded_lookups == 0 and st.hot_hits == 40
    assert st.hit_rate == 1.0 and st.padded_lookups == 64
    assert st.seconds > 0 and np.isfinite(st.lookups_per_s)
    d = st.as_dict()
    assert d["hit_rate"] == 1.0 and d["decoded_lookups"] == 0
    assert set(d) == set(jeng.stats().as_dict())
    _stats_equal(eng, jeng)


def test_stats_single_request_no_concatenate_path():
    eng, base, jeng, _ = _engines(_dpq_cfg(), hot_rows=100)
    h = eng.submit(np.asarray([1, 2, 450]))
    jh = jeng.submit(np.asarray([1, 2, 450]))
    outs, jouts = eng.flush(), jeng.flush()
    _same(outs[h], base.lookup([1, 2, 450]))
    _close_to_jax("dpq", outs[h], jouts[jh])
    st = eng.stats()
    assert st.requests == 1 and st.lookups == 3
    assert st.hot_hits == 2 and st.decoded_lookups == 32
    _stats_equal(eng, jeng)


def test_stats_accumulate_across_mixed_flushes():
    eng, base, jeng, _ = _engines(_dpq_cfg(), hot_rows=100)
    for ids in (np.arange(10), np.asarray([400, 450]),
                np.asarray([0, 400])):   # fully cached, fully cold, mixed
        _same(eng.lookup(ids), base.lookup(ids))
        jeng.lookup(ids)
    st = eng.stats()
    assert st.flushes == 3 and st.lookups == 14
    assert st.hot_hits == 11 and st.decoded_lookups == 64
    _stats_equal(eng, jeng)


# ------------------------------------------------------------- refresh

def test_refresh_hot_rows_tracks_observed_traffic():
    """The EMA counters after the same traffic equal JAX's bit for bit,
    refresh picks the same ids, and parity holds afterwards."""
    eng, base, jeng, _ = _engines(_dpq_cfg(), hot_rows=16,
                                  hot_track_freq=True)
    hot_segment = np.arange(300, 316)
    for _ in range(3):
        ids = np.concatenate([hot_segment, hot_segment])
        eng.lookup(ids)
        jeng.lookup(ids)
    np.testing.assert_array_equal(eng._freq.numpy(), jeng._freq)
    np.testing.assert_array_equal(eng.select_hot_ids(),
                                  jeng.select_hot_ids())
    new_ids = eng.refresh_hot_rows()
    np.testing.assert_array_equal(new_ids, hot_segment)
    np.testing.assert_array_equal(new_ids, jeng.refresh_hot_rows())
    before = eng.stats().decoded_lookups
    out = eng.lookup(hot_segment)
    jeng.lookup(hot_segment)
    assert eng.stats().decoded_lookups == before
    _same(out, base.lookup(hot_segment))
    _stats_equal(eng, jeng)


def test_refresh_with_explicit_ids_keeps_parity():
    eng, base, jeng, _ = _engines(_dpq_cfg(), hot_rows=32)
    eng.refresh_hot_rows(np.arange(200, 232))
    jeng.refresh_hot_rows(np.arange(200, 232))
    ids = np.asarray([0, 201, 231, 499])
    out = eng.lookup(ids)
    _same(out, base.lookup(ids))
    _close_to_jax("dpq", out, jeng.lookup(ids))
    assert eng.stats().hot_hits == 2
    _stats_equal(eng, jeng)


def test_refresh_before_traffic_keeps_head_set():
    eng, _, jeng, _ = _engines(_dpq_cfg(), hot_rows=16, hot_track_freq=True)
    assert eng.select_hot_ids() is None
    np.testing.assert_array_equal(eng.refresh_hot_rows(), np.arange(16))
    np.testing.assert_array_equal(jeng.refresh_hot_rows(), np.arange(16))


def test_refresh_disabled_raises():
    eng, *_ = _engines(_dpq_cfg(), hot_rows=0)
    with pytest.raises(ValueError, match="hot"):
        eng.refresh_hot_rows()


def test_auto_refresh_every_n_flushes():
    """Refresh every 2 flushes, on a stream that also hits ties: the
    counters, the selection (ties broken by id) and the installed set
    equal JAX's after every flush."""
    eng, base, jeng, _ = _engines(_dpq_cfg(), hot_rows=16,
                                  hot_refresh_every=2)
    rng = np.random.default_rng(4)
    for i in range(6):
        ids = np.concatenate([[300, 301, 302], rng.integers(0, 500, 9)])
        _same(eng.lookup(ids), base.lookup(ids))
        jeng.lookup(ids)
        np.testing.assert_array_equal(eng._freq.numpy(), jeng._freq)
        np.testing.assert_array_equal(eng._hot_ids, jeng._hot_ids)
    assert eng.stats().hot_refreshes == 3
    assert {300, 301, 302} <= set(eng._hot_ids.tolist())
    _stats_equal(eng, jeng)


def test_engine_hot_rows_cap():
    jemb, jart, temb, tart = _tables(_dpq_cfg())
    for bad in (-1, 501):
        with pytest.raises(ValueError, match="hot_rows"):
            ServingEngine(temb, tart, hot_rows=bad, device="cpu")


# ------------------------------------------------------ zipf stream

def test_drive_zipf_stream_hits_head():
    jcfg = _dpq_cfg(hot_rows=64)
    jemb, jart, temb, tart = _tables(jcfg)
    eng = ServingEngine(temb, tart, max_queue=256, device="cpu",
                        hot_track_freq=True)
    jeng = jax_engine.ServingEngine(jemb, jart, max_queue=256,
                                    hot_track_freq=True)
    st = drive_zipf_stream(eng, 500, n_requests=30, req_batch=16,
                           zipf_a=1.2, seed=5)
    jax_engine.drive_zipf_stream(jeng, 500, n_requests=30, req_batch=16,
                                 zipf_a=1.2, seed=5)
    assert st.lookups > 0 and st.flushes >= 1
    assert st.hit_rate > 0.4
    assert st.decoded_lookups < st.padded_lookups
    _stats_equal(eng, jeng)
    np.testing.assert_array_equal(eng._freq.numpy(), jeng._freq)
    np.testing.assert_array_equal(eng.select_hot_ids(),
                                  jeng.select_hot_ids())


def test_exported_hot_block_is_used_when_config_matches():
    """No override: the engine serves the artifact's export-time block
    itself; another size or a rebuild re-decodes."""
    jcfg = _dpq_cfg(hot_rows=64)
    jemb, jart, temb, tart = _tables(jcfg)
    eng = ServingEngine(temb, tart, device="cpu")
    assert eng._hot_block is eng.artifact["hot"]
    _same(eng._hot_block, torch.from_numpy(np.array(jart["hot"])))
    other = ServingEngine(temb, tart, hot_rows=32, device="cpu")
    assert other._hot_block.shape == (32, 16)
    _same(other._hot_block, eng._hot_block[:32])
