"""The port's IVF-PQ retrieval (``repro_torch/retrieval/ivf_pq.py``,
``build.build_ivf_artifact``, host-staged serving) against the JAX
package, test for test with the IVF tests of ``tests/test_retrieval.py``
and ``tests/test_retrieval_scale.py``.

Torch's generator and ``jax.random`` draw differently, so the parity
tests carry JAX's artifact across (``coarse``, ``centroids`` and the
list tables) and search it in both packages, or carry JAX's initial
centroids and hold Lloyd's iterations from them.  The bars:

* the list layout, the assignment and the codes from the same tables:
  bit for bit;
* search on dyadic tables (coarse centroids, PQ centroids and queries
  multiples of 1/8: every product and sum exact in any order): scores
  and ids bit-identical, ties included;
* search on the tables as built: scores within ``SCORE_TOL``, ids
  equal, the probe sets equal but between coarse scores within
  ``ASSIGN_TOL`` of each other (the two packages' CPU matmuls round
  differently);
* Lloyd's iterations from the same start: centroids within
  ``CENT_TOL``, codes equal;
* the scoring (``pq_score_batched`` over the unique probed lists), the
  plain per-query scoring, host-staged search and the host-staged
  engine: bit-identical to one another.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import engine as jax_engine
from repro.retrieval import IndexConfig as JaxIndexConfig
from repro.retrieval import build_ivf_artifact as jax_build_ivf
from repro.retrieval import get_index as jax_get_index
from repro.retrieval import index_class as jax_index_class
from repro.retrieval import ivf_pq as jax_ivf
from repro_torch.convert import ivf_pq_artifact_from_numpy
from repro_torch.kernels.pq_score import build_lut_batch
from repro_torch.launch import engine, serve
from repro_torch.launch.async_engine import AsyncServingEngine
from repro_torch.retrieval import (INVALID_ID, IVFPQ, IndexConfig,
                                   build_ivf_artifact, flat_pq, get_index,
                                   index_class, registered_index_kinds,
                                   suggest_nlist, topk_by_position)
from repro_torch.retrieval import ivf_pq
from tests._hypothesis_compat import given, settings, st

SCORE_TOL = 1e-5
CENT_TOL = 1e-5
ASSIGN_TOL = 1e-5
WAIT = 60.0

_N, _D = 403, 16            # deliberately not a multiple of any block


def _vectors(n=_N, d=_D, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(8, d)) * 2.0
    return (centers[rng.integers(0, 8, n)]
            + 0.2 * rng.normal(size=(n, d))).astype(np.float32)


_VECS = _vectors()


def _kw(**kw):
    return dict(num_subspaces=4, num_centroids=16, iters=3, nlist=8,
                nprobe=8, coarse_iters=3) | kw


def _cfg(**kw):
    return IndexConfig(kind="ivf_pq", **_kw(**kw))


def _jcfg(**kw):
    return JaxIndexConfig(kind="ivf_pq", **_kw(**kw))


def _gen(seed=7):
    return torch.Generator().manual_seed(seed)


def _build(cfg, vecs=_VECS, seed=7):
    return build_ivf_artifact(_gen(seed), vecs, cfg, device="cpu")


def _jax_artifact(vecs, jcfg, seed=1):
    art, _ = jax_build_ivf(jax.random.PRNGKey(seed), vecs, jcfg)
    return {name: np.asarray(leaf) for name, leaf in art.items()}


def _queries(b, d=_D, seed=2):
    return np.random.default_rng(seed).normal(size=(b, d)).astype(np.float32)


def _assert_same(got, want):
    """Bit for bit: (scores, ids) pairs of either package."""
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_array_equal(g.view(np.int32), np.asarray(w).view(
            np.int32))


# ------------------------------------------------------------ registry

@pytest.mark.parametrize("kind", ["flat_pq", "ivf_pq"])
def test_index_conformance_build_search(kind):
    """Every registered kind: build -> batched search returns (B, k)
    descending scores with in-range ids, no duplicates, as JAX's
    conformance test asks of its kinds."""
    assert kind in registered_index_kinds()
    index = get_index(index_class(kind).probe_config())
    vecs = torch.from_numpy(_vectors(512, 16, seed=3))
    art = index.build(_gen(0), vecs)
    s, i = index.search(art, torch.from_numpy(_queries(5, seed=3)), 7)
    assert tuple(s.shape) == tuple(i.shape) == (5, 7)
    assert bool((s[:, 1:] <= s[:, :-1]).all()), "scores must descend"
    assert bool((i != INVALID_ID).all())
    assert bool(((i >= 0) & (i < 512)).all())
    for row in i.tolist():
        assert len(set(row)) == len(row)


def test_probe_config_matches_jax():
    for kind in registered_index_kinds():
        got = dataclasses.asdict(index_class(kind).probe_config())
        want = dataclasses.asdict(jax_index_class(kind).probe_config())
        for name in ("kind", "num_subspaces", "num_centroids", "iters",
                     "nlist", "nprobe", "coarse_iters"):
            assert got[name] == want[name], (kind, name)


@pytest.mark.parametrize("kw", [dict(nprobe=0), dict(nlist=4, nprobe=8),
                                dict(nlist=0), dict(train_sample=-1),
                                dict(encode_block=-8),
                                dict(list_cap_quantile=0.0),
                                dict(list_cap_quantile=1.5)])
def test_ivf_config_errors_as_jax(kw):
    with pytest.raises(ValueError):
        JaxIndexConfig(kind="ivf_pq", **kw)
    with pytest.raises(ValueError):
        IndexConfig(kind="ivf_pq", **kw)


def test_suggest_nlist_gives_valid_ivf_configs():
    for n, nprobe in ((5000, 8), (10, 8), (1_000_000, 128)):
        nlist = suggest_nlist(n, nprobe)
        IndexConfig(kind="ivf_pq", nlist=nlist, nprobe=min(nprobe, nlist))
    assert suggest_nlist(1_000_000, 128) == 1000


# ----------------------------------------------------- the list layout

def _skewed_assignment(nlist=64, n=20_000, seed=0):
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, nlist + 1) ** 1.1
    assign = rng.choice(nlist, size=n, p=w / w.sum()).astype(np.int64)
    codes = rng.integers(0, 256, size=(n, 8)).astype(np.uint8)
    return assign, codes


@pytest.mark.parametrize("quantile", [0.5, 0.9, 0.95, 1.0])
def test_bounded_list_layout_bit_identical_to_jax(quantile):
    assign, codes = _skewed_assignment()
    got = ivf_pq.bounded_list_layout(assign, codes, 64, quantile)
    want = jax_ivf.bounded_list_layout(assign, codes, 64, quantile)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_bounded_layout_bytes_on_skewed_assignment():
    """The quantile-capped chained layout stays within a constant
    factor of the ideal bytes on a Zipf-skewed assignment, and is a
    faithful inverse of the corpus."""
    nlist, n, D = 64, 20_000, 8
    assign, codes = _skewed_assignment(nlist, n)
    lay = ivf_pq.bounded_list_layout(assign, codes, nlist, 0.9)
    counts = np.bincount(assign, minlength=nlist)
    ideal, padded = n * D, nlist * int(counts.max()) * D
    assert padded >= 8 * ideal
    assert lay["list_codes"].nbytes <= 4 * ideal
    ids = lay["list_ids"]
    valid = ids != INVALID_ID
    np.testing.assert_array_equal(np.sort(ids[valid]), np.arange(n))
    np.testing.assert_array_equal(lay["list_codes"][valid],
                                  codes[ids[valid]])
    chain = lay["list_chain"]
    for lst in range(nlist):
        rows = chain[lst][chain[lst] >= 0]
        members = ids[rows][ids[rows] != INVALID_ID]
        assert members.size == counts[lst]
        assert (assign[members] == lst).all()
    assert lay["list_codes"].shape[0] % nlist == 0


def test_quantile_one_reproduces_pad_to_max():
    rng = np.random.default_rng(1)
    nlist, n, D = 8, 500, 4
    assign = rng.integers(0, nlist, n)
    codes = rng.integers(0, 256, size=(n, D)).astype(np.uint8)
    lay = ivf_pq.bounded_list_layout(assign, codes, nlist, 1.0)
    counts = np.bincount(assign, minlength=nlist)
    assert lay["list_chain"].shape == (nlist, 1)
    assert lay["list_codes"].shape == (nlist, counts.max(), D)
    np.testing.assert_array_equal(lay["list_chain"][:, 0], np.arange(nlist))
    want = jax_ivf.bounded_list_layout(assign, codes, nlist, 1.0)
    for name in want:
        np.testing.assert_array_equal(lay[name], want[name])


# ------------------------------------------ the build against JAX's

@pytest.mark.parametrize("residual", [False, True])
def test_assign_encode_layout_from_jax_tables_equal_jax(residual):
    """JAX's coarse table and codebooks carried across: the port's
    blocked assignment, encode and layout give JAX's list tables bit
    for bit (no coarse score within ASSIGN_TOL of a tie here)."""
    vecs = _vectors(600, seed=8)
    jcfg = _jcfg(ivf_residual=residual, list_cap_quantile=0.7)
    jart = _jax_artifact(vecs, jcfg)
    coarse = torch.from_numpy(jart["coarse"].copy())
    x = torch.from_numpy(vecs)
    a = ivf_pq.coarse_assign(x, coarse)
    want_a = np.asarray(jax_ivf.coarse_assign(jnp.asarray(vecs),
                                              jnp.asarray(jart["coarse"])))
    d = (torch.sum(coarse ** 2, -1)[None] - 2 * x @ coarse.T).numpy()
    gap = np.abs(d[np.arange(600), a.numpy()]
                 - d[np.arange(600), want_a])
    assert gap.max() <= ASSIGN_TOL
    np.testing.assert_array_equal(a.numpy(), want_a)
    tc = x - coarse[a] if residual else x
    codes = flat_pq.encode_corpus(tc, torch.from_numpy(
        jart["centroids"].copy()))
    lay = ivf_pq.bounded_list_layout(a.numpy(), codes.numpy().astype(
        np.uint8), 8, 0.7)
    for name in lay:
        np.testing.assert_array_equal(lay[name], jart[name], err_msg=name)


@pytest.mark.parametrize("iters", [1, 4])
def test_coarse_lloyd_from_jax_initial_centroids_matches_jax(iters):
    vecs = _vectors(500, seed=9)
    key = jax.random.PRNGKey(4)
    init = np.array(jax_ivf.coarse_kmeans(key, jnp.asarray(vecs), 8,
                                          iters=0))
    want = np.asarray(jax_ivf.coarse_kmeans(key, jnp.asarray(vecs), 8,
                                            iters=iters))
    got = flat_pq.lloyd(torch.from_numpy(vecs),
                        torch.from_numpy(init)[None], iters)[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=CENT_TOL)
    np.testing.assert_array_equal(
        ivf_pq.coarse_assign(torch.from_numpy(vecs), got).numpy(),
        np.asarray(jax_ivf.coarse_assign(jnp.asarray(vecs),
                                         jnp.asarray(want))))


@pytest.mark.parametrize("chunk", [1, 7 * 16, 1000])
def test_chunked_lloyd_matches_one_shot(chunk, monkeypatch):
    """Lloyd walking its rows in chunks: centroids within CENT_TOL of
    the one-shot fit, codes equal."""
    x = torch.from_numpy(_vectors(700, seed=10))
    init = flat_pq.initial_centroids(_gen(1), x, 4, 16)
    one = flat_pq.lloyd(x, init, 5)
    monkeypatch.setattr(flat_pq, "LLOYD_CHUNK_ELEMS", chunk)
    got = flat_pq.lloyd(x, init, 5)
    np.testing.assert_allclose(got.numpy(), one.numpy(), rtol=0,
                               atol=CENT_TOL)
    assert torch.equal(flat_pq.encode_corpus(x, got),
                       flat_pq.encode_corpus(x, one))
    # at or under the threshold the fit is one shot, bit for bit
    monkeypatch.setattr(flat_pq, "LLOYD_CHUNK_ELEMS", 700 * 16)
    assert torch.equal(flat_pq.lloyd(x, init, 5), one)


def test_chunked_coarse_assign_matches_one_shot(monkeypatch):
    x = torch.from_numpy(_vectors(700, seed=11))
    coarse = ivf_pq.coarse_kmeans(_gen(2), x, 16, iters=3)
    one = ivf_pq.coarse_assign(x, coarse)
    assert one.dtype == torch.int32
    monkeypatch.setattr(ivf_pq, "ASSIGN_CHUNK_ELEMS", 16 * 33)
    assert torch.equal(ivf_pq.coarse_assign(x, coarse), one)


# ------------------------------------------ streamed == one-shot parity

_ONE_SHOT = {}


def _one_shot(sample):
    if sample not in _ONE_SHOT:
        _ONE_SHOT[sample] = _build(_cfg(train_sample=sample))[0]
    return _ONE_SHOT[sample]


def _assert_artifacts_equal(art, ref, msg=""):
    assert sorted(art) == sorted(ref)
    for name in ref:
        assert torch.equal(art[name], ref[name]), f"{name} {msg}"


@pytest.mark.parametrize("sample", [0, 64])
def test_streamed_build_matches_one_shot(sample):
    """Blocked encode + sampled fit are bit-identical to the one-shot
    build at equal sample settings, for any block size."""
    ref = _one_shot(sample)
    for block in (1, 3, 64, 100, _N, 5 * _N):
        art, stats = _build(_cfg(train_sample=sample, encode_block=block))
        _assert_artifacts_equal(art, ref, f"block={block} sample={sample}")
        assert stats.blocks == -(-_N // min(block, _N))
        assert stats.sample_rows == (sample or _N)


@settings(deadline=None, max_examples=8)
@given(st.integers(min_value=1, max_value=_N + 50),
       st.sampled_from([0, 97]))
def test_streamed_build_parity_property(block, sample):
    art, _ = _build(_cfg(train_sample=sample, encode_block=block))
    _assert_artifacts_equal(art, _one_shot(sample))


def test_build_takes_numpy_or_tensor_and_returns_host_lists():
    a_np, _ = _build(_cfg())
    a_t, _ = _build(_cfg(), vecs=torch.from_numpy(_VECS))
    _assert_artifacts_equal(a_t, a_np)
    for name in ("list_chain", "list_codes", "list_ids"):
        assert a_np[name].device.type == "cpu"
    assert a_np["list_codes"].dtype == torch.uint8
    assert a_np["list_ids"].dtype == a_np["list_chain"].dtype == torch.int32
    # the index's build moves every leaf to the vectors' device
    art = get_index(_cfg()).build(_gen(), torch.from_numpy(_VECS))
    _assert_artifacts_equal(art, a_np)


def test_build_stats_peak_is_block_bounded():
    vecs = _vectors(8192, 16, seed=1)
    cfg = _cfg(nlist=16, train_sample=1024, encode_block=512)
    art, stats = build_ivf_artifact(_gen(0), vecs, cfg, device="cpu")
    assert stats.blocks == 16 and stats.block_rows == 512
    assert stats.sample_rows == 1024
    assert stats.peak_device_ok
    assert stats.peak_device_bytes < vecs.nbytes
    vecs4 = _vectors(32768, 16, seed=2)
    _, stats4 = build_ivf_artifact(_gen(0), vecs4, cfg, device="cpu")
    assert stats4.device_bound_bytes == stats.device_bound_bytes
    # the same accounting as JAX's build of the same config and corpus
    _, jstats = jax_build_ivf(jax.random.PRNGKey(0), vecs,
                              JaxIndexConfig(**dataclasses.asdict(cfg)
                                             | dict(block_n=64)))
    assert stats.device_bound_bytes == jstats.device_bound_bytes
    assert stats.peak_device_bytes == jstats.peak_device_bytes
    counts = np.bincount(np.asarray(art["list_ids"])[
        np.asarray(art["list_ids"]) != INVALID_ID], minlength=8192)
    assert (counts == 1).all()
    assert stats.list_cap == art["list_codes"].shape[1]
    assert stats.max_chain == art["list_chain"].shape[1]
    assert stats.lists_ext == art["list_codes"].shape[0]
    assert set(stats.step_seconds) == {"sample", "coarse_fit", "pq_fit",
                                       "assign", "encode", "layout"}
    assert stats.as_dict()["peak_device_ok"] is True


def test_build_rejects_undersized_corpus_or_sample():
    vecs = _vectors(32)
    for build in (jax_build_ivf, None):
        with pytest.raises(ValueError, match="nlist"):
            if build:
                build(jax.random.PRNGKey(0), vecs, _jcfg(nlist=64))
            else:
                _build(_cfg(nlist=64), vecs=vecs)
        with pytest.raises(ValueError, match="train_sample"):
            if build:
                build(jax.random.PRNGKey(0), vecs,
                      _jcfg(nlist=16, train_sample=8))
            else:
                _build(_cfg(nlist=16, train_sample=8), vecs=vecs)


# ------------------------------------------- search against JAX's

def _dyadic(a, scale=8.0, lim=2.0):
    return (np.clip(np.round(np.asarray(a) * scale), -lim * scale,
                    lim * scale) / scale).astype(np.float32)


def _search_both(jcfg, jart, q, k):
    art = ivf_pq_artifact_from_numpy(jart, "cpu")
    index = get_index(IndexConfig(**dataclasses.asdict(jcfg)
                                  | dict(block_n=None)))
    got = index.search(art, torch.from_numpy(q), k)
    jindex = jax_get_index(jcfg)
    want = jindex.search({n: jnp.asarray(v) for n, v in jart.items()},
                         jnp.asarray(q), k)
    return index, art, got, jindex, want


@pytest.mark.parametrize("residual", [False, True])
def test_search_on_dyadic_jax_artifact_bit_identical(residual):
    """Dyadic tables and queries (every LUT entry, coarse score and sum
    exact): scores and ids bit for bit, ties broken by position as
    ``lax.top_k`` breaks them."""
    vecs = _vectors(700, seed=12)
    jcfg = _jcfg(nlist=16, nprobe=5, ivf_residual=residual,
                 list_cap_quantile=0.6)
    jart = _jax_artifact(vecs, jcfg)
    jart["coarse"] = _dyadic(jart["coarse"])
    jart["centroids"] = _dyadic(jart["centroids"])
    q = _dyadic(_queries(9, seed=5), lim=1.0)
    _, _, got, _, want = _search_both(jcfg, jart, q, 40)
    _assert_same(got, want)
    s = got[0].numpy()
    # the dyadic grid really ties: equal scores inside the lists
    assert any(len(np.unique(row)) < row.size for row in s)


@pytest.mark.parametrize("residual", [False, True])
def test_search_on_jax_artifact_matches_jax(residual):
    vecs = _vectors(900, seed=13)
    jcfg = _jcfg(nlist=16, nprobe=4, ivf_residual=residual,
                 list_cap_quantile=0.8)
    jart = _jax_artifact(vecs, jcfg)
    q = _queries(7, seed=6)
    index, art, got, jindex, want = _search_both(jcfg, jart, q, 25)
    # the probe sets: equal, but between coarse scores within ASSIGN_TOL
    ps, lists = index._probe(art, torch.from_numpy(q))
    jps, jlists = jindex._probe({"coarse": jnp.asarray(jart["coarse"])},
                                jnp.asarray(q))
    np.testing.assert_allclose(ps.numpy(), np.asarray(jps), rtol=0,
                               atol=ASSIGN_TOL)
    np.testing.assert_array_equal(lists.numpy(), np.asarray(jlists))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=SCORE_TOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_spilled_layout_search_matches_padded_layout():
    vecs = torch.from_numpy(_vectors(2048, 16, seed=3))
    q = torch.from_numpy(_queries(6, seed=9))
    outs = {}
    for quant in (1.0, 0.5):
        idx = get_index(_cfg(nlist=16, nprobe=16, list_cap_quantile=quant))
        art = idx.build(_gen(5), vecs)
        if quant < 1.0:
            assert art["list_chain"].shape[1] > 1   # chains really spill
        outs[quant] = idx.search(art, q, 50)
    _assert_same(outs[0.5], outs[1.0])


def _plain_search(index, art, q, k):
    """The search recomputed query by query: its probe, then the
    query's own probed rows scored by ``probed_scores_ref``."""
    probe_s, lists = index._probe(art, q)
    luts = build_lut_batch(q, art["centroids"]).contiguous()
    outs = []
    for b in range(q.shape[0]):
        chain = art["list_chain"][lists[b]]
        live = chain >= 0
        rows = torch.where(live, chain, 0)
        codes = art["list_codes"][rows]
        ids = art["list_ids"][rows]
        s = ivf_pq.probed_scores_ref(
            luts[b:b + 1], codes.reshape(1, -1, codes.shape[-1])
        ).reshape(ids.shape)
        if index.cfg.ivf_residual:
            s = s + probe_s[b][:, None, None]
        valid = (ids != INVALID_ID) & live[..., None]
        s = torch.where(valid, s, float("-inf"))
        ids = torch.where(valid, ids, INVALID_ID)
        outs.append(topk_by_position(s.reshape(1, -1), ids.reshape(1, -1),
                                     k))
    return (torch.cat([o[0] for o in outs]),
            torch.cat([o[2] for o in outs]))


@pytest.mark.parametrize("residual", [False, True])
def test_scoring_bit_identical_to_plain_per_query_scoring(residual):
    """The scoring (``pq_score_batched`` over the unique probed lists,
    here its plain version, then gathered) equals each query's own
    probed rows summed by ``probed_scores_ref``, bit for bit; and the
    search equals the plain search recomputed query by query."""
    vecs = torch.from_numpy(_vectors(1500, 16, seed=14))
    index = get_index(_cfg(nlist=16, nprobe=6, list_cap_quantile=0.5,
                           ivf_residual=residual))
    art = index.build(_gen(3), vecs)
    q = torch.from_numpy(_queries(11, seed=7))
    _, lists = index._probe(art, q)
    chain, _ = index._expand_chain(art["list_chain"], lists)
    assert len(torch.unique(chain)) < chain.numel()   # lists shared
    luts = build_lut_batch(q, art["centroids"]).contiguous()
    plain = ivf_pq.probed_scores_ref(
        luts, art["list_codes"][chain].reshape(11, -1, 4))
    cand = index._candidate_scores(luts, art["list_codes"], chain)
    assert torch.equal(cand.view(torch.int32), plain.view(torch.int32))
    _assert_same(index.search(art, q, 30), _plain_search(index, art, q, 30))


def test_search_in_query_chunks_equals_one_pass(monkeypatch):
    vecs = torch.from_numpy(_vectors(1500, 16, seed=15))
    index = get_index(_cfg(nlist=16, nprobe=6, list_cap_quantile=0.5))
    art = index.build(_gen(3), vecs)
    q = torch.from_numpy(_queries(13, seed=8))
    one = index.search(art, q, 30)
    monkeypatch.setattr(ivf_pq, "CANDIDATE_CHUNK", 1)   # a query a chunk
    assert len(index._query_chunks(13, 100)) == 13
    _assert_same(index.search(art, q, 30), one)


def test_recall_vs_dense_scan():
    """ivf_pq at nprobe = nlist/8 keeps recall@100 >= 0.95 against the
    dense scan (JAX's test_retrieval_recall_vs_dense_scan)."""
    from repro_torch.data.synthetic import pq_clustered_corpus
    vecs, q = pq_clustered_corpus(n=20_000, n_clusters=64)
    index = get_index(IndexConfig(kind="ivf_pq", num_subspaces=8,
                                  num_centroids=128, iters=15,
                                  coarse_iters=15, nlist=64, nprobe=8))
    art = index.build(_gen(42), torch.from_numpy(vecs))
    _, ids = index.search(art, torch.from_numpy(q), 100)
    exact = np.argsort(-(q @ vecs.T), axis=1)[:, :100]
    recall = np.mean([np.isin(ids[b].numpy(), exact[b]).mean()
                      for b in range(q.shape[0])])
    assert recall >= 0.95, recall


# ---------------------------------------------------- host-staged

def test_host_staged_search_matches_device_search():
    vecs = _vectors(1024, 16, seed=4)
    cfg = _cfg(nlist=16, nprobe=4)
    art_host, _ = build_ivf_artifact(_gen(1), vecs, cfg, device="cpu")
    q = torch.from_numpy(_queries(5, seed=2))
    idx = get_index(cfg)
    ref = idx.search(art_host, q, 20)
    got = idx.search_host_staged(art_host, q, 20)
    _assert_same(got, ref)
    assert idx.staged_bytes > 0
    # and JAX's host-staged search on the same artifact
    jidx = jax_get_index(_jcfg(nlist=16, nprobe=4))
    want = jidx.search_host_staged(
        {n: (jnp.asarray(v.numpy()) if n in ("coarse", "centroids")
             else v.numpy()) for n, v in art_host.items()},
        jnp.asarray(q.numpy()), 20)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=SCORE_TOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_staged_bytes_count_the_one_upload():
    """``staged_bytes`` grows by what the flush uploaded: the U unique
    probed extended lists' codes (padded to 4 bytes) and ids, then each
    probed slot's staged row (int32) and live flag (a byte)."""
    vecs = _vectors(2000, 16, seed=16)
    cfg = _cfg(nlist=16, nprobe=5, list_cap_quantile=0.5)
    art, stats = build_ivf_artifact(_gen(1), vecs, cfg, device="cpu")
    idx = get_index(cfg)
    q = torch.from_numpy(_queries(6, seed=3))
    _, lists = idx._probe(art, q)
    uniq, slots, live = idx.stage_plan(art["list_chain"].numpy(),
                                       lists.numpy())
    chain = art["list_chain"].numpy()[lists.numpy()]
    assert slots.shape == live.shape == (6, 5, stats.max_chain)
    np.testing.assert_array_equal(uniq[slots], np.where(live, chain, 0))
    assert len(uniq) == len(np.unique(np.where(live, chain, 0)))
    idx.search_host_staged(art, q, 10)
    cap = stats.list_cap
    want = (-(-len(uniq) * cap * 4 // 4) * 4 + len(uniq) * cap * 4
            + 6 * 5 * stats.max_chain * 5)
    assert idx.staged_bytes == want == IVFPQ.staged_upload_bytes(
        len(uniq), cap, 4, slots.size)
    assert IVFPQ.staged_upload_bytes(3, 5, 3, 7) == 48 + 60 + 35


def test_host_staged_engine_bit_identical_and_bounded_upload():
    vecs = _vectors(8192, 16, seed=5)
    cfg = _cfg(nlist=256, nprobe=2, host_staged=True)
    art_host, _ = build_ivf_artifact(_gen(1), vecs, cfg, device="cpu")
    eng = engine.RetrievalEngine(get_index(cfg), art_host, k=20, block_q=4,
                                 device="cpu")
    assert eng.host_staged
    ref_eng = engine.RetrievalEngine(
        get_index(dataclasses.replace(cfg, host_staged=False)), art_host,
        k=20, block_q=4, device="cpu")
    rng = np.random.default_rng(2)
    reqs = [rng.normal(size=(b, 16)).astype(np.float32) for b in (5, 3)]
    hs = [eng.submit(r) for r in reqs]
    rhs = [ref_eng.submit(r) for r in reqs]
    outs, ref_outs = eng.flush(), ref_eng.flush()
    for h, rh in zip(hs, rhs):
        _assert_same(outs[h], ref_outs[rh])
    table_mb = (art_host["list_codes"].numel()
                + 4 * art_host["list_ids"].numel()) / 1e6
    assert 0 < eng.staged_mbytes < table_mb
    # the JAX engine on the same artifact and requests
    jeng = jax_engine.RetrievalEngine(
        jax_get_index(_jcfg(nlist=256, nprobe=2, host_staged=True)),
        {n: v.numpy() for n, v in art_host.items()}, k=20, block_q=4)
    jhs = [jeng.submit(r) for r in reqs]
    jouts = jeng.flush()
    for h, jh in zip(hs, jhs):
        np.testing.assert_allclose(outs[h][0].numpy(),
                                   np.asarray(jouts[jh][0]), rtol=0,
                                   atol=SCORE_TOL)
        np.testing.assert_array_equal(outs[h][1].numpy(),
                                      np.asarray(jouts[jh][1]))


def test_host_staged_engine_rejects_flat_and_mesh():
    vecs = torch.from_numpy(_vectors(256, 16, seed=6))
    fidx = get_index(IndexConfig(num_subspaces=4, num_centroids=16,
                                 iters=3))
    fart = fidx.build(_gen(0), vecs)
    with pytest.raises(ValueError, match="has no host-staged serve path"):
        engine.RetrievalEngine(fidx, fart, k=10, host_staged=True,
                               device="cpu")
    iidx = get_index(_cfg(host_staged=True))
    iart = iidx.build(_gen(0), vecs)
    with pytest.raises(ValueError, match="single-device"):
        engine.RetrievalEngine(iidx, iart, k=10, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="distributed"):
        engine.RetrievalEngine(get_index(_cfg()), iart, k=10, mesh=object(),
                               device="cpu")
    with pytest.raises(NotImplementedError, match="distributed"):
        iidx.local_topk(iart, vecs[:2], 3, shard=0, num_shards=1)


def test_retrieval_engine_on_jax_artifact_matches_jax_engine():
    """The IVF engine micro-batches and routes results to the right
    request: JAX's test_retrieval_engine_microbatches_and_returns_right_
    request, against JAX's engine on JAX's artifact."""
    vecs = _vectors(512, 16, seed=17)
    jcfg = _jcfg(nlist=8, nprobe=8, iters=5)
    jart = _jax_artifact(vecs, jcfg, seed=0)
    art = ivf_pq_artifact_from_numpy(jart, "cpu")
    eng = engine.RetrievalEngine(get_index(_cfg(nlist=8, nprobe=8, iters=5)),
                                 art, k=10, block_q=8, device="cpu")
    jeng = jax_engine.RetrievalEngine(jax_get_index(jcfg), jart, k=10,
                                      block_q=8)
    rng = np.random.default_rng(0)
    q_a = rng.normal(size=(3, 16)).astype(np.float32)
    q_b = rng.normal(size=(16,)).astype(np.float32)
    assert eng.submit(q_a) == jeng.submit(q_a)
    s_b, i_b = eng.search(q_b)
    js_b, ji_b = jeng.search(q_b)
    assert tuple(s_b.shape) == (1, 10)
    np.testing.assert_array_equal(i_b.numpy(), np.asarray(ji_b))
    np.testing.assert_allclose(s_b.numpy(), np.asarray(js_b), rtol=0,
                               atol=SCORE_TOL)
    assert eng.pending == 0
    st_ = eng.stats()
    assert st_.requests == 2 and st_.lookups == 4 and st_.flushes == 1
    assert st_.padded_lookups % eng.pad_multiple == 0


def test_ivf_artifact_from_numpy_checks_shapes_and_host_leaves():
    jart = _jax_artifact(_vectors(300, seed=18), _jcfg())
    art = ivf_pq_artifact_from_numpy(jart, "cpu", host_staged=True)
    assert art["list_codes"].dtype == torch.uint8
    assert all(art[n].device.type == "cpu" for n in art)
    bad = [dict(jart, coarse=jart["coarse"][:, :3]),
           dict(jart, list_ids=jart["list_ids"].astype(np.int64)),
           dict(jart, list_chain=jart["list_chain"][:2]),
           dict(jart, list_codes=jart["list_codes"][:, :, :2]),
           {n: v for n, v in jart.items() if n != "coarse"}]
    for b in bad:
        with pytest.raises(ValueError):
            ivf_pq_artifact_from_numpy(b, "cpu")


# ------------------------------------------------ async and the CLI

def test_async_engine_serves_a_host_staged_engine():
    vecs = _vectors(4096, 16, seed=19)
    cfg = _cfg(nlist=64, nprobe=4, host_staged=True)
    art, _ = build_ivf_artifact(_gen(1), vecs, cfg, device="cpu")
    sync = engine.RetrievalEngine(get_index(cfg), art, k=15, block_q=8,
                                  device="cpu")
    staged = engine.RetrievalEngine(get_index(cfg), art, k=15, block_q=8,
                                    device="cpu")
    rng = np.random.default_rng(4)
    reqs = [rng.normal(size=(int(rng.integers(1, 6)), 16)).astype(
        np.float32) for _ in range(12)]
    with AsyncServingEngine(staged, max_wait_us=200.0) as aeng:
        # one flush a request: its LUTs are built over the same padded
        # batch as the synchronous engine's
        got = [aeng.submit(r).result(timeout=WAIT) for r in reqs]
        assert aeng.drain(timeout=WAIT)
    for r, (s, i) in zip(reqs, got):
        ws, wi = sync.search(r)
        _assert_same((s, i), (ws.numpy(), wi.numpy()))
    assert staged.staged_mbytes > 0
    assert aeng.stats().submitted == 12


@pytest.mark.parametrize("host_staged", [False, True])
def test_cli_serves_ivf_on_cpu(host_staged, capsys):
    argv = ["--arch", "two-tower-retrieval", "--device", "cpu",
            "--candidates", "3000", "--retrieval", "ivf_pq", "--nprobe", "4"]
    run = serve.main(argv + (["--host-staged"] if host_staged else []))
    out = capsys.readouterr().out
    nlist = suggest_nlist(3000, 4)
    assert f"ivf_pq index built" in out
    assert f"(nlist={nlist}, nprobe=4)" in out
    assert "recall@100 vs exact dense scan" in out
    assert ("host-staged:" in out) == host_staged
    assert run.stats.requests == 50
    assert run.engine.host_staged == host_staged


def test_serve_retrieval_ivf_counters_equal_to_jax(capsys):
    """serve_retrieval with an IVF index, host-staged, against JAX's on
    the smoke config: the same stream's counters."""
    from repro.configs.registry import get_arch as jax_get_arch
    from repro.launch import serve as jax_serve
    from repro_torch.configs.registry import get_arch
    _, cfg = get_arch("two-tower-retrieval", smoke=True)
    run = serve.serve_retrieval(cfg, 2000, index_kind="ivf_pq", nprobe=4,
                                host_staged=True, device="cpu")
    assert run.engine.host_staged and run.index.cfg.nlist == 45
    _, jcfg = jax_get_arch("two-tower-retrieval", smoke=True)
    jax_serve.serve_retrieval(jcfg, 2000, index_kind="ivf_pq", nprobe=4,
                              host_staged=True)
    out = capsys.readouterr().out
    jline = [ln for ln in out.splitlines() if ln.startswith("engine:")][-1]
    st_ = run.stats
    assert jline.startswith(f"engine: {st_.requests} requests / "
                            f"{st_.lookups} queries in {st_.flushes} "
                            f"flushes")


# ------------------------------------------------------ 1M-row recall

@pytest.mark.slow
def test_one_million_row_recall_and_peak():
    """The JAX bench's retrieval scale on the port alone: the streamed
    1M build from a host corpus with bounded peak device bytes, and
    recall@100 >= 0.95 at nprobe = 128."""
    from repro_torch.data.synthetic import pq_clustered_corpus
    n = 1_000_000
    vecs, q = pq_clustered_corpus(n=n, n_clusters=1024, cluster_zipf_a=1.3)
    nlist = suggest_nlist(n, 128)
    cfg = IndexConfig(kind="ivf_pq", num_subspaces=8, num_centroids=128,
                      iters=10, coarse_iters=10, nlist=nlist, nprobe=128,
                      train_sample=131_072, encode_block=131_072,
                      list_cap_quantile=0.9)
    art, stats = build_ivf_artifact(_gen(42), vecs, cfg, device="cpu")
    assert stats.peak_device_ok
    assert stats.peak_device_bytes < vecs.nbytes // 2
    _, ids = get_index(cfg).search(art, torch.from_numpy(q), 100)
    exact = np.argsort(-(q @ vecs.T), axis=1)[:, :100]
    recall = float(np.mean([np.isin(ids[b].numpy(), exact[b]).mean()
                            for b in range(q.shape[0])]))
    assert recall >= 0.95, f"recall@100 {recall:.3f} at nprobe=128"
