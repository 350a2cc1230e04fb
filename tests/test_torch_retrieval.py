"""The port's retrieval path against the JAX package.

Inputs are made with numpy from a seed and handed to both packages.
The JAX Pallas kernels run in interpret mode at a small ``block_n``,
as ``tests/test_retrieval.py`` runs them; the port runs its plain
versions (the CPU path of every op).  The bars:

* dyadic LUTs (multiples of 1/8, which any summation order adds
  exactly) with heavy ties: scores and ids bit-identical;
* normal LUTs: scores to 1e-5 absolute (the TPU kernels sum through a
  one-hot matmul, in another order), ids equal;
* top-k merges: bit for bit;
* Lloyd's iterations from the same initial centroids: centroids to
  1e-5, codes identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import pq_score as jax_pq
from repro.launch import engine as jax_engine
from repro.retrieval import IndexConfig as JaxIndexConfig
from repro.retrieval import flat_pq as jax_flat_pq
from repro.retrieval import get_index as jax_get_index
from repro.retrieval import merge_topk as jax_merge_topk
from repro.retrieval import topk_by_position as jax_topk_by_position
from repro_torch.convert import flat_pq_artifact_from_numpy
from repro_torch.kernels import pq_score as pq
from repro_torch.kernels.pq_score.pq_score import (LANE_TILE, LANES_THREADS,
                                                   LUT_BUDGET, ROWS_THREADS,
                                                   ROWS_UNROLL, SMEM_MAX,
                                                   SMEM_PER_SM,
                                                   TOPK_MAX_MERGE,
                                                   TOPK_THREADS, lanes_smem,
                                                   score_plan, topk_plan)
from repro_torch.launch import engine
from repro_torch.retrieval import (INVALID_ID, IndexConfig, build,
                                   flat_pq, get_index, index_class, ivf_pq,
                                   merge_topk, register_index,
                                   registered_index_kinds, suggest_nlist,
                                   topk_by_position)
from repro_torch.retrieval.base import Index
from tests._hypothesis_compat import given, settings, st

SCORE_TOL = 1e-5
CENT_TOL = 1e-5
BLOCK_N = 64                       # JAX interpret kernels' candidate block
CODE_DTYPES = {"uint8": np.uint8, "int32": np.int32}


def _luts(kind, b, d, k, seed):
    rng = np.random.default_rng(seed)
    if kind == "dyadic":           # exact in any summation order
        return (rng.integers(-16, 17, (b, d, k)) / 8.0).astype(np.float32)
    return rng.normal(size=(b, d, k)).astype(np.float32)


def _codes(n, d, k, dtype, seed, ties=False):
    rng = np.random.default_rng(seed)
    # ties: codes from 3 values, so many rows (and scores) coincide
    hi = 3 if ties else k
    return rng.integers(0, hi, (n, d)).astype(CODE_DTYPES[dtype])


def _assert_scores(got, want, kind):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    if kind == "dyadic":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_TOL)


# ------------------------------------------------ pq_score plain versions

@pytest.mark.parametrize("kind", ["dyadic", "normal"])
@pytest.mark.parametrize("dtype", sorted(CODE_DTYPES))
def test_pq_score_ref_matches_jax(kind, dtype):
    luts = _luts(kind, 1, 6, 16, seed=1)
    codes = _codes(257, 6, 16, dtype, seed=2, ties=kind == "dyadic")
    got = pq.pq_score_ref(torch.from_numpy(luts[0]), torch.from_numpy(codes))
    assert got.dtype == torch.float32 and tuple(got.shape) == (257,)
    _assert_scores(got, jax_pq.pq_score_ref(luts[0], codes), kind)
    _assert_scores(got, jax_pq.pq_score(luts[0], codes, block_n=BLOCK_N,
                                        interpret=True), kind)


@pytest.mark.parametrize("kind", ["dyadic", "normal"])
@pytest.mark.parametrize("dtype", sorted(CODE_DTYPES))
def test_pq_score_batched_ref_matches_jax(kind, dtype):
    luts = _luts(kind, 4, 8, 16, seed=3)
    codes = _codes(257, 8, 16, dtype, seed=4, ties=kind == "dyadic")
    got = pq.pq_score_batched_ref(torch.from_numpy(luts),
                                  torch.from_numpy(codes))
    assert tuple(got.shape) == (4, 257)
    _assert_scores(got, jax_pq.pq_score_batched_ref(luts, codes), kind)
    _assert_scores(got, jax_pq.pq_score_batched(
        luts, codes, block_n=BLOCK_N, interpret=True), kind)


@pytest.mark.parametrize("kind", ["dyadic", "normal"])
@pytest.mark.parametrize("dtype", sorted(CODE_DTYPES))
@pytest.mark.parametrize("n,k", [(257, 10), (257, 100), (3, 5)],
                         ids=["k10", "k100", "k_past_n"])
def test_pq_topk_ref_matches_jax(kind, dtype, n, k):
    luts = _luts(kind, 4, 6, 16, seed=5)
    codes = _codes(n, 6, 16, dtype, seed=6, ties=kind == "dyadic")
    s, i = pq.pq_topk_ref(torch.from_numpy(luts), torch.from_numpy(codes), k)
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    assert tuple(s.shape) == tuple(i.shape) == (4, k)
    for js, ji in (jax_pq.pq_topk_ref(luts, codes, k),
                   jax_pq.pq_topk(luts, codes, k, block_n=BLOCK_N,
                                  interpret=True)):
        _assert_scores(s, js, kind)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    if k > n:                      # the pad contract
        assert (s[:, n:] == -np.inf).all()
        assert (i[:, n:] == INVALID_ID).all()
    if kind == "dyadic":           # the ties really are there
        assert len(np.unique(s.numpy())) < s.numel()


def test_pq_topk_ref_is_a_stable_sort_of_the_batched_scores():
    luts = torch.from_numpy(_luts("dyadic", 3, 8, 16, seed=7))
    codes = torch.from_numpy(_codes(500, 8, 16, "uint8", seed=8, ties=True))
    scores = pq.pq_score_batched_ref(luts, codes)
    order = torch.sort(scores, dim=1, descending=True, stable=True)
    s, i = pq.pq_topk_ref(luts, codes, 50)
    assert torch.equal(s, order.values[:, :50])
    assert torch.equal(i.long(), order.indices[:, :50])
    # equal scores come out in ascending id order
    same = s[:, 1:] == s[:, :-1]
    assert bool(same.any()) and bool((i[:, 1:] > i[:, :-1])[same].all())


def test_signed_zeros_score_and_rank_as_jax():
    """A row of -0.0 terms scores +0.0 (every sum starts from +0.0, as
    JAX's does); top-k ranks +0.0 above -0.0 where ``lax.top_k`` does
    (``topk_by_position``) and holds them equal where ``lax.sort`` does
    (``merge_topk``)."""
    rng = np.random.default_rng(9)
    luts = np.where(rng.normal(size=(3, 6, 16)) < 1.0, -0.0,
                    0.0).astype(np.float32)
    codes = _codes(257, 6, 16, "uint8", seed=10)
    lt, ct = torch.from_numpy(luts), torch.from_numpy(codes)
    s, i = pq.pq_topk_ref(lt, ct, 20)
    for got, want in (
            (pq.pq_score_ref(lt[0], ct), jax_pq.pq_score_ref(luts[0], codes)),
            (pq.pq_score_batched_ref(lt, ct),
             jax_pq.pq_score_batched_ref(luts, codes)),
            (pq.pq_score_batched_ref(lt, ct), jax_pq.pq_score_batched(
                luts, codes, block_n=BLOCK_N, interpret=True)),
            (s, jax_pq.pq_topk_ref(luts, codes, 20)[0])):
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      np.asarray(want).view(np.int32))
    np.testing.assert_array_equal(i.numpy(),
                                  np.asarray(jax_pq.pq_topk_ref(luts, codes,
                                                                20)[1]))
    scores = np.array([[-0.0, 0.0, -0.0, 0.0, 1.0, -0.0]], np.float32)
    ids = np.arange(6)[None]
    got = topk_by_position(torch.from_numpy(scores), torch.from_numpy(ids), 6)
    want = jax_topk_by_position(jnp.asarray(scores), jnp.asarray(ids), 6)
    assert got[2].tolist() == [[4, 1, 3, 0, 2, 5]]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy().view(np.int32),
                                      np.asarray(b).view(np.int32))
    for a, b in zip(_torch_merge(scores, ids, 6), _jax_merge(scores, ids, 6)):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def test_pq_ops_take_stored_uint8_codes_and_clamp():
    cent = torch.from_numpy(
        np.random.default_rng(0).normal(size=(4, 16, 4)).astype(np.float32))
    codes8 = torch.from_numpy(_codes(100, 4, 16, "uint8", seed=1))
    q = torch.from_numpy(
        np.random.default_rng(2).normal(size=(3, 16)).astype(np.float32))
    a = pq.score_candidates(q[0], cent, codes8)
    b = pq.score_candidates(q[0], cent, codes8.to(torch.int32))
    assert torch.equal(a, b)
    ab = pq.score_candidates_batched(q, cent, codes8)
    np.testing.assert_allclose(ab[0].numpy(), a.numpy(), atol=SCORE_TOL)
    ts, ti = pq.topk_candidates(q, cent, codes8, 5)
    assert tuple(ts.shape) == (3, 5) and ti.dtype == torch.int32
    # out-of-range codes clamp to K-1 (and negative int32 codes to 0)
    wide = codes8.to(torch.int32).clone()
    wide[:, 0] = 40
    wide[:, 1] = -3
    clamped = wide.clamp(0, 15)
    lut = pq.build_lut(q[0], cent)
    assert torch.equal(pq.pq_score_ref(lut, wide),
                       pq.pq_score_ref(lut, clamped))


def test_pq_builds_luts_like_jax():
    rng = np.random.default_rng(9)
    cent = rng.normal(size=(4, 16, 8)).astype(np.float32)
    q = rng.normal(size=(5, 32)).astype(np.float32)
    np.testing.assert_allclose(
        pq.build_lut_batch(torch.from_numpy(q), torch.from_numpy(cent)),
        jax_pq.build_lut_batch_ref(q, cent), atol=SCORE_TOL)
    np.testing.assert_allclose(
        pq.build_lut(torch.from_numpy(q[0]), torch.from_numpy(cent)),
        jax_pq.build_lut_ref(q[0], cent), atol=SCORE_TOL)


# (N, B, K of the LUTs, k, block_n) -> (queries a block, buffer slots a
# query, candidates a block, partial lists a query) on a card of 132 SMs:
# the retrieval flush (16 queries and 64 KB a block, three blocks an SM:
# one wave of 377 blocks, 13 lists), one query (as many lists as one
# merge block takes), a tiny corpus, a k past 128 (a 1,024-slot buffer),
# and an explicit block_n with K = 256 LUTs (8 KB a query: 7 queries a
# block)
@pytest.mark.parametrize("n,b,kk,k,block_n,plan", [
    (1_000_000, 464, 64, 100, None, (16, 256, 77056, 13)),
    (1_000_000, 1, 64, 100, None, (1, 256, 6144, 163)),
    (3, 2, 64, 5, None, (2, 256, 256, 1)),
    (257, 4, 64, 300, None, (4, 1024, 256, 2)),
    (100_000, 16, 256, 64, 1024, (7, 256, 1024, 98))])
def test_pq_topk_plan(n, b, kk, k, block_n, plan):
    got = topk_plan(n, b, 8, kk, k, 132, block_n)
    assert (got.queries, got.cap, got.chunk, got.chunks) == plan


def test_pq_topk_plan_buffers_and_scratch():
    """Every buffer holds at least 2 k pairs and a round of candidates
    and is a power of two (the bitonic sort's size); a block's shared
    memory is its LUTs (rows of 1-3 queries, or padded to 4, 8 or 16)
    and its buffers, 16 queries a block at k = 100, one at k = 8,192;
    scratch holds every (query, chunk) list and the first merge round's
    output, none when one chunk covers N."""
    for k in (1, 100, 256, 1000, 8192):
        p = topk_plan(1_000_000, 64, 8, 64, k, 132)
        assert p.cap >= max(2 * k, TOPK_THREADS)
        assert p.cap & (p.cap - 1) == 0 and p.cap <= max(4 * k, TOPK_THREADS)
        width = (p.queries if p.queries < 4
                 else 1 << (p.queries - 1).bit_length())
        assert width in (1, 2, 3, 4, 8, 16)
        assert p.smem == width * 8 * 64 * 4 + p.queries * p.cap * 8
        assert p.chunk % TOPK_THREADS == 0
        assert p.chunks * p.chunk >= 1_000_000 > (p.chunks - 1) * p.chunk
        assert p.chunks * k <= TOPK_MAX_MERGE            # one merge round
        assert p.rows0 == 64 * p.chunks * k and p.rows1 == 0
    assert topk_plan(1_000_000, 64, 8, 64, 100, 132).queries == 16
    assert topk_plan(1_000_000, 64, 8, 64, 8192, 132).queries == 1
    small = topk_plan(5000, 8, 8, 64, 100, 132, block_n=8192)
    assert (small.chunks, small.rows0, small.rows1) == (1, 0, 0)
    # block_n = 128 leaves 7,813 lists: a first merge round of 48 groups
    many = topk_plan(1_000_000, 16, 8, 64, 100, 132, block_n=128)
    assert many.chunks == 7813 and many.rows0 == 16 * 7813 * 100
    assert many.rows1 == 16 * 48 * 100
    assert topk_plan(0, 4, 8, 64, 4, 132).chunks == 1


# B -> the scoring launches' (route, first query, queries, width) at the
# retrieval index's (N, D, K) = (1M, 8, 64), uint8 codes: B <= 8 on the
# rows route, 32-query groups on the lanes route, a remainder of at most
# 8 queries on the rows route and a larger one as a masked lanes group
@pytest.mark.parametrize("b,launches", [
    (1, [("rows", 0, 1, 1)]),
    (5, [("rows", 0, 5, 8)]),
    (8, [("rows", 0, 8, 8)]),
    (9, [("lanes", 0, 9, 32)]),
    (16, [("lanes", 0, 16, 32)]),
    (33, [("lanes", 0, 32, 32), ("rows", 32, 1, 1)]),
    (40, [("lanes", 0, 32, 32), ("rows", 32, 8, 8)]),
    (64, [("lanes", 0, 64, 32)]),
    (464, [("lanes", 0, 464, 32)]),
    (465, [("lanes", 0, 465, 32)])])
def test_pq_score_plan_routes(b, launches):
    got = score_plan(1_000_000, b, 8, 64, 1, 132)
    assert [(p.route, p.q0, p.nq, p.width) for p in got] == launches


@pytest.mark.parametrize("dk", [(8, 64), (8, 256), (16, 64), (16, 256),
                                (5, 64), (5, 256), (12, 256), (8, 3000)])
@pytest.mark.parametrize("b", [1, 5, 16, 17, 33, 464, 465])
@pytest.mark.parametrize("code_bytes", [1, 4])
def test_pq_score_plan_covers_every_query_and_candidate(b, dk, code_bytes):
    """Every query in exactly one launch, in order; each launch's spans
    cover N with no empty block, in the route's unit; the shared memory
    is what the route needs (csrc/pq_score.cu re-checks it); about one
    wave of blocks; 32 queries' LUTs past 128 KB (D=8, K=256 and up)
    never take the lanes route, and the rows route's groups are as wide
    as LUT_BUDGET allows."""
    d, kk = dk
    lut = d * kk * 4
    for n in (257, 1_000_000):
        _check_score_plan(score_plan(n, b, d, kk, code_bytes, 132), n, b, d,
                          kk, code_bytes, lut)


def _check_score_plan(plan, n, b, d, kk, code_bytes, lut):
    q = 0
    for p in plan:
        assert p.q0 == q and p.groups == -(-p.nq // p.width)
        q += p.nq
        assert p.splits * p.span >= n > (p.splits - 1) * p.span
        if p.route == "lanes":
            assert 32 * lut <= 128 * 1024 and b > 8
            assert p.width == 32 and p.threads == LANES_THREADS
            assert p.span % (LANE_TILE * LANES_THREADS // 32) == 0
            assert p.smem == lanes_smem(d, kk, code_bytes,
                                        LANES_THREADS // 32) <= SMEM_MAX
        else:
            assert p.route == "rows" and p.threads == ROWS_THREADS
            assert p.width in (1, 2, 4, 8, 16)
            assert p.span % (ROWS_THREADS * ROWS_UNROLL) == 0
            assert p.smem == p.width * lut <= LUT_BUDGET
            assert p.width >= min(p.nq, 16) or 2 * p.width * lut > LUT_BUDGET
            assert p.nq <= 8 or 32 * lut > 128 * 1024
        per_sm = max(1, min(8 if p.route == "rows" else 2,
                            SMEM_PER_SM // (p.smem + 1024)))
        assert p.splits == 1 or p.splits * p.groups <= per_sm * 132
    assert q == b


def test_pq_score_plan_takes_block_n_and_refuses_nonsense():
    """block_n, where given, is the candidates a block walks, rounded
    up to the route's unit; it must be positive."""
    lanes, rows = score_plan(100_000, 33, 8, 64, 1, 132, block_n=1000)
    assert (lanes.route, lanes.span, lanes.splits) == ("lanes", 1024, 98)
    assert (rows.route, rows.span, rows.splits) == ("rows", 1024, 98)
    for bad in (0, -5):
        with pytest.raises(ValueError, match="positive"):
            score_plan(100, 33, 8, 64, 1, 132, block_n=bad)


def test_pq_topk_refuses_k_past_the_tile_and_cpu_tensors():
    with pytest.raises(ValueError, match="k <= 8192"):
        topk_plan(10_000, 1, 8, 64, 8193, 132)
    with pytest.raises(ValueError, match="k <= 8192"):
        topk_plan(10_000, 1, 8, 64, 0, 132)
    with pytest.raises(ValueError, match="positive"):
        topk_plan(10_000, 1, 8, 64, 10, 132, block_n=0)
    luts = torch.zeros((1, 4, 16))
    codes = torch.zeros((10, 4), dtype=torch.uint8)
    for fn in (lambda: pq.pq_topk(luts, codes, 3),
               lambda: pq.pq_score_batched(luts, codes),
               lambda: pq.pq_score(luts[0], codes)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn()
    # an explicit cuda backend on CPU tensors raises; no fallback
    with pytest.raises(ValueError, match="CUDA tensors"):
        pq.topk_candidates(torch.zeros((1, 16)), torch.zeros((4, 16, 4)),
                           codes, 3, backend="cuda")


# ------------------------------------------------------ top-k merging

def _sharded_merge(merge, scores, splits, k):
    """Split the candidate axis, top-k each part (global ids), merge."""
    parts, start = [], 0
    for size in splits:
        part = scores[..., start:start + size]
        ids = np.broadcast_to(np.arange(start, start + size), part.shape)
        parts.append(merge(part, ids, k))
        start += size
    s_cat = np.concatenate([np.asarray(s) for s, _ in parts], axis=-1)
    i_cat = np.concatenate([np.asarray(i) for _, i in parts], axis=-1)
    return merge(s_cat, i_cat, k)


def _torch_merge(scores, ids, k, tiebreak=None):
    tb = None if tiebreak is None else torch.from_numpy(np.array(tiebreak))
    s, i = merge_topk(torch.from_numpy(np.array(scores)),
                      torch.from_numpy(np.array(ids)), k, tiebreak=tb)
    return s.numpy(), i.numpy()


def _jax_merge(scores, ids, k, tiebreak=None):
    s, i = jax_merge_topk(jnp.asarray(scores), jnp.asarray(ids), k,
                          tiebreak=None if tiebreak is None
                          else jnp.asarray(tiebreak))
    return np.asarray(s), np.asarray(i)


def _check_merge_case(scores, splits, k):
    n = scores.shape[-1]
    ids = np.broadcast_to(np.arange(n), scores.shape)
    ref = _torch_merge(scores, ids, k)
    want = _jax_merge(scores, ids, k)
    for a, b in zip(ref, want):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_sharded_merge(_torch_merge, scores, splits, k), ref):
        np.testing.assert_array_equal(a, b)
    if k <= n:                     # position tiebreak == id here
        ts, tp, ti = topk_by_position(torch.from_numpy(scores),
                                      torch.from_numpy(np.array(ids)), k)
        js, jp, ji = jax_topk_by_position(jnp.asarray(scores),
                                          jnp.asarray(ids), k)
        for a, b in ((ts, js), (tp, jp), (ti, ji)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        # the two orders agree except between -0.0 and +0.0, which
        # lax.top_k ranks and lax.sort holds equal (as the port's do)
        if not (np.signbit(scores) & (scores == 0)).any():
            np.testing.assert_array_equal(ts.numpy(), ref[0])
            np.testing.assert_array_equal(ti.numpy(), ref[1])


@pytest.mark.parametrize("trial", range(8))
def test_merge_topk_matches_jax_seeded(trial):
    """Seeded splits incl. tie-heavy inputs: the port's merge equals
    JAX's, and merged per-part top-k equals the one-pass top-k, bit for
    bit."""
    rng = np.random.default_rng(trial)
    n = int(rng.integers(3, 60))
    k = int(rng.integers(1, n + 5))
    if trial % 2:                  # 4 discrete values: dense ties
        scores = rng.choice([0.0, 1.0, -1.0, 0.5], size=(3, n))
    else:
        scores = rng.normal(size=(3, n))
    scores = scores.astype(np.float32)
    cuts = sorted(rng.choice(n + 1, size=int(rng.integers(0, 4))))
    splits = [int(s) for s in np.diff([0] + list(cuts) + [n]) if s > 0]
    _check_merge_case(scores, splits or [n], k)


@settings(deadline=None, max_examples=30)
@given(st.lists(st.floats(min_value=-100, max_value=100, width=32)
                .map(lambda x: round(x, 1)),   # rounded -> frequent ties
                min_size=1, max_size=40),
       st.integers(min_value=1, max_value=45),
       st.data())
def test_merge_topk_matches_jax_property(values, k, data):
    n = len(values)
    cut_count = data.draw(st.integers(min_value=0, max_value=min(4, n)))
    cuts = sorted(data.draw(st.lists(
        st.integers(min_value=0, max_value=n), min_size=cut_count,
        max_size=cut_count)))
    splits = [int(s) for s in np.diff([0] + cuts + [n]) if s > 0] or [n]
    _check_merge_case(np.asarray(values, np.float32)[None], splits, k)


def test_merge_topk_explicit_tiebreak_matches_jax():
    rng = np.random.default_rng(11)
    scores = rng.choice([0.0, 2.0, -1.0], size=(4, 30)).astype(np.float32)
    ids = rng.permutation(1000)[:30].astype(np.int32)[None].repeat(4, 0)
    tb = np.stack([rng.permutation(30) for _ in range(4)]).astype(np.int32)
    for k in (5, 30, 37):
        got = _torch_merge(scores, ids, k, tiebreak=tb)
        want = _jax_merge(scores, ids, k, tiebreak=tb)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------- index + build

def _corpus(n=512, d=16, seed=0):
    """Well-separated clusters: no near-ties between centroids."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(16, d)) * 2.0
    assign = rng.integers(0, 16, n)
    return (centers[assign] + 0.1 * rng.normal(size=(n, d))
            ).astype(np.float32)


def test_registry_holds_flat_pq_only():
    """The registry holds both ported kinds (the name dates from the
    flat-only slice); unknown kinds, bad configs and a duplicate
    registration are refused."""
    assert registered_index_kinds() == ("flat_pq", "ivf_pq")
    assert IndexConfig(kind="ivf_pq").kind == "ivf_pq"
    with pytest.raises(KeyError, match="unknown index kind 'nope'"):
        IndexConfig(kind="nope")
    with pytest.raises(ValueError):
        IndexConfig(num_centroids=1)
    with pytest.raises(ValueError, match="kernel backend"):
        IndexConfig(kernel_backend="xla")
    with pytest.raises(ValueError):            # duplicate registration
        @register_index("flat_pq")
        class Impostor(Index):
            pass
    assert index_class("flat_pq") is flat_pq.FlatPQ
    assert index_class("ivf_pq") is ivf_pq.IVFPQ


def test_unported_index_paths_raise():
    index = get_index(IndexConfig())
    with pytest.raises(NotImplementedError, match="distributed"):
        index.artifact_shard_specs({})
    with pytest.raises(NotImplementedError, match="distributed"):
        index.local_topk({}, torch.zeros((1, 8)), 1, shard=0, num_shards=1)
    assert not index.supports_host_staged
    with pytest.raises(NotImplementedError,
                       match="has no host-staged serve path"):
        index.search_host_staged({}, torch.zeros((1, 8)), 1)


@pytest.mark.parametrize("n,nprobe", [(1, 1), (100, 1), (10_000, 8),
                                      (10_000, 200), (1_000_000, 8)])
def test_suggest_nlist_matches_jax(n, nprobe):
    from repro.retrieval import suggest_nlist as jax_suggest_nlist
    assert suggest_nlist(n, nprobe) == jax_suggest_nlist(n, nprobe)


@pytest.mark.parametrize("iters", [1, 5])
def test_lloyd_from_jax_initial_centroids_matches_jax(iters):
    vecs = _corpus()
    key = jax.random.PRNGKey(3)
    init = np.array(jax_flat_pq.fit_pq(key, vecs, 4, 16, iters=0))
    want = np.asarray(jax_flat_pq.fit_pq(key, vecs, 4, 16, iters=iters))
    got = flat_pq.lloyd(torch.from_numpy(vecs), torch.from_numpy(init),
                        iters)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=CENT_TOL)
    codes = flat_pq.encode_corpus(torch.from_numpy(vecs), got)
    want_codes = jax_flat_pq.encode_corpus(vecs, jnp.asarray(want),
                                           backend="xla")
    assert codes.dtype == torch.int32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_codes))


def test_fit_pq_samples_distinct_rows_and_iters_zero_is_the_init():
    vecs = torch.from_numpy(_corpus(n=100))
    cent = flat_pq.fit_pq(torch.Generator().manual_seed(0), vecs, 4, 16,
                          iters=0)
    x = vecs.reshape(100, 4, 4)
    for d in range(4):                 # every centroid is a corpus row,
        rows = {tuple(r) for r in x[:, d].tolist()}
        got = [tuple(r) for r in cent[d].tolist()]
        assert set(got) <= rows and len(set(got)) == 16   # all distinct
    small = flat_pq.fit_pq(torch.Generator().manual_seed(0), vecs[:5], 4,
                           16, iters=0)                    # n < K
    assert tuple(small.shape) == (4, 16, 4)


def test_blocked_build_is_bit_identical_to_one_shot():
    vecs = torch.from_numpy(_corpus(n=300))
    arts = []
    for block in (0, 64, 7):
        cfg = IndexConfig(num_subspaces=4, num_centroids=16, iters=3,
                          encode_block=block)
        art, stats = build.build_flat_artifact(
            torch.Generator().manual_seed(5), vecs, cfg)
        assert stats.blocks == (-(-300 // block) if block else 1)
        assert stats.n == 300 and stats.peak_device_ok
        arts.append(art)
    for art in arts[1:]:
        assert torch.equal(art["codes"], arts[0]["codes"])
        assert torch.equal(art["centroids"], arts[0]["centroids"])
    cfg = IndexConfig(num_subspaces=4, num_centroids=16, train_sample=50)
    _, stats = build.build_flat_artifact(torch.Generator().manual_seed(5),
                                         vecs, cfg)
    assert stats.sample_rows == 50
    assert stats.as_dict()["peak_device_ok"] is True


def test_flat_pq_scores_equal_decoded_dot_products_and_search():
    from repro_torch.kernels.mgqe_decode import mgqe_decode_ref
    vecs = torch.from_numpy(_corpus(n=300))
    index = get_index(IndexConfig(num_subspaces=4, num_centroids=32,
                                  iters=5))
    art = index.build(torch.Generator().manual_seed(0), vecs)
    assert art["codes"].dtype == torch.uint8
    q = torch.from_numpy(
        np.random.default_rng(3).normal(size=(6, 16)).astype(np.float32))
    scores = index.scores(art, q)
    decoded = mgqe_decode_ref(art["codes"], art["centroids"])
    np.testing.assert_allclose(scores.numpy(), (q @ decoded.T).numpy(),
                               atol=SCORE_TOL)
    s, i = index.search(art, q, 9)
    order = np.argsort(-scores.numpy(), axis=1, kind="stable")[:, :9]
    np.testing.assert_array_equal(i.numpy(), order)
    assert float(flat_pq.reconstruction_mse(art, vecs)) < 0.1
    # the one-shot offline step is the index's build with no sample and
    # no blocks, from the same generator
    one = flat_pq.build_corpus_artifact(torch.Generator().manual_seed(0),
                                        vecs, 4, 32, iters=5)
    assert torch.equal(one["codes"], art["codes"])
    assert torch.equal(one["centroids"], art["centroids"])


def test_flat_pq_search_on_jax_artifact_matches_jax():
    vecs = _corpus(n=400)
    jcfg = JaxIndexConfig(num_subspaces=4, num_centroids=16, iters=4,
                          block_n=BLOCK_N)
    jindex = jax_get_index(jcfg)
    jart = jindex.build(jax.random.PRNGKey(0), jnp.asarray(vecs))
    art = flat_pq_artifact_from_numpy(jax.tree.map(np.asarray, jart), "cpu")
    index = get_index(IndexConfig(num_subspaces=4, num_centroids=16))
    q = np.random.default_rng(4).normal(size=(5, 16)).astype(np.float32)
    s, i = index.search(art, torch.from_numpy(q), 20)
    js, ji = jindex.search(jart, jnp.asarray(q), 20)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=SCORE_TOL)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    sc = flat_pq.adc_scores(art, torch.from_numpy(q[0]))
    np.testing.assert_allclose(
        sc.numpy(), np.asarray(jax_flat_pq.adc_scores(jart, q[0])),
        atol=SCORE_TOL)


def test_flat_pq_artifact_from_numpy_checks_shapes():
    good = {"codes": np.zeros((10, 4), np.uint8),
            "centroids": np.zeros((4, 16, 2), np.float32)}
    art = flat_pq_artifact_from_numpy(good, "cpu")
    assert art["codes"].dtype == torch.uint8
    for bad in (dict(good, codes=np.zeros((10, 3), np.uint8)),
                dict(good, codes=np.zeros((10, 4), np.int64)),
                dict(good, centroids=np.zeros((4, 16), np.float32))):
        with pytest.raises(ValueError):
            flat_pq_artifact_from_numpy(bad, "cpu")


# ---------------------------------------------------------- the engine

def _engines(max_queue=64, block_q=16, k=10):
    vecs = _corpus(n=600)
    jindex = jax_get_index(JaxIndexConfig(num_subspaces=4, num_centroids=16,
                                          iters=3, block_n=BLOCK_N,
                                          kernel_backend="xla"))
    jart = jindex.build(jax.random.PRNGKey(1), jnp.asarray(vecs))
    art = flat_pq_artifact_from_numpy(jax.tree.map(np.asarray, jart), "cpu")
    index = get_index(IndexConfig(num_subspaces=4, num_centroids=16))
    jeng = jax_engine.RetrievalEngine(jindex, jart, k=k, block_q=block_q,
                                      max_queue=max_queue)
    teng = engine.RetrievalEngine(index, art, k=k, block_q=block_q,
                                  max_queue=max_queue, device="cpu")
    return jeng, teng


def test_retrieval_engine_counters_equal_to_jax():
    jeng, teng = _engines()
    jst = jax_engine.drive_random_query_stream(jeng, 16, 30, 12, seed=2)
    tst = engine.drive_random_query_stream(teng, 16, 30, 12, seed=2)
    for c in ("requests", "lookups", "padded_lookups", "flushes"):
        assert getattr(tst, c) == getattr(jst, c), c
    assert tst.flushes > 1 and tst.lookups_per_s > 0


def test_retrieval_engine_flush_splits_scores_and_ids_per_request():
    jeng, teng = _engines()
    rng = np.random.default_rng(6)
    reqs = [rng.normal(size=(n, 16)).astype(np.float32) for n in (1, 5, 16)]
    reqs.append(rng.normal(size=16).astype(np.float32))        # one (d,)
    for r in reqs:
        assert jeng.submit(r) == teng.submit(r)
    jouts, touts = jeng.flush(), teng.flush()
    assert len(touts) == len(jouts) == 4
    for r, (js, ji), (ts, ti) in zip(reqs, jouts, touts):
        rows = 1 if r.ndim == 1 else r.shape[0]
        assert tuple(ts.shape) == tuple(ti.shape) == (rows, 10)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js),
                                   atol=SCORE_TOL)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert teng.stats().padded_lookups == 32          # 23 -> 2 x 16
    s, i = teng.search(reqs[0])
    assert tuple(i.shape) == (1, 10)


def test_retrieval_engine_refuses_unported_modes():
    _, teng = _engines()
    with pytest.raises(NotImplementedError, match="distributed"):
        engine.RetrievalEngine(teng.index, teng.artifact, k=5, mesh=object(),
                               device="cpu")
    with pytest.raises(ValueError, match="index kind 'flat_pq' has no "
                       "host-staged serve path"):
        engine.RetrievalEngine(teng.index, teng.artifact, k=5,
                               host_staged=True, device="cpu")
    assert teng.flush() == []
