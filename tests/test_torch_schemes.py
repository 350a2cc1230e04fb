"""The port's ``rq`` and ``mpe`` schemes and the ``lrf``/``sq``/``hash``
baselines against the JAX package.

Each JAX table is initialised from a PRNG key and carried across with
``repro_torch.convert``; both packages then export, serve and run the
training forward on the CPU (JAX on its ``xla`` backend, the plain
references).  The bars:

* export artifacts identical leaf for leaf; ``rq`` and ``mpe`` codes
  may differ only where two candidates' distances are equal to within
  ``TIE_TOL`` (f32 dots summed in another order);
* served rows, from the JAX artifact carried across: bit-identical for
  ``mpe`` and ``hash``; within ``SERVE_TOL`` for ``rq`` (its stage sum),
  ``sq`` (``q * scale + lo``, which XLA may fuse) and ``lrf`` (a matmul);
* the ``apply`` forward and its aux loss within ``APPLY_TOL``;
* ``serving_size_bits`` and ``training_param_count`` equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import Embedding as JaxEmbedding
from repro.core import EmbeddingConfig as JaxConfig
from repro.core import baselines as jax_baselines
from repro.kernels.mgqe_decode.ref import rq_decode_stages_ref as jax_rq_ref
from repro.kernels.packed_decode import unpack_codes as jax_unpack
from repro_torch.convert import artifact_from_numpy, params_from_numpy
from repro_torch.core import Embedding, EmbeddingConfig, baselines
from repro_torch.core.schemes import registered_kinds
from repro_torch.core.schemes.base import tree_leaves
from repro_torch.core.serving import size_table
from repro.core.serving import size_table as jax_size_table

TIE_TOL = 1e-5      # distance gap at which two f32 argmins may disagree
SERVE_TOL = 1e-6    # rows that add or multiply in another order
APPLY_TOL = 1e-5    # forward rows and aux losses (sums of squares)

CONFIGS = {
    "rq": dict(vocab_size=300, dim=8, kind="rq", num_levels=3,
               num_centroids=16),
    "rq_m1": dict(vocab_size=200, dim=8, kind="rq", num_levels=1,
                  num_centroids=8),
    "rq_k300": dict(vocab_size=400, dim=8, kind="rq", num_levels=2,
                    num_centroids=300),
    "mpe": dict(vocab_size=300, dim=10, kind="mpe", num_subspaces=5,
                tier_boundaries=(15, 75), tier_bits=(8, 4, 2)),
    "mpe_d8": dict(vocab_size=300, dim=16, kind="mpe", num_subspaces=8,
                   tier_boundaries=(30,), tier_bits=(4, 2)),
    "lrf": dict(vocab_size=300, dim=8, kind="lrf", rank=2),
    "sq": dict(vocab_size=300, dim=8, kind="sq", sq_bits=8),
    "sq12": dict(vocab_size=300, dim=8, kind="sq", sq_bits=12),
    "hash": dict(vocab_size=300, dim=8, kind="hash", hash_buckets=64),
}
EXACT_SERVE = {"mpe", "mpe_d8", "hash"}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == ml_dtypes.bfloat16 else x


def _pair(kw, seed=0):
    """(jax emb, jax params, port emb, port params) on the same tables."""
    jemb = JaxEmbedding(JaxConfig(**kw, kernel_backend="xla"))
    jparams = jemb.init(jax.random.PRNGKey(seed))
    temb = Embedding(EmbeddingConfig(**kw), device="cpu")
    return jemb, jparams, temb, params_from_numpy(_np(jparams), temb.cfg,
                                                  "cpu")


def _dist64(x, c):
    """Squared distances in float64: x (..., S) against c (..., S)."""
    return np.sum((x.astype(np.float64) - c.astype(np.float64)) ** 2, -1)


def _rq_tie_gap(emb, cbs, got, want) -> float:
    """Largest distance gap at each row's first disagreeing stage (the
    residual before it is the same f32 chain in both packages)."""
    gap = 0.0
    for row in np.nonzero((got != want).any(1))[0]:
        r = emb[row].astype(np.float32)
        for m in range(cbs.shape[0]):
            if got[row, m] != want[row, m]:
                gap = max(gap, abs(_dist64(r, cbs[m, got[row, m]])
                                   - _dist64(r, cbs[m, want[row, m]])))
                break
            r = r - cbs[m, got[row, m]]
    return gap


def _mpe_tie_gap(emb, cfg, centroids, got, want) -> float:
    """Largest distance gap over the codes (unpacked) that disagree."""
    d = cfg.num_subspaces
    e_sub = emb.reshape(emb.shape[0], d, -1)
    gap = 0.0
    for b, cent, g, w in zip(cfg.tier_bits, centroids, got, want):
        gc = np.asarray(jax_unpack(jnp.asarray(g), b, d)).astype(np.int64)
        wc = np.asarray(jax_unpack(jnp.asarray(w), b, d)).astype(np.int64)
        for row, sub in zip(*np.nonzero(gc != wc)):
            x = e_sub[row, sub]
            gap = max(gap, abs(_dist64(x, cent[sub, gc[row, sub]])
                               - _dist64(x, cent[sub, wc[row, sub]])))
    return gap


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_export_artifacts_match_jax(name):
    jemb, jparams, temb, tparams = _pair(CONFIGS[name])
    want = _np(jemb.export(jparams))
    got = temb.export(tparams)
    jl, tl = jax.tree.leaves(want), tree_leaves(got)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).removeprefix("torch.") == j.dtype.name
    got_np = jax.tree.map(np.asarray, got,
                          is_leaf=lambda x: isinstance(x, torch.Tensor))
    kind = temb.cfg.kind
    if kind in ("rq", "mpe"):
        emb = np.asarray(jparams["emb"])
        codes_g, codes_w = got_np.pop("codes"), want.pop("codes")
        if kind == "rq":
            gap = _rq_tie_gap(emb, np.asarray(jparams["codebooks"]),
                              codes_g, codes_w)
            n_same = int((codes_g == codes_w).all(1).sum())
        else:
            gap = _mpe_tie_gap(emb, temb.cfg, _np(jparams["centroids"]),
                               codes_g, codes_w)
            n_same = sum(int((g == w).all(1).sum())
                         for g, w in zip(codes_g, codes_w))
            n_same //= len(codes_g)
        assert gap <= TIE_TOL
        assert n_same >= 0.99 * temb.cfg.vocab_size
    for j, t in zip(jax.tree.leaves(want), jax.tree.leaves(got_np)):
        np.testing.assert_array_equal(_bits(t), _bits(j))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_served_rows_match_jax(name):
    jemb, jparams, temb, _ = _pair(CONFIGS[name])
    jart = jemb.export(jparams)
    tart = artifact_from_numpy(_np(jart), temb.cfg, "cpu")
    ids = np.random.default_rng(1).integers(
        0, temb.cfg.vocab_size, (3, 41)).astype(np.int32)
    want = np.asarray(jemb.serve(jart, jnp.asarray(ids)))
    got = temb.serve(tart, torch.from_numpy(ids))
    assert tuple(got.shape) == want.shape == (3, 41, temb.cfg.dim)
    assert got.dtype == torch.float32
    if name in EXACT_SERVE:
        np.testing.assert_array_equal(_bits(got), _bits(want))
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=SERVE_TOL)


def test_bf16_mpe_artifact_serves_bit_identical():
    kw = dict(CONFIGS["mpe"], param_dtype="bfloat16")
    jemb = JaxEmbedding(JaxConfig(**kw, kernel_backend="xla"))
    jart = jemb.export(jemb.init(jax.random.PRNGKey(2)))
    cfg = EmbeddingConfig(**kw)
    tart = artifact_from_numpy(_np(jart), cfg, "cpu")
    ids = np.arange(cfg.vocab_size, dtype=np.int32)
    want = np.asarray(jemb.serve(jart, jnp.asarray(ids)))
    got = Embedding(cfg, device="cpu").serve(tart, torch.from_numpy(ids))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_apply_forward_matches_jax(name):
    jemb, jparams, temb, tparams = _pair(CONFIGS[name])
    ids = np.random.default_rng(2).integers(
        0, temb.cfg.vocab_size, (3, 17)).astype(np.int32)
    jout, jaux = jemb.apply(jparams, jnp.asarray(ids))
    tout, taux = temb.apply(tparams, torch.from_numpy(ids))
    assert tuple(tout.shape) == (3, 17, temb.cfg.dim)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=0, atol=APPLY_TOL)
    assert taux.dtype == torch.float32 and taux.dim() == 0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=APPLY_TOL,
                               atol=APPLY_TOL)


@pytest.mark.parametrize("hot_rows", [0, 7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_sizes_equal_to_jax(name, dtype, hot_rows):
    kw = dict(CONFIGS[name], param_dtype=dtype, hot_rows=hot_rows)
    jcfg, tcfg = JaxConfig(**kw), EmbeddingConfig(**kw)
    assert tcfg.serving_size_bits() == jcfg.serving_size_bits()
    assert tcfg.training_param_count() == jcfg.training_param_count()


def test_size_table_of_every_kind_equal_to_jax():
    """The paper's size table: every scheme at one width, FE = 100%."""
    kws = [dict(vocab_size=300, dim=8)] + [
        dict(CONFIGS[n], vocab_size=300) for n in
        ("lrf", "sq", "hash", "rq")] + [dict(CONFIGS["mpe_d8"],
                                             vocab_size=300, dim=8,
                                             num_subspaces=4)]
    got = size_table([EmbeddingConfig(**kw) for kw in kws])
    want = jax_size_table([JaxConfig(**kw) for kw in kws])
    assert got == want
    assert [r["kind"] for r in got] == ["full", "lrf", "sq", "hash", "rq",
                                        "mpe"]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_export_matches_artifact_struct(name):
    temb = Embedding(EmbeddingConfig(**CONFIGS[name]), device="cpu")
    art = temb.export(temb.init(temb.generator(1)))
    shapes = lambda tree: [(tuple(t.shape), t.dtype)
                           for t in tree_leaves(tree)]
    assert shapes(art) == shapes(temb.serving_artifact_struct())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_init_shapes_match_jax_and_follow_the_seed(name):
    kw = CONFIGS[name]
    temb = Embedding(EmbeddingConfig(**kw), device="cpu")
    params = temb.init(temb.generator(3))
    jparams = JaxEmbedding(JaxConfig(**kw)).init(jax.random.PRNGKey(0))
    _shape = lambda tree: [tuple(np.shape(x)) for x in tree_leaves(tree)]
    assert _shape(params) == [s.shape for s in jax.tree.leaves(jparams)]
    again = temb.init(temb.generator(3))
    other = temb.init(temb.generator(4))
    for a, b, c in zip(tree_leaves(params), tree_leaves(again),
                       tree_leaves(other)):
        assert torch.equal(a, b) and not torch.equal(a, c)


def test_hash_buckets_identical_to_jax():
    """JAX multiplies in uint32 with wraparound; the port emulates it in
    int64.  Ids up to 2**31 - 1, at several bucket counts."""
    ids = np.concatenate([np.arange(1000), np.random.default_rng(0).integers(
        0, 2 ** 31 - 1, 5000), [2 ** 31 - 1]]).astype(np.int32)
    for buckets in (1, 64, 1000, 2_500_000, 2 ** 31 - 1):
        want = np.asarray(jax_baselines._hash_ids(jnp.asarray(ids), buckets))
        got = baselines.hash_ids(torch.from_numpy(ids), buckets)
        np.testing.assert_array_equal(got.numpy(), want)


def test_sq_codes_round_half_to_even_as_jax():
    """Values landing exactly on .5 steps: both packages round to even."""
    emb = np.tile(np.arange(0, 8.5, 0.5, dtype=np.float32)[:, None], (1, 4))
    emb[:, 1] *= -1.0
    kw = dict(vocab_size=emb.shape[0], dim=4, kind="sq", sq_bits=4)
    cfg = EmbeddingConfig(**kw)
    got = baselines.sq_export({"emb": torch.from_numpy(emb)}, cfg)
    want = jax_baselines.sq_export({"emb": jnp.asarray(emb)}, JaxConfig(**kw))
    for k in ("q", "lo", "scale"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_rq_decode_adds_stages_in_the_reference_order():
    """A -0.0 row of stage 0 plus -0.0 rows stays -0.0, as in the JAX
    reference (a sum started from +0.0 would give +0.0)."""
    cbs = np.full((3, 4, 5), -0.0, np.float32)
    cbs[:, 1] = np.random.default_rng(0).normal(size=(3, 5))
    codes = np.array([[0, 0, 0], [1, 0, 1], [1, 1, 1]], np.uint8)
    want = np.asarray(jax_rq_ref(jnp.asarray(codes), jnp.asarray(cbs)))
    cfg = EmbeddingConfig(vocab_size=3, dim=5, kind="rq", num_levels=3,
                          num_centroids=4)
    got = Embedding(cfg, device="cpu").serve(
        {"codes": torch.from_numpy(codes), "codebooks": torch.from_numpy(cbs)},
        torch.arange(3))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert bool(torch.signbit(got[0]).all())


@pytest.mark.parametrize("bad", [
    dict(vocab_size=10, dim=8, kind="rq", num_levels=0),
    dict(vocab_size=10, dim=8, kind="rq", num_centroids=1),
    dict(vocab_size=10, dim=10, kind="mpe", num_subspaces=3,
         tier_boundaries=(5,), tier_bits=(8, 4)),
    dict(vocab_size=10, dim=8, kind="mpe", num_subspaces=4,
         tier_boundaries=(5,), tier_bits=(8,)),
    dict(vocab_size=10, dim=8, kind="mpe", num_subspaces=4,
         tier_boundaries=(5,), tier_bits=(8, 3)),
    dict(vocab_size=10, dim=8, kind="mpe", num_subspaces=4,
         tier_boundaries=(5,), tier_bits=(2, 4)),
    dict(vocab_size=10, dim=8, kind="mpe", num_subspaces=4,
         tier_boundaries=(10,), tier_bits=(8, 4)),
    dict(vocab_size=10, dim=8, kind="lrf", rank=0),
    dict(vocab_size=10, dim=8, kind="sq", sq_bits=0),
    dict(vocab_size=10, dim=8, kind="hash", hash_buckets=0),
])
def test_config_validation_matches_jax(bad):
    with pytest.raises(ValueError):
        JaxConfig(**bad)
    with pytest.raises(ValueError):
        EmbeddingConfig(**bad)


def test_registry_holds_every_jax_kind():
    from repro.core.schemes import registered_kinds as jax_kinds
    assert registered_kinds() == jax_kinds()
    cfg = EmbeddingConfig(**CONFIGS["sq"])
    assert Embedding(cfg, device="cpu").scheme.hot_dtype == torch.float32
    bf = dataclasses.replace(cfg, param_dtype="bfloat16")
    assert Embedding(bf, device="cpu").scheme.hot_dtype == torch.float32
