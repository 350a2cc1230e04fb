"""The port's export-and-serve path against the JAX package.

Each JAX table is initialised from a PRNG key, carried across with
``repro_torch.convert``, and both packages export and serve it on the
CPU: exported codes must be identical, served rows bit-identical, and
the size accounting equal.  JAX runs its ops on the ``xla`` backend
(its plain references).
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
from repro.core import mgqe as jax_mgqe
from repro.core import partition as jax_partition
from repro.core.serving import size_table as jax_size_table
from repro_torch.convert import (artifact_from_numpy, params_from_numpy,
                                 tensor_from_numpy)
from repro_torch.core import Embedding, EmbeddingConfig
from repro_torch.core import dpq, mgqe, partition
from repro_torch.core.schemes import registered_kinds
from repro_torch.core.schemes.base import tree_leaves
from repro_torch.core.serving import format_size_table, size_table

TIERS = dict(num_subspaces=4, num_centroids=16, tier_boundaries=(30,))
CONFIGS = {
    "full": dict(vocab_size=50, dim=8),
    "dpq": dict(vocab_size=300, dim=16, kind="dpq", num_subspaces=4,
                num_centroids=16),
    "dpq_k300": dict(vocab_size=400, dim=8, kind="dpq", num_subspaces=4,
                     num_centroids=300),
    "shared_k": dict(vocab_size=300, dim=16, kind="mgqe",
                     tier_num_centroids=(16, 4), **TIERS),
    "shared_k_3tier": dict(vocab_size=300, dim=16, kind="mgqe",
                           num_subspaces=8, num_centroids=32,
                           tier_boundaries=(20, 100),
                           tier_num_centroids=(32, 8, 2)),
    "private_k": dict(vocab_size=300, dim=16, kind="mgqe",
                      mgqe_variant="private_k",
                      tier_num_centroids=(16, 4), **TIERS),
    "private_d": dict(vocab_size=300, dim=16, kind="mgqe",
                      mgqe_variant="private_d",
                      tier_num_subspaces=(4, 2), **TIERS),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == ml_dtypes.bfloat16 else x


def _pair(kw, seed=0):
    """(jax emb, jax params, jax artifact, port emb, port params)."""
    jemb = JaxEmbedding(JaxConfig(**kw, kernel_backend="xla"))
    jparams = jemb.init(jax.random.PRNGKey(seed))
    jart = jemb.export(jparams)
    temb = Embedding(EmbeddingConfig(**kw), device="cpu")
    tparams = params_from_numpy(_np(jparams), temb.cfg, "cpu")
    return jemb, jparams, jart, temb, tparams


def _assert_trees_equal(jtree, ttree):
    jl = jax.tree.leaves(_np(jtree))
    tl = tree_leaves(ttree)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).removeprefix("torch.") == j.dtype.name
        np.testing.assert_array_equal(_bits(t), _bits(j))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_export_codes_identical_to_jax(name):
    _, _, jart, temb, tparams = _pair(CONFIGS[name])
    _assert_trees_equal(jart, temb.export(tparams))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_served_rows_bit_identical_to_jax(name):
    jemb, _, jart, temb, tparams = _pair(CONFIGS[name])
    tart = temb.export(tparams)
    ids = np.random.default_rng(1).integers(
        0, temb.cfg.vocab_size, (3, 41)).astype(np.int32)
    want = np.asarray(jemb.serve(jart, jnp.asarray(ids)))
    got = temb.serve(tart, torch.from_numpy(ids))
    assert tuple(got.shape) == want.shape == (3, 41, temb.cfg.dim)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("name", ["shared_k", "private_k", "private_d"])
def test_bf16_artifact_serves_bit_identical(name):
    """bfloat16 centroids decode to the same bits in both packages (the
    JAX artifact carried across; bf16 export is a later slice)."""
    kw = dict(CONFIGS[name], param_dtype="bfloat16")
    jemb = JaxEmbedding(JaxConfig(**kw, kernel_backend="xla"))
    jart = jemb.export(jemb.init(jax.random.PRNGKey(2)))
    cfg = EmbeddingConfig(**kw)
    tart = artifact_from_numpy(_np(jart), cfg, "cpu")
    ids = np.arange(cfg.vocab_size, dtype=np.int32)
    want = np.asarray(jemb.serve(jart, jnp.asarray(ids)))
    got = Embedding(cfg, device="cpu").serve(tart, torch.from_numpy(ids))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("hot_rows", [0, 7])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_size_accounting_equal_to_jax(name, hot_rows):
    kw = dict(CONFIGS[name], hot_rows=hot_rows)
    jcfg, tcfg = JaxConfig(**kw), EmbeddingConfig(**kw)
    assert tcfg.serving_size_bits() == jcfg.serving_size_bits()
    assert tcfg.training_param_count() == jcfg.training_param_count()
    for kw2 in (kw, dict(kw, param_dtype="bfloat16")):
        assert (EmbeddingConfig(**kw2).serving_size_bits()
                == JaxConfig(**kw2).serving_size_bits())


def test_size_table_equal_to_jax():
    names = ["full", "dpq", "shared_k", "private_k", "private_d"]
    got = size_table([EmbeddingConfig(**dict(CONFIGS[n], vocab_size=300,
                                              dim=16)) for n in names])
    want = jax_size_table([JaxConfig(**dict(CONFIGS[n], vocab_size=300,
                                            dim=16)) for n in names])
    assert got == want
    assert "100.00" in format_size_table(got)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_export_matches_artifact_struct(name):
    temb = Embedding(EmbeddingConfig(**CONFIGS[name]), device="cpu")
    art = temb.export(temb.init())
    shapes = lambda tree: [(tuple(t.shape), t.dtype)
                           for t in tree_leaves(tree)]
    assert shapes(art) == shapes(temb.serving_artifact_struct())
    assert all(t.device.type == "meta"
               for t in tree_leaves(temb.serving_artifact_struct()))


def test_k_limits_equal_to_jax():
    for name in ("shared_k", "shared_k_3tier"):
        kw = CONFIGS[name]
        want = np.asarray(jax_mgqe.k_limit_for_all_rows(JaxConfig(**kw)))
        got = mgqe.k_limit_for_all_rows(EmbeddingConfig(**kw), "cpu")
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_partition_matches_jax():
    for v, fr in [(1000, (0.1,)), (50, (0.1, 0.5)), (7, (0.01, 0.02))]:
        assert (partition.frequency_boundaries(v, fr)
                == jax_partition.frequency_boundaries(v, fr))
    ids = np.random.default_rng(0).integers(0, 500, 64).astype(np.int32)
    want = jax_partition.tier_of_ids(ids, (10, 100))
    got = partition.tier_of_ids(torch.from_numpy(ids), (10, 100))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(partition.tier_of_ids([5, 10, 400],
                                                        (10, 100)), [0, 1, 2])


@pytest.mark.parametrize("name", ["dpq", "shared_k", "private_k",
                                  "private_d"])
def test_init_shapes_and_scale(name):
    cfg = EmbeddingConfig(**dict(CONFIGS[name], vocab_size=4000))
    temb = Embedding(cfg, device="cpu")
    params = temb.init(temb.generator(3))
    jparams = JaxEmbedding(JaxConfig(**dict(CONFIGS[name],
                                            vocab_size=4000))).init(
        jax.random.PRNGKey(0))
    _shape = lambda tree: [tuple(np.shape(x)) for x in tree_leaves(tree)]
    assert _shape(params) == [s.shape for s in jax.tree.leaves(jparams)]
    std = float(params["emb"].std())
    assert abs(std - cfg.dim ** -0.5) < 0.05 * cfg.dim ** -0.5
    again = temb.init(temb.generator(3))
    assert torch.equal(params["emb"], again["emb"])
    assert not torch.equal(params["emb"], temb.init(temb.generator(4))["emb"])


@pytest.mark.parametrize("lead,k_limit", [((37,), None),
                                          ((3, 11), None),
                                          ((3, 11), 5),
                                          ((3, 11), "per_item")],
                         ids=["flat", "batched", "scalar_limit",
                              "item_limits"])
def test_assign_codes_matches_jax(lead, k_limit):
    """The primitives over leading batch dims, with a broadcast budget."""
    from repro.core import dpq as jax_dpq
    rng = np.random.default_rng(4)
    e = rng.normal(size=lead + (4, 3)).astype(np.float32)
    cent = rng.normal(size=(4, 16, 3)).astype(np.float32)
    if k_limit == "per_item":
        k_limit = rng.integers(1, 17, lead).astype(np.int32)
    lim_j = None if k_limit is None else jnp.asarray(k_limit, jnp.int32)
    lim_t = (None if k_limit is None
             else torch.as_tensor(np.asarray(k_limit, np.int32)))
    et, ct = torch.from_numpy(e), torch.from_numpy(cent)
    np.testing.assert_allclose(
        dpq.subspace_distances(et, ct).numpy(),
        np.asarray(jax_dpq.subspace_distances(jnp.asarray(e),
                                              jnp.asarray(cent))),
        rtol=1e-6, atol=1e-6)    # f32 dots; only the summation order differs
    got = dpq.assign_codes(et, ct, lim_t)
    want = jax_dpq.assign_codes(jnp.asarray(e), jnp.asarray(cent), lim_j)
    assert got.dtype == torch.int32 and tuple(got.shape) == lead + (4,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        _bits(dpq.decode_codes(got, ct)),
        _bits(jax_dpq.decode_codes(want, jnp.asarray(cent))))


def test_decode_codes_matches_serving_gather():
    kw = CONFIGS["dpq"]
    _, _, jart, temb, tparams = _pair(kw)
    art = temb.export(tparams)
    ids = torch.arange(20)
    rows = dpq.decode_codes(art["codes"].index_select(0, ids),
                            art["centroids"])
    assert torch.equal(rows.reshape(20, -1), temb.serve(art, ids))


def test_not_ported_paths_raise():
    cfg = EmbeddingConfig(**CONFIGS["shared_k"])
    temb = Embedding(cfg, device="cpu")
    params = temb.init()
    # the model-parallel row gather is ported: with no mesh a
    # sharded_rows table reads plainly, as JAX's does with no ambient
    # mesh; under a mesh the gather needs the table's global row count.
    # Every arch trains on a mesh (MACE: tests/test_torch_mace_mesh.py)
    # but ogb_products, which mace_cell refuses, naming its bytes
    rows = Embedding(dataclasses.replace(cfg, sharded_rows=True),
                     device="cpu")
    for got, want in zip(rows.apply(params, torch.arange(3)),
                         temb.apply(params, torch.arange(3))):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="global row count"):
        dpq.row_gather(params["emb"], torch.arange(3), mesh=object())
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.launch.cells import mace_cell
    ogb = next(s for s in GNN_SHAPES if s.name == "ogb_products")
    with pytest.raises(ValueError,
                       match=r"285 GB .*\(ROADMAP.md §1 item 8\)"):
        mace_cell(get_arch("mace")[1], ogb, object())
    # the hot-row cache is ported: export attaches the decoded head
    hot = Embedding(dataclasses.replace(cfg, hot_rows=4), device="cpu")
    hot_art = hot.export(params)
    assert torch.equal(hot_art["hot"],
                       hot.serve(hot_art, torch.arange(4)))
    # sharded_codes serving is ported: with no mesh it decodes on one
    # device, as JAX's serve does with no ambient mesh
    sharded = Embedding(dataclasses.replace(cfg, sharded_codes=True),
                        device="cpu")
    art = temb.export(params)
    assert torch.equal(sharded.serve(art, torch.arange(3)),
                       temb.serve(art, torch.arange(3)))


def test_hot_rows_zero_export_is_the_scheme_export():
    temb = Embedding(EmbeddingConfig(**CONFIGS["shared_k"]), device="cpu")
    params = temb.init()
    art = temb.export(params)
    assert set(art) == {"codes", "centroids"}
    assert temb.scheme.attach_hot_rows(art) is art


def test_embedding_defaults_to_the_card():
    """The default device is the card; with none present it raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Embedding(EmbeddingConfig(**CONFIGS["dpq"]))


@pytest.mark.parametrize("bad", [
    dict(vocab_size=10, dim=10, kind="dpq", num_subspaces=3),
    dict(vocab_size=10, dim=8, kind="mgqe", mgqe_variant="nope",
         tier_boundaries=(5,), tier_num_centroids=(4, 2)),
    dict(vocab_size=10, dim=8, kind="mgqe", num_subspaces=4,
         tier_boundaries=(5,), tier_num_centroids=(2, 4)),
    dict(vocab_size=10, dim=8, kind="mgqe", num_subspaces=4,
         tier_boundaries=(10,), tier_num_centroids=(4, 2)),
    dict(vocab_size=10, dim=8, kind="mgqe", num_subspaces=4,
         mgqe_variant="private_d", tier_boundaries=(5,),
         tier_num_subspaces=(3, 2)),
    dict(vocab_size=10, dim=8, hot_rows=11),
])
def test_config_validation_matches_jax(bad):
    with pytest.raises(ValueError):
        JaxConfig(**bad)
    with pytest.raises(ValueError):
        EmbeddingConfig(**bad)


def test_unported_kinds_are_refused_by_name():
    """Every kind of the JAX registry is ported; any other kind is
    refused, naming the registered ones."""
    assert registered_kinds() == ("dpq", "full", "hash", "lrf", "mgqe",
                                  "mpe", "rq", "sq")
    with pytest.raises(ValueError, match="registered schemes: dpq, full"):
        EmbeddingConfig(vocab_size=32, dim=8, kind="dhe")


def test_convert_carries_bf16_bits_and_checks_the_spec():
    a = np.random.default_rng(0).normal(size=(3, 5)).astype(
        ml_dtypes.bfloat16)
    t = tensor_from_numpy(a, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16))
    cfg = EmbeddingConfig(**CONFIGS["dpq"])
    art = {"codes": np.zeros((300, 4), np.int32),      # wrong dtype
           "centroids": np.zeros((4, 16, 4), np.float32)}
    with pytest.raises(ValueError, match="does not match"):
        artifact_from_numpy(art, cfg, "cpu")
    with pytest.raises(ValueError, match="param_dtype"):
        params_from_numpy({"emb": np.zeros((300, 16), np.float64),
                           "centroids": art["centroids"]}, cfg, "cpu")
