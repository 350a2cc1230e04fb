"""The port's sharded retrieval (``retrieval/sharded.py`` over
``Index.local_topk``, the retrieval half of ``sharding/rules.py``, the
``RetrievalEngine`` under a mesh) against the JAX package's
single-device search: JAX's own sharded test fails on this tree
(``tests/test_sharding.py``), so the sizes are its
(``test_sharded_retrieval_topk_bit_identical_all_kinds``) and the
reference is JAX's ``index.search`` and single-device engine.

JAX builds every index in this process; its coarse table and PQ
centroids are rounded to multiples of 1/8 and so are the queries, so
every LUT entry, coarse score and sum is exact in any order and the two
packages' scores are equal bit for bit, ties included (as
``tests/test_torch_ivf.py``'s dyadic tests do).  The artifacts and the
expected results cross to the ranks as numpy arrays; the ranks are gloo
processes on the CPU (``launch.mesh.spawn``), one group a test from a
``file://`` store under ``tmp_path``.  Scores and ids must equal JAX's
(``torch.equal``, which holds -0.0 equal to +0.0 as JAX's tests do).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.convert import (flat_pq_artifact_from_numpy,
                                 ivf_pq_artifact_from_numpy)
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import spawn
from repro_torch.retrieval import IndexConfig, get_index

TIMEOUT = 120.0
MESHES = {"2x2": (2, 2), "2x4": (2, 4)}
KINDS = ("flat_pq", "ivf_pq")


def _dyadic(a, scale=8.0, lim=2.0):
    return (np.clip(np.round(np.asarray(a) * scale), -lim * scale,
                    lim * scale) / scale).astype(np.float32)


def _jax_index(jcfg, vecs, seed=2):
    """JAX's index and its dyadic artifact (numpy)."""
    import jax
    from repro.retrieval import get_index as jax_get_index
    index = jax_get_index(jcfg)
    art = {n: np.array(v) for n, v in
           index.build(jax.random.PRNGKey(seed), vecs).items()}
    for name in ("coarse", "centroids"):
        if name in art:
            art[name] = _dyadic(art[name])
    return index, art


def _jax_search(index, art, q, k):
    import jax.numpy as jnp
    s, i = index.search({n: jnp.asarray(v) for n, v in art.items()},
                        jnp.asarray(q), k)
    return np.asarray(s), np.asarray(i)


def _port_index(jcfg_dict, art_np):
    cfg = IndexConfig(**dict(jcfg_dict, block_n=None))
    convert = (ivf_pq_artifact_from_numpy if cfg.kind == "ivf_pq"
               else flat_pq_artifact_from_numpy)
    return get_index(cfg), convert(art_np, "cpu")


def _equal(got, want, what):
    got, want = torch.as_tensor(got), torch.from_numpy(np.array(want))
    assert got.shape == want.shape and got.dtype == want.dtype, what
    assert torch.equal(got, want), what


def _cases():
    """(name, JAX config, corpus, queries, k) as JAX's sharded test:
    every kind's probe config over 2048 x 16 at k = 50, IVF with k past
    its candidates (64 rows), and IVF over a skewed corpus whose chains
    spill under a tight list cap."""
    import jax
    from repro.retrieval import IndexConfig as JaxIndexConfig
    from repro.retrieval import index_class as jax_index_class
    vecs = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (2048, 16)))
    q = _dyadic(np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                             (8, 16))), lim=1.0)
    out = [(kind, jax_index_class(kind).probe_config(), vecs, q, 50)
           for kind in KINDS]
    small = JaxIndexConfig(kind="ivf_pq", num_subspaces=4, num_centroids=16,
                           iters=3, nlist=8, nprobe=2)
    out.append(("ivf_k_past_candidates", small, vecs[:64], q, 40))
    cents = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (8, 16)))
    g = np.repeat(np.arange(8), [1200, 400, 200, 100, 60, 40, 28, 20])
    skewed = (cents[g] + 0.05 * np.random.default_rng(3).normal(
        size=(2048, 16))).astype(np.float32)
    spill = JaxIndexConfig(kind="ivf_pq", num_subspaces=4, num_centroids=16,
                           iters=3, nlist=8, nprobe=8, list_cap_quantile=0.5)
    out.append(("ivf_spilled", spill, skewed, q, 50))
    return out


# ----------------------------------------------------------------------
# specs, no ranks
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_retrieval_specs_equal_jax(kind):
    import jax
    from jax.sharding import PartitionSpec as P
    from repro.retrieval import index_class as jax_index_class
    from repro.sharding import rules as jax_rules
    from repro_torch.sharding import rules
    jcfg = jax_index_class(kind).probe_config()
    vecs = np.random.default_rng(0).normal(size=(256, 16)).astype(np.float32)
    jindex, art_np = _jax_index(jcfg, vecs)
    index, art = _port_index(dataclasses.asdict(jcfg), art_np)
    want = jax.tree.map(tuple, jax_rules.retrieval_artifact_specs(
        jindex, art_np, model_axis="mdl"), is_leaf=lambda x: isinstance(x, P))
    assert index.artifact_shard_specs(art, model_axis="mdl") == want
    assert rules.retrieval_artifact_specs(index, art) == jax.tree.map(
        tuple, jindex.artifact_shard_specs(art_np),
        is_leaf=lambda x: isinstance(x, P))
    assert index.supports_sharded and jindex.supports_sharded


@pytest.mark.parametrize("kind", KINDS)
def test_a_mesh_without_the_model_axis_searches_whole(kind):
    """Placement keeps every leaf whole and ``sharded_topk`` takes its
    single-device route: JAX's single-device search."""
    from repro.retrieval import index_class as jax_index_class
    from repro_torch.retrieval import sharded_topk
    from repro_torch.sharding.rules import shard_retrieval_artifact

    class DataOnlyMesh:
        shape = {"data": 2}
        size = 2
        device = torch.device("cpu")

    jcfg = jax_index_class(kind).probe_config()
    vecs = np.random.default_rng(0).normal(size=(256, 16)).astype(np.float32)
    q = _dyadic(np.random.default_rng(1).normal(size=(5, 16)), lim=1.0)
    jindex, art_np = _jax_index(jcfg, vecs)
    index, art = _port_index(dataclasses.asdict(jcfg), art_np)
    placed = shard_retrieval_artifact(art, index, DataOnlyMesh())
    assert set(placed) == set(art)
    for name in art:
        assert torch.equal(placed[name], art[name]), name
    s, i = sharded_topk(index, placed, torch.from_numpy(q), 10,
                        mesh=DataOnlyMesh())
    ws, wi = _jax_search(jindex, art_np, q, 10)
    _equal(s, ws, kind)
    _equal(i, wi, kind)


# ----------------------------------------------------------------------
# sharded_topk and the engine on gloo ranks
# ----------------------------------------------------------------------

def _topk_body(rank, mesh_shape, cases, reqs, ks):
    from repro_torch.launch.engine import RetrievalEngine
    from repro_torch.retrieval import sharded_topk
    from repro_torch.sharding.rules import shard_retrieval_artifact
    m = mesh_mod.make_debug_mesh(*mesh_shape)
    out = []
    for cfg_dict, art_np, q, k in cases:
        index, art = _port_index(cfg_dict, art_np)
        art_s = shard_retrieval_artifact(art, index, m)
        blocks = {name: bool(torch.equal(art_s[name], art[name].chunk(
            mesh_shape[1])[m.axis_index("model")]))
            for name in index.rows_leaves}
        q_t = torch.from_numpy(q)
        res = [sharded_topk(index, art_s, q_t[:b], k, mesh=m)
               for b in (8, 5, 1)]
        eng = RetrievalEngine(index, art, k=ks, block_q=4, mesh=m)
        handles = [eng.submit(r) for r in reqs]
        flushed = eng.flush()
        out.append(dict(
            blocks=blocks, topk=[(s.numpy(), i.numpy()) for s, i in res],
            single=[x.numpy() for x in sharded_topk(index, art, q_t, k)],
            engine=[(flushed[h][0].numpy(), flushed[h][1].numpy())
                    for h in handles],
            pad=(eng.pad_multiple, eng.data_shards)))
    refused = []
    cfg_dict, art_np, _, _ = cases[-1]
    index, art = _port_index(dict(cfg_dict, host_staged=True), art_np)
    odd = dict(art, list_codes=art["list_codes"][:-1],
               list_ids=art["list_ids"][:-1])
    for make in (
            lambda: RetrievalEngine(index, art, k=5, mesh=m),
            lambda: RetrievalEngine(get_index(IndexConfig(kind="ivf_pq")),
                                    odd, k=5, mesh=m),
            lambda: shard_retrieval_artifact(odd, index, m),
            lambda: RetrievalEngine(get_index(IndexConfig(kind="ivf_pq")),
                                    art, k=5, mesh=m, model_axis="mdl")):
        try:
            make()
            refused.append(None)
        except ValueError as e:
            refused.append(str(e))
    return out, refused


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_topk_and_engine_equal_jax_single_device(mesh, tmp_path):
    """flat_pq and ivf_pq, k past the candidates, spilled chains, odd
    and single-query batches; the engine over odd requests (pad
    granularity block_q x data shards) against JAX's single-device
    engine; each rank's rows leaves its own block; the refusals."""
    from repro.launch import engine as jax_engine
    mesh_shape = MESHES[mesh]
    rng = np.random.default_rng(0)
    reqs = [_dyadic(rng.normal(size=(n, 16)), lim=1.0) for n in (5, 1, 3)]
    ks = 13
    cases, want = [], []
    for name, jcfg, vecs, q, k in _cases():
        jindex, art_np = _jax_index(jcfg, vecs)
        if name == "ivf_spilled":
            assert art_np["list_chain"].shape[1] > 1     # chains spill
        ref_eng = jax_engine.RetrievalEngine(jindex, art_np, k=ks, block_q=4)
        handles = [ref_eng.submit(r) for r in reqs]
        flushed = ref_eng.flush()
        want.append(dict(
            topk=[_jax_search(jindex, art_np, q[:b], k) for b in (8, 5, 1)],
            engine=[tuple(np.asarray(x) for x in flushed[h])
                    for h in handles]))
        cases.append((dataclasses.asdict(jcfg), art_np, q, k))
    res = spawn(_topk_body, 2 * mesh_shape[1],
                args=(mesh_shape, cases, reqs, ks), store_dir=str(tmp_path),
                timeout_s=TIMEOUT)
    for out, refused in res:
        for (cfg, _, _, k), w, got in zip(cases, want, out):
            what = (cfg["kind"], k)
            assert all(got["blocks"].values()), what
            for (gs, gi), (ws, wi) in zip(got["topk"], w["topk"]):
                _equal(gs, ws, what)
                _equal(gi, wi, what)
            _equal(got["single"][0], w["topk"][0][0], what)
            _equal(got["single"][1], w["topk"][0][1], what)
            for (gs, gi), (ws, wi) in zip(got["engine"], w["engine"]):
                _equal(gs, ws, what)
                _equal(gi, wi, what)
            assert got["pad"] == (4 * 2, 2)
        # k past the candidates pads (-inf, INVALID_ID) as JAX does
        assert np.isneginf(out[2]["topk"][0][0]).any()
        assert "host_staged serving is single-device" in refused[0]
        assert "do not divide over model=" in refused[1]
        assert "do not divide over model=" in refused[2]
        assert "has no 'mdl' axis to shard corpus rows over" in refused[3]


def test_local_topk_ids_are_global_and_the_base_refuses():
    """A shard's partial names corpus rows by their global ids (flat:
    the id is also the tiebreak; IVF: the candidate position), and an
    index kind without rows cannot be distributed."""
    from repro_torch.retrieval.base import Index
    vecs = torch.from_numpy(np.random.default_rng(1).normal(
        size=(256, 16)).astype(np.float32))
    q = vecs[:3]
    index = get_index(IndexConfig(num_subspaces=4, num_centroids=8, iters=2))
    art = index.build(torch.Generator().manual_seed(0), vecs)
    half = dict(art, codes=art["codes"][128:])
    s, tb, i = index.local_topk(half, q, 5, shard=1, num_shards=2)
    ws, wi = index.search(half, q, 5)
    assert torch.equal(s, ws) and torch.equal(i, wi + 128)
    assert torch.equal(tb, i)
    assert not Index(index.cfg).supports_sharded
    with pytest.raises(ValueError, match="cannot be distributed"):
        Index(index.cfg).artifact_shard_specs(art)
    with pytest.raises(NotImplementedError, match="no per-shard top-k"):
        Index(index.cfg).local_topk(art, q, 5, shard=0, num_shards=1)
