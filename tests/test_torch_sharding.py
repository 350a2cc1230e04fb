"""The port's distributed serving layer against the JAX package: meshes
(``launch/mesh.py``), placement specs (``sharding/rules.py``), the
sharded quantized gather (``sharding/quantized.py``), the sharded
``ServingEngine`` and ``serve --mesh``.

JAX's own sharded tests fail on this tree (``tests/test_sharding.py``,
``ShardingTypeError``), so the port's sharded outputs are held to JAX's
SINGLE-device ones.  JAX exports and serves in this process; the
artifacts and the expected rows cross to the ranks as numpy arrays.
The ranks are gloo processes on the CPU (``launch.mesh.spawn``), forked
from a server that imported torch and nothing of JAX; each test runs
all its cases in one group, from a ``file://`` store under
``tmp_path``, with bounded start, collectives and join.  Bars:

* specs: equal to ``tuple(P)`` of JAX's ``PartitionSpec`` trees;
* rows: ``torch.equal`` to JAX's single-device ``serve``, for dpq,
  every mgqe variant, rq and mpe, on (2, 2) and (2, 4) meshes.
  ``torch.equal`` holds -0.0 equal to +0.0, as JAX's own sharded tests
  (``assert_array_equal``) do: a decoded -0.0 summed with another
  shard's +0.0 in the psum comes back +0.0.  The tier boundaries lie
  inside shard 1's block on both meshes, so a gather that keyed the
  tiers on local ids would fail.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.convert import artifact_from_numpy
from repro_torch.core import Embedding, EmbeddingConfig
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import spawn

TIMEOUT = 120.0
MESHES = {"2x2": (2, 2), "2x4": (2, 4)}

# tier boundaries at 40 and 80: inside model shard 1 of both meshes
# ([64, 128) on 2x2, [32, 64) on 2x4)
VARIANTS = {
    "dpq": dict(kind="dpq", num_subspaces=4, num_centroids=8),
    "shared_k": dict(kind="mgqe", num_subspaces=4, num_centroids=8,
                     tier_boundaries=(40, 80),
                     tier_num_centroids=(8, 4, 2)),
    "private_k": dict(kind="mgqe", mgqe_variant="private_k",
                      num_subspaces=4, num_centroids=8,
                      tier_boundaries=(40, 80),
                      tier_num_centroids=(8, 4, 2)),
    "private_d": dict(kind="mgqe", mgqe_variant="private_d",
                      num_subspaces=4, num_centroids=8,
                      tier_boundaries=(40, 80),
                      tier_num_subspaces=(4, 2, 1)),
    "rq": dict(kind="rq", num_levels=3, num_centroids=8),
    "mpe": dict(kind="mpe", num_subspaces=8, tier_boundaries=(40, 80),
                tier_bits=(8, 4, 2)),
}
SHAPES = [(8, 8), (7,), (1,), (3, 5), (0,)]


def _cfg_kw(name, vocab=128, **kw):
    return dict(vocab_size=vocab, dim=16, decode_block_b=32,
                **VARIANTS[name], **kw)


def _jax_table(kw, seed=0):
    """JAX's export of one table, as numpy."""
    import jax
    from repro.core import Embedding as JaxEmbedding
    from repro.core import EmbeddingConfig as JaxConfig
    jemb = JaxEmbedding(JaxConfig(**kw, kernel_backend="xla"))
    jart = jemb.export(jemb.init(jax.random.PRNGKey(seed)))
    return jemb, jart, jax.tree.map(np.asarray, jart)


def _jax_rows(jemb, jart, ids):
    import jax.numpy as jnp
    return np.asarray(jemb.serve(jart, jnp.asarray(ids)))


def _port(kw, art_np):
    cfg = EmbeddingConfig(**kw)
    return cfg, artifact_from_numpy(art_np, cfg, "cpu")


def _equal(got, want, what):
    got, want = torch.as_tensor(got), torch.from_numpy(np.array(want))
    assert got.shape == want.shape and got.dtype == want.dtype, what
    assert torch.equal(got, want), what


# ----------------------------------------------------------------------
# specs, no ranks
# ----------------------------------------------------------------------

def _jax_spec_tuples(specs):
    import jax
    from jax.sharding import PartitionSpec as P
    return jax.tree.map(tuple, specs, is_leaf=lambda x: isinstance(x, P))


@pytest.mark.parametrize("name", sorted(VARIANTS))
@pytest.mark.parametrize("hot_rows", [0, 16])
def test_quantized_specs_equal_jax(name, hot_rows):
    from repro.core.schemes import get_scheme as jax_get_scheme
    from repro.core import EmbeddingConfig as JaxConfig
    from repro.sharding import rules as jax_rules
    from repro_torch.core.schemes import get_scheme
    from repro_torch.sharding import rules
    kw = _cfg_kw(name, hot_rows=hot_rows)
    jcfg, cfg = JaxConfig(**kw), EmbeddingConfig(**kw)
    want = _jax_spec_tuples(jax_get_scheme(jcfg).artifact_shard_specs(
        model_axis="mdl"))
    assert get_scheme(cfg).artifact_shard_specs(model_axis="mdl") == want
    assert rules.quantized_artifact_specs(cfg) == _jax_spec_tuples(
        jax_rules.quantized_artifact_specs(jcfg))


class _DataOnlyMesh:
    """A mesh with no ``model`` axis: nothing is split over it, so no
    ranks are needed."""
    shape = {"data": 2}
    size = 2
    device = torch.device("cpu")


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_a_mesh_without_the_model_axis_serves_whole(name):
    """Placement keeps every leaf whole and the gather takes its
    single-device route: JAX's single-device rows."""
    from repro_torch.sharding.quantized import quantized_gather
    from repro_torch.sharding.rules import shard_quantized_artifact
    kw = _cfg_kw(name, hot_rows=16)
    jemb, jart, art_np = _jax_table(kw)
    cfg, art = _port(kw, art_np)
    placed = shard_quantized_artifact(art, cfg, _DataOnlyMesh())
    for got, want in zip(_leaves(placed), _leaves(art), strict=True):
        assert torch.equal(got, want), name
    ids = np.random.default_rng(3).integers(0, 128, (3, 5)).astype(np.int32)
    _equal(quantized_gather(placed, torch.from_numpy(ids), cfg,
                            mesh=_DataOnlyMesh()),
           _jax_rows(jemb, jart, ids), name)


@pytest.mark.parametrize("kind", ["full", "lrf", "sq", "hash"])
def test_unshardable_schemes_refused_as_jax(kind):
    from repro.sharding.quantized import supports_sharding as jax_supports
    from repro.sharding.quantized import sharded_variants as jax_variants
    from repro_torch.core.schemes import get_scheme
    from repro_torch.sharding.quantized import (sharded_variants,
                                                supports_sharding)
    assert not supports_sharding(kind) and not jax_supports(kind)
    assert sharded_variants() == jax_variants()
    kw = dict(vocab_size=64, dim=8, kind=kind)
    if kind == "hash":
        kw["hash_buckets"] = 16
    with pytest.raises(ValueError, match="no quantized artifact"):
        get_scheme(EmbeddingConfig(**kw)).artifact_shard_specs()


def test_spec_tree_and_dp_axes_equal_jax():
    import jax.numpy as jnp
    from repro.sharding import rules as jax_rules
    from repro_torch.sharding import rules
    rule_list = [(r"emb$", lambda leaf: ("model", None)),
                 (r"w\d$", lambda leaf: (None, "model")),
                 (r"stack/", lambda leaf: (("pod", "data"), None))]
    shapes = {"emb": (64, 8), "w1": (3, 8, 16), "bias": (16,),
              "stack": [(2, 4, 4), (5, 3)]}

    def tree(make):
        return {k: [make(s) for s in v] if isinstance(v, list) else make(v)
                for k, v in shapes.items()}

    want = _jax_spec_tuples(jax_rules.spec_tree(
        tree(lambda s: jnp.zeros(s)), rule_list, default=()))
    assert rules.spec_tree(tree(torch.zeros), rule_list) == want
    for multi_pod in (False, True):
        assert rules.dp_axes(multi_pod) == jax_rules.dp_axes(multi_pod)
    assert rules._pad_spec(("model",), 3) == tuple(
        jax_rules._pad_spec(("model",), 3))
    with pytest.raises(ValueError, match="longer than ndim"):
        rules._pad_spec(("a", "b"), 1)


def _production_on_one(rank):
    try:
        mesh_mod.make_production_mesh()
    except ValueError as e:
        return str(e)


def test_mesh_needs_a_group_and_a_named_backend(tmp_path):
    with pytest.raises(RuntimeError, match="none is initialised"):
        mesh_mod.make_debug_mesh(2, 2, device="cpu")
    with pytest.raises(ValueError, match="backend must be one of"):
        spawn(_ok, 2, backend="mpi", store_dir=str(tmp_path))
    # a world of one: the production mesh refuses, it does not shrink
    (msg,) = spawn(_production_on_one, 1, store_dir=str(tmp_path),
                   timeout_s=TIMEOUT)
    assert "256 ranks" in msg and "world size 1" in msg
    assert mesh_mod.rank_device("cpu") == torch.device("cpu")
    assert mesh_mod.rank_device("cuda:3") == torch.device("cuda", 3)


# ----------------------------------------------------------------------
# meshes on 8 ranks, and spawn's failure paths
# ----------------------------------------------------------------------

def _ok(rank):
    return rank


def _mesh_body(rank):
    """Both debug meshes, the production mesh's refusal and the
    collectives' mesh order on one group of 8 ranks."""
    from repro_torch.sharding.collectives import all_gather, axis_index, psum
    from repro_torch.sharding.gather import data_shard_index
    out = {}
    m = mesh_mod.make_debug_mesh(2, 4)
    out["2x4"] = (m.shape, m.axis_names, m.size, str(m.device),
                  axis_index(m, "data"), axis_index(m, "model"),
                  data_shard_index(m, ("data",)))
    t = torch.tensor([float(rank)])
    out["psum_model"] = psum(t, m, "model").item()
    out["psum_all"] = psum(t, m, ("data", "model")).item()
    out["gather_model"] = all_gather(t, m, "model").tolist()
    out["stack_data"] = all_gather(t, m, "data", tiled=False).tolist()
    p = mesh_mod.make_debug_mesh(2, 2, multi_pod=True)
    out["pod"] = (p.shape, p.axis_names, axis_index(p, "pod"),
                  axis_index(p, "data"), axis_index(p, "model"),
                  data_shard_index(p, ("pod", "data")))
    out["gather_pod_data"] = all_gather(t, p, ("pod", "data")).tolist()
    for make in (lambda: mesh_mod.make_production_mesh(),
                 lambda: mesh_mod.make_production_mesh(multi_pod=True),
                 lambda: mesh_mod.make_debug_mesh(2, 2)):
        try:
            make()
            out.setdefault("refused", []).append(None)
        except ValueError as e:
            out.setdefault("refused", []).append(str(e))
    return out


def test_mesh_shapes_and_collectives_on_8_ranks(tmp_path):
    res = spawn(_mesh_body, 8, store_dir=str(tmp_path), timeout_s=TIMEOUT)
    for rank, out in enumerate(res):
        d, m = divmod(rank, 4)
        assert out["2x4"] == ({"data": 2, "model": 4}, ("data", "model"), 8,
                              "cpu", d, m, d)
        assert out["psum_model"] == sum(range(4 * d, 4 * d + 4))
        assert out["psum_all"] == sum(range(8))
        assert out["gather_model"] == [float(4 * d + j) for j in range(4)]
        assert out["stack_data"] == [[float(m)], [float(4 + m)]]
        pod, rem = divmod(rank, 4)
        pd, pm = divmod(rem, 2)
        assert out["pod"] == ({"pod": 2, "data": 2, "model": 2},
                              ("pod", "data", "model"), pod, pd, pm,
                              2 * pod + pd)
        # pod slowest, data next: the data shards in linear order
        assert out["gather_pod_data"] == [float(2 * j + pm)
                                          for j in range(4)]
        r256, r512, r4 = out["refused"]
        assert "256 ranks" in r256 and "world size 8" in r256
        assert "512 ranks" in r512 and "world size 8" in r512
        assert "4 ranks" in r4 and "world size 8" in r4


def _fail_on_one(rank):
    if rank == 1:
        raise ArithmeticError("planted")
    return rank


def _hang_on_one(rank):
    import time
    if rank == 1:
        time.sleep(60)
    return rank


def test_spawn_reports_a_failed_or_hung_rank(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed(.|\n)*"
                       "ArithmeticError: planted"):
        spawn(_fail_on_one, 2, store_dir=str(tmp_path), timeout_s=TIMEOUT)
    with pytest.raises(TimeoutError, match="did not finish within 3s"):
        spawn(_hang_on_one, 2, store_dir=str(tmp_path), timeout_s=3.0)
    assert spawn(_ok, 3, store_dir=str(tmp_path)) == [0, 1, 2]


# ----------------------------------------------------------------------
# quantized_gather
# ----------------------------------------------------------------------

def _gather_body(rank, mesh_shape, cases):
    """Every case's rows through quantized_gather on this rank, and
    through serve with no mesh (the single-device route)."""
    from repro_torch.sharding.quantized import quantized_gather
    from repro_torch.sharding.rules import shard_quantized_artifact
    m = mesh_mod.make_debug_mesh(*mesh_shape)
    out = []
    for kw, art_np, ids_list in cases:
        cfg, art = _port(kw, art_np)
        scfg = dataclasses.replace(cfg, sharded_codes=True)
        art_s = shard_quantized_artifact(art, scfg, m)
        emb = Embedding(scfg, device="cpu")
        rows = []
        for ids in ids_list:
            ids_t = torch.from_numpy(ids)
            rows.append((quantized_gather(art_s, ids_t, scfg, mesh=m).numpy(),
                         emb.serve(art_s, ids_t, mesh=m).numpy(),
                         emb.serve(art, ids_t).numpy()))
        out.append(([tuple(t.shape) for t in
                     (art_s["codes"] if isinstance(art_s["codes"], list)
                      else [art_s["codes"]])], rows))
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_quantized_gather_equals_jax_single_device(mesh, tmp_path):
    """dpq, every mgqe variant, rq and mpe; odd, single and empty
    batches; and a vocabulary that does not divide over model (the
    single-device route, its artifact kept whole)."""
    mesh_shape = MESHES[mesh]
    model_n = mesh_shape[1]
    rng = np.random.default_rng(1)
    cases, want = [], []
    for name in sorted(VARIANTS):
        for vocab in (128, 129):
            kw = _cfg_kw(name, vocab=vocab)
            jemb, jart, art_np = _jax_table(kw)
            ids_list = [rng.integers(0, vocab, s).astype(np.int32)
                        for s in SHAPES]
            cases.append((kw, art_np, ids_list))
            want.append([_jax_rows(jemb, jart, ids) for ids in ids_list])
    res = spawn(_gather_body, model_n * 2, args=(mesh_shape, cases),
                store_dir=str(tmp_path), timeout_s=TIMEOUT)
    for out in res:
        for (kw, _, ids_list), wants, (code_shapes, rows) in zip(
                cases, want, out):
            v = kw["vocab_size"]
            local = v // model_n if v % model_n == 0 else v
            assert {s[0] for s in code_shapes} == {local}, kw
            for ids, w, (got, served, single) in zip(ids_list, wants, rows):
                what = (kw["kind"], kw.get("mgqe_variant"), v, ids.shape)
                assert w.shape == ids.shape + (16,), what
                _equal(got, w, what)
                _equal(served, w, what)
                _equal(single, w, what)


# ----------------------------------------------------------------------
# ServingEngine under a mesh
# ----------------------------------------------------------------------

def _engine_body(rank, mesh_shape, cases, reqs, hot_ids, refresh_ids):
    from repro_torch.launch.engine import ServingEngine
    m = mesh_mod.make_debug_mesh(*mesh_shape)
    out = []
    for kw, art_np in cases:
        cfg, art = _port(kw, art_np)
        emb = Embedding(cfg, device="cpu")
        eng = ServingEngine(emb, art, mesh=m, hot_rows=0)
        handles = [eng.submit(r) for r in reqs]
        flushed = eng.flush()
        cold = [flushed[h].numpy() for h in handles]
        st = eng.stats()
        # the export's hot leaf placed replicated; the block re-decoded
        # through the sharded gather
        hot_eng = ServingEngine(emb, art, mesh=m)
        mixed = hot_eng.lookup(hot_ids).numpy()
        st1 = dataclasses.replace(hot_eng.stats())
        cached = hot_eng.lookup(np.arange(16)).numpy()
        st2 = dataclasses.replace(hot_eng.stats())
        hot_eng.refresh_hot_rows(refresh_ids)
        refreshed = hot_eng.lookup(hot_ids).numpy()
        # the EMA counters pick the same head on every rank
        ema = ServingEngine(emb, art, mesh=m, hot_rows=8,
                            hot_refresh_every=2)
        ema_rows = [ema.lookup(r).numpy() for r in reqs]
        out.append(dict(
            cold=cold, pad=(eng.pad_multiple, eng.data_shards,
                            st.padded_lookups, st.decoded_lookups),
            mixed=mixed, cached=cached, refreshed=refreshed,
            hits=(st1.hot_hits, st1.decoded_lookups, st2.decoded_lookups),
            hot_ids=hot_eng._hot_ids.tolist(), ema=ema_rows,
            ema_ids=ema._hot_ids.tolist()))
    # refusals, as JAX's engine words them
    refused = []
    lrf = EmbeddingConfig(vocab_size=128, dim=16, kind="lrf", rank=4)
    bad_vocab = dict(cases[0][0], vocab_size=129)
    for make in (
            lambda: ServingEngine(Embedding(lrf, device="cpu"),
                                  {}, mesh=m),
            lambda: ServingEngine(Embedding(EmbeddingConfig(**bad_vocab),
                                            device="cpu"), {}, mesh=m),
            lambda: ServingEngine(Embedding(EmbeddingConfig(**cases[0][0]),
                                            device="cpu"), {}, mesh=m,
                                  model_axis="mdl")):
        try:
            make()
            refused.append(None)
        except ValueError as e:
            refused.append(str(e))
    return out, refused


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_serving_engine_under_mesh_equals_jax_single_device(mesh, tmp_path):
    """The sharded engine (JAX's test_sharded_engine_matches_single_device
    and test_sharded_engine_hot_cache_bit_identical, held to JAX's
    single-device engine): odd requests, the pad granularity, the hot
    cache on a mixed batch, a wholly cached flush decoding nothing on
    any rank, a refresh re-decoded through the sharded gather, and an
    EMA-driven refresh every 2 flushes."""
    from repro.launch import engine as jax_engine
    mesh_shape = MESHES[mesh]
    rng = np.random.default_rng(0)
    reqs = [rng.integers(0, 128, n) for n in (5, 40, 1, 17)]
    hot_ids = np.r_[np.arange(8), rng.integers(0, 128, 20), 31, 32, 81]
    refresh_ids = np.arange(64, 96)
    cases, want = [], []
    for name in sorted(VARIANTS):
        kw = _cfg_kw(name, hot_rows=32)
        jemb, jart, art_np = _jax_table(kw)
        assert art_np["hot"].shape == (32, 16)
        ref = jax_engine.ServingEngine(jemb, jart, hot_rows=0)
        handles = [ref.submit(r) for r in reqs]
        flushed = ref.flush()
        want.append(dict(
            cold=[np.asarray(flushed[h]) for h in handles],
            mixed=np.asarray(ref.lookup(hot_ids)),
            cached=np.asarray(ref.lookup(np.arange(16))),
            ema=[np.asarray(ref.lookup(r)) for r in reqs]))
        cases.append((kw, art_np))
    res = spawn(_engine_body, 2 * mesh_shape[1],
                args=(mesh_shape, cases, reqs, hot_ids, refresh_ids),
                store_dir=str(tmp_path), timeout_s=TIMEOUT)
    for out, refused in res:
        for (kw, _), w, got in zip(cases, want, out):
            what = (kw["kind"], kw.get("mgqe_variant"))
            for g, ww in zip(got["cold"], w["cold"]):
                _equal(g, ww, what)
            pad, shards, padded, decoded = got["pad"]
            assert (pad, shards) == (32 * 2, 2) and padded % pad == 0
            assert decoded == padded
            _equal(got["mixed"], w["mixed"], what)
            _equal(got["cached"], w["cached"], what)
            _equal(got["refreshed"], w["mixed"], what)
            hits, decoded1, decoded2 = got["hits"]
            assert hits > 0 and decoded1 > 0, what
            assert decoded2 == decoded1, "a wholly cached flush decodes"
            assert got["hot_ids"] == refresh_ids.tolist()
            for g, ww in zip(got["ema"], w["ema"]):
                _equal(g, ww, what)
        assert "needs a quantized table, got kind='lrf'" in refused[0]
        assert "vocab=129 does not divide over model=" in refused[1]
        assert "has no 'mdl' axis to shard codes over" in refused[2]
    # every rank chose the same EMA head
    assert len({tuple(tuple(o["ema_ids"]) for o in out)
                for out, _ in res}) == 1


def test_engine_refuses_a_device_that_is_not_the_ranks():
    from repro_torch.launch.engine import _engine_device

    class FakeMesh:
        device = torch.device("cpu")
    assert _engine_device(None, FakeMesh()) == torch.device("cpu")
    assert _engine_device("cpu", None) == torch.device("cpu")
    with pytest.raises(ValueError, match="not the mesh rank's device"):
        _engine_device("meta", FakeMesh())


# ----------------------------------------------------------------------
# serve --mesh
# ----------------------------------------------------------------------

CLI_ARGS = ["--arch", "deepfm", "--device", "cpu", "--engine", "--mesh",
            "data=2,model=2", "--dist-backend", "gloo", "--requests", "30",
            "--req-batch", "32"]


def _cli_body(rank, argv):
    import contextlib
    import io
    from repro_torch.launch import serve
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        st = serve.main(argv)
    return st.as_dict(), buf.getvalue()


def test_serve_cli_mesh_on_4_cpu_ranks(tmp_path):
    """``serve --engine --mesh data=2,model=2`` on 4 gloo ranks: every
    rank serves JAX's single-device stream (the same requests, lookups
    and flushes), pads to block_b x 2, and rank 0 alone prints, the
    codes' MB per shard among it."""
    from repro.configs import deepfm as jax_deepfm
    from repro.launch import serve as jax_serve
    jst = jax_serve.serve_engine("recsys", jax_deepfm.smoke_config(), 30,
                                 32, backend="xla")
    res = spawn(_cli_body, 4, args=(CLI_ARGS,), store_dir=str(tmp_path),
                timeout_s=TIMEOUT)
    from repro_torch.configs import get_arch
    from repro_torch.launch.engine import embedding_config_of_arch
    block_b = embedding_config_of_arch(
        "recsys", get_arch("deepfm", smoke=True)[1]).decode_block_b
    for rank, (st, text) in enumerate(res):
        for c in ("requests", "lookups", "flushes"):
            assert st[c] == getattr(jst, c), c
        assert st["padded_lookups"] % (2 * block_b) == 0
        if rank:
            assert text == ""
        else:
            assert "row-sharded x2 ->" in text and "MB/shard" in text
            assert "engine: 30 requests" in text


@pytest.mark.parametrize("argv,match", [
    (["--mesh", "data=2"], "has no 'model' axis to shard codes over"),
    (["--mesh", "data=2,model=2"], "needs 4 ranks, found 1"),
    (["--mesh", "data2"], "bad mesh axis"),
    (["--mesh", "data=1,model=1", "--async"], "--async serves a single"),
])
def test_serve_cli_mesh_refusals(argv, match, capsys):
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(["--arch", "deepfm", "--device", "cpu", "--engine"]
                   + argv)
    assert match in capsys.readouterr().err


def test_serve_cli_mesh_needs_engine(capsys):
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(["--arch", "deepfm", "--device", "cpu", "--mesh",
                    "data=1,model=1"])
    assert "--mesh requires --engine" in capsys.readouterr().err
