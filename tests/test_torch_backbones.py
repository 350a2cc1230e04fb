"""The port's backbones (GMF, NeuMF, SASRec), their samplers and the
paper-reproduction runners against the JAX package, on the CPU.

Each JAX model is initialised from a PRNG key at
``tests/test_models_recsys.py``'s ``_bb_cfg`` size and carried across
with ``repro_torch.convert.backbone_params_from_numpy``; both packages
then run on the same sampler batches (JAX on its ``xla`` route, the
port on its plain versions).  The bars:

* the forward (scores, SASRec's hidden states), the loss and the
  gradient of every parameter within 1e-5 (f32 sums and matmuls in
  another order), for every scheme the paper compares;
* the samplers' batches bit-identical from one seed;
* 5 steps of ``fit`` within 1e-5 of ``benchmarks/common.py::_fit``
  (every step's loss, the final params);
* HR@10 equal; ``run_item2item``'s RMSE within 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import common as jax_common
from repro.data import sampler as jax_sampler
from repro.data.synthetic import aar_like as jax_aar_like
from repro.data.synthetic import movielens_like as jax_movielens_like
from repro.models.recsys import backbones as jax_backbones
from repro_torch.convert import backbone_params_from_numpy
from repro_torch.core.schemes.base import tree_leaves
from repro_torch.data import sampler
from repro_torch.data.synthetic import aar_like, movielens_like
from repro_torch.launch import backbones as runs
from repro_torch.models.recsys import backbones
from repro_torch.models.recsys.backbones import (GMF, BackboneConfig, NeuMF,
                                                 SASRec, make_backbone)

TOL = 1e-5
POINTWISE_KINDS = ["full", "dpq", "mgqe", "lrf", "sq"]
SASREC_KINDS = ["full", "dpq", "mgqe"]
N_USERS, N_ITEMS = 100, 80
# short histories, so a SASRec batch of maxlen 10 holds left-padded rows
DATA = dict(n_users=N_USERS, n_items=N_ITEMS, mean_len=6, seed=0)


def _bb_cfg(model, kind="mgqe", cls=BackboneConfig):
    return cls(model=model, n_users=N_USERS, n_items=N_ITEMS, dim=16,
               embed_kind=kind, num_subspaces=4, num_centroids=16,
               tier_tail_centroids=8, mlp_dims=(16, 8), maxlen=10,
               n_blocks=1)


def _pair(model, kind, seed=0):
    """(jax model, jax params, port model, port params on the CPU)."""
    jm = jax_backbones.make_backbone(
        _bb_cfg(model, kind, jax_backbones.BackboneConfig))
    jp = jm.init(jax.random.PRNGKey(seed))
    m = make_backbone(_bb_cfg(model, kind), device="cpu")
    return jm, jp, m, backbone_params_from_numpy(
        jax.tree.map(np.asarray, jp), m, "cpu")


@pytest.fixture(scope="module")
def data():
    return movielens_like(**DATA)


def _pointwise_batch(data, seed=0):
    return next(iter(sampler.PointwiseSampler(data, batch_pos=16, n_neg=4,
                                              seed=seed)))


def _sequence_batch(data, seed=0, batch=8):
    return next(iter(sampler.SequenceSampler(data, batch=batch, maxlen=10,
                                             seed=seed)))


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _t(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def _loss_and_grads_match(jloss, tloss, jp, p, b):
    """The loss, its metrics and the gradient of every parameter."""
    (jl, jmet), jg = jax.value_and_grad(jloss, has_aux=True)(jp, _j(b))
    leaves = tree_leaves(p)
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss, met = tloss(p, _t(b))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    assert np.isfinite(float(loss.detach()))
    _close(loss, jl)
    assert set(met) == set(jmet)
    for k in met:
        _close(met[k], jmet[k])
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(jleaves) == len(grads)
    for t, g, jgl in zip(leaves, grads, jleaves):
        _close(torch.zeros_like(t) if g is None else g, jgl)


# ------------------------------------------------------------ the models

@pytest.mark.parametrize("model,kind", [("gmf", "mgqe"), ("neumf", "mgqe"),
                                        ("neumf", "lrf"), ("sasrec", "mgqe"),
                                        ("sasrec", "full")])
def test_params_carry_across_leaf_for_leaf(model, kind):
    jm, jp, m, p = _pair(model, kind)
    jl = jax.tree_util.tree_leaves(jp)
    tl = tree_leaves(p)
    assert len(jl) == len(tl)
    for a, t in zip(jl, tl):
        assert t.dtype == torch.float32 and t.shape == a.shape
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))
    # the port's own init has the same tree
    fresh = m.init(torch.Generator().manual_seed(0))
    assert [tuple(t.shape) for t in tree_leaves(fresh)] \
        == [tuple(t.shape) for t in tl]
    with pytest.raises(ValueError, match="params hold"):
        backbone_params_from_numpy({"w": np.zeros(16, np.float32)}, m, "cpu")


@pytest.mark.parametrize("model", ["gmf", "neumf"])
@pytest.mark.parametrize("kind", POINTWISE_KINDS)
def test_pointwise_backbone_matches_jax(data, model, kind):
    jm, jp, m, p = _pair(model, kind)
    b = _pointwise_batch(data)
    jlogits, jaux = jm.score(jp, jnp.asarray(b["user_ids"]),
                             jnp.asarray(b["item_ids"]))
    logits, aux = m.score(p, torch.from_numpy(b["user_ids"]),
                          torch.from_numpy(b["item_ids"]))
    assert logits.shape == (len(b["label"]),)
    _close(logits, jlogits)
    _close(aux, jaux)
    _loss_and_grads_match(jm.loss, m.loss, jp, p, b)


@pytest.mark.parametrize("kind", POINTWISE_KINDS)
def test_gmf_mse_loss_matches_jax(kind):
    jm, jp, m, p = _pair("gmf", kind)
    rng = np.random.default_rng(2)
    b = {"user_ids": rng.integers(0, N_USERS, 64),
         "item_ids": rng.integers(0, N_ITEMS, 64),
         "label": rng.uniform(-1, 1, 64).astype(np.float32)}
    _loss_and_grads_match(jm.mse_loss, m.mse_loss, jp, p, b)


@pytest.mark.parametrize("kind", SASREC_KINDS)
def test_sasrec_matches_jax(data, kind):
    jm, jp, m, p = _pair("sasrec", kind)
    b = _sequence_batch(data)
    assert (b["seq"] == 0).any()             # left-padded rows
    jh, jaux = jm.trunk(jp, jnp.asarray(b["seq"]))
    h, aux = m.trunk(p, torch.from_numpy(b["seq"]))
    assert h.shape == (8, 10, 16)
    _close(h, jh)
    _close(aux, jaux)
    _loss_and_grads_match(jm.loss, m.loss, jp, p, b)


@pytest.mark.parametrize("kind", SASREC_KINDS)
def test_sasrec_all_pad_row_stays_finite_and_matches_jax(data, kind):
    """A row whose every key is pad: its softmax is uniform over -1e30
    scores (JAX's), not NaN, and its hidden states are zeroed."""
    jm, jp, m, p = _pair("sasrec", kind)
    b = _sequence_batch(data, seed=3)
    for k in b:
        b[k][0] = 0
    h, _ = m.trunk(p, torch.from_numpy(b["seq"]))
    assert torch.isfinite(h).all() and not h[0].any()
    _close(h, jm.trunk(jp, jnp.asarray(b["seq"]))[0])
    _loss_and_grads_match(jm.loss, m.loss, jp, p, b)


@pytest.mark.parametrize("model", ["gmf", "neumf", "sasrec"])
def test_served_rows_score_as_the_training_forward(data, model):
    """``export`` then scoring from the served rows: an MGQE model's
    served rows are its centroids, the training forward's e + (c - e),
    within a rounding; on the CPU both assign with the plain version."""
    _, _, m, p = _pair(model, "mgqe")
    art = m.export(p)
    assert set(art) == set(m.tables)
    for name in m.tables:
        assert art[name]["codes"].dtype == torch.uint8
    if model == "sasrec":
        seq = torch.from_numpy(_sequence_batch(data)["seq"])
        got, aux = m.trunk(p, seq, art)
        want, _ = m.trunk(p, seq)
    else:
        b = _pointwise_batch(data)
        ids = (torch.from_numpy(b["user_ids"]),
               torch.from_numpy(b["item_ids"]))
        got, aux = m.score(p, *ids, artifacts=art)
        want, _ = m.score(p, *ids)
    assert float(aux) == 0.0
    _close(got, want, tol=1e-6)


def test_backbones_default_to_the_card():
    cfg = _bb_cfg("gmf")
    if torch.cuda.is_available():
        assert GMF(cfg).device.type == "cuda"
    else:
        for cls in (GMF, NeuMF, SASRec):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cls(cfg)


# ---------------------------------------------------------- the samplers

def test_samplers_bit_identical_to_jax(data):
    jdata = jax_movielens_like(**DATA)
    pairs = [
        (sampler.PointwiseSampler(data, batch_pos=32, n_neg=4, seed=5),
         jax_sampler.PointwiseSampler(jdata, batch_pos=32, n_neg=4, seed=5)),
        (sampler.SequenceSampler(data, batch=16, maxlen=10, seed=5),
         jax_sampler.SequenceSampler(jdata, batch=16, maxlen=10, seed=5)),
    ]
    for ours, theirs in pairs:
        it, jit = iter(ours), iter(theirs)
        for _ in range(5):
            b, jb = next(it), next(jit)
            assert set(b) == set(jb)
            for k in b:
                assert b[k].dtype == jb[k].dtype
                np.testing.assert_array_equal(b[k], jb[k])


def test_sharded_iterator_and_prefetcher_match_jax(data):
    jdata = jax_movielens_like(**DATA)
    for host in (0, 1):
        ours = sampler.Prefetcher(sampler.ShardedIterator(
            sampler.SequenceSampler(data, batch=16, maxlen=10, seed=1),
            host, 2))
        theirs = jax_sampler.Prefetcher(jax_sampler.ShardedIterator(
            jax_sampler.SequenceSampler(jdata, batch=16, maxlen=10, seed=1),
            host, 2))
        for _ in range(5):
            b, jb = next(ours), next(theirs)
            assert b["seq"].shape == (8, 10)
            for k in jb:
                np.testing.assert_array_equal(b[k], jb[k])
    with pytest.raises(ValueError, match="not divisible"):
        next(sampler.ShardedIterator(
            sampler.SequenceSampler(data, batch=15, maxlen=10), 0, 2))
    # a finite source ends the prefetcher
    assert list(sampler.Prefetcher(iter([{"a": 1}, {"a": 2}]))) \
        == [{"a": 1}, {"a": 2}]


# ---------------------------------------------------- the training runs

@pytest.mark.parametrize("model,kind", [("gmf", "mgqe"), ("neumf", "mgqe"),
                                        ("sasrec", "mgqe"), ("gmf", "full")])
def test_fit_matches_jax_fit(data, model, kind):
    """5 adam steps of ``fit`` against ``benchmarks/common.py::_fit``
    from the same params and sampler batches: every step's loss and the
    final params within 1e-5."""
    jm, jp, m, p = _pair(model, kind)
    jdata = jax_movielens_like(**DATA)
    if model == "sasrec":
        it = iter(sampler.SequenceSampler(data, batch=16, maxlen=10))
        jit = iter(jax_sampler.SequenceSampler(jdata, batch=16, maxlen=10))
    else:
        it = iter(sampler.PointwiseSampler(data, batch_pos=32))
        jit = iter(jax_sampler.PointwiseSampler(jdata, batch_pos=32))
    jstate, jlosses = jax_common._fit(jm, jp, jm.loss, jit, 5, 1e-2,
                                      log_every=1)
    state, losses = runs.fit(m, p, m.loss, it, 5, 1e-2, log_every=1)
    assert len(losses) == len(jlosses) == 5
    _close(np.asarray(losses), np.asarray(jlosses))
    jleaves = jax.tree_util.tree_leaves(jstate.params)
    leaves = tree_leaves(state.params)
    assert len(leaves) == len(jleaves)
    for t, j in zip(leaves, jleaves):
        _close(t, j)
    assert int(state.step) == 5


def _patched_init(monkeypatch, model, kind):
    """The port's model of ``model`` initialised to the JAX package's
    PRNGKey(0) params (the runners draw their own)."""
    jp = jax.tree.map(np.asarray, _pair(model, kind)[1])
    cls = {"gmf": GMF, "neumf": NeuMF, "sasrec": SASRec}[model]
    monkeypatch.setattr(cls, "init", lambda self, gen=None:
                        backbone_params_from_numpy(jp, self, "cpu"))


@pytest.mark.parametrize("model", ["gmf", "neumf", "sasrec"])
def test_hr_at_10_matches_jax(data, model):
    """HR@10 of the same params on the same users and candidates; ties
    count against the model in both (``>=``), checked on all-equal
    scores."""
    jm, jp, m, p = _pair(model, "full", seed=4)
    jdata = jax_movielens_like(**DATA)
    if model == "sasrec":
        got = runs.hr_at_10_sasrec(m, p, data, 10, n_users_eval=60)
        want = jax_common.hr_at_10_sasrec(jm, jp, jdata, 10,
                                          n_users_eval=60)
    else:
        got = runs.hr_at_10_pointwise(m, p, data, n_users_eval=60)
        want = jax_common.hr_at_10_pointwise(jm, jp, jdata, n_users_eval=60)
    assert 0.0 <= got <= 1.0
    assert got == want
    assert runs._hr_at_10(np.zeros((3, 101))) == 0.0
    users, cand = runs.eval_candidates(data, 60, 100, 7, shift=1)
    assert cand.shape == (60, 101) and cand.min() >= 1
    np.testing.assert_array_equal(cand[:, 0], data.test_item[users] + 1)


@pytest.mark.parametrize("model", ["gmf", "sasrec"])
def test_runners_match_jax(monkeypatch, data, model):
    """``run_pointwise`` / ``run_sasrec`` from the JAX init: the logged
    losses, HR@10 and the size against the JAX runners'."""
    cfg = _bb_cfg(model)
    jcfg = _bb_cfg(model, cls=jax_backbones.BackboneConfig)
    jdata = jax_movielens_like(**DATA)
    _patched_init(monkeypatch, model, "mgqe")
    if model == "sasrec":
        r = runs.run_sasrec(cfg, data, steps=4, eval_users=50, device="cpu")
        jr = jax_common.run_sasrec(jcfg, jdata, steps=4, eval_users=50)
    else:
        r = runs.run_pointwise(model, cfg, data, steps=4, eval_users=50,
                               device="cpu")
        jr = jax_common.run_pointwise(model, jcfg, jdata, steps=4,
                                      eval_users=50)
    _close(np.asarray(r.losses), np.asarray(jr.losses))
    assert (r.scheme, r.metric, r.size_bits) \
        == (jr.scheme, jr.metric, jr.size_bits)
    np.testing.assert_allclose(r.size_pct, jr.size_pct, rtol=1e-12)
    assert r.step_ms > 0 and set(r.params) == set(r.model.tables
                                                  + r.model.dense_keys)


@pytest.mark.parametrize("kind", ["full", "mgqe"])
def test_run_item2item_matches_jax(monkeypatch, kind):
    cfg = dataclasses.replace(_bb_cfg("gmf", kind), n_users=300,
                              n_items=300)
    jcfg = dataclasses.replace(
        _bb_cfg("gmf", kind, jax_backbones.BackboneConfig), n_users=300,
        n_items=300)
    jm = jax_backbones.GMF(jcfg)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    monkeypatch.setattr(backbones.GMF, "init", lambda self, gen=None:
                        backbone_params_from_numpy(jp, self, "cpu"))
    aar = aar_like(n_apps=300, n_pairs=4000, seed=1)
    r = runs.run_item2item(cfg, aar, steps=8, device="cpu")
    jr = jax_common.run_item2item(
        jcfg, jax_aar_like(n_apps=300, n_pairs=4000, seed=1), steps=8)
    assert np.isfinite(r.metric)
    np.testing.assert_allclose(r.metric, jr.metric, rtol=0, atol=1e-4)
    _close(np.asarray(r.losses), np.asarray(jr.losses))


def test_scheme_grid_matches_jax():
    grid = runs.scheme_grid(6040, 3416, "sasrec")
    jgrid = jax_common.scheme_grid(6040, 3416, "sasrec")
    assert list(grid) == list(jgrid)
    for k in grid:
        assert [dataclasses.asdict(c) for c in grid[k]] \
            == [dataclasses.asdict(c) for c in jgrid[k]]
    # the MGQE tables the paper's sweep exports: S = 64 / D, two tiers
    for c in grid["mgqe"]:
        e = c.emb_config(c.n_items + 1)
        assert e.tier_num_centroids == (256, 64) and e.subspace_dim \
            == 64 // c.num_subspaces


def test_rel_gap_verdict():
    assert runs.rel_gap(0.5, 0.55)[1] == "TRACKS"
    gap, verdict = runs.rel_gap(0.4, 0.6)
    assert verdict == "DIVERGES" and abs(gap - 0.5) < 1e-12
