"""The port's DeepFM, its field collection and every scheme's backward
against the JAX package.

The JAX model is initialised from a PRNG key at the smoke config (six
fields, the two large ones MGQE) and carried across with
``repro_torch.convert``; both packages then run on the same
``CTRStream`` batch on the CPU (JAX on its ``xla`` backend, the port on
its plain versions).  Codes are compared first wherever a forward
quantizes: the bars below hold only where both packages pick the same
centroids, and the tests check that they do.  The bars:

* ``apply`` logits and aux loss within 1e-5 (f32 sums and matmuls in
  another order);
* ``serve`` from the JAX artifacts: field rows bit-identical (a pure
  gather), logits within 1e-5; the port's own export equal to JAX's;
* ``loss`` within 1e-5 and the gradient of every parameter within 1e-5
  of ``jax.grad``;
* each scheme's ``apply`` backward (``full``, ``dpq``, the three MGQE
  variants, ``rq``, ``mpe``, ``lrf``, ``sq``, ``hash``): the gradients of
  a linear read-out of the rows and, separately, of the aux loss,
  within 1e-5, leaf for leaf.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deepfm as jax_deepfm_config
from repro.core import Embedding as JaxEmbedding
from repro.core import EmbeddingConfig as JaxConfig
from repro.core import dpq as jax_dpq
from repro.models.recsys.deepfm import DeepFM as JaxDeepFM
from repro_torch.configs import get_arch
from repro_torch.convert import (artifact_from_numpy,
                                 deepfm_params_from_numpy, params_from_numpy)
from repro_torch.core import Embedding, EmbeddingConfig, dpq
from repro_torch.core.schemes.base import tree_leaves
from repro_torch.data.synthetic import CTRStream
from repro_torch.launch import cells, serve
from repro_torch.models.recsys.deepfm import DeepFM
from repro_torch.models.recsys.two_tower import TwoTower

TOL = 1e-5
BATCH = 64


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree):
    """Leaves in the port's order (sorted dict keys) — JAX's order too."""
    return tree_leaves(tree)


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, jax model, jax params, port model, port params, batch)."""
    jcfg = dataclasses.replace(jax_deepfm_config.smoke_config(),
                               kernel_backend="xla")
    jmodel = JaxDeepFM(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    _, cfg = get_arch("deepfm", smoke=True)
    model = DeepFM(cfg, device="cpu")
    params = deepfm_params_from_numpy(_np(jparams), model, "cpu")
    b = next(iter(CTRStream(cfg.field_vocab_sizes, BATCH, seed=3)))
    return jcfg, jmodel, jparams, model, params, b


def _jbatch(b):
    return {"sparse_ids": jnp.asarray(b["sparse_ids"], jnp.int32),
            "label": jnp.asarray(b["label"])}


def _tbatch(b):
    return {"sparse_ids": torch.from_numpy(b["sparse_ids"]),
            "label": torch.from_numpy(b["label"])}


def _field_codes_match(jmodel, jparams, model, params, ids):
    """Every quantized field's training codes for ``ids``, both
    packages: identical (checked before any bar that depends on them)."""
    for i, (je, te) in enumerate(zip(jmodel.fields.embs, model.fields.embs)):
        if te.cfg.kind != "mgqe":
            continue
        from repro.core.mgqe import _tier_k_limits as jax_limits
        from repro_torch.core.mgqe import _tier_k_limits
        col = ids[:, i]
        jp, tp = jparams["fields"][f"f{i}"], params["fields"][f"f{i}"]
        e = np.asarray(jp["emb"])[col].reshape(len(col), te.cfg.num_subspaces,
                                               -1)
        jc = jax_dpq.assign_codes(jnp.asarray(e), jp["centroids"],
                                  jax_limits(je.cfg, jnp.asarray(col)))
        tc = dpq.assign_codes(torch.from_numpy(e), tp["centroids"],
                              _tier_k_limits(te.cfg, torch.from_numpy(col)))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


# ------------------------------------------------------------- the model

def test_params_carry_across_leaf_for_leaf(pair):
    _, _, jparams, model, params, _ = pair
    jl = jax.tree_util.tree_leaves(jparams)
    tl = _leaves(params)
    # 2 MGQE fields (emb, centroids) + 4 full, 6 first-order, 3 layers, bias
    assert len(jl) == len(tl) == 2 * 2 + 4 + 6 + 3 * 2 + 1
    for a, t in zip(jl, tl):
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))
    fresh = model.init(torch.Generator().manual_seed(0))
    assert [tuple(t.shape) for t in _leaves(fresh)] \
        == [tuple(t.shape) for t in tl]


def test_apply_matches_jax(pair):
    _, jmodel, jparams, model, params, b = pair
    _field_codes_match(jmodel, jparams, model, params, b["sparse_ids"])
    jlogits, jaux = jmodel.apply(jparams, _jbatch(b))
    logits, aux = model.apply(params, _tbatch(b))
    assert tuple(logits.shape) == (BATCH,) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=TOL, atol=TOL)


def test_serve_matches_jax(pair):
    """Rows from the JAX artifacts bit-identical, logits to 1e-5; the
    port's own export identical to JAX's."""
    _, jmodel, jparams, model, params, b = pair
    jart = jmodel.fields.export(jparams["fields"])
    art = {f"f{i}": artifact_from_numpy(_np(jart[f"f{i}"]), e.cfg, "cpu")
           for i, e in enumerate(model.fields.embs)}
    ids_j = jnp.asarray(b["sparse_ids"], jnp.int32)
    ids_t = torch.from_numpy(b["sparse_ids"])
    rows = model.fields.serve(art, ids_t)
    assert tuple(rows.shape) == (BATCH, 6, 10)
    np.testing.assert_array_equal(rows.numpy(),
                                  np.asarray(jmodel.fields.serve(jart, ids_j)))
    np.testing.assert_allclose(
        model.serve(params, art, {"sparse_ids": ids_t}).numpy(),
        np.asarray(jmodel.serve(jparams, jart, {"sparse_ids": ids_j})),
        rtol=TOL, atol=TOL)
    own = model.fields.export(params["fields"])
    for i in range(6):
        for a, t in zip(jax.tree_util.tree_leaves(jart[f"f{i}"]),
                        _leaves(own[f"f{i}"])):
            np.testing.assert_array_equal(t.numpy(), np.asarray(a))


def test_loss_and_grads_match_jax(pair):
    _, jmodel, jparams, model, params, b = pair
    (jloss, jm), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(
        jparams, _jbatch(b))
    leaves = _leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, m = model.loss(params, _tbatch(b))
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    for k in ("loss", "bce", "aux"):
        np.testing.assert_allclose(float(m[k].detach()), float(jm[k]),
                                   rtol=TOL, atol=TOL)
    jl = jax.tree_util.tree_leaves(jgrads)
    assert len(jl) == len(grads)
    for g, jg in zip(grads, jl):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=TOL,
                                   atol=TOL)


def test_bce_is_written_as_jax_writes_it(pair):
    """At large |logit| the max/log1p form stays finite and exact where
    a naive log(sigmoid) would not."""
    _, _, _, model, params, b = pair
    tb = _tbatch(b)
    params = dict(params, bias=torch.tensor(80.0))
    loss, m = model.loss(params, tb)
    assert torch.isfinite(loss)
    logits, _ = model.apply(params, tb)
    y = tb["label"]
    want = torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-logits.abs())))
    assert float(m["bce"]) == float(want)


def test_field_collection_structure_matches_jax(pair):
    jcfg, jmodel, _, model, _, _ = pair
    assert model.fields.serving_size_bits() \
        == jmodel.fields.serving_size_bits()
    assert model.fields.full_size_bits() == jmodel.fields.full_size_bits()
    jst = jmodel.fields.artifact_struct()
    tst = model.fields.artifact_struct()
    assert sorted(jst) == sorted(tst)
    for k in jst:
        got = [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
               for t in _leaves(tst[k])]
        want = [(tuple(s.shape), str(s.dtype))
                for s in jax.tree_util.tree_leaves(jst[k])]
        assert got == want
    kinds = [e.cfg.kind for e in model.fields.embs]
    assert kinds == ["mgqe", "mgqe", "full", "full", "full", "full"]


def test_recsys_registry():
    _, cfg = get_arch("deepfm", smoke=True)
    assert isinstance(cells.recsys_model(cfg, device="cpu"), DeepFM)
    _, tcfg = get_arch("two-tower-retrieval", smoke=True)
    assert isinstance(cells.recsys_model(tcfg, device="cpu"), TwoTower)
    from repro_torch.models.recsys import BST, AutoInt
    _, acfg = get_arch("autoint", smoke=True)
    assert isinstance(cells.recsys_model(acfg, device="cpu"), AutoInt)
    _, bcfg = get_arch("bst", smoke=True)
    assert isinstance(cells.recsys_model(bcfg, device="cpu"), BST)
    with pytest.raises(ValueError, match="unknown recsys model"):
        cells.recsys_model(dataclasses.replace(cfg, model="dlrm"),
                           device="cpu")
    if not torch.cuda.is_available():                # the card by default
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cells.recsys_model(cfg)


def test_serve_ctr_cli_on_cpu(capsys):
    run = serve.main(["--arch", "deepfm", "--device", "cpu", "--batch",
                      "16"])
    assert isinstance(run, serve.CTRRun)
    assert tuple(run.scores.shape) == (16,)
    assert bool(torch.isfinite(run.scores).all())
    again = run.model.serve(run.params, run.artifacts, run.batch)
    np.testing.assert_array_equal(again.numpy(), run.scores.numpy())
    assert "served B=16" in capsys.readouterr().out
    # the artifacts are what export gives, the field tables gone
    assert set(run.artifacts["f0"]) == {"codes", "centroids"}
    assert run.artifacts["f0"]["codes"].dtype == torch.uint8


def test_serve_ctr_scores_the_jax_batch():
    """Without ``sparse_ids``, ``serve_ctr`` scores the ids the JAX
    package's ``serve_ctr`` draws (uniform per field, numpy seed 0);
    given them, it scores those, and refuses another shape."""
    _, cfg = get_arch("deepfm", smoke=True)
    jcfg = jax_deepfm_config.smoke_config()
    assert cfg.field_vocab_sizes == jcfg.field_vocab_sizes
    rng = np.random.default_rng(0)
    want = np.stack([rng.integers(0, v, 8) for v in jcfg.field_vocab_sizes],
                    1)
    run = serve.serve_ctr(cfg, 8, device="cpu")
    np.testing.assert_array_equal(run.batch["sparse_ids"].numpy(), want)
    ids = next(iter(CTRStream(cfg.field_vocab_sizes, 8, seed=1)))[
        "sparse_ids"]
    given = serve.serve_ctr(cfg, 8, device="cpu", sparse_ids=ids)
    np.testing.assert_array_equal(given.batch["sparse_ids"].numpy(), ids)
    np.testing.assert_array_equal(
        given.scores.numpy(),
        given.model.serve(given.params, given.artifacts,
                          {"sparse_ids": torch.from_numpy(ids)}).numpy())
    with pytest.raises(ValueError, match="sparse_ids"):
        serve.serve_ctr(cfg, 4, device="cpu", sparse_ids=ids)


def test_serve_cli_refuses_unported_models(monkeypatch):
    from repro_torch.configs import registry
    _, cfg = get_arch("deepfm", smoke=True)
    monkeypatch.setattr(registry, "get_arch", lambda a, smoke=False: (
        "recsys", dataclasses.replace(cfg, model="dlrm")))
    monkeypatch.setattr(serve, "get_arch", registry.get_arch)
    with pytest.raises(SystemExit):
        serve.main(["--arch", "deepfm", "--device", "cpu"])


# ------------------------------------------------- every scheme's backward

TIERS = dict(num_subspaces=4, num_centroids=16, tier_boundaries=(30,))
SCHEMES = {
    "full": dict(vocab_size=50, dim=8),
    "dpq": dict(vocab_size=300, dim=16, kind="dpq", num_subspaces=4,
                num_centroids=16),
    "shared_k": dict(vocab_size=300, dim=16, kind="mgqe",
                     tier_num_centroids=(16, 4), **TIERS),
    "private_k": dict(vocab_size=300, dim=16, kind="mgqe",
                      mgqe_variant="private_k",
                      tier_num_centroids=(16, 4), **TIERS),
    "private_d": dict(vocab_size=300, dim=16, kind="mgqe",
                      mgqe_variant="private_d",
                      tier_num_subspaces=(4, 2), **TIERS),
    "rq": dict(vocab_size=300, dim=8, kind="rq", num_levels=3,
               num_centroids=16),
    "mpe": dict(vocab_size=300, dim=10, kind="mpe", num_subspaces=5,
                tier_boundaries=(15, 75), tier_bits=(8, 4, 2)),
    "lrf": dict(vocab_size=300, dim=8, kind="lrf", rank=2),
    "sq": dict(vocab_size=300, dim=8, kind="sq", sq_bits=8),
    "hash": dict(vocab_size=300, dim=8, kind="hash", hash_buckets=64),
}


@pytest.mark.parametrize("target", ["rows", "aux"])
@pytest.mark.parametrize("name", sorted(SCHEMES))
def test_scheme_backward_matches_jax(name, target):
    """d/dparams of sum(rows * R) (the straight-through path to the
    table, and the gather into every codebook) or of the aux loss
    (codebook and commitment terms), every leaf within 1e-5."""
    kw = SCHEMES[name]
    jemb = JaxEmbedding(JaxConfig(**kw, kernel_backend="xla"))
    jparams = jemb.init(jax.random.PRNGKey(4))
    temb = Embedding(EmbeddingConfig(**kw), device="cpu")
    tparams = params_from_numpy(_np(jparams), temb.cfg, "cpu")
    rng = np.random.default_rng(5)
    ids = rng.integers(0, kw["vocab_size"], (4, 30))
    ids[0, :3] = (0, kw["vocab_size"] - 1, 0)
    cot = rng.normal(size=(4, 30, kw["dim"])).astype(np.float32)

    def jloss(p):
        rows, aux = jemb.apply(p, jnp.asarray(ids, jnp.int32))
        return jnp.sum(rows * cot) if target == "rows" else aux

    jval, jgrads = jax.value_and_grad(jloss)(jparams)
    leaves = _leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    rows, aux = temb.apply(tparams, torch.from_numpy(ids))
    val = torch.sum(rows * torch.from_numpy(cot)) if target == "rows" \
        else aux
    # the baselines' aux is a constant 0: no graph, every grad zero
    grads = (torch.autograd.grad(val, leaves, allow_unused=True)
             if val.requires_grad else [None] * len(leaves))
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=TOL,
                               atol=TOL)
    jl = jax.tree_util.tree_leaves(jgrads)
    assert len(jl) == len(grads)
    for g, p, jg in zip(grads, leaves, jl):
        g = torch.zeros_like(p) if g is None else g
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=TOL,
                                   atol=TOL)
