"""The port's two-tower retrieval slice against the JAX package.

* the training-path forward (``quantize`` / ``lookup_train`` /
  ``Embedding.apply``) the user tower runs: codes identical, rows
  bit-identical (the straight-through value is computed as JAX
  computes it), aux loss to 1e-5;
* ``TwoTower`` at ``smoke_config()`` with the JAX params carried
  across: tower outputs to 1e-5, index codes identical given the same
  vectors and centroids, retrieval ids equal;
* the serve CLI's retrieval path, on the CPU;
* ``loss`` (in-batch sampled softmax with logQ correction) within 1e-5
  and the gradient of every parameter within 1e-5 of ``jax.grad``, with
  ``full``, ``dpq`` and ``mgqe`` tables; a planted fault (the softmax
  temperature left out) fails that bar;
* 5 ``fit`` steps of ``launch.train.recsys_setup`` against the JAX
  launcher's ``_recsys_setup`` step on the same batches: every loss,
  every step's gradients and the final accumulators within 1e-5;
  every final param within float32 rounding of a float64 adagrad
  over the port's own gradients and apart from JAX's by no more
  than the two packages' replays are (see TOL).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import two_tower_retrieval as jax_tt_config
from repro.core import Embedding as JaxEmbedding
from repro.core import EmbeddingConfig as JaxConfig
from repro.core import dpq as jax_dpq
from repro.launch import train as jax_train
from repro.models.recsys.two_tower import TwoTower as JaxTwoTower
from repro.retrieval import IndexConfig as JaxIndexConfig
from repro.retrieval import flat_pq as jax_flat_pq
from repro_torch.configs import get_arch
from repro_torch.convert import (flat_pq_artifact_from_numpy,
                                 opt_state_from_numpy, params_from_numpy,
                                 two_tower_params_from_numpy)
from repro_torch.core import Embedding, EmbeddingConfig, dpq
from repro_torch.core.schemes.base import tree_leaves
from repro_torch.launch import serve
from repro_torch.launch import train as train_cli
from repro_torch.models.recsys import two_tower
from repro_torch.models.recsys.two_tower import TwoTower
from repro_torch.nn import initializers, mlp
from repro_torch.retrieval import IndexConfig, flat_pq
from repro_torch.train.loop import LoopConfig, fit
from repro_torch.train.optimizer import (TrainState, adagrad_replay,
                                         record_adagrad)

AUX_TOL = 1e-5
VEC_TOL = 1e-5
TOL = 1e-5              # losses, grads, 5 training steps
# adagrad's first step on an element divides its gradient g by |g| +
# eps (1e-8): the update moves by lr * eps / (|g| + eps)^2 per unit of
# gradient, 2.5e5 at |g| = eps, so a gradient two packages compute 1e-9
# apart (after a cancellation) moves the element by a few 1e-4.  So the
# fit test holds every step's gradients within TOL of JAX's, every
# param within float32 rounding of a float64 adagrad over the gradients
# the port's own updates consumed (``adagrad_replay``: this holds however
# ill-conditioned the step), and its gap to JAX's param within what the
# two packages' replays are apart.
LR32 = float(np.float32(1e-2))      # adagrad's lr as the step holds it
EPS = 1e-8
STEPS = 5
LOSS_BATCH = 64

TIERS = dict(num_subspaces=4, num_centroids=16, tier_boundaries=(30,))
CONFIGS = {
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
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(kw, seed=0):
    jemb = JaxEmbedding(JaxConfig(**kw, kernel_backend="xla"))
    jparams = jemb.init(jax.random.PRNGKey(seed))
    cfg = EmbeddingConfig(**kw)
    temb = Embedding(cfg, device="cpu")
    return jemb, jparams, temb, params_from_numpy(_np(jparams), cfg, "cpu")


# ---------------------------------------------- the training forward

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_apply_forward_matches_jax(name):
    """Rows bit-identical and aux to 1e-5, ids across every tier and
    repeated, with a leading batch shape."""
    jemb, jparams, temb, tparams = _pair(CONFIGS[name])
    vocab = CONFIGS[name]["vocab_size"]
    ids = np.random.default_rng(1).integers(0, vocab, (3, 40))
    ids[0, :3] = (0, vocab - 1, 0)
    jrows, jaux = jemb.apply(jparams, jnp.asarray(ids, jnp.int32))
    rows, aux = temb.apply(tparams, torch.from_numpy(ids))
    assert tuple(rows.shape) == (3, 40, CONFIGS[name]["dim"])
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    assert aux.dtype == torch.float32 and aux.dim() == 0
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0,
                               atol=AUX_TOL)


@pytest.mark.parametrize("k_limit", [False, True])
def test_quantize_codes_identical_to_jax(k_limit):
    rng = np.random.default_rng(2)
    e = (rng.normal(size=(64, 32)) * 0.2).astype(np.float32)
    cent = (rng.normal(size=(8, 32, 4)) * 0.2).astype(np.float32)
    lim = rng.choice([32, 8], size=64).astype(np.int32) if k_limit else None
    jq, jcodes, jaux = jax_dpq.quantize(
        e, cent, k_limit=None if lim is None else jnp.asarray(lim),
        beta=0.5)
    q, codes, aux = dpq.quantize(
        torch.from_numpy(e), torch.from_numpy(cent),
        k_limit=None if lim is None else torch.from_numpy(lim), beta=0.5)
    assert codes.dtype == torch.int32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(aux), float(jaux), atol=AUX_TOL)
    if lim is not None:
        assert (codes.numpy() < lim[:, None]).all()


def test_straight_through_gradient_reaches_the_table():
    """The forward is the centroid; the gradient of the STE term goes to
    the full-table rows unchanged (the training slice tests the rest)."""
    rng = np.random.default_rng(3)
    e = torch.from_numpy(rng.normal(size=(5, 8)).astype(np.float32))
    e.requires_grad_(True)
    cent = torch.from_numpy(rng.normal(size=(2, 4, 4)).astype(np.float32))
    q, codes, _ = dpq.quantize(e, cent)
    q.sum().backward()
    assert torch.equal(e.grad, torch.ones_like(e))
    rows = dpq.decode_codes(codes, cent).reshape(5, 8)
    np.testing.assert_allclose(q.detach().numpy(), rows.numpy(), atol=1e-6)


# --------------------------------------------------------- init repair

def test_init_scales_in_place_bit_identical():
    """The in-place scale gives the very values the out-of-place one
    did, at one table's peak."""
    def gen():
        return torch.Generator().manual_seed(4)
    want = torch.randn((300, 16), generator=gen()) * 16 ** -0.5
    assert torch.equal(dpq.init_full_table(gen(), 300, 16), want)
    want = torch.randn((4, 16, 4), generator=gen()) * 0.5
    assert torch.equal(dpq.init_centroids(gen(), 4, 16, 4, scale=0.5), want)
    want = torch.randn((7, 3), generator=gen()) * 0.25
    assert torch.equal(initializers.normal(gen(), (7, 3), 0.25), want)


def test_mlp_matches_jax():
    from repro.nn.mlp import mlp as jax_mlp
    from repro.nn.mlp import mlp_init as jax_mlp_init
    jparams = jax_mlp_init(jax.random.PRNGKey(0), (16, 32, 8))
    layers = [{k: torch.from_numpy(np.asarray(v).copy())
               for k, v in layer.items()} for layer in jparams]
    x = np.random.default_rng(5).normal(size=(6, 16)).astype(np.float32)
    for act in ("relu", "gelu", "silu", "tanh"):
        np.testing.assert_allclose(
            mlp.mlp(layers, torch.from_numpy(x), act=act).numpy(),
            np.asarray(jax_mlp(jparams, jnp.asarray(x), act=act)),
            atol=VEC_TOL)
    ours = mlp.mlp_init(torch.Generator().manual_seed(0), (16, 32, 8))
    assert [tuple(layer["w"].shape) for layer in ours] == [(16, 32), (32, 8)]
    assert not ours[0]["b"].any()


# ---------------------------------------------------------- the model

@pytest.fixture(scope="module")
def towers():
    """JAX TwoTower at smoke_config(), its params carried across."""
    _, cfg = get_arch("two-tower-retrieval", smoke=True)
    jcfg = jax_tt_config.smoke_config()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jmodel = JaxTwoTower(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = TwoTower(cfg, device="cpu")
    params = two_tower_params_from_numpy(_np(jparams), model, "cpu")
    return jmodel, jparams, model, params


def test_two_tower_configs_equal_to_jax(towers):
    jmodel, _, model, _ = towers
    for ours, theirs in ((model.user_emb, jmodel.user_emb),
                         (model.item_emb, jmodel.item_emb)):
        assert dataclasses.asdict(ours.cfg) == dataclasses.asdict(theirs.cfg)
    _, full = get_arch("two-tower-retrieval", smoke=False)
    assert dataclasses.asdict(full) == dataclasses.asdict(
        jax_tt_config.CONFIG)


def test_two_tower_tower_outputs_match_jax(towers):
    jmodel, jparams, model, params = towers
    ids = np.arange(0, 30_000, 97)
    for ours, theirs in ((model.user_vec, jmodel.user_vec),
                         (model.item_vec, jmodel.item_vec)):
        v, aux = ours(params, torch.from_numpy(ids))
        jv, jaux = theirs(jparams, jnp.asarray(ids, jnp.int32))
        assert tuple(v.shape) == (len(ids), 32)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=VEC_TOL)
        np.testing.assert_allclose(float(aux), float(jaux), atol=AUX_TOL)
    # blocked item tower == one shot, bit for bit
    item_ids = torch.arange(5000)
    assert torch.equal(model.encode_items(params, item_ids, rows=777),
                       model.item_vec(params, item_ids)[0])


def test_two_tower_index_and_retrieval_match_jax(towers):
    jmodel, jparams, model, params = towers
    n = 3000
    jcfg = JaxIndexConfig(num_subspaces=8, num_centroids=64, iters=4,
                          block_n=64, kernel_backend="xla")
    jindex, jart = jmodel.build_index(jax.random.PRNGKey(1), jparams,
                                      jnp.arange(n, dtype=jnp.int32), jcfg)
    jvecs = np.array(jmodel.encode_items(
        jparams, jnp.arange(n, dtype=jnp.int32)))
    # the port's build steps from JAX's vectors and initial centroids
    key_fit = jax.random.split(jax.random.PRNGKey(1))[1]
    init = np.array(jax_flat_pq.fit_pq(key_fit, jvecs, 8, 64, iters=0))
    cent = flat_pq.lloyd(torch.from_numpy(jvecs), torch.from_numpy(init), 4)
    np.testing.assert_allclose(cent.numpy(), np.asarray(jart["centroids"]),
                               atol=1e-5)
    codes = flat_pq.encode_corpus(torch.from_numpy(jvecs),
                                  torch.from_numpy(np.array(
                                      jart["centroids"])))
    np.testing.assert_array_equal(codes.numpy().astype(np.uint8),
                                  np.asarray(jart["codes"]))
    # the port's own index over the port's tower: same shapes and kinds
    index, art = model.build_index(torch.Generator().manual_seed(1), params,
                                   torch.arange(n), IndexConfig(
                                       num_subspaces=8, num_centroids=64,
                                       iters=4))
    assert art["codes"].dtype == torch.uint8
    assert tuple(art["codes"].shape) == (n, 8)
    # retrieval over JAX's artifact: ids equal, scores to 1e-5
    art_j = flat_pq_artifact_from_numpy(_np(jart), "cpu")
    users = np.arange(0, 50_000, 6_000)
    s, i = model.retrieval_topk(params, index, art_j, torch.from_numpy(users),
                                100)
    js, ji = jmodel.retrieval_topk(jparams, jindex, jart,
                                   jnp.asarray(users, jnp.int32), 100)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=VEC_TOL)
    # single-query ADC and the dense baseline agree with JAX too
    adc = model.retrieval_scores_adc(params, art_j, torch.tensor([7]))
    np.testing.assert_allclose(
        adc.numpy(), np.asarray(jmodel.retrieval_scores_adc(
            jparams, jart, jnp.asarray([7], jnp.int32))), atol=VEC_TOL)
    dense = model.retrieval_scores(params, torch.tensor([7]),
                                   torch.from_numpy(jvecs))
    np.testing.assert_allclose(
        dense.numpy(), np.asarray(jmodel.retrieval_scores(
            jparams, jnp.asarray([7], jnp.int32), jnp.asarray(jvecs))),
        atol=VEC_TOL)


def test_two_tower_unported_paths_raise(towers):
    """No silent move to the CPU: without a card the default raises."""
    if not torch.cuda.is_available():
        _, cfg = get_arch("two-tower-retrieval", smoke=True)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TwoTower(cfg)


def test_build_adc_corpus_is_a_flat_pq_build(towers):
    _, _, model, params = towers
    ids = torch.arange(800)
    art = model.build_adc_corpus(torch.Generator().manual_seed(2), params,
                                 ids, num_subspaces=4, num_centroids=16)
    assert tuple(art["centroids"].shape) == (4, 16, 8)
    scores = model.retrieval_scores_adc(params, art, torch.tensor([3]))
    assert tuple(scores.shape) == (800,) and bool(torch.isfinite(scores).all())


# ------------------------------------------------------------- the CLI

def test_cli_retrieval_runs_on_the_cpu(capsys):
    run = serve.main(["--arch", "two-tower-retrieval", "--device", "cpu",
                      "--candidates", "4000"])
    out = capsys.readouterr().out
    assert "flat_pq index built" in out
    assert "queries/s x top-100" in out and "recall@100" in out
    # the JAX CLI's own stream: 50 requests of 1..16 users
    assert run.stats.requests == 50
    assert run.stats.padded_lookups % 16 == 0
    assert sum(len(r) for r in run.requests) == run.stats.lookups
    assert 0.0 <= run.recall <= 1.0
    assert tuple(run.artifact["codes"].shape) == (4000, 8)


# ------------------------------------------------------------- training

def _loss_batch(cfg, seed=6):
    """Uniform users and items, and a logQ that differs per item (a
    constant one cancels out of the softmax)."""
    rng = np.random.default_rng(seed)
    return {"user_ids": rng.integers(0, cfg.n_users, LOSS_BATCH),
            "item_ids": rng.integers(0, cfg.n_items, LOSS_BATCH),
            "item_logq": np.log(rng.uniform(1e-6, 1e-4, LOSS_BATCH))
            .astype(np.float32)}


def _jbatch(b):
    return {k: jnp.asarray(v, jnp.float32 if k == "item_logq"
                           else jnp.int32) for k, v in b.items()}


def _tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _kind_pair(kind):
    jcfg = dataclasses.replace(jax_tt_config.smoke_config(), embed_kind=kind,
                               kernel_backend="xla")
    jmodel = JaxTwoTower(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(2))
    _, cfg = get_arch("two-tower-retrieval", smoke=True)
    model = TwoTower(dataclasses.replace(cfg, embed_kind=kind), device="cpu")
    return jmodel, jparams, model, two_tower_params_from_numpy(
        _np(jparams), model, "cpu")


@pytest.mark.parametrize("kind", ["full", "dpq", "mgqe"])
def test_two_tower_loss_and_grads_match_jax(kind):
    jmodel, jparams, model, params = _kind_pair(kind)
    b = _loss_batch(model.cfg)
    (_, jm), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(
        jparams, _jbatch(b))
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, m = model.loss(params, _tbatch(b))
    grads = torch.autograd.grad(loss, leaves)
    for k in ("loss", "softmax", "aux"):
        np.testing.assert_allclose(float(m[k].detach()), float(jm[k]),
                                   rtol=TOL, atol=TOL)
    jl = jax.tree_util.tree_leaves(jgrads)
    assert len(jl) == len(grads) == (10 if kind == "full" else 12)
    for g, jg in zip(grads, jl):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=TOL,
                                   atol=TOL)


def test_two_tower_loss_is_finite(towers):
    """The smoke model's loss on the launcher's own first batch: finite,
    the softmax term non-negative (logsumexp >= the gold logit), the loss
    the sum of it and both tables' aux losses."""
    _, _, model, params = towers
    _, _, _, data = train_cli.recsys_setup(model.cfg, 128, device="cpu")
    loss, m = model.loss(params, next(data))
    assert bool(torch.isfinite(loss)) and loss.dim() == 0
    assert float(m["softmax"]) >= 0
    assert float(m["aux"]) > 0
    assert float(loss) == float(m["softmax"] + m["aux"])


def test_two_tower_planted_temperature_fault_fails_the_bar(monkeypatch):
    jmodel, jparams, model, params = _kind_pair("mgqe")
    b = _loss_batch(model.cfg)
    jloss, _ = jmodel.loss(jparams, _jbatch(b))
    monkeypatch.setattr(two_tower, "INV_TEMPERATURE", 1.0)
    loss, _ = model.loss(params, _tbatch(b))
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL,
                                   atol=TOL)


def _jax_steps(jstate, jstep, jdata, steps):
    """The JAX launcher's step, jitted as JAX's ``fit`` jits it, taken
    one step at a time: (final state, each step's metrics, the tape of
    the gradients its updates consumed, each recovered from the step's
    move of the param from p to p' and its accumulator A as
    (p - p') (sqrt(A) + eps) / lr)."""
    def leaves(tree):
        return [np.asarray(x, np.float64)
                for x in jax.tree_util.tree_leaves(tree)]
    jit_step = jax.jit(jstep)
    prev, hist, tape = leaves(jstate.params), [], []
    for _ in range(steps):
        jstate, m = jit_step(jstate, next(jdata))
        p, acc = leaves(jstate.params), leaves(jstate.opt_state["acc"])
        tape.append(("jax", LR32, EPS, [
            torch.from_numpy((q - x) * (np.sqrt(a) + EPS) / LR32)
            for q, x, a in zip(prev, p, acc)]))
        prev = p
        hist.append({k: float(v) for k, v in m.items()})
    return jstate, hist, tape


def _assert_adagrad(p0, final, tape, jfinal, jtape):
    """The final state against JAX's (see TOL): every step's gradients
    and the accumulators within TOL; every param within its rounding
    slack of ``adagrad_replay`` over the port's own gradients, and apart
    from JAX's by at most what the two replays are apart."""
    replay, racc, slack = adagrad_replay(p0, tape)
    jreplay, _, jslack = adagrad_replay(p0, jtape)
    assert len(tape) == len(jtape) == STEPS
    for (_, lr, _, grads), (_, _, _, jgrads) in zip(tape, jtape):
        assert lr == LR32
        for g, jg in zip(grads, jgrads):
            np.testing.assert_allclose(g.numpy(), jg.numpy(), rtol=TOL,
                                       atol=TOL)
    jl = jax.tree_util.tree_leaves(jfinal.params)
    jacc = jax.tree_util.tree_leaves(jfinal.opt_state["acc"])
    tl, acc = tree_leaves(final.params), tree_leaves(final.opt_state["acc"])
    assert len(tl) == len(jl) == len(acc) == len(jacc) == len(replay)
    for t, j, a, ja, r, jr, ra, s, js in zip(tl, jl, acc, jacc, replay,
                                             jreplay, racc, slack, jslack):
        np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=TOL,
                                   atol=TOL)
        t, a = t.double(), a.double()
        assert bool(((a - ra).abs() <= ra * STEPS * 2.0 ** -22).all())
        assert bool(((t - r).abs() <= s).all())
        gap = (t - torch.from_numpy(np.asarray(j, np.float64))).abs()
        assert bool((gap <= (r - jr).abs() + s + js).all())


def test_two_tower_fit_matches_jax_launcher():
    """5 steps of ``fit`` on ``recsys_setup``'s stream and step against
    the JAX launcher's ``_recsys_setup`` on its own, from the same params:
    every loss within 1e-5, the final state as ``_assert_adagrad``
    holds it."""
    jcfg = dataclasses.replace(jax_tt_config.smoke_config(),
                               kernel_backend="xla")
    jstate, jstep, jdata = jax_train._recsys_setup(jcfg, LOSS_BATCH)
    _, cfg = get_arch("two-tower-retrieval", smoke=True)
    model, _, step, data = train_cli.recsys_setup(cfg, LOSS_BATCH,
                                                  device="cpu")
    params = two_tower_params_from_numpy(_np(jstate.params), model, "cpu")
    state = TrainState(params, opt_state_from_numpy(_np(jstate.opt_state),
                                                    params, "cpu"))
    p0 = [t.clone() for t in tree_leaves(params)]
    jfinal, jhist, jtape = _jax_steps(jstate, jstep, jdata, STEPS)
    with record_adagrad() as tape:
        final, hist = fit(state, step, data,
                          LoopConfig(total_steps=STEPS, log_every=1))
    assert [h["step"] for h in hist] == list(range(1, STEPS + 1))
    assert len(jhist) == STEPS
    for h, jh in zip(hist, jhist):
        for k in ("loss", "softmax", "aux"):
            np.testing.assert_allclose(h[k], jh[k], rtol=TOL, atol=TOL)
    _assert_adagrad(p0, final, tape, jfinal, jtape)


def test_two_tower_stream_is_the_jax_stream_and_resumes():
    """The batches equal the JAX launcher's, draw for draw (int32 ids, a
    float32 logQ of 1 / n_items); ``start`` draws and discards the
    batches before it."""
    _, _, jdata = jax_train._recsys_setup(jax_tt_config.smoke_config(), 16)
    _, cfg = get_arch("two-tower-retrieval", smoke=True)
    _, _, _, data = train_cli.recsys_setup(cfg, 16, device="cpu")
    batches = [next(data) for _ in range(3)]
    for b in batches:
        jb = next(jdata)
        assert b["user_ids"].dtype == torch.int32
        assert b["item_logq"].dtype == torch.float32
        for k in ("user_ids", "item_ids", "item_logq"):
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(jb[k]))
    _, _, _, resumed = train_cli.recsys_setup(cfg, 16, device="cpu", start=2)
    r = next(resumed)
    for k in ("user_ids", "item_ids", "item_logq"):
        np.testing.assert_array_equal(r[k].numpy(), batches[2][k].numpy())


def test_two_tower_train_cli_on_cpu(capsys):
    run = train_cli.main(["--arch", "two-tower-retrieval", "--device", "cpu",
                          "--steps", "3", "--batch", "32", "--log-every",
                          "1"])
    assert [h["step"] for h in run.history] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in run.history)
    assert "done: 3 steps" in capsys.readouterr().out
