"""The port's BST (Behavior Sequence Transformer) against the JAX
package, on the CPU.

The JAX model is initialised from a PRNG key at the smoke config
(30,000 items, MGQE; one block of four heads over 11 positions, MLP
64-32) and carried across with ``repro_torch.convert``; both packages
then run on the same batch of uniform histories and targets (JAX on its
``xla`` route, the port on its plain versions).  Codes are compared
first wherever a forward quantizes.  The bars:

* ``apply`` logits and aux within 1e-5 (f32 sums and matmuls in
  another order);
* ``loss`` within 1e-5 and the gradient of every parameter within 1e-5
  of ``jax.grad``, with the item table as ``full``, ``dpq`` and
  ``mgqe``;
* export codes identical to JAX's; served item rows bit-identical (a
  pure gather), served logits within 1e-5;
* ``serve_ctr`` scores the batch the JAX package's ``serve_ctr`` draws;
* 5 ``fit`` steps of ``launch.train.recsys_setup`` against the JAX
  launcher's ``_recsys_setup`` step on the same batches: every loss,
  every step's gradients and the final accumulators within 1e-5;
  every final param within float32 rounding of a float64 adagrad
  over the port's own gradients and apart from JAX's by no more
  than the two packages' replays are (see TOL);
* a planted fault (``pos_emb`` left out) fails the forward bar.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import bst as jax_bst_config
from repro.core import dpq as jax_dpq
from repro.core.mgqe import _tier_k_limits as jax_tier_limits
from repro.launch import train as jax_train
from repro.models.recsys.bst import BST as JaxBST
from repro_torch.configs import get_arch
from repro_torch.convert import (artifact_from_numpy, bst_params_from_numpy,
                                 opt_state_from_numpy)
from repro_torch.core import dpq
from repro_torch.core.mgqe import _tier_k_limits
from repro_torch.core.schemes.base import tree_leaves
from repro_torch.launch import cells, engine, serve
from repro_torch.launch import train as train_cli
from repro_torch.models.recsys import BST
from repro_torch.train.loop import LoopConfig, fit
from repro_torch.train.optimizer import (TrainState, adagrad_replay,
                                         record_adagrad)

TOL = 1e-5
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
BATCH = 64
STEPS = 5
KINDS = ["full", "dpq", "mgqe"]


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(kind="mgqe", seed=0):
    """(jax model, jax params, port model, port params on the CPU)."""
    jcfg = dataclasses.replace(jax_bst_config.smoke_config(),
                               embed_kind=kind, kernel_backend="xla")
    jmodel = JaxBST(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    _, cfg = get_arch("bst", smoke=True)
    model = BST(dataclasses.replace(cfg, embed_kind=kind), device="cpu")
    return jmodel, jparams, model, bst_params_from_numpy(
        _np(jparams), model, "cpu")


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _batch(seed=3):
    _, cfg = get_arch("bst", smoke=True)
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, cfg.n_items, (BATCH, cfg.seq_len))
    hist[0, :3] = (0, cfg.n_items - 1, 0)
    return {"hist_ids": hist,
            "target_id": rng.integers(0, cfg.n_items, BATCH),
            "label": (rng.random(BATCH) < 0.3).astype(np.float32)}


def _jbatch(b):
    return {k: jnp.asarray(v, jnp.float32 if k == "label" else jnp.int32)
            for k, v in b.items()}


def _tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _all_ids(b):
    return np.concatenate([b["hist_ids"], b["target_id"][:, None]], 1)


def _codes_match(jmodel, jparams, model, params, ids):
    """The item table's training codes for ``ids`` (B, L + 1), both
    packages: identical (checked before any bar that depends on
    them).  Returns whether the table quantizes."""
    jp, tp = jparams["item_emb"], params["item_emb"]
    if "centroids" not in tp:
        return False
    flat = ids.reshape(-1)
    cfg = model.item_emb.cfg
    e = np.asarray(jp["emb"])[flat].reshape(len(flat), cfg.num_subspaces, -1)
    tiered = cfg.tier_boundaries            # mgqe: a budget per tier
    jc = jax_dpq.assign_codes(
        jnp.asarray(e), jp["centroids"],
        jax_tier_limits(jmodel.item_emb.cfg, jnp.asarray(flat))
        if tiered else None)
    tc = dpq.assign_codes(
        torch.from_numpy(e), tp["centroids"],
        _tier_k_limits(cfg, torch.from_numpy(flat)) if tiered else None)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    return True


def _assert_trees(port, jtree, tol):
    jl = jax.tree_util.tree_leaves(jtree)
    tl = tree_leaves(port)
    assert len(jl) == len(tl)
    for t, j in zip(tl, jl):
        assert tuple(t.shape) == np.shape(j)
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   rtol=tol, atol=tol)


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


# ------------------------------------------------------------- the model

def test_configs_equal_to_jax():
    for smoke, jcfg in ((True, jax_bst_config.smoke_config()),
                        (False, jax_bst_config.CONFIG)):
        family, cfg = get_arch("bst", smoke=smoke)
        assert family == "recsys"
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert isinstance(cells.recsys_model(cfg, device="cpu"), BST)
    # the engine serves the item table (10M rows at CONFIG), as JAX's does
    ecfg = engine.embedding_config_of_arch("recsys", cfg)
    assert (ecfg.vocab_size, ecfg.dim, ecfg.kind) == (10_000_000, 32, "mgqe")


def test_params_carry_across_leaf_for_leaf(pair):
    jmodel, jparams, model, params = pair
    jl = jax.tree_util.tree_leaves(jparams)
    tl = tree_leaves(params)
    # one block: ffn (2 layers x (w, b)), ln1, ln2 (scale, bias each),
    # wk, wo, wq, wv; item_emb (centroids, emb); mlp 3 x (w, b); pos_emb
    assert len(jl) == len(tl) == (4 + 2 + 2 + 4) + 2 + 6 + 1
    for a, t in zip(jl, tl):
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))
    fresh = model.init(torch.Generator().manual_seed(0))
    assert [tuple(t.shape) for t in tree_leaves(fresh)] \
        == [tuple(t.shape) for t in tl]
    assert tuple(params["pos_emb"].shape) == (11, 32)
    assert tuple(params["mlp"][0]["w"].shape) == (11 * 32, 64)
    assert tuple(params["blocks"][0]["ffn"][0]["w"].shape) == (32, 128)


def test_apply_matches_jax(pair):
    jmodel, jparams, model, params = pair
    b = _batch()
    assert _codes_match(jmodel, jparams, model, params, _all_ids(b))
    jlogits, jaux = jmodel.apply(jparams, _jbatch(b))
    logits, aux = model.apply(params, _tbatch(b))
    assert tuple(logits.shape) == (BATCH,) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=TOL, atol=TOL)


def test_planted_pos_emb_fault_fails_the_bar(pair, monkeypatch):
    """The trunk with ``pos_emb`` left out (zeroed): the same logits bar
    must fail."""
    jmodel, jparams, model, params = pair
    b = _batch()
    jlogits, _ = jmodel.apply(jparams, _jbatch(b))
    faulty = dict(params, pos_emb=torch.zeros_like(params["pos_emb"]))
    logits, _ = model.apply(faulty, _tbatch(b))
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_loss_and_grads_match_jax(kind):
    jmodel, jparams, model, params = _pair(kind, seed=1)
    b = _batch(seed=4)
    assert _codes_match(jmodel, jparams, model, params, _all_ids(b)) \
        == (kind != "full")
    (jloss, jm), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(
        jparams, _jbatch(b))
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, m = model.loss(params, _tbatch(b))
    grads = torch.autograd.grad(loss, leaves)
    for k in ("loss", "bce", "aux"):
        np.testing.assert_allclose(float(m[k].detach()), float(jm[k]),
                                   rtol=TOL, atol=TOL)
    _assert_trees(list(grads), jgrads, TOL)


# ------------------------------------------------------------- serving

def test_export_and_serve_match_jax(pair):
    """The port's export equal to JAX's, leaf for leaf; rows from the
    JAX artifact bit-identical, logits to 1e-5."""
    jmodel, jparams, model, params = pair
    jart = jmodel.item_emb.export(jparams["item_emb"])
    own = model.item_emb.export(params["item_emb"])
    jl, tl = jax.tree_util.tree_leaves(jart), tree_leaves(own)
    assert len(jl) == len(tl) == 2
    for a, t in zip(jl, tl):
        assert t.numpy().dtype == np.asarray(a).dtype
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))
    assert own["codes"].dtype == torch.uint8
    art = artifact_from_numpy(_np(jart), model.item_emb.cfg, "cpu")
    b = _batch(seed=5)
    ids = _all_ids(b)
    rows = model.item_emb.serve(art, torch.from_numpy(ids))
    assert tuple(rows.shape) == (BATCH, 11, 32)
    np.testing.assert_array_equal(
        rows.numpy(),
        np.asarray(jmodel.item_emb.serve(jart, jnp.asarray(ids, jnp.int32))))
    np.testing.assert_allclose(
        model.serve(params, art, _tbatch(b)).numpy(),
        np.asarray(jmodel.serve(jparams, jart, _jbatch(b))),
        rtol=TOL, atol=TOL)


def test_serve_ctr_scores_the_jax_batch(capsys):
    """``serve_ctr`` draws the JAX package's batch (a uniform history,
    then a uniform target, numpy seed 0) and scores it through the
    served rows; it takes no field ids."""
    _, cfg = get_arch("bst", smoke=True)
    jcfg = jax_bst_config.smoke_config()
    rng = np.random.default_rng(0)
    hist = rng.integers(0, jcfg.n_items, (8, jcfg.seq_len))
    target = rng.integers(0, jcfg.n_items, 8)
    run = serve.main(["--arch", "bst", "--device", "cpu", "--batch", "8"])
    assert "served B=8" in capsys.readouterr().out
    np.testing.assert_array_equal(run.batch["hist_ids"].numpy(), hist)
    np.testing.assert_array_equal(run.batch["target_id"].numpy(), target)
    assert tuple(run.scores.shape) == (8,)
    assert bool(torch.isfinite(run.scores).all())
    np.testing.assert_array_equal(
        run.scores.numpy(),
        run.model.serve(run.params, run.artifacts, run.batch).numpy())
    assert set(run.artifacts) == {"codes", "centroids"}
    assert run.serving_bits == run.model.item_emb.serving_size_bits()
    assert run.full_bits == cfg.n_items * cfg.embed_dim * 32
    with pytest.raises(ValueError, match="no sparse_ids"):
        serve.serve_ctr(cfg, 8, device="cpu",
                        sparse_ids=np.zeros((8, 1), np.int64))


# ------------------------------------------------------------ training

def test_fit_matches_jax_launcher():
    """5 steps of ``fit`` on ``recsys_setup``'s stream and step against
    the JAX launcher's ``_recsys_setup`` on its own, from the same params:
    every loss and the final params and accumulators within 1e-5."""
    jcfg = dataclasses.replace(jax_bst_config.smoke_config(),
                               kernel_backend="xla")
    jstate, jstep, jdata = jax_train._recsys_setup(jcfg, BATCH)
    _, cfg = get_arch("bst", smoke=True)
    model, _, step, data = train_cli.recsys_setup(cfg, BATCH, device="cpu")
    params = bst_params_from_numpy(_np(jstate.params), model, "cpu")
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
        for k in ("loss", "bce", "aux"):
            np.testing.assert_allclose(h[k], jh[k], rtol=TOL, atol=TOL)
    _assert_adagrad(p0, final, tape, jfinal, jtape)


def test_recsys_setup_stream_is_the_jax_stream_and_resumes():
    """The batches equal the JAX launcher's, draw for draw; ``start``
    draws and discards the batches before it."""
    _, _, jdata = jax_train._recsys_setup(jax_bst_config.smoke_config(), 16)
    _, cfg = get_arch("bst", smoke=True)
    _, _, _, data = train_cli.recsys_setup(cfg, 16, device="cpu")
    batches = [next(data) for _ in range(3)]
    for b in batches:
        jb = next(jdata)
        assert b["hist_ids"].dtype == torch.int32
        for k in ("hist_ids", "target_id", "label"):
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(jb[k]))
    _, _, _, resumed = train_cli.recsys_setup(cfg, 16, device="cpu", start=2)
    r = next(resumed)
    for k in ("hist_ids", "target_id", "label"):
        np.testing.assert_array_equal(r[k].numpy(), batches[2][k].numpy())


def test_train_cli_on_cpu(capsys):
    run = train_cli.main(["--arch", "bst", "--device", "cpu", "--steps",
                          "3", "--batch", "32", "--log-every", "1"])
    assert [h["step"] for h in run.history] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in run.history)
    assert "done: 3 steps" in capsys.readouterr().out


def test_defaults_to_the_card():
    """No silent move to the CPU: without a card the defaults raise."""
    if not torch.cuda.is_available():
        _, cfg = get_arch("bst", smoke=True)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BST(cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.serve_ctr(cfg, 4)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cli.train("bst", steps=1, batch=4)
