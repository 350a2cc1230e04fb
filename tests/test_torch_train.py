"""The port's training substrate against the JAX package: optimizers,
the loop, checkpoints and the training CLI.

The bars:

* one ``apply_updates`` step of every optimizer kind under every LR
  schedule, clip on and off, from the same params, grads and moments:
  params and moments within 1e-6 (float32, one rounded operation at a
  time in both packages; ``pow``, ``sqrt`` and ``cos`` may differ in the
  last bit);
* ``fit`` for 5 steps of the smoke DeepFM on the same ``CTRStream``
  batches from the same params: loss per step within 1e-4 relative,
  final params within 1e-5.  MGQE training takes an argmin every step,
  and a near-tie could flip a code after an update that differs by one
  ulp; the step-by-step test compares each step's codes before it
  compares anything else, so a flip would fail as a flip;
* checkpoints: a JAX-written ``TrainState`` restored by the port equal
  array for array, and the converse; the port's own round trip, torn
  steps, pruning and corruption fallback as JAX's tests pin them;
* ``fit`` failed at step 3 and resumed from its step-2 checkpoint over
  a fresh stream, as JAX's ``fit`` resumes: the bars of ``fit`` above;
* the training CLI (which hands ``fit`` a stream positioned at the
  checkpoint's step) failed at step 3 and resumed equal to an
  uninterrupted run, bit for bit (the CPU adds in a fixed order).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deepfm as jax_deepfm_config
from repro.core import dpq as jax_dpq
from repro.core.mgqe import _tier_k_limits as jax_tier_limits
from repro.data.synthetic import CTRStream as JaxCTRStream
from repro.models.recsys.deepfm import DeepFM as JaxDeepFM
from repro.train import checkpoint as jax_ckpt
from repro.train import optimizer as jax_opt
from repro.train.loop import LoopConfig as JaxLoopConfig
from repro.train.loop import fit as jax_fit
from repro.train.resilience import FailureInjector as JaxFailureInjector
from repro.train.resilience import SimulatedFailure as JaxSimulatedFailure
from repro_torch.configs import get_arch
from repro_torch.convert import deepfm_params_from_numpy, opt_state_from_numpy
from repro_torch.core import dpq
from repro_torch.core.mgqe import _tier_k_limits
from repro_torch.core.schemes.base import tree_leaves
from repro_torch.data.synthetic import CTRStream
from repro_torch.launch import train as train_cli
from repro_torch.models.recsys.deepfm import DeepFM
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train.loop import LoopConfig, fit
from repro_torch.train.resilience import (FailureInjector, SimulatedFailure,
                                          StragglerDetector)

STEP_TOL = 1e-6          # one optimizer step
LOSS_RTOL = 1e-4         # per-step loss over 5 training steps
PARAM_TOL = 1e-5         # params after 5 training steps
BATCH = 128
STEPS = 5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


def _tree_t(tree):
    return jax.tree.map(_t, _np(tree))


def _assert_trees(port, jtree, tol):
    jl = jax.tree_util.tree_leaves(jtree)
    tl = tree_leaves(port)
    assert len(jl) == len(tl)
    for t, j in zip(tl, jl):
        assert tuple(t.shape) == np.shape(j)
        if tol == 0:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        else:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol,
                                       atol=tol)


# ------------------------------------------------------------- optimizers

KINDS = ["adam", "adamw", "adagrad", "sgd"]
SCHEDULES = ["constant", "cosine", "linear_warmup_cosine"]


def _opt_problem(kind, seed=0):
    """Params, grads and a mid-run state (step 7, moments non-zero)."""
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(5, 3)).astype(np.float32),
              "b": rng.normal(size=(3,)).astype(np.float32),
              "emb": {"t10": rng.normal(size=(7, 2)).astype(np.float32),
                      "t2": rng.normal(size=()).astype(np.float32)}}
    grads = jax.tree.map(
        lambda p: (rng.normal(size=p.shape) * 3).astype(np.float32), params)
    state = {"step": np.asarray(7, np.int32)}
    for k in jax_opt._rule(kind).state_keys:
        state[k] = jax.tree.map(
            lambda p: np.abs(rng.normal(size=p.shape)).astype(np.float32)
            if k in ("v", "acc") else
            rng.normal(size=p.shape).astype(np.float32), params)
    return params, grads, state


@pytest.mark.parametrize("clip", [None, 1.0], ids=["noclip", "clip"])
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("kind", KINDS)
def test_apply_updates_matches_jax(kind, schedule, clip):
    cfg_kw = dict(kind=kind, lr=0.05, schedule=schedule, warmup_steps=10,
                  total_steps=50, grad_clip=clip, weight_decay=0.01)
    params, grads, state = _opt_problem(kind)
    jp, js = jax_opt.apply_updates(
        jax_opt.OptimizerConfig(**cfg_kw), jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, state))
    tp, tg, ts = _tree_t(params), _tree_t(grads), _tree_t(state)
    p_ids = [id(t) for t in tree_leaves(tp)]
    new_p, new_s = opt.apply_updates(opt.OptimizerConfig(**cfg_kw), tp, tg,
                                     ts)
    assert [id(t) for t in tree_leaves(new_p)] == p_ids       # in place
    _assert_trees(new_p, jp, STEP_TOL)
    assert int(new_s["step"]) == int(js["step"]) == 8
    assert new_s["step"].dtype == torch.int32
    for k in jax_opt._rule(kind).state_keys:
        _assert_trees(new_s[k], js[k], STEP_TOL)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_schedule_lr_matches_jax(schedule):
    cfg_kw = dict(lr=0.3, schedule=schedule, warmup_steps=10,
                  total_steps=100, min_lr_frac=0.1)
    for step in (0, 3, 9, 10, 11, 55, 99, 150):
        want = float(jax_opt.schedule_lr(jax_opt.OptimizerConfig(**cfg_kw),
                                         jnp.asarray(step, jnp.int32)))
        got = opt.schedule_lr(opt.OptimizerConfig(**cfg_kw),
                              torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=STEP_TOL)


@pytest.mark.parametrize("kind", ["adam", "adamw"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adam_in_pieces_equals_whole_leaves(kind, dtype, monkeypatch):
    """Adam takes a large leaf in flat pieces (views of the param and its
    moments; float32 temporaries a piece's size): the same bits as the
    whole leaf, a non-contiguous leaf kept whole."""
    g = torch.Generator().manual_seed(2)

    def problem():
        params = {"w": torch.randn(6, 5, generator=g).to(dtype),
                  "t": torch.randn(4, 9, generator=g).to(dtype).T,
                  "b": torch.randn(3, generator=g).to(dtype)}
        grads = {k: torch.randn(v.shape, generator=g).to(dtype)
                 for k, v in params.items()}
        return params, grads

    cfg = opt.OptimizerConfig(kind=kind, lr=1e-2, weight_decay=0.1)
    rule = opt._rule(kind)
    runs = []
    for n in (0, 7):
        g.manual_seed(2)
        params, grads = problem()
        state = opt.init(cfg, params)
        monkeypatch.setattr(rule, "piece_elements", n)
        for _ in range(2):
            params, state = opt.apply_updates(
                cfg, params, {k: v.clone() for k, v in grads.items()}, state)
        runs.append(tree_leaves([params, state]))
    pieces = opt._pieces(7, [torch.zeros(6, 5)], [torch.zeros(6, 5)],
                         {"m": [torch.zeros(6, 5)]})
    assert [t.numel() for t in pieces[0]] == [7, 7, 7, 7, 2]
    for a, b in zip(*runs):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_grad_clip_global_norm():
    g = {"a": torch.tensor([3.0, 4.0])}          # norm 5
    clipped, norm = opt.clip_by_global_norm(g, 1.0)
    assert abs(float(norm) - 5.0) < 1e-5
    np.testing.assert_allclose(clipped["a"].numpy(), [0.6, 0.8], rtol=1e-5)
    small = {"a": torch.tensor([0.3, 0.4])}
    np.testing.assert_array_equal(
        opt.clip_by_global_norm(small, 1.0)[0]["a"].numpy(),
        np.asarray([0.3, 0.4], np.float32))


@pytest.mark.parametrize("kind", KINDS)
def test_init_state_layout_matches_jax(kind):
    params, _, _ = _opt_problem(kind)
    js = jax_opt.init(jax_opt.OptimizerConfig(kind=kind),
                      jax.tree.map(jnp.asarray, params))
    ts = opt.init(opt.OptimizerConfig(kind=kind), _tree_t(params))
    assert sorted(ts) == sorted(js)
    assert ts["step"].dtype == torch.int32 and ts["step"].dim() == 0
    _assert_trees(ts, js, 0)


def test_unknown_optimizer_kind_raises():
    with pytest.raises(ValueError, match="registered"):
        opt.init(opt.OptimizerConfig(kind="lion"), {"w": torch.zeros(2)})


def test_step_fn_updates_in_place_and_releases_grad():
    params = {"w": torch.tensor([2.0, -3.0]), "b": torch.tensor(1.0)}

    def loss_fn(p, batch):
        loss = torch.sum(p["w"] ** 2) + p["b"] ** 2
        return loss, {"loss": loss}

    cfg = opt.OptimizerConfig(kind="sgd", lr=0.1, grad_clip=None)
    state = opt.TrainState.create(cfg, params)
    w = params["w"]
    new, m = opt.make_step_fn(cfg, loss_fn)(state, {})
    assert new.params["w"] is w and not w.requires_grad
    assert not m["loss"].requires_grad
    np.testing.assert_allclose(w.numpy(), [2.0 - 0.4, -3.0 + 0.6],
                               rtol=1e-6)
    assert int(new.step) == 1


# --------------------------------------------------- DeepFM training parity

@pytest.fixture(scope="module")
def deepfm_pair():
    jcfg = dataclasses.replace(jax_deepfm_config.smoke_config(),
                               kernel_backend="xla")
    jmodel = JaxDeepFM(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    _, cfg = get_arch("deepfm", smoke=True)
    model = DeepFM(cfg, device="cpu")
    return jcfg, jmodel, jparams, cfg, model


def _port_state(jstate, model):
    params = deepfm_params_from_numpy(_np(jstate.params), model, "cpu")
    return opt.TrainState(params, opt_state_from_numpy(
        _np(jstate.opt_state), params, "cpu"))


def _adagrad():
    return (jax_opt.OptimizerConfig(kind="adagrad", lr=1e-2),
            opt.OptimizerConfig(kind="adagrad", lr=1e-2))


def _codes_agree(jmodel, jparams, model, params, ids):
    for i, te in enumerate(model.fields.embs):
        if te.cfg.kind != "mgqe":
            continue
        col = ids[:, i]
        e = np.asarray(jparams["fields"][f"f{i}"]["emb"])[col].reshape(
            len(col), te.cfg.num_subspaces, -1)
        jc = jax_dpq.assign_codes(
            jnp.asarray(e), jparams["fields"][f"f{i}"]["centroids"],
            jax_tier_limits(jmodel.fields.embs[i].cfg, jnp.asarray(col)))
        te_e = params["fields"][f"f{i}"]["emb"][torch.from_numpy(col)]
        tc = dpq.assign_codes(
            te_e.reshape(len(col), te.cfg.num_subspaces, -1),
            params["fields"][f"f{i}"]["centroids"],
            _tier_k_limits(te.cfg, torch.from_numpy(col)))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_deepfm_steps_match_jax_step_by_step(deepfm_pair):
    """5 steps, each step's MGQE codes compared first, then the loss;
    the final params and accumulators at the end."""
    jcfg, jmodel, jparams, cfg, model = deepfm_pair
    jocfg, tocfg = _adagrad()
    jstate = jax_opt.TrainState.create(jocfg, jparams)
    state = _port_state(jstate, model)
    jstep = jax.jit(jax_opt.make_step_fn(jocfg, jmodel.loss))
    tstep = opt.make_step_fn(tocfg, model.loss)
    stream = CTRStream(cfg.field_vocab_sizes, BATCH, seed=2)
    for _ in range(STEPS):
        b = stream.next_batch()
        _codes_agree(jmodel, jstate.params, model, state.params,
                     b["sparse_ids"])
        jstate, jm = jstep(jstate, {"sparse_ids": jnp.asarray(
            b["sparse_ids"], jnp.int32), "label": jnp.asarray(b["label"])})
        state, m = tstep(state, {"sparse_ids": torch.from_numpy(
            b["sparse_ids"]), "label": torch.from_numpy(b["label"])})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
    _assert_trees(state.params, jstate.params, PARAM_TOL)
    _assert_trees(state.opt_state["acc"], jstate.opt_state["acc"], PARAM_TOL)
    assert int(state.step) == int(jstate.step) == STEPS


def test_fit_matches_jax_fit(deepfm_pair, tmp_path):
    """Both packages' ``fit`` over the same CTRStream batches."""
    jcfg, jmodel, jparams, cfg, model = deepfm_pair
    jocfg, tocfg = _adagrad()
    # JAX's fit donates the state's buffers: hand it copies, so the
    # fixture's params outlive this test
    jstate = jax_opt.TrainState.create(jocfg, jax.tree.map(jnp.array,
                                                           jparams))
    state = _port_state(jstate, model)

    def jdata():
        for b in JaxCTRStream(jcfg.field_vocab_sizes, BATCH, seed=4):
            yield {"sparse_ids": jnp.asarray(b["sparse_ids"], jnp.int32),
                   "label": jnp.asarray(b["label"])}

    def tdata():
        for b in CTRStream(cfg.field_vocab_sizes, BATCH, seed=4):
            yield {"sparse_ids": torch.from_numpy(b["sparse_ids"]),
                   "label": torch.from_numpy(b["label"])}

    jfinal, jhist = jax_fit(jstate, jax_opt.make_step_fn(jocfg, jmodel.loss),
                            jdata(), JaxLoopConfig(total_steps=STEPS,
                                                   log_every=1))
    final, hist = fit(state, opt.make_step_fn(tocfg, model.loss), tdata(),
                      LoopConfig(total_steps=STEPS, log_every=1))
    assert [h["step"] for h in hist] == [h["step"] for h in jhist] \
        == list(range(1, STEPS + 1))
    for h, jh in zip(hist, jhist):
        for k in ("loss", "bce", "aux"):
            np.testing.assert_allclose(h[k], jh[k], rtol=LOSS_RTOL)
        assert h["step_time_s"] > 0
    _assert_trees(final.params, jfinal.params, PARAM_TOL)


def test_fit_resume_matches_jax_fit(deepfm_pair, tmp_path):
    """Both packages' ``fit`` checkpointing every 2 steps, failed at step
    3, then resumed from the step-2 checkpoint over a fresh stream: the
    resumed steps 3..5 take the stream's first batches in both, so the
    losses and final params agree within the ``fit`` bars."""
    jcfg, jmodel, jparams, cfg, model = deepfm_pair
    jocfg, tocfg = _adagrad()

    def states():
        # JAX's fit donates the state's buffers and the port's updates
        # it in place: each run gets its own copies
        js = jax_opt.TrainState.create(jocfg, jax.tree.map(jnp.array,
                                                           jparams))
        return js, _port_state(js, model)

    def jdata():
        for b in JaxCTRStream(jcfg.field_vocab_sizes, BATCH, seed=6):
            yield {"sparse_ids": jnp.asarray(b["sparse_ids"], jnp.int32),
                   "label": jnp.asarray(b["label"])}

    def tdata():
        for b in CTRStream(cfg.field_vocab_sizes, BATCH, seed=6):
            yield {"sparse_ids": torch.from_numpy(b["sparse_ids"]),
                   "label": torch.from_numpy(b["label"])}

    jstep = jax_opt.make_step_fn(jocfg, jmodel.loss)
    tstep = opt.make_step_fn(tocfg, model.loss)
    jl = JaxLoopConfig(total_steps=STEPS, log_every=1, ckpt_every=2,
                       ckpt_dir=str(tmp_path / "jax"))
    tl = LoopConfig(total_steps=STEPS, log_every=1, ckpt_every=2,
                    ckpt_dir=str(tmp_path / "port"))
    js, ts = states()
    with pytest.raises(JaxSimulatedFailure):
        jax_fit(js, jstep, jdata(), jl,
                injector=JaxFailureInjector(fail_at_steps=[3]))
    with pytest.raises(SimulatedFailure):
        fit(ts, tstep, tdata(), tl,
            injector=FailureInjector(fail_at_steps=[3]))
    assert ckpt.list_steps(tl.ckpt_dir) == jax_ckpt.list_steps(jl.ckpt_dir) \
        == [2]
    js, ts = states()
    jfinal, jhist = jax_fit(js, jstep, jdata(), jl)
    final, hist = fit(ts, tstep, tdata(), tl)
    assert [h["step"] for h in hist] == [h["step"] for h in jhist] \
        == [3, 4, 5]
    for h, jh in zip(hist, jhist):
        for k in ("loss", "bce", "aux"):
            np.testing.assert_allclose(h[k], jh[k], rtol=LOSS_RTOL)
    assert int(final.step) == int(jfinal.step) == STEPS
    _assert_trees(final.params, jfinal.params, PARAM_TOL)


def test_ctr_stream_starts_at_a_batch():
    """``start`` skips the batches before it without drawing them; the
    stream itself is JAX's, draw for draw."""
    vocab = (50, 10_000_000, 7)
    whole = CTRStream(vocab, 16, seed=3)
    batches = [whole.next_batch() for _ in range(4)]
    jax_batches = JaxCTRStream(vocab, 16, seed=3)
    for b in batches:
        jb = jax_batches.next_batch()
        for k in ("sparse_ids", "label"):
            np.testing.assert_array_equal(b[k], jb[k])
    for start in (1, 3):
        late = CTRStream(vocab, 16, seed=3, start=start).next_batch()
        for k in ("sparse_ids", "label"):
            np.testing.assert_array_equal(late[k], batches[start][k])


# ------------------------------------------------------------- checkpoints

def _quad_state(kind="adam"):
    params = {"w": torch.tensor([2.0, -3.0]), "b": torch.tensor(1.0),
              "mlp": [{"w": torch.ones(2, 2)}]}
    return opt.TrainState.create(opt.OptimizerConfig(kind=kind), params)


def test_checkpoint_roundtrip_and_layout(tmp_path):
    state = _quad_state()
    path = ckpt.save(str(tmp_path), 7, state, keep=2)
    assert sorted(os.listdir(path)) == ["COMMITTED", "manifest.json",
                                        "shard_0.npz"]
    restored, step = ckpt.restore_latest(str(tmp_path), state)
    assert step == 7 and isinstance(restored, opt.TrainState)
    for a, b in zip(tree_leaves([state.params, state.opt_state]),
                    tree_leaves([restored.params, restored.opt_state])):
        assert a.dtype == b.dtype and a.shape == b.shape and a is not b
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    keys = [k for k, _ in ckpt._flatten_with_paths(state)]
    assert keys == ["0/b", "0/mlp/[0]/w", "0/w", "1/m/b", "1/m/mlp/[0]/w",
                    "1/m/w", "1/step", "1/v/b", "1/v/mlp/[0]/w", "1/v/w"]


def test_checkpoint_torn_step_is_ignored(tmp_path):
    state = _quad_state()
    ckpt.save(str(tmp_path), 3, state)
    torn = tmp_path / "step_00000009"
    torn.mkdir()
    (torn / "manifest.json").write_text("{}")        # no COMMITTED marker
    (tmp_path / "step_00000010.tmp").mkdir()
    assert ckpt.list_steps(str(tmp_path)) == [3]
    assert ckpt.restore_latest(str(tmp_path), state)[1] == 3


def test_checkpoint_keep_policy(tmp_path):
    state = _quad_state()
    for s in (1, 2, 3, 4):
        ckpt.save(str(tmp_path), s, state, keep=2)
    assert ckpt.list_steps(str(tmp_path)) == [3, 4]
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert len([d for d in os.listdir(tmp_path)
                if d.startswith("step_")]) == 2


def test_checkpoint_corruption_falls_back(tmp_path):
    state = _quad_state()
    ckpt.save(str(tmp_path), 1, state, keep=2)
    ckpt.save(str(tmp_path), 2, state, keep=2)
    with open(tmp_path / "step_00000002" / "shard_0.npz", "wb") as fh:
        fh.write(b"garbage")
    assert ckpt.restore_latest(str(tmp_path), state)[1] == 1
    assert ckpt.restore_latest(str(tmp_path / "none"), state) == (None, -1)


def test_jax_checkpoint_restores_into_the_port_and_back(deepfm_pair,
                                                        tmp_path):
    """A JAX ``TrainState`` after one adagrad step, written by the JAX
    package, read by the port array for array; the port's own write of
    it read back by the JAX package, with the same manifest."""
    jcfg, jmodel, jparams, cfg, model = deepfm_pair
    jocfg, tocfg = _adagrad()
    jstate = jax_opt.TrainState.create(jocfg, jparams)
    b = next(iter(JaxCTRStream(jcfg.field_vocab_sizes, 32, seed=5)))
    jstate, _ = jax.jit(jax_opt.make_step_fn(jocfg, jmodel.loss))(
        jstate, {"sparse_ids": jnp.asarray(b["sparse_ids"], jnp.int32),
                 "label": jnp.asarray(b["label"])})
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_ckpt.save(jdir, 1, jstate)
    template = opt.TrainState.create(
        tocfg, model.init(torch.Generator().manual_seed(9)))
    restored, step = ckpt.restore_latest(jdir, template)
    assert step == 1
    _assert_trees([restored.params, restored.opt_state],
                  [jstate.params, jstate.opt_state], 0)
    ckpt.save(tdir, 1, restored)
    with open(os.path.join(jdir, "step_00000001", "manifest.json")) as f:
        jman = f.read()
    with open(os.path.join(tdir, "step_00000001", "manifest.json")) as f:
        assert f.read() == jman
    back, _ = jax_ckpt.restore_latest(tdir, jstate)
    for a, b_ in zip(jax.tree_util.tree_leaves(back),
                     jax.tree_util.tree_leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b_))


def _bf16_state():
    """An adamw state whose params are bfloat16 (moments float32), one
    optimizer step in."""
    g = torch.Generator().manual_seed(3)
    params = {"w": torch.randn(4, 3, generator=g).to(torch.bfloat16),
              "layers": [{"b": torch.randn(5, generator=g).to(
                  torch.bfloat16)}]}
    cfg = opt.OptimizerConfig(kind="adamw", lr=1e-2)
    state = opt.TrainState.create(cfg, params)
    grads = {"w": torch.randn(4, 3, generator=g).to(torch.bfloat16),
             "layers": [{"b": torch.randn(5, generator=g).to(
                 torch.bfloat16)}]}
    params, opt_state = opt.apply_updates(cfg, params, grads,
                                          state.opt_state)
    return opt.TrainState(params, opt_state)


def test_checkpoint_bf16_roundtrip(tmp_path):
    """bfloat16 leaves go to disk as the JAX trainer's do: 2-byte words
    (``|V2``), ``"dtype": "bfloat16"`` in the manifest; they come back
    bit for bit."""
    import json
    state = _bf16_state()
    path = ckpt.save(str(tmp_path), 1, state)
    with open(os.path.join(path, "manifest.json")) as f:
        arrays = json.load(f)["arrays"]
    assert arrays["0/w"]["dtype"] == "bfloat16"
    assert arrays["0/layers/[0]/b"]["dtype"] == "bfloat16"
    assert arrays["1/m/w"]["dtype"] == "float32"
    with np.load(os.path.join(path, "shard_0.npz")) as z:
        assert z["0|w"].dtype == np.dtype("V2")
        np.testing.assert_array_equal(
            z["0|w"].view(np.int16), state.params["w"].view(torch.int16))
    restored, step = ckpt.restore_latest(str(tmp_path), state)
    assert step == 1
    for a, b in zip(tree_leaves([state.params, state.opt_state]),
                    tree_leaves([restored.params, restored.opt_state])):
        assert a.dtype == b.dtype
        if a.dtype == torch.bfloat16:
            assert torch.equal(a.view(torch.int16), b.view(torch.int16))
        else:
            assert torch.equal(a, b)


def test_jax_bf16_checkpoint_restores_into_the_port(tmp_path):
    """A bfloat16 ``TrainState`` saved by the JAX package restores into
    the port bit for bit, and the port writes the same manifest (crc32s
    included) for it."""
    import ml_dtypes
    state = _bf16_state()
    jparams = {"w": jnp.asarray(state.params["w"].view(torch.int16).numpy()
                                .view(ml_dtypes.bfloat16)),
               "layers": [{"b": jnp.asarray(
                   state.params["layers"][0]["b"].view(torch.int16).numpy()
                   .view(ml_dtypes.bfloat16))}]}
    jocfg = jax_opt.OptimizerConfig(kind="adamw", lr=1e-2)
    jopt = jax.tree.map(lambda t: jnp.asarray(t.numpy()), state.opt_state)
    jstate = jax_opt.TrainState(jparams, jopt)
    assert jax_opt.init(jocfg, jparams).keys() == jopt.keys()
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_ckpt.save(jdir, 1, jstate)
    template = _bf16_state()
    for t in tree_leaves(template.params):
        t.zero_()
    restored, step = ckpt.restore_latest(jdir, template)
    assert step == 1
    for a, b in zip(tree_leaves(restored.params), tree_leaves(state.params)):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    ckpt.save(tdir, 1, restored)
    with open(os.path.join(jdir, "step_00000001", "manifest.json")) as f:
        jman = f.read()
    with open(os.path.join(tdir, "step_00000001", "manifest.json")) as f:
        assert f.read() == jman


# ------------------------------------------------------- fault tolerance

def _final_params(run):
    return [t.clone() for t in tree_leaves(run.state.params)]


def test_fail_at_and_resume_equals_uninterrupted(tmp_path):
    kw = dict(smoke=True, steps=STEPS, batch=64, log_every=1, device="cpu")
    d = str(tmp_path / "ckpt")
    with pytest.raises(SimulatedFailure):
        train_cli.train("deepfm", ckpt_dir=d, ckpt_every=2, fail_at=3, **kw)
    assert ckpt.list_steps(d) == [2]
    resumed = train_cli.train("deepfm", ckpt_dir=d, ckpt_every=2, **kw)
    assert int(resumed.state.step) == STEPS
    assert [h["step"] for h in resumed.history] == [3, 4, 5]
    whole = train_cli.train("deepfm", **kw)
    for a, b in zip(_final_params(resumed), _final_params(whole)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    for h, w in zip(resumed.history, whole.history[2:]):
        assert h["loss"] == w["loss"]


def test_crash_restart_resumes_quadratic(tmp_path):
    """JAX's test_crash_restart_resumes_and_converges, on the port."""
    cfg = opt.OptimizerConfig(kind="sgd", lr=0.05, grad_clip=None)

    def loss_fn(p, batch):
        loss = torch.sum(p["w"] ** 2) + p["b"] ** 2
        return loss, {"loss": loss}

    step_fn = opt.make_step_fn(cfg, loss_fn)

    def data():
        while True:
            yield {}

    def fresh():
        return opt.TrainState.create(cfg, {"w": torch.tensor([2.0, -3.0]),
                                           "b": torch.tensor(1.0)})

    lcfg = LoopConfig(total_steps=20, log_every=100, ckpt_every=5,
                      ckpt_dir=str(tmp_path))
    with pytest.raises(SimulatedFailure):
        fit(fresh(), step_fn, data(), lcfg,
            injector=FailureInjector(fail_at_steps=[12]))
    final, _ = fit(fresh(), step_fn, data(), lcfg)
    ref = fresh()
    for _ in range(20):
        ref, _ = step_fn(ref, {})
    assert int(final.step) == 20
    np.testing.assert_array_equal(final.params["w"].numpy(),
                                  ref.params["w"].numpy())


def test_straggler_detector_flags_slow_host():
    det = StragglerDetector(num_hosts=4, threshold=1.8, patience=5)
    rng = np.random.default_rng(0)
    reports = []
    for _ in range(50):
        for h in range(4):
            dt = 1.0 + 0.01 * rng.standard_normal()
            if h == 2:
                dt *= 3.0                        # host 2 is slow
            det.record(h, dt)
        reports = det.check()
    assert [r.host for r in reports] == [2]
    assert reports[0].ratio > 1.8


def test_straggler_detector_recovers():
    det = StragglerDetector(num_hosts=4, threshold=1.5, patience=2)
    for _ in range(20):
        for h in range(4):
            det.record(h, 5.0 if h == 3 else 1.0)
        det.check()
    assert [r.host for r in det.check()] == [3]
    for _ in range(60):                          # host 3 recovers
        for h in range(4):
            det.record(h, 1.0)
        det.check()
    assert det.check() == []


# ------------------------------------------- adagrad's replayed bound

class _SkipsSmallGradients(opt._OPTIMIZERS["adagrad"]):
    """A planted fault only small-gradient elements feel: adagrad that
    leaves alone every element whose accumulated gradient stays under
    1e-5 (where a 1e-9 gradient gap between two packages moves an
    element by up to 1e-4, so a bar on the param gap alone cannot tell
    it from rounding)."""

    @classmethod
    def update(cls, cfg, lr, step, params, grads, moments):
        for g, a in zip(grads, moments["acc"]):
            g.masked_fill_(torch.sqrt(a + g * g) < 1e-5, 0.0)
        super().update(cfg, lr, step, params, grads, moments)


@pytest.mark.parametrize("faulty", [False, True],
                         ids=["adagrad", "skips-small-gradients"])
@pytest.mark.parametrize("arch", ["autoint", "bst", "two-tower-retrieval"])
def test_adagrad_replay_holds_every_element(arch, faulty, monkeypatch):
    """5 steps of ``arch``'s smoke model through ``recsys_setup`` and
    ``fit`` under ``record_adagrad``: every param within its rounding
    slack of ``adagrad_replay`` over the gradients the updates consumed,
    and with ``_SkipsSmallGradients`` planted, the elements it skips
    (those whose first non-zero gradient is under 1e-5 are there) over
    1,000 slacks outside it, though still within lr x steps."""
    if faulty:
        monkeypatch.setitem(opt._OPTIMIZERS, "adagrad", _SkipsSmallGradients)
    _, cfg = get_arch(arch, smoke=True)
    _, state, step, data = train_cli.recsys_setup(cfg, 64, device="cpu")
    p0 = [t.clone() for t in tree_leaves(state.params)]
    with opt.record_adagrad() as tape:
        final, _ = fit(state, step, data,
                       LoopConfig(total_steps=5, log_every=1))
    assert len(tape) == 5
    replay, _, slack = opt.adagrad_replay(p0, tape)
    gaps = [(t.double() - r).abs() for t, r in zip(tree_leaves(final.params),
                                                   replay)]
    over = max(float((g / s).max()) for g, s in zip(gaps, slack))
    small = 0
    for i in range(len(p0)):
        seen = torch.zeros(p0[i].shape, dtype=torch.bool)
        for _, _, _, grads in tape:
            g = grads[i]
            small += int(((g != 0) & ~seen & (g.abs() < 1e-5)).sum())
            seen |= g != 0
    assert small > 0
    if faulty:
        # far outside the replay's slack, yet within the lr x steps that
        # a bar on the param gap alone would have to allow
        assert over > 1e3
        assert max(float(g.max()) for g in gaps) < 1e-2 * 5
    else:
        assert over <= 1.0


# ------------------------------------------------------------- the CLI

def test_train_cli_on_cpu(capsys):
    run = train_cli.main(["--arch", "deepfm", "--device", "cpu", "--steps",
                          "3", "--batch", "32", "--log-every", "1"])
    assert [h["step"] for h in run.history] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in run.history)
    out = capsys.readouterr().out
    assert "step 3:" in out and "done: 3 steps" in out


@pytest.mark.parametrize("arch", ["gemma3-27b", "stablelm-3b", "mace"])
def test_train_cli_refuses_unported_paths(arch, capsys):
    """The LM archs and the GNN family (``mace``), each refused until its
    slice, train 2 steps on the CPU."""
    if arch == "mace":
        run = train_cli.main(["--arch", arch, "--device", "cpu", "--steps",
                              "2", "--log-every", "1"])
        assert [h["step"] for h in run.history] == [1, 2]
        assert all(np.isfinite(h["loss"]) for h in run.history)
        assert "rmse=" in capsys.readouterr().out
        return
    run = train_cli.main(["--arch", arch, "--device", "cpu", "--steps", "2",
                          "--seq", "16", "--batch", "2", "--log-every", "1"])
    assert [h["step"] for h in run.history] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in run.history)
    assert int(run.state.step) == 2
    out = capsys.readouterr().out
    assert "xent=" in out and "done: 2 steps" in out


def test_train_defaults_to_the_card():
    """No silent move to the CPU: without a card the default raises."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cli.train("deepfm", steps=1, batch=4)
