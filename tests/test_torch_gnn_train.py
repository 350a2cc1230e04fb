"""The port's GNN training path (``launch/train.py``'s gnn branch)
against the JAX package, on the CPU, at the smoke config.

* ``gnn_stream`` yields JAX ``_gnn_setup``'s batches bit for bit, and
  from ``start`` on the batches an uninterrupted stream would;
* 3 adam steps of ``gnn_setup`` + ``fit`` against JAX's ``_gnn_setup``
  step (jitted), from JAX's params and adam state carried across
  (``convert.mace_params_from_numpy``, ``opt_state_from_numpy``): each
  loss and the final params within 1e-5;
* 2 adam steps of ``node_class_loss`` on ``NeighborSampler`` batches
  (``launch/cells.py::sampled_graph``, the loss masked to the seeds)
  against JAX's, losses and ``acc`` within 1e-5, params within 1e-5
  but where adam's first step divides a clipped gradient below 1e-7 by
  its own size plus eps 1e-8 (there a gradient's last-bit rounding
  moves the step by up to lr: measured 3.85e-5 on 3 of layer 0's 240
  ``u2`` elements, whose gradients are 1.4e-8 beside the leaf's largest
  of 5.2e4); those few are held within lr per step;
* ``train --arch mace --device cpu`` failed at step 3 and resumed,
  bit-identical to an uninterrupted run; a stream not positioned at
  the checkpoint gives other params.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jax_get_arch
from repro.data import graph as jax_graph
from repro.launch.train import _gnn_setup as jax_gnn_setup
from repro.models.gnn.mace import MACE as JaxMACE
from repro.train import optimizer as jax_opt
from repro_torch.configs import get_arch
from repro_torch.convert import mace_params_from_numpy, opt_state_from_numpy
from repro_torch.core.schemes.base import tree_leaves
from repro_torch.data import graph
from repro_torch.launch import train as train_cli
from repro_torch.launch.cells import sampled_graph
from repro_torch.models.gnn.mace import MACE
from repro_torch.train import optimizer as opt
from repro_torch.train.loop import LoopConfig, fit
from repro_torch.train.resilience import SimulatedFailure

TOL = 1e-5
BATCH = 32
STEPS = 3
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _jax(g):
    return {k: jnp.asarray(v) for k, v in g.items() if k != "n_graphs"}


def _carried(jstate, model):
    """JAX's train state as the port's: params and adam moments."""
    params = mace_params_from_numpy(jax.tree.map(np.asarray, jstate.params),
                                    model, "cpu")
    moments = opt_state_from_numpy(jax.tree.map(np.asarray,
                                                jstate.opt_state),
                                   params, "cpu")
    return opt.TrainState(params, moments)


@pytest.fixture(scope="module")
def jax_run():
    """JAX's ``_gnn_setup`` at the smoke config: its initial state, the
    first STEPS batches of its stream, and its step (jitted, the batch's
    ``n_graphs`` closed over) run over them: (state, batches, losses,
    final params)."""
    jcfg = jax_get_arch("mace", smoke=True)[1]
    state, step, data = jax_gnn_setup(jcfg, BATCH)
    batches = [next(data) for _ in range(STEPS)]
    batches = [{k: (np.asarray(v) if k != "n_graphs" else v)
                for k, v in b.items()} for b in batches]
    n_graphs = batches[0]["n_graphs"]
    compiled = jax.jit(lambda s, g: step(s, dict(g, n_graphs=n_graphs))
                       ).lower(state, _jax(batches[0])).compile(
        compiler_options=FAST_COMPILE)
    s, losses = state, []
    for b in batches:
        s, m = compiled(s, _jax(b))
        losses.append(float(m["loss"]))
    return state, batches, losses, jax.tree.map(np.asarray, s.params)


def test_gnn_stream_equals_jax_batches(jax_run):
    _, batches, _, _ = jax_run
    cfg = get_arch("mace", smoke=True)[1]
    ours = train_cli.gnn_stream(cfg, BATCH)
    for want in batches:
        got = next(ours)
        assert set(got) == set(want) and got["n_graphs"] == min(BATCH, 32)
        for k, v in want.items():
            np.testing.assert_array_equal(np.asarray(got[k]), v)
    late = next(train_cli.gnn_stream(cfg, BATCH, start=2))
    np.testing.assert_array_equal(late["positions"], batches[2]["positions"])


def test_three_adam_steps_match_jax(jax_run):
    jstate, batches, want_losses, want_params = jax_run
    cfg = get_arch("mace", smoke=True)[1]
    model, _, step, data = train_cli.gnn_setup(cfg, BATCH, device="cpu")
    assert isinstance(model, MACE)
    assert train_cli.GNN_OPTIMIZER.kind == "adam"
    assert train_cli.GNN_OPTIMIZER.lr == 1e-3
    state, hist = fit(_carried(jstate, model), step, data,
                      LoopConfig(total_steps=STEPS, log_every=1))
    _close([h["loss"] for h in hist], want_losses)
    assert int(state.step) == STEPS
    leaves = jax.tree.leaves(want_params)
    got = tree_leaves(state.params)
    assert len(got) == len(leaves)
    for g, w in zip(got, leaves):
        _close(g, w)
    moved = max(float(np.abs(w - np.asarray(a)).max()) for w, a in
                zip(leaves, jax.tree.leaves(jstate.params)))
    assert moved > 1e-4                                # the steps moved them


def test_node_class_steps_on_sampled_batches_match_jax():
    jcfg = jax_get_arch("mace", smoke=True)[1]
    cfg = get_arch("mace", smoke=True)[1]
    g = graph.random_graph(300, 2400, 8, n_classes=cfg.d_readout, seed=0)
    csr = graph.CSRGraph.from_edge_index(g["edge_index"], 300)
    sampler = graph.NeighborSampler(csr, (4, 3), seed=1)
    subs = [sampled_graph(g, sampler.sample(np.arange(16) + 16 * i))
            for i in range(2)]
    assert subs[0]["label_mask"].sum() == 16
    jm = JaxMACE(jcfg)
    key = jax.random.PRNGKey(1)
    ocfg = jax_opt.OptimizerConfig(kind="adam", lr=1e-3)
    jstate = jax.jit(lambda k: jax_opt.TrainState.create(
        ocfg, jm.init(k, n_feat=8))).lower(key).compile(
        compiler_options=FAST_COMPILE)(key)

    def jstep(state, gr):
        (_, m), grads = jax.value_and_grad(jm.node_class_loss, has_aux=True)(
            state.params, gr)
        p, o = jax_opt.apply_updates(ocfg, state.params, grads,
                                     state.opt_state)
        return jax_opt.TrainState(p, o), m

    model = MACE(cfg, device="cpu")
    state = _carried(jstate, model)
    # adam's ill-conditioned elements: a clipped first gradient below 1e-7
    # (exact zeros, the paths layer 0's l = 0 input cannot feed, update
    # by exactly 0 in both)
    grads = jax.tree.leaves(jax.jit(jax.grad(lambda p, g: jm.node_class_loss(
        p, g)[0])).lower(jstate.params, _jax(subs[0])).compile(
        compiler_options=FAST_COMPILE)(jstate.params, _jax(subs[0])))
    norm = max(float(np.sqrt(sum(np.sum(np.square(g)) for g in grads))), 1.0)
    tiny = [(np.asarray(g) != 0) & (np.abs(np.asarray(g)) / norm < 1e-7)
            for g in grads]
    step = opt.make_step_fn(train_cli.GNN_OPTIMIZER, model.node_class_loss)
    for sub in subs:              # a new sample's shape compiles anew
        jstate, jm_metrics = jax.jit(jstep).lower(jstate, _jax(sub)).compile(
            compiler_options=FAST_COMPILE)(jstate, _jax(sub))
        state, metrics = step(state, {k: torch.from_numpy(v)
                                      for k, v in sub.items()})
        for k in ("loss", "acc"):
            _close(metrics[k], jm_metrics[k])
    assert sum(t.sum() for t in tiny) < 0.02 * sum(t.size for t in tiny)
    lr = train_cli.GNN_OPTIMIZER.lr
    for a, b, t in zip(tree_leaves(state.params),
                       jax.tree.leaves(jstate.params), tiny):
        a, b = a.numpy(), np.asarray(b)
        _close(a[~t], b[~t])
        assert np.all(np.abs(a[t] - b[t]) <= lr * len(subs))


def _run(tmp, **kw):
    return train_cli.train("mace", device="cpu", steps=5, log_every=1,
                           ckpt_dir=str(tmp), ckpt_every=2, **kw)


def test_cli_fail_and_resume_bit_identical(tmp_path, monkeypatch, capsys):
    whole = _run(tmp_path / "whole")
    with pytest.raises(SimulatedFailure):
        train_cli.main(["--arch", "mace", "--device", "cpu", "--steps", "5",
                        "--ckpt-dir", str(tmp_path / "cut"), "--ckpt-every",
                        "2", "--fail-at", "3"])
    resumed = _run(tmp_path / "cut")
    assert [h["step"] for h in resumed.history] == [3, 4, 5]
    assert [h["loss"] for h in resumed.history] == \
        [h["loss"] for h in whole.history[2:]]
    for a, b in zip(tree_leaves([whole.state.params, whole.state.opt_state]),
                    tree_leaves([resumed.state.params,
                                 resumed.state.opt_state])):
        assert torch.equal(a, b)
    # a resume whose stream restarts at the first batch trains on others
    with pytest.raises(SimulatedFailure):
        _run(tmp_path / "bad", fail_at=3)
    sound = train_cli.gnn_stream
    monkeypatch.setattr(train_cli, "gnn_stream",
                        lambda cfg, b, start=0: sound(cfg, b, 0))
    bad = _run(tmp_path / "bad")
    assert not all(torch.equal(a, b) for a, b in zip(
        tree_leaves(whole.state.params), tree_leaves(bad.state.params)))
    assert "done: 5 steps" in capsys.readouterr().out
