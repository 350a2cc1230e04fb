"""The port's LM training path against the JAX package, on the CPU.

The smoke configs of the five LM archs, with JAX's params carried across
by ``repro_torch.convert.lm_params_from_numpy``, on the same
numpy-seeded batches.  The bars:

* ``chunked_xent`` within 1e-5 of JAX's, at chunk = S and chunk < S;
  a ragged S raises in both; the gold logit taken from the wrong row of
  ``w_head.T`` fails the bar;
* ``loss_fn`` and every gradient leaf within 1e-5 of
  ``jax.grad(repro.models.lm.loss_fn)``, with the port under remat off,
  ``layer`` and ``group`` (the pattern layout's groups, and
  ``remat_block`` 2 and 0 on the uniform layout) and attention
  ``dense`` and ``chunked`` (JAX's KV scan at ``attention_block`` 8 over
  S = 20, so its last block is padded).  JAX's remat changes no value
  (``tests/test_models_lm.py::test_group_remat_matches_layer_remat``),
  so its reference is taken once per arch and route;
* the port's group remat against its layer remat, as that JAX test
  holds JAX's;
* ``attend``'s backward (the plain version's vjp, recomputed) equal to
  plain autograd bit for bit, and a group of KV heads at a time within
  float32 rounding of it;
* three adamw steps of ``lm_setup`` against JAX's ``_lm_setup`` from
  the same params: losses and params within 1e-5 (the warmup's lr
  included); gemma3-27b with bfloat16 params within one bfloat16 step
  (at the scale of the param or of the run's updates);
* ``lm_stream`` equal to JAX's batches, ``start`` skipping;
* ``train`` failed at step 3 and resumed, bit-identical to an
  uninterrupted run (float32 and bfloat16 params).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jax_get_arch
from repro.launch.train import _lm_setup as jax_lm_setup
from repro.models import lm as jax_lm
from repro_torch.configs import get_arch
from repro_torch.configs.base import LM_SHAPES
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core.schemes.base import tree_leaves, tree_map
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.flash_attention import attend, flash_attention_ref
from repro_torch.launch import train as train_cli
from repro_torch.models import lm
from repro_torch.train import optimizer as opt
from repro_torch.train.resilience import SimulatedFailure

TOL = 1e-5
ARCHS = ["stablelm-3b", "gemma3-4b", "gemma3-27b", "mixtral-8x7b",
         "qwen3-moe-30b-a3b"]
PATTERN = {"gemma3-4b", "gemma3-27b"}
BATCH, SEQ = 2, 20
# S = 20: xent chunks of 4, and JAX's scan pads its last KV block of 8
TRAIN = {"xent_chunk": 4, "attention_block": 8}


# XLA's CPU backend at optimisation level 0: the references compile in
# about half the time, the same program within float32 rounding
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _compiled(fn, *args, static_argnums=()):
    """``fn`` jitted and compiled for ``args`` under ``FAST_COMPILE``."""
    return jax.jit(fn, static_argnums=static_argnums).lower(*args).compile(
        compiler_options=FAST_COMPILE)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _tokens(vocab, seed=7, b=BATCH, s=SEQ):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1))
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


class Pair:
    """One smoke config in both packages (``TRAIN`` applied), JAX's
    params carried across, and one batch."""

    def __init__(self, arch, param_dtype=None):
        extra = dict(TRAIN, **({"param_dtype": param_dtype}
                               if param_dtype else {}))
        self.jcfg = dataclasses.replace(jax_get_arch(arch, smoke=True)[1],
                                        **extra)
        self.cfg = dataclasses.replace(get_arch(arch, smoke=True)[1],
                                       **extra)
        key = jax.random.PRNGKey(0)
        self.jparams = _compiled(jax_lm.model_init, key, self.jcfg,
                                 static_argnums=1)(key)
        self.np_params = jax.tree.map(np.asarray, self.jparams)
        self.tokens, self.labels = _tokens(self.cfg.vocab_size)
        self._ref = {}

    def params(self):
        """A fresh copy of the params, as the port's tensors."""
        return lm_params_from_numpy(self.np_params, self.cfg, "cpu")

    def batch(self):
        return {"tokens": torch.from_numpy(self.tokens),
                "labels": torch.from_numpy(self.labels)}

    def reference(self, impl):
        """JAX's (loss, metrics, grads) at attention ``impl``."""
        if impl not in self._ref:
            jcfg = dataclasses.replace(self.jcfg, attention_impl=impl)
            args = (self.jparams, {"tokens": jnp.asarray(self.tokens),
                                   "labels": jnp.asarray(self.labels)})
            (loss, metrics), grads = _compiled(jax.value_and_grad(
                lambda p, b: jax_lm.loss_fn(p, b, jcfg), has_aux=True),
                *args)(*args)
            self._ref[impl] = (loss, metrics,
                               jax.tree_util.tree_flatten_with_path(grads)[0])
        return self._ref[impl]


_PAIRS = {}


def _pair(arch, param_dtype=None):
    if (arch, param_dtype) not in _PAIRS:
        _PAIRS[arch, param_dtype] = Pair(arch, param_dtype)
    return _PAIRS[arch, param_dtype]


def _leaf(tree, path):
    for key in path:
        tree = tree[key.key] if hasattr(key, "key") else tree[key.idx]
    return tree


def _port_grads(cfg, params, batch):
    """(loss, metrics, grads as a tree of the params' structure)."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = lm.loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_id = {id(p): g for p, g in zip(leaves, grads)}
    return loss, metrics, tree_map(lambda p: by_id[id(p)], params)


# ----------------------------------------------------------------------
# chunked_xent
# ----------------------------------------------------------------------

def _xent_inputs(seed=11, b=2, s=16, d=24, v=40):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(b, s, d)).astype(np.float32)
    w = (rng.normal(size=(d, v)) * 0.3).astype(np.float32)
    y = rng.integers(0, v, (b, s)).astype(np.int32)
    return h, y, w


@pytest.mark.parametrize("chunk", [16, 4, 64])
def test_chunked_xent_matches_jax(chunk):
    """chunk = S, chunk < S, and a chunk past S (taken as S by both)."""
    h, y, w = _xent_inputs()
    args = (jnp.asarray(h), jnp.asarray(y), jnp.asarray(w))
    want, (jh, jw) = _compiled(jax.value_and_grad(
        lambda a, b, c: jax_lm.chunked_xent(a, b, c, chunk),
        argnums=(0, 2)), *args)(*args)
    th, tw = torch.from_numpy(h).requires_grad_(), \
        torch.from_numpy(w).requires_grad_()
    got = lm.chunked_xent(th, torch.from_numpy(y), tw, chunk)
    _close(got.detach(), want)
    gh, gw = torch.autograd.grad(got, (th, tw))
    _close(gh, jh)
    _close(gw, jw)


def test_chunked_xent_refuses_a_ragged_sequence():
    h, y, w = _xent_inputs(s=12)
    with pytest.raises(ValueError, match="multiple of chunk"):
        jax_lm.chunked_xent(jnp.asarray(h), jnp.asarray(y), jnp.asarray(w), 8)
    with pytest.raises(ValueError, match="multiple of chunk"):
        lm.chunked_xent(torch.from_numpy(h), torch.from_numpy(y),
                        torch.from_numpy(w), 8)


def test_chunked_xent_planted_gold_row_fails():
    """The gold logit taken from the next row of ``w_head.T`` (labels
    only pick the gold row) is far outside the bar."""
    h, y, w = _xent_inputs()
    want = float(jax_lm.chunked_xent(jnp.asarray(h), jnp.asarray(y),
                                     jnp.asarray(w), 4))
    wrong = (torch.from_numpy(y) + 1) % w.shape[1]
    bad = float(lm.chunked_xent(torch.from_numpy(h), wrong,
                                torch.from_numpy(w), 4))
    assert abs(bad - want) > 100 * TOL


# ----------------------------------------------------------------------
# loss_fn and its gradients
# ----------------------------------------------------------------------

def _remats(arch):
    base = [("off", {"remat": False}),
            ("layer", {"remat": True, "remat_granularity": "layer"})]
    if arch in PATTERN:
        return base + [("group", {"remat": True,
                                  "remat_granularity": "group"})]
    return base + [(f"group-{rb}", {"remat": True, "remat_granularity":
                                    "group", "remat_block": rb})
                   for rb in (2, 0)]


CASES = [(arch, impl, name, kw) for arch in ARCHS
         for impl in ("dense", "chunked") for name, kw in _remats(arch)]


@pytest.mark.parametrize("arch,impl,remat,kw", CASES,
                         ids=[f"{a}-{i}-{r}" for a, i, r, _ in CASES])
def test_loss_and_grads_match_jax(arch, impl, remat, kw):
    pair = _pair(arch)
    cfg = dataclasses.replace(pair.cfg, attention_impl=impl, **kw)
    loss, metrics, grads = _port_grads(cfg, pair.params(), pair.batch())
    jloss, jmetrics, jgrads = pair.reference(impl)
    _close(loss.detach(), jloss)
    for key in ("xent", "aux"):
        _close(metrics[key].detach(), jmetrics[key])
    assert len(jgrads) == len(tree_leaves(grads)) > 10
    for path, want in jgrads:
        got = _leaf(grads, path)
        assert got is not None, jax.tree_util.keystr(path)
        _close(got, want)


def test_group_remat_matches_layer_remat():
    """Remat granularity changes memory, never values or gradients (the
    twin of JAX's test, with its bars)."""
    _, cfg = get_arch("stablelm-3b", smoke=True)
    cfg = dataclasses.replace(cfg, num_layers=4)
    cfg_l = dataclasses.replace(cfg, remat=True, remat_granularity="layer")
    cfg_g = dataclasses.replace(cfg, remat=True, remat_granularity="group",
                                remat_block=2)
    assert [len(e) for e, _ in lm._remat_segments(
        cfg_g, lm._layer_plan(cfg_g, 16), False)] == [2, 2]
    params = lm.model_init(torch.Generator(device="cpu").manual_seed(0), cfg)
    tok, lab = _tokens(cfg.vocab_size, s=16)
    batch = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)}
    l1, _, g1 = _port_grads(cfg_l, params, batch)
    l2, _, g2 = _port_grads(cfg_g, params, batch)
    np.testing.assert_allclose(float(l1.detach()), float(l2.detach()),
                               rtol=1e-6)
    for a, b in zip(tree_leaves(g1), tree_leaves(g2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_segments_follow_jax(arch):
    """Where JAX places ``jax.checkpoint``: per layer; per pattern group
    (remainder layers unwrapped); per ``remat_block`` layers; none for
    prefill (``collect_kv``) or with remat off."""
    _, cfg = get_arch(arch, smoke=True)
    plan = lm._layer_plan(cfg, 16)
    on = dataclasses.replace(cfg, remat=True)
    assert lm._remat_segments(cfg, plan, False) == [(plan, False)]
    assert lm._remat_segments(on, plan, True) == [(plan, False)]
    assert lm._remat_segments(on, plan, False) == [([e], True) for e in plan]
    grp = dataclasses.replace(on, remat_granularity="group", remat_block=0)
    sizes = [(len(e), c) for e, c in lm._remat_segments(grp, plan, False)]
    if cfg.is_pattern:
        p = cfg.local_global_pattern + 1
        g, r = divmod(cfg.num_layers, p)
        assert sizes == [(p, True)] * g + ([(r, False)] if r else [])
    else:
        blk = max(1, int(round(cfg.num_layers ** 0.5)))
        while cfg.num_layers % blk:
            blk -= 1
        assert sizes == [(blk, True)] * (cfg.num_layers // blk)


# ----------------------------------------------------------------------
# attend's backward
# ----------------------------------------------------------------------

def _qkv(seed, b=2, s=24, h=4, hkv=2, hd=16):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            for shape in ((b, s, h, hd), (b, s, hkv, hd), (b, s, hkv, hd))]


@pytest.mark.parametrize("window", [5, 1 << 30])
def test_attend_backward_is_plain_autograd_bit_for_bit(window):
    q, k, v = _qkv(3)
    up = torch.from_numpy(np.random.default_rng(4).normal(
        size=q.shape).astype(np.float32))
    a = [t.clone().requires_grad_(True) for t in (q, k, v)]
    b = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = attend(*a, window)
    want = flash_attention_ref(*b, window=window)
    assert torch.equal(out, want)
    got = torch.autograd.grad(out, a, up)
    ref = torch.autograd.grad(want, b, up)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_attend_backward_by_kv_head_groups(monkeypatch):
    """Under a budget of one KV head's scores the recompute runs a head
    at a time: the same function, within float32 rounding."""
    q, k, v = _qkv(5, hkv=4, h=8)
    up = torch.from_numpy(np.random.default_rng(6).normal(
        size=q.shape).astype(np.float32))
    whole = attn_ops.attention_vjp(q, k, v, 7, up)
    per_head = 2 * 2 * 24 * 24 * 4
    assert attn_ops.recompute_groups(2, 24, 24, 8, 4) == 4
    monkeypatch.setattr(attn_ops, "RECOMPUTE_BYTES", per_head)
    assert attn_ops.recompute_groups(2, 24, 24, 8, 4) == 1
    grouped = attn_ops.attention_vjp(q, k, v, 7, up)
    for g, w in zip(grouped, whole):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6)
    # a window that is not the layer's is no longer the same function
    wrong = attn_ops.attention_vjp(q, k, v, 1 << 30, up)
    assert max(float((g - w).abs().max())
               for g, w in zip(wrong, whole)) > 1e-2


# ----------------------------------------------------------------------
# the launcher: lm_stream, lm_setup, train
# ----------------------------------------------------------------------

def test_lm_shapes_match_jax():
    from repro.configs.base import LM_SHAPES as JAX_LM_SHAPES
    assert [dataclasses.asdict(s) for s in LM_SHAPES] == \
        [dataclasses.asdict(s) for s in JAX_LM_SHAPES]
    assert (LM_SHAPES[0].name, LM_SHAPES[0].seq_len) == ("train_4k", 4096)


def test_lm_stream_matches_jax_and_skips(monkeypatch):
    _, jcfg = jax_get_arch("stablelm-3b", smoke=True)
    _, cfg = get_arch("stablelm-3b", smoke=True)
    # the batches do not depend on the params: skip drawing them again
    jparams = _pair("stablelm-3b").jparams
    monkeypatch.setattr(jax_lm, "model_init", lambda key, cfg: jparams)
    _, _, jdata = jax_lm_setup(jcfg, 3, 16)
    want = [next(jdata) for _ in range(4)]
    got = train_cli.lm_stream(cfg, 3, 16)
    for w in want:
        g = next(got)
        for key in ("tokens", "labels"):
            assert g[key].dtype == torch.int32
            np.testing.assert_array_equal(g[key].numpy(), np.asarray(w[key]))
    late = train_cli.lm_stream(cfg, 3, 16, start=2)
    for w in want[2:]:
        np.testing.assert_array_equal(next(late)["tokens"].numpy(),
                                      np.asarray(w["tokens"]))


def _bf16_step_bar(got: torch.Tensor, want, travel: float):
    """``got`` (bfloat16) within one bfloat16 step of ``want``, the step
    taken at the larger of ``|want|`` and ``travel`` (how far the run's
    updates can move a param: adam's steps are at most about lr each).
    A zero-initialised norm scale sits at that size, where the grid is
    finer than the two packages' float32 gradients agree."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), travel))) - 7)
    assert np.all(np.abs(got - want) <= ulp)


@pytest.mark.parametrize("arch,param_dtype", [
    ("stablelm-3b", None), ("gemma3-27b", "bfloat16")])
def test_lm_setup_steps_match_jax(arch, param_dtype, monkeypatch):
    """Three adamw steps of ``lm_setup``'s step from JAX's params on
    ``lm_stream``'s batches, against ``_lm_setup``'s jitted step on its
    own (its state built on the pair's params, not drawn again): the lr
    is 3e-4 * (step + 1) / 20 in the warmup."""
    pair = _pair(arch, param_dtype)
    monkeypatch.setattr(jax_lm, "model_init", lambda key, cfg: pair.jparams)
    jstate, jstep, jdata = jax_lm_setup(pair.jcfg, BATCH, 16)
    jbatches = [next(jdata) for _ in range(3)]
    jstep = _compiled(jstep, jstate, jbatches[0])
    state, step, data = train_cli.lm_setup(pair.cfg, BATCH, 16, device="cpu")
    state = opt.TrainState.create(train_cli.LM_OPTIMIZER, pair.params())
    for s in range(3):
        assert float(opt.schedule_lr(
            train_cli.LM_OPTIMIZER, torch.tensor(s))) == pytest.approx(
                3e-4 * (s + 1) / 20, rel=1e-3)
        jstate, jm = jstep(jstate, jbatches[s])
        state, m = step(state, next(data))
        _close(m["loss"], jm["loss"])
    assert int(state.step) == 3
    for path, want in jax.tree_util.tree_flatten_with_path(
            jstate.params)[0]:
        got = _leaf(state.params, path)
        if param_dtype == "bfloat16":
            assert got.dtype == torch.bfloat16
            _bf16_step_bar(got, want, travel=3e-4 * (1 + 2 + 3) / 20)
        else:
            _close(got, want)


@pytest.mark.parametrize("arch,overrides", [
    ("stablelm-3b", None),
    ("gemma3-27b", {"param_dtype": "bfloat16", "remat": True}),
    ("qwen3-moe-30b-a3b", {"remat": True})])
def test_fail_at_and_resume_equals_uninterrupted(arch, overrides, tmp_path):
    """``train`` failed at step 3 resumes from its step-2 checkpoint
    (bfloat16 leaves included) on the batches an uninterrupted run
    takes, and ends with the same bits (the CPU adds in a fixed
    order)."""
    kw = dict(smoke=True, steps=5, batch=2, seq=16, log_every=1,
              device="cpu", overrides=overrides)
    d = str(tmp_path / "ckpt")
    with pytest.raises(SimulatedFailure):
        train_cli.train(arch, ckpt_dir=d, ckpt_every=2, fail_at=3, **kw)
    resumed = train_cli.train(arch, ckpt_dir=d, ckpt_every=2, **kw)
    whole = train_cli.train(arch, **kw)
    assert [h["step"] for h in resumed.history] == [3, 4, 5]
    assert [h["loss"] for h in resumed.history] == \
        [h["loss"] for h in whole.history[2:]]
    for a, b in zip(tree_leaves(resumed.state.params),
                    tree_leaves(whole.state.params)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    if overrides and "param_dtype" in overrides:
        assert tree_leaves(whole.state.params)[0].dtype == torch.bfloat16


def test_train_refuses_the_gnn_family_by_its_roadmap_item():
    """The gnn family's refusal went with its port (ROADMAP.md §1 item
    7): ``train`` now takes ``mace`` through ``gnn_setup``."""
    run = train_cli.train("mace", device="cpu", steps=1, log_every=1)
    assert int(run.state.step) == 1 and np.isfinite(run.history[0]["loss"])
    assert type(run.model).__name__ == "MACE"
