"""The port's mixture-of-experts FFN (``nn/moe.py``) against the JAX
package's, on the CPU.

Params and inputs are drawn with numpy and handed to both packages
(``moe_init`` is compared by statistics only: the generators differ).
The bars:

* ``capacity`` equal;
* the routed expert ids equal (both take the top k with the lower
  index first among ties), the aux loss within 1e-6;
* ``moe_ffn``'s output within 1e-5 (f32 GEMMs summed in another
  order), with capacity factors that keep every choice and that drop
  most of them, and a zero router whose every probability ties.

Then the MoE models' twins of ``tests/test_models_lm.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jax_get_arch
from repro.models import lm as jax_lm
from repro.nn import moe as jax_moe
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import lm
from repro_torch.nn import moe

TOL = 1e-5
AUX_TOL = 1e-6

# (d_model, d_ff, experts, top_k): the two MoE smoke configs' widths
# (mixtral's, qwen3's) and qwen3's published 128 experts top-8
WIDTHS = [(64, 96, 4, 2), (64, 32, 8, 2), (64, 32, 128, 8)]


def _params(d, f, e, seed, zero_router=False):
    rng = np.random.default_rng(seed)
    p = {"router": rng.normal(size=(d, e)) * d ** -0.5,
         "w_gate": rng.normal(size=(e, d, f)) * d ** -0.5,
         "w_up": rng.normal(size=(e, d, f)) * d ** -0.5,
         "w_down": rng.normal(size=(e, f, d)) * f ** -0.5}
    if zero_router:
        p["router"] = np.zeros((d, e))
    return {k: v.astype(np.float32) for k, v in p.items()}


def _x(b, s, d, seed):
    return np.random.default_rng(seed).normal(size=(b, s, d)).astype(
        np.float32)


def _both(p, x, top_k, factor):
    """(port out, port aux, jax out, jax aux) on the same inputs."""
    out, aux = moe.moe_ffn({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), top_k=top_k,
                           capacity_factor=factor)
    jout, jaux = jax_moe.moe_ffn({k: jnp.asarray(v) for k, v in p.items()},
                                 jnp.asarray(x), top_k=top_k,
                                 capacity_factor=factor)
    return out, aux, np.asarray(jout), float(jaux)


def _jax_route(p, x, top_k):
    """JAX's routing steps, as ``_dispatch_combine`` takes them."""
    xt = jnp.asarray(x.reshape(-1, x.shape[-1]))
    probs = jax.nn.softmax(xt @ jnp.asarray(p["router"]), axis=-1)
    return np.asarray(jax.lax.top_k(probs, top_k)[1])


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("factor", [0.01, 1.0, 1.25, 2.0, 64.0])
def test_capacity_matches_jax(factor):
    for t in (1, 2, 7, 64, 4096, 8192):
        for e, k in ((4, 2), (8, 2), (128, 8)):
            assert moe.capacity(t, e, k, factor) == \
                jax_moe.capacity(t, e, k, factor)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_init_shapes_and_statistics(dtype):
    """JAX's shapes and dtypes; each leaf N(0, its scale^2)."""
    d, f, e = 64, 96, 8
    got = moe.moe_init(torch.Generator().manual_seed(0), d, f, e,
                       dtype=getattr(torch, dtype))
    want = jax_moe.moe_init(jax.random.PRNGKey(0), d, f, e,
                            dtype=getattr(jnp, dtype))
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        w = np.asarray(want[name])
        assert tuple(t.shape) == w.shape
        assert str(t.dtype).removeprefix("torch.") == str(w.dtype)
        assert t.device.type == "cpu"
        std = f ** -0.5 if name == "w_down" else d ** -0.5
        tf = t.float()
        assert abs(float(tf.std()) / std - 1) < 0.1, name
        assert abs(float(tf.mean())) < 0.1 * std, name
        assert abs(float(w.astype(np.float32).std()) / std - 1) < 0.1


@pytest.mark.parametrize("factor", [1.25, 0.01])
@pytest.mark.parametrize("d,f,e,k", WIDTHS)
def test_moe_ffn_matches_jax(d, f, e, k, factor):
    p = _params(d, f, e, seed=e)
    x = _x(2, 24, d, seed=e + 1)
    ids = moe.route(torch.from_numpy(x.reshape(-1, d)),
                    torch.from_numpy(p["router"]), k)[1]
    np.testing.assert_array_equal(ids.numpy(), _jax_route(p, x, k))
    out, aux, jout, jaux = _both(p, x, k, factor)
    assert out.shape == jout.shape and out.dtype == torch.float32
    _close(out, jout, TOL)
    assert aux.dtype == torch.float32
    assert abs(float(aux) - jaux) <= AUX_TOL


def test_moe_capacity_drops_tokens_gracefully():
    """With a tiny capacity factor most tokens drop: outputs stay
    finite, dropped tokens contribute zero, and both packages agree."""
    p = _params(16, 32, 4, seed=0)
    x = _x(2, 64, 16, seed=1)
    out_lo, _, jout_lo, _ = _both(p, x, 2, 0.01)
    assert bool(torch.isfinite(out_lo).all())
    _close(out_lo, jout_lo, TOL)
    out_hi, _, jout_hi, _ = _both(p, x, 2, 64.0)
    _close(out_hi, jout_hi, TOL)
    assert float(out_lo.abs().sum()) < float(out_hi.abs().sum())
    # cap = 8 over 256 choices: some tokens lose both choices
    assert int((out_lo.abs().sum(-1) == 0).sum()) > 0


@pytest.mark.parametrize("d,f,e,k", WIDTHS)
def test_zero_router_ties_route_to_the_first_experts(d, f, e, k):
    """Every probability 1/E: JAX's top-k gives experts 0..k-1 for every
    token, and so must the port (torch.topk would not)."""
    p = _params(d, f, e, seed=3, zero_router=True)
    x = _x(2, 8, d, seed=4)
    ids = moe.route(torch.from_numpy(x.reshape(-1, d)),
                    torch.from_numpy(p["router"]), k)[1]
    np.testing.assert_array_equal(_jax_route(p, x, k),
                                  np.tile(np.arange(k), (16, 1)))
    np.testing.assert_array_equal(ids.numpy(), np.tile(np.arange(k), (16, 1)))
    out, aux, jout, jaux = _both(p, x, k, 1.25)
    _close(out, jout, TOL)
    assert abs(float(aux) - jaux) <= AUX_TOL


def test_kept_and_dropped_choices_share_slot_cap_minus_one(monkeypatch):
    """A dropped choice scatters a zero row into slot cap-1, where an
    expert's last kept choice also lands: the dispatch must add.  A
    store in its place (planted) loses the kept row and misses JAX."""
    d, f, e, k = 16, 32, 4, 2
    p = _params(d, f, e, seed=5)
    x = _x(2, 64, d, seed=6)
    cap = moe.capacity(128, e, k, 0.01)
    ids = moe.route(torch.from_numpy(x.reshape(-1, d)),
                    torch.from_numpy(p["router"]), k)[1].reshape(-1)
    # every expert gets more than cap choices: its last kept one and its
    # dropped ones all land in slot cap-1
    counts = np.bincount(ids.numpy(), minlength=e)
    assert cap == 8 and (counts > cap).all(), (cap, counts)
    out, _, jout, _ = _both(p, x, k, 0.01)
    _close(out, jout, TOL)

    monkeypatch.setattr(torch.Tensor, "index_add_", torch.Tensor.index_copy_)
    bad, _ = moe.moe_ffn({n: torch.from_numpy(v) for n, v in p.items()},
                         torch.from_numpy(x), top_k=k, capacity_factor=0.01)
    monkeypatch.undo()
    assert float(np.abs(bad.numpy() - jout).max()) > 100 * TOL


def test_moe_shard_map_is_refused():
    """Without a mesh there are no token groups: ``moe_shard_map`` (the
    grouped dispatch, ``nn/moe.py::moe_ffn_sharded``) asks for
    ``mesh=``, as JAX's asks for an ambient mesh; on a mesh it runs
    (``tests/test_torch_lm_mesh.py``)."""
    _, cfg = get_arch("qwen3-moe-30b-a3b", smoke=True)
    cfg = dataclasses.replace(cfg, moe_shard_map=True)
    params = lm.model_init(torch.Generator().manual_seed(0), cfg)
    tokens = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="pass mesh="):
        lm.forward(params, tokens, cfg)
    with pytest.raises(ValueError, match="pass mesh="):
        moe.moe_ffn_sharded(params["layers"]["moe"], torch.zeros((1, 8, 64)),
                            top_k=2, mesh=None)


# ----------------------------------------------------------------------
# the MoE models: twins of tests/test_models_lm.py
# ----------------------------------------------------------------------

def _model(arch, **changes):
    """The smoke config in both packages, JAX's params carried across."""
    _, jcfg = jax_get_arch(arch, smoke=True)
    _, cfg = get_arch(arch, smoke=True)
    jcfg = dataclasses.replace(jcfg, **changes)
    cfg = dataclasses.replace(cfg, **changes)
    jparams = jax_lm.model_init(jax.random.PRNGKey(0), jcfg)
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                  "cpu")
    return cfg, jcfg, params, jparams


def test_moe_aux_loss_and_balance():
    """The forward's aux (the embedding's loss plus each layer's Switch
    loss) equals JAX's, and is >= 1 up to the batch (1 at balance)."""
    cfg, jcfg, params, jparams = _model("qwen3-moe-30b-a3b")
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (2, 16), 0,
                                           cfg.vocab_size), np.int32)
    with torch.no_grad():
        _, aux, _ = lm.forward(params, torch.from_numpy(tokens), cfg)
    _, jaux, _ = jax_lm.forward(jparams, jnp.asarray(tokens), jcfg)
    assert abs(float(aux) - float(jaux)) <= TOL
    assert float(aux) >= 0.9


def test_lm_sliding_window_restricts_attention():
    """One windowed layer (mixtral's smoke config, capacity wide enough
    that no two tokens compete for a slot): a token past the window
    leaves the last position's hidden state unchanged; both hidden
    states match JAX's."""
    cfg, jcfg, params, jparams = _model("mixtral-8x7b", num_layers=1,
                                        moe_capacity_factor=64.0)
    w = cfg.sliding_window
    t1 = np.zeros((1, w + 4), np.int32)
    t2 = t1.copy()
    t2[0, 0] = 1
    with torch.no_grad():
        h1 = lm.forward(params, torch.from_numpy(t1), cfg)[0]
        h2 = lm.forward(params, torch.from_numpy(t2), cfg)[0]
    _close(h1[:, -1], h2[:, -1], 1e-4)
    assert float((h1[:, 0] - h2[:, 0]).abs().max()) > 1e-3
    for h, t in ((h1, t1), (h2, t2)):
        _close(h, jax_lm.forward(jparams, jnp.asarray(t), jcfg)[0], 1e-4)


def test_kv_repeat_forward_identical():
    """KV-head replication is a layout change: the forward's values do
    not move (the port's attention sums each head's scores in the same
    order either way)."""
    _, cfg = get_arch("mixtral-8x7b", smoke=True)
    params = lm.model_init(torch.Generator().manual_seed(0), cfg)
    cfg2 = dataclasses.replace(cfg, attn_kv_repeat=True)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32))
    with torch.no_grad():
        h1 = lm.forward(params, toks, cfg)[0]
        h2 = lm.forward(params, toks, cfg2)[0]
    np.testing.assert_array_equal(h1.numpy(), h2.numpy())
