"""The port's LM serving path against the JAX package, on the CPU.

The building blocks (``rms_norm``, ``apply_rope``, ``glu_ffn``, the
attention paths and the KV-cache helpers) run on numpy inputs handed
to both packages; the models are the smoke configs of stablelm-3b
(uniform layout), gemma3-4b and gemma3-27b (the 5:1 local:global
pattern), mixtral-8x7b (MoE, every layer windowed: the decode cache is
a ring that wraps) and qwen3-moe-30b-a3b (MoE, 8 experts top-2), f32,
and gemma3-27b's with bfloat16 params (as its full config holds them;
activations f32).
The JAX params (``model_init`` from a PRNG key) and the JAX-exported
MGQE token artifact are carried across with ``repro_torch.convert``.
The bars:

* the blocks within 1e-6 (f32 elementwise math and short sums in
  another order);
* ``layer_forward`` with ``attention_impl`` dense and chunked within
  2e-5 (the chunked route is JAX's KV scan with a small
  ``attention_block`` against the port's flash_attention op);
* ``forward``, ``prefill`` (cache leaves and logits) and four
  ``decode_step``s, with ``split_local_global_cache`` both ways, within
  1e-4, and the greedy tokens equal.

Each JAX function is jitted once per config.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jax_get_arch
from repro.core import Embedding as JaxEmbedding
from repro.models import lm as jax_lm
from repro.nn import attention as jax_attn
from repro.nn import mlp as jax_mlp
from repro.nn import norm as jax_norm
from repro.nn import rope as jax_rope
from repro_torch.configs import get_arch
from repro_torch.configs.base import LMConfig
from repro_torch.convert import artifact_from_numpy, lm_params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.nn import attention as attn
from repro_torch.nn import mlp, norm, rope

TOL = 1e-6
LAYER_TOL = 2e-5
MODEL_TOL = 1e-4
ARCHS = ["stablelm-3b", "gemma3-4b", "gemma3-27b", "mixtral-8x7b",
         "qwen3-moe-30b-a3b"]
BATCH, PROMPT, STEPS = 2, 12, 4


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


# ----------------------------------------------------------------------
# building blocks
# ----------------------------------------------------------------------

def test_rms_norm_and_layer_norm_match_jax():
    rng = _rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    scale = (rng.normal(size=(64,)) * 0.1).astype(np.float32)
    bias = (rng.normal(size=(64,)) * 0.1).astype(np.float32)
    got = norm.rms_norm({"scale": torch.from_numpy(scale)},
                        torch.from_numpy(x))
    _close(got, jax_norm.rms_norm({"scale": jnp.asarray(scale)},
                                  jnp.asarray(x)), TOL)
    p = {"scale": 1.0 + scale, "bias": bias}
    got = norm.layer_norm({k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(x))
    _close(got, jax_norm.layer_norm({k: jnp.asarray(v) for k, v in p.items()},
                                    jnp.asarray(x)), TOL)


# the parameter builders of nn/, called as the LM's init calls them
NN_INITS = {
    "rms_norm_init": (lambda dt, **kw: norm.rms_norm_init(64, dt, **kw),
                      lambda dt: jax_norm.rms_norm_init(64, dt)),
    "layer_norm_init": (lambda dt, **kw: norm.layer_norm_init(64, dt, **kw),
                        lambda dt: jax_norm.layer_norm_init(64, dt)),
    "rope_freqs": (lambda dt, **kw: {"freqs": rope.rope_freqs(80, 1e6, **kw)},
                   lambda dt: {"freqs": jax_rope.rope_freqs(
                       80, jnp.float32(1e6))}),
}


@pytest.mark.parametrize("name", sorted(NN_INITS))
def test_nn_inits_default_to_the_card(name):
    """Like the rest of the package, nn/'s builders put their tensors on
    the card unless the caller passes device="cpu"; with no card the
    default raises and names that argument (never a silent CPU)."""
    build = NN_INITS[name][0]
    if torch.cuda.is_available():
        assert all(t.is_cuda for t in build(torch.float32).values())
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build(torch.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(NN_INITS))
def test_nn_inits_on_the_cpu_match_jax(name, dtype):
    """With device="cpu" the builders give JAX's values, dtypes and
    shapes; rope's inverse frequencies are each library's own float32
    pow, so they agree to float32 rounding (TOL), the rest exactly."""
    build, jax_build = NN_INITS[name]
    got = build(getattr(torch, dtype), device="cpu")
    want = jax_build(getattr(jnp, dtype))
    assert sorted(got) == sorted(want)
    for key, t in got.items():
        assert t.device.type == "cpu"
        w = np.asarray(want[key])
        assert tuple(t.shape) == w.shape
        assert str(t.dtype).removeprefix("torch.") == str(w.dtype)
        if name == "rope_freqs":
            _close(t, w, TOL)
        else:
            np.testing.assert_array_equal(t.float().numpy(),
                                          w.astype(np.float32))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
@pytest.mark.parametrize("hd", [16, 80])
def test_apply_rope_matches_jax(hd, theta):
    x = _rng(1).normal(size=(2, 24, 3, hd)).astype(np.float32)
    for pos in (np.arange(24, dtype=np.int32),
                np.full((24,), 23, np.int32)):
        got = rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                              theta)
        _close(got, jax_rope.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                        jnp.float32(theta)), TOL)


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_glu_ffn_matches_jax(act):
    rng = _rng(2)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    p = {"w_gate": rng.normal(size=(64, 96)) * 0.125,
         "w_up": rng.normal(size=(64, 96)) * 0.125,
         "w_down": rng.normal(size=(96, 64)) * 0.1}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    got = mlp.glu_ffn({k: torch.from_numpy(v) for k, v in p.items()},
                      torch.from_numpy(x), act=act)
    _close(got, jax_mlp.glu_ffn({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), act=act), TOL)


def _qkv_inputs(s, skv, seed=3):
    rng = _rng(seed)
    q = rng.normal(size=(2, s, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, skv, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, skv, 2, 16)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("window", [3, jax_attn.FULL_WINDOW])
def test_dense_and_decode_attention_match_jax(window):
    q, k, v = _qkv_inputs(9, 9)
    pos = np.arange(9, dtype=np.int32)
    kpos = pos.copy()
    kpos[7:] = -1                              # unwritten ring slots
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = attn.dense_attention(tq, tk, tv, torch.from_numpy(pos),
                               torch.from_numpy(kpos), window)
    _close(got, jax_attn.dense_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.asarray(kpos), window), TOL)
    kp_b = np.stack([kpos, np.roll(kpos, 2)])  # (B, S), per row
    for kp in (kpos, kp_b):
        got = attn.decode_attention(tq[:, :1], tk, tv, torch.from_numpy(kp),
                                    window)
        _close(got, jax_attn.decode_attention(
            jnp.asarray(q[:, :1]), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(kp), window), TOL)


def test_cache_update_matches_jax():
    _, k, v = _qkv_inputs(1, 6)
    _, k_new, v_new = _qkv_inputs(1, 1, seed=4)
    kp = np.full((2, 6), -1, np.int32)
    for pos in (3, 6, 13):                     # in range, wrapped twice
        want = jax_attn.cache_update(jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(kp), jnp.asarray(k_new),
                                     jnp.asarray(v_new), jnp.int32(pos))
        got = attn.cache_update(torch.from_numpy(k.copy()),
                                torch.from_numpy(v.copy()),
                                torch.from_numpy(kp.copy()),
                                torch.from_numpy(k_new),
                                torch.from_numpy(v_new), pos)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("s,cache_len", [(5, 8), (8, 8), (13, 5), (16, 5)])
def test_cache_from_prefill_matches_jax(s, cache_len):
    _, k, v = _qkv_inputs(1, s)
    pos = np.arange(s, dtype=np.int32)
    want = jax_attn.cache_from_prefill(jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(pos), cache_len)
    got = attn.cache_from_prefill(torch.from_numpy(k), torch.from_numpy(v),
                                  torch.from_numpy(pos), cache_len)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # stacked leading dims (a layer group): each layer as on its own
    ks, vs = np.stack([k, k + 1]), np.stack([v, v - 1])
    got = attn.cache_from_prefill(torch.from_numpy(ks), torch.from_numpy(vs),
                                  torch.from_numpy(pos), cache_len)
    for i in range(2):
        want = jax_attn.cache_from_prefill(jnp.asarray(ks[i]),
                                           jnp.asarray(vs[i]),
                                           jnp.asarray(pos), cache_len)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))


# ----------------------------------------------------------------------
# models: JAX params and artifact carried across
# ----------------------------------------------------------------------

class Pair:
    """One smoke config in both packages, with JAX's params and
    exported token artifact carried across; ``param_dtype`` replaces
    the config's (the token table and centroids are drawn in it)."""

    def __init__(self, arch, param_dtype=None):
        _, self.jcfg = jax_get_arch(arch, smoke=True)
        _, self.cfg = get_arch(arch, smoke=True)
        if param_dtype:
            self.jcfg = dataclasses.replace(self.jcfg,
                                            param_dtype=param_dtype)
            self.cfg = dataclasses.replace(self.cfg, param_dtype=param_dtype)
        self.jparams = jax_lm.model_init(jax.random.PRNGKey(0), self.jcfg)
        self.jart = JaxEmbedding(self.jcfg.embedding).export(
            self.jparams["embed"])
        np_params = jax.tree.map(np.asarray, self.jparams)
        self.params = lm_params_from_numpy(np_params, self.cfg, "cpu")
        ecfg = dataclasses.replace(self.cfg.embedding,
                                   param_dtype=self.cfg.param_dtype)
        self.art = artifact_from_numpy(jax.tree.map(np.asarray, self.jart),
                                       ecfg, "cpu")
        self.tokens = _rng(5).integers(
            0, self.cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)


_PAIRS = {}


def _pair(arch, param_dtype=None):
    """Each config's Pair, built once per test process."""
    if (arch, param_dtype) not in _PAIRS:
        _PAIRS[arch, param_dtype] = Pair(arch, param_dtype)
    return _PAIRS[arch, param_dtype]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _pair(request.param)


def test_config_and_layer_plan_match_jax(pair):
    jfields = {f.name for f in dataclasses.fields(pair.jcfg)}
    assert {f.name for f in dataclasses.fields(LMConfig)} == jfields
    for f in jfields - {"embedding"}:
        assert getattr(pair.cfg, f) == getattr(pair.jcfg, f), f
    assert pair.cfg.param_count() == pair.jcfg.param_count()
    for got, want in zip(lm.layer_windows(pair.cfg, 64),
                         jax_lm.layer_windows(pair.jcfg, 64)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for split in (False, True):
        cfg = dataclasses.replace(pair.cfg, split_local_global_cache=split)
        jcfg = dataclasses.replace(pair.jcfg, split_local_global_cache=split)
        got = lm.make_cache(cfg, BATCH, 20, device="cpu")
        want = jax_lm.make_cache(jcfg, BATCH, 20)
        assert set(got) == set(want)
        for name in set(got) - {"pos"}:
            for g, w in zip(got[name], want[name]):
                assert tuple(g.shape) == w.shape
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("impl", ["dense", "chunked"])
def test_layer_forward_matches_jax(pair, impl):
    cfg = dataclasses.replace(pair.cfg, attention_impl=impl,
                              attention_block=4)
    jcfg = dataclasses.replace(pair.jcfg, attention_impl=impl,
                               attention_block=4)
    name = "layers" if "layers" in pair.params else "glob"
    p = jax.tree.map(lambda a: a[0], pair.jparams[name])
    tp = lm._index(pair.params[name], 0)
    x = _rng(6).normal(size=(BATCH, PROMPT, cfg.d_model)).astype(np.float32)
    pos = np.arange(PROMPT, dtype=np.int32)
    for window in (5, jax_attn.FULL_WINDOW):
        y, aux, (k, v) = lm.layer_forward(tp, torch.from_numpy(x),
                                          torch.from_numpy(pos), window,
                                          1e4, cfg, collect_kv=True)
        jy, jaux, (jk, jv) = jax_lm.layer_forward(
            p, jnp.asarray(x), jnp.asarray(pos), jnp.int32(window),
            jnp.float32(1e4), jcfg, collect_kv=True)
        _close(y, jy, LAYER_TOL)
        _close(k, jk, TOL)
        _close(v, jv, TOL)
        # a dense FFN has no aux loss; an MoE layer's is the router's
        assert abs(float(aux) - float(jaux)) <= TOL
        assert (float(aux) > 0) == cfg.is_moe


def test_params_carry_across_leaf_for_leaf(pair):
    flat = jax.tree_util.tree_flatten_with_path(pair.jparams)[0]
    assert len(flat) > 10
    for path, leaf in flat:
        t = pair.params
        for key in path:
            t = t[key.key] if hasattr(key, "key") else t[key.idx]
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    bad = jax.tree.map(np.asarray, pair.jparams)
    bad["lm_head"] = bad["lm_head"][:, :-1]
    with pytest.raises(ValueError, match="lm_head"):
        lm_params_from_numpy(bad, pair.cfg, "cpu")


def test_forward_matches_jax(pair):
    h, aux, _ = lm.forward(pair.params, torch.from_numpy(pair.tokens),
                           pair.cfg)
    jh, jaux, _ = jax.jit(lambda p, t: jax_lm.forward(p, t, pair.jcfg))(
        pair.jparams, jnp.asarray(pair.tokens))
    _close(h, jh, MODEL_TOL)
    _close(aux, jaux, MODEL_TOL)


@pytest.mark.parametrize("arch,split,param_dtype", [
    ("stablelm-3b", False, None),
    ("gemma3-4b", False, None),
    ("gemma3-4b", True, None),
    ("gemma3-27b", False, None),
    ("gemma3-27b", True, None),
    ("gemma3-27b", False, "bfloat16"),
    ("mixtral-8x7b", False, None),
    ("mixtral-8x7b", True, None),
    ("qwen3-moe-30b-a3b", False, None),
    ("qwen3-moe-30b-a3b", True, None)])
def test_prefill_and_decode_match_jax(arch, split, param_dtype):
    """Both cache layouts of the pattern models (the split cache keeps
    window-sized rings for the local layers); the uniform layout has
    one, so the flag changes nothing there (mixtral's window of 8 makes
    its cache a ring that wraps either way).  gemma3-27b also with its
    full config's bfloat16 params, carried across from JAX's bfloat16
    leaves (activations stay f32, so the bar is the same)."""
    pair = _pair(arch, param_dtype)
    cfg = dataclasses.replace(pair.cfg, split_local_global_cache=split)
    jcfg = dataclasses.replace(pair.jcfg, split_local_global_cache=split)
    max_seq = PROMPT + STEPS
    jprefill = jax.jit(lambda p, t: jax_lm.prefill(
        p, t, jcfg, max_seq=max_seq, embed_artifact=pair.jart))
    jdecode = jax.jit(lambda p, c, t: jax_lm.decode_step(
        p, c, t, jcfg, embed_artifact=pair.jart))
    with torch.no_grad():
        cache, logits = lm.prefill(pair.params, torch.from_numpy(pair.tokens),
                                   cfg, max_seq=max_seq,
                                   embed_artifact=pair.art)
    jcache, jlogits = jprefill(pair.jparams, jnp.asarray(pair.tokens))

    def same_cache(c, jc):
        assert set(c) == set(jc)
        assert c["pos"] == int(jc["pos"])
        for name in set(c) - {"pos"}:
            for g, w in zip(c[name], jc[name]):
                assert tuple(g.shape) == w.shape
                _close(g, w, MODEL_TOL)

    same_cache(cache, jcache)
    _close(logits, jlogits, MODEL_TOL)
    tok = torch.argmax(logits, -1).to(torch.int32)
    jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    for _ in range(STEPS):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        with torch.no_grad():
            cache, logits = lm.decode_step(pair.params, cache, tok, cfg,
                                           embed_artifact=pair.art)
        jcache, jlogits = jdecode(pair.jparams, jcache, jtok)
        _close(logits, jlogits, MODEL_TOL)
        tok = torch.argmax(logits, -1).to(torch.int32)
        jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    same_cache(cache, jcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_lm_cli_on_cpu(arch, capsys):
    run = serve.main(["--arch", arch, "--device", "cpu", "--prompt-len",
                      "16", "--decode-steps", "4", "--batch", "2"])
    assert isinstance(run, serve.LMRun)
    _, cfg = get_arch(arch, smoke=True)
    assert tuple(run.tokens.shape) == (2, 5)
    assert tuple(run.logits.shape) == (2, cfg.vocab_size)
    assert bool(torch.isfinite(run.logits).all())
    assert run.tokens.dtype == torch.int32
    assert torch.equal(run.tokens[:, 0],
                       torch.argmax(run.logits, -1).to(torch.int32))
    assert run.tokens_per_s > 0
    out = capsys.readouterr().out
    assert "embedding artifact" in out and "tok/s" in out


def test_bf16_params_carry_across_and_f32_leaves_are_refused():
    """A bfloat16 config takes JAX's bfloat16 leaves (``ml_dtypes``) bit
    for bit, the token table included, and refuses float32 ones."""
    pair = _pair("gemma3-27b", "bfloat16")
    flat = jax.tree_util.tree_flatten_with_path(pair.jparams)[0]
    for path, leaf in flat:
        t = pair.params
        for key in path:
            t = t[key.key] if hasattr(key, "key") else t[key.idx]
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      np.asarray(leaf).view(np.int16))
    f32 = jax.tree.map(lambda a: np.asarray(a, np.float32), pair.jparams)
    with pytest.raises(ValueError, match="bfloat16"):
        lm_params_from_numpy(f32, pair.cfg, "cpu")
    one = jax.tree.map(np.asarray, pair.jparams)
    one["loc"]["wq"] = one["loc"]["wq"].astype(np.float32)
    with pytest.raises(ValueError, match="loc.wq"):
        lm_params_from_numpy(one, pair.cfg, "cpu")


@pytest.mark.parametrize("arch,why", [("mace", "GNN family")])
def test_unported_archs_are_refused(arch, why):
    """Every arch of the JAX registry is ported now; ``mace`` (the GNN
    family) resolves, and serving it is refused with its reasons, as
    the JAX package's CLI refuses it."""
    assert get_arch(arch)[0] == "gnn"
    with pytest.raises(SystemExit, match="train-only arch"):
        serve.main(["--arch", arch, "--device", "cpu"])
    with pytest.raises(NotImplementedError, match=why):
        serve.main(["--arch", arch, "--engine", "--device", "cpu"])
