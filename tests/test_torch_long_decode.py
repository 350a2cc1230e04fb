"""``long_500k``'s sequence-parallel decode against the JAX package, on
the CPU.

``build_cell``'s ``long_500k`` cell (B = 1, the ``split_cache`` option,
gemma3-4b's smoke config) on gloo ranks (``launch.mesh.spawn``, one
group of 4 for (2, 2) and (4, 1), one of 8 for (2, 4)): the token whole
on every rank, the cache's sequence over the data axes (``kpos`` with
it), the kv heads over ``model`` where they divide (on (2, 4) they do
not: every rank caches both and gathers the query heads).  JAX's
single-device ``decode_step`` runs here from the same prefilled cache
(a prompt past the local window, so the local ring has wrapped) and
its params, artifact, cache and references cross as numpy.  Bars:
three greedy steps' logits within 1e-5 in float32; a planted fault
(rank (0, 0)'s global-layer K block swapped for its neighbour's along
the data axis) must fail.
"""
import dataclasses

import numpy as np
import pytest

from repro_torch.configs import get_arch
from repro_torch.launch.mesh import spawn

# JAX and the JAX package are imported where the references are made:
# the ranks import this module for their body and need neither

TOL = 1e-5
TIMEOUT = 240.0
PROMPT, MAX_SEQ, STEPS = 12, 32, 3
MESHES = [(2, 2), (4, 1), (2, 4)]
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _jax_long():
    """JAX's gemma3-4b smoke config with the split cache on one device: a
    B = 1 prompt prefilled into a cache of MAX_SEQ slots, then STEPS
    greedy decode steps; (params, artifact, cache, every step's fed
    token and logits), numpy."""
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_arch as jax_get_arch
    from repro.core import Embedding as JaxEmbedding
    from repro.launch import cells as jax_cells
    from repro.models import lm as jax_lm
    _, jcfg = jax_get_arch("gemma3-4b", smoke=True)
    jcfg = dataclasses.replace(jcfg, **jax_cells._LM_CFG_OPTS["split_cache"])
    key = jax.random.PRNGKey(0)
    params = jax.jit(lambda k: jax_lm.model_init(k, jcfg)).lower(key).compile(
        compiler_options=FAST_COMPILE)(key)
    art = JaxEmbedding(jcfg.embedding).export(params["embed"])
    serve = jax_cells._strip_embed_table(params)
    toks = jnp.asarray(np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (1, PROMPT)).astype(np.int32))
    cache, logits = jax.jit(lambda p, a, t: jax_lm.prefill(
        p, t, jcfg, max_seq=MAX_SEQ, embed_artifact=a)).lower(
        serve, art, toks).compile(compiler_options=FAST_COMPILE)(
        serve, art, toks)
    cache0 = jax.tree.map(np.asarray, cache)
    decode = jax.jit(lambda p, a, c, t: jax_lm.decode_step(
        p, c, t, jcfg, embed_artifact=a)).lower(
        serve, art, cache, jnp.zeros((1,), jnp.int32)).compile(
        compiler_options=FAST_COMPILE)
    fed, out = [], []
    for _ in range(STEPS):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        cache, logits = decode(serve, art, cache, tok)
        fed.append(np.asarray(tok))
        out.append(np.asarray(logits))
    return (jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, art),
            cache0, fed, out)


def _swap_block(cache, mesh):
    """Rank (0, 0)'s global-layer K block swapped for its neighbour's
    along the sequence's data axis: the block another rank holds."""
    from repro_torch.sharding import collectives as coll
    k = cache["glob"][0]
    theirs = coll.all_gather(k.contiguous(), mesh, "data", dim=-3)
    if mesh.axis_index("data") == 0 and mesh.axis_index("model") == 0:
        n = k.shape[-3]
        k.copy_(theirs.narrow(-3, n, n))


def _body(rank, world, ref):
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.convert import lm_cache_from_numpy, lm_params_from_numpy
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import make_debug_mesh
    params_np, art_np, cache_np, fed, _ = ref
    _, cfg = get_arch("gemma3-4b", smoke=True)
    shape = ShapeSpec("long_500k", "decode", seq_len=MAX_SEQ, global_batch=1)
    out = {}
    for mesh_shape in MESHES:
        if mesh_shape[0] * mesh_shape[1] != world:
            continue
        m = make_debug_mesh(*mesh_shape, device="cpu")
        cell = build_cell("gemma3-4b", shape, m, opts=("split_cache",),
                          cfg=cfg, artifact=art_np,
                          params=lm_params_from_numpy(params_np, cfg, "cpu"))
        params, art, _, _ = cell.args
        for planted in (False, True):
            cache = lm_cache_from_numpy(cache_np, cell.cell.cfg, "cpu",
                                        mesh=m)
            if planted:
                _swap_block(cache, m)
            logits = []
            for tok in fed:
                cache, lg = cell.fn(params, art, cache,
                                    cell.cell.local_tokens(tok))
                logits.append(lg.numpy().copy())
            out[(mesh_shape, planted)] = logits
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's reference, every rank's results by world size)."""
    ref = _jax_long()
    return ref, {world: spawn(_body, world, args=(world, ref),
                              store_dir=tmp_path_factory.mktemp("pg"),
                              timeout_s=TIMEOUT) for world in (4, 8)}


@pytest.mark.parametrize("shape", MESHES)
def test_long_500k_decode_matches_jax_single_device(runs, shape):
    (_, _, _, _, want), ranks = runs
    for r in ranks[shape[0] * shape[1]]:
        got = r[(shape, False)]
        for step, (g, w) in enumerate(zip(got, want, strict=True)):
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL,
                                       err_msg=f"{shape} step {step}")


@pytest.mark.parametrize("shape", MESHES)
def test_long_500k_planted_block_swap_fails(runs, shape):
    (_, _, _, _, want), ranks = runs
    got = ranks[shape[0] * shape[1]][0][(shape, True)]
    gap = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    assert gap > 100 * TOL, gap
