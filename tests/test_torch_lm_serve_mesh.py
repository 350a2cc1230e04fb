"""The port's LM serving on a mesh against the JAX package, on the CPU.

``sharding/rules.py``'s ``lm_cache_spec``, ``lm_artifact_specs`` and
``strip_embed_table``, the tensor-parallel prefill and decode of
``models/lm.py`` over a placed KV cache (the sequence-split attention
of ``nn/attention.py`` where the kv heads do not divide over
``model``), the served token table's per-rank gather, the
``launch/cells.py`` serving cells and ``serve --mesh``.  The ranks are
gloo processes on the CPU (``launch.mesh.spawn``), one group of 4 for
every case; JAX runs in this process only, on one device, and params,
artifacts, caches and references cross as numpy arrays.  Bars:

* specs: ``lm_cache_spec`` equal to ``tuple(P)`` of JAX's for the five
  LM archs' ``CONFIG``s and smoke configs, at (data, model) = (2, 2),
  (2, 4), (1, 4) and (16, 16), with and without a pod axis, a batch
  that divides the data axes and B = 1, the split cache on and off;
  the artifact specs equal to the ``.spec`` of JAX's
  ``_lm_artifact_sharding`` on a (1, 1) mesh;
* prefill and four greedy decode steps of ``lm_prefill_cell`` and
  ``lm_decode_cell`` on the ranks against JAX's own ``lm_prefill_cell``
  and ``lm_decode_cell`` fns run on one device, from the same params
  and artifact: logits within 1e-5, each rank's cache block within 1e-5
  of the block of JAX's cache that the spec names (after the prefill
  and after the steps), greedy tokens identical.  The five smoke
  configs on (2, 2) (kv heads over ``model``); gemma3-4b on (1, 4),
  where its 2 kv heads do not divide 4 (the cache's sequence over
  ``model``, ``wk``/``wv`` split inside a head and gathered), with the
  split cache too and a prompt longer than its window of 8 (the local
  ring wraps); qwen3 with ``moe_shard_map`` (JAX's ``moe_ffn_sharded``
  swapped for its single-device twin on the (2, 2) groups,
  ``test_torch_moe_mesh.py::jax_grouped_moe``);
* the per-rank form of the quantized gather bit-identical to JAX's
  single-device decode; ``serve --mesh`` printing the tokens the
  single-device CLI prints;
* refusals: a batch that does not divide the data axes (ROADMAP §1
  item 9), a cache block of the wrong shape, ``attn_kv_repeat``.
"""
import contextlib
import dataclasses
import functools
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.base import ShapeSpec as JaxShapeSpec
from repro.configs.registry import get_arch as jax_get_arch
from repro.core import Embedding as JaxEmbedding
from repro.launch import cells as jax_cells
from repro.models import lm as jax_lm
from repro.nn import attention as jax_attn
from repro.nn import moe as jax_moe
from repro.sharding import rules as jax_rules
from repro_torch.configs import get_arch
from repro_torch.core import Embedding
from repro_torch.launch.mesh import spawn
from repro_torch.models import lm
from repro_torch.nn import attention as attn
from repro_torch.sharding import rules
from test_torch_moe_mesh import jax_grouped_moe

TOL = 1e-5
TIMEOUT = 180.0
B, PROMPT, STEPS = 4, 12, 4
MAX_SEQ = 20                        # PROMPT + STEPS, rounded up to 4 slots
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
ARCHS = ["stablelm-3b", "gemma3-4b", "gemma3-27b", "mixtral-8x7b",
         "qwen3-moe-30b-a3b"]
# case -> (arch, config changes, mesh): every arch on (2, 2); the
# sequence over model on (1, 4); the split cache with a prompt past the
# window; the grouped MoE dispatch in the prefill
CASES = {
    "stablelm": ("stablelm-3b", {}, (2, 2)),
    "gemma3-4b": ("gemma3-4b", {}, (2, 2)),
    "gemma3-27b": ("gemma3-27b", {}, (2, 2)),
    "mixtral": ("mixtral-8x7b", {}, (2, 2)),
    "qwen3": ("qwen3-moe-30b-a3b", {}, (2, 2)),
    "gemma3-4b-split": ("gemma3-4b", {"split_local_global_cache": True},
                        (2, 2)),
    "gemma3-4b-seq": ("gemma3-4b", {}, (1, 4)),
    "gemma3-4b-seq-split": ("gemma3-4b", {"split_local_global_cache": True},
                            (1, 4)),
    "qwen3-shard-map": ("qwen3-moe-30b-a3b", {"moe_shard_map": True},
                        (2, 2)),
}
CLI = ["--arch", "gemma3-4b", "--device", "cpu", "--prompt-len", "16",
       "--decode-steps", "4", "--batch", "2"]


class _FakeMesh:
    """What the rules read of a mesh: axis sizes, names, this rank's
    coordinates."""

    def __init__(self, shape: dict, coords=None):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.device = torch.device("cpu")
        self._coords = dict(zip(self.axis_names, coords or
                                (0,) * len(shape)))

    def axis_index(self, axis):
        return self._coords[axis]


def _mesh(data, model, multi_pod=False, coords=None):
    shape = {"pod": 2} if multi_pod else {}
    shape.update({"data": data, "model": model})
    return _FakeMesh(shape, coords)


def _tup(tree):
    """JAX's spec tree as the port's: a ``P`` as its tuple, a cache
    stack's tuple of specs as a list."""
    if isinstance(tree, dict):
        return {k: _tup(v) for k, v in tree.items()}
    if isinstance(tree, P):
        return tuple(tree)
    return [_tup(v) for v in tree]


# ----------------------------------------------------------------------
# specs, no ranks
# ----------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("mesh", [(2, 2), (2, 4), (1, 4), (16, 16)])
@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_cache_spec_equals_jax(arch, size, mesh, multi_pod):
    """All three branches: batch over the data axes with the kv heads
    over model, or with the sequence over model where they do not
    divide (gemma3-4b's and qwen3's 4 kv heads on model = 16, mixtral's
    8); a batch of 1 over more than one data shard puts the sequence
    over the data axes."""
    smoke = size == "smoke"
    m = _mesh(*mesh, multi_pod)
    dp_n = mesh[0] * (2 if multi_pod else 1)
    seq = 64 if smoke else 4096
    for split in (False, True):
        _, jcfg = jax_get_arch(arch, smoke=smoke)
        jcfg = dataclasses.replace(jcfg, split_local_global_cache=split)
        _, cfg = get_arch(arch, smoke=smoke)
        cfg = dataclasses.replace(cfg, split_local_global_cache=split)
        for b in (2 * dp_n, 1):
            template = jax.eval_shape(lambda: jax_lm.make_cache(jcfg, b,
                                                                 seq))
            want = jax_rules.lm_cache_spec(jcfg, b, m, multi_pod, template)
            got = rules.lm_cache_spec(cfg, b, m, multi_pod, lm.make_cache(
                cfg, b, seq, device="meta"))
            assert got == _tup(want), (split, b)


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch,kind", [(a, "mgqe") for a in ARCHS] + [
    ("gemma3-4b", k) for k in ("mgqe-private_k", "dpq", "full")])
def test_lm_artifact_specs_equal_jax(arch, kind, size):
    """The served token table's specs, leaf for leaf, equal to the specs
    of JAX's ``_lm_artifact_sharding`` on a (1, 1) mesh (a prefix spec
    over a list of tiers' centroids given to each), for every LM arch's
    MGQE table and other kinds of gemma3-4b's."""
    _, jcfg = jax_get_arch(arch, smoke=size == "smoke")
    _, cfg = get_arch(arch, smoke=size == "smoke")
    kind, _, variant = kind.partition("-")

    def table(ecfg):
        ecfg = dataclasses.replace(ecfg, kind=kind)
        return dataclasses.replace(ecfg, mgqe_variant=variant) if variant \
            else ecfg

    jart = JaxEmbedding(table(jcfg.embedding)).serving_artifact_struct()
    jmesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(
        jax.sharding.AxisType.Auto,) * 2)
    want = jax_cells._lm_artifact_sharding(jmesh, jart)
    art = Embedding(table(cfg.embedding),
                    device="cpu").serving_artifact_struct()
    got = rules.lm_artifact_specs(art)
    assert set(got) == set(want)
    for k, spec in got.items():
        leaves = spec if isinstance(spec, list) else [spec]
        for leaf_spec in leaves:
            assert leaf_spec == tuple(want[k].spec), k


@pytest.mark.parametrize("arch", ARCHS)
def test_strip_embed_table_equals_jax(arch):
    _, jcfg = jax_get_arch(arch, smoke=True)
    jparams = jax.eval_shape(lambda k: jax_lm.model_init(k, jcfg),
                             jax.random.PRNGKey(0))
    want = jax_cells._strip_embed_table(jparams)
    got = rules.strip_embed_table(jparams)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert "emb" not in got["embed"] and "emb" in jparams["embed"]


@pytest.mark.parametrize("s,cache_len,n", [(12, 20, 4), (12, 8, 4),
                                           (20, 20, 2), (13, 8, 2)])
def test_cache_from_prefill_block_is_jax_cache_block(s, cache_len, n):
    """``cache_from_prefill(seq_block=(i, n))``: rank i's slots of JAX's
    ring cache, kpos whole; a ring that wraps included."""
    rng = np.random.default_rng(s + cache_len)
    k = rng.normal(size=(2, s, 3, 4)).astype(np.float32)
    v = rng.normal(size=(2, s, 3, 4)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)
    jk, jv, jp = (np.asarray(a) for a in jax_attn.cache_from_prefill(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos), cache_len))
    size = cache_len // n
    for i in range(n):
        gk, gv, gp = attn.cache_from_prefill(
            torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(pos),
            cache_len, seq_block=(i, n))
        np.testing.assert_array_equal(gk.numpy(),
                                      jk[:, i * size:(i + 1) * size])
        np.testing.assert_array_equal(gv.numpy(),
                                      jv[:, i * size:(i + 1) * size])
        np.testing.assert_array_equal(gp.numpy(), jp)


# ----------------------------------------------------------------------
# refusals
# ----------------------------------------------------------------------

def test_a_batch_that_does_not_divide_the_data_axes_is_refused():
    """B = 1 over two data shards: a prefill's prompts are refused (the
    JAX cell's sequence-parallel tokens, which the port's prefill has
    not), named; a decode batch is served as the JAX cell serves
    ``long_500k``: the token whole on every rank and the cache's
    sequence over the data axes."""
    from repro_torch.launch.cells import LMDecodeCell, LMPrefillCell
    _, cfg = get_arch("gemma3-4b", smoke=True)
    m = _mesh(2, 2)
    cache = lm.make_cache(cfg, 1, 16, mesh=m)
    whole = lm.make_cache(cfg, 1, 16, device="cpu")
    for name, leaves in whole.items():
        if name != "pos":
            for i, (got, want) in enumerate(zip(cache[name], leaves)):
                seq = -3 if i < 2 else -1         # k, v; kpos
                assert got.shape[seq] * 2 == want.shape[seq]
    with pytest.raises(ValueError, match=r"1 prompts or training rows does "
                                         r"not divide over 2 data shard"):
        LMPrefillCell(cfg, m, None, 1, 16, 16).local_tokens(
            np.zeros((1, 16), np.int32))
    token = LMDecodeCell(cfg, m, None, 1, 16).local_tokens(
        np.zeros((1,), np.int32))
    assert tuple(token.shape) == (1,)


def test_a_cache_block_of_the_wrong_shape_is_refused():
    """A whole cache, a cache of another batch or a block of another
    rank layout is not this rank's block: named, with the shape the
    spec gives."""
    _, cfg = get_arch("gemma3-4b", smoke=True)
    m = _mesh(2, 2)
    block = lm.make_cache(cfg, 4, 16, mesh=m)
    lm.check_cache(block, cfg, m, 4)
    whole = lm.make_cache(cfg, 4, 16, device="cpu")
    with pytest.raises(ValueError, match=r"cache loc/0: \(1, 5, 4, 16, 2, "
                                         r"16\) is not this rank's block "
                                         r"\(1, 5, 2, 16, 1, 16\)"):
        lm.check_cache(whole, cfg, m, 4)
    with pytest.raises(ValueError, match="is not this rank's block"):
        lm.check_cache(block, cfg, m, 8)
    seq = lm.make_cache(cfg, 4, 16, mesh=_mesh(1, 4))
    with pytest.raises(ValueError, match="is not this rank's block"):
        lm.check_cache(seq, cfg, _mesh(1, 4), 8)
    with pytest.raises(ValueError, match="does not divide over"):
        lm.make_cache(cfg, 4, 18, mesh=_mesh(1, 4))


def test_attn_kv_repeat_is_refused_on_a_mesh():
    _, cfg = get_arch("gemma3-4b", smoke=True)
    cfg = dataclasses.replace(cfg, attn_kv_repeat=True)
    with pytest.raises(ValueError, match="attn_kv_repeat"):
        lm.prefill({}, torch.zeros((1, 4), dtype=torch.int32), cfg,
                   mesh=_mesh(1, 2))


# ----------------------------------------------------------------------
# prefill and decode on gloo ranks against JAX on one device
# ----------------------------------------------------------------------

def _tokens(vocab):
    return np.random.default_rng(7).integers(
        0, vocab, (B, PROMPT)).astype(np.int32)


def _jcfg(arch, changes):
    _, jcfg = jax_get_arch(arch, smoke=True)
    return dataclasses.replace(jcfg, **changes)


@functools.lru_cache(maxsize=None)
def _jax_init(arch):
    """JAX's params and exported token artifact of a smoke config."""
    jcfg = _jcfg(arch, {})
    jparams = jax_lm.model_init(jax.random.PRNGKey(0), jcfg)
    jart = JaxEmbedding(jcfg.embedding).export(jparams["embed"])
    return jparams, jart


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_case(arch, changes):
    """JAX's run of a case on one device: its cells' fns (the prefill
    cell's cache sized MAX_SEQ), the prefill's cache and logits, every
    decode step's logits and tokens, the last cache; all numpy."""
    jcfg = _jcfg(arch, changes)
    jparams, jart = _jax_init(arch)
    serve = jax_cells._strip_embed_table(jparams)
    jmesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(
        jax.sharding.AxisType.Auto,) * 2)
    shape = JaxShapeSpec("t", "prefill", seq_len=MAX_SEQ, global_batch=B)
    pre = jax_cells.lm_prefill_cell(arch, jcfg, shape, jmesh, False)
    dec = jax_cells.lm_decode_cell(arch, jcfg, dataclasses.replace(
        shape, kind="decode"), jmesh, False)
    toks = jnp.asarray(_tokens(jcfg.vocab_size))
    sharded = jax_moe.moe_ffn_sharded
    jax_moe.moe_ffn_sharded = jax_grouped_moe(2, 2)
    try:
        prefill = jax.jit(pre.fn).lower(serve, jart, toks).compile(
            compiler_options=FAST_COMPILE)
    finally:
        jax_moe.moe_ffn_sharded = sharded
    cache, logits = prefill(serve, jart, toks)
    out = {"cache0": _np(cache), "logits": [np.asarray(logits)]}
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    decode = jax.jit(dec.fn).lower(serve, jart, cache, tok).compile(
        compiler_options=FAST_COMPILE)
    toks_out = [np.asarray(tok)]
    for _ in range(STEPS):
        cache, logits = decode(serve, jart, cache, tok)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        out["logits"].append(np.asarray(logits))
        toks_out.append(np.asarray(tok))
    out["tokens"] = np.stack(toks_out, 1)
    out["cache"] = _np(cache)
    return out


def _cache_np(cache):
    return {k: v if k == "pos" else [t.numpy().copy() for t in v]
            for k, v in cache.items()}


def _serve_body(rank, cases, ids, jart):
    """Every case on this rank (its mesh over the 4 ranks), the per-rank
    gather of ``ids`` (this data shard's rows), then ``serve --mesh``."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.launch import serve
    from repro_torch.launch.cells import lm_decode_cell, lm_prefill_cell
    from repro_torch.launch.mesh import make_debug_mesh
    meshes = {shape: make_debug_mesh(*shape, device="cpu")
              for shape in ((2, 2), (1, 4))}
    out = {}
    for name, (arch, changes, shape, params, art) in cases.items():
        _, cfg = get_arch(arch, smoke=True)
        cfg = dataclasses.replace(cfg, **changes)
        m = meshes[shape]
        spec = ShapeSpec("t", "prefill", seq_len=PROMPT, global_batch=B)
        pre = lm_prefill_cell(cfg, spec, m, max_seq=MAX_SEQ,
                              params=lm_params_from_numpy(params, cfg, "cpu"),
                              artifact=art)
        dec = lm_decode_cell(cfg, dataclasses.replace(
            spec, kind="decode", seq_len=MAX_SEQ), m, served=pre.served)
        cache, logits = pre.step(pre.local_tokens(_tokens(cfg.vocab_size)))
        res = {"coords": (m.axis_index("data"), m.axis_index("model")),
               "cache0": _cache_np(cache), "logits": [logits.numpy()]}
        tok = torch.argmax(logits, -1).to(torch.int32)
        toks = [tok]
        for _ in range(STEPS):
            cache, logits = dec.step(cache, tok)
            tok = torch.argmax(logits, -1).to(torch.int32)
            res["logits"].append(logits.numpy())
            toks.append(tok)
        res["tokens"] = torch.stack(toks, 1).numpy()
        res["cache"] = _cache_np(cache)
        out[name] = res
    # planted: the sequence merge without its pmax (each rank's block
    # shifted by its own max), on the sequence-split case
    from repro_torch.sharding import collectives as coll
    arch, changes, shape, params, art = cases["gemma3-4b-seq"]
    _, cfg = get_arch(arch, smoke=True)
    pmax = coll.pmax
    coll.pmax = lambda x, mesh, axes: x.detach().clone()
    try:
        pre = lm_prefill_cell(
            cfg, ShapeSpec("t", "prefill", seq_len=PROMPT, global_batch=B),
            meshes[shape], max_seq=MAX_SEQ,
            params=lm_params_from_numpy(params, cfg, "cpu"), artifact=art)
        cache, logits = pre.step(pre.local_tokens(_tokens(cfg.vocab_size)))
        dec = lm_decode_cell(cfg, ShapeSpec(
            "t", "decode", seq_len=MAX_SEQ, global_batch=B), meshes[shape],
            served=pre.served)
        _, logits = dec.step(cache, torch.argmax(logits, -1).to(torch.int32))
        out["planted"] = logits.numpy()
    finally:
        coll.pmax = pmax
    # the served table's per-rank gather: this data shard's ids, over
    # JAX's artifact placed by lm_artifact_specs
    from repro_torch.convert import lm_artifact_from_numpy
    _, cfg = get_arch("gemma3-4b", smoke=True)
    m = meshes[(2, 2)]
    emb = Embedding(cfg.embedding, device="cpu")
    art = lm_artifact_from_numpy(jart, cfg, "cpu", mesh=m)
    mine = torch.from_numpy(ids[m.axis_index("data")])
    out["rows"] = emb.serve(art, mine, mesh=m, per_rank=True).numpy()
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        run = serve.main(CLI + ["--mesh", "data=2,model=2",
                                "--dist-backend", "gloo"])
    out["cli"] = (text.getvalue(), run.tokens.numpy())
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(JAX's run of every case, every rank's, the ids of the gather)."""
    from repro_torch.convert import lm_artifact_from_numpy
    refs, cases, by_jax = {}, {}, {}
    for name, (arch, changes, shape) in CASES.items():
        key = (arch, tuple(sorted(changes.items())))
        if key not in by_jax:
            by_jax[key] = _jax_case(arch, changes)
        refs[name] = by_jax[key]
        jparams, jart = _jax_init(arch)
        _, cfg = get_arch(arch, smoke=True)
        cases[name] = (arch, changes, shape, _np(jparams),
                       lm_artifact_from_numpy(_np(jart), cfg, "cpu"))
    ids = np.random.default_rng(3).integers(0, 512, (2, 3, 5))
    ranks = spawn(_serve_body, 4, args=(cases, ids,
                                        _np(_jax_init("gemma3-4b")[1])),
                  store_dir=str(tmp_path_factory.mktemp("lm_serve")),
                  timeout_s=TIMEOUT)
    return refs, ranks, ids


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_and_decode_match_jax_single_device(served, case):
    """Every rank's logits (its data shard's rows) within 1e-5 of JAX's
    prefill and four decode steps; its greedy tokens equal to JAX's."""
    refs, ranks, _ = served
    ref = refs[case]
    shape = CASES[case][2]
    bl = B // shape[0]
    for r in ranks:
        out = r[case]
        d = out["coords"][0]
        for got, want in zip(out["logits"], ref["logits"], strict=True):
            np.testing.assert_allclose(got, want[d * bl:(d + 1) * bl],
                                       rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(out["tokens"],
                                      ref["tokens"][d * bl:(d + 1) * bl])


@pytest.mark.parametrize("case", sorted(CASES))
def test_cache_blocks_are_jax_cache_blocks(served, case):
    """Every rank's cache, after the prefill and after the decode steps,
    within 1e-5 of the block of JAX's cache that ``lm_cache_spec``
    names for that rank (``convert.lm_cache_from_numpy``; kpos exactly);
    the sequence-split cases hold a block of the slots of every kv
    head."""
    from repro_torch.convert import lm_cache_from_numpy
    refs, ranks, _ = served
    arch, changes, shape = CASES[case]
    _, cfg = get_arch(arch, smoke=True)
    cfg = dataclasses.replace(cfg, **changes)
    for when in ("cache0", "cache"):
        want_cache = refs[case][when]
        specs = rules.lm_cache_spec(cfg, B, _mesh(*shape), False,
                                    lm_cache_from_numpy(want_cache, cfg,
                                                        "meta"))
        split = any(sp[-3] == "model" for stack in specs.values()
                    if isinstance(stack, list) for sp in stack[:2])
        assert split == (case.startswith("gemma3-4b-seq")), specs
        for r in ranks:
            got = r[case][when]
            want = lm_cache_from_numpy(want_cache, cfg, "cpu",
                                       mesh=_mesh(*shape,
                                                  coords=r[case]["coords"]))
            assert got["pos"] == want["pos"]
            assert set(got) == set(want)
            for name in set(want) - {"pos"}:
                for i, (g, w) in enumerate(zip(got[name], want[name],
                                               strict=True)):
                    assert g.shape == tuple(w.shape)
                    if i == 2:
                        np.testing.assert_array_equal(g, w.numpy())
                    else:
                        np.testing.assert_allclose(g, w.numpy(), rtol=TOL,
                                                   atol=TOL)


def test_planted_merge_without_its_max_fails(served):
    """The sequence merge with each rank's own max in place of the pmax
    moves the first decode step's logits far past the bar (the prefill,
    which attends over the whole sequence on every rank, does not
    merge)."""
    refs, ranks, _ = served
    want = refs["gemma3-4b-seq"]["logits"][1]
    for r in ranks:
        assert np.abs(r["planted"] - want).max() > 100 * TOL


def test_per_rank_gather_is_jax_decode_bit_for_bit(served):
    """The served table's rows on each rank of (2, 2), for that data
    shard's own ids, equal to JAX's single-device serve."""
    _, ranks, ids = served
    _, jart = _jax_init("gemma3-4b")
    _, jcfg = jax_get_arch("gemma3-4b", smoke=True)
    jemb = JaxEmbedding(jcfg.embedding)
    for r in ranks:
        d = r["gemma3-4b"]["coords"][0]
        want = np.asarray(jemb.serve(jart, jnp.asarray(ids[d])))
        np.testing.assert_array_equal(r["rows"], want)


def test_serve_cli_on_a_mesh_prints_the_single_device_tokens(served,
                                                              capsys):
    """``serve --mesh data=2,model=2`` on 4 CPU ranks: rank 0 prints the
    sample the single-device CLI prints, every rank's run holds the same
    tokens, and rank 0 prints each rank's bytes and a decode step's
    collectives (7 layers: 2 psums a layer, the gather's 2, the logits'
    gather); the other ranks print nothing."""
    from repro_torch.launch import serve
    _, ranks, _ = served
    one = serve.main(CLI)
    want = re.search(r"sample: (\[.*\])", capsys.readouterr().out).group(1)
    for i, r in enumerate(ranks):
        text, tokens = r["cli"]
        np.testing.assert_array_equal(tokens, one.tokens.numpy())
        if i:
            assert text == ""
            continue
        assert re.search(r"sample: (\[.*\])", text).group(1) == want
        assert "prefill:" in text and "tok/s" in text
        assert len(re.findall(r"rank \d: params", text)) == 4
        assert "a decode step's collectives (rank 0): 17," in text


def test_serve_cli_mesh_refusals(capsys):
    from repro_torch.launch import serve
    for argv, match in (
            (["--mesh", "data=2"], "no 'model' axis to shard the token "
                                   "codes and the heads"),
            (["--mesh", "data=2,model=2"], "needs 4 ranks, found 1")):
        with pytest.raises(SystemExit):
            serve.main(CLI + argv + ["--dist-backend", "gloo"])
        assert match in capsys.readouterr().err
