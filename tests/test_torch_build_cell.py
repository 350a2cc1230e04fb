"""``build_cell``'s named options and heads cut by the placement
against the JAX package, on the CPU (``long_500k``'s decode:
``test_torch_long_decode.py``).

The ranks are gloo processes (``launch.mesh.spawn``): one group of 4
and one of 8 run every case of their size; JAX runs here on one device
and its params and references cross as numpy.  Bars (ROADMAP.md's
parity bars):

* one training step of ``build_cell``'s LM cell with JAX's named
  options against JAX's ``lm_train_cell`` fn with the same options, on
  a smoke config: ``remat_group``, ``xent_chunk_256`` and
  ``attn_block_2048`` together on gemma3-4b (remat on), ``microbatch2``
  and ``embed_full`` together on stablelm-3b, on (2, 2); stablelm-3b on
  (1, 8), where ``wq``'s and ``wk``'s columns split inside a head (4
  heads over 8 ranks).  The loss within 1e-5, every param after the
  adamw step within 1e-5 + 1e-5|p| (elements of |g| < 1e-6 at 2·lr).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.launch.mesh import spawn

# JAX and the JAX package are imported where the references are made:
# the ranks import this module for their body and need neither

TOL = 1e-5
LR = 3e-4
TIMEOUT = 240.0
B, SEQ = 4, 16
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
# name -> (arch, opts, config changes on both sides, mesh)
TRAIN = {
    "group-xent-block": ("gemma3-4b", ("remat_group", "xent_chunk_256",
                                       "attn_block_2048"),
                         {"remat": True}, (2, 2)),
    "microbatch-full": ("stablelm-3b", ("microbatch2", "embed_full"), {},
                        (2, 2)),
    "cut-heads": ("stablelm-3b", (), {}, (1, 8)),
}


def _jax_cfg(arch, opts, changes):
    """JAX's smoke config with the options applied as its ``build_cell``
    applies them, and the microbatches."""
    from repro.configs.registry import get_arch as jax_get_arch
    from repro.core.types import EmbeddingConfig as JaxEmbeddingConfig
    from repro.launch import cells as jax_cells
    _, cfg = jax_get_arch(arch, smoke=True)
    cfg = dataclasses.replace(cfg, **changes)
    mb = 1
    for o in opts:
        if o.startswith("microbatch"):
            mb = int(o[len("microbatch"):])
        elif o == "embed_full":
            cfg = dataclasses.replace(cfg, embedding=JaxEmbeddingConfig(
                vocab_size=cfg.vocab_size, dim=cfg.d_model))
        else:
            cfg = dataclasses.replace(cfg, **jax_cells._LM_CFG_OPTS[o])
    return cfg, mb


def _batch(vocab):
    toks = np.random.default_rng(3).integers(0, vocab, (B, SEQ + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def _paths(tree) -> dict:
    import jax
    return {"/".join(str(k.key) if hasattr(k, "key") else str(k.idx)
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _fast(fn, *args):
    import jax
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE)(
        *args)


def _jax_train(arch, opts, changes):
    """(params numpy, loss, params after the step, the step's gradient
    read back from adam's first moment m = (1 - b1)·g)."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import ShapeSpec as JaxShapeSpec
    from repro.launch import cells as jax_cells
    from repro.models import lm as jax_lm
    from repro.train import optimizer as jax_opt
    jcfg, mb = _jax_cfg(arch, opts, changes)
    params = _fast(lambda k: jax_lm.model_init(k, jcfg),
                   jax.random.PRNGKey(0))
    ocfg = jax_opt.OptimizerConfig(kind="adamw", lr=LR, grad_clip=1.0)
    state = jax_opt.TrainState.create(ocfg, params)
    jmesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(
        jax.sharding.AxisType.Auto,) * 2)
    cell = jax_cells.lm_train_cell(
        arch, jcfg, JaxShapeSpec("t", "train", seq_len=SEQ, global_batch=B),
        jmesh, False, microbatches=mb)
    batch = {k: jnp.asarray(v) for k, v in _batch(jcfg.vocab_size).items()}
    new, metrics = _fast(cell.fn, state, batch)
    b1 = jax_opt.OptimizerConfig().b1
    return (jax.tree.map(np.asarray, params), float(metrics["loss"]),
            _paths(new.params),
            {k: v / (1 - b1) for k, v in _paths(new.opt_state["m"]).items()})


def _whole(tree, specs, mesh):
    """Every leaf of a rank's tree gathered whole over its spec's axes."""
    from repro_torch.sharding import collectives as coll
    from repro_torch.sharding.rules import split_axes, zip_map

    def whole(t, spec):
        for dim, axes in enumerate(spec):
            if axes is not None and split_axes((axes,), mesh):
                t = coll.all_gather(t.contiguous(), mesh, axes, dim=dim)
        return t
    return zip_map(whole, tree, specs)


def _body(rank, world, train):
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.core.schemes.base import tree_leaves
    from repro_torch.launch.cells import _tree_paths, build_cell
    from repro_torch.launch.mesh import make_debug_mesh
    out = {}
    for name, (arch, opts, changes, shape, params_np) in train.items():
        if shape[0] * shape[1] != world:
            continue
        m = make_debug_mesh(*shape, device="cpu")
        _, cfg = get_arch(arch, smoke=True)
        cfg = dataclasses.replace(cfg, **changes)
        # the options' config as build_cell applies it, for the params
        probe = build_cell(arch, ShapeSpec("t", "train", seq_len=SEQ,
                                           global_batch=B),
                           _abstract(shape), opts=opts, cfg=cfg)
        cell = build_cell(arch, ShapeSpec("t", "train", seq_len=SEQ,
                                          global_batch=B),
                          m, opts=opts, cfg=cfg,
                          params=lm_params_from_numpy(params_np,
                                                      probe.cell.cfg, "cpu"))
        tc = cell.cell
        batch = tc.local_batch({k: torch.from_numpy(v) for k, v in
                                _batch(cfg.vocab_size).items()})
        state, metrics = cell.fn(tc.state, batch)
        whole = _whole(state.params, tc.specs.params, m)
        out[name] = {"loss": float(metrics["loss"]),
                     "paths": [p for p, _ in _tree_paths(tc.specs.params)],
                     "params": [t.numpy().copy()
                                for t in tree_leaves(whole)]}
    return out


def _abstract(shape):
    from repro_torch.launch.mesh import AbstractMesh
    return AbstractMesh(shape, ("data", "model"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's references, every rank's results of both groups)."""
    refs = {name: _jax_train(arch, opts, changes)
            for name, (arch, opts, changes, _) in TRAIN.items()}
    train = {name: (arch, opts, changes, shape, refs[name][0])
             for name, (arch, opts, changes, shape) in TRAIN.items()}
    ranks = {}
    for world in (4, 8):
        ranks[world] = spawn(_body, world, args=(world, train),
                             store_dir=tmp_path_factory.mktemp("pg"),
                             timeout_s=TIMEOUT)
    return refs, ranks


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_named_options_step_matches_jax(runs, name):
    refs, ranks = runs
    _, loss, jparams, jgrads = refs[name]
    shape = TRAIN[name][3]
    for r in ranks[shape[0] * shape[1]]:
        out = r[name]
        assert abs(out["loss"] - loss) <= TOL + TOL * abs(loss)
        for path, p in zip(out["paths"], out["params"], strict=True):
            want = jparams[path].astype(np.float64)
            tiny = np.abs(jgrads[path]) < 1e-6
            gap = np.abs(p.astype(np.float64) - want)
            bar = np.where(tiny, 2 * LR, TOL + TOL * np.abs(want))
            assert (gap <= bar).all(), (name, path, float(gap.max()))
