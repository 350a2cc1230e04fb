"""The port's recsys serving and retrieval cells on a mesh against the JAX
package, on the CPU.

``launch/cells.py::recsys_serve_cell`` and ``recsys_retrieval_cell``,
the served models' ``serve(mesh=)`` (``models/recsys/fields.py::
serve_placed``: the per-rank quantized gather over each rank's code
block, a row-split full table through the row gather, a table kept
whole decoded in place) and ``sharding/rules.py::
recsys_artifact_specs``.  The ranks are gloo processes on the CPU
(``launch.mesh.spawn``), one group of 4 running every case on a
(2, 2) and a (1, 4) mesh.  JAX's own sharded tests fail on this tree
(ROADMAP.md §3), so each cell is held to the JAX cell's own ``fn``
run on one CPU device (a (1, 1) ``jax.make_mesh``) with real arrays,
jitted at XLA's optimisation level 0 (op by op, JAX compiles every
primitive: three times as long): JAX draws the params and exports the
artifacts, and both cross to the ranks as numpy arrays
(``convert.py``).  Bars:

* ``recsys_artifact_specs`` equal to the specs of JAX's ``art_spec``
  (read off the cell's shardings) for each CTR model's artifacts;
* serving (deepfm, autoint, bst, two-tower; two batch sizes, standing
  for ``serve_p99`` and ``serve_bulk``): the decoded rows of every field
  bit-identical to JAX's single-device ``serve``, the logits within
  1e-5; the fields include a code table that does not divide (10,001
  rows), a full table under 16·model rows (31) and full tables split
  by rows;
* retrieval: two-tower's ADC scores over a PQ-coded corpus split over
  every axis within 1e-5 and their top-100 ids identical; the CTR
  models' candidate logits within 1e-5;
* planted: a rank serving another rank's code block fails both bars.
"""
import dataclasses
import functools
import importlib

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.launch.mesh import spawn

TOL = 1e-5
TIMEOUT = 180.0
TOPK = 100
MESHES = ((2, 2), (1, 4))
# serve_p99 and serve_bulk, cut to the CPU
BATCHES = {"serve_p99": 8, "serve_bulk": 40}
N_CAND = {"two-tower-retrieval": 1000, "deepfm": 200, "autoint": 200,
          "bst": 200}
# a code table split by rows (12,000), one that does not divide (10,001)
# and stays whole, full tables split (500, 100, 64) and one under
# 16·model rows (31) kept whole
FIELDS = (12_000, 10_001, 500, 31, 100, 64)
ARCHS = {
    "deepfm": dict(field_vocab_sizes=FIELDS),
    "autoint": dict(field_vocab_sizes=FIELDS),
    "bst": dict(n_items=12_000),
    "two-tower-retrieval": dict(n_users=12_000, n_items=10_002),
}
CTR = ("deepfm", "autoint", "bst")
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False


def _cfgs(arch):
    """(the JAX config, the port's) of ``arch``'s small config."""
    _, cfg = get_arch(arch, smoke=True)
    cfg = dataclasses.replace(cfg, **ARCHS[arch])
    mod = importlib.import_module("repro.configs." + arch.replace("-", "_"))
    jcfg = dataclasses.replace(mod.smoke_config(), **ARCHS[arch],
                               kernel_backend="xla")
    return jcfg, cfg


def _np(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


def _jmesh():
    import jax
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(
        jax.sharding.AxisType.Auto,) * 2)


def _batch(arch, cfg, b, seed):
    rng = np.random.default_rng(seed)
    if arch == "two-tower-retrieval":
        return {"user_ids": rng.integers(0, cfg.n_users, b).astype(np.int32),
                "item_ids": rng.integers(0, cfg.n_items, b).astype(np.int32)}
    if arch == "bst":
        return {"hist_ids": rng.integers(0, cfg.n_items, (b, cfg.seq_len))
                .astype(np.int32),
                "target_id": rng.integers(0, cfg.n_items, b).astype(np.int32)}
    return {"sparse_ids": np.stack(
        [rng.integers(0, v, b) for v in cfg.field_vocab_sizes], 1
    ).astype(np.int32)}


def _corpus(cfg, n):
    d_out = cfg.tower_mlp[-1]
    n_sub = 16 if d_out % 16 == 0 else 8
    rng = np.random.default_rng(5)
    return {"codes": rng.integers(0, 256, (n, n_sub)).astype(np.uint8),
            "centroids": rng.normal(size=(n_sub, 256, d_out // n_sub))
            .astype(np.float32)}


def _fast(fn, *args):
    import jax
    return jax.jit(fn).lower(*args).compile(
        compiler_options=FAST_COMPILE)(*args)


def _strip(arch, params):
    """The JAX cell's ``serve_params``."""
    if arch == "bst":
        return {**params, "item_emb": {k: v for k, v in
                                       params["item_emb"].items()
                                       if k != "emb"}}
    return {**params, "fields": {f: {k: v for k, v in fv.items()
                                     if k != "emb"}
                                 for f, fv in params["fields"].items()}}


@functools.lru_cache(maxsize=None)
def _jax_case(arch):
    """JAX's params and artifacts, and its cells' outputs on one device
    (the serving cell at both batches, its decoded rows, the retrieval
    cell); all numpy."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import ShapeSpec as JShape
    from repro.launch import cells as jc
    jcfg, cfg = _cfgs(arch)
    jmodel = jc._recsys_model(jcfg)
    params = _fast(jmodel.init, jax.random.PRNGKey(0))
    out = {"params": _np(params), "serve": {}, "rows": {}}
    art = None
    if arch != "two-tower-retrieval":
        art = (jmodel.item_emb.export(params["item_emb"]) if arch == "bst"
               else jmodel.fields.export(params["fields"]))
        out["art"] = _np(art)
        cell = jc.recsys_serve_cell(arch, jcfg, JShape(
            "serve_p99", "rec_serve", batch=8), _jmesh(), False)
        out["art_spec"] = [tuple(s.spec) for s in
                           jax.tree_util.tree_leaves(cell.in_shardings[1])]
    for name, b in BATCHES.items():
        cell = jc.recsys_serve_cell(arch, jcfg, JShape(
            name, "rec_serve", batch=b), _jmesh(), False)
        batch = {k: jnp.asarray(v) for k, v in
                 _batch(arch, cfg, b, seed=b).items()}
        if art is None:
            out["serve"][name] = np.asarray(_fast(cell.fn, params, batch))
            continue
        out["serve"][name] = np.asarray(_fast(cell.fn, _strip(arch, params),
                                              art, batch))
        if arch == "bst":
            ids = jnp.concatenate([batch["hist_ids"],
                                   batch["target_id"][:, None]], 1)
            out["rows"][name] = np.asarray(_fast(jmodel.item_emb.serve,
                                                 art, ids))
        else:
            out["rows"][name] = np.asarray(_fast(
                jmodel.fields.serve, art, batch["sparse_ids"]))
    n = N_CAND[arch]
    cell = jc.recsys_retrieval_cell(arch, jcfg, JShape(
        "retrieval_cand", "rec_retrieval", batch=1, n_candidates=n),
        _jmesh(), False)
    if arch == "two-tower-retrieval":
        corpus = {k: jnp.asarray(v) for k, v in _corpus(cfg, n).items()}
        out["retrieval"] = np.asarray(_fast(cell.fn, params, corpus,
                                            jnp.asarray([7], jnp.int32)))
    else:
        batch = {k: jnp.asarray(v) for k, v in
                 _batch(arch, cfg, n, seed=11).items()}
        out["retrieval"] = np.asarray(_fast(cell.fn, params, batch))
    return out


def _port_params(arch, cfg, params_np):
    from repro_torch import convert
    from repro_torch.launch.cells import recsys_model
    model = recsys_model(cfg, device="cpu")
    conv = {"deepfm": convert.deepfm_params_from_numpy,
            "autoint": convert.autoint_params_from_numpy,
            "bst": convert.bst_params_from_numpy,
            "two-tower-retrieval": convert.two_tower_params_from_numpy}[arch]
    return conv(params_np, model, "cpu")


def _port_art(arch, cfg, art_np):
    from repro_torch.convert import artifact_from_numpy
    from repro_torch.launch.cells import recsys_model
    model = recsys_model(cfg, device="cpu")
    if arch == "bst":
        return artifact_from_numpy(art_np, model.item_emb.cfg, "cpu")
    return {f"f{i}": artifact_from_numpy(art_np[f"f{i}"], e.cfg, "cpu")
            for i, e in enumerate(model.fields.embs)}


class _OtherBlock:
    """A mesh whose ``model`` coordinate is the next rank's: placing an
    artifact through it hands this rank another rank's code block."""

    def __init__(self, mesh):
        self._mesh = mesh
        self.shape, self.device = mesh.shape, mesh.device

    def axis_index(self, axis):
        i = self._mesh.axis_index(axis)
        return (i + 1) % self.shape[axis] if axis == "model" else i


def _rows(cell, batch):
    """The decoded rows a CTR cell's step serves (every field, or bst's
    item table), through the same placed path."""
    from repro_torch.models.recsys.fields import serve_placed
    model = cell.model
    with torch.no_grad():
        if model.cfg.model == "bst":
            return serve_placed(model.item_emb, cell.artifacts,
                                model.ids(batch), cell.mesh)
        return model.fields.serve(cell.artifacts, batch["sparse_ids"],
                                  mesh=cell.mesh)


def _ranks_body(rank, cases):
    """Every case on this rank, on each mesh over the 4 ranks."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.cells import (recsys_retrieval_cell,
                                          recsys_serve_cell)
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.sharding.rules import place, recsys_artifact_specs
    out = {}
    for shape in MESHES:
        m = make_debug_mesh(*shape, device="cpu")
        res = out[shape] = {"coords": (m.axis_index("data"),
                                       m.axis_index("model"))}
        for arch, (params_np, art_np) in cases.items():
            _, cfg = _cfgs(arch)
            params = _port_params(arch, cfg, params_np)
            art = None if art_np is None else _port_art(arch, cfg, art_np)
            got = res[arch] = {"serve": {}, "rows": {}}
            for name, b in BATCHES.items():
                cell = recsys_serve_cell(
                    cfg, ShapeSpec(name, "rec_serve", batch=b), m,
                    params=params, artifacts=art)
                batch = cell.local_batch(_batch(arch, cfg, b, seed=b))
                got["serve"][name] = cell.step(batch).numpy()
                if art is not None:
                    got["rows"][name] = _rows(cell, batch).numpy()
            if arch == "deepfm":
                # planted: each rank placed with the next rank's blocks
                cell.artifacts = place(art, recsys_artifact_specs(art, m),
                                       _OtherBlock(m))
                got["planted"] = (cell.step(batch).numpy(),
                                  _rows(cell, batch).numpy())
            n = N_CAND[arch]
            cell = recsys_retrieval_cell(cfg, ShapeSpec(
                "retrieval_cand", "rec_retrieval", batch=1,
                n_candidates=n), m, params=params)
            if arch == "two-tower-retrieval":
                got["retrieval"] = cell.step(
                    cell.local_corpus(_corpus(cfg, n)),
                    torch.tensor([7], dtype=torch.int32)).numpy()
            else:
                got["retrieval"] = cell.step(cell.local_candidates(
                    _batch(arch, cfg, n, seed=11))).numpy()
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = {arch: (_jax_case(arch)["params"], _jax_case(arch).get("art"))
             for arch in ARCHS}
    return spawn(_ranks_body, 4, args=(cases,),
                 store_dir=str(tmp_path_factory.mktemp("recsys_serve")),
                 timeout_s=TIMEOUT)


def _rows_of(want, shape, coords, b):
    d = coords[0]
    bl = b // shape[0]
    return want[d * bl:(d + 1) * bl]


@pytest.mark.parametrize("arch", CTR)
def test_artifact_specs_equal_jax_art_spec(arch):
    """``recsys_artifact_specs`` on a (1, 1) mesh (every leaf of at least
    16 rows split over ``model``) equal to the JAX cell's artifact
    shardings; on (2, 2) and (1, 4) the fields under 16·model rows or
    that do not divide stay whole."""
    from repro_torch.sharding.rules import recsys_artifact_specs, spec_leaves

    class _M:
        def __init__(self, model):
            self.shape = {"data": 1, "model": model}
    ref = _jax_case(arch)
    _, cfg = _cfgs(arch)
    art = _port_art(arch, cfg, ref["art"])
    assert spec_leaves(recsys_artifact_specs(art, _M(1))) == ref["art_spec"]
    if arch != "bst":
        for model in (2, 4):
            specs = recsys_artifact_specs(art, _M(model))
            split = [specs[f"f{i}"].get("codes", specs[f"f{i}"].get("emb"))
                     == ("model", None) for i in range(len(FIELDS))]
            assert split == [True, False, True, False, True, True]


@pytest.mark.parametrize("batch", sorted(BATCHES))
@pytest.mark.parametrize("shape", MESHES, ids=["2x2", "1x4"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_serve_cell_matches_jax_single_device(ranks, arch, shape, batch):
    """Each rank's logits (its data shard's rows) within 1e-5 of the JAX
    cell's fn on one device; a CTR model's decoded rows bit-identical."""
    ref = _jax_case(arch)
    b = BATCHES[batch]
    for r in ranks:
        out = r[shape]
        got = out[arch]
        np.testing.assert_allclose(
            got["serve"][batch],
            _rows_of(ref["serve"][batch], shape, out["coords"], b),
            rtol=TOL, atol=TOL)
        if arch in CTR:
            np.testing.assert_array_equal(
                got["rows"][batch],
                _rows_of(ref["rows"][batch], shape, out["coords"], b))


@pytest.mark.parametrize("shape", MESHES, ids=["2x2", "1x4"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_retrieval_cell_matches_jax_single_device(ranks, arch, shape):
    """All N scores on every rank within 1e-5 of the JAX cell's; for
    two-tower the top-100 ids of the gathered scores identical (a stable
    sort, as ``jax.lax.top_k`` breaks ties)."""
    want = _jax_case(arch)["retrieval"]
    for r in ranks:
        got = r[shape][arch]["retrieval"]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        if arch == "two-tower-retrieval":
            top = np.argsort(-got, kind="stable")[:TOPK]
            np.testing.assert_array_equal(
                top, np.argsort(-want, kind="stable")[:TOPK])


@pytest.mark.parametrize("shape", MESHES, ids=["2x2", "1x4"])
def test_planted_other_block_fails(ranks, shape):
    """A rank serving the next rank's code blocks (deepfm, serve_bulk's
    batch) decodes other rows and moves the logits past the bar."""
    ref = _jax_case("deepfm")
    b = BATCHES["serve_bulk"]
    for r in ranks:
        out = r[shape]
        logits, rows = out["deepfm"]["planted"]
        want_rows = _rows_of(ref["rows"]["serve_bulk"], shape,
                             out["coords"], b)
        assert not np.array_equal(rows, want_rows)
        want = _rows_of(ref["serve"]["serve_bulk"], shape, out["coords"], b)
        assert np.abs(logits - want).max() > 100 * TOL
