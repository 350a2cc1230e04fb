"""The port's distributed recsys training against the JAX package: the
sharded row gather (``sharding/gather.py``), the recsys rules
(``sharding/rules.py``), the sharded clip, the train cell
(``launch/cells.py::recsys_train_cell``), checkpoints of whole arrays
and the elastic restore, and ``train --mesh``.

JAX's own sharded training test fails on this tree
(``tests/test_sharding.py::test_sharded_rows_train_lookup_private_variants``,
``ShardingTypeError``), so the port's sharded steps are held to JAX's
SINGLE-device step on the same global batch.  JAX runs in this process
only; params, batches and references cross to the ranks as numpy
arrays.  The ranks are gloo processes on the CPU (``launch.mesh.spawn``,
forked from a server that imported torch and nothing of JAX), one
group a test running all its cases.  Bars:

* specs: the param, adagrad-state and batch spec trees equal to
  ``tuple(P)`` of JAX's ``recsys_param_rules``/``recsys_batch_spec``;
* the row gather: forward rows bit-identical to JAX's single-device
  ``apply`` (``jnp.take``; lrf's ``u[ids] @ v`` within 1e-5, a matmul
  that rounds by its shape), aux within 1e-5 (a rank's aux weighted by
  B_local/B_global, summed), gradients within 1e-5 of ``jax.grad``, on
  (2, 2), (1, 4) and (4, 1), for every scheme that reads a table;
* 3 adagrad steps of each recsys model on (2, 2): losses, the reduced
  gradients and the clipped gradients adagrad consumed within 1e-5 of
  JAX's, the accumulators within 1e-5, every param within float32
  rounding of a float64 adagrad over the rank's own gradients and
  apart from JAX's by no more than the two replays are
  (``adagrad_replay``, as ``tests/test_torch_autoint.py`` holds one
  device); replicated leaves bit-identical on every rank, row blocks
  on every rank of their model index; every table the rules row-shard
  read through the sharded gather;
* planted faults fail those bars: a missing B_local/B_global weight, a
  per-rank two-tower softmax, tiers keyed on a block's local ids, a
  plain read of a placed block, a clip by the rank's local norm;
* checkpoints: a (2, 2) state restored on (1, 4), (4, 1) and one
  device equal to the saved whole arrays, a step after each within
  1e-5 of the uninterrupted run's, a same-mesh resume bit-identical;
* ``train --mesh`` on 4 CPU ranks within 1e-5 of one device's
  ``train``, and its refusals.
"""
import contextlib
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core.schemes.base import tree_leaves, tree_map
from repro_torch.launch.mesh import spawn

TIMEOUT = 180.0
TOL = 1e-5
MESHES = {"2x2": (2, 2), "1x4": (1, 4), "4x1": (4, 1)}
# XLA's CPU backend at optimisation level 0: JAX's references compile in
# about half the time, the same program within float32 rounding
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
LR32 = float(np.float32(1e-2))      # adagrad's lr as the step holds it
EPS = 1e-8
STEPS = 3
BATCH = 32
# small vocabularies that exercise every branch of the rules on a
# (2, 2) mesh: split (12,000, 500, 100, 64 rows), odd (10,001) and
# under 16·model (31) kept whole; the mgqe field's tier boundary (row
# 1,200 of 12,000) keyed on a block's local ids moves ids 6,000-7,199
FIELDS = (12_000, 10_001, 500, 31, 100, 64)
ARCHS = {
    "deepfm": dict(field_vocab_sizes=FIELDS),
    "autoint": dict(field_vocab_sizes=FIELDS),
    "bst": dict(n_items=12_000),
    "two-tower-retrieval": dict(n_users=12_000, n_items=10_002),
}
# the faults each model's run plants (each must fail a bar)
PLANTED = {
    "deepfm": ("unweighted", "local_tiers", "local_clip", "plain_read"),
    "autoint": ("unweighted",),
    "bst": ("unweighted",),
    "two-tower-retrieval": ("per_rank_softmax", "unweighted"),
}
# the schemes' tables for the row gather (vocab 128, dim 16); the tier
# boundaries at 40 and 80 lie inside model shard 1 on the 2x2 mesh
SCHEMES = {
    "full": dict(kind="full"),
    "sq": dict(kind="sq", sq_bits=8),
    "lrf": dict(kind="lrf", rank=4),
    "hash": dict(kind="hash", hash_buckets=32),
    "dpq": dict(kind="dpq", num_subspaces=4, num_centroids=8),
    "shared_k": dict(kind="mgqe", num_subspaces=4, num_centroids=8,
                     tier_boundaries=(40, 80),
                     tier_num_centroids=(8, 4, 2)),
    "private_k": dict(kind="mgqe", mgqe_variant="private_k",
                      num_subspaces=4, num_centroids=8,
                      tier_boundaries=(40, 80),
                      tier_num_centroids=(8, 4, 2)),
    "private_d": dict(kind="mgqe", mgqe_variant="private_d",
                      num_subspaces=4, num_centroids=8,
                      tier_boundaries=(40, 80),
                      tier_num_subspaces=(4, 2, 1)),
    "rq": dict(kind="rq", num_levels=3, num_centroids=8),
    "mpe": dict(kind="mpe", num_subspaces=8, tier_boundaries=(40, 80),
                tier_bits=(8, 4, 2)),
}


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False


class _ShapeOnlyMesh:
    """The rules read a mesh's axis sizes only: no ranks needed."""

    def __init__(self, data, model):
        self.shape = {"data": data, "model": model}


def _cfgs(arch):
    """(the JAX config, the port's) of ``arch``'s small training config."""
    import importlib
    _, cfg = get_arch(arch, smoke=True)
    cfg = dataclasses.replace(cfg, **ARCHS[arch])
    mod = importlib.import_module(
        "repro.configs." + arch.replace("-", "_"))
    jcfg = dataclasses.replace(mod.smoke_config(), **ARCHS[arch],
                               kernel_backend="xla")
    return jcfg, cfg


def _np(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


def _jax_leaves(tree):
    import jax
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _jax_spec_tuples(specs):
    import jax
    from jax.sharding import PartitionSpec as P
    return jax.tree.map(tuple, specs, is_leaf=lambda x: isinstance(x, P))


def _port_params(arch, cfg, params_np, device="cpu"):
    from repro_torch import convert
    from repro_torch.launch.cells import recsys_model
    model = recsys_model(cfg, device=device)
    conv = {"deepfm": convert.deepfm_params_from_numpy,
            "autoint": convert.autoint_params_from_numpy,
            "bst": convert.bst_params_from_numpy,
            "two-tower-retrieval": convert.two_tower_params_from_numpy}[arch]
    return conv(params_np, model, device)


def _batches(arch, cfg, n=STEPS, batch=BATCH):
    """The first ``n`` global batches of ``recsys_stream``, as numpy."""
    from repro_torch.launch.train import recsys_stream
    stream = recsys_stream(cfg, batch)
    return [{k: v.numpy() for k, v in next(stream).items()}
            for _ in range(n)]


# ----------------------------------------------------------------------
# specs, no ranks
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_recsys_specs_equal_jax(arch, mesh):
    """Param, adagrad-state and batch spec trees equal JAX's, on the
    JAX params' shapes; deepfm's dim-1 first-order tables and the small
    fields included, whatever their ``sharded_rows``."""
    import jax
    from repro.launch.cells import _recsys_model
    from repro.sharding import rules as jax_rules
    from repro_torch.sharding import rules
    jcfg, cfg = _cfgs(arch)
    m = _ShapeOnlyMesh(*MESHES[mesh])
    jparams = jax.eval_shape(_recsys_model(jcfg).init, jax.random.PRNGKey(0))
    want = _jax_spec_tuples(jax_rules.spec_tree(
        jparams, jax_rules.recsys_param_rules(jcfg, m)))
    params = jax.tree.map(lambda s: torch.empty(s.shape, device="meta"),
                          jparams)
    p_spec, o_spec = rules.recsys_state_specs(params, cfg, m)
    assert p_spec == want
    assert o_spec == {"step": (), "acc": want}
    if arch == "deepfm" and mesh == "2x2":
        # the dim-1 first-order tables, built with no sharded_rows
        cut, whole = ("model", None), (None, None)
        assert [p_spec["first_order"][f"f{i}"]["emb"] for i in range(6)] \
            == [cut, whole, cut, whole, cut, cut]
    for multi_pod in (False, True):
        b = {k: torch.from_numpy(v) for k, v in
             _batches(arch, cfg, n=1, batch=8)[0].items()}
        b["scalar"] = torch.zeros(())
        jb = jax.tree.map(lambda t: jax.ShapeDtypeStruct(
            tuple(t.shape), np.float32), b)
        assert rules.recsys_batch_spec(b, multi_pod) == _jax_spec_tuples(
            jax_rules.recsys_batch_spec(jb, multi_pod))


# ----------------------------------------------------------------------
# the row gather, every scheme that reads a table
# ----------------------------------------------------------------------

def _scheme_kw(name):
    return dict(vocab_size=128, dim=16, **SCHEMES[name])


def _plant_local_tiers(mesh):
    """Tiers keyed on the rank's block-local ids: what a gather that
    handed the lookup its local rows' ids would do."""
    from repro_torch.core import mgqe
    from repro_torch.core import partition
    rows_local = 128 // mesh.shape["model"]
    off = mesh.axis_index("model") * rows_local

    def local_tiers(ids, bounds):
        return partition.tier_of_ids(ids - off, bounds)
    mgqe.tier_of_ids = local_tiers


def _gather_body(rank, mesh_shape, cases, planted):
    """Each case's rows, aux and gradients on this rank: the scheme's
    ``apply`` under the mesh over this rank's placed params and its data
    shard of the ids, with the loss sum(rows * w) + aux · B_local /
    B_global; a replicated leaf's gradient summed over data.  Then the
    direct ``row_gather`` of a (128, 8) table's block."""
    from repro_torch.core import Embedding, EmbeddingConfig
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.sharding import rules
    from repro_torch.sharding.collectives import psum
    from repro_torch.sharding.gather import data_shard_index, row_gather
    from repro_torch.train.optimizer import loss_grads
    m = make_debug_mesh(*mesh_shape, device="cpu")
    if planted == "local_tiers":
        _plant_local_tiers(m)
    data_n = mesh_shape[0]
    d = data_shard_index(m, ("data",))
    out = []
    for kw, params_np, ids, w in cases:
        cfg = EmbeddingConfig(**kw)
        emb = Embedding(cfg, device="cpu")
        whole = params_from_numpy(params_np, cfg, "cpu")
        specs = rules.spec_tree(whole, rules.recsys_param_rules(None, m))
        params = rules.place(whole, specs, m)
        b = ids.shape[0] // data_n
        ids_l = torch.from_numpy(ids[d * b:(d + 1) * b])
        w_l = torch.from_numpy(w[d * b:(d + 1) * b])

        def loss(p, _):
            rows, aux = emb.apply(p, ids_l, mesh=m)
            return torch.sum(rows * w_l) + aux / data_n, {
                "rows": rows, "aux": aux}

        grads, got = loss_grads(loss, params, None)
        split = [rules.splits(s, m) for s in rules.spec_leaves(specs)]
        gl = [g if cut else psum(g, m, "data")
              for g, cut in zip(tree_leaves(grads), split)]
        out.append((got["rows"].numpy(), float(got["aux"]),
                    [g.numpy() for g in gl], split))
    table = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (128, 8)).astype(np.float32))
    block = rules.place(table, ("model", None), m).requires_grad_(True)
    ids = cases[0][2]
    b = ids.shape[0] // data_n
    ids_l = torch.from_numpy(ids[d * b:(d + 1) * b])
    rows = row_gather(block, ids_l, m)
    w_l = torch.from_numpy(cases[0][3][d * b:(d + 1) * b, :, :8].copy())
    (g,) = torch.autograd.grad(torch.sum(rows * w_l), [block])
    return out, (rows.detach().numpy(), g.numpy())


@functools.lru_cache(maxsize=None)
def _gather_refs(names, seed=0):
    """(cases for the ranks, JAX's single-device rows, aux and grads,
    the direct gather's rows and grad), jitted at ``FAST_COMPILE``."""
    import jax
    import jax.numpy as jnp
    from repro.core import Embedding as JaxEmbedding
    from repro.core import EmbeddingConfig as JaxConfig
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 128, (8, 3)).astype(np.int32)
    w = rng.standard_normal((8, 3, 16)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    cases, refs = [], []
    for name in names:
        kw = _scheme_kw(name)
        jemb = JaxEmbedding(JaxConfig(**kw, kernel_backend="xla"))

        def loss(p):
            rows, aux = jemb.apply(p, jnp.asarray(ids))
            return jnp.sum(rows * w) + aux, (rows, aux)

        p = _fast(jemb.init, key)
        g, (rows, aux) = _fast(jax.grad(loss, has_aux=True), p)
        cases.append((kw, _np(p), ids, w))
        refs.append((np.asarray(rows), float(aux), _jax_leaves(g)))
    table = np.random.default_rng(5).standard_normal((128, 8)).astype(
        np.float32)

    def direct(t):
        rows = jnp.take(t, jnp.asarray(ids), axis=0)
        return jnp.sum(rows * w[:, :, :8]), rows

    g_d, rows_d = _fast(jax.grad(direct, has_aux=True), jnp.asarray(table))
    return cases, refs, (np.asarray(rows_d), np.asarray(g_d))


def _fast(fn, *args):
    """``fn(*args)``, jitted and compiled at ``FAST_COMPILE``."""
    import jax
    return jax.jit(fn).lower(*args).compile(
        compiler_options=FAST_COMPILE)(*args)


def _block(a, cut, rank, mesh_shape):
    """Rank's block of the whole array ``a`` when ``cut``, else ``a``."""
    if not cut:
        return a
    model_n = mesh_shape[1]
    n = a.shape[0] // model_n
    j = rank % model_n
    return a[j * n:(j + 1) * n]


def _check_gather(res, refs, direct, mesh_shape, names):
    data_n, model_n = mesh_shape
    for rank, (out, (rows_d, g_d)) in enumerate(res):
        d = rank // model_n
        for name, (rows, aux, grads, split), (j_rows, j_aux, j_grads) in \
                zip(names, out, refs):
            b = j_rows.shape[0] // data_n
            want = j_rows[d * b:(d + 1) * b]
            if name == "lrf":      # u's rows times v: a matmul's rounding
                np.testing.assert_allclose(rows, want, rtol=TOL, atol=TOL)
            else:
                np.testing.assert_array_equal(rows, want, err_msg=name)
            assert len(grads) == len(j_grads), name
            for g, jg, cut in zip(grads, j_grads, split):
                np.testing.assert_allclose(
                    g, _block(jg, cut, rank, mesh_shape), rtol=TOL,
                    atol=TOL, err_msg=name)
        b = direct[0].shape[0] // data_n
        np.testing.assert_array_equal(rows_d, direct[0][d * b:(d + 1) * b])
        np.testing.assert_allclose(g_d, _block(direct[1], True, rank,
                                               mesh_shape), rtol=TOL,
                                   atol=TOL)
    # the aux: each data shard's weighted share, summed
    for i, name in enumerate(names):
        total = sum(res[d * model_n][0][i][1] for d in range(data_n))
        np.testing.assert_allclose(total / data_n, refs[i][1], rtol=TOL,
                                   atol=TOL, err_msg=name)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_row_gather_matches_jax_single_device(mesh, tmp_path):
    """Every scheme that reads a table (full, sq, lrf's ``u``, hash's
    buckets, dpq, the three mgqe variants, rq, mpe) through its
    ``apply`` on this mesh, and the direct gather of one table's
    block."""
    mesh_shape = MESHES[mesh]
    names = tuple(sorted(SCHEMES))
    cases, refs, direct = _gather_refs(names)
    res = spawn(_gather_body, mesh_shape[0] * mesh_shape[1],
                args=(mesh_shape, cases, None), store_dir=str(tmp_path),
                timeout_s=TIMEOUT)
    _check_gather(res, refs, direct, mesh_shape, names)


def test_tiers_keyed_on_local_ids_fail(tmp_path):
    """A planted lookup that keys the mgqe tiers on the block's local
    ids gives other rows on the ranks of model shard 1."""
    mesh_shape = MESHES["2x2"]
    names = ("shared_k", "private_k", "private_d")
    cases, refs, direct = _gather_refs(names)
    res = spawn(_gather_body, 4, args=(mesh_shape, cases, "local_tiers"),
                store_dir=str(tmp_path), timeout_s=TIMEOUT)
    with pytest.raises(AssertionError):
        _check_gather(res, refs, direct, mesh_shape, names)
    for rank in (1, 3):                  # model shard 1
        for (rows, *_), (j_rows, *_) in zip(res[rank][0], refs):
            d = rank // 2
            assert not np.array_equal(rows, j_rows[d * 4:(d + 1) * 4])


def _plain_read_body(rank):
    """A placed block read plainly: the guard refuses it."""
    from repro_torch.core import dpq
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.recsys.bst import BST
    from repro_torch.sharding import rules
    m = make_debug_mesh(2, 2, device="cpu")
    table = torch.arange(128 * 4, dtype=torch.float32).reshape(128, 4)
    block = rules.place(table, ("model", None), m)
    ids = torch.tensor([1, 70, 127, 64])
    out = {"gathered": dpq.row_gather(block, ids, mesh=m, rows=128).numpy()}
    for what, call in (
            ("wrong rows", lambda: dpq.row_gather(block, ids, mesh=m,
                                                   rows=100)),
            ("no rows", lambda: dpq.row_gather(block, ids, mesh=m))):
        try:
            call()
            out[what] = None
        except ValueError as e:
            out[what] = str(e)
    _, cfg = get_arch("bst", smoke=True)
    cfg = dataclasses.replace(cfg, seq_len=31, n_items=64)
    model = BST(cfg, device="cpu")
    whole = model.init(torch.Generator().manual_seed(0))
    specs = rules.spec_tree(whole, rules.recsys_param_rules(cfg, m))
    params = rules.place(whole, specs, m)
    batch = {"hist_ids": torch.zeros((2, 31), dtype=torch.int32),
             "target_id": torch.zeros((2,), dtype=torch.int32),
             "label": torch.zeros((2,))}
    try:
        model.loss(params, batch, mesh=m)
        out["pos_emb"] = None
    except ValueError as e:
        out["pos_emb"] = str(e)
    out["pos_spec"] = specs["pos_emb"]
    return out


def test_a_placed_block_is_never_read_plainly(tmp_path):
    """The gather reads a block through the sharded route (rows equal to
    the whole table's); a block of another size, a call with no row
    count and bst's ``pos_emb`` placed row-sharded (32 rows: the rules'
    ``emb$`` takes it before ``pos_emb$``) raise."""
    res = spawn(_plain_read_body, 4, store_dir=str(tmp_path),
                timeout_s=TIMEOUT)
    table = np.arange(128 * 4, dtype=np.float32).reshape(128, 4)
    for out in res:
        np.testing.assert_array_equal(out["gathered"],
                                      table[[1, 70, 127, 64]])
        assert "does not row-shard" in out["wrong rows"]
        assert "global row count" in out["no rows"]
        assert out["pos_spec"] == ("model", None)
        assert "pos_emb holds 16 of its 32 rows" in out["pos_emb"]


# ----------------------------------------------------------------------
# 3 adagrad steps of each recsys model on a (2, 2) mesh
# ----------------------------------------------------------------------

def _per_rank_softmax(self, params, batch, mesh=None):
    """Two-tower's loss with the softmax over this rank's items only:
    under GSPMD the softmax is over the global batch, so this is
    another loss."""
    from repro_torch.models.recsys.two_tower import INV_TEMPERATURE
    u, aux_u = self.user_vec(params, batch["user_ids"], mesh)
    v, aux_v = self.item_vec(params, batch["item_ids"], mesh)
    logits = (u @ v.T) * INV_TEMPERATURE - batch["item_logq"][None, :]
    sm = torch.mean(torch.logsumexp(logits, -1) - torch.diagonal(logits))
    loss = sm + aux_u + aux_v
    return loss, {"loss": loss, "softmax": sm, "aux": aux_u + aux_v}


@contextlib.contextmanager
def _planted(fault, mesh):
    """``fault`` planted in this rank's process for the block."""
    from repro_torch.core import mgqe, partition
    from repro_torch.launch import cells
    from repro_torch.models.recsys.two_tower import TwoTower
    from repro_torch.sharding import gather
    from repro_torch.train import optimizer
    saved = [(cells.RecsysTrainCell, "data_shards"), (TwoTower, "loss"),
             (mgqe, "tier_of_ids"), (optimizer, "clip_by_global_norm"),
             (gather, "placed_row_gather")]
    saved = [(o, name, o.__dict__[name]) for o, name in saved]
    clip = optimizer.clip_by_global_norm
    if fault == "unweighted":          # the local mean backpropagated
        cells.RecsysTrainCell.data_shards = property(lambda self: 1)
    elif fault == "per_rank_softmax":
        TwoTower.loss = _per_rank_softmax
    elif fault == "local_tiers":       # the mgqe field's block offset
        off = mesh.axis_index("model") * (FIELDS[0] // mesh.shape["model"])
        mgqe.tier_of_ids = lambda ids, b: partition.tier_of_ids(ids - off, b)
    elif fault == "local_clip":        # each rank's own blocks' norm
        optimizer.clip_by_global_norm = \
            lambda g, n, mesh=None, specs=None: clip(g, n)
    elif fault == "plain_read":        # a placed block read plainly
        gather.placed_row_gather = \
            lambda table, ids, mesh, rows, model_axis="model": \
            table[ids.long()]
    try:
        yield
    finally:
        for o, name, value in saved:
            setattr(o, name, value)


def _train_body(rank, arch, cfg_kw, params_np, batches, faults):
    """3 steps of the train cell on this rank's data shards, first as it
    is and then with each of ``faults`` planted: for each run, each
    step's metrics, reduced (pre-clip) gradients and the tape adagrad
    consumed, the final params and accumulators and the leaves' split
    flags, or the error a run raised."""
    from repro_torch.launch.mesh import make_debug_mesh
    m = make_debug_mesh(2, 2, device="cpu")
    _, cfg = get_arch(arch, smoke=True)
    cfg = dataclasses.replace(cfg, **cfg_kw)
    runs = []
    for fault in (None,) + tuple(faults):
        with _planted(fault, m), _gathered() as tables:
            try:
                runs.append(_train_run(cfg, m, _port_params(
                    arch, cfg, params_np), batches))
            except (IndexError, RuntimeError) as e:
                runs.append(f"{type(e).__name__}: {e}")
        if fault is None:
            runs[0]["gathered"] = tables
    return runs


@contextlib.contextmanager
def _gathered():
    """The storage of every table that went through the sharded row
    gather within the block (yields the set)."""
    from repro_torch.sharding import gather
    tables, row_gather = set(), gather.row_gather

    def recording(table, ids, mesh, model_axis="model", rows=None):
        tables.add(table.untyped_storage().data_ptr())
        return row_gather(table, ids, mesh, model_axis, rows)
    gather.row_gather = recording
    try:
        yield tables
    finally:
        gather.row_gather = row_gather


def _train_run(cfg, m, params, batches):
    from repro_torch.launch.cells import recsys_train_cell
    from repro_torch.launch.train import RECSYS_OPTIMIZER
    from repro_torch.train.optimizer import (TrainState, apply_updates,
                                             record_adagrad)
    cell = recsys_train_cell(cfg, m, params=params)
    state, hist, grads_seen = cell.state, [], []
    with record_adagrad() as tape:
        for b in batches:
            batch = cell.local_batch({k: torch.from_numpy(v)
                                      for k, v in b.items()})
            grads, metrics = cell.reduce(*cell.grads(state, batch))
            grads_seen.append([g.clone().numpy()
                               for g in tree_leaves(grads)])
            params, opt_state = apply_updates(
                RECSYS_OPTIMIZER, state.params, grads, state.opt_state,
                mesh=m, specs=cell.specs.params)
            state = TrainState(params, opt_state)
            hist.append({k: float(v) for k, v in metrics.items()})
    return dict(hist=hist, grads=grads_seen,
                tape=[[g.numpy() for g in t[3]] for t in tape],
                params=[t.numpy() for t in tree_leaves(state.params)],
                acc=[t.numpy() for t in tree_leaves(state.opt_state["acc"])],
                split=cell.split,
                storage=[t.untyped_storage().data_ptr()
                         for t in tree_leaves(state.params)])


def _jax_run(jcfg, batches):
    """JAX's single-device step on the global batches: (init params,
    each step's metrics and ``jax.grad``, the tape recovered from each
    step's move (p - p')(sqrt(A) + eps)/lr, the final params and
    accumulators), as numpy."""
    import jax
    import jax.numpy as jnp
    from repro.launch.cells import _recsys_model
    from repro.train import optimizer as jopt
    jmodel = _recsys_model(jcfg)
    params = _fast(jmodel.init, jax.random.PRNGKey(0))
    ocfg = jopt.OptimizerConfig(kind="adagrad", lr=1e-2)
    state = jopt.init(ocfg, params)

    def step(params, state, batch):
        (_, metrics), g = jax.value_and_grad(jmodel.loss, has_aux=True)(
            params, batch)
        params, state = jopt.apply_updates(ocfg, params, g, state)
        return params, state, metrics, g

    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    step = jax.jit(step).lower(params, state, jb[0]).compile(
        compiler_options=FAST_COMPILE)    # compiled once, run 3 times
    p0 = _np(params)
    hist, grads, tape = [], [], []
    prev = [x.astype(np.float64) for x in _jax_leaves(params)]
    for b in jb:
        params, state, metrics, g = step(params, state, b)
        hist.append({k: float(v) for k, v in metrics.items()})
        grads.append(_jax_leaves(g))
        p = [x.astype(np.float64) for x in _jax_leaves(params)]
        acc = [x.astype(np.float64) for x in _jax_leaves(state["acc"])]
        tape.append([(q - x) * (np.sqrt(a) + EPS) / LR32
                     for q, x, a in zip(prev, p, acc)])
        prev = p
    return p0, dict(hist=hist, grads=grads, tape=tape,
                    params=_jax_leaves(params), acc=_jax_leaves(state["acc"]))


def _check_rank(rank, out, p0_leaves, ref):
    """One rank's run against JAX's (the bars of the module docstring)."""
    from repro_torch.train.optimizer import adagrad_replay
    mesh_shape = MESHES["2x2"]

    def blk(a, cut):
        return _block(np.asarray(a), cut, rank, mesh_shape)

    split = out["split"]
    for h, jh in zip(out["hist"], ref["hist"], strict=True):
        assert set(h) == set(jh)
        for k in h:
            np.testing.assert_allclose(h[k], jh[k], rtol=TOL, atol=TOL,
                                       err_msg=k)
    for gs, jgs in zip(out["grads"], ref["grads"], strict=True):
        for g, jg, cut in zip(gs, jgs, split, strict=True):
            np.testing.assert_allclose(g, blk(jg, cut), rtol=TOL, atol=TOL)
    p0 = [torch.from_numpy(blk(p, cut).copy())
          for p, cut in zip(p0_leaves, split)]
    tape = [("cpu", LR32, EPS, [torch.from_numpy(g) for g in t])
            for t in out["tape"]]
    jtape = [("jax", LR32, EPS, [torch.from_numpy(blk(g, cut).copy())
                                 for g, cut in zip(t, split)])
             for t in ref["tape"]]
    for (_, _, _, gs), (_, _, _, jgs) in zip(tape, jtape):
        for g, jg in zip(gs, jgs):
            np.testing.assert_allclose(g.numpy(), jg.numpy(), rtol=TOL,
                                       atol=TOL)
    replay, racc, slack = adagrad_replay(p0, tape)
    jreplay, _, jslack = adagrad_replay(p0, jtape)
    for t, j, a, ja, r, jr, ra, s, js, cut in zip(
            out["params"], ref["params"], out["acc"], ref["acc"], replay,
            jreplay, racc, slack, jslack, split, strict=True):
        np.testing.assert_allclose(a, blk(ja, cut), rtol=TOL, atol=TOL)
        t, a = torch.from_numpy(t).double(), torch.from_numpy(a).double()
        assert bool(((a - ra).abs() <= ra * STEPS * 2.0 ** -22).all())
        assert bool(((t - r).abs() <= s).all())
        gap = (t - torch.from_numpy(blk(j, cut).astype(np.float64))).abs()
        assert bool((gap <= (r - jr).abs() + s + js).all())


def _check_replicas(res):
    """Replicated leaves bit-identical on every rank; a row block on
    every rank of its model index."""
    model_n = MESHES["2x2"][1]
    for rank, out in enumerate(res):
        for t, first, peer, cut in zip(out["params"], res[0]["params"],
                                       res[rank % model_n]["params"],
                                       out["split"], strict=True):
            np.testing.assert_array_equal(t, peer if cut else first)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_sharded_steps_match_jax_single_device(arch, tmp_path):
    """3 adagrad steps on a (2, 2) mesh against JAX's single-device step
    on the same global batches; then each of the arch's planted faults
    (``PLANTED``) must fail a bar."""
    jcfg, cfg = _cfgs(arch)
    batches = _batches(arch, cfg)
    p0, ref = _jax_run(jcfg, batches)
    p0_leaves = _jax_leaves(p0)
    res = spawn(_train_body, 4, args=(arch, ARCHS[arch], p0, batches,
                                      PLANTED[arch]),
                store_dir=str(tmp_path), timeout_s=TIMEOUT)
    runs = [r[0] for r in res]
    assert sum(runs[0]["split"]) > 0
    for rank, out in enumerate(runs):
        _check_rank(rank, out, p0_leaves, ref)
        # every table the rules row-shard went through the sharded gather
        assert {p for p, cut in zip(out["storage"], out["split"]) if cut} \
            <= out["gathered"]
    _check_replicas(runs)
    for i, fault in enumerate(PLANTED[arch], 1):
        planted = [r[i] for r in res]
        if fault == "plain_read":       # a block's ids fall outside it
            assert any("IndexError" in str(r) for r in planted), fault
            continue
        with pytest.raises(AssertionError):
            for rank, out in enumerate(planted):
                _check_rank(rank, out, p0_leaves, ref)


# ----------------------------------------------------------------------
# checkpoints of whole arrays, the elastic restore, fit under a mesh
# ----------------------------------------------------------------------

def _elastic_body(rank, ckpt_dir, cfg_kw, params_np, batches):
    """deepfm on (2, 2): ``fit`` 2 steps writing a checkpoint at step 2,
    then on to step 3 (the uninterrupted run); ``fit`` resumed from the
    checkpoint on the same mesh; then on (1, 4) and (4, 1) meshes of
    the same ranks: the restored blocks, and ``fit`` resumed to step
    3.  Returns each run's final params (this rank's) and losses."""
    from repro_torch.launch.cells import recsys_train_cell
    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding.rules import whole_like
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train.loop import LoopConfig, fit
    from repro_torch.train.optimizer import TrainState
    _, cfg = get_arch("deepfm", smoke=True)
    cfg = dataclasses.replace(cfg, **cfg_kw)
    out = {}

    def run(shape, start, total, **loop):
        m = Mesh(shape, ("data", "model"), device="cpu")
        cell = recsys_train_cell(cfg, m, params=_port_params(
            "deepfm", cfg, params_np))
        data = iter([cell.local_batch({k: torch.from_numpy(v)
                                       for k, v in b.items()})
                     for b in batches[start:]])
        state, hist = fit(cell.state, cell.step, data,
                          LoopConfig(total_steps=total, log_every=1,
                                     **loop), mesh=m, specs=cell.specs)
        return m, cell, state, [h["loss"] for h in hist]

    _, cell, state, losses = run((2, 2), 0, 2, ckpt_every=2,
                                 ckpt_dir=ckpt_dir)
    # the uninterrupted run goes on from the state it has
    data = iter([cell.local_batch({k: torch.from_numpy(v)
                                   for k, v in batches[2].items()})])
    state, hist = fit(state, cell.step, data, LoopConfig(
        total_steps=1, log_every=1), resume=False)
    out["uninterrupted"] = ([t.numpy() for t in tree_leaves(state.params)],
                           losses + [hist[0]["loss"]])
    for shape in ((2, 2), (1, 4), (4, 1)):
        m, cell, state, losses = run(shape, 2, 3, ckpt_dir=ckpt_dir)
        template = TrainState(whole_like(cell.state.params,
                                         cell.specs.params, m),
                              whole_like(cell.state.opt_state,
                                         cell.specs.opt_state, m))
        restored = ckpt_lib.elastic_restore(ckpt_dir, 2, template,
                                            cell.specs, m)
        out[shape] = ([t.numpy() for t in tree_leaves(state.params)],
                      losses, [t.numpy() for t in _state_leaves(restored)],
                      cell.split)
    return out


def _state_leaves(state) -> list:
    """A TrainState's leaves: the params', then adagrad's (``acc``, then
    ``step``)."""
    return tree_leaves(state.params) + tree_leaves(state.opt_state)


def _whole(runs, key, i, split, shape):
    """Leaf ``i`` of ``key``'s run, assembled whole from the ranks of a
    mesh of ``shape`` (a row block from each model index)."""
    if not split[i]:
        return runs[0][key][0][i]
    return np.concatenate([runs[j][key][0][i] for j in range(shape[1])])


def test_elastic_restore_across_meshes_and_one_device(tmp_path):
    """A (2, 2) checkpoint holds whole arrays (equal to one device's
    state within 1e-5 after the same 2 steps); restored on (1, 4), (4,
    1) each rank holds its block of them, bit for bit, and on one
    device the whole; a step after each restore within 1e-5 of the
    uninterrupted run's; the same-mesh resume bit-identical to it."""
    from repro_torch.launch.train import RECSYS_OPTIMIZER, recsys_setup
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train.optimizer import TrainState
    from repro_torch.launch.cells import recsys_model
    arch = "deepfm"
    _, cfg = _cfgs(arch)
    batches = _batches(arch, cfg)
    p0 = tree_map(lambda t: t.numpy(), recsys_model(cfg, "cpu").init(
        torch.Generator().manual_seed(0)))
    ckpt_dir = str(tmp_path / "ckpt")
    res = spawn(_elastic_body, 4, args=(ckpt_dir, ARCHS[arch], p0, batches),
                store_dir=str(tmp_path), timeout_s=TIMEOUT)
    assert ckpt_lib.list_steps(ckpt_dir) == [2]
    # one device: the same 2 steps, then the checkpoint restored
    _, _, step, _ = recsys_setup(cfg, BATCH, device="cpu")
    single = TrainState.create(RECSYS_OPTIMIZER,
                               _port_params(arch, cfg, p0))
    tb = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
    for b in tb[:2]:
        single, _ = step(single, b)
    restored = ckpt_lib.elastic_restore(ckpt_dir, 2, single)
    for got, want in zip(_state_leaves(restored), _state_leaves(single),
                         strict=True):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL,
                                   atol=TOL)
    whole_ckpt = [t.numpy().copy() for t in _state_leaves(restored)]
    restored, m3 = step(restored, tb[2])
    split = res[0][(2, 2)][3]
    n_params = len(split)
    unint = [_whole(res, "uninterrupted", i, split, (2, 2))
             for i in range(n_params)]
    loss3 = res[0]["uninterrupted"][1][2]
    np.testing.assert_allclose(float(m3["loss"]), loss3, rtol=TOL, atol=TOL)
    for got, want in zip(tree_leaves(restored.params), unint, strict=True):
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    for rank, out in enumerate(res):
        # the same mesh: bit for bit
        for got, want in zip(out[(2, 2)][0], out["uninterrupted"][0],
                             strict=True):
            np.testing.assert_array_equal(got, want)
        assert out[(2, 2)][1] == [loss3]
        for shape in ((1, 4), (4, 1)):
            params, losses, blocks, cut = out[shape]
            flags = cut + cut + [False]          # params, acc, step
            for got, whole, c in zip(blocks, whole_ckpt, flags,
                                     strict=True):
                np.testing.assert_array_equal(
                    got, _block(whole, c, rank, shape))
            np.testing.assert_allclose(losses, [loss3], rtol=TOL, atol=TOL)
    for shape in ((1, 4), (4, 1)):
        split = res[0][shape][3]
        for i, want in enumerate(unint):
            np.testing.assert_allclose(_whole(res, shape, i, split, shape),
                                       want, rtol=TOL, atol=TOL)


def _cli_body(rank, cfg_kw_unused, argvs):
    """``launch.train``'s CLI on this rank, once per argv: ``--mesh``
    joins the group the rank is in.  Each run's losses, and the shape of
    the first run's field-0 table."""
    from repro_torch.launch import train as train_cli
    runs = [train_cli.main(argv) for argv in argvs]
    return [[h["loss"] for h in run.history] for run in runs], str(
        runs[0].state.params["fields"]["f0"]["emb"].shape)


def test_train_cli_on_a_mesh_and_its_refusals(tmp_path, capsys):
    """``train --mesh data=2,model=2`` on 4 CPU ranks: every rank's losses
    within 1e-5 of one device's ``train``, for deepfm (its 50,000-row
    field held as 25,000-row blocks), for an LM arch (stablelm-3b,
    through ``lm_train_cell``) and for MACE (through ``mace_cell``, 8
    molecules a batch).  A mesh without ``model`` and a world of the
    wrong size are refused."""
    from repro_torch.launch import train as train_cli
    mesh = ["--device", "cpu", "--steps", "3", "--log-every", "1",
            "--mesh", "data=2,model=2", "--dist-backend", "gloo"]
    argvs = [["--arch", "deepfm", "--batch", "32"] + mesh,
             ["--arch", "stablelm-3b", "--batch", "4", "--seq", "16"] + mesh,
             ["--arch", "mace", "--batch", "8"] + mesh]
    res = spawn(_cli_body, 4, args=(None, argvs), store_dir=str(tmp_path),
                timeout_s=TIMEOUT)
    want = [[h["loss"] for h in train_cli.train(
        arch, steps=3, batch=batch, seq=16, log_every=1,
        device="cpu").history]
        for arch, batch in (("deepfm", 32), ("stablelm-3b", 4),
                            ("mace", 8))]
    for losses, shape in res:
        for got, w in zip(losses, want, strict=True):
            np.testing.assert_allclose(got, w, rtol=TOL, atol=TOL)
        assert shape == "torch.Size([25000, 10])"
    for arch, mesh, msg in (
            ("mace", "data=2,model=2", "needs 4 ranks, found 1"),
            ("deepfm", "data=4", "no 'model' axis"),
            ("deepfm", "data=2,model=2", "needs 4 ranks, found 1"),
            ("stablelm-3b", "data=2,model=2", "needs 4 ranks, found 1")):
        with pytest.raises(SystemExit):
            train_cli.main(["--arch", arch, "--device", "cpu", "--mesh",
                            mesh, "--dist-backend", "gloo"])
        assert msg in capsys.readouterr().err
