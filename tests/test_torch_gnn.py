"""The port's GNN family (MACE) against the JAX package, on the CPU.

Smoke config, tiny graphs, inputs from numpy seeds.  The bars:

* ``so3``: ``real_cg`` and ``coupling_table`` bit-identical to JAX's;
  ``spherical_harmonics`` and ``bessel_basis`` within 1e-6, the basis
  zero at and past ``r_cut``;
* ``data/graph.py``: ``molecule_batch``, ``random_graph``, ``CSRGraph``
  and ``NeighborSampler.sample`` bit-identical to JAX's, dtypes too;
* ``MACE.apply`` (``node_out``, ``energy``), both losses, ``acc`` and
  the gradient of both losses within 1e-5 of JAX's (jitted once per
  module), JAX's params carried across by
  ``convert.mace_params_from_numpy``;
* the registry's cells, ``mace_model_flops`` and the shapes'
  resolution equal to JAX's;
* E(3): energy unchanged under a rotation (JAX's own bar: rtol 1e-3,
  atol 1e-4) and a translation, ``node_out`` permutation-equivariant;
  on a graph padded with self-loops the same rotation check fails with
  the edge mask planted away;
* ``serve --arch mace`` and ``embedding_config_of_arch("gnn", ...)``
  refuse with their reasons.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.data import graph as jax_graph
from repro.launch.cells import mace_model_flops as jax_mace_flops
from repro.models.gnn import so3 as jax_so3
from repro.models.gnn.mace import MACE as JaxMACE
from repro.models.gnn.mace import bessel_basis as jax_bessel
from repro_torch.configs import get_arch, registry
from repro_torch.configs.base import GNN_SHAPES
from repro_torch.convert import mace_params_from_numpy
from repro_torch.core.schemes.base import tree_leaves
from repro_torch.data import graph
from repro_torch.launch import serve
from repro_torch.launch.cells import mace_model_flops, mace_shape
from repro_torch.launch.engine import embedding_config_of_arch
from repro_torch.models.gnn import so3
from repro_torch.models.gnn.mace import (MACE, bessel_basis, gather_rows,
                                         segment_sum)

TOL = 1e-5
N_FEAT = 8
# XLA's CPU backend at optimisation level 0: the reference compiles in
# about half the time, the same program within float32 rounding
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _close(got, want, tol=TOL):
    if isinstance(got, torch.Tensor):
        got = got.detach()
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _graph(n=12, e=30, n_species=10, seed=0, d_feat=0, n_graphs=1):
    """The JAX tests' random graph (numpy): positions spread by 2, random
    directed edges (self-loops among them), ``n_graphs`` graphs of
    consecutive nodes, labels and a label mask."""
    rng = np.random.default_rng(seed)
    g = {
        "positions": (rng.normal(size=(n, 3)) * 2).astype(np.float32),
        "edge_index": np.stack([rng.integers(0, n, e),
                                rng.integers(0, n, e)]).astype(np.int32),
        "species": rng.integers(0, n_species, n).astype(np.int32),
        "graph_id": np.minimum(np.arange(n) * n_graphs // n,
                               n_graphs - 1).astype(np.int32),
        "n_graphs": n_graphs,
        "energy": rng.normal(size=n_graphs).astype(np.float32),
        "labels": rng.integers(0, 4, n).astype(np.int32),
        "label_mask": (rng.random(n) < 0.7).astype(np.float32),
    }
    if d_feat:
        g["node_feats"] = rng.normal(size=(n, d_feat)).astype(np.float32)
    return g


def _torch(g):
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in g.items()}


def _jax(g):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in g.items()}


class Pair:
    """The smoke config in both packages, JAX's params (with a feature
    projection) carried across, one graph, and JAX's results on it,
    each compiled once."""

    def __init__(self):
        self.jcfg = jax_registry.get_arch("mace", smoke=True)[1]
        self.cfg = get_arch("mace", smoke=True)[1]
        self.jm = JaxMACE(self.jcfg)
        self.model = MACE(self.cfg, device="cpu")
        key = jax.random.PRNGKey(0)
        init = jax.jit(lambda k: self.jm.init(k, n_feat=N_FEAT))
        self.jparams = init.lower(key).compile(
            compiler_options=FAST_COMPILE)(key)
        self.np_params = jax.tree.map(np.asarray, self.jparams)
        self.g = _graph(n=14, e=40, n_species=self.cfg.num_species,
                        d_feat=N_FEAT, n_graphs=2)
        n_graphs = self.g["n_graphs"]
        jg = _jax({k: v for k, v in self.g.items() if k != "n_graphs"})

        def reference(p, g):
            g = dict(g, n_graphs=n_graphs)
            out = self.jm.apply(p, g)
            (el, em), eg = jax.value_and_grad(self.jm.energy_loss,
                                              has_aux=True)(p, g)
            (nl, nm), ng = jax.value_and_grad(self.jm.node_class_loss,
                                              has_aux=True)(p, g)
            return out, (el, em, eg), (nl, nm, ng)
        self.ref = jax.jit(reference).lower(self.jparams, jg).compile(
            compiler_options=FAST_COMPILE)(self.jparams, jg)

    def params(self):
        return mace_params_from_numpy(self.np_params, self.model, "cpu")


@pytest.fixture(scope="module")
def pair():
    return Pair()


def _grads(loss_fn, params, g):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = loss_fn(params, g)
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    return loss, metrics, grads


# ----------------------------------------------------------------------
# so3
# ----------------------------------------------------------------------

def test_real_cg_and_coupling_table_bit_identical_to_jax():
    for l1 in range(3):
        for l2 in range(3):
            for l3 in range(abs(l1 - l2), l1 + l2 + 1):
                got, want = so3.real_cg(l1, l2, l3), jax_so3.real_cg(l1, l2,
                                                                     l3)
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
    for l_max in (1, 2, 3):
        got, want = so3.coupling_table(l_max), jax_so3.coupling_table(l_max)
        assert [p[:3] for p in got] == [p[:3] for p in want]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a[3], b[3])
        np.testing.assert_array_equal(so3.dense_coupling(l_max),
                                      jax_so3.dense_coupling(l_max))
        assert so3.irrep_slices(l_max) == jax_so3.irrep_slices(l_max)
        assert so3.num_sh(l_max) == jax_so3.num_sh(l_max)
    np.testing.assert_array_equal(so3.real_unitary(2),
                                  jax_so3.real_unitary(2))
    assert so3.cg_complex(1, 0, 1, 0, 2, 0) == jax_so3.cg_complex(1, 0, 1, 0,
                                                                  2, 0)


@pytest.mark.parametrize("l_max", [0, 1, 2])
def test_spherical_harmonics_match_jax(l_max):
    rng = np.random.default_rng(l_max)
    v = (rng.normal(size=(500, 3)) * 3).astype(np.float32)
    v[:3] = 0.0                                  # self-loop edges: r = 0
    got = so3.spherical_harmonics(l_max, torch.from_numpy(v))
    want = jax_so3.spherical_harmonics(l_max, jnp.asarray(v))
    assert got.shape == (500, (l_max + 1) ** 2) and got.dtype == torch.float32
    _close(got, want, 1e-6)
    with pytest.raises(NotImplementedError, match="l_max <= 2"):
        so3.spherical_harmonics(3, torch.from_numpy(v))


def test_wigner_d_rotates_the_harmonics():
    """D(R) from the port's harmonics is orthogonal and maps Y(r) to
    Y(R r) at fresh directions, for each l."""
    rot = _rotation()
    v = np.random.default_rng(9).normal(size=(50, 3))
    for l in (1, 2):
        d = so3.wigner_d_from_rotation(l, rot)
        np.testing.assert_allclose(d @ d.T, np.eye(2 * l + 1), atol=1e-8)
        sl = so3.irrep_slices(l)[l]
        y = so3.spherical_harmonics(l, torch.from_numpy(v)).numpy()[:, sl]
        y_rot = so3.spherical_harmonics(
            l, torch.from_numpy(v @ rot.T)).numpy()[:, sl]
        np.testing.assert_allclose(y @ d.T, y_rot, atol=1e-8)


def test_bessel_basis_matches_jax_and_cuts_off():
    r = np.concatenate([np.linspace(0.0, 6.0, 301),
                        [1e-7, 4.99, 5.0, 7.5]]).astype(np.float32)
    got = bessel_basis(torch.from_numpy(r), 8, 5.0)
    want = jax_bessel(jnp.asarray(r), 8, 5.0)
    assert got.shape == (len(r), 8)
    _close(got, want, 1e-6)
    past = torch.from_numpy(r) >= 5.0
    assert float(got[past].abs().max()) < 1e-6     # zero at and past r_cut


# ----------------------------------------------------------------------
# data/graph.py
# ----------------------------------------------------------------------

def _same(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got[k] == want[k], k


def test_molecule_batch_and_random_graph_bit_identical_to_jax():
    kw = dict(n_graphs=5, n_atoms=12, n_edges=24, n_species=7, seed=3)
    _same(graph.molecule_batch(**kw), jax_graph.molecule_batch(**kw))
    _same(graph.random_graph(300, 2000, 16, seed=1),
          jax_graph.random_graph(300, 2000, 16, seed=1))


def test_csr_graph_and_neighbor_sampler_bit_identical_to_jax():
    g = graph.random_graph(500, 4000, 8, seed=2)
    got = graph.CSRGraph.from_edge_index(g["edge_index"], 500)
    want = jax_graph.CSRGraph.from_edge_index(g["edge_index"], 500)
    assert got.n_nodes == want.n_nodes
    for k in ("indptr", "indices"):
        assert getattr(got, k).dtype == getattr(want, k).dtype
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    ours = graph.NeighborSampler(got, (5, 3), seed=4)
    theirs = jax_graph.NeighborSampler(want, (5, 3), seed=4)
    rng = np.random.default_rng(5)
    for _ in range(3):                           # the rng advances alike
        seeds = rng.choice(500, 32, replace=False)
        _same(ours.sample(seeds), theirs.sample(seeds))
    assert graph.sampled_subgraph_sizes(1024, (15, 10)) == \
        jax_graph.sampled_subgraph_sizes(1024, (15, 10)) == (169984, 168960)


# ----------------------------------------------------------------------
# the model against JAX
# ----------------------------------------------------------------------

def test_params_carried_across_and_refused_when_wrong(pair):
    params = pair.params()
    assert [tuple(t.shape) for t in tree_leaves(params)] == \
        [tuple(a.shape) for a in jax.tree.leaves(pair.np_params)]
    bad = jax.tree.map(np.asarray, pair.jparams)
    bad["layers"][1]["u2"] = bad["layers"][1]["u2"][:, :-1]
    with pytest.raises(ValueError, match="u2"):
        mace_params_from_numpy(bad, pair.model, "cpu")
    with pytest.raises(ValueError, match="layers"):
        mace_params_from_numpy(dict(pair.np_params, layers=[]), pair.model,
                               "cpu")
    proj = dict(pair.np_params["feat_proj"], b=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="feat_proj"):
        mace_params_from_numpy(dict(pair.np_params, feat_proj=proj),
                               pair.model, "cpu")


def test_apply_matches_jax(pair):
    out = pair.model.apply(pair.params(), _torch(pair.g))
    want = pair.ref[0]
    assert out["node_out"].shape == (14, pair.cfg.d_readout)
    assert out["energy"].shape == (2,)
    _close(out["node_out"], want["node_out"])
    _close(out["energy"], want["energy"])


@pytest.mark.parametrize("loss", ["energy_loss", "node_class_loss"])
def test_losses_and_grads_match_jax(pair, loss):
    params = pair.params()
    got_loss, got_m, grads = _grads(getattr(pair.model, loss), params,
                                    _torch(pair.g))
    want_loss, want_m, want_g = pair.ref[1 if loss == "energy_loss" else 2]
    _close(got_loss, want_loss)
    assert set(got_m) == set(want_m)
    for k in want_m:
        _close(got_m[k], want_m[k])
    want_leaves = jax.tree.leaves(want_g)
    assert len(grads) == len(want_leaves)
    for g, w in zip(grads, want_leaves):
        _close(g, w)
    assert max(float(g.abs().max()) for g in grads) > 1e-3   # not vacuous


def test_node_class_loss_without_a_mask_and_acc_bounds(pair):
    g = _torch(pair.g)
    del g["label_mask"]
    loss, m = pair.model.node_class_loss(pair.params(), g)
    assert torch.isfinite(loss) and 0.0 <= float(m["acc"]) <= 1.0


def test_segment_sum_and_gather_rows_repeat_and_refuse_out_of_range_ids():
    rng = np.random.default_rng(6)
    data = rng.normal(size=(50, 3, 4)).astype(np.float32)
    ids = rng.integers(0, 7, 50).astype(np.int32)
    got = segment_sum(torch.from_numpy(data), torch.from_numpy(ids), 9)
    _close(got, jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(ids),
                                    num_segments=9))
    assert float(got[7:].abs().max()) == 0.0
    # the same bits twice, the sum and the gather's backward (both add
    # in id order on the CPU, where index_put_'s accumulation does not)
    gen = torch.Generator().manual_seed(0)
    big = torch.randn((100_000, 4, 9), generator=gen)
    idx = torch.randint(0, 300, (100_000,))
    assert torch.equal(segment_sum(big, idx, 300), segment_sum(big, idx, 300))
    x = torch.randn((300, 4, 9))

    def grad():
        t = x.clone().requires_grad_(True)
        return torch.autograd.grad((gather_rows(t, idx) * big).sum(), t)[0]
    assert torch.equal(grad(), grad())
    torch.testing.assert_close(gather_rows(x, idx), x[idx], rtol=0, atol=0)
    # JAX drops out-of-range ids; the port raises (no silent clamp)
    with pytest.raises(RuntimeError, match="out of bounds"):
        segment_sum(torch.from_numpy(data), torch.full((50,), 9), 9)
    with pytest.raises(IndexError, match="out of range"):
        gather_rows(torch.from_numpy(data), torch.full((5,), 50))


# ----------------------------------------------------------------------
# registry and cells
# ----------------------------------------------------------------------

def test_registry_cells_equal_jax():
    def cells(mod):
        return [(a, dataclasses.asdict(s), skip)
                for a, s, skip in mod.all_cells(include_skipped=True)]
    ours = cells(registry)
    assert ours == cells(jax_registry)
    assert len(ours) == 40 and sum(s is None for *_, s in ours) == 38
    assert registry.get_arch("mace")[0] == "gnn"
    assert [dataclasses.asdict(s) for s in registry.shapes_for("mace")] == \
        [dataclasses.asdict(s) for s in jax_registry.shapes_for("mace")]
    with pytest.raises(KeyError, match="unknown arch"):
        registry.get_arch("no-such-arch")


@pytest.mark.parametrize("name", [s.name for s in GNN_SHAPES])
def test_mace_flops_and_shape_resolution_match_jax(name):
    shape = next(s for s in GNN_SHAPES if s.name == name)
    n, e, d_feat, task, n_graphs = mace_shape(shape)
    want = {"full_graph_sm": (2708, 10556, 1433, "node_class", 0),
            "minibatch_lg": (169984, 168960, 128, "node_class", 0),
            "ogb_products": (2449029, 61859140, 100, "node_class", 0),
            "molecule": (3840, 8192, 0, "energy", 128)}[name]
    assert (n, e, d_feat, task, n_graphs) == want
    for cfg_smoke in (False, True):
        cfg = get_arch("mace", smoke=cfg_smoke)[1]
        jcfg = jax_registry.get_arch("mace", smoke=cfg_smoke)[1]
        for train in (False, True):
            assert mace_model_flops(cfg, n, e, train) == \
                jax_mace_flops(jcfg, n, e, train)


# ----------------------------------------------------------------------
# E(3) and the edge mask
# ----------------------------------------------------------------------

def _rotation():
    a, b = 0.7, -1.2
    rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                   [0, 0, 1]])
    rx = np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)],
                   [0, np.sin(b), np.cos(b)]])
    return rz @ rx


def _self_loop_padded(g):
    """``g`` with one self-loop per node appended, as
    ``NeighborSampler`` pads degree-0 nodes."""
    n = len(g["positions"])
    loops = np.stack([np.arange(n), np.arange(n)]).astype(np.int32)
    return dict(g, edge_index=np.concatenate([g["edge_index"], loops], 1))


def _rotation_gap(model, params, g):
    """Largest |E(R x) - E(x)| less JAX's bar (atol 1e-4 + rtol 1e-3
    |E(x)|): <= 0 where the energy is invariant."""
    rot = _rotation().astype(np.float32)
    e1 = model.apply(params, _torch(g))["energy"]
    e2 = model.apply(params, _torch(dict(
        g, positions=g["positions"] @ rot.T)))["energy"]
    return float(((e1 - e2).abs() - (1e-4 + 1e-3 * e1.abs())).max())


def test_energy_invariant_under_rotation_and_translation(pair):
    params = pair.params()
    g = _graph(n_species=pair.cfg.num_species, d_feat=N_FEAT)
    assert _rotation_gap(pair.model, params, g) <= 0
    e1 = pair.model.apply(params, _torch(g))["energy"]
    moved = dict(g, positions=g["positions"] + np.float32([[5.0, -3.0, 1.0]]))
    e2 = pair.model.apply(params, _torch(moved))["energy"]
    torch.testing.assert_close(e2, e1, rtol=1e-4, atol=1e-6)


def test_node_out_permutation_equivariant(pair):
    params = pair.params()
    g = _graph(n=10, e=20, n_species=pair.cfg.num_species, d_feat=N_FEAT)
    perm = np.random.default_rng(3).permutation(10)
    inv = np.argsort(perm)
    g2 = dict(g, positions=g["positions"][perm], species=g["species"][perm],
              node_feats=g["node_feats"][perm],
              edge_index=inv[g["edge_index"]].astype(np.int32))
    out1 = pair.model.apply(params, _torch(g))["node_out"]
    out2 = pair.model.apply(params, _torch(g2))["node_out"]
    torch.testing.assert_close(out2, out1[perm], rtol=1e-3, atol=1e-4)


def test_dropped_edge_mask_fails_rotation_on_self_loops(pair, monkeypatch):
    """A planted fault: with the edge mask always 1, the self-loops'
    Y(0) (a constant, non-rotating l=2 part) enters the A-basis, and the
    energy of a self-loop-padded graph moves under the rotation."""
    params = pair.params()
    g = _self_loop_padded(_graph(n_species=pair.cfg.num_species,
                                 d_feat=N_FEAT))
    assert _rotation_gap(pair.model, params, g) <= 0
    monkeypatch.setattr(MACE, "_edge_mask",
                        lambda self, dist: torch.ones_like(dist))
    assert _rotation_gap(pair.model, params, g) > 0


# ----------------------------------------------------------------------
# refusals
# ----------------------------------------------------------------------

def test_mace_serving_refused_with_its_reasons():
    with pytest.raises(SystemExit, match="no serving path"):
        serve.main(["--arch", "mace", "--device", "cpu"])
    cfg = get_arch("mace")[1]
    with pytest.raises(NotImplementedError, match="no large-vocab"):
        embedding_config_of_arch("gnn", cfg)
    with pytest.raises(NotImplementedError, match="no large-vocab"):
        serve.main(["--arch", "mace", "--engine", "--device", "cpu"])
