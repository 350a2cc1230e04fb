"""The port's MACE training cell on a mesh against the JAX package, on the
CPU.

``sharding/rules.py::gnn_param_rules`` and ``gnn_graph_spec``,
``models/gnn/mace.py``'s ``apply``/``energy_loss``/``node_class_loss``
with ``mesh=`` (the node irreps all-gathered, each rank's block of the
receiver sums, the losses summed over every rank),
``launch/cells.py::mace_cell`` (nodes and edges split over every axis,
the padding of ``pad_graph``, channel blocks gathered over ``model``,
adam on the blocks).  The ranks are gloo processes on the CPU
(``launch.mesh.spawn``), one group of 4 running every case on a (2, 2)
and a (1, 4) mesh.  Each step is held to the JAX cell's own ``fn``
(``mace_cell(...).fn``, jitted at XLA's optimisation level 0) on one
CPU device (a (1, 1) ``jax.make_mesh``): JAX draws the params and
adam's state, which cross as numpy arrays (``convert.py``).  Bars:

* the param spec trees equal to ``tuple(P)`` of JAX's
  ``gnn_param_rules`` (smoke and ``CONFIG``, with and without a feature
  projection, channels that divide over ``model`` and that do not),
  ``gnn_graph_spec`` equal to JAX's;
* ``pad_graph``'s padding, whole graphs with and without a label mask;
* one adam step (lr 1e-3, global-norm clip 1.0) on a molecule batch
  (energy), a full graph with features, every node labelled, and a
  ``NeighborSampler`` subgraph (node classes, the loss masked to the
  seeds), none of whose N or E divides by 4, so both are padded: losses and metrics within
  1e-5, every param within 1e-5 of JAX's step but where adam's first
  step divides a gradient near zero by its own size plus eps: there
  the energy case holds elements of |g| < 1e-6 within 2·lr (the bar of
  ``tests/test_torch_lm_mesh.py``) and the node-class cases those of a
  clipped |g| below 1e-7 within lr (``tests/test_torch_gnn_train.py``,
  ROADMAP.md §3 fact 4);
* planted: a receiver sum keeping the next rank's node block, and a
  padded node that adds into graph 0's energy, each move the loss past
  the bar; ``ogb_products`` is refused, naming its bytes.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeSpec as JaxShapeSpec
from repro.configs.registry import get_arch as jax_get_arch
from repro.launch import cells as jax_cells
from repro.models.gnn.mace import MACE as JaxMACE
from repro.sharding import rules as jax_rules
from repro.train import optimizer as jax_opt
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch.mesh import spawn
from repro_torch.sharding import rules

TOL = 1e-5
TIMEOUT = 180.0
LR = 1e-3
MESHES = ((2, 2), (1, 4))
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
CASES = ("molecule", "full_graph", "minibatch")
PLANT_MESH = (2, 2)


class _ShapeOnlyMesh:
    def __init__(self, data, model):
        self.shape = {"data": data, "model": model}


# ----------------------------------------------------------------------
# specs, no ranks
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n_feat", [None, 24])
@pytest.mark.parametrize("model", [1, 2, 3, 4])
@pytest.mark.parametrize("size", ["smoke", "full"])
def test_gnn_param_rules_equal_jax(size, model, n_feat):
    """Channels over ``model`` where ``d_hidden`` divides (16 and 128 on
    2 and 4), whole on 3; the radial and readout MLPs and
    ``feat_proj/b`` replicated."""
    _, jcfg = jax_get_arch("mace", smoke=size == "smoke")
    _, cfg = get_arch("mace", smoke=size == "smoke")
    m = _ShapeOnlyMesh(2, model)
    jparams = jax.eval_shape(lambda k: JaxMACE(jcfg).init(k, n_feat=n_feat),
                             jax.random.PRNGKey(0))
    want = jax.tree.map(tuple, jax_rules.spec_tree(
        jparams, jax_rules.gnn_param_rules(jcfg, m)),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    params = jax.tree.map(lambda s: torch.empty(s.shape, device="meta"),
                          jparams)
    got = rules.spec_tree(params, rules.gnn_param_rules(cfg, m))
    assert got == want
    split = any(rules.splits(sp, m) for sp in rules.spec_leaves(got))
    assert split == (model in (2, 4))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_gnn_graph_spec_equals_jax(multi_pod):
    want = jax_rules.gnn_graph_spec(multi_pod)
    got = rules.gnn_graph_spec(multi_pod)
    assert set(got) == set(want)
    for k, spec in got.items():
        assert spec == (None if want[k] is None else tuple(want[k])), k


def test_ogb_products_is_refused_with_its_bytes():
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.launch.cells import mace_cell
    _, cfg = get_arch("mace", smoke=False)
    shape = next(s for s in GNN_SHAPES if s.name == "ogb_products")
    with pytest.raises(ValueError, match=r"285 GB and w_r \(E, C·15\) "
                                         r"475 GB"):
        mace_cell(cfg, shape, _ShapeOnlyMesh(2, 2))


@pytest.mark.parametrize("task", ["energy", "node_class"])
def test_pad_graph_pads_nodes_and_edges_that_change_nothing(task):
    """Padded edges are (0, 0) self-loops; padded nodes sit at the origin
    with species 0, no label (a node-class graph without a mask gets
    ones for its own nodes) and, for the energy, the graph id n_graphs;
    the real nodes and edges are kept as they were."""
    from repro_torch.data import graph
    from repro_torch.launch.cells import pad_graph
    if task == "energy":
        g = graph.molecule_batch(n_graphs=3, n_atoms=5, n_edges=9,
                                 n_species=10, seed=1)
    else:
        g = graph.random_graph(38, 101, 8, n_classes=4, seed=2)
    p = pad_graph(g, 4, task)
    n, e = len(g["positions"]), g["edge_index"].shape[1]
    assert p["positions"].shape[0] == -(-n // 4) * 4
    assert p["edge_index"].shape[1] == -(-e // 4) * 4
    assert not p["edge_index"][:, e:].any()
    assert not p["positions"][n:].any() and not p["species"][n:].any()
    for k, v in g.items():
        if k != "n_graphs":
            np.testing.assert_array_equal(
                p[k][:, :e] if k == "edge_index" else p[k][:n], v)
    if task == "energy":
        assert (p["graph_id"][n:] == 3).all() and p["n_graphs"] == 3
    else:
        assert "label_mask" not in g
        np.testing.assert_array_equal(p["label_mask"].numpy(),
                                      [1.0] * n + [0.0] * (len(p["labels"])
                                                           - n))


# ----------------------------------------------------------------------
# one step on gloo ranks against JAX's cell on one device
# ----------------------------------------------------------------------

def _graphs(cfg):
    """case -> (the whole graph as numpy, the JAX shape, the port's shape)
    of each case; no N or E divides by 4."""
    from repro_torch.data import graph
    from repro_torch.launch.cells import sampled_graph
    mol = graph.molecule_batch(n_graphs=3, n_atoms=5, n_edges=9,
                               n_species=cfg.num_species, seed=1)
    g = graph.random_graph(300, 2400, 8, n_classes=cfg.d_readout, seed=0)
    sampler = graph.NeighborSampler(
        graph.CSRGraph.from_edge_index(g["edge_index"], 300), (3, 2), seed=1)
    sub = sampled_graph(g, sampler.sample(np.arange(15)))
    n, e = len(sub["positions"]), sub["edge_index"].shape[1]
    # a whole graph of the sample's sizes, every node labelled: JAX
    # compiles one program for both node-class cases
    full = graph.random_graph(n, e, 8, n_classes=cfg.d_readout, seed=2)
    full["label_mask"] = np.ones(n, np.float32)
    out = {}
    for name, gr, kw in (
            ("molecule", mol, dict(kind="graph_batched", n_nodes=5,
                                   n_edges=9, batch_graphs=3)),
            ("full_graph", full, dict(kind="graph_full", n_nodes=n,
                                      n_edges=e, d_feat=8)),
            ("minibatch", sub, dict(kind="graph_full", n_nodes=n,
                                    n_edges=e, d_feat=8))):
        assert len(gr["positions"]) % 4 and gr["edge_index"].shape[1] % 4
        out[name] = (gr, JaxShapeSpec(name, **kw), ShapeSpec(name, **kw))
    return out


def _fast(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE)(
        *args)


_PROGRAMS = {}


def _compiled(fn, kind, state, g):
    """The JAX cell's step compiled once a task and graph shape (a cell's
    fn differs only in what the shape names)."""
    key = (kind, tuple((k, v.shape) for k, v in sorted(g.items())))
    if key not in _PROGRAMS:
        _PROGRAMS[key] = jax.jit(fn).lower(state, g).compile(
            compiler_options=FAST_COMPILE)
    return _PROGRAMS[key]


@functools.lru_cache(maxsize=None)
def _jax_init(jcfg, d_feat):
    """JAX's initial train state (params from key 0, adam's zeros)."""
    ocfg = jax_opt.OptimizerConfig(kind="adam", lr=LR)
    return _fast(lambda k: jax_opt.TrainState.create(
        ocfg, JaxMACE(jcfg).init(k, n_feat=d_feat)), jax.random.PRNGKey(0))


def _jax_case(jcfg, jshape, gr):
    """JAX's cell on one device: (its initial params, the params after one
    step, the metrics, the step's clipped gradient leaves, read back from
    adam's first moment m = (1 - b1)·g), numpy."""
    jmesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(
        jax.sharding.AxisType.Auto,) * 2)
    cell = jax_cells.mace_cell("mace", jcfg, jshape, jmesh, False)
    state = _jax_init(jcfg, jshape.d_feat or None)
    g = {k: jnp.asarray(v) for k, v in gr.items() if k != "n_graphs"}
    new, metrics = _compiled(cell.fn, jshape.kind, state, g)(state, g)
    b1 = jax_opt.OptimizerConfig().b1
    return (jax.tree.map(np.asarray, state.params),
            [np.asarray(x) for x in jax.tree.leaves(new.params)],
            {k: float(v) for k, v in metrics.items()},
            [np.asarray(x) / (1 - b1)
             for x in jax.tree.leaves(new.opt_state["m"])])


def _roll_block(psum_scatter):
    """A receiver sum that keeps the next rank's node block: the partial
    sums rolled up by one block before the reduce-scatter."""
    from repro_torch.sharding.collectives import axes_size

    def wrong(x, mesh, axes, dim=0):
        step = x.shape[dim] // axes_size(mesh, axes)
        return psum_scatter(torch.roll(x, -step, dims=dim), mesh, axes, dim)
    return wrong


def _mace_body(rank, cases):
    """Every case on this rank, on each mesh: one step's metrics and its
    whole params after (the channel blocks gathered), then the planted
    faults' losses."""
    from repro_torch.core.schemes.base import tree_leaves
    from repro_torch.convert import mace_params_from_numpy
    from repro_torch.launch import cells
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.gnn import mace
    _, cfg = get_arch("mace", smoke=True)
    out = {}
    for shape in MESHES:
        m = make_debug_mesh(*shape, device="cpu")
        res = out[shape] = {}
        for name, (gr, pshape, params_np) in cases.items():
            def params():
                # fresh tensors: a cell's step updates its replicated
                # leaves in place
                return mace_params_from_numpy(params_np, mace.MACE(
                    cfg, device="cpu"), "cpu")
            cell = cells.mace_cell(cfg, pshape, m, params=params())
            g = cell.local_graph(gr)
            state, metrics = cell.step(cell.state, g)
            with torch.no_grad():
                whole = cell.whole_params(state.params)
            res[name] = {"metrics": {k: float(v) for k, v in
                                     metrics.items()},
                         "params": [t.numpy() for t in tree_leaves(whole)],
                         "n_local": g["positions"].shape[0]}
            if shape != PLANT_MESH:
                continue
            # planted faults, forward only, from the first step's params
            fresh = cells.mace_cell(cfg, pshape, m, params=params())
            sound = mace.psum_scatter
            mace.psum_scatter = _roll_block(sound)
            try:
                with torch.no_grad():
                    res[name]["wrong_block"] = float(fresh.loss(
                        fresh.state.params, g)[0])
            finally:
                mace.psum_scatter = sound
            if name == "molecule":
                pad = cells.pad_graph

                def into_graph0(graph, multiple, task):
                    n = len(graph["positions"])
                    padded = pad(graph, multiple, task)
                    padded["graph_id"][n:] = 0
                    return padded
                cells.pad_graph = into_graph0
                try:
                    with torch.no_grad():
                        res[name]["pad_in_energy"] = float(fresh.loss(
                            fresh.state.params, fresh.local_graph(gr))[0])
                finally:
                    cells.pad_graph = pad
    return out


@pytest.fixture(scope="module")
def mace_run(tmp_path_factory):
    """(JAX's reference of every case, every rank's results)."""
    jcfg = jax_get_arch("mace", smoke=True)[1]
    _, cfg = get_arch("mace", smoke=True)
    refs, cases = {}, {}
    for name, (gr, jshape, pshape) in _graphs(cfg).items():
        refs[name] = _jax_case(jcfg, jshape, gr)
        cases[name] = (gr, pshape, refs[name][0])
    ranks = spawn(_mace_body, 4, args=(cases,),
                  store_dir=str(tmp_path_factory.mktemp("mace_mesh")),
                  timeout_s=TIMEOUT)
    return refs, ranks


def _tiny(name, grads):
    """Adam's ill-conditioned elements of the case's first step (``grads``
    clipped) that are not 0 (exact zeros, the paths layer 0's l = 0
    input cannot feed, update by exactly 0 in both): |g| < 1e-6 for the
    energy, held at 2·lr (a third of the smoke config's elements: its
    energy gradients are small); for node classes a |g| below 1e-7 of
    the global norm (at least 1), held at lr, and fewer than 2% of the
    elements."""
    if name == "molecule":
        return [(g != 0) & (np.abs(g) < 1e-6) for g in grads], 2 * LR
    norm = max(float(np.sqrt(sum(np.sum(np.square(g)) for g in grads))), 1.0)
    return [(g != 0) & (np.abs(g) / norm < 1e-7) for g in grads], LR


@pytest.mark.parametrize("shape", MESHES, ids=["2x2", "1x4"])
@pytest.mark.parametrize("case", CASES)
def test_one_step_matches_jax_cell(mace_run, case, shape):
    """Every rank's metrics within 1e-5 of the JAX cell's, every param
    (gathered whole) within 1e-5 of its step but adam's ill-conditioned
    elements (:func:`_tiny`), and the step moved the params; the graph's
    padding split evenly over the 4 ranks."""
    refs, ranks = mace_run
    p0, want, metrics, grads = refs[case]
    tiny, held = _tiny(case, grads)
    if case != "molecule":
        assert sum(t.sum() for t in tiny) < 0.02 * sum(t.size for t in tiny)
    for r in ranks:
        got = r[shape][case]
        assert set(got["metrics"]) == set(metrics)
        for k, v in metrics.items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=TOL,
                                       atol=TOL)
        assert len(got["params"]) == len(want)
        for a, b, t in zip(got["params"], want, tiny):
            np.testing.assert_allclose(a[~t], b[~t], rtol=TOL, atol=TOL)
            assert np.all(np.abs(a[t] - b[t]) <= held)
    moved = max(float(np.abs(w - a).max()) for w, a in
                zip(want, jax.tree.leaves(p0)))
    assert moved > 1e-4


@pytest.mark.parametrize("case", CASES)
def test_planted_wrong_receiver_block_fails(mace_run, case):
    """On (2, 2): each rank keeping the next rank's block of the receiver
    sums moves the loss past the bar."""
    refs, ranks = mace_run
    want = refs[case][2]["loss"]
    for r in ranks:
        got = r[PLANT_MESH][case]["wrong_block"]
        assert abs(got - want) > 100 * TOL * max(1.0, abs(want))


def test_planted_padded_node_in_energy_fails(mace_run):
    """On (2, 2): the molecule batch's 15 nodes pad to 16, and its padded
    node added into graph 0's energy moves the loss past the bar (the
    sound padding held it within the bar above)."""
    refs, ranks = mace_run
    want = refs["molecule"][2]["loss"]
    for r in ranks:
        got = r[PLANT_MESH]["molecule"]["pad_in_energy"]
        assert abs(got - want) > 100 * TOL
