"""The port's LM training on a mesh against the JAX package, on the CPU.

``sharding/rules.py``'s LM rules (``lm_param_rules``, ``lm_state_specs``
with ZeRO-1 moments, ``lm_batch_spec``), the tensor-parallel layers of
``models/lm.py``, the vocab-parallel ``chunked_xent``, FSDP, the grouped
MoE dispatch, ``launch/cells.py::lm_train_cell`` (microbatches
included) and checkpoints of an LM on a mesh.  The ranks are gloo
processes on the CPU (``launch.mesh.spawn``), one group for the steps'
cases and one for the resume; JAX runs in this process only, on one
device, and params, batches and references cross as numpy arrays.
Bars:

* specs: the param and optimizer-state spec trees equal to ``tuple(P)``
  of JAX's ``lm_state_specs`` for the five LM archs' ``CONFIG``s and
  smoke configs, at (data, model) = (2, 2) and (2, 4), with
  ``fsdp_params`` and ``attn_kv_repeat`` on and off; the batch spec
  JAX's;
* refusals, each naming the leaf (or the batch) and the sizes: a split
  that does not divide, a split of ``wk`` that cuts heads, a batch
  that does not divide the data axes;
* three steps of ``lm_train_cell`` on a (2, 2) mesh against JAX's own
  ``lm_train_cell`` step run on one device (adamw at lr 3e-4, clip
  1.0; the microbatch scan on a (1, 1) JAX mesh) from the same params on
  the same global
  batches: every step's loss within 1e-5, the first step's gradients
  (every leaf, each rank's ZeRO-1 block, which between the ranks covers
  every element) within 1e-5, and the params after three steps within
  1e-5 — adam's first steps move an element by about lr whatever its
  gradient's size, so an element whose gradient is within float32
  rounding of 0 may move the other way: such elements (|g| < 1e-6 in
  JAX's first step) are held within 2·lr·steps instead.  For the
  ``moe_shard_map`` configs JAX's ``moe_ffn_sharded`` (which needs a
  mesh of devices) is swapped for its single-device twin on the same
  (2, 2) groups (``test_torch_moe_mesh.py::jax_grouped_moe``, held to
  it there);
* replicated leaves bit-identical on every rank that holds the same
  block, after every step;
* ``train`` on the mesh failed at step 3 and resumed bit-identical to an
  uninterrupted mesh run (FSDP, ZeRO-1 and bfloat16 leaves in the
  checkpoint); the checkpoint restored on (1, 4) holds the whole
  arrays' blocks bit for bit and on one device the whole arrays, and a
  step after each matches the uninterrupted run's loss within 1e-5.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.base import ShapeSpec as JaxShapeSpec
from repro.configs.registry import get_arch as jax_get_arch
from repro.launch import cells as jax_cells
from repro.models import lm as jax_lm
from repro.nn import moe as jax_moe
from repro.sharding import rules as jax_rules
from repro.train import optimizer as jax_opt
from repro_torch.configs import get_arch
from repro_torch.launch.mesh import spawn
from repro_torch.sharding import rules
from test_torch_moe_mesh import jax_grouped_moe

TOL = 1e-5
TIMEOUT = 180.0
MESH = (2, 2)                       # (data, model)
B, SEQ, STEPS = 4, 16, 3
LR = 3e-4
# XLA's CPU backend at optimisation level 0: the references compile in
# about half the time, the same program within float32 rounding
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
ARCHS = ["stablelm-3b", "gemma3-4b", "gemma3-27b", "mixtral-8x7b",
         "qwen3-moe-30b-a3b"]
# (arch, config changes, microbatches): every stack layout, both MoE
# strategies and the global MoE formulation, FSDP, remat (the FSDP
# gathers repeated in the recompute), kv repeat and microbatches
CASES = {
    "stablelm": ("stablelm-3b", {}, 1),
    "stablelm-fsdp-remat-mb2": ("stablelm-3b", {"fsdp_params": True,
                                                "remat": True}, 2),
    "qwen3-expert-fsdp": ("qwen3-moe-30b-a3b", {"moe_shard_map": True,
                                                "fsdp_params": True}, 1),
    "qwen3-ffn": ("qwen3-moe-30b-a3b", {"moe_shard_map": True,
                                        "num_experts": 3}, 1),
    "mixtral-mb2": ("mixtral-8x7b", {}, 2),
    "gemma3-27b-kvrep-fsdp-group": ("gemma3-27b", {
        "attn_kv_repeat": True, "fsdp_params": True, "remat": True,
        "remat_granularity": "group"}, 1),
}


class _FakeMesh:
    """What the rules and the cell read of a mesh before any collective:
    axis sizes, names, this rank's coordinates and device."""

    def __init__(self, data, model, coords=(0, 0)):
        self.shape = {"data": data, "model": model}
        self.axis_names = ("data", "model")
        self.device = torch.device("cpu")
        self._coords = dict(zip(self.axis_names, coords))

    def axis_index(self, axis):
        return self._coords[axis]


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE)


def _tup(specs):
    return jax.tree.map(tuple, specs, is_leaf=lambda x: isinstance(x, P))


def _meta(tree):
    return jax.tree.map(lambda s: torch.empty(s.shape, device="meta"), tree)


@functools.lru_cache(maxsize=None)
def _jax_state_shapes(arch, smoke):
    _, jcfg = jax_get_arch(arch, smoke=smoke)
    ocfg = jax_opt.OptimizerConfig(kind="adamw")
    return jax.eval_shape(lambda k: jax_opt.TrainState.create(
        ocfg, jax_lm.model_init(k, jcfg)), jax.random.PRNGKey(0))


# ----------------------------------------------------------------------
# specs and refusals, no ranks
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kv_repeat", [False, True])
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh", [(2, 2), (2, 4)])
@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_specs_equal_jax(arch, size, mesh, fsdp, kv_repeat):
    """Param and adamw-state spec trees equal JAX's (ZeRO-1 moments:
    "data" on their first free dim that divides; ``step`` replicated)."""
    smoke = size == "smoke"
    _, jcfg = jax_get_arch(arch, smoke=smoke)
    jcfg = dataclasses.replace(jcfg, fsdp_params=fsdp,
                               attn_kv_repeat=kv_repeat)
    _, cfg = get_arch(arch, smoke=smoke)
    cfg = dataclasses.replace(cfg, fsdp_params=fsdp,
                              attn_kv_repeat=kv_repeat)
    st = _jax_state_shapes(arch, smoke)
    m = _FakeMesh(*mesh)
    want = jax_rules.lm_state_specs(jcfg, m, st.params, st.opt_state)
    got = rules.lm_state_specs(cfg, m, _meta(st.params),
                               _meta(st.opt_state))
    assert got[0] == _tup(want[0])
    assert got[1] == _tup(want[1])
    if not smoke:            # every registry arch places at (2, 2), (2, 4)
        template, leaves, specs = _meta(st.params), [], []
        rules.map_with_path(lambda path, t: leaves.append((path, t)),
                            template)
        rules.zip_map(lambda t, sp: specs.append(sp), template, got[0])
        for (path, t), spec in zip(leaves, specs, strict=True):
            rules.check_lm_leaf(cfg, m, path, t, spec)


def test_lm_batch_spec_equals_jax():
    for multi_pod in (False, True):
        assert rules.lm_batch_spec(multi_pod) == _tup(
            jax_rules.lm_batch_spec(multi_pod))


def test_a_split_that_does_not_divide_is_refused():
    """A vocabulary of 510 over model = 4: GSPMD would pad the rows; the
    cell names the table and the sizes before it places anything."""
    from repro_torch.launch.cells import lm_train_cell
    _, cfg = get_arch("stablelm-3b", smoke=True)
    cfg = dataclasses.replace(cfg, vocab_size=510, embedding=dataclasses
                              .replace(cfg.embedding, vocab_size=510))
    with pytest.raises(ValueError, match=r"embed/emb: dim 0 of size 510 "
                                         r"does not divide over model = 4"):
        lm_train_cell(cfg, _FakeMesh(1, 4))


def test_a_split_that_cuts_heads_is_refused():
    """A split that cuts heads is placed and gathered, no longer refused.
    qwen3's smoke config has 2 kv heads of 16: ``wk``'s 32 columns
    divide over model = 4, into half heads.  The cell places that split
    as GSPMD does, so that a rank holds JAX's argument bytes on the
    production meshes; the layer gathers the columns over ``model``,
    every rank computes every head's attention (redundantly) and keeps
    its column block of the output for ``wo`` (``models/lm.py::
    _heads_cut``; ``tests/test_torch_build_cell.py`` holds such a step
    to JAX).  With kv repeat the heads stay whole on every rank."""
    from repro_torch.launch.cells import lm_train_cell
    _, cfg = get_arch("qwen3-moe-30b-a3b", smoke=True)
    cell = lm_train_cell(cfg, _FakeMesh(1, 4))
    assert cell.specs.params["layers"]["wk"][-1] == "model"
    assert cell.state.params["layers"]["wk"].shape[-1] == \
        cfg.num_kv_heads * cfg.resolved_head_dim // 4
    cell = lm_train_cell(dataclasses.replace(cfg, attn_kv_repeat=True),
                         _FakeMesh(1, 4))
    assert cell.specs.params["layers"]["wk"] == (None, None, None)


def test_a_batch_that_does_not_divide_the_data_axes_is_refused():
    """One sequence over two data shards is the JAX cell's
    sequence-parallel branch, named; so is a microbatch smaller than the
    data axes."""
    from repro_torch.launch.cells import lm_train_cell
    _, cfg = get_arch("stablelm-3b", smoke=True)
    toks = torch.zeros((1, 8), dtype=torch.int32)
    cell = lm_train_cell(cfg, _FakeMesh(2, 1))
    with pytest.raises(ValueError, match=r"1 rows does not divide into 1 "
                                         r"microbatch\(es\) over 2 data "
                                         r"shard\(s\).*long_500k"):
        cell.local_batch({"tokens": toks, "labels": toks})
    cell = lm_train_cell(cfg, _FakeMesh(2, 1), microbatches=2)
    toks = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="long_500k"):
        cell.local_batch({"tokens": toks, "labels": toks})


# ----------------------------------------------------------------------
# three steps on a (2, 2) mesh against JAX's step on one device
# ----------------------------------------------------------------------

def _batches(vocab):
    rng = np.random.default_rng(11)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, vocab, (B, SEQ + 1))
        out.append({"tokens": toks[:, :-1].astype(np.int32),
                    "labels": toks[:, 1:].astype(np.int32)})
    return out


def _jax_paths(tree) -> dict:
    """{"layers/wq": array, ...} of a JAX tree."""
    return {"/".join(str(k.key) if hasattr(k, "key") else str(k.idx)
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_case(arch, changes, mb):
    """JAX's run of a case: (params as numpy, each step's loss, the first
    step's gradient (the microbatches' mean), the params after
    ``STEPS`` steps).  The step is JAX's ``lm_train_cell``'s: with
    microbatches its scan, on a (1, 1) mesh of this process's one
    device, else ``make_step_fn``'s (the cell's own), compiled once with
    its gradients as an output.  ``moe_ffn_sharded`` is its single-device
    twin on the (2, 2) mesh's groups."""
    _, jcfg = jax_get_arch(arch, smoke=True)
    jcfg = dataclasses.replace(jcfg, **changes)
    key = jax.random.PRNGKey(0)
    params = jax.jit(jax_lm.model_init, static_argnums=1).lower(
        key, jcfg).compile(compiler_options=FAST_COMPILE)(key)
    ocfg = jax_opt.OptimizerConfig(kind="adamw", lr=LR, grad_clip=1.0)
    state = jax_opt.TrainState.create(ocfg, params)
    batches = [{k: jnp.asarray(v) for k, v in b.items()}
               for b in _batches(jcfg.vocab_size)]

    def loss(p, b):
        return jax_lm.loss_fn(p, b, jcfg)

    def step_with_grads(state, batch):
        (_, metrics), g = jax.value_and_grad(loss, has_aux=True)(
            state.params, batch)
        p, o = jax_opt.apply_updates(ocfg, state.params, g,
                                     state.opt_state)
        return jax_opt.TrainState(p, o), metrics, g

    sharded = jax_moe.moe_ffn_sharded
    jax_moe.moe_ffn_sharded = jax_grouped_moe(*MESH)
    try:
        if mb == 1:
            step = _compiled(step_with_grads, state, batches[0])
        else:
            cell = jax_cells.lm_train_cell(
                arch, jcfg, JaxShapeSpec("t", "train", seq_len=SEQ,
                                         global_batch=B),
                jax.make_mesh((1, 1), ("data", "model"), axis_types=(
                    jax.sharding.AxisType.Auto,) * 2), False,
                microbatches=mb)
            cell_step = _compiled(cell.fn, state, batches[0])
            rows = B // mb
            grad = _compiled(jax.grad(lambda p, b: loss(p, b)[0]), params,
                             {k: v[:rows] for k, v in batches[0].items()})
    finally:
        jax_moe.moe_ffn_sharded = sharded
    if mb == 1:
        g = None
    else:
        g = jax.tree.map(lambda *gs: sum(
            x.astype(jnp.float32) for x in gs) / mb, *[
            grad(params, {k: v[i * rows:(i + 1) * rows]
                          for k, v in batches[0].items()})
            for i in range(mb)])

        def step(state, batch):
            return cell_step(state, batch) + (None,)
    losses = []
    for b in batches:
        state, metrics, gi = step(state, b)
        g = gi if g is None else g
        losses.append(float(metrics["loss"]))
    return (jax.tree.map(np.asarray, params), losses, _jax_paths(g),
            _jax_paths(state.params))


def _steps_body(rank, cases):
    """Every case on this rank: ``lm_train_cell`` from JAX's params, each
    step's global loss, the first step's accumulated gradient blocks
    (what the update consumes) and the params after the steps, with the
    specs and paths to place JAX's arrays by."""
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.core.schemes.base import tree_leaves
    from repro_torch.launch.cells import _tree_paths, lm_train_cell
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.sharding.rules import spec_leaves
    m = make_debug_mesh(*MESH, device="cpu")
    out = {"coords": (m.axis_index("data"), m.axis_index("model"))}
    for name, (arch, changes, mb, params_np) in cases.items():
        _, cfg = get_arch(arch, smoke=True)
        cfg = dataclasses.replace(cfg, **changes)
        cell = lm_train_cell(cfg, m, mb, params=lm_params_from_numpy(
            params_np, cfg, "cpu"))
        state, losses, grads, reps = cell.state, [], None, []
        for s, b in enumerate(_batches(cfg.vocab_size)):
            lb = cell.local_batch({k: torch.from_numpy(v)
                                   for k, v in b.items()})
            acc, metrics = cell.accumulate(state, lb)
            if s == 0:
                grads = [g.float().numpy().copy() for g in acc]
            state = cell.update(state, acc)
            losses.append(float(metrics["loss"]))
            reps.append([t.numpy().copy() for t in tree_leaves(state.params)])
        out[name] = dict(
            losses=losses, grads=grads, params=reps[-1], every_step=reps,
            paths=[p for p, _ in _tree_paths(cell.specs.params)],
            p_specs=spec_leaves(cell.specs.params),
            m_specs=spec_leaves(cell.specs.opt_state["m"]))
    return out


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """(JAX's run of every case, every rank's)."""
    refs, cases = {}, {}
    for name, (arch, changes, mb) in CASES.items():
        refs[name] = _jax_case(arch, changes, mb)
        cases[name] = (arch, changes, mb, refs[name][0])
    ranks = spawn(_steps_body, MESH[0] * MESH[1], args=(cases,),
                  store_dir=str(tmp_path_factory.mktemp("lm_mesh")),
                  timeout_s=TIMEOUT)
    return refs, ranks


def _block(a, spec, coords):
    """The block of ``a`` a rank at ``coords`` (data, model) holds under
    ``spec``."""
    return rules.NamedSpec(_FakeMesh(*MESH, coords=coords), tuple(
        spec)).block(torch.from_numpy(np.array(a))).numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_lm_mesh_steps_match_jax_single_device(steps, case):
    refs, ranks = steps
    _, losses, jgrads, jparams = refs[case]
    g1 = {k: np.asarray(v, np.float64) for k, v in jgrads.items()}
    for r in ranks:
        out, coords = r[case], r["coords"]
        np.testing.assert_allclose(out["losses"], losses, rtol=TOL,
                                   atol=TOL)
        for path, g, ms in zip(out["paths"], out["grads"], out["m_specs"],
                               strict=True):
            np.testing.assert_allclose(
                g, _block(jgrads[path], ms, coords), rtol=TOL, atol=TOL,
                err_msg=f"{case}: grad {path}")
        for path, p, ps in zip(out["paths"], out["params"], out["p_specs"],
                               strict=True):
            want = _block(jparams[path], ps, coords)
            tiny = np.abs(_block(g1[path].astype(np.float32), ps,
                                 coords)) < 1e-6
            gap = np.abs(p.astype(np.float64) - want)
            bar = np.where(tiny, 2 * LR * STEPS, TOL + TOL * np.abs(want))
            assert (gap <= bar).all(), (case, path, float(gap.max()))


def test_lm_mesh_replicated_leaves_bit_identical(steps):
    """After every step, the ranks that hold the same block of a leaf
    hold the same bits (the model ranks' norms, the data ranks' row
    blocks)."""
    _, ranks = steps
    for case in CASES:
        for step in range(STEPS):
            seen = {}
            for r in ranks:
                out = r[case]
                for i, (path, ps) in enumerate(zip(out["paths"],
                                                   out["p_specs"])):
                    axes = rules.split_axes(ps, _FakeMesh(*MESH))
                    key = (path,) + tuple(
                        r["coords"][("data", "model").index(a)]
                        for a in axes)
                    t = out["every_step"][step][i]
                    if key in seen:
                        np.testing.assert_array_equal(t, seen[key])
                    seen[key] = t


def test_jax_state_placed_by_the_specs(steps):
    """``convert.lm_state_from_numpy`` carries JAX's params and an adamw
    state across and places each leaf as ``lm_state_specs`` does: every
    rank of a (2, 2) mesh (FSDP and ZeRO-1 on) holds its block of the
    whole arrays, bit for bit."""
    from repro_torch.convert import lm_state_from_numpy
    from repro_torch.core.schemes.base import tree_leaves
    from repro_torch.train.optimizer import TrainState
    refs, _ = steps
    params = refs["stablelm-fsdp-remat-mb2"][0]
    _, cfg = get_arch("stablelm-3b", smoke=True)
    cfg = dataclasses.replace(cfg, fsdp_params=True, remat=True)
    rng = np.random.default_rng(5)
    moment = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
        np.float32), params)
    opt = {"step": np.asarray(3, np.int32), "m": moment,
           "v": jax.tree.map(np.abs, moment)}
    whole = lm_state_from_numpy(params, opt, cfg, "cpu")
    template = jax.tree.map(lambda a: torch.empty(a.shape, device="meta"),
                            params)
    p_spec, o_spec = rules.lm_state_specs(cfg, _FakeMesh(*MESH), template, {
        "step": torch.zeros(()), "m": template, "v": template})
    specs = TrainState(p_spec, o_spec)
    assert any("data" in rules.split_axes(sp, _FakeMesh(*MESH))
               for sp in rules.spec_leaves(o_spec["m"]))
    for coords in ((0, 0), (0, 1), (1, 0), (1, 1)):
        placed = lm_state_from_numpy(params, opt, cfg, "cpu",
                                     mesh=_FakeMesh(*MESH, coords=coords),
                                     specs=specs)
        for tree, spec in ((placed.params, p_spec),
                           (placed.opt_state, o_spec)):
            src = whole.params if tree is placed.params else whole.opt_state
            for got, want, sp in zip(tree_leaves(tree), tree_leaves(src),
                                     rules.spec_leaves(spec), strict=True):
                assert torch.equal(got, rules.NamedSpec(
                    _FakeMesh(*MESH, coords=coords), tuple(sp)).block(want))


# ----------------------------------------------------------------------
# train --mesh: crash, resume, elastic restore
# ----------------------------------------------------------------------

RESUME = dict(arch="stablelm-3b", smoke=True, batch=4, seq=16,
              log_every=1, device="cpu",
              overrides={"fsdp_params": True, "param_dtype": "bfloat16"})


def _resume_body(rank, ckpt_dir):
    """On (2, 2): ``train`` failed at step 3 with a checkpoint at step 2,
    resumed to 4; an uninterrupted run to 4.  Then the step-2 checkpoint
    restored on (1, 4) (its blocks) and trained to step 3 from it."""
    from repro_torch.core.schemes.base import tree_leaves
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.cells import lm_train_cell
    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding.rules import whole_like
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train.optimizer import TrainState
    from repro_torch.train.resilience import SimulatedFailure
    m = Mesh((2, 2), ("data", "model"), device="cpu")
    kw = dict(RESUME, steps=4, mesh=m)
    try:
        train_cli.train(ckpt_dir=ckpt_dir, ckpt_every=2, fail_at=3, **kw)
        raise AssertionError("no failure at step 3")
    except SimulatedFailure:
        pass
    resumed = train_cli.train(ckpt_dir=ckpt_dir, **kw)
    whole = train_cli.train(**kw)
    m14 = Mesh((1, 4), ("data", "model"), device="cpu")
    _, cfg = get_arch(RESUME["arch"], smoke=True)
    cfg = dataclasses.replace(cfg, **RESUME["overrides"])
    cell = lm_train_cell(cfg, m14, optimizer=train_cli.LM_OPTIMIZER)
    template = TrainState(whole_like(cell.state.params, cell.specs.params,
                                     m14),
                          whole_like(cell.state.opt_state,
                                     cell.specs.opt_state, m14))
    restored = ckpt_lib.elastic_restore(ckpt_dir, 2, template, cell.specs,
                                        m14)
    blocks = [t.clone() for t in tree_leaves(restored.params)
              + tree_leaves(restored.opt_state)]
    data = train_cli.lm_stream(cfg, RESUME["batch"], RESUME["seq"], start=2)
    _, metrics = cell.step(restored, cell.local_batch(next(data)))
    from repro_torch.launch.cells import _tree_paths
    specs = [s for _, s in _tree_paths(cell.specs.params)] + [
        s for _, s in _tree_paths(cell.specs.opt_state)]
    return dict(
        resumed=[h["loss"] for h in resumed.history],
        whole=[h["loss"] for h in whole.history],
        same=[torch.equal(a, b) for a, b in zip(
            tree_leaves(resumed.state.params)
            + tree_leaves(resumed.state.opt_state),
            tree_leaves(whole.state.params)
            + tree_leaves(whole.state.opt_state), strict=True)],
        coords14=(m14.axis_index("data"), m14.axis_index("model")),
        blocks14=blocks, specs14=specs, loss14=float(metrics["loss"]))


def test_mesh_resume_and_elastic_restore(tmp_path):
    from repro_torch.core.schemes.base import tree_leaves
    from repro_torch.launch import train as train_cli
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train.loop import on_device
    ckpt_dir = str(tmp_path / "ckpt")
    res = spawn(_resume_body, 4, args=(ckpt_dir,), store_dir=str(tmp_path),
                timeout_s=TIMEOUT)
    for r in res:
        assert r["resumed"] == r["whole"][2:]
        assert all(r["same"])
    assert ckpt_lib.list_steps(ckpt_dir) == [2]
    # one device: the whole arrays, and a step from them
    _, cfg = get_arch(RESUME["arch"], smoke=True)
    cfg = dataclasses.replace(cfg, **RESUME["overrides"])
    state, step, data = train_cli.lm_setup(cfg, RESUME["batch"],
                                           RESUME["seq"], device="cpu",
                                           start=2)
    restored = ckpt_lib.elastic_restore(ckpt_dir, 2, state)
    leaves = tree_leaves(restored.params) + tree_leaves(restored.opt_state)
    assert leaves[0].dtype == torch.bfloat16
    for r in res:
        for got, whole, spec in zip(r["blocks14"], leaves, r["specs14"],
                                    strict=True):
            mesh = _FakeMesh(1, 4, coords=r["coords14"])
            want = rules.NamedSpec(mesh, tuple(spec)).block(whole)
            assert torch.equal(got, want)
        np.testing.assert_allclose(r["loss14"], r["whole"][2], rtol=TOL,
                                   atol=TOL)
    _, metrics = step(restored, on_device(next(data), "cpu"))
    np.testing.assert_allclose(float(metrics["loss"]), res[0]["whole"][2],
                               rtol=TOL, atol=TOL)
