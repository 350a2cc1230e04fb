"""The port's MoE on a mesh against the JAX package, on the CPU.

``nn/moe.py::moe_ffn_sharded`` (the grouped dispatch, both strategies)
and ``moe_ffn``'s mesh formulation run on a (2, 2) mesh of gloo CPU
ranks (``launch.mesh.spawn``, one group for the module); JAX's
``moe_ffn_sharded`` runs in a subprocess with 4 forced host devices on a
(2, 2) mesh, as ``tests/test_sharding.py`` runs it.  The shapes are
JAX's test's: x (4, 16, 32), d_ff 64, top 2, 8 experts (the expert
strategy) and 3 (the ffn strategy at model = 2).  Bars:

* outputs and aux within 1e-5 of JAX's ``moe_ffn_sharded``, at
  ``capacity_factor`` 1.25 (tokens drop, group by group) and at 64;
* at 64, the gradients of ``sum(out * cos(out)) + aux`` (every weight
  and x) within 1e-5 of ``jax.grad`` of JAX's;
* at 64 (nothing drops), outputs and the experts' gradients within
  1e-5 of the port's own single-device ``moe_ffn``; its aux is the
  groups' mean, so it is held to JAX's alone;
* ``moe_ffn`` on the mesh (the global formulation: tokens gathered over
  data, experts or their d_ff over model) within 1e-5 of the port's
  single-device ``moe_ffn``, aux and every gradient included, at 1.25;
* the single-device twin of JAX's grouping that
  ``tests/test_torch_lm_mesh.py`` uses (:func:`jax_grouped_moe`), and
  the port's own (``moe_ffn_grouped``, the card tests' plain version),
  within 1e-5 of JAX's ``moe_ffn_sharded``, outputs, aux and gradients;
* planted: the expert strategy's sequence gather with a summing
  backward (``all_gather_grad`` where the consumer is replicated over
  model) fails the gradient bar.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import spawn

TOL = 1e-5
TIMEOUT = 180.0
MESH = (2, 2)                 # (data, model)
B, S, D, F, TOP_K = 4, 16, 32, 64, 2
EXPERTS = {"expert": 8, "ffn": 3}
FACTORS = (1.25, 64.0)
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_grouped_moe(data_n: int, model_n: int):
    """JAX's ``moe_ffn_sharded`` on a (data_n, model_n) mesh, computed on
    one device: the same token groups (the expert strategy's (data,
    model) blocks of batch and sequence, the ffn strategy's data
    blocks), each dispatched at its own capacity through JAX's own
    ``_dispatch_combine``, the aux the groups' mean."""
    import jax.numpy as jnp
    from repro.nn import moe as jmoe

    def fn(params, x, *, top_k, capacity_factor=1.25, model_axis="model"):
        e = params["router"].shape[-1]
        b, s, d = x.shape
        seq_n = model_n if (e % model_n == 0 and e >= model_n) else 1
        bl, sl = b // data_n, s // seq_n
        rows, auxs = [], []
        for di in range(data_n):
            row = []
            for mi in range(seq_n):
                xg = x[di * bl:(di + 1) * bl, mi * sl:(mi + 1) * sl]
                cap = jmoe.capacity(bl * sl, e, top_k, capacity_factor)
                out, aux = jmoe._dispatch_combine(
                    xg.reshape(bl * sl, d), params["router"], top_k, cap,
                    lambda buf: jmoe._expert_swiglu(
                        buf, params["w_gate"], params["w_up"],
                        params["w_down"]))
                row.append(out.reshape(bl, sl, d))
                auxs.append(aux)
            rows.append(jnp.concatenate(row, axis=1))
        return jnp.concatenate(rows, axis=0), jnp.mean(jnp.stack(auxs))

    return fn


def _inputs(e: int, seed: int = 0):
    """Params (router, w_gate, w_up, w_down) and x, numpy float32."""
    rng = np.random.default_rng(seed + e)
    p = {"router": rng.normal(size=(D, e)) * D ** -0.5,
         "w_gate": rng.normal(size=(e, D, F)) * D ** -0.5,
         "w_up": rng.normal(size=(e, D, F)) * D ** -0.5,
         "w_down": rng.normal(size=(e, F, D)) * F ** -0.5}
    x = rng.normal(size=(B, S, D))
    return ({k: v.astype(np.float32) for k, v in p.items()},
            x.astype(np.float32))


_JAX_SCRIPT = """
import sys, numpy as np, jax, jax.numpy as jnp
sys.path.insert(0, {tests!r})
from test_torch_moe_mesh import jax_grouped_moe, _inputs, EXPERTS, FACTORS
from repro.nn import moe as jmoe
mesh = jax.make_mesh((2, 2), ("data", "model"))
twin = jax_grouped_moe(2, 2)
out = {{}}
for name, e in EXPERTS.items():
    p, x = _inputs(e)
    for f in FACTORS:
        def loss(fn, p, x):
            o, a = fn(p, x, top_k=2, capacity_factor=f)
            return jnp.sum(o * jnp.cos(o)) + a, (o, a)
        with mesh:
            sharded = jax.jit(lambda p, x: jax.value_and_grad(
                lambda p, x: loss(jmoe.moe_ffn_sharded, p, x),
                argnums=(0, 1), has_aux=True)(p, x))
            (_, (o, a)), (gp, gx) = sharded(p, x)
        (_, (to, ta)), (tgp, tgx) = jax.value_and_grad(
            lambda p, x: loss(twin, p, x), argnums=(0, 1),
            has_aux=True)(p, x)
        key = f"{{name}}_{{f}}"
        out[key + "_out"], out[key + "_aux"] = np.asarray(o), np.asarray(a)
        out[key + "_twin_out"] = np.asarray(to)
        out[key + "_twin_aux"] = np.asarray(ta)
        out[key + "_gx"], out[key + "_twin_gx"] = np.asarray(gx), \\
            np.asarray(tgx)
        for k in p:
            out[key + "_g_" + k] = np.asarray(gp[k])
            out[key + "_twin_g_" + k] = np.asarray(tgp[k])
np.savez({path!r}, **out)
"""


def _jax_refs(path: str) -> dict:
    """JAX's ``moe_ffn_sharded`` on a (2, 2) mesh of 4 forced host
    devices, and :func:`jax_grouped_moe` beside it, in a subprocess."""
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    code = _JAX_SCRIPT.format(tests=os.path.join(_ROOT, "tests"), path=path)
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    with np.load(path) as z:
        return dict(z)


def _block(a: np.ndarray, strategy: str, name: str, model_i: int
           ) -> np.ndarray:
    """A model rank's block of leaf ``name``: the experts over model (the
    expert strategy, and the mesh formulation's when E divides), else
    their d_ff; the router whole."""
    dim = {"router": None, "w_gate": 2, "w_up": 2, "w_down": 1}[name]
    if strategy == "expert" and dim is not None:
        dim = 0
    if dim is None:
        return a
    n = a.shape[dim] // MESH[1]
    return np.ascontiguousarray(
        np.take(a, range(model_i * n, (model_i + 1) * n), axis=dim))


def _rank_case(m, strategy, e, factor, sharded, planted):
    """One case on this rank: the loss of the module docstring over its
    data shard (the outputs replicated over model), weighted
    B_local/B_global in the aux, its gradients summed over data.
    Returns (out rows of this data shard, aux, grads, dx)."""
    from repro_torch.nn import moe
    from repro_torch.sharding import collectives as coll
    data_n, model_n = m.shape["data"], m.shape["model"]
    p_np, x_np = _inputs(e)
    params = {k: torch.from_numpy(_block(v, strategy, k, m.axis_index(
        "model"))).requires_grad_(True) for k, v in p_np.items()}
    d = m.axis_index("data")
    x = torch.from_numpy(x_np[d * (B // data_n):(d + 1) * (B // data_n)])
    x.requires_grad_(True)
    kw = dict(top_k=TOP_K, capacity_factor=factor, mesh=m)
    if not sharded:
        out, aux = moe.moe_ffn(params, x, **kw)
    elif strategy == "expert":
        out, aux = moe.moe_ffn_sharded(
            params, coll.scatter_to(x, m, "model", 1), **kw)
        gather = coll.all_gather_grad if planted else coll.gather_from
        out = gather(out, m, "model", dim=1)
    else:
        out, aux = moe.moe_ffn_sharded(params, x, **kw)
    loss = torch.sum(out * torch.cos(out)) + aux / data_n
    grads = torch.autograd.grad(loss, list(params.values()) + [x])
    gp = {k: coll.psum(g, m, "data").numpy()
          for k, g in zip(params, grads[:-1])}
    return out.detach().numpy(), float(aux), gp, grads[-1].numpy()


def _ranks(rank):
    """Every case of the module on this rank: the grouped dispatch (both
    strategies, both capacity factors), the mesh formulation of
    ``moe_ffn`` and the planted sequence gather."""
    from repro_torch.launch.mesh import make_debug_mesh
    m = make_debug_mesh(*MESH, device="cpu")
    out = {"coords": (m.axis_index("data"), m.axis_index("model"))}
    for strategy, e in EXPERTS.items():
        for f in FACTORS:
            out[strategy, f] = _rank_case(m, strategy, e, f, True, False)
        out[strategy, "global"] = _rank_case(m, strategy, e, 1.25, False,
                                             False)
    out["planted"] = _rank_case(m, "expert", EXPERTS["expert"], 64.0, True,
                                True)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's references, every rank's results)."""
    tmp = tmp_path_factory.mktemp("moe_mesh")
    refs = _jax_refs(str(tmp / "refs.npz"))
    ranks = spawn(_ranks, MESH[0] * MESH[1], store_dir=str(tmp),
                  timeout_s=TIMEOUT)
    return refs, ranks


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL, err_msg=what)


def _check(rank_out, ref, key, strategy, grads: bool, gx: bool = True):
    d, mi = rank_out["coords"]
    out, aux, gp, dx = rank_out[key]
    bl = B // MESH[0]
    rows = slice(d * bl, (d + 1) * bl)
    name = f"{strategy}_{key[1]}"
    _close(out, ref[name + "_out"][rows], f"{name} out")
    _close(aux, ref[name + "_aux"], f"{name} aux")
    if grads:
        for k, g in gp.items():
            _close(g, _block(ref[f"{name}_g_{k}"], strategy, k, mi),
                   f"{name} grad {k}")
        if gx:
            _close(dx, ref[name + "_gx"][rows], f"{name} grad x")


@pytest.mark.parametrize("factor", FACTORS)
@pytest.mark.parametrize("strategy", sorted(EXPERTS))
def test_moe_ffn_sharded_matches_jax(runs, strategy, factor):
    """Every rank's outputs and aux within 1e-5 of JAX's
    ``moe_ffn_sharded`` on its (2, 2) mesh (tokens dropping at 1.25);
    at 64 every gradient too."""
    refs, ranks = runs
    for r in ranks:
        _check(r, refs, (strategy, factor), strategy, grads=factor == 64.0)


@pytest.mark.parametrize("strategy", sorted(EXPERTS))
def test_moe_ffn_sharded_matches_the_single_device_moe_ffn(runs, strategy):
    """At capacity 64 nothing drops: the outputs and the experts'
    gradients of the grouped dispatch equal the port's single-device
    ``moe_ffn``'s (the aux, a mean over groups, differs)."""
    from repro_torch.nn import moe
    _, ranks = runs
    p_np, x_np = _inputs(EXPERTS[strategy])
    params = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in p_np.items()}
    out, aux = moe.moe_ffn(params, torch.from_numpy(x_np), top_k=TOP_K,
                           capacity_factor=64.0)
    grads = dict(zip(params, torch.autograd.grad(
        torch.sum(out * torch.cos(out)), list(params.values()))))
    bl = B // MESH[0]
    for r in ranks:
        d, mi = r["coords"]
        got_out, _, gp, _ = r[strategy, 64.0]
        _close(got_out, out.detach().numpy()[d * bl:(d + 1) * bl],
               f"{strategy} out")
        for k in ("w_gate", "w_up", "w_down"):
            _close(gp[k], _block(grads[k].numpy(), strategy, k, mi),
                   f"{strategy} grad {k}")


@pytest.mark.parametrize("strategy", sorted(EXPERTS))
def test_moe_ffn_on_a_mesh_is_the_single_device_function(runs, strategy):
    """``moe_ffn(mesh=)``: tokens gathered over data and dispatched
    globally, so outputs, aux and every gradient equal the port's
    single-device ``moe_ffn`` at 1.25, dropped tokens and all."""
    from repro_torch.nn import moe
    _, ranks = runs
    p_np, x_np = _inputs(EXPERTS[strategy])
    params = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in p_np.items()}
    x = torch.from_numpy(x_np).requires_grad_(True)
    out, aux = moe.moe_ffn(params, x, top_k=TOP_K, capacity_factor=1.25)
    grads = torch.autograd.grad(torch.sum(out * torch.cos(out)) + aux,
                                list(params.values()) + [x])
    bl = B // MESH[0]
    for r in ranks:
        d, mi = r["coords"]
        got_out, got_aux, gp, dx = r[strategy, "global"]
        _close(got_out, out.detach().numpy()[d * bl:(d + 1) * bl], "out")
        _close(got_aux, float(aux.detach()), "aux")
        for k, g in zip(params, grads[:-1]):
            _close(gp[k], _block(g.numpy(), strategy, k, mi), k)
        _close(dx, grads[-1].numpy()[d * bl:(d + 1) * bl], "x")


@pytest.mark.parametrize("factor", FACTORS)
@pytest.mark.parametrize("strategy", sorted(EXPERTS))
def test_the_single_device_grouping_twin_matches_jax(runs, strategy,
                                                      factor):
    """:func:`jax_grouped_moe`, the LM tests' single-device stand-in for
    JAX's sharded dispatch, equals it: outputs, aux, every gradient."""
    refs, _ = runs
    name = f"{strategy}_{factor}"
    for k in ("out", "aux", "gx", "g_router", "g_w_gate", "g_w_up",
              "g_w_down"):
        _close(refs[f"{name}_twin_{k}"], refs[f"{name}_{k}"], k)


@pytest.mark.parametrize("factor", FACTORS)
@pytest.mark.parametrize("strategy", sorted(EXPERTS))
def test_moe_ffn_grouped_matches_jax(runs, strategy, factor):
    """``moe_ffn_grouped``, the plain single-device version the card's
    mesh runs are held to, equals JAX's ``moe_ffn_sharded`` on its (2, 2)
    mesh: outputs and aux, and at 64 every gradient."""
    from repro_torch.nn import moe
    refs, _ = runs
    p_np, x_np = _inputs(EXPERTS[strategy])
    params = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in p_np.items()}
    x = torch.from_numpy(x_np).requires_grad_(True)
    out, aux = moe.moe_ffn_grouped(params, x, top_k=TOP_K,
                                   capacity_factor=factor, data_n=MESH[0],
                                   model_n=MESH[1])
    name = f"{strategy}_{factor}"
    _close(out.detach().numpy(), refs[name + "_out"], "out")
    _close(float(aux.detach()), refs[name + "_aux"], "aux")
    if factor == 64.0:
        grads = torch.autograd.grad(torch.sum(out * torch.cos(out)) + aux,
                                    list(params.values()) + [x])
        for k, g in zip(params, grads):
            _close(g.numpy(), refs[f"{name}_g_{k}"], k)
        _close(grads[-1].numpy(), refs[name + "_gx"], "x")


def test_a_summing_sequence_gather_fails(runs):
    """Planted: the expert strategy's outputs gathered back over model
    with ``all_gather_grad`` (a reduce-scatter backward) where the
    consumer is replicated over model.  The forward is JAX's; x's
    gradient through the experts comes out at twice its value, far
    outside the bar."""
    refs, ranks = runs
    bl = B // MESH[0]
    for r in ranks:
        d = r["coords"][0]
        out, _, _, dx = r["planted"]
        _close(out, refs["expert_64.0_out"][d * bl:(d + 1) * bl], "out")
        want = refs["expert_64.0_gx"][d * bl:(d + 1) * bl]
        with pytest.raises(AssertionError):
            _close(dx, want, "planted grad x")
        assert np.abs(dx - want).max() > 0.1 * np.abs(want).max()
