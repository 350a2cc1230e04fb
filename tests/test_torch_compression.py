"""The port's int8 gradient compression (``train/compression.py``)
against the JAX package's, on the CPU.

* ``quantize_int8`` and ``dequantize`` bit for bit: random leaves at
  several scales, exact half-steps (round half to even, as
  ``jnp.round``), values past the clip, an all-zero leaf;
* ``compressed_psum_mean`` on 1 and 4 gloo ranks (``launch.mesh.spawn``),
  3 steps with error feedback, against numpy over JAX's per-rank
  quantize and dequantize: the new error bit for bit, the mean within
  float32 rounding of the sum's order (bit for bit on 1 rank);
* ``init_error_state``: float32 zeros shaped like the gradients.
"""
import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import spawn
from repro_torch.train import compression

TIMEOUT = 120.0
STEPS = 3


def _cases():
    rng = np.random.default_rng(0)
    # with 127 the largest |x| the scale is 1, so x / scale = x: the
    # halves round to even
    half = np.arange(-8, 9, dtype=np.float32) + 0.5
    return {
        "normal": rng.standard_normal((64, 8)).astype(np.float32),
        "tiny": (rng.standard_normal(100) * 1e-6).astype(np.float32),
        "large": (rng.standard_normal((3, 5, 7)) * 1e4).astype(np.float32),
        "half_steps": np.concatenate([half, [127.0]]).astype(np.float32),
        "zeros": np.zeros((4, 4), np.float32),
        "scalar": np.array(-3.25, np.float32),
    }


@pytest.mark.parametrize("name", sorted(_cases()))
def test_quantize_and_dequantize_bit_identical_to_jax(name):
    import jax.numpy as jnp
    from repro.train import compression as jax_compression
    x = _cases()[name]
    jq, js = jax_compression.quantize_int8(jnp.asarray(x))
    q, s = compression.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    np.testing.assert_array_equal(
        compression.dequantize(q, s).numpy(),
        np.asarray(jax_compression.dequantize(jq, js)))
    if name == "zeros":
        assert not q.any() and float(s) == float(np.float32(1e-12))
    if name == "half_steps":           # -7.5 -> -8, -6.5 -> -6, ...
        assert float(s) == 1.0
        np.testing.assert_array_equal(q.numpy()[:-1],
                                      np.round(x[:-1]).astype(np.int8))


def _grads(world, seed=1):
    """Each rank's gradient tree for each step (numpy)."""
    rng = np.random.default_rng(seed)
    return [[{"w": rng.standard_normal((16, 4)).astype(np.float32),
              "layers": [{"b": rng.standard_normal(4).astype(np.float32)},
                         {"b": np.zeros(3, np.float32)}]}
             for _ in range(world)] for _ in range(STEPS)]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _compressed_body(rank, world, grads):
    """``compressed_psum_mean`` over the ranks' ``data`` axis for each
    step, error fed back."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.core.schemes.base import tree_map
    m = make_debug_mesh(world, 1, device="cpu")
    err, out = None, []
    for step in grads:
        g = tree_map(torch.from_numpy, step[rank])
        if err is None:
            err = compression.init_error_state(g)
            assert all(e.dtype == torch.float32 and not e.any()
                       for e in _leaves(err))
        mean, err = compression.compressed_psum_mean(g, err, m, "data")
        out.append(([t.numpy() for t in _leaves(mean)],
                    [t.numpy() for t in _leaves(err)]))
    return out


@pytest.mark.parametrize("world", [1, 4])
def test_compressed_psum_mean_against_jax_per_rank_values(world, tmp_path):
    import jax.numpy as jnp
    from repro.train import compression as jax_compression
    grads = _grads(world)
    res = spawn(_compressed_body, world, args=(world, grads),
                store_dir=str(tmp_path), timeout_s=TIMEOUT)
    errs = [[np.zeros_like(x) for x in _leaves(grads[0][r])]
            for r in range(world)]
    for step, g_step in enumerate(grads):
        deqs = []
        for r in range(world):
            deq_r, err_r = [], []
            for g, e in zip(_leaves(g_step[r]), errs[r]):
                g32 = jnp.asarray(g) + jnp.asarray(e)
                q, s = jax_compression.quantize_int8(g32)
                d = jax_compression.dequantize(q, s)
                deq_r.append(np.asarray(d))
                err_r.append(np.asarray(g32 - d))
            deqs.append(deq_r)
            errs[r] = err_r
        for r, out in enumerate(res):
            mean, err = out[step]
            for got, want in zip(err, errs[r], strict=True):
                np.testing.assert_array_equal(got, want)
            for i, got in enumerate(mean):
                total = deqs[0][i].copy()
                for r2 in range(1, world):
                    total = total + deqs[r2][i]
                want = total / np.float32(world)
                if world == 1:
                    np.testing.assert_array_equal(got, want)
                else:
                    np.testing.assert_allclose(got, want, rtol=2e-7,
                                               atol=1e-7)
