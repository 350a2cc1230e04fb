"""The port's flash_attention op on the CPU against the JAX package.

The op's CPU path is its plain version, ``flash_attention_ref``, a copy
of JAX's oracle; the CUDA kernel is held against it on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).  Inputs are drawn with
numpy and handed to both packages.  The bars:

* the plain version against JAX's ``flash_attention_ref`` and JAX's
  Pallas kernel in interpret mode, at the JAX tests' four shapes
  (``tests/test_kernels.py``), within 2e-5 (f32; another summation
  order than the Pallas kernel's online softmax);
* ``attend`` and the port's ``chunked_attention`` against JAX's
  ``chunked_attention`` and ``dense_attention`` with ``arange``
  positions, at odd lengths and windows 1, 8 and full, within 2e-5;
* bf16 within 3e-2 (the JAX tests' own bar);
* dispatch: ``auto`` on CPU tensors is the plain version, ``cuda`` on
  CPU tensors raises, and the kernel refuses inputs that require grad.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention import \
    flash_attention_ref as jax_flash_ref
from repro.nn import attention as jax_attn
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import (attend, flash_attention,
                                                 flash_attention_ref)
from repro_torch.nn import attention as attn

TOL = 2e-5
BF16_TOL = 3e-2
FULL = 1 << 30


def _inputs(b, sq, skv, h, hkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(b, sq, h, hd)) * 0.3).astype(np.float32)
    k = (rng.normal(size=(b, skv, hkv, hd)) * 0.3).astype(np.float32)
    v = rng.normal(size=(b, skv, hkv, hd)).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


# the JAX tests' shapes: GQA causal, MHA windowed, cross-length, a
# window wider than the Pallas kernel's 128-row block
JAX_SHAPES = [(2, 256, 256, 4, 2, 64, FULL), (1, 128, 128, 4, 4, 32, 64),
              (2, 128, 384, 8, 2, 64, FULL), (1, 256, 256, 2, 1, 128, 300)]


@pytest.mark.parametrize("b,sq,skv,h,hkv,hd,win", JAX_SHAPES)
def test_plain_matches_jax_ref_and_pallas_interpret(b, sq, skv, h, hkv, hd,
                                                    win):
    q, k, v = _inputs(b, sq, skv, h, hkv, hd, seed=sq + h)
    got = flash_attention_ref(*_t(q, k, v), window=win).numpy()
    ref = np.asarray(jax_flash_ref(*_j(q, k, v), window=win))
    pallas = np.asarray(jax_flash(*_j(q, k, v), window=win, block_q=128,
                                  block_k=128, interpret=True))
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, pallas, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("win", [1, 8, FULL])
@pytest.mark.parametrize("s,h,hkv,hd", [(37, 4, 2, 16), (100, 2, 2, 32),
                                        (129, 8, 2, 16)])
def test_attend_matches_jax_chunked_and_dense(s, h, hkv, hd, win):
    q, k, v = _inputs(2, s, s, h, hkv, hd, seed=s)
    pos = np.arange(s, dtype=np.int32)
    chunked = np.asarray(jax_attn.chunked_attention(
        *_j(q, k, v), jnp.asarray(pos), jnp.asarray(pos), win, block=16))
    dense = np.asarray(jax_attn.dense_attention(
        *_j(q, k, v), jnp.asarray(pos), jnp.asarray(pos), win))
    tq, tk, tv = _t(q, k, v)
    tpos = torch.from_numpy(pos)
    for got in (attend(tq, tk, tv, win),
                attn.chunked_attention(tq, tk, tv, tpos, tpos, win),
                attn.dense_attention(tq, tk, tv, tpos, tpos, win)):
        np.testing.assert_allclose(got.numpy(), chunked, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got.numpy(), dense, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("win", [64, FULL], ids=["local", "global"])
def test_plain_matches_jax_at_gemma3_27b_head_dim(win):
    """hd = 168 (gemma3-27b: 5,376 / 32), which the card's kernel
    zero-pads to 176 for the tensor cores: the plain version against
    JAX's oracle and its Pallas kernel in interpret mode, GQA 4 over 2,
    local and global."""
    q, k, v = _inputs(1, 128, 128, 4, 2, 168, seed=168)
    got = flash_attention_ref(*_t(q, k, v), window=win).numpy()
    ref = np.asarray(jax_flash_ref(*_j(q, k, v), window=win))
    pallas = np.asarray(jax_flash(*_j(q, k, v), window=win, block_q=64,
                                  block_k=64, interpret=True))
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, pallas, rtol=TOL, atol=TOL)


def test_kernel_head_dims_and_tiles():
    """The kernel compiles hd = 168 beside the six earlier widths, and
    picks its KV tile per dtype: 64 keys on the CUDA cores (float32),
    on the tensor cores (bfloat16) 64 below hd = 256 and 32 at 320."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        BLOCK_K, HEAD_DIMS, default_block_k)
    assert HEAD_DIMS == (16, 32, 64, 80, 128, 168, 320)
    assert BLOCK_K.default is None and set(BLOCK_K.candidates) == {None, 32,
                                                                   64}
    for hd in HEAD_DIMS:
        assert default_block_k(torch.float32, hd) == 64
        assert default_block_k(torch.bfloat16, hd) == (32 if hd == 320
                                                       else 64)


def test_rows_that_see_no_key_average_every_value():
    """Query rows past Skv + window - 1 see no key: every score is
    -1e30 and the reference averages all values; so does the port."""
    q, k, v = _inputs(1, 64, 16, 2, 1, 16, seed=3)
    got = flash_attention_ref(*_t(q, k, v), window=8).numpy()
    ref = np.asarray(jax_flash_ref(*_j(q, k, v), window=8))
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got[0, 40, 0], v[0, :, 0].mean(0), atol=1e-6)


def test_plain_bf16_matches_jax_ref():
    q, k, v = (a.astype(jnp.bfloat16) for a in _inputs(1, 128, 128, 2, 2,
                                                       32, seed=2))
    got = flash_attention_ref(*(torch.from_numpy(np.asarray(a, np.float32))
                                .to(torch.bfloat16) for a in (q, k, v)))
    ref = jax_flash_ref(*_j(q, k, v))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)


def test_plain_version_is_differentiable_like_jax():
    import jax
    q, k, v = _inputs(1, 48, 48, 2, 1, 16, seed=9)
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    (attend(tq, tk, tv, 8) ** 2).sum().backward()
    want = jax.grad(lambda q, k, v: jnp.sum(jax_flash_ref(q, k, v, 8) ** 2),
                    argnums=(0, 1, 2))(*_j(q, k, v))
    for t, w in zip((tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-4)


def test_chunked_attention_takes_only_index_positions():
    q, k, v = _t(*_inputs(1, 8, 8, 2, 2, 16))
    pos = torch.arange(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="arange"):
        attn.chunked_attention(q, k, v, pos + 1, pos + 1)


def test_dispatch_auto_on_cpu_is_the_plain_version(monkeypatch):
    monkeypatch.delenv(dispatch.ENV_VAR, raising=False)
    assert dispatch.resolve_backend(None, torch.device("cpu")) == "torch"
    q, k, v = _t(*_inputs(1, 40, 40, 4, 2, 16))
    before = flash_attention.launches
    assert torch.equal(attend(q, k, v, 8), flash_attention_ref(q, k, v, 8))
    assert flash_attention.launches == before
    assert "block_k" in dispatch.op_tunables("flash_attention")
    assert dispatch.op_tunables("flash_attention")["block_k"].default is None


def test_cuda_route_refuses_cpu_tensors_and_grad(monkeypatch):
    monkeypatch.delenv(dispatch.ENV_VAR, raising=False)
    q, k, v = _t(*_inputs(1, 16, 16, 2, 2, 16))
    before = flash_attention.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention(q, k, v)
    with pytest.raises(ValueError, match="CUDA tensors"):
        attend(q, k, v, backend="cuda")
    monkeypatch.setenv(dispatch.ENV_VAR, "cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        attend(q, k, v)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q.requires_grad_(), k, v)
    with torch.no_grad():                 # no grad: on to the device check
        with pytest.raises(ValueError, match="CUDA tensors"):
            flash_attention(q, k, v)
    # attend's backward is the recompute: pinned to the kernel, a CPU
    # input with grad reaches the device check, not the grad refusal
    with pytest.raises(ValueError, match="CUDA tensors"):
        attend(q, k, v)
    monkeypatch.delenv(dispatch.ENV_VAR)
    out = attend(q, k, v, 5)              # the plain version, with grad
    (dq,) = torch.autograd.grad(out.sum(), q)
    assert dq.shape == q.shape and bool(torch.isfinite(dq).all())
    assert flash_attention.launches == before
