"""The port's bit-packing and fused unpack-and-decode op against the JAX
package's.

On the CPU: ``pack_codes`` gives bytes identical to JAX's at every
bitwidth, width and leading shape, ``unpack_codes`` inverts it, and the
plain ``packed_decode_ref`` is bit-identical to JAX's (float32 and
bfloat16).  A spy shows that the packed (B, W) words themselves reach
the op from the ``mpe`` serve path.  The CUDA kernel is held to the
plain version on the card in ``test_torch_gpu.py``.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.packed_decode import pack_codes as jax_pack
from repro.kernels.packed_decode import packed_decode_ref as jax_decode
from repro.kernels.packed_decode import unpack_codes as jax_unpack
from repro_torch.convert import tensor_from_numpy
from repro_torch.core import Embedding, EmbeddingConfig
from repro_torch.kernels import dispatch
from repro_torch.kernels.packed_decode import (PACK_BITS, decode, pack_codes,
                                               packed_decode,
                                               packed_decode_ref,
                                               packed_width, unpack_codes)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x.view(torch.int32)).numpy()
    x = np.asarray(x)
    return x.view(np.int16 if x.dtype.itemsize == 2 else np.int32)


def _codes(shape, bits, seed=0, dtype=np.int32):
    return np.random.default_rng(seed).integers(
        0, 2 ** bits, shape).astype(dtype)


@pytest.mark.parametrize("bits", PACK_BITS)
@pytest.mark.parametrize("shape", [(37, 5), (37, 8), (1, 1), (3, 5, 7),
                                   (2, 3, 8), (0, 5)],
                         ids=lambda s: "x".join(map(str, s)))
def test_pack_codes_byte_identical_to_jax(shape, bits):
    """D = 5 at 4 bits leaves one pad code in the last byte, at 2 bits
    three; the pad bits are zero in both packages."""
    codes = _codes(shape, bits, seed=sum(shape) + bits)
    want = np.asarray(jax_pack(jnp.asarray(codes), bits))
    got = pack_codes(torch.from_numpy(codes), bits)
    assert got.dtype == torch.uint8
    assert tuple(got.shape) == shape[:-1] + (packed_width(shape[-1], bits),)
    np.testing.assert_array_equal(got.numpy(), want)
    back = unpack_codes(got, bits, shape[-1])
    assert back.dtype == torch.uint8
    np.testing.assert_array_equal(back.numpy(), codes)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jax_unpack(jnp.asarray(want), bits,
                                            shape[-1])))


@pytest.mark.parametrize("bits", PACK_BITS)
def test_pack_codes_cuts_to_the_low_byte_as_jax_does(bits):
    """uint8 input, and int32 codes past a byte, pack as JAX's cast to
    uint8 packs them."""
    for codes in (_codes((9, 5), bits, dtype=np.uint8),
                  np.arange(45, dtype=np.int32).reshape(9, 5) * 97):
        np.testing.assert_array_equal(
            pack_codes(torch.from_numpy(codes), bits).numpy(),
            np.asarray(jax_pack(jnp.asarray(codes), bits)))


@pytest.mark.parametrize("bits,d,w", [(2, 8, 2), (4, 8, 4), (8, 8, 8),
                                      (2, 7, 2), (4, 5, 3), (2, 5, 2),
                                      (2, 1, 1)])
def test_packed_width(bits, d, w):
    assert packed_width(d, bits) == w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,s", [(5, 2), (8, 8)])
@pytest.mark.parametrize("bits", PACK_BITS)
@pytest.mark.parametrize("b", [1, 37, 257])
def test_packed_decode_plain_matches_jax(b, bits, d, s, dtype):
    rng = np.random.default_rng(b + bits + d)
    packed = np.asarray(jax_pack(jnp.asarray(_codes((b, d), bits)), bits))
    cent = rng.normal(size=(d, 2 ** bits, s)).astype(np.float32)
    if dtype == "bfloat16":
        cent = cent.astype(ml_dtypes.bfloat16)
    want = jax_decode(jnp.asarray(packed), jnp.asarray(cent), bits)
    got = packed_decode_ref(tensor_from_numpy(packed, "cpu"),
                            tensor_from_numpy(cent, "cpu"), bits)
    assert tuple(got.shape) == (b, d * s)
    assert got.dtype == (torch.bfloat16 if dtype == "bfloat16"
                         else torch.float32)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_packed_decode_op_on_cpu_is_plain_version():
    packed = pack_codes(torch.from_numpy(_codes((64, 5), 4)), 4)
    cent = torch.randn(5, 16, 2, generator=torch.Generator().manual_seed(0))
    for backend in (None, "auto", "torch"):
        np.testing.assert_array_equal(
            _bits(decode(packed, cent, 4, backend=backend)),
            _bits(packed_decode_ref(packed, cent, 4)))


def test_packed_words_reach_the_op():
    """The mpe serve path hands the op the PACKED (B, W_i) uint8 words,
    one call per tier: the unpack happens inside the op."""
    cfg = EmbeddingConfig(vocab_size=32, dim=8, kind="mpe", num_subspaces=4,
                          tier_boundaries=(8, 16), tier_bits=(8, 4, 2))
    emb = Embedding(cfg, device="cpu")
    art = emb.export(emb.init(emb.generator(0)))
    real = dispatch._REGISTRY["packed_decode"]["torch"]
    seen = []

    def spy(packed, cent, bits, **kw):
        seen.append((tuple(packed.shape), packed.dtype, bits))
        return real(packed, cent, bits, **kw)

    dispatch._REGISTRY["packed_decode"]["torch"] = spy
    try:
        out = emb.serve(art, torch.arange(9))
    finally:
        dispatch._REGISTRY["packed_decode"]["torch"] = real
    assert tuple(out.shape) == (9, cfg.dim)
    assert seen == [((9, packed_width(4, b)), torch.uint8, b)
                    for b in cfg.tier_bits]
    # sub-byte tiers cross the boundary narrower than the code count
    assert all(w < 4 for (_, w), _, b in seen if b < 8)


def test_packed_decode_refuses_bad_input():
    cent = torch.zeros((8, 4, 2))
    with pytest.raises(ValueError, match="packed width"):
        unpack_codes(torch.zeros((4, 3), dtype=torch.uint8), 2, 8)
    with pytest.raises(ValueError, match="packed width"):
        packed_decode_ref(torch.zeros((4, 3), dtype=torch.uint8), cent, 2)
    with pytest.raises(ValueError, match="bits"):
        packed_width(8, 3)
    with pytest.raises(ValueError, match="K >= 2"):
        packed_decode_ref(torch.zeros((4, 2), dtype=torch.uint8), cent, 4)
    # no silent fallback: the kernel wrapper refuses CPU tensors
    before = packed_decode.launches
    packed = torch.zeros((4, 2), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        packed_decode(packed, cent, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        decode(packed, cent, 2, backend="cuda")
    assert packed_decode.launches == before
