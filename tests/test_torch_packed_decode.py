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
from repro_torch.kernels.decode_chunks import (SMEM_MAX, SMEM_SLOT_MAX,
                                               SMEM_TABLE_MAX)
from repro_torch.kernels.packed_decode import (PACK_BITS, decode, pack_codes,
                                               packed_decode,
                                               packed_decode_ref,
                                               packed_width, unpack_codes)
from repro_torch.kernels.packed_decode.packed_decode import (packed_plan,
                                                             packed_smem)


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


# (B, D, S, bits, element bytes) -> packed_decode's plan (route,
# threads a block, lanes a slot, blocks) on a card of 132 SMs: the mpe
# tiers at deepfm's serve_bulk (D=5, S=2; 8, 4 and 2 bits) in f32 and
# bf16, one engine flush (3,456 rows) and 256 rows (never more blocks
# than the chunks of 32 rows need), the JAX bench's D=8, S=8 (a 64 KB
# staged table), a table past the smem route's limit (through L2) and
# a slot past its limit
@pytest.mark.parametrize("shape,plan", [
    ((262144, 5, 2, 8, 4), ("smem", 512, 0, 264)),
    ((262144, 5, 2, 4, 4), ("smem", 512, 0, 264)),
    ((262144, 5, 2, 2, 4), ("smem", 512, 0, 264)),
    ((262144, 5, 2, 8, 2), ("smem", 512, 0, 264)),
    ((3456, 5, 2, 8, 4), ("smem", 512, 0, 7)),
    ((256, 5, 2, 2, 4), ("smem", 512, 0, 1)),
    ((262144, 8, 8, 8, 4), ("smem", 512, 0, 132)),
    ((1000, 16, 16, 8, 4), ("l2", 1024, 4, 63)),
    ((1000, 4, 32, 4, 4), ("l2", 1024, 8, 32))])
def test_packed_decode_plan_routes(shape, plan):
    got = packed_plan(*shape, sms=132)
    assert (got.route, got.threads, got.group, got.grid) == plan


@pytest.mark.parametrize("s", [1, 2, 3, 8, 17, 64])
@pytest.mark.parametrize("d", [1, 5, 8, 16, 200])
@pytest.mark.parametrize("b", [1, 33, 262144])
def test_packed_decode_plan_fits_what_the_kernel_takes(b, d, s):
    """The smem route only where the D * 2^bits addressed slots (each
    subspace padded to 16 bytes) and the slot are within its limits,
    with shared memory as the kernel computes it and within a block's
    limit, and no more blocks than chunks of 32 rows; else the l2 route
    with a power-of-two group of lanes, one a 16-byte vector up to 32,
    and no more lanes than slots need."""
    for bits in PACK_BITS:
        for elem_bytes in (2, 4):
            slot = s * elem_bytes
            p = packed_plan(b, d, s, bits, elem_bytes, sms=132)
            assert p.threads % 32 == 0 and 0 < p.threads <= 1024
            if p.route == "smem":
                assert d * (-(-(slot << bits) // 16) * 16) <= SMEM_TABLE_MAX
                assert slot <= SMEM_SLOT_MAX and p.group == 0
                assert p.smem == packed_smem(d, slot, bits,
                                             p.threads // 32) <= SMEM_MAX
                assert 1 <= p.grid
                assert (p.grid - 1) * p.threads // 32 < -(-b // 32)
                continue
            assert p.route == "l2" and p.smem == 0
            vec = next(v for v in (16, 8, 4, 2) if slot % v == 0)
            assert p.group & (p.group - 1) == 0
            assert min(slot // vec, 32) <= p.group <= 32
            assert 1 <= p.grid <= 2048 // p.threads * 132
            assert (p.grid - 1) * p.threads < b * d * p.group


def test_packed_decode_plan_takes_block_b_as_threads_a_block():
    # the mpe scheme's pinned decode_block_b (256): 8 warps a block
    p = packed_plan(262144, 5, 2, 8, 4, 132, block_b=256)
    assert (p.route, p.threads) == ("smem", 256)
    p = packed_plan(1000, 16, 16, 8, 4, 132, block_b=256)
    assert (p.route, p.threads, p.grid) == ("l2", 256, 250)
    # the engine's pad multiple need not be whole warps: rounded up
    for bb, threads in ((1, 32), (16, 32), (48, 64), (100, 128),
                        (1000, 1024)):
        assert packed_plan(262144, 5, 2, 8, 4, 132, block_b=bb).threads \
            == threads
        assert packed_plan(1000, 16, 16, 8, 4, 132,
                           block_b=bb).threads == threads
    for bad in (0, 1025, 2048, -32):
        with pytest.raises(ValueError, match="must lie in"):
            packed_plan(262144, 5, 2, 8, 4, 132, block_b=bad)


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
