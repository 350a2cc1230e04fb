"""The port's decode and assignment ops against the JAX package's
references.

On the CPU the plain PyTorch versions (``repro_torch.kernels.*.ref``)
are held to the JAX oracles (``repro.kernels.*.ref``) on identical numpy
inputs: codes identical, decoded rows bit-identical.  The CUDA kernels
are held to the plain versions on the card in ``test_torch_gpu.py``.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.dpq_assign.dpq_assign import (dpq_assign as
                                                 jax_assign_kernel)
from repro.kernels.dpq_assign.ref import (dpq_assign_blocked_ref as
                                          jax_assign_blocked,
                                          dpq_assign_ref as jax_assign)
from repro.kernels.mgqe_decode.ref import mgqe_decode_ref as jax_decode
from repro.kernels.mgqe_decode.ref import (rq_decode_stages_ref as
                                           jax_decode_stages)
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels import build
from repro_torch.kernels.dpq_assign import (assign, dpq_assign,
                                            dpq_assign_blocked_ref,
                                            dpq_assign_ref)
from repro_torch.kernels.dpq_assign.dpq_assign import (MAX_SMEM, TILES,
                                                       WALK_MAX_S, WALK_ROWS,
                                                       choose_tiles,
                                                       smem_bytes)
from repro_torch.kernels.mgqe_decode import (decode, decode_stages,
                                             mgqe_decode, mgqe_decode_ref,
                                             rq_decode_stages,
                                             rq_decode_stages_ref)
from repro_torch.kernels.mgqe_decode.mgqe_decode import (SMEM_MAX,
                                                         SMEM_SLOT_MAX,
                                                         SMEM_TABLE_MAX,
                                                         decode_plan,
                                                         RQ_SMEM_MIN_ROWS,
                                                         decode_smem,
                                                         rq_plan, rq_smem)


def _bits(x) -> np.ndarray:
    """Raw bits of a float array/tensor, for bit-identity checks."""
    if isinstance(x, torch.Tensor):
        x = x.cpu()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x.view(torch.int32)).numpy()
    x = np.asarray(x)
    return x.view(np.int16 if x.dtype.itemsize == 2 else np.int32)


# (code dtype, K, largest code drawn): in range, clamped (codes past K,
# as private_k lanes of other tiers carry), and int32 codes for K > 256
CODE_CASES = {
    "uint8": (np.uint8, 256, 255),
    "uint8_clamped": (np.uint8, 64, 255),
    "int32": (np.int32, 300, 299),
    "int32_clamped": (np.int32, 300, 1000),
}


def _decode_inputs(b, d, s, case, dtype, seed=0):
    code_dt, k, hi = CODE_CASES[case]
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, hi + 1, (b, d)).astype(code_dt)
    cent = rng.normal(size=(d, k, s)).astype(np.float32)
    if dtype == "bfloat16":
        cent = cent.astype(ml_dtypes.bfloat16)
    return codes, cent


@pytest.mark.parametrize("case", sorted(CODE_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [1, 37, 257])
def test_mgqe_decode_plain_matches_jax(b, dtype, case):
    codes, cent = _decode_inputs(b, 5, 2, case, dtype)
    want = jax_decode(jnp.asarray(codes), jnp.asarray(cent))
    got = mgqe_decode_ref(tensor_from_numpy(codes, "cpu"),
                          tensor_from_numpy(cent, "cpu"))
    assert tuple(got.shape) == (b, 10)
    assert got.dtype == (torch.bfloat16 if dtype == "bfloat16"
                         else torch.float32)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_mgqe_decode_op_on_cpu_is_plain_version():
    codes, cent = _decode_inputs(64, 8, 8, "uint8", "float32")
    c, t = tensor_from_numpy(codes, "cpu"), tensor_from_numpy(cent, "cpu")
    for backend in (None, "auto", "torch"):
        np.testing.assert_array_equal(_bits(decode(c, t, backend=backend)),
                                      _bits(mgqe_decode_ref(c, t)))


# (B, D, K, S, code bytes, element bytes) -> mgqe_decode's plan (route,
# threads a block, lanes a slot, blocks) on a card of 132 SMs: deepfm's
# serve_bulk in f32 and bf16 (a 10 KB / 5 KB table in shared memory,
# 8,192 chunks of 32 rows for 264 blocks of 16 warps), gemma3-4b's
# prefill (2.6 MB table, 1,280-byte slots: through L2) in both types,
# D*S odd, the JAX bench's d = 64 table (64 KB: one block an SM), two
# tables past the smem route's limit, chunks so wide that fewer warps
# fit a block, and the backbones' 64 KB tables (d = 64 at D = 16, 8, 4:
# 16-64 byte slots) over their 500 x 101 evaluation candidates, one
# chunk a warp
@pytest.mark.parametrize("shape,plan", [
    ((262144, 5, 256, 2, 1, 4), ("smem", 512, 0, 264)),
    ((262144, 5, 256, 2, 1, 2), ("smem", 512, 0, 264)),
    ((8192, 8, 256, 320, 1, 4), ("l2", 1024, 32, 264)),
    ((8192, 8, 256, 320, 1, 2), ("l2", 1024, 32, 264)),
    ((1000, 5, 64, 3, 1, 4), ("smem", 512, 0, 2)),
    ((262144, 8, 256, 8, 1, 4), ("smem", 512, 0, 132)),
    ((1000, 4, 4096, 8, 4, 4), ("l2", 1024, 2, 8)),
    ((257, 16, 256, 16, 4, 4), ("l2", 1024, 4, 17)),
    ((262144, 200, 16, 1, 4, 2), ("smem", 96, 0, 132)),
    ((50500, 16, 256, 4, 1, 4), ("smem", 512, 0, 99)),
    ((50500, 8, 256, 8, 1, 4), ("smem", 512, 0, 99)),
    ((50500, 4, 256, 16, 1, 4), ("smem", 512, 0, 99))])
def test_mgqe_decode_plan_routes(shape, plan):
    got = decode_plan(*shape, sms=132)
    assert (got.route, got.threads, got.group, got.grid) == plan


@pytest.mark.parametrize("s", [2, 3, 17, 320])
@pytest.mark.parametrize("dk", [(1, 1), (5, 256), (8, 256), (16, 256),
                                (4, 4096), (200, 16)])
@pytest.mark.parametrize("b", [1, 262144])
def test_mgqe_decode_plan_fits_what_the_kernel_takes(b, dk, s):
    """The smem route only for tables and slots within its limits, with
    shared memory as the kernel computes it (the table and each warp's
    chunks) and within a block's limit, and no more warps than chunks of
    32 rows; else the l2 route with a power-of-two group of lanes, one
    a 16-byte vector up to 32, and no more lanes than slots need."""
    d, k = dk
    for code_bytes in (1, 4):
        for elem_bytes in (2, 4):
            slot = s * elem_bytes
            p = decode_plan(b, d, k, s, code_bytes, elem_bytes, sms=132)
            assert p.threads % 32 == 0 and 0 < p.threads <= 1024
            if p.route == "smem":
                assert d * k * slot <= SMEM_TABLE_MAX
                assert slot <= SMEM_SLOT_MAX and p.group == 0
                assert p.smem == decode_smem(d, k, slot, code_bytes,
                                             p.threads // 32) <= SMEM_MAX
                assert 1 <= p.grid
                assert (p.grid - 1) * p.threads // 32 < -(-b // 32)
                continue
            assert p.route == "l2" and p.smem == 0
            assert (d * k * slot > SMEM_TABLE_MAX or slot > SMEM_SLOT_MAX
                    or decode_smem(d, k, slot, code_bytes, 1) > SMEM_MAX)
            vec = next(v for v in (16, 8, 4, 2) if slot % v == 0)
            assert p.group & (p.group - 1) == 0
            assert min(slot // vec, 32) <= p.group <= 32
            assert 1 <= p.grid <= 2048 // p.threads * 132
            assert (p.grid - 1) * p.threads < b * d * p.group


def test_mgqe_decode_plan_takes_block_b_as_threads_a_block():
    assert decode_plan(262144, 5, 256, 2, 1, 4, 132, block_b=128).threads \
        == 128
    # the schemes' pinned decode_block_b (256): on the l2 route blocks
    # fill the card's threads all the same
    lm = decode_plan(8192, 8, 256, 320, 1, 4, 132, block_b=256)
    assert (lm.threads, lm.grid) == (256, 1056)
    # a block_b that is not whole warps (an engine's pad multiple) is
    # rounded up to them, on both routes
    for bb, threads in ((16, 32), (100, 128)):
        assert decode_plan(262144, 5, 256, 2, 1, 4, 132,
                           block_b=bb).threads == threads
        assert decode_plan(8192, 8, 256, 320, 1, 4, 132,
                           block_b=bb).threads == threads
    for bad in (0, 2048, -32):
        with pytest.raises(ValueError, match="must lie in"):
            decode_plan(262144, 5, 256, 2, 1, 4, 132, block_b=bad)


# rq_decode_stages: (code dtype, M, K, d); the stage sum of the plain
# version is the JAX reference's chain, so the rows are expected
# bit-identical; the bar is RQ_TOL (measured gap here: 0.0)
RQ_TOL = 1e-6
RQ_CASES = {
    "uint8_deepfm": (np.uint8, 5, 256, 10),
    "uint8_d64": (np.uint8, 4, 256, 64),
    "int32_k300": (np.int32, 3, 300, 8),
    "uint8_m1": (np.uint8, 1, 16, 8),
}


@pytest.mark.parametrize("case", sorted(RQ_CASES))
@pytest.mark.parametrize("b", [1, 37, 257])
def test_rq_decode_stages_plain_matches_jax(b, case):
    code_dt, m, k, d = RQ_CASES[case]
    rng = np.random.default_rng(b + m)
    codes = rng.integers(0, k, (b, m)).astype(code_dt)
    cbs = (rng.normal(size=(m, k, d)) * 0.5 ** np.arange(m)[:, None, None]
           ).astype(np.float32)
    want = np.asarray(jax_decode_stages(jnp.asarray(codes), jnp.asarray(cbs)))
    got = rq_decode_stages_ref(torch.from_numpy(codes), torch.from_numpy(cbs))
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RQ_TOL)
    # the op on CPU tensors is the plain version, whatever the request
    for backend in (None, "auto", "torch"):
        np.testing.assert_array_equal(
            _bits(decode_stages(torch.from_numpy(codes),
                                torch.from_numpy(cbs), backend=backend)),
            _bits(got))


def test_rq_decode_stages_plain_clamps_and_rounds_bf16_per_add():
    """Codes past K read row K-1 (the kernel's clamp); bfloat16 stages
    add one at a time, each add rounded to bfloat16."""
    rng = np.random.default_rng(5)
    cbs = torch.from_numpy(rng.normal(size=(3, 8, 4)).astype(np.float32))
    codes = torch.tensor([[7, 200, 9], [0, 1, 2]], dtype=torch.uint8)
    got = rq_decode_stages_ref(codes, cbs)
    np.testing.assert_array_equal(
        _bits(got[0]), _bits(cbs[0, 7] + cbs[1, 7] + cbs[2, 7]))
    bf = cbs.to(torch.bfloat16)
    want = (bf[0, 0] + bf[1, 1]) + bf[2, 2]
    np.testing.assert_array_equal(_bits(rq_decode_stages_ref(codes, bf)[1]),
                                  _bits(want))


# (B, M, K, d, code bytes, element bytes) -> rq_decode_stages' plan
# (route, threads a block, elements a vector, blocks) on a card of 132
# SMs: deepfm's serve_bulk in f32 (51,200 B of codebooks in shared
# memory, a lane a row) and bf16, both sides of the
# smem route's least batch (65,536 rows), one engine flush (3,456 rows)
# and 256 rows (through L2), int32 codes, d = 64 in bf16 (vectors of 8),
# the JAX bench's d = 64 in f32 (256 KB: through L2, a vector of 4 a
# thread), codebooks past the limit and one stage
@pytest.mark.parametrize("shape,plan", [
    ((262144, 5, 256, 10, 1, 4), ("smem", 512, 2, 264)),
    ((262144, 5, 256, 10, 1, 2), ("smem", 512, 2, 264)),
    ((65536, 5, 256, 10, 1, 4), ("smem", 512, 2, 128)),
    ((65535, 5, 256, 10, 1, 4), ("l2", 256, 2, 1280)),
    ((3456, 5, 256, 10, 1, 4), ("l2", 256, 2, 68)),
    ((256, 5, 256, 10, 1, 4), ("l2", 256, 2, 5)),
    ((100000, 3, 300, 8, 4, 4), ("smem", 512, 4, 196)),
    ((262144, 2, 256, 64, 1, 2), ("smem", 512, 8, 132)),
    ((262144, 4, 256, 64, 1, 4), ("l2", 256, 4, 16384)),
    ((262144, 4, 4096, 4, 4, 4), ("l2", 256, 4, 1024)),
    ((65536, 1, 16, 8, 1, 4), ("smem", 512, 4, 128))])
def test_rq_decode_stages_plan_routes(shape, plan):
    got = rq_plan(*shape, sms=132)
    assert (got.route, got.threads, got.vec, got.grid) == plan


@pytest.mark.parametrize("d", [1, 7, 10, 64, 300])
@pytest.mark.parametrize("mk", [(1, 16), (5, 256), (4, 256), (12, 4096)])
@pytest.mark.parametrize("b", [1, 33, 65535, 262144])
def test_rq_decode_stages_plan_fits_what_the_kernel_takes(b, mk, d):
    """The smem route only from RQ_SMEM_MIN_ROWS rows and for codebooks
    within its limit, with shared memory as the kernel computes it (the
    codebooks and each warp's offsets and chunks) and within a block's
    limit, vectors of at most 16 bytes that divide d, a lane a row, and
    no more blocks than chunks of 32 rows; else the l2 route: a vector
    of 4, 2 or 1 elements that divides d and the codebooks' alignment,
    a thread a vector, and blocks for every vector up to the grid's
    cap."""
    m, k = mk
    for code_bytes in (1, 4):
        for elem_bytes in (2, 4):
            for align in (4, 8, 16):
                p = rq_plan(b, m, k, d, code_bytes, elem_bytes, sms=132,
                            cbs_align=align)
                assert d % p.vec == 0 and p.vec * elem_bytes <= 16
                assert 0 < p.threads <= 1024 and p.grid >= 1
                if p.route == "smem":
                    assert b >= RQ_SMEM_MIN_ROWS
                    assert m * k * d * elem_bytes <= SMEM_TABLE_MAX
                    assert p.threads % 32 == 0
                    assert p.smem == rq_smem(m, k, d, code_bytes,
                                             elem_bytes,
                                             p.threads // 32) <= SMEM_MAX
                    assert (p.grid - 1) * p.threads // 32 < -(-b // 32)
                    continue
                assert p.route == "l2" and p.smem == 0
                assert (b < RQ_SMEM_MIN_ROWS
                        or m * k * d * elem_bytes > SMEM_TABLE_MAX
                        or rq_smem(m, k, d, code_bytes, elem_bytes, 1)
                        > SMEM_MAX)
                assert p.vec <= 4 and align % (p.vec * elem_bytes) == 0
                assert p.grid == min(-(-b * (d // p.vec) // p.threads),
                                     1 << 20)


def test_rq_decode_stages_plan_takes_block_b_as_threads_a_block():
    deepfm = (262144, 5, 256, 10, 1, 4)
    # the schemes' pinned decode_block_b (256): 8 warps a block
    p = rq_plan(*deepfm, sms=132, block_b=256)
    assert (p.route, p.threads) == ("smem", 256)
    # a block that is not a whole number of warps takes the l2 route,
    # with as many threads as asked
    for bb in (1, 33, 100, 1000):
        p = rq_plan(*deepfm, sms=132, block_b=bb)
        assert (p.route, p.threads, p.vec) == ("l2", bb, 2)
        assert p.grid == min(-(-262144 * 5 // bb), 1 << 20)
    # codebooks at an address 4 bytes past 16: one element a thread
    p = rq_plan(1000, 5, 256, 10, 1, 4, 132, block_b=100, cbs_align=4)
    assert (p.route, p.vec, p.grid) == ("l2", 1, 100)
    p = rq_plan(1000, 5, 256, 10, 1, 4, 132, cbs_align=8)
    assert (p.route, p.threads, p.vec) == ("l2", 256, 2)
    for bad in (0, -32, 1025, 2048):
        with pytest.raises(ValueError, match="threads per block"):
            rq_plan(*deepfm, sms=132, block_b=bad)


# (B, D, K, S): the deepfm export shape, a wide one, a long-S one
ASSIGN_SHAPES = [(4096, 5, 256, 2), (4096, 8, 256, 8), (2048, 4, 64, 16)]


def _assign_inputs(b, d, k, s, seed=0):
    rng = np.random.default_rng(seed)
    e = (rng.normal(size=(b, d, s)) * (d * s) ** -0.5).astype(np.float32)
    cent = (rng.normal(size=(d, k, s)) * (d * s) ** -0.5).astype(np.float32)
    # mixed tier budgets, the shared_k mask: K and K/4
    klim = np.where(rng.random(b) < 0.1, k, k // 4).astype(np.int32)
    return e, cent, klim


@pytest.mark.parametrize("masked", [False, True], ids=["all_k", "k_limit"])
@pytest.mark.parametrize("shape", ASSIGN_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_dpq_assign_plain_matches_jax(shape, masked):
    e, cent, klim = _assign_inputs(*shape)
    lim_j = jnp.asarray(klim) if masked else None
    lim_t = torch.from_numpy(klim) if masked else None
    want = np.asarray(jax_assign(jnp.asarray(e), jnp.asarray(cent), lim_j))
    et, ct = torch.from_numpy(e), torch.from_numpy(cent)
    flat = dpq_assign_ref(et, ct, lim_t)
    blocked = dpq_assign_blocked_ref(et, ct, lim_t, block_b=500)
    assert flat.dtype == torch.int32 and tuple(flat.shape) == shape[:2]
    np.testing.assert_array_equal(flat.numpy(), want)
    np.testing.assert_array_equal(blocked.numpy(), want)
    if masked:
        assert (flat.numpy() < klim[:, None]).all()


def test_dpq_assign_blocked_matches_jax_blocked():
    e, cent, klim = _assign_inputs(1000, 5, 256, 2, seed=3)
    want = np.asarray(jax_assign_blocked(jnp.asarray(e), jnp.asarray(cent),
                                         jnp.asarray(klim), block_b=128))
    got = dpq_assign_blocked_ref(torch.from_numpy(e), torch.from_numpy(cent),
                                 torch.from_numpy(klim), block_b=128)
    np.testing.assert_array_equal(got.numpy(), want)


# (B, D, K, S) in bfloat16: B not a multiple of the Pallas block, a
# 256-centroid table at the index's S, and S = 48 (three k-depths)
BF16_ASSIGN_SHAPES = [(257, 4, 64, 16), (512, 8, 256, 32), (128, 2, 256, 48)]


@pytest.mark.parametrize("masked", [False, True], ids=["all_k", "k_limit"])
@pytest.mark.parametrize("shape", BF16_ASSIGN_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_dpq_assign_plain_matches_jax_kernel_in_bf16(shape, masked):
    """bfloat16 inputs, rounded once and handed to both packages: the
    port's plain version gives the TPU kernel's codes (its ``interpret``
    route: f32 accumulation, ||c||^2 from the values cast to f32), bit
    for bit, on the op's CPU path too."""
    e, cent, klim = _assign_inputs(*shape, seed=shape[3])
    e16, c16 = e.astype(ml_dtypes.bfloat16), cent.astype(ml_dtypes.bfloat16)
    lim_j = jnp.asarray(klim) if masked else None
    lim_t = torch.from_numpy(klim) if masked else None
    want = np.asarray(jax_assign_kernel(jnp.asarray(e16), jnp.asarray(c16),
                                        lim_j, block_b=128, interpret=True))
    et = tensor_from_numpy(e16, "cpu")
    ct = tensor_from_numpy(c16, "cpu")
    assert et.dtype == ct.dtype == torch.bfloat16
    np.testing.assert_array_equal(dpq_assign_ref(et, ct, lim_t).numpy(), want)
    np.testing.assert_array_equal(assign(et, ct, lim_t).numpy(), want)


# every shape dpq_assign's kernel runs at on the paths: deepfm's export
# batch, the retrieval index, gemma3-4b's and gemma3-27b's token tables
KERNEL_ASSIGN_SHAPES = [(65536, 5, 256, 2), (1_000_000, 8, 64, 32),
                        (65536, 8, 256, 320), (65536, 8, 256, 672)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", KERNEL_ASSIGN_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_dpq_assign_tiles_fit_shared_memory(shape, dtype):
    """The wrapper's tile chooser (pure Python) gives an instantiated
    configuration within 227 KB of shared memory at every path shape;
    S is streamed, so gemma3-27b's 344 KB subspace table need not fit."""
    b, d, k, s = shape
    block_m, block_s = choose_tiles(dtype, b, d, k, s)
    assert smem_bytes(dtype, block_m, block_s, k, s) <= MAX_SMEM
    # enough blocks to fill the card at the paths' row counts
    assert -(-b // block_m) * d >= 264
    if dtype == torch.float32 and s <= WALK_MAX_S:
        assert (block_m, block_s) == (512, 0)             # the walk
    else:
        rows, steps = TILES[dtype]
        assert block_m in rows and block_s in steps
        # S in one k-step where an instantiated one holds it, else streamed
        assert block_s >= s or block_s == steps[-1]


@pytest.mark.parametrize("b", [6040, 3417])
@pytest.mark.parametrize("d", [16, 8, 4])
def test_dpq_assign_walks_the_backbone_tables(b, d):
    """The backbones' MGQE tables (6,040 users or 3,417 SASRec items,
    d = 64 at D = 16, 8, 4: S = 4, 8, 16) export on the float32 walk at
    its smallest row tile: too few rows to fill the card even so
    (ceil(B / 256) * D blocks, 56 to 384 for 528)."""
    s = 64 // d
    assert choose_tiles(torch.float32, b, d, 256, s) == (256, 0)
    assert smem_bytes(torch.float32, 256, 0, 256, s) <= MAX_SMEM
    assert -(-b // 256) * d < 4 * 132


def test_dpq_assign_tile_chooser_checks_what_it_is_given():
    """Every instantiated tile pair fits at any table size (S is
    streamed); a pinned pair the kernel lacks, a walk whose table does
    not fit, and a dtype the kernel does not take are refused before any
    launch."""
    for dtype, (rows, steps) in TILES.items():
        for m in rows:
            for s in steps:
                assert smem_bytes(dtype, m, s, 4096, 4096) <= MAX_SMEM
                assert choose_tiles(dtype, 100, 2, 256, 8, m, s) == (m, s)
    for m in WALK_ROWS:
        assert choose_tiles(torch.float32, 100, 2, 256, 2, m, 0) == (m, 0)
    with pytest.raises(ValueError, match="block_m in"):
        choose_tiles(torch.bfloat16, 4096, 8, 256, 320, block_m=256)
    with pytest.raises(ValueError, match="block_s in"):
        choose_tiles(torch.float32, 4096, 8, 256, 320, block_s=64)
    with pytest.raises(ValueError, match="walk takes"):
        choose_tiles(torch.float32, 4096, 8, 256, 320, block_s=0)
    with pytest.raises(ValueError, match="shared memory"):
        choose_tiles(torch.float32, 4096, 8, 20000, 2, block_s=0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        choose_tiles(torch.float16, 4096, 8, 256, 320)
    # small calls take the smallest row tile, small S the smallest step;
    # a float32 table too large to stage whole takes the tiled product
    assert choose_tiles(torch.float32, 10, 1, 256, 2) == (256, 0)
    assert choose_tiles(torch.float32, 10, 1, 20000, 2) == (64, 2)
    assert choose_tiles(torch.float32, 10, 1, 256, 16) == (256, 0)
    assert choose_tiles(torch.float32, 10, 1, 256, 32) == (64, 32)
    assert choose_tiles(torch.bfloat16, 10, 1, 256, 3) == (64, 16)


def test_dpq_assign_ties_go_to_first_index():
    """Duplicated centroids tie exactly; both packages keep the first."""
    rng = np.random.default_rng(1)
    cent = rng.normal(size=(3, 8, 2)).astype(np.float32)
    cent[:, 5] = cent[:, 2]
    e = np.repeat(cent[None, :, 2, :], 4, axis=0)      # nearest: 2 == 5
    got = assign(torch.from_numpy(e), torch.from_numpy(cent))
    want = np.asarray(jax_assign(jnp.asarray(e), jnp.asarray(cent)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() == 2).all()


def test_dpq_assign_zero_budget_gives_code_zero():
    e, cent, _ = _assign_inputs(16, 2, 8, 2)
    lim = np.zeros(16, np.int32)
    got = assign(torch.from_numpy(e), torch.from_numpy(cent),
                 torch.from_numpy(lim))
    want = np.asarray(jax_assign(jnp.asarray(e), jnp.asarray(cent),
                                 jnp.asarray(lim)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("op", ["mgqe_decode", "dpq_assign",
                                "rq_decode_stages"])
def test_cuda_wrappers_refuse_cpu_tensors(op):
    """No silent fallback: the kernel wrapper raises on CPU tensors, and
    so does the op when the cuda backend is pinned."""
    if op == "mgqe_decode":
        codes, cent = _decode_inputs(8, 5, 2, "uint8", "float32")
        args = (torch.from_numpy(codes), torch.from_numpy(cent))
        wrapper, public = mgqe_decode, decode
    elif op == "rq_decode_stages":
        codes, cent = _decode_inputs(8, 5, 2, "uint8", "float32")
        args = (torch.from_numpy(codes), torch.from_numpy(cent))
        wrapper, public = rq_decode_stages, decode_stages
    else:
        e, cent, _ = _assign_inputs(8, 5, 16, 2)
        args = (torch.from_numpy(e), torch.from_numpy(cent))
        wrapper, public = dpq_assign, assign
    before = wrapper.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        wrapper(*args)
    with pytest.raises(ValueError, match="CUDA tensors"):
        public(*args, backend="cuda")
    assert wrapper.launches == before


def test_kernel_sources_are_listed_and_hashed(tmp_path, monkeypatch):
    # each source: the TPU kernel file it replaces and its entry points
    sources = {
        "dpq_assign": ("dpq_assign/dpq_assign.py", ["dpq_assign"]),
        "embedding_bag": ("embedding_bag/embedding_bag.py",
                          ["embedding_bag"]),
        "flash_attention": ("flash_attention/flash_attention.py",
                            ["flash_attention"]),
        "mgqe_decode": ("mgqe_decode/mgqe_decode.py", ["mgqe_decode"]),
        "packed_decode": ("packed_decode/packed_decode.py",
                          ["packed_decode"]),
        "pq_score": ("pq_score/pq_score.py", ["pq_score_batched",
                                              "pq_topk"]),
        "rq_decode_stages": ("mgqe_decode/mgqe_decode.py",
                             ["rq_decode_stages"]),
    }
    assert build.sources() == sorted(sources)
    p = build.library_path("mgqe_decode")
    assert p == build.library_path("mgqe_decode")          # deterministic
    assert p != build.library_path("dpq_assign")
    assert p.parent == build.BUILD_DIR
    for name in build.sources():
        text = (build.CSRC / f"{name}.cu").read_text()
        tpu, entries = sources[name]
        assert f"src/repro/kernels/{tpu}" in text
        for fn in entries:
            assert f'extern "C" int {fn}_launch' in text


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(["mgqe_decode"])
    assert list(tmp_path.iterdir()) == []


def test_launch_counts_exact_under_threads():
    """``build.count_launch`` from eight threads with a short switch
    interval: no increment is lost (the async engine's flush and
    refresh threads both launch kernels)."""
    import sys
    import threading

    from repro_torch.kernels import build

    def wrapper():
        pass

    wrapper.launches = 0

    def work():
        for _ in range(5000):
            build.count_launch(wrapper)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == 40_000
