"""The port's CUDA kernels on the card, held to their plain versions.

Every test here is marked ``gpu`` and skips (in the ``cuda`` fixture,
at run time) where there is no card.  The file imports nothing of JAX,
so it runs on a machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu \\
        tests/test_torch_gpu.py

(``--noconftest``: the suite's conftest imports JAX.)
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import Embedding, EmbeddingConfig
from repro_torch.kernels.decode_chunks import l2_gather_plan
from repro_torch.kernels.dpq_assign import dpq_assign, dpq_assign_ref
from repro_torch.kernels.embedding_bag import (bag, embedding_bag,
                                               embedding_bag_inorder,
                                               embedding_bag_ref)
from repro_torch.kernels.embedding_bag.embedding_bag import bag_plan
from repro_torch.kernels.mgqe_decode import (mgqe_decode, mgqe_decode_ref,
                                             rq_decode_stages,
                                             rq_decode_stages_ref)
from repro_torch.kernels.mgqe_decode.mgqe_decode import (RQ_SMEM_MIN_ROWS,
                                                         decode_plan,
                                                         rq_plan)
from repro_torch.kernels.packed_decode import (pack_codes, packed_decode,
                                               packed_decode_ref)
from repro_torch.kernels.packed_decode.packed_decode import packed_plan
from repro_torch.kernels.pq_score import (INVALID_ID, pq_score,
                                          pq_score_batched,
                                          pq_score_batched_ref, pq_score_ref,
                                          pq_topk, pq_topk_ref)
from repro_torch.launch import engine
from repro_torch.retrieval import IndexConfig, get_index
from repro_torch.train.loop import on_device

# dpq_assign: the kernel's fused dot may round differently in the last
# bit from the plain version's matmul, so codes may differ only between
# distances equal to within this (distances are O(1) here)
ASSIGN_TOL = 1e-5


@pytest.fixture
def cuda():
    """The card, or a skip where there is none (decided here, at run
    time, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run with -m gpu on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16
            else t.view(torch.int32)).numpy()


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> None:
    """Bit for bit, compared on the card (the scores at B = 465, N = 1M
    are 1.9 GB); the host comparison runs only to report a mismatch."""
    assert got.shape == want.shape and got.dtype == want.dtype
    view = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    if not torch.equal(got.view(view), want.view(view)):
        np.testing.assert_array_equal(_bits(got), _bits(want))


# (code dtype, K, largest code drawn): in range, clamped (codes past K,
# as private_k lanes of other tiers carry), and int32 codes for K > 256
CODE_CASES = {
    "uint8": (np.uint8, 256, 255),
    "uint8_clamped": (np.uint8, 64, 255),
    "int32": (np.int32, 300, 299),
    "int32_clamped": (np.int32, 300, 1000),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CODE_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("b", [1, 257, 262144])
def test_mgqe_decode_kernel_matches_plain(cuda, b, dtype, case):
    code_dt, k, hi = CODE_CASES[case]
    rng = np.random.default_rng(b)
    c = torch.from_numpy(rng.integers(0, hi + 1, (b, 5)).astype(code_dt)
                         ).to(cuda)
    t = torch.from_numpy(rng.normal(size=(5, k, 2)).astype(np.float32)
                         ).to(cuda, dtype)
    before = mgqe_decode.launches
    got = mgqe_decode(c, t)
    torch.cuda.synchronize()
    assert mgqe_decode.launches == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (b, 10)
    np.testing.assert_array_equal(_bits(got), _bits(mgqe_decode_ref(c, t)))


# (D, K, S) on each decode route: deepfm's table (smem), D*S odd (smem,
# 12-byte slots), gemma3-4b's token table (l2, 1,280-byte slots); B of
# one row, around a 512-row block of 16 warps' 32-row chunks, and a
# ragged 8,195
@pytest.mark.gpu
@pytest.mark.parametrize("case", ["uint8", "int32_clamped"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("dks", [(5, 256, 2), (5, 64, 3), (8, 256, 320)],
                         ids=["deepfm", "D5S3", "lm_S320"])
@pytest.mark.parametrize("b", [1, 511, 513, 8195])
def test_mgqe_decode_kernel_routes(cuda, b, dks, dtype, case):
    d, k, s = dks
    code_dt, _, hi = CODE_CASES[case]
    rng = np.random.default_rng(b + s)
    c = torch.from_numpy(rng.integers(0, hi + 1, (b, d))
                         .astype(code_dt)).to(cuda)
    t = torch.from_numpy(rng.normal(size=(d, k, s)).astype(np.float32)
                         ).to(cuda, dtype)
    got = mgqe_decode(c, t)
    assert got.dtype == dtype and tuple(got.shape) == (b, d * s)
    _same_bits(got, mgqe_decode_ref(c, t))


@pytest.mark.gpu
@pytest.mark.parametrize("block_b", [32, 128, 1024])
def test_mgqe_decode_kernel_any_block(cuda, block_b):
    """block_b, the threads a block, changes the schedule only; B =
    262,149 leaves a ragged last chunk of rows."""
    rng = np.random.default_rng(block_b)
    c = torch.from_numpy(rng.integers(0, 256, (262149, 5)).astype(np.uint8)
                         ).to(cuda)
    t = torch.randn((5, 256, 2), device=cuda)
    _same_bits(mgqe_decode(c, t, block_b=block_b), mgqe_decode_ref(c, t))


@pytest.mark.gpu
@pytest.mark.parametrize("dks", [(5, 256, 2), (8, 256, 320)],
                         ids=["smem", "l2"])
def test_mgqe_decode_kernel_unaligned_codes(cuda, dks):
    """Codes at an odd byte address: the smem route copies its code chunks
    byte by byte instead of by cp.async; the l2 route reads codes one at
    a time either way."""
    d, k, s = dks
    rng = np.random.default_rng(3)
    codes = torch.from_numpy(rng.integers(0, k, (4099, d)).astype(np.uint8)
                             ).to(cuda)
    raw = torch.empty(4099 * d + 1, dtype=torch.uint8, device=cuda)
    shifted = raw[1:].view(4099, d)
    shifted.copy_(codes)
    assert shifted.data_ptr() % 2 == 1 and shifted.is_contiguous()
    t = torch.randn((d, k, s), device=cuda)
    _same_bits(mgqe_decode(shifted, t), mgqe_decode_ref(codes, t))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(257, 16, 256, 16), (1000, 4, 4096, 8)],
                         ids=["smem_64k", "table_past_smem"])
def test_mgqe_decode_kernel_large_tables(cuda, shape):
    b, d, k, s = shape
    rng = np.random.default_rng(0)
    c = torch.from_numpy(rng.integers(0, k, (b, d)).astype(np.int32)).to(cuda)
    t = torch.from_numpy(rng.normal(size=(d, k, s)).astype(np.float32)
                         ).to(cuda)
    np.testing.assert_array_equal(_bits(mgqe_decode(c, t)),
                                  _bits(mgqe_decode_ref(c, t)))


def _assign_case(b, d, k, s, dtype, seed, head=0.1, k_small=None):
    """e_sub (b, d, s) and centroids (d, k, s) at the init's scale, in
    ``dtype``, and mixed budgets: a ``head`` share of rows at K, the
    rest at ``k_small`` (default K // 4)."""
    rng = np.random.default_rng(seed)
    scale = (d * s) ** -0.5
    e = torch.from_numpy((rng.normal(size=(b, d, s)) * scale
                          ).astype(np.float32)).to("cuda", dtype)
    c = torch.from_numpy((rng.normal(size=(d, k, s)) * scale
                          ).astype(np.float32)).to("cuda", dtype)
    small = k // 4 if k_small is None else k_small
    klim = np.where(rng.random(b) < head, k, small).astype(np.int32)
    return e, c, torch.from_numpy(klim).to("cuda")


def _assign_gap(e, c, lim, got, want) -> float:
    """Largest float64 distance gap between the kernel's pick and the
    plain version's, over blocks of 65,536 rows; codes within budget."""
    c64 = c.double()
    c_sq = torch.sum(c64 * c64, -1)[None]
    gap = 0.0
    for i in range(0, e.shape[0], 65536):
        dist = c_sq - 2.0 * torch.einsum("bds,dks->bdk",
                                         e[i:i + 65536].double(), c64)
        a = dist.gather(-1, got[i:i + 65536].long()[..., None])
        w = dist.gather(-1, want[i:i + 65536].long()[..., None])
        gap = max(gap, float((a - w).abs().max()))
    if lim is not None:
        assert bool((got < lim[:, None].clamp(min=1)).all())
    return gap


def _plain(e, c, lim):
    """The plain assignment over blocks of 65,536 rows."""
    return torch.cat([dpq_assign_ref(e[i:i + 65536], c,
                                     None if lim is None else
                                     lim[i:i + 65536])
                      for i in range(0, e.shape[0], 65536)])


ASSIGN_DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ASSIGN_DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4096, 5, 256, 2), (4096, 8, 256, 8),
                                   (2048, 4, 64, 16), (65536, 5, 256, 2),
                                   (300, 3, 100, 3), (1000000, 8, 64, 32),
                                   (65536, 8, 256, 320),
                                   (65536, 8, 256, 672)],
                         ids=lambda s: "x".join(map(str, s)))
def test_dpq_assign_kernel_matches_plain(cuda, shape, dtype):
    """Every path shape (deepfm's export, the index, the gemma3-4b and
    gemma3-27b token tables) in both dtypes, mixed budgets: codes within
    budget, and where they differ from the plain version, the two
    distances equal to within ASSIGN_TOL."""
    b, d, k, s = shape
    e, c, lim = _assign_case(b, d, k, s, dtype, seed=b + s)
    before = dpq_assign.launches
    got = dpq_assign(e, c, lim)
    want = _plain(e, c, lim)
    torch.cuda.synchronize()
    assert dpq_assign.launches == before + 1
    assert got.shape == want.shape == (b, d)
    assert _assign_gap(e, c, lim, got, want) <= ASSIGN_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ASSIGN_DTYPES, ids=["float32", "bfloat16"])
def test_dpq_assign_kernel_every_tile(cuda, dtype):
    """Every instantiated (block_m, block_s), the float32 walk's
    included, agrees with the plain version and gives the same codes,
    since a row tile, a k-step or the walk changes the
    schedule, not a dot's order (bfloat16: the same mma chain per
    accumulator at every k-step).  B is not a multiple of any row tile;
    S = 100 is not a multiple of any k-step."""
    from repro_torch.kernels.dpq_assign.dpq_assign import (
        BLOCK_M, BLOCK_S, WALK_S, choose_tiles)
    for s in (100,) + ((WALK_S if dtype == torch.float32 else ())):
        e, c, lim = _assign_case(1000, 3, 200, s, dtype, seed=4)
        # every pair of the tunables' candidates the kernel takes here
        tiles = []
        for m in BLOCK_M.candidates[1:]:
            for bs in BLOCK_S.candidates[1:]:
                try:
                    tiles.append(choose_tiles(dtype, 1000, 3, 200, s, m, bs))
                except ValueError:
                    continue
        assert len(tiles) >= 6
        outs = [dpq_assign(e, c, lim, block_m=m, block_s=bs)
                for m, bs in tiles]
        want = dpq_assign_ref(e, c, lim)
        for got in outs:
            assert _assign_gap(e, c, lim, got, want) <= ASSIGN_TOL
            # every route sums each dot in the same order
            assert torch.equal(got, outs[0])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ASSIGN_DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (37, 2, 5, 3),
                                   (4097, 5, 256, 2), (129, 4, 70, 100),
                                   (65, 2, 130, 24)],
                         ids=lambda s: "x".join(map(str, s)))
def test_dpq_assign_kernel_ragged_edges(cuda, shape, dtype):
    """B not a multiple of the row tile, K not a multiple of the
    centroid tile, S not a multiple of the k-step (3, 100) or of a
    16-byte chunk (3, 5 x 2 bytes)."""
    b, d, k, s = shape
    e, c, lim = _assign_case(b, d, k, s, dtype, seed=s, head=0.5)
    for budget in (None, lim):
        got = dpq_assign(e, c, budget)
        want = dpq_assign_ref(e, c, budget)
        assert _assign_gap(e, c, budget, got, want) <= ASSIGN_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ASSIGN_DTYPES, ids=["float32", "bfloat16"])
def test_dpq_assign_kernel_ties_and_zero_budget(cuda, dtype):
    rng = np.random.default_rng(1)
    cent = rng.normal(size=(3, 8, 2)).astype(np.float32)
    cent[:, 5] = cent[:, 2]                       # exact tie: 2 == 5
    e = np.repeat(cent[None, :, 2, :], 4, axis=0)
    c = torch.from_numpy(cent).to(cuda, dtype)
    et = torch.from_numpy(e).to(cuda, dtype)
    assert (dpq_assign(et, c).cpu() == 2).all()
    zero = torch.zeros(4, dtype=torch.int32, device=cuda)
    assert (dpq_assign(et, c, zero).cpu() == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ASSIGN_DTYPES, ids=["float32", "bfloat16"])
def test_dpq_assign_kernel_budgets_inside_the_first_tile(cuda, dtype):
    """Row tiles whose budgets all end inside the first centroid tile
    (an MGQE tail: 64 of 256) skip the later tiles, and a nearer
    centroid past the budget never wins; one head row in a tile brings
    every later tile back for that tile alone."""
    from repro_torch.kernels.dpq_assign.dpq_assign import BLOCK_N
    b, d, k, s = 2048, 2, 256, 32
    e, c, _ = _assign_case(b, d, k, s, dtype, seed=9)
    # the exact row as a centroid past every budget: it would win
    c[:, BLOCK_N + 3] = e[5]
    lim = torch.full((b,), BLOCK_N, dtype=torch.int32, device=cuda)
    lim[1000] = k
    lim[7] = 40
    got = dpq_assign(e, c, lim)
    want = dpq_assign_ref(e, c, lim)
    assert _assign_gap(e, c, lim, got, want) <= ASSIGN_TOL
    assert bool((got[lim < k] < BLOCK_N).all())
    assert bool((got[7] < 40).all())
    assert bool((dpq_assign(e, c)[5] == BLOCK_N + 3).all())


@pytest.mark.gpu
def test_kernel_wrappers_refuse_what_they_do_not_take(cuda):
    c = torch.zeros((4, 5), dtype=torch.int64, device=cuda)
    t = torch.zeros((5, 8, 2), device=cuda)
    with pytest.raises(TypeError, match="uint8 or int32"):
        mgqe_decode(c, t)
    # dpq_assign takes float32 and bfloat16 (one dtype for both inputs)
    e = torch.zeros((4, 5, 2), device=cuda, dtype=torch.bfloat16)
    assert dpq_assign(e, t.to(torch.bfloat16)).shape == (4, 5)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        dpq_assign(e.half(), t.half())
    with pytest.raises(TypeError, match="one dtype for both"):
        dpq_assign(e, t)
    with pytest.raises(ValueError, match="contiguous"):
        mgqe_decode(c.to(torch.int32).t().contiguous().t(), t)


@pytest.mark.gpu
def test_engine_on_card_matches_cpu(cuda):
    cfg = EmbeddingConfig(vocab_size=5000, dim=10, kind="mgqe",
                          num_subspaces=5, num_centroids=256,
                          tier_boundaries=(500,),
                          tier_num_centroids=(256, 64))
    cpu = Embedding(cfg, device="cpu")
    params = cpu.init()
    art_cpu = cpu.export(params)
    card = Embedding(cfg)
    n0 = dpq_assign.launches
    art = card.export({k: v.to(cuda) for k, v in params.items()})
    assert dpq_assign.launches > n0
    eng = engine.ServingEngine(card, art)
    ref = engine.ServingEngine(cpu, art_cpu, device="cpu")
    ids = np.arange(0, 5000, 7)
    m0 = mgqe_decode.launches
    got = eng.lookup(ids).cpu()
    assert mgqe_decode.launches == m0 + 1
    want = ref.lookup(ids)
    # codes may differ only between near-equal distances; rows served
    # from identical codes are identical
    same = (art["codes"].cpu() == art_cpu["codes"]).all(1)[ids]
    assert float(same.float().mean()) > 0.99
    assert torch.equal(got[same], want[same])


# ---------------------------------------------------------- pq kernels
# Each pq kernel sums in the plain version's order: scores bit-identical,
# top-k ids and scores bit-identical, ties (scores drawn from few LUT
# values) included.

PQ_SHAPES = [(8, 64), (8, 256), (16, 64), (16, 256)]        # (D, K)


def _pq_inputs(cuda, b, n, d, k, code_dt, ties, seed=0):
    rng = np.random.default_rng(seed)
    if ties:           # multiples of 1/8 from few values: many equal sums
        luts = rng.integers(-4, 5, (b, d, k)) / 8.0
    else:
        luts = rng.normal(size=(b, d, k))
    codes = rng.integers(0, k, (n, d)).astype(code_dt)
    return (torch.from_numpy(luts.astype(np.float32)).to(cuda),
            torch.from_numpy(codes).to(cuda))


# batch sizes on both sides of every route threshold of score_plan: the
# rows route (B <= 16), the lanes route with a rows remainder (33, the
# retrieval flush's 464) and with a masked last group (465), full groups
PQ_BATCHES = [1, 5, 16, 33, 64, 464, 465]


@pytest.mark.gpu
@pytest.mark.parametrize("ties", [False, True], ids=["normal", "ties"])
@pytest.mark.parametrize("code_dt", [np.uint8, np.int32],
                         ids=["uint8", "int32"])
@pytest.mark.parametrize("dk", PQ_SHAPES, ids=lambda s: "D%dK%d" % s)
@pytest.mark.parametrize("b", PQ_BATCHES)
@pytest.mark.parametrize("n", [257, 1_000_000])
def test_pq_score_batched_kernel_matches_plain(cuda, n, b, dk, code_dt, ties):
    luts, codes = _pq_inputs(cuda, b, n, *dk, code_dt, ties)
    before = pq_score_batched.launches
    got = pq_score_batched(luts, codes)
    torch.cuda.synchronize()
    assert pq_score_batched.launches == before + 1
    assert tuple(got.shape) == (b, n)
    _same_bits(got, pq_score_batched_ref(luts, codes))


@pytest.mark.gpu
@pytest.mark.parametrize("ties", [False, True], ids=["normal", "ties"])
@pytest.mark.parametrize("code_dt", [np.uint8, np.int32],
                         ids=["uint8", "int32"])
@pytest.mark.parametrize("dk", [(5, 64), (12, 256)], ids=["D5K64", "D12K256"])
@pytest.mark.parametrize("b", [1, 16, 33, 465])
@pytest.mark.parametrize("n", [257, 1_000_000])
def test_pq_score_batched_kernel_odd_widths(cuda, n, b, dk, code_dt, ties):
    """D not a multiple of 8: code rows read four (D = 12) or one (D = 5)
    at a time on the lanes route, one at a time on the rows route."""
    luts, codes = _pq_inputs(cuda, b, n, *dk, code_dt, ties)
    _same_bits(pq_score_batched(luts, codes),
               pq_score_batched_ref(luts, codes))


@pytest.mark.gpu
@pytest.mark.parametrize("b", [5, 40])
@pytest.mark.parametrize("n", [257, 100_003])
def test_pq_score_batched_kernel_clamps_codes_past_k(cuda, n, b):
    """uint8 codes up to 255 against K = 64: every route clamps to K - 1
    (the lanes route only in the tiles that need it)."""
    luts, _ = _pq_inputs(cuda, b, n, 8, 64, np.uint8, ties=False)
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 64, (n, 8)).astype(np.uint8)
    codes[::97] = rng.integers(64, 256, codes[::97].shape)
    codes = torch.from_numpy(codes).to(cuda)
    _same_bits(pq_score_batched(luts, codes),
               pq_score_batched_ref(luts, codes))


@pytest.mark.gpu
@pytest.mark.parametrize("block_n", [1, 256, 5000, 2_000_000])
def test_pq_score_batched_kernel_any_span(cuda, block_n):
    """block_n, the candidates a block walks (rounded up to the route's
    unit), changes the schedule only: at B = 33 both routes run."""
    luts, codes = _pq_inputs(cuda, 33, 100_003, 8, 64, np.uint8, ties=True)
    _same_bits(pq_score_batched(luts, codes, block_n=block_n),
               pq_score_batched_ref(luts, codes))


@pytest.mark.gpu
@pytest.mark.parametrize("code_dt", [np.uint8, np.int32],
                         ids=["uint8", "int32"])
@pytest.mark.parametrize("dk", PQ_SHAPES, ids=lambda s: "D%dK%d" % s)
@pytest.mark.parametrize("n", [257, 1_000_000])
def test_pq_score_kernel_matches_plain(cuda, n, dk, code_dt):
    luts, codes = _pq_inputs(cuda, 1, n, *dk, code_dt, ties=False)
    before = pq_score.launches
    got = pq_score(luts[0], codes)
    torch.cuda.synchronize()
    assert pq_score.launches == before + 1
    np.testing.assert_array_equal(_bits(got),
                                  _bits(pq_score_ref(luts[0], codes)))


def _check_topk(luts, codes, k, block_n=None):
    before = pq_topk.launches
    s, i = pq_topk(luts, codes, k, block_n=block_n)
    torch.cuda.synchronize()
    assert pq_topk.launches == before + 1
    ws, wi = pq_topk_ref(luts, codes, k)
    np.testing.assert_array_equal(_bits(s), _bits(ws))
    np.testing.assert_array_equal(i.cpu().numpy(), wi.cpu().numpy())
    # and a stable descending sort of the batched kernel's own scores
    order = torch.sort(pq_score_batched(luts, codes), dim=1,
                       descending=True, stable=True)
    m = min(k, codes.shape[0])
    np.testing.assert_array_equal(_bits(s[:, :m]),
                                  _bits(order.values[:, :m]))
    np.testing.assert_array_equal(i[:, :m].cpu().numpy(),
                                  order.indices[:, :m].cpu().numpy())
    return s, i


@pytest.mark.gpu
@pytest.mark.parametrize("ties", [False, True], ids=["normal", "ties"])
@pytest.mark.parametrize("k", [1, 100])
@pytest.mark.parametrize("dk", PQ_SHAPES, ids=lambda s: "D%dK%d" % s)
@pytest.mark.parametrize("b", [1, 16, 64])
@pytest.mark.parametrize("n", [257, 1_000_000])
def test_pq_topk_kernel_matches_plain(cuda, n, b, dk, k, ties):
    luts, codes = _pq_inputs(cuda, b, n, *dk, np.uint8, ties)
    _check_topk(luts, codes, k)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [257, 1_000_000])
def test_pq_kernels_score_minus_zero_terms_as_plus_zero(cuda, n):
    """LUTs of -0.0 and +0.0: every sum starts from +0.0, as the plain
    version's (and the JAX package's) does, so no score is -0.0 and
    the top-k is a pure tie, in id order."""
    luts, codes = _pq_inputs(cuda, 4, n, 8, 64, np.uint8, ties=False)
    luts = torch.where(luts < 1.0, -0.0, 0.0).to(torch.float32)
    got = pq_score_batched(luts, codes)
    np.testing.assert_array_equal(_bits(got),
                                  _bits(pq_score_batched_ref(luts, codes)))
    assert not bool(torch.signbit(got).any())
    s, i = _check_topk(luts, codes, 100)
    assert not bool(torch.signbit(s).any())
    np.testing.assert_array_equal(i.cpu().numpy(),
                                  np.broadcast_to(np.arange(100), (4, 100)))


@pytest.mark.gpu
@pytest.mark.parametrize("code_dt", [np.uint8, np.int32],
                         ids=["uint8", "int32"])
@pytest.mark.parametrize("n,k", [(257, 300), (3, 5), (0, 4), (1, 1)])
def test_pq_topk_kernel_pads_past_n(cuda, n, k, code_dt):
    luts, codes = _pq_inputs(cuda, 4, n, 8, 64, code_dt, ties=True)
    s, i = pq_topk(luts, codes, k)
    ws, wi = pq_topk_ref(luts, codes, k)
    np.testing.assert_array_equal(_bits(s), _bits(ws))
    np.testing.assert_array_equal(i.cpu().numpy(), wi.cpu().numpy())
    assert (s[:, n:].cpu() == -np.inf).all()
    assert (i[:, n:].cpu() == INVALID_ID).all()


@pytest.mark.gpu
@pytest.mark.parametrize("block_n", [128, 1024, 8192])
def test_pq_topk_kernel_merge_rounds(cuda, block_n):
    """Small chunks leave more partial lists than one merge block takes:
    1M candidates in chunks of 128 leave 7,813 lists a query, merged in
    two rounds (1,024: 977 lists, two rounds; 8,192: 123, one)."""
    luts, codes = _pq_inputs(cuda, 16, 1_000_000, 8, 64, np.uint8, True)
    s, i = _check_topk(luts, codes, 100, block_n=block_n)
    same = s[:, 1:] == s[:, :-1]
    assert bool(same.any())                          # the ties are there
    assert bool((i[:, 1:] > i[:, :-1])[same].all())  # and in id order


def _rising(cuda, b, n):
    """LUTs and codes under which candidate n scores exactly n (its id's
    base-64 digits as the codes of the first four subspaces, each
    weighted by its place): every candidate passes every threshold."""
    ids = np.arange(n)
    codes = np.zeros((n, 8), np.uint8)
    luts = np.zeros((b, 8, 64), np.float32)
    for j in range(4):
        codes[:, j] = (ids // 64 ** (3 - j)) % 64
        luts[:, j] = np.arange(64) * float(64 ** (3 - j))
    return torch.from_numpy(luts).to(cuda), torch.from_numpy(codes).to(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["normal", "ties", "rising"])
def test_pq_topk_kernel_at_the_retrieval_flush(cuda, case):
    """The retrieval path's flush (B = 464 queries, N = 1M, k = 100):
    bit-identical to the stable sort, on random LUTs, on few LUT values
    (ties at the k-th score) and on scores rising with the id (the
    selection's worst case: every candidate passes)."""
    if case == "rising":
        luts, codes = _rising(cuda, 464, 1_000_000)
    else:
        luts, codes = _pq_inputs(cuda, 464, 1_000_000, 8, 64, np.uint8,
                                 ties=case == "ties")
    s, i = _check_topk(luts, codes, 100)
    if case == "rising":
        np.testing.assert_array_equal(
            i.cpu().numpy(), np.broadcast_to(np.arange(999_999, 999_899, -1),
                                             (464, 100)))


@pytest.mark.gpu
@pytest.mark.parametrize("ties", [False, True], ids=["normal", "ties"])
def test_pq_topk_kernel_largest_k(cuda, ties):
    """k = 8,192, the largest the kernel keeps: one query a block, a
    buffer of 16,384 pairs."""
    luts, codes = _pq_inputs(cuda, 4, 1_000_000, 8, 64, np.uint8, ties)
    _check_topk(luts, codes, 8192)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [6, 8])
def test_pq_kernels_unaligned_and_odd_width_codes(cuda, d):
    """Codes whose rows are not 8-byte aligned (or whose width is not a
    multiple of 8) take the byte-wise load."""
    luts, codes = _pq_inputs(cuda, 3, 5000, d, 64, np.uint8, ties=False)
    raw = torch.empty(5000 * d + 3, dtype=torch.uint8, device=cuda)
    shifted = raw[3:].view(5000, d)
    shifted.copy_(codes)
    assert shifted.data_ptr() % 8 != 0 and shifted.is_contiguous()
    np.testing.assert_array_equal(
        _bits(pq_score_batched(luts, shifted)),
        _bits(pq_score_batched_ref(luts, codes)))
    _check_topk(luts, shifted, 50)


@pytest.mark.gpu
def test_pq_kernels_refuse_what_they_do_not_take(cuda):
    luts, codes = _pq_inputs(cuda, 2, 100, 8, 64, np.uint8, ties=False)
    with pytest.raises(ValueError, match="k <= 8192"):
        pq_topk(luts, codes, 8193)
    with pytest.raises(ValueError, match="k <= 8192"):
        pq_topk(luts, codes, 0)
    with pytest.raises(TypeError, match="float32"):
        pq_score_batched(luts.double(), codes)
    with pytest.raises(TypeError, match="uint8 or int32"):
        pq_score_batched(luts, codes.long())
    with pytest.raises(ValueError, match="subspaces"):
        pq_topk(luts, codes[:, :4].contiguous(), 5)
    with pytest.raises(ValueError, match="contiguous"):
        pq_score_batched(luts.transpose(1, 2).contiguous().transpose(1, 2),
                         codes)
    # shapes past the kernels' own limits: refused by csrc/pq_score.cu
    with pytest.raises(RuntimeError, match="limits: csrc/pq_score.cu"):
        pq_score_batched(torch.zeros((1, 8, 4096), device=cuda), codes)
    with pytest.raises(RuntimeError, match="limits: csrc/pq_score.cu"):
        pq_topk(torch.zeros((1, 8, 4096), device=cuda), codes, 5)


@pytest.mark.gpu
def test_dpq_assign_kernel_at_the_index_shape(cuda):
    """flat_pq's corpus encode: D=8, K=64, S=32 (one centroid tile, one
    k-step), every row at the full budget."""
    b, d, k, s = 65536, 8, 64, 32
    rng = np.random.default_rng(3)
    e = torch.from_numpy((rng.normal(size=(b, d, s)) * 0.06
                          ).astype(np.float32)).to(cuda)
    c = torch.from_numpy((rng.normal(size=(d, k, s)) * 0.06
                          ).astype(np.float32)).to(cuda)
    got = dpq_assign(e, c)
    want = dpq_assign_ref(e, c)
    torch.cuda.synchronize()
    e64, c64 = e.double(), c.double()
    dist = (torch.sum(c64 * c64, -1)[None]
            - 2.0 * torch.einsum("bds,dks->bdk", e64, c64))
    gap = (dist.gather(-1, got.long()[..., None])
           - dist.gather(-1, want.long()[..., None])).abs()
    assert float(gap.max()) <= ASSIGN_TOL
    assert float((got == want).float().mean()) > 0.999


@pytest.mark.gpu
def test_retrieval_engine_on_card_matches_cpu(cuda):
    """Dyadic queries and centroids make every LUT exact in any order,
    so the card's engine and the CPU's return the same bits."""
    rng = np.random.default_rng(4)
    n, d, k = 20_000, 8, 64
    art_cpu = {
        "codes": torch.from_numpy(rng.integers(0, k, (n, d)
                                               ).astype(np.uint8)),
        "centroids": torch.from_numpy(
            (rng.integers(-4, 5, (d, k, 4)) / 4.0).astype(np.float32))}
    index = get_index(IndexConfig(num_subspaces=d, num_centroids=k))
    card = engine.RetrievalEngine(index, art_cpu, k=100, block_q=16,
                                  max_queue=64)
    cpu = engine.RetrievalEngine(index, art_cpu, k=100, block_q=16,
                                 max_queue=64, device="cpu")
    reqs = [(rng.integers(-4, 5, (int(m), 32)) / 4.0).astype(np.float32)
            for m in rng.integers(1, 17, 20)]
    outs = []
    for eng in (card, cpu):
        got = []
        for r in reqs:
            eng.submit(r)
            if eng.should_flush():
                got += eng.flush()
        got += eng.flush()
        outs.append(got)
    before, flushes = pq_topk.launches, card.stats().flushes
    st_card = card.serve_stream(reqs)
    assert pq_topk.launches - before == st_card.flushes - flushes > 0
    st_cpu = cpu.serve_stream(reqs)
    for c in ("requests", "lookups", "padded_lookups", "flushes"):
        assert getattr(st_card, c) == getattr(st_cpu, c), c
    assert len(outs[0]) == len(outs[1]) == len(reqs)
    for (cs, ci), (ps, pi) in zip(*outs):
        np.testing.assert_array_equal(_bits(cs), _bits(ps))
        np.testing.assert_array_equal(ci.cpu().numpy(), pi.numpy())


# ------------------------------------------- rq and mpe decode kernels
# Both are bit-identical to their plain versions: rq_decode_stages adds
# the stages in the plain version's order (each add rounded to bfloat16
# for bfloat16 codebooks), packed_decode is a pure gather.

# (code dtype, M, K, d, largest code drawn): deepfm's rq field; the JAX
# bench's d = 64 (256 KB of codebooks, tiled over columns); codes past K
# (clamped); int32 codes for K > 256; one stage
RQ_CASES = {
    "uint8_deepfm": (np.uint8, 5, 256, 10, 255),
    "uint8_d64": (np.uint8, 4, 256, 64, 255),
    "uint8_clamped": (np.uint8, 3, 64, 8, 255),
    "int32_k300": (np.int32, 3, 300, 8, 299),
    "int32_clamped": (np.int32, 2, 300, 8, 1000),
    "uint8_m1": (np.uint8, 1, 16, 8, 15),
}


def _rq_inputs(cuda, b, case, dtype, seed=0):
    code_dt, m, k, d, hi = RQ_CASES[case]
    rng = np.random.default_rng(seed + b)
    codes = torch.from_numpy(rng.integers(0, hi + 1, (b, m)).astype(code_dt))
    cbs = rng.normal(size=(m, k, d)) * 0.5 ** np.arange(m)[:, None, None]
    return (codes.to(cuda),
            torch.from_numpy(cbs.astype(np.float32)).to(cuda, dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(RQ_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("b", [1, 37, 257, 262144])
def test_rq_decode_stages_kernel_matches_plain(cuda, b, dtype, case):
    codes, cbs = _rq_inputs(cuda, b, case, dtype)
    before = rq_decode_stages.launches
    got = rq_decode_stages(codes, cbs)
    torch.cuda.synchronize()
    assert rq_decode_stages.launches == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (b, cbs.shape[2])
    np.testing.assert_array_equal(_bits(got),
                                  _bits(rq_decode_stages_ref(codes, cbs)))


@pytest.mark.gpu
@pytest.mark.parametrize("block_b", [1, 32, 100, 256, 1024])
@pytest.mark.parametrize("case", ["uint8_deepfm", "uint8_d64"])
def test_rq_decode_stages_kernel_any_block_size(cuda, case, block_b):
    codes, cbs = _rq_inputs(cuda, 1000, case, torch.float32)
    np.testing.assert_array_equal(
        _bits(rq_decode_stages(codes, cbs, block_b=block_b)),
        _bits(rq_decode_stages_ref(codes, cbs)))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [6, 7, 10, 12, 64])
@pytest.mark.parametrize("offset", [0, 1, 2])
def test_rq_decode_stages_kernel_widths_and_alignments(cuda, d, offset):
    """Every output width, with codebooks and output starting 0, 4 or 8
    bytes past an aligned address: the kernel picks its vector width
    from both (4, 2 or 1 elements per thread)."""
    rng = np.random.default_rng(d + offset)
    m, k, b = 3, 32, 999
    codes = torch.from_numpy(rng.integers(0, k, (b, m)).astype(np.uint8)
                             ).to(cuda)
    raw = torch.zeros(m * k * d + offset, device=cuda)
    cbs = raw[offset:].view(m, k, d)
    cbs.copy_(torch.from_numpy(rng.normal(size=(m, k, d)).astype(
        np.float32)))
    got = rq_decode_stages(codes, cbs)
    assert got.data_ptr() % 16 == 0
    np.testing.assert_array_equal(_bits(got),
                                  _bits(rq_decode_stages_ref(codes, cbs)))


@pytest.mark.gpu
def test_rq_decode_stages_kernel_large_codebooks(cuda):
    """Codebooks of 768 KB (M=12, K=4096, d=4), read through L2, and
    more stages than the kernel's load chunk of 8."""
    rng = np.random.default_rng(2)
    m, k, d = 12, 4096, 4
    codes = torch.from_numpy(rng.integers(0, k, (5000, m)).astype(np.int32)
                             ).to(cuda)
    cbs = torch.from_numpy(rng.normal(size=(m, k, d)).astype(np.float32)
                           ).to(cuda)
    np.testing.assert_array_equal(_bits(rq_decode_stages(codes, cbs)),
                                  _bits(rq_decode_stages_ref(codes, cbs)))


@pytest.mark.gpu
def test_rq_decode_stages_kernel_keeps_minus_zero(cuda):
    """Stage 0's -0.0 plus -0.0 stays -0.0: the sum starts from stage
    0's row, as the plain version's does, not from +0.0."""
    cbs = torch.full((3, 4, 16), -0.0, device=cuda)
    codes = torch.zeros((300, 3), dtype=torch.uint8, device=cuda)
    got = rq_decode_stages(codes, cbs)
    assert bool(torch.signbit(got).all())
    np.testing.assert_array_equal(_bits(got),
                                  _bits(rq_decode_stages_ref(codes, cbs)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("ds", [(5, 2), (8, 8)], ids=["D5S2", "D8S8"])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("b", [1, 37, 257, 262144])
def test_packed_decode_kernel_matches_plain(cuda, b, bits, ds, dtype):
    d, s = ds
    rng = np.random.default_rng(b + bits)
    codes = torch.from_numpy(rng.integers(0, 2 ** bits, (b, d)))
    packed = pack_codes(codes, bits).to(cuda)
    cent = torch.from_numpy(rng.normal(size=(d, 2 ** bits, s)).astype(
        np.float32)).to(cuda, dtype)
    before = packed_decode.launches
    got = packed_decode(packed, cent, bits)
    torch.cuda.synchronize()
    assert packed_decode.launches == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (b, d * s)
    np.testing.assert_array_equal(_bits(got),
                                  _bits(packed_decode_ref(packed, cent, bits)))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(16, 256, 16, 8), (5, 64, 2, 2),
                                   (3, 300, 4, 8)],
                         ids=["table_past_smem", "k_past_2bits", "k300"])
def test_packed_decode_kernel_other_tables(cuda, shape):
    """A table past the shared-memory budget (read through L2), and
    tables with more centroids than the codes address."""
    d, k, s, bits = shape
    rng = np.random.default_rng(0)
    codes = torch.from_numpy(rng.integers(0, 2 ** bits, (1000, d)))
    packed = pack_codes(codes, bits).to(cuda)
    cent = torch.from_numpy(rng.normal(size=(d, k, s)).astype(np.float32)
                            ).to(cuda)
    np.testing.assert_array_equal(_bits(packed_decode(packed, cent, bits)),
                                  _bits(packed_decode_ref(packed, cent, bits)))


@pytest.mark.gpu
def test_rq_and_packed_wrappers_refuse_what_they_do_not_take(cuda):
    cbs = torch.zeros((3, 8, 4), device=cuda)
    with pytest.raises(TypeError, match="uint8 or int32"):
        rq_decode_stages(torch.zeros((4, 3), dtype=torch.int64,
                                     device=cuda), cbs)
    with pytest.raises(ValueError, match="stages"):
        rq_decode_stages(torch.zeros((4, 2), dtype=torch.uint8,
                                     device=cuda), cbs)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rq_decode_stages(torch.zeros((4, 3), dtype=torch.uint8,
                                     device=cuda), cbs.double())
    with pytest.raises(ValueError, match="threads per block"):
        rq_decode_stages(torch.zeros((4, 3), dtype=torch.uint8,
                                     device=cuda), cbs, block_b=2048)
    cent = torch.zeros((5, 16, 2), device=cuda)
    with pytest.raises(ValueError, match="packed width"):
        packed_decode(torch.zeros((4, 2), dtype=torch.uint8, device=cuda),
                      cent, 4)
    with pytest.raises(ValueError, match="K >= 2"):
        packed_decode(torch.zeros((4, 5), dtype=torch.uint8, device=cuda),
                      cent, 8)
    with pytest.raises(TypeError, match="uint8"):
        packed_decode(torch.zeros((4, 3), dtype=torch.int32, device=cuda),
                      cent, 4)
    with pytest.raises(ValueError, match="contiguous"):
        packed_decode(torch.zeros((3, 4), dtype=torch.uint8,
                                  device=cuda).t(), cent, 4)


# the two routes of the redesigned decode kernels, each taken at shapes
# the planner would send down the other one too: B of one row, a chunk
# of 32 rows either side of 31 and 33, a ragged 257 and serve_bulk
ROUTE_BATCHES = [1, 31, 33, 257, 262144]


def _packed_route(route, b, d, s, bits, elem_bytes):
    """packed_plan's smem plan, or the l2 route (256 threads a block)."""
    if route == "smem":
        plan = packed_plan(b, d, s, bits, elem_bytes, sms=132)
        assert plan.route == "smem"
        return plan
    return l2_gather_plan(b, d, s * elem_bytes, sms=132, block_b=256)


def _packed_case(cuda, b, d, k, s, bits, dtype, seed):
    rng = np.random.default_rng(seed)
    codes = torch.from_numpy(rng.integers(0, 2 ** bits, (b, d)))
    cent = torch.from_numpy(rng.normal(size=(d, k, s)).astype(np.float32)
                            ).to(cuda, dtype)
    return pack_codes(codes, bits).to(cuda), cent


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["smem", "l2"])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("b", ROUTE_BATCHES)
def test_packed_decode_kernel_routes(cuda, b, bits, route, dtype):
    """Each mpe tier (D=5, S=2, K = 2^bits) on both routes, bit for bit."""
    packed, cent = _packed_case(cuda, b, 5, 2 ** bits, 2, bits, dtype,
                                b + bits)
    plan = _packed_route(route, b, 5, 2, bits, cent.element_size())
    got = packed_decode(packed, cent, bits, plan=plan)
    assert got.dtype == dtype and tuple(got.shape) == (b, 10)
    _same_bits(got, packed_decode_ref(packed, cent, bits))


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["smem", "l2"])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_packed_decode_kernel_unaligned_packed(cuda, bits, route):
    """Packed bytes at an odd address (a storage offset of one byte):
    the smem route copies its chunks byte by byte instead of by
    cp.async."""
    packed, cent = _packed_case(cuda, 4099, 5, 2 ** bits, 2, bits,
                                torch.float32, bits)
    raw = torch.empty(packed.numel() + 1, dtype=torch.uint8, device=cuda)
    shifted = raw[1:].view(packed.shape)
    shifted.copy_(packed)
    assert shifted.data_ptr() % 2 == 1 and shifted.is_contiguous()
    plan = _packed_route(route, 4099, 5, 2, bits, 4)
    _same_bits(packed_decode(shifted, cent, bits, plan=plan),
               packed_decode_ref(packed, cent, bits))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["smem", "l2"])
@pytest.mark.parametrize("shape", [(5, 64, 2, 2), (8, 17, 8, 4),
                                   (5, 300, 1, 8)],
                         ids=["k64_bits2", "k17_bits4", "k300_s1_bits8"])
def test_packed_decode_kernel_tier_table_past_2bits(cuda, shape, route,
                                                    dtype):
    """Tables with more rows than a code addresses: the smem route
    stages only the 2^bits rows of each subspace (byte by byte where a
    subspace does not start 16-byte aligned, as at K=300, S=1)."""
    d, k, s, bits = shape
    packed, cent = _packed_case(cuda, 1025, d, k, s, bits, dtype, k)
    plan = _packed_route(route, 1025, d, s, bits, cent.element_size())
    _same_bits(packed_decode(packed, cent, bits, plan=plan),
               packed_decode_ref(packed, cent, bits))


def _rq_route(route, b, codes, cbs):
    """rq_plan's smem plan (its choice from RQ_SMEM_MIN_ROWS rows) or its
    l2 plan (its choice below), at any B: each route's blocks walk the rows
    in strides, so a grid planned for more or fewer rows covers B."""
    m, k, d = cbs.shape
    cb, eb = codes.element_size(), cbs.element_size()
    if route == "l2":
        plan = rq_plan(min(b, RQ_SMEM_MIN_ROWS - 1), m, k, d, cb, eb, 132)
        assert plan.route == "l2"
        return plan
    plan = rq_plan(max(b, RQ_SMEM_MIN_ROWS), m, k, d, cb, eb, 132)
    assert plan.route == "smem"
    return plan


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["smem", "l2"])
@pytest.mark.parametrize("b", ROUTE_BATCHES)
def test_rq_decode_stages_kernel_routes(cuda, b, route, dtype):
    """deepfm's rq codebooks (M=5, K=256, d=10) on both routes, bit for
    bit."""
    codes, cbs = _rq_inputs(cuda, b, "uint8_deepfm", dtype)
    got = rq_decode_stages(codes, cbs, plan=_rq_route(route, b, codes, cbs))
    assert got.dtype == dtype and tuple(got.shape) == (b, 10)
    _same_bits(got, rq_decode_stages_ref(codes, cbs))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["smem", "l2"])
def test_rq_decode_stages_kernel_int32_codes_past_k(cuda, route, dtype):
    """int32 codes past K read row K-1 and negative ones row 0."""
    rng = np.random.default_rng(9)
    m, k, d, b = 3, 300, 8, 2049
    codes = rng.integers(-50, 1000, (b, m)).astype(np.int32)
    codes[:10] = [[-1, 300, 299]] * 10
    codes = torch.from_numpy(codes).to(cuda)
    cbs = torch.from_numpy(rng.normal(size=(m, k, d)).astype(np.float32)
                           ).to(cuda, dtype)
    got = rq_decode_stages(codes, cbs, plan=_rq_route(route, b, codes, cbs))
    _same_bits(got, rq_decode_stages_ref(codes, cbs))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["smem", "l2"])
@pytest.mark.parametrize("m", [1, 4, 5, 8, 9, 12])
def test_rq_decode_stages_kernel_stage_counts(cuda, m, route, dtype):
    """The counts the smem route unrolls (4, 5) and others it walks 8
    at a time (1, 8, 9, 12), each in the plain version's order."""
    rng = np.random.default_rng(m)
    k, d, b = 32, 6, 3000
    codes = torch.from_numpy(rng.integers(0, k, (b, m)).astype(np.uint8)
                             ).to(cuda)
    cbs = rng.normal(size=(m, k, d)) * 0.5 ** np.arange(m)[:, None, None]
    cbs = torch.from_numpy(cbs.astype(np.float32)).to(cuda, dtype)
    got = rq_decode_stages(codes, cbs, plan=_rq_route(route, b, codes, cbs))
    _same_bits(got, rq_decode_stages_ref(codes, cbs))


@pytest.mark.gpu
@pytest.mark.parametrize("code_dt", [np.uint8, np.int32],
                         ids=["uint8", "int32"])
@pytest.mark.parametrize("route", ["smem", "l2"])
def test_rq_decode_stages_kernel_unaligned_codes(cuda, route, code_dt):
    """Codes at an address 1 (uint8) or 4 (int32) bytes past 16: the
    smem route copies its chunks byte by byte."""
    rng = np.random.default_rng(4)
    b, m = 4099, 5
    codes = torch.from_numpy(rng.integers(0, 256, (b, m)).astype(code_dt)
                             ).to(cuda)
    raw = torch.empty(b * m + 1, dtype=codes.dtype, device=cuda)
    shifted = raw[1:].view(b, m)
    shifted.copy_(codes)
    assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
    cbs = torch.randn((m, 256, 10), device=cuda)
    got = rq_decode_stages(shifted, cbs,
                           plan=_rq_route(route, b, shifted, cbs))
    _same_bits(got, rq_decode_stages_ref(codes, cbs))


@pytest.mark.gpu
def test_decode_wrappers_raise_on_plans_their_kernels_refuse(cuda):
    """A plan the kernel cannot run is refused by the entry point and
    raised by the wrapper: nothing launches."""
    packed, cent = _packed_case(cuda, 100, 5, 256, 2, 8, torch.float32, 0)
    p = packed_plan(100, 5, 2, 8, 4, sms=132)
    codes, cbs = _rq_inputs(cuda, 100, "uint8_deepfm", torch.float32)
    q = _rq_route("smem", 100, codes, cbs)
    l2 = _rq_route("l2", 100, codes, cbs)
    before = (packed_decode.launches, rq_decode_stages.launches)
    for bad in (p._replace(smem=p.smem + 16), p._replace(threads=100),
                p._replace(route="l2", group=3, smem=0),
                p._replace(grid=0)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            packed_decode(packed, cent, 8, plan=bad)
    big = torch.zeros((4, 256, 64), device=cuda)      # 256 KB: past smem
    shifted = torch.zeros(5 * 256 * 10 + 1, device=cuda)[1:].view(5, 256, 10)
    for args, bad in (((codes, cbs), q._replace(vec=4)),
                      ((codes, cbs), q._replace(threads=100)),
                      ((codes, cbs), q._replace(smem=q.smem - 16)),
                      ((codes[:, :4].contiguous(), big), q),
                      ((codes, cbs), l2._replace(vec=8)),
                      ((codes, shifted), l2)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            rq_decode_stages(*args, plan=bad)
    assert (packed_decode.launches, rq_decode_stages.launches) == before
    for bad in (0, 2048):
        with pytest.raises(ValueError, match="must lie in"):
            packed_decode(packed, cent, 8, block_b=bad)


MPE_ENGINE = dict(vocab_size=5000, dim=10, kind="mpe", num_subspaces=5,
                  tier_boundaries=(250, 1250), tier_bits=(8, 4, 2))
RQ_ENGINE = dict(vocab_size=5000, dim=10, kind="rq", num_levels=5,
                 num_centroids=256)


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [RQ_ENGINE, MPE_ENGINE], ids=["rq", "mpe"])
def test_rq_and_mpe_engines_on_card_match_cpu(cuda, kw):
    """Export on the card and on the CPU from the same params, then
    serve through both engines: codes equal except at near-ties, rows
    bit-identical wherever the codes are, one kernel launch per flush
    (per tier, for mpe)."""
    cfg = EmbeddingConfig(**kw)
    cpu = Embedding(cfg, device="cpu")
    params = cpu.init()
    art_cpu = cpu.export(params)
    card = Embedding(cfg)
    art = card.export({k: (v.to(cuda) if isinstance(v, torch.Tensor)
                           else [t.to(cuda) for t in v])
                       for k, v in params.items()})
    codes = art["codes"] if isinstance(art["codes"], list) \
        else [art["codes"]]
    codes_cpu = art_cpu["codes"] if isinstance(art_cpu["codes"], list) \
        else [art_cpu["codes"]]
    same = torch.ones(cfg.vocab_size, dtype=torch.bool)
    for c, w in zip(codes, codes_cpu):
        same &= (c.cpu() == w).all(1)
    assert float(same.float().mean()) > 0.99
    ids = np.arange(0, 5000, 7)
    counter = rq_decode_stages if cfg.kind == "rq" else packed_decode
    per_flush = 1 if cfg.kind == "rq" else len(cfg.tier_bits)
    before = counter.launches
    got = engine.ServingEngine(card, art).lookup(ids).cpu()
    assert counter.launches == before + per_flush
    want = engine.ServingEngine(cpu, art_cpu, device="cpu").lookup(ids)
    keep = same[ids]
    assert torch.equal(got[keep], want[keep])


@pytest.mark.gpu
@pytest.mark.parametrize("block_b", [1, 48, 100, 256])
@pytest.mark.parametrize("kw", [RQ_ENGINE, MPE_ENGINE], ids=["rq", "mpe"])
def test_rq_and_mpe_engines_on_card_take_any_block_b(cuda, kw, block_b):
    """An engine pads its flushes to ``block_b``, any count in [1,
    1024]; the decode kernels take it as threads a block (packed_decode
    rounded up to whole warps, rq_decode_stages on its l2 route where it
    is not whole warps).  The card's rows equal the CPU engine's on the
    same artifact, bit for bit."""
    cfg = EmbeddingConfig(**kw)
    cpu = Embedding(cfg, device="cpu")
    art = cpu.export(cpu.init())
    ids = np.arange(0, 5000, 7)
    counter = rq_decode_stages if cfg.kind == "rq" else packed_decode
    before = counter.launches
    eng = engine.ServingEngine(cpu, art, block_b=block_b, device=cuda)
    got = eng.lookup(ids).cpu()
    assert counter.launches > before and eng.pad_multiple == block_b
    want = engine.ServingEngine(cpu, art, block_b=block_b,
                                device="cpu").lookup(ids)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


MGQE_ENGINE = dict(vocab_size=5000, dim=10, kind="mgqe", num_subspaces=5,
                  num_centroids=256, tier_boundaries=(500,),
                  tier_num_centroids=(256, 64))
DPQ_ENGINE = dict(vocab_size=5000, dim=10, kind="dpq", num_subspaces=5,
                  num_centroids=256)


@pytest.mark.gpu
@pytest.mark.parametrize("block_b", [48, 100])
@pytest.mark.parametrize("kw", [MGQE_ENGINE, DPQ_ENGINE], ids=["mgqe", "dpq"])
def test_mgqe_and_dpq_engines_on_card_take_any_block_b(cuda, kw, block_b):
    """An mgqe or dpq engine pads its flushes to ``block_b``, any count
    in [1, 1024]; mgqe_decode takes it as threads a block rounded up to
    whole warps.  The card's rows equal the CPU engine's (the plain
    decode) on the same artifact, bit for bit, one launch a flush."""
    cfg = EmbeddingConfig(**kw)
    cpu = Embedding(cfg, device="cpu")
    art = cpu.export(cpu.init())
    ids = np.arange(0, 5000, 7)
    before = mgqe_decode.launches
    eng = engine.ServingEngine(cpu, art, block_b=block_b, device=cuda)
    got = eng.lookup(ids).cpu()
    assert mgqe_decode.launches == before + 1
    assert eng.pad_multiple == block_b
    want = engine.ServingEngine(cpu, art, block_b=block_b,
                                device="cpu").lookup(ids)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# ---------------------------------------------------------- embedding_bag

def _bag_inputs(b, v, d, dtype, weighted, seed, dev, max_len=64):
    """A table (v, d), b bags of 0..max_len uniform ids (some empty),
    the sorted segment ids and, if ``weighted``, float32 weights."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, max_len + 1, b)
    if b > 2:
        lens[[0, b // 2]] = 0                       # empty bags inside
    seg = np.repeat(np.arange(b), lens)
    ids = rng.integers(0, v, seg.size)
    table = torch.from_numpy(rng.normal(size=(v, d)).astype(np.float32))
    w = (torch.from_numpy(rng.normal(size=seg.size).astype(np.float32))
         .to(dev) if weighted else None)
    return (table.to(dtype).to(dev), torch.from_numpy(ids).to(dev),
            torch.from_numpy(seg).to(dev), w)


@pytest.mark.gpu
@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("d", [10, 256])
@pytest.mark.parametrize("b", [1, 257])
def test_embedding_bag_kernel_matches_plain(cuda, b, d, dtype, weighted):
    """Bit-identical to the in-order version, on the card and on the
    CPU; within the plain version's bar of it (float32: 1e-5 of the
    bag's sum of |row * w|, the atomics' order; bfloat16: a rounding
    per product and add, (terms + 1) * 2^-8 of that sum)."""
    table, ids, seg, w = _bag_inputs(b, 1000, d, dtype, weighted, b + d,
                                     cuda)
    before = embedding_bag.launches
    got = embedding_bag(table, ids, seg, b, w)
    torch.cuda.synchronize()
    assert embedding_bag.launches == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (b, d)
    rows = table.index_select(0, ids).cpu()
    want = embedding_bag_inorder(rows, torch.arange(ids.numel()), seg.cpu(),
                                 b, None if w is None else w.cpu())
    assert np.array_equal(_bits(got), _bits(want))
    inorder = embedding_bag_inorder(table, ids, seg, b, w)
    assert np.array_equal(_bits(got), _bits(inorder))
    plain = embedding_bag_ref(table, ids, seg, b, w)
    absw = rows.float().abs() * (1.0 if w is None else w.cpu().abs()[:, None])
    abs_sum = torch.zeros(b, d).index_add(0, seg.cpu(), absw)
    n = torch.bincount(seg.cpu(), minlength=b)[:, None]
    bar = (1e-5 if dtype == torch.float32 else (n + 1) * 2.0 ** -8) * abs_sum
    assert bool(((got.float() - plain.float()).abs().cpu() <= bar).all())
    empty = torch.bincount(seg, minlength=b) == 0
    assert bool((got[empty] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("d,offset", [(1, 0), (3, 1), (8, 1), (17, 0),
                                      (64, 1), (96, 0)])
def test_embedding_bag_kernel_widths_and_alignments(cuda, d, offset):
    """Widths with every vector size and lane count, tables that start
    one row into their storage (another alignment), int64 indices."""
    for dtype in (torch.float32, torch.bfloat16):
        full, ids, seg, w = _bag_inputs(100, 301, d, dtype, True, d, cuda)
        table = full[offset:]
        ids = ids.clamp(max=table.shape[0] - 1)
        got = embedding_bag(table, ids, seg, 100, w)
        rows = table.index_select(0, ids).cpu()
        want = embedding_bag_inorder(rows, torch.arange(ids.numel()),
                                     seg.cpu(), 100, w.cpu())
        assert np.array_equal(_bits(got), _bits(want))
        got32 = embedding_bag(table, ids.int(), seg.int(), 100, w)
        assert np.array_equal(_bits(got32), _bits(want))


@pytest.mark.gpu
def test_embedding_bag_kernel_edges(cuda):
    """No ids at all (every bag zero), ids outside the table (clamped,
    as the plain version clamps), a bag of 5,000 ids."""
    table = torch.randn((50, 10), device=cuda)
    none = torch.zeros(0, dtype=torch.int64, device=cuda)
    out = embedding_bag(table, none, none, 7)
    assert tuple(out.shape) == (7, 10) and bool((out == 0).all())
    ids = torch.tensor([-4, 0, 49, 77], device=cuda)
    seg = torch.tensor([0, 0, 1, 1], device=cuda)
    assert torch.equal(embedding_bag(table, ids, seg, 2),
                       embedding_bag_inorder(table, ids, seg, 2))
    big = torch.randint(0, 50, (5000,), device=cuda)
    one = torch.zeros(5000, dtype=torch.int64, device=cuda)
    got = embedding_bag(table, big, one, 1)
    want = embedding_bag_inorder(table.index_select(0, big).cpu(),
                                 torch.arange(5000), one.cpu(), 1)
    assert np.array_equal(_bits(got), _bits(want))


def _bag_same_as_inorder(table, ids, seg, b, w=None, plan=None):
    """One launch of the kernel, bit-identical to the in-order version
    over the gathered rows on the CPU."""
    before = embedding_bag.launches
    got = embedding_bag(table, ids, seg, b, w, plan=plan)
    torch.cuda.synchronize()
    assert embedding_bag.launches == before + 1
    rows = table.index_select(0, ids.long().clamp(0, table.shape[0] - 1))
    want = embedding_bag_inorder(rows.cpu(), torch.arange(ids.numel()),
                                 seg.cpu(), b, None if w is None else w.cpu())
    assert got.dtype == table.dtype and tuple(got.shape) == (b, table.shape[1])
    assert np.array_equal(_bits(got), _bits(want))
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("d", [10, 256])
def test_embedding_bag_kernel_bag_longer_than_a_chunk(cuda, d, dtype):
    """A bag of three chunks and more, between ragged ones, summed over
    each chunk in turn in id order."""
    rng = np.random.default_rng(d)
    p = bag_plan(50, d, dtype.itemsize, 8, 132)
    lens = rng.integers(0, 40, 50)
    lens[[3, 4]] = 0
    lens[10] = 3 * p.chunk + 5
    seg = torch.from_numpy(np.repeat(np.arange(50), lens)).to(cuda)
    ids = torch.from_numpy(rng.integers(0, 2000, seg.numel())).to(cuda)
    w = torch.from_numpy(rng.normal(size=seg.numel()).astype(np.float32)
                         ).to(cuda)
    table = torch.randn((2000, d), device=cuda).to(dtype)
    for ww in (None, w):
        _bag_same_as_inorder(table, ids, seg, 50, ww)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("d", [10, 256])
def test_embedding_bag_kernel_every_id_in_one_bag(cuda, d, dtype):
    """One bag holding every id of a 5,000-row table once: one tile,
    many chunks."""
    perm = torch.randperm(5000, device=cuda)
    seg = torch.zeros(5000, dtype=torch.int64, device=cuda)
    table = torch.randn((5000, d), device=cuda).to(dtype)
    w = torch.randn(5000, device=cuda)
    _bag_same_as_inorder(table, perm, seg, 1, w)
    _bag_same_as_inorder(table, perm.int(), seg.int(), 1)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 257, 4096])
def test_embedding_bag_kernel_all_bags_empty(cuda, b):
    """No ids at all, and ids only in the last of b bags: every other
    bag zero, one launch each."""
    table = torch.randn((100, 10), device=cuda)
    none = torch.zeros(0, dtype=torch.int32, device=cuda)
    out = _bag_same_as_inorder(table, none, none, b)
    assert bool((out == 0).all())
    ids = torch.arange(7, device=cuda, dtype=torch.int32)
    seg = torch.full((7,), b - 1, dtype=torch.int32, device=cuda)
    out = _bag_same_as_inorder(table, ids, seg, b)
    assert bool((out[:-1] == 0).all())


def _zipf_lens(b, total, cap, a=1.1, seed=0):
    """b bag lengths floor(c * rank^-a), at most cap, summing to about
    total, in a random order."""
    r = np.arange(1, b + 1, dtype=np.float64) ** -a
    lo, hi = 0.0, float(total)
    for _ in range(60):
        c = (lo + hi) / 2
        lo, hi = (c, hi) if np.minimum(np.floor(c * r), cap).sum() < total \
            else (lo, c)
    lens = np.minimum(np.floor(hi * r), cap).astype(np.int64)
    return np.random.default_rng(seed).permutation(lens)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("d", [10, 256])
def test_embedding_bag_kernel_zipf_bags(cuda, d, dtype):
    """4,096 bags whose lengths follow a Zipf law (exponent 1.1, at most
    16,384 ids a bag, about 130,000 in all): the longest bag spans many
    chunks, most bags hold one id or a few."""
    lens = _zipf_lens(4096, 130_000, 16384, seed=d)
    assert lens.max() == 16384 and abs(lens.sum() - 130_000) < 200
    rng = np.random.default_rng(d)
    seg = torch.from_numpy(np.repeat(np.arange(4096), lens)).to(cuda)
    ids = torch.from_numpy(rng.integers(0, 1000, seg.numel())).to(cuda)
    w = torch.from_numpy(rng.normal(size=seg.numel()).astype(np.float32)
                         ).to(cuda)
    table = torch.randn((1000, d), device=cuda).to(dtype)
    _bag_same_as_inorder(table, ids, seg, 4096, w)


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [None, 1, 3])
@pytest.mark.parametrize("d", [10, 64])
def test_embedding_bag_kernel_tile_borders(cuda, d, chunk):
    """Empty bags on both sides of every tile border (tiles of 51 bags
    at d = 10 and 16 at d = 64, the most a block's threads cover, and
    chunks of 1 or 3 ids where given): each tile's span from the warp
    search, each bag's start from the adjacent difference."""
    rng = np.random.default_rng(d)
    b = 200
    p = bag_plan(b, d, 4, 8, 132)
    tile = 256 // p.slab                    # a thread a (bag, vector)
    p = p._replace(tile=tile, grid_x=-(-b // tile),
                   chunk=p.chunk if chunk is None else chunk)
    lens = rng.integers(1, 9, b)
    for border in range(tile, b, tile):
        lens[border - 1:border + 1] = 0
    seg = torch.from_numpy(np.repeat(np.arange(b), lens)).to(cuda)
    ids = torch.from_numpy(rng.integers(0, 500, seg.numel())).to(cuda)
    table = torch.randn((500, d), device=cuda)
    from repro_torch.kernels.embedding_bag.embedding_bag import bag_smem
    p = p._replace(smem=bag_smem(p.tile, p.chunk, p.slab, p.vec * 4, 8))
    out = _bag_same_as_inorder(table, ids, seg, b, plan=p)
    assert bool((out[torch.from_numpy(lens == 0)] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("d", [8, 10, 256, 3])
def test_embedding_bag_kernel_bf16_subnormals_and_extremes(cuda, d):
    """bfloat16 rows from 2^-140 to 2^10 (subnormal ones included) and
    weights from 2^-20 to 2^20: the kernel's packed bfloat16 products
    and sums (one rounding of the exact result) equal the in-order
    version's float32 operations rounded to bfloat16, bit for bit; d = 3
    takes the lone-element path."""
    g = torch.Generator().manual_seed(d)
    mag = torch.randint(-140, 10, (500, d), generator=g).float()
    sign = torch.randint(0, 2, (500, d), generator=g).float() * 2 - 1
    table = (sign * torch.exp2(mag)
             * (1 + torch.rand((500, d), generator=g))).bfloat16()
    lens = torch.randint(0, 40, (64,), generator=g)
    seg = torch.repeat_interleave(torch.arange(64), lens)
    ids = torch.randint(0, 500, (seg.numel(),), generator=g)
    w = (torch.exp2(torch.randint(-20, 20, (seg.numel(),),
                                  generator=g).float())
         * torch.randn(seg.numel(), generator=g)).bfloat16()
    for ww in (None, w):
        _bag_same_as_inorder(table.to(cuda), ids.to(cuda), seg.to(cuda), 64,
                             None if ww is None else ww.to(cuda))


@pytest.mark.gpu
def test_embedding_bag_kernel_refuses_bad_plans(cuda):
    """A plan the kernel cannot run is refused by the entry point and
    raised by the wrapper: nothing launches."""
    table = torch.randn((100, 10), device=cuda)
    ids = torch.randint(0, 100, (300,), device=cuda)
    seg = torch.sort(torch.randint(0, 40, (300,), device=cuda)).values
    p = bag_plan(40, 10, 4, 8, 132)
    before = embedding_bag.launches
    for bad in (p._replace(smem=p.smem + 16), p._replace(threads=128),
                p._replace(vec=4), p._replace(tile=p.tile + 1),
                p._replace(grid_x=p.grid_x + 1), p._replace(slab=6),
                p._replace(chunk=0)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            embedding_bag(table, ids, seg, 40, plan=bad)
    assert embedding_bag.launches == before


@pytest.mark.gpu
def test_embedding_bag_kernel_refuses_grad_and_bad_inputs(cuda):
    table, ids, seg, w = _bag_inputs(9, 40, 8, torch.float32, True, 0, cuda)
    before = embedding_bag.launches
    with pytest.raises(RuntimeError, match="no backward"):
        embedding_bag(table.requires_grad_(True), ids, seg, 9, w)
    with pytest.raises(RuntimeError, match="no backward"):
        bag(table, ids, seg, 9, w)                 # auto -> the kernel
    table.requires_grad_(False)
    with pytest.raises(RuntimeError, match="no backward"):
        embedding_bag(table, ids, seg, 9, w.clone().requires_grad_(True))
    assert embedding_bag.launches == before
    with torch.no_grad():
        embedding_bag(table.requires_grad_(True), ids, seg, 9, w)
    table.requires_grad_(False)
    # the plain version stays differentiable on the card
    t = table.clone().requires_grad_(True)
    embedding_bag_ref(t, ids, seg, 9, w).sum().backward()
    assert t.grad is not None
    with pytest.raises(ValueError, match="CUDA tensors"):
        embedding_bag(table, ids.cpu(), seg, 9)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        embedding_bag(table.double(), ids, seg, 9)
    with pytest.raises(TypeError, match="int32 or int64"):
        embedding_bag(table, ids.float(), seg, 9)
    with pytest.raises(ValueError, match="contiguous"):
        embedding_bag(table.t(), ids, seg, 9)


@pytest.mark.gpu
def test_fields_embedding_bag_on_card(cuda):
    """sum and mean launch the kernel once each, bit-identical to the
    in-order version on the CPU (mean: divided by the bag's count); max
    launches nothing and equals the plain ops on the CPU."""
    from repro_torch.models.recsys import fields
    table, ids, seg, w = _bag_inputs(257, 500, 10, torch.float32, True, 3,
                                     cuda)
    for mode, ww, launches in (("sum", w, 1), ("mean", None, 1),
                               ("max", w, 0)):
        before = embedding_bag.launches
        got = fields.embedding_bag(table, ids, seg, 257, ww, mode=mode)
        torch.cuda.synchronize()
        assert embedding_bag.launches == before + launches
        args = (table.cpu(), ids.cpu(), seg.cpu(), 257,
                None if ww is None else ww.cpu())
        if mode == "max":
            want = fields.embedding_bag(*args, mode=mode)
        else:
            want = embedding_bag_inorder(*args)
            if mode == "mean":
                n = torch.bincount(args[2], minlength=257).float()
                want = want / torch.clamp(n, min=1.0)[:, None]
        assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.gpu
def test_deepfm_train_step_on_card_matches_cpu(cuda):
    """One adagrad step of the smoke DeepFM on the card and on the CPU
    from the same params and batch: the MGQE fields' codes equal, loss
    within 1e-5, every param and accumulator within 1e-5."""
    from repro_torch.configs import get_arch
    from repro_torch.core import dpq
    from repro_torch.core.mgqe import _tier_k_limits
    from repro_torch.core.schemes.base import tree_leaves, tree_map
    from repro_torch.data.synthetic import CTRStream
    from repro_torch.models.recsys.deepfm import DeepFM
    from repro_torch.train import optimizer as opt
    _, cfg = get_arch("deepfm", smoke=True)
    ocfg = opt.OptimizerConfig(kind="adagrad", lr=1e-2)
    cpu_model, card_model = DeepFM(cfg, device="cpu"), DeepFM(cfg)
    params = cpu_model.init(torch.Generator().manual_seed(0))
    card = opt.TrainState.create(ocfg, tree_map(lambda t: t.to(cuda),
                                                params))
    host = opt.TrainState.create(ocfg, params)
    b = CTRStream(cfg.field_vocab_sizes, 256, seed=1).next_batch()
    batch = {"sparse_ids": torch.from_numpy(b["sparse_ids"]),
             "label": torch.from_numpy(b["label"])}
    for i, e in enumerate(cpu_model.fields.embs):
        if e.cfg.num_subspaces and "centroids" in params["fields"][f"f{i}"]:
            col = batch["sparse_ids"][:, i]
            p = params["fields"][f"f{i}"]
            e_sub = p["emb"][col].reshape(len(col), e.cfg.num_subspaces, -1)
            lim = _tier_k_limits(e.cfg, col)
            want = dpq.assign_codes(e_sub, p["centroids"], lim)
            got = dpq.assign_codes(e_sub.to(cuda), p["centroids"].to(cuda),
                                   lim.to(cuda))
            assert torch.equal(got.cpu(), want)
    card, m_card = opt.make_step_fn(ocfg, card_model.loss)(
        card, {k: v.to(cuda) for k, v in batch.items()})
    host, m_host = opt.make_step_fn(ocfg, cpu_model.loss)(host, batch)
    assert abs(float(m_card["loss"]) - float(m_host["loss"])) <= 1e-5
    for a, c in zip(tree_leaves([host.params, host.opt_state["acc"]]),
                    tree_leaves([card.params, card.opt_state["acc"]])):
        assert torch.allclose(c.cpu(), a, rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------------
# the LM slice: flash_attention, dpq_assign at LM widths, the smoke LM
# ----------------------------------------------------------------------

FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}   # the JAX bars
# bf16 also per row against the plain version in float32 on the same
# inputs: P and the output are each rounded once to bf16 (<= 2^-8 of a
# value each), so within 4 * 2^-8 of the row's largest |output|
FLASH_BF16_ROW_TOL = 4 * 2 ** -8
FULL = 1 << 30

# (b, sq, skv, h, hkv, hd, window): gemma3-4b's local and global layers
# at a 4,096-token prefill, stablelm-3b's, the JAX tests' four shapes, an
# odd length, the smoke configs' hd = 16, rows that see no key,
# gemma3-27b's layers (hd = 168, zero-padded to 176 on the tensor cores)
# and a key count that is no multiple of either KV tile
FLASH_SHAPES = {
    "gemma_local": (2, 4096, 4096, 8, 4, 320, 1024),
    "gemma_global": (2, 4096, 4096, 8, 4, 320, FULL),
    "stablelm": (1, 2048, 2048, 32, 32, 80, FULL),
    "jax_gqa": (2, 256, 256, 4, 2, 64, FULL),
    "jax_window": (1, 128, 128, 4, 4, 32, 64),
    "jax_cross": (2, 128, 384, 8, 2, 64, FULL),
    "jax_wide_window": (1, 256, 256, 2, 1, 128, 300),
    "odd_1500": (1, 1500, 1500, 8, 4, 320, 1024),
    "smoke_hd16": (2, 1100, 1100, 4, 2, 16, 8),
    "no_key_rows": (1, 200, 40, 2, 1, 64, 8),
    "gemma27b_local": (1, 4096, 4096, 32, 16, 168, 1024),
    "gemma27b_global": (1, 4096, 4096, 32, 16, 168, FULL),
    "ragged_kv": (2, 333, 1001, 8, 4, 168, 500),
}


def _flash_inputs(shape, dtype, device, seed=0):
    b, sq, skv, h, hkv, hd, _ = shape
    g = torch.Generator(device=device).manual_seed(seed)
    # q and k at unit scale: scores of std 1, so each row's weights
    # follow its scores rather than a near-uniform mean
    q = torch.randn((b, sq, h, hd), generator=g, device=device)
    k = torch.randn((b, skv, hkv, hd), generator=g, device=device)
    v = torch.randn((b, skv, hkv, hd), generator=g, device=device)
    return q.to(dtype), k.to(dtype), v.to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(FLASH_SHAPES))
def test_flash_attention_kernel_matches_plain(cuda, name, dtype):
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    shape = FLASH_SHAPES[name]
    q, k, v = _flash_inputs(shape, dtype, cuda)
    before = flash_attention.launches
    got = flash_attention(q, k, v, window=shape[-1])
    want = flash_attention_ref(q, k, v, window=shape[-1])
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.shape == want.shape and got.dtype == dtype
    tol = FLASH_TOL[dtype]
    assert torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        want32 = flash_attention_ref(q.float(), k.float(), v.float(),
                                     window=shape[-1])
        bar = FLASH_BF16_ROW_TOL * want32.abs().amax(-1, keepdim=True)
        assert bool(((got.float() - want32).abs() <= bar).all())


@pytest.mark.gpu
@pytest.mark.parametrize("block_k", [32, 64])
def test_flash_attention_kernel_tiles_and_strides(cuda, block_k):
    """Either KV tile gives the plain version's numbers, and inputs
    read through strides (every other head of a wider tensor) equal
    their contiguous copies."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    shape = (2, 333, 333, 8, 4, 80, 100)
    q, k, v = _flash_inputs(shape, torch.float32, cuda, seed=1)
    want = flash_attention_ref(q, k, v, window=100)
    got = flash_attention(q, k, v, window=100, block_k=block_k)
    assert torch.allclose(got, want, rtol=2e-5, atol=2e-5)
    wide = torch.cat([q, q], dim=3).reshape(2, 333, 16, 80)[:, :, ::2]
    assert not wide.is_contiguous() and torch.equal(wide, q)
    assert torch.equal(flash_attention(wide, k, v, window=100,
                                       block_k=block_k),
                       flash_attention(q, k, v, window=100, block_k=block_k))


@pytest.mark.gpu
@pytest.mark.parametrize("block_k", [32, 64])
def test_flash_attention_bf16_kernel_tiles_strides_and_alignment(cuda,
                                                                 block_k):
    """bf16 on the tensor cores: either KV tile within the bars of the
    plain version; inputs read through strides (every other head of a
    wider tensor) equal their contiguous copies bit for bit, and so do
    rows that are not 16-byte aligned (hd 80 in rows of 81: the kernel's
    plain loads instead of cp.async)."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    shape = (2, 333, 333, 8, 4, 80, 100)
    q, k, v = _flash_inputs(shape, torch.bfloat16, cuda, seed=2)
    got = flash_attention(q, k, v, window=100, block_k=block_k)
    want = flash_attention_ref(q, k, v, window=100)
    assert torch.allclose(got.float(), want.float(), rtol=3e-2, atol=3e-2)
    wide = torch.cat([q, q], dim=3).reshape(2, 333, 16, 80)[:, :, ::2]
    assert not wide.is_contiguous() and torch.equal(wide, q)
    rows81 = torch.zeros((2, 333, 8, 81), dtype=torch.bfloat16, device=cuda)
    rows81[..., :80] = q
    odd = rows81[..., :80]
    assert odd.stride(2) == 81 and torch.equal(odd, q)
    for other in (wide, odd):
        assert torch.equal(flash_attention(other, k, v, window=100,
                                           block_k=block_k), got)


@pytest.mark.gpu
def test_flash_attention_kernel_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.flash_attention import flash_attention
    q, k, v = _flash_inputs((1, 64, 64, 4, 2, 32, FULL), torch.float32, cuda)
    before = flash_attention.launches
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q.clone().requires_grad_(), k, v)
    with pytest.raises(TypeError, match="one dtype"):
        flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="not compiled"):
        flash_attention(q[..., :24], k[..., :24], v[..., :24])
    with pytest.raises(ValueError, match="multiple of Hkv"):
        flash_attention(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="stride 1"):
        flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3),
                        k, v)
    with pytest.raises(ValueError, match="32 or 64"):
        flash_attention(q, k, v, block_k=128)
    assert flash_attention.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ASSIGN_DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("k", [256, 64])
def test_dpq_assign_kernel_at_lm_widths(cuda, k, dtype):
    """An LM token table: D = 8, S = 2560 / 8 = 320 (gemma3-4b) and
    5376 / 8 = 672 (gemma3-27b).  S is streamed through shared memory,
    so no subspace's table has to fit it whole."""
    b, d = 16384, 8
    for s in (320, 672):
        e, c, lim = _assign_case(b, d, k, s, dtype, seed=k + s,
                                 k_small=min(k, 64))
        for budget in (None, lim):
            got = dpq_assign(e, c, budget)
            want = dpq_assign_ref(e, c, budget)
            torch.cuda.synchronize()
            assert _assign_gap(e, c, budget, got, want) <= ASSIGN_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ASSIGN_DTYPES, ids=["float32", "bfloat16"])
def test_dpq_assign_kernel_ties_across_chunks(cuda, dtype):
    """A centroid repeated in a later centroid tile never wins: the
    first index does, as torch.argmin's; a budget that ends inside the
    first tile never reaches the second."""
    from repro_torch.kernels.dpq_assign.dpq_assign import BLOCK_N
    d, k, s = 2, 600, 200
    rng = np.random.default_rng(2)
    cent = rng.normal(size=(d, k, s)).astype(np.float32)
    cent[:, BLOCK_N + 5] = cent[:, 7]             # exact tie across tiles
    cent[:, 2 * BLOCK_N + 1] = cent[:, 7]
    cent[:, k - 1] = cent[:, 7]
    e = np.repeat(cent[None, :, 7, :], 5, axis=0)
    c = torch.from_numpy(cent).to(cuda, dtype)
    et = torch.from_numpy(e).to(cuda, dtype)
    assert (dpq_assign(et, c).cpu() == 7).all()
    lim = torch.tensor([3, 8, BLOCK_N + 6, k, 0], dtype=torch.int32,
                       device=cuda)
    got = dpq_assign(et, c, lim).cpu()
    assert torch.equal(got, dpq_assign_ref(et, c, lim).cpu())
    assert got[1:4].eq(7).all() and got[4].eq(0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["stablelm-3b", "gemma3-4b", "gemma3-27b",
                                  "mixtral-8x7b", "qwen3-moe-30b-a3b"])
def test_lm_smoke_on_card_matches_cpu(cuda, arch):
    """The smoke LM served from the same params and artifact on the card
    and on the CPU, a 1,100-token prompt (the chunked route: the
    flash_attention kernel on the card): prefill and 3 decode steps'
    logits within 1e-4, greedy tokens equal."""
    from repro_torch.configs import get_arch
    from repro_torch.core.schemes.base import tree_map
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import lm
    _, cfg = get_arch(arch, smoke=True)
    params = lm.model_init(torch.Generator().manual_seed(0), cfg)
    art = Embedding(cfg.embedding, device="cpu").export(params["embed"])
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 1100)).astype(np.int32))
    runs = []
    for dev in ("cpu", cuda):
        p, a = (tree_map(lambda t: t.to(dev), x) for x in (params, art))
        before = flash_attention.launches
        with torch.no_grad():
            cache, logits = lm.prefill(p, tokens.to(dev), cfg, max_seq=1103,
                                       embed_artifact=a)
            out = [logits]
            for _ in range(3):
                tok = torch.argmax(logits, -1).to(torch.int32)
                cache, logits = lm.decode_step(p, cache, tok, cfg,
                                               embed_artifact=a)
                out.append(logits)
        runs.append([x.cpu() for x in out])
        launched = flash_attention.launches - before
        assert launched == (cfg.num_layers if dev == cuda else 0)
    for host, card in zip(*runs):
        assert torch.allclose(card, host, rtol=1e-4, atol=1e-4)
        assert torch.equal(torch.argmax(card, -1), torch.argmax(host, -1))


def _moe_params(d, f, e, seed, zero_router=False):
    g = torch.Generator().manual_seed(seed)
    p = {"router": torch.randn((d, e), generator=g) * d ** -0.5,
         "w_gate": torch.randn((e, d, f), generator=g) * d ** -0.5,
         "w_up": torch.randn((e, d, f), generator=g) * d ** -0.5,
         "w_down": torch.randn((e, f, d), generator=g) * f ** -0.5}
    if zero_router:
        p["router"].zero_()
    return p


@pytest.mark.gpu
@pytest.mark.parametrize("factor", [1.25, 0.01])
@pytest.mark.parametrize("d,f,e,k", [(64, 96, 4, 2), (64, 32, 8, 2),
                                     (256, 64, 128, 8)])
def test_moe_ffn_on_card_matches_cpu(cuda, d, f, e, k, factor):
    """nn/moe.py in f32 on the card and on the CPU from the same params
    and tokens (the MoE archs' smoke widths and 128 experts top-8; a
    capacity factor that keeps every choice and one that drops most):
    the routed experts equal, output and aux within 1e-5."""
    from repro_torch.core.schemes.base import tree_map
    from repro_torch.nn import moe
    p = _moe_params(d, f, e, seed=e)
    x = torch.randn((2, 300, d), generator=torch.Generator().manual_seed(1))
    runs = []
    for dev in ("cpu", cuda):
        pd, xd = tree_map(lambda t: t.to(dev), p), x.to(dev)
        ids = moe.route(xd.reshape(-1, d), pd["router"], k)[1]
        out, aux = moe.moe_ffn(pd, xd, top_k=k, capacity_factor=factor)
        runs.append((ids.cpu(), out.cpu(), aux.cpu()))
    (ids_h, out_h, aux_h), (ids_c, out_c, aux_c) = runs
    assert torch.equal(ids_c, ids_h)
    assert torch.allclose(out_c, out_h, rtol=1e-5, atol=1e-5)
    assert abs(float(aux_c) - float(aux_h)) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("e,k", [(4, 2), (8, 2), (128, 8)])
def test_moe_zero_router_ties_on_card(cuda, e, k):
    """Every router probability tied: the card's stable sort gives
    experts 0..k-1 for every token, as JAX's top-k does."""
    from repro_torch.nn import moe
    p = {n: t.to(cuda) for n, t in _moe_params(64, 32, e, seed=2,
                                               zero_router=True).items()}
    x = torch.randn((4096, 64), device=cuda)
    ids = moe.route(x, p["router"], k)[1]
    assert torch.equal(ids.cpu(), torch.arange(k).expand(4096, k))
    out, _ = moe.moe_ffn(p, x[None], top_k=k)
    assert bool(torch.isfinite(out).all())


@pytest.mark.gpu
def test_bf16_param_lm_on_card_kernel_route_matches_plain(cuda):
    """gemma3-27b's smoke config with its full config's bfloat16 params
    (activations f32) served on the card, a 1,100-token prompt: the
    kernel route (flash_attention on every layer, mgqe_decode on the
    bf16 centroids) against the plain route on the same card, prefill
    and 3 decode steps' logits within 1e-4, greedy tokens equal."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.dispatch import pinned_backend
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mgqe_decode import mgqe_decode
    from repro_torch.models import lm
    _, cfg = get_arch("gemma3-27b", smoke=True)
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    params = lm.model_init(torch.Generator(device=cuda).manual_seed(0), cfg)
    assert params["loc"]["wq"].dtype == params["embed"]["emb"].dtype \
        == torch.bfloat16
    emb = Embedding(dataclasses.replace(cfg.embedding,
                                        param_dtype="bfloat16"), device=cuda)
    art = emb.export(params["embed"])
    assert art["centroids"].dtype == torch.bfloat16
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 1100)).astype(np.int32)).to(cuda)
    runs = []
    for backend in (None, "torch"):
        before = (flash_attention.launches, mgqe_decode.launches)
        with torch.no_grad(), pinned_backend(backend):
            cache, logits = lm.prefill(params, tokens, cfg, max_seq=1103,
                                       embed_artifact=art)
            out = [logits]
            for _ in range(3):
                tok = torch.argmax(logits, -1).to(torch.int32)
                cache, logits = lm.decode_step(params, cache, tok, cfg,
                                               embed_artifact=art)
                out.append(logits)
        launched = (flash_attention.launches - before[0],
                    mgqe_decode.launches - before[1])
        assert launched == ((cfg.num_layers, 4) if backend is None
                            else (0, 0))
        runs.append(out)
    for kernel, plain in zip(*runs):
        assert kernel.dtype == torch.float32
        assert torch.allclose(kernel, plain, rtol=1e-4, atol=1e-4)
        assert torch.equal(torch.argmax(kernel, -1), torch.argmax(plain, -1))


# ----------------------------------------------------------------------
# the backbones (GMF, NeuMF, SASRec): trained on the card, their MGQE
# tables exported and served
# ----------------------------------------------------------------------

def _bb_cfg(model, **kw):
    """The parity tests' tiny backbone (d = 16, D = 4, K = 16 / 8)."""
    from repro_torch.models.recsys.backbones import BackboneConfig
    return BackboneConfig(**{**dict(
        model=model, n_users=100, n_items=80, dim=16, embed_kind="mgqe",
        num_subspaces=4, num_centroids=16, tier_tail_centroids=8,
        mlp_dims=(16, 8), maxlen=10, n_blocks=1), **kw})


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["gmf", "neumf", "sasrec"])
def test_backbone_steps_on_card_match_cpu(cuda, model):
    """3 adam steps of an MGQE backbone on the card and on the CPU from
    the same params and sampler batches: every loss and every final
    param within 1e-5."""
    from repro_torch.core.schemes.base import tree_leaves, tree_map
    from repro_torch.data.sampler import PointwiseSampler, SequenceSampler
    from repro_torch.data.synthetic import movielens_like
    from repro_torch.launch.backbones import fit
    from repro_torch.models.recsys.backbones import make_backbone
    data = movielens_like(n_users=100, n_items=80, mean_len=6, seed=0)
    cfg = _bb_cfg(model)
    cpu, card = make_backbone(cfg, device="cpu"), make_backbone(cfg)
    params = cpu.init(torch.Generator().manual_seed(0))
    card_params = tree_map(lambda t: t.to(cuda), params)

    def batches():
        return iter(SequenceSampler(data, batch=64, maxlen=10)
                    if model == "sasrec" else
                    PointwiseSampler(data, batch_pos=128))
    s_card, l_card = fit(card, card_params, card.loss, batches(), 3, 1e-2,
                         log_every=1)
    s_cpu, l_cpu = fit(cpu, params, cpu.loss, batches(), 3, 1e-2,
                       log_every=1)
    np.testing.assert_allclose(l_card, l_cpu, rtol=1e-5, atol=1e-5)
    for c, a in zip(tree_leaves(s_card.params), tree_leaves(s_cpu.params)):
        assert c.is_cuda
        assert torch.allclose(c.cpu(), a, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("vocab", [6040, 3417])
@pytest.mark.parametrize("d", [4, 8, 16])
def test_backbone_mgqe_table_exports_and_serves_on_card(cuda, d, vocab):
    """A backbone's MGQE table at the paper's widths (d = 64, D = 4, 8,
    16, K = 256 with a tail of 64): export launches dpq_assign once, its
    codes equal the plain assignment up to near-ties, and serve launches
    mgqe_decode, its rows bit-identical to the plain decode of the
    exported codes."""
    from repro_torch.core.mgqe import k_limit_for_all_rows
    from repro_torch.models.recsys.backbones import BackboneConfig
    cfg = BackboneConfig(model="gmf", n_users=vocab, n_items=vocab,
                         embed_kind="mgqe", num_subspaces=d).emb_config(vocab)
    emb = Embedding(cfg)
    params = emb.init(emb.generator(d))
    n0 = (dpq_assign.launches, mgqe_decode.launches)
    art = emb.export(params)
    codes, cent = art["codes"], art["centroids"]
    assert codes.dtype == torch.uint8 and codes.shape == (vocab, d)
    e = params["emb"].reshape(vocab, d, -1)
    lim = k_limit_for_all_rows(cfg, cuda)
    assert _assign_gap(e, cent, lim, codes.to(torch.int32),
                       _plain(e, cent, lim)) <= ASSIGN_TOL
    ids = torch.from_numpy(np.random.default_rng(d).integers(
        0, vocab, 50_500)).to(cuda)
    rows = emb.serve(art, ids)
    assert rows.shape == (50_500, 64)
    want = mgqe_decode_ref(codes.index_select(0, ids), cent)
    _same_bits(rows, want)
    assert (dpq_assign.launches - n0[0], mgqe_decode.launches - n0[1]) \
        == (1, 1)
    # the planner stages the 64 KB table (16-64 byte slots); the l2
    # route, run on the same codes, agrees bit for bit
    assert decode_plan(50_500, d, 256, 64 // d, 1, 4, 132).route == "smem"
    _same_bits(mgqe_decode(codes.index_select(0, ids), cent,
                           plan=l2_gather_plan(50_500, d, 4 * 64 // d, 132)),
               want)


# ------------------------------------------------------- hot-row cache
# Every scheme's cached engine on the card against its uncached engine:
# the hot block is decoded at B = HOT_ROWS (rq's smem route), the flushes'
# cold remainders at their own B (rq's l2 route), and the merged rows
# must be bit-identical for any flush size.

HOT_VOCAB = 100_000
HOT_ROWS = RQ_SMEM_MIN_ROWS + 1000
HOT_SCHEMES = {
    "dpq": dict(kind="dpq", num_subspaces=5, num_centroids=256),
    "mgqe-shared_k": dict(kind="mgqe", num_subspaces=5, num_centroids=256,
                          tier_boundaries=(10_000,),
                          tier_num_centroids=(256, 64)),
    "mgqe-private_k": dict(kind="mgqe", num_subspaces=5, num_centroids=256,
                           mgqe_variant="private_k",
                           tier_boundaries=(10_000,),
                           tier_num_centroids=(256, 64)),
    "mgqe-private_d": dict(kind="mgqe", num_subspaces=5, num_centroids=16,
                           mgqe_variant="private_d",
                           tier_boundaries=(10_000,),
                           tier_num_subspaces=(5, 2)),
    "rq": dict(kind="rq", num_levels=5, num_centroids=256),
    "mpe": dict(kind="mpe", num_subspaces=5, tier_boundaries=(5000, 25_000),
                tier_bits=(8, 4, 2)),
    "lrf": dict(kind="lrf", rank=8),
    "sq": dict(kind="sq", sq_bits=8),
    "hash": dict(kind="hash", hash_buckets=4096),
    "full": dict(kind="full"),
}
HOT_COUNTERS = {"dpq": mgqe_decode, "mgqe": mgqe_decode,
                "rq": rq_decode_stages, "mpe": packed_decode}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(HOT_SCHEMES))
def test_cached_engine_on_card_bit_identical_to_uncached(cuda, name):
    cfg = EmbeddingConfig(vocab_size=HOT_VOCAB, dim=10, **HOT_SCHEMES[name])
    emb = Embedding(cfg)
    art = emb.export(emb.init(emb.generator(0)))
    eng = engine.ServingEngine(emb, art, hot_rows=HOT_ROWS)
    base = engine.ServingEngine(emb, art, hot_rows=0)
    if cfg.kind == "rq":       # the block and the flushes: both routes
        assert rq_plan(HOT_ROWS, 5, 256, 10, 1, 4, 132).route == "smem"
        assert rq_plan(4352, 5, 256, 10, 1, 4, 132).route == "l2"
    counter = HOT_COUNTERS.get(cfg.kind)
    rng = np.random.default_rng(0)
    for b in (1, 8, 255, 256, 4097):
        ids = rng.integers(0, HOT_VOCAB, b)
        ids[::2] = rng.integers(0, HOT_ROWS, len(ids[::2]))   # cached
        _same_bits(eng.lookup(ids), base.lookup(ids))
    hot_ids = rng.integers(0, HOT_ROWS, 4097)                # all cached
    before = None if counter is None else counter.launches
    got = eng.lookup(hot_ids)
    if counter is not None:
        assert counter.launches == before     # no decode kernel launched
    _same_bits(got, base.lookup(hot_ids))
    assert eng.stats().hot_hits > 0


@pytest.mark.gpu
def test_lrf_served_row_does_not_depend_on_the_batch(cuda):
    """lrf's served row at B = 1 equals the same row at B = 4,096 (a
    matmul would pick another kernel, and rounding, by shape)."""
    cfg = EmbeddingConfig(vocab_size=50_000, dim=64, kind="lrf", rank=64)
    emb = Embedding(cfg)
    art = emb.export(emb.init(emb.generator(3)))
    ids = torch.from_numpy(np.random.default_rng(3).integers(
        0, 50_000, 4096)).to(cuda)
    many = emb.serve(art, ids)
    for i in (0, 1, 4095):
        _same_bits(emb.serve(art, ids[i:i + 1]), many[i:i + 1])
    assert float((many - art["u"][ids] @ art["v"]).abs().max()) < 1e-5


@pytest.mark.gpu
def test_async_engine_on_card_matches_sync_through_refreshes(cuda):
    """200 flushes through the async engine, on its own CUDA streams,
    with refreshes fired beside them on a stream whose head moves: every
    future's rows bit-identical to the uncached synchronous engine's."""
    from repro_torch.data.synthetic import zipf_ids
    from repro_torch.launch.async_engine import AsyncServingEngine
    cfg = EmbeddingConfig(vocab_size=HOT_VOCAB, dim=10,
                          **HOT_SCHEMES["mgqe-shared_k"])
    emb = Embedding(cfg)
    art = emb.export(emb.init(emb.generator(0)))
    eng = engine.ServingEngine(emb, art, hot_rows=4096)
    base = engine.ServingEngine(emb, art, hot_rows=0)
    rng = np.random.default_rng(5)
    perm = rng.permutation(HOT_VOCAB)          # the head is not ids < C
    reqs = [perm[zipf_ids(rng, int(rng.integers(1, 65)), HOT_VOCAB, 1.2)]
            for _ in range(200)]
    a = AsyncServingEngine(eng, max_wait_us=100.0, refresh_every=8)
    try:
        assert a._flush_stream != torch.cuda.default_stream(cuda)
        assert a._refresh_stream != a._flush_stream
        outs = []
        for i, r in enumerate(reqs):            # one flush a request
            outs.append(a.submit(r).result(timeout=60))
            if i % 10 == 5:
                a.refresh_now()
        assert a.drain(timeout=60)
        st = a.stats()
    finally:
        a.close(timeout=60)
    assert st.flushes == 200 and st.hot_refreshes > 0
    assert not np.array_equal(eng._hot_ids, np.arange(4096))
    for r, got in zip(reqs, outs):
        want = base.lookup(r).cpu().numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


@pytest.mark.gpu
def test_launch_counts_exact_under_two_threads(cuda):
    """Two threads launching mgqe_decode at once: the count is exact."""
    import threading
    codes, cent = _decode_inputs_for_threads(cuda)
    n0 = mgqe_decode.launches

    def work():
        with torch.cuda.stream(torch.cuda.Stream(cuda)):
            for _ in range(2000):
                mgqe_decode(codes, cent)
            torch.cuda.current_stream(cuda).synchronize()

    threads = [threading.Thread(target=work) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert mgqe_decode.launches - n0 == 4000


def _decode_inputs_for_threads(cuda):
    rng = np.random.default_rng(9)
    codes = torch.from_numpy(rng.integers(0, 256, (256, 5)).astype(
        np.uint8)).to(cuda)
    cent = torch.from_numpy(rng.normal(size=(5, 256, 2)).astype(
        np.float32)).to(cuda)
    return codes, cent


# ----------------------------------------------------------------------
# AutoInt and BST served, AutoInt, BST and two-tower trained on the card
# ----------------------------------------------------------------------

def _table_at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _recsys_codes(model, params, batch):
    """{table: training codes of its ids in ``batch``} of every table
    with centroids (MGQE tables under their tiers' budgets)."""
    from repro_torch.core import dpq
    from repro_torch.core.mgqe import _tier_k_limits
    from repro_torch.launch.cells import recsys_tables
    out = []
    for path, emb, ids in recsys_tables(model, batch):
        p = _table_at(params, path)
        if "centroids" in p:
            ids = ids.reshape(-1).to(p["emb"].device).long()
            e = p["emb"][ids].reshape(len(ids), emb.cfg.num_subspaces, -1)
            lim = (_tier_k_limits(emb.cfg, ids)
                   if emb.cfg.tier_boundaries else None)
            out.append(dpq.assign_codes(e, p["centroids"], lim).cpu())
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["autoint", "bst", "two-tower-retrieval"])
def test_recsys_steps_on_card_match_cpu(cuda, arch):
    """3 adagrad steps of the smoke model through ``recsys_setup`` on the
    card and on the CPU from the same params and the launcher's batches,
    under ``record_adagrad``: each step's MGQE codes equal, the loss
    within 1e-5 relative, every step's gradients and the accumulators
    within 1e-5; every param within its rounding slack of
    ``adagrad_replay`` over its own run's gradients, and the two runs'
    params apart by at most what their replays are apart (adagrad's
    first step turns a 1e-9 gradient gap near |g| = 1e-8 into up to
    2.5e-4, so no fixed bar on the param gap both holds and sees a
    fault)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.schemes.base import tree_leaves, tree_map
    from repro_torch.launch.train import recsys_setup
    from repro_torch.train import optimizer as opt
    _, cfg = get_arch(arch, smoke=True)
    cpu, host, step_host, data = recsys_setup(cfg, 256, device="cpu")
    card_model, _, step_card, _ = recsys_setup(cfg, 256, device=cuda)
    card = opt.TrainState.create(opt.OptimizerConfig(kind="adagrad",
                                                     lr=1e-2),
                                 tree_map(lambda t: t.to(cuda), host.params))
    p0 = [t.clone() for t in tree_leaves(host.params)]
    with opt.record_adagrad() as tape:
        for _ in range(3):
            batch = next(data)
            for c, h in zip(_recsys_codes(card_model, card.params, batch),
                            _recsys_codes(cpu, host.params, batch)):
                assert torch.equal(c, h)
            card, mc = step_card(card, {k: v.to(cuda)
                                        for k, v in batch.items()})
            host, mh = step_host(host, batch)
            assert abs(float(mc["loss"]) - float(mh["loss"])) \
                <= 1e-5 * abs(float(mh["loss"]))
    tc = [t for t in tape if t[0].type == "cuda"]
    th = [t for t in tape if t[0].type == "cpu"]
    assert len(tc) == len(th) == 3
    for (*_, gc), (*_, gh) in zip(tc, th):
        for a, b in zip(gc, gh):
            assert torch.allclose(a, b, rtol=1e-5, atol=1e-5)
    rc, _, sc = opt.adagrad_replay(p0, tc)
    rh, _, sh = opt.adagrad_replay(p0, th)
    for c, h, xc, xh, ec, eh in zip(tree_leaves(card.params),
                                    tree_leaves(host.params), rc, rh, sc, sh):
        assert c.is_cuda
        c, h = c.cpu().double(), h.double()
        assert bool(((c - xc).abs() <= ec).all())
        assert bool(((h - xh).abs() <= eh).all())
        assert bool(((c - h).abs() <= (xc - xh).abs() + ec + eh).all())
    for c, h in zip(tree_leaves(card.opt_state["acc"]),
                    tree_leaves(host.opt_state["acc"])):
        assert torch.allclose(c.cpu(), h, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,launches", [("autoint", (2, 2)),
                                           ("bst", (1, 1))])
def test_ctr_served_rows_on_card_match_plain_decode(cuda, arch, launches):
    """``serve_ctr`` of the smoke model on the card: export launches
    dpq_assign once per quantized table (each under 65,536 rows), the
    scored batch mgqe_decode once per quantized table; the served rows
    bit-identical to the plain decode of the same artifacts and the
    logits within 1e-5 of the model on the plain ops."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.launch.cells import recsys_model, recsys_tables
    from repro_torch.launch.serve import serve_ctr
    _, cfg = get_arch(arch, smoke=True)
    n0 = (dpq_assign.launches, mgqe_decode.launches)
    run = serve_ctr(cfg, 512, device=cuda)
    assert (dpq_assign.launches - n0[0], mgqe_decode.launches - n0[1]) \
        == launches
    plain = recsys_model(dataclasses.replace(cfg, kernel_backend="torch"),
                         device=cuda)
    tables = recsys_tables(run.model, run.batch)
    assert len(tables) == (1 if arch == "bst" else cfg.n_sparse)
    for (path, emb, ids), (_, pemb, _) in zip(tables,
                                              recsys_tables(plain, run.batch)):
        art = _table_at(run.artifacts, path[1:])
        rows = emb.serve(art, ids)
        assert rows.shape == ids.shape + (cfg.embed_dim,)
        _same_bits(rows, pemb.serve(art, ids))
    logits = plain.serve(run.params, run.artifacts, run.batch)
    assert run.scores.is_cuda and bool(torch.isfinite(run.scores).all())
    assert torch.allclose(run.scores, logits, rtol=1e-5, atol=1e-5)


# ------------------------------------------------- ivf_pq on the card

def _ivf_corpus(n=60_000, seed=0):
    from repro_torch.data.synthetic import pq_clustered_corpus
    return pq_clustered_corpus(n=n, n_clusters=256, cluster_zipf_a=1.3,
                               seed=seed)


def _ivf_cfg(**kw):
    return IndexConfig(**dict(kind="ivf_pq", num_subspaces=8,
                              num_centroids=128, iters=5, coarse_iters=5,
                              nlist=128, nprobe=32, train_sample=16_384,
                              encode_block=16_384, list_cap_quantile=0.9)
                       | kw)


@pytest.mark.gpu
@pytest.mark.parametrize("residual", [False, True])
def test_ivf_probed_scoring_on_card_bit_identical_to_plain(cuda, residual):
    """The search's scoring on the card — ``pq_score_batched`` over the
    unique probed lists, one launch, then gathered — gives the plain
    per-query scoring's bits (the kernel adds in the plain version's
    order)."""
    from repro_torch.kernels.pq_score import build_lut_batch
    from repro_torch.retrieval import build_ivf_artifact, ivf_pq
    vecs, q = _ivf_corpus()
    cfg = _ivf_cfg(ivf_residual=residual)
    host, _ = build_ivf_artifact(torch.Generator(device=cuda).manual_seed(0),
                                 vecs, cfg, device=cuda)
    art = {n: t.to(cuda) for n, t in host.items()}
    index = get_index(cfg)
    qd = torch.from_numpy(q).to(cuda)
    _, lists = index._probe(art, qd)
    chain, _ = index._expand_chain(art["list_chain"], lists)
    luts = build_lut_batch(qd, art["centroids"]).contiguous()
    plain = ivf_pq.probed_scores_ref(
        luts, art["list_codes"][chain.reshape(q.shape[0], -1)].reshape(
            q.shape[0], -1, 8))
    before = pq_score_batched.launches
    cand = index._candidate_scores(luts, art["list_codes"], chain)
    assert pq_score_batched.launches - before == 1
    _same_bits(cand, plain)
    s, i = index.search(art, qd, 100)
    assert bool(torch.isfinite(s).all()) and bool((i != INVALID_ID).all())


@pytest.mark.gpu
@pytest.mark.parametrize("nprobe", [1, 16])
def test_ivf_host_staged_on_card_equals_device_search(cuda, nprobe):
    """Host-staged search (pinned host tables, one upload a flush) and
    its engine on the card: bit-identical to the device search, and the
    upload counted as ``staged_upload_bytes`` says."""
    from repro_torch.retrieval import build_ivf_artifact
    vecs, q = _ivf_corpus(seed=1)
    cfg = _ivf_cfg(nprobe=nprobe)
    host, stats = build_ivf_artifact(
        torch.Generator(device=cuda).manual_seed(1), vecs, cfg, device=cuda)
    assert host["list_codes"].device.type == "cpu"
    assert host["coarse"].is_cuda and host["centroids"].is_cuda
    art = {n: t.to(cuda) for n, t in host.items()}
    index = get_index(cfg)
    qd = torch.from_numpy(q).to(cuda)
    want = index.search(art, qd, 100)
    got = index.search_host_staged(host, qd, 100)
    _same_bits(got[0], want[0])
    assert torch.equal(got[1], want[1])
    uniq, slots, _ = index.stage_plan(host["list_chain"].numpy(),
                                      index._probe(art, qd)[1].cpu().numpy())
    assert index.staged_bytes == index.staged_upload_bytes(
        len(uniq), stats.list_cap, 8, slots.size)
    eng = engine.RetrievalEngine(get_index(dataclasses.replace(
        cfg, host_staged=True)), host, k=100, block_q=16)
    assert eng.artifact["list_codes"].is_pinned()
    s, i = eng.search(q)
    _same_bits(s, want[0])
    assert torch.equal(i, want[1])


@pytest.mark.gpu
def test_ivf_async_host_staged_on_card_matches_sync(cuda):
    """A host-staged IVF engine behind the async front-end: its flushes
    (the probe, the host gather and the upload on the flush thread's
    stream) give every future the synchronous device engine's bits."""
    from repro_torch.launch.async_engine import AsyncServingEngine
    from repro_torch.retrieval import build_ivf_artifact
    vecs, _ = _ivf_corpus(seed=3)
    cfg = _ivf_cfg(nprobe=8, host_staged=True)
    host, _ = build_ivf_artifact(
        torch.Generator(device=cuda).manual_seed(3), vecs, cfg, device=cuda)
    staged = engine.RetrievalEngine(get_index(cfg), host, k=50, block_q=8)
    sync = engine.RetrievalEngine(get_index(dataclasses.replace(
        cfg, host_staged=False)), host, k=50, block_q=8)
    rng = np.random.default_rng(6)
    reqs = [rng.normal(size=(int(rng.integers(1, 9)), 64)).astype(
        np.float32) for _ in range(40)]
    a = AsyncServingEngine(staged, max_wait_us=200.0)
    try:
        assert a._flush_stream != torch.cuda.default_stream(cuda)
        # one flush a request: its LUTs are built over the same padded
        # batch as the synchronous engine's
        got = [a.submit(r).result(timeout=60) for r in reqs]
        assert a.drain(timeout=60)
    finally:
        a.close(timeout=60)
    assert staged.staged_mbytes > 0
    for r, (s, i) in zip(reqs, got):
        ws, wi = sync.search(r)
        np.testing.assert_array_equal(s.view(np.int32), _bits(ws))
        np.testing.assert_array_equal(i, wi.cpu().numpy())


@pytest.mark.gpu
def test_ivf_build_on_card_peak_bounded_and_codes_plain(cuda):
    """The streamed build from a host corpus: one ``dpq_assign`` a
    block, the staged peak within the config's bound and below the
    corpus, the allocator's peak within twice the staged one, and the
    layout's codes the plain assignment's up to near-ties."""
    from repro_torch.retrieval import build_ivf_artifact
    vecs, _ = _ivf_corpus(n=100_000, seed=2)
    cfg = _ivf_cfg()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = dpq_assign.launches
    art, stats = build_ivf_artifact(
        torch.Generator(device=cuda).manual_seed(2), vecs, cfg, device=cuda)
    peak = torch.cuda.max_memory_allocated() - base
    assert dpq_assign.launches - before == stats.blocks == 7
    assert stats.peak_device_ok
    assert stats.peak_device_bytes < vecs.nbytes
    assert peak <= 2 * stats.device_bound_bytes, (peak, stats)
    ids = art["list_ids"].reshape(-1)
    valid = ids != INVALID_ID
    codes = torch.zeros((vecs.shape[0], 8), dtype=torch.uint8)
    codes[ids[valid].long()] = art["list_codes"].reshape(-1, 8)[valid]
    e = torch.from_numpy(vecs).to(cuda).reshape(-1, 8, 8)
    c = art["centroids"]
    want = dpq_assign_ref(e, c)
    e64, c64 = e.double(), c.double()
    dist = (torch.sum(c64 * c64, -1)[None]
            - 2.0 * torch.einsum("bds,dks->bdk", e64, c64))
    gap = (dist.gather(-1, codes.to(cuda).long()[..., None])
           - dist.gather(-1, want.long()[..., None])).abs()
    assert float(gap.max()) <= ASSIGN_TOL


# ----------------------------------------------------------------------
# LM training: attend's backward, the smoke trainers, replay, checkpoints
# ----------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape,window", [((2, 300, 4, 2, 16), 64),
                                          ((1, 513, 8, 8, 80), 1 << 30),
                                          ((1, 256, 8, 2, 64), 100)])
@pytest.mark.parametrize("grouped", [False, True],
                         ids=["whole", "by_kv_head"])
def test_attend_backward_on_card_matches_plain_autograd(cuda, shape, window,
                                                         dtype, grouped,
                                                         monkeypatch):
    """``attend`` on the card: the kernel forward (one launch), and
    dq, dk, dv of the recompute against autograd through the plain
    version on the same inputs and upstream grad: the same bits when
    the recompute is whole, within float32 rounding (bfloat16: one
    rounding) a KV head at a time."""
    from repro_torch.kernels.flash_attention import (attend, flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.flash_attention import ops
    b, s, h, hkv, hd = shape
    if grouped:
        monkeypatch.setattr(ops, "RECOMPUTE_BYTES",
                            b * (h // hkv) * s * s * 4)
        assert ops.recompute_groups(b, s, s, h, hkv) == 1
    g = torch.Generator(device=cuda).manual_seed(hd)
    q, k, v = (torch.randn((b, s, n, hd), generator=g, device=cuda,
                           dtype=dtype) for n in (h, hkv, hkv))
    up = torch.randn((b, s, h, hd), generator=g, device=cuda, dtype=dtype)
    a = [t.clone().requires_grad_(True) for t in (q, k, v)]
    r = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = flash_attention.launches
    out = attend(*a, window)
    assert flash_attention.launches == before + 1
    got = torch.autograd.grad(out, a, up)
    want = torch.autograd.grad(flash_attention_ref(*r, window=window), r, up)
    assert flash_attention.launches == before + 1
    for x, y in zip(got, want):
        if grouped:
            tol = 1e-5 if dtype == torch.float32 else 2 ** -7
            assert torch.allclose(x.float(), y.float(), rtol=tol, atol=tol)
        else:
            _same_bits(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["stablelm-3b", "gemma3-4b", "gemma3-27b",
                                  "mixtral-8x7b", "qwen3-moe-30b-a3b"])
def test_lm_train_smoke_on_card_matches_cpu(cuda, arch):
    """3 adamw steps of ``lm_setup`` at the smoke config with layer remat
    and the chunked route (the kernel on the card, two launches a layer
    a step: the forward and its recompute), from the same params and
    batches on the card and on the CPU: losses within 1e-4 relative."""
    from repro_torch.configs import get_arch
    from repro_torch.core.schemes.base import tree_map
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.train import lm_setup
    from repro_torch.train import optimizer as opt
    _, cfg = get_arch(arch, smoke=True)
    cfg = dataclasses.replace(cfg, attention_impl="chunked", remat=True)
    host, step, data = lm_setup(cfg, 2, 64, device="cpu")
    card = opt.TrainState(tree_map(lambda t: t.to(cuda), host.params),
                          tree_map(lambda t: t.to(cuda), host.opt_state))
    before = flash_attention.launches
    for _ in range(3):
        batch = next(data)
        card, mc = step(card, {k: t.to(cuda) for k, t in batch.items()})
        host, mh = step(host, batch)
        assert abs(float(mc["loss"]) - float(mh["loss"])) <= \
            1e-4 * abs(float(mh["loss"]))
    assert flash_attention.launches - before == 2 * cfg.num_layers * 3


@pytest.mark.gpu
def test_row_gather_backward_repeats_on_card(cuda):
    """``core/dpq.py::row_gather``'s backward gives the same bits twice
    (a sorted index_put_, not index_select's atomic index_add_), with
    65,536 ids on 1,000 rows."""
    from repro_torch.core.dpq import row_gather
    g = torch.Generator(device=cuda).manual_seed(5)
    table = torch.randn((100_000, 16), generator=g, device=cuda)
    ids = torch.randint(0, 1000, (65_536,), generator=g, device=cuda)
    up = torch.randn((65_536, 16), generator=g, device=cuda)
    grads = []
    for _ in range(2):
        t = table.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(
            (row_gather(t, ids.to(torch.int32)) * up).sum(), t)[0])
    _same_bits(grads[0], grads[1])


@pytest.mark.gpu
def test_bf16_checkpoint_roundtrip_on_card(cuda, tmp_path):
    """bfloat16 params on the card saved and restored onto the card's
    template, bit for bit, float32 moments beside them."""
    from repro_torch.core.schemes.base import tree_leaves
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt
    g = torch.Generator(device=cuda).manual_seed(1)
    params = {"w": torch.randn((64, 48), generator=g, device=cuda).to(
        torch.bfloat16), "b": torch.randn(7, generator=g, device=cuda).to(
        torch.bfloat16)}
    state = opt.TrainState.create(opt.OptimizerConfig(kind="adamw"), params)
    ckpt.save(str(tmp_path), 2, state)
    template = opt.TrainState.create(
        opt.OptimizerConfig(kind="adamw"),
        {k: torch.zeros_like(t) for k, t in params.items()})
    restored, step = ckpt.restore_latest(str(tmp_path), template)
    assert step == 2
    for a, b in zip(tree_leaves([state.params, state.opt_state]),
                    tree_leaves([restored.params, restored.opt_state])):
        assert b.is_cuda and a.dtype == b.dtype
        _same_bits(b, a)


def _mace_grads(loss_fn, params, batch):
    from repro_torch.core.schemes.base import tree_leaves
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        return torch.autograd.grad(loss_fn(params, batch)[0], leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)


@pytest.mark.gpu
def test_mace_smoke_on_card_matches_cpu(cuda):
    """``gnn_setup`` at the smoke config from the same params and batches
    on the card and on the CPU: the first batch's gradients within 1e-5
    relative to 1 + |g|, then 3 adam steps' losses within 1e-4
    relative; no kernel launched (MACE's path holds none)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.schemes.base import tree_map
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.train import gnn_setup
    from repro_torch.train import optimizer as opt
    _, cfg = get_arch("mace", smoke=True)
    model, host, step, data = gnn_setup(cfg, 32, device="cpu")
    card = opt.TrainState(tree_map(lambda t: t.to(cuda), host.params),
                          tree_map(lambda t: t.to(cuda), host.opt_state))
    counts = [f.launches for f in (mgqe_decode, dpq_assign, embedding_bag,
                                   flash_attention, pq_topk)]
    batch = next(data)
    got = _mace_grads(model.energy_loss, card.params, on_device(batch, cuda))
    want = _mace_grads(model.energy_loss, host.params, on_device(batch, "cpu"))
    for g, w in zip(got, want):
        assert float(((g.cpu() - w).abs() / (1 + w.abs())).max()) <= 1e-5
    for _ in range(3):
        card, mc = step(card, on_device(batch, cuda))
        host, mh = step(host, on_device(batch, "cpu"))
        assert abs(float(mc["loss"]) - float(mh["loss"])) <= \
            1e-4 * abs(float(mh["loss"]))
        batch = next(data)
    assert counts == [f.launches for f in (mgqe_decode, dpq_assign,
                                           embedding_bag, flash_attention,
                                           pq_topk)]


@pytest.mark.gpu
def test_mace_step_repeats_on_card(cuda):
    """One adam step of ``node_class_loss`` run twice from the same
    state on a Zipf-sender graph (many rows onto the gather's backward
    and the receiver sum), bit for bit; ``segment_sum`` and
    ``gather_rows``' backward alone too."""
    from repro_torch.configs import get_arch
    from repro_torch.core.schemes.base import tree_leaves, tree_map
    from repro_torch.data.graph import random_graph
    from repro_torch.launch.train import GNN_OPTIMIZER
    from repro_torch.models.gnn.mace import MACE, gather_rows, segment_sum
    from repro_torch.train import optimizer as opt
    _, cfg = get_arch("mace", smoke=True)
    g = random_graph(2000, 20000, 16, n_classes=cfg.d_readout, seed=0)
    model = MACE(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0),
                        n_feat=16)
    step = opt.make_step_fn(GNN_OPTIMIZER, model.node_class_loss)
    runs = []
    for _ in range(2):
        state = opt.TrainState.create(GNN_OPTIMIZER,
                                      tree_map(torch.clone, params))
        runs.append(step(state, on_device(g, cuda))[0])
    for a, b in zip(tree_leaves(runs[0].params), tree_leaves(runs[1].params)):
        _same_bits(a, b)
    gen = torch.Generator(device=cuda).manual_seed(1)
    data = torch.randn((200_000, 16, 9), generator=gen, device=cuda)
    ids = torch.randint(0, 1000, (200_000,), generator=gen, device=cuda)
    _same_bits(segment_sum(data, ids, 1000), segment_sum(data, ids, 1000))
    x = torch.randn((1000, 16, 9), generator=gen, device=cuda)

    def grad():
        t = x.clone().requires_grad_(True)
        return torch.autograd.grad((gather_rows(t, ids) * data).sum(), t)[0]
    _same_bits(grad(), grad())


@pytest.mark.gpu
def test_mace_rotation_invariant_on_card_and_fails_without_the_mask(
        cuda, monkeypatch):
    """Smoke config on the card, a molecule batch padded with a self-loop
    a node: the energy moves under a rotation by less than JAX's bar
    (atol 1e-4 + rtol 1e-3 |E|); with the edge mask planted away it
    moves by more."""
    from repro_torch.configs import get_arch
    from repro_torch.data.graph import molecule_batch
    from repro_torch.models.gnn.mace import MACE
    _, cfg = get_arch("mace", smoke=True)
    g = molecule_batch(4, 12, 24, n_species=cfg.num_species, seed=2)
    n = len(g["positions"])
    g["edge_index"] = np.concatenate(
        [g["edge_index"], np.stack([np.arange(n)] * 2).astype(np.int32)], 1)
    a = 0.9
    rot = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                    [-np.sin(a), 0, np.cos(a)]], np.float32)
    model = MACE(cfg, device=cuda)
    params = model.init()

    def over():
        e1 = model.apply(params, on_device(g, cuda))["energy"]
        e2 = model.apply(params, on_device(dict(
            g, positions=g["positions"] @ rot.T), cuda))["energy"]
        return float(((e1 - e2).abs() - (1e-4 + 1e-3 * e1.abs())).max())
    assert over() <= 0
    monkeypatch.setattr(MACE, "_edge_mask",
                        lambda self, dist: torch.ones_like(dist))
    assert over() > 0


# ----------------------------------------------------------------------
# distributed serving: gloo ranks sharing the card, one NCCL rank
# ----------------------------------------------------------------------

MESH_TIMEOUT = 240.0
MESH_TABLES = {
    "mgqe": dict(kind="mgqe", mgqe_variant="private_k", num_subspaces=4,
                 num_centroids=16, tier_boundaries=(700, 1500),
                 tier_num_centroids=(16, 8, 4)),
    "rq": dict(kind="rq", num_levels=3, num_centroids=16),
    "mpe": dict(kind="mpe", num_subspaces=8, tier_boundaries=(700, 1500),
                tier_bits=(8, 4, 2)),
}
MESH_DECODE = {"mgqe": mgqe_decode, "rq": rq_decode_stages,
               "mpe": packed_decode}


def _mesh_tables():
    """Each scheme's table (2,048 rows, d = 16, tiers cut inside model
    shard 1) exported on the CPU: {name: (config fields, artifact)}."""
    out = {}
    for name, kw in MESH_TABLES.items():
        cfg = EmbeddingConfig(vocab_size=2048, dim=16, decode_block_b=64,
                              **kw)
        emb = Embedding(cfg, device="cpu")
        out[name] = (dataclasses.asdict(cfg),
                     emb.export(emb.init(emb.generator(0))))
    return out


def _gather_on_card_rank(rank, tables, ids_list):
    """quantized_gather and ServingEngine(mesh) on a (2, 2) mesh of
    gloo ranks on cuda:0, each case against the single-device decode
    kernel on the same card."""
    from repro_torch.launch.engine import ServingEngine
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.sharding.quantized import quantized_gather
    from repro_torch.sharding.rules import shard_quantized_artifact
    mesh = make_debug_mesh(2, 2)
    out = {}
    for name, (cfg_d, art) in tables.items():
        cfg = EmbeddingConfig(**cfg_d)
        emb = Embedding(cfg, device=mesh.device)
        dev = {k: ([t.to(mesh.device) for t in v] if isinstance(v, list)
                   else v.to(mesh.device)) for k, v in art.items()}
        scfg = dataclasses.replace(cfg, sharded_codes=True)
        local = shard_quantized_artifact(art, scfg, mesh)
        MESH_DECODE[name].launches = 0
        same = []
        for ids in ids_list:
            ids_t = torch.from_numpy(ids).to(mesh.device)
            want = emb.serve(dev, ids_t)
            got = quantized_gather(local, ids_t, scfg, mesh=mesh)
            same.append(torch.equal(got, want))
        eng = ServingEngine(emb, art, mesh=mesh, hot_rows=256)
        ref = ServingEngine(emb, art, device=mesh.device)
        flat = np.concatenate(ids_list)
        same.append(torch.equal(eng.lookup(flat), ref.lookup(flat)))
        out[name] = (same, MESH_DECODE[name].launches)
    return out


@pytest.mark.gpu
def test_quantized_gather_and_engine_on_card_with_gloo_ranks(cuda, tmp_path):
    from repro_torch.launch.mesh import spawn
    rng = np.random.default_rng(0)
    ids_list = [rng.integers(0, 2048, n).astype(np.int32)
                for n in (1, 7, 257, 1000)]
    tables = _mesh_tables()
    res = spawn(_gather_on_card_rank, 4, backend="gloo", device="cuda:0",
                args=(tables, ids_list), store_dir=str(tmp_path),
                timeout_s=MESH_TIMEOUT)
    for out in res:
        for name, (same, launches) in out.items():
            assert all(same), name
            assert launches > 0, name


def _topk_on_card_rank(rank, cases):
    from repro_torch.launch.engine import RetrievalEngine
    from repro_torch.launch.mesh import make_debug_mesh
    mesh = make_debug_mesh(2, 2)
    pq_topk.launches = pq_score_batched.launches = 0
    same = []
    for cfg, art, q in cases:
        index = get_index(cfg)
        eng = RetrievalEngine(index, art, k=50, block_q=16, mesh=mesh)
        ref = RetrievalEngine(index, art, k=50, block_q=16,
                              device=mesh.device)
        for b in (1, 33, 100):
            got, want = eng.search(q[:b]), ref.search(q[:b])
            same.append(torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1]))
    return same, pq_topk.launches, pq_score_batched.launches


@pytest.mark.gpu
def test_sharded_topk_on_card_with_gloo_ranks(cuda, tmp_path):
    from repro_torch.launch.mesh import spawn
    g = torch.Generator().manual_seed(0)
    vecs = torch.randn((8192, 32), generator=g)
    q = torch.randn((100, 32), generator=g).numpy()
    cases = []
    for cfg in (IndexConfig(num_subspaces=8, num_centroids=64, iters=3),
                IndexConfig(kind="ivf_pq", num_subspaces=8, num_centroids=64,
                            iters=3, nlist=32, nprobe=8,
                            list_cap_quantile=0.6)):
        art = get_index(cfg).build(torch.Generator().manual_seed(1), vecs)
        cases.append((cfg, {k: v.cpu() for k, v in art.items()}, q))
    res = spawn(_topk_on_card_rank, 4, backend="gloo", device="cuda:0",
                args=(cases,), store_dir=str(tmp_path),
                timeout_s=MESH_TIMEOUT)
    for same, topk_launches, score_launches in res:
        assert all(same)
        assert topk_launches > 0 and score_launches > 0


def _nccl_rank(rank, tables, ids):
    import torch.distributed as dist
    from repro_torch.launch.engine import ServingEngine
    from repro_torch.launch.mesh import make_debug_mesh
    mesh = make_debug_mesh(1, 1)
    t = torch.ones(4, device=mesh.device)
    dist.all_reduce(t)
    cfg_d, art = tables["mgqe"]
    emb = Embedding(EmbeddingConfig(**cfg_d), device=mesh.device)
    eng = ServingEngine(emb, art, mesh=mesh)
    ref = ServingEngine(emb, art, device=mesh.device)
    return (dist.get_backend(), bool((t == 1).all()),
            bool(torch.equal(eng.lookup(ids), ref.lookup(ids))))


@pytest.mark.gpu
def test_nccl_world_of_one_serves_through_the_mesh_engine(cuda, tmp_path):
    from repro_torch.launch.mesh import spawn
    tables = _mesh_tables()
    ids = np.random.default_rng(1).integers(0, 2048, 999)
    (res,) = spawn(_nccl_rank, 1, backend="nccl", device="cuda:0",
                   args=(tables, ids), store_dir=str(tmp_path),
                   timeout_s=MESH_TIMEOUT)
    assert res == ("nccl", True, True)


# ----------------------------------------------------------------------
# distributed recsys training: 4 gloo ranks sharing cuda:0
# ----------------------------------------------------------------------

MESH_TRAIN_BATCH = 256
MESH_TRAIN_STEPS = 3
MESH_TRAIN_TOL = 1e-5


def _mesh_train_batches(cfg, n=MESH_TRAIN_STEPS):
    from repro_torch.launch.train import recsys_stream
    stream = recsys_stream(cfg, MESH_TRAIN_BATCH)
    return [next(stream) for _ in range(n)]


def _leaf_list(tree):
    from repro_torch.core.schemes.base import tree_leaves
    return [t.detach().cpu() for t in tree_leaves(tree)]


def _mesh_train_rank(rank, what, ckpt_dir=None):
    """deepfm's smoke config on a (2, 2) mesh of ranks on cuda:0:
    ``steps`` -- each step's losses and reduced gradients; ``resume`` --
    the final params of a run through step 3 and of one resumed from
    its step-2 checkpoint; ``repeat`` -- one batch's reduced gradients
    twice."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.cells import recsys_train_cell
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.train.loop import LoopConfig, fit
    from repro_torch.train.optimizer import TrainState, apply_updates
    from repro_torch.launch.train import RECSYS_OPTIMIZER
    mesh = make_debug_mesh(2, 2)
    _, cfg = get_arch("deepfm", smoke=True)
    batches = _mesh_train_batches(cfg)

    def cell_and_data(start=0):
        cell = recsys_train_cell(cfg, mesh)
        return cell, [on_device(cell.local_batch(b), mesh.device)
                      for b in batches[start:]]

    if what == "steps":
        cell, data = cell_and_data()
        state, out = cell.state, []
        for b in data:
            grads, metrics = cell.reduce(*cell.grads(state, b))
            out.append((float(metrics["loss"]), _leaf_list(grads)))
            params, opt = apply_updates(RECSYS_OPTIMIZER, state.params,
                                        grads, state.opt_state, mesh=mesh,
                                        specs=cell.specs.params)
            state = TrainState(params, opt)
        return out, cell.split
    if what == "resume":
        cell, data = cell_and_data()
        state, _ = fit(cell.state, cell.step, iter(data), LoopConfig(
            total_steps=2, ckpt_every=2, ckpt_dir=ckpt_dir), mesh=mesh,
            specs=cell.specs)
        state, _ = fit(state, cell.step, iter(data[2:]),
                       LoopConfig(total_steps=1), resume=False)
        cell2, data2 = cell_and_data(2)
        resumed, _ = fit(cell2.state, cell2.step, iter(data2), LoopConfig(
            total_steps=3, ckpt_dir=ckpt_dir), mesh=mesh, specs=cell2.specs)
        return _leaf_list(state.params), _leaf_list(resumed.params)
    cell, data = cell_and_data()
    return [_leaf_list(cell.reduce(*cell.grads(cell.state, data[0]))[0])
            for _ in range(2)]


@pytest.mark.gpu
def test_sharded_recsys_steps_on_card_match_one_device(cuda, tmp_path):
    """3 adagrad steps of deepfm's smoke config on a (2, 2) mesh of gloo
    ranks on the card: each step's loss and reduced gradients (a row
    block's of its rows) within 1e-5 of one device's step on the
    global batch."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import spawn
    from repro_torch.launch.train import recsys_setup
    from repro_torch.train.optimizer import loss_grads
    res = spawn(_mesh_train_rank, 4, backend="gloo", device="cuda:0",
                args=("steps",), store_dir=str(tmp_path),
                timeout_s=MESH_TIMEOUT)
    _, cfg = get_arch("deepfm", smoke=True)
    model, state, step, _ = recsys_setup(cfg, MESH_TRAIN_BATCH)
    want = []
    for b in _mesh_train_batches(cfg):
        b = on_device(b, cuda)
        grads, metrics = loss_grads(model.loss, state.params, b)
        want.append((float(metrics["loss"]), _leaf_list(grads)))
        state, _ = step(state, b)
    for rank, (steps, split) in enumerate(res):
        for (loss, grads), (w_loss, w_grads) in zip(steps, want,
                                                    strict=True):
            assert abs(loss - w_loss) <= MESH_TRAIN_TOL * max(1, abs(w_loss))
            for g, w, cut in zip(grads, w_grads, split, strict=True):
                if cut:
                    n = g.shape[0]
                    w = w[(rank % 2) * n:(rank % 2 + 1) * n]
                torch.testing.assert_close(g, w, rtol=MESH_TRAIN_TOL,
                                           atol=MESH_TRAIN_TOL)


@pytest.mark.gpu
def test_sharded_resume_on_card_is_bit_identical(cuda, tmp_path):
    """A (2, 2) run checkpointed at step 2 (whole arrays) and resumed on
    the same mesh ends bit for bit where the uninterrupted run does."""
    from repro_torch.launch.mesh import spawn
    res = spawn(_mesh_train_rank, 4, backend="gloo", device="cuda:0",
                args=("resume", str(tmp_path / "ckpt")),
                store_dir=str(tmp_path),
                timeout_s=MESH_TIMEOUT)
    for straight, resumed in res:
        for a, b in zip(straight, resumed, strict=True):
            _same_bits(b, a)


@pytest.mark.gpu
def test_sharded_backward_repeats_on_card(cuda, tmp_path):
    """The sharded gather's backward (``dout`` gathered, an ordered
    ``index_put_`` into the block) gives the same bits twice."""
    from repro_torch.launch.mesh import spawn
    res = spawn(_mesh_train_rank, 4, backend="gloo", device="cuda:0",
                args=("repeat",), store_dir=str(tmp_path),
                timeout_s=MESH_TIMEOUT)
    for first, second in res:
        for a, b in zip(first, second, strict=True):
            _same_bits(b, a)


# ----------------------------------------------------------------------
# LM training on a (2, 2) mesh of gloo ranks sharing the card
# ----------------------------------------------------------------------

LM_MESH_BATCH, LM_MESH_SEQ = 4, 16
# (arch, config changes, microbatches): the chunked route (the
# flash_attention kernel) at the smoke widths; FSDP, remat and
# microbatches; both grouped-MoE strategies; the global MoE formulation
LM_MESH_CASES = {
    "stablelm-fsdp-remat-mb2": ("stablelm-3b", {"fsdp_params": True,
                                                "remat": True}, 2),
    "qwen3-expert": ("qwen3-moe-30b-a3b", {"moe_shard_map": True}, 1),
    "qwen3-ffn": ("qwen3-moe-30b-a3b", {"moe_shard_map": True,
                                        "num_experts": 3}, 1),
    "mixtral": ("mixtral-8x7b", {}, 1),
}


def _lm_mesh_cfg(case):
    from repro_torch.configs import get_arch
    arch, changes, mb = LM_MESH_CASES[case]
    _, cfg = get_arch(arch, smoke=True)
    return dataclasses.replace(cfg, attention_impl="chunked",
                               **changes), mb


def _lm_mesh_batch(cfg):
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (LM_MESH_BATCH, LM_MESH_SEQ + 1))
    return {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)),
            "labels": torch.from_numpy(toks[:, 1:].astype(np.int32))}


def _lm_mesh_rank(rank, case):
    """The first step of ``lm_train_cell`` on a (2, 2) mesh on cuda:0:
    the global loss, the accumulated gradients' blocks (as the moments
    are placed), their specs and this rank's coordinates."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.cells import lm_train_cell
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.sharding.rules import spec_leaves
    mesh = make_debug_mesh(2, 2)
    cfg, mb = _lm_mesh_cfg(case)
    cell = lm_train_cell(cfg, mesh, mb)
    flash_attention.launches = 0
    acc, metrics = cell.accumulate(cell.state, on_device(
        cell.local_batch(_lm_mesh_batch(cfg)), mesh.device))
    return (float(metrics["loss"]), [g.float().cpu() for g in acc],
            spec_leaves(cell.specs.opt_state["m"]),
            (mesh.axis_index("data"), mesh.axis_index("model")),
            flash_attention.launches)


def _block_of(t: torch.Tensor, spec, coords) -> torch.Tensor:
    """The block of ``t`` a rank at ``coords`` (data, model) of a (2, 2)
    mesh holds under ``spec``."""
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        n, i = 1, 0
        for a in axes:
            n, i = n * 2, i * 2 + coords[("data", "model").index(a)]
        t = t.narrow(dim, i * (t.shape[dim] // n), t.shape[dim] // n)
    return t


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(LM_MESH_CASES))
def test_lm_mesh_step_on_card_matches_one_device(cuda, tmp_path, case):
    """One step of ``lm_train_cell`` on a (2, 2) mesh of 4 gloo ranks on
    the card (the flash_attention kernel on each rank's heads): the loss
    and every gradient leaf's block within 1e-5 of one device's step on
    the global batch (the grouped MoE's plain version,
    ``moe_ffn_grouped``, for ``moe_shard_map``), microbatches averaged
    as the cell does."""
    import functools
    from repro_torch.core.schemes.base import tree_leaves
    from repro_torch.launch.mesh import spawn
    from repro_torch.models import lm
    from repro_torch.nn import moe
    from repro_torch.train.optimizer import loss_grads
    res = spawn(_lm_mesh_rank, 4, backend="gloo", device="cuda:0",
                args=(case,), store_dir=str(tmp_path),
                timeout_s=MESH_TIMEOUT)
    cfg, mb = _lm_mesh_cfg(case)
    params = lm.model_init(torch.Generator(device="cuda").manual_seed(0),
                           cfg)
    batch = on_device(_lm_mesh_batch(cfg), cuda)
    single = moe.moe_ffn

    def grouped(params, x, *, mesh=None, **kw):
        return moe.moe_ffn_grouped(params, x, data_n=2, model_n=2, **kw)

    if cfg.moe_shard_map:
        moe.moe_ffn = grouped
    try:
        rows = LM_MESH_BATCH // mb
        grads, loss = None, 0.0
        for i in range(mb):
            part = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
            g, metrics = loss_grads(functools.partial(
                lm.loss_fn, cfg=dataclasses.replace(cfg,
                                                    moe_shard_map=False)),
                params, part)
            g = [x.float() for x in tree_leaves(g)]
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
            loss += float(metrics["loss"]) / mb
    finally:
        moe.moe_ffn = single
    grads = [g / mb for g in grads]
    for r_loss, blocks, specs, coords, launches in res:
        assert abs(r_loss - loss) <= MESH_TRAIN_TOL * max(1.0, abs(loss))
        assert launches > 0
        for got, want, spec in zip(blocks, grads, specs, strict=True):
            torch.testing.assert_close(got, _block_of(want, spec,
                                                      coords).cpu(),
                                       rtol=MESH_TRAIN_TOL,
                                       atol=MESH_TRAIN_TOL)


def _moe_mesh_rank(rank, e):
    """``moe_ffn_sharded`` on a (2, 2) mesh on cuda:0 (8 experts: the
    expert strategy; 3: the ffn strategy) at capacity 64: this data
    shard's outputs (gathered over model), the aux and the gradients of
    sum(out * cos(out)) + aux, summed over data."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.nn import moe
    from repro_torch.sharding import collectives as coll
    mesh = make_debug_mesh(2, 2)
    params, x = _moe_mesh_inputs(e)
    d, m = mesh.axis_index("data"), mesh.axis_index("model")
    expert = moe.expert_parallel(e, 2)
    dims = {"router": None, "w_gate": 0 if expert else 2,
            "w_up": 0 if expert else 2, "w_down": 0 if expert else 1}
    local = {k: v if dims[k] is None else v.narrow(
        dims[k], m * v.shape[dims[k]] // 2, v.shape[dims[k]] // 2).clone()
        for k, v in params.items()}
    xd = x[d * 2:(d + 1) * 2].clone()
    for t in list(local.values()) + [xd]:
        t.requires_grad_(True)
    kw = dict(top_k=2, capacity_factor=64.0, mesh=mesh)
    if expert:
        out, aux = moe.moe_ffn_sharded(
            local, coll.scatter_to(xd, mesh, "model", 1), **kw)
        out = coll.gather_from(out, mesh, "model", 1)
    else:
        out, aux = moe.moe_ffn_sharded(local, xd, **kw)
    loss = torch.sum(out * torch.cos(out)) + aux / 2
    names = sorted(local)
    grads = torch.autograd.grad(loss, [local[k] for k in names] + [xd])
    return (out.detach().cpu(), float(aux), (d, m), dims,
            {k: coll.psum(g, mesh, "data").cpu()
             for k, g in zip(names, grads)}, grads[-1].cpu())


def _moe_mesh_inputs(e):
    """JAX's test's shapes: d 32, d_ff 64, e experts, x (4, 16, 32)."""
    from repro_torch.nn import moe
    g = torch.Generator(device="cuda").manual_seed(e)
    return moe.moe_init(g, 32, 64, e), torch.randn(
        (4, 16, 32), generator=g, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("e", [8, 3])
def test_moe_ffn_sharded_on_card_both_strategies(cuda, tmp_path, e):
    """``moe_ffn_sharded`` on a (2, 2) mesh of 4 gloo ranks on the card,
    the expert strategy (8 experts, all-to-all over model) and the ffn
    strategy (3 experts, d_ff over model): outputs, aux and every
    gradient within 1e-5 of ``moe_ffn_grouped`` on one device."""
    from repro_torch.launch.mesh import spawn
    from repro_torch.nn import moe
    res = spawn(_moe_mesh_rank, 4, backend="gloo", device="cuda:0",
                args=(e,), store_dir=str(tmp_path), timeout_s=MESH_TIMEOUT)
    params, x = _moe_mesh_inputs(e)
    for t in list(params.values()) + [x]:
        t.requires_grad_(True)
    out, aux = moe.moe_ffn_grouped(params, x, top_k=2, capacity_factor=64.0,
                                   data_n=2, model_n=2)
    names = sorted(params)
    grads = torch.autograd.grad(torch.sum(out * torch.cos(out)) + aux,
                                [params[k] for k in names] + [x])
    want = dict(zip(names, grads))
    for r_out, r_aux, (d, m), dims, r_grads, r_dx in res:
        rows = slice(d * 2, (d + 1) * 2)
        torch.testing.assert_close(r_out, out[rows].detach().cpu(),
                                   rtol=MESH_TRAIN_TOL, atol=MESH_TRAIN_TOL)
        assert abs(r_aux - float(aux)) <= MESH_TRAIN_TOL
        torch.testing.assert_close(r_dx, grads[-1][rows].cpu(),
                                   rtol=MESH_TRAIN_TOL, atol=MESH_TRAIN_TOL)
        for k in names:
            w = want[k]
            if dims[k] is not None:
                n = w.shape[dims[k]] // 2
                w = w.narrow(dims[k], m * n, n)
            torch.testing.assert_close(r_grads[k], w.cpu(),
                                       rtol=MESH_TRAIN_TOL,
                                       atol=MESH_TRAIN_TOL)


# LM serving on a (data, model) mesh of 4 gloo ranks on the card: the
# smoke configs on the chunked route (the flash_attention kernel on each
# rank's heads), prefilled and decoded through the serving cells
LM_SERVE_BATCH, LM_SERVE_PROMPT, LM_SERVE_STEPS = 2, 16, 4
LM_SERVE_MAX_SEQ = 24                  # prompt + steps, in blocks of 4 slots
LM_SERVE_CASES = {
    "stablelm": ("stablelm-3b", {}, (2, 2)),
    "gemma3-4b-split": ("gemma3-4b", {"split_local_global_cache": True},
                        (2, 2)),
    "gemma3-27b": ("gemma3-27b", {}, (2, 2)),
    "mixtral": ("mixtral-8x7b", {}, (2, 2)),
    "qwen3": ("qwen3-moe-30b-a3b", {}, (2, 2)),
    # 2 kv heads over model = 4: the cache's sequence over model
    "gemma3-4b-seq": ("gemma3-4b", {}, (1, 4)),
}


def _lm_serve_cfg(case):
    from repro_torch.configs import get_arch
    arch, changes, _ = LM_SERVE_CASES[case]
    _, cfg = get_arch(arch, smoke=True)
    return dataclasses.replace(cfg, attention_impl="chunked", **changes)


def _lm_serve_prompts(cfg):
    return np.random.default_rng(4).integers(
        0, cfg.vocab_size, (LM_SERVE_BATCH, LM_SERVE_PROMPT)).astype(np.int32)


def _lm_serve_rank(rank, case):
    """The serving cells of a case on its mesh on cuda:0 (params drawn
    from a generator seeded 0 on the card, the token table exported once):
    this rank's prefill and decode logits, its tokens, its coordinates
    and its flash_attention launches."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.cells import lm_decode_cell, lm_prefill_cell
    from repro_torch.launch.mesh import make_debug_mesh
    mesh = make_debug_mesh(*LM_SERVE_CASES[case][2])
    cfg = _lm_serve_cfg(case)
    spec = ShapeSpec("t", "prefill", seq_len=LM_SERVE_PROMPT,
                     global_batch=LM_SERVE_BATCH)
    pre = lm_prefill_cell(cfg, spec, mesh, max_seq=LM_SERVE_MAX_SEQ)
    dec = lm_decode_cell(cfg, dataclasses.replace(
        spec, kind="decode", seq_len=LM_SERVE_MAX_SEQ), mesh,
        served=pre.served)
    flash_attention.launches = 0
    cache, logits = pre.step(pre.local_tokens(_lm_serve_prompts(cfg)))
    out, toks = [logits.cpu()], [torch.argmax(logits, -1).to(torch.int32)]
    for _ in range(LM_SERVE_STEPS):
        cache, logits = dec.step(cache, toks[-1])
        out.append(logits.cpu())
        toks.append(torch.argmax(logits, -1).to(torch.int32))
    return (mesh.axis_index("data"), out, torch.stack(toks, 1).cpu(),
            flash_attention.launches)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(LM_SERVE_CASES))
def test_lm_serve_mesh_on_card_matches_one_device(cuda, tmp_path, case):
    """``lm_prefill_cell`` and ``lm_decode_cell`` on 4 gloo ranks sharing
    the card: every rank's prefill logits and each of 4 greedy decode
    steps' within 1e-5 of one device's serve of the same params and
    artifact, its tokens equal, the kernel launched on every rank."""
    from repro_torch.core import Embedding
    from repro_torch.launch.mesh import spawn
    from repro_torch.models import lm
    res = spawn(_lm_serve_rank, 4, backend="gloo", device="cuda:0",
                args=(case,), store_dir=str(tmp_path),
                timeout_s=MESH_TIMEOUT)
    cfg = _lm_serve_cfg(case)
    params = lm.model_init(torch.Generator(device="cuda").manual_seed(0),
                           cfg)
    emb = Embedding(dataclasses.replace(cfg.embedding,
                                        param_dtype=cfg.param_dtype),
                    device="cuda")
    with torch.no_grad():
        art = emb.export(params["embed"])
        cache, logits = lm.prefill(
            params, torch.from_numpy(_lm_serve_prompts(cfg)).to(cuda), cfg,
            max_seq=LM_SERVE_MAX_SEQ, embed_artifact=art)
        want, toks = [logits.cpu()], [torch.argmax(logits, -1).to(
            torch.int32)]
        for _ in range(LM_SERVE_STEPS):
            cache, logits = lm.decode_step(params, cache, toks[-1], cfg,
                                           embed_artifact=art)
            want.append(logits.cpu())
            toks.append(torch.argmax(logits, -1).to(torch.int32))
    toks = torch.stack(toks, 1).cpu()
    bl = LM_SERVE_BATCH // LM_SERVE_CASES[case][2][0]
    for d, got, r_toks, launches in res:
        rows = slice(d * bl, (d + 1) * bl)
        assert launches == cfg.num_layers
        assert torch.equal(r_toks, toks[rows])
        for g, w in zip(got, want, strict=True):
            torch.testing.assert_close(g, w[rows], rtol=MESH_TRAIN_TOL,
                                       atol=MESH_TRAIN_TOL)


# ----------------------------------------------------------------------
# the recsys serving and retrieval cells and MACE's training cell on a
# (2, 2) mesh of gloo ranks sharing the card
# ----------------------------------------------------------------------

CELL_BATCH = 64
CELL_CAND = {"deepfm": 256, "autoint": 256, "bst": 128,
             "two-tower-retrieval": 4096}


def _cell_cfg(arch):
    from repro_torch.configs import get_arch
    return get_arch(arch, smoke=True)[1]


def _cell_batch(arch, cfg, b, seed):
    rng = np.random.default_rng(seed)
    if arch == "two-tower-retrieval":
        return {"user_ids": rng.integers(0, cfg.n_users, b).astype(np.int32),
                "item_ids": rng.integers(0, cfg.n_items, b).astype(np.int32)}
    if arch == "bst":
        return {"hist_ids": rng.integers(0, cfg.n_items, (b, cfg.seq_len))
                .astype(np.int32),
                "target_id": rng.integers(0, cfg.n_items, b).astype(np.int32)}
    return {"sparse_ids": np.stack([rng.integers(0, v, b) for v in
                                    cfg.field_vocab_sizes], 1)
            .astype(np.int32)}


def _cell_corpus(cfg, n):
    rng = np.random.default_rng(5)
    d_out = cfg.tower_mlp[-1]
    n_sub = 16 if d_out % 16 == 0 else 8
    return {"codes": rng.integers(0, 256, (n, n_sub)).astype(np.uint8),
            "centroids": rng.normal(size=(n_sub, 256, d_out // n_sub))
            .astype(np.float32)}


def _cell_rows(model, artifacts, batch, mesh=None):
    from repro_torch.models.recsys.fields import serve_placed
    with torch.no_grad():
        if model.cfg.model == "bst":
            return serve_placed(model.item_emb, artifacts, model.ids(batch),
                                mesh)
        return model.fields.serve(artifacts, batch["sparse_ids"], mesh=mesh)


def _recsys_cells_rank(rank, arch):
    """The serving cell (params seeded 0 on the card, exported on the
    rank) and the retrieval cell of ``arch`` on (2, 2): this rank's data
    coordinate, logits, decoded rows, scores, and its mgqe_decode and
    pq_score launches."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels.mgqe_decode import mgqe_decode
    from repro_torch.kernels.pq_score import pq_score
    from repro_torch.launch.cells import (recsys_retrieval_cell,
                                          recsys_serve_cell)
    from repro_torch.launch.mesh import make_debug_mesh
    mesh = make_debug_mesh(2, 2)
    cfg = _cell_cfg(arch)
    cell = recsys_serve_cell(cfg, ShapeSpec("t", "rec_serve",
                                            batch=CELL_BATCH), mesh)
    mgqe_decode.launches = pq_score.launches = 0
    batch = cell.local_batch(_cell_batch(arch, cfg, CELL_BATCH, 1))
    logits = cell.step(batch).cpu()
    rows = None if cell.artifacts is None else _cell_rows(
        cell.model, cell.artifacts, batch, mesh).cpu()
    n = CELL_CAND[arch]
    rcell = recsys_retrieval_cell(cfg, ShapeSpec(
        "t", "rec_retrieval", batch=1, n_candidates=n), mesh)
    if arch == "two-tower-retrieval":
        scores = rcell.step(rcell.local_corpus(_cell_corpus(cfg, n)),
                            torch.tensor([7], dtype=torch.int32))
    else:
        scores = rcell.step(rcell.local_candidates(
            _cell_batch(arch, cfg, n, 2)))
    return (mesh.axis_index("data"), logits, rows, scores.cpu(),
            mgqe_decode.launches, pq_score.launches)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["deepfm", "autoint", "bst",
                                  "two-tower-retrieval"])
def test_recsys_cells_on_card_match_one_device(cuda, tmp_path, arch):
    """``recsys_serve_cell`` and ``recsys_retrieval_cell`` on 4 gloo ranks
    sharing the card: every rank's logits within 1e-5 of one device's
    serve of the same params and artifacts (their decoded rows bit for
    bit, ``mgqe_decode`` launched on every rank), the retrieval scores
    within 1e-5 (two-tower: ``pq_score`` on every rank, the top-100 ids
    identical)."""
    from repro_torch.launch.cells import (recsys_export, recsys_model,
                                          serve_params)
    from repro_torch.launch.mesh import spawn
    from repro_torch.retrieval.flat_pq import adc_scores
    res = spawn(_recsys_cells_rank, 4, backend="gloo", device="cuda:0",
                args=(arch,), store_dir=str(tmp_path),
                timeout_s=MESH_TIMEOUT)
    cfg = _cell_cfg(arch)
    model = recsys_model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    batch = on_device(_cell_batch(arch, cfg, CELL_BATCH, 1), "cuda")
    n = CELL_CAND[arch]
    with torch.no_grad():
        if arch == "two-tower-retrieval":
            u, _ = model.user_vec(params, batch["user_ids"])
            v, _ = model.item_vec(params, batch["item_ids"])
            want, rows = torch.sum(u * v, -1).cpu(), None
            q, _ = model.user_vec(params, torch.tensor(
                [7], dtype=torch.int32, device="cuda"))
            scores = adc_scores(on_device(_cell_corpus(cfg, n), "cuda"),
                                q[0]).cpu()
        else:
            arts = recsys_export(model, params)
            want = model.serve(serve_params(cfg, params), arts, batch).cpu()
            rows = _cell_rows(model, arts, batch).cpu()
            scores = model.apply(params, on_device(
                _cell_batch(arch, cfg, n, 2), "cuda"))[0].cpu()
    bl = CELL_BATCH // 2
    for d, logits, r_rows, r_scores, mgqe, pq in res:
        part = slice(d * bl, (d + 1) * bl)
        torch.testing.assert_close(logits, want[part], rtol=MESH_TRAIN_TOL,
                                   atol=MESH_TRAIN_TOL)
        torch.testing.assert_close(r_scores, scores, rtol=MESH_TRAIN_TOL,
                                   atol=MESH_TRAIN_TOL)
        if rows is not None:
            _same_bits(r_rows, rows[part])
            assert mgqe > 0
        else:
            assert pq == 1
            top = torch.sort(r_scores, descending=True, stable=True)[1]
            want_top = torch.sort(scores, descending=True, stable=True)[1]
            assert torch.equal(top[:100], want_top[:100])


def _mace_cell_graph(task):
    """A graph whose N and E do not divide by 4 (both padded)."""
    from repro_torch.data import graph
    cfg = _cell_cfg("mace")
    if task == "energy":
        return graph.molecule_batch(n_graphs=7, n_atoms=9, n_edges=17,
                                    n_species=cfg.num_species, seed=3)
    return graph.random_graph(201, 1003, 12, n_classes=cfg.d_readout,
                              seed=4)


def _mace_cell_shape(task):
    from repro_torch.configs.base import ShapeSpec
    if task == "energy":
        return ShapeSpec("t", "graph_batched", n_nodes=9, n_edges=17,
                         batch_graphs=7)
    return ShapeSpec("t", "graph_full", n_nodes=201, n_edges=1003,
                     d_feat=12)


def _mace_cell_rank(rank, task):
    """One step of ``mace_cell`` (params seeded 0 on the card) on (2, 2):
    the metrics and the params after, gathered whole."""
    from repro_torch.core.schemes.base import tree_leaves
    from repro_torch.launch.cells import mace_cell
    from repro_torch.launch.mesh import make_debug_mesh
    mesh = make_debug_mesh(2, 2)
    cell = mace_cell(_cell_cfg("mace"), _mace_cell_shape(task), mesh)
    state, metrics = cell.step(cell.state,
                               cell.local_graph(_mace_cell_graph(task)))
    with torch.no_grad():
        whole = [t.cpu() for t in tree_leaves(
            cell.whole_params(state.params))]
    return {k: float(v) for k, v in metrics.items()}, whole


@pytest.mark.gpu
@pytest.mark.parametrize("task", ["energy", "node_class"])
def test_mace_cell_on_card_matches_one_device(cuda, tmp_path, task):
    """``mace_cell``'s adam step on 4 gloo ranks sharing the card, on a
    padded graph: metrics within 1e-5 of one device's step from the same
    params, every param within 1e-5 but adam's ill-conditioned elements
    (a first-step |g| < 1e-6, held at 2·lr), and the step moved the
    params."""
    from repro_torch.core.schemes.base import tree_leaves
    from repro_torch.launch.mesh import spawn
    from repro_torch.launch.train import GNN_OPTIMIZER
    from repro_torch.models.gnn.mace import MACE
    from repro_torch.train import optimizer as opt
    res = spawn(_mace_cell_rank, 4, backend="gloo", device="cuda:0",
                args=(task,), store_dir=str(tmp_path),
                timeout_s=MESH_TIMEOUT)
    cfg = _cell_cfg("mace")
    model = MACE(cfg, device="cuda")
    d_feat = 12 if task == "node_class" else None
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        n_feat=d_feat)
    loss = model.energy_loss if task == "energy" else model.node_class_loss
    init = [t.to("cpu", copy=True) for t in tree_leaves(params)]
    state, metrics = opt.make_step_fn(GNN_OPTIMIZER, loss)(
        opt.TrainState.create(GNN_OPTIMIZER, params),
        on_device(_mace_cell_graph(task), "cuda"))
    grads = [(m / (1 - GNN_OPTIMIZER.b1)).cpu()
             for m in tree_leaves(state.opt_state["m"])]
    want = [t.cpu() for t in tree_leaves(state.params)]
    for got_metrics, got in res:
        for k, v in metrics.items():
            assert abs(got_metrics[k] - float(v)) <= \
                MESH_TRAIN_TOL * (1 + abs(float(v)))
        for a, b, g in zip(got, want, grads, strict=True):
            tiny = (g != 0) & (g.abs() < 1e-6)
            torch.testing.assert_close(a[~tiny], b[~tiny],
                                       rtol=MESH_TRAIN_TOL,
                                       atol=MESH_TRAIN_TOL)
            assert bool(((a - b).abs()[tiny] <= 2e-3).all())
        assert max(float((a - i).abs().max())
                   for a, i in zip(got, init)) > 1e-4


# ----------------------------------------------------------------------
# long_500k's sequence-parallel decode, and each op's cost
# ----------------------------------------------------------------------

LONG_PROMPT, LONG_MAX_SEQ, LONG_STEPS = 12, 32, 3


def _long_rank(rank, mesh_shape):
    """gemma3-4b's smoke config through ``build_cell``'s long_500k cell
    (B = 1, ``split_cache``) on cuda:0: a prompt prefilled on one device
    of this rank (the cache placed by ``lm_cache_spec``'s B = 1 branch),
    then LONG_STEPS greedy steps fed the one-device run's tokens; the
    logits of both routes."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import lm
    from repro_torch.sharding.collectives import all_gather
    from repro_torch.sharding.rules import (NamedSpec, lm_cache_spec,
                                            strip_embed_table)
    mesh = make_debug_mesh(*mesh_shape)
    _, cfg = get_arch("gemma3-4b", smoke=True)
    shape = ShapeSpec("long_500k", "decode", seq_len=LONG_MAX_SEQ,
                      global_batch=1)
    cell = build_cell("gemma3-4b", shape, mesh, opts=("split_cache",),
                      cfg=cfg)
    scfg = cell.cell.cfg
    params, art, _, _ = cell.args
    # one device: the same draw (the cell's params come from a generator
    # seeded 0 on the card, as here), whole
    whole = strip_embed_table(lm.model_init(
        torch.Generator(device="cuda").manual_seed(0), scfg))
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, scfg.vocab_size, (1, LONG_PROMPT)).astype(np.int32)).cuda()
    with torch.no_grad():
        full_art = dict(art)
        full_art["codes"] = all_gather(art["codes"], mesh, "model")
        cache, logits = lm.prefill(whole, toks, scfg, max_seq=LONG_MAX_SEQ,
                                   embed_artifact=full_art)
        specs = lm_cache_spec(scfg, 1, mesh, False, cache)
        block = {k: v if k == "pos" else tuple(
            NamedSpec(mesh, sp).block(t).contiguous()
            for t, sp in zip(v, specs[k])) for k, v in cache.items()}
        one, mine = [], []
        for _ in range(LONG_STEPS):
            tok = torch.argmax(logits, -1).to(torch.int32)
            block, got = cell.fn(params, art, block,
                                 cell.cell.local_tokens(tok))
            cache, logits = lm.decode_step(whole, cache, tok, scfg,
                                           embed_artifact=full_art)
            one.append(logits.cpu())
            mine.append(got.cpu())
    return one, mine


@pytest.mark.gpu
@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 1)])
def test_long_500k_split_decode_on_card_matches_one_device(cuda, tmp_path,
                                                           mesh_shape):
    """long_500k's cell on 4 gloo ranks sharing the card (the cache's
    sequence over data, kv heads over model on (2, 2)) against the same
    rank's one-device decode of the same cache: every step's logits
    within 1e-5 (float32), the tokens equal."""
    from repro_torch.launch.mesh import spawn
    res = spawn(_long_rank, 4, backend="gloo", device="cuda:0",
                args=(mesh_shape,), store_dir=str(tmp_path), timeout_s=300)
    for one, mine in res:
        for a, b in zip(one, mine, strict=True):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                       atol=1e-5)
            assert torch.equal(a.argmax(-1), b.argmax(-1))


@pytest.mark.gpu
def test_each_op_cost_is_its_rows_bound(cuda):
    """Every op's ``cost`` on card tensors at its kernel's path shape is
    the bound column's count (PERF.md §6: bytes read once and written
    once over HBM, FLOPs over the dtype's peak), and a dispatched call
    inside the counter counts once at that cost."""
    from repro_torch.kernels import dispatch
    from repro_torch.roofline import CostCounter, kernel_roofline, peak_flops
    from repro_torch.roofline import HBM_BW
    g = torch.Generator(device="cuda").manual_seed(0)
    b, d, k, s, n, q = 4096, 5, 256, 2, 1 << 20, 8
    codes = torch.randint(0, k, (b, d), generator=g, device="cuda",
                          dtype=torch.uint8)
    cent = torch.randn((d, k, s), generator=g, device="cuda")
    cbs = torch.randn((d, k, 10), generator=g, device="cuda")
    packed = pack_codes(torch.randint(0, 16, (b, d), generator=g,
                                      device="cuda", dtype=torch.int32), 4)
    pcent = torch.randn((d, 16, s), generator=g, device="cuda")
    e = torch.randn((b, d, s), generator=g, device="cuda")
    lim = torch.full((b,), 64, device="cuda", dtype=torch.int32)
    table = torch.randn((100_000, 16), generator=g, device="cuda")
    ids = torch.randint(0, 100_000, (8192,), generator=g, device="cuda")
    seg = torch.sort(torch.randint(0, 512, (8192,), generator=g,
                                   device="cuda")).values.to(torch.int32)
    qh = torch.randn((1, 256, 4, 64), generator=g, device="cuda",
                     dtype=torch.bfloat16)
    kh = torch.randn((1, 256, 2, 64), generator=g, device="cuda",
                     dtype=torch.bfloat16)
    luts = torch.randn((4, q, k), generator=g, device="cuda")
    pq = torch.randint(0, k, (n, q), generator=g, device="cuda",
                       dtype=torch.uint8)
    pairs = 256 * 257 // 2
    cases = {
        "mgqe_decode": ((codes, cent), {},
                        (0, b * d + d * k * s * 4 + b * d * s * 4)),
        "rq_decode_stages": ((codes, cbs), {},
                             (b * (d - 1) * 10,
                              b * d + d * k * 10 * 4 + b * 10 * 4)),
        "packed_decode": ((packed, pcent, 4), {},
                          (0, packed.numel() + d * 16 * s * 4
                           + b * d * s * 4)),
        "dpq_assign": ((e, cent, lim), {},
                       (2 * s * d * b * 64,
                        b * d * s * 4 + d * k * s * 4 + b * d * 4 + b * 4)),
        "embedding_bag": ((table, ids, seg, 512), {},
                          (8192 * 16, 8192 * 16 * 4 + 8192 * 12
                           + 512 * 16 * 4)),
        "flash_attention": ((qh, kh, kh), {},
                            (4 * 64 * pairs * 4, (2 * qh.numel()
                                                  + 2 * kh.numel()) * 2)),
        "pq_score": ((luts[0], pq), {}, (n * q, n * q + q * k * 4 + n * 4)),
        "pq_score_batched": ((luts, pq), {},
                             (4 * n * q, n * q + 4 * q * k * 4 + 4 * n * 4)),
        "pq_topk": ((luts, pq, 100), {},
                    (4 * n * q, n * q + 4 * q * k * 4 + 4 * 100 * 8)),
    }
    assert set(cases) == set(dispatch.registered_ops())
    for name, (args, kw, (flops, nbytes)) in cases.items():
        cost = dispatch.op_cost(name, *args, **kw)
        assert (cost.flops, cost.bytes) == (flops, nbytes), name
        bound = kernel_roofline(cost.flops, cost.bytes, dtype=cost.dtype)
        assert bound["bound_ms"] == pytest.approx(1e3 * max(
            nbytes / HBM_BW, flops / peak_flops(cost.dtype))), name
        counter = CostCounter()
        with dispatch.counting(counter), counter:
            dispatch.dispatch(name, *args, **kw)
        assert counter.ops == {name: 1}, name
        assert counter.bytes == nbytes, name
