"""The port's CUDA kernels on the card, held to their plain versions.

Every test here is marked ``gpu`` and skips (in the ``cuda`` fixture,
at run time) where there is no card.  The file imports nothing of JAX,
so it runs on a machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu \\
        tests/test_torch_gpu.py

(``--noconftest``: the suite's conftest imports JAX.)
"""
import numpy as np
import pytest
import torch

from repro_torch.core import Embedding, EmbeddingConfig
from repro_torch.kernels.dpq_assign import dpq_assign, dpq_assign_ref
from repro_torch.kernels.mgqe_decode import mgqe_decode, mgqe_decode_ref
from repro_torch.launch import engine

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


@pytest.mark.gpu
@pytest.mark.parametrize("block_b", [64, 256, 1024])
@pytest.mark.parametrize("shape", [(4096, 5, 256, 2), (4096, 8, 256, 8),
                                   (2048, 4, 64, 16), (65536, 5, 256, 2),
                                   (300, 3, 100, 3)],
                         ids=lambda s: "x".join(map(str, s)))
def test_dpq_assign_kernel_matches_plain(cuda, shape, block_b):
    b, d, k, s = shape
    rng = np.random.default_rng(0)
    scale = (d * s) ** -0.5
    e = torch.from_numpy((rng.normal(size=(b, d, s)) * scale
                          ).astype(np.float32)).to(cuda)
    c = torch.from_numpy((rng.normal(size=(d, k, s)) * scale
                          ).astype(np.float32)).to(cuda)
    klim = np.where(rng.random(b) < 0.1, k, k // 4).astype(np.int32)
    lim = torch.from_numpy(klim).to(cuda)
    got = dpq_assign(e, c, lim, block_b=block_b)
    want = dpq_assign_ref(e, c, lim)
    torch.cuda.synchronize()
    assert (got.cpu().numpy() < klim[:, None]).all()
    e64, c64 = e.double(), c.double()
    dist = (torch.sum(c64 * c64, -1)[None]
            - 2.0 * torch.einsum("bds,dks->bdk", e64, c64))
    gap = (dist.gather(-1, got.long()[..., None])
           - dist.gather(-1, want.long()[..., None])).abs()
    assert float(gap.max()) <= ASSIGN_TOL


@pytest.mark.gpu
def test_dpq_assign_kernel_ties_and_zero_budget(cuda):
    rng = np.random.default_rng(1)
    cent = rng.normal(size=(3, 8, 2)).astype(np.float32)
    cent[:, 5] = cent[:, 2]                       # exact tie: 2 == 5
    e = np.repeat(cent[None, :, 2, :], 4, axis=0)
    c, et = torch.from_numpy(cent).to(cuda), torch.from_numpy(e).to(cuda)
    assert (dpq_assign(et, c).cpu() == 2).all()
    zero = torch.zeros(4, dtype=torch.int32, device=cuda)
    assert (dpq_assign(et, c, zero).cpu() == 0).all()


@pytest.mark.gpu
def test_kernel_wrappers_refuse_what_they_do_not_take(cuda):
    c = torch.zeros((4, 5), dtype=torch.int64, device=cuda)
    t = torch.zeros((5, 8, 2), device=cuda)
    with pytest.raises(TypeError, match="uint8 or int32"):
        mgqe_decode(c, t)
    e = torch.zeros((4, 5, 2), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32 only"):
        dpq_assign(e, t.to(torch.bfloat16))
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
