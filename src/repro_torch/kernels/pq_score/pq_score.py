"""CUDA kernel wrappers: ADC scoring of a PQ-coded candidate corpus.

Replace the TPU kernels of ``src/repro/kernels/pq_score/pq_score.py``:

  ``pq_score``          ``pq_score`` (Pallas body ``_score_kernel``) —
                        here the batched kernel launched with B = 1
  ``pq_score_batched``  ``pq_score_batched`` (``_score_batched_kernel``)
  ``pq_topk``           ``pq_topk`` (``_topk_kernel``)

The kernels themselves, with their design notes, are in
``csrc/pq_score.cu``: LUTs staged in shared memory and gathered there
(the TPU's one-hot matmul was an MXU workaround), the scores summed in
the plain version's order so the two are bit-identical.  The scoring
kernels are bound by the bytes they move (codes in, scores out); the
top-k by its adds, as it writes only (B, k) pairs — it takes two
passes, a sorted top-k per (query, tile) and merges of those lists.

Each wrapper checks device, dtype, rank and contiguity, allocates its
outputs and scratch with ``torch.empty``, launches on the current
stream, raises if the launch fails and adds one to its own
``launches`` count.  The kernels' shape limits (queries per launch,
LUT bytes, tile and shared-memory sizes) live in ``csrc/pq_score.cu``
alone: its entry points refuse a shape past them, and the wrapper
raises with that error.  They take CUDA tensors only; the ops' CPU path is
the plain version in ``ref.py``, chosen by the dispatch layer, never by
a fallback here.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dispatch import Tunable

# candidates per block of the scoring kernel (256 threads stride them)
SCORE_BLOCK_N = Tunable(1024, (256, 512, 1024, 2048, 4096))
# candidates per tile of pq_topk's first pass: a power of two >= k; the
# tile is cut to the next power of two >= max(N, k) for small corpora
TOPK_BLOCK_N = Tunable(8192, (1024, 2048, 4096, 8192))

_CODE_BYTES = {torch.uint8: 1, torch.int32: 4}

_SCORE_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_SCRATCH_ARGTYPES = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                     ctypes.c_int, ctypes.c_int, ctypes.c_int,
                     ctypes.POINTER(ctypes.c_longlong)]
_TOPK_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                  ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _check(what: str, luts: torch.Tensor, codes: torch.Tensor) -> None:
    """luts (B, D, K) f32 and codes (N, D) uint8/int32, contiguous, on
    one CUDA device; raises on any other input."""
    if not (luts.is_cuda and codes.is_cuda):
        raise ValueError(
            f"{what}'s CUDA kernel takes CUDA tensors, got LUTs on "
            f"{luts.device} and codes on {codes.device}; the plain version "
            f"(backend 'torch') serves CPU tensors")
    if luts.device != codes.device:
        raise ValueError(f"LUTs on {luts.device}, codes on {codes.device}")
    if luts.dtype != torch.float32:
        raise TypeError(f"{what} takes float32 LUTs, got {luts.dtype}")
    if codes.dtype not in _CODE_BYTES:
        raise TypeError(f"codes must be uint8 or int32, got {codes.dtype}")
    if luts.dim() != 3 or codes.dim() != 2:
        raise ValueError(f"want LUTs (B, D, K) and codes (N, D), got "
                         f"{tuple(luts.shape)} and {tuple(codes.shape)}")
    if codes.shape[1] != luts.shape[1]:
        raise ValueError(f"codes have {codes.shape[1]} subspaces, LUTs "
                         f"{luts.shape[1]}")
    if not (luts.is_contiguous() and codes.is_contiguous()):
        raise ValueError(f"{what} takes contiguous LUTs and codes")


def _launch_scores(luts: torch.Tensor, codes: torch.Tensor,
                   block_n: Optional[int]) -> torch.Tensor:
    b, d, k = luts.shape
    n = codes.shape[0]
    block_n = SCORE_BLOCK_N.default if block_n is None else int(block_n)
    if block_n <= 0:
        raise ValueError(f"block_n must be positive, got {block_n}")
    out = torch.empty((b, n), dtype=torch.float32, device=luts.device)
    if n == 0:
        return out
    fn = build.function("pq_score", "pq_score_batched_launch",
                        _SCORE_ARGTYPES)
    stream = torch.cuda.current_stream(luts.device).cuda_stream
    err = fn(luts.data_ptr(), codes.data_ptr(), _CODE_BYTES[codes.dtype],
             out.data_ptr(), n, b, d, k, block_n, stream)
    build.check("pq_score", err, f"pq_score launch at B={b} N={n} D={d} "
                f"K={k} block_n={block_n} (limits: csrc/pq_score.cu)")
    return out


def pq_score(lut: torch.Tensor, codes: torch.Tensor,
             block_n: Optional[int] = None) -> torch.Tensor:
    """lut (D, K) f32; codes (N, D) uint8/int32 -> scores (N,) f32:
    the batched kernel at B = 1."""
    if lut.dim() != 2:
        raise ValueError(f"want lut (D, K), got {tuple(lut.shape)}")
    luts = lut[None]
    _check("pq_score", luts, codes)
    out = _launch_scores(luts, codes, block_n)[0]
    pq_score.launches += 1
    return out


def pq_score_batched(luts: torch.Tensor, codes: torch.Tensor,
                     block_n: Optional[int] = None) -> torch.Tensor:
    """luts (B, D, K) f32; codes (N, D) uint8/int32 -> scores (B, N)."""
    _check("pq_score_batched", luts, codes)
    out = _launch_scores(luts, codes, block_n)
    pq_score_batched.launches += 1
    return out


def topk_tile(n: int, k: int, block_n: Optional[int] = None) -> int:
    """The first pass's tile: ``block_n`` (a power of two >= k; the
    kernel's own limit on it is in ``csrc/pq_score.cu``) cut to the next
    power of two >= max(N, k)."""
    block_n = TOPK_BLOCK_N.default if block_n is None else int(block_n)
    if block_n <= 0 or block_n & (block_n - 1):
        raise ValueError(f"pq_topk's block_n must be a power of two, got "
                         f"{block_n}")
    if k > block_n:
        raise ValueError(f"pq_topk keeps k <= block_n; got k={k} > "
                         f"{block_n}")
    return min(block_n, 1 << (max(n, k, 1) - 1).bit_length())


def pq_topk(luts: torch.Tensor, codes: torch.Tensor, k: int,
            block_n: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """luts (B, D, K) f32; codes (N, D) uint8/int32 -> (scores (B, k)
    f32, ids (B, k) int32), ordered by (score desc, id asc), padded with
    ``(-inf, INVALID_ID)`` when k > N."""
    _check("pq_topk", luts, codes)
    k = int(k)
    if k <= 0:
        raise ValueError(f"k must be positive, got {k}")
    b, d, kk = luts.shape
    n = codes.shape[0]
    tile = topk_tile(n, k, block_n)
    what = (f"pq_topk at B={b} N={n} D={d} K={kk} k={k} tile={tile} "
            f"(limits: csrc/pq_score.cu)")
    rows = (ctypes.c_longlong * 2)()
    err = build.function("pq_score", "pq_topk_scratch", _SCRATCH_ARGTYPES)(
        n, b, d, kk, k, tile, rows)
    build.check("pq_score", err, what)
    rows0, rows1 = rows
    dev = luts.device
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    s0 = torch.empty((rows0,), dtype=torch.float32, device=dev)
    i0 = torch.empty((rows0,), dtype=torch.int32, device=dev)
    s1 = torch.empty((rows1,), dtype=torch.float32, device=dev)
    i1 = torch.empty((rows1,), dtype=torch.int32, device=dev)
    fn = build.function("pq_score", "pq_topk_launch", _TOPK_ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(luts.data_ptr(), codes.data_ptr(), _CODE_BYTES[codes.dtype],
             out_s.data_ptr(), out_i.data_ptr(), s0.data_ptr(),
             i0.data_ptr(), s1.data_ptr(), i1.data_ptr(), n, b, d, kk, k,
             tile, stream)
    build.check("pq_score", err, what)
    pq_topk.launches += 1
    return out_s, out_i


# launches of each kernel in this process (chip_smoke.py resets and
# reads them around the main path)
pq_score.launches = 0
pq_score_batched.launches = 0
pq_topk.launches = 0
