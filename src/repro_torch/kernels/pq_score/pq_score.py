"""CUDA kernel wrappers: ADC scoring of a PQ-coded candidate corpus.

Replace the TPU kernels of ``src/repro/kernels/pq_score/pq_score.py``:

  ``pq_score``          ``pq_score`` (Pallas body ``_score_kernel``) —
                        here the scoring kernels at B = 1
  ``pq_score_batched``  ``pq_score_batched`` (``_score_batched_kernel``)
  ``pq_topk``           ``pq_topk`` (``_topk_kernel``)

The kernels themselves, with their design notes, are in
``csrc/pq_score.cu``: LUTs staged in shared memory and gathered there
(the TPU's one-hot matmul was an MXU workaround), the scores summed in
the plain version's order so the two are bit-identical.  The scoring
kernels are bound by the bytes they move (codes in, scores out) and, in
practice, by the shared-memory reads of the LUTs: from 9 queries a
warp scores 32 candidates for 32 queries at once, four queries a lane,
so a quarter warp's LUT reads are one 128-byte row (the "lanes"
route); smaller batches keep one thread a candidate (the "rows"
route).
``score_plan`` chooses the routes and the grid in pure Python.  The
top-k is bound by its adds, as it writes only (B, k) pairs — it takes
two passes: a selection per (query, chunk of candidates) that keeps a
running threshold, and merges of the partial lists.

Each wrapper checks device, dtype, rank and contiguity, allocates its
outputs and scratch with ``torch.empty``, launches on the current
stream, raises if the launch fails and adds one to its own
``launches`` count.  The kernels' shape limits (queries per launch,
LUT bytes, k, buffer and shared-memory sizes) are checked by
``csrc/pq_score.cu``'s entry points, which refuse a shape past them;
the wrapper raises with that error.  ``score_plan`` and ``topk_plan``
size the launches from the same constants, and the entry points
re-check the plans.  They take CUDA tensors only; the ops' CPU path is
the plain version in ``ref.py``, chosen by the dispatch layer, never by
a fallback here.
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dispatch import Tunable

# candidates a scoring block walks (None: as many blocks as fill the
# card once, see score_plan)
SCORE_BLOCK_N = Tunable(None, (None, 16384, 65536, 262144))
# candidates per block of pq_topk's selection pass (None: as many
# blocks as fill the card once, see topk_plan)
TOPK_BLOCK_N = Tunable(None, (None, 4096, 16384, 65536, 262144))

# pq_topk's constants, as csrc/pq_score.cu defines them (its entry point
# refuses a plan past them): candidates a selection round scores (one a
# thread), the selection blocks an SM its launch bounds allow, queries a
# block, the largest k, pairs a merge block sorts, and the shared memory
# of one SM (of which the runtime keeps 1 KB a block, and the selection
# kernel's static state takes under 1 KB)
TOPK_THREADS = 256
TOPK_BLOCKS_PER_SM = 3
TOPK_MAX_Q = 16
TOPK_MAX_K = 8192
TOPK_MAX_MERGE = 16384
SMEM_PER_SM = 228 * 1024

_CODE_BYTES = {torch.uint8: 1, torch.int32: 4}

# the scoring kernels' constants, as csrc/pq_score.cu defines them (its
# entry point refuses a plan past them): queries a lanes group,
# candidates a warp's tile, the lanes route's largest LUTs (32 queries),
# threads a block and blocks an SM (its launch bounds: 128 registers a
# thread); the rows route's threads a block, candidates a thread scores
# at once, most queries below the lanes route, widest group and LUT
# budget; a block's largest dynamic shared memory
LANE_Q = 32
LANE_TILE = 32
LANES_LUT_MAX = 128 * 1024
LANES_THREADS = 256
LANES_BLOCKS_PER_SM = 2
ROWS_THREADS = 256
ROWS_UNROLL = 2
ROWS_MAX_Q = 8
ROWS_MAX_WIDTH = 16
LUT_BUDGET = 96 * 1024
SMEM_MAX = 227 * 1024
# the routes' numbers in the entry point
ROUTES = {"lanes": 0, "rows": 1}

_SCORE_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_void_p]
_TOPK_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                  ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                  ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                  ctypes.c_void_p]


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


class ScoreLaunch(NamedTuple):
    """One launch of the scoring kernels: ``route`` ("lanes" or
    "rows"), queries [``q0``, ``q0 + nq``) in groups of ``width``
    (``groups`` of them, the last possibly short), ``splits`` blocks a
    group of ``span`` candidates each, ``threads`` a block and ``smem``
    bytes of dynamic shared memory a block."""
    route: str
    q0: int
    nq: int
    width: int
    groups: int
    splits: int
    span: int
    threads: int
    smem: int


def lanes_smem(d: int, kk: int, code_bytes: int, warps: int) -> int:
    """A lanes-route block's shared memory: 32 queries' LUTs and, per
    warp, a double buffer of a tile's codes."""
    buf = _cdiv(LANE_TILE * d * code_bytes, 16) * 16
    return d * kk * LANE_Q * 4 + warps * 2 * buf


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _splits(n: int, groups: int, blocks: int, unit: int,
            block_n: Optional[int]) -> Tuple[int, int]:
    """(splits, span): each group's candidates cut into spans of a
    multiple of ``unit``, as many as make ``blocks`` blocks in all (or
    ``block_n`` candidates a span)."""
    if block_n is None:
        splits = max(1, min(_cdiv(n, unit), blocks // groups))
        span = _cdiv(_cdiv(n, splits), unit) * unit
    else:
        if int(block_n) <= 0:
            raise ValueError(f"block_n must be positive, got {block_n}")
        span = _cdiv(int(block_n), unit) * unit
    return _cdiv(n, span), span


def score_plan(n: int, b: int, d: int, kk: int, code_bytes: int, sms: int,
               block_n: Optional[int] = None) -> List[ScoreLaunch]:
    """Plan ``pq_score_batched`` over N = ``n`` candidates for B = ``b``
    queries of (D, K) = (``d``, ``kk``) LUTs, codes of ``code_bytes``
    bytes, on a card of ``sms`` SMs: one or two launches.

    The rule.  Where 32 queries' LUTs fit LANES_LUT_MAX: B <= ROWS_MAX_Q
    (8) takes the rows route (one group, width the next power of two
    >= B); a larger B takes the lanes route in groups of 32, and a
    remainder r = B mod 32 goes to the rows route when r <= ROWS_MAX_Q
    (width the next power of two >= r), else to a last, masked lanes
    group.  (On an H100 a lanes group costs about the same at any of
    its 32 queries, and the rows route's time grows with its queries:
    they cross between 8 and 12.)  Where 32 queries' LUTs do not fit,
    every query takes the rows route, in groups of the largest power of
    two <= ROWS_MAX_WIDTH (16) whose LUTs fit LUT_BUDGET (fewer when B
    is smaller).  Each launch has about one wave of blocks: (splits x
    groups) blocks, as many as the card holds at its shared memory,
    each walking ``span`` candidates (``block_n``, rounded up to the
    route's unit, where given)."""
    lut = d * kk * 4
    out: List[ScoreLaunch] = []

    def lanes(q0: int, nq: int) -> None:
        warps = LANES_THREADS // 32
        smem = lanes_smem(d, kk, code_bytes, warps)
        groups = _cdiv(nq, LANE_Q)
        per_sm = max(1, min(LANES_BLOCKS_PER_SM,
                            SMEM_PER_SM // (smem + 1024)))
        splits, span = _splits(n, groups, per_sm * sms, LANE_TILE * warps,
                               block_n)
        out.append(ScoreLaunch("lanes", q0, nq, LANE_Q, groups, splits, span,
                               LANES_THREADS, smem))

    def rows(q0: int, nq: int, width: int) -> None:
        smem = width * lut
        groups = _cdiv(nq, width)
        per_sm = max(1, min(2048 // ROWS_THREADS,
                            SMEM_PER_SM // (smem + 1024)))
        splits, span = _splits(n, groups, per_sm * sms,
                               ROWS_THREADS * ROWS_UNROLL, block_n)
        out.append(ScoreLaunch("rows", q0, nq, width, groups, splits, span,
                               ROWS_THREADS, smem))

    if LANE_Q * lut <= LANES_LUT_MAX:
        if b <= ROWS_MAX_Q:
            rows(0, b, _pow2_at_least(b))
        else:
            full, r = divmod(b, LANE_Q)
            if r > ROWS_MAX_Q:
                lanes(0, b)
            else:
                lanes(0, full * LANE_Q)
                if r:
                    rows(full * LANE_Q, r, _pow2_at_least(r))
    else:
        width = ROWS_MAX_WIDTH
        while width > 1 and width * lut > LUT_BUDGET:
            width //= 2
        rows(0, b, min(width, _pow2_at_least(b)))
    return out


def _launch_scores(luts: torch.Tensor, codes: torch.Tensor,
                   block_n: Optional[int]) -> torch.Tensor:
    b, d, k = luts.shape
    n = codes.shape[0]
    out = torch.empty((b, n), dtype=torch.float32, device=luts.device)
    if n == 0:
        return out
    cb = _CODE_BYTES[codes.dtype]
    plan = score_plan(n, b, d, k, cb, build.sm_count(luts.device), block_n)
    fn = build.function("pq_score", "pq_score_batched_launch",
                        _SCORE_ARGTYPES)
    stream = torch.cuda.current_stream(luts.device).cuda_stream
    for p in plan:
        err = fn(luts.data_ptr(), codes.data_ptr(), cb, out.data_ptr(), n, b,
                 d, k, ROUTES[p.route], p.q0, p.nq, p.width, p.splits,
                 p.span, p.threads, p.smem, stream)
        build.check("pq_score", err, f"pq_score launch at B={b} N={n} D={d} "
                    f"K={k} {p} (limits: csrc/pq_score.cu)")
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
    build.count_launch(pq_score)
    return out


def pq_score_batched(luts: torch.Tensor, codes: torch.Tensor,
                     block_n: Optional[int] = None) -> torch.Tensor:
    """luts (B, D, K) f32; codes (N, D) uint8/int32 -> scores (B, N)."""
    _check("pq_score_batched", luts, codes)
    out = _launch_scores(luts, codes, block_n)
    build.count_launch(pq_score_batched)
    return out


class TopkPlan(NamedTuple):
    """One ``pq_topk`` launch: ``queries`` a selection block, ``cap``
    buffer slots a query, ``chunk`` candidates a block, ``chunks``
    blocks a query group (partial lists a query), and the scratch pairs
    of the partial lists (``rows0``) and of the first merge round
    (``rows1``); ``smem`` bytes of dynamic shared memory a block."""
    queries: int
    cap: int
    chunk: int
    chunks: int
    rows0: int
    rows1: int
    smem: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def topk_plan(n: int, b: int, d: int, kk: int, k: int, sms: int,
              block_n: Optional[int] = None) -> TopkPlan:
    """Plan ``pq_topk`` over N = ``n`` candidates for B = ``b`` queries
    of (D, K) = (``d``, ``kk``) LUTs on a card of ``sms`` SMs.

    A block takes up to TOPK_MAX_Q queries, as many as keep it within
    its share of an SM's shared memory (TOPK_BLOCKS_PER_SM blocks an
    SM), else one; each query's buffer holds the next power of two
    >= 2 k pairs, at least TOPK_THREADS, so that an overflow (a sort)
    frees k slots or more.  ``block_n`` (candidates a block) left as
    None cuts N into as many chunks as make one wave of blocks on the
    card, each a multiple of TOPK_THREADS, but no more than one merge
    block takes (TOPK_MAX_MERGE // k lists), so one merge round is
    left."""
    if not 0 < k <= TOPK_MAX_K:
        raise ValueError(f"pq_topk takes 0 < k <= {TOPK_MAX_K}; got k={k}")
    cap = max(TOPK_THREADS, 1 << (2 * k - 1).bit_length())
    per_query = d * kk * 4 + cap * 8
    queries = max(1, min(TOPK_MAX_Q, b,
                         (SMEM_PER_SM // TOPK_BLOCKS_PER_SM - 2048)
                         // per_query))
    # the LUT rows hold the queries innermost, padded to 4, 8 or 16 from
    # 4 queries up (read four at a time)
    width = queries if queries < 4 else 1 << (queries - 1).bit_length()
    smem = width * d * kk * 4 + queries * cap * 8
    groups = _cdiv(b, queries)
    gmax = TOPK_MAX_MERGE // k
    if block_n is None:
        per_sm = max(1, min(TOPK_BLOCKS_PER_SM,
                            SMEM_PER_SM // (smem + 2048)))
        chunks = max(1, min(sms * per_sm // groups, gmax,
                            _cdiv(n, TOPK_THREADS)))
        chunk = _cdiv(_cdiv(max(n, 1), chunks), TOPK_THREADS) * TOPK_THREADS
    else:
        chunk = int(block_n)
        if chunk <= 0:
            raise ValueError(f"pq_topk's block_n must be positive, got "
                             f"{chunk}")
    chunks = _cdiv(n, chunk) if n > 0 else 1
    first_round = _cdiv(chunks, gmax)
    return TopkPlan(queries, cap, chunk, chunks,
                    b * chunks * k if chunks > 1 else 0,
                    b * first_round * k if first_round > 1 else 0, smem)


def pq_topk(luts: torch.Tensor, codes: torch.Tensor, k: int,
            block_n: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """luts (B, D, K) f32; codes (N, D) uint8/int32 -> (scores (B, k)
    f32, ids (B, k) int32), ordered by (score desc, id asc), padded with
    ``(-inf, INVALID_ID)`` when k > N."""
    _check("pq_topk", luts, codes)
    k = int(k)
    b, d, kk = luts.shape
    n = codes.shape[0]
    dev = luts.device
    plan = topk_plan(n, b, d, kk, k, build.sm_count(dev), block_n)
    what = (f"pq_topk at B={b} N={n} D={d} K={kk} k={k} {plan} "
            f"(limits: csrc/pq_score.cu)")
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    s0 = torch.empty((plan.rows0,), dtype=torch.float32, device=dev)
    i0 = torch.empty((plan.rows0,), dtype=torch.int32, device=dev)
    s1 = torch.empty((plan.rows1,), dtype=torch.float32, device=dev)
    i1 = torch.empty((plan.rows1,), dtype=torch.int32, device=dev)
    fn = build.function("pq_score", "pq_topk_launch", _TOPK_ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(luts.data_ptr(), codes.data_ptr(), _CODE_BYTES[codes.dtype],
             out_s.data_ptr(), out_i.data_ptr(), s0.data_ptr(),
             i0.data_ptr(), s1.data_ptr(), i1.data_ptr(), n, b, d, kk, k,
             plan.queries, plan.cap, plan.chunk, plan.rows0, plan.rows1,
             stream)
    build.check("pq_score", err, what)
    build.count_launch(pq_topk)
    return out_s, out_i


# launches of each kernel in this process (chip_smoke.py resets and
# reads them around the main path)
pq_score.launches = 0
pq_score_batched.launches = 0
pq_topk.launches = 0
