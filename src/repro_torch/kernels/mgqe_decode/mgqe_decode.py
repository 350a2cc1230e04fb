"""CUDA kernel wrappers: the MGQE/DPQ and RQ serving decodes.

Replace the TPU kernels of ``src/repro/kernels/mgqe_decode/
mgqe_decode.py``:

  ``mgqe_decode``       ``mgqe_decode`` (Pallas body ``_decode_kernel``)
                        -> ``csrc/mgqe_decode.cu``: a real gather, from
                        a centroid table staged in shared memory (small
                        tables and slots) or through L2 (the LM's),
                        routed by ``decode_plan``
  ``rq_decode_stages``  ``rq_decode_stages`` (``_staged_kernel``) ->
                        ``csrc/rq_decode_stages.cu``: each output
                        vector's M codebook entries gathered and summed
                        in registers, in the plain version's order, from
                        codebooks staged in shared memory (up to 96 KB:
                        deepfm's) or read through L2, routed by
                        ``rq_plan``

Both are bound by the bytes they move, and their shared-memory routes
are the per-warp row chunks of ``csrc/decode_chunks.cuh``
(``kernels/decode_chunks.py`` sizes them).  Each wrapper checks device,
dtype, shape and contiguity, allocates the output with ``torch.empty``,
launches on the current stream, raises if the launch fails and adds one
to its own ``launches`` count.  It takes CUDA tensors only; the ops'
CPU path is the plain version in ``ref.py``, chosen by the dispatch
layer, never by a fallback here.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_chunks import (MAX_THREADS, ROUTES,
                                               SMEM_MAX, SMEM_SLOT_MAX,
                                               SMEM_TABLE_MAX, DecodePlan,
                                               align16, cdiv, l2_gather_plan,
                                               walk, warp_bytes, whole_warps)
from repro_torch.kernels.dispatch import Tunable

# threads a block (None: the planner's choice).  mgqe_decode takes any
# count in [1, 1024], rounded up to whole warps; rq_decode_stages takes
# any count in [1, 1024], and
# one that is not a whole number of warps takes its l2 route.  The
# schemes pass their config's decode_block_b (the engine's pad
# multiple, 256 by default)
BLOCK_B = Tunable(None, (None, 128, 256, 512, 1024))
RQ_BLOCK_B = Tunable(None, (None, 64, 128, 256, 512, 1024))

_CODE_BYTES = {torch.uint8: 1, torch.int32: 4}
_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]

# rq_decode_stages' planner: the smem route from this many rows (below
# it staging the codebooks costs more than it saves: at deepfm's shape
# the l2 route is the faster at 32,768 rows and the slower at 65,536),
# and its l2 route's threads a block and largest grid
RQ_SMEM_MIN_ROWS = 65536
RQ_L2_THREADS = 256
RQ_L2_MAX_GRID = 1 << 20


def decode_smem(d: int, k: int, slot: int, code_bytes: int,
                warps: int) -> int:
    """A smem-route block's shared memory: the table and, per warp, two
    chunks of codes and one of output rows."""
    return align16(d * k * slot) + warps * warp_bytes(d * code_bytes,
                                                      d * slot)


def decode_plan(b: int, d: int, k: int, s: int, code_bytes: int,
                elem_bytes: int, sms: int,
                block_b: Optional[int] = None) -> DecodePlan:
    """Plan ``mgqe_decode`` of B = ``b`` rows of (D, K, S) = (``d``,
    ``k``, ``s``) centroids on a card of ``sms`` SMs.  ``block_b``:
    threads a block, any count in [1, 1024], rounded up to whole warps.

    The rule: a table of at most SMEM_TABLE_MAX bytes whose slots (S
    elements) are at most SMEM_SLOT_MAX bytes takes the smem route where
    one warp's chunks fit SMEM_MAX beside it (``decode_chunks.walk``:
    blocks of WALK_THREADS or ``block_b``).  Anything else (the LM token
    tables) takes the l2 route (``decode_chunks.l2_gather_plan``: blocks
    of L2_THREADS or ``block_b``, a group of lanes a slot, the next
    power of two >= the slot's 16-byte vectors, at most 32; as many
    blocks as fill the card's threads once)."""
    block_b = whole_warps(block_b)
    slot = s * elem_bytes
    if slot <= SMEM_SLOT_MAX:
        w = walk(b, align16(d * k * slot),
                 warp_bytes(d * code_bytes, d * slot), sms, block_b)
        if w is not None:
            return DecodePlan("smem", w.threads, 0, w.grid, w.smem)
    return l2_gather_plan(b, d, slot, sms, block_b)


class RqPlan(NamedTuple):
    """One ``rq_decode_stages`` launch: ``route`` ("smem" or "l2"),
    ``threads`` a block, ``vec`` elements a vector, ``grid`` blocks,
    ``smem`` bytes of dynamic shared memory a block."""
    route: str
    threads: int
    vec: int
    grid: int
    smem: int


def rq_smem(m: int, k: int, d: int, code_bytes: int, elem_bytes: int,
            warps: int) -> int:
    """A smem-route block's shared memory: the codebooks and, per warp,
    two chunks of codes and one of output rows."""
    return align16(m * k * d * elem_bytes) + warps * warp_bytes(
        m * code_bytes, d * elem_bytes)


def rq_plan(b: int, m: int, k: int, d: int, code_bytes: int,
            elem_bytes: int, sms: int, block_b: Optional[int] = None,
            cbs_align: int = 16) -> RqPlan:
    """Plan ``rq_decode_stages`` of B = ``b`` rows of (M, K, d) =
    (``m``, ``k``, ``d``) codebooks, their base address a multiple of
    ``cbs_align`` bytes, on a card of ``sms`` SMs.

    The rule: from RQ_SMEM_MIN_ROWS rows, codebooks of at most
    SMEM_TABLE_MAX bytes take the smem route where one warp's share
    fits beside them and ``block_b`` is None or a whole number of warps
    (``decode_chunks.walk``: blocks of WALK_THREADS or ``block_b``);
    vectors of the widest 8, 4, 2 or 1 elements of at most 16 bytes
    that divide d, a lane a row.  Anything else takes the
    l2 route: blocks of RQ_L2_THREADS (or ``block_b``, any count in [1,
    1024]), a thread a vector of 4, 2 or 1 elements that divides d and
    the codebooks' alignment, blocks enough for every vector, at most
    RQ_L2_MAX_GRID."""
    if block_b is not None and not 0 < int(block_b) <= MAX_THREADS:
        raise ValueError(f"block_b (threads per block) must lie in "
                         f"[1, {MAX_THREADS}], got {block_b}")
    if b >= RQ_SMEM_MIN_ROWS and (block_b is None or int(block_b) % 32 == 0):
        w = walk(b, align16(m * k * d * elem_bytes),
                 warp_bytes(m * code_bytes, d * elem_bytes), sms, block_b)
        if w is not None:
            vec = next(v for v in (8, 4, 2, 1)
                       if d % v == 0 and v * elem_bytes <= 16)
            return RqPlan("smem", w.threads, vec, w.grid, w.smem)
    threads = RQ_L2_THREADS if block_b is None else int(block_b)
    vec = next(v for v in (4, 2, 1)
               if d % v == 0 and cbs_align % (v * elem_bytes) == 0)
    grid = max(1, min(cdiv(b * (d // vec), threads), RQ_L2_MAX_GRID))
    return RqPlan("l2", threads, vec, grid, 0)


_RQ_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_longlong, ctypes.c_void_p]


def mgqe_decode(codes: torch.Tensor, centroids: torch.Tensor,
                block_b: Optional[int] = None, *,
                plan: Optional[DecodePlan] = None) -> torch.Tensor:
    """codes (B, D) uint8/int32; centroids (D, K, S) float32/bfloat16,
    both contiguous on one CUDA device -> (B, D*S) in the centroid
    dtype.  Codes >= K are clamped to K-1.  ``block_b``: threads a
    block, in [1, 1024], rounded up to whole warps.  ``plan``: a launch
    plan to run instead of ``decode_plan``'s (to time or test a route);
    the kernel refuses one it cannot run."""
    if not (codes.is_cuda and centroids.is_cuda):
        raise ValueError(
            f"mgqe_decode's CUDA kernel takes CUDA tensors, got codes on "
            f"{codes.device} and centroids on {centroids.device}; the "
            f"plain version (backend 'torch') serves CPU tensors")
    if codes.device != centroids.device:
        raise ValueError(f"codes on {codes.device}, centroids on "
                         f"{centroids.device}")
    if codes.dtype not in _CODE_BYTES:
        raise TypeError(f"codes must be uint8 or int32, got {codes.dtype}")
    if centroids.dtype not in _ELEM_BYTES:
        raise TypeError(f"centroids must be float32 or bfloat16, got "
                        f"{centroids.dtype}")
    if codes.dim() != 2 or centroids.dim() != 3:
        raise ValueError(f"want codes (B, D) and centroids (D, K, S), got "
                         f"{tuple(codes.shape)} and "
                         f"{tuple(centroids.shape)}")
    b, d = codes.shape
    n_sub, k, s = centroids.shape
    if d != n_sub:
        raise ValueError(f"codes have {d} subspaces, centroids {n_sub}")
    if not (codes.is_contiguous() and centroids.is_contiguous()):
        raise ValueError("mgqe_decode takes contiguous codes and centroids")
    out = torch.empty((b, d * s), dtype=centroids.dtype,
                      device=centroids.device)
    if b == 0:
        return out
    cb, eb = _CODE_BYTES[codes.dtype], _ELEM_BYTES[centroids.dtype]
    if plan is None:
        plan = decode_plan(b, d, k, s, cb, eb, build.sm_count(codes.device),
                           BLOCK_B.default if block_b is None else block_b)
    fn = build.function("mgqe_decode", "mgqe_decode_launch", _ARGTYPES)
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    err = fn(codes.data_ptr(), cb, centroids.data_ptr(), eb, out.data_ptr(),
             b, d, k, s, ROUTES[plan.route], plan.group, plan.grid,
             plan.threads, plan.smem, stream)
    build.check("mgqe_decode", err, f"mgqe_decode launch at B={b} D={d} "
                f"K={k} S={s} {plan} (limits: csrc/mgqe_decode.cu)")
    build.count_launch(mgqe_decode)
    return out


# launches of the kernel in this process (chip_smoke.py resets and
# reads it around the main path)
mgqe_decode.launches = 0


def _alignment(t: torch.Tensor) -> int:
    """The largest power of two (at most 16) that divides ``t``'s data
    address, in bytes."""
    ptr = t.data_ptr()
    return min(16, ptr & -ptr) if ptr else 16


def rq_decode_stages(codes: torch.Tensor, codebooks: torch.Tensor,
                     block_b: Optional[int] = None, *,
                     plan: Optional[RqPlan] = None) -> torch.Tensor:
    """codes (B, M) uint8/int32; stacked codebooks (M, K, d)
    float32/bfloat16, both contiguous on one CUDA device -> (B, d) in
    the codebook dtype, ``sum_m codebooks[m, codes[:, m]]``.  Codes >= K
    are clamped to K-1.  ``block_b``: threads per block, in [1, 1024].
    ``plan``: a launch plan to run instead of ``rq_plan``'s (to time or
    test a route); the kernel refuses one it cannot run."""
    if not (codes.is_cuda and codebooks.is_cuda):
        raise ValueError(
            f"rq_decode_stages' CUDA kernel takes CUDA tensors, got codes "
            f"on {codes.device} and codebooks on {codebooks.device}; the "
            f"plain version (backend 'torch') serves CPU tensors")
    if codes.device != codebooks.device:
        raise ValueError(f"codes on {codes.device}, codebooks on "
                         f"{codebooks.device}")
    if codes.dtype not in _CODE_BYTES:
        raise TypeError(f"codes must be uint8 or int32, got {codes.dtype}")
    if codebooks.dtype not in _ELEM_BYTES:
        raise TypeError(f"codebooks must be float32 or bfloat16, got "
                        f"{codebooks.dtype}")
    if codes.dim() != 2 or codebooks.dim() != 3:
        raise ValueError(f"want codes (B, M) and codebooks (M, K, d), got "
                         f"{tuple(codes.shape)} and "
                         f"{tuple(codebooks.shape)}")
    b, m = codes.shape
    m2, k, d = codebooks.shape
    if m != m2:
        raise ValueError(f"codes have {m} stages, codebooks {m2}")
    if not (codes.is_contiguous() and codebooks.is_contiguous()):
        raise ValueError("rq_decode_stages takes contiguous codes and "
                         "codebooks")
    cb, eb = _CODE_BYTES[codes.dtype], _ELEM_BYTES[codebooks.dtype]
    if plan is None:
        plan = rq_plan(b, m, k, d, cb, eb, build.sm_count(codes.device),
                       RQ_BLOCK_B.default if block_b is None else block_b,
                       cbs_align=_alignment(codebooks))
    out = torch.empty((b, d), dtype=codebooks.dtype, device=codebooks.device)
    if b == 0:
        return out
    fn = build.function("rq_decode_stages", "rq_decode_stages_launch",
                        _RQ_ARGTYPES)
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    err = fn(codes.data_ptr(), cb, codebooks.data_ptr(), eb, out.data_ptr(),
             b, m, k, d, ROUTES[plan.route], plan.vec, plan.grid,
             plan.threads, plan.smem, stream)
    build.check("rq_decode_stages", err, f"rq_decode_stages launch at B={b} "
                f"M={m} K={k} d={d} {plan} (limits: "
                f"csrc/rq_decode_stages.cu)")
    build.count_launch(rq_decode_stages)
    return out


# launches of the kernel in this process (chip_smoke.py resets and
# reads it around the main path)
rq_decode_stages.launches = 0


__all__ = ["BLOCK_B", "DecodePlan", "RQ_BLOCK_B", "RQ_L2_MAX_GRID",
           "RQ_L2_THREADS", "RQ_SMEM_MIN_ROWS", "RqPlan", "SMEM_MAX",
           "SMEM_SLOT_MAX", "SMEM_TABLE_MAX", "decode_plan", "decode_smem",
           "mgqe_decode", "rq_decode_stages", "rq_plan", "rq_smem"]
