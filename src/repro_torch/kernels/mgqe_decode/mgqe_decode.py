"""CUDA kernel wrappers: the MGQE/DPQ and RQ serving decodes.

Replace the TPU kernels of ``src/repro/kernels/mgqe_decode/
mgqe_decode.py``:

  ``mgqe_decode``       ``mgqe_decode`` (Pallas body ``_decode_kernel``)
                        -> ``csrc/mgqe_decode.cu``: a real gather, from
                        a centroid table staged in shared memory (small
                        tables and slots) or through L2 (the LM's),
                        routed by ``decode_plan``
  ``rq_decode_stages``  ``rq_decode_stages`` (``_staged_kernel``) ->
                        ``csrc/rq_decode_stages.cu``: one thread per
                        output element gathers its M codebook entries
                        through the read-only cache and sums them in a
                        register, in the plain version's order

Both are bound by the bytes they move.  Each wrapper checks device,
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
from repro_torch.kernels.dispatch import Tunable

# mgqe_decode: threads a block (a multiple of 32; None: decode_plan's
# choice), as rq_decode_stages takes it; on the smem route also the rows
# a block gathers at once (one a thread).  The schemes pass their
# config's decode_block_b (the engine's pad multiple, 256 by default)
BLOCK_B = Tunable(None, (None, 128, 256, 512, 1024))
# rq_decode_stages: threads per block, one output element each
RQ_BLOCK_B = Tunable(256, (64, 128, 256, 512, 1024))

_CODE_BYTES = {torch.uint8: 1, torch.int32: 4}
_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]

# mgqe_decode's constants, as csrc/mgqe_decode.cu defines them (its
# entry point refuses a plan past them): rows a warp gathers at a time,
# the smem route's largest table and slot, a block's largest dynamic
# shared memory and threads; and the planner's own: each route's
# threads a block by default, the smem route's blocks an SM at most (a
# block stages the table, so fewer and larger blocks stage it less
# often: at serve_bulk 16 warps a block, each walking two chunks), an
# SM's shared memory and threads
CHUNK = 32
SMEM_TABLE_MAX = 96 * 1024
SMEM_SLOT_MAX = 64
SMEM_MAX = 227 * 1024
MAX_THREADS = 1024
SMEM_THREADS = 512
L2_THREADS = 1024
BLOCKS_PER_SM = 2
SMEM_PER_SM = 228 * 1024
THREADS_PER_SM = 2048
DECODE_ROUTES = {"smem": 0, "l2": 1}


class DecodePlan(NamedTuple):
    """One ``mgqe_decode`` launch: ``route`` ("smem" or "l2"),
    ``threads`` a block, ``group`` lanes a slot (l2 route), ``grid``
    blocks, ``smem`` bytes of dynamic shared memory a block."""
    route: str
    threads: int
    group: int
    grid: int
    smem: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _align16(x: int) -> int:
    return _cdiv(x, 16) * 16


def decode_smem(d: int, k: int, slot: int, code_bytes: int,
                warps: int) -> int:
    """A smem-route block's shared memory: the table and, per warp, two
    chunks of codes and one of output rows."""
    return _align16(d * k * slot) + warps * (
        2 * _align16(CHUNK * d * code_bytes) + CHUNK * d * slot)


def decode_plan(b: int, d: int, k: int, s: int, code_bytes: int,
                elem_bytes: int, sms: int,
                block_b: Optional[int] = None) -> DecodePlan:
    """Plan ``mgqe_decode`` of B = ``b`` rows of (D, K, S) = (``d``,
    ``k``, ``s``) centroids on a card of ``sms`` SMs.

    The rule: a table of at most SMEM_TABLE_MAX bytes whose slots (S
    elements) are at most SMEM_SLOT_MAX bytes takes the smem route where
    one warp's chunks fit SMEM_MAX beside it: blocks of SMEM_THREADS
    (or ``block_b``; fewer warps where their chunks would not fit), up
    to BLOCKS_PER_SM an SM, no more than the chunks of CHUNK rows need.
    Anything else (the LM token tables) takes the l2 route: blocks of
    L2_THREADS (or ``block_b``), a group of lanes a slot, the next power
    of two >= the slot's 16-byte vectors, at most 32; as many blocks as
    fill the card's threads once."""
    if block_b is not None and not (0 < int(block_b) <= MAX_THREADS
                                    and int(block_b) % 32 == 0):
        raise ValueError(f"block_b (threads a block) must be a multiple of "
                         f"32 in [32, {MAX_THREADS}], got {block_b}")
    slot = s * elem_bytes
    if (d * k * slot <= SMEM_TABLE_MAX and slot <= SMEM_SLOT_MAX
            and decode_smem(d, k, slot, code_bytes, 1) <= SMEM_MAX):
        warps = (SMEM_THREADS if block_b is None else int(block_b)) // 32
        while decode_smem(d, k, slot, code_bytes, warps) > SMEM_MAX:
            warps -= 1
        smem = decode_smem(d, k, slot, code_bytes, warps)
        per_sm = max(1, min(BLOCKS_PER_SM, THREADS_PER_SM // (32 * warps),
                            SMEM_PER_SM // (smem + 1024)))
        grid = max(1, min(_cdiv(_cdiv(b, CHUNK), warps), per_sm * sms))
        return DecodePlan("smem", 32 * warps, 0, grid, smem)
    threads = L2_THREADS if block_b is None else int(block_b)
    vec = next(v for v in (16, 8, 4, 2) if slot % v == 0)
    group = min(32, 1 << max(0, (_cdiv(slot, vec) - 1).bit_length()))
    grid = max(1, min(_cdiv(b * d * group, threads),
                      THREADS_PER_SM // threads * sms))
    return DecodePlan("l2", threads, group, grid, 0)


_RQ_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]


def mgqe_decode(codes: torch.Tensor, centroids: torch.Tensor,
                block_b: Optional[int] = None) -> torch.Tensor:
    """codes (B, D) uint8/int32; centroids (D, K, S) float32/bfloat16,
    both contiguous on one CUDA device -> (B, D*S) in the centroid
    dtype.  Codes >= K are clamped to K-1."""
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
    plan = decode_plan(b, d, k, s, cb, eb, build.sm_count(codes.device),
                       BLOCK_B.default if block_b is None else block_b)
    fn = build.function("mgqe_decode", "mgqe_decode_launch", _ARGTYPES)
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    err = fn(codes.data_ptr(), cb, centroids.data_ptr(), eb, out.data_ptr(),
             b, d, k, s, DECODE_ROUTES[plan.route], plan.group, plan.grid,
             plan.threads, plan.smem, stream)
    build.check("mgqe_decode", err, f"mgqe_decode launch at B={b} D={d} "
                f"K={k} S={s} {plan} (limits: csrc/mgqe_decode.cu)")
    mgqe_decode.launches += 1
    return out


# launches of the kernel in this process (chip_smoke.py resets and
# reads it around the main path)
mgqe_decode.launches = 0


def rq_decode_stages(codes: torch.Tensor, codebooks: torch.Tensor,
                     block_b: Optional[int] = None) -> torch.Tensor:
    """codes (B, M) uint8/int32; stacked codebooks (M, K, d)
    float32/bfloat16, both contiguous on one CUDA device -> (B, d) in
    the codebook dtype, ``sum_m codebooks[m, codes[:, m]]``.  Codes >= K
    are clamped to K-1.  ``block_b``: threads per block, in [1, 1024]."""
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
    block_b = RQ_BLOCK_B.default if block_b is None else int(block_b)
    if not 0 < block_b <= 1024:
        raise ValueError(f"block_b (threads per block) must lie in "
                         f"[1, 1024], got {block_b}")
    out = torch.empty((b, d), dtype=codebooks.dtype, device=codebooks.device)
    if b == 0:
        return out
    fn = build.function("rq_decode_stages", "rq_decode_stages_launch",
                        _RQ_ARGTYPES)
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    err = fn(codes.data_ptr(), _CODE_BYTES[codes.dtype],
             codebooks.data_ptr(), _ELEM_BYTES[codebooks.dtype],
             out.data_ptr(), b, m, k, d, block_b, stream)
    build.check("rq_decode_stages", err, "rq_decode_stages launch")
    rq_decode_stages.launches += 1
    return out


# launches of the kernel in this process (chip_smoke.py resets and
# reads it around the main path)
rq_decode_stages.launches = 0
