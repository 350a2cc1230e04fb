"""CUDA kernel wrapper: fused unpack-and-decode of bit-packed codes.

Replaces the TPU kernel ``src/repro/kernels/packed_decode/
packed_decode.py::packed_decode`` (Pallas body
``_packed_decode_kernel``).  The kernel itself, with its design notes,
is ``csrc/packed_decode.cu``.  Its smem route (every mpe tier) is the
per-warp row chunks of ``csrc/decode_chunks.cuh``: a block stages the
2^bits centroid rows a code can address, each warp takes its packed
bytes 32 rows at a time, a lane unpacks its row's codes in registers
and gathers its slots, and the warp writes the rows out in 16-byte
vectors.  Tables past that route's limits are read through L2, a group
of lanes a slot.  ``packed_plan`` chooses.  Bound by the bytes it moves.

The wrapper checks device, dtype, shape and contiguity, allocates the
output with ``torch.empty``, launches on the current stream and raises
if the launch fails.  It takes CUDA tensors only; the op's CPU path is
the plain version in ``ref.py``, chosen by the dispatch layer, never by
a fallback here.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_chunks import (ROUTES, SMEM_SLOT_MAX,
                                               DecodePlan, align16,
                                               l2_gather_plan, walk,
                                               warp_bytes, whole_warps)
from repro_torch.kernels.dispatch import Tunable
from repro_torch.kernels.packed_decode.pack import packed_width
from repro_torch.kernels.packed_decode.ref import check_table

# threads a block, rounded up to whole warps (None: packed_plan's
# choice); the mpe scheme passes its config's decode_block_b (the
# engine's pad multiple, 256 by default, any count in [1, 1024])
BLOCK_B = Tunable(None, (None, 128, 256, 512, 1024))

_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_void_p]


def packed_smem(d: int, slot: int, bits: int, warps: int) -> int:
    """A smem-route block's shared memory: each subspace's 2^bits
    staged slots (padded to 16 bytes) and, per warp, two chunks of
    packed bytes and one of output rows."""
    return d * align16(slot << bits) + warps * warp_bytes(
        packed_width(d, bits), d * slot)


def packed_plan(b: int, d: int, s: int, bits: int, elem_bytes: int,
                sms: int, block_b: Optional[int] = None) -> DecodePlan:
    """Plan ``packed_decode`` of B = ``b`` rows of D = ``d`` codes of
    ``bits`` bits against (D, K, S = ``s``) centroids on a card of
    ``sms`` SMs (K >= 2^bits plays no part: only the 2^bits rows a code
    addresses are read).  ``block_b``: threads a block, any count in
    [1, 1024], rounded up to whole warps.

    The rule: where the D * 2^bits addressed slots take at most
    SMEM_TABLE_MAX bytes (each subspace padded to 16), a slot at most
    SMEM_SLOT_MAX bytes and one warp's chunks fit beside them (every
    mpe tier), the smem route (``decode_chunks.walk``: blocks of
    WALK_THREADS or ``block_b``).  Anything else takes the l2 route
    (``decode_chunks.l2_gather_plan``: blocks of L2_THREADS or
    ``block_b``, a group of lanes a slot)."""
    block_b = whole_warps(block_b)
    slot = s * elem_bytes
    if slot <= SMEM_SLOT_MAX:
        w = walk(b, d * align16(slot << bits),
                 warp_bytes(packed_width(d, bits), d * slot), sms, block_b)
        if w is not None:
            return DecodePlan("smem", w.threads, 0, w.grid, w.smem)
    return l2_gather_plan(b, d, slot, sms, block_b)


def packed_decode(packed: torch.Tensor, centroids: torch.Tensor, bits: int,
                  block_b: Optional[int] = None, *,
                  plan: Optional[DecodePlan] = None) -> torch.Tensor:
    """packed (B, W) uint8 with W = ceil(D / (8 // bits)); centroids
    (D, K, S) float32/bfloat16 with K >= 2**bits, both contiguous on one
    CUDA device -> (B, D*S) in the centroid dtype.  ``block_b``: threads
    a block, in [1, 1024], rounded up to whole warps.  ``plan``: a launch plan to run instead
    of ``packed_plan``'s (to time or test a route); the kernel refuses
    one it cannot run."""
    if not (packed.is_cuda and centroids.is_cuda):
        raise ValueError(
            f"packed_decode's CUDA kernel takes CUDA tensors, got packed "
            f"on {packed.device} and centroids on {centroids.device}; the "
            f"plain version (backend 'torch') serves CPU tensors")
    if packed.device != centroids.device:
        raise ValueError(f"packed on {packed.device}, centroids on "
                         f"{centroids.device}")
    if packed.dtype != torch.uint8:
        raise TypeError(f"packed codes must be uint8, got {packed.dtype}")
    if centroids.dtype not in _ELEM_BYTES:
        raise TypeError(f"centroids must be float32 or bfloat16, got "
                        f"{centroids.dtype}")
    check_table(centroids, bits)
    if packed.dim() != 2:
        raise ValueError(f"want packed (B, W), got {tuple(packed.shape)}")
    b, w = packed.shape
    d, k, s = centroids.shape
    if w != packed_width(d, bits):
        raise ValueError(
            f"packed width {w} does not hold {d} codes of {bits} bits "
            f"(want {packed_width(d, bits)})")
    if not (packed.is_contiguous() and centroids.is_contiguous()):
        raise ValueError("packed_decode takes contiguous packed codes and "
                         "centroids")
    eb = _ELEM_BYTES[centroids.dtype]
    if plan is None:
        plan = packed_plan(b, d, s, bits, eb, build.sm_count(packed.device),
                           BLOCK_B.default if block_b is None else block_b)
    out = torch.empty((b, d * s), dtype=centroids.dtype,
                      device=centroids.device)
    if b == 0:
        return out
    fn = build.function("packed_decode", "packed_decode_launch", _ARGTYPES)
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    err = fn(packed.data_ptr(), centroids.data_ptr(), eb, out.data_ptr(), b,
             w, d, k, s, bits, ROUTES[plan.route], plan.group, plan.grid,
             plan.threads, plan.smem, stream)
    build.check("packed_decode", err, f"packed_decode launch at B={b} D={d} "
                f"K={k} S={s} bits={bits} {plan} (limits: "
                f"csrc/packed_decode.cu)")
    build.count_launch(packed_decode)
    return out


# launches of the kernel in this process (chip_smoke.py resets and
# reads it around the main path)
packed_decode.launches = 0
