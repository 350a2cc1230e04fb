"""CUDA kernel wrapper: the fused EmbeddingBag (ragged gather +
weighted segment sum).

Replaces the TPU kernel ``src/repro/kernels/embedding_bag/
embedding_bag.py::embedding_bag`` (Pallas body ``_bag_kernel``).  The
kernel itself, with its design notes, is ``csrc/embedding_bag.cu``.  It
is bound by the bytes it moves, and at deepfm's width (d = 10, a 40-byte
row in two 32-byte sectors) by the latency of its loads: a block owns a
tile of bags, finds their ids' span by a 32-way warp search of the
sorted segment ids, stages the span's ids and weights in shared memory
a chunk at a time (the bags' starts by an adjacent difference), gathers
every row of a chunk at once with cp.async into a double-buffered
shared buffer, and a thread per (bag, vector) sums its bag's rows in id
order in registers.  ``bag_plan`` sizes the launch: the tile so that
the grid fills the card, the chunk to what shared memory holds, wide
rows in tiles of one bag and small chunks, and rows of more than
BAG_THREADS vectors cut into slabs.

The wrapper checks device, dtype, shape and contiguity, allocates the
output with ``torch.empty`` (every bag, empty ones included, is written
by the kernel), launches on the current stream, raises if the launch
fails and adds one to its ``launches`` count.  It takes CUDA tensors
only; the op's CPU path is the plain version in ``ref.py``, chosen by
the dispatch layer, never by a fallback here.  The kernel has no
backward (nor had the TPU kernel): a table or weights that require
grad are refused while grad mode is on.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_chunks import SMEM_PER_SM, align16, cdiv

_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}
_IDX_BYTES = {torch.int32: 4, torch.int64: 8}

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_void_p]

# the kernel's block (csrc/embedding_bag.cu's kThreads), the blocks an
# SM the planner sizes tiles and chunks for, and a chunk's most ids
BAG_THREADS = 256
BAG_BLOCKS_PER_SM = 2
BAG_CHUNK_MAX = 1024
# the shared memory a block may take for BAG_BLOCKS_PER_SM of them to
# fit an SM (the card reserves 1 KB a block)
BAG_SMEM_BUDGET = SMEM_PER_SM // BAG_BLOCKS_PER_SM - 1024
# wide rows: a block's slab of a row of at least BAG_WIDE_BYTES takes a
# tile of one bag and chunks of BAG_WIDE_CHUNK_BYTES of rows (at d = 256:
# 16 float32 rows, 32 bfloat16), so that more, smaller blocks share an
# SM and one block's sum overlaps the others' gathers (two blocks of a
# 113 KB chunk an SM measured slower on the card, in float32 and bfloat16)
BAG_WIDE_BYTES = 512
BAG_WIDE_CHUNK_BYTES = 16 * 1024


class BagPlan(NamedTuple):
    """One ``embedding_bag`` launch: ``vec`` elements a vector (the
    gather's copies), ``tile`` bags a block, ``chunk`` ids a chunk,
    ``slab`` vectors of a row a block sums, a grid of ``grid_x`` tiles
    by ``grid_y`` slabs, ``threads`` a block and ``smem`` bytes of
    dynamic shared memory."""
    vec: int
    tile: int
    chunk: int
    slab: int
    grid_x: int
    grid_y: int
    threads: int
    smem: int


def bag_vec(d: int, elem_bytes: int, align: int = 16) -> int:
    """Elements a vector: the widest of 8, 4, 2, 1 that divides ``d``,
    takes at most 16 bytes and divides ``align`` (the largest power of
    two that divides the table's and the output's addresses)."""
    return next(v for v in (8, 4, 2, 1)
                if d % v == 0 and v * elem_bytes <= 16
                and align % (v * elem_bytes) == 0)


def bag_smem(tile: int, chunk: int, slab: int, vec_bytes: int,
             idx_bytes: int) -> int:
    """A block's shared memory (``csrc/embedding_bag.cu``'s ``layout``):
    the span and ``tile`` + 1 bag starts, then two buffers of ``chunk``
    ids, weights and rows of ``slab`` vectors."""
    return 16 + align16(8 * (tile + 1)) + 2 * (
        align16(chunk * idx_bytes) + align16(chunk * 4)
        + align16(chunk * slab * vec_bytes))


@functools.lru_cache(maxsize=256)
def bag_plan(num_bags: int, d: int, elem_bytes: int, idx_bytes: int,
             sms: int, align: int = 16) -> BagPlan:
    """Plan ``embedding_bag`` of ``num_bags`` bags of rows of ``d``
    elements (``elem_bytes`` each) with ids of ``idx_bytes`` on a card
    of ``sms`` SMs.

    The rule: vectors of ``bag_vec``; a block of BAG_THREADS threads
    sums a slab of at most BAG_THREADS vectors of each row (rows wider
    than that are cut into slabs, the grid's second dimension), a
    thread per (bag, vector).  Narrow rows (a slab of less than
    BAG_WIDE_BYTES): a tile of at most BAG_THREADS // slab bags, as few
    as still give BAG_BLOCKS_PER_SM blocks an SM where there are bags
    enough, and chunks of as many ids as fit BAG_SMEM_BUDGET with both
    buffers, at most BAG_CHUNK_MAX.  Wide rows: a tile of one bag and
    chunks of BAG_WIDE_CHUNK_BYTES of rows, at least one row."""
    if num_bags < 1 or d < 1:
        raise ValueError(f"want num_bags >= 1 and d >= 1, got {num_bags} "
                         f"and {d}")
    vec = bag_vec(d, elem_bytes, align)
    vb = vec * elem_bytes
    g = d // vec
    slab = min(g, BAG_THREADS)
    grid_y = cdiv(g, slab)
    if slab * vb >= BAG_WIDE_BYTES:
        tile, chunk = 1, max(1, BAG_WIDE_CHUNK_BYTES // (slab * vb))
    else:
        tiles = cdiv(BAG_BLOCKS_PER_SM * sms, grid_y)
        tile = max(1, min(BAG_THREADS // slab, cdiv(num_bags, tiles)))
        head = bag_smem(tile, 0, slab, vb, idx_bytes)
        chunk = max(1, min(BAG_CHUNK_MAX, (BAG_SMEM_BUDGET - head)
                           // (2 * (idx_bytes + 4 + slab * vb))))
        while chunk > 1 and bag_smem(tile, chunk, slab, vb,
                                     idx_bytes) > BAG_SMEM_BUDGET:
            chunk -= 1      # the 16-byte alignment of the three arrays
    return BagPlan(vec, tile, chunk, slab, cdiv(num_bags, tile), grid_y,
                   BAG_THREADS, bag_smem(tile, chunk, slab, vb, idx_bytes))


def _align(ptr: int) -> int:
    """The largest power of two <= 16 that divides ``ptr``."""
    return min(16, ptr & -ptr) if ptr else 16


# the kernel's ctypes entry point, looked up at the first launch
_launch = None


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  segment_ids: torch.Tensor, num_bags: int,
                  weights: Optional[torch.Tensor] = None, *,
                  plan: Optional[BagPlan] = None) -> torch.Tensor:
    """table (V, d) float32/bfloat16; ids and segment_ids (nnz,)
    int32/int64, segment_ids sorted ascending in [0, num_bags); optional
    weights (nnz,), cast to the table's dtype; all contiguous on one
    CUDA device -> (num_bags, d) in the table's dtype, bags with no ids
    zero.  Ids outside [0, V) are clamped into the table.  ``plan``: a
    launch plan to run instead of ``bag_plan``'s (to time or test one);
    the kernel refuses one it cannot run."""
    global _launch
    if torch.is_grad_enabled() and (
            table.requires_grad
            or (weights is not None and weights.requires_grad)):
        raise RuntimeError(
            "embedding_bag's CUDA kernel has no backward: the table or "
            "the weights require grad; use the plain version (backend "
            "'torch'), which is differentiable, or run under "
            "torch.no_grad()")
    dev = table.device
    weighted = weights is not None
    if not (table.is_cuda and ids.is_cuda and segment_ids.is_cuda
            and (not weighted or weights.is_cuda)):
        raise ValueError(
            f"embedding_bag's CUDA kernel takes CUDA tensors, got "
            f"{_devices(table, ids, segment_ids, weights)}; the plain "
            f"version (backend 'torch') serves CPU tensors")
    if ids.device != dev or segment_ids.device != dev or (
            weighted and weights.device != dev):
        raise ValueError(f"tensors on several devices: "
                         f"{_devices(table, ids, segment_ids, weights)}")
    eb = _ELEM_BYTES.get(table.dtype)
    if eb is None:
        raise TypeError(f"table must be float32 or bfloat16, got "
                        f"{table.dtype}")
    ib = _IDX_BYTES.get(ids.dtype)
    if ib is None or segment_ids.dtype not in _IDX_BYTES:
        raise TypeError(f"ids and segment_ids must be int32 or int64, got "
                        f"{ids.dtype} and {segment_ids.dtype}")
    if table.dim() != 2 or ids.dim() != 1 or segment_ids.shape != ids.shape:
        raise ValueError(f"want table (V, d), ids and segment_ids (nnz,), "
                         f"got {tuple(table.shape)}, {tuple(ids.shape)} and "
                         f"{tuple(segment_ids.shape)}")
    if weighted and (weights.shape != ids.shape
                     or not weights.is_floating_point()):
        raise ValueError(f"want float weights (nnz,), got "
                         f"{tuple(weights.shape)} {weights.dtype}")
    if not (table.is_contiguous() and ids.is_contiguous()
            and segment_ids.is_contiguous()
            and (not weighted or weights.is_contiguous())):
        raise ValueError("embedding_bag takes contiguous tensors")
    if weighted:
        weights = weights.to(table.dtype)
    num_bags = int(num_bags)
    if num_bags < 0:
        raise ValueError(f"num_bags must be >= 0, got {num_bags}")
    if ids.dtype != segment_ids.dtype:
        ids, segment_ids = ids.long(), segment_ids.long()
        ib = 8
    v, d = table.shape
    out = torch.empty((num_bags, d), dtype=table.dtype, device=dev)
    if num_bags == 0 or d == 0:
        return out
    if v == 0 and ids.numel():
        raise ValueError("ids into an empty table")
    tp, op = table.data_ptr(), out.data_ptr()
    if plan is None:
        plan = bag_plan(num_bags, d, eb, ib, build.sm_count(dev),
                        _align(tp | op))
    if _launch is None:
        _launch = build.function("embedding_bag", "embedding_bag_launch",
                                 _ARGTYPES)
    err = _launch(tp, eb, v, d, ids.data_ptr(), segment_ids.data_ptr(), ib,
                  weights.data_ptr() if weighted else None, ids.numel(), op,
                  num_bags, plan.vec, plan.tile, plan.chunk, plan.slab,
                  plan.grid_x, plan.grid_y, plan.threads, plan.smem,
                  torch.cuda.current_stream(dev).cuda_stream)
    if err:
        build.check("embedding_bag", err, f"embedding_bag launch at V={v} "
                    f"d={d} nnz={ids.numel()} bags={num_bags} {plan} "
                    f"(limits: csrc/embedding_bag.cu)")
    build.count_launch(embedding_bag)
    return out


def _devices(*tensors) -> list:
    return sorted({str(t.device) for t in tensors if t is not None})


# launches of the kernel in this process (chip_smoke.py resets and
# reads it around each path)
embedding_bag.launches = 0


__all__ = ["BAG_BLOCKS_PER_SM", "BAG_CHUNK_MAX", "BAG_SMEM_BUDGET",
           "BAG_THREADS", "BAG_WIDE_BYTES", "BAG_WIDE_CHUNK_BYTES", "BagPlan",
           "bag_plan", "bag_smem", "bag_vec", "embedding_bag"]
