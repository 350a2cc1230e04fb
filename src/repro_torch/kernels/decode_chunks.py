"""Launch planning shared by the small-table decode kernels.

``csrc/decode_chunks.cuh`` is the skeleton of ``mgqe_decode``,
``packed_decode`` and ``rq_decode_stages``: a block stages its table in
shared memory, then each warp walks chunks of ``CHUNK`` rows.  The
constants here are the header's (each kernel's entry point refuses a
plan past them) and the planner's own; the helpers size one such walk.
Each kernel's planner (``decode_plan``, ``packed_plan``, ``rq_plan``)
chooses between that route and its l2 route with them.  Pure Python:
the CPU tests check every plan.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

# the header's constants: rows a warp gathers at a time, the walk
# routes' largest staged table, the gather kernels' largest slot on
# them, a block's largest dynamic shared memory and threads
CHUNK = 32
SMEM_TABLE_MAX = 96 * 1024
SMEM_SLOT_MAX = 64
SMEM_MAX = 227 * 1024
MAX_THREADS = 1024
# the card's: shared memory and threads an SM (H100)
SMEM_PER_SM = 228 * 1024
THREADS_PER_SM = 2048
# the entry points' route numbers
ROUTES = {"smem": 0, "l2": 1}
# the planners' defaults: threads a block on the walk routes and their
# blocks an SM at most (a block stages its table, so fewer and larger
# blocks stage it less often: at serve_bulk 16 warps a block, each
# walking two chunks), and threads a block on the gather kernels' l2
# routes
WALK_THREADS = 512
WALK_BLOCKS_PER_SM = 2
L2_THREADS = 1024


class DecodePlan(NamedTuple):
    """One ``mgqe_decode`` or ``packed_decode`` launch: ``route``
    ("smem" or "l2"), ``threads`` a block, ``group`` lanes a slot (l2
    route), ``grid`` blocks, ``smem`` bytes of dynamic shared memory a
    block."""
    route: str
    threads: int
    group: int
    grid: int
    smem: int


class Walk(NamedTuple):
    """A walk route's launch shape: ``threads`` a block, ``grid``
    blocks, ``smem`` bytes of dynamic shared memory a block."""
    threads: int
    grid: int
    smem: int


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def align16(x: int) -> int:
    return cdiv(x, 16) * 16


def warp_bytes(in_row: int, out_row: int) -> int:
    """A warp's shared memory on a walk route: two chunks of input rows
    (``in_row`` bytes each) and one of output rows (``out_row``)."""
    return 2 * align16(CHUNK * in_row) + CHUNK * out_row


def whole_warps(block_b: Optional[int]) -> Optional[int]:
    """``block_b`` threads (any count in [1, MAX_THREADS]) rounded up to
    whole warps; None stays None."""
    if block_b is None:
        return None
    if not 0 < int(block_b) <= MAX_THREADS:
        raise ValueError(f"block_b (threads a block) must lie in "
                         f"[1, {MAX_THREADS}], got {block_b}")
    return cdiv(int(block_b), 32) * 32


def walk(b: int, table: int, per_warp: int, sms: int,
         block_b: Optional[int] = None) -> Optional[Walk]:
    """The launch of a walk over ``b`` rows with a ``table`` of staged
    bytes (16-byte aligned) and ``per_warp`` bytes a warp: blocks of
    WALK_THREADS or ``block_b`` threads (fewer warps where their chunks
    would not fit SMEM_MAX), up to WALK_BLOCKS_PER_SM an SM where
    threads and shared memory allow, and no more blocks than the chunks
    of CHUNK rows need.  None where the table is past SMEM_TABLE_MAX or
    one warp does not fit beside it."""
    if table > SMEM_TABLE_MAX or table + per_warp > SMEM_MAX:
        return None
    warps = (WALK_THREADS if block_b is None else int(block_b)) // 32
    while table + warps * per_warp > SMEM_MAX:
        warps -= 1
    smem = table + warps * per_warp
    per_sm = max(1, min(WALK_BLOCKS_PER_SM, THREADS_PER_SM // (32 * warps),
                        SMEM_PER_SM // (smem + 1024)))
    grid = max(1, min(cdiv(cdiv(b, CHUNK), warps), per_sm * sms))
    return Walk(32 * warps, grid, smem)


def l2_group(slot: int) -> int:
    """Lanes a slot on a gather kernel's l2 route: the next power of two
    >= the slot's vectors (the widest of 16, 8, 4, 2 bytes that divides
    it), at most 32."""
    vec = next(v for v in (16, 8, 4, 2) if slot % v == 0)
    return min(32, 1 << max(0, (cdiv(slot, vec) - 1).bit_length()))


def l2_gather_plan(b: int, d: int, slot: int, sms: int,
                   block_b: Optional[int] = None) -> DecodePlan:
    """A gather kernel's l2 route over ``b`` rows of ``d`` slots: blocks
    of L2_THREADS or ``block_b`` threads, ``l2_group(slot)`` lanes a
    slot, as many blocks as fill the card's threads once, and no more
    than the slots need."""
    threads = L2_THREADS if block_b is None else int(block_b)
    group = l2_group(slot)
    grid = max(1, min(cdiv(b * d * group, threads),
                      THREADS_PER_SM // threads * sms))
    return DecodePlan("l2", threads, group, grid, 0)


__all__ = ["CHUNK", "DecodePlan", "L2_THREADS", "MAX_THREADS", "ROUTES",
           "SMEM_MAX", "SMEM_PER_SM", "SMEM_SLOT_MAX", "SMEM_TABLE_MAX",
           "THREADS_PER_SM", "WALK_BLOCKS_PER_SM", "WALK_THREADS", "Walk",
           "align16", "cdiv", "l2_gather_plan", "l2_group", "walk",
           "warp_bytes", "whole_warps"]
