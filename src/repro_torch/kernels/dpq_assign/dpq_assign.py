"""CUDA kernel wrapper: nearest-centroid search (the DPQ/MGQE encoder).

Replaces the TPU kernel ``src/repro/kernels/dpq_assign/dpq_assign.py::
dpq_assign`` (Pallas body ``_assign_kernel``).  The kernel itself, with
its design notes, is ``csrc/dpq_assign.cu``: for each subspace, a
product of a row tile with a centroid tile, streamed over S through
shared memory, with the masked argmin fused into its epilogue — float32
on the CUDA cores, bfloat16 on the tensor cores (float32 accumulation).

The wrapper checks device, dtype, shape and contiguity, chooses the
tiles (:func:`choose_tiles`, pure Python), allocates the codes with
``torch.empty``, launches on the current stream and raises if the
launch fails.  It takes CUDA tensors only, float32 or bfloat16; the
op's CPU path is the plain version in ``ref.py``, chosen by the
dispatch layer, never by a fallback here.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dispatch import Tunable

# rows a block (None: choose_tiles picks by shape)
BLOCK_M = Tunable(None, (None, 64, 128, 256, 512, 1024))
# S values a k-step, the depth streamed through shared memory at a time;
# 0 is the float32 walk for small S (None: choose_tiles picks by S)
BLOCK_S = Tunable(None, (None, 0, 2, 4, 8, 16, 32, 64))

# centroids a tile: one tail tier of an MGQE table (K = 64) is one tile
BLOCK_N = 64

# what csrc/dpq_assign.cu instantiates for the tiled product, per dtype:
# (rows a block, S a k-step); float32 on the CUDA cores, bfloat16 on the
# tensor cores, whose k-depth is 16
TILES = {
    torch.float32: ((64, 128, 256), (2, 4, 8, 16, 32)),
    torch.bfloat16: ((64, 128), (16, 32, 64)),
}
# the float32 walk (block_s = 0): rows a block (256 threads, 1, 2 or 4
# rows each) and the S it is compiled for; the chooser walks at S up to
# WALK_MAX_S
WALK_ROWS = (256, 512, 1024)
WALK_S = (1, 2, 3, 4, 8, 16)
WALK_MAX_S = 16
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# a block's shared memory on an H100 (232,448 bytes)
MAX_SMEM = 227 * 1024
# blocks that fill an H100's 132 SMs: two a SM for the tiled product;
# four for the walk, whose blocks are short and uneven across SMs
_FILL_BLOCKS = 2 * 132
_WALK_BLOCKS = 4 * 132

_ARGTYPES = [ctypes.c_void_p] * 5 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def smem_bytes(dtype: torch.dtype, block_m: int, block_s: int, k: int,
               s: int) -> int:
    """Dynamic shared memory of one block, as ``csrc/dpq_assign.cu``
    lays it out.  Tiled product: two stages of the row tile and the
    centroid tile, a float32 row padded to an odd number of 16-byte
    chunks (k-steps of 2: not padded), a bfloat16 row by 16 bytes.
    Walk (block_s 0): the table, each centroid beside its norm in a row
    of 2 floats (S = 1) or S + 1 rounded up to 4."""
    if block_s == 0:
        return k * (2 if s == 1 else (s + 4) // 4 * 4) * 4
    if dtype == torch.float32:
        ld = block_s if block_s == 2 else 4 * ((block_s // 4 + 1) | 1)
        return 2 * (block_m + BLOCK_N) * ld * 4
    return 2 * (block_m + BLOCK_N) * (block_s + 8) * 2


def _fill(rows: Tuple[int, ...], b: int, d: int, blocks: int) -> int:
    """The largest row tile that still gives the card ``blocks`` blocks
    (``ceil(B / rows) * D``), else the smallest."""
    return next((m for m in reversed(rows) if -(-b // m) * d >= blocks),
                rows[0])


def choose_tiles(dtype: torch.dtype, b: int, d: int, k: int, s: int,
                 block_m: Optional[int] = None,
                 block_s: Optional[int] = None) -> Tuple[int, int]:
    """(rows a block, S values a k-step) for a call; a value the caller
    names is checked, one left as None is chosen.

    float32 at S <= WALK_MAX_S walks (block_s 0) when the table fits.
    Otherwise the k-step is the smallest instantiated one that holds S
    (a single step, zero-padded), else the largest (S streamed in
    steps).  The row tile is the largest that still fills the card
    (the walk asks for more blocks: at deepfm's export batch, 512 rows a
    block ran faster than 1,024 on an H100)."""
    if dtype not in TILES:
        raise TypeError(f"dpq_assign's kernel takes float32 or bfloat16, "
                        f"got {dtype}")
    walk = dtype == torch.float32 and (
        block_s == 0 or (block_s is None and s <= WALK_MAX_S
                         and s in WALK_S
                         and smem_bytes(dtype, 0, 0, k, s) <= MAX_SMEM))
    if walk:
        block_s = 0
        if block_m is None:
            block_m = _fill(WALK_ROWS, b, d, _WALK_BLOCKS)
        if block_m not in WALK_ROWS or s not in WALK_S:
            raise ValueError(f"dpq_assign's float32 walk takes block_m in "
                             f"{WALK_ROWS} and S in {WALK_S}, got "
                             f"{block_m} and {s}")
    else:
        ms, ss = TILES[dtype]
        if block_s is None:
            block_s = next((x for x in ss if x >= s), ss[-1])
        if block_m is None:
            block_m = _fill(ms, b, d, _FILL_BLOCKS)
        if block_m not in ms or block_s not in ss:
            raise ValueError(f"dpq_assign's {dtype} kernel takes block_m in "
                             f"{ms} and block_s in {ss}, got {block_m} and "
                             f"{block_s}")
    smem = smem_bytes(dtype, block_m, block_s, k, s)
    if smem > MAX_SMEM:
        raise ValueError(f"tiles ({block_m}, {block_s}) need {smem} bytes "
                         f"of shared memory, more than {MAX_SMEM}")
    return block_m, block_s


def dpq_assign(e_sub: torch.Tensor, centroids: torch.Tensor,
               k_limit: Optional[torch.Tensor] = None,
               block_m: Optional[int] = None,
               block_s: Optional[int] = None) -> torch.Tensor:
    """e_sub (B, D, S); centroids (D, K, S), both float32 or both
    bfloat16; k_limit (B,) int32 or None, all contiguous on one CUDA
    device -> codes (B, D) int32."""
    tensors = [e_sub, centroids] + ([] if k_limit is None else [k_limit])
    if not all(t.is_cuda for t in tensors):
        raise ValueError(
            f"dpq_assign's CUDA kernel takes CUDA tensors, got "
            f"{[str(t.device) for t in tensors]}; the plain version "
            f"(backend 'torch') serves CPU tensors")
    if any(t.device != e_sub.device for t in tensors):
        raise ValueError(f"inputs on several devices: "
                         f"{[str(t.device) for t in tensors]}")
    if e_sub.dtype not in TILES or centroids.dtype != e_sub.dtype:
        raise TypeError(
            f"dpq_assign's kernel takes float32 or bfloat16, one dtype for "
            f"both inputs, got e_sub {e_sub.dtype} and centroids "
            f"{centroids.dtype}")
    if e_sub.dim() != 3 or centroids.dim() != 3:
        raise ValueError(f"want e_sub (B, D, S) and centroids (D, K, S), "
                         f"got {tuple(e_sub.shape)} and "
                         f"{tuple(centroids.shape)}")
    b, d, s = e_sub.shape
    n_sub, k, s2 = centroids.shape
    if (d, s) != (n_sub, s2):
        raise ValueError(f"e_sub subspaces {(d, s)} do not match "
                         f"centroids {(n_sub, s2)}")
    if k_limit is not None:
        if k_limit.dtype != torch.int32 or tuple(k_limit.shape) != (b,):
            raise ValueError(f"k_limit must be int32 of shape ({b},), got "
                             f"{k_limit.dtype} {tuple(k_limit.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("dpq_assign takes contiguous inputs")
    block_m, block_s = choose_tiles(e_sub.dtype, b, d, k, s, block_m,
                                    block_s)
    codes = torch.empty((b, d), dtype=torch.int32, device=e_sub.device)
    if b == 0:
        return codes
    # the tiled product's squared norms, (D, K) float32
    norms = (None if block_s == 0 else
             torch.empty((d, k), dtype=torch.float32, device=e_sub.device))
    fn = build.function("dpq_assign", "dpq_assign_launch", _ARGTYPES)
    stream = torch.cuda.current_stream(e_sub.device).cuda_stream
    err = fn(e_sub.data_ptr(), centroids.data_ptr(),
             None if k_limit is None else k_limit.data_ptr(),
             None if norms is None else norms.data_ptr(), codes.data_ptr(),
             b, d, k, s, _DTYPE_CODE[e_sub.dtype], block_m, block_s, stream)
    build.check("dpq_assign", err, "dpq_assign launch")
    build.count_launch(dpq_assign)
    return codes


# launches of the kernel in this process (chip_smoke.py resets and
# reads it around the main path)
dpq_assign.launches = 0
