"""CUDA kernel wrapper: nearest-centroid search (the DPQ/MGQE encoder).

Replaces the TPU kernel ``src/repro/kernels/dpq_assign/dpq_assign.py::
dpq_assign`` (Pallas body ``_assign_kernel``).  The kernel itself, with
its design notes, is ``csrc/dpq_assign.cu``: one block per (row tile,
subspace), centroids and their squared norms in shared memory (in
chunks of K when one subspace's table does not fit, as an LM token
table's S = 320 does not), the distances and the running argmin in
registers — bound by the operations of the distance loop.

The wrapper checks device, dtype, shape and contiguity, allocates the
codes with ``torch.empty``, launches on the current stream and raises
if the launch fails.  It takes CUDA tensors only, float32 only; the
op's CPU path is the plain version in ``ref.py``, chosen by the
dispatch layer, never by a fallback here.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dispatch import Tunable

# rows per block (= threads per block)
BLOCK_B = Tunable(256, (64, 128, 256, 512, 1024))

# a block's shared memory: one chunk of centroids[d] and their norms
_MAX_SMEM = 227 * 1024

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def chunk_centroids(k: int, s: int) -> int:
    """Centroids staged at a time: all K when one subspace's table and
    norms fit a block's shared memory, else the most that do."""
    fit = _MAX_SMEM // ((s + 1) * 4)
    if fit < 1:
        raise ValueError(f"one centroid of S={s} floats exceeds a block's "
                         f"shared memory")
    return min(k, fit)


def dpq_assign(e_sub: torch.Tensor, centroids: torch.Tensor,
               k_limit: Optional[torch.Tensor] = None,
               block_b: Optional[int] = None) -> torch.Tensor:
    """e_sub (B, D, S) f32; centroids (D, K, S) f32; k_limit (B,) int32
    or None, all contiguous on one CUDA device -> codes (B, D) int32."""
    tensors = [e_sub, centroids] + ([] if k_limit is None else [k_limit])
    if not all(t.is_cuda for t in tensors):
        raise ValueError(
            f"dpq_assign's CUDA kernel takes CUDA tensors, got "
            f"{[str(t.device) for t in tensors]}; the plain version "
            f"(backend 'torch') serves CPU tensors")
    if any(t.device != e_sub.device for t in tensors):
        raise ValueError(f"inputs on several devices: "
                         f"{[str(t.device) for t in tensors]}")
    if e_sub.dtype != torch.float32 or centroids.dtype != torch.float32:
        raise TypeError(
            f"dpq_assign's kernel takes float32 only, got e_sub "
            f"{e_sub.dtype} and centroids {centroids.dtype} (bfloat16 "
            f"export is queued in ROADMAP.md)")
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
    kc = chunk_centroids(k, s)
    block_b = BLOCK_B.default if block_b is None else int(block_b)
    if not 0 < block_b <= 1024:
        raise ValueError(f"block_b must lie in [1, 1024], got {block_b}")
    codes = torch.empty((b, d), dtype=torch.int32, device=e_sub.device)
    if b == 0:
        return codes
    fn = build.function("dpq_assign", "dpq_assign_launch", _ARGTYPES)
    stream = torch.cuda.current_stream(e_sub.device).cuda_stream
    err = fn(e_sub.data_ptr(), centroids.data_ptr(),
             None if k_limit is None else k_limit.data_ptr(),
             codes.data_ptr(), b, d, k, s, kc, block_b, stream)
    build.check("dpq_assign", err, "dpq_assign launch")
    dpq_assign.launches += 1
    return codes


# launches of the kernel in this process (chip_smoke.py resets and
# reads it around the main path)
dpq_assign.launches = 0
