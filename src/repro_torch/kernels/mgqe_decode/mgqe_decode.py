"""CUDA kernel wrapper: MGQE/DPQ serving decode (codes -> embeddings).

Replaces the TPU kernel ``src/repro/kernels/mgqe_decode/mgqe_decode.py::
mgqe_decode`` (Pallas body ``_decode_kernel``).  The kernel itself,
with its design notes, is ``csrc/mgqe_decode.cu``: a real gather from a
centroid table staged in shared memory, bound by the bytes it moves.

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
from repro_torch.kernels.dispatch import Tunable

# rows per tile; every block strides over tiles
BLOCK_B = Tunable(256, (64, 128, 256, 512))

_CODE_BYTES = {torch.uint8: 1, torch.int32: 4}
_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


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
    block_b = BLOCK_B.default if block_b is None else int(block_b)
    if block_b <= 0:
        raise ValueError(f"block_b must be positive, got {block_b}")
    out = torch.empty((b, d * s), dtype=centroids.dtype,
                      device=centroids.device)
    if b == 0:
        return out
    fn = build.function("mgqe_decode", "mgqe_decode_launch", _ARGTYPES)
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    err = fn(codes.data_ptr(), _CODE_BYTES[codes.dtype],
             centroids.data_ptr(), _ELEM_BYTES[centroids.dtype],
             out.data_ptr(), b, d, k, s, block_b, stream)
    build.check("mgqe_decode", err, "mgqe_decode launch")
    mgqe_decode.launches += 1
    return out


# launches of the kernel in this process (chip_smoke.py resets and
# reads it around the main path)
mgqe_decode.launches = 0
