"""CUDA kernel wrapper: fused unpack-and-decode of bit-packed codes.

Replaces the TPU kernel ``src/repro/kernels/packed_decode/
packed_decode.py::packed_decode`` (Pallas body
``_packed_decode_kernel``).  The kernel itself, with its design notes,
is ``csrc/packed_decode.cu``: each thread unpacks one code from its
byte in registers and copies that centroid's S floats from a table
staged in shared memory, bound by the bytes it moves.

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
from repro_torch.kernels.packed_decode.pack import packed_width
from repro_torch.kernels.packed_decode.ref import check_table

# rows per tile; every block strides over tiles
BLOCK_B = Tunable(256, (64, 128, 256, 512))

_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]


def packed_decode(packed: torch.Tensor, centroids: torch.Tensor, bits: int,
                  block_b: Optional[int] = None) -> torch.Tensor:
    """packed (B, W) uint8 with W = ceil(D / (8 // bits)); centroids
    (D, K, S) float32/bfloat16 with K >= 2**bits, both contiguous on one
    CUDA device -> (B, D*S) in the centroid dtype."""
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
    block_b = BLOCK_B.default if block_b is None else int(block_b)
    if block_b <= 0:
        raise ValueError(f"block_b must be positive, got {block_b}")
    out = torch.empty((b, d * s), dtype=centroids.dtype,
                      device=centroids.device)
    if b == 0:
        return out
    fn = build.function("packed_decode", "packed_decode_launch", _ARGTYPES)
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    err = fn(packed.data_ptr(), centroids.data_ptr(),
             _ELEM_BYTES[centroids.dtype], out.data_ptr(), b, w, d, k, s,
             bits, block_b, stream)
    build.check("packed_decode", err, "packed_decode launch")
    packed_decode.launches += 1
    return out


# launches of the kernel in this process (chip_smoke.py resets and
# reads it around the main path)
packed_decode.launches = 0
