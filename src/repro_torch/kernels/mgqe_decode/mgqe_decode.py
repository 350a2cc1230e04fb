"""CUDA kernel wrappers: the MGQE/DPQ and RQ serving decodes.

Replace the TPU kernels of ``src/repro/kernels/mgqe_decode/
mgqe_decode.py``:

  ``mgqe_decode``       ``mgqe_decode`` (Pallas body ``_decode_kernel``)
                        -> ``csrc/mgqe_decode.cu``: a real gather from a
                        centroid table staged in shared memory
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
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dispatch import Tunable

# rows per tile; every block strides over tiles
BLOCK_B = Tunable(256, (64, 128, 256, 512))
# rq_decode_stages: threads per block, one output element each
RQ_BLOCK_B = Tunable(256, (64, 128, 256, 512, 1024))

_CODE_BYTES = {torch.uint8: 1, torch.int32: 4}
_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
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
