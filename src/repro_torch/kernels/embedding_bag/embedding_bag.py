"""CUDA kernel wrapper: the fused EmbeddingBag (ragged gather +
weighted segment sum).

Replaces the TPU kernel ``src/repro/kernels/embedding_bag/
embedding_bag.py::embedding_bag`` (Pallas body ``_bag_kernel``).  The
kernel itself, with its design notes, is ``csrc/embedding_bag.cu``: a
group of lanes per bag finds the bag's ids by binary search in the
sorted segment ids and sums its rows in registers, in the bag's id
order, bound by the bytes it moves.

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
from typing import Optional

import torch

from repro_torch.kernels import build

_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}
_IDX_BYTES = {torch.int32: 4, torch.int64: 8}

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_void_p]


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  segment_ids: torch.Tensor, num_bags: int,
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """table (V, d) float32/bfloat16; ids and segment_ids (nnz,)
    int32/int64, segment_ids sorted ascending in [0, num_bags); optional
    weights (nnz,), cast to the table's dtype; all contiguous on one
    CUDA device -> (num_bags, d) in the table's dtype, bags with no ids
    zero.  Ids outside [0, V) are clamped into the table."""
    if torch.is_grad_enabled() and (
            table.requires_grad
            or (weights is not None and weights.requires_grad)):
        raise RuntimeError(
            "embedding_bag's CUDA kernel has no backward: the table or "
            "the weights require grad; use the plain version (backend "
            "'torch'), which is differentiable, or run under "
            "torch.no_grad()")
    tensors = [table, ids, segment_ids] + ([] if weights is None
                                           else [weights])
    if not all(t.is_cuda for t in tensors):
        raise ValueError(
            f"embedding_bag's CUDA kernel takes CUDA tensors, got "
            f"{sorted({str(t.device) for t in tensors})}; the plain version "
            f"(backend 'torch') serves CPU tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"tensors on several devices: "
                         f"{sorted({str(t.device) for t in tensors})}")
    if table.dtype not in _ELEM_BYTES:
        raise TypeError(f"table must be float32 or bfloat16, got "
                        f"{table.dtype}")
    if ids.dtype not in _IDX_BYTES or segment_ids.dtype not in _IDX_BYTES:
        raise TypeError(f"ids and segment_ids must be int32 or int64, got "
                        f"{ids.dtype} and {segment_ids.dtype}")
    if table.dim() != 2 or ids.dim() != 1 or segment_ids.shape != ids.shape:
        raise ValueError(f"want table (V, d), ids and segment_ids (nnz,), "
                         f"got {tuple(table.shape)}, {tuple(ids.shape)} and "
                         f"{tuple(segment_ids.shape)}")
    if weights is not None:
        if weights.shape != ids.shape or not weights.is_floating_point():
            raise ValueError(f"want float weights (nnz,), got "
                             f"{tuple(weights.shape)} {weights.dtype}")
        weights = weights.to(table.dtype)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("embedding_bag takes contiguous tensors")
    num_bags = int(num_bags)
    if num_bags < 0:
        raise ValueError(f"num_bags must be >= 0, got {num_bags}")
    if ids.dtype != segment_ids.dtype:
        ids, segment_ids = ids.long(), segment_ids.long()
    v, d = table.shape
    out = torch.empty((num_bags, d), dtype=table.dtype, device=table.device)
    if num_bags == 0 or d == 0:
        return out
    if v == 0 and ids.numel():
        raise ValueError("ids into an empty table")
    fn = build.function("embedding_bag", "embedding_bag_launch", _ARGTYPES)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = fn(table.data_ptr(), _ELEM_BYTES[table.dtype], v, d,
             ids.data_ptr(), segment_ids.data_ptr(), _IDX_BYTES[ids.dtype],
             None if weights is None else weights.data_ptr(), ids.numel(),
             out.data_ptr(), num_bags, stream)
    build.check("embedding_bag", err, "embedding_bag launch")
    embedding_bag.launches += 1
    return out


# launches of the kernel in this process (chip_smoke.py resets and
# reads it around each path)
embedding_bag.launches = 0
