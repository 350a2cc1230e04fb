"""CUDA kernel wrapper: blocked causal/windowed GQA attention (forward).

Replaces the TPU kernel ``src/repro/kernels/flash_attention/
flash_attention.py::flash_attention`` (Pallas body ``_flash_kernel``).
The kernel itself, with its design notes, is
``csrc/flash_attention.cu``: one block per (query tile of 64 rows,
query head, batch row) walks the KV tiles of its band with the output
accumulator in registers; KV tiles wholly outside the band are
skipped.  bfloat16 runs both products on the tensor cores (mma.sync,
f32 accumulation, the softmax in registers); float32 stays on the CUDA
cores in f32, since TF32 would miss the f32 bar.  It reads
(B, S, H, hd) through strides: no transpose, and no g-fold repeat of
K/V for GQA (query head h reads KV head h // g).

The wrapper checks device, dtype, shape and the last dimension's
stride, allocates the output with ``torch.empty``, launches on the
current stream and raises if the launch fails.  It takes CUDA tensors
only, float32 or bfloat16, and no input that requires grad (the
backward — the JAX package's recompute through the reference — comes
with LM training); the op's CPU path is the plain version in
``ref.py``, chosen by the dispatch layer, never by a fallback here.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dispatch import Tunable

# KV rows per tile, 32 or 64 for either dtype (None: default_block_k);
# the query tile is fixed at 64 rows
BLOCK_K = Tunable(None, (None, 32, 64))

HEAD_DIMS = (16, 32, 64, 80, 128, 168, 320)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 10
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def default_block_k(dtype: torch.dtype, hd: int) -> int:
    """The KV tile a launch takes when the caller names none: 64 on the
    CUDA cores (float32); on the tensor cores (bfloat16) 64, but 32 at
    hd = 320, where a 64-key score tile beside the 16 x 320 f32
    accumulator would leave the thread too few registers."""
    return 32 if dtype == torch.bfloat16 and hd > 256 else 64


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: int = 1 << 30,
                    block_k: Optional[int] = None) -> torch.Tensor:
    """q (B, Sq, H, hd); k, v (B, Skv, Hkv, hd), one dtype (float32 or
    bfloat16), last dimension contiguous, on one CUDA device ->
    (B, Sq, H, hd) contiguous.  Query i sees key j iff
    ``0 <= i - j < window``; H must be a multiple of Hkv."""
    tensors = (q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "flash_attention's CUDA kernel has no backward: an input "
            "requires grad; use the plain version (backend 'torch'), "
            "which is differentiable, or run under torch.no_grad()")
    if not all(t.is_cuda for t in tensors):
        raise ValueError(
            f"flash_attention's CUDA kernel takes CUDA tensors, got "
            f"{[str(t.device) for t in tensors]}; the plain version "
            f"(backend 'torch') serves CPU tensors")
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"inputs on several devices: "
                         f"{[str(t.device) for t in tensors]}")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f"flash_attention takes q, k, v of one dtype, "
                        f"float32 or bfloat16, got "
                        f"{[t.dtype for t in tensors]}")
    if any(t.dim() != 4 for t in tensors):
        raise ValueError(f"want q (B, Sq, H, hd) and k, v (B, Skv, Hkv, "
                         f"hd), got {[tuple(t.shape) for t in tensors]}")
    b, sq, h, hd = q.shape
    _, skv, hkv, _ = k.shape
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd
            or hkv == 0 or h % hkv):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not agree (H must be a "
                         f"multiple of Hkv)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not compiled; the kernel takes "
                         f"{HEAD_DIMS}")
    if skv == 0:
        raise ValueError("flash_attention needs at least one key")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError("flash_attention reads the head dim contiguously "
                         "(stride 1)")
    if b > 65535 or h > 65535:
        raise ValueError(f"batch {b} and heads {h} must be <= 65535")
    block_k = default_block_k(q.dtype, hd) if block_k is None else int(block_k)
    if block_k not in (32, 64):
        raise ValueError(f"block_k must be 32 or 64, got {block_k}")
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    if b * sq * h == 0:
        return out
    fn = build.function("flash_attention", "flash_attention_launch",
                        _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [s for t in tensors for s in t.stride()[:3]]
    # clamped so the kernel's Skv + window cannot overflow 64 bits
    window = max(min(int(window), 1 << 62), -(1 << 62))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             b, sq, skv, h, hkv, hd, *strides, window, hd ** -0.5,
             block_k, _DTYPES[q.dtype], stream)
    build.check("flash_attention", err, "flash_attention launch")
    build.count_launch(flash_attention)
    return out


# launches of the kernel in this process (chip_smoke.py resets and
# reads it around the main path)
flash_attention.launches = 0
