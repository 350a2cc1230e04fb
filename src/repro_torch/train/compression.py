"""Gradient compression for a data-parallel all-reduce: int8
quantization with error feedback (1-bit-Adam-style residual
correction), from the JAX package's ``train/compression.py``.

Each rank quantizes its local gradient leaf by leaf, the sum runs over
the dequantized float32 values (as the JAX package's float psum does),
and the error-feedback state keeps the quantization bias from
accumulating.  So, as there, the 8/32 wire saving is modelled, not
taken: the collective carries float32.  Nothing in the launcher turns
it on.
"""
from __future__ import annotations

from typing import Any, Sequence, Tuple, Union

import torch

from repro_torch.core.schemes.base import tree_map


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes in [-127, 127], the float32 scale max|x| / 127 +
    1e-12).  ``torch.round`` rounds half to even, as ``jnp.round``."""
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum_mean(grads: Any, err: Any, mesh,
                         axes: Union[str, Sequence[str]]
                         ) -> Tuple[Any, Any]:
    """Per-leaf int8 quantize (with error feedback), sum over the ranks
    of ``axes``, dequantized mean.  Returns (mean grads, new err); ``err``
    mirrors ``grads`` (:func:`init_error_state`).  Every rank of the
    axes calls it with the same tree."""
    from repro_torch.sharding.collectives import _axes, psum
    n = 1
    for a in _axes(axes):
        n *= mesh.shape[a]

    def one(g, e):
        g32 = g.to(torch.float32) + e
        q, scale = quantize_int8(g32)
        deq = dequantize(q, scale)
        # the payload: the int8 values, cast for the float sum, and one
        # scale a leaf a rank
        summed = psum(deq, mesh, axes)
        return (summed / n).to(g.dtype), g32 - deq

    pairs = _zip_map(one, grads, err)
    return tree_map(lambda p: p.mean, pairs), tree_map(lambda p: p.err,
                                                       pairs)


class _Pair:
    """A leaf's (mean, new error), kept as one leaf of the tree."""

    def __init__(self, mean: torch.Tensor, err: torch.Tensor):
        self.mean, self.err = mean, err


def _zip_map(fn, grads, err):
    """``_Pair(*fn(g, e))`` over two trees of the same structure, leaf
    by leaf (dict keys matched by name)."""
    if isinstance(grads, dict):
        return {k: _zip_map(fn, v, err[k]) for k, v in grads.items()}
    if isinstance(grads, (list, tuple)):
        return type(grads)(_zip_map(fn, g, e)
                           for g, e in zip(grads, err, strict=True))
    return _Pair(*fn(grads, err))


def init_error_state(grads_template: Any) -> Any:
    """float32 zeros shaped like ``grads_template``, on its devices."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_template)


__all__ = ["compressed_psum_mean", "dequantize", "init_error_state",
           "quantize_int8"]
