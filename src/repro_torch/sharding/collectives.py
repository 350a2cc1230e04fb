"""Collectives over the named axes of a :class:`~repro_torch.launch.mesh.Mesh`.

What a ``shard_map`` body calls in the JAX package — ``lax.psum``,
``lax.all_gather`` and ``lax.axis_index`` — over ``torch.distributed``
on the mesh's per-axis process groups.  They take the list forms of
``all_gather``/``all_reduce``, which gloo runs on CUDA tensors too (it
stages them through host memory).  An axis of size 1 costs nothing.

Every rank of an axis's group must make the same calls in the same
order, so callers decide whether to call from state that every rank
shares (the ids of a flush, never a per-rank count).

:func:`all_gather_grad` is the tiled gather that autograd sees through:
its backward sums the cotangent over the same axes and keeps this
rank's slice (a reduce-scatter), as the transpose of ``lax.all_gather``
does.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch

Axes = Union[str, Sequence[str]]


def _axes(axes: Axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
    return mesh.axis_index(axis)


def psum(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axes`` (``lax.psum``); a new
    tensor, ``x`` is left as it was."""
    import torch.distributed as dist
    out = x.clone()
    for a in _axes(axes):
        if mesh.shape[a] > 1:
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group(a))
    return out


def all_gather(x: torch.Tensor, mesh, axes: Axes,
               tiled: bool = True) -> torch.Tensor:
    """Every rank's ``x`` over ``axes``, in mesh order (the first axis
    slowest, as ``lax.all_gather`` over a tuple of axes orders them).
    ``tiled``: concatenated along dim 0; else stacked on a new leading
    dim (one axis only)."""
    import torch.distributed as dist
    axes = _axes(axes)
    if not tiled and len(axes) != 1:
        raise ValueError(f"an untiled all_gather takes one axis, got {axes}")
    x = x.contiguous()
    if not tiled:
        x = x.unsqueeze(0)
    # the innermost axis first: each outer gather then lays whole inner
    # blocks side by side
    for a in reversed(axes):
        n = mesh.shape[a]
        if n == 1:
            continue
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=mesh.group(a))
        x = torch.cat(parts)
    return x


def linear_index(mesh, axes: Axes) -> int:
    """This rank's position among the ranks of ``axes``, in mesh order
    (the block :func:`all_gather` puts this rank's ``x`` at)."""
    idx = 0
    for a in _axes(axes):
        idx = idx * mesh.shape[a] + mesh.axis_index(a)
    return idx


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes, ctx.rows = mesh, axes, x.shape[0]
        return all_gather(x, mesh, axes)

    @staticmethod
    def backward(ctx, grad):
        i, n = linear_index(ctx.mesh, ctx.axes), ctx.rows
        return psum(grad.contiguous(), ctx.mesh, ctx.axes)[i * n:(i + 1) * n], \
            None, None


def all_gather_grad(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """:func:`all_gather` (tiled) with a backward: the cotangent summed
    over ``axes`` and this rank's slice of it, so a loss that every rank
    computes from the gathered rows gives each rank the whole gradient
    of its own rows."""
    return _AllGather.apply(x, mesh, _axes(axes))


__all__ = ["all_gather", "all_gather_grad", "axis_index", "linear_index",
           "psum"]
