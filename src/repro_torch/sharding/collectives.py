"""Collectives over the named axes of a :class:`~repro_torch.launch.mesh.Mesh`.

What a ``shard_map`` body calls in the JAX package — ``lax.psum``,
``lax.pmean``, ``lax.all_gather``, ``lax.all_to_all`` and
``lax.axis_index`` — and a broadcast from the first rank, over
``torch.distributed`` on the mesh's per-axis process groups.  They
take the list forms of ``all_gather``/``all_reduce`` and the
single-tensor ``all_to_all_single``, which gloo runs on CUDA tensors
too (it stages them through host memory; it has no list-form
all-to-all there).  An axis of size 1 costs nothing.

Every rank of an axis's group must make the same calls in the same
order, so callers decide whether to call from state that every rank
shares (the ids of a flush, never a per-rank count).

**Gradients.**  The port trains under one convention (``launch/
cells.py``): a loss is computed *redundantly* on every rank of
``model`` (each model rank holds the same value and the same
cotangent, counted once) and *summed* over the data axes (each rank's
share weighted B_local/B_global).  The autograd collectives below are
the transposes under that convention:

* :func:`all_gather_grad` — a gather over axes whose ranks feed
  *different* partials of the loss (the data axes): its backward sums
  the cotangent over them and keeps this rank's slice (a
  reduce-scatter), as the transpose of ``lax.all_gather`` does;
* :func:`gather_from` — a gather whose consumer is replicated over
  ``model``: every rank's cotangent is the whole one, so its backward
  *slices*.  A sum there would multiply the gradient by the axis size;
* :func:`scatter_to` — this rank's block of a tensor replicated over the
  axis; backward, the blocks' cotangents gathered back;
* :func:`copy_to` and :func:`reduce_from` — the tensor-parallel
  conjugates: the input of a column-parallel product (identity
  forward, psum backward) and the output of a row-parallel one (psum
  forward, identity backward);
* :func:`psum_scatter` — this rank's block of a sum of partials over
  the axes (MACE's receiver sum on a mesh); backward, the blocks'
  cotangents gathered;
* :func:`all_to_all` — backward, the reverse all-to-all;
* :func:`pmean` — backward, the cotangent summed over the data axes
  among its axes and divided by their ranks.

A mesh whose ``stats`` holds a :class:`CommStats` counts every
collective, its kind, its bytes and its seconds (the device
synchronised around it); a mesh without one pays nothing.  On an
:class:`~repro_torch.launch.mesh.AbstractMesh` every collective is
counted and skipped in one place (``_collective``): its output keeps
the shape the real one would have, its values are not computed.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Sequence, Union

import torch

Axes = Union[str, Sequence[str]]
# half-precision sums are taken in float32 and rounded once
_WIDE = {torch.bfloat16: torch.float32, torch.float16: torch.float32}


def _axes(axes: Axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


# the kinds a CommStats tells apart
KINDS = ("all-reduce", "all-gather", "all-to-all", "broadcast")


@dataclasses.dataclass
class CommStats:
    """Collectives made through a mesh while it holds this object: their
    count, the bytes each rank sent into them and the host seconds they
    took, the device synchronised before and after each; ``kinds`` and
    ``kind_bytes`` split the count and the bytes by kind (``KINDS``),
    ``axis_bytes`` the bytes by the mesh axis the collective ran over.
    On an :class:`~repro_torch.launch.mesh.AbstractMesh` the count and
    the bytes are what a rank of a real mesh of its shape would make."""

    count: int = 0
    bytes: int = 0
    seconds: float = 0.0
    kinds: Dict[str, int] = dataclasses.field(default_factory=dict)
    kind_bytes: Dict[str, int] = dataclasses.field(default_factory=dict)
    axis_bytes: Dict[str, int] = dataclasses.field(default_factory=dict)

    def add(self, kind: str, axis: str, nbytes: int,
            seconds: float) -> None:
        self.count += 1
        self.bytes += nbytes
        self.seconds += seconds
        self.kinds[kind] = self.kinds.get(kind, 0) + 1
        self.kind_bytes[kind] = self.kind_bytes.get(kind, 0) + nbytes
        self.axis_bytes[axis] = self.axis_bytes.get(axis, 0) + nbytes

    def counted(self) -> tuple:
        """(count, bytes, kinds, kind_bytes): what a dry run predicts."""
        return (self.count, self.bytes, dict(sorted(self.kinds.items())),
                dict(sorted(self.kind_bytes.items())))


def _collective(mesh, kind: str, axis: str, t: torch.Tensor, call) -> None:
    """Make one collective of ``kind`` over ``axis`` that sends ``t``:
    ``call()`` makes
    it, unless ``mesh`` is abstract (then the caller's output tensor,
    already of the right shape, is the result); counted into
    ``mesh.stats`` when the mesh has one, timed with the device
    synchronised before and after."""
    stats = getattr(mesh, "stats", None)
    abstract = getattr(mesh, "abstract", False)
    if stats is None:
        if not abstract:
            call()
        return
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    if not abstract:
        call()
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    stats.add(kind, axis, t.numel() * t.element_size(),
              time.perf_counter() - t0)


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
    return mesh.axis_index(axis)


def axes_size(mesh, axes: Axes) -> int:
    """The number of ranks along ``axes``."""
    n = 1
    for a in _axes(axes):
        n *= mesh.shape[a]
    return n


def psum(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axes`` (``lax.psum``); a new
    tensor, ``x`` is left as it was.  A bfloat16 or float16 ``x`` is
    summed in float32 and rounded once."""
    import torch.distributed as dist
    wide = _WIDE.get(x.dtype)
    out = x.to(wide) if wide is not None else x.clone()
    for a in _axes(axes):
        if mesh.shape[a] > 1:
            _collective(mesh, "all-reduce", a, out, lambda: dist.all_reduce(
                out, op=dist.ReduceOp.SUM, group=mesh.group(a)))
    return out.to(x.dtype) if wide is not None else out


def pmax(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """Elementwise max of ``x`` over the ranks of ``axes`` (no gradient)."""
    import torch.distributed as dist
    out = x.detach().clone()
    for a in _axes(axes):
        if mesh.shape[a] > 1:
            _collective(mesh, "all-reduce", a, out, lambda: dist.all_reduce(
                out, op=dist.ReduceOp.MAX, group=mesh.group(a)))
    return out


def broadcast(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """``x`` of the rank at index 0 of every one of ``axes``, on every
    rank, in place (each axis in turn: after the last, every rank holds
    the first rank's ``x``).  Ranks other than the first pass a tensor of
    the same shape and dtype, whose values are overwritten."""
    import torch.distributed as dist
    for a in _axes(axes):
        if mesh.shape[a] > 1:
            def call(a=a):
                group = mesh.group(a)
                dist.broadcast(x, src=dist.get_global_rank(group, 0),
                               group=group)
            _collective(mesh, "broadcast", a, x, call)
    return x


def all_gather(x: torch.Tensor, mesh, axes: Axes,
               tiled: bool = True, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` over ``axes``, in mesh order (the first axis
    slowest, as ``lax.all_gather`` over a tuple of axes orders them).
    ``tiled``: concatenated along ``dim``; else stacked on a new leading
    dim (one axis only)."""
    import torch.distributed as dist
    axes = _axes(axes)
    if not tiled and len(axes) != 1:
        raise ValueError(f"an untiled all_gather takes one axis, got {axes}")
    if not tiled:
        x = x.unsqueeze(0)
    elif dim:
        return all_gather(x.movedim(dim, 0), mesh, axes).movedim(0, dim)
    x = x.contiguous()
    # the innermost axis first: each outer gather then lays whole inner
    # blocks side by side
    for a in reversed(axes):
        n = mesh.shape[a]
        if n == 1:
            continue
        parts = [torch.empty_like(x) for _ in range(n)]
        _collective(mesh, "all-gather", a, x, lambda: dist.all_gather(
            parts, x, group=mesh.group(a)))
        x = torch.cat(parts)
    return x


def linear_index(mesh, axes: Axes) -> int:
    """This rank's position among the ranks of ``axes``, in mesh order
    (the block :func:`all_gather` puts this rank's ``x`` at)."""
    idx = 0
    for a in _axes(axes):
        idx = idx * mesh.shape[a] + mesh.axis_index(a)
    return idx


def block(x: torch.Tensor, mesh, axes: Axes, dim: int = 0) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over ``axes`` (a view),
    the block :func:`all_gather` takes from it; a ``dim`` that does not
    divide raises."""
    n = axes_size(mesh, axes)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not divide "
                         f"over {_axes(axes)} = {n}")
    size = x.shape[dim] // n
    return x.narrow(dim, linear_index(mesh, axes) * size, size)


def _all_to_all(x: torch.Tensor, mesh, axis: str, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    import torch.distributed as dist
    n = mesh.shape[axis]
    if n == 1:
        return x
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of size "
                         f"{x.shape[split_dim]} does not split over "
                         f"{axis} = {n}")
    # the single-tensor form, the blocks laid along dim 0 (gloo refuses
    # the list form on CUDA tensors)
    blocks = x.movedim(split_dim, 0).contiguous()
    out = torch.empty_like(blocks)
    _collective(mesh, "all-to-all", axis, blocks,
                lambda: dist.all_to_all_single(out, blocks,
                                               group=mesh.group(axis)))
    return torch.cat([c.movedim(0, split_dim)
                      for c in out.chunk(n, dim=0)], dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.args = (mesh, axis, concat_dim, split_dim)
        return _all_to_all(x, mesh, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, *ctx.args), None, None, None, None


def all_to_all(x: torch.Tensor, mesh, axis: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``:
    ``x`` cut into ``n`` blocks along ``split_dim``, block ``j`` sent to
    rank ``j`` of ``axis``, the blocks received laid along
    ``concat_dim`` in rank order.  Backward: the reverse all-to-all."""
    return _AllToAll.apply(x, mesh, axis, split_dim, concat_dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return all_gather(x, mesh, axes, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return block(psum(grad.contiguous(), ctx.mesh, ctx.axes), ctx.mesh,
                     ctx.axes, ctx.dim), None, None, None


def all_gather_grad(x: torch.Tensor, mesh, axes: Axes,
                    dim: int = 0) -> torch.Tensor:
    """:func:`all_gather` (tiled, along ``dim``) with a backward: the
    cotangent summed over ``axes`` and this rank's slice of it (a
    reduce-scatter), so a loss that every rank computes a different
    share of from the gathered rows gives each rank the whole gradient
    of its own rows.  For a consumer replicated over the axis, see
    :func:`gather_from`."""
    return _AllGather.apply(x, mesh, _axes(axes), dim)


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather(x, mesh, axis, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return block(grad, ctx.mesh, ctx.axis, ctx.dim), None, None, None


def gather_from(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The blocks of ``axis``'s ranks along ``dim``, for a consumer
    replicated over ``axis``: backward, this rank's slice of the
    cotangent (every rank holds the whole one)."""
    return _GatherFrom.apply(x, mesh, axis, dim)


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return block(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad, ctx.mesh, ctx.axis, dim=ctx.dim), None, \
            None, None


def scatter_to(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of ``x``, replicated over ``axis``:
    backward, the blocks' cotangents gathered (the whole cotangent of
    ``x``, on every rank)."""
    return _ScatterTo.apply(x, mesh, axis, dim)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return psum(grad, ctx.mesh, ctx.axis), None, None


def copy_to(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Identity forward, psum over ``axis`` backward: the input (or a
    replicated weight) of work that each rank of ``axis`` does a
    different part of, e.g. a column-parallel product."""
    if mesh.shape[axis] == 1:
        return x
    return _CopyTo.apply(x, mesh, axis)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return psum(x, mesh, axes)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def reduce_from(x: torch.Tensor, mesh, axis: Axes) -> torch.Tensor:
    """psum over ``axis`` (one axis or several) forward, identity
    backward: the output of a row-parallel product, or a loss's partial
    sums, replicated over the axes after the sum."""
    if axes_size(mesh, axis) == 1:
        return x
    return _ReduceFrom.apply(x, mesh, _axes(axis))


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return block(psum(x, mesh, axes), mesh, axes, dim).clone()

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad.contiguous(), ctx.mesh, ctx.axes,
                          dim=ctx.dim), None, None, None


def psum_scatter(x: torch.Tensor, mesh, axes: Axes,
                 dim: int = 0) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``x`` over ``axes``
    (``lax.psum_scatter``, tiled): each rank holds partial sums of the
    whole and keeps its block of the total.  gloo has no reduce-scatter,
    so the whole sum crosses (a psum) and the block is cut after.
    Backward: the blocks' cotangents gathered, each rank's partial
    feeding every block."""
    return _PsumScatter.apply(x, mesh, _axes(axes), dim)


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, model_axis):
        ctx.mesh, ctx.n = mesh, axes_size(mesh, axes)
        ctx.data = tuple(a for a in axes if a != model_axis)
        return psum(x, mesh, axes) / ctx.n

    @staticmethod
    def backward(ctx, grad):
        return psum(grad, ctx.mesh, ctx.data) / ctx.n, None, None, None


def pmean(x: torch.Tensor, mesh, axes: Axes,
          model_axis: str = "model") -> torch.Tensor:
    """Mean of ``x`` over the ranks of ``axes`` (``lax.pmean``).
    Backward under the module's convention: the cotangent summed over
    the data axes among ``axes`` (each holds a different share of the
    loss) and divided by the ranks of ``axes``; over ``model_axis`` the
    cotangent is the whole one already.  ``x`` must differ by rank along
    each axis it is averaged over: a value replicated over ``model``
    (equal on its ranks) takes the mean over the data axes alone."""
    return _PMean.apply(x, mesh, _axes(axes), model_axis)


__all__ = ["CommStats", "KINDS", "all_gather", "all_gather_grad", "all_to_all",
           "axes_size", "axis_index", "block", "broadcast", "copy_to",
           "gather_from", "linear_index", "pmax", "pmean", "psum",
           "psum_scatter", "reduce_from", "scatter_to"]
