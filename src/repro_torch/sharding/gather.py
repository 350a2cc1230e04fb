"""The model-parallel embedding row gather, and the data-shard index
shared by the sharded bodies.

A table row-sharded over ``model`` read by a data-sharded batch: each
rank holds its block of ``rows / model_n`` rows and its shard of the
ids.  :func:`row_gather` keeps every collective proportional to the
batch, as the JAX package's ``shard_map`` gather does:

  forward:  all-gather the ids over data -> each rank gathers the rows
            its block owns (zeros elsewhere) -> psum over model of the
            (B_global, d) partials -> this data shard's slice.
  backward: all-gather the output's cotangent over data -> scatter-add
            it into a (rows_local, d) zeros, locally.  No table-sized
            collective: the block's gradient comes out whole on every
            rank of its model line.

:func:`placed_row_gather` reads a table as its placement left it: a
whole table plainly, a row block through :func:`row_gather`; the
placement decides, not a config flag (``sharding/rules.py``).
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.sharding.collectives import (all_gather, linear_index,
                                              psum)


def data_shard_index(mesh, data_axes: Sequence[str]) -> int:
    """Linearised index of this rank's data shard over ``data_axes`` (in
    mesh order): the body helper shared by the row gather, the quantized
    gather (``sharding/quantized.py``) and the sharded top-k
    (``retrieval/sharded.py``), so their batch-slice arithmetic is one
    implementation."""
    return linear_index(mesh, data_axes)


def data_axes_of(mesh, model_axis: str) -> tuple:
    """The mesh's axes other than ``model_axis``, in mesh order."""
    return tuple(a for a in mesh.axis_names if a != model_axis)


def data_shards(mesh, model_axis: str) -> int:
    """Ranks along the data axes: the batch's shard count."""
    n = 1
    for a in data_axes_of(mesh, model_axis):
        n *= mesh.shape[a]
    return n


def _local_ids(ids_all: torch.Tensor, mesh, model_axis: str,
               rows_local: int):
    """The global ids as rows of this rank's block, clipped, and which
    of them the block owns."""
    local = ids_all.long() - mesh.axis_index(model_axis) * rows_local
    hit = (local >= 0) & (local < rows_local)
    return local.clamp(0, rows_local - 1), hit


class _RowGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, mesh, model_axis):
        data_axes = data_axes_of(mesh, model_axis)
        flat = ids.reshape(-1)
        ids_all = all_gather(flat, mesh, data_axes)
        local, hit = _local_ids(ids_all, mesh, model_axis, table.shape[0])
        rows = table[local] * hit[:, None].to(table.dtype)
        full = psum(rows, mesh, model_axis)              # (B_global, d)
        i, b = data_shard_index(mesh, data_axes), flat.shape[0]
        ctx.save_for_backward(local, hit)
        ctx.mesh, ctx.data_axes, ctx.rows_local = mesh, data_axes, \
            table.shape[0]
        return full[i * b:(i + 1) * b]

    @staticmethod
    def backward(ctx, dout):
        local, hit = ctx.saved_tensors
        dout = all_gather(dout.contiguous(), ctx.mesh, ctx.data_axes)
        dt = torch.zeros((ctx.rows_local, dout.shape[1]), dtype=dout.dtype,
                         device=dout.device)
        # the ordered accumulate (sorted on the card), never
        # ``index_add_``, whose atomic adds give other bits on a rerun
        dt.index_put_((local,), dout * hit[:, None].to(dout.dtype),
                      accumulate=True)
        return dt, None, None, None


def row_gather(table: torch.Tensor, ids: torch.Tensor, mesh,
               model_axis: str = "model", rows=None) -> torch.Tensor:
    """Rows of the global ``ids`` (this rank's data shard of them) from a
    table of ``rows`` rows (default: ``table``'s times ``model_n``)
    row-sharded over ``model_axis``, of which ``table`` is this rank's
    block; shape ``ids.shape + (d,)``.  Differentiable in ``table``,
    with the batch-sized backward of the module docstring.  Every rank
    of the mesh calls it in the same order with as many ids as its data
    peers.  Rows that do not divide over ``model_axis``, or a block of
    the wrong size, raise: the JAX package reads such a table with a
    plain ``take`` of the whole, which a placed block cannot give."""
    model_n = mesh.shape[model_axis]
    rows = table.shape[0] * model_n if rows is None else rows
    if rows % model_n or table.shape[0] * model_n != rows:
        raise ValueError(
            f"a table of {rows} rows does not row-shard over "
            f"{model_axis}={model_n} into blocks of {table.shape[0]}")
    out = _RowGather.apply(table, ids, mesh, model_axis)
    return out.reshape(tuple(ids.shape) + (table.shape[1],))


def placed_row_gather(table: torch.Tensor, ids: torch.Tensor, mesh,
                      rows: int, model_axis: str = "model"
                      ) -> torch.Tensor:
    """``table[ids]`` for a table of ``rows`` global rows as its
    placement over ``mesh`` left this rank: a whole table (placed
    replicated) is read plainly, a row block through :func:`row_gather`.
    A block that is not one of ``model_axis``'s raises; a placed block
    is never read plainly."""
    if table.shape[0] == rows:
        return table[ids.long()]
    return row_gather(table, ids, mesh, model_axis, rows=rows)


def batch_mean(x: torch.Tensor, mesh, model_axis: str = "model"
               ) -> torch.Tensor:
    """Mean of ``x`` over the global batch, of which this rank holds its
    data shard: the local sum, summed over the data axes, over the
    global count.  Equal to the single-device mean where the sums are
    exact (a mask's)."""
    data_axes = data_axes_of(mesh, model_axis)
    total = psum(torch.sum(x), mesh, data_axes)
    return total / (x.numel() * data_shards(mesh, model_axis))


__all__ = ["batch_mean", "data_axes_of", "data_shard_index", "data_shards",
           "placed_row_gather", "row_gather"]
