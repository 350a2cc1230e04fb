"""The data-shard index shared by the sharded serving bodies.

``row_gather(sharded=True)`` — the training path's model-parallel row
gather with its batch-sized backward — is the training half of the
distributed layer and still raises (``core/dpq.py``).
"""
from __future__ import annotations

from typing import Sequence


def data_shard_index(mesh, data_axes: Sequence[str]) -> int:
    """Linearised index of this rank's data shard over ``data_axes`` (in
    mesh order): the body helper shared by the quantized gather
    (``sharding/quantized.py``) and the sharded top-k
    (``retrieval/sharded.py``), so their batch-slice arithmetic is one
    implementation."""
    idx = 0
    for a in data_axes:
        idx = idx * mesh.shape[a] + mesh.axis_index(a)
    return idx


def data_axes_of(mesh, model_axis: str) -> tuple:
    """The mesh's axes other than ``model_axis``, in mesh order."""
    return tuple(a for a in mesh.axis_names if a != model_axis)


def data_shards(mesh, model_axis: str) -> int:
    """Ranks along the data axes: the batch's shard count."""
    n = 1
    for a in data_axes_of(mesh, model_axis):
        n *= mesh.shape[a]
    return n


__all__ = ["data_axes_of", "data_shard_index", "data_shards"]
