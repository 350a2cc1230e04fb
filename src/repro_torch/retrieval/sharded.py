"""Sharded batched top-k: distributed corpus rows, merged partials.

The O(corpus) artifact leaves (``Index.rows_leaves``: flat codes, the
IVF list tables) are row-sharded over the mesh's ``model`` axis, as
``sharding/quantized.py`` shards code tables; codebooks, the coarse
table and the chain map are replicated (``sharding/rules.py``).  On
every rank, as the JAX package's ``shard_map`` body:

  all-gather the queries over the data axes -> the index's OWN
  ``local_topk`` over this rank's rows (global ids, (B_global, k)
  partials) -> all-gather the partials over ``model`` -> two-key
  ``merge_topk`` -> this data shard's batch -> all-gathered over the
  data axes, so every rank returns the full result.

Wire bytes a search: O(B · k · model_n · 8) plus the queries, not the
corpus.  The merge equals the single-device search bit for bit: a
candidate's score does not depend on the shard it lies in, and
truncation to k under the total order (score desc, tiebreak asc) is
associative (``retrieval/topk.py``).

As in ``sharding/quantized.py``, the body keeps the JAX package's
data-sharded form, written for a per-rank query stream; under today's
replicated feed the data slice and its two gathers rebuild a batch
every rank already holds (ROADMAP §1 item 8 lists the one-collective
form as open).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.retrieval.topk import merge_topk
from repro_torch.sharding.collectives import all_gather, axis_index
from repro_torch.sharding.gather import (data_axes_of, data_shard_index,
                                         data_shards)


def sharded_topk(index, artifact: Dict, queries: torch.Tensor, k: int,
                 model_axis: str = "model", mesh=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed ``index.search``: queries (B, d), the same on every
    rank -> (scores (B, k), ids (B, k)) on every rank, over this rank's
    ``artifact`` (``shard_retrieval_artifact``).

    Single-device search with no mesh, a mesh of one rank or without
    ``model_axis``, one model shard, or an empty batch.  Odd batches
    are padded to the data-shard granularity.  (Rows that do not divide
    over ``model`` are refused at placement, so unlike the JAX package
    there is no whole-corpus route here.)"""
    if mesh is None or mesh.size == 1 or model_axis not in mesh.shape:
        return index.search(artifact, queries, k)
    if not index.supports_sharded:
        raise ValueError(
            f"index kind {index.kind!r} cannot be distributed")
    data_axes = data_axes_of(mesh, model_axis)
    model_n = mesh.shape[model_axis]
    data_n = data_shards(mesh, model_axis)
    b = queries.shape[0]
    if model_n == 1 or b == 0:
        return index.search(artifact, queries, k)
    pad = (-b) % data_n
    if pad:
        queries = F.pad(queries, (0, 0, 0, pad))
    b_local = (b + pad) // data_n
    idx = data_shard_index(mesh, data_axes)

    # --- the shard body
    q_all = queries[idx * b_local:(idx + 1) * b_local]
    if data_axes:
        q_all = all_gather(q_all, mesh, data_axes)
    s, tb, i = index.local_topk(artifact, q_all, k,
                                shard=axis_index(mesh, model_axis),
                                num_shards=model_n)      # (B_global, k)
    bg = s.shape[0]

    def cat(x):
        x_all = all_gather(x, mesh, model_axis, tiled=False)  # (n, B, k)
        return x_all.transpose(0, 1).reshape(bg, model_n * k)

    ms, mi = merge_topk(cat(s), cat(i), k, tiebreak=cat(tb))
    ms = ms[idx * b_local:(idx + 1) * b_local]
    mi = mi[idx * b_local:(idx + 1) * b_local]
    # --- the data-sharded result, read whole on every rank
    if data_axes:
        ms, mi = (all_gather(x, mesh, data_axes) for x in (ms, mi))
    return ms[:b], mi[:b]


__all__ = ["sharded_topk"]
