"""Sharded quantized-table serving: distributed codes, replicated
codebooks.

After export only integer codes ``(n, D)`` and small centroid tables
remain (paper §2, Fig. 1).  The codes are still O(vocab), so they are
row-sharded over the mesh's ``model`` axis while the codebooks (KBs)
are replicated on every rank (``sharding/rules.py``).  The lookup
follows the JAX package's ``shard_map`` body, on every rank:

  all-gather the ids over the data axes (KBs) -> decode the rows this
  rank holds through the scheme's own decode (the dispatched kernel:
  ``mgqe_decode``, ``rq_decode_stages`` or ``packed_decode``), zeros
  elsewhere -> psum over ``model`` of the (B_global, d) partials ->
  this data shard's batch -> all-gathered over the data axes.

Every rank passes the same global ids and gets the same full rows,
as the JAX package's caller gets the global array (the last gather is
the one JAX makes when the data-sharded result is read whole).  An
LM's tokens differ by data rank (``models/lm.py`` served on a mesh):
``per_rank=True`` takes each rank's own ids and returns its own rows,
the ids gathered over the data axes and the rows kept as one psum over
``model`` leaves them.  Wire
bytes a lookup: O(B_global · d · 4), independent of the vocabulary.

The body keeps the JAX package's data-sharded form, in which each data
shard's batch is that rank's own input: the form a per-rank request
stream needs.  Under today's replicated feed the data slice and its two
gathers rebuild a batch every rank already holds, so a flush makes two
collectives more than the psum alone (ROADMAP §1 item 8 lists the
one-collective form as open).
Exactly one rank holds each id's row, so the psum adds zeros to it:
the rows equal the single-device decode (a -0.0 may come back +0.0).
No backward: codes are a frozen export artifact.

Which schemes shard, the placement and the per-shard decode all come
from the scheme registry (``supports_sharded_codes``,
``artifact_shard_specs``, ``QuantizedScheme.decode``).
"""
from __future__ import annotations

import math
import torch
import torch.nn.functional as F

from repro_torch.core.schemes import get_scheme, registered_kinds, scheme_class
from repro_torch.sharding.collectives import all_gather, axis_index, psum
from repro_torch.sharding.gather import (data_axes_of, data_shard_index,
                                         data_shards)


def supports_sharding(kind: str, variant: str = "-") -> bool:
    """True when :func:`quantized_gather` can distribute this scheme's
    codes."""
    del variant  # every variant of a shardable scheme is supported
    try:
        cls = scheme_class(kind)
    except KeyError:
        return False
    return cls.supports_sharded_codes


def sharded_variants():
    """(kind, variant) pairs the sharded gather supports, from the
    scheme registry."""
    return [(kind, v)
            for kind in registered_kinds()
            if supports_sharding(kind)
            for v in scheme_class(kind).variants()]


def _codes_rows(artifact: dict) -> int:
    """Vocab row count of the (possibly per-tier list of) code tables."""
    codes = artifact["codes"]
    if isinstance(codes, (list, tuple)):
        ns = {c.shape[0] for c in codes}
        if len(ns) != 1:
            raise ValueError(
                f"per-tier code tables disagree on vocab rows: {sorted(ns)}")
        return ns.pop()
    return codes.shape[0]


def quantized_gather(artifact: dict, ids: torch.Tensor, cfg,
                     model_axis: str = "model", mesh=None,
                     per_rank: bool = False) -> torch.Tensor:
    """Sharded serving decode: ``ids`` (any shape, the same on every
    rank) -> rows ``ids.shape + (d,)`` on every rank, over this rank's
    ``artifact`` (``shard_quantized_artifact``).

    ``per_rank``: ``ids`` are this rank's own (an LM's tokens: they differ
    over the data axes, the same shape everywhere and the same on the
    ranks of a model line), and so are the rows: the ids all-gathered
    over the data axes, this rank's code block decoded, a psum over
    ``model``, this data shard's rows kept (two collectives).

    Single-device decode — the JAX package's fallback — with no mesh, a
    mesh of one rank or without ``model_axis``, one model shard, an
    empty batch, or a vocabulary that does not divide (whose artifact
    placement kept whole).  Odd batches are padded to the data-shard
    granularity with id 0 instead."""
    scheme = get_scheme(cfg)
    if not scheme.supports_sharded_codes:
        raise ValueError(f"cannot shard codes of kind={cfg.kind!r}")
    if mesh is None or mesh.size == 1 or model_axis not in mesh.shape:
        return scheme.decode(artifact, ids)
    data_axes = data_axes_of(mesh, model_axis)
    model_n = mesh.shape[model_axis]
    data_n = data_shards(mesh, model_axis)
    v = cfg.vocab_size
    lead = tuple(ids.shape)
    flat = math.prod(lead)
    if model_n == 1 or v % model_n or flat == 0:
        return scheme.decode(artifact, ids)
    rows_local = v // model_n
    if _codes_rows(artifact) != rows_local:
        raise ValueError(f"artifact holds {_codes_rows(artifact)} code rows,"
                         f" not this rank's block of {rows_local} (place "
                         f"it with shard_quantized_artifact)")
    if per_rank:
        return _per_rank_gather(artifact, ids, cfg, scheme, mesh, model_axis,
                                data_axes, rows_local)
    # pad the flat batch to the data-shard granularity (id 0 is always
    # valid), so odd request sizes keep the O(B·d) wire path
    flat_ids = ids.reshape(-1)
    pad = (-flat) % data_n
    if pad:
        flat_ids = F.pad(flat_ids, (0, pad))
    b_local = (flat + pad) // data_n
    idx = data_shard_index(mesh, data_axes)

    # --- the shard body
    ids_all = flat_ids[idx * b_local:(idx + 1) * b_local]
    if data_axes:
        ids_all = all_gather(ids_all, mesh, data_axes)
    full = psum(_local_decode(artifact, ids_all, scheme, mesh, model_axis,
                              rows_local), mesh, model_axis)
    out = full[idx * b_local:(idx + 1) * b_local]
    # --- the data-sharded result, read whole on every rank
    if data_axes:
        out = all_gather(out, mesh, data_axes)
    return out[:flat].reshape(lead + (cfg.dim,))


def _local_decode(artifact, ids_all, scheme, mesh, model_axis, rows_local):
    """The rows of ``ids_all`` (global ids) this rank's code block holds,
    zeros elsewhere."""
    local = ids_all - axis_index(mesh, model_axis) * rows_local
    hit = (local >= 0) & (local < rows_local)
    local = local.clamp(0, rows_local - 1)
    # decode against the LOCAL code block; frequency-tiered blending
    # (mgqe's private variants, mpe) keys on the GLOBAL id
    # block_b=None: the decode op's Tunable picks the block, since the
    # all-gathered batch is not the shape cfg.decode_block_b was pinned to
    rows = scheme.decode(artifact, local, tier_ids=ids_all, block_b=None)
    return rows.masked_fill(~hit[:, None], 0)


def _per_rank_gather(artifact, ids, cfg, scheme, mesh, model_axis,
                     data_axes, rows_local) -> torch.Tensor:
    """:func:`quantized_gather`'s ``per_rank`` body."""
    flat = ids.reshape(-1)
    ids_all = all_gather(flat, mesh, data_axes) if data_axes else flat
    full = psum(_local_decode(artifact, ids_all, scheme, mesh, model_axis,
                              rows_local), mesh, model_axis)
    idx = data_shard_index(mesh, data_axes)
    out = full[idx * flat.numel():(idx + 1) * flat.numel()]
    return out.reshape(tuple(ids.shape) + (cfg.dim,))


__all__ = ["quantized_gather", "sharded_variants", "supports_sharding"]
