"""Differentiable Product Quantization (DPQ) — VQ variant (paper §1.1).

Training keeps a full embedding table ``emb`` of shape (n, d).  Each row
is viewed as D subvectors of dim S = d/D.  Per subspace there are K
learnable centroids; each subvector snaps to its nearest centroid
(argmin over L2 distance).  At serving time the full table is
discarded; only the integer codes and the centroid tables remain.

Ported: initialisation, the nearest-centroid assignment, the
straight-through forward (``quantize``, ``lookup_train``; the plain
assignment, as in the JAX package) and its backward, the row gather
(plain, or model-parallel under a mesh), code export over the whole
vocabulary (the ``dpq_assign`` op) and the serving lookup (the
``mgqe_decode`` op).

MGQE (mgqe.py) reuses every function here via the ``k_limit`` argument:
items restricted to the first K_i centroids mask distance slots
k >= K_i to +inf before the argmin.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.dpq_assign import assign
from repro_torch.kernels.mgqe_decode import decode


def init_centroids(gen: torch.Generator, num_subspaces: int,
                   num_centroids: int, subspace_dim: int, scale: float = 1.0,
                   dtype=torch.float32) -> torch.Tensor:
    """Centroid tables, shape (D, K, S), on the generator's device.
    Scaled in place: the peak is one table, not two."""
    cent = torch.randn((num_subspaces, num_centroids, subspace_dim),
                       generator=gen, dtype=dtype, device=gen.device)
    return cent.mul_(scale)


def init_full_table(gen: torch.Generator, vocab_size: int, dim: int,
                    scale: Optional[float] = None,
                    dtype=torch.float32) -> torch.Tensor:
    """(vocab, dim) table drawn from ``gen`` and scaled in place, so
    the peak is one table: two-tower's 50M-row user table is 51.2 GB,
    and a scaled copy beside it would not fit an 80 GB card."""
    if scale is None:
        scale = dim ** -0.5
    emb = torch.randn((vocab_size, dim), generator=gen, dtype=dtype,
                      device=gen.device)
    return emb.mul_(scale)


# ----------------------------------------------------------------------
# Quantization primitives (shape-polymorphic over leading batch dims).
# ----------------------------------------------------------------------

def subspace_distances(e_sub: torch.Tensor,
                       centroids: torch.Tensor) -> torch.Tensor:
    """Squared-L2 distances from subvectors to centroids.

    e_sub:     (..., D, S)
    centroids: (D, K, S)
    returns    (..., D, K)

    ||e - c||^2 = ||e||^2 - 2 e.c + ||c||^2; the ||e||^2 term is
    constant w.r.t. the argmin so it is dropped.
    """
    dots = torch.einsum("...ds,dks->...dk", e_sub, centroids)
    c_sq = torch.sum(torch.square(centroids), dim=-1)     # (D, K)
    return c_sq - 2.0 * dots


def assign_codes(e_sub: torch.Tensor, centroids: torch.Tensor,
                 k_limit: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Nearest-centroid codes, shape (..., D), int32.

    k_limit: optional per-item centroid budget (broadcastable to the
    leading dims of e_sub).  Slots k >= k_limit are masked to +inf —
    the MGQE shared-variable-K rule ("use only the first K_i
    centroids").  Ties go to the first index.
    """
    dist = subspace_distances(e_sub, centroids)
    if k_limit is not None:
        k = dist.shape[-1]
        slot = torch.arange(k, dtype=torch.int32, device=dist.device)
        lim = torch.broadcast_to(k_limit, dist.shape[:-2])[..., None, None]
        dist = dist.masked_fill(slot >= lim, float("inf"))
    return torch.argmin(dist, dim=-1).to(torch.int32)


def decode_codes(codes: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """codes (..., D) -> concatenated centroid vectors (..., D, S)."""
    d = centroids.shape[0]
    flat = codes.reshape(-1, d).long()        # widen: uint8 would mask
    sub = torch.arange(d, device=codes.device)[None, :]
    return centroids[sub, flat].reshape(codes.shape + (centroids.shape[-1],))


def quantize(e: torch.Tensor, centroids: torch.Tensor,
             k_limit: Optional[torch.Tensor] = None,
             beta: float = 0.25
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full DPQ forward for pre-gathered rows.

    e: (..., d) full-table rows;  centroids: (D, K, S) with D*S == d.
    Returns (quantized (..., d), codes (..., D), aux_loss scalar).
    """
    num_sub, _, sub_dim = centroids.shape
    lead = tuple(e.shape[:-1])
    e_sub = e.reshape(lead + (num_sub, sub_dim))
    codes = assign_codes(e_sub, centroids, k_limit)
    c_sel = decode_codes(codes, centroids)        # (..., D, S)
    # Straight-through: forward value is the centroid, gradient hits e.
    # Written as the JAX package writes it, so the forward value is
    # bit-identical to it wherever the codes agree.
    q_sub = e_sub + (c_sel - e_sub).detach()
    # Codebook + commitment losses (gradients: codebook term ->
    # centroids via the differentiable gather in c_sel; commitment -> e).
    codebook = torch.mean(torch.sum(
        torch.square(e_sub.detach() - c_sel), dim=-1))
    commit = torch.mean(torch.sum(
        torch.square(e_sub - c_sel.detach()), dim=-1))
    aux = codebook + beta * commit
    return q_sub.reshape(e.shape), codes, aux


def row_gather(table: torch.Tensor, ids: torch.Tensor, mesh=None,
               rows: Optional[int] = None) -> torch.Tensor:
    """Rows ``table[ids]``, shape ids.shape + (d,).

    With a ``mesh`` the table is read as its placement left this rank
    (``sharding/gather.py::placed_row_gather``): ``rows`` is its global
    row count, a whole table is read plainly and a row block over
    ``model`` through the model-parallel gather with its batch-sized
    backward.  The placement decides, not ``cfg.sharded_rows``: deepfm's
    dim-1 first-order tables carry no flag, yet the recsys rules place
    them row-sharded.

    Advanced indexing, not ``index_select``: its backward is a sorted
    ``index_put_`` with accumulate, which gives the same bits on every
    run, where ``index_select``'s (``index_add_``, atomic adds on the
    card) does not, and a resumed run would drift from an uninterrupted
    one."""
    if mesh is None:
        return table[ids.long()]
    if rows is None:
        raise ValueError("a row gather under a mesh needs the table's "
                         "global row count (rows=)")
    from repro_torch.sharding.gather import placed_row_gather
    return placed_row_gather(table, ids, mesh, rows)


def batch_fraction(mask: torch.Tensor, mesh=None) -> torch.Tensor:
    """The share of the batch's items that ``mask`` selects, as float32:
    over this rank's ids, or, under a ``mesh``, over the global batch
    (the per-tier weight of the private variants' aux loss, which is
    not a mean over items: a rank's share at the global weight makes
    the ranks' B_local/B_global-weighted sum the single-device loss)."""
    m = mask.to(torch.float32)
    if mesh is None:
        return torch.mean(m)
    from repro_torch.sharding.gather import batch_mean
    return batch_mean(m, mesh)


def lookup_train(params: dict, ids: torch.Tensor,
                 k_limit: Optional[torch.Tensor] = None,
                 beta: float = 0.25, mesh=None, rows: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training-path lookup: gather full rows, quantize, STE.

    ids: (...,) int, global ids (under a ``mesh``, this rank's data
    shard of them, and ``rows`` the table's global row count); returns
    (emb (..., d), aux_loss scalar: the mean over this rank's ids).
    """
    e = row_gather(params["emb"], ids, mesh=mesh, rows=rows)
    q, _, aux = quantize(e, params["centroids"], k_limit=k_limit, beta=beta)
    return q, aux


# ----------------------------------------------------------------------
# Table-level API used by the model layers.
# ----------------------------------------------------------------------

def init(gen: torch.Generator, vocab_size: int, dim: int, num_subspaces: int,
         num_centroids: int, dtype=torch.float32) -> dict:
    """Full table first, then centroids, both drawn from ``gen``."""
    emb = init_full_table(gen, vocab_size, dim, dtype=dtype)
    # Centroids init'd at the scale of the embeddings so early argmins
    # spread over the codebook rather than collapsing to one centroid.
    cent = init_centroids(gen, num_subspaces, num_centroids,
                          dim // num_subspaces, scale=dim ** -0.5,
                          dtype=dtype)
    return {"emb": emb, "centroids": cent}


def export_codes(params: dict, k_limit_per_row: Optional[torch.Tensor] = None,
                 batch: int = 65536,
                 backend: Optional[str] = None) -> torch.Tensor:
    """Materialize serving codes for the whole vocab, shape (n, D) int32.

    Batched over rows so exporting a 10M-row table never holds more
    than one batch of work at once.  The nearest-centroid search runs
    through the dispatched ``dpq_assign`` op (the CUDA kernel for a
    table on the card).
    """
    emb = params["emb"]
    centroids = params["centroids"]
    n = emb.shape[0]
    num_sub, _, sub_dim = centroids.shape
    outs = []
    for start in range(0, n, batch):
        rows = emb[start:start + batch]
        lim = None
        if k_limit_per_row is not None:
            lim = k_limit_per_row[start:start + batch]
        e_sub = rows.reshape(rows.shape[0], num_sub, sub_dim)
        outs.append(assign(e_sub, centroids, lim, backend=backend))
    return torch.cat(outs, dim=0)


def serving_lookup(codes_table: torch.Tensor, centroids: torch.Tensor,
                   ids: torch.Tensor, backend: Optional[str] = None,
                   block_b: Optional[int] = None) -> torch.Tensor:
    """Serving-path lookup: codes + centroids only (full table gone).

    The decode runs through the kernel dispatch layer: the CUDA
    ``mgqe_decode`` kernel for an artifact on the card, the plain
    version on the CPU.  ``backend``/``block_b`` usually come from
    ``EmbeddingConfig.kernel_backend`` / ``decode_block_b``; left as
    None, ``block_b`` resolves through the autotune cache.  Ids must
    lie in [0, vocab): on the card an out-of-range row index is a
    device-side fault.
    """
    # gather at the STORED dtype (uint8 for K<=256); the op widens the
    # codes itself — an int32 batch here quadruples gather traffic
    codes = codes_table.index_select(0, ids.reshape(-1))   # (N, D)
    flat = decode(codes, centroids, block_b=block_b, backend=backend)
    return flat.reshape(tuple(ids.shape)
                        + (centroids.shape[0] * centroids.shape[-1],))
