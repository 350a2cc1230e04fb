"""Compression baselines the paper compares against (§3.4).

* Full Embedding (FE)       — the conventional (n, d) table.
* Low-rank Factorization    — (n, r) @ (r, d).
* Scalar Quantization (SQ)  — post-training per-dim uniform quantization.
* Hashing trick             — ids hashed into a smaller table (Weinberger
  et al. 2009; cited as [15] in the paper's intro).

Every init draws its tables from the generator and scales them in
place, so the peak is one table.  None of them runs a kernel.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.dpq import row_gather
from repro_torch.core.types import EmbeddingConfig


def _zero(device) -> torch.Tensor:
    """Aux-loss placeholder of the schemes that have no aux loss."""
    return torch.zeros((), dtype=torch.float32, device=device)


def _randn(gen: torch.Generator, shape, scale: float,
           dtype) -> torch.Tensor:
    t = torch.randn(shape, generator=gen, dtype=dtype, device=gen.device)
    return t.mul_(scale)


# ---------------------------------------------------------------- full
def full_init(gen: torch.Generator, cfg: EmbeddingConfig,
              dtype=torch.float32) -> dict:
    """The (n, d) table, scaled in place (the peak is one table)."""
    return {"emb": _randn(gen, (cfg.vocab_size, cfg.dim), cfg.dim ** -0.5,
                          dtype)}


def full_lookup(params: dict, ids: torch.Tensor, cfg: EmbeddingConfig,
                mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training-path lookup of the full table: (rows, zero aux); under a
    ``mesh``, as the table's placement left this rank."""
    rows = row_gather(params["emb"], ids, mesh=mesh, rows=cfg.vocab_size)
    return rows, _zero(rows.device)


# ----------------------------------------------------------------- lrf
def lrf_init(gen: torch.Generator, cfg: EmbeddingConfig,
             dtype=torch.float32) -> dict:
    """u (n, r) then v (r, d), each scaled in place."""
    u = _randn(gen, (cfg.vocab_size, cfg.rank), cfg.rank ** -0.5, dtype)
    v = _randn(gen, (cfg.rank, cfg.dim), cfg.dim ** -0.5, dtype)
    return {"u": u, "v": v}


def lrf_lookup(params: dict, ids: torch.Tensor, cfg: EmbeddingConfig,
               mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows ``u[ids] @ v``, shape ids.shape + (d,), and a zero aux; under
    a ``mesh``, ``u`` as its placement left this rank."""
    rows = row_gather(params["u"], ids, mesh=mesh, rows=cfg.vocab_size)
    out = rows @ params["v"]
    return out, _zero(out.device)


def lrf_serving_lookup(artifact: dict, ids: torch.Tensor,
                       cfg: EmbeddingConfig) -> torch.Tensor:
    """Served rows ``u[ids] @ v``, each independent of the batch.

    A matmul picks its kernel, and with it its summation order, by
    shape, so a row would round one way at B = 1 and another at B =
    4,096: the hot-row cache decodes its block at B = ``hot_rows`` and
    flushes at any B.  Here the rank sum runs in a fixed order instead:
    every product ``u[i, k] * v[k, e]`` in one elementwise op (float32,
    exact for bfloat16 inputs), then the rank steps added one at a time,
    each add its own elementwise op (no fused multiply-add on either
    device), and the sum cast to the table's dtype.  The training
    forward (:func:`lrf_lookup`) keeps its matmul."""
    v = artifact["v"]
    rows = row_gather(artifact["u"], ids).float()          # (..., r)
    prod = rows[..., :, None] * v.float()                   # (..., r, d)
    out = prod[..., 0, :]
    for k in range(1, v.shape[0]):
        out = out + prod[..., k, :]
    return out.to(v.dtype)


# ------------------------------------------------------------------ sq
# SQ trains exactly like FE; quantization happens at export time.
sq_init = full_init
sq_lookup = full_lookup


def sq_export(params: dict, cfg: EmbeddingConfig) -> dict:
    """Per-dimension uniform quantization of the whole table: codes
    ``q`` (uint8 up to 8 bits, else int32) and float32 ``lo``/``scale``.
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    emb = params["emb"].float()
    lo = torch.amin(emb, dim=0)                    # (d,)
    hi = torch.amax(emb, dim=0)
    buckets = (1 << cfg.sq_bits) - 1
    scale = torch.where(hi > lo, (hi - lo) / buckets,
                        torch.ones_like(hi))
    qd = torch.uint8 if cfg.sq_bits <= 8 else torch.int32
    q = torch.round((emb - lo[None, :]) / scale[None, :]).to(qd)
    return {"q": q, "lo": lo, "scale": scale}


def sq_serving_lookup(artifact: dict, ids: torch.Tensor,
                      cfg: EmbeddingConfig) -> torch.Tensor:
    """Dequantized rows ``q[ids] * scale + lo`` in float32."""
    rows = row_gather(artifact["q"], ids).float()
    return rows * artifact["scale"] + artifact["lo"]


# ---------------------------------------------------------------- hash
def hash_init(gen: torch.Generator, cfg: EmbeddingConfig,
              dtype=torch.float32) -> dict:
    """The (buckets, d) table, scaled in place."""
    return {"emb": _randn(gen, (cfg.hash_buckets, cfg.dim),
                          cfg.dim ** -0.5, dtype)}


def hash_ids(ids: torch.Tensor, buckets: int) -> torch.Tensor:
    """Knuth multiplicative hash, bucket = (uint32(id) * 2654435761 mod
    2^32) mod buckets: the JAX package's uint32 arithmetic, emulated in
    int64 (the low 32 bits of the product survive any wraparound)."""
    h = ((ids.long() & 0xFFFFFFFF) * 2654435761) & 0xFFFFFFFF
    return h % buckets


def hash_lookup(params: dict, ids: torch.Tensor, cfg: EmbeddingConfig,
                mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows of the hashed ids, and a zero aux; under a ``mesh``, the
    bucket table as its placement left this rank."""
    rows = row_gather(params["emb"], hash_ids(ids, cfg.hash_buckets),
                      mesh=mesh, rows=cfg.hash_buckets)
    return rows, _zero(rows.device)
