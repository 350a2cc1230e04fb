"""Grouped-query attention: dense, chunked (the flash_attention kernel)
and cached-decode paths; sliding windows are per-layer scalars, so
local and global layers share one layer function.

Shapes:
    q:     (B, Sq, n_q, hd)
    k, v:  (B, Skv, n_kv, hd)      n_q = n_kv * group
    out:   (B, Sq, n_q, hd)

Masking model: every query/key carries an integer position.  A key is
visible iff ``0 <= qpos - kpos < window`` (causal + window in one
predicate; window = FULL_WINDOW for global layers) and ``kpos >= 0``
(ring-buffer slots that haven't been written yet carry kpos = -1).

The decode-cache helpers update the caches in place (the JAX package
returns new arrays): a layer's cache is a view into the stacked cache
of its layer group, so a step writes one slot and copies nothing.  On
a mesh whose ``model`` axis splits the cache's sequence
(``sharding/rules.py::lm_cache_spec``), each rank holds a block of the
slots: :func:`decode_attention_split` merges the blocks' partial
softmax statistics over the axis.  A batch that does not divide over
the data axes (``long_500k``, B = 1) splits the sequence over the data
axes instead, its ``kpos`` with it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import attend

# "infinite" window sentinel — bigger than any sequence we lower
FULL_WINDOW = 2 ** 30

_NEG_INF = -1e30


def _split_heads(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B, S, n_q, hd) -> (B, S, n_kv, g, hd)."""
    b, s, n_q, hd = q.shape
    return q.reshape(b, s, n_kv, n_q // n_kv, hd)


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, window) -> torch.Tensor:
    """Boolean (…, Sq, Skv) visibility mask."""
    delta = qpos[..., :, None] - kpos[..., None, :]
    return (delta >= 0) & (delta < window) & (kpos[..., None, :] >= 0)


# ----------------------------------------------------------------------
# Dense path: materializes (Sq, Skv) scores.  Fine for short sequences.
# ----------------------------------------------------------------------

def dense_attention(q, k, v, qpos, kpos, window=FULL_WINDOW) -> torch.Tensor:
    n_kv = k.shape[2]
    qg = _split_heads(q, n_kv)                          # (B,Sq,kv,g,hd)
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() * scale
    mask = _mask(qpos, kpos, window)                    # (Sq,Skv)
    scores = scores.masked_fill(~mask[None, None, None], _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(q.shape)


# ----------------------------------------------------------------------
# Chunked path: the flash_attention kernel (online softmax over KV
# tiles) — the JAX package's lax.scan over KV blocks, on the card.
# ----------------------------------------------------------------------

def chunked_attention(q, k, v, qpos, kpos, window=FULL_WINDOW,
                      block: int = 1024) -> torch.Tensor:
    """The JAX package's signature.  Positions must be the indices
    (``qpos == kpos == arange(S)``), the only way the model calls it:
    the kernel masks by index.  ``block`` (the JAX scan's KV chunk) is
    not read: the kernel's tiles are its own."""
    s = q.shape[1]
    ar = torch.arange(s, dtype=qpos.dtype, device=qpos.device)
    # values on the meta device (a dry run) cannot be read: shapes alone
    values = qpos.device.type != "meta"
    if (qpos.shape != (s,) or kpos.shape != (k.shape[1],) or s != k.shape[1]
            or values and not (torch.equal(qpos, ar)
                               and torch.equal(kpos, ar))):
        raise ValueError("chunked_attention takes positions equal to "
                         "arange(S) for both queries and keys (the "
                         "kernel masks by index); use dense_attention "
                         "for other positions")
    return attend(q, k, v, int(window))


# ----------------------------------------------------------------------
# Decode path: single query token against a cache.
# ----------------------------------------------------------------------

def decode_attention(q, k_cache, v_cache, kpos, window=FULL_WINDOW
                     ) -> torch.Tensor:
    """q: (B, 1, n_q, hd); caches (B, S, n_kv, hd); kpos (B, S) or (S,)."""
    n_kv = k_cache.shape[2]
    qg = _split_heads(q, n_kv)[:, 0]                    # (B,kv,g,hd)
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache).float() * scale
    if kpos.dim() == 1:
        kpos = kpos[None]
    qpos = torch.amax(kpos, dim=-1)                     # newest written token
    delta = qpos[:, None] - kpos                        # (B, S)
    mask = (delta >= 0) & (delta < window) & (kpos >= 0)
    s = s.masked_fill(~mask[:, None, None, :], _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(q.shape).to(q.dtype)


def decode_attention_split(q, k_block, v_block, kpos, window, mesh,
                           axis="model", qpos=None) -> torch.Tensor:
    """:func:`decode_attention` over a cache whose sequence is split over
    ``axis`` (one axis or several, in mesh order): this rank holds the
    slots ``[i·S/n, (i+1)·S/n)`` of every kv head it caches (``k_block``,
    ``v_block`` (B, S/n, n_kv, hd)) and ``kpos`` whole (B, S) or its block
    (B, S/n) alike; ``q`` (B, 1, n_q, hd) holds the query heads of those
    kv heads, and so does the output.  ``qpos``, the newest written
    position, is read from ``kpos`` when not given (a block of ``kpos``
    needs it given).

    Each rank scores its block and returns partial statistics — the row
    max, the sum of the exponentials and the unnormalised output, in
    float32 — merged over ``axis``: the max by a ``pmax`` first, then
    the sums and the outputs, shifted by it, in one ``psum``."""
    from repro_torch.sharding import collectives as coll
    n_kv = k_block.shape[2]
    s_loc = k_block.shape[1]
    qg = _split_heads(q, n_kv)[:, 0]                    # (B,kv,g,hd)
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_block).float() * scale
    if kpos.dim() == 1:
        kpos = kpos[None]
    if qpos is None:
        qpos = torch.amax(kpos, dim=-1)                 # newest written token
    else:
        qpos = torch.full((kpos.shape[0],), int(qpos), dtype=kpos.dtype,
                          device=kpos.device)
    if kpos.shape[-1] == s_loc:
        kp = kpos
    else:
        start = coll.linear_index(mesh, axis) * s_loc
        kp = kpos[:, start:start + s_loc]
    delta = qpos[:, None] - kp
    mask = (delta >= 0) & (delta < window) & (kp >= 0)
    s = s.masked_fill(~mask[:, None, None, :], _NEG_INF)
    top = coll.pmax(torch.amax(s, dim=-1), mesh, axis)  # (B,kv,g)
    p = torch.exp(s - top[..., None])
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_block.float())
    merged = coll.psum(torch.cat([o, p.sum(-1)[..., None]], dim=-1), mesh,
                       axis)
    out = merged[..., :-1] / merged[..., -1:]
    return out.reshape(q.shape).to(q.dtype)


# ----------------------------------------------------------------------
# KV cache helpers (ring buffer for windowed layers, linear for global).
# ----------------------------------------------------------------------

def cache_update(k_cache, v_cache, kpos_cache, k_new, v_new, pos: int,
                 mesh=None, axis="model", cache_len=None):
    """Write one decode step's K/V at ring slot ``pos % cache_len``, in
    place, and return the three caches.

    k_cache:(B,S,kv,hd)  k_new:(B,1,kv,hd)  pos: the global token
    position (a python int).  Global layers size the cache at max-seq
    so the ring never wraps; local layers size it at the window.
    kpos_cache (B,S) tracks which token occupies each slot (-1 = empty).

    A cache whose sequence is split over ``axis`` of ``mesh`` (one axis or
    several; ``k_cache`` this rank's block of S/n slots): the K/V go only
    to the rank that owns the slot; the position to every rank where
    ``kpos_cache`` is whole, to the owner alone where it is a block too.
    ``cache_len`` is the whole cache's slots (default: ``kpos_cache``'s,
    whole)."""
    cache_len = cache_len or kpos_cache.shape[-1]
    slot = int(pos) % cache_len
    s_loc = k_cache.shape[1]
    if kpos_cache.shape[-1] == cache_len:
        kpos_cache[:, slot] = int(pos)
    if s_loc != cache_len:
        from repro_torch.sharding.collectives import linear_index
        mine = linear_index(mesh, axis)
        if slot // s_loc != mine:
            return k_cache, v_cache, kpos_cache
        slot -= mine * s_loc
    if kpos_cache.shape[-1] != cache_len:
        kpos_cache[:, slot] = int(pos)
    k_cache[:, slot:slot + 1] = k_new.to(k_cache.dtype)
    v_cache[:, slot:slot + 1] = v_new.to(v_cache.dtype)
    return k_cache, v_cache, kpos_cache


def cache_from_prefill(k, v, kpos, cache_len: int, seq_block=None):
    """Convert prefill K/V (..., B, S, kv, hd) + positions (S,) into a
    ring cache of ``cache_len`` slots laid out by ``token % cache_len``;
    kpos comes back as (..., B, cache_len).

    ``seq_block`` (i, n): the K/V of the slots ``[i·L/n, (i+1)·L/n)``
    alone (L = ``cache_len``), the block of a cache whose sequence is
    split n ways (``sharding/rules.py::lm_cache_spec``); kpos whole."""
    s = k.shape[-3]
    seq = k.dim() - 3
    lead = k.shape[:-3]
    if s <= cache_len:
        pad = cache_len - s
        shape = list(k.shape)
        shape[seq] = pad
        k_c = torch.cat([k, k.new_zeros(shape)], dim=seq)
        v_c = torch.cat([v, v.new_zeros(shape)], dim=seq)
        kp = torch.cat([kpos, kpos.new_full((pad,), -1)])
        # slot of token t is t % cache_len == t while s <= cache_len
    else:
        shift = s % cache_len
        k_c = torch.roll(k[..., s - cache_len:, :, :], shift, dims=seq)
        v_c = torch.roll(v[..., s - cache_len:, :, :], shift, dims=seq)
        kp = torch.roll(kpos[s - cache_len:], shift, dims=0)
    if seq_block is not None:
        i, n = seq_block
        if cache_len % n:
            raise ValueError(f"a cache of {cache_len} slots does not split "
                             f"into {n} blocks of the sequence")
        size = cache_len // n
        k_c = k_c.narrow(seq, i * size, size).contiguous()
        v_c = v_c.narrow(seq, i * size, size).contiguous()
    return k_c, v_c, kp.expand(lead + (cache_len,)).contiguous()
