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
of its layer group, so a step writes one slot and copies nothing.
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
    if (qpos.shape != (s,) or kpos.shape != (k.shape[1],) or s != k.shape[1]
            or not torch.equal(qpos, ar) or not torch.equal(kpos, ar)):
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


# ----------------------------------------------------------------------
# KV cache helpers (ring buffer for windowed layers, linear for global).
# ----------------------------------------------------------------------

def cache_update(k_cache, v_cache, kpos_cache, k_new, v_new, pos: int):
    """Write one decode step's K/V at ring slot ``pos % cache_len``, in
    place, and return the three caches.

    k_cache:(B,S,kv,hd)  k_new:(B,1,kv,hd)  pos: the global token
    position (a python int).  Global layers size the cache at max-seq
    so the ring never wraps; local layers size it at the window.
    kpos_cache (B,S) tracks which token occupies each slot (-1 = empty).
    """
    slot = int(pos) % k_cache.shape[1]
    k_cache[:, slot:slot + 1] = k_new.to(k_cache.dtype)
    v_cache[:, slot:slot + 1] = v_new.to(v_cache.dtype)
    kpos_cache[:, slot] = int(pos)
    return k_cache, v_cache, kpos_cache


def cache_from_prefill(k, v, kpos, cache_len: int):
    """Convert prefill K/V (..., B, S, kv, hd) + positions (S,) into a
    ring cache of ``cache_len`` slots laid out by ``token % cache_len``;
    kpos comes back as (..., B, cache_len)."""
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
        return k_c, v_c, kp.expand(lead + (cache_len,)).contiguous()
    shift = s % cache_len
    k_c = torch.roll(k[..., s - cache_len:, :, :], shift, dims=seq)
    v_c = torch.roll(v[..., s - cache_len:, :, :], shift, dims=seq)
    p_c = torch.roll(kpos[s - cache_len:], shift, dims=0)
    return k_c, v_c, p_c.expand(lead + (cache_len,)).contiguous()
