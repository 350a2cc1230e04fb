"""Bit-packing for sub-byte quantization codes.

A code table (..., D) whose entries fit in ``bits`` ∈ {2, 4, 8} bits is
stored as packed bytes (..., W) with ``W = ceil(D / (8 // bits))`` —
``8 // bits`` codes per byte, little-endian within the byte (code j of
a byte occupies bits ``[j*bits, (j+1)*bits)``), trailing pad codes
zero.  The bytes are identical to the JAX package's ``pack_codes``.

The shifts run in int32 on any device (torch's unsigned 32-bit type has
few operators); ``pack_codes`` runs once at export, and
``unpack_codes`` is the plain unpack — the serving path never
materializes it, the ``packed_decode`` kernel unpacks in registers.
"""
from __future__ import annotations

import torch

PACK_BITS = (2, 4, 8)


def packed_width(num_codes: int, bits: int) -> int:
    """Bytes needed to pack ``num_codes`` codes of ``bits`` bits each."""
    if bits not in PACK_BITS:
        raise ValueError(f"bits must be one of {PACK_BITS}, got {bits}")
    per_byte = 8 // bits
    return -(-num_codes // per_byte)


def _shifts(per_byte: int, bits: int, ndim: int, device) -> torch.Tensor:
    return (torch.arange(per_byte, dtype=torch.int32, device=device)
            * bits).reshape((1,) * ndim + (per_byte,))


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """codes (..., D) int, values < 2**bits -> packed (..., W) uint8.

    Each code is first cut to its low byte, as a cast to uint8 does."""
    per_byte = 8 // bits
    d = codes.shape[-1]
    w = packed_width(d, bits)
    c = codes.to(torch.int32) & 0xFF
    pad = w * per_byte - d
    if pad:
        c = torch.nn.functional.pad(c, (0, pad))
    c = c.reshape(tuple(c.shape[:-1]) + (w, per_byte))
    word = torch.sum(c << _shifts(per_byte, bits, c.dim() - 1, c.device),
                     dim=-1, dtype=torch.int32)
    return (word & 0xFF).to(torch.uint8)


def unpack_codes(packed: torch.Tensor, bits: int,
                 num_codes: int) -> torch.Tensor:
    """packed (..., W) uint8 -> codes (..., num_codes) uint8.

    Inverse of :func:`pack_codes`; trailing pad codes are dropped."""
    per_byte = 8 // bits
    w = packed.shape[-1]
    if w != packed_width(num_codes, bits):
        raise ValueError(
            f"packed width {w} does not hold {num_codes} codes of "
            f"{bits} bits (want {packed_width(num_codes, bits)})")
    shifts = _shifts(per_byte, bits, packed.dim(), packed.device)
    codes = (packed.to(torch.int32)[..., None] >> shifts) & (2 ** bits - 1)
    codes = codes.reshape(tuple(packed.shape[:-1]) + (w * per_byte,))
    return codes[..., :num_codes].to(torch.uint8)
