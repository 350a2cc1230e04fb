"""Mixed-Precision Embeddings (arXiv 2409.20305) as a registry plugin.

MGQE's capacity knob one level down the stack: instead of varying the
number of centroids or subspaces per frequency tier, ``mpe`` varies the
*bitwidth* of the stored codes — tier i uses ``K_i = 2**tier_bits[i]``
centroids per subspace and stores its codes bit-packed at
``tier_bits[i]`` bits per code (int8 head, int4/int2 tail).  Serving
decodes through the dispatched ``packed_decode`` op, which unpacks in
registers, so the tail tiers' smaller code bytes hold end to end.

Storage follows the ``mgqe`` ``private_d`` precedent: each tier keeps a
FULL (n, W_i) packed table so decode stays one kernel call per tier
blended by tier masks, while ``logical_bits`` count only the rows in
tier i at their packed width.
"""
from __future__ import annotations

import torch

from repro_torch.core import dpq
from repro_torch.core.partition import tier_of_ids
from repro_torch.core.schemes.base import (PIN_TO_CONFIG, ArtifactLeaf,
                                           QuantizedScheme, register_scheme,
                                           torch_dtype)
from repro_torch.kernels.packed_decode import (PACK_BITS, decode, pack_codes,
                                               packed_width)


@register_scheme("mpe")
class MixedPrecisionEmbedding(QuantizedScheme):
    """Per-frequency-tier code bitwidths with bit-packed storage:
    frequent items get int8 codes, the tail int4/int2."""

    @classmethod
    def validate(cls, cfg):
        if cfg.dim % cfg.num_subspaces != 0:
            raise ValueError(
                f"dim={cfg.dim} not divisible by D={cfg.num_subspaces}")
        m = len(cfg.tier_boundaries) + 1
        if len(cfg.tier_bits) != m:
            raise ValueError(
                f"tier_bits must have {m} entries, got "
                f"{len(cfg.tier_bits)}")
        for b in cfg.tier_bits:
            if b not in PACK_BITS:
                raise ValueError(
                    f"tier_bits entries must be one of {PACK_BITS}, "
                    f"got {b}")
        if any(cfg.tier_bits[i] < cfg.tier_bits[i + 1]
               for i in range(len(cfg.tier_bits) - 1)):
            raise ValueError("tier_bits must be non-increasing")
        if any(b <= 0 or b >= cfg.vocab_size for b in cfg.tier_boundaries):
            raise ValueError("tier boundaries must lie inside (0, vocab)")
        if any(cfg.tier_boundaries[i] >= cfg.tier_boundaries[i + 1]
               for i in range(len(cfg.tier_boundaries) - 1)):
            raise ValueError("tier boundaries must be strictly ascending")

    # ------------------------------------------------------------ train
    def init(self, gen, dtype):
        """Full table first, then each tier's (D, 2**b_i, S) codebook,
        all drawn from ``gen`` and scaled in place."""
        cfg = self.cfg
        emb = dpq.init_full_table(gen, cfg.vocab_size, cfg.dim, dtype=dtype)
        return {
            "emb": emb,
            "centroids": [
                dpq.init_centroids(gen, cfg.num_subspaces, 2 ** b_i,
                                   cfg.subspace_dim, scale=cfg.dim ** -0.5,
                                   dtype=dtype)
                for b_i in cfg.tier_bits],
        }

    def apply(self, params, ids, mesh=None):
        """Training path: per-tier codebook quantization blended by tier
        masks (the same loop as the mgqe private variants)."""
        cfg = self.cfg
        e = dpq.row_gather(params["emb"], ids, mesh=mesh,
                           rows=cfg.vocab_size)
        tiers = tier_of_ids(ids, cfg.tier_boundaries)
        out = torch.zeros_like(e)
        aux = torch.zeros((), dtype=torch.float32, device=e.device)
        for i, cent in enumerate(params["centroids"]):
            q_i, _, aux_i = dpq.quantize(e, cent, beta=cfg.beta)
            mask = tiers == i
            out = torch.where(mask[..., None], q_i, out)
            aux = aux + aux_i * dpq.batch_fraction(mask, mesh)
        return out, aux

    # ------------------------------------------------------------ serve
    def export(self, params):
        """Discard the full table; per tier, assign codes against the
        tier codebook over the whole vocabulary (the ``dpq_assign`` op)
        and bit-pack them."""
        cfg = self.cfg
        out = {"codes": [], "centroids": params["centroids"]}
        for b_i, cent in zip(cfg.tier_bits, params["centroids"]):
            codes = dpq.export_codes({"emb": params["emb"], "centroids": cent},
                                     backend=cfg.kernel_backend)
            out["codes"].append(pack_codes(codes, b_i))
        return out

    def decode(self, artifact, ids, tier_ids=None,
               block_b=PIN_TO_CONFIG):
        """One ``packed_decode`` per tier, blended by tier masks.  The
        gathered rows stay PACKED across the op boundary: each tier's
        (B, W_i) words go straight to the op, which unpacks them."""
        cfg = self.cfg
        bb = self.resolve_block_b(block_b)
        tiers = tier_of_ids(ids if tier_ids is None else tier_ids,
                            cfg.tier_boundaries)
        flat_ids = ids.reshape(-1)
        out = None
        for i, (b_i, cent) in enumerate(zip(cfg.tier_bits,
                                            artifact["centroids"])):
            packed = artifact["codes"][i].index_select(0, flat_ids)
            rows = decode(packed, cent, b_i, block_b=bb,
                          backend=cfg.kernel_backend)
            out_i = rows.reshape(tuple(ids.shape) + (cfg.dim,))
            out = out_i if out is None \
                else torch.where((tiers == i)[..., None], out_i, out)
        return out

    # -------------------------------------------------------- structure
    def cold_artifact_spec(self):
        cfg = self.cfg
        n, D = cfg.vocab_size, cfg.num_subspaces
        pd = torch_dtype(cfg.param_dtype)
        return {
            "codes": [
                ArtifactLeaf((n, packed_width(D, b_i)), torch.uint8,
                             rows=True, logical_bits=sz * D * b_i)
                for sz, b_i in zip(cfg.tier_sizes(), cfg.tier_bits)],
            "centroids": [
                ArtifactLeaf((D, 2 ** b_i, cfg.subspace_dim), pd)
                for b_i in cfg.tier_bits],
        }

    def training_param_count(self):
        cfg = self.cfg
        return (cfg.vocab_size * cfg.dim
                + cfg.dim * sum(2 ** b for b in cfg.tier_bits))
