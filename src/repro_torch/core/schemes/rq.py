"""Residual quantization (``rq``) as a registry plugin.

Training (straight-through, VQ-VAE-style like DPQ): M = ``num_levels``
sequential *full-width* codebooks ``C_m (K, d)``; stage m quantizes the
residual left by stages < m:

    r_0 = e
    c_m = argmin_k ||r_m - C_m[k]||^2
    r_{m+1} = r_m - sg(C_m[c_m])
    out = e + sg(sum_m C_m[c_m]) - sg(e)

Serving artifact: codes ``(n, M)`` + codebooks ``(M, K, d)``, decoded
through the dispatched single-pass ``rq_decode_stages`` op (the CUDA
kernel for an artifact on the card): the M-stage sum happens in the
kernel's registers, and no (B, M·d) stage rows reach memory.
"""
from __future__ import annotations

import torch

from repro_torch.core import dpq
from repro_torch.core.schemes.base import (PIN_TO_CONFIG, ArtifactLeaf,
                                           QuantizedScheme, log2ceil,
                                           register_scheme, torch_dtype)
from repro_torch.kernels.mgqe_decode import decode_stages


def _stage_assign(r: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest-codeword ids (int32) for residuals r (..., d) against
    one codebook (K, d): the plain assignment with a single full-width
    subspace, as the JAX package assigns them."""
    return dpq.assign_codes(r[..., None, :], codebook[None])[..., 0]


def _stages(e: torch.Tensor, codebooks: torch.Tensor):
    """Yield (residual r_m, code c_m, codeword C_m[c_m]) for each stage
    m of rows e (..., d); the codeword is a differentiable gather."""
    r = e
    for m in range(codebooks.shape[0]):
        cb = codebooks[m]
        code = _stage_assign(r, cb)
        c = dpq.row_gather(cb, code)
        yield r, code, c
        r = r - c.detach()


@register_scheme("rq")
class ResidualQuantization(QuantizedScheme):
    """M sequential full-width codebooks over residuals."""

    @classmethod
    def validate(cls, cfg):
        if cfg.num_levels < 1:
            raise ValueError(
                f"rq needs num_levels >= 1, got {cfg.num_levels}")
        if cfg.num_centroids < 2:
            raise ValueError("rq needs num_centroids >= 2")

    # ------------------------------------------------------------ train
    def init(self, gen, dtype):
        """Full table first, then the codebooks, both drawn from
        ``gen`` and scaled in place.  Stage 0 sits at embedding scale;
        later stages model residuals, which shrink — geometric damping
        keeps early argmins spread at every level."""
        cfg = self.cfg
        emb = dpq.init_full_table(gen, cfg.vocab_size, cfg.dim, dtype=dtype)
        scales = torch.tensor([cfg.dim ** -0.5 * 0.5 ** m
                               for m in range(cfg.num_levels)],
                              dtype=dtype, device=gen.device)
        cbs = torch.randn((cfg.num_levels, cfg.num_centroids, cfg.dim),
                          generator=gen, dtype=dtype, device=gen.device)
        return {"emb": emb, "codebooks": cbs.mul_(scales[:, None, None])}

    def _quantize(self, e: torch.Tensor, codebooks: torch.Tensor):
        """Residual-quantize rows e (..., d); returns (quantized
        (..., d), codes (..., M), aux_loss scalar)."""
        beta = self.cfg.beta
        q_total = torch.zeros_like(e)
        codes = []
        aux = torch.zeros((), dtype=torch.float32, device=e.device)
        for r, code, c in _stages(e, codebooks):
            codebook_loss = torch.mean(torch.sum(
                torch.square(r.detach() - c), dim=-1))
            commit = torch.mean(torch.sum(
                torch.square(r - c.detach()), dim=-1))
            aux = aux + codebook_loss + beta * commit
            q_total = q_total + c
            codes.append(code)
        # written as the JAX package writes it, so the forward value is
        # bit-identical to it wherever the codes agree
        out = e + q_total.detach() - e.detach()
        return out, torch.stack(codes, dim=-1), aux

    def apply(self, params, ids, mesh=None):
        e = dpq.row_gather(params["emb"], ids, mesh=mesh,
                           rows=self.cfg.vocab_size)
        out, _, aux = self._quantize(e, params["codebooks"])
        return out, aux

    # ------------------------------------------------------------ serve
    def export(self, params, batch: int = 65536):
        """Codes of the whole vocabulary, batch by batch through the
        plain residual assignment (the JAX package runs no kernel here
        either), then the codebooks."""
        emb, cbs = params["emb"], params["codebooks"]
        outs = []
        with torch.no_grad():
            for s in range(0, emb.shape[0], batch):
                codes = [code for _, code, _ in _stages(emb[s:s + batch],
                                                         cbs)]
                outs.append(torch.stack(codes, dim=-1))
        return {"codes": torch.cat(outs).to(self.code_dtype),
                "codebooks": cbs}

    def decode(self, artifact, ids, tier_ids=None,
               block_b=PIN_TO_CONFIG):
        cfg = self.cfg
        # codes keep their stored dtype (uint8) up to the op, which
        # widens them itself
        codes = artifact["codes"].index_select(0, ids.reshape(-1))
        out = decode_stages(codes, artifact["codebooks"],
                            block_b=self.resolve_block_b(block_b),
                            backend=cfg.kernel_backend)
        return out.reshape(tuple(ids.shape) + (cfg.dim,))

    # -------------------------------------------------------- structure
    def cold_artifact_spec(self):
        cfg = self.cfg
        return {
            "codebooks": ArtifactLeaf(
                (cfg.num_levels, cfg.num_centroids, cfg.dim),
                torch_dtype(cfg.param_dtype)),
            "codes": ArtifactLeaf(
                (cfg.vocab_size, cfg.num_levels), self.code_dtype,
                rows=True,
                logical_bits=cfg.vocab_size * cfg.num_levels
                * log2ceil(cfg.num_centroids)),
        }

    def training_param_count(self):
        cfg = self.cfg
        return (cfg.vocab_size * cfg.dim
                + cfg.num_levels * cfg.num_centroids * cfg.dim)
