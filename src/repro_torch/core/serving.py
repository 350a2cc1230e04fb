"""Serving-side utilities: model-size accounting and artifact packing.

The paper evaluates "model size" as bits needed to store the embedding
at *serving* time, normalized to Full Embedding = 100% (§3.5).  This
module produces that table for any set of EmbeddingConfigs.
"""
from __future__ import annotations

from typing import Dict, Iterable, List

from repro_torch.core.schemes import get_scheme
from repro_torch.core.types import EmbeddingConfig


def size_row(cfg: EmbeddingConfig, baseline_bits: int) -> Dict:
    bits = cfg.serving_size_bits()
    return {
        "kind": cfg.kind,
        "variant": get_scheme(cfg).variant_label,
        "bits": bits,
        "mbytes": bits / 8 / 1e6,
        "pct_of_full": 100.0 * bits / baseline_bits,
    }


def size_table(cfgs: Iterable[EmbeddingConfig]) -> List[Dict]:
    cfgs = list(cfgs)
    full_bits = None
    for c in cfgs:
        # not scheme dispatch — picking the uncompressed row as the
        # size-table baseline; behavior lives in core/schemes/
        if c.kind == "full":  # repro-lint: disable=kind-dispatch
            full_bits = c.serving_size_bits()
            break
    if full_bits is None:
        full_bits = EmbeddingConfig(
            vocab_size=cfgs[0].vocab_size, dim=cfgs[0].dim).serving_size_bits()
    return [size_row(c, full_bits) for c in cfgs]


def format_size_table(rows: List[Dict]) -> str:
    hdr = f"{'scheme':14s} {'bits':>14s} {'MB':>10s} {'% of FE':>8s}"
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        name = r["kind"] + (f"/{r['variant']}" if r["variant"] else "")
        lines.append(f"{name:14s} {r['bits']:>14d} {r['mbytes']:>10.3f} "
                     f"{r['pct_of_full']:>8.2f}")
    return "\n".join(lines)
