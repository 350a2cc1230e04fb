"""Index build, the flat half: sampled fit + blocked encode.

Building a ``flat_pq`` index is O(corpus) in memory two ways: the
codebook fit scores every row against every centroid, and the encoding
assigns every row at once.  This module bounds both:

  * **sampled fit** — the PQ codebooks are fitted on a
    ``cfg.train_sample``-row sample (without replacement, drawn from the
    build's generator); fit temporaries scale with the sample;
  * **blocked encode** — ``encode_corpus`` runs over fixed
    ``cfg.encode_block``-row blocks and the codes are concatenated.

Blocked == one-shot bit for bit: one shot is a single block covering N,
and ``dpq_assign`` is row-independent, so a block boundary cannot change
any row's code.  Torch runs eagerly, so blocks need no padding to a
static shape (the JAX package pads its last block for one compilation).

``BuildStats.peak_device_bytes`` tracks the bytes the build holds at
once (sample + per-block I/O + codebooks); the analytic
``device_bound_bytes`` is derived from the config alone.  The IVF half
(``build_ivf_artifact``) waits for the IVF slice in ROADMAP.md.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Tuple

import torch


@dataclasses.dataclass
class BuildStats:
    """Accounting for one build (the IVF layout fields come with the
    IVF half)."""

    n: int = 0                   # corpus rows
    d: int = 0                   # vector width
    sample_rows: int = 0         # rows the codebooks were fitted on
    block_rows: int = 0          # rows per encode block
    blocks: int = 0              # encode blocks run
    seconds: float = 0.0         # wall time of the whole build
    peak_device_bytes: int = 0   # max bytes held for the build at once
    device_bound_bytes: int = 0  # analytic config-derived bound

    @property
    def peak_device_ok(self) -> bool:
        """Did the build's held bytes stay within the config-derived
        (corpus-independent) bound?"""
        return self.peak_device_bytes <= self.device_bound_bytes

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self) | {
            "peak_device_ok": self.peak_device_ok}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def training_sample(gen: torch.Generator, vectors: torch.Tensor,
                    sample: int) -> torch.Tensor:
    """Without-replacement row sample for the codebook fits.

    ``sample`` of 0 (or >= N) means the full corpus.  Indices are
    sorted so the sample keeps corpus order, and depend only on the
    generator and ``sample``, never on the block size."""
    n = vectors.shape[0]
    if not sample or sample >= n:
        return vectors
    idx = torch.randperm(n, generator=gen, device=gen.device)[:int(sample)]
    return vectors[torch.sort(idx).values.to(vectors.device)]


def blocked_map(step: Callable, vectors: torch.Tensor, block: int
                ) -> Tuple[Tuple[torch.Tensor, ...], int, int]:
    """Run a per-row map over fixed-size row blocks.

    ``step`` maps a ``(rows, d)`` block to a tensor or a tuple of
    per-row outputs.  Returns the concatenated outputs, the block count
    and the peak bytes of one block's input and outputs."""
    n = vectors.shape[0]
    block = min(block, n) if block else n
    outs: list = []
    peak = 0
    for start in range(0, n, block):
        blk = vectors[start:start + block]
        res = step(blk)
        res = res if isinstance(res, tuple) else (res,)
        peak = max(peak, _nbytes(blk) + sum(_nbytes(r) for r in res))
        outs.append(res)
    cat = tuple(torch.cat([o[j] for o in outs]) for j in range(len(outs[0])))
    return cat, len(outs), peak


def _device_bound_bytes(sample_rows: int, block: int, d: int,
                        out_bytes_per_row: int,
                        codebook_bytes: int) -> int:
    """Config-derived bound: sample + block I/O + codebooks, with 2x
    slack.  No term depends on the corpus size."""
    sample_bytes = sample_rows * d * 4
    block_bytes = block * (d * 4 + out_bytes_per_row)
    return 2 * (sample_bytes + block_bytes + codebook_bytes) + (1 << 20)


def build_flat_artifact(gen: torch.Generator, vectors: torch.Tensor,
                        cfg) -> Tuple[Dict, BuildStats]:
    """``flat_pq`` build: sampled fit + blocked encode.

    Returns ``({codes, centroids}, BuildStats)``, on the vectors'
    device."""
    from repro_torch.retrieval import flat_pq

    t0 = time.perf_counter()
    n, d = vectors.shape
    train = training_sample(gen, vectors, cfg.train_sample)
    cent = flat_pq.fit_pq(gen, train, cfg.num_subspaces, cfg.num_centroids,
                          cfg.iters)
    code_dtype = torch.uint8 if cfg.num_centroids <= 256 else torch.int32

    def step(blk):
        return flat_pq.encode_corpus(blk, cent, backend=cfg.kernel_backend)

    (codes,), blocks, peak = blocked_map(step, vectors, cfg.encode_block)
    block = min(cfg.encode_block, n) if cfg.encode_block else n
    sample_bytes = _nbytes(train) if train is not vectors else 0
    stats = BuildStats(
        n=n, d=d, sample_rows=train.shape[0], block_rows=block,
        blocks=blocks,
        peak_device_bytes=peak + sample_bytes + _nbytes(cent),
        device_bound_bytes=_device_bound_bytes(
            train.shape[0], block, d,
            out_bytes_per_row=4 * cfg.num_subspaces,
            codebook_bytes=_nbytes(cent)))
    artifact = {"codes": codes.to(code_dtype), "centroids": cent}
    if vectors.is_cuda:
        torch.cuda.synchronize(vectors.device)
    stats.seconds = time.perf_counter() - t0
    return artifact, stats
