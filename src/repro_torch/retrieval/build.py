"""Index builds: sampled fit + blocked encode, flat and IVF.

Building an index is O(corpus) in memory three ways: the codebook fits
score every row against every centroid, the assignment and encoding
run over every row at once, and the whole corpus sits on the device.
This module bounds all three:

  * **sampled fit** — the coarse and PQ codebooks are fitted on a
    ``cfg.train_sample``-row sample (without replacement, drawn from the
    build's generator); fit temporaries scale with the sample;
  * **blocked encode** — ``coarse_assign`` / ``encode_corpus`` run over
    fixed ``cfg.encode_block``-row blocks and the outputs are
    concatenated;
  * **host corpus** (IVF) — ``build_ivf_artifact`` takes the corpus as
    a CPU tensor or numpy array that never goes to the card whole: the
    sample and each block are staged to the build device in turn, and
    the list tables come back in host memory (placement — the device,
    or host-staged serving — is the caller's).

Blocked == one-shot bit for bit: one shot is a single block covering N,
and ``dpq_assign`` is row-independent, so a block boundary cannot change
any row's code.  Torch runs eagerly, so blocks need no padding to a
static shape (the JAX package pads its last block for one compilation).

``BuildStats.peak_device_bytes`` tracks the bytes the build holds at
once (sample + per-block I/O + codebooks); the analytic
``device_bound_bytes`` is derived from the config alone.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class BuildStats:
    """Accounting for one build."""

    n: int = 0                   # corpus rows
    d: int = 0                   # vector width
    sample_rows: int = 0         # rows the codebooks were fitted on
    block_rows: int = 0          # rows per encode block
    blocks: int = 0              # encode blocks run
    seconds: float = 0.0         # wall time of the whole build
    peak_device_bytes: int = 0   # max bytes held for the build at once
    device_bound_bytes: int = 0  # analytic config-derived bound
    # layout accounting (IVF only; zeros for flat kinds)
    list_count_max: int = 0      # longest coarse list
    list_count_mean: float = 0.0
    list_cap: int = 0            # per-list slot cap after quantile
    max_chain: int = 0           # longest spill chain
    lists_ext: int = 0           # extended list count (base + spill)
    # wall seconds of each step (IVF: sample, coarse_fit, pq_fit,
    # assign, encode, layout), the device synchronised after each
    step_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)

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


class _Clock:
    """Wall seconds of each build step, the device synchronised at each
    boundary so a step owns its own device work."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds: Dict[str, float] = {}
        self.t = time.perf_counter()

    def lap(self, step: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.seconds[step] = self.seconds.get(step, 0.0) + now - self.t
        self.t = now


def build_ivf_artifact(gen: torch.Generator, vectors, cfg,
                       device="cuda") -> Tuple[Dict, BuildStats]:
    """``ivf_pq`` build: sampled coarse + PQ fit, blocked assign +
    encode, bounded chained list layout.

    ``vectors`` (N, d) float32 — a CPU tensor or numpy array (staged
    block by block), or a tensor on ``device`` already.  ``gen`` draws
    the sample, the coarse and the PQ initial centroids, in that order;
    on its own device.  Returns ``({coarse, centroids, list_chain,
    list_codes, list_ids}, BuildStats)``: ``coarse`` and ``centroids``
    on ``device``, the list tables as CPU tensors."""
    from repro_torch.core.api import resolve_device
    from repro_torch.retrieval import flat_pq
    from repro_torch.retrieval.ivf_pq import (bounded_list_layout,
                                              coarse_assign, coarse_kmeans)

    device = resolve_device(device)
    t0 = time.perf_counter()
    clock = _Clock(device)
    rows = torch.as_tensor(vectors)          # zero-copy from numpy
    n, d = rows.shape
    if n < cfg.nlist:
        raise ValueError(
            f"corpus of {n} vectors cannot fill nlist={cfg.nlist} "
            f"coarse cells")
    train = training_sample(gen, rows, cfg.train_sample)
    if train.shape[0] < cfg.nlist:
        raise ValueError(
            f"train_sample={train.shape[0]} cannot seed "
            f"nlist={cfg.nlist} coarse cells")
    train_dev = train.to(device)
    clock.lap("sample")
    coarse = coarse_kmeans(gen, train_dev, cfg.nlist, iters=cfg.coarse_iters)
    clock.lap("coarse_fit")
    if cfg.ivf_residual:
        to_code = train_dev - coarse[coarse_assign(train_dev, coarse)]
    else:
        to_code = train_dev
    cent = flat_pq.fit_pq(gen, to_code, cfg.num_subspaces,
                          cfg.num_centroids, cfg.iters)
    del to_code
    clock.lap("pq_fit")
    small = cfg.num_centroids <= 256
    code_dtype = torch.uint8 if small else torch.int32

    block = min(cfg.encode_block, n) if cfg.encode_block else n
    assign_np = np.empty(n, np.int32)
    codes_np = np.empty((n, cfg.num_subspaces),
                        np.uint8 if small else np.int32)
    blocks = peak = 0
    for start in range(0, n, block):
        blk = rows[start:start + block].to(device)
        a = coarse_assign(blk, coarse)
        clock.lap("assign")
        tc = blk - coarse[a] if cfg.ivf_residual else blk
        codes = flat_pq.encode_corpus(tc, cent, backend=cfg.kernel_backend)
        peak = max(peak, _nbytes(blk) + _nbytes(a) + _nbytes(codes))
        assign_np[start:start + block] = a.cpu().numpy()
        codes_np[start:start + block] = codes.to(code_dtype).cpu().numpy()
        del blk, a, tc, codes
        clock.lap("encode")
        blocks += 1
    layout = bounded_list_layout(assign_np, codes_np, cfg.nlist,
                                 cfg.list_cap_quantile)
    counts = np.bincount(assign_np, minlength=cfg.nlist)
    clock.lap("layout")
    codebook_bytes = _nbytes(coarse) + _nbytes(cent)
    stats = BuildStats(
        n=n, d=d, sample_rows=train.shape[0], block_rows=block,
        blocks=blocks,
        peak_device_bytes=peak + _nbytes(train) + codebook_bytes,
        device_bound_bytes=_device_bound_bytes(
            train.shape[0], block, d,
            out_bytes_per_row=4 + 4 * cfg.num_subspaces,
            codebook_bytes=codebook_bytes),
        list_count_max=int(counts.max()),
        list_count_mean=float(counts.mean()),
        list_cap=layout["list_codes"].shape[1],
        max_chain=layout["list_chain"].shape[1],
        lists_ext=layout["list_codes"].shape[0],
        step_seconds=clock.seconds)
    artifact = {"coarse": coarse, "centroids": cent,
                **{name: torch.from_numpy(leaf)
                   for name, leaf in layout.items()}}
    stats.seconds = time.perf_counter() - t0
    return artifact, stats
