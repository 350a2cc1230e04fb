"""Batched serving engine (paper Fig. 1 serving path).

Production serving traffic is many small requests, not one big batch.
The engine owns a device-resident artifact — moved to the device once
and reused across every request — and micro-batches queued requests
into a single decode call:

  * ``submit(x)`` enqueues a request (coerced and checked HOST-side — no
    device work on the submit path) and returns a handle;
  * ``flush()`` concatenates the queue in numpy, pads the flat batch up
    to the decode kernel's row tile, runs ONE decode via the shared
    ``run_flat`` device leg — one pinned host-to-device copy, one
    decode call, one synchronise before the clock stops — and splits
    results back per request;
  * the synchronous helpers (``lookup`` / ``search``) are submit +
    flush.

Two engines share that plumbing (``_MicroBatchEngine``):

  ``ServingEngine``    id lookups -> embedding rows over one exported
                       table (the scheme's decode kernel: ``mgqe_decode``,
                       ``rq_decode_stages`` or ``packed_decode``);
  ``RetrievalEngine``  query vectors -> (top-k scores, candidate ids)
                       over a built retrieval index (the ``pq_topk``
                       kernel, retrieval/).

Stats accumulate across flushes; ``stats()`` reports requests/second.
The hot-row cache, the sharded (mesh) paths and host-staged retrieval
are later slices in ROADMAP.md.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.api import Embedding, resolve_device
from repro_torch.core.schemes.base import tree_map


@dataclasses.dataclass
class EngineStats:
    requests: int = 0
    lookups: int = 0           # items actually requested (pre-padding)
    padded_lookups: int = 0    # items processed incl. tile padding
    flushes: int = 0
    seconds: float = 0.0

    @property
    def lookups_per_s(self) -> float:
        # zero guard: empty or instantaneous streams report 0.0
        return self.lookups / self.seconds if self.seconds > 0 else 0.0

    @classmethod
    def derived_metrics(cls) -> List[str]:
        """Every derived (computed) metric this stats class exports:
        the properties defined anywhere on the class."""
        return sorted({name for klass in cls.__mro__
                       for name, val in vars(klass).items()
                       if isinstance(val, property)})

    def as_dict(self) -> Dict:
        out = {f.name: getattr(self, f.name)
               for f in dataclasses.fields(self)}
        for name in self.derived_metrics():
            out[name] = getattr(self, name)
        return out


class _MicroBatchEngine:
    """Queue/pad/flush/split plumbing shared by the serving engines.

    Subclasses define ``_coerce_host`` (request -> numpy array with a
    leading batch dim) and ``_run`` (padded flat batch on the device ->
    a tensor, or a tuple of tensors, with the same leading dim);
    everything else — queueing, padding to ``pad_multiple``, stats, splitting
    results back per request — lives here.
    """

    def __init__(self, pad_multiple: int, max_queue: int,
                 device: torch.device):
        self.pad_multiple = pad_multiple
        self.max_queue = max_queue
        self.device = device
        self._queue: List[np.ndarray] = []
        self._queued = 0
        self.stats_ = EngineStats()

    # --------------------------------------------------------- hooks
    def _coerce_host(self, request) -> np.ndarray:
        """Request -> host (numpy) array with a leading batch dim, NO
        device upload: the whole flush ships as one copy."""
        raise NotImplementedError

    def _run(self, flat: torch.Tensor):
        """One call over the padded flat batch on the device."""
        raise NotImplementedError

    # --------------------------------------------------------- queue
    def submit(self, request) -> int:
        """Enqueue one request; returns its handle (index into the
        list the next flush() returns)."""
        arr = self._coerce_host(request)
        self._queue.append(arr)
        self._queued += arr.shape[0]
        return len(self._queue) - 1

    @property
    def pending(self) -> int:
        return self._queued

    def should_flush(self) -> bool:
        return self._queued >= self.max_queue

    # --------------------------------------------------------- serve
    def flush(self) -> List:
        """Process every queued request in one padded micro-batch and
        return each request's result, in submit order: its rows, or a
        tuple of its rows of each output (retrieval's scores and ids)."""
        if not self._queue:
            return []
        reqs, self._queue = self._queue, []
        n_req, n_rows = len(reqs), self._queued
        self._queued = 0
        flat = np.concatenate(reqs) if n_req > 1 else reqs[0]
        out = self.run_flat(flat, n_rows, n_requests=n_req)
        sizes = [r.shape[0] for r in reqs]
        if isinstance(out, tuple):
            pieces = [torch.split(o[:n_rows], sizes) for o in out]
            return [tuple(p[i] for p in pieces) for i in range(n_req)]
        return list(torch.split(out[:n_rows], sizes))

    def run_flat(self, flat: np.ndarray, n_valid: Optional[int] = None,
                 n_requests: int = 1):
        """One call over a HOST-assembled flat batch.

        Padding happens in numpy BEFORE the single host-to-device copy
        (from pinned memory, non-blocking), so the padded lengths
        collapse to a few stable shapes.  The clock stops after a
        device synchronise: PyTorch returns before the card finishes.
        Returns the RAW result (padded rows included); callers slice
        ``[:n_valid]``.  Stats accumulate as ``n_requests`` requests of
        ``n_valid`` total lookups.
        """
        n_valid = int(flat.shape[0] if n_valid is None else n_valid)
        pad = (-n_valid) % self.pad_multiple
        if pad:
            widths = [(0, pad)] + [(0, 0)] * (flat.ndim - 1)
            flat = np.pad(flat, widths)    # zero rows are always valid
        host = torch.from_numpy(np.ascontiguousarray(flat))
        on_card = self.device.type == "cuda"
        if on_card:
            host = host.pin_memory()
        dev = host.to(self.device, non_blocking=on_card)
        t0 = time.perf_counter()
        out = self._run(dev)
        if on_card:
            torch.cuda.synchronize(self.device)
        self.stats_.seconds += time.perf_counter() - t0
        self.stats_.requests += n_requests
        self.stats_.lookups += n_valid
        self.stats_.padded_lookups += int(dev.shape[0])
        self.stats_.flushes += 1
        return out

    def serve_stream(self, requests: Sequence[np.ndarray]) -> EngineStats:
        """Drive a request stream through the micro-batcher; flush
        whenever the queue reaches max_queue, once more at the end."""
        for r in requests:
            self.submit(r)
            if self.should_flush():
                self.flush()
        self.flush()
        return self.stats_

    def stats(self) -> EngineStats:
        return self.stats_


class ServingEngine(_MicroBatchEngine):
    """Micro-batching lookup engine over one exported embedding table.

    The artifact is moved to ``device`` once (the card by default; with
    no card present construction raises — pass ``device="cpu"``).
    Every flush pads to ``block_b``, which the decode kernels also take
    as their threads a block.
    Request ids are checked on the host against ``[0, vocab)``: on the
    card an out-of-range row index is a device-side fault, not a clamp.
    """

    def __init__(self, emb: Embedding, artifact: dict,
                 block_b: Optional[int] = None,
                 max_queue: int = 65536,
                 backend: Optional[str] = None,
                 device="cuda"):
        overrides = {}
        if backend is not None:
            overrides["kernel_backend"] = backend
        if block_b is not None:
            # the queue's padding is block_b; the decode kernels take it
            # as threads a block, rounded up to whole warps (rq's l2
            # route takes it as it is)
            overrides["decode_block_b"] = block_b
        device = resolve_device(device)
        if overrides or emb.device != device:
            # rebuild so the decode path dispatches as asked
            emb = Embedding(dataclasses.replace(emb.cfg, **overrides),
                            device=device)
        self.emb = emb
        self.block_b = emb.cfg.decode_block_b
        super().__init__(pad_multiple=self.block_b, max_queue=max_queue,
                         device=device)
        # device-resident once; requests only ship (B,) int32 ids
        self.artifact = tree_map(lambda t: t.to(device), artifact)

    # --------------------------------------------------------- serve
    def _coerce_host(self, ids) -> np.ndarray:
        arr = np.asarray(ids, np.int32).reshape(-1)
        vocab = self.emb.cfg.vocab_size
        if arr.size and (arr.min() < 0 or arr.max() >= vocab):
            raise ValueError(f"request ids must lie in [0, {vocab}), got "
                             f"[{arr.min()}, {arr.max()}]")
        return arr

    def _run(self, flat: torch.Tensor) -> torch.Tensor:
        return self.emb.serve(self.artifact, flat)

    def lookup(self, ids) -> torch.Tensor:
        """Synchronous single-request path (submit + flush).  Flushes
        whatever else is queued too and returns THIS request's rows."""
        handle = self.submit(ids)
        return self.flush()[handle]


class RetrievalEngine(_MicroBatchEngine):
    """Micro-batching top-k retrieval over one built index.

    Requests are query-vector batches (B_i, d); every flush pads the
    concatenated queries to ``block_q`` and runs ONE batched search
    (``Index.search``), returning per request ``(scores (B_i, k),
    candidate ids (B_i, k))``.  The artifact is moved to ``device`` once
    (the card by default; with no card present construction raises —
    pass ``device="cpu"``).

    Single device only: ``mesh`` (a distributed corpus) and
    ``host_staged`` (list tables kept in host memory, an IVF feature)
    raise, naming their slices in ROADMAP.md.
    """

    def __init__(self, index, artifact: dict, k: int,
                 block_q: int = 64, max_queue: int = 4096, mesh=None,
                 host_staged: Optional[bool] = None, device="cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "a retrieval mesh (sharded corpus) waits for the "
                "distributed slice in ROADMAP.md")
        if host_staged is None:
            host_staged = index.cfg.host_staged
        if host_staged:
            raise NotImplementedError(
                "host-staged retrieval waits for the IVF slice in "
                "ROADMAP.md")
        self.index, self.k = index, k
        self.block_q = block_q
        device = resolve_device(device)
        super().__init__(pad_multiple=block_q, max_queue=max_queue,
                         device=device)
        # device-resident once; requests only ship (B, d) f32 queries
        self.artifact = {name: leaf.to(device)
                         for name, leaf in artifact.items()}

    def _coerce_host(self, queries) -> np.ndarray:
        q = np.asarray(queries, np.float32)
        return q[None] if q.ndim == 1 else q

    def _run(self, flat: torch.Tensor):
        return self.index.search(self.artifact, flat, self.k)

    def search(self, queries):
        """Synchronous single-request path (submit + flush): queries
        (B, d) or (d,) -> (scores, ids).  Flushes whatever else is
        queued too and returns THIS request's results."""
        handle = self.submit(queries)
        return self.flush()[handle]


def random_requests(vocab_size: int, n_requests: int, req_batch: int,
                    seed: int = 0) -> List[np.ndarray]:
    """The uniform request stream of the bench/demo harness:
    ``n_requests`` requests of 1..``req_batch`` ids each, from ``seed``."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab_size, int(rng.integers(1, req_batch + 1)))
            for _ in range(n_requests)]


def drive_stream(engine: _MicroBatchEngine,
                 requests: Sequence[np.ndarray]) -> EngineStats:
    """Drive ``requests`` through the engine twice and return the stats
    of the second pass: the first builds the kernels and warms every
    padded shape, so the returned stats hold no build or first-launch
    time."""
    engine.serve_stream(requests)          # warm pass
    engine.stats_ = EngineStats()
    return engine.serve_stream(requests)


def drive_random_stream(engine: ServingEngine, vocab_size: int,
                        n_requests: int, req_batch: int,
                        seed: int = 0) -> EngineStats:
    """Stream n_requests random-size requests (1..req_batch ids each),
    warm pass first, and return the throughput stats."""
    return drive_stream(engine, random_requests(vocab_size, n_requests,
                                                req_batch, seed))


def drive_zipf_stream(engine: ServingEngine, vocab_size: int,
                      n_requests: int, req_batch: int,
                      zipf_a: float = 1.2, seed: int = 0) -> EngineStats:
    """Power-law twin of :func:`drive_random_stream`: Zipf(``zipf_a``)
    ids over the frequency-sorted vocabulary, warm pass first."""
    from repro_torch.data.synthetic import zipf_request_stream
    return drive_stream(engine, zipf_request_stream(
        vocab_size, n_requests, req_batch, zipf_a=zipf_a, seed=seed))


def drive_random_query_stream(engine: RetrievalEngine, dim: int,
                              n_requests: int, req_batch: int,
                              seed: int = 0) -> EngineStats:
    """Retrieval twin of :func:`drive_random_stream`: random-size
    query-vector requests, warm pass first."""
    rng = np.random.default_rng(seed)
    reqs = [rng.normal(size=(int(rng.integers(1, req_batch + 1)), dim)
                       ).astype(np.float32)
            for _ in range(n_requests)]
    return drive_stream(engine, reqs)


def embedding_config_of_arch(family: str, cfg):
    """Pick the arch's main large-vocab EmbeddingConfig (engine demo)."""
    from repro_torch.models.recsys.fields import field_embedding_config
    if family == "lm":                 # the token table
        return cfg.embedding
    if family != "recsys":
        raise NotImplementedError(
            f"family {family!r} waits for its slice in ROADMAP.md; the "
            f"port serves the lm and recsys archs")
    if cfg.model == "two_tower":       # the item table, as in JAX
        return field_embedding_config(cfg, cfg.n_items)
    return field_embedding_config(cfg, max(cfg.field_vocab_sizes))


__all__ = ["EngineStats", "RetrievalEngine", "ServingEngine",
           "drive_random_query_stream", "drive_random_stream",
           "drive_stream", "drive_zipf_stream", "embedding_config_of_arch",
           "random_requests"]
