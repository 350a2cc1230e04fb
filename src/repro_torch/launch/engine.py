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
                       over a built retrieval index (retrieval/: the
                       ``pq_topk`` kernel for flat_pq; ivf_pq's probed
                       search, its list tables on the device or staged
                       from host memory a flush at a time).

``ServingEngine`` can keep a hot-row cache: a dense block of the
hottest rows, decoded once; each flush is split on the host into cached
and cold ids, only the cold remainder reaches the decode kernel, and a
gather-and-select merges the two (DESIGN.md §9).
``launch/async_engine.py`` wraps either engine in a latency front-end.

Stats accumulate across flushes; ``stats()`` reports requests/second.
The sharded (mesh) paths are a later slice in ROADMAP.md.
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
    # hot-row cache accounting (ServingEngine): hits count REAL lookups
    # only (flush padding never counts); decoded_lookups are the rows
    # that reached the decode kernel, the cold side's own padding
    # included — a flush served wholly from the cache adds zero
    hot_hits: int = 0
    decoded_lookups: int = 0
    hot_refreshes: int = 0

    @property
    def lookups_per_s(self) -> float:
        # zero guard: empty or instantaneous streams report 0.0
        return self.lookups / self.seconds if self.seconds > 0 else 0.0

    @property
    def hit_rate(self) -> float:
        """Fraction of real lookups served from the hot-row cache."""
        return self.hot_hits / self.lookups if self.lookups else 0.0

    @classmethod
    def derived_metrics(cls) -> List[str]:
        """Every derived (computed) metric this stats class exports:
        the properties defined anywhere on the class."""
        return sorted({name for klass in cls.__mro__
                       for name, val in vars(klass).items()
                       if isinstance(val, property)})

    def as_dict(self) -> Dict:
        # counters first (a field with its own as_dict — the async
        # stats' latency histogram — exports through it), then every
        # derived metric, subclass additions included
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out[f.name] = v.as_dict() if hasattr(v, "as_dict") else v
        for name in self.derived_metrics():
            out[name] = getattr(self, name)
        return out


class _MicroBatchEngine:
    """Queue/pad/flush/split plumbing shared by the serving engines.

    Subclasses define ``_coerce_host`` (request -> numpy array with a
    leading batch dim) and ``_run`` (the staged padded flat batch and
    its count of real rows -> a tensor, or a tuple of tensors, with the
    flat batch's leading dim); everything else — queueing, padding to
    ``pad_multiple``, the upload, stats, splitting results back per
    request — lives here.
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

    def _run(self, staged, n_valid: int):
        """One call over the padded flat batch as ``_stage`` left it;
        its first ``n_valid`` rows are real."""
        raise NotImplementedError

    def _stage(self, flat: np.ndarray):
        """The padded flat batch as ``_run`` takes it, before the clock
        starts: by default on the device, in one copy."""
        return self._upload(flat)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device: one host-to-device copy
        from pinned memory, non-blocking, on the current stream."""
        host = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return host
        return host.pin_memory().to(self.device, non_blocking=True)

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
        collapse to a few stable shapes.  The clock stops after the
        current stream is synchronised (PyTorch returns before the card
        finishes) — that stream only, so a refresh decoding on another
        stream never delays a flush.  Returns the RAW result (padded
        rows included); callers slice ``[:n_valid]``.  Stats accumulate
        as ``n_requests`` requests of ``n_valid`` total lookups.
        """
        n_valid = int(flat.shape[0] if n_valid is None else n_valid)
        pad = (-n_valid) % self.pad_multiple
        if pad:
            widths = [(0, pad)] + [(0, 0)] * (flat.ndim - 1)
            flat = np.pad(flat, widths)    # zero rows are always valid
        staged = self._stage(flat)
        t0 = time.perf_counter()
        out = self._run(staged, n_valid)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self.stats_.seconds += time.perf_counter() - t0
        self.stats_.requests += n_requests
        self.stats_.lookups += n_valid
        self.stats_.padded_lookups += int(flat.shape[0])
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

    **Hot-row cache** (DESIGN.md §9): with ``hot_rows`` = C > 0 (or the
    config's ``hot_rows``) the engine keeps a dense (C, d) block of the
    hottest rows on the device and a host id->slot map.  Each flush is
    split on the host (slots, cold ids padded to ``block_b``, each
    position's rank among the cold ids), shipped in one upload, and
    merged on the device by two gathers and a select: cached positions
    read the block, the cold remainder goes through the scheme's decode
    kernel, and a flush served wholly from the cache launches none.
    Cached rows are bit-identical to the cold path: the block is the
    artifact's export-time ``hot`` leaf, used only when this engine
    decodes exactly as the export did (no backend or ``block_b``
    override, the same device, a block of C rows), or else re-decoded
    through this engine's own serve path.  EMA frequency counters kept
    on the device (``hot_track_freq``) feed ``refresh_hot_rows``, which
    re-points the cache at the observed-hottest ids;
    ``hot_refresh_every`` = N does so every N flushes.
    """

    def __init__(self, emb: Embedding, artifact: dict,
                 block_b: Optional[int] = None,
                 max_queue: int = 65536,
                 backend: Optional[str] = None,
                 device="cuda",
                 hot_rows: Optional[int] = None,
                 hot_ema_decay: float = 0.99,
                 hot_refresh_every: int = 0,
                 hot_track_freq: Optional[bool] = None):
        overrides = {}
        if backend is not None:
            overrides["kernel_backend"] = backend
        if block_b is not None:
            # the queue's padding is block_b; the decode kernels take it
            # as threads a block, rounded up to whole warps (rq's l2
            # route takes it as it is)
            overrides["decode_block_b"] = block_b
        device = resolve_device(device)
        rebuilt = bool(overrides) or emb.device != device
        if rebuilt:
            # rebuild so the decode path dispatches as asked
            emb = Embedding(dataclasses.replace(emb.cfg, **overrides),
                            device=device)
        self.emb = emb
        self.block_b = emb.cfg.decode_block_b
        super().__init__(pad_multiple=self.block_b, max_queue=max_queue,
                         device=device)
        # device-resident once; requests only ship (B,) int32 ids
        self.artifact = tree_map(lambda t: t.to(device), artifact)

        # ------------------------------------------------ hot-row cache
        vocab = emb.cfg.vocab_size
        self.hot_rows = (emb.cfg.hot_rows if hot_rows is None
                         else int(hot_rows))
        if not 0 <= self.hot_rows <= vocab:
            raise ValueError(f"hot_rows={self.hot_rows} must lie in [0, "
                             f"vocab_size={vocab}]")
        self.hot_ema_decay = float(hot_ema_decay)
        self.hot_refresh_every = int(hot_refresh_every)
        # the EMA counters cost O(vocab) device work per flush; track
        # them only when the adaptive cache is in play
        self.hot_track_freq = (hot_refresh_every > 0
                               if hot_track_freq is None
                               else bool(hot_track_freq))
        # (block (C, d) on the device, host id->slot map (vocab,) int32
        # with -1 for cold, host (C,) int64 id set): swapped as ONE
        # reference, so a flush reads one consistent cache state
        self._hot: Optional[tuple] = None
        self._freq: Optional[torch.Tensor] = None   # (vocab,) f32 EMA
        self._freq_event = None    # recorded after each counter update
        if self.hot_rows:
            # seed with the head ids (frequency-sorted convention)
            block = None
            if ("hot" in artifact and not rebuilt
                    and artifact["hot"].shape[0] == self.hot_rows):
                block = self.artifact["hot"]
            self._set_hot_rows(np.arange(self.hot_rows), block=block)

    # ----------------------------------------------------- hot-row cache
    @property
    def _hot_block(self) -> Optional[torch.Tensor]:
        return None if self._hot is None else self._hot[0]

    @property
    def _hot_ids(self) -> Optional[np.ndarray]:
        return None if self._hot is None else self._hot[2]

    def _decode_ids(self, ids_np: np.ndarray) -> torch.Tensor:
        """Decode arbitrary ids through the engine's own serve path,
        padded to the flush granularity, on the current stream — the
        rows a flush's cold path gives for the same ids."""
        n = len(ids_np)
        padded = np.zeros(n + (-n) % self.pad_multiple, np.int32)
        padded[:n] = ids_np
        return self.emb.serve(self.artifact, self._upload(padded))[:n]

    def prepare_hot_rows(self, ids_np: np.ndarray, block=None) -> tuple:
        """Build (but do not install) the cache state for an id set:
        the block decoded through the engine's own serve path (or the
        given one) and the host id->slot map.  Touches no live cache
        field, so a background thread may run it beside flushes and
        hand the result to :meth:`install_hot_rows`."""
        ids_np = np.asarray(ids_np, np.int64)
        if block is None:
            block = self._decode_ids(ids_np)
        slot = np.full(self.emb.cfg.vocab_size, -1, np.int32)
        slot[ids_np] = np.arange(len(ids_np), dtype=np.int32)
        return block, slot, ids_np

    def install_hot_rows(self, state: tuple) -> None:
        """Swap a prepared cache state in: one reference assignment, and
        a flush reads the state once, so a swap never tears a flush."""
        self._hot = tuple(state)

    def _set_hot_rows(self, ids_np: np.ndarray, block=None) -> None:
        self.install_hot_rows(self.prepare_hot_rows(ids_np, block=block))

    def freq_snapshot(self) -> Optional[torch.Tensor]:
        """A copy of the EMA counters on the current stream, ordered
        after the last flush's update to them (None before any
        traffic)."""
        freq, event = self._freq, self._freq_event
        if freq is None:
            return None
        if event is not None:
            torch.cuda.current_stream(self.device).wait_event(event)
        return freq.clone()

    def select_hot_ids(self, freq: Optional[torch.Tensor] = None):
        """The top ``hot_rows`` ids by the EMA counters (default: the
        live ones), ties broken by id, sorted; None before any traffic.
        A stable sort of the negated counters is ``np.lexsort((arange,
        -freq))``; ``0 - freq`` keeps unseen ids at +0.0, one key."""
        if freq is None:
            freq = self._freq
        if freq is None:
            return None
        order = torch.sort(0.0 - freq, stable=True).indices
        # the top ids sorted where they are, so the host gets one copy
        return torch.sort(order[:self.hot_rows]).values.cpu().numpy()

    def refresh_hot_rows(self, hot_ids=None) -> np.ndarray:
        """Re-point the cache at the observed-hottest ids and re-decode
        the block through the engine's own serve path.

        ``hot_ids`` defaults to :meth:`select_hot_ids`; an explicit id
        set overrides.  Before any traffic the current set is kept.
        Returns the active hot id set."""
        if not self.hot_rows:
            raise ValueError("hot-row cache disabled (hot_rows=0)")
        if hot_ids is None:
            hot_ids = self.select_hot_ids()
            if hot_ids is None:
                return self._hot_ids       # no traffic observed yet
        hot_ids = np.asarray(hot_ids, np.int64)
        self.stats_.hot_refreshes += 1
        if np.array_equal(hot_ids, self._hot_ids):
            # steady state: the same set — skip the re-decode
            return self._hot_ids
        self._set_hot_rows(hot_ids)
        return self._hot_ids

    def _track(self, real_ids: torch.Tensor) -> None:
        """The EMA counters, on the device: ``freq *= decay; freq +=
        bincount(real ids)`` in float32, as the JAX engine computes them
        on the host (the counts are exact integers)."""
        vocab = self.emb.cfg.vocab_size
        if self._freq is None:
            self._freq = torch.zeros(vocab, dtype=torch.float32,
                                     device=self.device)
        self._freq.mul_(self.hot_ema_decay)
        self._freq.add_(torch.bincount(real_ids, minlength=vocab).float())
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            self._freq_event = event

    # --------------------------------------------------------- serve
    def _coerce_host(self, ids) -> np.ndarray:
        arr = np.asarray(ids, np.int32).reshape(-1)
        vocab = self.emb.cfg.vocab_size
        if arr.size and (arr.min() < 0 or arr.max() >= vocab):
            raise ValueError(f"request ids must lie in [0, {vocab}), got "
                             f"[{arr.min()}, {arr.max()}]")
        return arr

    def _stage(self, flat: np.ndarray):
        # with the cache on, the split is host work inside the timed
        # window (``_run``), and the upload follows it
        hot = self._hot
        return hot, flat if hot is not None else self._upload(flat)

    def split_flush(self, flat: np.ndarray, n_valid: int,
                    slot_map: np.ndarray) -> tuple:
        """The host half of a cached flush: ``(buf, hits, n_cold)``.
        ``buf`` (int32) holds, back to back, each position's cache slot
        (padding pointed at slot 0), and when any id is cold each
        position's rank among the cold ids and the cold ids padded to
        ``pad_multiple`` (n_cold of them, padding included), then, when
        the EMA counters are tracked, the real ids: everything the
        device needs, for ONE upload.  ``hits``: real ids cached."""
        # the clip mirrors the JAX engine's clamped ids
        flat = np.clip(flat, 0, self.emb.cfg.vocab_size - 1)
        slots = slot_map[flat]                     # (B,) int32, -1 = cold
        hits = int((slots[:n_valid] >= 0).sum())
        # flush padding is dropped after the flush: point it at cache
        # row 0 so it never forces decode work
        slots[n_valid:] = 0
        cold_mask = slots < 0
        n_cold = int(cold_mask.sum())
        parts = [slots]
        if n_cold:
            rank = np.maximum(np.cumsum(cold_mask) - 1, 0)
            cold = np.zeros(n_cold + (-n_cold) % self.pad_multiple,
                            np.int32)
            cold[:n_cold] = flat[cold_mask]    # zero ids are always valid
            parts += [rank, cold]
            n_cold = cold.size
        if self.hot_track_freq:
            parts.append(flat[:n_valid])
        return np.concatenate(parts).astype(np.int32, copy=False), hits, \
            n_cold

    def _run(self, staged, n_valid: int) -> torch.Tensor:
        hot, flat = staged
        if hot is None:
            self.stats_.decoded_lookups += int(flat.shape[0])
            return self.emb.serve(self.artifact, flat)
        block, slot_map, _ = hot
        buf, hits, n_cold = self.split_flush(flat, n_valid, slot_map)
        self.stats_.hot_hits += hits
        self.stats_.decoded_lookups += n_cold
        dev = self._upload(buf)
        b = flat.shape[0]
        slots = dev[:b]
        if self.hot_track_freq:
            self._track(dev[dev.shape[0] - n_valid:])
        if not n_cold:
            # wholly cache-served: a gather, no decode kernel
            return block.index_select(0, slots)
        rank, cold = dev[b:2 * b], dev[2 * b:2 * b + n_cold]
        cold_out = self.emb.serve(self.artifact, cold)
        # two O(B)-row gathers and a select: no scatter, no concatenate
        # (an O(C) copy of the block per flush)
        hot_rows = block.index_select(0, slots.clamp(min=0))
        cold_rows = cold_out.index_select(0, rank)
        return torch.where((slots >= 0)[:, None], hot_rows, cold_rows)

    def run_flat(self, flat: np.ndarray, n_valid: Optional[int] = None,
                 n_requests: int = 1):
        out = super().run_flat(flat, n_valid, n_requests=n_requests)
        # one refresh cadence for both front-ends: the queueing flush()
        # routes through here; the async front-end sets
        # hot_refresh_every=0 and refreshes on its own thread
        if (self._hot is not None and self.hot_refresh_every
                and self.stats_.flushes % self.hot_refresh_every == 0):
            self.refresh_hot_rows()
        return out

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

    Pass ``host_staged=True`` (or build the index with
    ``IndexConfig(host_staged=True)``) to keep the O(corpus) list
    tables in HOST memory, pinned on the card's host: every flush
    stages only the probed lists to the device
    (``Index.search_host_staged``, one upload on the current stream) —
    upload ∝ B·nprobe·cap a flush, corpus-independent.  Single device
    only: ``mesh`` (a distributed corpus) raises, naming its slice in
    ROADMAP.md.
    """

    def __init__(self, index, artifact: dict, k: int,
                 block_q: int = 64, max_queue: int = 4096, mesh=None,
                 host_staged: Optional[bool] = None, device="cuda"):
        if host_staged is None:
            host_staged = index.cfg.host_staged
        if host_staged:
            if mesh is not None:
                raise ValueError(
                    "host_staged serving is single-device; a sharded "
                    "corpus already bounds per-device bytes")
            if not index.supports_host_staged:
                raise ValueError(
                    f"index kind {index.cfg.kind!r} has no host-staged "
                    f"serve path")
        if mesh is not None:
            raise NotImplementedError(
                "a retrieval mesh (sharded corpus) waits for the "
                "distributed slice in ROADMAP.md")
        self.index, self.k = index, k
        self.block_q = block_q
        self.host_staged = bool(host_staged)
        device = resolve_device(device)
        super().__init__(pad_multiple=block_q, max_queue=max_queue,
                         device=device)
        # device-resident once; requests only ship (B, d) f32 queries.
        # Host-staged: the host leaves stay on the CPU (pinned, for the
        # flushes' uploads), the small ones (coarse table, codebooks)
        # go to the device
        host = set(index.host_leaves()) if self.host_staged else set()
        self.artifact = {name: self._place(leaf, name in host)
                         for name, leaf in artifact.items()}

    def _place(self, leaf, on_host: bool) -> torch.Tensor:
        leaf = torch.as_tensor(leaf)
        if not on_host:
            return leaf.to(self.device)
        leaf = leaf.cpu()
        return leaf.pin_memory() if self.device.type == "cuda" else leaf

    @property
    def staged_mbytes(self) -> float:
        """Total MB staged to the device so far (host-staged mode)."""
        return float(getattr(self.index, "staged_bytes", 0)) / 1e6

    def _coerce_host(self, queries) -> np.ndarray:
        q = np.asarray(queries, np.float32)
        return q[None] if q.ndim == 1 else q

    def _run(self, flat: torch.Tensor, n_valid: int):
        if self.host_staged:
            return self.index.search_host_staged(self.artifact, flat, self.k)
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
                 requests: Sequence[np.ndarray],
                 reset_freq: bool = False) -> EngineStats:
    """Drive ``requests`` through the engine twice and return the stats
    of the second pass: the first builds the kernels and warms every
    padded shape, so the returned stats hold no build or first-launch
    time.  ``reset_freq`` also zeroes a ServingEngine's EMA counters
    between the passes."""
    engine.serve_stream(requests)          # warm pass
    engine.stats_ = EngineStats()
    if reset_freq and getattr(engine, "_freq", None) is not None:
        engine._freq.zero_()
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
    ids over the frequency-sorted vocabulary — the head-heavy traffic
    the hot-row cache exists for — warm pass first.  The EMA counters
    are zeroed with the stats, so the measured pass starts clean."""
    from repro_torch.data.synthetic import zipf_request_stream
    return drive_stream(engine, zipf_request_stream(
        vocab_size, n_requests, req_batch, zipf_a=zipf_a, seed=seed),
        reset_freq=True)


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
    if cfg.model in ("bst", "two_tower"):     # the item table, as in JAX
        return field_embedding_config(cfg, cfg.n_items)
    return field_embedding_config(cfg, max(cfg.field_vocab_sizes))


__all__ = ["EngineStats", "RetrievalEngine", "ServingEngine",
           "drive_random_query_stream", "drive_random_stream",
           "drive_stream", "drive_zipf_stream", "embedding_config_of_arch",
           "random_requests"]
