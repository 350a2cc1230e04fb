"""Asynchronous latency-SLO serving front-end (DESIGN.md §10).

The synchronous engines (`launch/engine.py`) answer "how many lookups
per second can one call sustain"; production serving must answer "what
latency does a REQUEST see while traffic arrives on its own clock".
This module adds that layer: a dedicated flush thread owns the device
work, and submitters never touch it.

  * :class:`AsyncServingEngine` wraps a ``ServingEngine`` or a
    ``RetrievalEngine``.  ``submit()`` appends to a host-side queue and
    returns a ``Future`` at once; the flush thread runs the engine's
    ``run_flat`` and resolves the futures with numpy arrays.
  * **Deadline-based adaptive batching** — a flush fires when the queue
    holds a block of rows ("full") or when the oldest queued request has
    waited ``max_wait_us`` ("deadline"), whichever comes first.  The
    trigger is a pure state machine (:class:`FlushPolicy`), so tests
    drive it with a fake clock.
  * **Per-request latency** — submit to result, recorded into a
    :class:`~repro_torch.launch.latency.LatencyHistogram` on
    :class:`AsyncEngineStats`, which extends ``EngineStats`` with
    p50/p99/p999.
  * **Background hot-row refresh** — the EMA re-rank and the O(C) block
    re-decode run on a refresher thread; the new cache state is swapped
    in between flushes (``ServingEngine.prepare_hot_rows`` /
    ``install_hot_rows``).
  * :func:`drive_open_loop` replays an arrival schedule open-loop
    (submission times come from the generator's clock, not from
    completions), so the measured tail includes the queueing delay a
    closed-loop load generator would hide (coordinated omission).

On the card each thread owns a CUDA stream: every device step of a
flush (the pinned upload, the decode, the copy of the result to the
host) runs on the flush stream, the refresher decodes on its own, and
each waits on its own stream only.  A block decoded on the refresh
stream is marked as used by the flush stream (``record_stream``), so
the caching allocator does not hand its memory out while a flush may
read it, and the refresher orders its read of the EMA counters after
the flush stream's last update (an event).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.launch.engine import EngineStats, ServingEngine
from repro_torch.launch.latency import LatencyHistogram

__all__ = ["AsyncEngineStats", "AsyncServingEngine", "FlushPolicy",
           "drive_open_loop"]


class FlushPolicy:
    """Deadline-based adaptive-batching trigger, as a pure state
    machine over ``(pending rows, oldest submit time, now)``.

    The flush thread owns one instance; tests drive it directly with a
    fake clock.  Transitions:

      * ``on_submit(n_rows, now)`` — rows join the queue; the deadline
        clock starts when the queue goes non-empty.
      * ``decision(now, forced=False)`` — ``"full"`` when pending rows
        reach ``block_rows`` (a whole kernel block is ready: waiting
        longer adds latency but no batching efficiency), else
        ``"deadline"`` once the OLDEST request has waited
        ``max_wait_s``, else ``"drain"`` when a flush is being forced
        (drain/close), else ``None`` (keep waiting).  Full wins over
        deadline: the label records why the flush fired.
      * ``timeout(now)`` — how long the flush thread may sleep before
        the deadline can fire (None while the queue is empty).
      * ``on_flush(now)`` — the queue was taken; reset.
    """

    def __init__(self, block_rows: int, max_wait_s: float):
        if block_rows < 1:
            raise ValueError(f"block_rows must be >= 1, got {block_rows}")
        if not max_wait_s >= 0:
            raise ValueError(f"max_wait_s must be >= 0, got {max_wait_s}")
        self.block_rows = int(block_rows)
        self.max_wait_s = float(max_wait_s)
        self.rows = 0
        self.oldest: Optional[float] = None

    def on_submit(self, n_rows: int, now: float) -> None:
        if self.rows == 0:
            self.oldest = now
        self.rows += int(n_rows)

    def decision(self, now: float, forced: bool = False) -> Optional[str]:
        if self.rows <= 0:
            return None
        if self.rows >= self.block_rows:
            return "full"
        if now - self.oldest >= self.max_wait_s:
            return "deadline"
        if forced:
            return "drain"
        return None

    def timeout(self, now: float) -> Optional[float]:
        if self.rows <= 0:
            return None
        return max(0.0, self.oldest + self.max_wait_s - now)

    def on_flush(self, now: float) -> None:
        self.rows = 0
        self.oldest = None


@dataclasses.dataclass
class AsyncEngineStats(EngineStats):
    """``EngineStats`` plus the async front-end's request-level view.

    The wrapper installs ONE instance as the inner engine's ``stats_``,
    so the inherited counters (lookups, flushes, device ``seconds``,
    hot-cache hits) accumulate as in synchronous serving, and:

      * ``latency`` — submit->result histogram (one sample a request);
        ``p50_ms``/``p99_ms``/``p999_ms`` read it (NaN when empty);
      * ``flushes_full`` / ``flushes_deadline`` / ``flushes_drain`` —
        which trigger fired each flush (their sum == ``flushes``);
      * ``wall_seconds`` — open-loop stream wall time (set by
        :func:`drive_open_loop`), feeding ``sustained_lookups_per_s``.
    """
    submitted: int = 0
    flushes_full: int = 0
    flushes_deadline: int = 0
    flushes_drain: int = 0
    wall_seconds: float = 0.0
    latency: LatencyHistogram = dataclasses.field(
        default_factory=LatencyHistogram)

    @property
    def p50_ms(self) -> float:
        return self.latency.p50_ms

    @property
    def p99_ms(self) -> float:
        return self.latency.p99_ms

    @property
    def p999_ms(self) -> float:
        return self.latency.p999_ms

    @property
    def sustained_lookups_per_s(self) -> float:
        """Completed lookups over stream WALL time (queueing included)
        — the open-loop throughput a latency SLO is stated against."""
        return (self.lookups / self.wall_seconds
                if self.wall_seconds > 0 else 0.0)


class AsyncServingEngine:
    """Asynchronous front-end over a micro-batch engine.

    Parameters
    ----------
    engine:
        A ``ServingEngine`` or ``RetrievalEngine``.  The wrapper becomes
        its only caller; its ``stats_`` is replaced with a shared
        :class:`AsyncEngineStats`.
    max_wait_us:
        Deadline for the oldest queued request before a partial flush
        fires: 0 flushes every submit at once (smallest batches), large
        values converge on block-full batching.
    max_block_rows:
        Row threshold of the "full" trigger; defaults to the engine's
        ``pad_multiple`` (past it a flush pads to the next block anyway).
    refresh_every:
        When > 0 (a ``ServingEngine`` with a hot-row cache): every N
        flushes the refresher thread re-ranks the EMA counters,
        re-decodes the block off the flush path and swaps it in between
        flushes.  The engine's own in-flush refresh is turned off and
        its EMA tracking on.
    clock:
        Monotonic time source (injectable for deterministic tests).
    """

    def __init__(self, engine, max_wait_us: float = 1000.0,
                 max_block_rows: Optional[int] = None,
                 refresh_every: int = 0,
                 clock: Callable[[], float] = time.monotonic):
        if getattr(engine, "mesh", None) is not None:
            # deadlines fire per rank, and the refresher runs beside the
            # flushes: the ranks' collectives would not line up
            raise ValueError("the async front-end serves a single-device "
                             "engine; a mesh engine's ranks must flush "
                             "together")
        self.engine = engine
        self.clock = clock
        self.policy = FlushPolicy(
            block_rows=(engine.pad_multiple if max_block_rows is None
                        else max_block_rows),
            max_wait_s=float(max_wait_us) * 1e-6)
        self.stats_ = AsyncEngineStats()
        engine.stats_ = self.stats_      # shared: inner flush accumulates
        self.refresh_every = int(refresh_every)
        if self.refresh_every:
            if not (isinstance(engine, ServingEngine) and engine.hot_rows):
                raise ValueError(
                    "refresh_every needs a ServingEngine with a hot-row "
                    "cache (hot_rows > 0)")
            # the refresher owns the cadence: an in-flush refresh would
            # put the O(C) re-decode back on the flush path
            engine.hot_refresh_every = 0
            engine.hot_track_freq = True
        # one stream a thread on the card (None: the CPU has none)
        on_card = engine.device.type == "cuda"
        self._flush_stream = (torch.cuda.Stream(engine.device)
                              if on_card else None)
        self._refresh_stream = (torch.cuda.Stream(engine.device)
                                if on_card else None)
        if on_card:
            # both start after what was queued so far on the creator's
            # stream: the artifact's upload and the first hot block
            here = torch.cuda.current_stream(engine.device)
            self._flush_stream.wait_stream(here)
            self._refresh_stream.wait_stream(here)

        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)   # flush thread waits
        self._idle = threading.Condition(self._lock)   # drain/refresh wait
        self._pending: List[tuple] = []    # (request, Future, t_submit)
        self._inflight = False
        self._force = False
        self._stop = False
        self._flusher = threading.Thread(
            target=self._flush_loop, name="async-engine-flush", daemon=True)
        self._refresh_evt = threading.Event()
        self._refresher = None
        if self.refresh_every:
            self._refresher = threading.Thread(
                target=self._refresh_loop, name="async-engine-refresh",
                daemon=True)
            self._refresher.start()
        self._flusher.start()

    @staticmethod
    def _on(stream):
        """Run the block's device work on ``stream`` (none on the CPU)."""
        return (torch.cuda.stream(stream) if stream is not None
                else contextlib.nullcontext())

    # ------------------------------------------------------------ submit
    def submit(self, request) -> Future:
        """Enqueue one request; returns a Future resolving to its result
        — numpy arrays, value-identical to what the synchronous
        engine's flush returns for the same request.  Never blocks on
        device work: a host coerce and a queue append."""
        arr = self.engine._coerce_host(request)
        fut: Future = Future()
        now = self.clock()
        with self._work:
            if self._stop:
                raise RuntimeError("AsyncServingEngine is closed")
            self._pending.append((arr, fut, now))
            self.policy.on_submit(arr.shape[0], now)
            self.stats_.submitted += 1
            self._work.notify()
        return fut

    def lookup(self, request, timeout: Optional[float] = None):
        """Synchronous convenience: ``submit(...).result()``."""
        return self.submit(request).result(timeout=timeout)

    @property
    def pending(self) -> int:
        with self._lock:
            return self.policy.rows

    # ------------------------------------------------------- flush thread
    def _flush_loop(self) -> None:
        while True:
            with self._work:
                reason = None
                while reason is None:
                    now = self.clock()
                    reason = self.policy.decision(
                        now, forced=self._force or self._stop)
                    if reason is None:
                        if self._stop:
                            return           # closed and drained
                        self._work.wait(self.policy.timeout(now))
                # take whole requests until a block's worth of rows is
                # reached, not the whole backlog: the padded shapes stay
                # a couple of warm sizes, and a backlog drains as a run
                # of steady-state flushes
                k, rows = 0, 0
                while (k < len(self._pending)
                       and rows < self.policy.block_rows):
                    rows += self._pending[k][0].shape[0]
                    k += 1
                batch, self._pending = self._pending[:k], self._pending[k:]
                if self._pending:
                    self.policy.rows -= rows
                    self.policy.oldest = self._pending[0][2]
                else:
                    self.policy.on_flush(self.clock())
                field = {"full": "flushes_full",
                         "deadline": "flushes_deadline",
                         "drain": "flushes_drain"}[reason]
                setattr(self.stats_, field,
                        getattr(self.stats_, field) + 1)
                self._inflight = True
            # device work OUTSIDE the lock, so submitters keep queueing:
            # the batch goes through the engine as ONE padded call — one
            # upload, one decode, one copy back — and each future gets
            # its slice of the host result
            err, results = None, []
            try:
                sizes = [arr.shape[0] for arr, _, _ in batch]
                flat = (batch[0][0] if len(batch) == 1 else
                        np.concatenate([arr for arr, _, _ in batch]))
                n_valid = int(flat.shape[0])
                with self._on(self._flush_stream):
                    out = self.engine.run_flat(flat, n_valid,
                                               n_requests=len(batch))
                    leaves = out if isinstance(out, tuple) else (out,)
                    host = [leaf[:n_valid].cpu().numpy() for leaf in leaves]
                offs = np.cumsum([0] + sizes)
                for i in range(len(sizes)):
                    res = tuple(h[offs[i]:offs[i + 1]] for h in host)
                    results.append(res if isinstance(out, tuple) else res[0])
            except BaseException as e:         # noqa: BLE001 — forwarded
                err = e
            done = self.clock()
            with self._idle:
                if err is None:
                    for _, _, t0 in batch:
                        self.stats_.latency.record(done - t0)
                self._inflight = False
                self._idle.notify_all()
            # resolve futures outside the lock (callbacks run here)
            if err is None:
                for (_, fut, _), res in zip(batch, results):
                    fut.set_result(res)
            else:
                for _, fut, _ in batch:
                    fut.set_exception(err)
            if (err is None and self.refresh_every
                    and self.stats_.flushes % self.refresh_every == 0):
                self._refresh_evt.set()

    # --------------------------------------------------- refresher thread
    def _refresh_loop(self) -> None:
        while True:
            self._refresh_evt.wait()
            self._refresh_evt.clear()
            if self._stop:
                return
            self._do_refresh()

    def _wait_idle(self) -> None:
        """Wait (holding ``_idle``) until no flush is in flight."""
        while self._inflight and not self._stop:
            self._idle.wait()

    def _do_refresh(self) -> None:
        """One background refresh: EMA re-rank, re-decode the block on
        the refresh stream, swap it in between flushes.  The counters
        are copied while no flush is in flight (their updates are on the
        flush stream); the decode runs unlocked beside flushes; the
        install waits for the flush in flight, if any."""
        eng, rs = self.engine, self._refresh_stream
        with self._idle:
            self._wait_idle()
            with self._on(rs):
                freq = eng.freq_snapshot()
            if rs is not None:
                rs.synchronize()     # the copy is done before a flush
        if freq is None:
            return                       # no traffic observed yet
        with self._on(rs):
            ids = eng.select_hot_ids(freq)
        with self._lock:
            self.stats_.hot_refreshes += 1
        if np.array_equal(ids, eng._hot_ids):
            return                       # steady state: skip the decode
        with self._on(rs):
            state = eng.prepare_hot_rows(ids)
        if rs is not None:
            rs.synchronize()
            # the flush stream reads the block from now on
            state[0].record_stream(self._flush_stream)
        with self._idle:
            self._wait_idle()
            eng.install_hot_rows(state)

    def refresh_now(self, wait: bool = False) -> None:
        """Trigger a background refresh now (testing/ops hook).  With
        ``wait=True`` it runs on the calling thread instead —
        deterministic, still off the flush path."""
        if not self.refresh_every and not (
                isinstance(self.engine, ServingEngine)
                and self.engine.hot_rows):
            raise ValueError("no hot-row cache to refresh")
        if wait:
            self._do_refresh()
        else:
            self._refresh_evt.set()

    # -------------------------------------------------------------- drain
    def drain(self, timeout: Optional[float] = None) -> bool:
        """Force-flush and block until every submitted request has
        resolved.  Returns False on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._idle:
            self._force = True
            self._work.notify_all()
            try:
                while self._pending or self._inflight:
                    left = (None if deadline is None
                            else deadline - time.monotonic())
                    if left is not None and left <= 0:
                        return False
                    self._idle.wait(left)
            finally:
                self._force = False
        return True

    # -------------------------------------------------------------- stats
    def stats(self) -> AsyncEngineStats:
        return self.stats_

    def reset_stats(self) -> None:
        """Fresh counters/histogram (e.g. after a warmup pass)."""
        with self._lock:
            self.stats_ = AsyncEngineStats()
            self.engine.stats_ = self.stats_

    # ------------------------------------------------------------ closing
    def close(self, timeout: Optional[float] = None) -> None:
        """Drain, then stop both threads.  Idempotent."""
        self.drain(timeout=timeout)
        with self._work:
            self._stop = True
            self._work.notify_all()
        self._refresh_evt.set()          # wake the refresher to exit
        self._flusher.join(timeout)
        if self._refresher is not None:
            self._refresher.join(timeout)

    def __enter__(self) -> "AsyncServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def drive_open_loop(engine: AsyncServingEngine,
                    requests: Sequence[np.ndarray],
                    arrivals: Sequence[float],
                    sleep: Callable[[float], None] = time.sleep,
                    timeout: Optional[float] = None,
                    futures: Optional[list] = None) -> AsyncEngineStats:
    """Replay an arrival schedule through the async engine, open-loop.

    ``arrivals[i]`` (seconds from stream start,
    ``data/synthetic.open_loop_arrivals``) is when ``requests[i]`` is
    submitted — on the generator's clock, never gated on completions.
    After the last submission the engine is drained; ``wall_seconds``
    covers first submit to drain complete, so
    ``sustained_lookups_per_s`` is the open-loop throughput.  A drain
    longer than ``timeout`` seconds raises TimeoutError.  ``futures``, a
    list, receives each request's Future in submit order."""
    if len(requests) != len(arrivals):
        raise ValueError(f"{len(requests)} requests vs {len(arrivals)} "
                         f"arrival times")
    clock = engine.clock
    t0 = clock()
    for req, due in zip(requests, arrivals):
        delay = due - (clock() - t0)
        if delay > 0:
            sleep(delay)
        fut = engine.submit(req)
        if futures is not None:
            futures.append(fut)
    if not engine.drain(timeout=timeout):
        raise TimeoutError(f"the stream did not drain in {timeout}s")
    st = engine.stats()
    st.wall_seconds += clock() - t0
    return st
