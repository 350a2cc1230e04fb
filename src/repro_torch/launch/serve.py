"""Serving launcher, four paths:

* ``--arch gemma3-4b`` / ``stablelm-3b``: the LM served on the paper's
  path — init, export of the MGQE token table (``dpq_assign``), prefill
  of a batch of prompts (above 1,024 tokens through the
  ``flash_attention`` kernel), then greedy decode (``serve_lm``);
* ``--engine``: export a quantized artifact, then serve a stream of
  batched requests through the micro-batching engine on the paper's
  Figure-1 path (codes + centroids, full table discarded); with
  ``--hot-rows C`` the engine keeps the C hottest rows decoded
  (``--hot-refresh N`` re-points them at observed traffic every N
  flushes), and with ``--async`` the stream arrives open-loop at
  ``--arrival-rate`` requests/s through the async front-end, which
  reports p50/p99/p999 against ``--slo-ms``;
* ``--arch two-tower-retrieval`` without ``--engine``: build a
  ``flat_pq`` index (or with ``--retrieval ivf_pq`` an IVF index of
  ``--nprobe`` probes, its list tables kept in host memory with
  ``--host-staged``) over the item tower's outputs and serve top-k
  retrieval for a stream of user batches through the RetrievalEngine;
* ``--arch deepfm`` / ``autoint`` / ``bst`` without ``--engine``: the
  CTR model itself — init, export its tables, score one batch
  (``serve_ctr``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepfm \\
        --full --engine --requests 200 --req-batch 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepfm \\
        --full --engine --hot-rows 1250000 --zipf-a 1.2 --async \\
        --arrival-rate 1000
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch two-tower-retrieval --full --candidates 1000000
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch two-tower-retrieval --retrieval ivf_pq --nprobe 8 \\
        --host-staged
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepfm \\
        --full --batch 4096
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b \\
        --full --batch 2 --prompt-len 4096 --decode-steps 16

run on the card and report lookups/second, queries/second or the
batch's time, or the prefill's seconds and decode tokens/s;
``--device cpu`` runs the same paths on the CPU with the plain PyTorch
ops.  The mesh paths of the JAX package's CLI are a later slice in
ROADMAP.md.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, List

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.core.types import KERNEL_BACKENDS
from repro_torch.kernels.dispatch import pinned_backend


@dataclasses.dataclass
class EngineRun:
    """What :func:`serve_engine` built and measured."""

    emb: Any
    artifact: dict
    engine: Any
    requests: List[np.ndarray]      # the stream, in submit order
    stats: Any                      # EngineStats of the measured pass


def serve_async_engine(engine, vocab_size: int, req_batch: int,
                       max_wait_us: float, arrival_rate: float,
                       slo_ms: float, duration_s: float, zipf_a: float,
                       hot_refresh: int = 0):
    """Open-loop latency demo of the async front-end (DESIGN.md §10):
    wrap the engine, replay a Zipf arrival schedule at ``arrival_rate``
    requests/s (a warm pass, then the measured one), report the hit
    rate, the latency percentiles and the SLO verdict.  Returns the
    measured pass's AsyncEngineStats."""
    from repro_torch.data.synthetic import zipf_open_loop_stream
    from repro_torch.launch.async_engine import (AsyncServingEngine,
                                                 drive_open_loop)
    arrivals, reqs = zipf_open_loop_stream(
        vocab_size, rate_rps=arrival_rate, duration_s=duration_s,
        req_batch=req_batch, zipf_a=zipf_a)
    with AsyncServingEngine(engine, max_wait_us=max_wait_us,
                            refresh_every=hot_refresh) as aeng:
        # warm pass: the kernels' first launches and every padded shape
        # before the measured pass
        drive_open_loop(aeng, reqs, arrivals)
        aeng.reset_stats()
        st = drive_open_loop(aeng, reqs, arrivals)
    offered = len(reqs) / arrivals[-1]
    print(f"async engine: {st.requests} requests ({st.lookups} lookups) "
          f"open-loop at {offered:,.0f} req/s over {st.wall_seconds:.3f}s "
          f"wall -> {st.sustained_lookups_per_s:,.0f} lookups/s sustained "
          f"on {engine.device}")
    print(f"  flush triggers: {st.flushes_full} block-full / "
          f"{st.flushes_deadline} deadline({max_wait_us:.0f}us) / "
          f"{st.flushes_drain} drain; device time {st.seconds:.6f}s of "
          f"{st.wall_seconds:.3f}s wall")
    if getattr(engine, "hot_rows", 0):
        print(f"  hot cache: hit rate {st.hit_rate:.1%}, "
              f"{st.decoded_lookups} rows decoded, {st.hot_refreshes} "
              f"refresh(es)")
    print(f"  latency p50 {st.p50_ms:.3f} ms | p99 {st.p99_ms:.3f} ms | "
          f"p999 {st.p999_ms:.3f} ms")
    ok = st.p99_ms <= slo_ms
    print(f"  SLO p99 <= {slo_ms:.1f} ms: {'MET' if ok else 'MISSED'}")
    return st


def serve_engine(family, cfg, n_requests: int, req_batch: int,
                 backend=None, max_queue: int = 4096, zipf_a: float = 0.0,
                 device="cuda", seed: int = 0, hot_rows: int = 0,
                 hot_refresh: int = 0, use_async: bool = False,
                 max_wait_us: float = 1000.0, arrival_rate: float = 500.0,
                 slo_ms: float = 5.0, duration_s: float = 2.0) -> EngineRun:
    """Request-stream demo of the micro-batching engine: N requests of
    random size <= req_batch against the arch's main embedding table
    (whichever scheme its ``embed_kind`` selects), a warm pass and then
    the measured one.  ``zipf_a`` > 1 switches the stream from uniform
    to power-law ids; ``hot_rows`` turns the hot-row cache on and
    ``hot_refresh`` re-points it every N flushes; ``use_async`` serves
    an open-loop stream through the async front-end instead
    (:func:`serve_async_engine`, whose stats the run then holds)."""
    from repro_torch.core import Embedding
    from repro_torch.data.synthetic import zipf_request_stream
    from repro_torch.launch.engine import (ServingEngine, drive_stream,
                                           embedding_config_of_arch,
                                           random_requests)
    ecfg = embedding_config_of_arch(family, cfg)
    emb = Embedding(ecfg, device=device)
    params = emb.init(emb.generator(seed))
    artifact = emb.export(params)
    del params                         # the full table is discarded
    full_bits = ecfg.vocab_size * ecfg.dim * 32
    print(f"engine table: kind={ecfg.kind} vocab={ecfg.vocab_size} "
          f"d={ecfg.dim}; artifact "
          f"{emb.serving_size_bits()/8/1e6:.2f} MB "
          f"({100*emb.serving_size_bits()/full_bits:.1f}% of full)")
    engine = ServingEngine(emb, artifact, backend=backend,
                           max_queue=max_queue, device=device,
                           hot_rows=hot_rows or None,
                           hot_refresh_every=hot_refresh)
    if engine.hot_rows:
        width = engine.emb.scheme.hot_dtype.itemsize
        print(f"hot-row cache: {engine.hot_rows} rows pre-decoded "
              f"({engine.hot_rows * ecfg.dim * width / 1e6:.2f} MB dense)"
              + (f", refresh every {hot_refresh} flushes"
                 if hot_refresh else ""))
    if use_async:
        st = serve_async_engine(engine, ecfg.vocab_size, req_batch,
                                max_wait_us=max_wait_us,
                                arrival_rate=arrival_rate, slo_ms=slo_ms,
                                duration_s=duration_s,
                                zipf_a=zipf_a or 1.2,
                                hot_refresh=hot_refresh if hot_rows else 0)
        return EngineRun(emb, artifact, engine, [], st)
    if zipf_a:
        reqs = zipf_request_stream(ecfg.vocab_size, n_requests, req_batch,
                                   zipf_a=zipf_a)
    else:
        reqs = random_requests(ecfg.vocab_size, n_requests, req_batch)
    st = drive_stream(engine, reqs, reset_freq=bool(zipf_a))
    print(f"engine: {st.requests} requests / {st.lookups} lookups in "
          f"{st.flushes} flushes, {st.seconds:.6f}s on {engine.device} -> "
          f"{st.lookups_per_s:,.0f} lookups/s (block_b={engine.block_b}, "
          f"pad overhead "
          f"{100*(st.padded_lookups/st.lookups-1) if st.lookups else 0.0:.1f}%)")
    if engine.hot_rows:
        print(f"hot cache: hit rate {st.hit_rate:.1%} "
              f"({st.hot_hits}/{st.lookups} lookups cache-served; "
              f"{st.decoded_lookups} rows through the decode kernel vs "
              f"{st.padded_lookups} without the cache; "
              f"{st.hot_refreshes} refresh(es))")
    # a copy: later flushes of the same engine keep adding to its stats
    return EngineRun(emb, artifact, engine, reqs, dataclasses.replace(st))


@dataclasses.dataclass
class RetrievalRun:
    """What :func:`serve_retrieval` built and measured."""

    model: Any
    params: dict
    index: Any
    artifact: dict
    engine: Any
    users: List[np.ndarray]         # the stream's user ids, per request
    requests: List[np.ndarray]      # their query vectors
    stats: Any                      # EngineStats of the measured pass
    recall: float
    build_seconds: float


def serve_retrieval(cfg, n_candidates: int, index_kind: str = "flat_pq",
                    nprobe: int = 8, topk: int = 100, n_requests: int = 50,
                    req_batch: int = 16, backend=None,
                    host_staged: bool = False, device="cuda",
                    seed: int = 0) -> RetrievalRun:
    """Top-k candidate retrieval through the index registry and the
    micro-batching RetrievalEngine: build the index over the item
    tower's outputs for ``n_candidates`` items, stream ``n_requests``
    batches of 1..``req_batch`` users through the engine (a warm pass,
    then the measured one), and measure recall@``topk`` against the
    exact dense scan.  An IVF index gets ``nlist = suggest_nlist(n,
    nprobe)``; ``host_staged`` keeps its list tables in host memory and
    stages only the probed lists a flush."""
    from repro_torch.core.api import resolve_device
    from repro_torch.launch.engine import RetrievalEngine, drive_stream
    from repro_torch.models.recsys.two_tower import TwoTower
    from repro_torch.retrieval import IndexConfig, suggest_nlist

    device = resolve_device(device)
    model = TwoTower(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(seed))
    n = min(n_candidates, cfg.n_items)
    item_ids = torch.arange(n, device=device)
    # nlist ~ sqrt(N) balances probed work against list length
    nlist = suggest_nlist(n, nprobe)
    icfg = IndexConfig(kind=index_kind, num_subspaces=8, num_centroids=64,
                       nlist=nlist, nprobe=min(nprobe, nlist),
                       kernel_backend=backend)

    # offline: build the index over the PQ-coded candidate tower outputs
    t0 = time.perf_counter()
    index, artifact = model.build_index(
        torch.Generator(device=device).manual_seed(seed + 1), params,
        item_ids, icfg)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t0
    code_mb = sum(artifact[name].numel() * artifact[name].element_size()
                  for name in index.rows_leaves) / 1e6
    detail = index.describe()
    print(f"{index_kind} index built in {build_s:.1f}s: {code_mb:.1f} MB "
          f"corpus rows vs {n * cfg.tower_mlp[-1] * 4 / 1e6:.1f} MB dense"
          + (f" ({detail})" if detail else ""))

    # online: stream user batches through the engine; top-k ids + scores
    engine = RetrievalEngine(index, artifact, k=topk, block_q=16,
                             host_staged=host_staged, device=device)
    rng = np.random.default_rng(0)
    users = [rng.integers(0, cfg.n_users, int(rng.integers(1, req_batch + 1)))
             for _ in range(n_requests)]
    reqs = [model.user_vec(params, torch.from_numpy(u).to(device))[0]
            .cpu().numpy() for u in users]
    st = drive_stream(engine, reqs)            # warm pass, then measured
    print(f"engine: {st.requests} requests / {st.lookups} queries in "
          f"{st.flushes} flushes, {st.seconds:.6f}s on {device} -> "
          f"{st.lookups_per_s:,.0f} queries/s x top-{topk}")
    if host_staged:
        print(f"host-staged: {engine.staged_mbytes:.2f} MB staged over "
              f"{st.flushes * 2} flushes (warm+measured) vs "
              f"{code_mb:.1f} MB device-resident")

    # recall vs the exact dense scan, one probe batch
    probe = torch.arange(8, device=device)
    _, ids = model.retrieval_topk(params, index, artifact, probe, topk)
    cand_vecs = model.encode_items(params, item_ids)
    u8, _ = model.user_vec(params, probe)
    ex = torch.topk(u8 @ cand_vecs.T, min(topk, n), dim=1).indices.cpu()
    ids = ids.cpu()
    rec = float(np.mean([len(set(ids[b].tolist()) & set(ex[b].tolist()))
                         / topk for b in range(8)]))
    print(f"recall@{topk} vs exact dense scan: {rec:.3f}")
    # a copy: later flushes of the same engine keep adding to its stats
    return RetrievalRun(model, params, index, artifact, engine, users, reqs,
                        dataclasses.replace(st), rec, build_s)


# the models ``serve_ctr`` scores
CTR_MODELS = ("autoint", "bst", "deepfm")


@dataclasses.dataclass
class CTRRun:
    """What :func:`serve_ctr` built and scored."""

    model: Any
    params: dict
    # the field models' (deepfm, autoint): every field's serving
    # artifact, keyed as the fields; bst's: the item table's artifact
    artifacts: dict
    # on the device: {"sparse_ids": (B, F)} for the field models,
    # {"hist_ids": (B, seq_len), "target_id": (B,)} for bst
    batch: dict
    scores: torch.Tensor            # (B,) logits
    seconds: float                  # the scoring call, synchronised
    serving_bits: int               # the artifacts' size
    full_bits: int                  # the same tables in float32


def serve_ctr(cfg, batch: int, device="cuda", sparse_ids=None) -> CTRRun:
    """A CTR model served as the paper serves it: init, export (the
    large tables to codes + centroids through ``dpq_assign``; the full
    tables of the small fields and deepfm's first-order tables stay),
    then score one batch through ``model.serve`` (``mgqe_decode`` once
    per quantized table).  The batch's ids are drawn as the JAX
    package's ``serve_ctr`` draws them from numpy seed 0: for bst a
    uniform history (batch, seq_len) and target (batch,) over the
    items, for the field models uniform ids per field, unless
    ``sparse_ids`` (batch, fields) is given."""
    from repro_torch.core.api import resolve_device
    from repro_torch.launch.cells import recsys_model

    if cfg.model not in CTR_MODELS:
        raise ValueError(f"serve_ctr serves {', '.join(CTR_MODELS)}, not "
                         f"{cfg.model!r}")
    device = resolve_device(device)
    model = recsys_model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    rng = np.random.default_rng(0)
    if cfg.model == "bst":
        if sparse_ids is not None:
            raise ValueError("bst takes no sparse_ids: it serves an item "
                             "history and a target")
        artifacts = model.item_emb.export(params["item_emb"])
        b = {"hist_ids": rng.integers(0, cfg.n_items, (batch, cfg.seq_len)),
             "target_id": rng.integers(0, cfg.n_items, batch)}
        size_bits = model.item_emb.serving_size_bits()
        full_bits = cfg.n_items * cfg.embed_dim * 32
    else:
        artifacts = model.fields.export(params["fields"])
        if sparse_ids is None:
            sparse_ids = np.stack([rng.integers(0, v, batch)
                                   for v in cfg.field_vocab_sizes], 1)
        if tuple(sparse_ids.shape) != (batch, len(cfg.field_vocab_sizes)):
            raise ValueError(f"sparse_ids must be (batch, fields) = "
                             f"{(batch, len(cfg.field_vocab_sizes))}, got "
                             f"{tuple(sparse_ids.shape)}")
        b = {"sparse_ids": sparse_ids}
        size_bits = model.fields.serving_size_bits()
        full_bits = model.fields.full_size_bits()
    b = {k: torch.as_tensor(v).to(device) for k, v in b.items()}
    _sync(device)
    t0 = time.perf_counter()
    scores = model.serve(params, artifacts, b)
    _sync(device)
    seconds = time.perf_counter() - t0
    print(f"served B={batch} in {seconds:.6f}s on {device}; scores mean "
          f"{float(torch.mean(scores)):.4f}; artifacts "
          f"{size_bits / 8e6:.2f} MB ({100 * size_bits / full_bits:.1f}% "
          f"of full)")
    return CTRRun(model, params, artifacts, b, scores, seconds, size_bits,
                  full_bits)


@dataclasses.dataclass
class LMRun:
    """What :func:`serve_lm` built, served and measured."""

    params: dict
    artifact: dict                  # the token table's codes + centroids
    prompts: torch.Tensor           # (B, prompt_len) int32
    logits: torch.Tensor            # (B, V) f32, the prefill's last token
    tokens: torch.Tensor            # (B, decode_steps + 1) greedy tokens
    prefill_seconds: float
    decode_seconds: float

    @property
    def tokens_per_s(self) -> float:
        b, n = self.tokens.shape
        return b * (n - 1) / self.decode_seconds if self.decode_seconds \
            else 0.0


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_lm(cfg, batch: int, prompt_len: int, decode_steps: int,
             device="cuda", seed: int = 0) -> LMRun:
    """An LM served as the paper serves its vocabulary: init, export
    the token table to codes + centroids (the full table is not read
    again), prefill ``batch`` prompts of ``prompt_len`` random tokens
    (numpy seed 0, as the JAX package draws them), then
    ``decode_steps`` greedy steps against the KV cache."""
    from repro_torch.core import Embedding
    from repro_torch.core.api import resolve_device
    from repro_torch.models import lm

    device = resolve_device(device)
    params = lm.model_init(torch.Generator(device=device).manual_seed(seed),
                           cfg)
    emb = Embedding(cfg.embedding, device=device)
    with torch.no_grad():
        artifact = emb.export(params["embed"])
    full_bits = cfg.embedding.vocab_size * cfg.embedding.dim * 32
    print(f"embedding artifact: {emb.serving_size_bits()/8/1e6:.2f} MB "
          f"({100*emb.serving_size_bits()/full_bits:.1f}% of full)")

    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)).to(device)
    max_seq = prompt_len + decode_steps

    with torch.no_grad():
        _sync(device)
        t0 = time.perf_counter()
        cache, logits = lm.prefill(params, prompts, cfg, max_seq=max_seq,
                                   embed_artifact=artifact)
        _sync(device)
        prefill_s = time.perf_counter() - t0
        print(f"prefill: {prefill_s:.6f}s; logits {tuple(logits.shape)}")

        tok = torch.argmax(logits, -1).to(torch.int32)
        out = [tok]
        t0 = time.perf_counter()
        for _ in range(decode_steps):
            cache, step_logits = lm.decode_step(params, cache, tok, cfg,
                                                embed_artifact=artifact)
            tok = torch.argmax(step_logits, -1).to(torch.int32)
            out.append(tok)
        _sync(device)
        decode_s = time.perf_counter() - t0
    run = LMRun(params, artifact, prompts, logits, torch.stack(out, 1),
                prefill_s, decode_s)
    print(f"decoded {decode_steps} steps x B={batch} in {decode_s:.6f}s "
          f"({run.tokens_per_s:.1f} tok/s) on {device}; sample: "
          f"{run.tokens[0, :8].tolist()}")
    return run


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--engine", action="store_true",
                    help="drive the micro-batching ServingEngine")
    ap.add_argument("--candidates", type=int, default=10000,
                    help="two-tower retrieval: items in the index")
    ap.add_argument("--retrieval", default="flat_pq",
                    help="retrieval index kind for two-tower serving "
                         "(flat_pq | ivf_pq)")
    ap.add_argument("--nprobe", type=int, default=8,
                    help="ivf_pq: coarse lists probed per query")
    ap.add_argument("--topk", type=int, default=100,
                    help="candidates returned per retrieval query")
    ap.add_argument("--host-staged", action="store_true",
                    help="retrieval: keep the list tables in host memory, "
                         "staging probed lists per flush (ivf_pq)")
    ap.add_argument("--batch", type=int, default=4,
                    help="CTR serving: rows in the scored batch; LM "
                         "serving: prompts")
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="LM serving: tokens per prompt")
    ap.add_argument("--decode-steps", type=int, default=16,
                    help="LM serving: greedy decode steps")
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--req-batch", type=int, default=64)
    ap.add_argument("--zipf-a", type=float, default=0.0,
                    help="drive the engine with Zipf(a) power-law ids "
                         "instead of uniform (needs a > 1.0)")
    ap.add_argument("--hot-rows", type=int, default=0,
                    help="pre-decode this many head rows into the "
                         "engine's hot-row cache (0 = off)")
    ap.add_argument("--hot-refresh", type=int, default=0,
                    help="re-point the hot cache at observed traffic "
                         "every N flushes (0 = static head-id set)")
    ap.add_argument("--async", dest="use_async", action="store_true",
                    help="serve through the AsyncServingEngine front-end: "
                         "open-loop arrivals, deadline-batched flushes, "
                         "p50/p99/p999 against --slo-ms")
    ap.add_argument("--max-wait-us", type=float, default=1000.0,
                    help="async: flush deadline — a partial batch fires "
                         "once its oldest request has waited this long")
    ap.add_argument("--arrival-rate", type=float, default=500.0,
                    help="async: open-loop offered load, requests/second "
                         "(Poisson interarrivals)")
    ap.add_argument("--slo-ms", type=float, default=5.0,
                    help="async: p99 latency SLO the report is judged "
                         "against")
    ap.add_argument("--duration", type=float, default=2.0,
                    help="async: measured stream length in seconds")
    ap.add_argument("--kernel-backend", default=None,
                    choices=KERNEL_BACKENDS,
                    help="backend of the embedding ops (LM: of every op "
                         "of the run)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: the card; "
                         "'cpu' runs the plain PyTorch ops)")
    args = ap.parse_args(argv)

    if args.zipf_a and args.zipf_a <= 1.0:
        ap.error(f"--zipf-a must be > 1.0 (the truncated power law "
                 f"diverges at a <= 1), got {args.zipf_a}")
    if args.host_staged and args.engine:
        ap.error("--host-staged applies to the retrieval serving path, "
                 "not --engine")
    if (args.hot_rows or args.hot_refresh or args.use_async) \
            and not args.engine:
        ap.error("--hot-rows/--hot-refresh/--async require --engine")
    if args.hot_refresh and not args.hot_rows:
        ap.error("--hot-refresh needs a cache to refresh; pass "
                 "--hot-rows N")
    if args.use_async and args.arrival_rate <= 0:
        ap.error(f"--arrival-rate must be > 0 (open-loop load is "
                 f"rate-driven), got {args.arrival_rate}")
    family, cfg = get_arch(args.arch, smoke=args.smoke)
    if args.engine:
        return serve_engine(family, cfg, args.requests, args.req_batch,
                            backend=args.kernel_backend, zipf_a=args.zipf_a,
                            device=args.device, hot_rows=args.hot_rows,
                            hot_refresh=args.hot_refresh,
                            use_async=args.use_async,
                            max_wait_us=args.max_wait_us,
                            arrival_rate=args.arrival_rate,
                            slo_ms=args.slo_ms,
                            duration_s=args.duration).stats
    if family == "lm":
        if min(args.batch, args.prompt_len) < 1 or args.decode_steps < 0:
            ap.error("--batch and --prompt-len must be >= 1 and "
                     "--decode-steps >= 0")
        with pinned_backend(args.kernel_backend):
            return serve_lm(cfg, args.batch, args.prompt_len,
                            args.decode_steps, device=args.device)
    if cfg.model != "two_tower":
        if args.batch < 1:
            ap.error(f"--batch must be >= 1, got {args.batch}")
        if args.kernel_backend:
            cfg = dataclasses.replace(cfg, kernel_backend=args.kernel_backend)
        try:
            return serve_ctr(cfg, args.batch, device=args.device)
        except ValueError as e:             # a model serve_ctr does not serve
            ap.error(str(e))
    from repro_torch.retrieval import index_class, registered_index_kinds
    if args.retrieval not in registered_index_kinds():
        ap.error(f"unknown index kind {args.retrieval!r}; registered "
                 f"indexes: {', '.join(registered_index_kinds())}")
    if args.nprobe < 1:
        ap.error(f"--nprobe must be >= 1, got {args.nprobe}")
    if args.host_staged and not index_class(args.retrieval
                                            ).supports_host_staged:
        ap.error(f"index kind {args.retrieval!r} has no host-staged serve "
                 f"path")
    return serve_retrieval(cfg, args.candidates, index_kind=args.retrieval,
                           nprobe=args.nprobe, topk=args.topk,
                           backend=args.kernel_backend,
                           host_staged=args.host_staged, device=args.device)


if __name__ == "__main__":
    main()
