"""Serving launcher: export a quantized artifact, then serve a stream of
batched requests through the micro-batching engine on the paper's
Figure-1 path (codes + centroids, full table discarded).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepfm \\
        --full --engine --requests 200 --req-batch 64

runs on the card and reports lookups/second; ``--device cpu`` runs the
same path on the CPU with the plain PyTorch ops.  Only the ``--engine``
path is ported; the LM, retrieval, async, hot-row and mesh paths of the
JAX package's CLI are later slices in ROADMAP.md.
"""
from __future__ import annotations

import argparse

from repro_torch.configs.registry import get_arch
from repro_torch.core.types import KERNEL_BACKENDS


def serve_engine(family, cfg, n_requests: int, req_batch: int,
                 backend=None, max_queue: int = 4096, zipf_a: float = 0.0,
                 device="cuda", seed: int = 0):
    """Request-stream demo of the micro-batching engine: N requests of
    random size <= req_batch against the arch's main embedding table.
    ``zipf_a`` > 1 switches the stream from uniform to power-law ids."""
    from repro_torch.core import Embedding
    from repro_torch.launch.engine import (ServingEngine, drive_random_stream,
                                           drive_zipf_stream,
                                           embedding_config_of_arch)
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
                           max_queue=max_queue, device=device)
    if zipf_a:
        st = drive_zipf_stream(engine, ecfg.vocab_size, n_requests,
                               req_batch, zipf_a=zipf_a)
    else:
        st = drive_random_stream(engine, ecfg.vocab_size, n_requests,
                                 req_batch)
    print(f"engine: {st.requests} requests / {st.lookups} lookups in "
          f"{st.flushes} flushes, {st.seconds:.6f}s on {engine.device} -> "
          f"{st.lookups_per_s:,.0f} lookups/s (block_b={engine.block_b}, "
          f"pad overhead "
          f"{100*(st.padded_lookups/st.lookups-1) if st.lookups else 0.0:.1f}%)")
    return st


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--engine", action="store_true",
                    help="drive the micro-batching ServingEngine (the "
                         "only ported serving path)")
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--req-batch", type=int, default=64)
    ap.add_argument("--zipf-a", type=float, default=0.0,
                    help="drive the engine with Zipf(a) power-law ids "
                         "instead of uniform (needs a > 1.0)")
    ap.add_argument("--kernel-backend", default=None,
                    choices=KERNEL_BACKENDS)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: the card; "
                         "'cpu' runs the plain PyTorch ops)")
    args = ap.parse_args(argv)

    if not args.engine:
        ap.error("only the --engine serving path is ported; pass --engine")
    if args.zipf_a and args.zipf_a <= 1.0:
        ap.error(f"--zipf-a must be > 1.0 (the truncated power law "
                 f"diverges at a <= 1), got {args.zipf_a}")
    family, cfg = get_arch(args.arch, smoke=args.smoke)
    return serve_engine(family, cfg, args.requests, args.req_batch,
                        backend=args.kernel_backend, zipf_a=args.zipf_a,
                        device=args.device)


if __name__ == "__main__":
    main()
