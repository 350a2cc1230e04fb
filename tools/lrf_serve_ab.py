"""lrf's served rows two ways, on the card: the matmul ``u[ids] @ v``
(the serve path before it was made independent of the batch) and
``baselines.lrf_serving_lookup`` (a fixed-order rank sum).

    python3 tools/lrf_serve_ab.py

At deepfm's largest field (10M rows, d = 10, rank 2 as
``field_embedding_config`` gives it), drives ``ServingEngine`` over
``chip_smoke.py``'s stream (200 requests of 1..64 ids, max_queue 4,096)
with each serve path in turns (matmul, sum, sum, matmul), a warm pass
and then the best of five measured passes each, and prints lookups/s
beside the card's name and power limit; then, for rank 2 and a rank of
64 at d = 64, whether each formulation gives a row the same bits at B =
1 as at B = 4,096.  Needs one card; exits 2 without one.
"""
from __future__ import annotations

import dataclasses
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))
sys.path.insert(1, REPO)


def matmul_serve(artifact, ids, cfg):
    from repro_torch.core import baselines
    return baselines.lrf_lookup(artifact, ids, cfg)[0]


def engine_rate(emb, art, reqs, serve) -> float:
    """Best lookups/s of five measured passes, ``serve`` in place of the
    scheme's."""
    from repro_torch.launch.engine import EngineStats, ServingEngine
    eng = ServingEngine(emb, art, max_queue=4096)
    eng.emb.scheme.serve = lambda a, i: serve(a, i, eng.emb.cfg)
    eng.serve_stream(reqs)
    best = 0.0
    for _ in range(5):
        eng.stats_ = EngineStats()
        best = max(best, eng.serve_stream(reqs).lookups_per_s)
    return best


def batch_free(serve, cfg, art, ids) -> bool:
    """Rows 0, 1 and the last of ``ids`` equal at B = 1 and B = len."""
    import torch
    many = serve(art, ids, cfg)
    return all(torch.equal(serve(art, ids[i:i + 1], cfg), many[i:i + 1])
               for i in (0, 1, len(ids) - 1))


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("lrf_serve_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.configs import get_arch
    from repro_torch.core import Embedding, EmbeddingConfig, baselines
    from repro_torch.launch.engine import (embedding_config_of_arch,
                                           random_requests)

    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    _, cfg = get_arch("deepfm", smoke=False)
    ecfg = embedding_config_of_arch(
        "recsys", dataclasses.replace(cfg, embed_kind="lrf"))
    emb = Embedding(ecfg)
    art = emb.export(emb.init(emb.generator(0)))
    reqs = random_requests(ecfg.vocab_size, chip_smoke.N_REQUESTS,
                           chip_smoke.REQ_BATCH)
    fixed = baselines.lrf_serving_lookup
    rates = {"matmul": [], "sum": []}
    for name in ("matmul", "sum", "sum", "matmul"):
        serve = matmul_serve if name == "matmul" else fixed
        rates[name].append(engine_rate(emb, art, reqs, serve))
    print(f"lrf engine, deepfm field vocab={ecfg.vocab_size} d={ecfg.dim} "
          f"rank={ecfg.rank}: matmul serve {rates['matmul']} lookups/s, "
          f"fixed-order sum {rates['sum']} lookups/s [{card}]")
    for vocab, dim, rank in ((ecfg.vocab_size, ecfg.dim, ecfg.rank),
                             (50_000, 64, 64)):
        c = EmbeddingConfig(vocab_size=vocab, dim=dim, kind="lrf", rank=rank)
        e = Embedding(c)
        a = e.export(e.init(e.generator(1)))
        ids = torch.from_numpy(np.random.default_rng(1).integers(
            0, vocab, 4096)).cuda()
        print(f"rank {rank}, d={dim}: a row's bits the same at B = 1 and "
              f"B = 4,096: matmul {batch_free(matmul_serve, c, a, ids)}, "
              f"fixed-order sum {batch_free(fixed, c, a, ids)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
