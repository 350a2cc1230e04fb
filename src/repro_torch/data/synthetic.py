"""Synthetic datasets, statistically matched to the paper's benchmarks.

The container is offline, so MovieLens-1M and the proprietary AAR set
are *regenerated*: interactions are drawn from a planted latent-factor
model with Zipf-distributed item popularity, which preserves the two
properties the paper's technique exploits — collaborative structure
(so models have signal to learn) and a power-law long tail (so MGQE's
frequency tiers matter).  Ids are frequency-sorted by construction
(id 0 = most popular), matching the framework convention.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np


def zipf_ids(rng: np.random.Generator, n: int, vocab: int,
             zipf_a: float) -> np.ndarray:
    """Truncated-power-law ids via inverse CDF, overflow-safe.

    ``zipf_a`` must be > 1.0: the inverse-CDF exponent is
    ``-1 / (zipf_a - 1)``, which diverges at 1.0 — there is no silent
    rescue to "some nearby distribution" (`not (a > 1)` also rejects
    NaN).
    """
    if not zipf_a > 1.0:
        raise ValueError(
            f"zipf_ids needs zipf_a > 1.0 (the truncated power law's "
            f"inverse CDF diverges at a <= 1.0), got {zipf_a}")
    u = rng.random(n)
    x = (1.0 - u) ** (-1.0 / (zipf_a - 1.0)) - 1.0
    x = np.minimum(x, float(vocab - 1))     # clip in float space (inf-safe)
    return x.astype(np.int64)


def open_loop_arrivals(rate_rps: float, duration_s: float = None,
                       n_requests: int = None, process: str = "poisson",
                       seed: int = 0) -> np.ndarray:
    """Arrival timestamps (seconds from stream start) for an OPEN-LOOP
    load generator: requests arrive on the generator's clock at a
    target ``rate_rps``, independent of how fast the server answers.

    A closed-loop driver (fire, wait, fire) implicitly slows its
    offered load whenever the server lags, so its measured latency
    hides exactly the queueing delay a latency SLO is about
    (coordinated omission); benchmarking "sustained throughput AT a
    p99" requires this open-loop shape
    (``launch/async_engine.drive_open_loop``).

    Exactly one of ``duration_s`` / ``n_requests`` sets the stream
    length (``duration_s`` implies ``round(rate_rps * duration_s)``
    requests — rate-driven, not count-driven).  ``process``:

    * ``"poisson"`` — i.i.d. exponential interarrivals (memoryless,
      the standard model of independent user traffic; bursts happen,
      which is what stresses a deadline-batched queue);
    * ``"deterministic"`` — fixed ``1/rate`` spacing (worst-case-free
      baseline; isolates service time from arrival burstiness).
    """
    if not rate_rps > 0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    if (duration_s is None) == (n_requests is None):
        raise ValueError("pass exactly one of duration_s / n_requests")
    if n_requests is None:
        n_requests = int(round(rate_rps * duration_s))
    if n_requests < 1:
        raise ValueError(
            f"stream is empty: rate {rate_rps}/s over {duration_s}s")
    if process == "poisson":
        rng = np.random.default_rng(seed)
        gaps = rng.exponential(1.0 / rate_rps, n_requests)
        return np.cumsum(gaps)
    if process == "deterministic":
        return (1.0 + np.arange(n_requests)) / rate_rps
    raise ValueError(f"unknown arrival process {process!r} "
                     f"(want 'poisson' or 'deterministic')")


def zipf_open_loop_stream(vocab: int, rate_rps: float, duration_s: float,
                          req_batch: int, zipf_a: float = 1.2,
                          process: str = "poisson", seed: int = 0
                          ) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Arrival-rate-driven power-law serving load: the open-loop
    arrival schedule of :func:`open_loop_arrivals` paired with
    Zipf(``zipf_a``) id batches of random size 1..``req_batch`` from
    :func:`zipf_request_stream`.  Returns ``(arrivals, requests)`` of
    equal length — the input :func:`launch.async_engine.drive_open_loop`
    replays against the async engine."""
    arrivals = open_loop_arrivals(rate_rps, duration_s=duration_s,
                                  process=process, seed=seed)
    requests = zipf_request_stream(vocab, len(arrivals), req_batch,
                                   zipf_a=zipf_a, seed=seed + 1)
    return arrivals, requests


def zipf_request_stream(vocab: int, n_requests: int, req_batch: int,
                        zipf_a: float = 1.2, seed: int = 0
                        ) -> List[np.ndarray]:
    """Power-law serving traffic: ``n_requests`` id batches of random
    size 1..``req_batch``, ids Zipf(``zipf_a``)-distributed over the
    frequency-sorted vocabulary (id 0 = hottest).  This is the request
    mix the ServingEngine's hot-row cache exists for — the head tier
    absorbs most lookups (``launch/engine.py::drive_zipf_stream``)."""
    rng = np.random.default_rng(seed)
    return [zipf_ids(rng, int(rng.integers(1, req_batch + 1)), vocab,
                     zipf_a)
            for _ in range(n_requests)]


# ----------------------------------------------------------------------
# MovieLens-1M-like implicit-feedback sequences
# ----------------------------------------------------------------------

@dataclasses.dataclass
class InteractionData:
    n_users: int
    n_items: int
    train_seqs: List[np.ndarray]     # per-user item sequence (time order)
    valid_item: np.ndarray           # (n_users,) withheld action
    test_item: np.ndarray            # (n_users,) withheld action
    item_counts: np.ndarray          # (n_items,) train popularity


def movielens_like(n_users: int = 6040, n_items: int = 3416,
                   mean_len: int = 96, latent_dim: int = 16,
                   zipf_a: float = 1.2, seed: int = 0) -> InteractionData:
    """~1M implicit-feedback interactions, 94%+ sparsity like ML-1M."""
    rng = np.random.default_rng(seed)
    # planted latent structure
    u_lat = rng.normal(size=(n_users, latent_dim)).astype(np.float32)
    i_lat = rng.normal(size=(n_items, latent_dim)).astype(np.float32)
    # popularity bias: Zipf over frequency-sorted ids
    pop = 1.0 / np.arange(1, n_items + 1) ** (zipf_a - 1.0)
    log_pop = np.log(pop / pop.sum())

    lens = np.clip(rng.geometric(1.0 / mean_len, size=n_users) + 4, 5,
                   min(600, n_items - 2))
    train_seqs, valid, test = [], np.zeros(n_users, np.int64), \
        np.zeros(n_users, np.int64)
    counts = np.zeros(n_items, np.int64)
    # score items per user: affinity + popularity; sample without replace
    for u in range(n_users):
        scores = i_lat @ u_lat[u] * 0.6 + log_pop * 2.0 \
            + rng.gumbel(size=n_items)
        take = int(lens[u])
        top = np.argpartition(-scores, take)[:take]
        seq = top[rng.permutation(take)]       # random temporal order
        train, v, t = seq[:-2], seq[-2], seq[-1]
        train_seqs.append(train.astype(np.int64))
        valid[u], test[u] = v, t
        np.add.at(counts, train, 1)
    # remap ids so that id order == popularity order (framework rule)
    order = np.argsort(-counts, kind="stable")
    remap = np.empty(n_items, np.int64)
    remap[order] = np.arange(n_items)
    train_seqs = [remap[s] for s in train_seqs]
    valid, test = remap[valid], remap[test]
    counts = counts[order]
    return InteractionData(n_users, n_items, train_seqs, valid, test, counts)


# ----------------------------------------------------------------------
# AAR-like item-to-item relevance pairs
# ----------------------------------------------------------------------

def aar_like(n_apps: int = 20000, n_pairs: int = 400000,
             latent_dim: int = 16, zipf_a: float = 1.3,
             seed: int = 1) -> Dict[str, np.ndarray]:
    """(app_a, app_b, score in [-100, 100]) relevance triples; 90/10
    train/eval split (paper §3.1)."""
    rng = np.random.default_rng(seed)
    lat = rng.normal(size=(n_apps, latent_dim)).astype(np.float32)
    p = 1.0 / np.arange(1, n_apps + 1) ** zipf_a
    p /= p.sum()
    a = rng.choice(n_apps, size=n_pairs, p=p)
    b = rng.choice(n_apps, size=n_pairs, p=p)
    sim = np.sum(lat[a] * lat[b], axis=1) / latent_dim ** 0.5
    score = np.clip(sim * 40 + rng.normal(scale=10, size=n_pairs), -100, 100)
    n_train = int(0.9 * n_pairs)
    return {
        "train_a": a[:n_train], "train_b": b[:n_train],
        "train_y": score[:n_train].astype(np.float32),
        "eval_a": a[n_train:], "eval_b": b[n_train:],
        "eval_y": score[n_train:].astype(np.float32),
        "n_apps": n_apps,
    }


# ----------------------------------------------------------------------
# Criteo-like CTR batches (AutoInt / DeepFM)
# ----------------------------------------------------------------------

def criteo_field_vocabs(n_sparse: int = 39) -> Tuple[int, ...]:
    """Power-law mix of field vocabularies, Criteo-style: a couple of
    huge id spaces, a middle band, and many small enum fields."""
    sizes = ([10_000_000] * 2 + [1_000_000] * 4 + [100_000] * 6
             + [10_000] * 9 + [1_000] * 9 + [100] * 9)
    if len(sizes) != 39:
        raise ValueError(f"criteo-style tier list has {len(sizes)} != 39 "
                         f"entries")
    return tuple(sizes[:n_sparse])


class CTRStream:
    """Infinite deterministic batch stream with a planted logistic
    teacher so CTR models have real signal to fit."""

    def __init__(self, vocab_sizes: Tuple[int, ...], batch: int,
                 zipf_a: float = 1.1, teacher_dim: int = 8, seed: int = 0,
                 start: int = 0):
        """``start`` > 0 begins at that batch of the stream, as if the
        batches before it had been drawn: each batch takes one uniform
        double per id and one per label, so the generator is advanced
        past them without drawing."""
        self.vocab_sizes = vocab_sizes
        self.batch = batch
        self.rng = np.random.default_rng(seed)
        self.rng.bit_generator.advance(
            start * batch * (len(vocab_sizes) + 1))
        self.zipf_a = zipf_a
        t_rng = np.random.default_rng(seed + 1)
        # hashed teacher embeddings (cheap for 10M vocabs)
        self.teacher = [t_rng.normal(size=(min(v, 4096), teacher_dim))
                        .astype(np.float32) for v in vocab_sizes]
        self.w = t_rng.normal(size=(len(vocab_sizes), teacher_dim)) \
            .astype(np.float32)

    def _sample_ids(self, vocab: int, n: int) -> np.ndarray:
        return zipf_ids(self.rng, n, vocab, self.zipf_a)

    def next_batch(self) -> Dict[str, np.ndarray]:
        ids = np.stack([self._sample_ids(v, self.batch)
                        for v in self.vocab_sizes], axis=1)   # (B, F)
        logit = np.zeros(self.batch, np.float32)
        for f in range(ids.shape[1]):
            e = self.teacher[f][ids[:, f] % self.teacher[f].shape[0]]
            logit += e @ self.w[f]
        p = 1.0 / (1.0 + np.exp(-(logit * 0.5 - 1.0)))
        label = (self.rng.random(self.batch) < p).astype(np.float32)
        return {"sparse_ids": ids, "label": label}

    def __iter__(self):
        while True:
            yield self.next_batch()


# ----------------------------------------------------------------------
# Two-tower retrieval interactions
# ----------------------------------------------------------------------

class RetrievalStream:
    def __init__(self, n_users: int, n_items: int, batch: int,
                 zipf_a: float = 1.2, seed: int = 0):
        self.n_users, self.n_items, self.batch = n_users, n_items, batch
        self.rng = np.random.default_rng(seed)
        self.zipf_a = zipf_a
        # empirical item sampling probability for logQ correction
        idx = np.arange(1, n_items + 1, dtype=np.float64)
        p = idx ** -zipf_a
        self.item_p = (p / p.sum()).astype(np.float64)

    def next_batch(self) -> Dict[str, np.ndarray]:
        u = self.rng.integers(0, self.n_users, self.batch)
        i = zipf_ids(self.rng, self.batch, self.n_items, self.zipf_a)
        logq = np.log(self.item_p[i]).astype(np.float32)
        return {"user_ids": u, "item_ids": i, "item_logq": logq}


# ----------------------------------------------------------------------
# BST behavior sequences
# ----------------------------------------------------------------------

class BehaviorSeqStream:
    def __init__(self, n_items: int, seq_len: int, batch: int,
                 zipf_a: float = 1.2, latent_dim: int = 8, seed: int = 0):
        self.n_items, self.seq_len, self.batch = n_items, seq_len, batch
        self.rng = np.random.default_rng(seed)
        self.zipf_a = zipf_a
        t_rng = np.random.default_rng(seed + 1)
        self.lat = t_rng.normal(size=(min(n_items, 8192), latent_dim)) \
            .astype(np.float32)

    def next_batch(self) -> Dict[str, np.ndarray]:
        b, l = self.batch, self.seq_len
        ids = zipf_ids(self.rng, b * (l + 1), self.n_items,
                       self.zipf_a).reshape(b, l + 1)
        hist, target = ids[:, :l], ids[:, l]
        h_lat = self.lat[hist % self.lat.shape[0]].mean(axis=1)
        t_lat = self.lat[target % self.lat.shape[0]]
        logit = np.sum(h_lat * t_lat, axis=1) * 2.0
        p = 1.0 / (1.0 + np.exp(-logit))
        label = (self.rng.random(b) < p).astype(np.float32)
        return {"hist_ids": hist, "target_id": target, "label": label}


# ----------------------------------------------------------------------
# PQ-structured retrieval corpus (recall benchmarks, DESIGN.md §8)
# ----------------------------------------------------------------------

def pq_clustered_corpus(n: int = 100_000, d: int = 64,
                        num_subspaces: int = 8, n_words: int = 16,
                        n_clusters: int = 64, p_mut: float = 0.25,
                        n_queries: int = 16, query_noise: float = 0.05,
                        seed: int = 0, cluster_zipf_a: float = 0.0
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Synthetic corpus for measuring retrieval recall vs the exact
    dense scan: (items (n, d) f32, queries (n_queries, d) f32).

    Items live exactly on a product code — per subspace each item takes
    one of ``n_words`` codeword sub-vectors — so a PQ codec with
    K >= ~4x n_words recovers the corpus losslessly and measured recall
    isolates the RETRIEVAL approximation (IVF probing), not quantizer
    noise.  Cluster structure for IVF comes from ``n_clusters``
    prototype tuples that items copy with per-subspace mutation prob
    ``p_mut``; code tuples are deduplicated (duplicates resampled
    uniformly) so top-k boundaries are not degenerate tie groups.
    Queries point along cluster prototypes plus noise — the
    concentrated-top-k regime IVF exists for.

    ``cluster_zipf_a`` > 1 draws cluster membership from the truncated
    power law instead of uniform — head clusters hold most of the
    corpus, the skew regime the bounded IVF list layout exists for
    (DESIGN.md §12).  0 (default) keeps cluster sizes uniform.
    """
    if d % num_subspaces:
        raise ValueError(
            f"dim {d} does not divide into {num_subspaces} subspaces")
    s = d // num_subspaces
    rng = np.random.default_rng(seed)
    books = rng.normal(size=(num_subspaces, n_words, s)).astype(np.float32)
    proto = rng.integers(0, n_words, (n_clusters, num_subspaces))
    if cluster_zipf_a:
        g = zipf_ids(rng, n, n_clusters, cluster_zipf_a)
    else:
        g = rng.integers(0, n_clusters, n)
    mut = rng.random((n, num_subspaces)) < p_mut
    code = np.where(mut, rng.integers(0, n_words, (n, num_subspaces)),
                    proto[g])
    # resample duplicates until every tuple is unique (a single pass
    # can re-collide; one residual duplicate at n=100k puts two
    # bit-identical scores on a top-k boundary and reads as recall loss)
    while True:
        _, first = np.unique(code, axis=0, return_index=True)
        if first.size == n:
            break
        dup = np.ones(n, bool)
        dup[first] = False
        code[dup] = rng.integers(0, n_words,
                                 (int(dup.sum()), num_subspaces))
    items = books[np.arange(num_subspaces)[None], code].reshape(n, d)
    qc = rng.integers(0, n_clusters, n_queries)
    qvec = books[np.arange(num_subspaces)[None], proto[qc]].reshape(
        n_queries, d)
    q = qvec / np.linalg.norm(qvec, axis=1, keepdims=True)
    q = q + query_noise * rng.normal(size=(n_queries, d))
    return items.astype(np.float32), q.astype(np.float32)
