"""IVF-PQ — coarse k-means partition + per-list PQ codes, the
``ivf_pq`` index kind.

Cluster the corpus into ``nlist`` coarse cells and at query time score
only the ``nprobe`` most promising cells, reading ~``nprobe/nlist`` of
the code bytes the flat scan reads.  Probed candidates score by the
usual LUT summation; with ``ivf_residual=True`` the codes quantize
residuals against the cell centroid and the coarse dot product is
added back —

    score(i) = <q, c_coarse[list(i)]>  +  sum_d lut[d, codes[i, d]]

One LUT build per query (the codebook is global, so the LUT is shared
across probed lists); ``nprobe`` controls the recall/bytes dial.

Storage layout: probing must stay a dense gather, but padding every
list to the LONGEST list blows memory by the max/mean list ratio on
skewed corpora.  Lists are instead capped at the ``list_cap_quantile``
count quantile; rows past the cap spill into chained extension lists
appended after index ``nlist`` in the extended tables —

  ``list_codes (nlist_ext, cap, D)`` uint8,
  ``list_ids   (nlist_ext, cap)``   int32 (GLOBAL corpus ids,
                                          ``INVALID_ID`` padding),
  ``list_chain (nlist, max_chain)`` int32 — per base list, its full
      chain of extended-list ids (-1 padded); row 0 is the base list.

Probing gathers the (B, P) probed base lists' chains, then their slots
— (B, P, C, cap).  ``list_cap_quantile=1.0`` reproduces the
pad-to-max layout (max_chain == 1, no spill lists); ``nlist_ext`` is
padded with empty lists to a multiple of ``nlist``.  The build streams
through ``retrieval/build.py``.

The JAX package runs this path outside Pallas but for the corpus
encode (``dpq_assign``); here too the coarse fit, the assignment, the
probe and the top-k are plain ops.  The probed candidates are scored
by the ``pq_score_batched`` kernel: the U unique probed lists for all
B queries at once, then each query's (P, C, cap) positions gathered
from the (B, U·cap) scores.  That is bit-identical to the plain
version, each query's own probed rows gathered and summed
(``probed_scores_ref``), as both add ``lut[d, code[d]]`` for
d = 0..D-1 from +0.0; on an H100 it ran 1.6-2x faster than the plain
version at the JAX bench's retrieval scale and at two-tower's flush
(PERF.md §6, row 7).

The final top-k is ``topk_by_position`` over the flat (B, P·C·cap)
candidates: the position tiebreak in that (probe × chain × slot)
layout is what keeps host-staged and device search bit-identical.
"""
from __future__ import annotations

import time
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.pq_score import INVALID_ID, build_lut_batch
from repro_torch.retrieval import flat_pq
from repro_torch.retrieval.base import Index, IndexConfig, register_index
from repro_torch.retrieval.topk import _order_key, topk_by_position

# candidates (query x probed slot) one scoring pass materialises; a
# larger batch is searched in query chunks (each query's result does
# not depend on the others), so the (B, P·C·cap) temporaries stay
# ~0.13 GB each whatever the flush
CANDIDATE_CHUNK = 1 << 25

# rows x nlist of one coarse-assign step (float32: 256 MB); larger
# blocks are assigned in row chunks
ASSIGN_CHUNK_ELEMS = 1 << 26


def coarse_kmeans(gen: torch.Generator, vectors: torch.Tensor, nlist: int,
                  iters: int = 10) -> torch.Tensor:
    """Euclidean Lloyd's over full-width vectors -> (nlist, d) centers:
    the per-subspace k-means with ONE subspace of width d."""
    return flat_pq.fit_pq(gen, vectors, num_subspaces=1,
                          num_centroids=nlist, iters=iters)[0]


def coarse_assign(vectors: torch.Tensor, coarse: torch.Tensor) -> torch.Tensor:
    """Nearest coarse centroid per vector (euclidean), (N,) int32:
    ``argmin(|c|^2 - 2 x.c)``, the first minimum on ties.  Rows are
    independent, so a large block runs in row chunks."""
    c_sq = torch.sum(torch.square(coarse), dim=-1)        # (nlist,)
    n = vectors.shape[0]
    rows = max(1, ASSIGN_CHUNK_ELEMS // max(coarse.shape[0], 1))
    out = [torch.argmin(c_sq[None, :] - 2 * (vectors[r:r + rows]
                                             @ coarse.T), dim=-1)
           for r in range(0, n, rows)]
    if not out:
        return torch.zeros((0,), dtype=torch.int32, device=vectors.device)
    return torch.cat(out).to(torch.int32)


def bounded_list_layout(assign_np: np.ndarray, codes_np: np.ndarray,
                        nlist: int, cap_quantile: float) -> Dict:
    """Host-side bucketing into the quantile-capped chained layout.

    Returns host numpy ``{list_chain, list_codes, list_ids}`` (see the
    module docstring for shapes).  Within a base list, corpus ids
    ascend along the chain (stable sort)."""
    n = assign_np.shape[0]
    counts = np.bincount(assign_np, minlength=nlist)
    if cap_quantile >= 1.0:
        cap = max(int(counts.max()), 1)
    else:
        cap = max(int(np.ceil(np.quantile(counts, cap_quantile))), 1)
    chunks = np.maximum(1, -(-counts // cap))      # ceil; >= 1 per list
    max_chain = int(chunks.max())
    n_spill = int((chunks - 1).sum())
    # pad with empty lists to a multiple of nlist
    n_ext = -(-(nlist + n_spill) // nlist) * nlist
    spill_start = nlist + np.concatenate(
        [[0], np.cumsum(chunks - 1)[:-1]])
    chain = np.full((nlist, max_chain), -1, np.int32)
    chain[:, 0] = np.arange(nlist)
    for j in range(1, max_chain):
        has = chunks > j
        chain[has, j] = spill_start[has] + (j - 1)

    order = np.argsort(assign_np, kind="stable")   # ids ascend per list
    starts = np.zeros(nlist, np.int64)
    starts[1:] = np.cumsum(counts)[:-1]
    slot = np.arange(n) - starts[assign_np[order]]
    ext = chain[assign_np[order], slot // cap]     # extended-list row
    within = slot % cap
    n_sub = codes_np.shape[1]
    list_codes = np.zeros((n_ext, cap, n_sub), codes_np.dtype)
    list_ids = np.full((n_ext, cap), INVALID_ID, np.int32)
    list_codes[ext, within] = codes_np[order]
    list_ids[ext, within] = order
    return {"list_chain": chain, "list_codes": list_codes,
            "list_ids": list_ids}


def probed_scores_ref(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Each query's own rows: luts (B, D, K) f32, codes (B, M, D)
    uint8/int32 -> scores (B, M), ``sum_d lut[b, d, codes[b, m, d]]``
    added for d = 0..D-1 from +0.0 (the order ``pq_score_batched``
    adds in).  Codes are widened here, inside the op, and clamped to
    [0, K) as the pq ops clamp."""
    b, n_sub, k = luts.shape
    acc = torch.zeros(codes.shape[:2], dtype=luts.dtype, device=luts.device)
    for d in range(n_sub):
        idx = codes[:, :, d].long().clamp_(0, k - 1)
        acc = acc + luts[:, d, :].gather(1, idx)
    return acc


@register_index("ivf_pq")
class IVFPQ(Index):
    """nprobe-controlled probing over a coarse partition of PQ codes.

    ``staged_bytes`` counts the bytes ``search_host_staged`` has
    uploaded and ``stage_seconds`` the host time it spent before the
    upload (the probe's copy back, the chain expansion, the gather and
    packing)."""

    rows_leaves = ("list_codes", "list_ids")
    supports_host_staged = True

    def __init__(self, cfg: IndexConfig):
        super().__init__(cfg)
        self.staged_bytes = 0
        self.stage_seconds = 0.0

    def host_leaves(self) -> Tuple[str, ...]:
        # the chain expands on the host in host-staged mode: it stays
        # host-resident beside the row tables
        return self.rows_leaves + ("list_chain",)

    @classmethod
    def validate(cls, cfg: IndexConfig) -> None:
        if cfg.nlist < 1:
            raise ValueError(f"ivf_pq needs nlist >= 1, got {cfg.nlist}")
        if not 1 <= cfg.nprobe <= cfg.nlist:
            raise ValueError(
                f"ivf_pq needs 1 <= nprobe <= nlist, got "
                f"nprobe={cfg.nprobe} nlist={cfg.nlist}")

    def describe(self) -> str:
        return f"nlist={self.cfg.nlist}, nprobe={self.cfg.nprobe}"

    # ------------------------------------------------------------ build
    def build(self, gen: torch.Generator, vectors: torch.Tensor) -> Dict:
        """Build through the streamed build (retrieval/build.py) on the
        vectors' device and move every leaf there.  Use
        ``build.build_ivf_artifact`` directly to keep the list tables
        in host memory (host-staged serving)."""
        from repro_torch.retrieval.build import build_ivf_artifact
        artifact, _ = build_ivf_artifact(gen, vectors, self.cfg,
                                         device=vectors.device)
        return {name: torch.as_tensor(leaf).to(vectors.device)
                for name, leaf in artifact.items()}

    # ----------------------------------------------------------- search
    def _probe(self, artifact: Dict, queries: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-nprobe coarse cells per query: (scores, list ids), both
        (B, nprobe), in ``lax.top_k``'s order (score desc, lower list
        first among equal scores: a stable sort on the order key)."""
        coarse_scores = queries @ artifact["coarse"].T      # (B, nlist)
        order = torch.sort(_order_key(coarse_scores), dim=-1,
                           descending=True, stable=True).indices
        lists = order[:, :self.cfg.nprobe]
        return coarse_scores.gather(1, lists), lists

    def _expand_chain(self, chain_table: torch.Tensor, lists: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, P) probed base lists -> (B, P, C) extended-list ids via
        the chain table, plus the live mask (chain padding is -1).
        Dead slots clamp to row 0 and are masked downstream."""
        chain = chain_table[lists]
        live = chain >= 0
        return torch.where(live, chain, 0), live

    def _candidate_scores(self, luts: torch.Tensor, list_codes: torch.Tensor,
                          chain: torch.Tensor) -> torch.Tensor:
        """(B, P, C) extended-list ids into ``list_codes`` -> flat
        (B, P·C·cap) candidate scores: the unique lists scored once for
        every query (one ``pq_score_batched``), then gathered."""
        b = chain.shape[0]
        cap, n_sub = list_codes.shape[1], list_codes.shape[2]
        uniq, inv = torch.unique(chain, return_inverse=True)
        scores = dispatch.dispatch(
            "pq_score_batched", luts,
            list_codes[uniq].reshape(-1, n_sub), block_n=self.cfg.block_n,
            backend=self.cfg.kernel_backend)            # (B, U·cap)
        slot = torch.arange(cap, device=chain.device)
        pos = (inv[..., None] * cap + slot).reshape(b, -1)
        return scores.gather(1, pos)

    def _score_probed(self, tables: Dict, luts: torch.Tensor,
                      probe_s: torch.Tensor, chain: torch.Tensor,
                      hit: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Score the (B, P, C) probed extended lists of ``tables``
        (``list_codes``, ``list_ids``) with the queries' LUTs (B, D, K)
        -> flat (B, P·C·cap) candidate (scores, global ids); ``hit``
        masks chain padding to (-inf, INVALID_ID)."""
        b, p, c = chain.shape
        cap = tables["list_codes"].shape[1]
        cand = self._candidate_scores(luts, tables["list_codes"], chain
                                      ).reshape(b, p, c, cap)
        ids = tables["list_ids"][chain]                   # (B, P, C, cap)
        if self.cfg.ivf_residual:
            cand = cand + probe_s[:, :, None, None]
        valid = (ids != INVALID_ID) & hit[..., None]
        cand = torch.where(valid, cand, float("-inf"))
        ids = torch.where(valid, ids, INVALID_ID)
        return cand.reshape(b, -1), ids.reshape(b, -1)

    def _query_chunks(self, b: int, per_query: int):
        rows = max(1, CANDIDATE_CHUNK // max(per_query, 1))
        return [(q0, min(q0 + rows, b)) for q0 in range(0, b, rows)]

    def _topk(self, tables: Dict, queries: torch.Tensor,
              probe_s: torch.Tensor, chain: torch.Tensor, live: torch.Tensor,
              k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(scores, positions, ids) of ``topk_by_position`` over the
        probed candidates.  The LUTs of the whole batch in one product,
        then scoring and selection per chunk of queries: a query's
        top-k does not depend on the chunk it falls in."""
        luts = build_lut_batch(queries, tables["centroids"]
                               ).to(torch.float32).contiguous()  # (B, D, K)
        per_query = chain.shape[1] * chain.shape[2] * \
            tables["list_codes"].shape[1]
        outs = []
        for q0, q1 in self._query_chunks(queries.shape[0], per_query):
            s, i = self._score_probed(tables, luts[q0:q1], probe_s[q0:q1],
                                      chain[q0:q1], live[q0:q1])
            outs.append(topk_by_position(s, i, k))
        return tuple(torch.cat(parts) for parts in zip(*outs))

    def search(self, artifact: Dict, queries: torch.Tensor,
               k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        probe_s, lists = self._probe(artifact, queries)
        chain, live = self._expand_chain(artifact["list_chain"], lists)
        top_s, _, top_i = self._topk(artifact, queries, probe_s, chain,
                                     live, k)
        return top_s, top_i

    def local_topk(self, artifact: Dict, queries: torch.Tensor, k: int, *,
                   shard: int, num_shards: int):
        """Per-shard top-k over the local extended lists: probe (the
        coarse table is replicated), expand the chains to GLOBAL list
        ids, mask the lists this shard does not hold, then score
        (``pq_score_batched``) and select.  The candidate position —
        (probe x chain x slot), the same on every shard — is the
        tiebreak."""
        lists_local = artifact["list_codes"].shape[0]
        probe_s, lists = self._probe(artifact, queries)
        chain, live = self._expand_chain(artifact["list_chain"], lists)
        local = chain - shard * lists_local
        hit = live & (local >= 0) & (local < lists_local)
        return self._topk(artifact, queries, probe_s,
                          local.clamp(0, lists_local - 1), hit, k)

    # ------------------------------------------------------ host-staged
    def stage_plan(self, chain_h: np.ndarray, lists: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The host half of a staged flush: (B, P) probed base lists ->
        the unique extended lists to stage (U,), each probed slot's row
        among them (B, P, C) int32, and the live mask (B, P, C)."""
        chain = chain_h[lists]                          # (B, P, C)
        live = chain >= 0
        uniq, inv = np.unique(np.where(live, chain, 0), return_inverse=True)
        return uniq, inv.reshape(chain.shape).astype(np.int32), live

    @staticmethod
    def staged_upload_bytes(u: int, cap: int, code_row_bytes: int,
                            slots: int) -> int:
        """Bytes of one staged flush's single upload: the U staged
        lists' codes (padded to 4 bytes) and ids, then each probed
        slot's staged row (int32) and live flag (uint8)."""
        codes = -(-u * cap * code_row_bytes // 4) * 4
        return codes + u * cap * 4 + slots * 5

    def search_host_staged(self, artifact: Dict, queries: torch.Tensor,
                           k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Serve with the list tables host-resident.

        The probe runs on the device (the coarse table is tiny); the
        probed base lists' chains expand on the host, and only the
        unique probed extended lists are gathered from host memory and
        staged to the device in ONE upload on the current stream — the
        staged codes and ids, each slot's staged row and its live flag
        packed into one buffer (pinned when the device is the card):
        upload ∝ B·nprobe·max_chain·cap, never O(corpus).  Scoring and
        selection are ``search``'s on the staged tables, in the same
        (probe × chain × slot) layout, so the results are
        bit-identical.  ``staged_bytes`` grows by the upload's size
        (``staged_upload_bytes``).  Eager torch needs no padding of U
        to a few sizes (the JAX package pads to a multiple of 64 for
        its jit)."""
        codes_h = torch.as_tensor(artifact["list_codes"])
        ids_h = torch.as_tensor(artifact["list_ids"])
        chain_h = torch.as_tensor(artifact["list_chain"]).numpy()
        device = artifact["coarse"].device
        probe_s, lists = self._probe(artifact, queries)
        t0 = time.perf_counter()
        uniq, slots, live = self.stage_plan(chain_h, lists.cpu().numpy())
        u, cap, n_sub = len(uniq), codes_h.shape[1], codes_h.shape[2]
        row = n_sub * codes_h.element_size()
        n_codes = -(-u * cap * row // 4) * 4
        n_ids = u * cap * 4
        total = self.staged_upload_bytes(u, cap, row, slots.size)
        buf = torch.empty(total, dtype=torch.uint8,
                          pin_memory=device.type == "cuda")
        uniq_t = torch.from_numpy(uniq)
        torch.index_select(codes_h, 0, uniq_t, out=buf[:u * cap * row].view(
            codes_h.dtype).view(u, cap, n_sub))
        torch.index_select(ids_h, 0, uniq_t, out=buf[n_codes:n_codes + n_ids]
                           .view(torch.int32).view(u, cap))
        off = n_codes + n_ids
        buf[off:off + 4 * slots.size].view(torch.int32).copy_(
            torch.from_numpy(slots.reshape(-1)))
        buf[off + 4 * slots.size:].copy_(
            torch.from_numpy(live.reshape(-1).view(np.uint8)))
        self.stage_seconds += time.perf_counter() - t0
        dev = buf.to(device, non_blocking=True)
        self.staged_bytes += total
        staged = {"centroids": artifact["centroids"],
                  "list_codes": dev[:u * cap * row].view(codes_h.dtype)
                  .view(u, cap, n_sub),
                  "list_ids": dev[n_codes:n_codes + n_ids]
                  .view(torch.int32).view(u, cap)}
        shape = slots.shape
        chain = dev[off:off + 4 * slots.size].view(torch.int32).view(shape)
        live_d = dev[off + 4 * slots.size:].view(torch.bool).view(shape)
        top_s, _, top_i = self._topk(staged, queries, probe_s, chain.long(),
                                     live_d, k)
        return top_s, top_i


__all__ = ["ASSIGN_CHUNK_ELEMS", "CANDIDATE_CHUNK", "IVFPQ",
           "bounded_list_layout", "coarse_assign", "coarse_kmeans",
           "probed_scores_ref"]
