"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. the card's name and power limit (nvidia-smi) and the torch version;
2. build every CUDA kernel from ``src/repro_torch/kernels/csrc/`` with
   nvcc, one process per source, all at once;
3. hold each kernel against its plain PyTorch version on the card at
   the paths' shapes (``mgqe_decode`` at deepfm's and at gemma3-4b's
   prefill shape, ``rq_decode_stages`` and ``packed_decode`` on every
   route (a table past the shared-memory limit through L2, rq's smem
   route at 262,144 rows), the pq kernels at B = 1, 16, the
   retrieval flush's 464 and a ragged 465: bit-identical, ``pq_topk``
   also on scores rising with the id;
   ``dpq_assign`` in float32 and bfloat16: identical codes except
   between distances equal to within ``ASSIGN_TOL``);
4. drive the first main path at full width: deepfm's ``CONFIG`` -> its
   10M-row MGQE field -> init on the card -> export (``dpq_assign``) ->
   ``ServingEngine`` over 200 random requests (``mgqe_decode``), with
   every kernel's launch count set to 0 just before and read just
   after; then check the served rows and exported codes against the
   plain versions, and a small table end to end against the CPU; then
   export and serve once more under torch.profiler, for the device
   time of each kernel;
5. time each of its kernels, its plain version and, where one PyTorch
   call computes the same function, that call, with CUDA events at the
   main path's shapes, beside the least time the card could take
   (``mgqe_decode`` also at gemma3-4b's prefill shape, held
   bit-identical there);
   ``dpq_assign`` at all four of its shapes (deepfm's export, also on
   the tiled product against the walk the kernel takes at S = 2; the
   retrieval index; gemma3-4b's f32 and gemma3-27b's bf16 token
   tables, launch by launch as exported), every launch's codes held to
   the plain version;
6. drive the third path at full width on the same 10M-row field:
   ``rq`` (deepfm's ``CONFIG`` with embed_kind="rq", M=5, K=256)
   through ``launch.serve.serve_engine`` (``rq_decode_stages``), then
   ``mpe`` (tiers at 5% and 25% of the ids, 8/4/2-bit packed codes)
   through ``Embedding`` and ``ServingEngine`` (export: ``dpq_assign``;
   serve: ``packed_decode``, one launch per tier), each with the counts
   set to 0 just before and read just after; hold every flush's rows
   against the plain decode of its ids, bit for bit, the mpe codes
   against the plain assignment, and small rq and mpe tables against
   the CPU; then serve the lrf, sq and hash baselines once each through
   ``serve_engine`` and print every scheme's size and lookups/s;
7. time ``rq_decode_stages`` and ``packed_decode`` as in 5, each with
   the launch plan it took (rq's entry at one engine flush, the shape
   of its counted launches), also at B = 262,144, in bfloat16, at the
   schemes' pinned block_b, at one engine flush and at B = 256, and rq
   on both routes and at the JAX bench's d = 64; then
8. the hot-row phase on deepfm's largest field (10M rows, mgqe, D=5,
   S=2, K=256/64): exported with a hot block of 1,250,000 rows (the
   JAX bench's n // 8; ``dpq_assign``, then ``mgqe_decode`` at B = C)
   and served through a cached and an uncached ``ServingEngine`` on the
   JAX bench's stream (120 Zipf requests of 1-512 ids at a = 1.05, 1.2,
   1.5, best of 3 passes): hit rates, rows decoded, both engines'
   lookups/s, every flush bit-identical between them and to the plain
   decode, a wholly cached flush launching no decode, and where a cached
   flush's time goes (host split, upload, kernels under the profiler);
   a stream whose head moved (Zipf over a permutation), refreshed every
   4 flushes (the hit rate must rise) and one refresh timed; then the
   cached engine behind ``AsyncServingEngine`` (deadline 500 us, SLO p99
   <= 5 ms) on open-loop Zipf(1.2) streams of 1-8 ids at 200, 500, 1,000
   and 2,000 requests/s for 2 s each: p50/p99/p999, flushes by trigger,
   sustained lookups/s, every future bit-identical to the synchronous
   engine; and once more with background refreshes and ``refresh_now``
   fired mid-stream; counts set to 0 just before and read just after.
   Phase 6 also serves each of its schemes behind a cache of 4,096 rows
   (every flush bit-identical to its uncached engine's: lrf's rows may
   not depend on the batch);
9. the fourth path, each phase freeing the card after it:
   ``embedding_bag`` against its plain version at deepfm's largest
   field as a full table (V = 10M, d = 10) and at two-tower's 10M-row
   item table pooled over watch-history bags (d = 256, 10.24 GB in
   float32), 4,096 bags of 0..64 uniform ids and 257 (a ragged edge),
   float32 and bfloat16, with and without weights, then 4,096 bags of
   Zipf lengths (exponent 1.1, at most 16,384 ids), one bag of every id
   of a 16,384-row table and 1,000 bags all empty but the last:
   bit-identical to the in-order version (which adds in the kernel's
   order), and within ``BAG_F32_TOL`` (float32) or a bfloat16 rounding
   per product and add (bfloat16) of the plain version, one float32
   segment sum; the fields module's ``embedding_bag`` in sum, mean and
   max (counts set to 0 just before and read just after: two
   launches); the kernel (with its launch plan and the wrapper's host
   time), the plain version and ``F.embedding_bag`` timed at both
   shapes, float32 and bfloat16, and on the Zipf bags (the kernel's
   worst case: one thread per vector sums a bag); then DeepFM at
   ``configs/deepfm.py::CONFIG`` (39 fields, 24.7M rows, MGQE on the
   21 large ones) served through ``launch.serve.serve_ctr`` (init,
   export, one batch of 4,096 Zipf ids; ``dpq_assign`` and
   ``mgqe_decode`` launches equal to the counts predicted from the
   fields; rows bit-identical to the plain decode, logits within
   ``CTR_TOL`` of the plain ops) and trained through
   ``launch.train.train`` (5 adagrad steps at batch 4,096: finite
   losses, no kernel launched, step times, peak memory, one step split
   into forward, backward and optimizer and one under the profiler);
   AutoInt (``configs/autoint.py::CONFIG``: 39 fields, 24.7M rows, 21
   MGQE fields at D=8) and BST (``configs/bst.py::CONFIG``: 10M items,
   D=8, 21 positions) served and trained the same way (AutoInt 391
   ``dpq_assign`` and 21 ``mgqe_decode`` launches, BST 153 and 1:
   ``CTR_LAUNCHES``); two-tower at its published widths, its users cut
   to 5M (``TT_TRAIN_USERS``), trained 5 steps through ``recsys_setup``
   and ``fit``, its trained item tower indexed (flat_pq over 1M items,
   one ``dpq_assign``) and queried top-100 for 16 users (one
   ``pq_topk``), the lists bit-identical to ``pq_topk_ref``; then at
   the smoke configs 5 steps of DeepFM, AutoInt, BST and two-tower on
   the card against 5 on the CPU (codes compared first, loss and params
   within their bars) and a run failed at step 3 and resumed against an
   uninterrupted one (DeepFM, AutoInt), once more in a child process
   under ``torch.use_deterministic_algorithms(True)``; then
   ``dpq_assign`` and ``mgqe_decode`` timed at AutoInt's and BST's
   shapes;
10. the backbone phase (the paper's §3.2, ``launch/backbones.py``):
   GMF, NeuMF and SASRec, each with full and MGQE tables, trained on
   the card through ``run_pointwise``/``run_sasrec`` at the paper's
   widths (ML-1M-like 6,040 x 3,416, d = 64, D = 8, K = 256 with a tail
   of 64 for the 90% least frequent ids, NeuMF's MLP 128-64-32, SASRec
   2 blocks at maxlen 50; BB_STEPS adam steps at batches of 512 x 5 and
   128 x 50): step time, peak memory, loss first to last, HR@10 over
   500 users, size and Fig. 3's verdict, no kernel launched; then the
   tests' tiny backbones on the card against the CPU, step by step
   (losses within ``CTR_TOL`` up to the first near-tie code flip), with
   three planted faults that must fail; then every trained MGQE table
   exported (``dpq_assign``) and the evaluation's 500 x 101 candidates
   served (``mgqe_decode``), counts set to 0 just before and read just
   after: codes held to the plain assignment, served rows bit-identical
   to the plain decode and within a rounding of the training forward's,
   HR@10 from the served rows beside the training forward's; then both
   kernels timed at D = 16, 8, 4 (S = 4, 8, 16);
11. the LM phase: ``flash_attention`` against its plain version in
   float32 (CUDA cores) and bfloat16 (tensor cores) at gemma3-4b's local
   (window 1,024) and global layer shapes (B=2, S=4,096, 8 query heads
   over 4 KV heads, hd=320), gemma3-27b's (B=1, S=4,096, 32 heads over
   16, hd=168), stablelm-3b's (B=1, S=2,048, 32 heads, hd=80), the JAX
   tests' shapes and an odd length (bars: ``FLASH_TOL``; bf16 also per
   row against the plain version in float32, ``FLASH_BF16_ROW_TOL``,
   which two planted faults must fail); ``dpq_assign`` at the LM
   token tables' widths (D=8, S=320 and 672, K=256 and 64, float32 and
   bfloat16) against the plain assignment; then gemma3-4b at
   ``configs/gemma3_4b.py::CONFIG`` through ``launch.serve.serve_lm`` —
   init, MGQE export of the 262,144-row token table (``dpq_assign``),
   prefill of 2 prompts of 4,096 tokens (``flash_attention`` on all 34
   layers, ``mgqe_decode``), 16 greedy decode steps — with the counts
   set to 0 just before and read just after; the token rows held
   bit-identical to the plain decode, exported codes to the plain
   assignment, the last-token logits to the same prefill on the plain
   ops (``LM_LOGIT_TOL`` and top-1 tokens equal), and each prefill
   layer, fed the plain route's input, to the plain route with its
   attention in f32 (``LM_LAYER_TOL``: checks that the kernel route
   with a planted window fault must fail); the export's four
   ``dpq_assign`` launches timed on the served table; the prefill and
   one decode step under the profiler; then ``flash_attention``, its
   plain version and ``F.scaled_dot_product_attention`` timed at the
   local and global shapes, and the kernel at gemma3-27b's at either KV
   tile; then gemma3-27b's token table (262,144 x 5,376, bfloat16,
   lm_embedding's two tiers) exported as MGQE on the card, its head,
   tier-boundary and tail slices held to the plain assignment; the
   card is freed after;
12. free the card and drive the retrieval path at full width:
   two-tower retrieval at ``configs/two_tower_retrieval.py::CONFIG``
   (50M users, 10M items, embed_dim 256, towers 1024-512-256) through
   ``launch.serve.serve_retrieval`` — init, the ``flat_pq`` index over
   1,000,000 candidates (``dpq_assign``), the engine stream twice
   (``pq_topk``), recall@100 against the exact dense scan — then the
   stream once more keeping each flush's results, ``FlatPQ.scores``
   over the flush's queries (``pq_score_batched``) and one user's
   ``retrieval_scores_adc`` (``pq_score``), all counts set to 0 just
   before and read just after; then hold every flush against the
   plain ``pq_topk_ref`` and a stable sort of the oracle scores, bit
   for bit, hold the index's codes (and ``dpq_assign`` run again on
   the same tower outputs) against the plain assignment, as in 3, and
   print the peak device memory;
13. time the pq kernels at that path's shapes, as in 5,
   ``pq_score_batched`` also at a ragged B = 465, and ``pq_topk`` also
   on its worst case (scores rising with the id, held to the exact
   answer) and beside ``torch.topk(pq_score_batched(...))``, the two
   calls it fuses;
14. the retrieval-scale phase: ``ivf_pq`` at the JAX bench's
   ``bench_retrieval_scale`` widths and knobs (``IVF_*``) over a
   1,000,000-row Zipf-clustered corpus kept on the host (cut from the
   bench's default 10M rows for time), built through
   ``build_ivf_artifact`` (sampled coarse and PQ fits, 8 blocks of
   131,072 rows staged to the card, 8 ``dpq_assign`` launches, counts
   set to 0 just before and read just after): ``BuildStats`` and the
   list layout, the layout's codes held to the plain assignment and
   ``dpq_assign`` timed at the build's shape; then nprobe in 1, 4, 16,
   64, 128 over its 16 queries, 30 searches each on the card and
   through a host-staged ``RetrievalEngine`` (counted: one
   ``pq_score_batched`` a search), recall@100 against the exact dense
   scan, p50/p99, staged MB and host split a flush, the search with the
   plain scoring in the kernel's place timed at nprobe 128 and
   ``pq_score_batched`` at the search's shape;
   every search bit-identical to the plain per-query scoring, the
   host-staged results to the device's; the run fails unless some
   nprobe reaches recall@100 >= 0.95 and the build's peak device bytes
   stay within their bound.  Then two-tower's ``CONFIG`` through
   ``serve_retrieval(index_kind="ivf_pq", nprobe=128, host_staged=True)``
   over 1M candidates (counted: one ``dpq_assign``): recall@100
   (reported), queries/s beside phase 12's flat_pq, every flush
   bit-identical to the device search;
15. print one ``{"kernels": [...]}`` JSON line (launches summed over
   every path), then, last, the ``{"ok": true, "device": ...}`` line.

It needs one card and no arguments, imports nothing of JAX, and runs
the port from the ``src/`` directory beside this file.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s outside
# the tensor cores.  The least time for a call is the larger of its
# bytes over the first and its operations over the second.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# dpq_assign: the kernel's fused dot may round differently in the last
# bit from the plain version's matmul (bf16: the tensor cores sum the
# exact products in another order), so a code may differ only where the
# two candidates' distances are equal to within this (distances are
# O(1) at these scales; f32 rounding is ~1e-7 of that).
ASSIGN_TOL = 1e-5
# gemma3-27b's token table, exported in bf16 on the card (the config is
# not registered yet: only its embedding is built)
LM27_VOCAB, LM27_DIM = 262_144, 5_376

RAGGED_BATCH = 257                     # decode: beside serve_bulk's
ASSIGN_BATCH = 65536                   # export_codes' batch
N_REQUESTS, REQ_BATCH = 200, 64
TOPK = 100                             # serve_retrieval's top-k
# the engine's scores may differ from one user's own ADC scores only
# by the user tower's and the LUT build's f32 rounding at another batch
# size (the same LUT gives the same bits)
ADC_TOL = 1e-5

# embedding_bag: deepfm's largest field as a full table, and two-tower's
# 10M-row item table pooled over a watch-history bag; 4,096 bags of
# 0..64 uniform ids (and 257, a ragged edge)
BAG_SHAPES = ((10_000_000, 10, "deepfm's largest field as a full table"),
              (10_000_000, 256, "two-tower's item table, a watch-history "
                                "bag (YouTube-DNN style)"))
BAG_BATCH, BAG_MAX_LEN = 4096, 64
# the skewed case: 4,096 bags whose lengths follow a Zipf law over the
# bags' ranks (exponent 1.1, at most 16,384 ids a bag), scaled to the
# uniform case's nnz; one bag of every id of a table's first
# BAG_ONE_ROWS rows; BAG_EMPTY bags, all empty but the last
BAG_ZIPF_A, BAG_ZIPF_CAP = 1.1, 16384
BAG_ONE_ROWS = 16384
BAG_EMPTY = 1000
# kernel vs the plain version (float32 atomics in no fixed order), as a
# share of the bag's sum of |row * w|; a bag of 64 ids reorders to
# within 63 * 2^-24 = 3.8e-6 of it.  bfloat16: (terms + 1) * 2^-8.
BAG_F32_TOL = 1e-5
# the hot-row phase: deepfm's largest field (10M rows, mgqe/shared_k)
# with the JAX bench's cache of max(1024, n // 8) rows
# (benchmarks/kernel_bench.py:512), its stream of 120 Zipf requests of
# 1-512 ids at three exponents and max_queue 8,192 (:952-953, :531)
HOT_ROWS = 1_250_000
HOT_ZIPF = (1.05, 1.2, 1.5)
HOT_REQUESTS, HOT_REQ_BATCH, HOT_MAX_QUEUE = 120, 512, 8192
HOT_PASSES = 3                         # measured passes, the best kept
# the moving head: Zipf(1.2) over a fixed permutation of the ids,
# refreshed every REFRESH_EVERY flushes
REFRESH_EVERY, REFRESH_REQUESTS = 4, 480
# phase 6's schemes once more with a small cache: the block (B = 4,096)
# and the flushes take different launch shapes
HOT_SMALL = 4096
# the async front-end as the JAX bench drives it (:620, :954-957):
# deadline 500 us, p99 SLO 5 ms, open-loop Zipf(1.2) requests of 1-8
# ids for 2 s at each rate
ASYNC_WAIT_US, SLO_MS = 500.0, 5.0
ASYNC_RATES, ASYNC_SECONDS, ASYNC_REQ_BATCH = (200, 500, 1000, 2000), 2.0, 8
ASYNC_REFRESH_EVERY, ASYNC_REFRESH_RATE = 8, 1000
CTR_BATCH = 4096                       # the CTR models served and trained
CTR_TOL = 1e-5                         # logits, kernels vs plain ops
# the CTR models served at their full CONFIG, and the launches of one
# serve_ctr: dpq_assign once per 65,536-row export batch of each
# quantized table, mgqe_decode once per quantized table (deepfm and
# autoint: the 21 Criteo-style fields of >= 10,000 rows, 2 x 153 + 4 x
# 16 + 6 x 2 + 9 x 1 batches; bst: its 10M-row item table, all 21
# positions of a row in one decode)
CTR_ARCHS = ("deepfm", "autoint", "bst")
CTR_LAUNCHES = {"deepfm": (391, 21), "autoint": (391, 21), "bst": (153, 1)}
TRAIN_STEPS = 5
CHECK_BATCH = 256                      # smoke-config card-vs-CPU runs
TRAIN_LOSS_RTOL = 1e-4
TRAIN_PARAM_TOL = 1e-5
# adagrad's first step on an element divides its gradient g by |g| +
# eps (1e-8): the update moves by lr * eps / (|g| + eps)^2 per unit of
# gradient, 2.5e5 at |g| = eps, so a gradient the card computes 1e-9
# from the CPU's (after a cancellation) can move the element by 2.5e-4.
# So a card run is held to a CPU run through the gradients: each step's
# within TRAIN_PARAM_TOL, every param within float32 rounding of a
# float64 adagrad over its own run's gradients (``adagrad_replay``), and
# the two runs' params apart by at most what their replays are apart
# (``adagrad_gaps``)
# the models whose failed-and-resumed run is held to an uninterrupted one
RESUME_ARCHS = ("deepfm", "autoint")
# two-tower trained at its published widths, its 50M users cut to 5M:
# the CONFIG's tables (61.44 GB), their gradients, adagrad's
# accumulators and its temporary would be about 184 GB; 5M users and
# the 10M items keep 15.36 GB of tables.  Its trained index is queried
# by the JAX bench's retrieval batch (benchmarks/kernel_bench.py:699,
# ``bench_retrieval_topk``'s batch=16).
TT_TRAIN_USERS = 5_000_000
TT_QUERIES = 16

# the retrieval-scale phase: the JAX bench's ``bench_retrieval_scale``
# (benchmarks/kernel_bench.py:786-880) at its --quick row count, 1M
# rows, cut from its default 10M for time (the corpus generator, host
# work that grows faster than the rows, takes about 9 s at 1M); its
# widths and knobs otherwise: d = 64, D = 8, K = 128, nlist =
# suggest_nlist(n, 128) = 1,000, 10 + 10 Lloyd iterations, train_sample
# and encode_block 131,072, lists capped at the 0.9 count quantile, the
# corpus Zipf(1.3)-clustered over min(2048, suggest_nlist(n)) clusters;
# its 16 queries, nprobe swept, 30 searches at each (the bench's
# ``iters`` up to 2M rows).  Its gates: recall@100 >= IVF_RECALL at
# some swept nprobe, and the build's peak device bytes within the
# config's bound.
IVF_ROWS = 1_000_000
IVF_DIM, IVF_SUB, IVF_K = 64, 8, 128
IVF_BLOCK = 131_072
IVF_NPROBES = (1, 4, 16, 64, 128)
IVF_ITERS = 30
IVF_RECALL = 0.95
# two-tower's CONFIG through serve_retrieval(index_kind="ivf_pq",
# host_staged=True) at the sweep's widest probe
TT_IVF_NPROBE = 128

# the backbone phase (the paper's §3.2 and benchmarks/convergence.py
# --full): ML-1M-like 6,040 users x 3,416 items, d = 64, D = 8, K = 256
# with a tail tier of 64; the size sweep's D = 16, 8, 4 (S = 4, 8, 16)
BB_USERS, BB_ITEMS, BB_DIM = 6040, 3416, 64
# adam steps a run: benchmarks/common.py's default.  The --full
# protocol's 2,000 made the phase 114-162 s on an H100 (the steps are
# host-bound and the host varies), past its ~120 s budget; Fig. 3 at
# 2,000 steps is ``python -m repro_torch.launch.backbones convergence
# --full``.  At 400 steps FE has not yet left MGQE's plateau (its gap
# opens after about step 500), so every verdict here reads TRACKS.
BB_STEPS = 400
BB_EVAL = 500                          # HR@10's users
BB_CHECK_STEPS = 10                    # the tiny card-vs-CPU runs
BB_PROFILE_STEPS = 20                  # an MGQE run's steps under the profiler
BB_SUBSPACES = (16, 8, 4)

# the LM phase: gemma3-4b's CONFIG served through serve_lm
LM_ARCH = "gemma3-4b"
LM_BATCH, LM_PROMPT, LM_STEPS = 2, 4096, 16
# H100 SXM dense bf16 tensor-core peak (data sheet): the attention
# kernel's and bf16 dpq_assign's operation bound
BF16_FLOP_PER_S = 989e12
FULL_WINDOW = 1 << 30
# flash_attention against its plain version: the JAX tests' own bars
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# q and k drawn at randn * FLASH_QK_SCALE (v at randn): scores of std 1,
# so a row's weights follow its scores rather than a near-uniform mean
FLASH_QK_SCALE = 1.0
# bfloat16, held also per row against the plain version computed in
# float32 on the same bf16 inputs: P and the output are each rounded
# once to bf16 (at most 2^-8 of a value each), so |diff| stays within
# 4 * 2^-8 of the row's largest |output|.  The planted faults of
# ``planted_attention`` must fail this bar.
FLASH_BF16_ROW_TOL = 4 * 2 ** -8
# the planted faults' unit: one KV tile of 64 keys (the f32 kernel's
# tile; the bf16 kernel's is 32 or 64)
FLASH_TILE = 64
# (name, b, s_q, s_kv, h, h_kv, hd, window): gemma3-4b's local and global
# layers at the path's prefill, gemma3-27b's (hd = 5,376 / 32 = 168, not
# a multiple of the tensor cores' k-depth of 16), stablelm-3b's, the JAX
# tests' shapes (tests/test_kernels.py: cross-length, a window wider
# than a tile) and an odd length
FLASH_CASES = (
    ("gemma3-4b local", 2, 4096, 4096, 8, 4, 320, 1024),
    ("gemma3-4b global", 2, 4096, 4096, 8, 4, 320, FULL_WINDOW),
    ("gemma3-27b local", 1, 4096, 4096, 32, 16, 168, 1024),
    ("gemma3-27b global", 1, 4096, 4096, 32, 16, 168, FULL_WINDOW),
    ("stablelm-3b", 1, 2048, 2048, 32, 32, 80, FULL_WINDOW),
    ("jax gqa", 2, 256, 256, 4, 2, 64, FULL_WINDOW),
    ("jax window", 1, 128, 128, 4, 4, 32, 64),
    ("jax cross-length", 2, 128, 384, 8, 2, 64, FULL_WINDOW),
    ("jax window > tile", 1, 256, 256, 2, 1, 128, 300),
    ("odd length", 1, 1500, 1500, 8, 4, 320, 1024),
)
# last-token prefill logits, the kernel route against the same prefill
# on the plain attention (bf16 activations through 34 layers, where the
# plain version rounds each score to bf16 and the kernel does not): the
# top-1 tokens equal and max |diff| within LM_LOGIT_TOL: between the
# sound runs' reading (0.1016) and the plain prefill's with layer 0's
# window one KV tile short (0.1562; H100 SXM, 700 W).  The kernel route
# with that planted fault must fail the check.
LM_LOGIT_TOL = 0.125
# each prefill layer fed the plain route's input to it (the plain route
# with its attention in f32 on the same bf16 inputs), the kernel route's
# output held to that route's: the largest over the 34 layers of the
# mean |diff| of a layer's output.  The sound route read 0.00188, both
# planted window faults 0.01182 (6.3x; H100 SXM, 700 W); no statistic
# of the final output (last-token logits or every position's hidden
# state, max or mean, against either plain route) reached 2x.  The bar
# sits between them, 2.7x above the sound reading and 2.4x below the
# faults'.
LM_LAYER_TOL = 0.005

REPO = os.path.dirname(os.path.abspath(__file__))


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int = 100, warmup: int = 5, hold: bool = True):
    """(device ms, host ms) of one ``fn()``, averaged over ``iters``
    calls after ``warmup``.

    A kernel of a few microseconds is shorter than the Python call that
    launches it, so back-to-back launches would time the host.  The
    card is first kept busy (``torch.cuda._sleep``) while the host
    queues all ``iters`` calls; the CUDA events around them then time
    the device alone.  The sleep doubles until it outlasts the
    queueing.  The host figure is the wall time to queue one call.

    ``hold=False`` is for calls of many launches each far longer than
    its host work (the plain versions): the launch queue's depth would
    stall the host behind the sleep, and the card stays busy without
    it.  The check that the host kept ahead then is host < device."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if not hold:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host = time.perf_counter() - t0
        ev[1].record()
        torch.cuda.synchronize()
        device = ev[0].elapsed_time(ev[1]) / iters
        need(host * 1e3 / iters < device, "the host queued ahead of the card")
        return device, host * 1e3 / iters
    cycles = 50_000_000
    for _ in range(6):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host = time.perf_counter() - t0
        ev[2].record()
        torch.cuda.synchronize()
        if ev[0].elapsed_time(ev[1]) > host * 1e3:
            return ev[1].elapsed_time(ev[2]) / iters, host * 1e3 / iters
        cycles *= 2
    raise RuntimeError("the host could not queue the calls ahead of the "
                       "card; device time not measurable this way")


def serve_bulk_batch() -> int:
    """The recsys bulk-serving batch (262,144 rows)."""
    from repro_torch.configs.base import RECSYS_SHAPES
    return next(s.batch for s in RECSYS_SHAPES if s.name == "serve_bulk")


def retrieval_candidates() -> int:
    """The recsys retrieval corpus (1,000,000 candidates)."""
    from repro_torch.configs.base import RECSYS_SHAPES
    return next(s.n_candidates for s in RECSYS_SHAPES
                if s.name == "retrieval_cand")


def bits(t):
    """A float32 or bfloat16 tensor's bits, for bit-for-bit comparisons
    (-inf and -0.0 included)."""
    import torch
    return t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16
                               else torch.int32)


def finite_err(a, b) -> float:
    """Largest |a - b| where both are finite; 0.0 when none is."""
    import torch
    ok = torch.isfinite(a) & torch.isfinite(b)
    return float((a[ok] - b[ok]).abs().max()) if bool(ok.any()) else 0.0


def need(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


# ----------------------------------------------------------------------
# inputs at the main path's shapes
# ----------------------------------------------------------------------

def decode_inputs(b, d, k, s, dtype, seed, code_hi=None):
    """codes (b, d) uint8 drawn up to ``code_hi`` (past K-1: clamped,
    as private_k lanes of other tiers carry) and centroids (d, k, s)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    hi = k if code_hi is None else code_hi + 1
    codes = torch.randint(0, hi, (b, d), generator=g, device="cuda",
                          dtype=torch.int32).to(torch.uint8)
    cent = torch.randn((d, k, s), generator=g, device="cuda").to(dtype)
    return codes, cent


def assign_inputs(b, d, k, s, seed, k_small, dtype=None):
    """e_sub (b, d, s), centroids (d, k, s) at the init's scale, in
    ``dtype`` (default float32), and a mixed k_limit: 10% of rows,
    scattered at random, at K (head tier), the rest at k_small."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    scale = (d * s) ** -0.5
    dtype = dtype or torch.float32
    e = (torch.randn((b, d, s), generator=g, device="cuda") * scale
         ).to(dtype)
    cent = (torch.randn((d, k, s), generator=g, device="cuda") * scale
            ).to(dtype)
    head = torch.rand((b,), generator=g, device="cuda") < 0.1
    lim = torch.where(head, k, k_small).to(torch.int32)
    return e, cent, lim


def assign_gap(e, cent, lim, got, want) -> float:
    """Largest distance gap (float64) between the kernel's pick and the
    plain version's; 0.0 when every code agrees.  Runs over blocks of
    ASSIGN_BATCH rows, so its float64 distances stay small at 1M rows."""
    import torch
    c64 = cent.double()
    c_sq = torch.sum(c64 * c64, -1)[None]
    gap = 0.0
    for i in range(0, e.shape[0], ASSIGN_BATCH):
        dist = c_sq - 2.0 * torch.einsum(
            "bds,dks->bdk", e[i:i + ASSIGN_BATCH].double(), c64)
        a = dist.gather(-1, got[i:i + ASSIGN_BATCH].long()[..., None])
        b = dist.gather(-1, want[i:i + ASSIGN_BATCH].long()[..., None])
        gap = max(gap, float((a - b).abs().max()))
    if lim is not None:
        need(bool((got < lim[:, None]).all()), "codes respect k_limit")
    return gap


def blocked_assign_ref_lim(e, cent, lim):
    """The plain assignment under per-row budgets (or none), over blocks
    of 8,192 rows (its (rows, D, K) distances stay small)."""
    import torch
    from repro_torch.kernels.dpq_assign import dpq_assign_ref
    return torch.cat([dpq_assign_ref(e[i:i + 8192], cent,
                                     None if lim is None else lim[i:i + 8192])
                      for i in range(0, e.shape[0], 8192)])


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------

def build_kernels():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    reports = build.build()
    log(f"build: {sorted(reports) or 'already built'} in "
        f"{time.perf_counter() - t0:.1f}s -> {build.BUILD_DIR}")
    for name, text in sorted(reports.items()):
        for entry, regs, spills in ptxas_entries(text):
            log(f"  ptxas {name} {entry}: {regs} registers, {spills}")
    for name in build.sources():
        build.library(name)


def ptxas_entries(text: str) -> list:
    """(kernel, registers, spills) per entry function of one source's
    ``nvcc -Xptxas -v`` report, the kernel named from its mangled name
    with its integer template arguments (``flash_bf16_kernel<320,32>``)."""
    import re
    out, entry, spills = [], "?", "?"
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']*)'", line)
        if m:
            # _ZN <length><name> ... [I <template args> E] E: the last
            # name before the arguments is the kernel's
            rest, entry = m.group(1).removeprefix("_ZN"), m.group(1)[:60]
            while (part := re.match(r"(\d+)", rest)):
                start = len(part.group(1))
                entry = rest[start:start + int(part.group(1))]
                rest = rest[start + len(entry):]
            args = re.match(r"I(.*?)EE", rest)
            if args:
                entry += "<" + ",".join(
                    re.findall(r"Li(\d+)E", args.group(1) + "E")
                    or [{"h": "uint8", "i": "int32"}.get(args.group(1)[:1],
                                                         args.group(1))]) + ">"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = f"{m.group(1)}/{m.group(2)} bytes spill stores/loads"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append((entry, int(m.group(1)), spills))
    return out


def lm_decode_shape() -> tuple:
    """(B, D, K, S, dtype) of mgqe_decode at LM_ARCH's prefill: the
    LM_BATCH x LM_PROMPT prompt tokens' rows from its token table's
    centroids (the largest tier's K), in its parameter dtype."""
    import torch
    from repro_torch.configs import get_arch
    _, cfg = get_arch(LM_ARCH, smoke=False)
    e = cfg.embedding
    return (LM_BATCH * LM_PROMPT, e.num_subspaces, e.num_centroids,
            e.dim // e.num_subspaces, getattr(torch, cfg.param_dtype))


def check_kernels() -> dict:
    """Each kernel against its plain version on the card; returns
    ``{name: max_abs_err}`` over every case."""
    import torch
    from repro_torch.kernels.dpq_assign import dpq_assign, dpq_assign_ref
    from repro_torch.kernels.mgqe_decode import mgqe_decode, mgqe_decode_ref

    errs = {"mgqe_decode": 0.0, "dpq_assign": 0.0}
    for b in (serve_bulk_batch(), RAGGED_BATCH):
        for dtype in (torch.float32, torch.bfloat16):
            for k, hi in ((256, 255), (64, 255)):     # in range, clamped
                codes, cent = decode_inputs(b, 5, k, 2, dtype, seed=b + k,
                                            code_hi=hi)
                got = mgqe_decode(codes, cent)
                want = mgqe_decode_ref(codes, cent)
                torch.cuda.synchronize()
                need(got.shape == want.shape == (b, 10),
                     f"mgqe_decode shape at B={b}")
                same = torch.equal(bits(got), bits(want))
                err = float((got.float() - want.float()).abs().max())
                log(f"check mgqe_decode B={b} K={k} codes<= {hi} {dtype}: "
                    f"bit-identical={same} max_abs_err={err}")
                need(same, f"mgqe_decode bit-identical at B={b} {dtype}")
                errs["mgqe_decode"] = max(errs["mgqe_decode"], err)
    # the LM's token rows (the l2 route), in both element types
    lb, ld, lk, ls, _ = lm_decode_shape()
    for dtype in (torch.float32, torch.bfloat16):
        codes, cent = decode_inputs(lb, ld, lk, ls, dtype, seed=lb + ls)
        got, want = mgqe_decode(codes, cent), mgqe_decode_ref(codes, cent)
        torch.cuda.synchronize()
        same = torch.equal(bits(got), bits(want))
        err = float((got.float() - want.float()).abs().max())
        log(f"check mgqe_decode B={lb} D={ld} K={lk} S={ls} {dtype} "
            f"({LM_ARCH}'s prefill): bit-identical={same} max_abs_err={err}")
        need(same, f"mgqe_decode bit-identical at {LM_ARCH}'s prefill "
             f"shape, {dtype}")
        errs["mgqe_decode"] = max(errs["mgqe_decode"], err)
        del codes, cent, got, want

    for (b, d, k, s, k_small) in ((ASSIGN_BATCH, 5, 256, 2, 64),
                                  (ASSIGN_BATCH, 8, 256, 8, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            e, cent, lim = assign_inputs(b, d, k, s, seed=d, k_small=k_small,
                                         dtype=dtype)
            got = dpq_assign(e, cent, lim)
            want = dpq_assign_ref(e, cent, lim)
            torch.cuda.synchronize()
            need(got.shape == want.shape == (b, d), "dpq_assign shape")
            mism = int((got != want).sum())
            gap = assign_gap(e, cent, lim, got, want)
            log(f"check dpq_assign B={b} D={d} K={k} S={s} {dtype} k_limit "
                f"{k}/{k_small}: {mism} of {b * d} codes differ, max "
                f"distance gap {gap:.3g} (tolerance {ASSIGN_TOL})")
            need(gap <= ASSIGN_TOL, f"dpq_assign within {ASSIGN_TOL}")
            errs["dpq_assign"] = max(errs["dpq_assign"], gap)
    errs.update(check_decode_kernels())
    errs.update(check_pq_kernels())
    return errs


def check_decode_kernels() -> dict:
    """rq_decode_stages and packed_decode against their plain versions
    on the card, bit for bit, on every route: at the third path's shapes
    (M=5, K=256, d=10, codebooks in shared memory at B = 262,144 and
    through L2 at 257; D=5, S=2 at 8, 4 and 2 bits) and the JAX bench's d = 64
    shapes (M=4, K=256, 256 KB of codebooks: through L2; D=8, S=8), a
    table past packed_decode's shared-memory limit (D=16, S=16, 8 bits:
    through L2), B = 257 and 262,144, float32 and bfloat16."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.mgqe_decode import (rq_decode_stages,
                                                 rq_decode_stages_ref)
    from repro_torch.kernels.mgqe_decode.mgqe_decode import rq_plan
    from repro_torch.kernels.packed_decode import (pack_codes, packed_decode,
                                                   packed_decode_ref)
    from repro_torch.kernels.packed_decode.packed_decode import packed_plan
    errs = {"rq_decode_stages": 0.0, "packed_decode": 0.0}
    sms = build.sm_count("cuda")
    g = torch.Generator(device="cuda").manual_seed(31)
    for b in (RAGGED_BATCH, serve_bulk_batch()):
        for dtype in (torch.float32, torch.bfloat16):
            eb = torch.tensor([], dtype=dtype).element_size()
            for m, k, d in ((5, 256, 10), (4, 256, 64)):
                codes, cbs = rq_inputs(b, m, k, d, dtype, g)
                want = rq_decode_stages_ref(codes, cbs)
                p = rq_plan(b, m, k, d, 1, eb, sms)
                got = rq_decode_stages(codes, cbs)
                torch.cuda.synchronize()
                need(got.shape == want.shape == (b, d), "rq shape")
                same = torch.equal(bits(got), bits(want))
                err = float((got.float() - want.float()).abs().max())
                log(f"check rq_decode_stages B={b} M={m} K={k} d={d} "
                    f"{dtype} {p}: bit-identical={same} max_abs_err={err}")
                need(same, f"rq_decode_stages bit-identical at B={b} "
                     f"d={d} {dtype} {p}")
                errs["rq_decode_stages"] = max(errs["rq_decode_stages"],
                                               err)
            for d, s, bit_set in ((5, 2, (8, 4, 2)), (8, 8, (8, 4, 2)),
                                  (16, 16, (8,))):
                for nb in bit_set:
                    codes = torch.randint(0, 2 ** nb, (b, d), generator=g,
                                          device="cuda", dtype=torch.int32)
                    packed = pack_codes(codes, nb)
                    cent = torch.randn((d, 2 ** nb, s), generator=g,
                                       device="cuda").to(dtype)
                    p = packed_plan(b, d, s, nb, eb, sms)
                    got = packed_decode(packed, cent, nb)
                    want = packed_decode_ref(packed, cent, nb)
                    torch.cuda.synchronize()
                    same = torch.equal(bits(got), bits(want))
                    err = float((got.float() - want.float()).abs().max())
                    log(f"check packed_decode B={b} D={d} S={s} bits={nb} "
                        f"W={packed.shape[1]} {dtype} {p.route} route: "
                        f"bit-identical={same} max_abs_err={err}")
                    need(same, f"packed_decode bit-identical at B={b} "
                         f"D={d} bits={nb} {dtype} ({p.route} route)")
                    need((p.route == "l2") == (d == 16),
                         f"packed_decode's route at D={d}, S={s}: {p.route}")
                    errs["packed_decode"] = max(errs["packed_decode"], err)
    return errs


def rq_inputs(b, m, k, d, dtype, g):
    """codes (b, m) uint8 and stacked codebooks (m, k, d), stage m at
    the init's scale d**-0.5 * 0.5**m."""
    import torch
    codes = torch.randint(0, k, (b, m), generator=g, device="cuda",
                          dtype=torch.int32).to(torch.uint8)
    scale = d ** -0.5 * 0.5 ** torch.arange(m, device="cuda")
    cbs = torch.randn((m, k, d), generator=g, device="cuda")
    return codes, (cbs * scale[:, None, None]).to(dtype)


def check_pq_kernels() -> dict:
    """The pq kernels against their plain versions at the retrieval
    index's shape (N = 1M, D = 8, K = 64, k = 100), normal and tie-heavy
    LUTs, B = 1 and 16 (the scoring kernels' rows route), the flush's
    464 (the lanes route and a rows remainder) and a ragged 465 (a
    masked last lanes group): bit-identical."""
    import torch
    from repro_torch.kernels.pq_score import (pq_score, pq_score_batched,
                                              pq_score_batched_ref,
                                              pq_score_ref, pq_topk,
                                              pq_topk_ref)
    errs = {"pq_score": 0.0, "pq_score_batched": 0.0, "pq_topk": 0.0}
    n, d, k = retrieval_candidates(), 8, 64
    g = torch.Generator(device="cuda").manual_seed(21)
    codes = torch.randint(0, k, (n, d), generator=g, device="cuda",
                          dtype=torch.int32).to(torch.uint8)
    for b in (1, 16, 464, 465):
        for ties in (False, True):
            luts = torch.randn((b, d, k), generator=g, device="cuda")
            if ties:                 # multiples of 1/8 from 9 values
                luts = torch.round(luts * 2.0).clamp(-4, 4) / 8.0
            got = pq_score_batched(luts, codes)
            want = pq_score_batched_ref(luts, codes)
            s1 = pq_score(luts[0].contiguous(), codes)
            w1 = pq_score_ref(luts[0], codes)
            ts, ti = pq_topk(luts, codes, TOPK)
            ws, wi = pq_topk_ref(luts, codes, TOPK)
            torch.cuda.synchronize()
            same = (torch.equal(bits(got), bits(want))
                    and torch.equal(bits(s1), bits(w1))
                    and torch.equal(bits(ts), bits(ws))
                    and torch.equal(ti, wi))
            log(f"check pq kernels N={n} B={b} D={d} K={k} k={TOPK} "
                f"{'tie-heavy' if ties else 'normal'} LUTs: "
                f"bit-identical={same}")
            need(same, f"pq kernels bit-identical at B={b}")
            errs["pq_score_batched"] = max(errs["pq_score_batched"],
                                           finite_err(got, want))
            errs["pq_score"] = max(errs["pq_score"], finite_err(s1, w1))
            errs["pq_topk"] = max(errs["pq_topk"], finite_err(ts, ws))
            del got, want, s1, w1, ts, ti, ws, wi
    # the selection's worst case: scores that rise with the id, so every
    # candidate passes every threshold
    luts, codes = rising_scores(16, n, d, k)
    ts, ti = pq_topk(luts, codes, TOPK)
    ws, wi = pq_topk_ref(luts, codes, TOPK)
    torch.cuda.synchronize()
    same = torch.equal(bits(ts), bits(ws)) and torch.equal(ti, wi)
    log(f"check pq_topk N={n} B=16 D={d} K={k} k={TOPK} scores rising with "
        f"the id: bit-identical={same}")
    need(same and int(ti[0, 0]) == n - 1, "pq_topk bit-identical on scores "
         "rising with the id")
    return errs


def rising_scores(b, n, d, k):
    """LUTs (b, d, k) and codes (n, d) uint8 under which candidate n
    scores exactly n: its id's base-k digits as codes of the first
    subspaces, each weighted by its place (exact in f32 below 2^24)."""
    import torch
    digits = max(1, math.ceil(math.log(n, k))) if n > 1 else 1
    need(digits <= d and k ** digits <= 2 ** 24, "rising scores fit")
    ids = torch.arange(n, device="cuda")
    codes = torch.zeros((n, d), dtype=torch.uint8, device="cuda")
    luts = torch.zeros((b, d, k), device="cuda")
    for j in range(digits):
        place = k ** (digits - 1 - j)
        codes[:, j] = ((ids // place) % k).to(torch.uint8)
        luts[:, j, :] = torch.arange(k, device="cuda").float() * place
    return luts, codes


def small_table_against_cpu(cfg=None):
    """A small table end to end on the card (kernels) and on the CPU
    (plain versions), same params: codes equal except at near-ties, rows
    equal wherever every code of the row is, engine counters equal.
    Default: an MGQE table."""
    import numpy as np
    import torch
    from repro_torch.core import Embedding, EmbeddingConfig
    from repro_torch.core.schemes.base import tree_leaves, tree_map
    from repro_torch.launch.engine import ServingEngine, drive_random_stream

    if cfg is None:
        cfg = EmbeddingConfig(vocab_size=5000, dim=10, kind="mgqe",
                              num_subspaces=5, num_centroids=256,
                              tier_boundaries=(500,),
                              tier_num_centroids=(256, 64))
    cpu = Embedding(cfg, device="cpu")
    params = cpu.init(cpu.generator(1))
    art_cpu = cpu.export(params)
    card = Embedding(cfg)
    art = card.export(tree_map(lambda t: t.cuda(), params))
    same = torch.ones(cfg.vocab_size, dtype=torch.bool)
    for c, w in zip(tree_leaves(art["codes"]), tree_leaves(art_cpu["codes"])):
        same &= (c.cpu() == w).all(1)
    need(float(same.float().mean()) > 0.99, f"small {cfg.kind} table: codes "
         f"agree")
    ids = np.arange(0, cfg.vocab_size, 3)
    got = ServingEngine(card, art).lookup(ids).cpu()
    want = ServingEngine(cpu, art_cpu, device="cpu").lookup(ids)
    need(torch.equal(bits(got[same[ids]]), bits(want[same[ids]])),
         f"small {cfg.kind} table: rows agree where codes do")
    st_card = drive_random_stream(ServingEngine(card, art, max_queue=512),
                                  cfg.vocab_size, 60, 48, seed=3)
    st_cpu = drive_random_stream(
        ServingEngine(cpu, art_cpu, max_queue=512, device="cpu"),
        cfg.vocab_size, 60, 48, seed=3)
    for c in ("requests", "lookups", "padded_lookups", "flushes"):
        need(getattr(st_card, c) == getattr(st_cpu, c), f"counter {c}")
    log(f"small {cfg.kind} table vs CPU: {int((~same).sum())} of "
        f"{cfg.vocab_size} rows' codes differ at near-ties; rows and "
        f"engine counters agree")


def main_path():
    """deepfm at full width: init -> export -> serve, on the card."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core import Embedding
    from repro_torch.kernels.dpq_assign import dpq_assign, dpq_assign_ref
    from repro_torch.kernels.mgqe_decode import mgqe_decode, mgqe_decode_ref
    from repro_torch.core.mgqe import k_limit_for_all_rows
    from repro_torch.launch.engine import (ServingEngine, drive_random_stream,
                                           embedding_config_of_arch)

    family, cfg = get_arch("deepfm", smoke=False)
    ecfg = embedding_config_of_arch(family, cfg)
    log(f"main path: deepfm field vocab={ecfg.vocab_size} dim={ecfg.dim} "
        f"D={ecfg.num_subspaces} K={ecfg.num_centroids} "
        f"tiers={ecfg.tier_boundaries} K_i={ecfg.tier_num_centroids}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    dpq_assign.launches = 0
    mgqe_decode.launches = 0
    t0 = time.perf_counter()
    emb = Embedding(ecfg)
    params = emb.init(emb.generator(0))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    artifact = emb.export(params)
    torch.cuda.synchronize()
    t_export = time.perf_counter() - t0
    engine = ServingEngine(emb, artifact, max_queue=4096)
    st = drive_random_stream(engine, ecfg.vocab_size, N_REQUESTS, REQ_BATCH)
    launches = {"dpq_assign": dpq_assign.launches,
                "mgqe_decode": mgqe_decode.launches}
    peak = torch.cuda.max_memory_allocated()

    log(f"main path: init {t_init:.3f}s, export {t_export:.3f}s; engine "
        f"{st.requests} requests / {st.lookups} lookups in {st.flushes} "
        f"flushes ({st.padded_lookups} padded), {st.seconds:.6f}s -> "
        f"{st.lookups_per_s:,.0f} lookups/s; launches {launches}; "
        f"peak device memory {peak / 2**20:.1f} MiB")
    for name, n in launches.items():
        need(n > 0, f"{name} launched on the main path")
    need(st.requests == N_REQUESTS, "every request served")

    codes, cent = artifact["codes"], artifact["centroids"]
    need(codes.dtype == torch.uint8
         and tuple(codes.shape) == (ecfg.vocab_size, ecfg.num_subspaces),
         "codes (n, D) uint8")
    # served rows: finite, right shape, and bit-identical to the plain
    # decode of the artifact
    rng = np.random.default_rng(7)
    ids = rng.integers(0, ecfg.vocab_size, 4099)
    rows = engine.lookup(ids)
    ids_t = torch.from_numpy(ids).cuda()
    want = mgqe_decode_ref(codes.index_select(0, ids_t), cent)
    need(tuple(rows.shape) == (4099, ecfg.dim), "served rows (n, dim)")
    need(bool(torch.isfinite(rows).all()), "served rows finite")
    need(torch.equal(rows, want), "served rows == plain decode")
    # exported codes of a head and a tail slice against the plain
    # assignment of the same rows under the same tier budgets
    lim_all = k_limit_for_all_rows(ecfg, "cuda")
    gap = 0.0
    for start in (0, ecfg.tier_boundaries[0] - ASSIGN_BATCH // 2,
                  ecfg.vocab_size - ASSIGN_BATCH):
        rows_e = params["emb"][start:start + ASSIGN_BATCH].reshape(
            ASSIGN_BATCH, ecfg.num_subspaces, -1)
        lim = lim_all[start:start + ASSIGN_BATCH]
        plain = dpq_assign_ref(rows_e, cent, lim)
        got = codes[start:start + ASSIGN_BATCH].to(torch.int32)
        gap = max(gap, assign_gap(rows_e, cent, lim, got, plain))
    need(gap <= ASSIGN_TOL, "exported codes == plain assignment")
    tail = codes[ecfg.tier_boundaries[0]:]
    need(int(tail.max()) < ecfg.tier_num_centroids[1],
         "tail tier codes < K_tail")
    log(f"main path checks: rows bit-identical to the plain decode, "
        f"export codes within {gap:.3g} of the plain assignment, tail "
        f"codes < {ecfg.tier_num_centroids[1]}")

    # where the time goes: device time by kernel under the profiler
    # (which slows the host, so the busy shares are lower bounds)
    profile_phase("export", lambda: emb.export(params))
    profile_phase("serve (warm + measured pass)", lambda: drive_random_stream(
        engine, ecfg.vocab_size, N_REQUESTS, REQ_BATCH))
    return launches, st


def profile_phase(what: str, fn) -> None:
    """Wall time of ``fn()`` under torch.profiler and the device time of
    each kernel and copy it ran, largest first."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = {}
    for ev in prof.key_averages():
        # device-side events only: a host op's entry repeats the time
        # of the kernels it launched
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            device[ev.key] = (us / 1e3, ev.count)
    busy = sum(ms for ms, _ in device.values())
    log(f"profile {what}: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / wall_ms:.1f}%)")
    for name, (ms, n) in sorted(device.items(), key=lambda kv: -kv[1][0])[:6]:
        log(f"  {ms:9.3f} ms  {n:5d}x  {name[:90]}")


def time_kernels(errs: dict, launches: dict) -> list:
    """The ``kernels`` entries: times at the main path's shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import EmbeddingConfig
    from repro_torch.kernels.mgqe_decode import (decode, mgqe_decode,
                                                 mgqe_decode_ref)

    out = []
    # mgqe_decode: deepfm table (D=5, K=256, S=2, f32), serve_bulk batch
    b, d, k, s = serve_bulk_batch(), 5, 256, 2
    codes, cent = decode_inputs(b, d, k, s, torch.float32, seed=11)
    offs = (codes.long() + torch.arange(d, device="cuda") * k).contiguous()
    flat = cent.reshape(d * k, s)
    ms, host = time_ms(lambda: mgqe_decode(codes, cent))
    plain, _ = time_ms(lambda: mgqe_decode_ref(codes, cent))
    lib, lib_host = time_ms(lambda: F.embedding(offs, flat))
    nbytes = b * d * 1 + d * k * s * 4 + b * d * s * 4
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    out.append({"name": "mgqe_decode", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/mgqe_decode.cu",
                "replaces": "src/repro/kernels/mgqe_decode/mgqe_decode.py:54",
                "launches": launches["mgqe_decode"],
                "max_abs_err": errs["mgqe_decode"], "ms": ms,
                "plain_ms": plain, "bound_ms": bound, "bound_by": "bytes",
                "library_ms": lib})
    log(f"time mgqe_decode B={b} D={d} K={k} S={s} f32: kernel {ms:.5f} ms, "
        f"plain {plain:.5f} ms, F.embedding {lib:.5f} ms, bound {bound:.5f} "
        f"ms ({nbytes} bytes); host time to launch: wrapper {host:.5f} ms, "
        f"F.embedding {lib_host:.5f} ms")
    # as the schemes call it: block_b pinned to the config's
    # decode_block_b (the engine's pad multiple), threads a block
    pin = EmbeddingConfig(vocab_size=1, dim=d * s).decode_block_b
    pin_ms, _ = time_ms(lambda: mgqe_decode(codes, cent, block_b=pin))
    log(f"time mgqe_decode B={b} D={d} K={k} S={s} f32 at the schemes' "
        f"block_b={pin}: kernel {pin_ms:.5f} ms")

    # mgqe_decode at the size of one engine flush (max_queue 4,096 ids
    # padded to block_b), and the host time of the dispatched op
    fb = 4352
    f_codes, f_cent = codes[:fb].contiguous(), cent
    f_ms, _ = time_ms(lambda: mgqe_decode(f_codes, f_cent))
    _, op_host = time_ms(lambda: decode(f_codes, f_cent))
    log(f"time mgqe_decode B={fb} (one engine flush): kernel {f_ms:.5f} ms, "
        f"bound {(fb * d * 9 + d * k * s * 4) / HBM_BYTES_PER_S * 1e3:.5f} "
        f"ms; host time to launch through dispatch {op_host:.5f} ms")

    # mgqe_decode at gemma3-4b's prefill shape: the token rows of
    # LM_BATCH x LM_PROMPT prompt tokens, from its token table's
    # centroids in the LM path's dtype (the l2 route: 1,280-byte slots)
    lb, ld, lk, ls, l_dtype = lm_decode_shape()
    l_codes, l_cent = decode_inputs(lb, ld, lk, ls, l_dtype, seed=13)
    got, want = mgqe_decode(l_codes, l_cent), mgqe_decode_ref(l_codes, l_cent)
    torch.cuda.synchronize()
    need(torch.equal(bits(got), bits(want)), f"mgqe_decode bit-identical at "
         f"{LM_ARCH}'s prefill shape")
    del got, want
    l_offs = (l_codes.long() + torch.arange(ld, device="cuda") * lk
              ).contiguous()
    l_flat = l_cent.reshape(ld * lk, ls)
    l_ms, _ = time_ms(lambda: mgqe_decode(l_codes, l_cent))
    l_plain, _ = time_ms(lambda: mgqe_decode_ref(l_codes, l_cent), iters=20,
                         hold=False)
    l_lib, _ = time_ms(lambda: F.embedding(l_offs, l_flat))
    esz = l_cent.element_size()
    l_bytes = lb * ld + ld * lk * ls * esz + lb * ld * ls * esz
    l_bound = l_bytes / HBM_BYTES_PER_S * 1e3
    l_pin, _ = time_ms(lambda: mgqe_decode(l_codes, l_cent, block_b=pin))
    log(f"time mgqe_decode B={lb} D={ld} K={lk} S={ls} {l_dtype} "
        f"({LM_ARCH}'s prefill, bit-identical to the plain version): kernel "
        f"{l_ms:.5f} ms (at the schemes' block_b={pin}: {l_pin:.5f} ms), "
        f"plain {l_plain:.5f} ms, F.embedding {l_lib:.5f} ms, bound "
        f"{l_bound:.5f} ms ({l_bytes} bytes, {100 * l_bound / l_ms:.0f}% of "
        f"it)")
    del l_codes, l_cent, l_offs, l_flat

    # dpq_assign at all four of its shapes: deepfm's export (the main
    # path's, the entry's numbers), the retrieval index, gemma3-4b's
    # token table (f32) and gemma3-27b's (bf16)
    entry = time_assign_shapes()
    out.append({"name": "dpq_assign", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/dpq_assign.cu",
                "replaces": "src/repro/kernels/dpq_assign/dpq_assign.py:44",
                "launches": launches["dpq_assign"],
                "max_abs_err": max(errs["dpq_assign"], entry.pop("gap")),
                **entry, "library_ms": None})
    return out


def assign_bound(e, k, lim, launches):
    """(bound ms, by, FLOP, bytes, centroid evaluations) of ``launches``
    calls over the rows ``e`` (n, D, S): 2*S FLOP for every centroid a
    row's budget reaches (against the dtype's peak) or each row, the
    centroids (once a launch), the budgets and the codes moved once
    (against HBM)."""
    n, d, s = e.shape
    item = e.element_size()
    evaluated = d * (n * k if lim is None
                     else int(lim.clamp(min=0, max=k).long().sum()))
    flops = 2 * s * evaluated
    nbytes = (n * d * s * item + launches * d * k * s * item
              + (0 if lim is None else n * 4) + n * d * 4)
    peak = F32_FLOP_PER_S if item == 4 else BF16_FLOP_PER_S
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops, nbytes, evaluated)


def time_assign_pass(what, e_all, cent, lim_all, batch, iters=5,
                     **route) -> dict:
    """dpq_assign over ``e_all`` in launches of ``batch`` rows, as
    export_codes (65,536) or the index build (all rows at once) runs it:
    per launch, the kernel (``route`` pins its tiles), the plain version
    and the bound; every launch's codes held to the plain version's."""
    import torch
    from repro_torch.kernels.dpq_assign import dpq_assign, dpq_assign_ref
    n, k = e_all.shape[0], cent.shape[1]
    parts = [(e_all[i:i + batch], None if lim_all is None
              else lim_all[i:i + batch]) for i in range(0, n, batch)]

    def run(fn):
        for e, lim in parts:
            fn(e, cent, lim)

    ms, _ = time_ms(lambda: run(lambda e, c, l: dpq_assign(e, c, l,
                                                           **route)),
                    iters=iters, warmup=1)
    plain, _ = time_ms(lambda: run(dpq_assign_ref), iters=1, warmup=1,
                       hold=False)
    gap, mism = 0.0, 0
    for e, lim in parts:
        got = dpq_assign(e, cent, lim, **route)
        want = blocked_assign_ref_lim(e, cent, lim)
        mism += int((got != want).sum())
        gap = max(gap, assign_gap(e, cent, lim, got, want))
    need(gap <= ASSIGN_TOL, f"dpq_assign {what} within {ASSIGN_TOL}")
    bound, by, flops, nbytes, evaluated = assign_bound(e_all, k, lim_all,
                                                       len(parts))
    n_l = len(parts)
    log(f"time dpq_assign {what}: {n_l} launch(es) of {batch} rows, D="
        f"{cent.shape[0]} K={k} S={cent.shape[2]} {e_all.dtype}"
        f"{' ' + str(route) if route else ''}; per launch: kernel "
        f"{ms / n_l:.5f} ms, plain {plain / n_l:.5f} ms, bound "
        f"{bound / n_l:.5f} ms by {by} ({flops} FLOP over {evaluated} "
        f"centroid evaluations, {nbytes} bytes, for all launches); "
        f"{mism} of {e_all.shape[0] * cent.shape[0]} codes differ from "
        f"the plain version, largest distance gap {gap:.3g}")
    return {"ms": ms / n_l, "plain_ms": plain / n_l,
            "bound_ms": bound / n_l, "bound_by": by, "gap": gap}


def lm_assign_inputs(arch_dim, seed, dtype):
    """A 262,144-row LM token table as rows (n, 8, dim / 8) at the init's
    scale, its centroids, and the MGQE budgets of lm_embedding's two
    tiers (head 10% at K=256, tail at K=64), by sorted id as exported."""
    import torch
    from repro_torch.configs.lm_common import lm_embedding
    from repro_torch.core.mgqe import k_limit_for_all_rows
    ecfg = lm_embedding(LM27_VOCAB, arch_dim)
    n, d, k = ecfg.vocab_size, ecfg.num_subspaces, ecfg.num_centroids
    s = ecfg.dim // d
    g = torch.Generator(device="cuda").manual_seed(seed)
    e = (torch.randn((n, d, s), generator=g, device="cuda") * ecfg.dim ** -0.5
         ).to(dtype)
    cent = (torch.randn((d, k, s), generator=g, device="cuda")
            * ecfg.dim ** -0.5).to(dtype)
    return e, cent, k_limit_for_all_rows(ecfg, "cuda")


def time_assign_shapes() -> dict:
    """dpq_assign timed at its four shapes; returns deepfm's export
    numbers (the main path's) with the largest distance gap seen."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.dpq_assign import dpq_assign
    from repro_torch.core.mgqe import k_limit_for_all_rows
    from repro_torch.launch.engine import embedding_config_of_arch
    # deepfm's export, batch by batch as export_codes runs it (65,536
    # rows, budgets of the sorted ids: 15 batches at K=256, one that
    # straddles the tier boundary, 137 at K=64); the kernel's walk, and
    # its tiled product pinned at a k-step of 2 for comparison
    ecfg = embedding_config_of_arch(*get_arch("deepfm", smoke=False))
    n, d, k = ecfg.vocab_size, ecfg.num_subspaces, ecfg.num_centroids
    s = ecfg.dim // d
    g = torch.Generator(device="cuda").manual_seed(12)
    scale = (d * s) ** -0.5
    e_all = torch.randn((n, d, s), generator=g, device="cuda") * scale
    cent = torch.randn((d, k, s), generator=g, device="cuda") * scale
    lim_all = k_limit_for_all_rows(ecfg, "cuda")
    # (a pass queues 153 launches, 306 for the tiled product's two a
    # call: few passes, so the host's queue stays ahead of the card)
    main = time_assign_pass("over deepfm's export", e_all, cent, lim_all,
                            ASSIGN_BATCH, iters=3)
    tiled = time_assign_pass("over deepfm's export, the tiled product",
                             e_all, cent, lim_all, ASSIGN_BATCH, iters=2,
                             block_s=2)
    boundary = ecfg.tier_boundaries[0] // ASSIGN_BATCH * ASSIGN_BATCH
    for what, i in (("head tier (all K=256)", 0),
                    ("straddling the tier boundary", boundary),
                    ("tail tier (all K=64)", n - 2 * ASSIGN_BATCH)):
        e, lim = e_all[i:i + ASSIGN_BATCH], lim_all[i:i + ASSIGN_BATCH]
        ms, host = time_ms(lambda: dpq_assign(e, cent, lim))
        log(f"  one batch {what}, rows {i}..{i + ASSIGN_BATCH} "
            f"({int((lim == k).sum())} at K={k}): kernel {ms:.5f} ms; host "
            f"time to launch: wrapper {host:.5f} ms")
    t, by, flops, _, evaluated = assign_bound(e_all, k, lim_all, 1)
    # with the argmin: per (row, centroid) S FMAs, one FMA for the
    # distance and one compare-and-select, each at one lane-op a clock
    # (67 TFLOP/s = 33.5 T FMA lanes a second)
    n_b = -(-n // ASSIGN_BATCH)
    argmin = evaluated * (s + 2) / (F32_FLOP_PER_S / 2) * 1e3 / n_b
    log(f"  deepfm export bound per launch with the argmin (S + 2 lane "
        f"ops a centroid evaluation): {argmin:.5f} ms; tiled product "
        f"{tiled['ms']:.5f} ms a launch against the walk's "
        f"{main['ms']:.5f}")
    gap = max(main["gap"], tiled["gap"])
    del e_all, cent, lim_all
    # the retrieval index: flat_pq encodes all 1M tower outputs in one
    # launch (D = 8, K = 64, S = 32, no budget)
    g = torch.Generator(device="cuda").manual_seed(13)
    nc = retrieval_candidates()
    e_all = torch.randn((nc, 8, 32), generator=g, device="cuda") * 0.06
    cent = torch.randn((8, 64, 32), generator=g, device="cuda") * 0.06
    r = time_assign_pass("at the index shape", e_all, cent, None, nc,
                         iters=10)
    gap = max(gap, r["gap"])
    del e_all, cent
    # the LM token tables, as export_codes runs them: gemma3-4b (f32,
    # S = 320) and gemma3-27b (bf16, S = 672)
    for dim, dtype, seed in ((2560, torch.float32, 14),
                             (LM27_DIM, torch.bfloat16, 15)):
        e_all, cent, lim_all = lm_assign_inputs(dim, seed, dtype)
        r = time_assign_pass(f"over an LM token table's export (d_model "
                             f"{dim})", e_all, cent, lim_all, ASSIGN_BATCH)
        gap = max(gap, r["gap"])
        del e_all, cent, lim_all
        gc.collect()
        torch.cuda.empty_cache()
    main["gap"] = gap
    return main


def compressed_paths() -> tuple:
    """The third path: deepfm's 10M-row field served by the remaining
    schemes.  ``rq`` through ``launch.serve.serve_engine`` (deepfm's
    CONFIG with embed_kind="rq"), then ``mpe`` through ``Embedding`` and
    ``ServingEngine`` (no arch selects it): init, export, the engine
    stream twice and once more keeping each flush, each scheme with
    every launch count set to 0 just before and read just after; every
    flush's rows held against the plain decode of its ids, the mpe codes
    against the plain assignment, small tables against the CPU; then the
    lrf/sq/hash baselines once each through serve_engine.  Returns
    (launches summed over rq and mpe, errs, the rq flush's padded
    size)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core import Embedding, EmbeddingConfig
    from repro_torch.core.partition import frequency_boundaries, tier_of_ids
    from repro_torch.kernels.dpq_assign import dpq_assign_ref
    from repro_torch.kernels.mgqe_decode import rq_decode_stages_ref
    from repro_torch.kernels.packed_decode import (packed_decode_ref,
                                                   unpack_codes)
    from repro_torch.data.synthetic import zipf_request_stream
    from repro_torch.launch.engine import (ServingEngine, drive_stream,
                                           random_requests)
    from repro_torch.launch.serve import serve_engine

    _, cfg = get_arch("deepfm", smoke=False)
    n = max(cfg.field_vocab_sizes)
    full_bits = n * cfg.embed_dim * 32
    errs = {"rq_decode_stages": 0.0, "packed_decode": 0.0, "dpq_assign": 0.0}

    def counts():
        return {name: fn.launches for name, fn in kernel_counters().items()}

    def hot_small(kind, emb, art):
        """The scheme once more behind a cache of HOT_SMALL rows, on a
        Zipf(1.2) stream: every flush's rows bit-identical to the
        uncached engine's (lrf: its serve path may not depend on B)."""
        reqs = zipf_request_stream(n, N_REQUESTS, REQ_BATCH, zipf_a=1.2,
                                   seed=5)
        cached = ServingEngine(emb, art, max_queue=4096, hot_rows=HOT_SMALL)
        st = dataclasses.replace(drive_stream(cached, reqs))
        kept = drive_keeping_flushes(cached, reqs)
        ref = drive_keeping_flushes(ServingEngine(emb, art, max_queue=4096),
                                    reqs)
        for (_, got), (_, want) in zip(kept, ref):
            need(torch.equal(bits(torch.cat(got)), bits(torch.cat(want))),
                 f"{kind} cached rows == uncached rows")
        log(f"{kind} behind a hot cache of {HOT_SMALL} rows (Zipf 1.2): hit "
            f"rate {st.hit_rate:.4f}, {st.decoded_lookups} of "
            f"{st.padded_lookups} rows decoded, {st.lookups_per_s:,.0f} "
            f"lookups/s; {len(kept)} flushes bit-identical to the uncached "
            f"engine's")

    def hold_flushes(kind, kept, plain):
        """Every kept flush's rows against plain(ids), bit for bit."""
        for flat, res in kept:
            ids = torch.from_numpy(flat).cuda()
            rows = torch.cat(res)
            need(tuple(rows.shape) == (flat.shape[0], cfg.embed_dim)
                 and bool(torch.isfinite(rows).all()),
                 f"{kind} rows (n, dim), finite")
            need(torch.equal(bits(rows), bits(plain(ids))),
                 f"{kind} flush rows == plain decode")

    # ---------------------------------------------------------------- rq
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    run = serve_engine("recsys", dataclasses.replace(cfg, embed_kind="rq"),
                       N_REQUESTS, REQ_BATCH, max_queue=4096)
    kept = drive_keeping_flushes(run.engine, run.requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rq_launches = counts()
    ecfg, st = run.emb.cfg, run.stats
    flushes = 2 * st.flushes + len(kept)        # warm, measured, kept
    log(f"rq path: deepfm field vocab={ecfg.vocab_size} dim={ecfg.dim} "
        f"M={ecfg.num_levels} K={ecfg.num_centroids}; {wall:.3f}s in all; "
        f"artifact {run.emb.serving_size_bits() / 8e6:.2f} MB "
        f"({100 * run.emb.serving_size_bits() / full_bits:.2f}% of full); "
        f"engine {st.requests} requests / {st.lookups} lookups in "
        f"{st.flushes} flushes ({st.padded_lookups} padded), "
        f"{st.seconds:.6f}s -> {st.lookups_per_s:,.0f} lookups/s; launches "
        f"{rq_launches} over {flushes} flushes; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    need(st.requests == N_REQUESTS, "every rq request served")
    need(rq_launches["rq_decode_stages"] == flushes,
         "rq_decode_stages launched once per flush")
    codes, cbs = run.artifact["codes"], run.artifact["codebooks"]
    need(codes.dtype == torch.uint8 and tuple(codes.shape)
         == (n, ecfg.num_levels), "rq codes (n, M) uint8")
    hold_flushes("rq", kept, lambda ids: rq_decode_stages_ref(
        codes.index_select(0, ids), cbs))
    flush_b = st.padded_lookups // st.flushes
    profile_phase("rq serve (warm + measured pass)",
                  lambda: drive_stream(run.engine, run.requests))
    hot_small("rq", run.emb, run.artifact)
    del run, kept, codes, cbs
    small_table_against_cpu(EmbeddingConfig(
        vocab_size=5000, dim=10, kind="rq", num_levels=5, num_centroids=256))

    # --------------------------------------------------------------- mpe
    mcfg = EmbeddingConfig(vocab_size=n, dim=cfg.embed_dim, kind="mpe",
                           num_subspaces=cfg.num_subspaces,
                           tier_boundaries=frequency_boundaries(
                               n, (0.05, 0.25)),
                           tier_bits=(8, 4, 2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    emb = Embedding(mcfg)
    params = emb.init(emb.generator(0))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    art = emb.export(params)
    torch.cuda.synchronize()
    t_export = time.perf_counter() - t0
    engine = ServingEngine(emb, art, max_queue=4096)
    reqs = random_requests(n, N_REQUESTS, REQ_BATCH)
    # a copy: the kept pass below adds to the engine's own stats
    st = dataclasses.replace(drive_stream(engine, reqs))
    kept = drive_keeping_flushes(engine, reqs)
    torch.cuda.synchronize()
    mpe_launches = counts()
    flushes = 2 * st.flushes + len(kept)
    tiers = len(mcfg.tier_bits)
    batches = -(-n // ASSIGN_BATCH)
    log(f"mpe path: vocab={n} dim={mcfg.dim} D={mcfg.num_subspaces} "
        f"tiers={mcfg.tier_boundaries} bits={mcfg.tier_bits} W="
        f"{[c.shape[1] for c in art['codes']]}; init {t_init:.3f}s, export "
        f"{t_export:.3f}s; artifact {emb.serving_size_bits() / 8e6:.2f} MB "
        f"({100 * emb.serving_size_bits() / full_bits:.2f}% of full); "
        f"engine {st.requests} requests / {st.lookups} lookups in "
        f"{st.flushes} flushes ({st.padded_lookups} padded), "
        f"{st.seconds:.6f}s -> {st.lookups_per_s:,.0f} lookups/s; launches "
        f"{mpe_launches} over {flushes} flushes; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    need(st.requests == N_REQUESTS, "every mpe request served")
    need(mpe_launches["packed_decode"] == tiers * flushes,
         "packed_decode launched once per tier per flush")
    need(mpe_launches["dpq_assign"] == tiers * batches,
         "dpq_assign launched once per tier per export batch")
    cents = art["centroids"]

    def mpe_plain(ids):
        tier = tier_of_ids(ids, mcfg.tier_boundaries)
        out = None
        for i, (b_i, cent) in enumerate(zip(mcfg.tier_bits, cents)):
            rows = packed_decode_ref(art["codes"][i].index_select(0, ids),
                                     cent, b_i)
            out = rows if out is None else torch.where(
                (tier == i)[:, None], rows, out)
        return out

    hold_flushes("mpe", kept, mpe_plain)
    # each tier's codes, unpacked, of a head slice, the slices across both
    # tier boundaries and the tail, against the plain assignment
    gap = 0.0
    starts = [0] + [b - ASSIGN_BATCH // 2 for b in mcfg.tier_boundaries] \
        + [n - ASSIGN_BATCH]
    for i, (b_i, cent) in enumerate(zip(mcfg.tier_bits, cents)):
        for start in starts:
            e = params["emb"][start:start + ASSIGN_BATCH].reshape(
                ASSIGN_BATCH, mcfg.num_subspaces, -1)
            got = unpack_codes(art["codes"][i][start:start + ASSIGN_BATCH],
                               b_i, mcfg.num_subspaces).to(torch.int32)
            gap = max(gap, assign_gap(e, cent, None, got,
                                      dpq_assign_ref(e, cent)))
    need(gap <= ASSIGN_TOL, "mpe codes == plain assignment")
    errs["dpq_assign"] = gap
    log(f"third path checks: every rq and mpe flush bit-identical to the "
        f"plain decode of its ids; mpe codes of every tier within {gap:.3g}"
        f" of the plain assignment")
    profile_phase("mpe export", lambda: emb.export(params))
    profile_phase("mpe serve (warm + measured pass)",
                  lambda: drive_stream(engine, reqs))
    hot_small("mpe", emb, art)
    del params, art, engine, kept, emb
    small_table_against_cpu(EmbeddingConfig(
        vocab_size=5000, dim=10, kind="mpe", num_subspaces=5,
        tier_boundaries=(250, 1250), tier_bits=(8, 4, 2)))

    # --------------------------------------------------------- baselines
    # the paper's comparison (§3.4) on the same field; no kernel runs
    reset_counts()
    for kind in ("lrf", "sq", "hash"):
        run = serve_engine("recsys", dataclasses.replace(cfg,
                                                         embed_kind=kind),
                           N_REQUESTS, REQ_BATCH, max_queue=4096)
        rows = run.engine.lookup(run.requests[0])
        need(run.stats.requests == N_REQUESTS
             and tuple(rows.shape) == (len(run.requests[0]), cfg.embed_dim)
             and bool(torch.isfinite(rows).all()),
             f"{kind}: every request served, rows finite")
        log(f"baseline {kind}: artifact "
            f"{run.emb.serving_size_bits() / 8e6:.2f} MB "
            f"({100 * run.emb.serving_size_bits() / full_bits:.2f}% of full),"
            f" {run.stats.lookups_per_s:,.0f} lookups/s")
        hot_small(kind, run.emb, run.artifact)
        del run
    need(not any(counts().values()), "the baselines launch no kernel")
    launches = {name: rq_launches[name] + mpe_launches[name]
                for name in rq_launches}
    gc.collect()
    torch.cuda.empty_cache()
    return launches, errs, flush_b


def time_decode_kernels(errs: dict, launches: dict, flush_b: int) -> list:
    """The ``kernels`` entries of rq_decode_stages and packed_decode at
    the third path's shapes, beside the bound, the plain version and,
    for rq, ``F.embedding_bag``: rq at one engine flush (``flush_b``
    rows, the shape of every launch the path counted: the l2 route),
    packed_decode at B = 262,144 (the bulk-serving batch; its flushes
    take the same smem route).  Also logged, each with the launch plan
    it took: rq at B = 262,144 (the smem route), in bfloat16, at the
    schemes' pinned block_b (256 threads a block), on both routes at
    32,768, 65,536 and 262,144 rows, at B = 256 and at the JAX bench's
    d = 64; packed_decode in bfloat16, at block_b=256, at one flush and
    at B = 256."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_chunks import walk, warp_bytes
    from repro_torch.kernels.mgqe_decode import (decode_stages,
                                                 rq_decode_stages,
                                                 rq_decode_stages_ref)
    from repro_torch.kernels.mgqe_decode.mgqe_decode import (
        RQ_L2_MAX_GRID, RQ_L2_THREADS, RQ_SMEM_MIN_ROWS, RqPlan, rq_plan)
    from repro_torch.kernels.packed_decode import (pack_codes, packed_decode,
                                                   packed_decode_ref,
                                                   packed_width)
    from repro_torch.kernels.packed_decode.packed_decode import packed_plan

    def bound(nbytes, ops):
        t_b = nbytes / HBM_BYTES_PER_S * 1e3
        t_o = ops / F32_FLOP_PER_S * 1e3
        return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"

    def rq_times(c, cb):
        """(kernel, plain, F.embedding_bag, bound, bound_by, bytes, host
        times of the wrapper and of F.embedding_bag) of rq at c's rows."""
        rows = c.shape[0]
        offs = (c.long() + torch.arange(m, device="cuda") * k).contiguous()
        flat = cb.reshape(m * k, d)
        t_k, host = time_ms(lambda: rq_decode_stages(c, cb))
        t_p, _ = time_ms(lambda: rq_decode_stages_ref(c, cb), iters=50)
        t_l, l_host = time_ms(lambda: F.embedding_bag(offs, flat,
                                                      mode="sum"))
        nbytes = rows * m + m * k * d * 4 + rows * d * 4
        t_b, by = bound(nbytes, rows * (m - 1) * d)
        return t_k, t_p, t_l, t_b, by, nbytes, host, l_host

    out = []
    sms = build.sm_count("cuda")
    g = torch.Generator(device="cuda").manual_seed(41)
    b, m, k, d = serve_bulk_batch(), 5, 256, 10
    codes, cbs = rq_inputs(b, m, k, d, torch.float32, g)
    for rows in (flush_b, b):
        c = codes[:rows].contiguous()
        plan = rq_plan(rows, m, k, d, 1, 4, sms)
        ms, plain, lib, t, by, nbytes, host, lib_host = rq_times(c, cbs)
        if rows == flush_b:
            out.append({
                "name": "rq_decode_stages", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/rq_decode_stages.cu",
                "replaces": "src/repro/kernels/mgqe_decode/mgqe_decode.py:103",
                "launches": launches["rq_decode_stages"],
                "max_abs_err": errs["rq_decode_stages"], "ms": ms,
                "plain_ms": plain, "bound_ms": t, "bound_by": by,
                "library_ms": lib})
        log(f"time rq_decode_stages B={rows}"
            f"{' (one engine flush: the entry)' if rows == flush_b else ''}"
            f" M={m} K={k} d={d} f32 {plan}: kernel {ms:.5f} ms, plain "
            f"{plain:.5f} ms, F.embedding_bag {lib:.5f} ms, bound {t:.5f} ms"
            f" by {by} ({nbytes} bytes); host time to launch: wrapper "
            f"{host:.5f} ms, F.embedding_bag {lib_host:.5f} ms")
    cbs16 = cbs.to(torch.bfloat16)
    p16 = rq_plan(b, m, k, d, 1, 2, sms)
    ms16, _ = time_ms(lambda: rq_decode_stages(codes, cbs16))
    log(f"time rq_decode_stages B={b} bf16 {p16}: kernel {ms16:.5f} ms, "
        f"bound {(b * m + m * k * d * 2 + b * d * 2) / HBM_BYTES_PER_S * 1e3:.5f}"
        f" ms")
    # both routes either side of the smem route's least batch, and at
    # serve_bulk: the planner's rule
    for fb in (RQ_SMEM_MIN_ROWS // 2, RQ_SMEM_MIN_ROWS, b):
        f_codes = codes[:fb].contiguous()
        w = walk(fb, m * k * d * 4, warp_bytes(m, d * 4), sms)
        smem = RqPlan("smem", w.threads, 2, w.grid, w.smem)
        l2 = RqPlan("l2", RQ_L2_THREADS, 2,
                    min(-(-fb * d // 2 // RQ_L2_THREADS), RQ_L2_MAX_GRID), 0)
        t_s, _ = time_ms(lambda: rq_decode_stages(f_codes, cbs, plan=smem))
        t_l, _ = time_ms(lambda: rq_decode_stages(f_codes, cbs, plan=l2))
        log(f"time rq_decode_stages B={fb} f32 on each route: smem "
            f"{t_s:.5f} ms, l2 {t_l:.5f} ms (the planner's: "
            f"{rq_plan(fb, m, k, d, 1, 4, sms).route})")
    p256 = rq_plan(b, m, k, d, 1, 4, sms, block_b=256)
    ms256, _ = time_ms(lambda: rq_decode_stages(codes, cbs, 256))
    log(f"time rq_decode_stages B={b} f32 at the schemes' block_b=256 "
        f"{p256}: kernel {ms256:.5f} ms")
    f_codes = codes[:256].contiguous()
    f_ms, _ = time_ms(lambda: rq_decode_stages(f_codes, cbs))
    _, op_host = time_ms(lambda: decode_stages(f_codes, cbs))
    log(f"time rq_decode_stages B=256 {rq_plan(256, m, k, d, 1, 4, sms)}: "
        f"kernel {f_ms:.5f} ms, bound "
        f"{(256 * (m + d * 4) + m * k * d * 4) / HBM_BYTES_PER_S * 1e3:.5f} "
        f"ms; host time to launch through dispatch {op_host:.5f} ms")
    # the bench's d = 64: 256 KB of codebooks, read through L2
    c64, cb64 = rq_inputs(b, 4, 256, 64, torch.float32, g)
    ms64, _ = time_ms(lambda: rq_decode_stages(c64, cb64))
    t64, _ = bound(b * 4 + 4 * 256 * 64 * 4 + b * 64 * 4, b * 3 * 64)
    log(f"time rq_decode_stages B={b} M=4 K=256 d=64 f32 "
        f"{rq_plan(b, 4, 256, 64, 1, 4, sms)}: kernel {ms64:.5f} ms, bound "
        f"{t64:.5f} ms")
    del codes, cbs, cbs16, c64, cb64

    # packed_decode: one launch per mpe tier, D=5, S=2, K = 2**bits
    dd, s = 5, 2
    rows = {}
    for nb in (8, 4, 2):
        raw = torch.randint(0, 2 ** nb, (b, dd), generator=g, device="cuda",
                            dtype=torch.int32)
        packed = pack_codes(raw, nb)
        cent = torch.randn((dd, 2 ** nb, s), generator=g, device="cuda")
        cent16 = cent.to(torch.bfloat16)
        t_k, host = time_ms(lambda: packed_decode(packed, cent, nb))
        t_p, _ = time_ms(lambda: packed_decode_ref(packed, cent, nb),
                         iters=50)
        t_16, _ = time_ms(lambda: packed_decode(packed, cent16, nb))
        t_256, _ = time_ms(lambda: packed_decode(packed, cent, nb, 256))
        w = packed_width(dd, nb)
        nbytes = b * w + dd * 2 ** nb * s * 4 + b * dd * s * 4
        t_b, by = bound(nbytes, 0)
        f_packed = packed[:flush_b].contiguous()
        t_f, _ = time_ms(lambda: packed_decode(f_packed, cent, nb))
        s_packed = packed[:256].contiguous()
        t_s, _ = time_ms(lambda: packed_decode(s_packed, cent, nb))
        rows[nb] = (t_k, t_p, t_b)
        log(f"time packed_decode B={b} D={dd} S={s} bits={nb} W={w} "
            f"{packed_plan(b, dd, s, nb, 4, sms)}: kernel {t_k:.5f} ms, plain "
            f"{t_p:.5f} ms, bound {t_b:.5f} ms by {by} ({nbytes} bytes); "
            f"bf16 {t_16:.5f} ms (bound "
            f"{(b * w + dd * 2 ** nb * s * 2 + b * dd * s * 2) / HBM_BYTES_PER_S * 1e3:.5f}"
            f" ms); at the schemes' block_b=256 {t_256:.5f} ms; at one flush "
            f"(B={flush_b}) {t_f:.5f} ms; at B=256 {t_s:.5f} ms; host time "
            f"to launch: wrapper {host:.5f} ms")
    mean = [sum(r[i] for r in rows.values()) / len(rows) for i in range(3)]
    out.append({"name": "packed_decode", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/packed_decode.cu",
                "replaces": "src/repro/kernels/packed_decode/packed_decode.py:57",
                "launches": launches["packed_decode"],
                "max_abs_err": errs["packed_decode"], "ms": mean[0],
                "plain_ms": mean[1], "bound_ms": mean[2], "bound_by": "bytes",
                "library_ms": None})
    log(f"packed_decode per launch, mean of the three tiers at B={b}: "
        f"kernel {mean[0]:.5f} ms, plain {mean[1]:.5f} ms, bound "
        f"{mean[2]:.5f} ms")
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------
# the hot-row phase: deepfm's 10M-row MGQE field behind the hot-row
# cache, refreshed, and behind the async front-end
# ----------------------------------------------------------------------

def best_pass(engine, reqs, passes=HOT_PASSES):
    """A warm pass, then ``passes`` measured ones (EMA counters zeroed
    with the stats); the stats of the fastest, as the JAX bench keeps."""
    import dataclasses
    from repro_torch.launch.engine import EngineStats
    engine.serve_stream(reqs)
    best = None
    for _ in range(passes):
        engine.stats_ = EngineStats()
        if engine._freq is not None:
            engine._freq.zero_()
        st = dataclasses.replace(engine.serve_stream(reqs))
        if best is None or st.lookups_per_s > best.lookups_per_s:
            best = st
    return best


def moving_head(perm, n_requests, req_batch, seed):
    """Zipf(1.2) requests over ``perm``: the hottest ids are perm[0],
    perm[1], ..., not the head ids the cache is seeded with."""
    import numpy as np
    from repro_torch.data.synthetic import zipf_ids
    rng = np.random.default_rng(seed)
    return [perm[zipf_ids(rng, int(rng.integers(1, req_batch + 1)),
                          len(perm), 1.2)] for _ in range(n_requests)]


def split_breakdown(engine, kept) -> str:
    """Where a cached flush's host time goes: the host split
    (``split_flush``) and the one pinned upload, per flush, over the
    kept flushes (padded as run_flat pads them)."""
    import numpy as np
    import torch
    hot = engine._hot
    t_split = t_up = 0.0
    for flat, _ in kept:
        n_valid = flat.shape[0]
        padded = np.zeros(n_valid + (-n_valid) % engine.pad_multiple,
                          np.int32)
        padded[:n_valid] = flat
        t0 = time.perf_counter()
        buf, _, _ = engine.split_flush(padded, n_valid, hot[1])
        t1 = time.perf_counter()
        engine._upload(buf)
        torch.cuda.synchronize()
        t_up += time.perf_counter() - t1
        t_split += t1 - t0
    k = len(kept)
    return (f"host split {1e3 * t_split / k:.5f} ms and pinned upload "
            f"(synchronised) {1e3 * t_up / k:.5f} ms a flush")


def hot_cache_phase(card: str) -> dict:
    """deepfm's largest field (10M rows, mgqe/shared_k, D=5, S=2, K=256/64)
    exported with a hot block of HOT_ROWS rows and served: (1) the JAX
    bench's Zipf stream at three exponents through the cached engine and
    an uncached one, every flush bit-identical between them and to the
    plain decode, a fully cached flush launching no decode; (2) a stream
    whose head moved, refreshed every REFRESH_EVERY flushes: the hit rate
    rises, the rows stay bit-identical, one refresh timed; (3) the async
    front-end on open-loop streams at ASYNC_RATES, every future's rows
    bit-identical to the synchronous engine's, p50/p99/p999 and the SLO;
    then once more with background refreshes and ``refresh_now`` fired
    mid-stream.  Counts set to 0 just before, read just after; returns
    them."""
    import dataclasses
    import threading

    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core import Embedding
    from repro_torch.data.synthetic import (open_loop_arrivals,
                                            zipf_open_loop_stream,
                                            zipf_request_stream)
    from repro_torch.kernels.mgqe_decode import mgqe_decode, mgqe_decode_ref
    from repro_torch.launch.async_engine import (AsyncServingEngine,
                                                 drive_open_loop)
    from repro_torch.launch.engine import (ServingEngine,
                                           embedding_config_of_arch)

    family, cfg = get_arch("deepfm", smoke=False)
    ecfg = dataclasses.replace(embedding_config_of_arch(family, cfg),
                               hot_rows=HOT_ROWS)
    n, dim = ecfg.vocab_size, ecfg.dim
    log(f"hot-row phase: deepfm field vocab={n} dim={dim} "
        f"D={ecfg.num_subspaces} K={ecfg.tier_num_centroids} hot_rows="
        f"{HOT_ROWS} ({HOT_ROWS * dim * 4 / 1e6:.0f} MB block, "
        f"{n * 4 / 1e6:.0f} MB host slot map)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counts()
    t_phase = time.perf_counter()
    emb = Embedding(ecfg)
    params = emb.init(emb.generator(0))
    t0 = time.perf_counter()
    art = emb.export(params)           # codes, then the block (B = C)
    torch.cuda.synchronize()
    t_export = time.perf_counter() - t0
    del params
    codes, cent = art["codes"], art["centroids"]

    def plain(ids):
        ids = torch.as_tensor(np.asarray(ids)).cuda()
        return mgqe_decode_ref(codes.index_select(0, ids), cent)

    def same(got, ids, what):
        need(tuple(got.shape) == (len(ids), dim)
             and bool(torch.isfinite(got).all()), f"{what}: (n, dim), finite")
        need(torch.equal(bits(got), bits(plain(ids))), f"{what} == plain "
             f"decode")

    need(tuple(art["hot"].shape) == (HOT_ROWS, dim), "hot leaf (C, dim)")
    same(art["hot"], np.arange(HOT_ROWS), "the exported hot block")
    cached = ServingEngine(emb, art, max_queue=HOT_MAX_QUEUE)
    uncached = ServingEngine(emb, art, max_queue=HOT_MAX_QUEUE, hot_rows=0)
    need(cached._hot_block is cached.artifact["hot"],
         "the engine serves the exported block")
    log(f"hot-row phase: export {t_export:.3f}s (dpq_assign, then the "
        f"block through mgqe_decode at B={HOT_ROWS}) [{card}]")

    # (1) the JAX bench's stream at three exponents
    for a in HOT_ZIPF:
        reqs = zipf_request_stream(n, HOT_REQUESTS, HOT_REQ_BATCH,
                                   zipf_a=a, seed=17)
        st0, st1 = best_pass(uncached, reqs), best_pass(cached, reqs)
        kept1 = drive_keeping_flushes(cached, reqs)
        kept0 = drive_keeping_flushes(uncached, reqs)
        for (flat, got), (_, want) in zip(kept1, kept0):
            rows = torch.cat(got)
            need(torch.equal(bits(rows), bits(torch.cat(want))),
                 "cached rows == uncached rows")
            same(rows, flat, "a cached flush")
        log(f"hot cache zipf_a={a}: hit rate {st1.hit_rate:.4f}; "
            f"{st1.decoded_lookups} of {st1.padded_lookups} rows decoded "
            f"({st0.decoded_lookups} uncached); cached "
            f"{st1.lookups_per_s:,.0f} lookups/s, uncached "
            f"{st0.lookups_per_s:,.0f} ({st1.lookups_per_s / st0.lookups_per_s:.2f}x;"
            f" best of {HOT_PASSES} passes of {st1.flushes} flushes); "
            f"{len(kept1)} flushes bit-identical to the uncached engine and "
            f"the plain decode [{card}]")
        if a == 1.2:
            log(f"  a cached flush at zipf_a=1.2: "
                f"{split_breakdown(cached, kept1)}; device "
                f"{1e3 * st1.seconds / st1.flushes:.5f} ms a flush in all "
                f"(uncached {1e3 * st0.seconds / st0.flushes:.5f})")
            profile_phase("cached serve at zipf_a=1.2 (one pass)",
                          lambda: cached.serve_stream(reqs))
    before = mgqe_decode.launches
    head = np.arange(0, HOT_ROWS, 311)
    same(cached.lookup(head), head, "a wholly cached flush")
    launched = mgqe_decode.launches - before
    need(launched == 0, "a wholly cached flush launches no decode")
    log(f"hot cache: a flush of {len(head)} cached ids launched "
        f"{launched} mgqe_decode")

    # (2) the head moved: refreshes re-point the cache
    perm = np.random.default_rng(23).permutation(n)
    reqs = moving_head(perm, REFRESH_REQUESTS, HOT_REQ_BATCH, seed=29)
    eng = ServingEngine(emb, art, max_queue=HOT_MAX_QUEUE,
                        hot_refresh_every=REFRESH_EVERY)
    per_flush, pending = [], []
    for r in reqs:
        eng.submit(r)
        pending.append(r)
        if eng.should_flush() or r is reqs[-1]:
            h0, l0 = eng.stats_.hot_hits, eng.stats_.lookups
            rows = torch.cat(eng.flush())
            same(rows, np.concatenate(pending), "a refreshed flush")
            per_flush.append((eng.stats_.hot_hits - h0,
                              eng.stats_.lookups - l0))
            pending.clear()
    first = per_flush[:REFRESH_EVERY]
    late = per_flush[2 * REFRESH_EVERY:]
    rate = lambda fl: sum(h for h, _ in fl) / sum(m for _, m in fl)
    need(len(late) > 0 and rate(late) > rate(first),
         "the hit rate rises after the refreshes")
    need(eng.stats_.hot_refreshes == len(per_flush) // REFRESH_EVERY,
         "a refresh every REFRESH_EVERY flushes")
    log(f"refresh: {len(per_flush)} flushes, {eng.stats_.hot_refreshes} "
        f"refreshes every {REFRESH_EVERY}; hit rate {rate(first):.4f} over "
        f"the flushes before the first, {rate(late):.4f} after the second; "
        f"rows bit-identical to the plain decode [{card}]")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = eng.select_hot_ids()
    t_select = time.perf_counter() - t0
    new_ids = np.sort(perm[:HOT_ROWS])
    t0 = time.perf_counter()
    eng.refresh_hot_rows(new_ids)
    torch.cuda.synchronize()
    t_refresh = time.perf_counter() - t0
    same(eng.lookup(perm[:4096]), perm[:4096], "rows after a refresh")
    log(f"one refresh: select_hot_ids (a stable sort of {n} counters, the "
        f"top {len(ids)} copied to the host) {1e3 * t_select:.3f} ms; "
        f"re-decode of {HOT_ROWS} rows, slot map and install "
        f"{1e3 * t_refresh:.3f} ms (host wall, synchronised) [{card}]")

    def one_refresh():
        eng.select_hot_ids()
        eng.refresh_hot_rows(np.sort(perm[-HOT_ROWS:]))

    profile_phase("one refresh (select, re-decode, install)", one_refresh)
    del eng

    # (3) the async front-end, open loop, on its own CUDA streams
    gc.collect()
    gc.freeze()
    try:
        a_eng = AsyncServingEngine(cached, max_wait_us=ASYNC_WAIT_US)
        try:
            for rows in (1, cached.pad_multiple + 1):   # both padded shapes
                a_eng.lookup(np.zeros(rows, np.int64), timeout=60)
            met = 0
            for rate_rps in ASYNC_RATES:
                arrivals, reqs = zipf_open_loop_stream(
                    n, rate_rps, ASYNC_SECONDS, ASYNC_REQ_BATCH, zipf_a=1.2,
                    seed=7)
                a_eng.reset_stats()
                futs = []
                st = drive_open_loop(a_eng, reqs, arrivals, timeout=120,
                                     futures=futs)
                check_async(futs, reqs, uncached, st)
                if st.p99_ms <= SLO_MS:
                    met = max(met, rate_rps)
                log(f"async at {rate_rps} req/s: {st.requests} requests / "
                    f"{st.lookups} lookups over {st.wall_seconds:.3f}s -> "
                    f"{st.sustained_lookups_per_s:,.0f} lookups/s sustained;"
                    f" p50 {st.p50_ms:.4f} ms, p99 {st.p99_ms:.4f} ms, p999 "
                    f"{st.p999_ms:.4f} ms (SLO p99 <= {SLO_MS} ms: "
                    f"{'MET' if st.p99_ms <= SLO_MS else 'MISSED'}); flushes "
                    f"{st.flushes}: {st.flushes_full} full, "
                    f"{st.flushes_deadline} deadline, {st.flushes_drain} "
                    f"drain; hit rate {st.hit_rate:.4f}; device "
                    f"{st.seconds:.4f}s [{card}]")
            log(f"async: highest rate meeting the SLO (p99 <= {SLO_MS} ms): "
                f"{met} req/s of {ASYNC_RATES} [{card}]")
        finally:
            a_eng.close(timeout=120)
        # once more with the refresher: a moving head, refresh_now fired
        # mid-stream beside the background cadence
        eng = ServingEngine(emb, art, max_queue=HOT_MAX_QUEUE)
        a_eng = AsyncServingEngine(eng, max_wait_us=ASYNC_WAIT_US,
                                   refresh_every=ASYNC_REFRESH_EVERY)
        try:
            arrivals = open_loop_arrivals(ASYNC_REFRESH_RATE,
                                          duration_s=ASYNC_SECONDS, seed=31)
            reqs = moving_head(perm, len(arrivals), ASYNC_REQ_BATCH,
                               seed=37)
            kick = threading.Timer(ASYNC_SECONDS / 2, a_eng.refresh_now)
            kick.start()
            futs = []
            st = drive_open_loop(a_eng, reqs, arrivals, timeout=120,
                                 futures=futs)
            kick.join()
            check_async(futs, reqs, uncached, st)
            need(st.hot_refreshes > 0, "the refresher ran")
            need(not np.array_equal(eng._hot_ids, np.arange(HOT_ROWS)),
                 "the refresher re-pointed the cache")
            log(f"async with refreshes every {ASYNC_REFRESH_EVERY} flushes "
                f"and refresh_now mid-stream at {ASYNC_REFRESH_RATE} req/s: "
                f"{st.hot_refreshes} refreshes over {st.flushes} flushes, "
                f"hit rate {st.hit_rate:.4f}; p50 {st.p50_ms:.4f} ms, p99 "
                f"{st.p99_ms:.4f} ms, p999 {st.p999_ms:.4f} ms; every "
                f"future bit-identical to the synchronous engine [{card}]")
        finally:
            a_eng.close(timeout=120)
    finally:
        gc.unfreeze()
    launches = {name: fn.launches for name, fn in counters.items()}
    for name in ("dpq_assign", "mgqe_decode"):
        need(launches[name] > 0, f"{name} launched on the hot-row phase")
    log(f"hot-row phase: {time.perf_counter() - t_phase:.1f}s; launches "
        f"{launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    del cached, uncached, eng, a_eng, art, codes, cent
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def check_async(futs, reqs, sync_engine, st) -> None:
    """Every future resolved, its rows bit-identical to the synchronous
    engine's for the same ids; the triggers account for every flush."""
    import numpy as np
    need(len(futs) == len(reqs) and st.latency.count == len(reqs),
         "one latency sample a request")
    need(st.flushes_full + st.flushes_deadline + st.flushes_drain
         == st.flushes, "the triggers sum to the flushes")
    got = np.concatenate([f.result(timeout=60) for f in futs])
    want = sync_engine.lookup(np.concatenate(reqs)).cpu().numpy()
    need(got.shape == want.shape
         and np.array_equal(got.view(np.int32), want.view(np.int32)),
         "async rows == synchronous rows")


# ----------------------------------------------------------------------
# the fourth path: the recsys fields' embedding_bag, DeepFM served and
# trained
# ----------------------------------------------------------------------

def bag_inputs(b, v, d, seed, max_len=BAG_MAX_LEN):
    """b bags of 0..max_len uniform ids over v rows (bags 0 and b // 2
    left empty), int32 ids and sorted segment ids, float32 weights, all
    on the card."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, max_len + 1, b)
    lens[[0, b // 2]] = 0
    seg = np.repeat(np.arange(b, dtype=np.int32), lens)
    ids = rng.integers(0, v, seg.size, dtype=np.int32)
    w = rng.normal(size=seg.size).astype(np.float32)
    return (torch.from_numpy(ids).cuda(), torch.from_numpy(seg).cuda(),
            torch.from_numpy(w).cuda())


def zipf_lens(b, total, seed, a=BAG_ZIPF_A, cap=BAG_ZIPF_CAP):
    """b bag lengths floor(c * rank^-a), at most cap, c chosen so that
    they sum to about ``total``, in an order drawn from ``seed``."""
    import numpy as np
    r = np.arange(1, b + 1, dtype=np.float64) ** -a
    lo, hi = 0.0, float(total)
    for _ in range(60):                      # bisect c
        c = (lo + hi) / 2
        if np.minimum(np.floor(c * r), cap).sum() < total:
            lo = c
        else:
            hi = c
    lens = np.minimum(np.floor(hi * r), cap).astype(np.int64)
    return np.random.default_rng(seed).permutation(lens)


def bag_cases(v, d, seed):
    """The bag phase's extra cases, each (name, ids, seg, b, w) on the
    card: BAG_BATCH Zipf bags (nnz about the uniform bags' mean,
    BAG_BATCH * BAG_MAX_LEN / 2), one bag of every id of the first
    BAG_ONE_ROWS rows (it spans many chunks), and BAG_EMPTY bags all
    empty but the last."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed + 1)
    lens = zipf_lens(BAG_BATCH, BAG_BATCH * BAG_MAX_LEN // 2, seed + 2)
    zseg = np.repeat(np.arange(BAG_BATCH, dtype=np.int32), lens)
    zids = rng.integers(0, v, zseg.size, dtype=np.int32)
    one = rng.permutation(BAG_ONE_ROWS).astype(np.int32)
    last = rng.integers(0, v, 9, dtype=np.int32)

    def card(*arrays):
        return [torch.from_numpy(a).cuda() for a in arrays]

    return [("zipf", *card(zids, zseg), BAG_BATCH,
             *card(rng.normal(size=zseg.size).astype(np.float32))),
            ("one bag", *card(one, np.zeros(BAG_ONE_ROWS, np.int32)), 1,
             *card(rng.normal(size=BAG_ONE_ROWS).astype(np.float32))),
            ("empty but the last",
             *card(last, np.full(9, BAG_EMPTY - 1, np.int32)), BAG_EMPTY,
             *card(rng.normal(size=9).astype(np.float32)))]


def check_bag_case(table, ids, seg, b, w) -> float:
    """The kernel against the in-order version on the card (which adds
    in the kernel's order): bit-identical; and against the plain
    version (one float32 segment sum) within its bar.  Returns the
    largest |diff| to the plain version."""
    import torch
    from repro_torch.kernels.embedding_bag import (embedding_bag,
                                                   embedding_bag_inorder,
                                                   embedding_bag_ref)
    got = embedding_bag(table, ids, seg, b, w)
    inorder = embedding_bag_inorder(table, ids, seg, b, w)
    plain = embedding_bag_ref(table, ids, seg, b, w)
    torch.cuda.synchronize()
    need(tuple(got.shape) == (b, table.shape[1]) and got.dtype == table.dtype,
         "embedding_bag shape and dtype")
    same = torch.equal(bits(got), bits(inorder))
    err = float((got.float() - plain.float()).abs().max())
    absw = table.index_select(0, ids).float().abs()
    if w is not None:
        absw = absw * w.abs()[:, None]
    abs_sum = torch.zeros((b, table.shape[1]), device=table.device
                          ).index_add(0, seg.long(), absw)
    n = torch.bincount(seg, minlength=b)[:, None]
    bar = (BAG_F32_TOL if table.dtype == torch.float32
           else (n + 1) * 2.0 ** -8) * abs_sum
    within = bool(((got.float() - plain.float()).abs() <= bar).all())
    empty = torch.bincount(seg, minlength=b) == 0
    log(f"check embedding_bag V={table.shape[0]} d={table.shape[1]} B={b} "
        f"nnz={ids.numel()} {table.dtype} "
        f"{'weighted' if w is not None else 'unweighted'}: bit-identical to "
        f"the in-order version={same}; max_abs_err to the plain version "
        f"{err} (within its bar={within}); {int(empty.sum())} empty bags "
        f"zero={bool((got[empty] == 0).all())}")
    need(same, "embedding_bag bit-identical to the in-order version")
    need(within, "embedding_bag within the plain version's bar")
    need(bool((got[empty] == 0).all()), "empty bags zero")
    return err


def bag_path(table, ids, seg, b, w) -> tuple:
    """The fields module's pooled lookup, the path that runs the kernel:
    ``fields.embedding_bag`` in sum (weighted), mean and max mode, the
    counts set to 0 just before and read just after; each result held
    against the CPU over the gathered rows, bit for bit: sum and mean
    against the in-order version (mean divided by the bag's count), max
    against the plain ops.  Returns the launches."""
    import torch
    from repro_torch.kernels.embedding_bag import embedding_bag_inorder
    from repro_torch.models.recsys import fields
    counters = reset_counts()
    out = {"sum": fields.embedding_bag(table, ids, seg, b, w, mode="sum"),
           "mean": fields.embedding_bag(table, ids, seg, b, mode="mean"),
           "max": fields.embedding_bag(table, ids, seg, b, w, mode="max")}
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    rows = table.index_select(0, ids).cpu()
    ar = torch.arange(ids.numel())
    count = torch.clamp(torch.bincount(seg.cpu(), minlength=b).float(),
                        min=1.0)[:, None]
    for mode, got in out.items():
        args = (rows, ar, seg.cpu(), b, None if mode == "mean" else w.cpu())
        if mode == "max":
            want = fields.embedding_bag(*args, mode=mode)
        else:
            want = embedding_bag_inorder(*args)
            if mode == "mean":
                want = want / count
        need(torch.equal(bits(got.cpu()), bits(want)),
             f"fields.embedding_bag {mode} == the CPU's")
    log(f"bag path: fields.embedding_bag sum/mean/max over V={table.shape[0]}"
        f" d={table.shape[1]} B={b} nnz={ids.numel()}: launches {launches}; "
        f"every mode bit-identical to the CPU's (sum, mean: in order)")
    need(launches["embedding_bag"] == 2, "embedding_bag launched once by sum "
         "and once by mean, never by max")
    need(sum(launches.values()) == 2, "no other kernel on the bag path")
    return launches


def time_bag(table, ids, seg, b, w, what="uniform") -> dict:
    """Kernel, plain version and ``F.embedding_bag`` (offsets built from
    the segments outside the clock) at one shape, beside the byte
    bound: each input read once, the output written once.  Prints the
    launch plan (bags a tile, ids a chunk, grid, shared memory) and the
    wrapper's host time to queue one launch."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels.embedding_bag import (embedding_bag,
                                                   embedding_bag_ref)
    from repro_torch.kernels.embedding_bag.embedding_bag import bag_plan
    if w is not None:
        w = w.to(table.dtype)
    plan = bag_plan(b, table.shape[1], table.element_size(),
                    ids.element_size(), build.sm_count(table.device))
    ms, host = time_ms(lambda: embedding_bag(table, ids, seg, b, w))
    plain, _ = time_ms(lambda: embedding_bag_ref(table, ids, seg, b, w),
                       iters=50)
    offsets = torch.searchsorted(seg, torch.arange(b, device="cuda",
                                                   dtype=seg.dtype)
                                 ).to(ids.dtype)
    lib_fn = (lambda: F.embedding_bag(ids, table, offsets, mode="sum",
                                      per_sample_weights=w))
    lib, _ = time_ms(lib_fn, iters=50)
    lib_err = float((lib_fn().float() - embedding_bag(
        table, ids, seg, b, w).float()).abs().max())
    v, d = table.shape
    el = table.element_size()
    nnz = ids.numel()
    nbytes = (nnz * d * el + nnz * (ids.element_size() + seg.element_size())
              + (0 if w is None else nnz * w.element_size()) + b * d * el)
    ops = nnz * d * (1 if w is None else 2)
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / F32_FLOP_PER_S * 1e3
    log(f"time embedding_bag {what} V={v} d={d} B={b} nnz={nnz} "
        f"{table.dtype} {'weighted' if w is not None else 'unweighted'} "
        f"(plan: tile {plan.tile} bags, chunk {plan.chunk} ids, grid "
        f"{plan.grid_x}x{plan.grid_y}, {plan.smem} bytes of shared memory; "
        f"longest bag {int(torch.bincount(seg).max()) if nnz else 0}): "
        f"kernel {ms:.5f} "
        f"ms, plain {plain:.5f} ms, F.embedding_bag {lib:.5f} ms (max |diff| "
        f"to the kernel {lib_err:.3g}), bound {max(t_b, t_o):.5f} ms by "
        f"{'bytes' if t_b >= t_o else 'operations'} ({nbytes} bytes, {ops} "
        f"operations); host time to launch: wrapper {host:.5f} ms")
    return {"ms": ms, "plain_ms": plain, "library_ms": lib,
            "bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations"}


def bag_phase() -> tuple:
    """The embedding_bag kernel at its two shapes (deepfm's largest field
    as a full table, d=10; two-tower's 10M-row item table with a
    watch-history bag, d=256, 10.24 GB in float32): held against its
    plain version at B=4,096 and B=257, float32 and bfloat16, with and
    without weights, then on the Zipf bags, one bag of every id of a
    table's first BAG_ONE_ROWS rows and BAG_EMPTY bags all empty but
    the last (float32 and bfloat16, weighted and not); the fields
    module's path at d=10; the timings (float32 weighted and not,
    bfloat16 weighted, and the Zipf bags, the kernel's worst case: one
    thread per vector sums a bag in id order).  Frees the card at the
    end.  Returns (launches, err, timings keyed (d, dtype, weighted,
    case))."""
    import torch
    err, launches, timings = 0.0, None, {}
    for v, d, what in BAG_SHAPES:
        gc.collect()
        torch.cuda.empty_cache()
        g = torch.Generator(device="cuda").manual_seed(d)
        table = torch.randn((v, d), generator=g, device="cuda")
        log(f"bag shape: {what}, V={v} d={d} "
            f"({table.numel() * 4 / 1e9:.2f} GB in float32)")
        for dtype in (torch.float32, torch.bfloat16):
            t = table if dtype == torch.float32 else table.to(dtype)
            for b in (BAG_BATCH, RAGGED_BATCH):
                ids, seg, w = bag_inputs(b, v, d, seed=b + d)
                for ww in (None, w):
                    err = max(err, check_bag_case(t, ids, seg, b, ww))
            for name, ids, seg, b, w in bag_cases(v, d, seed=d):
                tt = t[:BAG_ONE_ROWS] if name == "one bag" else t
                log(f"bag case: {name}")
                for ww in (None, w):
                    err = max(err, check_bag_case(tt, ids, seg, b, ww))
            del t
        ids, seg, w = bag_inputs(BAG_BATCH, v, d, seed=BAG_BATCH + d)
        if d == BAG_SHAPES[0][1]:
            launches = bag_path(table, ids, seg, BAG_BATCH, w)
        for dtype, ww in ((torch.float32, w), (torch.float32, None),
                          (torch.bfloat16, w)):
            t = table.to(dtype)
            timings[(d, dtype, ww is not None, "uniform")] = time_bag(
                t, ids, seg, BAG_BATCH, ww)
            del t
        _, zids, zseg, zb, zw = bag_cases(v, d, seed=d)[0]
        timings[(d, torch.float32, True, "zipf")] = time_bag(
            table, zids, zseg, zb, zw, what="zipf")
        del table, ids, seg, w, zids, zseg, zw
    gc.collect()
    torch.cuda.empty_cache()
    return launches, err, timings


def table_at(tree, path):
    """The leaf of ``tree`` (params, or ``serve_ctr``'s artifacts) at
    ``path``, a table's keys from ``recsys_tables``."""
    for key in path:
        tree = tree[key]
    return tree


def training_codes(model, params, batch) -> dict:
    """{table path: the training codes of its ids in ``batch``} for
    every table whose params carry centroids, on the params' device
    (MGQE tables under their tiers' budgets)."""
    from repro_torch.core import dpq
    from repro_torch.core.mgqe import _tier_k_limits
    from repro_torch.launch.cells import recsys_tables
    out = {}
    for path, emb, ids in recsys_tables(model, batch):
        p = table_at(params, path)
        if "centroids" not in p:
            continue
        ids = ids.reshape(-1).to(p["emb"].device)
        e_sub = p["emb"].index_select(0, ids.long()).reshape(
            len(ids), emb.cfg.num_subspaces, -1)
        lim = _tier_k_limits(emb.cfg, ids) if emb.cfg.tier_boundaries \
            else None
        out[path] = dpq.assign_codes(e_sub, p["centroids"], lim)
    return out


def served_rows(model, artifacts, batch) -> list:
    """The rows a CTR model's ``serve`` reads, table by table: each
    table's artifact from ``serve_ctr`` served over its ids in
    ``batch`` (a field's (B, d), bst's item table's (B, seq_len + 1,
    d))."""
    from repro_torch.launch.cells import recsys_tables
    return [emb.serve(table_at(artifacts, path[1:]), ids)
            for path, emb, ids in recsys_tables(model, batch)]


def ctr_serve_path(arch: str) -> dict:
    """A CTR model (deepfm, autoint or bst) at its full ``CONFIG``
    through ``launch.serve.serve_ctr``: init, export of every table,
    one batch of 4,096 scored (the field models a CTRStream batch of
    Zipf ids, bst serve_ctr's own uniform draws), the counts set to 0
    just before and read just after (``dpq_assign`` once per 65,536-row
    export batch of each quantized table, ``mgqe_decode`` once per
    quantized table: CTR_LAUNCHES); then the served rows held
    bit-identical to the plain decode of the same artifacts and the
    logits to the same model on the plain ops (``kernel_backend=
    "torch"``) within CTR_TOL.  Returns the launches."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import CTRStream
    from repro_torch.launch.cells import recsys_model, recsys_tables
    from repro_torch.launch.serve import serve_ctr

    _, cfg = get_arch(arch, smoke=False)
    ids = None
    if cfg.field_vocab_sizes:
        ids = next(iter(CTRStream(cfg.field_vocab_sizes, CTR_BATCH)))[
            "sparse_ids"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counts()
    t0 = time.perf_counter()
    run = serve_ctr(cfg, CTR_BATCH, sparse_ids=ids)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    tables = recsys_tables(run.model, run.batch)
    q_vocabs = [emb.cfg.vocab_size for path, emb, _ in tables
                if "codes" in table_at(run.artifacts, path[1:])]
    want_assign = sum(-(-v // ASSIGN_BATCH) for v in q_vocabs)
    log(f"ctr serve path: {arch} CONFIG, {len(tables)} tables of "
        f"{sum(emb.cfg.vocab_size for _, emb, _ in tables)} rows, embed_dim "
        f"{cfg.embed_dim}, {len(q_vocabs)} quantized table(s) at D="
        f"{cfg.num_subspaces}; init + export + score B={CTR_BATCH} in "
        f"{wall:.3f}s (the score alone {run.seconds:.6f}s); artifacts "
        f"{run.serving_bits / 8e6:.2f} MB of {run.full_bits / 8e6:.2f} MB "
        f"full ({100 * run.serving_bits / run.full_bits:.2f}%); launches "
        f"{launches} (predicted dpq_assign {want_assign}, mgqe_decode "
        f"{len(q_vocabs)}); peak device memory {peak / 2**30:.3f} GiB "
        f"({peak} bytes)")
    need((launches["dpq_assign"], launches["mgqe_decode"])
         == (want_assign, len(q_vocabs)) == CTR_LAUNCHES[arch],
         f"{arch}: dpq_assign and mgqe_decode launched "
         f"{CTR_LAUNCHES[arch]} times")
    need(sum(launches.values()) == sum(CTR_LAUNCHES[arch]),
         "no other kernel on the serve path")
    # warm: the first scored batch above also paid for cuBLAS's set-up
    t_serve = []
    for _ in range(3):
        t0 = time.perf_counter()
        run.model.serve(run.params, run.artifacts, run.batch)
        torch.cuda.synchronize()
        t_serve.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    for path, emb, _ in tables:
        emb.export(table_at(run.params, path))
    torch.cuda.synchronize()
    t_export = time.perf_counter() - t0
    log(f"ctr serve warm ({arch}): scored batches of {CTR_BATCH} in "
        f"{[f'{x * 1e3:.3f}' for x in t_serve]} ms; export of every table "
        f"again in {t_export * 1e3:.3f} ms")
    rows = served_rows(run.model, run.artifacts, run.batch)
    plain_model = recsys_model(dataclasses.replace(cfg,
                                                   kernel_backend="torch"))
    rows_plain = served_rows(plain_model, run.artifacts, run.batch)
    logits_plain = plain_model.serve(run.params, run.artifacts, run.batch)
    torch.cuda.synchronize()
    need(all(tuple(r.shape) == tuple(ids.shape) + (cfg.embed_dim,)
             and bool(torch.isfinite(r).all())
             for r, (_, _, ids) in zip(rows, tables)),
         f"each table's served rows (its ids' shape, {cfg.embed_dim}), "
         f"finite")
    need(all(torch.equal(bits(r), bits(p)) for r, p in zip(rows, rows_plain)),
         "served rows == the plain decode")
    err = float((run.scores - logits_plain).abs().max())
    need(tuple(run.scores.shape) == (CTR_BATCH,)
         and bool(torch.isfinite(run.scores).all()), "logits (B,), finite")
    need(err <= CTR_TOL, f"logits within {CTR_TOL} of the plain ops")
    log(f"ctr serve checks ({arch}): served rows of {len(rows)} tables "
        f"{sorted({tuple(r.shape) for r in rows})} bit-identical to the "
        f"plain decode; logits within {err:.3g} of "
        f"the model on the plain ops; scores mean "
        f"{float(run.scores.mean()):.6f}")
    profile_phase(f"{arch} serve (B={CTR_BATCH}, full width)",
                  lambda: run.model.serve(run.params, run.artifacts,
                                          run.batch))
    del run, rows, rows_plain, logits_plain, plain_model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def step_split(what, model, state, batch) -> None:
    """One more adagrad step (lr 1e-2, clip 1.0) split into forward,
    backward and optimizer by the host clock around synchronises, then
    one under the profiler."""
    import torch
    from repro_torch.core.schemes.base import tree_leaves, tree_map
    from repro_torch.train import optimizer as opt

    ocfg = opt.OptimizerConfig(kind="adagrad", lr=1e-2)
    batch = {k: v.cuda() for k, v in batch.items()}
    leaves = tree_leaves(state.params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = model.loss(state.params, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    flat = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    by_id = {id(p): g for p, g in zip(leaves, flat)}
    grads = tree_map(lambda p: by_id[id(p)], state.params)
    opt.apply_updates(ocfg, state.params, grads, state.opt_state)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    del flat, grads, by_id
    log(f"train step split ({what}; host clock around synchronises): "
        f"forward {(t1 - t0) * 1e3:.3f} ms, backward "
        f"{(t2 - t1) * 1e3:.3f} ms, optimizer (clip + adagrad over every "
        f"table) {(t3 - t2) * 1e3:.3f} ms")
    step_fn = opt.make_step_fn(ocfg, model.loss)
    profile_phase(f"{what} train step", lambda: step_fn(state, batch))


def ctr_train_path(arch: str) -> dict:
    """A CTR model trained at its full ``CONFIG`` through
    ``launch.train.train``: 5 adagrad steps (lr 1e-2, clip 1.0) at batch
    4,096 on the launcher's stream, the counts set to 0 just before and
    read just after (the training step runs no kernel, as JAX's runs no
    Pallas kernel); losses finite; the step times and the peak device
    memory; then ``step_split``.  Returns the launches."""
    import torch
    from repro_torch.core.schemes.base import tree_leaves
    from repro_torch.launch.train import recsys_stream, train

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counts()
    run = train(arch, smoke=False, steps=TRAIN_STEPS, batch=CTR_BATCH,
                log_every=1)
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in run.history]
    times = [h["step_time_s"] for h in run.history]
    n_params = sum(t.numel() for t in tree_leaves(run.state.params))
    log(f"ctr train path: {arch} full width, {n_params} params "
        f"({n_params * 4 / 1e9:.3f} GB float32), adagrad lr 1e-2 clip 1.0, "
        f"B={CTR_BATCH}: {TRAIN_STEPS} steps in {run.seconds:.3f}s; losses "
        f"{[round(x, 6) for x in losses]}; step times (s) "
        f"{[round(x, 6) for x in times]}; launches {launches}; peak device "
        f"memory {peak / 2**30:.3f} GiB ({peak} bytes)")
    need(len(losses) == TRAIN_STEPS and all(math.isfinite(x) for x in losses),
         "every full-width training loss finite")
    need(not any(launches.values()), "the training step launches no kernel")
    batch = next(recsys_stream(run.model.cfg, CTR_BATCH, start=TRAIN_STEPS))
    step_split(f"{arch}, B={CTR_BATCH}, full width", run.model, run.state,
               batch)
    del run, batch
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def two_tower_train_path() -> dict:
    """Two-tower at its published widths (embed_dim 256, towers
    1024-512-256, D = 16, K = 256/64) with the users cut to
    TT_TRAIN_USERS (the tables, gradients, accumulators and adagrad's
    temporary of the CONFIG's 50M users would not fit one card), trained
    through ``recsys_setup`` and ``fit``: 5 steps at batch 4,096, counts
    set to 0 just before and read just after (no kernel), finite losses,
    the peak memory; then ``build_index`` (flat_pq, D = 8, K = 64) over
    the trained item tower for 1,000,000 items and ``retrieval_topk``
    top-100 for the JAX bench's TT_QUERIES users, counts set to 0 just
    before and read just after (``dpq_assign`` once, ``pq_topk`` once);
    every list bit-identical to ``pq_topk_ref`` and the index's codes
    within ASSIGN_TOL of the plain assignment.  Returns the launches."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.schemes.base import tree_leaves
    from repro_torch.kernels.pq_score import build_lut_batch, pq_topk_ref
    from repro_torch.launch.train import recsys_setup
    from repro_torch.retrieval import IndexConfig
    from repro_torch.train.loop import LoopConfig, fit

    _, full = get_arch("two-tower-retrieval", smoke=False)
    cfg = dataclasses.replace(full, n_users=TT_TRAIN_USERS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counts()
    t0 = time.perf_counter()
    model, state, step, data = recsys_setup(cfg, CTR_BATCH)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    state, hist = fit(state, step, data,
                      LoopConfig(total_steps=TRAIN_STEPS, log_every=1))
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in hist]
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    log(f"two-tower train path: {cfg.n_users} users (CONFIG: "
        f"{full.n_users}) x {cfg.n_items} items, embed_dim {cfg.embed_dim}, "
        f"towers {cfg.tower_mlp}, D={cfg.num_subspaces}; {n_params} params "
        f"({n_params * 4 / 1e9:.3f} GB float32), init {t_init:.3f}s; "
        f"B={CTR_BATCH}: losses {[round(x, 6) for x in losses]}; step "
        f"times (s) {[round(h['step_time_s'], 6) for h in hist]}; launches "
        f"{launches}; peak device memory {peak / 2**30:.3f} GiB ({peak} "
        f"bytes) of {torch.cuda.get_device_properties(0).total_memory / 2**30:.2f} GiB")
    need(len(losses) == TRAIN_STEPS and all(math.isfinite(x) for x in losses),
         "every two-tower training loss finite")
    need(not any(launches.values()), "the training step launches no kernel")
    step_split(f"two-tower, B={CTR_BATCH}, {cfg.n_users} users", model,
               state, next(data))

    n_cand = retrieval_candidates()
    icfg = IndexConfig(kind="flat_pq", num_subspaces=8, num_centroids=64)
    items = torch.arange(n_cand, device="cuda")
    users = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.n_users, TT_QUERIES)).cuda()
    torch.cuda.synchronize()
    counters = reset_counts()
    t0 = time.perf_counter()
    index, art = model.build_index(
        torch.Generator(device="cuda").manual_seed(1), state.params, items,
        icfg)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    scores, ids = model.retrieval_topk(state.params, index, art, users, TOPK)
    torch.cuda.synchronize()
    t_query = time.perf_counter() - t0
    r_launches = {name: fn.launches for name, fn in counters.items()}
    codes, cent = art["codes"], art["centroids"]
    u, _ = model.user_vec(state.params, users)
    ws, wi = pq_topk_ref(build_lut_batch(u, cent).contiguous(), codes, TOPK)
    need(tuple(scores.shape) == tuple(ids.shape) == (TT_QUERIES, TOPK)
         and bool(torch.isfinite(scores).all()), "top-k (queries, k), finite")
    need(torch.equal(bits(scores), bits(ws)) and torch.equal(ids, wi),
         "trained two-tower top-k == pq_topk_ref")
    e = model.encode_items(state.params, items)
    e = e.reshape(n_cand, cent.shape[0], cent.shape[2]).contiguous()
    gap = assign_gap(e, cent, None, codes,
                     blocked_assign_ref_lim(e, cent, None))
    need(gap <= ASSIGN_TOL, f"trained index codes within {ASSIGN_TOL} of "
         f"the plain assignment")
    log(f"two-tower trained index: flat_pq D=8 K=64 over {n_cand} items "
        f"built in {t_build:.3f}s; top-{TOPK} for {TT_QUERIES} users in "
        f"{t_query * 1e3:.3f} ms; launches {r_launches}; lists "
        f"bit-identical to pq_topk_ref; codes within {gap:.3g} of the "
        f"plain assignment")
    need(r_launches["dpq_assign"] == 1 and r_launches["pq_topk"] == 1
         and sum(r_launches.values()) == 2,
         "the index build launches dpq_assign once, the query pq_topk once")
    del model, state, step, data, index, art, e, u, scores, ids, ws, wi
    gc.collect()
    torch.cuda.empty_cache()
    return {name: launches[name] + r_launches[name] for name in launches}


def adagrad_gaps(p0, card, host, tape) -> dict:
    """A card run against a CPU run from the same params ``p0``, with
    ``tape`` the ``record_adagrad`` tape of both: the largest param and
    accumulator gaps, the largest gradient gap at any step (relative to
    1 + |g|), each run's largest distance from ``adagrad_replay`` of its
    own gradients as a share of the rounding slack, the largest share of
    the replays' gap plus both slacks that the param gap takes, and the
    elements where that bound exceeds TRAIN_PARAM_TOL."""
    from repro_torch.core.schemes.base import tree_leaves
    from repro_torch.train.optimizer import adagrad_replay

    tapes = {d: [t for t in tape if t[0].type == d] for d in ("cuda", "cpu")}
    need(len(tapes["cuda"]) == len(tapes["cpu"]) == TRAIN_STEPS,
         "one recorded update a step on each device")
    grad = max(float(((gc - gh).abs() / (1 + gh.abs())).max())
               for (*_, c), (*_, h) in zip(tapes["cuda"], tapes["cpu"])
               for gc, gh in zip(c, h))
    out = {"param": 0.0, "grad": grad, "replay": 0.0, "bound": 0.0,
           "loose": 0, "acc": max(
               float((c.cpu() - h).abs().max()) for c, h in zip(
                   tree_leaves(card.opt_state["acc"]),
                   tree_leaves(host.opt_state["acc"])))}
    rc, _, sc = adagrad_replay(p0, tapes["cuda"])
    rh, _, sh = adagrad_replay(p0, tapes["cpu"])
    for c, h, xc, xh, ec, eh in zip(tree_leaves(card.params),
                                    tree_leaves(host.params), rc, rh, sc,
                                    sh):
        c, h = c.cpu().double(), h.double()
        bound = (xc - xh).abs() + ec + eh
        out["param"] = max(out["param"], float((c - h).abs().max()))
        out["replay"] = max(out["replay"], float(((c - xc).abs() / ec).max()),
                            float(((h - xh).abs() / eh).max()))
        out["bound"] = max(out["bound"], float(((c - h).abs() / bound).max()))
        out["loose"] += int((bound > TRAIN_PARAM_TOL).sum())
    return out


def train_card_vs_cpu(arch: str) -> None:
    """At ``arch``'s smoke config: 5 adagrad steps through
    ``recsys_setup`` on the card and 5 on the CPU from the same params
    and the launcher's batches under ``record_adagrad``, each step's
    MGQE codes compared first (a near-tie flip would fail as a flip),
    then the loss (within TRAIN_LOSS_RTOL); at the end every gradient
    and accumulator within TRAIN_PARAM_TOL and every param as
    ``adagrad_gaps`` holds it (deepfm's also within TRAIN_PARAM_TOL)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.schemes.base import tree_leaves, tree_map
    from repro_torch.launch.train import recsys_setup
    from repro_torch.train import optimizer as opt

    _, cfg = get_arch(arch, smoke=True)
    cpu_model, host, step_host, data = recsys_setup(cfg, CHECK_BATCH,
                                                    device="cpu")
    card_model, _, step_card, _ = recsys_setup(cfg, CHECK_BATCH)
    ocfg = opt.OptimizerConfig(kind="adagrad", lr=1e-2)
    card = opt.TrainState.create(ocfg, tree_map(lambda t: t.cuda(),
                                                host.params))
    p0 = [t.clone() for t in tree_leaves(host.params)]
    rel, n_codes = [], 0
    with opt.record_adagrad() as tape:
        for s in range(TRAIN_STEPS):
            batch = next(data)
            c_codes = training_codes(card_model, card.params, batch)
            h_codes = training_codes(cpu_model, host.params, batch)
            n_codes += sum(c.numel() for c in h_codes.values())
            flips = sum(int((c_codes[k].cpu() != h_codes[k]).sum())
                        for k in h_codes)
            need(flips == 0, f"{arch} step {s}: {flips} MGQE codes differ "
                 f"between the card and the CPU (a near-tie flip)")
            card, mc = step_card(card, {k: v.cuda() for k, v in batch.items()})
            host, mh = step_host(host, batch)
            rel.append(abs(float(mc["loss"]) - float(mh["loss"]))
                       / abs(float(mh["loss"])))
            need(rel[-1] <= TRAIN_LOSS_RTOL, f"{arch} step {s}: loss within "
                 f"{TRAIN_LOSS_RTOL} relative of the CPU's")
    g = adagrad_gaps(p0, card, host, tape)
    n = sum(t.numel() for t in p0)
    log(f"train card vs CPU ({arch} smoke config, B={CHECK_BATCH}, "
        f"{TRAIN_STEPS} steps): {n_codes} MGQE codes, equal at every step; "
        f"loss relative gaps {[f'{x:.3g}' for x in rel]}; largest gradient "
        f"gap {g['grad']:.3g} relative to 1 + |g| and accumulator gap "
        f"{g['acc']:.3g} (bar {TRAIN_PARAM_TOL}); each run within "
        f"{g['replay']:.3g} of its replay's rounding slack (bar 1); largest "
        f"param gap {g['param']:.3g}, at most {g['bound']:.4g} of the "
        f"replays' gap plus their slack (bar 1), which exceeds "
        f"{TRAIN_PARAM_TOL} at {g['loose']} of {n} elements")
    need(g["grad"] <= TRAIN_PARAM_TOL and g["acc"] <= TRAIN_PARAM_TOL,
         f"{arch}: every step's gradients and the final accumulators "
         f"within {TRAIN_PARAM_TOL} of the CPU's")
    need(g["replay"] <= 1.0, f"{arch}: every param within float32 "
         f"rounding of adagrad replayed over its run's gradients")
    need(g["bound"] <= 1.0, f"{arch}: every param gap within the replays' "
         f"gap plus their rounding")
    if arch == "deepfm":
        need(g["param"] <= TRAIN_PARAM_TOL,
             f"deepfm: final params within {TRAIN_PARAM_TOL} of the CPU's")


def resume_gap(arch: str) -> tuple:
    """``arch`` at its smoke config trained 5 steps with a checkpoint
    every 2, failed at step 3, resumed, against an uninterrupted run:
    (largest final param gap, bit-identical)."""
    import shutil

    import torch
    from repro_torch.core.schemes.base import tree_leaves
    from repro_torch.launch.train import train
    from repro_torch.train.resilience import SimulatedFailure

    ckpt_dir = os.path.join(REPO, "build", f"chip_smoke_ckpt_{arch}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    kw = dict(smoke=True, steps=TRAIN_STEPS, batch=CHECK_BATCH, log_every=1)
    try:
        train(arch, ckpt_dir=ckpt_dir, ckpt_every=2, fail_at=3, **kw)
        failed = False
    except SimulatedFailure:
        failed = True
    need(failed, "--fail-at 3 stops the run")
    resumed = train(arch, ckpt_dir=ckpt_dir, ckpt_every=2, **kw)
    whole = train(arch, **kw)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    need([h["step"] for h in resumed.history] == [3, 4, 5],
         "the resumed run starts from the step-2 checkpoint")
    pairs = list(zip(tree_leaves(resumed.state.params),
                     tree_leaves(whole.state.params)))
    gap = max(float((a - b).abs().max()) for a, b in pairs)
    same = all(torch.equal(bits(a), bits(b)) for a, b in pairs)
    log(f"train resume ({arch}): failed at step 3, resumed from step 2 to "
        f"{int(resumed.state.step)}; final params against an uninterrupted "
        f"run: largest gap {gap:.3g}, bit-identical={same}")
    need(gap <= TRAIN_PARAM_TOL, "the resumed run's params == the "
         "uninterrupted run's")
    return gap, same


DETERMINISTIC_FLAG = "--deterministic-resume"


def gather_backward_repeats() -> dict:
    """{gather: whether its backward gives the same bits twice} for the
    two gathers of the training forward: ``index_select`` (the rows,
    ``core/dpq.py::row_gather``; its backward is ``index_add_``) and
    advanced indexing (the centroids, ``core/dpq.py::decode_codes``; its
    backward is ``index_put_`` with accumulate), each summing 65,536
    upstream rows into 1,000 of a (100,000, 16) table."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(5)
    table = torch.randn((100_000, 16), generator=g, device="cuda")
    ids = torch.randint(0, 1000, (65_536,), generator=g, device="cuda")
    up = torch.randn((65_536, 16), generator=g, device="cuda")
    out = {}
    for name, fn in (("index_select", lambda t: t.index_select(0, ids)),
                     ("advanced indexing", lambda t: t[ids])):
        grads = []
        for _ in range(2):
            t = table.clone().requires_grad_(True)
            grads.append(torch.autograd.grad((fn(t) * up).sum(), t)[0])
        out[name] = torch.equal(bits(grads[0]), bits(grads[1]))
    return out


def deterministic_resume() -> int:
    """The child's side of ``resume_checks``: which gather's backward
    repeats bit for bit, with the default algorithms and then with
    deterministic ones, then the resume checks of RESUME_ARCHS under
    ``torch.use_deterministic_algorithms(True)``; one JSON line each,
    with the resume gap or the error of an op that has no deterministic
    implementation."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    default = gather_backward_repeats()
    torch.use_deterministic_algorithms(True)
    print("DETERMINISTIC " + json.dumps(
        {"probe": {name: [default[name], again] for name, again in
                   gather_backward_repeats().items()}}), flush=True)
    for arch in RESUME_ARCHS:
        try:
            gap, same = resume_gap(arch)
            out = {"arch": arch, "gap": gap, "bit_identical": same}
        except RuntimeError as e:
            if "deterministic" not in str(e):
                raise
            out = {"arch": arch, "refused": str(e).splitlines()[0]}
        print("DETERMINISTIC " + json.dumps(out), flush=True)
    return 0


def resume_checks() -> None:
    """The resume check of each of RESUME_ARCHS as the package runs it,
    then once more in a child process started with
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` under
    ``torch.use_deterministic_algorithms(True)`` (no other phase runs
    under it): both gaps printed, or the op that refused."""
    results = {arch: resume_gap(arch) for arch in RESUME_ARCHS}
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    t0 = time.perf_counter()
    child = subprocess.run([sys.executable, os.path.abspath(__file__),
                            DETERMINISTIC_FLAG], env=env, cwd=REPO,
                           capture_output=True, text=True, timeout=600)
    lines = [json.loads(x.split(" ", 1)[1])
             for x in child.stdout.splitlines()
             if x.startswith("DETERMINISTIC ")]
    if child.returncode != 0 or len(lines) != 1 + len(RESUME_ARCHS):
        log(child.stdout[-4000:])
        log(child.stderr[-4000:])
        need(False, "the deterministic resume child ran to its end")
    for name, (default, det) in lines[0]["probe"].items():
        log(f"gather backward ({name}, 65,536 rows into 1,000): the same "
            f"bits twice with the default algorithms: {default}; with "
            f"deterministic ones: {det}")
    for out in lines[1:]:
        gap, same = results[out["arch"]]
        log(f"train resume under deterministic algorithms ({out['arch']}, "
            f"child process, {time.perf_counter() - t0:.1f}s): "
            + (f"gap {out['gap']:.3g}, bit-identical={out['bit_identical']}"
               if "gap" in out else f"refused: {out['refused']}")
            + f" (default algorithms: gap {gap:.3g}, bit-identical={same})")


def time_ctr_kernels() -> None:
    """``dpq_assign`` and ``mgqe_decode`` at the new CTR models' shapes:
    AutoInt's 10M-row field (D = 8, S = 2) and BST's item table (D = 8,
    S = 4), K = 256 with a tail of 64, f32; ``dpq_assign`` over the
    table's export (153 launches of 65,536 rows) as ``time_assign_pass``
    runs deepfm's, ``mgqe_decode`` over the served batch's ids (AutoInt
    one field's B = 4,096, BST's B = 4,096 x 21 = 86,016), each beside
    its plain version, its bound and, for the decode, ``F.embedding``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_arch
    from repro_torch.core.mgqe import k_limit_for_all_rows
    from repro_torch.kernels import build
    from repro_torch.kernels.mgqe_decode import mgqe_decode, mgqe_decode_ref
    from repro_torch.kernels.mgqe_decode.mgqe_decode import decode_plan
    from repro_torch.launch.engine import embedding_config_of_arch

    sms = build.sm_count("cuda")
    for arch, b in (("autoint", CTR_BATCH),
                    ("bst", CTR_BATCH * (get_arch("bst")[1].seq_len + 1))):
        ecfg = embedding_config_of_arch(*get_arch(arch, smoke=False))
        n, d, k = ecfg.vocab_size, ecfg.num_subspaces, ecfg.num_centroids
        s = ecfg.dim // d
        g = torch.Generator(device="cuda").manual_seed(n + d + s)
        scale = ecfg.dim ** -0.5
        e_all = torch.randn((n, d, s), generator=g, device="cuda") * scale
        cent = torch.randn((d, k, s), generator=g, device="cuda") * scale
        time_assign_pass(f"over {arch}'s {n}-row table's export", e_all,
                         cent, k_limit_for_all_rows(ecfg, "cuda"),
                         ASSIGN_BATCH, iters=3)
        del e_all
        codes, cent = decode_inputs(b, d, k, s, torch.float32, seed=b)
        got, want = mgqe_decode(codes, cent), mgqe_decode_ref(codes, cent)
        torch.cuda.synchronize()
        need(torch.equal(bits(got), bits(want)), f"mgqe_decode bit-identical "
             f"at {arch}'s served shape")
        offs = (codes.long() + torch.arange(d, device="cuda") * k
                ).contiguous()
        flat = cent.reshape(d * k, s)
        ms, host = time_ms(lambda: mgqe_decode(codes, cent))
        plain, _ = time_ms(lambda: mgqe_decode_ref(codes, cent))
        lib, _ = time_ms(lambda: F.embedding(offs, flat))
        nbytes = b * d + d * k * s * 4 + b * d * s * 4
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"time mgqe_decode B={b} D={d} K={k} S={s} f32 ({arch}'s served "
            f"batch, {decode_plan(b, d, k, s, 1, 4, sms)}): kernel "
            f"{ms:.5f} ms, plain {plain:.5f} ms, F.embedding {lib:.5f} ms, "
            f"bound {bound:.5f} ms by bytes ({nbytes} bytes, "
            f"{100 * bound / ms:.0f}% of it); host time to launch "
            f"{host:.5f} ms")
        del codes, cent, got, want, offs, flat
        gc.collect()
        torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# the backbone phase: the paper's GMF, NeuMF and SASRec (§3.2) trained on
# the card, their MGQE tables exported (dpq_assign) and served
# (mgqe_decode)
# ----------------------------------------------------------------------

def bb_planted_commitment(model):
    """The planted fault of the card-vs-CPU check: ``model`` with the
    commitment term of every table's aux loss of the wrong sign."""
    import dataclasses

    from repro_torch.core import Embedding
    for name in model.tables:
        emb = getattr(model, name)
        setattr(model, name, Embedding(
            dataclasses.replace(emb.cfg, beta=-emb.cfg.beta),
            device=model.device))
    return model


def bb_pads_counted(model):
    """The other planted fault: SASRec's loss with the pad positions
    kept in its mask (a pad's positive read as item 1)."""
    import torch

    def loss(params, batch):
        pos = batch["pos"]
        return model.loss(params, {**batch, "pos": torch.where(
            pos == 0, torch.ones_like(pos), pos)})
    return loss


def bb_training(ml) -> dict:
    """Each backbone, full and MGQE, trained at the paper's widths on the
    card through ``run_pointwise``/``run_sasrec``: the step time, the
    peak device memory, the loss first to last, HR@10 over BB_EVAL
    users, the serving size and Fig. 3's verdict.  Training and the
    evaluation on the training forward launch no kernel.  Each MGQE run
    takes BB_PROFILE_STEPS more steps on a copy of its params under the
    profiler.  Returns the runs by ``model/kind``."""
    import torch
    from repro_torch.core.schemes.base import tree_map
    from repro_torch.data.sampler import PointwiseSampler, SequenceSampler
    from repro_torch.launch.backbones import (fit, rel_gap, run_pointwise,
                                              run_sasrec)
    from repro_torch.models.recsys.backbones import BackboneConfig

    out = {}
    t0 = time.perf_counter()
    for model in ("gmf", "neumf", "sasrec"):
        for kind in ("full", "mgqe"):
            cfg = BackboneConfig(model=model, n_users=ml.n_users,
                                 n_items=ml.n_items, dim=BB_DIM,
                                 embed_kind=kind)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            counters = reset_counts()
            if model == "sasrec":
                r = run_sasrec(cfg, ml, steps=BB_STEPS, eval_users=BB_EVAL)
            else:
                r = run_pointwise(model, cfg, ml, steps=BB_STEPS,
                                  eval_users=BB_EVAL)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            launched = {k: fn.launches for k, fn in counters.items()
                        if fn.launches}
            log(f"backbone {model}/{kind}: {BB_STEPS} steps, "
                f"{r.step_ms:.4f} ms a step (synchronised); loss "
                f"{r.losses[0]:.6f} -> {r.losses[-1]:.6f} (logged "
                f"{[round(x, 4) for x in r.losses]}); HR@10 {r.metric:.4f} "
                f"over {BB_EVAL} users; size {r.size_bits} bits "
                f"({r.size_pct:.4f}% of full); peak device memory "
                f"{peak / 2**20:.1f} MiB; {r.seconds:.2f}s in all")
            need(len(r.losses) > 1 and all(math.isfinite(x)
                                            for x in r.losses),
                 f"{model}/{kind}: finite losses")
            need(0.0 <= r.metric <= 1.0, f"{model}/{kind}: HR@10 in [0, 1]")
            need(not launched, f"{model}/{kind}: training and its "
                 f"evaluation launch no kernel, got {launched}")
            out[f"{model}/{kind}"] = r
            if kind == "mgqe":
                # where a step's time goes: BB_PROFILE_STEPS more steps
                # on a copy of the trained params, under the profiler
                it = (iter(SequenceSampler(ml, batch=128, maxlen=cfg.maxlen))
                      if model == "sasrec"
                      else iter(PointwiseSampler(ml, batch_pos=512)))
                copy = tree_map(torch.clone, r.params)
                profile_phase(f"backbone {model}/mgqe, {BB_PROFILE_STEPS} "
                              f"training steps", lambda: fit(
                                  r.model, copy, r.model.loss, it,
                                  BB_PROFILE_STEPS, 1e-3))
    for model in ("gmf", "neumf", "sasrec"):
        fe = out[f"{model}/full"].losses[-1]
        mg = out[f"{model}/mgqe"].losses[-1]
        gap, verdict = rel_gap(fe, mg)
        log(f"backbone Fig. 3 {model} at {BB_STEPS} steps: final "
            f"FE={fe:.6f} MGQE={mg:.6f} rel-gap={100 * gap:.2f}% -> "
            f"{verdict}; HR@10 FE "
            f"{out[f'{model}/full'].metric:.4f} MGQE "
            f"{out[f'{model}/mgqe'].metric:.4f}; MGQE size "
            f"{out[f'{model}/mgqe'].size_pct:.4f}% of full")
    log(f"backbone training: 6 runs in {time.perf_counter() - t0:.1f}s")
    return out


def bb_train_codes(model, params, batch) -> dict:
    """Each MGQE table's training codes for a batch's ids (the plain
    assignment, as the training forward runs it), by table: (rows
    (n, D, S), centroids, codes (n, D))."""
    import torch
    from repro_torch.core import dpq
    from repro_torch.core.mgqe import _tier_k_limits
    out = {}
    for name in model.tables:
        if model.cfg.model == "sasrec":
            ids = torch.cat([batch[k].reshape(-1)
                             for k in ("seq", "pos", "neg")])
        else:
            ids = batch["user_ids" if name.startswith("user")
                        else "item_ids"]
        cfg, p = getattr(model, name).cfg, params[name]
        e = p["emb"].index_select(0, ids).reshape(-1, cfg.num_subspaces,
                                                  cfg.subspace_dim)
        out[name] = (e, p["centroids"], dpq.assign_codes(
            e, p["centroids"], _tier_k_limits(cfg, ids)))
    return out


def bb_card_vs_cpu() -> None:
    """At the tests' tiny size (``_bb_cfg``: 100 users, 80 items, d=16,
    D=4, K=16/8): BB_CHECK_STEPS adam steps of each backbone as MGQE on
    the card and on the CPU from the same params and sampler batches.
    Before each step the training codes of the batch's ids are compared;
    every step's loss (aux included) is held within CTR_TOL of the CPU's
    up to the first step whose codes differ, which ends the comparison
    (the two runs then train on other centroids) and whose differing
    codes must be near-ties (ASSIGN_TOL).  Then three planted faults on
    the card (the commitment term's sign in GMF and SASRec, SASRec's pad
    mask), which must fail that bar."""
    import torch
    from repro_torch.core.schemes.base import tree_map
    from repro_torch.data.sampler import PointwiseSampler, SequenceSampler
    from repro_torch.data.synthetic import movielens_like
    from repro_torch.models.recsys.backbones import (BackboneConfig,
                                                     make_backbone)
    from repro_torch.train import optimizer as opt

    data = movielens_like(n_users=100, n_items=80, mean_len=6, seed=0)

    def run(name, fault=None):
        """(loss gaps a step before the first code flip, those from it
        on, the step of the first flip or None, the flips' largest
        distance gap)."""
        cfg = BackboneConfig(model=name, n_users=100, n_items=80, dim=16,
                             embed_kind="mgqe", num_subspaces=4,
                             num_centroids=16, tier_tail_centroids=8,
                             mlp_dims=(16, 8), maxlen=10, n_blocks=1)
        cpu = make_backbone(cfg, device="cpu")
        params = cpu.init(torch.Generator().manual_seed(0))
        card = make_backbone(cfg)
        card_params = tree_map(lambda t: t.cuda(), params)
        loss_fn = card.loss
        if fault == "commitment":
            loss_fn = bb_planted_commitment(card).loss
        elif fault == "pads":
            loss_fn = bb_pads_counted(card)
        ocfg = opt.OptimizerConfig(
            kind="adam", lr=1e-3 if name == "sasrec" else 2e-3,
            grad_clip=None)
        states = [opt.TrainState.create(ocfg, card_params),
                  opt.TrainState.create(ocfg, params)]
        steps = [opt.make_step_fn(ocfg, loss_fn),
                 opt.make_step_fn(ocfg, cpu.loss)]
        it = (iter(SequenceSampler(data, batch=128, maxlen=10))
              if name == "sasrec"
              else iter(PointwiseSampler(data, batch_pos=512)))
        gaps, after, flip, tie = [], [], None, 0.0
        for i in range(BB_CHECK_STEPS):
            b = {k: torch.from_numpy(v) for k, v in next(it).items()}
            batches = [{k: v.cuda() for k, v in b.items()}, b]
            if flip is None:
                c_codes = bb_train_codes(card, states[0].params, batches[0])
                h_codes = bb_train_codes(cpu, states[1].params, b)
                for t, (e, cent, want) in h_codes.items():
                    got = c_codes[t][2].cpu()
                    if not torch.equal(got, want):
                        flip = i
                        tie = max(tie, assign_gap(e, cent, None, got, want))
            out = [step(st, bt) for step, st, bt in zip(steps, states,
                                                        batches)]
            states = [st for st, _ in out]
            (gaps if flip is None else after).append(
                abs(float(out[0][1]["loss"]) - float(out[1][1]["loss"])))
        return gaps, after, flip, tie

    for name in ("gmf", "neumf", "sasrec"):
        gaps, after, flip, tie = run(name)
        log(f"backbone card vs CPU {name}/mgqe (tiny config, "
            f"{BB_CHECK_STEPS} steps): loss gaps {[f'{x:.3g}' for x in gaps]}"
            f" (bar CTR_TOL {CTR_TOL}); "
            + ("training codes equal at every step" if flip is None else
               f"a code differs before step {flip} (a near-tie: distance "
               f"gap {tie:.3g}), which ends the comparison; the loss gaps "
               f"from there on, not held: {[f'{x:.3g}' for x in after]}"))
        need(len(gaps) > 0 and max(gaps) <= CTR_TOL, f"backbone {name}: "
             f"card losses within {CTR_TOL} of the CPU's")
        need(tie <= ASSIGN_TOL, f"backbone {name}: codes differ between "
             f"the card and the CPU only at near-ties")
    for name, fault in (("gmf", "commitment"), ("sasrec", "commitment"),
                        ("sasrec", "pads")):
        gaps, _, _, _ = run(name, fault)
        worst = max(gaps, default=0.0)
        log(f"backbone card vs CPU {name}/mgqe with a planted fault "
            f"({fault}): loss gaps {[f'{x:.3g}' for x in gaps]}, the "
            f"largest {worst / CTR_TOL:.3g}x the bar")
        need(worst > CTR_TOL, f"the planted {fault} fault fails the "
             f"backbone card-vs-CPU bar")


def bb_serving(runs, ml) -> tuple:
    """The trained MGQE tables of every backbone exported through
    ``Embedding.export`` (``dpq_assign``) and the evaluation's candidates
    (BB_EVAL users x 101 ids) served through ``Embedding.serve``
    (``mgqe_decode``), then HR@10 from the served rows, with every count
    set to 0 just before and read just after.  Checks: codes equal to
    the plain assignment up to ASSIGN_TOL; served rows bit-identical to
    ``mgqe_decode_ref`` on the same codes and, where the training
    forward picked the same codes, within a rounding of its rows
    (2^-23 (|c| + |e|) an element: e + (c - e) rounds twice); where it
    did not, the two picks within ASSIGN_TOL of a tie.  Returns
    (launches, largest distance gap)."""
    import numpy as np
    import torch
    from repro_torch.core import dpq
    from repro_torch.core.mgqe import _tier_k_limits, k_limit_for_all_rows
    from repro_torch.kernels.mgqe_decode import mgqe_decode_ref
    from repro_torch.launch.backbones import (eval_candidates,
                                              hr_at_10_pointwise,
                                              hr_at_10_sasrec)

    total = {"dpq_assign": 0, "mgqe_decode": 0}
    worst = 0.0
    for model_name in ("gmf", "neumf", "sasrec"):
        r = runs[f"{model_name}/mgqe"]
        model, params = r.model, r.params
        sasrec = model_name == "sasrec"
        users, cand = eval_candidates(ml, BB_EVAL, 100, 7,
                                      shift=1 if sasrec else 0)
        counters = reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        art = model.export(params)
        torch.cuda.synchronize()
        t_export = time.perf_counter() - t0
        ids = {"item": torch.from_numpy(cand.reshape(-1)).cuda(),
               "user": torch.from_numpy(np.repeat(users, 101)).cuda()}
        with torch.no_grad():
            served = {name: getattr(model, name).serve(
                art[name], ids["user" if name.startswith("user") else "item"])
                for name in model.tables}
            if sasrec:
                hr_served = hr_at_10_sasrec(model, params, ml, model.cfg.maxlen,
                                            BB_EVAL, artifacts=art)
            else:
                hr_served = hr_at_10_pointwise(model, params, ml, BB_EVAL,
                                               artifacts=art)
        torch.cuda.synchronize()
        launches = {k: counters[k].launches for k in total}
        for k in total:
            total[k] += launches[k]
        need(launches["dpq_assign"] == len(model.tables),
             f"{model_name}: one dpq_assign launch a table")
        need(launches["mgqe_decode"] > 0, f"{model_name}: mgqe_decode "
             f"launched serving the candidates")
        with torch.no_grad():
            hr_train = (hr_at_10_sasrec(model, params, ml, model.cfg.maxlen,
                                        BB_EVAL) if sasrec else
                        hr_at_10_pointwise(model, params, ml, BB_EVAL))
        ties = 0
        for name in model.tables:
            emb = getattr(model, name)
            ecfg, p, a = emb.cfg, params[name], art[name]
            n, d = ecfg.vocab_size, ecfg.num_subspaces
            codes, cent = a["codes"], a["centroids"]
            e_all = p["emb"].reshape(n, d, -1)
            lim = k_limit_for_all_rows(ecfg, "cuda")
            want = blocked_assign_ref_lim(e_all, cent, lim)
            got = codes.to(torch.int32)
            gap = assign_gap(e_all, cent, lim, got, want)
            need(codes.dtype == torch.uint8 and tuple(codes.shape) == (n, d),
                 f"{model_name}.{name}: codes (n, D) uint8")
            need(gap <= ASSIGN_TOL, f"{model_name}.{name}: exported codes "
                 f"== the plain assignment up to {ASSIGN_TOL}")
            tid = ids["user" if name.startswith("user") else "item"]
            rows = served[name]
            need(tuple(rows.shape) == (tid.shape[0], ecfg.dim)
                 and bool(torch.isfinite(rows).all()),
                 f"{model_name}.{name}: served rows (n, d), finite")
            need(torch.equal(bits(rows), bits(mgqe_decode_ref(
                codes.index_select(0, tid), cent))),
                f"{model_name}.{name}: served rows bit-identical to "
                f"mgqe_decode_ref")
            # the training forward on the same ids: its own codes (the
            # plain assignment, as in training) and rows e + (c - e)
            with torch.no_grad():
                train_rows, _ = emb.apply(p, tid)
                e = p["emb"].index_select(0, tid)
                t_codes = dpq.assign_codes(e.reshape(-1, d, ecfg.subspace_dim),
                                           cent, _tier_k_limits(ecfg, tid))
            s_codes = codes.index_select(0, tid).to(torch.int32)
            agree = (t_codes == s_codes).all(1)
            c_rows = rows[agree]
            bar = 2.0 ** -23 * (c_rows.abs() + e[agree].abs())
            need(bool(((c_rows - train_rows[agree]).abs() <= bar).all()),
                 f"{model_name}.{name}: served rows within a rounding of "
                 f"the training forward's")
            tie_gap = assign_gap(e.reshape(-1, d, ecfg.subspace_dim), cent,
                                 None, s_codes, t_codes)
            need(tie_gap <= ASSIGN_TOL, f"{model_name}.{name}: training "
                 f"and exported codes differ only at near-ties")
            n_ties = int((~agree).sum())
            ties += n_ties
            worst = max(worst, gap, tie_gap)
            log(f"backbone serve {model_name}.{name}: vocab {n} D={d} "
                f"S={ecfg.subspace_dim} K={ecfg.tier_num_centroids}; "
                f"export codes within {gap:.3g} of the plain assignment "
                f"({int((got != want).sum())} of {n * d} differ); "
                f"{tid.shape[0]} served rows bit-identical to "
                f"mgqe_decode_ref; {n_ties} of them picked other codes in "
                f"the training forward (near-ties within {tie_gap:.3g})")
        log(f"backbone serve {model_name}/mgqe: export {t_export:.4f}s, "
            f"launches {launches}; HR@10 from the served rows "
            f"{hr_served:.4f}, from the training forward {hr_train:.4f} "
            f"({ties} candidate rows at near-ties could separate them)")
    return total, worst


def time_bb_kernels() -> None:
    """``dpq_assign`` and ``mgqe_decode`` at the backbones' widths: D in
    BB_SUBSPACES (S = 64 / D), K = 256 with a tail of 64, f32;
    ``dpq_assign`` over each vocabulary (6,040 users, 3,417 SASRec
    items) as export runs it (one launch), ``mgqe_decode`` over the
    evaluation's candidates (BB_EVAL x 101 rows), each beside its plain
    version, its bound and, for the decode, ``F.embedding``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import EmbeddingConfig
    from repro_torch.core.mgqe import k_limit_for_all_rows
    from repro_torch.core.partition import frequency_boundaries
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_chunks import l2_gather_plan
    from repro_torch.kernels.dpq_assign import dpq_assign, dpq_assign_ref
    from repro_torch.kernels.dpq_assign.dpq_assign import choose_tiles
    from repro_torch.kernels.mgqe_decode import mgqe_decode, mgqe_decode_ref
    from repro_torch.kernels.mgqe_decode.mgqe_decode import decode_plan

    sms = build.sm_count("cuda")
    for d in BB_SUBSPACES:
        s = BB_DIM // d
        for n in (BB_USERS, BB_ITEMS + 1):
            ecfg = EmbeddingConfig(
                vocab_size=n, dim=BB_DIM, kind="mgqe", num_subspaces=d,
                num_centroids=256, tier_boundaries=frequency_boundaries(
                    n, (0.1,)), tier_num_centroids=(256, 64))
            g = torch.Generator(device="cuda").manual_seed(n + d)
            e = torch.randn((n, d, s), generator=g, device="cuda") \
                * BB_DIM ** -0.5
            cent = torch.randn((d, 256, s), generator=g, device="cuda") \
                * BB_DIM ** -0.5
            lim = k_limit_for_all_rows(ecfg, "cuda")
            got, want = dpq_assign(e, cent, lim), dpq_assign_ref(e, cent, lim)
            gap = assign_gap(e, cent, lim, got, want)
            need(gap <= ASSIGN_TOL, f"dpq_assign within {ASSIGN_TOL} at D="
                 f"{d}, vocab {n}")
            ms, host = time_ms(lambda: dpq_assign(e, cent, lim))
            # the plain version's few large launches: few calls, so the
            # launch queue stays shallow behind the held card
            plain, _ = time_ms(lambda: dpq_assign_ref(e, cent, lim),
                               iters=20)
            bound, by, flops, nbytes, _ = assign_bound(e, 256, lim, 1)
            log(f"time dpq_assign vocab={n} D={d} K=256/64 S={s} f32 (a "
                f"backbone table's export, tiles "
                f"{choose_tiles(torch.float32, n, d, 256, s)}): kernel "
                f"{ms:.5f} ms, plain {plain:.5f} ms, bound {bound:.5f} ms by "
                f"{by} ({flops} FLOP, {nbytes} bytes); "
                f"{int((got != want).sum())} of {n * d} codes differ from "
                f"the plain version, largest distance gap {gap:.3g}; host "
                f"time to launch {host:.5f} ms")
            del e, cent, lim, got, want
        b = BB_EVAL * 101
        codes, cent = decode_inputs(b, d, 256, s, torch.float32, seed=d)
        got, want = mgqe_decode(codes, cent), mgqe_decode_ref(codes, cent)
        torch.cuda.synchronize()
        need(torch.equal(bits(got), bits(want)), f"mgqe_decode bit-identical "
             f"at D={d}, S={s}")
        offs = (codes.long() + torch.arange(d, device="cuda") * 256
                ).contiguous()
        flat = cent.reshape(d * 256, s)
        # the planned route (smem: the 64 KB table staged a block), and
        # the l2 route on the same call for comparison
        l2 = l2_gather_plan(b, d, s * 4, sms)
        need(torch.equal(bits(mgqe_decode(codes, cent, plan=l2)),
                         bits(want)), f"mgqe_decode's l2 route "
             f"bit-identical at D={d}, S={s}")
        ms, host = time_ms(lambda: mgqe_decode(codes, cent))
        l2_ms, _ = time_ms(lambda: mgqe_decode(codes, cent, plan=l2))
        plain, _ = time_ms(lambda: mgqe_decode_ref(codes, cent))
        lib, _ = time_ms(lambda: F.embedding(offs, flat))
        nbytes = b * d + d * 256 * s * 4 + b * d * s * 4
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"time mgqe_decode B={b} D={d} K=256 S={s} f32 (the backbones' "
            f"candidates, {decode_plan(b, d, 256, s, 1, 4, sms)}): kernel "
            f"{ms:.5f} ms (on the l2 route {l2}: {l2_ms:.5f} ms), plain "
            f"{plain:.5f} ms, F.embedding {lib:.5f} ms, bound {bound:.5f} "
            f"ms by bytes ({nbytes} bytes, {100 * bound / ms:.0f}% of it); "
            f"host time to launch {host:.5f} ms")
        del codes, cent, got, want, offs, flat


def backbone_path() -> tuple:
    """The backbone phase: training (``bb_training``), the card against
    the CPU (``bb_card_vs_cpu``), export and serving (``bb_serving``)
    and the kernels at the backbones' widths (``time_bb_kernels``).
    Returns (launches of the export and serving, largest distance
    gap)."""
    import torch
    from repro_torch.data.synthetic import movielens_like
    t0 = time.perf_counter()
    ml = movielens_like(n_users=BB_USERS, n_items=BB_ITEMS, seed=0)
    log(f"backbone data: movielens_like {BB_USERS} users x {BB_ITEMS} items,"
        f" {sum(len(s) for s in ml.train_seqs)} training interactions, "
        f"built in {time.perf_counter() - t0:.1f}s")
    runs = bb_training(ml)
    bb_card_vs_cpu()
    launches, gap = bb_serving(runs, ml)
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    time_bb_kernels()
    log(f"backbone phase: {time.perf_counter() - t0:.1f}s in all")
    return launches, gap


# ----------------------------------------------------------------------
# the LM phase: flash_attention, dpq_assign at LM widths, gemma3-4b
# served at full width
# ----------------------------------------------------------------------

def flash_inputs(b, sq, skv, h, hkv, hd, dtype, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, sq, h, hd), generator=g, device="cuda")
    k = torch.randn((b, skv, hkv, hd), generator=g, device="cuda")
    v = torch.randn((b, skv, hkv, hd), generator=g, device="cuda")
    q, k = q * FLASH_QK_SCALE, k * FLASH_QK_SCALE
    return q.to(dtype), k.to(dtype), v.to(dtype)


def planted_attention(q, k, v, window, fault):
    """The kernel's arithmetic (float32 scores, P rounded to v's dtype,
    float32 sums) written densely, with a planted fault: ``flat`` gives
    every key of the band the same weight (the scores ignored),
    ``dropped tile`` leaves out one KV tile in the middle of the last
    row's band."""
    import torch
    b, sq, h, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, hkv, h // hkv, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * hd ** -0.5
    if fault == "flat":
        s = torch.zeros_like(s)
    i = torch.arange(sq, device=q.device)[:, None]
    j = torch.arange(skv, device=q.device)[None, :]
    seen = (i - j >= 0) & (i - j < window)
    if fault == "dropped tile":
        lo = (sq - 1 - min(window, sq) // 2) // FLASH_TILE * FLASH_TILE
        seen &= (j < lo) | (j >= lo + FLASH_TILE)
    s = s.masked_fill(~seen, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float())
    o = o / l[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(q.shape).to(q.dtype)


def bf16_row_ratio(got, want32):
    """max |got - want32| over each row's bar, FLASH_BF16_ROW_TOL times
    the row's (query, head) largest |want32|; <= 1 passes."""
    bar = FLASH_BF16_ROW_TOL * want32.abs().amax(-1, keepdim=True)
    return float(((got.float() - want32).abs() / bar).max())


def check_flash() -> float:
    """flash_attention against its plain version at every FLASH_CASES
    shape, float32 and bfloat16 (bf16 also per row against the plain
    version in float32, a bar the planted faults must fail); returns
    the largest |diff| to the plain version."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    worst = 0.0
    for name, b, sq, skv, h, hkv, hd, win in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(b, sq, skv, h, hkv, hd, dtype, seed=sq)
            got = flash_attention(q, k, v, window=win)
            want = flash_attention_ref(q, k, v, window=win)
            torch.cuda.synchronize()
            tol = FLASH_TOL[str(dtype).removeprefix("torch.")]
            err = float((got.float() - want.float()).abs().max())
            line = (f"check flash_attention {name} B={b} Sq={sq} Skv={skv} "
                    f"H={h} Hkv={hkv} hd={hd} window={win} {dtype}: "
                    f"max_abs_err={err:.3g} (bar {tol})")
            ratio, planted = 0.0, {}
            if dtype == torch.bfloat16:
                want32 = flash_attention_ref(q.float(), k.float(), v.float(),
                                             window=win)
                ratio = bf16_row_ratio(got, want32)
                line += (f"; per row against the float32 plain version "
                         f"{ratio:.3g} of the bar")
                for fault in ("flat", "dropped tile"):
                    bad = planted_attention(q, k, v, win, fault)
                    planted[fault] = bf16_row_ratio(bad, want32)
                    line += (f"; planted {fault}: {planted[fault]:.3g} of the "
                             f"bar, max_abs_err "
                             f"{float((bad.float() - want.float()).abs().max()):.3g}")
                    del bad
                del want32
            log(line)
            need(got.shape == want.shape and got.dtype == dtype
                 and bool(torch.isfinite(got).all()),
                 f"flash_attention output at {name} {dtype}")
            need(err <= tol, f"flash_attention within {tol} of the plain "
                 f"version at {name} {dtype}")
            need(ratio <= 1, f"flash_attention within {FLASH_BF16_ROW_TOL:.4g}"
                 f" of each row's largest |output| at {name} {dtype}")
            for fault, bad_ratio in planted.items():
                need(bad_ratio > 1, f"the planted {fault} fault fails the "
                     f"bf16 bar at {name}")
            worst = max(worst, err)
            del q, k, v, got, want
    torch.cuda.empty_cache()
    return worst


def check_lm_assign() -> float:
    """dpq_assign at the LM token tables' widths (D=8, S=2560/8=320 for
    gemma3-4b and 5376/8=672 for gemma3-27b), K=256 and K=64, with the
    MGQE budgets, float32 and bfloat16, against the plain assignment;
    returns the largest distance gap."""
    import torch
    from repro_torch.kernels.dpq_assign import dpq_assign
    gap = 0.0
    for s in (320, 672):
        for k in (256, 64):
            for dtype in (torch.float32, torch.bfloat16):
                e, cent, lim = assign_inputs(ASSIGN_BATCH, 8, k, s, seed=k + s,
                                             k_small=64, dtype=dtype)
                got = dpq_assign(e, cent, lim)
                want = blocked_assign_ref_lim(e, cent, lim)
                g = assign_gap(e, cent, lim, got, want)
                log(f"check dpq_assign B={ASSIGN_BATCH} D=8 K={k} S={s} "
                    f"{dtype}: {int((got != want).sum())} of "
                    f"{ASSIGN_BATCH * 8} codes differ from the plain version,"
                    f" largest distance gap {g:.3g}")
                need(g <= ASSIGN_TOL, f"dpq_assign at S={s} K={k} {dtype} "
                     f"within {ASSIGN_TOL}")
                gap = max(gap, g)
    return gap


def lm27_export_check() -> float:
    """gemma3-27b's token table (262,144 x 5,376, lm_embedding's two
    tiers, param_dtype bfloat16), initialised from a seeded generator and
    exported as MGQE on the card: one dpq_assign launch a 65,536 rows, in
    bfloat16 on the tensor cores.  A head slice, the slice across the
    tier boundary and a tail slice are held to the plain assignment
    under the same budgets.  Only the embedding is built: the config is
    not registered.  Returns the largest distance gap."""
    import dataclasses
    import torch
    from repro_torch.configs.lm_common import lm_embedding
    from repro_torch.core import Embedding
    from repro_torch.core.mgqe import k_limit_for_all_rows
    from repro_torch.kernels.dpq_assign import dpq_assign
    ecfg = dataclasses.replace(lm_embedding(LM27_VOCAB, LM27_DIM),
                               param_dtype="bfloat16")
    d = ecfg.num_subspaces
    emb = Embedding(ecfg)
    params = emb.init(emb.generator(27))
    need(params["emb"].dtype == params["centroids"].dtype == torch.bfloat16,
         "gemma3-27b's table and centroids in bfloat16")
    torch.cuda.synchronize()
    before = dpq_assign.launches
    t0 = time.perf_counter()
    artifact = emb.export(params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = dpq_assign.launches - before
    need(launched == -(-LM27_VOCAB // ASSIGN_BATCH),
         "dpq_assign once per export batch of the bf16 table")
    codes, cent = artifact["codes"], artifact["centroids"]
    need(codes.dtype == torch.uint8 and tuple(codes.shape) == (LM27_VOCAB, d)
         and cent.dtype == torch.bfloat16, "codes (n, D) uint8, bf16 "
         "centroids")
    lim_all = k_limit_for_all_rows(ecfg, "cuda")
    head = ecfg.tier_boundaries[0]
    gap, mism = 0.0, 0
    # the boundary slice: its first eighth in the head tier (which holds
    # 26,214 rows, under half a batch)
    for lo in (0, head - ASSIGN_BATCH // 8, LM27_VOCAB - ASSIGN_BATCH):
        sl = slice(lo, lo + ASSIGN_BATCH)
        e = params["emb"][sl].reshape(ASSIGN_BATCH, d, -1)
        got = codes[sl].to(torch.int32)
        want = blocked_assign_ref_lim(e, cent, lim_all[sl])
        mism += int((got != want).sum())
        gap = max(gap, assign_gap(e, cent, lim_all[sl], got, want))
    need(gap <= ASSIGN_TOL, f"bf16 exported codes within {ASSIGN_TOL} of "
         f"the plain assignment")
    need(int(codes[head:].max()) < ecfg.tier_num_centroids[1],
         "tail tier codes < K_tail")
    log(f"lm bf16 export: gemma3-27b's token table {LM27_VOCAB} x "
        f"{LM27_DIM} (D={d}, S={LM27_DIM // d}, K={ecfg.num_centroids}/"
        f"{ecfg.tier_num_centroids[1]}, head {head} rows) in bfloat16, "
        f"exported in {wall:.6f}s over {launched} dpq_assign launches; "
        f"head, tier-boundary and tail slices ({3 * ASSIGN_BATCH} rows): "
        f"{mism} of {3 * ASSIGN_BATCH * d} codes differ from the plain "
        f"assignment, largest distance gap {gap:.3g} (tolerance "
        f"{ASSIGN_TOL})")
    return gap


@contextlib.contextmanager
def window_short_by_a_tile(layers: int):
    """A planted fault: inside the block, the first ``layers`` local
    layers (window below the full one) reach ``chunked_attention`` with
    their window one KV tile short."""
    from repro_torch.nn import attention as attn
    sound = attn.chunked_attention
    left = [layers]

    def faulty(q, k, v, qpos, kpos, window=attn.FULL_WINDOW, **kw):
        if window < attn.FULL_WINDOW and left[0] > 0:
            left[0] -= 1
            window -= FLASH_TILE
        return sound(q, k, v, qpos, kpos, window, **kw)
    attn.chunked_attention = faulty
    try:
        yield
    finally:
        attn.chunked_attention = sound


@contextlib.contextmanager
def attention_in_f32():
    """The plain route with its attention computed in float32 on the
    same bf16 inputs (scores and P unrounded), the output rounded once
    to bf16."""
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.nn import attention as attn
    sound = attn.chunked_attention

    def f32(q, k, v, qpos, kpos, window=attn.FULL_WINDOW, **kw):
        return flash_attention_ref(q.float(), k.float(), v.float(),
                                   int(window)).to(q.dtype)
    attn.chunked_attention = f32
    try:
        yield
    finally:
        attn.chunked_attention = sound


def lm_statistics(run, cfg) -> dict:
    """Distances from the kernel route (sound, and with the window one
    KV tile short on layer 0 and on every local layer) to two plain
    routes (bf16 attention; attention in f32 on the same inputs), read
    on the last-token logits and on every position's final hidden
    state, max and mean |diff|.  Returns {statistic: (sound, fault on
    1 layer, fault on every layer)} for each plain route."""
    import torch
    from repro_torch.kernels.dispatch import pinned_backend
    from repro_torch.models import lm

    def hidden():
        with torch.no_grad():
            return lm.forward(run.params, run.prompts, cfg,
                              embed_artifact=run.artifact)[0]

    def logits(h):
        return (h[:, -1] @ run.params["lm_head"].to(h.dtype)).float()

    routes = {"sound": hidden()}
    for layers in (1, cfg.num_layers):
        with window_short_by_a_tile(layers):
            routes[layers] = hidden()
    refs = {}
    with pinned_backend("torch"):
        refs["plain bf16"] = hidden()
        with attention_in_f32():
            refs["plain f32"] = hidden()
    out = {}
    for ref_name, ref in refs.items():
        ref_logits = logits(ref)
        for what in ("logits", "hidden"):
            for stat in ("max", "mean"):
                vals = []
                for key in ("sound", 1, cfg.num_layers):
                    got = routes[key]
                    d = ((logits(got) - ref_logits) if what == "logits"
                         else (got.float() - ref.float())).abs()
                    vals.append(float(d.max() if stat == "max"
                                      else d.mean()))
                out[(ref_name, what, stat)] = tuple(vals)
                of = ("last-token logits" if what == "logits"
                      else "final hidden state at every position")
                log(f"lm statistic against the {ref_name} route, {stat} "
                    f"|diff| of the {of}: sound {vals[0]:.5g}, window fault on layer 0 "
                    f"{vals[1]:.5g} ({vals[1] / max(vals[0], 1e-30):.2f}x), "
                    f"on every local layer {vals[2]:.5g} "
                    f"({vals[2] / max(vals[0], 1e-30):.2f}x)")
    del routes, refs
    out.update(lm_layer_statistics(run, cfg))
    return out


def lm_layer_statistics(run, cfg) -> dict:
    """Each layer of the prefill fed the plain route's input to that
    layer (its output on the plain ops as the reference), so that bf16
    noise does not build up from layer to layer: the largest over the
    layers of the mean |diff| of a layer's output, for the kernel route
    (sound, and with the window one KV tile short on layer 0 and on
    every local layer) against the plain bf16 and the plain f32-
    attention routes.  Returns {statistic: (sound, fault on 1 layer,
    fault on every layer)}."""
    import torch
    from repro_torch.core import Embedding
    from repro_torch.core.schemes.base import torch_dtype
    from repro_torch.kernels.dispatch import pinned_backend
    from repro_torch.models import lm

    dtype = torch_dtype(cfg.dtype)
    s = run.prompts.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device="cuda")
    plan = [(lm._index(run.params[name], *idx), window, theta)
            for name, idx, window, theta in lm._layer_plan(cfg, s)]

    def layer(p, x, window, theta):
        return lm.layer_forward(p, x, positions, window, theta, cfg)[0]

    out = {}
    with torch.no_grad():
        x0 = Embedding(cfg.embedding, device="cuda").serve(run.artifact,
                                                           run.prompts)
        x0 = x0.to(dtype) * torch.tensor(cfg.d_model ** 0.5, dtype=dtype)
        for ref_name in ("plain bf16", "plain f32"):
            inputs, refs = [], []
            x = x0
            with pinned_backend("torch"), (attention_in_f32()
                                           if ref_name == "plain f32"
                                           else contextlib.nullcontext()):
                for p, window, theta in plan:
                    inputs.append(x)
                    x = layer(p, x, window, theta)
                    refs.append(x)
            vals = []
            for layers in (0, 1, cfg.num_layers):
                per_layer = []
                with (window_short_by_a_tile(layers) if layers
                      else contextlib.nullcontext()):
                    for (p, window, theta), xin, ref in zip(plan, inputs,
                                                            refs):
                        got = layer(p, xin, window, theta)
                        per_layer.append(float((got.float() - ref.float())
                                               .abs().mean()))
                vals.append(max(per_layer))
                if layers == 0:
                    sound_layers = per_layer
            out[(ref_name, "layer", "mean")] = tuple(vals)
            log(f"lm statistic against the {ref_name} route, each layer fed "
                f"that route's input: the largest mean |diff| of a layer's "
                f"output: sound {vals[0]:.5g} (layer "
                f"{sound_layers.index(vals[0])}), window fault on layer 0 "
                f"{vals[1]:.5g} ({vals[1] / max(vals[0], 1e-30):.2f}x), on "
                f"every local layer {vals[2]:.5g} "
                f"({vals[2] / max(vals[0], 1e-30):.2f}x); sound per layer "
                f"{[round(v, 5) for v in sound_layers]}")
            del inputs, refs
    return out


def lm_path() -> dict:
    """gemma3-4b at ``configs/gemma3_4b.py::CONFIG`` through
    ``launch.serve.serve_lm``: init, MGQE export of the 262,144 x 2,560
    token table, prefill of 2 prompts of 4,096 tokens, 16 greedy decode
    steps, the counts set to 0 just before and read just after; then the
    token rows held bit-identical to the plain decode, the exported
    codes of a head and a tail slice to the plain assignment, and the
    last-token logits to the same prefill on the plain ops.  Returns
    the launches."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core import Embedding
    from repro_torch.core.mgqe import k_limit_for_all_rows
    from repro_torch.kernels.dispatch import pinned_backend
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import lm

    _, cfg = get_arch(LM_ARCH, smoke=False)
    ecfg = cfg.embedding
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counts()
    t0 = time.perf_counter()
    run = serve_lm(cfg, LM_BATCH, LM_PROMPT, LM_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    emb = Embedding(ecfg)
    want = {"dpq_assign": -(-ecfg.vocab_size // ASSIGN_BATCH),
            "mgqe_decode": 1 + LM_STEPS, "flash_attention": cfg.num_layers}
    log(f"lm path: {cfg.name} {cfg.num_layers} layers d_model "
        f"{cfg.d_model} heads {cfg.num_heads}/{cfg.num_kv_heads} hd "
        f"{cfg.resolved_head_dim}, {cfg.param_count()} params "
        f"({cfg.param_dtype}), vocab {ecfg.vocab_size} as MGQE (head tier "
        f"{ecfg.tier_boundaries[0]} rows at K={ecfg.tier_num_centroids[0]}, "
        f"tail at K={ecfg.tier_num_centroids[1]}, D={ecfg.num_subspaces}); "
        f"artifact {emb.serving_size_bits() / 8e6:.2f} MB "
        f"({100 * emb.serving_size_bits() / (ecfg.vocab_size * ecfg.dim * 32):.2f}"
        f"% of full); init + export + prefill + decode in {wall:.3f}s; "
        f"prefill B={LM_BATCH} x {LM_PROMPT} in {run.prefill_seconds:.6f}s "
        f"({LM_BATCH * LM_PROMPT / run.prefill_seconds:,.0f} tokens/s); "
        f"{LM_STEPS} decode steps in {run.decode_seconds:.6f}s "
        f"({run.tokens_per_s:.2f} tokens/s, "
        f"{run.decode_seconds / LM_STEPS * 1e3:.3f} ms a step); peak device "
        f"memory {peak:.3f} GiB; launches {launches} (predicted {want})")
    for name, n in want.items():
        need(launches[name] == n, f"{name} launched {n} times on the LM "
             f"path")
    need(sum(launches.values()) == sum(want.values()),
         "no other kernel on the LM path")
    need(tuple(run.logits.shape) == (LM_BATCH, cfg.vocab_size)
         and bool(torch.isfinite(run.logits).all()),
         "prefill logits (B, V), finite")
    need(tuple(run.tokens.shape) == (LM_BATCH, LM_STEPS + 1)
         and bool(((run.tokens >= 0) & (run.tokens < cfg.vocab_size)).all()),
         "greedy tokens (B, steps + 1) in the vocabulary")

    # the token rows: the served decode against the plain decode
    rows = emb.serve(run.artifact, run.prompts)
    with pinned_backend("torch"):
        rows_plain = emb.serve(run.artifact, run.prompts)
    torch.cuda.synchronize()
    need(torch.equal(bits(rows), bits(rows_plain)),
         "token rows == the plain decode, bit for bit")
    # the exported codes of a head and a tail slice, under their budgets
    lim_all = k_limit_for_all_rows(ecfg, "cuda")
    gap = 0.0
    for lo in (0, ecfg.vocab_size - ASSIGN_BATCH):
        sl = slice(lo, lo + ASSIGN_BATCH)
        e = run.params["embed"]["emb"][sl].reshape(
            ASSIGN_BATCH, ecfg.num_subspaces, -1)
        cent = run.artifact["centroids"]
        got = run.artifact["codes"][sl].to(torch.int32)
        gap = max(gap, assign_gap(e, cent, lim_all[sl], got,
                                  blocked_assign_ref_lim(e, cent,
                                                         lim_all[sl])))
    need(gap <= ASSIGN_TOL, f"exported codes within {ASSIGN_TOL} of the "
         f"plain assignment")
    # the export's four dpq_assign launches, timed on the table it
    # exported (f32, S = 320, the tiers' budgets by sorted id)
    time_assign_pass(f"over {cfg.name}'s export (the served table)",
                     run.params["embed"]["emb"].reshape(
                         ecfg.vocab_size, ecfg.num_subspaces, -1),
                     run.artifact["centroids"], lim_all, ASSIGN_BATCH)
    # the last-token logits against the same prefill on the plain ops;
    # then the kernel route with a planted fault (the window one KV tile
    # short on layer 0, and on every local layer) must fail that check
    with torch.no_grad(), pinned_backend("torch"):
        logits_plain = lm.prefill(run.params, run.prompts, cfg,
                                  max_seq=LM_PROMPT + LM_STEPS,
                                  embed_artifact=run.artifact)[1]

    def against_plain(logits):
        d = (logits - logits_plain).abs()
        return (float(d.max()), float(d.mean()),
                bool(torch.equal(logits.argmax(-1), logits_plain.argmax(-1))))
    planted = {}
    for layers in (1, cfg.num_layers):
        with torch.no_grad(), window_short_by_a_tile(layers):
            planted[layers] = against_plain(lm.prefill(
                run.params, run.prompts, cfg, max_seq=LM_PROMPT + LM_STEPS,
                embed_artifact=run.artifact)[1])
    torch.cuda.synchronize()
    err, mean_err, top1 = against_plain(run.logits)
    log(f"lm checks: token rows bit-identical to the plain decode; "
        f"exported codes (head and tail slices) within {gap:.3g} of the "
        f"plain assignment; last-token logits against the plain attention: "
        f"max |diff| {err:.4g} (bar {LM_LOGIT_TOL}), mean |diff| "
        f"{mean_err:.4g}, largest |logit| "
        f"{float(logits_plain.abs().max()):.4g}, top-1 tokens equal: {top1}; "
        f"the kernel route with the window one KV tile short (max |diff|, "
        f"mean |diff|, top-1 equal): on layer 0 {planted[1]}, on every "
        f"local layer {planted[cfg.num_layers]}; sample tokens "
        f"{run.tokens[0, :8].tolist()}")
    need(top1, "prefill top-1 tokens == the plain ops'")
    need(err <= LM_LOGIT_TOL, f"prefill logits within {LM_LOGIT_TOL} of "
         f"the plain ops'")
    for layers, (bad, _, bad_top1) in planted.items():
        need(bad > LM_LOGIT_TOL or not bad_top1, f"the planted window "
             f"fault on {layers} layer(s) fails the logits check")
    stats = lm_statistics(run, cfg)
    sound, *faults = stats[("plain f32", "layer", "mean")]
    need(sound <= LM_LAYER_TOL, f"every prefill layer within "
         f"{LM_LAYER_TOL} (mean |diff|) of the plain route's, from the "
         f"same input")
    for layers, bad in zip((1, cfg.num_layers), faults):
        need(bad > LM_LAYER_TOL, f"the planted window fault on {layers} "
             f"layer(s) fails the per-layer check")
    del rows, rows_plain, logits_plain

    # where the time goes: one prefill and one decode step, profiled
    with torch.no_grad():
        profile_phase(f"{cfg.name} prefill (B={LM_BATCH} x {LM_PROMPT})",
                      lambda: lm.prefill(run.params, run.prompts, cfg,
                                         max_seq=LM_PROMPT + LM_STEPS,
                                         embed_artifact=run.artifact))
        cache, _ = lm.prefill(run.params, run.prompts, cfg,
                              max_seq=LM_PROMPT + LM_STEPS,
                              embed_artifact=run.artifact)
        tok = run.tokens[:, 0]
        profile_phase(f"{cfg.name} decode step (B={LM_BATCH})",
                      lambda: lm.decode_step(run.params, cache, tok, cfg,
                                             embed_artifact=run.artifact))
    del run, cache
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def sdpa_backend(fn) -> str:
    """The kernels one ``scaled_dot_product_attention`` call ran, named
    from the profiler (the dispatcher picks among flash, efficient,
    cuDNN and math without saying which)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted({ev.key for ev in prof.key_averages()
                    if ev.device_type == DeviceType.CUDA})
    low = " ".join(names).lower()
    kind = ("flash" if "flash" in low else
            "cuDNN" if "cudnn" in low else
            "efficient (cutlass fmha)" if "fmha" in low or "efficient" in low
            else "math (matmuls and softmax)")
    return f"{kind}: {[n[:60] for n in names][:4]}"


def time_flash(err: float, launches: dict) -> dict:
    """flash_attention timed at gemma3-4b's local and global layer
    shapes (bf16, the path's prefill), beside its plain version, one
    ``F.scaled_dot_product_attention`` call and its bound; the
    ``kernels`` entry holds the per-launch mean over the prefill's layer
    mix (29 local, 5 global)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    _, cfg = get_arch(LM_ARCH, smoke=False)
    b, s, h, hkv = LM_BATCH, LM_PROMPT, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    n_glob = cfg.num_layers // (cfg.local_global_pattern + 1)
    n_loc = cfg.num_layers - n_glob
    q, k, v = flash_inputs(b, s, s, h, hkv, hd, torch.bfloat16, seed=21)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    pos = torch.arange(s, device="cuda")
    times = {}
    for name, win in (("local", cfg.sliding_window), ("global", FULL_WINDOW)):
        delta = pos[:, None] - pos[None, :]
        band = (delta >= 0) & (delta < win)
        if win >= s:
            def lib():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
        else:
            def lib():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=band, enable_gqa=True)
        ms, host = time_ms(lambda: flash_attention(q, k, v, window=win),
                           iters=10, warmup=2)
        other = {bk: time_ms(lambda: flash_attention(q, k, v, window=win,
                                                     block_k=bk),
                             iters=10, warmup=2)[0] for bk in (32, 64)}
        plain, _ = time_ms(lambda: flash_attention_ref(q, k, v, window=win),
                           iters=3, warmup=1, hold=False)
        lib_ms, _ = time_ms(lib, iters=10, warmup=2)
        lib_err = float((lib().transpose(1, 2).float()
                         - flash_attention_ref(q, k, v, window=win).float())
                        .abs().max())
        pairs = int(band.sum()) * b * h
        flops = 4 * hd * pairs
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
        t_ops = flops / BF16_FLOP_PER_S * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        times[name] = (ms, plain, lib_ms, max(t_ops, t_bytes),
                       "operations" if t_ops >= t_bytes else "bytes")
        log(f"time flash_attention gemma3-4b {name} layer B={b} S={s} H={h} "
            f"Hkv={hkv} hd={hd} window={win} bf16: kernel {ms:.5f} ms, "
            f"plain {plain:.5f} ms, F.scaled_dot_product_attention "
            f"{lib_ms:.5f} ms ({sdpa_backend(lib)}; max |diff| to the "
            f"plain version {lib_err:.3g}), bound {max(t_ops, t_bytes):.5f} "
            f"ms ({flops} FLOP over {pairs} visible pairs at 989 TFLOP/s, "
            f"{nbytes} bytes); {flops / ms / 1e9:.2f} TFLOP/s; host time to "
            f"launch {host:.5f} ms; the kernel at block_k 32 / 64: "
            f"{other[32]:.5f} / {other[64]:.5f} ms")
    del q, k, v, qt, kt, vt
    # gemma3-27b's layer (hd 168, zero-padded to 176 on the tensor
    # cores) at either KV tile, for the tile the kernel picks by default
    q, k, v = flash_inputs(1, s, s, 32, 16, 168, torch.bfloat16, seed=27)
    for name, win in (("local", 1024), ("global", FULL_WINDOW)):
        tiles = {bk: time_ms(lambda: flash_attention(q, k, v, window=win,
                                                     block_k=bk),
                             iters=10, warmup=2)[0] for bk in (32, 64)}
        log(f"time flash_attention gemma3-27b {name} layer B=1 S={s} H=32 "
            f"Hkv=16 hd=168 window={win} bf16: block_k 32 / 64: "
            f"{tiles[32]:.5f} / {tiles[64]:.5f} ms")
    mix = [(times["local"], n_loc), (times["global"], n_glob)]

    def mean(i):
        return sum(t[i] * n for t, n in mix) / cfg.num_layers

    log(f"time flash_attention per launch over the prefill's {n_loc} local "
        f"and {n_glob} global layers: kernel {mean(0):.5f} ms, plain "
        f"{mean(1):.5f} ms, library {mean(2):.5f} ms, bound {mean(3):.5f} ms")
    del q, k, v
    gc.collect()
    torch.cuda.empty_cache()
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/"
                        "flash_attention.py:81",
            "launches": launches["flash_attention"], "max_abs_err": err,
            "ms": mean(0), "plain_ms": mean(1), "bound_ms": mean(3),
            "bound_by": times["global"][4], "library_ms": mean(2)}


def kernel_counters() -> dict:
    """Every kernel wrapper of the port, by name (each keeps its own
    ``launches`` count)."""
    from repro_torch.kernels.dpq_assign import dpq_assign
    from repro_torch.kernels.mgqe_decode import mgqe_decode, rq_decode_stages
    from repro_torch.kernels.packed_decode import packed_decode
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.pq_score import (pq_score, pq_score_batched,
                                              pq_topk)
    return {"mgqe_decode": mgqe_decode, "dpq_assign": dpq_assign,
            "rq_decode_stages": rq_decode_stages,
            "packed_decode": packed_decode, "pq_score": pq_score,
            "pq_score_batched": pq_score_batched, "pq_topk": pq_topk,
            "embedding_bag": embedding_bag,
            "flash_attention": flash_attention}


def reset_counts() -> dict:
    """Set every kernel's launch count to 0; returns the wrappers."""
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    return counters


def drive_keeping_flushes(engine, requests) -> list:
    """The request stream through the engine once more, flushing where
    ``serve_stream`` flushes; returns, per flush, its requests
    concatenated (numpy) and the flush's per-request results."""
    import numpy as np
    out, pending = [], []

    def flush():
        res = engine.flush()
        out.append((np.concatenate(pending), res))
        pending.clear()

    for r in requests:
        engine.submit(r)
        pending.append(r)
        if engine.should_flush():
            flush()
    flush()
    return out


def retrieval_path():
    """two-tower retrieval at full width: serve_retrieval, then the
    stream kept per flush, the exactness oracle and one user's ADC
    scores; checks (a)-(d), and the index's codes against the plain
    assignment.  Returns (launches, errs, timing inputs, queries/s)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.dpq_assign import dpq_assign
    from repro_torch.kernels.pq_score import (build_lut_batch, pq_score,
                                              pq_score_batched_ref,
                                              pq_score_ref, pq_topk_ref)
    from repro_torch.launch.serve import serve_retrieval

    _, cfg = get_arch("two-tower-retrieval", smoke=False)
    n_cand = retrieval_candidates()
    log(f"retrieval path: {cfg.name} users={cfg.n_users} items="
        f"{cfg.n_items} embed_dim={cfg.embed_dim} towers={cfg.tower_mlp} "
        f"D={cfg.num_subspaces}; flat_pq D=8 K=64 over {n_cand} "
        f"candidates, top-{TOPK}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counts()
    t0 = time.perf_counter()
    run = serve_retrieval(cfg, n_cand, topk=TOPK)
    flushes = []
    for flat, res in drive_keeping_flushes(run.engine, run.requests):
        # the flush's queries padded as run_flat pads them
        pad = (-flat.shape[0]) % run.engine.pad_multiple
        flushes.append((torch.from_numpy(np.pad(flat, ((0, pad), (0, 0))))
                        .cuda(), flat.shape[0],
                        torch.cat([sc for sc, _ in res]),
                        torch.cat([ix for _, ix in res])))
    oracle = [run.index.scores(run.artifact, q) for q, _, _, _ in flushes]
    user0 = torch.tensor([int(run.users[0][0])], device="cuda")
    adc = run.model.retrieval_scores_adc(run.params, run.artifact, user0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    st = run.stats
    log(f"retrieval path: {wall:.1f}s (index build {run.build_seconds:.3f}s);"
        f" engine {st.requests} requests / {st.lookups} queries in "
        f"{st.flushes} flushes ({st.padded_lookups} padded), "
        f"{st.seconds:.6f}s -> {st.lookups_per_s:,.1f} queries/s; "
        f"recall@{TOPK} vs the dense scan {run.recall:.3f}; launches "
        f"{launches}; peak device memory {peak / 2**30:.2f} GiB "
        f"({peak} bytes) of {torch.cuda.get_device_properties(0).total_memory / 2**30:.2f} GiB")
    for name in ("dpq_assign", "pq_score", "pq_score_batched", "pq_topk"):
        need(launches[name] > 0, f"{name} launched on the retrieval path")
    need(st.requests == 50, "every retrieval request served")

    codes, cent = run.artifact["codes"], run.artifact["centroids"]
    n = codes.shape[0]
    need(codes.dtype == torch.uint8 and tuple(codes.shape) == (n_cand, 8)
         and tuple(cent.shape) == (8, 64, cfg.tower_mlp[-1] // 8),
         "index codes (N, 8) uint8, centroids (8, 64, S)")
    errs = {"pq_score": 0.0, "pq_score_batched": 0.0, "pq_topk": 0.0}
    for (q, n_valid, s, i), scores in zip(flushes, oracle):
        need(tuple(s.shape) == tuple(i.shape) == (n_valid, TOPK),
             "flush results (rows, k)")
        need(bool(torch.isfinite(s).all()), "top-k scores finite")
        need(bool((i >= 0).all() and (i < n).all()), "top-k ids in range")
        need(bool((s[:, 1:] <= s[:, :-1]).all()), "top-k scores descend")
        luts = build_lut_batch(q, cent).contiguous()
        for c0 in range(0, n_valid, 32):
            c1 = min(c0 + 32, n_valid)
            # (a) the plain top-k of the same LUTs, bit for bit
            ws, wi = pq_topk_ref(luts[c0:c1], codes, TOPK)
            need(torch.equal(bits(s[c0:c1]), bits(ws))
                 and torch.equal(i[c0:c1], wi), "(a) flush == pq_topk_ref")
            errs["pq_topk"] = max(errs["pq_topk"], finite_err(s[c0:c1], ws))
            # (b) a stable descending sort of the oracle's scores
            srt = torch.sort(scores[c0:c1], dim=1, descending=True,
                             stable=True)
            need(torch.equal(bits(s[c0:c1]), bits(srt.values[:, :TOPK]))
                 and torch.equal(i[c0:c1].long(), srt.indices[:, :TOPK]),
                 "(b) flush == stable sort of FlatPQ.scores")
            # the oracle (pq_score_batched) against its plain version
            want = pq_score_batched_ref(luts[c0:c1], codes)
            need(torch.equal(bits(scores[c0:c1]), bits(want)),
                 "pq_score_batched == plain")
            errs["pq_score_batched"] = max(errs["pq_score_batched"],
                                           finite_err(scores[c0:c1], want))
    # (c) one user's ADC scores (pq_score) == that user's oracle row;
    # the same LUT through pq_score gives the oracle row's bits
    row = oracle[0][0]
    adc_err = float((adc - row).abs().max())
    adc_same = int((bits(adc) == bits(row)).sum())
    need(adc_err <= ADC_TOL, f"(c) retrieval_scores_adc within {ADC_TOL}")
    lut0 = build_lut_batch(flushes[0][0], cent)[0].contiguous()
    k_row = pq_score(lut0, codes)
    need(torch.equal(bits(k_row), bits(row)),
         "(c) pq_score == pq_score_batched on one LUT")
    w_row = pq_score_ref(lut0, codes)
    need(torch.equal(bits(k_row), bits(w_row)), "pq_score == plain")
    errs["pq_score"] = finite_err(k_row, w_row)
    log(f"retrieval checks: {len(flushes)} flush(es), {sum(f[1] for f in flushes)}"
        f" queries: (a) top-k bit-identical to pq_topk_ref, (b) to a stable"
        f" sort of FlatPQ.scores; (c) user {int(user0)}'s "
        f"retrieval_scores_adc within {adc_err:.3g} of its oracle row "
        f"({adc_same} of {n} scores bit-identical; pq_score on the oracle's "
        f"LUT: all bit-identical); (d) launches {launches}")

    # the index's codes came from the path's one dpq_assign launch over
    # all N tower outputs (D = 8, K = 64, S = 32: the tiled product,
    # which deepfm's S = 2 never takes); hold them, and the
    # kernel run again on the same outputs, against the plain assignment
    e = run.model.encode_items(run.params, torch.arange(n, device="cuda"))
    e = e.reshape(n, cent.shape[0], cent.shape[2]).contiguous()
    want = blocked_assign_ref_lim(e, cent, None)
    again = dpq_assign(e, cent)
    gap = max(assign_gap(e, cent, None, codes, want),
              assign_gap(e, cent, None, again, want))
    agree = int((codes.long() == want.long()).sum())
    log(f"retrieval check dpq_assign B={n} D={cent.shape[0]} "
        f"K={cent.shape[1]} S={cent.shape[2]}: the index's codes and a "
        f"fresh launch against the plain assignment, {agree} of "
        f"{codes.numel()} codes equal, largest distance gap {gap:.3g} "
        f"(tolerance {ASSIGN_TOL})")
    need(gap <= ASSIGN_TOL, f"index codes within {ASSIGN_TOL} of the plain "
         f"assignment")
    errs["dpq_assign"] = gap
    del e, want, again

    # where the time goes: device time by kernel under the profiler
    gen = torch.Generator(device="cuda").manual_seed(1)
    ids = torch.arange(n, device="cuda")
    profile_phase("index build", lambda: run.model.build_index(
        gen, run.params, ids, run.index.cfg))
    profile_phase("retrieval serve (one pass)", lambda: run.engine.serve_stream(
        run.requests))
    timing = (luts_of(flushes[0][0], cent), codes)
    del run, flushes, oracle, adc
    gc.collect()
    torch.cuda.empty_cache()
    return launches, errs, timing, st.lookups_per_s


def luts_of(queries, cent):
    from repro_torch.kernels.pq_score import build_lut_batch
    return build_lut_batch(queries, cent).contiguous()


def time_pq_kernels(errs: dict, launches: dict, luts, codes) -> list:
    """The pq kernels' ``kernels`` entries at the retrieval path's
    shapes: N = 1M candidates, D = 8, K = 64, k = 100, B = the flush's
    padded size (1 for pq_score)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.pq_score import (pq_score, pq_score_batched,
                                              pq_score_batched_ref,
                                              pq_score_ref, pq_topk,
                                              pq_topk_ref)
    b, d, k = luts.shape
    n = codes.shape[0]
    src = "src/repro_torch/kernels/csrc/pq_score.cu"
    tpu = "src/repro/kernels/pq_score/pq_score.py"
    offs = (codes.long() + torch.arange(d, device="cuda") * k).contiguous()
    table = luts.permute(1, 2, 0).reshape(d * k, b).contiguous()
    lut1 = luts[0].contiguous()
    table1 = lut1.reshape(d * k, 1).contiguous()

    def bound(nbytes, ops):
        t_b = nbytes / HBM_BYTES_PER_S * 1e3
        t_o = ops / F32_FLOP_PER_S * 1e3
        return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"

    out = []
    cases = [
        ("pq_score", 62, lambda: pq_score(lut1, codes),
         lambda: pq_score_ref(lut1, codes),
         lambda: F.embedding_bag(offs, table1, mode="sum"),
         n * d + d * k * 4 + n * 4, n * d, 1),
        ("pq_score_batched", 93, lambda: pq_score_batched(luts, codes),
         lambda: pq_score_batched_ref(luts, codes),
         lambda: F.embedding_bag(offs, table, mode="sum"),
         n * d + b * d * k * 4 + b * n * 4, b * n * d, b),
        ("pq_topk", 146, lambda: pq_topk(luts, codes, TOPK),
         lambda: pq_topk_ref(luts, codes, TOPK), None,
         n * d + b * d * k * 4 + b * TOPK * 8, b * n * d, b),
    ]
    # pq_topk against the two-call composition it fuses (no single
    # library call computes it), and on its worst case: scores rising
    # with the id, every candidate passing every threshold
    fused, _ = time_ms(lambda: pq_topk(luts, codes, TOPK), iters=20,
                       warmup=2)
    two, _ = time_ms(lambda: torch.topk(pq_score_batched(luts, codes), TOPK),
                     iters=20, warmup=2)
    r_luts, r_codes = rising_scores(b, n, d, k)
    worst, _ = time_ms(lambda: pq_topk(r_luts, r_codes, TOPK), iters=3,
                       warmup=1)
    ws, wi = pq_topk(r_luts, r_codes, TOPK)
    want = torch.arange(n - 1, n - 1 - TOPK, -1, device="cuda",
                        dtype=torch.int32).expand(b, TOPK)
    need(torch.equal(wi, want) and torch.equal(ws, want.float()),
         "pq_topk's worst case: the last k ids, scores equal to the ids")
    log(f"time pq_topk N={n} B={b} D={d} K={k} k={TOPK}: kernel {fused:.5f} "
        f"ms (random LUTs), {worst:.5f} ms (worst case, scores rising with "
        f"the id, held exact); torch.topk(pq_score_batched(...)) "
        f"{two:.5f} ms, {two / fused:.2f}x the kernel's time")
    del r_luts, r_codes, ws, wi, want
    # the scoring kernels at a ragged batch (a masked last lanes group)
    luts465 = torch.cat([luts, luts[:1]]).contiguous()
    r_ms, _ = time_ms(lambda: pq_score_batched(luts465, codes), iters=20,
                      warmup=2)
    r_bound = (n * d + 465 * d * k * 4 + 465 * n * 4) / HBM_BYTES_PER_S * 1e3
    log(f"time pq_score_batched N={n} B=465 D={d} K={k}: kernel {r_ms:.5f} "
        f"ms, bound {r_bound:.5f} ms by bytes")
    del luts465
    for name, line, kern, plain_fn, lib_fn, nbytes, ops, bb in cases:
        ms, host = time_ms(kern, iters=20, warmup=2)
        plain, _ = time_ms(plain_fn, iters=3, warmup=1, hold=False)
        lib = None
        if lib_fn is not None:
            lib, _ = time_ms(lib_fn, iters=20, warmup=2)
        t, by = bound(nbytes, ops)
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": f"{tpu}:{line}",
                    "launches": launches[name], "max_abs_err": errs[name],
                    "ms": ms, "plain_ms": plain, "bound_ms": t,
                    "bound_by": by, "library_ms": lib})
        log(f"time {name} N={n} B={bb} D={d} K={k}"
            + (f" k={TOPK}" if name == "pq_topk" else "")
            + f": kernel {ms:.5f} ms, plain {plain:.5f} ms, library "
            + (f"{lib:.5f} ms (F.embedding_bag)" if lib is not None
               else "none")
            + f", bound {t:.5f} ms by {by} ({nbytes} bytes, {ops} adds); "
            f"host time to launch {host:.5f} ms")
        gc.collect()
        torch.cuda.empty_cache()

    return out


# ----------------------------------------------------------------------
# the retrieval-scale phase: ivf_pq built from a host corpus at the JAX
# bench's widths, searched on the card and host-staged; two-tower's
# CONFIG served through an IVF index
# ----------------------------------------------------------------------

def ivf_plain_search(index, art, q, k):
    """``index.search`` recomputed query by query on the same tables:
    its probe, then each query's own probed rows scored by the plain ADC
    (``pq_score_batched_ref`` on that query's LUT: the sum from +0.0 in
    subspace order), masked and selected as the index does."""
    import torch
    from repro_torch.kernels.pq_score import (INVALID_ID, build_lut_batch,
                                              pq_score_batched_ref)
    from repro_torch.retrieval import topk_by_position
    probe_s, lists = index._probe(art, q)
    luts = build_lut_batch(q, art["centroids"]).contiguous()
    out_s, out_i = [], []
    for b in range(q.shape[0]):
        chain = art["list_chain"][lists[b]]                 # (P, C)
        live = chain >= 0
        rows = torch.where(live, chain, 0).long()
        codes = art["list_codes"][rows]                     # (P, C, cap, D)
        ids = art["list_ids"][rows]
        s = pq_score_batched_ref(luts[b:b + 1], codes.reshape(
            -1, codes.shape[-1]))[0].reshape(ids.shape)
        if index.cfg.ivf_residual:
            s = s + probe_s[b][:, None, None]
        valid = (ids != INVALID_ID) & live[..., None]
        s = torch.where(valid, s, float("-inf"))
        ids = torch.where(valid, ids, INVALID_ID)
        ts, _, ti = topk_by_position(s.reshape(1, -1), ids.reshape(1, -1), k)
        out_s.append(ts)
        out_i.append(ti)
    return torch.cat(out_s), torch.cat(out_i)


def plain_scoring(index):
    """An index of ``index``'s config whose search scores the probed
    candidates by the plain version (each query's own probed rows
    gathered and summed in PyTorch, ``probed_scores_ref``) in place of
    ``pq_score_batched`` over the unique lists: the route the kernel's
    was kept over, timed beside it and held bit-identical to it."""
    from repro_torch.retrieval.ivf_pq import IVFPQ, probed_scores_ref

    class PlainScoring(IVFPQ):
        def _candidate_scores(self, luts, list_codes, chain):
            b = chain.shape[0]
            codes = list_codes[chain.reshape(b, -1)]   # (B, P·C, cap, D)
            return probed_scores_ref(luts, codes.reshape(
                b, -1, list_codes.shape[2]))

    return PlainScoring(index.cfg)


def timed_calls(fn, iters=IVF_ITERS):
    """``fn()`` once to warm, then ``iters`` times, each to the card's
    synchronise: (last result, p50 ms, p99 ms, calls made)."""
    import numpy as np
    import torch
    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return (out, float(np.percentile(times, 50)),
            float(np.percentile(times, 99)), iters + 1)


def same_topk(a, b) -> bool:
    import torch
    return (torch.equal(bits(a[0]), bits(b[0]))
            and torch.equal(a[1].to(b[1].device), b[1]))


def ivf_recall(ids, exact) -> float:
    import numpy as np
    ids = ids.cpu().numpy()
    return float(np.mean([np.isin(ids[b], exact[b]).mean()
                          for b in range(ids.shape[0])]))


def time_ivf_scoring(index, art, q) -> None:
    """``pq_score_batched`` at the IVF search's shape (the kernel route:
    the B queries' LUTs over the codes of every list they probe, U·cap
    rows): kernel, plain version and ``F.embedding_bag`` timed beside
    the bound, the kernel held bit-identical to the plain version."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.pq_score import (build_lut_batch,
                                              pq_score_batched,
                                              pq_score_batched_ref)
    _, lists = index._probe(art, q)
    chain, _ = index._expand_chain(art["list_chain"], lists)
    uniq = torch.unique(chain)
    codes = art["list_codes"][uniq].reshape(-1, art["list_codes"].shape[2])
    luts = build_lut_batch(q, art["centroids"]).contiguous()
    b, d, k = luts.shape
    n = codes.shape[0]
    need(torch.equal(bits(pq_score_batched(luts, codes)),
                     bits(pq_score_batched_ref(luts, codes))),
         "pq_score_batched == plain at the IVF search's shape")
    offs = (codes.long() + torch.arange(d, device=codes.device) * k
            ).contiguous()
    table = luts.permute(1, 2, 0).reshape(d * k, b).contiguous()
    ms, _ = time_ms(lambda: pq_score_batched(luts, codes), iters=20,
                    warmup=2)
    plain, _ = time_ms(lambda: pq_score_batched_ref(luts, codes), iters=3,
                       warmup=1, hold=False)
    lib, _ = time_ms(lambda: F.embedding_bag(offs, table, mode="sum"),
                     iters=20, warmup=2)
    nbytes = n * d + b * d * k * 4 + b * n * 4
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = b * n * d / F32_FLOP_PER_S * 1e3
    log(f"time pq_score_batched at the ivf search (nprobe="
        f"{index.cfg.nprobe}: {len(uniq)} unique lists) N={n} B={b} D={d} "
        f"K={k}: kernel {ms:.5f} ms, plain {plain:.5f} ms, library "
        f"{lib:.5f} ms (F.embedding_bag), bound {max(t_b, t_o):.5f} ms by "
        f"{'bytes' if t_b >= t_o else 'operations'} ({nbytes} bytes); "
        f"held bit-identical to the plain version")


def ivf_scale_phase() -> dict:
    """The JAX bench's retrieval scale on the card (IVF_* above): the
    streamed build from a host corpus, the nprobe sweep on the device and
    host-staged, both scoring routes at the widest probe; checks and
    gates as in the module docstring.  Returns the launches of its two
    counted runs (the build, the searches)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.data.synthetic import pq_clustered_corpus
    from repro_torch.kernels.pq_score import INVALID_ID
    from repro_torch.launch.engine import RetrievalEngine
    from repro_torch.retrieval import (IndexConfig, build_ivf_artifact,
                                       get_index, suggest_nlist)

    t_phase = time.perf_counter()
    n, k, b = IVF_ROWS, TOPK, TT_QUERIES
    t0 = time.perf_counter()
    vecs, q_np = pq_clustered_corpus(
        n=n, d=IVF_DIM, num_subspaces=IVF_SUB, n_queries=b,
        n_clusters=min(2048, suggest_nlist(n)), cluster_zipf_a=1.3)
    gen_s = time.perf_counter() - t0
    nlist = suggest_nlist(n, max(IVF_NPROBES))
    cfg = IndexConfig(kind="ivf_pq", num_subspaces=IVF_SUB,
                      num_centroids=IVF_K, iters=10, coarse_iters=10,
                      nlist=nlist, nprobe=max(IVF_NPROBES),
                      train_sample=min(n, IVF_BLOCK),
                      encode_block=min(n, IVF_BLOCK), list_cap_quantile=0.9)
    log(f"ivf scale: corpus {n} x {IVF_DIM} f32 on the host "
        f"({vecs.nbytes / 1e6:.1f} MB, generated in {gen_s:.1f}s), "
        f"{b} queries; nlist={nlist} D={IVF_SUB} K={IVF_K} "
        f"train_sample={cfg.train_sample} encode_block={cfg.encode_block} "
        f"list_cap_quantile={cfg.list_cap_quantile}")

    # the build: counts set to 0 just before, read just after
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counts()
    art_host, stats = build_ivf_artifact(
        torch.Generator(device="cuda").manual_seed(0), vecs, cfg)
    build_launches = {name: fn.launches for name, fn in counters.items()}
    build_peak = torch.cuda.max_memory_allocated() - base
    st = stats
    split = ", ".join(f"{step} {sec:.3f}s"
                      for step, sec in st.step_seconds.items())
    log(f"ivf scale build: {st.seconds:.3f}s in {st.blocks} blocks of "
        f"{st.block_rows} (sample {st.sample_rows}): {split}; peak device "
        f"bytes {st.peak_device_bytes} ({st.peak_device_bytes / 1e6:.1f} MB)"
        f" vs bound {st.device_bound_bytes} "
        f"({st.device_bound_bytes / 1e6:.1f} MB) -> "
        f"{'OK' if st.peak_device_ok else 'BLOWN'}; allocator peak over "
        f"the build {build_peak / 1e6:.1f} MB; launches {build_launches}")
    layout_mb = (art_host["list_codes"].numel()
                 * art_host["list_codes"].element_size()
                 + 4 * art_host["list_ids"].numel()) / 1e6
    padded_mb = nlist * st.list_count_max * (IVF_SUB + 4) / 1e6
    ideal_mb = n * (IVF_SUB + 4) / 1e6
    log(f"ivf scale layout: lists max {st.list_count_max} mean "
        f"{st.list_count_mean:.1f}, cap {st.list_cap} (q=0.9), chain <= "
        f"{st.max_chain}, {st.lists_ext} ext lists -> {layout_mb:.1f} MB "
        f"(pad-to-max {padded_mb:.1f} MB, ideal {ideal_mb:.1f} MB)")
    need(st.peak_device_ok, "ivf build peak device bytes within the bound")
    need(build_launches["dpq_assign"] == st.blocks == -(-n // IVF_BLOCK),
         f"the build launched dpq_assign once a block "
         f"({build_launches['dpq_assign']} of {st.blocks})")
    need(all(v == 0 for name, v in build_launches.items()
             if name != "dpq_assign"), "no other kernel in the build")

    art = {name: leaf.cuda() for name, leaf in art_host.items()}
    q = torch.from_numpy(q_np).cuda()
    # the exact dense scan, and the build's codes against the plain
    # assignment (as phase 3 holds dpq_assign)
    vecs_dev = torch.from_numpy(vecs).cuda()
    exact = torch.topk(q @ vecs_dev.T, k, dim=1).indices.cpu().numpy()
    e_all = vecs_dev.reshape(n, IVF_SUB, IVF_DIM // IVF_SUB)
    cent = art["centroids"]
    ids_flat = art["list_ids"].reshape(-1)
    valid = ids_flat != INVALID_ID
    need(int(valid.sum()) == n, "every corpus row in one list slot")
    codes_row = torch.zeros((n, IVF_SUB), dtype=torch.uint8,
                            device=cent.device)
    codes_row[ids_flat[valid].long()] = art["list_codes"].reshape(
        -1, IVF_SUB)[valid]
    want = blocked_assign_ref_lim(e_all, cent, None)
    gap = assign_gap(e_all, cent, None, codes_row, want)
    agree = int((codes_row.long() == want.long()).sum())
    log(f"ivf scale check dpq_assign B={n} D={IVF_SUB} K={IVF_K} "
        f"S={IVF_DIM // IVF_SUB}: the layout's codes against the plain "
        f"assignment, {agree} of {codes_row.numel()} equal, largest "
        f"distance gap {gap:.3g} (tolerance {ASSIGN_TOL})")
    need(gap <= ASSIGN_TOL, f"ivf codes within {ASSIGN_TOL} of the plain "
         f"assignment")
    assign_t = time_assign_pass("ivf scale build", e_all, cent, None,
                                IVF_BLOCK)
    del vecs_dev, e_all, want, codes_row
    torch.cuda.empty_cache()

    # the searches: counts set to 0 just before, read just after
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counts()
    searches = 0
    sweep, outs = {}, {}
    for p in IVF_NPROBES:
        idx = get_index(dataclasses.replace(cfg, nprobe=p))
        out, p50, p99, calls = timed_calls(lambda: idx.search(art, q, k))
        searches += calls
        outs[p] = out
        per_query = p * st.max_chain * st.list_cap
        sweep[p] = {"recall": ivf_recall(out[1], exact), "p50": p50,
                    "p99": p99, "candidates": per_query}
        if p == max(IVF_NPROBES):
            plain = plain_scoring(idx)
            other, o50, o99, _ = timed_calls(lambda: plain.search(art, q, k))
            need(same_topk(other, out), f"the plain scoring's search == "
                 f"the kernel's at nprobe={p}")
            sweep[p]["plain"] = (o50, o99)
    device_peak = torch.cuda.max_memory_allocated() - base
    staged = {}
    for p in IVF_NPROBES:
        pcfg = dataclasses.replace(cfg, nprobe=p, host_staged=True)
        eng = RetrievalEngine(get_index(pcfg), art_host, k=k, block_q=b)
        got, p50, p99, calls = timed_calls(lambda: eng.search(q_np))
        searches += calls
        need(same_topk(got, outs[p]), f"host-staged == device search at "
             f"nprobe={p}")
        staged[p] = {"p50": p50, "p99": p99,
                     "mb": eng.staged_mbytes / calls,
                     "host_ms": eng.index.stage_seconds * 1e3 / calls}
        if p == max(IVF_NPROBES):
            staged_eng = eng
    launches = {name: fn.launches for name, fn in counters.items()}
    need(launches["pq_score_batched"] == searches,
         f"one pq_score_batched a search "
         f"({launches['pq_score_batched']} of {searches})")
    need(all(v == 0 for name, v in launches.items()
             if name != "pq_score_batched"), "no other kernel in a search")
    for p in IVF_NPROBES:
        s = sweep[p]
        extra = ("" if "plain" not in s else
                 f"; plain scoring p50 {s['plain'][0]:.3f} ms p99 "
                 f"{s['plain'][1]:.3f} ms")
        log(f"ivf scale nprobe={p:>4}: recall@{k} {s['recall']:.3f} | "
            f"device p50 {s['p50']:.3f} ms p99 {s['p99']:.3f} ms"
            f"{extra} | host-staged p50 {staged[p]['p50']:.3f} ms p99 "
            f"{staged[p]['p99']:.3f} ms, {staged[p]['mb']:.2f} MB a flush, "
            f"host split {staged[p]['host_ms']:.3f} ms | "
            f"{s['candidates']} candidate slots a query")
    best = max(s["recall"] for s in sweep.values())
    art_mb = sum(t.numel() * t.element_size() for t in art.values()) / 1e6
    log(f"ivf scale: search launches {launches}; peak device memory of "
        f"the device searches {device_peak / 1e6:.1f} MB above the "
        f"artifact's {art_mb:.1f} MB")
    need(best >= IVF_RECALL, f"recall@{k} >= {IVF_RECALL} at some swept "
         f"nprobe (best {best:.3f})")

    # every search bit-identical to the plain per-query scoring
    for p in IVF_NPROBES:
        idx = get_index(dataclasses.replace(cfg, nprobe=p))
        need(same_topk(ivf_plain_search(idx, art, q, k), outs[p]),
             f"search == plain per-query scoring at nprobe={p}")
    log(f"ivf scale checks: every search bit-identical to the plain "
        f"per-query scoring, host-staged to device, the plain scoring's "
        f"search at nprobe={max(IVF_NPROBES)} to the kernel's")
    idx = get_index(cfg)
    time_ivf_scoring(idx, art, q)
    profile_phase(f"ivf device search nprobe={cfg.nprobe}",
                  lambda: idx.search(art, q, k))
    profile_phase(f"ivf host-staged flush nprobe={cfg.nprobe}",
                  lambda: staged_eng.search(q_np))
    log(f"ivf scale phase {time.perf_counter() - t_phase:.1f}s; dpq_assign "
        f"per launch {assign_t['ms']:.5f} ms (bound "
        f"{assign_t['bound_ms']:.5f} ms by {assign_t['bound_by']})")
    del art, art_host, staged_eng, outs
    gc.collect()
    torch.cuda.empty_cache()
    return {name: build_launches[name] + launches[name]
            for name in launches}


def two_tower_ivf_path(flat_qps: float) -> dict:
    """Two-tower's CONFIG through ``serve_retrieval(index_kind="ivf_pq",
    nprobe=TT_IVF_NPROBE, host_staged=True)`` over the retrieval
    corpus: counts set to 0 just before and read just after; recall and
    queries/s beside phase 12's flat_pq; every flush bit-identical to the
    device search of the same queries.  Returns the launches."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serve_retrieval

    _, cfg = get_arch("two-tower-retrieval", smoke=False)
    n_cand = retrieval_candidates()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counts()
    t0 = time.perf_counter()
    run = serve_retrieval(cfg, n_cand, index_kind="ivf_pq",
                          nprobe=TT_IVF_NPROBE, topk=TOPK, host_staged=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    st = run.stats
    log(f"two-tower ivf_pq ({run.index.describe()}, host-staged): "
        f"{wall:.1f}s (index build {run.build_seconds:.3f}s); engine "
        f"{st.requests} requests / {st.lookups} queries in {st.flushes} "
        f"flushes, {st.seconds:.6f}s -> {st.lookups_per_s:,.1f} queries/s "
        f"(flat_pq, phase 12: {flat_qps:,.1f}); staged "
        f"{run.engine.staged_mbytes:.2f} MB over {2 * st.flushes} flushes; "
        f"recall@{TOPK} vs the dense scan {run.recall:.3f} (random towers;"
        f" reported, not gated); launches {launches}; peak device memory "
        f"{peak / 2**30:.2f} GiB")
    need(st.requests == 50, "every ivf retrieval request served")
    need(launches["dpq_assign"] == 1, "the IVF index's one encode launch")
    checked = 0
    for flat, res in drive_keeping_flushes(run.engine, run.requests):
        pad = (-flat.shape[0]) % run.engine.pad_multiple
        qd = torch.from_numpy(np.pad(flat, ((0, pad), (0, 0)))).cuda()
        s, i = run.index.search(run.artifact, qd, TOPK)
        got = (torch.cat([sc for sc, _ in res]),
               torch.cat([ix for _, ix in res]))
        need(same_topk(got, (s[:flat.shape[0]], i[:flat.shape[0]])),
             "host-staged flush == device search")
        checked += flat.shape[0]
    log(f"two-tower ivf checks: {checked} queries' host-staged results "
        f"bit-identical to the device search")
    # the last flush's queries, device search, scored by the kernel and
    # by the plain version
    for what, index in (("pq_score_batched", run.index),
                        ("plain", plain_scoring(run.index))):
        _, p50, p99, _ = timed_calls(
            lambda: index.search(run.artifact, qd, TOPK), iters=5)
        log(f"two-tower ivf device search of {qd.shape[0]} queries, "
            f"scoring {what}: p50 {p50:.3f} ms p99 {p99:.3f} ms")
    profile_phase("two-tower ivf host-staged pass",
                  lambda: run.engine.serve_stream(run.requests))
    del run
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(REPO, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    if sys.argv[1:] == [DETERMINISTIC_FLAG]:
        return deterministic_resume()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build_kernels()
    errs = check_kernels()
    small_table_against_cpu()
    launches, _ = main_path()
    kernels = time_kernels(errs, launches)
    gc.collect()
    torch.cuda.empty_cache()
    c_launches, c_errs, flush_b = compressed_paths()
    kernels += time_decode_kernels(
        {name: max(errs[name], c_errs[name])
         for name in ("rq_decode_stages", "packed_decode")},
        c_launches, flush_b)
    h_launches = hot_cache_phase(card)
    bag_launches, bag_err, bag_times = bag_phase()
    ctr_launches = [ctr_serve_path(arch) for arch in CTR_ARCHS]
    ctr_launches += [ctr_train_path(arch) for arch in CTR_ARCHS]
    ctr_launches.append(two_tower_train_path())
    for arch in CTR_ARCHS + ("two-tower-retrieval",):
        train_card_vs_cpu(arch)
    resume_checks()
    time_ctr_kernels()
    b_launches, bb_gap = backbone_path()
    t = bag_times[(BAG_SHAPES[0][1], torch.float32, True, "uniform")]
    kernels.append({"name": "embedding_bag", "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
                    "replaces": "src/repro/kernels/embedding_bag/"
                                "embedding_bag.py:53",
                    "launches": 0, "max_abs_err": bag_err, **t})
    gc.collect()
    torch.cuda.empty_cache()
    flash_err = check_flash()
    lm_assign_gap = check_lm_assign()
    l_launches = lm_path()
    kernels.append(time_flash(flash_err, l_launches))
    gc.collect()
    torch.cuda.empty_cache()
    lm27_gap = lm27_export_check()
    gc.collect()
    torch.cuda.empty_cache()                 # free the card for two-tower
    r_launches, r_errs, (luts, codes), flat_qps = retrieval_path()
    pq_errs = {name: max(errs[name], err) for name, err in r_errs.items()}
    kernels += time_pq_kernels(pq_errs, r_launches, luts, codes)
    del luts, codes
    gc.collect()
    torch.cuda.empty_cache()
    t_ivf = time.perf_counter()
    i_launches = [ivf_scale_phase(), two_tower_ivf_path(flat_qps)]
    log(f"ivf phase {time.perf_counter() - t_ivf:.1f}s")
    for entry in kernels:                    # every path's launches
        name = entry["name"]
        entry["launches"] = sum(p.get(name, 0) for p in
                                (launches, c_launches, h_launches,
                                 bag_launches, *ctr_launches,
                                 b_launches, l_launches, r_launches,
                                 *i_launches))
        if name == "dpq_assign":
            entry["max_abs_err"] = max(entry["max_abs_err"], pq_errs[name],
                                       c_errs[name], lm_assign_gap,
                                       lm27_gap, bb_gap)
    log(f"total {time.perf_counter() - t0:.1f}s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
