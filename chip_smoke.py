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
   not depend on the batch).  Then the distributed-serving phase
   (``sharded_serving_phase``): the same field exported as mgqe, rq
   and mpe, two-tower's 1M-item flat_pq (D=8, K=64, d=256) and the 1M
   IVF index of phase 16, each served once on one device for the
   reference results and saved to the host; 4 gloo ranks on cuda:0 as
   a (data=2, model=2) mesh (``launch.mesh.spawn``), each placing only
   its row block (its device holding 1/2 of the code or corpus bytes
   plus the replicated codebooks, read from ``memory_allocated``) and
   serving 200 requests through ``ServingEngine(mesh)``, uncached and
   behind a 1,250,000-row hot block (a wholly cached flush launching
   no decode; mgqe also refreshed), and batches of 464 and 465 through
   ``RetrievalEngine(mesh)``: every flush and top-k bit-identical to
   the single-device results on every rank, ``mgqe_decode``,
   ``rq_decode_stages``, ``packed_decode``, ``pq_topk`` and
   ``pq_score_batched`` launched on every rank, flush and search ms
   beside the single device's and the wire bytes a flush; one NCCL rank
   through ``ServingEngine`` on a (1, 1) mesh (bit-identical; queued,
   run in the LM mesh phase's one NCCL process), and ``serve --mesh
   data=2,model=2`` under torchrun on 4 gloo ranks sharing the card
   (the smoke config), exit 0.  Then the distributed-training phase
   (``sharded_training_phase``): deepfm's ``CONFIG`` (all 78 tables
   row-sharded) trained 5 adagrad steps at B = 4,096 through the train
   cell (``launch/cells.py::recsys_train_cell``) on 4 gloo ranks on
   cuda:0 as a (data=2, model=2) mesh, each rank taking its data shard
   of the global batches, held to 5 one-device steps on the same
   batches (losses and every gradient adagrad consumed within MT_TOL
   at the rows the batches read, every other row's gradient exactly
   0, params within their float64 adagrad replay's bars); replicated
   leaves bit-identical on every rank after each step, row blocks on
   every rank of their model index; ``compressed_psum_mean`` over the
   replicated gradient shares on the data axis each step (its
   relative error printed; it feeds no update); a checkpoint of whole
   arrays at step 3, resumed on the same mesh (bit for bit), on a
   (1, 4) mesh of the same ranks and on one device (steps 4-5 within
   the bars of the uninterrupted run); the trained tables of the 21
   mgqe fields gathered, exported (``dpq_assign``) and served through
   ``ServingEngine(mesh)`` (``mgqe_decode``), every flush bit-identical
   to a one-device engine's on the same artifact; two-tower at its
   widths, users and items cut to 2M, 3 steps on the mesh: losses and
   the towers' first-step gradients within MT_TOL of one device (a
   planted per-rank softmax must move the loss); deepfm's ``CONFIG``
   on one NCCL rank, bit-identical to one device (queued as above);
   and ``train --mesh data=2,model=2`` under torchrun (the smoke
   config), exit 0; per-rank device bytes,
   step ms beside one device's and the wire bytes a step printed;
   counts set to 0 just before, read just after;
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
   uninterrupted one (DeepFM, AutoInt; bit for bit under the default
   algorithms), once more in a child process
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
11. the LM phases: ``flash_attention`` against its plain version in
   float32 (CUDA cores) and bfloat16 (tensor cores) at gemma3-4b's local
   (window 1,024) and global layer shapes (B=2, S=4,096, 8 query heads
   over 4 KV heads, hd=320), gemma3-27b's (B=1, S=4,096, 32 heads over
   16, hd=168), qwen3-moe-30b-a3b's (B=2, S=4,096, 32 heads over 4,
   hd=64), mixtral-8x7b's (B=1, S=8,192, 32 heads over 8, hd=128,
   window 4,096), stablelm-3b's (B=1, S=2,048, 32 heads, hd=80), a
   mesh rank's of 13 (B=1, S=4,096: stablelm-3b's 16 of 32 heads,
   qwen3's 16 over 2 of 4 KV heads), the JAX tests' shapes and an odd length (bars: ``FLASH_TOL``; bf16 also per
   row against the plain version in float32, ``FLASH_BF16_ROW_TOL``,
   which two planted faults must fail); ``dpq_assign`` at the LM token
   tables' widths (D=8, S=256, 320, 512 and 672, K=256 and 64, float32
   and bfloat16) against the plain assignment; then, one phase an arch
   (``LM_PATHS``), each freeing the card after it, the arch's ``CONFIG``
   through ``launch.serve.serve_lm``: gemma3-4b (f32 weights), then in
   bfloat16 qwen3-moe-30b-a3b (24 of 48 layers, 128 experts top-8,
   through ``nn/moe.py``), gemma3-27b (32 of 62 layers, 5:1
   local:global) at 2 prompts of 4,096 tokens, and mixtral-8x7b (8
   experts top-2, window 4,096) cut to 16 of its 32 layers (87.0 GiB of
   weights do not fit the card) at 1 prompt of 8,192 — init, MGQE
   export of the token table (``dpq_assign``), prefill
   (``flash_attention`` on every layer, ``mgqe_decode``), 8 greedy
   decode steps — with the counts set to 0
   just before and read just after; the token rows held bit-identical
   to the plain decode, the exported codes of a head, a tier-boundary
   and a tail slice to the plain assignment, the last-token logits to
   the same prefill on the plain route with its attention in f32 (the
   attention's plain version called one KV-head group at a time, so it
   fits beside the weights), and each prefill layer, fed that route's
   input, to it (``LM_BARS``: a planted fault, the window one KV tile
   short, or qwen3's MoE gate left unnormalised, must fail), the MoE
   route flips between the routes counted, prefill and decode beside
   their bounds and peak memory printed, the export's ``dpq_assign``
   launches timed on the served table, the prefill and one decode step
   profiled;
12. LM training (``lm_train_phases``), each phase freeing the card
   after it: ``attend`` at stablelm-3b's training layer shape (2 x
   4,096), qwen3's and gemma3-4b's local layer: its forward, the
   kernel, against the plain version (``FLASH_TOL`` and the per-row
   ``FLASH_BF16_ROW_TOL``; a dropped KV tile must fail), and its
   backward (the recompute through the plain version a group of KV
   heads at a time) against autograd through the plain version
   (bit-identical where the recompute is whole, else within
   ``ATTN_BWD_TOL``; the recompute at the other kind of layer's window
   must fail); stablelm-3b's first-step loss at
   2 x 4,096 on the kernel route against the plain version's
   (``LM_STEP_LOSS_TOL``; every layer at a 1,024-key window must fail);
   stablelm-3b's ``CONFIG`` (f32 params, bf16 activations, layer remat,
   MGQE token table) trained 5 adamw steps through
   ``launch.train.train`` at train_4k's sequence, 2 sequences a step
   (train_4k's global batch of 256 cut to what the card holds), the
   counts set to 0 just before and read just after (2
   ``flash_attention`` launches a layer a step): step time and
   tokens/s beside the FLOP bound, peak memory, losses; one more step
   profiled, its device time split by profiler ranges into attention's
   plain recompute, the chunked xent (forward and backward) and the
   optimizer (the first two also timed alone as a cross-check); the
   trained table exported (``dpq_assign``) and
   served through ``launch.serve.serve_lm`` (a prefill of 1 x 4,096 and
   8 decode steps, ``mgqe_decode``), counted likewise, rows and codes
   held as in 11 (the initial table's export must fail the codes'
   bar); qwen3-moe-30b-a3b at full width, bf16 params, 4 of its 48
   layers, trained 3 steps at 1 x 4,096 with the same prints; the five
   LM archs' smoke configs on the chunked route with layer remat on
   the card against the CPU (first-batch gradients within
   ``TRAIN_PARAM_TOL``, 5 steps' losses within ``TRAIN_LOSS_RTOL``; the
   recompute at a wrong window must fail); a resumed stablelm-3b run
   at full width (4 layers) and a resumed qwen3 smoke run against
   uninterrupted ones, bit for bit (a resume on the wrong batches must
   differ); then ``flash_attention``, its plain version and
   ``F.scaled_dot_product_attention`` timed at every layer shape of the
   LM prefills and of training (13's included), the entry holding the
   mean per launch;
13. the LM mesh phase (``lm_mesh_phase``), after 12 and before its
   attention timing: one device's references on the card, then one
   NCCL rank and 4 gloo ranks on cuda:0 as a (data=2, model=2) mesh
   (``launch.mesh.spawn``) and 3 as a (1, 3) mesh; counts set to 0
   just before the ranks and read just after, summed over them.
   ``launch/cells.py::lm_train_cell`` trains, each rank with its heads
   (tensor parallel over model), its data shard and ZeRO-1 moments:
   stablelm-3b's ``CONFIG`` with FSDP (f32 params, bf16 activations,
   layer remat) at 2 x train_4k's sequence, one a data rank, cut to
   ``LMM_LAYERS`` of 32 layers (4 ranks at 32 overflowed the card):
   a step and a traced one (the collectives counted and timed with the
   device synchronised around each), state bytes and peak a rank, the
   first loss within ``LMM_BF16_LOSS_TOL`` of one device's, the trained
   token table gathered over model, exported (``dpq_assign``) and
   served (``mgqe_decode``) on rank 0, codes and rows held to the
   plain versions; float32 checks at a depth cut (stablelm-3b and
   qwen3 at 1 layer, qwen3 at a capacity where nothing drops, found from
   one device's routing) against one device: loss and ``LMM_SAMPLES``
   gradient elements a leaf within 1e-5, stablelm-3b's params after
   one adamw step too (elements of first-step |g| < 1e-6 within 2 lr);
   qwen3-moe-30b-a3b's ``CONFIG`` (bf16) at ``QW_LAYERS`` of 48 with
   ``moe_shard_map`` (128 experts over model = 2: the expert strategy,
   all-to-all over model) two steps, the share of (token, choice) pairs
   dropped at capacity 1.25 from one device's ``moe_ffn_grouped``;
   ``train`` on the mesh failed in step 2 and resumed from its
   checkpoint of whole arrays (stablelm-3b at 1 layer), bit-identical
   to an uninterrupted run; stablelm-3b's float32 check's step on one
   NCCL rank bit-identical to one device (in one NCCL process with the
   distributed phases' queued checks); the traced steps' collectives
   held to the dry run (``dry_check``: ``chip_smoke.py --dry-run``, a
   child process started with the script, counts each mesh phase's
   cells on an ``AbstractMesh`` of (2, 2) on the meta device through
   ``launch/dryrun.py``); and one qwen3 MoE layer at full width
   on (1, 3) (128 experts % 3: the ffn strategy, d_ff over model) at
   4,096 tokens, forward and backward within 1e-5 (gradients at each
   leaf's scale) of one device's ``moe_ffn``; every rank's
   ``flash_attention`` launches counted (the mesh-rank shapes also
   checked in 11: stablelm-3b's 16 of 32 heads, qwen3's 16 over 2 of 4
   KV heads); every number beside the card's name and power limit;
   then the LM serving mesh phase (``lm_serve_mesh_phase``): the token
   tables of gemma3-4b and qwen3-moe-30b-a3b exported once on the card
   (``dpq_assign``), one device's references in this process, then 4
   gloo ranks on cuda:0 as a (data=2, model=2) mesh and 8 as a (1, 8)
   mesh, each serving through ``launch/cells.py::lm_prefill_cell`` and
   ``lm_decode_cell`` (its params placed by ``lm_param_rules`` as they
   are drawn, its block of the codes, ``mgqe_decode``, and of the KV
   cache by ``lm_cache_spec``; ``flash_attention`` on its heads); the
   counts set to 0 just before the export and read after the ranks:
   (a) gemma3-4b's ``CONFIG`` (34 layers, f32 params, bf16
   activations) prefilling 2 x 4,096 and 8 decode steps fed one
   device's tokens, every step's logits within ``LM_BARS`` of one
   device's (and the top-1 rule), prefill seconds, decode tokens/s,
   bytes a rank and one traced decode step's collectives (2 a layer,
   the gather's 2, the logits' 1); (b) float32 at 7 layers, 1,100
   tokens (past the local window), split cache off and on, on (2, 2)
   and on (1, 8) (4 kv heads over 8: the cache's sequence over model,
   the blocks' attention merged), logits within 1e-4 of one device and
   greedy tokens identical (4 steps), the merge without its pmax
   planted on (1,
   8) and failing; (c) qwen3-moe-30b-a3b's ``CONFIG`` at 4 of 48
   layers (the global MoE formulation, experts over model) at 2 x
   1,024 and 8 steps within ``LM_BARS`` of one device with its experts
   pinned to the mesh's routes, the share of the mesh's routes that
   one device does not choose within ``LMS_FLIP_BAR`` (one device's
   routes of the other prompt planted and failing), the share of
   (token, choice) pairs dropped; (d) ``decode_32k`` through
   ``lm_decode_cell``, its global batch of 128 cut to 4, a 22.8 GB
   cache drawn from seeded generators (positions 0..32,759), 3 steps
   timed beside their bytes bound and held to one device's steps on
   the same cache within ``LM_BARS`` (beside one device's distance to
   its steps with the decode attention in float32), and a fourth step
   with one rank's cache rows swapped planted and failing it; (e)
   ``long_500k`` through ``build_cell(..., opts=("split_cache",))``:
   gemma3-4b's ``CONFIG`` at float32 activations, B = 1 over 524,288
   slots (the token on every rank, the five global layers' 26.8 GB
   cache split over data, kv heads over model), drawn chunk by chunk
   from seeded generators (``long_fill_cache``), 3 steps held to one
   device's on the same cache within ``LMS_CHECK_TOL`` (float32) with
   identical tokens, and a fourth with the two halves of one rank's
   key block swapped planted and failing; (a)'s and (e)'s counted
   decode steps held to the dry run (``dry_check``);
14. the GNN phase (``gnn_phases``), freeing the card after it: MACE's
   ``configs/mace.py::CONFIG`` (2 layers, d_hidden 128, l_max 2,
   correlation order 3) trained GNN_STEPS adam steps through
   ``train.fit`` on three of ``GNN_SHAPES`` — molecule (128 molecules
   of 30 atoms and 64 edges, energy), full_graph_sm (a Cora-sized
   ``random_graph``, d_feat 1,433, every node labelled) and
   minibatch_lg (``NeighborSampler`` batches of 1,024 seeds at fanout
   (15, 10) over a 232,965-node, 114,615,892-edge host graph, the loss
   masked to the seeds; the host graph built in a child process
   started with the script, beside the earlier phases); ogb_products
   does not fit one card (one (E, C, 9) f32 edge tensor is 285 GB) —
   each with step ms beside
   the FLOP bound, peak memory, finite losses and the sampler's host
   ms, molecule's and minibatch_lg's step once more profiled and split
   by profiler ranges (``GNN_SPANS``); then ``launch.train``'s CLI
   with ``--arch mace --full``; every kernel's count set to 0 just
   before the shapes and read after the CLI, 0 launches required (no
   Pallas function lies on MACE's path in the JAX package); the smoke
   config on the card against the CPU (gradients within
   ``TRAIN_PARAM_TOL``, losses within ``TRAIN_LOSS_RTOL``); E(3) at
   ``CONFIG`` on a graph padded with self-loops (rotation, translation,
   permutation; the edge mask planted away must fail the rotation); a
   step run twice bit for bit (molecule, full_graph_sm), the receiver
   sum and the gather's backward against ``index_add_`` at
   minibatch_lg's scale, and a ``--full`` run failed at step 3 and
   resumed, bit for bit (a resume on the wrong batches must differ);
15. the cells mesh phase (``cells_mesh_phase``): one device's
   references in this process — each recsys ``CONFIG``'s params from
   seed 0 (two-tower's users and items cut to ``CM_TT_ROWS``), a CTR
   model's artifacts exported once (``dpq_assign``), the serve_p99
   (B = 512) and serve_bulk (B = 262,144) logits and each data shard's
   decoded rows, the retrieval_cand scores (``CM_CAND``: two-tower and
   deepfm at 1,000,000 candidates, autoint's and bst's cut), MACE's
   ``CONFIG`` stepped once on molecule, full_graph_sm and the GNN
   phase's minibatch_lg sample (each step's gradients before the clip
   kept; minibatch_lg's loss and gradients also in float64) — then 4
   gloo ranks on cuda:0 as a (data=2, model=2) mesh (``cm_rank``):
   ``recsys_serve_cell`` (rows bit-identical, logits within
   ``CM_TOL``; ``mgqe_decode`` launched on every rank),
   ``recsys_retrieval_cell`` (scores within ``CM_TOL``, two-tower's
   top-100 ids identical, ``pq_score`` launched on every rank) and
   ``mace_cell`` (the metrics within ``CM_TOL``, the reduced gradients
   before the clip within ``CM_TOL`` of each leaf's largest, the params
   after one adam step within the adam bars and moved; minibatch_lg's
   float32 step a no-op on both sides, ``CM_NOOP_STEP``, so its params
   unchanged, its float32 loss within ``CM_TOL`` relative plus
   ``CM_NOISE_RULE`` times one device's float32 rounding, and its
   float64 loss and reduced gradients within ``CM_TOL``); each with ms
   a flush or step on the mesh and one device, its collectives (count,
   bytes a rank) and bytes a rank; planted: a rank serving the next
   rank's code blocks, a receiver sum keeping the next rank's node
   block and a padded node in graph 0's energy must fail; each
   counted flush, retrieval call and step's collectives (count, kinds,
   bytes a rank) equal to the dry run's (minibatch_lg's at its
   sample's sizes, its static shape's printed), each beside its three
   roofline terms; counts set to 0 just before the export and read
   after the ranks, summed;
16. free the card and drive the retrieval path at full width:
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
17. time the pq kernels at that path's shapes, as in 5,
   ``pq_score_batched`` also at a ragged B = 465, and ``pq_topk`` also
   on its worst case (scores rising with the id, held to the exact
   answer) and beside ``torch.topk(pq_score_batched(...))``, the two
   calls it fuses;
18. the retrieval-scale phase: ``ivf_pq`` at the JAX bench's
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
   (reported), queries/s beside phase 16's flat_pq, every flush
   bit-identical to the device search;
19. print one ``{"kernels": [...]}`` JSON line (launches summed over
   every path), then, last, the ``{"ok": true, "device": ...}`` line.

It needs one card and no arguments, imports nothing of JAX, and runs
the port from the ``src/`` directory beside this file.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import math
import os
import subprocess
import sys
import time

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
HOT_PASSES = 2                         # measured passes, the best kept
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
IVF_ITERS = 15
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
# --full``.  At 400 steps FE had not yet left MGQE's plateau (its gap
# opens after about step 500), so every verdict here reads TRACKS; the
# 400 steps' 61.3 s of training are cut to 50 for the script's time.
BB_STEPS = 50
BB_EVAL = 500                          # HR@10's users
BB_CHECK_STEPS = 10                    # the tiny card-vs-CPU runs
BB_PROFILE_STEPS = 20                  # an MGQE run's steps under the profiler
BB_SUBSPACES = (16, 8, 4)

# the LM phases: each arch's CONFIG served through serve_lm, LM_STEPS
# greedy decode steps after the prefill; gemma3-4b's prefill is also
# mgqe_decode's LM shape (LM_ARCH, LM_BATCH x LM_PROMPT)
LM_ARCH = "gemma3-4b"
LM_BATCH, LM_PROMPT, LM_STEPS = 2, 4096, 8
# (arch, prompts, prompt length, layers kept: None for the config's).
# mixtral-8x7b's 32 layers hold 87.0 GiB of bf16 weights, more than the
# card's 80 GB (26 layers, 70.8 GiB, fit: 74.9 GiB peak, H100 SXM); on
# one prompt past its 4,096 window, so the window bites in the flash
# kernel and the decode cache is a 4,096-slot ring that wraps.  For the
# script's time, qwen3-moe-30b-a3b runs 24 of its 48 layers, gemma3-27b
# 32 of 62 (five 5:1 groups and two remainder layers) and mixtral 16
# (the phases took 28.8, 35.1 and 24.4 s at 48, 62 and 26)
LM_PATHS = (
    (LM_ARCH, LM_BATCH, LM_PROMPT, None),
    ("qwen3-moe-30b-a3b", 2, 4096, 24),
    ("gemma3-27b", 2, 4096, 32),
    ("mixtral-8x7b", 1, 8192, 16),
)
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
# a multiple of the tensor cores' k-depth of 16), qwen3-moe-30b-a3b's
# (hd 64, 32 heads over 4), mixtral-8x7b's (hd 128, window 4,096 of an
# 8,192-token prompt), stablelm-3b's, a rank's heads on the LM mesh
# phase's (data=2, model=2) mesh (stablelm-3b's 16 of 32, qwen3's 16 of
# 32 over 2 of 4 KV heads), the JAX tests' shapes
# (tests/test_kernels.py: cross-length, a window wider than a tile) and
# an odd length
FLASH_CASES = (
    ("gemma3-4b local", 2, 4096, 4096, 8, 4, 320, 1024),
    ("gemma3-4b global", 2, 4096, 4096, 8, 4, 320, FULL_WINDOW),
    ("gemma3-27b local", 1, 4096, 4096, 32, 16, 168, 1024),
    ("gemma3-27b global", 1, 4096, 4096, 32, 16, 168, FULL_WINDOW),
    ("qwen3-moe-30b-a3b", 2, 4096, 4096, 32, 4, 64, FULL_WINDOW),
    ("mixtral-8x7b", 1, 8192, 8192, 32, 8, 128, 4096),
    ("stablelm-3b", 1, 2048, 2048, 32, 32, 80, FULL_WINDOW),
    ("stablelm-3b mesh rank", 1, 4096, 4096, 16, 16, 80, FULL_WINDOW),
    ("qwen3 mesh rank", 1, 4096, 4096, 16, 2, 64, FULL_WINDOW),
    ("gemma3-4b serving mesh rank local", 1, 4096, 4096, 4, 2, 320, 1024),
    ("gemma3-4b serving mesh rank global", 1, 4096, 4096, 4, 2, 320,
     FULL_WINDOW),
    ("gemma3-4b (1, 8) rank", 2, 1100, 1100, 1, 1, 320, 1024),
    ("jax gqa", 2, 256, 256, 4, 2, 64, FULL_WINDOW),
    ("jax window", 1, 128, 128, 4, 4, 32, 64),
    ("jax cross-length", 2, 128, 384, 8, 2, 64, FULL_WINDOW),
    ("jax window > tile", 1, 256, 256, 2, 1, 128, 300),
    ("odd length", 1, 1500, 1500, 8, 4, 320, 1024),
)
# The LM checks' bars, per arch: (LM_LOGIT_TOL, LM_LAYER_TOL, whether
# the planted fault must fail the logits bar too).  Readings: H100 SXM,
# 700 W; sound / the planted fault on the first layer it reaches, on
# every layer it reaches.
#
# LM_LOGIT_TOL: the last-token prefill logits' max |diff| from the same
# prefill on the plain route with its attention in f32 on the same bf16
# inputs (the kernel's scores are f32 too; bf16 activations through
# every layer), an MoE arch's with its experts pinned to the kernel
# route's (a route flip on the last token's path moved mixtral's logits
# by 0.2598 at 25 layers, where its sound reading was 0.04).  Unpinned
# readings: gemma3-4b 0.1016 / 0.1455, 0.2305;
# qwen3-moe-30b-a3b 0.0832 / 0.4688, 0.8125 (the gate unnormalised);
# gemma3-27b 0.1172 / 0.1797, 0.2617 (62 layers: against the plain bf16
# route it read 0.1562, past gemma3-4b's 0.125); mixtral-8x7b at 26
# layers 0.0391 / 0.0391, 0.2930 (the latter through flips): a window
# one 64-key tile short of 4,096 moves its logits no more than bf16
# noise does, so there its fault is held by the per-layer bar alone.
# Top-1 tokens must agree, or the kernel route's pick must lie within
# the bar of the plain route's best logit (random weights leave
# near-ties among 32k-262k logits).
#
# LM_LAYER_TOL: each prefill layer fed the plain f32-attention route's
# input to it, the largest over the layers of the mean |diff| of a
# layer's output.  Sound / faulted: gemma3-4b 0.00188 / 0.01182 (6.3x);
# qwen3 0.00158 / 0.11701; gemma3-27b 0.00182 / 0.01189; mixtral at 26
# layers 0.00188 / 0.00343, 0.00418 (its fault reaches only the 4,160
# of 8,192 positions past the window, by 64 of 4,096 keys: so a bar of
# its own, 1.38x above the sound reading and 1.32x below the fault's).
# No statistic of the final output (logits or every position's hidden
# state, max or mean, against either plain route) separates the window
# faults by 2x.
LM_BARS = {
    "gemma3-4b": (0.125, 0.005, True),
    "qwen3-moe-30b-a3b": (0.125, 0.005, True),
    "gemma3-27b": (0.15, 0.005, True),
    "mixtral-8x7b": (0.125, 0.0026, False),
}

# LM training.  Phase A: stablelm-3b's CONFIG (f32 params, bf16
# activations, layer remat) trained LM_TRAIN_STEPS adamw steps at
# train_4k's sequence of 4,096, its global batch of 256 cut to what one
# card holds: params, grads and two f32 moments are 41.7 GiB
# (LMConfig.param_count() 2.795B at 16 bytes), the layer-boundary bf16
# activations 0.67 GB a sequence (peak 49.45 GiB at B = 2).  Phase B:
# qwen3-moe-30b-a3b at full width with bf16 params and f32 moments
# (6.86 GiB a layer, 6.96 GiB for the token table and head), its 48
# layers cut to MOE_TRAIN_LAYERS, 1 x 4,096: the most under ~76 GiB
# (73.9 GiB at 8 layers; 9 ran out of memory; H100 SXM).
LM_TRAIN_ARCH = "stablelm-3b"
LM_TRAIN_BATCH = 2
LM_TRAIN_STEPS = 2
MOE_TRAIN_ARCH = "qwen3-moe-30b-a3b"
MOE_TRAIN_LAYERS = 4
MOE_TRAIN_BATCH = 1
MOE_TRAIN_STEPS = 3
# C.4: stablelm-3b at full width, its depth cut for a resume check whose
# checkpoints (params and both moments) stay a few GB: two layers (99.0
# s at four), so a restore that swaps or repeats a stack's layers still
# cannot match
LM_RESUME_LAYERS = 2
LM_RESUME_BATCH = 1
# C.2: the smoke configs on the card against the CPU
LM_ARCHS = ("stablelm-3b", "gemma3-4b", "gemma3-27b", "mixtral-8x7b",
            "qwen3-moe-30b-a3b")
LM_CHECK_BATCH, LM_CHECK_SEQ, LM_CHECK_STEPS = 2, 64, 5
# gemma3's local window: the planted faults' wrong window for a global
# layer
LM_LOCAL_WINDOW = 1024
# C.1: attend's forward and backward at the training layer shapes,
# bf16: (name, B, S, H, Hkv, hd, window, the planted backward fault's
# window)
ATTN_BWD_CASES = (
    ("stablelm-3b", LM_TRAIN_BATCH, 4096, 32, 32, 80, FULL_WINDOW,
     LM_LOCAL_WINDOW),
    ("qwen3-moe-30b-a3b", 1, 4096, 32, 4, 64, FULL_WINDOW, LM_LOCAL_WINDOW),
    ("gemma3-4b local", 1, 4096, 8, 4, 320, LM_LOCAL_WINDOW, FULL_WINDOW),
)
# attend's grads against plain autograd's where the recompute runs a
# group of KV heads at a time (the same function; bf16 products may
# round otherwise in another batch of the GEMM): the largest |diff|
# relative to the largest |grad|, one bf16 rounding
ATTN_BWD_TOL = 2 ** -8
# C.3: stablelm-3b's first-step loss (B = 2 x 4,096) on the kernel
# route against the plain version's.  Readings (H100 SXM, 700 W): sound
# 8.6e-05 (1.4e-04 against the plain version in f32); every layer
# forced to a 1,024-key window 2.5e-03: the bar sits 5.8x above the one
# and 4.9x below the other
LM_STEP_LOSS_TOL = 5e-4
# the GNN phase (``gnn_phases``): MACE's CONFIG trained GNN_STEPS adam
# steps through ``train.fit`` on three of GNN_SHAPES.  ogb_products does
# not fit one card: one (E, C, 9) f32 edge tensor is 285 GB.
GNN_SHAPE_NAMES = ("molecule", "full_graph_sm", "minibatch_lg")
GNN_STEPS = 5
# minibatch_lg's seeds a batch (the shape's batch_nodes)
GNN_MINI_SEEDS = 1024
# gnn_setup's stream (the launcher's min(batch, 32) molecules)
GNN_CHECK_BATCH = 32
# E(3): JAX's own rotation bar (tests/test_models_gnn.py)
GNN_E3_RTOL, GNN_E3_ATOL = 1e-3, 1e-4
# the profiler ranges of a MACE training step (``gnn_traced_spans``)
GNN_SPANS = ("radial MLP", "edge TP", "gather/scatter", "B-basis", "mixes",
             "readout", "optimizer")

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

def summed_bound(name: str, calls) -> dict:
    """``op_roofline`` of several calls of the op ``name`` together
    (``calls``: (args, kwargs) each): their FLOPs and bytes summed, then
    over the peaks."""
    from repro_torch.kernels.dispatch import op_cost
    from repro_torch.roofline import kernel_roofline
    costs = [op_cost(name, *a, **kw) for a, kw in calls]
    return kernel_roofline(sum(c.flops for c in costs),
                           sum(c.bytes for c in costs),
                           dtype=costs[0].dtype)


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


def profile_phase(what: str, fn, spans=()) -> dict:
    """Wall time of ``fn()`` under torch.profiler and the device time of
    each kernel and copy it ran, largest first; returns the wall and
    device busy ms and, for each profiler range named in ``spans``, the
    device time of the kernels launched inside it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_us(ev, total):
        name = "device_time_total" if total else "self_device_time_total"
        us = getattr(ev, name, None)
        if us is None:
            us = getattr(ev, name.replace("device", "cuda"), 0.0)
        return us

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
        # of the kernels it launched, and so does a range's device-side
        # annotation
        if ev.device_type != DeviceType.CUDA or ev.key in spans:
            continue
        us = device_us(ev, total=False)
        if us > 0:
            device[ev.key] = (us / 1e3, ev.count)
    busy = sum(ms for ms, _ in device.values())
    log(f"profile {what}: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / wall_ms:.1f}%)")
    for name, (ms, n) in sorted(device.items(), key=lambda kv: -kv[1][0])[:6]:
        log(f"  {ms:9.3f} ms  {n:5d}x  {name[:90]}")
    out = {"wall_ms": wall_ms, "busy_ms": busy,
           "device_ops": sum(n for _, n in device.values())}
    if spans:
        # a range's host-side event: the kernels of the ops inside it
        events = [ev for ev in prof.events()
                  if ev.name in spans and ev.device_type == DeviceType.CPU]
        for name in spans:
            out[name] = sum(device_us(ev, total=True) for ev in events
                            if ev.name == name) / 1e3
    return out


def time_kernels(errs: dict, launches: dict) -> list:
    """The ``kernels`` entries: times at the main path's shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import EmbeddingConfig
    from repro_torch.kernels.mgqe_decode import (decode, mgqe_decode,
                                                 mgqe_decode_ref)
    from repro_torch.roofline import op_roofline

    out = []
    # mgqe_decode: deepfm table (D=5, K=256, S=2, f32), serve_bulk batch
    b, d, k, s = serve_bulk_batch(), 5, 256, 2
    codes, cent = decode_inputs(b, d, k, s, torch.float32, seed=11)
    offs = (codes.long() + torch.arange(d, device="cuda") * k).contiguous()
    flat = cent.reshape(d * k, s)
    ms, host = time_ms(lambda: mgqe_decode(codes, cent))
    plain, _ = time_ms(lambda: mgqe_decode_ref(codes, cent))
    lib, lib_host = time_ms(lambda: F.embedding(offs, flat))
    r = op_roofline("mgqe_decode", codes, cent)
    nbytes, bound = r["bytes"], r["bound_ms"]
    out.append({"name": "mgqe_decode", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/mgqe_decode.cu",
                "replaces": "src/repro/kernels/mgqe_decode/mgqe_decode.py:54",
                "launches": launches["mgqe_decode"],
                "max_abs_err": errs["mgqe_decode"], "ms": ms,
                "plain_ms": plain, "bound_ms": bound,
                "bound_by": r["bound_by"], "library_ms": lib})
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
    f_bound = op_roofline("mgqe_decode", f_codes, f_cent)["bound_ms"]
    log(f"time mgqe_decode B={fb} (one engine flush): kernel {f_ms:.5f} ms, "
        f"bound {f_bound:.5f} ms; host time to launch through dispatch "
        f"{op_host:.5f} ms")

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
    r = op_roofline("mgqe_decode", l_codes, l_cent)
    l_bytes, l_bound = r["bytes"], r["bound_ms"]
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


def assign_bound(parts, cent) -> tuple:
    """(bound ms, by, FLOP, bytes) of dpq_assign's launches over
    ``parts`` ((rows, budgets) each) against ``cent``: their costs
    summed (``summed_bound``): 2·S FLOP for every centroid a row's
    budget reaches, the rows, budgets and codes once and the centroids
    once a launch."""
    r = summed_bound("dpq_assign", [((e, cent, lim), {})
                                    for e, lim in parts])
    return r["bound_ms"], r["bound_by"], r["flops"], r["bytes"]


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
    bound, by, flops, nbytes = assign_bound(parts, cent)
    evaluated = flops // (2 * cent.shape[2])
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
    from repro_torch.roofline import peak_flops
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
    t, by, flops, _ = assign_bound([(e_all, lim_all)], cent)
    evaluated = flops // (2 * s)
    # with the argmin: per (row, centroid) S FMAs, one FMA for the
    # distance and one compare-and-select, each at one lane-op a clock
    # (67 TFLOP/s = 33.5 T FMA lanes a second)
    n_b = -(-n // ASSIGN_BATCH)
    argmin = evaluated * (s + 2) / (peak_flops("float32") / 2) * 1e3 / n_b
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
    from repro_torch.roofline import op_roofline

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
        r = op_roofline("rq_decode_stages", c, cb)
        return (t_k, t_p, t_l, r["bound_ms"], r["bound_by"], r["bytes"],
                host, l_host)

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
    b16 = op_roofline("rq_decode_stages", codes, cbs16)["bound_ms"]
    log(f"time rq_decode_stages B={b} bf16 {p16}: kernel {ms16:.5f} ms, "
        f"bound {b16:.5f} ms")
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
        f"{op_roofline('rq_decode_stages', f_codes, cbs)['bound_ms']:.5f} "
        f"ms; host time to launch through dispatch {op_host:.5f} ms")
    # the bench's d = 64: 256 KB of codebooks, read through L2
    c64, cb64 = rq_inputs(b, 4, 256, 64, torch.float32, g)
    ms64, _ = time_ms(lambda: rq_decode_stages(c64, cb64))
    t64 = op_roofline("rq_decode_stages", c64, cb64)["bound_ms"]
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
        r = op_roofline("packed_decode", packed, cent, nb)
        nbytes, t_b, by = r["bytes"], r["bound_ms"], r["bound_by"]
        t_b16 = op_roofline("packed_decode", packed, cent16, nb)["bound_ms"]
        f_packed = packed[:flush_b].contiguous()
        t_f, _ = time_ms(lambda: packed_decode(f_packed, cent, nb))
        s_packed = packed[:256].contiguous()
        t_s, _ = time_ms(lambda: packed_decode(s_packed, cent, nb))
        rows[nb] = (t_k, t_p, t_b)
        log(f"time packed_decode B={b} D={dd} S={s} bits={nb} W={w} "
            f"{packed_plan(b, dd, s, nb, 4, sms)}: kernel {t_k:.5f} ms, plain "
            f"{t_p:.5f} ms, bound {t_b:.5f} ms by {by} ({nbytes} bytes); "
            f"bf16 {t_16:.5f} ms (bound {t_b16:.5f} ms); at the schemes' "
            f"block_b=256 {t_256:.5f} ms; at one flush (B={flush_b}) "
            f"{t_f:.5f} ms; at B=256 {t_s:.5f} ms; host time "
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
# distributed serving: a (data, model) mesh of gloo ranks on one card
# ----------------------------------------------------------------------

SHARD_MESH = (2, 2)                    # (data, model): 4 ranks, one card
SHARD_TIMEOUT = 300.0                  # a group's start, collectives, join
SHARD_BATCHES = (464, 465)             # retrieval: the flush, ragged
SHARD_SEARCHES = 2                     # measured searches a batch
SHARD_HEAD = 4096                      # ids of a wholly cached flush
TT_ITEM_DIM = 256                      # two-tower's tower output width
# the decode kernel each scheme of the phase launches
SHARD_DECODE = {"mgqe": "mgqe_decode", "rq": "rq_decode_stages",
                "mpe": "packed_decode"}


def shard_schemes() -> dict:
    """deepfm's largest field (10M rows) as phases 4 and 6 serve it:
    mgqe (D=5, K=256/64), rq (M=5, K=256), mpe (8/4/2-bit tiers at 5%
    and 25% of the ids) -> {name: EmbeddingConfig}."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.core import EmbeddingConfig
    from repro_torch.core.partition import frequency_boundaries
    from repro_torch.launch.engine import embedding_config_of_arch
    family, cfg = get_arch("deepfm", smoke=False)
    n = max(cfg.field_vocab_sizes)
    return {
        "mgqe": embedding_config_of_arch(family, cfg),
        "rq": embedding_config_of_arch(
            family, dataclasses.replace(cfg, embed_kind="rq")),
        "mpe": EmbeddingConfig(
            vocab_size=n, dim=cfg.embed_dim, kind="mpe",
            num_subspaces=cfg.num_subspaces,
            tier_boundaries=frequency_boundaries(n, (0.05, 0.25)),
            tier_bits=(8, 4, 2))}


def leaf_bytes(tree, leaves, rows: bool) -> int:
    """Bytes of the leaves of ``tree`` whose spec says ``rows``."""
    from repro_torch.core.schemes.base import tree_leaves
    return sum(t.numel() * t.element_size()
               for t, leaf in zip(tree_leaves(tree), leaves)
               if leaf.rows == rows)


def placed_check(what, before, local_rows, whole_rows, replicated,
                 n_leaves, model_n) -> dict:
    """The rank's device holds its 1/model_n of the row leaves plus the
    replicated ones, and nothing more: the caching allocator rounds a
    block up to 512 bytes, and a block past 1 MiB up to its 2 MiB
    segment when the rest is under 1 MiB (PyTorch's CUDA allocator), so
    each leaf may hold up to 2 MiB more than its bytes."""
    import torch
    torch.cuda.synchronize()
    placed = torch.cuda.memory_allocated() - before
    need(local_rows * model_n == whole_rows,
         f"{what}: the rank holds 1/{model_n} of the rows")
    need(local_rows + replicated <= placed
         <= local_rows + replicated + (2 << 20) * n_leaves
         and placed < whole_rows,
         f"{what}: the device holds its block and the replicated leaves "
         f"({placed} bytes allocated, {local_rows} + {replicated} placed, "
         f"{whole_rows} in the whole table)")
    return {"rows": local_rows, "whole_rows": whole_rows,
            "replicated": replicated, "allocated": placed}


def same_as(t, ref) -> bool:
    """``torch.equal`` of a tensor and a numpy reference (-0.0 equal to
    +0.0: a psum may turn one shard's -0.0 into +0.0)."""
    import torch
    return torch.equal(t.cpu(), torch.from_numpy(ref))


def sharded_rank(rank, plan) -> dict:
    """One rank of the distributed phase (a gloo process on the card):
    the three schemes through ServingEngine(mesh), uncached and behind a
    HOT_ROWS block, then flat_pq and ivf_pq through RetrievalEngine(mesh),
    each held bit for bit (torch.equal) to the single-device engine's
    results that the parent computed.  Returns the checks' numbers."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import Embedding, EmbeddingConfig
    from repro_torch.launch.engine import (EngineStats, RetrievalEngine,
                                           ServingEngine, drive_stream)
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.retrieval import IndexConfig, get_index
    mesh = make_debug_mesh(*SHARD_MESH)
    model_n = mesh.shape["model"]
    need(mesh.device == torch.device("cuda", 0), "every rank on cuda:0")
    counters = reset_counts()
    reqs = plan["requests"]
    out = {"serving": {}, "retrieval": {}}

    def same_flushes(kept, want, what):
        need(len(kept) == len(want), f"{what}: the flushes line up")
        for (_, res), ref in zip(kept, want):
            need(same_as(torch.cat(res), ref),
                 f"{what}: flush rows == the single-device engine's")

    for name, s in plan["serving"].items():
        cfg = EmbeddingConfig(**s["cfg"])
        art = torch.load(s["path"], map_location="cpu", mmap=True)
        emb = Embedding(cfg, device=mesh.device)
        leaves = emb.scheme.artifact_leaves()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        eng = ServingEngine(emb, art, mesh=mesh, max_queue=4096)
        placed = placed_check(
            name, before, leaf_bytes(eng.artifact, leaves, True),
            leaf_bytes(art, leaves, True),
            leaf_bytes(eng.artifact, leaves, False), len(leaves), model_n)
        st = dataclasses.replace(drive_stream(eng, reqs))
        same_flushes(drive_keeping_flushes(eng, reqs), s["rows"], name)
        decode = counters[SHARD_DECODE[name]]
        need(same_as(eng.lookup(np.arange(SHARD_HEAD)), s["head"]),
             f"{name}: head rows")
        hot = ServingEngine(emb, art, mesh=mesh, max_queue=4096,
                            hot_rows=HOT_ROWS)
        hst = dataclasses.replace(drive_stream(hot, reqs))
        same_flushes(drive_keeping_flushes(hot, reqs), s["rows"],
                     f"{name} behind a hot block")
        n0 = decode.launches
        cached = hot.lookup(np.arange(SHARD_HEAD))
        need(decode.launches == n0 and same_as(cached, s["head"]),
             f"{name}: a wholly cached flush launches no decode")
        refreshed = None
        if name == "mgqe":
            t0 = time.perf_counter()
            hot.refresh_hot_rows(np.arange(HOT_ROWS, 2 * HOT_ROWS))
            torch.cuda.synchronize()
            refreshed = time.perf_counter() - t0
            same_flushes(drive_keeping_flushes(hot, reqs), s["rows"],
                         f"{name} after a refresh")
        out["serving"][name] = dict(
            placed=placed, flush_ms=1e3 * st.seconds / st.flushes,
            hot_flush_ms=1e3 * hst.seconds / hst.flushes,
            hit_rate=hst.hit_rate, flushes=st.flushes,
            padded=st.padded_lookups, refresh_s=refreshed)
        del eng, hot, art
        torch.cuda.empty_cache()

    for name, r in plan["retrieval"].items():
        index = get_index(IndexConfig(**r["cfg"]))
        art = torch.load(r["path"], map_location="cpu", mmap=True)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        eng = RetrievalEngine(index, art, k=TOPK, block_q=16, mesh=mesh)
        local = sum(eng.artifact[k].numel() * eng.artifact[k].element_size()
                    for k in index.rows_leaves)
        whole = sum(art[k].numel() * art[k].element_size()
                    for k in index.rows_leaves)
        rest = sum(t.numel() * t.element_size()
                   for k, t in eng.artifact.items()
                   if k not in index.rows_leaves)
        placed = placed_check(name, before, local, whole, rest,
                              len(eng.artifact), model_n)
        ms = {}
        for b, (ref_s, ref_i) in zip(SHARD_BATCHES, r["want"]):
            q = r["queries"][:b]
            eng.search(q)                          # the first launches
            eng.stats_ = EngineStats()
            for _ in range(SHARD_SEARCHES):
                s_, i_ = eng.search(q)
            need(same_as(s_, ref_s) and same_as(i_, ref_i),
                 f"{name} B={b}: top-{TOPK} == the single-device search's")
            ms[b] = 1e3 * eng.stats_.seconds / eng.stats_.flushes
        out["retrieval"][name] = dict(placed=placed, ms=ms,
                                      pad=eng.pad_multiple)
        del eng, art
        torch.cuda.empty_cache()
    out["launches"] = {k: fn.launches for k, fn in counters.items()}
    return out


def nccl_world1_rank(rank, plan) -> dict:
    """One NCCL rank on the card: a (1, 1) mesh, an all_reduce through
    NCCL, and the mgqe field through ServingEngine(mesh), which takes the
    single-device route (JAX's size-1 fallback): every flush bit for bit
    the single-device engine's."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import Embedding, EmbeddingConfig
    from repro_torch.launch.engine import ServingEngine, drive_stream
    from repro_torch.launch.mesh import make_debug_mesh
    mesh = make_debug_mesh(1, 1)
    need(dist.get_backend() == "nccl", "the group runs on NCCL")
    t = torch.full((8,), 3.0, device=mesh.device)
    dist.all_reduce(t)
    need(bool((t == 3.0).all()), "an NCCL all_reduce of one rank")
    counters = reset_counts()
    s = plan["serving"]["mgqe"]
    emb = Embedding(EmbeddingConfig(**s["cfg"]), device=mesh.device)
    eng = ServingEngine(emb, torch.load(s["path"], map_location="cpu",
                                        mmap=True), mesh=mesh, max_queue=4096)
    drive_stream(eng, plan["requests"])
    kept = drive_keeping_flushes(eng, plan["requests"])
    for (_, res), ref in zip(kept, s["rows"]):
        need(same_as(torch.cat(res), ref),
             "NCCL world 1: flush rows == the single-device engine's")
    return {"launches": {k: fn.launches for k, fn in counters.items()},
            "flushes": len(kept)}


MESH_CLIS_FLAG = "--mesh-clis"
MESH_CLIS_MARK = "MESHCLIS train --mesh\n"


def mesh_clis(ckpt_dir: str) -> int:
    """One rank of the distributed training phase's torchrun: ``serve
    --mesh`` then ``train --mesh`` (both the smoke config of deepfm on
    (data=2, model=2), gloo on cuda:0) in the same process group, so the
    two drives share one start; rank 0 prints MESH_CLIS_MARK between
    them."""
    import torch.distributed as dist
    from repro_torch.launch import serve, train
    from repro_torch.launch.mesh import init_distributed
    mesh = ["--mesh", "data=2,model=2", "--dist-backend", "gloo",
            "--device", "cuda:0"]
    init_distributed("gloo", device="cuda:0")
    try:
        serve.main(["--arch", "deepfm", "--engine"] + mesh)
        dist.barrier()
        if dist.get_rank() == 0:
            print(MESH_CLIS_MARK, end="", flush=True)
        train.main(["--arch", "deepfm", "--steps", "2", "--batch",
                    str(CTR_BATCH), "--log-every", "1", "--ckpt-dir",
                    ckpt_dir, "--ckpt-every", "2"] + mesh)
    finally:
        dist.destroy_process_group()
    return 0


# the three distributed phases' NCCL (1, 1) checks, run in turn in one
# NCCL process (``run_nccl_jobs``, at the LM mesh phase): one process
# start for the three
NCCL_JOBS = []
_NCCL = {}


def nccl_dir() -> str:
    """A directory the deferred NCCL checks' files live in until they
    run."""
    import tempfile
    if "dir" not in _NCCL:
        _NCCL["dir"] = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    return _NCCL["dir"]


def defer_nccl(name: str, fn, plan, check) -> None:
    """Queue ``fn(0, plan)`` for the one NCCL process; ``check(result)``
    holds its result when it has run."""
    NCCL_JOBS.append((name, fn, plan, check))


def nccl_jobs_rank(rank, jobs) -> dict:
    """One NCCL rank on the card: every queued check in turn, each
    timed."""
    out = {}
    for name, fn, plan in jobs:
        t0 = time.perf_counter()
        out[name] = fn(rank, plan)
        out[name]["seconds"] = time.perf_counter() - t0
    return out


def run_nccl_jobs(name: str, fn, plan, store_dir: str) -> tuple:
    """The queued checks and ``fn(0, plan)`` (as ``name``) in one NCCL
    process; every queued check held; returns (``fn``'s result, the
    launches of the others, the process's seconds)."""
    import shutil
    from repro_torch.launch.mesh import spawn
    jobs = [(n, f, p) for n, f, p, _ in NCCL_JOBS] + [(name, fn, plan)]
    t0 = time.perf_counter()
    try:
        (res,) = spawn(nccl_jobs_rank, 1, backend="nccl", device="cuda:0",
                       args=(jobs,), store_dir=store_dir,
                       timeout_s=LMM_TIMEOUT)
    finally:
        shutil.rmtree(_NCCL.pop("dir", ""), ignore_errors=True)
    seconds = time.perf_counter() - t0
    launches = {}
    for n, _, _, check in NCCL_JOBS:
        check(res[n])
        for k, v in res[n].get("launches", {}).items():
            launches[k] = launches.get(k, 0) + v
    NCCL_JOBS.clear()
    return res[name], launches, seconds


def sharded_serving_phase(card: str) -> dict:
    """The distributed-serving phase (see the module docstring): the
    parent exports and builds, serves each artifact on one device for
    the reference rows, and saves the artifacts to the host; then 4 gloo
    ranks on the card (``sharded_rank``), one NCCL rank
    (``nccl_world1_rank``) and ``serve --mesh`` under torchrun.  Counts
    set to 0 just before, read just after, the ranks' summed in;
    returns them."""
    import dataclasses
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.core import Embedding
    from repro_torch.core.schemes.base import tree_map
    from repro_torch.launch.engine import (EngineStats, RetrievalEngine,
                                           ServingEngine, drive_stream,
                                           random_requests)
    from repro_torch.launch.mesh import spawn
    from repro_torch.retrieval import (IndexConfig, build_ivf_artifact,
                                       get_index)

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    counters = reset_counts()
    data_n, model_n = SHARD_MESH
    world = data_n * model_n
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    schemes = shard_schemes()
    n = schemes["mgqe"].vocab_size
    reqs = random_requests(n, N_REQUESTS, REQ_BATCH, seed=29)
    plan = {"requests": reqs, "serving": {}, "retrieval": {}}
    single = {}
    try:
        # ---------------------------------- the parent: exports, references
        for name, ecfg in schemes.items():
            emb = Embedding(ecfg)
            params = emb.init(emb.generator(0))
            art = emb.export(params)
            del params
            eng = ServingEngine(emb, art, max_queue=4096)
            st = dataclasses.replace(drive_stream(eng, reqs))
            kept = drive_keeping_flushes(eng, reqs)
            path = os.path.join(tmp, f"{name}.pt")
            torch.save(tree_map(lambda t: t.cpu(), art), path)
            # the references cross to the ranks as numpy arrays
            plan["serving"][name] = {
                "cfg": dataclasses.asdict(ecfg), "path": path,
                "rows": [torch.cat(res).cpu().numpy() for _, res in kept],
                "head": eng.lookup(np.arange(SHARD_HEAD)).cpu().numpy()}
            single[name] = dict(ms=1e3 * st.seconds / st.flushes,
                                padded=st.padded_lookups, flushes=st.flushes)
            del eng, art, emb, kept
            torch.cuda.empty_cache()
        g = torch.Generator(device="cuda").manual_seed(31)
        vecs = torch.randn((retrieval_candidates(), TT_ITEM_DIM),
                           generator=g, device="cuda")
        fcfg = IndexConfig(kind="flat_pq", num_subspaces=8,
                           num_centroids=64)
        fart = get_index(fcfg).build(
            torch.Generator(device="cuda").manual_seed(1), vecs)
        fq = torch.randn((max(SHARD_BATCHES), TT_ITEM_DIM), generator=g,
                         device="cuda").cpu().numpy()
        del vecs
        ivecs, iq = ivf_scale_corpus(max(SHARD_BATCHES))
        icfg = ivf_scale_config()
        iart, _ = build_ivf_artifact(
            torch.Generator(device="cuda").manual_seed(0), ivecs, icfg)
        del ivecs
        for name, cfg_i, art, q in (("flat_pq", fcfg, fart, fq),
                                    ("ivf_pq", icfg, iart, iq)):
            index = get_index(cfg_i)
            eng = RetrievalEngine(index, art, k=TOPK, block_q=16)
            want, ms = [], {}
            for b in SHARD_BATCHES:
                eng.search(q[:b])
                eng.stats_ = EngineStats()
                for _ in range(SHARD_SEARCHES):
                    s_, i_ = eng.search(q[:b])
                want.append((s_.cpu().numpy(), i_.cpu().numpy()))
                ms[b] = 1e3 * eng.stats_.seconds / eng.stats_.flushes
            path = os.path.join(tmp, f"{name}.pt")
            torch.save({k: torch.as_tensor(v).cpu() for k, v in art.items()},
                       path)
            plan["retrieval"][name] = {"cfg": dataclasses.asdict(cfg_i),
                                       "path": path, "queries": q,
                                       "want": want}
            single[name] = dict(ms=ms, pad=eng.pad_multiple)
            del eng
        del fart, iart
        torch.cuda.empty_cache()
        t_ref = time.perf_counter() - t_phase

        # ---------------------------------------------- 4 gloo ranks
        t0 = time.perf_counter()
        ranks = spawn(sharded_rank, world, backend="gloo", device="cuda:0",
                      args=(plan,), store_dir=tmp, timeout_s=SHARD_TIMEOUT)
        t_ranks = time.perf_counter() - t0
        # ---------------- one NCCL rank (run with the LM mesh phase's)
        import shutil as sh
        mgqe = dict(plan["serving"]["mgqe"],
                    path=sh.copy(plan["serving"]["mgqe"]["path"], nccl_dir()))

        def nccl_check(nccl):
            need(nccl["launches"]["mgqe_decode"] > 0,
                 "NCCL world 1: mgqe_decode")
            log(f"NCCL world 1: ServingEngine(mesh=(1, 1)) over "
                f"{nccl['flushes']} flushes bit-identical (the distributed "
                f"phase's check, {nccl['seconds']:.1f}s in the one NCCL "
                f"process)")
        defer_nccl("serving", nccl_world1_rank,
                   {"serving": {"mgqe": mgqe}, "requests": plan["requests"]},
                   nccl_check)
        # serve --mesh under torchrun: with train --mesh, in the
        # distributed training phase's one torchrun (``mesh_clis``)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    launches = {k: fn.launches for k, fn in counters.items()}
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] += v
    for name in SHARD_DECODE.values():
        need(all(r["launches"][name] > 0 for r in ranks),
             f"{name} launched on every rank")
    for name in ("pq_topk", "pq_score_batched"):
        need(all(r["launches"][name] > 0 for r in ranks),
             f"{name} launched on every rank")

    # what one flush puts on the wire, per rank, by collective: the
    # ids' all-gather over data, the (B_global, d) partials' psum over
    # model, the rows' all-gather over data (payloads, f32 rows)
    for name, ecfg in schemes.items():
        rows = [r["serving"][name] for r in ranks]
        p = rows[0]["placed"]
        b_global = rows[0]["padded"] / rows[0]["flushes"]
        log(f"sharded {name} (mesh data={data_n}, model={model_n}, "
            f"{world} gloo ranks on cuda:0): each rank's device holds "
            f"{p['rows'] / 1e6:.3f} MB of codes (1/{model_n} of "
            f"{p['whole_rows'] / 1e6:.3f}) + {p['replicated'] / 1e6:.4f} MB "
            f"codebooks, {p['allocated']} bytes allocated; flush ms "
            f"sharded {[round(r['flush_ms'], 5) for r in rows]} by rank vs "
            f"single-device {single[name]['ms']:.5f}; behind "
            f"{HOT_ROWS} hot rows {[round(r['hot_flush_ms'], 5) for r in rows]}"
            f" (hit rate {rows[0]['hit_rate']:.4f})"
            + (f", a refresh {rows[0]['refresh_s']:.3f}s"
               if rows[0]["refresh_s"] is not None else "")
            + f"; wire a flush (B_global {b_global:.0f}, d {ecfg.dim}): ids "
            f"{4 * b_global:.0f} B, partials {4 * b_global * ecfg.dim:.0f} "
            f"B, rows {4 * b_global * ecfg.dim:.0f} B; every flush "
            f"bit-identical on every rank [{card}]")
    for name in ("flat_pq", "ivf_pq"):
        rows = [r["retrieval"][name] for r in ranks]
        p = rows[0]["placed"]
        d_q = plan["retrieval"][name]["queries"].shape[1]
        log(f"sharded {name}: each rank's device holds "
            f"{p['rows'] / 1e6:.3f} MB of corpus rows (1/{model_n} of "
            f"{p['whole_rows'] / 1e6:.3f}) + {p['replicated'] / 1e6:.4f} MB "
            f"replicated; search ms " + "; ".join(
                f"B={b}: sharded {[round(r['ms'][b], 5) for r in rows]} vs "
                f"single-device {single[name]['ms'][b]:.5f}"
                for b in SHARD_BATCHES)
            + f"; wire a query: {4 * d_q} B gathered, {model_n * TOPK * 12}"
            f" B of partials (scores, tiebreaks, ids), {TOPK * 8} B of "
            f"results; top-{TOPK} bit-identical on every rank [{card}]")
    log(f"distributed phase {time.perf_counter() - t_phase:.1f}s (parent's "
        f"exports and references {t_ref:.1f}s, 4 ranks {t_ranks:.1f}s; its "
        f"NCCL check runs with the LM mesh phase's, its torchrun drive with "
        f"the distributed training phase's); gloo on one card moves the "
        f"collectives through host memory: no interconnect is measured; "
        f"launches {launches}")
    return launches


# ----------------------------------------------------------------------
# distributed recsys training: deepfm and two-tower on a (2, 2) mesh
# ----------------------------------------------------------------------

MT_MESH = (2, 2)                       # (data, model): 4 ranks, one card
MT_STEPS = 5                           # deepfm's steps on the mesh
MT_CKPT = 3                            # the step checkpointed and resumed
MT_TOL = 1e-5                          # losses and gradients
MT_TT_ROWS = 2_000_000                 # two-tower's users and items, cut
MT_TT_STEPS = 2
MT_NCCL_STEPS = 2
MT_TIMED = 1                           # unrecorded steps timed, each side
MT_SERVE_REQUESTS = 8                  # requests through each served field
MT_TIMEOUT = 600.0                     # a group's start, collectives, join


def mt_paths(tree, prefix="") -> list:
    """Leaf paths of a param tree in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in mt_paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree)
                for p in mt_paths(v, f"{prefix}{i}/")]
    return [prefix[:-1]]


def mt_rows(cfg, batches) -> dict:
    """{table path: the sorted rows any of ``batches`` reads} for
    deepfm's field and first-order tables (column i of ``sparse_ids``)."""
    import numpy as np
    ids = np.concatenate([b["sparse_ids"] for b in batches])
    return {f"{t}/f{i}/emb": np.unique(ids[:, i]).astype(np.int64)
            for t in ("fields", "first_order")
            for i in range(cfg.n_sparse)}


def mt_sparse(leaves, paths, rows, split, j) -> list:
    """Each leaf on the host at the rows ``rows`` names (a table), or
    whole: a split leaf is this rank's block (model index ``j``) and
    keeps the named rows inside it, as (global rows, values)."""
    import torch
    out = []
    for t, path, cut in zip(leaves, paths, split):
        if path not in rows:
            out.append(t.detach().cpu().clone())
            continue
        r = rows[path]
        n = t.shape[0]
        lo = j * n if cut else 0
        r = r[(r >= lo) & (r < lo + n)] if cut else r
        out.append((r, t.detach()[torch.from_numpy(r - lo).to(t.device)]
                    .cpu()))
    return out


def mt_merge(ranks: list, key: str) -> list:
    """A run's sparse leaves whole: each split leaf's blocks from the
    ranks of data index 0 (mesh order), in row order."""
    import numpy as np
    import torch
    first = ranks[0][key]
    if isinstance(first, dict):               # one entry a step
        return {s: mt_merge([{key: r[key][s]} for r in ranks], key)
                for s in first}
    out = []
    for i, leaf in enumerate(first):
        if not isinstance(leaf, tuple):
            out.append(leaf)
            continue
        parts = [r[key][i] for r in ranks]
        at = np.concatenate([p[0] for p in parts])
        need(bool((np.diff(at) > 0).all()), "the blocks' rows in order")
        out.append(torch.cat([p[1] for p in parts]))
    return out


def mt_values(leaves) -> list:
    return [t[1] if isinstance(t, tuple) else t for t in leaves]


def mt_crc(tensors) -> int:
    """crc32 over the bytes of ``tensors``, in turn."""
    import zlib
    import torch
    c = 0
    for t in tensors:
        c = zlib.crc32(t.detach().cpu().contiguous().view(-1).view(
            torch.uint8).numpy().tobytes(), c)
    return c


def mt_held(what, run, ref, start, acc=None) -> dict:
    """``run`` against ``ref`` (each: its losses, its sparse tape a step
    and its sparse final params), two runs of the same steps from the
    common ``start`` (and adagrad accumulators ``acc``): the first
    step's loss and consumed gradients within MT_TOL (both runs take it
    from the same params); every param within float32 rounding of a
    float64 adagrad over the run's own gradients and apart from
    ``ref``'s by no more than the two replays are.  After the first
    step the runs' params differ where adagrad's first step on an
    element divides a gradient by its own size (a 1e-9 gap at |g| near
    1e-8 moves it by ~lr), so the later losses and gradients are
    reported, not barred.  Returns the largest gaps."""
    from repro_torch.train.optimizer import adagrad_replay
    steps = sorted(ref["tape"])
    need(len(run["losses"]) == len(ref["losses"]) == len(steps),
         f"{what}: the steps")
    loss_gaps = [abs(a - b) / max(1.0, abs(b))
                 for a, b in zip(run["losses"], ref["losses"])]
    tape, rtape, grad_gaps = [], [], []
    for s in steps:
        g, rg = mt_values(run["tape"][s]), mt_values(ref["tape"][s])
        grad_gaps.append(max(float((a - b).abs().max()) if a.numel()
                             else 0.0 for a, b in zip(g, rg, strict=True)))
        tape.append(("x", run["lr"], run["eps"], g))
        rtape.append(("x", run["lr"], run["eps"], rg))
    need(loss_gaps[0] <= MT_TOL and grad_gaps[0] <= MT_TOL,
         f"{what}: the first step's loss and gradients within {MT_TOL} "
         f"({loss_gaps[0]:.3g}, {grad_gaps[0]:.3g})")
    p0 = mt_values(start)
    a0 = None if acc is None else mt_values(acc)
    r, _, s = adagrad_replay(p0, tape, acc=a0)
    rr, _, rs = adagrad_replay(p0, rtape, acc=a0)
    param_gap, share = 0.0, 0.0
    for t, rt, x, rx, e, re_ in zip(mt_values(run["final"]),
                                    mt_values(ref["final"]), r, rr, s, rs,
                                    strict=True):
        t, rt = t.double(), rt.double()
        if not t.numel():
            continue
        need(bool(((t - x).abs() <= e).all()),
             f"{what}: params within float32 rounding of their replay")
        gap = (t - rt).abs()
        param_gap = max(param_gap, float(gap.max()))
        bound = (x - rx).abs() + e + re_
        need(bool((gap <= bound).all()), f"{what}: params apart from the "
             f"reference's by no more than the replays are")
        share = max(share, float((gap / bound).max()))
    return {"loss": [float(f"{x:.3g}") for x in loss_gaps],
            "grad": [float(f"{x:.3g}") for x in grad_gaps],
            "param": param_gap, "bound_share": share}


def mt_whole_tree(params, split, mesh):
    """This rank's params with every row block gathered whole over
    ``model``: a tree one device's model reads."""
    from repro_torch.core.schemes.base import tree_leaves
    from repro_torch.sharding.collectives import all_gather
    it = iter([all_gather(t, mesh, "model") if cut else t
               for t, cut in zip(tree_leaves(params), split)])

    def rebuild(tree):
        if isinstance(tree, dict):
            return {k: rebuild(tree[k]) for k in sorted(tree)}
        if isinstance(tree, list):
            return [rebuild(v) for v in tree]
        return next(it)
    return rebuild(params)


def mt_one_device_gap(cell, state, grads, metrics, batch, mesh) -> tuple:
    """The step's reduced (pre-clip) gradients and loss against one
    device's at the same params on the global ``batch``: the params
    gathered whole, ``model.loss`` with no mesh.  Returns (loss gap,
    gradient gap, one device's gradients clipped by its global norm,
    as this rank's blocks)."""
    from repro_torch.core.schemes.base import tree_leaves
    from repro_torch.launch.train import RECSYS_OPTIMIZER
    from repro_torch.train.optimizer import clip_by_global_norm, loss_grads
    whole = mt_whole_tree(state.params, cell.split, mesh)
    ref, m = loss_grads(cell.model.loss, whole, batch)
    j = mesh.axis_index("model")
    blocks = []
    for w, cut in zip(tree_leaves(ref), cell.split):
        if cut:
            n = w.shape[0] // mesh.shape["model"]
            w = w[j * n:(j + 1) * n]
        blocks.append(w)
    gap = max(float((g - w).abs().max())
              for g, w in zip(tree_leaves(grads), blocks))
    clip_by_global_norm(ref, RECSYS_OPTIMIZER.grad_clip)  # blocks: views
    loss_gap = abs(float(metrics["loss"]) - float(m["loss"])) / max(
        1.0, abs(float(m["loss"])))
    return loss_gap, gap, blocks


def mt_per_rank_softmax_loss(model, params, batch, mesh) -> float:
    """Two-tower's first-step loss with the softmax over each rank's own
    items (a planted fault): weighted and summed over data as the cell
    sums the real one."""
    import torch
    from repro_torch.models.recsys.two_tower import INV_TEMPERATURE
    from repro_torch.sharding.collectives import psum
    with torch.no_grad():
        u, au = model.user_vec(params, batch["user_ids"], mesh)
        v, av = model.item_vec(params, batch["item_ids"], mesh)
        logits = (u @ v.T) * INV_TEMPERATURE - batch["item_logq"][None, :]
        sm = torch.mean(torch.logsumexp(logits, -1) - torch.diagonal(logits))
        loss = (sm + au + av) / mesh.shape["data"]
        return float(psum(loss, mesh, "data"))


def mt_run(cell, state, batches, rows, paths, mesh, steps, err=None,
           ckpt=None, forced=False):
    """``steps`` (step numbers) of ``cell`` on this rank from ``state``,
    recorded: losses, the sparse tape, the crc of the replicated leaves
    after each step; ``err`` (a list) takes the compressed mean's
    relative error over the replicated gradient shares a step (its
    error fed back); ``ckpt`` = (dir, step) saves the whole state;
    ``forced`` also holds each step against one device's at the same
    params (``mt_one_device_gap``: the loss and reduced gradients, and
    the clipped gradients adagrad consumed at the batches' rows)."""
    import torch
    from repro_torch.core.schemes.base import tree_leaves
    from repro_torch.launch.train import RECSYS_OPTIMIZER
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train import compression
    from repro_torch.train.loop import on_device
    from repro_torch.train.optimizer import (TrainState, apply_updates,
                                             record_adagrad)
    j = mesh.axis_index("model")
    data_n = mesh.shape["data"]
    out = {"losses": [], "tape": {}, "rep_crc": [], "forced": []}
    feedback = None
    with record_adagrad() as tape:
        for s in steps:
            whole = {k: torch.from_numpy(v) for k, v in
                     batches[s - 1].items()}
            batch = on_device(cell.local_batch(whole), mesh.device)
            grads, metrics = cell.grads(state, batch)
            if err is not None:
                shares = [g for g, cut in zip(tree_leaves(grads), cell.split)
                          if not cut]
                if feedback is None:
                    feedback = compression.init_error_state(shares)
                mean, feedback = compression.compressed_psum_mean(
                    shares, feedback, mesh, "data")
            grads, metrics = cell.reduce(grads, metrics)
            if err is not None:
                exact = torch.cat([g.reshape(-1) for g, cut in zip(
                    tree_leaves(grads), cell.split) if not cut])
                got = torch.cat([m.reshape(-1) for m in mean]) * data_n
                err.append(float((got - exact).norm() / exact.norm()))
            if forced:
                loss_gap, grad_gap, ref = mt_one_device_gap(
                    cell, state, grads, metrics,
                    on_device(whole, mesh.device), mesh)
            params, opt = apply_updates(
                RECSYS_OPTIMIZER, state.params, grads, state.opt_state,
                mesh=mesh, specs=cell.specs.params)
            state = TrainState(params, opt)
            out["losses"].append(float(metrics["loss"]))
            _, lr, eps, g = tape.pop()
            out["lr"], out["eps"] = lr, eps
            sparse = mt_sparse(g, paths, rows, cell.split, j)
            for t, sp in zip(g, sparse):        # nothing outside the rows
                if isinstance(sp, tuple):
                    need(int(torch.count_nonzero(t)) == int(
                        torch.count_nonzero(sp[1])),
                         "a table's gradient lies on the rows it read")
            if forced:
                clipped = mt_sparse(ref, paths, rows, cell.split, j)
                clip_gap = max(float((a - b).abs().max()) if a.numel()
                               else 0.0 for a, b in zip(
                                   mt_values(sparse), mt_values(clipped)))
                out["forced"].append((loss_gap, grad_gap, clip_gap))
                del ref, clipped
            out["tape"][s] = sparse
            out["rep_crc"].append(mt_crc(
                t for t, cut in zip(tree_leaves(state.params), cell.split)
                if not cut))
            if ckpt is not None and s == ckpt[1]:
                ckpt_lib.save(ckpt[0], s, state, mesh=mesh, specs=cell.specs)
    out["final"] = mt_sparse(tree_leaves(state.params), paths, rows,
                             cell.split, j)
    return state, out


def mt_timed(step, state, batches, device) -> list:
    """ms of each of ``batches``' steps, nothing recorded (host clock
    around a synchronised step)."""
    import torch
    from repro_torch.train.loop import on_device
    ms = []
    for b in batches:
        b = on_device(b, device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, b)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return ms


def mt_restored(cell, ckpt_dir, mesh):
    """The checkpoint's step MT_CKPT placed on ``mesh`` for ``cell``."""
    from repro_torch.sharding.rules import whole_like
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train.optimizer import TrainState
    template = TrainState(
        whole_like(cell.state.params, cell.specs.params, mesh),
        whole_like(cell.state.opt_state, cell.specs.opt_state, mesh))
    return ckpt_lib.elastic_restore(ckpt_dir, MT_CKPT, template,
                                    cell.specs, mesh)


def mt_rank(rank, plan) -> dict:
    """One rank of the distributed-training phase (a gloo process on the
    card); see ``sharded_training_phase``."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core import Embedding
    from repro_torch.core.schemes.base import tree_leaves
    from repro_torch.launch.cells import recsys_train_cell
    from repro_torch.launch.engine import ServingEngine, random_requests
    from repro_torch.launch.mesh import Mesh, make_debug_mesh
    from repro_torch.models.recsys.fields import field_embedding_config
    from repro_torch.sharding.collectives import all_gather
    from repro_torch.train.loop import on_device
    mesh = make_debug_mesh(*MT_MESH)
    need(mesh.device == torch.device("cuda", 0), "every rank on cuda:0")
    counters = reset_counts()
    _, cfg = get_arch("deepfm", smoke=False)
    batches, rows = plan["batches"], plan["rows"]
    out = {}
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    cell = recsys_train_cell(cfg, mesh)
    torch.cuda.synchronize()
    out["t_init"] = time.perf_counter() - t0
    out["state_bytes"] = torch.cuda.memory_allocated() - before
    out["split"] = cell.split
    paths = mt_paths(cell.state.params)
    j = mesh.axis_index("model")
    out["start"] = mt_sparse(tree_leaves(cell.state.params), paths, rows,
                             cell.split, j)
    torch.cuda.reset_peak_memory_stats()
    rel = []
    state, run = mt_run(cell, cell.state, batches, rows, paths, mesh,
                        range(1, MT_STEPS + 1), err=rel,
                        ckpt=(plan["ckpt"], MT_CKPT), forced=True)
    out["peak"] = torch.cuda.max_memory_allocated() - before
    out["run"], out["rel"] = run, rel
    out["block_crc"] = [mt_crc([t]) for t in tree_leaves(state.params)]
    # the same mesh, resumed from the checkpoint: bit for bit
    restored = mt_restored(cell, plan["ckpt"], mesh)
    out["at_ckpt"] = (mt_sparse(tree_leaves(restored.params), paths, rows,
                                cell.split, j),
                      mt_sparse(tree_leaves(restored.opt_state["acc"]),
                                paths, rows, cell.split, j))
    resumed, _ = mt_run(cell, restored, batches, rows, paths, mesh,
                        range(MT_CKPT + 1, MT_STEPS + 1))
    out["resumed_crc"] = [mt_crc([t]) for t in tree_leaves(resumed.params)]
    del restored, resumed
    # the trained tables gathered, exported and served, through the
    # mesh and on one device
    t0 = time.perf_counter()
    served, codes_crc = [], {}
    for i, v in enumerate(cfg.field_vocab_sizes):
        ecfg = field_embedding_config(cfg, v)
        if ecfg.kind != "mgqe":
            continue
        p = state.params["fields"][f"f{i}"]
        whole = all_gather(p["emb"], mesh, "model")
        emb = Embedding(ecfg, device=mesh.device)
        art = emb.export({"emb": whole, "centroids": p["centroids"]})
        del whole
        codes_crc[i] = mt_crc([art["codes"]])
        reqs = random_requests(v, MT_SERVE_REQUESTS, REQ_BATCH, seed=i)
        got = drive_keeping_flushes(ServingEngine(emb, art, mesh=mesh),
                                    reqs)
        want = drive_keeping_flushes(ServingEngine(emb, art), reqs)
        served.append(all(torch.equal(torch.cat(a), torch.cat(b))
                          for (_, a), (_, b) in zip(got, want,
                                                    strict=True)))
        del art
    out["served"], out["codes_crc"] = served, codes_crc
    out["t_serve"] = time.perf_counter() - t0
    out["ms"] = mt_timed(cell.step, state, [
        cell.local_batch({k: torch.from_numpy(v) for k, v in b.items()})
        for b in batches[:MT_TIMED]], mesh.device)
    del state, cell
    torch.cuda.empty_cache()
    # (1, 4) over the same ranks, resumed from the checkpoint
    m14 = Mesh((1, 4), ("data", "model"), device=mesh.device)
    cell = recsys_train_cell(cfg, m14)
    restored = mt_restored(cell, plan["ckpt"], m14)
    cell.state = restored
    _, run14 = mt_run(cell, restored, batches, rows, paths, m14,
                      range(MT_CKPT + 1, MT_STEPS + 1))
    out["run14"], out["split14"] = run14, cell.split
    del cell, restored
    torch.cuda.empty_cache()
    # two-tower at its widths, users and items cut
    _, tt_full = get_arch("two-tower-retrieval", smoke=False)
    tcfg = dataclasses.replace(tt_full, n_users=MT_TT_ROWS,
                               n_items=MT_TT_ROWS)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cell = recsys_train_cell(tcfg, mesh)
    out["tt_state_bytes"] = torch.cuda.memory_allocated() - before
    tb = [on_device(cell.local_batch({k: torch.from_numpy(v)
                                      for k, v in b.items()}), mesh.device)
          for b in plan["tt_batches"]]
    out["tt_planted"] = mt_per_rank_softmax_loss(cell.model,
                                                 cell.state.params, tb[0],
                                                 mesh)
    grads, _ = cell.reduce(*cell.grads(cell.state, tb[0]))
    out["tt_grads"] = [g.cpu() for g, path in zip(
        tree_leaves(grads), mt_paths(cell.state.params)) if "mlp" in path]
    del grads
    state, losses, ms = cell.state, [], []
    for b in tb:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = cell.step(state, b)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(m["loss"]))
    out["tt_losses"], out["tt_ms"] = losses, ms
    out["tt_peak"] = torch.cuda.max_memory_allocated() - before
    out["launches"] = {k: fn.launches for k, fn in counters.items()}
    return out


def mt_nccl_rank(rank, plan) -> dict:
    """One NCCL rank on the card: deepfm's ``CONFIG`` through the train
    cell on a (1, 1) mesh, MT_NCCL_STEPS steps: its losses and the crc
    of every param (the cell's size-1 route is the single device's)."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.core.schemes.base import tree_leaves
    from repro_torch.launch.cells import recsys_train_cell
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.train.loop import on_device
    mesh = make_debug_mesh(1, 1)
    need(dist.get_backend() == "nccl", "the group runs on NCCL")
    _, cfg = get_arch("deepfm", smoke=False)
    cell = recsys_train_cell(cfg, mesh)
    state, losses = cell.state, []
    for b in plan["batches"][:MT_NCCL_STEPS]:
        state, m = cell.step(state, on_device(cell.local_batch(
            {k: torch.from_numpy(v) for k, v in b.items()}), mesh.device))
        losses.append(float(m["loss"]))
    return {"losses": losses,
            "crc": mt_crc(tree_leaves(state.params))}


def mt_wire_bytes(b_global: int, split, leaves) -> dict:
    """What a deepfm step puts on the wire per rank, by collective: per
    split table the ids' gather (int32), the (B_global, d) partials'
    psum and the cotangent's gather (float32); the replicated gradients
    and metrics in one psum; the clip's sum."""
    tables = [t for t, cut in zip(leaves, split) if cut]
    reps = sum(t.numel() for t, cut in zip(leaves, split) if not cut)
    ids = 4 * b_global * len(tables)
    rows = sum(4 * b_global * t.shape[1] for t in tables)
    return {"collectives": 3 * len(tables) + 2, "ids": ids,
            "partials": rows, "cotangents": rows,
            "replicated": 4 * (reps + 3), "clip": 4}


def sharded_training_phase(card: str) -> dict:
    """The distributed-training phase (see the module docstring): one
    device's reference runs in this process, then 4 gloo ranks on the
    card (``mt_rank``), one NCCL rank (``mt_nccl_rank``) and ``train
    --mesh`` under torchrun.  Counts set to 0 just before, read just
    after, the ranks' summed in; returns them."""
    import dataclasses
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core import Embedding
    from repro_torch.core.schemes.base import tree_leaves
    from repro_torch.launch.mesh import spawn
    from repro_torch.launch.train import recsys_setup, recsys_stream
    from repro_torch.models.recsys.fields import field_embedding_config
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train.loop import on_device
    from repro_torch.train.optimizer import loss_grads, record_adagrad

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    counters = reset_counts()
    data_n, model_n = MT_MESH
    world = data_n * model_n
    _, cfg = get_arch("deepfm", smoke=False)
    stream = recsys_stream(cfg, CTR_BATCH)
    batches = [{k: v.numpy() for k, v in next(stream).items()}
               for _ in range(MT_STEPS)]
    rows = mt_rows(cfg, batches)
    _, tt_full = get_arch("two-tower-retrieval", smoke=False)
    tcfg = dataclasses.replace(tt_full, n_users=MT_TT_ROWS,
                               n_items=MT_TT_ROWS)
    stream = recsys_stream(tcfg, CTR_BATCH)
    tt_batches = [{k: v.numpy() for k, v in next(stream).items()}
                  for _ in range(MT_TT_STEPS)]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_mesh_")
    ckpt_dir = os.path.join(tmp, "ckpt")
    plan = {"batches": batches, "rows": rows, "ckpt": ckpt_dir,
            "tt_batches": tt_batches}
    try:
        # ------------------------------------- one device: the reference
        model, state, step, _ = recsys_setup(cfg, CTR_BATCH)
        paths = mt_paths(state.params)
        whole = [False] * len(paths)
        start = mt_sparse(tree_leaves(state.params), paths, rows, whole, 0)
        single = {"losses": [], "tape": {}}
        with record_adagrad() as tape:
            for s, b in enumerate(batches, 1):
                b = on_device({k: torch.from_numpy(v) for k, v in b.items()},
                              "cuda")
                state, m = step(state, b)
                single["losses"].append(float(m["loss"]))
                _, lr, eps, g = tape.pop()
                single["tape"][s] = mt_sparse(g, paths, rows, whole, 0)
                if s == MT_NCCL_STEPS:
                    single["crc2"] = mt_crc(tree_leaves(state.params))
        single["lr"], single["eps"] = lr, eps
        single["final"] = mt_sparse(tree_leaves(state.params), paths, rows,
                                    whole, 0)
        codes_crc = {}
        for i, v in enumerate(cfg.field_vocab_sizes):
            ecfg = field_embedding_config(cfg, v)
            if ecfg.kind == "mgqe":
                codes_crc[i] = mt_crc([Embedding(ecfg).export(
                    state.params["fields"][f"f{i}"])["codes"]])
        # the state goes on (in place) to the timed steps: only its
        # shapes serve later, as the restore's template
        single["ms"] = mt_timed(step, state, [
            {k: torch.from_numpy(v) for k, v in b.items()}
            for b in batches[:MT_TIMED]], "cuda")
        # two-tower: the loss of each step and the first step's towers'
        # gradients
        tmodel, tstate, tstep, _ = recsys_setup(tcfg, CTR_BATCH)
        tb = [on_device({k: torch.from_numpy(v) for k, v in b.items()},
                        "cuda") for b in tt_batches]
        g, _ = loss_grads(tmodel.loss, tstate.params, tb[0])
        tt_grads = [t.cpu() for t, path in zip(
            tree_leaves(g), mt_paths(tstate.params)) if "mlp" in path]
        del g
        tt_losses, tt_ms = [], []
        for b in tb:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tstate, m = tstep(tstate, b)
            torch.cuda.synchronize()
            tt_ms.append(1e3 * (time.perf_counter() - t0))
            tt_losses.append(float(m["loss"]))
        del tmodel, tstate, tstep, tb
        gc.collect()
        torch.cuda.empty_cache()
        t_ref = time.perf_counter() - t_phase

        # ----------------------------------------------- 4 gloo ranks
        t0 = time.perf_counter()
        ranks = spawn(mt_rank, world, backend="gloo", device="cuda:0",
                      args=(plan,), store_dir=tmp, timeout_s=MT_TIMEOUT)
        t_ranks = time.perf_counter() - t0
        need(ckpt_lib.list_steps(ckpt_dir) == [MT_CKPT],
             "the mesh wrote one checkpoint of whole arrays")
        # one device resumed from the mesh's checkpoint
        restored = ckpt_lib.elastic_restore(ckpt_dir, MT_CKPT, state)
        at_ckpt = (mt_sparse(tree_leaves(restored.params), paths, rows,
                             whole, 0),
                   mt_sparse(tree_leaves(restored.opt_state["acc"]), paths,
                             rows, whole, 0))
        one = {"losses": [], "tape": {}}
        with record_adagrad() as tape:
            for s in range(MT_CKPT + 1, MT_STEPS + 1):
                b = on_device({k: torch.from_numpy(v)
                               for k, v in batches[s - 1].items()}, "cuda")
                restored, m = step(restored, b)
                one["losses"].append(float(m["loss"]))
                _, one["lr"], one["eps"], g = tape.pop()
                one["tape"][s] = mt_sparse(g, paths, rows, whole, 0)
        one["final"] = mt_sparse(tree_leaves(restored.params), paths, rows,
                                 whole, 0)
        del model, state, step, restored
        gc.collect()
        torch.cuda.empty_cache()
        # ---------------- one NCCL rank (run with the LM mesh phase's)
        def nccl_check(nccl):
            # NCCL (1, 1): the single device's route, bit for bit
            need(nccl["losses"] == single["losses"][:MT_NCCL_STEPS]
                 and nccl["crc"] == single["crc2"],
                 "NCCL (1, 1): losses and params bit-identical to one "
                 "device")
            log(f"NCCL world 1: deepfm CONFIG {MT_NCCL_STEPS} steps on a "
                f"(1, 1) mesh bit-identical to one device (the distributed "
                f"training phase's check, {nccl['seconds']:.1f}s in the one "
                f"NCCL process)")
        defer_nccl("training", mt_nccl_rank,
                   {"batches": plan["batches"][:MT_NCCL_STEPS]}, nccl_check)
        # ------------- serve --mesh, then train --mesh, under torchrun
        t0 = time.perf_counter()
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(world), os.path.abspath(__file__),
               MESH_CLIS_FLAG, os.path.join(tmp, "cli")]
        env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
        proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                              text=True, timeout=MT_TIMEOUT)
        t_cli = time.perf_counter() - t0
        cli_steps = ckpt_lib.list_steps(os.path.join(tmp, "cli"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # -------------------------------------------------------- the bars
    r0 = ranks[0]
    split = r0["split"]
    model_ranks = ranks[:model_n]                # data index 0
    sharded = {"losses": r0["run"]["losses"], "lr": r0["run"]["lr"],
               "eps": r0["run"]["eps"],
               "tape": mt_merge([r["run"] for r in model_ranks], "tape"),
               "final": mt_merge([r["run"] for r in model_ranks], "final")}
    start_m = mt_merge(model_ranks, "start")
    for a, b in zip(mt_values(start_m), mt_values(start), strict=True):
        need(torch.equal(a, b), "the placed init is the single device's")
    forced = [max(r["run"]["forced"][k][i] for r in ranks)
              for k in range(MT_STEPS) for i in range(3)]
    need(max(forced) <= MT_TOL, f"every step on the mesh: its loss, reduced "
         f"gradients and clipped gradients within {MT_TOL} of one device's "
         f"at the same params ({max(forced):.3g})")
    gaps = mt_held("deepfm on the mesh vs one device", sharded, single,
                   start)
    for r in ranks:
        need(r["run"]["losses"] == r0["run"]["losses"],
             "every rank reports the same global losses")
        need(r["run"]["rep_crc"] == r0["run"]["rep_crc"],
             "replicated leaves bit-identical on every rank, every step")
        need(r["resumed_crc"] == r["block_crc"],
             "the same-mesh resume bit-identical to the uninterrupted run")
        need(all(r["served"]) and len(r["served"]) == len(codes_crc),
             "every trained field served through the mesh bit-identical "
             "to one device")
        need(r["launches"]["dpq_assign"] > 0
             and r["launches"]["mgqe_decode"] > 0,
             "dpq_assign and mgqe_decode launched on every rank")
    for rank in range(model_n, world):               # data replicas
        need(ranks[rank]["block_crc"] == ranks[rank % model_n]["block_crc"],
             "a row block bit-identical on every rank of its model index")
    # elastic: from the checkpoint, steps MT_CKPT+1.. on (1, 4) and on
    # one device against the uninterrupted (2, 2) run
    late = range(MT_CKPT + 1, MT_STEPS + 1)
    ref = dict(sharded, losses=sharded["losses"][MT_CKPT:],
               tape={s: sharded["tape"][s] for s in late})
    p3 = mt_merge([{"p": r["at_ckpt"][0]} for r in model_ranks], "p")
    a3 = mt_merge([{"a": r["at_ckpt"][1]} for r in model_ranks], "a")
    for a, b in zip(mt_values(p3) + mt_values(a3),
                    mt_values(at_ckpt[0]) + mt_values(at_ckpt[1]),
                    strict=True):
        need(torch.equal(a, b), "the checkpoint restores the same bits on "
             "the mesh and on one device")
    run14 = {"losses": ranks[0]["run14"]["losses"],
             "lr": ranks[0]["run14"]["lr"], "eps": ranks[0]["run14"]["eps"],
             "tape": mt_merge([r["run14"] for r in ranks], "tape"),
             "final": mt_merge([r["run14"] for r in ranks], "final")}
    gaps14 = mt_held("resumed on (1, 4)", run14, ref, p3, a3)
    gaps1 = mt_held("resumed on one device", one, ref, p3, a3)
    same_codes = sum(r0["codes_crc"][i] == c for i, c in codes_crc.items())
    # two-tower: the global softmax
    tt_gap = max(abs(a - b) / max(1.0, abs(b)) for a, b in
                 zip(r0["tt_losses"], tt_losses))
    need(len(r0["tt_losses"]) == MT_TT_STEPS and tt_gap <= MT_TOL,
         f"two-tower on the mesh: losses within {MT_TOL} of one device "
         f"({r0['tt_losses']} vs {tt_losses})")
    tt_grad_gap = 0.0
    for r in ranks:
        for g, w in zip(r["tt_grads"], tt_grads, strict=True):
            tt_grad_gap = max(tt_grad_gap, float((g - w).abs().max()))
    need(tt_grad_gap <= MT_TOL, f"two-tower: the towers' first-step "
         f"gradients within {MT_TOL} ({tt_grad_gap:.3g})")
    planted = abs(r0["tt_planted"] - tt_losses[0])
    need(planted > 1e-3, "a per-rank softmax (planted) moves the loss off "
         "one device's")
    served, _, trained = proc.stdout.partition(MESH_CLIS_MARK)
    tail = [line for line in served.splitlines()
            if line.startswith(("mesh ", "engine"))]
    log(f"serve --mesh (torchrun, {world} gloo ranks on cuda:0, the smoke "
        f"config): " + " | ".join(tail))
    need(proc.returncode == 0, "torchrun ... serve --mesh, train --mesh "
         "exits 0:\n" + proc.stdout[-4000:] + proc.stderr[-4000:])
    need(any("row-sharded x2" in line for line in tail),
         "serve --mesh printed the per-shard code bytes")
    tail = [line for line in trained.splitlines()
            if line.startswith(("step ", "done"))]
    log(f"train --mesh (torchrun, {world} gloo ranks on cuda:0, the smoke "
        f"config; in the same ranks after serve --mesh, one start for the "
        f"two): exit {proc.returncode} in {t_cli:.1f}s for both; "
        + " | ".join(tail))
    need(proc.returncode == 0 and any(line.startswith("done") for line in tail)
         and cli_steps == [2], "torchrun ... train --mesh exits 0, its "
         "checkpoint written:\n" + proc.stdout[-4000:] + proc.stderr[-4000:])

    launches = {k: fn.launches for k, fn in counters.items()}
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] += v
    wire = mt_wire_bytes(CTR_BATCH, split, mt_values(start))
    log(f"sharded deepfm CONFIG (mesh data={data_n}, model={model_n}, "
        f"{world} gloo ranks on cuda:0, B={CTR_BATCH}): {sum(split)} of "
        f"{len(split)} param leaves row-sharded; each rank's device holds "
        f"{[round(r['state_bytes'] / 1e9, 4) for r in ranks]} GB of params "
        f"and accumulators (one device: whole), peak "
        f"{[round(r['peak'] / 1e9, 4) for r in ranks]} GB above it "
        f"during the steps; init and placement "
        f"{[round(r['t_init'], 3) for r in ranks]} s; step ms by rank "
        f"{[[round(x, 3) for x in r['ms']] for r in ranks]} vs "
        f"one device {[round(x, 3) for x in single['ms']]}; wire a step per "
        f"rank {wire} bytes ({sum(wire.values()) - wire['collectives']} in "
        f"{wire['collectives']} collectives); losses "
        f"{sharded['losses']} vs one device {single['losses']}; each step "
        f"against one device at the same params (loss, reduced gradients, "
        f"clipped gradients; max over ranks) "
        f"{[float(f'{x:.3g}') for x in forced]}; against one device's own "
        f"run (step 1 barred, then adagrad's replay bars) {gaps} [{card}]")
    log(f"sharded deepfm: compressed_psum_mean (int8, error fed back) "
        f"over the replicated gradient shares on the data axis, relative "
        f"error a step by rank {[[round(x, 6) for x in r['rel']] for r in ranks]}")
    log(f"sharded deepfm: checkpoint of whole arrays at step {MT_CKPT}; "
        f"the same-mesh resume bit-identical on every rank; resumed on "
        f"(1, 4): losses {run14['losses']}, gaps {gaps14}; on one device: "
        f"losses {one['losses']}, gaps {gaps1} (the uninterrupted run "
        f"{ref['losses']}); the trained tables of {len(codes_crc)} mgqe "
        f"fields exported and served through ServingEngine(mesh) "
        f"bit-identical to one device on every rank "
        f"({[round(r['t_serve'], 2) for r in ranks]} s); their codes "
        f"equal to the one-device run's export in {same_codes} of "
        f"{len(codes_crc)} fields")
    log(f"sharded two-tower ({MT_TT_ROWS} users and items of CONFIG's "
        f"{tt_full.n_users}/{tt_full.n_items}, d={tcfg.embed_dim}, towers "
        f"{tcfg.tower_mlp}): each rank's device holds "
        f"{[round(r['tt_state_bytes'] / 1e9, 4) for r in ranks]} GB, peak "
        f"{[round(r['tt_peak'] / 1e9, 4) for r in ranks]} GB; step ms by "
        f"rank {[[round(x, 3) for x in r['tt_ms']] for r in ranks]} vs one "
        f"device {[round(x, 3) for x in tt_ms]}; losses {r0['tt_losses']} "
        f"vs {tt_losses} (gap {tt_gap:.3g}), the towers' first-step "
        f"gradients within {tt_grad_gap:.3g}; a per-rank softmax "
        f"(planted) {r0['tt_planted']:.6f} vs {tt_losses[0]:.6f}")
    log(f"distributed training phase {time.perf_counter() - t_phase:.1f}s "
        f"(one device's references {t_ref:.1f}s, 4 ranks {t_ranks:.1f}s, "
        f"torchrun {t_cli:.1f}s; its NCCL check runs with the LM mesh "
        f"phase's); launches {launches}")
    return launches


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
    from repro_torch.roofline import op_roofline
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
    nnz = ids.numel()
    r = op_roofline("embedding_bag", table, ids, seg, b, w)
    nbytes, ops = r["bytes"], r["flops"]
    log(f"time embedding_bag {what} V={v} d={d} B={b} nnz={nnz} "
        f"{table.dtype} {'weighted' if w is not None else 'unweighted'} "
        f"(plan: tile {plan.tile} bags, chunk {plan.chunk} ids, grid "
        f"{plan.grid_x}x{plan.grid_y}, {plan.smem} bytes of shared memory; "
        f"longest bag {int(torch.bincount(seg).max()) if nnz else 0}): "
        f"kernel {ms:.5f} "
        f"ms, plain {plain:.5f} ms, F.embedding_bag {lib:.5f} ms (max |diff| "
        f"to the kernel {lib_err:.3g}), bound {r['bound_ms']:.5f} ms by "
        f"{r['bound_by']} ({nbytes} bytes, {ops} "
        f"operations); host time to launch: wrapper {host:.5f} ms")
    return {"ms": ms, "plain_ms": plain, "library_ms": lib,
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"]}


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
    batch = next(recsys_stream(run.cfg, CTR_BATCH, start=TRAIN_STEPS))
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


def resume_gap(arch: str, planted=None, **train_kw) -> tuple:
    """``arch`` (its smoke config unless ``train_kw`` says otherwise)
    trained 5 steps with a checkpoint every 2, failed at step 3, resumed,
    against an uninterrupted run: (largest final param gap,
    bit-identical, the gap of a resume under the ``planted`` fault's
    context manager, or None)."""
    import shutil

    import torch
    from repro_torch.core.schemes.base import tree_leaves
    from repro_torch.launch.train import train
    from repro_torch.train.resilience import SimulatedFailure

    ckpt_dir = os.path.join(REPO, "build", f"chip_smoke_ckpt_{arch}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    kw = dict(dict(smoke=True, steps=TRAIN_STEPS, batch=CHECK_BATCH,
                   log_every=1), **train_kw)
    try:
        train(arch, ckpt_dir=ckpt_dir, ckpt_every=2, fail_at=3, **kw)
        failed = False
    except SimulatedFailure:
        failed = True
    need(failed, "--fail-at 3 stops the run")

    def final_gap(run, other):
        return max(float((a.float() - b.float()).abs().max()) for a, b in
                   zip(tree_leaves(run.state.params),
                       tree_leaves(other.state.params)))
    bad_run = None
    if planted is not None:
        with planted():             # writes no checkpoint of its own
            bad_run = train(arch, ckpt_dir=ckpt_dir, **kw)
    # restored from the step-2 checkpoint; it writes none of its own
    resumed = train(arch, ckpt_dir=ckpt_dir, **kw)
    whole = train(arch, **kw)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    need([h["step"] for h in resumed.history] == [3, 4, 5],
         "the resumed run starts from the step-2 checkpoint")
    pairs = list(zip(tree_leaves(resumed.state.params),
                     tree_leaves(whole.state.params)))
    gap = final_gap(resumed, whole)
    same = all(torch.equal(bits(a), bits(b)) for a, b in pairs)
    bad = None if bad_run is None else final_gap(bad_run, whole)
    log(f"train resume ({arch}): failed at step 3, resumed from step 2 to "
        f"{int(resumed.state.step)}; final params against an uninterrupted "
        f"run: largest gap {gap:.3g}, bit-identical={same}")
    need(gap <= TRAIN_PARAM_TOL, "the resumed run's params == the "
         "uninterrupted run's")
    return gap, same, bad


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
            gap, same, _ = resume_gap(arch)
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
    results = {arch: resume_gap(arch)[:2] for arch in RESUME_ARCHS}
    for arch, (gap, same) in results.items():
        need(same, f"{arch}: a resumed run is bit-identical to an "
             f"uninterrupted one under the default algorithms (row_gather's "
             f"backward is a sorted index_put_)")
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
    from repro_torch.roofline import op_roofline

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
        r = op_roofline("mgqe_decode", codes, cent)
        nbytes, bound = r["bytes"], r["bound_ms"]
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
    from repro_torch.roofline import op_roofline

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
            bound, by, flops, nbytes = assign_bound([(e, lim)], cent)
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
        r = op_roofline("mgqe_decode", codes, cent)
        nbytes, bound = r["bytes"], r["bound_ms"]
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
    """dpq_assign at the LM token tables' widths (D=8, S = d_model / 8:
    256 for qwen3-moe-30b-a3b, 320 for gemma3-4b, 512 for mixtral-8x7b,
    672 for gemma3-27b), K=256 and K=64, with the MGQE budgets, float32
    and bfloat16, against the plain assignment; returns the largest
    distance gap."""
    import torch
    from repro_torch.kernels.dpq_assign import dpq_assign
    gap = 0.0
    for s in (256, 320, 512, 672):
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


@contextlib.contextmanager
def window_short_by_a_tile(layers: int):
    """A planted fault: inside the block, the first ``layers`` layers
    with a window below the full one reach ``chunked_attention`` with
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
def gate_unnormalised(layers: int):
    """A planted fault: inside the block, the first ``layers`` MoE
    layers weight their top-k experts by the router's probabilities as
    they are, not renormalised to sum to 1."""
    import torch
    from repro_torch.nn import moe
    sound = moe.route
    left = [layers]

    def faulty(xt, router, top_k):
        gate_w, gate_i, probs = sound(xt, router, top_k)
        if left[0] > 0:
            left[0] -= 1
            gate_w = torch.gather(probs, 1, gate_i)
        return gate_w, gate_i, probs
    moe.route = faulty
    try:
        yield
    finally:
        moe.route = sound


def planted_fault(cfg) -> tuple:
    """(name, context manager planting it on the first n layers it
    reaches, whether it reaches a layer of a given window): the window
    one KV tile short where layers are windowed; else (qwen3: every
    layer global, so a window fault would change nothing) the MoE gate
    left unnormalised."""
    if cfg.sliding_window is not None:
        return ("the window one KV tile short", window_short_by_a_tile,
                lambda window: window < FULL_WINDOW)
    need(cfg.is_moe, f"{cfg.name}: a planted fault that reaches its layers")
    return ("the gate weights unnormalised", gate_unnormalised,
            lambda window: True)


@contextlib.contextmanager
def plain_route(f32: bool = False):
    """The plain route: every op pinned to its plain version, the
    attention's (``flash_attention_ref``) called one KV-head group at a
    time.  Heads are independent, so it is the same function; a whole
    call's dense (B, H, S, S) float32 scores and their temporaries would
    not fit beside the 27B-56B models' weights.  ``f32``: the attention
    computed in float32 on the same bf16 inputs (scores and P
    unrounded), its output rounded once to bf16."""
    import torch
    from repro_torch.kernels.dispatch import pinned_backend
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.nn import attention as attn
    sound = attn.chunked_attention

    def by_group(q, k, v, qpos, kpos, window=attn.FULL_WINDOW, **kw):
        hkv = k.shape[2]
        g = q.shape[2] // hkv
        outs = []
        for i in range(hkv):
            part = (q[:, :, i * g:(i + 1) * g], k[:, :, i:i + 1],
                    v[:, :, i:i + 1])
            if f32:
                part = tuple(t.float() for t in part)
            outs.append(flash_attention_ref(*part, int(window)).to(q.dtype))
        return torch.cat(outs, dim=2)
    attn.chunked_attention = by_group
    try:
        with pinned_backend("torch"):
            yield
    finally:
        attn.chunked_attention = sound


@contextlib.contextmanager
def recording_routes(into: list):
    """Inside the block every MoE layer's routed expert ids (T, k) are
    appended to ``into``."""
    from repro_torch.nn import moe
    sound = moe.moe_ffn

    def recorded(params, x, *, top_k, capacity_factor=1.25, **kw):
        into.append(moe.route(x.reshape(-1, x.shape[-1]), params["router"],
                              top_k)[1])
        return sound(params, x, top_k=top_k, capacity_factor=capacity_factor,
                     **kw)
    moe.moe_ffn = recorded
    try:
        yield
    finally:
        moe.moe_ffn = sound


@contextlib.contextmanager
def pinned_routes(ids: list):
    """Inside the block the MoE layers take, one after another, the
    expert ids of ``ids`` (a (T, k) tensor a layer) in place of their own
    top-k; the gate weights are the layer's own router probabilities at
    those experts, renormalised as ``route`` does."""
    import torch
    from repro_torch.nn import moe
    sound = moe.route
    layers = iter(ids)

    def pinned(xt, router, top_k):
        _, _, probs = sound(xt, router, top_k)
        gate_i = next(layers)
        gate_w = torch.gather(probs, 1, gate_i)
        gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
        return gate_w, gate_i, probs
    moe.route = pinned
    try:
        yield
    finally:
        moe.route = sound


def lm_statistics(run, cfg, fault) -> dict:
    """The whole prefill on the kernel route (sound, and with the
    planted fault on the first layer it reaches and on every layer)
    against two plain routes (bf16 attention; attention in f32 on the
    same inputs), read on the last-token logits and on every position's
    final hidden state, max and mean |diff|.  An MoE arch's plain
    routes run also with their experts pinned to the sound kernel
    route's choices: a near-tied router flips between the routes on
    bf16 noise, and one flip on the last token's path moves its logits
    by far more than the noise.  Returns {statistic: (sound, fault on 1
    layer, fault on every layer)} for each plain route, the planted
    runs' last-token logits and the reference's: the plain
    f32-attention route, with pinned experts for an MoE arch."""
    import torch
    from repro_torch.models import lm
    name, planted, _ = fault

    def hidden():
        with torch.no_grad():
            return lm.forward(run.params, run.prompts, cfg,
                              embed_artifact=run.artifact)[0]

    def logits(h):
        return (h[:, -1] @ run.params["lm_head"].to(h.dtype)).float()

    kernel_ids = []
    with recording_routes(kernel_ids):
        routes = {"sound": hidden()}
    for layers in (1, cfg.num_layers):
        with planted(layers):
            routes[layers] = hidden()
    refs = {}
    for ref_name, f32 in (("plain bf16", False), ("plain f32", True)):
        with plain_route(f32):
            refs[ref_name] = hidden()
    reference = "plain f32"
    if cfg.is_moe:
        reference = "plain f32, experts pinned"
        with plain_route(True), pinned_routes(kernel_ids):
            refs[reference] = hidden()
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
                log(f"lm statistic {cfg.name} against the {ref_name} route, "
                    f"{stat} |diff| of the {of}: sound {vals[0]:.5g}, "
                    f"{name} on the first layer it reaches {vals[1]:.5g} "
                    f"({vals[1] / max(vals[0], 1e-30):.2f}x), on every "
                    f"layer {vals[2]:.5g} "
                    f"({vals[2] / max(vals[0], 1e-30):.2f}x)")
    out["planted logits"] = {layers: logits(routes[layers])
                             for layers in (1, cfg.num_layers)}
    out["plain logits"] = logits(refs[reference])
    del routes, refs
    return out


def lm_layer_statistics(run, cfg, fault) -> dict:
    """Each layer of the prefill fed the plain route's input to that
    layer (its output on the plain route as the reference), so that
    bf16 noise does not build up from layer to layer: the largest over
    the layers of the mean |diff| of a layer's output, for the kernel
    route (sound, and with the planted fault on the first layer it
    reaches and on every layer) against the plain bf16 and the plain
    f32-attention routes; one layer at a time, so nothing of the other
    layers is kept.  For an MoE arch also the route flips: the (layer,
    token, choice) slots whose expert differs between the kernel route
    and the plain route from the same layer input.  Returns {statistic:
    (sound, fault on 1 layer, fault on every layer)} and the flips."""
    import torch
    from repro_torch.core import Embedding
    from repro_torch.core.schemes.base import torch_dtype
    from repro_torch.models import lm
    name, planted, reaches = fault

    dtype = torch_dtype(cfg.dtype)
    s = run.prompts.shape[1]
    device = run.prompts.device
    positions = torch.arange(s, dtype=torch.int32, device=device)
    plan = [(lm._index(run.params[n], *idx), window, theta)
            for n, idx, window, theta in lm._layer_plan(cfg, s)]
    first = next(i for i, (_, w, _) in enumerate(plan) if reaches(w))

    def layer(p, x, window, theta):
        return lm.layer_forward(p, x, positions, window, theta, cfg)[0]

    def mean_diff(a, b):
        return float((a.float() - b.float()).abs().mean())

    out = {}
    with torch.no_grad():
        x0 = Embedding(cfg.embedding, device=device).serve(run.artifact,
                                                           run.prompts)
        x0 = x0.to(dtype) * torch.tensor(cfg.d_model ** 0.5, dtype=dtype)
        for ref_name, f32 in (("plain bf16", False), ("plain f32", True)):
            sound, bad = [], []
            flips = slots = 0
            x = x0
            for p, window, theta in plan:
                plain_ids, kernel_ids = [], []
                with plain_route(f32), recording_routes(plain_ids):
                    ref = layer(p, x, window, theta)
                with recording_routes(kernel_ids):
                    sound.append(mean_diff(layer(p, x, window, theta), ref))
                if reaches(window):
                    with planted(1):
                        bad.append(mean_diff(layer(p, x, window, theta),
                                             ref))
                else:
                    bad.append(sound[-1])
                for a, b in zip(plain_ids, kernel_ids):
                    flips += int((a != b).sum())
                    slots += a.numel()
                x = ref
            one = [bad[i] if i == first else v for i, v in enumerate(sound)]
            vals = (max(sound), max(one), max(bad))
            out[(ref_name, "layer", "mean")] = vals
            out[(ref_name, "flips")] = (flips, slots)
            log(f"lm statistic {cfg.name} against the {ref_name} route, each "
                f"layer fed that route's input: the largest mean |diff| of "
                f"a layer's output: sound {vals[0]:.5g} (layer "
                f"{sound.index(vals[0])}), {name} on layer {first} "
                f"{vals[1]:.5g} ({vals[1] / max(vals[0], 1e-30):.2f}x), on "
                f"every layer {vals[2]:.5g} "
                f"({vals[2] / max(vals[0], 1e-30):.2f}x); route flips "
                f"{flips} of {slots} (layer, token, choice) slots; sound per "
                f"layer {[round(v, 5) for v in sound]}; faulted per layer "
                f"{[round(v, 5) for v in bad]}")
    return out


def lm_decode_bytes(run, cfg, b: int, max_seq: int) -> int:
    """The bytes one decode step must read: every weight but the token
    table (served from its artifact) and the whole KV cache (the
    capacity formulation runs every expert, so an MoE step reads all
    its experts' weights even at B = 2)."""
    from repro_torch.core.schemes.base import tree_leaves
    from repro_torch.models import lm
    weights = sum(t.numel() * t.element_size()
                  for name, tree in run.params.items() if name != "embed"
                  for t in tree_leaves(tree))
    cache = lm.make_cache(cfg, b, max_seq, device="meta")
    return weights + sum(t.numel() * t.element_size()
                         for name, leaves in cache.items() if name != "pos"
                         for t in leaves)


def check_served_table(run, ecfg, emb) -> tuple:
    """An LM run's served token rows (``mgqe_decode``) held bit-identical
    to the plain decode, and the exported codes (``dpq_assign``) of a
    head, a tier-boundary and a tail slice (the whole table where it is
    under two slices) to the plain assignment under their budgets.
    Returns (the largest distance gap of a code that differs, codes that
    differ)."""
    import torch
    from repro_torch.core.mgqe import k_limit_for_all_rows
    from repro_torch.kernels.dispatch import pinned_backend

    # the token rows: the served decode against the plain decode
    rows = emb.serve(run.artifact, run.prompts)
    with pinned_backend("torch"):
        rows_plain = emb.serve(run.artifact, run.prompts)
    torch.cuda.synchronize()
    need(torch.equal(bits(rows), bits(rows_plain)),
         "token rows == the plain decode, bit for bit")
    del rows, rows_plain
    # the exported codes of a head, a tier-boundary and a tail slice
    # (the whole table where it is under two slices), under their budgets
    lim_all = k_limit_for_all_rows(ecfg, "cuda")
    n_rows = min(ASSIGN_BATCH, ecfg.vocab_size)
    head = ecfg.tier_boundaries[0]
    gap, mism = 0.0, 0
    for lo in sorted({0, min(max(head - n_rows // 8, 0),
                             ecfg.vocab_size - n_rows),
                      ecfg.vocab_size - n_rows}):
        sl = slice(lo, lo + n_rows)
        e = run.params["embed"]["emb"][sl].reshape(
            n_rows, ecfg.num_subspaces, -1)
        cent = run.artifact["centroids"]
        got = run.artifact["codes"][sl].to(torch.int32)
        want_codes = blocked_assign_ref_lim(e, cent, lim_all[sl])
        mism += int((got != want_codes).sum())
        gap = max(gap, assign_gap(e, cent, lim_all[sl], got, want_codes))
    need(gap <= ASSIGN_TOL, f"exported codes within {ASSIGN_TOL} of the "
         f"plain assignment")
    need(int(run.artifact["codes"][head:].max())
         < ecfg.tier_num_centroids[1], "tail tier codes < K_tail")
    return gap, mism


def lm_path(arch: str, batch: int, prompt: int, layers) -> tuple:
    """``arch``'s ``CONFIG`` (``layers``: its depth cut to that many)
    through ``launch.serve.serve_lm``: init, MGQE export of the token
    table, prefill of ``batch`` prompts of ``prompt`` tokens, LM_STEPS
    greedy decode steps, the counts set to 0 just before and read just
    after; then the token rows held bit-identical to the plain decode,
    the exported codes of a head, a tier-boundary and a tail slice to
    the plain assignment, the export's launches timed on the served
    table, the last-token logits and each layer to the plain route (a
    planted fault must fail both), one prefill and one decode step
    profiled.  Returns (launches, the largest distance gap of the
    export's codes, flash_attention's (shape, launches) on the path)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core import Embedding
    from repro_torch.core.mgqe import k_limit_for_all_rows
    from repro_torch.core.schemes.base import torch_dtype
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import lm
    from repro_torch.roofline import HBM_BW, lm_prefill_flops, peak_flops

    t_phase = time.perf_counter()
    _, cfg = get_arch(arch, smoke=False)
    full_layers = cfg.num_layers
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    ecfg = cfg.embedding
    max_seq = prompt + LM_STEPS
    fault = planted_fault(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counts()
    t0 = time.perf_counter()
    run = serve_lm(cfg, batch, prompt, LM_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    emb = Embedding(dataclasses.replace(ecfg, param_dtype=cfg.param_dtype))
    full_bits = run.params["embed"]["emb"].numel() * \
        run.params["embed"]["emb"].element_size() * 8
    want = {"dpq_assign": -(-ecfg.vocab_size // ASSIGN_BATCH),
            "mgqe_decode": 1 + LM_STEPS, "flash_attention": cfg.num_layers}
    flops = lm_prefill_flops(cfg, batch, prompt)
    prefill_bound = flops / peak_flops("bfloat16")
    step_bytes = lm_decode_bytes(run, cfg, batch, max_seq)
    step_bound = step_bytes / HBM_BW
    step_s = run.decode_seconds / LM_STEPS
    weight_gib = (cfg.param_count() * torch_dtype(cfg.param_dtype).itemsize
                  / 2**30)
    cut = (f"; depth cut from {full_layers} to {cfg.num_layers} layers "
           f"({full_layers} layers of bfloat16 weights do not fit one card)"
           if layers else "")
    log(f"lm path: {cfg.name} {cfg.num_layers} layers d_model "
        f"{cfg.d_model} heads {cfg.num_heads}/{cfg.num_kv_heads} hd "
        f"{cfg.resolved_head_dim} d_ff {cfg.d_ff}"
        + (f" experts {cfg.num_experts} top-{cfg.num_experts_per_tok}"
           if cfg.is_moe else "")
        + f" window {cfg.sliding_window}{cut}, {cfg.param_count()} params "
        f"({cfg.param_dtype}, {weight_gib:.1f} GiB), "
        f"vocab {ecfg.vocab_size} as MGQE (head tier "
        f"{ecfg.tier_boundaries[0]} rows at K={ecfg.tier_num_centroids[0]}, "
        f"tail at K={ecfg.tier_num_centroids[1]}, D={ecfg.num_subspaces}); "
        f"artifact {emb.serving_size_bits() / 8e6:.2f} MB "
        f"({100 * emb.serving_size_bits() / full_bits:.2f}% of full); "
        f"init + export + prefill + decode in {wall:.3f}s; prefill B={batch} "
        f"x {prompt} in {run.prefill_seconds:.6f}s "
        f"({batch * prompt / run.prefill_seconds:,.0f} tokens/s; bound "
        f"{prefill_bound * 1e3:.3f} ms: {flops} FLOP at 989 TFLOP/s, "
        f"{batch * prompt / prefill_bound:,.0f} tokens/s); {LM_STEPS} decode "
        f"steps in {run.decode_seconds:.6f}s ({run.tokens_per_s:.2f} "
        f"tokens/s, {step_s * 1e3:.3f} ms a step; bound "
        f"{step_bound * 1e3:.3f} ms: {step_bytes} bytes of weights and KV "
        f"cache at 3.35 TB/s); peak device memory {peak:.3f} GiB; launches "
        f"{launches} (predicted {want})")
    for name, n in want.items():
        need(launches[name] == n, f"{name} launched {n} times on the "
             f"{cfg.name} path")
    need(sum(launches.values()) == sum(want.values()),
         f"no other kernel on the {cfg.name} path")
    need(tuple(run.logits.shape) == (batch, cfg.vocab_size)
         and bool(torch.isfinite(run.logits).all()),
         "prefill logits (B, V), finite")
    need(tuple(run.tokens.shape) == (batch, LM_STEPS + 1)
         and bool(((run.tokens >= 0) & (run.tokens < cfg.vocab_size)).all()),
         "greedy tokens (B, steps + 1) in the vocabulary")
    need(all(t.dtype == torch.bfloat16 for t in
             (run.params["lm_head"], run.params["embed"]["emb"],
              run.artifact["centroids"])) == (cfg.param_dtype == "bfloat16"),
         f"{cfg.name}'s weights, table and centroids in {cfg.param_dtype}")

    gap, mism = check_served_table(run, ecfg, emb)
    lim_all = k_limit_for_all_rows(ecfg, "cuda")
    # the export's dpq_assign launches, timed on the table it exported
    time_assign_pass(f"over {cfg.name}'s export (the served table)",
                     run.params["embed"]["emb"].reshape(
                         ecfg.vocab_size, ecfg.num_subspaces, -1),
                     run.artifact["centroids"], lim_all, ASSIGN_BATCH)
    del lim_all

    # the last-token logits against the plain route's; the kernel route
    # with the planted fault (on the first layer it reaches, and on
    # every layer) must fail that check where LM_BARS says it can
    logit_tol, layer_tol, logits_see_fault = LM_BARS[arch]
    stats = lm_statistics(run, cfg, fault)
    logits_plain = stats.pop("plain logits")
    planted_logits = stats.pop("planted logits")

    def against_plain(logits):
        d = (logits - logits_plain).abs()
        pick = logits_plain.gather(-1, logits.argmax(-1)[:, None])[:, 0]
        return (float(d.max()), float(d.mean()),
                bool(torch.equal(logits.argmax(-1), logits_plain.argmax(-1))),
                bool((pick >= logits_plain.amax(-1) - logit_tol).all()))
    err, mean_err, top1, top1_near = against_plain(run.logits)
    planted = {n: against_plain(x) for n, x in planted_logits.items()}
    log(f"lm checks {cfg.name}: token rows bit-identical to the plain "
        f"decode; exported codes (head, tier-boundary and tail slices, "
        f"{mism} codes differ) within {gap:.3g} of the plain assignment; "
        f"last-token logits against the plain f32-attention route"
        f"{' with its experts pinned to the kernel route' if cfg.is_moe else ''}: max "
        f"|diff| {err:.4g} (bar {logit_tol}), mean |diff| {mean_err:.4g}, "
        f"largest |logit| {float(logits_plain.abs().max()):.4g}, top-1 "
        f"tokens equal: {top1}, the kernel's pick within the bar of the "
        f"plain route's best: {top1_near}; the kernel route with "
        f"{fault[0]} (max |diff|, mean |diff|, top-1 equal, within the "
        f"bar): on the first layer it reaches {planted[1]}, on every "
        f"layer {planted[cfg.num_layers]}; sample tokens "
        f"{run.tokens[0, :8].tolist()}")
    need(top1_near, f"{cfg.name} prefill top-1 tokens == the plain "
         f"route's, or within {logit_tol} of its best logit")
    need(err <= logit_tol, f"{cfg.name} prefill logits within "
         f"{logit_tol} of the plain route's")
    if logits_see_fault:
        for n, (bad, _, _, bad_near) in planted.items():
            need(bad > logit_tol or not bad_near, f"{fault[0]} on {n} "
                 f"layer(s) fails the logits check ({cfg.name})")
    stats.update(lm_layer_statistics(run, cfg, fault))
    sound, *faults = stats[("plain f32", "layer", "mean")]
    need(sound <= layer_tol, f"every {cfg.name} prefill layer within "
         f"{layer_tol} (mean |diff|) of the plain route's, from the "
         f"same input")
    for n, bad in zip((1, cfg.num_layers), faults):
        need(bad > layer_tol, f"{fault[0]} on {n} layer(s) fails the "
             f"per-layer check ({cfg.name})")
    del logits_plain, planted_logits

    # where the time goes: one prefill and one decode step, profiled
    with torch.no_grad():
        profile_phase(f"{cfg.name} prefill (B={batch} x {prompt})",
                      lambda: lm.prefill(run.params, run.prompts, cfg,
                                         max_seq=max_seq,
                                         embed_artifact=run.artifact))
        cache, _ = lm.prefill(run.params, run.prompts, cfg, max_seq=max_seq,
                              embed_artifact=run.artifact)
        tok = run.tokens[:, 0]
        profile_phase(f"{cfg.name} decode step (B={batch})",
                      lambda: lm.decode_step(run.params, cache, tok, cfg,
                                             embed_artifact=run.artifact))
    shapes = {}
    for _, _, window, _ in lm._layer_plan(cfg, prompt):
        key = (cfg.name, batch, prompt, cfg.num_heads, cfg.num_kv_heads,
               cfg.resolved_head_dim, min(window, FULL_WINDOW))
        shapes[key] = shapes.get(key, 0) + 1
    del run, cache
    phase_peak = torch.cuda.max_memory_allocated() / 2**30
    gc.collect()
    torch.cuda.empty_cache()
    log(f"lm phase {cfg.name}: {time.perf_counter() - t_phase:.1f}s; peak "
        f"device memory over the phase (its checks included) "
        f"{phase_peak:.3f} GiB")
    return launches, gap, shapes


def sdpa_backend(fn) -> str:
    """The backend one ``scaled_dot_product_attention`` call took, named
    from the profiler's aten ops (the dispatcher picks among flash,
    efficient, cuDNN and math without saying which), and the first
    kernels it ran."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    ops = " ".join(ev.key for ev in events
                   if ev.device_type != DeviceType.CUDA).lower()
    kernels = sorted({ev.key for ev in events
                      if ev.device_type == DeviceType.CUDA})
    kind = ("cuDNN" if "cudnn_attention" in ops else
            "flash" if "flash_attention" in ops else
            "efficient (cutlass fmha)" if "efficient_attention" in ops
            else "math (matmuls and softmax)")
    return f"{kind}: {[n[:60] for n in kernels][:4]}"


def time_flash(err: float, launches: int, shapes: dict) -> dict:
    """flash_attention timed at every layer shape of the LM paths' prefills
    (bf16), beside its plain version, one
    ``F.scaled_dot_product_attention`` call and its bound; the
    ``kernels`` entry holds the mean per launch over the paths' layers
    (``shapes``: (arch, B, S, H, Hkv, hd, window) -> layers)."""
    from repro_torch.kernels.flash_attention.ops import visible_pairs
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.roofline import op_roofline
    times = {}
    for key, count in shapes.items():
        # (arch, B, S, H, Hkv, hd, window[, dtype name]): bf16 unless named
        arch, b, s, h, hkv, hd, win, *dtype = key
        dtype = getattr(torch, dtype[0]) if dtype else torch.bfloat16
        q, k, v = flash_inputs(b, s, s, h, hkv, hd, dtype,
                               seed=hd + win % 997)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        pos = torch.arange(s, device="cuda")
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
        pairs = visible_pairs(s, win) * b * h
        r = op_roofline("flash_attention", q, k, v, window=win)
        flops, nbytes = r["flops"], r["bytes"]
        times[key] = (ms, plain, lib_ms, r["bound_ms"], r["bound_by"])
        log(f"time flash_attention {arch} layer x{count} B={b} S={s} H={h} "
            f"Hkv={hkv} hd={hd} window={win} {dtype}: kernel {ms:.5f} ms, "
            f"plain {plain:.5f} ms, F.scaled_dot_product_attention "
            f"{lib_ms:.5f} ms ({sdpa_backend(lib)}; max |diff| to the "
            f"plain version {lib_err:.3g}), bound {r['bound_ms']:.5f} "
            f"ms ({flops} FLOP over {pairs} visible pairs at "
            f"{989 if dtype == torch.bfloat16 else 67} TFLOP/s, "
            f"{nbytes} bytes); {flops / ms / 1e9:.2f} TFLOP/s; host time to "
            f"launch {host:.5f} ms; the kernel at block_k 32 / 64: "
            f"{other[32]:.5f} / {other[64]:.5f} ms")
        del q, k, v, qt, kt, vt, band
        gc.collect()
        torch.cuda.empty_cache()
    total = sum(shapes.values())
    need(total == launches, "every flash_attention launch of the LM paths "
         "has its shape timed")

    def mean(i):
        return sum(times[key][i] * n for key, n in shapes.items()) / total

    log(f"time flash_attention per launch over the LM paths' {total} "
        f"layers: kernel {mean(0):.5f} ms, plain {mean(1):.5f} ms, library "
        f"{mean(2):.5f} ms, bound {mean(3):.5f} ms")
    by = {}
    for key, n in shapes.items():
        by[times[key][4]] = by.get(times[key][4], 0) + n
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/"
                        "flash_attention.py:81",
            "launches": launches, "max_abs_err": err,
            "ms": mean(0), "plain_ms": mean(1), "bound_ms": mean(3),
            "bound_by": max(by, key=by.get), "library_ms": mean(2)}


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
    from repro_torch.roofline import op_roofline
    b, d, k = luts.shape
    n = codes.shape[0]
    src = "src/repro_torch/kernels/csrc/pq_score.cu"
    tpu = "src/repro/kernels/pq_score/pq_score.py"
    offs = (codes.long() + torch.arange(d, device="cuda") * k).contiguous()
    table = luts.permute(1, 2, 0).reshape(d * k, b).contiguous()
    lut1 = luts[0].contiguous()
    table1 = lut1.reshape(d * k, 1).contiguous()

    out = []
    cases = [
        ("pq_score", 62, lambda: pq_score(lut1, codes),
         lambda: pq_score_ref(lut1, codes),
         lambda: F.embedding_bag(offs, table1, mode="sum"),
         op_roofline("pq_score", lut1, codes), 1),
        ("pq_score_batched", 93, lambda: pq_score_batched(luts, codes),
         lambda: pq_score_batched_ref(luts, codes),
         lambda: F.embedding_bag(offs, table, mode="sum"),
         op_roofline("pq_score_batched", luts, codes), b),
        ("pq_topk", 146, lambda: pq_topk(luts, codes, TOPK),
         lambda: pq_topk_ref(luts, codes, TOPK), None,
         op_roofline("pq_topk", luts, codes, TOPK), b),
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
    r465 = op_roofline("pq_score_batched", luts465, codes)
    log(f"time pq_score_batched N={n} B=465 D={d} K={k}: kernel {r_ms:.5f} "
        f"ms, bound {r465['bound_ms']:.5f} ms by {r465['bound_by']}")
    del luts465
    for name, line, kern, plain_fn, lib_fn, r, bb in cases:
        ms, host = time_ms(kern, iters=20, warmup=2)
        plain, _ = time_ms(plain_fn, iters=3, warmup=1, hold=False)
        lib = None
        if lib_fn is not None:
            lib, _ = time_ms(lib_fn, iters=20, warmup=2)
        t, by, nbytes, ops = (r["bound_ms"], r["bound_by"], r["bytes"],
                              r["flops"])
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
    from repro_torch.roofline import op_roofline
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
    r = op_roofline("pq_score_batched", luts, codes)
    nbytes = r["bytes"]
    log(f"time pq_score_batched at the ivf search (nprobe="
        f"{index.cfg.nprobe}: {len(uniq)} unique lists) N={n} B={b} D={d} "
        f"K={k}: kernel {ms:.5f} ms, plain {plain:.5f} ms, library "
        f"{lib:.5f} ms (F.embedding_bag), bound {r['bound_ms']:.5f} ms by "
        f"{r['bound_by']} ({nbytes} bytes); "
        f"held bit-identical to the plain version")


def ivf_scale_corpus(n_queries: int):
    """The JAX bench's retrieval-scale corpus at IVF_ROWS rows (host
    numpy) and ``n_queries`` queries: the one the dry run's child drew
    beside the earlier phases (:func:`dry_rows`), or drawn here."""
    from repro_torch.data.synthetic import pq_clustered_corpus
    from repro_torch.retrieval import suggest_nlist
    if "proc" in _DRY and n_queries in IVF_CORPUS_QUERIES:
        dry_rows()
        return _DRY["corpus"].pop(n_queries)
    return pq_clustered_corpus(
        n=IVF_ROWS, d=IVF_DIM, num_subspaces=IVF_SUB, n_queries=n_queries,
        n_clusters=min(2048, suggest_nlist(IVF_ROWS)), cluster_zipf_a=1.3)


def ivf_scale_config():
    """The JAX bench's ``bench_retrieval_scale`` index at IVF_ROWS rows,
    probed at the widest of IVF_NPROBES."""
    from repro_torch.retrieval import IndexConfig, suggest_nlist
    n = IVF_ROWS
    return IndexConfig(kind="ivf_pq", num_subspaces=IVF_SUB,
                       num_centroids=IVF_K, iters=10, coarse_iters=10,
                       nlist=suggest_nlist(n, max(IVF_NPROBES)),
                       nprobe=max(IVF_NPROBES),
                       train_sample=min(n, IVF_BLOCK),
                       encode_block=min(n, IVF_BLOCK), list_cap_quantile=0.9)


def ivf_scale_phase() -> dict:
    """The JAX bench's retrieval scale on the card (IVF_* above): the
    streamed build from a host corpus, the nprobe sweep on the device and
    host-staged, both scoring routes at the widest probe; checks and
    gates as in the module docstring.  Returns the launches of its two
    counted runs (the build, the searches)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.kernels.pq_score import INVALID_ID
    from repro_torch.launch.engine import RetrievalEngine
    from repro_torch.retrieval import build_ivf_artifact, get_index

    t_phase = time.perf_counter()
    n, k, b = IVF_ROWS, TOPK, TT_QUERIES
    t0 = time.perf_counter()
    vecs, q_np = ivf_scale_corpus(b)
    gen_s = time.perf_counter() - t0
    cfg = ivf_scale_config()
    nlist = cfg.nlist
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
    queries/s beside phase 16's flat_pq; every flush bit-identical to the
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


# ----------------------------------------------------------------------
# LM training: stablelm-3b at full width, qwen3-moe-30b-a3b at a depth
# cut, and the checks of the training path
# ----------------------------------------------------------------------

def lm_train_seq() -> int:
    """The training sequence: ``train_4k``'s (``configs/base.py::LM_SHAPES``)."""
    from repro_torch.configs.base import LM_SHAPES
    return next(s for s in LM_SHAPES if s.name == "train_4k").seq_len


@contextlib.contextmanager
def forced_window(window: int):
    """A planted fault: inside the block, every layer's
    ``chunked_attention`` runs with ``window`` in place of its own."""
    from repro_torch.nn import attention as attn
    sound = attn.chunked_attention

    def faulty(q, k, v, qpos, kpos, _window=attn.FULL_WINDOW, **kw):
        return sound(q, k, v, qpos, kpos, window, **kw)
    attn.chunked_attention = faulty
    try:
        yield
    finally:
        attn.chunked_attention = sound


@contextlib.contextmanager
def recompute_other_window(local: int):
    """A planted fault: inside the block, ``attend``'s backward
    recomputes with the other kind of layer's window (``local`` for a
    global layer, the full window for a local one)."""
    from repro_torch.kernels.flash_attention import ops
    sound = ops.attention_vjp

    def faulty(q, k, v, window, grad_out):
        return sound(q, k, v, local if window >= FULL_WINDOW
                     else FULL_WINDOW, grad_out)
    ops.attention_vjp = faulty
    try:
        yield
    finally:
        ops.attention_vjp = sound


def attention_backward_checks() -> None:
    """C.1, at the training layer shapes (``ATTN_BWD_CASES``): ``attend``'s
    output, the kernel's, against the plain version on the same inputs
    (``FLASH_TOL``, and per row against the plain version in float32
    within ``FLASH_BF16_ROW_TOL``, a bar a dropped KV tile must fail);
    its dq, dk, dv (the recompute through the plain version a group of
    KV heads at a time) against autograd through the plain version on
    the same inputs and upstream grad, bit-identical where the
    recompute is whole, else within ``ATTN_BWD_TOL`` of the largest
    |grad|; the recompute with the other kind of layer's window must
    fail that bar."""
    import torch
    from repro_torch.kernels.flash_attention import (attend,
                                                     flash_attention_ref)
    from repro_torch.kernels.flash_attention.ops import (attention_vjp,
                                                         recompute_groups)
    for what, b, s, h, hkv, hd, window, wrong in ATTN_BWD_CASES:
        q, k, v = flash_inputs(b, s, s, h, hkv, hd, torch.bfloat16, seed=hd)
        g = torch.Generator(device="cuda").manual_seed(hd + 1)
        up = torch.randn(q.shape, generator=g, device="cuda").to(q.dtype)
        a = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = attend(*a, window)
        got = torch.autograd.grad(out, a, up)
        out = out.detach()
        del a
        with torch.no_grad():
            plain = flash_attention_ref(q, k, v, window=window)
            fwd_err = float((out.float() - plain.float()).abs().max())
            del plain
            want32 = flash_attention_ref(q.float(), k.float(), v.float(),
                                         window=window)
            fwd_ratio = bf16_row_ratio(out, want32)
            fwd_bad = bf16_row_ratio(planted_attention(
                q, k, v, window, "dropped tile"), want32)
            del want32
        log(f"attention forward {what} (B={b} S={s} H={h}/{hkv} hd={hd} "
            f"window={window} bf16): attend (the kernel) against the plain "
            f"version max_abs_err={fwd_err:.3g} (bar "
            f"{FLASH_TOL['bfloat16']}); per row against the float32 plain "
            f"version {fwd_ratio:.3g} of the bar; planted dropped tile "
            f"{fwd_bad:.3g} of the bar")
        need(out.shape == q.shape and bool(torch.isfinite(out).all()),
             f"{what}: attend's output")
        need(fwd_err <= FLASH_TOL["bfloat16"], f"{what}: attend's output "
             f"within {FLASH_TOL['bfloat16']} of the plain version")
        need(fwd_ratio <= 1, f"{what}: attend's output within "
             f"{FLASH_BF16_ROW_TOL:.4g} of each row's largest |output|")
        need(fwd_bad > 1, f"{what}: the dropped tile fails the per-row bar")
        del out
        r = [t.clone().requires_grad_(True) for t in (q, k, v)]
        want = torch.autograd.grad(flash_attention_ref(*r, window=window),
                                   r, up)
        del r
        bad = attention_vjp(q, k, v, wrong, up)

        def rel(x):
            return max(float((xi.float() - wi.float()).abs().max())
                       / float(wi.float().abs().max())
                       for xi, wi in zip(x, want))
        groups = hkv // recompute_groups(b, s, s, h, hkv)
        same = all(torch.equal(bits(x), bits(w)) for x, w in zip(got, want))
        sound, faulted = rel(got), rel(bad)
        log(f"attention backward {what} (B={b} S={s} H={h}/{hkv} hd={hd} "
            f"window={window} bf16): recompute in {groups} group(s) of KV "
            f"heads; dq, dk, dv against autograd through the plain "
            f"version: bit-identical={same}, largest |diff| relative to "
            f"the largest |grad| {sound:.4g} (bar {ATTN_BWD_TOL:.4g}); the "
            f"recompute at window {wrong}: {faulted:.4g}")
        if groups == 1:
            need(same, f"{what}: a whole recompute gives plain autograd's "
                 f"bits")
        need(sound <= ATTN_BWD_TOL, f"{what}: attend's grads within "
             f"{ATTN_BWD_TOL} of plain autograd's")
        need(faulted > ATTN_BWD_TOL, f"{what}: the recompute at the wrong "
             f"window fails the bar")
        del q, k, v, up, got, want, bad
        gc.collect()
        torch.cuda.empty_cache()


def lm_first_step_check(cfg, batch: int, seq: int) -> tuple:
    """C.3: the first training batch's loss from ``lm_setup``'s params
    on the kernel route against the same loss with attention on the
    plain version (one KV-head group at a time), bf16 and f32, and with
    every layer forced to a 1,024-key window (a planted fault that must
    fail the bar).  Returns (the kernel route's loss, a copy of the
    initial token table)."""
    import torch
    from repro_torch.launch.train import lm_setup
    from repro_torch.models import lm
    state, _, data = lm_setup(cfg, batch, seq)
    first = {k: t.cuda() for k, t in next(data).items()}
    table = state.params["embed"]["emb"].clone()
    with torch.no_grad():
        kernel = float(lm.loss_fn(state.params, first, cfg)[0])
        with plain_route():
            plain = float(lm.loss_fn(state.params, first, cfg)[0])
        with plain_route(f32=True):
            plain32 = float(lm.loss_fn(state.params, first, cfg)[0])
        with forced_window(LM_LOCAL_WINDOW):
            faulted = float(lm.loss_fn(state.params, first, cfg)[0])
    log(f"lm first step ({cfg.name}, B={batch} x {seq}): loss on the kernel "
        f"route {kernel:.6f}, with attention on the plain version "
        f"{plain:.6f} (|diff| {abs(kernel - plain):.3g}, bar "
        f"{LM_STEP_LOSS_TOL}), on the plain version in f32 {plain32:.6f} "
        f"(|diff| {abs(kernel - plain32):.3g}); every layer at a "
        f"{LM_LOCAL_WINDOW}-key window {faulted:.6f} (|diff| "
        f"{abs(faulted - plain):.3g})")
    need(abs(kernel - plain) <= LM_STEP_LOSS_TOL, "first-step loss on the "
         "kernel route within the bar of the plain version's")
    need(abs(faulted - plain) > LM_STEP_LOSS_TOL, "the forced window fails "
         "the first-step bar")
    del state, first, data
    gc.collect()
    torch.cuda.empty_cache()
    return kernel, table


# the profiler ranges of an LM training step (``traced_spans``)
LM_SPANS = ("attention recompute", "xent", "optimizer")


def span_backward(out, stop, name: str) -> None:
    """Puts each autograd node between ``out`` and the nodes in ``stop``
    (a leaf's accumulator stops the walk too) under a profiler range
    ``name`` while the backward runs it: the node's own ops and any
    checkpoint recompute its saved tensors call for."""
    from torch.profiler import record_function
    held, open_ranges, todo = {}, {}, [out.grad_fn]
    while todo:
        node = todo.pop()
        if (node is None or node in stop or id(node) in held
                or node.name().endswith("AccumulateGrad")):
            continue
        held[id(node)] = node

        def enter(grads, key=id(node)):
            open_ranges[key] = record_function(name).__enter__()

        def leave(grads_in, grads_out, key=id(node)):
            open_ranges.pop(key).__exit__(None, None, None)
        node.register_prehook(enter)
        node.register_hook(leave)
        todo.extend(fn for fn, _ in node.next_functions)


@contextlib.contextmanager
def traced_spans():
    """Inside the block an LM training step runs under the ``LM_SPANS``
    profiler ranges: ``attention recompute`` around every
    ``attention_vjp`` (attend's backward), ``xent`` around
    ``chunked_xent``'s forward and around each node of its graph in the
    backward, ``optimizer`` around ``apply_updates`` (clip and adamw)."""
    from torch.profiler import record_function
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import lm
    from repro_torch.train import optimizer as opt
    sound = (ops.attention_vjp, lm.chunked_xent, opt.apply_updates)

    def spanned(name, fn):
        def run(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)
        return run

    def xent(h, labels, w_head, chunk, **kw):
        with record_function("xent"):
            out = sound[1](h, labels, w_head, chunk, **kw)
        span_backward(out, {h.grad_fn, w_head.grad_fn}, "xent")
        return out
    ops.attention_vjp = spanned("attention recompute", sound[0])
    lm.chunked_xent = xent
    opt.apply_updates = spanned("optimizer", sound[2])
    try:
        yield
    finally:
        ops.attention_vjp, lm.chunked_xent, opt.apply_updates = sound


def lm_step_split(cfg, state, batch: int, seq: int, start: int) -> None:
    """Where a training step's time goes: one more step of
    ``launch.train.lm_step_fn`` under the profiler, its device time
    split by the ``LM_SPANS`` ranges (``traced_spans``) into attention's
    plain recompute, the chunked xent and the optimizer, each a share of
    the step's device busy time.  As a cross-check, every layer's
    ``attention_vjp`` and the chunked xent (forward and backward) timed
    alone at the step's shapes on random inputs."""
    import torch
    from repro_torch.kernels.flash_attention.ops import attention_vjp
    from repro_torch.launch.train import lm_step_fn, lm_stream
    from repro_torch.models import lm
    data = lm_stream(cfg, batch, seq, start=start)
    b0 = {k: t.cuda() for k, t in next(data).items()}
    with traced_spans():
        step = lm_step_fn(cfg)
        split = profile_phase(f"{cfg.name} train step (B={batch} x {seq})",
                              lambda: step(state, b0), spans=LM_SPANS)
    busy = split["busy_ms"]
    rest = busy - sum(split[name] for name in LM_SPANS)
    log(f"train step split ({cfg.name}, B={batch} x {seq}; device time "
        f"under the profiler's ranges): of {busy:.3f} ms busy, "
        + ", ".join(f"{name} {split[name]:.3f} ms "
                    f"({100 * split[name] / busy:.1f}%)" for name in LM_SPANS)
        + f", the rest (every layer's forward, its remat recompute and "
        f"backward) {rest:.3f} ms ({100 * rest / busy:.1f}%)")
    for name in LM_SPANS:
        need(split[name] > 0, f"{cfg.name}: the trace attributes device time "
             f"to {name}")
    need(rest > 0, f"{cfg.name}: the spans overlap no other span")

    d, hd = cfg.d_model, cfg.resolved_head_dim
    q, k, v = flash_inputs(batch, seq, seq, cfg.num_heads, cfg.num_kv_heads,
                           hd, torch.bfloat16, seed=3)
    up = torch.randn_like(q)
    vjp_ms, _ = time_ms(lambda: attention_vjp(q, k, v, FULL_WINDOW, up),
                        iters=3, warmup=1, hold=False)
    del q, k, v, up
    g = torch.Generator(device="cuda").manual_seed(4)
    h = torch.randn((batch, seq, d), generator=g, device="cuda").to(
        torch.bfloat16).requires_grad_(True)
    w_head = state.params["lm_head"]

    def xent():
        w = w_head.detach().requires_grad_(True)
        out = lm.chunked_xent(h, b0["labels"], w, cfg.xent_chunk)
        torch.autograd.grad(out, (h, w))
    xent_ms, _ = time_ms(xent, iters=3, warmup=1, hold=False)
    del h
    recompute = vjp_ms * cfg.num_layers
    log(f"train step split ({cfg.name}) cross-check, timed alone on random "
        f"inputs: attention's plain recompute {vjp_ms:.3f} ms a layer, "
        f"{recompute:.3f} ms over {cfg.num_layers} layers ("
        f"{recompute / split['attention recompute']:.3f}x the traced span), "
        f"the chunked xent forward and backward {xent_ms:.3f} ms "
        f"({xent_ms / split['xent']:.3f}x the traced span)")


def lm_train_run(arch: str, batch: int, seq: int, steps: int,
                 layers=None) -> tuple:
    """``arch``'s ``CONFIG`` (its depth cut to ``layers``) trained
    ``steps`` adamw steps through ``launch.train.train`` at ``batch`` x
    ``seq``, the counts set to 0 just before and read just after: step
    time (the median from step 2 on), tokens/s beside the step's FLOP
    bound, peak memory, ``flash_attention`` launches a step (layer
    remat: 2 a layer, the forward and its recompute), every loss finite,
    the first cross-entropy near ln V.  Returns (the run, its launches, its config)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import train
    from repro_torch.roofline import lm_train_flops, peak_flops
    full_layers = get_arch(arch, smoke=False)[1].num_layers
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counts()
    run = train(arch, smoke=False, steps=steps, batch=batch, seq=seq,
                log_every=1,
                overrides={"num_layers": layers} if layers else None)
    torch.cuda.synchronize()
    cfg = run.cfg
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [h["loss"] for h in run.history]
    xent = [h["xent"] for h in run.history]
    times = sorted(h["step_time_s"] for h in run.history[1:])
    step_s = times[len(times) // 2]
    flops, parts = lm_train_flops(cfg, batch, seq)
    bound_s = flops / peak_flops("bfloat16")
    want = 2 * cfg.num_layers * steps if cfg.remat else \
        cfg.num_layers * steps
    state_gib = cfg.param_count() * (
        2 * torch.tensor([], dtype=getattr(torch, cfg.param_dtype))
        .element_size() + 8) / 2**30
    cut = (f", depth cut from {full_layers} to {cfg.num_layers} layers "
           f"(the params, their grads and two f32 moments of "
           f"{full_layers} layers do not fit one card)" if layers else "")
    log(f"lm train ({cfg.name}{cut}): {cfg.param_count()} params in "
        f"{cfg.param_dtype}, activations {cfg.dtype}, remat "
        f"{cfg.remat_granularity if cfg.remat else 'off'}, MGQE token table; "
        f"{steps} adamw steps at B={batch} x {seq} (train_4k's global batch "
        f"of 256 cut to {batch}); step {step_s * 1e3:.3f} ms (median of "
        f"steps 2-{steps}; all {[round(h['step_time_s'] * 1e3, 3) for h in run.history]}), "
        f"{batch * seq / step_s:,.0f} tokens/s; bound {bound_s * 1e3:.3f} ms "
        f"({flops} FLOP at 989 TFLOP/s: weights {parts['weights']}, remat "
        f"{parts['remat']}, attention {parts['attention']}; "
        f"{flops / step_s / 1e12:.1f} TFLOP/s achieved, "
        f"{step_s / bound_s:.2f}x the bound); peak device memory "
        f"{peak:.3f} GiB (params, grads and moments reckoned at "
        f"{state_gib:.1f} GiB); losses {[round(x, 6) for x in losses]}, "
        f"cross-entropy {[round(x, 6) for x in xent]} (ln V = "
        f"{math.log(cfg.vocab_size):.4f}), aux "
        f"{[round(h['aux'], 4) for h in run.history]}; launches {launches}, "
        f"flash_attention {launches['flash_attention'] / steps:g} a step "
        f"(predicted {want // steps})")
    need(all(math.isfinite(x) for x in losses), f"{cfg.name}: finite losses")
    need(abs(xent[0] - math.log(cfg.vocab_size)) < 1.0,
         f"{cfg.name}: the first cross-entropy near ln V")
    need(launches["flash_attention"] == want, f"{cfg.name}: flash_attention "
         f"launched {want} times in training")
    need(sum(launches.values()) == want, f"{cfg.name}: no other kernel in "
         f"training")
    return run, launches, cfg


def lm_train_export_serve(cfg, run, table0) -> tuple:
    """C.5: the trained token table exported through ``dpq_assign`` and
    served (a prefill of 1 x train_4k's sequence, LM_STEPS decode steps)
    through ``launch.serve.serve_lm``, the counts set to 0 just before
    and read just after; the rows and codes held as ``lm_path`` holds
    them; a stale artifact (the initial table's export) must fail the
    codes' bar against the trained table.  Returns (launches, the
    largest gap of a code, flash_attention's shape)."""
    import torch
    from repro_torch.core import Embedding
    from repro_torch.core.mgqe import k_limit_for_all_rows
    from repro_torch.launch.serve import serve_lm
    params = run.state.params
    run.state.opt_state = None
    gc.collect()
    torch.cuda.empty_cache()
    seq = lm_train_seq()
    ecfg = cfg.embedding
    counters = reset_counts()
    served = serve_lm(cfg, 1, seq, LM_STEPS, params=params)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    want = {"dpq_assign": -(-ecfg.vocab_size // ASSIGN_BATCH),
            "mgqe_decode": 1 + LM_STEPS, "flash_attention": cfg.num_layers}
    emb = Embedding(dataclasses.replace(ecfg, param_dtype=cfg.param_dtype))
    gap, mism = check_served_table(served, ecfg, emb)
    stale = emb.export(params["embed"] | {"emb": table0})
    lim = k_limit_for_all_rows(ecfg, "cuda")
    n = min(ASSIGN_BATCH, ecfg.vocab_size)
    e = params["embed"]["emb"][:n].reshape(n, ecfg.num_subspaces, -1)
    got = stale["codes"][:n].to(torch.int32)
    plain = blocked_assign_ref_lim(e, served.artifact["centroids"], lim[:n])
    stale_gap = assign_gap(e, served.artifact["centroids"], lim[:n], got,
                           plain)
    moved = float((params["embed"]["emb"] - table0).abs().max())
    log(f"lm train -> export -> serve ({cfg.name}): the trained table "
        f"(moved by up to {moved:.4g} from its init) exported and served, "
        f"prefill 1 x {seq} in {served.prefill_seconds:.6f}s, {LM_STEPS} "
        f"decode steps in {served.decode_seconds:.6f}s; token rows "
        f"bit-identical to the plain decode; exported codes ({mism} differ) "
        f"within {gap:.3g} of the plain assignment; the initial table's "
        f"codes against the trained table's plain assignment: "
        f"{int((got != plain).sum())} of {got.numel()} differ, gap "
        f"{stale_gap:.4g}; launches {launches} (predicted {want})")
    need(launches == {**{k: 0 for k in launches}, **want},
         f"{cfg.name}: the export and serve launch {want}")
    need(bool(torch.isfinite(served.logits).all()), "finite served logits")
    need(stale_gap > ASSIGN_TOL, "a stale artifact fails the codes' bar")
    shape = (f"{cfg.name} serve", 1, seq, cfg.num_heads, cfg.num_kv_heads,
             cfg.resolved_head_dim, FULL_WINDOW)
    del served, stale, lim, e, got, plain
    return launches, gap, shape


def leaf_grads(loss_fn, params, batch) -> list:
    """The gradient of ``loss_fn(params, batch)[0]`` with respect to
    every leaf of ``params``."""
    import torch
    from repro_torch.core.schemes.base import tree_leaves
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, _ = loss_fn(params, batch)
        return list(torch.autograd.grad(loss, leaves))
    finally:
        for p in leaves:
            p.requires_grad_(False)


def lm_grads(cfg, params, batch) -> list:
    """The gradient of ``lm.loss_fn`` with respect to every leaf."""
    from repro_torch.models import lm
    return leaf_grads(lambda p, b: lm.loss_fn(p, b, cfg), params, batch)


def lm_smoke_card_vs_cpu() -> None:
    """C.2: each LM arch's smoke config with the chunked route (the
    kernel on the card) and layer remat, from the same params and
    ``lm_stream`` batches on the card and on the CPU: the first batch's
    gradients within TRAIN_PARAM_TOL (relative to 1 + |g|), then
    LM_CHECK_STEPS adamw steps with every loss within TRAIN_LOSS_RTOL;
    stablelm-3b's card gradients once more with ``attend``'s recompute
    at an 8-key window (a planted fault that must fail the gradients'
    bar; a few warmup steps barely move the loss)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.schemes.base import tree_map
    from repro_torch.launch.train import lm_setup
    from repro_torch.train import optimizer as opt

    for arch in LM_ARCHS:
        _, cfg = get_arch(arch, smoke=True)
        cfg = dataclasses.replace(cfg, attention_impl="chunked", remat=True)
        host, step, data = lm_setup(cfg, LM_CHECK_BATCH, LM_CHECK_SEQ,
                                    device="cpu")
        card = opt.TrainState(tree_map(lambda t: t.cuda(), host.params),
                              tree_map(lambda t: t.cuda(), host.opt_state))
        batch = next(data)
        on_card = {k: t.cuda() for k, t in batch.items()}
        want = lm_grads(cfg, host.params, batch)

        def grad_gap(fault=False):
            with (recompute_other_window(8) if fault
                  else contextlib.nullcontext()):
                got = lm_grads(cfg, card.params, on_card)
            return max(float(((g.cpu() - w).abs() / (1 + w.abs())).max())
                       for g, w in zip(got, want))
        gap = grad_gap()
        bad = grad_gap(fault=True) if arch == LM_TRAIN_ARCH else None
        rel = []
        for _ in range(LM_CHECK_STEPS):
            card, mc = step(card, on_card)
            host, mh = step(host, batch)
            rel.append(abs(float(mc["loss"]) - float(mh["loss"]))
                       / abs(float(mh["loss"])))
            batch = next(data)
            on_card = {k: t.cuda() for k, t in batch.items()}
        log(f"lm train card vs CPU ({cfg.name}, chunked route, layer remat, "
            f"B={LM_CHECK_BATCH} x {LM_CHECK_SEQ}): first-batch gradients "
            f"within {gap:.3g} relative to 1 + |g| (bar {TRAIN_PARAM_TOL})"
            + (f", with the card's recompute at an 8-key window {bad:.3g}"
               if bad is not None else "")
            + f"; {LM_CHECK_STEPS} steps' loss relative gaps "
            f"{[f'{x:.3g}' for x in rel]} (bar {TRAIN_LOSS_RTOL})")
        need(gap <= TRAIN_PARAM_TOL, f"{cfg.name}: gradients within "
             f"{TRAIN_PARAM_TOL} of the CPU's")
        need(max(rel) <= TRAIN_LOSS_RTOL, f"{cfg.name}: losses within "
             f"{TRAIN_LOSS_RTOL} of the CPU's")
        if bad is not None:
            need(bad > TRAIN_PARAM_TOL, "the wrong recompute window fails "
                 "the gradients' bar")


@contextlib.contextmanager
def stream_not_positioned():
    """A planted fault: inside the block, a resumed LM run's stream
    starts at the first batch, not at its checkpoint's."""
    from repro_torch.launch import train as train_mod
    sound = train_mod.lm_stream
    train_mod.lm_stream = lambda cfg, b, s, start=0: sound(cfg, b, s, 0)
    try:
        yield
    finally:
        train_mod.lm_stream = sound


def lm_resume_checks() -> None:
    """C.4: stablelm-3b at full width, its depth cut to
    LM_RESUME_LAYERS, failed at step 3 and resumed against an
    uninterrupted run under the default algorithms: bit-identical; a
    resume whose stream is not positioned at its checkpoint must
    differ.  Then qwen3-moe-30b-a3b's smoke config (the MoE dispatch's
    and combine's backward) the same way: whether it repeats bit for
    bit."""
    overrides = {"num_layers": LM_RESUME_LAYERS}
    kw = dict(smoke=False, batch=LM_RESUME_BATCH, seq=lm_train_seq(),
              overrides=overrides)
    t0 = time.perf_counter()
    gap, same, bad = resume_gap(LM_TRAIN_ARCH, planted=stream_not_positioned,
                                **kw)
    log(f"lm train resume ({LM_TRAIN_ARCH} at full width, {LM_RESUME_LAYERS} "
        f"layers, B={LM_RESUME_BATCH} x {lm_train_seq()}, "
        f"{time.perf_counter() - t0:.1f}s): gap {gap:.3g}, "
        f"bit-identical={same}; resumed on a stream not positioned at the "
        f"checkpoint: gap {bad:.3g}")
    need(same, f"{LM_TRAIN_ARCH}: a resumed run is bit-identical to an "
         f"uninterrupted one")
    need(bad > 0, "a resume on the wrong batches differs")
    moe_kw = dict(smoke=True, batch=LM_CHECK_BATCH, seq=LM_CHECK_SEQ,
                  overrides={"attention_impl": "chunked", "remat": True})
    gap, same, _ = resume_gap("qwen3-moe-30b-a3b", **moe_kw)
    log(f"lm train resume (qwen3-moe-30b-a3b smoke config, chunked route, "
        f"layer remat): gap {gap:.3g}, bit-identical={same}"
        + ("" if same else " (not bit for bit: the ops left with atomic "
           "adds in their backward are the dispatch's index_add_ forward "
           "and the combine's gather)"))


def lm_train_phases() -> tuple:
    """Phases A, B and C of LM training (see the module docstring).
    Returns (the launches of each counted run, flash_attention's
    (shape -> launches) over them, the largest code gap of the export)."""
    import torch
    t_phase = time.perf_counter()
    attention_backward_checks()
    seq = lm_train_seq()
    from repro_torch.configs import get_arch
    _, cfg = get_arch(LM_TRAIN_ARCH, smoke=False)
    first_loss, table0 = lm_first_step_check(cfg, LM_TRAIN_BATCH, seq)
    run, a_launches, cfg = lm_train_run(LM_TRAIN_ARCH, LM_TRAIN_BATCH, seq,
                                        LM_TRAIN_STEPS)
    log(f"lm train ({cfg.name}): first step's loss {run.history[0]['loss']:.6f}"
        f", the kernel route's loss on the same params and batch "
        f"{first_loss:.6f}")
    lm_step_split(cfg, run.state, LM_TRAIN_BATCH, seq, LM_TRAIN_STEPS)
    s_launches, gap, serve_shape = lm_train_export_serve(cfg, run, table0)
    del run, table0
    gc.collect()
    torch.cuda.empty_cache()
    log(f"lm phase A ({cfg.name}): {time.perf_counter() - t_phase:.1f}s; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} "
        f"GiB")
    t_b = time.perf_counter()
    moe_run, b_launches, moe_cfg = lm_train_run(
        MOE_TRAIN_ARCH, MOE_TRAIN_BATCH, seq, MOE_TRAIN_STEPS,
        layers=MOE_TRAIN_LAYERS)
    lm_step_split(moe_cfg, moe_run.state, MOE_TRAIN_BATCH, seq,
                  MOE_TRAIN_STEPS)
    log(f"lm phase B ({moe_cfg.name}): peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    del moe_run
    gc.collect()
    torch.cuda.empty_cache()
    log(f"lm phase B ({moe_cfg.name}): {time.perf_counter() - t_b:.1f}s")
    t_c = time.perf_counter()
    lm_smoke_card_vs_cpu()
    lm_resume_checks()
    log(f"lm phase C: {time.perf_counter() - t_c:.1f}s; the LM training "
        f"phases {time.perf_counter() - t_phase:.1f}s")
    shapes = {(f"{cfg.name} train", LM_TRAIN_BATCH, seq, cfg.num_heads,
               cfg.num_kv_heads, cfg.resolved_head_dim, FULL_WINDOW):
              a_launches["flash_attention"],
              (f"{moe_cfg.name} train", MOE_TRAIN_BATCH, seq,
               moe_cfg.num_heads, moe_cfg.num_kv_heads,
               moe_cfg.resolved_head_dim, FULL_WINDOW):
              b_launches["flash_attention"],
              serve_shape: s_launches["flash_attention"]}
    return [a_launches, b_launches, s_launches], shapes, gap


# ----------------------------------------------------------------------
# the LM mesh phase: LM training on a (data, model) mesh of gloo ranks
# sharing the card
# ----------------------------------------------------------------------

LMM_MESH = (2, 2)                      # (data, model): 4 gloo ranks, one card
LMM_ARCH = "stablelm-3b"
# 4 ranks' state and activations at all 32 layers overflowed the card's
# 80 GB in the first step, and a step's time grows with its layers'
# host-staged gloo collectives: the depth is cut for memory and time,
# the width kept (the whole script read 1,015.8 s of its 1,200 s at 16
# layers; 1,205.5 s at 8 with the LM serving mesh phase, whose time
# the cut to 4 paid; 1 for the dry run's and long_500k's time; H100
# 80GB HBM3 at 700 W)
LMM_LAYERS = 1
LMM_BATCH = 2                          # train_4k's sequence, one a data rank
LMM_STEPS = 2                          # a step, then a traced one
LMM_CHECK_LAYERS = 1                   # stablelm-3b's float32 check's depth
QW_CHECK_LAYERS = 1                    # qwen3's (its 128 experts in float32)
LMM_SAMPLES = 4096                     # elements held a leaf
LMM_TOL = 1e-5                         # the CPU tests' bar (float32)
# bf16 activations: row-parallel partials rounded to bf16 before their
# float32 sum, where one device rounds each product once
LMM_BF16_LOSS_TOL = 2e-3
# the resume's depth: one layer (127.1 s for the three runs at two, a
# 1,140.5 s script; a resume repeats bit for bit at one as at two);
# the one-device resume (LM_RESUME_LAYERS) keeps two, so a restore that
# swaps or repeats layers of a stack cannot match there
LMM_RESUME_LAYERS = 1
QW_ARCH = "qwen3-moe-30b-a3b"
QW_LAYERS = 1                          # for the whole run's time
FFN_MESH = (1, 3)                      # 128 experts % 3 != 0: the ffn strategy
FFN_TOKENS = 4096
LMM_TIMEOUT = 900.0


def lmm_index(path: str, shape) -> "np.ndarray":
    """LMM_SAMPLES flat indices of a leaf of ``shape`` (every index of a
    smaller one), drawn from a seed of the leaf's path."""
    import zlib
    import numpy as np
    n = math.prod(shape)
    if n <= LMM_SAMPLES:
        return np.arange(n)
    rng = np.random.default_rng(zlib.crc32(path.encode()))
    return np.sort(rng.choice(n, LMM_SAMPLES, replace=False))


def lmm_block(spec, shape, mesh) -> tuple:
    """(start, size) per dim of a rank's block of a leaf of ``shape``
    under ``spec`` (``mesh`` None: the whole leaf)."""
    out = []
    for dim, axes in enumerate(spec):
        if axes is None or mesh is None:
            out.append((0, shape[dim]))
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        n, i = 1, 0
        for a in axes:
            n *= mesh.shape[a]
            i = i * mesh.shape[a] + mesh.axis_index(a)
        out.append((i * (shape[dim] // n), shape[dim] // n))
    return out


def lmm_samples(leaves, paths, whole_shapes, specs, mesh) -> dict:
    """{path: (mask, values)} of each leaf (this rank's block under its
    spec) at its ``lmm_index`` elements: which of them the block holds,
    and their values as float32 on the host."""
    import numpy as np
    import torch
    out = {}
    for t, path, shape, spec in zip(leaves, paths, whole_shapes, specs,
                                    strict=True):
        idx = lmm_index(path, shape)
        spec = (None,) * len(shape) if spec is None else tuple(spec)
        blk = lmm_block(spec, shape, mesh)
        multi = np.unravel_index(idx, shape)
        mask = np.ones(len(idx), bool)
        for (start, size), m in zip(blk, multi):
            mask &= (m >= start) & (m < start + size)
        local = np.ravel_multi_index(
            [m[mask] - start for (start, _), m in zip(blk, multi)],
            [size for _, size in blk]) if len(shape) else np.zeros(
                int(mask.sum()), np.int64)
        vals = t.detach().reshape(-1)[torch.from_numpy(local).to(t.device)]
        out[path] = (mask, vals.float().cpu().numpy())
    return out


def lmm_merge(ranks: list, key: str) -> dict:
    """The ranks' ``lmm_samples`` of ``key`` merged: {path: values}, every
    sampled element from a rank whose block holds it."""
    import numpy as np
    merged = {}
    for r in ranks:
        for path, (mask, vals) in r[key].items():
            if path not in merged:
                merged[path] = (np.zeros(len(mask), bool),
                                np.zeros(len(mask), np.float32))
            have, out = merged[path]
            out[mask] = vals
            have |= mask
    for path, (have, _) in merged.items():
        need(bool(have.all()), f"{key}: the ranks' blocks cover every "
             f"sampled element of {path}")
    return {path: out for path, (_, out) in merged.items()}


def lmm_gap(got: dict, want: dict, tiny: dict = None, travel: float = 0.0,
            leaf_scale: bool = False) -> float:
    """The largest |got - want| over every sampled leaf as a multiple of
    its bar ``LMM_TOL + LMM_TOL·|want|`` (so <= 1 passes); with
    ``leaf_scale`` the bar's relative part is of the leaf's largest
    |want|, for sums over thousands of tokens, whose rounding follows the
    terms' size, not the sum's; elements whose first-step gradient is
    tiny (``tiny``) barred at ``travel`` instead (adam moves them by
    about lr whatever their gradient's size)."""
    import numpy as np
    worst = 0.0
    need(set(got) == set(want), "the same sampled leaves")
    for path in want:
        g, w = got[path].astype(np.float64), want[path].astype(np.float64)
        bar = LMM_TOL + LMM_TOL * (np.abs(w).max() if leaf_scale
                                   else np.abs(w))
        if tiny is not None:
            bar = np.where(tiny[path], travel, bar)
        worst = max(worst, float((np.abs(g - w) / bar).max()))
    return worst


def lmm_specs(cell) -> tuple:
    """(paths, whole shapes, param specs, moment specs) of a cell's
    leaves, in ``tree_leaves`` order."""
    from repro_torch.launch.cells import _tree_paths
    from repro_torch.sharding.rules import spec_leaves, whole_like
    from repro_torch.core.schemes.base import tree_leaves
    whole = whole_like(cell.state.params, cell.specs.params, cell.mesh)
    return ([p for p, _ in _tree_paths(cell.specs.params)],
            [tuple(t.shape) for t in tree_leaves(whole)],
            spec_leaves(cell.specs.params),
            spec_leaves(cell.specs.opt_state["m"]))


@contextlib.contextmanager
def grouped_moe(data_n: int, model_n: int, counts: list = None):
    """Within the block, ``nn/moe.py::moe_ffn`` on one device computes
    ``moe_ffn_sharded`` on a (data_n, model_n) mesh
    (``moe_ffn_grouped``, its plain version).  ``counts`` collects
    (pairs, kept, most pairs an expert got) a token group."""
    import torch
    from repro_torch.nn import moe
    single = moe.moe_ffn

    def twin(params, x, *, top_k, capacity_factor=1.25, mesh=None,
             model_axis="model"):
        e = params["router"].shape[-1]
        if counts is not None:
            b, s, d = x.shape
            seq_n = model_n if moe.expert_parallel(e, model_n) else 1
            bl, sl = b // data_n, s // seq_n
            cap = moe.capacity(bl * sl, e, top_k, capacity_factor)
            with torch.no_grad():
                for di in range(data_n):
                    for mi in range(seq_n):
                        xg = x[di * bl:(di + 1) * bl,
                               mi * sl:(mi + 1) * sl].reshape(-1, d)
                        _, gate_i, _ = moe.route(xg, params["router"], top_k)
                        flat = gate_i.reshape(-1)
                        _, keep = moe.slots(flat, e, cap)
                        counts.append((flat.numel(), int(keep.sum()), int(
                            torch.bincount(flat, minlength=e).max())))
        return moe.moe_ffn_grouped(params, x, top_k=top_k,
                                   capacity_factor=capacity_factor,
                                   data_n=data_n, model_n=model_n)

    moe.moe_ffn = twin
    try:
        yield
    finally:
        moe.moe_ffn = single


def no_drop_factor(counts: list, e: int, top_k: int, tokens: int) -> float:
    """The least capacity factor whose ``capacity(tokens, ...)`` holds the
    most pairs any expert got in ``counts``."""
    most = max(c[2] for c in counts)
    return most * e / (tokens * top_k)


def lmm_configs(plan: dict) -> dict:
    """The phase's configs: stablelm-3b's ``CONFIG`` with FSDP (bf16
    activations) at LMM_LAYERS and its float32 check at
    LMM_CHECK_LAYERS; qwen3's
    ``CONFIG`` at QW_LAYERS with ``moe_shard_map`` and its float32
    check at QW_CHECK_LAYERS and a capacity where nothing drops
    (``plan["qw_factor"]``)."""
    import dataclasses
    from repro_torch.configs import get_arch
    _, st = get_arch(LMM_ARCH, smoke=False)
    _, qw = get_arch(QW_ARCH, smoke=False)
    st = dataclasses.replace(st, fsdp_params=True)
    qw = dataclasses.replace(qw, num_layers=QW_LAYERS, moe_shard_map=True)
    f32 = dict(dtype="float32", param_dtype="float32")
    return {"stablelm": dataclasses.replace(st, num_layers=min(
                LMM_LAYERS, st.num_layers)),
            "stablelm_check": dataclasses.replace(
                st, num_layers=LMM_CHECK_LAYERS, **f32),
            "qwen3": qw,
            "qwen3_check": dataclasses.replace(
                qw, num_layers=QW_CHECK_LAYERS,
                moe_capacity_factor=plan.get("qw_factor", 16.0), **f32)}


def lmm_one_device(cfg, batch: dict, update: bool, twin=None) -> dict:
    """One device's first step of ``cfg`` from the cell's params (a
    generator seeded 0 on the card): its loss, sampled gradients and,
    with ``update``, sampled params after the cell's adamw step;
    ``twin`` wraps the forward (the grouped MoE)."""
    import functools
    import torch
    from repro_torch.core.schemes.base import tree_leaves
    from repro_torch.launch.cells import _tree_paths
    from repro_torch.models import lm
    from repro_torch.train.optimizer import (OptimizerConfig, TrainState,
                                             apply_updates, loss_grads)
    params = lm.model_init(torch.Generator(device="cuda").manual_seed(0),
                           cfg)
    paths = [p for p, _ in _tree_paths(params)]
    shapes = [tuple(t.shape) for t in tree_leaves(params)]
    with twin or contextlib.nullcontext():
        grads, metrics = loss_grads(functools.partial(lm.loss_fn, cfg=cfg),
                                    params, batch)
    out = {"loss": float(metrics["loss"]),
           "grads": {k: v[1] for k, v in lmm_samples(
               tree_leaves(grads), paths, shapes, [None] * len(paths),
               None).items()}}
    if update:
        state = TrainState.create(OptimizerConfig(kind="adamw", lr=3e-4,
                                                  grad_clip=1.0), params)
        apply_updates(OptimizerConfig(kind="adamw", lr=3e-4, grad_clip=1.0),
                      state.params, grads, state.opt_state)
        out["params"] = {k: v[1] for k, v in lmm_samples(
            tree_leaves(state.params), paths, shapes, [None] * len(paths),
            None).items()}
        del state
    del params, grads
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lmm_cell_step(cell, batch, update: bool) -> dict:
    """A cell's first step on the global ``batch``: its loss, the sampled
    blocks of the gradients the update consumes and, with ``update``, of
    the params after it."""
    import torch
    from repro_torch.core.schemes.base import tree_leaves
    from repro_torch.train.loop import on_device
    paths, shapes, p_specs, m_specs = lmm_specs(cell)
    lb = on_device(cell.local_batch(batch), cell.mesh.device)
    acc, metrics = cell.accumulate(cell.state, lb)
    out = {"loss": float(metrics["loss"]),
           "grads": lmm_samples(acc, paths, shapes, m_specs, cell.mesh)}
    if update:
        state = cell.update(cell.state, acc)
        out["params"] = lmm_samples(tree_leaves(state.params), paths, shapes,
                                    p_specs, cell.mesh)
    del acc
    torch.cuda.synchronize()
    return out


def lmm_timed_steps(cell, batch, steps: int) -> dict:
    """``steps`` steps of a cell on the global ``batch``, the last traced:
    the mesh's collectives counted and timed, the device synchronised
    around each.  Losses, step ms, the traced step's collectives (count,
    bytes a rank, seconds), peak device memory."""
    import torch
    from repro_torch.sharding.collectives import CommStats
    from repro_torch.train.loop import on_device
    lb = on_device(cell.local_batch(batch), cell.mesh.device)
    state, losses, ms = cell.state, [], []
    torch.cuda.reset_peak_memory_stats()
    for s in range(steps):
        if s == steps - 1:
            cell.mesh.stats = CommStats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = cell.step(state, lb)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(m["loss"]))
    stats, cell.mesh.stats = cell.mesh.stats, None
    cell.state = state
    return {"losses": losses, "ms": ms, "comm": dataclasses.asdict(stats),
            "peak": torch.cuda.max_memory_allocated()}


def lmm_export_serve(cell, out: dict) -> None:
    """The trained token table gathered over model, exported on rank 0
    (``dpq_assign``) and a batch of its ids served (``mgqe_decode``):
    codes held to the plain assignment, rows bit-identical to the plain
    decode of the codes."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import Embedding
    from repro_torch.core.mgqe import k_limit_for_all_rows
    from repro_torch.sharding.collectives import all_gather
    p = cell.state.params["embed"]
    whole = all_gather(p["emb"], cell.mesh, "model")
    if dist.get_rank() != 0:
        return
    ecfg = cell.cfg.embedding
    emb = Embedding(ecfg, device=cell.mesh.device)
    art = emb.export({"emb": whole, "centroids": p["centroids"]})
    ids = torch.arange(0, ecfg.vocab_size, 7, device=whole.device)
    rows = emb.serve(art, ids)
    codes = art["codes"].long()[ids]
    cent = art["centroids"]
    plain = torch.cat([cent[d][codes[:, d]] for d in range(cent.shape[0])],
                      dim=-1)
    n = min(ASSIGN_BATCH, ecfg.vocab_size)
    e = whole[:n].reshape(n, ecfg.num_subspaces, -1)
    lim = k_limit_for_all_rows(ecfg, "cuda")[:n]
    got = art["codes"][:n].to(torch.int32)
    want = blocked_assign_ref_lim(e, cent, lim)
    out["export"] = {"rows_equal": bool(torch.equal(bits(rows.float()),
                                                    bits(plain.float()))),
                     "gap": assign_gap(e, cent, lim, got, want),
                     "differ": int((got != want).sum()), "rows": len(ids)}
    del whole, art, rows, plain


def lmm_rank(rank, plan) -> dict:
    """One rank of the LM mesh phase (a gloo process on the card); see
    ``lm_mesh_phase``."""
    import io
    import torch
    from repro_torch.core.schemes.base import tree_leaves
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.cells import lm_train_cell
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.train.resilience import SimulatedFailure
    mesh = make_debug_mesh(*LMM_MESH)
    need(mesh.device == torch.device("cuda", 0), "every rank on cuda:0")
    counters = reset_counts()
    cfgs = lmm_configs(plan)
    batches = {name: {k: torch.from_numpy(v) for k, v in b.items()}
               for name, b in plan["batches"].items()}
    out = {"coords": (mesh.axis_index("data"), mesh.axis_index("model"))}
    t0 = time.perf_counter()
    for name in ("stablelm_check", "qwen3_check"):
        torch.cuda.reset_peak_memory_stats()
        cell = lm_train_cell(cfgs[name], mesh)
        out[name] = lmm_cell_step(cell, batches[name.split("_")[0]],
                                  update=name.startswith("st"))
        out[name]["peak"] = torch.cuda.max_memory_allocated()
        del cell
        gc.collect()
        torch.cuda.empty_cache()
    out["t_check"] = time.perf_counter() - t0
    for name in ("stablelm", "qwen3"):
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        cell = lm_train_cell(cfgs[name], mesh)
        torch.cuda.synchronize()
        run = {"t_init": time.perf_counter() - t0,
               "state_bytes": torch.cuda.memory_allocated() - before}
        run.update(lmm_timed_steps(cell, batches[name], LMM_STEPS))
        run["peak"] -= before
        if name == "stablelm":
            lmm_export_serve(cell, run)
        out[name] = run
        del cell
        gc.collect()
        torch.cuda.empty_cache()
    # fail in the second step (index 1) with a checkpoint at step 1,
    # resume; an uninterrupted run beside it
    t0 = time.perf_counter()
    kw = dict(smoke=False, steps=2, batch=LMM_BATCH, seq=lm_train_seq(),
              log_every=1, mesh=mesh,
              overrides={"num_layers": LMM_RESUME_LAYERS,
                         "fsdp_params": True})
    with contextlib.redirect_stdout(io.StringIO()):
        try:
            train_cli.train(LMM_ARCH, ckpt_dir=plan["ckpt"], ckpt_every=1,
                            fail_at=1, **kw)
            failed = False
        except SimulatedFailure:
            failed = True
        resumed = train_cli.train(LMM_ARCH, ckpt_dir=plan["ckpt"], **kw)
        whole = train_cli.train(LMM_ARCH, **kw)
    out["resume"] = {
        "failed": failed, "steps": [h["step"] for h in resumed.history],
        "losses": [h["loss"] for h in resumed.history],
        "whole": [h["loss"] for h in whole.history],
        "same": all(torch.equal(a, b) for a, b in zip(
            tree_leaves(resumed.state.params)
            + tree_leaves(resumed.state.opt_state),
            tree_leaves(whole.state.params)
            + tree_leaves(whole.state.opt_state), strict=True)),
        "seconds": time.perf_counter() - t0}
    del resumed, whole
    out["launches"] = {k: fn.launches for k, fn in counters.items()}
    return out


def ffn_inputs() -> tuple:
    """One qwen3 MoE layer at full width (d_model 2,048, d_ff 768, 128
    experts), float32, and FFN_TOKENS tokens of x, drawn on the card
    from fixed seeds."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.nn import moe
    _, cfg = get_arch(QW_ARCH, smoke=False)
    gen = torch.Generator(device="cuda").manual_seed(5)
    params = moe.moe_init(gen, cfg.d_model, cfg.d_ff, cfg.num_experts)
    x = torch.randn((1, FFN_TOKENS, cfg.d_model), generator=gen,
                    device="cuda")
    return params, x, cfg.num_experts_per_tok


FFN_SPECS = {"router": (None, None), "w_gate": (None, None, "model"),
             "w_up": (None, None, "model"), "w_down": (None, "model", None)}


def ffn_loss_samples(params: dict, x, out, aux, grads, mesh) -> dict:
    """The ffn check's loss and the samples of its output, the weights'
    gradients (blocks under FFN_SPECS) and x's gradient."""
    names = sorted(params)
    whole = {"router": (x.shape[-1], params["router"].shape[-1])}
    e, d = params["router"].shape[1], x.shape[-1]
    f = params["w_down"].shape[1] * (1 if mesh is None else
                                     mesh.shape["model"])
    whole.update({"w_gate": (e, d, f), "w_up": (e, d, f),
                  "w_down": (e, f, d)})
    g = dict(zip(names + ["x"], grads))
    return {"aux": float(aux), "out": lmm_samples(
        [out], ["out"], [tuple(out.shape)], [None], None),
        "grads": lmm_samples(
            [g[k] for k in names] + [g["x"]], names + ["x"],
            [whole[k] for k in names] + [tuple(x.shape)],
            [FFN_SPECS[k] if mesh is not None else None for k in names]
            + [None], mesh)}


def ffn_forward_backward(params: dict, x, top_k: int, factor: float,
                         mesh=None) -> dict:
    """``moe_ffn_sharded`` on ``mesh`` (``moe_ffn`` without one) at
    ``factor``: the loss sum(out * cos(out)) + aux and its gradients,
    sampled."""
    import torch
    from repro_torch.nn import moe
    for t in params.values():
        t.requires_grad_(True)
    x.requires_grad_(True)
    kw = dict(top_k=top_k, capacity_factor=factor)
    out, aux = (moe.moe_ffn(params, x, **kw) if mesh is None else
                moe.moe_ffn_sharded(params, x, mesh=mesh, **kw))
    loss = torch.sum(out * torch.cos(out)) + aux
    names = sorted(params)
    grads = torch.autograd.grad(loss, [params[k] for k in names] + [x])
    res = ffn_loss_samples(params, x, out.detach(), aux.detach(), grads,
                           mesh)
    res["loss"] = float(loss.detach())
    return res


def ffn_rank(rank, plan) -> dict:
    """One rank of the ffn strategy's check: a (data=1, model=3) mesh of
    gloo ranks on the card, the layer's d_ff split over model."""
    import torch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.nn import moe
    mesh = Mesh(FFN_MESH, ("data", "model"))
    counters = reset_counts()
    params, x, top_k = ffn_inputs()
    need(not moe.expert_parallel(params["router"].shape[1],
                                 mesh.shape["model"]),
         "128 experts over model = 3 take the ffn strategy")
    m, n = mesh.axis_index("model"), mesh.shape["model"]
    f = params["w_gate"].shape[-1] // n
    local = {"router": params["router"],
             "w_gate": params["w_gate"][..., m * f:(m + 1) * f].clone(),
             "w_up": params["w_up"][..., m * f:(m + 1) * f].clone(),
             "w_down": params["w_down"][:, m * f:(m + 1) * f].clone()}
    del params
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ffn_forward_backward(local, x, top_k, plan["ffn_factor"], mesh)
    torch.cuda.synchronize()
    res["seconds"] = time.perf_counter() - t0
    res["coords"] = (0, m)
    res["launches"] = {k: fn.launches for k, fn in counters.items()}
    return res


def lmm_nccl_rank(rank, plan) -> dict:
    """One NCCL rank on the card: stablelm-3b's float32 check (FSDP on,
    LMM_CHECK_LAYERS layers) one step through ``lm_train_cell`` on a
    (1, 1) mesh."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.cells import lm_train_cell
    from repro_torch.launch.mesh import make_debug_mesh
    mesh = make_debug_mesh(1, 1)
    need(dist.get_backend() == "nccl", "the group runs on NCCL")
    counters = reset_counts()
    cell = lm_train_cell(lmm_configs(plan)["stablelm_check"], mesh)
    batch = {k: torch.from_numpy(v)
             for k, v in plan["batches"]["stablelm"].items()}
    res = lmm_cell_step(cell, batch, update=True)
    res["launches"] = {k: fn.launches for k, fn in counters.items()}
    return res


def lm_mesh_phase(card: str) -> tuple:
    """The LM mesh phase (see the module docstring): one device's
    references in this process, one NCCL rank, 4 gloo ranks on the card
    as a (data=2, model=2) mesh (``lmm_rank``) and 3 as a (1, 3) mesh
    (``ffn_rank``).  Counts set to 0 just before the ranks, read just
    after, the ranks' summed.  Returns (launches, flash_attention's
    (shape -> launches))."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.launch.mesh import spawn
    from repro_torch.launch.train import lm_stream
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train.loop import on_device
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    seq = lm_train_seq()
    plan = {}
    cfgs = lmm_configs(plan)
    plan["batches"] = {name: {k: v.numpy() for k, v in next(lm_stream(
        cfgs[name], LMM_BATCH, seq)).items()} for name in ("stablelm",
                                                            "qwen3")}
    dev = {name: on_device({k: torch.from_numpy(v) for k, v in b.items()},
                           "cuda") for name, b in plan["batches"].items()}
    # ------------------------------------ one device: the references
    e, k = cfgs["qwen3"].num_experts, cfgs["qwen3"].num_experts_per_tok
    group = LMM_BATCH // LMM_MESH[0] * seq // LMM_MESH[1]
    counts = []
    from repro_torch.models import lm
    with torch.no_grad(), grouped_moe(*LMM_MESH, counts):
        lm.forward(lm.model_init(torch.Generator(device="cuda")
                                 .manual_seed(0), cfgs["qwen3"]),
                   dev["qwen3"]["tokens"],
                   dataclasses.replace(cfgs["qwen3"], moe_shard_map=False,
                                       moe_capacity_factor=1.25))
    dropped = 1 - sum(c[1] for c in counts) / sum(c[0] for c in counts)
    counts = []
    with torch.no_grad(), grouped_moe(*LMM_MESH, counts):
        check = dataclasses.replace(cfgs["qwen3_check"],
                                    moe_shard_map=False,
                                    moe_capacity_factor=e / k)
        lm.forward(lm.model_init(torch.Generator(device="cuda")
                                 .manual_seed(0), check),
                   dev["qwen3"]["tokens"], check)
    plan["qw_factor"] = no_drop_factor(counts, e, k, group)
    cfgs = lmm_configs(plan)
    gc.collect()
    torch.cuda.empty_cache()
    counts = []
    ref = {"qwen3_check": lmm_one_device(
        dataclasses.replace(cfgs["qwen3_check"], moe_shard_map=False),
        dev["qwen3"], update=False, twin=grouped_moe(*LMM_MESH, counts))}
    need(all(c[0] == c[1] for c in counts), "qwen3's check drops nothing "
         f"at capacity factor {plan['qw_factor']:.4f}")
    ref["stablelm_check"] = lmm_one_device(cfgs["stablelm_check"],
                                           dev["stablelm"], update=True)
    ref["stablelm"] = lmm_one_device(cfgs["stablelm"], dev["stablelm"],
                                     update=False)
    params, x, top_k = ffn_inputs()
    with torch.no_grad():
        from repro_torch.nn import moe
        _, gate_i, _ = moe.route(x.reshape(-1, x.shape[-1]),
                                 params["router"], top_k)
        most = int(torch.bincount(gate_i.reshape(-1),
                                  minlength=params["router"].shape[1]).max())
    plan["ffn_factor"] = most * params["router"].shape[1] / (FFN_TOKENS
                                                             * top_k)
    ref["ffn"] = ffn_forward_backward(params, x, top_k, plan["ffn_factor"])
    del params, x, dev
    gc.collect()
    torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t_phase
    log(f"lm mesh: one device's references {t_ref:.1f}s; this process "
        f"holds {torch.cuda.memory_allocated() / 2**30:.3f} GiB "
        f"({torch.cuda.memory_reserved() / 2**30:.3f} reserved) before the "
        f"ranks start")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_lm_mesh_")
    plan["ckpt"] = os.path.join(tmp, "ckpt")
    counters = reset_counts()
    try:
        # the distributed phases' NCCL checks and this one, one process
        nccl, nccl_launches, t_nccl = run_nccl_jobs("lm", lmm_nccl_rank,
                                                    plan, tmp)
        t0 = time.perf_counter()
        ranks = spawn(lmm_rank, LMM_MESH[0] * LMM_MESH[1], backend="gloo",
                      device="cuda:0", args=(plan,), store_dir=tmp,
                      timeout_s=LMM_TIMEOUT)
        t_ranks = time.perf_counter() - t0
        ckpt_steps = ckpt_lib.list_steps(plan["ckpt"])
        t0 = time.perf_counter()
        ffn = spawn(ffn_rank, FFN_MESH[1], backend="gloo", device="cuda:0",
                    args=(plan,), store_dir=tmp, timeout_s=LMM_TIMEOUT)
        t_ffn = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {name: fn.launches for name, fn in counters.items()}
    for r in [nccl] + ranks + ffn:
        for name, v in r["launches"].items():
            launches[name] += v

    # ------------------------------------------------------- the bars
    lr, steps = 3e-4, 1
    for name in ("stablelm_check", "qwen3_check"):
        got = {k: v for k, v in lmm_merge([r[name] for r in ranks],
                                          "grads").items()}
        gap = lmm_gap(got, ref[name]["grads"])
        loss_gap = abs(ranks[0][name]["loss"] - ref[name]["loss"])
        line = (f"lm mesh {name}: loss {ranks[0][name]['loss']:.7f} vs one "
                f"device {ref[name]['loss']:.7f} (gap {loss_gap:.3g}); the "
                f"gradients at {LMM_SAMPLES} elements a leaf within "
                f"{gap:.3g} of the bar {LMM_TOL} + {LMM_TOL}|g|")
        need(loss_gap <= LMM_TOL + LMM_TOL * abs(ref[name]["loss"]),
             f"{name}: the mesh's loss within {LMM_TOL} of one device's")
        need(gap <= 1.0, f"{name}: every sampled gradient within the bar")
        if "params" in ref[name]:
            tiny = {p: np.abs(v) < 1e-6
                    for p, v in ref[name]["grads"].items()}
            pgap = lmm_gap(lmm_merge([r[name] for r in ranks], "params"),
                           ref[name]["params"], tiny, 2 * lr * steps)
            line += (f"; params after the adamw step within {pgap:.3g} of "
                     f"the bar ({sum(int(t.sum()) for t in tiny.values())} "
                     f"elements of first-step |g| < 1e-6 barred at 2 lr)")
            need(pgap <= 1.0, f"{name}: every sampled param within the bar")
        log(line + f" [{card}]")
    # NCCL (1, 1): the one-device route, bit for bit
    same = nccl["loss"] == ref["stablelm_check"]["loss"] and all(
        np.array_equal(nccl[key][p][1], ref["stablelm_check"][key][p])
        for key in ("grads", "params") for p in ref["stablelm_check"][key])
    need(same, "NCCL (1, 1): stablelm-3b's loss, gradients and params "
         "bit-identical to one device's")
    # stablelm-3b and qwen3 at CONFIG on the mesh
    st, qw = ranks[0]["stablelm"], ranks[0]["qwen3"]
    for r in ranks:
        for name in ("stablelm", "qwen3"):
            need(r[name]["losses"] == ranks[0][name]["losses"],
                 f"{name}: every rank reports the same global losses")
            need(all(math.isfinite(x) for x in r[name]["losses"]),
                 f"{name}: finite losses")
    st_gap = abs(st["losses"][0] - ref["stablelm"]["loss"])
    need(st_gap <= LMM_BF16_LOSS_TOL, f"stablelm-3b on the mesh: the first "
         f"loss within {LMM_BF16_LOSS_TOL} of one device's")
    for name, cfg in (("stablelm", cfgs["stablelm"]), ("qwen3", cfgs["qwen3"])):
        need(abs(ranks[0][name]["losses"][0] - math.log(cfg.vocab_size))
             < 1.0, f"{name}: the first loss near ln V")
    ex = ranks[0]["stablelm"]["export"]
    need(ex["rows_equal"] and ex["gap"] <= ASSIGN_TOL,
         "the trained table's export and served rows held to the plain "
         "versions")
    res = [r["resume"] for r in ranks]
    need(all(x["failed"] and x["steps"] == [2] and x["same"]
             and x["losses"] == x["whole"][1:] for x in res),
         "the mesh run failed in step 2 resumed bit-identical to an "
         "uninterrupted one")
    need(ckpt_steps == [1], "one checkpoint of whole arrays, at step 1")
    # the ffn strategy on (1, 3)
    # each weight's gradient sums 4,096 tokens' terms: a partial summed
    # over d_ff in another order moves an element by rounding of the
    # terms (the router's, |g| up to ~220, by ~1e-4 on the CPU too)
    fgap = lmm_gap(lmm_merge(ffn, "grads"), {p: v[1] for p, v in
                                             ref["ffn"]["grads"].items()},
                   leaf_scale=True)
    ogap = lmm_gap(lmm_merge(ffn, "out"), {p: v[1] for p, v in
                                           ref["ffn"]["out"].items()})
    need(fgap <= 1.0 and ogap <= 1.0 and abs(ffn[0]["aux"] - ref["ffn"][
        "aux"]) <= LMM_TOL, "the ffn strategy on (1, 3): outputs, aux and "
         "gradients within the bar of one device's moe_ffn")
    want_flash = {"stablelm": 2 * (LMM_CHECK_LAYERS + cfgs["stablelm"]
                                   .num_layers * LMM_STEPS
                                   + LMM_RESUME_LAYERS * 5),
                  "qwen3": 2 * (QW_CHECK_LAYERS + QW_LAYERS * LMM_STEPS)}
    for r in ranks:
        need(r["launches"]["flash_attention"] == sum(want_flash.values()),
             f"flash_attention launched {sum(want_flash.values())} times on "
             f"every rank ({r['launches']})")
    need(launches["dpq_assign"] == 1 and launches["mgqe_decode"] == 1,
         "the trained table exported and served once")
    # the distributed phases' NCCL checks ran in this phase's process
    for name, v in nccl_launches.items():
        launches[name] += v

    def comm(run):
        c = run["comm"]
        count, nbytes, secs = c["count"], c["bytes"], c["seconds"]
        return (f"{count} gloo collectives, {nbytes / 1e9:.3f} GB from this "
                f"rank, {secs * 1e3:.1f} ms of the traced step's "
                f"{run['ms'][-1]:.1f} ms (compute and launches "
                f"{run['ms'][-1] - secs * 1e3:.1f} ms)")

    for name, cfg in (("stablelm", cfgs["stablelm"]), ("qwen3", cfgs["qwen3"])):
        runs = [r[name] for r in ranks]
        log(f"lm mesh {cfg.name} ({cfg.num_layers} layers, params "
            f"{cfg.param_dtype}, activations {cfg.dtype}, FSDP "
            f"{cfg.fsdp_params}, moe_shard_map {cfg.moe_shard_map}) on "
            f"(data={LMM_MESH[0]}, model={LMM_MESH[1]}), 4 gloo ranks on "
            f"cuda:0, B={LMM_BATCH} x {seq}: losses {runs[0]['losses']}; "
            f"step ms by rank {[[round(x, 1) for x in r['ms']] for r in runs]}"
            f"; init and placement {[round(r['t_init'], 2) for r in runs]} s;"
            f" state on each rank's device "
            f"{[round(r['state_bytes'] / 2**30, 3) for r in runs]} GiB, peak "
            f"above it {[round(r['peak'] / 2**30, 3) for r in runs]} GiB; "
            f"rank 0's traced step: {comm(runs[0])} [{card}]")
    log(f"lm mesh stablelm-3b: the first loss on the mesh "
        f"{st['losses'][0]:.6f} vs one device's {ref['stablelm']['loss']:.6f}"
        f" (gap {st_gap:.3g}, bar {LMM_BF16_LOSS_TOL}); NCCL (1, 1): the "
        f"float32 check's step bit-identical to one device (loss, "
        f"{LMM_SAMPLES} gradient and param elements a leaf); the trained table gathered, exported "
        f"(codes: {ex['differ']} differ from the plain assignment, gap "
        f"{ex['gap']:.3g}) and {ex['rows']} ids served bit-identical to the "
        f"plain decode")
    log(f"lm mesh qwen3 ({QW_LAYERS} of 48 layers, 128 experts over model "
        f"= 2, the expert strategy): {dropped:.4%} of (token, choice) pairs "
        f"dropped at capacity factor 1.25 (one device's grouped twin at "
        f"init); the float32 check ({QW_CHECK_LAYERS} layer) at factor "
        f"{plan['qw_factor']:.4f}, where nothing drops; peak above the "
        f"ranks' start in the checks "
        f"{[round(r['qwen3_check']['peak'] / 2**30, 3) for r in ranks]} GiB;"
        f" the ffn strategy (one layer, 128 experts over "
        f"model = 3, d_ff 768 -> 256 a rank, {FFN_TOKENS} tokens) at factor "
        f"{plan['ffn_factor']:.4f}: outputs within {ogap:.3g} of the bar, "
        f"gradients within {fgap:.3g} of it at each leaf's scale, aux {ffn[0]['aux']:.7f} vs "
        f"{ref['ffn']['aux']:.7f}, forward and backward "
        f"{[round(r['seconds'], 3) for r in ffn]} s a rank [{card}]")
    for name in ("stablelm", "qwen3"):
        dry_check(f"lm mesh {name}", [r[name]["comm"] for r in ranks],
                  max(r[name]["ms"][-1] for r in ranks), card)
    log(f"lm mesh resume (stablelm-3b at {LMM_RESUME_LAYERS} layers, FSDP, "
        f"ZeRO-1): failed in step 2, resumed from the step-1 checkpoint of "
        f"whole arrays bit-identical to the uninterrupted run, "
        f"{res[0]['seconds']:.1f} s for the three runs")
    log(f"lm mesh phase {time.perf_counter() - t_phase:.1f}s (one device's "
        f"references {t_ref:.1f}s, NCCL {t_nccl:.1f}s for the three "
        f"phases' checks, {nccl['seconds']:.1f}s of it this phase's; 4 ranks "
        f"{t_ranks:.1f}s, the ffn strategy's 3 ranks {t_ffn:.1f}s); "
        f"launches {launches}")
    shapes = {("stablelm-3b mesh rank", 1, seq, 16, 16, 80, FULL_WINDOW):
              4 * want_flash["stablelm"],
              ("qwen3 mesh rank", 1, seq, 16, 2, 64, FULL_WINDOW):
              4 * want_flash["qwen3"],
              # the NCCL rank's layers are the LM training phase's
              (f"{cfgs['stablelm'].name} train", LMM_BATCH, seq, 32, 32, 80,
               FULL_WINDOW): nccl["launches"]["flash_attention"]}
    need(nccl["launches"]["flash_attention"] == 2 * LMM_CHECK_LAYERS,
         "the NCCL rank launched flash_attention twice a layer")
    return launches, shapes


# ----------------------------------------------------------------------
# the LM serving mesh phase: lm_prefill_cell and lm_decode_cell on ranks
# ----------------------------------------------------------------------

LMS_MESH = (2, 2)                      # (data, model): 4 gloo ranks, one card
LMS_ARCH = "gemma3-4b"
# (a): gemma3-4b's CONFIG at full width and depth, one prompt a data rank
LMS_BATCH, LMS_PROMPT, LMS_STEPS = 2, 4096, 8
LMS_MAX_SEQ = LMS_PROMPT + LMS_STEPS
# (b): float32 at full width, gemma3-4b's loc, glob and rem stacks (7
# layers), a prompt past the local window of 1,024 (the local ring
# wraps), on (2, 2) (the kv heads over model) and on (1, 8) (4 kv heads
# do not divide 8: the cache's sequence over model); the cache's 1,108
# slots rounded up to whole blocks of 8
LMS_CHECK_LAYERS = 7
LMS_CHECK_PROMPT, LMS_CHECK_STEPS = 1100, 4
LMS_CHECK_MAX_SEQ = 1112
LMS_CHECK_TOL = 1e-4
LMS_SEQ_MESH = (1, 8)
# (c): qwen3-moe-30b-a3b's CONFIG (bf16) at full width, 4 of 48 layers,
# the global MoE formulation (128 experts over model = 2)
QWS_LAYERS = 4
QWS_PROMPT, QWS_STEPS = 1024, 8
# (d): LM_SHAPES' decode_32k through lm_decode_cell, its global batch of
# 128 cut to 4 (4 x 32,768 slots of gemma3-4b's 34 layers: 22.8 GB of
# bf16 cache); the cache drawn from seeded generators, positions
# 0..32,759 written
LMS_DECODE_BATCH = 4
LMS_DECODE_VALID = 32760
LMS_DECODE_STEPS = 3
# LM_BARS' bars over their sound readings (gemma3-4b: 0.125 / 0.1016)
LMS_NOISE_RULE = 1.25
# (d)'s planted fault: in one step after the timed ones, the rank at
# these (data, model) coordinates reads its cache block's two batch rows
# swapped
LMS_PLANT_COORDS = (0, 1)
# (c)'s bar on the share of (token, choice) routes whose expert one
# device does not choose, LM_BARS' rule over the reading of one device
# against its own run with the attention in float32: 486 of 66,048
# (the mesh read 467, one device's routes of the other prompt 57,672;
# H100 80GB HBM3 at 700 W)
LMS_FLIP_NOISE = 486 / 66048
LMS_FLIP_BAR = LMS_NOISE_RULE * LMS_FLIP_NOISE
LMS_TIMEOUT = 900.0

# (e): LM_SHAPES' long_500k (B = 1 over 524,288 cached positions) through
# build_cell with the split_cache option: the token whole on every rank,
# the global layers' cache sequence over data, the kv heads over model;
# float32 activations (the global layers' cache 26.8 GB), its K and V
# drawn chunk by chunk from seeded generators so a rank draws its block
# alone, positions 0..LONG_VALID-1 written
LONG_VALID = 524288 - 4
LONG_STEPS = 3
LONG_CHUNK = 65536
LONG_PLANT_COORDS = (0, 1)             # the rank whose key halves swap


def long_shape():
    from repro_torch.configs.base import LM_SHAPES
    return next(s for s in LM_SHAPES if s.name == "long_500k")


def long_config():
    """gemma3-4b's CONFIG with float32 activations (the split cache is
    build_cell's ``split_cache`` option)."""
    return dataclasses.replace(lms_configs()["a"], dtype="float32")


def long_fill_cache(cache: dict, cfg, mesh=None) -> None:
    """Fill ``cache`` (whole, or with a ``mesh`` this rank's block under
    ``lm_cache_spec`` of B = 1) in place: each layer's K and V drawn
    LONG_CHUNK slots at a time (an eighth of a shorter stack's) from a
    generator seeded by its stack,
    layer, leaf and chunk (a rank draws only the chunks of its block),
    V about a mean of its own for each kv head; kpos the position each
    slot holds after LONG_VALID tokens (the local rings wrapped), -1 for
    the global layers' slots not yet written."""
    import zlib
    import numpy as np
    import torch
    from repro_torch.models import lm
    from repro_torch.sharding.collectives import linear_index
    from repro_torch.sharding.rules import NamedSpec, lm_cache_spec
    whole = lm._cache_template(cfg, 1, long_shape().seq_len)
    specs = None if mesh is None else lm_cache_spec(cfg, 1, mesh, False,
                                                    whole)
    for name, leaves in whole.items():
        if name == "pos":
            continue
        lead = tuple(leaves[0].shape[:-4])
        clen = leaves[2].shape[-1]
        slot = torch.arange(clen, dtype=torch.int64, device="cuda")
        if clen >= LONG_VALID:
            kp = torch.where(slot < LONG_VALID, slot, -1)
        else:                            # a ring of clen slots
            kp = LONG_VALID - 1 - (LONG_VALID - 1 - slot) % clen
        kp = kp.to(torch.int32)[None]
        for flat in range(math.prod(lead)):
            idx = tuple(int(i) for i in np.unravel_index(flat, lead))
            sp = [None, None, None] if specs is None else [
                sp_[len(lead):] for sp_ in specs[name]]
            kp_block = kp if sp[2] is None else NamedSpec(mesh, sp[2]).block(
                kp)
            cache[name][2][idx].copy_(kp_block)
            for j in range(2):
                dst = cache[name][j][idx]
                # chunks on a grid of the whole sequence alone, so a
                # block of up to 8 shards is whole chunks
                step = min(LONG_CHUNK, clen // 8)
                start, n = 0, clen
                if sp[j] is not None and sp[j][1] is not None:
                    n = dst.shape[1]
                    start = NamedSpec(mesh, (None, sp[j][1])).block(
                        torch.empty((1, clen), device="meta")).shape[1] \
                        * linear_index(mesh, sp[j][1])
                for c0 in range(start, start + n, step):
                    g = torch.Generator(device="cuda").manual_seed(
                        zlib.crc32(f"long/{name}/{flat}/{j}/{c0}".encode()))
                    t = torch.randn((1, step) + tuple(leaves[j].shape[-2:]),
                                    generator=g, device="cuda")
                    if j == 1:
                        t += torch.randn((1, 1) + tuple(leaves[j].shape[-2:-1])
                                         + (1,), generator=g, device="cuda")
                    if sp[j] is not None and sp[j][2] is not None:
                        t = NamedSpec(mesh, (None, None, sp[j][2])).block(t)
                    dst[:, c0 - start:c0 - start + step].copy_(t)
                    del t
    cache["pos"] = LONG_VALID


def long_decode(step, cache, local, feed, planted=None, mesh=None) -> dict:
    """LONG_STEPS decode steps of ``step`` on ``cache`` fed ``feed``'s
    tokens, the first with the mesh's collectives counted (a ``mesh``),
    each timed; then one more (``last``), ``planted(cache)`` applied
    first where given.  Logits on the host."""
    import torch
    from repro_torch.sharding.collectives import CommStats
    out = {"logits": [], "ms": []}
    with torch.no_grad():
        for i in range(LONG_STEPS):
            if mesh is not None and i == 0:
                mesh.stats = CommStats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                cache, logits = step(cache, local(feed[:, i]))
                torch.cuda.synchronize()
            finally:
                if mesh is not None and i == 0:
                    out["comm"] = dataclasses.asdict(mesh.stats)
                    mesh.stats = None
            out["ms"].append(1e3 * (time.perf_counter() - t0))
            out["logits"].append(logits.float().cpu())
        if planted is not None:
            planted(cache)
        cache, logits = step(cache, local(feed[:, LONG_STEPS]))
        out["last"] = logits.float().cpu()
    return out


def long_swap_block(cache: dict) -> None:
    """(e)'s planted fault, in place: the two halves of this rank's
    block of the global layers' keys swapped, their values left in place,
    so each key of the block stands beside another position's value (a
    sequence block written at the wrong offset)."""
    k = cache["glob"][0]
    n = k.shape[-3] // 2
    first = k.narrow(-3, 0, n).clone()
    k.narrow(-3, 0, n).copy_(k.narrow(-3, n, n))
    k.narrow(-3, n, n).copy_(first)


def long_rank(mesh, plan) -> dict:
    """(e) on this rank: long_500k's cell through ``build_cell`` (the
    params drawn as (a)'s, the artifact (a)'s), its cache block filled
    by ``long_fill_cache``, the steps of ``long_decode``."""
    import torch
    from repro_torch.launch.cells import build_cell
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cell = build_cell(LMS_ARCH, long_shape(), mesh, opts=("split_cache",),
                      cfg=long_config(), artifact=plan["art"]["a"])
    params, art, cache, _ = cell.args
    long_fill_cache(cache, cell.cell.cfg, mesh)
    cache_bytes = sum(t.numel() * t.element_size()
                      for name, leaves in cache.items() if name != "pos"
                      for t in leaves)
    plant = mesh.axis_index("data"), mesh.axis_index("model")
    out = long_decode(lambda c, t: cell.fn(params, art, c, t), cache,
                      cell.cell.local_tokens, plan["feed"]["e"],
                      long_swap_block if plant == LONG_PLANT_COORDS
                      else None, mesh)
    out.update(note=cell.note, cache_bytes=cache_bytes,
               peak=torch.cuda.max_memory_allocated() - before)
    return out



def lms_configs() -> dict:
    """The phase's configs: (a) and (d) gemma3-4b's CONFIG (f32 params,
    bf16 activations); (b) its float32 check at LMS_CHECK_LAYERS, the
    split cache off and on; (c) qwen3's CONFIG at QWS_LAYERS."""
    from repro_torch.configs import get_arch
    _, g = get_arch(LMS_ARCH, smoke=False)
    _, q = get_arch(QW_ARCH, smoke=False)
    check = dataclasses.replace(g, num_layers=LMS_CHECK_LAYERS,
                                dtype="float32", param_dtype="float32")
    return {"a": g, "b": check,
            "b_split": dataclasses.replace(check,
                                           split_local_global_cache=True),
            "c": dataclasses.replace(q, num_layers=QWS_LAYERS), "d": g}


def lms_prompts(cfg, batch: int, prompt: int, seed: int):
    import numpy as np
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, prompt)).astype(np.int32)


@contextlib.contextmanager
def counted_moe(counts: list):
    """Within the block, ``nn/moe.py::moe_ffn`` also records (pairs, kept)
    of each call's routing at its capacity (the global formulation's
    slots, the mesh's as one device's), through the ``route`` of the
    block's entry (a recorder entered after it sees the layer's own
    calls alone)."""
    import torch
    from repro_torch.nn import moe
    single, route = moe.moe_ffn, moe.route

    def counted(params, x, *, top_k, capacity_factor=1.25, **kw):
        e = params["router"].shape[-1]
        xt = x.reshape(-1, x.shape[-1])
        cap = moe.capacity(xt.shape[0], e, top_k, capacity_factor)
        with torch.no_grad():
            _, gate_i, _ = route(xt, params["router"], top_k)
            _, keep = moe.slots(gate_i.reshape(-1), e, cap)
        counts.append((keep.numel(), int(keep.sum()), x.shape[1]))
        return single(params, x, top_k=top_k,
                      capacity_factor=capacity_factor, **kw)

    moe.moe_ffn = counted
    try:
        yield
    finally:
        moe.moe_ffn = single


@contextlib.contextmanager
def recorded_route_ids(into: list):
    """Inside the block every call of ``nn/moe.py::route`` appends its
    expert ids (T, k) to ``into`` (the global formulation's routes on a
    mesh: every token of the batch, on every rank)."""
    from repro_torch.nn import moe
    sound = moe.route

    def recorded(xt, router, top_k):
        out = sound(xt, router, top_k)
        into.append(out[1])
        return out
    moe.route = recorded
    try:
        yield
    finally:
        moe.route = sound


@contextlib.contextmanager
def f32_attention():
    """Within the block the attention (a prefill's and a decode step's)
    runs in float32 on the same bf16 inputs, its output rounded once: the
    reading LM_BARS are set from."""
    from repro_torch.nn import attention as attn
    names = ("dense_attention", "chunked_attention", "decode_attention")
    sound = {n: getattr(attn, n) for n in names}

    def f32(fn):
        def run(q, k, v, *args, **kw):
            return fn(q.float(), k.float(), v.float(), *args, **kw).to(
                q.dtype)
        return run
    for n in names:
        setattr(attn, n, f32(sound[n]))
    try:
        yield
    finally:
        for n in names:
            setattr(attn, n, sound[n])


def route_flips(got: list, want: list) -> int:
    """The (token, choice) routes of ``got`` whose expert is not among
    the same token's choices in ``want`` (lists of (T, k) expert ids, a
    ``route`` call each)."""
    return sum(int((~(a[:, :, None] == b[:, None, :]).any(-1)).sum())
               for a, b in zip(got, want))


def lms_swap_rows(cache: dict) -> None:
    """(d)'s planted fault, in place: this rank's cache block with its
    two batch rows swapped in every layer's K and V."""
    for name, leaves in cache.items():
        if name == "pos":
            continue
        for t in leaves[:2]:
            for idx in itertools.product(*map(range, t.shape[:-4])):
                t[idx].copy_(t[idx].flip(0))


def lms_fill_cache(cache: dict, cfg, batch: int, max_seq: int,
                   mesh=None) -> None:
    """Fill ``cache`` (whole, or with a ``mesh`` this rank's block under
    ``lm_cache_spec``) in place: each layer's K and V of the whole cache
    drawn from a generator seeded by its stack, layer and leaf (so every
    rank draws the same whole cache and keeps its block), V about a mean
    of its own for each batch row and kv head (so that a step's
    attention output tells the rows and heads apart), kpos the
    positions 0..LMS_DECODE_VALID-1 and -1 after; ``pos`` the next."""
    import zlib
    import numpy as np
    import torch
    from repro_torch.models import lm
    from repro_torch.sharding.rules import NamedSpec, lm_cache_spec
    whole = lm.make_cache(cfg, batch, max_seq, device="meta")
    specs = None if mesh is None else lm_cache_spec(cfg, batch, mesh, False,
                                                    whole)
    for name, leaves in whole.items():
        if name == "pos":
            continue
        lead = tuple(leaves[0].shape[:-4])
        clen = leaves[2].shape[-1]
        kp = torch.arange(clen, dtype=torch.int32, device="cuda")
        kp = torch.where(kp < LMS_DECODE_VALID, kp, -1).expand(batch, clen)
        for flat in range(math.prod(lead)):
            idx = tuple(int(i) for i in np.unravel_index(flat, lead))
            for j in range(3):
                if j == 2:
                    t = kp
                else:
                    g = torch.Generator(device="cuda").manual_seed(
                        zlib.crc32(f"{name}/{flat}/{j}".encode()))
                    shape = tuple(leaves[j].shape[len(lead):])
                    t = torch.randn(shape, generator=g, device="cuda")
                    if j == 1:
                        t += torch.randn((batch, 1) + shape[2:],
                                         generator=g, device="cuda")
                    t = t.to(cache[name][j].dtype)
                if specs is not None:
                    t = NamedSpec(mesh, specs[name][j][len(lead):]).block(t)
                cache[name][j][idx].copy_(t)
                del t
    cache["pos"] = LMS_DECODE_VALID


def lms_serve(cfg, mesh, art, prompts, max_seq: int, steps: int,
              feed=None, params=None, trace: bool = False) -> dict:
    """``lm_prefill_cell`` then ``steps`` decode steps of
    ``lm_decode_cell`` on this rank (``mesh``; None: one device, through
    ``models/lm.py`` on the card): each step fed ``feed``'s tokens (B,
    steps) when given, else greedy.  Logits (this rank's rows, on the
    host), tokens, prefill and decode seconds, peak bytes above the
    start; with ``trace`` one more decode step with the mesh's
    collectives counted.  Returns with ``served`` (the placed model)."""
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.cells import lm_decode_cell, lm_prefill_cell
    from repro_torch.models import lm
    from repro_torch.sharding.collectives import CommStats
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    b, s = prompts.shape
    out = {}
    if mesh is None:
        toks_in = torch.from_numpy(prompts).cuda()

        def prefill():
            return lm.prefill(params, toks_in, cfg, max_seq=max_seq,
                              embed_artifact=art)

        def decode(cache, tok):
            return lm.decode_step(params, cache, tok, cfg,
                                  embed_artifact=art)

        def local(t):
            return torch.as_tensor(t).cuda()
    else:
        spec = ShapeSpec("serve", "prefill", seq_len=s, global_batch=b)
        pre = lm_prefill_cell(cfg, spec, mesh, artifact=art,
                              max_seq=max_seq)
        dec = lm_decode_cell(cfg, dataclasses.replace(
            spec, kind="decode", seq_len=max_seq), mesh, served=pre.served)
        torch.cuda.synchronize()
        out["served_bytes"] = torch.cuda.memory_allocated() - before
        toks_in = pre.local_tokens(prompts)
        decode, local = dec.step, dec.local_tokens
        out["served"] = pre.served

        def prefill():
            return pre.step(toks_in)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache, logits = prefill()
        torch.cuda.synchronize()
        out["prefill_s"] = time.perf_counter() - t0
        logits_all = [logits]
        tok = torch.argmax(logits, -1).to(torch.int32)
        toks = [tok]
        t0 = time.perf_counter()
        for i in range(steps):
            if feed is not None:
                tok = local(feed[:, i])
            cache, logits = decode(cache, tok)
            logits_all.append(logits)
            tok = torch.argmax(logits, -1).to(torch.int32)
            toks.append(tok)
        torch.cuda.synchronize()
        out["decode_s"] = time.perf_counter() - t0
        out["logits"] = [x.float().cpu() for x in logits_all]
        del logits_all
        if trace:
            mesh.stats = CommStats()
            try:
                decode(cache, tok)
                out["comm"] = dataclasses.asdict(mesh.stats)
            finally:
                mesh.stats = None
    out["tokens"] = torch.stack(toks, 1).cpu()
    out["cache_bytes"] = sum(t.numel() * t.element_size()
                             for name, leaves in cache.items()
                             if name != "pos" for t in leaves)
    out["peak"] = torch.cuda.max_memory_allocated() - before
    del cache
    return out


def lms_decode_32k(cfg, mesh, served, params, art, feed,
                   planted: bool = False) -> dict:
    """decode_32k on this rank (``mesh``; None: one device): a cache of
    LMS_DECODE_BATCH x the shape's 32,768 slots filled by
    ``lms_fill_cache``, LMS_DECODE_STEPS steps fed ``feed``'s tokens,
    each timed, then one more (``last``), with this rank's cache rows
    swapped first where ``planted``; logits on the host, the cache's
    bytes."""
    import torch
    from repro_torch.configs.base import LM_SHAPES
    from repro_torch.launch.cells import lm_decode_cell
    from repro_torch.models import lm
    shape = next(s for s in LM_SHAPES if s.name == "decode_32k")
    if mesh is None:
        cache = lm.make_cache(cfg, LMS_DECODE_BATCH, shape.seq_len)

        def step(cache, tok):
            return lm.decode_step(params, cache, tok, cfg,
                                  embed_artifact=art)

        def local(t):
            return torch.as_tensor(t).cuda()
    else:
        cell = lm_decode_cell(cfg, shape, mesh, batch=LMS_DECODE_BATCH,
                              served=served)
        need("cut to 4" in cell.note, f"decode_32k's cut named: {cell.note}")
        cache = cell.make_cache()
        step, local = cell.step, cell.local_tokens
    lms_fill_cache(cache, cfg, LMS_DECODE_BATCH, shape.seq_len, mesh)
    out = {"logits": [], "ms": [], "cache_bytes": sum(
        t.numel() * t.element_size() for name, leaves in cache.items()
        if name != "pos" for t in leaves)}
    with torch.no_grad():
        for i in range(LMS_DECODE_STEPS):
            tok = local(feed[:, i])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cache, logits = step(cache, tok)
            torch.cuda.synchronize()
            out["ms"].append(1e3 * (time.perf_counter() - t0))
            out["logits"].append(logits.float().cpu())
        if planted:
            lms_swap_rows(cache)
        cache, logits = step(cache, local(feed[:, LMS_DECODE_STEPS]))
        out["last"] = logits.float().cpu()
    del cache
    return out


def lms_rank(rank, plan) -> dict:
    """One rank of the LM serving mesh phase on (2, 2) (a gloo process on
    the card): (b) both splits, (c), (a) with its traced step, then (d)
    on (a)'s placed model; see ``lm_serve_mesh_phase``."""
    import torch
    from repro_torch.launch.mesh import make_debug_mesh
    mesh = make_debug_mesh(*LMS_MESH)
    need(mesh.device == torch.device("cuda", 0), "every rank on cuda:0")
    counters = reset_counts()
    cfgs = lms_configs()
    out = {"coords": (mesh.axis_index("data"), mesh.axis_index("model"))}
    for key in ("b", "b_split", "c"):
        routes = []
        with recorded_route_ids(routes):
            run = lms_serve(cfgs[key], mesh, plan["art"][key],
                            plan["prompts"][key], plan["max_seq"][key],
                            plan["steps"][key], feed=plan["feed"].get(key))
        run.pop("served")
        run["routes"] = [t.cpu() for t in routes]
        out[key] = run
        del routes
        gc.collect()
        torch.cuda.empty_cache()
    run = lms_serve(cfgs["a"], mesh, plan["art"]["a"], plan["prompts"]["a"],
                    LMS_MAX_SEQ, LMS_STEPS, feed=plan["feed"]["a"],
                    trace=True)
    served = run.pop("served")
    out["a"] = run
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out["d"] = lms_decode_32k(cfgs["d"], mesh, served, None, None,
                              plan["feed"]["d"],
                              planted=out["coords"] == LMS_PLANT_COORDS)
    out["d"]["peak"] = torch.cuda.max_memory_allocated()
    out["d"]["params_bytes"] = lms_bytes(served.params)
    del served
    gc.collect()
    torch.cuda.empty_cache()
    out["e"] = long_rank(mesh, plan)
    out["launches"] = {k: fn.launches for k, fn in counters.items()}
    return out


def lms_seq_rank(rank, plan) -> dict:
    """One rank of (1, 8), where gemma3-4b's 4 kv heads do not divide
    model: (b) with the split cache off and on, then (uncounted) the
    planted fault, the sequence merge without its pmax."""
    import torch
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.sharding import collectives as coll
    mesh = make_debug_mesh(*LMS_SEQ_MESH)
    counters = reset_counts()
    cfgs = lms_configs()
    out = {"coords": (mesh.axis_index("data"), mesh.axis_index("model"))}
    for key in ("b", "b_split"):
        run = lms_serve(cfgs[key], mesh, plan["art"][key],
                        plan["prompts"][key], plan["max_seq"][key],
                        plan["steps"][key])
        run.pop("served")
        out[key] = run
    out["launches"] = {k: fn.launches for k, fn in counters.items()}
    pmax = coll.pmax
    coll.pmax = lambda x, mesh, axes: x.detach().clone()
    try:
        run = lms_serve(cfgs["b"], mesh, plan["art"]["b"],
                        plan["prompts"]["b"], plan["max_seq"]["b"], 1)
        out["planted"] = run["logits"]
    finally:
        coll.pmax = pmax
    return out


def lms_bytes(params: dict) -> int:
    """The bytes of an LM's params but its embedding's (the token table
    stripped: the artifact serves its rows)."""
    from repro_torch.core.schemes.base import tree_leaves
    return sum(t.numel() * t.element_size()
               for name, tree in params.items() if name != "embed"
               for t in tree_leaves(tree))


def lms_top1(got, want, bar: float) -> bool:
    """Top-1 tokens equal, or each row's pick within ``bar`` of the
    reference's best logit (random weights leave near-ties)."""
    import torch
    pick = want.gather(-1, got.argmax(-1)[:, None])[:, 0]
    return bool(torch.equal(got.argmax(-1), want.argmax(-1))) or bool(
        ((want.max(-1).values - pick) <= bar).all())


def lm_serve_mesh_phase(card: str) -> tuple:
    """The LM serving mesh phase (see the module docstring): one device's
    references in this process, then 4 gloo ranks on the card as a
    (data=2, model=2) mesh (``lms_rank``) and 8 as a (1, 8) mesh
    (``lms_seq_rank``).  The token tables exported once here; counts set
    to 0 just before that export and read after the ranks, the ranks'
    summed.  Returns (launches, flash_attention's (shape -> launches))."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.core import Embedding
    from repro_torch.core.schemes.base import tree_map
    from repro_torch.launch.mesh import spawn
    from repro_torch.models import lm
    from repro_torch.sharding.rules import strip_embed_table
    from repro_torch.roofline import HBM_BW
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfgs = lms_configs()
    plan = {"prompts": {"a": lms_prompts(cfgs["a"], LMS_BATCH, LMS_PROMPT, 0),
                        "b": lms_prompts(cfgs["b"], LMS_BATCH,
                                         LMS_CHECK_PROMPT, 1),
                        "c": lms_prompts(cfgs["c"], LMS_BATCH, QWS_PROMPT,
                                         2)},
            "max_seq": {"b": LMS_CHECK_MAX_SEQ, "b_split": LMS_CHECK_MAX_SEQ,
                        "c": QWS_PROMPT + QWS_STEPS},
            "steps": {"b": LMS_CHECK_STEPS, "b_split": LMS_CHECK_STEPS,
                      "c": QWS_STEPS},
            "feed": {"d": np.random.default_rng(3).integers(
                0, cfgs["d"].vocab_size,
                (LMS_DECODE_BATCH, LMS_DECODE_STEPS + 1)).astype(np.int32),
                "e": np.random.default_rng(4).integers(
                    0, cfgs["d"].vocab_size,
                    (1, LONG_STEPS + 1)).astype(np.int32)},
            "art": {}}
    plan["prompts"]["b_split"] = plan["prompts"]["b"]
    # ------------------------------------ the export, once, counted
    counters = reset_counts()
    params = {}
    t0 = time.perf_counter()
    for key in ("a", "c"):
        cfg = cfgs[key]
        params[key] = lm.model_init(torch.Generator(device="cuda")
                                    .manual_seed(0), cfg)
        emb = Embedding(dataclasses.replace(cfg.embedding,
                                            param_dtype=cfg.param_dtype),
                        device="cuda")
        with torch.no_grad():
            art = emb.export(params[key]["embed"])
        plan["art"][key] = tree_map(lambda t: t.cpu(), art)
        params[key] = strip_embed_table(params[key])
        del art
    t_export = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    # the 7-layer check draws the same token table first (model_init
    # draws the embedding before the layers): one artifact serves both
    for key in ("b", "b_split", "d"):
        plan["art"][key] = plan["art"]["a"]
    art = {k: tree_map(lambda t: t.cuda(), v) for k, v in plan["art"].items()}
    # ------------------------------------ one device: the references
    ref, moe_counts, one_routes, f32_routes = {}, [], [], []
    with counted_moe(moe_counts), recorded_route_ids(one_routes):
        ref["c"] = lms_serve(cfgs["c"], None, art["c"], plan["prompts"]["c"],
                             plan["max_seq"]["c"], QWS_STEPS,
                             params=params["c"])
    one_routes = [t.cpu() for t in one_routes]
    plan["feed"]["c"] = ref["c"]["tokens"][:, :-1].numpy()
    # (c)'s noise reading: one device's routes with its attention in
    # float32, fed the same tokens
    with f32_attention(), recorded_route_ids(f32_routes):
        lms_serve(cfgs["c"], None, art["c"], plan["prompts"]["c"],
                  plan["max_seq"]["c"], QWS_STEPS, feed=plan["feed"]["c"],
                  params=params.pop("c"))
    f32_routes = [t.cpu() for t in f32_routes]
    pre_n = [c for c in moe_counts if c[2] > 1]
    dec_n = [c for c in moe_counts if c[2] == 1]
    dropped = {what: 1 - sum(c[1] for c in n) / sum(c[0] for c in n)
               for what, n in (("prefill", pre_n), ("decode", dec_n))}
    gc.collect()
    torch.cuda.empty_cache()
    ref["a"] = lms_serve(cfgs["a"], None, art["a"], plan["prompts"]["a"],
                         LMS_MAX_SEQ, LMS_STEPS, params=params["a"])
    plan["feed"]["a"] = ref["a"]["tokens"][:, :-1].numpy()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ref["d"] = lms_decode_32k(cfgs["d"], None, None, params["a"], art["d"],
                              plan["feed"]["d"])
    with f32_attention():
        ref["d_f32"] = lms_decode_32k(cfgs["d"], None, None, params["a"],
                                      art["d"], plan["feed"]["d"])
    gc.collect()
    torch.cuda.empty_cache()
    # (e) on one device: the same params, the whole cache
    t0 = time.perf_counter()
    lcfg = dataclasses.replace(long_config(), split_local_global_cache=True)
    cache = lm.make_cache(lcfg, 1, long_shape().seq_len)
    long_fill_cache(cache, lcfg)
    ref["e_bytes"] = sum(t.numel() * t.element_size()
                         for name, leaves in cache.items() if name != "pos"
                         for t in leaves)
    ref["e"] = long_decode(lambda c, t: lm.decode_step(
        params["a"], c, t, lcfg, embed_artifact=art["a"]), cache,
        lambda t: torch.as_tensor(t).cuda(), plan["feed"]["e"])
    ref["e"]["peak"] = torch.cuda.max_memory_allocated()
    del cache
    ref["e_s"] = time.perf_counter() - t0
    weights = lms_bytes(params["a"])
    del params["a"]
    gc.collect()
    torch.cuda.empty_cache()
    for key in ("b", "b_split"):
        p = strip_embed_table(lm.model_init(
            torch.Generator(device="cuda").manual_seed(0), cfgs[key]))
        ref[key] = lms_serve(cfgs[key], None, art[key], plan["prompts"][key],
                             plan["max_seq"][key], plan["steps"][key],
                             params=p)
        del p
        gc.collect()
        torch.cuda.empty_cache()
    del art
    gc.collect()
    torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t_phase
    log(f"lm serve mesh: the token tables exported once in {t_export:.1f}s "
        f"(dpq_assign {launches['dpq_assign']}); one device's references "
        f"{t_ref:.1f}s; this process holds "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB before the ranks")
    counters = reset_counts()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_lm_serve_")
    try:
        t0 = time.perf_counter()
        ranks = spawn(lms_rank, LMS_MESH[0] * LMS_MESH[1], backend="gloo",
                      device="cuda:0", args=(plan,), store_dir=tmp,
                      timeout_s=LMS_TIMEOUT)
        t_ranks = time.perf_counter() - t0
        t0 = time.perf_counter()
        seq = spawn(lms_seq_rank, LMS_SEQ_MESH[0] * LMS_SEQ_MESH[1],
                    backend="gloo", device="cuda:0", args=(plan,),
                    store_dir=tmp, timeout_s=LMS_TIMEOUT)
        t_seq = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name, fn in counters.items():
        launches[name] += fn.launches
    for r in ranks + seq:
        for name, v in r["launches"].items():
            launches[name] += v

    # one device again, its routes pinned to the mesh's (the global
    # formulation routes every token on every rank): a router near a tie
    # flips on the psums' rounding, and a flip, or a drop it moves, on
    # the last token's path moves its logits by more than bf16 noise
    mesh_routes = ranks[0]["c"]["routes"]
    need(all(len(r["c"]["routes"]) == len(mesh_routes) and all(
        torch.equal(a, b) for a, b in zip(r["c"]["routes"], mesh_routes))
        for r in ranks), "(c): every rank routes the same tokens alike")
    n_routes = sum(t.numel() for t in mesh_routes)
    flips = {"mesh": route_flips(mesh_routes, one_routes),
             "f32": route_flips(f32_routes, one_routes),
             # planted: a router fed the other prompt's rows
             "planted": route_flips(mesh_routes, [
                 t.reshape(LMS_BATCH, -1, t.shape[-1]).flip(0).reshape(
                     t.shape) for t in one_routes])}
    share = {k: v / n_routes for k, v in flips.items()}
    p = strip_embed_table(lm.model_init(
        torch.Generator(device="cuda").manual_seed(0), cfgs["c"]))
    with pinned_routes([t.cuda() for t in mesh_routes]):
        ref["c_pinned"] = lms_serve(
            cfgs["c"], None, tree_map(lambda t: t.cuda(), plan["art"]["c"]),
            plan["prompts"]["c"], plan["max_seq"]["c"], QWS_STEPS,
            feed=plan["feed"]["c"], params=p)
    del p
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------------------------- the bars
    def rows(r, mesh, key):
        d = r["coords"][0]
        bl = (LMS_DECODE_BATCH if key == "d" else LMS_BATCH) // mesh[0]
        return slice(d * bl, (d + 1) * bl)

    def gaps(group, mesh, key, ref_key=None):
        """Each step's largest |logit diff| over the ranks."""
        return [max(float((r[key]["logits"][i]
                           - want[rows(r, mesh, key)]).abs().max())
                    for r in group)
                for i, want in enumerate(ref[ref_key or key]["logits"])]

    def top1(group, mesh, key, bar, ref_key=None):
        return all(lms_top1(got, ref[ref_key or key]["logits"][i][
            rows(r, mesh, key)], bar) for r in group
            for i, got in enumerate(r[key]["logits"]))

    def fmt(xs):
        return [float(f"{x:.3g}") for x in xs]

    bar_g = LM_BARS[LMS_ARCH][0]
    bar_q = LM_BARS[QW_ARCH][0]
    checks = []
    for key, mesh_shape, group in (("b", LMS_MESH, ranks),
                                   ("b_split", LMS_MESH, ranks),
                                   ("b", LMS_SEQ_MESH, seq),
                                   ("b_split", LMS_SEQ_MESH, seq)):
        g = gaps(group, mesh_shape, key)
        same = all(torch.equal(r[key]["tokens"],
                               ref[key]["tokens"][rows(r, mesh_shape, key)])
                   for r in group)
        log(f"lm serve mesh (b) {cfgs[key].name} float32, {LMS_CHECK_LAYERS} "
            f"layers, split cache {cfgs[key].split_local_global_cache}, on "
            f"{mesh_shape}: prefill of {LMS_BATCH} x {LMS_CHECK_PROMPT} and "
            f"{LMS_CHECK_STEPS} greedy steps, logits within {fmt(g)} of one "
            f"device (bar {LMS_CHECK_TOL}); tokens identical: {same} "
            f"[{card}]")
        checks.append((max(g) <= LMS_CHECK_TOL and same,
                       f"(b) {key} on {mesh_shape}: logits within "
                       f"{LMS_CHECK_TOL} of one device and tokens identical"))
    planted = max(float((r["planted"][1] - ref["b"]["logits"][1][
        rows(r, LMS_SEQ_MESH, "b")]).abs().max()) for r in seq)
    log(f"lm serve mesh (b) planted: the sequence merge without its pmax "
        f"moves the first decode step's logits by {planted:.4g} (bar "
        f"{LMS_CHECK_TOL})")
    checks.append((planted > LMS_CHECK_TOL,
                   "the planted merge fault fails (b)'s bar"))
    a = [r["a"] for r in ranks]
    g_a, t_a = gaps(ranks, LMS_MESH, "a"), top1(ranks, LMS_MESH, "a", bar_g)
    c = a[0]["comm"]
    count, nbytes, secs = c["count"], c["bytes"], c["seconds"]
    layers = cfgs["a"].num_layers
    tok_s = LMS_BATCH * LMS_STEPS / max(x["decode_s"] for x in a)
    one_tok_s = LMS_BATCH * LMS_STEPS / ref["a"]["decode_s"]
    log(f"lm serve mesh (a) {cfgs['a'].name} CONFIG ({layers} layers, f32 "
        f"params, bf16 activations) on (data={LMS_MESH[0]}, model="
        f"{LMS_MESH[1]}), 4 gloo ranks on cuda:0: prefill {LMS_BATCH} x "
        f"{LMS_PROMPT} in {[round(x['prefill_s'], 3) for x in a]} s by rank "
        f"(one device {ref['a']['prefill_s']:.3f} s), {LMS_STEPS} decode "
        f"steps (fed one device's tokens) at {tok_s:.1f} tokens/s (one "
        f"device {one_tok_s:.1f}); logits within {fmt(g_a)} of one device "
        f"(bar {bar_g}), top-1 rule {t_a}; served model "
        f"{[round(x['served_bytes'] / 1e9, 3) for x in a]} GB a rank, cache "
        f"{[round(x['cache_bytes'] / 1e9, 3) for x in a]} GB, peak above "
        f"the start {[round(x['peak'] / 1e9, 3) for x in a]} GB; a decode "
        f"step's collectives (rank 0, traced): {count}, {nbytes / 1e6:.3f} "
        f"MB from this rank, {secs * 1e3:.1f} ms [{card}]")
    checks += [(max(g_a) <= bar_g and t_a, f"(a) {LMS_ARCH}: every step's "
                f"logits within {bar_g} of one device and the top-1 rule"),
               (count == 2 * layers + 3, f"a decode step's collectives: 2 a "
                f"layer, the gather's 2 and the logits' 1 ({count})")]
    c = [r["c"] for r in ranks]
    g_c = gaps(ranks, LMS_MESH, "c", "c_pinned")
    t_c = top1(ranks, LMS_MESH, "c", bar_q, "c_pinned")
    log(f"lm serve mesh (c) {cfgs['c'].name} ({QWS_LAYERS} of 48 layers, "
        f"bf16, 128 experts over model = 2, the global formulation): "
        f"prefill {LMS_BATCH} x {QWS_PROMPT} in "
        f"{[round(x['prefill_s'], 3) for x in c]} s, {QWS_STEPS} steps in "
        f"{[round(x['decode_s'], 3) for x in c]} s; logits within "
        f"{fmt(g_c)} of one device's with its experts pinned to the mesh's "
        f"routes (bar {bar_q}), top-1 rule {t_c}; unpinned "
        f"{fmt(gaps(ranks, LMS_MESH, 'c'))}; of {n_routes} (token, choice) "
        f"routes, {flips['mesh']} ({share['mesh']:.4%}) choose an expert "
        f"one device does not (bar {LMS_FLIP_BAR:.4%}), one device with "
        f"its attention in float32 {flips['f32']} ({share['f32']:.4%}), "
        f"planted (one device's routes of the other prompt) "
        f"{flips['planted']} ({share['planted']:.4%}); pairs dropped at "
        f"capacity 1.25 (one device's routing): prefill "
        f"{dropped['prefill']:.4%}, decode {dropped['decode']:.4%}; served "
        f"model {[round(x['served_bytes'] / 1e9, 3) for x in c]} GB a rank "
        f"[{card}]")
    checks += [(max(g_c) <= bar_q and t_c, f"(c) {QW_ARCH}: every step's "
                f"logits within {bar_q} of one device (experts pinned) and "
                f"the top-1 rule"),
               (share["mesh"] <= LMS_FLIP_BAR, f"(c) {QW_ARCH}: the mesh's "
                f"routes within {LMS_FLIP_BAR:.4%} of one device's"),
               (share["planted"] > LMS_FLIP_BAR, "(c)'s planted routes of "
                "the other prompt fail the routes' bar")]
    # LM_BARS are set about 1.25x above a reading of bf16 noise: the
    # logits' distance to the same run with its attention in float32 on
    # the same bf16 inputs (gemma3-4b's prefill: 0.1016 -> 0.125); the
    # reading at this shape is logged beside the bar
    d = [r["d"] for r in ranks]
    g_d = gaps(ranks, LMS_MESH, "d")
    g_d32 = gaps(ranks, LMS_MESH, "d", "d_f32")
    floor = [float((a_ - b_).abs().max()) for a_, b_ in
             zip(ref["d"]["logits"], ref["d_f32"]["logits"])]
    bar_d = bar_g
    t_d = top1(ranks, LMS_MESH, "d", bar_d)
    planted_d = max(float((r["d"]["last"] - ref["d"]["last"][
        rows(r, LMS_MESH, "d")]).abs().max()) for r in ranks)
    log(f"lm serve mesh (d) bf16 noise at 32,760 cached keys: one device's "
        f"steps against its steps with the decode attention in float32 on "
        f"the same cache {fmt(floor)} (LM_BARS' {bar_g} read at "
        f"gemma3-4b's prefill); the mesh against the latter {fmt(g_d32)}; "
        f"largest |logit| "
        f"{float(max(x.abs().max() for x in ref['d']['logits'])):.4g}; "
        f"planted (rank {LMS_PLANT_COORDS}'s cache rows swapped) the step "
        f"after moves by {planted_d:.4g} (bar {bar_d:.4g})")
    card_bytes = sum(x["params_bytes"] + x["cache_bytes"] for x in d)
    one_bytes = weights + ref["d"]["cache_bytes"]
    mesh_ms = [max(x["ms"][i] for x in d) for i in range(LMS_DECODE_STEPS)]
    log(f"lm serve mesh (d) decode_32k through lm_decode_cell: "
        f"{cfgs['d'].name}, its global batch of 128 cut to "
        f"{LMS_DECODE_BATCH}, a {ref['d']['cache_bytes'] / 1e9:.2f} GB cache "
        f"({[round(x['cache_bytes'] / 1e9, 3) for x in d]} GB a rank), "
        f"positions 0..{LMS_DECODE_VALID - 1}: {LMS_DECODE_STEPS} steps "
        f"{[round(x, 2) for x in mesh_ms]} ms (slowest rank) against a "
        f"bytes bound of {card_bytes / HBM_BW * 1e3:.2f} ms "
        f"({card_bytes / 1e9:.2f} GB on the card: each rank's params and "
        f"cache block); one device {[round(x, 2) for x in ref['d']['ms']]} "
        f"ms against {one_bytes / HBM_BW * 1e3:.2f} ms "
        f"({one_bytes / 1e9:.2f} GB); logits within {fmt(g_d)} of one "
        f"device (bar {bar_d:.4g}), top-1 rule {t_d}; peak a rank "
        f"{[round(x['peak'] / 1e9, 3) for x in d]} GB [{card}]")
    checks += [(max(g_d) <= bar_d and t_d,
                f"(d) decode_32k: every step's logits within {bar_d:.4g} "
                f"of one device on the same cache and the top-1 rule"),
               (planted_d > bar_d, "(d)'s planted swap of one rank's cache "
                "rows fails its bar")]
    # (e) long_500k: the mesh against one device on the same cache
    e = [r["e"] for r in ranks]
    bar_e = LMS_CHECK_TOL
    g_e = [max(float((x["logits"][i] - ref["e"]["logits"][i]).abs().max())
               for x in e) for i in range(LONG_STEPS)]
    same_e = all(torch.equal(x["logits"][i].argmax(-1),
                             ref["e"]["logits"][i].argmax(-1))
                 for x in e for i in range(LONG_STEPS))
    planted_e = max(float((x["last"] - ref["e"]["last"]).abs().max())
                    for x in e)
    log(f"lm serve mesh (e) long_500k through build_cell ({e[0]['note']}): "
        f"{cfgs['a'].name} at float32 activations, B = 1 over "
        f"{long_shape().seq_len:,} slots, a {ref['e_bytes'] / 1e9:.2f} GB "
        f"cache ({[round(x['cache_bytes'] / 1e9, 3) for x in e]} GB a rank), "
        f"positions 0..{LONG_VALID - 1}: {LONG_STEPS} steps "
        f"{[round(max(x['ms'][i] for x in e), 2) for i in range(LONG_STEPS)]}"
        f" ms (slowest rank; the first counted) against one device's "
        f"{[round(x, 2) for x in ref['e']['ms']]} ms; logits within "
        f"{fmt(g_e)} of one device (bar {bar_e}), tokens identical "
        f"{same_e}; planted (rank {LONG_PLANT_COORDS}'s global-layer key "
        f"block halves swapped) the step after moves by "
        f"{planted_e:.4g}; peak a rank "
        f"{[round(x['peak'] / 1e9, 3) for x in e]} GB, one device "
        f"{ref['e']['peak'] / 1e9:.3f} GB; one device's reference "
        f"{ref['e_s']:.1f}s [{card}]")
    checks += [(max(g_e) <= bar_e and same_e,
                f"(e) long_500k: every step's logits within {bar_e} of one "
                f"device on the same cache, the tokens identical"),
               (planted_e > bar_e, "(e)'s planted swap of a rank's sequence "
                "block fails its bar")]
    for ok, what in checks:
        need(ok, what)
    dry_check("lm serve (a) decode", [r["a"]["comm"] for r in ranks],
              1e3 * max(r["a"]["decode_s"] for r in ranks) / LMS_STEPS, card)
    dry_check("long_500k", [x["comm"] for x in e],
              max(x["ms"][0] for x in e), card)
    per_rank = {"a": layers, "b": LMS_CHECK_LAYERS}
    for r in ranks:
        need(r["launches"]["flash_attention"] == per_rank["a"]
             + 2 * per_rank["b"], f"flash_attention on every (2, 2) rank: "
             f"(a)'s {layers} layers and (b)'s twice {LMS_CHECK_LAYERS} "
             f"({r['launches']})")
        need(r["launches"]["mgqe_decode"] > 0, "mgqe_decode on every rank")
    for r in seq:
        need(r["launches"]["flash_attention"] == 2 * per_rank["b"],
             f"flash_attention on every (1, 8) rank ({r['launches']})")
    need(launches["dpq_assign"] > 0, "the token tables exported once")
    n_loc = sum(1 for _, _, w, _ in lm._layer_plan(cfgs["a"], LMS_PROMPT)
                if w < FULL_WINDOW)
    c_loc = sum(1 for _, _, w, _ in lm._layer_plan(cfgs["b"],
                                                   LMS_CHECK_PROMPT)
                if w < FULL_WINDOW)
    shapes = {}
    for name, b, s, h, hkv, n_ranks, n_layers, n_loc_, dtype in (
            ("gemma3-4b mesh rank", 1, LMS_PROMPT, 4, 2, 4, layers, n_loc,
             "bfloat16"),
            ("gemma3-4b f32 check (2, 2) rank", 1, LMS_CHECK_PROMPT, 4, 2, 4,
             2 * LMS_CHECK_LAYERS, 2 * c_loc, "float32"),
            ("gemma3-4b f32 check (1, 8) rank", LMS_BATCH, LMS_CHECK_PROMPT,
             1, 1, 8, 2 * LMS_CHECK_LAYERS, 2 * c_loc, "float32")):
        for window, n in ((LM_LOCAL_WINDOW, n_loc_),
                          (FULL_WINDOW, n_layers - n_loc_)):
            shapes[(name, b, s, h, hkv, 320, window, dtype)] = n * n_ranks
    need(sum(shapes.values()) == sum(r["launches"]["flash_attention"]
                                     for r in ranks + seq),
         "every flash_attention launch of the phase has its shape")
    log(f"lm serve mesh phase {time.perf_counter() - t_phase:.1f}s (one "
        f"device's references {t_ref:.1f}s, 4 ranks {t_ranks:.1f}s, 8 ranks "
        f"{t_seq:.1f}s); launches {launches}")
    return launches, shapes


# ----------------------------------------------------------------------
# the GNN phase: MACE trained on the card
# ----------------------------------------------------------------------

def gnn_shape(name: str):
    from repro_torch.configs.base import GNN_SHAPES
    return next(s for s in GNN_SHAPES if s.name == name)


def gnn_host_graph(shape, started):
    """minibatch_lg's host graph, which the child process of
    :func:`start_gnn_host_graph` built while the earlier phases ran:
    ``random_graph`` over the shape's nodes and edges at d_feat 128
    (``mace_cell``'s width), its CSR and a ``NeighborSampler`` at the
    shape's fanout, with the seconds of each step and the host bytes of
    the graph."""
    import shutil
    import numpy as np
    from repro_torch.data.graph import CSRGraph, NeighborSampler
    t0 = time.perf_counter()
    proc, out_dir = started
    try:
        out, err = proc.communicate(timeout=600)
        lines = [x for x in out.splitlines() if x.startswith("HOSTGRAPH ")]
        if proc.returncode != 0 or len(lines) != 1:
            log(out[-4000:])
            log(err[-4000:])
            need(False, "the host graph's child process ran to its end")
        times = json.loads(lines[0].split(" ", 1)[1])
        g = {k: np.load(os.path.join(out_dir, f"{k}.npy"))
             for k in times["leaves"]}
        csr = CSRGraph(np.load(os.path.join(out_dir, "indptr.npy")),
                       np.load(os.path.join(out_dir, "indices.npy")),
                       shape.n_nodes)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    host = sum(a.nbytes for a in g.values()) + csr.indptr.nbytes \
        + csr.indices.nbytes
    log(f"gnn host graph ({shape.name}): random_graph({shape.n_nodes:,} "
        f"nodes, {shape.n_edges:,} edges, d_feat 128) "
        f"{times['random_graph_s']:.1f}s, CSRGraph.from_edge_index "
        f"{times['csr_s']:.1f}s in a child process beside the earlier "
        f"phases; waited {time.perf_counter() - t0:.1f}s here; "
        f"{host / 2**30:.2f} GiB kept on the host")
    return g, NeighborSampler(csr, shape.fanout, seed=0)


HOST_GRAPH_FLAG = "--gnn-host-graph"


def start_gnn_host_graph():
    """Start building minibatch_lg's host graph (numpy on the host, ~40 s,
    no card) in a child process, so it overlaps the phases before the
    GNN phase: (the process, the directory it writes to), which
    :func:`gnn_host_graph` waits on."""
    import tempfile
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_graph_")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             HOST_GRAPH_FLAG, out_dir], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, out_dir


def gnn_host_graph_child(out_dir: str) -> int:
    """The child's side of :func:`start_gnn_host_graph`: the graph's
    leaves, its CSR's ``indptr`` and ``indices`` as .npy files in
    ``out_dir``, and one line of their names and the seconds each step
    took."""
    import numpy as np
    from repro_torch.data.graph import CSRGraph, random_graph
    shape = gnn_shape("minibatch_lg")
    t0 = time.perf_counter()
    g = random_graph(shape.n_nodes, shape.n_edges, 128, seed=0)
    t1 = time.perf_counter()
    csr = CSRGraph.from_edge_index(g.pop("edge_index"), shape.n_nodes)
    t2 = time.perf_counter()
    for name, a in dict(g, indptr=csr.indptr, indices=csr.indices).items():
        np.save(os.path.join(out_dir, f"{name}.npy"), a)
    print("HOSTGRAPH " + json.dumps({"leaves": sorted(g),
                                     "random_graph_s": t1 - t0,
                                     "csr_s": t2 - t1}), flush=True)
    return 0


def gnn_data(name: str, cfg, host=None):
    """(batches, d_feat, task, sampler host ms a batch): GNN_STEPS + 1
    numpy batches of the shape ``name`` (the last for the profiled
    step).  molecule: ``molecule_batch`` of 128 x 30 atoms x 64 edges,
    seed s for batch s; full_graph_sm: one ``random_graph`` (Cora-sized,
    d_feat 1,433), every node labelled, the same batch each step;
    minibatch_lg: a ``NeighborSampler`` sample of GNN_MINI_SEEDS seeds
    drawn without replacement, the loss masked to them."""
    import numpy as np
    from repro_torch.data.graph import molecule_batch, random_graph
    from repro_torch.launch.cells import mace_shape, sampled_graph
    shape = gnn_shape(name)
    _, _, d_feat, task, _ = mace_shape(shape)
    n = GNN_STEPS + 1
    if name == "molecule":
        return ([molecule_batch(shape.batch_graphs, shape.n_nodes,
                                shape.n_edges, n_species=cfg.num_species,
                                seed=s) for s in range(n)], d_feat, task, None)
    if name == "full_graph_sm":
        g = random_graph(shape.n_nodes, shape.n_edges, shape.d_feat, seed=0)
        return [g] * n, d_feat, task, None
    g, sampler = host
    rng = np.random.default_rng(1)
    batches, ms = [], []
    for _ in range(n):
        seeds = rng.choice(shape.n_nodes, GNN_MINI_SEEDS, replace=False)
        t0 = time.perf_counter()
        batches.append(sampled_graph(g, sampler.sample(seeds)))
        ms.append((time.perf_counter() - t0) * 1e3)
    return batches, d_feat, task, ms


def gnn_model(cfg, d_feat: int, task: str, device="cuda", seed: int = 0):
    """(model, train state, step fn) of MACE at ``cfg``: params seeded
    ``seed`` on ``device`` (a feature projection where ``d_feat``), the
    launcher's ``GNN_OPTIMIZER`` over the task's loss."""
    import torch
    from repro_torch.launch.train import GNN_OPTIMIZER
    from repro_torch.models.gnn.mace import MACE
    from repro_torch.train import optimizer as opt
    model = MACE(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(seed),
                        n_feat=d_feat or None)
    loss = model.energy_loss if task == "energy" else model.node_class_loss
    return (model, opt.TrainState.create(GNN_OPTIMIZER, params),
            opt.make_step_fn(GNN_OPTIMIZER, loss))


def gnn_spanned(name: str, fn):
    """``fn`` with its forward under the profiler range ``name`` and its
    output's backward nodes, back to its tensor inputs, under the same
    range while the backward runs them (``span_backward``)."""
    import torch
    from torch.profiler import record_function
    from repro_torch.core.schemes.base import tree_leaves

    def run(*args, **kw):
        with record_function(name):
            out = fn(*args, **kw)
        if isinstance(out, torch.Tensor) and out.grad_fn is not None:
            stop = {t.grad_fn for t in tree_leaves([list(args), kw])
                    if isinstance(t, torch.Tensor) and t.grad_fn is not None}
            span_backward(out, stop, name)
        return out
    return run


@contextlib.contextmanager
def gnn_traced_spans():
    """Inside the block a MACE training step runs under the GNN_SPANS
    profiler ranges, forward and backward: the radial MLP, the edge
    tensor product, the gathers (senders, species rows) and the sums by
    id (receivers, graphs), the B-basis, the per-l channel mixes, the
    readout, and ``apply_updates`` (clip and adam)."""
    from repro_torch.models.gnn import mace
    from repro_torch.train import optimizer as opt
    methods = {"_radial": "radial MLP", "_edge_tp": "edge TP",
               "_pairwise": "B-basis", "_mix_per_l": "mixes",
               "_readout": "readout"}
    sound = {m: getattr(mace.MACE, m) for m in methods}
    sound_fns = (mace.gather_rows, mace.segment_sum, opt.apply_updates)
    for m, name in methods.items():
        setattr(mace.MACE, m, gnn_spanned(name, sound[m]))
    mace.gather_rows = gnn_spanned("gather/scatter", sound_fns[0])
    mace.segment_sum = gnn_spanned("gather/scatter", sound_fns[1])
    opt.apply_updates = gnn_spanned("optimizer", sound_fns[2])
    try:
        yield
    finally:
        for m in methods:
            setattr(mace.MACE, m, sound[m])
        mace.gather_rows, mace.segment_sum, opt.apply_updates = sound_fns


def gnn_step_split(what: str, state, step, batch: dict) -> dict:
    """One more training step under the profiler, its device time split
    by the GNN_SPANS ranges, each a share of the step's busy time, and
    the busy share of the step's wall time."""
    from repro_torch.train.loop import on_device
    card_batch = on_device(batch, "cuda")
    with gnn_traced_spans():
        split = profile_phase(what, lambda: step(state, card_batch),
                              spans=GNN_SPANS)
    busy = split["busy_ms"]
    rest = busy - sum(split[name] for name in GNN_SPANS)
    log(f"gnn step split ({what}; device time under the profiler's "
        f"ranges): of {busy:.3f} ms busy in {split['wall_ms']:.3f} ms wall "
        f"({100 * busy / split['wall_ms']:.1f}% busy; {split['device_ops']} "
        f"kernels and copies on the device), "
        + ", ".join(f"{name} {split[name]:.3f} ms "
                    f"({100 * split[name] / busy:.1f}%)"
                    for name in GNN_SPANS)
        + f", the rest (harmonics, bessel basis, residuals, loss) "
        f"{rest:.3f} ms ({100 * rest / busy:.1f}%)")
    for name in GNN_SPANS:
        need(split[name] > 0, f"{what}: the trace attributes device time "
             f"to {name}")
    return split


def gnn_train_shape(name: str, cfg, card: str, host=None) -> dict:
    """MACE's ``CONFIG`` trained GNN_STEPS adam steps through
    ``train.fit`` on the shape ``name`` (``gnn_data``): step ms (median
    of steps 2 on) beside the FLOP bound at 67 TFLOP/s f32, peak memory,
    every loss finite, the sampler's host ms a batch; then, for
    molecule and minibatch_lg, one more step profiled and split."""
    import torch
    from repro_torch.launch.cells import mace_shape
    from repro_torch.train.loop import LoopConfig, fit
    from repro_torch.roofline import gnn_step_flops, peak_flops
    t0 = time.perf_counter()
    batches, d_feat, task, sample_ms = gnn_data(name, cfg, host)
    host_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _, state, step = gnn_model(cfg, d_feat, task)
    state, hist = fit(state, step, iter(batches[:GNN_STEPS]),
                      LoopConfig(total_steps=GNN_STEPS, log_every=1))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [h["loss"] for h in hist]
    times = sorted(h["step_time_s"] for h in hist[1:])
    step_ms = times[len(times) // 2] * 1e3
    flops = [gnn_step_flops(cfg, len(b["positions"]),
                            b["edge_index"].shape[1], d_feat)
             for b in batches[:GNN_STEPS]]
    bound_ms = sum(flops) / len(flops) / peak_flops("float32") * 1e3
    nodes = [len(b["positions"]) for b in batches[:GNN_STEPS]]
    edges = batches[0]["edge_index"].shape[1]
    n_up, e_up, *_ = mace_shape(gnn_shape(name))
    up_ms = gnn_step_flops(cfg, n_up, e_up, d_feat) / peak_flops(
        "float32") * 1e3
    upper = "" if n_up == max(nodes) else (
        f"; at the shape's static sizes (N {n_up:,}, E {e_up:,}, as "
        f"mace_cell lowers it) {up_ms:.3f} ms")
    extra = (f"acc {[round(h['acc'], 4) for h in hist]}" if task != "energy"
             else f"rmse {[round(h['rmse'], 4) for h in hist]}")
    sampled = (f"; sampler {[round(x, 1) for x in sample_ms]} ms a batch on "
               f"the host ({GNN_MINI_SEEDS} seeds, fanout "
               f"{gnn_shape(name).fanout})" if sample_ms else "")
    log(f"gnn train ({cfg.name} CONFIG, {name}, {task}, {card}): N "
        f"{nodes} E {edges} d_feat {d_feat}; {GNN_STEPS} adam steps, step "
        f"{step_ms:.3f} ms (median of steps 2-{GNN_STEPS}; all "
        f"{[round(h['step_time_s'] * 1e3, 3) for h in hist]}); bound "
        f"{bound_ms:.3f} ms ({sum(flops) / len(flops):.4g} FLOP at 67 "
        f"TFLOP/s f32, TF32 off{upper}), {step_ms / bound_ms:.1f}x the "
        f"bound; peak "
        f"device memory {peak:.3f} GiB; losses "
        f"{[round(x, 6) for x in losses]}, {extra}; host data "
        f"{host_s:.1f}s{sampled}")
    need(all(math.isfinite(x) for x in losses), f"gnn {name}: finite losses")
    split = None
    if name in ("molecule", "minibatch_lg"):
        split = gnn_step_split(f"mace {name} train step", state, step,
                               batches[GNN_STEPS])
    del state, step, batches
    return {"step_ms": step_ms, "bound_ms": bound_ms, "peak_gib": peak,
            "split": split}


def gnn_card_vs_cpu() -> None:
    """The smoke config through ``gnn_setup`` on the card against the
    CPU from the same params and batches: the first batch's gradients
    within TRAIN_PARAM_TOL (relative to 1 + |g|), then GNN_STEPS adam
    steps' losses within TRAIN_LOSS_RTOL; and ``node_class_loss``'s
    gradients on a sampled subgraph with a feature projection, within
    TRAIN_PARAM_TOL of each leaf's largest (the cubic B-basis of two
    layers takes these gradients to ~1e5, in JAX as here, so an element
    near 0 carries the rounding of terms of that size)."""
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.core.schemes.base import tree_map
    from repro_torch.data.graph import CSRGraph, NeighborSampler, random_graph
    from repro_torch.launch.cells import sampled_graph
    from repro_torch.launch.train import gnn_setup
    from repro_torch.train import optimizer as opt
    from repro_torch.train.loop import on_device
    _, cfg = get_arch("mace", smoke=True)
    model, host, step, data = gnn_setup(cfg, GNN_CHECK_BATCH, device="cpu")
    card = opt.TrainState(tree_map(lambda t: t.cuda(), host.params),
                          tree_map(lambda t: t.cuda(), host.opt_state))

    def gap(got, want):
        return max(float(((g.cpu() - w).abs() / (1 + w.abs())).max())
                   for g, w in zip(got, want))
    batch = next(data)
    e_gap = gap(leaf_grads(model.energy_loss, card.params,
                           on_device(batch, "cuda")),
                leaf_grads(model.energy_loss, host.params,
                           on_device(batch, "cpu")))
    rel = []
    for _ in range(GNN_STEPS):
        card, mc = step(card, on_device(batch, "cuda"))
        host, mh = step(host, on_device(batch, "cpu"))
        rel.append(abs(float(mc["loss"]) - float(mh["loss"]))
                   / abs(float(mh["loss"])))
        batch = next(data)
    g = random_graph(600, 4800, 8, n_classes=cfg.d_readout, seed=3)
    sampler = NeighborSampler(CSRGraph.from_edge_index(g["edge_index"], 600),
                              (5, 3), seed=0)
    sub = sampled_graph(g, sampler.sample(np.arange(64)))
    nc_model, nc_state, _ = gnn_model(cfg, 8, "node_class", device="cpu")
    nc_card = tree_map(lambda t: t.cuda(), nc_state.params)
    got = leaf_grads(nc_model.node_class_loss, nc_card,
                     on_device(sub, "cuda"))
    want = leaf_grads(nc_model.node_class_loss, nc_state.params,
                      on_device(sub, "cpu"))
    n_gap = max(float((g.cpu() - w).abs().max() / w.abs().max())
                for g, w in zip(got, want) if bool(w.any()))
    n_scale = max(float(w.abs().max()) for w in want)
    log(f"gnn train card vs CPU ({cfg.name}, gnn_setup's stream of "
        f"{GNN_CHECK_BATCH} molecules): first-batch gradients within "
        f"{e_gap:.3g} relative to 1 + |g| (bar {TRAIN_PARAM_TOL}); "
        f"{GNN_STEPS} steps' loss relative gaps {[f'{x:.3g}' for x in rel]} "
        f"(bar {TRAIN_LOSS_RTOL}); node_class_loss gradients on a sampled "
        f"subgraph ({len(sub['positions'])} nodes, 64 seeds, d_feat 8; "
        f"|g| up to {n_scale:.4g}) within {n_gap:.3g} of each leaf's "
        f"largest")
    need(max(e_gap, n_gap) <= TRAIN_PARAM_TOL, "gnn: gradients within "
         f"{TRAIN_PARAM_TOL} of the CPU's")
    need(max(rel) <= TRAIN_LOSS_RTOL, f"gnn: losses within "
         f"{TRAIN_LOSS_RTOL} of the CPU's")


def self_loop_padded(g: dict) -> dict:
    """``g`` with one self-loop a node appended, as ``NeighborSampler``
    pads a node of degree 0."""
    import numpy as np
    n = len(g["positions"])
    loops = np.stack([np.arange(n), np.arange(n)]).astype(np.int32)
    return dict(g, edge_index=np.concatenate([g["edge_index"], loops], 1))


def gnn_e3_checks(cfg) -> None:
    """E(3) at ``CONFIG`` on the card, on 8 molecules padded with a
    self-loop a node: the energy unchanged under a rotation (JAX's bar,
    rtol GNN_E3_RTOL, atol GNN_E3_ATOL) and a translation, ``node_out``
    permutation-equivariant; with the edge mask planted away (every
    edge kept, the self-loops' Y(0) with it) the rotation must fail."""
    import numpy as np
    import torch
    from repro_torch.data.graph import molecule_batch
    from repro_torch.models.gnn import mace
    from repro_torch.train.loop import on_device
    model, state, _ = gnn_model(cfg, 0, "energy", seed=3)
    params = state.params
    g = self_loop_padded(molecule_batch(8, 30, 64, n_species=cfg.num_species,
                                        seed=11))
    a, b = 0.7, -1.2
    rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                   [0, 0, 1]])
    rx = np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)],
                   [0, np.sin(b), np.cos(b)]])
    rot = (rz @ rx).astype(np.float32)

    def energy(gr):
        with torch.no_grad():
            return model.apply(params, on_device(gr, "cuda"))["energy"]

    def rotation_gap():
        e1 = energy(g)
        e2 = energy(dict(g, positions=g["positions"] @ rot.T))
        return (float((e1 - e2).abs().max()), float(
            ((e1 - e2).abs() - (GNN_E3_ATOL + GNN_E3_RTOL * e1.abs())).max()),
            float(e1.abs().max()))
    rot_err, rot_over, scale = rotation_gap()
    e1 = energy(g)
    moved = energy(dict(g, positions=g["positions"]
                        + np.float32([[5.0, -3.0, 1.0]])))
    trans_over = float(((moved - e1).abs()
                        - (GNN_E3_ATOL + GNN_E3_RTOL * e1.abs())).max())
    n = len(g["positions"])
    perm = np.random.default_rng(3).permutation(n)
    inv = np.argsort(perm)
    g2 = dict(g, positions=g["positions"][perm], species=g["species"][perm],
              graph_id=g["graph_id"][perm],
              edge_index=inv[g["edge_index"]].astype(np.int32))
    with torch.no_grad():
        out1 = model.apply(params, on_device(g, "cuda"))["node_out"]
        out2 = model.apply(params, on_device(g2, "cuda"))["node_out"]
    want = out1[torch.from_numpy(perm).cuda()]
    perm_over = float(((out2 - want).abs()
                       - (GNN_E3_ATOL + GNN_E3_RTOL * want.abs())).max())
    sound = mace.MACE._edge_mask
    mace.MACE._edge_mask = lambda self, dist: torch.ones_like(dist)
    try:
        bad_err, bad_over, _ = rotation_gap()
    finally:
        mace.MACE._edge_mask = sound
    log(f"gnn E(3) ({cfg.name} CONFIG on the card, 8 molecules + a "
        f"self-loop a node, {n} nodes): rotation |dE| {rot_err:.3g} (|E| up "
        f"to {scale:.4g}; bar atol {GNN_E3_ATOL} + rtol {GNN_E3_RTOL}, "
        f"margin {-rot_over:.3g}), translation margin {-trans_over:.3g}, "
        f"node_out permutation margin {-perm_over:.3g}; with the edge mask "
        f"planted away the rotation's |dE| is {bad_err:.4g} (over the bar "
        f"by {bad_over:.4g})")
    need(rot_over <= 0, "gnn: the energy is rotation-invariant")
    need(trans_over <= 0, "gnn: the energy is translation-invariant")
    need(perm_over <= 0, "gnn: node_out is permutation-equivariant")
    need(bad_over > 0, "gnn: the dropped edge mask fails the rotation check")


def scatter_repeats(e: int, n: int, c: int) -> dict:
    """{op: (whether it gives the same bits twice, device ms a call)}
    for a receiver sum of ``e`` (c, 9) rows into ``n`` (``index_add_``,
    atomic adds on the card, and ``mace.segment_sum``, a sorted
    ``index_put_``), each receiver taking e / n rows, and for the
    backward of ``mace.gather_rows`` over as many rows."""
    import torch
    from repro_torch.models.gnn.mace import gather_rows, segment_sum
    g = torch.Generator(device="cuda").manual_seed(7)
    data = torch.randn((e, c, 9), generator=g, device="cuda")
    ids = torch.randint(0, n, (e,), generator=g, device="cuda")
    x = torch.randn((n, c, 9), generator=g, device="cuda")

    def gather_grad():
        t = x.clone().requires_grad_(True)
        return torch.autograd.grad((gather_rows(t, ids) * data).sum(), t)[0]
    out = {}
    for name, fn in (("index_add_", lambda: torch.zeros_like(x).index_add_(
            0, ids, data)), ("segment_sum", lambda: segment_sum(data, ids, n)),
                     ("gather backward", gather_grad)):
        a, b = fn(), fn()
        out[name] = (torch.equal(bits(a), bits(b)),
                     time_ms(fn, iters=5, warmup=1, hold=False)[0])
    return out


@contextlib.contextmanager
def gnn_stream_not_positioned():
    """A planted fault: inside the block, a resumed MACE run's stream
    starts at the first batch, not at its checkpoint's."""
    from repro_torch.launch import train as train_mod
    sound = train_mod.gnn_stream
    train_mod.gnn_stream = lambda cfg, b, start=0: sound(cfg, b, 0)
    try:
        yield
    finally:
        train_mod.gnn_stream = sound


def gnn_repeat_checks(cfg, full_graph: dict) -> None:
    """One adam step at ``CONFIG`` run twice from the same state on the
    same batch, bit for bit (molecule, and full_graph_sm, whose Zipf
    senders pile thousands of rows onto the gather's backward); a
    ``--full`` run failed at step 3 and resumed, bit-identical to an
    uninterrupted one (a resume on the wrong batches must differ); and
    whether ``index_add_`` would have repeated at minibatch_lg's
    receiver sum."""
    import torch
    from repro_torch.core.schemes.base import tree_leaves, tree_map
    from repro_torch.data.graph import molecule_batch
    from repro_torch.launch.cells import mace_shape
    from repro_torch.train import optimizer as opt
    from repro_torch.train.loop import on_device
    shape = gnn_shape("molecule")
    cases = (("molecule", molecule_batch(
        shape.batch_graphs, shape.n_nodes, shape.n_edges,
        n_species=cfg.num_species, seed=0), 0, "energy"),
             ("full_graph_sm", full_graph, full_graph["node_feats"].shape[1],
              "node_class"))
    same = {}
    for name, batch, d_feat, task in cases:
        _, state, step = gnn_model(cfg, d_feat, task)
        runs = []
        for _ in range(2):
            s = opt.TrainState(tree_map(torch.clone, state.params),
                               tree_map(torch.clone, state.opt_state))
            runs.append(step(s, on_device(batch, "cuda"))[0])
        same[name] = all(torch.equal(bits(a), bits(b)) for a, b in zip(
            tree_leaves(runs[0].params), tree_leaves(runs[1].params)))
        del state, runs
    n, e, *_ = mace_shape(gnn_shape("minibatch_lg"))
    probe = scatter_repeats(e, n, cfg.d_hidden)
    t0 = time.perf_counter()
    gap, resumed_same, bad = resume_gap(
        "mace", planted=gnn_stream_not_positioned, smoke=False,
        batch=GNN_CHECK_BATCH)
    log(f"gnn repeat ({cfg.name} CONFIG): one step twice bit-identical: "
        f"{same}; at minibatch_lg's receiver sum ({e:,} rows of "
        f"({cfg.d_hidden}, 9) into {n:,}) the same bits twice, device ms a "
        f"call: " + ", ".join(f"{k} {ok} {ms:.3f} ms"
                              for k, (ok, ms) in probe.items()) + "; "
        f"resume (--full, gnn_setup's stream, {time.perf_counter() - t0:.1f}"
        f"s): gap {gap:.3g}, bit-identical={resumed_same}; resumed on a "
        f"stream not positioned at the checkpoint: gap {bad:.3g}")
    need(all(same.values()), "gnn: a step repeats bit for bit")
    need(probe["segment_sum"][0] and probe["gather backward"][0],
         "gnn: the receiver sum and the gather's backward repeat")
    need(resumed_same, "gnn: a resumed run is bit-identical to an "
         "uninterrupted one")
    need(bad > 0, "gnn: a resume on the wrong batches differs")


def gnn_phases(card: str, started) -> tuple:
    """The GNN phase (see the module docstring): MACE's CONFIG trained on
    GNN_SHAPE_NAMES and through the CLI with every kernel's launch count
    set to 0 just before and read just after (0 required: no Pallas
    function lies on the JAX path), then the card against the CPU, E(3),
    repeatability and resume.  Returns (the launches, all 0, and
    minibatch_lg's first sampled subgraph, which the cells mesh phase
    trains on)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import train as train_mod
    t_phase = time.perf_counter()
    _, cfg = get_arch("mace", smoke=False)
    host = gnn_host_graph(gnn_shape("minibatch_lg"), started)
    counters = reset_counts()
    results = {}
    for name in GNN_SHAPE_NAMES:
        results[name] = gnn_train_shape(
            name, cfg, card, host if name == "minibatch_lg" else None)
        gc.collect()
        torch.cuda.empty_cache()
    mini = gnn_first_sample(host)
    del host
    t_cli = time.perf_counter()
    run = train_mod.main(["--arch", "mace", "--full", "--steps",
                          str(GNN_STEPS), "--log-every", "1"])
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"gnn CLI (launch.train --arch mace --full --steps {GNN_STEPS}, "
        f"{time.perf_counter() - t_cli:.1f}s): losses "
        f"{[round(h['loss'], 6) for h in run.history]}; kernel launches "
        f"over the GNN path {launches}")
    need(all(math.isfinite(h["loss"]) for h in run.history),
         "gnn CLI: finite losses")
    need(sum(launches.values()) == 0, "gnn: no kernel launched (no Pallas "
         "function lies on MACE's path)")
    del run
    gnn_card_vs_cpu()
    gnn_e3_checks(cfg)
    from repro_torch.data.graph import random_graph
    sm = gnn_shape("full_graph_sm")
    gnn_repeat_checks(cfg, random_graph(sm.n_nodes, sm.n_edges, sm.d_feat,
                                        seed=0))
    gc.collect()
    torch.cuda.empty_cache()
    log(f"gnn phase {time.perf_counter() - t_phase:.1f}s ({card}): "
        + "; ".join(f"{name} {r['step_ms']:.3f} ms a step "
                    f"({r['step_ms'] / r['bound_ms']:.1f}x its "
                    f"{r['bound_ms']:.3f} ms bound), peak "
                    f"{r['peak_gib']:.3f} GiB" for name, r in results.items()))
    return launches, mini


def gnn_first_sample(host) -> dict:
    """A sampled subgraph of minibatch_lg on the GNN phase's sampler, from
    the GNN_MINI_SEEDS seeds ``gnn_data``'s first batch takes."""
    import numpy as np
    from repro_torch.launch.cells import sampled_graph
    g, sampler = host
    shape = gnn_shape("minibatch_lg")
    seeds = np.random.default_rng(1).choice(shape.n_nodes, GNN_MINI_SEEDS,
                                            replace=False)
    return sampled_graph(g, sampler.sample(seeds))


# ----------------------------------------------------------------------
# the cells mesh phase: the recsys serving and retrieval cells and
# MACE's training cell, each rank's share on 4 gloo ranks of the card
# ----------------------------------------------------------------------

CM_MESH = (2, 2)                       # (data, model): 4 gloo ranks, one card
CM_ARCHS = ("deepfm", "autoint", "bst", "two-tower-retrieval")
CM_SERVE = ("serve_p99", "serve_bulk")
CM_TT_ROWS = 2_000_000                 # two-tower's users and items, cut
# retrieval_cand's 1,000,000 candidates, cut where the training path's
# (B, D, 256) distances (and AutoInt's attention, BST's 21 ids a row)
# would not fit 4 ranks and one device on the card
CM_CAND = {"two-tower-retrieval": 1_000_000, "deepfm": 1_000_000,
           "autoint": 262_144, "bst": 32_768}
CM_USER = 7                            # the retrieval cell's query
CM_TOL = 1e-5
CM_TOPK = 100
CM_FLUSHES = 1                         # timed flushes after the compared one
CM_PLANT_GRAPHS = 127                  # molecules: 3,810 nodes pad to 3,812
CM_TIMEOUT = 900.0
# MACE's graphs whose float32 step is a no-op on one device and on the
# mesh alike: the global-norm clip's squares overflow float32, so the
# clip zeroes every gradient (ROADMAP.md §3 fact 4).  Their loss and
# their reduced gradients before the clip are held in float64 too
# (``mace_float64``), where nothing overflows; their float32 loss may
# lie CM_NOISE_RULE times one device's own float32 rounding (read
# against float64) from one device's, beyond 1e-5 relative
CM_NOOP_STEP = ("minibatch_lg",)
CM_NOISE_RULE = 4.0
# a step that is not a no-op moves some param by more than this (adam's
# first step moves an element of |g| >> eps by lr = 1e-3)
CM_MOVED = 1e-4
CM_DEVICE = "cuda"                     # the card; every rank on its index 0


def cm_configs() -> dict:
    """The phase's recsys configs: each ``CONFIG``, two-tower's users and
    items cut to CM_TT_ROWS (50M users are 123 GB of f32 tables)."""
    from repro_torch.configs import get_arch
    out = {arch: get_arch(arch, smoke=False)[1] for arch in CM_ARCHS}
    out["two-tower-retrieval"] = dataclasses.replace(
        out["two-tower-retrieval"], n_users=CM_TT_ROWS, n_items=CM_TT_ROWS)
    return out


def cm_mace_config():
    """MACE's ``CONFIG``."""
    from repro_torch.configs import get_arch
    return get_arch("mace", smoke=False)[1]


def cm_recsys_shape(name: str):
    from repro_torch.configs.base import RECSYS_SHAPES
    return next(s for s in RECSYS_SHAPES if s.name == name)


def cm_batch(arch: str, cfg, b: int, seed: int) -> dict:
    """A global batch of ``b`` rows of uniform ids (numpy), the serving
    cells' inputs (``label`` left out: the cells drop it)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    if arch == "two-tower-retrieval":
        return {"user_ids": rng.integers(0, cfg.n_users, b).astype(np.int32),
                "item_ids": rng.integers(0, cfg.n_items, b).astype(np.int32)}
    if arch == "bst":
        return {"hist_ids": rng.integers(0, cfg.n_items, (b, cfg.seq_len))
                .astype(np.int32),
                "target_id": rng.integers(0, cfg.n_items, b).astype(np.int32)}
    return {"sparse_ids": np.stack([rng.integers(0, v, b) for v in
                                    cfg.field_vocab_sizes], 1)
            .astype(np.int32)}


def cm_corpus(cfg, n: int) -> dict:
    """The two-tower retrieval cell's PQ-coded corpus (numpy, seeded):
    codes (n, n_sub) uint8 and (n_sub, 256, d_out / n_sub) centroids, the
    JAX cell's shapes."""
    import numpy as np
    d_out = cfg.tower_mlp[-1]
    n_sub = 16 if d_out % 16 == 0 else 8
    rng = np.random.default_rng(5)
    return {"codes": rng.integers(0, 256, (n, n_sub)).astype(np.uint8),
            "centroids": (rng.normal(size=(n_sub, 256, d_out // n_sub))
                          / np.sqrt(d_out)).astype(np.float32)}


def cm_rows(model, artifacts, batch, mesh=None):
    """The decoded rows a CTR model's serve reads (every field, or bst's
    item table), through the same placed path."""
    import torch
    from repro_torch.models.recsys.fields import serve_placed
    with torch.no_grad():
        if model.cfg.model == "bst":
            return serve_placed(model.item_emb, artifacts, model.ids(batch),
                                mesh)
        return model.fields.serve(artifacts, batch["sparse_ids"], mesh=mesh)


def cm_wall_ms(fn, n: int) -> float:
    """Wall ms of one ``fn()`` (the card synchronised), over ``n``."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def cm_counted(mesh, fn):
    """(``fn()``, its wall ms, its collectives: count, bytes a rank and
    seconds with the card synchronised around each)."""
    import torch
    from repro_torch.sharding.collectives import CommStats
    mesh.stats = CommStats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        stats, mesh.stats = mesh.stats, None
    return out, (time.perf_counter() - t0) * 1e3, dataclasses.asdict(stats)


def cm_gnn_graph(name: str, cfg, mini: dict) -> dict:
    """MACE's graph of ``name`` (numpy): molecule 128 molecules of 30
    atoms and 64 edges (seed 0); full_graph_sm a ``random_graph`` of its
    sizes at d_feat 1,433 (seed 0); minibatch_lg the GNN phase's
    sampled subgraph."""
    from repro_torch.data.graph import molecule_batch, random_graph
    shape = gnn_shape(name)
    if name == "molecule":
        return molecule_batch(shape.batch_graphs, shape.n_nodes,
                              shape.n_edges, n_species=cfg.num_species,
                              seed=0)
    if name == "full_graph_sm":
        return random_graph(shape.n_nodes, shape.n_edges, shape.d_feat,
                            seed=0)
    return mini


def cm_plant_graph(cfg) -> dict:
    """CM_PLANT_GRAPHS molecules: 3,810 nodes, which pad to 3,812 on 4
    ranks."""
    from repro_torch.data.graph import molecule_batch
    shape = gnn_shape("molecule")
    return molecule_batch(CM_PLANT_GRAPHS, shape.n_nodes, shape.n_edges,
                          n_species=cfg.num_species, seed=5)


def cm_recsys_reference(arch: str, cfg, tmp: str) -> dict:
    """One device's outputs of ``arch``'s cells: params drawn from seed 0
    on the card (as the cells draw them), a CTR model's artifacts
    exported once (``dpq_assign``; saved to ``tmp`` for the ranks), each
    serving batch's logits and each data shard's decoded rows (crc32),
    the retrieval scores; ms a flush or a scoring call (the card
    synchronised)."""
    import torch
    from repro_torch.core.schemes.base import tree_map
    from repro_torch.launch.cells import (recsys_export, recsys_model,
                                          serve_params)
    from repro_torch.retrieval.flat_pq import adc_scores
    from repro_torch.train.loop import on_device
    model = recsys_model(cfg, device=CM_DEVICE)
    params = model.init(torch.Generator(device=CM_DEVICE).manual_seed(0))
    out = {"serve": {}, "crc": {}, "ms": {}, "art": None}
    arts = sp = None
    if arch != "two-tower-retrieval":
        t0 = time.perf_counter()
        arts = recsys_export(model, params)
        torch.cuda.synchronize()
        out["export_s"] = time.perf_counter() - t0
        out["art"] = os.path.join(tmp, f"{arch}_art.pt")
        torch.save(tree_map(lambda t: t.cpu(), arts), out["art"])
        sp = serve_params(cfg, params)
    data_n = CM_MESH[0]
    for name in CM_SERVE:
        b = cm_recsys_shape(name).batch
        batch = on_device(cm_batch(arch, cfg, b, b), CM_DEVICE)

        def flush():
            with torch.no_grad():
                if arts is None:
                    u, _ = model.user_vec(params, batch["user_ids"])
                    v, _ = model.item_vec(params, batch["item_ids"])
                    return torch.sum(u * v, dim=-1)
                return model.serve(sp, arts, batch)
        out["serve"][name] = flush().cpu()
        out["ms"][name] = cm_wall_ms(flush, CM_FLUSHES)
        if arts is not None:
            rows = cm_rows(model, arts, batch)
            bl = b // data_n
            out["crc"][name] = [mt_crc([rows[d * bl:(d + 1) * bl]])
                                for d in range(data_n)]
            del rows
        del batch
    n = CM_CAND[arch]
    with torch.no_grad():
        if arch == "two-tower-retrieval":
            corpus = cm_corpus(cfg, n)
            out["corpus"] = os.path.join(tmp, "corpus.pt")
            torch.save(corpus, out["corpus"])
            corpus = on_device(corpus, CM_DEVICE)
            user = torch.tensor([CM_USER], dtype=torch.int32,
                                device=CM_DEVICE)

            def score():
                u, _ = model.user_vec(params, user)
                return adc_scores(corpus, u[0])
        else:
            cand = on_device(cm_batch(arch, cfg, n, 11), CM_DEVICE)

            def score():
                return model.apply(params, cand)[0]
        out["retrieval"] = score().cpu()
        out["ms"]["retrieval"] = cm_wall_ms(score, 1)
    return out


def cm_mace_reference(cfg, graphs: dict, plant: dict) -> dict:
    """One device's adam step of MACE's CONFIG on each graph (params from
    seed 0, ``gnn_model``): metrics, the params before and after (CPU),
    the gradients before the clip and the step's clipped ones (adam's
    m / (1 - b1)), ms of a second step; on a CM_NOOP_STEP graph also the
    metrics and gradients in float64; and the loss on the planting
    batch."""
    import torch
    from repro_torch.core.schemes.base import tree_leaves
    from repro_torch.launch.cells import mace_shape
    from repro_torch.launch.train import GNN_OPTIMIZER
    from repro_torch.train.loop import on_device
    out = {}
    for name, g in graphs.items():
        _, _, d_feat, task, _ = mace_shape(gnn_shape(name))
        model, state, step = gnn_model(cfg, d_feat, task, device=CM_DEVICE)
        fn = model.energy_loss if task == "energy" else model.node_class_loss
        batch = on_device(g, CM_DEVICE)
        res = {"task": task,
               "init": [t.to("cpu", copy=True)
                        for t in tree_leaves(state.params)],
               "pre": [t.cpu() for t in leaf_grads(fn, state.params, batch)]}
        if name in CM_NOOP_STEP:
            grads, metrics = cm_float64_grads(fn, state.params, batch)
            res["f64"] = {"metrics": metrics,
                          "grads": [t.cpu() for t in tree_leaves(grads)]}
            del grads
        state, metrics = step(state, batch)
        res["metrics"] = {k: float(v) for k, v in metrics.items()}
        res["grads"] = [(m / (1 - GNN_OPTIMIZER.b1)).cpu()
                        for m in tree_leaves(state.opt_state["m"])]
        res["params"] = [t.to("cpu", copy=True)
                         for t in tree_leaves(state.params)]
        res["ms"] = cm_wall_ms(lambda: step(state, batch), 1)
        out[name] = res
        del state, step, batch, model
        gc.collect()
        torch.cuda.empty_cache()
    model, state, _ = gnn_model(cfg, 0, "energy", device=CM_DEVICE)
    with torch.no_grad():
        out["plant_loss"] = float(model.energy_loss(
            state.params, on_device(plant, CM_DEVICE))[0])
    return out


@contextlib.contextmanager
def mace_float64():
    """A stand-in: inside the block, MACE computes in float64 from float64
    params and graph (its CG tables in float64, its readout not cast to
    float32)."""
    from repro_torch.models.gnn.mace import MACE
    from repro_torch.nn.mlp import mlp
    cgs, readout = MACE._cgs, MACE._readout
    MACE._cgs = lambda self, device: [(a.double(), b.double())
                                      for a, b in cgs(self, device)]
    MACE._readout = lambda self, layer, x: mlp(layer["readout"], x[:, :, 0],
                                               act="silu")
    try:
        yield
    finally:
        MACE._cgs, MACE._readout = cgs, readout


def cm_float64_grads(fn, params, graph: dict) -> tuple:
    """(gradient tree, metrics) of ``fn(params, graph)``'s loss with the
    params and the graph's floats in float64 and MACE computing in
    float64 (``mace_float64``): the reading, free of float32 overflow,
    that a CM_NOOP_STEP graph's gradients are held to (MACE's node-class
    terms reach 1e24 at CONFIG, ROADMAP §3 fact 4)."""
    import torch
    from repro_torch.core.schemes.base import tree_map
    from repro_torch.train.optimizer import loss_grads
    p64 = tree_map(lambda t: t.double(), params)
    g64 = {k: v.double() if isinstance(v, torch.Tensor)
           and v.is_floating_point() else v for k, v in graph.items()}
    with mace_float64():
        grads, metrics = loss_grads(fn, p64, g64)
    return grads, {k: float(v) for k, v in metrics.items()}


class CmOtherBlock:
    """A mesh whose ``model`` coordinate is the next rank's: an artifact
    placed through it hands this rank another rank's code block."""

    def __init__(self, mesh):
        self.mesh, self.shape, self.device = mesh, mesh.shape, mesh.device

    def axis_index(self, axis):
        i = self.mesh.axis_index(axis)
        return (i + 1) % self.shape[axis] if axis == "model" else i


def cm_roll_block(psum_scatter):
    """A planted receiver sum that keeps the next rank's node block."""
    import torch
    from repro_torch.sharding.collectives import axes_size

    def wrong(x, mesh, axes, dim=0):
        step = x.shape[dim] // axes_size(mesh, axes)
        return psum_scatter(torch.roll(x, -step, dims=dim), mesh, axes, dim)
    return wrong


def cm_rank_recsys(arch, cfg, mesh, plan, counters) -> dict:
    """One rank's serving and retrieval cells of ``arch`` (see
    ``cells_mesh_phase``)."""
    import torch
    from repro_torch.launch.cells import (recsys_retrieval_cell,
                                          recsys_serve_cell)
    from repro_torch.sharding.rules import place, recsys_artifact_specs
    ref = plan["refs"][arch]
    arts = None if ref["art"] is None else torch.load(ref["art"])
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    cell = recsys_serve_cell(cfg, cm_recsys_shape("serve_p99"), mesh,
                             artifacts=arts)
    out = {"placed": torch.cuda.memory_allocated() - before, "serve": {}}
    mgqe0 = counters["mgqe_decode"].launches
    for name in CM_SERVE:
        b = cm_recsys_shape(name).batch
        batch = cell.local_batch(cm_batch(arch, cfg, b, b))
        t0 = time.perf_counter()
        logits = cell.step(batch)
        torch.cuda.synchronize()
        first = (time.perf_counter() - t0) * 1e3
        ms = cm_wall_ms(lambda: cell.step(batch), CM_FLUSHES)
        _, counted_ms, stats = cm_counted(mesh, lambda: cell.step(batch))
        res = {"logits": logits.cpu(), "first_ms": first, "ms": ms,
               "counted_ms": counted_ms, "stats": stats}
        if arts is not None:
            res["crc"] = mt_crc([cm_rows(cell.model, cell.artifacts, batch,
                                         mesh)])
        out["serve"][name] = res
        if arch == "deepfm" and name == "serve_p99":
            sound = cell.artifacts
            cell.artifacts = place(arts, recsys_artifact_specs(arts, mesh),
                                   CmOtherBlock(mesh))
            out["planted"] = (cell.step(batch).cpu(), mt_crc([cm_rows(
                cell.model, cell.artifacts, batch, mesh)]))
            cell.artifacts = sound
    out["mgqe_decode"] = counters["mgqe_decode"].launches - mgqe0
    out["serve_peak"] = torch.cuda.max_memory_allocated()
    del cell, arts, batch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n = CM_CAND[arch]
    rcell = recsys_retrieval_cell(cfg, cm_recsys_shape("retrieval_cand"),
                                  mesh, n_candidates=n)
    pq0 = counters["pq_score"].launches
    if arch == "two-tower-retrieval":
        corpus = rcell.local_corpus(torch.load(ref["corpus"],
                                               weights_only=False))
        user = torch.tensor([CM_USER], dtype=torch.int32)
        args = (corpus, user)
    else:
        args = (rcell.local_candidates(cm_batch(arch, cfg, n, 11)),)
    scores, out["retrieval_ms"], out["retrieval_stats"] = cm_counted(
        mesh, lambda: rcell.step(*args))
    out["pq_score"] = counters["pq_score"].launches - pq0
    out["scores"] = scores.cpu() if _cm_first(mesh) else mt_crc([scores])
    out["retrieval_peak"] = torch.cuda.max_memory_allocated()
    out["note"] = rcell.note
    del rcell, args, scores
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _cm_first(mesh) -> bool:
    return all(mesh.axis_index(a) == 0 for a in mesh.axis_names)


def cm_rank_mace(cfg, mesh, plan) -> dict:
    """One rank's MACE cells (see ``cells_mesh_phase``)."""
    import torch
    from repro_torch.core.schemes.base import tree_leaves, tree_map
    from repro_torch.launch import cells
    from repro_torch.models.gnn import mace
    out = {}
    for name, path in plan["graphs"].items():
        graph = torch.load(path, weights_only=False)
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        cell = cells.mace_cell(cfg, gnn_shape(name), mesh)
        g = cell.local_graph(graph)
        placed = torch.cuda.memory_allocated() - before
        f64 = None
        if name in CM_NOOP_STEP:
            grads, metrics = cm_float64_grads(cell.loss, cell.state.params,
                                              g)
            with torch.no_grad():
                f64 = {"metrics": metrics, "grads": [
                    t.cpu() for t in tree_leaves(cell.whole_params(
                        cell.reduce(grads)))]}
            del grads
            gc.collect()
            torch.cuda.empty_cache()
        # the reduced gradients before the clip (which scales them in
        # place), as the step computes them
        pre, reduce = [], cell.reduce

        def stash(grads):
            out = reduce(grads)
            pre.append(tree_map(torch.clone, out))
            return out
        cell.reduce = stash
        (state, metrics), ms, stats = cm_counted(
            mesh, lambda: cell.step(cell.state, g))
        cell.reduce = reduce
        res = {"metrics": {k: float(v) for k, v in metrics.items()},
               "counted_ms": ms, "stats": stats, "placed": placed,
               "n_local": g["positions"].shape[0],
               "e_local": g["edge_index"].shape[1], "note": cell.note}
        with torch.no_grad():
            whole = [t.to("cpu", copy=True) for t in tree_leaves(
                cell.whole_params(state.params))]
            res["pre"] = [t.cpu() for t in tree_leaves(
                cell.whole_params(pre[0]))]
        del pre
        res["params"] = whole if _cm_first(mesh) else mt_crc(whole)
        res["crc"] = mt_crc(whole)
        res["f64"] = f64
        if name != "minibatch_lg":
            res["ms"] = cm_wall_ms(lambda: cell.step(state, g), 1)
        res["peak"] = torch.cuda.max_memory_allocated()
        out[name] = res
        del cell, g, state, graph, whole
        gc.collect()
        torch.cuda.empty_cache()
    # planted faults, forward only, from seed 0's params
    plant = torch.load(plan["plant"], weights_only=False)
    cell = cells.mace_cell(cfg, gnn_shape("molecule"), mesh)
    with torch.no_grad():
        out["plant_sound"] = float(cell.loss(cell.state.params,
                                             cell.local_graph(plant))[0])
        sound = mace.psum_scatter
        mace.psum_scatter = cm_roll_block(sound)
        try:
            out["plant_block"] = float(cell.loss(
                cell.state.params, cell.local_graph(plant))[0])
        finally:
            mace.psum_scatter = sound
        pad = cells.pad_graph

        def into_graph0(graph, multiple, task):
            n = len(graph["positions"])
            padded = pad(graph, multiple, task)
            padded["graph_id"][n:] = 0
            return padded
        cells.pad_graph = into_graph0
        try:
            out["plant_pad"] = float(cell.loss(cell.state.params,
                                               cell.local_graph(plant))[0])
        finally:
            cells.pad_graph = pad
    return out


def cm_rank(rank, plan) -> dict:
    """One rank of the cells mesh phase on (2, 2), a gloo process on the
    card: every recsys arch's serving and retrieval cells, then MACE's
    three cells and the planted faults; its kernel launches counted from
    0."""
    import torch
    from repro_torch.launch.mesh import make_debug_mesh
    mesh = make_debug_mesh(*CM_MESH)
    need(mesh.device == torch.device(CM_DEVICE, 0), "every rank on "
         f"{CM_DEVICE}:0")
    counters = reset_counts()
    cfgs = cm_configs()
    out = {"coords": (mesh.axis_index("data"), mesh.axis_index("model"))}
    for arch in CM_ARCHS:
        out[arch] = cm_rank_recsys(arch, cfgs[arch], mesh, plan, counters)
    out["mace"] = cm_rank_mace(cm_mace_config(), mesh, plan)
    out["launches"] = {k: fn.launches for k, fn in counters.items()}
    return out


def cm_params_gap(got, want, grads, task) -> tuple:
    """(largest |got - want| over the elements held at 1e-5, over the
    rest, the rest's count, whether every element meets its bar).  The
    rest are adam's ill-conditioned elements of the first step (``grads``
    one device's clipped gradients; exact zeros update by 0 in both):
    for the energy a |g| < 1e-6, held at 2·lr (``tests/
    test_torch_lm_mesh.py``'s bar); for node classes a |g| below 1e-7 of
    the global norm (at least 1), held at lr (``tests/
    test_torch_gnn_train.py``'s, ROADMAP.md §3 fact 4)."""
    import torch
    if task == "energy":
        tiny = [(g != 0) & (g.abs() < 1e-6) for g in grads]
        held = 2e-3
    else:
        norm = max(float(torch.sqrt(sum(torch.sum(g.double() ** 2)
                                        for g in grads))), 1.0)
        tiny = [(g != 0) & (g.abs() / norm < 1e-7) for g in grads]
        held = 1e-3
    gap, tgap, n_tiny, ok = 0.0, 0.0, 0, True
    for a, b, t in zip(got, want, tiny, strict=True):
        d = (a - b).abs()
        if bool((~t).any()):
            gap = max(gap, float(d[~t].max()))
            ok = ok and bool((d[~t] <= CM_TOL + CM_TOL * b[~t].abs()).all())
        if bool(t.any()):
            tgap = max(tgap, float(d[t].max()))
            ok = ok and float(d[t].max()) <= held
            n_tiny += int(t.sum())
    return gap, tgap, n_tiny, ok


def cm_grads_gap(got, want) -> float:
    """Largest gap of two gradients, leaf by leaf, each relative to its
    leaf's largest |g| in ``want`` (``gnn_card_vs_cpu``'s node-class
    bar); a leaf that is 0 in ``want`` must be 0 in ``got``."""
    gap = 0.0
    for a, b in zip(got, want, strict=True):
        scale = float(b.abs().max())
        d = float((a.double() - b.double()).abs().max())
        gap = max(gap, d / scale if scale > 0 else
                  (0.0 if d == 0 else float("inf")))
    return gap


def cm_close(a: float, b: float) -> bool:
    return abs(a - b) <= CM_TOL + CM_TOL * abs(b)


def cells_mesh_phase(card: str, mini: dict) -> dict:
    """The cells mesh phase (see the module docstring): one device's
    references in this process (the recsys artifacts exported once
    here), then 4 gloo ranks on the card as a (data=2, model=2) mesh
    (``cm_rank``), each held to one device.  Counts set to 0 just
    before the export and read after the ranks, the ranks' summed; the
    phase fails unless every rank launched ``mgqe_decode`` in the
    serving cells and ``pq_score`` in the two-tower retrieval cell.
    Returns the launches."""
    import shutil
    import tempfile
    import torch
    from repro_torch.launch.mesh import spawn
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfgs = cm_configs()
    gcfg = cm_mace_config()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cells_")
    try:
        counters = reset_counts()
        refs = {}
        for arch in CM_ARCHS:
            refs[arch] = cm_recsys_reference(arch, cfgs[arch], tmp)
            gc.collect()
            torch.cuda.empty_cache()
        graphs = {name: cm_gnn_graph(name, gcfg, mini)
                  for name in GNN_SHAPE_NAMES}
        plant = cm_plant_graph(gcfg)
        g_ref = cm_mace_reference(gcfg, graphs, plant)
        plan = {"refs": {a: {"art": r["art"], "corpus": r.get("corpus")}
                         for a, r in refs.items()},
                "graphs": {}, "plant": os.path.join(tmp, "plant.pt")}
        for name, g in graphs.items():
            plan["graphs"][name] = os.path.join(tmp, f"{name}.pt")
            torch.save(g, plan["graphs"][name])
        torch.save(plant, plan["plant"])
        del graphs
        launches = {name: fn.launches for name, fn in counters.items()}
        gc.collect()
        torch.cuda.empty_cache()
        t_ref = time.perf_counter() - t_phase
        log(f"cells mesh: one device's references {t_ref:.1f}s (exports "
            + ", ".join(f"{a} {r['export_s']:.1f}s" for a, r in refs.items()
                        if "export_s" in r)
            + f", dpq_assign {launches['dpq_assign']}); this process holds "
            f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB before the "
            f"ranks")
        counters = reset_counts()
        t0 = time.perf_counter()
        ranks = spawn(cm_rank, CM_MESH[0] * CM_MESH[1], backend="gloo",
                      device=f"{CM_DEVICE}:0", args=(plan,), store_dir=tmp,
                      timeout_s=CM_TIMEOUT)
        t_ranks = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name, fn in counters.items():
        launches[name] += fn.launches
    for r in ranks:
        for name, n in r["launches"].items():
            launches[name] += n
    gib = 2 ** 30
    # ------------------------------------------------ (a), (b) recsys
    for arch in CM_ARCHS:
        ref = refs[arch]
        for name in CM_SERVE:
            want = ref["serve"][name]
            bl = want.shape[0] // CM_MESH[0]
            gap, crc_ok = 0.0, True
            for r in ranks:
                got = r[arch]["serve"][name]
                d = r["coords"][0]
                part = want[d * bl:(d + 1) * bl]
                gap = max(gap, float((got["logits"] - part).abs().max()))
                need(torch.allclose(got["logits"], part, rtol=CM_TOL,
                                    atol=CM_TOL),
                     f"cells {arch} {name}: logits within {CM_TOL} of one "
                     f"device")
                if "crc" in got:
                    crc_ok = crc_ok and got["crc"] == ref["crc"][name][d]
            need(crc_ok, f"cells {arch} {name}: decoded rows bit-identical "
                         f"to one device")
            r0 = ranks[0][arch]["serve"][name]
            cut = (f", users and items cut to {CM_TT_ROWS:,}"
                   if arch == "two-tower-retrieval" else "")
            log(f"cells serve ({arch} CONFIG{cut}, {name} "
                f"B={want.shape[0]:,}, {card}): a flush "
                f"{max(r[arch]['serve'][name]['ms'] for r in ranks):.3f} ms "
                f"on the mesh (slowest rank, mean of {CM_FLUSHES}; first "
                f"{r0['first_ms']:.3f}), one device {ref['ms'][name]:.3f} "
                f"ms; collectives a flush {r0['stats']['count']} "
                f"({r0['stats']['bytes'] / 1e6:.3f} MB a rank, "
                f"{r0['stats']['seconds'] * 1e3:.3f} ms synchronised, the "
                f"counted flush {r0['counted_ms']:.3f} ms); logits within "
                f"{gap:.3g} (bar {CM_TOL})"
                + (f"; rows bit-identical: {crc_ok}" if "crc" in r0 else ""))
        mem = [r[arch]["placed"] / gib for r in ranks]
        log(f"cells serve ({arch}): the served model a rank "
            f"{min(mem):.3f}-{max(mem):.3f} GiB, serving peak "
            f"{max(r[arch]['serve_peak'] for r in ranks) / gib:.3f} GiB; "
            f"mgqe_decode launches a rank "
            f"{[r[arch]['mgqe_decode'] for r in ranks]}")
        if arch != "two-tower-retrieval":
            need(all(r[arch]["mgqe_decode"] > 0 for r in ranks),
                 f"cells {arch}: every rank launched mgqe_decode")
        want = ref["retrieval"]
        got = ranks[0][arch]["scores"]
        same = all(r[arch]["scores"] == mt_crc([got]) for r in ranks[1:])
        gap = float((got - want).abs().max())
        need(same, f"cells {arch} retrieval: every rank holds the same "
                   f"scores")
        need(torch.allclose(got, want, rtol=CM_TOL, atol=CM_TOL),
             f"cells {arch} retrieval: scores within {CM_TOL}")
        extra = ""
        if arch == "two-tower-retrieval":
            top = torch.sort(got, descending=True, stable=True)[1][:CM_TOPK]
            top_w = torch.sort(want, descending=True,
                               stable=True)[1][:CM_TOPK]
            need(torch.equal(top, top_w), "cells two-tower retrieval: the "
                 "top-100 ids identical")
            need(all(r[arch]["pq_score"] > 0 for r in ranks),
                 "cells two-tower retrieval: every rank launched pq_score")
            extra = (f"; top-{CM_TOPK} ids identical; pq_score launches a "
                     f"rank {[r[arch]['pq_score'] for r in ranks]}")
        r0 = ranks[0][arch]
        log(f"cells retrieval ({arch}, {r0['note']}, {card}): "
            f"{max(r[arch]['retrieval_ms'] for r in ranks):.3f} ms on the "
            f"mesh (slowest rank, its first call, counted: the card "
            f"synchronised around each collective), one device "
            f"{ref['ms']['retrieval']:.3f} ms; collectives "
            f"{r0['retrieval_stats']['count']} "
            f"({r0['retrieval_stats']['bytes'] / 1e6:.3f} MB a rank, "
            f"{r0['retrieval_stats']['seconds'] * 1e3:.3f} ms "
            f"synchronised); peak "
            f"{max(r[arch]['retrieval_peak'] for r in ranks) / gib:.3f} GiB "
            f"a rank; scores within {gap:.3g} (bar {CM_TOL}){extra}")
    # ------------------------------------------------ (c) MACE
    for name in GNN_SHAPE_NAMES:
        want = g_ref[name]
        r0 = ranks[0]["mace"][name]
        noop = name in CM_NOOP_STEP
        gap, tgap, n_tiny, ok = cm_params_gap(r0["params"], want["params"],
                                              want["grads"], want["task"])
        pre_gap = max(cm_grads_gap(r["mace"][name]["pre"], want["pre"])
                      for r in ranks)
        moved = max(float((a - b).abs().max())
                    for a, b in zip(r0["params"], want["init"], strict=True))
        log(f"cells mace ({gcfg.name} CONFIG, {name}, {r0['note']}, "
            f"{want['task']}, {card}): a rank's N {r0['n_local']:,} E "
            f"{r0['e_local']:,}; the step "
            + (f"{max(r['mace'][name]['ms'] for r in ranks):.3f} ms on the "
               f"mesh (slowest rank, the second step), "
               if "ms" in r0 else "")
            + f"the counted step {r0['counted_ms']:.3f} ms, one device "
            f"{want['ms']:.3f} ms; collectives a step "
            f"{r0['stats']['count']} ({r0['stats']['bytes'] / 1e6:.3f} MB "
            f"a rank, {r0['stats']['seconds'] * 1e3:.3f} ms "
            f"synchronised); placed "
            f"{max(r['mace'][name]['placed'] for r in ranks) / gib:.3f} "
            f"GiB, peak "
            f"{max(r['mace'][name]['peak'] for r in ranks) / gib:.3f} GiB a "
            f"rank; metrics {[r['mace'][name]['metrics'] for r in ranks]} "
            f"(one device {want['metrics']}); the reduced gradients before "
            f"the clip within {pre_gap:.3g} of each leaf's largest "
            + ("(float32, reported: see below)" if noop
               else f"(bar {CM_TOL})")
            + f"; {sum(int(g.count_nonzero()) for g in want['grads']):,} of "
            f"{sum(g.numel() for g in want['grads']):,} one device's clipped "
            f"elements not 0")
        need(all(r["mace"][name]["crc"] == r0["crc"] for r in ranks),
             f"cells mace {name}: every rank holds the same params")
        for k, v in want["metrics"].items():
            if noop and k == "loss":
                continue
            need(all(cm_close(r["mace"][name]["metrics"][k], v)
                     for r in ranks),
                 f"cells mace {name}: {k} within {CM_TOL} of one device")
        if not noop:
            need(pre_gap <= CM_TOL, f"cells mace {name}: the reduced "
                 f"gradients within {CM_TOL} of one device's")
            log(f"cells mace {name}: params within {gap:.3g} (bar {CM_TOL}) "
                f"of one device's step, {n_tiny} ill-conditioned elements "
                f"within {tgap:.3g} (bar "
                f"{'2·lr' if want['task'] == 'energy' else 'lr'}); the step "
                f"moved a param by up to {moved:.3g} (bar > {CM_MOVED})")
            need(ok, f"cells mace {name}: params within the adam bar of one "
                     f"device's step")
            need(moved > CM_MOVED, f"cells mace {name}: the step moved the "
                                   f"params")
            continue
        # a no-op step: its float32 loss and its float64 gradients
        f64 = want["f64"]
        one = want["metrics"]["loss"]
        noise = abs(one - f64["metrics"]["loss"])
        bar = CM_TOL * abs(one) + CM_NOISE_RULE * noise
        gaps = [abs(r["mace"][name]["metrics"]["loss"] - one) for r in ranks]
        g64 = max(cm_grads_gap(r["mace"][name]["f64"]["grads"], f64["grads"])
                  for r in ranks)
        m64 = [r["mace"][name]["f64"]["metrics"] for r in ranks]
        still = all(bool(torch.equal(a, b)) for a, b in
                    zip(want["params"], want["init"], strict=True))
        log(f"cells mace {name}: the float32 step is a no-op on one device "
            f"and on the mesh (the clip's squares overflow float32 and it "
            f"zeroes every gradient, ROADMAP §3 fact 4): params unchanged "
            f"bit for bit on one device {still}, the mesh's within {moved:.3g} "
            f"of them; the float32 loss on the mesh within {max(gaps):.4g} "
            f"of one device's {one:.8g}, whose own float32 rounding reads "
            f"{noise:.4g} against float64; bar {CM_TOL} relative + "
            f"{CM_NOISE_RULE} x that rounding = {bar:.4g}; in float64 the "
            f"metrics {m64} (one device {f64['metrics']}) and the reduced "
            f"gradients within {g64:.3g} of each leaf's largest (bar "
            f"{CM_TOL}; {sum(int(g.count_nonzero()) for g in f64['grads']):,}"
            f" elements not 0)")
        need(still and moved == 0, f"cells mace {name}: the no-op step leaves "
                                   f"the params as they were")
        need(max(gaps) <= bar, f"cells mace {name}: the float32 loss within "
                               f"its bar of one device")
        need(all(cm_close(m[k], v) for m in m64
                 for k, v in f64["metrics"].items()),
             f"cells mace {name}: float64 metrics within {CM_TOL} of one "
             f"device")
        need(g64 <= CM_TOL, f"cells mace {name}: float64 reduced gradients "
                            f"within {CM_TOL} of one device's")
    # ------------------------------------------- the dry run's counts
    for arch in CM_ARCHS:
        for name in CM_SERVE:
            dry_check(f"cells {arch} {name}",
                      [r[arch]["serve"][name]["stats"] for r in ranks],
                      max(r[arch]["serve"][name]["counted_ms"]
                          for r in ranks), card)
        dry_check(f"cells {arch} retrieval",
                  [r[arch]["retrieval_stats"] for r in ranks],
                  max(r[arch]["retrieval_ms"] for r in ranks), card)
    for name in ("molecule", "full_graph_sm"):
        dry_check(f"cells mace {name}",
                  [r["mace"][name]["stats"] for r in ranks],
                  max(r["mace"][name]["counted_ms"] for r in ranks), card)
    # minibatch_lg: the sample's own sizes (its static shape reported)
    from repro_torch.configs.base import ShapeSpec
    mini_r = ranks[0]["mace"]["minibatch_lg"]
    n_all, e_all = 4 * mini_r["n_local"], 4 * mini_r["e_local"]
    sample = ShapeSpec("minibatch_lg", "graph_full", n_nodes=n_all,
                       n_edges=e_all, d_feat=128)
    dry_check("cells mace minibatch_lg", [r["mace"]["minibatch_lg"]["stats"]
                                          for r in ranks],
              max(r["mace"]["minibatch_lg"]["counted_ms"] for r in ranks),
              card, dry_count("mace", sample, cm_mace_config(), (), {}))
    static = dry_rows()["cells mace minibatch_lg"]
    log(f"dry run cells mace minibatch_lg at its static shape "
        f"({gnn_shape('minibatch_lg').name}: the sample's sizes padded "
        f"{n_all:,} nodes and {e_all:,} edges here): collectives by rank "
        f"{[r['counted'] for r in static]}; terms (rank 0) "
        f"{static[0]['terms']}")
    # ------------------------------------------------ (d) planted
    want = refs["deepfm"]["serve"]["serve_p99"]
    bl = want.shape[0] // CM_MESH[0]
    p_gap = min(float((r["deepfm"]["planted"][0]
                       - want[r["coords"][0] * bl:(r["coords"][0] + 1) * bl])
                      .abs().max()) for r in ranks)
    p_rows = any(r["deepfm"]["planted"][1] == refs["deepfm"]["crc"][
        "serve_p99"][r["coords"][0]] for r in ranks)
    plant = g_ref["plant_loss"]
    m = [r["mace"] for r in ranks]
    n_plant = CM_PLANT_GRAPHS * gnn_shape("molecule").n_nodes
    log(f"cells planted: deepfm served from the next rank's code blocks: "
        f"logits off by at least {p_gap:.4g}, rows bit-identical on some "
        f"rank: {p_rows}; MACE on {CM_PLANT_GRAPHS} molecules (N padded "
        f"from {n_plant:,} to {-(-n_plant // 4) * 4:,}): loss one device "
        f"{plant:.7g}, the mesh "
        f"{[round(x['plant_sound'], 7) for x in m]}, the next rank's "
        f"receiver block {[round(x['plant_block'], 7) for x in m]}, a "
        f"padded node in graph 0's energy "
        f"{[round(x['plant_pad'], 7) for x in m]}")
    need(p_gap > 100 * CM_TOL and not p_rows, "cells planted: another "
         "rank's code block fails the serving bars")
    need(all(cm_close(x["plant_sound"], plant) for x in m),
         "cells mace: the padded molecule batch within the bar")
    need(all(not cm_close(x["plant_block"], plant) for x in m),
         "cells planted: the wrong receiver block fails the loss bar")
    need(all(not cm_close(x["plant_pad"], plant) for x in m),
         "cells planted: a padded node in the energy fails the loss bar")
    log(f"cells mesh phase {time.perf_counter() - t_phase:.1f}s (the ranks "
        f"{t_ranks:.1f}s; {card}); launches {launches}")
    return launches



# ----------------------------------------------------------------------
# the dry run of the mesh phases' cells: launch/dryrun.py's count of a
# step on the meta device, at (2, 2), held to what the phases' gloo
# ranks count
# ----------------------------------------------------------------------

DRY_FLAG = "--dry-run"
DRY_MESH = (2, 2)                      # every mesh phase's (data, model)
# the IVF corpus's query counts the child also draws (the distributed
# phase's flush and the retrieval-scale phase's queries): 12.7 s of host
# numpy each, off the card's path
IVF_CORPUS_QUERIES = (max(SHARD_BATCHES), TT_QUERIES)
_DRY = {}                              # the child process, then its rows


def dry_cells() -> dict:
    """The cells the mesh phases count collectives of, at their shapes
    and cuts: name -> (arch, ShapeSpec, config, opts, build_cell's
    keywords).  minibatch_lg's static shape (169,984 nodes) is reported;
    its measured step is a sample's, held in ``cells_mesh_phase`` to a
    dry run at the sample's own sizes."""
    from repro_torch.configs.base import ShapeSpec
    seq = lm_train_seq()
    lmm, lms = lmm_configs({}), lms_configs()
    train = ShapeSpec("train_4k", "train", seq_len=seq,
                      global_batch=LMM_BATCH)
    out = {"lm mesh stablelm": (LMM_ARCH, train, lmm["stablelm"], (), {}),
           "lm mesh qwen3": (QW_ARCH, train, lmm["qwen3"], (), {}),
           "lm serve (a) decode": (LMS_ARCH, ShapeSpec(
               "serve", "decode", seq_len=LMS_MAX_SEQ,
               global_batch=LMS_BATCH), lms["a"], (), {}),
           "long_500k": (LMS_ARCH, long_shape(), long_config(),
                         ("split_cache",), {})}
    cfgs = cm_configs()
    for arch in CM_ARCHS:
        for name in CM_SERVE:
            out[f"cells {arch} {name}"] = (arch, cm_recsys_shape(name),
                                           cfgs[arch], (), {})
        out[f"cells {arch} retrieval"] = (
            arch, cm_recsys_shape("retrieval_cand"), cfgs[arch], (),
            {"n_candidates": CM_CAND[arch]})
    for name in ("molecule", "full_graph_sm", "minibatch_lg"):
        out[f"cells mace {name}"] = ("mace", gnn_shape(name),
                                     cm_mace_config(), (), {})
    return out


def dry_count(arch, shape, cfg, opts, kw) -> list:
    """Each rank's count of one step of ``build_cell``'s cell on an
    ``AbstractMesh`` of DRY_MESH (the meta device): its collectives
    (count, bytes a rank, kinds, bytes by kind) and the three roofline
    terms on H100 constants."""
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.dryrun import trace_step
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.roofline import terms
    out = []
    for rank in range(DRY_MESH[0] * DRY_MESH[1]):
        mesh = AbstractMesh(DRY_MESH, ("data", "model"), rank)
        cell = build_cell(arch, shape, mesh, opts=opts, cfg=cfg, **kw)
        t = trace_step(cell, mesh)
        k, c = t["counter"], t["comm"]
        out.append({"counted": list(c.counted()), "terms": terms(
            k.flops, k.bytes, c.axis_bytes, mesh.shape,
            cell.model_flops).row()})
        del cell, t
    return out


def start_dry_run():
    """Start the dry run of :func:`dry_cells` (the meta device, no card)
    in a child process beside the early phases; :func:`dry_rows` waits
    on it."""
    import tempfile
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dry_")
    _DRY["proc"] = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), DRY_FLAG, out_dir],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    _DRY["dir"] = out_dir
    return _DRY["proc"]


def dry_run_child(out_dir: str) -> int:
    """The child's side of :func:`start_dry_run`: every cell's counts as
    JSON in ``out_dir``, and the seconds it took."""
    import torch
    torch.set_num_threads(2)
    import numpy as np
    t0 = time.perf_counter()
    rows = {name: dry_count(*spec) for name, spec in dry_cells().items()}
    with open(os.path.join(out_dir, "dry.json"), "w") as f:
        json.dump(rows, f)
    t1 = time.perf_counter()
    for nq in IVF_CORPUS_QUERIES:
        vecs, q = ivf_scale_corpus(nq)
        np.save(os.path.join(out_dir, f"ivf_{nq}_vecs.npy"), vecs)
        np.save(os.path.join(out_dir, f"ivf_{nq}_queries.npy"), q)
    print("DRYRUN " + json.dumps({"seconds": t1 - t0, "cells": len(rows),
                                  "corpus_s": time.perf_counter() - t1}),
          flush=True)
    return 0


def dry_rows() -> dict:
    """The child's rows (waited for once)."""
    import shutil
    if "rows" not in _DRY:
        t0 = time.perf_counter()
        proc = _DRY["proc"]
        try:
            out, err = proc.communicate(timeout=900)
            lines = [x for x in out.splitlines() if x.startswith("DRYRUN ")]
            if proc.returncode != 0 or len(lines) != 1:
                log(out[-4000:])
                log(err[-4000:])
                need(False, "the dry run's child process ran to its end")
            with open(os.path.join(_DRY["dir"], "dry.json")) as f:
                _DRY["rows"] = json.load(f)
            import numpy as np
            _DRY["corpus"] = {nq: tuple(np.load(os.path.join(
                _DRY["dir"], f"ivf_{nq}_{leaf}.npy")) for leaf in
                ("vecs", "queries")) for nq in IVF_CORPUS_QUERIES}
        finally:
            shutil.rmtree(_DRY["dir"], ignore_errors=True)
        info = json.loads(lines[0].split(" ", 1)[1])
        log(f"dry run: {info['cells']} cells x {DRY_MESH[0] * DRY_MESH[1]} "
            f"ranks on the meta device in {info['seconds']:.1f}s, then the "
            f"IVF corpus for {IVF_CORPUS_QUERIES} queries in "
            f"{info['corpus_s']:.1f}s, in a child process beside the "
            f"earlier phases; waited {time.perf_counter() - t0:.1f}s here")
    return _DRY["rows"]


def measured(stats: dict) -> list:
    """A rank's ``CommStats`` (as a dict) in a dry row's form."""
    return [stats["count"], stats["bytes"], dict(stats["kinds"]),
            dict(stats["kind_bytes"])]


def dry_check(name: str, stats: list, ms: float, card: str,
              rows: list = None) -> None:
    """Each rank's measured collectives (``stats``, in rank order) held
    exactly to the dry run's count of the same cell (``rows``, default
    the child's); the measured ``ms`` printed beside the three terms
    (the gloo time is not held to the NVLink term)."""
    rows = rows or dry_rows()[name]
    got = [measured(s) for s in stats]
    want = [r["counted"] for r in rows]
    t = rows[0]["terms"]
    log(f"dry run {name} on {DRY_MESH}: collectives by rank {got} against "
        f"{want}; measured {ms:.3f} ms beside the terms (rank 0, H100 "
        f"constants) compute {t['compute_ms']:.3f} | memory "
        f"{t['memory_ms']:.3f} | collective {t['collective_ms']:.3f} ms -> "
        f"{t['dominant']}-bound [{card}]")
    need(got == want, f"dry run {name}: every rank's collectives, their "
         f"kinds and bytes equal to the dry run's count")


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
    if sys.argv[1:2] == [HOST_GRAPH_FLAG]:
        return gnn_host_graph_child(sys.argv[2])
    if sys.argv[1:2] == [DRY_FLAG]:
        return dry_run_child(sys.argv[2])
    if sys.argv[1:2] == [MESH_CLIS_FLAG]:
        return mesh_clis(sys.argv[2])
    started = start_gnn_host_graph()
    dry = start_dry_run()
    try:
        return main_phases(started)
    finally:
        for proc in (started[0], dry):
            if proc.poll() is None:         # a phase failed before its use
                proc.kill()
                proc.wait()


def main_phases(started) -> int:
    """Every phase in turn (see the module docstring); ``started`` is
    the host graph's child process (:func:`start_gnn_host_graph`)."""
    import torch
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
    s_launches = sharded_serving_phase(card)
    m_launches = sharded_training_phase(card)
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
    l_launches, flash_shapes = [], {}
    for arch, batch, prompt, layers in LM_PATHS:
        path_launches, gap, shapes = lm_path(arch, batch, prompt, layers)
        l_launches.append(path_launches)
        lm_assign_gap = max(lm_assign_gap, gap)
        flash_shapes.update(shapes)
    gc.collect()
    torch.cuda.empty_cache()
    t_train = time.perf_counter()
    train_launches, train_shapes, train_gap = lm_train_phases()
    log(f"lm training phases {time.perf_counter() - t_train:.1f}s")
    l_launches += train_launches
    flash_shapes.update(train_shapes)
    gc.collect()
    torch.cuda.empty_cache()
    mesh_launches, mesh_shapes = lm_mesh_phase(card)
    l_launches.append(mesh_launches)
    for key, n in mesh_shapes.items():
        flash_shapes[key] = flash_shapes.get(key, 0) + n
    gc.collect()
    torch.cuda.empty_cache()
    serve_launches, serve_shapes = lm_serve_mesh_phase(card)
    l_launches.append(serve_launches)
    for key, n in serve_shapes.items():
        flash_shapes[key] = flash_shapes.get(key, 0) + n
    lm_assign_gap = max(lm_assign_gap, train_gap)
    kernels.append(time_flash(
        flash_err, sum(p["flash_attention"] for p in l_launches),
        flash_shapes))
    gc.collect()
    torch.cuda.empty_cache()
    g_launches, mini = gnn_phases(card, started)
    gc.collect()
    torch.cuda.empty_cache()
    c_launches_mesh = cells_mesh_phase(card, mini)
    del mini
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
                                 s_launches, m_launches, bag_launches,
                                 *ctr_launches,
                                 b_launches, *l_launches, g_launches,
                                 c_launches_mesh, r_launches, *i_launches))
        if name == "dpq_assign":
            entry["max_abs_err"] = max(entry["max_abs_err"], pq_errs[name],
                                       c_errs[name], lm_assign_gap,
                                       bb_gap)
    log(f"total {time.perf_counter() - t0:.1f}s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
