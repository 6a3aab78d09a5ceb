#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # the whole check, one card

Phases, in order; any failure raises and the script exits non-zero:

1. device  the card's name and power limit (``nvidia-smi``); no CUDA, exit.
2. build   every CUDA kernel of the main path from ``src/repro_torch/csrc``
           (one ``nvcc`` per source, all at once), with the seconds taken;
           the registers and spill bytes ptxas reports for prune_kernel,
           topk_kernel, topk_pruned_kernel, ucb_kernel, ucb_block_kernel,
           choose_tile_kernel (each width; ucb's and choose's also for a
           bf16 Minv), cross_tc_kernel,
           cross_split_kernel and cc_hop_kernel (each load width; any
           spill fails); the count of HGMMA
           (wgmma) instructions in the flash and cross libraries' SASS
           (``cuobjdump -sass``), neither of which may be 0.
3. small   each kernel against its plain PyTorch version on ragged small
           shapes (choose's two variants and ucb's two, each forced past
           its wrapper, at 37 users (K = 7, d = 19; K = 64, d = 25 and
           32), 256 users (K = 64, d = 25 and 32: serving's shortlist) and
           on duplicate candidates: both choose variants pick the same
           candidates and copy the same x, bit for bit, no duplicate beats
           its first copy, and either ucb variant's first-index argmax is
           that pick; at the paper clones' shapes (phase 4d: n = 943,
           1816, 1888, 5045; K = 20; d = 5, 19, 25) the same on slates
           gathered from a 2047-item table with a duplicate in each, half
           the rows' best item the duplicated one, rank1_update_inv, and
           prune on the full graph and a sparse one, both branches
           forced; cross on both routes at B = 16 ... 5000 (d = 429
           among them), each within 2e-5, and its W split bit-equal to the
           plain version; flash: f32 within 1e-4; bf16 kernel and plain version
           each within 2e-2 of the f32 plain version on upcast inputs;
           the bf16 cases reach the split-KV decode variant and the wgmma
           prefill variant at their edges; embedding_bag at L = 1, 31,
           32, 33, 100 over D = 8, 16, 25, 129 and on a table 4 bytes off
           a 16-byte boundary; both rank-1 kernels' block-per-user and
           warp-per-user variants bit-equal on the same rows: a row view
           against the whole state with one user live, and two users an
           SM (264 on 132 SMs) against one more, the variants' limit;
           ucb's two variants likewise bit-equal: two users an SM as a
           view of one more, and a row view at an odd user (off a 16-byte
           boundary) against the whole state; cc_hop (``check_cc_hop``:
           the wrapper, the kernel with its dense threshold forced both
           ways and the warp-per-row kernel, each equal to the plain
           version) at the paper datasets' row lengths (n = 943, 1816,
           1888, 5045, 20000; W = 30, 57, 59, 158, 625) and at 20480, on
           sparse, half-dense (a third of the rows empty) and full graphs, on
           row views off a 16-byte boundary, a flat buffer's view 4
           bytes off one, and random words (bits past C set) against a
           labels_j shorter than 32 W and off a 16-byte boundary; prune
           on ragged rows, words
           and feature slabs, dense and sparse words, equal vectors and
           pairs on the threshold; its dense and sparse branches forced
           and bit-equal on words whose every warp tile the walk takes
           (256 bits a tile, the cap, among them); the branch-free square root of prune and topk
           against sqrtf on every non-negative float; topk at d = 1, 8,
           24, 31, 32, 33, 48, 64; topk_pruned bit-equal to topk: for 37
           users at tile 128, where each split walks 8 tiles and must skip
           some, for 256 users at tiles 128, 384, 512, 1024 and 2048, and
           at d = 32 and 64 with k = 128, the shared-memory corner); the
           reduced-precision variants (``small_quant_checks``): the bf16
           rank-1 update at the clones' shapes and both its variants,
           topk over bf16 and int8 banks at d = 1 ... 64, from a row
           whose bytes start off a 16-byte boundary and at N < k, and
           topk_pruned over quantized region catalogs at tiles 128, 384,
           512 and 2048); the bf16-Minv variants (``small_minv_checks``),
           each bit-equal to its f32 kernel on the widened Minv and within
           its band of the plain version: choose and ucb at d = 1 ... 64,
           K = 256 and 257, n = 2 x SMs and one more, serving's 256 x 64,
           on Minv one row and one element off a 16-byte boundary (both
           choose variants and both ucb variants forced where the tile
           takes the shape); the M-ful update at the clones' shapes, n = 2
           x SMs and one more, d = 33 and 64, one element off, CLUB's n = 1
           row views and its variants bit-equal; topk over f32, bf16 and
           int8 items at d = 1 ... 64, one row in, N < k; topk_pruned over
           each kind's region catalog at tiles 128, 2048 and at d = 64, k =
           128; an f16 Minv refused by all six wrappers with a TypeError,
           nothing launched).
4. main    ``repro_torch.core.distclub.run`` at the paper's full width
           (20480 users, d=25, K=20, 100 planted clusters,
           ``distclub_paper.CONFIG``) for 2 epochs, with the kernel launch
           counters set to 0 just before and read just after; then one
           more epoch, timed warm, and once more under torch.profiler for
           the device time by kernel.  Phases 4, 4b (CLUB) and 4s log the
           adjacency at each ``connected_components`` call of their
           counted runs (rows, words, set bits, density, full words, hops;
           ``cc_graphs``).
   plain   the same run with every kernel wrapper swapped for its plain
           version, on the same CUDA tensors: no kernel may launch, and
           its clusters per epoch and reward/random must agree with the
           kernel path's within the bands of ``compare_paths``.
4b. base   the paper's baselines at the same width on the same
           environment: ``core.club.run`` for 2048 interactions
           (``bench_paper.py``'s CLUB slice; network update every 64),
           counters set to 0 before (2048 ucb and 4096 rank1_update
           launches, one prune per update); ``core.dccb.run`` with
           L = ``CONFIG.buffer_size`` = 32 for as many epochs as phase 4
           had interactions (``choose`` launches = epochs x L).  Prints, for
           DistCLUB (phase 4), DCCB and CLUB: us per interaction,
           reward/random, comm bytes per interaction, clusters, peak
           memory.  Both rerun through the plain versions on the card (no
           kernel may launch; ``compare_paths``'s bands); then a CLUB
           window of 64 interactions and a network update, and a DCCB
           epoch, under torch.profiler.
4d. clones the paper's dataset clones (``data.datasets.PAPER_DATASETS``
           less synthetic-small: movielens, lastfm, delicious, yahoo and
           the 20000-user synthetic set) at their own n, d and K, each
           under the four ``make_env`` kinds (synthetic, replay, drift,
           catalog): ``distclub.run`` with ``distclub_paper.CONFIG`` for
           ``epochs_for(spec, CONFIG)`` epochs, counters set to 0 before
           and read after, under a spy that fails on any torch call that
           returns a tensor on the host; reward/random must exceed 1;
           then one more epoch timed warm and once more profiled (ms and
           device ms per epoch, busy share); the web clones rerun through
           the plain versions on the card (no kernel may launch;
           ``compare_paths``' bands).  Then CLUB (2048 interactions) and
           DCCB (L = 16, ``bench_paper.py``'s movielens budget) on the
           movielens clone under replay, drift and catalog, counted, and
           ``examples/quickstart_torch.py``'s ``main("cuda")``.
4s. serve  ``repro_torch.serve`` at full width: a distclub session warm-
           started from that run's state (``OnlineBandit.from_offline``)
           serves 16 batches of 256 distinct users against a 2^18-item
           catalog (``make_catalog_env`` with the same seed: 100 regions,
           item noise 0.05), k_short=64, stage 2 every 2048 interactions;
           once unpruned, once from the same start cluster-pruned
           (``build_clusters``, 512-item tiles, 512 anchors).  Both runs
           must serve identical items in every batch; counters set to 0
           before the two runs and read after; one more batch of each
           under torch.profiler.
   plain   the unpruned run through the plain versions on the card: no
           kernel may launch, reward/random within 1% of the kernel run's
           and at least 95% of the served items identical.
   dccb    a dccb session (``get_policy("dccb")``) on phase 4b's DCCB
           state serves the same 16 batches unpruned, gossip every 2048
           interactions, counted on its own (one topk and one choose
           launch a batch, nothing else), ms per batch; topk and choose
           against their plain versions on the first and the next batch's
           inputs (``check_topk``/``check_choose`` near-tie bands); one
           more batch under torch.profiler; then through the plain
           versions: no kernel may launch, clusters within 1% of n.  The
           served items are not compared: DCCB's users score with w = 0,
           Minv = I (a gossip cut resets both its users, and at the
           paper's gamma nearly every user is cut), so the items tie and
           the two paths round the tied scores 1 ulp apart.
4x. shard  the sharded runtime (``launch.mesh.spawn``; each group has a
           time limit, and a rank that raises or a join past it fails the
           script).  One NCCL rank (``cuda:0``): ``distclub_shard`` at
           phase 4's configuration, environment and seed for ``EPOCHS``
           epochs, counted, then one warm epoch timed; its first stage 1
           (through the runtime's stage body), its state, metrics and
           cluster counts bit-equal to phase 4's, its launches equal to
           phase 4's.  Four gloo ranks sharing the card (NCCL takes one
           rank a card; gloo stages each collective through host memory,
           a choice the binding makes by backend): the same run, each
           rank 5120 users; the first stage 1 and the first stage 2's
           adjacency and labels bit-equal to phase 4's (no psum feeds a
           decision before then); after it, clusters per epoch and
           reward/random within ``compare_paths``' bands; the users whose
           occ or label differ, ms per epoch, peak memory and bytes sent
           by rank, beside the modelled ``comm_bytes``.  Then on the
           same four: ``dccb_shard`` (L = ``CONFIG.buffer_size``, 2
           epochs; comm bytes exactly epochs n (L + 1)(d^2 + d) 4,
           reward/random > 0.98, the ring's bytes), and phase 4s's 16
           batches through ``OnlineBandit.from_offline(..., col=)`` on
           phase 4's state, each rank 2^16 items of the catalog
           (``catalog.item_shard``), unpruned and then pruned
           (``build_clusters(512, 512)``): items equal to phase 4s's
           through the first refresh, and after it any difference a near
           tie under ``check_topk``'s band, against phase 4s's session
           rerun batch by batch; ms per batch; then phase 4s's first
           batch through a cold ``OnlineBandit.sharded`` session, its
           items and reward equal to a one-process
           ``OnlineBandit.create``'s, its state within 1e-6; then 8 slate
           batches through a sharded session with a pending ring
           (``from_offline(..., col=, pending_capacity=)``), recommended
           and observed with delay 0: bit-equal to the same ranks'
           synchronous ``step``, the ring the same on every rank, the
           choices a one-process session's.  Then cold
           ``OnlineBandit.sharded`` sessions of the club and linucb
           policies through phase 4s's first 4 batches (club's stage 2
           over the ranks after the last one): items and reward equal
           to ``OnlineBandit.create``'s of the same policy in this
           process, batch by batch.  Then the learned sharded session
           saved after 8 batches (rank 0 writes the global arrays),
           restored onto the four ranks and onto this process: the next
           4 batches equal the unbroken run's on both; save and restore
           ms.  Then a ``Guarded`` sharded session tracking its catalog
           slice: the recall probe 1.0 on healthy batches, a 12.5%
           retirement past its churn ceiling rolls state and catalog
           back, and the restored pair serves the snapshot pair's items.
           Then phase 4o's churn run (its fault mix, 12 of its 48
           rounds) on the item-sharded ``OPS_ITEMS`` slots, conservation
           after every delivery: pending counters, publishes, items
           added and retired, reward equal to phase 4o's one-process run
           of the same rounds; tx/s beside it.  Every run is counted on
           its own, and its launches checked.  After every
           timed run, rank 0 holds the kernels at its shard shapes to
           their plain versions (uncounted): prune and cc_hop on the
           first stage 2's 5120 local rows against 20480 columns, topk
           on a served batch over its 2^16-item slice and on the churn
           run's last request over its churned 73728-slot slice,
           topk_pruned on its ``shard_slice`` of the sorted stream.  The
           four ranks share one card: their times are no scaling figure.
4p. prec   reduced-precision serving: phase 4s's 16 batches in a bf16
           and an int8 session (``from_offline(..., precision=)``: bf16
           ``Minv``) against phase 4s's catalog quantized to each
           (``make_catalog(..., precision=)``), unpruned and pruned
           (``build_clusters(512, 512)``), counted (16 topk_<p>_tc, 16
           topk_pruned_<p>_tc, 32 rank1_update_inv_bf16 and 32 choose
           launches, no chain top-K and no f32 topk, topk_pruned or
           rank1_update_inv), the filter launches' own violation counts
           0 (``topk.ops.FilterStats``), the
           pruned items equal to the unpruned ones in every batch; the
           same session batch by batch through the plain versions (items
           equal, or both within ``check_topk``'s band); the bf16
           session saved half way (``train.checkpoint``), restored into a
           fresh session, its second half's items equal, restores under
           f32 and int8 refused; the counterfactual choice-flip rate of
           ``benchmarks/bench_precision.py`` on that bench's own
           configuration (256 cold users, 4096 structureless items, d 32,
           batches of 64, 32 + 40 rounds), at most 0.01 each, and, not
           gated, for phase 4s's learned users and traffic against a
           random 2^18-item catalog and against the region catalog.
   bf16 Minv  the engines on a bf16 Minv (``minv_phase``): phase 4's
           learned state with Minv cast to bf16 (M, b f32) through 32
           rounds of the bf16 preset's ``InteractBackend.choose`` and
           ``update_lin`` and of ``ucb_scores`` at n = 20480, d = 25, K =
           20 on phase 4's environment, the kernel's state carried
           forward, counted (32 choose_bf16, ucb_bf16 and
           rank1_update_bf16 launches, no f32 choose, ucb or
           rank1_update); each round held, uncounted, to the f32 kernels
           on the widened Minv (picks, x and scores bit for bit; Minv the
           round-to-nearest-even of the f32 update's, M and b bit-equal)
           and to the plain versions on the same inputs (``hold_choose``,
           ``hold_rank1_bf16``); then one serving batch of the bf16
           preset's ``RetrievalBackend.shortlist`` and
           ``shortlist_pruned`` for phase 4s's first 256 users with the
           bf16 session's Minv in bf16, over phase 4s's f32 bank and phase
           4p's bf16 and int8 banks, counted (one launch of each of the
           six topk*_minv_bf16* kernels, nothing else), each shortlist
           the f32-Minv kernel's on the widened Minv bit for bit and
           within ``check_topk``'s band of the plain version.
4o. ops    the operations layer (``serve.guardrails``, ``serve.faults``,
           ``serve.experiments``) at serving's width: phase 4s's learned
           users, batches of 256, k_short 64, rings of 4096 with TTL 16.
           (1) ``run_faulted_catalog`` for 48 rounds against the 2^18-item
           region catalog in 2^18 + 2^15 slots under delivery faults
           (delay 0.3 up to 4 rounds, loss 0.05, dup 0.05) and churn
           (2048 adds and 2048 retirements every 4 rounds, publishes a
           round late, torn at 0.25, a 4096-item flash crowd at round 20,
           the hot region retired at round 32), the conservation identity
           asserted after every delivery, beside its clean control on the
           same traffic, after a 4-round warm-up and in both orders (clean,
           faulted, faulted, clean: tx/s and seconds of each run; matched
           ratio, reward against clean, stale, publishes, items added and
           retired).  (2) ``Guarded``: phase
           4s's first 4 batches cluster-pruned with the recall probe
           (items phase 4s's, recall 1.0); a ``run_faulted`` slate run (K
           20) with every reward sign-flipped from round 16 and the CTR
           floor at half the clean rate, which must roll back, then roll
           back once more and serve 4 transactions bit-identically to a
           session restored from the same snapshot; the ms of a snapshot,
           a rollback and a guarded transaction beside a bare one.  (3) a
           three-arm experiment (distclub, dccb on phase 4b's state, a
           fresh linucb; selector epochs of 10, floor 0.05, per-arm
           guardrails) for 60 rounds under the delivery faults with the
           linucb arm's rewards sign-flipped from round 20: only linucb
           is disabled and every request is still served; the report;
           a routed transaction's ms beside its arms' plain ones; one arm
           at fraction 1.0 bit-equal to the plain session for 8 batches.
           Counted (``ops_launches``; choose, rank1_update_inv, prune,
           cc_hop, topk and topk_pruned must each launch).  (4) topk
           against its plain version (``check_topk``) on the churned bank
           that served (1)'s last request, with that request's users; the
           first 24 rounds of (1), every publish torn, and of (3) with the
           plain versions in lockstep (each request served by the plain
           versions on the same session and catalog first: equal decision
           ids, differing picks only at near ties, and before each catalog
           request ``check_topk`` on the serving bank of that moment), then
           through the plain versions alone (identical items and choices
           in at least 95% of the requests, ``compare_paths``' bands).  (5) ``launch.faultrun --scenario
           churn --guard``, ``launch.abrun --selector --guard --faults``
           and ``examples/ab_experiment_torch.py`` at their defaults on
           the card, run together, each exiting 0.
4r. recsys the recsys models at their published configs
           (``repro_torch.configs``): DCN-v2 (26 x 2^20 x 16 f32 tables,
           d_interact 429, 3 cross layers) scores 16 serve_p99 batches of
           512 rows and 2 serve_bulk batches of 262144 on the JAX
           package's synthetic traffic (after one uncounted batch of
           each size), counters set to 0 before and read after (3 cross
           launches a batch); the same batches through the
           plain versions on the card, logits within 2e-5 of each logit's
           term scale; ``embedding.bag_lookup`` over a field's table with
           512 and 262144 bags of 50 ids, its own counted run; SASRec,
           BERT4Rec and MIND score 4 serve_p99 batches (512 users x 1000
           candidates) and one retrieval_cand call (2^20 candidates) each,
           no kernel; ``launch.serve.serve_recsys`` at its defaults
           (reward/random > 1, within 1% of the same run on the CPU).
4l. lm     Qwen3-4B (``configs.get("qwen3-4b")``) at full width and
           depth, bf16, random weights drawn on the card from the seed: 8
           prompts of 2048 tokens (a seeded host generator) through
           ``lm_prefill``, the cache copied into ``init_cache(cfg, 8,
           4096)``, 64 greedy ``lm_decode_step``s, counters set to 0
           before and read after (exactly 36 + 36 x 64 = 2340 flash
           launches, no other kernel); prefill ms and tokens/s, decode ms
           per step and tokens/s, peak memory; one prefill and one decode
           step under torch.profiler.
   plain   the same prefill and steps through the plain versions on the
           card, teacher-forced on the kernel path's tokens: no kernel may
           launch; last-position logits within a relative L2 error of
           5e-2, greedy tokens equal in >= 95% of (sequence, step) pairs.
   cli     ``launch.serve.serve_lm`` at its defaults on the card, its
           tokens equal to the same call on the CPU at >= 99% of positions.
4t. train  training (``launch.train``), after phase 4l's model and cache
           are freed: (a) Qwen3-4B at full width and depth, bf16
           parameters, f32 AdamW moments, remat on, random weights from
           the seed, 3 steps of ``train.lm_step`` at the CLI's defaults
           (B 8, S 128, lr 3e-4) on its Zipf token stream, no checkpoint,
           counted: every loss finite, every gradient leaf of the first
           step finite and not all zeros in each of its blocks, exactly
           2 x 36 flash launches a step (the forward's and the backward's
           recompute), nothing else; seconds per step, peak memory.  (b)
           gradients through the flash and cross kernels' autograd
           Functions against autograd through their plain versions on one
           random cotangent: flash bf16 at the training shape (q [8, 32,
           128, 128], k and v [8, 8, 128, 128], causal) and f32 at Dh 32
           with 4 q heads a kv head, within the forward's tolerances (1e-4
           f32, 2e-2 bf16); cross at 65536 rows (tensor route) and 512
           (SIMT), d 429, each element within 2e-5 of its term scale.  (c)
           DCN-v2 at its published config (26 x 2^20 x 16 tables), 3
           Adagrad steps of 65536 rows, counted (3 cross and 3 cross_split
           launches a step), losses and the first step's gradients
           finite.  (d) ``--arch distclub-paper --steps 2`` in this
           process, counted (choose, rank1_update_inv, prune, cc_hop);
           then as subprocesses, together: ``examples/train_lm_torch.py``
           (step 0's loss above the final one; the second run resumes
           from step 30), ``--arch distclub-paper --steps 2`` and
           ``--arch sasrec|bert4rec|mind|dcn-v2 --reduce --steps 5``.
4m. moe   the MoE LMs, after phase 4t's models are freed.  (a)
           deepseek-moe-16b at full width and depth, bf16, random weights
           drawn on the card: phase 4l's prefill of 8 x 2048 tokens, its
           cache copied into 8 x 4096 slots and 32 greedy decode steps,
           counted (exactly 28 + 28 x 32 = 924 flash launches, nothing
           else); ms and tokens/s, peak memory, profiles; then the plain
           versions, teacher-forced on the kernel path's tokens, twice:
           with their own routers (logits, tokens and the share of
           (token, choice) routings that agree, layer by layer, printed
           beside phase 4l's bands) and with the kernel run's routings
           forced as the tokens are (logits within 5e-2 relative L2; the
           greedy-token share printed beside phase 4l's 0.95, which
           random weights' flat logits miss); and against the same passes
           with attention in f32, the kernel path no farther than the
           plain path in logits (relative L2) and in greedy tokens equal,
           the kernel with the plain version's error added to its own
           refused by that comparison.  (b) llama4-maverick at full
           width, 1 of its 24 blocks (a dense and a MoE layer of 128
           experts; 66 launches), the same.  (c) deepseek-moe-16b
           trained at full width, cut to the most layers whose step fits
           (12 bytes a parameter beside 16 GB), 3 steps at the CLI's
           defaults: losses and every gradient leaf (routers, experts,
           shared experts) finite and nonzero block by block, 2 flash
           launches a layer a step.  (d) ``serve_lm`` for both at the CLI's
           defaults against the CPU (>= 99% tokens equal), and
           ``launch.train --arch deepseek-moe-16b --reduce --steps 5``.
4k. shard  the sharded LM decode (``distributed.decode_shard``; its
           attention is ``torch.matmul`` and a flash-decoding merge, no
           kernel: no sharded step may launch a counted one).  (a)
           Qwen3-4B at full width and depth, bf16, random weights, on a
           one-rank mesh (every axis of size 1; ``repro``'s rule puts it
           in the f-sharded layout): a prefill of 8 x 2048 (flash), its
           K/V in a 32768-slot cache (decode_32k's S_max; its batch of
           128 cut to 8, 38.65 GB), 32 steps of ``lm_decode_step``
           (counted: 36 + 36 x 32 flash launches) and of the sharded step
           at each position on the same cache, teacher-forced on
           ``lm_decode_step``'s greedy tokens (phase 4l's bands); ms a
           step, profiles, peak memory, bytes sent, cache bytes read;
           then the bf16 cache freed, the prompt's K/V quantized into an
           int8 cache and the int8 step on the same tokens within 0.08
           (max |d| / max |ref|) of the bf16 sharded step.  (b) four gloo
           ranks sharing the card, mesh (data 2 x model 2), each drawing
           Qwen3-4B at full width cut to 4 layers from the seed and
           keeping its pieces: the standard (batch 8), int8 and tiny-batch
           (batch 1: sequence over all four) layouts, 8 steps from a
           2044-token prompt against 4096 slots (the writes cross the
           2048-slot shard boundary of both layouts), each within 5e-2
           relative L2 of the one-process sharded step and >= 95% tokens
           equal.  (c) the same ranks, deepseek-moe-16b at full width cut
           to 2 layers (dropless MoE, 32 experts a rank), the same band,
           routings equal to one process's but for printed near ties
           (router logits of the k-th and (k+1)-th experts within 0.02).
4g. gnn    the GAT (``launch.steps.gnn_train_step``) at each gat-cora
           cell on one NCCL rank, 3 steps on random graphs at
           ``CELL_DIMS`` (minibatch_lg sampled by ``NeighborSampler`` from
           a 232,965-node, 114.6 M-edge graph on the host; ogb_products'
           edges cut to the largest 1/2^j that fits): losses finite,
           seconds a step, peak memory, no kernel launch; full_graph_sm's
           losses within 1e-5 of the same steps on the CPU; then
           ``gat_loss_local`` on full_graph_sm over 4 gloo ranks sharing
           the card against one process, exact and int8 gathers (1e-5),
           the int8 loss within 5% of the exact one.
4c. cells  the global-program cells (``launch.steps.build_cell``,
           DTensor arguments) on one NCCL rank, a one-rank ``DeviceMesh``
           in this process, each counted: (a) Qwen3-4B ``train_4k`` cut
           to ``CELL_LM_LAYERS`` layers and one row of ``CELL_LM_SEQ`` in
           each of its 8 microbatches, remat, 2 AdamW steps (exactly 768
           flash launches), against the same steps under the plain
           versions from the same seed: losses within 1e-4, the two
           runs' updates at a cosine of at least 0.99, and a control
           with attention on q, k, v rounded to e4m3 refused by that
           band; (b) Qwen3-4B
           ``prefill_32k`` at 8 x 2048 against ``lm_prefill`` on the same
           weights (36 launches; phase 4l's band, bit-equality printed);
           (c) DCN-v2 ``train_batch`` (65536 rows, one Adagrad step),
           ``serve_p99``, ``serve_bulk`` and ``retrieval_cand`` (2^20
           rows), 3 cross launches each, against their plain reruns
           (logits within 2e-5 of their term scale, parameters 1e-5);
           (d) ``online_20k`` on phase 4's environment against
           ``distclub_shard``'s epoch (every field equal; choose,
           rank1_update_inv, prune and cc_hop launched); (e)
           deepseek-moe-16b train (16 microbatches of one 2048-token
           row; held as (a), its reruns on the counted run's routings)
           and prefill cut to 2 layers; (f) a GAT cell against
           ``gnn_train_step`` (3 steps' losses 1e-5; parameters after
           the first within 1e-5 but for at most 0.1% of them).
           No multi-rank part:
           gloo ranks sharing the card crash in a functional collective
           on a CUDA tensor (``PERF.md`` section 7).
5. full    each kernel against its plain version on the state that run
           left (and on the full first-epoch adjacency for prune, whose
           words on the learned graph must equal its words on the full
           graph ANDed with the learned one; ucb's
           argmax must equal choose's choice for every user, and both
           choose variants and both ucb variants pick the same, forced on
           the state and on the serving batch's shortlist (256 x 64); ucb and
           rank1_update also at CLUB's n = 1 on its state's rows, and
           both rank-1 kernels there bit-equal to the whole state's
           warp-per-user variant with only that user live; ucb there
           bit-equal to its warp-per-user variant forced on the row), the
           two top-K kernels on one serving batch's users at full width
           (topk's shortlist scores ``torch.equal`` to ``ucb_scores`` of the
           shortlisted items, a block per user at 256 users; topk_pruned's
           skip ratio and its plain version's), cc_hop by ``check_cc_hop``
           on the learned graph (at the identity labels and at the run's)
           and on the full graph, the bf16-Minv variants (their errors
           from phase 4p's held runs), the reduced-precision variants
           (``check_rank1_bf16``: within one bf16 ulp or 1e-5, masked
           rows bit-identical, both variants bit-equal on 2 x SMs + 1
           users; ``check_topk_quant`` and ``check_topk_pruned`` over
           phase 4p's quantized banks: scores the bits of ``ucb_scores``
           of the dequantized items, bit-equal to the f32 kernel over
           them, pruned bit-equal to unpruned),
           cross on a serve_bulk batch's layers 1 and 2 on both routes,
           the W split of both bit-equal to its plain version, embedding_bag
           on the two bag batches of phase 4r, and flash on the q/k/v of
           phase 4l's prefill layers 0 and 35 and a decode step's layer 0,
           and of phase 4m's: deepseek's prefill layers 0 and 27 (group
           1) and a decode step's layer 0, llama4's two layers (group 5:
           the kernel within 2e-2 of the f32 version and 4e-2 of the
           plain version, which itself strays past 2e-2 there, reported).
6. times   median of 25 launches (CUDA events, L2 flushed before each) of
           every kernel and its plain version at the main path's shapes,
           beside the least time the card could take (bytes over 3.35 TB/s
           or f32 operations over 67 TFLOP/s, counted from these inputs;
           cross's tensor route: its three TF32 products over 494.7
           TFLOP/s, the f32 bound beside it)
           and, for embedding_bag, ``F.embedding_bag`` on the same inputs;
           choose beside its warp variant, 50 launches each in turns, on
           the state and on the serving batch's shortlist; cross at 262144
           and at 512 rows in turns with its other route and with cuBLAS
           ``addmm`` (its GEMM and bias alone); ucb and
           rank1_update also at n = 1, kernel and plain version over 200
           launches each, in turns (both also beside their warp-per-user
           variant on the same row); topk_pruned, its launch alone (the
           wrapper's walk plan done once) and topk over 50 launches each
           in turns; embedding_bag and
           F.embedding_bag at 512 bags likewise; the launch floor, a
           one-element in-place op's median over 200 launches, beside the
           n = 1 and 512-bag times; each reduced-precision variant
           beside its f32 kernel, 50 launches each in turns, on the bf16
           session's batch (the filter kernels also beside the chain
           kernels they replace, and held to their own bound: the
           product's d (d + 1) multiply-adds a row and piece at 989
           TFLOP/s plus the rescored chains at 67, or the bytes; the
           chain kernel's operations bound beside it); each bf16-Minv variant (choose, ucb and the
           M-ful update on phase 5's inputs with Minv in bf16, the top-K
           six on phase 4p's bf16-Minv serving batch) beside its f32
           kernel on the widened Minv, 50 launches each in turns; flash at phase 4l's prefill and decode
           shapes and at phase 4m's (deepseek's prefill and decode,
           llama4's prefill: ``moe_*_launches`` in its row), with
           ``scaled_dot_product_attention`` as its yardstick;
           bf16 flash runs on the tensor cores and is held to their bf16
           rate (989 TFLOP/s), its f32 bound printed beside it; cc_hop
           beside its warp-per-row kernel, 50 launches each in turns, on the
           learned graph (also after a flush that only reads 256 MB), the
           full graph and the graph of the main path's first stage 2 at
           its first two hops (held to the plain version there too), its
           dense threshold forced to each of 0 ... 32 on the last three, and
           rank1_update_inv after the read-only flush; prune also
           on phase 4's learned graph (its density, and a bound of its set
           bits x (2d + 8) operations), on random graphs of rising
           density, and on graphs with the same bits in every warp tile
           (the sparse threshold's measurement), each branch forced too
           (the walk only where no warp tile holds more than it takes).

Each row of the ``kernels`` JSON has the launches of the main path's
run and of each phase's counted runs (``train_launches``: phase 4t's;
``cells_launches``: phase 4c's).
The line before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12      # H100 SXM data sheet, f32 outside tensor cores
TF32_FLOPS_PER_S = 494.7e12  # H100 SXM data sheet, TF32 dense tensor cores
EPOCHS = 2
SEED = 0
REPS = 25
TURN_REPS = 200              # launches of each, in turns: n = 1 kernels
                             # and 512 bags against their yardsticks

KERNEL_INFO = {  # name -> (source, TPU kernel it replaces)
    "choose": ("src/repro_torch/csrc/choose.cu",
               "src/repro/kernels/interact/interact.py:80"),
    "rank1_update_inv": ("src/repro_torch/csrc/rank1.cu",
                         "src/repro/kernels/rank1/rank1.py:72"),
    "prune": ("src/repro_torch/csrc/prune.cu",
              "src/repro/kernels/graph/graph.py:65"),
    "cc_hop": ("src/repro_torch/csrc/cc_hop.cu",
               "src/repro/kernels/graph/graph.py:123"),
    "topk": ("src/repro_torch/csrc/topk.cu",
             "src/repro/kernels/topk/topk.py:114"),
    "topk_pruned": ("src/repro_torch/csrc/topk.cu",
                    "src/repro/kernels/topk/topk.py:229"),
    "cross": ("src/repro_torch/csrc/cross.cu",
              "src/repro/kernels/cross/cross.py:37"),
    "cross_split": ("src/repro_torch/csrc/cross.cu",
                    "src/repro/kernels/cross/cross.py:37"),
    "embedding_bag": ("src/repro_torch/csrc/embag.cu",
                      "src/repro/kernels/embag/embag.py:39"),
    "rank1_update": ("src/repro_torch/csrc/rank1.cu",
                     "src/repro/kernels/rank1/rank1.py:102"),
    "ucb": ("src/repro_torch/csrc/ucb.cu",
            "src/repro/kernels/ucb/ucb.py:59"),
    "flash": ("src/repro_torch/csrc/flash.cu",
              "src/repro/kernels/flash/flash.py:89"),
    # the reduced-precision variants (phase 4p)
    "rank1_update_inv_bf16": ("src/repro_torch/csrc/rank1.cu",
                              "src/repro/kernels/rank1/rank1.py:72"),
    # bf16 and int8 items at d <= 32: the tensor-core filter kernels
    # (their chain kernels, topk_bf16 ... topk_pruned_int8, are timed
    # beside them in phase 6)
    "topk_bf16_tc": ("src/repro_torch/csrc/topk_tc.cu",
                     "src/repro/kernels/topk/topk.py:114"),
    "topk_int8_tc": ("src/repro_torch/csrc/topk_tc.cu",
                     "src/repro/kernels/topk/topk.py:114"),
    "topk_pruned_bf16_tc": ("src/repro_torch/csrc/topk_tc.cu",
                            "src/repro/kernels/topk/topk.py:229"),
    "topk_pruned_int8_tc": ("src/repro_torch/csrc/topk_tc.cu",
                            "src/repro/kernels/topk/topk.py:229"),
    # the bf16-Minv variants (phase 4p, bf16 Minv)
    "choose_bf16": ("src/repro_torch/csrc/choose.cu",
                    "src/repro/kernels/interact/interact.py:80"),
    "ucb_bf16": ("src/repro_torch/csrc/ucb.cu",
                 "src/repro/kernels/ucb/ucb.py:59"),
    "rank1_update_bf16": ("src/repro_torch/csrc/rank1.cu",
                          "src/repro/kernels/rank1/rank1.py:102"),
    **{f"topk{p}_minv_bf16{s}": (
        "src/repro_torch/csrc/topk" + ("_tc" if s else "") + ".cu",
        "src/repro/kernels/topk/topk.py:" + ("229" if p else "114"))
       for p in ("", "_pruned") for s in ("", "_bf16_tc", "_int8_tc")},
}
# each bank's suffix of the top-K kernels' names at serving's d = 25: the
# f32 bank's chain kernels, the bf16 and int8 banks' filter kernels
BANK_SFX = {"f32": "", "bf16": "_bf16_tc", "int8": "_int8_tc"}
MINV_TOPK = tuple(f"topk{p}_minv_bf16{s}" for p in ("", "_pruned")
                  for s in BANK_SFX.values())
MINV_KERNELS = ("choose_bf16", "ucb_bf16", "rank1_update_bf16", *MINV_TOPK)
MINV_ROUNDS = 32             # phase 4p's lockstep engine rounds, bf16 Minv
PRECISIONS = ("bf16", "int8")  # phase 4p's reduced-precision sessions
# phase 4p's median batch ms, unpruned and pruned, through the chain
# kernels before the filter kernels served these banks (PERF.md section
# 5), printed beside this run's
CHAIN_BATCH_MS = {"bf16": (4.82, 8.03), "int8": (5.13, 8.57)}
FLIP_WARM = 32               # bench_precision.py's warm-up batches
FLIP_BATCHES = 16            # counterfactual batches measured after it
FLIP_MAX = 0.01              # bench_precision.py's choice_flip_rate gate
SERVE_ITEMS = 2**18          # the gate row of benchmarks/bench_retrieval.py
SERVE_BATCH = 256            # BENCH_serve.json's request batch
SERVE_BATCHES = 16
K_SHORT = 64
REFRESH_EVERY = 2048
P99_BATCHES = 16             # DCN-v2 serve_p99 batches of 512 rows
BULK_BATCHES = 2             # and serve_bulk batches of 262144
SEQ_BATCHES = 4              # serve_p99 batches of each sequence model
BAG_L = 50                   # ids per bag; the last 20% are 0-weight pads
CLUB_T = 2048                # benchmarks/bench_paper.py's CLUB slice
LM_ARCH = "qwen3-4b"         # full width and depth, random weights
LM_BATCH = 8                 # prefill_32k's 32 x 32768, cut to 8 x 2048
LM_PROMPT = 2048
LM_CACHE = 4096              # decode_32k's 128 x 32768, cut to 8 x 4096
LM_STEPS = 64
BF16_FLOPS_PER_S = 989e12    # H100 SXM data sheet, bf16 dense tensor cores
TRAIN_STEPS = 3              # phase 4t: Qwen3-4B and DCN-v2 steps
TRAIN_CLI_TIMEOUT_S = 600
TRAIN_CLIS = (("example", ["examples/train_lm_torch.py"]),
              ("distclub-paper", ["-m", "repro_torch.launch.train", "--arch",
                                  "distclub-paper", "--steps", "2"]),
              *((arch, ["-m", "repro_torch.launch.train", "--arch", arch,
                        "--reduce", "--steps", "5"])
                for arch in ("sasrec", "bert4rec", "mind", "dcn-v2")))
CLONE_USERS = (943, 1816, 1888, 5045)  # the web clones' users (Table 1)
CLONES = ("movielens", "lastfm", "delicious", "yahoo", "synthetic")
ENV_KINDS = ("synthetic", "replay", "drift", "catalog")
BENCH_DCCB_L = 16            # benchmarks/bench_paper.py's DCCB_L
BENCH_MOVIELENS_BUDGET = 16_000   # and its movielens interaction budget


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# kernel against plain version
# ---------------------------------------------------------------------------


def check_choose(w, Minv, ctx, occ, alpha):
    """x must be ctx[choice] exactly; choices equal except where the
    plain version's scores of the two picks are within 1e-5 max(1, |s|).
    The error reported is the largest plain-score gap between the plain
    pick and the kernel's, over all rows."""
    import torch
    from repro_torch.kernels.interact import ops, ref
    choice_k, x_k = ops.choose(w, Minv, ctx, occ, alpha)
    scores = ref.ucb_scores_ref(w, Minv, ctx, occ, alpha)
    choice_p = torch.argmax(scores, dim=-1)
    gathered = torch.take_along_dim(ctx, choice_k.long()[:, None, None],
                                    dim=1)[:, 0]
    assert torch.equal(x_k, gathered), "choose: x is not ctx[choice]"
    s_p = torch.take_along_dim(scores, choice_p[:, None], dim=1)[:, 0]
    s_k = torch.take_along_dim(scores, choice_k.long()[:, None], dim=1)[:, 0]
    gap = s_p - s_k                  # 0 where the picks agree
    near = gap <= 1e-5 * torch.clamp_min(s_p.abs(), 1.0)
    assert bool(near.all()), (
        f"choose: {int((~near).sum())} choices differ beyond a near tie")
    n_diff = int((choice_k.long() != choice_p).sum())
    return {"max_abs_err": float(gap.max()), "near_ties": n_diff}


def check_rank1(Minv, b, x, r, mask):
    """Minv and b within rtol = atol = 1e-5; masked rows bit-identical."""
    import torch
    from repro_torch.kernels.rank1 import ops, ref
    Minv_p, b_p = ref.rank1_update_inv_ref(Minv.clone(), b.clone(), x, r,
                                           mask)
    Minv_k, b_k = ops.rank1_update_inv(Minv.clone(), b.clone(), x, r, mask)
    torch.testing.assert_close(Minv_k, Minv_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(b_k, b_p, rtol=1e-5, atol=1e-5)
    off = ~mask
    assert torch.equal(Minv_k[off], Minv[off]) and torch.equal(b_k[off],
                                                                b[off])
    err = max(float((Minv_k - Minv_p).abs().max()),
              float((b_k - b_p).abs().max()))
    return {"max_abs_err": err}


def check_ucb(w, Minv, ctx, occ, alpha):
    """Scores within 1e-5 (1 + |s|) of the plain version's (the kernel
    fuses each multiply-add, the plain version rounds twice); the
    first-index argmax of each row equal to the fused choose kernel's
    choice, bit for bit (both run ucb_score.cuh)."""
    import torch
    from repro_torch.kernels.interact import ops as iops
    from repro_torch.kernels.ucb import ops, ref
    s_k = ops.ucb_scores(w, Minv, ctx, occ, alpha)
    s_p = ref.ucb_scores_ref(w, Minv, ctx, occ, alpha)
    err = (s_k - s_p).abs()
    assert bool((err <= 1e-5 * (1 + s_p.abs())).all()), "ucb: scores differ"
    choice, _ = iops.choose(w, Minv, ctx, occ, alpha)
    first = torch.argmax(s_k, dim=-1).to(torch.int32)
    assert torch.equal(first, choice), (
        f"ucb: argmax differs from choose for {int((first != choice).sum())}"
        " users")
    return {"max_abs_err": float(err.max())}


def ucb_variant(w, Minv, ctx, occ, alpha, variant):
    """ucb's kernel for Minv's dtype in the variant the caller names, past
    the wrapper."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.ucb import ops
    n, K, d = ctx.shape
    out = torch.empty(n, K, dtype=torch.float32, device=ctx.device)
    _build.launch(ops.KERNELS[Minv.dtype], w.data_ptr(), Minv.data_ptr(),
                  ctx.data_ptr(), occ.data_ptr(), float(alpha), n, K, d,
                  variant, out.data_ptr())
    return out


def check_ucb_variants(w, Minv, ctx, occ, alpha, u):
    """ucb's two variants on the same rows, bit for bit: the most users
    that take a block each on this card (``BLOCK_PER_USER_PER_SM`` an SM)
    as a leading view against the whole state of one user more (a warp
    per user), and user ``u``'s row view (n = 1, a block per user)
    against the same; each also by ``check_ucb``'s bands and argmax
    rule."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.ucb import ops
    n, K, d = ctx.shape
    sms = _build.sm_count(ctx.device.index or 0)
    nt = ops.BLOCK_PER_USER_PER_SM * sms
    assert n == nt + 1 and ops.variant(nt, K, d, sms) == ops.BLOCK_PER_USER
    assert ops.variant(n, K, d, sms) == ops.WARP_PER_USER
    assert ops.variant(1, K, d, sms) == ops.BLOCK_PER_USER
    whole = ops.ucb_scores(w, Minv, ctx, occ, alpha)
    head = ops.ucb_scores(w[:nt], Minv[:nt], ctx[:nt], occ[:nt], alpha)
    row = (w[u:u + 1], Minv[u:u + 1], ctx[u:u + 1], occ[u:u + 1])
    assert torch.equal(head, whole[:nt]), "ucb: the variants differ"
    assert torch.equal(ops.ucb_scores(*row, alpha), whole[u:u + 1]), (
        "ucb: the row view differs from the whole state")
    err = max(check_ucb(w, Minv, ctx, occ, alpha)["max_abs_err"],
              check_ucb(w[:nt], Minv[:nt], ctx[:nt], occ[:nt],
                        alpha)["max_abs_err"],
              check_ucb(*row, alpha)["max_abs_err"])
    return {"max_abs_err": err, "bit_equal": True,
            "row_offset_mod16": Minv[u:u + 1].data_ptr() % 16}


def choose_variant(w, Minv, ctx, occ, alpha, variant):
    """choose's kernel for Minv's dtype in the variant the caller names,
    past the wrapper (the register tile with the wrapper's users a
    block)."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.interact import ops
    n, K, d = ctx.shape
    users = ops.geometry(n, K, d, _build.sm_count(ctx.device.index or 0),
                         Minv.element_size())[1]
    choice = torch.empty(n, dtype=torch.int32, device=ctx.device)
    x = torch.empty(n, d, dtype=torch.float32, device=ctx.device)
    _build.launch(ops.KERNELS[Minv.dtype], w.data_ptr(), Minv.data_ptr(),
                  ctx.data_ptr(), occ.data_ptr(), float(alpha), n, K, d,
                  variant, users if variant == ops.REGISTER_TILE else 4,
                  choice.data_ptr(), x.data_ptr())
    return choice, x


def check_pick(w, Minv, ctx, occ, alpha):
    """choose's two variants and ucb's two, each forced past its wrapper
    on the same inputs (d <= 32, which all four take): the two choose
    variants pick the same candidates and copy the same x, bit for bit,
    and the first-index argmax of either ucb variant's scores is that
    pick (all four run ucb_score.cuh's chains in its order)."""
    import torch
    from repro_torch.kernels.interact import ops as iops
    from repro_torch.kernels.ucb import ops as uops
    c_w, x_w = choose_variant(w, Minv, ctx, occ, alpha, iops.WARP_PER_USER)
    c_t, x_t = choose_variant(w, Minv, ctx, occ, alpha, iops.REGISTER_TILE)
    assert torch.equal(c_w, c_t) and torch.equal(x_w, x_t), (
        f"choose: the variants differ for {int((c_w != c_t).sum())} users")
    for v in (uops.WARP_PER_USER, uops.BLOCK_PER_USER):
        first = torch.argmax(ucb_variant(w, Minv, ctx, occ, alpha, v),
                             dim=-1).to(torch.int32)
        assert torch.equal(first, c_t), (
            f"ucb variant {v}: argmax differs from choose's pick for "
            f"{int((first != c_t).sum())} users")
    return {"pick_bit_equal": True, "users": int(c_t.shape[0])}


def check_duplicates(w, Minv, ids, table, occ, alpha):
    """Slates gathered from an item table (``ctx = table[ids]``), as the
    replay and catalog kinds give them: both choose variants, forced,
    pick a candidate whose item id does not occur earlier in its slate (a
    duplicate never beats its first copy).  Returns how many rows picked
    an item that occurs twice in their slate."""
    import torch
    from repro_torch.kernels.interact import ops as iops
    ctx = table[ids.long()]
    same = ids[:, :, None] == ids[:, None, :]                  # [n, K, K]
    first = torch.argmax(same.to(torch.int32), dim=2)         # first copy
    twice = same.sum(dim=2) > 1
    for variant in (iops.WARP_PER_USER, iops.REGISTER_TILE):
        choice, _ = choose_variant(w, Minv, ctx, occ, alpha, variant)
        c = choice.long()[:, None]
        assert torch.equal(first.gather(1, c), c), (
            f"choose variant {variant}: a duplicate beat its first copy")
    return int(twice.gather(1, c).sum())


def check_rank1_mful(M, Minv, b, x, r, mask):
    """On copies: M, Minv and b within rtol = atol = 1e-5 of the plain
    version; masked rows bit-identical; the kernel writes through the
    tensors it is given."""
    import torch
    from repro_torch.kernels.rank1 import ops, ref
    plain = ref.rank1_update_ref(M.clone(), Minv.clone(), b.clone(), x, r,
                                 mask)
    given = (M.clone(), Minv.clone(), b.clone())
    got = ops.rank1_update(*given, x, r, mask)
    assert all(g is t for g, t in zip(got, given)), "rank1_update: copies"
    for g, p_ in zip(got, plain):
        torch.testing.assert_close(g, p_, rtol=1e-5, atol=1e-5)
    off = ~mask
    for g, a in zip(got, (M, Minv, b)):
        assert torch.equal(g[off], a[off]), "rank1_update: masked row moved"
    return {"max_abs_err": max(float((g - p_).abs().max())
                               for g, p_ in zip(got, plain))}


def check_rank1_row_view(M, Minv, b, x, r, u):
    """CLUB's call: user ``u``'s row views of the full state, updated in
    place through the views with ``x [1, d]``, ``r [1]``; every other row
    left bit-identical."""
    import torch
    from repro_torch.kernels.rank1 import ops, ref
    full = (M.clone(), Minv.clone(), b.clone())
    live = torch.ones(1, dtype=torch.bool, device=M.device)
    ops.rank1_update(*(t[u:u + 1] for t in full), x, r, live)
    plain = ref.rank1_update_ref(*(t[u:u + 1].clone() for t in (M, Minv, b)),
                                 x, r, live)
    for g, p_, a in zip(full, plain, (M, Minv, b)):
        torch.testing.assert_close(g[u:u + 1], p_, rtol=1e-5, atol=1e-5)
        rest = torch.ones(a.shape[0], dtype=torch.bool, device=a.device)
        rest[u] = False
        assert torch.equal(g[rest], a[rest]), "rank1_update: other rows moved"
    return {"max_abs_err": max(float((g[u:u + 1] - p_).abs().max())
                               for g, p_ in zip(full, plain))}


def check_rank1_variants(M, Minv, b, x, r, u):
    """Both rank-1 kernels' two variants on one user's row, bit for bit:
    user ``u``'s row views (n = 1: a block per user) against the whole
    state with only ``u`` live (more users than a block per user takes: a
    warp per user); every other row bit-identical to the input."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.rank1 import ops
    n, d = b.shape
    sms = _build.sm_count(b.device.index or 0)
    assert ops.variant(1, d, sms) == ops.BLOCK_PER_USER
    assert ops.variant(n, d, sms) == ops.WARP_PER_USER
    live = torch.ones(1, dtype=torch.bool, device=b.device)
    only_u = torch.zeros(n, dtype=torch.bool, device=b.device)
    only_u[u] = True
    xs, rs = torch.zeros_like(b), torch.zeros(n, device=b.device)
    xs[u], rs[u] = x[0], r[0]
    for name, state in (("rank1_update", (M, Minv, b)),
                        ("rank1_update_inv", (Minv, b))):
        fn = getattr(ops, name)
        row = tuple(t.clone() for t in state)
        whole = tuple(t.clone() for t in state)
        fn(*(t[u:u + 1] for t in row), x, r, live)
        fn(*whole, xs, rs, only_u)
        for a, c, t in zip(row, whole, state):
            assert torch.equal(a, c), f"{name}: the variants differ"
            assert torch.equal(a[:u], t[:u]) and torch.equal(a[u + 1:],
                                                             t[u + 1:])
    return {"bit_equal": True}


def check_rank1_threshold(M, Minv, b, x, r, mask):
    """A state of one user past the block-per-user limit: all of it (a
    warp per user) and its first users as a leading view (a block per
    user) within 1e-5 of the plain version and bit-equal on the rows they
    share, the view leaving the last row as it was; for both kernels."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.rank1 import ops
    n, d = b.shape
    sms = _build.sm_count(b.device.index or 0)
    nt = ops.BLOCK_PER_USER_PER_SM * sms
    assert n == nt + 1 and ops.variant(nt, d, sms) == ops.BLOCK_PER_USER
    assert ops.variant(n, d, sms) == ops.WARP_PER_USER
    err = 0.0
    for m in (nt, n):
        err = max(err, check_rank1_mful(M[:m], Minv[:m], b[:m], x[:m],
                                        r[:m], mask[:m])["max_abs_err"],
                  check_rank1(Minv[:m], b[:m], x[:m], r[:m],
                              mask[:m])["max_abs_err"])
    for name, state in (("rank1_update", (M, Minv, b)),
                        ("rank1_update_inv", (Minv, b))):
        fn = getattr(ops, name)
        head = tuple(t.clone() for t in state)
        whole = tuple(t.clone() for t in state)
        fn(*(t[:nt] for t in head), x[:nt], r[:nt], mask[:nt])
        fn(*whole, x, r, mask)
        for a, c, t in zip(head, whole, state):
            assert torch.equal(a[:nt], c[:nt]), f"{name}: the variants differ"
            assert torch.equal(a[nt:], t[nt:]), f"{name}: the view spilled"
    return {"max_abs_err": err, "bit_equal": True}


def check_prune(adj, v_i, cb_i, v_j, cb_j, gamma):
    """Bit-equal, except pairs with |dist - thresh| <= 1e-5 thresh.  The
    error reported is the largest |dist - thresh| (f64) over the pairs
    whose bits differ, 0 where none do."""
    import torch
    from repro_torch.kernels.graph import ops, ref
    out_k = ops.prune_packed(adj, v_i, cb_i, v_j, cb_j, gamma)
    out_p = ref.prune_packed_ref(adj, v_i, cb_i, v_j, cb_j, gamma)
    assert not bool((out_k & ~adj).any()), "prune set a bit"
    pairs = []
    for r0 in range(0, adj.shape[0], 2048):
        xor = ref.unpack_bits(out_k[r0:r0 + 2048] ^ out_p[r0:r0 + 2048],
                              v_j.shape[0])
        ij = torch.nonzero(xor)
        ij[:, 0] += r0
        pairs.append(ij)
    ij = torch.cat(pairs)
    vi, vj = v_i[ij[:, 0]].double(), v_j[ij[:, 1]].double()
    d2 = (vi * vi).sum(-1) + (vj * vj).sum(-1) - 2 * (vi * vj).sum(-1)
    dist = torch.sqrt(torch.clamp_min(d2, 0))
    thresh = gamma * (cb_i[ij[:, 0]].double() + cb_j[ij[:, 1]].double())
    near = (dist - thresh).abs() <= 1e-5 * thresh
    assert bool(near.all()), (
        f"prune: {int((~near).sum())} bits differ away from the boundary")
    err = float((dist - thresh).abs().max()) if ij.shape[0] else 0.0
    return {"max_abs_err": err, "near_ties": int(ij.shape[0])}


def prune_branch(adj, v_i, cb_i, v_j, cb_j, gamma, sparse_max):
    """prune's kernel with its sparse threshold set by the caller (0: every
    warp with a set bit takes the dense branch; ``SPARSE_CAP``: every warp
    with at most that many bits walks them), past the wrapper."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.graph import ops
    R, W = adj.shape
    C, d = v_j.shape
    out = torch.empty_like(adj)
    work = torch.empty(ops.prune_work_floats(R, W, d), dtype=torch.float32,
                       device=adj.device)
    _build.launch("prune", adj.data_ptr(), v_i.data_ptr(), cb_i.data_ptr(),
                  v_j.data_ptr(), cb_j.data_ptr(), float(gamma), R, W, C, d,
                  sparse_max, work.data_ptr(), out.data_ptr())
    return out


def check_prune_branches(adj, v_i, cb_i, v_j, cb_j, gamma):
    """Both branches of the prune kernel forced on the same words, each
    bit-equal to the wrapper's words.  ``adj`` must hold at most
    SPARSE_CAP set bits in every warp tile, so that no block of the forced
    walk goes dense; returns the most bits a warp tile holds."""
    import torch
    from repro_torch.kernels.graph import ops
    most = int(ops.warp_tile_bits(adj).max())
    assert most <= ops.SPARSE_CAP, (
        f"prune: a warp tile holds {most} bits, more than the walk takes")
    out = ops.prune_packed(adj, v_i, cb_i, v_j, cb_j, gamma)
    for sparse_max in (0, ops.SPARSE_CAP):
        got = prune_branch(adj, v_i, cb_i, v_j, cb_j, gamma, sparse_max)
        assert torch.equal(got, out), (
            f"prune: the branch at sparse_max={sparse_max} differs")
    return most


def sqrt_check() -> int:
    """The branch-free square root of prune's and topk's epilogues
    (``csrc/sqrt_rn.cuh``) against sqrtf on every non-negative float, on
    the card (``prune_sqrt_check``); raises on any mismatch."""
    import ctypes
    import torch
    from repro_torch.kernels import _build
    fn = _build.load("prune").prune_sqrt_check
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    count = torch.zeros(1, dtype=torch.int64, device="cuda")
    err = fn(count.data_ptr(), torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"prune_sqrt_check: CUDA error {err}"
    n = int(count)
    assert n == 0, f"sqrt_rn differs from sqrtf on {n} floats"
    return n


def tile_adj(g, R, C, k, dev, rows=2048):
    """A packed [R, ceil(C/32)] adjacency with k set bits at random
    columns in each row's every 128 columns (fewer in a ragged last 128,
    whose columns past C are dropped), so that a full warp tile of prune
    (16 rows by 128 columns) holds 16 k; drawn ``rows`` rows at a time."""
    import torch
    from repro_torch.kernels.graph import ref as gref
    segs = -(-C // 128)
    parts = []
    for r0 in range(0, R, rows):
        m = min(rows, R - r0)
        key = torch.rand(m, segs, 128, generator=g, device=dev)
        bits = torch.zeros(m, segs, 128, dtype=torch.bool, device=dev)
        bits.scatter_(-1, key.topk(k, dim=-1).indices, True)
        parts.append(gref.pack_bits(bits.reshape(m, -1)[:, :C]))
    return torch.cat(parts)


def random_adj(g, R, C, p, dev, rows=2048):
    """A packed [R, ceil(C/32)] adjacency with each bit set with
    probability p, drawn on the card ``rows`` rows at a time."""
    import torch
    from repro_torch.kernels.graph import ref as gref
    return torch.cat([gref.pack_bits(
        torch.rand(min(rows, R - r0), C, generator=g, device=dev) < p)
        for r0 in range(0, R, rows)])


def check_topk(w, Minv, occ, items, live, alpha, k, got=None, plain=None):
    """The kernel's shortlist (``got``, else a fresh launch) against the
    plain version's (``plain``, else computed here): the finite pattern
    equal; scores at each position within 1e-5 (1 + |s|); ids equal
    except near ties, where the plain score of the kernel's item at that
    position is within the same tolerance of the plain score there
    (counted)."""
    import torch
    from repro_torch.kernels.interact import ref as iref
    from repro_torch.kernels.topk import ops, ref
    s_k, i_k = got if got is not None else ops.topk(w, Minv, occ, items,
                                                    live, alpha, k)
    s_p, i_p = plain if plain is not None else ref.topk_ref(
        w, Minv, occ, items, live, alpha, k)
    fin = torch.isfinite(s_p)
    assert torch.equal(fin, torch.isfinite(s_k)), "topk: -inf pattern"
    assert torch.equal(i_k[~fin], i_p[~fin]), "topk: underfull ids"
    tol = 1e-5 * (1 + s_p.abs())
    err = torch.where(fin, (s_k - s_p).abs(), torch.zeros_like(s_p))
    assert bool((err[fin] <= tol[fin]).all()), "topk: scores differ"
    diff = (i_k != i_p) & fin
    if bool(diff.any()):
        x = items[i_k.clamp_min(0).long()]
        s_of_k = iref.ucb_scores_ref(w, Minv, x, occ, alpha)
        near = (s_of_k - s_p).abs() <= tol
        assert bool(near[diff].all()), "topk: ids differ beyond near ties"
    return {"max_abs_err": float(err.max()), "near_ties": int(diff.sum())}


def check_topk_pruned(w, Minv, occ, cat, clusters, alpha, k):
    """Both sides bit-equal across the layouts: the pruned kernel to the
    unpruned kernel over the unsorted catalog, the pruned plain version
    to the unpruned plain version; then the pruned kernel against its
    plain version on the same inputs, by ``check_topk``'s bands.  Returns
    the error dict with the kernel's and the plain version's skip
    ratios.  An int8 catalog's scales go with it (the pruned kernels take
    the sorted ones)."""
    import torch
    from repro_torch.core.catalog import dequantize
    from repro_torch.kernels.topk import ops, ref
    bank = cat.serving
    quant = bank.emb.dtype == torch.int8
    sc = bank.scale if quant else None
    ss = clusters.scale_sorted if quant else None
    tb = ref.tile_bounds(w, Minv, occ, alpha, clusters.tile_mu,
                         clusters.tile_r, clusters.tile_xn, clusters.tile_n)
    s_u, i_u = ops.topk(w, Minv, occ, bank.emb, bank.live, alpha, k,
                        scales=sc)
    s_k, i_k, sk, tot = ops.topk_pruned(
        w, Minv, occ, clusters.emb_sorted, clusters.live_sorted,
        clusters.perm, alpha, k, tb, scales=ss)
    assert torch.equal(s_k, s_u) and torch.equal(i_k, i_u), (
        "topk_pruned is not bit-equal to topk")
    s_p, i_p, sk_p, tot_p = ref.topk_ref_pruned(
        w, Minv, occ, clusters.emb_sorted, clusters.live_sorted,
        clusters.perm, alpha, k, tb, scales=ss)
    s_r, i_r = ref.topk_ref(w, Minv, occ, bank.emb, bank.live, alpha, k,
                            scales=sc)
    assert torch.equal(s_p, s_r) and torch.equal(i_p, i_r), (
        "topk_ref_pruned is not bit-equal to topk_ref")
    res = check_topk(w, Minv, occ, dequantize(bank), bank.live, alpha, k,
                     got=(s_k, i_k), plain=(s_p, i_p))
    res.update(skip=sk / tot, plain_skip=sk_p / tot_p)
    return res


def check_topk_piece(w, Minv, occ, emb_sorted, live_sorted, ids_sorted,
                     tile_mu, tile_r, tile_xn, tile_n, alpha, items, *, k):
    """The pruned kernel on a shard's piece of the sorted stream (the
    arguments of ``RetrievalBackend.shortlist_pruned``, global ids): its
    scores bit-equal to the unpruned kernel's over the same piece, its
    shortlist against the pruned plain version's by ``check_topk``'s
    bands (``items``: the whole catalog, which the global ids index)."""
    import torch
    from repro_torch.kernels.topk import ops, ref
    tb = ref.tile_bounds(w, Minv, occ, alpha, tile_mu, tile_r, tile_xn,
                         tile_n)
    s_k, i_k, sk, tot = ops.topk_pruned(w, Minv, occ, emb_sorted,
                                        live_sorted, ids_sorted, alpha, k, tb)
    s_u, _ = ops.topk(w, Minv, occ, emb_sorted, live_sorted, alpha, k)
    assert torch.equal(s_k, s_u), "topk_pruned on a piece: other scores"
    s_p, i_p, sk_p, tot_p = ref.topk_ref_pruned(
        w, Minv, occ, emb_sorted, live_sorted, ids_sorted, alpha, k, tb)
    res = check_topk(w, Minv, occ, items, None, alpha, k, got=(s_k, i_k),
                     plain=(s_p, i_p))
    res.update(skip=sk / tot, plain_skip=sk_p / tot_p)
    return res


def bf16_ulps(a, b):
    """The distance, in bf16 ulps, between two bf16 tensors, elementwise."""
    import torch

    def ordered(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits >= 0, bits, -32768 - bits)

    return (ordered(a) - ordered(b)).abs()


def check_rank1_bf16(Minv, b, x, r, mask):
    """rank1_update_inv on a bf16 Minv against its plain version: each
    element of Minv within one bf16 ulp, or within the f32 update's
    atol of 1e-5 (the two sum Minv x in other orders, so their f32
    values differ by a few f32 ulps before the rounding to bf16; where
    the subtraction cancels, a value far below 1 holds that difference
    as several of its own bf16 ulps); b within rtol = atol = 1e-5;
    masked rows bit-identical."""
    import torch
    from repro_torch.kernels.rank1 import ops, ref
    assert Minv.dtype == torch.bfloat16
    Minv_p, b_p = ref.rank1_update_inv_ref(Minv.clone(), b.clone(), x, r,
                                           mask)
    Minv_k, b_k = ops.rank1_update_inv(Minv.clone(), b.clone(), x, r, mask)
    ulps = bf16_ulps(Minv_k, Minv_p)
    gap = (Minv_k.float() - Minv_p.float()).abs()
    wide = ulps > 1
    assert bool((gap[wide] <= 1e-5).all()), (
        f"rank1_update_inv_bf16: {int((wide & (gap > 1e-5)).sum())} "
        "elements beyond one ulp and 1e-5")
    torch.testing.assert_close(b_k, b_p, rtol=1e-5, atol=1e-5)
    off = ~mask
    assert torch.equal(Minv_k[off], Minv[off]) and torch.equal(b_k[off],
                                                                b[off])
    err = max(float(gap.max()), float((b_k - b_p).abs().max()))
    return {"max_abs_err": err, "max_ulps": int(ulps.max()),
            "beyond_one_ulp": int(wide.sum()),
            "max_abs_beyond": float(Minv_p.float()[wide].abs().max())
            if bool(wide.any()) else 0.0,
            "ulp_share": float((Minv_k != Minv_p).float().mean())}


def check_rank1_bf16_variants(Minv, b, x, r, mask):
    """The bf16 update's two variants on the same rows, bit for bit: the
    first 2 x SMs users as a leading view (a block per user) against the
    whole state (a warp per user, ``n`` past that limit); the rows past
    the view as they were."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.rank1 import ops
    n, d = b.shape
    sms = _build.sm_count(b.device.index or 0)
    nt = ops.BLOCK_PER_USER_PER_SM * sms
    assert ops.variant(nt, d, sms) == ops.BLOCK_PER_USER
    assert ops.variant(n, d, sms) == ops.WARP_PER_USER
    head = (Minv.clone(), b.clone())
    whole = (Minv.clone(), b.clone())
    ops.rank1_update_inv(head[0][:nt], head[1][:nt], x[:nt], r[:nt],
                         mask[:nt])
    ops.rank1_update_inv(*whole, x, r, mask)
    for a, c, t in zip(head, whole, (Minv, b)):
        assert torch.equal(a[:nt], c[:nt]), "rank1 bf16: the variants differ"
        assert torch.equal(a[nt:], t[nt:]), "rank1 bf16: the view spilled"
    return {"bit_equal": True, "block_rows": nt, "warp_rows": n}


def check_topk_quant(w, Minv, occ, items, live, scales, alpha, k):
    """A reduced catalog's top-K (bf16, or int8 with ``scales``): the
    kernel against its plain version by ``check_topk``'s bands on the
    dequantized items; the kernel's shortlist scores the bits of
    ``ucb_scores`` of the dequantized items, and its shortlist bit-equal
    to the f32 kernel's over the dequantized rows (dequantization on chip
    is exact or one rounding, as the plain version's)."""
    import torch
    from repro_torch.kernels.topk import ops, ref
    from repro_torch.kernels.ucb import ops as uops
    deq = ref.dequantize_rows(items, scales).contiguous()
    got = ops.topk(w, Minv, occ, items, live, alpha, k, scales=scales)
    plain = ref.topk_ref(w, Minv, occ, items, live, alpha, k, scales=scales)
    res = check_topk(w, Minv, occ, deq, live, alpha, k, got=got, plain=plain)
    s_k, i_k = got
    held = i_k >= 0
    s_u = uops.ucb_scores(w, Minv, deq[i_k.clamp_min(0).long()], occ, alpha)
    assert torch.equal(s_k[held], s_u[held]), (
        "topk: reduced shortlist scores differ from ucb_scores")
    s_f, i_f = ops.topk(w, Minv, occ, deq, live, alpha, k)
    assert torch.equal(s_k, s_f) and torch.equal(i_k, i_f), (
        "topk: the reduced kernel differs from the f32 one on its rows")
    return res


@contextlib.contextmanager
def uncounted():
    """Launches inside the block leave the counts as they were: the
    comparisons a counted run makes between its steps."""
    from repro_torch.kernels import _build
    counts = dict(_build.LAUNCHES)
    try:
        yield
    finally:
        _build.LAUNCHES.update(counts)


def hold_choose(w, Minv, ctx, occ, alpha, choice, x, scores=None):
    """A choose's outputs on a bf16 Minv (``choice``, ``x``; ucb's
    ``scores`` where given) against the kernels for Minv's f32 widening
    (exact), bit for bit, and against the plain versions on the same
    inputs: ``check_choose``'s near-tie band for the pick, ``check_ucb``'s
    for the scores; x is ctx[choice] and the scores' first-index argmax
    is the pick."""
    import torch
    from repro_torch.kernels.interact import ops as iops
    from repro_torch.kernels.ucb import ops as uops
    from repro_torch.kernels.ucb import ref as uref
    assert Minv.dtype == torch.bfloat16
    c32, x32 = iops.choose(w, Minv.float(), ctx, occ, alpha)
    assert torch.equal(choice, c32) and torch.equal(x, x32), (
        "choose_bf16: not the f32 kernel's pick on the widened Minv")
    plain = uref.ucb_scores_ref(w, Minv, ctx, occ, alpha)
    assert torch.equal(x, torch.take_along_dim(
        ctx, choice.long()[:, None, None], dim=1)[:, 0]), (
        "choose_bf16: x is not ctx[choice]")
    s_p = plain.max(dim=-1).values
    s_k = torch.take_along_dim(plain, choice.long()[:, None], dim=1)[:, 0]
    gap = s_p - s_k
    assert bool((gap <= 1e-5 * torch.clamp_min(s_p.abs(), 1.0)).all()), (
        "choose_bf16: choices differ beyond a near tie")
    res = {"max_abs_err": float(gap.max()),
           "near_ties": int((choice.long() != plain.argmax(-1)).sum())}
    if scores is not None:
        assert torch.equal(scores, uops.ucb_scores(w, Minv.float(), ctx, occ,
                                                   alpha)), (
            "ucb_bf16: not the f32 kernel's scores on the widened Minv")
        err = (scores - plain).abs()
        assert bool((err <= 1e-5 * (1 + plain.abs())).all()), (
            "ucb_bf16: scores differ")
        assert torch.equal(torch.argmax(scores, -1).to(torch.int32),
                           choice), "ucb_bf16: argmax is not the pick"
        res["ucb_max_abs_err"] = float(err.max())
    return res


def check_choose_bf16(w, Minv, ctx, occ, alpha):
    """choose and ucb on a bf16 Minv through their wrappers, by
    ``hold_choose``; then, where the register tile takes the shape (d <=
    32, K <= 256), both choose variants and both ucb variants forced: the
    same picks, bit for bit (``check_pick``)."""
    from repro_torch.kernels.interact import ops as iops
    from repro_torch.kernels.ucb import ops as uops
    choice, x = iops.choose(w, Minv, ctx, occ, alpha)
    res = hold_choose(w, Minv, ctx, occ, alpha, choice, x,
                      uops.ucb_scores(w, Minv, ctx, occ, alpha))
    _, K, d = ctx.shape
    if d <= iops.TILE_MAX_D and -(-K // iops.TILE_TK) <= iops.TILE_THREADS:
        res.update(check_pick(w, Minv, ctx, occ, alpha))
    return res


def hold_rank1_bf16(before, after, x, r, mask):
    """An M-ful update on a bf16 Minv (``before`` = (M, Minv, b) as they
    were, ``after`` as the kernel left them) against the f32 kernel on
    Minv's widening: Minv the round-to-nearest-even of its result, M and
    b bit-equal; and against the plain version on the same inputs: Minv
    within one bf16 ulp or 1e-5 (``check_rank1_bf16``'s band), M and b
    within rtol = atol = 1e-5; masked rows bit-identical."""
    import torch
    from repro_torch.kernels.rank1 import ops, ref
    M, Minv, b = before
    f32 = ops.rank1_update(M.clone(), Minv.float(), b.clone(), x, r, mask)
    assert torch.equal(after[1], f32[1].bfloat16()), (
        "rank1_update_bf16: Minv is not the f32 kernel's, rounded")
    assert torch.equal(after[0], f32[0]) and torch.equal(after[2], f32[2]), (
        "rank1_update_bf16: M or b is not the f32 kernel's")
    plain = ref.rank1_update_ref(M.clone(), Minv.clone(), b.clone(), x, r,
                                 mask)
    ulps = bf16_ulps(after[1], plain[1])
    gap = (after[1].float() - plain[1].float()).abs()
    wide = ulps > 1
    assert bool((gap[wide] <= 1e-5).all()), (
        f"rank1_update_bf16: {int((wide & (gap > 1e-5)).sum())} elements "
        "beyond one ulp and 1e-5")
    for i in (0, 2):
        torch.testing.assert_close(after[i], plain[i], rtol=1e-5, atol=1e-5)
    off = ~mask
    for a, t in zip(after, before):
        assert torch.equal(a[off], t[off]), "rank1_update_bf16: masked row"
    return {"max_abs_err": max(float(gap.max()), *(
        float((after[i] - plain[i]).abs().max()) for i in (0, 2))),
        "max_ulps": int(ulps.max()), "beyond_one_ulp": int(wide.sum())}


def check_rank1_mful_bf16(M, Minv, b, x, r, mask):
    """The M-ful update on a bf16 Minv through its wrapper, on copies, by
    ``hold_rank1_bf16``; the kernel writes through the tensors it is
    given."""
    from repro_torch.kernels.rank1 import ops
    given = (M.clone(), Minv.clone(), b.clone())
    got = ops.rank1_update(*given, x, r, mask)
    assert all(g is t for g, t in zip(got, given)), "rank1_update: copies"
    return hold_rank1_bf16((M, Minv, b), got, x, r, mask)


def check_topk_minv_bf16(w, Minv, occ, items, live, scales, alpha, k,
                         got=None):
    """The top-K over f32, bf16 or int8 items (int8 with ``scales``) with
    the users' Minv in bf16: its shortlist (``got``, else a fresh launch)
    and score bits the kernel's for Minv's f32 widening, and the kernel
    against its plain version by ``check_topk_quant``."""
    import torch
    from repro_torch.kernels.topk import ops
    assert Minv.dtype == torch.bfloat16
    s, i = got if got is not None else ops.topk(w, Minv, occ, items, live,
                                                alpha, k, scales=scales)
    s32, i32 = ops.topk(w, Minv.float(), occ, items, live, alpha, k,
                        scales=scales)
    assert torch.equal(s, s32) and torch.equal(i, i32), (
        "topk_minv_bf16: not the f32-Minv kernel's shortlist")
    return check_topk_quant(w, Minv, occ, items, live, scales, alpha, k)


def check_topk_pruned_minv_bf16(w, Minv, occ, cat, clusters, alpha, k,
                                got=None):
    """The pruned top-K with the users' Minv in bf16 over ``cat``'s bank:
    its shortlist (``got``, else a fresh launch) the pruned kernel's for
    Minv's f32 widening, bit for bit (the skips may differ), and
    ``check_topk_pruned``'s checks on the bf16 Minv."""
    import torch
    from repro_torch.kernels.topk import ops, ref
    assert Minv.dtype == torch.bfloat16
    ss = clusters.scale_sorted if cat.serving.emb.dtype == torch.int8 \
        else None
    tb = ref.tile_bounds(w, Minv, occ, alpha, clusters.tile_mu,
                         clusters.tile_r, clusters.tile_xn, clusters.tile_n)
    args = (clusters.emb_sorted, clusters.live_sorted, clusters.perm, alpha,
            k, tb)
    s, i = got if got is not None else ops.topk_pruned(
        w, Minv, occ, *args, scales=ss)[:2]
    s32, i32, _, _ = ops.topk_pruned(w, Minv.float(), occ, *args, scales=ss)
    assert torch.equal(s, s32) and torch.equal(i, i32), (
        "topk_pruned_minv_bf16: not the f32-Minv kernel's shortlist")
    return check_topk_pruned(w, Minv, occ, cat, clusters, alpha, k)


def check_topk_filter(w, Minv, occ, items, live, scales, alpha, k,
                      got=None):
    """A filter kernel (bf16 or int8 items at d <= 32, ``got`` or a
    fresh launch) against the chain kernel it replaces (``chain=True``)
    on the same inputs, scores and ids bit for bit; no violation; its
    scores ``ucb_scores``' bits on the widened rows (the rescoring's
    chain is a copy of csrc/ucb_score.cuh's, held to it here); then
    against the plain version by ``check_topk``'s bands.  Returns the
    error dict with the rescored share (pairs rescored over live pairs)
    and the violations."""
    import torch
    from repro_torch.kernels.topk import ops, ref
    from repro_torch.kernels.ucb import ops as uops
    assert ops.route(ops.item_kind(items, scales), w.shape[1]) == ops.FILTER
    with ops.FilterStats() as st:
        s_t, i_t = ops.topk(w, Minv, occ, items, live, alpha, k,
                            scales=scales)
    if got is not None:
        assert torch.equal(got[0], s_t) and torch.equal(got[1], i_t), (
            "topk filter: not the launch's own shortlist")
    s_c, i_c = ops.topk(w, Minv, occ, items, live, alpha, k, scales=scales,
                        chain=True)
    assert torch.equal(s_t, s_c) and torch.equal(i_t, i_c), (
        "topk filter: not the chain kernel's shortlist")
    rescored, viol = st.rescored, st.violations
    assert viol == 0, f"topk filter: {viol} violations"
    deq = ref.dequantize_rows(items, scales).contiguous()
    held = i_t >= 0
    s_u = uops.ucb_scores(w, Minv, deq[i_t.clamp_min(0).long()], occ, alpha)
    assert torch.equal(s_t[held], s_u[held]), (
        "topk filter: shortlist scores differ from ucb_scores")
    plain = ref.topk_ref(w, Minv, occ, items, live, alpha, k, scales=scales)
    res = check_topk(w, Minv, occ, deq, live, alpha, k, got=(s_t, i_t),
                     plain=plain)
    pairs = w.shape[0] * int((live > 0).sum())
    res.update(rescored=rescored, violations=viol,
               rescored_share=rescored / max(pairs, 1))
    return res


def check_topk_pruned_filter(w, Minv, occ, items_sorted, live_sorted,
                             ids_sorted, scales_sorted, tb, alpha, k,
                             unpruned):
    """The pruned filter kernel against the pruned chain kernel on the
    same sorted layout, and against ``unpruned`` (the unpruned filter
    kernel's shortlist over the unsorted catalog), bit for bit; no
    violation.  Returns the rescored share (over the live pairs) and
    both skip ratios."""
    import torch
    from repro_torch.kernels.topk import ops
    args = (w, Minv, occ, items_sorted, live_sorted, ids_sorted, alpha, k,
            tb)
    with ops.FilterStats() as st:
        s_t, i_t, sk_t, tot = ops.topk_pruned(*args, scales=scales_sorted)
    s_c, i_c, sk_c, _ = ops.topk_pruned(*args, scales=scales_sorted,
                                        chain=True)
    assert torch.equal(s_t, s_c) and torch.equal(i_t, i_c), (
        "topk_pruned filter: not the chain kernel's shortlist")
    assert torch.equal(s_t, unpruned[0]) and torch.equal(i_t, unpruned[1]), (
        "topk_pruned filter: not the unpruned shortlist")
    rescored, viol = st.rescored, st.violations
    assert viol == 0, f"topk_pruned filter: {viol} violations"
    pairs = w.shape[0] * int((live_sorted > 0).sum())
    return {"rescored": rescored, "violations": viol,
            "rescored_share": rescored / max(pairs, 1),
            "skip": sk_t / tot, "chain_skip": sk_c / tot}


def sorted_layout(w, Minv, occ, items, live, scales, alpha, tile, seed):
    """A cluster-sorted layout of a raw bank for the pruned kernels: rows
    ordered by a random projection, ``tile``-row tiles with their stats
    and bounds.  Returns (items, live, ids, scales, tb), sorted."""
    import torch
    from repro_torch.kernels.topk import ref
    dev = w.device
    N, d = items.shape
    deq = ref.dequantize_rows(items, scales)
    g = torch.Generator(device=dev).manual_seed(seed)
    key = deq @ torch.randn(d, generator=g, device=dev)
    perm = torch.argsort(key).to(torch.int32)
    p = perm.long()
    T = N // tile
    et = deq[p].view(T, tile, d)
    lt = live[p].view(T, tile)
    cnt = lt.sum(1)
    mu = (et * lt[..., None]).sum(1) / cnt.clamp_min(1)[:, None]
    r = torch.where(lt > 0, torch.linalg.norm(et - mu[:, None], dim=-1),
                    0.0).amax(1)
    xn = torch.where(lt > 0, torch.linalg.norm(et, dim=-1), 0.0).amax(1)
    tb = ref.tile_bounds(w, Minv, occ, alpha, mu, r, xn, cnt.to(torch.int32))
    return (items[p].contiguous(), live[p].contiguous(), perm,
            None if scales is None else scales[p].contiguous(), tb)


def small_filter_checks(dev):
    """The filter kernels on stress catalogs (``ref.stress_case``: many
    pairs at a user's floor: copies of user 0's k-th item, rows one ulp
    apart, rows where the bonus dominates, near-singular Minv from 400
    rank-1 updates, zero, tiny and dead rows), n = 261 (not a multiple
    of 8), N = 20037 (not a multiple of the chunk), k 1, 64 and 128, d 8,
    25 (est from the product) and 32 (est from the features), bf16 and
    int8 items, Minv in f32 and bf16: each entry bit-equal to the chain
    kernel, no violation, within check_topk's bands of the plain
    version; the pruned entries on a sorted layout (tiles of 511 rows)
    bit-equal to the pruned chain kernel and to the unpruned shortlist."""
    import torch
    from repro_torch.kernels.topk import ops, ref
    t0 = time.perf_counter()
    n, N, tile = 261, 20037, 511
    cases = [(25, 64), (25, 1), (25, 128), (32, 64), (8, 64)]
    for ci, (dd, kk) in enumerate(cases):
        for prec in PRECISIONS:
            for minv in (torch.float32, torch.bfloat16):
                case = ref.stress_case(SEED + 40 + ci, n, dd, N, kk, prec,
                                       minv_dtype=minv)
                w, M, occ, items, live, sc = (
                    None if t is None else t.to(dev) for t in case)
                res = check_topk_filter(w, M, occ, items, live, sc, 0.3, kk)
                N2 = N - N % tile
                got = ops.topk(w, M, occ, items[:N2], live[:N2], 0.3, kk,
                               scales=None if sc is None else sc[:N2])
                lay = sorted_layout(w, M, occ, items[:N2], live[:N2],
                                    None if sc is None else sc[:N2], 0.3,
                                    tile, SEED + ci)
                resp = check_topk_pruned_filter(
                    w, M, occ, lay[0], lay[1], lay[2], lay[3], lay[4], 0.3,
                    kk, got)
                log(f"small topk filter {prec} Minv {str(minv)[6:]} "
                    f"(stress, n={n}, d={dd}, N={N}, k={kk}): {res}; "
                    f"pruned (N={N2}, tile {tile}): {resp}")
    log(f"small topk filter checks: {time.perf_counter() - t0} s")


def cc_hop_forced(adj, labels_self, labels_j, dense_min):
    """cc_hop's kernel with the dense threshold set by the caller (0:
    every word with a set bit takes the min over its 32 labels; 32: every
    word is walked), the wrapper's geometry, past the wrapper."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.graph import ops
    R, W = adj.shape
    vec, blocks = ops.cc_hop_geometry(R, W, adj.data_ptr(),
                                      _build.sm_count(adj.device.index or 0))
    out = torch.empty(R, dtype=torch.int32, device=adj.device)
    _build.launch("cc_hop", adj.data_ptr(), labels_self.data_ptr(),
                  labels_j.data_ptr(), R, W, labels_j.shape[0], vec, blocks,
                  dense_min, out.data_ptr())
    return out


def cc_hop_warp(adj, labels_self, labels_j):
    """cc_hop's warp-per-row kernel (``cc_hop_warp_launch``, the design
    before the streaming one), which nothing on the path launches."""
    import torch
    from repro_torch.kernels import _build
    R, W = adj.shape
    out = torch.empty(R, dtype=torch.int32, device=adj.device)
    _build.launch("cc_hop_warp", adj.data_ptr(), labels_self.data_ptr(),
                  labels_j.data_ptr(), R, W, labels_j.shape[0],
                  out.data_ptr())
    return out


def check_cc_hop(adj, labels_self, labels_j):
    """Integer-exact: the wrapper's labels equal to the plain version's,
    and to the kernel's with its threshold forced both ways and to the
    warp-per-row kernel's, each ``torch.equal``."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.graph import ops, ref
    out_k = ops.cc_hop_packed(adj, labels_self, labels_j)
    out_p = ref.cc_hop_packed_ref(adj, labels_self, labels_j)
    err = float((out_k.long() - out_p.long()).abs().max())
    assert err == 0, "cc_hop differs from its plain version"
    for dense_min in (0, 32):
        assert torch.equal(cc_hop_forced(adj, labels_self, labels_j,
                                         dense_min), out_k), (
            f"cc_hop: the kernel at dense_min={dense_min} differs")
    assert torch.equal(cc_hop_warp(adj, labels_self, labels_j), out_k), (
        "cc_hop: the warp-per-row kernel differs")
    R, W = adj.shape
    geo = ops.cc_hop_geometry(R, W, adj.data_ptr(),
                              _build.sm_count(adj.device.index or 0))
    return {"max_abs_err": err, "variants_equal": True, "geometry": geo}


def cross_route(x0, xl, W, bias, route):
    """cross's kernel on the route the caller names, past the wrapper (the
    tensor route after its W split, as the wrapper launches them)."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.cross import ops
    B, d = x0.shape
    out = torch.empty(B, d, dtype=torch.float32, device=x0.device)
    split = None
    if route == ops.TENSOR:
        split = torch.empty(ops.split_words(d), dtype=torch.int32,
                            device=x0.device)
        _build.launch("cross_split", W.data_ptr(), d, split.data_ptr())
    _build.launch("cross", x0.data_ptr(), xl.data_ptr(), W.data_ptr(),
                  bias.data_ptr(), out.data_ptr(), B, d, route,
                  0 if split is None else split.data_ptr())
    return out


def check_cross(x0, xl, W, bias):
    """Both routes, each within rtol = atol = 2e-5 of the plain version,
    the reference's own tolerance for this kernel (tests/test_kernels.py):
    each element is a d-term f32 dot product that cuBLAS sums in another
    order, and the tensor route's 3xTF32 holds it to a few ulp of its
    terms.  The error reported is the larger of the two routes'; the
    wrapper's route is one of them."""
    import torch
    from repro_torch.kernels.cross import ops, ref
    out_p = ref.cross_layer_ref(x0, xl, W, bias)
    errs = {}
    for name, route in (("simt", ops.SIMT), ("tensor", ops.TENSOR)):
        out_k = cross_route(x0, xl, W, bias, route)
        torch.testing.assert_close(out_k, out_p, rtol=2e-5, atol=2e-5,
                                   msg=lambda m: f"cross {name}: {m}")
        errs[name] = float((out_k - out_p).abs().max())
    return {"max_abs_err": max(errs.values()),
            **{f"max_abs_err_{k}": v for k, v in errs.items()}}


def check_cross_split(W):
    """The W split bit-equal to its plain version, ``cross_split_ref``."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.cross import ops, ref
    d = W.shape[0]
    split = torch.empty(ops.split_words(d), dtype=torch.int32,
                        device=W.device)
    _build.launch("cross_split", W.data_ptr(), d, split.data_ptr())
    assert torch.equal(split, ref.cross_split_ref(W)), (
        "cross_split differs from its plain version")
    return {"max_abs_err": 0.0}


def check_embag(table, idx, wt):
    """Within rtol = atol = 1e-5 of the plain version, the reference's own
    tolerance for this kernel: an L-term f32 sum in another order."""
    import torch
    from repro_torch.kernels.embag import ops, ref
    out_k = ops.embedding_bag(table, idx, wt)
    ones = torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
    out_p = ref.embedding_bag_ref(table, idx, ones if wt is None else wt)
    torch.testing.assert_close(out_k, out_p, rtol=1e-5, atol=1e-5)
    return {"max_abs_err": float((out_k - out_p).abs().max())}


def check_flash(q, k, v, *, causal, q_offset=0, kv_len=None, chunk=None,
                ref_chunk=None, hold_plain=True):
    """The flash kernel against its plain version, ``chunked_attention``
    (in one chunk unless ``chunk`` is given: the chunk only sets the
    scan).  f32: within 1e-4 abs/rel (an f32 online softmax over the same
    keys in another order).  bf16: the kernel within 2e-2 abs/rel of
    ``chunked_attention`` run in f32 on the upcast inputs (both round the
    output and P to bf16, the kernel's tensor-core variant as the plain
    version does; the plain version also rounds its scores), and the
    plain version too where ``hold_plain``.  Elsewhere (llama4-maverick's
    layers: v of ~1.3 a head element, and early rows that average a few
    keys, meet the plain version's bf16-rounded scores) the kernel is
    held within 4e-2 of the plain version, the two 2e-2 legs together,
    and the plain version's own distance is reported, not held.  The
    error reported is the kernel's largest absolute difference from the
    f32 version, which scans ``ref_chunk`` keys at a time (default: the
    plain version's chunk), beside the plain version's and the count of
    its elements past 2e-2."""
    import torch
    from repro_torch.kernels.flash import ops, ref
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    c = k.shape[2] if chunk is None else chunk
    out_k = ops.attention(q, k, v, **kw)
    out_p = ref.chunked_attention(q, k, v, chunk=c, **kw)
    assert out_k.dtype == q.dtype and out_k.shape == q.shape
    if q.dtype == torch.float32:
        torch.testing.assert_close(out_k, out_p, rtol=1e-4, atol=1e-4)
        return {"max_abs_err": float((out_k - out_p).abs().max())}
    want = ref.chunked_attention(q.float(), k.float(), v.float(),
                                 chunk=ref_chunk or c, **kw)
    torch.testing.assert_close(out_k.float(), want, rtol=2e-2, atol=2e-2)
    if hold_plain:
        torch.testing.assert_close(out_p.float(), want, rtol=2e-2,
                                   atol=2e-2)
    else:
        torch.testing.assert_close(out_k.float(), out_p.float(), rtol=4e-2,
                                   atol=4e-2)
    plain = (out_p.float() - want).abs()
    return {"max_abs_err": float((out_k.float() - want).abs().max()),
            "plain_max_abs_err": float(plain.max()),
            "plain_past_2e-2": int((plain > 2e-2 + 2e-2 * want.abs())
                                   .sum()),
            "against_plain": float((out_k.float() - out_p.float()).abs()
                                   .max())}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def spd_inverse(g, n, d, device):
    import torch
    A = 0.3 * torch.randn(n, d, d, generator=g, device=device)
    M = torch.eye(d, device=device) + A @ A.transpose(1, 2)
    return torch.linalg.inv(M).contiguous()


def unit(x):
    import torch
    return x / torch.linalg.norm(x, dim=-1, keepdim=True)


def small_checks(dev):
    import torch
    from repro_torch.core import clustering
    from repro_torch.kernels.graph import ref as gref
    g = torch.Generator(device=dev).manual_seed(1234)

    n, d, K = 37, 19, 7
    w = 0.5 * torch.randn(n, d, generator=g, device=dev)
    Minv = spd_inverse(g, n, d, dev)
    ctx = unit(torch.randn(n, K, d, generator=g, device=dev)).contiguous()
    occ = torch.randint(0, 1000, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    log(f"small choose (n={n}, d={d}, K={K}): "
        f"{check_choose(w, Minv, ctx, occ, 0.3)}, both variants and both "
        f"ucb variants: {check_pick(w, Minv, ctx, occ, 0.3)}")

    nd, Kd, dd = 16, 12, 8
    ctx2 = torch.randn(nd, Kd, dd, generator=g, device=dev)
    ctx2[:, 5] = ctx2[:, 2]
    ctx2[:, 9] = ctx2[:, 2]
    w2 = torch.randn(nd, dd, generator=g, device=dev)
    eye = torch.eye(dd, device=dev).expand(nd, dd, dd).contiguous()
    ones = torch.ones(nd, dtype=torch.int32, device=dev)
    from repro_torch.kernels import _build
    from repro_torch.kernels.interact import ops as iops
    for variant in (iops.WARP_PER_USER, iops.REGISTER_TILE):
        choice, _ = choose_variant(w2, eye, ctx2, ones, 0.3, variant)
        assert not bool(((choice == 5) | (choice == 9)).any()), (
            f"choose variant {variant}: a duplicate beat its first copy")
    log(f"small choose duplicates: {check_choose(w2, eye, ctx2, ones, 0.3)}"
        f", both variants and both ucb variants: "
        f"{check_pick(w2, eye, ctx2, ones, 0.3)}")
    # the catalog path's shortlist width: K = k_short = 64, at 37 users
    # and at serving's 256 (a register-tile block per user); at d=32 the
    # warp variant needs 49,664 B of shared memory, past the 48 KB default
    for nk in (n, SERVE_BATCH):
        occ_k = torch.randint(0, 1000, (nk,), generator=g, device=dev,
                              dtype=torch.int32)
        for dk in (25, 32):
            Mk = spd_inverse(g, nk, dk, dev)
            wk = 0.5 * torch.randn(nk, dk, generator=g, device=dev)
            ck = unit(torch.randn(nk, K_SHORT, dk, generator=g,
                                  device=dev)).contiguous()
            geo = iops.geometry(nk, K_SHORT, dk,
                                _build.sm_count(dev.index or 0))
            log(f"small choose (n={nk}, d={dk}, K={K_SHORT}, geometry "
                f"{geo}): "
                f"{check_choose(wk, Mk, ck, occ_k, 0.3)}, both variants and "
                f"both ucb variants: {check_pick(wk, Mk, ck, occ_k, 0.3)}")

    log(f"small ucb (n={n}, d={d}, K={K}): "
        f"{check_ucb(w, Minv, ctx, occ, 0.3)}")
    log(f"small ucb duplicates: {check_ucb(w2, eye, ctx2, ones, 0.3)}")
    from repro_torch.kernels.ucb import ops as uops
    s_dup = uops.ucb_scores(w2, eye, ctx2, ones, 0.3)
    assert torch.equal(s_dup[:, 5], s_dup[:, 2]), "ucb: duplicates differ"
    log(f"small ucb n=1 row view (d={d}, K={K}): " + str(check_ucb(
        w[5:6], Minv[5:6], ctx[5:6], occ[5:6], 0.3)))

    b = torch.randn(n, d, generator=g, device=dev)
    x = torch.randn(n, d, generator=g, device=dev)
    r = torch.rand(n, generator=g, device=dev)
    mask = torch.rand(n, generator=g, device=dev) < 0.7
    log(f"small rank1 (n={n}, d={d}): {check_rank1(Minv, b, x, r, mask)}")
    M = torch.linalg.inv(Minv).contiguous()
    log(f"small rank1_update (n={n}, d={d}): "
        f"{check_rank1_mful(M, Minv, b, x, r, mask)}")
    log(f"small rank1_update n=1 row view (d={d}): "
        f"{check_rank1_row_view(M, Minv, b, x[5:6], r[5:6], 5)}")
    # the two variants: at CLUB's d, one user past the block-per-user
    # limit, so that the whole state takes a warp per user
    from repro_torch.kernels.rank1 import ops as rops
    nv, dv = rops.BLOCK_PER_USER_PER_SM * _build.sm_count(dev.index or 0) \
        + 1, 25
    Minv_v = spd_inverse(g, nv, dv, dev)
    M_v = torch.linalg.inv(Minv_v).contiguous()
    b_v = torch.randn(nv, dv, generator=g, device=dev)
    x_v = unit(torch.randn(nv, dv, generator=g, device=dev))
    r_v = torch.rand(nv, generator=g, device=dev)
    mask_v = torch.rand(nv, generator=g, device=dev) < 0.7
    mask_v[-1] = True
    log(f"small rank1 variants, n=1 row view against n={nv} (d={dv}): "
        f"{check_rank1_variants(M_v, Minv_v, b_v, x_v[7:8], r_v[7:8], 7)}")
    log(f"small rank1 variants at n={nv - 1} and n={nv} (d={dv}): "
        f"{check_rank1_threshold(M_v, Minv_v, b_v, x_v, r_v, mask_v)}")
    # ucb's two variants on the same state at CLUB's K; user 7's row view
    # starts 7 x 625 floats in, off a 16-byte boundary
    w_v = 0.5 * torch.randn(nv, dv, generator=g, device=dev)
    ctx_v = unit(torch.randn(nv, 20, dv, generator=g, device=dev))
    occ_v = torch.randint(0, 1000, (nv,), generator=g, device=dev,
                          dtype=torch.int32)
    log(f"small ucb variants at n={nv - 1} and n={nv}, and user 7's row "
        f"view (d={dv}, K=20): "
        f"{check_ucb_variants(w_v, Minv_v, ctx_v.contiguous(), occ_v, 0.3, 7)}")

    ng = 33
    dense = torch.rand(ng, ng, generator=g, device=dev) < 0.7
    dense = torch.triu(dense, 1)
    dense = dense | dense.T
    adj = gref.pack_bits(dense)
    v = torch.randn(ng, d, generator=g, device=dev)
    cb = clustering.cb_width(torch.randint(0, 100, (ng,), generator=g,
                                           device=dev))
    log(f"small prune (n={ng}, d={d}): "
        f"{check_prune(adj, v, cb, v, cb, 1.2)}")
    # ragged rows and words, one and several slabs of features, dense and
    # sparse words: within the plain version's near-tie band; both
    # branches bit-equal where every warp tile fits the walk (p = 0.02,
    # and 16 bits in every row's 128 columns: 256 a tile, the cap)
    for R, C, dp in ((200, 300, 17), (130, 1000, 40), (257, 64, 5),
                     (129, 33, 16), (300, 70, 1), (140, 130, 33)):
        v_r = torch.randn(R, dp, generator=g, device=dev)
        v_c = torch.randn(C, dp, generator=g, device=dev)
        cb_r = 0.3 * torch.rand(R, generator=g, device=dev) + 0.1
        cb_c = 0.3 * torch.rand(C, generator=g, device=dev) + 0.1
        gam = 2.0 * math.sqrt(dp)
        for p in (0.7, 0.02):
            a = random_adj(g, R, C, p, dev)
            log(f"small prune (R={R}, C={C}, d={dp}, p={p}): "
                f"{check_prune(a, v_r, cb_r, v_c, cb_c, gam)}")
            if p < 0.1:
                log(f"  branches, most bits in a warp tile: "
                    f"{check_prune_branches(a, v_r, cb_r, v_c, cb_c, gam)}")
        a = tile_adj(g, R, C, 16, dev)
        log(f"small prune (R={R}, C={C}, d={dp}, 16 bits a row's 128 "
            f"columns): {check_prune(a, v_r, cb_r, v_c, cb_c, gam)}, "
            f"branches, most bits in a warp tile: "
            f"{check_prune_branches(a, v_r, cb_r, v_c, cb_c, gam)}")
    # equal vectors (distance 0, below sqrtf's fast range) and widths that
    # put pairs on the threshold: the near-tie band on the full graph
    # (dense); both branches equal on a band of it that holds the
    # diagonal, the equal pairs (i, i +- 200) and the pair (0, 1) on the
    # threshold, ~100 bits a warp tile
    nt, dt = 600, 25
    v_t = unit(torch.randn(nt, dt, generator=g, device=dev))
    v_t[300:350] = v_t[100:150]
    cb_t = torch.full((nt,), 0.3, device=dev)
    gam_t = float(torch.linalg.norm(v_t[0] - v_t[1])) / 0.6
    full_t = gref.init_packed_adj(nt, nt, device=dev)
    ii = torch.arange(nt, device=dev)
    band = (ii[None, :] - ii[:, None]) % 20 == 0
    band[0, 1] = band[1, 0] = True
    band_t = gref.pack_bits(band)
    log(f"small prune on the threshold (n={nt}, d={dt}): "
        f"{check_prune(full_t, v_t, cb_t, v_t, cb_t, gam_t)}; on its band: "
        f"{check_prune(band_t, v_t, cb_t, v_t, cb_t, gam_t)}, branches, "
        f"most bits in a warp tile: "
        f"{check_prune_branches(band_t, v_t, cb_t, v_t, cb_t, gam_t)}")
    log(f"sqrt_rn against sqrtf on every non-negative float: "
        f"{sqrt_check()} mismatches")
    sparse = torch.rand(ng, ng, generator=g, device=dev) < 0.08
    sparse = torch.triu(sparse, 1)
    labels = torch.randperm(ng, generator=g, device=dev).to(torch.int32)
    log(f"small cc_hop (n={ng}): "
        f"{check_cc_hop(gref.pack_bits(sparse | sparse.T), labels, labels)}")
    small_clone_checks(g, dev)
    small_cc_hop_checks(g, dev)
    small_topk_checks(g, dev, n, d, w, Minv, occ)
    small_quant_checks(g, dev, n, d, Minv, occ)
    small_filter_checks(dev)
    small_minv_checks(g, dev)
    small_recsys_checks(g, dev)
    small_flash_checks(g, dev)


def small_clone_checks(g, dev):
    """The kernels of DistCLUB's path at the paper clones' shapes (phase
    4d): at n = 943, 1816, 1888 and 5045, K = 20 and d = 5, 19 and 25,
    choose's two variants forced (``check_choose``, ``check_pick``) on
    slates gathered from a 2047-item table, each with a duplicate after
    its first copy and, in half the rows, that item the best
    (``check_duplicates``); rank1_update_inv; prune on the full graph and
    on a sparse one, both branches forced on the sparse one."""
    import torch
    from repro_torch.core import clustering
    from repro_torch.kernels.graph import ref as gref
    K = 20
    for n in CLONE_USERS:
        occ = torch.randint(0, 1000, (n,), generator=g, device=dev,
                            dtype=torch.int32)
        ids = torch.randint(1, 2048, (n, K), generator=g, device=dev,
                            dtype=torch.int32)
        ids[:, 11] = ids[:, 4]
        full = gref.init_packed_adj(n, n, device=dev)
        sparse = random_adj(g, n, n, 0.02, dev)
        cb = clustering.cb_width(occ)
        for d in (5, 19, 25):
            table = unit(torch.randn(2048, d, generator=g, device=dev))
            ctx = table[ids.long()]
            Minv = spd_inverse(g, n, d, dev)
            w = 0.5 * torch.randn(n, d, generator=g, device=dev)
            w[::2] = 4.0 * table[ids[::2, 4].long()]
            log(f"small choose at a clone's shape (n={n}, d={d}, K={K}): "
                f"{check_choose(w, Minv, ctx, occ, 0.03)}, both variants "
                f"and both ucb variants: "
                f"{check_pick(w, Minv, ctx, occ, 0.03)}, rows that picked "
                f"a duplicated item, never after its first copy: "
                f"{check_duplicates(w, Minv, ids, table, occ, 0.03)}")
            b = torch.randn(n, d, generator=g, device=dev)
            x = ctx[:, 3].contiguous()
            r = (torch.rand(n, generator=g, device=dev) < 0.5).float()
            mask = torch.rand(n, generator=g, device=dev) < 0.7
            log(f"small rank1 at a clone's shape (n={n}, d={d}): "
                f"{check_rank1(Minv, b, x, r, mask)}")
            v = torch.randn(n, d, generator=g, device=dev)
            gam = 0.5 * math.sqrt(d)
            log(f"small prune at a clone's shape (n={n}, W={full.shape[1]}, "
                f"d={d}): full {check_prune(full, v, cb, v, cb, gam)}, "
                f"p=0.02 {check_prune(sparse, v, cb, v, cb, gam)}, "
                f"branches, most bits in a warp tile: "
                f"{check_prune_branches(sparse, v, cb, v, cb, gam)}")


def small_cc_hop_checks(g, dev):
    """cc_hop by ``check_cc_hop`` (the plain version, both thresholds
    forced and the warp-per-row kernel) at the paper datasets' row
    lengths (n = 943, 1816, 1888, 5045, 20000: W = 30, 57, 59, 158, 625,
    8- and 4-byte loads) and the main path's (20480: W = 640, 16-byte loads),
    each on a sparse graph, a half-dense one with every third row empty
    and the full one;
    then row views at offsets off a 16-byte boundary, a [R, 640] view of a
    flat buffer 4 bytes off one, and random words (bits past C set, ~16 a
    word) against labels_j shorter than 32 W, 4 bytes off a 16-byte
    boundary."""
    import torch
    from repro_torch.kernels.graph import ops as gops
    from repro_torch.kernels.graph import ref as gref
    for n in (943, 1816, 1888, 5045, 20000, 20480):
        labels = torch.randperm(n, generator=g, device=dev).to(torch.int32)
        half = random_adj(g, n, n, 0.5, dev)
        half[::3] = 0
        for name, a in (("p=0.002", random_adj(g, n, n, 0.002, dev)),
                        ("p=0.5, every third row empty", half),
                        ("full", gref.init_packed_adj(n, n, device=dev))):
            log(f"small cc_hop (n={n}, W={a.shape[1]}, {name}): "
                f"{check_cc_hop(a, labels, labels)}")
        W = half.shape[1]
        r0 = 1 if (W * 4) % 16 else 0      # a view off a 16-byte boundary
        if r0:
            view = half[r0:r0 + n // 2]
            res = check_cc_hop(view, labels[r0:r0 + n // 2], labels)
            assert res["geometry"][0] < 4, res
            log(f"small cc_hop rows {r0}..{r0 + n // 2} of n={n} (offset "
                f"mod 16: {view.data_ptr() % 16}): {res}")
    # the main path's rows at a 4-byte offset: 4-byte loads
    n = 20480
    W = gref.packed_words(n)
    labels = torch.randperm(n, generator=g, device=dev).to(torch.int32)
    buf = torch.empty(n * W + 1, dtype=torch.int32, device=dev)
    flat = buf[1:].view(n, W)
    flat.copy_(random_adj(g, n, n, 0.01, dev))
    res = check_cc_hop(flat, labels, labels)
    assert res["geometry"][0] == 1, res
    log(f"small cc_hop (n={n}, a flat buffer's view 4 bytes off a 16-byte "
        f"boundary, p=0.01): {res}")
    # random words, bits past C included, against a shorter labels_j off a
    # 16-byte boundary (the dense branch's 4-byte loads); a row shard
    for R, C in ((1888, 1883), (700, 20000)):
        W = gops.packed_words(C)
        words = torch.randint(-2**31, 2**31, (R, W), generator=g,
                              device=dev, dtype=torch.int64).to(torch.int32)
        lbuf = torch.randperm(C + 1, generator=g, device=dev).to(torch.int32)
        lj = lbuf[1:]
        ls = torch.randperm(R, generator=g, device=dev).to(torch.int32)
        res = check_cc_hop(words, ls, lj)
        log(f"small cc_hop (R={R}, C={C}, W={W}, random words, labels_j "
            f"offset mod 16 {lj.data_ptr() % 16}): {res}")


def small_topk_checks(g, dev, n, d, w, Minv, occ):
    """Both top-K kernels on ragged shapes: copies of one item at chunk
    edges and in other chunks (they must tie bit-exactly, smaller id
    first), an all-dead 512-item chunk, N < k_short, the d=64 / k=128
    limits, and the pruned kernel on a region catalog, where it must skip
    and stay bit-equal to the unpruned kernel."""
    import torch
    from repro_torch.core import catalog, itemclub
    from repro_torch.kernels.topk import ops
    N, k = 1300, 13
    items = unit(torch.randn(N, d, generator=g, device=dev))
    copies = [3, 511, 512, 1024, 1299]
    items[copies] = items[3].clone()
    live = (torch.rand(N, generator=g, device=dev) < 0.9).float()
    live[512:1024] = 0.0                 # one whole chunk dead ...
    live[[3, 511, 1024, 1299]] = 1.0     # ... 512 included
    live[512] = 0.0
    w_dup = w.clone()
    w_dup[:8] = 3.0 * items[3]           # 8 users rank the copies first
    log(f"small topk (n={n}, d={d}, N={N}, k={k}): "
        f"{check_topk(w_dup, Minv, occ, items, live, 0.3, k)}")
    _, ids = ops.topk(w_dup, Minv, occ, items, live, 0.3, k)
    assert bool((ids[:8, :4] == torch.tensor(
        [3, 511, 1024, 1299], device=dev, dtype=torch.int32)).all()), (
        "topk: copies of one item do not tie in id order")
    log(f"small topk N < k (N=9, k={k}): "
        f"{check_topk(w, Minv, occ, items[:9], live[:9], 0.3, k)}")
    # each side of the features-in-registers buckets (d <= 32: 4 items a
    # thread; above: 1) and of the blocks of 8 steps
    for dd in (1, 8, 24, 31, 32, 33, 48):
        w_d = 0.5 * torch.randn(n, dd, generator=g, device=dev)
        it_d = unit(torch.randn(2000, dd, generator=g, device=dev))
        lv_d = (torch.rand(2000, generator=g, device=dev) < 0.9).float()
        log(f"small topk d={dd} (n={n}, N=2000, k=64): " + str(check_topk(
            w_d, spd_inverse(g, n, dd, dev), occ, it_d, lv_d, 0.3, 64)))
    n64 = 20
    log("small topk d=64 k=128: " + str(check_topk(
        torch.randn(n64, 64, generator=g, device=dev),
        spd_inverse(g, n64, 64, dev), occ[:n64],
        unit(torch.randn(3000, 64, generator=g, device=dev)),
        torch.ones(3000, device=dev), 0.3, 128)))

    # the pruned kernel on a region catalog, bit-equal to topk, where each
    # of its splits walks 8 tiles of 128 items: one chunk after its first
    # tile, which must give it floors to skip with
    R, N2 = 8, 8192
    cent = unit(torch.randn(R, d, generator=g, device=dev))
    reg = torch.randint(0, R, (N2,), generator=g, device=dev)
    emb = unit(cent[reg] + 0.01 * torch.randn(N2, d, generator=g,
                                              device=dev))
    cat = catalog.make_catalog(emb)
    clusters = itemclub.build_clusters(cat, tile_items=128, n_anchors=256)
    w_reg = 0.8 * cent[torch.randint(0, R, (n,), generator=g, device=dev)]
    res = check_topk_pruned(w_reg, Minv, occ, cat, clusters, 0.3, k)
    log(f"small topk_pruned (n={n}, d={d}, N={N2}, {R} regions, tile 128, "
        f"clusters={int(clusters.n_clusters)}): {res}")
    assert res["skip"] > 0, "topk_pruned skipped no tile"

    # on region catalogs whose tiles gather into chunks (128: 8 a
    # 1024-row chunk; 384: 2, not dividing it; 512: 2), fill one (1024)
    # and stream in slices (2048), for 256 users (32 groups, several
    # chunks a split); then at the shared-memory corner, d = 32 and 64
    # with k = 128
    N2 = 12288
    for dk, nk, kk, tiles in ((d, 256, k, (128, 384, 512, 1024, 2048)),
                              (32, 20, 128, (512,)), (64, 20, 128, (512,))):
        cent = unit(torch.randn(R, dk, generator=g, device=dev))
        reg = torch.randint(0, R, (N2,), generator=g, device=dev)
        emb = unit(cent[reg] + 0.01 * torch.randn(N2, dk, generator=g,
                                                  device=dev))
        cat = catalog.make_catalog(emb)
        w_reg = 0.8 * cent[torch.randint(0, R, (nk,), generator=g,
                                         device=dev)]
        M_reg = spd_inverse(g, nk, dk, dev)
        occ_reg = torch.randint(0, 1000, (nk,), generator=g, device=dev,
                                dtype=torch.int32)
        for tile in tiles:
            clusters = itemclub.build_clusters(cat, tile_items=tile,
                                               n_anchors=256)
            res = check_topk_pruned(w_reg, M_reg, occ_reg, cat, clusters,
                                    0.3, kk)
            log(f"small topk_pruned (n={nk}, d={dk}, N={N2}, {R} regions, "
                f"tile {tile}, k={kk}, "
                f"clusters={int(clusters.n_clusters)}): {res}")
            if tile == 128:
                assert res["skip"] > 0, "topk_pruned skipped no tile"


def small_quant_checks(g, dev, n, d, Minv, occ):
    """The reduced-precision variants on ragged shapes: the bf16 rank-1
    update at the clones' shapes and on both sides of the block-per-user
    limit (its two variants bit-equal); topk over bf16 and int8 banks at
    d = 1 ... 64 (k = 128 at 64), over rows whose byte range starts off a
    16-byte boundary (a view one row in) and over N < k; topk_pruned over
    quantized region catalogs at tiles 128 (8 a chunk), 384 (not dividing
    a chunk) and 2048 (slices), bit-equal to topk, skipping at 128."""
    import torch
    from repro_torch.core import catalog, itemclub
    from repro_torch.kernels import _build
    sms = _build.sm_count(dev.index or 0)
    for nr, dr in ((943, 19), (5045, 5), (2 * 2 * sms + 1, 25), (37, 33),
                   (64, 64)):
        x = unit(torch.randn(nr, dr, generator=g, device=dev))
        r = (torch.rand(nr, generator=g, device=dev) < 0.5).float()
        mask = torch.rand(nr, generator=g, device=dev) < 0.8
        Mb = spd_inverse(g, nr, dr, dev).bfloat16()
        b = torch.randn(nr, dr, generator=g, device=dev)
        log(f"small rank1_update_inv bf16 (n={nr}, d={dr}): "
            f"{check_rank1_bf16(Mb, b, x, r, mask)}")
        if nr > 2 * sms and dr <= 32:
            log(f"small rank1_update_inv bf16 variants (d={dr}): "
                f"{check_rank1_bf16_variants(Mb, b, x, r, mask)}")
    for prec in PRECISIONS:
        for dd, kk, N in ((1, 13, 2000), (5, 13, 2001), (19, 64, 2003),
                          (25, 64, 2047), (32, 64, 2049), (33, 64, 1999),
                          (64, 128, 3001)):
            w_d = 0.5 * torch.randn(n, dd, generator=g, device=dev)
            cat = catalog.make_catalog(
                unit(torch.randn(N, dd, generator=g, device=dev)),
                precision=prec)
            bank = cat.serving
            lv = (torch.rand(N, generator=g, device=dev) < 0.9).float()
            sc = bank.scale if prec == "int8" else None
            M_d = spd_inverse(g, n, dd, dev)
            res = check_topk_quant(w_d, M_d, occ, bank.emb, lv, sc, 0.3, kk)
            # one row in: the byte range starts d or 2 d bytes past the
            # allocation's alignment
            res1 = check_topk_quant(w_d, M_d, occ, bank.emb[1:], lv[1:],
                                    None if sc is None else sc[1:], 0.3, kk)
            res9 = check_topk_quant(w_d, M_d, occ, bank.emb[:9], lv[:9],
                                    None if sc is None else sc[:9], 0.3, kk)
            log(f"small topk {prec} d={dd} (n={n}, N={N}, k={kk}): {res}; "
                f"one row in: {res1}; N=9: {res9}")
        R, N2 = 8, 12288
        for dk, nk, kk, tiles in ((d, 256, 13, (128, 384, 2048)),
                                  (64, 20, 128, (512,))):
            cent = unit(torch.randn(R, dk, generator=g, device=dev))
            reg = torch.randint(0, R, (N2,), generator=g, device=dev)
            cat = catalog.make_catalog(
                unit(cent[reg] + 0.01 * torch.randn(N2, dk, generator=g,
                                                    device=dev)),
                precision=prec)
            w_reg = 0.8 * cent[torch.randint(0, R, (nk,), generator=g,
                                             device=dev)]
            M_reg = spd_inverse(g, nk, dk, dev)
            occ_reg = torch.randint(0, 1000, (nk,), generator=g, device=dev,
                                    dtype=torch.int32)
            for tile in tiles:
                clusters = itemclub.build_clusters(cat, tile_items=tile,
                                                   n_anchors=256)
                res = check_topk_pruned(w_reg, M_reg, occ_reg, cat,
                                        clusters, 0.3, kk)
                log(f"small topk_pruned {prec} (n={nk}, d={dk}, N={N2}, "
                    f"tile {tile}, k={kk}): {res}")
                if tile == 128:
                    assert res["skip"] > 0, "topk_pruned skipped no tile"


def off_by_one(t):
    """A copy of ``t`` whose data starts one element (2 bytes for bf16)
    past a 16-byte boundary: a view into a flat buffer one longer."""
    import torch
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


def small_minv_checks(g, dev):
    """The bf16-Minv variants on ragged shapes, each bit-equal to its f32
    kernel on the widened Minv and within its band of the plain version:
    choose and ucb at d = 1 ... 64 (the register tile and a block per user
    up to d = 32, a warp per user above), K past the tile's threads a
    user (256, 257), users on both sides of ucb's block-per-user limit
    (2 x SMs, one more), serving's 256 x 64, and on Minv rows off a
    16-byte boundary (a view one row in; a buffer one element in); the
    M-ful update at the clones' shapes, on both sides of its
    block-per-user limit and at d = 33 and 64, on a buffer one element
    in, through CLUB's n = 1 row views at an odd user, its two variants
    bit-equal; topk over f32, bf16 and int8 items at d = 1 ... 64, one
    row in and N < k; topk_pruned over each kind's region catalog at
    tiles 128 (skipping) and 2048 (slices), and at d = 64, k = 128; and an
    f16 Minv refused by every wrapper with a ``TypeError``, nothing
    launched."""
    import torch
    from repro_torch.core import catalog, itemclub
    from repro_torch.kernels import _build
    from repro_torch.kernels.interact import ops as iops
    from repro_torch.kernels.rank1 import ops as rops
    from repro_torch.kernels.topk import ops as tops
    from repro_torch.kernels.ucb import ops as uops
    t_start = time.perf_counter()
    sms = _build.sm_count(dev.index or 0)
    nu = 2 * sms
    for n, K, d in ((37, 20, 1), (37, 20, 5), (37, 7, 19), (37, 20, 25),
                    (37, 20, 31), (37, 64, 32), (37, 20, 33), (20, 20, 64),
                    (5, 256, 32), (5, 257, 32), (nu, 20, 25),
                    (nu + 1, 20, 25), (SERVE_BATCH, K_SHORT, 25)):
        w = 0.5 * torch.randn(n + 1, d, generator=g, device=dev)
        Mb = spd_inverse(g, n + 1, d, dev).bfloat16()
        ctx = unit(torch.randn(n + 1, K, d, generator=g, device=dev))
        occ = torch.randint(0, 1000, (n + 1,), generator=g, device=dev,
                            dtype=torch.int32)
        res = check_choose_bf16(w[:n], Mb[:n], ctx[:n].contiguous(),
                                occ[:n], 0.3)
        # one row in: 2 d^2 bytes past the allocation (2 mod 16 at
        # d = 19, 25); and a buffer one element in
        res1 = check_choose_bf16(w[1:], Mb[1:], ctx[1:].contiguous(),
                                 occ[1:], 0.3)
        res2 = check_choose_bf16(w[:n], off_by_one(Mb[:n]),
                                 ctx[:n].contiguous(), occ[:n], 0.3)
        log(f"small choose/ucb bf16 Minv (n={n}, K={K}, d={d}): {res}; one "
            f"row in: {res1}; one element in: {res2}")
    for nr, dr in ((943, 19), (5045, 5), (nu, 25), (nu + 1, 25), (37, 33),
                   (64, 64)):
        Minv = spd_inverse(g, nr, dr, dev)
        Mb = Minv.bfloat16()
        M = torch.linalg.inv(Mb.float()).contiguous()
        b = torch.randn(nr, dr, generator=g, device=dev)
        x = unit(torch.randn(nr, dr, generator=g, device=dev))
        r = (torch.rand(nr, generator=g, device=dev) < 0.5).float()
        mask = torch.rand(nr, generator=g, device=dev) < 0.8
        res = check_rank1_mful_bf16(M, Mb, b, x, r, mask)
        res1 = check_rank1_mful_bf16(M, off_by_one(Mb), b, x, r, mask)
        log(f"small rank1_update bf16 (n={nr}, d={dr}): {res}; one element "
            f"in: {res1}")
        if dr <= 32:     # CLUB's row view: a block per user
            u = 7
            live = torch.ones(1, dtype=torch.bool, device=dev)
            rows = (M.clone(), Mb.clone(), b.clone())
            before = tuple(t[u:u + 1].clone() for t in rows)
            rops.rank1_update(*(t[u:u + 1] for t in rows), x[u:u + 1],
                              r[u:u + 1], live)
            res = hold_rank1_bf16(before, tuple(t[u:u + 1] for t in rows),
                                  x[u:u + 1], r[u:u + 1], live)
            keep = torch.arange(nr, device=dev) != u
            assert all(torch.equal(a[keep], t[keep])
                       for a, t in zip(rows, (M, Mb, b))), (
                "rank1_update_bf16: the row view wrote other rows")
            log(f"small rank1_update bf16 n=1 row view at user {u} (offset "
                f"mod 16: {Mb[u:u + 1].data_ptr() % 16}): {res}")
            if nr > nu:  # the whole state: a warp per user
                res = check_rank1_variants(M, Mb, b, x[u:u + 1], r[u:u + 1],
                                           u)
                log(f"small rank1 bf16 variants, the row view against "
                    f"n={nr}: {res}")
    n = 37
    occ = torch.randint(0, 1000, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    for prec in ("f32", *PRECISIONS):
        for dd, kk, N in ((1, 13, 2000), (19, 64, 2003), (25, 64, 2047),
                          (32, 64, 2049), (33, 64, 1999), (64, 128, 3001)):
            w_d = 0.5 * torch.randn(n, dd, generator=g, device=dev)
            bank = catalog.make_catalog(
                unit(torch.randn(N, dd, generator=g, device=dev)),
                precision=prec).serving
            lv = (torch.rand(N, generator=g, device=dev) < 0.9).float()
            sc = bank.scale if prec == "int8" else None
            Mb = spd_inverse(g, n, dd, dev).bfloat16()
            res = check_topk_minv_bf16(w_d, Mb, occ, bank.emb, lv, sc, 0.3,
                                       kk)
            res1 = check_topk_minv_bf16(
                w_d, Mb, occ, bank.emb[1:], lv[1:],
                None if sc is None else sc[1:], 0.3, kk)
            res9 = check_topk_minv_bf16(
                w_d, Mb, occ, bank.emb[:9], lv[:9],
                None if sc is None else sc[:9], 0.3, kk)
            log(f"small topk bf16 Minv, {prec} items d={dd} (n={n}, N={N}, "
                f"k={kk}): {res}; one row in: {res1}; N=9: {res9}")
        R, N2 = 8, 12288
        for dk, nk, kk, tiles in ((25, 256, 13, (128, 2048)),
                                  (64, 20, 128, (512,))):
            cent = unit(torch.randn(R, dk, generator=g, device=dev))
            reg = torch.randint(0, R, (N2,), generator=g, device=dev)
            cat = catalog.make_catalog(
                unit(cent[reg] + 0.01 * torch.randn(N2, dk, generator=g,
                                                    device=dev)),
                precision=prec)
            w_reg = 0.8 * cent[torch.randint(0, R, (nk,), generator=g,
                                             device=dev)]
            Mb = spd_inverse(g, nk, dk, dev).bfloat16()
            occ_reg = torch.randint(0, 1000, (nk,), generator=g, device=dev,
                                    dtype=torch.int32)
            for tile in tiles:
                clusters = itemclub.build_clusters(cat, tile_items=tile,
                                                   n_anchors=256)
                res = check_topk_pruned_minv_bf16(w_reg, Mb, occ_reg, cat,
                                                  clusters, 0.3, kk)
                log(f"small topk_pruned bf16 Minv, {prec} items (n={nk}, "
                    f"d={dk}, N={N2}, tile {tile}, k={kk}): {res}")
                if tile == 128:
                    assert res["skip"] > 0, "topk_pruned skipped no tile"
    n, K, d, N = 8, 5, 4, 64
    w = torch.randn(n, d, generator=g, device=dev)
    Mh = spd_inverse(g, n, d, dev).half()
    ctx = unit(torch.randn(n, K, d, generator=g, device=dev))
    occ = torch.ones(n, dtype=torch.int32, device=dev)
    x, r = ctx[:, 0].contiguous(), torch.ones(n, device=dev)
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    items = unit(torch.randn(N, d, generator=g, device=dev))
    live = torch.ones(N, device=dev)
    ids = torch.arange(N, dtype=torch.int32, device=dev)
    tb = torch.zeros(n, 4, device=dev)
    M, b = torch.eye(d, device=dev).repeat(n, 1, 1), torch.zeros_like(w)
    before = dict(_build.LAUNCHES)
    refused = []
    for name, call in (
            ("choose", lambda: iops.choose(w, Mh, ctx, occ, 0.3)),
            ("ucb_scores", lambda: uops.ucb_scores(w, Mh, ctx, occ, 0.3)),
            ("rank1_update", lambda: rops.rank1_update(M, Mh, b, x, r,
                                                       mask)),
            ("rank1_update_inv", lambda: rops.rank1_update_inv(Mh, b, x, r,
                                                               mask)),
            ("topk", lambda: tops.topk(w, Mh, occ, items, live, 0.3, 8)),
            ("topk_pruned", lambda: tops.topk_pruned(
                w, Mh, occ, items, live, ids, 0.3, 8, tb))):
        try:
            call()
        except TypeError:
            refused.append(name)
    torch.cuda.synchronize()
    assert len(refused) == 6 and _build.LAUNCHES == before, (
        f"an f16 Minv: only {refused} refused it")
    log(f"small f16 Minv: refused with TypeError by {refused}, nothing "
        f"launched")
    log(f"small_minv_checks: {time.perf_counter() - t_start} s")


def small_recsys_checks(g, dev):
    """cross on ragged shapes, both routes (the SIMT route's two tile
    shapes: B=5000 at d=429 takes the 128x64 tiles), and the W split
    bit-equal to its plain version; embedding_bag at the reference's test
    shapes, then with pad slots, ids out of range, no weights and D=6 (the
    4-byte path)."""
    import torch
    for B, d in ((16, 16), (37, 24), (100, 64), (37, 429), (5000, 429)):
        x0 = torch.randn(B, d, generator=g, device=dev)
        xl = torch.randn(B, d, generator=g, device=dev)
        W = torch.randn(d, d, generator=g, device=dev) / math.sqrt(d)
        bias = torch.randn(d, generator=g, device=dev)
        log(f"small cross (B={B}, d={d}): {check_cross(x0, xl, W, bias)}; "
            f"W split: {check_cross_split(W)}")
    for V, D, B, L in ((50, 8, 4, 3), (1000, 64, 16, 10), (128, 128, 8, 1),
                       (77, 6, 33, 7)):
        table = torch.randn(V, D, generator=g, device=dev)
        idx = torch.randint(0, V, (B, L), generator=g, device=dev,
                            dtype=torch.int32)
        wt = torch.rand(B, L, generator=g, device=dev)
        log(f"small embedding_bag (V={V}, D={D}, B={B}, L={L}): "
            f"{check_embag(table, idx, wt)}")
        odd = torch.randint(-V - 9, V + 9, (B, L), generator=g, device=dev,
                            dtype=torch.int32)
        wt[:, L // 2:] = 0.0
        log(f"  pads, ids out of range: {check_embag(table, odd, wt)}; "
            f"no weights: {check_embag(table, odd, None)}")
    # the kernel's step edges (a step covers 8 S slots: 64 at D=16) and
    # each lane geometry, with pads and ids out of range; then a table 4
    # bytes off a 16-byte boundary (the 4-byte path at D=16)
    from repro_torch.kernels.embag import ops as eops
    V, B = 300, 37
    for D in (8, 16, 25, 129):
        for L in (1, 31, 32, 33, 100):
            table = torch.randn(V, D, generator=g, device=dev)
            odd = torch.randint(-V - 9, V + 9, (B, L), generator=g,
                                device=dev, dtype=torch.int32)
            wt = torch.rand(B, L, generator=g, device=dev)
            wt[torch.rand(B, L, generator=g, device=dev) < 0.2] = 0.0
            log(f"small embedding_bag (D={D}, L={L}, "
                f"{eops.launch_geometry(D, B, True)}): "
                f"{check_embag(table, odd, wt)}")
    D, L = 16, 50
    table = torch.randn(V * D + 1, generator=g, device=dev)[1:].view(V, D)
    assert table.data_ptr() % 16 == 4
    idx = torch.randint(0, V, (B, L), generator=g, device=dev,
                        dtype=torch.int32)
    wt = torch.rand(B, L, generator=g, device=dev)
    log(f"small embedding_bag, table 4 bytes off (D={D}, L={L}, "
        f"{eops.launch_geometry(D, B, False)}): "
        f"{check_embag(table, idx, wt)}")


def small_flash_checks(g, dev):
    """flash on ragged shapes, f32 and bf16: Sq and Skv off the 64-key
    tile, Sq = 1, GQA groups 1, 3, 4 and 8 (MQA), causal and
    bidirectional, q_offset > 0, kv_len < Skv, rows that see no key
    (q_offset < 0), Dh 32, 64, 128 and 256.  In bf16 the cases reach the
    split-KV decode variant at its edges (kv_len off the split, below one
    split, Sq 2-4 at group 4: 8 and 16 rows) and the wgmma prefill
    variant at its (Sq off the 128-row tile and off its positions, Dh
    32, 64 and 128, group 3)."""
    import torch
    cases = [  # B, Hq, Hkv, Sq, Skv, Dh, causal, q_offset, kv_len
        (2, 4, 4, 77, 77, 64, True, 0, None),
        (1, 8, 2, 130, 200, 32, False, 0, None),
        (2, 8, 1, 45, 300, 128, True, 255, None),
        (3, 32, 8, 1, 1000, 128, True, 700, 701),
        (1, 4, 1, 1, 129, 64, False, 0, 100),
        (2, 16, 2, 100, 260, 128, True, 150, 250),
        (1, 2, 2, 33, 50, 256, True, 17, None),
        (1, 4, 1, 10, 64, 32, True, -5, None),
        # split-KV decode: kv_len off the split (8 splits of 128), below
        # one split, Sq 2 and 4 at group 4, group 8, a row before key 0
        (2, 32, 8, 1, 3000, 128, True, 1000, 1001),
        (2, 8, 2, 1, 512, 64, True, 40, 41),
        (2, 16, 4, 2, 300, 128, True, 200, 202),
        (1, 8, 2, 4, 257, 64, True, 250, 254),
        (2, 8, 1, 1, 700, 128, True, 600, 650),
        (1, 4, 1, 3, 64, 128, True, -1, None),
        # wgmma prefill: Sq off the 128-row tile and off the 32 positions
        # a tile holds at group 4, Dh 64, group 3 (42 positions a tile)
        (2, 32, 8, 200, 200, 128, True, 0, None),
        (1, 4, 4, 300, 300, 128, True, 0, None),
        (2, 8, 2, 150, 150, 64, True, 0, None),
        (1, 6, 2, 70, 90, 64, True, 20, None),
    ]
    for B, Hq, Hkv, Sq, Skv, Dh, causal, off, kv_len in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(B, h, s, Dh, generator=g, device=dev)
                       .to(dtype) for h, s in ((Hq, Sq), (Hkv, Skv),
                                               (Hkv, Skv)))
            res = check_flash(q, k, v, causal=causal, q_offset=off,
                              kv_len=kv_len)
            log(f"small flash (B={B}, Hq={Hq}, Hkv={Hkv}, Sq={Sq}, "
                f"Skv={Skv}, Dh={Dh}, causal={causal}, q_offset={off}, "
                f"kv_len={kv_len}, {str(dtype)[6:]}): {res}")
    # a row that sees no key comes out 0, as in chunked_attention: on the
    # SIMT variant (f32), the split-KV one (bf16, 8 rows) and the wgmma
    # one (bf16, 80 rows)
    from repro_torch.kernels.flash import ops
    for Sq, dtype in ((4, torch.float32), (4, torch.bfloat16),
                      (40, torch.bfloat16)):
        q = torch.randn(1, 2, Sq, 64, generator=g, device=dev).to(dtype)
        out = ops.attention(q, q[:, :1], q[:, :1], causal=True, q_offset=-2)
        assert bool((out[0, :, :2] == 0).all()), (
            f"flash: masked rows not 0 (Sq {Sq}, {dtype})")


SPILL_CHECKED = ("prune_kernel", "topk_kernel", "topk_pruned_kernel",
                 "topk_tc_kernel", "topk_pruned_tc_kernel", "ucb_kernel",
                 "ucb_block_kernel", "choose_tile_kernel", "cross_tc_kernel",
                 "cross_split_kernel", "cc_hop_kernel")


def spill_check() -> dict:
    """Registers and spills of the prune, top-K, ucb, choose (register
    tile, each width), cross (tensor route and W split) and cc_hop (each
    load width) kernels, from the ptxas report of their builds; raise if
    any of them spills."""
    from repro_torch.kernels import _build
    usage = {}
    for lib in ("prune", "topk", "topk_bf16_tc", "ucb", "choose", "cross",
                "cc_hop"):
        usage.update(_build.ptxas_usage(_build.build_report(lib)))
    seen = {}
    for func, (regs, st, ld) in sorted(usage.items()):
        m = re.search(r"\d+(" + "|".join(SPILL_CHECKED) + ")", func)
        if m is None:
            continue
        args = re.findall(r"Li(\d+)E", func)
        if "bfloat16" in func:      # the instantiation for a bf16 Minv
            args.append("bf16")
        label = m.group(1) + (f"<{', '.join(args)}>" if args else "")
        seen[label] = (regs, st, ld)
        log(f"ptxas {label}: {regs} registers, {st} bytes spill stores, "
            f"{ld} bytes spill loads")
    for kname in SPILL_CHECKED:
        assert any(label.split("<")[0] == kname for label in seen), (
            f"ptxas: no report for {kname}")
    spilled = [label for label, (_, st, ld) in seen.items() if st or ld]
    assert not spilled, f"ptxas: {spilled} spill"
    return seen


def sass_check() -> dict:
    """Count the HGMMA (wgmma) instructions in the SASS of the flash and
    cross libraries and the HMMA (mma.sync) ones of the top-K's filter
    kernels (``cuobjdump -sass``); raise if any has none, or if the
    retired ``flash_mma_kernel`` is still in flash's."""
    import shutil
    from repro_torch.kernels import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    counts = {}
    for name in ("flash", "cross"):
        lib = _build.library_path(_build.KERNELS[name][0])
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, check=True, timeout=300).stdout
        n = counts[name] = sum("HGMMA" in line for line in sass.splitlines())
        log(f"sass {lib.name}: {n} HGMMA instructions")
        assert n > 0, f"{name}: no HGMMA in the compiled library"
        if name == "flash":
            assert "flash_mma_kernel" not in sass, (
                "flash: flash_mma_kernel is built")
    lib = _build.library_path(_build.KERNELS["topk_bf16_tc"][0])
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts["topk_tc"], func = {}, None
    for line in sass.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            func = m.group(1) if "_tc_kernel" in m.group(1) else None
            if func:
                counts["topk_tc"][func] = 0
        elif func and "HMMA" in line:
            counts["topk_tc"][func] += 1
    log(f"sass {lib.name}: HMMA instructions of the filter kernels "
        f"{counts['topk_tc']}")
    assert len(counts["topk_tc"]) == 4 and all(counts["topk_tc"].values()), (
        "topk: a filter kernel without HMMA")
    return counts


@contextlib.contextmanager
def plain_path():
    """Every kernel wrapper swapped for its plain version, so that the
    engines and models run the plain PyTorch path on the CUDA tensors."""
    import torch
    from repro_torch.kernels.cross import ops as cops
    from repro_torch.kernels.cross import ref as cref
    from repro_torch.kernels.embag import ops as eops
    from repro_torch.kernels.embag import ref as eref
    from repro_torch.kernels.flash import ops as fops
    from repro_torch.kernels.flash import ref as fref
    from repro_torch.kernels.graph import ops as gops
    from repro_torch.kernels.graph import ref as gref
    from repro_torch.kernels.interact import ops as iops
    from repro_torch.kernels.interact import ref as iref
    from repro_torch.kernels.rank1 import ops as rops
    from repro_torch.kernels.rank1 import ref as rref
    from repro_torch.kernels.topk import ops as tops
    from repro_torch.kernels.topk import ref as tref
    from repro_torch.kernels.ucb import ops as uops
    from repro_torch.kernels.ucb import ref as uref

    def embag_plain(table, idx, wt=None):
        ones = torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
        return eref.embedding_bag_ref(table, idx, ones if wt is None else wt)

    with contextlib.ExitStack() as stack:
        for module, name, plain in (
                (iops, "choose", iref.choose_ref),
                (rops, "rank1_update_inv", rref.rank1_update_inv_ref),
                (rops, "rank1_update", rref.rank1_update_ref),
                (uops, "ucb_scores", uref.ucb_scores_ref),
                (gops, "prune_packed", gref.prune_packed_ref),
                (gops, "cc_hop_packed", gref.cc_hop_packed_ref),
                (tops, "topk", tref.topk_ref),
                (tops, "topk_pruned", tref.topk_ref_pruned),
                (cops, "cross_layer", cref.cross_layer_ref),
                (eops, "embedding_bag", embag_plain),
                (fops, "attention", fref.chunked_attention)):
            stack.enter_context(mock.patch.object(module, name, plain))
        yield


def compare_paths(kernel, plain, n: int) -> None:
    """Kernel path against plain path, each ``(reward/random, clusters per
    epoch)``.  The two trajectories part at the first candidate tie that
    they round differently (cold-start bonuses tie to the last ulp), so
    they are held to statistics, not step by step: reward/random within 1%
    of the kernel path's (the bandit's lift over random is ~5%, so a path
    that learned nothing fails), clusters after each stage 2 within 1% of
    the n users."""
    (r_k, c_k), (r_p, c_p) = kernel, plain
    log(f"paths: kernel reward/random={r_k} clusters={c_k}; "
        f"plain reward/random={r_p} clusters={c_p}")
    assert abs(r_p - r_k) <= 0.01 * r_k, "reward/random: paths disagree"
    assert all(abs(a - b) <= 0.01 * n for a, b in zip(c_k, c_p)), (
        "clusters per epoch: paths disagree")


def cuda_ms(fn, flush, reps=REPS, warmup=3) -> float:
    """Median milliseconds of ``fn`` over ``reps`` launches (CUDA events),
    the L2 cache flushed before each."""
    return statistics.median(cuda_times(fn, flush, reps, warmup))


def turn_ms(fns: dict, flush, reps=TURN_REPS) -> dict:
    """Median milliseconds of each of ``fns`` over ``reps`` launches
    (``cuda_times``), taken in turns: each in order, ``reps / 2`` launches,
    then each again, so that a drift of the card touches all alike."""
    times = {key: [] for key in fns}
    for _ in range(2):
        for key, fn in fns.items():
            times[key] += cuda_times(fn, flush, reps // 2)
    return {key: statistics.median(t) for key, t in times.items()}


def cuda_times(fn, flush, reps, warmup=3) -> list[float]:
    """Milliseconds of each of ``reps`` launches of ``fn`` (CUDA events),
    the L2 cache flushed before each: ``flush`` is a 256 MB tensor that
    is zeroed, or a callable (``read_flush``)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush() if callable(flush) else flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def read_flush(flush):
    """A flush that only reads the 256 MB ``flush`` (its max), so that the
    L2 lines it leaves are clean; the ``zero_`` flush leaves them dirty,
    and a kernel that reads pays for their write-back."""
    import torch
    flat = flush.view(torch.int64)
    return lambda: flat.amax()


@contextlib.contextmanager
def cc_graphs(label, rows, chunk=2048):
    """Log the packed adjacency of every ``connected_components`` call made
    inside: rows, words, set bits, density, words with all 32 bits set,
    and hops (cc_hop launches); ``rows`` gets one dict a call.  The bits
    are counted ``chunk`` rows at a time (a few MB of scratch) after each
    call, inside the run."""
    from repro_torch.kernels import _build
    from repro_torch.runtime import stages
    real = stages.connected_components

    def spy(col, gb, adj, n, row0, n_local):
        before = _build.LAUNCHES["cc_hop"]
        labels = real(col, gb, adj, n, row0, n_local)
        R, W = adj.shape
        parts = [adj[r:r + chunk] for r in range(0, R, chunk)]
        bits = sum(popcount(p) for p in parts)
        rows.append({"rows": R, "words": W, "set_bits": bits,
                     "density": bits / max(1, R * n),
                     "full_words": sum(int((p == -1).sum()) for p in parts),
                     "hops": _build.LAUNCHES["cc_hop"] - before})
        return labels

    with mock.patch.object(stages, "connected_components", spy):
        yield rows
    log(f"{label}: {len(rows)} connected_components calls (rows, words, "
        f"set bits, density, full words, hops): "
        f"{[tuple(r.values()) for r in rows]}")


def first_stage2_graph(ops, hyper, d, dev):
    """The adjacency that the main path's first stage 2 runs connected
    components on (``distclub.run`` for one epoch from the seed, the input
    of its call)."""
    from repro_torch.core import distclub
    from repro_torch.runtime import stages
    real, caught = stages.connected_components, []

    def spy(col, gb, adj, *rest):
        caught.append(adj)
        return real(col, gb, adj, *rest)

    with mock.patch.object(stages, "connected_components", spy):
        distclub.run(ops, SEED, hyper, 1, d, device=dev)
    return caught[0]


@contextlib.contextmanager
def first_args(cls, *names):
    """Every call of ``cls``'s methods ``names`` inside goes on as it
    was; the dict yielded gets, by name, the arguments of each one's first
    call."""
    caught = {}

    def spy(name, real):
        def call(self, *args, **kw):
            caught.setdefault(name, args)
            return real(self, *args, **kw)
        return call

    with contextlib.ExitStack() as stack:
        for name in names:
            stack.enter_context(mock.patch.object(
                cls, name, spy(name, getattr(cls, name))))
        yield caught


CC_DENSE_MINS = (0, 4, 8, 12, 16, 20, 24, 28, 32)


def cc_hop_sweep(graphs, flush) -> list[dict]:
    """cc_hop with its dense threshold forced to each of CC_DENSE_MINS
    (32: every word walked, no table), median of REPS launches on each of
    ``graphs`` ({label: (adjacency, labels)}): the threshold's
    measurement."""
    out = []
    for dense_min in CC_DENSE_MINS:
        row = {"dense_min": dense_min}
        for label, (a, la) in graphs.items():
            row[f"ms{label}"] = cuda_ms(
                lambda: cc_hop_forced(a, la, la, dense_min), flush)
        out.append(row)
        log(f"time cc_hop at dense_min={dense_min}: {row}")
    return out


PRUNE_DENSITIES = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.02, 0.05, 0.08,
                   0.12)
# set bits in each row's every 128 columns: 16 x as many in a warp tile
PRUNE_ROW_BITS = (6, 8, 10, 11, 12, 13, 14, 15, 16)


def prune_sweep(dev, v, cb, gamma, flush) -> list[dict]:
    """prune over ``v`` (all rows against all columns), median of REPS
    launches each: the wrapper's time and each branch of the kernel
    forced, on seeded random adjacencies of rising density (a warp
    tile's mean bits 2048 x density; the forced walk only where no tile
    holds more than it takes) and on adjacencies with the same bits in
    every warp tile (the sparse threshold's measurement)."""
    import torch
    from repro_torch.kernels.graph import ops as gops
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    n = v.shape[0]
    cases = [({"density": p}, random_adj(g, n, n, p, dev))
             for p in PRUNE_DENSITIES]
    cases += [({"row_bits": k}, tile_adj(g, n, n, k, dev))
              for k in PRUNE_ROW_BITS]
    rows = []
    for row, a in cases:
        tiles = gops.warp_tile_bits(a)
        most = int(tiles.max())
        row.update(tile_bits_mean=float(tiles.float().mean()),
                   tile_bits_max=most,
                   ms=cuda_ms(lambda: gops.prune_packed(a, v, cb, v, cb,
                                                        gamma), flush),
                   dense_ms=cuda_ms(lambda: prune_branch(
                       a, v, cb, v, cb, gamma, 0), flush),
                   sparse_ms=cuda_ms(lambda: prune_branch(
                       a, v, cb, v, cb, gamma, gops.SPARSE_CAP), flush)
                   if most <= gops.SPARSE_CAP else None)
        rows.append(row)
        log(f"time prune: {row}")
    return rows


def device_kernels(fn) -> tuple[float, list]:
    """``fn`` once under torch.profiler, tracing the card's activity only
    (what is read is device time; host events would make ``key_averages``
    slow, and phase 4d profiles 20 epochs): (device busy microseconds, its
    kernels' events, longest first)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda ev: -ev.self_device_time_total)
    return sum(ev.self_device_time_total for ev in kernels), kernels


def profile_epoch(distclub, state, ops, hyper, d, steady_s) -> None:
    """Device time by kernel over one more epoch (torch.profiler), and its
    share of ``steady_s``, the same epoch's wall time without the profiler
    (whose own host cost inflates the wall time it sees)."""
    busy_us, kernels = device_kernels(
        lambda: distclub.epoch(state, ops, SEED, EPOCHS, hyper, d))
    log(f"profile: device busy {busy_us / 1e3} ms in an epoch of "
        f"{steady_s * 1e3} ms wall ({busy_us / (steady_s * 1e6)} busy)")
    for ev in kernels[:25]:
        log(f"  {ev.self_device_time_total / 1e3:10.3f} ms "
            f"{ev.count:6d}x  {ev.key[:90]}")


# the port's own kernels (csrc/*.cu): a profile prints each of them
PORT_KERNELS = re.compile(r"\b(cc_hop|choose\w*|cross\w*|embag|flash\w*|merge"
                          r"|prune\w*|rank1\w*|topk\w*|ucb\w*)_kernel\b")


def profile_batch(label, fn, steady_s) -> None:
    """Device time by kernel of one serving batch (torch.profiler), and its
    share of ``steady_s``, a batch's wall time without the profiler: the
    15 longest kernels, then the port's own kernels among the rest."""
    busy_us, kernels = device_kernels(fn)
    log(f"profile {label}: device busy {busy_us / 1e3} ms in a batch of "
        f"{steady_s * 1e3} ms wall ({busy_us / (steady_s * 1e6)} busy)")
    for ev in kernels[:15] + [ev for ev in kernels[15:]
                              if PORT_KERNELS.search(ev.key)]:
        log(f"  {ev.self_device_time_total / 1e3:10.3f} ms "
            f"{ev.count:6d}x  {ev.key[:90]}")


def serve_clusters(state) -> int:
    """Clusters of a serving state: the labels of the last stage 2, or the
    components of dccb's dense gossip graph."""
    from repro_torch.core import clustering
    if hasattr(state, "core"):
        return int(clustering.num_clusters(
            clustering.connected_components(state.core.adj)))
    return int(clustering.num_clusters(state.labels))


class ServeRun:
    """The serving workload of phase 4s: users, catalog, traffic and the
    Bernoulli draws, all made once on the card from the seed."""

    def __init__(self, dev, state, theta, hyper):
        import torch
        from repro_torch import serve
        from repro_torch.configs import distclub_paper as paper
        from repro_torch.core import env
        cenv, _ = env.make_catalog_env(
            SEED, paper.N_USERS, paper.D_FEAT, paper.N_CLUSTERS, SERVE_ITEMS,
            n_regions=100, n_candidates=hyper.n_candidates,
            within_cluster_noise=paper.WITHIN_CLUSTER_NOISE,
            item_noise_scale=0.05, device=dev)
        assert torch.equal(cenv.theta, theta), "catalog env: other users"
        self.env = cenv
        self.theta = theta
        self.catalog = serve.make_catalog(env.catalog_embeddings(cenv))
        self.start = serve.OnlineBandit.from_offline(
            state, hyper, refresh_every=REFRESH_EVERY)
        g = torch.Generator(device=dev).manual_seed(SEED + 2)
        self.users = torch.randperm(paper.N_USERS, generator=g, device=dev)[
            :(SERVE_BATCHES + 1) * SERVE_BATCH].to(torch.int32).view(
                SERVE_BATCHES + 1, SERVE_BATCH)
        self.uniforms = torch.rand(SERVE_BATCHES + 1, SERVE_BATCH,
                                   generator=g, device=dev)

    def reward_fn(self, key, uids, ctx, slot):
        from repro_torch.core import env
        return env.step_rewards(self.uniforms[key], self.theta[uids.long()],
                                ctx, slot)

    def run(self, clusters=None, batches=SERVE_BATCHES, start=None,
            catalog=None):
        """Serve the batches from ``start`` (default the warm distclub
        session) against ``catalog`` (default the f32 catalog):
        ``(session, items per batch, reward/random, seconds per batch,
        clusters after each refresh, (tiles skipped, tile visits))``."""
        import torch
        from repro_torch import serve
        sess = self.start if start is None else start
        catalog = self.catalog if catalog is None else catalog
        items, secs, n_clu = [], [], []
        reward = rand = 0.0
        skipped = total = 0
        for t in range(batches):
            t0 = time.perf_counter()
            out = serve.step_catalog(sess, t, self.users[t], catalog,
                                     self.reward_fn, k_short=K_SHORT,
                                     clusters=clusters)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            sess, item, metrics = out[:3]
            if clusters is not None:
                skipped += out[3].tiles_skipped
                total += out[3].tiles_total
            items.append(item)
            reward += float(metrics.reward)
            rand += float(metrics.rand_reward)
            if int(sess.state.since_refresh) == 0:
                n_clu.append(serve_clusters(sess.state))
        return sess, items, reward / rand, secs, n_clu, (skipped, total)


def serve_phase(dev, state, theta, hyper, dccb_state, graphs):
    """Phase 4s and its plain run, then the dccb policy on phase 4b's
    DCCB state; returns what phases 5 and 6 need (the launches summed
    over the counted runs); the adjacency at each connected_components
    call of the counted runs goes into ``graphs``."""
    import torch
    from repro_torch import serve
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    work = ServeRun(dev, state, theta, hyper)
    torch.cuda.synchronize()
    log(f"serve setup: {SERVE_ITEMS} items, d={work.catalog.d}, "
        f"{time.perf_counter() - t0} s")

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    with cc_graphs("serve", graphs):
        sess_u, items_u, rr_u, secs_u, clu_u, _ = work.run()
        t0 = time.perf_counter()
        clusters = serve.build_clusters(work.catalog, tile_items=512,
                                        n_anchors=512)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        sess_p, items_p, rr_p, secs_p, clu_p, (sk, tot) = work.run(clusters)
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    same = [bool(torch.equal(a, b)) for a, b in zip(items_u, items_p)]
    n_req = SERVE_BATCH * (SERVE_BATCHES - 1)
    log(f"serve unpruned: reward/random={rr_u} clusters after each "
        f"refresh={clu_u} warm requests/s={n_req / sum(secs_u[1:])} "
        f"median batch ms={1e3 * statistics.median(secs_u)}")
    log(f"serve pruned: reward/random={rr_p} clusters after each "
        f"refresh={clu_p} warm requests/s={n_req / sum(secs_p[1:])} "
        f"median batch ms={1e3 * statistics.median(secs_p)} skip "
        f"ratio={sk / tot} ({sk} of {tot} tile visits) item clusters="
        f"{int(clusters.n_clusters)} build_clusters s={build_s}")
    log(f"serve launches: {launches} max_memory_allocated={peak}")
    assert all(same), f"pruned and unpruned served other items: {same}"
    assert len(clu_u) == 2 and clu_u == clu_p, (clu_u, clu_p)
    assert rr_u > 1.0, "serving does no better than random"
    for it in items_u:
        assert it.shape == (SERVE_BATCH,) and bool((it >= 0).all())
        assert bool((it < SERVE_ITEMS).all())
    for t in (sess_u.state.Minv, sess_u.state.b, sess_u.state.uMcinv):
        assert bool(torch.isfinite(t).all()), "non-finite serving state"
    assert launches["topk"] == SERVE_BATCHES, launches
    assert launches["topk_pruned"] == SERVE_BATCHES, launches
    assert launches["choose"] == 2 * SERVE_BATCHES, launches
    assert launches["rank1_update_inv"] == 2 * SERVE_BATCHES, launches
    assert launches["prune"] == 2 * len(clu_u) + 1, launches
    assert launches["cc_hop"] >= 2 * len(clu_u) + 1, launches

    extra = SERVE_BATCHES    # a batch outside both runs, for the profiles
    for label, cl, secs in (("unpruned", None, secs_u),
                            ("pruned", clusters, secs_p)):
        profile_batch(label, lambda: serve.step_catalog(
            sess_u, extra, work.users[extra], work.catalog, work.reward_fn,
            k_short=K_SHORT, clusters=cl), statistics.median(secs))

    # ---- phase 4s, plain ---------------------------------------------------
    _build.reset_launches()
    t0 = time.perf_counter()
    with plain_path():
        _, items_q, rr_q, _, clu_q, _ = work.run()
    torch.cuda.synchronize()
    share = float(torch.mean(torch.cat(
        [(a == b).float() for a, b in zip(items_u, items_q)])))
    log(f"serve plain: {time.perf_counter() - t0} s for "
        f"{SERVE_BATCHES} batches, reward/random={rr_q} clusters after "
        f"each refresh={clu_q} identical items={share}")
    assert not any(_build.LAUNCHES.values()), dict(_build.LAUNCHES)
    assert abs(rr_q - rr_u) <= 0.01 * rr_u, "serve reward/random: paths part"
    assert share >= 0.95, "serve: the plain path served other items"
    d_launch = serve_dccb(dev, work, hyper, dccb_state)
    launches = {k: v + d_launch[k] for k, v in launches.items()}
    work.items = items_u      # phase 4x holds its sharded session to them
    return work, sess_u, clusters, launches, sk / tot


def serve_dccb(dev, work, hyper, core):
    """Phase 4s, dccb: the policy's session on the offline DCCB state
    serves the unpruned batches, counted; profiled; then plain."""
    import torch
    from repro_torch import serve
    from repro_torch.kernels import _build
    from repro_torch.kernels.topk import ref as tref
    n, d = work.theta.shape
    cfg = serve.make_cfg(n, d, hyper, refresh_every=REFRESH_EVERY,
                         seed=SEED)
    start = serve.OnlineBandit(
        policy=serve.get_policy("dccb", cfg),
        state=serve.DCCBServeState(core=core, since_refresh=torch.zeros(
            (), dtype=torch.int32, device=dev)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    sess, items, rr, secs, n_clu, _ = work.run(start=start)
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n_req = SERVE_BATCH * (SERVE_BATCHES - 1)
    log(f"serve dccb: reward/random={rr} clusters after each refresh="
        f"{n_clu} warm requests/s={n_req / sum(secs[1:])} median batch "
        f"ms={1e3 * statistics.median(secs)} ms per batch="
        f"{[1e3 * s for s in secs]}")
    log(f"serve dccb launches: {launches} max_memory_allocated={peak}")
    assert len(n_clu) == 2, n_clu
    assert launches["topk"] == SERVE_BATCHES, launches
    assert launches["choose"] == SERVE_BATCHES, launches
    assert sum(launches.values()) == 2 * SERVE_BATCHES, launches
    assert int(sess.state.core.occ.sum()) == (
        int(core.occ.sum()) + SERVE_BATCH * SERVE_BATCHES)
    for it in items:
        assert it.shape == (SERVE_BATCH,) and bool((it >= 0).all())
        assert bool((it < SERVE_ITEMS).all())
    for t in (sess.state.core.Mw, sess.state.core.bw, sess.state.core.Mbuf):
        assert bool(torch.isfinite(t).all()), "non-finite dccb serving state"

    # topk and choose against their plain versions on this path's inputs:
    # the first batch's users on the start state, the next batch's on the
    # last state (uncounted)
    extra = SERVE_BATCHES
    bank = work.catalog.serving
    for label, st, t in (("start", start.state, 0),
                         ("end", sess.state, extra)):
        w, Minv, occ = sess.policy.gather_score(st, work.users[t].long())
        e_t = check_topk(w, Minv, occ, bank.emb, bank.live, hyper.alpha,
                         K_SHORT)
        _, ids = tref.topk_ref(w, Minv, occ, bank.emb, bank.live,
                               hyper.alpha, K_SHORT)
        e_c = check_choose(w, Minv, bank.emb[ids.long()].contiguous(), occ,
                           hyper.alpha)
        log(f"serve dccb {label} batch: users at w = 0 "
            f"{int((w.abs().amax(dim=1) == 0).sum())} of {SERVE_BATCH}; "
            f"topk {e_t}; choose {e_c}")

    profile_batch("dccb", lambda: serve.step_catalog(
        sess, extra, work.users[extra], work.catalog, work.reward_fn,
        k_short=K_SHORT), statistics.median(secs))

    _build.reset_launches()
    t0 = time.perf_counter()
    with plain_path():
        _, items_q, rr_q, _, clu_q, _ = work.run(start=start)
    torch.cuda.synchronize()
    share = float(torch.mean(torch.cat(
        [(a == b).float() for a, b in zip(items, items_q)])))
    log(f"serve dccb plain: {time.perf_counter() - t0} s for "
        f"{SERVE_BATCHES} batches, reward/random={rr_q} clusters after "
        f"each refresh={clu_q} identical items={share}")
    assert not any(_build.LAUNCHES.values()), dict(_build.LAUNCHES)
    assert len(clu_q) == len(n_clu) and all(
        abs(a - b) <= 0.01 * n for a, b in zip(n_clu, clu_q)), (n_clu, clu_q)
    for it in items_q:
        assert it.shape == (SERVE_BATCH,) and bool((it >= 0).all())
    return launches


# ---------------------------------------------------------------------------
# phase 4p: reduced-precision serving and checkpointing
# ---------------------------------------------------------------------------


def precision_lockstep(work, start, cat, items, alpha) -> int:
    """A reduced-precision session's run against the plain versions,
    batch by batch: the session is served again from ``start`` (its items
    must be ``items`` again), and before each batch the plain versions
    recommend on the same state; where an item differs, both items' plain
    UCB scores under that state's statistics (the dequantized rows) must
    lie within ``check_topk``'s band.  Returns the differences."""
    import torch
    from repro_torch import serve
    from repro_torch.kernels.ucb import ref as uref
    deq = serve.dequantize(cat.serving)
    sess, n_diff = start, 0
    for t in range(SERVE_BATCHES):
        uids = work.users[t]
        with plain_path():
            want, _, _ = serve.recommend_catalog(sess, uids, cat,
                                                 k_short=K_SHORT)
        w, M, occ = sess.policy.gather_score(sess.state, uids.long())
        sess, item, _ = serve.step_catalog(sess, t, uids, cat,
                                           work.reward_fn, k_short=K_SHORT)
        assert torch.equal(item, items[t]), "phase 4p: a rerun served others"
        diff = item != want
        if bool(diff.any()):
            s_k, s_p = (uref.ucb_scores_ref(
                w[diff], M[diff], deq[i.long()][:, None], occ[diff],
                alpha)[:, 0] for i in (item[diff], want[diff]))
            assert bool(((s_k - s_p).abs()
                         <= 1e-5 * (1 + s_p.abs())).all()), (
                "phase 4p: the plain versions served other items beyond "
                "near ties")
            n_diff += int(diff.sum())
    return n_diff


def flip_rates(dev, oracle, theta, f32_cat, cats, *, batch=SERVE_BATCH,
               warm=FLIP_WARM, batches=FLIP_BATCHES, seed=SEED + 3) -> dict:
    """``benchmarks/bench_precision.py``'s counterfactual choice-flip
    rate: the f32 session ``oracle`` drives the one trajectory over
    ``warm + batches`` batches of ``batch`` distinct users; after the
    warm-up each batch's f32 decision (``recommend_catalog`` on the f32
    catalog) is compared with the decision from the same state cast down
    to each precision's state dtype against its quantized catalog
    (``cats``).  ``{precision: (flips, decisions)}``."""
    import dataclasses

    import torch
    from repro_torch import serve
    from repro_torch.core import env
    cfg = oracle.policy.cfg
    g = torch.Generator(device=dev).manual_seed(seed)
    steps = warm + batches
    users = torch.stack([torch.randperm(cfg.n_users, generator=g,
                                        device=dev)[:batch]
                         for _ in range(steps)]).to(torch.int32)
    uniforms = torch.rand(steps, batch, generator=g, device=dev)

    def reward_fn(key, uids, ctx, slot):
        return env.step_rewards(uniforms[key], theta[uids.long()], ctx, slot)

    probes = {p: serve.OnlineBandit.create(
        cfg.n_users, cfg.d, cfg.hyper, precision=p, device=dev)
        for p in cats}
    flips = dict.fromkeys(cats, 0)
    for t in range(steps):
        u = users[t]
        if t >= warm:
            want, _, _ = serve.recommend_catalog(oracle, u, f32_cat,
                                                 k_short=K_SHORT)
            for p, cat in cats.items():
                sdt = probes[p].policy.cfg.precision.torch_state
                st = oracle.state._replace(Minv=oracle.state.Minv.to(sdt),
                                           uMcinv=oracle.state.uMcinv.to(sdt))
                got, _, _ = serve.recommend_catalog(
                    dataclasses.replace(probes[p], state=st), u, cat,
                    k_short=K_SHORT)
                flips[p] += int((got != want).sum())
        oracle, _, _ = serve.step_catalog(oracle, t, u, f32_cat, reward_fn,
                                          k_short=K_SHORT)
    return {p: (f, batches * batch) for p, f in flips.items()}


def bench_flip_rates(dev) -> dict:
    """``benchmarks/bench_precision.py``'s parity measurement itself,
    through the port's kernels: a cold distclub session of 256 users (d
    32, alpha 0.05, gamma 1.5, no refresh) against 4096 unit-norm random
    items (structureless, so that the items are distinct and a flip is a
    real change of ranking), batches of 64 distinct users, k_short 64,
    32 warm-up and 40 measured rounds; users' preferences random unit
    vectors.  Draws from the seed on the card (not the bench's JAX
    draws).  ``{precision: (flips, decisions)}``."""
    import torch
    from repro_torch import serve
    from repro_torch.core.types import BanditHyper
    n, d, N = 256, 32, 4096
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    emb = unit(torch.randn(N, d, generator=g, device=dev))
    theta = unit(torch.randn(n, d, generator=g, device=dev))
    hyper = BanditHyper(alpha=0.05, gamma=1.5, n_candidates=K_SHORT)
    oracle = serve.OnlineBandit.create(n, d, hyper, device=dev)
    cats = {p: serve.make_catalog(emb, precision=p) for p in PRECISIONS}
    return flip_rates(dev, oracle, theta, serve.make_catalog(emb), cats,
                      batch=64, warm=32, batches=40, seed=SEED + 5)


def checkpoint_round_trip(work, start, cat, items):
    """The bf16 session saved after half the batches
    (``CheckpointManager`` under ``build/``, removed after), then
    restored into a fresh bf16 session, which must serve the second half's
    items again; a restore under the f32 and the int8 presets must raise
    (their tags differ).  Returns the save and restore seconds."""
    import shutil

    import torch
    from repro_torch import serve
    from repro_torch.train.checkpoint import CheckpointManager
    ckdir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    ck = CheckpointManager(ckdir, keep=2)
    half = SERVE_BATCHES // 2
    sess = start
    for t in range(half):
        sess, _, _ = serve.step_catalog(sess, t, work.users[t], cat,
                                        work.reward_fn, k_short=K_SHORT)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess.save(ck, half)
    save_s = time.perf_counter() - t0
    del sess                                     # the "crash"
    fresh = fresh_session(start)
    t0 = time.perf_counter()
    back, step = fresh.restore(ck)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    assert step == half and back.state.Minv.dtype == torch.bfloat16
    assert back.state.Minv.device == start.state.Minv.device
    for t in range(half, SERVE_BATCHES):
        back, item, _ = serve.step_catalog(back, t, work.users[t], cat,
                                           work.reward_fn, k_short=K_SHORT)
        assert torch.equal(item, items[t]), (
            "phase 4p: the restored session served other items")
    refused = []
    for prec in ("f32", "int8"):
        other = serve.OnlineBandit.create(
            start.policy.cfg.n_users, start.policy.cfg.d,
            start.policy.cfg.hyper, precision=prec,
            device=start.state.Minv.device)
        try:
            other.restore(ck)
        except ValueError as e:
            assert "precision mismatch" in str(e), e
            refused.append(prec)
    assert refused == ["f32", "int8"], f"restored under {refused}"
    shutil.rmtree(ckdir, ignore_errors=True)
    return {"save_s": save_s, "restore_s": restore_s,
            "refused": refused, "resumed_batches": SERVE_BATCHES - half}


def fresh_session(session):
    """A fresh session of ``session``'s policy and precision on the same
    device (the restarted replica): identity rows, as ``create`` makes."""
    from repro_torch import serve
    cfg = session.policy.cfg
    return serve.OnlineBandit.create(
        cfg.n_users, cfg.d, cfg.hyper, refresh_every=cfg.refresh_every,
        precision=cfg.precision, device=session.state.Minv.device)


def precision_phase(dev, work, state, hyper, theta):
    """Phase 4p: phase 4s's workload (the learned users from phase 4's
    state, 2^18 items, 16 batches of 256, k_short 64, stage 2 every 2048)
    in a session of each reduced precision against the catalog quantized
    to it, unpruned and pruned (``build_clusters(512, 512)``), counted:
    every launch through the variant kernels (the f32 topk, topk_pruned
    and rank1_update_inv never), the pruned items equal to the unpruned
    ones in every batch; the run against the plain versions
    (``precision_lockstep``); the bf16 session's checkpoint round trip;
    the counterfactual choice-flip rate against the f32 session
    (``flip_rates``): at most FLIP_MAX on ``bench_precision.py``'s own
    configuration (``bench_flip_rates``), where the method is defined,
    and printed for phase 4s's learned users and traffic against a
    structureless random catalog of 2^18 items and against phase 4s's
    region catalog.  Returns what phases 5 and 6 need."""
    import torch
    from repro_torch import serve
    from repro_torch.kernels import _build
    from repro_torch.kernels.topk import ops as tops
    emb = work.catalog.serving.emb
    out = {"cats": {}, "clusters": {}, "sessions": {}, "launches": {}}
    total = dict.fromkeys(_build.LAUNCHES, 0)
    for prec in PRECISIONS:
        t0 = time.perf_counter()
        cat = serve.make_catalog(emb, precision=prec)
        start = serve.OnlineBandit.from_offline(
            state, hyper, refresh_every=REFRESH_EVERY, precision=prec)
        clusters = serve.build_clusters(cat, tile_items=512, n_anchors=512)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        # the filter launches' own counts: no violation on the path
        with tops.FilterStats() as st_u:
            sess_u, items_u, rr_u, secs_u, clu_u, _ = work.run(
                start=start, catalog=cat)
        with tops.FilterStats() as st_p:
            sess_p, items_p, rr_p, secs_p, clu_p, (sk, tot) = work.run(
                clusters, start=start, catalog=cat)
        launches = dict(_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        same = [bool(torch.equal(a, b)) for a, b in zip(items_u, items_p)]
        log(f"precision {prec}: catalog {cat.emb.dtype} "
            f"{cat.emb.element_size() * cat.emb[0].numel()} bytes a bank, "
            f"state {sess_u.state.Minv.dtype}, setup {setup_s} s; unpruned "
            f"reward/random={rr_u} median batch ms="
            f"{1e3 * statistics.median(secs_u)}; pruned reward/random="
            f"{rr_p} median batch ms={1e3 * statistics.median(secs_p)} skip "
            f"ratio={sk / tot}; clusters after each refresh={clu_u}; "
            f"items same as phase 4s's in "
            f"{sum(bool(torch.equal(a, b)) for a, b in zip(items_u, work.items))}"
            f" of {SERVE_BATCHES} batches; max_memory_allocated={peak}")
        log(f"precision {prec} launches: {launches}")
        pairs = SERVE_BATCHES * SERVE_BATCH * int((cat.serving.live > 0).sum())
        log(f"precision {prec} filter on the path: unpruned rescored "
            f"{st_u.rescored} pairs (share {st_u.rescored / pairs}), "
            f"violations {st_u.violations}; pruned rescored {st_p.rescored}"
            f" (share {st_p.rescored / pairs}), violations "
            f"{st_p.violations}")
        assert st_u.violations == 0 and st_p.violations == 0, (
            f"{prec}: filter violations on the path")
        assert st_u.rescored > 0 and st_p.rescored > 0
        log(f"precision {prec} median batch ms beside the chain kernels' "
            f"(PERF.md section 5): unpruned "
            f"{1e3 * statistics.median(secs_u)} (chain: "
            f"{CHAIN_BATCH_MS[prec][0]}), pruned "
            f"{1e3 * statistics.median(secs_p)} (chain: "
            f"{CHAIN_BATCH_MS[prec][1]})")
        assert all(same), f"{prec}: pruned and unpruned served other items"
        assert rr_u > 1.0, f"{prec}: serving does no better than random"
        assert len(clu_u) == 2 and clu_u == clu_p, (clu_u, clu_p)
        for t in (sess_u.state.Minv, sess_u.state.uMcinv, sess_u.state.b):
            assert bool(torch.isfinite(t.float()).all()), "non-finite state"
        assert sess_u.state.Minv.dtype == torch.bfloat16
        assert launches[f"topk_{prec}_tc"] == SERVE_BATCHES, launches
        assert launches[f"topk_pruned_{prec}_tc"] == SERVE_BATCHES, launches
        assert not launches[f"topk_{prec}"], launches
        assert not launches[f"topk_pruned_{prec}"], launches
        assert launches["rank1_update_inv_bf16"] == 2 * SERVE_BATCHES, (
            launches)
        assert launches["choose"] == 2 * SERVE_BATCHES, launches
        for name in ("topk", "topk_pruned", "rank1_update_inv"):
            assert launches[name] == 0, launches
        for k, v in launches.items():
            total[k] += v
        t0 = time.perf_counter()
        n_diff = precision_lockstep(work, start, cat, items_u, hyper.alpha)
        log(f"precision {prec} plain: {time.perf_counter() - t0} s, items "
            f"other than the kernels' (near ties): {n_diff} of "
            f"{SERVE_BATCH * SERVE_BATCHES}")
        out["cats"][prec], out["clusters"][prec] = cat, clusters
        out["sessions"][prec] = sess_u
        out["launches"][prec] = launches
        out.setdefault("skip", {})[prec] = sk / tot
        if prec == "bf16":
            out["checkpoint"] = checkpoint_round_trip(work, start, cat,
                                                      items_u)
            log(f"precision bf16 checkpoint: {out['checkpoint']}")
    # the counterfactual choice-flip rate (bench_precision.py's method):
    # on the bench's own configuration (a structureless catalog), gated;
    # on phase 4s's learned users, traffic and size against a
    # structureless random catalog of as many items; and on phase 4s's
    # region catalog, whose items are near-clones (100 regions, noise
    # 0.05), so that a flip there may be one clone for another
    oracle = serve.OnlineBandit.from_offline(state, hyper,
                                             refresh_every=REFRESH_EVERY)
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    rand_emb = unit(torch.randn(emb.shape, generator=g, device=dev))
    runs = {
        "bench": lambda: bench_flip_rates(dev),
        "random_catalog": lambda: flip_rates(
            dev, oracle, theta, serve.make_catalog(rand_emb),
            {p: serve.make_catalog(rand_emb, precision=p)
             for p in PRECISIONS}),
        "region_catalog": lambda: flip_rates(dev, oracle, theta,
                                             work.catalog, out["cats"]),
    }
    out["flip"] = {}
    for label, run in runs.items():
        t0 = time.perf_counter()
        flips = run()
        out["flip"][label] = {p: f / m for p, (f, m) in flips.items()}
        log(f"precision choice_flip_rate {label} "
            f"({time.perf_counter() - t0} s): "
            + ", ".join(f"{p} {f / m} ({f} of {m})" for p, (f, m)
                        in flips.items()))
    for p, rate in out["flip"]["bench"].items():
        assert rate <= FLIP_MAX, f"{p}: choice_flip_rate {rate}"
    out["total"] = total
    return out


def minv_engine_rounds(state, ops, hyper, step0):
    """Phase 4p, bf16 Minv, (a): phase 4's learned state with Minv cast to
    bf16 (M, b f32) through ``MINV_ROUNDS`` rounds of the bf16 preset's
    ``InteractBackend.choose`` and ``update_lin`` and of ``ucb_scores``
    (the round's score matrix) on phase 4's environment (its contexts and
    rewards from step ``step0`` on; a rotating eighth of the users sits
    out each round), the kernel's state carried forward.  Each round is
    held, uncounted, to the kernels on Minv's f32 widening (picks, x,
    scores bit for bit; the update's Minv their rounding, M and b
    bit-equal) and to the plain versions on the same inputs
    (``hold_choose``, ``hold_rank1_bf16``).  Returns the launches, the
    errors and the last round's inputs."""
    import torch
    from repro_torch.core import linucb
    from repro_torch.core.backend import BackendConfig
    from repro_torch.core.types import LinUCBState
    from repro_torch.kernels import _build
    from repro_torch.kernels.ucb import ops as uops
    lin0 = state.lin
    lin = LinUCBState(lin0.M.clone(), lin0.Minv.bfloat16(), lin0.b.clone(),
                      lin0.occ.clone())
    be = BackendConfig.create("bf16").interact()
    n = lin.b.shape[0]
    users = torch.arange(n, device=lin.b.device)
    errs = {k: {"max_abs_err": 0.0, "near_ties": 0, "max_ulps": 0}
            for k in ("choose_bf16", "ucb_bf16", "rank1_update_bf16")}
    secs = []
    torch.cuda.synchronize()
    _build.reset_launches()
    for t in range(MINV_ROUNDS):
        step = step0 + t
        t0 = time.perf_counter()
        ctx = ops.contexts_fn(SEED, step, lin.occ)
        w = linucb.user_vector(lin.Minv.float(), lin.b)
        x, choice = be.choose(w, lin.Minv, ctx, lin.occ, hyper.alpha)
        scores = uops.ucb_scores(w, lin.Minv, ctx, lin.occ, hyper.alpha)
        r = ops.rewards_fn(SEED, step, lin.occ, ctx, choice)[0]
        mask = (users + t) % 8 != 0
        with uncounted():
            res = hold_choose(w, lin.Minv, ctx, lin.occ, hyper.alpha, choice,
                              x, scores)
            before = tuple(a.clone() for a in lin[:3])
        lin = be.update_lin(lin, x, r, mask)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        with uncounted():
            upd = hold_rank1_bf16(before, lin[:3], x, r, mask)
        for k, v in (("choose_bf16", res["max_abs_err"]),
                     ("ucb_bf16", res["ucb_max_abs_err"]),
                     ("rank1_update_bf16", upd["max_abs_err"])):
            errs[k]["max_abs_err"] = max(errs[k]["max_abs_err"], v)
        errs["choose_bf16"]["near_ties"] += res["near_ties"]
        errs["rank1_update_bf16"]["max_ulps"] = max(
            errs["rank1_update_bf16"]["max_ulps"], upd["max_ulps"])
    launches = dict(_build.LAUNCHES)
    assert lin.Minv.dtype == torch.bfloat16
    for a in lin[:3]:
        assert bool(torch.isfinite(a.float()).all()), "non-finite state"
    for k in ("choose_bf16", "ucb_bf16", "rank1_update_bf16"):
        assert launches[k] == MINV_ROUNDS, launches
    for k in ("choose", "ucb", "rank1_update"):
        assert launches[k] == 0, launches
    return {"launches": launches, "errs": errs, "secs": secs,
            "inputs": (w, lin, ctx, x, r, mask)}


def minv_serving_batch(serving, sess_q, banks, alpha):
    """Phase 4p, bf16 Minv, (b): one serving batch of the bf16 preset's
    ``RetrievalBackend`` (``shortlist`` and ``shortlist_pruned``) for phase
    4s's first 256 users with the bf16 session's statistics, Minv in bf16
    (the session's own bits: its gathered rows are their exact widening),
    over each bank of ``banks`` (f32, bf16, int8: ``(catalog,
    clusters)``), counted; then, uncounted, each shortlist against the
    kernels on Minv's f32 widening, bit for bit, and against the plain
    versions (``check_topk_minv_bf16``, ``check_topk_pruned_minv_bf16``).
    Returns the launches and the errors."""
    import torch
    from repro_torch.core.backend import BackendConfig
    from repro_torch.kernels import _build
    from repro_torch.kernels.topk import ops as tops
    from repro_torch.kernels.topk import ref as tref
    idx = serving.users[0].long()
    w, M32, occ = sess_q.policy.gather_score(sess_q.state, idx)
    Mb = M32.bfloat16()
    assert torch.equal(Mb.float(), M32), "the gathered rows are not bf16's"
    rb = BackendConfig.create("bf16").retrieval(K_SHORT)
    got = {}
    torch.cuda.synchronize()
    _build.reset_launches()
    with tops.FilterStats() as st:
        for kind, (cat, cl) in banks.items():
            bank = cat.serving
            quant = bank.emb.dtype == torch.int8
            got[kind] = (
                rb.shortlist(w, Mb, occ, bank.emb, bank.live, alpha,
                             scales=bank.scale if quant else None),
                rb.shortlist_pruned(
                    w, Mb, occ, cl.emb_sorted, cl.live_sorted, cl.perm,
                    cl.tile_mu, cl.tile_r, cl.tile_xn, cl.tile_n, alpha,
                    scales_sorted=cl.scale_sorted if quant else None))
    launches = dict(_build.LAUNCHES)
    log(f"precision bf16 Minv serving batch, filter on the path: rescored "
        f"{st.rescored} pairs, violations {st.violations}")
    assert st.violations == 0, "bf16 Minv: filter violations on the path"
    assert st.rescored > 0
    for k in MINV_TOPK:
        assert launches[k] == 1, launches
    assert not any(v for k, v in launches.items() if k not in MINV_TOPK), (
        launches)
    errs = {}
    with uncounted():
        for kind, (cat, cl) in banks.items():
            bank = cat.serving
            sfx = BANK_SFX[kind]
            (s_u, i_u), (s_p, i_p, _, _) = got[kind]
            errs[f"topk_minv_bf16{sfx}"] = check_topk_minv_bf16(
                w, Mb, occ, bank.emb, bank.live,
                bank.scale if kind == "int8" else None, alpha, K_SHORT,
                got=(s_u, i_u))
            errs[f"topk_pruned_minv_bf16{sfx}"] = \
                check_topk_pruned_minv_bf16(w, Mb, occ, cat, cl, alpha,
                                            K_SHORT, got=(s_p, i_p))
            if kind != "f32":  # the filter kernels against the chain's
                sc = bank.scale if kind == "int8" else None
                ss = cl.scale_sorted if kind == "int8" else None
                res = check_topk_filter(w, Mb, occ, bank.emb, bank.live, sc,
                                        alpha, K_SHORT, got=(s_u, i_u))
                tb = tref.tile_bounds(w, Mb, occ, alpha, cl.tile_mu,
                                      cl.tile_r, cl.tile_xn, cl.tile_n)
                resp = check_topk_pruned_filter(
                    w, Mb, occ, cl.emb_sorted, cl.live_sorted, cl.perm, ss,
                    tb, alpha, K_SHORT, (s_u, i_u))
                for key, got_f in ((f"topk_minv_bf16{sfx}", res),
                                   (f"topk_pruned_minv_bf16{sfx}", resp)):
                    errs[key].update(
                        rescored=got_f["rescored"],
                        rescored_share=got_f["rescored_share"],
                        violations=got_f["violations"])
    return {"launches": launches, "errs": errs, "users": (w, Mb, occ)}


def minv_phase(dev, state, ops, hyper, serving, precision, item_clusters,
               step0):
    """Phase 4p, bf16 Minv: the engines on a bf16 Minv at full width
    (``minv_engine_rounds``, n = 20480, d = 25, K = 20) and one serving
    batch of the top-K over phase 4s's f32 and phase 4p's bf16 and int8
    banks (``minv_serving_batch``); each counted on its own, every
    launch through a bf16-Minv kernel.  Returns what phases 5 and 6
    need."""
    t0 = time.perf_counter()
    rounds = minv_engine_rounds(state, ops, hyper, step0)
    log(f"precision bf16 Minv engines: {MINV_ROUNDS} rounds in "
        f"{time.perf_counter() - t0} s (with their checks), median round "
        f"{1e3 * statistics.median(rounds['secs'])} ms; launches "
        f"{ {k: v for k, v in rounds['launches'].items() if v} }; "
        f"{rounds['errs']}")
    banks = {"f32": (serving.catalog, item_clusters),
             **{p: (precision["cats"][p], precision["clusters"][p])
                for p in PRECISIONS}}
    t0 = time.perf_counter()
    batch = minv_serving_batch(serving, precision["sessions"]["bf16"], banks,
                               hyper.alpha)
    log(f"precision bf16 Minv serving batch: {time.perf_counter() - t0} s "
        f"(with its checks); launches "
        f"{ {k: v for k, v in batch['launches'].items() if v} }; "
        f"{batch['errs']}")
    launches = {k: rounds["launches"][k] + batch["launches"][k]
                for k in rounds["launches"]}
    return {"launches": launches, "errs": {**rounds["errs"],
                                           **batch["errs"]},
            "rounds": rounds, "batch": batch, "banks": banks}


# ---------------------------------------------------------------------------
# phase 4o: the operations layer (guardrails, faults, experiments)
# ---------------------------------------------------------------------------

OPS_PENDING = 4096           # every buffer-enabled session's ring
OPS_TTL = 16
OPS_ITEMS = SERVE_ITEMS + SERVE_ITEMS // 8   # 2^18 + 2^15 slots: room for adds
OPS_CATALOG_ROUNDS = 48
OPS_GUARD_ROUNDS = 32
OPS_FLIP_AFTER = 16
OPS_EXP_ROUNDS = 60
OPS_POISON_AFTER = 20
OPS_CTR_FLOOR = 0.2          # the arms' floor; a healthy arm serves ~0.5
OPS_WARM_ROUNDS = 4          # item 1's warm-up before its timed runs
OPS_PLAIN_ROUNDS = 24        # item 1's (publishes torn) and item 3's first
                             # rounds in lockstep with the plain versions
OPS_RESUME = 4               # transactions held bit-identical after rollback
OPS_ONE_ARM = 8
OPS_DELIVERY = dict(p_delay=0.3, max_delay=4, p_loss=0.05, p_dup=0.05)
OPS_CHURN = dict(churn_every=4, churn_add=2048, churn_retire=2048,
                 swap_stall_rounds=1, p_torn=0.25, flash_crowd_at=20,
                 flash_crowd_size=4096, mass_retire_at=32)
OPS_CKPT_DIR = ROOT / "build" / "chip_smoke_ops_ckpt"
OPS_CLI_TIMEOUT_S = 300
OPS_CLIS = (("faultrun", ["-m", "repro_torch.launch.faultrun", "--scenario",
                          "churn", "--guard"]),
            ("abrun", ["-m", "repro_torch.launch.abrun", "--selector",
                       "--guard", "--faults"]),
            ("ab_experiment", ["examples/ab_experiment_torch.py"]))


def wall_ms(fn, reps=10) -> float:
    """Median milliseconds of ``fn()`` on the host clock, the card
    synchronised before and after each call."""
    import torch
    times = []
    for _ in range(reps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times[2:])


def ops_session(state, hyper):
    """The learned distclub users with a pending ring."""
    from repro_torch import serve
    return serve.OnlineBandit.from_offline(
        state, hyper, refresh_every=REFRESH_EVERY,
        pending_capacity=OPS_PENDING, pending_ttl=OPS_TTL)


def ops_catalog_run(work, state, hyper, rounds, spec):
    """Item 1: one ``run_faulted_catalog`` of the learned users on the
    region catalog in ``OPS_ITEMS`` slots, conservation asserted after
    every delivery; its report and the host seconds it took, the card
    synchronised before and after."""
    import torch
    from repro_torch import serve
    from repro_torch.core import env
    from repro_torch.serve import faults
    sess = ops_session(state, hyper)
    cat = serve.make_catalog(env.catalog_embeddings(work.env),
                             capacity=OPS_ITEMS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, rep = faults.run_faulted_catalog(
        sess, work.env, rounds, spec, catalog=cat, k_short=K_SHORT,
        batch=SERVE_BATCH, key=SEED, assert_conservation=True)
    torch.cuda.synchronize()
    return rep, time.perf_counter() - t0


def _picks_near(sess, uids, diff, x_k, x_p, label):
    """Where the kernels' pick and the plain versions' differ (``diff``),
    both picks' plain UCB scores (contexts ``x_k``, ``x_p``) under the
    session's statistics for ``uids`` must lie within ``check_topk``'s
    band.  Returns the differences."""
    from repro_torch.kernels.ucb import ref as uref
    from repro_torch.serve import session as smod
    if not bool(diff.any()):
        return 0
    idx, _, _ = smod._request_masks(sess.policy, sess.col, sess.state, uids)
    w, M, occ = sess.policy.gather_score(sess.state, idx)
    s_k, s_p = (uref.ucb_scores_ref(w[diff], M[diff], x[diff][:, None],
                                    occ[diff], sess.policy.cfg.hyper.alpha)
                [:, 0] for x in (x_k, x_p))
    assert bool(((s_k - s_p).abs() <= 1e-5 * (1 + s_p.abs())).all()), (
        f"{label}: the plain versions picked otherwise beyond near ties")
    return int(diff.sum())


@contextlib.contextmanager
def ops_watch(lockstep=False):
    """Wraps ``serve.session.recommend`` and ``recommend_catalog`` where
    the fault harness and the experiment call them, and yields a record:
    the last catalog request (session, users, catalog), the items of
    each catalog request, the torn publishes.  With ``lockstep`` each
    request is also served by the plain versions on the same session
    (and catalog) before the kernels serve it, and the kernels' result
    carries on: the decision ids must be equal, and where a choice or an
    item differs both picks must be near ties (``_picks_near``); each
    catalog request first holds topk to its plain version on the serving
    bank of that moment (``check_topk``)."""
    import torch
    from repro_torch.core import catalog as catalog_mod
    from repro_torch.serve import session as smod
    rec = {"last": None, "items": [], "torn": 0, "batches": 0,
           "after_publish": 0, "near_ties": 0, "topk_err": 0.0,
           "topk_ties": 0}
    orig_rec, orig_cat = smod.recommend, smod.recommend_catalog
    orig_torn = catalog_mod.torn_publish

    def recommend(sess, uids, ctx):
        got = orig_rec(sess, uids, ctx)
        if lockstep:
            with plain_path():
                want = orig_rec(sess, uids, ctx)
            assert torch.equal(got[2], want[2]), "lockstep: other ids"
            ar = torch.arange(uids.shape[0], device=uids.device)
            rec["near_ties"] += _picks_near(
                sess, uids, got[1] != want[1], ctx[ar, got[1].long()],
                ctx[ar, want[1].long()], "choose")
            rec["batches"] += 1
        return got

    def recommend_catalog(sess, uids, cat, *, k_short=64, clusters=None):
        rec["last"] = (sess, uids, cat)
        if lockstep:
            idx, _, _ = smod._request_masks(sess.policy, sess.col,
                                            sess.state, uids)
            w, M, occ = sess.policy.gather_score(sess.state, idx)
            r = check_topk(w, M, occ, cat.serving.emb, cat.serving.live,
                           sess.policy.cfg.hyper.alpha, k_short)
            rec["topk_err"] = max(rec["topk_err"], r["max_abs_err"])
            rec["topk_ties"] += r["near_ties"]
            with plain_path():
                want = orig_cat(sess, uids, cat, k_short=k_short,
                                clusters=clusters)
        got = orig_cat(sess, uids, cat, k_short=k_short, clusters=clusters)
        rec["items"].append(got[1])
        if lockstep:
            assert torch.equal(got[2], want[2]), "lockstep: other ids"
            ar = torch.arange(uids.shape[0], device=uids.device)
            rec["near_ties"] += _picks_near(
                sess, uids, got[1] != want[1], got[4][ar, got[3].long()],
                want[4][ar, want[3].long()], "catalog")
            rec["batches"] += 1
            rec["after_publish"] += int(cat.epoch > 0)
        return got

    def torn_publish(cat, keep, *col):
        rec["torn"] += 1
        return orig_torn(cat, keep, *col)

    with mock.patch.object(smod, "recommend", recommend), \
            mock.patch.object(smod, "recommend_catalog", recommend_catalog), \
            mock.patch.object(catalog_mod, "torn_publish", torn_publish):
        yield rec


def ops_guarded(dev, work, state, hyper, item_clusters):
    """Item 2: guarded catalog batches (pruned, recall probed), then the
    guarded sign-flip run, the bit-identical resume after a rollback and
    the costs of a snapshot, a rollback and a guarded transaction."""
    import dataclasses
    import shutil

    import torch
    from repro_torch import serve
    from repro_torch.core import env
    from repro_torch.serve import faults, guardrails
    from repro_torch.train.checkpoint import CheckpointManager
    shutil.rmtree(OPS_CKPT_DIR, ignore_errors=True)
    n, d = work.theta.shape
    K = hyper.n_candidates

    # phase 4s's first batches through a guarded, catalog-tracking session
    # on the cluster-pruned path, each probed against the direct shortlist
    gc = guardrails.Guarded.create(
        serve.OnlineBandit.from_offline(state, hyper,
                                        refresh_every=REFRESH_EVERY),
        CheckpointManager(OPS_CKPT_DIR / "catalog", keep=1),
        guardrails.GuardrailConfig(recall_floor=0.99, warmup=0,
                                   snapshot_every=10**9),
        catalog=work.catalog)
    skipped = 0
    for t in range(4):
        gc, items, _, rmet = gc.step_catalog(
            t, work.users[t], reward_fn=work.reward_fn, k_short=K_SHORT,
            probe_recall=True, clusters=item_clusters)
        assert torch.equal(items, work.items[t]), (
            "guarded pruned batch: other items than phase 4s")
        skipped += rmet.tiles_skipped
    log(f"ops guarded catalog: 4 cluster-pruned batches, recall probe "
        f"ema {gc.gs.ema_recall}, tiles skipped {skipped}, events "
        f"{gc.events}")
    assert gc.gs.ema_recall == 1.0 and not gc.gs.rollbacks

    kw = dict(batch=SERVE_BATCH, key=SEED + 1)
    _, clean = faults.run_faulted(ops_session(state, hyper), work.theta,
                                  OPS_GUARD_ROUNDS, faults.FaultSpec(), **kw)
    rate = clean.reward / clean.interactions
    cfg = guardrails.GuardrailConfig(ctr_floor=rate / 2,
                                     warmup=2 * SERVE_BATCH, ema=0.7,
                                     snapshot_every=4, cooldown=2)
    ckpt = CheckpointManager(OPS_CKPT_DIR / "slates", keep=2)
    g = guardrails.Guarded.create(ops_session(state, hyper), ckpt, cfg)
    spec = faults.FaultSpec(seed=SEED, p_flip=1.0, flip_after=OPS_FLIP_AFTER)
    t0 = time.perf_counter()
    g, rep = faults.run_faulted(g, work.theta, OPS_GUARD_ROUNDS, spec, **kw)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    rolls = [e for e in rep.events if e[0] == "rollback"]
    snaps = [e for e in rep.events if e[0] == "snapshot"]
    log(f"ops guarded sign-flip: {OPS_GUARD_ROUNDS} rounds x {SERVE_BATCH}"
        f", flip from round {OPS_FLIP_AFTER}, ctr_floor {rate / 2} (half "
        f"the clean rate {rate}); {len(snaps)} snapshots, {len(rolls)} "
        f"rollbacks, first {rolls[:1]}; reward {rep.reward} (clean "
        f"{clean.reward}); tx_per_s {rep.tx_per_s} (clean "
        f"{clean.tx_per_s}); {run_s} s")
    assert rolls and all(e[2] == ("ctr_floor",) for e in rolls), rep.events

    # poisoned feedback until the next rollback, then the restored
    # snapshot in a fresh session must serve what the guarded one serves
    stream = faults.TrafficStream(SEED + 2, SERVE_BATCH, n, K=K, d=d,
                                  device=dev)
    before, i = g.gs.rollbacks, 0
    while g.gs.rollbacks == before:
        u, c, uni = stream.slate_batch(i)
        g, ch, ids = g.recommend(u, c)
        g = g.observe_delayed(
            ids, -env.step_rewards(uni, work.theta[u.long()], c, ch)[0])
        i += 1
        assert i < 64, "the poisoned session never rolled back"
    step = g.events[-1][3]
    ref, got = ops_session(state, hyper).restore(ckpt, step)
    assert got == step
    for j in range(OPS_RESUME):
        u, c, uni = stream.slate_batch(100 + j)
        g, ch_g, ids_g = g.recommend(u, c)
        ref, ch_r, ids_r = serve.recommend(ref, u, c)
        assert torch.equal(ch_g, ch_r), "rolled-back session: other choices"
        r = env.step_rewards(uni, work.theta[u.long()], c, ch_r)[0]
        g = g.observe_delayed(ids_g, r)
        ref = serve.observe_delayed(ref, ids_r, r)
    for f in ("Minv", "b"):
        assert torch.equal(getattr(g.session.state, f),
                           getattr(ref.state, f)), f"rolled back: {f}"

    # costs: a snapshot (state to disk), a rollback (restore included), a
    # guarded transaction beside a bare one on the same batch
    ck_t = CheckpointManager(OPS_CKPT_DIR / "timing", keep=1)
    snap_ms = wall_ms(lambda: g.session.save(ck_t, 0), reps=3)
    roll_ms = wall_ms(lambda: g._rollback(g.session, None), reps=3)
    quiet = dataclasses.replace(g, cfg=cfg._replace(snapshot_every=10**9))
    u, c, _ = stream.slate_batch(200)
    guarded_ms = bare_ms = 0.0
    for _ in range(2):          # in turns
        guarded_ms += wall_ms(lambda: quiet.recommend(u, c)) / 2
        bare_ms += wall_ms(lambda: serve.recommend(g.session, u, c)) / 2
    state_bytes = sum(t.numel() * t.element_size()
                      for t in g.session.state if torch.is_tensor(t))
    log(f"ops guarded costs: snapshot {snap_ms} ms ({state_bytes} bytes of "
        f"state), rollback {roll_ms} ms (restore included), guarded "
        f"recommend {guarded_ms} ms against bare {bare_ms} ms on one batch "
        f"of {SERVE_BATCH}; resumed {OPS_RESUME} transactions bit-identical "
        f"to a session restored from step {step}")
    shutil.rmtree(OPS_CKPT_DIR, ignore_errors=True)
    return {"rollbacks": len(rolls), "snapshot_ms": snap_ms,
            "rollback_ms": roll_ms, "guarded_ms": guarded_ms,
            "bare_ms": bare_ms}


def ops_arms(dev, state, hyper, dccb_core, n, d):
    """Item 3's arms, each with its own ring: distclub on the learned
    users, dccb on phase 4b's state, a fresh linucb."""
    import torch
    from repro_torch import serve
    from repro_torch.serve import pending
    cfg = serve.make_cfg(n, d, hyper, refresh_every=REFRESH_EVERY, seed=SEED)
    dccb = serve.OnlineBandit(
        policy=serve.get_policy("dccb", cfg),
        state=serve.DCCBServeState(core=dccb_core, since_refresh=torch.zeros(
            (), dtype=torch.int32, device=dev)),
        pending=pending.init(OPS_PENDING, d, device=dev), ttl=OPS_TTL)
    linucb = serve.OnlineBandit.create(
        n, d, hyper, policy="linucb", pending_capacity=OPS_PENDING,
        pending_ttl=OPS_TTL, device=dev)
    return [ops_session(state, hyper), dccb, linucb]


def ops_experiment(dev, work, state, hyper, dccb_core, rounds, spec):
    """Item 3: the three arms over ``rounds`` batches of the seeded slate
    traffic, the spec's delivery faults on the merged decision stream
    (``faults.Harness``) and its sign flips on the linucb arm's feedback
    alone, as ``examples/ab_experiment.py`` poisons one arm: ``(exp,
    ExperimentReport, the choices of each round)``."""
    import numpy as np
    from repro_torch.core import env
    from repro_torch.serve import experiments, faults, guardrails
    n, d = work.theta.shape
    exp = experiments.create(
        ops_arms(dev, state, hyper, dccb_core, n, d),
        names=("distclub", "dccb", "linucb"), salt=SEED,
        selector=experiments.make_selector(3, epoch_rounds=10, floor=0.05),
        guard_cfg=guardrails.GuardrailConfig(
            ctr_floor=OPS_CTR_FLOOR, warmup=2 * SERVE_BATCH, ema=0.7,
            cooldown=2),
        snapshot_every=4)
    stream = faults.TrafficStream(SEED + 3, SERVE_BATCH, n,
                                  K=hyper.n_candidates, d=d, device=dev)
    h = faults.Harness(spec, SERVE_BATCH, dev)
    poisoned = exp.names.index("linucb")
    chosen = []

    def fold(ids, rs):
        nonlocal exp
        exp = experiments.observe_delayed(exp, ids, rs)

    t0 = guardrails.clock(exp.arms[0])
    for i in range(rounds):
        users, ctx, uniforms = stream.slate_batch(i)
        exp, choices, gids = experiments.recommend(exp, users, ctx)
        chosen.append(choices)
        h.n_tx += 1
        realized, expected, best, rand = env.step_rewards(
            uniforms, work.theta[users.long()], ctx, choices)
        gids_np = gids.cpu().numpy()
        valid = gids_np >= 0
        r_np = realized.cpu().numpy().astype(np.float32)
        r_del, lost, lag, dup = h.draw_faults(i, r_np)
        arms_np = np.where(valid, gids_np % exp.n_arms, -1)
        r_del = np.where(arms_np == poisoned, r_del, r_np)
        exp = experiments.record_feedback(
            exp, users.cpu().numpy(), arms_np, r_np,
            expected=expected.cpu().numpy(), best=best.cpu().numpy(),
            rand=rand.cpu().numpy(), learner_rewards=r_del)
        h.enqueue(i, gids_np, valid, r_del, lost, lag, dup)
        h.round_end(i, fold)
    h.drain(fold)
    dt = guardrails.clock(exp.arms[0]) - t0
    return exp, experiments.report(exp, rounds=rounds,
                                   tx_per_s=h.n_tx / dt), chosen


def ops_routing(dev, work, state, hyper, exp):
    """Item 3's costs and the one-arm parity: ms of a routed transaction
    beside the sum of its enabled arms' plain transactions on the same
    masked batches; one arm at fraction 1.0 bit-equal to the plain
    session over ``OPS_ONE_ARM`` batches."""
    import torch
    from repro_torch import serve
    from repro_torch.core import env
    from repro_torch.serve import experiments, faults
    n, d = work.theta.shape
    stream = faults.TrafficStream(SEED + 4, SERVE_BATCH, n,
                                  K=hyper.n_candidates, d=d, device=dev)
    u, c, _ = stream.slate_batch(0)
    arm_of = experiments.assign_arms(exp, u)
    routed_ms = wall_ms(lambda: experiments.recommend(exp, u, c))
    arms_ms = {exp.names[a]: wall_ms(lambda a=a: serve.recommend(
        exp.arms[a], torch.where(arm_of == a, u, -1), c))
        for a in range(exp.n_arms) if exp.enabled[a]}

    one = experiments.create([ops_session(state, hyper)])
    plain = ops_session(state, hyper)
    for t in range(OPS_ONE_ARM):
        u, c, uni = stream.slate_batch(1 + t)
        one, c_e, ids_e = experiments.recommend(one, u, c)
        plain, c_p, ids_p = serve.recommend(plain, u, c)
        assert torch.equal(c_e, c_p) and torch.equal(ids_e, ids_p), (
            "one-arm experiment: other choices or ids than the session")
        r = env.step_rewards(uni, work.theta[u.long()], c, c_p)[0]
        one = experiments.observe_delayed(one, ids_e, r)
        plain = serve.observe_delayed(plain, ids_p, r)
    for a, b in zip(list(one.arms[0].state) + list(one.arms[0].pending),
                    list(plain.state) + list(plain.pending)):
        assert torch.equal(a, b), "one-arm experiment: other state"
    return routed_ms, arms_ms


def run_together(clis, timeout_s, label) -> dict:
    """Each ``(name, argv)`` of ``clis`` as ``python argv`` from the repo
    root, all started together; each must exit with 0.  Returns each
    one's output."""
    import os
    env_vars = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen([sys.executable] + argv, cwd=ROOT,
                                    env=env_vars, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name, argv in clis}
    outs = {}
    try:
        for name, p in procs.items():
            outs[name] = p.communicate(timeout=timeout_s)[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for name, p in procs.items():
        tail = outs[name].strip().splitlines()[-4:]
        log(f"{label} {name}: exit {p.returncode}; last lines {tail}")
    log(f"{label}s: {time.perf_counter() - t0} s, run together")
    for name, p in procs.items():
        assert p.returncode == 0, f"{name} exited {p.returncode}"
    return outs


def ops_clis():
    """Item 5: the two CLIs and the example at their defaults, on the
    card, started together; each must exit with 0."""
    run_together(OPS_CLIS, OPS_CLI_TIMEOUT_S, "ops cli")


def ops_phase(dev, work, state, hyper, dccb_core, item_clusters):
    """Phase 4o: the operations layer at serving's full width (20480
    learned users, d 25, batches of 256, k_short 64), counted: a catalog
    run under churn and delivery faults beside its clean control
    (conservation after every delivery), guarded serving (pruned batches
    with the recall probe, a sign-flip run that must roll back and then
    resume bit-identically), a three-arm experiment whose poisoned
    linucb arm must be disabled, a one-arm experiment bit-equal to the
    plain session; then uncounted: topk held to its plain version on the
    churned bank of the catalog run's last request, the first rounds of
    the catalog run (every publish torn) and of the experiment with the
    plain versions in lockstep and then through the plain versions alone
    (``compare_paths``' bands), and the CLIs and the example.  Returns
    the launches of the counted part."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.serve import faults
    from repro_torch.serve import session as smod
    t_phase = time.perf_counter()
    n = work.theta.shape[0]
    cat_spec = faults.FaultSpec(seed=SEED, **OPS_DELIVERY, **OPS_CHURN)
    exp_spec = faults.FaultSpec(seed=SEED, **OPS_DELIVERY, p_flip=1.0,
                                flip_after=OPS_POISON_AFTER)
    torch.cuda.synchronize()
    _build.reset_launches()

    # ---- 1. catalog serving under churn and delivery faults ----------------
    # a short warm-up, then the faulted run and its clean control on the
    # same traffic in both orders
    ops_catalog_run(work, state, hyper, OPS_WARM_ROUNDS, cat_spec)
    runs = {"clean": [], "faulted": []}
    with ops_watch() as seen:
        for label in ("clean", "faulted", "faulted", "clean"):
            runs[label].append(ops_catalog_run(
                work, state, hyper, OPS_CATALOG_ROUNDS,
                cat_spec if label == "faulted" else faults.FaultSpec(
                    seed=SEED)))
            if label == "faulted" and len(runs[label]) == 1:
                final = seen["last"]
    (clean, _), (rep, _) = runs["clean"][0], runs["faulted"][0]
    st = rep.pending
    log(f"ops catalog churn: {OPS_CATALOG_ROUNDS} rounds x {SERVE_BATCH} "
        f"against {SERVE_ITEMS} items in {OPS_ITEMS} slots, k_short "
        f"{K_SHORT}, ring {OPS_PENDING} ttl {OPS_TTL}; matched_ratio "
        f"{st['matched'] / st['issued']}; reward_vs_clean_ratio "
        f"{rep.reward / clean.reward}; stale {st['stale']}; publishes "
        f"{rep.publishes}; items_added {rep.items_added} items_retired "
        f"{rep.items_retired}; pending {st}")
    for label, order in (("clean", "first, last"),
                         ("faulted", "second, third")):
        log(f"ops catalog churn {label} (run {order} of clean, faulted, "
            f"faulted, clean after a {OPS_WARM_ROUNDS}-round warm-up): "
            f"tx_per_s {[r.tx_per_s for r, _ in runs[label]]}; "
            f"transactions {[round(r.tx_per_s * s) for r, s in runs[label]]}"
            f"; s {[s for _, s in runs[label]]}")
    events = OPS_CATALOG_ROUNDS // OPS_CHURN["churn_every"] + 2
    assert rep.publishes == events, rep.publishes
    assert rep.items_added == (
        OPS_CATALOG_ROUNDS // OPS_CHURN["churn_every"] * OPS_CHURN["churn_add"]
        + OPS_CHURN["flash_crowd_size"]), rep.items_added
    assert rep.interactions == clean.interactions == (
        OPS_CATALOG_ROUNDS * SERVE_BATCH)
    assert final[2].epoch == events - 1, final[2].epoch
    assert st["stale"] > 0 and st["unmatched"] > 0, st
    assert rep.reward > 0.8 * clean.reward > 0, (rep.reward, clean.reward)

    # ---- 2. guardrails -----------------------------------------------------
    guard = ops_guarded(dev, work, state, hyper, item_clusters)

    # ---- 3. the experiment ---------------------------------------------------
    t0 = time.perf_counter()
    exp, er, _ = ops_experiment(dev, work, state, hyper, dccb_core,
                                OPS_EXP_ROUNDS, exp_spec)
    exp_s = time.perf_counter() - t0
    log(f"ops experiment: {OPS_EXP_ROUNDS} rounds x {SERVE_BATCH}, linucb "
        f"poisoned from round {OPS_POISON_AFTER}; {exp_s} s; enabled "
        f"{er.enabled}; final split {er.fractions}; leader {er.leader} vs "
        f"{er.runner_up} z {er.z_leading_pair}; events {er.events}")
    for i, name in enumerate(er.names):
        log(f"ops experiment arm {name}: reward {er.reward[i]} regret "
            f"{er.regret[i]} decisions {er.interactions[i]} delivered "
            f"{er.delivered[i]} matched_ratio {er.matched_ratio[i]}")
    log(f"ops experiment shares over time: {er.shares}")
    assert er.enabled == (True, True, False), er.events
    assert [e[2] for e in er.events if e[0].startswith("disable")] == [
        "linucb"], er.events
    assert sum(er.interactions) == OPS_EXP_ROUNDS * SERVE_BATCH
    routed_ms, arms_ms = ops_routing(dev, work, state, hyper, exp)
    log(f"ops experiment routing: routed recommend {routed_ms} ms against "
        f"the sum of its enabled arms' plain recommends "
        f"{sum(arms_ms.values())} ms ({arms_ms}); one arm at fraction 1.0 "
        f"bit-equal to the plain session over {OPS_ONE_ARM} batches")
    launches = dict(_build.LAUNCHES)
    log("ops_launches " + json.dumps(launches))
    for name in ("choose", "rank1_update_inv", "prune", "cc_hop", "topk",
                 "topk_pruned"):
        assert launches[name] > 0, (name, launches)

    # ---- 4. kernels against their plain versions ------------------------------
    # topk on the churned bank that served the faulted run's last request
    sess, uids, cat = final
    idx, _, _ = smod._request_masks(sess.policy, sess.col, sess.state, uids)
    w, M, occ = sess.policy.gather_score(sess.state, idx)
    res = check_topk(w, M, occ, cat.serving.emb, cat.serving.live,
                     hyper.alpha, K_SHORT)
    log(f"ops topk on the churned bank (epoch {cat.epoch}, "
        f"{int(cat.serving.live.sum())} live of {cat.capacity} slots): "
        f"{res}")
    # the first rounds of item 1 (every publish torn) and of item 3, the
    # plain versions in lockstep with the kernels, then alone
    lock_spec = cat_spec._replace(p_torn=1.0)
    t0 = time.perf_counter()
    with ops_watch(lockstep=True) as lk:
        k_rep, _ = ops_catalog_run(work, state, hyper, OPS_PLAIN_ROUNDS,
                                   lock_spec)
        k_exp, k_ch = ops_experiment(dev, work, state, hyper, dccb_core,
                                     OPS_PLAIN_ROUNDS, exp_spec)[1:]
    lock_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with plain_path():
        _build.reset_launches()
        with ops_watch() as pw:
            p_rep, _ = ops_catalog_run(work, state, hyper, OPS_PLAIN_ROUNDS,
                                       lock_spec)
            p_exp, p_ch = ops_experiment(dev, work, state, hyper, dccb_core,
                                         OPS_PLAIN_ROUNDS, exp_spec)[1:]
        assert not any(_build.LAUNCHES.values()), dict(_build.LAUNCHES)
    same_items = float(torch.mean(torch.cat(
        [(a == b).float() for a, b in zip(lk["items"], pw["items"])])))
    same_choices = float(torch.mean(torch.cat(
        [(a == b).float() for a, b in zip(k_ch, p_ch)])))
    log(f"ops lockstep: {lk['batches']} requests ({lk['after_publish']} "
        f"catalog requests after a publish, {lk['torn']} torn publishes), "
        f"picks differing at near ties {lk['near_ties']}; topk max_abs_err "
        f"{lk['topk_err']} near ties {lk['topk_ties']}; {lock_s} s")
    log(f"ops plain: {time.perf_counter() - t0} s for {OPS_PLAIN_ROUNDS} "
        f"rounds of the catalog run and of the experiment; identical "
        f"items {same_items}, identical choices {same_choices}")
    assert lk["torn"] >= 1 and lk["after_publish"] >= 1, lk
    assert pw["torn"] == lk["torn"], (pw["torn"], lk["torn"])
    assert len(lk["items"]) == len(pw["items"]) == OPS_PLAIN_ROUNDS
    assert same_items >= 0.95 and same_choices >= 0.95, (
        "ops: the plain path served other items or choices")
    compare_paths((k_rep.reward / k_rep.rand_reward, []),
                  (p_rep.reward / p_rep.rand_reward, []), n)
    compare_paths((sum(k_exp.reward) / sum(k_exp.rand_reward), []),
                  (sum(p_exp.reward) / sum(p_exp.rand_reward), []), n)
    assert p_rep.pending["issued"] == k_rep.pending["issued"]

    # ---- 5. the CLIs and the example -----------------------------------------
    ops_clis()
    log(f"ops phase: {time.perf_counter() - t_phase} s")
    return {"launches": launches, "guard": guard, "routed_ms": routed_ms,
            "arms_ms": arms_ms}


# ---------------------------------------------------------------------------
# phase 4x: the sharded runtime, one NCCL rank and four gloo ranks
# ---------------------------------------------------------------------------

SHARD_RANKS = 4              # gloo ranks sharing the one card
SHARD_DCCB_EPOCHS = 2
SHARD_TIMEOUT_S = 420        # each spawned group, its start included
SHARD_DELAYED_BATCHES = 8    # slate batches through the sharded ring
SHARD_POLICY_BATCHES = 4     # phase 4s's first batches, cold club / linucb
SHARD_POLICY_REFRESH = SHARD_POLICY_BATCHES * SERVE_BATCH   # stage 2 after
                                                            # the last batch
SHARD_SAVE_AT = 8            # batches before the sharded save
SHARD_RESUME = 4             # batches held equal after it
SHARD_CHURN_ROUNDS = 12      # phase 4o's churn run, cut from 48 rounds
SHARD_CHURN_CEILING = 0.05   # the guarded run's churn ceiling: its 12.5%
                             # retirement must roll back
SHARD_CKPT_DIR = ROOT / "build" / "chip_smoke_shard_ckpt"
SHARD_GUARD_DIR = ROOT / "build" / "chip_smoke_shard_guard"


class TimedCollectives:
    """``col`` with each primitive's wall time summed by name (the card
    synchronised before and after each call): where a warm epoch's time
    goes between the collectives and the rest."""

    def __init__(self, col):
        self.col, self.secs = col, {}
        self.n_shards = col.n_shards
        self.axis_index = col.axis_index

    def _timed(self, name, x):
        import torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = getattr(self.col, name)(x)
        torch.cuda.synchronize()
        self.secs[name] = self.secs.get(name, 0.0) + time.perf_counter() - t0
        return out

    def all_gather(self, x):
        return self._timed("all_gather", x)

    def psum(self, x):
        return self._timed("psum", x)


def shard_distclub(col, dev, inp, caught):
    """The paper configuration through ``distclub_shard`` on this rank:
    the first epoch's stage 1 through the runtime's own stage body
    (uncounted), then ``EPOCHS`` epochs counted, then one warm epoch
    timed, and one more with its collectives timed.  ``caught`` gets the
    arguments of the counted run's first prune and first cc_hop."""
    import torch
    from repro_torch.configs import distclub_paper as paper
    from repro_torch.core import env, env_ops
    from repro_torch.core.backend import BackendConfig, GraphBackend
    from repro_torch.core.types import Metrics
    from repro_torch.distributed import distclub_shard
    from repro_torch.kernels import _build
    from repro_torch.runtime import collectives, stages
    n, d, hyper = paper.N_USERS, paper.D_FEAT, paper.CONFIG
    theta = torch.from_numpy(inp["theta"]).to(dev)
    ops = env_ops.synthetic_ops(env.SyntheticEnv(theta, hyper.n_candidates))
    init, epoch = distclub_shard.make_runtime(col, n, d, hyper, ops,
                                              device=dev)
    state = init()
    row0 = col.axis_index() * state.occ.shape[0]
    stage1 = stages.personalized_rounds(
        BackendConfig.create().interact(), ops, hyper, SEED, 0, state.Minv,
        state.b, state.occ, state.u_rounds, row0)[:3]
    stage1 = [col.all_gather(t) for t in stage1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    collectives.reset_bytes()
    t0 = time.perf_counter()
    metrics, n_clu = [], []
    with first_args(GraphBackend, "prune_rows", "cc_hop") as args:
        for e in range(EPOCHS):
            state, m, c = epoch(state, SEED, e)
            metrics.append(m)
            n_clu.append(c)
            if e == 0:   # the first stage 2's graph: stages 3, 4 keep it
                first = state.adj, state.labels
    torch.cuda.synchronize()
    caught.update(args)
    wall = time.perf_counter() - t0
    out = dict(launches=dict(_build.LAUNCHES), sent=dict(collectives.BYTES),
               peak=torch.cuda.max_memory_allocated(), wall=wall)
    t0 = time.perf_counter()
    epoch(state, SEED, EPOCHS)
    torch.cuda.synchronize()
    steady = time.perf_counter() - t0
    timed = TimedCollectives(col)
    t0 = time.perf_counter()
    distclub_shard.build_epoch_fn(timed, n, d, hyper, ops, dev)(
        state, SEED, EPOCHS)
    torch.cuda.synchronize()
    return out | dict(
        steady=steady, timed_epoch=time.perf_counter() - t0,
        collective_secs=timed.secs, stage1=stage1,
        first_adj=col.all_gather(first[0]), first_labels=first[1],
        state=distclub_shard.gather_state(state, col),
        metrics=Metrics(*(torch.cat(v) for v in zip(*metrics))),
        n_clusters=torch.stack(n_clu))


def shard_dccb(col, dev, inp):
    """``dccb_shard`` at the paper configuration, L = buffer_size,
    ``SHARD_DCCB_EPOCHS`` epochs, counted."""
    import torch
    from repro_torch.configs import distclub_paper as paper
    from repro_torch.core import env, env_ops
    from repro_torch.core.types import Metrics
    from repro_torch.distributed import dccb_shard
    from repro_torch.kernels import _build
    from repro_torch.runtime import collectives
    n, d, hyper = paper.N_USERS, paper.D_FEAT, paper.CONFIG
    theta = torch.from_numpy(inp["theta"]).to(dev)
    ops = env_ops.synthetic_ops(env.SyntheticEnv(theta, hyper.n_candidates))
    init, epoch = dccb_shard.make_runtime(col, n, d, hyper.buffer_size,
                                          hyper, ops, device=dev)
    state = init()
    torch.cuda.synchronize()
    _build.reset_launches()
    collectives.reset_bytes()
    t0 = time.perf_counter()
    metrics = []
    for e in range(SHARD_DCCB_EPOCHS):
        state, m = epoch(state, SEED, e)
        metrics.append(m)
    torch.cuda.synchronize()
    return dict(wall=time.perf_counter() - t0,
                launches=dict(_build.LAUNCHES),
                sent=dict(collectives.BYTES),
                metrics=Metrics(*(torch.cat(v) for v in zip(*metrics))),
                comm_bytes=state.comm_bytes, occ=state.occ,
                finite=all(bool(torch.isfinite(t).all())
                           for t in (state.Mw, state.bw, state.xbuf)))


def shard_serve(col, dev, inp, caught):
    """Phase 4s's traffic through ``OnlineBandit.from_offline(..., col=)``
    on this rank's users and its item slice, unpruned and then pruned,
    each counted (``caught`` gets the arguments of each run's first
    shortlist); then phase 4s's first batch through a cold
    ``OnlineBandit.sharded`` session (uncounted)."""
    import torch
    from repro_torch import convert, serve
    from repro_torch.configs import distclub_paper as paper
    from repro_torch.core import catalog, env
    from repro_torch.core.backend import RetrievalBackend
    from repro_torch.kernels import _build
    from repro_torch.runtime import collectives
    hyper = paper.CONFIG
    state = convert.state_from_numpy(inp["state"], device=dev)
    theta, users, uniforms, emb = (torch.from_numpy(inp[k]).to(dev) for k in
                                   ("theta", "users", "uniforms", "emb"))
    full = serve.make_catalog(emb)
    cat = catalog.item_shard(full, col.axis_index(), col.n_shards)
    clusters = serve.build_clusters(full, tile_items=512, n_anchors=512)

    def reward_fn(key, uids, ctx, slot):
        return env.step_rewards(uniforms[key], theta[uids.long()], ctx, slot)

    out = {}
    for label, cl, method in (("unpruned", None, "shortlist"),
                              ("pruned", clusters, "shortlist_pruned")):
        sess = serve.OnlineBandit.from_offline(
            state, hyper, refresh_every=REFRESH_EVERY, col=col)
        torch.cuda.synchronize()
        _build.reset_launches()
        collectives.reset_bytes()
        items, secs, refreshed = [], [], []
        with first_args(RetrievalBackend, method) as args:
            for t in range(SERVE_BATCHES):
                t0 = time.perf_counter()
                res = serve.step_catalog(sess, t, users[t], cat, reward_fn,
                                         k_short=K_SHORT, clusters=cl)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                sess, item = res[:2]
                items.append(item)
                if int(sess.state.since_refresh) == 0:
                    refreshed.append(t)
        out[label] = dict(items=torch.stack(items), secs=secs,
                          refreshed=refreshed,
                          launches=dict(_build.LAUNCHES),
                          sent=dict(collectives.BYTES))
        caught.update(args)

    cold = serve.OnlineBandit.sharded(col, theta.shape[0], emb.shape[1],
                                      hyper, refresh_every=REFRESH_EVERY,
                                      device=dev)
    cold, item, m = serve.step_catalog(cold, 0, users[0], cat, reward_fn,
                                       k_short=K_SHORT)
    out["cold"] = dict(items=item, reward=m.reward, Minv=cold.state.Minv,
                       b=cold.state.b, occ=cold.state.occ)

    # delayed feedback on the sharded session (a replicated ring): each
    # batch recommended, then observed with delay 0, beside the
    # synchronous step on the same slates, counted
    slates = torch.from_numpy(inp["slates"]).to(dev)
    sync = serve.OnlineBandit.from_offline(
        state, hyper, refresh_every=REFRESH_EVERY, col=col)
    split = serve.OnlineBandit.from_offline(
        state, hyper, refresh_every=REFRESH_EVERY, col=col,
        pending_capacity=2 * SERVE_BATCH, pending_ttl=16)
    torch.cuda.synchronize()
    _build.reset_launches()
    choices = []
    for t in range(SHARD_DELAYED_BATCHES):
        u, c = users[t], slates[t]
        sync, ch_a, _ = serve.step(sync, t, u, c, reward_fn)
        split, ch_b, ids = serve.recommend(split, u, c)
        assert torch.equal(ch_a, ch_b), "sharded split: other choices"
        split = serve.observe_delayed(split, ids,
                                      reward_fn(t, u, c, ch_b)[0])
        choices.append(ch_b)
    for a, b in zip(sync.state, split.state):
        assert torch.equal(a, b), "sharded split: other state than step"
    out["delayed"] = dict(choices=torch.stack(choices),
                          launches=dict(_build.LAUNCHES),
                          pending=serve.pending_stats(split),
                          ring=tuple(split.pending),
                          refreshed=int(split.state.since_refresh) == 0)
    return out


def _serving_inputs(col, dev, inp):
    """Phase 4's state, phase 4s's traffic and this rank's slice of its
    catalog, on this rank."""
    import torch
    from repro_torch import convert, serve
    from repro_torch.core import catalog, env
    state = convert.state_from_numpy(inp["state"], device=dev)
    theta, users, uniforms, emb = (torch.from_numpy(inp[k]).to(dev) for k in
                                   ("theta", "users", "uniforms", "emb"))
    cat = catalog.item_shard(serve.make_catalog(emb), col.axis_index(),
                             col.n_shards)

    def reward_fn(key, uids, ctx, slot):
        return env.step_rewards(uniforms[key], theta[uids.long()], ctx, slot)

    return state, users, cat, reward_fn


def shard_policies(col, dev, inp):
    """Cold ``OnlineBandit.sharded`` sessions of the club and linucb
    policies through phase 4s's first ``SHARD_POLICY_BATCHES`` batches,
    each counted, stage 2 (club) over ``col`` after the last one."""
    import torch
    from repro_torch import serve
    from repro_torch.configs import distclub_paper as paper
    from repro_torch.kernels import _build
    from repro_torch.runtime import collectives
    _, users, cat, reward_fn = _serving_inputs(col, dev, inp)
    out = {}
    for policy in ("club", "linucb"):
        sess = serve.OnlineBandit.sharded(
            col, paper.N_USERS, paper.D_FEAT, paper.CONFIG, policy=policy,
            refresh_every=SHARD_POLICY_REFRESH, device=dev)
        torch.cuda.synchronize()
        _build.reset_launches()
        collectives.reset_bytes()
        items, rewards, secs = [], [], []
        for t in range(SHARD_POLICY_BATCHES):
            t0 = time.perf_counter()
            sess, item, m = serve.step_catalog(sess, t, users[t], cat,
                                               reward_fn, k_short=K_SHORT)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            items.append(item)
            rewards.append(m.reward)
        out[policy] = dict(items=torch.stack(items),
                           reward=torch.stack(rewards), secs=secs,
                           launches=dict(_build.LAUNCHES),
                           sent=dict(collectives.BYTES),
                           refreshed=int(sess.state.since_refresh) == 0,
                           labels=getattr(sess.state, "labels", None))
    return out


def shard_ckpt(col, dev, inp):
    """The learned sharded session (``from_offline(..., col=)``) serves
    ``SHARD_SAVE_AT`` of phase 4s's batches, is saved (rank 0 writes the
    global arrays), and serves ``SHARD_RESUME`` more; a fresh session on
    the same ranks restores it and serves those batches again.  The
    serving is counted."""
    import torch
    from repro_torch import serve
    from repro_torch.configs import distclub_paper as paper
    from repro_torch.kernels import _build
    from repro_torch.train.checkpoint import CheckpointManager
    state, users, cat, reward_fn = _serving_inputs(col, dev, inp)
    ck = CheckpointManager(SHARD_CKPT_DIR, keep=1)
    hyper = paper.CONFIG

    def run(sess, lo, hi):
        items = []
        for t in range(lo, hi):
            sess, item, _ = serve.step_catalog(sess, t, users[t], cat,
                                               reward_fn, k_short=K_SHORT)
            items.append(item)
        return sess, items

    sess = serve.OnlineBandit.from_offline(
        state, hyper, refresh_every=REFRESH_EVERY, col=col)
    torch.cuda.synchronize()
    _build.reset_launches()
    sess, _ = run(sess, 0, SHARD_SAVE_AT)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess.save(ck, SHARD_SAVE_AT)
    torch.cuda.synchronize()
    save_s = time.perf_counter() - t0
    end = SHARD_SAVE_AT + SHARD_RESUME
    _, unbroken = run(sess, SHARD_SAVE_AT, end)
    fresh = serve.OnlineBandit.sharded(col, paper.N_USERS, paper.D_FEAT,
                                       hyper, refresh_every=REFRESH_EVERY,
                                       device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored, step = fresh.restore(ck)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    assert step == SHARD_SAVE_AT, step
    _, again = run(restored, SHARD_SAVE_AT, end)
    torch.cuda.synchronize()
    return dict(save_s=save_s, restore_s=restore_s,
                unbroken=torch.stack(unbroken), restored=torch.stack(again),
                launches=dict(_build.LAUNCHES))


def shard_guarded(col, dev, inp):
    """A ``Guarded`` sharded session tracking its catalog slice: two
    healthy batches with the recall probe (a snapshot after the second),
    a third batch, then a retirement of 12.5% of the catalog that breaches
    ``SHARD_CHURN_CEILING`` and rolls state and catalog back, and the
    third batch again.  Counted."""
    import torch
    from repro_torch import serve
    from repro_torch.configs import distclub_paper as paper
    from repro_torch.kernels import _build
    from repro_torch.serve import guardrails
    from repro_torch.train.checkpoint import CheckpointManager
    state, users, cat, reward_fn = _serving_inputs(col, dev, inp)
    sess = serve.OnlineBandit.from_offline(
        state, paper.CONFIG, refresh_every=REFRESH_EVERY, col=col)
    cfg = guardrails.GuardrailConfig(
        recall_floor=0.99, warmup=0, churn_ceiling=SHARD_CHURN_CEILING,
        snapshot_every=2, cooldown=1)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    g = guardrails.Guarded.create(sess, CheckpointManager(SHARD_GUARD_DIR,
                                                          keep=2),
                                  cfg, catalog=cat)
    torch.cuda.synchronize()
    snapshot_s = time.perf_counter() - t0
    for t in range(3):
        g, served, _ = g.step_catalog(t, users[t], reward_fn=reward_fn,
                                      k_short=K_SHORT, probe_recall=True)
    recall, snapshots = g.gs.ema_recall, g.events
    g, _ = g.stage_churn(retire=torch.arange(SERVE_ITEMS // 8, device=dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g = g.publish()
    torch.cuda.synchronize()
    rollback_s = time.perf_counter() - t0
    events = g.events
    g, again, _ = g.step_catalog(2, users[2], reward_fn=reward_fn,
                                 k_short=K_SHORT)
    torch.cuda.synchronize()
    return dict(served=served, again=again, recall=recall,
                snapshots=snapshots, events=events, snapshot_s=snapshot_s,
                rollback_s=rollback_s, epoch=g.catalog.epoch,
                n_live=g.catalog.n_live(col),
                launches=dict(_build.LAUNCHES))


def shard_churn(col, dev, inp, caught):
    """Phase 4o's churn run on this rank's users and its slice of the
    ``OPS_ITEMS`` slots, ``SHARD_CHURN_ROUNDS`` rounds, conservation
    asserted after every delivery, counted; ``caught`` gets the last
    request's rows and churned slice for rank 0's topk check."""
    import torch
    from repro_torch import convert, serve
    from repro_torch.configs import distclub_paper as paper
    from repro_torch.core import catalog, env
    from repro_torch.kernels import _build
    from repro_torch.runtime import collectives
    from repro_torch.serve import faults
    from repro_torch.serve import session as smod
    state = convert.state_from_numpy(inp["state"], device=dev)
    e = convert.record_from_numpy(inp["env"], env.CatalogEnv, device=dev)
    sess = serve.OnlineBandit.from_offline(
        state, paper.CONFIG, refresh_every=REFRESH_EVERY, col=col,
        pending_capacity=OPS_PENDING, pending_ttl=OPS_TTL)
    cat = catalog.item_shard(
        serve.make_catalog(env.catalog_embeddings(e), capacity=OPS_ITEMS),
        col.axis_index(), col.n_shards)
    spec = faults.FaultSpec(seed=SEED, **OPS_DELIVERY, **OPS_CHURN)
    torch.cuda.synchronize()
    _build.reset_launches()
    collectives.reset_bytes()
    with ops_watch() as seen:
        t0 = time.perf_counter()
        sess, rep = faults.run_faulted_catalog(
            sess, e, SHARD_CHURN_ROUNDS, spec, catalog=cat, k_short=K_SHORT,
            batch=SERVE_BATCH, key=SEED, assert_conservation=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    launches, sent = dict(_build.LAUNCHES), dict(collectives.BYTES)
    last, uids, churned = seen["last"]
    w, M, occ = smod._request_rows(last.policy, col, last.state, uids)[:3]
    caught["churn"] = (w, M, occ, churned.serving.emb, churned.serving.live,
                       paper.CONFIG.alpha)
    return dict(report=rep, secs=secs, launches=launches, sent=sent,
                torn=seen["torn"], epoch=churned.epoch,
                n_live=churned.n_live(col))


def shard_checks(caught, inp):
    """The kernels at this rank's shard shapes against their plain
    versions on the same inputs: prune and cc_hop on the counted DistCLUB
    run's first stage 2 (its local rows against every user), topk on the
    unpruned serving run's first batch over the rank's item slice
    (``row0_items`` past it), topk_pruned on the pruned run's first batch
    over the rank's ``shard_slice`` of the sorted stream."""
    import torch
    from repro_torch.core import clustering
    adj, v_i, occ_i, v_j, occ_j, gamma = caught["prune_rows"]
    w, Minv, occ, items, live, alpha = caught["shortlist"][:6]
    emb = torch.from_numpy(inp["emb"]).to(w.device)
    return {
        "prune": check_prune(adj, v_i, clustering.cb_width(occ_i), v_j,
                             clustering.cb_width(occ_j), gamma),
        "cc_hop": check_cc_hop(*caught["cc_hop"]),
        "topk": check_topk(w, Minv, occ, items, live, alpha, K_SHORT),
        "topk_pruned": check_topk_piece(*caught["shortlist_pruned"], emb,
                                        k=K_SHORT),
        "topk_churned": check_topk(*caught["churn"], K_SHORT),
        "shapes": {"prune": (tuple(adj.shape), tuple(v_j.shape)),
                   "topk": (tuple(w.shape), tuple(items.shape)),
                   "topk_pruned": tuple(
                       caught["shortlist_pruned"][3].shape),
                   "topk_churned": tuple(caught["churn"][3].shape)}}


def shard_rank(rank, col, dev, inp):
    """Phase 4x on one rank (``launch.mesh.spawn``): DistCLUB, then, where
    ``inp`` asks, DCCB, serving, the club and linucb sessions, save and
    restore, a guarded rollback and the churn run, and on rank 0, after
    every timed run, the kernels at its shard shapes against their plain
    versions."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    caught = {}
    out = {"distclub": shard_distclub(col, dev, inp, caught)}
    if "state" in inp:
        out["dccb"] = shard_dccb(col, dev, inp)
        out["serve"] = shard_serve(col, dev, inp, caught)
        out["policies"] = shard_policies(col, dev, inp)
        out["ckpt"] = shard_ckpt(col, dev, inp)
        out["guarded"] = shard_guarded(col, dev, inp)
        out["churn"] = shard_churn(col, dev, inp, caught)
        if rank == 0:
            out["checks"] = shard_checks(caught, inp)
    return out


def serve_near_ties(work, items, alpha) -> int:
    """Phase 4s's one-process session again, batch by batch: its items must
    be phase 4s's; where the sharded run's ``items`` differ, both items'
    plain UCB scores under the one-process statistics of that batch must
    lie within ``check_topk``'s band.  Returns the differences."""
    import torch
    from repro_torch import serve
    from repro_torch.kernels.ucb import ref as uref
    sess, n_diff = work.start, 0
    emb = work.catalog.serving.emb
    for t in range(SERVE_BATCHES):
        uids = work.users[t]
        w, M, occ = sess.policy.gather_score(sess.state, uids.long())
        sess, item, _ = serve.step_catalog(sess, t, uids, work.catalog,
                                           work.reward_fn, k_short=K_SHORT)
        assert torch.equal(item, work.items[t]), "phase 4s: other items"
        diff = item != torch.from_numpy(items[t]).to(item.device)
        if bool(diff.any()):
            got = torch.from_numpy(items[t]).to(item.device)[diff].long()
            s_one, s_shard = (uref.ucb_scores_ref(
                w[diff], M[diff], emb[i][:, None], occ[diff], alpha)[:, 0]
                for i in (item[diff].long(), got))
            assert bool(((s_one - s_shard).abs()
                         <= 1e-5 * (1 + s_one.abs())).all()), (
                "sharded serving: items differ beyond near ties")
            n_diff += int(diff.sum())
    return n_diff


def shard_phase(dev, main, work):
    """Phase 4x: ``distclub_shard`` at the paper configuration on one NCCL
    rank (bit-equal to phase 4) and on four gloo ranks sharing the card
    (bit-equal through the first stage 2, then within ``compare_paths``'
    bands), ``dccb_shard`` and the sharded serving session on the four.
    ``main`` holds phase 4's results.  Returns the launches summed over
    the counted runs of every rank."""
    import numpy as np
    import torch
    from repro_torch import convert, serve
    from repro_torch.configs import distclub_paper as paper
    from repro_torch.core import distclub
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh
    from repro_torch.runtime import stages
    n, d, hyper = paper.N_USERS, paper.D_FEAT, paper.CONFIG
    R, L = hyper.max_rounds, hyper.buffer_size
    state, ops = main["state"], main["ops"]

    # phase 4's first stage 1 and first stage 2, one process (uncounted)
    s1 = distclub.stage1(distclub.init_state(n, d, hyper, device=dev), ops,
                         SEED, 0, hyper)[0]
    s2 = distclub.stage2(s1, hyper, d)
    ref1 = [t.cpu().numpy() for t in (s1.lin.Minv, s1.lin.b, s1.lin.occ)]
    ref2 = [t.cpu().numpy() for t in (s2.graph.adj, s2.graph.labels)]
    ph4 = {"Minv": state.lin.Minv, "b": state.lin.b, "occ": state.lin.occ,
           "adj": state.graph.adj, "labels": state.graph.labels,
           "u_rounds": state.u_rounds, "c_rounds": state.c_rounds,
           "comm_bytes": state.comm_bytes}
    ph4 = {k: v.cpu().numpy() for k, v in ph4.items()}
    rr4 = main["reward"] / main["rand"]
    clu4 = main["n_clusters"].tolist()
    theta = work.theta.cpu().numpy()
    total = dict.fromkeys(_build.LAUNCHES, 0)

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    def bit_equal(got, want, what):
        for g, w, f in zip(got, want, what):
            assert np.array_equal(g, w), f"phase 4x: {f} differs"

    # ---- one NCCL rank: bit-equal to phase 4 --------------------------------
    t0 = time.perf_counter()
    (one,) = mesh.spawn(shard_rank, 1, "nccl", args=({"theta": theta},),
                        timeout=SHARD_TIMEOUT_S)
    one = one["distclub"]
    g = one["state"]
    log(f"shard nccl x1: spawn+run {time.perf_counter() - t0} s; ms per "
        f"epoch {1e3 * one['wall'] / EPOCHS} (phase 4 "
        f"{1e3 * main['wall'] / EPOCHS}); warm epoch {1e3 * one['steady']} "
        f"ms (phase 4 {1e3 * main['steady']}); with its collectives timed "
        f"{1e3 * one['timed_epoch']} ms, of which "
        f"{({k: 1e3 * v for k, v in one['collective_secs'].items()})} ms; "
        f"bytes moved {one['sent']}; "
        f"max_memory_allocated={one['peak']}; launches {one['launches']}")
    bit_equal(one["stage1"], ref1, ("stage-1 Minv", "stage-1 b",
                                    "stage-1 occ"))
    bit_equal([getattr(g, k) for k in ph4], list(ph4.values()),
              [f"nccl x1 {k}" for k in ph4])
    for f in one["metrics"]._fields:
        assert np.array_equal(getattr(one["metrics"], f), getattr(
            main["metrics"], f).cpu().numpy()), f"nccl x1 metrics {f}"
    assert one["n_clusters"].tolist() == clu4, (one["n_clusters"], clu4)
    assert one["launches"] == main["launches"], (one["launches"],
                                                 main["launches"])
    add(one["launches"])

    # ---- four gloo ranks on the one card ------------------------------------
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    slates = unit(torch.randn(SHARD_DELAYED_BATCHES, SERVE_BATCH,
                              hyper.n_candidates, d, generator=g,
                              device=dev))
    serve_inp = {"theta": theta, "users": work.users.cpu().numpy(),
                 "uniforms": work.uniforms.cpu().numpy(),
                 "emb": work.catalog.serving.emb.cpu().numpy(),
                 "state": convert.state_to_numpy(state),
                 "slates": slates.cpu().numpy(),
                 "env": convert.record_to_numpy(work.env)}
    for path in (SHARD_CKPT_DIR, SHARD_GUARD_DIR):
        shutil.rmtree(path, ignore_errors=True)
    t0 = time.perf_counter()
    outs = mesh.spawn(shard_rank, SHARD_RANKS, "gloo", dev,
                      args=(serve_inp,), timeout=SHARD_TIMEOUT_S)
    log(f"shard gloo x{SHARD_RANKS} on one card (not a scaling figure: the "
        f"ranks share the card): spawn+run {time.perf_counter() - t0} s")
    runs = [o["distclub"] for o in outs]
    r0 = runs[0]
    bit_equal(r0["stage1"], ref1, ("gloo stage-1 Minv", "gloo stage-1 b",
                                   "gloo stage-1 occ"))
    bit_equal([r0["first_adj"], r0["first_labels"]], ref2,
              ("gloo first stage-2 adjacency", "gloo first stage-2 labels"))
    for r in runs:
        distclub_counts(r["launches"], R, EPOCHS, n, "gloo distclub")
        add(r["launches"])
        assert np.array_equal(r["state"].labels, r0["state"].labels)
    m = r0["metrics"]
    rr = float(m.reward.sum()) / float(m.rand_reward.sum())
    compare_paths((rr4, clu4), (rr, r0["n_clusters"].tolist()), n)
    gs = r0["state"]
    sent = [sum(r["sent"].values()) for r in runs]
    log(f"shard gloo distclub: reward/random={rr} (phase 4 {rr4}) "
        f"clusters={r0['n_clusters'].tolist()} (phase 4 {clu4}); users "
        f"whose occ differs from phase 4's: {int((gs.occ != ph4['occ']).sum())}"
        f", whose label differs: "
        f"{int((gs.labels != ph4['labels']).sum())}; ms per epoch by rank "
        f"{[1e3 * r['wall'] / EPOCHS for r in runs]}, warm epoch ms "
        f"{[1e3 * r['steady'] for r in runs]}; max_memory_allocated by "
        f"rank {[r['peak'] for r in runs]}")
    log(f"shard gloo distclub: a warm epoch with its collectives timed "
        f"(synchronised), by rank: ms {[1e3 * r['timed_epoch'] for r in runs]}"
        f", of which collectives ms "
        f"{[{k: 1e3 * v for k, v in r['collective_secs'].items()} for r in runs]}")
    log(f"shard gloo distclub bytes moved per epoch, by rank: "
        f"{[{k: v / EPOCHS for k, v in r['sent'].items()} for r in runs]}; "
        f"all ranks {sum(sent) / EPOCHS}; modelled comm_bytes per epoch "
        f"{stages.stage2_comm_bytes(n, d)}")
    assert float(gs.comm_bytes) == float(ph4["comm_bytes"])
    for t in (gs.Minv, gs.b):
        assert np.isfinite(t).all(), "gloo distclub: non-finite state"

    # ---- dccb_shard on the four ranks ---------------------------------------
    dc = [o["dccb"] for o in outs]
    m = dc[0]["metrics"]
    rr_d = float(m.reward.sum()) / float(m.rand_reward.sum())
    want = SHARD_DCCB_EPOCHS * n * (L + 1) * (d * d + d) * 4
    log(f"shard gloo dccb: L={L} epochs={SHARD_DCCB_EPOCHS} "
        f"reward/random={rr_d} comm_bytes={float(dc[0]['comm_bytes'])} "
        f"(model {want}); ring bytes by rank "
        f"{[r['sent']['permute'] for r in dc]}; ms per epoch by rank "
        f"{[1e3 * r['wall'] / SHARD_DCCB_EPOCHS for r in dc]}")
    assert float(dc[0]["comm_bytes"]) == want, (dc[0]["comm_bytes"], want)
    assert rr_d > 0.98, f"dccb_shard reward/random {rr_d}"
    assert int(m.interactions.sum()) == n * L * SHARD_DCCB_EPOCHS
    for r in dc:
        assert r["finite"], "dccb_shard: non-finite state"
        assert r["launches"]["choose"] == L * SHARD_DCCB_EPOCHS, r["launches"]
        assert sum(r["launches"].values()) == L * SHARD_DCCB_EPOCHS
        add(r["launches"])

    # ---- the sharded serving session on the four ranks ----------------------
    sv = [o["serve"] for o in outs]
    u = sv[0]["unpruned"]
    for r in sv:
        for label in ("unpruned", "pruned"):
            assert np.array_equal(r[label]["items"], u["items"]), label
            assert r[label]["refreshed"] == u["refreshed"], label
            lc = r[label]["launches"]
            topk = "topk" if label == "unpruned" else "topk_pruned"
            assert lc[topk] == lc["choose"] == SERVE_BATCHES, lc
            assert lc["rank1_update_inv"] == SERVE_BATCHES, lc
            assert lc["prune"] == len(u["refreshed"]) >= 1, lc
            assert sum(lc.values()) == 3 * SERVE_BATCHES + lc["prune"] \
                + lc["cc_hop"], lc
            add(lc)
    first = u["refreshed"][0]
    for t in range(first + 1):
        assert np.array_equal(u["items"][t], work.items[t].cpu().numpy()), (
            f"sharded serving: batch {t}, before the first refresh, served "
            "other items than phase 4s")
    ties = serve_near_ties(work, u["items"], hyper.alpha)
    for label in ("unpruned", "pruned"):
        secs = [r[label]["secs"] for r in sv]
        log(f"shard gloo serve {label}: refreshes after batches "
            f"{u['refreshed']}; items equal to phase 4s's through batch "
            f"{first}; items differing after it (near ties) {ties}; median "
            f"batch ms by rank {[1e3 * statistics.median(s) for s in secs]}; "
            f"bytes moved by rank {[r[label]['sent'] for r in sv]}; "
            f"launches (rank 0) {sv[0][label]['launches']}")

    # ---- a cold OnlineBandit.sharded session against a one-process one ------
    cold, item, m = serve.step_catalog(
        serve.OnlineBandit.create(n, d, hyper, refresh_every=REFRESH_EVERY,
                                  device=dev),
        0, work.users[0], work.catalog, work.reward_fn, k_short=K_SHORT)
    sc = [r["cold"] for r in sv]
    errs = {f: float(np.abs(np.concatenate([c[f] for c in sc])
                            - getattr(cold.state, f).cpu().numpy()).max())
            for f in ("Minv", "b")}
    log(f"shard gloo serve, cold OnlineBandit.sharded x{SHARD_RANKS}: "
        f"batch 0's items equal to a one-process OnlineBandit.create's "
        f"on every rank: {all(np.array_equal(c['items'], item.cpu().numpy()) for c in sc)}; "
        f"reward {[float(c['reward']) for c in sc]} (one process "
        f"{float(m.reward)}); state max abs err {errs}")
    for c in sc:
        assert np.array_equal(c["items"], item.cpu().numpy()), (
            "cold sharded session: other items than one process")
        assert float(c["reward"]) == float(m.reward), "cold: other reward"
    assert np.array_equal(np.concatenate([c["occ"] for c in sc]),
                          cold.state.occ.cpu().numpy()), "cold: other occ"
    assert max(errs.values()) <= 1e-6, errs

    # ---- delayed feedback on the sharded session ----------------------------
    one = serve.OnlineBandit.from_offline(state, hyper,
                                          refresh_every=REFRESH_EVERY)
    dl = [r["delayed"] for r in sv]
    for t in range(SHARD_DELAYED_BATCHES):
        one, ch, _ = serve.step(one, t, work.users[t], slates[t],
                                work.reward_fn)
        for r in dl:
            assert np.array_equal(r["choices"][t], ch.cpu().numpy()), (
                f"sharded delayed feedback: batch {t}, other choices than "
                "one process")
    st = dl[0]["pending"]
    log(f"shard gloo serve, delayed feedback x{SHARD_RANKS}: "
        f"{SHARD_DELAYED_BATCHES} slate batches recommended then observed "
        f"(delay 0), bit-equal to the synchronous step on every rank, "
        f"choices equal to one process; refreshed at the end "
        f"{dl[0]['refreshed']}; ring {st}; launches (rank 0) "
        f"{dl[0]['launches']}")
    assert st["matched"] == SHARD_DELAYED_BATCHES * SERVE_BATCH, st
    assert st["in_flight"] == 0 and st["unmatched"] == 0, st
    for r in dl:
        assert r["pending"] == st, "sharded ring: ranks differ"
        for a, b in zip(r["ring"], dl[0]["ring"]):
            assert np.array_equal(a, b), "sharded ring: ranks differ"
        lc = r["launches"]
        assert lc["choose"] == lc["rank1_update_inv"] == (
            2 * SHARD_DELAYED_BATCHES), lc
        add(lc)

    shard_policies_check(dev, work, outs, add)
    shard_ckpt_check(dev, work, state, outs, add)
    shard_guarded_check(outs, add)
    shard_churn_check(work, state, outs, add)

    # ---- rank 0's kernels at its shard shapes against their plain versions --
    ck = outs[0]["checks"]
    log(f"shard gloo rank 0, kernels at its shard shapes {ck['shapes']} "
        f"against their plain versions: prune {ck['prune']}; cc_hop "
        f"{ck['cc_hop']}; topk {ck['topk']}; topk_pruned "
        f"{ck['topk_pruned']}; topk on the churned slice "
        f"{ck['topk_churned']}")
    n_loc, n_items = n // SHARD_RANKS, SERVE_ITEMS // SHARD_RANKS
    assert ck["shapes"]["prune"] == ((n_loc, -(-n // 32)), (n, d)), ck
    assert ck["shapes"]["topk"] == ((SERVE_BATCH, d), (n_items, d)), ck
    assert ck["shapes"]["topk_pruned"] == (n_items, d), ck
    assert ck["shapes"]["topk_churned"] == (OPS_ITEMS // SHARD_RANKS, d), ck
    return total


def shard_policies_check(dev, work, outs, add):
    """The cold club and linucb sessions on the four ranks against
    ``OnlineBandit.create`` of the same policy in this process."""
    import numpy as np
    import torch
    from repro_torch import serve
    from repro_torch.configs import distclub_paper as paper
    n, d, hyper = paper.N_USERS, paper.D_FEAT, paper.CONFIG
    for policy in ("club", "linucb"):
        runs = [o["policies"][policy] for o in outs]
        one = serve.OnlineBandit.create(n, d, hyper, policy=policy,
                                        refresh_every=SHARD_POLICY_REFRESH,
                                        device=dev)
        secs = []
        for t in range(SHARD_POLICY_BATCHES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one, item, m = serve.step_catalog(one, t, work.users[t],
                                              work.catalog, work.reward_fn,
                                              k_short=K_SHORT)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            for r in runs:
                assert np.array_equal(r["items"][t], item.cpu().numpy()), (
                    f"sharded {policy}: batch {t}, other items than one "
                    "process")
                assert float(r["reward"][t]) == float(m.reward), (
                    f"sharded {policy}: batch {t}, other reward")
        same_labels = None
        if policy == "club":
            assert int(one.state.since_refresh) == 0
            same_labels = all(np.array_equal(r["labels"],
                                             one.state.labels.cpu().numpy())
                              for r in runs)
        for r in runs:
            lc = r["launches"]
            assert lc["topk"] == lc["choose"] == SHARD_POLICY_BATCHES, lc
            assert lc["rank1_update_inv"] == SHARD_POLICY_BATCHES, lc
            assert r["refreshed"] == (policy == "club"), policy
            if policy == "club":
                assert lc["prune"] >= 1 and lc["cc_hop"] >= 1, lc
            else:
                assert lc["prune"] == lc["cc_hop"] == 0, lc
            add(lc)
        log(f"shard gloo {policy} x{SHARD_RANKS}: cold "
            f"OnlineBandit.sharded, {SHARD_POLICY_BATCHES} batches of "
            f"{SERVE_BATCH}, items and reward equal to one process's in "
            f"every batch; stage 2 over the ranks after the last batch: "
            f"{runs[0]['refreshed']} (labels equal to one process's: "
            f"{same_labels}); ms per batch by rank "
            f"{[[1e3 * x for x in r['secs']] for r in runs]} (one process "
            f"{[1e3 * x for x in secs]}); bytes moved by rank "
            f"{[r['sent'] for r in runs]}; launches (rank 0) "
            f"{runs[0]['launches']}")


def shard_ckpt_check(dev, work, state, outs, add):
    """The sharded save and its restores: on the four ranks, and onto
    one process on this card, each resumes with the unbroken run's
    items."""
    import numpy as np
    import torch
    from repro_torch import serve
    from repro_torch.configs import distclub_paper as paper
    from repro_torch.train.checkpoint import CheckpointManager
    runs = [o["ckpt"] for o in outs]
    want = runs[0]["unbroken"]
    for r in runs:
        assert np.array_equal(r["unbroken"], want), "ranks: other items"
        assert np.array_equal(r["restored"], want), (
            "sharded restore on the four ranks: other items than the "
            "unbroken run")
        lc = r["launches"]
        assert lc["topk"] == lc["choose"] == SHARD_SAVE_AT + 2 * SHARD_RESUME
        add(lc)
    tmpl = serve.OnlineBandit.from_offline(state, paper.CONFIG,
                                           refresh_every=REFRESH_EVERY)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one, step = tmpl.restore(CheckpointManager(SHARD_CKPT_DIR))
    torch.cuda.synchronize()
    restore_ms = 1e3 * (time.perf_counter() - t0)
    assert step == SHARD_SAVE_AT, step
    for j, t in enumerate(range(SHARD_SAVE_AT, SHARD_SAVE_AT + SHARD_RESUME)):
        one, item, _ = serve.step_catalog(one, t, work.users[t],
                                          work.catalog, work.reward_fn,
                                          k_short=K_SHORT)
        assert np.array_equal(item.cpu().numpy(), want[j]), (
            f"restore onto one process: batch {t}, other items than the "
            "unbroken sharded run")
    nbytes = sum(t.nbytes for t in one.state)
    as_4s = all(np.array_equal(want[j], work.items[t].cpu().numpy())
                for j, t in enumerate(range(SHARD_SAVE_AT,
                                            SHARD_SAVE_AT + SHARD_RESUME)))
    log(f"shard gloo checkpoint x{SHARD_RANKS}: saved after batch "
        f"{SHARD_SAVE_AT} ({nbytes} bytes of global state, rank 0 writing), "
        f"restored onto the {SHARD_RANKS} ranks and onto one process: the "
        f"next {SHARD_RESUME} batches equal the unbroken run's on both "
        f"(and phase 4s's: {as_4s}); save ms by rank "
        f"{[1e3 * r['save_s'] for r in runs]}, restore ms by rank "
        f"{[1e3 * r['restore_s'] for r in runs]}, one-process restore ms "
        f"{restore_ms} (phase 4o, one process: snapshot 269-338, rollback "
        f"333-393)")


def shard_guarded_check(outs, add):
    """The guarded rollback on the four ranks: the same events on each,
    the snapshot pair's items served again, the recall probe 1.0."""
    import numpy as np
    runs = [o["guarded"] for o in outs]
    for r in runs:
        assert r["recall"] == 1.0, f"guarded sharded: recall {r['recall']}"
        assert np.array_equal(r["again"], r["served"]), (
            "guarded sharded: the restored pair served other items than "
            "the snapshot pair")
        assert r["events"][-1][0] == "rollback", r["events"]
        assert r["events"][-1][2] == ("churn_ceiling",), r["events"]
        assert r["events"] == runs[0]["events"], "ranks: other events"
        add(r["launches"])
    log(f"shard gloo guarded x{SHARD_RANKS}: recall probe ema "
        f"{runs[0]['recall']} on healthy batches; events "
        f"{runs[0]['events']}; after the rollback epoch "
        f"{runs[0]['epoch']}, live items {runs[0]['n_live']}; the restored "
        f"pair served the snapshot pair's items; snapshot ms by rank "
        f"{[1e3 * r['snapshot_s'] for r in runs]} (state and catalog, "
        f"gathered), rollback ms by rank "
        f"{[1e3 * r['rollback_s'] for r in runs]}; launches (rank 0) "
        f"{runs[0]['launches']}")


def shard_churn_check(work, state, outs, add):
    """The item-sharded churn run on the four ranks against phase 4o's
    one-process run of the same rounds on this card."""
    from repro_torch.configs import distclub_paper as paper
    from repro_torch.serve import faults
    spec = faults.FaultSpec(seed=SEED, **OPS_DELIVERY, **OPS_CHURN)
    one, one_s = ops_catalog_run(work, state, paper.CONFIG,
                                 SHARD_CHURN_ROUNDS, spec)
    runs = [o["churn"] for o in outs]
    for r in runs:
        rep = r["report"]
        for f in ("pending", "interactions", "delivered", "publishes",
                  "items_added", "items_retired", "reward", "expected"):
            assert getattr(rep, f) == getattr(one, f), (
                f"sharded churn: {f} {getattr(rep, f)} against one "
                f"process's {getattr(one, f)}")
        assert r["launches"]["topk"] == SHARD_CHURN_ROUNDS, r["launches"]
        add(r["launches"])
    rep = runs[0]["report"]
    log(f"shard gloo churn x{SHARD_RANKS}: {SHARD_CHURN_ROUNDS} rounds of "
        f"phase 4o's mix on {OPS_ITEMS // SHARD_RANKS} slots a rank, "
        f"conservation after every delivery; pending, publishes, items "
        f"added and retired, reward equal to one process's: {rep.pending}; "
        f"publishes {rep.publishes} ({runs[0]['torn']} torn); added "
        f"{rep.items_added}, retired {rep.items_retired}; reward "
        f"{rep.reward}; tx/s by rank {[r['report'].tx_per_s for r in runs]}"
        f" (one process {one.tx_per_s}; not a scaling figure: the ranks "
        f"share one card); s by rank {[r['secs'] for r in runs]} (one "
        f"process {one_s}); final epoch {runs[0]['epoch']}, live items "
        f"{runs[0]['n_live']}; bytes moved by rank "
        f"{[r['sent'] for r in runs]}; launches (rank 0) "
        f"{runs[0]['launches']}")


def algo_line(name, secs, inter, rr, comm, clusters, peak):
    """One line of the paper's comparison (bench_paper.py's columns)."""
    per = None if comm is None else comm / inter
    log(f"baseline {name}: us/interaction={1e6 * secs / inter} "
        f"interactions={inter} reward/random={rr} "
        f"comm_bytes/interaction={per} clusters={clusters} "
        f"max_memory_allocated={peak}")


def baselines_phase(dev, ops, hyper, d, distclub_inter, graphs):
    """Phase 4b: CLUB and DCCB at the paper configuration's full width on
    the phase-4 environment, counted (CLUB's adjacency at each network
    update into ``graphs``), then through the plain versions on the card,
    then profiled.  Returns what phases 5 and 6 need."""
    import torch
    from repro_torch.core import club, clustering, dccb
    from repro_torch.kernels import _build
    n = ops.n_users
    L = hyper.buffer_size

    # ---- CLUB: CLUB_T sequential interactions ------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    with cc_graphs("club", graphs):
        (c_state, c_m), c_s = timed(lambda: club.run(ops, SEED, hyper,
                                                     CLUB_T, d, device=dev))
    c_launch = dict(_build.LAUNCHES)
    c_peak = torch.cuda.max_memory_allocated()
    c_rr = float(c_m.reward.sum()) / float(c_m.rand_reward.sum())
    c_clu = int(clustering.num_clusters(c_state.graph.labels))
    algo_line("club", c_s, CLUB_T, c_rr, None, c_clu, c_peak)
    log(f"club launches: {c_launch}")
    updates = CLUB_T // hyper.delta_net
    assert c_launch["ucb"] == CLUB_T, c_launch
    assert c_launch["rank1_update"] == 2 * CLUB_T, c_launch
    assert c_launch["prune"] == updates, c_launch
    assert updates <= c_launch["cc_hop"] <= updates * n, c_launch
    assert sum(c_launch.values()) == (3 * CLUB_T + updates
                                      + c_launch["cc_hop"]), c_launch
    assert int(c_state.lin.occ.sum()) == CLUB_T
    for t in (*c_state.lin, *c_state.clusters[:3], c_m.reward):
        assert bool(torch.isfinite(t.float()).all()), "club: non-finite"

    # ---- DCCB: epochs of L rounds, as many interactions as phase 4 ---------
    epochs = max(1, round(distclub_inter / (n * L)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    (b_state, b_m, b_clu), b_s = timed(lambda: dccb.run(
        ops, SEED, hyper, epochs, d, L, device=dev))
    b_launch = dict(_build.LAUNCHES)
    b_peak = torch.cuda.max_memory_allocated()
    b_inter = int(b_m.interactions.sum())
    b_rr = float(b_m.reward.sum()) / float(b_m.rand_reward.sum())
    algo_line("dccb", b_s, b_inter, b_rr, float(b_state.comm_bytes),
              b_clu.tolist(), b_peak)
    log(f"dccb: L={L} epochs={epochs} launches: {b_launch}")
    at_init = int((b_state.bw.abs().amax(dim=1) == 0).sum())
    log(f"dccb users at w = 0 after the run (reset by a gossip cut or "
        f"never popped): {at_init} of {n}")
    assert b_inter == epochs * L * n
    assert b_launch["choose"] == epochs * L, b_launch
    assert sum(b_launch.values()) == b_launch["choose"], b_launch
    acc = torch.zeros((), dtype=torch.float32)      # the f32 accumulator
    for _ in range(epochs):
        acc = acc + torch.tensor(float(n * (L + 1) * (d * d + d) * 4))
    assert float(b_state.comm_bytes) == float(acc), float(b_state.comm_bytes)
    for t in (b_state.Mw, b_state.bw, b_state.Mbuf, b_m.reward):
        assert bool(torch.isfinite(t).all()), "dccb: non-finite"

    # ---- both through the plain versions on the card -----------------------
    _build.reset_launches()
    with plain_path():
        (cp_state, cp_m), cp_s = timed(lambda: club.run(
            ops, SEED, hyper, CLUB_T, d, device=dev))
        (_, bp_m, bp_clu), bp_s = timed(lambda: dccb.run(
            ops, SEED, hyper, epochs, d, L, device=dev))
    assert not any(_build.LAUNCHES.values()), dict(_build.LAUNCHES)
    log(f"baselines plain: club {cp_s} s, dccb {bp_s} s")
    compare_paths(
        (c_rr, [c_clu]),
        (float(cp_m.reward.sum()) / float(cp_m.rand_reward.sum()),
         [int(clustering.num_clusters(cp_state.graph.labels))]), n)
    compare_paths(
        (b_rr, b_clu.tolist()),
        (float(bp_m.reward.sum()) / float(bp_m.rand_reward.sum()),
         bp_clu.tolist()), n)

    # ---- profiles: a CLUB window ending in a network update, a DCCB epoch --
    def club_window():
        return club.run(ops, SEED, hyper, hyper.delta_net, d, device=dev,
                        state=c_state, t0=CLUB_T)
    _, w_s = timed(club_window)
    profile_batch(f"club window of {hyper.delta_net} interactions and one "
                  "network update", club_window, w_s)

    def dccb_epoch():
        return dccb.epoch(dccb.clone(b_state), ops, SEED, epochs, hyper, d,
                          L)
    _, e_s = timed(dccb_epoch)
    profile_batch("dccb epoch", dccb_epoch, e_s)
    return {"club": c_state, "dccb": b_state, "club_launches": c_launch,
            "dccb_launches": b_launch}


@contextlib.contextmanager
def host_tensors():
    """Count, by function, every torch call made inside that returns a
    tensor on the host (``TorchFunctionMode``); yields the counts."""
    import collections
    import torch
    from torch.overrides import TorchFunctionMode
    hits = collections.Counter()

    class Spy(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor) and t.device.type == "cpu":
                    hits[getattr(func, "__name__", str(func))] += 1
            return out

    with Spy():
        yield hits


def distclub_counts(launches, R, epochs, n, label):
    """The launches a DistCLUB run of ``epochs`` makes, and no other."""
    assert launches["choose"] == 2 * R * epochs, (label, launches)
    assert launches["rank1_update_inv"] == 2 * R * epochs, (label, launches)
    assert launches["prune"] == epochs, (label, launches)
    assert epochs <= launches["cc_hop"] <= epochs * n, (label, launches)
    assert sum(launches.values()) == 4 * R * epochs + epochs \
        + launches["cc_hop"], (label, launches)


def clones_phase(dev) -> dict:
    """Phase 4d: the paper's dataset clones under every environment kind,
    then the baselines and the quickstart on them; returns the launches
    of every kernel over the phase's counted runs."""
    import torch
    from repro_torch.configs import distclub_paper as paper
    from repro_torch.core import club, clustering, dccb, distclub
    from repro_torch.data import datasets
    from repro_torch.kernels import _build
    t_phase = time.perf_counter()
    total = {k: 0 for k in KERNEL_INFO}
    hyper = paper.CONFIG
    R = hyper.max_rounds
    for name in CLONES:
        spec = datasets.PAPER_DATASETS[name]
        assert spec.n_candidates == hyper.n_candidates
        n, d = spec.n_users, spec.d
        epochs = datasets.epochs_for(spec, hyper)
        for kind in ENV_KINDS:
            t0 = time.perf_counter()
            ops, _ = datasets.make_env(spec, seed=SEED, kind=kind,
                                       device=dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launches()
            with host_tensors() as hits:
                state, m, clu = distclub.run(ops, SEED, hyper, epochs, d,
                                             device=dev)
                torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)
            peak = torch.cuda.max_memory_allocated()
            label = f"{name} {kind}"
            assert not hits, f"{label}: tensors on the host: {dict(hits)}"
            distclub_counts(launches, R, epochs, n, label)
            for t in (*state.lin, m.reward):
                assert bool(torch.isfinite(t.float()).all()), label
            inter = int(m.interactions.sum())
            rr = float(m.reward.sum()) / float(m.rand_reward.sum())
            assert rr > 1.0, f"{label}: reward/random {rr}"
            for k in total:
                total[k] += launches[k]
            t_run = time.perf_counter()
            # one more epoch from the run's state, warm; once more profiled
            _, steady_s = timed(lambda: distclub.epoch(
                state, ops, SEED, epochs, hyper, d))
            busy_us, kernels = device_kernels(lambda: distclub.epoch(
                state, ops, SEED, epochs, hyper, d))
            t_prof = time.perf_counter()
            if name == "synthetic":      # where the paper-scale epoch goes
                for ev in kernels[:8]:
                    log(f"  {label}: {ev.self_device_time_total / 1e3:10.3f} "
                        f"ms {ev.count:6d}x  {ev.key[:80]}")
            plain = ""
            if name != "synthetic":
                _build.reset_launches()
                with plain_path():
                    _, pm, pc = distclub.run(ops, SEED, hyper, epochs, d,
                                             device=dev)
                assert not any(_build.LAUNCHES.values()), (
                    label, dict(_build.LAUNCHES))
                prr = float(pm.reward.sum()) / float(pm.rand_reward.sum())
                compare_paths((rr, clu.tolist()), (prr, pc.tolist()), n)
                plain = f" plain reward/random={prr} clusters={pc.tolist()}"
            log(f"clone {label}: n={n} d={d} K={spec.n_candidates} "
                f"interactions={inter} epochs={epochs} "
                f"ms/epoch={1e3 * steady_s} device_ms/epoch={busy_us / 1e3} "
                f"busy={busy_us / (steady_s * 1e6)} reward/random={rr} "
                f"clusters={clu.tolist()} "
                f"comm_bytes={float(state.comm_bytes)} "
                f"max_memory_allocated={peak} "
                f"seconds={time.perf_counter() - t0} (build and counted run "
                f"{t_run - t0}, warm and profiled epochs {t_prof - t_run}) "
                f"launches={launches}" + plain)
    # the baselines on the movielens clone, bench_paper.py's CLUB slice and
    # DCCB buffer; DCCB for its interaction budget's epochs
    spec = datasets.PAPER_DATASETS["movielens"]
    n, d = spec.n_users, spec.d
    dccb_epochs = max(1, BENCH_MOVIELENS_BUDGET // (n * BENCH_DCCB_L))
    for kind in ENV_KINDS[1:]:
        ops, _ = datasets.make_env(spec, seed=SEED, kind=kind, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        (cs, cm), c_s = timed(lambda: club.run(ops, SEED, hyper, CLUB_T, d,
                                               device=dev))
        launches = dict(_build.LAUNCHES)
        updates = CLUB_T // hyper.delta_net
        assert launches["ucb"] == CLUB_T and launches["prune"] == updates
        assert launches["rank1_update"] == 2 * CLUB_T, launches
        assert sum(launches.values()) == 3 * CLUB_T + updates \
            + launches["cc_hop"], launches
        assert bool(torch.isfinite(cs.lin.Minv).all())
        algo_line(f"club movielens {kind}", c_s, CLUB_T,
                  float(cm.reward.sum()) / float(cm.rand_reward.sum()), None,
                  int(clustering.num_clusters(cs.graph.labels)),
                  torch.cuda.max_memory_allocated())
        for k in total:
            total[k] += launches[k]
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        (bs, bm, bclu), b_s = timed(lambda: dccb.run(
            ops, SEED, hyper, dccb_epochs, d, BENCH_DCCB_L, device=dev))
        launches = dict(_build.LAUNCHES)
        assert launches["choose"] == sum(launches.values()) \
            == dccb_epochs * BENCH_DCCB_L, launches
        assert bool(torch.isfinite(bs.Mw).all())
        b_inter = int(bm.interactions.sum())
        assert b_inter == dccb_epochs * BENCH_DCCB_L * n
        algo_line(f"dccb movielens {kind}", b_s, b_inter,
                  float(bm.reward.sum()) / float(bm.rand_reward.sum()),
                  float(bs.comm_bytes), bclu.tolist(),
                  torch.cuda.max_memory_allocated())
        for k in total:
            total[k] += launches[k]
    # the quickstart on the card
    sys.path.insert(0, str(ROOT / "examples"))
    import quickstart_torch as qs
    _build.reset_launches()
    (q_state, q_m, q_clu), q_s = timed(lambda: qs.main("cuda"))
    launches = dict(_build.LAUNCHES)
    distclub_counts(launches, qs.HYPER.max_rounds, qs.N_EPOCHS, qs.N_USERS,
                    "quickstart")
    assert q_clu.shape == (qs.N_EPOCHS,) and q_m.reward.is_cuda
    for k in total:
        total[k] += launches[k]
    log(f"quickstart: {q_s} s, launches {launches}")
    log(f"clones phase: {time.perf_counter() - t_phase} s, launches {total}")
    return total


def dcn_traffic(g, cfg, batch, dev):
    """The JAX package's synthetic DCN-v2 traffic (``repro.launch.train``):
    dense features N(0, 1), sparse ids uniform over each field's vocab."""
    import torch
    return (torch.randn(batch, cfg.n_dense, generator=g, device=dev),
            torch.randint(0, cfg.vocab_per_field, (batch, cfg.n_sparse),
                          generator=g, device=dev, dtype=torch.int32))


def dcn_term_scale(model, dense, sparse):
    """Per logit, sum_j |both_j final_j| through the plain versions: the
    size of the terms the logit adds up, against which its rounding is
    measured (a logit can cancel to near 0 while its terms are large)."""
    import torch
    from repro_torch.kernels.cross import ref as cref
    from repro_torch.models import layers
    from repro_torch.models.recsys import dcn_v2
    x0 = dcn_v2.interaction_input(model, dense, sparse)
    xl = x0
    for lyr in model.cross:
        xl = cref.cross_layer_ref(x0, xl, lyr.W, lyr.b)
    deep = layers.mlp([(lyr.w, lyr.b) for lyr in model.deep], x0,
                      final_act=True)
    return (torch.cat([xl, deep], dim=-1).abs() @ model.final.abs())[:, 0]


def timed(fn):
    """``(fn(), seconds)``, the host clock around a synchronised call."""
    import torch
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def recsys_phase(dev):
    """Phase 4r; returns what phases 5 and 6 need."""
    import torch
    from repro_torch import configs
    from repro_torch.configs import recsys_shapes
    from repro_torch.kernels import _build
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models.recsys import dcn_v2, embedding, mind, seqrec
    g = torch.Generator(device=dev).manual_seed(SEED + 3)

    # ---- DCN-v2 at its published config ----------------------------------
    spec = configs.get("dcn-v2")
    cfg = spec.cfg
    torch.cuda.reset_peak_memory_stats()
    model, secs = timed(lambda: dcn_v2.DCNv2(cfg, seed=SEED, device=dev))
    log(f"dcn-v2: {sum(p.numel() for p in model.parameters())} parameters "
        f"(tables {tuple(model.tables.shape)}), d_interact={cfg.d_interact}, "
        f"init {secs} s")
    batches = [("serve_p99", dcn_traffic(g, cfg, recsys_shapes.P99_B, dev))
               for _ in range(P99_BATCHES)]
    batches += [("serve_bulk", dcn_traffic(g, cfg, recsys_shapes.BULK_B, dev))
                for _ in range(BULK_BATCHES)]
    for shape, (dense, sparse) in batches[P99_BATCHES - 1:P99_BATCHES + 1]:
        want = spec.input_specs(shape)
        assert (tuple(dense.shape), dense.dtype) == want["dense_feats"]
        assert (tuple(sparse.shape), sparse.dtype) == want["sparse_ids"]
    # one uncounted batch of each size first: cuBLAS's and the caching
    # allocator's first-call costs stay out of the times
    for i in (0, P99_BATCHES):
        dcn_v2.dcn_fwd(model, *batches[i][1])
    torch.cuda.synchronize()
    _build.reset_launches()
    logits, secs = [], {"serve_p99": [], "serve_bulk": []}
    for shape, (dense, sparse) in batches:
        out, s = timed(lambda: dcn_v2.dcn_fwd(model, dense, sparse))
        logits.append(out)
        secs[shape].append(s)
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for shape, s in secs.items():
        log(f"dcn-v2 {shape}: ms per batch {[1e3 * x for x in s]} "
            f"median {1e3 * statistics.median(s)}")
    log(f"dcn-v2 launches: {launches} max_memory_allocated={peak}")
    # three cross launches a batch; the tensor route's batches (serve_bulk)
    # each also split three Ws; nothing else launches
    from repro_torch.kernels.cross import ops as cops
    sms = _build.sm_count(dev.index or 0)
    tensor = sum(cops.route(dense.shape[0], cfg.d_interact, sms)
                 == cops.TENSOR for _, (dense, _) in batches)
    assert launches["cross"] == cfg.n_cross_layers * len(batches), launches
    assert launches["cross_split"] == cfg.n_cross_layers * tensor, launches
    assert sum(launches.values()) == (launches["cross"]
                                      + launches["cross_split"]), launches
    for out, (_, (dense, _)) in zip(logits, batches):
        assert out.shape == (dense.shape[0],) and out.dtype == torch.float32
        assert bool(torch.isfinite(out).all()), "non-finite DCN logits"
    for shape in ("serve_p99", "serve_bulk"):
        bs = [b for b in batches if b[0] == shape]
        profile_batch(f"dcn-v2 {shape}",
                      lambda: dcn_v2.dcn_fwd(model, *bs[0][1]),
                      statistics.median(secs[shape]))

    # ---- the same batches through the plain versions ------------------------
    # Each cross element is a 429-term f32 dot product and each logit a
    # 941-term one; cuBLAS and the kernel sum them in other orders, an
    # error of ~sqrt(n) 2^-24 (~1e-6) of the terms' absolute sum per
    # product, compounded over 3 layers and the head: 2e-5 of the logit's
    # term scale, the kernel's own tolerance, bounds it with room.
    _build.reset_launches()
    worst = 0.0
    with plain_path():
        for out, (_, (dense, sparse)) in zip(logits, batches):
            plain = dcn_v2.dcn_fwd(model, dense, sparse)
            scale = dcn_term_scale(model, dense, sparse)
            ratio = float(((out - plain).abs() / (1 + scale)).max())
            worst = max(worst, ratio)
    assert not any(_build.LAUNCHES.values()), dict(_build.LAUNCHES)
    log(f"dcn-v2 kernel vs plain logits: max |d| / (1 + term scale) = "
        f"{worst} over {len(batches)} batches (limit 2e-5)")
    assert worst <= 2e-5, "DCN logits: kernel and plain paths disagree"

    # ---- EmbeddingBag through the embedding module's entry point ----------
    table = model.tables[0]                   # one field's [2^20, 16] table
    bags = {}
    for n_bags in (recsys_shapes.P99_B, recsys_shapes.BULK_B):
        idx = torch.randint(0, cfg.vocab_per_field, (n_bags, BAG_L),
                            generator=g, device=dev, dtype=torch.int32)
        wt = torch.rand(n_bags, BAG_L, generator=g, device=dev)
        wt[:, int(0.8 * BAG_L):] = 0.0
        bags[n_bags] = (idx, wt)
    torch.cuda.synchronize()
    _build.reset_launches()
    for n_bags, (idx, wt) in bags.items():
        out, s = timed(lambda: embedding.bag_lookup(table, idx, wt))
        assert out.shape == (n_bags, cfg.embed_dim)
        assert bool(torch.isfinite(out).all())
        log(f"bag_lookup: {n_bags} bags of {BAG_L}: {1e3 * s} ms")
    bag_launches = dict(_build.LAUNCHES)
    log(f"bag_lookup launches: {bag_launches}")
    assert bag_launches["embedding_bag"] == len(bags), bag_launches

    # ---- SASRec, BERT4Rec, MIND: serve_p99 and retrieval_cand -------------
    x0_bulk = dcn_v2.interaction_input(model, *batches[-1][1])
    run = {"model": model, "x0_bulk": x0_bulk,
           "x0_p99": dcn_v2.interaction_input(model, *batches[0][1]),
           "bags": bags, "launches": launches, "bag_launches": bag_launches}
    fns = {"sasrec": (seqrec.SeqRec, seqrec.score_candidates,
                      seqrec.retrieval_scores),
           "bert4rec": (seqrec.SeqRec, seqrec.score_candidates,
                        seqrec.retrieval_scores),
           "mind": (mind.MIND, mind.mind_serve, mind.mind_retrieval)}
    _build.reset_launches()
    for arch, (cls, serve_fn, retr_fn) in fns.items():
        spec = configs.get(arch)
        torch.cuda.reset_peak_memory_stats()
        m = cls(spec.cfg, seed=SEED, device=dev)

        def inputs(shape):
            (hs, hd), (cs, cd) = (spec.input_specs(shape)[k]
                                  for k in ("hist", "cand"))
            return (torch.randint(1, spec.cfg.n_items, hs, generator=g,
                                  device=dev, dtype=hd),
                    torch.randint(0, spec.cfg.n_items, cs, generator=g,
                                  device=dev, dtype=cd))
        s_p99 = []
        for _ in range(SEQ_BATCHES):
            hist, cand = inputs("serve_p99")
            scores, s = timed(lambda: serve_fn(m, hist, cand))
            s_p99.append(s)
            assert scores.shape == cand.shape, scores.shape
            assert bool(torch.isfinite(scores).all()), f"{arch}: non-finite"
        hist, cand = inputs("retrieval_cand")
        scores, s_retr = timed(lambda: retr_fn(m, hist, cand))
        assert scores.shape == cand.shape and scores.dtype == torch.float32
        assert bool(torch.isfinite(scores).all()), f"{arch}: non-finite"
        log(f"{arch}: serve_p99 ms per batch {[1e3 * x for x in s_p99]} "
            f"median {1e3 * statistics.median(s_p99)}; retrieval_cand "
            f"({cand.shape[0]} candidates) {1e3 * s_retr} ms; "
            f"max_memory_allocated={torch.cuda.max_memory_allocated()}")
        del m
    assert not any(_build.LAUNCHES.values()), dict(_build.LAUNCHES)

    # ---- the serving CLI's recsys path at its defaults --------------------
    # The CLI draws its world on the host, so the card serves the requests
    # of the CPU run: reward/random must be > 1 and within 1% of the CPU's
    # (choices part only where the two devices round a near tie apart).
    args = serve_cli.parse_args([])
    spec = configs.get(args.arch)
    ratio, s = timed(lambda: serve_cli.serve_recsys(spec, args, device=dev))
    cli_launches = dict(_build.LAUNCHES)
    ratio_cpu = serve_cli.serve_recsys(spec, args, device="cpu")
    log(f"serve_recsys ({args.arch}, {args.policy}, {args.steps} x "
        f"{args.batch}): reward/random={ratio} in {s} s (CPU run: "
        f"{ratio_cpu}), launches {cli_launches}")
    assert ratio > 1.0, "serve_recsys does no better than random"
    assert abs(ratio - ratio_cpu) <= 0.01 * ratio_cpu, (
        "serve_recsys: the card and the CPU part")
    assert cli_launches["choose"] == args.steps, cli_launches
    return run


def smi_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def capture_attention(calls):
    """Record the arguments of the given calls (by index) of
    ``flash_ops.attention`` while it runs as it is."""
    from repro_torch.kernels.flash import ops as fops
    real = fops.attention
    seen = []

    def spy(q, k, v, **kw):
        if len(seen) in calls:
            calls[len(seen)] = (q, k, v, kw)
        seen.append(None)
        return real(q, k, v, **kw)

    with mock.patch.object(fops, "attention", spy):
        yield calls


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def lm_phase(dev):
    """Phase 4l: Qwen3-4B at full width and depth, bf16, random weights
    drawn on the card: a prefill of 8 x 2048 tokens, its cache copied into
    an 8 x 4096 one, 64 greedy decode steps, counted (36 flash launches a
    pass); a prefill and a decode step profiled; the same passes through
    the plain versions, teacher-forced on the kernel path's tokens; the
    serving CLI's LM path against the CPU.  Returns the q/k/v of
    prefill layers 0 and 35 and of a decode step's layer 0 for phases 5
    and 6, and the launches."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import transformer as tr
    spec = configs.get(LM_ARCH)
    cfg = spec.cfg
    B, S, S_max = LM_BATCH, LM_PROMPT, LM_CACHE
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model, init_s = timed(lambda: tr.LM(cfg, seed=SEED, device=dev))
    n_params = sum(p.numel() for p in model.parameters())
    log(f"lm {LM_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.d_head}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}, {n_params} parameters, "
        f"{str(cfg.dtype)[6:]}, init {init_s} s")
    prompts = torch.randint(0, cfg.vocab, (B, S), generator=torch.Generator()
                            .manual_seed(SEED + 4)).to(dev)
    # one short uncounted pass first: cuBLAS's and the allocator's
    # first-call costs stay out of the times
    _, c = tr.lm_prefill(model, prompts[:1, :64])
    tr.lm_decode_step(model, prompts[:1, 0], c, 63)
    torch.cuda.synchronize()
    del c

    # ---- counted: prefill, then LM_STEPS greedy decode steps -------------
    _build.reset_launches()
    (logits, (kp, vp)), prefill_s = timed(lambda: tr.lm_prefill(model,
                                                                prompts))
    cache = tr.init_cache(cfg, B, S_max, device=dev)
    cache[0][..., :S, :] = kp
    cache[1][..., :S, :] = vp
    del kp, vp
    fed, logits_k, step_s = [], [logits], []
    tok = torch.argmax(logits, dim=-1)
    for i in range(LM_STEPS):
        fed.append(tok)
        (logits, _), s_ = timed(lambda: tr.lm_decode_step(model, tok, cache,
                                                          S + i))
        step_s.append(s_)
        logits_k.append(logits)
        tok = torch.argmax(logits, dim=-1)
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    step_med = statistics.median(step_s)
    log(f"lm prefill: {B} x {S} tokens in {1e3 * prefill_s} ms = "
        f"{B * S / prefill_s} tokens/s")
    log(f"lm decode: {LM_STEPS} steps at batch {B} from position {S} of a "
        f"{S_max}-slot cache: median {1e3 * step_med} ms per step = "
        f"{B / step_med} tokens/s (mean {1e3 * statistics.mean(step_s)} "
        f"ms, first {1e3 * step_s[0]} ms)")
    log(f"lm launches: {launches} max_memory_allocated={peak} card: "
        f"{smi_line()}")
    want = cfg.n_layers * (1 + LM_STEPS)
    assert launches["flash"] == want, (launches, want)
    assert sum(launches.values()) == want, launches
    for lg in logits_k:
        assert lg.shape == (B, cfg.vocab) and lg.dtype == cfg.dtype
        assert bool(torch.isfinite(lg).all()), "non-finite LM logits"

    # ---- q/k/v of the path for phases 5 and 6 (uncounted) -----------------
    with capture_attention({0: None}) as dec:
        tr.lm_decode_step(model, tok, cache, S + LM_STEPS)
    with capture_attention({0: None, cfg.n_layers - 1: None}) as pre:
        tr.lm_prefill(model, prompts)
    torch.cuda.synchronize()

    # ---- profiles: one prefill, one decode step ----------------------------
    profile_batch(f"lm prefill {B} x {S}", lambda: tr.lm_prefill(model,
                                                                 prompts),
                  prefill_s)
    profile_batch(f"lm decode step at position {S + LM_STEPS + 1}",
                  lambda: tr.lm_decode_step(model, tok, cache,
                                            S + LM_STEPS + 1), step_med)

    # ---- the same passes through the plain versions, teacher-forced --------
    _build.reset_launches()
    with plain_path():
        (logits, (kp, vp)), plain_prefill_s = timed(
            lambda: tr.lm_prefill(model, prompts))
        pcache = tr.init_cache(cfg, B, S_max, device=dev)
        pcache[0][..., :S, :] = kp
        pcache[1][..., :S, :] = vp
        del kp, vp
        logits_p = [logits]
        t0 = time.perf_counter()
        for i, tok_i in enumerate(fed):
            logits_p.append(tr.lm_decode_step(model, tok_i, pcache,
                                              S + i)[0])
        torch.cuda.synchronize()
        plain_step_s = (time.perf_counter() - t0) / LM_STEPS
    assert not any(_build.LAUNCHES.values()), dict(_build.LAUNCHES)
    errs = [rel_l2(a, b) for a, b in zip(logits_k, logits_p)]
    agree = torch.cat([(torch.argmax(a, -1) == torch.argmax(b, -1)).float()
                       for a, b in zip(logits_k, logits_p)])
    share = float(agree.mean())
    log(f"lm plain: prefill {1e3 * plain_prefill_s} ms, {1e3 * plain_step_s}"
        f" ms per step; last-position logits relative L2 error against the "
        f"kernel path: prefill {errs[0]}, steps max {max(errs[1:])} "
        f"(limit 5e-2); greedy tokens agree in {int(agree.sum())} of "
        f"{agree.numel()} (sequence, step) pairs = {share} (limit 0.95)")
    assert max(errs) <= 5e-2, "LM logits: kernel and plain paths part"
    assert share >= 0.95, "LM greedy tokens: kernel and plain paths part"
    del pcache, logits_p

    # ---- the serving CLI's LM path at its defaults, card against CPU -------
    args = serve_cli.parse_args(["--arch", LM_ARCH])
    _build.reset_launches()
    toks, cli_s = timed(lambda: serve_cli.serve_lm(spec, args, device=dev))
    cli_launches = dict(_build.LAUNCHES)
    toks_cpu = serve_cli.serve_lm(spec, args, device="cpu")
    same = int((toks == toks_cpu).sum())
    log(f"serve_lm ({args.arch} reduced, {args.steps} steps x {args.batch}):"
        f" {cli_s} s on the card; tokens equal to the CPU run's at {same} of"
        f" {toks.numel()} positions; launches {cli_launches}")
    assert toks.shape == (args.batch, args.steps)
    assert same >= 0.99 * toks.numel(), "serve_lm: the card and the CPU part"
    small = serve_cli.reduced_lm(spec)
    assert cli_launches["flash"] == small.n_layers * (1 + args.steps)
    # the captured k and v are views of whole caches (the decode step's
    # 4.8 GB): keep copies of the layers' slices alone, so the caches go
    def own(q, k, v, kw):
        return q, k.clone(), v.clone(), kw

    return {"prefill": [own(*pre[0]), own(*pre[cfg.n_layers - 1])],
            "decode": own(*dec[0]),
            "launches": launches["flash"], "cfg": cfg}


def grad_blocks_ok(grads) -> tuple[int, int, list]:
    """Each gradient leaf finite and not all zeros, block by block for the
    stacked [n_blocks, ...] leaves: ``(leaves, blocks checked, failing
    (path, block) pairs)``; one host read a leaf."""
    import torch
    paths, oks = [], []

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}.{k}" if prefix else k)
            return
        if isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, f"{prefix}.{i}")
            return
        g = (tree.reshape(tree.shape[0], -1) if prefix.startswith("blocks")
             else tree.reshape(1, -1))
        paths.append(prefix)
        oks.append(torch.isfinite(g).all(dim=1) & (g != 0).any(dim=1))

    walk(grads, "")
    flags = [t.tolist() for t in oks]
    bad = [(p, b) for p, f in zip(paths, flags) for b, ok in enumerate(f)
           if not ok]
    return len(paths), sum(len(f) for f in flags), bad


def check_flash_grad(q, k, v, **kw):
    """dq, dk and dv through the flash kernel's autograd Function (the
    kernel forward, one launch; the backward ``chunked_attention``'s,
    recomputed) against autograd through the plain version, on one
    random cotangent: f32 within 1e-4 abs/rel, bf16 within 2e-2 abs/rel,
    the forward's own tolerances (``check_flash``): the backward shares
    the plain version's arithmetic and differs only where the forward
    does."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash import ops, ref
    g = torch.Generator(device=q.device).manual_seed(SEED + 9)
    w = torch.randn(q.shape, generator=g, device=q.device).to(q.dtype)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    _build.reset_launches()
    out = ops.attention(*leaves, **kw)
    got = torch.autograd.grad(out, leaves, w)
    launches = dict(_build.LAUNCHES)
    assert launches["flash"] == 1 and sum(launches.values()) == 1, launches
    want = torch.autograd.grad(ref.chunked_attention(*leaves, **kw),
                               leaves, w)
    tol = 1e-4 if q.dtype == torch.float32 else 2e-2
    errs = {}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == q.dtype and a.shape == b.shape
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol,
                                   msg=lambda m: f"flash {name}: {m}")
        errs[name] = float((a.float() - b.float()).abs().max())
    return errs


def check_cross_grad(x0, xl, W, bias):
    """dx0, dxl, dW and db through the cross kernel's autograd Function
    (the kernel forward on the wrapper's route; the closed-form backward
    in torch ops) against autograd through the plain version, on one
    random cotangent g: each element within 2e-5 of its term scale, the
    absolute sum of the terms it adds up (``|g||u|``, ``|h||W| + |g|``,
    ``|h|^T |xl|``, ``sum |h|`` with ``u = xl W^T + b``, ``h = g x0``),
    as phase 4r holds the logits: f32 products summed in other orders."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.cross import ops, ref
    gen = torch.Generator(device=x0.device).manual_seed(SEED + 10)
    g = torch.randn(x0.shape, generator=gen, device=x0.device)
    leaves = [t.detach().requires_grad_() for t in (x0, xl, W, bias)]
    _build.reset_launches()
    got = torch.autograd.grad(ops.cross_layer(*leaves), leaves, g)
    launches = dict(_build.LAUNCHES)
    want = torch.autograd.grad(ref.cross_layer_ref(*leaves), leaves, g)
    with torch.no_grad():
        ag, ax0, axl, aW = g.abs(), x0.abs(), xl.abs(), W.abs()
        ah = ag * ax0
        scales = (ag * (axl @ aW.T + bias.abs()), ah @ aW + ag, ah.T @ axl,
                  ah.sum(dim=0))
    errs = {}
    for name, a, b, sc in zip(("dx0", "dxl", "dW", "db"), got, want,
                              scales):
        ratio = float(((a - b).abs() / sc.clamp_min(1e-30)).max())
        errs[name] = {"max_abs_err": float((a - b).abs().max()),
                      "max_err_over_term_scale": ratio}
        assert ratio <= 2e-5, f"cross {name}: {ratio} of its term scale"
    return errs, launches


def train_phase(dev):
    """Phase 4t: training.  (a) Qwen3-4B at full width and depth (bf16
    parameters, f32 AdamW moments, remat on) for ``TRAIN_STEPS`` steps of
    ``launch.train``'s step at its defaults (B 8, S 128, lr 3e-4) on its
    Zipf stream, no checkpoint, counted: losses finite, every gradient
    leaf finite and not all zeros block by block on the first step, 36
    flash launches a forward and 36 more in the backward's recompute.
    (b) the flash and cross Functions' gradients against autograd through
    their plain versions.  (c) DCN-v2 at its published config (26 x 2^20
    x 16 tables) for ``TRAIN_STEPS`` Adagrad steps at ``TRAIN_B`` rows,
    counted (3 cross and 3 cross_split launches a step).  (d) the bandit
    family in this process, counted, then the training CLI's families and
    ``examples/train_lm_torch.py`` as subprocesses, together.  Returns
    the launches of (a), (c) and (d)'s counted run by kernel."""
    import gc
    import torch
    from repro_torch import configs
    from repro_torch.configs import recsys_shapes
    from repro_torch.kernels import _build
    from repro_torch.kernels.cross import ops as cops
    from repro_torch.launch import train
    from repro_torch.models import transformer as tr
    from repro_torch.models.recsys import dcn_v2
    from repro_torch.train import optimizer
    from repro_torch.tree import tree_leaves
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t_phase = time.perf_counter()
    counted = {}

    # ---- (a) Qwen3-4B at full width and depth --------------------------------
    spec = configs.get(LM_ARCH)
    cfg = spec.cfg
    args = train.parse_args(["--arch", LM_ARCH])
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model, init_s = timed(lambda: tr.LM(cfg, seed=args.seed, device=dev)
                          .requires_grad_(True))
    params = model.tree()
    opt = optimizer.adamw_init(params)
    leaves = tree_leaves(params)
    n_params = sum(p.numel() for p in leaves)
    p_bytes = sum(p.numel() * p.element_size() for p in leaves)
    m_bytes = sum(t.numel() * t.element_size()
                  for t in tree_leaves((opt.m, opt.v)))
    log(f"train {LM_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_params} parameters ({p_bytes} bytes {str(cfg.dtype)[6:]}, "
        f"moments {m_bytes} bytes f32), remat {cfg.remat}, B {args.batch} "
        f"S {args.seq}, init {init_s} s; {held} bytes held by earlier "
        f"phases")
    torch.cuda.synchronize()
    _build.reset_launches()
    losses, step_s = [], []
    for i in range(TRAIN_STEPS):
        tokens = train.zipf_tokens(cfg.vocab, (args.batch, args.seq + 1),
                                   args.seed, i, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:
            # the first step in two calls, its gradients checked between
            loss, grads = train.value_and_grad(
                tr.lm_loss, params, model, tokens[:, :-1], tokens[:, 1:])
            n_leaves, n_blocks, bad = grad_blocks_ok(grads)
            params, opt = optimizer.adamw_update(grads, opt, params, lr=3e-4)
            del grads
        else:
            params, opt, loss = train.lm_step(model, params, opt, tokens)
        losses.append(float(loss))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"train {LM_ARCH}: losses {losses}; seconds per step {step_s} "
        f"(after the first: median {statistics.median(step_s[1:])}); "
        f"first step's gradients: {n_leaves} leaves, {n_blocks} "
        f"(leaf, block) slices finite and not all zero, failing {bad}")
    log(f"train {LM_ARCH} launches: {launches} max_memory_allocated={peak} "
        f"card: {smi_line()}")
    want = TRAIN_STEPS * 2 * cfg.n_layers      # forward + remat recompute
    assert launches["flash"] == want, (launches, want)
    assert sum(launches.values()) == want, launches
    assert all(math.isfinite(x) for x in losses), losses
    assert not bad, f"gradients missing or not finite: {bad}"
    counted["flash"] = launches["flash"]
    # uncounted: one more step in its two calls, each timed, then one
    # under torch.profiler
    def loss_and_grads():      # the gradients dropped on return
        train.value_and_grad(tr.lm_loss, params, model, tokens[:, :-1],
                             tokens[:, 1:])

    _, grad_s = timed(loss_and_grads)
    total_s = timed(lambda: train.lm_step(model, params, opt, tokens))[1]
    log(f"train {LM_ARCH} step split: loss and gradients {grad_s} s, then "
        f"a whole step {total_s} s: the AdamW update ~{total_s - grad_s} s")
    profile_batch(f"train {LM_ARCH} step", lambda: train.lm_step(
        model, params, opt, tokens), statistics.median(step_s[1:]))
    del model, params, opt, leaves, loss
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (b) the kernels' gradients against their plain versions ------------
    g = torch.Generator(device=dev).manual_seed(SEED + 8)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (scale * torch.randn(*shape, generator=g, device=dev)).to(
            dtype)

    grads = {}
    for label, (Bq, Hq, Hkv, S, Dh, dt) in (
            ("bf16_train", (args.batch, cfg.n_heads, cfg.n_kv_heads,
                            args.seq, cfg.d_head, torch.bfloat16)),
            ("f32_gqa4_dh32", (4, 8, 2, 64, 32, torch.float32))):
        grads[f"flash_{label}"] = check_flash_grad(
            randn(Bq, Hq, S, Dh, dtype=dt), randn(Bq, Hkv, S, Dh, dtype=dt),
            randn(Bq, Hkv, S, Dh, dtype=dt), causal=True)
    dI = configs.get("dcn-v2").cfg.d_interact
    sms = _build.sm_count(dev.index or 0)
    for B in (recsys_shapes.TRAIN_B, recsys_shapes.P99_B):
        errs, launched = check_cross_grad(
            randn(B, dI), randn(B, dI), randn(dI, dI, scale=dI ** -0.5),
            randn(dI, scale=0.1))
        tensor = cops.route(B, dI, sms) == cops.TENSOR
        assert launched["cross"] == 1, launched
        assert launched["cross_split"] == int(tensor), launched
        grads[f"cross_{B}_{'tensor' if tensor else 'simt'}"] = errs
    log(f"train gradients, kernel Function vs autograd through the plain "
        f"version: {grads}")

    # ---- (c) DCN-v2 at its published config ----------------------------------
    dspec = configs.get("dcn-v2")
    dcfg = dspec.cfg
    torch.cuda.reset_peak_memory_stats()
    model, init_s = timed(lambda: dcn_v2.DCNv2(dcfg, seed=SEED, device=dev)
                          .requires_grad_(True))
    params = model.tree()
    opt = optimizer.adagrad_init(params)
    B = recsys_shapes.TRAIN_B
    want = dspec.input_specs("train_batch")
    _build.reset_launches()
    losses, step_s = [], []
    for i in range(TRAIN_STEPS):
        batch, _ = train.recsys_batch("dcn-v2", dcfg, B, SEED, i, dev)
        assert all((tuple(t.shape), t.dtype) == want[k] for t, k in zip(
            batch, ("dense_feats", "sparse_ids", "labels")))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:
            loss, grads = train.value_and_grad(dcn_v2.dcn_loss, params,
                                               model, *batch)
            n_leaves, n_blocks, bad = grad_blocks_ok(grads)
            params, opt = optimizer.adagrad_update(grads, opt, params)
            del grads
        else:
            params, opt, loss = train.recsys_step(dcn_v2.dcn_loss, model,
                                                  params, opt, batch)
        losses.append(float(loss))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launches = dict(_build.LAUNCHES)
    log(f"train dcn-v2: tables {tuple(model.tables.shape)}, batch {B}, init "
        f"{init_s} s; losses {losses}; seconds per step {step_s}; first "
        f"step's gradients: {n_leaves} leaves finite and not all zero, "
        f"failing {bad}; launches {launches} max_memory_allocated="
        f"{torch.cuda.max_memory_allocated()}")
    n = dcfg.n_cross_layers * TRAIN_STEPS
    split = n * (cops.route(B, dcfg.d_interact, sms) == cops.TENSOR)
    assert launches["cross"] == n and launches["cross_split"] == split, (
        launches)
    assert sum(launches.values()) == n + split, launches
    assert all(math.isfinite(x) for x in losses), losses
    assert not bad, f"gradients missing or not finite: {bad}"
    counted.update(cross=launches["cross"],
                   cross_split=launches["cross_split"])
    del model, params, opt, loss
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (d) the bandit family, counted; the CLIs as subprocesses ------------
    _build.reset_launches()
    _, secs = timed(lambda: train.main(["--arch", "distclub-paper",
                                        "--steps", "2"]))
    launches = dict(_build.LAUNCHES)
    log(f"train distclub-paper (2 epochs at 20480 users): {secs} s, "
        f"launches {launches}")
    from repro_torch.configs import distclub_paper
    R = distclub_paper.CONFIG.max_rounds
    assert launches["choose"] == launches["rank1_update_inv"] == 2 * 2 * R
    assert launches["prune"] == 2 and launches["cc_hop"] >= 2, launches
    counted.update({k: launches[k] for k in ("choose", "rank1_update_inv",
                                             "prune", "cc_hop")})
    outs = run_together(TRAIN_CLIS, TRAIN_CLI_TIMEOUT_S, "train cli")
    example = outs["example"]
    first = float(example.split("step     0  loss ")[1].split()[0])
    final = float(example.rsplit("done; final loss ", 1)[1].split()[0])
    log(f"train example: loss at step 0 {first}, final {final}")
    assert "resumed from checkpoint step 30" in example, "no resume"
    assert first > final, "the example's loss did not fall"
    assert "interactions, reward/random" in outs["distclub-paper"]
    log(f"train phase: {time.perf_counter() - t_phase} s")
    return counted


# ---------------------------------------------------------------------------
# phase 4m: the MoE LMs
# ---------------------------------------------------------------------------

MOE_ARCHS = ("deepseek-moe-16b", "llama4-maverick-400b-a17b")
MOE_STEPS = 32               # greedy decode steps after the 8 x 2048 prefill
MOE_BLOCKS = {"llama4-maverick-400b-a17b": 1}   # 1 of 24 blocks: ~37 GB
MOE_TRAIN_ARCH = "deepseek-moe-16b"
MOE_TRAIN_RESERVE = 16e9     # bytes kept beside 12 a parameter (bf16
                             # weights and gradients, f32 moments) for the
                             # step's temporaries and activations
MOE_CLI_TIMEOUT_S = 300
MOE_CLIS = (("deepseek-moe-16b", ["-m", "repro_torch.launch.train",
                                  "--arch", "deepseek-moe-16b", "--reduce",
                                  "--steps", "5"]),)


@contextlib.contextmanager
def capture_routing(store):
    """Append the indices of every ``torch.topk`` call (the MoE routers':
    nothing else on the LM path calls it) to ``store`` while it runs as
    it is."""
    import torch
    real = torch.topk

    def spy(*a, **kw):
        out = real(*a, **kw)
        store.append(out.indices)
        return out

    with mock.patch.object(torch, "topk", spy):
        yield store


@contextlib.contextmanager
def force_routing(routes, own):
    """Make each ``torch.topk`` call (the MoE routers') return the next of
    ``routes``, an earlier run's indices, with this run's own
    probabilities at them, as the tokens are teacher-forced; the indices
    this run's router would have picked go to ``own``."""
    import torch
    real = torch.topk
    forced = iter(routes)

    def spy(probs, k, *a, **kw):
        own.append(real(probs, k, *a, **kw).indices)
        idx = next(forced)
        return probs.gather(-1, idx), idx

    with mock.patch.object(torch, "topk", spy):
        yield own


def routing_agreement(routes_a, routes_b, n_moe: int) -> list[float]:
    """For each MoE layer, the share of (token, choice) routings of run a
    that run b also made (the same expert among the token's top k), over
    every pass the two runs made in the same order."""
    hits, total = [0] * n_moe, [0] * n_moe
    for i, (a, b) in enumerate(zip(routes_a, routes_b, strict=True)):
        same = (a[:, :, None] == b[:, None, :]).any(dim=-1)
        hits[i % n_moe] += int(same.sum())
        total[i % n_moe] += same.numel()
    return [h / t for h, t in zip(hits, total)]


def free_card():
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()


def moe_serve(dev, arch):
    """Phase 4m (a, b): ``arch`` at full width (llama4-maverick cut to
    ``MOE_BLOCKS`` blocks), bf16, random weights drawn on the card: a
    prefill of 8 x 2048 tokens, its cache copied into an 8 x 4096 one,
    ``MOE_STEPS`` greedy decode steps, counted (one flash launch a layer
    a pass, nothing else); a prefill and a decode step profiled; the same
    passes through the plain versions, teacher-forced on the kernel
    path's tokens (phase 4l's bands), and the routings of the two runs
    compared layer by layer.  Returns the q/k/v of the first and last
    prefill layers and of a decode step's layer 0, and the launches."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.models import transformer as tr
    cfg = configs.get(arch).cfg
    if arch in MOE_BLOCKS:
        cfg = dataclasses.replace(
            cfg, n_layers=MOE_BLOCKS[arch] * cfg.block_layers)
    B, S, S_max = LM_BATCH, LM_PROMPT, LM_CACHE
    n_moe = cfg.n_layers // cfg.moe_every
    free_card()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model, init_s = timed(lambda: tr.LM(cfg, seed=SEED, device=dev))
    n_params = sum(p.numel() for p in model.parameters())
    log(f"moe {arch}: {cfg.n_layers} of {configs.get(arch).cfg.n_layers} "
        f"layers ({cfg.n_blocks} blocks of {cfg.block_layers}), d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.d_head}, {cfg.n_experts} experts top-{cfg.top_k} of d_ff "
        f"{cfg.d_ff_expert} + {cfg.n_shared} shared, vocab {cfg.vocab}, "
        f"{n_params} parameters, {str(cfg.dtype)[6:]}, init {init_s} s; "
        f"{held} bytes held by earlier phases")
    prompts = torch.randint(0, cfg.vocab, (B, S), generator=torch.Generator()
                            .manual_seed(SEED + 4)).to(dev)
    # one short uncounted pass first: cuBLAS's and the allocator's
    # first-call costs stay out of the times
    _, c = tr.lm_prefill(model, prompts[:1, :64])
    tr.lm_decode_step(model, prompts[:1, 0], c, 63)
    torch.cuda.synchronize()
    del c

    # ---- counted: prefill, then MOE_STEPS greedy decode steps ------------
    routes_k = []
    _build.reset_launches()
    with capture_routing(routes_k):
        (logits, (kp, vp)), prefill_s = timed(lambda: tr.lm_prefill(
            model, prompts))
        cache = tr.init_cache(cfg, B, S_max, device=dev)
        cache[0][..., :S, :] = kp
        cache[1][..., :S, :] = vp
        del kp, vp
        fed, logits_k, step_s = [], [logits], []
        tok = torch.argmax(logits, dim=-1)
        for i in range(MOE_STEPS):
            fed.append(tok)
            (logits, _), s_ = timed(lambda: tr.lm_decode_step(
                model, tok, cache, S + i))
            step_s.append(s_)
            logits_k.append(logits)
            tok = torch.argmax(logits, dim=-1)
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    step_med = statistics.median(step_s)
    from repro_torch.models import moe
    caps = (moe.capacity(B * S, cfg.top_k, cfg.n_experts,
                         cfg.capacity_factor),
            moe.capacity(B, cfg.top_k, cfg.n_experts, cfg.capacity_factor))
    log(f"moe {arch} prefill: {B} x {S} tokens in {1e3 * prefill_s} ms = "
        f"{B * S / prefill_s} tokens/s (expert capacity {caps[0]})")
    log(f"moe {arch} decode: {MOE_STEPS} steps at batch {B} from position "
        f"{S} of a {S_max}-slot cache: median {1e3 * step_med} ms per step "
        f"= {B / step_med} tokens/s (mean {1e3 * statistics.mean(step_s)} "
        f"ms, first {1e3 * step_s[0]} ms; expert capacity {caps[1]}, so "
        f"{B * cfg.top_k} routed pairs a layer share {cfg.n_experts} "
        f"slots: repro's semantics)")
    log(f"moe {arch} launches: {launches} max_memory_allocated={peak} card: "
        f"{smi_line()}")
    want = cfg.n_layers * (1 + MOE_STEPS)
    assert launches["flash"] == want, (launches, want)
    assert sum(launches.values()) == want, launches
    assert len(routes_k) == n_moe * (1 + MOE_STEPS), len(routes_k)
    for lg in logits_k:
        assert lg.shape == (B, cfg.vocab) and lg.dtype == cfg.dtype
        assert bool(torch.isfinite(lg).all()), "non-finite MoE logits"

    # ---- q/k/v of the path for phases 5 and 6 (uncounted) -----------------
    with capture_attention({0: None}) as dec:
        tr.lm_decode_step(model, tok, cache, S + MOE_STEPS)
    with capture_attention({0: None, cfg.n_layers - 1: None}) as pre:
        tr.lm_prefill(model, prompts)
    torch.cuda.synchronize()

    def own(q, k, v, kw):
        return q, k.clone(), v.clone(), kw

    out = {"prefill": [own(*pre[i]) for i in sorted(pre)],
           "decode": own(*dec[0]), "launches": launches["flash"],
           "cfg": cfg, "layers": sorted(pre)}
    del pre, dec

    # ---- profiles: one prefill, one decode step ----------------------------
    profile_batch(f"moe {arch} prefill {B} x {S}",
                  lambda: tr.lm_prefill(model, prompts), prefill_s)
    profile_batch(f"moe {arch} decode step at position {S + MOE_STEPS + 1}",
                  lambda: tr.lm_decode_step(model, tok, cache,
                                            S + MOE_STEPS + 1), step_med)
    del cache
    free_card()

    # ---- the same passes through the plain versions, teacher-forced --------
    from repro_torch.kernels.flash import ops as fops
    from repro_torch.kernels.flash import ref as fref
    kernel = fops.attention

    def f32_attention(q, k, v, **kw):
        """The reference: ``chunked_attention`` on the upcast inputs,
        rounded once to their dtype."""
        return fref.chunked_attention(q.float(), k.float(), v.float(),
                                      **kw).to(q.dtype)

    def worse_kernel(q, k, v, **kw):
        """The kernel with the plain version's distance from the
        reference added to its own: what the held comparison must
        refuse."""
        want = fref.chunked_attention(q.float(), k.float(), v.float(), **kw)
        plain = fref.chunked_attention(q, k, v, **kw).float()
        return (kernel(q, k, v, **kw).float() + plain - want).to(q.dtype)

    def plain_run(routing, attention=None):
        """The prefill and the fed tokens' steps under ``routing``, through
        the plain versions, or with ``attention`` in the flash wrapper's
        place: (logits, prefill s, s a step)."""
        _build.reset_launches()
        swap = (plain_path() if attention is None else
                mock.patch.object(fops, "attention", attention))
        with swap, routing:
            (logits, (kp, vp)), prefill_s = timed(
                lambda: tr.lm_prefill(model, prompts))
            pcache = tr.init_cache(cfg, B, S_max, device=dev)
            pcache[0][..., :S, :] = kp
            pcache[1][..., :S, :] = vp
            del kp, vp
            logits_p = [logits]
            t0 = time.perf_counter()
            for i, tok_i in enumerate(fed):
                logits_p.append(tr.lm_decode_step(model, tok_i, pcache,
                                                  S + i)[0])
            torch.cuda.synchronize()
            step_s = (time.perf_counter() - t0) / MOE_STEPS
        if attention is None:
            assert not any(_build.LAUNCHES.values()), dict(_build.LAUNCHES)
        return logits_p, prefill_s, step_s

    def bands(logits_p):
        errs = [rel_l2(a, b) for a, b in zip(logits_k, logits_p)]
        agree = torch.cat([(torch.argmax(a, -1) == torch.argmax(b, -1))
                           .float() for a, b in zip(logits_k, logits_p)])
        return errs, agree

    def against(ref, runs) -> dict:
        """Each run's logits (every position) against the reference's:
        (relative L2 error, share of greedy tokens equal)."""
        want = torch.cat(ref)
        out = {}
        for label, run in runs.items():
            got = torch.cat(run)
            out[label] = (rel_l2(got, want), float(
                (got.argmax(-1) == want.argmax(-1)).float().mean()))
        return out

    # (1) free-running routers: a bf16 near-tie in a router flips a choice,
    # and a flipped choice moves the token's state and, through attention,
    # later tokens' and later layers' choices; printed, not held
    routes_p = []
    logits_p, plain_prefill_s, plain_step_s = plain_run(
        capture_routing(routes_p))
    errs, agree = bands(logits_p)
    routed = routing_agreement(routes_k, routes_p, n_moe)
    share = float(agree.mean())
    logits_f, _, _ = plain_run(capture_routing([]), f32_attention)
    free = against(logits_f, {"kernel": logits_k, "plain": logits_p})
    log(f"moe {arch} plain, its own routings: prefill {1e3 * plain_prefill_s}"
        f" ms, {1e3 * plain_step_s} ms per step; last-position logits "
        f"relative L2 error against the kernel path: prefill {errs[0]}, "
        f"steps max {max(errs[1:])} (phase 4l's band 5e-2: "
        f"{'held' if max(errs) <= 5e-2 else 'missed'}); greedy tokens agree "
        f"in {int(agree.sum())} of {agree.numel()} (sequence, step) pairs = "
        f"{share} (phase 4l's band 0.95: "
        f"{'held' if share >= 0.95 else 'missed'}); against the f32 "
        f"attention reference on its own routings (relative L2, tokens "
        f"equal): {free}")
    log(f"moe {arch} routings agreeing between the kernel and plain runs, "
        f"MoE layer by layer (prefill and every step): {routed}")
    del logits_p, logits_f, routes_p
    # (2) the routings teacher-forced too, as the tokens are: the plain
    # routers' own picks recorded beside the kernel run's.  Held to phase
    # 4l's logit band; its token band (0.95) is printed, held or missed:
    # random weights leave the logits flat (a median top-2 gap of ~7 bf16
    # ulps), so bf16 paths that round differently part on near ties.
    # Held instead: against the same passes with attention in f32, the
    # kernel path is no farther than the plain path, in logits and in
    # greedy tokens; a kernel with the plain version's error added to its
    # own must fail that
    own = []
    logits_p, _, _ = plain_run(force_routing(routes_k, own))
    errs, agree = bands(logits_p)
    share = float(agree.mean())
    own_routed = routing_agreement(routes_k, own, n_moe)
    logits_f, _, _ = plain_run(force_routing(routes_k, []), f32_attention)
    logits_w, _, _ = plain_run(force_routing(routes_k, []), worse_kernel)
    ref = against(logits_f, {"kernel": logits_k, "plain": logits_p,
                             "worse kernel": logits_w})

    def no_worse(label) -> bool:
        return (ref[label][0] <= ref["plain"][0]
                and ref[label][1] >= ref["plain"][1])

    log(f"moe {arch} plain, the kernel run's routings forced: last-position "
        f"logits relative L2 error against the kernel path: prefill "
        f"{errs[0]}, steps max {max(errs[1:])} (limit 5e-2); greedy tokens "
        f"agree in {int(agree.sum())} of {agree.numel()} (sequence, step) "
        f"pairs = {share} (phase 4l's band 0.95: "
        f"{'held' if share >= 0.95 else 'missed'}); routings the plain "
        f"routers would have picked themselves, layer by layer: "
        f"{own_routed}")
    log(f"moe {arch} against the f32 attention reference, routings forced "
        f"(relative L2, tokens equal): {ref}; the kernel no worse than the "
        f"plain version: {no_worse('kernel')}; the kernel with the plain "
        f"version's error added refused: {not no_worse('worse kernel')}")
    assert max(errs) <= 5e-2, f"{arch} logits: kernel and plain paths part"
    assert no_worse("kernel"), (
        f"{arch}: the kernel path is farther from the f32 reference than "
        f"the plain path")
    assert not no_worse("worse kernel"), (
        f"{arch}: the reference comparison passes the kernel with the "
        f"plain version's error added")
    del model, logits_p, logits_f, logits_w, logits_k, routes_k, own
    free_card()
    return out


def moe_param_split(cfg) -> tuple[int, int]:
    """(parameters outside the layers, parameters a layer) of a config
    whose blocks are one layer each."""
    import dataclasses
    one = dataclasses.replace(cfg, n_layers=1).param_count()
    per = dataclasses.replace(cfg, n_layers=2).param_count() - one
    return one - per, per


def moe_train(dev):
    """Phase 4m (c): deepseek-moe-16b at full width, cut to the most
    layers whose step fits the card (12 bytes a parameter beside
    ``MOE_TRAIN_RESERVE``), ``TRAIN_STEPS`` steps of ``launch.train``'s
    step at its defaults (B 8, S 128, lr 3e-4, f32 AdamW moments, remat)
    on its Zipf stream, counted: losses finite, every gradient leaf of
    the first step (each block's router, experts and shared expert among
    them) finite and not all zero, 2 flash launches a layer a step.
    Returns the flash launches."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.launch import train
    from repro_torch.models import transformer as tr
    from repro_torch.train import optimizer
    full = configs.get(MOE_TRAIN_ARCH).cfg
    args = train.parse_args(["--arch", MOE_TRAIN_ARCH])
    free_card()
    free, total = torch.cuda.mem_get_info()
    outside, per = moe_param_split(full)
    n_layers = max(1, min(full.n_layers, int(
        ((free - MOE_TRAIN_RESERVE) / 12 - outside) // per)))
    cfg = dataclasses.replace(full, n_layers=n_layers)
    log(f"train {MOE_TRAIN_ARCH}: cut to {n_layers} of {full.n_layers} "
        f"layers: {cfg.param_count()} parameters ({outside} outside the "
        f"layers, {per} a layer) x 12 bytes = {12 * cfg.param_count()} of "
        f"{free} bytes free ({total} on the card), {MOE_TRAIN_RESERVE} kept "
        f"for temporaries and activations")
    torch.cuda.reset_peak_memory_stats()
    model, init_s = timed(lambda: tr.LM(cfg, seed=args.seed, device=dev)
                          .requires_grad_(True))
    params = model.tree()
    opt = optimizer.adamw_init(params)
    _build.reset_launches()
    losses, step_s = [], []
    for i in range(TRAIN_STEPS):
        tokens = train.zipf_tokens(cfg.vocab, (args.batch, args.seq + 1),
                                   args.seed, i, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:
            loss, grads = train.value_and_grad(
                tr.lm_loss, params, model, tokens[:, :-1], tokens[:, 1:])
            n_leaves, n_blocks, bad = grad_blocks_ok(grads)
            moe_leaves = sorted(grads["blocks"]["l0"]["moe"])
            params, opt = optimizer.adamw_update(grads, opt, params, lr=3e-4)
            del grads
        else:
            params, opt, loss = train.lm_step(model, params, opt, tokens)
        losses.append(float(loss))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"train {MOE_TRAIN_ARCH} ({n_layers} layers, B {args.batch} S "
        f"{args.seq}, init {init_s} s): losses {losses}; seconds per step "
        f"{step_s}; first step's gradients: {n_leaves} leaves, {n_blocks} "
        f"(leaf, block) slices finite and not all zero (MoE leaves "
        f"{moe_leaves} in each block), failing {bad}")
    log(f"train {MOE_TRAIN_ARCH} launches: {launches} max_memory_allocated="
        f"{peak} card: {smi_line()}")
    want = TRAIN_STEPS * 2 * n_layers          # forward + remat recompute
    assert launches["flash"] == want, (launches, want)
    assert sum(launches.values()) == want, launches
    assert all(math.isfinite(x) for x in losses), losses
    assert not bad, f"gradients missing or not finite: {bad}"
    del model, params, opt, loss
    free_card()
    return launches["flash"]


def moe_clis(dev):
    """Phase 4m (d): ``launch.serve.serve_lm`` for both MoE archs at the
    CLI's defaults on the card against the same call on the CPU (tokens
    equal at >= 99% of positions), then ``launch.train --arch
    deepseek-moe-16b --reduce --steps 5`` as a subprocess.  Returns the
    flash launches of the two serve_lm calls."""
    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.launch import serve as serve_cli
    total = 0
    for arch in MOE_ARCHS:
        spec = configs.get(arch)
        args = serve_cli.parse_args(["--arch", arch])
        _build.reset_launches()
        toks, cli_s = timed(lambda: serve_cli.serve_lm(spec, args,
                                                       device=dev))
        cli_launches = dict(_build.LAUNCHES)
        toks_cpu = serve_cli.serve_lm(spec, args, device="cpu")
        same = int((toks == toks_cpu).sum())
        log(f"serve_lm ({arch} reduced, {args.steps} steps x {args.batch}): "
            f"{cli_s} s on the card; tokens equal to the CPU run's at {same} "
            f"of {toks.numel()} positions; launches {cli_launches}")
        assert toks.shape == (args.batch, args.steps)
        assert same >= 0.99 * toks.numel(), f"serve_lm {arch}: card and CPU"
        small = serve_cli.reduced_lm(spec)
        assert cli_launches["flash"] == small.n_layers * (1 + args.steps)
        assert sum(cli_launches.values()) == cli_launches["flash"]
        total += cli_launches["flash"]
    outs = run_together(MOE_CLIS, MOE_CLI_TIMEOUT_S, "moe train cli")
    assert "done; final loss" in outs["deepseek-moe-16b"]
    return total


def moe_phase(dev):
    """Phase 4m: both MoE LMs served, deepseek-moe-16b trained, the
    CLIs."""
    t_phase = time.perf_counter()
    runs = {arch: moe_serve(dev, arch) for arch in MOE_ARCHS}
    trained = moe_train(dev)
    cli = moe_clis(dev)
    log(f"moe phase: {time.perf_counter() - t_phase} s")
    return {"runs": runs, "train_launches": trained, "cli_launches": cli}


def flash_times(q, k, v, kw, chunk, flush) -> dict:
    """flash at one shape of the path: kernel, plain version and
    ``scaled_dot_product_attention`` (which the port never calls; the
    decode step on the valid cache prefix, non-causal; ``sdpa`` names
    its form), each over ``REPS`` launches, beside the bound
    (``flash_work``'s bytes and operations, bf16 at the tensor cores'
    rate)."""
    import torch
    from repro_torch.kernels.flash import ops as fops
    from repro_torch.kernels.flash import ref as fref
    F = torch.nn.functional
    kv = kw["kv_len"] or k.shape[2]
    n_bytes, flops = flash_work(q, k, v, kw)
    kw = {key: kw[key] for key in ("causal", "q_offset", "kv_len")}
    ks, vs = k[:, :, :kv], v[:, :, :kv]
    causal = q.shape[2] > 1
    try:
        F.scaled_dot_product_attention(q, ks, vs, is_causal=causal,
                                       enable_gqa=True)
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, ks, vs, is_causal=causal, enable_gqa=True)
        note = "enable_gqa"
    except TypeError:
        note = "K/V expanded to the q heads beforehand (no enable_gqa)"
        grp = q.shape[1] // k.shape[1]
        ksx, vsx = (t.repeat_interleave(grp, 1) for t in (ks, vs))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, ksx, vsx, is_causal=causal)
    bms, by = bound_ms(n_bytes, flops, BF16_FLOPS_PER_S
                       if q.dtype == torch.bfloat16 else F32_FLOPS_PER_S)
    return {"shape": [list(q.shape), list(k.shape)], "kv_len": kv,
            "ms": cuda_ms(lambda: fops.attention(q, k, v, **kw), flush),
            "plain_ms": cuda_ms(lambda: fref.chunked_attention(
                q, k, v, chunk=chunk, **kw), flush),
            "library_ms": cuda_ms(sdpa, flush), "bound_ms": bms,
            "bound_by": by, "bytes": n_bytes, "ops": flops, "sdpa": note}


def flash_work(q, k, v, kw) -> tuple[int, int]:
    """(bytes, operations) of one flash call: q, the visible keys' k and
    v, and out, once each; 4 Dh operations per (query, visible key) pair
    (Q K^T and P V)."""
    import torch
    Bq, Hq, Sq, Dh = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    kv = min(kw.get("kv_len") or Skv, Skv)
    pos = kw["q_offset"] + torch.arange(Sq)
    seen = int(torch.clamp(torch.minimum(pos + 1, torch.tensor(kv))
                           if kw["causal"] else torch.full((Sq,), kv),
                           min=0).sum())
    n_bytes = q.element_size() * (2 * Bq * Hq * Sq * Dh
                                  + 2 * Bq * Hkv * kv * Dh)
    return n_bytes, 4 * Dh * Bq * Hq * seen


def moe_flash_times(moe_out, flush) -> dict:
    """Phase 6's flash times at the MoE path's shapes: deepseek's prefill
    (group 1) and decode step, llama4-maverick's prefill (group 5)."""
    out = {}
    for arch, run in moe_out["runs"].items():
        tag = arch.split("-")[0]
        chunk = run["cfg"].attn_chunk
        out[f"{tag}_prefill"] = flash_times(*run["prefill"][0], chunk, flush)
        if arch == "deepseek-moe-16b":
            out[f"{tag}_decode"] = flash_times(*run["decode"], chunk, flush)
    for label, t in out.items():
        log(f"time flash at {label}: {t}, "
            f"{math.ceil(t['ms'] / t['bound_ms'])}x the bound")
    return out


def moe_flash_checks(moe_out) -> float:
    """Phase 5's flash checks on the MoE path: deepseek's first and last
    prefill layers and a decode step's layer 0 (group 1), llama4-maverick's
    two prefill layers (group 5, the plain version's distance from the f32
    version reported, not held).  Returns the largest error against the
    f32 version."""
    errs = []
    for arch, run in moe_out["runs"].items():
        cases = [(f"prefill layer {i}", qkv)
                 for i, qkv in zip(run["layers"], run["prefill"])]
        if arch == "deepseek-moe-16b":
            cases.append(("decode step layer 0", run["decode"]))
        for label, (q, k, v, kw) in cases:
            kw = {key: kw[key] for key in ("causal", "q_offset", "kv_len")}
            res = check_flash(q, k, v, chunk=run["cfg"].attn_chunk,
                              ref_chunk=512,
                              hold_plain=arch == "deepseek-moe-16b", **kw)
            log(f"full flash, {arch} {label} {tuple(q.shape)} x "
                f"{tuple(k.shape)} (group {q.shape[1] // k.shape[1]}) "
                f"{kw}: {res}")
            errs.append(res["max_abs_err"])
    return max(errs)


# ---------------------------------------------------------------------------
# phase 4k: the sharded LM decode
# ---------------------------------------------------------------------------

DS_ARCH = "qwen3-4b"         # (a): full width and depth, one process
DS_SLOTS = 32768             # decode_32k's S_max; its batch 128 cut to 8
                             # (618 GB of bf16 cache at 128, 38.65 GB at 8)
DS_STEPS = 32
DS_INT8_BAND = 0.08          # repro's test: max |int8 - bf16| / max |bf16|
DS_MESH = ((2, 2), ("data", "model"))   # (b, c): gloo ranks on the card
DS_CUTS = (("qwen3-4b", 4), ("deepseek-moe-16b", 2))   # (arch, layers)
DS_LAYOUTS = (("standard", 8, False), ("int8", 8, True), ("tiny", 1, False))
DS_PROMPT = 2044             # 4 short of the 2048-slot shard boundary
DS_RANK_SLOTS = 4096
DS_RANK_STEPS = 8
DS_REL = 5e-2                # ranks against one process: relative L2 of
                             # each step's logits (phase 4l's band)
DS_TOKENS = 0.95             # greedy tokens equal, pooled over a model
DS_TIE = 0.02                # router logits of the k-th and (k+1)-th
                             # experts closer than this: a near tie
DS_TIMEOUT_S = 600


@contextlib.contextmanager
def ds_routes(store):
    """Record each routing of the sharded step (``decode_shard._route``):
    the experts chosen, sorted, and the gap between the router logits of
    the k-th and (k+1)-th experts, a row each."""
    import torch
    from repro_torch.distributed import decode_shard
    real = decode_shard._route

    def spy(z, router, k):
        gate, idx = real(z, router, k)
        top = torch.topk(z.float() @ router, k + 1, dim=-1).values
        store.append((idx.sort(-1).values.cpu(),
                      (top[:, k - 1] - top[:, k]).cpu()))
        return gate, idx

    with mock.patch.object(decode_shard, "_route", spy):
        yield store


def ds_caches(cfg, kp, vp, slots, kv_quant, dev):
    """Full caches of ``slots`` slots on ``dev`` holding the prompt's K/V
    ``kp``/``vp`` [nb, bl, B, Hkv, S, Dh] in their first S slots, as int8
    codes and f32 scales with ``kv_quant``."""
    import torch
    from repro_torch.distributed import decode_shard
    nb, bl, B, Hkv, S, Dh = kp.shape
    shape = (nb, bl, B, Hkv, slots, Dh)
    if not kv_quant:
        out = tuple(torch.zeros(shape, dtype=cfg.dtype, device=dev)
                    for _ in range(2))
        out[0][..., :S, :] = kp
        out[1][..., :S, :] = vp
        return out
    out = (*(torch.zeros(shape, dtype=torch.int8, device=dev)
             for _ in range(2)),
           *(torch.zeros(shape[:-1], device=dev) for _ in range(2)))
    for b in range(nb):           # a block at a time: f32 temporaries
        for src, codes, scales in ((kp, out[0], out[2]),
                                   (vp, out[1], out[3])):
            c, s = decode_shard.quantize(src[b].to(dev))
            codes[b, ..., :S, :] = c
            scales[b, ..., :S] = s
    return out


def ds_one(dev):
    """Phase 4k (a): Qwen3-4B at full width and depth, bf16, random
    weights, on a one-rank mesh: a prefill of 8 x 2048 (flash), its K/V in
    a 32768-slot cache, ``DS_STEPS`` steps of ``lm_decode_step`` (counted:
    flash) and of the sharded step at each position on the same cache
    (the sharded step rewrites its own slot), teacher-forced on
    ``lm_decode_step``'s greedy tokens and held to phase 4l's bands; then,
    the bf16 cache freed, the prompt's K/V quantized into an int8 cache
    and the int8 step run on the same tokens, held to ``DS_INT8_BAND`` of
    the bf16 sharded step.  No sharded step launches a counted kernel."""
    import torch
    from repro_torch import configs
    from repro_torch.distributed import decode_shard
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh
    from repro_torch.models import transformer as tr
    from repro_torch.runtime import collectives
    cfg = configs.get(DS_ARCH).cfg
    B, S, S_max = LM_BATCH, LM_PROMPT, DS_SLOTS
    free_card()
    torch.cuda.reset_peak_memory_stats()
    model = tr.LM(cfg, seed=SEED, device=dev)
    prompts = torch.randint(0, cfg.vocab, (B, S), generator=torch.Generator()
                            .manual_seed(SEED + 4)).to(dev)
    one = mesh.make_mesh((1, 1), ("data", "model"))
    ds = decode_shard.build_decode_step(one, cfg, B, S_max, device=dev)
    log(f"shard decode (a) {DS_ARCH}: mesh {one.shape}, f-sharded "
        f"{ds.fshard} (2 x {cfg.param_count()} parameters / tp 1 > 8e9), "
        f"sequence over {ds.seq_axes}, batch {B} against {S_max} slots")
    assert ds.fshard, "repro's rule puts Qwen3-4B at tp 1 in the f-sharded"

    _build.reset_launches()
    logits, (kp, vp) = tr.lm_prefill(model, prompts)
    cache = tr.init_cache(cfg, B, S_max, device=dev)
    cache[0][..., :S, :] = kp
    cache[1][..., :S, :] = vp
    params = ds.shard_params(model.tree())
    local = ds.shard_caches(cache)
    assert all(a.data_ptr() == c.data_ptr() for a, c in zip(local, cache))
    # one uncounted step at the last slot first (masked until a step
    # reaches it): the first-call costs stay out of the times
    ds.step(params, prompts[:, 0], local, S_max - 1)
    torch.cuda.synchronize()
    fed, errs, agree, sharded, lm_s, sh_s = [], [], [], [], [], []
    tok = torch.argmax(logits, dim=-1)
    collectives.reset_bytes()
    for i in range(DS_STEPS):
        fed.append(tok)
        (lg, _), s1 = timed(lambda: tr.lm_decode_step(model, tok, cache,
                                                      S + i))
        before = dict(_build.LAUNCHES)
        (sg, _), s2 = timed(lambda: ds.step(params, tok, local, S + i))
        assert dict(_build.LAUNCHES) == before, "a sharded step launched"
        lm_s.append(s1)
        sh_s.append(s2)
        errs.append(rel_l2(sg, lg))
        agree.append(torch.argmax(sg, -1) == torch.argmax(lg, -1))
        sharded.append(sg)
        tok = torch.argmax(lg, dim=-1)
    sent = {k: v / DS_STEPS for k, v in collectives.BYTES.items()}
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    share = float(torch.cat(agree).float().mean())
    lm_med, sh_med = statistics.median(lm_s), statistics.median(sh_s)
    slot_bytes = 2 * cache[0][..., 0, :].nbytes       # K and V, one slot
    weight_bytes = sum(p.nbytes for p in model.parameters()) \
        - model.embed.nbytes
    log(f"shard decode (a): {DS_STEPS} steps at batch {B} from position {S}:"
        f" lm_decode_step median {1e3 * lm_med} ms, sharded step median "
        f"{1e3 * sh_med} ms a step (means {1e3 * statistics.mean(lm_s)} / "
        f"{1e3 * statistics.mean(sh_s)})")
    log(f"shard decode (a) cache read a step: sharded {slot_bytes * S_max} "
        f"bytes (all {S_max} slots), lm_decode_step {slot_bytes * (S + 1)}"
        f"-{slot_bytes * (S + DS_STEPS)} (the live slots); weights "
        f"{weight_bytes} bytes; bound "
        f"{1e3 * (slot_bytes * S_max + weight_bytes) / HBM_BYTES_PER_S} ms "
        f"at {HBM_BYTES_PER_S} B/s")
    log(f"shard decode (a) against lm_decode_step: logits relative L2 max "
        f"{max(errs)} mean {statistics.mean(errs)} (limit 5e-2); greedy "
        f"tokens agree in {int(torch.cat(agree).sum())} of "
        f"{torch.cat(agree).numel()} = {share} (limit 0.95); launches "
        f"{launches} (flash: lm_decode_step's and the prefill's); bytes sent "
        f"a step {sent}; max_memory_allocated={peak} card: {smi_line()}")
    want = cfg.n_layers * (1 + DS_STEPS)
    assert launches["flash"] == want, (launches, want)
    assert sum(launches.values()) == want, launches
    for lg in sharded:
        assert lg.shape == (B, cfg.vocab) and lg.dtype == cfg.dtype
        assert bool(torch.isfinite(lg).all()), "non-finite sharded logits"
    assert max(errs) <= 5e-2, "sharded decode: logits part from the LM's"
    assert share >= 0.95, "sharded decode: greedy tokens part"
    profile_batch(f"shard decode (a) lm_decode_step at position "
                  f"{S + DS_STEPS}", lambda: tr.lm_decode_step(
                      model, tok, cache, S + DS_STEPS), lm_med)
    profile_batch(f"shard decode (a) sharded step at position "
                  f"{S + DS_STEPS}", lambda: ds.step(params, tok, local,
                                                     S + DS_STEPS), sh_med)

    # ---- int8: the bf16 cache freed first (both with the weights: 67 GB)
    del local, cache, lg, sg, _
    free_card()
    torch.cuda.reset_peak_memory_stats()
    dsq = decode_shard.build_decode_step(one, cfg, B, S_max, kv_quant=True,
                                         device=dev)
    qlocal = dsq.shard_caches(ds_caches(cfg, kp, vp, S_max, True, dev))
    del kp, vp
    dsq.step(params, prompts[:, 0], qlocal, S_max - 1)   # uncounted
    torch.cuda.synchronize()
    qerr, q_s = [], []
    for i, tok_i in enumerate(fed):
        before = dict(_build.LAUNCHES)
        (qg, _), s_ = timed(lambda: dsq.step(params, tok_i, qlocal, S + i))
        assert dict(_build.LAUNCHES) == before, "an int8 step launched"
        ref = sharded[i].float()
        qerr.append(float((qg.float() - ref).abs().max() / ref.abs().max()))
        q_s.append(s_)
        assert bool(torch.isfinite(qg).all()), "non-finite int8 logits"
    q_peak = torch.cuda.max_memory_allocated()
    q_med = statistics.median(q_s)
    q_slot = sum(c[..., 0, :].nbytes for c in qlocal[:2]) + sum(
        s[..., 0].nbytes for s in qlocal[2:])
    log(f"shard decode (a) int8 cache: median {1e3 * q_med} ms a step (mean "
        f"{1e3 * statistics.mean(q_s)}); max |int8 - bf16| / max |bf16| "
        f"of the logits: max {max(qerr)} mean {statistics.mean(qerr)} (limit "
        f"{DS_INT8_BAND}); cache read a step {q_slot * S_max} bytes; "
        f"max_memory_allocated={q_peak}")
    assert max(qerr) < DS_INT8_BAND, "int8 cache: logits part from bf16's"
    profile_batch(f"shard decode (a) int8 step at position {S + DS_STEPS}",
                  lambda: dsq.step(params, tok, qlocal, S + DS_STEPS), q_med)
    del qlocal, params, model, _
    free_card()


def ds_cut(arch, n_layers):
    import dataclasses
    from repro_torch import configs
    return dataclasses.replace(configs.get(arch).cfg, n_layers=n_layers)


def ds_layouts(cfg):
    return DS_LAYOUTS if not cfg.is_moe else DS_LAYOUTS[:1]


def ds_reference(dev, arch, n_layers) -> dict:
    """One process at the cut: the model from the seed, the K/V of an 8 x
    ``DS_PROMPT`` prompt (flash), and each layout's greedy run of the
    sharded step on a one-rank mesh (the tokens it feeds, its logits and
    routings)."""
    import torch
    from repro_torch.distributed import decode_shard
    from repro_torch.launch import mesh
    from repro_torch.models import transformer as tr
    cfg = ds_cut(arch, n_layers)
    model = tr.LM(cfg, seed=SEED, device=dev)
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, DS_PROMPT),
                            generator=torch.Generator()
                            .manual_seed(SEED + 5)).to(dev)
    logits, (kp, vp) = tr.lm_prefill(model, prompts)
    one = mesh.make_mesh((1, 1), DS_MESH[1])
    runs = {}
    for name, batch, q in ds_layouts(cfg):
        ds = decode_shard.build_decode_step(one, cfg, batch, DS_RANK_SLOTS,
                                            kv_quant=q, device=dev)
        caches = ds.shard_caches(ds_caches(
            cfg, kp[:, :, :batch], vp[:, :, :batch], DS_RANK_SLOTS, q, dev))
        params = ds.shard_params(model.tree())
        tok = torch.argmax(logits[:batch], dim=-1)
        fed, outs, routes = [], [], []
        with ds_routes(routes):
            for i in range(DS_RANK_STEPS):
                fed.append(tok)
                lg, _ = ds.step(params, tok, caches, DS_PROMPT + i)
                outs.append(lg.float().cpu())
                tok = torch.argmax(lg, dim=-1)
        runs[name] = {"fed": torch.stack(fed).cpu(),
                      "logits": torch.stack(outs), "routes": routes}
    return {"cfg": cfg, "k": kp.cpu(), "v": vp.cpu(), "runs": runs}


def ds_rank(rank, col, dev, inp):
    """Phase 4k (b, c), one of the ranks: for each cut, the model drawn
    from the seed and cut to this rank's pieces, then each layout's steps
    on the reference's tokens from its prompt's K/V."""
    import torch
    from repro_torch.distributed import decode_shard
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh
    from repro_torch.models import transformer as tr
    from repro_torch.runtime import collectives
    m = mesh.make_mesh(*DS_MESH)
    out = {}
    for arch, n_layers in DS_CUTS:
        part = inp[arch]
        cfg = ds_cut(arch, n_layers)
        steps = {name: decode_shard.build_decode_step(
            m, cfg, batch, DS_RANK_SLOTS, kv_quant=q, device=dev)
            for name, batch, q in ds_layouts(cfg)}
        first = next(iter(steps.values()))
        assert all(s.param_specs == first.param_specs
                   for s in steps.values())
        model = tr.LM(cfg, seed=SEED, device=dev)
        params = first.shard_params(model.tree())
        del model
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated(dev)
        for name, batch, q in ds_layouts(cfg):
            ds = steps[name]
            caches = ds.shard_caches(ds_caches(
                cfg, part["k"][:, :, :batch], part["v"][:, :, :batch],
                DS_RANK_SLOTS, q, "cpu"))
            fed = part["fed"][name]
            _build.reset_launches()
            collectives.reset_bytes()
            routes, outs, secs = [], [], []
            with ds_routes(routes):
                for i in range(DS_RANK_STEPS):
                    tok = ds.shard_token(fed[i].to(dev))
                    (lg, _), s_ = timed(lambda: ds.step(
                        params, tok, caches, DS_PROMPT + i))
                    outs.append(lg.float())      # numpy holds no bf16
                    secs.append(s_)
            out[f"{arch} {name}"] = {
                "logits": torch.stack(outs), "secs": secs,
                "bytes": dict(collectives.BYTES),
                "launches": dict(_build.LAUNCHES), "routes": routes,
                "held": held, "layout": (ds.seq_axes, tuple(ds.token_spec))}
            del caches, _
    return out


def ds_check(label, cfg, batch, ref, outs, spec) -> tuple[int, int]:
    """One layout of (b) or (c): the ranks' gathered logits against the
    one-process run, step by step (``DS_REL``), with the sequences whose
    routings part from the reference's left out: a sequence's first
    differing routing (in step, then layer order) must be a near tie
    (``DS_TIE``) and is printed; what follows from it in that sequence
    is not compared.  Returns (greedy tokens equal, (sequence, step)
    pairs compared)."""
    import numpy as np
    import torch
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh
    m = mesh.mesh_spec(*DS_MESH)
    full = sharding.assemble([o[label]["logits"] for o in outs],
                             sharding.P(None, *spec.logits_spec), m)
    want = ref["logits"]
    assert full.shape == want.shape, (full.shape, want.shape)
    flipped = set()
    if cfg.is_moe:
        per_step = len(ref["routes"]) // DS_RANK_STEPS    # MoE layers
        model_ax = m.axis_names.index("model")
        for r, o in enumerate(outs):
            routes = o[label]["routes"]
            assert len(routes) == len(ref["routes"])
            coords = mesh.mesh_spec(*DS_MESH, rank=r).coords
            if coords[model_ax]:
                # "model" (the minor axis) replicates the routed tokens:
                # the same experts as at model index 0
                twin = outs[r - coords[model_ax]][label]["routes"]
                assert all(np.array_equal(a[0], b[0])
                           for a, b in zip(routes, twin)), (label, r)
                continue
            rows = sharding.shard(torch.arange(batch), spec.token_spec,
                                  mesh.mesh_spec(*DS_MESH, rank=r))
            for j, ((idx, _), (ref_idx, gap)) in enumerate(
                    zip(routes, ref["routes"])):
                for a, row in enumerate(rows.tolist()):
                    if row in flipped or torch.equal(
                            torch.as_tensor(idx[a]), ref_idx[row]):
                        continue
                    log(f"shard decode {label}: rank {r} {coords} step "
                        f"{j // per_step} layer {j % per_step} sequence "
                        f"{row}: experts {idx[a].tolist()} against "
                        f"{ref_idx[row].tolist()}, the reference's k-th / "
                        f"(k+1)-th router logit gap {float(gap[row])} "
                        f"(near tie below {DS_TIE})")
                    assert float(gap[row]) < DS_TIE, "a routing moved"
                    flipped.add(row)
    keep = [b for b in range(batch) if b not in flipped]
    assert keep, f"{label}: every sequence's routing moved"
    errs = [rel_l2(full[i, keep], want[i, keep]) for i in range(len(want))]
    agree = full[:, keep].argmax(-1) == want[:, keep].argmax(-1)
    secs = [statistics.median(o[label]["secs"]) for o in outs]
    sent = [{k: v / DS_RANK_STEPS for k, v in o[label]["bytes"].items()}
            for o in outs]
    log(f"shard decode {label}: {len(outs)} ranks {DS_MESH}, seq over "
        f"{spec.seq_axes}, token {tuple(spec.token_spec)}: logits relative "
        f"L2 against one process max {max(errs)} mean "
        f"{statistics.mean(errs)} (limit {DS_REL}); greedy tokens equal "
        f"{int(agree.sum())} of {agree.numel()}; sequences left out for "
        f"near-tie routings {sorted(flipped)}; ms a step by rank "
        f"{[1e3 * s for s in secs]}; bytes sent a step by rank {sent}; "
        f"memory held by rank {[o[label]['held'] for o in outs]}")
    for o in outs:
        assert not any(o[label]["launches"].values()), o[label]["launches"]
        assert o[label]["layout"] == (spec.seq_axes,
                                      tuple(spec.token_spec))
    assert max(errs) <= DS_REL, f"{label}: the ranks part from one process"
    return int(agree.sum()), agree.numel()


def ds_ranks(dev):
    """Phase 4k (b, c): ``DS_MESH`` over four gloo ranks sharing the card
    (one spawn), each cut against the one-process sharded step in this
    process: Qwen3-4B at full width cut to 4 layers in the standard, int8
    and tiny-batch layouts, deepseek-moe-16b at full width cut to 2 layers
    (dropless MoE, standard layout), ``DS_RANK_STEPS`` steps each from a
    ``DS_PROMPT``-token prompt against ``DS_RANK_SLOTS`` slots, so the
    writes cross the 2048-slot boundary of both layouts' shards."""
    import torch
    from repro_torch.distributed import decode_shard
    from repro_torch.launch import mesh
    free_card()
    refs, inp = {}, {}
    t0 = time.perf_counter()
    for arch, n_layers in DS_CUTS:
        refs[arch] = ds_reference(dev, arch, n_layers)
        inp[arch] = {"k": refs[arch]["k"], "v": refs[arch]["v"],
                     "fed": {name: run["fed"] for name, run
                             in refs[arch]["runs"].items()}}
        free_card()
    log(f"shard decode (b, c): one-process runs {time.perf_counter() - t0} s")
    t0 = time.perf_counter()
    outs = mesh.spawn(ds_rank, DS_MESH[0][0] * DS_MESH[0][1], "gloo",
                      torch.device("cuda", dev.index or 0), args=(inp,),
                      timeout=DS_TIMEOUT_S)
    log(f"shard decode (b, c): {len(outs)} gloo ranks, spawn+run "
        f"{time.perf_counter() - t0} s")
    spec_mesh = mesh.mesh_spec(*DS_MESH)
    for arch, n_layers in DS_CUTS:
        cfg = refs[arch]["cfg"]
        equal = pairs = 0
        for name, batch, q in ds_layouts(cfg):
            spec = decode_shard.build_decode_step(
                spec_mesh, cfg, batch, DS_RANK_SLOTS, kv_quant=q,
                device="cpu")
            e, p = ds_check(f"{arch} {name}", cfg, batch,
                            refs[arch]["runs"][name], outs, spec)
            equal, pairs = equal + e, pairs + p
        log(f"shard decode {arch} ({n_layers} layers): greedy tokens equal "
            f"{equal} of {pairs} = {equal / pairs} (limit {DS_TOKENS})")
        assert equal >= DS_TOKENS * pairs, f"{arch}: greedy tokens part"


def shard_decode_phase(dev):
    """Phase 4k: the sharded LM decode, (a) in this process, (b, c) on
    four gloo ranks."""
    t_phase = time.perf_counter()
    ds_one(dev)
    log(f"shard decode (a): {time.perf_counter() - t_phase} s")
    t0 = time.perf_counter()
    ds_ranks(dev)
    log(f"shard decode (b, c): {time.perf_counter() - t0} s")
    log(f"shard decode phase: {time.perf_counter() - t_phase} s")


# ---------------------------------------------------------------------------
# phase 4g: the GAT
# ---------------------------------------------------------------------------

GNN_STEPS = 3
GNN_RANKS = 4                # gloo ranks sharing the card for the check
GNN_TIMEOUT_S = 600
GNN_EDGE_SHARE = 0.9         # of the free memory, for ogb_products' step


def gnn_small_graph(parts: int):
    """full_graph_sm's random graph (numpy, from the seed): features
    N(0, 1), edges whose destinations fall ``parts`` equal blocks of
    nodes in turn (the sharded layout), labels uniform, half the nodes
    masked in."""
    import numpy as np
    from repro_torch.configs import gat_cora
    n, e, f, c = gat_cora.CELL_DIMS["full_graph_sm"]
    rng = np.random.default_rng(SEED + 20)
    feats = rng.standard_normal((n, f), dtype=np.float32)
    src = rng.integers(0, n, e, dtype=np.int32)
    blk, per = n // parts, e // parts
    dst = np.concatenate([rng.integers(r * blk, (r + 1) * blk, per,
                                       dtype=np.int32)
                          for r in range(parts)])
    labels = rng.integers(0, c, n, dtype=np.int32)
    mask = rng.random(n) < 0.5
    return feats, src, dst, labels, mask


def ogb_edge_cut(free: int, n_nodes: int, n_edges: int, cfg):
    """(j, edges, bytes): the least j for which a step on ogb_products'
    edges cut to 1/2^j fits ``GNN_EDGE_SHARE`` of ``free`` bytes,
    reckoned from the last layer's backward: four [E, heads, classes] f32
    tensors (the gathered sources, the messages' gradient, its product
    with the sources, the sources' gradient) and 16 [E, heads] f32
    temporaries an edge, three [N, heads, classes] f32 tensors a node
    (the gathered embeddings, their gradient, the output's).  At 1/32
    this reckons 23.6 GB; a step there peaked at 22.3 GB on an H100."""
    for j in range(12):
        e = n_edges >> j
        need = 4 * cfg.n_heads * (e * (4 * cfg.n_classes + 16)
                                  + 3 * n_nodes * cfg.n_classes)
        if need <= GNN_EDGE_SHARE * free:
            return j, e, need
    raise AssertionError("ogb_products: no edge cut fits")


def gnn_cell_inputs(cell, cfg, dev):
    """The cell's random graph at ``CELL_DIMS`` on ``dev``: (feats, src,
    dst, labels, mask, note)."""
    import numpy as np
    import torch
    from repro_torch.configs import gat_cora
    from repro_torch.models import gnn
    n, e, f, c = gat_cora.CELL_DIMS[cell]
    g = torch.Generator(device=dev).manual_seed(SEED + 21)
    note = {}
    if cell == "full_graph_sm":
        arrays = gnn_small_graph(GNN_RANKS)
        return (*(torch.from_numpy(a).to(dev) for a in arrays), note)
    if cell == "molecule":
        # 128 graphs of 32 nodes (30 atoms + padding), 64 edges each
        rng = np.random.default_rng(SEED + 22)
        graph = np.repeat(np.arange(128, dtype=np.int32), e // 128) * 32
        src = graph + rng.integers(0, 32, e, dtype=np.int32)
        dst = graph + rng.integers(0, 32, e, dtype=np.int32)
        feats = torch.randn(n, f, generator=g, device=dev)
        labels = torch.randint(0, c, (n,), generator=g, device=dev,
                               dtype=torch.int32)
        mask = torch.rand(n, generator=g, device=dev) < 0.5
        return (feats, torch.from_numpy(src).to(dev),
                torch.from_numpy(dst).to(dev), labels, mask, note)
    if cell == "minibatch_lg":
        # Reddit-scale graph on the host, dst in order (each node's
        # in-degree drawn first), then 1024 seeds sampled at 15-10
        rng = np.random.default_rng(SEED + 23)
        t0 = time.perf_counter()
        counts = rng.multinomial(e, np.full(n, 1.0 / n))
        dst = np.repeat(np.arange(n, dtype=np.int32), counts)
        src = rng.integers(0, n, e, dtype=np.int32)
        note["graph_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        sampler = gnn.NeighborSampler(n, src, dst)
        note["sampler_init_s"] = time.perf_counter() - t0
        del src, dst
        seeds = rng.choice(n, gat_cora.BATCH_NODES, replace=False)
        t0 = time.perf_counter()
        nodes, s_src, s_dst = sampler.sample(rng, seeds, gat_cora.FANOUTS)
        note["sample_s"] = time.perf_counter() - t0
        del sampler
        nodes_t = torch.from_numpy(nodes).to(dev)
        feats = torch.randn(n, f, generator=g, device=dev)[nodes_t]
        labels = torch.randint(0, c, (n,), generator=g, device=dev,
                               dtype=torch.int32)[nodes_t]
        mask = torch.zeros(len(nodes), dtype=torch.bool, device=dev)
        mask[:gat_cora.BATCH_NODES] = True
        note.update(nodes=len(nodes), edges=len(s_src))
        return (feats, torch.from_numpy(s_src).to(dev),
                torch.from_numpy(s_dst).to(dev), labels, mask, note)
    # ogb_products: every node, the edges cut to what fits
    free, _ = torch.cuda.mem_get_info()
    j, e_cut, need = ogb_edge_cut(free - n * f * 4, n, e, cfg)
    note.update(edge_cut=f"1/{2 ** j}", edges=e_cut, reckoned_bytes=need,
                free_bytes=free)
    feats = torch.randn(n, f, generator=g, device=dev)
    src = torch.randint(0, n, (e_cut,), generator=g, device=dev,
                        dtype=torch.int32)
    dst = torch.randint(0, n, (e_cut,), generator=g, device=dev,
                        dtype=torch.int32)
    labels = torch.randint(0, c, (n,), generator=g, device=dev,
                           dtype=torch.int32)
    mask = torch.rand(n, generator=g, device=dev) < 0.5
    return feats, src, dst, labels, mask, note


def gnn_params(cfg, dev):
    """The GAT's parameters from the seed (drawn on the host, moved) and
    their AdamW state."""
    import torch
    from repro_torch.models import gnn
    from repro_torch.train import optimizer
    params = [{k: t.to(dev) for k, t in layer.items()} for layer in
              gnn.init_gat(torch.Generator().manual_seed(SEED), cfg)]
    return params, optimizer.adamw_init(params)


def gnn_rank(rank, col, dev):
    """Phase 4g on one NCCL rank (``launch.mesh.spawn``): each gat-cora
    cell's ``GNN_STEPS`` steps of ``launch.steps.gnn_train_step`` on its
    random graph, counted; losses, seconds a step, peak memory."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.launch import steps
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = configs.get("gat-cora")
    out = {}
    for cell in spec.shapes:
        cfg = spec.cell_cfg(cell)
        free_card()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        feats, src, dst, labels, mask, note = gnn_cell_inputs(cell, cfg, dev)
        params, opt = gnn_params(cfg, dev)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        _build.reset_launches()
        losses, step_s = [], []
        for _ in range(GNN_STEPS):
            t0 = time.perf_counter()
            params, opt, loss = steps.gnn_train_step(
                params, opt, cfg, feats, src, dst, labels, mask, col)
            losses.append(float(loss))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        out[cell] = {"losses": losses, "step_s": step_s, "setup_s": setup_s,
                     "peak": torch.cuda.max_memory_allocated(),
                     "launches": sum(_build.LAUNCHES.values()),
                     "shape": (tuple(feats.shape), int(src.shape[0])),
                     "quantized_gather": cfg.quantized_gather, **note}
        del feats, src, dst, labels, mask, params, opt, loss
    return out


def gnn_shard_rank(rank, col, dev, inp):
    """``gat_loss_local`` on this rank's rows and edges of full_graph_sm,
    exact and quantized gathers."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.models import gnn
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get("gat-cora").cell_cfg("full_graph_sm")
    feats, src, dst, labels, mask = inp["graph"]
    n_loc, e_loc = feats.shape[0] // col.n_shards, src.shape[0] // col.n_shards
    rows, cut = slice(rank * n_loc, (rank + 1) * n_loc), slice(
        rank * e_loc, (rank + 1) * e_loc)
    args = [torch.from_numpy(a).to(dev) for a in (
        feats[rows], src[cut], dst[cut], labels[rows], mask[rows])]
    params = [{k: torch.from_numpy(a).to(dev) for k, a in layer.items()}
              for layer in inp["params"]]
    with torch.no_grad():
        return {q: float(gnn.gat_loss_local(
            params, dataclasses.replace(cfg, quantized_gather=q), *args,
            col)) for q in (False, True)}


def gnn_phase(dev):
    """Phase 4g: the GAT at each gat-cora cell on one NCCL rank
    (``gnn_rank``), full_graph_sm's losses against the same steps on the
    CPU, then ``gat_loss_local`` on full_graph_sm over ``GNN_RANKS`` gloo
    ranks sharing the card against one process, exact and quantized."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.launch import mesh, steps
    from repro_torch.models import gnn
    from repro_torch.runtime.collectives import NullCollectives
    t_phase = time.perf_counter()
    free_card()
    t0 = time.perf_counter()
    (one,) = mesh.spawn(gnn_rank, 1, "nccl", timeout=GNN_TIMEOUT_S)
    log(f"gnn nccl x1: spawn+run {time.perf_counter() - t0} s")
    for cell, r in one.items():
        log(f"gnn {cell}: {r}")
        assert all(math.isfinite(x) for x in r["losses"]), (cell, r)
        assert r["launches"] == 0, (cell, r["launches"])
    log(f"gnn card: {smi_line()}")

    # full_graph_sm's steps on the CPU, one process
    spec = configs.get("gat-cora")
    cfg = spec.cell_cfg("full_graph_sm")
    cpu = torch.device("cpu")
    graph = gnn_small_graph(GNN_RANKS)
    args = [torch.from_numpy(a) for a in graph]
    params, opt = gnn_params(cfg, cpu)
    init = [{k: t.detach().numpy().copy() for k, t in layer.items()}
            for layer in params]
    cpu_losses = []
    for _ in range(GNN_STEPS):
        params, opt, loss = steps.gnn_train_step(params, opt, cfg, *args,
                                                 NullCollectives())
        cpu_losses.append(float(loss))
    card = one["full_graph_sm"]["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(card, cpu_losses)]
    log(f"gnn full_graph_sm losses: card {card}, CPU {cpu_losses}, "
        f"relative differences {rel} (limit 1e-5)")
    assert max(rel) <= 1e-5, "gnn full_graph_sm: card and CPU part"

    # gat_loss_local over GNN_RANKS gloo ranks against one process
    t0 = time.perf_counter()
    outs = mesh.spawn(gnn_shard_rank, GNN_RANKS, "gloo",
                      torch.device("cuda", dev.index or 0),
                      args=({"graph": graph, "params": init},),
                      timeout=GNN_TIMEOUT_S)
    shard_s = time.perf_counter() - t0
    dev_args = [t.to(dev) for t in args]
    dev_params = [{k: torch.from_numpy(a).to(dev) for k, a in layer.items()}
                  for layer in init]
    with torch.no_grad():
        whole = {q: float(gnn.gat_loss_local(
            dev_params, dataclasses.replace(cfg, quantized_gather=q),
            *dev_args, NullCollectives())) for q in (False, True)}
    log(f"gnn gat_loss_local on {GNN_RANKS} gloo ranks sharing the card "
        f"(spawn+run {shard_s} s): exact {[o[False] for o in outs]}, "
        f"quantized {[o[True] for o in outs]}; one process: exact "
        f"{whole[False]}, quantized {whole[True]}")
    for o in outs:
        for q in (False, True):
            assert abs(o[q] - whole[q]) <= 1e-5 * abs(whole[q]), (q, o, whole)
    drift = abs(whole[True] - whole[False]) / abs(whole[False])
    log(f"gnn quantized against exact loss: {drift} (repro's limit 0.05)")
    assert drift < 0.05, "gnn: the int8 gather moved the loss"
    log(f"gnn phase: {time.perf_counter() - t_phase} s")


# ---- phase 4c: the global-program cells of launch/steps.py ------------------

CELL_LM_LAYERS = 24          # (a) Qwen3-4B train_4k: 24 of 36 layers (16
                             # bytes a parameter: 51 GB; all 36: 71 GB)
CELL_LM_SEQ = 2048           # train_4k's 256 x 4096 cut to one row of
                             # 2048 a microbatch
CELL_LM_STEPS = 2
CELL_TRAIN_BAND = dict(loss=1e-4, cos=0.99)  # (a), (e) against the plain
                             # rerun: losses' relative difference, the
                             # updates' cosine; the control (attention on
                             # q, k, v rounded to e4m3) must fall outside
CELL_LM_BAND = 5e-2          # (b), (e): phase 4l's logits band
CELL_MOE_LAYERS = 2          # (e) deepseek-moe-16b cut to 2 of 28 layers
CELL_DCN_BAND = 2e-5         # (c): phase 4r's, of each logit's term scale
CELL_DCN_PARAM_BAND = 1e-5   # (c) train: Adagrad at lr 1e-2 on the same
                             # gradients up to the cross route's rounding
CELL_GNN = "full_graph_sm"
CELL_GNN_BAND = 1e-5         # (f) losses: the segment sums' index_add
                             # order is unspecified (atomics on the card)
CELL_GNN_PARAM_BAND = 1e-5   # (f) parameters after the first step, all
CELL_GNN_PARTED = 1e-3       # but this share of them: AdamW's first step
                             # is ~lr sign(g), so only a gradient within
                             # the summation order's rounding of 0 or of
                             # its eps parts the two (at most 1 of 95,536
                             # elements, gnn_train_step against itself on
                             # the CPU).  Later steps are printed, not
                             # held: the first step's differences grow
                             # through the forward (20% of the elements
                             # past 1e-5 after 3 steps, the same test)


def cut_spec(arch, n_layers, shape, inputs):
    """``arch``'s spec with its config cut to ``n_layers`` and ``shape``'s
    inputs replaced by ``inputs`` (``{name: (shape, dtype)}``)."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.configs.base import ArchSpec, ShapeCell
    spec = configs.get(arch)
    cfg = spec.cfg if n_layers is None else dataclasses.replace(
        spec.cfg, n_layers=n_layers)
    kind = spec.shapes[shape].kind
    return ArchSpec(arch, spec.family, cfg, {
        shape: ShapeCell(kind, lambda c: inputs, spec.shapes[shape].note)})


def full_host(tree):
    """A DTensor tree's whole leaves on the host, by path."""
    from repro_torch.convert import _flatten
    return {k: v.full_tensor().detach().to("cpu", copy=True)
            for k, v in _flatten(tree)}


def counted_launches(counted, launches):
    for k, v in launches.items():
        if v:
            counted[k] = counted.get(k, 0) + v


def e4m3_attention(q, k, v, **kw):
    """The train check's control: the plain attention on q, k and v
    rounded to float8 e4m3 in the forward pass (straight through in the
    backward), a lower-precision attention that ``CELL_TRAIN_BAND`` must
    refuse."""
    import torch
    from repro_torch.kernels.flash import ref as fref

    def rounded(t):
        return t + (t.to(torch.float8_e4m3fn).to(t.dtype) - t).detach()

    return fref.chunked_attention(rounded(q), rounded(k), rounded(v), **kw)


def update_agreement(p0, got, ref, dev):
    """Two runs' updates from ``p0`` (host trees by path), leaf by leaf on
    the card: (cosine, share of elements whose signs part, parameters'
    relative L2)."""
    num = den_k = den_p = diff = norm = 0.0
    flips = total = 0
    for k, v0 in p0.items():
        v0, gk, gp = (t.to(dev).double() for t in (v0, got[k], ref[k]))
        uk, up = gk - v0, gp - v0
        num += float((uk * up).sum())
        den_k += float((uk * uk).sum())
        den_p += float((up * up).sum())
        flips += int(((uk > 0) != (up > 0)).sum())
        total += uk.numel()
        diff += float((gk - gp).pow(2).sum())
        norm += float(gp.pow(2).sum())
        del v0, gk, gp, uk, up
    return (num / math.sqrt(den_k * den_p), flips / total,
            math.sqrt(diff / norm))


def cells_lm_train(m, dev, arch, n_layers, seq, counted):
    """``train_4k`` of ``arch`` cut to ``n_layers`` and one row of ``seq``
    tokens in each of its microbatches, ``CELL_LM_STEPS`` steps through
    the cell, counted; the same steps again under ``plain_path()`` from
    the same seed, the losses and the updates held to
    ``CELL_TRAIN_BAND``, and a third time with ``e4m3_attention``, which
    the band must refuse.  A MoE model's reruns take the counted run's
    routings (``force_routing``), as phase 4m's do: a bf16 near tie in a
    router would otherwise send a token to another expert."""
    import torch
    from repro_torch import configs
    from repro_torch.convert import _flatten
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash import ops as fops
    from repro_torch.launch import steps, train
    from repro_torch.models import transformer as tr
    from repro_torch.train import optimizer
    B = configs.get(arch).cfg.microbatches
    spec = cut_spec(arch, n_layers, "train_4k", {
        "tokens": ((B, seq), torch.int32), "labels": ((B, seq), torch.int32)})
    cfg = spec.cfg
    cell = steps.build_lm_cell(spec, "train_4k", m)
    tokens = [train.zipf_tokens(cfg.vocab, (B, seq + 1), SEED, i, dev)
              for i in range(CELL_LM_STEPS)]
    routes = []

    def routing(first):
        if not cfg.is_moe:
            return contextlib.nullcontext()
        return capture_routing(routes) if first else force_routing(routes,
                                                                   [])

    def run(count):
        model = tr.LM(cfg, seed=SEED, device=dev)
        params = model.tree()
        p0 = ({k: v.detach().to("cpu", copy=True) for k, v in
               _flatten(params)} if count else None)
        p, o = cell.from_full((params, optimizer.adamw_init(params)))
        del model, params
        free_card()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        losses, step_s = [], []
        with routing(count):
            for t in tokens:
                t0 = time.perf_counter()
                p, o, loss = cell.step_fn(p, o, *cell.from_full(
                    (t[:, :-1], t[:, 1:]), first=2))
                losses.append(float(loss.full_tensor()))
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
        launches = dict(_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        out = full_host(p)
        del p, o, loss
        free_card()
        return losses, step_s, launches, peak, out, p0

    losses, step_s, launches, peak, got, p0 = run(True)
    want = CELL_LM_STEPS * cfg.microbatches * 2 * cfg.n_layers
    log(f"cells {arch} train_4k ({cfg.n_layers} layers, {B} x {seq}, "
        f"{cfg.microbatches} microbatches, remat {cfg.remat}): losses "
        f"{losses}; seconds per step {step_s}; max_memory_allocated={peak}; "
        f"launches {launches} (want flash {want})")
    assert launches.get("flash") == want and sum(launches.values()) == want, \
        (launches, want)
    assert all(math.isfinite(x) for x in losses), losses
    assert all(torch.isfinite(v.float()).all() for v in got.values())
    counted_launches(counted, launches)
    with plain_path():
        p_losses, p_step_s, p_launches, _, ref, _ = run(False)
        assert not sum(p_launches.values()), p_launches
        with mock.patch.object(fops, "attention", e4m3_attention):
            c_losses, _, c_launches, _, ctl, _ = run(False)
        assert not sum(c_launches.values()), c_launches
    band = CELL_TRAIN_BAND
    read = {}
    for label, out, ls in (("kernel", got, losses), ("e4m3 control", ctl,
                                                     c_losses)):
        d_loss = max(abs(a - b) / abs(b) for a, b in zip(ls, p_losses))
        cos, flips, p_rel = update_agreement(p0, out, ref, dev)
        read[label] = dict(loss_rel=d_loss, cos=cos, flips=flips,
                           param_rel=p_rel,
                           held=d_loss <= band["loss"] and cos >= band["cos"])
    del got, ref, ctl, p0
    log(f"cells {arch} train_4k against the plain rerun (losses "
        f"{p_losses}, seconds per step {p_step_s}; control losses "
        f"{c_losses}): {read} (band: loss rel <= {band['loss']}, cosine >= "
        f"{band['cos']})")
    assert read["kernel"]["held"], read["kernel"]
    assert not read["e4m3 control"]["held"], (
        f"{arch}: the train band passes the e4m3 control")
    return {"losses": losses, "step_s": step_s, "peak": peak, **read}


def cells_lm_prefill(m, dev, arch, n_layers, counted):
    """``prefill_32k`` of ``arch`` (cut to ``n_layers`` where given) at
    phase 4l's 8 x 2048 through the cell, counted, against
    ``lm_prefill`` on the same weights (one rank runs the same ops on the
    same tensors: expected bit for bit; held to phase 4l's band)."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tr
    spec = cut_spec(arch, n_layers, "prefill_32k",
                    {"tokens": ((LM_BATCH, LM_PROMPT), torch.int32)})
    cfg = spec.cfg
    model = tr.LM(cfg, seed=SEED, device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 40)
    tokens = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), generator=g,
                           device=dev, dtype=torch.int32)
    cell = steps.build_lm_cell(spec, "prefill_32k", m)
    args = cell.from_full((model.tree(), tokens))
    free_card()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    logits, (kc, vc) = cell.step_fn(*args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    logits, kc, vc = (t.full_tensor() for t in (logits, kc, vc))
    with torch.no_grad():
        ref, (rk, rv) = tr.lm_prefill(model, tokens)
    exact = all(torch.equal(a, b) for a, b in ((logits, ref), (kc, rk),
                                               (vc, rv)))
    errs = [rel_l2(logits, ref), rel_l2(kc, rk), rel_l2(vc, rv)]
    log(f"cells {arch} prefill_32k ({cfg.n_layers} layers, {LM_BATCH} x "
        f"{LM_PROMPT}): {secs} s, max_memory_allocated={peak}, launches "
        f"{launches}; against lm_prefill: bit-equal {exact}, rel L2 "
        f"logits/k/v {errs} (band {CELL_LM_BAND})")
    want = cfg.n_layers
    assert launches.get("flash") == want and sum(launches.values()) == want, \
        (launches, want)
    assert max(errs) <= CELL_LM_BAND, errs
    counted_launches(counted, launches)
    del model, logits, kc, vc, ref, rk, rv, args
    free_card()
    return {"secs": secs, "peak": peak, "bit_equal": exact, "rel_l2": errs}


def cells_dcn(m, dev, counted):
    """DCN-v2 at its published config: ``train_batch`` (65536 rows, one
    Adagrad step), ``serve_p99``, ``serve_bulk`` and ``retrieval_cand``
    (2^20 rows) through their cells, counted, each against the same cell
    under ``plain_path()``: logits within ``CELL_DCN_BAND`` of each
    logit's term scale, the train loss and parameters too."""
    import torch
    from repro_torch import configs
    from repro_torch.configs import recsys_shapes as rs
    from repro_torch.convert import _flatten
    from repro_torch.kernels import _build
    from repro_torch.launch import steps
    from repro_torch.models.recsys import dcn_v2
    from repro_torch.train import optimizer
    spec = configs.get("dcn-v2")
    cfg = spec.cfg
    g = torch.Generator(device=dev).manual_seed(SEED + 41)
    out = {}

    def model():
        return dcn_v2.DCNv2(cfg, seed=SEED, device=dev)

    dense, sparse = dcn_traffic(g, cfg, rs.TRAIN_B, dev)
    labels = (torch.rand(rs.TRAIN_B, generator=g, device=dev) < 0.3).float()
    cell = steps.build_cell("dcn-v2", "train_batch", m)

    def train_run():
        params = model().tree()
        args = cell.from_full((params, optimizer.adagrad_init(params), dense,
                               sparse, labels))
        _build.reset_launches()
        t0 = time.perf_counter()
        p, _, loss = cell.step_fn(*args)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        return (float(loss.full_tensor()), {k: v.full_tensor() for k, v in
                                            _flatten(p)},
                dict(_build.LAUNCHES), secs)

    free_card()
    torch.cuda.reset_peak_memory_stats()
    loss, params, launches, secs = train_run()
    peak = torch.cuda.max_memory_allocated()
    counted_launches(counted, launches)
    with plain_path():
        p_loss, p_params, p_launches, _ = train_run()
    assert not sum(p_launches.values()), p_launches
    d_param = max(float((params[k] - p_params[k]).abs().max())
                  for k in params)
    log(f"cells dcn-v2 train_batch ({rs.TRAIN_B} rows): {secs} s, "
        f"max_memory_allocated={peak}, launches {launches}; loss {loss} "
        f"against plain {p_loss}; parameters max |diff| {d_param} (band "
        f"{CELL_DCN_PARAM_BAND})")
    assert launches.get("cross") == cfg.n_cross_layers, launches
    assert abs(loss - p_loss) <= CELL_DCN_BAND * abs(p_loss), (loss, p_loss)
    assert d_param <= CELL_DCN_PARAM_BAND, d_param
    out["train_batch"] = {"secs": secs, "peak": peak, "loss": loss,
                          "param_diff": d_param}
    del params, p_params
    free_card()

    mdl = model()
    for shape, rows in (("serve_p99", rs.P99_B), ("serve_bulk", rs.BULK_B),
                        ("retrieval_cand", rs.N_CAND_RETR)):
        cell = steps.build_cell("dcn-v2", shape, m)
        d, s = dcn_traffic(g, cfg, rows, dev)
        args = cell.from_full((mdl.tree(), d, s))
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        got = cell.step_fn(*args).full_tensor()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        counted_launches(counted, launches)
        with plain_path():
            ref = cell.step_fn(*args).full_tensor()
            with torch.no_grad():
                scale = dcn_term_scale(mdl, d, s)
        err = float(((got - ref).abs() / scale).max())
        log(f"cells dcn-v2 {shape} ({rows} rows): {secs} s, "
            f"max_memory_allocated={peak}, launches {launches}; logits "
            f"against plain: max |diff| / term scale {err} (band "
            f"{CELL_DCN_BAND})")
        assert launches.get("cross") == cfg.n_cross_layers, launches
        assert err <= CELL_DCN_BAND, (shape, err)
        out[shape] = {"secs": secs, "peak": peak, "err": err}
        del d, s, args, got, ref, scale
        free_card()
    return out


def cells_bandit(m, dev, theta, counted):
    """``distclub-paper`` ``online_20k``: one epoch through the cell on
    phase 4's environment, counted, against ``distclub_shard``'s epoch on
    the same rank and environment (phase 4x's one-NCCL-rank runtime):
    every field of the state, the metrics and the cluster count equal."""
    import torch
    from repro_torch import configs
    from repro_torch.configs import distclub_paper as paper
    from repro_torch.core import env, env_ops
    from repro_torch.distributed import distclub_shard
    from repro_torch.kernels import _build
    from repro_torch.launch import steps
    spec = configs.get("distclub-paper")
    hyper = spec.cfg
    ops = env_ops.synthetic_ops(env.SyntheticEnv(theta, hyper.n_candidates))
    col = m.col(("data", "model"))
    init, epoch = distclub_shard.make_runtime(
        col, paper.N_USERS, paper.D_FEAT, hyper, ops, device=dev)
    cell = steps.build_bandit_cell(spec, "online_20k", m, device=dev,
                                   ops=ops)
    args = cell.to_args((init(), torch.tensor([SEED, 0], device=dev)))
    free_card()
    _build.reset_launches()
    t0 = time.perf_counter()
    state, metrics, n_clu = cell.step_fn(*args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    counted_launches(counted, launches)
    ref, r_metrics, r_clu = epoch(init(), SEED, 0)
    equal = {f: torch.equal(getattr(state, f).to_local(), getattr(ref, f))
             for f in ref._fields}
    equal["metrics"] = all(torch.equal(a, b) for a, b in zip(metrics,
                                                            r_metrics))
    log(f"cells distclub-paper online_20k: one epoch {secs} s, launches "
        f"{launches}, clusters {int(n_clu)} (distclub_shard {int(r_clu)}); "
        f"equal to distclub_shard's epoch: {equal}")
    assert all(equal.values()) and int(n_clu) == int(r_clu), equal
    for k in ("choose", "rank1_update_inv", "prune", "cc_hop"):
        assert launches.get(k, 0) > 0, (k, launches)
    return {"secs": secs, "clusters": int(n_clu)}


def cells_gnn(m, dev):
    """One GAT cell (``CELL_GNN``) through ``build_cell``, ``GNN_STEPS``
    steps, against ``gnn_train_step`` on the same rank: losses within
    ``CELL_GNN_BAND``; the parameters after the first step within
    ``CELL_GNN_PARAM_BAND`` but for at most ``CELL_GNN_PARTED`` of them,
    after the last printed."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import steps
    from repro_torch.runtime.collectives import NullCollectives
    spec = configs.get("gat-cora")
    cfg = spec.cell_cfg(CELL_GNN)
    feats, src, dst, labels, mask, _ = gnn_cell_inputs(CELL_GNN, cfg, dev)
    cell = steps.build_cell("gat-cora", CELL_GNN, m)
    params, opt = gnn_params(cfg, dev)
    p, o, *graph = cell.from_full((params, opt, feats, src, dst, labels,
                                   mask))
    rp, ro = gnn_params(cfg, dev)

    def apart(p, rp):
        """(elements past the band, of how many, max |diff|)."""
        parted = total = 0
        d_max = 0.0
        for la, lb in zip(p, rp):
            for name, a in la.items():
                d = (a.full_tensor() - lb[name]).detach().abs()
                parted += int((d > CELL_GNN_PARAM_BAND).sum())
                total += d.numel()
                d_max = max(d_max, float(d.max()))
        return parted, total, d_max

    losses, ref, step_s, parts = [], [], [], []
    for _ in range(GNN_STEPS):
        t0 = time.perf_counter()
        p, o, loss = cell.step_fn(p, o, *graph)
        losses.append(float(loss.full_tensor()))
        step_s.append(time.perf_counter() - t0)
        rp, ro, rl = steps.gnn_train_step(rp, ro, cfg, feats, src, dst,
                                          labels, mask, NullCollectives())
        ref.append(float(rl))
        parts.append(apart(p, rp))
    d_loss = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
    log(f"cells gat-cora {CELL_GNN}: losses {losses} (gnn_train_step "
        f"{ref}: rel {d_loss}, band {CELL_GNN_BAND}); parameters past "
        f"{CELL_GNN_PARAM_BAND} after each step (parted, of, max |diff|): "
        f"{parts} (after the first, limit {CELL_GNN_PARTED} of them); "
        f"seconds per step {step_s}")
    parted, total, _ = parts[0]
    assert d_loss <= CELL_GNN_BAND, (losses, ref)
    assert parted <= CELL_GNN_PARTED * total, parts
    return {"losses": losses, "step_s": step_s}


def cells_phase(dev, theta):
    """Phase 4c: the global-program cells of ``launch.steps`` on one NCCL
    rank (a one-rank ``DeviceMesh`` on ``cuda:0``, process group in this
    process): (a) Qwen3-4B ``train_4k`` cut to ``CELL_LM_LAYERS`` layers
    and 8 x ``CELL_LM_SEQ`` (one row a microbatch), remat,
    AdamW, against its plain rerun; (b) Qwen3-4B ``prefill_32k`` at 8 x
    2048, full depth, against ``lm_prefill``; (c) DCN-v2's four cells at
    their published rows against their plain reruns; (d) ``online_20k``
    against ``distclub_shard``; (e) deepseek-moe-16b's train and prefill
    cut to ``CELL_MOE_LAYERS`` layers (the rank's expert block); (f) a GAT
    cell against ``gnn_train_step``.  Returns the launches of the cells'
    counted runs by kernel."""
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    t_phase = time.perf_counter()
    free_card()
    held = torch.cuda.memory_allocated()
    counted = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cells_")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        m = mesh_lib.make_mesh((1, 1), ("data", "model"), "cuda")
        log(f"cells: one NCCL rank, mesh {m.shape}, device mesh "
            f"{m.device_mesh}; {held} bytes held by earlier phases")
        secs = {}
        t0 = time.perf_counter()
        cells_lm_train(m, dev, LM_ARCH, CELL_LM_LAYERS, CELL_LM_SEQ, counted)
        secs["a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cells_lm_prefill(m, dev, LM_ARCH, None, counted)
        secs["b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cells_dcn(m, dev, counted)
        secs["c"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cells_bandit(m, dev, theta, counted)
        secs["d"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cells_lm_train(m, dev, "deepseek-moe-16b", CELL_MOE_LAYERS,
                       LM_PROMPT, counted)
        cells_lm_prefill(m, dev, "deepseek-moe-16b", CELL_MOE_LAYERS,
                         counted)
        secs["e"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cells_gnn(m, dev)
        secs["f"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    free_card()
    log(f"cells: launches {counted}; seconds by part {secs}; phase 4c "
        f"{time.perf_counter() - t_phase} s; card: {smi_line()}")
    return counted


def recsys_extra_times(recsys, flush, x0b, xl1, c1, bags_p99):
    """Beside the kernel line: cross on the serve_bulk layer-2 inputs
    (the wrapper's tensor route, its W split included) in turns with its
    SIMT route and with its yardstick, cuBLAS ``addmm`` (the GEMM and bias
    alone, which the port never calls); the same three at serve_p99's 512
    rows (layer 2), where the wrapper takes the SIMT route; embedding_bag,
    its plain version and yardstick at 512 bags.  Returns the extra keys
    of the cross and embedding_bag lines."""
    import torch
    from repro_torch.kernels.cross import ops as cops
    from repro_torch.kernels.cross import ref as cref
    from repro_torch.kernels.embag import ops as eops
    from repro_torch.kernels.embag import ref as eref
    model = recsys["model"]
    x0p, c0 = recsys["x0_p99"], model.cross[0]
    xl1p = cops.cross_layer(x0p, x0p, c0.W, c0.b)
    table = model.tables[0]
    idx, wt = bags_p99
    cross = turn_ms({
        "ms_turns": lambda: cops.cross_layer(x0b, xl1, c1.W, c1.b),
        "simt_ms": lambda: cross_route(x0b, xl1, c1.W, c1.b, cops.SIMT),
        "gemm_ms": lambda: torch.addmm(c1.b, xl1, c1.W.T)}, flush,
        reps=2 * REPS)
    cross.update(turn_ms({
        "ms_p99": lambda: cops.cross_layer(x0p, xl1p, c1.W, c1.b),
        "tensor_ms_p99": lambda: cross_route(x0p, xl1p, c1.W, c1.b,
                                             cops.TENSOR),
        "gemm_ms_p99": lambda: torch.addmm(c1.b, xl1p, c1.W.T)}, flush))
    B, d = x0p.shape
    cross.update(
        plain_ms_p99=cuda_ms(
            lambda: cref.cross_layer_ref(x0p, xl1p, c1.W, c1.b), flush),
        bound_ms_p99=bound_ms(4 * (3 * B * d + d * d + d),
                              2 * B * d * d + 3 * B * d)[0],
        reps_turns=2 * REPS, reps_p99=TURN_REPS)
    # embedding_bag against F.embedding_bag at 512 bags, whose order two
    # runs of 25 disagreed on: TURN_REPS launches each, in turns
    embag = turn_ms({
        "ms_p99": lambda: eops.embedding_bag(table, idx, wt),
        "library_ms_p99": lambda: torch.nn.functional.embedding_bag(
            idx, table, per_sample_weights=wt, mode="sum")}, flush)
    embag["plain_ms_p99"] = cuda_ms(
        lambda: eref.embedding_bag_ref(table, idx, wt), flush)
    embag["reps_p99"] = TURN_REPS
    nonpad = int((wt != 0).sum())
    embag["bound_ms_p99"] = bound_ms(
        8 * idx.numel() + 4 * table.shape[1] * (nonpad + idx.shape[0]),
        2 * table.shape[1] * nonpad)[0]
    log(f"time cross in turns with its SIMT route and addmm, at 262144 "
        f"and 512 rows: {cross}")
    log(f"time embedding_bag at 512 bags, median of {TURN_REPS} launches "
        f"each, in turns: kernel {embag['ms_p99']} ms, F.embedding_bag "
        f"{embag['library_ms_p99']} ms; {embag}")
    return cross, embag


def popcount(words):
    """Set bits in an int32 tensor of packed words."""
    from repro_torch.kernels.graph import ops as gops
    return int(gops.warp_tile_bits(words).sum())


def filter_bound_ms(Minv, N: float, d: int, n_bytes: float,
                    rescored: int) -> dict:
    """The filter kernels' own bound (ms) on one H100, ``bound_ms`` of
    their rows: the larger of the bytes at the memory rate and the
    operations, which are the product at the bf16 tensor-core rate (d (d
    + 1) multiply-adds, 2 flops each, of every user's Minv and w pieces,
    one piece or two by the user's Minv, against each of the ``N`` rows
    scored: the live rows, the visited share of them where pruned) plus
    the rescored pairs' chains (2 d^2 + 4 d + 6 f32 operations each) at
    the f32 rate; and its parts."""
    M = Minv.float()
    lo = (M - M.bfloat16().float()).bfloat16() != 0
    pieces = M.shape[0] + int(lo.flatten(1).any(1).sum())  # over the users
    prod = 2 * N * d * (d + 1) * pieces
    parts = {"product_ms": 1e3 * prod / BF16_FLOPS_PER_S,
             "rescore_ms": 1e3 * rescored * (2 * d * d + 4 * d + 6)
             / F32_FLOPS_PER_S,
             "bytes_ms": 1e3 * n_bytes / HBM_BYTES_PER_S}
    ops_ms = parts["product_ms"] + parts["rescore_ms"]
    return {"filter_bound_ms": max(ops_ms, parts["bytes_ms"]),
            "filter_bound_by": ("bytes" if parts["bytes_ms"] >= ops_ms
                                else "operations"), **parts}


def bound_ms(n_bytes: float, flops: float,
             rate: float = F32_FLOPS_PER_S) -> tuple[float, str]:
    t_mem = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / rate
    return 1e3 * max(t_mem, t_ops), ("bytes" if t_mem >= t_ops
                                     else "operations")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2

    # ---- phase 1: device ---------------------------------------------------
    log(smi_line())
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")
    # f32 products in full f32: TF32 would move choices and edge bits
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from repro_torch.configs import distclub_paper as paper
    from repro_torch.core import clustering, distclub, env, env_ops, linucb
    from repro_torch.kernels import _build
    from repro_torch.kernels.cross import ops as cops
    from repro_torch.kernels.cross import ref as cref
    from repro_torch.kernels.embag import ops as eops
    from repro_torch.kernels.embag import ref as eref
    from repro_torch.kernels.graph import ops as gops
    from repro_torch.kernels.graph import ref as gref
    from repro_torch.kernels.interact import ops as iops
    from repro_torch.kernels.interact import ref as iref
    from repro_torch.kernels.rank1 import ops as rops
    from repro_torch.kernels.rank1 import ref as rref
    from repro_torch.kernels.topk import ops as tops
    from repro_torch.kernels.topk import ref as tref
    from repro_torch.kernels.ucb import ops as uops
    from repro_torch.kernels.ucb import ref as uref

    # ---- phase 2: build ----------------------------------------------------
    t0 = time.perf_counter()
    reports = _build.build_all()
    log(f"build: {len(reports)} kernels in {time.perf_counter() - t0:.2f} s")
    for kname, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {kname}: {line.strip()}")
    spill_check()
    sass_check()

    # ---- phase 3: small shapes -----------------------------------------------
    small_checks(dev)
    torch.cuda.synchronize()

    # ---- phase 4: the main path at full width --------------------------------
    n, d, hyper = paper.N_USERS, paper.D_FEAT, paper.CONFIG
    K, R = hyper.n_candidates, hyper.max_rounds
    e, _ = env.make_synthetic_env(SEED, n, d, paper.N_CLUSTERS, K,
                                  paper.WITHIN_CLUSTER_NOISE, device=dev)
    ops = env_ops.synthetic_ops(e)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    graphs = {"offline": [], "club": [], "serve": []}
    t0 = time.perf_counter()
    with cc_graphs("main path", graphs["offline"]):
        state, metrics, n_clusters = distclub.run(ops, SEED, hyper, EPOCHS,
                                                  d, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    reward = float(metrics.reward.sum())
    rand = float(metrics.rand_reward.sum())
    inter = int(metrics.interactions.sum())
    log(f"main path: n={n} d={d} K={K} epochs={EPOCHS} "
        f"interactions={inter} reward={reward} random={rand} "
        f"reward/random={reward / rand}")
    log(f"clusters per epoch={n_clusters.tolist()} "
        f"comm_bytes={float(state.comm_bytes)} "
        f"seconds/epoch={wall / EPOCHS} (incl. first-epoch warm-up) "
        f"max_memory_allocated={peak}")
    log(f"launches: {launches}")
    assert metrics.reward.shape == (EPOCHS * 2 * R,)
    for t in (state.lin.M, state.lin.Minv, state.lin.b, metrics.reward):
        assert bool(torch.isfinite(t).all()), "non-finite output"
    assert state.graph.adj.shape == (n, gref.packed_words(n))
    assert 1 <= int(n_clusters.min()) and int(n_clusters.max()) <= n
    assert reward / rand > 1.0, "the bandit does no better than random"
    assert launches["choose"] == 2 * R * EPOCHS, launches
    assert launches["rank1_update_inv"] == 2 * R * EPOCHS, launches
    assert launches["prune"] == EPOCHS, launches
    assert EPOCHS <= launches["cc_hop"] <= EPOCHS * n, launches

    # one more epoch from the run's state, warm: the steady epoch time
    t0 = time.perf_counter()
    distclub.epoch(state, ops, SEED, EPOCHS, hyper, d)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    log(f"steady epoch (epoch {EPOCHS + 1}): {steady_s} s")
    profile_epoch(distclub, state, ops, hyper, d, steady_s)

    # ---- phase 4, plain: the same run through the plain versions -------------
    _build.reset_launches()
    t0 = time.perf_counter()
    with plain_path():
        _, p_metrics, p_clusters = distclub.run(ops, SEED, hyper, EPOCHS, d,
                                                device=dev)
    torch.cuda.synchronize()
    log(f"plain path: seconds/epoch={(time.perf_counter() - t0) / EPOCHS} "
        f"interactions={int(p_metrics.interactions.sum())}")
    assert not any(_build.LAUNCHES.values()), dict(_build.LAUNCHES)
    compare_paths(
        (reward / rand, n_clusters.tolist()),
        (float(p_metrics.reward.sum()) / float(p_metrics.rand_reward.sum()),
         p_clusters.tolist()), n)

    # ---- phase 4b: the paper's baselines at full width ----------------------
    algo_line("distclub", wall, inter, reward / rand,
              float(state.comm_bytes), n_clusters.tolist(), peak)
    baselines = baselines_phase(dev, ops, hyper, d, inter, graphs["club"])

    # ---- phase 4d: the paper's dataset clones under every env kind ----------
    on_clones = clones_phase(dev)

    # ---- phase 4s: serving at full width, and its plain run -----------------
    dccb_core = baselines.pop("dccb")
    serving, sess, item_clusters, serve_launches, _ = serve_phase(
        dev, state, e.theta, hyper, dccb_core, graphs["serve"])

    # ---- phase 4x: the sharded runtime, one NCCL rank and four gloo ranks ---
    shard_launches = shard_phase(torch.device("cuda", 0), dict(
        state=state, ops=ops, metrics=metrics, n_clusters=n_clusters,
        reward=reward, rand=rand, launches=launches, wall=wall,
        steady=steady_s), serving)

    # ---- phase 4p: reduced-precision serving and checkpointing -------------
    precision = precision_phase(dev, serving, state, hyper, e.theta)
    minv = minv_phase(dev, state, ops, hyper, serving, precision,
                      item_clusters, EPOCHS * 2 * R + 1)

    # ---- phase 4o: the operations layer -------------------------------------
    ops_launches = ops_phase(dev, serving, state, hyper, dccb_core,
                             item_clusters)["launches"]

    # ---- phase 4r: the recsys models at their published configs -------------
    recsys = recsys_phase(dev)

    # ---- phase 4l: LM serving at full width and depth -----------------------
    lm = lm_phase(dev)

    # ---- phase 4t: training ---------------------------------------------------
    train_launches = train_phase(dev)

    # ---- phase 4m: the MoE LMs ------------------------------------------------
    moe = moe_phase(dev)

    # ---- phase 4k: the sharded LM decode ----------------------------------------
    shard_decode_phase(dev)

    # ---- phase 4g: the GAT ------------------------------------------------------
    gnn_phase(dev)

    # ---- phase 4c: the global-program cells on one NCCL rank ------------------
    cells_launches = cells_phase(dev, e.theta)

    # ---- phase 5: kernels against plain versions at full width --------------
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    sms = _build.sm_count(0)
    Minv, b, occ = state.lin.Minv, state.lin.b, state.lin.occ
    w = linucb.user_vector(Minv, b)
    ctx = ops.contexts_fn(SEED, EPOCHS * 2 * R, occ)
    errs = {"choose": check_choose(w, Minv, ctx, occ, hyper.alpha)}
    log(f"full choose, both variants and both ucb variants (n={n}, "
        f"geometry {iops.geometry(n, K, d, sms)}): "
        f"{check_pick(w, Minv, ctx, occ, hyper.alpha)}")
    _, x = iops.choose(w, Minv, ctx, occ, hyper.alpha)
    r = (torch.rand(n, generator=g, device=dev) < 0.5).float()
    mask = 0 < state.u_rounds
    errs["rank1_update_inv"] = check_rank1(Minv, b, x, r, mask)
    # the baselines' two kernels at full width on the same inputs (the
    # M-ful update with the run's M = inv(Minv)), then at CLUB's n = 1:
    # the next CLUB interaction's user, its cluster's row and its own rows
    M = state.lin.M
    errs["ucb"] = check_ucb(w, Minv, ctx, occ, hyper.alpha)
    errs["rank1_update"] = check_rank1_mful(M, Minv, b, x, r, mask)
    cs = baselines["club"]
    u = ops.user_fn(SEED, CLUB_T)
    lab = int(cs.graph.labels[u])
    occ1 = cs.lin.occ[u:u + 1]
    ctx1 = ops.contexts_fn(SEED, CLUB_T, occ1, row0=u)
    Mc1, bc1 = cs.clusters.Mcinv[lab:lab + 1], cs.clusters.bc[lab:lab + 1]
    w1 = linucb.user_vector(Mc1, bc1)
    x1, r1 = ctx1[0, :1].contiguous(), torch.ones(1, device=dev)
    live1 = torch.ones(1, dtype=torch.bool, device=dev)
    log(f"full ucb at n=1 (CLUB's call, K={K}): "
        f"{check_ucb(w1, Mc1, ctx1, occ1, hyper.alpha)}")
    same = torch.equal(uops.ucb_scores(w1, Mc1, ctx1, occ1, hyper.alpha),
                       ucb_variant(w1, Mc1, ctx1, occ1, hyper.alpha,
                                   uops.WARP_PER_USER))
    log(f"full ucb at n=1, variant {uops.variant(1, K, d, sms)} against "
        f"the warp-per-user variant on cluster {lab}'s row (offset mod 16: "
        f"{Mc1.data_ptr() % 16}): bit-equal {same}")
    assert same, "ucb: the variants differ on CLUB's row"
    log(f"full rank1_update at n=1 (CLUB's user row views): "
        f"{check_rank1_row_view(cs.lin.M, cs.lin.Minv, cs.lin.b, x1, r1, u)}")
    log(f"full rank1 variants at n=1 against n={n} (CLUB's state): "
        f"{check_rank1_variants(cs.lin.M, cs.lin.Minv, cs.lin.b, x1, r1, u)}")
    cb = clustering.cb_width(occ)
    full = gref.init_packed_adj(n, n, device=dev)
    errs["prune"] = check_prune(full, w, cb, w, cb, hyper.gamma)
    log(f"full prune on the epoch's pruned graph: "
        f"{check_prune(state.graph.adj, w, cb, w, cb, hyper.gamma)}")
    # the kernel's sparse and dense branches agree: its words on the
    # learned graph are its words on the full graph ANDed with it
    learned = state.graph.adj
    same = torch.equal(
        gops.prune_packed(learned, w, cb, w, cb, hyper.gamma),
        gops.prune_packed(full, w, cb, w, cb, hyper.gamma) & learned)
    log(f"full prune on the learned graph equals prune on the full graph "
        f"AND the learned graph: {same}")
    assert same, "prune: the sparse and the dense branch disagree"
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    errs["cc_hop"] = check_cc_hop(state.graph.adj, ids, ids)
    log(f"full cc_hop on the labels: "
        f"{check_cc_hop(state.graph.adj, state.graph.labels, state.graph.labels)}")
    log(f"full cc_hop on the full graph: {check_cc_hop(full, ids, ids)}")
    # one serving batch's users with the statistics the catalog path
    # scores with, after the unpruned run
    idx = serving.users[0].long()
    w_s, M_s, occ_s = sess.policy.gather_score(sess.state, idx)
    bank = serving.catalog.serving
    errs["topk"] = check_topk(w_s, M_s, occ_s, bank.emb, bank.live,
                              hyper.alpha, K_SHORT)
    # the shortlist's scores are the bits of the ucb kernel's chain
    # (csrc/ucb_score.cuh) on the same users and items
    s_k, i_k = tops.topk(w_s, M_s, occ_s, bank.emb, bank.live, hyper.alpha,
                         K_SHORT)
    held = i_k >= 0
    s_u = uops.ucb_scores(w_s, M_s, bank.emb[i_k.clamp_min(0).long()],
                          occ_s, hyper.alpha)
    log(f"full topk scores against ucb_scores (variant "
        f"{uops.variant(*s_k.shape, d, sms)}) of the shortlisted items: "
        f"{int(held.sum())} entries, bit-equal "
        f"{torch.equal(s_k[held], s_u[held])}")
    assert torch.equal(s_k[held], s_u[held]), (
        "topk: shortlist scores differ from ucb_scores")
    # serving's choose on the shortlisted items, both variants of choose
    # and of ucb
    ctx_s = bank.emb[i_k.clamp_min(0).long()].contiguous()
    log(f"full choose at serving's shape {tuple(ctx_s.shape)} (geometry "
        f"{iops.geometry(*ctx_s.shape, sms)}): "
        f"{check_choose(w_s, M_s, ctx_s, occ_s, hyper.alpha)}, both "
        f"variants and both ucb variants: "
        f"{check_pick(w_s, M_s, ctx_s, occ_s, hyper.alpha)}")
    errs["topk_pruned"] = check_topk_pruned(w_s, M_s, occ_s, serving.catalog,
                                            item_clusters, hyper.alpha,
                                            K_SHORT)
    # the reduced-precision variants at full width: the bf16 update on
    # phase 4's state cast down (the same x, r and mask), both its variants
    # on its first 2 x SMs + 1 users; the top-K variants over phase 4p's
    # quantized catalogs for the same batch's users with the bf16
    # session's statistics
    Minv_bf = Minv.bfloat16()
    errs["rank1_update_inv_bf16"] = check_rank1_bf16(Minv_bf, b, x, r, mask)
    nv = 2 * sms + 1
    log(f"full rank1_update_inv bf16, both variants on {nv} users: "
        f"{check_rank1_bf16_variants(Minv_bf[:nv], b[:nv], x[:nv], r[:nv], mask[:nv])}")
    sess_q = precision["sessions"]["bf16"]
    w_q, M_q, occ_q = sess_q.policy.gather_score(sess_q.state, idx)
    quant = {}
    for prec in PRECISIONS:
        cat_q = precision["cats"][prec]
        bank_q = cat_q.serving
        quant[prec] = (bank_q, bank_q.scale if prec == "int8" else None,
                       precision["clusters"][prec])
        errs[f"topk_{prec}_tc"] = check_topk_quant(
            w_q, M_q, occ_q, bank_q.emb, bank_q.live, quant[prec][1],
            hyper.alpha, K_SHORT)
        errs[f"topk_pruned_{prec}_tc"] = check_topk_pruned(
            w_q, M_q, occ_q, cat_q, quant[prec][2], hyper.alpha, K_SHORT)
        # the filter kernels against the chain kernels on serving's batch
        cl_q = quant[prec][2]
        res = check_topk_filter(w_q, M_q, occ_q, bank_q.emb, bank_q.live,
                                quant[prec][1], hyper.alpha, K_SHORT)
        tb_q = tref.tile_bounds(w_q, M_q, occ_q, hyper.alpha, cl_q.tile_mu,
                                cl_q.tile_r, cl_q.tile_xn, cl_q.tile_n)
        resp = check_topk_pruned_filter(
            w_q, M_q, occ_q, cl_q.emb_sorted, cl_q.live_sorted, cl_q.perm,
            cl_q.scale_sorted if prec == "int8" else None, tb_q,
            hyper.alpha, K_SHORT,
            tops.topk(w_q, M_q, occ_q, bank_q.emb, bank_q.live, hyper.alpha,
                      K_SHORT, scales=quant[prec][1]))
        log(f"full topk filter {prec} against the chain kernels on "
            f"serving's batch: {res}; pruned: {resp}")
        for key, got in ((f"topk_{prec}_tc", res),
                         (f"topk_pruned_{prec}_tc", resp)):
            errs[key].update(rescored=got["rescored"],
                             rescored_share=got["rescored_share"],
                             violations=got["violations"])
    # DCN-v2's layers 1 and 2 on a serve_bulk batch; EmbeddingBag on the
    # bags of phase 4r
    x0b = recsys["x0_bulk"]
    c0, c1 = recsys["model"].cross[0], recsys["model"].cross[1]
    errs["cross"] = check_cross(x0b, x0b, c0.W, c0.b)
    xl1 = cops.cross_layer(x0b, x0b, c0.W, c0.b)
    log(f"full cross, layer 2: {check_cross(x0b, xl1, c1.W, c1.b)}")
    errs["cross_split"] = check_cross_split(c1.W)
    log(f"full cross_split, layers 1 and 2: {check_cross_split(c0.W)}, "
        f"{errs['cross_split']}")
    table = recsys["model"].tables[0]
    bags_p99, bags_bulk = (recsys["bags"][nb] for nb in sorted(recsys["bags"]))
    log(f"full embedding_bag, {bags_p99[0].shape[0]} bags: "
        f"{check_embag(table, *bags_p99)}")
    errs["embedding_bag"] = check_embag(table, *bags_bulk)
    # flash on the q/k/v of the LM path: prefill layers 0 and 35 (the f32
    # reference scans 512 keys at a time to bound its memory), a decode
    # step's layer 0
    chunk = lm["cfg"].attn_chunk
    flash_errs = []
    for label, (q, k, v, kw) in (("prefill layer 0", lm["prefill"][0]),
                                 ("prefill layer 35", lm["prefill"][1]),
                                 ("decode step layer 0", lm["decode"])):
        kw = {key: kw[key] for key in ("causal", "q_offset", "kv_len")}
        res = check_flash(q, k, v, chunk=chunk, ref_chunk=512, **kw)
        log(f"full flash, {label} {tuple(q.shape)} x {tuple(k.shape)} "
            f"{kw}: {res}")
        flash_errs.append(res["max_abs_err"])
    flash_errs.append(moe_flash_checks(moe))
    errs["flash"] = {"max_abs_err": max(flash_errs)}
    # the bf16-Minv variants, held in phase 4p's counted runs (the engine
    # rounds at full width, the serving batch over the three banks)
    errs.update(minv["errs"])
    for kname, res in errs.items():
        log(f"full {kname}: {res}")

    # ---- phase 6: times ------------------------------------------------------
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    # both updates work in place: each gets its own copy to overwrite
    Minv_w, b_w = Minv.clone(), b.clone()
    Minv_p, b_p = Minv.clone(), b.clone()
    adj = state.graph.adj
    W = adj.shape[1]
    live = int(mask.sum())
    work = {
        "choose": (
            lambda: iops.choose(w, Minv, ctx, occ, hyper.alpha),
            lambda: iref.choose_ref(w, Minv, ctx, occ, hyper.alpha),
            4 * (n * K * d + n * d * d + n * d + n + n + n * d),
            n * K * (4 * d + 2 * d * d + 6)),
        "rank1_update_inv": (
            lambda: rops.rank1_update_inv(Minv_w, b_w, x, r, mask),
            lambda: rref.rank1_update_inv_ref(Minv_p, b_p, x, r, mask),
            live * 4 * (2 * d * d + 3 * d + 1) + n,
            live * (5 * d * d + 4 * d + 2)),
        "prune": (
            lambda: gops.prune_packed(full, w, cb, w, cb, hyper.gamma),
            lambda: gref.prune_packed_ref(full, w, cb, w, cb, hyper.gamma),
            2 * 4 * n * W + 2 * 4 * n * (d + 1),
            popcount(full) * (2 * d + 8)),
        "cc_hop": (
            lambda: gops.cc_hop_packed(adj, ids, ids),
            lambda: gref.cc_hop_packed_ref(adj, ids, ids),
            4 * (n * W + 3 * n),
            0),
    }
    # the top-K pair: every (user, live item) pair scored, 4d + 2d^2 + 6
    # f32 operations each (the count used for choose); the pruned kernel's
    # bound is scaled by the tiles it need not score
    B, N_live = w_s.shape[0], bank.live.shape[0]
    tk_bytes = 4 * (B * d + B * d * d + B + N_live * d + N_live) \
        + 8 * B * K_SHORT
    tk_ops = B * N_live * (4 * d + 2 * d * d + 6)
    tb = tref.tile_bounds(w_s, M_s, occ_s, hyper.alpha, item_clusters.tile_mu,
                          item_clusters.tile_r, item_clusters.tile_xn,
                          item_clusters.tile_n)
    pruned_args = (w_s, M_s, occ_s, item_clusters.emb_sorted,
                   item_clusters.live_sorted, item_clusters.perm,
                   hyper.alpha, K_SHORT, tb)
    keep = 1.0 - max(errs["topk_pruned"]["skip"],
                     errs["topk_pruned"]["plain_skip"])
    work.update({
        "topk": (
            lambda: tops.topk(w_s, M_s, occ_s, bank.emb, bank.live,
                              hyper.alpha, K_SHORT),
            lambda: tref.topk_ref(w_s, M_s, occ_s, bank.emb, bank.live,
                                  hyper.alpha, K_SHORT),
            tk_bytes, tk_ops),
        "topk_pruned": (
            lambda: tops.topk_pruned(*pruned_args),
            lambda: tref.topk_ref_pruned(*pruned_args),
            keep * (tk_bytes + 4 * (N_live + B * tb.shape[1])),
            keep * tk_ops),
    })
    # the reduced-precision variants: the bf16 update on its own copies of
    # phase 5's bf16 state (Minv's bytes halved), the top-K variants over
    # the quantized banks (the items' bytes halved, or a quarter plus the
    # int8 scales; int8 adds a dequantizing multiply a feature)
    Minv_bw, b_bw = Minv_bf.clone(), b.clone()
    Minv_bp, b_bp = Minv_bf.clone(), b.clone()
    chain, filter_bounds = {}, {}
    work["rank1_update_inv_bf16"] = (
        lambda: rops.rank1_update_inv(Minv_bw, b_bw, x, r, mask),
        lambda: rref.rank1_update_inv_ref(Minv_bp, b_bp, x, r, mask),
        live * (2 * 2 * d * d + 4 * (3 * d + 1)) + n,
        live * (5 * d * d + 4 * d + 2))
    for prec, (bank_q, sc_q, cl_q) in quant.items():
        isz = bank_q.emb.element_size()
        q_bytes = (4 * (B * d + B * d * d + B + N_live) + isz * N_live * d
                   + (4 * N_live if sc_q is not None else 0)
                   + 8 * B * K_SHORT)
        q_ops = tk_ops + (N_live * d if sc_q is not None else 0)
        tb_q = tref.tile_bounds(w_q, M_q, occ_q, hyper.alpha, cl_q.tile_mu,
                                cl_q.tile_r, cl_q.tile_xn, cl_q.tile_n)
        pargs_q = (w_q, M_q, occ_q, cl_q.emb_sorted, cl_q.live_sorted,
                   cl_q.perm, hyper.alpha, K_SHORT, tb_q)
        ss_q = cl_q.scale_sorted if sc_q is not None else None
        keep_q = 1.0 - max(errs[f"topk_pruned_{prec}_tc"]["skip"],
                           errs[f"topk_pruned_{prec}_tc"]["plain_skip"])
        work[f"topk_{prec}_tc"] = (
            lambda bq=bank_q, sq=sc_q: tops.topk(
                w_q, M_q, occ_q, bq.emb, bq.live, hyper.alpha, K_SHORT,
                scales=sq),
            lambda bq=bank_q, sq=sc_q: tref.topk_ref(
                w_q, M_q, occ_q, bq.emb, bq.live, hyper.alpha, K_SHORT,
                scales=sq),
            q_bytes, q_ops)
        work[f"topk_pruned_{prec}_tc"] = (
            lambda a=pargs_q, sq=ss_q: tops.topk_pruned(*a, scales=sq),
            lambda a=pargs_q, sq=ss_q: tref.topk_ref_pruned(*a, scales=sq),
            keep_q * (q_bytes + 4 * (N_live + B * tb_q.shape[1])),
            keep_q * q_ops)
        # the chain kernels these replace at d <= 32, the yardstick timed
        # in turns beside them
        chain[f"topk_{prec}_tc"] = (
            lambda bq=bank_q, sq=sc_q: tops.topk(
                w_q, M_q, occ_q, bq.emb, bq.live, hyper.alpha, K_SHORT,
                scales=sq, chain=True))
        chain[f"topk_pruned_{prec}_tc"] = (
            lambda a=pargs_q, sq=ss_q: tops.topk_pruned(
                *a, scales=sq, chain=True))
        for v, rows in ((f"topk_{prec}_tc", N_live),
                        (f"topk_pruned_{prec}_tc", keep_q * N_live)):
            filter_bounds[v] = filter_bound_ms(M_q, rows, d, work[v][2],
                                               errs[v]["rescored"])
    # the bf16-Minv variants: choose, ucb and the M-ful update on phase 5's
    # inputs with Minv cast to bf16 (2 d^2 bytes a user; the update on its
    # own copies), the top-K six on phase 4p's bf16-Minv serving batch over
    # each bank (the f32 bank's items at 4 bytes), pruned over each bank's
    # own sorted layout; each beside its f32 kernel on the widened Minv
    Mb_k = (M.clone(), Minv_bf.clone(), b.clone())
    Mb_p = (M.clone(), Minv_bf.clone(), b.clone())
    Mb_f = (M.clone(), Minv_bf.float(), b.clone())
    Minv_wide = Minv_bf.float()
    work.update({
        "choose_bf16": (
            lambda: iops.choose(w, Minv_bf, ctx, occ, hyper.alpha),
            lambda: iref.choose_ref(w, Minv_bf, ctx, occ, hyper.alpha),
            4 * (n * K * d + 2 * n * d + 2 * n) + 2 * n * d * d,
            n * K * (4 * d + 2 * d * d + 6)),
        "ucb_bf16": (
            lambda: uops.ucb_scores(w, Minv_bf, ctx, occ, hyper.alpha),
            lambda: uref.ucb_scores_ref(w, Minv_bf, ctx, occ, hyper.alpha),
            4 * n * (K * d + d + 1 + K) + 2 * n * d * d,
            n * K * (4 * d + 2 * d * d + 6)),
        "rank1_update_bf16": (
            lambda: rops.rank1_update(*Mb_k, x, r, mask),
            lambda: rref.rank1_update_ref(*Mb_p, x, r, mask),
            live * (12 * d * d + 4 * (3 * d + 1)) + n,
            live * (7 * d * d + 4 * d + 2)),
    })
    minv_f32 = {
        "choose_bf16": lambda: iops.choose(w, Minv_wide, ctx, occ,
                                           hyper.alpha),
        "ucb_bf16": lambda: uops.ucb_scores(w, Minv_wide, ctx, occ,
                                            hyper.alpha),
        "rank1_update_bf16": lambda: rops.rank1_update(*Mb_f, x, r, mask)}
    w_b, Mb_b, occ_b = minv["batch"]["users"]
    Mb_wide = Mb_b.float()
    for kind, (cat_b, cl_b) in minv["banks"].items():
        bank_b = cat_b.serving
        sc_b = bank_b.scale if kind == "int8" else None
        ss_b = cl_b.scale_sorted if kind == "int8" else None
        sfx = BANK_SFX[kind]
        Nb = bank_b.live.shape[0]
        b_bytes = (4 * (B * d + B + Nb) + 2 * B * d * d
                   + bank_b.emb.element_size() * Nb * d
                   + (4 * Nb if sc_b is not None else 0) + 8 * B * K_SHORT)
        b_ops = tk_ops + (Nb * d if sc_b is not None else 0)
        tb_b = tref.tile_bounds(w_b, Mb_b, occ_b, hyper.alpha, cl_b.tile_mu,
                                cl_b.tile_r, cl_b.tile_xn, cl_b.tile_n)
        pa_b = (cl_b.emb_sorted, cl_b.live_sorted, cl_b.perm, hyper.alpha,
                K_SHORT, tb_b)
        e_p = errs[f"topk_pruned_minv_bf16{sfx}"]
        keep_b = 1.0 - max(e_p["skip"], e_p["plain_skip"])
        topk_args = (bank_b.emb, bank_b.live, hyper.alpha, K_SHORT)
        work[f"topk_minv_bf16{sfx}"] = (
            lambda a=topk_args, sq=sc_b: tops.topk(w_b, Mb_b, occ_b, *a,
                                                   scales=sq),
            lambda a=topk_args, sq=sc_b: tref.topk_ref(w_b, Mb_b, occ_b, *a,
                                                       scales=sq),
            b_bytes, b_ops)
        work[f"topk_pruned_minv_bf16{sfx}"] = (
            lambda a=pa_b, sq=ss_b: tops.topk_pruned(w_b, Mb_b, occ_b, *a,
                                                     scales=sq),
            lambda a=pa_b, sq=ss_b: tref.topk_ref_pruned(w_b, Mb_b, occ_b,
                                                         *a, scales=sq),
            keep_b * (b_bytes + 4 * (Nb + B * tb_b.shape[1])),
            keep_b * b_ops)
        minv_f32[f"topk_minv_bf16{sfx}"] = (
            lambda a=topk_args, sq=sc_b: tops.topk(w_b, Mb_wide, occ_b, *a,
                                                   scales=sq))
        minv_f32[f"topk_pruned_minv_bf16{sfx}"] = (
            lambda a=pa_b, sq=ss_b: tops.topk_pruned(w_b, Mb_wide, occ_b,
                                                     *a, scales=sq))
        if kind != "f32":
            chain[f"topk_minv_bf16{sfx}"] = (
                lambda a=topk_args, sq=sc_b: tops.topk(
                    w_b, Mb_b, occ_b, *a, scales=sq, chain=True))
            chain[f"topk_pruned_minv_bf16{sfx}"] = (
                lambda a=pa_b, sq=ss_b: tops.topk_pruned(
                    w_b, Mb_b, occ_b, *a, scales=sq, chain=True))
            for v, rows in ((f"topk_minv_bf16{sfx}", Nb),
                            (f"topk_pruned_minv_bf16{sfx}", keep_b * Nb)):
                filter_bounds[v] = filter_bound_ms(Mb_b, rows, d, work[v][2],
                                                   errs[v]["rescored"])
    # cross: layer 2 of a serve_bulk batch (x0 and xl distinct inputs);
    # embedding_bag: the 262144 bags, pads' rows not counted (not read)
    Bb, dI = x0b.shape
    idx_b, wt_b = bags_bulk
    nonpad = int((wt_b != 0).sum())
    dE = table.shape[1]
    split_buf = torch.empty(cops.split_words(dI), dtype=torch.int32,
                            device=dev)
    work.update({
        # the tensor route's work: three TF32 products of 2 B d^2 flops
        # (the f32 bound at 67 TFLOP/s goes beside it)
        "cross": (
            lambda: cops.cross_layer(x0b, xl1, c1.W, c1.b),
            lambda: cref.cross_layer_ref(x0b, xl1, c1.W, c1.b),
            4 * (3 * Bb * dI + dI * dI + dI),
            3 * 2 * Bb * dI * dI),
        "cross_split": (
            lambda: _build.launch("cross_split", c1.W.data_ptr(), dI,
                                  split_buf.data_ptr()),
            lambda: cref.cross_split_ref(c1.W),
            4 * (dI * dI + cops.split_words(dI)),
            0),
        "embedding_bag": (
            lambda: eops.embedding_bag(table, idx_b, wt_b),
            lambda: eref.embedding_bag_ref(table, idx_b, wt_b),
            8 * idx_b.numel() + 4 * dE * (nonpad + idx_b.shape[0]),
            2 * dE * nonpad),
    })
    # ucb and the M-ful update at n=20480 on phase 5's inputs, each update
    # on its own copies; and at CLUB's n = 1 (one user's row views)
    ucb_bytes = lambda m: 4 * m * (K * d + d * d + d + 1 + K)  # noqa: E731
    ucb_ops_ = lambda m: m * K * (4 * d + 2 * d * d + 6)  # noqa: E731
    r1u_bytes = lambda m, k: 4 * m * (4 * d * d + 3 * d + 1) + k  # noqa: E731
    r1u_ops = lambda m: m * (7 * d * d + 4 * d + 2)  # noqa: E731
    mful_k = (M.clone(), Minv.clone(), b.clone())
    mful_p = (M.clone(), Minv.clone(), b.clone())
    row_k = tuple(t.clone() for t in (cs.lin.M, cs.lin.Minv, cs.lin.b))
    row_p = tuple(t.clone() for t in (cs.lin.M, cs.lin.Minv, cs.lin.b))
    # the warp-per-user variant (the design the block variant replaced)
    # launched at n = 1 on the same row, past the wrapper's choice, timed
    # in the same turns
    row_w = tuple(t.clone() for t in (cs.lin.M, cs.lin.Minv, cs.lin.b))
    warp_n1 = [t[u:u + 1].data_ptr() for t in row_w] + [
        x1.data_ptr(), r1.data_ptr(), live1.data_ptr(), 1, d,
        rops.WARP_PER_USER]
    n1_yardsticks = {
        "rank1_update": {
            "warp_ms_n1": lambda: _build.launch("rank1_update", *warp_n1)},
        "ucb": {"warp_ms_n1": lambda: ucb_variant(
            w1, Mc1, ctx1, occ1, hyper.alpha, uops.WARP_PER_USER)}}
    work.update({
        "rank1_update": (
            lambda: rops.rank1_update(*mful_k, x, r, mask),
            lambda: rref.rank1_update_ref(*mful_p, x, r, mask),
            r1u_bytes(live, n), r1u_ops(live)),
        "ucb": (
            lambda: uops.ucb_scores(w, Minv, ctx, occ, hyper.alpha),
            lambda: uref.ucb_scores_ref(w, Minv, ctx, occ, hyper.alpha),
            ucb_bytes(n), ucb_ops_(n)),
    })
    at_n1 = {
        "rank1_update": (
            lambda: rops.rank1_update(*(t[u:u + 1] for t in row_k), x1, r1,
                                      live1),
            lambda: rref.rank1_update_ref(*(t[u:u + 1] for t in row_p), x1,
                                          r1, live1),
            r1u_bytes(1, 1), r1u_ops(1)),
        "ucb": (
            lambda: uops.ucb_scores(w1, Mc1, ctx1, occ1, hyper.alpha),
            lambda: uref.ucb_scores_ref(w1, Mc1, ctx1, occ1, hyper.alpha),
            ucb_bytes(1), ucb_ops_(1)),
    }
    # one PyTorch call of the same function, timed here and used nowhere
    # in the port: F.embedding_bag (ids in range: it does not clamp)
    library = {"embedding_bag": lambda: torch.nn.functional.embedding_bag(
        idx_b, table, per_sample_weights=wt_b, mode="sum")}
    on_path = {k: launches[k] for k in ("choose", "rank1_update_inv",
                                        "prune", "cc_hop")}
    # flash at the LM path's two shapes, prefill layer 0 (B 8, Hq 32, Hkv
    # 8, S 2048, Dh 128, causal) and a decode step (Sq 1 against the first
    # 2113 slots of a 4096-slot cache), beside scaled_dot_product_attention
    flash_pre = flash_times(*lm["prefill"][0], chunk, flush)
    flash_dec = flash_times(*lm["decode"], chunk, flush)
    rates = {"cross": TF32_FLOPS_PER_S}
    on_path.update(flash=lm["launches"])
    on_path.update({k: precision["total"][k] for k in (
        "rank1_update_inv_bf16", "topk_bf16_tc", "topk_int8_tc",
        "topk_pruned_bf16_tc", "topk_pruned_int8_tc")})
    on_path.update({k: minv["launches"][k] for k in MINV_KERNELS})
    on_path.update(topk=serve_launches["topk"],
                   topk_pruned=serve_launches["topk_pruned"],
                   cross=recsys["launches"]["cross"],
                   cross_split=recsys["launches"]["cross_split"],
                   embedding_bag=recsys["bag_launches"]["embedding_bag"],
                   ucb=baselines["club_launches"]["ucb"],
                   rank1_update=baselines["club_launches"]["rank1_update"])
    # launches of every kernel in phase 4b's two counted runs
    on_baselines = {k: baselines["club_launches"][k]
                    + baselines["dccb_launches"][k] for k in KERNEL_INFO}
    rows = []
    for kname in [*work, "flash"]:
        if kname == "flash":
            ms, plain_ms, lib_ms, bms, by, n_bytes, flops = (
                flash_pre[key] for key in ("ms", "plain_ms", "library_ms",
                                           "bound_ms", "bound_by", "bytes",
                                           "ops"))
        else:
            kern, plain, n_bytes, flops = work[kname]
            ms = cuda_ms(kern, flush)
            # the plain top-K versions take a second or more a call: 3 reps
            slow = kname.startswith("topk")
            plain_ms = cuda_ms(plain, flush, reps=3 if slow else REPS,
                               warmup=1 if slow else 3)
            lib_ms = (cuda_ms(library[kname], flush) if kname in library
                      else None)
            bms, by = bound_ms(n_bytes, flops,
                               rates.get(kname, F32_FLOPS_PER_S))
        # a filter kernel's bound is its own (filter_bound_ms); the chain
        # kernel's operations bound, which both are read against, beside it
        chain_bms = None
        if kname in filter_bounds:
            chain_bms = bms
            bms = filter_bounds[kname]["filter_bound_ms"]
            by = filter_bounds[kname]["filter_bound_by"]
        source, replaces = KERNEL_INFO[kname]
        rows.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": on_path[kname],
            "max_abs_err": errs[kname]["max_abs_err"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms,
            **({} if chain_bms is None else {"chain_bound_ms": chain_bms}),
            "near_ties": errs[kname].get("near_ties", 0),
            "serve_launches": serve_launches[kname],
            "baseline_launches": on_baselines[kname],
            "clone_launches": on_clones[kname],
            "shard_launches": shard_launches[kname],
            "ops_launches": ops_launches[kname],
            "train_launches": train_launches.get(kname, 0),
            "cells_launches": cells_launches.get(kname, 0),
        })
        log(f"time {kname}: kernel {ms} ms, plain {plain_ms} ms, "
            f"library {lib_ms} ms, bound {bms} ms ({by}; {n_bytes} bytes, "
            f"{flops} ops), {math.ceil(ms / bms)}x the bound")
    by_name = {row["name"]: row for row in rows}
    # topk_pruned beside topk, in turns, and the pruned kernel's launch
    # alone (``pruned_launch``: the wrapper's walk plan, sorts and gathers
    # done once beforehand); the skip ratios from phase 5's launch
    kernel_only, _ = tops.pruned_launch(*pruned_args)
    turns = turn_ms({"topk": work["topk"][0],
                     "pruned": work["topk_pruned"][0],
                     "launch": kernel_only}, flush, reps=2 * REPS)
    extra = {f"ms_{key}_turns": t for key, t in turns.items()}
    extra.update(ratio_to_topk=turns["pruned"] / turns["topk"],
                 launch_ratio_to_topk=turns["launch"] / turns["topk"],
                 **{key: errs["topk_pruned"][key] for key in (
                     "skip", "plain_skip")})
    by_name["topk_pruned"].update(extra)
    log(f"time topk_pruned beside topk, {2 * REPS} launches each in turns: "
        f"{extra}")
    # each reduced-precision variant beside its f32 kernel, in turns, on
    # the same users and statistics (the bf16 session's batch of phase 5):
    # topk over the f32, bf16 and int8 banks, topk_pruned over each bank's
    # own sorted layout, the M-free update on f32 and bf16 copies of the
    # state
    bank = serving.catalog.serving
    tb_f = tref.tile_bounds(w_q, M_q, occ_q, hyper.alpha,
                            item_clusters.tile_mu, item_clusters.tile_r,
                            item_clusters.tile_xn, item_clusters.tile_n)
    f32_turns = {
        "topk": lambda: tops.topk(w_q, M_q, occ_q, bank.emb, bank.live,
                                  hyper.alpha, K_SHORT),
        "topk_pruned": lambda: tops.topk_pruned(
            w_q, M_q, occ_q, item_clusters.emb_sorted,
            item_clusters.live_sorted, item_clusters.perm, hyper.alpha,
            K_SHORT, tb_f),
        "rank1_update_inv": work["rank1_update_inv"][0]}
    # (the filter kernels also beside the chain kernels they replace at d
    # <= 32, on the same inputs: "<name>:chain")
    for base, variants in (("topk", ("topk_bf16_tc", "topk_int8_tc")),
                           ("topk_pruned", ("topk_pruned_bf16_tc",
                                            "topk_pruned_int8_tc")),
                           ("rank1_update_inv", ("rank1_update_inv_bf16",))):
        t = turn_ms({"f32": f32_turns[base],
                     **{v: work[v][0] for v in variants},
                     **{f"{v}:chain": chain[v] for v in variants
                        if v in chain}}, flush, reps=2 * REPS)
        for v in variants:
            by_name[v].update(ms_turns=t[v], f32_ms_turns=t["f32"],
                              ratio_to_f32=t[v] / t["f32"])
            if v in chain:
                by_name[v].update(chain_ms_turns=t[f"{v}:chain"],
                                  ratio_to_chain=t[v] / t[f"{v}:chain"])
        log(f"time {base} beside its variants, {2 * REPS} launches each in "
            f"turns, on the bf16 session's batch: {t}")
    for prec in PRECISIONS:
        by_name[f"topk_pruned_{prec}_tc"].update(
            skip=errs[f"topk_pruned_{prec}_tc"]["skip"],
            plain_skip=errs[f"topk_pruned_{prec}_tc"]["plain_skip"])
        by_name[f"topk_{prec}_tc"].update(
            {f"choice_flip_rate_{label}": rates[prec]
             for label, rates in precision["flip"].items()})
    # each bf16-Minv variant beside its f32 kernel on the widened Minv (the
    # same inputs otherwise), in turns; the filter ones also beside the
    # chain kernel with the bf16 Minv
    for v in MINV_KERNELS:
        t = turn_ms({"f32": minv_f32[v], v: work[v][0],
                     **({"chain": chain[v]} if v in chain else {})}, flush,
                    reps=2 * REPS)
        by_name[v].update(ms_turns=t[v], f32_ms_turns=t["f32"],
                          ratio_to_f32=t[v] / t["f32"])
        if v in chain:
            by_name[v].update(chain_ms_turns=t["chain"],
                              ratio_to_chain=t[v] / t["chain"])
        log(f"time {v} beside its f32 kernel on the widened Minv, "
            f"{2 * REPS} launches each in turns: {t}")
    for v in MINV_TOPK:
        if "pruned" in v:
            by_name[v].update(skip=errs[v]["skip"],
                              plain_skip=errs[v]["plain_skip"])
    # the filter rows: the chain kernel alone, the rescored pairs, the
    # violations (0) and the filter's own bound beside the operations bound
    for v, fb in filter_bounds.items():
        by_name[v].update(fb, chain_ms=cuda_ms(chain[v], flush),
                          rescored=errs[v]["rescored"],
                          rescored_share=errs[v]["rescored_share"],
                          violations=errs[v]["violations"])
        log(f"time {v} (the filter) alone {by_name[v]['ms']} ms, its chain "
            f"kernel alone {by_name[v]['chain_ms']} ms; rescored "
            f"{errs[v]['rescored']} pairs (share "
            f"{errs[v]['rescored_share']}), violations "
            f"{errs[v]['violations']}; bound (the filter's own) "
            f"{by_name[v]['bound_ms']} ms: {fb}; the chain kernel's "
            f"operations bound {by_name[v]['chain_bound_ms']} ms")
    by_name["rank1_update_bf16"]["max_ulps"] = errs["rank1_update_bf16"][
        "max_ulps"]
    by_name["rank1_update_inv_bf16"]["max_ulps"] = errs[
        "rank1_update_inv_bf16"]["max_ulps"]
    # choose beside its warp variant (the design before the register tile)
    # in turns: at the offline shape on phase 5's inputs, and at serving's
    # (256 users x 64 shortlisted items) on phase 5's serving batch
    for label, cargs in (("", (w, Minv, ctx, occ)),
                         ("_serving", (w_s, M_s, ctx_s, occ_s))):
        t = turn_ms({
            "ms": lambda a=cargs: iops.choose(*a, hyper.alpha),
            "warp_ms": lambda a=cargs: choose_variant(
                *a, hyper.alpha, iops.WARP_PER_USER)}, flush, reps=2 * REPS)
        m, Kc, dc = cargs[2].shape
        extra = {f"{key}{label}_turns": v for key, v in t.items()}
        extra[f"bound_ms{label}"] = bound_ms(
            4 * (m * Kc * dc + m * dc * dc + 2 * m * dc + 2 * m),
            m * Kc * (4 * dc + 2 * dc * dc + 6))[0]
        by_name["choose"].update(extra)
        log(f"time choose beside its warp variant, {2 * REPS} launches "
            f"each in turns, {tuple(cargs[2].shape)}: {extra}")
    by_name["cross"]["bound_ms_f32"] = bound_ms(
        work["cross"][2], 2 * Bb * dI * dI + 3 * Bb * dI)[0]
    # cc_hop in turns with its warp-per-row kernel: on the learned graph,
    # the full graph and the graph of the main path's first stage 2 (at its
    # first hop's labels and its second's), all of the same bytes and so
    # of the same bound; on the learned graph also after a flush that only
    # reads, as rank1_update_inv (the first redesign pass's bytes-bound
    # rows); the dense threshold's sweep; the paths' graphs (phases 4, 4b
    # and 4s)
    first = first_stage2_graph(ops, hyper, d, dev)
    hop1 = gops.cc_hop_packed(first, ids, ids)
    hop2 = torch.minimum(hop1, hop1[hop1.long()])
    log(f"full cc_hop on the first stage 2's graph at its second hop: "
        f"{check_cc_hop(first, hop2, hop2)}")
    ro = read_flush(flush)
    extra = {}
    for label, (a, la), fl in (
            ("", (adj, ids), flush), ("_ro", (adj, ids), ro),
            ("_full", (full, ids), flush), ("_first", (first, ids), flush),
            ("_first_hop2", (first, hop2), flush)):
        t = turn_ms({"ms": lambda a=a, la=la: gops.cc_hop_packed(a, la, la),
                     "warp_ms": lambda a=a, la=la: cc_hop_warp(a, la, la)},
                    fl, reps=2 * REPS)
        extra.update({f"{key}{label}_turns": v for key, v in t.items()})
    extra.update(ms_ro_flush=cuda_ms(work["cc_hop"][0], ro),
                 set_bits=popcount(adj), set_bits_full=popcount(full),
                 set_bits_first=popcount(first))
    log(f"time cc_hop beside its warp-per-row kernel, {2 * REPS} launches "
        f"each in turns, and after a read-only flush: {extra}")
    extra.update(dense_min_sweep=cc_hop_sweep(
        {"_first": (first, ids), "_first_hop2": (first, hop2),
         "_full": (full, ids)}, flush), path_graphs=graphs)
    by_name["cc_hop"].update(extra)
    by_name["rank1_update_inv"]["ms_ro_flush"] = cuda_ms(
        work["rank1_update_inv"][0], ro)
    log(f"time rank1_update_inv after a read-only flush: "
        f"{by_name['rank1_update_inv']['ms_ro_flush']} ms (after zero_: "
        f"{by_name['rank1_update_inv']['ms']})")
    # what any launch costs under this method: a one-element in-place op
    one = torch.zeros(1, device=dev)
    floor_ms = statistics.median(cuda_times(lambda: one.add_(1.0), flush,
                                            TURN_REPS))
    log(f"time launch floor (one-element add_, median of {TURN_REPS} "
        f"launches): {floor_ms} ms")
    # at n = 1 (a block per user for rank1_update): TURN_REPS launches of
    # the kernel and of its plain version, in turns
    for kname, (kern, plain, n_bytes, flops) in at_n1.items():
        bms, by = bound_ms(n_bytes, flops)
        extra = turn_ms({"ms_n1": kern, "plain_ms_n1": plain,
                         **n1_yardsticks.get(kname, {})}, flush)
        extra.update(bound_ms_n1=bms, floor_ms_n1=floor_ms,
                     reps_n1=TURN_REPS)
        by_name[kname].update(extra)
        log(f"time {kname} at n=1: {extra} ({by})")
    # prune on the learned graph of phase 4: set bits only
    set_bits = popcount(adj)
    bms, by = bound_ms(work["prune"][2], set_bits * (2 * d + 8))
    extra = {
        "ms_sparse": cuda_ms(lambda: gops.prune_packed(
            adj, w, cb, w, cb, hyper.gamma), flush),
        "plain_ms_sparse": cuda_ms(lambda: gref.prune_packed_ref(
            adj, w, cb, w, cb, hyper.gamma), flush),
        "bound_ms_sparse": bms, "bound_by_sparse": by,
        "density_sparse": set_bits / (n * n)}
    by_name["prune"].update(extra)
    log(f"time prune on the learned graph ({set_bits} set bits of {n * n}, "
        f"{set_bits * (2 * d + 8)} ops): {extra}")
    by_name["prune"]["density_sweep"] = prune_sweep(dev, w, cb, hyper.gamma,
                                                    flush)
    extra = {f"{key}_decode": flash_dec[key] for key in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    extra.update(bound_ms_f32=bound_ms(flash_pre["bytes"],
                                       flash_pre["ops"])[0],
                 library=f"scaled_dot_product_attention "
                         f"({flash_pre['sdpa']})")
    moe_runs = moe["runs"].values()
    extra.update(moe_flash_times(moe, flush),
                 moe_launches=sum(run["launches"] for run in moe_runs),
                 moe_train_launches=moe["train_launches"],
                 moe_cli_launches=moe["cli_launches"])
    by_name["flash"].update(extra)
    log(f"time flash at decode ({flash_dec['bytes']} bytes, "
        f"{flash_dec['ops']} ops; the split-KV "
        f"variant, both products on the tensor cores): {extra}")
    cross_x, embag_x = recsys_extra_times(recsys, flush, x0b, xl1, c1,
                                          bags_p99)
    by_name["cross"].update(cross_x)
    by_name["embedding_bag"].update(embag_x, floor_ms_p99=floor_ms)
    torch.cuda.synchronize()

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
