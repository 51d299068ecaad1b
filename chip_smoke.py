#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: serve and train
full-width dlrm-rm2 (Adagrad, momentum SGD and Adam; LMA and hashed_row;
its durability: the step guard, checkpoints, a chaos soak, the pool scan,
the CSR store; hashed_row through the tiered store under a memory budget),
full-width DCN-v2, dlrm-rm2 with the qr, md and freq
embeddings, full-width DIN, then full-width xDeepFM, then dlrm-rm2 with
its pool and D' store sharded over 4 ranks on the same card: a (1, 4) mesh,
then a (data=2, model=2) mesh, freq and the CSR store under a mesh, the
exchange guard and a checkpoint under a mesh, the dense LM
tinyllama-1.1b at full width (bf16, an int8 KV cache): prefill, decode,
the LMServer, decode_32k, prefill_32k and an LMA token table, the GAT
(gat-cora) trained at full width on its four shapes, ogbn-products'
126,167,309 edges included, and through an LMA node-id table, and last the
MoE and MLA LMs (deepseek-v3-671b, llama4-scout-17b-a16e) served at full
width and 4 layers, then the LMs trained at train_4k (S = 4,096):
tinyllama-1.1b at full width and depth, with and without an LMA token
table, and the MoE LMs at the depth one card holds, then the LMs served
under a (data, model) mesh of 4 gloo ranks on the card.  The host batches of
the launcher runs (phases 9, 33c) and of the LM training (phase 38) are
drawn in a spawned process (``HostDraws``) while the card runs the phases
before them.

Run from the root of a checkout: ``python3 chip_smoke.py`` (``python3
chip_smoke.py --phase 39`` builds the kernels and runs phase 39 alone).  It needs one
sm_90 card and ``nvcc``; it imports only torch, numpy and ``repro_torch``
(from ``src/``), and it exits non-zero, printing no result, when there is
no card or no port beside it.

Phases (any failure raises and ends the run with a non-zero code):
  1. print the card's name and power limit; build the CUDA kernels (one
     nvcc per source, in parallel) and log each kernel's registers, stack
     frame and spill stores from ptxas;
  2. build dlrm-rm2 at full width on the card: the 135,053,312-slot striped
     LMA pool and the 33,762,577 x 32 D' store with planted clusters, a
     share of values made very sparse (support 0 or 1) so the fallback runs;
  3. hold each kernel against its plain PyTorch version on the card at the
     serving shapes (locations and lookups bit-exact, bag and dot within
     tolerance);
  4. serve single requests through the port's BatchingScorer (max_batch
     512) at two offered rates; the fused lookup and dot kernels must have
     launched once per device call; one served batch is recomputed from the
     plain versions;
  5. the split lookup (locations kernel + gather) over the served batch;
     the locations kernel must have launched;
  6. time each serving kernel at B=512 and B=4096 (device time from
     CUDA-graph replay) beside its bound and its plain version; the dot
     interaction also at B=16 and the training batch B=65,536, beside
     torch.bmm with the triangle's index, checked against its plain version
     (the same bits twice) and traced by torch.profiler at each batch;
  7. hold the training kernels against their plain versions at full width:
     locations bit-exact (lma flat and striped with fallback rows,
     hashed_elem, hashed_row), scatter-add and weight gradient within 1e-6,
     on a serving batch; locations bit-exact and scatter-add within 1e-6 of
     each slot's sum |g| on a real B=65,536 training batch (the plain
     versions in chunks); sparse Adagrad on a sentinel-padded unique stream
     and on a real B=65,536 step's bucketed stream (updates and
     accumulators equal, the untouched accumulator slots bit-unchanged);
  8. train dlrm-rm2 at full width for a few steps through the port's Trainer
     with sparse pool gradients, each step also taken densely (a second
     Trainer) from the same parameters and accumulators: finite losses,
     the pools' .grad stays None on the sparse path, each run launched
     exactly its kernels per step (sparse: lookup, locations, sparse
     Adagrad; dense: lookup, scatter-add); the two steps agree
     (``check_step``, for every pool: bit-equal outside the pools, pool
     slot sums within the rounding bound, each pool exactly Adagrad of its
     own sums); steps/s, lookups/s, a per-phase split from CUDA events,
     host batch time and peak memory;
  9. the paper's comparison through the port's launcher, 300 steps at
     B=512 and alpha = 16: lma-dlrm-criteo with every registered kind but
     full (freq, hashed_elem, hashed_row, lma, md, qr), lma-dlrm-avazu
     with lma and hashed_elem; eval AUC of each; their host batches (D'
     rows, steps, eval) drawn aside and handed out by
     (spec, size, index);
 10. a bag's backward on the full pool (scatter-add and weight-gradient
     kernels) against the plain versions;
 11. time the training kernels (CUDA-graph replay) beside their bounds,
     plain versions and, for sparse Adagrad, torch.optim.Adagrad on a
     sparse gradient (its device time from the profiler: a sparse step
     synchronises, so no graph captures it), and trace the sparse
     Adagrad kernel's two passes and the weight gradient;
 18. (run here, while dlrm-rm2 is on the card) build dlrm-rm2 with
     hashed_row at the same budget (2,110,208 rows of 64) and take one
     B=65,536 step's row-mode SparseGrad (one index per row, [K, 64]);
 19. hold sparse SGD and sparse Adam (and Adagrad's row layout) against
     their plain versions on a sentinel-padded unique stream and the real
     bucketed stream of the LMA pool, all three flat on a tile-edge stress
     stream (runs of every length 1..4,097 across the fold's tile edges,
     one of 2^15, a sentinel tail), on the row-mode SparseGrad (Adam also
     with a row-wise nu) and on a bucketed row stress stream [K, 64] (runs
     of every length 1..300 and one of 5,000 across the row kernel's
     32-entry spans, -0 values, lone -0 entries, runs whose column is all
     -0, a sentinel tail; states a tenth -0): updates and states bit-equal
     as int32 bit patterns, untouched state slots bit-unchanged; a
     mismatch fails the run after phase 22;
 20. train full-width dlrm-rm2 with make_optimizer's sgd arm (momentum SGD,
     lazy sparse SGD) and adam arm (Adam, lazy row-wise Adam) on the LMA
     pool, and the adam arm on the hashed_row pool, 8 steps each, each step
     taken sparse and dense from one state: exact launch counts per step
     (the sparse optimizer's kernel once, no sparse Adagrad, no locations
     kernel in row mode) and ``check_step`` with its lazy rule (the sparse
     pool exactly the plain lazy optimizer of its SparseGrad, untouched
     slots bit-unchanged; the dense pool the same update of its own sums at
     the touched slots; the untouched slots the dense path moved counted);
 21. the embedding bag through ops.embedding_bag at the reference's bench
     shape and on the hashed_row pool viewed as [2,110,208, 64] with a
     B=4,096 batch's rows, within 1e-6 of sum |w T|, the same bits twice,
     with sha256 digests of inputs and outputs (two versions of the kernel
     run on one card compare their bits by them);
 22. time sparse SGD and Adam (flat and row layout) and Adagrad's row
     layout (CUDA-graph replay) beside their bounds, plain versions and torch.optim.Adagrad /
     SparseAdam on the live entries' COO gradient (hybrid in the row
     layout; profiled device time), the bag (cold L2) beside its bound,
     plain version, F.embedding_bag and the launch floor (a one-element
     fill timed the same way); then free dlrm-rm2 and its training state;
 32. (run here, on the dlrm-rm2 model the phases above trained, every
     Trainer from this phase's initial parameters with sparse Adagrad at
     B=65,536, 24 host batches cached) durability: (a) a nan_grad and a
     huge_grad step skipped, the state's sha256 digest unchanged, rows 2,
     3 and 4 launched once each and row 7 not; a clean guarded step
     bit-identical to the unguarded step from the same state; guarded and
     unguarded steps/s, alternated; (b) a base save of the pool, its
     accumulator and the MLPs (1.09 GB) after one step, a restore into a
     fresh Trainer bit-identical to it, one step and a delta save: bytes,
     the synchronous snapshot and the background write's seconds, restore
     and scan seconds, dirty chunks per pool leaf; (c) a clean run of 24
     steps and a chaos run of the same steps (``DUR_SPEC``: nan_grad,
     preempt, torn_ckpt, rot_row, read_fail, preempt; a boundary every 4
     steps, deltas, one skip rolls back, a boundary quarantine rolls
     back): the chaos run's durable state bit-identical to the clean
     run's, restarts equal to its preempts, at most 4 steps lost; health
     counters over its incarnations, the checkpoint directory's peak size;
     (d) the pool scan on the card a bitwise no-op on a clean state,
     chunk checksums equal numpy's, and after rot_row's 8 flips exactly
     the chunks they hit found and zeroed; (e) the D' store as CSR, built
     on the card: lookups and locations through it bit-identical to the
     dense store's, one launch of rows 2 and 4 each; (f) the launcher's
     lma-dlrm-criteo as phase 9 runs it, with --ckpt-delta and faults
     (nan_grad@50, rot_row@120:8): 300 steps completed, its health and
     eval AUC beside phase 9's; the checkpoints live in a temporary
     directory under build/, removed at the end;
 33. (run here, after phase 32, the LMA model and its D' store still on
     the card) tiering: (d) the distinct 512-slot blocks one planned
     B=4,096 batch touches in the striped LMA pool and in hashed_row's;
     dlrm-rm2 with hashed_row (2,110,208 rows of 64) under a 512 MiB
     budget for its two compact leaves (pool and Adagrad accumulator; a
     stage bound of B * 26 blocks, one per lookup, since a 64-slot row
     lies in one block; 12,582,912 hot slots), which the launcher's
     staging rule refuses; (a) 24 steps at B=4,096 through the tiered
     store (re-tier every 8), dense Adagrad, each beside a resident dense
     step from the same state (``export_full``): non-pool parameters,
     states and losses bit-equal, slot sums within sum_tol (two sequential
     sums), each pool exactly Adagrad of its own sums; exact launches (row
     4 twice and row 3 once a tiered step, rows 2, 5 and 7 never);
     tiered and resident steps/s, the pre-step's split (plan,
     touched_blocks, stage, install, writeback, retier), staged blocks and
     bytes a step, host-to-device and device-to-host GB/s; the tiered
     lookup bit-equal to row 2's; a stage, install, write-back and re-tier
     with no update leaving both full pools bit-identical; (b) a clean and
     a chaos run of 24 tiered steps (``TIER_DUR_SPEC``: nan_grad,
     stage_fail, preempt, torn_ckpt, rot_row; a boundary every 4 steps,
     deltas): full pools, accumulator and MLPs bit-identical, tier meta
     equal, staging retried, restarts equal to preempts; save, restore
     and ``sanitize_cold`` times; (c) full-width DIN through the launcher
     with ``--tier-budget-mb 40 --batch 4 --steps 300`` beside the same
     run untiered (the DIN batches drawn aside for both): compact leaves
     within 40 MiB, both eval AUCs;
 29. free dlrm-rm2's pool and training state, keep its D' store, and
     build full-width DCN-v2 on that store (the same 26 vocabularies and
     max_set): a 33,763,328-slot striped pool, d=16, x0 of 429, 3 cross
     layers, deep MLP 1024-1024-512; rows 2, 4 and 5 at d=16 over a
     B=65,536 training batch (lookups and locations bit-exact, scatter-add
     within 1e-6 of each slot's sum |g|); serve at the two rates (row 2
     once per device call); 4 + 4 steps at B=65,536 under ``check_step``
     (rows 2, 4 and 7 per sparse step, 2 and 5 per dense step);
     retrieval_cand, 1,000,000 candidates in chunks of 8,192: timed, one
     forward's launches a chunk, the first chunk's scores bit-equal to a
     direct forward of its batch; then free the store;
 30. dlrm-rm2 at full width with qr (1,838,080 parameters), md
     (132,282,385; dims 1-4 a field) and freq (1,024 hot rows, 2,109,184
     tail rows of 64; its hot ids from a training batch's id counts): a
     served batch against the plain forward, 1,024 requests at 100K/s,
     4 + 4 steps at B=65,536 under ``check_step`` (qr and md have no pool:
     both trainers bit-equal; freq in row mode, its row ids and locations
     on the card bit-equal to the CPU's); row 3 once per device call and
     per step, freq's row 7 (row layout) once per sparse step, rows 2, 4
     and 5 never;
 31. full-width DIN: 5,000,000 items, d=18, a 5,627,904-slot flat pool,
     its 5,000,000 x 32 D' store planted on the card; batches and requests
     drawn in bulk (``DinDraw``); rows 2, 4 and 5 at d=18 over a B=16,384
     batch's history and targets; serve at the two rates (row 2 twice per
     device call: history, then target); 4 + 4 steps at B=65,536 under
     ``check_step`` (both lookups' records in one SparseGrad, K =
     119,144,448, a global sort and row 7's flat fold); retrieval_cand as
     in phase 29;
 12. build xDeepFM at full width on the card: the 21,102,592-slot flat
     LMA pool (d=10), the 2,113,536-slot flat linear pool (d=1) and the
     33,763,877 x 32 D' store, planted and made very sparse as in phase 2;
 13. hold the CIN kernel against its plain version on all three layers'
     real inputs at B=512, B=4096 and a ragged B=333: every output within
     1e-5 of its sum |terms|;
 14. hold the lookup and locations kernels against their plain versions
     for both pools at B=512, bit-exact;
 15. serve xDeepFM requests (no dense features) through the BatchingScorer
     at the two offered rates: the CIN kernel launched three times and the
     lookup twice per device call; one served batch against the plain
     versions;
 16. train xDeepFM at B=4096 for a few steps, sparse and dense, each step
     taken both ways from one state and held together by ``check_step``
     for both pools;
 17. time the CIN kernel, its plain version and one torch.einsum (all by
     CUDA-graph replay) per layer at B=512 and B=4096, beside two bounds:
     float32 FMAs on the CUDA cores and three TF32 passes on the tensor
     cores (the lower, the card's floor, is the row's bound); then free
     xDeepFM;
 23. the one-card oracle: rebuild dlrm-rm2 from the seed, record the
     logits of a 512-request batch, hashed_row's lookup of it, and 4
     Adagrad steps at B=65,536 taken sparse and dense from one state
     (losses, the final pool and dense parameters); save them on the host
     and free the card;
 24. spawn 4 ranks on this card with the gloo backend (``run_ranks``: a
     FileStore, the ``spawn`` start method; all_gathers of 1 MiB or more
     through CUDA IPC, every other collective staged through host memory,
     counted and timed, so its times are not NVLink's); each
     rank builds its slab of the pool and its rows of the store (padded to
     ``store_rows``) from the same seed;
 25. on every rank, rows 10-12 and the slab mode of rows 2 and 5 against
     their plain versions at the 512-request and B=65,536 chunk shapes:
     rows 10, 11 and the slab lookup bit-exact, rows 12 and 5 within 1e-6
     of each slot's sum |g|;
 26. the sharded forward of the 512 batch under psum, ring and all_to_all,
     every rank's logits bit-equal to the oracle's, with exact launches per
     rank; hashed_row's lookup under ring bit-equal to its one-card lookup;
 27. under each strategy, 4 steps through each rank's Trainer, sparse and
     dense from one state (``check_step`` on the rank's slab, exact
     launches): the sparse run's losses, slabs and dense parameters
     bit-equal to the oracle's, the dense losses too; losses and dense
     parameters bit-equal across ranks; steps/s, the phase split, each
     rank's peak memory and its host-staged collective time;
 28. on rank 0, time rows 10-12 (CUDA-graph replay) at the B=65,536 chunk
     shapes beside their bounds and plain versions;
 34. (the rest of distribution, ``run_distribution``) spawn the 4 ranks
     again as a (data=2, model=2) mesh (world rank d * 2 + m; gloo, one
     card); on the (1, 4) mesh of the same ranks: (b) freq dlrm-rm2's
     forward of the 512 batch under psum, ring and all_to_all bit-equal to
     the one-card forward (the generic location lookup: row 11's gathers),
     (c) the LMA model with its D' store as CSR sharded per rank
     (``shard_csr_buffers``): the forward bit-equal to the dense store's
     and the oracle's, (d) an injected drop_chunk: the ExchangeGuard
     demotes all_to_all, then ring; 2 sparse steps after it bit-equal to
     psum-pinned ones, psum's launches, (e) one sparse step, a save
     gathered to rank 0 (1.09 GB), one more step, and on rank 0 the save
     restored on one process on the card, every leaf bit-equal; then on
     the (2, 2) mesh (a) the 512 batch's lookup share bit-equal to the
     oracle's rows (phase 23's oracle, reused), its logits within 1e-5;
     sparse and dense Adagrad at B=65,536 (32,768 a data index), 4 steps
     each under psum and all_to_all: losses within 1e-5 of the oracle's,
     exact launches, losses and dense parameters bit-equal on every rank,
     slabs bit-equal between replicas; steps/s, each rank's peak, the
     host-staged s and GiB a step by axis; and (e) the (1, 4) checkpoint
     restored at (2, 2): one further step within 1e-5 of the uninterrupted
     run's;
 35. (the dense LM, ``run_lm``, after freeing everything before it)
     tinyllama-1.1b at full width (22 layers, d 2,048, 32 heads, KV 4,
     d_ff 5,632, vocab 32,000, bf16, int8 KV cache), random weights from
     the seed: (a) its parameter count (1,099,956,224 by param_count),
     bytes and cache bytes a token (11,968); (b) at B=8, S=2,048 tokens
     from LMGenerator(32000, seed=0), the decode of the last token from
     the int8 prefill cache of the first S - 1 against the prefill over
     all S, both against a float32 copy of the weights with a float cache:
     within rtol 0.1, atol 0.15 (tests/test_kv_quant.py's bound), the
     float32 top-1 among the int8 top-5, the float32 decode within 2e-3 of
     its prefill; (c) the LMServer over 64 prompts of 128-1,024 tokens
     (seed 1), n_slots 32, max_new_tokens 128, max_len 1,152: prefill ms a
     wave, the median decode-step ms, generated tokens/s, peak GiB, and
     its first wave recomputed by prefill + decode_step, tokens equal; (d)
     decode_32k, B=128 against a 32,768-token int8 cache (50.2 GB,
     quantized from random K/V): 5 steps at cache_len 32,763-32,767, the
     median ms, peak GiB, one layer's dequantization, blocked attention
     and F.scaled_dot_product_attention on its dequantized K/V; (e)
     prefill_32k at B=4 (the published 32 is a mesh's global batch): s,
     tokens/s, peak GiB, one layer's blocked attention and causal SDPA;
     (f) the model with an LMA token table (4,096,000 striped slots over a
     planted 32,000 x 32 D' store): embed_tokens through row 2 bit-equal
     to the plain split path on (b)'s batch, row 2 timed at the prefill
     and decode shapes, a prefill and 16 decode steps launching row 2
     once each; row 2 at 1, 4, 8, 16 and 128 tokens (``row2_sweep``),
     each bit-equal to the plain split path and timed beside its bound,
     the launch floor and the one-tile grid; rows 4 and 10 at those
     sizes, 512 and 1,056 rows (``chunk_sweep``; row 10 on a slab from
     base m / 4), each bit-equal to its plain version and timed likewise,
     beside row 2's time and with the blocks an SM holds;
 36. (the GAT, ``run_gat``, last; its two large graphs built by
     ``GraphBuilder``, a spawned process, while phases 23-35 run) gat-cora
     at full width (2 layers, 8 heads of 8, Adam at lr 5e-3 through the
     Trainer), the edge-chunked aggregation (``models/gnn.py``): (a) Cora
     (2,708 nodes, 23,820 edges, 1,433 features): the logits and every
     parameter gradient chunked against ``gat_conv_plain`` at the default
     chunk and at 997 edges (which splits in-edge lists), within 1e-5 and
     1e-4 of the plain max |value|; 200 steps, accuracy on and off the
     train mask; (b) molecule (128 graphs x 30 nodes, 20,224 edges, the
     mean readout): 50 steps on one batch, the loss falling; (c)
     minibatch_lg: the Reddit-like graph (232,965 nodes, 229,464,749
     edges) and its sampler; one block padded to 169,984 nodes and 338,944
     edges held chunked against plain; 20 steps on fresh blocks, the host's
     sampling beside the device step; (d) ogb_products full-batch
     (2,449,029 nodes, 126,167,309 edges): 5 steps, losses finite and
     falling; one step at layer 1's default chunk C and at C / 4 from one
     state (losses within 1e-5, parameter changes within 1e-2 of the
     step); steps/s, each layer's forward and backward (CUDA events),
     layer 1 by kernel (``torch.profiler``), peak memory; (e) node ids
     (arange(N)) through an LMA table (vocab 2,449,029, d 64, alpha 16,
     max_set 32) over a planted D' store: 65,536 ids through row 2
     bit-equal to the plain split path, 3 Trainer steps launching rows 2,
     4 and 9 once each a step (sparse pool gradient; row 5 on the dense
     rule);
 37. (the MoE and MLA LMs, ``run_moe``, last; one model on the card at a
     time) deepseek-v3-671b and llama4-scout-17b-a16e at full width and
     4 layers (deepseek: 3 dense + 1 MoE layer, MLA; scout: 4 MoE
     layers, GQA), bf16, int8 cache, random weights from the seed: (a)
     each one's parameter count by param_count (15,111,028,736 and
     10,877,337,600) and cache bytes a token (2,320 and 8,448), its build
     time; (b) at the reference's drop-free capacity factor E / k * 1.05,
     B=4, S=128: the decode of the last token from the int8 prefill cache
     of S - 1 tokens against the prefill over S (rtol 0.1, atol 0.15, the
     prefill's top-1 among the decode's top-5) for each sequence whose MoE
     routes agree at every layer, 3 of the 4 at least; every sequence's
     router input within that bound and its router logits within
     0.08 of the prefill's at each MoE layer up to the first where
     its experts part;
     deepseek's first MLA layer copied to float32, its absorbed decode
     against mla_train's last position within 1e-4; the MoE layer against
     a per-expert float32 loop on the bf16 weights, normwise within 2e-2;
     (c) the LMServer over
     32 prompts of 128-1,024 tokens (seed 1) in waves of 16, 64 new tokens
     each, at the config's capacity factor: generated tokens/s, the median
     decode step, each wave's MoE capacity and dropped assignments; (d)
     deepseek's decode_32k, B=128 against a 32,768-token int8 latent cache
     (9.73 GB): 5 steps, peak memory, the MoE layer's share and bytes
     bound, one layer's whole-cache dequantization; (e) deepseek's
     prefill_32k at B=1 (C = 1,280); (f) scout's (b), (c) and prefill_32k
     (C = 2,560, the dropped assignments logged); (g) deepseek with an LMA
     token table (129,280 x 7,168 at alpha 16, a planted D' store): row 2
     bit-equal to the plain split path over 4,096 tokens, timed at the
     prefill and decode shapes beside its bound, a prefill and 16 decode
     steps launching row 2 once each, and 35f's sweeps at d = 7,168; (h)
     the port's launcher (``launch.train.main``) for every registered LM
     arch, its smoke config for 3 steps on the card: every loss finite,
     deepseek-v3's optimizer Adafactor, steps/s;
 38. (the LMs trained, ``run_lm_train``, last) train_4k (S = 4,096),
     remat on (each layer and each loss chunk checkpointed), through the
     port's Trainer with the arch's optimizer as ``launch.train``'s
     ``make_optimizer`` builds it, batches from LMGenerator(vocab, seed=0):
     (a) tinyllama-1.1b at 22 layers, d 2,048, bf16, Adam at lr 4e-4, B
     = 8 (the largest power of two the reckoning, ``train_reckoning``,
     fits; its peak measured beside it): one warm step and 3 timed,
     every loss finite, steps/s and tokens/s (host clock), the Trainer's
     phase split (CUDA events), peak GiB and the model-FLOP utilisation,
     tokens/s x (6 N + 6 L S d) / 989 TFLOP/s; (b) the same with 35f's LMA
     token table and sparse pool gradients at B = 8: one step from a
     common state taken densely (rows 2 and 5) and sparse (rows 2, 4 and
     9), held to each other by ``check_step`` (losses bit-equal), one
     more sparse step; each path's launches exactly one of each of its
     rows a step; row 4's locations bit-equal to ``locations_ref`` and
     row 2's lookups to their gather over the batch, chunk by chunk;
     rows 2, 4, 5 and 9 timed at these shapes beside their bounds, plain
     versions and (row 9) torch.optim.SparseAdam; (c) deepseek-v3-671b
     (Adafactor) and llama4-scout-17b-a16e (Adam) at B = 1 and the
     deepest depth the reckoning fits (deepseek from one dense and one
     MoE layer, scout from one MoE layer): one warm step and 2 timed,
     each MoE layer's C and dropped assignments (its recompute routing
     alike); an arch that fits at no depth prints its reckoning and is
     not run;
 39. (the LMs served under a mesh, ``run_mesh_lm``, last) 4 gloo ranks
     on the card, spawned as a (data=2, model=2) mesh whose world mesh is
     the (1, 4) one, wait while the parent computes one-card oracles
     (bf16, and the same weights upcast to float32: the twin the bf16 runs
     are held to, beside one card's own distance from it); each rank's
     int8 cache slab is filled from a seeded function of (layer, leaf,
     position block, row block): (a) tinyllama-1.1b at 22 layers,
     long_500k over all four ranks at (1, 4), 3 steps at cache_len
     524,285..524,287; (b) decode_32k at (2, 2), B = 64 (the published
     128 cut for four ranks on one card), 3 steps, then the LMServer over
     16 prompts with float32 weights, its tokens equal to one card's but
     at top-2 ties; (c) deepseek-v3-671b at 4 layers, (1, 4), 64 experts
     a rank, decode_32k at the largest B of 128, 64, 32 whose reckoning
     fits 72 GB, drop-free (the float32 MoE check at the config's C);
     (d) llama4-scout at 4 layers, (2, 2), E over (data,
     model), a prefill at B = 2, S = 1,024 (the full-mesh token ladder)
     and 4 steps, drop-free; (e) the LMA token table at (1, 4) under
     psum, ring and all_to_all, bit-equal to one card's row 2, launches
     exact, rows 2, 4, 10 and 11 timed at its shapes (rows 4 and 10 at
     their default tile, 32 columns for a 512-row chunk).  Each step: layer
     0's writes bit-equal to one card's, every write and the logits held
     to the float32 twin (35b's bound, or 1.25 x one card's distance) over
     the sequences whose MoE routes agree, the last layer's float32
     attention within 1e-5 of a float64 evaluation over the whole layer,
     and at the end each slab bit-equal to the seeded cache with exactly
     the run's writes; a MoE layer in float32 within 1e-5 normwise of one
     card's ``moe_apply``.  Then print one line per kernel, the
     ``kernels`` JSON line, the card line, and last the result line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
# (offered requests per second, open loop; requests): full batches of 512,
# then a trickle where the 2 ms batching delay cuts small batches
SERVE_RUNS = ((100_000, 2048), (5_000, 1024))
TICK_S = 1e-3
SPARSE_PERIOD = 50              # value v % 50 == 0: support 0, == 1: support 1
N_CLUSTERS = 4096
TRAIN_STEPS = 8                 # per run, sparse and dense
XDEEPFM_TRAIN_BATCH = 4096      # the xDeepFM paper's mini-batch (section 4.1)
CIN_CHECK_BATCHES = (512, 4096, 333)
# row 3's batches: about the 5K/s path's mean, the largest served, 4,096 and
# the training batch
DOT_BATCHES = (16, 512, 4096, 65536)
LAUNCHER_STEPS, LAUNCHER_BATCH = 300, 512
# launch.train's --n-signatures and --eval-batches defaults, and the eval
# batches its ``evaluate`` draws: (size, first index)
LAUNCHER_SIGNATURES, LAUNCHER_EVAL_BATCHES = 10_000, 8
LAUNCHER_EVAL_B, LAUNCHER_EVAL_FROM = 2048, 700_000
FULL_CHUNK = 4096 * 26         # values per plain call over a B=65,536 batch
# A pool slot's gradient is a float32 sum of its run of n contributions (n
# up to ~22,000 at the hottest slot of a B=65,536 step).  Two summation
# orders (atomics, the plain index_add_, the sparse fold) differ by
# rounding only, which scales with the slot's sum of |contribution|.  For
# contributions of random sign (phase 7's random g) the partial sums are a
# random walk and the difference stays near u = 2^-24 of sum |g|: held to
# SUM_RTOL.  A real step's contributions to one slot share a sign in part
# (p - y has a nonzero mean), so the atomics' partial sums grow with n; the
# sums are held to sum_tol, the classical bound on the rounding of a
# sequential sum (the atomics) plus that of a pairwise one (the fold),
# which rounding cannot exceed.  It is tight where runs are short (most
# slots), and it catches one lost or misplaced contribution of average
# size, sum |g| / n, at every slot with n < 2,900.
SUM_RTOL = 1e-6
# A CIN output is a float32 sum of Hk * F (up to 7,800) products; the kernel
# and the plain version sum them in different orders, so each output is held
# to a share of its sum |terms|, as the CPU tests hold the plain version to
# the reference.
SUM_RTOL_CIN = 1e-5
U32 = 2.0 ** -24                # float32 unit roundoff
FLT_MIN = 2.0 ** -126           # the smallest normal float32
ADAGRAD_EPS = 1e-10             # optim.adagrad's default, as make_optimizer
MOMENTUM = 0.9                  # make_optimizer's sgd arm
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8   # adam's defaults, likewise

# Peak rates of one H100 SXM (NVIDIA's published figures; 700 W): 3.35 TB/s
# of HBM, 67 TFLOP/s float32 outside the tensor cores.  NVIDIA publishes no
# int32 ALU rate; the ceiling no mix of int32 instructions can pass is the
# dispatch limit, 4 schedulers x 32 lanes per SM per clock (logic, shifts
# and min on the 64-lane INT pipe, IMAD on the FMA pipe), so 132 SMs x 128
# x 1.98 GHz = 33.5 T int32 operations/s.  The tensor cores do 494.7
# TFLOP/s of dense TF32; three TF32 passes make a float32-exact product.
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2**20          # its L2 cache
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 494.7e12     # dense, on the tensor cores
INT32_OP_PER_S = 132 * 128 * 1.98e9

# int32 operations per unit of work, counted from csrc/hash_core.cuh
OPS_HASH = 15          # hash_u32 (14) + the running min, per seed x element
OPS_CHAIN_STEP = 11    # fmix32 (8) + xor, multiply, add per chain step
OPS_FINISH = 11        # final fmix32 (8) + slot arithmetic (3) per column
OPS_FALLBACK = 32      # hash_pair (29) + slot arithmetic (3) per column


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ timing

def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Host-launched time per call: CUDA events around ``iters`` calls.
    Includes launch overhead wherever the host is slower than the card."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters: int) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    replayed between CUDA events, so no host launch cost is timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cold_graph_ms(torch, fn, iters: int, dev, repeats: int = 3) -> float:
    """Device time per call with a cold L2: in one CUDA graph each call
    follows a read of a buffer three times the L2's size, and the same reads
    alone, replayed from a second graph, are subtracted; the median of
    ``repeats`` such differences."""
    junk = torch.ones(3 * L2_BYTES // 4, device=dev)
    sink = torch.empty((), device=dev)

    def flush():
        torch.sum(junk, dim=0, out=sink)

    def both():
        flush()
        fn()

    diffs = [graph_ms(torch, both, iters) - graph_ms(torch, flush, iters)
             for _ in range(repeats)]
    return float(np.median(diffs))


class PhaseTimer:
    """CUDA events at the Trainer's phase marks; the median device time of
    each phase over the steps after the first."""

    def __init__(self, torch):
        self.torch = torch
        self.steps: list[list] = []

    def mark(self, name: str):
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        if name == "start":
            self.steps.append([])
        self.steps[-1].append((name, ev))

    def split_ms(self) -> dict:
        self.torch.cuda.synchronize()
        per = {}
        for step in self.steps[1:]:
            for (_, a), (name, b) in zip(step, step[1:]):
                per.setdefault(name, []).append(a.elapsed_time(b))
        return {k: float(np.median(v)) for k, v in per.items()}


def events_ms(torch, fn):
    """-> (fn(), ms between CUDA events recorded around the one call)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def profile_ms(torch, fn, iters: int = 3) -> dict:
    """Device time per call of each CUDA kernel that ``fn`` launches, by
    kernel name, from ``torch.profiler`` over ``iters`` calls after a
    warm-up call: the trace of a kernel's passes."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        if us > 0:
            out[ev.key[:60]] = us / 1e3 / iters
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def device_ms(torch, fn, iters: int = 3) -> float:
    """Device time per call of everything ``fn`` launches (the profiler's
    kernel times summed): the yardstick for a library call that synchronises
    with the host (a sparse COO optimizer step), which no CUDA graph can
    capture; for graph-captured kernels it agrees with ``graph_ms``."""
    return sum(profile_ms(torch, fn, iters).values())


def sum_tol(run, abs_sum, pairwise: bool = True):
    """How far a sequential float32 sum and a second float32 sum of the same
    ``run`` contributions, whose absolute values sum to ``abs_sum``, can
    differ: (gamma(n - 1) + gamma(ceil(log2 n))) * abs_sum when the second is
    pairwise, 2 gamma(n - 1) * abs_sum when it is sequential too,
    gamma(k) = k u / (1 - k u) (Higham, Accuracy and Stability of Numerical
    Algorithms, 4.2).  The sequential sums on the card are atomic adds,
    which flush a subnormal input or result to zero, each losing less than
    FLT_MIN: 2 n FLT_MIN more covers both sums."""
    def gamma(k):
        return k * U32 / (1 - k * U32)
    second = run.log2().ceil() if pairwise else run - 1
    return (gamma(run - 1) + gamma(second)) * abs_sum + 2 * run * FLT_MIN


# each built kernel's ptxas figures by name (``ptxas_table``), filled by
# the build in ``run_phases``; row 5's timings report its registers
PTXAS: dict = {}


def scatter_launch(torch, S: int) -> dict:
    """Row 5's cooperative grid on the current card for sets of ``S``
    words: the blocks an SM holds (the wrapper's own occupancy query), the
    grid, and the kernel's registers from the build's ptxas report."""
    from repro_torch.kernels.fused_embed import kernel as fk
    index = torch.cuda.current_device()
    return {"grid": fk.scatter_grid(index, S),
            "blocks_per_sm": fk.blocks_per_sm("scatter", S, 0),
            "registers": PTXAS.get("fused_scatter_kernel",
                                   {}).get("registers")}


def fill_ms(torch, m: int, dev, iters: int) -> float:
    """The pool's zero fill alone, as the parent's wrapper ran it before
    row 5: ``torch.empty(m).zero_()``, by CUDA-graph replay."""
    return graph_ms(torch, lambda: torch.empty(m, device=dev).zero_(), iters)


def kernel_fill_ms(torch, spec, g, gids, rows, support, iters: int) -> float:
    """Row 5 with no rows: the kernel's own fill of its [spec.m] buffer
    (the bulk copies that its FILL_BYTES_PER_NS stands for), by CUDA-graph
    replay."""
    from repro_torch.kernels.fused_embed.kernel import fused_scatter_add_cuda
    return graph_ms(torch, lambda: fused_scatter_add_cuda(
        spec, g[:0], gids[:0], rows[:0], support[:0]), iters)


def ptxas_table(report: str) -> dict:
    """Registers, stack frame and spill stores of each kernel in one
    source's ``ptxas -v`` report, by the kernel's name."""
    table, fn = {}, None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            fn = kernel_name(m.group(1))
            table[fn] = {"registers": 0, "stack": 0, "spill": 0}
        elif fn and "bytes stack frame" in ln:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", ln)]
            table[fn]["stack"], table[fn]["spill"] = nums[0], nums[1]
        elif fn and (m := re.search(r"Used (\d+) registers", ln)):
            table[fn]["registers"] = int(m.group(1))
    return table


def kernel_name(mangled: str) -> str:
    """A kernel's name with its template arguments, demangled by c++filt
    less the anonymous namespace and the parameter list (the mangled symbol
    where c++filt is missing)."""
    try:
        out = subprocess.run(["c++filt", mangled], capture_output=True,
                             text=True, timeout=30).stdout.strip()
    except OSError:
        return mangled
    out = out.replace("(anonymous namespace)::", "").removeprefix("void ")
    return out[:out.rindex("(")] if out.endswith(")") else out or mangled


def bound(nbytes: float, ops: float, rate: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def hash_work(torch, p, rows, support, fallback: bool = True):
    """(bytes read, int32 ops) of the slot function over these rows (see
    OPS_*): the set rows of the hashed values in, plus ids and support when
    the fallback applies (its rows take the hashed_elem columns instead)."""
    N, S = rows.shape
    valid = (rows != -1).sum(dim=1)
    lma = support >= p.min_support if fallback else torch.ones_like(support,
                                                                     dtype=bool)
    n_fb = int((~lma).sum())
    ops = (p.n_raw_hashes * OPS_HASH * int(valid[lma].sum())
           + (N - n_fb) * p.d * (p.n_h * OPS_CHAIN_STEP + OPS_FINISH)
           + n_fb * p.d * OPS_FALLBACK)
    return (N - n_fb) * S * 4 + (N * 8 if fallback else 0), ops


def lma_work(torch, p, rows, support, fallback: bool):
    """(bytes, int32 ops) of the lookup (fallback) or of the locations
    kernel without it: the hashing, the gathered floats, d slots out."""
    nbytes, ops = hash_work(torch, p, rows, support, fallback)
    N = rows.shape[0]
    return nbytes + N * p.d * 4 + (N * p.d * 4 if fallback else 0), ops


# -------------------------------------------------------------- requests

def draw_requests(rng, vocabs, n: int, n_dense: int) -> dict:
    """Ids skewed toward each field's head (P(id < k) = (k/V)^(1/3)),
    dense features log-transformed counts (none, and no ``dense`` key, for
    a model without them), all from the seed."""
    v = np.asarray(vocabs)
    u = rng.random((n, len(vocabs)))
    sparse = np.minimum((u ** 3 * v).astype(np.int64), v - 1)
    out = {"sparse": sparse.astype(np.int32)}
    if n_dense:
        dense = np.log1p(rng.exponential(4.0, (n, n_dense)))
        out["dense"] = dense.astype(np.float32)
    return out


class DinDraw:
    """DIN batches drawn in bulk (``DINGenerator.batch`` makes B * L
    ``rng.choice`` calls in Python, ~6.5M at B = 65,536): DINGenerator's
    model (a latent intent cluster per sample, 80% of the history from it,
    the target from it half the time, the label whether it is, 10%
    flipped), with items skewed toward each cluster's head (P(rank < k) =
    (k/n)^(1/3)), so hot items make long runs in the pool's stream.  Item
    i's cluster is perm^-1(i) % K."""

    def __init__(self, n_items: int, hist_len: int, n_clusters: int = 50,
                 seed: int = SEED):
        rng = np.random.default_rng((seed, 0xD1D))
        self.perm = rng.permutation(n_items)
        self.cluster = np.empty(n_items, np.int64)
        self.cluster[self.perm] = np.arange(n_items) % n_clusters
        self.n_items, self.L, self.K, self.seed = (n_items, hist_len,
                                                   n_clusters, seed)

    def _items(self, rng, clusters):
        per = self.n_items // self.K
        rank = (rng.random(clusters.shape) ** 3 * per).astype(np.int64)
        return self.perm[clusters + self.K * rank].astype(np.int32)

    def batch(self, B: int, idx: int) -> dict:
        rng = np.random.default_rng((self.seed, idx, 0xD1))
        K, L = self.K, self.L
        z = rng.integers(0, K, B)
        own = rng.random((B, L)) < 0.8
        hist = self._items(rng, np.where(own, z[:, None],
                                         rng.integers(0, K, (B, L))))
        lengths = rng.integers(L // 4, L + 1, B)
        mask = np.arange(L)[None, :] < lengths[:, None]
        pos = rng.random(B) < 0.5
        target = self._items(rng, np.where(pos, z, rng.integers(0, K, B)))
        label = (self.cluster[target] == z).astype(np.float32)
        label = np.where(rng.random(B) < 0.1, 1 - label, label)
        return {"hist": hist, "hist_mask": mask, "target": target,
                "label": label.astype(np.float32)}


def request_drawer(cfg):
    """-> draw(rng, n): n requests for ``cfg``'s model, without labels."""
    if cfg.model == "din":
        din = DinDraw(cfg.embedding.vocab_sizes[0], cfg.hist_len)

        def draw(rng, n):
            b = din.batch(n, int(rng.integers(1 << 30)))
            b.pop("label")
            return b
        return draw
    return lambda rng, n: draw_requests(rng, cfg.embedding.vocab_sizes, n,
                                        cfg.n_dense)


def global_ids(torch, cfg, batch, dev):
    """[B, F] field-local ids -> [B*F] ids in the common-memory space."""
    ids = torch.from_numpy(batch["sparse"]).to(dev)
    offs = torch.as_tensor(cfg.embedding.table_offsets()[:-1],
                           dtype=torch.int32, device=dev)
    return (ids + offs[None, :]).reshape(-1).contiguous()


def batch_gids(torch, cfg, batch, dev):
    """Every id a forward looks up, in call order: DIN's history then its
    targets (one item table, offset 0), else the fields' global ids."""
    if cfg.model == "din":
        return torch.cat([torch.from_numpy(batch[k]).reshape(-1)
                          for k in ("hist", "target")]).to(dev)
    return global_ids(torch, cfg, batch, dev)


# ------------------------------------------------------------------ phases

def build_model(torch, dev, arch: str = "dlrm-rm2", mesh=None,
                kind: str = "lma", bufs: dict | None = None):
    """The model at full width from the seed with the ``kind`` embedding,
    and for lma its D' store planted and made very sparse, or ``bufs`` (a
    store already on the card for the same values: DCN-v2 takes
    dlrm-rm2's); other schemes' buffers are the caller's.  With a mesh,
    this rank's share: the pool's slab and the rows of the store padded to
    ``store_rows`` (length 0, empty sets)."""
    from repro_torch.configs import get_config
    from repro_torch.models.recsys import Recsys, linear_config

    cfg = get_config(arch).make_model(embedding_kind=kind)
    e = cfg.embedding
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = Recsys(cfg, gen, device=dev, mesh=mesh).eval()
    if bufs is not None:
        if bufs["store_sets"].shape != (e.total_vocab, e.lma.max_set):
            raise AssertionError("the D' store given does not fit "
                                 f"{cfg.name}")
        store_note = f"D' store {tuple(bufs['store_sets'].shape)} reused"
    elif e.lma is None:
        bufs, store_note = {}, "no D' store"
    else:
        bufs, store_note = plant_store(torch, e, mesh, dev)
    torch.cuda.synchronize()
    p = e.lma
    if p is None:
        pools = (f"{e.kind}: {e.param_count():,} parameters, d={e.dim}"
                 + (f", md_dims {e.md_dims}" if e.md_dims else ""))
    else:
        pools = (f"m={p.m} stripe={p.stripe} d={p.d} n_h={p.n_h} "
                 f"max_set={p.max_set} min_support={p.min_support}")
    if cfg.model == "xdeepfm":
        q = linear_config(cfg).lma
        pools += (f"; linear pool m={q.m} stripe={q.stripe} d={q.d}; CIN "
                  f"{cfg.cin_layers}, deep MLP {cfg.deep_mlp}")
    log(f"model: {arch}, {pools}; {store_note}; built in "
        f"{time.perf_counter() - t0:.1f} s")
    return cfg, model, bufs


def plant_store(torch, e, mesh, dev) -> tuple:
    """The D' store of ``e``'s values planted from the seed and made very
    sparse; with a mesh, this rank's rows.  -> (buffers, a note)."""
    from repro_torch.core.signatures import planted_dense_store
    from repro_torch.embed import make_buffers

    store = planted_dense_store(e.total_vocab, N_CLUSTERS,
                                max_set=e.lma.max_set, seed=SEED, device=dev)
    v = torch.arange(store.n_values, device=dev)
    zero, one = v % SPARSE_PERIOD == 0, v % SPARSE_PERIOD == 1
    store.sets[zero] = -1
    store.sets[one, 1:] = -1
    store.lengths[zero] = 0
    store.lengths[one] = 1
    note = (f"D' store {tuple(store.sets.shape)} int32 "
            f"({store.sets.numel() * 4 / 1e9:.2f} GB); very sparse share "
            f"{2 / SPARSE_PERIOD:.1%} of values (support 0: "
            f"1/{SPARSE_PERIOD}, support 1: 1/{SPARSE_PERIOD})")
    if mesh is None:
        return make_buffers(e, store), note
    # this rank's rows of the store padded to store_rows (the pad rows,
    # length 0 and empty sets, all on the last rank), cut before the
    # padding so that the whole store is never copied
    from repro_torch.dist.sharding import pad_rows, store_rows
    c = store_rows(store.n_values) // mesh.model
    lo = mesh.rank * c
    hi = min(lo + c, store.n_values)
    return {"store_sets": pad_rows(store.sets[lo:hi], c, -1),
            "store_lengths": pad_rows(store.lengths[lo:hi], c, 0)}, note


def kernel_inputs(torch, cfg, model, bufs, batch, dev):
    """Everything the three kernels see for one batch of requests."""
    gids = global_ids(torch, cfg, batch, dev)
    rows, support = cfg.table.scheme.fused_inputs(cfg.embedding, bufs, gids)
    with torch.inference_mode():
        feats = model.embedding["memory"][
            cfg.table.scheme.locations(cfg.embedding, bufs, gids).long()]
        bot = model.bot(torch.from_numpy(batch["dense"]).to(dev))
        allf = torch.cat([bot[:, None, :],
                          feats.reshape(-1, cfg.n_fields, cfg.embedding.dim)],
                         dim=1).contiguous()
    return gids, rows, support, allf


def check_kernels(torch, cfg, model, bufs, batch, dev) -> dict:
    from repro_torch.kernels.dot_interaction.kernel import dot_interaction_cuda
    from repro_torch.kernels.dot_interaction.ref import dot_interaction_ref
    from repro_torch.kernels.fused_embed import ops as fe
    from repro_torch.kernels.fused_embed.kernel import fused_lookup_cuda
    from repro_torch.kernels.fused_embed.ref import (fused_embed_bag_ref,
                                                     fused_lookup_ref)
    from repro_torch.kernels.lma_locations.kernel import lma_locations_cuda
    from repro_torch.kernels.lma_locations.ref import lma_locations_ref

    p = cfg.embedding.lma
    mem = model.embedding["memory"].detach()
    gids, rows, support, allf = kernel_inputs(torch, cfg, model, bufs, batch,
                                              dev)
    n_fb = int((support < p.min_support).sum())
    if n_fb == 0:
        raise AssertionError("the check batch holds no fallback rows")
    err = {"lma_locations": 0.0}
    with torch.inference_mode():
        for params in (dataclasses.replace(p, striped=False), p):
            got = lma_locations_cuda(params, rows)
            want = lma_locations_ref(params, rows)
            err["lma_locations"] = max(err["lma_locations"], float(
                (got.long() - want.long()).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(f"lma_locations differ (stripe "
                                     f"{params.stripe})")
            spec = fe.lma_spec(params)
            got = fused_lookup_cuda(spec, mem, gids, rows, support)
            want = fused_lookup_ref(spec, mem, gids, rows, support)
            if not torch.equal(got, want):
                raise AssertionError(f"fused lookup differs (stripe "
                                     f"{params.stripe})")
        B, F = batch["sparse"].shape
        gen = torch.Generator(device=dev).manual_seed(SEED + 1)
        w = torch.rand((B, F), generator=gen, device=dev)
        shaped = (gids.reshape(B, F), w, rows.reshape(B, F, -1),
                  support.reshape(B, F))
        spec = fe.lma_spec(p)
        bag = fused_lookup_cuda(spec, mem, shaped[0], shaped[2], shaped[3],
                                shaped[1])
        bag_want = fused_embed_bag_ref(spec, mem, *shaped)
        torch.testing.assert_close(bag, bag_want, rtol=1e-6, atol=1e-6)
        err["fused_embed"] = float((bag - bag_want).abs().max())
        z = dot_interaction_cuda(allf)
        z_want = dot_interaction_ref(allf)
        torch.testing.assert_close(z, z_want, rtol=1e-5, atol=1e-6)
        err["dot_interaction"] = float((z - z_want).abs().max())
    log(f"check at B={B} ({gids.numel()} values, {n_fb} fallback rows): "
        "locations bit-exact flat and striped; lookups bit-exact flat and "
        f"striped; bag max |err| {err['fused_embed']:.3g} (tol 1e-6); dot "
        f"max |err| {err['dot_interaction']:.3g} (rtol 1e-5)")
    return err


def plain_forward(torch, cfg, model, bufs, batch, dev):
    """The forward through the plain versions only: split lookups (a table
    scheme's own gathers), then the pairwise-product interaction (DLRM), the
    two-einsum CIN (xDeepFM), or the model's plain cross (DCN-v2) and
    attention (DIN) layers."""
    from repro_torch.embed import SPLIT
    from repro_torch.kernels.dot_interaction.ref import dot_interaction_ref

    e, scheme = cfg.embedding, cfg.table.scheme
    t = on_card(torch, batch, dev)

    def lookup(gids):
        return SPLIT.lookup(e, scheme, dict(model.embedding), bufs, gids)

    if cfg.model == "din":
        B, L = batch["hist"].shape
        return model.din_logits(lookup(t["hist"].reshape(-1)).reshape(B, L, -1),
                                lookup(t["target"]), t)
    if scheme.family == "table":
        feats = cfg.table.embed_fields(dict(model.embedding), bufs,
                                       t["sparse"])
    else:
        gids = global_ids(torch, cfg, batch, dev)
        feats = lookup(gids).reshape(-1, cfg.n_fields, e.dim)
        if cfg.model == "xdeepfm":
            return plain_xdeepfm(torch, cfg, model, bufs, gids, feats)
    if cfg.model == "dcn":
        return model.dcn_logits(feats, t)
    bot = model.bot(t["dense"])
    z = dot_interaction_ref(torch.cat([bot[:, None, :], feats], dim=1))
    return model.top(torch.cat([bot, z], dim=-1))[:, 0]


def plain_cin_inputs(torch, cfg, model, feats):
    """x0 [B, F, d] and the three layers' inputs xk through the plain CIN."""
    from repro_torch.kernels.cin.ref import cin_ref

    x0 = feats.reshape(-1, cfg.n_fields, cfg.embedding.dim).contiguous()
    xks, xk = [], x0
    for i in range(len(cfg.cin_layers)):
        xks.append(xk)
        xk = torch.relu(cin_ref(xk, x0, model.cin[f"layer_{i}"].detach())
                        ).contiguous()   # einsum may return a permuted view
    return x0, xks, xk


def plain_xdeepfm(torch, cfg, model, bufs, gids, feats):
    """xDeepFM's logits from the plain versions: the CIN's pools, the deep
    MLP and the linear table's split lookup, added as the model adds them."""
    from repro_torch.embed import SPLIT
    from repro_torch.models.recsys import linear_config

    x0, xks, last = plain_cin_inputs(torch, cfg, model, feats)
    pools = [xk.sum(dim=-1) for xk in xks[1:] + [last]]
    B = x0.shape[0]
    lin_cfg = linear_config(cfg)
    lin = SPLIT.lookup(lin_cfg, cfg.table.scheme, dict(model.linear), bufs,
                       gids)
    return (model.cin_out(torch.cat(pools, dim=-1))[:, 0]
            + model.deep(x0.reshape(B, -1))[:, 0]
            + lin.reshape(B, -1).sum(dim=-1))


def model_launches(cfg) -> dict:
    """The kernels one forward launches: the fused lookup once per lookup of
    a pool whose scheme has a fused spec (xDeepFM's two pools, DIN's history
    and target; none for a table scheme or freq), the dot interaction
    (DLRM) or the CIN's three layers (xDeepFM)."""
    out = {"dlrm": {"dot_interaction": 1}, "xdeepfm": {"cin": 3}}.get(
        cfg.model, {})
    scheme = cfg.table.scheme
    if scheme.family == "memory" and scheme.fused_spec(cfg.embedding):
        out = {**out, "fused_embed": 2 if cfg.model in ("xdeepfm", "din")
               else 1}
    return out


def serve(torch, cfg, model, bufs, dev, kernels, runs=SERVE_RUNS,
          label: str | None = None) -> tuple:
    from repro_torch.configs._recsys_common import RECSYS_SHAPE_TABLE
    from repro_torch.serve import BatchingScorer, model_score_fn, pad_buckets

    max_batch = RECSYS_SHAPE_TABLE["serve_p99"]["batch"]
    score = model_score_fn(model, bufs)
    draw = request_drawer(cfg)
    label = label or cfg.name
    served = []

    def score_fn(batch):
        t0 = time.perf_counter()
        out = score(batch)            # returns host numpy: the call is synced
        served.append((batch, out, time.perf_counter() - t0))
        return out

    rng = np.random.default_rng(SEED + 3)
    warm = draw(rng, max_batch)
    for b in pad_buckets(max_batch):    # first call of each bucket's shapes
        score_fn({k: v[:b] for k, v in warm.items()})
    warm_on_card = on_card(torch, warm, dev)
    with torch.inference_mode():
        fwd_ms = time_ms(torch, lambda: model(warm_on_card, bufs), 20)
    log(f"{label}: forward of a {max_batch}-request batch already on the "
        f"card: {fwd_ms:.3f} ms (host-launched)")
    for k in kernels.values():
        k.launches = 0
    served.clear()
    records = []
    for rate, n in runs:
        first = len(served)
        reqs = draw(rng, n)
        records.append(drive(BatchingScorer(score_fn, max_batch=max_batch,
                                            max_delay_ms=2.0), reqs, rate))
        records[-1]["device_call_ms"] = float(
            np.mean([s[2] for s in served[first:]]) * 1e3)
        log(f"{label}: served {{requests}} requests at an offered {{rate}} "
            "requests/s in {device_calls} device calls (mean batch "
            "{mean_batch:.1f}, max {max_batch}; {device_call_ms:.3f} ms per "
            "call); latency ms p50={p50:.3f} p99={p99:.3f}".format(
                **records[-1]))
    counts = {name: k.launches for name, k in kernels.items()}
    records.append({"forward_ms_b512": fwd_ms})
    calls = len(served)
    log(f"{label}: launches while serving ({calls} device calls): {counts}")
    per_call = model_launches(cfg)
    for name in counts:
        if counts[name] != per_call.get(name, 0) * calls:
            raise AssertionError(f"{label}: {name} launched {counts[name]} "
                                 f"times in {calls} device calls, not "
                                 f"{per_call.get(name, 0)} per call")
    # the largest batch served, against the plain versions
    batch, out, _ = max(served, key=lambda s: len(s[1]))
    with torch.inference_mode():
        want = plain_forward(torch, cfg, model, bufs, batch, dev).cpu().numpy()
    if out.shape != want.shape or not np.isfinite(out).all():
        raise AssertionError("served logits have the wrong shape")
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)
    log(f"{label}: served batch of {len(out)} vs plain versions: max |err| "
        f"{float(np.abs(out - want).max()):.3g} (tol 1e-4)")
    return counts, records, batch


def drive(scorer, reqs: dict, rate: float) -> dict:
    """Submit single requests open loop at ``rate`` per second, wait for
    every result; -> batching and latency statistics."""
    n = len(next(iter(reqs.values())))
    pending = []
    try:
        t0 = time.perf_counter()
        while len(pending) < n:
            # every 1 ms tick, submit what is due, then sleep: a client
            # that spun between arrivals would hold the GIL and starve the
            # scorer's worker thread
            due = min(n, int((time.perf_counter() - t0) * rate) + 1)
            for i in range(len(pending), due):
                pending.append(scorer.submit({k: v[i]
                                              for k, v in reqs.items()}))
            time.sleep(TICK_S)
        for p in pending:
            if not p.event.wait(60.0):
                raise TimeoutError("a request was not served")
            if p.error is not None:
                raise p.error
    finally:
        scorer.close()
    scores = np.asarray([p.result for p in pending])
    if not np.isfinite(scores).all():
        raise AssertionError("non-finite logits")
    lat = np.asarray([p.t_done - p.t_enqueue for p in pending]) * 1e3
    return {"rate": rate, "requests": scorer.n_requests,
            "device_calls": scorer.n_batches,
            "mean_batch": float(np.mean(scorer.batch_sizes)),
            "max_batch": int(np.max(scorer.batch_sizes)),
            "p50": float(np.percentile(lat, 50)),
            "p99": float(np.percentile(lat, 99)), "max_ms": float(lat.max())}


def split_lookup(torch, cfg, model, bufs, batch, dev, kernels) -> int:
    """The split lookup path over a served batch: the locations kernel,
    then a gather; equal to the fused lookup on every non-fallback row."""
    from repro_torch.kernels.fused_embed import ops as fe
    from repro_torch.kernels.lma_locations.ops import lma_gather

    p = cfg.embedding.lma
    mem = model.embedding["memory"].detach()
    gids = global_ids(torch, cfg, batch, dev)
    rows, support = cfg.table.scheme.fused_inputs(cfg.embedding, bufs, gids)
    for k in kernels.values():
        k.launches = 0
    with torch.inference_mode():
        split = lma_gather(p, mem, rows)
        n = kernels["lma_locations"].launches
        fused = fe.fused_lookup(fe.lma_spec(p), mem, gids, rows, support)
    if n == 0:
        raise AssertionError("lma_locations was not launched")
    dense = support >= p.min_support
    if not torch.equal(split[dense], fused[dense]):
        raise AssertionError("split and fused lookups differ")
    log(f"split lookup over {gids.numel()} served values: launches "
        f"lma_locations={n}; equal to the fused lookup on "
        f"{int(dense.sum())} non-fallback rows")
    return n


def measure(torch, cfg, model, bufs, dev) -> dict:
    from repro_torch.kernels.fused_embed import ops as fe
    from repro_torch.kernels.fused_embed.kernel import fused_lookup_cuda
    from repro_torch.kernels.fused_embed.ref import fused_lookup_ref
    from repro_torch.kernels.lma_locations.kernel import lma_locations_cuda
    from repro_torch.kernels.lma_locations.ref import lma_locations_ref

    p = cfg.embedding.lma
    spec = fe.lma_spec(p)
    mem = model.embedding["memory"].detach()
    res = {"lma_locations": {}, "fused_embed": {}}
    rng = np.random.default_rng(SEED + 4)
    for B in (512, 4096):
        batch = draw_requests(rng, cfg.embedding.vocab_sizes, B, cfg.n_dense)
        gids, rows, support, allf = kernel_inputs(torch, cfg, model, bufs,
                                                  batch, dev)
        iters = 50 if B == 512 else 10
        with torch.inference_mode():
            r = res["lma_locations"][B] = {}
            r["ms"] = graph_ms(torch, lambda: lma_locations_cuda(p, rows),
                               iters)
            r["plain_ms"] = time_ms(torch, lambda: lma_locations_ref(p, rows),
                                    2, warmup=1)
            r["bound_ms"], r["bound_by"] = bound(
                *lma_work(torch, p, rows, support, fallback=False),
                INT32_OP_PER_S)
            r["library_ms"] = None

            r = res["fused_embed"][B] = {}
            r["ms"] = graph_ms(torch, lambda: fused_lookup_cuda(
                spec, mem, gids, rows, support), iters)
            r["plain_ms"] = time_ms(torch, lambda: fused_lookup_ref(
                spec, mem, gids, rows, support), 2, warmup=1)
            r["bound_ms"], r["bound_by"] = bound(
                *lma_work(torch, p, rows, support, fallback=True),
                INT32_OP_PER_S)
            r["library_ms"] = None
        for name in res:
            r = res[name][B]
            log(f"  {name} B={B}: {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}), {r['bound_ms'] / r['ms']:.1%} of bound")
    return res


def dot_inputs(torch, cfg, model, bufs, B: int, rng, dev):
    """The interaction's input for B drawn requests, [B, 1 + 26, 64]: the
    bottom MLP's output beside the fused lookup's rows, as the model
    concatenates them."""
    from repro_torch.kernels.fused_embed import ops as fe
    from repro_torch.kernels.fused_embed.kernel import fused_lookup_cuda

    batch = draw_requests(rng, cfg.embedding.vocab_sizes, B, cfg.n_dense)
    gids = global_ids(torch, cfg, batch, dev)
    rows, support = cfg.table.scheme.fused_inputs(cfg.embedding, bufs, gids)
    with torch.inference_mode():
        feats = fused_lookup_cuda(fe.lma_spec(cfg.embedding.lma),
                                  model.embedding["memory"], gids, rows,
                                  support)
        bot = model.bot(torch.from_numpy(batch["dense"]).to(dev))
        return torch.cat([bot[:, None, :], feats.reshape(B, cfg.n_fields, -1)],
                         dim=1).contiguous()


def measure_dot(torch, cfg, model, bufs, dev) -> dict:
    """Row 3 at the served batches (16, about the 5K/s path's mean; 512,
    the largest) and at 4,096 and the training batch 65,536: checked against
    its plain version (the same bits on a second call), then timed by
    CUDA-graph replay beside its bound, its plain version and torch.bmm with
    the triangle's index, and traced by torch.profiler."""
    from repro_torch.kernels.dot_interaction.kernel import dot_interaction_cuda
    from repro_torch.kernels.dot_interaction.ref import (dot_interaction_ref,
                                                         tril_pairs)

    res = {}
    rng = np.random.default_rng(SEED + 9)
    for B in DOT_BATCHES:
        allf = dot_inputs(torch, cfg, model, bufs, B, rng, dev)
        _, F, d = allf.shape
        P = F * (F - 1) // 2
        ii, jj = tril_pairs(F, dev)
        chunks = allf.split(4096)    # the plain version's [B, P, d] operands

        def plain():
            return torch.cat([dot_interaction_ref(c) for c in chunks])

        r = res[B] = {}
        iters = 20 if B == 65536 else 200
        with torch.inference_mode():
            z = dot_interaction_cuda(allf)
            if not torch.equal(z, dot_interaction_cuda(allf)):
                raise AssertionError(f"dot_interaction B={B}: two calls "
                                     "gave different bits")
            want = plain()
            torch.testing.assert_close(z, want, rtol=1e-5, atol=1e-6)
            r["max_abs_err"] = float((z - want).abs().max())
            del z, want
            r["ms"] = graph_ms(torch, lambda: dot_interaction_cuda(allf),
                               iters)
            r["plain_ms"] = time_ms(torch, plain, 2 if B == 65536 else 20)
            r["library_ms"] = graph_ms(torch, lambda: torch.bmm(
                allf, allf.transpose(1, 2))[:, ii, jj], iters)
            r["bound_ms"], r["bound_by"] = bound(
                (B * F * d + B * P) * 4, 2 * B * P * d, FP32_FLOP_PER_S)
            r["profile_ms"] = profile_ms(
                torch, lambda: dot_interaction_cuda(allf))
        log(f"  dot_interaction B={B}: {r['ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"{r['bound_ms'] / r['ms']:.1%} of bound, plain "
            f"{r['plain_ms']:.3f} ms, torch.bmm + index "
            f"{r['library_ms']:.4f} ms; max |err| {r['max_abs_err']:.3g} "
            "(rtol 1e-5), the same bits twice; profiler "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in r["profile_ms"].items()))
        del allf, chunks
    return res


# -------------------------------------------------------------- training

def ctr_generator(cfg):
    """The port's CTR data at the model's (Criteo) vocabularies.  n_clusters
    must not exceed the smallest vocabulary (3): with more, the generator
    leaves empty cluster pools (the reference's launcher has the same
    limit)."""
    from repro_torch.data.synthetic_ctr import CTRGenerator, CTRSpec

    t0 = time.perf_counter()
    e = cfg.embedding
    gen = CTRGenerator(CTRSpec(n_fields=cfg.n_fields, n_dense=cfg.n_dense,
                               vocab_sizes=e.vocab_sizes, n_clusters=3,
                               value_dist="uniform", seed=SEED))
    log(f"CTR generator at {cfg.name}'s {cfg.n_fields} vocabularies "
        f"({cfg.n_dense} dense features, 3 clusters, uniform values) built "
        f"in {time.perf_counter() - t0:.1f} s")
    return gen


def on_card(torch, batch: dict, dev) -> dict:
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def real_step_grad(torch, cfg, model, bufs, batch, dev):
    """One B=65,536 step's forward and backward under the sparse capture:
    -> the pool's SparseGrad (bucketed), nothing applied."""
    from repro_torch.models.recsys import loss_fn
    from repro_torch.optim import sparse as sp

    with sp.capture() as cap:
        loss, _ = loss_fn(model, on_card(torch, batch, dev), bufs)
        loss.backward()
    grads = cap.grads({"memory": model.embedding["memory"]})
    for q in model.parameters():
        q.grad = None
    return grads["memory"]


def check_training_kernels(torch, cfg, model, bufs, check_batch, sg,
                           dev) -> dict:
    """Rows 4-7 against their plain versions at full width."""
    from repro_torch.kernels.fused_embed import ops as fe
    from repro_torch.kernels.fused_embed import ref as fref
    from repro_torch.kernels.fused_embed.kernel import (
        fused_locations_cuda, fused_scatter_add_cuda, fused_weight_grad_cuda)
    from repro_torch.kernels.sparse_update.kernel import sparse_adagrad_cuda
    from repro_torch.kernels.sparse_update.ref import sparse_adagrad_ref
    from repro_torch.optim.sparse import dedup_locations

    p = cfg.embedding.lma
    e = cfg.embedding
    mem = model.embedding["memory"].detach()
    gids = global_ids(torch, cfg, check_batch, dev)
    rows, support = cfg.table.scheme.fused_inputs(e, bufs, gids)
    n_fb = int((support < p.min_support).sum())
    if n_fb == 0:
        raise AssertionError("the check batch holds no fallback rows")
    err = {"fused_locations": 0}
    with torch.no_grad():
        cases = [(fe.lma_spec(dataclasses.replace(p, striped=False)), True),
                 (fe.lma_spec(p), True)]
        cases += [(fe.hashed_spec(kind, e.dim, e.budget, e.seed), False)
                  for kind in ("hashed_elem", "hashed_row")]
        for spec, lma in cases:
            inputs = (gids, rows, support) if lma else (gids,)
            got = fused_locations_cuda(spec, *inputs)
            want = fref.locations_ref(spec, *inputs)
            err["fused_locations"] = max(err["fused_locations"], int(
                (got.long() - want.long()).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(f"{spec.scheme} locations differ "
                                     f"(stripe {spec.stripe})")
        spec = fe.lma_spec(p)
        gen = torch.Generator(device=dev).manual_seed(SEED + 6)
        g = torch.randn((gids.numel(), p.d), generator=gen, device=dev) * 1e-3
        got = fused_scatter_add_cuda(spec, g, gids, rows, support)
        want = fref.scatter_add_ref(spec, g, gids, rows, support)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        err["fused_scatter_add"] = float((got - want).abs().max())
        B, F = check_batch["sparse"].shape
        bag = (gids.reshape(B, F), rows.reshape(B, F, -1),
               support.reshape(B, F))
        w = torch.rand((B, F), generator=gen, device=dev)
        gb = torch.randn((B, p.d), generator=gen, device=dev) * 1e-3
        got = fused_scatter_add_cuda(spec, gb, *bag, weights=w)
        want = fref.scatter_add_ref(spec, gb, *bag, weights=w)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        err["fused_scatter_add"] = max(err["fused_scatter_add"],
                                       float((got - want).abs().max()))
        got = fused_weight_grad_cuda(spec, mem, gb, *bag)
        if not torch.equal(got, fused_weight_grad_cuda(spec, mem, gb, *bag)):
            raise AssertionError("weight grad: two calls gave different "
                                 "bits")
        want = fref.weight_grad_ref(spec, mem, gb, *bag)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        err["fused_weight_grad"] = float((got - want).abs().max())
        del got, want

        # row 7: a unique sentinel-padded stream, then the real step's
        half = sg.indices.numel() // 16
        uniq = dedup_locations(sg.indices[:half], sg.values[:half], (p.m,))
        acc0 = torch.rand(p.m, generator=gen, device=dev) * 1e-6
        err["sparse_adagrad"] = 0.0
        exact = True
        for stream in (uniq, sg):
            acc_k, acc_p = acc0.clone(), acc0.clone()
            u_k = sparse_adagrad_cuda(stream.indices, stream.values, acc_k,
                                      lr=1e-2, unique=stream.unique)
            u_p, _ = sparse_adagrad_ref(stream.indices, stream.values, acc_p,
                                        lr=1e-2, unique=stream.unique)
            torch.testing.assert_close(u_k, u_p, rtol=1e-5, atol=1e-9)
            torch.testing.assert_close(acc_k, acc_p, rtol=1e-5, atol=1e-12)
            exact = exact and torch.equal(u_k, u_p) and torch.equal(acc_k,
                                                                    acc_p)
            err["sparse_adagrad"] = max(err["sparse_adagrad"],
                                        float((u_k - u_p).abs().max()),
                                        float((acc_k - acc_p).abs().max()))
            touched = torch.zeros(p.m, dtype=torch.bool, device=dev)
            touched[stream.indices[stream.indices < p.m].long()] = True
            if not torch.equal(acc_k[~touched].view(torch.int32),
                               acc0[~touched].view(torch.int32)):
                raise AssertionError("sparse Adagrad wrote untouched slots")
            del acc_k, acc_p, touched
        _, runs = torch.unique_consecutive(sg.indices, return_counts=True)
        K = sg.indices.numel()
        shares = ", ".join(
            f"{lo}-{hi}: {int(((runs >= lo) & (runs <= hi)).sum())} runs, "
            f"{float(runs[(runs >= lo) & (runs <= hi)].sum()) / K:.1%} of "
            "entries" for lo, hi in ((1, 32), (33, 64), (65, 256),
                                     (257, 1024), (1025, 1 << 30)))
    log(f"bucketed stream's run lengths (K={K}): {shares}")
    log(f"training kernels at B={B} ({gids.numel()} values, {n_fb} fallback "
        "rows): locations bit-exact (lma flat and striped, hashed_elem, "
        f"hashed_row); scatter-add max |err| {err['fused_scatter_add']:.3g} "
        f"and weight grad {err['fused_weight_grad']:.3g} (tol 1e-6, the same "
        "bits twice); sparse "
        f"Adagrad on K={uniq.indices.numel()} unique (sentinel-padded) and "
        f"K={sg.indices.numel()} bucketed entries ({runs.numel()} slots, "
        f"longest run {int(runs.max())}): max |err| "
        f"{err['sparse_adagrad']:.3g} (rtol 1e-5), bit-identical {exact}, "
        "untouched accumulator slots bit-unchanged")
    return err


def check_full_batch(torch, cfg, bufs, mem, batch, dev) -> dict:
    """Rows 2, 4 and 5 at the training shape, every id a training batch
    looks up, against their plain versions run over chunks of FULL_CHUNK
    values (one plain call over all of them needs tens of GB): lookups
    from the pool ``mem`` and locations bit-exact, dM within SUM_RTOL *
    sum |g| at every slot.  -> errors and the plain versions' summed
    device times."""
    from repro_torch.kernels.fused_embed import ops as fe
    from repro_torch.kernels.fused_embed import ref as fref
    from repro_torch.kernels.fused_embed.kernel import (fused_locations_cuda,
                                                        fused_lookup_cuda,
                                                        fused_scatter_add_cuda)

    p = cfg.embedding.lma
    spec = fe.lma_spec(p)
    gids = batch_gids(torch, cfg, batch, dev)
    rows, support = cfg.table.scheme.fused_inputs(cfg.embedding, bufs, gids)
    N = gids.numel()
    n_fb = int((support < p.min_support).sum())
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    g = torch.randn((N, p.d), generator=gen, device=dev) * 1e-3
    plain = {"fused_locations": 0.0, "fused_scatter_add": 0.0}
    loc_err = 0
    with torch.no_grad():
        loc = fused_locations_cuda(spec, gids, rows, support)
        dm = fused_scatter_add_cuda(spec, g, gids, rows, support)
        looked = fused_lookup_cuda(spec, mem, gids, rows, support)
        want, abs_sum = torch.zeros_like(dm), torch.zeros_like(dm)
        for a in range(0, N, FULL_CHUNK):
            part = (gids[a:a + FULL_CHUNK], rows[a:a + FULL_CHUNK],
                    support[a:a + FULL_CHUNK])
            g_part = g[a:a + FULL_CHUNK]
            want_loc, ms = events_ms(
                torch, lambda: fref.locations_ref(spec, *part))
            plain["fused_locations"] += ms
            loc_err = max(loc_err, int((loc[a:a + FULL_CHUNK].long()
                                        - want_loc.long()).abs().max()))
            if not torch.equal(looked[a:a + FULL_CHUNK],
                               mem[want_loc.long()]):
                raise AssertionError(f"lookup at d={p.d} differs from the "
                                     f"plain gather (values {a}..)")
            dm_part, ms = events_ms(
                torch, lambda: fref.scatter_add_ref(spec, g_part, *part))
            plain["fused_scatter_add"] += ms
            want += dm_part
            abs_sum.index_add_(0, want_loc.reshape(-1).long(),
                               g_part.abs().reshape(-1))
            del want_loc, dm_part
        if loc_err:
            raise AssertionError(f"locations at the training batch differ "
                                 f"(max |diff| {loc_err})")
        diff = (dm - want).abs()
        ratio = float((diff / abs_sum.clamp_min(1e-30)).max())
        if bool((diff > SUM_RTOL * abs_sum).any()):
            raise AssertionError(f"scatter-add at the training batch: max "
                                 f"|err| / sum |g| {ratio:.3g} > {SUM_RTOL}")
        out = {"fused_locations": loc_err,
               "fused_scatter_add": float(diff.max()), "ratio": ratio,
               "plain_ms": plain, "slots": int((abs_sum > 0).sum())}
    log(f"training kernels of {cfg.name} (d={p.d}, m={p.m}, stripe "
        f"{p.stripe}) over a training batch's {N} values ({n_fb} fallback "
        f"rows, {out['slots']} slots touched): locations and lookups "
        f"bit-exact; scatter-add max |err| {out['fused_scatter_add']:.3g}, "
        f"max |err| / sum |g| {ratio:.3g} (tol {SUM_RTOL}); plain versions "
        f"over {-(-N // FULL_CHUNK)} chunks: locations "
        f"{plain['fused_locations']:.1f} ms, scatter-add "
        f"{plain['fused_scatter_add']:.1f} ms")
    return out


@contextlib.contextmanager
def raw_streams(torch, streams: dict):
    """While active, keep the raw contributions (element slots, values) of
    each pool whose lookups record no stripe buckets, by parameter name, as
    a sparse-gradient capture releases them (a row record's [N] rows become
    its [N, d] element slots): such a pool's SparseGrad is deduped
    (``optim.sparse.from_locations``) and holds each slot's sum, not its
    contributions, whose count and sum |g| ``check_step`` needs."""
    from repro_torch.optim import sparse as sp

    grads = sp.SparseCapture.grads

    def slots(r):
        if not r.row_width:
            return r.loc.reshape(-1)
        cols = torch.arange(r.row_width, device=r.loc.device)
        return (r.loc.long()[:, None] * r.row_width + cols).reshape(-1)

    def tapped(cap, named_params, gather=None):
        for name, p in named_params.items():
            recs = [r for r in cap.records
                    if r.memory is p and r.grad is not None]
            if recs and {r.n_buckets for r in recs} == {0}:
                if gather is not None:
                    raise AssertionError("raw_streams taps one-process or "
                                         "(1, P) captures only")
                streams[name] = (torch.cat([slots(r) for r in recs]),
                                 torch.cat([r.grad.reshape(-1)
                                            for r in recs]))
        return grads(cap, named_params, gather)

    sp.SparseCapture.grads = tapped
    try:
        yield streams
    finally:
        sp.SparseCapture.grads = grads


class Recorder:
    """An optimizer that keeps the gradients of the last update it made."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params):
        self.grads = grads
        return self.opt.update(grads, state, params)


def clone_state(torch, s):
    """A copy of an optimizer state (tensors, dicts, tuples, NamedTuples)."""
    if isinstance(s, torch.Tensor):
        return s.clone()
    if isinstance(s, dict):
        return {k: clone_state(torch, v) for k, v in s.items()}
    if isinstance(s, tuple):
        parts = [clone_state(torch, v) for v in s]
        return type(s)(*parts) if hasattr(s, "_fields") else tuple(parts)
    return s


def state_equal(torch, a, b) -> bool:
    """Bit-equal optimizer states (the same structure, equal tensors)."""
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(state_equal(torch, a[k], b[k])
                                            for k in a)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(state_equal(torch, x, y)
                                        for x, y in zip(a, b))
    return a == b


def pool_moments(torch, state) -> list:
    """A pool's moment tensors: Adagrad's accumulator or SGD's momentum
    (the state itself), or Adam's mu and nu."""
    return [state] if isinstance(state, torch.Tensor) else list(state[1:])


def lazy_hyper(arch, step: int) -> dict:
    """The sparse optimizer's hyper-parameters as make_optimizer sets them,
    Adam's bias corrections at ``step``."""
    from repro_torch.optim.optimizers import bias_correction

    lr = arch.learning_rate
    if arch.optimizer == "sgd":
        return {"lr": lr, "momentum": MOMENTUM}
    return {"lr": lr, "b1": ADAM_B1, "b2": ADAM_B2, "eps": ADAM_EPS,
            "bc1": bias_correction(ADAM_B1, step),
            "bc2": bias_correction(ADAM_B2, step)}


def check_step(torch, n, p0, st0, dense_p, params, states, opts, arch,
               parity, streams) -> None:
    """One step taken both ways from (p0, st0), held to each other:
    - outside the pools the two paths had the same gradients, so the
      parameters and optimizer states are bit-identical;
    - for every pool the sparse path updated (a SparseGrad): the dense pool
      gradient is 0 off the touched slots, and at each touched slot the
      sparse path's folded sum (the sparse kernels' order, which
      ``fold_duplicates`` reproduces bit for bit) is within ``sum_tol`` of
      the dense path's (``check_pool`` then holds each path to the update
      of its own sums).
    So the paths differ only by the rounding of the slot sums; a model
    without a pool (a table scheme) takes the same step both ways, bit for
    bit.  ``st0``
    holds each pool's optimizer state before the step; ``streams`` the raw
    contributions of each deduped SparseGrad (``raw_streams``); ``parity``
    gathers one record per pool."""
    from repro_torch.optim.sparse import is_sparse

    gs, gd = opts["sparse"].grads, opts["dense"].grads
    pools = sorted(k for k, g in gs.items() if is_sparse(g))
    if set(pools) != set(st0) or set(gs) != set(gd):
        raise AssertionError(f"step {n}: sparse pools {pools}, expected "
                             f"{sorted(st0)}")
    for k, q in params.items():
        if k not in pools and not (torch.equal(gs[k], gd[k])
                                   and torch.equal(q, dense_p[k])
                                   and state_equal(torch, states["sparse"][k],
                                                   states["dense"][k])):
            raise AssertionError(
                f"step {n}: {k} differs between the paths (|grad diff| "
                f"{float((gs[k] - gd[k]).abs().max()):.3g})")
    for pool in pools:
        check_pool(torch, n, pool, p0[pool], st0[pool], dense_p[pool],
                   params[pool].detach(), states, gs[pool], gd[pool], arch,
                   parity.setdefault(pool, {"max_pool_param_diff": 0.0,
                                            "max_sum_ratio": 0.0,
                                            "max_tol_share": 0.0}),
                   streams)


def element_stream(torch, sg, m: int):
    """A SparseGrad's live entries as element slots of the flat [m] pool:
    (slots [k] sorted, values [k]); a row-mode gradient's rows expand to
    their d columns."""
    keep = sg.indices < sg.dense_shape[0]
    idx, vals = sg.indices[keep], sg.values[keep]
    if vals.dim() == 2:
        d = vals.shape[1]
        cols = torch.arange(d, device=idx.device)
        idx = (idx.long()[:, None] * d + cols).reshape(-1).to(torch.int32)
        vals = vals.reshape(-1)
    return idx, vals


def check_pool(torch, n, pool, q0_all, st0, dense_q, sparse_q, states, sg,
               g_dense, arch, parity, streams) -> None:
    """``check_step``'s rules for one pool.  The sparse path's slot sum is
    the fold of a bucketed SparseGrad (pairwise, as the sparse kernels add)
    or the sum of a deduped one (``index_add_``, sequential); the run length
    and sum |g| of a slot come from the raw contributions.  Then each path
    is held to the update of its own sums (``adagrad_rule`` /
    ``lazy_rule``).  Logs each path's largest error against the float64 sum
    (a share of sum |g|, where that is a normal float32), and, for the
    elements that differ most, both sums, sum |g|, the run length and the
    state before the step."""
    from repro_torch.kernels.sparse_update.ref import fold_duplicates

    m = g_dense.numel()
    idx, vals = element_stream(torch, sg, m)
    head, folded = fold_duplicates(idx, vals)
    slots = idx[head].long()
    s = {"sparse": folded[head], "dense": g_dense[slots]}
    del head, folded
    raw_loc, raw = streams[pool] if sg.unique else (idx, vals)
    raw_loc = raw_loc.long()
    run = torch.zeros(m, dtype=torch.int64, device=slots.device).index_add_(
        0, raw_loc, torch.ones_like(raw_loc))[slots]
    abs_sum, exact = (torch.zeros(m, dtype=torch.float64, device=slots.device)
                      .index_add_(0, raw_loc, v)[slots]
                      for v in (raw.abs().double(), raw.double()))
    del idx, vals, raw_loc, raw
    touched = torch.zeros(m, dtype=torch.bool, device=slots.device)
    touched[slots] = True
    if bool((g_dense[~touched] != 0).any()):
        raise AssertionError(f"step {n}: the dense {pool} gradient is not 0 "
                             "off the touched slots")
    ds = (s["sparse"] - s["dense"]).abs().double()
    tol = sum_tol(run.double(), abs_sum, pairwise=not sg.unique)
    ratio = float((ds / abs_sum.clamp_min(1e-30)).max())
    share = float((ds / tol.clamp_min(1e-30)).max())
    if share > 1:
        raise AssertionError(f"step {n}: {pool}: sparse and dense slot sums "
                             f"differ: max |diff| / sum_tol {share:.3g}")
    pools = {"sparse": sparse_q, "dense": dense_q}
    if arch.optimizer == "adagrad":
        adagrad_rule(torch, n, pool, arch, q0_all, st0, pools, states, slots,
                     touched, s)
    else:
        parity["dense_untouched_moved"] = max(
            parity.get("dense_untouched_moved", 0),
            lazy_rule(torch, n, pool, arch, sg, q0_all, st0, pools, states,
                      slots, touched, s))
    moment0 = pool_moments(torch, st0)[-1][slots]
    dp = (pools["sparse"][slots] - pools["dense"][slots]).abs()
    worst = [{"slot": int(slots[i]), "s_sparse": float(s["sparse"][i]),
              "s_dense": float(s["dense"][i]), "sum_abs": float(abs_sum[i]),
              "run": int(run[i]), "state0": float(moment0[i]),
              "param_diff": float(dp[i])}
             for i in torch.topk(dp, min(3, dp.numel())).indices.tolist()]
    if float(dp.max()) >= parity["max_pool_param_diff"]:
        parity["max_pool_param_diff"], parity["worst"] = float(dp.max()), worst
    parity["max_sum_ratio"] = max(parity["max_sum_ratio"], ratio)
    parity["max_tol_share"] = max(parity["max_tol_share"], share)
    # each path's error against the float64 sum, over the slots whose sum
    # |g| is a normal float32 (atomic adds flush subnormal sums to 0)
    normal = abs_sum >= FLT_MIN
    zero = torch.zeros(1, dtype=torch.float64, device=slots.device)
    off = {name: float(torch.cat([zero, ((s[name].double() - exact).abs()
                                         / abs_sum.clamp_min(1e-300))[normal]
                                  ]).max()) for name in s}
    at = int(torch.argmax(ds / abs_sum.clamp_min(1e-300)))
    for name in s:
        parity[f"max_{name}_err"] = max(parity.get(f"max_{name}_err", 0.0),
                                        off[name])
    log(f"  step {n} {pool}: {slots.numel()} slots, max |s diff| / sum |g| "
        f"{ratio:.3g} (slot {int(slots[at])}, run {int(run[at])}, sum |g| "
        f"{float(abs_sum[at]):.3g}, sum {float(exact[at]):.4g}), "
        f"{share:.3g} of sum_tol; max |s - float64 sum| / sum |g|: sparse "
        f"{off['sparse']:.3g}, dense {off['dense']:.3g}; max |param diff| "
        f"{float(dp.max()):.3g}"
        + (f"; {parity['dense_untouched_moved']} untouched slots moved on "
           "the dense path" if arch.optimizer != "adagrad" else "")
        + " at: " + "; ".join(
            f"slot {w['slot']} s {w['s_sparse']:.4g} / {w['s_dense']:.4g}, "
            f"sum |g| {w['sum_abs']:.3g}, run {w['run']}, state0 "
            f"{w['state0']:.3g}, diff {w['param_diff']:.3g}" for w in worst))


def adagrad_rule(torch, n, pool, arch, q0_all, acc0, pools, states, slots,
                 touched, s, names=("sparse", "dense")) -> None:
    """Adagrad is lazy and exact alike (a zero gradient moves nothing), so
    each path's pool and accumulator are exactly Adagrad of its own slot
    sums from (q0, acc0), and untouched slots are unchanged on both."""
    from repro_torch.kernels.sparse_update.ref import ieee_sqrt

    a0, q0 = acc0[slots], q0_all[slots]
    for name in names:
        a = a0 + s[name] * s[name]
        want = q0 + -arch.learning_rate * s[name] / (ieee_sqrt(a)
                                                     + ADAGRAD_EPS)
        got, acc = pools[name], states[name][pool]
        if not (torch.equal(got[slots], want) and torch.equal(acc[slots], a)
                and torch.equal(got[~touched], q0_all[~touched])
                and torch.equal(acc[~touched], acc0[~touched])):
            raise AssertionError(
                f"step {n}: the {name} {pool} is not Adagrad of its own slot "
                f"sums (max |diff| "
                f"{float((got[slots] - want).abs().max()):.3g})")


def lazy_rule(torch, n, pool, arch, sg, q0_all, st0, pools, states, slots,
              touched, s) -> int:
    """Momentum SGD and Adam: the dense path is not lazy (an untouched slot
    with a momentum or moment moves there), the sparse path is.
    - The sparse path's pool and moments equal the plain lazy optimizer
      (``sparse_sgd_ref`` / ``sparse_adam_ref``) applied to the same
      SparseGrad from (q0, st0), over all m slots, bit for bit; untouched
      slots keep their bits.
    - The dense path's pool at the touched slots equals that same lazy
      update driven by the dense slot sums, bit for bit (so the pools differ
      only through the sums, within ``sum_tol``); its moments and the rest
      of its pool are exactly the dense formula of its gradient, 0 off the
      touched slots.
    -> how many untouched slots moved on the dense path."""
    from repro_torch.kernels.sparse_update import ref as sref

    algo, lr = arch.optimizer, arch.learning_rate
    plain = {"sgd": sref.sparse_sgd_ref, "adam": sref.sparse_adam_ref}[algo]
    hyper = lazy_hyper(arch, n)
    t0 = pool_moments(torch, st0)
    shape = sg.dense_shape
    q, t = q0_all.clone(), [x.clone() for x in t0]
    u, _ = plain(sg.indices, sg.values, *(x.view(shape) for x in t),
                 unique=sg.unique, **hyper)
    keep = sg.indices < shape[0]
    q.view(shape).index_add_(0, sg.indices[keep].long(), u[keep])
    got_t = pool_moments(torch, states["sparse"][pool])
    if not (torch.equal(pools["sparse"], q)
            and all(torch.equal(a, b) for a, b in zip(got_t, t))):
        diffs = "; ".join(
            f"{what}: {int((a != b).sum())} elements differ ("
            f"{int((a != b)[touched].sum())} touched), max |diff| "
            f"{float((a - b).abs().max()):.3g}"
            for what, a, b in zip(("pool", "moment 1", "moment 2"),
                                  [pools["sparse"]] + got_t, [q] + t))
        raise AssertionError(f"step {n}: the sparse {pool} is not the plain "
                             f"lazy {algo} of its SparseGrad: {diffs}")
    if not (torch.equal(pools["sparse"][~touched], q0_all[~touched])
            and all(torch.equal(a[~touched], b[~touched])
                    for a, b in zip(got_t, t0))):
        raise AssertionError(f"step {n}: sparse {algo} moved untouched "
                             f"{pool} slots")
    del q, t, u
    ar = torch.arange(slots.numel(), dtype=torch.int32, device=slots.device)
    u, _ = plain(ar, s["dense"], *(x[slots].clone() for x in t0),
                 unique=True, **hyper)
    if not torch.equal(pools["dense"][slots], q0_all[slots] + u):
        raise AssertionError(f"step {n}: the dense {pool} at its touched "
                             f"slots is not the lazy {algo} of its sums")
    g = torch.zeros_like(q0_all)
    g[slots] = s["dense"]
    if algo == "sgd":
        mo = MOMENTUM * t0[0] + g
        want, want_t = q0_all + -lr * mo, [mo]
    else:
        mu = ADAM_B1 * t0[0] + (1 - ADAM_B1) * g
        nu = ADAM_B2 * t0[1] + (1 - ADAM_B2) * (g * g)
        want = q0_all + (-lr * sref.div(mu, hyper["bc1"])
                         / (sref.ieee_sqrt(sref.div(nu, hyper["bc2"]))
                            + ADAM_EPS))
        want_t = [mu, nu]
    if not (torch.equal(pools["dense"], want)
            and all(torch.equal(a, b) for a, b in zip(
                pool_moments(torch, states["dense"][pool]), want_t))):
        raise AssertionError(f"step {n}: the dense {pool} is not dense "
                             f"{algo} of its gradient")
    return int((pools["dense"][~touched] != q0_all[~touched]).sum())


SPARSE_KERNEL = {"adagrad": "sparse_adagrad", "sgd": "sparse_sgd",
                 "adam": "sparse_adam"}


def step_launches(cfg, optimizer: str, path: str) -> dict:
    """The kernels one training step of ``path`` launches, by name: the
    forward's (``model_launches``), then for each pool lookup through the
    fused kernel its gradient: sparse, the locations kernel (none when a
    row-aligned scheme records rows) and once per pool the sparse
    optimizer's kernel (a pool without a fused spec too); dense, the
    scatter-add.  A table scheme has no pool and launches no more."""
    out = dict(model_launches(cfg))
    scheme, e = cfg.table.scheme, cfg.embedding
    if scheme.family != "memory":
        return out
    lookups = out.get("fused_embed", 0)
    if path == "dense":
        if lookups:
            out["fused_scatter_add"] = lookups
        return out
    out[SPARSE_KERNEL[optimizer]] = 2 if cfg.model == "xdeepfm" else 1
    if lookups and not (scheme.row_aligned
                        and scheme.memory_slots(e) % e.dim == 0):
        out["fused_locations"] = lookups
    return out


def train_full_width(torch, arch_id, cfg, model, bufs, gen, B, dev,
                     kernels, optimizer: str | None = None,
                     steps: int = TRAIN_STEPS, per_step: dict | None = None,
                     localize=None, tag: str = "") -> dict:
    """``steps`` steps of B examples through the port's Trainer with
    sparse pool gradients and the arch's optimizer (or ``optimizer``, as
    ``dataclasses.replace(arch, optimizer=...)`` gives it to
    make_optimizer); before each, the same step densely (a second Trainer
    with sparse_grads=False) from the same parameters and optimizer state,
    and the two results held to each other (``check_step``).  Each run must
    launch exactly ``step_launches`` (or ``per_step[path]``) per step.  On a
    rank of a sharded pool, ``localize(grads)`` cuts the sparse path's
    SparseGrads to the rank's slab before the check.  -> launches per run,
    throughput, phase split, parity."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import lookups_per_step, make_optimizer
    from repro_torch.models.recsys import loss_fn
    from repro_torch.optim.sparse import has_memory
    from repro_torch.train.trainer import Trainer, TrainerConfig

    arch = get_config(arch_id)
    if optimizer is not None:
        arch = dataclasses.replace(arch, optimizer=optimizer)
    label = f"{arch_id} ({cfg.embedding.kind}, {arch.optimizer}){tag}"
    params = dict(model.named_parameters())
    pools = [k for k in params if has_memory({k: None})]
    timers, trainers, opts, runs = {}, {}, {}, {}
    for name in ("sparse", "dense"):
        timers[name] = PhaseTimer(torch)
        opts[name] = Recorder(make_optimizer(arch))
        trainers[name] = Trainer(
            TrainerConfig(total_steps=0, log_every=0,
                          lookups_per_step=lookups_per_step(cfg, B)),
            lambda m, b: loss_fn(m, b, bufs), model, opts[name],
            lambda step: gen.batch(B, step), sparse_grads=name == "sparse",
            on_phase=timers[name].mark, device=dev)
        runs[name] = {"losses": [], "peak_gib": 0.0, "held_gib": 0.0,
                      "launches": dict.fromkeys(kernels, 0)}
    sparse_tr, dense_tr = trainers["sparse"], trainers["dense"]
    parity = {}

    def step(name, n):
        tr, r = trainers[name], runs[name]
        tr.step, tr.cfg.total_steps = n - 1, n
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        r["held_gib"] = max(r["held_gib"],
                            torch.cuda.memory_allocated() / 2**30)
        before = {k: f.launches for k, f in kernels.items()}
        r["losses"].append(tr.fit(log=lambda _: None)["loss"])
        for k, f in kernels.items():
            r["launches"][k] += f.launches - before[k]
        r["peak_gib"] = max(r["peak_gib"],
                            torch.cuda.max_memory_allocated() / 2**30)

    for k in kernels.values():
        k.launches = 0
    for n in range(1, steps + 1):
        with torch.no_grad():
            p0 = {k: q.detach().clone() for k, q in params.items()}
            st0 = {k: clone_state(torch, sparse_tr.opt_state[k])
                   for k in pools}
            dense_tr.opt_state = clone_state(torch, sparse_tr.opt_state)
        step("dense", n)
        with torch.no_grad():
            p_dense = {k: q.detach().clone() for k, q in params.items()}
            for k, q in params.items():
                q.copy_(p0[k])
        with raw_streams(torch, {}) as streams:
            step("sparse", n)
        for k in pools:
            if params[k].grad is not None:
                raise AssertionError(f"{k} has a dense .grad on the sparse "
                                     "path")
        states = {"sparse": sparse_tr.opt_state, "dense": dense_tr.opt_state}
        if localize is not None:
            opts["sparse"].grads = localize(opts["sparse"].grads)
        with torch.no_grad():
            check_step(torch, n, p0, st0, p_dense, params, states, opts,
                       arch, parity, streams)
        opts["sparse"].grads = opts["dense"].grads = None
        del p0, st0, p_dense, streams
    counts = {n: k.launches for n, k in kernels.items()}
    for name, tr in trainers.items():
        r = runs[name]
        r.update(tr.throughput())
        r["phase_ms"] = timers[name].split_ms()
        r["end_to_end_steps_per_sec"] = 1.0 / (1.0 / r["steps_per_sec"]
                                               + r["batch_sec"])
        if not np.isfinite(r["losses"]).all():
            raise AssertionError(f"{name}: non-finite loss {r['losses']}")
        log(f"train {label} {name}: B={B}, {steps} steps, losses "
            + " ".join(f"{x:.5f}" for x in r["losses"])
            + f"; {r['steps_per_sec']:.2f} steps/s, "
            f"{r['lookups_per_sec']:,.0f} lookups/s; phases (ms, median) "
            + ", ".join(f"{k} {v:.2f}" for k, v in r["phase_ms"].items())
            + f"; host batch {r['batch_sec'] * 1e3:.1f} ms, with it "
            f"{r['end_to_end_steps_per_sec']:.2f} steps/s end to end; peak "
            f"{r['peak_gib']:.2f} GiB ({r['held_gib']:.2f} GiB held at the "
            f"step's start, the check's copies included); launches "
            f"{r['launches']}")
    np.testing.assert_allclose(runs["sparse"]["losses"],
                               runs["dense"]["losses"], rtol=1e-6)
    runs["parity"] = parity
    runs["launches"] = counts
    rule = ("the pool exactly Adagrad of its own sums"
            if arch.optimizer == "adagrad" else
            f"the sparse pool exactly the plain lazy {arch.optimizer} of its "
            "SparseGrad, untouched slots bit-unchanged; the dense pool "
            "exactly the same update of its own sums at the touched slots")
    if not pools:
        log(f"sparse vs dense {label}: no pool, so the two trainers took the "
            "same steps: parameters and optimizer states bit-identical after "
            "every step")
    for pool, par in parity.items():
        w = par["worst"][0]
        log(f"sparse vs dense {label} {pool}, each step from the same state: "
            f"non-pool parameters and optimizer states bit-identical; slot "
            f"sums within {par['max_sum_ratio']:.3g} of sum |g|, "
            f"{par['max_tol_share']:.3g} of sum_tol (against the float64 "
            f"sum: sparse {par['max_sparse_err']:.3g}, dense "
            f"{par['max_dense_err']:.3g}); {rule}; max |param diff| "
            f"{par['max_pool_param_diff']:.3g} (worst slot {w['slot']}: run "
            f"{w['run']}, sum |g| {w['sum_abs']:.3g}, s {w['s_sparse']:.4g} "
            f"/ {w['s_dense']:.4g}, state0 {w['state0']:.3g})"
            + (f"; up to {par['dense_untouched_moved']} untouched slots "
               "moved on the dense path in a step"
               if "dense_untouched_moved" in par else "")
            + "; losses within rtol 1e-6 (the same forward)")
    for name in ("sparse", "dense"):
        one = (step_launches(cfg, arch.optimizer, name) if per_step is None
               else per_step[name])
        got = runs[name]["launches"]
        want = {k: one.get(k, 0) * steps for k in got}
        if got != want:
            raise AssertionError(f"{label} {name} run launched {got}, "
                                 f"expected {want}")
    return runs


def launcher_comparison(torch, kernels) -> dict:
    """The port's run of examples/train_lma_dlrm.py through
    repro_torch.launch.train at an equal budget (alpha = 16): lma-dlrm-criteo
    with every registered kind but ``full``, lma-dlrm-avazu with lma and
    hashed_elem; the eval AUC of each."""
    from repro_torch.embed import list_schemes
    from repro_torch.launch import train as launcher

    kinds = [k for k in list_schemes() if k != "full"]
    out = {"lma-dlrm-criteo": {}, "lma-dlrm-avazu": {}}
    for arch, kind in ([("lma-dlrm-criteo", k) for k in kinds]
                       + [("lma-dlrm-avazu", k)
                          for k in ("lma", "hashed_elem")]):
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        res = launcher.main(["--arch", arch, "--embedding-kind", kind,
                             "--steps", str(LAUNCHER_STEPS), "--batch",
                             str(LAUNCHER_BATCH), "--device", "cuda"])
        out[arch][kind] = {
            "auc": res["eval"]["auc"],
            "steps_per_sec": res["train"]["steps_per_sec"],
            "seconds": time.perf_counter() - t0,
            "launches": {n: k.launches for n, k in kernels.items()
                         if k.launches}}
        if not np.isfinite(res["train"]["loss"]):
            raise AssertionError(f"launcher {arch} {kind}: non-finite loss")
    for arch, runs in out.items():
        runs["auc_gap_lma_hashed_elem"] = (runs["lma"]["auc"]
                                           - runs["hashed_elem"]["auc"])
        log(f"launcher {arch}, {LAUNCHER_STEPS} steps at B={LAUNCHER_BATCH}: "
            "eval AUC " + ", ".join(
                f"{k} {r['auc']:.4f} ({r['steps_per_sec']:.0f} steps/s)"
                for k, r in runs.items() if isinstance(r, dict))
            + f"; lma - hashed_elem {runs['auc_gap_lma_hashed_elem']:+.4f}; "
            f"launches (lma) {runs['lma']['launches']}")
    return out


def bag_backward(torch, cfg, model, bufs, dev, kernels) -> tuple:
    """embed_bag on the full pool with weights that need a gradient: the
    backward launches the scatter-add and weight-gradient kernels; dM and dw
    against the plain versions."""
    from repro_torch.kernels.fused_embed import ops as fe
    from repro_torch.kernels.fused_embed import ref as fref

    p = cfg.embedding.lma
    mem = model.embedding["memory"]
    rng = np.random.default_rng(SEED + 7)
    B, L = 512, 26
    ids = torch.from_numpy(rng.integers(0, cfg.embedding.vocab_sizes[0],
                                        (B, L)).astype(np.int32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    w = torch.rand((B, L), generator=gen, device=dev).requires_grad_()
    g = torch.randn((B, p.d), generator=gen, device=dev) * 1e-3
    mem.grad = None
    for k in kernels.values():
        k.launches = 0
    out = cfg.table.embed_bag(dict(model.embedding), bufs, 0, ids, w)
    out.backward(g)
    counts = {n: k.launches for n, k in kernels.items()}
    for name in ("fused_embed", "fused_scatter_add", "fused_weight_grad"):
        if counts[name] != 1:
            raise AssertionError(f"bag backward: {name} launched "
                                 f"{counts[name]} times")
    with torch.no_grad():
        rows, support = cfg.table.scheme.fused_inputs(cfg.embedding, bufs,
                                                      ids.reshape(-1))
        shaped = (ids, rows.reshape(B, L, -1), support.reshape(B, L))
        spec = fe.lma_spec(p)
        dm = fref.scatter_add_ref(spec, g, *shaped, weights=w.detach())
        dw = fref.weight_grad_ref(spec, mem.detach(), g, *shaped)
        torch.testing.assert_close(mem.grad, dm, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(w.grad, dw, rtol=1e-6, atol=1e-6)
        err = {"scatter": float((mem.grad - dm).abs().max()),
               "weights": float((w.grad - dw).abs().max())}
    mem.grad = None
    log(f"bag backward on the full pool (B={B}, L={L}): launches {counts}; "
        f"dM max |err| {err['scatter']:.3g}, dw max |err| "
        f"{err['weights']:.3g} (tol 1e-6)")
    return counts, err


def measure_training(torch, cfg, model, bufs, gen, train_batch, plain_full,
                     sg, dev) -> dict:
    """Rows 4-7 timed by CUDA-graph replay beside their bounds, plain
    versions and (row 7) the library's sparse Adagrad.  At B=65,536 (the
    training batch of phase 7) the plain times are phase 7's chunked
    runs."""
    from repro_torch.kernels.fused_embed import ops as fe
    from repro_torch.kernels.fused_embed import ref as fref
    from repro_torch.kernels.fused_embed.kernel import (
        fused_locations_cuda, fused_scatter_add_cuda, fused_weight_grad_cuda)
    from repro_torch.kernels.sparse_update.kernel import sparse_adagrad_cuda
    from repro_torch.kernels.sparse_update.ref import sparse_adagrad_ref

    p = cfg.embedding.lma
    spec = fe.lma_spec(p)
    mem = model.embedding["memory"].detach()
    res = {"fused_locations": {}, "fused_scatter_add": {},
           "fused_weight_grad": {}}
    for B in (4096, 65536):
        batch = train_batch if B == 65536 else gen.batch(B, 900_000 + B)
        gids = global_ids(torch, cfg, batch, dev)
        rows, support = cfg.table.scheme.fused_inputs(cfg.embedding, bufs,
                                                      gids)
        N = gids.numel()
        g = torch.randn((N, p.d), device=dev) * 1e-3
        in_bytes, ops = hash_work(torch, p, rows, support)
        iters = 10 if B == 4096 else 3
        small = B == 4096
        with torch.no_grad():
            r = res["fused_locations"][B] = {}
            r["ms"] = graph_ms(torch, lambda: fused_locations_cuda(
                spec, gids, rows, support), iters)
            r["plain_ms"] = time_ms(torch, lambda: fref.locations_ref(
                spec, gids, rows, support), 2, warmup=1) if small \
                else plain_full["fused_locations"]
            r["bound_ms"], r["bound_by"] = bound(in_bytes + N * p.d * 4, ops,
                                                 INT32_OP_PER_S)
            r["library_ms"] = None
            r = res["fused_scatter_add"][B] = {}
            r["ms"] = graph_ms(torch, lambda: fused_scatter_add_cuda(
                spec, g, gids, rows, support), iters // 2 + 1)
            r["plain_ms"] = time_ms(torch, lambda: fref.scatter_add_ref(
                spec, g, gids, rows, support), 2, warmup=1) if small \
                else plain_full["fused_scatter_add"]
            r["bound_ms"], r["bound_by"] = bound(
                in_bytes + N * p.d * 4 + N * p.d * 8 + p.m * 4, ops,
                INT32_OP_PER_S)
            r["library_ms"] = None
            r["fill_ms"] = fill_ms(torch, p.m, dev, iters)
            r["kernel_fill_ms"] = kernel_fill_ms(torch, spec, g, gids, rows,
                                                 support, iters)
            r.update(scatter_launch(torch, rows.shape[-1]))
            if small:
                F = cfg.n_fields
                bag = (gids.reshape(B, F), rows.reshape(B, F, -1),
                       support.reshape(B, F))
                gb = g[:B]
                r = res["fused_weight_grad"][B] = {}
                r["ms"] = graph_ms(torch, lambda: fused_weight_grad_cuda(
                    spec, mem, gb, *bag), iters)
                r["plain_ms"] = time_ms(torch, lambda: fref.weight_grad_ref(
                    spec, mem, gb, *bag), 2, warmup=1)
                r["bound_ms"], r["bound_by"] = bound(
                    in_bytes + B * p.d * 4 + N * p.d * 4 + N * 4,
                    ops + 2 * N * p.d, INT32_OP_PER_S)
                r["library_ms"] = None
                r["profile_ms"] = profile_ms(torch, lambda: (
                    fused_weight_grad_cuda(spec, mem, gb, *bag)))
        del g
    K = sg.indices.numel()
    heads = int(torch.unique_consecutive(sg.indices).numel())
    acc = torch.zeros(p.m, device=dev)
    r = res["sparse_adagrad"] = {}
    r["ms"] = graph_ms(torch, lambda: sparse_adagrad_cuda(
        sg.indices, sg.values, acc, lr=1e-2, unique=False), 5)
    r["plain_ms"] = time_ms(torch, lambda: sparse_adagrad_ref(
        sg.indices, sg.values, acc, lr=1e-2, unique=False), 2, warmup=1)
    r["bound_ms"], r["bound_by"] = bound(12 * K + 8 * heads, 0, 1.0)
    r["library_ms"] = library_sparse_ms(torch, torch.optim.Adagrad, sg,
                                        (p.m,), dev, lr=1e-2, eps=1e-10)
    r["passes_ms"] = profile_ms(torch, lambda: sparse_adagrad_cuda(
        sg.indices, sg.values, acc, lr=1e-2, unique=False))
    r["K"], r["slots"] = K, heads
    del acc
    for name in ("fused_locations", "fused_scatter_add", "fused_weight_grad"):
        for B, r in res[name].items():
            log(f"  {name} B={B}: {r['ms']:.4f} ms, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}), "
                f"{r['bound_ms'] / r['ms']:.1%} of bound, plain "
                f"{r['plain_ms']:.3f} ms"
                + (f" ({-(-B * cfg.n_fields // FULL_CHUNK)} chunked calls)"
                   if B == 65536 else "")
                + ("; profiler " + ", ".join(
                    f"{k} {v:.4f} ms" for k, v in r["profile_ms"].items())
                   if "profile_ms" in r else "")
                + (f"; the fill alone (torch.empty(m).zero_(), m = {p.m}) "
                   f"{r['fill_ms']:.4f} ms, the kernel's own with no rows "
                   f"{r['kernel_fill_ms']:.4f} ms; cooperative grid "
                   f"{r['grid']} blocks ({r['blocks_per_sm']} an SM), "
                   f"{r['registers']} registers" if "fill_ms" in r else ""))
    r = res["sparse_adagrad"]
    log(f"  sparse_adagrad K={K} ({heads} slots): {r['ms']:.4f} ms, bound "
        f"{r['bound_ms']:.4f} ms (bytes), {r['bound_ms'] / r['ms']:.1%} of "
        f"bound, plain {r['plain_ms']:.3f} ms, torch.optim.Adagrad (sparse) "
        f"{r['library_ms']:.3f} ms of device time; its passes "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in r["passes_ms"].items()))
    return res


# ------------------------------------- rows 8, 9 (sparse SGD, Adam), 13 (bag)

def build_hashed_row(torch, dev, mesh=None):
    """dlrm-rm2 with hashed_row at the same budget: 135,053,312 / 64 =
    2,110,208 pool rows, so its sparse gradient is row mode (with a mesh,
    this rank's slab of the pool)."""
    from repro_torch.configs import get_config
    from repro_torch.models.recsys import Recsys

    cfg = get_config("dlrm-rm2").make_model(embedding_kind="hashed_row")
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    model = Recsys(cfg, gen, device=dev, mesh=mesh).eval()
    e = cfg.embedding
    log(f"model: dlrm-rm2 (hashed_row), m={e.budget}, "
        f"{e.budget // e.dim} rows of d={e.dim}")
    return cfg, model, cfg.table.make_buffers(None)


def stress_stream(torch, m: int, dev, tile: int = 2048, halo: int = 2048):
    """A bucketed flat stream against the flat fold's tiles: runs of every
    length 1..tile + halo + 1 in random order (run ends on and around every
    tile edge, runs that fill the halo and go to the second pass), one of
    2^15, then a tail of sentinels (= m); slots spread over [0, m), values
    of both signs over seven decades, 1% -0."""
    from types import SimpleNamespace

    rng = np.random.default_rng(SEED + 23)
    lengths = np.concatenate([np.arange(1, tile + halo + 2), [1 << 15]])
    rng.shuffle(lengths)
    slots = np.sort(rng.choice(m, lengths.shape[0], replace=False))
    idx = np.concatenate([np.repeat(slots, lengths),
                          np.full(1000, m)]).astype(np.int32)
    vals = (rng.normal(0, 1, idx.shape[0])
            * 10.0 ** rng.uniform(-6, 1, idx.shape[0])).astype(np.float32)
    vals[rng.random(idx.shape[0]) < 0.01] = -0.0
    return SimpleNamespace(indices=torch.from_numpy(idx).to(dev),
                           values=torch.from_numpy(vals).to(dev),
                           unique=False)


def row_stress_stream(torch, rows: int, d: int, dev, longest: int = 300,
                      long_run: int = 5000):
    """A bucketed row-layout stream [K, d] against the row kernel's spans of
    32 entries: runs of every length 1..longest and one of long_run in
    random order (run ends at every offset of a span, runs across many
    spans), then a tail of sentinels (= rows); row scales over seven
    decades, both signs, 1% of the values -0, every fourth run of length 1
    all -0, and one column -0 through every entry of every tenth run (the
    reference folds each such sum to +0)."""
    from types import SimpleNamespace

    rng = np.random.default_rng(SEED + 24)
    lengths = np.concatenate([np.arange(1, longest + 1), [long_run]])
    rng.shuffle(lengths)
    slots = np.sort(rng.choice(rows, lengths.shape[0], replace=False))
    idx = np.concatenate([np.repeat(slots, lengths),
                          np.full(1000, rows)]).astype(np.int32)
    vals = (rng.normal(0, 1, (idx.shape[0], d))
            * 10.0 ** rng.uniform(-6, 1, (idx.shape[0], 1))).astype(np.float32)
    vals[rng.random(vals.shape) < 0.01] = -0.0
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    lone = starts[lengths == 1]
    vals[lone[::4]] = -0.0
    for r in range(0, lengths.shape[0], 10):
        vals[starts[r]:starts[r] + lengths[r], rng.integers(d)] = -0.0
    vals[idx >= rows] = 0.0
    return SimpleNamespace(indices=torch.from_numpy(idx).to(dev),
                           values=torch.from_numpy(vals).to(dev),
                           unique=False, dense_shape=(rows, d))


def bits_equal(torch, a, b) -> bool:
    """Equal as float32 values and as bit patterns (so -0 differs from
    +0)."""
    return torch.equal(a, b) and torch.equal(a.view(torch.int32),
                                             b.view(torch.int32))


def digest(torch, *tensors) -> str:
    """The first 16 hex digits of the sha256 of the tensors' bytes."""
    import hashlib

    h = hashlib.sha256()
    for x in tensors:
        h.update(x.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def optimizer_cases(torch, gen, lead: int, shape: tuple) -> dict:
    """Random states on a pool of ``shape`` (leading dim ``lead``) for SGD
    and Adam, and for a row layout also Adagrad (row 7's flat layout is
    phase 7's) and Adam with a row-wise [lead] nu."""
    def rand(*sh):
        return torch.rand(sh, generator=gen, device=gen.device)
    cases = {"sgd": (rand(*shape) - 0.5,),
             "adam": ((rand(*shape) - 0.5) * 1e-3, rand(*shape) * 1e-6)}
    if len(shape) == 2:
        cases["adagrad"] = (rand(*shape),)
        cases["adam row-wise nu"] = (cases["adam"][0], rand(lead) * 1e-6)
    return cases


def check_optimizer_kernels(torch, p, sg, sg_rows, dev) -> tuple:
    """Rows 8 and 9 (and row 7's row layout) against their plain versions:
    on a sentinel-padded unique stream, the real B=65,536 step's bucketed
    stream of the LMA pool and (rows 7-9) the tile-edge stress stream (flat
    [m] states), on the hashed_row pool's row-mode SparseGrad ([rows, 64]
    states, Adam also with a row-wise nu) and (rows 7-9, Adam both ways) on
    the bucketed row stress stream (``row_stress_stream``, with a tenth of
    every state's elements -0, so a -0 where the reference folds to +0
    shows in SGD's and Adam's updates too).  Updates and states bit-equal,
    compared as int32 bit patterns (the earlier streams' row-wise nu may
    instead be within 1e-6 relative, see ``ref.row_mean``; the stress
    stream's may not), untouched slots bit-unchanged.  A mismatch is
    recorded and the checks go on, so one run shows every stream and op;
    ``run_optimizers`` raises after phase 22.  -> (max |err| by kernel,
    the mismatches)."""
    from repro_torch.kernels.sparse_update import ops as su
    from repro_torch.kernels.sparse_update import ref as sref
    from repro_torch.optim.sparse import dedup_locations

    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    hyper = {"sgd": {"lr": 1e-2, "momentum": MOMENTUM},
             "adagrad": {"lr": 1e-2, "eps": ADAGRAD_EPS},
             "adam": {"lr": 1e-3, "b1": ADAM_B1, "b2": ADAM_B2,
                      "bc1": 0.271, "bc2": 0.00299, "eps": ADAM_EPS}}
    half = sg.indices.numel() // 16
    uniq = dedup_locations(sg.indices[:half], sg.values[:half], (p.m,))
    err, lines, failures = {}, [], []
    rows_shape = tuple(sg_rows.dense_shape)
    streams = [("LMA unique", uniq, (p.m,)), ("LMA bucketed", sg, (p.m,)),
               ("tile-edge stress", stress_stream(torch, p.m, dev), (p.m,)),
               ("hashed_row rows", sg_rows, rows_shape),
               ("row stress", row_stress_stream(torch, rows_shape[0],
                                                rows_shape[1], dev),
                rows_shape)]
    with torch.no_grad():
        for where, stream, shape in streams:
            lead = shape[0]
            cases = optimizer_cases(torch, gen, lead, shape)
            if where == "tile-edge stress":     # row 7's flat fold too
                cases["adagrad"] = (torch.rand(shape, generator=gen,
                                               device=dev),)
            if where == "row stress":
                for x in {id(x): x for c in cases.values() for x in c
                          }.values():
                    x[torch.rand(x.shape, generator=gen, device=dev)
                      < 0.1] = -0.0
            for case, states in cases.items():
                algo = case.split()[0]
                mine = tuple(x.clone() for x in states)
                plain = tuple(x.clone() for x in states)
                u_k, _ = su.sparse_update(algo, stream.indices, stream.values,
                                          mine, unique=stream.unique,
                                          **hyper[algo])
                u_p, _ = getattr(sref, f"sparse_{algo}_ref")(
                    stream.indices, stream.values, *plain,
                    unique=stream.unique, **hyper[algo])
                exact = all(bits_equal(torch, a, b) for a, b in
                            zip((u_k,) + mine, (u_p,) + plain))
                rel = max(float(((a - b).abs() / b.abs().clamp_min(1e-30))
                                .max()) for a, b in zip((u_k,) + mine,
                                                        (u_p,) + plain))
                if not exact and not (case.endswith("nu") and rel <= 1e-6
                                      and where != "row stress"):
                    n_bits = sum(int((a.view(torch.int32)
                                      != b.view(torch.int32)).sum())
                                 for a, b in zip((u_k,) + mine,
                                                 (u_p,) + plain))
                    failures.append(f"{SPARSE_KERNEL[algo]} on {where} "
                                    f"({case}): {n_bits} elements differ in "
                                    f"their bits, max rel {rel:.3g}")
                touched = torch.zeros(lead, dtype=torch.bool, device=dev)
                touched[stream.indices[stream.indices < lead].long()] = True
                for x0, x in zip(states, mine):
                    if not torch.equal(x[~touched].view(torch.int32),
                                       x0[~touched].view(torch.int32)):
                        failures.append(f"{case} on {where} wrote untouched "
                                        "slots")
                name = SPARSE_KERNEL[algo]
                err[name] = max(err.get(name, 0.0), float(
                    (u_k - u_p).abs().max()), *(float((a - b).abs().max())
                                                for a, b in zip(mine, plain)))
                lines.append(f"{case} on {where} (K={stream.indices.numel()})"
                             f": {'bit-identical' if exact else f'rel {rel:.3g}'}")
                del mine, plain, u_k, u_p
    log("sparse optimizer kernels vs plain versions (int32 bit patterns): "
        + "; ".join(lines))
    for f in failures:
        log(f"MISMATCH: {f}")
    return err, failures


def check_embedding_bag(torch, hr_model, hr_cfg, gen, dev, kernels) -> tuple:
    """Row 13 through its entry point (``ops.embedding_bag``) at the
    reference's bench shape (B=2,048, L=32, a 65,536 x 64 table) and on the
    hashed_row pool viewed as its [2,110,208, 64] table with the rows of a
    B=4,096 batch's 26 fields; each output within 1e-6 of its sum_l |w T|
    of the plain version.  -> (launches, max |err|, the inputs by B)."""
    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

    g = torch.Generator(device=dev).manual_seed(SEED + 22)
    table = torch.randn((65_536, 64), generator=g, device=dev)
    ids = torch.randint(0, 65_536, (2048, 32), generator=g, device=dev,
                        dtype=torch.int32)
    e = hr_cfg.embedding
    pool = hr_model.embedding["memory"].detach().view(-1, e.dim)
    batch = gen.batch(4096, 800_000)
    gids = global_ids(torch, hr_cfg, batch, dev)
    rows = hr_cfg.table.scheme.sparse_row_ids(e, {}, gids).reshape(4096, -1)
    inputs = {2048: (table, ids, torch.rand((2048, 32), generator=g,
                                            device=dev) - 0.5),
              4096: (pool, rows.contiguous(),
                     torch.rand(rows.shape, generator=g, device=dev) - 0.5)}
    for k in kernels.values():
        k.launches = 0
    with torch.no_grad():
        outs = {B: eb.embedding_bag(*args) for B, args in inputs.items()}
    n = kernels["embedding_bag"].launches
    if n != len(inputs):
        raise AssertionError(f"embedding_bag launched {n} times in "
                             f"{len(inputs)} calls")
    worst, parts = 0.0, []
    with torch.no_grad():
        for B, (t, i, w) in inputs.items():
            if not bits_equal(torch, outs[B], eb.embedding_bag(t, i, w)):
                raise AssertionError(f"embedding_bag B={B}: two calls gave "
                                     "different bits")
            # the digests let two runs (two versions of the kernel) compare
            # their bits: equal inputs and equal outputs give equal digests
            parts.append(f"B={B} sha256 of ids, weights, table "
                         f"{digest(torch, i, w, t)}, of the output "
                         f"{digest(torch, outs[B])}")
            want = embedding_bag_ref(t, i, w)
            scale = torch.einsum("bl,bld->bd", w.abs().double(),
                                 t[i.long()].abs().double())
            err = (outs[B] - want).abs()
            ratio = float((err.double() / scale.clamp_min(1e-30)).max())
            if ratio > SUM_RTOL or outs[B].shape != want.shape:
                raise AssertionError(f"embedding_bag B={B}: max |err| / sum "
                                     f"|w T| {ratio:.3g}")
            worst = max(worst, float(err.max()))
            parts.append(f"B={B} L={i.shape[1]} table {tuple(t.shape)}: max "
                         f"|err| {float(err.max()):.3g}, / sum |w T| "
                         f"{ratio:.3g}")
    log("embedding_bag through ops.embedding_bag, launches "
        f"{n}, the same bits twice: " + "; ".join(parts)
        + f" (tol {SUM_RTOL})")
    return n, worst, inputs


def library_sparse_ms(torch, opt_cls, stream, shape, dev, **kw):
    """Device time of one step of ``opt_cls`` (torch.optim.Adagrad or
    SparseAdam) on a COO gradient of the stream's live entries: a flat
    stream's [K] values, or the row layout's [n, d] rows as a hybrid COO
    tensor (one sparse dim); the profiler's, as no CUDA graph captures a
    sparse step."""
    live = stream.indices < shape[0]
    idx, vals = stream.indices[live], stream.values[live]
    param = torch.nn.Parameter(torch.zeros(shape, device=dev))
    opt = opt_cls([param], **kw)
    coo = torch.sparse_coo_tensor(idx[None].long(), vals, shape,
                                  check_invariants=False)

    def library_step():
        param.grad = coo
        opt.step()

    return device_ms(torch, library_step)


def measure_optimizers(torch, sg, sg_rows, dev) -> dict:
    """Rows 8 and 9 timed by CUDA-graph replay on the LMA pool's real
    bucketed K=109,051,904 stream (flat states), and rows 7-9 on the
    hashed_row pool's row-mode SparseGrad ([rows, 64], element-wise
    states), beside their bytes bounds (each index read and each update
    written, the live entries' values read -- a sentinel's value is never
    read --, and each touched slot's states read and written once), the
    plain versions and one PyTorch call for the same function where there
    is one: torch.optim.Adagrad and SparseAdam on the COO gradient of the
    live entries (hybrid in the row layout; profiled device time).  No
    single PyTorch call computes lazy momentum SGD: torch.optim.SGD applies
    its momentum buffer to every slot.  Row 7's flat layout is phase
    11's."""
    from repro_torch.kernels.sparse_update import ref as sref
    from repro_torch.kernels.sparse_update.kernel import (sparse_adagrad_cuda,
                                                          sparse_adam_cuda,
                                                          sparse_sgd_cuda)

    hyper = {"adagrad": {"lr": 1e-2, "eps": ADAGRAD_EPS},
             "sgd": {"lr": 1e-2, "momentum": MOMENTUM},
             "adam": {"lr": 1e-3, "b1": ADAM_B1, "b2": ADAM_B2, "bc1": 0.271,
                      "bc2": 0.00299, "eps": ADAM_EPS}}
    kernel = {"adagrad": sparse_adagrad_cuda, "sgd": sparse_sgd_cuda,
              "adam": sparse_adam_cuda}
    library = {"adagrad": (torch.optim.Adagrad,
                           {"lr": 1e-2, "eps": ADAGRAD_EPS}),
               "adam": (torch.optim.SparseAdam, {"lr": 1e-3})}
    res = {}
    for algo in ("adagrad", "sgd", "adam"):
        n_states = 2 if algo == "adam" else 1
        r = {}
        for where, stream in (("flat", sg), ("rows", sg_rows)):
            if algo == "adagrad" and where == "flat":
                continue
            shape = tuple(stream.dense_shape)
            states = tuple(torch.zeros(shape, device=dev)
                           for _ in range(n_states))
            K = stream.indices.numel()
            live = stream.indices[stream.indices < shape[0]]
            slots = int(torch.unique_consecutive(live).numel())
            width = 1 if len(shape) == 1 else shape[1]
            t = {"K": K, "live": live.numel(), "slots": slots,
                 "row_width": width}

            def run():
                return kernel[algo](stream.indices, stream.values, *states,
                                    unique=stream.unique, **hyper[algo])

            graph_ms(torch, run, 5)     # the first timing of a stream
            t["ms"] = graph_ms(torch, run, 5)           # reads high
            t["plain_ms"] = time_ms(torch, lambda: getattr(
                sref, f"sparse_{algo}_ref")(stream.indices, stream.values,
                                            *states, unique=stream.unique,
                                            **hyper[algo]), 2, warmup=1)
            t["bound_ms"], t["bound_by"] = bound(
                K * (4 + 4 * width) + live.numel() * 4 * width
                + slots * width * 8 * n_states, 0, 1.0)
            t["library_ms"] = None
            if algo in library:
                opt_cls, kw = library[algo]
                t["library_ms"] = library_sparse_ms(torch, opt_cls, stream,
                                                    shape, dev, **kw)
            t["passes_ms"] = profile_ms(torch, run)
            r[where] = t
            del states
            lib = {"adagrad": "torch.optim.Adagrad",
                   "adam": "torch.optim.SparseAdam"}.get(algo)
            log(f"  {SPARSE_KERNEL[algo]} {where} K={K} ({slots} slots, "
                f"width {width}): {t['ms']:.4f} ms, bound "
                f"{t['bound_ms']:.4f} ms (bytes), "
                f"{t['bound_ms'] / t['ms']:.1%} of bound, plain "
                f"{t['plain_ms']:.3f} ms"
                + (f", {lib} {t['library_ms']:.3f} ms of device time"
                   if t["library_ms"] is not None else "")
                + "; profiler " + ", ".join(f"{k} {v:.4f} ms"
                                            for k, v in t["passes_ms"].items()))
        res[SPARSE_KERNEL[algo]] = ({**r["flat"], "rows": r["rows"]}
                                    if "flat" in r else {"rows": r["rows"]})
    return res


def measure_bag(torch, inputs, dev) -> dict:
    """Row 13 by CUDA-graph replay with a cold L2 (``cold_graph_ms``: both
    tables would otherwise stay in L2 across replays) at both of
    ``check_embedding_bag``'s shapes, beside its bytes bound (each distinct
    gathered row once, ids and weights in, the output out), its plain
    version and F.embedding_bag with per-sample weights, timed the same
    way; and the launch floor both ways: a kernel that does nothing (a
    one-element fill) by ``cold_graph_ms``, as row 13 is timed, and by
    plain graph replay."""
    import torch.nn.functional as tf

    from repro_torch.kernels.embedding_bag.kernel import embedding_bag_cuda
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

    one = torch.zeros(1, device=dev)
    floor = {"launch_floor_ms": cold_graph_ms(torch, lambda: one.fill_(0.0),
                                              50, dev),
             "launch_floor_warm_ms": graph_ms(torch, lambda: one.fill_(0.0),
                                              50)}
    log(f"  launch floor (a one-element fill by graph replay): "
        f"{floor['launch_floor_ms']:.4f} ms measured as row 13 is "
        f"(cold_graph_ms), {floor['launch_floor_warm_ms']:.4f} ms warm")
    res = {}
    with torch.no_grad():
        for B, (t, i, w) in inputs.items():
            L, d = i.shape[1], t.shape[1]
            valid = i[(i >= 0) & (i < t.shape[0])]
            rows = int(torch.unique(valid).numel())
            r = res[B] = {"L": L, "table_rows": t.shape[0], "d": d,
                          "distinct_rows": rows, **floor}
            r["ms"] = cold_graph_ms(torch, lambda: embedding_bag_cuda(t, i, w),
                                    50, dev)
            r["plain_ms"] = cold_graph_ms(
                torch, lambda: embedding_bag_ref(t, i, w), 10, dev)
            r["library_ms"] = cold_graph_ms(torch, lambda: tf.embedding_bag(
                i, t, per_sample_weights=w, mode="sum"), 50, dev)
            r["bound_ms"], r["bound_by"] = bound(
                rows * d * 4 + B * L * 8 + B * d * 4, 2 * valid.numel() * d,
                FP32_FLOP_PER_S)
            log(f"  embedding_bag B={B} L={L} table {tuple(t.shape)} "
                f"({rows} distinct rows), cold L2: "
                f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}), {r['bound_ms'] / r['ms']:.1%} of bound, "
                f"plain {r['plain_ms']:.4f} ms, F.embedding_bag "
                f"{r['library_ms']:.4f} ms")
    return res


def run_optimizers(torch, cfg, model, bufs, gen, B, sg, dev,
                   kernels) -> dict:
    """Phases 18-22: the hashed_row pool (row mode), rows 7-9 against
    their plain versions, full-width training with the sgd and adam arms
    (LMA) and the adam arm (hashed_row), row 13, and the timings; a phase
    19 mismatch fails the run after the timings.  -> the launch counts by
    path, errors, timings and training records."""
    hr_cfg, hr_model, hr_bufs = build_hashed_row(torch, dev)
    sg_rows = real_step_grad(torch, hr_cfg, hr_model, hr_bufs,
                             gen.batch(B, 0), dev)
    if sg_rows.values.dim() != 2 or not sg_rows.unique:
        raise AssertionError("hashed_row's SparseGrad is not row mode")
    err, failures = check_optimizer_kernels(torch, cfg.embedding.lma, sg,
                                            sg_rows, dev)
    paths, train = {}, {}
    for label, c, m, b, opt in (
            ("dlrm-rm2 train sgd", cfg, model, bufs, "sgd"),
            ("dlrm-rm2 train adam", cfg, model, bufs, "adam"),
            ("dlrm-rm2 hashed_row train adam", hr_cfg, hr_model, hr_bufs,
             "adam")):
        train[label] = train_full_width(torch, "dlrm-rm2", c, m, b, gen, B,
                                        dev, kernels, optimizer=opt)
        paths[f"{label} sparse"] = train[label]["sparse"]["launches"]
        paths[f"{label} dense"] = train[label]["dense"]["launches"]
    n_bag, err["embedding_bag"], bag_inputs = check_embedding_bag(
        torch, hr_model, hr_cfg, gen, dev, kernels)
    paths["embedding_bag op"] = {"embedding_bag": n_bag}
    res = measure_optimizers(torch, sg, sg_rows, dev)
    res["embedding_bag"] = measure_bag(torch, bag_inputs, dev)
    del hr_model, sg_rows, bag_inputs
    if failures:
        raise AssertionError("phase 19: " + "; ".join(failures))
    return {"paths": paths, "err": err, "res": res, "train": train}


# ------------------------------- qr, md and freq; DCN-v2; DIN; retrieval

SCHEME_STEPS = 4                # per run of these paths, sparse and dense
SCHEME_SERVE_RUNS = ((100_000, 1024),)
RETRIEVAL_CANDIDATES, RETRIEVAL_CHUNK = 1_000_000, 8192
DIN_CHECK_BATCH = 16_384        # 1,654,784 ids, about dlrm-rm2's check


def check_freq_rows(torch, cfg, bufs, batch, dev) -> dict:
    """freq's row ids and locations for a training batch on the card equal,
    bit for bit, those of the same batch on the CPU."""
    scheme, e = cfg.table.scheme, cfg.embedding
    gids = global_ids(torch, cfg, batch, dev)
    host = {k: v.cpu() for k, v in bufs.items()}
    with torch.no_grad():
        rows = scheme.sparse_row_ids(e, bufs, gids)
        loc = scheme.locations(e, bufs, gids)
        rows_h = scheme.sparse_row_ids(e, host, gids.cpu())
        loc_h = scheme.locations(e, host, gids.cpu())
    if not (torch.equal(rows.cpu(), rows_h) and torch.equal(loc.cpu(), loc_h)):
        raise AssertionError("freq: row ids or locations differ between the "
                             "card and the CPU")
    k = scheme.hot_k(e)
    out = {"values": gids.numel(), "hot_k": k,
           "tail_rows": scheme.tail_rows(e),
           "hot_share": float((rows < k).double().mean()),
           "rows_touched": int(torch.unique(rows).numel())}
    log(f"freq: row ids and locations of {out['values']} training values "
        "bit-equal on the card and the CPU; hot tier {hot_k} rows, tail "
        "{tail_rows} rows; {hot_share:.1%} of values hit a hot row; "
        "{rows_touched} rows touched".format(**out))
    return out


def run_schemes(torch, dev, kernels, gen) -> dict:
    """dlrm-rm2 at full width with qr, md and freq (no D' store): a served
    batch against the plain forward, 1,024 requests at 100K/s, and
    SCHEME_STEPS steps at B = 65,536 taken sparse and dense from one state
    (``check_step``: qr and md have no pool, so the two trainers must agree
    bit for bit; freq's pool is row mode, its row ids and locations checked
    against the CPU's); exact launches throughout."""
    from repro_torch.configs._recsys_common import RECSYS_SHAPE_TABLE

    B = RECSYS_SHAPE_TABLE["train_batch"]["batch"]
    out = {"paths": {}, "serving": {}, "train": {}}
    for kind in ("qr", "md", "freq"):
        label = f"dlrm-rm2 {kind}"
        cfg, model, bufs = build_model(torch, dev, "dlrm-rm2", kind=kind)
        if kind == "freq":
            batch = gen.batch(B, 0)
            ids = global_ids(torch, cfg, batch, dev).long()
            seen = torch.bincount(ids, minlength=cfg.embedding.total_vocab)
            bufs = cfg.table.make_buffers(seen, device=dev)
            out["freq"] = check_freq_rows(torch, cfg, bufs, batch, dev)
        launched, out["serving"][label], _ = serve(
            torch, cfg, model, bufs, dev, kernels, runs=SCHEME_SERVE_RUNS,
            label=label)
        out["paths"][f"{label} serve"] = launched
        train = train_full_width(torch, "dlrm-rm2", cfg, model, bufs, gen, B,
                                 dev, kernels, steps=SCHEME_STEPS)
        out["train"][label] = train
        out["paths"][f"{label} train sparse"] = train["sparse"]["launches"]
        out["paths"][f"{label} train dense"] = train["dense"]["launches"]
        del cfg, model, bufs, train
        free(torch)
    return out


def run_retrieval(torch, cfg, model, bufs, dev, kernels, label) -> dict:
    """retrieval_cand: one context against RETRIEVAL_CANDIDATES candidates
    in chunks of RETRIEVAL_CHUNK, timed on the host clock around a synced
    call after a warm-up; exact launches (one forward a chunk); the first
    chunk's scores equal, bit for bit, a direct forward of that chunk's
    batch."""
    from repro_torch.models.recsys import retrieval

    rng = np.random.default_rng(SEED + 13)
    ctx = request_drawer(cfg)(rng, 1)
    C, chunk = RETRIEVAL_CANDIDATES, RETRIEVAL_CHUNK
    cand = torch.from_numpy(rng.integers(
        0, cfg.embedding.vocab_sizes[0], C).astype(np.int32)).to(dev)
    ctx_t = on_card(torch, ctx, dev)
    retrieval(model, ctx_t, cand[:2 * chunk], bufs, chunk)
    torch.cuda.synchronize()
    zero(kernels)
    t0 = time.perf_counter()
    scores = retrieval(model, ctx_t, cand, bufs, chunk)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    got = counts(kernels)
    n_chunks = -(-C // chunk)
    want = {k: n * n_chunks for k, n in model_launches(cfg).items()}
    if {k: n for k, n in got.items() if n} != want:
        raise AssertionError(f"{label} retrieval launched {got}, expected "
                             f"{want}")
    if scores.shape != (C,) or not bool(torch.isfinite(scores).all()):
        raise AssertionError(f"{label} retrieval: bad scores")
    direct = {k: v.repeat(chunk, *([1] * (v.dim() - 1)))
              for k, v in ctx_t.items()}
    if cfg.model == "din":
        direct["target"] = cand[:chunk]
    else:
        direct["sparse"][:, 0] = cand[:chunk]
    with torch.inference_mode():
        first = model(direct, bufs)
    if not torch.equal(first, scores[:chunk]):
        raise AssertionError(f"{label} retrieval: the first chunk differs "
                             "from a direct forward (max |diff| "
                             f"{float((first - scores[:chunk]).abs().max()):.3g})")
    out = {"candidates": C, "chunk": chunk, "chunks": n_chunks,
           "seconds": sec, "candidates_per_sec": C / sec, "launches": got}
    log(f"{label} retrieval_cand: {C} candidates in {n_chunks} chunks of "
        f"{chunk}: {sec * 1e3:.1f} ms ({C / sec:,.0f} candidates/s); "
        f"launches {want}; the first chunk bit-equal to a direct forward")
    return out


def run_dcn(torch, dev, kernels, store_bufs, gen) -> dict:
    """Full-width DCN-v2 on dlrm-rm2's D' store (the same 26 Criteo
    vocabularies and max_set): rows 2, 4 and 5 at d = 16 striped over a
    training batch, serving at both rates, SCHEME_STEPS steps at B = 65,536
    under ``check_step``, retrieval_cand."""
    from repro_torch.configs._recsys_common import RECSYS_SHAPE_TABLE

    B = RECSYS_SHAPE_TABLE["train_batch"]["batch"]
    cfg, model, bufs = build_model(torch, dev, "dcn-v2", bufs=store_bufs)
    out = {"check": check_full_batch(
        torch, cfg, bufs, model.embedding["memory"].detach(),
        gen.batch(B, 0), dev)}
    launched, out["serving"], _ = serve(torch, cfg, model, bufs, dev,
                                        kernels)
    out["paths"] = {"dcn-v2 serve": launched}
    train = train_full_width(torch, "dcn-v2", cfg, model, bufs, gen, B, dev,
                             kernels, steps=SCHEME_STEPS)
    out["train"] = train
    out["paths"]["dcn-v2 train sparse"] = train["sparse"]["launches"]
    out["paths"]["dcn-v2 train dense"] = train["dense"]["launches"]
    out["retrieval"] = run_retrieval(torch, cfg, model, bufs, dev, kernels,
                                     "dcn-v2")
    out["paths"]["dcn-v2 retrieval"] = out["retrieval"]["launches"]
    return out


def run_din(torch, dev, kernels) -> dict:
    """Full-width DIN: its 5,000,000 x 32 D' store planted on the card,
    rows 2, 4 and 5 at d = 18 (a flat pool) over a B = 16,384 batch's
    history and targets, serving at both rates (two lookups a device call),
    SCHEME_STEPS steps at B = 65,536 under ``check_step`` (both lookups'
    records in one SparseGrad), retrieval_cand."""
    from repro_torch.configs._recsys_common import RECSYS_SHAPE_TABLE

    B = RECSYS_SHAPE_TABLE["train_batch"]["batch"]
    cfg, model, bufs = build_model(torch, dev, "din")
    draw = DinDraw(cfg.embedding.vocab_sizes[0], cfg.hist_len)
    out = {"check": check_full_batch(
        torch, cfg, bufs, model.embedding["memory"].detach(),
        draw.batch(DIN_CHECK_BATCH, 1 << 20), dev)}
    launched, out["serving"], _ = serve(torch, cfg, model, bufs, dev,
                                        kernels)
    out["paths"] = {"din serve": launched}
    train = train_full_width(torch, "din", cfg, model, bufs, draw, B, dev,
                             kernels, steps=SCHEME_STEPS)
    out["train"] = train
    out["paths"]["din train sparse"] = train["sparse"]["launches"]
    out["paths"]["din train dense"] = train["dense"]["launches"]
    out["retrieval"] = run_retrieval(torch, cfg, model, bufs, dev, kernels,
                                     "din")
    out["paths"]["din retrieval"] = out["retrieval"]["launches"]
    return out


def free(torch) -> None:
    """Hand the memory of what the caller dropped back to the card and
    restart the peak count."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


# ---------------------------------------------------------------- xDeepFM

def cin_layer_inputs(torch, cfg, model, bufs, B, seed, dev):
    """Real inputs of the three CIN layers for B drawn requests: x0 from the
    plain split lookup, each xk through the plain CIN; -> (x0, [(xk, w)])."""
    from repro_torch.embed import SPLIT

    batch = draw_requests(np.random.default_rng(seed),
                          cfg.embedding.vocab_sizes, B, cfg.n_dense)
    gids = global_ids(torch, cfg, batch, dev)
    with torch.inference_mode():
        feats = SPLIT.lookup(cfg.embedding, cfg.table.scheme,
                             dict(model.embedding), bufs, gids)
        x0, xks, _ = plain_cin_inputs(torch, cfg, model, feats)
    ws = [model.cin[f"layer_{i}"].detach() for i in range(len(xks))]
    return x0, list(zip(xks, ws))


def abs_terms(torch, xk, x0, w, chunk: int = 512):
    """sum_{h,f} |w[o,h,f] xk[b,h,e] x0[b,f,e]| per output, in float64."""
    return torch.cat([torch.einsum(
        "bhd,bfd,ohf->bod", xk[a:a + chunk].abs().double(),
        x0[a:a + chunk].abs().double(), w.abs().double())
        for a in range(0, xk.shape[0], chunk)])


def check_cin(torch, cfg, model, bufs, dev) -> tuple:
    """Row 14 against its plain version on the three layers' real inputs at
    each of CIN_CHECK_BATCHES: every output within SUM_RTOL_CIN of its sum
    |terms|.  -> (max |err|, the inputs by batch for the timings)."""
    from repro_torch.kernels.cin.kernel import cin_cuda
    from repro_torch.kernels.cin.ref import cin_ref

    worst_abs, inputs = 0.0, {}
    for B in CIN_CHECK_BATCHES:
        x0, layers = cin_layer_inputs(torch, cfg, model, bufs, B, SEED + B,
                                      dev)
        inputs[B] = (x0, layers)
        parts = []
        with torch.inference_mode():
            for i, (xk, w) in enumerate(layers):
                got, want = cin_cuda(xk, x0, w), cin_ref(xk, x0, w)
                err = (got - want).abs()
                ratio = float((err.double()
                               / abs_terms(torch, xk, x0, w).clamp_min(1e-30)
                               ).max())
                if not bool(torch.isfinite(got).all()) or \
                        ratio > SUM_RTOL_CIN:
                    raise AssertionError(f"cin B={B} layer {i}: max |err| / "
                                         f"sum |terms| {ratio:.3g}")
                worst_abs = max(worst_abs, float(err.max()))
                parts.append(f"layer {i} [Hk={xk.shape[1]}] max |err| "
                             f"{float(err.max()):.3g}, / sum |terms| "
                             f"{ratio:.3g}")
        log(f"cin at B={B}: " + "; ".join(parts)
            + f" (tol {SUM_RTOL_CIN} of sum |terms|)")
    return worst_abs, inputs


def check_xdeepfm_lookups(torch, cfg, model, bufs, batch, dev) -> None:
    """Rows 2 and 4 for both pools (flat, d=10 and d=1) at the served batch
    size, bit-exact against their plain versions."""
    from repro_torch.kernels.fused_embed import ops as fe
    from repro_torch.kernels.fused_embed import ref as fref
    from repro_torch.kernels.fused_embed.kernel import (fused_locations_cuda,
                                                        fused_lookup_cuda)
    from repro_torch.models.recsys import linear_config

    gids = global_ids(torch, cfg, batch, dev)
    out = []
    with torch.inference_mode():
        for e, params in ((cfg.embedding, model.embedding),
                          (linear_config(cfg), model.linear)):
            p = e.lma
            rows, support = cfg.table.scheme.fused_inputs(e, bufs, gids)
            n_fb = int((support < p.min_support).sum())
            if n_fb == 0:
                raise AssertionError("the check batch holds no fallback rows")
            spec = fe.lma_spec(p)
            mem = params["memory"].detach()
            if not torch.equal(fused_lookup_cuda(spec, mem, gids, rows,
                                                 support),
                               fref.fused_lookup_ref(spec, mem, gids, rows,
                                                     support)):
                raise AssertionError(f"lookup differs (m={p.m}, d={p.d})")
            if not torch.equal(fused_locations_cuda(spec, gids, rows,
                                                    support),
                               fref.locations_ref(spec, gids, rows,
                                                  support)):
                raise AssertionError(f"locations differ (m={p.m}, d={p.d})")
            out.append(f"m={p.m} d={p.d} stripe={p.stripe}")
    log(f"xdeepfm lookups at B={len(batch['sparse'])} ({gids.numel()} values, "
        f"{n_fb} fallback rows): lookup and locations bit-exact for both "
        f"pools ({'; '.join(out)})")


def measure_cin(torch, inputs) -> dict:
    """Row 14 per layer at B=512 (a served batch) and B=4096 (a training
    batch): device time from CUDA-graph replay of the kernel, its plain
    version and one torch.einsum over the same inputs, beside two bounds:
    the float32 flops on the CUDA cores (67 TFLOP/s) and three TF32 passes
    on the tensor cores (494.7 TFLOP/s); the lower is the card's floor for
    float32-exact work and the row's bound.  The entry of a batch sums its
    three layers (one forward)."""
    from repro_torch.kernels.cin.kernel import cin_cuda
    from repro_torch.kernels.cin.ref import cin_ref

    res = {}
    for B in (512, 4096):
        x0, layers = inputs[B]
        F, d = x0.shape[1], x0.shape[2]
        per = []
        with torch.inference_mode():
            for xk, w in layers:
                Ho, Hk = w.shape[0], w.shape[1]
                Q = Hk * F
                r = {"Hk": Hk, "Ho": Ho}
                iters = 20 if B == 512 else 5
                r["ms"] = graph_ms(torch, lambda: cin_cuda(xk, x0, w), iters)
                r["plain_ms"] = graph_ms(torch, lambda: cin_ref(xk, x0, w),
                                         iters)
                r["library_ms"] = graph_ms(torch, lambda: torch.einsum(
                    "bhd,bfd,ohf->bod", xk, x0, w), iters)
                nbytes = 4 * (B * Hk * d + B * F * d + Ho * Q + B * Ho * d)
                flops = 2 * B * d * Ho * Q
                r["bound_fp32_ms"], _ = bound(nbytes, flops, FP32_FLOP_PER_S)
                r["bound_3xtf32_ms"], by = bound(nbytes, 3 * flops,
                                                 TF32_FLOP_PER_S)
                # the card's floor for float32-exact work: the lower
                r["bound_ms"], r["bound_by"] = min(
                    (r["bound_3xtf32_ms"], by), bound(nbytes, flops,
                                                      FP32_FLOP_PER_S))
                per.append(r)
        tot = {k: sum(r[k] for r in per)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                         "bound_fp32_ms", "bound_3xtf32_ms")}
        tot["bound_by"] = per[0]["bound_by"]
        tot["layers"] = per
        res[B] = tot
        log(f"  cin B={B}: {tot['ms']:.4f} ms over 3 layers ("
            + ", ".join(f"Hk={r['Hk']} {r['ms']:.4f} ms / bound "
                        f"{r['bound_ms']:.4f}" for r in per)
            + f"), bound {tot['bound_ms']:.4f} ms ({tot['bound_by']}, 3xTF32"
            f" on the tensor cores; {tot['bound_ms'] / tot['ms']:.1%} of it), "
            f"float32 FMA bound {tot['bound_fp32_ms']:.4f} ms "
            f"({tot['bound_fp32_ms'] / tot['ms']:.1%} of it), plain "
            f"{tot['plain_ms']:.4f} ms, torch.einsum {tot['library_ms']:.4f}"
            " ms (all by CUDA-graph replay)")
    return res


def run_xdeepfm(torch, dev, kernels) -> tuple:
    """Phases 12-17: build, check, serve, train and time full-width
    xDeepFM.  -> (launch counts of its main paths, the CIN's max |err|,
    its timings, the serving and training records)."""
    cfg, model, bufs = build_model(torch, dev, "xdeepfm")
    cin_err, inputs = check_cin(torch, cfg, model, bufs, dev)
    batch = draw_requests(np.random.default_rng(SEED + 11),
                          cfg.embedding.vocab_sizes, 512, cfg.n_dense)
    check_xdeepfm_lookups(torch, cfg, model, bufs, batch, dev)
    serve_counts, serving, _ = serve(torch, cfg, model, bufs, dev, kernels)
    gen = ctr_generator(cfg)
    train = train_full_width(torch, "xdeepfm", cfg, model, bufs, gen,
                             XDEEPFM_TRAIN_BATCH, dev, kernels)
    counts = {"serve": serve_counts, "train_sparse":
              train["sparse"]["launches"], "train_dense":
              train["dense"]["launches"]}
    res = measure_cin(torch, inputs)
    return counts, cin_err, res, serving, train


# ------------------------------------------- dlrm-rm2 sharded over 4 ranks

SHARD_RANKS = 4
SHARD_STEPS = 4                 # per strategy, sparse and dense
STRATEGIES = ("psum", "ring", "all_to_all")
# the launches of one sharded forward on each rank (the lookup, then the
# dot): psum's slab-mode lookup over the whole batch; ring's chunk lookup
# and three visiting-chunk gathers; all_to_all's chunk locations and one
# whole-batch gather
SHARD_FORWARD = {
    "psum": {"fused_embed": 1, "dot_interaction": 1},
    "ring": {"fused_chunk_lookup": 1, "fused_chunk_gather": 3,
             "dot_interaction": 1},
    "all_to_all": {"fused_locations": 1, "fused_chunk_gather": 1,
                   "dot_interaction": 1},
}
# a training step adds the pool gradient: sparse, psum's locations on its
# reconstructed rows (ring and all_to_all reuse the exchange's) and the
# slab's sparse Adagrad; dense, the slab's scatter (psum's recomputes its
# locations, the chunk scatter takes the exchange's)
SHARD_STEP = {
    s: {"sparse": dict(f, sparse_adagrad=1,
                       **({"fused_locations": f.get("fused_locations", 0)
                           + 1} if s == "psum" else {})),
        "dense": dict(f, **({"fused_scatter_add": 1} if s == "psum"
                            else {"fused_chunk_scatter": 1}))}
    for s, f in SHARD_FORWARD.items()}


def shard_kernels() -> dict:
    """Every kernel wrapper of the JSON line, by name (a rank's counters)."""
    from repro_torch.kernels.cin.kernel import cin_cuda
    from repro_torch.kernels.dot_interaction.kernel import dot_interaction_cuda
    from repro_torch.kernels.embedding_bag.kernel import embedding_bag_cuda
    from repro_torch.kernels.fused_embed import kernel as fk
    from repro_torch.kernels.lma_locations.kernel import lma_locations_cuda
    from repro_torch.kernels.sparse_update import kernel as sk

    return {"lma_locations": lma_locations_cuda,
            "fused_embed": fk.fused_lookup_cuda,
            "dot_interaction": dot_interaction_cuda,
            "fused_locations": fk.fused_locations_cuda,
            "fused_scatter_add": fk.fused_scatter_add_cuda,
            "fused_weight_grad": fk.fused_weight_grad_cuda,
            "sparse_adagrad": sk.sparse_adagrad_cuda,
            "cin": cin_cuda,
            "sparse_sgd": sk.sparse_sgd_cuda,
            "sparse_adam": sk.sparse_adam_cuda,
            "embedding_bag": embedding_bag_cuda,
            "fused_chunk_lookup": fk.fused_chunk_lookup_cuda,
            "fused_chunk_gather": fk.fused_chunk_gather_cuda,
            "fused_chunk_scatter": fk.fused_chunk_scatter_cuda}


class HostBatches:
    """Training batches made once on the host, served by step."""

    def __init__(self, batches: list):
        self.batches = batches

    def batch(self, B: int, step: int) -> dict:
        return self.batches[step]


def sharded_oracle(torch, dev, kernels, check_batch, batches, path) -> dict:
    """Phase 23: dlrm-rm2 rebuilt from the seed on one card: the logits and
    the LMA lookup of the 512-request batch, hashed_row's lookup of it, and
    SHARD_STEPS steps
    at B=65,536 taken sparse and dense from one state (``train_full_width``:
    losses, then the final pool and dense parameters).  Saved to ``path``
    on the host; the card is freed."""
    import gc

    cfg, model, bufs = build_model(torch, dev)
    with torch.no_grad():
        logits = model(on_card(torch, check_batch, dev), bufs).cpu()
        lookup = cfg.table.embed_fields(
            dict(model.embedding), bufs,
            torch.from_numpy(check_batch["sparse"]).to(dev)).cpu()
    hr_cfg, hr_model, _ = build_hashed_row(torch, dev)
    with torch.no_grad():
        hr = hr_cfg.table.embed_fields(
            dict(hr_model.embedding), {},
            torch.from_numpy(check_batch["sparse"]).to(dev)).cpu()
    del hr_model
    B = batches[0]["label"].shape[0]
    train = train_full_width(torch, "dlrm-rm2", cfg, model, bufs,
                             HostBatches(batches), B, dev, kernels,
                             steps=SHARD_STEPS, tag=" one-card oracle")
    oracle = {"logits": logits, "hr": hr, "lookup": lookup,
              "losses": {k: train[k]["losses"] for k in ("sparse", "dense")},
              "params": {k: q.detach().cpu()
                         for k, q in model.named_parameters()},
              "launches": {k: train[k]["launches"]
                           for k in ("sparse", "dense")}}
    torch.save(oracle, path)
    del cfg, model, bufs, train
    gc.collect()
    torch.cuda.empty_cache()
    log(f"one-card oracle saved ({Path(path).stat().st_size / 2**30:.2f} "
        "GiB on the host); card freed: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    return oracle


def slab_of(mesh, n: int) -> tuple[int, int]:
    """(base, length) of this rank's slab of an [n] pool."""
    m_local = n // mesh.model
    return mesh.rank * m_local, m_local


def chunk_inputs(torch, mesh, cfg, bufs, gids):
    """This rank's chunk of the ids and its D' rows and support, through
    the exchange's set reconstruction (the chunk engine's own)."""
    from repro_torch.dist import exchange as exl

    p = cfg.embedding.lma
    c = gids.numel() // mesh.model
    chunk = gids[mesh.rank * c:(mesh.rank + 1) * c]
    sets = bufs["store_sets"][:, : p.max_set]
    packed = torch.cat([sets, bufs["store_lengths"][:, None]], dim=1)
    rows, = exl.ALL_TO_ALL.set_lookup_many((packed,), chunk, mesh)
    return (chunk, rows[:, : p.max_set].contiguous(),
            rows[:, p.max_set].contiguous())


def held_to_sum_abs(torch, got, want, abs_sum) -> float:
    """max |got - want| / sum |g| over the slots, raising above SUM_RTOL."""
    diff = (got - want).abs().double()
    ratio = float((diff / abs_sum.clamp_min(1e-30)).max())
    if bool((diff > SUM_RTOL * abs_sum).any()):
        raise AssertionError(f"max |err| / sum |g| {ratio:.3g} > {SUM_RTOL}")
    return ratio


def check_chunk_kernels(torch, mesh, cfg, model, bufs, batch, dev) -> dict:
    """Phase 25 on one batch: rows 10 and 11 and the slab-mode lookup (row
    2) bit-exact against their plain versions (over FULL_CHUNK pieces),
    rows 12 and 5 in slab mode within SUM_RTOL of each slot's sum |g|.
    Shapes: this rank's chunk (row 10, the slab lookup, row 11's ring step,
    row 5) and the whole batch (row 11's all_to_all gather, row 12).  ->
    errors, the plain versions' times and the inputs, for the timings."""
    from repro_torch.dist import collectives as col
    from repro_torch.kernels.fused_embed import ops as fe
    from repro_torch.kernels.fused_embed import kernel as fk
    from repro_torch.kernels.fused_embed import ref as fref

    p = cfg.embedding.lma
    spec = fe.lma_spec(p)
    slab = model.embedding["memory"].detach()
    base, m_local = slab_of(mesh, p.m)
    gids = global_ids(torch, cfg, batch, dev)
    chunk, rows, support = chunk_inputs(torch, mesh, cfg, bufs, gids)
    c, N = chunk.numel(), gids.numel()
    gen = torch.Generator(device=dev).manual_seed(SEED + 30 + mesh.rank)
    plain = {"fused_chunk_lookup": 0.0, "fused_chunk_gather": 0.0,
             "fused_chunk_scatter": 0.0}
    err = {}
    with torch.no_grad():
        part, loc = fk.fused_chunk_lookup_cuda(spec, slab, chunk, rows,
                                               support, base)
        slab_lookup = fk.fused_lookup_cuda(spec, slab, chunk, rows, support,
                                           base=base)
        g_c = torch.randn((c, p.d), generator=gen, device=dev) * 1e-3
        dm5 = fk.fused_scatter_add_cuda(spec, g_c, chunk, rows, support,
                                        base=base, m_local=m_local)
        want5 = torch.zeros_like(dm5)
        abs5 = torch.zeros(m_local, dtype=torch.float64, device=dev)
        for a in range(0, c, FULL_CHUNK):
            sl = slice(a, a + FULL_CHUNK)
            piece = (chunk[sl], rows[sl], support[sl])
            (w_part, w_loc), ms = events_ms(torch, lambda: fref.chunk_lookup_ref(
                spec, slab, *piece, base=base))
            plain["fused_chunk_lookup"] += ms
            if not (torch.equal(loc[sl], w_loc) and torch.equal(part[sl], w_part)
                    and torch.equal(slab_lookup[sl], w_part)):
                raise AssertionError(f"rank {mesh.rank}: chunk lookup or the "
                                     f"slab-mode lookup differ at B={N}")
            want5 += fref.scatter_add_ref(spec, g_c[sl], *piece, base=base,
                                          m_local=m_local)
            rel = w_loc.reshape(-1).long() - base
            inb = (rel >= 0) & (rel < m_local)
            abs5.index_add_(0, rel[inb], g_c[sl].reshape(-1)[inb].abs().double())
            del w_part, w_loc, rel, inb
        err["fused_scatter_add"] = held_to_sum_abs(torch, dm5, want5, abs5)
        del dm5, want5, abs5, slab_lookup
        full = col.all_gather(loc, mesh).reshape(-1, p.d)
        for locs in (loc, full):
            got = fk.fused_chunk_gather_cuda(slab, locs, base)
            want, ms = events_ms(torch, lambda: fref.chunk_gather_ref(
                slab, locs, base))
            if locs is loc:
                if not torch.equal(got, part):
                    raise AssertionError("chunk gather differs from the "
                                         "chunk lookup's partial")
            else:
                plain["fused_chunk_gather"] = ms
            if not torch.equal(got, want):
                raise AssertionError(f"rank {mesh.rank}: chunk gather "
                                     f"differs at {tuple(locs.shape)}")
            del got, want
        g = torch.randn((N, p.d), generator=gen, device=dev) * 1e-3
        dm = fk.fused_chunk_scatter_cuda(full, g, base, m_local)
        want, plain["fused_chunk_scatter"] = events_ms(
            torch, lambda: fref.chunk_scatter_ref(full, g, base, m_local))
        rel = full.reshape(-1).long() - base
        inb = (rel >= 0) & (rel < m_local)
        abs_sum = torch.zeros(m_local, dtype=torch.float64, device=dev
                              ).index_add_(0, rel[inb],
                                           g.reshape(-1)[inb].abs().double())
        err["fused_chunk_scatter"] = held_to_sum_abs(torch, dm, want, abs_sum)
        in_slab = int(inb.sum())
        del dm, want, rel, inb, abs_sum
    err["fused_chunk_lookup"] = err["fused_chunk_gather"] = 0
    log(f"rank {mesh.rank} chunk kernels at B={N // cfg.n_fields} (chunk "
        f"{c} values, slab {base}..{base + m_local}): rows 10 and 11 and the "
        f"slab-mode lookup bit-exact; row 12 max |err| / sum |g| "
        f"{err['fused_chunk_scatter']:.3g}, row 5 (slab) "
        f"{err['fused_scatter_add']:.3g} (tol {SUM_RTOL}); {in_slab} of "
        f"{N * p.d} whole-batch locations in the slab")
    return {"err": err, "plain_ms": plain,
            "inputs": (spec, slab, base, m_local, chunk, rows, support, loc,
                       full, g, in_slab)}


def measure_chunk_kernels(torch, inputs, plain: dict, p) -> dict:
    """Phase 28 (rank 0, the other ranks idle): rows 10-12 by CUDA-graph
    replay at the B=65,536 chunk shapes beside their bounds and plain
    versions; no single PyTorch call computes a slab-masked gather or
    scatter, so there is no library time."""
    from repro_torch.kernels.fused_embed import kernel as fk

    (spec, slab, base, m_local, chunk, rows, support, loc, full, g,
     in_slab) = inputs
    c, N, d = chunk.numel(), full.shape[0], p.d
    res = {}
    with torch.no_grad():
        nbytes, ops = lma_work(torch, p, rows, support, fallback=True)
        in_c = int(((loc >= base) & (loc < base + m_local)).sum())
        # the locations are written too; only in-slab values are read
        nbytes += c * d * 4 - (c * d - in_c) * 4
        r = res["fused_chunk_lookup"] = {"batch": c}
        r["ms"] = graph_ms(torch, lambda: fk.fused_chunk_lookup_cuda(
            spec, slab, chunk, rows, support, base), 5)
        r["bound_ms"], r["bound_by"] = bound(nbytes, ops, INT32_OP_PER_S)
        r = res["fused_chunk_gather"] = {"batch": N}
        r["ms"] = graph_ms(torch, lambda: fk.fused_chunk_gather_cuda(
            slab, full, base), 10)
        r["bound_ms"], r["bound_by"] = bound(N * d * 8 + in_slab * 4, 0,
                                             INT32_OP_PER_S)
        r["at_chunk"] = {"batch": c, "ms": graph_ms(
            torch, lambda: fk.fused_chunk_gather_cuda(slab, loc, base), 20)}
        r["at_chunk"]["bound_ms"] = bound(c * d * 8 + in_c * 4, 0,
                                          INT32_OP_PER_S)[0]
        r = res["fused_chunk_scatter"] = {"batch": N}
        r["ms"] = graph_ms(torch, lambda: fk.fused_chunk_scatter_cuda(
            full, g, base, m_local), 10)
        r["bound_ms"], r["bound_by"] = bound(
            N * d * 8 + in_slab * 8 + m_local * 4, 0, INT32_OP_PER_S)
    for name, r in res.items():
        r["plain_ms"] = plain[name]
        r["library_ms"] = None
        log(f"  {name} at {r['batch']} rows: {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), {r['bound_ms'] / r['ms']:.1%} of bound; "
            "library: none (no PyTorch call masks by slab)"
            + (f"; at the chunk ({r['at_chunk']['batch']} rows) "
               f"{r['at_chunk']['ms']:.4f} ms, bound "
               f"{r['at_chunk']['bound_ms']:.4f} ms" if "at_chunk" in r
               else ""))
    return res


def zero(kernels):
    for k in kernels.values():
        k.launches = 0


def counts(kernels) -> dict:
    return {n: k.launches for n, k in kernels.items() if k.launches}


def sharded_forward(torch, mesh, cfg, model, bufs, batch, oracle, kernels,
                    dev) -> dict:
    """Phase 26: the 512-request forward under each strategy, each rank's
    logits bit-equal to the one-card oracle's, with exact launches."""
    from repro_torch.dist import exchange as exl
    from repro_torch.dist.context import use_mesh

    out = {}
    b = on_card(torch, batch, dev)
    for strategy in STRATEGIES:
        zero(kernels)
        exl.FORCED = strategy
        with torch.no_grad(), use_mesh(mesh):
            logits = model(b, bufs).cpu()
        exl.FORCED = None
        got = counts(kernels)
        if got != SHARD_FORWARD[strategy]:
            raise AssertionError(f"{strategy} forward launched {got}, "
                                 f"expected {SHARD_FORWARD[strategy]}")
        if not torch.equal(logits, oracle["logits"]):
            raise AssertionError(f"rank {mesh.rank}: {strategy} logits differ "
                                 "from one card's (max |diff| "
                                 f"{float((logits - oracle['logits']).abs().max()):.3g})")
        out[strategy] = got
    log(f"sharded forward at B=512: logits bit-equal to one card's under "
        f"{', '.join(STRATEGIES)}; launches per rank {out}")
    return out


def hashed_row_forward(torch, mesh, batch, oracle, kernels, dev) -> dict:
    """Phase 26b: hashed_row's lookup of the 512 batch under ring (rows 10
    and 11 with a hashed spec), bit-equal to its one-card lookup."""
    from repro_torch.dist import exchange as exl
    from repro_torch.dist.context import use_mesh

    cfg, model, _ = build_hashed_row(torch, dev, mesh=mesh)
    zero(kernels)
    exl.FORCED = "ring"
    with torch.no_grad(), use_mesh(mesh):
        out = cfg.table.embed_fields(dict(model.embedding), {},
                                     torch.from_numpy(batch["sparse"]).to(dev))
    exl.FORCED = None
    got = counts(kernels)
    if got != {"fused_chunk_lookup": 1, "fused_chunk_gather": 3}:
        raise AssertionError(f"hashed_row ring lookup launched {got}")
    if not torch.equal(out.cpu(), oracle["hr"]):
        raise AssertionError(f"rank {mesh.rank}: hashed_row ring lookup "
                             "differs from one card's")
    log(f"hashed_row sharded lookup under ring at B=512 bit-equal to one "
        f"card's; launches {got}")
    return got


def localizer(torch, mesh):
    """``localize`` for train_full_width: each SparseGrad cut to this
    rank's K/P slice, which is its slab's whole stream (slab-aligned), with
    slab-relative indices."""
    from repro_torch.dist.sharded_memory import slab_aligned
    from repro_torch.optim.sparse import SparseGrad, is_sparse

    def localize(grads):
        out = dict(grads)
        for k, g in grads.items():
            if not is_sparse(g):
                continue
            K = g.indices.numel()
            if not slab_aligned(g.unique, g.buckets, K, mesh.model):
                raise AssertionError(f"{k}: the stream is not slab-aligned")
            k_r = K // mesh.model
            base, m_local = slab_of(mesh, g.dense_shape[0])
            sl = slice(mesh.rank * k_r, (mesh.rank + 1) * k_r)
            out[k] = SparseGrad(g.indices[sl] - base, g.values[sl],
                                (m_local,), unique=False, buckets=g.buckets)
        return out

    return localize


def train_sharded(torch, mesh, cfg, model, bufs, batches, oracle, kernels,
                  dev) -> dict:
    """Phase 27: under each strategy, from the seed's state, SHARD_STEPS
    steps at B=65,536 through each rank's Trainer, sparse and dense from
    one state (``train_full_width``: check_step on this rank's slab, exact
    launches).  The sparse run bit-equal to the oracle's (losses, the
    rank's slab of the final pool, the dense parameters), the dense losses
    too (the same forward).  -> per strategy: the runs' records and the
    final dense parameters (host), for the cross-rank check."""
    from repro_torch.dist import exchange as exl
    from repro_torch.dist.context import use_mesh

    params = dict(model.named_parameters())
    with torch.no_grad():
        init = {k: q.detach().clone() for k, q in params.items()}
    B = batches[0]["label"].shape[0]
    base, m_local = slab_of(mesh, cfg.embedding.lma.m)
    out = {}
    for strategy in STRATEGIES:
        with torch.no_grad():
            for k, q in params.items():
                q.copy_(init[k])
        exl.FORCED = strategy
        t0 = time.perf_counter()
        s0, b0 = sum(mesh.staged_s.values()), mesh.staged_bytes
        with use_mesh(mesh):
            runs = train_full_width(
                torch, "dlrm-rm2", cfg, model, bufs, HostBatches(batches), B,
                dev, kernels, steps=SHARD_STEPS,
                per_step=SHARD_STEP[strategy],
                localize=localizer(torch, mesh),
                tag=f" {strategy}, rank {mesh.rank} of {mesh.model}")
        exl.FORCED = None
        wall = time.perf_counter() - t0
        n = 2 * SHARD_STEPS
        coll = {"s_per_step": (sum(mesh.staged_s.values()) - s0) / n,
                "gib_per_step": (mesh.staged_bytes - b0) / n / 2**30}
        for name in ("sparse", "dense"):
            if runs[name]["losses"] != oracle["losses"][name]:
                raise AssertionError(
                    f"rank {mesh.rank} {strategy}: {name} losses "
                    f"{runs[name]['losses']} differ from one card's "
                    f"{oracle['losses'][name]}")
        final = {k: q.detach().cpu() for k, q in params.items()}
        for k, q in final.items():
            want = oracle["params"][k]
            if k.endswith("memory"):
                want = want[base:base + m_local]
            if not torch.equal(q, want):
                raise AssertionError(f"rank {mesh.rank} {strategy}: {k} after "
                                     f"{SHARD_STEPS} sparse steps differs "
                                     "from one card's")
        log(f"sharded {strategy}: {SHARD_STEPS} sparse steps bit-equal to one "
            "card's (losses, this rank's slab, dense parameters); dense "
            f"losses equal too; {wall:.1f} s for the {n} steps and their "
            f"checks; host-staged collectives {coll['s_per_step']:.3f} s "
            f"and {coll['gib_per_step']:.3f} GiB a step (host clock)")
        out[strategy] = {
            "runs": {k: runs[k] for k in ("sparse", "dense", "parity")},
            "dense_params": {k: q for k, q in final.items()
                             if not k.endswith("memory")},
            "wall_s": wall, "collectives": coll}
    return out


def shard_rank(mesh, oracle_path: str, check_batch: dict,
               batches: list) -> dict:
    """One rank of phases 24-28 (run by ``run_ranks``): build this rank's
    share of dlrm-rm2 from the seed, check rows 10-12 and the slab mode of
    rows 2 and 5, the sharded forward and training against the one-card
    oracle, and on rank 0 time rows 10-12.  Only rank 0 prints; the others'
    records come back to the parent."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(
            sink if mesh.rank else sys.stdout):
        return _shard_rank(torch, mesh, oracle_path, check_batch, batches)


def _shard_rank(torch, mesh, oracle_path, check_batch, batches) -> dict:
    from repro_torch.dist import collectives as col

    dev = mesh.device
    oracle = torch.load(oracle_path, mmap=True, weights_only=False)
    kernels = shard_kernels()
    t0 = time.perf_counter()
    cfg, model, bufs = build_model(torch, dev, mesh=mesh)
    rec = {"rank": mesh.rank, "device": str(dev),
           "device_name": torch.cuda.get_device_name(dev),
           "build_s": time.perf_counter() - t0,
           "backend": col.dist.get_backend(mesh.group)}
    small = check_chunk_kernels(torch, mesh, cfg, model, bufs, check_batch,
                                dev)
    big = check_chunk_kernels(torch, mesh, cfg, model, bufs, batches[0], dev)
    rec["err"] = {k: max(small["err"][k], big["err"][k]) for k in big["err"]}
    rec["forward"] = sharded_forward(torch, mesh, cfg, model, bufs,
                                     check_batch, oracle, kernels, dev)
    rec["hashed_row_forward"] = hashed_row_forward(torch, mesh, check_batch,
                                                   oracle, kernels, dev)
    torch.cuda.reset_peak_memory_stats()
    rec["train"] = train_sharded(torch, mesh, cfg, model, bufs, batches,
                                 oracle, kernels, dev)
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    rec["staged"] = dict(mesh.staged)
    rec["staged_gib"] = mesh.staged_bytes / 2**30
    rec["staged_s"] = dict(mesh.staged_s)
    col.psum(torch.zeros(1, device=dev), mesh)        # every rank is done
    if mesh.rank == 0:
        rec["res"] = measure_chunk_kernels(torch, big["inputs"],
                                           big["plain_ms"], cfg.embedding.lma)
    return rec


def run_sharded(torch, dev, kernels, card: str, tmp: str) -> dict:
    """Phases 23-28: the one-card oracle (saved in ``tmp``, where phase 34
    reads it too), then SHARD_RANKS gloo ranks on this card
    (``shard_rank``); the ranks' losses and dense parameters held equal.
    -> launch counts by path, errors and timings, and the oracle's path,
    check batch and training batches."""
    from repro_torch.dist.collectives import run_ranks

    from repro_torch.configs import get_config
    from repro_torch.configs._recsys_common import RECSYS_SHAPE_TABLE

    rng = np.random.default_rng(SEED + 40)
    cfg = get_config("dlrm-rm2").make_model()
    check_batch = draw_requests(rng, cfg.embedding.vocab_sizes, 512,
                                cfg.n_dense)
    gen = ctr_generator(cfg)
    B = RECSYS_SHAPE_TABLE["train_batch"]["batch"]
    batches = [gen.batch(B, s) for s in range(SHARD_STEPS)]
    del gen
    path = str(Path(tmp) / "oracle.pt")
    sharded_oracle(torch, dev, kernels, check_batch, batches, path)
    log(f"spawning {SHARD_RANKS} ranks (world size {SHARD_RANKS}, mesh "
        f"data=1 x model={SHARD_RANKS}) on {torch.cuda.get_device_name(0)}"
        " with the gloo backend: all_gathers of 1 MiB or more go through "
        "CUDA IPC, every other collective is staged through host memory "
        "(gloo over loopback), so the exchange times below are host-staged, "
        "not NVLink's")
    t0 = time.perf_counter()
    ranks = run_ranks(shard_rank, SHARD_RANKS, path, check_batch,
                      batches, backend="gloo", device="cuda:0")
    wall = time.perf_counter() - t0
    for r in ranks:
        log(f"rank {r['rank']}: {r['backend']} on {r['device']} "
            f"({r['device_name']}); built in {r['build_s']:.1f} s; peak "
            f"{r['peak_gib']:.2f} GiB while training; host-staged "
            f"collectives {r['staged']} ({r['staged_gib']:.2f} GiB)")
    for s in STRATEGIES:
        ref = ranks[0]["train"][s]
        for r in ranks[1:]:
            t = r["train"][s]
            for name in ("sparse", "dense"):
                if t["runs"][name]["losses"] != ref["runs"][name]["losses"]:
                    raise AssertionError(f"{s}: rank {r['rank']}'s {name} "
                                         "losses differ from rank 0's")
            for k, q in t["dense_params"].items():
                if not torch.equal(q, ref["dense_params"][k]):
                    raise AssertionError(f"{s}: rank {r['rank']}'s {k} "
                                         "differs from rank 0's")
    log(f"{SHARD_RANKS} ranks in {wall:.1f} s: losses and dense parameters "
        "bit-equal across ranks under every strategy; card " + card)
    paths = {}
    for s in STRATEGIES:
        paths[f"dlrm-rm2 sharded {s} forward (rank 0)"] = ranks[0]["forward"][s]
        for name in ("sparse", "dense"):
            paths[f"dlrm-rm2 sharded {s} train {name} (rank 0)"] = {
                k: v for k, v in ranks[0]["train"][s]["runs"][name]
                ["launches"].items() if v}
    paths["dlrm-rm2 hashed_row sharded ring forward (rank 0)"] = \
        ranks[0]["hashed_row_forward"]
    err = {k: max(r["err"][k] for r in ranks) for k in ranks[0]["err"]}
    log(f"chunk kernels, the largest over {SHARD_RANKS} ranks and both "
        f"batches: row 12 max |err| / sum |g| "
        f"{err['fused_chunk_scatter']:.4g}, row 5 (slab) "
        f"{err['fused_scatter_add']:.4g} (tol {SUM_RTOL})")
    train = {s: {"wall_s": [r["train"][s]["wall_s"] for r in ranks],
                 "collectives": [r["train"][s]["collectives"] for r in ranks],
                 **{name: {k: ranks[0]["train"][s]["runs"][name][k]
                           for k in ("losses", "steps_per_sec", "phase_ms",
                                     "peak_gib", "batch_sec")}
                    for name in ("sparse", "dense")}}
             for s in STRATEGIES}
    summary = {"ranks": SHARD_RANKS, "backend": "gloo",
               "collectives": "all_gathers of 1 MiB or more through CUDA "
                              "IPC, the rest host-staged (not NVLink)",
               "wall_s": wall,
               "peak_gib": [r["peak_gib"] for r in ranks],
               "staged": ranks[0]["staged"],
               "staged_gib": ranks[0]["staged_gib"],
               "staged_s": ranks[0]["staged_s"], "train": train}
    for s, t in train.items():
        c = t["collectives"][0]
        log(f"sharded train {s} (4 ranks on one card, gloo host-staged "
            f"collectives): sparse {t['sparse']['steps_per_sec']:.2f} "
            f"steps/s, dense {t['dense']['steps_per_sec']:.2f} steps/s; "
            f"rank 0's host-staged collectives {c['s_per_step']:.3f} s and "
            f"{c['gib_per_step']:.3f} GiB a step; "
            "phases (ms, median, rank 0) sparse "
            + ", ".join(f"{k} {v:.1f}" for k, v in
                        t["sparse"]["phase_ms"].items())
            + "; dense " + ", ".join(f"{k} {v:.1f}" for k, v in
                                     t["dense"]["phase_ms"].items()))
    return {"paths": paths, "err": err, "res": ranks[0]["res"],
            "summary": summary, "oracle": path, "check_batch": check_batch,
            "batches": batches}


# ------------------------------------- the rest of distribution (phase 34)

DIST_DATA = 2                   # the (data, model) mesh of phase 34a: (2, 2)
DIST_STRATEGIES = ("psum", "all_to_all")
DIST_STEPS = 4                  # per strategy, sparse and dense, at (2, 2)
GUARD_STEPS = 2                 # after the demotion: auto, then psum-pinned
LOSS_RTOL = 1e-5                # a loss against one card's from its state
# a state at (2, 2) against the same state elsewhere, ||got - want|| /
# ||want - start|| over each leaf (a wrong or missing update reads O(1)).
# One step from a common state: the MLPs see half batches, so only the
# rounding differs.  DIST_STEPS steps from the seed's state: Adagrad's
# sign-like early steps carry that rounding on, and the trajectories part
# (dlrm-rm2 on one H100: about 2e-2 after 4 steps, 2e-6 after one)
STATE_RTOL = 1e-3
TRAJ_RTOL = 5e-2
# the launches of freq's forward at (1, 4): the generic location lookup's
# slab-masked gathers (row 11; the ring gathers its own chunk and the three
# visiting ones), then the dot
FREQ_FORWARD = {
    "psum": {"fused_chunk_gather": 1, "dot_interaction": 1},
    "ring": {"fused_chunk_gather": SHARD_RANKS, "dot_interaction": 1},
    "all_to_all": {"fused_chunk_gather": 1, "dot_interaction": 1},
}


def world_mesh(mesh):
    """The (1, world) mesh over the same ranks: model rank = world rank."""
    import torch.distributed as dist

    from repro_torch.dist.context import Mesh
    return Mesh(model=mesh.world, rank=mesh.world_rank, device=mesh.device,
                group=dist.group.WORLD, one_card=mesh.one_card)


def planted_store(torch, e, dev):
    """The whole D' store of ``e`` planted from the seed, very sparse as in
    ``plant_store``, on the card."""
    from repro_torch.core.signatures import planted_dense_store

    store = planted_dense_store(e.total_vocab, N_CLUSTERS,
                                max_set=e.lma.max_set, seed=SEED, device=dev)
    v = torch.arange(store.n_values, device=dev)
    zero, one = v % SPARSE_PERIOD == 0, v % SPARSE_PERIOD == 1
    store.sets[zero] = -1
    store.sets[one, 1:] = -1
    store.lengths[zero] = 0
    store.lengths[one] = 1
    return store


def csr_share(torch, store, mesh, dev) -> dict:
    """The store as CSR (its rows padded to ``store_rows`` with empty sets),
    this rank's re-based part of it through ``shard_csr_buffers``."""
    from repro_torch.dist.sharded_memory import shard_csr_buffers
    from repro_torch.dist.sharding import pad_rows, store_rows

    sets, lengths = store.sets, store.lengths
    n = store_rows(lengths.numel())
    # flat filled a slice of rows at a time: a boolean index over the whole
    # store would make 16 GB of int64 indices on every rank
    flat = torch.empty(int(lengths.sum()), dtype=sets.dtype, device=dev)
    cols = torch.arange(sets.shape[1], device=dev)[None, :]
    at = 0
    for a in range(0, sets.shape[0], 1 << 20):
        part = sets[a:a + (1 << 20)][cols < lengths[a:a + (1 << 20), None]]
        flat[at:at + part.numel()] = part
        at += part.numel()
    del part
    lengths = pad_rows(lengths, n, 0)
    offsets = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    offsets[1:] = torch.cumsum(lengths, 0)
    part = shard_csr_buffers({"store_flat": flat, "store_offsets": offsets,
                              "store_lengths": lengths}, mesh)
    del flat, offsets, lengths
    return part


def state_digest(torch, params: dict, pools: bool) -> str:
    """sha256 of the pool slabs (``pools``) or of every other parameter."""
    return digest(torch, *[q for k, q in sorted(params.items())
                           if k.endswith("memory") == pools])


def host_state(torch, tr) -> dict:
    """``tr``'s flat durable state (this rank's slabs of the pool leaves),
    copied to the host."""
    from repro_torch.checkpoint.manager import _flatten

    return {k: v.detach().cpu().clone() if isinstance(v, torch.Tensor)
            else torch.from_numpy(np.array(v))
            for k, v in _flatten(tr._state()).items()}


def joined_state(torch, files: list) -> dict:
    """The ``host_state`` records in ``files`` (one a rank, in slab order)
    joined without a collective: each pool leaf's slabs concatenated, every
    other leaf the first record's."""
    from repro_torch.dist.sharding import is_pool_path

    parts = [torch.load(f, mmap=True) for f in files]
    return {k: torch.cat([p[k] for p in parts])
            if is_pool_path(k) and v.dim() >= 1 else v
            for k, v in parts[0].items()}


def same_state(torch, got: dict, want: dict, what: str):
    """Every leaf of ``got`` bit-equal to ``want``'s."""
    if set(got) != set(want):
        raise AssertionError(f"{what}: leaves {sorted(set(got) ^ set(want))} "
                             "on one side only")
    for k, v in got.items():
        a, w = v.detach().cpu(), want[k]
        if not (bits_equal(torch, a, w) if a.dtype == torch.float32
                else torch.equal(a, w)):
            raise AssertionError(f"{what}: {k} differs")


def change_rel(torch, got, want, start) -> float:
    """||got - want|| / ||want - start|| in float64: the distance from
    ``want`` relative to the change ``want`` made from ``start``."""
    num = float(torch.linalg.vector_norm(got - want, dtype=torch.float64))
    den = float(torch.linalg.vector_norm(want - start, dtype=torch.float64))
    return num / den if den > 0 else (0.0 if num == 0 else float("inf"))


def held_step(torch, got: dict, want: dict, start: dict, what: str,
              tol: float = STATE_RTOL) -> tuple:
    """Every float leaf of ``got`` within ``tol`` of ``want`` (relative to
    the change from ``start``), every other leaf equal.  -> the largest
    reading and its leaf, logged before any failure."""
    rel = {k: change_rel(torch, v.to(want[k].device), want[k],
                         start[k].to(want[k].device))
           for k, v in got.items() if v.is_floating_point()}
    leaf = max(rel, key=rel.get)
    log(f"{what}: largest ||state - want|| / ||want - start|| {rel[leaf]:.3g}"
        f" ({leaf})")
    if rel[leaf] > tol:
        raise AssertionError(f"{what}: {leaf} {rel[leaf]:.3g} from the "
                             f"reference's state, over {tol}")
    for k, v in got.items():
        if not v.is_floating_point() and not torch.equal(v.cpu(),
                                                         want[k].cpu()):
            raise AssertionError(f"{what}: {k} differs")
    return rel[leaf], leaf


def axis_snapshot(mesh) -> tuple:
    return dict(mesh.axis_bytes), dict(mesh.axis_s)


def axis_per_step(mesh, before: tuple, steps: int) -> dict:
    """Host-staged GiB and host-clock seconds a step on each axis since
    ``before``."""
    b0, s0 = before
    return {a: {"gib": (mesh.axis_bytes[a] - b0.get(a, 0)) / steps / 2**30,
                "s": (mesh.axis_s[a] - s0.get(a, 0.0)) / steps}
            for a in set(mesh.axis_bytes) | set(b0)}


def dist_freq(torch, wmesh, check_batch, batch0, kernels, dev) -> dict:
    """34b: freq dlrm-rm2 at (1, 4): its forward of the 512 batch under
    every strategy bit-equal to the one-card forward (hot ids from one
    training batch's id counts, as phase 30), with exact launches."""
    from repro_torch.dist import exchange as exl
    from repro_torch.dist.context import use_mesh

    cfg, one, _ = build_model(torch, dev, kind="freq")
    ids = global_ids(torch, cfg, batch0, dev).long()
    seen = torch.bincount(ids, minlength=cfg.embedding.total_vocab)
    del ids
    b = on_card(torch, check_batch, dev)
    with torch.no_grad():
        want = one(b, cfg.table.make_buffers(seen, device=dev)).cpu()
    del one
    free(torch)
    _, model, _ = build_model(torch, dev, kind="freq", mesh=wmesh)
    bufs = cfg.table.make_buffers(seen, mesh=wmesh, device=dev)
    out = {}
    for strategy in STRATEGIES:
        zero(kernels)
        exl.FORCED = strategy
        with torch.no_grad(), use_mesh(wmesh):
            logits = model(b, bufs).cpu()
        exl.FORCED = None
        got = counts(kernels)
        if got != FREQ_FORWARD[strategy]:
            raise AssertionError(f"freq {strategy} forward launched {got}")
        if not bits_equal(torch, logits, want):
            raise AssertionError(f"rank {wmesh.rank}: freq {strategy} logits "
                                 "differ from one card's")
        out[strategy] = got
    log(f"34b freq dlrm-rm2 at (1, {wmesh.model}): the 512 forward bit-equal "
        f"to one card's under {', '.join(STRATEGIES)}; launches {out}")
    del model, bufs
    free(torch)
    return out


def dist_csr(torch, wmesh, cfg, model, dbufs, cbufs, check_batch, oracle,
             kernels, dev) -> dict:
    """34c: LMA dlrm-rm2 at (1, 4) with the CSR store sharded: the 512
    forward under every strategy bit-equal to the dense store's (and to the
    one-card oracle's logits), exact launches for both."""
    from repro_torch.dist import exchange as exl
    from repro_torch.dist.context import use_mesh

    b = on_card(torch, check_batch, dev)
    out = {"ms": {}}
    for strategy in STRATEGIES:
        got = {}
        for name, bufs in (("dense", dbufs), ("csr", cbufs)):
            zero(kernels)
            exl.FORCED = strategy
            with torch.no_grad(), use_mesh(wmesh):
                got[name], ms = events_ms(torch, lambda: model(b, bufs))
            exl.FORCED = None
            launched = counts(kernels)
            if launched != SHARD_FORWARD[strategy]:
                raise AssertionError(f"csr: the {name} store's {strategy} "
                                     f"forward launched {launched}")
            out["ms"][f"{strategy} {name}"] = ms
        if not (bits_equal(torch, got["csr"], got["dense"])
                and torch.equal(got["csr"].cpu(), oracle["logits"])):
            raise AssertionError(f"rank {wmesh.rank}: the CSR store's "
                                 f"{strategy} forward differs")
        out[strategy] = launched
    out["csr_bytes"] = int(sum(v.numel() * 4 for v in cbufs.values()))
    out["dense_bytes"] = int(sum(v.numel() * 4 for v in dbufs.values()))
    log(f"34c LMA dlrm-rm2 at (1, {wmesh.model}) with the CSR store sharded "
        f"({out['csr_bytes'] / 2**30:.2f} GiB on this rank against "
        f"{out['dense_bytes'] / 2**30:.2f} GiB dense): the 512 forward "
        f"bit-equal to the dense store's and the oracle's under "
        f"{', '.join(STRATEGIES)}; forward ms "
        + ", ".join(f"{k} {v:.1f}" for k, v in out["ms"].items()))
    return out


def dist_trainer(torch, cfg, model, bufs, batches, dev, sparse: bool = True,
                 ckpt_dir=None):
    from repro_torch.configs import get_config
    from repro_torch.launch.train import lookups_per_step, make_optimizer
    from repro_torch.models.recsys import loss_fn
    from repro_torch.train.trainer import Trainer, TrainerConfig

    B = batches[0]["label"].shape[0]
    return Trainer(TrainerConfig(total_steps=0, log_every=0,
                                 ckpt_dir=ckpt_dir, ckpt_every=10**6,
                                 async_ckpt=False,
                                 lookups_per_step=lookups_per_step(cfg, B)),
                   lambda m, b: loss_fn(m, b, bufs), model,
                   make_optimizer(get_config("dlrm-rm2")),
                   lambda step: batches[step], sparse_grads=sparse,
                   device=dev)


def run_steps(torch, tr, mesh, first: int, steps: int) -> list:
    """Steps ``first + 1 .. first + steps`` of ``tr`` under ``mesh``; the
    losses."""
    from repro_torch.dist.context import use_mesh

    losses = []
    with use_mesh(mesh):
        for n in range(first + 1, first + steps + 1):
            tr.step, tr.cfg.total_steps = n - 1, n
            losses.append(tr.fit(log=lambda _: None)["loss"])
    return losses


def dist_guard(torch, wmesh, cfg, model, bufs, check_batch, batches,
               kernels, dev) -> dict:
    """34d: an injected drop_chunk: the ExchangeGuard, probing the 512
    batch's lookup under each strategy, demotes all_to_all, then ring; the
    cost model's training then takes psum (exact launches) and its
    GUARD_STEPS steps are bit-equal to a psum-pinned run from the same
    state."""
    from repro_torch.dist import exchange as exl
    from repro_torch.dist.context import use_mesh
    from repro_torch.resilience import faults as flt
    from repro_torch.resilience.exchange_guard import ExchangeGuard
    from repro_torch.resilience.health import Health

    params = dict(model.named_parameters())
    with torch.no_grad():
        init = {k: q.detach().clone() for k, q in params.items()}
    ids = torch.from_numpy(check_batch["sparse"]).to(dev)

    def probe(name):
        exl.FORCED = name
        try:
            with torch.no_grad():
                return cfg.table.embed_fields(dict(model.embedding), bufs,
                                              ids)
        finally:
            exl.FORCED = None

    exl.reset_demotions()
    flt.install(flt.FaultInjector("drop_chunk@0"))
    try:
        health = Health()
        t0 = time.perf_counter()
        with use_mesh(wmesh):
            final = ExchangeGuard(probe, health=health, log=log).validate()
        guard_s = time.perf_counter() - t0
        if final != "psum" or set(exl.DEMOTED) != {"all_to_all", "ring"}:
            raise AssertionError(f"guard: {final}, demoted {exl.DEMOTED}")
        runs = {}
        for name, forced in (("auto", None), ("psum", "psum")):
            with torch.no_grad():
                for k, q in params.items():
                    q.copy_(init[k])
            exl.FORCED = forced
            zero(kernels)
            tr = dist_trainer(torch, cfg, model, bufs, batches, dev)
            losses = run_steps(torch, tr, wmesh, 0, GUARD_STEPS)
            exl.FORCED = None
            runs[name] = {"losses": losses, "launches": counts(kernels),
                          "pools": state_digest(torch, params, True),
                          "dense": state_digest(torch, params, False)}
            del tr
        want = {k: v * GUARD_STEPS
                for k, v in SHARD_STEP["psum"]["sparse"].items()}
        if runs["auto"]["launches"] != want:
            raise AssertionError(f"guard: after the demotion the run launched "
                                 f"{runs['auto']['launches']}, not psum's "
                                 f"{want}")
        if runs["auto"] != runs["psum"]:
            raise AssertionError(f"guard: training after the demotion differs "
                                 f"from the psum-pinned run: {runs}")
    finally:
        flt.install(None)
        exl.reset_demotions()
        exl.FORCED = None
        with torch.no_grad():
            for k, q in params.items():
                q.copy_(init[k])
    out = {"final": final, "health": health.as_dict(), "guard_s": guard_s,
           "losses": runs["auto"]["losses"],
           "launches": runs["auto"]["launches"]}
    log(f"34d exchange guard at (1, {wmesh.model}) under drop_chunk@0: "
        f"demoted all_to_all, then ring, to {final} "
        f"({health.exchange_demotions} demotions, {health.retries} retries, "
        f"{guard_s:.2f} s); {GUARD_STEPS} sparse steps after it bit-equal to "
        f"psum-pinned ones (losses {runs['auto']['losses']}); launches "
        f"{runs['auto']['launches']}")
    return out


def rank_files(root: str, step: int, ranks) -> list:
    """Where the (1, 4) ranks ``ranks`` keep their host state after
    ``step``."""
    return [os.path.join(root + "-ranks", f"step{step}-{r}.pt")
            for r in ranks]


def dist_checkpoint(torch, wmesh, cfg, model, bufs, batches, root, dev
                    ) -> dict:
    """34e (at (1, 4)): one sparse step, a save gathered to rank 0 and
    written there, one more step (the uninterrupted run's step 2), each
    rank's own state after steps 1 and 2 kept on the host's disk
    (``rank_files``); on rank 0, the save restored on one process on the
    card, every leaf bit-equal to the ranks' step-1 slabs joined.  -> times,
    the step-2 loss for 34a's resume at (2, 2)."""
    from repro_torch.checkpoint.manager import CheckpointManager, _flatten
    from repro_torch.dist import collectives as col
    from repro_torch.dist.context import use_mesh
    from repro_torch.models.recsys import Recsys

    os.makedirs(root + "-ranks", exist_ok=True)
    tr = dist_trainer(torch, cfg, model, bufs, batches, dev)
    run_steps(torch, tr, wmesh, 0, 1)
    torch.save(host_state(torch, tr), rank_files(root, 1, [wmesh.rank])[0])
    tr.mgr = CheckpointManager(root)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with use_mesh(wmesh):
        tr.save(blocking=True)
    save_s = time.perf_counter() - t0
    out = {"save_s": save_s,
           "save_split_s": dict(tr.mgr.last_save_seconds),
           "save_gib": tr.mgr.bytes_written / 2**30}
    tr.mgr = None
    out["loss2"] = run_steps(torch, tr, wmesh, 1, 1)[0]
    torch.save(host_state(torch, tr), rank_files(root, 2, [wmesh.rank])[0])
    del tr
    free(torch)
    col.barrier(wmesh)
    if wmesh.rank == 0:
        gen = torch.Generator(device=dev).manual_seed(SEED)
        whole = Recsys(cfg, gen, device=dev)
        one = dist_trainer(torch, cfg, whole, {}, batches, dev, ckpt_dir=root)
        t0 = time.perf_counter()
        if not one.try_resume() or one.step != 1:
            raise AssertionError("one process did not resume step 1")
        out["restore_one_s"] = time.perf_counter() - t0
        got = {k: v if isinstance(v, torch.Tensor)
               else torch.from_numpy(np.asarray(v))
               for k, v in _flatten(one._state()).items()}
        same_state(torch, got, joined_state(
            torch, rank_files(root, 1, range(wmesh.model))),
            "one-process restore against the ranks' step-1 slabs")
        out["leaves"] = len(got)
        out["ckpt_gib"] = dir_bytes(root) / 2**30
        del one, whole, got
        free(torch)
        log(f"34e checkpoint at (1, {wmesh.model}): save (gathered to rank 0, "
            f"{out['save_gib']:.2f} GiB written) {save_s:.2f} s (rank 0's "
            f"snapshot {out['save_split_s'].get('snapshot', 0):.2f} s, write "
            f"{out['save_split_s'].get('write', 0):.2f} s); restored on "
            f"one process on the card in {out['restore_one_s']:.2f} s, "
            f"{out['leaves']} leaves bit-equal to the {wmesh.model} ranks' "
            "own step-1 slabs, joined")
    col.barrier(wmesh)
    return out


def one_card_loss(torch, mesh, one, model, batch, dev) -> float | None:
    """The whole batch's loss on one card from this (data, model) rank's
    state: the pool's slabs gathered over 'model' (every rank takes part)
    and the dense parameters (the same on every rank) copied into
    ``one``, a (cfg, model, bufs) built with no mesh (its D' store whole),
    whose forward runs with no mesh installed, as one card runs it.  ->
    the loss where ``one`` is given (world rank 0), else None."""
    from repro_torch.dist import collectives as col
    from repro_torch.models.recsys import loss_fn

    with torch.no_grad():
        pool = col.all_gather(model.embedding["memory"].detach(), mesh,
                              "model")
        if one is None:
            return None
        _cfg, twin, bufs = one
        mine = dict(model.named_parameters())
        for k, q in twin.named_parameters():
            w = pool.reshape(-1, *q.shape[1:])[:q.shape[0]] \
                if k == POOL else mine[k]
            if w.shape != q.shape:
                raise AssertionError(f"one-card loss: {k} {tuple(w.shape)} "
                                     f"against {tuple(q.shape)}")
            q.copy_(w)
        return float(loss_fn(twin, on_card(torch, batch, dev), bufs)[0])


def dist_data(torch, mesh, check_batch, batches, oracle, kernels, dev,
              root: str, loss2: float) -> dict:
    """34a at (data=2, model=2): dlrm-rm2's pool and D' store sharded over
    'model', each batch split over 'data'.  The 512 batch's lookup share
    bit-equal to the oracle's rows, its logits within LOSS_RTOL of the
    oracle's largest; sparse and dense Adagrad, DIST_STEPS steps each from
    the seed's state under psum and all_to_all with exact launches, each
    step's loss within LOSS_RTOL of the one-card loss from the same state
    (``one_card_loss``, on world rank 0; every rank's losses are
    bit-equal, ``run_distribution``), the losses and the final slab and dense
    parameters within TRAJ_RTOL of the oracle's (its sparse run); then the
    (1, 4) checkpoint resumed here, bit-equal to the (1, 4) ranks' step-1
    state, and one step within LOSS_RTOL (loss) and STATE_RTOL (state) of
    the uninterrupted run's."""
    from repro_torch.dist import exchange as exl
    from repro_torch.dist.context import use_mesh
    from repro_torch.dist.sharded_memory import local_batch

    t0 = time.perf_counter()
    cfg, model, bufs = build_model(torch, dev, mesh=mesh)
    rec = {"build_s": time.perf_counter() - t0, "forward": {}, "train": {}}
    share = {k: local_batch(v, mesh) for k, v in check_batch.items()}
    c = share["sparse"].shape[0]
    lo = mesh.data_rank * c
    b = on_card(torch, share, dev)
    for strategy in DIST_STRATEGIES:
        exl.FORCED = strategy
        with torch.no_grad(), use_mesh(mesh):
            lookup = cfg.table.embed_fields(dict(model.embedding), bufs,
                                            b["sparse"]).cpu()
            zero(kernels)
            logits = model(b, bufs).cpu()
            launched = counts(kernels)
        exl.FORCED = None
        if launched != SHARD_FORWARD[strategy]:
            raise AssertionError(f"(2, 2) {strategy} forward launched "
                                 f"{launched}")
        if not bits_equal(torch, lookup, oracle["lookup"][lo:lo + c]):
            raise AssertionError(f"rank {mesh.world_rank}: the (2, 2) lookup "
                                 f"under {strategy} differs from the oracle's")
        # the MLPs see 256 rows here and 512 there, so their sums may round
        # differently: held normwise (max |diff| / max |logit|)
        want = oracle["logits"][lo:lo + c]
        rel = float((logits - want).abs().max() / want.abs().max())
        if rel > LOSS_RTOL:
            raise AssertionError(f"(2, 2) {strategy} logits {rel:.3g} from "
                                 "the oracle's")
        rec["forward"][strategy] = {"launches": launched, "logit_rel": rel,
                                    "bit_equal": torch.equal(logits, want)}
    log(f"34a (2, 2) forward of the 512 batch (256 rows a data index): the "
        f"lookup bit-equal to the one-card oracle's rows under "
        f"{', '.join(DIST_STRATEGIES)}; logits within "
        + ", ".join(f"{s} {r['logit_rel']:.3g}"
                    for s, r in rec["forward"].items())
        + f" of the oracle's largest; launches per rank "
        f"{ {s: r['launches'] for s, r in rec['forward'].items()} }")
    params = dict(model.named_parameters())
    with torch.no_grad():
        init = {k: q.detach().clone() for k, q in params.items()}
    base, m_local = slab_of(mesh, cfg.embedding.lma.m)
    # the one-card model each step's loss is held to (world rank 0)
    one = build_model(torch, dev) if mesh.world_rank == 0 else None
    torch.cuda.reset_peak_memory_stats()
    for strategy in DIST_STRATEGIES:
        for name in ("sparse", "dense"):
            with torch.no_grad():
                for k, q in params.items():
                    q.copy_(init[k])
            exl.FORCED = strategy
            tr = dist_trainer(torch, cfg, model, bufs, batches, dev,
                              sparse=name == "sparse")
            zero(kernels)
            before = axis_snapshot(mesh)
            losses, common, side, wall = [], [], {}, 0.0
            for k in range(DIST_STEPS):
                # the one-card loss from this state (the slabs gathered
                # into a model with no mesh), its launches set aside
                c0 = counts(kernels)
                common.append(one_card_loss(torch, mesh, one, model,
                                            batches[k], dev))
                for n_, v in counts(kernels).items():
                    side[n_] = side.get(n_, 0) + v - c0.get(n_, 0)
                t0 = time.perf_counter()
                losses += run_steps(torch, tr, mesh, k, 1)
                wall += time.perf_counter() - t0
            exl.FORCED = None
            launched = {n_: v - side.get(n_, 0)
                        for n_, v in counts(kernels).items()
                        if v - side.get(n_, 0)}
            want = {k: v * DIST_STEPS
                    for k, v in SHARD_STEP[strategy][name].items()}
            if launched != want:
                raise AssertionError(f"(2, 2) {strategy} {name} launched "
                                     f"{launched}, expected {want}")
            # each step's loss within LOSS_RTOL of the one-card loss from
            # the same state; the trajectory, from the seed's state, within
            # TRAJ_RTOL of the one-card oracle's (4 steps of rounding apart)
            rel = max(abs(a - w) / abs(w) for a, w in zip(losses, common)) \
                if one is not None else float("nan")
            ref = oracle["losses"][name]
            traj = max(abs(a - w) / abs(w) for a, w in zip(losses, ref))
            if not np.isfinite(losses).all() or rel > LOSS_RTOL:
                raise AssertionError(f"(2, 2) {strategy} {name} losses "
                                     f"{losses} against the one-card losses "
                                     f"from the same states {common}")
            if traj > TRAJ_RTOL:
                raise AssertionError(f"(2, 2) {strategy} {name} losses "
                                     f"{losses} against one card's {ref}")
            # the last step's update, which no loss sees: the final slab
            # and dense parameters against the oracle's (its sparse run)
            with torch.no_grad():
                state_rel = held_step(
                    torch, {k: q.detach() for k, q in params.items()},
                    {k: (w[base:base + m_local] if k.endswith("memory")
                         else w).to(dev)
                     for k, w in oracle["params"].items()}, init,
                    f"34a (2, 2) {strategy} {name}, rank {mesh.world_rank}: "
                    f"after {DIST_STEPS} steps against the oracle's",
                    TRAJ_RTOL)
            r = rec["train"][f"{strategy} {name}"] = {
                "losses": losses, "loss_rel": rel, "launches": launched,
                "common_losses": common, "traj_rel": traj,
                "state_rel": state_rel, "wall_s": wall, **tr.throughput(),
                "axes": axis_per_step(mesh, before, DIST_STEPS),
                "pools": state_digest(torch, params, True),
                "dense": state_digest(torch, params, False)}
            B = batches[0]["label"].shape[0]
            log(f"34a (2, 2) {strategy} {name}: {DIST_STEPS} steps at "
                f"B={B} ({B // mesh.data} a data index), "
                f"each loss within {rel:.3g} of the one-card loss from the "
                f"same state (the trajectory {traj:.3g} from one card's), "
                f"the final state "
                f"within {state_rel[0]:.3g} ({state_rel[1]}) of its; "
                f"{r['steps_per_sec']:.2f} steps/s; host-staged a step "
                + ", ".join(f"{a} {v['s']:.3f} s / {v['gib']:.3f} GiB"
                            for a, v in sorted(r["axes"].items()))
                + f"; launches {launched}")
            del tr
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    # the (1, 4) checkpoint resumed here: one further step
    with torch.no_grad():
        for k, q in params.items():
            q.copy_(init[k])
    tr = dist_trainer(torch, cfg, model, bufs, batches, dev, ckpt_dir=root)
    t0 = time.perf_counter()
    with use_mesh(mesh):
        if not tr.try_resume() or tr.step != 1:
            raise AssertionError("(2, 2) did not resume step 1")
    rec["restore_s"] = time.perf_counter() - t0
    tr.mgr = None
    # the (1, 4) ranks whose slabs make up this rank's
    mine = range(mesh.rank * mesh.data, (mesh.rank + 1) * mesh.data)
    want1 = joined_state(torch, rank_files(root, 1, mine))
    same_state(torch, host_state(torch, tr), want1,
               f"(2, 2) restore, rank {mesh.world_rank}, against the (1, 4) "
               "ranks' step-1 state")
    rec["resumed_loss2"] = run_steps(torch, tr, mesh, 1, 1)[0]
    rel = abs(rec["resumed_loss2"] - loss2) / abs(loss2)
    if rel > LOSS_RTOL:
        raise AssertionError(f"(2, 2) resumed step 2 loss "
                             f"{rec['resumed_loss2']} against the "
                             f"uninterrupted {loss2}")
    rec["resumed_rel"] = held_step(
        torch, host_state(torch, tr),
        joined_state(torch, rank_files(root, 2, mine)), want1,
        f"34e (2, 2) resumed step 2, rank {mesh.world_rank}, against the "
        "uninterrupted (1, 4) run's")
    log(f"34e the (1, 4) checkpoint restored at (2, 2) in "
        f"{rec['restore_s']:.2f} s, every leaf (pool slabs, Adagrad "
        f"accumulators, dense parameters, step) bit-equal to the (1, 4) "
        f"ranks' step-1 state; its step 2 loss {rec['resumed_loss2']:.6f} "
        f"within {rel:.3g} of the uninterrupted (1, 4) run's {loss2:.6f}, "
        f"its state within {rec['resumed_rel'][0]:.3g} "
        f"({rec['resumed_rel'][1]}) of that run's step-2 state")
    rec["axis_totals"] = {"bytes": dict(mesh.axis_bytes),
                          "s": dict(mesh.axis_s)}
    del tr, model, bufs, init, params, one
    free(torch)
    return rec


def dist_rank(mesh, oracle_path: str, check_batch: dict, batches: list,
              root: str) -> dict:
    """One rank of phase 34 (``run_ranks`` with data=2): the (1, 4) parts
    on the world mesh (freq, the CSR store, the exchange guard, the sharded
    checkpoint), then the (2, 2) part.  Only world rank 0 prints."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(
            sink if mesh.world_rank else sys.stdout):
        return _dist_rank(torch, mesh, oracle_path, check_batch, batches,
                          root)


def _dist_rank(torch, mesh, oracle_path, check_batch, batches, root) -> dict:
    from repro_torch.dist import collectives as col

    dev = mesh.device
    oracle = torch.load(oracle_path, mmap=True, weights_only=False)
    kernels = shard_kernels()
    wmesh = world_mesh(mesh)
    rec = {"rank": mesh.world_rank, "mesh": (mesh.data, mesh.model,
                                            mesh.data_rank, mesh.rank)}
    rec["freq"] = dist_freq(torch, wmesh, check_batch, batches[0], kernels,
                            dev)
    # LMA at (1, 4): the dense store's rows and the CSR store's part, both
    # cut from one planted store
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import pad_rows, store_rows
    from repro_torch.models.recsys import Recsys

    t0 = time.perf_counter()
    cfg = get_config("dlrm-rm2").make_model()
    model = Recsys(cfg, torch.Generator(device=dev).manual_seed(SEED),
                   device=dev, mesh=wmesh).eval()
    store = planted_store(torch, cfg.embedding, dev)
    c = store_rows(store.n_values) // wmesh.model
    lo, hi = wmesh.rank * c, min((wmesh.rank + 1) * c, store.n_values)
    dbufs = {"store_sets": pad_rows(store.sets[lo:hi], c, -1),
             "store_lengths": pad_rows(store.lengths[lo:hi], c, 0)}
    cbufs = csr_share(torch, store, wmesh, dev)
    del store
    free(torch)
    rec["build_14_s"] = time.perf_counter() - t0
    rec["csr"] = dist_csr(torch, wmesh, cfg, model, dbufs, cbufs,
                          check_batch, oracle, kernels, dev)
    del cbufs
    free(torch)
    rec["guard"] = dist_guard(torch, wmesh, cfg, model, dbufs, check_batch,
                              batches, kernels, dev)
    rec["ckpt"] = dist_checkpoint(torch, wmesh, cfg, model, dbufs, batches,
                                  root, dev)
    rec["staged_14"] = {"bytes": dict(wmesh.axis_bytes),
                        "s": dict(wmesh.axis_s)}
    del cfg, model, dbufs
    free(torch)
    rec["data"] = dist_data(torch, mesh, check_batch, batches, oracle,
                            kernels, dev, root, rec["ckpt"]["loss2"])
    col.barrier(mesh)
    return rec


def run_distribution(torch, card: str, shard: dict, tmp: str) -> dict:
    """Phase 34: SHARD_RANKS gloo ranks on this card as a (data=DIST_DATA,
    model=SHARD_RANKS / DIST_DATA) mesh (``dist_rank``); replicas held
    bit-equal.  -> launches by path and a summary."""
    from repro_torch.dist.collectives import run_ranks

    root = str(Path(tmp) / "dist-ckpt")
    log(f"34: spawning {SHARD_RANKS} ranks as a (data={DIST_DATA}, model="
        f"{SHARD_RANKS // DIST_DATA}) mesh on {torch.cuda.get_device_name(0)}"
        " (gloo: all_gathers of 1 MiB or more through CUDA IPC, every other "
        "collective staged through host memory, not NVLink)")
    t0 = time.perf_counter()
    ranks = run_ranks(dist_rank, SHARD_RANKS, shard["oracle"],
                      shard["check_batch"], shard["batches"], root,
                      data=DIST_DATA, backend="gloo", device="cuda:0")
    wall = time.perf_counter() - t0
    P = SHARD_RANKS // DIST_DATA
    r0 = ranks[0]
    for run, t in r0["data"]["train"].items():
        for r in ranks:
            o = r["data"]["train"][run]
            if o["losses"] != t["losses"] or o["dense"] != t["dense"]:
                raise AssertionError(f"34a {run}: rank {r['rank']}'s losses "
                                     "or dense parameters differ from rank "
                                     "0's")
            twin = ranks[r["mesh"][3]]["data"]["train"][run]
            if o["pools"] != twin["pools"]:
                raise AssertionError(f"34a {run}: rank {r['rank']}'s slab "
                                     "differs from its replica's")
    for r in ranks:
        log(f"34 rank {r['rank']} (data {r['mesh'][2]}, model {r['mesh'][3]})"
            f": peak {r['data']['peak_gib']:.2f} GiB in the (2, 2) training; "
            f"(2, 2) host-staged totals "
            + ", ".join(f"{a} {b / 2**30:.2f} GiB / "
                        f"{r['data']['axis_totals']['s'][a]:.2f} s"
                        for a, b in sorted(
                            r["data"]["axis_totals"]["bytes"].items())))
    log(f"34: {SHARD_RANKS} ranks in {wall:.1f} s: losses and dense "
        "parameters bit-equal on every rank, each slab bit-equal to its "
        "replica's; card " + card)
    paths = {}
    for s, f in r0["data"]["forward"].items():
        paths[f"dlrm-rm2 (2, 2) {s} forward (rank 0)"] = f["launches"]
    for run, t in r0["data"]["train"].items():
        paths[f"dlrm-rm2 (2, 2) {run} (rank 0)"] = t["launches"]
    for s, c in r0["freq"].items():
        paths[f"dlrm-rm2 freq (1, 4) {s} forward (rank 0)"] = c
    for s in STRATEGIES:
        paths[f"dlrm-rm2 csr (1, 4) {s} forward (rank 0)"] = r0["csr"][s]
    paths["dlrm-rm2 (1, 4) after demotion train (rank 0)"] = \
        r0["guard"]["launches"]
    summary = {
        "mesh": f"data={DIST_DATA} x model={P} (and (1, {SHARD_RANKS}))",
        "ranks": SHARD_RANKS, "backend": "gloo",
        "collectives": "all_gathers of 1 MiB or more through CUDA IPC, the "
                       "rest host-staged (not NVLink)", "wall_s": wall,
        "peak_gib": [r["data"]["peak_gib"] for r in ranks],
        "train": {run: {k: t[k] for k in ("losses", "loss_rel", "state_rel",
                                          "steps_per_sec", "batch_sec",
                                          "wall_s", "axes")}
                  for run, t in r0["data"]["train"].items()},
        "forward": r0["data"]["forward"],
        "build_s": {"(2, 2)": r0["data"]["build_s"],
                    "(1, 4)": r0["build_14_s"]},
        "csr": {k: r0["csr"][k] for k in ("ms", "csr_bytes", "dense_bytes")},
        "guard": {k: r0["guard"][k] for k in ("final", "health", "guard_s",
                                              "losses")},
        "checkpoint": {**{k: v for k, v in r0["ckpt"].items()
                          if k != "bytes"},
                       "restore_22_s": r0["data"]["restore_s"],
                       "resumed_loss2": r0["data"]["resumed_loss2"],
                       "resumed_rel": max(r["data"]["resumed_rel"]
                                          for r in ranks)},
    }
    for run, t in summary["train"].items():
        worst = max(r["data"]["train"][run]["state_rel"] for r in ranks)
        log(f"34a (2, 2) {run}: {t['steps_per_sec']:.2f} steps/s; final "
            f"state within {worst[0]:.3g} ({worst[1]}) of the oracle's on "
            "every rank; host-staged a step (rank 0) "
            + ", ".join(f"{a} {v['s']:.3f} s / {v['gib']:.3f} GiB"
                        for a, v in sorted(t["axes"].items())))
    return {"paths": paths, "summary": summary}


# ------------------------------------- durability on full-width dlrm-rm2

# The soak: 24 steps at B=65,536, a boundary every 4 steps, and one fault
# of each kind after the first boundary.  nan_grad@6 skips a step and rolls
# back to step 4; preempt@9 saves step 9 and restarts; torn_ckpt@11 tears
# the boundary save at step 12; rot_row@14 rots the pool (a step that reads
# it skips and rolls back, or the boundary scan at 16 finds it and rolls
# back), and the restore routes around the torn step 12; read_fail@17 fails
# the next host read, the restart after preempt@19, which falls back from
# step 19 to 16 (3 steps lost).
DUR_STEPS, DUR_EVERY = 24, 4
DUR_SPEC = ("nan_grad@6,preempt@9,torn_ckpt@11,rot_row@14:8,read_fail@17,"
            "preempt@19")
GUARD_TIMED_STEPS = 6           # guarded and unguarded steps, alternated
LAUNCHER_FAULTS = "nan_grad@50,rot_row@120:8"


def dir_bytes(path: str) -> int:
    total = 0
    for base, _, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(base, f))
            except OSError:         # removed by the manager's GC meanwhile
                pass
    return total


class DiskPeak:
    """The largest size a directory reached, sampled every 50 ms while
    active (checkpoints are written in a background thread)."""

    def __init__(self, path: str):
        import threading
        self.path, self.peak = path, 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.wait(0.05):
            self.peak = max(self.peak, dir_bytes(self.path))

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, dir_bytes(self.path))


def state_tensors(torch, trainer) -> list:
    """The parameters and optimizer moments of a Trainer, as tensors (the
    checkpoint's leaves but the step counters)."""
    from repro_torch.checkpoint.manager import _flatten
    return [v for _, v in sorted(_flatten(trainer._state()).items())
            if isinstance(v, torch.Tensor)]


def dirty_chunks(ckpt_dir: str, step: int) -> dict:
    with open(os.path.join(ckpt_dir, f"step_{step:010d}",
                           "manifest.json")) as f:
        man = json.load(f)
    return {k: len(v["chunks"]) for k, v in man.get("delta", {}).items()}


def durability_guard(torch, make, kernels, card) -> dict:
    """Part a: two poisoned steps skipped with the state bit-unchanged
    (by digest) and no row 7; a clean guarded step bit-identical to an
    unguarded one from the same state; guarded and unguarded steps/s."""
    from repro_torch.resilience.faults import FaultInjector

    tr = make(total_steps=1, timer=True)
    tr.fit(log=lambda _: None)                     # a clean step 0
    t0 = time.perf_counter()
    before = digest(torch, *state_tensors(torch, tr))
    digest_s = time.perf_counter() - t0
    state_bytes = sum(x.numel() * x.element_size()
                      for x in state_tensors(torch, tr))
    tr.faults = FaultInjector("nan_grad@1,huge_grad@2")
    skipped = {}
    for step, fault in ((1, "nan_grad"), (2, "huge_grad")):
        zero(kernels)
        tr.cfg.total_steps = step + 1
        tr.fit(log=lambda _: None)
        launched = counts(kernels)
        after = digest(torch, *state_tensors(torch, tr))
        want = {"fused_embed": 1, "dot_interaction": 1, "fused_locations": 1}
        if after != before or launched != want:
            raise AssertionError(
                f"guard: the {fault} step at {step} launched {launched} "
                f"(expected {want}) and left digest {after} (before "
                f"{before})")
        skipped[fault] = {"launches": launched, "digest": after}
    if (tr.health.skipped_steps, tr.health.nonfinite_grads) != (2, 2):
        raise AssertionError(f"guard: health {tr.health.as_dict()}")
    # a clean step from one state, guarded and unguarded
    with torch.no_grad():
        s0 = [x.detach().clone() for x in state_tensors(torch, tr)]
    tr.cfg.total_steps = 4
    tr.fit(log=lambda _: None)
    with torch.no_grad():
        guarded = [x.detach().clone() for x in state_tensors(torch, tr)]
    un = make(total_steps=4, guard_step=False, reset=False)
    with torch.no_grad():
        for x, y in zip(state_tensors(torch, tr), s0):
            x.copy_(y)
    un.opt_state = clone_state(torch, tr.opt_state)
    un.step = 3
    un.fit(log=lambda _: None)
    if not all(bits_equal(torch, a.float(), b.float()) if a.is_floating_point()
               else torch.equal(a, b)
               for a, b in zip(guarded, state_tensors(torch, un))):
        raise AssertionError("guard: a clean guarded step differs from the "
                             "unguarded step from the same state")
    del s0, guarded
    # steps/s, alternated: each trainer times its own steps
    for t in (tr, un):
        t._step_times.clear()
    for n in range(5, 5 + GUARD_TIMED_STEPS):
        for t in (tr, un):
            t.step, t.cfg.total_steps = n - 1, n
            t.fit(log=lambda _: None)
    g, u = tr.throughput()["steps_per_sec"], un.throughput()["steps_per_sec"]
    phase = tr.timer.split_ms()
    out = {"skipped": skipped, "digest_before": before,
           "digest_seconds": digest_s, "state_bytes": state_bytes,
           "clean_guarded_equals_unguarded": True,
           "guarded_steps_per_sec": g, "unguarded_steps_per_sec": u,
           "guard_ms": phase.get("guard"), "phase_ms": phase}
    log(f"durability guard: nan_grad and huge_grad steps skipped, state "
        f"digest {before} unchanged (a digest of the {state_bytes:,} B "
        f"state {digest_s:.2f} s), launches a skipped step {want} (no "
        f"sparse_adagrad); a clean guarded step bit-identical to the "
        f"unguarded step from the same state; {g:.2f} guarded / {u:.2f} "
        f"unguarded steps/s ({GUARD_TIMED_STEPS} each, alternated), the "
        f"guard's own phase {phase.get('guard', 0.0):.3f} ms; card {card}")
    return out


def durability_checkpoint(torch, make, root: str, card) -> dict:
    """Part b: a base save of the durable state after one step, a restore
    into a fresh Trainer bit-identical to it, one more step and a delta
    save; bytes, the save's snapshot and background-write seconds, restore
    and verify seconds, dirty chunks per pool leaf."""
    from repro_torch.resilience.chaos import (durable_state,
                                              states_bit_identical)

    ck = os.path.join(root, "checkpoint")
    kw = dict(ckpt_dir=ck, ckpt_every=1, ckpt_delta=True, keep=3)
    t1 = make(total_steps=1, **kw)
    t1.fit(log=lambda _: None)          # step 0; async base save at 1
    mgr = t1.mgr
    base = {"step": 1, "bytes": mgr.last_save_bytes,
            **{f"{k}_s": v for k, v in mgr.last_save_seconds.items()}}
    saved = durable_state(t1)
    t2 = make(total_steps=2, verify_pool=False, **kw)
    t0 = time.perf_counter()
    if not t2.try_resume():
        raise AssertionError("checkpoint: nothing to resume from")
    restore_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    t2._verify_pool()
    torch.cuda.synchronize()
    verify_s = time.perf_counter() - t0
    if not states_bit_identical(durable_state(t2), saved):
        raise AssertionError("checkpoint: the restored state differs from "
                             "the state saved")
    t2.cfg.verify_pool = True
    t2.fit(log=lambda _: None)          # resumes again, step 1; delta at 2
    delta = {"step": 2, "bytes": t2.mgr.last_save_bytes,
             "dirty_chunks": dirty_chunks(ck, 2),
             **{f"{k}_s": v for k, v in t2.mgr.last_save_seconds.items()}}
    n_chunks = -(-t1.params["embedding.memory"].numel() // 8192)
    out = {"base": base, "delta": delta, "restore_s": restore_s,
           "manager_restore_s": t2.mgr.last_restore_seconds,
           "verify_s": verify_s, "chunks_per_pool_leaf": n_chunks,
           "state_bytes": sum(v.nbytes for v in saved.values())}
    log(f"durability checkpoint: base save {base['bytes']:,} B "
        f"(state {out['state_bytes']:,} B), snapshot "
        f"{base['snapshot_s']:.2f} s + background write "
        f"{base['write_s']:.2f} s; restore into a fresh Trainer "
        f"{restore_s:.2f} s, bit-identical, verify scan {verify_s:.3f} s; "
        f"delta after one step {delta['bytes']:,} B, snapshot "
        f"{delta['snapshot_s']:.2f} s + write {delta['write_s']:.2f} s, "
        f"dirty chunks {delta['dirty_chunks']} of {n_chunks} a pool leaf; "
        f"card {card}")
    return out


def durability_soak(torch, make, root: str, B: int, card) -> tuple:
    """Part c: a clean run and a chaos run of DUR_STEPS steps; the chaos
    run's durable state bit-identical to the clean run's, restarts equal to
    its preempts, at most DUR_EVERY steps lost.  -> (summary, the last
    chaos Trainer)."""
    from repro_torch.resilience import chaos

    t0 = time.perf_counter()
    clean = make(total_steps=DUR_STEPS)
    clean.fit(log=lambda _: None)
    want = chaos.durable_state(clean)
    clean_s = time.perf_counter() - t0
    del clean
    ck = os.path.join(root, "soak")
    made, events = [], []

    def factory(inj):
        made.append(make(total_steps=DUR_STEPS, ckpt_dir=ck,
                         ckpt_every=DUR_EVERY, keep=3, ckpt_delta=True,
                         max_consecutive_skips=1,
                         rollback_on_quarantine=True, faults=inj))
        return made[-1]

    t0 = time.perf_counter()
    with DiskPeak(ck) as disk:
        res = chaos.run_chaos(factory, DUR_SPEC, seed=SEED,
                              log=events.append)
    chaos_s = time.perf_counter() - t0
    got = chaos.durable_state(made[-1])
    if not chaos.states_bit_identical(got, want):
        bad = [k for k in want if k not in got
               or got[k].tobytes() != want[k].tobytes()]
        raise AssertionError(f"soak: the chaos run's durable state differs "
                             f"from the clean run's at {bad}")
    preempts = DUR_SPEC.count("preempt@")
    if res["step"] != DUR_STEPS or res["preempted"] \
            or res["chaos_restarts"] != preempts \
            or res["chaos_max_lost_steps"] > DUR_EVERY:
        raise AssertionError(f"soak: {res}")
    health = {}
    for t in made:
        for k, v in t.health.as_dict().items():
            if k not in ("last_durable_step", "ckpt_bytes_written",
                         "delta_chain_len"):
                health[k] = health.get(k, 0) + v
    for k in ("skipped_steps", "rollbacks", "torn_writes_detected"):
        if not health[k]:
            raise AssertionError(f"soak: no {k} ({health})")
    out = {"spec": DUR_SPEC, "steps": DUR_STEPS, "ckpt_every": DUR_EVERY,
           "restarts": res["chaos_restarts"],
           "max_lost_steps": res["chaos_max_lost_steps"],
           "health": health, "last_incarnation": {
               k: res[k] for k in ("last_durable_step", "ckpt_bytes_written",
                                   "delta_chain_len", "resumed_step")},
           "bytes_written": sum(t.mgr.bytes_written for t in made),
           "peak_disk_bytes": disk.peak, "clean_s": clean_s,
           "chaos_s": chaos_s, "events": events,
           "bit_identical_to_clean": True}
    log(f"durability soak: {DUR_STEPS} steps at B={B:,}, "
        f"spec {DUR_SPEC}: durable state bit-identical to the clean run's; "
        f"restarts {res['chaos_restarts']} (= preempts), max lost steps "
        f"{res['chaos_max_lost_steps']}; health over {len(made)} "
        f"incarnations {health}; {out['bytes_written']:,} B written, peak "
        f"on disk {disk.peak:,} B; clean {clean_s:.1f} s, chaos "
        f"{chaos_s:.1f} s; events: " + " | ".join(events) + f"; card {card}")
    return out, made[-1]


def durability_integrity(torch, tr, card) -> dict:
    """Part d: the scan of the pool and its accumulator on the card is a
    bitwise no-op on a clean state; card checksums equal numpy's of the
    same bytes; after rot_row's 8 flips the scan finds exactly the chunks
    they hit and zeroes them, nothing else."""
    from repro_torch.resilience import faults as flt
    from repro_torch.resilience import integrity as integ

    pool, acc = tr.params["embedding.memory"], tr.opt_state["embedding.memory"]

    def scan():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = (integ.sanitize_tree(tr.params)[1]
             + integ.sanitize_tree(tr.opt_state)[1])
        torch.cuda.synchronize()
        return n, time.perf_counter() - t0

    with torch.no_grad():
        p0, a0 = pool.detach().clone(), acc.clone()
    n_clean, clean_s = scan()
    if n_clean or not (bits_equal(torch, pool.detach(), p0)
                       and bits_equal(torch, acc, a0)):
        raise AssertionError(f"integrity: the scan of a clean state found "
                             f"{n_clean} chunks or wrote")
    sums_ms = {}
    for name, x in (("pool", pool), ("accumulator", acc)):
        _, ms = events_ms(torch, lambda: integ.chunk_checksums(x))
        got = integ.chunk_checksums(x).cpu().numpy().astype(np.uint32)
        if not np.array_equal(got, integ.np_chunk_checksums(
                x.detach().cpu().numpy())):
            raise AssertionError(f"integrity: card checksums of the {name} "
                                 "differ from numpy's")
        sums_ms[name] = ms
    step = DUR_STEPS
    idx = flt.rot_indices(SEED, step, pool.numel(), 8)
    flt.FaultInjector("", SEED).rot_memory(tr.params, step, 8)
    flipped = pool.detach()[torch.from_numpy(idx).to(pool.device)].cpu()
    hit = sorted({int(i) // integ.CHUNK for i, v in zip(idx, flipped)
                  if not bool(v.abs() <= integ.MAX_ABS)})
    flagged = torch.nonzero(integ.bad_value_chunks(pool)).flatten().tolist()
    n_bad, rot_s = scan()
    c = integ.CHUNK
    with torch.no_grad():
        for k in hit:
            p0[k * c:(k + 1) * c] = 0
    if flagged != hit or n_bad != len(hit) or not hit \
            or not bits_equal(torch, pool.detach(), p0) \
            or not bits_equal(torch, acc, a0):
        raise AssertionError(f"integrity: rot hit chunks {hit}, the scan "
                             f"flagged {flagged} and quarantined {n_bad}")
    out = {"clean_scan_s": clean_s, "rot_scan_s": rot_s,
           "rot_elements": [int(i) for i in idx], "chunks_hit": hit,
           "quarantined": n_bad, "checksum_ms": sums_ms,
           "scanned_bytes": int(pool.numel() * 4 + acc.numel() * 4)}
    log(f"durability integrity: a clean scan of the pool and its "
        f"accumulator ({out['scanned_bytes']:,} B) {clean_s * 1e3:.1f} ms, "
        f"a bitwise no-op; card checksums equal numpy's (pool "
        f"{sums_ms['pool']:.2f} ms, accumulator "
        f"{sums_ms['accumulator']:.2f} ms); rot_row@{step}:8 hit chunks "
        f"{hit}, the scan found exactly those and zeroed them "
        f"({rot_s * 1e3:.1f} ms), nothing else written; card {card}")
    return out


def durability_csr(torch, cfg, model, bufs, batch, dev, kernels,
                   card) -> dict:
    """Part e: the full-width D' store as CSR (built on the card from the
    planted dense store); lookups and locations through it bit-identical
    to those through the dense store, one row 2 (and row 4) launch each."""
    from repro_torch.embed import backends as bke

    e, scheme = cfg.embedding, cfg.table.scheme
    sets, lengths = bufs["store_sets"], bufs["store_lengths"]
    t0 = time.perf_counter()
    keep = torch.arange(sets.shape[1], device=dev)[None, :] \
        < lengths[:, None]
    flat = sets[keep]
    del keep
    offsets = torch.zeros(lengths.numel() + 1, dtype=torch.int32, device=dev)
    offsets[1:] = torch.cumsum(lengths, 0)
    csr = {"store_flat": flat, "store_offsets": offsets,
           "store_lengths": lengths}
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    gids = global_ids(torch, cfg, batch, dev)
    params = {"memory": model.embedding["memory"].detach()}
    out = {"values": int(lengths.numel()), "nnz": int(flat.numel()),
           "build_s": build_s,
           "dense_bytes": int(sets.numel() * 4 + lengths.numel() * 4),
           "csr_bytes": int((flat.numel() + offsets.numel()
                             + lengths.numel()) * 4), "ms": {}}
    got = {}
    for name, b in (("dense", bufs), ("csr", csr)):
        zero(kernels)
        with torch.no_grad():
            got[name] = (bke.FUSED.lookup(e, scheme, params, b, gids),
                         bke.sparse_locations(e, scheme, params, b, gids))
        launched = counts(kernels)
        if launched != {"fused_embed": 1, "fused_locations": 1}:
            raise AssertionError(f"csr: the {name} store's lookup and "
                                 f"locations launched {launched}")
        _, out["ms"][name] = events_ms(
            torch, lambda: bke.FUSED.lookup(e, scheme, params, b, gids))
    if not (bits_equal(torch, got["csr"][0], got["dense"][0])
            and torch.equal(got["csr"][1], got["dense"][1])):
        raise AssertionError("csr: lookups or locations through the CSR "
                             "store differ from the dense store's")
    log(f"durability csr: D' as CSR, {out['values']:,} values, "
        f"{out['nnz']:,} sample ids ({out['csr_bytes']:,} B against "
        f"{out['dense_bytes']:,} B dense), built on the card in "
        f"{build_s:.2f} s; lookups ({gids.numel():,} ids) and locations "
        f"bit-identical to the dense store's, one lookup and one locations "
        f"launch each; lookup {out['ms']['csr']:.3f} ms CSR / "
        f"{out['ms']['dense']:.3f} ms dense; card {card}")
    return out


def durability_launcher(torch, root: str, kernels, lma_auc: float,
                        card) -> dict:
    """Part f: lma-dlrm-criteo through the launcher as phase 9 runs it,
    with checkpoints, deltas and faults; it must finish its steps."""
    from repro_torch.launch import train as launcher
    from repro_torch.resilience import faults as flt

    zero(kernels)
    t0 = time.perf_counter()
    try:
        res = launcher.main(["--arch", "lma-dlrm-criteo", "--embedding-kind",
                             "lma", "--steps", str(LAUNCHER_STEPS),
                             "--batch", str(LAUNCHER_BATCH), "--device",
                             "cuda", "--ckpt-dir",
                             os.path.join(root, "launcher"), "--ckpt-delta",
                             "--faults", LAUNCHER_FAULTS])
    finally:
        flt.install(None)
    tr = res["train"]
    if tr["step"] != LAUNCHER_STEPS or tr["preempted"] \
            or not np.isfinite(tr["loss"]):
        raise AssertionError(f"launcher with faults: {tr}")
    health = {k: v for k, v in res["health"].items() if v}
    out = {"faults": LAUNCHER_FAULTS, "steps": tr["step"],
           "auc": res["eval"]["auc"], "unfaulted_auc": lma_auc,
           "health": res["health"], "launches": counts(kernels),
           "seconds": time.perf_counter() - t0}
    log(f"durability launcher: lma-dlrm-criteo, {tr['step']} steps at "
        f"B={LAUNCHER_BATCH}, --ckpt-delta --faults {LAUNCHER_FAULTS}: "
        f"health {health}; eval AUC {out['auc']:.4f} against "
        f"{lma_auc:.4f} unfaulted (phase 9); launches {out['launches']}; "
        f"card {card}")
    return out


def durability_maker(torch, cfg, model, bufs, B: int, batches, dev):
    """-> (``make``, the parameters, their values now): ``make(reset,
    timer, faults, **kw)`` is a Trainer of full-width dlrm-rm2 with sparse
    Adagrad over ``batches``, every one from the values ``model`` holds
    now (``reset``: copied back in first), its own fresh optimizer
    state."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import lookups_per_step, make_optimizer
    from repro_torch.models.recsys import loss_fn
    from repro_torch.train.trainer import Trainer, TrainerConfig

    arch = get_config("dlrm-rm2")
    params = dict(model.named_parameters())
    with torch.no_grad():
        init = {k: p.detach().clone() for k, p in params.items()}

    def make(reset: bool = True, timer: bool = False, faults=None, **kw):
        if reset:
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(init[k])
        pt = PhaseTimer(torch) if timer else None
        t = Trainer(TrainerConfig(log_every=0,
                                  lookups_per_step=lookups_per_step(cfg, B),
                                  **kw),
                    lambda m, b: loss_fn(m, b, bufs), model,
                    make_optimizer(arch), lambda step: batches.batch(B, step),
                    sparse_grads=True, device=dev, faults=faults,
                    on_phase=pt.mark if pt else None)
        t.timer = pt
        return t
    return make, params, init


def durability_batches(gen, B: int) -> HostBatches:
    t0 = time.perf_counter()
    batches = HostBatches([gen.batch(B, s) for s in range(DUR_STEPS)])
    log(f"durability: {DUR_STEPS} host batches of B={B:,} cached in "
        f"{time.perf_counter() - t0:.1f} s")
    return batches


def run_durability(torch, cfg, model, bufs, gen, B, dev, kernels,
                   lma_auc, card) -> dict:
    """Phase 32 on full-width dlrm-rm2 with sparse Adagrad (every Trainer
    starts from the phase's initial parameters, its own fresh optimizer
    state): the guard, a checkpoint round trip, the CSR store, and the
    faulted launcher; the chaos soak and the pool scan run aside
    (``durability_aside``).  Checkpoints go to a temporary directory
    under build/, removed at the end."""
    import shutil
    import tempfile

    from repro_torch.resilience import faults as flt

    batches = durability_batches(gen, B)
    make, params, init = durability_maker(torch, cfg, model, bufs, B,
                                          batches, dev)
    os.makedirs(ROOT / "build", exist_ok=True)
    root = tempfile.mkdtemp(prefix="durability-", dir=ROOT / "build")
    paths = {}
    try:
        guard = durability_guard(torch, make, kernels, card)
        paths["dlrm-rm2 durability guard skipped step"] = \
            guard["skipped"]["nan_grad"]["launches"]
        ckpt = durability_checkpoint(torch, make, root, card)
        csr = durability_csr(torch, cfg, model, bufs, batches.batch(B, 0),
                             dev, kernels, card)
        paths["dlrm-rm2 durability csr lookup"] = {"fused_embed": 1,
                                                   "fused_locations": 1}
        launch = durability_launcher(torch, root, kernels, lma_auc, card)
        paths["lma-dlrm-criteo launcher with faults"] = launch["launches"]
    finally:
        flt.install(None)
        shutil.rmtree(root, ignore_errors=True)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(init[k])
    return {"paths": paths, "summary": {
        "guard": guard, "checkpoint": ckpt, "csr": csr, "launcher": launch}}


def durability_aside(torch, dev, kernels, card) -> dict:
    """Phase 32's chaos soak and pool scan (parts c, d), run in a process
    of their own (``Aside``) while the card runs phases 32-31: dlrm-rm2
    built anew from the seed at full width, its soak from those values and
    the scan of the soak's last Trainer.  -> their summaries and the
    soak's launches."""
    import shutil
    import tempfile

    from repro_torch.configs._recsys_common import RECSYS_SHAPE_TABLE
    from repro_torch.resilience import faults as flt

    B = RECSYS_SHAPE_TABLE["train_batch"]["batch"]
    cfg, model, bufs = build_model(torch, dev)
    make, _, _ = durability_maker(torch, cfg, model, bufs, B,
                                  durability_batches(ctr_generator(cfg), B),
                                  dev)
    os.makedirs(ROOT / "build", exist_ok=True)
    root = tempfile.mkdtemp(prefix="soak-", dir=ROOT / "build")
    try:
        zero(kernels)
        soak, last = durability_soak(torch, make, root, B, card)
        launches = counts(kernels)
        integrity = durability_integrity(torch, last, card)
    finally:
        flt.install(None)
        shutil.rmtree(root, ignore_errors=True)
    return {"soak": soak, "integrity": integrity, "launches": launches}


# ------------------------------------------------------------------ tiering

# Phase 33: hashed_row dlrm-rm2 trained through the tiered store.  A 512-slot
# block holds 8 whole 64-slot rows, so a lookup touches one block and B * 26
# blocks bound a batch's staging, a bound that always holds.
TIER_BATCH = 4096
TIER_BUDGET_MB = 512            # the two compact leaves: pool and accumulator
TIER_BLOCK = 512
TIER_STEPS, TIER_RETIER = 24, 8
TIER_DUR_STEPS, TIER_DUR_EVERY = 24, 4
TIER_DUR_SPEC = ("nan_grad@6,stage_fail@7,preempt@9,torn_ckpt@11,"
                 "rot_row@14:8,stage_fail@17,preempt@19")
DIN_TIER_BUDGET_MB = 40
DIN_TIER_ARGS = ["--arch", "din", "--batch", "4", "--steps", "300",
                 "--device", "cuda"]
POOL = "embedding.memory"


class StoreTimer:
    """Host ms of each call of the store's steps and the controller's plan,
    the card synchronised before and after each; ``remove`` unwraps."""

    NAMES = ("touched_blocks", "stage", "install", "writeback", "retier")

    def __init__(self, torch, ctrl):
        self.ctrl, self.ms = ctrl, {n: [] for n in ("plan",) + self.NAMES}
        self.plan, self.staged = ctrl.plan_fn, []

        def wrap(name, fn):
            def timed(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                self.ms[name].append((time.perf_counter() - t0) * 1e3)
                if name == "stage":
                    self.staged.append(out["staged"])
                return out
            return timed

        for n in self.NAMES:
            setattr(ctrl.store, n, wrap(n, getattr(ctrl.store, n)))
        ctrl.plan_fn = wrap("plan", ctrl.plan_fn)

    def remove(self):
        for n in self.NAMES:
            delattr(self.ctrl.store, n)
        self.ctrl.plan_fn = self.plan

    def median_ms(self) -> dict:
        return {n: float(np.median(v)) for n, v in self.ms.items() if v}


@contextlib.contextmanager
def lookup_cotangents(torch):
    """While active, keep the cotangent of each indexing lookup's output
    (the tiered backend's gather): the raw contributions a pool slot's
    gradient sums, whose count and sum |g| the tiered check needs."""
    from repro_torch.embed import backends as bke

    plain, got = bke.lookup, []

    def tapped(memory, loc):
        out = plain(memory, loc)
        if out.requires_grad:
            out.register_hook(lambda g: got.append(g.detach()))
        return out

    bke.lookup = tapped
    try:
        yield got
    finally:
        bke.lookup = plain


def tier_launches(T: int) -> dict:
    """Kernels of T tiered and T resident dense hashed_row steps: a tiered
    step plans and looks up through the locations kernel (row 4, twice) and
    gathers by indexing; the dot interaction (row 3) once either way."""
    return {"tiered": {"fused_locations": 2 * T, "dot_interaction": T},
            "resident": {"fused_embed": T, "dot_interaction": T,
                         "fused_scatter_add": T}}


def distinct_blocks(torch, cfg, bufs, batch, dev, block: int) -> dict:
    """The distinct ``block``-slot blocks one planned batch touches."""
    from repro_torch.embed import backends as bke

    loc = bke.global_locations(cfg.embedding, cfg.table.scheme, bufs,
                               batch_gids(torch, cfg, batch, dev))
    n = int(torch.unique(torch.div(loc, block,
                                   rounding_mode="floor")).numel())
    total = cfg.embedding.budget // block
    return {"blocks": n, "of": total, "share": n / total,
            "locations": loc.numel()}


def to_card(torch, x, dev):
    return (torch.from_numpy(x) if isinstance(x, np.ndarray) else x).to(dev)


def check_tiered_step(torch, n, arch, st, q0, acc0, res, tier_after, grads,
                      loc, cot, parity) -> None:
    """One tiered step against the resident dense step from the same state:
    the pool's slot sums within ``sum_tol`` (two sequential sums: PyTorch's
    indexing backward and the scatter-add's atomics) and zero off the
    touched slots, the compact gradient zero past the live rows, and each
    pool exactly Adagrad of its own sums (``adagrad_rule``)."""
    m, block, dev = q0.numel(), st.block, q0.device
    ids = torch.from_numpy(np.concatenate([st.hot_ids, st._staged_ids])
                           ).to(dev).long()
    live = ids.numel() * block
    glob = (ids[:, None] * block
            + torch.arange(block, device=dev)).reshape(-1)
    gc, gd = grads["tiered"], grads["resident"]
    if bool((gc[live:] != 0).any()):
        raise AssertionError(f"step {n}: tiered gradient past the live rows")
    gt = torch.zeros(m, device=dev)
    gt[glob] = gc[:live]
    flat = loc.reshape(-1).long()
    slots = torch.unique(flat)
    touched = torch.zeros(m, dtype=torch.bool, device=dev)
    touched[slots] = True
    for name, g in (("tiered", gt), ("resident", gd)):
        if bool((g[~touched] != 0).any()):
            raise AssertionError(f"step {n}: the {name} pool gradient is "
                                 "not 0 off the touched slots")
    raw = torch.cat([c.reshape(-1) for c in cot])
    run = torch.bincount(flat, minlength=m)[slots]
    abs_sum = torch.zeros(m, dtype=torch.float64, device=dev).index_add_(
        0, flat, raw.abs().double())[slots]
    s = {"tiered": gt[slots], "resident": gd[slots]}
    ds = (s["tiered"] - s["resident"]).abs().double()
    share = float((ds / sum_tol(run.double(), abs_sum, pairwise=False)
                   .clamp_min(1e-30)).max())
    if share > 1:
        raise AssertionError(f"step {n}: tiered and resident slot sums "
                             f"differ: {share:.3g} of sum_tol")
    adagrad_rule(torch, n, POOL, arch, q0, acc0,
                 {"tiered": tier_after[0], "resident": res[0]},
                 {"tiered": {POOL: tier_after[1]},
                  "resident": {POOL: res[1]}}, slots, touched, s,
                 names=("tiered", "resident"))
    parity["max_tol_share"] = max(parity.get("max_tol_share", 0.0), share)
    parity["max_sum_ratio"] = max(
        parity.get("max_sum_ratio", 0.0),
        float((ds / abs_sum.clamp_min(1e-30)).max()))
    parity["max_pool_param_diff"] = max(
        parity.get("max_pool_param_diff", 0.0),
        float((tier_after[0] - res[0]).abs().max()))


def copy_gbs(torch, src, dst, iters: int = 5) -> float:
    """GB/s of ``dst.copy_(src)`` (CUDA events, median of ``iters``)."""
    ms = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        dst.copy_(src, non_blocking=True)
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
    return src.numel() * src.element_size() / float(np.median(ms)) / 1e6


def tiered_run(torch, arch, hr_cfg, hr_model, hr_bufs, batches, dev, kernels,
               card) -> dict:
    """Part a: TIER_STEPS tiered steps (re-tier every TIER_RETIER), each
    beside a resident dense step from the same state, checked; the step
    split, staging traffic and copy rates; the tiered lookup against the
    fused one; a round trip with no update."""
    import copy

    from repro_torch.embed import backends as bke
    from repro_torch.launch.train import (_maybe_tier, lookups_per_step,
                                          make_optimizer)
    from repro_torch.models.recsys import loss_fn
    from repro_torch.tier import (TieredStore, TierController, split_batch,
                                  tier_split)
    from repro_torch.train.trainer import Trainer, TrainerConfig

    B, T = TIER_BATCH, TIER_STEPS
    e, scheme = hr_cfg.embedding, hr_cfg.table.scheme
    m = e.budget
    try:
        _maybe_tier(hr_cfg, arch, hr_model, hr_bufs,
                    lambda s: batches.batch(B, s), TIER_BUDGET_MB)
        raise AssertionError("the launcher's staging bound admitted "
                             "full-width dlrm-rm2")
    except SystemExit as exc:
        refusal = str(exc)
    log(f"tiering (a): the launcher's rule (one block per location element, "
        f"{B * hr_cfg.n_fields * e.dim:,} > {m // TIER_BLOCK:,} blocks) "
        f"refuses full-width dlrm-rm2: {refusal}")
    stage_blocks = B * hr_cfg.n_fields
    hot_slots, _ = tier_split(m, TIER_BUDGET_MB, 4, TIER_BLOCK, n_leaves=2,
                              stage_blocks=stage_blocks)
    st = TieredStore(hr_model.embedding["memory"], hot_slots,
                     block=TIER_BLOCK, stage_blocks=stage_blocks)
    tmodel = copy.deepcopy(hr_model)
    tmodel.embedding["memory"] = torch.nn.Parameter(st.initial_compact())

    def plan(batch):
        return bke.global_locations(e, scheme, hr_bufs,
                                    global_ids(torch, hr_cfg, batch, dev))

    ctrl = TierController(st, lambda s: batches.batch(B, s), plan,
                          retier_every=TIER_RETIER)
    timer = StoreTimer(torch, ctrl)

    def tiered_loss(model, b):
        clean, tb = split_batch(b)
        return loss_fn(model, clean, {**hr_bufs, **tb})

    opts = {k: Recorder(make_optimizer(arch, sparse_ok=False))
            for k in ("tiered", "resident")}
    timers = {k: PhaseTimer(torch) for k in opts}
    cfg_t = TrainerConfig(total_steps=0, log_every=0,
                          lookups_per_step=lookups_per_step(hr_cfg, B))
    trs = {"tiered": Trainer(cfg_t, tiered_loss, tmodel, opts["tiered"],
                             lambda s: batches.batch(B, s),
                             sparse_grads=False, device=dev, tier=ctrl,
                             on_phase=timers["tiered"].mark),
           "resident": Trainer(dataclasses.replace(cfg_t),
                               lambda mdl, b: loss_fn(mdl, b, hr_bufs),
                               hr_model, opts["resident"],
                               lambda s: batches.batch(B, s),
                               sparse_grads=False, device=dev,
                               on_phase=timers["resident"].mark)}
    ttr, rtr = trs["tiered"], trs["resident"]
    launches = {k: {} for k in trs}
    losses = {k: [] for k in trs}
    parity: dict = {}
    compact_bytes = 2 * st.compact_slots * 4
    budget = TIER_BUDGET_MB * 2**20
    if compact_bytes > budget:
        raise AssertionError(f"compact leaves {compact_bytes} B over the "
                             f"{budget} B budget")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def step(name, n):
        tr = trs[name]
        tr.step, tr.cfg.total_steps = n - 1, n
        zero(kernels)
        losses[name].append(tr.fit(log=lambda _: None)["loss"])
        for k, c in counts(kernels).items():
            launches[name][k] = launches[name].get(k, 0) + c

    full_p, full_o = ctrl.export_full(ttr.params, ttr.opt_state)
    rparams = dict(hr_model.named_parameters())
    t_start = time.perf_counter()
    for n in range(1, T + 1):
        with torch.no_grad():
            for k, q in rparams.items():
                q.copy_(to_card(torch, full_p[k], dev))
            for k, a in rtr.opt_state.items():
                a.copy_(to_card(torch, full_o[k], dev))
            q0, acc0 = rparams[POOL].detach().clone(), \
                rtr.opt_state[POOL].clone()
        step("resident", n)
        with lookup_cotangents(torch) as cot:
            step("tiered", n)
        full_p, full_o = ctrl.export_full(ttr.params, ttr.opt_state)
        with torch.no_grad():
            for k, q in ttr.params.items():
                if k != POOL and not (
                        torch.equal(q, rparams[k])
                        and torch.equal(ttr.opt_state[k], rtr.opt_state[k])
                        and torch.equal(opts["tiered"].grads[k],
                                        opts["resident"].grads[k])):
                    raise AssertionError(f"step {n}: {k} differs between "
                                         "the tiered and resident steps")
            loc = scheme.locations(e, hr_bufs, global_ids(
                torch, hr_cfg, batches.batch(B, n - 1), dev))
            check_tiered_step(
                torch, n, arch, st, q0, acc0,
                (rparams[POOL].detach(), rtr.opt_state[POOL]),
                (to_card(torch, full_p[POOL], dev),
                 to_card(torch, full_o[POOL], dev)),
                {k: o.grads[POOL] for k, o in opts.items()}, loc, cot,
                parity)
        if losses["tiered"][-1] != losses["resident"][-1]:
            raise AssertionError(f"step {n}: losses {losses}")
        for o in opts.values():
            o.grads = None
        del q0, acc0, loc, cot
    checked_s = time.perf_counter() - t_start
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    want = tier_launches(T)
    if launches != want:
        raise AssertionError(f"tiered launches {launches}, expected {want}")
    split = timer.median_ms()
    timer.remove()
    tput = {k: tr.throughput() for k, tr in trs.items()}
    step_ms = {k: 1e3 / tput[k]["steps_per_sec"] for k in trs}
    tiered_sps = 1e3 / (step_ms["tiered"] + tput["tiered"]["tier_sec"] * 1e3)
    n_stage = max(st.stats["stage_steps"], 1)
    staged = st.stats["staged_blocks"] / n_stage
    # the copy rates at the mean stage's size, through the store's buffers
    rows = int(round(staged))
    h2d = copy_gbs(torch, st._hbuf["memory"][0][:rows],
                   st._dbuf["memory"][:rows])
    d2h = copy_gbs(torch, st._dbuf["memory"][:rows],
                   st._wbuf["memory"][:rows])

    # the tiered lookup of the staged batch against the fused lookup (row
    # 2) of the full pool; then a round trip with no update
    with torch.inference_mode():
        b = batches.batch(B, T - 1)
        gids = global_ids(torch, hr_cfg, b, dev)
        got = hr_cfg.table.embed_fields(
            {"memory": tmodel.embedding["memory"]},
            {**hr_bufs, **st.batch_tier_buffers()},
            torch.from_numpy(b["sparse"]).to(dev)).reshape(gids.numel(), -1)
        want_e = bke.FUSED.lookup(e, scheme,
                                  {"memory": to_card(torch, full_p[POOL],
                                                     dev)}, hr_bufs, gids)
        if not bits_equal(torch, got, want_e):
            raise AssertionError("tiered lookup differs from the fused one")
    tree = ctrl._collect(ttr.params, ttr.opt_state)
    before = {k: st.full_pool(v, k) for k, v in tree.items()}
    st.writeback(tree)
    blocks, cnt = st.touched_blocks(plan(batches.batch(B, 0)))
    st.stage(blocks)
    st.install(tree)
    st.writeback(tree)
    st.observe(blocks, cnt * 1e6)
    _, moved = st.retier(tree)
    if not moved["promoted"] or any(
            not np.array_equal(st.full_pool(v, k).view(np.int32),
                               before[k].view(np.int32))
            for k, v in tree.items()):
        raise AssertionError(f"round trip moved bits ({moved})")
    out = {
        "batch": B, "steps": T, "retier_every": TIER_RETIER,
        "m": m, "block": TIER_BLOCK, "hot_slots": st.hot_slots,
        "stage_blocks": st.stage_blocks, "compact_slots": st.compact_slots,
        "compact_bytes": compact_bytes, "budget_bytes": budget,
        "resident_bytes": 2 * m * 4, "launcher_refusal": refusal,
        "peak_gib": peak_gib, "checked_seconds": checked_s,
        "losses": losses, "launches": launches, "parity": parity,
        "steps_per_sec": {"tiered": tiered_sps,
                          "tiered_step_only": tput["tiered"]["steps_per_sec"],
                          "resident": tput["resident"]["steps_per_sec"]},
        "pre_step_ms": tput["tiered"]["tier_sec"] * 1e3,
        "store_ms": split, "phase_ms": {k: t.split_ms()
                                        for k, t in timers.items()},
        "staged_blocks_per_step": staged, "staged_blocks": timer.staged,
        "host_fetch_bytes_per_step": st.stats["host_fetch_bytes"] / n_stage,
        "writeback_bytes_per_step":
            st.stats["writeback_bytes"] / max(n_stage - 1, 1),
        "promoted": st.stats["promoted"], "h2d_gbs": h2d, "d2h_gbs": d2h,
        "round_trip_promoted": moved["promoted"]}
    log(f"tiering (a): hashed_row dlrm-rm2, m={m:,}, B={B:,}: {st.hot_slots:,}"
        f" hot slots ({st.hot_blocks:,} blocks), stage {st.stage_blocks:,} "
        f"blocks, compact {st.compact_slots:,} slots x 2 leaves = "
        f"{compact_bytes:,} B against a {budget:,} B budget ("
        f"{2 * m * 4:,} B resident); peak {peak_gib:.2f} GiB; {T} steps each "
        f"held to a resident dense step from the same state: non-pool "
        f"parameters, states and losses bit-equal, slot sums within "
        f"{parity['max_tol_share']:.3g} of sum_tol, each pool exactly "
        f"Adagrad of its own sums; launches {launches}; steps/s tiered "
        f"{tiered_sps:.2f} (step alone "
        f"{tput['tiered']['steps_per_sec']:.2f}, pre_step "
        f"{out['pre_step_ms']:.1f} ms), resident "
        f"{tput['resident']['steps_per_sec']:.2f}; staged "
        f"{staged:,.0f} blocks (by step {timer.staged}), fetch "
        f"{out['host_fetch_bytes_per_step']:,.0f}"
        f" B, write-back {out['writeback_bytes_per_step']:,.0f} B a step; "
        f"store ms (median) " + ", ".join(f"{k} {v:.2f}"
                                          for k, v in split.items())
        + "; phases (ms) " + ", ".join(
            f"{k}: " + " ".join(f"{p} {v:.2f}" for p, v in ph.items())
            for k, ph in out["phase_ms"].items())
        + f"; host->device {h2d:.1f} GB/s, device->host {d2h:.1f} GB/s; "
        f"promoted {st.stats['promoted']:,}; tiered lookup bit-equal to the "
        f"fused one; a round trip (stage, install, write-back, re-tier "
        f"moving {moved['promoted']} blocks) left both full pools "
        f"bit-identical; card {card}")
    return out


def tiered_durability(torch, arch, hr_cfg, hr_model, hr_bufs, init, root,
                      batches, dev, card) -> dict:
    """Part b: a clean tiered run and a chaos run of TIER_DUR_STEPS steps
    (TIER_DUR_SPEC; a boundary every TIER_DUR_EVERY steps, deltas): the
    chaos run's full pools and accumulator bit-identical to the clean
    run's, the tier meta equal, staging retried, restarts = preempts."""
    import copy

    from repro_torch.embed import backends as bke
    from repro_torch.launch.train import make_optimizer
    from repro_torch.models.recsys import loss_fn
    from repro_torch.resilience import chaos
    from repro_torch.tier import (TieredStore, TierController, split_batch,
                                  tier_split)
    from repro_torch.train.trainer import Trainer, TrainerConfig

    B, e, scheme = TIER_BATCH, hr_cfg.embedding, hr_cfg.table.scheme
    stage_blocks = B * hr_cfg.n_fields
    hot_slots, _ = tier_split(e.budget, TIER_BUDGET_MB, 4, TIER_BLOCK,
                              n_leaves=2, stage_blocks=stage_blocks)
    tmodel = copy.deepcopy(hr_model)

    def plan(batch):
        return bke.global_locations(e, scheme, hr_bufs,
                                    global_ids(torch, hr_cfg, batch, dev))

    def tiered_loss(model, b):
        clean, tb = split_batch(b)
        return loss_fn(model, clean, {**hr_bufs, **tb})

    def make(faults=None, **kw):
        st = TieredStore(init[POOL], hot_slots, block=TIER_BLOCK,
                         stage_blocks=stage_blocks)
        with torch.no_grad():
            for k, q in tmodel.named_parameters():
                if k != POOL:
                    q.copy_(init[k])
        tmodel.embedding["memory"] = torch.nn.Parameter(st.initial_compact())
        ctrl = TierController(st, lambda s: batches.batch(B, s), plan,
                              retier_every=TIER_RETIER)
        return Trainer(TrainerConfig(total_steps=TIER_DUR_STEPS, log_every=0,
                                     **kw),
                       tiered_loss, tmodel, make_optimizer(arch,
                                                           sparse_ok=False),
                       lambda s: batches.batch(B, s), sparse_grads=False,
                       device=dev, faults=faults, tier=ctrl)

    t0 = time.perf_counter()
    clean = make()
    clean.fit(log=lambda _: None)
    want, want_meta = chaos.durable_state(clean), clean.tier.tier_meta()
    clean_s = time.perf_counter() - t0
    del clean
    ck = os.path.join(root, "tiered-soak")
    made, events = [], []

    def factory(inj):
        made.append(make(inj, ckpt_dir=ck, ckpt_every=TIER_DUR_EVERY, keep=3,
                         ckpt_delta=True, max_consecutive_skips=1,
                         rollback_on_quarantine=True))
        return made[-1]

    t0 = time.perf_counter()
    with DiskPeak(ck) as disk:
        res = chaos.run_chaos(factory, TIER_DUR_SPEC, seed=SEED,
                              log=events.append)
    chaos_s = time.perf_counter() - t0
    last = made[-1]
    got, meta = chaos.durable_state(last), last.tier.tier_meta()
    if not chaos.states_bit_identical(got, want):
        bad = [k for k in want if k not in got
               or got[k].tobytes() != want[k].tobytes()]
        raise AssertionError(f"tiered soak: the chaos run's durable state "
                             f"differs from the clean run's at {bad}")
    if not all(np.array_equal(meta[k].view(np.uint8),
                              want_meta[k].view(np.uint8)) for k in meta):
        raise AssertionError("tiered soak: tier meta differs")
    retries = sum(t.tier.store.stats["stage_retries"] for t in made)
    preempts = TIER_DUR_SPEC.count("preempt@")
    if res["step"] != TIER_DUR_STEPS or res["preempted"] \
            or res["chaos_restarts"] != preempts \
            or res["chaos_max_lost_steps"] > TIER_DUR_EVERY or retries < 1:
        raise AssertionError(f"tiered soak: {res}, stage retries {retries}")
    health = {}
    for t in made:
        for k, v in t.health.as_dict().items():
            if k not in ("last_durable_step", "ckpt_bytes_written",
                         "delta_chain_len"):
                health[k] = health.get(k, 0) + v
    t0 = time.perf_counter()
    quarantined = last.tier.store.sanitize_cold()
    scan_ms = (time.perf_counter() - t0) * 1e3
    out = {"spec": TIER_DUR_SPEC, "steps": TIER_DUR_STEPS,
           "ckpt_every": TIER_DUR_EVERY, "restarts": res["chaos_restarts"],
           "max_lost_steps": res["chaos_max_lost_steps"],
           "stage_retries": retries, "health": health,
           "bytes_written": sum(t.mgr.bytes_written for t in made),
           "save_seconds": [t.mgr.last_save_seconds for t in made],
           "last_save_bytes": [t.mgr.last_save_bytes for t in made],
           "restore_seconds": [t.mgr.last_restore_seconds for t in made],
           "peak_disk_bytes": disk.peak, "clean_s": clean_s,
           "chaos_s": chaos_s, "sanitize_cold_ms": scan_ms,
           "sanitize_cold_quarantined": quarantined, "events": events,
           "bit_identical_to_clean": True}
    log(f"tiering (b): {TIER_DUR_STEPS} tiered steps at B={B:,}, spec "
        f"{TIER_DUR_SPEC}: full pools, accumulator and MLPs bit-identical to "
        f"the clean run's, tier meta (hot set, EMA) equal; restarts "
        f"{res['chaos_restarts']} (= preempts), max lost steps "
        f"{res['chaos_max_lost_steps']}, stage retries {retries}; health "
        f"{health}; {out['bytes_written']:,} B written (peak on disk "
        f"{disk.peak:,} B); saves {out['save_seconds']} s of "
        f"{out['last_save_bytes']} B, restores {out['restore_seconds']} s; "
        f"sanitize_cold {scan_ms:.1f} ms; clean {clean_s:.1f} s, chaos "
        f"{chaos_s:.1f} s; events: " + " | ".join(events) + f"; card {card}")
    return out


# ------------------------------------ host batches, drawn aside

def launcher_draws(table: dict, argv: list) -> None:
    """The CTR or DIN batches ``launch.train.main(argv)`` draws, into
    ``table`` by (spec, size, index): its D' rows (or id counts), each
    training step's batch and the eval batches, drawn on the host through
    the launcher's own setup (on the CPU)."""
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_ctr
    from repro_torch.launch import train as launcher

    saved = {c: c.batch for c in (synthetic_ctr.CTRGenerator,
                                  synthetic_ctr.DINGenerator)}

    def recorder(draw):
        def batch(self, batch_size, batch_idx):
            out = draw(self, batch_size, batch_idx)
            table[(self.spec, batch_size, batch_idx)] = out
            return out
        return batch
    args = dict(zip(argv[::2], argv[1::2]))
    try:
        for c, draw in saved.items():
            c.batch = recorder(draw)
        arch = get_config(args["--arch"])
        gen, _, batch_fn, _ = launcher._recsys_setup(
            arch, arch.make_model(None), LAUNCHER_SIGNATURES,
            int(args["--batch"]), "cpu")
        for step in range(int(args["--steps"])):
            batch_fn(step)
        for i in range(LAUNCHER_EVAL_BATCHES):
            gen.batch(LAUNCHER_EVAL_B, LAUNCHER_EVAL_FROM + i)
    finally:
        for c, draw in saved.items():
            c.batch = draw


def draw_host_batches(path: str, jobs: list) -> None:
    """The host batches of the launcher runs (phase 9, 33c) and of the LM
    training (phase 38), drawn in a spawned process while the card runs
    the phases before them: each job ``(name, what)`` pickled into
    ``path/name.pkl`` (written whole, then renamed), in the order the
    phases take them.  ``what`` is a list of ``("launcher", argv)``
    (``launcher_draws``) or of ``("lm", arch, B, S, steps)``
    (``LMGenerator(vocab, seed=SEED)`` batches by (arch, B, step))."""
    import pickle

    from repro_torch.configs import get_config
    from repro_torch.data.lm_data import LMGenerator

    for name, what in jobs:
        t0 = time.perf_counter()
        table: dict = {}
        for item in what:
            if item[0] == "launcher":
                launcher_draws(table, item[1])
            else:
                _, arch, B, S, steps = item
                gen = LMGenerator(get_config(arch).make_model().vocab_size,
                                  seed=SEED)
                for step in range(steps):
                    table[(arch, B, step)] = gen.batch(B, S, step)
        table["seconds"] = time.perf_counter() - t0
        tmp = os.path.join(path, f"{name}.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(table, f, protocol=5)
        os.replace(tmp, os.path.join(path, f"{name}.pkl"))


class HostDraws:
    """``draw_host_batches`` in a spawned process, into a temporary
    directory under build/; ``take(name)`` waits for that job's file and
    loads it, ``close`` stops the process and removes the directory."""

    def __init__(self, jobs: list):
        import multiprocessing
        import tempfile

        os.makedirs(ROOT / "build", exist_ok=True)
        self.tmp = tempfile.TemporaryDirectory(prefix="batches-",
                                               dir=ROOT / "build")
        self.proc = multiprocessing.get_context("spawn").Process(
            target=draw_host_batches, args=(self.tmp.name, jobs),
            daemon=True)
        self.proc.start()

    def take(self, name: str) -> dict:
        """-> the job's table, with the seconds it took to draw
        (``seconds``) and that the caller waited for it (``waited``)."""
        import pickle

        path = os.path.join(self.tmp.name, f"{name}.pkl")
        t0 = time.perf_counter()
        while not os.path.exists(path):
            if not self.proc.is_alive() and not os.path.exists(path):
                raise RuntimeError(f"drawing the host batches failed (exit "
                                   f"code {self.proc.exitcode})")
            time.sleep(0.05)
        with open(path, "rb") as f:
            table = pickle.load(f)
        table["waited"] = time.perf_counter() - t0
        return table

    def close(self) -> None:
        if self.proc.is_alive():
            self.proc.terminate()
        self.proc.join()
        self.tmp.cleanup()


def run_aside(path: str, job: str) -> None:
    """One ``Aside`` job in this (spawned) process: ``ASIDE_JOBS[job]`` on
    the card, its result pickled into ``path`` (written whole, then
    renamed); a failure leaves no file and a non-zero exit code."""
    import pickle

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = ASIDE_JOBS[job](torch, torch.device("cuda"), shard_kernels(),
                          card_line())
    with open(path + ".part", "wb") as f:
        pickle.dump(out, f)
    os.replace(path + ".part", path)


class Aside:
    """A part of a phase whose time is host work (the chaos runs'
    checkpoint writes, hashes and restores), run in a spawned process of
    its own while the card runs the phases after it: ``take`` waits for
    its result, ``close`` stops it.  It builds its model anew from the
    seed and counts its own launches."""

    def __init__(self, job: str):
        import multiprocessing
        import tempfile

        os.makedirs(ROOT / "build", exist_ok=True)
        self.job, self.t0 = job, time.time()
        self.tmp = tempfile.TemporaryDirectory(prefix=f"aside-{job}-",
                                               dir=ROOT / "build")
        self.path = os.path.join(self.tmp.name, "out.pkl")
        self.proc = multiprocessing.get_context("spawn").Process(
            target=run_aside, args=(self.path, job), daemon=True)
        self.proc.start()

    def take(self) -> dict:
        """-> the job's result, with the seconds from its start to its
        result's writing (``seconds``, wall clock) and those the caller
        waited for it (``waited``)."""
        import pickle

        t0 = time.perf_counter()
        self.proc.join()
        if self.proc.exitcode != 0 or not os.path.exists(self.path):
            raise RuntimeError(f"the aside job {self.job} failed (exit code "
                               f"{self.proc.exitcode})")
        with open(self.path, "rb") as f:
            out = pickle.load(f)
        out["waited"] = time.perf_counter() - t0
        out["seconds"] = os.path.getmtime(self.path) - self.t0
        self.close()
        return out

    def close(self) -> None:
        if self.proc.is_alive():
            self.proc.terminate()
        self.proc.join()
        self.tmp.cleanup()


@contextlib.contextmanager
def drawn_batches(table: dict):
    """Within: ``CTRGenerator.batch`` and ``DINGenerator.batch`` hand out
    copies of the batches ``table`` holds by (spec, size, index), drawing
    any other as before; ``table["hits"]`` / ``["misses"]`` count them."""
    from repro_torch.data import synthetic_ctr

    saved = {c: c.batch for c in (synthetic_ctr.CTRGenerator,
                                  synthetic_ctr.DINGenerator)}
    table["hits"] = table["misses"] = 0

    def cached(draw):
        def batch(self, batch_size, batch_idx):
            got = table.get((self.spec, batch_size, batch_idx))
            if got is None:
                table["misses"] += 1
                return draw(self, batch_size, batch_idx)
            table["hits"] += 1
            return {k: v.copy() for k, v in got.items()}
        return batch
    try:
        for c, draw in saved.items():
            c.batch = cached(draw)
        yield table
    finally:
        for c, draw in saved.items():
            c.batch = draw


def tiered_launcher(torch, kernels, card, drawn: dict) -> dict:
    """Part c: full-width DIN through the launcher with and without
    --tier-budget-mb DIN_TIER_BUDGET_MB; the tiered run's compact leaves
    within the budget, its eval through the full pool.  Both runs take
    their batches from ``drawn`` (``HostDraws``' DIN job)."""
    from repro_torch.launch import train as launcher

    out = {}
    with drawn_batches(drawn):
        for name, extra in (("tiered", ["--tier-budget-mb",
                                        str(DIN_TIER_BUDGET_MB)]),
                            ("resident", [])):
            zero(kernels)
            t0 = time.perf_counter()
            res = launcher.main(DIN_TIER_ARGS + extra)
            tr = res["train"]
            if tr["step"] != 300 or not np.isfinite(tr["loss"]):
                raise AssertionError(f"launcher din {name}: {tr}")
            out[name] = {"auc": res["eval"]["auc"], "loss": tr["loss"],
                         "steps_per_sec": tr["steps_per_sec"],
                         "seconds": time.perf_counter() - t0,
                         "launches": counts(kernels),
                         "tier": res.get("tier")}
    t = out["tiered"]["tier"]
    budget = DIN_TIER_BUDGET_MB * 2**20
    if t is None or t["device_bytes"] > budget:
        raise AssertionError(f"launcher din tiered: {t}")
    log(f"tiering (c): DIN through the launcher, B=4, 300 steps: tiered "
        f"({t['compact_slots']:,} compact slots, stage {t['stage_blocks']:,}"
        f" blocks, {t['device_bytes']:,} B on the card against "
        f"{budget:,}; {t['staged_blocks'] / max(t['stage_steps'], 1):,.0f}"
        f" staged blocks a step) eval AUC {out['tiered']['auc']:.4f}, "
        f"{out['tiered']['steps_per_sec']:.1f} steps/s; resident AUC "
        f"{out['resident']['auc']:.4f}, {out['resident']['steps_per_sec']:.1f}"
        f" steps/s; {out['tiered']['seconds']:.1f} + "
        f"{out['resident']['seconds']:.1f} s (the batches drawn aside in "
        f"{drawn['seconds']:.1f} s, waited for {drawn['waited']:.1f} s; "
        f"{drawn['hits']} taken, {drawn['misses']} drawn here); "
        f"launches {out['tiered']['launches']}; card {card}")
    return out


def run_tiering(torch, cfg, model, bufs, gen, dev, kernels, card,
                din_drawn: dict) -> dict:
    """Phase 33 (after phase 32, dlrm-rm2 with LMA and its D' store still on
    the card): (d) the distinct blocks of one planned LMA batch; hashed_row
    dlrm-rm2 tiered under TIER_BUDGET_MB: (a) checked training beside
    resident dense steps, (c) DIN through the launcher; (b) durability
    runs aside (``tiering_aside``)."""
    from repro_torch.configs import get_config

    arch = get_config("dlrm-rm2")
    B = TIER_BATCH
    t0 = time.perf_counter()
    n = max(TIER_STEPS, TIER_DUR_STEPS)
    batches = HostBatches([gen.batch(B, s) for s in range(n)])
    log(f"tiering: {n} host batches of B={B:,} in "
        f"{time.perf_counter() - t0:.1f} s")
    hr_cfg, hr_model, hr_bufs = build_hashed_row(torch, dev)
    lma = distinct_blocks(torch, cfg, bufs, batches.batch(B, 0), dev,
                          TIER_BLOCK)
    row = distinct_blocks(torch, hr_cfg, hr_bufs, batches.batch(B, 0), dev,
                          TIER_BLOCK)
    log(f"tiering (d): one planned B={B:,} batch touches {lma['blocks']:,} of"
        f" {lma['of']:,} {TIER_BLOCK}-slot blocks of the striped LMA pool "
        f"({lma['share']:.1%}; {lma['locations']:,} locations), "
        f"{row['blocks']:,} ({row['share']:.1%}) of hashed_row's; card {card}")
    run = tiered_run(torch, arch, hr_cfg, hr_model, hr_bufs, batches, dev,
                     kernels, card)
    del hr_model
    free(torch)
    launch = tiered_launcher(torch, kernels, card, din_drawn)
    return {"paths": {"dlrm-rm2 tiered train": run["launches"]["tiered"],
                      "dlrm-rm2 tiered resident check":
                          run["launches"]["resident"],
                      "din launcher tiered": launch["tiered"]["launches"]},
            "summary": {"blocks": {"lma": lma, "hashed_row": row},
                        "train": run, "launcher": launch}}


def tiering_aside(torch, dev, kernels, card) -> dict:
    """Phase 33's durability (part b), run in a process of its own
    (``Aside``) while the card runs phases 32-31: hashed_row dlrm-rm2
    built anew from the seed, its tiered clean and chaos runs from those
    values over the phase's batches.  -> its summary."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config

    arch = get_config("dlrm-rm2")
    gen = ctr_generator(arch.make_model())
    batches = HostBatches([gen.batch(TIER_BATCH, s)
                           for s in range(TIER_DUR_STEPS)])
    hr_cfg, hr_model, hr_bufs = build_hashed_row(torch, dev)
    with torch.no_grad():
        init = {k: q.detach().clone()
                for k, q in hr_model.named_parameters()}
    os.makedirs(ROOT / "build", exist_ok=True)
    root = tempfile.mkdtemp(prefix="tiering-", dir=ROOT / "build")
    try:
        return tiered_durability(torch, arch, hr_cfg, hr_model, hr_bufs,
                                 init, root, batches, dev, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------ the dense LM (phase 35)

LM_ARCH = "tinyllama-1.1b"
LM_PARAMS = 1_099_956_224       # param_count of tinyllama-1.1b
LM_CACHE_TOKEN_BYTES = 11_968   # int8 K/V + float32 scales, 22 layers
LM_B, LM_S = 8, 2048            # 35b
INT8_RTOL, INT8_ATOL, INT8_TOPK = 0.1, 0.15, 5   # tests/test_kv_quant.py
CONSISTENCY_TOL = 2e-3          # tests/test_models_smoke.py, float32
SERVE_PROMPTS, SERVE_LENS = 64, (128, 1024)      # 35c, lengths from seed 1
SERVE_SLOTS, SERVE_NEW, SERVE_MAX_LEN = 32, 128, 1152
DECODE_B, DECODE_L, DECODE_STEPS = 128, 32768, 5  # 35d, decode_32k
FILL_ROWS = 16                  # sequences quantized into the cache at once
PREFILL_B, PREFILL_S = 4, 32768  # 35e, prefill_32k (published B = 32)
LMA_DECODE_STEPS = 16           # 35f
LMA_CHUNK = 512                 # tokens a plain location call takes
# 35f and 37g: row 2 at few tokens, the decode batches of 35b / 37g, the
# LMServer's waves of 16 and decode_32k's B = 128
SWEEP_TOKENS = (1, 4, 8, 16, 128)
# rows 4 and 10 at those sizes, at a rank's 512-row chunk (39e) and at
# 1,056 rows, the first whose one-tile grid fills the 132 SMs (where
# lookup_tile turns to one tile a row)
CHUNK_SWEEP_ROWS = SWEEP_TOKENS + (512, 1056)
SWEEP_ITERS = 100               # launches a CUDA graph replays
GRID_ITERS = 20                 # likewise, for chunk_sweep's other grids
BF16_FLOP_PER_S = 989e12        # dense, on the tensor cores


@contextlib.contextmanager
def lm_timed(torch, calls: dict):
    """Within: ``transformer.prefill`` and ``decode_step`` record each
    call's device time (CUDA events, the call synchronised) in ``calls``."""
    from repro_torch.models import transformer

    saved = {n: getattr(transformer, n) for n in ("prefill", "decode_step")}

    def wrap(name):
        def fn(*a, **kw):
            out, ms = events_ms(torch, lambda: saved[name](*a, **kw))
            calls.setdefault(name, []).append(ms)
            return out
        return fn
    try:
        for n in saved:
            setattr(transformer, n, wrap(n))
        yield calls
    finally:
        for n, f in saved.items():
            setattr(transformer, n, f)


def int8_close(torch, got, want, what: str) -> float:
    """``got`` within the int8 bound of ``want`` (rtol 0.1, atol 0.15);
    -> the largest |err|."""
    g, w = got.float(), want.float()
    err = float((g - w).abs().max())
    if not torch.allclose(g, w, rtol=INT8_RTOL, atol=INT8_ATOL):
        raise AssertionError(f"{what}: max |err| {err:.4g} outside rtol "
                             f"{INT8_RTOL}, atol {INT8_ATOL}")
    return err


def lm_check(torch, cfg, model, tokens, dev) -> dict:
    """35b: decode of the last token from the int8 prefill cache of the
    first S - 1 against the prefill over all S, both against a float32 copy
    of the weights with a float cache (and its own decode)."""
    import copy
    from repro_torch.models import transformer as tt

    B, S = tokens.shape
    res = {}
    with torch.no_grad():
        full, _ = tt.prefill(model, cfg, tokens)
        cache = tt.init_cache(cfg, B, S, dev)
        _, cache = tt.prefill(model, cfg, tokens[:, :-1], cache=cache)
        dec, _ = tt.decode_step(model, cfg, tokens[:, -1], cache, S - 1)
        del cache
        cfg32 = dataclasses.replace(cfg, dtype="float32", kv_cache_dtype=None)
        m32 = copy.deepcopy(model).float()
        f32, _ = tt.prefill(m32, cfg32, tokens)
        cache = tt.init_cache(cfg32, B, S, dev)
        _, cache = tt.prefill(m32, cfg32, tokens[:, :-1], cache=cache)
        dec32, _ = tt.decode_step(m32, cfg32, tokens[:, -1], cache, S - 1)
        del cache, m32
    for t in (full, dec, f32, dec32):
        if t.shape != (B, cfg.vocab_size) or not bool(t.isfinite().all()):
            raise AssertionError("LM logits are not finite [B, V]")
    res["decode_vs_prefill"] = int8_close(torch, dec, full,
                                          "int8 decode vs bf16 prefill")
    res["decode_vs_float32"] = int8_close(torch, dec, f32,
                                          "int8 decode vs float32 prefill")
    res["prefill_vs_float32"] = int8_close(torch, full, f32,
                                           "bf16 prefill vs float32 prefill")
    res["float32_decode_vs_prefill"] = float((dec32 - f32).abs().max())
    if not torch.allclose(dec32, f32, rtol=CONSISTENCY_TOL,
                          atol=CONSISTENCY_TOL):
        raise AssertionError("float32 decode vs prefill: max |err| "
                             f"{res['float32_decode_vs_prefill']:.3g}")
    top5 = torch.topk(dec.float(), INT8_TOPK, dim=-1).indices
    top1 = f32.argmax(-1)
    if not bool((top5 == top1[:, None]).any(-1).all()):
        raise AssertionError("the float32 top-1 is not among the int8 "
                             f"decode's top-{INT8_TOPK}")
    res["top1_equal"] = int((dec.float().argmax(-1) == top1).sum())
    log(f"35b: B={B} S={S}: int8 decode vs bf16 prefill max |err| "
        f"{res['decode_vs_prefill']:.4f}, vs float32 "
        f"{res['decode_vs_float32']:.4f}; bf16 prefill vs float32 "
        f"{res['prefill_vs_float32']:.4f} (rtol {INT8_RTOL}, atol "
        f"{INT8_ATOL}); float32 decode vs prefill "
        f"{res['float32_decode_vs_prefill']:.3g} (tol {CONSISTENCY_TOL}); "
        f"float32 top-1 in the int8 top-{INT8_TOPK} for all {B}, equal for "
        f"{res['top1_equal']}")
    return res


def wave_by_hand(torch, cfg, model, wave, max_new, max_len, dev):
    """One LMServer wave recomputed with prefill + decode_step."""
    from repro_torch.models import transformer as tt

    n, plen = len(wave), max(len(p) for p in wave)
    toks = np.zeros((n, plen), np.int32)
    for i, p in enumerate(wave):
        toks[i, plen - len(p):] = p
    pad_to = min(max_len, plen + max_new)
    cache = tt.init_cache(cfg, n, pad_to, dev)
    logits, cache = tt.prefill(model, cfg, torch.from_numpy(toks).to(dev),
                               cache=cache)
    out = [torch.argmax(logits, -1).to(torch.int32)]
    for step in range(1, max_new):
        if plen + step >= pad_to:
            break
        logits, cache = tt.decode_step(model, cfg, out[-1], cache,
                                       plen + step - 1)
        out.append(torch.argmax(logits, -1).to(torch.int32))
    return torch.stack(out, dim=1).cpu().tolist()


def lm_serve(torch, cfg, model, dev) -> dict:
    """35c: the LMServer over 64 prompts of 128-1,024 tokens in waves of
    32; one wave recomputed by hand, its tokens equal."""
    from repro_torch.serve import LMServer

    rng = np.random.default_rng(SEED + 1)
    lens = rng.integers(SERVE_LENS[0], SERVE_LENS[1] + 1, SERVE_PROMPTS)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, n)))
               for n in lens]
    server = LMServer(model, cfg, n_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN)
    free(torch)
    calls = {}
    with lm_timed(torch, calls):
        t0 = time.perf_counter()
        results = server.generate(prompts, max_new_tokens=SERVE_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    hand = wave_by_hand(torch, cfg, model, prompts[:SERVE_SLOTS], SERVE_NEW,
                        SERVE_MAX_LEN, dev)
    if [r.tokens for r in results[:SERVE_SLOTS]] != hand:
        raise AssertionError("the LMServer's first wave differs from its "
                             "recomputation by prefill + decode_step")
    gen = server.stats["generated"]
    out = {"prompts": SERVE_PROMPTS, "lengths": [int(lens.min()),
                                                 int(lens.max())],
           "stats": dict(server.stats),
           "prefill_ms_a_wave": calls["prefill"],
           "decode_step_ms_median": float(np.median(calls["decode_step"])),
           "generated_tokens_per_s": gen / wall, "wall_s": wall,
           "peak_gib": peak}
    log(f"35c: LMServer {SERVE_PROMPTS} prompts ({out['lengths'][0]}-"
        f"{out['lengths'][1]} tokens), n_slots {SERVE_SLOTS}, max_new "
        f"{SERVE_NEW}, max_len {SERVE_MAX_LEN}: {server.stats}; prefill "
        f"{', '.join(f'{x:.1f}' for x in calls['prefill'])} ms a wave, "
        f"decode step median {out['decode_step_ms_median']:.2f} ms, "
        f"{out['generated_tokens_per_s']:.1f} generated tokens/s "
        f"({wall:.2f} s), peak {peak:.2f} GiB; wave 1 equal to its "
        "recomputation")
    return out


def fill_cache(torch, cfg, cache, dev) -> None:
    """Every row of an int8 cache quantized from random K/V (or MLA
    latents; from the seed), FILL_ROWS sequences at a time."""
    from repro_torch.nn.attention import quantize_kv

    gen = torch.Generator(device=dev).manual_seed(SEED + 35)
    for c in cache.values():
        names = [n for n in c if not n.endswith("_scale")]
        count, B = c[names[0]].shape[:2]
        for li in range(count):
            for lo in range(0, B, FILL_ROWS):
                hi = min(lo + FILL_ROWS, B)
                for name in names:
                    x = torch.randn((hi - lo, *c[name].shape[2:]),
                                    generator=gen, device=dev,
                                    dtype=torch.bfloat16)
                    q, s = quantize_kv(x)
                    c[name][li, lo:hi] = q
                    c[f"{name}_scale"][li, lo:hi] = s


def gqa_sdpa_ms(torch, q, k, v, causal: bool, iters: int) -> float:
    """One ``F.scaled_dot_product_attention`` call at these shapes (q [B,
    H, S, hd], k/v [B, KV, T, hd], grouped heads): the library figure."""
    import torch.nn.functional as F
    return time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=True), iters, warmup=1)


def lm_decode_32k(torch, cfg, model, dev) -> dict:
    """35d: B = 128 against a 32,768-token int8 cache, 5 steps; one
    layer's dequantization, the port's attention and SDPA beside them."""
    from repro_torch.models import transformer as tt
    from repro_torch.nn.attention import blocked_attention, dequantize_kv

    free(torch)
    cache = tt.init_cache(cfg, DECODE_B, DECODE_L, dev)
    cache_gb = sum(t.numel() * t.element_size() for c in cache.values()
                   for t in c.values()) / 1e9
    t0 = time.perf_counter()
    fill_cache(torch, cfg, cache, dev)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(SEED + 36)
    ms = []
    with torch.no_grad():
        for step in range(DECODE_STEPS):
            tok = torch.randint(0, cfg.vocab_size, (DECODE_B,),
                                generator=gen, device=dev, dtype=torch.int32)
            at = DECODE_L - DECODE_STEPS + step
            (logits, _), t = events_ms(torch, lambda: tt.decode_step(
                model, cfg, tok, cache, at))
            ms.append(t)
            if not bool(logits.isfinite().all()):
                raise AssertionError("decode_32k logits are not finite")
        peak = torch.cuda.max_memory_allocated() / 2**30
        c = cache["layers_0"]
        kf, t_deq_k = events_ms(torch, lambda: dequantize_kv(
            c["k"][0], c["k_scale"][0], cfg.torch_dtype))
        vf, t_deq_v = events_ms(torch, lambda: dequantize_kv(
            c["v"][0], c["v_scale"][0], cfg.torch_dtype))
        q = torch.randn((DECODE_B, 1, cfg.n_heads, cfg.hd), generator=gen,
                        device=dev, dtype=cfg.torch_dtype)
        pos = torch.full((1,), DECODE_L - 1, dtype=torch.int32, device=dev)
        kv_pos = torch.arange(DECODE_L, dtype=torch.int32, device=dev)
        attn_ms = time_ms(torch, lambda: blocked_attention(
            q, kf, vf, causal=False, q_positions=pos, kv_positions=kv_pos,
            kv_valid_len=DECODE_L, block=cfg.attn_block), 3, warmup=1)
        del cache, c
        kt, vt = (x.transpose(1, 2).contiguous() for x in (kf, vf))
        sdpa = gqa_sdpa_ms(torch, q.transpose(1, 2), kt, vt, False, 5)
    med = float(np.median(ms))
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    bound_ms = (cache_gb * 1e9 + weights) / HBM_BYTES_PER_S * 1e3
    out = {"B": DECODE_B, "cache_len": DECODE_L, "steps_ms": ms,
           "median_ms": med, "cache_gb": cache_gb, "peak_gib": peak,
           "fill_s": fill_s, "bytes_bound_ms": bound_ms,
           "layer_dequantize_ms": t_deq_k + t_deq_v,
           "layer_attention_ms": attn_ms, "layer_sdpa_ms": sdpa}
    log(f"35d: decode_32k B={DECODE_B} against a {DECODE_L}-token int8 "
        f"cache ({cache_gb:.2f} GB, filled in {fill_s:.1f} s): steps "
        f"{', '.join(f'{x:.1f}' for x in ms)} ms, median {med:.1f} ms "
        f"(reading the cache and weights once: {bound_ms:.2f} ms), peak "
        f"{peak:.2f} GiB; one layer: dequantize K and V "
        f"{t_deq_k + t_deq_v:.2f} ms, blocked attention {attn_ms:.2f} ms, "
        f"SDPA on the dequantized K/V {sdpa:.3f} ms")
    return out


def lm_prefill_32k(torch, cfg, model, dev) -> dict:
    """35e: prefill_32k at B = 4 (the published 32 is a mesh's global
    batch); one layer's blocked attention and causal SDPA beside it."""
    from repro_torch.models import transformer as tt
    from repro_torch.nn.attention import blocked_attention

    free(torch)
    gen = torch.Generator(device=dev).manual_seed(SEED + 37)
    tok = torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_S),
                        generator=gen, device=dev, dtype=torch.int32)
    with torch.no_grad():
        cache = tt.init_cache(cfg, PREFILL_B, PREFILL_S, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = tt.prefill(model, cfg, tok, cache=cache)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if not bool(logits.isfinite().all()):
            raise AssertionError("prefill_32k logits are not finite")
        peak = torch.cuda.max_memory_allocated() / 2**30
        del cache, logits
        shape = (PREFILL_B, PREFILL_S)
        q = torch.randn((*shape, cfg.n_heads, cfg.hd), generator=gen,
                        device=dev, dtype=cfg.torch_dtype)
        k, v = (torch.randn((*shape, cfg.n_kv_heads, cfg.hd), generator=gen,
                            device=dev, dtype=cfg.torch_dtype)
                for _ in range(2))
        pos = torch.arange(PREFILL_S, dtype=torch.int32, device=dev)
        _, attn_ms = events_ms(torch, lambda: blocked_attention(
            q, k, v, causal=True, q_positions=pos, kv_positions=pos,
            block=cfg.attn_block))
        sdpa = gqa_sdpa_ms(torch, *(x.transpose(1, 2).contiguous()
                                    for x in (q, k, v)), True, 3)
    tokens = PREFILL_B * PREFILL_S
    out = {"B": PREFILL_B, "S": PREFILL_S, "seconds": secs,
           "tokens_per_s": tokens / secs, "peak_gib": peak,
           "layer_attention_ms": attn_ms, "layer_sdpa_causal_ms": sdpa,
           "reduced": "batch 32 -> 4 (the published 32 is a mesh's global "
                      "batch)"}
    log(f"35e: prefill_32k B={PREFILL_B} S={PREFILL_S}: {secs:.2f} s, "
        f"{tokens / secs:.0f} tokens/s, peak {peak:.2f} GiB; one layer: "
        f"blocked attention {attn_ms:.1f} ms, causal SDPA {sdpa:.2f} ms")
    return out


def row2_sweep(torch, p, spec, mem, gids, rows, support, dev) -> dict:
    """Row 2 over the first n tokens, n in SWEEP_TOKENS: bit-equal to the
    plain split path (locations, then the gather), timed by CUDA-graph
    replay beside its bound, the launch floor (a one-element fill, cold as
    row 13 is timed and warm) and the same source's one-tile grid (tile =
    d: one warp a row, the grid of a launch whose rows fill the card)."""
    from repro_torch.kernels.fused_embed import ref as fref
    from repro_torch.kernels.fused_embed.kernel import (fused_lookup_cuda,
                                                        lookup_tile, sm_count)

    one = torch.zeros(1, device=dev)
    floor = {"launch_floor_ms": cold_graph_ms(torch, lambda: one.fill_(0.0),
                                              50, dev),
             "launch_floor_warm_ms": graph_ms(torch, lambda: one.fill_(0.0),
                                              50)}
    out = {}
    for n in SWEEP_TOKENS:
        a = (gids[:n], rows[:n], support[:n])
        want = mem[fref.locations_ref(spec, *a).long()]
        if not torch.equal(fused_lookup_cuda(spec, mem, *a), want):
            raise AssertionError(f"row 2 at {n} tokens, d={p.d}, differs "
                                 "from the plain split path")
        tile = lookup_tile(n, p.d, sm_count(mem.device.index))
        r = out[n] = {"tokens": n, "tile": tile, **floor}
        r["ms"] = graph_ms(torch, lambda: fused_lookup_cuda(spec, mem, *a),
                           SWEEP_ITERS)
        r["one_tile_ms"] = graph_ms(torch, lambda: fused_lookup_cuda(
            spec, mem, *a, tile=p.d), SWEEP_ITERS)
        r["bound_ms"], r["bound_by"] = bound(
            *lma_work(torch, p, a[1], a[2], fallback=True), INT32_OP_PER_S)
        log(f"  row 2 at {n} tokens, d={p.d} (tile {tile}: "
            f"{n * -(-p.d // tile)} warps): {r['ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), launch floor "
            f"{floor['launch_floor_warm_ms']:.4f} ms warm / "
            f"{floor['launch_floor_ms']:.4f} ms cold; one tile a row "
            f"{r['one_tile_ms']:.4f} ms; bit-equal to the plain split path")
    return out


def chunk_work(torch, p, rows, support, loc, base: int, m_local: int):
    """(bytes, int32 ops) of rows 4 and 10 over these rows, by name: the
    slot function's (``lma_work`` with the fallback, less its gathered
    floats), d int32 slots out; row 10 also gathers its in-slab locations
    (``loc``) and writes d floats."""
    nb, ops = lma_work(torch, p, rows, support, fallback=True)
    N, d = loc.shape
    in_slab = int(((loc >= base) & (loc < base + m_local)).sum())
    return {"fused_locations": (nb - N * d * 4, ops),
            "fused_chunk_lookup": (nb + N * d * 4 - (N * d - in_slab) * 4,
                                   ops)}


def chunk_sweep(torch, p, spec, mem, gids, rows, support, row2) -> dict:
    """Rows 4 and 10 over the first n rows, n in CHUNK_SWEEP_ROWS, row 10
    from the middle half of the pool as its slab (base m / 4 > 0, so that
    locations fall on both sides of the mask).  Each grid timed is
    bit-equal to the plain version (``locations_ref``;
    ``chunk_lookup_ref``'s two steps, the locations, then their slab
    gather).  A row's outputs depend on that
    row alone, so the plain version runs over the largest n in
    LMA_CHUNK-row calls and each n is held to its first n rows.  Each is
    timed by CUDA-graph replay beside its bound, the launch floor and row
    2's time at the same rows (``row2``, row 2's sweep in this run), the
    same source's one-tile grid (tile = d) and, where the default tile is
    d (n past lookup_tile's threshold), its 32-column grid; with the
    blocks of 8 warps an SM holds for each kernel and tile (the occupancy
    API)."""
    from repro_torch.kernels.fused_embed import kernel as fk
    from repro_torch.kernels.fused_embed import ref as fref

    top = max(CHUNK_SWEEP_ROWS)
    floor = {k: row2[SWEEP_TOKENS[0]][k]
             for k in ("launch_floor_ms", "launch_floor_warm_ms")}
    base, m_local = p.m // 4, p.m // 2
    slab = mem[base:base + m_local]
    plain = {"fused_locations": 0.0, "fused_chunk_lookup": 0.0}
    want_loc, want_part = [], []
    for lo in range(0, top, LMA_CHUNK):
        a = (gids[lo:lo + LMA_CHUNK], rows[lo:lo + LMA_CHUNK],
             support[lo:lo + LMA_CHUNK])
        # chunk_lookup_ref's two steps: the locations, then their gather
        loc, t = events_ms(torch, lambda: fref.locations_ref(spec, *a))
        part, t_gather = events_ms(torch, lambda: fref.chunk_gather_ref(
            slab, loc, base))
        plain["fused_locations"] += t
        plain["fused_chunk_lookup"] += t + t_gather
        want_loc.append(loc)
        want_part.append(part)
    want_loc, want_part = torch.cat(want_loc), torch.cat(want_part)
    S = rows.shape[1]
    blocks = {name: {t: fk.blocks_per_sm(kind, S, t)
                     for t in (min(32, p.d), p.d)}
              for name, kind in (("fused_locations", "locations"),
                                 ("fused_chunk_lookup", "chunk_lookup"))}
    out = {"fused_locations": {}, "fused_chunk_lookup": {}}
    for n in CHUNK_SWEEP_ROWS:
        a = (gids[:n], rows[:n], support[:n])
        loc = want_loc[:n]
        inb = (loc >= base) & (loc < base + m_local)
        if not (bool(inb.any()) and bool((~inb).any())):
            raise AssertionError(f"row 10's sweep at {n} rows: the slab "
                                 "mask has one side only")
        work = chunk_work(torch, p, a[1], a[2], loc, base, m_local)
        tile = fk.lookup_tile(n, p.d, fk.sm_count(mem.device.index))
        # each timed grid (default tile None, one tile a row, 32 columns)
        grids = {"ms": None, "one_tile_ms": p.d}
        if tile == p.d != min(32, p.d):
            grids["tiled_ms"] = 32
        calls = {
            "fused_locations": (4, (loc,), lambda t: (
                fk.fused_locations_cuda(spec, *a, tile=t),)),
            "fused_chunk_lookup": (10, (want_part[:n], loc),
                                   lambda t: fk.fused_chunk_lookup_cuda(
                                       spec, slab, *a, base=base, tile=t))}
        for name, (row, want, call) in calls.items():
            r = out[name][n] = {"tokens": n, "tile": tile, **floor,
                                "blocks_per_sm": blocks[name][tile],
                                "one_tile_blocks_per_sm": blocks[name][p.d]}
            for key, t in grids.items():
                if not all(map(torch.equal, call(t), want)):
                    raise AssertionError(
                        f"row {row} at {n} rows, d={p.d}, tile "
                        f"{t or tile}, differs from its plain version")
                r[key] = graph_ms(torch, lambda: call(t),
                                  SWEEP_ITERS if t is None else GRID_ITERS)
            r["bound_ms"], r["bound_by"] = bound(*work[name], INT32_OP_PER_S)
            if n == top:
                r["plain_ms"] = plain[name]
            if n in row2:
                r["row2_ms"] = row2[n]["ms"]
            log(f"  row {row} at {n} rows, d={p.d} (tile {tile}: "
                f"{n * -(-p.d // tile)} warps, {r['blocks_per_sm']} blocks "
                f"an SM): {r['ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
                f"({r['bound_by']}, {r['bound_ms'] / r['ms']:.0%}); one "
                f"tile a row {r['one_tile_ms']:.4f} ms "
                f"({r['one_tile_blocks_per_sm']} blocks an SM)"
                + (f"; {r['ms'] / r['row2_ms']:.2f}x row 2's "
                   f"{r['row2_ms']:.4f} ms" if n in row2 else "")
                + (f"; 32-column tiles {r['tiled_ms']:.4f} ms"
                   if "tiled_ms" in r else "")
                + "; each grid bit-equal to its plain version")
    return out


def lm_lma(torch, cfg, tokens, dev, kernels) -> dict:
    """35f: tinyllama-1.1b with an LMA token table over a planted 32,000 x
    32 D' store: row 2's lookup (``embed_tokens``) bit-equal to the plain
    split path on 35b's batch, timed at the prefill and decode shapes; a
    prefill and 16 decode steps, row 2 once each."""
    from repro_torch.configs._recsys_common import embedding_of_kind
    from repro_torch.embed import get_scheme, make_buffers
    from repro_torch.kernels.fused_embed import ops as fe
    from repro_torch.kernels.fused_embed import ref as fref
    from repro_torch.kernels.fused_embed.kernel import fused_lookup_cuda
    from repro_torch.models import transformer as tt

    free(torch)
    e = embedding_of_kind("lma", (cfg.vocab_size,), cfg.d_model,
                          expansion=16.0, max_set=32)
    lcfg = dataclasses.replace(cfg, embedding=e)
    model = tt.init(lcfg, seed=SEED, device=dev).eval()
    bufs = make_buffers(e, planted_store(torch, e, dev))
    p = e.lma
    spec = fe.lma_spec(p)
    mem = model.embed["memory"].detach()
    B, S = tokens.shape
    gids = tokens.reshape(-1).contiguous()
    rows, support = get_scheme("lma").fused_inputs(e, bufs, gids)
    with torch.no_grad():
        zero(kernels)
        got = tt.embed_tokens(model, lcfg, tokens, bufs)
        if counts(kernels) != {"fused_embed": 1}:
            raise AssertionError(f"embed_tokens launched {counts(kernels)}")
        plain_ms = 0.0
        for lo in range(0, gids.numel(), LMA_CHUNK):
            part = (gids[lo:lo + LMA_CHUNK], rows[lo:lo + LMA_CHUNK],
                    support[lo:lo + LMA_CHUNK])
            want, t = events_ms(torch, lambda: mem[
                fref.locations_ref(spec, *part).long()])
            plain_ms += t
            if not torch.equal(got.reshape(-1, p.d)[lo:lo + LMA_CHUNK],
                               want):
                raise AssertionError("the LMA token table's lookup differs "
                                     f"from the plain split path (tokens "
                                     f"{lo}..)")
        n_fb = int((support < p.min_support).sum())
        timing = {}
        for label, n in (("prefill", gids.numel()), ("decode", B)):
            a = (gids[:n], rows[:n], support[:n])
            r = timing[label] = {"tokens": n}
            r["ms"] = graph_ms(torch, lambda: fused_lookup_cuda(
                spec, mem, *a), 20)
            r["bound_ms"], r["bound_by"] = bound(
                *lma_work(torch, p, a[1], a[2], fallback=True),
                INT32_OP_PER_S)
        timing["prefill"]["plain_ms"] = plain_ms
        timing["sweep"] = row2_sweep(torch, p, spec, mem, gids, rows,
                                     support, dev)
        rows_4_10 = chunk_sweep(torch, p, spec, mem, gids, rows, support,
                                timing["sweep"])
        zero(kernels)
        cache = tt.init_cache(lcfg, B, S + LMA_DECODE_STEPS, dev)
        logits, cache = tt.prefill(model, lcfg, tokens, bufs, cache=cache)
        launches = {"lm lma prefill": counts(kernels)}
        zero(kernels)
        cur = logits.argmax(-1).to(torch.int32)
        for step in range(LMA_DECODE_STEPS):
            logits, cache = tt.decode_step(model, lcfg, cur, cache, S + step,
                                           bufs)
            cur = logits.argmax(-1).to(torch.int32)
        launches["lm lma decode"] = counts(kernels)
        if not bool(logits.isfinite().all()):
            raise AssertionError("LMA LM logits are not finite")
    want = {"lm lma prefill": {"fused_embed": 1},
            "lm lma decode": {"fused_embed": LMA_DECODE_STEPS}}
    if launches != want:
        raise AssertionError(f"LMA LM launches {launches}, want {want}")
    out = {"pool_slots": p.m, "stripe": p.stripe, "fallback_tokens": n_fb,
           "row2": timing, "rows_4_10": rows_4_10, "launches": launches}
    log(f"35f: LMA token table m={p.m} (stripe {p.stripe}, d={p.d}, n_h="
        f"{p.n_h}, max_set {p.max_set}): embed_tokens over {gids.numel()} "
        f"tokens ({n_fb} fallback) bit-equal to the plain split path "
        f"({plain_ms:.1f} ms in {-(-gids.numel() // LMA_CHUNK)} chunks); "
        f"row 2 at {gids.numel()} tokens {timing['prefill']['ms']:.4f} ms "
        f"(bound {timing['prefill']['bound_ms']:.4f} ms), at {B} tokens "
        f"{timing['decode']['ms']:.4f} ms (bound "
        f"{timing['decode']['bound_ms']:.4f} ms); launches {launches}")
    return out


def run_lm(torch, dev, kernels, card) -> dict:
    """Phase 35: tinyllama-1.1b at full width on the card, bf16 with an
    int8 cache, random weights from the seed."""
    from repro_torch.configs import get_config
    from repro_torch.data.lm_data import LMGenerator
    from repro_torch.models import transformer as tt

    t_phase = time.perf_counter()
    free(torch)
    cfg = get_config(LM_ARCH).make_model()
    t0 = time.perf_counter()
    model = tt.init(cfg, seed=SEED, device=dev).eval()
    torch.cuda.synchronize()
    n_params = tt.param_count(cfg)[0]
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    per_token = tt.cache_bytes_per_token(cfg)
    if n_params != LM_PARAMS or per_token != LM_CACHE_TOKEN_BYTES:
        raise AssertionError(f"{LM_ARCH}: {n_params} parameters, {per_token} "
                             "cache bytes a token")
    log(f"35a: {LM_ARCH} ({cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads} heads, KV {cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}, {cfg.kv_cache_dtype} cache): "
        f"{n_params:,} parameters by param_count, {nbytes / 1e9:.3f} GB; "
        f"{per_token:,} cache bytes a token; built in "
        f"{time.perf_counter() - t0:.1f} s")
    toks = torch.from_numpy(LMGenerator(cfg.vocab_size, seed=SEED).batch(
        LM_B, LM_S, 0)["tokens"]).to(dev)
    out = {"arch": LM_ARCH, "params": n_params, "bytes": nbytes,
           "cache_bytes_per_token": per_token, "card": card}
    out["check"] = lm_check(torch, cfg, model, toks, dev)
    out["serve"] = lm_serve(torch, cfg, model, dev)
    out["decode_32k"] = lm_decode_32k(torch, cfg, model, dev)
    out["prefill_32k"] = lm_prefill_32k(torch, cfg, model, dev)
    del model
    out["lma"] = lm_lma(torch, cfg, toks, dev, kernels)
    free(torch)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 35: {out['seconds']:.1f} s")
    return out


# ------------------------------------------------------ the GAT (phase 36)

GAT_ARCH = "gat-cora"
CORA_STEPS, MOLECULE_STEPS, BLOCK_STEPS = 200, 50, 20
PRODUCTS_STEPS, GAT_LMA_STEPS = 5, 3
CORA_SPLIT_CHUNK = 997          # a chunk length that splits in-edge lists
# chunked against plain on the card, each max |err| over the max |value|:
# both sum by atomic adds, in no fixed order
GAT_OUT_TOL, GAT_GRAD_TOL = 1e-5, 1e-4
# one step at chunk C and at C / 4 from one state: the losses, and each
# parameter's change, which may differ by the atomics' rounding only
GAT_LOSS_RTOL, GAT_STEP_RTOL = 1e-5, 1e-2
GAT_LMA_DIM, GAT_LMA_ALPHA, GAT_LMA_MAX_SET = 64, 16.0, 32
GAT_LMA_CHECK, GAT_LMA_CHUNK = 65_536, 8_192   # ids held bit-exact, a call


def build_graphs(path: str, shapes: dict) -> None:
    """Phase 36's two large graphs from the seed, pickled into ``path``:
    ogbn-products' ``sbm_graph`` and the Reddit-like graph's
    ``NeighborSampler`` (its CSR built), with each one's seconds in
    ``seconds.json``; ``shapes``: their rows of ``GNN_SHAPE_TABLE``.  Run
    in a spawned process while the card runs the phases before 36 (host
    numpy, minutes at these sizes)."""
    import pickle

    from repro_torch.data.graph import NeighborSampler, sbm_graph

    secs = {}
    for name, shape in (("products", "ogb_products"),
                        ("reddit", "minibatch_lg")):
        t = shapes[shape]
        t0 = time.perf_counter()
        obj = sbm_graph(t["n_nodes"], t["n_edges"], t["d_feat"],
                        t["n_classes"], seed=SEED)
        if "fanout" in t:
            obj = NeighborSampler(obj, t["fanout"], seed=SEED)
        with open(os.path.join(path, f"{name}.pkl"), "wb") as f:
            pickle.dump(obj, f, protocol=5)
        secs[name] = time.perf_counter() - t0
        del obj
    with open(os.path.join(path, "seconds.json"), "w") as f:
        json.dump(secs, f)


class GraphBuilder:
    """``build_graphs`` in a spawned process, into a temporary directory
    under build/; ``take`` waits for it and loads the two objects, ``close``
    stops the process (if it still runs) and removes the directory."""

    def __init__(self):
        import multiprocessing
        import tempfile

        from repro_torch.configs.gat_cora import GNN_SHAPE_TABLE

        self.tmp = tempfile.TemporaryDirectory(prefix="graphs-",
                                               dir=ROOT / "build")
        shapes = {k: GNN_SHAPE_TABLE[k] for k in ("ogb_products",
                                                  "minibatch_lg")}
        self.proc = multiprocessing.get_context("spawn").Process(
            target=build_graphs, args=(self.tmp.name, shapes), daemon=True)
        self.proc.start()

    def take(self) -> tuple:
        """-> (products Graph, Reddit-like NeighborSampler, seconds)."""
        import pickle

        t0 = time.perf_counter()
        self.proc.join()
        if self.proc.exitcode != 0:
            raise RuntimeError(f"building the graphs failed (exit code "
                               f"{self.proc.exitcode})")
        waited = time.perf_counter() - t0
        out = []
        for name in ("products", "reddit"):
            with open(os.path.join(self.tmp.name, f"{name}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        with open(os.path.join(self.tmp.name, "seconds.json")) as f:
            secs = json.load(f)
        secs.update(waited=waited, load=time.perf_counter() - t0 - waited)
        return out[0], out[1], secs

    def close(self) -> None:
        if self.proc.is_alive():
            self.proc.terminate()
        self.proc.join()
        self.tmp.cleanup()


def gat_parity(torch, model, batch, chunks, bufs=None) -> dict:
    """The chunked aggregation against ``gat_conv_plain`` on the card: the
    logits and every parameter's gradient of the loss at each chunk length
    (None: the default from bytes), each max |err| over the plain max
    |value|.  -> {chunk: (logits err, gradient err)}."""
    from repro_torch.models import gnn

    def run(**kw):
        model.zero_grad(set_to_none=True)
        loss, _ = gnn.loss_fn(model, batch, bufs, **kw)
        loss.backward()
        with torch.no_grad():
            logits = model(batch, bufs, **kw)
        return logits, {k: p.grad.clone() for k, p in
                        model.named_parameters()}

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    want, want_g = run(plain=True)
    out = {}
    for c in chunks:
        got, got_g = run(chunk=c)
        e_out = rel(got, want)
        e_g = max(rel(got_g[k], want_g[k]) for k in want_g)
        if not (e_out <= GAT_OUT_TOL and e_g <= GAT_GRAD_TOL):
            raise AssertionError(f"chunked (chunk {c}) vs plain: logits "
                                 f"{e_out:.3g} (tol {GAT_OUT_TOL}), "
                                 f"gradients {e_g:.3g} (tol {GAT_GRAD_TOL})")
        out["default" if c is None else str(c)] = {"logits": e_out,
                                                   "grads": e_g}
    model.zero_grad(set_to_none=True)
    return out


def gat_trainer(torch, cfg, model, batch_fn, dev, bufs=None, chunk=None):
    """The port's Trainer over ``model`` with the arch's optimizer (Adam,
    lr 5e-3), CUDA events at its phase marks, and ``loss_fn`` reading the
    chunk length from ``tr.chunk`` (None: from bytes)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import make_optimizer
    from repro_torch.models import gnn
    from repro_torch.train.trainer import Trainer, TrainerConfig

    timer = PhaseTimer(torch)
    tr = Trainer(TrainerConfig(total_steps=0, log_every=0),
                 lambda m, b: gnn.loss_fn(m, b, bufs, tr.chunk), model,
                 make_optimizer(get_config(GAT_ARCH)), batch_fn, device=dev,
                 on_phase=timer.mark)
    tr.chunk, tr.timer = chunk, timer
    return tr


def gat_steps(torch, tr, steps: int, what: str) -> list:
    """``steps`` more steps of ``tr``, one ``fit`` each; -> their losses,
    all finite, none skipped."""
    losses = []
    for _ in range(steps):
        tr.cfg.total_steps = tr.step + 1
        losses.append(tr.fit(log=lambda _: None)["loss"])
    if tr.health.skipped_steps or not np.isfinite(losses).all():
        raise AssertionError(f"{what}: losses {losses}, "
                             f"{tr.health.skipped_steps} skipped steps")
    return losses


def gat_run_stats(torch, tr) -> dict:
    th = tr.throughput()
    return {"steps_per_sec": th["steps_per_sec"],
            "batch_sec": th["batch_sec"], "split_ms": tr.timer.split_ms(),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def gat_accuracy(torch, model, batch) -> dict:
    """Accuracy on the label mask and off it."""
    with torch.no_grad():
        hit = model(batch).argmax(-1) == batch["labels"].long()
    m = batch["label_mask"]
    return {"train": float(hit[m].float().mean()),
            "held_out": float(hit[~m].float().mean())}


def no_launches(kernels, what: str) -> None:
    if counts(kernels):
        raise AssertionError(f"{what} launched {counts(kernels)}; the "
                             "GAT's aggregation runs no kernel of the table")


def graph_on_card(torch, g, dev) -> dict:
    return {"features": torch.from_numpy(g.features).to(dev),
            "src": torch.from_numpy(g.src).to(dev),
            "dst": torch.from_numpy(g.dst).to(dev),
            "labels": torch.from_numpy(g.labels).to(dev),
            "label_mask": torch.from_numpy(g.train_mask).to(dev)}


def gat_cora(torch, dev, kernels) -> dict:
    """36a: Cora (N 2,708, E 23,820): chunked vs plain at the default chunk
    and at one that splits in-edge lists; 200 steps; accuracy on and off
    the train mask."""
    from repro_torch.configs.gat_cora import GNN_SHAPE_TABLE, make_model
    from repro_torch.data.graph import sbm_graph
    from repro_torch.models import gnn

    t = GNN_SHAPE_TABLE["full_graph_sm"]
    g = sbm_graph(t["n_nodes"], t["n_edges"], t["d_feat"], t["n_classes"],
                  seed=SEED)
    cfg = make_model("full_graph_sm")
    batch = graph_on_card(torch, g, dev)
    model = gnn.init(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    zero(kernels)
    parity = gat_parity(torch, model, batch, (None, CORA_SPLIT_CHUNK))
    free(torch)
    tr = gat_trainer(torch, cfg, model, lambda s: batch, dev)
    losses = gat_steps(torch, tr, CORA_STEPS, "Cora")
    no_launches(kernels, "36a")
    out = {"nodes": g.n_nodes, "edges": len(g.src), "parity": parity,
           "loss_first_last": [losses[0], losses[-1]],
           "accuracy": gat_accuracy(torch, model, batch),
           **gat_run_stats(torch, tr)}
    if not losses[-1] < losses[0]:
        raise AssertionError(f"Cora's loss did not fall: {losses}")
    log(f"36a: Cora N={g.n_nodes} E={len(g.src)}: chunked vs plain "
        f"{parity}; {CORA_STEPS} steps, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, accuracy {out['accuracy']}; "
        f"{out['steps_per_sec']:.1f} steps/s, split {out['split_ms']}, peak "
        f"{out['peak_gib']:.3f} GiB")
    return out


def gat_molecule(torch, dev, kernels) -> dict:
    """36b: 128 molecules x 30 nodes (20,224 edges), the mean readout: 50
    steps on one batch, the loss falling."""
    from repro_torch.configs.gat_cora import GNN_SHAPE_TABLE, make_model
    from repro_torch.data.graph import molecule_batch
    from repro_torch.models import gnn

    t = GNN_SHAPE_TABLE["molecule"]
    cfg = make_model("molecule")
    mb = molecule_batch(t["batch"], t["n_nodes"], t["n_edges"], t["d_feat"],
                        t["n_classes"], seed=SEED)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in mb.items()
             if k != "n_graphs"}
    batch["n_graphs"] = mb["n_graphs"]
    model = gnn.init(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    free(torch)
    zero(kernels)
    tr = gat_trainer(torch, cfg, model, lambda s: batch, dev)
    losses = gat_steps(torch, tr, MOLECULE_STEPS, "molecule")
    no_launches(kernels, "36b")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError(f"the molecule loss did not fall: {losses}")
    out = {"graphs": t["batch"], "edges": len(mb["src"]),
           "loss_first_last": [losses[0], losses[-1]],
           **gat_run_stats(torch, tr)}
    log(f"36b: molecule {t['batch']} graphs x {t['n_nodes']} nodes, "
        f"{len(mb['src'])} edges: {MOLECULE_STEPS} steps, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; {out['steps_per_sec']:.1f} "
        f"steps/s, split {out['split_ms']}")
    return out


def block_fn(sampler, t):
    """A step's padded block: 1,024 seed nodes from the step's seed, the
    sampler's fanouts, padded to the shape's fixed sizes."""
    from repro_torch.data.graph import pad_block

    b, (f1, f2) = t["batch_nodes"], t["fanout"]
    max_nodes = b + b * f1 + b * f1 * f2
    max_edges = b * f1 + b * f1 * f2 + max_nodes

    def batch_fn(step):
        rng = np.random.default_rng((SEED, 36, step))
        block = sampler.sample(rng.choice(t["n_nodes"], b, replace=False))
        pad = pad_block(block, max_nodes, max_edges)
        return {"features": pad["features"], "src": pad["src"],
                "dst": pad["dst"],
                "edge_mask": np.arange(max_edges) < len(block["src"]),
                "labels": pad["labels"], "label_mask": pad["label_mask"]}
    return batch_fn, max_nodes, max_edges


def gat_block(torch, dev, kernels, sampler) -> dict:
    """36c: the Reddit-like graph's sampled blocks (fan-out 15-10 of 1,024
    seeds, padded to 169,984 nodes and 338,944 edges): one block chunked vs
    plain (its [338,944, 8, 41] messages), 20 steps on fresh blocks, host
    sampling time against the device step."""
    from repro_torch.configs.gat_cora import GNN_SHAPE_TABLE, make_model
    from repro_torch.models import gnn

    t = GNN_SHAPE_TABLE["minibatch_lg"]
    cfg = make_model("minibatch_lg")
    batch_fn, max_nodes, max_edges = block_fn(sampler, t)
    t0 = time.perf_counter()
    host = batch_fn(BLOCK_STEPS)            # a block no step trains on
    sample_s = time.perf_counter() - t0
    live = int(host["edge_mask"].sum())
    block = {k: torch.as_tensor(v).to(dev) for k, v in host.items()}
    model = gnn.init(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    free(torch)
    zero(kernels)
    parity = gat_parity(torch, model, block, (None,))
    parity_peak = torch.cuda.max_memory_allocated() / 2**30
    del block
    free(torch)
    tr = gat_trainer(torch, cfg, model, batch_fn, dev)
    losses = gat_steps(torch, tr, BLOCK_STEPS, "minibatch_lg")
    no_launches(kernels, "36c")
    out = {"graph_edges": len(sampler.graph.src), "max_nodes": max_nodes,
           "max_edges": max_edges, "live_edges_of_check_block": live,
           "parity": parity, "parity_peak_gib": parity_peak,
           "check_block_sample_s": sample_s,
           "loss_first_last": [losses[0], losses[-1]],
           **gat_run_stats(torch, tr)}
    log(f"36c: minibatch_lg, a graph of {len(sampler.graph.src)} edges; "
        f"blocks padded to {max_nodes} nodes / {max_edges} edges (the check "
        f"block {live} live, sampled in {sample_s:.2f} s): chunked vs plain "
        f"{parity} (peak {parity_peak:.2f} GiB); {BLOCK_STEPS} steps, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; host batch "
        f"{out['batch_sec'] * 1e3:.1f} ms against a step of "
        f"{1e3 / out['steps_per_sec']:.1f} ms (median), device split "
        f"{out['split_ms']}")
    return out


def layer_split(torch, model, batch) -> dict:
    """Each layer's forward and backward alone, by CUDA events (layer 1's
    backward under a random cotangent, layer 0's from layer 1's input
    gradient, through the ELU; the second of two passes, the first leaving
    the caching allocator its blocks), and a profile of layer 1's forward
    and backward by kernel name."""
    from repro_torch.models import gnn

    cfg, src, dst = model.cfg, batch["src"], batch["dst"]
    n = batch["features"].shape[0]
    p0, p1 = model.layer_0, model.layer_1
    kw = dict(negative_slope=cfg.negative_slope)
    x0 = batch["features"]

    def split():
        out = {}
        h0, out["layer_0_forward_ms"] = events_ms(
            torch, lambda: gnn.gat_conv(p0, x0, src, dst, n,
                                        concat_heads=True, **kw))
        x1 = torch.nn.functional.elu(h0)
        x1d = x1.detach().requires_grad_()
        h1, out["layer_1_forward_ms"] = events_ms(
            torch, lambda: gnn.gat_conv(p1, x1d, src, dst, n,
                                        concat_heads=False, **kw))
        cot = torch.randn(h1.shape, generator=torch.Generator(
            device=h1.device).manual_seed(SEED), device=h1.device)
        g1, out["layer_1_backward_ms"] = events_ms(
            torch, lambda: torch.autograd.grad(h1, [x1d, *p1.values()],
                                               cot))
        _, out["layer_0_backward_ms"] = events_ms(
            torch, lambda: torch.autograd.grad(x1, list(p0.values()),
                                               g1[0]))
        return out, x1d.detach()

    split()
    out, x1d = split()
    x1d.requires_grad_()

    def layer1():
        y = gnn.gat_conv(p1, x1d, src, dst, n, concat_heads=False, **kw)
        torch.autograd.grad(y.sum(), [x1d, *p1.values()])
    out["layer_1_profile_ms"] = dict(list(profile_ms(torch, layer1,
                                                     iters=1).items())[:12])
    return out


def gat_products(torch, dev, kernels, g) -> dict:
    """36d: ogbn-products full-batch (N 2,449,029, E 126,167,309): 5 steps,
    losses finite and falling; one step at chunk C (layer 1's default) and
    at C / 4 from one state; steps/s, each layer's forward and backward,
    peak memory."""
    from repro_torch.configs.gat_cora import make_model
    from repro_torch.models import gnn

    cfg = make_model("ogb_products")
    free(torch)
    batch = graph_on_card(torch, g, dev)
    model = gnn.init(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.reset_peak_memory_stats()
    zero(kernels)
    tr = gat_trainer(torch, cfg, model, lambda s: batch, dev)
    losses = gat_steps(torch, tr, PRODUCTS_STEPS, "ogb_products")
    no_launches(kernels, "36d")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"ogb_products' loss did not fall: {losses}")
    stats = gat_run_stats(torch, tr)
    C = gnn.edge_chunk(cfg.n_heads, cfg.n_classes)
    p0 = {k: v.detach().clone() for k, v in tr.params.items()}
    s0, step0 = clone_state(torch, tr.opt_state), tr.step
    by_chunk = {}
    for c in (C, C // 4):
        with torch.no_grad():
            for k, v in tr.params.items():
                v.copy_(p0[k])
        tr.opt_state, tr.step, tr.chunk = clone_state(torch, s0), step0, c
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = gat_steps(torch, tr, 1, f"chunk {c}")[0]
        secs = time.perf_counter() - t0
        by_chunk[c] = (loss, secs, {k: v.detach().clone()
                                    for k, v in tr.params.items()})
    (la, sa, pa), (lb, sb, pb) = by_chunk[C], by_chunk[C // 4]
    loss_err = abs(la - lb) / abs(la)
    step_err = max(float((pa[k] - pb[k]).abs().max()
                         / (pa[k] - p0[k]).abs().max().clamp_min(1e-30))
                   for k in p0)
    if not (loss_err <= GAT_LOSS_RTOL and step_err <= GAT_STEP_RTOL):
        raise AssertionError(f"chunk {C} vs {C // 4}: loss {loss_err:.3g} "
                             f"(tol {GAT_LOSS_RTOL}), step {step_err:.3g} "
                             f"(tol {GAT_STEP_RTOL})")
    split = layer_split(torch, model, batch)
    out = {"nodes": g.n_nodes, "edges": len(g.src), "chunk": C,
           "losses": losses, **stats,
           "chunk_check": {"C": C, "C/4": C // 4, "loss_rel": loss_err,
                           "step_rel": step_err, "step_s": [sa, sb]},
           **split, "peak_gib_all": torch.cuda.max_memory_allocated() / 2**30}
    log(f"36d: ogb_products N={g.n_nodes} E={len(g.src)}: losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; {stats['steps_per_sec']:.3f}"
        f" steps/s, split {stats['split_ms']}, peak {stats['peak_gib']:.2f} "
        f"GiB; one step at chunk {C} / {C // 4}: {sa:.2f} / {sb:.2f} s, loss "
        f"rel {loss_err:.3g}, parameter change rel {step_err:.3g}; layer 0 "
        f"forward {split['layer_0_forward_ms']:.1f} ms, backward "
        f"{split['layer_0_backward_ms']:.1f} ms; layer 1 forward "
        f"{split['layer_1_forward_ms']:.1f} ms, backward "
        f"{split['layer_1_backward_ms']:.1f} ms; layer 1 by kernel "
        f"{split['layer_1_profile_ms']}")
    return out


def gat_lma(torch, dev, kernels, g) -> dict:
    """36e: the id-feature path at ogb_products: node ids arange(N) through
    an LMA table (vocab N, d 64, alpha 16, max_set 32) over a planted D'
    store; one lookup of 65,536 ids through row 2 bit-exact against the
    plain split path; 3 Trainer steps, row 2 once a forward and the
    Trainer's sparse (rows 4 and 9) or dense (row 5) rule."""
    from repro_torch.configs._recsys_common import embedding_of_kind
    from repro_torch.configs.gat_cora import make_model
    from repro_torch.embed import EmbeddingTable, get_scheme, make_buffers
    from repro_torch.kernels.fused_embed import ops as fe
    from repro_torch.kernels.fused_embed import ref as fref
    from repro_torch.models import gnn

    free(torch)
    N = g.n_nodes
    e = embedding_of_kind("lma", (N,), GAT_LMA_DIM, expansion=GAT_LMA_ALPHA,
                          max_set=GAT_LMA_MAX_SET)
    cfg = dataclasses.replace(make_model("ogb_products"), d_in=GAT_LMA_DIM,
                              node_id_embedding=e)
    bufs = make_buffers(e, planted_store(torch, e, dev))
    model = gnn.init(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    batch = graph_on_card(torch, g, dev)
    del batch["features"]
    batch["node_ids"] = torch.arange(N, dtype=torch.int32, device=dev)
    p = e.lma
    ids = torch.arange(0, N, N // GAT_LMA_CHECK, dtype=torch.int32,
                       device=dev)[:GAT_LMA_CHECK]
    mem = model.node_embed["memory"].detach()
    with torch.no_grad():
        zero(kernels)
        got = EmbeddingTable(e).embed(dict(model.node_embed), bufs, 0, ids)
        if counts(kernels) != {"fused_embed": 1}:
            raise AssertionError(f"the node lookup launched {counts(kernels)}")
        rows, support = get_scheme("lma").fused_inputs(e, bufs, ids)
        spec = fe.lma_spec(p)
        for lo in range(0, GAT_LMA_CHECK, GAT_LMA_CHUNK):
            s = slice(lo, lo + GAT_LMA_CHUNK)
            want = mem[fref.locations_ref(spec, ids[s], rows[s],
                                          support[s]).long()]
            if not torch.equal(got[s], want):
                raise AssertionError("the node lookup differs from the plain "
                                     f"split path (ids {lo}..)")
        n_fb = int((support < p.min_support).sum())
    zero(kernels)
    tr = gat_trainer(torch, cfg, model, lambda s: batch, dev, bufs=bufs)
    losses = gat_steps(torch, tr, GAT_LMA_STEPS, "gat lma")
    launches = counts(kernels)
    k = GAT_LMA_STEPS
    want = ({"fused_embed": k, "fused_locations": k, "sparse_adam": k}
            if tr.sparse_grads else {"fused_embed": k,
                                     "fused_scatter_add": k})
    if launches != want:
        raise AssertionError(f"gat lma launched {launches}, want {want}")
    if tr.sparse_grads and tr.params["node_embed.memory"].grad is not None:
        raise AssertionError("the node pool's .grad is set on the sparse "
                             "path")
    out = {"pool_slots": p.m, "stripe": p.stripe, "dim": p.d,
           "checked_ids": GAT_LMA_CHECK, "fallback_ids": n_fb,
           "sparse_grads": tr.sparse_grads, "losses": losses,
           "launches": {"gat lma": launches}, **gat_run_stats(torch, tr)}
    log(f"36e: node ids through LMA m={p.m} (stripe {p.stripe}, d={p.d}, "
        f"max_set {p.max_set}): {GAT_LMA_CHECK} ids ({n_fb} fallback) "
        f"bit-equal to the plain split path; {k} steps "
        f"({'sparse' if tr.sparse_grads else 'dense'} pool gradient), losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}, launches {launches}; "
        f"{out['steps_per_sec']:.3f} steps/s, split {out['split_ms']}, peak "
        f"{out['peak_gib']:.2f} GiB")
    return out


def run_gat(torch, dev, kernels, card, graphs: GraphBuilder) -> dict:
    """Phase 36: the GAT (gat-cora's four shapes) trained at full width on
    the card, and its id-feature path through an LMA table."""
    t_phase = time.perf_counter()
    free(torch)
    out = {"card": card, "cora": gat_cora(torch, dev, kernels),
           "molecule": gat_molecule(torch, dev, kernels)}
    products, sampler, secs = graphs.take()
    out["graphs_s"] = secs
    log(f"36: graphs built beside the earlier phases ({secs}); products "
        f"{len(products.src)} edges, Reddit-like {len(sampler.graph.src)}")
    out["minibatch_lg"] = gat_block(torch, dev, kernels, sampler)
    del sampler
    out["ogb_products"] = gat_products(torch, dev, kernels, products)
    out["lma"] = gat_lma(torch, dev, kernels, products)
    free(torch)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 36: {out['seconds']:.1f} s")
    return out


# ---------------------------------------- the MoE and MLA LMs (phase 37)

MOE_LAYERS = 4                  # full width, reduced depth: the one cut
MOE_ARCH, SCOUT_ARCH = "deepseek-v3-671b", "llama4-scout-17b-a16e"
# param_count at MOE_LAYERS (deepseek: 3 dense + 1 MoE layer; scout: 4 MoE)
MOE_PARAMS = {MOE_ARCH: 15_111_028_736, SCOUT_ARCH: 10_877_337_600}
# int8 cache bytes a token: MLA's fused latent (512 + 64) + a float32 scale
# a layer; scout's K and V (8 heads of 128) + 16 scales a layer
MOE_CACHE_TOKEN_BYTES = {MOE_ARCH: 4 * 580, SCOUT_ARCH: 4 * 2_112}
# 37b: 4 sequences, most of which must keep their routes (route_check)
MOE_CHECK_B, MOE_CHECK_S = 4, 128
MOE_AGREE = 3
# the largest router-logit shift of the int8 decode against the prefill
# at a MoE layer whose input routes agreed so far: the H100 read 0.0602
# (deepseek-v3) and 0.0590 (scout) over 4 sequences; a third above that
ROUTE_SHIFT = 0.08
MLA_F32_TOL = 1e-4              # absorbed decode vs expanded, float32
MOE_NORM_TOL = 2e-2             # bf16's 2^-8 on h, ye and the combine
MOE_SERVE_PROMPTS, MOE_SERVE_NEW = 32, 64        # 37c, lengths SERVE_LENS
# 16 slots a wave: a wave's prefill holds [16, 128, 512, 1,024] float32
# score tiles (4.3 GB) beside 30 GB of weights
MOE_SERVE_SLOTS = 16
MOE_SERVE_MAX_LEN = SERVE_LENS[1] + MOE_SERVE_NEW
MOE_PREFILL_B = 1               # 37e, 37f (the published 32 is a mesh's)
MOE_LMA_B, MOE_LMA_S = 4, 1024  # 37g
MOE_LMA_DECODE_STEPS = 16
LAUNCH_STEPS = 3                # 37h: each LM arch's smoke config
LAUNCH_LOSS = re.compile(r"\[trainer\] step (\d+) loss (\S+)")


@contextlib.contextmanager
def moe_calls(torch, calls: list, keep: bool = False):
    """Within: each ``moe.moe_apply`` call appends to ``calls`` its tokens
    T and, from the call's own ``stats``, its capacity C and expert load,
    with CUDA events recorded around it; nothing waits on the card and
    nothing is routed twice.  On leaving (one synchronize): each call's
    largest expert load, the (token, expert) assignments dropped past C
    (``moe.dropped``) and its device ms.  With ``keep``: also its input x,
    router logits and each token's experts ``top_i``."""
    from repro_torch.nn import moe

    apply = moe.moe_apply

    def wrapped(p, cfg, x):
        stats = {}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = apply(p, cfg, x, stats=stats)
        end.record()
        rec = {"T": x.shape[0], "C": stats["C"], "load": stats["load"],
               "events": (start, end)}
        if keep:
            rec.update(x=x, logits=stats["logits"], top_i=stats["top_i"])
        calls.append(rec)
        return out
    moe.moe_apply = wrapped
    try:
        yield calls
    finally:
        moe.moe_apply = apply
        torch.cuda.synchronize()
        for c in calls:
            start, end = c.pop("events")
            load = c.pop("load")
            c.update(max_load=int(load.max()),
                     dropped=int(moe.dropped(load, c["C"])),
                     ms=start.elapsed_time(end))


def moe_model(torch, arch: str, dev, card: str, embedding=None):
    """``arch`` at full width and MOE_LAYERS layers (with ``embedding``:
    its token table), random weights from the seed, on the card; its
    parameter count and cache bytes a token checked."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tt

    free(torch)
    cfg = dataclasses.replace(get_config(arch).make_model(),
                              n_layers=MOE_LAYERS, embedding=embedding)
    t0 = time.perf_counter()
    model = tt.init(cfg, seed=SEED, device=dev).eval()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    total, active = tt.param_count(cfg)
    per_token = tt.cache_bytes_per_token(cfg)
    if per_token != MOE_CACHE_TOKEN_BYTES[arch] or (
            embedding is None and total != MOE_PARAMS[arch]):
        raise AssertionError(f"{arch}: {total} parameters, {per_token} "
                             "cache bytes a token")
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"{arch} at {MOE_LAYERS} of {get_config(arch).make_model().n_layers}"
        f" layers {cfg.layer_groups()} (d {cfg.d_model}, {cfg.n_heads} "
        f"heads, {cfg.attention}, {cfg.moe.n_experts} experts top-"
        f"{cfg.moe.top_k} + {cfg.moe.n_shared_experts} shared, d_ff "
        f"{cfg.moe.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}, "
        f"{cfg.kv_cache_dtype} cache"
        f"{', an LMA token table' if embedding else ''}"
        f"): {total:,} parameters ({active:,} active) by param_count, "
        f"{nbytes / 1e9:.3f} GB; {per_token:,} cache bytes a token; built "
        f"in {secs:.1f} s ({card})")
    return cfg, model, {"params": total, "active": active, "bytes": nbytes,
                        "cache_bytes_per_token": per_token,
                        "build_s": secs}


def drop_free(cfg):
    """``cfg`` at the reference's drop-free capacity factor E / k * 1.05
    (``tests/test_models_smoke.py``): C >= T for any batch."""
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k * 1.05))


def plain_moe(torch, p, cfg, x):
    """The MoE layer written independently: each token's top-k experts by
    the float32 router, each expert's tokens through its FFN in float32 on
    the bf16 weights, summed per token in float32; the shared expert too.
    No capacity: the caller's cfg drops nothing."""
    import torch.nn.functional as F

    xf = x.float()
    logits = xf @ p.router.weight.T
    scores = torch.sigmoid(logits) if cfg.router == "sigmoid" \
        else torch.softmax(logits, dim=-1)
    w, idx = torch.topk(scores, cfg.top_k, dim=-1)
    w = w / w.sum(dim=-1, keepdim=True)
    out = torch.zeros_like(xf)
    for e in range(cfg.n_experts):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = xf[tok]
        h = F.silu(xe @ p.w_gate[e].float()) * (xe @ p.w_up[e].float())
        out.index_add_(0, tok, (h @ p.w_down[e].float()) * w[tok, slot, None])
    if cfg.n_shared_experts > 0:
        s = p.shared
        out += F.linear(F.silu(F.linear(xf, s.gate.weight.float()))
                        * F.linear(xf, s.up.weight.float()),
                        s.down.weight.float())
    return out


def route_check(torch, pre: list, dec: list, S: int) -> list:
    """Per sequence b, the int8 decode's MoE calls against the prefill's
    at token S - 1, layer by layer up to the first whose experts differ:
    the router's input x within the int8 bound (``int8_close``) and its
    largest logit shift; -> [{"shift": [...], "x_err": [...], "parted":
    (layer, the prefill router's gap between the two experts that
    swapped) or None}]."""
    out = []
    for b in range(dec[0]["top_i"].shape[0]):
        t = b * S + S - 1
        r = {"shift": [], "x_err": [], "parted": None}
        for li, (p, d) in enumerate(zip(pre, dec)):
            zp, zd = p["logits"][t], d["logits"][b]
            r["shift"].append(float((zd - zp).abs().max()))
            r["x_err"].append(int8_close(
                torch, d["x"][b], p["x"][t],
                f"sequence {b}'s MoE layer {li} input, int8 decode vs "
                "prefill"))
            ep, ed = set(p["top_i"][t].tolist()), set(d["top_i"][b].tolist())
            if ep != ed:
                r["parted"] = (li, float(zp[list(ep - ed)].min()
                                         - zp[list(ed - ep)].max()))
                break
        out.append(r)
    return out


def moe_check(torch, cfg, model, dev, card: str) -> dict:
    """37b: at the drop-free capacity factor, the decode of the last token
    from the int8 prefill cache of S - 1 tokens against the prefill over
    all S (the int8 bound, the prefill's top-1 among the decode's top-5);
    one MLA layer copied to float32, its absorbed decode against
    ``mla_train``'s last position (MLA_F32_TOL); the MoE layer against
    ``plain_moe`` (normwise MOE_NORM_TOL).

    The int8 cache moves a router's logits a little (ROUTE_SHIFT at
    most), and a token whose k-th and (k+1)-th logits are closer than that
    swaps an expert: its output then jumps by a whole expert's (top-1: all
    of it), which no logits bound covers.  So ``route_check`` holds every
    sequence's router input within the int8 bound and its logit shift
    within ROUTE_SHIFT at each MoE layer up to the first where its experts
    part (its hidden state, up to the layer before the flip); the logits
    bound holds the sequences whose routes agree throughout, MOE_AGREE of
    the B at least."""
    import copy

    from repro_torch.data.lm_data import LMGenerator
    from repro_torch.models import transformer as tt
    from repro_torch.nn import moe
    from repro_torch.nn.attention import mla_decode, mla_train

    B, S = MOE_CHECK_B, MOE_CHECK_S
    tokens = torch.from_numpy(LMGenerator(cfg.vocab_size, seed=SEED).batch(
        B, S, 0)["tokens"]).to(dev)
    dcfg = drop_free(cfg)
    res = {"B": B, "S": S, "capacity_factor": dcfg.moe.capacity_factor}
    n_moe = dict(cfg.layer_groups())["moe"]
    calls = []
    with torch.no_grad(), moe_calls(torch, calls, keep=True):
        full, _ = tt.prefill(model, dcfg, tokens)
        cache = tt.init_cache(dcfg, B, S, dev)
        _, cache = tt.prefill(model, dcfg, tokens[:, :-1], cache=cache)
        dec, _ = tt.decode_step(model, dcfg, tokens[:, -1], cache, S - 1)
        del cache
    for t in (full, dec):
        if t.shape != (B, cfg.vocab_size) or not bool(t.isfinite().all()):
            raise AssertionError("MoE LM logits are not finite [B, V]")
    routes = route_check(torch, calls[:n_moe], calls[2 * n_moe:], S)
    del calls
    res["routes"] = routes
    res["route_shift_max"] = max(max(r["shift"]) for r in routes)
    kept = [b for b, r in enumerate(routes) if r["parted"] is None]
    parted = {b: r["parted"] for b, r in enumerate(routes)
              if r["parted"] is not None}
    shifts = [[round(x, 5) for x in r["shift"]] for r in routes]
    if res["route_shift_max"] > ROUTE_SHIFT or len(kept) < MOE_AGREE:
        raise AssertionError(
            f"routes of the int8 decode vs the prefill: router logit "
            f"shifts by sequence and layer {shifts} (tol {ROUTE_SHIFT}); "
            f"parted (layer, gap) {parted}; {len(kept)} of {B} agree "
            f"(want {MOE_AGREE})")
    res["decode_vs_prefill"] = int8_close(torch, dec[kept], full[kept],
                                          "int8 decode vs prefill")
    top5 = torch.topk(dec[kept].float(), INT8_TOPK, dim=-1).indices
    if not bool((top5 == full[kept].float().argmax(-1)[:, None]).any(
            -1).all()):
        raise AssertionError("the prefill's top-1 is not among the int8 "
                             f"decode's top-{INT8_TOPK}")
    with torch.no_grad():
        x = tt.embed_tokens(model, cfg, tokens).to(cfg.torch_dtype)
        if cfg.attention == "mla":
            layer = model.groups()[0][0]
            m32 = copy.deepcopy(layer.attn).float()
            h = layer.norm_attn(x).float()
            out, kv = mla_train(m32, cfg.mla, h, block=cfg.attn_block,
                                return_kv=True)
            c = {"ckv": torch.zeros_like(kv["ckv"])}
            c["ckv"][:, :S - 1] = kv["ckv"][:, :S - 1]
            got, _ = mla_decode(m32, cfg.mla, h[:, -1:], c, S - 1,
                                block=cfg.attn_block)
            res["mla_float32_decode_vs_train"] = float(
                (got - out[:, -1:]).abs().max())
            if not torch.allclose(got, out[:, -1:], rtol=MLA_F32_TOL,
                                  atol=MLA_F32_TOL):
                raise AssertionError(
                    "absorbed MLA decode vs mla_train: max |err| "
                    f"{res['mla_float32_decode_vs_train']:.3g}")
            del m32, out, kv, c
        layer = model.groups()[-1][0]
        h = layer.norm_ffn(x).reshape(B * S, cfg.d_model)
        got, _ = moe.moe_apply(layer.moe, dcfg.moe, h)
        want = plain_moe(torch, layer.moe, dcfg.moe, h)
        res["moe_vs_plain_normwise"] = float(
            torch.linalg.norm(got.float() - want) / torch.linalg.norm(want))
    if res["moe_vs_plain_normwise"] > MOE_NORM_TOL:
        raise AssertionError("the MoE layer vs its per-expert loop: "
                             f"normwise {res['moe_vs_plain_normwise']:.3g}")
    log(f"37b ({cfg.name}): B={B} S={S}, capacity factor "
        f"{res['capacity_factor']:.2f} (drop-free): router logit shifts of "
        f"the int8 decode by sequence and MoE layer {shifts} (largest "
        f"{res['route_shift_max']:.4g}, tol {ROUTE_SHIFT}), router inputs "
        f"within the int8 bound (largest |err| "
        f"{max(max(r['x_err']) for r in routes):.4f}); routes parted "
        f"(layer, gap) {parted or 'nowhere'}; int8 decode vs prefill over "
        f"the {len(kept)} sequences whose routes agree: max |err| "
        f"{res['decode_vs_prefill']:.4f} (rtol {INT8_RTOL}, atol "
        f"{INT8_ATOL}), the prefill's top-1 in the decode's top-{INT8_TOPK}"
        + (f"; one MLA layer in float32, absorbed decode vs mla_train "
           f"{res['mla_float32_decode_vs_train']:.3g} (tol {MLA_F32_TOL})"
           if "mla_float32_decode_vs_train" in res else "")
        + f"; the MoE layer vs its per-expert float32 loop normwise "
        f"{res['moe_vs_plain_normwise']:.3g} (tol {MOE_NORM_TOL}) ({card})")
    return res


def moe_serve(torch, cfg, model, dev, card: str) -> dict:
    """37c: the LMServer over 32 prompts of 128-1,024 tokens (seed 1), 64
    new tokens each, at the config's own capacity factor."""
    from repro_torch.serve import LMServer

    rng = np.random.default_rng(SEED + 1)
    lens = rng.integers(SERVE_LENS[0], SERVE_LENS[1] + 1, MOE_SERVE_PROMPTS)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, n)))
               for n in lens]
    server = LMServer(model, cfg, n_slots=MOE_SERVE_SLOTS,
                      max_len=MOE_SERVE_MAX_LEN)
    free(torch)
    calls, mcalls = {}, []
    with lm_timed(torch, calls), moe_calls(torch, mcalls):
        t0 = time.perf_counter()
        results = server.generate(prompts, max_new_tokens=MOE_SERVE_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    waves = -(-MOE_SERVE_PROMPTS // MOE_SERVE_SLOTS)
    want = {"waves": waves, "decode_steps": waves * (MOE_SERVE_NEW - 1),
            "generated": MOE_SERVE_PROMPTS * MOE_SERVE_NEW}
    if server.stats != want or not all(
            len(r.tokens) == MOE_SERVE_NEW
            and all(0 <= t < cfg.vocab_size for t in r.tokens)
            for r in results):
        raise AssertionError(f"LMServer stats {server.stats}, want {want}")
    # the MoE calls of a wave: its prefill's n_moe, then n_moe a step
    n_moe = dict(cfg.layer_groups())["moe"]
    per_wave = n_moe * MOE_SERVE_NEW
    prefill_moe = [c for i, c in enumerate(mcalls) if i % per_wave < n_moe]
    decode_moe = [c["ms"] for i, c in enumerate(mcalls)
                  if i % per_wave >= n_moe]
    out = {"prompts": MOE_SERVE_PROMPTS, "slots": MOE_SERVE_SLOTS,
           "lengths": [int(lens.min()), int(lens.max())],
           "stats": dict(server.stats), "prefill_ms": calls["prefill"],
           "decode_step_ms_median": float(np.median(calls["decode_step"])),
           "generated_tokens_per_s": server.stats["generated"] / wall,
           "wall_s": wall, "peak_gib": peak,
           "prefill_moe": prefill_moe,
           "decode_moe_ms_median": float(np.median(decode_moe)) * n_moe}
    log(f"37c ({cfg.name}): LMServer {MOE_SERVE_PROMPTS} prompts "
        f"({out['lengths'][0]}-{out['lengths'][1]} tokens), n_slots "
        f"{MOE_SERVE_SLOTS}, max_new {MOE_SERVE_NEW}: {server.stats}; "
        f"prefill {', '.join(f'{x:.1f}' for x in calls['prefill'])} ms a "
        f"wave (MoE T={[c['T'] for c in prefill_moe[::n_moe]]}, C="
        f"{[c['C'] for c in prefill_moe[::n_moe]]}, dropped "
        f"{sum(c['dropped'] for c in prefill_moe)}), decode step median "
        f"{out['decode_step_ms_median']:.2f} ms (its MoE layers "
        f"{out['decode_moe_ms_median']:.2f} ms), "
        f"{out['generated_tokens_per_s']:.1f} generated tokens/s "
        f"({wall:.2f} s), peak {peak:.2f} GiB ({card})")
    return out


def moe_decode_32k(torch, cfg, model, dev, card: str) -> dict:
    """37d: decode_32k, B = 128 against a 32,768-token int8 cache, 5
    steps: the median step, peak memory, the MoE layers' share and their
    bytes bound (every expert read), one layer's whole-cache
    dequantization."""
    from repro_torch.models import transformer as tt
    from repro_torch.nn.attention import dequantize_kv

    free(torch)
    cache = tt.init_cache(cfg, DECODE_B, DECODE_L, dev)
    cache_gb = sum(t.numel() * t.element_size() for c in cache.values()
                   for t in c.values()) / 1e9
    t0 = time.perf_counter()
    fill_cache(torch, cfg, cache, dev)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(SEED + 38)
    ms, mcalls = [], []
    with torch.no_grad(), moe_calls(torch, mcalls):
        for step in range(DECODE_STEPS):
            tok = torch.randint(0, cfg.vocab_size, (DECODE_B,),
                                generator=gen, device=dev, dtype=torch.int32)
            at = DECODE_L - DECODE_STEPS + step
            (logits, _), t = events_ms(torch, lambda: tt.decode_step(
                model, cfg, tok, cache, at))
            ms.append(t)
            if not bool(logits.isfinite().all()):
                raise AssertionError("decode_32k logits are not finite")
    peak = torch.cuda.max_memory_allocated() / 2**30
    name = "ckv" if cfg.attention == "mla" else "k"
    c = cache["layers_0"]
    with torch.no_grad():
        _, deq_ms = events_ms(torch, lambda: dequantize_kv(
            c[name][0], c[f"{name}_scale"][0], cfg.torch_dtype))
    del cache, c
    med = float(np.median(ms))
    n_moe = dict(cfg.layer_groups())["moe"]
    moe_ms = float(np.median([x["ms"] for x in mcalls])) * n_moe
    experts = sum(p.numel() * p.element_size()
                  for g in model.groups() for layer in g
                  if layer.kind == "moe"
                  for p in (layer.moe.w_gate, layer.moe.w_up,
                            layer.moe.w_down))
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    out = {"B": DECODE_B, "cache_len": DECODE_L, "steps_ms": ms,
           "median_ms": med, "cache_gb": cache_gb, "peak_gib": peak,
           "fill_s": fill_s,
           "bytes_bound_ms": (cache_gb * 1e9 + weights)
           / HBM_BYTES_PER_S * 1e3,
           "moe_ms": moe_ms, "moe_share": moe_ms / med,
           "moe_T": mcalls[0]["T"], "moe_C": mcalls[0]["C"],
           "moe_bytes_bound_ms": experts / HBM_BYTES_PER_S * 1e3,
           "layer_dequantize_ms": deq_ms}
    log(f"37d ({cfg.name}): decode_32k B={DECODE_B} against a {DECODE_L}-"
        f"token int8 cache ({cache_gb:.2f} GB, filled in {fill_s:.1f} s): "
        f"steps {', '.join(f'{x:.1f}' for x in ms)} ms, median {med:.1f} ms "
        f"(reading the cache and weights once: {out['bytes_bound_ms']:.2f} "
        f"ms), peak {peak:.2f} GiB; MoE layers {moe_ms:.2f} ms a step "
        f"({100 * out['moe_share']:.1f}%; T={out['moe_T']}, C="
        f"{out['moe_C']}: every expert read, bound "
        f"{out['moe_bytes_bound_ms']:.2f} ms); one layer's whole-cache "
        f"dequantization {deq_ms:.2f} ms ({card})")
    return out


def moe_prefill_32k(torch, cfg, model, dev, card: str) -> dict:
    """37e / 37f: prefill_32k at B = 1 (the published 32 is a mesh's
    global batch): s, tokens/s, peak memory, the MoE layers' time, C and
    the assignments dropped past it."""
    from repro_torch.models import transformer as tt

    free(torch)
    gen = torch.Generator(device=dev).manual_seed(SEED + 39)
    tok = torch.randint(0, cfg.vocab_size, (MOE_PREFILL_B, PREFILL_S),
                        generator=gen, device=dev, dtype=torch.int32)
    mcalls = []
    with torch.no_grad(), moe_calls(torch, mcalls):
        cache = tt.init_cache(cfg, MOE_PREFILL_B, PREFILL_S, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = tt.prefill(model, cfg, tok, cache=cache)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if not bool(logits.isfinite().all()):
            raise AssertionError("prefill_32k logits are not finite")
    peak = torch.cuda.max_memory_allocated() / 2**30
    del cache, logits
    tokens = MOE_PREFILL_B * PREFILL_S
    out = {"B": MOE_PREFILL_B, "S": PREFILL_S, "seconds": secs,
           "tokens_per_s": tokens / secs, "peak_gib": peak,
           "moe": mcalls, "moe_s": sum(c["ms"] for c in mcalls) / 1e3,
           "dropped": sum(c["dropped"] for c in mcalls),
           "reduced": "batch 32 -> 1 (the published 32 is a mesh's global "
                      "batch)"}
    log(f"37{'e' if cfg.attention == 'mla' else 'f'} ({cfg.name}): "
        f"prefill_32k B={MOE_PREFILL_B} S={PREFILL_S}: {secs:.2f} s, "
        f"{tokens / secs:.0f} tokens/s, peak {peak:.2f} GiB; MoE layers "
        f"{out['moe_s']:.2f} s (T={mcalls[0]['T']}, C={mcalls[0]['C']}, "
        f"largest expert load {max(c['max_load'] for c in mcalls)}, "
        f"{out['dropped']} assignments dropped over {len(mcalls)} layers) "
        f"({card})")
    return out


def moe_lma(torch, dev, kernels, card: str) -> dict:
    """37g: deepseek-v3 with an LMA token table (129,280 x 7,168 at alpha
    16 over a planted D' store): row 2's lookup (``embed_tokens``)
    bit-equal to the plain split path, timed at the prefill and decode
    shapes beside its bound; a prefill and 16 decode steps, row 2 once
    each."""
    from repro_torch.configs import get_config
    from repro_torch.configs._recsys_common import embedding_of_kind
    from repro_torch.data.lm_data import LMGenerator
    from repro_torch.embed import get_scheme, make_buffers
    from repro_torch.kernels.fused_embed import ops as fe
    from repro_torch.kernels.fused_embed import ref as fref
    from repro_torch.kernels.fused_embed.kernel import fused_lookup_cuda
    from repro_torch.models import transformer as tt

    base = get_config(MOE_ARCH).make_model()
    e = embedding_of_kind("lma", (base.vocab_size,), base.d_model,
                          expansion=16.0, max_set=32)
    cfg, model, info = moe_model(torch, MOE_ARCH, dev, card, embedding=e)
    bufs = make_buffers(e, planted_store(torch, e, dev))
    p = e.lma
    spec = fe.lma_spec(p)
    mem = model.embed["memory"].detach()
    B, S = MOE_LMA_B, MOE_LMA_S
    tokens = torch.from_numpy(LMGenerator(cfg.vocab_size, seed=SEED).batch(
        B, S, 0)["tokens"]).to(dev)
    gids = tokens.reshape(-1).contiguous()
    rows, support = get_scheme("lma").fused_inputs(e, bufs, gids)
    with torch.no_grad():
        zero(kernels)
        got = tt.embed_tokens(model, cfg, tokens, bufs)
        if counts(kernels) != {"fused_embed": 1}:
            raise AssertionError(f"embed_tokens launched {counts(kernels)}")
        plain_ms = 0.0
        for lo in range(0, gids.numel(), LMA_CHUNK):
            part = (gids[lo:lo + LMA_CHUNK], rows[lo:lo + LMA_CHUNK],
                    support[lo:lo + LMA_CHUNK])
            want, t = events_ms(torch, lambda: mem[
                fref.locations_ref(spec, *part).long()])
            plain_ms += t
            if not torch.equal(got.reshape(-1, p.d)[lo:lo + LMA_CHUNK],
                               want):
                raise AssertionError("the LMA token table's lookup differs "
                                     f"from the plain split path (tokens "
                                     f"{lo}..)")
        del got, want
        n_fb = int((support < p.min_support).sum())
        timing = {}
        for label, n in (("prefill", gids.numel()), ("decode", B)):
            a = (gids[:n], rows[:n], support[:n])
            r = timing[label] = {"tokens": n}
            r["ms"] = graph_ms(torch, lambda: fused_lookup_cuda(
                spec, mem, *a), 20)
            r["bound_ms"], r["bound_by"] = bound(
                *lma_work(torch, p, a[1], a[2], fallback=True),
                INT32_OP_PER_S)
        timing["prefill"]["plain_ms"] = plain_ms
        timing["sweep"] = row2_sweep(torch, p, spec, mem, gids, rows,
                                     support, dev)
        rows_4_10 = chunk_sweep(torch, p, spec, mem, gids, rows, support,
                                timing["sweep"])
        zero(kernels)
        cache = tt.init_cache(cfg, B, S + MOE_LMA_DECODE_STEPS, dev)
        logits, cache = tt.prefill(model, cfg, tokens, bufs, cache=cache)
        launches = {"lm moe lma prefill": counts(kernels)}
        zero(kernels)
        cur = logits.argmax(-1).to(torch.int32)
        for step in range(MOE_LMA_DECODE_STEPS):
            logits, cache = tt.decode_step(model, cfg, cur, cache, S + step,
                                           bufs)
            cur = logits.argmax(-1).to(torch.int32)
        launches["lm moe lma decode"] = counts(kernels)
        if not bool(logits.isfinite().all()):
            raise AssertionError("LMA MoE LM logits are not finite")
    want = {"lm moe lma prefill": {"fused_embed": 1},
            "lm moe lma decode": {"fused_embed": MOE_LMA_DECODE_STEPS}}
    if launches != want:
        raise AssertionError(f"LMA MoE LM launches {launches}, want {want}")
    out = {"pool_slots": p.m, "stripe": p.stripe, "fallback_tokens": n_fb,
           "row2": timing, "rows_4_10": rows_4_10, "launches": launches,
           "build": info}
    log(f"37g: {MOE_ARCH} with an LMA token table m={p.m} (stripe "
        f"{p.stripe}, d={p.d}, n_h={p.n_h}, max_set {p.max_set}): "
        f"embed_tokens over {gids.numel()} tokens ({n_fb} fallback) "
        f"bit-equal to the plain split path ({plain_ms:.1f} ms in "
        f"{-(-gids.numel() // LMA_CHUNK)} chunks); row 2 at {gids.numel()} "
        f"tokens {timing['prefill']['ms']:.4f} ms (bound "
        f"{timing['prefill']['bound_ms']:.4f} ms), at {B} tokens "
        f"{timing['decode']['ms']:.4f} ms (bound "
        f"{timing['decode']['bound_ms']:.4f} ms); launches {launches} "
        f"({card})")
    del model
    return out


def lm_launchers(torch, card: str) -> dict:
    """37h: the port's launcher (``repro_torch.launch.train.main``) on the
    card for every registered LM arch, its smoke config for LAUNCH_STEPS
    steps: every step's loss finite (the launcher's log line each step), no
    step skipped, deepseek-v3's optimizer state Adafactor's and the others'
    Adam's (the Trainer the launcher built); steps/s (the median step, the
    Trainer's clock) and each run's seconds."""
    import io

    from repro_torch.configs import get_config
    from repro_torch.configs.base import list_archs
    from repro_torch.launch import train as launch
    from repro_torch.optim.optimizers import AdafactorState, AdamState

    made = []

    class Recorded(launch.Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    out = {}
    t_all = time.perf_counter()
    plain, launch.Trainer = launch.Trainer, Recorded
    try:
        for arch in [a for a in list_archs()
                     if get_config(a).family == "lm"]:
            text = io.StringIO()
            made.clear()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(text):
                res = launch.main(["--arch", arch,
                                   "--steps", str(LAUNCH_STEPS)])
            seconds = time.perf_counter() - t0
            losses = [float(v)
                      for _, v in LAUNCH_LOSS.findall(text.getvalue())]
            name = get_config(arch).optimizer
            st = made[0].opt_state
            # multi_transform keeps a state a parameter
            ran = (isinstance(st, AdafactorState) if name == "adafactor"
                   else name == "adam" and all(
                       isinstance(x, AdamState) for x in
                       (st.values() if isinstance(st, dict) else [st])))
            if (len(losses) != LAUNCH_STEPS or not np.isfinite(losses).all()
                    or res["train"]["skipped_steps"] or not ran):
                raise AssertionError(
                    f"37h: the launcher's {arch} run: losses {losses}, "
                    f"{res['train']}, optimizer state "
                    f"{type(st).__name__} (the arch's {name})")
            out[arch] = {"losses": losses, "optimizer": name,
                         "steps_per_sec": res["train"]["steps_per_sec"],
                         "seconds": seconds}
            log(f"37h: the launcher's {arch} (smoke, {name}): losses "
                f"{', '.join(f'{x:.4f}' for x in losses)}, "
                f"{res['train']['steps_per_sec']:.2f} steps/s, "
                f"{seconds:.1f} s ({card})")
    finally:
        launch.Trainer = plain
    if set(out) != {"tinyllama-1.1b", "stablelm-3b", "qwen1.5-32b",
                    MOE_ARCH, SCOUT_ARCH}:
        raise AssertionError(f"37h: LM archs {sorted(out)}")
    out["seconds"] = time.perf_counter() - t_all
    log(f"37h: {len(out) - 1} LM archs through the launcher in "
        f"{out['seconds']:.1f} s")
    return out


def run_moe(torch, dev, kernels, card) -> dict:
    """Phase 37: deepseek-v3-671b and llama4-scout-17b-a16e at full width
    and MOE_LAYERS layers on the card, bf16 with an int8 cache, random
    weights from the seed, one model at a time."""
    t_phase = time.perf_counter()
    out = {"card": card, "layers": MOE_LAYERS}
    cfg, model, out["deepseek"] = moe_model(torch, MOE_ARCH, dev, card)
    ds = out["deepseek"]
    ds["check"] = moe_check(torch, cfg, model, dev, card)
    ds["serve"] = moe_serve(torch, cfg, model, dev, card)
    ds["decode_32k"] = moe_decode_32k(torch, cfg, model, dev, card)
    ds["prefill_32k"] = moe_prefill_32k(torch, cfg, model, dev, card)
    del model
    cfg, model, out["scout"] = moe_model(torch, SCOUT_ARCH, dev, card)
    sc = out["scout"]
    sc["check"] = moe_check(torch, cfg, model, dev, card)
    sc["serve"] = moe_serve(torch, cfg, model, dev, card)
    sc["prefill_32k"] = moe_prefill_32k(torch, cfg, model, dev, card)
    del model
    out["lma"] = moe_lma(torch, dev, kernels, card)
    free(torch)
    out["launcher"] = lm_launchers(torch, card)
    free(torch)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 37: {out['seconds']:.1f} s")
    return out


# ------------------------------------------------ LM training (phase 38)

TRAIN_S = 4096                  # train_4k's sequence (LM_SHAPE_TABLE)
# 38a / 38b: the largest power of two that fits one card, by the reckoning
# (``train_reckoning``: 8 fits, 16 does not) and the measured peak
TRAIN_B = 8
TRAIN_TIMED = 3                 # 38a: steps timed after one warm step
LMA_TRAIN_TIMED = 1             # 38b: after its checked step (time limit)
MOE_TRAIN_TIMED = 2             # 38c, after one warm step
# 38c's depths: each arch's fewest layers that hold a MoE layer (and for
# deepseek a dense one) up to phase 37's MOE_LAYERS; the leading dense
# layers as the config has them, cut to leave the last layer a MoE one
MOE_TRAIN_MIN = {MOE_ARCH: 2, SCOUT_ARCH: 1}
FIT_SHARE = 0.97                # of the card's memory a reckoned peak may take
GB = 1e9


def train_reckoning(torch, cfg, batches, optimizer: str, S: int = TRAIN_S,
                    mesh_shape: tuple | None = None) -> dict:
    """What a train step of ``cfg`` at sequence ``S`` holds on the card at
    each batch B of ``batches``, reckoned from the code before it runs
    (parameter shapes from a model on the meta device); -> {B: reckoning}:
    - ``state``: each parameter in its dtype, its gradient (the same),
      Adam's two float32 moments (12 B a bf16 parameter) or Adafactor's
      factored float32 moments, and the updates, which the Trainer holds in
      the parameter's dtype until it applies them;
    - ``backward``, beyond the state: every layer's input ([B, S, d], the
      checkpoint), one layer's recompute (the causal triangle's score
      tiles, [B, H, q_block, attn_block] float32, three kept a tile: the
      scores, their exponent, its float32 copy for the value product; four
      [B, S, d_ff] activations of its FFN, or of a MoE its shared expert and
      [E, C, d_ff] expert buffers), the float32 output table and its
      gradient, and one loss chunk's [B, chunk, V] float32 logits (three);
    - ``update``, beyond the state, one leaf at a time: Adam's temporaries,
      32 B an element of the largest leaf or of its ``ADAM_SLICE`` rows
      (the float32 gradient, its square, the scaled first moment, nu's
      quotient and its float64 copy and root); Adafactor's five float32
      temporaries of the largest leaf.
    The peak is the state plus the larger of the two.  With ``mesh_shape``
    = (D, M), a rank's under that mesh (rank 0's ``lm_rules`` blocks): its
    B / D sequences, H / M heads, d_ff / M and the output table's V / M
    rows and logits; beside the peak the largest leaf the step gathers over
    'data' (D > 1) and its gradient before the reduce-scatter
    (``gathered``), and a context: ``rank_gb``, the card's ``total_gb``."""
    from repro_torch.dist.context import Mesh
    from repro_torch.dist.sharding import spec_axes, stored_spec
    from repro_torch.models import transformer as tt
    from repro_torch.nn.moe import moe_capacity
    from repro_torch.optim.optimizers import adafactor
    from repro_torch.optim.sparse import ADAM_SLICE

    D, M = mesh_shape or (1, 1)
    mesh = Mesh(model=M, data=D) if mesh_shape else None
    with torch.device("meta"):
        model = tt.Transformer(cfg, torch.Generator(), torch.device("meta"),
                               mesh=mesh, train=mesh is not None)
    params = dict(model.named_parameters())
    n = sum(p.numel() for p in params.values())
    own = sum(p.numel() * p.element_size() for p in params.values())
    largest = max(p.numel() for p in params.values())
    if optimizer == "adafactor":
        st = adafactor(1e-3).init(params)
        moments = 4 * sum(x.numel() for v in st.vs.values()
                          for x in v.values())
        update = 5 * 4 * largest
    else:
        moments, update = 8 * n, 32 * min(largest, ADAM_SLICE)
    state = 3 * own + moments

    def gathered(p) -> int:
        spec = stored_spec(p)
        over = D > 1 and spec is not None and any(
            "data" in spec_axes(spec, i) for i in range(len(spec)))
        return 2 * p.numel() * p.element_size() * D if over else 0
    big = max(gathered(p) for p in params.values())
    d, H, V = cfg.d_model, cfg.n_heads, cfg.vocab_size
    qb, blk = min(512, S), cfg.attn_block
    tiles = sum(-(-min(lo + qb, S) // blk) for lo in range(0, S, qb))
    act = 2 if cfg.dtype == "bfloat16" else 4
    chunk = cfg.loss_chunk if 0 < cfg.loss_chunk < S else S
    out = {}
    for B in batches:
        Bl = B // D
        layer = 3 * tiles * Bl * (H // M) * qb * blk * 4
        if cfg.moe is None:
            layer += 4 * Bl * S * (cfg.d_ff // M) * act
        else:
            m = cfg.moe
            C = min(moe_capacity(m, Bl * S), Bl * S)
            layer += 4 * act * (Bl * S * m.d_ff * m.n_shared_experts // M
                                + m.n_experts // M * C * (m.d_ff + d))
        backward = (cfg.n_layers * Bl * S * d * act + layer
                    + 2 * V // M * d * 4 + 3 * Bl * chunk * V // M * 4)
        r = out[B] = {"B": B, "S": S, "layers": cfg.n_layers, "params": n,
                      "state_gb": state / GB, "backward_gb": backward / GB,
                      "update_gb": update / GB,
                      "peak_gb": (state + max(backward, update)) / GB,
                      "optimizer": optimizer}
        if mesh is not None:
            r.update(mesh=mesh_shape, gathered_gb=big / GB,
                     rank_gb=r["peak_gb"] + big / GB + CONTEXT_GB)
            r["total_gb"] = r["rank_gb"] * D * M
    return out


def reckoning_line(r: dict, card_gb: float) -> str:
    fits = r["peak_gb"] <= FIT_SHARE * card_gb
    return (f"{r['layers']} layers, B={r['B']}, S={r['S']}: {r['params']:,} "
            f"parameters, {r['optimizer']} state {r['state_gb']:.1f} GB + "
            f"max(backward {r['backward_gb']:.1f}, update "
            f"{r['update_gb']:.1f}) GB = {r['peak_gb']:.1f} GB reckoned "
            f"against {FIT_SHARE:.0%} of the card's {card_gb:.1f} GB: "
            + ("fits" if fits else "does not fit"))


def lm_steps(torch, tr, first: int, n: int) -> tuple:
    """Steps ``first`` .. ``first + n - 1`` of ``tr`` (its batches by
    index), each timed on the host clock between synchronizations;
    -> (losses, seconds)."""
    losses, secs = [], []
    for step in range(first, first + n):
        tr.step, tr.cfg.total_steps = step, step + 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = tr.fit(log=lambda _: None)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if res["skipped_steps"] or not np.isfinite(res["loss"]):
            raise AssertionError(f"LM training step {step}: {res}")
        losses.append(res["loss"])
    return losses, secs


def lm_trainer(torch, arch_id, cfg, model, batches, B, dev, bufs=None,
               sparse=None, timer=None, opt=None):
    """The port's Trainer over ``cfg``'s ``loss_fn`` with the arch's
    optimizer as the launcher builds it (``make_optimizer``), the drawn
    batches of (arch, B, step)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import make_optimizer
    from repro_torch.models import transformer as tt
    from repro_torch.train.trainer import Trainer, TrainerConfig

    def loss(m, b):
        return tt.loss_fn(m, cfg, b["tokens"], b["labels"], bufs)
    return Trainer(TrainerConfig(total_steps=0, log_every=0), loss, model,
                   opt or make_optimizer(get_config(arch_id)),
                   lambda step: batches[(arch_id, B, step)],
                   sparse_grads=sparse,
                   on_phase=timer.mark if timer else None, device=dev)


def train_rates(B: int, secs: list) -> dict:
    sps = 1.0 / float(np.median(secs))
    return {"steps_per_sec": sps, "tokens_per_sec": sps * B * TRAIN_S,
            "step_s": secs}


def lm_train_dense(torch, dev, kernels, card, batches) -> dict:
    """38a: tinyllama-1.1b at full width and depth, train_4k at TRAIN_B:
    one warm step and TRAIN_TIMED timed, Adam as the launcher builds it."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tt

    cfg = get_config(LM_ARCH).make_model()
    if not (cfg.remat and cfg.loss_chunk == 512):
        raise AssertionError(f"{LM_ARCH}: remat {cfg.remat}, loss_chunk "
                             f"{cfg.loss_chunk}")
    card_gb = torch.cuda.get_device_properties(0).total_memory / GB
    rk = train_reckoning(torch, cfg, (TRAIN_B, 2 * TRAIN_B), "adam")
    for B, r in rk.items():
        log(f"38a reckoning, {LM_ARCH} {reckoning_line(r, card_gb)}")
    if (rk[TRAIN_B]["peak_gb"] > FIT_SHARE * card_gb
            or rk[2 * TRAIN_B]["peak_gb"] <= FIT_SHARE * card_gb):
        raise AssertionError(f"B={TRAIN_B} is not the largest power of two "
                             "the reckoning fits")
    model = tt.init(cfg, seed=SEED, device=dev)
    timer = PhaseTimer(torch)
    tr = lm_trainer(torch, LM_ARCH, cfg, model, batches, TRAIN_B, dev,
                    timer=timer)
    zero(kernels)
    torch.cuda.reset_peak_memory_stats()
    losses, secs = lm_steps(torch, tr, 0, 1 + TRAIN_TIMED)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if counts(kernels):
        raise AssertionError(f"the dense LM launched {counts(kernels)}")
    total = tt.param_count(cfg)[0]
    N = total - cfg.vocab_size * cfg.d_model
    L, S, d = cfg.n_layers, TRAIN_S, cfg.d_model
    flops = 6 * N + 6 * L * S * d
    out = {"arch": LM_ARCH, "B": TRAIN_B, "S": S, "layers": L,
           "losses": losses, **train_rates(TRAIN_B, secs[1:]),
           "phase_ms": timer.split_ms(), "peak_gib": peak,
           "reckoning": rk, "non_embedding_params": N,
           "flops_per_token": flops}
    out["mfu"] = out["tokens_per_sec"] * flops / BF16_FLOP_PER_S
    log(f"38a: {LM_ARCH} ({L} layers, d {d}, {cfg.dtype}, remat, loss_chunk "
        f"{cfg.loss_chunk}, Adam lr {get_config(LM_ARCH).learning_rate}) "
        f"train_4k at B={TRAIN_B}, S={S}: losses "
        + " ".join(f"{x:.5f}" for x in losses)
        + f"; {out['steps_per_sec']:.4f} steps/s, "
        f"{out['tokens_per_sec']:,.0f} tokens/s (host clock, median of "
        f"{TRAIN_TIMED} after a warm step); phases (ms, median) "
        + ", ".join(f"{k} {v:.1f}" for k, v in out["phase_ms"].items())
        + f"; peak {peak:.2f} GiB (reckoned {rk[TRAIN_B]['peak_gb']:.1f} "
        f"GB); model-FLOP utilisation {out['mfu']:.2%} = tokens/s x (6 N + "
        f"6 L S d) / 989 TFLOP/s (dense bf16), N = {N:,} parameters "
        f"without the {cfg.vocab_size:,} x {d} token table, {flops:.4g} "
        "flops a token; the attention's score and value products run in "
        f"float32 (67 TFLOP/s); card {card}")
    return out


def copy_state_(torch, dst, src):
    """``src``'s optimizer state copied into ``dst``'s tensors in place
    (no third copy of a model's moments); -> the state."""
    if isinstance(dst, torch.Tensor):
        return dst.copy_(src)
    if isinstance(dst, dict):
        return {k: copy_state_(torch, dst[k], src[k]) for k in dst}
    if isinstance(dst, tuple):
        parts = [copy_state_(torch, a, b) for a, b in zip(dst, src)]
        return type(dst)(*parts) if hasattr(dst, "_fields") else tuple(parts)
    return src


def lm_train_kernels(torch, arch, p, spec, mem, tokens, bufs, e, sg,
                     dev) -> dict:
    """38b's kernels at its shapes: row 4's locations bit-equal to
    ``locations_ref`` and row 2's lookups to the gather of those, chunk by
    chunk (LMA_CHUNK tokens); rows 2, 4, 5 and 9 timed by CUDA-graph replay
    beside their bounds (as PERF.md counts them: ``lma_work`` / ``hash_work``
    plus the floats each reads and writes; row 9's bytes: each index and
    value read, each update written, each touched slot's two moments read
    and written) and their plain versions, summed over the chunks: the
    locations (row 4), then the gather (row 2) or an ``index_add_`` (row
    5, ``scatter_add_ref``'s two parts), each part timed; row 9 also beside
    torch.optim.SparseAdam on the live entries' COO gradient."""
    from repro_torch.embed import get_scheme
    from repro_torch.kernels.fused_embed import ref as fref
    from repro_torch.kernels.fused_embed.kernel import (fused_locations_cuda,
                                                        fused_lookup_cuda,
                                                        fused_scatter_add_cuda)
    from repro_torch.kernels.sparse_update import ref as sref
    from repro_torch.kernels.sparse_update.kernel import sparse_adam_cuda

    gids = tokens.reshape(-1).contiguous()
    rows, support = get_scheme("lma").fused_inputs(e, bufs, gids)
    N = gids.numel()
    g = torch.randn((N, p.d), generator=torch.Generator(device=dev)
                    .manual_seed(SEED + 38), device=dev) * 1e-3
    plain = {"fused_embed": 0.0, "fused_locations": 0.0,
             "fused_scatter_add": 0.0}
    with torch.no_grad():
        loc = fused_locations_cuda(spec, gids, rows, support)
        looked = fused_lookup_cuda(spec, mem, gids, rows, support)
        dm = torch.zeros(p.m, device=dev)
        for lo in range(0, N, LMA_CHUNK):
            part = (gids[lo:lo + LMA_CHUNK], rows[lo:lo + LMA_CHUNK],
                    support[lo:lo + LMA_CHUNK])
            want, ms = events_ms(torch, lambda: fref.locations_ref(spec,
                                                                    *part))
            if not torch.equal(loc[lo:lo + LMA_CHUNK], want):
                raise AssertionError(f"row 4's locations differ from "
                                     f"locations_ref (tokens {lo}..)")
            got, gather = events_ms(torch, lambda: mem[want.long()])
            if not torch.equal(looked[lo:lo + LMA_CHUNK], got):
                raise AssertionError(f"row 2's lookup differs from the plain "
                                     f"split path (tokens {lo}..)")
            # the plain scatter-add is those locations, then an index_add_
            _, add = events_ms(torch, lambda: dm.index_add_(
                0, want.reshape(-1).long(), g[lo:lo + LMA_CHUNK].reshape(-1)))
            plain["fused_locations"] += ms
            plain["fused_embed"] += ms + gather
            plain["fused_scatter_add"] += ms + add
        del loc, looked, dm
        in_bytes, ops = hash_work(torch, p, rows, support)
        res = {}
        for name, fn, nbytes, work in (
                ("fused_embed", lambda: fused_lookup_cuda(
                    spec, mem, gids, rows, support),
                 *lma_work(torch, p, rows, support, fallback=True)),
                ("fused_locations", lambda: fused_locations_cuda(
                    spec, gids, rows, support), in_bytes + N * p.d * 4, ops),
                ("fused_scatter_add", lambda: fused_scatter_add_cuda(
                    spec, g, gids, rows, support),
                 in_bytes + N * p.d * 4 + N * p.d * 8 + p.m * 4, ops)):
            r = res[name] = {"tokens": N}
            r["ms"] = graph_ms(torch, fn, 5)
            r["plain_ms"] = plain[name]
            r["bound_ms"], r["bound_by"] = bound(nbytes, work, INT32_OP_PER_S)
            r["library_ms"] = None
        r = res["fused_scatter_add"]
        r["fill_ms"] = fill_ms(torch, p.m, dev, 5)
        r["kernel_fill_ms"] = kernel_fill_ms(torch, spec, g, gids, rows,
                                             support, 5)
        r.update(scatter_launch(torch, rows.shape[-1]))
        del g
        shape = tuple(sg.dense_shape)
        mu, nu = (torch.zeros(shape, device=dev) for _ in range(2))
        hyper = lazy_hyper(arch, 1)
        live = sg.indices[sg.indices < shape[0]]
        slots = int(torch.unique_consecutive(live).numel())
        K = sg.indices.numel()

        def run():
            return sparse_adam_cuda(sg.indices, sg.values, mu, nu,
                                    unique=sg.unique, **hyper)
        r = res["sparse_adam"] = {"K": K, "live": live.numel(),
                                  "slots": slots}
        r["ms"] = graph_ms(torch, run, 5)
        r["plain_ms"] = time_ms(torch, lambda: sref.sparse_adam_ref(
            sg.indices, sg.values, mu, nu, unique=sg.unique, **hyper), 2,
            warmup=1)
        r["bound_ms"], r["bound_by"] = bound(
            K * 8 + live.numel() * 4 + slots * 16, 0, 1.0)
    r["library_ms"] = library_sparse_ms(torch, torch.optim.SparseAdam, sg,
                                        shape, dev,
                                        lr=arch.learning_rate)
    del mu, nu
    for name, r in res.items():
        log(f"  38b {name} at "
            + (f"K={r['K']} ({r['slots']} slots)" if "K" in r
               else f"{r['tokens']} tokens, d={p.d}")
            + f": {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), {r['bound_ms'] / r['ms']:.1%} of bound, "
            f"plain {r['plain_ms']:.3f} ms"
            + (f", torch.optim.SparseAdam {r['library_ms']:.3f} ms of device "
               "time" if r["library_ms"] is not None else "")
            + (f"; the fill alone (m = {p.m}) {r['fill_ms']:.4f} ms, the "
               f"kernel's own {r['kernel_fill_ms']:.4f} ms, grid "
               f"{r['grid']} ({r['blocks_per_sm']} an SM), {r['registers']} "
               "registers" if "fill_ms" in r else ""))
    return res


def lm_train_lma(torch, dev, kernels, card, batches) -> dict:
    """38b: 38a's model with 35f's LMA token table (alpha 16, 4,096,000
    striped slots over a planted 32,000 x 32 D' store) and sparse pool
    gradients at TRAIN_B: one step from a common state taken densely (a
    second Trainer, sparse_grads=False: rows 2 and 5) and sparse (rows 2, 4
    and 9), held to each other by ``check_step``; then LMA_TRAIN_TIMED
    sparse steps timed; each path launches its rows once a step."""
    from repro_torch.configs import get_config
    from repro_torch.configs._recsys_common import embedding_of_kind
    from repro_torch.embed import make_buffers
    from repro_torch.kernels.fused_embed import ops as fe
    from repro_torch.launch.train import make_optimizer
    from repro_torch.models import transformer as tt

    arch = get_config(LM_ARCH)
    base = arch.make_model()
    e = embedding_of_kind("lma", (base.vocab_size,), base.d_model,
                          expansion=16.0, max_set=32)
    cfg = dataclasses.replace(base, embedding=e)
    model = tt.init(cfg, seed=SEED, device=dev)
    bufs = make_buffers(e, planted_store(torch, e, dev))
    p = e.lma
    pool = "embed.memory"
    params = dict(model.named_parameters())
    timer = PhaseTimer(torch)
    opts = {name: Recorder(make_optimizer(arch))
            for name in ("sparse", "dense")}
    trs = {name: lm_trainer(torch, LM_ARCH, cfg, model, batches, TRAIN_B,
                            dev, bufs=bufs, sparse=name == "sparse",
                            timer=timer if name == "sparse" else None,
                            opt=opts[name]) for name in ("sparse", "dense")}
    launches = {}
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        p0 = {k: q.detach().clone() for k, q in params.items()}
        st0 = {pool: clone_state(torch, trs["sparse"].opt_state[pool])}
        trs["dense"].opt_state = copy_state_(
            torch, trs["dense"].opt_state, trs["sparse"].opt_state)
    zero(kernels)
    dense_losses, _ = lm_steps(torch, trs["dense"], 0, 1)
    launches["lm train lma dense"] = counts(kernels)
    with torch.no_grad():
        p_dense = {k: q.detach().clone() for k, q in params.items()}
        for k, q in params.items():
            q.copy_(p0[k])
    zero(kernels)
    with raw_streams(torch, {}) as streams:
        losses, secs = lm_steps(torch, trs["sparse"], 0, 1)
    if params[pool].grad is not None:
        raise AssertionError(f"{pool} has a dense .grad on the sparse path")
    if losses != dense_losses:
        raise AssertionError(f"the sparse and dense steps' losses differ: "
                             f"{losses} / {dense_losses}")
    parity = {}
    states = {"sparse": trs["sparse"].opt_state,
              "dense": trs["dense"].opt_state}
    with torch.no_grad():
        check_step(torch, 1, p0, st0, p_dense, params, states, opts, arch,
                   parity, streams)
    sg = opts["sparse"].grads[pool]
    opts["sparse"].grads = opts["dense"].grads = None
    del p0, st0, p_dense, streams, states, trs["dense"]
    free(torch)
    more, secs_t = lm_steps(torch, trs["sparse"], 1, LMA_TRAIN_TIMED)
    losses += more
    launches["lm train lma"] = counts(kernels)
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {"lm train lma": {"fused_embed": 1 + LMA_TRAIN_TIMED,
                             "fused_locations": 1 + LMA_TRAIN_TIMED,
                             "sparse_adam": 1 + LMA_TRAIN_TIMED},
            "lm train lma dense": {"fused_embed": 1, "fused_scatter_add": 1}}
    if launches != want:
        raise AssertionError(f"LMA LM training launched {launches}, want "
                             f"{want}")
    tokens = torch.from_numpy(batches[(LM_ARCH, TRAIN_B, 0)]["tokens"]).to(
        dev)
    with torch.no_grad():
        mem = params[pool].detach()
        rows = lm_train_kernels(torch, arch, p, fe.lma_spec(p), mem, tokens,
                                bufs, e, sg, dev)
    par = parity[pool]
    out = {"arch": LM_ARCH, "B": TRAIN_B, "S": TRAIN_S, "pool_slots": p.m,
           "losses": losses, "dense_loss": dense_losses[0],
           **train_rates(TRAIN_B, secs_t), "phase_ms": timer.split_ms(),
           "peak_gib": peak, "launches": launches, "rows": rows,
           "parity": {k: v for k, v in par.items() if k != "worst"}}
    log(f"38b: {LM_ARCH} with an LMA token table (m={p.m}, stripe "
        f"{p.stripe}, d={p.d}), sparse pool gradients, train_4k at "
        f"B={TRAIN_B}: losses " + " ".join(f"{x:.5f}" for x in losses)
        + f" (the dense oracle's step 1 {dense_losses[0]:.5f}, bit-equal); "
        f"check_step: non-pool parameters and Adam states bit-identical, "
        f"pool slot sums within {par['max_sum_ratio']:.3g} of sum |g| "
        f"({par['max_tol_share']:.3g} of sum_tol), the sparse pool exactly "
        f"the plain lazy Adam of its SparseGrad, max |pool diff| "
        f"{par['max_pool_param_diff']:.3g}; {out['steps_per_sec']:.4f} "
        f"steps/s, {out['tokens_per_sec']:,.0f} tokens/s; phases (ms, "
        f"median) " + ", ".join(f"{k} {v:.1f}"
                                for k, v in out["phase_ms"].items())
        + f"; peak {peak:.2f} GiB (the check's copies included); launches "
        f"{launches}; card {card}")
    return out


def lm_train_moe(torch, arch_id, dev, kernels, card, batches) -> dict:
    """38c: ``arch_id`` at full width, train_4k at B=1, remat, its
    optimizer as the launcher builds it, at the deepest depth the
    reckoning fits (from MOE_TRAIN_MIN up to MOE_LAYERS); none fitting,
    the reckoning is the result.  One warm step, MOE_TRAIN_TIMED timed;
    each MoE layer's C and dropped assignments from its calls (the
    forward's and, as remat recomputes the layer, the backward's, which
    must route alike)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tt
    from repro_torch.nn import moe

    arch = get_config(arch_id)
    full = arch.make_model()
    card_gb = torch.cuda.get_device_properties(0).total_memory / GB
    chosen, lines = None, []
    for L in range(MOE_TRAIN_MIN[arch_id], MOE_LAYERS + 1):
        cfg = dataclasses.replace(full, n_layers=L, first_k_dense=min(
            full.first_k_dense, L - 1))
        r = train_reckoning(torch, cfg, (1,), arch.optimizer)[1]
        lines.append(r)
        log(f"38c reckoning, {arch_id} {cfg.layer_groups()}: "
            f"{reckoning_line(r, card_gb)}")
        if r["peak_gb"] > FIT_SHARE * card_gb:
            break
        chosen = (cfg, r)
    out = {"arch": arch_id, "optimizer": arch.optimizer, "reckoning": lines}
    if chosen is None:
        out["fits"] = False
        log(f"38c: {arch_id} ({arch.optimizer}) does not fit one card at "
            f"{MOE_TRAIN_MIN[arch_id]} layers, its fewest with a MoE layer"
            f"{' and a dense one' if full.first_k_dense else ''}; not run "
            f"(ROADMAP.md, Queue 1 item 2); card {card}")
        return out
    cfg, r = chosen
    free(torch)
    model = tt.init(cfg, seed=SEED, device=dev)
    tr = lm_trainer(torch, arch_id, cfg, model, batches, 1, dev)
    zero(kernels)
    torch.cuda.reset_peak_memory_stats()
    calls: list = []
    with moe_routes(torch, calls):
        losses, secs = lm_steps(torch, tr, 0, 1 + MOE_TRAIN_TIMED)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if counts(kernels):
        raise AssertionError(f"{arch_id} launched {counts(kernels)}")
    n_moe = sum(c for k, c in cfg.layer_groups() if k == "moe")
    if len(calls) != 2 * n_moe * (1 + MOE_TRAIN_TIMED):
        raise AssertionError(f"{arch_id}: {len(calls)} MoE calls in "
                             f"{1 + MOE_TRAIN_TIMED} steps of {n_moe} MoE "
                             "layers, each recomputed once")
    layers = []
    for i in range(0, len(calls), 2 * n_moe):
        fwd, rec = calls[i:i + n_moe], calls[i + n_moe:i + 2 * n_moe][::-1]
        for a, b in zip(fwd, rec):
            if a["C"] != b["C"] or not torch.equal(a["load"], b["load"]):
                raise AssertionError(f"{arch_id}: a MoE layer's recompute "
                                     "routed otherwise than its forward")
        layers.append([{"T": c["T"], "C": c["C"],
                        "dropped": int(moe.dropped(c["load"], c["C"])),
                        "max_load": int(c["load"].max())} for c in fwd])
    del calls
    del model, tr
    free(torch)
    out.update(fits=True, layers=cfg.n_layers, groups=cfg.layer_groups(),
               B=1, S=TRAIN_S, losses=losses, **train_rates(1, secs[1:]),
               peak_gib=peak, reckoned_gb=r["peak_gb"], moe=layers)
    log(f"38c: {arch_id} at {cfg.n_layers} of {full.n_layers} layers "
        f"{cfg.layer_groups()} (full width, {arch.optimizer}), train_4k at "
        f"B=1: losses " + " ".join(f"{x:.5f}" for x in losses)
        + f"; {out['steps_per_sec']:.4f} steps/s, "
        f"{out['tokens_per_sec']:,.0f} tokens/s; peak {peak:.2f} GiB "
        f"(reckoned {r['peak_gb']:.1f} GB); MoE layers by step (C, dropped "
        "of T x k): " + "; ".join(
            ", ".join(f"C {c['C']} dropped {c['dropped']}" for c in s)
            for s in layers) + f"; card {card}")
    return out


@contextlib.contextmanager
def moe_routes(torch, calls: list):
    """Within: each ``moe.moe_apply`` call appends its tokens T and its
    ``stats`` (capacity C, expert load) to ``calls`` before it runs, so a
    remat recompute that stops once it has rebuilt what the backward needs
    (past the stats, inside the call) is recorded too; nothing waits on
    the card."""
    from repro_torch.nn import moe

    apply = moe.moe_apply

    def wrapped(p, cfg, x):
        stats = {"T": x.shape[0]}
        calls.append(stats)
        return apply(p, cfg, x, stats=stats)
    moe.moe_apply = wrapped
    try:
        yield calls
    finally:
        moe.moe_apply = apply
    for c in calls:
        if "load" not in c:
            raise AssertionError("a MoE call stopped before its stats")


def run_lm_train(torch, dev, kernels, card, batches) -> dict:
    """Phase 38: the LMs trained on the card, train_4k (S = 4,096), remat
    on: (a) tinyllama-1.1b, (b) with an LMA token table, (c) the MoE and
    MLA LMs at the depth one card holds."""
    t_phase = time.perf_counter()
    out, secs = {"card": card}, {}
    for part, key, fn in (
            ("38a", "dense", lambda: lm_train_dense(torch, dev, kernels, card,
                                                    batches)),
            ("38b", "lma", lambda: lm_train_lma(torch, dev, kernels, card,
                                                batches)),
            ("38c", "moe", lambda: {a: lm_train_moe(torch, a, dev, kernels,
                                                    card, batches)
                                    for a in (MOE_ARCH, SCOUT_ARCH)})):
        free(torch)
        t0 = time.perf_counter()
        out[key] = fn()
        secs[part] = time.perf_counter() - t0
    free(torch)
    out["seconds"] = time.perf_counter() - t_phase
    out["seconds_by_part"] = secs
    log(f"phase 38: {out['seconds']:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()) + ")")
    return out


# -------------------------------------------------------------------- main

# ------------------------------------- the LMs under a mesh (phase 39)

# One spawn of MESH_RANKS gloo ranks on the card as a (data=MESH_DATA,
# model=2) mesh; its world mesh is the (1, 4) one.  Each part holds the
# meshed path to a one-card oracle computed in the parent before the spawn.
MESH_RANKS, MESH_DATA = 4, 2
MESH_DEVICE = "cuda:0"          # every rank on the one card
LONG_L = 524_288                # long_500k: B = 1 (LM_SHAPE_TABLE)
MESH_STEPS = 3                  # decode steps of 39a and 39b
MESH_B, MESH_L = 64, 32_768     # 39b, decode_32k (published B = 128)
MESH_SERVE_PROMPTS, MESH_SERVE_NEW = 16, 32      # 39b's LMServer, one wave
MESH_SERVE_SLOTS = 16
MESH_SERVE_LENS = (128, 512)
MESH_MOE_BS = (128, 64, 32)     # 39c: the largest whose reckoning fits
MESH_BUDGET_GB = 72.0           # of the card's 80 GB, for the four ranks
CONTEXT_GB = 0.6                # a rank's CUDA context and allocator slack
SCOUT_B, SCOUT_S, SCOUT_STEPS = 2, 1024, 4       # 39d
MESH_LMA_B, MESH_LMA_S, MESH_LMA_STEPS = 4, 512, 4   # 39e: 2,048 tokens
CACHE_BLOCK, CACHE_ROWS = 4096, 16   # a seeded piece of a cache layer
F32_TOL = 1e-5                  # attention (of max |o|), the MoE (normwise)
# the meshed bf16 logits' distance from the float32 weights' at most this
# many times the one-card bf16 run's where 35b's bound holds neither: at
# decode_32k's B = 64 one card's own reads 0.19 (NVIDIA H100 80GB HBM3,
# 700.00 W), past its atol of 0.15
MESH_NOISE = 1.25
TWIN_BLOCK = 8192               # tinyllama's float32 twin: KV blocks
TIE = 1e-4                      # a server's parting step: a top-2 tie
# 39e's launches of one embed_tokens call under each strategy (rank 0):
# psum's slab lookup (row 2); ring's chunk lookup and three visiting-chunk
# gathers (rows 10, 11); all_to_all's chunk locations and one gather
# (rows 4, 11)
MESH_LMA_ONE = {"fused_embed": 1}     # one card's lookup: row 2
MESH_LMA_LAUNCHES = {s: {k: v for k, v in f.items() if k != "dot_interaction"}
                     for s, f in SHARD_FORWARD.items()}


def seeded_piece(torch, per: tuple, layer: int, leaf: int, j: int, r: int,
                 rows: int, n: int, dev):
    """Rows ``[r * R, r * R + rows)`` and positions ``[j * CACHE_BLOCK,
    + n)`` of cache leaf ``leaf`` of ``layer``: bf16 normals from a seed of
    (layer, leaf, position block, row block), quantized -> (int8, scale)."""
    from repro_torch.nn.attention import quantize_kv

    seed = ((((SEED + 39) * 256 + layer) * 4 + leaf) * 2**16 + j) * 2**16 + r
    gen = torch.Generator(device=dev).manual_seed(seed % 2**63)
    return quantize_kv(torch.randn((rows, n, *per), generator=gen, device=dev,
                                   dtype=torch.bfloat16))


def seeded_pieces(cfg, B: int, L: int, slab):
    """The pieces of the seeded [B, L] cache that meet ``slab`` ((b0, b1),
    (lo, hi)): (group, layer in group, layer, leaf index, name, per, j, r,
    piece rows, piece positions, the slab's rows, the slab's positions)."""
    from repro_torch.models.transformer import _cache_leaves

    (b0, b1), (lo, hi) = slab
    R = min(CACHE_ROWS, B)
    layer = 0
    for gi, (_kind, count) in enumerate(cfg.layer_groups()):
        for li in range(count):
            for ni, (name, per) in enumerate(_cache_leaves(cfg).items()):
                for j in range(lo // CACHE_BLOCK, -(-hi // CACHE_BLOCK)):
                    p0, p1 = j * CACHE_BLOCK, min((j + 1) * CACHE_BLOCK, L)
                    for r in range(b0 // R, -(-b1 // R)):
                        r0, r1 = r * R, min((r + 1) * R, B)
                        a0, a1 = max(r0, b0), min(r1, b1)
                        c0, c1 = max(p0, lo), min(p1, hi)
                        yield (gi, li, layer + li, ni, name, per, j, r,
                               (slice(a0 - r0, a1 - r0),
                                slice(c0 - p0, c1 - p0)),
                               (slice(a0 - b0, a1 - b0),
                                slice(c0 - lo, c1 - lo)), r1 - r0, p1 - p0)
        layer += count


def fill_seeded(torch, cfg, cache, B: int, L: int, slab, dev) -> None:
    """Write the seeded cache's ``slab`` rows and positions into ``cache``
    (a rank's slab, or with the whole slab the one-card cache)."""
    for (gi, li, layer, ni, name, per, j, r, (pr, pp), (sr, sp), rows,
         n) in seeded_pieces(cfg, B, L, slab):
        q, s = seeded_piece(torch, per, layer, ni, j, r, rows, n, dev)
        c = cache[f"layers_{gi}"]
        c[name][li, sr, sp] = q[pr, pp]
        c[f"{name}_scale"][li, sr, sp] = s[pr, pp]


def seeded_held(torch, cfg, cache, B: int, L: int, slab, writes: dict,
                dev, what: str) -> None:
    """Every element of a rank's slab bit-equal to the seeded cache's,
    but at the positions in ``writes`` ({pos: {layer: {name: (q, s)}}}, the
    whole batch's new entries), which it must hold instead: nothing else
    written, and each write on the slab that owns its position."""
    (b0, b1), (lo, hi) = slab
    for (gi, li, layer, ni, name, per, j, r, (pr, pp), (sr, sp), rows,
         n) in seeded_pieces(cfg, B, L, slab):
        q, s = seeded_piece(torch, per, layer, ni, j, r, rows, n, dev)
        q, s = q[pr, pp].clone(), s[pr, pp].clone()
        c0 = sp.start + lo
        for pos, w in writes.items():
            if c0 <= pos < c0 + q.shape[1]:
                wq, ws = w[layer][name]
                q[:, pos - c0] = wq[b0 + sr.start:b0 + sr.stop].to(dev)
                s[:, pos - c0] = ws[b0 + sr.start:b0 + sr.stop].to(dev)
        c = cache[f"layers_{gi}"]
        if not (torch.equal(c[name][li, sr, sp], q)
                and bits_equal(torch, c[f"{name}_scale"][li, sr, sp], s)):
            raise AssertionError(f"{what}: layer {layer} {name} rows "
                                 f"{b0 + sr.start}.. positions {c0}.. differ "
                                 "from the seeded cache with this run's "
                                 "writes")


def written_entries(cache, cfg, pos: int) -> dict:
    """{layer: {name: (q, s)}}: a cache's entries at ``pos`` (on the
    host)."""
    from repro_torch.models.transformer import _cache_leaves

    out, layer = {}, 0
    for gi, (_kind, count) in enumerate(cfg.layer_groups()):
        c = cache[f"layers_{gi}"]
        for li in range(count):
            out[layer + li] = {
                name: (c[name][li, :, pos].to("cpu", copy=True),
                       c[f"{name}_scale"][li, :, pos].to("cpu", copy=True))
                for name in _cache_leaves(cfg)}
        layer += count
    return out


@contextlib.contextmanager
def flash_tap(torch, cfg, rec: dict):
    """Within (a rank): each ``sharded_flash_decode`` call's new entries are
    kept by layer in ``rec["writes"][pos]`` (the whole batch's, on the
    host), and the last layer's call is made once more with a float32
    query (its output before the cast; the write repeats the same bits):
    ``rec["last"][pos] = (q, o32)``."""
    from repro_torch.dist import flash_decode as fd

    orig = fd.sharded_flash_decode
    names = ("ckv",) if cfg.attention == "mla" else ("k", "v")
    n_layers = cfg.n_layers
    state = {"n": 0}

    def tapped(q, k_cache, v_cache, k_new, v_new, cache_len, **kw):
        layer = state["n"] % n_layers
        state["n"] += 1
        out = orig(q, k_cache, v_cache, k_new, v_new, cache_len, **kw)
        pos = min(int(cache_len), int(kw["length"]) - 1)
        news = ((k_new, kw.get("k_scale_new")),
                (v_new, kw.get("v_scale_new")))
        rec["writes"].setdefault(pos, {})[layer] = {
            n: (v[:, 0].cpu(), s[:, 0].cpu()) for n, (v, s) in
            zip(names, news)}
        if cfg.attention == "mla":          # [B, 1, 1, w] -> [B, w]
            rec["writes"][pos][layer] = {"ckv": tuple(
                x[:, 0] for x in rec["writes"][pos][layer]["ckv"])}
        if layer == n_layers - 1:
            o32 = orig(q.float(), k_cache, v_cache, k_new, v_new, cache_len,
                       **kw)
            rec["last"][pos] = (q.float().cpu(), o32.cpu())
        return out
    fd.sharded_flash_decode = tapped
    try:
        yield rec
    finally:
        fd.sharded_flash_decode = orig


def plain_decode_attention(torch, cfg, q, cache_leaf: dict, pos: int,
                           rows: int = 4):
    """The last layer's decode attention in float64 over a whole int8
    cache layer (``{name: (q, s)}`` after this step's write), every row
    below ``pos + 1`` valid: [B, 1, H, vd]."""
    import torch.nn.functional as F

    if cfg.attention == "mla":
        kq, ks = cache_leaf["ckv"]
        kq, ks = kq[:, :, None], ks[:, :, None]
        vq, vs = kq[..., :cfg.mla.kv_lora_rank], ks
        scale = 1.0 / np.sqrt(cfg.mla.qk_dim)
    else:
        (kq, ks), (vq, vs) = cache_leaf["k"], cache_leaf["v"]
        scale = 1.0 / np.sqrt(cfg.hd)
    B, L, KV = kq.shape[:3]
    H = q.shape[2]
    n = pos + 1
    outs = []
    for a in range(0, B, rows):
        k = kq[a:a + rows, :n].double() * ks[a:a + rows, :n, :, None].double()
        v = vq[a:a + rows, :n].double() * vs[a:a + rows, :n, :, None].double()
        qq = q[a:a + rows, 0].double().reshape(-1, KV, H // KV, q.shape[-1])
        s = torch.einsum("bkgh,btkh->bkgt", qq * scale, k)
        o = torch.einsum("bkgt,btkd->bkgd", F.softmax(s, dim=-1), v)
        outs.append(o.reshape(o.shape[0], 1, H, v.shape[-1]))
        del k, v, s
    return torch.cat(outs)


def seeded_layer(torch, cfg, layer: int, B: int, L: int, writes: dict,
                 dev) -> dict:
    """One layer of the seeded [B, L] cache, whole, with ``writes``."""
    from repro_torch.models.transformer import _cache_leaves

    layer_leaves = {}
    for ni, (name, per) in enumerate(_cache_leaves(cfg).items()):
        q = torch.empty((B, L, *per), dtype=torch.int8, device=dev)
        s = torch.empty((B, L, *per[:-1]), dtype=torch.float32, device=dev)
        layer_leaves[name] = (q, s)
    for (gi, li, lay, ni, name, per, j, r, (pr, pp), (sr, sp), rows,
         n) in seeded_pieces(cfg, B, L, ((0, B), (0, L))):
        if lay != layer:
            continue
        pq, ps = seeded_piece(torch, per, lay, ni, j, r, rows, n, dev)
        layer_leaves[name][0][sr, sp] = pq[pr, pp]
        layer_leaves[name][1][sr, sp] = ps[pr, pp]
    for pos, w in writes.items():
        for name, (wq, ws) in w[layer].items():
            layer_leaves[name][0][:, pos] = wq.to(dev)
            layer_leaves[name][1][:, pos] = ws.to(dev)
    return layer_leaves


def route_ok(torch, cfg, mine: list, theirs: list, B: int):
    """Which tokens took the same experts in two runs at every MoE layer
    before each layer: ``mine`` and ``theirs`` each MoE call's ``top_i``
    [B * n, k], in layer order -> [n_layers + 1, B, n] bool (row
    ``n_layers``: all of them).  A token whose experts part at a layer (a
    near-tied router swapped them: no fault) holds other values from the
    next layer on, so its later cache entries and logits are not held."""
    n = mine[0].shape[0] // B if mine else 1
    ok = torch.ones((B, n), dtype=torch.bool)
    out = [ok.clone()]
    for layer in range(1, cfg.n_layers + 1):
        i = layer - 1 - cfg.first_k_dense     # the MoE call of layer - 1
        if cfg.moe is not None and 0 <= i < len(mine):
            a = mine[i].cpu().sort(-1).values
            b = theirs[i].cpu().sort(-1).values
            ok &= (a == b).all(-1).reshape(B, n)
        out.append(ok.clone())
    return torch.stack(out)


def calls_top_i(torch, cfg, xs: list) -> list:
    """Each recorded MoE call's (module, whole-batch x) -> its ``top_i``."""
    from repro_torch.nn import moe
    return [moe.route(p, cfg.moe, x)[2].cpu() for p, x in xs]


def held_close(torch, got, want, what: str, one_err: float) -> float:
    """``got`` within the int8 bound of the float32 twin's ``want`` (rtol
    0.1, atol 0.15), or no farther from it than MESH_NOISE times the
    one-card bf16 run's ``one_err`` -> the largest |err| (0 when empty)."""
    if got.numel() == 0:
        return 0.0
    g, w = got.float(), want.float().to(got.device)
    err = float((g - w).abs().max())
    if torch.allclose(g, w, rtol=INT8_RTOL, atol=INT8_ATOL) or \
            err <= MESH_NOISE * one_err:
        return err
    raise AssertionError(f"{what}: max |err| {err:.4g} outside rtol "
                         f"{INT8_RTOL}, atol {INT8_ATOL}, and over "
                         f"{MESH_NOISE} x one card's bf16 {one_err:.4g}")


def logits_held(torch, got, want, what: str, rows, one_err: float) -> float:
    """The rows' logits against the float32 twin's: each row's top-1 among
    its top-5, and ``held_close``."""
    g, w = got.float()[rows], want.float().to(got.device)[rows]
    if g.numel():
        top5 = torch.topk(w, INT8_TOPK, dim=-1).indices
        if not bool((top5 == g.argmax(-1)[:, None]).any(-1).all()):
            raise AssertionError(f"{what}: a row's top-1 is not among the "
                                 "float32 twin's top-5")
    return held_close(torch, g, w, what, one_err)


def deq(q, s):
    """An int8 cache entry (or slab) dequantized to float32."""
    return q.float() * s[..., None].float().to(q.device)


@contextlib.contextmanager
def cast_experts(torch, *shared):
    """Within: the MoE's expert stacks evaluated in their input's dtype,
    a bf16 stack cast to float32 one expert at a time (no float32 copy of
    a whole stack: deepseek-v3's are 7.5 GB each in bf16), and each module
    of ``shared`` (a shared expert of a bf16 model) upcast, its weights
    restored on the way out."""
    from repro_torch.nn import moe

    plain = moe._expert_ffn

    def ffn(w_gate, w_up, w_down, xe):
        if w_gate.dtype == xe.dtype:
            return plain(w_gate, w_up, w_down, xe)
        return torch.cat([plain(*(w[e:e + 1].to(xe.dtype)
                                  for w in (w_gate, w_up, w_down)),
                                xe[e:e + 1]) for e in range(xe.shape[0])])
    held = [(q, q.data) for m in shared for q in m.parameters()]
    moe._expert_ffn = ffn
    try:
        for q, w in held:
            q.data = w.float()
        yield
    finally:
        moe._expert_ffn = plain
        for q, w in held:
            q.data = w


def float32_twin(torch, cfg, model, attn_block: int | None = None):
    """``model`` turned in place into its float32 twin: every parameter
    upcast (the same values) but the expert stacks, which ``cast_experts``
    casts an expert at a time; -> its config (with ``attn_block``, longer
    KV blocks: the same sums in another order, a shorter loop)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if not re.search(r"moe\.w_(gate|up|down)$", name):
                p.data = p.data.float()
    return dataclasses.replace(cfg, dtype="float32",
                               attn_block=attn_block or cfg.attn_block)


def one_card_noise(torch, cfg, bf: dict, tw: dict, B: int) -> dict:
    """The one-card bf16 run against its float32 twin, step by step: the
    sequences whose routes agree before each layer (``ok32``, [n_layers +
    1, B]), and over those the largest |err| of the logits and of the
    written entries (dequantized): the bf16 noise one card carries."""
    out = {"ok32": [], "logit_err": [], "write_err": []}
    for t, pos in enumerate(bf["writes"]):
        ok = route_ok(torch, cfg, [c["top_i"] for c in bf["moe"][t]],
                      [c["top_i"] for c in tw["moe"][t]], B)[:, :, 0]
        rows = ok[-1]
        le = float((bf["logits"][t].float() - tw["logits"][t].float())[
            rows].abs().max()) if bool(rows.any()) else 0.0
        we = 0.0
        for layer, leaves in bf["writes"][pos].items():
            m = ok[layer]
            for name, (q, sc) in leaves.items():
                d = (deq(q, sc) - deq(*tw["writes"][pos][layer][name]))[m]
                if d.numel():
                    we = max(we, float(d.abs().max()))
        out["ok32"].append(ok)
        out["logit_err"].append(le)
        out["write_err"].append(we)
    return out


def mesh_reckoning(torch, cfg, B: int, L: int, mesh_shape: tuple) -> dict:
    """A rank's reckoned peak (GB) at (data, model) = ``mesh_shape``: its
    share of the parameters (a model built on the meta device for rank 0),
    its cache slab, the decode's float32 block temporaries (a K block and
    its V, three [B_l, H, block] score tiles) and the logits; the MoE's
    in-body gather of one layer's experts over 'data'; and a context."""
    from repro_torch.dist.context import Mesh
    from repro_torch.dist.flash_decode import cache_split
    from repro_torch.models import transformer as tt

    D, M = mesh_shape
    mesh = Mesh(model=M, data=D)
    with torch.device("meta"):
        model = tt.Transformer(cfg, torch.Generator(), torch.device("meta"),
                               mesh=mesh)
    share = sum(p.numel() * p.element_size() for p in model.parameters())
    (b0, b1), (lo, hi) = cache_split(mesh, ("data",), B, L)
    slab = (b1 - b0) * (hi - lo) * tt.cache_bytes_per_token(cfg)
    width = sum(int(np.prod(s)) for s in tt._cache_leaves(cfg).values())
    blk = cfg.attn_block
    temps = 4 * (b1 - b0) * blk * (2 * width + 3 * cfg.n_heads) \
        + 4 * B * cfg.vocab_size
    gather = 0
    if cfg.moe is not None and D > 1:
        m = cfg.moe
        gather = 3 * m.n_experts // M * cfg.d_model * m.d_ff * 2
    per = (share + slab + temps + gather) / 1e9 + CONTEXT_GB
    return {"share_gb": share / 1e9, "slab_gb": slab / 1e9,
            "temps_gb": (temps + gather) / 1e9, "rank_gb": per,
            "total_gb": per * D * M}


def reckon_line(what: str, r: dict) -> str:
    return (f"{what}: reckoned {r['rank_gb']:.2f} GB a rank (share "
            f"{r['share_gb']:.2f}, cache slab {r['slab_gb']:.2f}, "
            f"temporaries {r['temps_gb']:.2f}, context {CONTEXT_GB}), "
            f"{r['total_gb']:.2f} GB over {MESH_RANKS} ranks")


def staged_per_step(mesh, before: dict, steps: int) -> dict:
    """Host-staged seconds a step by collective since ``before``."""
    return {k: (mesh.staged_s[k] - before.get(k, 0.0)) / steps
            for k in mesh.staged_s if mesh.staged_s[k] != before.get(k, 0.0)}


def oracle_decode(torch, cfg, model, B: int, L: int, first: int,
                  steps: int, dev) -> dict:
    """One card: the seeded [B, L] cache, ``steps`` decode steps of seeded
    tokens at cache_len ``first``..; -> the tokens, each step's logits,
    written entries and MoE calls (their x and ``top_i``)."""
    from repro_torch.models import transformer as tt

    cache = tt.init_cache(cfg, B, L, dev)
    fill_seeded(torch, cfg, cache, B, L, ((0, B), (0, L)), dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 391)
    toks = torch.randint(0, cfg.vocab_size, (steps, B), generator=gen,
                         device=dev, dtype=torch.int32)
    out = {"tokens": toks.cpu(), "logits": [], "writes": {}, "moe": [],
           "ms": []}
    with torch.no_grad():
        for t in range(steps):
            pos = first + t
            calls = []
            with moe_calls(torch, calls, keep=True):
                (logits, _), ms = events_ms(torch, lambda: tt.decode_step(
                    model, cfg, toks[t], cache, pos))
            out["ms"].append(ms)
            out["logits"].append(logits.cpu())
            out["writes"][min(pos, L - 1)] = written_entries(cache, cfg,
                                                             min(pos, L - 1))
            out["moe"].append([{k: (v.cpu() if hasattr(v, "cpu") else v)
                                for k, v in c.items() if k != "logits"}
                               for c in calls])
    del cache
    return out


def rank_decode(torch, mesh, cfg, model, B: int, L: int, oracle: dict,
                first: int, dev, what: str) -> dict:
    """A rank: its slab of the seeded cache, the oracle's tokens decoded at
    ``first``..; each step's writes: layer 0's bit-equal to the one-card
    oracle's (the same inputs), every layer's held to the float32 twin's
    (``held_close``); the logits to the twin's (``logits_held``), over the
    sequences whose MoE routes agree with both one-card runs' (3 in 4 at
    least); the last layer's float32 attention to a float64 evaluation
    over the whole layer (rank 0); the slab at the end bit-equal to the
    seeded one with exactly this run's writes."""
    from repro_torch.dist.context import use_mesh
    from repro_torch.models import transformer as tt
    from repro_torch.nn import moe

    steps = len(oracle["logits"])
    with use_mesh(mesh):
        cache = tt.init_cache(cfg, B, L, dev)
        slab = tt.cache_slab(B, L)
    t0 = time.perf_counter()
    fill_seeded(torch, cfg, cache, B, L, slab, dev)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    rec = {"writes": {}, "last": {}}
    ms, errs, agree, moe_ms = [], [], [], []
    before = dict(mesh.staged_s)
    with torch.no_grad(), flash_tap(torch, cfg, rec), use_mesh(mesh):
        for t in range(steps):
            pos = first + t
            xs = []
            sharded = moe.moe_apply_sharded

            def keep(p, c, x, *a, **kw):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = sharded(p, c, x, *a, **kw)
                end.record()
                xs.append((p, x, (start, end)))
                return out
            moe.moe_apply_sharded = keep
            try:
                (logits, _), t_ms = events_ms(torch, lambda: tt.decode_step(
                    model, cfg, oracle["tokens"][t].to(dev), cache, pos,
                    length=L))
            finally:
                moe.moe_apply_sharded = sharded
            ms.append(t_ms)
            moe_ms.append(sum(s.elapsed_time(e) for _, _, (s, e) in xs))
            wpos = min(pos, L - 1)
            ok = route_ok(torch, cfg, calls_top_i(torch, cfg,
                                                  [(p, x) for p, x, _ in xs]),
                          [c["top_i"] for c in oracle["moe"][t]], B)[:, :, 0]
            agree.append(int(ok[-1].sum()))
            ok32 = oracle["ok32"][t]
            got_w, want_w = rec["writes"][wpos], oracle["writes"][wpos]
            werr = 0.0
            for layer, leaves in want_w.items():
                m = ok[layer] & ok32[layer]
                for name, (wq, ws) in leaves.items():
                    gq, gs = got_w[layer][name]
                    if layer == 0 and not (torch.equal(gq, wq) and
                                           bits_equal(torch, gs, ws)):
                        raise AssertionError(f"{what} step {t}: layer 0's "
                                             f"written {name} differs from "
                                             "the oracle's")
                    tq, ts = oracle["writes32"][wpos][layer][name]
                    werr = max(werr, held_close(
                        torch, deq(gq, gs)[m], deq(tq, ts)[m],
                        f"{what} step {t}: layer {layer}'s written {name} "
                        "(dequantized)", oracle["write_err"][t]))
            rows = (ok[-1] & ok32[-1]).nonzero()[:, 0].to(dev)
            errs.append((logits_held(torch, logits, oracle["logits32"][t],
                                     f"{what} step {t} logits", rows,
                                     oracle["logit_err"][t]), werr))
            if mesh.world_rank == 0:
                q, o32 = rec["last"][wpos]
                layer = seeded_layer(torch, cfg, cfg.n_layers - 1, B, L,
                                     {p: w for p, w in rec["writes"].items()},
                                     dev)
                ref = plain_decode_attention(torch, cfg, q.to(dev), layer,
                                             pos)
                scale = float(ref.abs().max())
                a_err = float((o32.to(dev).double() - ref).abs().max())
                del layer, ref
                if a_err > F32_TOL * scale:
                    raise AssertionError(f"{what} step {t}: the last layer's "
                                         f"float32 attention {a_err:.3g} "
                                         f"from float64's (max {scale:.3g})")
                errs[-1] = errs[-1] + (a_err / scale,)
    staged = staged_per_step(mesh, before, steps)
    if sum(agree) * 4 < 3 * B * steps:
        raise AssertionError(f"{what}: MoE routes agree for {agree} of {B} "
                             "sequences a step")
    seeded_held(torch, cfg, cache, B, L, slab, rec["writes"], dev, what)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del cache
    return {"ms": ms, "median_ms": float(np.median(ms)), "errs": errs,
            "staged_s": staged, "fill_s": fill_s, "slab": slab,
            "peak_gb": peak, "agree": agree, "moe_ms": moe_ms,
            "x": [x for _, x, _ in xs]}


def twin_decode(torch, cfg, model, runs: dict, dev,
                attn_block: int | None = None) -> dict:
    """Each (key: (B, L)) of ``runs`` decoded on one card with ``model``
    (bf16), then with its float32 twin (the same steps from the same
    seeded cache), the twin's logits and writes and the bf16 run's noise
    against it beside the bf16 run's.  ``model`` ends as the twin."""
    out = {k: oracle_decode(torch, cfg, model, B, L, L - MESH_STEPS,
                            MESH_STEPS, dev) for k, (B, L) in runs.items()}
    free(torch)
    cfg32 = float32_twin(torch, cfg, model, attn_block)
    for k, (B, L) in runs.items():
        with cast_experts(torch):
            tw = oracle_decode(torch, cfg32, model, B, L, L - MESH_STEPS,
                               MESH_STEPS, dev)
        out[k].update(logits32=tw["logits"], writes32=tw["writes"],
                      **one_card_noise(torch, cfg, out[k], tw, B))
        for c in out[k]["moe"]:
            for call in c:
                call.pop("x", None)
        free(torch)
    return out


def mesh_long(torch, dev, card) -> dict:
    """39a's and 39b's oracles (tinyllama-1.1b on one card, bf16 and its
    float32 twin), and 39b's LMServer over 16 prompts with float32
    weights."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tt
    from repro_torch.serve import LMServer

    cfg = get_config(LM_ARCH).make_model()
    model = tt.init(cfg, seed=SEED, device=dev).eval()
    out = twin_decode(torch, cfg, model, {"long": (1, LONG_L),
                                          "decode": (MESH_B, MESH_L)}, dev,
                      attn_block=TWIN_BLOCK)
    del model
    free(torch)
    f32 = dataclasses.replace(cfg, dtype="float32")
    model = tt.init(f32, seed=SEED, device=dev).eval()     # the server's
    rng = np.random.default_rng(SEED + 39)
    lens = rng.integers(MESH_SERVE_LENS[0], MESH_SERVE_LENS[1],
                        MESH_SERVE_PROMPTS)
    lens[0] = MESH_SERVE_LENS[1]                 # pad_to = 544: 4 divides it
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, n)))
               for n in lens]
    gaps = []                       # token t's top-2 gap: its logits'
    saved = {n: getattr(tt, n) for n in ("prefill", "decode_step")}

    def rec_gap(fn):
        def call(*a, **kw):
            logits, c = fn(*a, **kw)
            top = torch.topk(logits.float(), 2, dim=-1).values
            gaps.append((top[:, 0] - top[:, 1]).cpu())
            return logits, c
        return call
    server = LMServer(model, f32, n_slots=MESH_SERVE_SLOTS,
                      max_len=MESH_SERVE_LENS[1] + MESH_SERVE_NEW)
    for n, fn in saved.items():
        setattr(tt, n, rec_gap(fn))
    try:
        served = server.generate(prompts, max_new_tokens=MESH_SERVE_NEW)
    finally:
        for n, fn in saved.items():
            setattr(tt, n, fn)
    out["serve"] = {"prompts": prompts, "tokens": [r.tokens for r in served],
                    "gaps": gaps}
    del model, server
    free(torch)
    return out


def mesh_moe_oracle(torch, arch: str, dev, B: int, L: int) -> dict:
    """39c's oracle: deepseek-v3 at MOE_LAYERS on one card, MESH_STEPS
    decode steps on the seeded cache at the drop-free capacity (as 37b:
    which token an expert's capacity drops follows bits a merge order
    moves), bf16 and its float32 twin; the MoE layer in float32 on step
    0's input at the config's capacity (``moe_apply``, the bf16 experts
    cast an expert at a time), its C and drops."""
    from repro_torch.nn import moe

    cfg, model, _info = moe_model(torch, arch, dev, card_line())
    layer = [blk for g in model.groups() for blk in g][-1]
    out = oracle_decode(torch, drop_free(cfg), model, B, L, L - MESH_STEPS,
                        MESH_STEPS, dev)
    x = out["moe"][0][-1]["x"].to(dev)
    with torch.no_grad(), cast_experts(torch, layer.moe.shared):
        stats = {}
        y, aux = moe.moe_apply(layer.moe, cfg.moe, x.float(), stats=stats)
    f32 = {"x": x.cpu(), "y": y.cpu(), "C": stats["C"], "aux": float(aux),
           "dropped": int(moe.dropped(stats["load"], stats["C"]))}
    del x, y, out
    free(torch)
    out = twin_decode(torch, drop_free(cfg), model, {"ds": (B, L)},
                      dev)["ds"]
    out["moe_f32"] = f32
    del model, layer
    free(torch)
    return out


def scout_run(torch, cfg, model, prompt, steps, dev) -> dict:
    """A prefill of ``prompt`` into a cache of SCOUT_S + SCOUT_STEPS rows,
    then the decode steps: the logits, the cache after each (on the host)
    and each MoE call's x and ``top_i``."""
    from repro_torch.models import transformer as tt

    cache = tt.init_cache(cfg, SCOUT_B, SCOUT_S + SCOUT_STEPS, dev)
    out = {"logits": [], "caches": [], "moe": []}
    with torch.no_grad():
        for t in range(SCOUT_STEPS + 1):
            calls = []
            with moe_calls(torch, calls, keep=True):
                if t == 0:
                    logits, _ = tt.prefill(model, cfg, prompt, cache=cache)
                else:
                    logits, _ = tt.decode_step(model, cfg, steps[t - 1],
                                               cache, SCOUT_S + t - 1)
            out["logits"].append(logits.cpu())
            out["caches"].append({g: {k: v.to("cpu", copy=True)
                                      for k, v in c.items()}
                                  for g, c in cache.items()})
            out["moe"].append([{"top_i": c["top_i"].cpu(), "x": c["x"]}
                               for c in calls])
    del cache
    return out


def scout_noise(torch, cfg, bf: dict, tw: dict) -> dict:
    """Scout's one-card bf16 run against its float32 twin, step by step:
    the entries (layer, sequence, position) whose token's routes agree
    before their layer (``held32`` [n_layers, B, L], cumulative), the last
    tokens whose routes agree at every layer (``ok32``), and over those the
    largest |err| of the caches (layers past 0, dequantized) and logits."""
    L = SCOUT_S + SCOUT_STEPS
    held = torch.zeros((cfg.n_layers, SCOUT_B, L), dtype=torch.bool)
    out = {"held32": [], "ok32": [], "logit_err": [], "cache_err": []}
    for t in range(SCOUT_STEPS + 1):
        ok = route_ok(torch, cfg, [c["top_i"] for c in bf["moe"][t]],
                      [c["top_i"] for c in tw["moe"][t]], SCOUT_B)
        at = slice(0, SCOUT_S) if t == 0 else slice(SCOUT_S + t - 1,
                                                    SCOUT_S + t)
        held[:, :, at] = ok[:cfg.n_layers]
        rows = ok[-1, :, -1]
        le = float((bf["logits"][t].float() - tw["logits"][t].float())[
            rows].abs().max()) if bool(rows.any()) else 0.0
        ce = 0.0
        for gi, c in bf["caches"][t].items():
            for name in [n for n in c if not n.endswith("_scale")]:
                d = (deq(c[name], c[f"{name}_scale"])
                     - deq(tw["caches"][t][gi][name],
                           tw["caches"][t][gi][f"{name}_scale"]))
                for li in range(1, d.shape[0]):           # scout: one group
                    m = held[li]
                    if bool(m.any()):
                        ce = max(ce, float(d[li][m].abs().max()))
        out["held32"].append(held.clone())
        out["ok32"].append(rows)
        out["logit_err"].append(le)
        out["cache_err"].append(ce)
    return out


def mesh_scout_oracle(torch, dev) -> dict:
    """39d's oracle: scout at MOE_LAYERS, drop-free, on one card, bf16 and
    its float32 twin: a prefill of SCOUT_B x SCOUT_S seeded tokens into a
    cache of SCOUT_S + SCOUT_STEPS rows, then SCOUT_STEPS decode steps; the
    first MoE layer in float32 on the prefill's input."""
    from repro_torch.nn import moe

    cfg, model, _info = moe_model(torch, SCOUT_ARCH, dev, card_line())
    cfg = drop_free(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 392)
    prompt = torch.randint(0, cfg.vocab_size, (SCOUT_B, SCOUT_S),
                           generator=gen, device=dev, dtype=torch.int32)
    steps = torch.randint(0, cfg.vocab_size, (SCOUT_STEPS, SCOUT_B),
                          generator=gen, device=dev, dtype=torch.int32)
    bf = scout_run(torch, cfg, model, prompt, steps, dev)
    x = bf["moe"][0][0]["x"]
    p = model.layers_0[0].moe
    with torch.no_grad(), cast_experts(torch, p.shared):
        stats = {}
        y, aux = moe.moe_apply(p, cfg.moe, x.float(), stats=stats)
    f32 = {"x": x.cpu(), "y": y.cpu(), "C": stats["C"], "aux": float(aux),
           "dropped": int(moe.dropped(stats["load"], stats["C"]))}
    del x, y
    free(torch)
    with cast_experts(torch):
        tw = scout_run(torch, float32_twin(torch, cfg, model), model, prompt,
                       steps, dev)
    out = {"prompt": prompt.cpu(), "tokens": steps.cpu(), "moe_f32": f32,
           "logits": bf["logits"], "caches": bf["caches"],
           "moe": [[{"top_i": c["top_i"]} for c in calls]
                   for calls in bf["moe"]],
           "logits32": tw["logits"], "caches32": tw["caches"],
           **scout_noise(torch, cfg, bf, tw)}
    del model, bf, tw
    free(torch)
    return out


def mesh_lma_oracle(torch, dev, kernels) -> dict:
    """39e's oracle: 35f's token table (tinyllama's vocabulary, d 2,048)
    on one card, row 2's lookup of a 2,048-token prefill batch and of
    MESH_LMA_STEPS decode steps' tokens."""
    from repro_torch.configs import get_config
    from repro_torch.configs._recsys_common import embedding_of_kind
    from repro_torch.device import make_generator
    from repro_torch.embed import EmbeddingTable, make_buffers

    cfg = get_config(LM_ARCH).make_model()
    e = embedding_of_kind("lma", (cfg.vocab_size,), cfg.d_model,
                          expansion=16.0, max_set=32)
    params = EmbeddingTable(e).init(make_generator(SEED, dev), dev)
    bufs = make_buffers(e, planted_store(torch, e, dev))
    gen = torch.Generator(device=dev).manual_seed(SEED + 393)
    toks = torch.randint(0, cfg.vocab_size, (MESH_LMA_B,
                                             MESH_LMA_S + MESH_LMA_STEPS),
                         generator=gen, device=dev, dtype=torch.int32)
    table = EmbeddingTable(e)
    with torch.no_grad():
        zero(kernels)
        pre = table.embed(params, bufs, 0, toks[:, :MESH_LMA_S]).cpu()
        dec = [table.embed(params, bufs, 0, toks[:, MESH_LMA_S + t]).cpu()
               for t in range(MESH_LMA_STEPS)]
        if counts(kernels) != {k: v * (1 + MESH_LMA_STEPS)
                               for k, v in MESH_LMA_ONE.items()}:
            raise AssertionError(f"39e oracle launched {counts(kernels)}")
    del params, bufs
    free(torch)
    return {"tokens": toks.cpu(), "prefill": pre, "decode": dec}


def mesh_oracles(torch, dev, kernels, card, path: str) -> dict:
    """Phase 39's one-card oracles, computed before the spawn and saved to
    ``path``; 39c's batch chosen by the reckoning."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    free(torch)
    o = {"tiny": mesh_long(torch, dev, card)}
    ds = dataclasses.replace(get_config(MOE_ARCH).make_model(),
                             n_layers=MOE_LAYERS)
    reck = {B: mesh_reckoning(torch, ds, B, MESH_L, (1, MESH_RANKS))
            for B in MESH_MOE_BS}
    fits = [B for B in MESH_MOE_BS if reck[B]["total_gb"] <= MESH_BUDGET_GB]
    if not fits:
        raise AssertionError(f"39c: no batch of {MESH_MOE_BS} fits "
                             f"{MESH_BUDGET_GB} GB: {reck}")
    o["moe_B"] = fits[0]
    o["ds"] = mesh_moe_oracle(torch, MOE_ARCH, dev, fits[0], MESH_L)
    o["scout"] = mesh_scout_oracle(torch, dev)
    o["lma"] = mesh_lma_oracle(torch, dev, kernels)
    o["reckon"] = {
        "39a": mesh_reckoning(torch, get_config(LM_ARCH).make_model(), 1,
                              LONG_L, (1, MESH_RANKS)),
        "39b": mesh_reckoning(torch, get_config(LM_ARCH).make_model(),
                              MESH_B, MESH_L, (MESH_DATA, 2)),
        "39c": reck[fits[0]],
        "39d": mesh_reckoning(torch, drop_free(dataclasses.replace(
            get_config(SCOUT_ARCH).make_model(), n_layers=MOE_LAYERS)),
            SCOUT_B, SCOUT_S + SCOUT_STEPS, (MESH_DATA, 2))}
    for B, r in reck.items():
        log(reckon_line(f"39c deepseek-v3 decode_32k B={B} at (1, 4)", r))
    torch.save(o, path)
    log(f"39 one-card oracles in {time.perf_counter() - t0:.1f} s, saved "
        f"({Path(path).stat().st_size / 2**20:.0f} MiB on the host); 39c "
        f"takes B={fits[0]}; card {card}")
    free(torch)
    return o


def rank_peak(torch) -> float:
    return torch.cuda.max_memory_allocated() / 1e9


def mesh_tiny(torch, mesh, wmesh, o: dict, dev, kernels) -> dict:
    """39a (1, 4) long_500k and 39b (2, 2) decode_32k and the LMServer."""
    from repro_torch.configs import get_config
    from repro_torch.dist.context import use_mesh
    from repro_torch.models import transformer as tt
    from repro_torch.serve import LMServer

    cfg = get_config(LM_ARCH).make_model()
    res = {}
    free(torch)
    model = tt.init(cfg, seed=SEED, device=dev, mesh=wmesh).eval()
    zero(kernels)
    res["long"] = rank_decode(torch, wmesh, cfg, model, 1, LONG_L,
                              o["long"], LONG_L - MESH_STEPS, dev,
                              "39a long_500k (1, 4)")
    res["long"].pop("x")
    free(torch)
    res["decode"] = rank_decode(torch, mesh, cfg, model, MESH_B, MESH_L,
                                o["decode"], MESH_L - MESH_STEPS, dev,
                                "39b decode_32k (2, 2)")
    res["decode"].pop("x")
    if counts(kernels):
        raise AssertionError(f"39a/b launched {counts(kernels)}")
    del model
    free(torch)
    f32 = dataclasses.replace(cfg, dtype="float32")
    model = tt.init(f32, seed=SEED, device=dev, mesh=mesh).eval()
    srv = o["serve"]
    server = LMServer(model, f32, n_slots=MESH_SERVE_SLOTS,
                      max_len=MESH_SERVE_LENS[1] + MESH_SERVE_NEW)
    calls = {}
    before = dict(mesh.staged_s)
    with use_mesh(mesh), lm_timed(torch, calls):
        t0 = time.perf_counter()
        served = server.generate(srv["prompts"],
                                 max_new_tokens=MESH_SERVE_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ties = []
    for b, (got, want) in enumerate(zip([r.tokens for r in served],
                                        srv["tokens"])):
        if got == want:
            continue
        t = next(i for i, (a, c) in enumerate(zip(got, want)) if a != c)
        gap = float(srv["gaps"][t][b])
        if not gap < TIE:
            raise AssertionError(f"39b LMServer: sequence {b} parts from the "
                                 f"one-card server's at token {t}, top-2 gap "
                                 f"{gap:.3g}")
        ties.append((b, t, gap))
    steps = server.stats["decode_steps"]
    res["serve"] = {"stats": dict(server.stats), "ties": ties,
                    "generated_tokens_per_s": server.stats["generated"]
                    / wall, "wall_s": wall,
                    "decode_step_ms_median": float(np.median(
                        calls["decode_step"])),
                    "prefill_ms": calls["prefill"],
                    "staged_s": staged_per_step(mesh, before, max(steps, 1)),
                    "peak_gb": rank_peak(torch)}
    del model, server
    free(torch)
    return res


def moe_f32_held(torch, mesh, layer, cfg, f32: dict, lead: int, dev,
                 what: str) -> dict:
    """The MoE layer's ``moe_apply_sharded`` on the oracle's input in
    float32 (the bf16 experts cast one at a time) against the one-card
    ``moe_apply``'s, normwise within F32_TOL."""
    from repro_torch.dist.context import dp_axes
    from repro_torch.nn import moe

    stats = {}
    x = f32["x"].to(dev).float()
    with torch.no_grad(), cast_experts(torch, layer.moe.shared):
        (y, aux), ms = events_ms(torch, lambda: moe.moe_apply_sharded(
            layer.moe, cfg.moe, x, mesh, dp_axes(mesh),
            full_token_sharding=True, lead=lead, stats=stats))
    want = f32["y"].to(dev)
    rel = float(torch.linalg.vector_norm(y - want)
                / torch.linalg.vector_norm(want))
    if rel > F32_TOL:
        raise AssertionError(f"{what}: the MoE layer in float32 {rel:.3g} "
                             "from one card's, normwise")
    dropped = int(moe.dropped(stats["load"][stats["ids"]], stats["C"]))
    return {"rel": rel, "C": stats["C"], "T_loc": stats["T_loc"],
            "dropped": dropped, "ms": ms, "C_one": f32["C"],
            "dropped_one": f32["dropped"], "aux": float(aux),
            "aux_one": f32["aux"]}


def mesh_ds(torch, wmesh, o: dict, dev, kernels) -> dict:
    """39c: deepseek-v3 (1, 4), 64 experts a rank, MLA over the mesh; the
    decode drop-free, the MoE layer's float32 check at the config's
    capacity."""
    from repro_torch.configs import get_config
    from repro_torch.dist import collectives as col
    from repro_torch.models import transformer as tt

    cfg = dataclasses.replace(get_config(MOE_ARCH).make_model(),
                              n_layers=MOE_LAYERS)
    free(torch)
    t0 = time.perf_counter()
    model = tt.init(cfg, seed=SEED, device=dev, mesh=wmesh).eval()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    B = o["moe_B"]
    zero(kernels)
    r = rank_decode(torch, wmesh, drop_free(cfg), model, B, MESH_L, o["ds"],
                    MESH_L - MESH_STEPS, dev, f"39c deepseek-v3 B={B} (1, 4)")
    layer = [blk for g in model.groups() for blk in g][-1]
    r["moe_f32"] = moe_f32_held(torch, wmesh, layer, cfg, o["ds"]["moe_f32"],
                                B, dev, "39c")
    r["dropped_all"] = int(col.psum(torch.tensor(
        [r["moe_f32"]["dropped"]], device=dev), wmesh)[0])
    if counts(kernels):
        raise AssertionError(f"39c launched {counts(kernels)}")
    r.update(build_s=build_s, experts=tuple(layer.moe.w_gate.shape),
             peak_gb=rank_peak(torch))
    r.pop("x")
    del model, layer
    free(torch)
    return r


def mesh_scout(torch, mesh, o: dict, dev, kernels) -> dict:
    """39d: scout (2, 2), E over (data, model), a prefill on the full-mesh
    token ladder, then SCOUT_STEPS decode steps."""
    from repro_torch.configs import get_config
    from repro_torch.dist.context import use_mesh
    from repro_torch.models import transformer as tt
    from repro_torch.nn import moe

    cfg = drop_free(dataclasses.replace(get_config(SCOUT_ARCH).make_model(),
                                        n_layers=MOE_LAYERS))
    free(torch)
    model = tt.init(cfg, seed=SEED, device=dev, mesh=mesh).eval()
    L = SCOUT_S + SCOUT_STEPS
    so = o["scout"]
    zero(kernels)
    ms, agree, errs = [], [], []
    # per layer, the (sequence, position) entries whose token's routes
    # agreed with the one-card run's at every earlier MoE layer
    held = torch.zeros((cfg.n_layers, SCOUT_B, L), dtype=torch.bool)
    before = dict(mesh.staged_s)
    with torch.no_grad(), use_mesh(mesh):
        cache = tt.init_cache(cfg, SCOUT_B, L, dev)
        (b0, b1), (lo, hi) = slab = tt.cache_slab(SCOUT_B, L)
        for t in range(SCOUT_STEPS + 1):
            xs = []
            sharded = moe.moe_apply_sharded

            def keep(p, c, x, *a, **kw):
                xs.append((p, x))
                return sharded(p, c, x, *a, **kw)
            moe.moe_apply_sharded = keep
            try:
                if t == 0:
                    (logits, _), t_ms = events_ms(torch, lambda: tt.prefill(
                        model, cfg, so["prompt"].to(dev), cache=cache,
                        length=L))
                else:
                    (logits, _), t_ms = events_ms(
                        torch, lambda: tt.decode_step(
                            model, cfg, so["tokens"][t - 1].to(dev), cache,
                            SCOUT_S + t - 1, length=L))
            finally:
                moe.moe_apply_sharded = sharded
            ms.append(t_ms)
            what = f"39d scout (2, 2) {'prefill' if t == 0 else f'step {t}'}"
            ok = route_ok(torch, cfg, calls_top_i(torch, cfg, xs),
                          [c["top_i"] for c in so["moe"][t]], SCOUT_B)
            at = slice(0, SCOUT_S) if t == 0 else slice(SCOUT_S + t - 1,
                                                        SCOUT_S + t)
            held[:, :, at] = ok[:cfg.n_layers]
            mask_all = (held & so["held32"][t])[:, b0:b1, lo:hi].to(dev)
            want, twin = so["caches"][t], so["caches32"][t]
            cerr = 0.0
            for gi, c in cache.items():
                for name in [n for n in c if not n.endswith("_scale")]:
                    g, gs = c[name], c[f"{name}_scale"]
                    w = want[gi][name][:, b0:b1, lo:hi].to(dev)
                    ws = want[gi][f"{name}_scale"][:, b0:b1, lo:hi].to(dev)
                    if not (torch.equal(g[0], w[0])
                            and bits_equal(torch, gs[0], ws[0])):
                        raise AssertionError(f"{what}: layer 0's {name} "
                                             "slab differs from the oracle's")
                    tw = deq(twin[gi][name][:, b0:b1, lo:hi].to(dev),
                             twin[gi][f"{name}_scale"][:, b0:b1, lo:hi])
                    mine = deq(g, gs)
                    for li in range(1, g.shape[0]):     # scout: one group
                        m = mask_all[li]
                        cerr = max(cerr, held_close(
                            torch, mine[li][m], tw[li][m],
                            f"{what}: layer {li}'s {name} slab "
                            "(dequantized)", so["cache_err"][t]))
            last = ok[-1, :, -1]
            agree.append(int(last.sum()))
            rows = (last & so["ok32"][t]).nonzero()[:, 0].to(dev)
            errs.append((logits_held(torch, logits, so["logits32"][t],
                                     f"{what} logits", rows,
                                     so["logit_err"][t]), cerr))
    staged = staged_per_step(mesh, before, SCOUT_STEPS + 1)
    if sum(agree) * 4 < 3 * SCOUT_B * (SCOUT_STEPS + 1):
        raise AssertionError(f"39d: MoE routes agree for {agree} of "
                             f"{SCOUT_B} sequences a step")
    layer = model.layers_0[0]
    f32 = moe_f32_held(torch, mesh, layer, cfg, so["moe_f32"], SCOUT_B, dev,
                       "39d")
    gather_s = stack_gather_s(torch, mesh, layer.moe.w_gate)
    if counts(kernels):
        raise AssertionError(f"39d launched {counts(kernels)}")
    out = {"ms": ms, "agree": agree, "errs": errs, "staged_s": staged,
           "moe_f32": f32, "gather_s": gather_s,
           "gather_gb": layer.moe.w_gate.numel() * 2 / 1e9,
           "slab": slab, "experts": tuple(layer.moe.w_gate.shape),
           "peak_gb": rank_peak(torch)}
    del model, cache, layer
    free(torch)
    return out


def stack_gather_s(torch, mesh, w) -> dict:
    """One expert stack gathered over 'data' as ``moe_apply_sharded``
    gathers it, through CUDA IPC (ranks on one card) and staged through
    the host by gloo: host-clock s of each, the card synchronised."""
    from repro_torch.dist import collectives as col
    from repro_torch.nn import moe

    out, one = {}, mesh.one_card
    try:
        for label, ipc in (("ipc", one), ("staged", False)):
            mesh.one_card = ipc
            torch.cuda.synchronize()
            col.barrier(mesh)
            t0 = time.perf_counter()
            moe._gather(w.detach(), mesh, "data", 0)
            torch.cuda.synchronize()
            out[label] = time.perf_counter() - t0
    finally:
        mesh.one_card = one
    return out


# 39f: all_gather over the world's 4 ranks through each transport, at
# sizes on both sides of collectives.IPC_MIN_BYTES
GATHER_SWEEP = (8 << 10, 64 << 10, 256 << 10, 1 << 20, 4 << 20, 16 << 20)
GATHER_ITERS = 10


def gather_sweep(torch, wmesh) -> dict:
    """39f: ``all_gather`` over the world's ranks of a float32 tensor of
    each GATHER_SWEEP size (bytes a rank), through CUDA IPC and staged by
    gloo, whichever IPC_MIN_BYTES would pick: the median host-clock ms of
    GATHER_ITERS calls, each between a barrier and a synchronised card,
    by size and transport; and the bytes equal both ways."""
    from repro_torch.dist import collectives as col

    out, one = {}, wmesh.one_card
    try:
        for nbytes in GATHER_SWEEP:
            x = torch.arange(nbytes // 4, device=wmesh.device,
                             dtype=torch.float32) + wmesh.world_rank
            got, ms = {}, {}
            for label in ("ipc", "staged"):
                wmesh.one_card = label == "ipc"
                times = []
                for _ in range(GATHER_ITERS):
                    torch.cuda.synchronize()
                    col.barrier(wmesh)
                    t0 = time.perf_counter()
                    got[label] = col._ipc_all_gather(
                        x, wmesh, "model", wmesh.group) \
                        if label == "ipc" else col.all_gather(x, wmesh)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                ms[label] = float(np.median(times))
            if not torch.equal(got["ipc"], got["staged"]):
                raise AssertionError(f"39f: the {nbytes} B gathers differ")
            out[nbytes] = ms
    finally:
        wmesh.one_card = one
    return out


def mesh_lma(torch, wmesh, o: dict, dev, kernels) -> dict:
    """39e: the LMA token table under (1, 4): embed_tokens of the prefill
    batch and of each decode step's tokens under psum, ring and all_to_all
    bit-equal to the one-card row 2 lookup, launches exact; rank 0 times
    rows 2 (slab mode), 4, 10 and 11 at the 2,048-token shapes."""
    from repro_torch.configs import get_config
    from repro_torch.configs._recsys_common import embedding_of_kind
    from repro_torch.device import make_generator
    from repro_torch.dist import collectives as col
    from repro_torch.dist import exchange as exl
    from repro_torch.dist.context import use_mesh
    from repro_torch.embed import EmbeddingTable, make_buffers
    from repro_torch.kernels.fused_embed import kernel as fk
    from repro_torch.kernels.fused_embed import ops as fe
    from repro_torch.kernels.fused_embed import ref as fref

    cfg = get_config(LM_ARCH).make_model()
    e = embedding_of_kind("lma", (cfg.vocab_size,), cfg.d_model,
                          expansion=16.0, max_set=32)
    free(torch)
    table = EmbeddingTable(e)
    params = table.init(make_generator(SEED, dev), dev, mesh=wmesh)
    bufs = make_buffers(e, planted_store(torch, e, dev), mesh=wmesh)
    lo_ = o["lma"]
    toks = lo_["tokens"].to(dev)
    launches = {"prefill": {}, "decode": {}}
    by_strategy = {}
    with torch.no_grad(), use_mesh(wmesh):
        for s in STRATEGIES:
            exl.FORCED = s
            try:
                zero(kernels)
                got = table.embed(params, bufs, 0, toks[:, :MESH_LMA_S])
                pre = counts(kernels)
                if not torch.equal(got.cpu(), lo_["prefill"]):
                    raise AssertionError(f"39e {s}: the prefill lookup "
                                         "differs from one card's row 2")
                zero(kernels)
                for t in range(MESH_LMA_STEPS):
                    got = table.embed(params, bufs, 0,
                                      toks[:, MESH_LMA_S + t])
                    if not torch.equal(got.cpu(), lo_["decode"][t]):
                        raise AssertionError(f"39e {s}: decode step {t}'s "
                                             "lookup differs from one card's")
                dec = counts(kernels)
            finally:
                exl.FORCED = None
            want_dec = {k: v * MESH_LMA_STEPS
                        for k, v in MESH_LMA_LAUNCHES[s].items()}
            if pre != MESH_LMA_LAUNCHES[s] or dec != want_dec:
                raise AssertionError(f"39e {s}: launched {pre} (prefill), "
                                     f"{dec} (decode)")
            by_strategy[s] = {"prefill": pre, "decode": dec}
            for k, v in pre.items():
                launches["prefill"][k] = launches["prefill"].get(k, 0) + v
            for k, v in dec.items():
                launches["decode"][k] = launches["decode"].get(k, 0) + v
    timing = {}
    p = e.lma
    spec = fe.lma_spec(p)
    slab = params["memory"]
    base, m_local = slab_of(wmesh, p.m)
    d = p.d

    class _Cfg:
        embedding = e
    with torch.no_grad():
        # every rank: the chunk's D' rows (all_to_all), the whole batch's
        # rows and locations (all_gather), as the exchanges build them
        gids = toks[:, :MESH_LMA_S].reshape(-1).contiguous()
        chunk, rows, support = chunk_inputs(torch, wmesh, _Cfg, bufs, gids)
        part, loc = fk.fused_chunk_lookup_cuda(spec, slab, chunk, rows,
                                               support, base)
        rows_all = col.all_gather(rows, wmesh).reshape(-1, rows.shape[1])
        sup_all = col.all_gather(support, wmesh).reshape(-1)
        full = col.all_gather(loc, wmesh).reshape(-1, d)
    if wmesh.world_rank == 0:
        N = gids.numel()
        with torch.no_grad():
            checks = (
                ("fused_embed", lambda: fk.fused_lookup_cuda(
                    spec, slab, gids, rows_all, sup_all, base=base),
                 lambda: fref.fused_lookup_ref(spec, slab, gids, rows_all,
                                               sup_all, base=base)),
                ("fused_locations", lambda: fk.fused_locations_cuda(
                    spec, chunk, rows, support),
                 lambda: fref.locations_ref(spec, chunk, rows, support)),
                ("fused_chunk_lookup", lambda: fk.fused_chunk_lookup_cuda(
                    spec, slab, chunk, rows, support, base),
                 lambda: fref.chunk_lookup_ref(spec, slab, chunk, rows,
                                               support, base=base)),
                ("fused_chunk_gather", lambda: fk.fused_chunk_gather_cuda(
                    slab, full, base),
                 lambda: fref.chunk_gather_ref(slab, full, base)))
            nb_all, ops_all = lma_work(torch, p, rows_all, sup_all,
                                       fallback=True)
            in_all = int(((full >= base) & (full < base + m_local)).sum())
            c = chunk.numel()
            work = {"fused_embed": (N, nb_all - (N * d - in_all) * 4,
                                    ops_all),
                    "fused_chunk_gather": (N, N * d * 8 + in_all * 4, 0)}
            for name, w in chunk_work(torch, p, rows, support, loc, base,
                                      m_local).items():
                work[name] = (c, *w)
            for name, fn, plain in checks:
                got = fn()
                want, plain_ms = events_ms(torch, plain)
                if not (torch.equal(got[0], want[0]) and torch.equal(
                        got[1], want[1]) if isinstance(got, tuple)
                        else torch.equal(got, want)):
                    raise AssertionError(f"39e: {name} at the LM shape "
                                         "differs from its plain version")
                rows_n, nb, ops = work[name]
                r = timing[name] = {"tokens": rows_n, "plain_ms": plain_ms,
                                    "library_ms": None}
                if name in ("fused_locations", "fused_chunk_lookup"):
                    r["tile"] = fk.lookup_tile(rows_n, d, fk.sm_count(
                        slab.device.index))
                r["ms"] = graph_ms(torch, fn, 20)
                r["bound_ms"], r["bound_by"] = bound(nb, ops, INT32_OP_PER_S)
                del got, want
    del params, bufs
    free(torch)
    return {"launches": launches, "by_strategy": by_strategy,
            "timing": timing}


def mesh_rank(mesh, oracle_path: str) -> dict:
    """One rank of phase 39 (``run_ranks`` with data=MESH_DATA): each part
    on the card alone, freed before the next."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("phase 39: a rank found no GPU")
    dev = mesh.device
    t_wait = time.perf_counter()
    wait_for(oracle_path)
    o = torch.load(oracle_path, mmap=True, weights_only=False)
    kernels = shard_kernels()
    wmesh = world_mesh(mesh)
    t = {"waited for the oracles": time.perf_counter() - t_wait}
    out = {"rank": mesh.world_rank}
    for part, key, fn in (
            ("39a-b", "tiny", lambda: mesh_tiny(torch, mesh, wmesh, o["tiny"],
                                                dev, kernels)),
            ("39c", "ds", lambda: mesh_ds(torch, wmesh, o, dev, kernels)),
            ("39d", "scout", lambda: mesh_scout(torch, mesh, o, dev,
                                                kernels)),
            ("39e", "lma", lambda: mesh_lma(torch, wmesh, o, dev,
                                            kernels))):
        t0 = time.perf_counter()
        out[key] = fn()
        t[part] = time.perf_counter() - t0
    out["staged"] = {"mesh": dict(mesh.staged_s), "world":
                     dict(wmesh.staged_s)}
    t0 = time.perf_counter()
    out["sweep"] = gather_sweep(torch, wmesh)
    t["39f"] = time.perf_counter() - t0
    out["seconds"] = t
    from repro_torch.dist import collectives as col
    col.barrier(mesh)
    return out


def wait_for(path: str, timeout_s: float = 900.0) -> None:
    """Block until the parent marks ``path`` ready (``.ready``) or failed
    (``.failed``, which raises)."""
    t0 = time.perf_counter()
    while not os.path.exists(path + ".ready"):
        if os.path.exists(path + ".failed"):
            raise RuntimeError(f"{path}: the parent failed")
        if time.perf_counter() - t0 > timeout_s:
            raise TimeoutError(f"{path}: not ready after {timeout_s} s")
        time.sleep(0.1)


def run_mesh_lm(torch, dev, kernels, card) -> dict:
    """Phase 39: the LMs served under a (data, model) mesh: MESH_RANKS gloo
    ranks on this card (``mesh_rank``), spawned first so that they start
    while the parent computes the one-card oracles, which they wait for."""
    import tempfile
    import threading

    from repro_torch.dist.collectives import run_ranks

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mesh-lm-",
                                     dir=ROOT / "build") as tmp:
        path = str(Path(tmp) / "oracle.pt")
        log(f"39: spawning {MESH_RANKS} ranks as a (data={MESH_DATA}, model="
            f"{MESH_RANKS // MESH_DATA}) mesh and its (1, {MESH_RANKS}) world "
            "mesh on the card (gloo: all_gathers of 1 MiB or more through "
            "CUDA IPC, every other collective staged through host memory); "
            "they wait for the one-card oracles")
        spawned = {}

        def spawn():
            t0 = time.perf_counter()
            try:
                spawned["ranks"] = run_ranks(
                    mesh_rank, MESH_RANKS, path, data=MESH_DATA,
                    backend="gloo", device=MESH_DEVICE)
            except BaseException as e:          # re-raised below
                spawned["error"] = e
            spawned["s"] = time.perf_counter() - t0
        thread = threading.Thread(target=spawn)
        thread.start()
        try:
            o = mesh_oracles(torch, dev, kernels, card, path)
        except BaseException:
            Path(path + ".failed").touch()
            thread.join()
            raise
        Path(path + ".ready").touch()
        oracle_s = time.perf_counter() - t_phase
        for part, r in o["reckon"].items():
            log(reckon_line(f"{part} before its run", r))
        thread.join()
        if "error" in spawned:
            raise spawned["error"]
        ranks, ranks_s = spawned["ranks"], spawned["s"]
    r0 = ranks[0]
    tiny, ds, sc, lma = (r0[k] for k in ("tiny", "ds", "scout", "lma"))
    peaks = {part: [r[k]["peak_gb"] if k != "tiny" else None
                    for r in ranks] for part, k in (("39c", "ds"),
                                                    ("39d", "scout"))}
    for part, key in (("39a", "long"), ("39b", "decode")):
        peaks[part] = [r["tiny"][key]["peak_gb"] for r in ranks]
    for part, ps in sorted(peaks.items()):
        rk = o["reckon"][part]
        log(f"{part}: measured peaks {', '.join(f'{p:.2f}' for p in ps)} GB "
            f"a rank ({sum(ps):.2f} in all) beside the reckoned "
            f"{rk['rank_gb']:.2f} ({rk['total_gb']:.2f}); card {card}")
    def held_line(errs, noise) -> str:
        return (f"logits {', '.join(f'{e[0]:.3g}' for e in errs)} and "
                f"written entries {', '.join(f'{e[1]:.3g}' for e in errs)} "
                "from the float32 twin's (one card's bf16: "
                f"{', '.join(f'{x:.3g}' for x in noise['logit_err'])} and "
                f"{', '.join(f'{x:.3g}' for x in noise['write_err'])}; "
                f"35b's bound or {MESH_NOISE} x one card's)")

    for part, key, label in (("39a", "long", f"long_500k B=1, cache_len "
                              f"{LONG_L - MESH_STEPS}..{LONG_L - 1}, (1, 4)"),
                             ("39b", "decode", f"decode_32k B={MESH_B} "
                              "(published 128), (2, 2)")):
        r = tiny[key]
        log(f"{part} tinyllama-1.1b 22 layers {label}: steps "
            f"{', '.join(f'{x:.1f}' for x in r['ms'])} ms (median "
            f"{r['median_ms']:.1f}; one card's "
            f"{np.median(o['tiny'][key]['ms']):.1f}); slab {r['slab']} "
            f"filled in {r['fill_s']:.1f} s; "
            + held_line(r["errs"], o["tiny"][key])
            + "; the last layer's float32 attention within "
            f"{', '.join(f'{e[2]:.3g}' for e in r['errs'])} of max |o| "
            f"(float64); every slab bit-equal to the seeded cache with this "
            f"run's writes, layer 0's writes bit-equal to the oracle's; "
            f"host-staged s a step "
            + ", ".join(f"{k} {v:.4f}" for k, v in sorted(
                r["staged_s"].items())) + f"; card {card}")
    s = tiny["serve"]
    log(f"39b LMServer (2, 2), {MESH_SERVE_PROMPTS} prompts of "
        f"{MESH_SERVE_LENS[0]}-{MESH_SERVE_LENS[1]} tokens, float32 weights, "
        f"{MESH_SERVE_NEW} new: tokens equal to one card's server"
        + (f" but for ties {s['ties']}" if s["ties"] else "")
        + f"; {s['generated_tokens_per_s']:.1f} generated tokens/s, median "
        f"decode step {s['decode_step_ms_median']:.1f} ms, host-staged s a "
        "step " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(
            s["staged_s"].items())) + f"; card {card}")
    f = ds["moe_f32"]
    log(f"39c deepseek-v3 {MOE_LAYERS} layers (1, 4), {ds['experts'][0]} "
        f"experts a rank, decode_32k B={o['moe_B']}: steps "
        f"{', '.join(f'{x:.1f}' for x in ds['ms'])} ms (one card's "
        f"{', '.join(f'{x:.1f}' for x in o['ds']['ms'])}); MoE layer "
        f"{', '.join(f'{x:.2f}' for x in ds['moe_ms'])} ms a step (one "
        f"card's {', '.join(f'{c[-1]['ms']:.2f}' for c in o['ds']['moe'])});"
        f" routes agree for {ds['agree']} of {o['moe_B']}; "
        + held_line(ds["errs"], o["ds"]) + "; last layer's "
        f"float32 attention within "
        f"{', '.join(f'{e[2]:.3g}' for e in ds['errs'])}; the MoE layer in "
        f"float32 within {f['rel']:.3g} normwise of one card's, C {f['C']} "
        f"(one card {f['C_one']}), dropped {ds['dropped_all']} (one card "
        f"{f['dropped_one']}); card {card}")
    f = sc["moe_f32"]
    log(f"39d scout {MOE_LAYERS} layers (2, 2), {sc['experts'][0]} experts "
        f"a rank a layer, prefill B={SCOUT_B} S={SCOUT_S} then "
        f"{SCOUT_STEPS} steps: {', '.join(f'{x:.1f}' for x in sc['ms'])} "
        f"ms; routes agree {sc['agree']}; logits "
        f"{', '.join(f'{e[0]:.3g}' for e in sc['errs'])} and cache slabs "
        f"{', '.join(f'{e[1]:.3g}' for e in sc['errs'])} from the float32 "
        "twin's (one card's bf16: "
        f"{', '.join(f'{x:.3g}' for x in o['scout']['logit_err'])} and "
        f"{', '.join(f'{x:.3g}' for x in o['scout']['cache_err'])}); layer "
        "0's slabs bit-equal to the oracle's; the first MoE layer in float32 "
        "on the "
        f"prefill's {SCOUT_B * SCOUT_S} tokens (full-mesh ladder, "
        f"psum_scatter) within {f['rel']:.3g} normwise of one card's, C "
        f"{f['C']} over {f['T_loc']} tokens (one card {f['C_one']}), "
        f"dropped {f['dropped']} ({f['dropped_one']}); aux per shard "
        f"{f['aux']:.4f}, one card's {f['aux_one']:.4f} (per shard by "
        f"design, not gated); one layer's w_gate stack "
        f"({sc['gather_gb']:.3f} GB) gathered over 'data' in "
        f"{sc['gather_s']['ipc']:.4f} s through CUDA IPC, "
        f"{sc['gather_s']['staged']:.4f} s staged by gloo; host-staged s a "
        "step " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(
            sc["staged_s"].items())) + f"; card {card}")
    log(f"39e LMA token table (1, 4): embed_tokens bit-equal to one card's "
        f"row 2 under {', '.join(STRATEGIES)}; launches {lma['by_strategy']}"
        + "".join(f"; {n} at {t['tokens']} rows {t['ms']:.4f} ms (plain "
                  f"{t['plain_ms']:.3f}, bound {t['bound_ms']:.4f} ms, "
                  f"{t['bound_by']})" for n, t in lma["timing"].items())
        + f"; card {card}")
    from repro_torch.dist.collectives import IPC_MIN_BYTES
    log(f"39f all_gather over the world's {MESH_RANKS} ranks, median ms a "
        f"call (CUDA IPC / staged by gloo; IPC_MIN_BYTES {IPC_MIN_BYTES:,})"
        ": " + ", ".join(f"{n:,} B {m['ipc']:.3f} / {m['staged']:.3f}"
                         for n, m in r0["sweep"].items())
        + f"; the same bytes both ways; card {card}")
    log(f"39: oracles {oracle_s:.1f} s, ranks {ranks_s:.1f} s (rank 0: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in r0["seconds"].items())
        + f"); phase {time.perf_counter() - t_phase:.1f} s")
    return {"launches": {"lm mesh lma prefill": lma["launches"]["prefill"],
                         "lm mesh lma decode": lma["launches"]["decode"]},
            "timing": lma["timing"],
            "summary": {"long_500k": {k: tiny["long"][k] for k in (
                "ms", "median_ms", "errs", "staged_s", "peak_gb")},
                "decode_32k": {k: tiny["decode"][k] for k in (
                    "ms", "median_ms", "errs", "staged_s", "peak_gb")},
                "serve": s, "deepseek": {k: ds[k] for k in (
                    "ms", "moe_ms", "agree", "errs", "moe_f32",
                    "dropped_all", "peak_gb")},
                "scout": {k: sc[k] for k in ("ms", "agree", "errs",
                                             "moe_f32", "gather_s",
                                             "peak_gb")},
                "gather_sweep_ms": r0["sweep"],
                "reckon": o["reckon"], "oracle_s": oracle_s,
                "ranks_s": ranks_s, "card": card}}


# ------------------------------------- the LMs trained under a mesh (phase 40)

# One spawn of MESH_RANKS gloo ranks on the card: the (2, 2) mesh and its
# (1, 4) world mesh.  The parent computes the one-card oracles of (a), (c)
# and (d) meanwhile (saved under build/; the ranks hold their blocks to
# them), then runs (b)'s one-card steps and frees the card for the ranks'
# (b) and (d)'s scout.
TRAIN_F32_LAYERS = 2            # (a), (c): 2 of tinyllama's 22 layers
TRAIN_F32_S = 1024              # (a), (c): train_4k's S cut for float32
TRAIN_MESH_B = 4                # (a)-(d): the global batch (scout's 1)
TRAIN_MESH_STEPS = 3            # (b): steps at (2, 2)
TRAIN_LMA_STEPS = 2             # (c): sparse steps a mesh
MOE_SMOKE_S = 32                # (d): the smoke configs' sequence
SCOUT_MESH_STEPS = 2            # (d): scout at full width, 1 layer, (1, 4)
SCOUT_MESH_CARD_GB = 80.0       # (d): scout runs if its reckoned total fits
GRAD_TOL = 1e-5                 # (a), (c), (d): every leaf, normwise
# (c): the pool slabs after the steps, normwise.  The mesh's gradient is
# within ~7e-6 of one card's (sums in another order), ~1e-9 absolute at a
# slot; a slot whose gradient lies within a few eps of zero moves by up to
# lr / eps (4e4) times that under Adam's g / (|g| + eps), and the touched
# slots under 10 eps (printed) move the pool by ~1e-5 a step (measured
# on the H100).  Each step's slab is held bit for bit to the plain lazy
# Adam of its own SparseGrad
POOL_TOL = 1e-4
BF16_LOSS_TOL = 1e-2            # (b): each step's loss, relative
# (a), (c), (d): the elements whose step-1 gradient does not settle the
# update (``sure_masks``, from one card's gradient) are at most this share
# of each leaf, and each moves from one card's by at most a sign flip of
# every update, 2 lr a step.  The largest share is lm_head's at full width:
# a row no gold token names has the gradient sum_t p_v h_t / N, p_v about
# 1 / 32,000, which puts 1.1% of it under 10 eps (measured on the H100)
UNSETTLED_SHARE = 0.02
TRAIN_MESHES = {"2x2": "psum", "1x4": "all_to_all"}   # (c)'s strategies
# (c)'s launches a step on each rank: the sparse steps' lookup (psum: the
# slab's row 2; all_to_all: the chunk's locations, row 4, and one gather,
# row 11), psum's locations of its reconstructed rows (row 4) and the lazy
# Adam (row 9); the dense steps' scatter (psum: row 5's slab mode;
# all_to_all: the chunk scatter, row 12)
TRAIN_LMA_LAUNCHES = {
    "psum": {"sparse": {"fused_embed": 1, "fused_locations": 1,
                        "sparse_adam": 1},
             "dense": {"fused_embed": 1, "fused_scatter_add": 1}},
    "all_to_all": {"sparse": {"fused_locations": 1, "fused_chunk_gather": 1,
                              "sparse_adam": 1},
                   "dense": {"fused_locations": 1, "fused_chunk_gather": 1,
                             "fused_chunk_scatter": 1}},
}


def f32_train_cfg(lma: bool = False):
    """(a) and (c)'s model: tinyllama-1.1b at full width, TRAIN_F32_LAYERS
    layers, float32, remat and its loss chunk kept; with ``lma`` 35f's
    token table."""
    from repro_torch.configs import get_config
    from repro_torch.configs._recsys_common import embedding_of_kind
    cfg = dataclasses.replace(get_config(LM_ARCH).make_model(),
                              n_layers=TRAIN_F32_LAYERS, dtype="float32")
    if lma:
        cfg = dataclasses.replace(cfg, embedding=embedding_of_kind(
            "lma", (cfg.vocab_size,), cfg.d_model, expansion=16.0,
            max_set=32))
    return cfg


def moe_smoke_cfg(arch: str):
    """(d)'s smoke config of ``arch``: float32, remat on, the drop-free
    capacity factor."""
    from repro_torch.configs import get_config
    cfg = get_config(arch).make_smoke()
    return dataclasses.replace(cfg, remat=True, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k * 1.05))


def scout_mesh_cfg():
    """(d)'s scout: full width, 1 of its 48 layers."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(SCOUT_ARCH).make_model(),
                               n_layers=1, first_k_dense=0)


def mesh_batches(vocab: int, B: int, S: int, steps: int, seed: int) -> dict:
    """``steps`` global batches of uniform tokens and labels, by step."""
    rng = np.random.default_rng(SEED + seed)
    return {s: {k: rng.integers(0, vocab, (B, S)).astype(np.int32)
                for k in ("tokens", "labels")} for s in range(steps)}


def host(torch, tree: dict) -> dict:
    """Float32 host copies of a dict of tensors (a SparseGrad densified)."""
    from repro_torch.optim import sparse as sp
    return {k: (v.densify() if sp.is_sparse(v) else v).detach().to(
        torch.float32).cpu().clone() for k, v in tree.items()}


class FirstGrads(Recorder):
    """An optimizer that keeps its first update's gradients on the host
    and calls ``on_update(grads, state, params)`` before each update."""

    def __init__(self, torch, opt, on_update=None):
        super().__init__(opt)
        self.torch, self.first, self.on_update = torch, None, on_update

    def update(self, grads, state, params):
        if self.first is None:
            self.first = host(self.torch, grads)
            for k, g in self.first.items():       # a pool's whole stream
                if g.numel() != params[k].numel():
                    from repro_torch.dist.sharding import (block, stored_mesh,
                                                           stored_spec)
                    self.first[k] = block(
                        g.reshape(-1), stored_mesh(params[k]),
                        stored_spec(params[k])).reshape(
                            params[k].shape).clone()
        if self.on_update is not None:
            self.on_update(grads, state, params)
        return self.opt.update(grads, state, params)


def train_steps(torch, mesh, arch_id, cfg, batches, dev, steps: int,
                bufs=None, sparse=None, shares: int = 1, on_update=None,
                after=None, timer=None, keep: bool = True) -> dict:
    """``steps`` Trainer steps of ``cfg`` from the seed's parameters with
    the arch's optimizer as the launcher builds it: on one card (``mesh``
    None), or on this rank's ``lm_rules`` blocks under ``mesh``.  With
    ``shares`` > 1 (one card's oracle of a MoE at (2, 2)) the loss is the
    mean over the batch's 'data' shares of each share's ``loss_fn`` (the
    share's MoE capacity and aux).  ``after(trainer)`` runs after each
    step.  -> the losses, step seconds (host clock), the peak, and with
    ``keep`` the first step's gradients, the parameters after and their
    specs, on the host."""
    from repro_torch.configs import get_config
    from repro_torch.dist.context import use_mesh
    from repro_torch.dist.sharding import stored_spec
    from repro_torch.launch.train import make_optimizer
    from repro_torch.models import transformer as tt
    from repro_torch.train.trainer import Trainer, TrainerConfig

    def loss(m, b):
        if shares == 1:
            return tt.loss_fn(m, cfg, b["tokens"], b["labels"], bufs)
        c = b["tokens"].shape[0] // shares
        return sum(tt.loss_fn(m, cfg, b["tokens"][i * c:(i + 1) * c],
                              b["labels"][i * c:(i + 1) * c], bufs)[0]
                   for i in range(shares)) / shares, {}
    opt = make_optimizer(get_config(arch_id))
    if keep:
        opt = FirstGrads(torch, opt, on_update)
    free(torch)
    ctx = use_mesh(mesh) if mesh is not None else contextlib.nullcontext()
    with ctx:
        model = tt.init(cfg, seed=SEED, device=dev, mesh=mesh,
                        train=mesh is not None)
        tr = Trainer(TrainerConfig(total_steps=0, log_every=0), loss, model,
                     opt, lambda step: batches[step], sparse_grads=sparse,
                     on_phase=timer.mark if timer else None, device=dev)
        losses, secs = [], []
        for _ in range(steps):
            tr.cfg.total_steps = tr.step + 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = tr.fit(log=lambda _: None)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if res["skipped_steps"] or not np.isfinite(res["loss"]):
                raise AssertionError(f"phase 40, {cfg.name}: {res}")
            losses.append(res["loss"])
            if after is not None:
                after(tr)
        out = {"losses": losses, "secs": secs,
               "peak_gb": torch.cuda.max_memory_allocated() / GB}
        if keep:
            out.update(grads=opt.first, params=host(torch, tr.params),
                       specs={k: stored_spec(p)
                              for k, p in tr.params.items()})
    del model, tr, opt
    free(torch)
    return out


def sure_masks(torch, grads: dict) -> dict:
    """The elements whose first update the gradient settles: g = 0 (a row
    no token reads), or |g| at least GRAD_TOL of the leaf's rms (below it
    the sign of g is not resolved at the gradients' tolerance, and Adam's
    g / (|g| + eps) or Adafactor's g / sqrt(g^2) may take either sign) and
    at least 10 of Adam's eps (below it g / (|g| + eps) multiplies the
    gradient's own error by up to eps / |g|)."""
    return {k: (g == 0) | ((g.abs() >= GRAD_TOL * torch.sqrt(torch.mean(
        g.to(torch.float64) ** 2)).to(g.dtype)) & (g.abs() >= 10 * ADAM_EPS))
        for k, g in grads.items()}


def held_blocks(torch, mesh_shape, world_rank, got: dict, want: dict,
                specs: dict, sure: dict | None = None, dev=None) -> dict:
    """This rank's share of each leaf's normwise error: the squared norms
    of its block's difference from the oracle's block and of the oracle's
    block, counted on the one rank of each block's replicas (with ``sure``
    only over the elements it keeps; the largest |difference| of the
    others and their count beside, and the block's size), summed on
    ``dev`` (the card: not host work)."""
    from repro_torch.dist.sharding import block, mesh_at, spec_axes
    m = mesh_at(mesh_shape, world_rank)
    out = {}
    for k, g in got.items():
        spec = specs[k]
        used = {a for i in range(len(spec)) for a in spec_axes(spec, i)}
        if not (("data" in used or m.data_rank == 0)
                and ("model" in used or m.rank == 0)):
            continue
        w = block(want[k], m, spec).to(dev, torch.float64)
        d = g.reshape(w.shape).to(dev, torch.float64) - w
        rest, n_rest = 0.0, 0
        if sure is not None:
            keep = block(sure[k], m, spec).to(dev)
            n_rest = int((~keep).sum())
            rest = float(d[~keep].abs().max()) if n_rest else 0.0
            d = d[keep]
        out[k] = (float(torch.sum(d * d)), float(torch.sum(w * w)), rest,
                  n_rest, w.numel())
    return out


def summed(parts: list) -> dict:
    """The ranks' ``held_blocks`` shares -> {leaf: (relative error, the
    largest |difference| of the unsettled elements, their share of the
    leaf)}."""
    tot: dict = {}
    for p in parts:
        for k, (dd, ww, rest, n, size) in p.items():
            a = tot.setdefault(k, [0.0, 0.0, 0.0, 0, 0])
            a[0] += dd
            a[1] += ww
            a[2] = max(a[2], rest)
            a[3] += n
            a[4] += size
    return {k: (float(np.sqrt(a[0]) / max(np.sqrt(a[1]), 1e-30)), a[2],
                a[3] / a[4]) for k, a in tot.items()}


def train_reckon_line(what: str, r: dict) -> str:
    return (f"{what}: reckoned {r['rank_gb']:.2f} GB a rank (blocks, "
            f"gradients, updates and {r['optimizer']} state "
            f"{r['state_gb']:.2f}, the largest leaf gathered over 'data' and "
            f"its gradient {r['gathered_gb']:.2f}, max(backward "
            f"{r['backward_gb']:.2f}, update {r['update_gb']:.2f}), context "
            f"{CONTEXT_GB}), {r['total_gb']:.2f} GB over {MESH_RANKS} ranks")


def pool_row9_check(torch, arch, held: list):
    """``on_update`` of (c)'s sparse steps: the pool's update replayed on
    the host by the same lazy row-wise Adam, whose plain version a CPU
    tensor takes (``after`` holds the card's slab to it, bit for bit)."""
    from repro_torch.optim import sparse as sp
    from repro_torch.optim.optimizers import apply_updates

    def on_update(grads, state, params):
        k = "embed.memory"
        g, st = grads[k], state[k]
        gh = dataclasses.replace(g, indices=g.indices.cpu().clone(),
                                 values=g.values.cpu().clone())
        sh = type(st)(st.step, st.mu.cpu().clone(), st.nu.cpu().clone())
        p = params[k].detach().cpu().clone()
        upd, _ = sp.sparse_rowwise_adam(arch.learning_rate).update(gh, sh, p)
        apply_updates({k: p}, {k: upd})
        held.append(p)
    return on_update


def mesh_train_parts(torch, mesh, dev, kernels) -> dict:
    """A rank's (a), (c) and (d)'s smoke runs, on both meshes, their
    results kept on the host until the oracles come."""
    from repro_torch.configs import get_config
    from repro_torch.dist import exchange as exl
    from repro_torch.embed import make_buffers

    meshes = {"2x2": mesh, "1x4": world_mesh(mesh)}
    out = {"a": {}, "c": {}, "d": {}, "seconds": {}}
    t0 = time.perf_counter()
    cfg = f32_train_cfg()
    ba = mesh_batches(cfg.vocab_size, TRAIN_MESH_B, TRAIN_F32_S, 1, 40)
    for tag, m in meshes.items():
        if mesh.world_rank == 0:
            log(f"40a at {tag}")
        out["a"][tag] = train_steps(torch, m, LM_ARCH, cfg, ba, dev, 1)
    out["seconds"]["40a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg = f32_train_cfg(lma=True)
    arch = get_config(LM_ARCH)
    bc = mesh_batches(cfg.vocab_size, TRAIN_MESH_B, TRAIN_F32_S,
                      TRAIN_LMA_STEPS, 41)
    for tag, m in meshes.items():
        bufs = make_buffers(cfg.embedding, planted_store(
            torch, cfg.embedding, dev), mesh=m)
        exl.FORCED = TRAIN_MESHES[tag]
        try:
            for mode, steps in (("sparse", TRAIN_LMA_STEPS), ("dense", 1)):
                if mesh.world_rank == 0:
                    log(f"40c at {tag}, {mode}")
                held, bits = [], []

                def after(tr):
                    if held:
                        bits.append(bool(torch.equal(
                            tr.params["embed.memory"].detach().cpu(),
                            held.pop())))
                zero(kernels)
                r = train_steps(
                    torch, m, LM_ARCH, cfg, bc, dev, steps, bufs=bufs,
                    sparse=mode == "sparse", after=after,
                    on_update=(pool_row9_check(torch, arch, held)
                               if mode == "sparse" else None))
                r["launches"] = counts(kernels)
                r["row9_bit_equal"] = bits
                out["c"][tag, mode] = r
        finally:
            exl.FORCED = None
        del bufs
    out["seconds"]["40c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for a in (MOE_ARCH, SCOUT_ARCH):
        cfg = moe_smoke_cfg(a)
        bd = mesh_batches(cfg.vocab_size, TRAIN_MESH_B, MOE_SMOKE_S, 1, 42)
        for tag, m in meshes.items():
            if mesh.world_rank == 0:
                log(f"40d {a} at {tag}")
            out["d"][a, tag] = train_steps(torch, m, a, cfg, bd, dev, 1)
    out["seconds"]["40d smoke"] = time.perf_counter() - t0
    return out


def mesh_train_held(torch, mesh, parts: dict, o: dict) -> dict:
    """A rank's shares of (a), (c) and (d)'s errors against the oracles."""
    shapes = {"2x2": (mesh.data, mesh.model), "1x4": (1, mesh.world)}
    r, dev = mesh.world_rank, mesh.device

    def held(tag, got, one, sure=True):
        return {"losses": got["losses"], "peak_gb": got["peak_gb"],
                "grads": held_blocks(torch, shapes[tag], r, got["grads"],
                                     one["grads"], got["specs"], dev=dev),
                "params": held_blocks(torch, shapes[tag], r, got["params"],
                                      one["params"], got["specs"],
                                      one["sure"] if sure else None, dev)}
    out = {"a": {tag: held(tag, g, o["a"]) for tag, g in parts["a"].items()},
           "c": {}, "d": {}}
    for (tag, mode), g in parts["c"].items():
        one = o["c"][mode]
        h = held(tag, g, one)
        h["pool"] = held_blocks(
            torch, shapes[tag], r, {"embed.memory": g["params"][
                "embed.memory"]}, {"embed.memory": one["params"][
                    "embed.memory"]}, g["specs"], dev=dev)
        h.update(launches=g["launches"], row9=g["row9_bit_equal"])
        out["c"][tag, mode] = h
    for (a, tag), g in parts["d"].items():
        out["d"][a, tag] = held(tag, g, o["d"][a, tag])
    return out


def mesh_timed(torch, mesh, arch_id: str, cfg, batches, dev,
               steps: int) -> dict:
    """(b) and (d)'s scout on this rank: ``steps`` steps of ``cfg`` on its
    blocks, timed -> losses, step seconds, the Trainer's phases (CUDA
    events, median after the first step), host-staged s a step by
    collective and by axis, the IPC gathers a step, the peak."""
    timer = PhaseTimer(torch)
    s0, a0 = dict(mesh.staged_s), dict(mesh.axis_s)
    c0, i0 = dict(mesh.staged), dict(mesh.ipc_calls)
    r = train_steps(torch, mesh, arch_id, cfg, batches, dev, steps,
                    timer=timer, keep=False)
    return {"losses": r["losses"], "secs": r["secs"],
            "phase_ms": timer.split_ms(),
            "staged_s": staged_per_step(mesh, s0, steps),
            "staged_calls": {k: (mesh.staged[k] - c0.get(k, 0)) / steps
                             for k in mesh.staged
                             if mesh.staged[k] != c0.get(k, 0)},
            "axis_s": {k: (mesh.axis_s[k] - a0.get(k, 0.0)) / steps
                       for k in mesh.axis_s},
            "ipc_calls": {k: (mesh.ipc_calls[k] - i0.get(k, 0)) / steps
                          for k in mesh.ipc_calls},
            "peak_gb": r["peak_gb"]}


def mesh_train_oracles(torch, dev, kernels) -> dict:
    """One card's (a), (c) and (d) from the seed's parameters and the
    ranks' batches: the losses, first gradients, parameters after, and
    which elements' gradients resolve their sign (``sure_masks``)."""
    from repro_torch.embed import make_buffers
    o = {"c": {}, "d": {}}
    cfg = f32_train_cfg()
    ba = mesh_batches(cfg.vocab_size, TRAIN_MESH_B, TRAIN_F32_S, 1, 40)
    o["a"] = train_steps(torch, None, LM_ARCH, cfg, ba, dev, 1)
    cfg = f32_train_cfg(lma=True)
    bc = mesh_batches(cfg.vocab_size, TRAIN_MESH_B, TRAIN_F32_S,
                      TRAIN_LMA_STEPS, 41)
    bufs = make_buffers(cfg.embedding, planted_store(torch, cfg.embedding,
                                                     dev))
    for mode, steps in (("sparse", TRAIN_LMA_STEPS), ("dense", 1)):
        zero(kernels)
        o["c"][mode] = train_steps(torch, None, LM_ARCH, cfg, bc, dev, steps,
                                   bufs=bufs, sparse=mode == "sparse")
    del bufs
    for a in (MOE_ARCH, SCOUT_ARCH):
        cfg = moe_smoke_cfg(a)
        bd = mesh_batches(cfg.vocab_size, TRAIN_MESH_B, MOE_SMOKE_S, 1, 42)
        for tag, shares in (("2x2", MESH_DATA), ("1x4", 1)):
            o["d"][a, tag] = train_steps(torch, None, a, cfg, bd, dev, 1,
                                         shares=shares)
    for r in (o["a"], *o["c"].values(), *o["d"].values()):
        r["sure"] = sure_masks(torch, r["grads"])
    return o


def mesh_train_rank(mesh, path: str, scout: bool) -> dict:
    """One rank of phase 40 (``run_ranks`` with data=MESH_DATA): (a), (c)
    and (d)'s smoke runs while the parent computes their oracles, held to
    them once they come (``path``); then, once the parent has freed the
    card (``path`` + ".card"), (b) and, where it fits, (d)'s scout."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.dist import collectives as col

    if not torch.cuda.is_available():
        raise RuntimeError("phase 40: a rank found no GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    kernels = shard_kernels()
    parts = mesh_train_parts(torch, mesh, dev, kernels)
    t0 = time.perf_counter()
    wait_for(path)
    o = torch.load(path, mmap=True, weights_only=False)
    waited = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = mesh_train_held(torch, mesh, parts, o)
    out["seconds"] = dict(parts["seconds"], waited_for_oracles=waited,
                          held=time.perf_counter() - t0)
    del o, parts
    free(torch)
    t0 = time.perf_counter()
    wait_for(path + ".card")
    out["seconds"]["waited_for_card"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg = get_config(LM_ARCH).make_model()
    out["b"] = mesh_timed(torch, mesh, LM_ARCH, cfg, mesh_batches(
        cfg.vocab_size, TRAIN_MESH_B, TRAIN_S, TRAIN_MESH_STEPS, 43), dev,
        TRAIN_MESH_STEPS)
    out["seconds"]["40b"] = time.perf_counter() - t0
    if scout:
        t0 = time.perf_counter()
        cfg = scout_mesh_cfg()
        out["scout"] = mesh_timed(torch, world_mesh(mesh), SCOUT_ARCH, cfg,
                                  mesh_batches(cfg.vocab_size, 1, TRAIN_S,
                                               SCOUT_MESH_STEPS, 44), dev,
                                  SCOUT_MESH_STEPS)
        out["seconds"]["40d scout"] = time.perf_counter() - t0
    col.barrier(mesh)
    return out


def run_mesh_train(torch, dev, kernels, card) -> dict:
    """Phase 40: the LMs trained under a (data, model) mesh of MESH_RANKS
    gloo ranks on this card (``mesh_train_rank``), spawned first; the
    parent reckons, computes the one-card oracles, runs (b)'s one-card
    steps, frees the card, then holds the ranks' results to the gates."""
    import tempfile
    import threading

    from repro_torch.configs import get_config
    from repro_torch.dist.collectives import run_ranks

    t_phase = time.perf_counter()
    cfg_b, cfg_s = get_config(LM_ARCH).make_model(), scout_mesh_cfg()
    rk = {"b": train_reckoning(torch, cfg_b, (TRAIN_MESH_B,), "adam",
                               mesh_shape=(MESH_DATA,
                                           MESH_RANKS // MESH_DATA))[
                                               TRAIN_MESH_B],
          "scout": train_reckoning(torch, cfg_s, (1,), "adam",
                                   mesh_shape=(1, MESH_RANKS))[1]}
    for tag in TRAIN_MESHES:
        shape = (MESH_DATA, MESH_RANKS // MESH_DATA) if tag == "2x2" \
            else (1, MESH_RANKS)
        for part, lma in (("a", False), ("c", True)):
            rk[f"{part} {tag}"] = train_reckoning(
                torch, f32_train_cfg(lma), (TRAIN_MESH_B,), "adam",
                TRAIN_F32_S, shape)[TRAIN_MESH_B]
    scout = rk["scout"]["total_gb"] <= SCOUT_MESH_CARD_GB
    log(train_reckon_line(f"40b {LM_ARCH} 22 layers bf16 B={TRAIN_MESH_B} "
                          f"S={TRAIN_S} at (2, 2)", rk["b"]))
    log(train_reckon_line(f"40d {SCOUT_ARCH} full width, 1 of 48 layers, "
                          f"B=1 S={TRAIN_S} at (1, 4)", rk["scout"])
        + (f": within {SCOUT_MESH_CARD_GB} GB, it runs" if scout else
           f": past {SCOUT_MESH_CARD_GB} GB, not run: scout and deepseek-v3 "
           "train under a mesh only on four cards"))
    with tempfile.TemporaryDirectory(prefix="mesh-train-",
                                     dir=ROOT / "build") as tmp:
        path = str(Path(tmp) / "oracle.pt")
        spawned = {}

        def spawn():
            t0 = time.perf_counter()
            try:
                spawned["ranks"] = run_ranks(
                    mesh_train_rank, MESH_RANKS, path, scout, data=MESH_DATA,
                    backend="gloo", device=MESH_DEVICE)
            except BaseException as e:          # re-raised below
                spawned["error"] = e
            spawned["s"] = time.perf_counter() - t0
        thread = threading.Thread(target=spawn)
        thread.start()
        t0 = time.perf_counter()
        try:
            o = mesh_train_oracles(torch, dev, kernels)
            torch.save(o, path)
            Path(path + ".ready").touch()
            oracle_s = time.perf_counter() - t0
            g = o["c"]["sparse"]["grads"]["embed.memory"]
            g = g[g != 0]                   # the slots the batch touched
            losses = {"a": o["a"]["losses"],
                      "c": {k: r["losses"] for k, r in o["c"].items()},
                      "d": {k: r["losses"] for k, r in o["d"].items()},
                      "pool_grad": (float(g.square().mean().sqrt()),
                                    int((g.abs() < 10 * ADAM_EPS).sum()),
                                    g.numel())}
            del o
            free(torch)
            t0 = time.perf_counter()
            one_b = train_steps(torch, None, LM_ARCH, cfg_b, mesh_batches(
                cfg_b.vocab_size, TRAIN_MESH_B, TRAIN_S, TRAIN_MESH_STEPS,
                43), dev, TRAIN_MESH_STEPS, keep=False)
            one_b_s = time.perf_counter() - t0
            free(torch)
        except BaseException:
            for end in (".failed", ".card.failed"):
                Path(path + end).touch()
            thread.join()
            raise
        Path(path + ".card.ready").touch()
        thread.join()
        if "error" in spawned:
            raise spawned["error"]
        ranks, ranks_s = spawned["ranks"], spawned["s"]
    return mesh_train_report(rk, ranks, losses, one_b, card, {
        "oracles": oracle_s, "one card's 40b": one_b_s, "ranks": ranks_s,
        "phase": time.perf_counter() - t_phase})


def mesh_train_report(rk: dict, ranks: list, losses: dict, one_b: dict,
                      card: str, secs: dict) -> dict:
    """Phase 40's gates over the ranks' results, and its lines."""
    from repro_torch.configs import get_config

    def loss_err(got, want) -> float:
        return max(abs(g - w) / abs(w) for g, w in zip(got, want))

    failed = []

    def gate(part: str, key, one: list, lr: float, steps: int,
             pool: bool = False) -> dict:
        rs = [r[part][key] for r in ranks]
        le = max(loss_err(r["losses"], one) for r in rs)
        g = summed([r["grads"] for r in rs])
        p = summed([r["params"] for r in rs])
        if pool:                        # held to POOL_TOL below
            del p["embed.memory"]
        worst_g = max(g.items(), key=lambda kv: kv[1][0])
        worst_p = max(p.items(), key=lambda kv: kv[1][0])
        rest = max(v[1] for v in p.values())
        share = max(p.items(), key=lambda kv: kv[1][2])
        if le > GRAD_TOL or worst_g[1][0] > GRAD_TOL \
                or worst_p[1][0] > GRAD_TOL or rest > 2 * lr * steps \
                or share[1][2] > UNSETTLED_SHARE:
            failed.append(f"40{part} {key}: loss {le:.3g}, gradient "
                          f"{worst_g}, after {worst_p}, the unsettled "
                          f"elements' largest change {rest:.3g} (bound "
                          f"{2 * lr * steps:.3g}), their largest share "
                          f"{share}")
        out = {"loss_rel": le, "grad_rel": worst_g[1][0],
               "grad_worst": worst_g[0], "param_rel": worst_p[1][0],
               "param_worst": worst_p[0], "unsettled_share": share[1][2],
               "unsettled_worst": share[0], "unsettled_max": rest,
               "peak_gb": [r["peak_gb"] for r in rs]}
        if pool:
            pr = summed([r["pool"] for r in rs])["embed.memory"][0]
            if pr > POOL_TOL:
                failed.append(f"40c {key}: the pool slabs {pr:.3g} from "
                              "one card's")
            out["pool_rel"] = pr
        return out

    def peaks(part: str, key) -> list:
        return [r[part][key]["peak_gb"] for r in ranks]

    def line(r: dict) -> str:
        return (f"loss {r['loss_rel']:.3g} (relative), every leaf's "
                f"gradient within {r['grad_rel']:.3g} normwise (worst "
                f"{r['grad_worst']}), every leaf after the update within "
                f"{r['param_rel']:.3g} (worst {r['param_worst']}) over the "
                f"elements whose gradient settles the update (the others at "
                f"most {r['unsettled_share']:.3g} of a leaf, "
                f"{r['unsettled_worst']}, largest change "
                f"{r['unsettled_max']:.3g}); peaks "
                + ", ".join(f"{x:.2f}" for x in r["peak_gb"])
                + " GB a rank" + (f" beside the reckoned {rk_:.2f}"
                                  if (rk_ := r.get("reckoned_gb")) else ""))
    lr = get_config(LM_ARCH).learning_rate
    summary = {"a": {}, "c": {}, "d": {}}
    for tag in TRAIN_MESHES:
        r = summary["a"][tag] = gate("a", tag, losses["a"], lr, 1)
        r["reckoned_gb"] = rk[f"a {tag}"]["rank_gb"]
        log(f"40a {LM_ARCH} full width, {TRAIN_F32_LAYERS} layers, float32 "
            f"(TF32 off), B={TRAIN_MESH_B} S={TRAIN_F32_S}, one Adam step "
            f"at ({tag.replace('x', ', ')}) against one card's: " + line(r)
            + f"; card {card}")
    launches = {}
    lma = f32_train_cfg(lma=True).embedding.lma
    pool_m, pool_d = lma.m, lma.d
    for tag, strategy in TRAIN_MESHES.items():
        for mode, steps in (("sparse", TRAIN_LMA_STEPS), ("dense", 1)):
            key = (tag, mode)
            r = summary["c"][f"{tag} {mode}"] = gate(
                "c", key, losses["c"][mode], lr, steps, pool=True)
            r["reckoned_gb"] = rk[f"c {tag}"]["rank_gb"]
            want = {k: v * steps for k, v in
                    TRAIN_LMA_LAUNCHES[strategy][mode].items()}
            for rank in ranks:
                got = rank["c"][key]
                if got["launches"] != want:
                    failed.append(f"40c {key}: rank {rank['rank']} launched "
                                  f"{got['launches']}, want {want}")
                if mode == "sparse" and (len(got["row9"]) != steps
                                         or not all(got["row9"])):
                    failed.append(f"40c {key}: the pool after row 9 is not "
                                  f"the plain lazy Adam's: {got['row9']}")
            name = f"lm mesh train lma {strategy}" + (
                " dense" if mode == "dense" else "")
            launches[name] = ranks[0]["c"][key]["launches"]
            log(f"40c LMA token table (m={pool_m:,}, d={pool_d:,}, alpha "
                f"16) on 40a's model, {mode} pool gradients, {steps} step(s) "
                f"under {strategy} at ({tag.replace('x', ', ')}): the pool "
                f"slabs within {r['pool_rel']:.3g} of one card's (the "
                f"touched slots' step-1 gradients: rms "
                f"{losses['pool_grad'][0]:.3g}, {losses['pool_grad'][1]:,} "
                f"of {losses['pool_grad'][2]:,} under 10 x Adam's eps)"
                + (", each step's slab bit-equal to the plain lazy Adam of "
                   "its SparseGrad" if mode == "sparse" else "")
                + "; " + line(r) + f"; launches a rank {want}; card {card}")
    for a in (MOE_ARCH, SCOUT_ARCH):
        alr = get_config(a).learning_rate
        for tag in TRAIN_MESHES:
            r = summary["d"][f"{a} {tag}"] = gate("d", (a, tag),
                                                 losses["d"][a, tag], alr, 1)
            log(f"40d {a} smoke config, float32 on the card, B="
                f"{TRAIN_MESH_B} S={MOE_SMOKE_S}, one "
                f"{get_config(a).optimizer} step at "
                f"({tag.replace('x', ', ')}) against one card's of the same "
                "semantics" + (" (each 'data' share's MoE capacity and aux)"
                               if tag == "2x2" else "") + ": "
                + line(r) + f"; card {card}")
    b = [r["b"] for r in ranks]
    for r in b:
        le = loss_err(r["losses"], one_b["losses"])
        if le > BF16_LOSS_TOL:
            failed.append(f"40b: losses {r['losses']} against one card's "
                          f"{one_b['losses']}")
    r0 = b[0]
    step_s = float(np.median(r0["secs"]))
    tokens = TRAIN_MESH_B * TRAIN_S
    summary["b"] = {
        "losses": r0["losses"], "one_card_losses": one_b["losses"],
        "loss_rel": max(loss_err(r["losses"], one_b["losses"]) for r in b),
        "step_s": r0["secs"], "steps_per_sec": 1.0 / step_s,
        "tokens_per_sec": tokens / step_s,
        "one_card_step_s": one_b["secs"], "phase_ms": r0["phase_ms"],
        "staged_s": r0["staged_s"], "staged_calls": r0["staged_calls"],
        "axis_s": r0["axis_s"], "ipc_calls": r0["ipc_calls"],
        "peak_gb": [r["peak_gb"] for r in b], "reckoning": rk["b"]}
    sb = summary["b"]
    log(f"40b {LM_ARCH} 22 layers bf16 (remat, loss_chunk 512, Adam lr {lr}),"
        f" B={TRAIN_MESH_B} S={TRAIN_S} at (2, 2): losses "
        + " ".join(f"{x:.5f}" for x in sb["losses"]) + " (one card's "
        + " ".join(f"{x:.5f}" for x in one_b["losses"])
        + f", within {sb['loss_rel']:.3g}); steps "
        + ", ".join(f"{x:.2f}" for x in r0["secs"])
        + f" s (one card's " + ", ".join(f"{x:.2f}" for x in one_b["secs"])
        + f"): {sb['steps_per_sec']:.4f} steps/s, "
        f"{sb['tokens_per_sec']:,.0f} tokens/s (median step, host clock); "
        "phases (rank 0, CUDA events, ms, median after the first) "
        + ", ".join(f"{k} {v:.1f}" for k, v in sb["phase_ms"].items())
        + "; host-staged s a step by collective "
        + ", ".join(f"{k} {v:.3f} ({sb['staged_calls'][k]:.0f} calls)"
                    for k, v in sorted(sb["staged_s"].items()))
        + ", by axis " + ", ".join(f"{k} {v:.3f}"
                                   for k, v in sorted(sb["axis_s"].items()))
        + ", IPC gathers a step " + ", ".join(
            f"{k} {v:.0f}" for k, v in sorted(sb["ipc_calls"].items()))
        + "; peaks " + ", ".join(f"{p:.2f}" for p in sb["peak_gb"])
        + f" GB a rank ({sum(sb['peak_gb']):.2f} on the card) beside the "
        f"reckoned {rk['b']['rank_gb']:.2f} ({rk['b']['total_gb']:.2f}); "
        f"card {card}")
    if "scout" in ranks[0]:
        sc = [r["scout"] for r in ranks]
        summary["scout"] = {
            "losses": sc[0]["losses"], "step_s": sc[0]["secs"],
            "staged_s": sc[0]["staged_s"], "phase_ms": sc[0]["phase_ms"],
            "peak_gb": [r["peak_gb"] for r in sc],
            "reckoning": rk["scout"]}
        log(f"40d {SCOUT_ARCH} full width, 1 of 48 layers, bf16, B=1 "
            f"S={TRAIN_S} at (1, 4): losses "
            + " ".join(f"{x:.5f}" for x in sc[0]["losses"]) + "; steps "
            + ", ".join(f"{x:.2f}" for x in sc[0]["secs"]) + " s; peaks "
            + ", ".join(f"{r['peak_gb']:.2f}" for r in sc)
            + f" GB a rank ({sum(r['peak_gb'] for r in sc):.2f}) beside the "
            f"reckoned {rk['scout']['rank_gb']:.2f} "
            f"({rk['scout']['total_gb']:.2f}); host-staged s a step "
            + ", ".join(f"{k} {v:.3f}"
                        for k, v in sorted(sc[0]["staged_s"].items()))
            + f"; card {card}")
    else:
        summary["scout"] = {"run": False, "reckoning": rk["scout"]}
        log(f"40d {SCOUT_ARCH}: not run, its reckoned "
            f"{rk['scout']['total_gb']:.2f} GB on the card past "
            f"{SCOUT_MESH_CARD_GB}: scout and deepseek-v3 train under a mesh "
            f"only on four cards; card {card}")
    summary["seconds"] = secs
    summary["rank_seconds"] = ranks[0]["seconds"]
    log(f"40: " + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items())
        + " (rank 0: " + ", ".join(f"{k} {v:.1f} s" for k, v in
                                   ranks[0]["seconds"].items()) + ")")
    if failed:
        raise AssertionError("phase 40: " + "; ".join(failed))
    return {"launches": launches, "summary": summary}


SOURCES = {
    "lma_locations": ("src/repro_torch/csrc/lma_locations.cu",
                      "src/repro/kernels/lma_locations/kernel.py:108"),
    "fused_embed": ("src/repro_torch/csrc/fused_embed.cu",
                    "src/repro/kernels/fused_embed/kernel.py:356"),
    "dot_interaction": ("src/repro_torch/csrc/dot_interaction.cu",
                        "src/repro/kernels/dot_interaction/kernel.py:48"),
    "fused_locations": ("src/repro_torch/csrc/fused_embed.cu",
                        "src/repro/kernels/fused_embed/kernel.py:374"),
    "fused_scatter_add": ("src/repro_torch/csrc/fused_embed.cu",
                          "src/repro/kernels/fused_embed/kernel.py:404"),
    "fused_weight_grad": ("src/repro_torch/csrc/fused_embed.cu",
                          "src/repro/kernels/fused_embed/kernel.py:516"),
    "sparse_adagrad": ("src/repro_torch/csrc/sparse_update.cu",
                       "src/repro/kernels/sparse_update/kernel.py:120"),
    "cin": ("src/repro_torch/csrc/cin.cu", "src/repro/kernels/cin/kernel.py:39"),
    "sparse_sgd": ("src/repro_torch/csrc/sparse_update.cu",
                   "src/repro/kernels/sparse_update/kernel.py:120"),
    "sparse_adam": ("src/repro_torch/csrc/sparse_update.cu",
                    "src/repro/kernels/sparse_update/kernel.py:120"),
    "embedding_bag": ("src/repro_torch/csrc/embedding_bag.cu",
                      "src/repro/kernels/embedding_bag/kernel.py:56"),
    "fused_chunk_lookup": ("src/repro_torch/csrc/fused_embed.cu",
                           "src/repro/kernels/fused_embed/kernel.py:454"),
    "fused_chunk_gather": ("src/repro_torch/csrc/fused_embed.cu",
                           "src/repro/kernels/fused_embed/kernel.py:472"),
    "fused_chunk_scatter": ("src/repro_torch/csrc/fused_embed.cu",
                            "src/repro/kernels/fused_embed/kernel.py:490"),
}

# The batch of each kernel's JSON entry: the training batch for the rows the
# training step launches at B=65,536; for the dot interaction B=512, the
# largest served batch (its other batches, 65,536 included, beside it); the
# smallest measured otherwise (for
# the CIN, B=512, a served batch; its entry sums the three layers; for the
# embedding bag, the reference's bench shape, B=2,048).  The sparse
# optimizers' entries are the LMA pool's K=109,051,904 stream; the chunk
# kernels' (rows 10-12) rank 0's shapes of a sharded B=65,536 step.
MAIN_BATCH = {"fused_locations": 65536, "fused_scatter_add": 65536,
              "dot_interaction": 512}
BY_STREAM = ("sparse_adagrad", "sparse_sgd", "sparse_adam")
CHUNK_KERNELS = ("fused_chunk_lookup", "fused_chunk_gather",
                 "fused_chunk_scatter")


# the parts run aside (``Aside``), by job name
ASIDE_JOBS = {"durability": durability_aside, "tiering": tiering_aside}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(card)
    t_start = time.perf_counter()
    # the host batches of phases 9, 33c and 38, drawn in a spawned process
    # while the card runs the phases before them
    if sys.argv[1:] in (["--phase", "39"], ["--phase", "40"]):
        return phase_alone(torch, dev, card, sys.argv[2])
    draws = HostDraws(host_jobs())
    try:
        return run_phases(torch, dev, card, t_start, draws)
    finally:
        draws.close()


def phase_alone(torch, dev, card: str, phase: str) -> int:
    """``python3 chip_smoke.py --phase 39`` (the LMs served under a mesh)
    or ``--phase 40`` (trained under it): the build, then that phase only,
    its summary and the result line."""
    from repro_torch.kernels import KERNELS, build

    t0 = time.perf_counter()
    build.build_all(list(KERNELS))
    log(f"built {list(KERNELS)} in {time.perf_counter() - t0:.1f} s")
    if phase == "39":
        out = run_mesh_lm(torch, dev, shard_kernels(), card)
        log(json.dumps({"lm_mesh": out["summary"], "launches":
                        out["launches"], "timing": out["timing"],
                        "card": card}))
    else:
        out = run_mesh_train(torch, dev, shard_kernels(), card)
        log(json.dumps({"lm_mesh_train": out["summary"], "launches":
                        out["launches"], "card": card}, default=str))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def host_jobs() -> list:
    """``HostDraws``' jobs, in the order the phases take them: phase 9's
    launcher runs (each arch once: its kinds draw the same batches), 33c's
    DIN runs, phase 38's train_4k batches."""
    lm = [("lm", LM_ARCH, TRAIN_B, TRAIN_S, 1 + TRAIN_TIMED)] + [
        ("lm", a, 1, TRAIN_S, 1 + MOE_TRAIN_TIMED)
        for a in (MOE_ARCH, SCOUT_ARCH)]
    return [("ctr", [("launcher", ["--arch", a, "--steps",
                                   str(LAUNCHER_STEPS), "--batch",
                                   str(LAUNCHER_BATCH)])
                     for a in ("lma-dlrm-criteo", "lma-dlrm-avazu")]),
            ("din", [("launcher", DIN_TIER_ARGS)]),
            ("lm", lm)]


def run_phases(torch, dev, card: str, t_start: float, draws) -> int:
    from repro_torch.configs._recsys_common import RECSYS_SHAPE_TABLE
    from repro_torch.kernels import KERNELS, build

    def mark(what: str) -> None:
        log(f"[{time.perf_counter() - t_start:.1f} s] {what} done")

    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    t0 = time.perf_counter()
    reports = build.build_all(list(KERNELS))
    log(f"built {list(KERNELS)} in {time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        for fn, st in ptxas_table(rep).items():
            PTXAS[fn] = st
            log(f"  {name}: {fn}: {st['registers']} registers, "
                f"{st['stack']} B stack, {st['spill']} B spill stores")
    kernels = shard_kernels()
    mark("phase 1 (the build)")

    cfg, model, bufs = build_model(torch, dev)
    rng = np.random.default_rng(SEED)
    check_batch = draw_requests(rng, cfg.embedding.vocab_sizes, 512,
                                cfg.n_dense)
    err = check_kernels(torch, cfg, model, bufs, check_batch, dev)
    counts, runs, served = serve(torch, cfg, model, bufs, dev, kernels)
    paths = {"dlrm-rm2 serve": dict(counts)}
    counts["lma_locations"] = split_lookup(torch, cfg, model, bufs, served,
                                           dev, kernels)
    paths["dlrm-rm2 split lookup"] = {"lma_locations":
                                      counts["lma_locations"]}
    res = measure(torch, cfg, model, bufs, dev)
    res["dot_interaction"] = measure_dot(torch, cfg, model, bufs, dev)
    err["dot_interaction"] = max([err["dot_interaction"]] + [
        r["max_abs_err"] for r in res["dot_interaction"].values()])
    mark("phases 2-6")

    gen = ctr_generator(cfg)
    B_train = RECSYS_SHAPE_TABLE["train_batch"]["batch"]
    train_batch = gen.batch(B_train, 0)
    sg = real_step_grad(torch, cfg, model, bufs, train_batch, dev)
    err.update(check_training_kernels(torch, cfg, model, bufs, check_batch,
                                      sg, dev))
    full = check_full_batch(torch, cfg, bufs,
                            model.embedding["memory"].detach(), train_batch,
                            dev)
    for name in ("fused_locations", "fused_scatter_add"):
        err[name] = max(err[name], full[name])
    train = train_full_width(torch, "dlrm-rm2", cfg, model, bufs, gen,
                             B_train, dev, kernels)
    for name in ("fused_locations", "fused_scatter_add", "sparse_adagrad"):
        counts[name] = train["launches"][name]
    paths["dlrm-rm2 train sparse"] = train["sparse"]["launches"]
    paths["dlrm-rm2 train dense"] = train["dense"]["launches"]
    mark("phases 7-8")
    with drawn_batches(draws.take("ctr")) as drawn:
        launcher = launcher_comparison(torch, kernels)
    log(f"phase 9's batches drawn aside in {drawn['seconds']:.1f} s, waited "
        f"for {drawn['waited']:.1f} s; {drawn['hits']} taken, "
        f"{drawn['misses']} drawn here")
    mark("phase 9")
    bag_counts, bag_err = bag_backward(torch, cfg, model, bufs, dev, kernels)
    counts["fused_weight_grad"] = bag_counts["fused_weight_grad"]
    paths["dlrm-rm2 bag backward"] = bag_counts
    res.update(measure_training(torch, cfg, model, bufs, gen, train_batch,
                                full["plain_ms"], sg, dev))
    opt = run_optimizers(torch, cfg, model, bufs, gen, B_train, sg, dev,
                         kernels)
    paths.update(opt["paths"])
    for name, e in opt["err"].items():      # row 7 also on the row layout
        err[name] = max(err.get(name, 0.0), e)
    res["sparse_adagrad"]["rows"] = opt["res"].pop("sparse_adagrad")["rows"]
    res.update(opt["res"])
    counts["sparse_sgd"] = paths["dlrm-rm2 train sgd sparse"]["sparse_sgd"]
    counts["sparse_adam"] = sum(c.get("sparse_adam", 0)
                                for c in paths.values())
    counts["embedding_bag"] = paths["embedding_bag op"]["embedding_bag"]
    mark("phases 10-11, 18-22")
    # 32's chaos soak and pool scan and 33's tiered chaos run, whose time
    # is host work, each in a process of its own beside phases 32-31
    aside = {job: Aside(job) for job in ASIDE_JOBS}
    try:
        durable = run_durability(
            torch, cfg, model, bufs, gen, B_train, dev, kernels,
            launcher["lma-dlrm-criteo"]["lma"]["auc"], card)
        paths.update(durable["paths"])
        mark("phase 32 (its chaos soak aside)")
        tiering = run_tiering(torch, cfg, model, bufs, gen, dev, kernels,
                              card, draws.take("din"))
        paths.update(tiering["paths"])
        mark("phase 33 (its chaos run aside)")
        log(f"peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (dlrm-rm2 "
            "phases)")

        # free dlrm-rm2's pool, training state and SparseGrad; its D'
        # store serves DCN-v2 (the same vocabularies), then goes too
        del cfg, model, sg, train_batch
        free(torch)
        dcn = run_dcn(torch, dev, kernels, bufs, gen)
        del bufs
        free(torch)
        schemes = run_schemes(torch, dev, kernels, gen)
        del gen
        din = run_din(torch, dev, kernels)
        for name in ("fused_locations", "fused_scatter_add"):
            err[name] = max(err[name], dcn["check"][name],
                            din["check"][name])
        for run in (dcn, schemes, din):
            paths.update(run["paths"])
        free(torch)
        log(f"after freeing dlrm-rm2, DCN-v2 and DIN: "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        mark("phases 29-31")
        took = {job: a.take() for job, a in aside.items()}
    finally:
        for a in aside.values():
            a.close()
    soak = took["durability"]
    durable["summary"].update(soak=soak["soak"], integrity=soak["integrity"])
    paths["dlrm-rm2 durability soak"] = soak["launches"]
    tiering["summary"]["durability"] = took["tiering"]
    log("aside, beside phases 32-31: "
        + "; ".join(f"{job} {t['seconds']:.1f} s from its spawn, waited "
                    f"for {t['waited']:.1f} s" for job, t in took.items()))
    mark("32c-d and 33b (aside)")
    xcounts, err["cin"], xres, xserving, xtrain = run_xdeepfm(torch, dev,
                                                              kernels)
    res["cin"] = xres
    counts["cin"] = xcounts["serve"]["cin"]
    paths.update({f"xdeepfm {k.replace('_', ' ')}": c
                  for k, c in xcounts.items()})
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        "GiB (xdeepfm phases)")
    mark("phases 12-17")

    # free xDeepFM, then dlrm-rm2 sharded over 4 ranks on this card: at
    # (1, 4) (phases 23-28), then the rest of distribution (phase 34); the
    # GAT's two large graphs are built on the host meanwhile (phase 36)
    import tempfile
    free(torch)
    graphs = GraphBuilder()
    try:
        with tempfile.TemporaryDirectory(prefix="sharded-",
                                         dir=ROOT / "build") as tmp:
            shard = run_sharded(torch, dev, kernels, card, tmp)
            mark("phases 23-28")
            distribution = run_distribution(torch, card, shard, tmp)
            mark("phase 34")
        paths.update(shard["paths"])
        paths.update(distribution["paths"])
        # the dense LM at full width (phase 35): it needs the card whole
        free(torch)
        lm = run_lm(torch, dev, kernels, card)
        paths.update(lm["lma"]["launches"])
        mark("phase 35")
        # the GAT at full width (phase 36)
        gat = run_gat(torch, dev, kernels, card, graphs)
        paths.update(gat["lma"]["launches"])
        mark("phase 36")
    finally:
        graphs.close()
    # the MoE and MLA LMs at full width and reduced depth (phase 37), last
    free(torch)
    moe_lm = run_moe(torch, dev, kernels, card)
    paths.update(moe_lm["lma"]["launches"])
    mark("phase 37")
    # the LMs trained at train_4k (phase 38), last
    free(torch)
    lm_train = run_lm_train(torch, dev, kernels, card, draws.take("lm"))
    paths.update(lm_train["lma"]["launches"])
    mark("phase 38")
    # the LMs served under a (data, model) mesh of gloo ranks (phase 39)
    free(torch)
    mesh_lm = run_mesh_lm(torch, dev, kernels, card)
    paths.update(mesh_lm["launches"])
    mark("phase 39")
    # the LMs trained under that mesh (phase 40)
    free(torch)
    mesh_train = run_mesh_train(torch, dev, kernels, card)
    paths.update(mesh_train["launches"])
    mark("phase 40")
    for name, e in shard["err"].items():
        err[name] = max(err.get(name, 0.0), e)
    res.update(shard["res"])
    for name in CHUNK_KERNELS:
        counts[name] = sum(c.get(name, 0) for c in
                           (*shard["paths"].values(),
                            *distribution["paths"].values()))

    rows = []
    for name, (source, replaces) in SOURCES.items():
        r = res[name]
        if name in CHUNK_KERNELS:
            main_r, where = r, f"{r['batch']} rows"
            extra = {k: r[k] for k in ("batch", "at_chunk") if k in r}
        elif name in BY_STREAM:
            main_r = r
            extra = {k: r[k] for k in ("K", "slots", "rows", "passes_ms")
                     if k in r}
            where = f"K={r['K']}"
            if "rows" in r:
                where += (f" (row layout K={r['rows']['K']}: "
                          f"{r['rows']['ms']:.4f} ms, bound "
                          f"{r['rows']['bound_ms']:.4f} ms)")
        else:
            at = MAIN_BATCH.get(name, min(r))
            main_r, extra = r[at], {"batch": at}
            extra.update({k: main_r[k] for k in (
                "bound_fp32_ms", "bound_3xtf32_ms", "launch_floor_ms",
                "launch_floor_warm_ms", "fill_ms", "kernel_fill_ms", "grid",
                "blocks_per_sm",
                "registers") if k in main_r})
            where = f"B={at}"
            for other in sorted(set(r) - {at}):
                extra[f"at_batch_{other}"] = r[other]
                where += (f" (B={other}: {r[other]['ms']:.4f} ms, bound "
                          f"{r[other]['bound_ms']:.4f} ms)")
        if name in lm_train["lma"]["rows"]:     # 38b's shapes
            t = extra["at_lm_train"] = lm_train["lma"]["rows"][name]
            where += (f" (LM train_4k, "
                      + (f"K={t['K']}" if "K" in t
                         else f"{t['tokens']} tokens") + f": {t['ms']:.4f} "
                      f"ms, bound {t['bound_ms']:.4f} ms)")
        if name in mesh_lm["timing"]:   # 39e: rank 0's shapes at (1, 4)
            t = extra["at_lm_mesh"] = mesh_lm["timing"][name]
            where += (f" (LM (1, 4), {t['tokens']} rows: {t['ms']:.4f} ms, "
                      f"bound {t['bound_ms']:.4f} ms)")
        if name == "fused_embed":       # LMA token tables, d = 2,048, 7,168
            extra["at_lm"] = lm["lma"]["row2"]
            extra["at_moe_lm"] = moe_lm["lma"]["row2"]
            for d, r in ((2048, lm["lma"]["row2"]),
                         (7168, moe_lm["lma"]["row2"])):
                for t in [r["prefill"], *r["sweep"].values()]:
                    where += (f" (LM d={d}, {t['tokens']} tokens: "
                              f"{t['ms']:.4f} ms, bound "
                              f"{t['bound_ms']:.4f} ms)")
        if name in lm["lma"]["rows_4_10"]:      # few rows, d = 2,048, 7,168
            extra["at_lm"] = lm["lma"]["rows_4_10"][name]
            extra["at_moe_lm"] = moe_lm["lma"]["rows_4_10"][name]
            for d, r in ((2048, extra["at_lm"]), (7168, extra["at_moe_lm"])):
                for t in r.values():
                    where += (f" (LM d={d}, {t['tokens']} rows: "
                              f"{t['ms']:.4f} ms, bound "
                              f"{t['bound_ms']:.4f} ms)")
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": err[name], "ms": main_r["ms"],
            "plain_ms": main_r["plain_ms"], "bound_ms": main_r["bound_ms"],
            "bound_by": main_r["bound_by"],
            "library_ms": main_r["library_ms"], **extra,
            "launches_by_path": {path: c[name] for path, c in paths.items()
                                 if c.get(name)},
        })
        log(f"kernel {name}: launches {counts[name]}, max |err| "
            f"{err[name]:.3g}; {where} {main_r['ms']:.4f} ms (bound "
            f"{main_r['bound_ms']:.4f} ms, {main_r['bound_by']}); card "
            f"{card}")
    log(json.dumps({"training": train, "launcher": launcher,
                    "bag_backward": bag_err, "card": card}))
    log(json.dumps({"optimizer_training": opt["train"], "card": card}))
    log(json.dumps({"serving": runs, "card": card}))
    log(json.dumps({"schemes": {k: schemes[k] for k in ("serving", "train",
                                                        "freq")},
                    "card": card}))
    log(json.dumps({"dcn-v2": {k: dcn[k] for k in ("serving", "train",
                                                   "retrieval")},
                    "din": {k: din[k] for k in ("serving", "train",
                                                "retrieval")},
                    "card": card}))
    log(json.dumps({"xdeepfm": {"serving": xserving, "training": xtrain},
                    "card": card}))
    log(json.dumps({"sharded": shard["summary"], "card": card}))
    log(json.dumps({"distribution": distribution["summary"], "card": card}))
    log(json.dumps({"durability": durable["summary"], "card": card}))
    log(json.dumps({"tiering": tiering["summary"], "card": card}))
    log(json.dumps({"lm": {k: v for k, v in lm.items() if k != "card"},
                    "card": card}))
    log(json.dumps({"gat": {k: v for k, v in gat.items() if k != "card"},
                    "card": card}))
    log(json.dumps({"moe_lm": {k: v for k, v in moe_lm.items()
                               if k != "card"}, "card": card}))
    log(json.dumps({"lm_train": {k: v for k, v in lm_train.items()
                                 if k != "card"}, "card": card}))
    log(json.dumps({"lm_mesh": mesh_lm["summary"], "card": card}))
    log(json.dumps({"lm_mesh_train": mesh_train["summary"], "card": card},
                   default=str))
    log(json.dumps({"kernels": rows}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
