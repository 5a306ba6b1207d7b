#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # the full check, one card

Phases (each prints one JSON line; any failure exits nonzero):

1. device: ``nvidia-smi`` name and power limit, ``torch.cuda`` name;
2. build: every CUDA source of the port, one ``nvcc`` per source;
3. main path at the paper's MS-150k operating point: seeded vMF data
   (152,185 x 768), ``LAFPipeline(backend="random_projection")
   .fit_split`` (estimator epochs cut to ``--epochs``), then
   ``cluster_laf_dbscan(test, eps=0.55, tau=5, alpha=1.5)`` on the
   30,437-row test split, with every kernel's launch count set to 0
   just before and read just after (pass 2's fixpoint: one
   ``label_prop_fixpoint`` launch, no ``label_prop_rect`` or
   ``label_prop_update`` launch, one ``row_popcount`` launch);
4. cluster-pass parity: the same sweep through the port's host
   union-find pass (``cluster_device=False``) gives identical labels;
   ground truth: exact DBSCAN of the test split
   (``dbscan_parallel(backend="exact")``, the ``range_count`` kernel),
   held label for label to ``laf_dbscan`` with every point predicted
   core through the device packed pass (``cluster_device=True``);
   quality: ARI of the LAF labels against it (>= 0.99);
5. exact path: ``cluster_dbscan``, ``cluster_laf_dbscan`` (alpha 1.5),
   DBSCAN++ and LAF-DBSCAN++ (p = auto_sample_fraction(pred, 5, 1.5,
   0.2), alpha 1.0) on the exact backend, each warmed up once and then
   timed with the launch counts set to 0 just before and read just
   after; exact LAF-DBSCAN must reach ARI >= 0.99; each LAF method's
   predict is 3 ``rmi_mlp`` launches (one a stage), as on the main path;
6. components: the exact square adjacency of the test split
   (``range_bitmap``, 30,437 x 952 words) masked to exact DBSCAN's core
   points, through ``label_propagation_pallas`` (its rounds run in one
   ``label_prop_fixpoint`` launch and no ``label_prop_round`` or update
   launch, counts set to 0 just before and read just after): labels
   equal to exact DBSCAN's clusters on the cores and to plain
   ``label_propagation``;
7. each kernel against its plain PyTorch version on the card at the main
   path's shapes, with its time, the plain version's time and its bound;
   ``range_count`` also at DBSCAN++'s gathered sampled-core columns;
   ``rmi_mlp`` at the predict shape (every stage on all test rows) with
   the route and core-test flips it causes counted, and the fp32
   ``F.linear`` chain (five calls an expert) as its library yardstick;
   ``label_prop_round``, the square update and ``label_prop_fixpoint``
   in square mode on the components slab, ``label_prop_fixpoint`` in
   rect mode on the main path's slab (each fixpoint telemetry off and
   on, held exactly to ``label_prop_fixpoint_ref``: labels, flags,
   telemetry; its ptxas registers and spill bytes; its bound rounds x
   (K2's bytes + the update's)); the fixpoint, update rows, K2, K3 and
   ``label_prop_round`` also queued behind a
   sleep (the kernels' own time), the main path's update also before
   phase 6 ran; pass 2 alone (``packed_cluster_labels`` on the main
   slab) under the profiler, its busy share and top kernels
   (``pass2_trace``); K2, K3 and ``label_prop_round`` with their slab's set
   bits, nonzero words and bits a row, and ptxas's registers and spill
   bytes; ``predict_ab``:
   ``laf.predict``'s work with the fused forward and with the
   ``nn.Linear`` modules it replaced, in alternating turns, and its parts.
   The Hamming-filter rows are bound by max(bytes / 3.35 TB/s, 2 nq nd
   n_bits / 1,979 TOPS: the distances as int8 tensor-core products),
   with the CUDA cores' POPC time (nq nd w / (132 x 16 x the card's max
   SM clock)) beside it; the ``rmi_mlp`` row by the fp32 FMA rate, with
   the 3xTF32 tensor-core floor (3 x FLOP / 494.7 TFLOP/s) beside it.
   These rows also carry ptxas's registers, spill bytes and ``wgmma``
   notes for their kernels and the ``*GMMA`` opcodes in their SASS;
8. observability: the main path once with everything off and once after
   ``obs.enable(trace=True, metrics_on=True, telemetry=True)`` (same
   labels, one host sync, per-round telemetry equal to the gauges, the
   span tree exported to a Chrome trace, ``coverage`` printed); a count
   sweep of the whole split with its per-chunk occupancy slab held to the
   plain version; ``suggest_margin`` on the card against the host
   Hamming table; both ``_stats`` bodies of the Hamming filter against
   their plain versions and timed beside their twins;
9. lm_serve: llama3-8b at full width and depth (8,030,261,248
   parameters, bf16, weights from ``transformer_init(0, cfg)``): 4 x 4096
   tokens through ``transformer_prefill`` (warmed, then timed; 32
   ``flash_attention`` launches), then the first 1024 tokens of each
   request fed one by one through ``transformer_decode_step`` into a
   1088-slot cache and 64 greedy tokens (median step time; 32 launches a
   step); decode against ``transformer_prefill`` at the last prompt
   position and against ``transformer_forward`` at 16 prompt positions,
   within ``LM_REL_L2`` / ``LM_MAX_ABS``; greedy tokens that forward
   would pick otherwise are counted; the decode mapping held to the
   plain version on the filled cache's own prefix views (layers 0 and
   31, 1 to 1088 keys, as ``_gqa_decode_layer`` passes them); decode
   steps with the attention operator paired with steps through its raw
   launch function (``decode_operator_cost``); the weights are freed.  Then ``flash_attention`` against its plain
   version in bf16 at the prefill row (B 4, Hq 32, Hkv 8, S 4096, D 128,
   causal), the decode row (B 16, Sq 1, Sk 32768) and the decode path's
   own shape (B 4, Sk 1088), timed beside the plain version and
   ``scaled_dot_product_attention`` (the decode rows also queued behind
   a sleep: the kernels' own time), and at a windowed case (window
   1024, S 2048) for correctness only.  Every such
   comparison holds the kernel within one bf16 step of the plain
   value (``FLASH_TOL``);
10. recsys: bst at full width (a 5,000,000 x 32 fp32 item table, weights
   from ``bst_init(0, cfg)``, batches from ``ctr_batch`` with the target
   the first field's id): ``serve_p99`` (batch 512,
   ``sigmoid(bst_forward)``, median request ms, ids from the host and
   probabilities back to it), ``serve_bulk`` (batch 262,144, median ms
   and rows/s), a bulk ``bst_user_embedding`` of those 262,144 users and
   ``retrieval_cand`` (one user's ``bst_user_embedding`` against
   1,000,000 x 32 seeded fp32 candidates), with the launch counts set to
   0 before and read after (``embedding_bag``: one launch a
   ``bst_user_embedding`` call); then DeepFM, AutoInt and DIEN at full
   width at ``serve_p99``, each model's tables freed before the next.
   Every model's logits (the first 512 rows; bst's first 4,096 of
   ``serve_bulk`` and the retrieval scores too) are held to the same
   module copied to the host and run on the CPU (``RECSYS_TOL``).  The
   ``embedding_bag`` rows, against the plain version and timed beside it
   and ``F.embedding_bag``: bst's user tower at the ``serve_bulk`` batch
   (``mean``), ``benchmarks/kernel_bench.py:67``'s 8,192 bags of 32 from
   a 1M x 64 fp32 table (``sum``, ~10% padding) and a bf16 table (other
   negative ids, ids past V) for correctness only (``EB_TOL``), as are
   the kernel's edge cases ``EB_EDGES`` (D 1 to 256, bf16 with odd D, L
   1 to 64, ragged B, a table view off a 16-byte boundary, all-padding
   bags, ids past V; both combiners) with ptxas's registers and spill
   bytes.  Their
   byte bound reads each distinct row once; the kernel's and the
   library's device times are taken queued behind a sleep too;
11. baselines: the paper's KNN-BLOCK (6 projections, window 0.3 n / 2),
   BLOCK-DBSCAN (rnt 10) and rho-approximate DBSCAN (rho 1, the cell and
   the direct engine) on the test split at eps 0.55, tau 5, each warmed
   up once, then timed with the launch and host-sync counts set to 0 just
   before and read just after (each must launch the kernels of its path,
   ``BASELINE_KERNELS``), with ARI and AMI against phase 4's exact
   DBSCAN; each on the card against the same call on the CPU on the
   first 3,000 rows (identical; or each differing core flag and cluster
   traced to a kernel hit that differs, named with its margin, every
   margin within ``FLIP_MARGIN``); the
   ``evaluation`` line: every method of the paper's Fig. 1 and Table 3
   (phase 5's four, the main path, the baselines) with its time, speedup
   over DBSCAN, ARI, AMI and queries, and Table 4's rho-approx / DBSCAN
   time.  ``row_popcount`` (pass 2's row counts: one launch a clustering
   in ``fixpoint_inputs``, counted on the main path) is held exactly to
   its plain version on the main slab (phase 7) and on one KNN-BLOCK band
   slice with each row's window as its bit range (16-byte loads: the
   band is whole 128-column pieces), timed back to back and queued, bound
   by one read of the words (on the band, the words the windows touch);
12. stream: streaming LAF-DBSCAN (``repro_torch.stream``) on the same
   split, each part with the counts set to 0 just before it and read just
   after.  The exact stream: the 30,437 test rows through
   ``StreamingLAF(backend="exact")`` in ``StreamConfig.batch_rows``
   (4,096-row) batches, estimator off, held label for label (and core
   for core) to phase 4's exact DBSCAN.  The RP stream, the path users
   run: ``StreamingLAF`` warm-started from a ``RandomProjectionBackend``
   (512 bits, margin 3) fitted on the 121,748 train rows, then the test
   split in the same batches; ARI >= 0.99 against a batch run over all
   152,185 rows (train then test) on the same backend config, which is
   ``laf_dbscan`` with every point executed (the device pass; the host
   star unions of ``dbscan_parallel`` are not run at that size).  Each
   batch line: elapsed_s, rows/s, executed, promoted,
   ``stream.ingest.host_syncs`` and ``packed_connectivity``'s launches
   and rounds (the RP stream's last batch under the profiler: device
   busy, idle share, top kernels); the host reads are held to one a
   sweep block, a promotion block and a connectivity block (the
   reference: a promotion block twice).  Serve: 1,024 database rows perturbed by seeded noise of
   0.01/sqrt(d) and renormalized, through the RP stream's
   ``ClusterIndex`` on the engine (K1) and on its host oracle loop:
   labels, confidence and hits identical; single-query latency (p50,
   p99 over 200 calls) and the 1,024-query call.  Durable:
   ``DurableStream`` over the exact stream's batches (fsync on, a
   snapshot every 3 batches) dropped after batch 5 without ``close``,
   then ``DurableStream.recover``: labels, counts, core and owner equal
   the uninterrupted stream's after batch 5 and after the rest;
   snapshot seconds, recovery seconds, WAL replay rows/s.  Evict: 5% of
   the exact stream's rows (seeded, a core among them): one rebuild
   (``stream.rebuilds``), and the live rows' labels equal exact DBSCAN
   of those rows.  ``stream.degraded.events`` stays 0 throughout (the
   port has no degrade policy: a device fault raises and fails the
   phase).  The
   ``packed_connectivity`` row: one RP block slab (4,096 rows x the
   stream's 4,756 words) through the connectivity mode's cooperative
   launch, held exactly to ``packed_connectivity_ref`` (comp, owner,
   row_first, rounds; round 0 yields the owner and row_first, so the
   block is that one launch), with its queued device time, rounds, ptxas
   registers and spills, its grid (blocks, blocks an SM, the work
   items' row chunks), the split of its probe build (each round's K2
   walk, K3 walk and update, and how long blocks wait at each grid
   barrier: ``connectivity_split``) and its byte bound: rounds x (K2 +
   K3 + the update), the section 6 formulas, + the owner's row indices
   read and its column minimum written once (and, beside it, the same
   over the core rows that K3 and the later rounds' K2 need);
13. lm_zoo: the rest of the LM zoo in bf16, weights drawn on the card by
   ``transformer_init(0, cfg)``, one model at a time (each freed before
   the next loads): gemma3-27b (window 1024, 5:1 local:global) and
   granite-20b (52 layers, MQA) at full width and depth; grok-1-314b (8 experts, top-2) at full width with its depth
   cut to 4 of 64 layers (39.7 GiB) and deepseek-v2-236b (MLA, 160
   experts top-6 and 2 shared) at full width cut to 5 of 60 layers (1
   dense prefix + 4 MoE, 32.2 GiB), the weights that fit one card.
   Each: ``transformer_prefill`` of 2 x 4096 tokens of ``token_stream``
   (cut from ``prefill_32k``'s 32 x 32768; warmed, then timed; MoE at the
   published capacity 1.25 with each layer's ``drop_fraction``); a
   prompt fed a token a step and 32 greedy tokens at B 2 (cut from
   ``decode_32k``'s 128 x 32768): gemma3 1,152 tokens into 1,024-slot
   rings, the first ``ZOO_RING_FILL`` (1,008) through
   ``transformer_prefill_windowed`` and the rest a step each through
   ``transformer_decode_step_windowed`` (the rings wrap at 1,024), the
   others 256 through ``transformer_decode_step``; MoE models
   decode and are checked at the no-drop capacity ``n_experts / top_k``
   (a dropped entry makes forward differ from decode); decode against
   prefill at the last prompt position and against forward at 16
   positions (gemma3's include 1,023, 1,024 and 1,151) within
   ``LM_REL_L2`` / ``LM_MAX_ABS``; the launches of each path
   (``flash_attention``: one a GQA layer, 62 a gemma3 step, none in
   MLA's absorbed decode); the decode mapping on the filled caches (a
   ring's valid slots unmasked, a global prefix causal) against
   ``attention_ref`` (``FLASH_TOL``); a profiled decode step; MoE: one
   layer's output at 1,024 tokens against the same layer with fp32
   expert GEMMs, and its routes against an fp64 router.  Then the rows
   ``flash_attention_d192`` (deepseek-v2's prefill, B 2, H 128, S 4096,
   the (192, 128) pair with v at its own 128, as phase 13's prefill
   runs it; the faster of SDPA with v at 128 and padded to 192; the
   two-term floor beside the bound; ptxas's registers and spills of each
   192 instantiation), ``flash_attention_decode_ring`` (gemma3's full
   ring: B 2, Hq 32, Hkv 16, 1,024 slots, unmasked) and
   ``flash_attention_decode_mqa`` (granite's filled cache: Hq 48, Hkv 1,
   288 keys), each against the plain version, timed back to back and
   queued beside ``scaled_dot_product_attention`` with its bound;
14. train: the training half.  B11 (``flash_attention_bwd``, the
   gradient of attention) against ``attention_bwd_ref`` on the card at
   every instantiated width (16, 32, 64, 128, 192) and MLA's (192, 128)
   pair, fp32 and bf16, causal, windowed and unmasked, Hq / Hkv 1, 4 and
   8, ragged S, a query offset (``BWD_CASES``; the forward's log-sum-exp
   within ``LSE_TOL``, the gradients within ``BWD_TOL``, the autograd
   path too), the decode mapping (Sq = 1) raising; its rows at the
   forward row's shape (B 4, Hq 32, Hkv 8, S 4096, D 128, causal, bf16)
   and at deepseek-v2's training shape (``flash_attention_bwd_mla``: B
   2, Hq = Hkv = 128, S 4096, the (192, 128) pair): back to back and
   queued, a second call's dK and dV bit for bit and dQ's gap, the plain
   version, SDPA's backward at the same widths as the library, the bound
   (the five products on bf16 tensor cores) and the two-term floor,
   ptxas; and the ``flash_attention_lse`` row (that forward with the
   log-sum-exp written, beside it not written).  llama3-8b at full
   width, 2 layers, 1 x 1,024 tokens, bf16: every parameter's gradient
   through the kernels against the same loss through ``attention_ref``
   with autograd (``GRAD_REL_L2``; ``model_grads``).  llama3-8b
   training at full width, 2 of 32 layers (``TRAIN_LM_LAYERS``: bf16
   weights and grads, fp32 AdamW state; 8 layers' 27.96 GB checkpoint
   took a minute each way), B 8 x 4,096 (``train_4k``'s sequence; batch
   cut from 256), ``lm_batches(0, 8, 4096, 128256)``'s batch 0 repeated, remat,
   ``ce_chunk`` 512, ``adamw(lr=3e-4)`` behind a 100-step linear warmup
   (``TRAIN_LM_WARMUP``), through ``train_loop`` with a checkpoint
   directory: 3 steps (the first a warm-up), saved, one more step of the
   live state under the profiler (its device time by class: B11, the
   attention forward, the GEMMs, the rest; the AdamW window between
   CUDA events); then everything dropped, a model from another seed
   resumed from the checkpoint (its parameters and optimizer state
   fingerprinted against the saved ones: bit for bit) and stepped once
   (its loss against the uninterrupted run's, ``RESUME_TOL``); the loss
   must fall; the launches of a step: ``flash_attention`` 4 (forward
   and remat recompute), ``flash_attention_bwd`` 2.  The zoo's training
   (``ZOO_TRAIN``), each at full width with its depth cut from its
   training state: deepseek-v2 (2 of 60 layers: the dense prefix + 1
   MoE, MLA at (192, 128)), grok-1 (1 of 64) and gemma3-27b (6 of 62: 5
   local + the first global), B 2 x 4,096, bf16, remat, one microbatch,
   the full model's optimizer policy (bf16 AdamW state and ``ce_chunk``
   256 above 1e11 parameters, else fp32 and 512) behind the same
   warmup: first the gradient check on the drawn weights at 1 x 2,048
   tokens (MoE at the no-drop capacity, the positions whose experts flip
   between the two passes counted and left out of both losses, at least
   90% kept), then a warm-up step and three timed steps (the last
   profiled) on one repeated batch: the loss finite and falling, the
   launches of each step (2 ``flash_attention`` and 1
   ``flash_attention_bwd`` a layer), tokens/s, peak memory, MoE drop
   fractions at the published capacity.  The recsys
   rankers' ``train_batch`` at full width (bst, DeepFM, AutoInt, DIEN;
   65,536 rows of ``ctr_batches``, DIEN's halved until its GRU steps
   fit), and GAT's ``full_graph_sm`` (Cora's sizes), ``minibatch_lg``
   (1,024 seeds, fanout 15-10, from a ``powerlaw_graph`` at Reddit's
   232,965 nodes and 114,615,892 edges, CSR and sampler on the host) and
   ``molecule`` (128 graphs): each one step on a small batch held to a
   CPU copy (``TRAIN_STEP_TOL``: every gradient, relative L2 per leaf,
   then the loss and the updated parameters), then a warm-up and three timed steps
   (rows/s, edges/s).  ``ogb_products`` is not trained on one card: its
   cell (``build_gnn_train``, the edges split over a mesh) is traced in
   phase 16's dry run;
15. plane: the sharded index plane (``repro_torch.distributed``) on the
   whole MS-150k set (152,185 x 768) at eps 0.55, tau 5, alpha 1.5, with
   phase 3's estimator's predictions computed once and handed to every
   rank.  The reference is the port's single-device ``laf_dbscan`` on
   the card (warmed, then timed).  Then world 1 over NCCL in this
   process (``init_device_mesh("cuda", (1,))``), world 2 over gloo as two
   spawned ranks sharing this card (``testing.ranks``; the kernels were
   built in phase 2, so no rank builds), and, with two or more cards,
   world min(cards, 4) over NCCL a rank a card.  Each rank clusters
   through ``RandomProjectionBackend(mesh=)`` with device telemetry on,
   then timed with it off (counts set to 0 just before each and read
   just after), then sweeps its slab words and runs the sharded
   fixpoint on them.  Each must hold: labels, core mask,
   ``n_range_queries`` and rounds equal to the single-device run's; its
   slab words byte-equal (sha256) to its block of the single-device
   slab; one ``laf.cluster.host_syncs`` a clustering; the fixpoint's
   outputs and per-round frontier, changed and hops equal to
   ``packed_cluster_labels`` on the single-device slab (shard wins equal
   to the frontier on one rank, at least it on several); the plane
   sweep's occupancy triples, summed over the ranks, equal to a
   single-device count sweep's against the database padded as the plane
   pads it; launches: one ``label_prop_fixpoint`` on one rank, 64
   ``label_prop_rect`` and 64 ``label_prop_update`` (every round
   enqueued) on several, ``hamming_filter_bitmap_stats`` with telemetry
   on.  One line a world: seconds against the single-device run's,
   rounds, launches, the ``plane.*`` counters and peak memory of each
   rank, the fixpoint's time at 64 rounds and at the active rounds only
   (the idle rounds' cost), whether the collectives stage CUDA tensors
   through the host (gloo).  The rows ``label_prop_rect_plane``,
   ``label_prop_update_plane`` and ``hamming_filter_bitmap_stats_plane``
   hold those kernels to their plain versions at the shapes world 2's
   first rank gives them.  No fallback: a failed collective, kernel or
   build on any rank fails the phase.
16. tooling (``tooling_phase``): the launch lowerings, the dry run and
   laf-lint on the card.  ``build_laf_cluster`` and
   ``build_one_launch_cluster`` at ``ms_150k`` (phase 3's data and
   estimator, the random-projection index, world 1 over NCCL) run on the
   card with the launch counts set to 0 just before and read just after:
   the frontier round (4,096 rows, 16 Hamming launches, 3 ``rmi_mlp``)
   on its first 32 rows equals the same cell run on CPU copies through
   the plain versions (the pairs within 2 (d-1) 2^-24 of 1 - eps that
   flip and the signature bits that flip counted, every count difference
   inside them; predictions within ``TOL_RMI``), and the one-launch cell
   on the frontier's Hamming slab equals ``packed_cluster_labels`` on the
   same slab, exactly.  The same two cells traced on fake tensors
   (``launch.trace_analysis``) launch each operator as often as the
   card's counters say; the line prints the trace's peak live bytes
   beside the card's (``max_memory_allocated`` over the call plus the
   arguments) and their ratio.  Then ``python -m repro_torch.analysis
   --corpus tests/analysis_corpus_torch`` runs in this process on the
   card (the static checks, LAF104 on two gloo ranks, LAF103's
   sync-debug probe and LAF105 and LAF108 on CUDA), no library is built
   after phase 2 (``kernels._build.BUILDS``), the operators' dispatch
   cost is timed against their raw launch functions.  The model cells
   (A12b, ``launch.steps.build_cell``, world 1 over NCCL, the launch
   counts set to 0 just before each and read just after): llama3-8b's
   ``train_4k`` cell at full width, 2 of 32 layers, B 2 x 2,048, bf16,
   against the single-device ``lm_train_step`` from the same weights
   (``CELL_TOL``), then the same cell traced on ``meta`` tensors: its
   ``flash_attention`` and ``flash_attention_bwd`` launches equal the
   card's, and the trace's peak live bytes are printed beside the card's
   (the arguments plus ``max_memory_allocated`` over the step) with their
   ratio; bst's ``retrieval_cand`` cell at full width (10^6 candidates)
   against the single-device user tower and ``retrieval_scores``, its
   ``embedding_bag`` launch equal to the trace's; gat-cora's
   ``full_graph_sm`` cell against ``gnn_train_step``; the new
   operators' dispatch cost against their raw launch functions (and
   beside a form of the attention launch that mutates its log-sum-exp
   buffer).  Then
   the dry run (``python -m repro_torch.launch.dryrun``): every cluster
   record on 256 and 512 fake ranks (16, every one ``ok``) and the model
   cells of ``CELL_DRYRUN`` on 256 (``CELL_DRYRUN_LEFT`` is left to the
   CPU run, which writes all of them), under ``artifacts/dryrun_torch``
   with the roofline tables printed.  No fallback.
17. sharded_lm (``sharded_lm_phase``): the LM steps sharded over the
   ranks of a ``("data", "model")`` mesh (``launch.steps`` with
   ``mesh=``: DTensor parameters, optimizer state, activations and KV
   cache), bf16, weights from ``transformer_init(0, cfg)``: llama3-8b at
   full width, 2 of 32 layers, and deepseek-v2 at full width, 2 of 60
   layers (the dense prefix + one MoE layer of 160 experts: expert
   parallel at model 2).  First the single-device oracles on this card,
   each freed before the next and before the ranks start: a train step
   (``lm_loss_and_grads`` at batch 0 of ``lm_batches(0, B, 2048, V)``,
   then one timed ``lm_train_step``, the full model's optimizer policy,
   one microbatch) and llama3-8b's serving (a prefill of the train
   batch, warmed then timed; a 16-token prompt fed a token a step, then
   8 greedy steps).  Then two gloo ranks sharing this card at mesh (1, 2)
   (llama3-8b's train step, prefill and decode; deepseek-v2's train
   step, B 1 x 2,048), two at (2, 1) (llama3-8b's train step, B 2 x
   2,048), each rank with DTensor's all-gathers staged through
   ``distributed.sharding.staged_collective`` (the functional all-gather
   kills a gloo process on CUDA tensors), and llama3-8b's train step at
   world 1 over NCCL in this process.  Each run is held to its oracle
   (``SHARDED_TOL``): loss and grad norm, each gradient leaf of the first
   stacked layer (relative L2, each rank's shard against the host copy,
   one all-reduce), the prefill and decode logits, MoE route flips
   counted (at least 90% kept), ``flash_attention`` 4 and
   ``flash_attention_bwd`` 2 launches a step on every rank, every rank
   on the card.  Each line: step seconds at each mesh beside the
   single-device step's, the first (untimed) step's, peak memory a
   rank, launches a rank, the collectives of a forward and backward by
   kind (``CommDebugMode``), the staging function's calls.  No fallback.
18. examples (``examples_phase``): the paths of the port's example
   twins.  First the D 64 rows (``d64_rows``): ``flash_attention`` at
   head width 64, its prefill with the log-sum-exp and its decode
   mapping, and ``flash_attention_bwd``, in fp32 and bf16, at
   train_lm's shape (B 8, Hq 10, Hkv 2, S 256) and at (B 4, Hq 10, Hkv
   2, S 4096), causal, each held to its plain version, timed back to
   back and queued beside the same call zero-padded to D 128 (the path
   before D 64 was instantiated), SDPA (its backward: forward +
   ``backward()`` less its forward) and the bound, with ptxas's
   registers and spills of every ``<64>`` instantiation.  Then
   ``train_lm_64``: ``examples/train_lm_torch.py``'s ~100M model
   (d_model 640, 12 layers, 10 query heads over 2, d_head 64, fp32,
   remat) at its batch (8 x 256) and optimizer: one step held to a CPU
   copy (``TRAIN_STEP_TOL``), then ``train_loop`` for 4 steps with a
   checkpoint, one more step, dropped, resumed into other weights from
   the checkpoint (bit for bit) and stepped once (``RESUME_TOL``); 24
   ``flash_attention`` and 12 ``flash_attention_bwd`` launches a step.
   Then ``recsys_serving``: ``examples/recsys_serving_torch.py``'s
   ``serve`` at bst's full width (a 5M-row table), 150,000 catalogue
   items in 120 genres ingested by the RP stream in 4,096-row batches
   (eps 0.12, tau 5), 1,024 users (one ``embedding_bag`` launch), the
   full and the cluster-pruned scans, recall@10, the scored share,
   ``assign`` in bulk and 200 single-user calls (p50, p99), the launch
   counts set to 0 just before and read just after; then the example's
   own sizes (20,000 items, batches of 4,000, 4 users) on the card held
   to the same flow on the CPU, which a spawned process (4 threads)
   runs from the start of phase 14 on (``start_recsys_twin``): labels
   equal up to relabelling (else ARI >= 0.99, the pairs within
   ``FLIP_MARGIN`` of the threshold counted), shortlists, top-10 lists
   (ties within ``RS_TIE``), recall and ``assign`` equal, the user
   embeddings within ``RECSYS_TOL``.  No fallback.

Metrics are off by default (as in the reference); the script turns them
on before it drives a path, since the launch counts are counters.
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
is left at PyTorch's default (on) for the model's bf16 GEMMs.

Every phase line carries its ``seconds``.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the port's sources beside this file, it exits
nonzero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import logging
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM memory rate (NVIDIA data sheet)
FP32_FLOPS = 67e12          # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12         # H100 SXM bf16 tensor cores, dense
TF32_FLOPS = 494.7e12       # H100 SXM tf32 tensor cores, dense
INT8_OPS = 1979e12          # H100 SXM int8 tensor cores, dense
SMS, POPC_PER_CLOCK = 132, 16  # H100 SXM: SMs, 32-bit POPC results an SM and clock (CUDA cores)
KERNELS = {
    "hamming_filter": ("src/repro_torch/csrc/hamming_filter.cu",
                       "src/repro/kernels/hamming_filter/kernel.py:179"),
    "label_prop_rect": ("src/repro_torch/csrc/label_prop.cu",
                        "src/repro/kernels/label_prop/kernel.py:104"),
    "col_reduce": ("src/repro_torch/csrc/label_prop.cu",
                   "src/repro/kernels/label_prop/kernel.py:173"),
    "label_prop_update": ("src/repro_torch/csrc/label_prop.cu",
                          "src/repro/kernels/label_prop/ops.py:211 (jnp inside the fixpoint; no Pallas kernel)"),
    "label_prop_fixpoint": ("src/repro_torch/csrc/label_prop.cu",
                            "src/repro/kernels/label_prop/ops.py:228 (the lax.while_loop of packed_cluster_fixpoint "
                            ":123: label_prop_rect_pallas kernel.py:104 + the jnp update :211-214)"),
    "label_prop_fixpoint_square": ("src/repro_torch/csrc/label_prop.cu",
                                   "src/repro/kernels/label_prop/ops.py:114 (the lax.while_loop of "
                                   "label_propagation_pallas :84: label_prop_round_pallas kernel.py:68 + :109-111)"),
    "range_count": ("src/repro_torch/csrc/range_count.cu",
                    "src/repro/kernels/range_count/kernel.py:75 (_count_kernel :29)"),
    "range_count_bitmap": ("src/repro_torch/csrc/range_count.cu",
                           "src/repro/kernels/range_count/kernel.py:75 (_count_bitmap_kernel :49)"),
    "hamming_filter_count_stats": ("src/repro_torch/csrc/hamming_filter.cu",
                                   "src/repro/kernels/hamming_filter/kernel.py:131 (_filter_count_stats_kernel)"),
    "hamming_filter_bitmap_stats": ("src/repro_torch/csrc/hamming_filter.cu",
                                    "src/repro/kernels/hamming_filter/kernel.py:150 (_filter_count_bitmap_stats_kernel)"),
    "rmi_mlp": ("src/repro_torch/csrc/rmi_mlp.cu",
                "src/repro/kernels/rmi_mlp/kernel.py:48 (rmi_mlp_pallas -> :69, _mlp_kernel :26)"),
    "label_prop_round": ("src/repro_torch/csrc/label_prop.cu",
                         "src/repro/kernels/label_prop/kernel.py:68 (label_prop_round_pallas -> :91, "
                         "_label_prop_kernel :41)"),
    "label_prop_update_square": ("src/repro_torch/csrc/label_prop.cu",
                                 "src/repro/kernels/label_prop/ops.py:109-111 (jnp inside "
                                 "label_propagation_pallas's loop; no Pallas kernel)"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:90 (flash_attention_pallas -> :110, "
                        "_make_kernel :30)"),
    "flash_attention_decode": ("src/repro_torch/csrc/flash_attention.cu",
                               "src/repro/kernels/flash_attention/kernel.py:90 (flash_attention_pallas -> :110, "
                               "_make_kernel :30; the Sq = 1 mapping)"),
    "flash_attention_decode_path": ("src/repro_torch/csrc/flash_attention.cu",
                                    "src/repro/kernels/flash_attention/kernel.py:90 (flash_attention_pallas -> :110, "
                                    "_make_kernel :30; the Sq = 1 mapping at the decode path's shape)"),
    "embedding_bag": ("src/repro_torch/csrc/embedding_bag.cu",
                      "src/repro/kernels/embedding_bag/kernel.py:52 (embedding_bag_pallas -> :68, "
                      "_make_kernel :31)"),
    "embedding_bag_sum": ("src/repro_torch/csrc/embedding_bag.cu",
                          "src/repro/kernels/embedding_bag/kernel.py:52 (embedding_bag_pallas -> :68, "
                          "_make_kernel :31)"),
    "row_popcount": ("src/repro_torch/csrc/popcount.cu",
                     "src/repro/kernels/label_prop/ops.py:174 (no Pallas kernel: jnp.sum(lax.population_count("
                     "bitmap), axis=1) inside packed_cluster_fixpoint's jit)"),
    "packed_connectivity": ("src/repro_torch/csrc/label_prop.cu",
                            "src/repro/kernels/label_prop/ops.py:367 (the lax.while_loop of "
                            "_packed_connectivity_jit :325-380, behind packed_connectivity :383: "
                            "label_prop_rect_pallas kernel.py:104 + col_reduce_pallas kernel.py:173 + the jnp "
                            "update :374-377)"),
    "flash_attention_d192": ("src/repro_torch/csrc/flash_attention.cu",
                             "src/repro/kernels/flash_attention/kernel.py:90 (flash_attention_pallas -> :110, "
                             "_make_kernel :30; the (192, 128) pair: MLA's q/k and v, src/repro/models/mla.py:84-96)"),
    "flash_attention_decode_ring": ("src/repro_torch/csrc/flash_attention.cu",
                                    "src/repro/kernels/flash_attention/kernel.py:90 (the Sq = 1 mapping over a "
                                    "ring buffer's valid slots; the reference's windowed decode attends with a jnp "
                                    "einsum, src/repro/models/transformer.py:441-457)"),
    "flash_attention_decode_mqa": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention/kernel.py:90 (flash_attention_pallas -> :110, "
                                   "_make_kernel :30; the Sq = 1 mapping at Hkv 1)"),
    "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                            "(no Pallas kernel) the gradient of `blockwise_attention`, `src/repro/models/layers.py:94`, "
                            "taken by `jax.value_and_grad` at `src/repro/launch/steps.py:261`"),
    "flash_attention_bwd_mla": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                                "(no Pallas kernel) the gradient of `blockwise_attention`, "
                                "`src/repro/models/layers.py:94`, taken by `jax.value_and_grad` at "
                                "`src/repro/launch/steps.py:261`; at MLA's (192, 128) pair, `src/repro/models/mla.py:94`"),
    "flash_attention_lse": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:90 (flash_attention_pallas -> :110, "
                            "_make_kernel :30; the prefill with the log-sum-exp written: training's forward and "
                            "its remat recompute)"),
    "label_prop_rect_plane": ("src/repro_torch/csrc/label_prop.cu",
                              "src/repro/kernels/label_prop/kernel.py:104 (label_prop_rect_pallas -> :130; each "
                              "round of the sharded fixpoint, src/repro/kernels/label_prop/ops.py:200-203)"),
    "label_prop_update_plane": ("src/repro_torch/csrc/label_prop.cu",
                                "src/repro/kernels/label_prop/ops.py:211-214 (jnp: the sharded fixpoint's "
                                "scatter-min + pointer jump after the round's pmin; no Pallas kernel)"),
    "hamming_filter_bitmap_stats_plane": ("src/repro_torch/csrc/hamming_filter.cu",
                                          "src/repro/kernels/hamming_filter/kernel.py:150 "
                                          "(_filter_count_bitmap_stats_kernel -> :253; the sharded sweep's "
                                          "telemetry, src/repro/distributed/index_plane.py:419-427)"),
    "flash_attention<64>": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:90 (flash_attention_pallas -> :110, "
                            "_make_kernel :30; at head width 64: the LM examples' model, examples/train_lm.py:30,35)"),
    "flash_attention_bwd<64>": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                                "(no Pallas kernel) the gradient of `blockwise_attention`, "
                                "`src/repro/models/layers.py:94`, taken by `jax.value_and_grad`; at head width 64: "
                                "the LM examples' training, examples/train_lm.py:45-48"),
    "row_popcount_band": ("src/repro_torch/csrc/popcount.cu",
                          "src/repro/kernels/label_prop/ops.py:174 (no Pallas kernel; here with a bit range a "
                          "row: KNN-BLOCK's windows, src/repro/core/baselines.py:76-83)"),
}
RP_KERNELS = ("rmi_mlp", "hamming_filter", "label_prop_fixpoint", "col_reduce", "row_popcount")
# pass 2's fixpoint is one label_prop_fixpoint launch; its round steps,
# launched one a round before, are not launched on the path; its row
# counts are one row_popcount launch (fixpoint_inputs)
FIXPOINT_LAUNCHES = {"label_prop_fixpoint": 1, "label_prop_rect": 0, "label_prop_update": 0, "row_popcount": 1}
RMI_LAUNCHES_PER_PREDICT = 3  # one launch a stage (1, 2, 4 experts)
TOL_RMI = 2e-5
EXACT_KERNELS = ("range_count", "range_count_bitmap")
# the observability path: every kernel of the main path, plus the count
# stats body behind band()'s occupancy measurement; the bitmap stats body
# is reached only by the sharded plane's telemetry sweep (phase 15)
OBS_KERNELS = RP_KERNELS + ("hamming_filter_count_stats",)
STATS_KERNELS = ("hamming_filter_count_stats", "hamming_filter_bitmap_stats")
# decode == prefill / forward at full width in bf16, compared in fp32:
# relative L2 error of the logits and their largest absolute difference
LM_REL_L2 = 0.05
LM_MAX_ABS = 1.0
LM_PREFILL = (4, 4096)          # requests x tokens through transformer_prefill
LM_PROMPT, LM_NEW = 1024, 64    # decode: prompt tokens fed one by one, then greedy tokens
FLASH_TOL = "|kernel - plain| <= 2^-7 |plain| + 1e-5, bf16 out (one bf16 step of the value)"
RECSYS_P99, RECSYS_BULK = 512, 262144     # the registry's serve_p99 / serve_bulk batches
N_CANDIDATES = 1_000_000                  # retrieval_cand
BULK_CHECK_ROWS = 4096                    # serve_bulk rows held to the CPU
RECSYS_TOL = "|card - cpu| <= 1e-5 (1 + |cpu|), fp32 logits and scores, TF32 off on both"
EB_TOL = "|kernel - plain| <= 2 L 2^-24 sum_l |row| + 2^-23 |plain| (two fp32 summation orders)"
# phase 11: each baseline and the kernels its path launches (KNN-BLOCK's
# windowed mode counts only within windows: no count-only launch)
BASELINE_KERNELS = {
    "KNN-BLOCK": ("range_count_bitmap", "row_popcount"),
    "BLOCK-DBSCAN": ("range_count", "range_count_bitmap"),
    "rho-approx (cell)": ("range_count", "range_count_bitmap"),
    "rho-approx (direct)": ("range_count", "range_count_bitmap"),
}
BASELINE_PARITY_ROWS = 3000
# phase 12: the stream's batches (StreamConfig.batch_rows), the kernels
# its RP path launches, the serve and evict sizes
STREAM_BATCH = 4096
STREAM_RP_KERNELS = ("hamming_filter", "row_popcount", "col_reduce", "packed_connectivity")
SERVE_QUERIES, SERVE_SINGLE_CALLS, EVICT_FRAC = 1024, 200, 0.05
FLIP_MARGIN = 1e-5  # |dot - threshold| of a pair whose hit differs between the card and the CPU


LINES = ROOT / "chiprun_out" / "chip_smoke.jsonl"  # every emitted line, kept on disk beside the printed ones


def emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    LINES.parent.mkdir(exist_ok=True)
    with open(LINES, "a") as f:
        f.write(line + "\n")


def fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    return 1


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps: int = 20, sleep_cycles: int = 4_000_000) -> float:
    """Device time of ``fn``'s launches: the stream first sleeps (~2 ms)
    while the host enqueues all ``reps`` calls, so the events time the
    kernels back to back, not the host's cost of issuing them."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(sleep_cycles)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, flops: float = 0.0, peak: float = FP32_FLOPS):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def build_notes(name: str) -> dict:
    """What ptxas said of ``csrc/<name>.cu`` in this run's build (each
    kernel's registers and spill bytes, its C75xx notes: serialized wgmma)
    and the tensor-core opcodes (``*GMMA``) in its SASS, where
    ``cuobjdump`` is on the machine."""
    import re

    from repro_torch.kernels import _build

    log = _build.BUILD_LOG.get(name, "")
    notes = {
        "ptxas_registers": [int(m) for m in re.findall(r"Used (\d+) registers", log)],
        "ptxas_spill_bytes": [int(m) for m in re.findall(r"(\d+) bytes spill stores", log)],
        "ptxas_wgmma_notes": sorted(set(re.findall(r"\((C75\d\d)\)", log))),
    }
    cuobjdump = Path("/usr/local/cuda/bin/cuobjdump")
    if cuobjdump.exists():
        sass = subprocess.run([str(cuobjdump), "-sass", str(_build._target(name))],
                              capture_output=True, text=True).stdout
        ops = re.findall(r"\b([A-Z]*GMMA)\b", sass)
        notes["sass_gmma"] = {op: ops.count(op) for op in sorted(set(ops))}
    else:
        notes["sass_gmma"] = None
    return notes


def ptxas_entries(name: str, kernel: str) -> dict:
    """Registers and spill-store bytes that ptxas reported in this run's
    build of ``csrc/<name>.cu`` for each instantiation of ``kernel``,
    keyed ``kernel<args>`` by its template arguments: bools as 0/1,
    integers, ``float`` and ``bf16`` (its ``uint16_t`` bits or
    ``__nv_bfloat16``)."""
    import re

    from repro_torch.kernels import _build

    out = {}
    for chunk in _build.BUILD_LOG.get(name, "").split("Compiling entry function '")[1:]:
        entry = chunk.split("'", 1)[0]
        m = re.search(rf"\d{kernel}(?:I((?:[a-z]|L[a-z]\d+E|13__nv_bfloat16)+)E)?", entry)
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores", chunk)
        if m and regs:
            args = re.findall(r"L[a-z](\d+)E|(13__nv_bfloat16|[a-z])", m.group(1) or "")
            flags = ",".join(num or {"f": "float", "t": "bf16", "13__nv_bfloat16": "bf16"}.get(ch, ch)
                             for num, ch in args)
            out[f"{kernel}<{flags}>" if flags else kernel] = {
                "registers": int(regs.group(1)), "spill_bytes": int(spill.group(1)) if spill else None}
    return out


def slab_stats(bitmap) -> dict:
    """What sets a packed slab's per-bit work: its set bits, the share
    of its words that are nonzero, the bits of a nonzero word, and the
    set bits of a row at the median, the 90th percentile and the most."""
    import torch

    from repro_torch.index.signatures import popcount32

    pc = popcount32(bitmap)
    rows = pc.sum(dim=1, dtype=torch.int32).float()
    set_bits = int(pc.sum(dtype=torch.int64))
    nonzero = int((pc > 0).sum(dtype=torch.int64))
    return {"set_bits": set_bits, "nonzero_word_share": nonzero / max(1, pc.numel()),
            "bits_per_nonzero_word": set_bits / max(1, nonzero),
            "row_bits_p50_p90_max": [float(rows.quantile(0.5)), float(rows.quantile(0.9)), float(rows.max())]}


def popc_ms(nq: int, nd: int, w: int, clock_hz: float) -> float:
    """The CUDA cores' floor for the Hamming distances as 32-bit POPCs:
    nq nd w of them at 16 an SM and clock on 132 SMs."""
    return 1e3 * nq * nd * w / (SMS * POPC_PER_CLOCK * clock_hz)


def device_busy(fn, top: int = 8):
    """(wall s, device busy s, device busy union s, top kernels) of one
    call under ``torch.profiler``: the summed durations of the trace's
    device events, every kernel and copy the call ran, the length of the
    union of their intervals (equal when no two overlap), and the ``top``
    device kernels by summed time, [name, ms, count] each.  The
    profiler's own cost lengthens the wall time, so the idle share it
    gives is an upper bound.  Busy is None when the trace holds no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by = {}
    for e in events:
        ms, n = by.get(e.name, (0.0, 0))
        by[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3, n + 1)
    kernels = [[name[:80], ms, n] for name, (ms, n) in sorted(by.items(), key=lambda kv: -kv[1][0])[:top]]
    ranges = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy_us = sum(b - a for a, b in ranges)
    union_us, end = 0, None
    for a, b in ranges:
        if end is None or a > end:
            union_us, end = union_us + (b - a), b
        elif b > end:
            union_us, end = union_us + (b - end), b
    if busy_us <= 0:
        return wall, None, None, kernels
    return wall, busy_us / 1e6, union_us / 1e6, kernels


def flipped_pairs(kb, pb):
    """(i, j) pairs whose hit bit differs between two packed slabs."""
    import torch

    diff = kb ^ pb
    wi, wj = torch.nonzero(diff, as_tuple=True)
    pairs = []
    for i, c, word in zip(wi.tolist(), wj.tolist(), diff[wi, wj].tolist()):
        word &= 0xFFFFFFFF
        pairs += [(i, 32 * c + b) for b in range(32) if word >> b & 1]
    return pairs


def pair_margin(pairs, q, db, eps) -> float:
    """Largest |dot - (1 - eps)| over ``pairs``, dots in float64."""
    import torch

    if not pairs:
        return 0.0
    pi, pj = (torch.tensor(v, device=q.device) for v in zip(*pairs))
    dots = (q[pi].double() * db[pj].double()).sum(dim=1)
    return float((dots - (1.0 - eps)).abs().max())


def check_hamming(bk, exec_idx, eps, k1_rows, clock_hz):
    """K1 vs its plain version: 4096 executed queries x the whole test db.
    Bound: max(bytes / 3.35 TB/s, 2 nq nd n_bits / 1,979 TOPS), the
    Hamming distances as +-1 int8 products on the tensor cores;
    ``popc_ms`` beside it, the CUDA cores' POPC floor."""
    import torch

    from repro_torch.kernels import cost
    from repro_torch.index.signatures import hamming_words, popcount32
    from repro_torch.kernels.hamming_filter import hamming_filter_bitmap, hamming_filter_count
    from repro_torch.kernels.hamming_filter.ref import hamming_filter_ref

    t_lo, t_hi = bk.band(eps)
    q, qs = bk._gather(exec_idx[:k1_rows])
    db, dbs = bk.data_device, bk._sigs_dev
    nq, d, nd, w = q.shape[0], q.shape[1], db.shape[0], qs.shape[1]
    kc, kb = hamming_filter_bitmap(q, db, qs, dbs, eps, t_hi, t_lo=t_lo)
    pc, pb = hamming_filter_ref(q, db, qs, dbs, eps, t_lo, t_hi)
    # flipped pairs must sit within the fp32 summation-order bound of the
    # threshold: |dot - (1-eps)| <= 2 (d-1) 2^-24 for unit vectors
    tol = 2 * (d - 1) * 2.0 ** -24
    pairs = flipped_pairs(kb, pb)
    margin = pair_margin(pairs, q, db, eps)
    flips_per_row = popcount32(kb).sum(1) - popcount32(pb).sum(1)
    counts_ok = bool(torch.equal(kc - pc, flips_per_row))
    band = 0
    for s in range(0, nd, 1024):
        ham = hamming_words(qs, dbs[s : s + 1024])
        band += int(((ham > t_lo) & (ham <= t_hi)).sum())
    ms = time_ms(lambda: hamming_filter_bitmap(q, db, qs, dbs, eps, t_hi, t_lo=t_lo))
    count_ms = time_ms(lambda: hamming_filter_count(q, db, qs, dbs, eps, t_hi, t_lo=t_lo))
    counts_only_ok = bool(torch.equal(hamming_filter_count(q, db, qs, dbs, eps, t_hi, t_lo=t_lo), kc))
    plain = time_ms(lambda: hamming_filter_ref(q, db, qs, dbs, eps, t_lo, t_hi), reps=2, warmup=1)
    count_plain = time_ms(lambda: hamming_filter_ref(q, db, qs, dbs, eps, t_lo, t_hi, with_bitmap=False),
                          reps=2, warmup=1)
    b_ms, b_by = cost.hamming_filter_cost(nq, nd, d, w, bitmap=True).bound_ms()
    count_b_ms, count_b_by = cost.hamming_filter_cost(nq, nd, d, w, bitmap=False).bound_ms()
    ok = counts_ok and counts_only_ok and margin <= tol
    return ok, {
        "name": "hamming_filter", "shape": [nq, nd, d, w], "max_abs_err": int((kc - pc).abs().max()),
        "bit_flips": len(pairs), "flip_max_margin": margin, "tolerance": tol,
        "band_pairs": band, "popcount_ops": nq * nd * w, "int8_ops": 2 * nq * nd * 32 * w,
        "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by + " (int8 tensor cores)",
        "popc_ms": popc_ms(nq, nd, w, clock_hz),
        "count_only_ms": count_ms, "count_only_plain_ms": count_plain,
        "count_only_bound_ms": count_b_ms, "count_only_bound_by": count_b_by + " (int8 tensor cores)",
        **build_notes("hamming_filter"),
    }


def compare_range_count(q, db, eps):
    """Both bodies of the exact path's kernel vs the plain version on
    ``q`` x ``db``: (ok, the comparison's numbers)."""
    import torch

    from repro_torch.index.signatures import popcount32
    from repro_torch.kernels.range_count import range_count, range_count_bitmap, threshold
    from repro_torch.kernels.range_count.ref import range_count_bitmap_ref

    kc, kb = range_count_bitmap(q, db, eps)
    kc_only = range_count(q, db, eps)
    pc, pb = range_count_bitmap_ref(q, db, threshold(eps))
    tol = 2 * (q.shape[1] - 1) * 2.0 ** -24
    pairs = flipped_pairs(kb, pb)
    margin = pair_margin(pairs, q, db, eps)
    flips_per_row = popcount32(kb).sum(1) - popcount32(pb).sum(1)
    counts_ok = bool(torch.equal(kc - pc, flips_per_row)) and bool(torch.equal(kc_only, kc))
    return counts_ok and margin <= tol, {
        "shape": [q.shape[0], db.shape[0], q.shape[1]], "max_abs_err": int((kc - pc).abs().max()),
        "bit_flips": len(pairs), "flip_max_margin": margin, "tolerance": tol,
        "counts_equal_plain_plus_flips": counts_ok}


def check_range_count(x, rows, eps, sub_rows, sub_cols):
    """The exact path's kernel, both bodies, vs the plain version:
    ``len(rows)`` queries x every row of ``x`` (the timed shape, plus
    the fp32 product alone, ``torch.matmul``, as a yardstick), and
    ``sub_rows`` x ``sub_cols``, the gathered column subset that
    DBSCAN++'s core-core unions launch on."""
    import torch

    from repro_torch import exact_fp32
    from repro_torch.kernels.range_count import range_count, range_count_bitmap, threshold
    from repro_torch.kernels.range_count.ref import range_count_bitmap_ref, range_count_ref

    def gather(idx):
        return x[torch.from_numpy(idx).to(x.device)].contiguous()

    q = gather(rows)
    nq, d, nd = q.shape[0], q.shape[1], x.shape[0]
    n_words = -(-nd // 32)
    thr = threshold(eps)
    ok, common = compare_range_count(q, x, eps)
    sub_ok, subset = compare_range_count(gather(sub_rows), gather(sub_cols), eps)
    exact_fp32()
    common["matmul_ms"] = time_ms(lambda: torch.matmul(q, x.T))
    flops = 2.0 * nq * nd * d
    b_ms, b_by = bound_ms(4 * (nq * d + nd * d + nq), flops)
    count_row = {"name": "range_count", **common,
                 "ms": time_ms(lambda: range_count(q, x, eps)),
                 "plain_ms": time_ms(lambda: range_count_ref(q, x, thr), reps=2, warmup=1),
                 "bound_ms": b_ms, "bound_by": b_by}
    b_ms, b_by = bound_ms(4 * (nq * d + nd * d + nq * (1 + n_words)), flops)
    bitmap_row = {"name": "range_count_bitmap", **common,
                  "ms": time_ms(lambda: range_count_bitmap(q, x, eps)),
                  "plain_ms": time_ms(lambda: range_count_bitmap_ref(q, x, thr), reps=2, warmup=1),
                  "bound_ms": b_ms, "bound_by": b_by, "at_core_subset": subset}
    return ok and sub_ok, [count_row, bitmap_row]


def label_prop_inputs(bk, exec_idx, eps, tau):
    """The main path's packed slab and the fixpoint's inputs on it."""
    import torch

    from repro_torch.kernels.label_prop.ops import fixpoint_inputs
    from repro_torch.kernels.label_prop.ref import BIG

    n = bk.n_points
    slab, plan = bk.query_bitmap_device(exec_idx, eps)
    rows = np.full(plan.nq_padded, n, dtype=np.int64)
    rows[: len(exec_idx)] = exec_idx
    r, w = slab.shape
    rows_t, valid_r, _, core_r, pos, init = fixpoint_inputs(
        slab, torch.from_numpy(rows), tau, n=n, cap=w * 32)
    big_rows = torch.full((r,), BIG, dtype=torch.int32, device=slab.device)
    return {"slab": slab, "rows_t": rows_t, "valid_r": valid_r, "core_r": core_r, "pos": pos,
            "init": init, "big_rows": big_rows, "n": n, "tau": tau}


def pass2_trace(inp):
    """Pass 2 alone (``packed_cluster_labels`` on the main path's slab,
    telemetry off) under the profiler: wall, device busy, its top
    kernels.  Shows what besides the fixpoint fills ``label_prop_s``."""
    import torch

    from repro_torch.kernels.label_prop import packed_cluster_labels

    def run():
        return packed_cluster_labels(inp["slab"], inp["rows_t"], inp["tau"], n=inp["n"], telemetry=False)

    run()
    torch.cuda.synchronize()
    wall, busy, union, top = device_busy(run, top=12)
    return {"phase": "pass2_trace", "wall_s": wall, "device_busy_s": busy, "device_busy_union_s": union,
            "idle_share": None if union is None else 1.0 - union / wall, "top_kernels": top,
            "ms": time_ms(run, reps=5), "device_ms": queued_ms(run, reps=5, sleep_cycles=20_000_000)}


def make_update(inp, m):
    """(round 0's update launch on the main path's slab, its output)."""
    import torch

    from repro_torch.kernels.label_prop import label_prop_update

    flags = torch.tensor([1, 0], dtype=torch.int32, device=m.device)
    u = torch.empty_like(inp["init"])

    def update():  # round 0 reads flags[0] == 1 and only ever sets flags[1]
        label_prop_update(inp["init"], m, inp["pos"], u, flags, 0)

    return update, u


def update_ms(inp):
    """The update kernel's time on the main path's slab: back to back
    (``time_ms``, as its row reports it) and queued behind a sleep (the
    kernels alone)."""
    from repro_torch.kernels.label_prop import label_prop_rect

    update, _ = make_update(inp, label_prop_rect(inp["big_rows"], inp["init"], inp["slab"]))
    return time_ms(update), queued_ms(update)


def fixpoint_row(name, bitmap, init, pos, square):
    """``label_prop_fixpoint`` against ``label_prop_fixpoint_ref`` on the
    card, telemetry off and on: both label buffers, ``m``, the flags and
    the telemetry exactly equal (``max_abs_err`` their largest
    difference); its time (back to back and queued behind a sleep, each
    call after resetting buffer 0 and the flags, whose queued time is
    given apart) and its byte bound over this run's rounds:
    rounds x (K2's bytes + the update's), the section 6 formulas."""
    import torch

    from repro_torch.kernels import cost
    from repro_torch.kernels.label_prop import label_prop_fixpoint
    from repro_torch.kernels.label_prop.ref import label_prop_fixpoint_ref

    r, w = bitmap.shape
    cap, dev, iters = w * 32, bitmap.device, 64
    flags0 = torch.zeros(iters + 1, dtype=torch.int32, device=dev)
    flags0[0] = 1

    def state(telemetry):
        return ((init.clone(), torch.empty_like(init)), torch.empty(r, dtype=torch.int32, device=dev),
                flags0.clone(), torch.zeros((4, iters), dtype=torch.int32, device=dev) if telemetry else None)

    err, rounds, tele_sum = 0, None, None
    for telemetry in (False, True):
        got, want = state(telemetry), state(telemetry)
        label_prop_fixpoint(bitmap, got[0], got[1], pos, got[2], square=square, tele=got[3])
        label_prop_fixpoint_ref(bitmap, want[0], want[1], pos, want[2], square=square, tele=want[3])
        pairs = [(got[0][0], want[0][0]), (got[0][1], want[0][1]), (got[1], want[1]), (got[2], want[2])]
        if telemetry:
            pairs.append((got[3], want[3]))
            tele_sum = got[3].sum(dim=1).tolist()
        err = max([err] + [int((a.long() - b.long()).abs().max()) if a.numel() else 0 for a, b in pairs])
        rounds = int(got[2][:iters].sum())
    (bufs, m, flags, tele) = state(True)

    def reset():
        bufs[0].copy_(init)
        flags.copy_(flags0)

    def run(telemetry=False):
        reset()
        label_prop_fixpoint(bitmap, bufs, m, pos, flags, square=square, tele=tele if telemetry else None)

    def plain():
        b, mm, f, _ = state(False)
        label_prop_fixpoint_ref(bitmap, b, mm, pos, f, square=square)

    b_ms, b_by = cost.label_prop_fixpoint_cost(r, w, rounds).bound_ms()
    return {
        "name": name, "shape": [r, w], "square": square, "rounds": rounds, "telemetry_sums": tele_sum,
        "max_abs_err": err, "tolerance": "exact: labels, m, flags, telemetry",
        "ms": time_ms(run), "device_ms": queued_ms(run), "device_ms_telemetry": queued_ms(lambda: run(True)),
        "reset_device_ms": queued_ms(reset),
        "plain_ms": time_ms(plain, reps=2, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "ptxas": ptxas_entries("label_prop", "label_prop_fixpoint_kernel"),
    }


def check_label_prop(inp, before_components):
    """K2, the update step, K3 and the fixpoint (``fixpoint_row``) vs
    their plain versions on the main path's full slab (exact equality:
    integer results).
    ``before_components`` is ``update_ms`` read before the components
    phase ran.  K2 and K3 also report their time queued behind a sleep
    (``device_ms``: back to back, the host's ~16 us ``ctypes`` enqueue
    is the floor), the slab's ``slab_stats`` and ptxas's registers and
    spill bytes for each of their instantiations."""
    import torch

    from repro_torch.kernels import cost
    from repro_torch.kernels.label_prop import col_reduce, label_prop_rect
    from repro_torch.kernels.label_prop.ref import (
        BIG, col_reduce_ref, label_prop_rect_ref, label_prop_update_ref,
    )

    slab, rows_t, valid_r, core_r = inp["slab"], inp["rows_t"], inp["valid_r"], inp["core_r"]
    pos, init, big_rows = inp["pos"], inp["init"], inp["big_rows"]
    r, w = slab.shape
    cap = w * 32
    vals, weights = torch.where(core_r, rows_t, BIG), valid_r.to(torch.int32)
    stats = slab_stats(slab)
    out = []

    m = label_prop_rect(big_rows, init, slab)
    m_ref = label_prop_rect_ref(big_rows, init, slab)
    m_out = torch.empty_like(m)
    b_ms, b_by = cost.label_prop_rect_cost(r, w).bound_ms()
    out.append({
        "name": "label_prop_rect", "shape": [r, w], **stats,
        "max_abs_err": int((m.long() - m_ref.long()).abs().max()),
        "ms": time_ms(lambda: label_prop_rect(big_rows, init, slab, out=m_out)),
        "device_ms": queued_ms(lambda: label_prop_rect(big_rows, init, slab, out=m_out)),
        "plain_ms": time_ms(lambda: label_prop_rect_ref(big_rows, init, slab), reps=2, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by, "ptxas": ptxas_entries("label_prop", "label_prop_rect_kernel"),
    })

    update, u = make_update(inp, m)
    update()
    u_ref = label_prop_update_ref(init, m, pos)
    b_ms, b_by = cost.label_prop_update_cost(cap, r).bound_ms()
    out.append({
        "name": "label_prop_update", "shape": [cap], "max_abs_err": int((u.long() - u_ref.long()).abs().max()),
        "ms": time_ms(update), "device_ms": queued_ms(update),
        "ms_before_components": before_components[0], "device_ms_before_components": before_components[1],
        "plain_ms": time_ms(lambda: label_prop_update_ref(init, m, pos)),
        "bound_ms": b_ms, "bound_by": b_by,
    })

    cmin, csum = col_reduce(slab, vals, weights)
    rmin, rsum = col_reduce_ref(slab, vals, weights)
    err = max(int((cmin.long() - rmin.long()).abs().max()), int((csum - rsum).abs().max()))
    b_ms, b_by = cost.col_reduce_cost(r, w).bound_ms()
    out.append({
        "name": "col_reduce", "shape": [r, w], **stats, "max_abs_err": err,
        "ms": time_ms(lambda: col_reduce(slab, vals, weights)),
        "device_ms": queued_ms(lambda: col_reduce(slab, vals, weights)),  # with its two output fills
        "plain_ms": time_ms(lambda: col_reduce_ref(slab, vals, weights), reps=2, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by, "ptxas": ptxas_entries("label_prop", "col_reduce_kernel"),
    })
    out.append(fixpoint_row("label_prop_fixpoint", slab, init, pos, square=False))
    return all(k["max_abs_err"] == 0 for k in out), out


def check_rmi_mlp(pipe, test, eps, tau, alpha):
    """The estimator's fused forward at the predict shape: each stage's
    one launch (1, 2 and 4 experts on every test row) against the plain
    version on the card; the rows whose route or core test
    (pred >= alpha * tau) differs between the two are counted, not
    avoided.  Times: one predict's three launches, the plain version's,
    and the fp32 ``F.linear`` chain with TF32 off as the library
    yardstick (five calls an expert, not one call)."""
    import torch
    import torch.nn.functional as F

    from repro_torch import exact_fp32
    from repro_torch.kernels import cost
    from repro_torch.core.cardinality import featurize, rmi_route
    from repro_torch.kernels.rmi_mlp import rmi_stage_forward
    from repro_torch.kernels.rmi_mlp.ops import pack_stage, stage_launch, stage_params, tma_rows
    from repro_torch.kernels.rmi_mlp.ref import stage_forward_ref

    est = pipe.estimator
    stages, cfg = list(est.model.stages), est.cfg
    x = featurize(torch.from_numpy(np.asarray(test, np.float32)).to(est.device), eps)
    n, d_in = x.shape
    packs = [stage_params(experts, x.device) for experts in stages]
    kern = [rmi_stage_forward(experts, x) for experts in stages]
    plain = [stage_forward_ref(x, ws, bs) for ws, bs in packs]
    err = max(float((k - p).abs().max()) for k, p in zip(kern, plain))
    # the reference's own kernel tolerance, rtol = atol = 2e-5: the two
    # sum each layer's products in different orders (and the kernel's
    # are three tf32 products)
    within = all(bool(((k - p).abs() <= TOL_RMI * (1.0 + p.abs())).all()) for k, p in zip(kern, plain))

    def walk(outs):
        pred, routes = outs[0][0], []
        for o in outs[1:]:
            routes.append(rmi_route(pred, o.shape[0], cfg.target_max))
            pred = o.gather(0, routes[-1][None, :])[0]
        return pred, routes

    (zk, rk), (zp, rp) = walk(kern), walk(plain)
    moved = torch.zeros(n, dtype=torch.bool, device=x.device)
    for a, b in zip(rk, rp):
        moved |= a != b
    thr = alpha * tau
    core_k = torch.clamp(torch.exp2(zk) - 1.0, min=0.0) >= thr
    core_p = torch.clamp(torch.exp2(zp) - 1.0, min=0.0) >= thr

    kpacks = [pack_stage(experts, x.device) for experts in stages]  # packed once: the row times the launches
    xk = tma_rows(x)  # x as rmi_predict hands it to the kernel

    def predict():
        for kp in kpacks:
            stage_launch(kp, xk)

    def library():
        with torch.no_grad():
            for experts in stages:
                for m in experts:
                    h = x
                    for layer in m.layers[:-1]:
                        h = torch.relu(F.linear(h, layer.weight, layer.bias))
                    F.linear(h, m.layers[-1].weight, m.layers[-1].bias)

    exact_fp32()
    widths = [w.shape[2] for w in packs[0][0][:-1]]
    predict_cost = cost.rmi_predict_cost(n, d_in, widths, [len(experts) for experts in stages])
    flops = predict_cost.ops
    b_ms, b_by = predict_cost.bound_ms()
    t1 = time_ms(predict, reps=5)
    plain_ms = time_ms(lambda: [stage_forward_ref(x, ws, bs) for ws, bs in packs], reps=5)
    library_ms = time_ms(library, reps=5)
    t2 = time_ms(predict, reps=5)
    row = {
        "name": "rmi_mlp", "shape": [n, d_in, [len(e) for e in stages]], "max_abs_err": err,
        "tolerance": f"|z - plain| <= {TOL_RMI} (1 + |plain|)",
        "z_max_abs": max(float(p.abs().max()) for p in plain), "pred_max_abs_err": float((zk - zp).abs().max()),
        "route_flips": int(moved.sum()), "core_test_flips": int((core_k != core_p).sum()),
        "n_core_predicted": int(core_k.sum()),
        "ms": (t1 + t2) / 2, "ms_turns": [t1, t2],
        "stage_ms": [time_ms(lambda kp=kp: stage_launch(kp, xk), reps=5) for kp in kpacks],
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by + " (fp32 FMA, CUDA cores)",
        "tf32x3_floor_ms": 1e3 * 3 * flops / TF32_FLOPS, "library_ms": library_ms,
        "beats_library": (t1 + t2) / 2 < library_ms,
        "library": "fp32 F.linear + relu chain, TF32 off: 5 linear calls an expert, 35 a predict",
        "ms_is": "one predict: 3 launches on packed buffers (packing: the predict_ab line's pack_ms)",
        **build_notes("rmi_mlp"),
    }
    return within, row


def predict_ab(pipe, test, eps, turns: int = 6, reps: int = 5):
    """``laf.predict``'s work (``predict_counts``: upload, features,
    forward, copy back) with the fused forward (``rmi_predict``, as the
    pipeline runs it) and with the ``nn.Linear`` modules (``model(x)``,
    the forward it replaced), in alternating turns (ABBA...), host clock,
    the median of ``reps`` runs a turn; and each part of it timed alone,
    packing the modules' buffers (part of every fused forward) too."""
    import torch

    from repro_torch.core.cardinality import rmi_predict
    from repro_torch.kernels.rmi_mlp.ops import pack_stage

    est = pipe.estimator

    def fused():
        return est.predict_counts(test, eps)

    def linear():
        with torch.no_grad():
            z = est.model(est._features(test, eps))
        return torch.clamp(torch.exp2(z) - 1.0, min=0.0).cpu().numpy()

    def host_s(fn):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return float(np.median(times))

    fused(), linear()
    by = {"fused": [], "linear": []}
    for t in range(turns):
        name = ("fused", "linear")[(t + t // 2) % 2]  # fused, linear, linear, fused, ...
        by[name].append(host_s(fused if name == "fused" else linear))
    feats = est._features(test, eps)
    z = rmi_predict(est.model, feats)
    with torch.no_grad():
        z_linear = est.model(feats)
    parts = {
        "upload_and_features_s": host_s(lambda: est._features(test, eps)),
        "upload_s": host_s(lambda: torch.as_tensor(np.asarray(test, np.float32)).to(est.device)),
        "forward_fused_ms": time_ms(lambda: rmi_predict(est.model, feats), reps=5),
        "pack_ms": time_ms(lambda: [pack_stage(e, feats.device) for e in est.model.stages], reps=5),
        "forward_linear_ms": time_ms(lambda: est.model(feats).detach(), reps=5),
        "counts_and_copy_back_s": host_s(lambda: torch.clamp(torch.exp2(z) - 1.0, min=0.0).cpu().numpy()),
    }
    return {"phase": "predict_ab", "fused_s": by["fused"], "linear_s": by["linear"],
            "fused_median_s": float(np.median(by["fused"])), "linear_median_s": float(np.median(by["linear"])),
            "z_fused_vs_linear_max_abs": float((z - z_linear).abs().max()), **parts}


def first_occurrence(labels):
    """Labels renumbered 0..k-1 in order of their first appearance."""
    _, first, inv = np.unique(labels, return_index=True, return_inverse=True)
    rank = np.empty(len(first), dtype=np.int64)
    rank[np.argsort(first)] = np.arange(len(first))
    return rank[inv]


def check_components(test, eps, truth, dev):
    """Phase 6: connected components of exact DBSCAN's core graph over
    the packed square adjacency, the fixpoint against the truth and the
    plain version (one ``label_prop_fixpoint`` launch), the square
    round's two kernels and the square fixpoint against their plain
    versions.  Returns (ok, phase line, kernel rows, launch counts)."""
    import torch

    from repro_torch.kernels import cost
    from repro_torch.core.range_query import pack_bitmap_t, range_bitmap
    from repro_torch.core.union_find import compact_labels, label_propagation
    from repro_torch.kernels.label_prop import label_prop_round, label_prop_update, label_propagation_pallas
    from repro_torch.kernels.label_prop.ops import _round_into
    from repro_torch.kernels.label_prop.ref import BIG, label_prop_round_ref, label_prop_update_ref
    from repro_torch.obs import metrics

    t_phase = time.perf_counter()
    x = torch.from_numpy(np.asarray(test, np.float32)).to(dev)
    n = x.shape[0]
    core = torch.from_numpy(truth.core).to(dev)
    t0 = time.perf_counter()
    adj = range_bitmap(x, x, eps)
    bitmap = torch.where(core[:, None], adj & pack_bitmap_t(core[None, :]), 0)
    del adj
    torch.cuda.synchronize()
    adjacency_s = time.perf_counter() - t0
    w = bitmap.shape[1]
    label_propagation_pallas(bitmap, core)  # first use
    metrics.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    labels, rounds = label_propagation_pallas(bitmap, core, with_rounds=True)
    torch.cuda.synchronize()
    fixpoint_s = time.perf_counter() - t0
    snap = metrics.snapshot()
    launches = {"label_prop_fixpoint_square": snap.get("kernel.label_prop_fixpoint.launches", 0),
                "label_prop_round": snap.get("kernel.label_prop_round.launches", 0),
                "label_prop_update_square": snap.get("kernel.label_prop_update.launches", 0)}
    t0 = time.perf_counter()
    plain = label_propagation(bitmap, core)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    fixpoint_ms = time_ms(lambda: label_propagation_pallas(bitmap, core), reps=3, warmup=1)
    lab = labels.cpu().numpy()
    cores = truth.core
    got = compact_labels(np.where(cores, lab, -1))[cores]  # min-index labels, in first-member order
    rounds = int(rounds)
    checks = {
        "equals_exact_dbscan_on_cores": bool(np.array_equal(got, first_occurrence(truth.labels[cores]))),
        "equals_plain_label_propagation": bool(torch.equal(labels, plain)),
        "sentinel_on_non_cores": bool((lab[~cores] == n).all()),
        "rounds_within_64": 1 <= rounds < 64,
        # one launch a fixpoint: its rounds' K2 and update steps run inside it
        "one_fixpoint_launch": launches == {"label_prop_fixpoint_square": 1, "label_prop_round": 0,
                                            "label_prop_update_square": 0},
    }
    stats = slab_stats(bitmap)
    line = {"phase": "components", "n": n, "words": w, "slab_bytes": 4 * n * w, "n_cores": int(cores.sum()),
            "set_bits": stats["set_bits"], "n_components": int(got.max()) + 1 if len(got) else 0,
            "exact_dbscan_clusters": truth.n_clusters, "rounds": rounds, "launches": launches,
            "adjacency_s": adjacency_s, "fixpoint_s": fixpoint_s, "fixpoint_ms": fixpoint_ms,
            "plain_label_propagation_s": plain_s, "checks": checks}

    # the square round's kernels against their plain versions on the slab
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    lab0 = torch.where(core, idx, BIG)
    k = label_prop_round(lab0, bitmap)
    col0 = torch.full((w * 32,), BIG, dtype=torch.int32, device=dev)
    col0[:n] = lab0
    k_out = torch.empty_like(k)
    b_ms, b_by = bound_ms(4 * (n * w + 2 * n))
    rows = [{
        "name": "label_prop_round", "shape": [n, w], **stats,
        "max_abs_err": int((k.long() - label_prop_round_ref(lab0, bitmap).long()).abs().max()),
        "ms": time_ms(lambda: label_prop_round(lab0, bitmap)),
        # the kernel alone, as the fixpoint launches it (no label fill)
        "device_ms": queued_ms(lambda: _round_into(col0, bitmap, k_out)),
        "plain_ms": time_ms(lambda: label_prop_round_ref(lab0, bitmap), reps=2, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "ptxas": ptxas_entries("label_prop", "label_prop_rect_kernel"),
    }]
    cap = w * 32
    act = torch.zeros(cap, dtype=torch.bool, device=dev)
    act[:n] = core
    cidx = torch.arange(cap, dtype=torch.int32, device=dev)
    init, pos = torch.where(act, cidx, BIG), torch.where(act, cidx, -1)
    flags = torch.tensor([1, 0], dtype=torch.int32, device=dev)
    u = torch.empty_like(init)

    def update():  # round 0 reads flags[0] == 1 and only ever sets flags[1]
        label_prop_update(init, k, pos, u, flags, 0)

    update()
    b_ms, b_by = cost.label_prop_update_cost(cap, n).bound_ms()
    rows.append({
        "name": "label_prop_update_square", "shape": [cap],
        "max_abs_err": int((u.long() - label_prop_update_ref(init, k, pos).long()).abs().max()),
        "ms": time_ms(update), "device_ms": queued_ms(update), "plain_ms": time_ms(lambda: label_prop_update_ref(init, k, pos)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    })
    rows.append(fixpoint_row("label_prop_fixpoint_square", bitmap, init, pos, square=True))
    checks["kernels_equal_plain"] = all(r["max_abs_err"] == 0 for r in rows)
    line["seconds"] = time.perf_counter() - t_phase
    return all(checks.values()), line, rows, launches


def check_stats_bodies(bk, exec_idx, eps, k1_rows, clock_hz):
    """Both ``_stats`` bodies of K1 at its comparison shape (``k1_rows``
    executed queries x the whole test db): counts and words equal to
    the non-stats twin bit for bit, the whole-call real-pair triple equal
    to the plain version's, counts against the plain version as the K1
    check allows (fp32 boundary flips only).  Each body is timed beside
    its twin (twin, body, body, twin)."""
    import torch

    from repro_torch.kernels import cost
    from repro_torch.index.signatures import popcount32
    from repro_torch.kernels.hamming_filter import hamming_filter_bitmap, hamming_filter_count, hamming_filter_into
    from repro_torch.kernels.hamming_filter.ref import hamming_filter_ref

    t_lo, t_hi = bk.band(eps)
    q, qs = bk._gather(exec_idx[:k1_rows])
    db, dbs = bk.data_device, bk._sigs_dev
    nq, d, nd, w = q.shape[0], q.shape[1], db.shape[0], qs.shape[1]
    n_words = -(-nd // 32)
    tol = 2 * (d - 1) * 2.0 ** -24
    pc, pb, ps = hamming_filter_ref(q, db, qs, dbs, eps, t_lo, t_hi, stats_chunk=nq)
    band = int(ps[0, 1])  # the band pairs: the verify work
    rows, ok = [], True
    for bitmap in (False, True):
        def body():
            counts = torch.zeros(nq, dtype=torch.int32, device=q.device)
            words = torch.zeros((nq, n_words), dtype=torch.int32, device=q.device) if bitmap else None
            stats = torch.zeros((1, 3), dtype=torch.int32, device=q.device)
            hamming_filter_into(q, db, qs, dbs, eps, t_lo, t_hi, counts, words, stats=stats, chunk_rows=nq)
            return counts, words, stats

        def twin():
            if bitmap:
                return hamming_filter_bitmap(q, db, qs, dbs, eps, t_hi, t_lo=t_lo)
            return hamming_filter_count(q, db, qs, dbs, eps, t_hi, t_lo=t_lo), None

        kc, kw, ks = body()
        tc, tw = twin()
        twin_equal = bool(torch.equal(kc, tc)) and (not bitmap or bool(torch.equal(kw, tw)))
        triple_equal = bool(torch.equal(ks, ps))
        words = kw if bitmap else hamming_filter_bitmap(q, db, qs, dbs, eps, t_hi, t_lo=t_lo)[1]
        pairs = flipped_pairs(words, pb)
        margin = pair_margin(pairs, q, db, eps)
        flips_ok = bool(torch.equal(kc - pc, popcount32(words).sum(1) - popcount32(pb).sum(1)))
        t1 = time_ms(twin)
        m1 = time_ms(body)
        m2 = time_ms(body)
        t2 = time_ms(twin)
        plain = time_ms(lambda: hamming_filter_ref(q, db, qs, dbs, eps, t_lo, t_hi, with_bitmap=bitmap,
                                                   stats_chunk=nq), reps=2, warmup=1)
        b_ms, b_by = cost.hamming_filter_cost(nq, nd, d, w, bitmap=bitmap, stats_chunks=1).bound_ms()
        rows.append({
            "name": "hamming_filter_bitmap_stats" if bitmap else "hamming_filter_count_stats",
            "shape": [nq, nd, d, w], "max_abs_err": int((kc - pc).abs().max()),
            "triple": ks[0].tolist(), "triple_equals_plain": triple_equal, "equals_twin": twin_equal,
            "bit_flips": len(pairs), "flip_max_margin": margin, "tolerance": tol,
            "ms": (m1 + m2) / 2, "twin_ms": (t1 + t2) / 2, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by + " (int8 tensor cores)", "popc_ms": popc_ms(nq, nd, w, clock_hz),
            **build_notes("hamming_filter"),
        })
        ok &= twin_equal and triple_equal and flips_ok and margin <= tol
    return ok, rows


def check_observability(pipe, test, eps, tau, alpha, main_labels, truth_labels, dev):
    """Phase 7: the main path with everything off and on, the count
    sweep's occupancy slab, the margin tables.  Returns (ok, phase line,
    launch counts of the observability path)."""
    import torch

    from repro_torch import obs
    from repro_torch.core.metrics import adjusted_rand_index
    from repro_torch.index.random_projection import RandomProjectionBackend, record_occupancy, suggest_margin
    from repro_torch.index.sweep import plan_sweep
    from repro_torch.kernels.hamming_filter.ops import pad_grid_stats
    from repro_torch.kernels.hamming_filter.ref import hamming_filter_ref
    from repro_torch.obs import device as tele
    from repro_torch.obs import metrics

    warnings = []
    catcher = logging.Handler(logging.WARNING)
    catcher.emit = lambda rec: warnings.append(rec.getMessage())
    obs.get_logger().addHandler(catcher)
    fields = tele.CLUSTER_ROUND_FIELDS
    line = {"phase": "observability"}
    t_phase = time.perf_counter()
    try:
        # 1. the main path, obs off and everything on, in turns (off, on, on, off)
        obs.disable()
        off = [pipe.cluster_laf_dbscan(test, eps, tau, alpha)]
        obs.enable(trace=True, metrics_on=True, telemetry=True)
        obs.clear_trace()
        metrics.reset()
        torch.cuda.synchronize()
        on = [pipe.cluster_laf_dbscan(test, eps, tau, alpha)]
        snap = metrics.snapshot()
        recs = obs.spans()
        launches = {k: snap.get(f"kernel.{k}.launches", 0) for k in KERNELS}
        on.append(pipe.cluster_laf_dbscan(test, eps, tau, alpha))
        obs.disable()
        off.append(pipe.cluster_laf_dbscan(test, eps, tau, alpha))
        obs.enable(trace=True, metrics_on=True, telemetry=True)

        by_id = {r.span_id: r for r in recs}

        def ancestors(r):
            names = []
            while r.parent_id in by_id:
                r = by_id[r.parent_id]
                names.append(r.name)
            return names

        tree = {"laf.predict": "laf.run", "laf.fit_index": "laf.run", "laf.pass1": "laf.run",
                "laf.sweep": "laf.pass1", "laf.label_prop": "laf.run",
                "laf.cluster.round": "laf.label_prop"}
        tree_ok = all(
            any(r.name == name for r in recs)
            and all(anc in ancestors(r) for r in recs if r.name == name)
            for name, anc in tree.items())
        run_rec = next(r for r in recs if r.name == "laf.run")
        cluster_rec = next(r for r in recs if r.name == "laf.cluster")
        rounds = int(snap.get("laf.cluster.last_rounds", -1))
        per = sorted((r for r in recs if r.name == "laf.cluster.round"), key=lambda r: r.attrs["round"])
        per_round = {f: [r.attrs[f] for r in per] for f in fields}
        with tempfile.TemporaryDirectory() as td:
            path = Path(td) / "laf_trace.json"
            obs.export_chrome_trace(str(path))
            events = json.loads(path.read_text())["traceEvents"]
        names = {e["name"] for e in events}
        band_counts = {k: snap.get(f"index.band.{k}", 0) for k in ("accept", "band", "reject")}
        ari = adjusted_rand_index(on[0].result.labels, truth_labels)
        checks = {
            "labels_equal_obs_off": all(np.array_equal(o.result.labels, off[0].result.labels) for o in on + off[1:])
            and bool(np.array_equal(off[0].result.labels, main_labels)),
            "host_syncs_1": snap.get("laf.cluster.host_syncs") == 1,
            "rounds_equal_gauge": len(per) == rounds >= 1
            and all(snap.get(f"laf.telemetry.{f}") == sum(per_round[f]) for f in fields),
            "frontier_equals_shard_wins": per_round["frontier"] == per_round["shard_wins"],
            "ari_ge_0.99": ari >= 0.99,
            "span_tree": tree_ok,
            "chrome_trace": set(tree) | {"laf.run", "laf.cluster"} <= names,
            "index_band_nonzero": sum(band_counts.values()) > 0,
        }
        line.update({
            "elapsed_s_obs_off": [o.elapsed_s for o in off], "elapsed_s_obs_on": [o.elapsed_s for o in on],
            "predict_s_obs_on": on[0].predict_s, "coverage_laf_run": obs.coverage(run_rec, recs),
            "coverage_laf_cluster": obs.coverage(cluster_rec, recs),
            "span_s": {n: sum(r.dur for r in recs if r.name == n)
                       for n in ("laf.run", "laf.predict", "laf.cluster", "laf.fit_index", "laf.pass1",
                                 "laf.sweep", "laf.label_prop", "laf.postprocess")},
            "rounds": rounds, "per_round": per_round, "ari_vs_exact_dbscan": ari,
            "index_band": band_counts, "trace_events": len(events), "launches": launches,
        })

        # 2. a count sweep of the whole split with its occupancy slab
        bk = RandomProjectionBackend(device=dev).fit(test)
        rows = np.arange(len(test))
        bk.band(eps)  # its occupancy measurement, outside the sweep's counters
        metrics.reset()
        counts_on = bk.query_counts(rows, eps)
        sweep_snap = metrics.snapshot("sweep.")
        slab = tele.last_sweep_stats().copy()
        tele.disable_device()
        counts_off = bk.query_counts(rows, eps)
        tele.enable_device()
        plan = plan_sweep(len(rows), bk.chunk, bk.q_tile, bk.chunks_per_launch)
        t_lo, t_hi = bk.band(eps)
        q, qs = bk._gather(rows)
        _, _, real = hamming_filter_ref(q, bk.data_device, qs, bk._sigs_dev, eps, t_lo, t_hi,
                                        with_bitmap=False, stats_chunk=plan.chunk)
        plain = pad_grid_stats(qs, bk._sigs_dev, t_lo, t_hi, chunk=plan.chunk,
                               n_chunks=plan.n_launches * plan.cpl, db_tile=bk.db_tile)
        plain[: real.shape[0]] += real
        totals = slab.astype(np.int64).sum(axis=0)
        checks.update({
            "sweep_counts_unchanged": bool(np.array_equal(counts_on, counts_off)),
            "sweep_slab_rows": slab.shape == (plan.n_launches * plan.cpl, 3),
            "sweep_slab_equals_plain": bool(np.array_equal(slab, plain.cpu().numpy())),
            "sweep_tele_equals_slab": all(sweep_snap.get(f"sweep.tele.{f}") == int(totals[i])
                                          for i, f in enumerate(tele.SWEEP_STAT_FIELDS)),
            "sweep_host_syncs_1": sweep_snap.get("sweep.host_syncs") == 1,
        })
        line.update({"sweep_chunks": slab.shape[0], "sweep_tele": dict(zip(tele.SWEEP_STAT_FIELDS, totals.tolist()))})

        # 3. margin tables: the kernel's counters against the host Hamming sweep
        m_dev, table_dev = suggest_margin(bk, eps, report=True)
        host_bk = RandomProjectionBackend(device=dev, oracle=True).fit(test)
        m_host, table_host = suggest_margin(host_bk, eps, report=True)
        n = len(test)
        n_rows = len(np.unique(np.linspace(0, n - 1, min(n, 4 * bk.q_tile)).astype(np.int64)))

        def pairs(table):
            return [(r["margin"], r["t_lo"], r["t_hi"], round(r["band_frac"] * n_rows * n),
                     round(r["accept_frac"] * n_rows * n)) for r in table]

        occupancy = record_occupancy(bk, eps)  # called directly: a kernel failure fails the run
        checks.update({
            "margin_tables_equal": m_dev == m_host and pairs(table_dev) == pairs(table_host),
            "record_occupancy_row": occupancy == next(r for r in table_dev if r["margin"] == bk.margin),
            "no_occupancy_warning": not any("occupancy_record_failed" in w for w in warnings),
        })
        line.update({"suggested_margin": m_dev, "margin_table": table_dev})
    finally:
        obs.get_logger().removeHandler(catcher)
    line["checks"] = checks
    line["seconds"] = time.perf_counter() - t_phase
    return all(checks.values()), line, launches


def logit_gap(got, want):
    """(relative L2 error, largest absolute difference) in fp32."""
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm()), float((got - want).abs().max())


def lm_serve(dev):
    """Phase 9: llama3-8b at full width and depth in bf16 on the card,
    weights from ``transformer_init(0, cfg)``: prefill of 4 x 4096
    tokens, then the first 1024 tokens of each request fed one by one
    through ``transformer_decode_step`` and 64 greedy tokens, each path
    with the launch count set to 0 just before it and read just after;
    decode against prefill and forward, and the decode kernel on the
    filled cache against the plain version.  The weights are freed
    before it returns.  Returns (ok, phase line, launches by row)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import token_stream
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models.layers import blockwise_attention
    from repro_torch.models.transformer import (
        make_cache, transformer_decode_step, transformer_forward, transformer_init, transformer_prefill,
    )
    from repro_torch.obs import metrics

    counter = "kernel.flash_attention.launches"
    t_phase = time.perf_counter()
    cfg = get_arch("llama3-8b").make_config()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = transformer_init(0, cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    line = {"phase": "lm_serve", "arch": "llama3-8b", "dtype": str(cfg.dtype), "init_s": init_s,
            "params": n_params, "param_bytes": sum(p.numel() * p.element_size() for p in model.parameters()),
            "bf16_reduced_precision_reduction": torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}
    toks, _ = token_stream(np.random.default_rng(0), *LM_PREFILL, cfg.vocab)
    toks = torch.from_numpy(toks).to(dev)

    # prefill: warm once, then one timed call
    transformer_prefill(model, cfg, toks)
    metrics.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pre = transformer_prefill(model, cfg, toks)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = metrics.snapshot().get(counter, 0)
    line.update({"prefill_shape": list(LM_PREFILL), "prefill_s": prefill_s,
                 "prefill_tokens_per_s": LM_PREFILL[0] * LM_PREFILL[1] / prefill_s,
                 "prefill_launches": prefill_launches, "prefill_peak_mem_bytes": torch.cuda.max_memory_allocated(),
                 "prefill_logits_shape": list(pre.shape)})
    finite = bool(torch.isfinite(pre).all())
    del pre
    wall, busy, union, top = device_busy(lambda: transformer_prefill(model, cfg, toks))
    line["prefill_trace"] = {"wall_s": wall, "device_busy_s": busy, "device_busy_union_s": union,
                             "idle_share": None if union is None else 1.0 - union / wall, "top_kernels": top}

    # decode: the prompts token by token (teacher-forced), then greedy
    b = LM_PREFILL[0]
    prompt = toks[:, :LM_PROMPT].contiguous()
    del toks
    cache = make_cache(cfg, b, LM_PROMPT + LM_NEW)
    check_at = list(range(LM_PROMPT // 16 - 1, LM_PROMPT, LM_PROMPT // 16))  # 16 positions, the last among them
    saved, step_s, step_launches, generated, chunk_s = {}, [], [], [], []
    metrics.reset()
    torch.cuda.synchronize()
    t0 = t_chunk = time.perf_counter()
    for t in range(LM_PROMPT):
        logits, cache = transformer_decode_step(model, cfg, prompt[:, t : t + 1], cache, t)
        if t in check_at:
            saved[t] = logits.float()
        if (t + 1) % (LM_PROMPT // 8) == 0:  # the prompt's steps in 8 synced chunks
            torch.cuda.synchronize()
            chunk_s.append(time.perf_counter() - t_chunk)
            t_chunk = time.perf_counter()
    prompt_s = time.perf_counter() - t0
    tok = logits.argmax(-1, keepdim=True)
    for t in range(LM_PROMPT, LM_PROMPT + LM_NEW):
        generated.append(tok)
        before = metrics.snapshot().get(counter, 0)
        t0 = time.perf_counter()
        logits, cache = transformer_decode_step(model, cfg, tok, cache, t)
        tok = logits.argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        step_launches.append(metrics.snapshot().get(counter, 0) - before)
    decode_launches = metrics.snapshot().get(counter, 0)
    finite &= bool(torch.isfinite(logits).all())
    step_ms = 1e3 * float(np.median(step_s))
    line.update({"decode_batch": b, "cache_len": LM_PROMPT + LM_NEW, "prompt_steps": LM_PROMPT,
                 "prompt_s": prompt_s, "prompt_chunk_ms_per_step": [1e3 * c / (LM_PROMPT // 8) for c in chunk_s],
                 "greedy_steps": LM_NEW, "step_ms_median": step_ms,
                 "step_ms_min": 1e3 * min(step_s), "step_ms_max": 1e3 * max(step_s),
                 "decode_tokens_per_s": b / (step_ms / 1e3), "decode_launches": decode_launches,
                 "launches_per_step": sorted(set(step_launches))})

    # checks: decode == prefill at the last prompt position, decode ==
    # forward at 16 prompt positions, the greedy tokens against forward
    with torch.inference_mode():
        pre = transformer_prefill(model, cfg, prompt)
        gen = torch.cat(generated, dim=1)
        fwd = transformer_forward(model, cfg, torch.cat([prompt, gen[:, :-1]], dim=1))
    rel_a, abs_a = logit_gap(saved[LM_PROMPT - 1], pre)
    fwd_at = fwd[:, check_at].float()
    dec_at = torch.stack([saved[t] for t in check_at], dim=1)
    rel_b, abs_b = logit_gap(dec_at, fwd_at)
    greedy_fwd = fwd[:, LM_PROMPT - 1 :].argmax(-1)
    finite &= bool(torch.isfinite(pre).all()) and bool(torch.isfinite(fwd).all())
    # the decode mapping on the path's own operands, after the counts were
    # read: the filled cache's prefix views, passed as _gqa_decode_layer
    # passes them, against the plain version on the same views
    g = torch.Generator(device=dev).manual_seed(4)
    q = torch.randn((b, cfg.n_heads, 1, cfg.d_head), generator=g, device=dev).to(cfg.dtype)
    on_cache, on_cache_ok = [], True
    for layer in (0, cfg.n_layers - 1):
        kc, vc = cache["k"][layer], cache["v"][layer]
        for n in (1, 77, LM_PROMPT, LM_PROMPT + LM_NEW):
            out = blockwise_attention(q, kc, vc, causal=True, window=None, q_offset=n - 1,
                                      kv_block=cfg.kv_block, valid_len=n)
            ok_n, gap = flash_gap(out, attention_ref(q, kc[:, :, :n], vc[:, :, :n], causal=True))
            on_cache_ok &= ok_n
            gap.pop("tolerance")
            on_cache.append({"layer": layer, "keys": n, **gap})
    del q, out
    line["operator_vs_raw_launch"] = decode_operator_cost(model, cfg, generated[-1], cache, LM_PROMPT + LM_NEW - 1)
    checks = {
        "params_8030261248": n_params == 8_030_261_248 == cfg.param_count(),
        "prefill_launches_32": prefill_launches == cfg.n_layers,
        "launches_32_per_step": set(step_launches) == {cfg.n_layers},
        "decode_launches": decode_launches == cfg.n_layers * (LM_PROMPT + LM_NEW),
        "decode_equals_prefill": rel_a <= LM_REL_L2 and abs_a <= LM_MAX_ABS,
        "decode_equals_forward": rel_b <= LM_REL_L2 and abs_b <= LM_MAX_ABS,
        "decode_kernel_on_cache": on_cache_ok,
        "finite": finite,
    }
    line.update({
        "tolerance": f"rel L2 <= {LM_REL_L2} and max |diff| <= {LM_MAX_ABS} (fp32 compare of bf16 logits)",
        "decode_vs_prefill": {"rel_l2": rel_a, "max_abs": abs_a, "logit_max_abs": float(pre.float().abs().max())},
        "decode_vs_forward": {"positions": check_at, "rel_l2": rel_b, "max_abs": abs_b},
        "argmax_differs_vs_prefill": int((saved[LM_PROMPT - 1].argmax(-1) != pre.argmax(-1)).sum()),
        "argmax_differs_vs_forward": int((dec_at.argmax(-1) != fwd_at.argmax(-1)).sum()),
        "greedy_tokens_differ_vs_forward": int((greedy_fwd != gen).sum()),
        "greedy_tokens": gen.numel(),
        "decode_kernel_on_cache": {"shape": {"B": b, "Hq": cfg.n_heads, "Hkv": cfg.kv_heads, "D": cfg.d_head,
                                             "slots": LM_PROMPT + LM_NEW}, "tolerance": FLASH_TOL,
                                   "rows": on_cache},
        "checks": checks,
    })
    # one more step (slot LM_PROMPT + LM_NEW - 1 written again) under the profiler
    wall, busy, union, top = device_busy(
        lambda: transformer_decode_step(model, cfg, tok, cache, LM_PROMPT + LM_NEW - 1))
    line["decode_step_trace"] = {"wall_s": wall, "device_busy_s": busy, "device_busy_union_s": union,
                                 "idle_share": None if union is None else 1.0 - union / wall, "top_kernels": top}
    del model, cache, pre, fwd, fwd_at, dec_at, saved, logits
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    line["seconds"] = time.perf_counter() - t_phase
    return all(checks.values()), line, {"flash_attention": prefill_launches, "flash_attention_decode": decode_launches,
                                        "flash_attention_decode_path": decode_launches}


def flash_gap(out, ref):
    """(ok, fields) of the kernel's bf16 output against the plain
    version's: both sum in fp32 and round once to bf16, so they may
    differ by one bf16 step of the value, 2^-7 |plain|, and the fp32
    sums by far less than 1e-5.  The fields give the largest error, the
    typical |plain| beside it and the error over the plain output's RMS."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    ok = bool((err <= 2.0 ** -7 * ref.abs() + 1e-5).all()) and bool(out.isfinite().all())
    return ok, {"max_abs_err": float(err.max()), "mean_abs_plain": float(ref.abs().mean()),
                "max_err_over_rms": float(err.max() / ref.pow(2).mean().sqrt().clamp_min(1e-30)),
                "tolerance": FLASH_TOL}


def flash_row(name, b, hq, hkv, sq, sk, d, causal, window, seed, time_it=True, dv=None):
    """The kernel against its plain version on the card in bf16 (the
    working type) at one shape, v ``dv`` wide (default ``d``), within
    ``flash_gap``'s one bf16 step, and, when ``time_it``, its time, the
    plain version's, the library's (``scaled_dot_product_attention`` with
    ``enable_gqa``; where ``dv != d``, the faster of SDPA with v at its
    own width and with v zero-padded to ``d``, both timed) and the bound
    over bf16 tensor cores (the fp32 CUDA-core bound beside it); a decode
    row (Sq 1) also gives both calls' time queued behind a sleep, which
    leaves out the host's cost of issuing them."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cost
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    g = torch.Generator(device="cuda").manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=g, device="cuda", dtype=torch.float32).to(torch.bfloat16)

    dv = d if dv is None else dv
    q, k, v = draw(b, hq, sq, d), draw(b, hkv, sk, d), draw(b, hkv, sk, dv)
    out = flash_attention(q, k, v, causal=causal, window=window)
    ref = attention_ref(q, k, v, causal=causal, window=window)
    ok, gap = flash_gap(out, ref)
    ok &= out.shape == ref.shape == (b, hq, sq, dv)
    row = {"name": name, "shape": {"B": b, "Hq": hq, "Hkv": hkv, "Sq": sq, "Sk": sk, "D": d, "Dv": dv,
                                   "causal": causal, "window": window, "dtype": "bfloat16"}, **gap}
    del out, ref
    if not time_it:
        return ok, row
    # the (query, key) pairs the mask keeps and the keys read: what the work needs
    c = cost.attention_cost(b, hq, hkv, sq, sk, d, dv, causal=causal, window=window)
    pairs = b * hq * cost.attention_span(sq, sk, causal, window)[0]
    flops, n_bytes = c.ops, c.bytes
    b_ms, b_by = c.bound_ms()
    fp32_ms, _ = bound_ms(n_bytes, flops, FP32_FLOPS)
    vp = F.pad(v, (0, d - dv)) if dv != d else None

    def library(v=v):
        if window is None and (causal and sq == sk or sq == 1):
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal and sq > 1, enable_gqa=True)
        raise ValueError("no single library call for this mask")

    t1 = time_ms(lambda: flash_attention(q, k, v, causal=causal, window=window), reps=5)
    plain = time_ms(lambda: attention_ref(q, k, v, causal=causal, window=window), reps=2, warmup=1)
    lib = time_ms(library, reps=5)
    lib_padded = time_ms(lambda: library(vp), reps=5) if dv != d else None
    t2 = time_ms(lambda: flash_attention(q, k, v, causal=causal, window=window), reps=5)
    if sq == 1:
        row.update({"queued_ms": queued_ms(lambda: flash_attention(q, k, v, causal=causal, window=window)),
                    "library_queued_ms": queued_ms(library)})
    if dv != d:
        row.update({"library_v_own_width_ms": lib, "library_v_padded_ms": lib_padded,
                    "two_term_floor_ms": bound_ms(n_bytes, 2.0 * pairs * (d + 2 * dv), BF16_FLOPS)[0]})
        lib = min(lib, lib_padded)
    row.update({"flops": flops, "bytes": n_bytes, "ms": (t1 + t2) / 2, "ms_turns": [t1, t2], "plain_ms": plain,
                "library_ms": lib, "library": "F.scaled_dot_product_attention(enable_gqa=True), bf16",
                "bound_ms": b_ms, "bound_by": b_by, "bound_fp32_cuda_cores_ms": fp32_ms,
                "tflops": flops / ((t1 + t2) / 2) / 1e9})
    return ok, row


def check_flash_attention(lm_launches):
    """The flash-attention rows: the prefill row (B 4, Hq 32, Hkv 8, S
    4096, D 128, causal), the decode row (B 16, Sq 1, Sk 32768, the
    registry's decode_32k length), the decode path's own shape (B 4, Sk
    1088: ``lm_serve``'s full cache) and a windowed case (window 1024, S
    2048) for correctness only.  Returns (ok, rows, phase line)."""
    t_phase = time.perf_counter()
    ok_p, pre = flash_row("flash_attention", 4, 32, 8, 4096, 4096, 128, True, None, seed=1)
    ok_d, dec = flash_row("flash_attention_decode", 16, 32, 8, 1, 32768, 128, True, None, seed=2)
    ok_dp, dec_path = flash_row("flash_attention_decode_path", LM_PREFILL[0], 32, 8, 1, LM_PROMPT + LM_NEW, 128,
                                True, None, seed=4)
    ok_w, win = flash_row("flash_attention_window", 2, 32, 8, 2048, 2048, 128, True, 1024, seed=3, time_it=False)
    for row in (pre, dec, dec_path):
        row["launches"] = lm_launches[row["name"]]
    line = {"phase": "flash_attention", "seconds": time.perf_counter() - t_phase, "prefill_ok": ok_p,
            "decode_ok": ok_d, "decode_path_ok": ok_dp, "window_ok": ok_w, "window_case": win}
    return ok_p and ok_d and ok_dp and ok_w, [pre, dec, dec_path], line


def host_ms(fn, reps: int, warmup: int = 2):
    """(median ms, all ms) of ``fn()`` on the host clock, each call ended
    by a sync: a request's latency, uploads and copies back included."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times)), times


@contextlib.contextmanager
def raw_attention_launch():
    """``flash_attention`` calling its raw launch function in place of the
    operator ``repro_torch::flash_attention`` (the same launch and count)."""
    from repro_torch.kernels.flash_attention import ops

    op = ops._attention_op
    ops._attention_op = op._init_fn
    try:
        yield
    finally:
        ops._attention_op = op


def decode_operator_cost(model, cfg, token, cache, pos, steps: int = 32) -> dict:
    """Decode steps at ``pos`` (the cache's last position, written again
    with the token it holds) with the attention operator and with its raw
    launch function, one of each in turn, ``steps`` each, each synced:
    the operator's dispatch as the path feels it (its median of the
    paired differences beside the medians: the host's speed drifts over
    seconds)."""
    import torch

    from repro_torch.models.transformer import transformer_decode_step

    ms = {"operator": [], "raw_launch": []}
    for i in range(2 * steps + 2):
        kind = "raw_launch" if i % 2 else "operator"
        with raw_attention_launch() if kind == "raw_launch" else contextlib.nullcontext():
            t0 = time.perf_counter()
            transformer_decode_step(model, cfg, token, cache, pos)
            torch.cuda.synchronize()
            if i >= 2:  # one warm step of each
                ms[kind].append(1e3 * (time.perf_counter() - t0))
    med = {k: float(np.median(v)) for k, v in ms.items()}
    paired = [a - b for a, b in zip(ms["operator"], ms["raw_launch"])]
    return {"step_ms_median": med, "step_ms": ms, "added_ms_per_step_median_of_pairs": float(np.median(paired)),
            "attention_calls_per_step": cfg.n_layers}


def recsys_gap(card, cpu):
    """(ok, fields) of the card's fp32 output against the CPU's."""
    card, cpu = card.float().cpu(), cpu.float()
    err = (card - cpu).abs()
    ok = bool((err <= 1e-5 * (1 + cpu.abs())).all()) and bool(card.isfinite().all())
    return ok, {"max_abs_err": float(err.max()), "max_abs_cpu": float(cpu.abs().max()), "rows": int(cpu.shape[0])}


def eb_row(name, table, ids, combiner, time_it=True, library=None):
    """The embedding_bag kernel against its plain version on the card,
    within ``EB_TOL``; when ``time_it``, its time (two turns around the
    plain version and the library call, and queued behind a sleep: the
    kernel alone), the library call's and the byte bound over what these
    ids need: each distinct row read once (padding reads none, an id past
    V reads row V - 1), the ids read and the bags written once."""
    import torch

    from repro_torch.kernels import cost
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

    (b, length), (v, d) = ids.shape, table.shape
    out = embedding_bag(table, ids, combiner=combiner)
    ref = embedding_bag_ref(table, ids, combiner=combiner)
    scale = embedding_bag_ref(table.abs(), ids, combiner=combiner)
    err = (out - ref).abs()
    ok = bool((err <= 2 * length * 2.0 ** -24 * scale + 2.0 ** -23 * ref.abs()).all()) and bool(out.isfinite().all())
    valid = int((ids >= 0).sum())
    row = {"name": name, "shape": {"B": b, "L": length, "V": v, "D": d, "dtype": str(table.dtype).split(".")[-1],
                                   "combiner": combiner, "valid_ids": valid, "ids_past_V": int((ids >= v).sum())},
           "max_abs_err": float(err.max()), "mean_abs_plain": float(ref.abs().mean()), "tolerance": EB_TOL}
    del out, ref, scale, err
    if not time_it:
        return ok, row
    distinct = int(torch.unique(ids[ids >= 0].clamp(max=v - 1)).numel())
    n_bytes = cost.embedding_bag_cost(b, length, d, rows=distinct, elem=table.element_size()).bytes
    gathered_bytes = cost.embedding_bag_cost(b, length, d, rows=valid, elem=table.element_size()).bytes
    b_ms, b_by = cost.embedding_bag_cost(b, length, d, rows=distinct, elem=table.element_size()).bound_ms()

    def kernel():
        return embedding_bag(table, ids, combiner=combiner)

    lib_fn, lib_what = library
    t1 = time_ms(kernel, reps=20)
    plain = time_ms(lambda: embedding_bag_ref(table, ids, combiner=combiner), reps=3, warmup=1)
    lib = time_ms(lib_fn, reps=20)
    t2 = time_ms(kernel, reps=20)
    row["shape"]["distinct_rows"] = distinct
    row.update({"bytes": n_bytes, "gathered_bytes": gathered_bytes, "ms": (t1 + t2) / 2, "ms_turns": [t1, t2],
                "device_ms": queued_ms(kernel), "plain_ms": plain, "library_ms": lib,
                "library_device_ms": queued_ms(lib_fn), "library": lib_what, "bound_ms": b_ms, "bound_by": b_by,
                "gathered_bound_ms": bound_ms(gathered_bytes)[0], "gb_per_s": n_bytes / ((t1 + t2) / 2) / 1e6})
    return ok, row


# the kernel's mapping at its edges, for correctness only (mirrors
# tests/test_torch_embedding_bag.py's EDGE_CASES): (D, L, B, dtype, offset
# in elements of the table's start in its buffer); B 1003 and 4099 are not
# multiples of a block's bags, offset 1 puts the table 4 (2) bytes past a
# 16-byte boundary
EB_EDGES = ([(d, 20, 1003, "float32", 0) for d in (1, 3, 4, 32, 33, 64, 100, 128, 130, 256)]
            + [(d, 20, 1003, "bfloat16", 0) for d in (1, 3, 33, 129)]
            + [(32, l, 4099, "float32", 0) for l in (1, 20, 33, 64)]
            + [(32, 20, 4099, "float32", 1), (64, 20, 4099, "bfloat16", 1), (33, 7, 1003, "float32", 1)])


def eb_edge_inputs(d, length, b, dtype, offset, v=5000, seed=0, device="cpu"):
    """(table, ids) of an edge case: a (v, d) table that starts ``offset``
    elements into its buffer; ids in [-2, v + 2) (negative: padding; >= v:
    row v - 1), bag 0 all padding, bag 1 all past V."""
    import torch

    g = torch.Generator().manual_seed(seed)
    buf = torch.randn(v * d + offset, generator=g).to(device=device, dtype=getattr(torch, dtype))
    ids = torch.randint(-2, v + 2, (b, length), generator=g, dtype=torch.int32)
    ids[0] = -1
    ids[1] = v + torch.arange(length, dtype=torch.int32) % 3
    return buf[offset:].view(v, d), ids.to(device)  # the view keeps its offset on the device


def check_embedding_bag_edges(dev):
    """Every ``EB_EDGES`` case, both combiners, within ``EB_TOL`` of the
    plain version.  Returns (ok, rows)."""
    rows, ok = [], True
    for case in EB_EDGES:
        d, length, b, dtype, offset = case
        table, ids = eb_edge_inputs(*case, seed=len(rows), device=dev)
        ok &= offset == 0 or table.data_ptr() % 16 != 0  # the view is off a 16-byte boundary
        for combiner in ("sum", "mean"):
            ok_c, row = eb_row("embedding_bag_edge", table, ids, combiner, time_it=False)
            ok &= ok_c
            rows.append({"D": d, "L": length, "B": b, "dtype": dtype, "offset": offset, "combiner": combiner,
                         "max_abs_err": row["max_abs_err"], "ok": ok_c})
    return ok, rows


def check_embedding_bag(table, hist, dev):
    """The embedding_bag rows: bst's user tower at the serve_bulk batch
    (its item table and users, ``mean``), kernel_bench's 8,192 bags of 32
    from a 1M x 64 fp32 table (``sum``, ~10% padding) and a bf16 copy of
    the bst table (other negative ids, ids past V: correctness only).
    Returns (ok, timed rows, the bf16 case)."""
    import torch
    import torch.nn.functional as F

    ok_a, tower = eb_row("embedding_bag", table, hist, "mean",
                         library=(lambda: F.embedding_bag(hist, table, mode="mean"),
                                  "F.embedding_bag(ids, table, mode='mean'): no padding in these bags"))
    g = torch.Generator(device=dev).manual_seed(5)
    t64 = torch.randn((1_000_000, 64), generator=g, device=dev)
    ids = torch.randint(0, 1_000_000, (8192, 32), generator=g, device=dev, dtype=torch.int32)
    ids.masked_fill_(torch.rand(ids.shape, generator=g, device=dev) < 0.1, -1)
    safe, weights = ids.clamp(min=0), (ids >= 0).float()
    ok_b, bench = eb_row("embedding_bag_sum", t64, ids, "sum",
                         library=(lambda: F.embedding_bag(safe, t64, mode="sum", per_sample_weights=weights),
                                  "F.embedding_bag(ids with padding set to 0, table, mode='sum', "
                                  "per_sample_weights = the valid mask)"))
    del t64, ids, safe, weights
    t16 = table.to(torch.bfloat16)
    ids = hist[:65536].clone()
    r = torch.rand(ids.shape, generator=g, device=dev)
    ids[r < 0.05] = -3
    ids[(r >= 0.05) & (r < 0.07)] = -1
    ids[(r >= 0.07) & (r < 0.08)] += table.shape[0]  # past V: reads row V - 1
    ok_c, bf16 = eb_row("embedding_bag_bf16", t16, ids, "mean", time_it=False)
    del t16, ids
    return ok_a and ok_b and ok_c, [tower, bench], bf16


def recsys_serve(dev):
    """Phase 10: bst at full width (serve_p99, serve_bulk, a bulk user
    embedding, retrieval_cand), with the launch counts set to 0 just
    before and read just after; each model held to its CPU copy; the
    embedding_bag rows on bst's table; then DeepFM, AutoInt and DIEN at
    full width at serve_p99.  Every model is freed before the next.
    Returns (ok, phase line, embedding_bag rows, launches by row)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import ctr_batch
    from repro_torch.models import recsys
    from repro_torch.obs import metrics

    t_phase = time.perf_counter()
    line, checks = {"phase": "recsys", "tolerance": RECSYS_TOL}, {}
    rng = np.random.default_rng(0)

    # bst at full width
    cfg = get_arch("bst").make_config()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = recsys.bst_init(0, cfg)
    torch.cuda.synchronize()
    bst = {"init_s": time.perf_counter() - t0, "params": sum(p.numel() for p in model.parameters()),
           "param_bytes": sum(p.numel() * p.element_size() for p in model.parameters())}
    p99 = ctr_batch(rng, RECSYS_P99, 1, np.asarray([cfg.item_vocab]), seq_len=cfg.seq_len)
    bulk = ctr_batch(rng, RECSYS_BULK, 1, np.asarray([cfg.item_vocab]), seq_len=cfg.seq_len)
    user = ctr_batch(rng, 1, 1, np.asarray([cfg.item_vocab]), seq_len=cfg.seq_len)["hist"]
    g = torch.Generator(device=dev).manual_seed(6)
    cands = torch.randn((N_CANDIDATES, cfg.embed_dim), generator=g, device=dev)
    hist_bulk = torch.from_numpy(bulk["hist"]).to(dev)

    def serve(batch):
        return torch.sigmoid(recsys.bst_forward(model, cfg, batch["hist"], batch["ids"][:, 0])).cpu()

    user_calls = 0

    def user_embedding(hist):
        nonlocal user_calls
        user_calls += 1
        return recsys.bst_user_embedding(model, cfg, hist)

    def retrieve():
        return recsys.retrieval_scores(user_embedding(user), cands)

    metrics.reset()
    torch.cuda.reset_peak_memory_stats()
    p99_ms, p99_all = host_ms(lambda: serve(p99), reps=50, warmup=3)
    bulk_ms, bulk_all = host_ms(lambda: serve(bulk), reps=5, warmup=1)
    bulk_prob = serve(bulk)
    ub_ms, _ = host_ms(lambda: user_embedding(hist_bulk), reps=5, warmup=1)
    ret_ms, ret_all = host_ms(retrieve, reps=50, warmup=3)
    scores = retrieve()
    torch.cuda.synchronize()
    snap = metrics.snapshot()
    eb_launches = snap.get("kernel.embedding_bag.launches", 0)
    bst.update({
        "serve_p99": {"batch": RECSYS_P99, "ms_median": p99_ms, "ms_min": min(p99_all), "ms_max": max(p99_all),
                      "requests": len(p99_all)},
        "serve_bulk": {"batch": RECSYS_BULK, "ms_median": bulk_ms, "ms_all": bulk_all,
                       "rows_per_s": RECSYS_BULK / (bulk_ms / 1e3)},
        "user_bulk": {"batch": RECSYS_BULK, "ms_median": ub_ms, "users_per_s": RECSYS_BULK / (ub_ms / 1e3)},
        "retrieval_cand": {"n_candidates": N_CANDIDATES, "ms_median": ret_ms, "ms_min": min(ret_all),
                           "ms_max": max(ret_all), "requests": len(ret_all), "scores_shape": list(scores.shape)},
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "launches": {k.split(".")[1]: v for k, v in snap.items() if k.startswith("kernel.") and v},
        "user_embedding_calls": user_calls,
    })
    checks["bst_embedding_bag_launches_equal_calls"] = eb_launches == user_calls
    for name, batch in (("serve_p99", p99), ("serve_bulk", bulk)):
        wall, busy, union, top = device_busy(lambda: serve(batch))
        bst[name]["trace"] = {"wall_s": wall, "device_busy_s": busy, "device_busy_union_s": union,
                              "idle_share": None if union is None else 1.0 - union / wall, "top_kernels": top}

    # the card against the same module on the host
    host = copy.deepcopy(model).cpu()
    p99_card = serve(p99)
    p99_cpu = torch.sigmoid(recsys.bst_forward(host, cfg, p99["hist"], p99["ids"][:, 0]))
    n = BULK_CHECK_ROWS
    bulk_cpu = torch.sigmoid(recsys.bst_forward(host, cfg, bulk["hist"][:n], bulk["ids"][:n, 0]))
    ret_cpu = recsys.retrieval_scores(recsys.bst_user_embedding(host, cfg, user), cands.cpu())
    for name, (card, cpu) in {"serve_p99": (p99_card, p99_cpu), "serve_bulk": (bulk_prob[:n], bulk_cpu),
                              "retrieval_cand": (scores, ret_cpu)}.items():
        ok_c, gap = recsys_gap(card, cpu)
        checks[f"bst_{name}_equals_cpu"] = ok_c
        bst[name]["vs_cpu"] = gap
    del host, p99_cpu, bulk_cpu, ret_cpu, scores, bulk_prob, cands
    eb_ok, eb_rows, eb_bf16 = check_embedding_bag(model["item_table"], hist_bulk, dev)
    checks["embedding_bag_rows"] = eb_ok
    edges_ok, edges = check_embedding_bag_edges(dev)
    checks["embedding_bag_edges"] = edges_ok
    line.update({"bst": bst, "embedding_bag_bf16": eb_bf16, "embedding_bag_edges": edges,
                 "embedding_bag_ptxas": {**ptxas_entries("embedding_bag", "embedding_bag_vec16"),
                                         **ptxas_entries("embedding_bag", "embedding_bag_elem")}})
    del model, hist_bulk
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # DeepFM, AutoInt, DIEN at full width, serve_p99
    for name in ("deepfm", "autoint", "dien"):
        cfg = get_arch(name).make_config()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = getattr(recsys, f"{name}_init")(0, cfg)
        torch.cuda.synchronize()
        row = {"init_s": time.perf_counter() - t0, "params": sum(p.numel() for p in model.parameters()),
               "param_bytes": sum(p.numel() * p.element_size() for p in model.parameters())}
        if name == "dien":
            batch = ctr_batch(rng, RECSYS_P99, 1, np.asarray([cfg.item_vocab]), seq_len=cfg.seq_len)
            inputs = (batch["hist"], batch["ids"][:, 0])
        else:
            inputs = (ctr_batch(rng, RECSYS_P99, cfg.n_fields, np.asarray(cfg.vocab_sizes))["ids"],)
        fwd = getattr(recsys, f"{name}_forward")

        def serve_one():
            return torch.sigmoid(fwd(model, cfg, *inputs)).cpu()

        metrics.reset()
        ms, every = host_ms(serve_one, reps=30, warmup=3)
        row["serve_p99"] = {"batch": RECSYS_P99, "ms_median": ms, "ms_min": min(every), "ms_max": max(every),
                            "requests": len(every)}
        wall, busy, union, top = device_busy(serve_one)
        row["serve_p99"]["trace"] = {"wall_s": wall, "device_busy_s": busy, "device_busy_union_s": union,
                                     "idle_share": None if union is None else 1.0 - union / wall,
                                     "top_kernels": top}
        card = serve_one()
        host = copy.deepcopy(model).cpu()
        ok_c, gap = recsys_gap(card, torch.sigmoid(fwd(host, cfg, *inputs)))
        checks[f"{name}_serve_p99_equals_cpu"] = ok_c
        row["serve_p99"]["vs_cpu"] = gap
        line[name] = row
        del model, host
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    line["checks"] = checks
    line["seconds"] = time.perf_counter() - t_phase
    launches = {"embedding_bag": eb_launches, "embedding_bag_sum": eb_launches}
    eb_rows[1]["launches_note"] = ("a shape row of the same kernel, never launched on a path of its own: "
                                   "launches are the kernel's on the recsys path, as on the embedding_bag row")
    return all(checks.values()), line, eb_rows, launches


def check_row_popcount(slab):
    """``row_popcount`` on the main path's slab (pass 2's row counts)
    against its plain version, exactly; its time back to back and queued
    behind a sleep, and its byte bound (one read of the slab)."""
    import torch

    from repro_torch.kernels import cost
    from repro_torch.kernels.popcount import row_popcount
    from repro_torch.kernels.popcount.ref import row_popcount_ref

    r, w = slab.shape
    got, want = row_popcount(slab), row_popcount_ref(slab)
    b_ms, b_by = cost.row_popcount_cost(r, w).bound_ms()
    return {
        "name": "row_popcount", "shape": [r, w], "max_abs_err": int((got - want).abs().max()),
        "tolerance": "exact", "set_bits": int(want.sum(dtype=torch.int64)),
        "ms": time_ms(lambda: row_popcount(slab)), "device_ms": queued_ms(lambda: row_popcount(slab)),
        "plain_ms": time_ms(lambda: row_popcount_ref(slab), reps=3, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "ptxas": ptxas_entries("popcount", "row_popcount_kernel"),
    }


def knn_band_row(test, eps, tau, dev, block=2048):
    """``row_popcount`` with KNN-BLOCK's windows on one band slice, as
    ``knn_block_dbscan`` launches it at phase 11's setting: the middle
    block of sorted rows along the first projection against its band of
    columns (``_projection_order`` and ``_band``, the function's own),
    each row's window as its bit range; exact against the plain version,
    timed, and bound by one read of the words each row's window touches
    plus lo, hi and the counts."""
    import torch

    from repro_torch.core.baselines import _band, _projection_order
    from repro_torch.kernels.popcount import row_popcount
    from repro_torch.kernels.popcount.ref import row_popcount_ref
    from repro_torch.kernels.range_count import range_count_bitmap

    n = len(test)
    window = max(tau, int(0.3 * n / 2))
    order = np.ascontiguousarray(_projection_order(test, 6, 0)[:, 0])
    xs = torch.from_numpy(test[order]).to(dev)
    s = (n // 2) // block * block
    e = min(s + block, n)
    c0, c1, lo, hi = _band(s, e, n, window, dev)
    _, words = range_count_bitmap(xs[s:e], xs[c0:c1], eps)
    got, want = row_popcount(words, lo, hi), row_popcount_ref(words, lo, hi)
    r, w = words.shape
    touched = ((hi.long() + 31) // 32 - lo.long() // 32).clamp(min=0)  # words each window touches
    b_ms, b_by = bound_ms(4 * int(touched.sum()) + 12 * r)
    return {
        "name": "row_popcount_band", "shape": [r, w], "window": window, "columns": [c0, c1],
        "vec16": w % 4 == 0, "words_touched": int(touched.sum()),
        "max_abs_err": int((got - want).abs().max()), "tolerance": "exact",
        "ms": time_ms(lambda: row_popcount(words, lo, hi)),
        "device_ms": queued_ms(lambda: row_popcount(words, lo, hi)),
        "plain_ms": time_ms(lambda: row_popcount_ref(words, lo, hi), reps=3, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }


def baseline_methods(eps, tau):
    """Phase 11's calls: (function name, run(data, device)), at
    ``benchmarks/methods.py:50-53``'s settings for the two block methods
    and rho = 1 for both engines of rho-approximate DBSCAN."""
    from repro_torch.core.baselines import block_dbscan, knn_block_dbscan, rho_approx_dbscan

    return {
        "KNN-BLOCK": ("knn_block_dbscan", lambda x, d: knn_block_dbscan(
            x, eps, tau, n_proj=6, window=max(tau, int(0.3 * len(x) / 2)), seed=0, device=d)),
        "BLOCK-DBSCAN": ("block_dbscan", lambda x, d: block_dbscan(x, eps, tau, rnt=10, seed=0, device=d)),
        "rho-approx (cell)": ("rho_approx_dbscan", lambda x, d: rho_approx_dbscan(
            x, eps, tau, 1.0, engine="cell", device=d)),
        "rho-approx (direct)": ("rho_approx_dbscan", lambda x, d: rho_approx_dbscan(
            x, eps, tau, 1.0, engine="direct", device=d)),
    }


def same_result(a, b) -> bool:
    return bool(np.array_equal(a.labels, b.labels) and np.array_equal(a.core, b.core)
                and a.n_clusters == b.n_clusters and a.n_range_queries == b.n_range_queries
                and a.extras == b.extras)


def changed_rows(a, b):
    """Rows whose cluster differs between two labelings (as sets of rows,
    not ids: a merge renumbers every later cluster), noise included."""
    na, nb = np.bincount(a + 1), np.bincount(b + 1)
    pair = (a + 1).astype(np.int64) * (b.max() + 2) + (b + 1)
    _, inv, n_ab = np.unique(pair, return_inverse=True, return_counts=True)
    same = (na[a + 1] == n_ab[inv]) & (nb[b + 1] == n_ab[inv])
    return np.nonzero(((a < 0) != (b < 0)) | ((a >= 0) & ~same))[0]


def baseline_parity(name, run, x, eps, dev):
    """One baseline on the card against the same call on the CPU (the
    kernels' plain versions).  Where they differ, every pair whose hit
    differs between ``range_count_bitmap`` on the card and its plain
    version, at each threshold whose hits the method takes from the
    kernel (eps; eps(1 + rho) for rho-approx), is named with its
    |dot - threshold|.  The check holds only if ``n_range_queries`` and
    extras agree, every margin lies within ``FLIP_MARGIN``, every row
    whose core flag differs has a flipped pair in its own row, and every
    row whose cluster differs lies in a cluster (on the card or the CPU)
    that holds an end of a flipped pair: a difference that no flipped
    hit explains (the cover, the fp32 arg-maxes) fails."""
    import torch

    from repro_torch.kernels.range_count import range_count_bitmap, threshold
    from repro_torch.kernels.range_count.ref import range_count_bitmap_ref

    card, cpu = run(x, dev), run(x, "cpu")
    line = {"identical": same_result(card, cpu), "n_clusters": [card.n_clusters, cpu.n_clusters]}
    if line["identical"]:
        return True, line
    tests = {"eps": eps}
    if name.startswith("rho"):
        tests["eps_conn"] = min(2.0 * eps, 2.0)
    q = torch.from_numpy(x).to(dev)
    flips, margin, rows, ends = {}, 0.0, set(), set()
    for label, e in tests.items():
        pairs = flipped_pairs(range_count_bitmap(q, q, e)[1],
                              range_count_bitmap_ref(q.cpu(), q.cpu(), threshold(e))[1].to(dev))
        flips[label] = [[i, j, pair_margin([(i, j)], q, q, e)] for i, j in pairs]
        margin = max([margin] + [m for _, _, m in flips[label]])
        if label == "eps":
            rows = {i for i, _ in pairs}
        ends |= {k for p in pairs for k in p}
    core_diff = np.nonzero(card.core != cpu.core)[0]
    moved = changed_rows(card.labels, cpu.labels)
    touched_card = {card.labels[k] for k in ends} - {-1}
    touched_cpu = {cpu.labels[k] for k in ends} - {-1}
    unexplained_core = [int(k) for k in core_diff if k not in rows]
    unexplained_rows = [int(k) for k in moved
                        if card.labels[k] not in touched_card and cpu.labels[k] not in touched_cpu]
    line.update(label_diffs=int((card.labels != cpu.labels).sum()), rows_moved=len(moved),
                core_diffs=len(core_diff), flipped_pairs=flips, max_margin=margin, tolerance=FLIP_MARGIN,
                unexplained_core=unexplained_core[:20], unexplained_rows=unexplained_rows[:20])
    held = (card.n_range_queries == cpu.n_range_queries and card.extras == cpu.extras and margin <= FLIP_MARGIN
            and not unexplained_core and not unexplained_rows)
    return held, line


def baselines_phase(test, eps, tau, truth, dev):
    """Phase 11: the paper's baselines at the main path's operating point.
    Each method is warmed up once, then timed with the launch and host
    sync counts set to 0 just before and read just after; quality is ARI
    and AMI against phase 4's exact DBSCAN.  Then each on the card
    against the CPU on the split's first ``BASELINE_PARITY_ROWS`` rows,
    and ``row_popcount`` on one KNN-BLOCK band slice.  Returns (ok,
    method lines, rows by method, parity line, band kernel row)."""
    import torch

    from repro_torch.core.baselines import METRICS
    from repro_torch.core.metrics import adjusted_mutual_info, adjusted_rand_index
    from repro_torch.obs import metrics

    ok, lines, by = True, [], {}
    t_phase = time.perf_counter()
    for name, (fn_name, run) in baseline_methods(eps, tau).items():
        t_method = time.perf_counter()
        warm = run(test, dev)
        metrics.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = run(test, dev)
        elapsed = time.perf_counter() - t0  # the labels are host arrays: the device work is done
        snap = metrics.snapshot()
        lc = {k: snap.get(f"kernel.{k}.launches", 0) for k in ("range_count", "range_count_bitmap", "row_popcount")}
        row = {"elapsed_s": elapsed, "ari": adjusted_rand_index(r.labels, truth.labels),
               "ami": adjusted_mutual_info(r.labels, truth.labels), "n_range_queries": r.n_range_queries,
               "n_clusters": r.n_clusters, "noise_ratio": r.noise_ratio, "n_core": int(r.core.sum()),
               "extras": r.extras, "launches": lc, "host_syncs": snap.get(f"{METRICS[fn_name]}.host_syncs", 0),
               "phases_s": {k.split(".")[-1][:-2]: v for k, v in snap.items()
                            if k.startswith(f"{METRICS[fn_name]}.phase.")}}
        by[name] = row
        lines.append({"phase": "baselines", "method": name, "seconds": time.perf_counter() - t_method, **row})
        ok &= all(lc[k] > 0 for k in BASELINE_KERNELS[name]) and same_result(warm, r)
    parity, sub = {}, np.ascontiguousarray(test[:BASELINE_PARITY_ROWS])
    for name, (_, run) in baseline_methods(eps, tau).items():
        p_ok, parity[name] = baseline_parity(name, run, sub, eps, dev)
        ok &= p_ok
    band = knn_band_row(test, eps, tau, dev)
    ok &= band["max_abs_err"] == 0 and band["vec16"]
    parity_line = {"phase": "baselines", "seconds": time.perf_counter() - t_phase, "n": len(test),
                   "parity_rows": BASELINE_PARITY_ROWS, "parity": parity}
    return ok, lines, by, parity_line, band


def stream_state(s) -> dict:
    """A stream's labels, counts, core and owner (copies)."""
    n = s.state.n
    return {"labels": s.labels(), **{f: getattr(s.state, f)[:n].copy() for f in ("counts", "core", "owner")}}


def same_state(a, b) -> bool:
    return all(np.array_equal(a[k], b[k]) for k in ("labels", "counts", "core", "owner"))


def stream_batches(x):
    return [x[s : s + STREAM_BATCH] for s in range(0, len(x), STREAM_BATCH)]


def stream_run(s, batches, label, on_batch=None, profile_last=False):
    """Each batch through ``s.partial_fit``, one line a batch with its
    report and the deltas of the stream's host reads and
    ``packed_connectivity``'s launches and rounds; ``profile_last`` runs
    the last batch under the profiler (wall, device busy, idle share,
    top kernels)."""
    from repro_torch.obs import metrics

    keys = {"host_syncs": "stream.ingest.host_syncs", "connectivity_launches": "kernel.packed_connectivity.launches",
            "connectivity_rounds": "stream.ingest.connectivity_rounds"}
    lines = []
    for i, b in enumerate(batches):
        before = {k: metrics.counter(v).value for k, v in keys.items()}
        trace = {}
        if profile_last and i == len(batches) - 1:
            out = []
            wall, busy, union, top = device_busy(lambda: out.append(s.partial_fit(b)))
            rep = out[0]
            trace = {"trace": {"wall_s": wall, "device_busy_s": busy, "device_busy_union_s": union,
                               "idle_share": None if union is None else 1.0 - union / wall, "top_kernels": top}}
        else:
            rep = s.partial_fit(b)
        line = {"phase": "stream_batch", "stream": label, "batch": i, "rows": len(b), "elapsed_s": rep.elapsed_s,
                "rows_per_s": len(b) / rep.elapsed_s, "executed": rep.n_executed, "promoted": rep.n_promoted,
                "n_points": rep.n_points, "n_clusters": rep.n_clusters,
                **{k: metrics.counter(v).value - before[k] for k, v in keys.items()}, **trace}
        emit(line)
        lines.append(line)
        if on_batch is not None:
            on_batch(i, s)
    return lines


def blocks(n_rows: int, size: int) -> int:
    return -(-n_rows // size)


def connectivity_args(stream, rows, eps):
    """``packed_connectivity``'s operands for the stream's block of
    ``rows``, as ``apply_core_rows_packed`` builds them: the alive-masked
    packed slab of their hits, the rows, their core flags, the core
    columns."""
    import torch

    st, dev = stream.state, stream.backend.device
    slab = st.mask_packed(stream.backend.query_packed_device(rows, eps))
    return (slab, torch.from_numpy(rows).to(dev), torch.from_numpy(st.core[rows]).to(dev),
            torch.from_numpy(st.core[: st.n]).to(dev))


CONN_PHASES = ("k2", "k3", "update")  # the steps of a packed_connectivity round, split by grid barriers


def connectivity_split(args, reps: int = 5) -> dict:
    """Where ``packed_connectivity``'s time goes on ``args``: its probe
    build (``stamps``) records ``%globaltimer`` as each block enters and
    as it leaves each step of each round.  For each round and step,
    ``span_us`` is the last block's exit less the last block's exit of
    the step before (the barrier's latency included) and ``wait_us`` the
    last block's exit less the median block's (how long half the blocks
    idle at the barrier); medians over ``reps`` launches after one
    warm-up.  Also the grid (blocks, blocks an SM, K2's and K3's row
    chunks), and the stamped launch from the first block's entry to the
    last block's exit."""
    import torch

    from repro_torch.kernels.label_prop import packed_connectivity
    from repro_torch.kernels.label_prop.ops import connectivity_grid

    r, w = args[0].shape
    blocks, per_sm, chunk2, chunk3 = connectivity_grid(r, w)
    max_iters = 64
    runs = []
    for _ in range(reps + 1):
        st = torch.zeros((1 + 3 * max_iters, blocks), dtype=torch.int64, device=args[0].device)
        rounds = packed_connectivity(*args, max_iters=max_iters, stamps=st)[3]
        runs.append((st.cpu().numpy().astype(np.float64), int(rounds)))
    runs = runs[1:]
    rounds = runs[0][1]
    split = []
    for it in range(rounds):
        for ph, name in enumerate(CONN_PHASES):
            slot = 1 + 3 * it + ph
            split.append({"round": it, "step": name,
                          "span_us": float(np.median([(st[slot].max() - st[slot - 1].max()) / 1e3 for st, _ in runs])),
                          "wait_us": float(np.median([(st[slot].max() - np.median(st[slot])) / 1e3
                                                      for st, _ in runs]))})
    return {"blocks": blocks, "blocks_per_sm": per_sm, "chunk_rows": [chunk2, chunk3], "rounds": rounds,
            "split": split,
            "stamped_us": float(np.median([(st[3 * rounds].max() - st[0].min()) / 1e3 for st, _ in runs])),
            "entry_spread_us": float(np.median([(st[0].max() - st[0].min()) / 1e3 for st, _ in runs]))}


def connectivity_row(stream, rows, eps):
    """``packed_connectivity`` (the connectivity mode's one cooperative
    launch, whose round 0 also yields the owner and row_first) against
    ``packed_connectivity_ref`` on one RP block slab of the stream,
    exactly: comp, owner, row_first, rounds."""
    from repro_torch.kernels.label_prop import packed_connectivity
    from repro_torch.kernels.label_prop.ref import packed_connectivity_ref

    st = stream.state
    args = connectivity_args(stream, rows, eps)
    slab = args[0]
    got = packed_connectivity(*args)
    want = packed_connectivity_ref(*args)
    err = max(int((a.long() - b.long()).abs().max()) if a.numel() else 0 for a, b in zip(got, want))
    r, w = slab.shape
    rounds, cap, rc = int(got[3]), 32 * w, int(st.core[rows].sum())

    def k2(n_rows):
        return 4 * (n_rows * w + 32 * w + 2 * n_rows)

    def k3(n_rows):
        return 4 * (n_rows * w + 2 * n_rows + 64 * w)

    b_ms, b_by = bound_ms(rounds * (k2(r) + k3(r) + 4 * 4 * cap) + 4 * (r + cap))
    # what the function needs: K3 and the later rounds' K2 read the core rows only
    core_ms, _ = bound_ms(k2(r) + k3(rc) + (rounds - 1) * (k2(rc) + k3(rc)) + rounds * 4 * 4 * cap + 4 * (r + cap))
    _, _, _, top = device_busy(lambda: packed_connectivity(*args), top=6)
    return {
        "name": "packed_connectivity", "shape": [r, w], **slab_stats(slab), "rounds": rounds,
        "n_core_rows": rc, "max_abs_err": err,
        "tolerance": "exact: comp, owner, row_first, rounds",
        "ms": time_ms(lambda: packed_connectivity(*args)), "device_ms": queued_ms(lambda: packed_connectivity(*args)),
        "plain_ms": time_ms(lambda: packed_connectivity_ref(*args), reps=2, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "bound_note": "rounds x (K2 4(RW + 32W + 2R) + K3 4(RW + 2R + 64W) + update 4 x 4 x 32W) "
                      "+ 4(R + 32W): the owner's row indices read and its minimum written, once",
        "bound_core_rows_ms": core_ms,
        "bound_core_rows_note": "the same with K3 and rounds >= 1's K2 over the core rows only (round 0's K2, "
                                "row_first, over every row): the bytes this block's data needs",
        "ptxas": ptxas_entries("label_prop", "packed_connectivity_kernel"),
        "top_kernels": top,
        **connectivity_split(args),
    }


def stream_phase(data, test, truth, eps, tau, dev):
    """Phase 12: the exact stream, the RP stream and the
    ``packed_connectivity`` row on one of its blocks, serve, durable and
    evict.  Returns (ok, stream line, kernel row, launches of the RP
    stream)."""
    import torch

    from repro_torch import obs
    from repro_torch.core.dbscan import dbscan_parallel
    from repro_torch.core.laf_dbscan import laf_dbscan
    from repro_torch.core.metrics import adjusted_rand_index
    from repro_torch.data.synthetic import train_test_split
    from repro_torch.index.random_projection import RandomProjectionBackend
    from repro_torch.obs import metrics
    from repro_torch.stream import DurableStream, StreamingLAF

    t_phase = time.perf_counter()
    line, checks, degraded = {"phase": "stream", "batch_rows": STREAM_BATCH}, {}, 0
    batches = stream_batches(test)

    # the exact stream, held to exact DBSCAN of the split
    metrics.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ex = StreamingLAF(eps, tau, backend="exact", device=dev)
    at5 = {}
    ex_lines = stream_run(ex, batches, "exact", lambda i, s: at5.update(stream_state(s)) if i == 4 else None)
    snap = metrics.snapshot()
    ex_state = stream_state(ex)
    checks["exact_equals_dbscan"] = bool(np.array_equal(ex_state["labels"], truth.labels)
                                         and np.array_equal(ex_state["core"], truth.core))
    checks["exact_launches"] = snap.get("kernel.range_count_bitmap.launches", 0) > 0
    degraded += snap.get("stream.degraded.events", 0)
    line["exact"] = {"seconds": time.perf_counter() - t0, "n_clusters": ex.n_clusters,
                     "host_syncs": snap.get("stream.ingest.host_syncs", 0),
                     "range_count_bitmap_launches": snap.get("kernel.range_count_bitmap.launches", 0),
                     "rows_per_s": len(test) / sum(b["elapsed_s"] for b in ex_lines)}

    # the RP stream: warm start from the fitted train rows, then the split
    train, test2 = train_test_split(data, 0.8, 0)
    checks["split_is_phase_1s"] = bool(np.array_equal(test2, test))
    t0 = time.perf_counter()
    bk = RandomProjectionBackend(device=dev, n_bits=512, margin=3.0).fit(train)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    metrics.reset()
    t0 = time.perf_counter()
    rp = StreamingLAF(eps, tau, backend=bk)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm = metrics.snapshot()
    rp_lines = stream_run(rp, batches, "random_projection", profile_last=True)
    snap = metrics.snapshot()
    launches = {k: snap.get(f"kernel.{k}.launches", 0) for k in STREAM_RP_KERNELS}
    degraded += snap.get("stream.degraded.events", 0)
    sweep_blocks = blocks(len(train), rp.block_size) + sum(blocks(b["executed"], rp.block_size) for b in rp_lines)
    promo_blocks = sum(blocks(b["promoted"], rp.block_size) for b in rp_lines)
    syncs = snap.get("stream.ingest.host_syncs", 0)
    checks["rp_launches"] = all(v > 0 for v in launches.values())
    checks["rp_one_connectivity_launch_a_block"] = launches["packed_connectivity"] == sweep_blocks + promo_blocks
    checks["rp_host_syncs"] = syncs == 2 * sweep_blocks + promo_blocks
    t0 = time.perf_counter()
    allx = np.concatenate([train, test])
    batch = laf_dbscan(allx, eps, tau, 1.0, np.full(len(allx), np.inf),
                       backend=RandomProjectionBackend(device=dev, n_bits=512, margin=3.0), cluster_device=True)
    batch_s = time.perf_counter() - t0
    rp_labels = rp.labels()
    ari = adjusted_rand_index(rp_labels, batch.labels)
    checks["rp_ari"] = ari >= 0.99
    line["random_projection"] = {
        "fit_s": fit_s, "warm_start_s": warm_s, "warm_rows": len(train),
        "warm_host_syncs": warm.get("stream.ingest.host_syncs", 0),
        "warm_connectivity_launches": warm.get("kernel.packed_connectivity.launches", 0),
        "warm_connectivity_rounds": warm.get("stream.ingest.connectivity_rounds", 0),
        "stream_rows_per_s": len(test) / sum(b["elapsed_s"] for b in rp_lines),
        "n_points": rp.n_points, "n_clusters": rp.n_clusters, "words": -(-rp.n_points // 32),
        "launches": launches, "host_syncs": syncs, "sweep_blocks": sweep_blocks, "promotion_blocks": promo_blocks,
        "reference_host_reads": sweep_blocks + 2 * promo_blocks + sweep_blocks,
        "connectivity_rounds": snap.get("stream.ingest.connectivity_rounds", 0),
        "batch_run": "laf_dbscan, every point executed, device pass", "batch_s": batch_s,
        "batch_n_clusters": batch.n_clusters, "ari_vs_batch": ari,
        "labels_differing": int((rp_labels != batch.labels).sum()),
        "core_differing": int((rp.state.core[: rp.n_points] != batch.core).sum())}
    del batch
    # the kernel row on one block of the stream: the last full batch's rows
    # (the 7th at the ms-150k split)
    end = rp.n_points - len(batches[-1])
    kernel_row = connectivity_row(rp, np.arange(end - STREAM_BATCH, end), eps)
    checks["connectivity_kernel_exact"] = kernel_row["max_abs_err"] == 0

    # serve: perturbed database rows through the engine and the host oracle
    metrics.reset()
    rng = np.random.default_rng(7)
    pick = rng.choice(rp.n_points, SERVE_QUERIES, replace=False)
    q = rp.backend.data[pick] + (0.01 / np.sqrt(data.shape[1])) * rng.standard_normal(
        (SERVE_QUERIES, data.shape[1])).astype(np.float32)
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    t0 = time.perf_counter()
    snap_idx = rp.snapshot()
    build_s = time.perf_counter() - t0
    snap_idx.assign(q[:8])  # first use
    t0 = time.perf_counter()
    eng = snap_idx.assign(q)
    bulk_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = snap_idx.assign(q, oracle=True)
    oracle_s = time.perf_counter() - t0
    lat = []
    for i in range(SERVE_SINGLE_CALLS):
        t1 = time.perf_counter()
        snap_idx.assign(q[i : i + 1])
        lat.append(time.perf_counter() - t1)
    checks["serve_engine_equals_oracle"] = all(
        np.array_equal(getattr(eng, f), getattr(host, f)) for f in ("labels", "confidence", "n_hits"))
    snap = metrics.snapshot()
    degraded += snap.get("stream.degraded.events", 0)
    line["serve"] = {"queries": SERVE_QUERIES, "snapshot_build_s": build_s, "bulk_s": bulk_s, "oracle_s": oracle_s,
                     "single_p50_ms": 1e3 * float(np.percentile(lat, 50)),
                     "single_p99_ms": 1e3 * float(np.percentile(lat, 99)),
                     "agree_with_stream_labels": float(np.mean(eng.labels == rp_labels[pick])),
                     "noise": int((eng.labels < 0).sum()), "verify_launches": snap.get("serve.verify_launches", 0),
                     "hamming_filter_launches": snap.get("kernel.hamming_filter.launches", 0)}
    checks["serve_launches"] = line["serve"]["hamming_filter_launches"] > 0
    del rp, bk, snap_idx

    # durable: dropped after batch 5, then recovered
    metrics.reset()
    obs.enable(trace=True, metrics_on=True)
    obs.clear_trace()

    def factory():
        return StreamingLAF(eps, tau, backend="exact", device=dev)

    with tempfile.TemporaryDirectory() as td:
        d = DurableStream(factory(), td, snapshot_every=3, fsync=True)
        for b in batches[:5]:
            d.partial_fit(b)
        snap_s = [r.dur for r in obs.spans("durability.snapshot")]
        d2 = DurableStream.recover(td, factory, fsync=True)  # d is dropped: no close
        info = d2.recovery_info
        checks["durable_after_batch_5"] = same_state(stream_state(d2.stream), at5)
        for b in batches[5:]:
            d2.partial_fit(b)
        checks["durable_after_all"] = same_state(stream_state(d2.stream), ex_state)
        d2.close()
        d.close()
    obs.enable(trace=False, metrics_on=True)
    snap = metrics.snapshot()
    degraded += snap.get("stream.degraded.events", 0)
    line["durable"] = {"snapshot_every": 3, "fsync": True, "snapshot_s": snap_s, "recovered_seq": info["seq"],
                       "snapshot_step": info["snapshot_step"], "restore_s": info["restore_s"],
                       "replay_s": info["replay_s"], "recovery_s": info["recovery_s"],
                       "wal_rows": info["wal_rows"], "wal_replay_rows_per_s": info["wal_rows"] / info["replay_s"]}

    # evict: 5% of the exact stream's rows, a core among them
    metrics.reset()
    rng = np.random.default_rng(11)
    n = ex.n_points
    idx = np.sort(rng.choice(n, int(EVICT_FRAC * n), replace=False))
    t0 = time.perf_counter()
    rebuilt = ex.evict(idx)
    evict_s = time.perf_counter() - t0
    live = np.setdiff1d(np.arange(n), idx)
    ref = dbscan_parallel(test[live], eps, tau, backend="exact", device=dev)
    snap = metrics.snapshot()
    degraded += snap.get("stream.degraded.events", 0)
    checks["evict_kills_a_core"] = bool(ex_state["core"][idx].any())
    checks["evict_rebuilds_once"] = bool(rebuilt) and snap.get("stream.rebuilds", 0) == 1
    checks["evict_equals_dbscan"] = bool(np.array_equal(ex.labels(), ref.labels))
    line["evict"] = {"evicted": len(idx), "cores_evicted": int(ex_state["core"][idx].sum()), "evict_s": evict_s,
                     "rebuilds": snap.get("stream.rebuilds", 0),
                     "rebuilds_core_death": snap.get("stream.rebuilds.core_death", 0),
                     "n_points": ex.n_points, "n_clusters": ex.n_clusters}

    line["degraded_events"] = degraded
    checks["no_degraded_events"] = degraded == 0
    line["checks"] = checks
    line["seconds"] = time.perf_counter() - t_phase
    return all(checks.values()), line, kernel_row, launches


def evaluation_line(by_method, main, baselines):
    """Every method of the paper's Fig. 1 and Table 3 at the main path's
    operating point: time, speedup over exact DBSCAN, ARI and AMI against
    it, range queries; and Table 4's rho-approx (cell) / DBSCAN time."""
    t_db = by_method["DBSCAN"]["elapsed_s"]
    rows = {f"{k} (exact backend)": v for k, v in by_method.items()}
    rows["LAF-DBSCAN (random projection, main path)"] = main
    rows.update(baselines)
    return {"phase": "evaluation", "dbscan_s": t_db,
            "methods": {k: {"time_s": v["elapsed_s"], "speedup_vs_dbscan": t_db / v["elapsed_s"], "ari": v["ari"],
                            "ami": v["ami"], "queries": v["n_range_queries"]} for k, v in rows.items()},
            "table4_rho_cell_over_dbscan": baselines["rho-approx (cell)"]["elapsed_s"] / t_db}


# phase 13: the rest of the LM zoo, one card each, bf16, weights drawn by
# transformer_init(0, cfg) on the card; depth cut where the weights would
# not fit (grok-1: 4 of 64 layers, 39.7 GiB; deepseek-v2: 5 of 60, 1 dense
# prefix + 4 MoE, 32.2 GiB); prefill 2 x 4096 and decode prompts cut
# from prefill_32k / decode_32k.  gemma3-27b's prompt fills its rings by
# the windowed prefill up to ZOO_RING_FILL and goes on a step each past
# the ring's edge (1,152 prompt steps at full depth took 147-173 s,
# host-bound)
ZOO_PREFILL = (2, 4096)
ZOO_CELLS = {
    # name: (layers kept or None, decode prompt tokens, greedy tokens, windowed decode)
    "gemma3-27b": (None, 1152, 32, True),
    "granite-20b": (None, 256, 32, False),
    "grok-1-314b": (4, 256, 32, False),
    "deepseek-v2-236b": (5, 256, 32, False),
}
ZOO_RING_FILL = 1008    # windowed decode: prompt tokens through transformer_prefill_windowed (16 short of the ring)
ZOO_MOE_TOKENS = 1024   # one MoE layer's tokens, bf16 against fp32 expert GEMMs
PREFILL_TRIES = 8       # prompt positions, from the last back, for decode == prefill (MoE route flips)


class route_log:
    """Records the experts of every ``moe_apply`` call inside a ``with``
    block: each call's (G, Tg, k) indices, sorted within the k, by
    wrapping ``repro_torch.models.moe.route`` (this script's
    instrumentation; the module is restored on exit)."""

    def __enter__(self):
        from repro_torch.models import moe

        self.calls, self._moe, self._route = [], moe, moe.route

        def wrapped(router, cfg, xg):
            out = self._route(router, cfg, xg)
            self.calls.append(out[2].sort(dim=-1).values)
            return out

        moe.route = wrapped
        return self

    def __exit__(self, *exc):
        self._moe.route = self._route


def masked_gap(got, want, keep):
    """``logit_gap`` over the rows (batch, position) that ``keep`` marks."""
    return logit_gap(got[keep], want[keep]) if bool(keep.any()) else (0.0, 0.0)


def ring_checks(cache, cfg, steps, dev):
    """The decode mapping on the path's own filled caches against the
    plain version on the same slots: a local layer's ring (its valid
    prefix, unmasked, as ``_windowed_decode_layer`` passes it) and a
    global layer's prefix (causal, as ``_gqa_decode_layer`` passes it).
    Returns (ok, rows)."""
    import torch

    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models.layers import blockwise_attention

    g = torch.Generator(device=dev).manual_seed(5)
    b = cache["loc_k"].shape[2] if "loc_k" in cache else cache["k"].shape[1]
    q = torch.randn((b, cfg.n_heads, 1, cfg.d_head), generator=g, device=dev).to(cfg.dtype)
    ok, rows = True, []
    if "loc_k" in cache:
        pairs = [("ring", cache["loc_k"][0, 0], cache["loc_v"][0, 0]),
                 ("global", cache["glob_k"][0], cache["glob_v"][0])]
        if len(cache["suf_k"]):
            pairs.append(("suffix_ring", cache["suf_k"][-1], cache["suf_v"][-1]))
    else:
        pairs = [("layer_0", cache["k"][0], cache["v"][0]), ("layer_last", cache["k"][-1], cache["v"][-1])]
    for name, kc, vc in pairs:
        ring = name.endswith("ring")
        for n in ((kc.shape[2],) if ring else (1, 77, steps)):
            if ring:
                out = blockwise_attention(q, kc, vc, causal=False, valid_len=n)
                ref = attention_ref(q, kc[:, :, :n], vc[:, :, :n])
            else:
                out = blockwise_attention(q, kc, vc, causal=True, q_offset=n - 1, valid_len=n)
                ref = attention_ref(q, kc[:, :, :n], vc[:, :, :n], causal=True)
            ok_n, gap = flash_gap(out, ref)
            gap.pop("tolerance")
            ok &= ok_n
            rows.append({"cache": name, "slots": n, **gap})
    return ok, rows


def moe_precision(model, cfg, dev):
    """One MoE layer (the first) on ``ZOO_MOE_TOKENS`` normal hidden rows:
    the port's bf16 expert GEMMs against the same layer with its expert
    weights in fp32 (the reference's arithmetic: fp32 products and sums;
    the shared expert, bf16 in both packages, unchanged); the routes of
    the fp32 router against an fp64 one (ties go to the lower expert in
    both).  Returns the line's fields."""
    import torch

    from repro_torch.models.moe import moe_apply, route

    p = model.layers[0]["moe"]
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn((ZOO_MOE_TOKENS, cfg.d_model), generator=g, device=dev).to(cfg.dtype)
    out, aux = moe_apply(p, cfg.moe, x)
    p32 = {k: (v.float() if k in ("wi_gate", "wi_up", "wo") else v) for k, v in p.items()}
    ref, aux32 = moe_apply(p32, cfg.moe, x)
    del p32
    rel, mx = logit_gap(out, ref)
    _, _, idx = route(p["router"], cfg.moe, x[None])
    _, _, idx64 = route(p["router"].double(), cfg.moe, x[None].double())
    torch.cuda.empty_cache()
    return {"tokens": ZOO_MOE_TOKENS, "rel_l2": rel, "max_abs": mx, "out_rms": float(ref.pow(2).mean().sqrt()),
            "bf16_reduced_precision_reduction": torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
            "drop_fraction": float(aux["drop_fraction"]), "drop_fraction_fp32": float(aux32["drop_fraction"]),
            "routes_differ_vs_fp64_router": int((idx != idx64).sum()), "routes": idx.numel(),
            "ok": rel <= LM_REL_L2 and mx <= LM_MAX_ABS and bool(torch.isfinite(out).all())}


def zoo_model(name, dev):
    """One cell of phase 13: the config at full width (depth cut as
    ``ZOO_CELLS`` says), prefill of ``ZOO_PREFILL`` tokens (warmed, then
    timed; MoE: each layer's drop fraction at the published capacity),
    then a prompt fed a token a step (gemma3: ``make_cache_windowed``'s
    rings, its first ``ZOO_RING_FILL`` tokens through
    ``transformer_prefill_windowed``, then steps past the ring's edge)
    and greedy tokens, each path with the launch count
    set to 0 just before it and read just after; decode against prefill
    at the last prompt position and against forward at 16 positions
    (MoE models decode and run these checks at the no-drop capacity
    ``n_experts / top_k``: a dropped entry makes forward differ from
    decode, as the reference's tests note); the decode kernel on the
    filled caches against the plain version; a profiled decode step;
    MoE: ``moe_precision``.  The weights are freed before it returns.
    Returns (ok, line, launches by path)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import token_stream
    from repro_torch.models import transformer as tt
    from repro_torch.obs import metrics

    counter = "kernel.flash_attention.launches"
    t_model = time.perf_counter()
    depth, n_prompt, n_new, windowed = ZOO_CELLS[name]
    cfg = get_arch(name).make_config()
    full_layers = cfg.n_layers
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = tt.transformer_init(0, cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    line = {"phase": "lm_zoo", "arch": name, "dtype": str(cfg.dtype), "n_layers": cfg.n_layers,
            "published_layers": full_layers, "params": n_params,
            "param_bytes": sum(p.numel() * p.element_size() for p in model.parameters()), "init_s": init_s}
    toks, _ = token_stream(np.random.default_rng(0), *ZOO_PREFILL, cfg.vocab)
    toks = torch.from_numpy(toks).to(dev)

    # prefill at the published capacity: warm once, then one timed call
    tt.transformer_prefill(model, cfg, toks)
    metrics.reset()
    aux = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pre = tt.transformer_prefill(model, cfg, toks, moe_aux=aux)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = metrics.snapshot().get(counter, 0)
    finite = bool(torch.isfinite(pre).all())
    # bounds of the weights' work alone (attention's left out): a prefill
    # token multiplies every active non-embedding weight once (2 FLOP
    # each; lm_head only at the last position), a decode step reads every
    # weight but the embedding table once (MoE at capacity 8 runs every
    # expert)
    embed = cfg.vocab * cfg.d_model
    weight_flops = 2.0 * ZOO_PREFILL[0] * (ZOO_PREFILL[1] * (cfg.active_param_count() - 2 * embed) + embed)
    line.update({"prefill_weight_bound_s": weight_flops / BF16_FLOPS,
                 "step_bytes_bound_ms": 1e3 * (line["param_bytes"] - embed * model.embed.element_size())
                 / HBM_BYTES_PER_S})
    line.update({"prefill_shape": list(ZOO_PREFILL), "prefill_s": prefill_s,
                 "prefill_tokens_per_s": ZOO_PREFILL[0] * ZOO_PREFILL[1] / prefill_s,
                 "prefill_launches": prefill_launches, "prefill_peak_mem_bytes": torch.cuda.max_memory_allocated()})
    if cfg.moe is not None:
        line["prefill_capacity_factor"] = cfg.moe.capacity_factor
        line["prefill_drop_fraction_by_layer"] = [float(a["drop_fraction"]) for a in aux]
    del pre, aux

    # decode: the prompt token by token (teacher-forced), then greedy
    dcfg = cfg if cfg.moe is None else dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    b, steps = ZOO_PREFILL[0], n_prompt + n_new
    prompt = toks[:, :n_prompt].contiguous()
    del toks
    step = tt.transformer_decode_step_windowed if windowed else tt.transformer_decode_step
    cache = (tt.make_cache_windowed if windowed else tt.make_cache)(dcfg, b, steps)
    fill = ZOO_RING_FILL if windowed else 0
    if windowed:  # 16 positions from the first stepped one on, 1,023, 1,024 and the last among them
        extras = {cfg.window - 1, cfg.window, n_prompt - 1}
        check_at = sorted(extras | {int(t) for t in np.linspace(fill, n_prompt - 1, 16 - len(extras))})
    else:
        check_at = sorted(set(range(n_prompt // 16 - 1, n_prompt, n_prompt // 16)))[-16:]
    saved, step_s, step_launches, generated = {}, [], [], []
    n_moe = 0 if cfg.moe is None else cfg.n_layers - cfg.n_dense_layers
    fill_s, fill_launches = 0.0, 0
    if fill:
        metrics.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, cache = tt.transformer_prefill_windowed(model, dcfg, prompt[:, :fill], cache)
        torch.cuda.synchronize()
        fill_s = time.perf_counter() - t0
        fill_launches = metrics.snapshot().get(counter, 0)
    metrics.reset()
    torch.cuda.synchronize()
    with route_log() as dec_log:
        t0 = time.perf_counter()
        for t in range(fill, n_prompt):
            logits, cache = step(model, dcfg, prompt[:, t : t + 1], cache, t)
            if t in check_at or t >= n_prompt - PREFILL_TRIES:
                saved[t] = logits.float()
        torch.cuda.synchronize()
        prompt_s = time.perf_counter() - t0
        tok = logits.argmax(-1, keepdim=True)
        for t in range(n_prompt, steps):
            generated.append(tok)
            before = metrics.snapshot().get(counter, 0)
            t0 = time.perf_counter()
            logits, cache = step(model, dcfg, tok, cache, t)
            tok = logits.argmax(-1, keepdim=True)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            step_launches.append(metrics.snapshot().get(counter, 0) - before)
    decode_launches = metrics.snapshot().get(counter, 0)
    finite &= bool(torch.isfinite(logits).all())
    step_ms = 1e3 * float(np.median(step_s))
    # flash_attention calls a step: one a GQA layer; MLA's absorbed decode calls none
    per_step = 0 if cfg.attention == "mla" else cfg.n_layers
    line.update({"decode_batch": b, "cache_len": steps, "prompt_steps": n_prompt - fill, "greedy_steps": n_new,
                 "prompt_filled": fill, "fill_s": fill_s, "fill_launches": fill_launches,
                 "decode": "transformer_decode_step_windowed" if windowed else "transformer_decode_step",
                 "decode_capacity_factor": None if cfg.moe is None else dcfg.moe.capacity_factor,
                 "prompt_s": prompt_s, "prompt_ms_per_step": 1e3 * prompt_s / (n_prompt - fill),
                 "step_ms_median": step_ms, "step_ms_min": 1e3 * min(step_s), "step_ms_max": 1e3 * max(step_s),
                 "decode_tokens_per_s": b / (step_ms / 1e3), "decode_launches": decode_launches,
                 "launches_per_step": sorted(set(step_launches)), "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    if windowed:
        line["ring_slots"] = int(cache["loc_k"].shape[-2])
        line["ring_launches_per_step"] = sum(not cfg.layer_is_global(i) for i in range(cfg.n_layers))

    # checks: decode == prefill at the last prompt position, decode ==
    # forward at 16 positions, the greedy tokens against forward.  MoE in
    # bf16: where a token's experts differ between the decode step and
    # the full-sequence pass (a route flip: the router sees inputs one
    # rounding apart near a tie), its logits differ by the experts'
    # outputs, not by rounding; such rows are counted and left out of
    # the gap, and at least half the rows must remain.  Where every row
    # of the last prompt position flipped, the prefill check steps back
    # to the last prompt position (of PREFILL_TRIES) whose routes agree
    n_moe_calls = len(dec_log.calls)
    for t_pre in range(n_prompt - 1, n_prompt - 1 - PREFILL_TRIES, -1):
        with torch.inference_mode(), route_log() as pre_log:
            pre = tt.transformer_prefill(model, dcfg, prompt[:, : t_pre + 1])
        flip_pre = torch.zeros((b,), dtype=torch.bool, device=dev)
        if n_moe:
            dec_t = torch.stack(dec_log.calls).view(steps, n_moe, b, -1)[t_pre]             # (L, B, k)
            pre_t = torch.stack(pre_log.calls).view(n_moe, b, t_pre + 1, -1)[:, :, -1]
            flip_pre = (dec_t != pre_t).any(-1).any(0)                                       # (B,)
        if not bool(flip_pre.all()):
            break
    gen = torch.cat(generated, dim=1)
    with torch.inference_mode(), route_log() as fwd_log:
        fwd = tt.transformer_forward(model, dcfg, torch.cat([prompt, gen[:, :-1]], dim=1))
    flips = torch.zeros((b, steps - 1), dtype=torch.bool, device=dev)
    if n_moe:
        assert n_moe_calls == steps * n_moe
        dec_r = torch.stack(dec_log.calls).view(steps, n_moe, b, -1)[: steps - 1]   # (T, L, B, k)
        fwd_r = torch.stack(fwd_log.calls).view(n_moe, b, steps - 1, -1).permute(2, 0, 1, 3)
        flips = (dec_r != fwd_r).any(-1).any(1).T                                     # (B, T)
    keep_at = ~flips[:, check_at]
    rel_a, abs_a = masked_gap(saved[t_pre], pre, ~flip_pre)
    fwd_at = fwd[:, check_at].float()
    dec_at = torch.stack([saved[t] for t in check_at], dim=1)
    rel_b, abs_b = masked_gap(dec_at, fwd_at, keep_at)
    greedy_fwd = fwd[:, n_prompt - 1 :].argmax(-1)
    finite &= bool(torch.isfinite(pre).all()) and bool(torch.isfinite(fwd).all())
    kern_ok, kern_rows = (True, []) if cfg.attention == "mla" else ring_checks(cache, cfg, steps, dev)
    checks = {
        "prefill_launches": prefill_launches == cfg.n_layers,
        "launches_per_step": set(step_launches) == {per_step},
        "decode_launches": decode_launches == per_step * (steps - fill),
        "fill_launches": fill_launches == (cfg.n_layers if fill else 0),
        "decode_equals_prefill": rel_a <= LM_REL_L2 and abs_a <= LM_MAX_ABS and not bool(flip_pre.all()),
        "decode_equals_forward": (rel_b <= LM_REL_L2 and abs_b <= LM_MAX_ABS
                                  and 2 * int(keep_at.sum()) >= keep_at.numel()),
        "decode_kernel_on_cache": kern_ok,
        "finite": finite,
    }
    line.update({
        "tolerance": f"rel L2 <= {LM_REL_L2} and max |diff| <= {LM_MAX_ABS} (fp32 compare of bf16 logits)",
        "decode_vs_prefill": {"position": t_pre, "rel_l2": rel_a, "max_abs": abs_a,
                              "logit_max_abs": float(pre.float().abs().max()),
                              "rows_with_route_flips": int(flip_pre.sum())},
        "decode_vs_forward": {"positions": check_at, "rel_l2": rel_b, "max_abs": abs_b,
                              "rows_compared": int(keep_at.sum()), "rows": keep_at.numel(),
                              "all_rows": dict(zip(("rel_l2", "max_abs"), logit_gap(dec_at, fwd_at)))},
        "route_flips_vs_forward": {"positions": int(flips.sum()), "of": flips.numel()} if n_moe else None,
        "argmax_differs_vs_forward": int((dec_at.argmax(-1) != fwd_at.argmax(-1)).sum()),
        "greedy_tokens_differ_vs_forward": int((greedy_fwd != gen).sum()), "greedy_tokens": gen.numel(),
        "decode_kernel_on_cache": {"tolerance": FLASH_TOL, "rows": kern_rows},
    })
    del pre, fwd, fwd_at, dec_at, saved
    wall, busy, union, top = device_busy(lambda: step(model, dcfg, tok, cache, steps - 1))
    line["decode_step_trace"] = {"wall_s": wall, "device_busy_s": busy, "device_busy_union_s": union,
                                 "idle_share": None if union is None else 1.0 - union / wall, "top_kernels": top}
    del cache, logits
    torch.cuda.empty_cache()
    if cfg.moe is not None:
        line["moe_bf16_vs_fp32_experts"] = mp = moe_precision(model, cfg, dev)
        checks["moe_bf16_vs_fp32_experts"] = mp["ok"]
    line["checks"] = checks
    del model
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    line["seconds"] = time.perf_counter() - t_model
    return all(checks.values()), line, {"prefill": prefill_launches, "decode": decode_launches}


def lm_zoo(dev):
    """Phase 13: ``zoo_model`` for each of ``ZOO_CELLS`` in turn (each
    model freed before the next loads).  Returns (ok, lines, launches by
    kernel row, phase seconds)."""
    t_phase = time.perf_counter()
    ok, lines, by = True, [], {}
    for name in ZOO_CELLS:
        m_ok, line, launches = zoo_model(name, dev)
        ok &= m_ok
        lines.append(line)
        by[name] = launches
    launches = {"flash_attention_d192": by["deepseek-v2-236b"]["prefill"],
                "flash_attention_decode_ring": by["gemma3-27b"]["decode"],
                "flash_attention_decode_mqa": by["granite-20b"]["decode"]}
    return ok, lines, launches, time.perf_counter() - t_phase


def check_zoo_flash(zoo_launches):
    """The phase-13 kernel rows, each against its plain version in bf16
    with its time back to back and queued, the plain version's, the
    library's and its bound: ``flash_attention_d192`` (deepseek-v2's
    prefill: B 2, H 128, S 4096, the (192, 128) pair, v drawn at 128; the
    bound is the unpadded 2 (192 + 128) FLOP a pair, the two-term floor
    2 (192 + 2 x 128) beside it; the library the faster SDPA, v at 128 or
    padded to 192; ptxas's registers and spills of every 192
    instantiation), ``flash_attention_decode_ring`` (gemma3's
    full 1,024-slot ring, B 2, Hq 32, Hkv 16, unmasked) and
    ``flash_attention_decode_mqa`` (granite's filled cache: B 2, Hq 48,
    Hkv 1, 288 keys).  Returns (ok, rows)."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention

    ok_p, pre = flash_row("flash_attention_d192", 2, 128, 128, 4096, 4096, 192, True, None, seed=7, dv=128)
    ok_r, ring = flash_row("flash_attention_decode_ring", 2, 32, 16, 1, 1024, 128, False, None, seed=8)
    ok_m, mqa = flash_row("flash_attention_decode_mqa", 2, 48, 1, 1, ZOO_CELLS["granite-20b"][1]
                          + ZOO_CELLS["granite-20b"][2], 128, True, None, seed=9)
    g = torch.Generator(device="cuda").manual_seed(7)
    q, k = (torch.randn((2, 128, 4096, 192), generator=g, device="cuda").to(torch.bfloat16) for _ in range(2))
    v = torch.randn((2, 128, 4096, 128), generator=g, device="cuda").to(torch.bfloat16)
    pre["queued_ms"] = queued_ms(lambda: flash_attention(q, k, v, causal=True), reps=5)
    del q, k, v
    ptx = {}
    for kernel in ("prefill_tc_kernel", "prefill_fp32_kernel", "decode_split_kernel", "merge_kernel"):
        ptx.update(ptxas_entries("flash_attention", kernel))
    pre["ptxas"] = ptx   # every instantiation, D 192's among them
    for row in (pre, ring, mqa):
        row["launches"] = zoo_launches[row["name"]]
        row["ptxas_192"] = {k: v for k, v in ptx.items() if "192" in k}
    torch.cuda.empty_cache()
    return ok_p and ok_r and ok_m, [pre, ring, mqa]


# ---------------------------------------------------------------------------
# phase 14: training (the attention gradient B11, llama3-8b, recsys, GAT)
# ---------------------------------------------------------------------------

# B11 against attention_bwd_ref: (B, Hq, Hkv, Sq, Sk, D, Dv, causal, window, q_offset)
BWD_CASES = [
    (2, 4, 4, 70, 70, 16, 16, True, None, None), (2, 8, 1, 200, 200, 32, 32, True, None, None),
    (1, 8, 2, 300, 300, 128, 128, True, None, None), (2, 4, 1, 129, 129, 128, 128, False, None, None),
    (1, 8, 8, 513, 513, 128, 128, True, 100, None), (1, 4, 4, 100, 260, 32, 32, True, None, None),
    (1, 4, 1, 64, 200, 16, 16, True, None, -20), (2, 8, 2, 65, 333, 128, 128, False, None, None),
    (1, 4, 4, 257, 257, 32, 32, True, 64, None),
    # the bf16 mapping's 128-key tile and 64-query step at their edges
    (1, 8, 1, 128, 128, 128, 128, True, None, None), (1, 4, 4, 127, 127, 128, 128, True, None, None),
    (2, 4, 1, 257, 257, 128, 128, True, 90, None), (1, 4, 2, 129, 129, 16, 16, True, None, -30),
    # q/k 192 (B11b): v at 192, and MLA's (192, 128) pair; the tile's and the
    # step's edges, a window, a negative offset, Hq / Hkv of 1 and 4
    (1, 4, 1, 127, 127, 192, 192, True, None, None), (2, 4, 4, 257, 257, 192, 192, True, 90, None),
    (1, 4, 4, 129, 129, 192, 192, True, None, -20), (1, 4, 1, 128, 128, 192, 128, True, None, None),
    (1, 4, 4, 129, 129, 192, 128, True, None, None), (2, 4, 4, 257, 257, 192, 128, True, 100, None),
    (1, 4, 2, 200, 200, 192, 128, True, None, -30), (1, 8, 8, 64, 300, 192, 128, False, None, None),
    # D 64 (B8d): the LM examples' width; train_lm's heads (10 over 2), the
    # tile's and the step's edges, unmasked, a window, a negative offset
    (1, 10, 2, 256, 256, 64, 64, True, None, None), (1, 4, 4, 127, 127, 64, 64, True, None, None),
    (2, 4, 1, 129, 129, 64, 64, False, None, None), (1, 4, 4, 257, 257, 64, 64, True, 90, None),
    (1, 4, 2, 100, 260, 64, 64, True, None, -20),
]
LSE_TOL = "|kernel - plain| <= 1e-4 (1 + |plain|), fp32 lse; +inf on the same rows"
BWD_TOL = ("fp32: |kernel - plain| <= 1e-4 |plain| + 1e-4 rms(plain); bf16: <= 2^-7 |plain| + 1e-3 rms(plain) "
           "(one bf16 step of the value: both sum in fp32 and round once; the bf16 kernel takes P and dS as two "
           "bf16 terms, and adds dQ into its fp32 accumulator atomically, in an order that changes from run to "
           "run, so two calls' dQ may differ in the last bits, within this bound; dK and dV are equal bit for bit)")
# B11's kernels by name (bf16: the tensor-core launch and its two small kernels; fp32: the CUDA-core ones)
BWD_KERNELS = ("attn_bwd_stats_kernel", "attn_bwd_tc_kernel", "attn_bwd_dq_kernel", "delta_kernel", "dkdv_kernel",
               "dq_kernel")
BWD_ROW = (4, 32, 8, 4096, 128)   # B, Hq, Hkv, S, D: the forward row's shape, causal, bf16
BWD_MLA_ROW = (2, 128, 128, 4096, 192, 128)  # B, Hq, Hkv, S, D, Dv: deepseek-v2's training shape, causal, bf16
# full-width gradients through the kernels against the same step through attention_ref with autograd
GRAD_CHECK = (2, 1, 1024)         # layers, batch, tokens
GRAD_REL_L2 = 0.05                # per leaf, bf16: the kernel's P.V is two bf16 terms, the plain P fp32
# llama3-8b training at full width, depth cut
# 2 of 32 layers: at 8 its checkpoint (27.96 GB) took 58-67 s to save and as
# long to restore; phase 18's train_lm_64 saves and resumes too
TRAIN_LM_LAYERS, TRAIN_LM_BATCH, TRAIN_LM_SEQ = 2, 8, 4096
# the reference's adamw(lr=3e-4) behind a linear warmup over 100 steps: at a
# constant 3e-4 Adam's first steps move all 2.8 B parameters by +-lr at once,
# and the loss on one batch rises 11.8 -> 14.0 -> 14.6 -> 25.7 through the
# kernels and through attention_ref alike; over 10 steps it still rises
# (scripts/train_lm_lr_witness.py on an NVIDIA H100 80GB HBM3, 700 W; PERF.md,
# section 6)
TRAIN_LM_WARMUP = 100
RESUME_TOL = 1e-4                 # |resumed - uninterrupted| / |loss| at the first step after the restore
# the zoo's training at full width, each depth cut from its training state
# (bf16 weights and grads + AdamW's m and v in the full model's state dtype)
# to fit one card; train_4k's 4,096 tokens a row, one microbatch
ZOO_TRAIN = {
    # name: (layers kept, batch rows, why these layers)
    "deepseek-v2-236b": (2, 2, "2 of 60: the dense prefix + 1 MoE layer (MLA at (192, 128), 160 experts top-6)"),
    "grok-1-314b": (1, 2, "1 of 64 (8 experts top-2, GQA at D 128): 52.2 GB of state; a second layer passes 80 GB"),
    "gemma3-27b": (6, 2, "6 of 62: 5 local (window 1,024) + the first global (layer 5), the fewest with a global"),
}
ZOO_GRAD_TOKENS = 2048            # the gradient check's 1 x 2,048 tokens: the window masks beyond 1,024
# recsys and GAT steps held to a CPU copy
RECSYS_TRAIN_BATCH, TRAIN_PARITY_ROWS = 65536, 512
TRAIN_GRAD_REL_L2 = 1e-4          # per leaf, fp32 on both: the CPU tests' bound against JAX
TRAIN_STEP_TOL = (f"gradients: relative L2 per leaf <= {TRAIN_GRAD_REL_L2}; loss: |card - cpu| <= 1e-5 |cpu|; "
                  "parameters after one AdamW step: |card - cpu| <= 1e-5 (1 + |cpu|) where the CPU gradient "
                  "is 0 or >= 1e-6 (the first step maps g to lr g / (|g| + 1e-8): between the two, the "
                  "rounding of g moves the parameter by up to lr, so those are held by the gradients alone)")
GNN_MINIBATCH_SEEDS, GNN_FANOUT = 1024, (15, 10)


class StepFailed(Exception):
    """A train step that raised: not retried (``GuardedStep`` retries a
    ``RuntimeError``, and a failure here is a failed check)."""


def bwd_grad_gap(got, want, dtype):
    import torch

    got, want = got.float(), want.float()
    err = (got - want).abs()
    rms = want.pow(2).mean().sqrt()
    rel = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    atol = (1e-4 if dtype == torch.float32 else 1e-3) * rms + 1e-30
    ok = bool((err <= rel * want.abs() + atol).all()) and bool(got.isfinite().all())
    return ok, float(err.max()), float(err.max() / rms.clamp_min(1e-30))


def bwd_case(c, dtype, seed):
    """One B11 case: the forward's log-sum-exp against ``attention_ref``'s,
    ``flash_attention_bwd`` against ``attention_bwd_ref`` on the same
    inputs (the kernel's own output and log-sum-exp), and the autograd
    path's gradients against the same."""
    import torch

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref

    b, hq, hkv, sq, sk, d, dv, causal, window, off = c
    g = torch.Generator(device="cuda").manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=g, device="cuda", dtype=torch.float32).to(dtype)

    q, k, v, dout = draw(b, hq, sq, d), draw(b, hkv, sk, d), draw(b, hkv, sk, dv), draw(b, hq, sq, dv)
    q_offset = sk - sq if off is None else off
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device="cuda")
    out = ops._launch(q, k, v, causal, window, d ** -0.5, q_offset, lse)
    _, lse_ref = attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset, return_lse=True)
    fin = lse_ref.isfinite()
    ok = bool(torch.equal(fin, lse.isfinite()))
    ok &= bool(((lse - lse_ref)[fin].abs() <= 1e-4 * (1 + lse_ref[fin].abs())).all())
    row = {"case": dict(zip(("B", "Hq", "Hkv", "Sq", "Sk", "D", "Dv", "causal", "window", "q_offset"), c)),
           "dtype": str(dtype).split(".")[-1], "lse_ok": ok,
           "lse_max_abs_err": float((lse - lse_ref)[fin].abs().max()) if fin.any() else 0.0,
           "rows_without_keys": int((~fin).sum())}
    got = ops.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal, window=window, q_offset=q_offset)
    want = attention_bwd_ref(q, k, v, out, lse, dout, causal=causal, window=window, q_offset=q_offset)
    ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    ops.flash_attention(ql, kl, vl, causal=causal, window=window, q_offset=q_offset).backward(dout)
    for name, a, w in [*zip(("dq", "dk", "dv"), got, want),
                       *zip(("autograd_dq", "autograd_dk", "autograd_dv"), (ql.grad, kl.grad, vl.grad), want)]:
        o, e, r = bwd_grad_gap(a, w, dtype)
        row[name] = {"ok": o, "max_abs_err": e, "max_err_over_rms": r}
        ok &= o
    row["ok"] = ok
    return ok, row


def check_attention_bwd():
    """B11 held to its plain version at every instantiated width (16, 32,
    64, 128, 192 and MLA's (192, 128) pair), both dtypes and every mask of
    ``BWD_CASES``; the decode mapping (Sq = 1), which writes no
    log-sum-exp, raises before the forward launches.  Returns (ok, case
    rows, raises)."""
    import torch

    from repro_torch.kernels.flash_attention import ops

    ok, rows = True, []
    for i, c in enumerate(BWD_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            o, row = bwd_case(c, dtype, seed=i)
            rows.append(row)
            ok &= o
    q = torch.randn(1, 2, 1, 128, device="cuda", dtype=torch.bfloat16, requires_grad=True)
    kv = torch.randn(1, 2, 64, 128, device="cuda", dtype=torch.bfloat16)
    try:
        ops.flash_attention(q, kv, kv, causal=True)
        raised = {"sq_1": False}
    except NotImplementedError:
        raised = {"sq_1": True}
    return ok and all(raised.values()), rows, raised


def bwd_ptxas():
    out = {}
    for kernel in BWD_KERNELS:
        out.update(ptxas_entries("flash_attention_bwd", kernel))
    return out


def bwd_row(name, shape, seed):
    """A ``flash_attention_bwd`` row at ``shape`` (B, Hq, Hkv, S, D, Dv;
    causal, bf16): against the plain version on the same inputs, a second
    call against the first (dK and dV bit for bit, dQ's run-to-run gap),
    its time back to back and queued, the plain version's, SDPA's backward
    at the same widths (its forward plus ``backward()`` less its forward),
    the bound (the five products, 2 pairs (D + Dv + Dv + D + D) FLOP, on
    bf16 tensor cores) and the two-term floor (P and dS as two terms in
    dV, dK and dQ: 2 pairs (D + Dv + 2 Dv + 2 D + 2 D)).  Returns (ok, row,
    the inputs (q, k, v, dout, out, lse))."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cost
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    b, hq, hkv, s, d, dv = shape
    g = torch.Generator(device="cuda").manual_seed(seed)

    def draw(*shp):
        return torch.randn(shp, generator=g, device="cuda", dtype=torch.float32).to(torch.bfloat16)

    q, k, v, dout = draw(b, hq, s, d), draw(b, hkv, s, d), draw(b, hkv, s, dv), draw(b, hq, s, dv)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device="cuda")
    out = ops._launch(q, k, v, True, None, d ** -0.5, 0, lse)
    got = ops.flash_attention_bwd(q, k, v, out, lse, dout, causal=True)
    want = attention_bwd_ref(q, k, v, out, lse, dout, causal=True)
    ok, errs = True, []
    for a, w in zip(got, want):
        o, e, _ = bwd_grad_gap(a, w, torch.bfloat16)
        ok &= o
        errs.append(e)
    del want
    # a second call: dK and dV bit for bit, dQ (atomic adds in a run's own order) within BWD_TOL of the first
    again = ops.flash_attention_bwd(q, k, v, out, lse, dout, causal=True)
    dkdv_equal = all(bool(torch.equal(a, b2)) for a, b2 in zip(got[1:], again[1:]))
    dq_ok, dq_gap, _ = bwd_grad_gap(again[0], got[0], torch.bfloat16)
    dq_differ = int((again[0] != got[0]).sum())
    ok &= dkdv_equal and dq_ok
    del got, again
    bwd = lambda: ops.flash_attention_bwd(q, k, v, out, lse, dout, causal=True)
    t1 = time_ms(bwd, reps=3, warmup=1)
    queued = queued_ms(bwd, reps=3)
    t2 = time_ms(bwd, reps=3, warmup=0)
    plain = time_ms(lambda: attention_bwd_ref(q, k, v, out, lse, dout, causal=True), reps=1, warmup=1)
    ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    gqa = hq != hkv

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, enable_gqa=gqa).backward(dout)

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=gqa)

    fb, f_only = time_ms(sdpa_fwd_bwd, reps=5), time_ms(sdpa_fwd, reps=5)
    del ql, kl, vl
    c = cost.attention_bwd_cost(b, hq, hkv, s, s, d, dv, causal=True)  # q, dq, o, dO; k, dk, v, dv; lse
    pairs = b * hq * cost.attention_span(s, s, True)[0]
    flops, n_bytes = c.ops, c.bytes
    b_ms, b_by = c.bound_ms()
    row = {"name": name, "shape": {"B": b, "Hq": hq, "Hkv": hkv, "S": s, "D": d, "Dv": dv, "causal": True,
                                   "dtype": "bfloat16"},
           "max_abs_err": max(errs), "max_abs_err_dq_dk_dv": errs, "tolerance": BWD_TOL,
           "ms": (t1 + t2) / 2, "ms_turns": [t1, t2], "queued_ms": queued, "plain_ms": plain,
           "library_ms": fb - f_only, "library_fwd_bwd_ms": fb, "library_fwd_ms": f_only,
           "library": f"F.scaled_dot_product_attention(enable_gqa={gqa}), v at Dv: forward + backward() less its "
                      "forward",
           "flops": flops, "bytes": n_bytes, "bound_ms": b_ms, "bound_by": b_by,
           "two_term_floor_ms": bound_ms(n_bytes, 2.0 * pairs * (5 * d + 3 * dv), BF16_FLOPS)[0],
           "bound_fp32_cuda_cores_ms": bound_ms(n_bytes, flops, FP32_FLOPS)[0],
           "second_call": {"dk_dv_bit_equal": dkdv_equal, "dq_max_abs_diff": dq_gap,
                           "dq_elements_differing": dq_differ, "dq_within_tolerance": dq_ok},
           "tflops_counted": flops / ((t1 + t2) / 2) / 1e9, "ptxas": bwd_ptxas(),
           "build_notes": build_notes("flash_attention_bwd")}
    return ok, row, (q, k, v, dout, out, lse)


def attention_bwd_rows():
    """The ``flash_attention_bwd`` rows (``bwd_row``): at the forward
    row's shape (``BWD_ROW``: B 4, Hq 32, Hkv 8, S 4096, D 128, causal,
    bf16) and, as ``flash_attention_bwd_mla``, at deepseek-v2's training
    shape (``BWD_MLA_ROW``: B 2, Hq = Hkv = 128, S 4096, the (192, 128)
    pair); and the D 128 forward with the log-sum-exp written (training's
    forward) beside the same launch without it.  Returns (ok, [bwd row,
    lse row, mla row])."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cost
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    ok, bwd, (q, k, v, dout, out, lse) = bwd_row("flash_attention_bwd", (*BWD_ROW, BWD_ROW[4]), seed=11)
    b, hq, hkv, s, d = BWD_ROW
    scale = d ** -0.5

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

    # the forward with the log-sum-exp written, beside the same launch without it
    fwd_lse = lambda: ops._launch(q, k, v, True, None, scale, 0, lse)
    fwd_none = lambda: ops._launch(q, k, v, True, None, scale, 0)
    w1, n1 = time_ms(fwd_lse, reps=5), time_ms(fwd_none, reps=5)
    qw, qn = queued_ms(fwd_lse, reps=10), queued_ms(fwd_none, reps=10)
    w2, n2 = time_ms(fwd_lse, reps=5), time_ms(fwd_none, reps=5)
    ref, lse_ref = attention_ref(q, k, v, causal=True, return_lse=True)
    out2 = fwd_lse()
    ok_f, gap = flash_gap(out2, ref)
    lse_err = float((lse - lse_ref).abs().max())
    ok_f &= lse_err <= 1e-4 * (1 + float(lse_ref.abs().max()))
    plain_f = time_ms(lambda: attention_ref(q, k, v, causal=True, return_lse=True), reps=2, warmup=1)
    del ref, lse_ref
    lib_f = time_ms(sdpa_fwd, reps=5)
    fb_ms, fb_by = cost.attention_cost(b, hq, hkv, s, s, d, d, causal=True, lse=True).bound_ms()
    lse_row = {"name": "flash_attention_lse", "shape": bwd["shape"], **gap, "lse_max_abs_err": lse_err,
               "ms": (w1 + w2) / 2, "ms_turns": [w1, w2], "queued_ms": qw,
               "ms_lse_not_written": (n1 + n2) / 2, "ms_lse_not_written_turns": [n1, n2],
               "queued_ms_lse_not_written": qn, "plain_ms": plain_f, "library_ms": lib_f,
               "library": "F.scaled_dot_product_attention(enable_gqa=True), bf16, causal (no log-sum-exp out)",
               "bound_ms": fb_ms, "bound_by": fb_by}
    del q, k, v, dout, out, out2, lse
    torch.cuda.empty_cache()
    ok_m, mla, inputs = bwd_row("flash_attention_bwd_mla", BWD_MLA_ROW, seed=12)
    del inputs
    torch.cuda.empty_cache()
    return ok and ok_f and ok_m, [bwd, lse_row, mla]


def fingerprint(tree, chunk: int = 1 << 26):
    """Per leaf, two int64 sums of its raw bits (as integers, and weighted
    by position mod 65521 + 1), on its device: equal fingerprints show a
    restore bit for bit (any single flipped bit changes both)."""
    import torch

    from repro_torch.train.optimizer import tree_leaves

    out = []
    for x in tree_leaves(tree):
        t = x.detach().reshape(-1)
        bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
        w = t.view(bits)
        s1 = s2 = 0
        for i in range(0, w.numel(), chunk):
            part = w[i:i + chunk].to(torch.int64)
            pos = torch.arange(i, i + part.numel(), device=part.device) % 65521 + 1
            s1 += int(part.sum())
            s2 += int((part * pos).sum())
        out.append((s1, s2))
    return out


def synced_step(step_fn, launches: list):
    """``step_fn`` ended by a device sync (so ``train_loop``'s step seconds
    are the step's own), with each call's kernel launches appended to
    ``launches``; a ``RuntimeError`` becomes :class:`StepFailed` (no
    retry, no restore)."""
    import torch

    from repro_torch.obs import metrics

    names = ("flash_attention", "flash_attention_bwd")

    def fn(params, opt_state, batch):
        before = {n: metrics.counter(f"kernel.{n}.launches").value for n in names}
        try:
            out = step_fn(params, opt_state, batch)
            torch.cuda.synchronize()
        except RuntimeError as e:
            raise StepFailed(f"{type(e).__name__}: {e}") from e
        launches.append({n: metrics.counter(f"kernel.{n}.launches").value - before[n] for n in names})
        return out

    return fn


def grad_check_loss(model, h, labels, keep):
    """The gradient check's loss: mean next-token cross-entropy over the
    positions ``keep`` (B, S) marks, the head over ``_hidden``'s states
    there (``cross_entropy_loss``: fp32 log-softmax)."""
    from repro_torch.models.layers import cross_entropy_loss, dense

    return cross_entropy_loss(dense(model.lm_head, h[keep]), labels[keep])


def leaf_rel_l2(got, want):
    """|got - want| / |want| (L2, fp32), summed over ``row_blocks`` so that
    no whole-leaf fp32 copy is made."""
    import torch

    from repro_torch.train.optimizer import row_blocks

    num = den = torch.zeros((), dtype=torch.float64, device=want.device)
    for a, w in zip(row_blocks(got.contiguous()), row_blocks(want.contiguous())):
        wf = w.float()
        num = num + (a.float() - wf).square().sum().double()
        den = den + wf.square().sum().double()
    return float(num.sqrt() / den.sqrt().clamp_min(1e-30))


def model_grads(name, cfg, b, s, dev, model=None):
    """Every parameter's gradient of one loss through the kernels (the
    forward twice a layer with remat, B11 once) against the same loss
    through ``attention_ref`` with autograd, relative L2 per leaf
    (``GRAD_REL_L2``): ``cfg``'s model (``model``, or drawn by
    ``transformer_init(0, cfg)``), ``lm_batches(1, b, s, V)``'s batch 0.
    MoE runs at the no-drop capacity ``n_experts / top_k``; the positions
    whose experts differ between the two passes (``route_log``: a route
    flip, the router seeing inputs one rounding apart near a tie) are left
    out of both losses (``grad_check_loss``), and at least 90% of them
    must remain: with the MoE layer last, a flip changes only its own
    position's output.  On the CPU both passes are plain versions (the
    kernels' wrappers run theirs) and launch nothing.  Returns (ok,
    line)."""
    import dataclasses

    import torch

    from repro_torch.data.pipeline import lm_batches
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import layers
    from repro_torch.models import transformer as tt
    from repro_torch.obs import metrics

    if model is None:
        model = tt.transformer_init(0, cfg, device=dev)
    model.requires_grad_(True)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    batch = lm_batches(1, b, s, cfg.vocab)(0)
    tokens, labels = (torch.from_numpy(batch[k]).to(dev) for k in ("tokens", "labels"))
    names, leaves = zip(*model.named_parameters())

    def forward():
        with route_log() as log:
            h = tt._hidden(model, cfg, tokens)
        return h, (torch.stack([c.reshape(b, s, -1) for c in log.calls]) if log.calls else None)

    # both forwards first (the flips decide both losses); each backward
    # runs while its own attention is in place (remat recomputes the layer)
    metrics.reset()
    h_k, r_k = forward()
    kernel_fn = layers.flash_attention
    layers.flash_attention = lambda q, k, v, **kw: attention_ref(q, k, v, **kw)  # the plain path, autograd
    try:
        h_p, r_p = forward()
        flips = torch.zeros((b, s), dtype=torch.bool, device=h_k.device)
        if r_k is not None:
            flips = (r_k != r_p).any(-1).any(0)
        keep = ~flips
        loss_p = grad_check_loss(model, h_p, labels, keep)
        g_p = torch.autograd.grad(loss_p, leaves, materialize_grads=True)
    finally:
        layers.flash_attention = kernel_fn
    del h_p
    loss_k = grad_check_loss(model, h_k, labels, keep)
    g_k = torch.autograd.grad(loss_k, leaves, materialize_grads=True)
    del h_k
    launches = {n: metrics.counter(f"kernel.{n}.launches").value for n in ("flash_attention", "flash_attention_bwd")}
    rel = {n: leaf_rel_l2(a, w) for n, a, w in zip(names, g_k, g_p)}
    finite = all(bool(g.isfinite().all()) for g in g_k)
    del g_k, g_p
    n_att = cfg.n_layers if dev.type == "cuda" else 0
    kept = int(keep.sum())
    ok = max(rel.values()) <= GRAD_REL_L2 and finite and 10 * kept >= 9 * keep.numel()
    ok &= launches == {"flash_attention": 2 * n_att, "flash_attention_bwd": n_att}
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:5]
    line = {"phase": "train_grads", "arch": name, "n_layers": cfg.n_layers, "batch": b, "tokens": s,
            "dtype": str(cfg.dtype).split(".")[-1], "loss_kernel": float(loss_k.detach()), "loss_plain": float(loss_p.detach()),
            "capacity_factor": None if cfg.moe is None else cfg.moe.capacity_factor,
            "route_flips": int(flips.sum()), "positions_kept": kept, "positions": keep.numel(),
            "leaves": len(rel), "max_rel_l2": max(rel.values()), "median_rel_l2": float(np.median(list(rel.values()))),
            "worst_leaves": worst, "tolerance": f"per leaf relative L2 <= {GRAD_REL_L2}; >= 90% of positions kept",
            "launches": launches, "ok": ok}
    return ok, line


def profiled_lm_step(step_fn, model, cfg, params, state, batch, n_mb, chunk, opt):
    """One ``lm_train_step`` under ``torch.profiler``: (its result, the
    split of its device time).  The trace's kernels are summed by class:
    B11 (``BWD_KERNELS``), the attention forward (the prefill
    launches: forward and remat recompute), the GEMMs (cuBLAS and
    CUTLASS kernels) and the rest (norms, activations, the loss, the
    embedding's scatter, the clip and the optimizer's elementwise
    kernels).  CUDA events bound the optimizer on the device timeline:
    ``opt.apply`` (the AdamW math, each leaf added as it is computed);
    the forward, backward and clip come before."""
    import torch

    from repro_torch.train.optimizer import Optimizer

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]

    def apply(grads, st, p):
        ev[1].record()
        out = opt.apply(grads, st, p)
        ev[2].record()
        return out

    res = {}

    def run():
        ev[0].record()
        res["out"] = step_fn(model, cfg, params, state, batch, n_microbatches=n_mb, ce_chunk=chunk,
                             opt=Optimizer(opt.init, opt.update, apply))

    wall, busy, union, kernels = device_busy(run, top=1 << 30)
    classes = {"flash_attention_bwd": BWD_KERNELS,
               "flash_attention_fwd": ("prefill_",),
               "gemm": ("gemm", "nvjet", "xmma", "cutlass", "cublas")}
    by = {c: 0.0 for c in (*classes, "other")}
    for name, ms, _ in kernels:
        c = next((c for c, keys in classes.items() if any(k in name.lower() for k in keys)), "other")
        by[c] += ms / 1e3
    split = {"wall_s": wall, "device_busy_s": busy, "device_busy_union_s": union,
             "idle_share": None if union is None else 1.0 - union / wall, "kernels_s": by,
             "busy_share": None if not busy else {c: v / busy for c, v in by.items()},
             "events_s": {"step": ev[0].elapsed_time(ev[2]) / 1e3,
                          "forward_backward_clip": ev[0].elapsed_time(ev[1]) / 1e3,
                          "adamw_apply": ev[1].elapsed_time(ev[2]) / 1e3},
             "top_kernels": kernels[:12]}
    return res["out"], split


def lm_train(dev):
    """llama3-8b training at full width, ``TRAIN_LM_LAYERS`` of 32 layers,
    B 8 x 4,096 (``train_4k``'s sequence; batch cut from 256), bf16,
    remat, through ``train_loop`` with a checkpoint directory: 3 steps on
    one repeated batch (step 0 the warm-up), saved; one more step of the
    live state (the uninterrupted run); dropped (the kill); a model drawn
    from another seed resumed by ``train_loop`` from the checkpoint (no
    step left, so nothing is written again: one checkpoint a run, not
    two), its state fingerprinted against the saved one's, then
    stepped once.  Returns (ok, line, launches a
    step)."""
    import dataclasses
    import functools
    import gc
    import shutil

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import lm_batches
    from repro_torch.launch.steps import lm_ce_chunk, lm_microbatches, lm_train_step
    from repro_torch.models.transformer import transformer_init
    from repro_torch.train.optimizer import adamw, param_tree
    from repro_torch.train.schedule import warmup_linear
    from repro_torch.train.trainer import TrainLoopConfig, train_loop

    cfg = dataclasses.replace(get_arch("llama3-8b").make_config(), n_layers=TRAIN_LM_LAYERS)
    opt = adamw(lr=warmup_linear(3e-4, TRAIN_LM_WARMUP, 10_000))
    ckpt = ROOT / "build" / "chip_smoke_train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    batch0 = lm_batches(0, TRAIN_LM_BATCH, TRAIN_LM_SEQ, cfg.vocab)(0)
    make_batch = lambda step: batch0  # noqa: E731  (a repeated batch: the loss must fall)
    n_mb, chunk = lm_microbatches(cfg, TRAIN_LM_BATCH), lm_ce_chunk(cfg)
    line = {"phase": "train_lm", "arch": "llama3-8b", "dtype": str(cfg.dtype), "n_layers": cfg.n_layers,
            "params": cfg.param_count(), "batch": TRAIN_LM_BATCH, "seq": TRAIN_LM_SEQ, "microbatches": n_mb,
            "ce_chunk": chunk, "remat": cfg.remat,
            "optimizer": f"adamw(lr=warmup_linear(3e-4, {TRAIN_LM_WARMUP}, 10000)), fp32 state, clip 1.0",
            "reduced": {"n_layers": f"{TRAIN_LM_LAYERS} of 32 (at 8, the weights, grads and fp32 AdamW state of one "
                                    "card, the checkpoint's save and restore took 58-67 s each)",
                        "global_batch": "8 of train_4k's 256 (one microbatch)"}}

    def start(seed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = transformer_init(seed, cfg, device=dev).requires_grad_(True)
        params = param_tree(model)
        state = opt.init(params)
        torch.cuda.synchronize()
        return model, params, state, time.perf_counter() - t0

    launches, logs = [], []
    model, params, state, init_s = start(0)
    step = synced_step(functools.partial(lm_train_step, model, cfg, n_microbatches=n_mb, ce_chunk=chunk, opt=opt),
                       launches)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train_loop(TrainLoopConfig(total_steps=3, ckpt_dir=str(ckpt), ckpt_every=10 ** 9, log_every=1),
                     step, params, state, make_batch, log=logs.append)
    loop_s = time.perf_counter() - t0
    hist = out["history"]
    state = out["opt_state"]
    saved_fp = fingerprint((params, state))
    peak = torch.cuda.max_memory_allocated()
    # the uninterrupted run's next step, under the profiler
    (_, state, m3), split = profiled_lm_step(lm_train_step, model, cfg, params, state, batch0, n_mb, chunk, opt)
    loss_a3 = float(m3["loss"])
    step_s = [h["step_s"] for h in hist]
    losses = [h["loss"] for h in hist] + [loss_a3]
    line.update({"init_s": init_s, "losses": losses, "step_s": step_s + [None],
                 "warmup_step_s": step_s[0], "step_s_timed": step_s[1:],
                 "tokens_per_s": TRAIN_LM_BATCH * TRAIN_LM_SEQ / float(np.median(step_s[1:])),
                 "save_s": loop_s - sum(step_s), "peak_mem_bytes": peak, "launches_a_step": launches[1],
                 "grad_norm_last": float(m3["grad_norm"]), "profiled_step": split})
    # the kill: every tensor of the run dropped
    del model, params, state, out, step, m3
    gc.collect()
    torch.cuda.empty_cache()
    model, params, state, _ = start(1)  # other weights: the restore must overwrite every leaf
    step = synced_step(functools.partial(lm_train_step, model, cfg, n_microbatches=n_mb, ce_chunk=chunk, opt=opt),
                       launches)
    t0 = time.perf_counter()
    out = train_loop(TrainLoopConfig(total_steps=3, ckpt_dir=str(ckpt), ckpt_every=10 ** 9, log_every=1),
                     step, params, state, make_batch, log=logs.append)
    restore_s = time.perf_counter() - t0
    state = out["opt_state"]
    restored = fingerprint((params, state)) == saved_fp
    _, state, m3 = step(params, state, batch0)  # the resumed run's next step
    loss_b3 = float(m3["loss"])
    line.update({"resumed_from": [s for s in logs if s.startswith("resumed")], "restore_s": restore_s,
                 "restored_bit_for_bit": restored, "resumed_step": int(state["step"]) - 1,
                 "resumed_loss": loss_b3, "uninterrupted_loss": loss_a3,
                 "resume_rel_diff": abs(loss_b3 - loss_a3) / abs(loss_a3), "resume_tolerance": RESUME_TOL,
                 "checkpoint_bytes": sum(f.stat().st_size for f in ckpt.rglob("*") if f.is_file())})
    ok = all(np.isfinite(losses)) and losses[-1] < losses[0] and restored and not out["history"]
    ok &= line["resumed_step"] == 3 and line["resume_rel_diff"] <= RESUME_TOL
    ok &= launches[1] == {"flash_attention": 2 * TRAIN_LM_LAYERS, "flash_attention_bwd": TRAIN_LM_LAYERS}
    line["ok"] = ok
    del model, params, state, out, step, m3
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(ckpt, ignore_errors=True)
    return ok, line, launches[1]


def zoo_train(name, dev):
    """One zoo model's training at full width, ``ZOO_TRAIN``'s depth and
    batch x 4,096 (``train_4k``'s sequence), bf16, remat,
    ``lm_batches(0, B, 4096, V)``'s batch 0 repeated, one microbatch,
    clip 1.0, ``adamw`` behind ``warmup_linear(3e-4, TRAIN_LM_WARMUP,
    10000)`` with the full model's policy (state dtype and ``ce_chunk``:
    the cut config's parameter count would flip it).  First the gradient
    check on the drawn weights (``model_grads`` at 1 x
    ``ZOO_GRAD_TOKENS``), then a warm-up step and three timed steps
    through ``lm_train_step`` (the last under the profiler), the
    launches of each step read around it; MoE at the published capacity,
    each layer's drop fraction read from a forward of the batch after the
    steps.  Returns (ok, line, launches a step)."""
    import dataclasses
    import functools
    import gc

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import lm_batches
    from repro_torch.launch.steps import lm_ce_chunk, lm_train_step
    from repro_torch.models import transformer as tt
    from repro_torch.train.optimizer import adamw, param_tree
    from repro_torch.train.schedule import warmup_linear

    t_model = time.perf_counter()
    full = get_arch(name).make_config()
    n_layers, batch, why = ZOO_TRAIN[name]
    cfg = dataclasses.replace(full, n_layers=n_layers, remat=True)
    huge = full.param_count() > 1e11
    state_dtype = torch.bfloat16 if huge else torch.float32
    opt = adamw(lr=warmup_linear(3e-4, TRAIN_LM_WARMUP, 10_000), state_dtype=state_dtype)
    chunk = lm_ce_chunk(full)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = tt.transformer_init(0, cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    line = {"phase": "train_lm", "arch": name, "dtype": str(cfg.dtype), "n_layers": n_layers,
            "published_layers": full.n_layers, "params": n_params, "batch": batch, "seq": TRAIN_LM_SEQ,
            "microbatches": 1, "ce_chunk": chunk, "remat": True,
            "optimizer": f"adamw(lr=warmup_linear(3e-4, {TRAIN_LM_WARMUP}, 10000)), "
                         f"{str(state_dtype).split('.')[-1]} state, clip 1.0",
            "policy": {"state_dtype": str(state_dtype).split(".")[-1], "ce_chunk": chunk,
                       "reason": f"the full model's {full.param_count():.3e} parameters "
                                 f"{'>' if huge else '<='} 1e11 (lm_optimizer, lm_ce_chunk); one microbatch "
                                 f"on one card"},
            "capacity_factor": None if cfg.moe is None else cfg.moe.capacity_factor,
            "reduced": {"n_layers": why, "global_batch": f"{batch} of train_4k's 256 (one microbatch)"},
            "init_s": init_s}
    t0 = time.perf_counter()
    g_ok, g_line = model_grads(name, cfg, 1, ZOO_GRAD_TOKENS, dev, model)
    line["grads"] = {**g_line, "seconds": time.perf_counter() - t0}
    gc.collect()
    torch.cuda.empty_cache()

    params = param_tree(model)
    state = opt.init(params)
    batch0 = lm_batches(0, batch, TRAIN_LM_SEQ, cfg.vocab)(0)
    launches = []
    step = synced_step(functools.partial(lm_train_step, model, cfg, n_microbatches=1, ce_chunk=chunk, opt=opt),
                       launches)
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch0)
        step_s.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    (_, state, m), split = profiled_lm_step(lm_train_step, model, cfg, params, state, batch0, 1, chunk, opt)
    losses.append(float(m["loss"]))
    step_s.append(split["events_s"]["step"])
    peak = torch.cuda.max_memory_allocated()
    if cfg.moe is not None:
        aux = []
        tt.transformer_prefill(model, cfg, torch.from_numpy(batch0["tokens"]).to(dev), moe_aux=aux)
        line["drop_fraction_by_layer"] = [float(x["drop_fraction"]) for x in aux]
    expect = {"flash_attention": 2 * n_layers, "flash_attention_bwd": n_layers}
    line.update({"losses": losses, "warmup_step_s": step_s[0], "step_s_timed": step_s[1:],
                 "tokens_per_s": batch * TRAIN_LM_SEQ / float(np.median(step_s[1:])), "peak_mem_bytes": peak,
                 "launches_a_step": launches[1:], "launches_expected": expect,
                 "grad_norm_last": float(m["grad_norm"]), "profiled_step": split})
    checks = {"losses_finite_and_falling": bool(all(np.isfinite(losses)) and losses[-1] < losses[0]),
              "launches": all(x == expect for x in launches), "grads": g_ok}
    line.update({"checks": checks, "ok": all(checks.values()), "seconds": time.perf_counter() - t_model})
    del model, params, state, m, step
    gc.collect()
    torch.cuda.empty_cache()
    return line["ok"], line, launches[-1]


def cpu_step_parity(card_step, cpu_step, card_params, cpu_params, card_loss_fn, cpu_loss_fn):
    """One train step on the card and the same step on a CPU copy: (ok,
    fields) under ``TRAIN_STEP_TOL``.  First every parameter's gradient
    on both (``card_loss_fn``, ``cpu_loss_fn``), relative L2 per leaf;
    then the steps: the losses, and the parameters after the update
    wherever the CPU gradient is 0 or at least 1e-6.  Between the two
    AdamW's first step maps g to about lr g / (|g| + 1e-8), so the
    rounding of a tiny g moves the parameter by up to lr: those elements
    are held by the gradient check alone, and counted."""
    import torch

    from repro_torch.train.optimizer import tree_leaves

    def grads(params, loss_fn):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        return torch.autograd.grad(loss_fn(), leaves, materialize_grads=True)

    g_card, g_cpu = grads(card_params, card_loss_fn), grads(cpu_params, cpu_loss_fn)
    rel = [float((a.detach().cpu().double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))
           for a, b in zip(g_card, g_cpu)]
    ok = max(rel) <= TRAIN_GRAD_REL_L2
    del g_card
    m_cpu = cpu_step()
    m_card = card_step()
    l_cpu, l_card = float(m_cpu["loss"]), float(m_card["loss"])
    ok &= abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)
    worst, zero, small = 0.0, 0, 0
    for a, b, g in zip(tree_leaves(card_params), tree_leaves(cpu_params), g_cpu):
        a, b = a.detach().cpu().float(), b.detach().float()
        held = (g == 0) | (g.abs() >= 1e-6)
        if held.any():
            e = float(((a - b).abs()[held] / (1 + b[held].abs())).max())
            ok &= e <= 1e-5
            worst = max(worst, e)
        zero += int((g == 0).sum())
        small += int((~held).sum())
    return ok, {"loss_card": l_card, "loss_cpu": l_cpu, "grad_max_rel_l2": max(rel),
                "grad_median_rel_l2": float(np.median(rel)), "leaves": len(rel), "param_max_err": worst,
                "elements": sum(g.numel() for g in g_cpu), "elements_zero_grad": zero,
                "elements_grad_below_1e-6": small}


def recsys_train(dev):
    """The four recsys rankers' ``train_batch`` at full width: a step on
    ``TRAIN_PARITY_ROWS`` rows held to a CPU copy, then one warm-up and
    three timed ``recsys_train_step``s at 65,536 rows of ``ctr_batches``
    (DIEN's batch halved until its 2 x 100 GRU steps fit).  Returns (ok,
    lines)."""
    import gc

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import ctr_batches
    from repro_torch.launch.steps import recsys_optimizer, recsys_train_step
    from repro_torch.models import recsys
    from repro_torch.train.optimizer import param_tree

    ok, lines = True, []
    for name in ("bst", "deepfm", "autoint", "dien"):
        t_model = time.perf_counter()
        cfg = get_arch(name).make_config()
        model = getattr(recsys, f"{name}_init")(0, cfg, device=dev)
        host = copy.deepcopy(model).cpu()
        seq = name in ("bst", "dien")

        def batches(batch, seed):
            if seq:
                mk = ctr_batches(seed, batch, [cfg.item_vocab], seq_len=cfg.seq_len)
                return lambda i: {k: v for k, v in mk(i).items() if k != "ids"}
            return ctr_batches(seed, batch, cfg.vocab_sizes)

        small = batches(TRAIN_PARITY_ROWS, 1)(0)
        opt = recsys_optimizer()
        card_tree, host_tree = param_tree(model), param_tree(host)
        card_state, host_state = opt.init(card_tree), opt.init(host_tree)
        small_dev = {k: torch.as_tensor(v, device=dev) for k, v in small.items()}
        p_ok, parity = cpu_step_parity(
            lambda: recsys_train_step(model, cfg, card_tree, card_state, small)[2],
            lambda: recsys_train_step(host, cfg, host_tree, host_state, small)[2],
            card_tree, host_tree,
            lambda: recsys.bce_loss(recsys.recsys_logits(model, cfg, small_dev), small_dev["label"]),
            lambda: recsys.bce_loss(recsys.recsys_logits(host, cfg, small), small["label"]))
        del host, host_tree, host_state, small_dev
        gc.collect()
        state = opt.init(card_tree)
        batch, tried, step_s, losses = RECSYS_TRAIN_BATCH, [], [], []
        while True:
            make = batches(batch, 0)
            try:
                step_s, losses = [], []
                for i in range(4):
                    b = make(i)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    _, state, m = recsys_train_step(model, cfg, card_tree, state, b)
                    losses.append(float(m["loss"]))
                    step_s.append(time.perf_counter() - t0)
                break
            except torch.cuda.OutOfMemoryError:
                if name != "dien" or batch <= 1024:
                    raise
                tried.append(batch)
                batch //= 2
                state = opt.init(card_tree)
                gc.collect()
                torch.cuda.empty_cache()
        peak = torch.cuda.max_memory_allocated()
        row = {"phase": "train_recsys", "arch": name, "params": sum(p.numel() for p in model.parameters()),
               "batch": batch, "parity_rows": TRAIN_PARITY_ROWS, "parity_ok": p_ok, "parity": parity,
               "tolerance": TRAIN_STEP_TOL, "warmup_step_s": step_s[0], "step_s": step_s[1:],
               "rows_per_s": batch / float(np.median(step_s[1:])), "losses": losses, "peak_mem_bytes": peak,
               "seconds": time.perf_counter() - t_model}
        if tried:
            row["reduced"] = {"batch": f"{batch} of train_batch's {RECSYS_TRAIN_BATCH}: "
                                       f"{tried} ran out of memory in the GRU steps' saved activations"}
        step_ok = p_ok and all(np.isfinite(losses))
        row["ok"] = step_ok
        ok &= step_ok
        lines.append(row)
        del model, card_tree, state
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return ok, lines


def gnn_train(dev):
    """GAT (gat-cora's layers) on three of its shapes: ``full_graph_sm``
    at Cora's sizes, ``minibatch_lg`` (1,024 seeds, fanout 15-10, 602
    features, drawn by ``sample_fanout`` from a ``powerlaw_graph`` at
    Reddit's 232,965 nodes and 114,615,892 edges) and ``molecule`` (128
    graphs of 30 nodes, 64 edges): a step held to a CPU copy, then one
    warm-up and three timed ``gnn_train_step``s.  Returns (ok, lines)."""
    import gc

    import torch

    from repro_torch.configs.gat_cora import config_for_shape
    from repro_torch.configs.registry import GNN_SHAPES
    from repro_torch.data.graph_sampler import build_csr, sample_fanout
    from repro_torch.data.synthetic import powerlaw_graph, random_small_graphs
    from repro_torch.launch.steps import gnn_optimizer, gnn_train_step
    from repro_torch.models import gnn

    def full_batch(g):
        n, e = len(g["feats"]), len(g["src"])
        return {"feats": g["feats"], "src": g["src"], "dst": g["dst"], "labels": g["labels"],
                "label_mask": np.ones(n, np.float32), "edge_mask": np.ones(e, bool)}

    ok, lines = True, []
    meta = GNN_SHAPES["full_graph_sm"].meta
    cora = powerlaw_graph(np.random.default_rng(0), meta["n_nodes"], meta["n_edges"], meta["d_feat"])
    meta = GNN_SHAPES["minibatch_lg"].meta
    t0 = time.perf_counter()
    reddit = powerlaw_graph(np.random.default_rng(1), meta["n_nodes"], meta["n_edges"], meta["d_feat"])
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    csr = build_csr(reddit["src"], reddit["dst"], meta["n_nodes"])
    csr_s = time.perf_counter() - t0
    del reddit["src"], reddit["dst"]

    def sampled(i):
        rng = np.random.default_rng([2, i])
        seeds = rng.choice(meta["n_nodes"], size=GNN_MINIBATCH_SEEDS, replace=False).astype(np.int32)
        blk = sample_fanout(csr, seeds, GNN_FANOUT, reddit["feats"], rng)
        mask = np.zeros(len(blk["node_ids"]), np.float32)
        mask[: blk["n_seeds"]] = 1.0
        return {"feats": blk["feats"], "src": blk["src"], "dst": blk["dst"],
                "labels": reddit["labels"][blk["node_ids"]], "label_mask": mask, "edge_mask": blk["edge_mask"]}

    shapes = {"full_graph_sm": lambda i: full_batch(cora), "minibatch_lg": sampled,
              "molecule": lambda i: random_small_graphs(np.random.default_rng([3, i]), 128, 30, 64, 64)}
    for shape, make in shapes.items():
        cfg = config_for_shape(shape)
        params = gnn.gat_init(0, cfg, device=dev)
        host = {"layers": [{k: v.detach().cpu().clone() for k, v in layer.items()} for layer in params["layers"]]}
        opt = gnn_optimizer()
        card_state, host_state = opt.init(params), opt.init(host)
        b0 = make(0)

        def loss_of(tree):
            if "y" in b0:
                logits = gnn.gat_forward_batched(tree, cfg, b0["feats"], b0["src"], b0["dst"])
                return torch.mean(torch.square(logits.sum(-1) - torch.as_tensor(b0["y"], device=logits.device)))
            return gnn.gat_loss(tree, cfg, b0["feats"], b0["src"], b0["dst"], b0["labels"],
                                label_mask=b0["label_mask"], edge_mask=b0["edge_mask"])

        p_ok, parity = cpu_step_parity(lambda: gnn_train_step(cfg, params, card_state, b0)[2],
                                       lambda: gnn_train_step(cfg, host, host_state, b0)[2],
                                       params, host, lambda: loss_of(params), lambda: loss_of(host))
        state = opt.init(params)
        step_s, sample_s, losses, edges = [], [], [], []
        for i in range(1, 5):
            t0 = time.perf_counter()
            b = make(i)
            sample_s.append(time.perf_counter() - t0)
            edges.append(int(np.size(b["src"])))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, state, m = gnn_train_step(cfg, params, state, b)
            losses.append(float(m["loss"]))
            step_s.append(time.perf_counter() - t0)
        row = {"phase": "train_gnn", "arch": "gat-cora", "shape": shape, "d_in": cfg.d_in,
               "n_classes": cfg.n_classes, "edges": edges[-1], "parity_ok": p_ok, "parity": parity,
               "tolerance": TRAIN_STEP_TOL, "warmup_step_s": step_s[0], "step_s": step_s[1:],
               "edges_per_s": float(np.median(edges[1:])) / float(np.median(step_s[1:])), "losses": losses}
        if shape == "minibatch_lg":
            row.update({"graph_nodes": meta["n_nodes"], "graph_edges": meta["n_edges"], "generate_s": gen_s,
                        "csr_s": csr_s, "sample_s": sample_s[1:], "fanout": list(GNN_FANOUT),
                        "seeds": GNN_MINIBATCH_SEEDS, "block_nodes": int(len(b["feats"]))})
        row["ok"] = p_ok and all(np.isfinite(losses))
        ok &= row["ok"]
        lines.append(row)
        del params, host, state
        torch.cuda.empty_cache()
    del csr, reddit
    gc.collect()
    lines.append({"phase": "train_gnn", "shape": "ogb_products", "skipped": "not on one card: its cell "
                  "(launch.steps.build_gnn_train) splits the 61.9 M edges over a mesh, and its (E, H, D) fp32 "
                  "messages and their gradients come to about 40 GB; the dry run traces it (phase 16)"})
    return ok, lines


def train_phase(dev):
    """Phase 14: B11 against its plain version, its rows and the forward
    row with the log-sum-exp, the full-width gradient check, llama3-8b
    training with save and resume, the zoo's training (``ZOO_TRAIN``),
    the recsys and GAT steps; each phase line is printed as its part
    ends.  Returns (ok, kernel rows, launches by row)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch

    t_phase = time.perf_counter()
    b_ok, cases, raised = check_attention_bwd()
    emit({"phase": "train_attention", "seconds": time.perf_counter() - t_phase, "cases": len(cases), "ok": b_ok,
          "tolerances": {"lse": LSE_TOL, "grad": BWD_TOL}, "decode_mapping_raises": raised,
          "max_abs_err_by_dtype": {dt: max(max(r[n]["max_abs_err"] for n in ("dq", "dk", "dv"))
                                       for r in cases if r["dtype"] == dt) for dt in ("float32", "bfloat16")},
          "failed": [r for r in cases if not r["ok"]]})
    t0 = time.perf_counter()
    r_ok, rows = attention_bwd_rows()
    emit({"phase": "train_attention_rows", "seconds": time.perf_counter() - t0, "ok": r_ok,
          **{f"{r['name']}_ms": r["ms"] for r in rows}})
    t0 = time.perf_counter()
    n_layers, b, s = GRAD_CHECK
    g_ok, g_line = model_grads("llama3-8b", dataclasses.replace(get_arch("llama3-8b").make_config(),
                                                               n_layers=n_layers), b, s, dev)
    emit({**g_line, "seconds": time.perf_counter() - t0})
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    l_ok, l_line, step_launches = lm_train(dev)
    emit({**l_line, "seconds": time.perf_counter() - t0})
    z_ok, zoo_launches = True, {}
    for name in ZOO_TRAIN:
        m_ok, line, zoo_launches[name] = zoo_train(name, dev)
        emit(line)
        z_ok &= m_ok
    rs_ok, rs_lines = recsys_train(dev)
    for line in rs_lines:
        emit(line)
    gn_ok, gn_lines = gnn_train(dev)
    for line in gn_lines:
        emit(line)
    torch.cuda.empty_cache()
    ok = b_ok and r_ok and g_ok and l_ok and z_ok and rs_ok and gn_ok
    emit({"phase": "train", "seconds": time.perf_counter() - t_phase, "ok": ok,
          "checks": {"attention_bwd_cases": b_ok, "attention_rows": r_ok, "full_width_grads": g_ok,
                     "llama3_8b_train": l_ok, "zoo_train": z_ok, "recsys_train": rs_ok, "gnn_train": gn_ok}})
    launches = {"flash_attention_bwd": step_launches["flash_attention_bwd"],
                "flash_attention_lse": step_launches["flash_attention"],
                "flash_attention_bwd_mla": zoo_launches["deepseek-v2-236b"]["flash_attention_bwd"]}
    return ok, rows, launches


# ---------------------------------------------------------------------------
# phase 15: the sharded index plane
# ---------------------------------------------------------------------------

PLANE_KERNELS = ("hamming_filter", "hamming_filter_bitmap_stats", "label_prop_rect", "label_prop_update",
                 "label_prop_fixpoint", "col_reduce", "row_popcount")
PLANE_MAX_ITERS = 64   # packed_cluster_fixpoint's rounds: every one is enqueued above one rank
PLANE_WORLDS_MAX = 4   # one NCCL rank a card, on a machine with two or more


def sha256_of(t) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(t.cpu().numpy()).tobytes()).hexdigest()


def plane_run(mesh, data, p, dev) -> dict:
    """One rank's part of phase 15 on a ``DeviceMesh`` (every rank makes
    the same calls): LAF-DBSCAN through ``RandomProjectionBackend(mesh=)``
    with device telemetry on (also the warm-up), then timed with it off,
    each with the counts set to 0 just before and read just after; then
    the rank's slab words and the sharded fixpoint on them, with its time
    at 64 rounds and at the active rounds only (the idle rounds' cost)."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.laf_dbscan import laf_dbscan
    from repro_torch.distributed.index_plane import sharded_cluster_labels
    from repro_torch.distributed.sharding import plane_axes
    from repro_torch.index.random_projection import RandomProjectionBackend
    from repro_torch.obs import device as obs_device
    from repro_torch.obs import metrics

    eps, tau, alpha, pred = p["eps"], p["tau"], p["alpha"], p["pred"]
    n = data.shape[0]
    ax = plane_axes(mesh)
    was = obs_device.device_enabled()
    out = {"rank": dist.get_rank(), "index": ax.index, "world": ax.size, "backend": dist.get_backend(),
           "device": str(dev)}
    bk = RandomProjectionBackend(device=dev, mesh=mesh)

    def clustering(telemetry):
        (obs_device.enable_device if telemetry else obs_device.disable_device)()
        metrics.reset()
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res = laf_dbscan(data, eps, tau, alpha, pred, backend=bk)
        torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t0
        g = metrics.snapshot()
        row = {"seconds": secs, "labels": res.labels, "core": res.core, "n_range_queries": res.n_range_queries,
               "n_clusters": res.n_clusters, "host_syncs": g.get("laf.cluster.host_syncs", 0),
               "rounds": g.get("laf.cluster.last_rounds"), "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
               "launches": {k: g.get(f"kernel.{k}.launches", 0) for k in PLANE_KERNELS},
               "plane": {k: v for k, v in g.items() if k.startswith("plane.")},
               "phases_s": {k.split(".")[-1][:-2]: v for k, v in g.items() if k.startswith("laf.phase.")},
               "telemetry": {k: v for k, v in g.items() if k.startswith("laf.telemetry.")}}
        if telemetry:
            row["sweep_stats"] = obs_device.last_sweep_stats()
        return row

    out["T"] = clustering(True)
    out["A"] = clustering(False)
    exec_idx = np.nonzero(pred >= alpha * tau)[0]
    slab, plan = bk.query_bitmap_device(exec_idx, eps)
    out["slab_sha"], out["slab_shape"] = sha256_of(slab), list(slab.shape)
    rows = torch.full((plan.nq_padded,), n, dtype=torch.int32, device=dev)
    rows[: len(exec_idx)] = torch.from_numpy(exec_idx).to(dev)
    fx = sharded_cluster_labels(slab, rows, tau, mesh=mesh, axes=bk._plan.axes, n=n, telemetry=True)
    rounds = int(fx[4])
    out["fix"] = {"rounds": rounds, "tele": fx[5].cpu().numpy(), "labels": sha256_of(fx[0][:n]),
                  "owner": sha256_of(fx[1][:n]), "col_sum": sha256_of(fx[2][:n]), "counts": sha256_of(fx[3])}

    def fixpoint(max_iters):
        return lambda: sharded_cluster_labels(slab, rows, tau, mesh=mesh, axes=bk._plan.axes, n=n,
                                              max_iters=max_iters, telemetry=False)

    out["fixpoint_ms"] = host_ms(fixpoint(PLANE_MAX_ITERS), reps=3, warmup=1)[0]
    out["fixpoint_active_ms"] = host_ms(fixpoint(max(rounds, 1)), reps=3, warmup=1)[0]
    (obs_device.enable_device if was else obs_device.disable_device)()
    return out


def plane_rank(rank, world, p):
    """A spawned rank of phase 15: its card (``cuda:0`` for every rank
    when ``p["share"]``, else ``cuda:rank``), the mesh, the data."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import obs

    obs.enable(trace=False, metrics_on=True)  # the launch counts are counters
    dev = torch.device("cuda", 0 if p["share"] else rank)
    torch.cuda.set_device(dev)
    mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("data",))
    return plane_run(mesh, np.load(p["data"]), p, dev)


def plane_expectations(bk, slab, exec_idx, eps, world):
    """What a world's ranks must hold, from the single-device run: each
    shard's block of the single-device slab (zero words past it) by
    sha256, and the per-chunk occupancy of a single-device count sweep
    against the database padded with zero rows as the plane pads it."""
    from types import SimpleNamespace

    import torch

    from repro_torch.distributed.index_plane import shard_plan
    from repro_torch.index.sweep import sweep_counts
    from repro_torch.obs import device as obs_device

    n = bk.n_points
    plan = shard_plan(SimpleNamespace(mesh_dim_names=("data",), shape=(world,)), n, tile=bk.db_tile)
    w_loc = plan.n_local // 32
    padded = torch.nn.functional.pad(slab, (0, w_loc * world - slab.shape[1]))
    shas = [sha256_of(padded[:, k * w_loc : (k + 1) * w_loc]) for k in range(world)]
    del padded
    t_lo, t_hi = bk.band(eps)
    q, q_sig = bk._gather(exec_idx)
    db = torch.nn.functional.pad(bk.data_device, (0, 0, 0, plan.n_pad))
    db_sig = torch.nn.functional.pad(bk._sigs_dev, (0, 0, 0, plan.n_pad))
    was = obs_device.device_enabled()
    obs_device.enable_device()
    sweep_counts(q, q_sig, db, db_sig, n, eps, t_lo, t_hi, chunk=bk.chunk, chunks_per_launch=bk.chunks_per_launch,
                 q_tile=bk.q_tile, db_tile=bk.db_tile)
    (obs_device.enable_device if was else obs_device.disable_device)()
    return {"plan": plan, "slab_shas": shas, "sweep_stats": obs_device.last_sweep_stats().copy()}


def plane_kernel_rows(bk, slab, exec_idx, eps, tau, plan, clock_hz):
    """The three kernels the plane puts on a path, against their plain
    versions at the shapes world 2 gives them on its first rank: K2 over
    that rank's words of the slab (the global labels' first slice), the
    update over the plane's global columns, and the Hamming filter's
    bitmap ``_stats`` body over one sweep launch's queries against that
    rank's rows (256-row chunks).  Exact equality; times back to back
    and queued."""
    import torch

    from repro_torch.kernels import cost
    from repro_torch.index.signatures import popcount32
    from repro_torch.kernels.hamming_filter import hamming_filter_into
    from repro_torch.kernels.hamming_filter.ref import hamming_filter_ref
    from repro_torch.kernels.label_prop import label_prop_rect
    from repro_torch.kernels.label_prop.ops import fixpoint_inputs
    from repro_torch.kernels.label_prop.ref import BIG, label_prop_rect_ref, label_prop_update_ref

    n, dev = bk.n_points, slab.device
    w_loc, cap = plan.n_local // 32, plan.n_padded
    block = torch.nn.functional.pad(slab, (0, w_loc * plan.n_shards - slab.shape[1]))[:, :w_loc].contiguous()
    r = block.shape[0]
    rows = torch.full((r,), n, dtype=torch.int32, device=dev)
    rows[: len(exec_idx)] = torch.from_numpy(exec_idx).to(dev)
    _, _, _, _, pos, init = fixpoint_inputs(block, rows, tau, n=n, cap=cap)
    big_rows = torch.full((r,), BIG, dtype=torch.int32, device=dev)
    lab = init[: w_loc * 32]
    m = label_prop_rect(big_rows, lab, block)
    m_out = torch.empty_like(m)
    stats = slab_stats(block)
    out = []
    b_ms, b_by = cost.label_prop_rect_cost(r, w_loc).bound_ms()
    out.append({
        "name": "label_prop_rect_plane", "shape": [r, w_loc], **stats,
        "max_abs_err": int((m.long() - label_prop_rect_ref(big_rows, lab, block).long()).abs().max()),
        "ms": time_ms(lambda: label_prop_rect(big_rows, lab, block, out=m_out)),
        "device_ms": queued_ms(lambda: label_prop_rect(big_rows, lab, block, out=m_out)),
        "plain_ms": time_ms(lambda: label_prop_rect_ref(big_rows, lab, block), reps=2, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by,
    })
    update, u = make_update({"init": init, "pos": pos}, m)
    update()
    b_ms, b_by = cost.label_prop_update_cost(cap, r).bound_ms()
    out.append({
        "name": "label_prop_update_plane", "shape": [cap],
        "max_abs_err": int((u.long() - label_prop_update_ref(init, m, pos).long()).abs().max()),
        "ms": time_ms(update), "device_ms": queued_ms(update),
        "plain_ms": time_ms(lambda: label_prop_update_ref(init, m, pos)), "bound_ms": b_ms, "bound_by": b_by,
    })
    t_lo, t_hi = bk.band(eps)
    q, q_sig = bk._gather(exec_idx[: bk.chunk * bk.chunks_per_launch])  # one sweep launch's queries
    nq = q.shape[0]
    db, db_sig = bk.data_device[: plan.n_local], bk._sigs_dev[: plan.n_local]
    nd, d, w = db.shape[0], db.shape[1], q_sig.shape[1]
    words = -(-nd // 32)
    chunk = bk.chunk

    def body():
        counts = torch.zeros(nq, dtype=torch.int32, device=dev)
        bm = torch.zeros((nq, words), dtype=torch.int32, device=dev)
        st = torch.zeros((-(-nq // chunk), 3), dtype=torch.int32, device=dev)
        hamming_filter_into(q, db, q_sig, db_sig, eps, t_lo, t_hi, counts, bm, stats=st, chunk_rows=chunk)
        return counts, bm, st

    kc, kb, ks = body()
    pc, pb, ps = hamming_filter_ref(q, db, q_sig, db_sig, eps, t_lo, t_hi, stats_chunk=chunk)
    pairs = flipped_pairs(kb, pb)
    margin = pair_margin(pairs, q, db, eps)
    tol = 2 * (d - 1) * 2.0 ** -24
    b_ms, b_by = cost.hamming_filter_cost(nq, nd, d, w, bitmap=True, stats_chunks=ks.shape[0]).bound_ms()
    out.append({
        "name": "hamming_filter_bitmap_stats_plane", "shape": [nq, nd, d, w],
        "max_abs_err": int((kc - pc).abs().max()), "triples_equal_plain": bool(torch.equal(ks, ps)),
        "bit_flips": len(pairs), "flip_max_margin": margin, "tolerance": tol,
        "ms": time_ms(body), "device_ms": queued_ms(body),
        "plain_ms": time_ms(lambda: hamming_filter_ref(q, db, q_sig, db_sig, eps, t_lo, t_hi, stats_chunk=chunk),
                            reps=2, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by + " (int8 tensor cores)", "popc_ms": popc_ms(nq, nd, w, clock_hz),
    })
    ok = out[0]["max_abs_err"] == 0 and out[1]["max_abs_err"] == 0
    ok &= bool(torch.equal(ks, ps)) and margin <= tol and bool(torch.equal(
        kc - pc, popcount32(kb).sum(1) - popcount32(pb).sum(1)))
    return ok, out


def plane_check(world_rows, ref, expect, max_iters=PLANE_MAX_ITERS):
    """One world's ranks against the single-device run; returns (ok,
    what failed)."""
    bad = []
    for o in world_rows:
        k, world = o["index"], o["world"]
        for run in ("A", "T"):
            got = o[run]
            if not (np.array_equal(got["labels"], ref["labels"]) and np.array_equal(got["core"], ref["core"])
                    and got["n_range_queries"] == ref["n_range_queries"]):
                bad.append(f"rank {k} run {run}: labels, core or n_range_queries")
            if got["rounds"] != ref["rounds"] or got["host_syncs"] != 1:
                bad.append(f"rank {k} run {run}: rounds {got['rounds']} / host syncs {got['host_syncs']}")
        if o["slab_sha"] != expect["slab_shas"][k]:
            bad.append(f"rank {k}: slab words differ from the single-device slab's block")
        fx = o["fix"]
        if any(fx[f] != ref["fix"][f] for f in ("labels", "owner", "col_sum", "counts")) or \
                fx["rounds"] != ref["fix"]["rounds"]:
            bad.append(f"rank {k}: the sharded fixpoint's outputs")
        tele, want = fx["tele"], ref["fix"]["tele"]
        if not np.array_equal(tele[:3], want[:3]) or not (
                np.array_equal(tele[3], want[3]) if world == 1 else (tele[3] >= tele[0]).all()):
            bad.append(f"rank {k}: per-round telemetry")
        if not np.array_equal(o["T"]["sweep_stats"], expect["sweep_stats"]):
            bad.append(f"rank {k}: the plane sweep's occupancy triples")
        la, lt = o["A"]["launches"], o["T"]["launches"]
        want_l = ({"label_prop_fixpoint": 1, "label_prop_rect": 0, "label_prop_update": 0} if world == 1 else
                  {"label_prop_fixpoint": 0, "label_prop_rect": max_iters, "label_prop_update": max_iters})
        if any(la[x] != v for x, v in want_l.items()) or la["hamming_filter"] == 0 or \
                lt["hamming_filter_bitmap_stats"] == 0 or la["row_popcount"] != 1 or la["col_reduce"] != 1:
            bad.append(f"rank {k}: launches {la} / telemetry run {lt}")
    return not bad, bad


def plane_line(world_rows, ref, expect, backend):
    """The phase line of one world."""
    rows = sorted(world_rows, key=lambda o: o["index"])
    a, t = rows[0]["A"], rows[0]["T"]
    return {
        "phase": "plane", "world": len(rows), "backend": backend, "device": [o["device"] for o in rows],
        "seconds": [o["A"]["seconds"] for o in rows], "single_device_seconds": ref["seconds"],
        "telemetry_on_seconds": [o["T"]["seconds"] for o in rows],
        "rounds": a["rounds"], "n_clusters": a["n_clusters"], "n_padded": expect["plan"].n_padded,
        "slab_shape": [o["slab_shape"] for o in rows],
        "launches": {k: a["launches"][k] for k in ("label_prop_rect", "label_prop_update", "label_prop_fixpoint",
                                                   "hamming_filter", "row_popcount", "col_reduce")},
        "launches_telemetry_on": {k: t["launches"][k] for k in ("hamming_filter_bitmap_stats", "label_prop_rect",
                                                                 "label_prop_update")},
        "phases_s": [o["A"]["phases_s"] for o in rows], "single_device_phases_s": ref["phases_s"],
        "plane": [o["A"]["plane"] for o in rows], "plane_telemetry_on": [o["T"]["plane"] for o in rows],
        "peak_mem_bytes": [o["A"]["peak_mem_bytes"] for o in rows],
        "single_device_peak_mem_bytes": ref["peak_mem_bytes"],
        "fixpoint_ms": [o["fixpoint_ms"] for o in rows], "fixpoint_active_rounds_ms":
            [o["fixpoint_active_ms"] for o in rows],
        "idle_round_ms": [(o["fixpoint_ms"] - o["fixpoint_active_ms"]) / max(PLANE_MAX_ITERS - o["fix"]["rounds"], 1)
                          for o in rows],
        "single_device_fixpoint_ms": ref["fixpoint_ms"],
        "shard_wins": [int(o["fix"]["tele"][3].sum()) for o in rows],
        "frontier": int(rows[0]["fix"]["tele"][0].sum()),
        "collectives_stage_through_host": backend == "gloo",
    }


def plane_phase(data, pred, eps, tau, alpha, dev, clock_hz):
    """Phase 15: LAF-DBSCAN on the sharded index plane, at world 1 over
    NCCL in this process, world 2 over gloo as two spawned ranks sharing
    this card, and, with two or more cards, world min(cards, 4) over NCCL
    a rank a card; each held to the single-device run on the card (the
    same data and predictions).  Returns (ok, kernel rows, launches of
    the plane's world-2 path)."""
    import os
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.laf_dbscan import laf_dbscan
    from repro_torch.index.random_projection import RandomProjectionBackend
    from repro_torch.kernels.label_prop import packed_cluster_labels
    from repro_torch.obs import device as obs_device
    from repro_torch.obs import metrics
    from repro_torch.testing.ranks import run_ranks

    t_phase = time.perf_counter()
    n = data.shape[0]
    exec_idx = np.nonzero(pred >= alpha * tau)[0]
    bk = RandomProjectionBackend(device=dev).fit(data)
    was = obs_device.device_enabled()
    obs_device.enable_device()
    laf_dbscan(data, eps, tau, alpha, pred, backend=bk)  # warm-up, as each rank's telemetry run
    obs_device.disable_device()
    metrics.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = laf_dbscan(data, eps, tau, alpha, pred, backend=bk)
    torch.cuda.synchronize()
    g = metrics.snapshot()
    ref = {"seconds": time.perf_counter() - t0, "labels": res.labels, "core": res.core,
           "n_range_queries": res.n_range_queries, "rounds": g.get("laf.cluster.last_rounds"),
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "phases_s": {k.split(".")[-1][:-2]: v for k, v in g.items() if k.startswith("laf.phase.")}}
    slab, plan = bk.query_bitmap_device(exec_idx, eps)
    rows = torch.full((plan.nq_padded,), n, dtype=torch.int32, device=dev)
    rows[: len(exec_idx)] = torch.from_numpy(exec_idx).to(dev)
    fx = packed_cluster_labels(slab, rows, tau, n=n, telemetry=True)
    cap = fx[0].shape[0]
    ref["fix"] = {"rounds": int(fx[4]), "tele": fx[5].cpu().numpy(), "labels": sha256_of(fx[0][:n]),
                  "owner": sha256_of(fx[1][:n]), "col_sum": sha256_of(fx[2][:n]), "counts": sha256_of(fx[3])}
    ref["fixpoint_ms"] = host_ms(lambda: packed_cluster_labels(slab, rows, tau, n=n, telemetry=False), reps=3,
                                 warmup=1)[0]
    del fx
    worlds = [(1, "nccl"), (2, "gloo")]
    if torch.cuda.device_count() >= 2:
        worlds.append((min(torch.cuda.device_count(), PLANE_WORLDS_MAX), "nccl"))
    expect = {w: plane_expectations(bk, slab, exec_idx, eps, w) for w, _ in worlds}
    k_ok, k_rows = plane_kernel_rows(bk, slab, exec_idx, eps, tau, expect[2]["plan"], clock_hz)
    del slab, rows
    bk = None
    torch.cuda.empty_cache()
    emit({"phase": "plane_reference", "seconds": time.perf_counter() - t_phase, "n": n, "n_exec": len(exec_idx),
          "cap": cap, "seconds_single_device": ref["seconds"], "rounds": ref["rounds"],
          "fixpoint_ms": ref["fixpoint_ms"], "kernels_ok": k_ok})
    ok, launches = k_ok, {}
    with tempfile.TemporaryDirectory(prefix="plane-") as tmp:
        path = os.path.join(tmp, "data.npy")
        np.save(path, data)
        p = {"data": path, "pred": pred, "eps": eps, "tau": tau, "alpha": alpha}
        for world, backend in worlds:
            t0 = time.perf_counter()
            if world == 1:
                dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store1"), 1), rank=0,
                                        world_size=1, timeout=timedelta(seconds=300))
                try:
                    mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
                    got = [plane_run(mesh, data, p, dev)]
                finally:
                    dist.destroy_process_group()
            else:
                got = run_ranks(plane_rank, world, dict(p, share=backend == "gloo"), backend=backend,
                                timeout=300)
            w_ok, bad = plane_check(got, ref, expect[world])
            line = plane_line(got, ref, expect[world], backend)
            emit({**line, "wall_s": time.perf_counter() - t0, "ok": w_ok, "failed": bad})
            ok &= w_ok
            if world == 2:
                a, t = got[0]["A"]["launches"], got[0]["T"]["launches"]
                launches = {"label_prop_rect_plane": a["label_prop_rect"],
                            "label_prop_update_plane": a["label_prop_update"],
                            "hamming_filter_bitmap_stats_plane": t["hamming_filter_bitmap_stats"]}
    (obs_device.enable_device if was else obs_device.disable_device)()
    torch.cuda.empty_cache()
    emit({"phase": "plane", "seconds": time.perf_counter() - t_phase, "ok": ok,
          "worlds": [f"{w} {b}" for w, b in worlds]})
    return ok, k_rows, launches


TOOLING_CPU_ROWS = 32  # frontier rows held to the CPU copies (the plain Hamming filter: ~3 s for 32 here)


def dispatch_cost_us(dev, reps: int = 300) -> dict:
    """Microseconds an operator call adds over its raw launch function
    (``custom_op``'s ``_init_fn``), for one op returning a tensor and one
    mutating its arguments: each timed back to back over ``reps`` calls
    on tiny operands, the device synchronized at both ends."""
    import torch

    from repro_torch.kernels.label_prop.ops import _label_prop_rect_op
    from repro_torch.kernels.popcount.ops import _row_popcount_op

    words = torch.randint(0, 2**31 - 1, (64, 4), dtype=torch.int32, device=dev)
    labels = torch.arange(128, dtype=torch.int32, device=dev)
    rows = torch.full((64,), 2**31 - 1, dtype=torch.int32, device=dev)
    out = torch.empty(64, dtype=torch.int32, device=dev)
    return _dispatch_cost({"row_popcount": (_row_popcount_op, (words, None, None)),
                           "label_prop_rect": (_label_prop_rect_op, (rows, labels, words, out, None, False))}, reps)


def _dispatch_cost(calls: dict, reps: int) -> dict:
    """{name: op_us, raw_us, added_us} of ``calls`` ({name: (operator,
    args)}): the operator and its ``_init_fn`` each timed back to back over
    ``reps`` calls, in turns (op, raw, op, raw), synchronized at both ends."""
    import torch

    res = {}
    for name, (op, a) in calls.items():
        t = {}
        for kind, fn in (("op", op), ("raw", op._init_fn), ("op2", op), ("raw2", op._init_fn)):
            fn(*a)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn(*a)
            torch.cuda.synchronize()
            t[kind] = (time.perf_counter() - t0) / reps * 1e6
        res[name] = {"op_us": (t["op"] + t["op2"]) / 2, "raw_us": (t["raw"] + t["raw2"]) / 2,
                     "added_us": (t["op"] + t["op2"] - t["raw"] - t["raw2"]) / 2}
    return res


def _cell_run(fn, args):
    """One warm call, then one on zeroed counters: (outputs, launches,
    seconds, the call's peak bytes over what was allocated before it,
    ``max_memory_allocated`` after it)."""
    import torch

    from repro_torch.obs import metrics

    fn(*args)
    torch.cuda.synchronize()
    metrics.reset()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: v for k, v in metrics.snapshot("kernel.").items() if k.endswith(".launches") and v}
    peak = torch.cuda.max_memory_allocated()
    return out, launches, seconds, peak - before, peak


def _arg_bytes(args) -> int:
    import torch

    total = 0
    for a in args:
        ts = list(a.parameters()) if isinstance(a, torch.nn.Module) else [a] if torch.is_tensor(a) else []
        total += sum(t.numel() * t.element_size() for t in ts)
    return total


def frontier_parity(dc, dp, near, ham, q_flips, db_flips, gate_near, band):
    """Hold the card's frontier cell to its CPU copy pair by pair.  ``dc``
    (rows,) and ``dp`` (n,) are the absolute count and partial-count
    differences, ``near`` (rows, n) bool the pairs whose dot lies within
    the tolerance of ``1 - eps``, ``ham`` (rows, n) the CPU copy's
    Hamming distances, ``q_flips`` (rows,) and ``db_flips`` (n,) the
    signature bits that the card's signing and the CPU's disagree on,
    ``gate_near`` (rows,) bool the predictions within tolerance of
    ``alpha * tau``, ``band`` the cell's ``(t_lo, t_hi)``.  A pair may
    flip if it is near, or if its distance moves by its k flipped bits
    across a band edge; a row's count may differ by its row's pairs that
    may flip, and a partial count by its column's.  A gate on alpha * tau
    excuses its row's count (0 on one side), never a partial count: the
    gate does not touch those.  Returns ``(counts_ok, partial_ok,
    pairs_that_may_flip)``."""
    t_lo, t_hi = band
    k = q_flips[:, None] + db_flips[None, :]
    edge = (ham > t_hi - k) & (ham <= t_hi + k)
    if t_lo >= 0:
        edge |= (ham > t_lo - k) & (ham <= t_lo + k)
    may = near | edge
    counts_ok = bool(((dc <= may.sum(dim=1)) | gate_near).all())
    partial_ok = bool((dp <= may.sum(dim=0)).all())
    return counts_ok, partial_ok, int(may.sum())


# phase 16's model cells (A12b): ``launch.steps.build_cell``'s LM, recsys and
# GNN cells on the card at world 1 (NCCL), each held to its single-device step
CELL_LM = ("llama3-8b", 2, 2, 2048)  # (arch, layers kept of 32, batch rows, tokens a row): phase 17's cut
CELL_LM_LOSS_REL, CELL_LM_NORM_REL = 1e-4, 1e-3
CELL_REL, CELL_LEAF_REL = 1e-5, 1e-4
CELL_TOL = (f"llama3-8b train cell (bf16) vs the single-device lm_train_step: loss |cell - single| <= "
            f"{CELL_LM_LOSS_REL} |single|, grad norm <= {CELL_LM_NORM_REL} |single|; bst retrieval scores and the "
            f"GAT step (fp32): loss and scores relative (L2) <= {CELL_REL}, updated leaves relative L2 <= "
            f"{CELL_LEAF_REL}; the trace's launches equal the card's counters; the LM cell's trace-to-card peak "
            f"ratio within [0.8, 1.25]")
CELL_PEAK_RATIO = (0.8, 1.25)
# the dry run's model cells on the card: the named subset on pod16x16 but
# deepseek-v2-236b:train_4k, whose 60 layers x 16 microbatches trace in ~430 s
# on a CPU (the full set is written on the CPU: PERF.md section 6)
CELL_DRYRUN = ("llama3-8b:train_4k,llama3-8b:prefill_32k,llama3-8b:decode_32k,gemma3-27b:long_500k:windowed,"
               "gat-cora:ogb_products,bst:train_batch,bst:serve_p99,bst:retrieval_cand")
CELL_DRYRUN_CLUSTER = "laf_dbscan:nyt_150k,laf_dbscan:glove_150k,laf_dbscan:ms_150k,laf_dbscan:web_1b"
CELL_DRYRUN_LEFT = "deepseek-v2-236b:train_4k (its trace takes ~430 s: the CPU run holds its record)"


def _dict_bytes(tree) -> int:
    import torch

    if isinstance(tree, dict):
        return sum(_dict_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_dict_bytes(v) for v in tree)
    return tree.numel() * tree.element_size() if torch.is_tensor(tree) and tree.device.type != "cpu" else 0


def _rel_l2(a, b) -> float:
    import torch

    a, b = torch.as_tensor(a).detach().double().cpu(), torch.as_tensor(b).detach().double().cpu()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def _launched() -> dict:
    from repro_torch.obs import metrics

    return {k: v for k, v in metrics.snapshot("kernel.").items() if k.endswith(".launches") and v}


def _card_cell(cell, args):
    """One call of ``cell.step_fn`` on the card with the launch counts set
    to 0 just before and read just after: (outputs, launches, seconds,
    the card's peak = the arguments' bytes + max_memory_allocated over the
    call less what was allocated before it)."""
    import torch

    from repro_torch.obs import metrics

    torch.cuda.synchronize()
    metrics.reset()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = cell.step_fn(*args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return out, _launched(), seconds, _dict_bytes(args) + torch.cuda.max_memory_allocated() - before


def cell_lm_train(mesh, dev) -> dict:
    """llama3-8b ``train_4k``'s cell at full width, ``CELL_LM``'s depth and
    batch, bf16: the cell's step on the card against the single-device
    ``lm_train_step`` from the same weights and batch; then the same cell
    traced on ``meta`` tensors (launches, peak)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.data.pipeline import lm_batches
    from repro_torch.launch.cell import shard_args
    from repro_torch.launch.steps import build_cell, lm_optimizer, lm_train_step
    from repro_torch.launch.trace_analysis import analyze_trace
    from repro_torch.models import transformer as tt
    from repro_torch.train.optimizer import param_tree

    name, layers, b, s = CELL_LM
    arch = get_arch(name)
    cfg = dataclasses.replace(arch.make_config(), n_layers=layers)
    arch = dataclasses.replace(arch, make_config=lambda: cfg)
    cell = build_cell(arch, ShapeSpec("train_4k", "train", {"seq_len": s, "global_batch": b}), mesh)
    model = tt.transformer_init(0, cfg, device=dev)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in lm_batches(0, b, s, cfg.vocab)(0).items()}
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = lm_optimizer(cfg)
    args = shard_args(cell, mesh, (params, opt.init(params), batch))
    del params
    (_, _, m), launches, seconds, card_peak = _card_cell(cell, args)
    loss, norm = float(m["loss"]), float(m["grad_norm"])
    del args, m
    torch.cuda.empty_cache()
    tree = param_tree(model)
    _, _, want = lm_train_step(model, cfg, tree, opt.init(tree), batch)
    want_loss, want_norm = float(want["loss"]), float(want["grad_norm"])
    del model, tree, want
    torch.cuda.empty_cache()
    tr = analyze_trace(cell.step_fn, *cell.args)
    ratio = tr.peak_live_bytes / card_peak
    ok = (abs(loss - want_loss) <= CELL_LM_LOSS_REL * abs(want_loss)
          and abs(norm - want_norm) <= CELL_LM_NORM_REL * abs(want_norm)
          and tr.launches == launches and not tr.error and CELL_PEAK_RATIO[0] <= ratio <= CELL_PEAK_RATIO[1])
    return {"cell": cell.name, "layers": layers, "batch": [b, s], "seconds": seconds, "loss": loss,
            "single_loss": want_loss, "grad_norm": norm, "single_grad_norm": want_norm, "launches": launches,
            "trace_launches": tr.launches, "trace_peak_bytes": tr.peak_live_bytes, "card_peak_bytes": card_peak,
            "peak_ratio": ratio, "trace_collectives": tr.collective_summary()["total"], "ok": ok}


def cell_bst_retrieval(mesh, dev) -> dict:
    """bst ``retrieval_cand``'s cell at full width (a 5,000,000 x 32 item
    table, 1,000,000 candidates) against the single-device user tower and
    ``retrieval_scores``; its ``embedding_bag`` launches against the
    trace's."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.cell import shard_args
    from repro_torch.launch.steps import build_cell
    from repro_torch.launch.trace_analysis import analyze_trace
    from repro_torch.models import recsys

    arch = get_arch("bst")
    shape = arch.shapes["retrieval_cand"]
    cfg = arch.make_config()
    cell = build_cell(arch, shape, mesh)
    model = recsys.bst_init(0, cfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    hist = torch.randint(0, cfg.item_vocab, (shape.meta["batch"], cfg.seq_len), generator=g, device=dev,
                         dtype=torch.int32)
    cands = torch.randn((shape.meta["n_candidates"], cfg.embed_dim), generator=g, device=dev)
    params = {n: p.detach() for n, p in model.named_parameters()}
    args = shard_args(cell, mesh, (params, {"hist": hist, "target": hist[:, 0].contiguous()}, cands))
    out, launches, seconds, _ = _card_cell(cell, args)
    got = out.full_tensor() if hasattr(out, "full_tensor") else out
    want = recsys.retrieval_scores(recsys.bst_user_embedding(model, cfg, hist), cands)
    rel = _rel_l2(got, want)
    tr = analyze_trace(cell.step_fn, *cell.args)
    ok = rel <= CELL_REL and launches == tr.launches and bool(torch.isfinite(got).all()) and not tr.error
    return {"cell": cell.name, "seconds": seconds, "scores_rel_l2": rel, "launches": launches,
            "trace_launches": tr.launches, "ok": ok}


def cell_gat(mesh, dev) -> dict:
    """gat-cora ``full_graph_sm``'s cell (2,708 nodes, 10,556 edges of
    ``powerlaw_graph``) against ``gnn_train_step`` from the same weights."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.configs.gat_cora import config_for_shape
    from repro_torch.data.synthetic import powerlaw_graph
    from repro_torch.launch.cell import shard_args
    from repro_torch.launch.steps import build_cell, gnn_optimizer, gnn_train_step, pad_edges
    from repro_torch.models import gnn
    from repro_torch.train.optimizer import tree_leaves, tree_map

    arch = get_arch("gat-cora")
    shape = arch.shapes["full_graph_sm"]
    cfg = config_for_shape(shape.name)
    cell = build_cell(arch, shape, mesh)
    rng = np.random.default_rng(9)
    graph = powerlaw_graph(rng, shape.meta["n_nodes"], shape.meta["n_edges"], shape.meta["d_feat"])
    graph["label_mask"] = (rng.random(shape.meta["n_nodes"]) < 0.5).astype(np.float32)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in pad_edges(graph, mesh.size()).items()}
    params = gnn.gat_init(0, cfg, device=dev)
    mine = tree_map(lambda t: t.detach().clone(), params)
    args = shard_args(cell, mesh, (mine, gnn_optimizer().init(mine), batch))
    (new, _, m), _, seconds, _ = _card_cell(cell, args)
    got = tree_map(lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t, new)
    want_params, _, want = gnn_train_step(cfg, params, gnn_optimizer().init(params), batch)
    loss_rel = abs(float(m["loss"]) - float(want["loss"])) / abs(float(want["loss"]))
    leaf_rel = max(_rel_l2(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want_params)))
    ok = loss_rel <= CELL_REL and leaf_rel <= CELL_LEAF_REL
    return {"cell": cell.name, "seconds": seconds, "loss": float(m["loss"]), "single_loss": float(want["loss"]),
            "loss_rel": loss_rel, "leaf_rel_l2_max": leaf_rel, "ok": ok}


_MUTATING = []


def _mutating_attention_op():
    """``flash_attention``'s launch behind an operator that writes the
    log-sum-exp into a buffer it is given (``mutates_args``), registered
    once, for ``model_dispatch_cost_us``'s comparison."""
    import torch

    from repro_torch.kernels.flash_attention import ops

    if not _MUTATING:
        @torch.library.custom_op("repro_smoke::flash_attention_lse_mutating", mutates_args=("lse",),
                                 device_types="cuda", schema="(Tensor q, Tensor k, Tensor v, Tensor(a!) lse, "
                                 "bool causal, int? window, float scale, int q_offset) -> Tensor")
        def op(q, k, v, lse, causal, window, scale, q_offset):
            return ops._launch(q, k, v, causal, window, scale, q_offset, lse)

        _MUTATING.append(op)
    return _MUTATING[0]


def model_dispatch_cost_us(dev, reps: int = 300) -> dict:
    """Microseconds each of phase 16's new operators (``flash_attention``,
    ``flash_attention_lse``, ``flash_attention_bwd``, ``embedding_bag``)
    adds over its raw launch function, as ``dispatch_cost_us`` times the
    cluster operators; ``flash_attention_lse_mutating``: the same launch
    behind an operator that mutates a log-sum-exp buffer it is given (the
    form the operator first had); ``flash_attention`` also at the decode
    path's shape under ``torch.inference_mode`` (the serving entry points'
    mode), with a ``cProfile`` of those calls: the Python functions that
    take the most time of their own."""
    import cProfile
    import io
    import pstats

    import torch

    from repro_torch.kernels.embedding_bag.ops import _embedding_bag_op
    from repro_torch.kernels.flash_attention.ops import _attention_bwd_op, _attention_lse_op, _attention_op

    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn((1, 2, 128, 128), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    out, lse = _attention_lse_op(q, k, v, True, None, 0.088, 0)
    dout = torch.randn(out.shape, generator=g, device=dev).to(torch.bfloat16)
    table = torch.randn((1000, 32), generator=g, device=dev)
    ids = torch.randint(0, 1000, (64, 8), generator=g, device=dev, dtype=torch.int32)
    res = _dispatch_cost({
        "flash_attention_lse_mutating": (_mutating_attention_op(), (q, k, v, lse, True, None, 0.088, 0)),
        "flash_attention": (_attention_op, (q, k, v, True, None, 0.088, 0)),
        "flash_attention_lse": (_attention_lse_op, (q, k, v, True, None, 0.088, 0)),
        "flash_attention_bwd": (_attention_bwd_op, (q, k, v, out, lse, dout, True, None, 0.088, 0)),
        "embedding_bag": (_embedding_bag_op, (table, ids, True)),
    }, reps)
    with torch.inference_mode():
        b, sk = LM_PREFILL[0], LM_PROMPT + LM_NEW
        qd = torch.randn((b, 32, 1, 128), generator=g, device=dev).to(torch.bfloat16)
        kd, vd = (torch.randn((b, 8, sk, 128), generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
        call = (qd, kd, vd, True, None, 0.088, sk - 1)
        res["flash_attention_decode_inference_mode"] = _dispatch_cost({"op": (_attention_op, call)}, reps)["op"]
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(reps):
            _attention_op(*call)
        prof.disable()
        torch.cuda.synchronize()
    buf = io.StringIO()
    stats = pstats.Stats(prof, stream=buf)
    top = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:8]  # by time of its own
    res["flash_attention_decode_inference_mode"]["profile_us_per_call"] = [
        {"function": f"{fn[0].split('site-packages/')[-1]}:{fn[1]}({fn[2]})", "own_us": 1e6 * st[2] / reps,
         "cumulative_us": 1e6 * st[3] / reps} for fn, st in top]
    return res


def model_cells(mesh, dev):
    """Phase 16's model cells on the card (``cell_lm_train``,
    ``cell_bst_retrieval``, ``cell_gat``) and the new operators' dispatch
    cost.  Returns (ok, line fragment)."""
    import torch

    out = {"tolerance": CELL_TOL}
    ok = True
    for name, fn in (("llama3_8b_train", cell_lm_train), ("bst_retrieval", cell_bst_retrieval),
                     ("gat_full_graph_sm", cell_gat)):
        out[name] = fn(mesh, dev)
        ok &= out[name]["ok"]
        torch.cuda.empty_cache()
    out["dispatch"] = model_dispatch_cost_us(dev)
    return ok, out


def tooling_phase(data, est, eps, tau, dev, builds_after_phase2, phase3_launches):
    """Phase 16 (see the module docstring).  Returns (ok, phase line)."""
    import contextlib
    import io
    import os
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.analysis.__main__ import main as lint_main
    from repro_torch.configs.registry import ShapeSpec, get_arch
    from repro_torch.index.signatures import hamming_words, make_projection, pack_bits, popcount32
    from repro_torch.kernels import _build
    from repro_torch.kernels.hamming_filter import hamming_filter_bitmap
    from repro_torch.kernels.label_prop import packed_cluster_labels
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.laf_cluster import (
        build_laf_cluster, build_one_launch_cluster, frontier_inputs, slab_inputs,
    )
    from repro_torch.launch.trace_analysis import analyze_trace

    t_phase = time.perf_counter()
    n, d = data.shape
    shape = ShapeSpec("ms_150k", "cluster", {"n_points": n, "dim": d})
    arch = dryrun.cluster_arch(get_arch("laf_dbscan"))
    sub = dryrun.cluster_arch(get_arch("laf_dbscan"), frontier=TOOLING_CPU_ROWS, index_device=True)
    line = {"phase": "tooling", "shape": [n, d]}
    ok = True
    with tempfile.TemporaryDirectory(prefix="tooling-") as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0, world_size=1,
                                timeout=timedelta(seconds=300))
        try:
            mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
            fc = build_laf_cluster(arch, shape, mesh, device=dev)
            oc = build_one_launch_cluster(arch, shape, mesh, device=dev)
            f = fc.meta["frontier"]
            f_args = (est.model,) + frontier_inputs(fc, mesh, data, data[:f], device=dev)
            (counts, _, pred), f_launches, f_s, f_peak, f_max = _cell_run(fc.step_fn, f_args)
            # the first rows on CPU copies through the plain versions, and the
            # same small cell on the card for its partial counts
            cpu_cell = build_laf_cluster(sub, shape, mesh, device="cpu")
            card_cell = build_laf_cluster(sub, shape, mesh, device=dev)
            rows = TOOLING_CPU_ROWS
            t0 = time.perf_counter()
            cpu_in = frontier_inputs(cpu_cell, mesh, data, data[:rows], device="cpu")
            cpu = cpu_cell.step_fn(copy.deepcopy(est.model).cpu(), *cpu_in)
            cpu_s = time.perf_counter() - t0
            card = card_cell.step_fn(est.model, f_args[1], f_args[2][:rows].contiguous(), f_args[3])
            qf = torch.from_numpy(np.ascontiguousarray(data[:rows], np.float32)).to(dev)
            dots = qf.double() @ f_args[1].double().T
            tol = 2 * (d - 1) * 2.0 ** -24
            near = ((dots - (1.0 - eps)).abs() <= tol).cpu()
            proj = make_projection(d, sub.make_config().index_bits, seed=sub.make_config().index_seed)
            sig_card = pack_bits((qf @ torch.from_numpy(proj).to(dev)) >= 0.0).cpu()
            sig_cpu = pack_bits((qf.cpu() @ torch.from_numpy(proj)) >= 0.0)
            q_flips = popcount32(sig_card ^ sig_cpu).sum(dim=1)
            db_flips = popcount32(f_args[3].cpu() ^ cpu_in[2]).sum(dim=1)
            ham = hamming_words(sig_cpu.to(dev), cpu_in[2].to(dev)).cpu()
            dc = (counts[:rows].cpu().long() - cpu[0].long()).abs()
            dp = (card[1].cpu().long() - cpu[1].long()).abs()
            thr = sub.make_config().alpha * sub.make_config().tau
            gate_near = (cpu[2] - thr).abs() <= TOL_RMI * (1 + thr)
            pred_ok = bool(((pred[:rows].cpu() - cpu[2]).abs() <= TOL_RMI * (1 + cpu[2].abs())).all())
            counts_ok, partial_ok, may_flip = frontier_parity(dc, dp, near, ham, q_flips, db_flips, gate_near,
                                                              card_cell.meta["index_band"])
            frontier_ok = pred_ok and counts_ok and partial_ok
            # the one-launch cell on the frontier's Hamming slab
            q, q_sig = f_args[2], pack_bits((f_args[2] @ torch.from_numpy(proj).to(dev)) >= 0.0)
            t_lo, t_hi = fc.meta["index_band"]
            _, slab = hamming_filter_bitmap(q, f_args[1], q_sig, f_args[3], eps, t_hi, t_lo=t_lo)
            slab_rows = np.arange(f, dtype=np.int32)
            o_args = slab_inputs(oc, mesh, slab, slab_rows, tau, device=dev)
            o_out, o_launches, o_s, o_peak, o_max = _cell_run(oc.step_fn, o_args)
            want = packed_cluster_labels(slab, torch.from_numpy(slab_rows).to(dev), tau, n=n)
            one_ok = all(bool(torch.equal(a, b)) for a, b in zip(o_out[:5], want[:5]))
            # the same two cells traced on fake tensors
            fake_f, fake_o = build_laf_cluster(arch, shape, mesh), build_one_launch_cluster(arch, shape, mesh)
            tf, to = analyze_trace(fake_f.step_fn, *fake_f.args), analyze_trace(fake_o.step_fn, *fake_o.args)
            f_card_peak, o_card_peak = f_peak + _arg_bytes(f_args), o_peak + _arg_bytes(o_args)
            del f_args, o_args, cpu_in, card, qf, dots
            torch.cuda.empty_cache()
            # the LM, recsys and GNN cells on the card, held to their single-device steps and traced
            t0 = time.perf_counter()
            cells_ok, cells_line = model_cells(mesh, dev)
            cells_line["seconds"] = time.perf_counter() - t0
        finally:
            dist.destroy_process_group()
    trace_ok = tf.launches == f_launches and to.launches == o_launches and not tf.error and not to.error
    line.update({
        "frontier": {"seconds": f_s, "launches": f_launches, "rows_held_to_cpu": rows, "cpu_seconds": cpu_s,
                     "pred_ok": pred_ok, "count_rows_differing": int((dc > 0).sum()),
                     "pairs_within_tol": int(near.sum()), "tolerance": tol,
                     "signature_bit_flips": int(q_flips.sum() + db_flips.sum()), "pairs_that_may_flip": may_flip,
                     "gates_within_tol": int(gate_near.sum()), "partial_abs_diff": int(dp.sum()),
                     "counts_ok": counts_ok, "partial_ok": partial_ok, "ok": frontier_ok},
        "one_launch": {"seconds": o_s, "launches": o_launches, "rounds": int(o_out[4]),
                       "equals_packed_cluster_labels": one_ok},
        "trace": {"frontier_launches": tf.launches, "one_launch_launches": to.launches,
                  "launches_equal_card": trace_ok,
                  "frontier_peak_bytes": tf.peak_live_bytes, "frontier_card_peak_bytes": f_card_peak,
                  "frontier_max_memory_allocated": f_max, "one_launch_max_memory_allocated": o_max,
                  "frontier_peak_ratio": tf.peak_live_bytes / f_card_peak,
                  "one_launch_peak_bytes": to.peak_live_bytes, "one_launch_card_peak_bytes": o_card_peak,
                  "one_launch_peak_ratio": to.peak_live_bytes / o_card_peak},
    })
    ok &= frontier_ok and one_ok and trace_ok
    line["model_cells"] = cells_line
    ok &= cells_ok
    # laf-lint on the card, in this process
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = lint_main(["--corpus", str(ROOT / "tests" / "analysis_corpus_torch"), "--repo-root", str(ROOT)])
    print(buf.getvalue(), file=sys.stderr)
    builds = sum(_build.BUILDS.values())
    line["lint"] = {"rc": rc, "seconds": time.perf_counter() - t0, "report": buf.getvalue().strip().splitlines()[-2:],
                    "builds_after_phase2": builds - builds_after_phase2}
    ok &= rc == 0 and builds == builds_after_phase2
    # the operators' dispatch cost, and what it adds to phase 3's clustering
    cost_us = dispatch_cost_us(dev)
    added = max(v["added_us"] for v in cost_us.values())
    n_launches = sum(phase3_launches.values())
    line["dispatch"] = {"per_call_us": cost_us, "phase3_launches": n_launches,
                        "phase3_added_ms_at_most": added * n_launches / 1e3}
    # what the attention operator's dispatch adds to phase 9's decode path (34,816 calls)
    line["model_cells"]["decode_path_added_ms"] = (
        line["model_cells"]["dispatch"]["flash_attention_decode_inference_mode"]["added_us"] * 32
        * (LM_PROMPT + LM_NEW) / 1e3)
    # the dry run on fake ranks, and its roofline: every cluster record on both
    # meshes, and the model cells' named subset on pod16x16
    t0 = time.perf_counter()
    out_dir = ROOT / "artifacts" / "dryrun_torch"
    rc = dryrun.main(["--cells", CELL_DRYRUN_CLUSTER, "--mesh", "both", "--out", str(out_dir), "--quiet"])
    cluster_s = time.perf_counter() - t0
    rc_cells = dryrun.main(["--cells", CELL_DRYRUN, "--mesh", "single", "--out", str(out_dir), "--quiet"])
    tables = roofline.build_table(out_dir)
    recs = [r for rows_ in tables.values() for r in rows_ if r.arch == "laf_dbscan"]
    cell_recs = [r for r in tables.get("pod16x16", []) if r.arch != "laf_dbscan"]
    for mesh_name, rows_ in tables.items():
        print(roofline.to_markdown(rows_, mesh_name), file=sys.stderr)
    keys = ("arch", "shape", "mesh", "status", "compute_s", "memory_s", "collective_s", "bound", "mem_gib", "note")
    line["dryrun"] = {"rc": rc, "seconds": time.perf_counter() - t0, "cluster_seconds": cluster_s,
                      "records": len(recs), "ok": sum(r.status == "ok" for r in recs),
                      "roofline": [{k: v for k, v in r.as_dict().items() if k in keys} for r in recs],
                      "model_cells": {"rc": rc_cells, "cells": CELL_DRYRUN, "left_to_the_cpu_run": CELL_DRYRUN_LEFT,
                                      "records": len(cell_recs), "ok": sum(r.status == "ok" for r in cell_recs),
                                      "roofline": [{k: v for k, v in r.as_dict().items() if k in keys}
                                                   for r in cell_recs]}}
    ok &= rc == 0 and len(recs) == 16 and all(r.status == "ok" for r in recs)
    ok &= rc_cells == 0 and len(cell_recs) == len(CELL_DRYRUN.split(",")) and all(
        r.status == "ok" for r in cell_recs)
    line["seconds"] = time.perf_counter() - t_phase
    line["ok"] = ok
    return ok, line


# phase 17: the LM steps sharded over the ranks of a mesh (A10b), each held
# to the port's single-device step of the same config and weights on this card
SHARDED_LM = {
    # name: (layers kept, batch rows, tokens a row, meshes that train it, why these layers)
    "llama3-8b": (2, 2, 2048, ((1, 2), (2, 1)), "2 of 32"),
    "deepseek-v2-236b": (2, 1, 2048, ((1, 2),), "2 of 60: the dense prefix + 1 MoE layer of 160 experts "
                                                "(expert parallel at model 2)"),
}
SHARDED_PROMPT, SHARDED_NEW, SHARDED_CACHE = 16, 8, 64  # decode at (1, 2): prompt fed a token a step, greedy steps
SHARDED_LOSS_REL, SHARDED_NORM_REL = 1e-3, 1e-2
SHARDED_TOL = (f"bf16 on both: loss |sharded - single| <= {SHARDED_LOSS_REL} |single|, grad norm <= "
               f"{SHARDED_NORM_REL} |single|, each compared leaf's gradient relative L2 <= {GRAD_REL_L2} (phase 14's "
               f"bf16 bound; TRAIN_STEP_TOL's 1e-4 and 1e-5 hold fp32 steps on both sides), prefill and decode "
               f"logits relative L2 <= {LM_REL_L2} and max |diff| <= {LM_MAX_ABS} (PERF.md section 2); MoE positions "
               f"whose experts flip counted, at least 90% kept")


def sharded_cfg(name):
    """(cut config, full config) of a ``SHARDED_LM`` model: full width,
    its depth cut, remat on."""
    import dataclasses

    from repro_torch.configs import get_arch

    full = get_arch(name).make_config()
    return dataclasses.replace(full, n_layers=SHARDED_LM[name][0], remat=True), full


def compared_leaves(model):
    """The parameters whose gradients phase 17 compares: every leaf of
    one stacked layer (the first: attention, norms, the FFN or the MoE's
    router, experts and shared experts)."""
    return [n for n, _ in model.named_parameters() if n.startswith("layers.0.")]


def counted_sq(x, want):
    """(sum (x - want)^2, sum want^2) over this rank's shard of a DTensor
    ``x`` (every element counted on one rank: coordinate 0 of each mesh
    axis ``x`` is replicated over) against the whole ``want`` on the host,
    summed over the ranks in one all-reduce; a plain tensor alone."""
    import torch

    if not hasattr(x, "device_mesh"):
        w = want.to(x.device, torch.float32)
        return float(((x.float() - w) ** 2).sum()), float((w ** 2).sum())
    import torch.distributed as dist
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh, local = x.device_mesh, x.to_local()
    shape, off = compute_local_shape_and_global_offset(x.shape, mesh, x.placements)
    w = want[tuple(slice(o, o + n) for o, n in zip(off, shape))].to(local.device, torch.float32)
    sums = torch.stack([((local.float() - w) ** 2).sum(), (w ** 2).sum()])
    if not all(mesh.get_local_rank(i) == 0 for i, p in enumerate(x.placements) if p.is_replicate()):
        sums.zero_()
    dist.all_reduce(sums)
    return float(sums[0]), float(sums[1])


def sharded_train(name, mesh, dev, want=None):
    """One ``SHARDED_LM`` model's train step on ``mesh`` (None: the single
    device): the weights from ``transformer_init(0, cfg)``, batch 0 of
    ``lm_batches(0, B, S, V)``, one microbatch, the full model's
    optimizer policy (``lm_optimizer``, ``lm_ce_chunk``).  First
    ``lm_loss_and_grads`` (under ``CommDebugMode`` on a mesh: the
    collectives of a forward and backward by kind; MoE routes logged),
    then one ``lm_train_step`` timed, its launches and peak memory read
    around it.  ``want`` (the single-device run's ``grads_path``, loss
    and routes): each compared leaf's relative L2.  Returns a dict; on
    one device also the compared leaves' gradients on the host."""
    import torch

    from repro_torch.data.pipeline import lm_batches
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tt
    from repro_torch.obs import metrics
    from repro_torch.train.optimizer import global_norm, param_tree

    cfg, full = sharded_cfg(name)
    _, b, s, _, _ = SHARDED_LM[name]
    model = tt.transformer_init(0, cfg, device=dev)
    model.requires_grad_(True)
    leaves = compared_leaves(model)
    if mesh is not None:
        steps.shard_lm_params(model, cfg, mesh)
    batch = lm_batches(0, b, s, cfg.vocab)(0)
    kw = dict(mesh=mesh, n_microbatches=1, ce_chunk=steps.lm_ce_chunk(full))
    out = {"device": str(dev), "layers": cfg.n_layers, "batch": b, "tokens": s}
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    if mesh is not None:
        from torch.distributed.tensor.debug import CommDebugMode

        comm = CommDebugMode()
        with comm, route_log() as routes:
            loss, grads = steps.lm_loss_and_grads(model, cfg, batch, **kw)
        out["comms_fwd_bwd"] = {str(k).split(".")[-1]: int(v) for k, v in comm.get_comm_counts().items()}
    else:
        with route_log() as routes:
            loss, grads = steps.lm_loss_and_grads(model, cfg, batch, **kw)
    torch.cuda.synchronize(dev)
    out["first_s"] = time.perf_counter() - t0
    out["routes"] = [r.cpu().numpy() for r in routes.calls]  # numpy: a rank's result crosses a process
    names = sorted(n for n, _ in model.named_parameters())
    by_name = dict(zip(names, grads))
    out["grad_norm_first"], out["loss_first"] = float(global_norm(grads)), float(loss)
    if want is None:
        out["host_grads"] = {n: by_name[n].detach().cpu() for n in leaves}
    else:
        ref = torch.load(want["grads_path"], mmap=True)
        out["leaf_rel_l2"] = {}
        for n in leaves:
            d2, w2 = counted_sq(by_name[n], ref[n])
            out["leaf_rel_l2"][n] = (d2 / max(w2, 1e-30)) ** 0.5
        del ref
        flips = total = 0
        for got, exp in zip(out["routes"], want["routes"]):
            bad = (got != exp).any(-1)
            flips, total = flips + int(bad.sum()), total + bad.size
        out["route_flips"], out["routed_positions"] = flips, total
    del grads, by_name, loss
    params = param_tree(model)
    opt = steps.lm_optimizer(full)
    state = opt.init(params)
    metrics.reset()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params, state, m = steps.lm_train_step(model, cfg, params, state, batch, opt=opt, **kw)
    torch.cuda.synchronize(dev)
    out["step_s"] = time.perf_counter() - t0
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
    snap = metrics.snapshot()
    out["launches"] = {k: snap.get(f"kernel.{k}.launches", 0) for k in ("flash_attention", "flash_attention_bwd")}
    out["staged_all_gather_calls"] = snap.get("sharded.staged.all_gather.calls", 0)
    out["loss"], out["grad_norm"] = float(m["loss"]), float(m["grad_norm"])
    del model, params, state, m
    torch.cuda.empty_cache()
    return out


def sharded_serve(mesh, dev, want=None):
    """llama3-8b (``SHARDED_LM``'s depth) served at fresh weights: a
    prefill of the train batch (warmed, then timed) and a decode of
    ``SHARDED_PROMPT`` prompt tokens fed a token a step, then
    ``SHARDED_NEW`` steps fed the single-device run's greedy tokens, in a
    ``SHARDED_CACHE``-slot cache (``shard_lm_cache`` on a mesh); with
    ``want`` each logit row's gap to the single-device run's."""
    import torch

    from repro_torch.data.pipeline import lm_batches
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tt

    cfg, _ = sharded_cfg("llama3-8b")
    _, b, s, _, _ = SHARDED_LM["llama3-8b"]
    model = tt.transformer_init(0, cfg, device=dev)
    if mesh is not None:
        steps.shard_lm_params(model, cfg, mesh)
    tokens = lm_batches(0, b, s, cfg.vocab)(0)["tokens"]

    def full(x):
        return (x.full_tensor() if hasattr(x, "full_tensor") else x).float()

    out = {}
    steps.lm_prefill_step(model, cfg, tokens, mesh=mesh)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    logits = full(steps.lm_prefill_step(model, cfg, tokens, mesh=mesh))
    torch.cuda.synchronize(dev)
    out["prefill_s"] = time.perf_counter() - t0
    cache = tt.make_cache(cfg, b, SHARDED_CACHE, device=dev)
    if mesh is not None:
        cache = steps.shard_lm_cache(cache, cfg, mesh)
    feed = [tokens[:, t : t + 1] for t in range(SHARDED_PROMPT)]
    step_logits, step_ms, greedy = [], [], []
    for t in range(SHARDED_PROMPT + SHARDED_NEW):
        tok = feed[t] if t < SHARDED_PROMPT else (want["greedy"][t - SHARDED_PROMPT] if want else greedy[-1])
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        lg, cache = steps.lm_decode_step(model, cfg, tok, cache, t, mesh=mesh)
        lg = full(lg)
        torch.cuda.synchronize(dev)
        step_ms.append(1e3 * (time.perf_counter() - t0))
        if t >= SHARDED_PROMPT - 1:
            step_logits.append(lg.cpu())
            greedy.append(lg.argmax(-1, keepdim=True).cpu().numpy())
    out["decode_step_ms"] = float(np.median(step_ms[1:]))
    if want is None:
        out["prefill_logits"], out["decode_logits"], out["greedy"] = logits.cpu(), step_logits, greedy[:-1]
    else:
        out["prefill_gap"] = logit_gap(logits.cpu(), want["prefill_logits"])
        gaps = [logit_gap(g, w) for g, w in zip(step_logits, want["decode_logits"])]
        out["decode_gap_max"] = [max(g[0] for g in gaps), max(g[1] for g in gaps)]
        out["greedy_same"] = int(sum(bool((a == b).all()) for a, b in zip(greedy[:-1], want["greedy"])))
    del model, cache
    torch.cuda.empty_cache()
    return out


def sharded_rank(rank, world, p):
    """A spawned gloo rank of phase 17 on ``cuda:0`` (the ranks share the
    card): DTensor's all-gathers through the staging function, the mesh,
    then each of ``p["runs"]``."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import obs
    from repro_torch.distributed.sharding import stage_gloo_collectives

    obs.enable(trace=False, metrics_on=True)  # the launch counts are counters
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    stage_gloo_collectives("cuda")
    mesh = init_device_mesh("cuda", p["shape"], mesh_dim_names=("data", "model"))
    return sharded_runs(mesh, dev, p)


def sharded_runs(mesh, dev, p) -> dict:
    out = {"rank": mesh.get_rank(), "device": str(dev)}
    for name in p["runs"]:
        out[name] = sharded_train(name, mesh, dev, p["want"][name])
    if p.get("serve"):
        out["serve"] = sharded_serve(mesh, dev, p["want"]["serve"])
    return out


def sharded_check(name, rows, want):
    """(ok, failed checks) of one model's ranks against the single device."""
    cfg, _ = sharded_cfg(name)
    n_attn = cfg.n_layers
    bad = []
    r0 = rows[0][name]
    if abs(r0["loss"] - want["loss"]) > SHARDED_LOSS_REL * abs(want["loss"]):
        bad.append("loss")
    if abs(r0["grad_norm"] - want["grad_norm"]) > SHARDED_NORM_REL * abs(want["grad_norm"]):
        bad.append("grad_norm")
    if max(r0["leaf_rel_l2"].values()) > GRAD_REL_L2:
        bad.append("leaf_rel_l2")
    if 10 * (r0["routed_positions"] - r0["route_flips"]) < 9 * r0["routed_positions"]:
        bad.append("route_flips")
    for r in rows:
        if r[name]["launches"] != {"flash_attention": 2 * n_attn, "flash_attention_bwd": n_attn}:
            bad.append(f"launches rank {r['rank']}")
        if not r["device"].startswith("cuda"):
            bad.append(f"device rank {r['rank']}")
        if not (np.isfinite(r[name]["loss"]) and np.isfinite(r[name]["grad_norm"])):
            bad.append(f"finite rank {r['rank']}")
    return not bad, bad


def sharded_line(name, shape, backend, rows, want):
    ok, bad = sharded_check(name, rows, want)
    r0 = rows[0][name]
    cfg, full = sharded_cfg(name)
    return ok, {
        "phase": "sharded_lm", "arch": name, "mesh": list(shape), "backend": backend, "world": len(rows),
        "dtype": str(cfg.dtype), "n_layers": cfg.n_layers, "published_layers": full.n_layers,
        "batch": r0["batch"], "tokens": r0["tokens"], "reduced": SHARDED_LM[name][4],
        "step_s": [r[name]["step_s"] for r in rows], "single_device_step_s": want["step_s"],
        "first_step_s": [r[name]["first_s"] for r in rows],
        "peak_mem_bytes": [r[name]["peak_mem_bytes"] for r in rows], "single_device_peak_bytes": want["peak_mem_bytes"],
        "launches": [r[name]["launches"] for r in rows], "comms_fwd_bwd": r0.get("comms_fwd_bwd"),
        "staged_all_gather_calls": [r[name]["staged_all_gather_calls"] for r in rows],
        "loss": r0["loss"], "loss_single": want["loss"], "grad_norm": r0["grad_norm"],
        "grad_norm_single": want["grad_norm"], "max_leaf_rel_l2": max(r0["leaf_rel_l2"].values()),
        "leaf_rel_l2": r0["leaf_rel_l2"], "route_flips": r0["route_flips"],
        "routed_positions": r0["routed_positions"], "tolerance": SHARDED_TOL, "ok": ok, "failed": bad}


def sharded_lm_phase(dev):
    """Phase 17: the LM steps sharded over a mesh's ranks (module
    docstring).  Returns (ok, launches of a sharded llama3-8b train step
    on rank 0 at (1, 2))."""
    import gc
    import os
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.testing.ranks import run_ranks

    t_phase = time.perf_counter()
    ok, launches = True, {}
    with tempfile.TemporaryDirectory(prefix="sharded-") as tmp:
        want = {}
        for name in SHARDED_LM:  # the single-device oracles, each freed before the next
            t0 = time.perf_counter()
            w = sharded_train(name, None, dev)
            w["grads_path"] = os.path.join(tmp, f"{name}.pt")
            torch.save(w.pop("host_grads"), w["grads_path"])
            want[name] = w
            emit({"phase": "sharded_lm_single", "arch": name, "seconds": time.perf_counter() - t0,
                  **{k: w[k] for k in ("loss", "grad_norm", "step_s", "first_s", "peak_mem_bytes", "launches")}})
            gc.collect()
            torch.cuda.empty_cache()
        want["serve"] = sharded_serve(None, dev)
        worlds = [((1, 2), "gloo", ("llama3-8b", "deepseek-v2-236b"), True), ((2, 1), "gloo", ("llama3-8b",), False),
                  ((1, 1), "nccl", ("llama3-8b",), False)]
        for shape, backend, runs, serve in worlds:
            t0 = time.perf_counter()
            p = {"shape": shape, "runs": runs, "serve": serve, "want": want}
            if backend == "nccl":  # world 1 in this process
                dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store1"), 1), rank=0,
                                        world_size=1, timeout=timedelta(seconds=300))
                try:
                    rows = [sharded_runs(init_device_mesh("cuda", shape, mesh_dim_names=("data", "model")), dev, p)]
                finally:
                    dist.destroy_process_group()
            else:
                rows = run_ranks(sharded_rank, shape[0] * shape[1], p, backend=backend, timeout=600)
            for name in runs:
                m_ok, line = sharded_line(name, shape, backend, rows, want[name])
                emit({**line, "wall_s": time.perf_counter() - t0})
                ok &= m_ok
            if serve:
                sv = rows[0]["serve"]
                s_ok = (sv["prefill_gap"][0] <= LM_REL_L2 and sv["prefill_gap"][1] <= LM_MAX_ABS
                        and sv["decode_gap_max"][0] <= LM_REL_L2 and sv["decode_gap_max"][1] <= LM_MAX_ABS)
                emit({"phase": "sharded_lm_serve", "arch": "llama3-8b", "mesh": list(shape), "backend": backend,
                      "prefill": [SHARDED_LM["llama3-8b"][1], SHARDED_LM["llama3-8b"][2]],
                      "prefill_s": sv["prefill_s"], "single_device_prefill_s": want["serve"]["prefill_s"],
                      "decode_step_ms": sv["decode_step_ms"],
                      "single_device_decode_step_ms": want["serve"]["decode_step_ms"],
                      "prefill_gap": sv["prefill_gap"], "decode_gap_max": sv["decode_gap_max"],
                      "greedy_same": sv["greedy_same"], "greedy_steps": SHARDED_NEW, "ok": s_ok})
                ok &= s_ok
            if shape == (1, 2):
                launches = {f"{k}_sharded": v for k, v in rows[0]["llama3-8b"]["launches"].items()}
    torch.cuda.empty_cache()
    emit({"phase": "sharded_lm", "seconds": time.perf_counter() - t_phase, "ok": ok})
    return ok, launches


# ---------------------------------------------------------------------------
# phase 18: the LM examples' model on attention at D 64 (B8d) with its kernel
# rows, and the recsys serving example at full width (A8b)
# ---------------------------------------------------------------------------

TRAIN_LM64 = (8, 256, 4)       # batch rows, tokens a row, train_loop steps (step 0 the warm-up): the example's batch
D64_SHAPES = {"train_lm": (8, 10, 2, 256), "long": (4, 10, 2, 4096)}  # B, Hq, Hkv, S at D 64, causal
D64_FP32_TOL = "|kernel - plain| <= 2e-5 (1 + |plain|), fp32 out"
RS_ITEMS, RS_USERS, RS_ASSIGN_CALLS = 150_000, 1024, 200  # catalogue items (120 genres), users, single assign calls
RS_TWIN = (20_000, 4000, 4)    # items, batch, users: the example's defaults, held card against CPU
RS_TWIN_THREADS = 4            # the CPU twin's torch threads (it runs beside the card's phases)
RS_TIE = 1e-5                  # two top-10 lists may differ only where the swapped items' scores are this close


def load_example(name: str):
    """``examples/<name>.py`` as a module (its ``main`` not run)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def d64_ptxas() -> dict:
    """ptxas's registers and spill bytes of every ``<64>`` instantiation
    of the forward (three mappings) and the backward (both)."""
    out = {}
    for kernel in ("prefill_fp32_kernel", "prefill_tc_kernel", "decode_split_kernel"):
        out.update(ptxas_entries("flash_attention", kernel))
    out.update(bwd_ptxas())
    return {k: v for k, v in out.items() if "64" in k.rstrip(">").split("<")[-1].split(",")}


def d64_gap(out, ref):
    """(ok, max |err|) of a D 64 output against the plain one: one bf16
    step (``flash_gap``) or ``D64_FP32_TOL``."""
    import torch

    if out.dtype == torch.bfloat16:
        ok, gap = flash_gap(out, ref)
        return ok, gap["max_abs_err"]
    err = (out - ref).abs()
    return bool((err <= 2e-5 * (1 + ref.abs())).all()) and bool(out.isfinite().all()), float(err.max())


def d64_rows(label, shape, dtype, seed):
    """The D 64 rows at ``shape`` (B, Hq, Hkv, S; causal) in ``dtype``:
    the prefill with its log-sum-exp (training's forward), the decode
    mapping (one query against the S keys) and the backward, each held to
    its plain version on the same inputs, with its time back to back and
    queued, the bound (``kernels/cost.py``), the same call with q, k, v
    (and the output, dO) zero-padded to D 128 (the path before D 64 was
    instantiated) and SDPA's time (its backward: forward + ``backward()``
    less its forward).  Returns (ok, [prefill, decode, backward])."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cost
    from repro_torch.kernels.flash_attention import flash_attention, ops
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref

    b, hq, hkv, s = shape
    d, scale, elem = 64, 64 ** -0.5, torch.tensor([], dtype=dtype).element_size()
    g = torch.Generator(device="cuda").manual_seed(seed)

    def draw(*shp):
        return torch.randn(shp, generator=g, device="cuda", dtype=torch.float32).to(dtype)

    def pad(t):
        return F.pad(t, (0, 128 - d))

    def sdpa(q, k, v, causal=True):
        with torch.no_grad():
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)

    dt = str(dtype).split(".")[-1]
    base = {"B": b, "Hq": hq, "Hkv": hkv, "D": d, "causal": True, "dtype": dt}
    tol = FLASH_TOL if dtype == torch.bfloat16 else D64_FP32_TOL
    q, k, v, dout = draw(b, hq, s, d), draw(b, hkv, s, d), draw(b, hkv, s, d), draw(b, hq, s, d)
    qp, kp, vp, doutp = pad(q), pad(k), pad(v), pad(dout)

    # the prefill with the log-sum-exp written
    lse, lse_p = (torch.empty((b, hq, s), dtype=torch.float32, device="cuda") for _ in range(2))
    fwd = lambda: ops._launch(q, k, v, True, None, scale, 0, lse)  # noqa: E731
    fwd_p = lambda: ops._launch(qp, kp, vp, True, None, scale, 0, lse_p)  # noqa: E731
    out = fwd()
    ref, lse_ref = attention_ref(q, k, v, causal=True, return_lse=True)
    ok_f, err_f = d64_gap(out, ref)
    lse_err = float((lse - lse_ref).abs().max())
    ok_f &= lse_err <= 1e-4 * (1 + float(lse_ref.abs().max()))
    del ref, lse_ref
    t1, p1 = time_ms(fwd, reps=5), time_ms(fwd_p, reps=5)
    qd, qdp = queued_ms(fwd, reps=10), queued_ms(fwd_p, reps=10)
    t2, p2 = time_ms(fwd, reps=5), time_ms(fwd_p, reps=5)
    c = cost.attention_cost(b, hq, hkv, s, s, d, d, causal=True, elem=elem, lse=True)
    pre = {"name": "flash_attention<64>", "mapping": "prefill with the log-sum-exp", "cell": label,
           "shape": {**base, "Sq": s, "Sk": s}, "max_abs_err": err_f, "lse_max_abs_err": lse_err, "tolerance": tol,
           "ms": (t1 + t2) / 2, "ms_turns": [t1, t2], "queued_ms": qd, "padded_d128_ms": (p1 + p2) / 2,
           "padded_d128_ms_turns": [p1, p2], "padded_d128_queued_ms": qdp,
           "plain_ms": time_ms(lambda: attention_ref(q, k, v, causal=True, return_lse=True), reps=2, warmup=1),
           "library_ms": time_ms(lambda: sdpa(q, k, v), reps=5),
           "library": f"F.scaled_dot_product_attention(enable_gqa=True, is_causal=True), {dt}",
           "flops": c.ops, "bytes": c.bytes, "bound_ms": c.bound_ms()[0], "bound_by": c.bound_ms()[1], "ok": ok_f}
    pre["padded_over_d64"] = pre["padded_d128_ms"] / pre["ms"]

    # the decode mapping: the last position's query against all S keys
    q1, q1p = q[:, :, -1:].contiguous(), qp[:, :, -1:].contiguous()
    dec = lambda: flash_attention(q1, k, v, causal=True)  # noqa: E731
    dec_p = lambda: flash_attention(q1p, kp, vp, causal=True, scale=scale)  # noqa: E731
    ok_d, err_d = d64_gap(dec(), attention_ref(q1, k, v, causal=True))
    t1, p1 = time_ms(dec, reps=10), time_ms(dec_p, reps=10)
    qd, qdp = queued_ms(dec), queued_ms(dec_p)
    t2, p2 = time_ms(dec, reps=10), time_ms(dec_p, reps=10)
    c = cost.attention_cost(b, hq, hkv, 1, s, d, d, causal=True, elem=elem)
    decode = {"name": "flash_attention<64>", "mapping": "decode (Sq = 1)", "cell": label,
              "shape": {**base, "Sq": 1, "Sk": s}, "max_abs_err": err_d, "tolerance": tol,
              "ms": (t1 + t2) / 2, "ms_turns": [t1, t2], "queued_ms": qd, "padded_d128_ms": (p1 + p2) / 2,
              "padded_d128_ms_turns": [p1, p2], "padded_d128_queued_ms": qdp,
              "plain_ms": time_ms(lambda: attention_ref(q1, k, v, causal=True), reps=3, warmup=1),
              "library_ms": time_ms(lambda: sdpa(q1, k, v, causal=False), reps=10),
              "library_queued_ms": queued_ms(lambda: sdpa(q1, k, v, causal=False)),
              "library": f"F.scaled_dot_product_attention(enable_gqa=True), {dt}, one query (no mask)",
              "bytes": c.bytes, "bound_ms": c.bound_ms()[0], "bound_by": c.bound_ms()[1], "ok": ok_d}
    decode["padded_over_d64"] = decode["padded_d128_ms"] / decode["ms"]

    # the backward, from the kernel's own output and log-sum-exp
    out_p = fwd_p()
    bwd = lambda: ops.flash_attention_bwd(q, k, v, out, lse, dout, causal=True)  # noqa: E731
    bwd_p = lambda: ops.flash_attention_bwd(qp, kp, vp, out_p, lse_p, doutp, causal=True, scale=scale)  # noqa: E731
    got, want = bwd(), attention_bwd_ref(q, k, v, out, lse, dout, causal=True)
    ok_b, errs = True, []
    for a, w in zip(got, want):
        o, e, _ = bwd_grad_gap(a, w, dtype)
        ok_b &= o
        errs.append(e)
    del got, want
    t1, p1 = time_ms(bwd, reps=3, warmup=1), time_ms(bwd_p, reps=3, warmup=1)
    qd, qdp = queued_ms(bwd, reps=3), queued_ms(bwd_p, reps=3)
    t2, p2 = time_ms(bwd, reps=3, warmup=0), time_ms(bwd_p, reps=3, warmup=0)
    plain = time_ms(lambda: attention_bwd_ref(q, k, v, out, lse, dout, causal=True), reps=1, warmup=1)
    ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, enable_gqa=True).backward(dout)

    fb, f_only = time_ms(sdpa_fwd_bwd, reps=5), time_ms(lambda: sdpa(q, k, v), reps=5)
    c = cost.attention_bwd_cost(b, hq, hkv, s, s, d, d, causal=True, elem=elem)
    back = {"name": "flash_attention_bwd<64>", "mapping": "backward", "cell": label,
            "shape": {**base, "Sq": s, "Sk": s}, "max_abs_err": max(errs), "max_abs_err_dq_dk_dv": errs,
            "tolerance": BWD_TOL, "ms": (t1 + t2) / 2, "ms_turns": [t1, t2], "queued_ms": qd,
            "padded_d128_ms": (p1 + p2) / 2, "padded_d128_ms_turns": [p1, p2], "padded_d128_queued_ms": qdp,
            "plain_ms": plain, "library_ms": fb - f_only, "library_fwd_bwd_ms": fb, "library_fwd_ms": f_only,
            "library": f"F.scaled_dot_product_attention(enable_gqa=True, is_causal=True), {dt}: forward + "
                       "backward() less its forward",
            "flops": c.ops, "bytes": c.bytes, "bound_ms": c.bound_ms()[0], "bound_by": c.bound_ms()[1], "ok": ok_b}
    back["padded_over_d64"] = back["padded_d128_ms"] / back["ms"]
    del q, k, v, dout, qp, kp, vp, doutp, out, out_p, lse, lse_p, ql, kl, vl
    torch.cuda.empty_cache()
    return ok_f and ok_d and ok_b, [pre, decode, back]


def train_lm_64(dev):
    """``examples/train_lm_torch.py``'s ~100M model (d_model 640, 12 layers,
    10 query heads over 2 kv heads, d_head 64, fp32) at its batch (8 x
    256, ``lm_batches(0, ...)``) and optimizer (``adamw(3e-4, weight_decay
    0.1)``, clip 1.0, one microbatch, the whole logits), its attention the
    D 64 kernels: first one step held to a CPU copy (``cpu_step_parity``),
    then from the same weights ``train_loop`` for ``TRAIN_LM64[2]`` steps
    with a checkpoint directory (saved at the end) and one more step (the
    uninterrupted run); dropped; a model drawn from another seed resumed
    by ``train_loop`` from the checkpoint, its state fingerprinted against
    the saved one's, and stepped once.  Returns (ok, line, launches a
    step)."""
    import copy as copy_
    import functools
    import gc
    import shutil

    import torch

    from repro_torch.data.pipeline import lm_batches
    from repro_torch.launch.steps import lm_train_step
    from repro_torch.models.transformer import transformer_init, transformer_loss
    from repro_torch.train.optimizer import adamw, param_tree
    from repro_torch.train.trainer import TrainLoopConfig, train_loop

    rows, seq, steps = TRAIN_LM64
    cfg = load_example("train_lm_torch").make_config(small=False)
    opt = adamw(lr=3e-4, weight_decay=0.1)
    make_batch = lm_batches(0, rows, seq, cfg.vocab)
    ckpt = ROOT / "build" / "chip_smoke_train_lm64_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    loop_cfg = TrainLoopConfig(total_steps=steps, ckpt_dir=str(ckpt), ckpt_every=10 ** 9, log_every=1)
    line = {"phase": "train_lm_64", "example": "examples/train_lm_torch.py", "params": cfg.param_count(),
            "d_model": cfg.d_model, "n_layers": cfg.n_layers, "n_heads": cfg.n_heads, "kv_heads": cfg.kv_heads,
            "d_head": cfg.d_head, "dtype": str(cfg.dtype), "remat": cfg.remat, "batch": rows, "seq": seq,
            "optimizer": "adamw(lr=3e-4, weight_decay=0.1), clip 1.0, one microbatch, ce_chunk 0"}

    def start(seed):
        model = transformer_init(seed, cfg, device=dev).requires_grad_(True)
        params = param_tree(model)
        return model, params, opt.init(params)

    def step_of(model):
        return functools.partial(lm_train_step, model, cfg, opt=opt, n_microbatches=1, ce_chunk=0)

    # step 0 against a CPU copy of the same weights
    t0 = time.perf_counter()
    model, params, state = start(0)
    host = copy_.deepcopy(model).cpu()
    host_params = param_tree(host)
    host_state = opt.init(host_params)
    b0 = make_batch(0)
    b0_dev = {k: torch.as_tensor(v, device=dev) for k, v in b0.items()}
    p_ok, parity = cpu_step_parity(
        lambda: step_of(model)(params, state, b0)[2], lambda: step_of(host)(host_params, host_state, b0)[2],
        params, host_params,
        lambda: transformer_loss(model, cfg, b0_dev["tokens"], b0_dev["labels"]),
        lambda: transformer_loss(host, cfg, b0["tokens"], b0["labels"]))
    line.update({"parity_ok": p_ok, "parity": parity, "parity_tolerance": TRAIN_STEP_TOL,
                 "parity_s": time.perf_counter() - t0})
    del model, params, state, host, host_params, host_state, b0_dev
    gc.collect()
    torch.cuda.empty_cache()

    # the run, saved at its end, and the uninterrupted run's next step
    launches, logs = [], []
    model, params, state = start(0)
    step = synced_step(step_of(model), launches)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train_loop(loop_cfg, step, params, state, make_batch, log=logs.append)
    loop_s = time.perf_counter() - t0
    hist, state = out["history"], out["opt_state"]
    saved_fp = fingerprint((params, state))
    _, state, m = step(params, state, make_batch(steps))
    loss_a = float(m["loss"])
    step_s = [h["step_s"] for h in hist]
    losses = [h["loss"] for h in hist]
    line.update({"losses": losses + [loss_a], "step_s": step_s, "warmup_step_s": step_s[0],
                 "step_s_timed": step_s[1:], "tokens_per_s": rows * seq / float(np.median(step_s[1:])),
                 "save_s": loop_s - sum(step_s), "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                 "launches_a_step": launches[1]})
    # the kill, then the resume into other weights
    del model, params, state, out, step, m
    gc.collect()
    torch.cuda.empty_cache()
    model, params, state = start(1)
    step = synced_step(step_of(model), launches)
    t0 = time.perf_counter()
    out = train_loop(loop_cfg, step, params, state, make_batch, log=logs.append)
    restore_s = time.perf_counter() - t0
    state = out["opt_state"]
    restored = fingerprint((params, state)) == saved_fp
    _, state, m = step(params, state, make_batch(steps))
    loss_b = float(m["loss"])
    line.update({"resumed_from": [x for x in logs if x.startswith("resumed")], "restore_s": restore_s,
                 "restored_bit_for_bit": restored, "resumed_step": int(state["step"]) - 1,
                 "resumed_loss": loss_b, "uninterrupted_loss": loss_a, "resumed_loss_bit_equal": loss_b == loss_a,
                 "resume_rel_diff": abs(loss_b - loss_a) / abs(loss_a), "resume_tolerance": RESUME_TOL,
                 "checkpoint_bytes": sum(f.stat().st_size for f in ckpt.rglob("*") if f.is_file())})
    want = {"flash_attention": 2 * cfg.n_layers, "flash_attention_bwd": cfg.n_layers}
    ok = p_ok and all(np.isfinite(line["losses"])) and restored and not out["history"]
    ok &= line["resumed_step"] == steps and line["resume_rel_diff"] <= RESUME_TOL
    ok &= all(x == want for x in launches)
    line.update({"launches_expected": want, "ok": ok})
    del model, params, state, out, step, m
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(ckpt, ignore_errors=True)
    return ok, line, launches[1]


def recsys_twin_cpu(n_cand: int, batch: int, users: int, threads: int) -> dict:
    """Body of the recsys example's CPU twin, run in a process of its own
    (``start_recsys_twin``): ``serve`` at bst's full width on the CPU with
    ``bst_init(0, cfg, device="cpu")``'s parameters (the card's phase draws
    the same ones on the CPU and moves them), ``threads`` torch threads.
    Returns the compared results and the seconds it took."""
    import torch

    torch.set_num_threads(threads)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.models.recsys import bst_init

    t0 = time.perf_counter()
    cfg = get_arch("bst").make_config()
    out = load_example("recsys_serving_torch").serve(cfg, bst_init(0, cfg, device="cpu"), n_cand=n_cand,
                                                     batch=batch, n_users=users, device="cpu")
    return {**{k: v for k, v in out.items() if k not in ("stream", "snapshot", "catalogue")},
            "wall_s": time.perf_counter() - t0, "threads": threads}


def start_recsys_twin():
    """The CPU twin of phase 18's recsys check, started in a spawned
    process so that it runs while the card works on other phases: (the
    pool, its future).  The caller shuts the pool down."""
    import concurrent.futures
    import multiprocessing

    pool = concurrent.futures.ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    return pool, pool.submit(recsys_twin_cpu, *RS_TWIN, RS_TWIN_THREADS)


def relabelling(want, got):
    """The map of ``got``'s cluster ids onto ``want``'s where the two
    labellings are equal up to relabelling (noise -1 on both), else
    None."""
    if not np.array_equal(want < 0, got < 0):
        return None
    pairs = set(zip(got[got >= 0].tolist(), want[want >= 0].tolist()))
    to_want = dict(pairs)
    if len(to_want) != len(pairs) or len(set(to_want.values())) != len(to_want):
        return None
    return {**to_want, -1: -1}


def top_lists_agree(a, b, q, cands) -> bool:
    """Two top-k lists (users x k) agree where equal, or where each
    position that differs holds two items whose float64 scores are within
    ``RS_TIE``: a tie put in another order."""
    for u in range(len(q)):
        x, y = np.asarray(a[u]), np.asarray(b[u])
        if len(x) != len(y):
            return False
        diff = x != y
        if diff.any():
            qs = q[u].astype(np.float64)
            sx, sy = cands[x[diff]].astype(np.float64) @ qs, cands[y[diff]].astype(np.float64) @ qs
            if np.abs(sx - sy).max() > RS_TIE:
                return False
    return True


def near_threshold_pairs(cands, eps, dev, chunk: int = 4096) -> int:
    """Pairs (i < j) of the catalogue whose float64 dot lies within
    ``FLIP_MARGIN`` of 1 - eps: where the card's fp32 band test and the
    CPU's may decide a hit differently."""
    import torch

    x = torch.from_numpy(cands).to(dev, torch.float64)
    n = 0
    for s in range(0, len(x), chunk):
        d = x[s : s + chunk] @ x.T
        near = (d - (1.0 - eps)).abs() <= FLIP_MARGIN
        rows = torch.arange(s, s + len(d), device=dev)[:, None]
        n += int((near & (torch.arange(len(x), device=dev)[None, :] > rows)).sum())
    return n


def recsys_serving_phase(dev, twin):
    """``examples/recsys_serving_torch.py``'s ``serve`` on the card at
    bst's full width (``make_config``: embed_dim 32, seq_len 20, 8 heads,
    a 5M-row item table; ``bst_init(0, cfg, device="cpu")``'s parameters
    moved to the card): ``RS_ITEMS`` catalogue items in the example's 120
    genres in batches of ``STREAM_BATCH``, eps 0.12, tau 5, ``RS_USERS``
    users, the kernel counts set to 0 just before and read just after;
    then ``RS_ASSIGN_CALLS`` single-user ``assign`` calls (p50, p99).
    Then the example's own sizes (``RS_TWIN``) on the card, held to the
    CPU twin (``twin``, the future of ``start_recsys_twin``) under phase
    12's contract: labels equal up to relabelling, else ARI >= 0.99 with
    the pairs within ``FLIP_MARGIN`` of the threshold counted; the top-10
    lists equal but for ties within ``RS_TIE``; the user embeddings
    within ``RECSYS_TOL``.  Returns (ok, line, launches)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.metrics import adjusted_rand_index
    from repro_torch.models.recsys import bst_init
    from repro_torch.obs import metrics

    t_phase = time.perf_counter()
    ex = load_example("recsys_serving_torch")
    cfg = get_arch("bst").make_config()
    model = bst_init(0, cfg, device="cpu").to(dev)
    line, checks = {"phase": "recsys_serving", "example": "examples/recsys_serving_torch.py", "bst": "make_config()",
                    "item_vocab": cfg.item_vocab, "embed_dim": cfg.embed_dim, "items": RS_ITEMS,
                    "batch": STREAM_BATCH, "eps": ex.EPS, "tau": ex.TAU, "users": RS_USERS}, {}
    names = ("embedding_bag",) + STREAM_RP_KERNELS
    metrics.reset()
    torch.cuda.synchronize()
    out = ex.serve(cfg, model, n_cand=RS_ITEMS, batch=STREAM_BATCH, n_users=RS_USERS, device=dev)
    snap = metrics.snapshot()
    launches = {k: snap.get(f"kernel.{k}.launches", 0) for k in names}
    sec = out["seconds"]
    lat = []
    q = out["user_embeddings"]
    for i in range(RS_ASSIGN_CALLS):
        t0 = time.perf_counter()
        out["stream"].assign(q[i : i + 1])
        lat.append(time.perf_counter() - t0)
    line.update({"ingest_s": sec["ingest"], "ingest_rows_per_s": RS_ITEMS / sec["ingest"],
                 "n_batches": out["n_batches"], "last_batch_s": out["last_batch_s"], "n_clusters": out["n_clusters"],
                 "clustered_share": float(np.mean(out["labels"] >= 0)), "user_embedding_s": sec["embed"],
                 "full_scan_s": sec["full_scan"], "pruned_scan_s": sec["pruned_scan"], "recall_at_10": out["recall"],
                 "scored_share": out["scored_frac"], "assign_bulk_s": sec["assign"],
                 "assign_p50_ms": 1e3 * float(np.percentile(lat, 50)),
                 "assign_p99_ms": 1e3 * float(np.percentile(lat, 99)),
                 "assigned": int((out["assign_labels"] >= 0).sum()), "launches": launches})
    checks["launches"] = launches["embedding_bag"] == 1 and all(v > 0 for v in launches.values())
    checks["clustered"] = out["n_clusters"] > 0 and 0 < out["scored_frac"] < 1
    del out
    torch.cuda.empty_cache()

    # the example's own sizes: the card against the CPU twin
    n_cand, batch, users = RS_TWIN
    card = ex.serve(cfg, model, n_cand=n_cand, batch=batch, n_users=users, device=dev)
    t0 = time.perf_counter()
    cpu = twin.result()
    wait_s = time.perf_counter() - t0
    to_cpu = relabelling(cpu["labels"], card["labels"])
    ari = adjusted_rand_index(card["labels"], cpu["labels"])
    cands = card["catalogue"]
    qc = cpu["user_embeddings"]
    emb_ok, emb_gap = recsys_gap(torch.from_numpy(card["user_embeddings"]), torch.from_numpy(qc))
    full_ok = top_lists_agree(card["top_full"], cpu["top_full"], qc, cands)
    twin_line = {"items": n_cand, "batch": batch, "users": users, "cpu_wall_s": cpu["wall_s"],
                 "cpu_threads": cpu["threads"], "cpu_seconds": cpu["seconds"], "card_seconds": card["seconds"],
                 "waited_s": wait_s, "labels_equal_up_to_relabelling": to_cpu is not None, "ari": ari,
                 "labels_differing": None if to_cpu is not None else int((card["labels"] != cpu["labels"]).sum()),
                 "near_threshold_pairs": near_threshold_pairs(cands, ex.EPS, dev),
                 "n_clusters": [card["n_clusters"], cpu["n_clusters"]], "recall": [card["recall"], cpu["recall"]],
                 "scored_share": [card["scored_frac"], cpu["scored_frac"]], "user_embeddings": emb_gap,
                 "top_full_agree": full_ok}
    checks["twin_labels"] = to_cpu is not None or ari >= 0.99
    checks["twin_embeddings"] = emb_ok
    checks["twin_top_full"] = full_ok
    if to_cpu is not None:  # the same clusters: the shortlists, pruned lists and assign must match too
        twin_line["top_clusters_equal"] = bool(np.array_equal(np.vectorize(to_cpu.get)(card["top_clusters"]),
                                                              cpu["top_clusters"]))
        twin_line["top_pruned_agree"] = top_lists_agree(card["top_pruned"], cpu["top_pruned"], qc, cands)
        twin_line["assign_equal"] = bool(
            np.array_equal([to_cpu[int(x)] for x in card["assign_labels"]], cpu["assign_labels"])
            and np.array_equal(card["assign_hits"], cpu["assign_hits"])
            and np.allclose(card["assign_confidence"], cpu["assign_confidence"], rtol=0, atol=1e-6))
        checks["twin_serving"] = (twin_line["top_clusters_equal"] and twin_line["top_pruned_agree"]
                                  and twin_line["assign_equal"] and card["recall"] == cpu["recall"])
    line.update({"twin": twin_line, "checks": checks, "seconds": time.perf_counter() - t_phase,
                 "twin_tolerance": f"phase 12's: labels equal up to relabelling, else ARI >= 0.99 with the pairs "
                                   f"within {FLIP_MARGIN} of 1 - eps counted; top-10 lists equal but for ties within "
                                   f"{RS_TIE}; user embeddings {RECSYS_TOL}"})
    del model, card
    torch.cuda.empty_cache()
    return all(checks.values()), line, launches


def examples_phase(dev, twin):
    """Phase 18: the D 64 rows (``d64_rows`` at ``D64_SHAPES`` in fp32 and
    bf16, with ptxas's ``<64>`` entries), ``train_lm_64`` and
    ``recsys_serving_phase``, each path's launch counts read around its
    own run.  Returns (ok, kernel rows, launches by row)."""
    t_phase = time.perf_counter()
    import torch

    ok, rows = True, []
    for i, (label, shape) in enumerate(D64_SHAPES.items()):
        for j, dtype in enumerate((torch.float32, torch.bfloat16)):
            r_ok, r = d64_rows(label, shape, dtype, seed=60 + 2 * i + j)
            ok &= r_ok
            rows += r
    emit({"phase": "flash_attention_d64", "seconds": time.perf_counter() - t_phase, "ok": ok,
          "ptxas": d64_ptxas(), "rows": rows})
    t0 = time.perf_counter()
    t_ok, t_line, step_launches = train_lm_64(dev)
    emit({**t_line, "seconds": time.perf_counter() - t0})
    r_ok, r_line, rs_launches = recsys_serving_phase(dev, twin)
    emit(r_line)
    ok &= t_ok and r_ok
    emit({"phase": "examples", "seconds": time.perf_counter() - t_phase, "ok": ok,
          "checks": {"d64_rows": all(r["ok"] for r in rows), "train_lm_64": t_ok, "recsys_serving": r_ok}})
    # the kernels line's D 64 entries: the fp32 rows at train_lm's shape (the
    # path's own dtype and shape; every row is in the flash_attention_d64 line)
    kernel_rows = [r for r in rows if r["cell"] == "train_lm" and r["shape"]["dtype"] == "float32"
                   and r["mapping"] != "decode (Sq = 1)"]
    launches = {"flash_attention<64>": step_launches["flash_attention"],
                "flash_attention_bwd<64>": step_launches["flash_attention_bwd"]}
    return ok, kernel_rows, launches


def run(args) -> int:
    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device: the port's kernels run only on the card")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        return fail(f"the port's sources are not beside this script ({ROOT / 'src' / 'repro_torch'})")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.dbscan import dbscan_parallel
    from repro_torch.core.dbscan_pp import auto_sample_fraction
    from repro_torch.core.laf_dbscan import laf_dbscan
    from repro_torch.core.metrics import adjusted_mutual_info, adjusted_rand_index
    from repro_torch.core.pipeline import LAFPipeline
    from repro_torch.data.synthetic import make_angular_clusters
    from repro_torch.index.random_projection import RandomProjectionBackend
    from repro_torch import obs
    from repro_torch.kernels import _build
    from repro_torch.obs import metrics

    obs.enable(trace=False, metrics_on=True)  # the launch counts are counters
    LINES.unlink(missing_ok=True)

    dev = torch.device("cuda")
    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    clock_hz = 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.split()[0])
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind, "max_sm_clock_hz": clock_hz,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. build (one nvcc per source, all at once)
    t0 = time.perf_counter()
    libs = _build.build_all()
    for name in libs:
        _build.load(name)
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "(C75" in line:
                print(f"ptxas[{name}]: {line.strip()}", file=sys.stderr)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [str(p.relative_to(ROOT)) for p in libs.values()]})
    builds_after_phase2 = sum(_build.BUILDS.values())

    # 3. main path at the MS-150k operating point
    eps, tau, alpha = 0.55, 5, 1.5
    t0 = time.perf_counter()
    data, _ = make_angular_clusters(args.n, 768, 80, kappa=2560.0, noise_frac=0.40, seed=13)
    gen_s = time.perf_counter() - t0
    pipe = LAFPipeline(backend="random_projection", eps_grid=(0.3, 0.4, 0.5, 0.6),
                       epochs=args.epochs, seed=0, device=dev)
    t0 = time.perf_counter()
    test = pipe.fit_split(data)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    emit({"phase": "fit", "seconds": gen_s + fit_s, "n": args.n, "n_test": len(test), "epochs": args.epochs,
          "data_s": gen_s, "fit_s": fit_s, "training_set_s": pipe.estimator.set_seconds,
          "final_loss_stage0": pipe.estimator.history["stage0"][-1]})

    t_phase = time.perf_counter()
    warm = pipe.cluster_laf_dbscan(test, eps, tau, alpha)  # first use: lazy loads, allocator
    metrics.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = pipe.cluster_laf_dbscan(test, eps, tau, alpha)
    g = metrics.snapshot()
    launches = {k: g.get(f"kernel.{k}.launches", 0) for k in KERNELS}
    host_syncs = g.get("laf.cluster.host_syncs", 0)
    res = out.result
    emit({"phase": "main_path", "seconds": time.perf_counter() - t_phase,
          "warmup_elapsed_s": warm.elapsed_s, "elapsed_s": out.elapsed_s, "predict_s": out.predict_s,
          "fit_index_s": g.get("laf.phase.fit_index_s"), "sweep_s": g.get("laf.phase.sweep_s"), "label_prop_s": g.get("laf.phase.label_prop_s"),
          "rescue_s": g.get("laf.phase.rescue_s"),
          "n_predicted_core": res.extras["n_predicted_core"], "n_rescued": res.extras["n_rescued"],
          "n_clusters": res.n_clusters, "noise_ratio": res.noise_ratio,
          "rounds": g.get("laf.cluster.last_rounds"), "launches": launches,
          "host_syncs": host_syncs, "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    ok = all(launches[k] > 0 for k in RP_KERNELS) and host_syncs == 1
    ok &= all(launches[k] == v for k, v in FIXPOINT_LAUNCHES.items())
    ok &= launches["rmi_mlp"] == RMI_LAUNCHES_PER_PREDICT
    ok &= res.labels.shape == (len(test),) and int(res.labels.min()) >= -1
    ok &= bool(np.array_equal(warm.result.labels, res.labels))

    # 4. cluster-pass parity (same sweep, host union-find), exact DBSCAN
    #    ground truth (held to the device packed pass) and quality
    t_phase = time.perf_counter()
    pred = pipe.predict_counts(test, eps)
    bk = RandomProjectionBackend(device=dev).fit(test)
    host = laf_dbscan(test, eps, tau, alpha, pred, backend=bk, cluster_device=False)
    same = bool(np.array_equal(host.labels, res.labels) and np.array_equal(host.core, res.core)
                and host.extras == res.extras)
    truth = dbscan_parallel(test, eps, tau, backend="exact", device=dev)
    every_core = laf_dbscan(test, eps, tau, alpha, np.full(len(test), np.inf), backend="exact",
                            device=dev, cluster_device=True)
    truth_same = bool(np.array_equal(truth.labels, every_core.labels)
                      and np.array_equal(truth.core, every_core.core))
    quality = adjusted_rand_index(res.labels, truth.labels)
    emit({"phase": "parity", "seconds": time.perf_counter() - t_phase,
          "host_union_find_identical": same, "exact_dbscan_equals_device_pass": truth_same,
          "exact_dbscan_clusters": truth.n_clusters, "exact_dbscan_noise_ratio": truth.noise_ratio,
          "ari_vs_exact_dbscan": quality})
    wall, busy, union, _ = device_busy(lambda: pipe.cluster_laf_dbscan(test, eps, tau, alpha))
    # the same clustering without the profiler (metrics on, as here): the
    # main path's elapsed_s; busy over it assumes the profiler leaves the
    # device's own work as it is
    emit({"phase": "trace", "seconds": wall, "wall_s": wall, "device_busy_s": busy,
          "device_busy_union_s": union, "idle_share": None if busy is None else 1.0 - busy / wall,
          "unprofiled_elapsed_s": out.elapsed_s,
          "idle_share_unprofiled": None if union is None else 1.0 - union / out.elapsed_s})
    ok &= same and truth_same and quality >= 0.99

    # 5. the exact path: the paper's four methods on the exact backend
    t_phase = time.perf_counter()
    p = auto_sample_fraction(pred, tau, alpha, 0.2)
    methods = {
        "DBSCAN": lambda: pipe.cluster_dbscan(test, eps, tau, backend="exact"),
        "LAF-DBSCAN": lambda: pipe.cluster_laf_dbscan(test, eps, tau, alpha, backend="exact"),
        "DBSCAN++": lambda: pipe.cluster_dbscan_pp(test, eps, tau, p=p, backend="exact"),
        "LAF-DBSCAN++": lambda: pipe.cluster_laf_dbscan_pp(test, eps, tau, p=p, alpha=1.0, backend="exact"),
    }
    exact_launches = dict.fromkeys(EXACT_KERNELS, 0)
    by_method = {}
    for name, fn in methods.items():
        warm = fn()
        metrics.reset()
        torch.cuda.synchronize()
        o = fn()
        snap = metrics.snapshot()
        lc = {k: snap.get(f"kernel.{k}.launches", 0) for k in EXACT_KERNELS}
        for k in EXACT_KERNELS:
            exact_launches[k] += lc[k]
        rmi_launches = snap.get("kernel.rmi_mlp.launches", 0)
        r = o.result
        row = {"elapsed_s": o.elapsed_s, "warmup_elapsed_s": warm.elapsed_s, "predict_s": o.predict_s,
               "phases_s": {k.split(".")[-1][:-2]: v for k, v in snap.items()
                            if k.endswith("_s") and ".phase." in k},
               "n_range_queries": r.n_range_queries, "n_clusters": r.n_clusters,
               "noise_ratio": r.noise_ratio, "ari": adjusted_rand_index(r.labels, truth.labels),
               "ami": adjusted_mutual_info(r.labels, truth.labels), "launches": lc,
               "rmi_mlp_launches": rmi_launches, "params": o.params}
        by_method[name] = row
        if name == "DBSCAN++":
            pp_core = r.core  # the sampled cores: its core-core unions' rows and columns
        emit({"phase": "exact_path", "method": name, **row})
        ok &= sum(lc.values()) > 0
        ok &= rmi_launches == (RMI_LAUNCHES_PER_PREDICT if name.startswith("LAF") else 0)
        ok &= bool(np.array_equal(warm.result.labels, r.labels))
    ok &= by_method["LAF-DBSCAN"]["ari"] >= 0.99
    emit({"phase": "exact_path", "seconds": time.perf_counter() - t_phase, "p": p,
          "launches": exact_launches})

    # 6. components of the exact core graph over the packed square adjacency;
    #    the main path's update row is also timed before it runs
    exec_idx = np.nonzero(pred >= alpha * tau)[0]
    lp_inputs = label_prop_inputs(bk, exec_idx, eps, tau)
    update_before = update_ms(lp_inputs)
    comp_ok, comp_line, comp_rows, comp_launches = check_components(test, eps, truth, dev)
    emit(comp_line)
    ok &= comp_ok
    launches.update(comp_launches)

    # 7. kernels vs plain versions at main-path shapes
    t_phase = time.perf_counter()
    k1_ok, k1 = check_hamming(bk, exec_idx, eps, args.k1_rows, clock_hz)
    lp_ok, lp = check_label_prop(lp_inputs, update_before)
    emit(pass2_trace(lp_inputs))
    pc_row = check_row_popcount(lp_inputs["slab"])
    lp_ok &= pc_row["max_abs_err"] == 0
    del lp_inputs
    sampled_cores = np.nonzero(pp_core)[0]
    rc_ok, rc = check_range_count(bk.data_device, exec_idx[: args.k1_rows], eps,
                                  sampled_cores[: args.k1_rows // 2], sampled_cores)
    for k in rc:
        k["launches_by_method"] = {m: v["launches"][k["name"]] for m, v in by_method.items()}
    launches.update(exact_launches)
    st_ok, st = check_stats_bodies(bk, exec_idx, eps, args.k1_rows, clock_hz)
    rmi_ok, rmi = check_rmi_mlp(pipe, test, eps, tau, alpha)
    emit(predict_ab(pipe, test, eps))
    emit({"phase": "kernels", "seconds": time.perf_counter() - t_phase, "hamming_filter_ok": k1_ok,
          "label_prop_ok": lp_ok, "range_count_ok": rc_ok, "stats_bodies_ok": st_ok, "rmi_mlp_ok": rmi_ok,
          "rmi_mlp": {k: rmi[k] for k in ("max_abs_err", "route_flips", "core_test_flips", "ms", "plain_ms",
                                         "library_ms", "bound_ms")}})
    ok &= k1_ok and lp_ok and rc_ok and st_ok and rmi_ok
    ok &= all(launches[k] > 0 for k in RP_KERNELS + EXACT_KERNELS)

    # 8. observability, its launch counts read around its own path
    obs_ok, obs_line, obs_launches = check_observability(
        pipe, test, eps, tau, alpha, res.labels, truth.labels, dev)
    emit(obs_line)
    ok &= obs_ok and all(obs_launches[k] > 0 for k in OBS_KERNELS)
    for k in STATS_KERNELS:
        launches[k] = obs_launches[k]

    # 9. llama3-8b serving, its launch counts read around its own paths,
    #    then the flash-attention rows once its weights are freed
    lm_ok, lm_line, lm_launches = lm_serve(dev)
    emit(lm_line)
    fa_ok, fa_rows, fa_line = check_flash_attention(lm_launches)
    emit(fa_line)
    ok &= lm_ok and fa_ok and all(n > 0 for n in lm_launches.values())
    launches.update(lm_launches)

    # 10. recsys serving and retrieval, its launch counts read around its
    #     own path, and the embedding_bag rows on bst's table
    rs_ok, rs_line, eb_rows, rs_launches = recsys_serve(dev)
    emit(rs_line)
    ok &= rs_ok and all(n > 0 for n in rs_launches.values())
    launches.update(rs_launches)

    # 11. the paper's baselines beside the exact path's methods, each
    #     method's launch counts read around its own run
    bl_ok, bl_lines, bl_by, bl_parity, band = baselines_phase(test, eps, tau, truth, dev)
    for line in bl_lines:
        emit(line)
    emit(bl_parity)
    main_row = {"elapsed_s": out.elapsed_s, "ari": quality, "ami": adjusted_mutual_info(res.labels, truth.labels),
                "n_range_queries": res.n_range_queries}
    emit(evaluation_line(by_method, main_row, bl_by))
    ok &= bl_ok
    launches["row_popcount_band"] = bl_by["KNN-BLOCK"]["launches"]["row_popcount"]

    # 12. streaming: the exact and the RP stream, serve, durable, evict,
    #     each part's counts read around its own run
    sm_ok, sm_line, pc_conn, sm_launches = stream_phase(data, test, truth, eps, tau, dev)
    emit(sm_line)
    ok &= sm_ok
    launches["packed_connectivity"] = sm_launches["packed_connectivity"]
    for k in rc:
        k["launches_by_method"].update({m: v["launches"][k["name"]] for m, v in bl_by.items()})
    # 13. the rest of the LM zoo, one model at a time, each path's counts
    #     read around its own run; then the zoo's flash_attention rows
    t_phase = time.perf_counter()
    zoo_ok, zoo_lines, zoo_launches, zoo_s = lm_zoo(dev)
    for line in zoo_lines:
        emit(line)
    zf_ok, zf_rows = check_zoo_flash(zoo_launches)
    emit({"phase": "lm_zoo", "seconds": time.perf_counter() - t_phase, "models_s": zoo_s,
          "models_ok": zoo_ok, "flash_rows_ok": zf_ok})
    ok &= zoo_ok and zf_ok and all(n > 0 for n in zoo_launches.values())
    launches.update(zoo_launches)
    # 14. training: B11 and its rows, the full-width gradient check,
    #     llama3-8b with save and resume, the recsys and GAT steps, each
    #     step's launch counts read around it
    twin_pool, twin = start_recsys_twin()  # phase 18's CPU twin, on the host's cores while the card trains
    tr_ok, tr_rows, tr_launches = train_phase(dev)
    ok &= tr_ok and all(n > 0 for n in tr_launches.values())
    launches.update(tr_launches)
    # 15. the sharded index plane: the whole MS-150k set on world 1 (NCCL)
    #     and world 2 (gloo, two ranks on this card), each held to the
    #     single-device run; each run's counts read around it
    plane_pred = pipe.estimator.predict_counts(data, eps, reference_n=len(data))
    pl_ok, pl_rows, pl_launches = plane_phase(data, plane_pred, eps, tau, alpha, dev, clock_hz)
    ok &= pl_ok and all(n > 0 for n in pl_launches.values())
    launches.update(pl_launches)
    # 16. the launch lowerings on the card and on fake tensors, laf-lint,
    #     the full dry run and its roofline
    tl_ok, tl_line = tooling_phase(data, pipe.estimator, eps, tau, dev, builds_after_phase2,
                                   {k: launches[k] for k in RP_KERNELS})
    emit(tl_line)
    ok &= tl_ok
    # 17. the LM steps sharded over a mesh: llama3-8b at (1, 2) and (2, 1)
    #     over gloo on this card and world 1 over NCCL, deepseek-v2 at (1, 2),
    #     each held to the single-device step; each step's counts read around it
    sh_ok, sh_launches = sharded_lm_phase(dev)
    ok &= sh_ok and all(n > 0 for n in sh_launches.values())
    # 18. the examples' paths: attention at D 64 (its rows, train_lm's model
    #     trained, saved and resumed) and the recsys serving example at full
    #     width, held to its CPU twin; each path's counts read around it
    try:
        ex_ok, ex_rows, ex_launches = examples_phase(dev, twin)
    finally:
        twin_pool.shutdown(wait=True, cancel_futures=True)
    ok &= ex_ok and all(n > 0 for n in ex_launches.values())
    launches.update(ex_launches)
    rows = []
    for k in [k1, *lp, pc_row, *rc, *st, rmi, *comp_rows, *fa_rows, *eb_rows, band, pc_conn, *zf_rows, *tr_rows,
              *pl_rows, *ex_rows]:
        source, replaces = KERNELS[k["name"]]
        rows.append({"name": k["name"], "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches[k["name"]], "library_ms": None,
                     **{a: b for a, b in k.items() if a != "name"}})
    if not ok:
        emit({"kernels": rows})
        return fail("a check failed (see the phase lines above)")
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=152185, help="dataset rows (MS-150k: 152185)")
    ap.add_argument("--epochs", type=int, default=5,
                    help="estimator epochs (paper: 200; 5 since the examples' phase: at 4, 6 and 10 the card's "
                         "predicted cores and ARIs are the same, scripts/estimator_epochs_probe.py)")
    ap.add_argument("--k1-rows", type=int, default=4096, help="queries in the K1 comparison")
    args = ap.parse_args()
    try:
        import torch  # noqa: F401
    except ImportError:
        return fail("PyTorch is not installed")
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
