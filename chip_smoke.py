#!/usr/bin/env python3
"""Drive every path of the port end to end on one NVIDIA GPU, through
each of its seven hand-written CUDA kernels, and the models that call
B6 (DLRM, the four GNNs) and B7 (the dense and MoE LMs), on one card and
over ranks.

    python3 chip_smoke.py [--out FILE]

Four S2 frontier paths, one per (backend, tile store) pair, each carried
by one kernel (the sharded backend runs B1 and B3 again, in the sharded
phase; the reference backend runs none):

=========================  ========  =================================
backend                    tiles     kernel
=========================  ========  =================================
``frontier_kernel``        f32       B1 ``fused_level_blocks``
``frontier_kernel``        uint32    B3 ``fused_level_blocks_u32``
``frontier_kernel_packed`` f32       B2 ``packed_level_blocks``
``frontier_kernel_packed`` uint32    B4 ``packed_level_blocks_u32``
=========================  ========  =================================

Every one-card fixpoint runs on ``ops.LevelLoop``: LEVELS_PER_CHECK
levels a body, gated on the device, the body captured once per executor
in a CUDA graph and replayed, the host reading the loop's flag once a
body.  So a one-card run's level kernel launches bodies x
LEVELS_PER_CHECK x buckets times exactly (levels after convergence
launch on an empty frontier), its BFS levels come from the device
counter, and its host syncs are its bodies; a rank's fixpoint over a
mesh still reads its frontier every level and launches once a level.

Phases, each of which raises on failure (the run then exits non-zero):

* env      — the card's name and power limit, torch and CUDA versions;
* build    — every CUDA source, built from ``src/`` with one nvcc each,
             all started together;
* setup    — the Alibaba twin (``alibaba_like(seed=0)``: 50,000 nodes,
             327,848 edges, 216 labels), its 256-site placement at
             replication rate 0.2 (``configs/alibaba_rpq.py``), and the
             whole Stage-A tile store on the device twice: f32 and the
             uint32 bit-planes, whose offsets must equal the f32 store's
             and whose unpacked q1 tiles must equal the f32 tiles;
* kernels  — each kernel against its plain PyTorch version on the card,
             exactly equal (``torch.equal``: {0,1} operands and integer
             sums below 2^24 are exact in f32 in any order, OR is exact
             in any order) on (a) the q1 plan at full scale, (b) a
             block-16 plan with an empty label store, a wildcard and an
             inverse transition, (c) a plan with output blocks made only
             of cover steps, (d) the q1 plan with a cover step after
             every second valid step of each run (runs of more than
             2 x ``WORK_CHUNK`` valid steps with cover steps between
             them); the packed kernels on random lane words over all 32
             bits.  Each plan's work-list size (the CTAs of B1-B4) and
             longest run are logged.  Then the time of one level of each
             query's plan for each kernel, the plain version's, and the
             bound; each kernel again equal to plain at every timed
             level, with its chunks and the time of its output's zero
             fill alone;
* path     — ``s2_execute`` on Table-2 queries q1, q9 and q12 over all
             their valid starts, for each of the four paths, with the
             launch counts set to 0 just before each path and read just
             after; answers must equal the device-BFS oracle for every
             start, the §4.2 meters must equal the host meter on 32
             sampled starts, the path's kernel launches must equal its
             bodies x LEVELS_PER_CHECK and be nonzero, and no other kernel
             may launch; host syncs are logged beside the per-level
             loop's (levels + fixpoints).  Then q1 on each path, and
             under witness semantics on the f32 store, replayed from the
             executor's graph (two calls: capture, replay) against the
             eager one-level loop (``ops.EAGER``): answers, meters,
             witness planes and BFS levels equal bit for bit;
* trace    — each query again on each path, its per-call set-up
             (``make_s2_step_fn``: Stage B and the meters' degree
             vectors) timed apart from its first run (the capture) and a
             warm run, and a third run traced
             with ``torch.profiler``: device busy time, idle share,
             device time per kernel, and the path's level kernel looked
             up by pieces of its device symbol, which must match exactly
             one kernel, launched as often as in the path phase;
* plan     — the paper's §6 workflow on the same twin: a 256-peer overlay
             of mean degree 3 (``random_overlay``) probed for N_p, N_c and
             k, the Bayesian model fitted once, each of the 12 Table-2
             queries estimated (300 rollouts) and decided; then on 8
             sampled valid starts of each, S1 (``s1_execute`` on the
             padded site arrays staged once, its gather, dedup and device
             BFS also timed apart) and S2 (``s2_execute`` on B1 under the
             query class's fast path: reduced automaton, level cap).
             Answers of both must equal the device-BFS oracle, S1's
             deduped subgraph must be the graph's edges of the query's
             labels and its cost ``s1_costs``, B1's launches must equal
             the S2 bodies x LEVELS_PER_CHECK, and no other kernel may
             launch; each
             strategy's observed ``cost_of`` is logged beside the plan's
             forecast (whether the choice was the cheaper one is not
             checked: the plan is an estimate);
* witness  — witness semantics and bounded counting on the same twin:
             every valid start of q1, q9 and q12 through ``s2_execute(
             semantics="witness")`` on B1 and on B2 over the f32 store,
             each beside the pairs run of the same executor (wall times
             logged side by side) and a third run taken apart (set-up,
             executor, the levels' copy to pageable and to pinned host
             memory).  Answers and meters must equal the
             pairs run and the device BFS, the packed levels the f32
             ones, the levels of 4 sampled starts with answers the host
             product BFS (``witness.host_levels``), and 8 witnesses per
             query walked back from the levels must pass the label-store
             check and the automaton re-match; each run must launch its
             kernel LEVELS_PER_CHECK times a body and nothing else.  q1 again asks for the
             uint32 store without a Stage A: it must restage f32 and
             launch B1, not B3.  ``count_paths_bounded`` on q1 (8 levels,
             4 starts) must equal the host DP exactly, and B1 on a count
             frontier whose sums reach 2^24 - 1 (runs of 8 full tiles)
             must be ``torch.equal`` to its plain version;
* sharded  — the site-sharded backend (B3 and B1, one launch per shape
             bucket and level, on a work list that concatenates the
             bucket's member sites') and the reference backend (no
             kernel), each check raising: (i) the twin on 16 sites at
             replication rate 0.2 over the bit-plane store, Stage A per
             site, merged into 1 and 4 groups and bucketed (each step
             timed, bytes and bucket shapes logged); q1, q9, q12 over all
             valid starts at both group counts: answers == the device
             BFS, q_bc and n_bc == the host meter on the path phase's 32
             sampled starts, B3 launches == bodies x LEVELS_PER_CHECK x
             buckets, per-site
             meters equal at 1 and 4; (iv) B3 on the 4-row bucket of q1's
             plan ``torch.equal`` to the members' plain levels summed,
             and q1's per-site meters unchanged with ``allow_tf32 =
             True``; (iii) the reference backend on (i)'s placement, whose
             d_s2 must equal the sharded per-site meters summed, exactly,
             and on the setup's 256-site placement, 64 starts of each
             query (the 32 metered and 32 sampled): answers == the device
             BFS, meters == the host meter, no kernel launched; (ii) an
             8,000-node twin (``alibaba_like(8000, 52000)``) on 16 sites
             over the f32 store, at 1 and 4 groups, pairs and witness
             runs: the checks of (i), witness answers and meters == the
             pairs run, levels == ``host_levels`` on 4 starts and 8
             walked-back witnesses valid, then B1 on its 4-row bucket ==
             plain; the host's MemAvailable is logged before staging.
             The 16 sites and the f32 graph are cut for host memory: per
             site Stage A of the twin's 256 sites would be 15.7 M tiles
             (1.03 TB f32, 32.2 GB of bit-planes), and its f32 slabs at 16
             sites 64.6 GB;
* mesh     — the mesh programs over ranks (``mesh=``, one process a
             rank on ``torch.distributed``, levels ``pmax``-ed over the
             site axes, outputs gathered as a SUM into zeroed buffers):
             first the one-card references (``mesh=None``) at the ranks'
             axis sizes, as sha256 digests of answers, every cost field,
             witness levels and S1 buffers, and of each bucket row of the
             one-card plan; then (a) one NCCL rank in this process on a
             (1, 1) mesh: the sharded phase's (i) on B3 on its first 64
             valid starts a query, the reference backend on the 256-site
             placement (64 starts a query, pairs and witness) and the plan
             phase's S1
             gathers (every Table-2 query's labels at the padded width);
             (b) 4 ``gloo`` ranks spawned on the one card (NCCL refuses
             two ranks on one device): (i) on a (4, 1) mesh, (ii) on a
             (2, 2) mesh (B1, pairs and witness), each on its first 64
             valid starts a query, and the reference backend and S1 as
             in (a) on (4, 1).  Every digest must equal the one-card
             run's, every rank's bucket arrays and tiles its rows of the
             one-card plan, and each rank's B1/B3 launches its levels (one
             bucket a rank); the bytes all_reduced per level and the wall
             times of the 4 ranks sharing one card are logged (not
             multi-card times).  Its (c) and (d) run later, beside the
             phases whose inputs they take:
* mesh_serve — (c), after serve, the service over ranks: serve run (h)
             (the first 48 requests on ``frontier_kernel_sharded`` over
             the bit-plane store and the 16 sites) through
             ``QueryService(mesh=)``, rank 0 leading and the others
             following its flush orders: on one card at axis sizes 4 and
             2 (equal to run (h) at 1), on one NCCL rank (a (1, 1) mesh),
             and on 4 ``gloo`` ranks at (4, 1) and (2, 2); run (g) (the
             reference backend, first window forced to S1) at (4, 1);
             each rank's share of Stage A saved to its own file and
             restored into a fresh service whose first S2 request packs
             no tile, another rank's file refused; the async front end
             led by rank 0 over the 48 at run (e)'s 1x rate.  Every
             request's answers, costs, strategy and levels equal run
             (h)'s or (g)'s, on every rank (the async answers run (h)'s,
             and the same on every rank), B3 launching once a level a
             rank;
* examples — after mesh_serve, the port's example scripts on the card
             through their ``main(argv)``: ``examples/torch_quickstart.py``
             and ``examples/torch_plan_and_serve_rpq.py --small --queries
             q1,q6`` (an 8,000-node twin, its one-card service on the
             default backend, every start's answers held to the PAA
             oracle): no ``MISMATCH``, every start ``OK``;
* mesh_dlrm — (d), after dlrm, on one NCCL rank: dlrm-mlperf ``full()``
             at serve_p99 on a (1, 1) mesh on the dlrm phase's
             parameters: the bags bit for bit the one-card ones, each B6
             launch on the rank's lookups, 26 a step, the probabilities
             within 1e-6 of the largest;
* mesh_models — (d), after gnn, on 4 ``gloo`` ranks: dlrm-mlperf at
             serve_p99 on (2, 2) with its tables capped at 2^22 rows
             (row-sharded over the model axis, the batch over the data
             axis), gcn-cora at ogb_products on (4, 1) (edges blocked over
             the ranks, its degrees exact), schnet, nequip and
             equiformer-v2 ``full()`` at molecule on (2, 2), each against
             the one-card run of the same weights and inputs (DLRM's bags
             bit for bit, probabilities 1e-6; GNNs 1e-5, equiformer-v2
             1e-4), B6 launches a step as on one card; the capped DLRM's
             retrieval_cand step on (2, 2) over 1,000,000 candidates,
             each rank handed its block over every axis as ``repro``
             fits it (250,000), its top 64 gathered: the scores within
             1e-6 of the largest of the one-card top 64's, the indices
             equal up to ties; the all_reduces a
             step, their bytes and the ms a step logged per rank; (e)
             ``equiformer_energy_big`` at full width: on one NCCL rank
             in this process, ``equiformer_energy`` on a uniform graph of
             150,000 nodes at ogb_products' mean degree (3,789,000 edges
             padded to 116 chunks of 32,768) takes the big path (B6
             launches 2 x chunks x layers, the energy finite), and on a
             graph of 4,096 nodes and 16,384 edges (one chunk) and one of
             4,096 nodes and 100,000 edges (4 chunks, 31,072 masked)
             ``equiformer_atoms_big``'s energy is within EQ_TOL and
             every node's energy within EQ_ATOM_TOL of its plain twin's
             on the card; on
             the 4 ranks at (2, 2) the first graph's energy within EQ_TOL
             of the NCCL rank's;
* mesh_lm  — after moe, the LMs' mesh programs: (a) one NCCL rank in
             this process on a (1, 1) mesh: qwen3-14b at full width with
             2 layers at long_500k (batch 1, S 524,288, a random 4.29 GB
             cache) decoded with ``seq_sharded=True``, 4 steps from len
             S - 17 and one at len 1,000, logits bit for bit the one-card
             decode's, B7's partials and combine entries launching layers
             x steps each; before it, those entries at the ranks' shard
             shape against their plain twins and ``flash_decode_gqa_plain``
             (BF16_TOL), a shard past kv_len writing (-1e30, 0, 0), timed
             beside their bounds; (b) 4 ``gloo`` ranks on (1, 4), each on
             131,072 positions of the same cache (drawn from the seed
             block by block), the same steps within BF16_TOL of the
             largest |logit| of one card's, all_reduced bytes a step
             logged, each rank holding its tensor-parallel blocks (its
             dense weights exactly the whole's over 4); (c) 4 ``gloo``
             ranks on (2, 2): granite-moe-1b-a400m expert-parallel, its
             attention and vocab tensor-parallel (the dense weights the
             whole's over 2, a rank's heads reading their kv groups of
             the cache in place: B7's kv-head offset), the request run at
             capacity 1.25 (every MoE
             call within BF16_TOL of ``moe_capacity_plain``, drops logged)
             and at 2.0 (no drop, every call also within BF16_TOL of the
             one-card layer), at 2.0 again fed the moe phase's one-card
             tokens and experts (a token may take others only at a near
             tie), its prefill and last logits within BF16_TOL of the
             largest |logit| of one card's, then decode_32k at 2 layers on each rank's
             block of the batch (ms a step, all_to_all bytes); (d) one
             NCCL rank: kimi-k2 at full width with 1 layer, its experts
             expert-parallel with ``fsdp_experts``, the request run with
             every MoE call held to ``moe_capacity_plain``;
* serve    — the serving runtime on the same twin and placement (the plan
             phase's overlay; ``ServeConfig(n_rollouts=150, seed=0)``, the
             planner deciding): a 144-request ``workloads.generate``
             stream (8 hot classes, 80% hot, 1-8 starts) through
             ``QueryService`` in windows of 16 (enqueue, flush): (a) on
             ``frontier_kernel_packed`` over the uint32 store (B4), cold
             then warm; (d) its first 8 as witness requests, forced to S2,
             which restage f32 and run B2, 3 sampled pairs of each walked
             back and validated; (e) ``AsyncQueryService`` on the warm
             service, open loop (Poisson arrivals, serve_async.py's
             tenants, SLO mix and knobs) at 1x and 2x (a)'s warm q/s over
             the first 48, accepted answers == the sync ones; (b) the
             first 48 on ``frontier_kernel`` over the f32 store (B1) in a
             fresh service; (f) (b)'s Stage A saved and restored into a
             fresh service, whose first S2 request must pack no tile; (c)
             (b) again under a 1 GiB out-of-core budget, answers == (b)'s,
             spills and reloads nonzero; (g) the first 48 on the default
             ``ServeConfig`` (the reference backend, no kernel launched),
             the first window forced to S1; (h) the first 48 on
             ``frontier_kernel_sharded`` over the bit-plane store on the
             sharded phase's 16-site placement (B3, launches == bodies x
             LEVELS_PER_CHECK x buckets), its per-site Stage A saved and
             restored into a
             fresh service whose first S2 request must pack no tile.
             Every answer == the device BFS;
             each run's level kernel launches LEVELS_PER_CHECK times a
             body and no other kernel; a third warm run of (a) is traced
             (device busy ms, idle share); the summary's keys == ``repro``'s schema
             (``SUMMARY_KEYS``).  Each run logs q/s, latency p50 and p99
             and the host ms of the service's layers;
* baseline — the per-transition baseline path, carried by B5
             ``frontier_step_blocks``: the twin as per-label tile lists
             (``make_blocked_graph``) and Stage A again from them (equal
             to the graph's f32 store); B5 against its plain version on
             cases a to c as tile lists; 32 sampled starts of q1, q9 and
             q12, one ``multi_source_reach_baseline`` each, whose answers
             must equal the fused path on the same BlockedGraph (B1) and
             the device BFS, and whose B5 launches must equal levels x
             (transition, store) entries with no other kernel launched;
             one ``expand_level`` timed beside one ``expand_level_fused``,
             and each of its B5 launches, at the path's own operands,
             equal to the plain version; the tiles, chunks (CTAs) and
             longest column run of each launch of the q1 level;
* embedbag — B6 ``embedding_bag_sorted`` through ``embedding_bag`` at
             dlrm-mlperf's largest table (39,979,771 x 128 bf16) and
             through ``gnn_aggregate`` at ogb_products (2,449,029 nodes,
             61,859,140 uniform edges, 100 f32 features), each
             ``torch.equal`` to its plain version, with its launch
             geometry (lane groups, lanes, load width, lookups a group),
             bounds by distinct rows, by gathered rows and by gathered
             32-byte sectors, and ``F.embedding_bag``;
* decode   — B7 ``flash_decode_gqa`` through ``decode_attention`` at
             qwen3-14b's attention widths at decode_32k and long_500k,
             and at kimi-k2's (H 64, G 8, head dim 112) at decode_32k,
             against its plain version (max |diff| at most 2e-2 of the
             largest |output|, which an all-zero output and the kernel on
             half the cache must both miss) and SDPA; each shape's
             kv split (n_split, split length, partials' bytes) is logged;
             then B7 on a kv-head offset, read in place, at the shapes
             mesh_lm (c) gives a granite rank (its 8 of 16 q heads on
             kv groups [0, 4) and [4, 8) of the whole 8-group cache,
             Dh 64: decode_32k's 64 rows, the request run's 4 rows of
             1,040) against its plain version at the same offset, to
             the same limit, which the other half's groups must miss;
* dlrm     — dlrm-mlperf ``full()`` whole on the card (26 bf16 tables,
             48.07 GB; f32 MLPs 13-512-256-128 and 479-1024-1024-512-
             256-1) through ``models/dlrm.py``'s serve and retrieval
             steps, on ``data/pipeline.py`` ``dlrm_batch`` ids: serve_p99
             (batch 512) median and p99 ms, serve_bulk (batch 262,144)
             samples/s, retrieval_cand (1,000,000 candidates, top 64) ms,
             all by CUDA events a step; B6 launches == 26 a step, nothing
             else; probabilities finite in [0, 1]; each table's bags of a
             serve_bulk step ``torch.equal`` to the plain version; one
             retrieval's top 64 == the plain bags' (scores exact); one
             serve_bulk step traced for B6's and the GEMMs' shares;
* lm       — qwen3-14b at full width, 40 layers cut to 2 (the full
             decode_32k cache is 687 GB): (a) 8 ``lm_batch`` prompts of
             1,024 tokens through ``make_prefill``, the cache copied into
             ``init_cache(max_len=1,040)``, 16 greedy ``make_decode_step``s;
             the prefill's and the last step's logits within BF16_TOL of
             the largest |logit| of the port's CPU run of the same weights
             and tokens; B7 at that cache's shape ~= plain; (b) decode_32k
             (batch 128, a random 34.36 GB cache at len 32,768 - 17): ms a
             step by events, tokens/s, the byte bound, one step traced for
             B7's share; B7 launches == layers x steps, nothing else;
* moe      — (a) granite-moe-1b-a400m whole (24 layers, 32 experts
             top-8, 2.78 GB): the request run of the lm phase, its CPU
             replay of prompt 0 fed the card's tokens and experts
             (``RouteTape``: a token's own top-k may differ from the
             card's only where its k-th to (k+1)-th logit gap is at most
             twice its row's largest |logit difference|, and the router
             logits agree within BF16_TOL of the largest |logit|) within
             BF16_TOL of the largest |logit|;
             decode_32k with 24 layers cut to 4 (a 24-layer cache is
             206 GB): ms a step, tokens/s, the byte bound of the experts
             the step's tokens chose, the MoE layers timed apart, one
             step traced; (b) kimi-k2-1t-a32b at full width with 61
             layers cut to 1 (38.8 GB): the request run (logits finite),
             64 routed MoE outputs of its prefill against a token-by-
             token recomputation from the gathered experts within
             BF16_TOL, B7 at Dh 112 at the request cache's shape ~=
             plain, decode_32k as (a); B7 launches == layers x steps,
             nothing else;
* gnn      — the four GNN serve steps on data drawn from the seed, every
             scatter and readout on B6 (launches == scatters a step,
             nothing else), each within GNN_TOL of the port's CPU run
             of the same weights and batch: (a) gcn-cora at
             ogb_products (2,449,029 nodes x 100 f32, 61,859,140 uniform
             edges padded to 61,859,328), nodes/s; (b) gcn-cora on a
             minibatch_lg block (``NeighborSampler`` over a uniform
             graph of reddit's 232,965 nodes and 114,615,892 edges,
             1,024 seeds, fanout 15-10, 602 features), the graph build
             and the sampling timed on the host apart from serve ms;
             (c) schnet, nequip and equiformer-v2 ``full()`` at molecule
             (128 molecules x 30 atoms, 64 edges each), molecules/s, one
             equiformer-v2 step traced for B6's share;
* train    — training through ``repro_torch.training`` (AdamW), every
             table's and scatter's gradient B6 on the lookups sorted by
             row: (a) gcn-cora at ogb_products whole (the gnn phase's
             graph, labels and a train mask of ogbn-products' 196,615
             nodes), 6 steps of ``loop.run``: 6 B6 launches a step (4
             forward, 2 backward), the first step's loss and every
             gradient leaf within 1e-5 of the CPU run's largest, each
             backward launch ``torch.equal`` to plain on its real
             cotangent, a crash at step 3 and a resume from step 2 whose
             parameters equal the uninterrupted run's bit for bit, ms a
             step and nodes/s, one step traced (B6 forward and backward
             apart, the sorts); (b) dlrm-mlperf with each table capped at
             2^22 rows at train_batch (65,536): 52 B6 launches a step,
             each table's backward launch == plain and zero on unread
             rows, a 4,096-sample batch's loss and gradients against the
             CPU (MLPs 1e-5, bf16 tables 2e-2), AdamW on 4,096 sampled
             rows of each table against a CPU update (f32 1e-6, bf16 one
             ulp), AdamW's ms apart, one step traced; (c) qwen3-14b at
             full width, 2 layers, 4 sequences of 4,096 (4 microbatches),
             2 steps: no kernel of the repo (no B7), losses finite,
             1 x 256 tokens' loss and lm_head, embed and layer-0
             gradients within 2e-2 of the CPU run's largest, the
             attention and AdamW timed apart, one step traced.  B6's
             backward launch at (a)'s and (b)'s shapes is timed as the
             forward is, beside its bound, plain version and
             ``F.embedding_bag``'s backward;
* mesh_train — training over ranks on one NCCL rank, a (1, 1) mesh:
             (a) gcn-cora at ogb_products (the train phase's graph) one
             AdamW step with ZeRO-1 through ``make_gnn_train_step``, its
             loss, parameters and moments ``torch.equal`` to the one-card
             step's; granite-moe-1b-a400m at full width with 4 layers in
             f32, 4 x 1,024 tokens, expert-parallel at capacity 2.0, fed
             the one-card run's experts (``RouteTape``): 0 drops, every
             gradient leaf within GRAD_TOL of the one-card step's (the
             one-card layer is another function: routed rows against
             GShard slots; in bf16 the two round apart by more than a
             wrong reduction would show); (c) ``equiformer_energy_big``'s
             gradient on 4,096 nodes and 100,000 edges (4 chunks, the
             last masked), each layer and chunk recomputed in the
             backward, every leaf within EQ_GRAD_TOL of
             ``equiformer_atoms_big_plain``'s gradient on the card.
             Training over several ranks (4 ``gloo`` ranks sharing the
             card: capped DLRM's ZeRO steps, granite, the EquiformerV2
             gradient, a resume and a restore on another layout) is left
             out of the script: with it the script took 1,186 and 1,268 s
             on the card, over its 1,200-s limit;
             ``tests/test_torch_mesh_train.py`` holds those programs on
             the CPU at (2, 1), (4, 1), (2, 2) and (1, 4);
* dryrun   — the port's dry run (``repro_torch.launch``): (a) every cell
             of ``all_cells()`` but the LMs' train_4k and prefill_32k at
             the (16, 16) and (2, 16, 16) layouts (EquiformerV2 at
             ogb_products at the second only) on the meta device, each
             the program rank 0 runs there under a fake process group
             of 256 or 512 ranks, one line a cell (the rank's argument GiB, the roofline's compute,
             memory and collective terms, the bottleneck, the logical and
             wire collective bytes); (b) qwen3-14b decode_32k with 2
             layers (B7), dlrm-mlperf serve_bulk (B6) and a gcn-cora train
             step at ogb_products (B6 forward and backward), each counted
             by ``analysis.count_step`` on meta twins and then on the real
             arguments on the card: FLOPs equal (GCN's meta count larger
             by exactly its 188 padded edges' B6 work), the meta argument
             bytes equal to the allocator's requested bytes while the
             arguments are made, the meta peak beside
             ``max_memory_allocated``, and the step's ms (CUDA events)
             beside its roofline bound and share; (c) the gcn-cora train
             step at ogb_products as rank 0 of a (1, 1) mesh, counted on
             meta under a fake group and on the card under a one-rank
             NCCL group: the same collectives by kind, the card's c10d
             bytes equal to the run's ``WIRE_COUNTERS``, B6 equal to its
             plain version on the rank's degree scatter; (d) each kernel
             custom op's host µs a call against its CUDA implementation
             called directly, 1,000 calls each on small inputs.

The embedbag, decode, dlrm, lm, moe, gnn, train, mesh_train and dryrun
phases take their shapes from the port's configs (``configs/dlrm_mlperf.py``, ``qwen3_14b.py``,
``granite_moe_1b_a400m.py``, ``kimi_k2_1t_a32b.py``, the GNN configs,
``gnn_common.py`` and ``registry.py``'s shape tables), and the setup
its sites and rate from ``configs/alibaba_rpq.py``.

Each phase logs its seconds and peak device memory and frees its tensors
before the next.  The CPU references that take tens of seconds (the lm
phase's replay, the gnn phase's CPU runs, the train phase's float64
GCN run and LM check) run in threads (:class:`Background`) beside the
card's work, at the lowest CPU priority, on the same inputs with the same
arithmetic and limits, and are held where the gnn phase (the lm replay
and the gnn phase's) and the mesh_train phase (the train phase's) end;
patches of a function (``patched``) and the ReLU tape of the card's run
do not reach those threads, nor theirs the card's.  B5, B6 and B7 are
timed as B1-B4 are (CUDA graph, L2 flushed and warm; one call between
events) beside their plain versions,
their bounds and, where one PyTorch call computes the same function, that
call.  The last two lines are a JSON object with one entry per kernel,
then ``{"ok": true, "device": {...}}``.  It exits non-zero, printing no result,
when no GPU is present or when run without the repository's ``src/``.
"""

from __future__ import annotations

import argparse
import asyncio
import collections
import contextlib
import dataclasses
import functools
import hashlib
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
from repro_torch import interop  # noqa: E402
from repro_torch.configs import alibaba_rpq, dlrm_mlperf, gnn_common, qwen3_14b, registry  # noqa: E402
from repro_torch.configs import granite_moe_1b_a400m, kimi_k2_1t_a32b  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.dist import collectives  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.graph.sampling import NeighborSampler  # noqa: E402
from repro_torch.models import dlrm, gnn, transformer  # noqa: E402
from repro_torch.models import layers as lm_layers  # noqa: E402
from repro_torch.training import loop  # noqa: E402
from repro_torch.training import optimizer as opt_lib  # noqa: E402
from repro_torch.training.tree import leaves, leaves_with_paths, tree_map, value_and_grad  # noqa: E402
from repro_torch.core import cost_model, paa, planner, plans, strategies, witness  # noqa: E402
from repro_torch.core import regex as rx  # noqa: E402
from repro_torch.graph.generators import (  # noqa: E402
    TABLE2_PAPER, TABLE2_QUERIES, alibaba_like, random_labeled_graph,
)
from repro_torch.graph.partition import distribute, random_overlay  # noqa: E402
from repro_torch.graph.structure import LabeledGraph, to_device_graph  # noqa: E402
from repro_torch.graph.workloads import WorkloadConfig, generate  # noqa: E402
from repro_torch.serve import QueryService, ServeConfig, batcher, persist  # noqa: E402
from repro_torch.serve.aio import AdmissionRejected, AioConfig, AsyncQueryService  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import analysis, cells, dryrun, ranks  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.kernels.decode_attn import decode_attn  # noqa: E402
from repro_torch.kernels.decode_attn import ops as da_ops  # noqa: E402
from repro_torch.kernels.embedbag import embedbag  # noqa: E402
from repro_torch.kernels.embedbag import ops as eb_ops  # noqa: E402
from repro_torch.kernels.frontier import frontier as fkernel  # noqa: E402
from repro_torch.kernels.frontier import ops as fops  # noqa: E402
from repro_torch.kernels.frontier.ref import tile_words  # noqa: E402

# published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s,
# float32 FLOP/s outside the tensor cores, and dense bf16 FLOP/s on the
# tensor cores; INT32 lanes are half the FP32 lanes of an SM (64 against
# 128), so int32 operations run at half the float32 rate
INT32_OPS = 67e12 / 2
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
QUERIES = ("q1", "q9", "q12")
N_METER_SAMPLES = 32
SEED = 0
CSRC = "src/repro_torch/kernels/frontier/csrc"
FRONTIER_PY = "src/repro/kernels/frontier/frontier.py"
N_BASELINE_STARTS = 32
# the plan phase (§6): a 256-peer overlay of mean degree d = 3, as the
# paper's worked example; rollouts per estimate; starts per query
PLAN_SEED, PLAN_DEGREE, PLAN_ROLLOUTS, N_PLAN_STARTS = 6, 3.0, 300, 8
# the witness phase: witnesses walked back per query and backend; the
# count_paths_bounded length on q1; nodes of the complete digraph on which
# B1 sums counts to 2^24 - 1 (8 blocks of 128: runs of 8 full tiles)
N_WITNESSES, COUNT_LEVELS, COUNT_NODES = 8, 8, 1024
# the serve phase: the stream of benchmarks/serve_async.py's default size
# (144 requests, 8 hot classes, 1-8 starts); requests per sync window; the
# prefix of the f32, budgeted and async runs; witness requests and the
# pairs walked back from each; the out-of-core budget, about a tenth of the
# f32 store's 10.551 GB; the async mix and knobs of serve_async.py
SERVE_QUERIES, SERVE_WINDOW, SERVE_PREFIX, SERVE_WITNESS, SERVE_WALKS = 144, 16, 48, 8, 3
SERVE_ROLLOUTS, SERVE_BUDGET = 150, 2**30
SERVE_TENANTS, SERVE_LATENCY_SHARE = ("tenant-a", "tenant-b", "tenant-c"), 0.7
SERVE_AIO = {"max_window_s": {"latency": 0.25, "throughput": 1.0}, "window_gain": 2.0,
             "min_window_s": 0.01, "queue_depth": {"latency": 48, "throughput": 96}}
# the sharded phase: per-site Stage A holds every site's own copy of its
# edges' tiles, so the paper's 256 sites of the twin would stage 15.7 M
# tiles (1.03 TB f32, 32.2 GB of bit-planes); the phase cuts the site count
# to 16 (0.99 M bit-plane tiles, 2.0 GB of host slabs) and, for the f32
# store (64.6 GB of host slabs at 16 sites on the twin), the graph too.
# The group sizes it runs; the f32 graph; the reference run's starts a query
SHARD_SITES, SHARD_AXES = 16, (1, 4)
SHARD_F32_NODES, SHARD_F32_EDGES = 8000, 52000
N_REFERENCE_STARTS = 64
# the mesh phase: (a) one NCCL rank in this process on a (1, 1) mesh; (b)
# MESH_RANKS gloo ranks spawned on the one card (NCCL refuses two ranks on
# one device): the sharded phase's (i) on MESH_I_SHAPE, its (ii) on
# MESH_II_SHAPE, the reference backend and S1 on the 256-site placement on
# MESH_I_SHAPE, as (data, model) meshes; the spawn's time limit
MESH_RANKS, MESH_I_SHAPE, MESH_II_SHAPE, MESH_TIMEOUT_S = 4, (4, 1), (2, 2), 400
# (a) and (b) run (i) and (ii) on the first MESH_B_STARTS valid starts of
# each query: at all 477-715 starts, 4 ranks would put the twin's frontier
# (1.6 MB a level) through gloo 2,577 times over; 64 rather than 128 (and
# (a) no longer on all of them) keeps the script, (c) and (d) added,
# inside its time limit on a slow host
MESH_B_STARTS = 64
# its (c), the service over ranks: serve run (h) (the first SERVE_PREFIX
# requests on sharded/uint32 over the 16 sites) on one card at the ranks'
# axis sizes, on one NCCL rank, and on MESH_RANKS gloo ranks at
# MESH_I_SHAPE and MESH_II_SHAPE; run (g) and the async front end at
# MESH_I_SHAPE; (d), the models over ranks: dlrm-mlperf serve_p99 on one
# NCCL rank at full width, and on MESH_II_SHAPE with its tables capped at
# MESH_DLRM_CAP rows (4 ranks' shards and the one-card reference on one
# card), MESH_DLRM_STEPS steps timed a rank; gcn-cora at ogb_products on
# MESH_I_SHAPE; the molecular GNNs at molecule on MESH_II_SHAPE
MESH_DLRM_CAP, MESH_DLRM_STEPS, MESH_RETRIEVAL_STEPS = 2**22, 10, 5
# its (e), equiformer_energy_big at full width: on one NCCL rank on a uniform
# graph of EQ_BIG_NODES nodes (repro's _BIG_GRAPH_NODES, so that
# equiformer_energy dispatches to it) at ogb_products' mean degree, and on
# EQ_SMALL_NODES nodes and EQ_SMALL_EDGES edges (one NCCL rank and
# MESH_II_SHAPE), and on EQ_SMALL_NODES nodes and EQ_MULTI_EDGES edges (one
# NCCL rank: several chunks, the last padded with masked edges); positions
# uniform in a cube of side EQ_BOX.  Energies are held within EQ_TOL of the
# reference's (the ranks' to one NCCL rank's, 5.6e-5 seen; one NCCL rank's
# to the plain twin's, 5.3e-5 seen), and every node's energy within
# EQ_ATOM_TOL of the plain twin's largest (2.5e-3 seen: bf16 accumulation
# against f32)
EQ_BIG_NODES, EQ_SMALL_NODES, EQ_SMALL_EDGES, EQ_MULTI_EDGES = 150_000, 4096, 16384, 100_000
EQ_BOX, EQ_TOL, EQ_ATOM_TOL = 10.0, 5e-4, 1e-2
# the mesh_lm phase: (a) one NCCL rank and (b) MESH_RANKS gloo ranks on
# MESH_LM_SHAPE, qwen3-14b long_500k (batch 1, S 524,288) with LM_LAYERS
# layers on a cache sharded along the sequence, MESH_LM_STEPS decode steps
# from len S - 17 and one more with len MESH_LM_LOW (inside rank 0's shard:
# three shards past it); the cache drawn LONG_BLOCK positions at a time;
# (c) granite-moe-1b-a400m expert-parallel on MESH_II_SHAPE at capacity
# 1.25 and at MESH_MOE_NO_DROP, which no routing can overflow at the
# request run's and decode_32k's shapes (cap_send >= a rank's assignments,
# cap_exp >= every token of both sources on one expert), then decode_32k
# cut to MESH_MOE_DECODE_LAYERS layers: the model axis holds each batch
# block's cache twice, and at the moe phase's 4 layers the 4 ranks' caches
# alone would be 68.7 GB of the one card; (d) kimi-k2 at full width with
# KIMI_LAYERS layer on one NCCL rank
MESH_LM_SHAPE, MESH_LM_STEPS, MESH_LM_LOW, MESH_MOE_NO_DROP, LONG_BLOCK = (1, 4), 4, 1000, 2.0, 2**14
MESH_MOE_DECODE_LAYERS = 2
# the shapes of the embedbag and decode phases, from the port's configs:
# dlrm-mlperf's largest Criteo table (embed_dim 128, bf16 tables) at
# serve_bulk (batch 262,144 x multi_hot 1); ogb_products; qwen3-14b's
# attention widths (40 q-heads, 8 kv heads, head dim 128, bf16) at
# decode_32k and long_500k
RPQ = alibaba_rpq.full()
DLRM = dlrm_mlperf.full()
DLRM_ROWS, DLRM_DIM = max(DLRM.table_sizes), DLRM.embed_dim
DLRM_LOOKUPS = registry.RECSYS_SHAPES["serve_bulk"].dims["batch"] * DLRM.multi_hot
OGB_NODES, OGB_EDGES, OGB_FEAT = (registry.GNN_SHAPES["ogb_products"].dims[k]
                                  for k in ("n_nodes", "n_edges", "d_feat"))
QWEN = qwen3_14b.full()
QWEN_HEADS, QWEN_KV_HEADS, QWEN_DH = QWEN.n_q_heads, QWEN.n_kv_heads, QWEN.d_head
DECODE_SHAPES = {name: (registry.LM_SHAPES[name].dims["batch"], registry.LM_SHAPES[name].dims["seq"])
                 for name in ("decode_32k", "long_500k")}
# the decode phase's cases: (batch, S, q-heads, kv heads, head dim): qwen3-14b
# at decode_32k and long_500k, and kimi-k2-1t-a32b's attention (64 q-heads,
# 8 kv heads, head dim 112) at decode_32k
GRANITE = granite_moe_1b_a400m.full()
KIMI = kimi_k2_1t_a32b.full()
DECODE_CASES = {
    **{name: (b, s, QWEN_HEADS, QWEN_KV_HEADS, QWEN_DH) for name, (b, s) in DECODE_SHAPES.items()},
    "kimi_decode_32k": (*DECODE_SHAPES["decode_32k"], KIMI.n_q_heads, KIMI.n_kv_heads, KIMI.d_head),
}
# the dlrm phase: dlrm-mlperf full() whole (26 tables, 48.07 GB); steps
# timed after DLRM_WARMUP untimed ones: serve_p99 (batch 512), serve_bulk
# (batch 262,144), retrieval_cand (1,000,000 candidates, top 64); each
# step its own dlrm_batch step
DLRM_P99_STEPS, DLRM_BULK_STEPS, DLRM_RETRIEVAL_STEPS, DLRM_WARMUP = 60, 10, 20, 2
# the lm phase: qwen3-14b at full width, 40 layers cut to LM_LAYERS (the
# full decode_32k cache would be 687 GB); the request run's prompts, their
# length and the greedy tokens decoded after them; decode_32k steps timed
# after LM_WARMUP untimed ones
LM_LAYERS, LM_REQUESTS, LM_PROMPT, LM_NEW, LM_DECODE_STEPS, LM_WARMUP = 2, 8, 1024, 16, 20, 3
# the moe phase: granite-moe-1b-a400m whole (24 layers) for the request
# run, its decode_32k cut to MOE_DECODE_LAYERS layers (a 24-layer cache is
# 206 GB); kimi-k2-1t-a32b at full width cut to KIMI_LAYERS layer (one
# layer's experts are 33.82 GB, all 61 ~2 TB); the prompts of the request
# run that the CPU replays (a replay of all 8 through 24 bf16 layers would
# take minutes of host time); the tokens whose MoE output is recomputed
# token by token on the card
MOE_DECODE_LAYERS, KIMI_LAYERS, MOE_CPU_PROMPTS, KIMI_CHECK_TOKENS = 4, 1, 1, 64
MOE_DECODE_STEPS, MOE_WARMUP = 12, 2
# the gnn phase: gcn-cora at ogb_products and on a minibatch_lg block
# (1,024 seeds, fanout 15-10, NeighborSampler over a uniform graph of
# reddit's 232,965 nodes and 114,615,892 edges), and the three molecular
# GNNs at molecule (128 molecules x 30 atoms, 64 edges each); serve steps
# timed after one untimed step.  The CPU runs hold f32 results to GNN_TOL
# of the largest |output| (EquiformerV2: GNN_TOL_EQUIFORMER, 12 layers of
# f32 products summed in another order on each device)
GNN_STEPS, GNN_WARMUP, GNN_TOL, GNN_TOL_EQUIFORMER = 5, 1, 1e-5, 1e-4
MINIBATCH_SEEDS = registry.GNN_SHAPES["minibatch_lg"].dims["batch_nodes"]
MINIBATCH_FANOUT = tuple(registry.GNN_SHAPES["minibatch_lg"].dims[k] for k in ("fanout0", "fanout1"))
# the train phase: (a) gcn-cora at ogb_products, TRAIN_GCN_STEPS AdamW steps
# through training.loop.run, checkpoints every TRAIN_CKPT_EVERY, a simulated
# crash at TRAIN_CRASH_AT; ogbn-products' published train split
# (OGB_TRAIN_NODES nodes) as the size of the train mask; (b) dlrm-mlperf at
# train_batch with each table capped at TRAIN_TABLE_CAP rows (the full set's
# bf16 tables, gradients and f32 moments are 288 GB), TRAIN_DLRM_STEPS steps,
# the CPU check on a TRAIN_DLRM_CHECK_BATCH batch, AdamW against a CPU update
# on TRAIN_SAMPLED_ROWS rows of each table; (c) qwen3-14b at full width with
# TRAIN_LM_LAYERS layers, train_4k cut to TRAIN_LM_SEQS sequences of 4,096
# (the config's 4 microbatches of one), TRAIN_LM_STEPS steps, the CPU check
# on 1 x TRAIN_LM_CHECK tokens.  f32 gradients are held to GRAD_TOL of the
# largest |gradient| of their leaf, bf16 ones to BF16_TOL.  GCN's are held
# to a CPU run in float64: its gradients sum 2.4 M nodes' terms of either
# sign, whose f32 rounding a second f32 run would add to the comparison
TRAIN_GCN_STEPS, TRAIN_CKPT_EVERY, TRAIN_CRASH_AT, OGB_TRAIN_NODES = 6, 2, 3, 196_615
TRAIN_TABLE_CAP, TRAIN_DLRM_STEPS, TRAIN_DLRM_CHECK_BATCH, TRAIN_SAMPLED_ROWS = 2**22, 3, 4096, 4096
TRAIN_LM_LAYERS, TRAIN_LM_SEQS, TRAIN_LM_STEPS, TRAIN_LM_CHECK = 2, 4, 2, 256
GRAD_TOL = 1e-5
# the dryrun phase: (a) the port's dry run, rank 0's program, over every
# cell of all_cells() at both production layouts but the LMs' train_4k and
# prefill_32k, whose meta counts take 17 s to minutes of host time each
# (their ~10^6 plain ops a step: PERF.md §4), and EquiformerV2 at
# ogb_products counted at (2, 16, 16) only, whose rank program
# (equiformer_energy_big on 59 chunks of edges a layer there, 118 at
# (16, 16)) takes a minute or more a layout; `python -m
# repro_torch.launch.dryrun` counts them all at both; (b) three steps the
# phases run, each counted on meta tensors and
# on the card, then timed: DRYRUN_STEPS steps after the one that reads
# its peak, which is their warmup; (d) each custom op's host cost:
# DRYRUN_OP_CALLS calls of it and of its CUDA implementation
DRYRUN_LEFT_OUT_SHAPES = ("train_4k", "prefill_32k")
DRYRUN_MULTI_ONLY_CELLS = (("equiformer-v2", "ogb_products"),)
DRYRUN_STEPS = 5
DRYRUN_OP_CALLS = 1000
# B7 against its plain version: max |diff| at most BF16_TOL (the bf16
# tolerance of tests/test_kernels.py:140) times the largest |output|.  The
# outputs average ~kv_len V rows, so their size falls as 1/sqrt(kv_len)
# (largest ~4e-2 at decode_32k, ~1e-2 at long_500k): an absolute 2e-2
# would pass an all-zero output.  Relative to the largest output it is a
# few bf16 ulps there, the most by which the two roundings of p and of
# the output to bf16 may part.  Two controls on the same inputs must fail
# it: an all-zero output, and the kernel run on half the cache.
BF16_TOL = 2e-2
# mesh_train: granite at MESH_TRAIN_LM_LAYERS layers and
# MESH_TRAIN_LM_SEQS x MESH_TRAIN_LM_SEQ tokens at a capacity that drops
# nothing; equiformer_energy_big's gradient limit against the plain twin;
# a leaf is held against the larger of its largest |value| and
# GRAD_FLOOR of the model's
MESH_TRAIN_LM_LAYERS, MESH_TRAIN_LM_SEQS, MESH_TRAIN_LM_SEQ, MESH_TRAIN_NO_DROP = 4, 4, 1024, 2.0
EQ_GRAD_TOL, GRAD_FLOOR = 1e-2, 1e-3

# the serve phase's summary schema: repro's ServiceMetrics summary with the
# service's extras, key for key (a None leaf is any value, {} any keys).
# This script cannot import repro; tests/test_torch_serve.py holds this
# literal to repro's schema.
def _leaves(*names: str) -> dict:
    return dict.fromkeys(names)


_ADMISSION = _leaves("accepted", "rejected_rate_limited", "rejected_queue_full", "completed",
                     "failed", "cancelled_before_batch", "cancelled_mid_batch", "timed_out")
_HIST = _leaves("bucket_upper_ms", "counts", "n", "p50_ms", "p99_ms", "p999_ms")
_BY_FRONTIER = _leaves("f32", "packed")
SUMMARY_KEYS = {
    **_leaves("n_queries", "wall_s", "queries_per_sec", "p50_latency_s", "p95_latency_s",
              "plan_cache_hit_rate", "total_broadcast_symbols", "total_unicast_symbols",
              "stats_epoch"),
    "strategies": {},
    "exec_cache": _leaves("size", "graphs", "hits", "misses", "hit_rate", "builds", "releases"),
    "plan_store": _leaves("size", "hits", "misses", "hit_rate", "evictions"),
    "plan_pad_waste": {**_leaves("useful_steps", "padded_steps", "pad_waste_ratio"),
                       "bucket_grid_steps": {}},
    "frontier_mem": {
        "executors": _BY_FRONTIER, "frontier_bytes": _BY_FRONTIER, "lane_capacity": _BY_FRONTIER,
        "bytes_per_lane": _BY_FRONTIER, "staging_chunks": None,
        "tile_store": {"bytes_by_dtype": _leaves("f32", "uint32"),
                       **_leaves("slabs_resident", "slabs_spilled", "spills", "reloads")},
    },
    "aio": {
        "queue_depth": _leaves("latency", "throughput"),
        "admission": {"latency": _ADMISSION, "throughput": _ADMISSION},
        "batch_window": _leaves("flushes", "lanes_flushed", "fill_ratio", "deadline_flushes",
                                "fill_flushes", "window_s_p50"),
        "latency_hist": {"latency": _HIST, "throughput": _HIST},
    },
    "plan_cache": _leaves("size", "hits", "misses", "hit_rate"),
    "calibration": {**_leaves("n_observations", "n_label_classes"), "factors": {}},
}

# kernel name -> what drives and describes it; "lanes" marks the packed
# kernels, whose frontier is int32 lane words; "symbol" holds the pieces
# of the kernel's device symbol that the trace phase looks it up by, which
# together match its symbol only (B1 and B2 are instantiations of one
# body, as are B3 and B4; B5 is B1's body on another schedule)
KERNELS = {
    "fused_level_blocks": {
        "wrapper": fkernel.fused_level_blocks, "plain": fkernel.fused_level_blocks_plain,
        "tile_dtype": "f32", "lanes": False, "backend": "frontier_kernel",
        "source": f"{CSRC}/fused_level.cu", "replaces": f"{FRONTIER_PY}:209",
        "symbol": ("f32_chunk_kernel<", "LevelSchedule", "AddF32"),
    },
    "fused_level_blocks_u32": {
        "wrapper": fkernel.fused_level_blocks, "plain": fkernel.fused_level_blocks_plain,
        "tile_dtype": "uint32", "lanes": False, "backend": "frontier_kernel",
        "source": f"{CSRC}/fused_level.cu", "replaces": f"{FRONTIER_PY}:188",
        "symbol": ("bitplane_level_kernel<", "AddF32"),
    },
    "packed_level_blocks": {
        "wrapper": fkernel.packed_level_blocks, "plain": fkernel.packed_level_blocks_plain,
        "tile_dtype": "f32", "lanes": True, "backend": "frontier_kernel_packed",
        "source": f"{CSRC}/fused_level.cu", "replaces": f"{FRONTIER_PY}:337",
        "symbol": ("f32_chunk_kernel<", "LevelSchedule", "OrLanes"),
    },
    "packed_level_blocks_u32": {
        "wrapper": fkernel.packed_level_blocks, "plain": fkernel.packed_level_blocks_plain,
        "tile_dtype": "uint32", "lanes": True, "backend": "frontier_kernel_packed",
        "source": f"{CSRC}/fused_level.cu", "replaces": f"{FRONTIER_PY}:311",
        "symbol": ("bitplane_level_kernel<", "OrLanes"),
    },
}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def sparse_label_graph() -> LabeledGraph:
    """45 nodes, 200 edges over labels l0, l1, l3 — label l2 has no edges,
    so a plan over it meets an empty label store (the graph of
    ``tests/test_frontier_fused.py``)."""
    rng = np.random.default_rng(5)
    src = rng.integers(0, 45, 200).astype(np.int32)
    dst = rng.integers(0, 45, 200).astype(np.int32)
    lbl = rng.choice([0, 1, 3], 200).astype(np.int32)
    return LabeledGraph(45, src, lbl, dst, ["l0", "l1", "l2", "l3"])


def level_args(plan, frontier):
    """The positional arguments of one level on ``plan``."""
    return (
        frontier, plan.tiles, plan.firsts, plan.valids, plan.tile_ids,
        plan.f_rows, plan.f_cols, plan.o_rows, plan.o_cols,
        plan.block_size, plan.q_pad,
    )


def level_kw(plan) -> dict:
    """The keywords of one kernel level on ``plan``: run_ptr and the work
    list, which B1-B4 all walk."""
    return {"n_out_rows": plan.n_states * plan.q_pad, "run_ptr": plan.run_ptr, "work": plan.work}


SCHEDULE = ("firsts", "valids", "tile_ids", "f_rows", "f_cols", "o_rows", "o_cols")


def with_cover_steps(staged, plan):
    """``plan`` with a cover step (valids 0, tile 0) after every second
    valid step of each run, carried in through ``interop.plan_from_numpy``,
    which derives run_ptr and the work list anew."""
    cols = {k: getattr(plan, k).cpu().numpy() for k in SCHEDULE}
    ptr = plan.run_ptr.cpu().numpy()
    keep = []
    for lo, hi in zip(ptr[:-1], ptr[1:]):
        for n, i in enumerate(range(lo, hi)):
            keep.append(i)
            if n % 2 == 1 and i + 1 < hi and cols["valids"][i]:
                keep.append(-1 - i)  # a cover step in the output block of step i
    idx = np.array(keep)
    arrays = {k: a[np.where(idx >= 0, idx, -1 - idx)].copy() for k, a in cols.items()}
    for k in ("firsts", "valids", "tile_ids", "f_rows", "f_cols"):
        arrays[k][idx < 0] = 0
    return interop.plan_from_numpy(staged, plan.n_states, *(arrays[k] for k in SCHEDULE),
                                   plan.union_members)


def runs_of(plan) -> np.ndarray:
    """The valid steps of each output block's run."""
    return np.add.reduceat(plan.valids.cpu().numpy(), plan.run_ptr.cpu().numpy()[:-1])


def random_frontier(plan, gen, lanes: bool) -> torch.Tensor:
    """A seeded frontier with its union rows, padded columns empty: {0,1}
    f32 rows, or int32 lane words over all 32 bits."""
    shape = ((plan.n_states + len(plan.union_members)) * plan.q_pad, plan.v_pad)
    dev = plan.tiles.device
    if lanes:
        f = torch.randint(0, 2**32, shape, generator=gen, device=dev, dtype=torch.int64)
        f = f.to(torch.int32)  # wraps: bit 31 becomes the sign bit
    else:
        f = (torch.rand(shape, generator=gen, device=dev) < 0.3).float()
    f[:, plan.n_nodes :] = 0
    return f


def level_bound(plan, lanes: bool) -> tuple[float, str, int, int]:
    """The least time one level could take on the card: each distinct
    real tile (B·B·4 bytes f32, B·⌈B/32⌉·4 bit-planes), each distinct
    frontier block and the schedule read once, the output written once
    (bytes), against 2·8·B² operations per valid step, f32 FMAs for the
    fused kernels and int32 AND/OR for the packed ones; returns (ms, the
    binding resource, bytes, operations)."""
    valids = plan.valids.cpu().numpy().astype(bool)
    tids = plan.tile_ids.cpu().numpy()[valids]
    fblocks = set(zip(plan.f_rows.cpu().numpy()[valids].tolist(), plan.f_cols.cpu().numpy()[valids].tolist()))
    b = plan.block_size
    tile_bytes = b * (tile_words(b) if plan.tile_dtype == "uint32" else b) * 4
    n_steps = int(plan.valids.shape[0])
    nbytes = (
        len(set(tids.tolist())) * tile_bytes
        + len(fblocks) * plan.q_pad * b * 4
        + plan.n_states * plan.q_pad * plan.v_pad * 4
        + (6 * n_steps + plan.run_ptr.shape[0]) * 4
    )
    ops = 2 * plan.q_pad * b * b * int(valids.sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / (INT32_OPS if lanes else FP32_FLOPS)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def graph_ms(fn, iters: int, flush: torch.Tensor | None) -> float:
    """Device ms of ``fn`` per call: ``iters`` calls captured in one CUDA
    graph and replayed, so host launch overhead is not timed.  With
    ``flush``, each call is preceded by a 64 MB write that evicts the L2
    cache, and the time of the flushes alone is subtracted."""

    def replay_ms(body) -> float:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm-up outside the capture
            body()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                body()
        g.replay()
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        g.replay()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / iters

    if flush is None:
        return replay_ms(fn)

    def flushed():
        flush.zero_()
        fn()

    return replay_ms(flushed) - replay_ms(flush.zero_)


def events_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Mean ms of ``fn`` between CUDA events, L2 flushed before each call,
    with the host's launch work and syncs inside the window: the one
    footing on which the plain version, whose nonzero() syncs rule out a
    graph, and the kernel compare."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        total += t0.elapsed_time(t1)
    return total / iters


def device_trace(fn) -> dict:
    """``fn()`` traced with ``torch.profiler``: the traced wall ms, device
    busy ms (the union of the device events' intervals) and each device
    kernel's count and µs, the costliest first.  The device records are
    read from the profiler's raw results: ``prof.events()`` would build a
    Python event tree of every host and device record first, seconds for
    the ~10^4 launches of a query's level loop."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    spans, per_kernel = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        lo, hi = e.start_ns() / 1e3, e.end_ns() / 1e3
        spans.append((lo, hi))
        k = per_kernel.setdefault(e.name(), {"count": 0, "us": 0.0})
        k["count"] += 1
        k["us"] += hi - lo
    if not spans:
        raise AssertionError("the trace holds no device event")
    busy_us, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    return {"traced_ms": traced_ms, "device_busy_ms": busy_us / 1e3,
            "kernels": dict(sorted(per_kernel.items(), key=lambda kv: -kv[1]["us"]))}


def kernel_share(tr: dict, pieces: tuple[str, ...]) -> dict:
    """The device ms, launches and share of all device time in trace
    ``tr`` of the kernels whose name holds any of ``pieces``."""
    hits = [kt for name, kt in tr["kernels"].items() if any(p in name for p in pieces)]
    total_us = sum(kt["us"] for kt in tr["kernels"].values())
    ms = sum(kt["us"] for kt in hits) / 1e3
    return {"ms": ms, "count": sum(kt["count"] for kt in hits), "share": ms * 1e3 / total_us,
            "device_ms": total_us / 1e3}


def check_captured_against_eager(placement, ca, starts, stores, dev) -> dict:
    """q1 on the four path kinds (f32 rows and lane words, each on the f32
    and the bit-plane store): the executor's fixpoints replayed from its
    CUDA graph, LEVELS_PER_CHECK levels a host check, against the eager
    loop of one level a check (``ops.EAGER``, ``LEVELS_PER_CHECK = 1``), bit
    for bit: answers, meters and BFS levels, and on the f32 store the
    witness plane too.  The captured executor runs twice: the first call
    captures (after one eager body), the second replays only.  Launches
    here are not the path's: the counts are set to 0 before each run."""
    k, out = fops.LEVELS_PER_CHECK, {}
    for name, kk in KERNELS.items():
        td = kk["tile_dtype"]
        for sem in ("pairs", "witness") if td == "f32" else ("pairs",):
            runs = []
            for eager, per_check, calls in ((True, 1, 1), (False, k, 2)):
                fops.EAGER, fops.LEVELS_PER_CHECK = eager, per_check
                try:
                    step = strategies.make_s2_step_fn(
                        ca, placement.graph.n_nodes, backend=kk["backend"], graph=placement.graph,
                        replication_factor=placement.replication_factor, tile_dtype=td, staged=stores[td],
                        device=dev, semantics=sem)
                    for _ in range(calls):
                        reset_launches()
                        fops.FIXPOINT_COUNTERS.clear()
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        res = strategies.s2_execute(placement, ca, starts, step_fn=step, semantics=sem)
                        torch.cuda.synchronize()
                        c = fops.FIXPOINT_COUNTERS
                        runs.append({"digest": run_digest(res), "levels": c["levels"], "bodies": c["bodies"],
                                     "host_syncs": c["host_syncs"], "replays": c["replays"],
                                     "captures": c["captures"], "launches": only_launched(name, "q1, " + sem),
                                     "wall_ms": (time.perf_counter() - t0) * 1e3})
                        del res
                    step.release()
                finally:
                    fops.EAGER, fops.LEVELS_PER_CHECK = False, k
            eager, first, second = runs
            if not eager["digest"] == first["digest"] == second["digest"]:
                raise AssertionError(f"{name} q1 {sem}: the captured replay differs from the eager loop")
            if not eager["levels"] == first["levels"] == second["levels"] == eager["launches"] > 0:
                raise AssertionError(f"{name} q1 {sem}: BFS levels {eager['levels']} eager, "
                                     f"{first['levels']} and {second['levels']} captured")
            if (first["captures"], second["captures"], second["replays"]) != (1, 0, second["bodies"]) \
                    or any(r["launches"] != r["bodies"] * k for r in (first, second)):
                raise AssertionError(f"{name} q1 {sem}: captures, replays or launches off: {first} {second}")
            out[f"{name}/{sem}"] = {"eager": eager, "captured_first": first, "captured": second}
            log("path", f"{name} q1 {sem}: captured replay == the eager one-level loop bit for bit (answers, "
                f"meters{', witness plane' if sem == 'witness' else ''}), {eager['levels']} BFS levels both; "
                f"host syncs {eager['host_syncs']} eager, {second['host_syncs']} captured; launches "
                f"{eager['launches']} eager, {second['launches']} captured ({second['bodies']} bodies of {k}); "
                f"{eager['wall_ms']:.1f} ms eager, {first['wall_ms']:.1f} ms capturing, {second['wall_ms']:.1f} "
                "ms replaying")
    return out


def trace_query(placement, ca, starts, staged, dev, backend: str, symbol: tuple[str, ...]) -> dict:
    """One query's per-call set-up timed apart from its first run (which
    captures the executor's CUDA graph) and a warm run, and a third run
    traced with ``torch.profiler``: device busy time (the union of the
    device events' intervals), its share of the traced wall time, the
    device time and count of each kernel, and those of the path's level
    kernel, found by the pieces of its device symbol (``symbol``), which
    must match exactly one kernel name, and of every fill kernel (the
    level kernels' zeroed outputs among them)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = strategies.make_s2_step_fn(
        ca, placement.graph.n_nodes, backend=backend, graph=placement.graph,
        replication_factor=placement.replication_factor, tile_dtype=staged.tile_dtype,
        staged=staged, device=dev,
    )
    torch.cuda.synchronize()
    setup_ms = (time.perf_counter() - t0) * 1e3
    run_ms = []
    for _ in range(2):  # the first run captures the executor's graph, the second replays it only
        t0 = time.perf_counter()
        strategies.s2_execute(placement, ca, starts, step_fn=step)
        torch.cuda.synchronize()
        run_ms.append((time.perf_counter() - t0) * 1e3)
    first_run_ms, run_ms = run_ms
    tr = device_trace(lambda: strategies.s2_execute(placement, ca, starts, step_fn=step))
    per_kernel, traced_ms, busy_us = tr["kernels"], tr["traced_ms"], tr["device_busy_ms"] * 1e3

    def total(match) -> dict:
        hits = [kt for name, kt in per_kernel.items() if match(name)]
        return {"ms": sum(kt["us"] for kt in hits) / 1e3, "count": sum(kt["count"] for kt in hits)}

    names = [name for name in per_kernel if all(piece in name for piece in symbol)]
    if len(names) != 1:
        raise AssertionError(f"the pieces {symbol} match {len(names)} kernel names: {names}")
    return {
        "level_kernel": {**total(lambda name: name == names[0]), "name": names[0]},
        "fills": total(lambda name: "FillFunctor" in name),
        "setup_ms": setup_ms, "first_run_ms": first_run_ms, "run_ms": run_ms, "traced_ms": traced_ms,
        "device_busy_ms": busy_us / 1e3,
        "idle_share": 1.0 - busy_us / 1e3 / traced_ms,
        "idle_share_of_untraced_run": 1.0 - busy_us / 1e3 / run_ms,
        "kernels": per_kernel,
    }


def check_kernels(stores, cas, dev, gen) -> dict[str, float]:
    """Each kernel against its plain version on cases a to d; returns
    each kernel's max |kernel − plain| (0 when equal, else it raises)."""
    case_b_graph = sparse_label_graph()
    case_c_graph = random_labeled_graph(300, 500, 3, seed=11)
    small = {
        "b: block 16, empty store, wildcard, inverse": (
            case_b_graph, "(l0|l2)+ .^-1 l3^-1", 16),
        "c: cover-only output blocks": (case_c_graph, "l0 l1", 32),
    }
    max_err = dict.fromkeys(KERNELS, 0.0)
    for name, k in KERNELS.items():
        td = k["tile_dtype"]
        cases = {"a: q1, full scale": fops.build_level_schedule(cas["q1"], stores[td])}
        for label, (g, expr, block) in small.items():
            staged = fops.stage_graph(g, block, tile_dtype=td, device=dev)
            cases[label] = fops.build_level_schedule(paa.compile_query(expr, g), staged)
        cases["d: q1 with cover steps inside its runs"] = with_cover_steps(
            stores[td], cases["a: q1, full scale"])
        for label, plan in cases.items():
            valids = plan.valids.cpu().numpy()
            runs = runs_of(plan)
            f = random_frontier(plan, gen, k["lanes"])
            n_out = plan.n_states * plan.q_pad
            got = k["wrapper"](*level_args(plan, f), **level_kw(plan))
            want = k["plain"](*level_args(plan, f), n_out_rows=n_out)
            torch.cuda.synchronize()
            err = float((got.double() - want.double()).abs().max())
            max_err[name] = max(max_err[name], err)
            if got.dtype != want.dtype or not torch.equal(got, want):
                raise AssertionError(f"{name} != plain on case {label}: max |diff| {err}")
            log("kernels", f"{name} == plain on case {label}: {plan.n_states} states, "
                f"B={plan.block_size}, {td} tiles, {len(valids)} steps ({int(valids.sum())} with a "
                f"tile), {int((runs == 0).sum())} of {len(runs)} output blocks cover-only, longest "
                f"run {int(runs.max())} valid steps, work list {plan.work.shape[0]} chunks of <= "
                f"{plan.work.shape[1]}")
        if not (runs_of(cases["c: cover-only output blocks"]) == 0).any():
            raise AssertionError("case c has no cover-only output block")
        d = cases["d: q1 with cover steps inside its runs"]
        runs, steps = runs_of(d), np.diff(d.run_ptr.cpu().numpy())
        if not ((runs > 2 * fops.WORK_CHUNK) & (steps > runs)).any():
            raise AssertionError("case d has no run of more than two chunks with cover steps inside")
    return max_err


def time_levels(stores, cas, gen, flush) -> dict:
    """One level of each query's plan, for each kernel: CUDA graph with L2
    flushed and warm, one call between events, the plain version between
    events, and the bound."""
    times: dict = {}
    for q in QUERIES:
        plans = {td: fops.build_level_schedule(cas[q], s) for td, s in stores.items()}
        for name, k in KERNELS.items():
            plan = plans[k["tile_dtype"]]
            f = random_frontier(plan, gen, k["lanes"])
            kw = level_kw(plan)

            def kernel_level(k=k, plan=plan, f=f, kw=kw):
                return k["wrapper"](*level_args(plan, f), **kw)

            def plain_level(k=k, plan=plan, f=f):
                return k["plain"](*level_args(plan, f), n_out_rows=plan.n_states * plan.q_pad)

            bound_ms, bound_by, nbytes, ops = level_bound(plan, k["lanes"])
            t = times.setdefault(name, {})[q] = {
                "ms": graph_ms(kernel_level, 50, flush),
                "warm_ms": graph_ms(kernel_level, 50, None),
                "events_ms": events_ms(kernel_level, 20, flush),
                "plain_ms": events_ms(plain_level, 10, flush),
                "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "ops": ops,
            }
            if not torch.equal(kernel_level(), plain_level()):
                raise AssertionError(f"{name} != plain at the timed {q} level")
            t["chunks"], t["longest_run"] = int(plan.work.shape[0]), int(runs_of(plan).max())
            shape = (plan.n_states * plan.q_pad, plan.v_pad)
            def fill(shape=shape, f=f):
                return torch.zeros(shape, dtype=f.dtype, device=f.device)

            t["fill_ms"] = graph_ms(fill, 50, flush)
            log("kernels", f"{name} {q} level == plain; {t['chunks']} chunks of <= "
                f"{plan.work.shape[1]} = CTAs, longest run {t['longest_run']} valid steps; the "
                f"output's zero fill alone {t['fill_ms'] * 1e3:.2f} us (L2 flushed), inside the "
                "kernel times below")
            log("kernels", f"{name} {q} level: kernel {t['ms'] * 1e3:.2f} us (L2 flushed; "
                f"{t['warm_ms'] * 1e3:.2f} us warm; {t['events_ms'] * 1e3:.2f} us one call between "
                f"events), plain {t['plain_ms'] * 1e3:.2f} us between events, bound "
                f"{bound_ms * 1e3:.2f} us by {bound_by} ({nbytes / 1e6:.2f} MB, {ops / 1e6:.1f} M ops)")
    return times


# B7's entries: the whole kernel, and its split and combine kernels apart
# (the sequence-sharded decode); the JSON line counts all three as B7's
B7_ENTRIES = ("flash_decode_gqa", "flash_decode_gqa_partials", "flash_decode_combine")


def launch_counts() -> dict[str, int]:
    """Every kernel's launches so far, by the name the JSON line uses, and
    B7's two separate entries by theirs."""
    return {**fkernel.launch_counts(), "embedding_bag_sorted": embedbag.LAUNCHES,
            "flash_decode_gqa": decode_attn.LAUNCHES,
            "flash_decode_gqa_partials": decode_attn.PARTIAL_LAUNCHES,
            "flash_decode_combine": decode_attn.COMBINE_LAUNCHES}


def reset_launches() -> None:
    fkernel.reset_launches()
    embedbag.LAUNCHES = decode_attn.LAUNCHES = 0
    decode_attn.PARTIAL_LAUNCHES = decode_attn.COMBINE_LAUNCHES = 0


def launched(names: tuple[str, ...], what: str) -> dict[str, int]:
    """The launches of kernel entries ``names`` since the last reset;
    raises if one launched none or another kernel launched."""
    counts = launch_counts()
    for name in names:
        if counts[name] == 0:
            raise AssertionError(f"{what} launched no {name} kernel")
    if sum(counts.values()) != sum(counts[name] for name in names):
        raise AssertionError(f"{what} launched other kernels: {counts}")
    return {name: counts[name] for name in names}


def only_launched(name: str, what: str) -> int:
    """The launches of kernel ``name`` since the last reset; raises if it
    launched none or another kernel launched."""
    return launched((name,), what)[name]


def loop_launches(buckets: int = 1) -> int:
    """The level kernel's launches that the one-card fixpoints made since
    the counters' reset: each body of LEVELS_PER_CHECK levels (the eager
    first one and every graph replay) launches each level's kernel once
    per shape bucket, on an empty frontier after convergence too."""
    return fops.FIXPOINT_COUNTERS["bodies"] * fops.LEVELS_PER_CHECK * buckets


def check_loop_launches(n: int, what: str, buckets: int = 1) -> None:
    """``n`` level-kernel launches since the counters' reset, each held
    exactly: launches = bodies x LEVELS_PER_CHECK x buckets, one host sync
    a body, and the BFS levels (the device counter) within the bodies'
    levels and past all but each fixpoint's last body."""
    c, k = fops.FIXPOINT_COUNTERS, fops.LEVELS_PER_CHECK
    if n != loop_launches(buckets) or c["host_syncs"] != c["bodies"] or not (
            0 < c["levels"] and (c["bodies"] - c["fixpoints"]) * k <= c["levels"] <= c["bodies"] * k):
        raise AssertionError(f"{what}: {n} launches for {c['bodies']} bodies of {k} levels x {buckets} "
                             f"bucket(s), {c['levels']} BFS levels in {c['fixpoints']} fixpoints, "
                             f"{c['host_syncs']} host syncs")


def free() -> None:
    """Return the card's cached blocks after the caller dropped its
    tensors (``del``), so the next phase starts from a clean pool."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def timed(fn, graph_iters: int, event_iters: int, flush) -> dict:
    """A kernel wrapper's times, as for the level kernels: a CUDA graph
    with L2 flushed, the same warm, and one call between events."""
    return {"ms": graph_ms(fn, graph_iters, flush), "warm_ms": graph_ms(fn, graph_iters, None),
            "events_ms": events_ms(fn, event_iters, flush)}


def bound(nbytes: float, ops: float, rate: float) -> tuple[float, str]:
    """(ms, binding resource): the larger of bytes over HBM bandwidth and
    operations over ``rate``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def step_level(ca, bg, f: torch.Tensor):
    """The B5 launches of one baseline level on frontier ``f`` (n_states,
    v_pad): for each (transition, store), the path's own operand
    (``ops.expand_operand`` of the source state's row) and the store."""
    return [(fops.expand_operand(f[t.src]), entry) for t, entry in fops.baseline_entries(ca, bg)]


def check_step_calls(calls, block: int, q: str) -> float:
    """B5 against its plain version, ``torch.equal``, on each launch of a
    baseline level at the path's own operands; returns max |diff|."""
    max_err = 0.0
    for i, (rows, (tiles, r, c, w)) in enumerate(calls):
        got = fkernel.frontier_step_blocks(rows, tiles, r, c, block, work=w)
        want = fkernel.frontier_step_blocks_plain(rows, tiles, r, c, block)
        max_err = max(max_err, float((got - want).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"{q} level, launch {i}: frontier_step_blocks != plain")
    return max_err


def step_bound(calls, block: int) -> tuple[float, str, int, int]:
    """The least time of a level's B5 launches: each distinct store's
    tiles and index arrays read once, each launch's distinct frontier
    blocks read and its output written once (bytes), against 2·8·B²
    f32 FMAs per tile per launch (operations)."""
    stores = {id(e[0]): e for _, e in calls}
    nbytes = sum(sum(a.numel() * a.element_size() for a in e) for e in stores.values())
    ops = 0
    for rows, (tiles, r, _, _) in calls:
        nbytes += len(set(r.tolist())) * 8 * block * 4 + rows.numel() * 4
        ops += 2 * 8 * block * block * tiles.shape[0]
    return (*bound(nbytes, ops, FP32_FLOPS), nbytes, ops)


def check_step_kernel(bg, cas, dev, gen) -> float:
    """B5 against its plain version, ``torch.equal``, on every store of
    cases a, b and c rebuilt as per-label tile lists; returns max |diff|."""
    case_b = (sparse_label_graph(), "(l0|l2)+ .^-1 l3^-1", 16)
    case_c = (random_labeled_graph(300, 500, 3, seed=11), "l0 l1", 32)
    cases = {"a: q1, full scale, 16 rows": (bg, cas["q1"], 16)}
    for label, (graph, expr, block) in (("b: block 16, empty store, wildcard, inverse", case_b),
                                        ("c: the level kernels' cover-only case", case_c)):
        cases[label] = (fops.make_blocked_graph(graph, block, device=dev),
                        paa.compile_query(expr, graph), 8)
    max_err, all_unvisited = 0.0, 0
    for label, (b_g, ca, m_pad) in cases.items():
        stores = {id(e[0]): e for _, e in fops.baseline_entries(ca, b_g)}
        unvisited, longest = 0, 0
        for tiles, rows, cols, work in stores.values():
            f = (torch.rand((m_pad, b_g.v_pad), generator=gen, device=dev) < 0.3).float()
            f[:, b_g.n_nodes :] = 0
            got = fkernel.frontier_step_blocks(f, tiles, rows, cols, b_g.block_size, work=work)
            want = fkernel.frontier_step_blocks_plain(f, tiles, rows, cols, b_g.block_size)
            torch.cuda.synchronize()
            max_err = max(max_err, float((got - want).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(f"frontier_step_blocks != plain on case {label}")
            runs = np.diff(fops.column_runs(cols.cpu().numpy()))
            unvisited += b_g.v_pad // b_g.block_size - len(runs)
            longest = max(longest, int(runs.max()))
        n_tiles = sum(e[0].shape[0] for e in stores.values())
        log("baseline", f"frontier_step_blocks == plain on case {label}: {len(stores)} stores, "
            f"{n_tiles} tiles, B={b_g.block_size}, {m_pad} frontier rows, longest column run "
            f"{longest} tiles, {unvisited} column blocks unvisited (zero in both)")
        all_unvisited += unvisited
    if all_unvisited == 0:
        raise AssertionError("no case has an unvisited column block")
    return max_err


def phase_baseline(g, cas, dg, stores, dev, gen, flush, record) -> dict:
    """The per-transition baseline path (B5) on the full twin: its
    answers against the fused path (B1) on the same BlockedGraph and the
    device BFS, its launch count, and its times."""
    t0 = time.perf_counter()
    bg = fops.make_blocked_graph(g, block_size=128, device=dev)
    torch.cuda.synchronize()
    n_tiles = sum(e[0].shape[0] for st in (bg.fwd, bg.inv) for e in st.values())
    log("baseline", f"make_blocked_graph: {len(bg.fwd)} labels x 2 directions, {n_tiles} tiles, "
        f"{n_tiles * 128 * 128 * 4 / 1e9:.4f} GB ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    staged = fops.stage_graph(bg)
    torch.cuda.synchronize()
    same = torch.equal(staged.tiles, stores["f32"].tiles) and list(staged.offsets) == list(
        stores["f32"].offsets) and all(
        (a[0], a[1].tobytes(), a[2].tobytes()) == (b[0], b[1].tobytes(), b[2].tobytes())
        for a, b in zip(staged.offsets.values(), stores["f32"].offsets.values()))
    if not same:
        raise AssertionError("Stage A from the BlockedGraph differs from Stage A from the graph")
    log("baseline", f"stage_graph(BlockedGraph): {staged.tiles.shape[0]} tiles, equal to the "
        f"graph's f32 store byte for byte ({time.perf_counter() - t0:.1f} s)")
    rec = record["baseline"] = {"tiles": n_tiles}
    max_err = check_step_kernel(bg, cas, dev, gen)

    rng = np.random.default_rng(SEED + 1)
    launches, calls = 0, {}
    for q in QUERIES:
        ca = cas[q]
        starts = paa.valid_start_nodes(ca, g)
        sample = np.sort(rng.choice(starts, size=min(N_BASELINE_STARTS, len(starts)), replace=False))
        o_src, o_dst = paa.answers_multi_source(ca, dg, sample)
        plan = fops.build_level_plan(ca, staged)
        entries = len(list(fops.baseline_entries(ca, bg)))
        reset_launches()
        fops.FIXPOINT_COUNTERS.clear()
        answers, t_base = [], 0.0
        for s in sample:
            mask = np.zeros(g.n_nodes, np.float32)
            mask[s] = 1.0
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            answers.append(fops.multi_source_reach_baseline(ca, bg, mask))
            t_base += time.perf_counter() - t1
        n = only_launched("frontier_step_blocks", f"the baseline path on {q}")
        levels = fops.FIXPOINT_COUNTERS["levels"]
        if n != levels * entries:
            raise AssertionError(f"{q}: {n} B5 launches for {levels} levels x {entries} entries")
        launches += n
        t_fused = 0.0
        for s, got in zip(sample, answers):
            mask = np.zeros(g.n_nodes, np.float32)
            mask[s] = 1.0
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fused = fops.multi_source_reach(ca, staged, mask, plan=plan)
            t_fused += time.perf_counter() - t1
            want = np.zeros(g.n_nodes, bool)
            want[o_dst[o_src == s]] = True
            if not (np.array_equal(got, fused) and np.array_equal(got, want)):
                raise AssertionError(f"{q} start {s}: baseline, fused and device BFS answers differ")
        f = (torch.rand((ca.n_states, bg.v_pad), generator=gen, device=dev) < 0.3).float()
        f[:, g.n_nodes :] = 0
        f8 = torch.zeros((ca.n_states, plan.q_pad, plan.v_pad), device=dev)
        f8[:, 0] = f
        f8 = f8.reshape(-1, plan.v_pad)
        calls[q] = step_level(ca, bg, f)
        max_err = max(max_err, check_step_calls(calls[q], bg.block_size, q))
        r = rec[q] = {
            "starts": len(sample), "levels": levels, "entries": entries, "launches": n,
            "pairs": int(len(o_src)), "baseline_wall_ms": t_base * 1e3, "fused_wall_ms": t_fused * 1e3,
            "expand_level_ms": events_ms(lambda: fops.expand_level(ca, bg, f), 5, flush),
            "expand_level_fused_ms": events_ms(lambda: fops.expand_level_fused(plan, f8), 20, flush),
        }
        log("baseline", f"{q}: {len(sample)} starts, {r['pairs']} answer pairs; {levels} levels x "
            f"{entries} (transition, store) entries = {n} B5 launches, no other kernel; answers == "
            f"fused (B1, same BlockedGraph) == device BFS; {r['baseline_wall_ms']:.1f} ms baseline, "
            f"{r['fused_wall_ms']:.1f} ms fused; one level: expand_level {r['expand_level_ms']:.3f} ms "
            f"({entries} launches), expand_level_fused {r['expand_level_fused_ms']:.3f} ms (1 launch); "
            f"its {entries} B5 launches at the path's operands == plain")

    q1 = calls["q1"]
    rec["q1_launches"] = [
        {"tiles": int(tiles.shape[0]), "chunks": int(work.shape[0]),
         "longest_run": int(np.diff(fops.column_runs(cols.cpu().numpy())).max())}
        for _, (tiles, _, cols, work) in q1
    ]
    log("baseline", "B5, the q1 level's launches as (tiles, chunks = CTAs, longest column run): "
        + ", ".join(f"({x['tiles']}, {x['chunks']}, {x['longest_run']})" for x in rec["q1_launches"]))

    def kernel_level():
        for rows, (tiles, r_, c_, w) in q1:
            fkernel.frontier_step_blocks(rows, tiles, r_, c_, bg.block_size, work=w)

    def plain_level():
        for rows, (tiles, r_, c_, _) in q1:
            fkernel.frontier_step_blocks_plain(rows, tiles, r_, c_, bg.block_size)

    def fills():
        for rows, _ in q1:
            torch.zeros_like(rows)

    t = rec["q1_level"] = timed(kernel_level, 20, 10, flush)
    t["plain_ms"] = events_ms(plain_level, 5, flush)
    t["fill_ms"] = graph_ms(fills, 20, flush)
    t["bound_ms"], t["bound_by"], nbytes, ops = step_bound(q1, bg.block_size)
    log("baseline", f"B5, the {len(q1)} launches of one q1 level: {t['ms'] * 1e3:.2f} us (L2 "
        f"flushed; {t['warm_ms'] * 1e3:.2f} us warm; {t['events_ms'] * 1e3:.2f} us one call between "
        f"events), plain {t['plain_ms'] * 1e3:.2f} us, bound {t['bound_ms'] * 1e3:.2f} us by "
        f"{t['bound_by']} ({nbytes / 1e6:.2f} MB, {ops / 1e6:.1f} M ops); the {len(q1)} outputs' "
        f"zero fills alone {t['fill_ms'] * 1e3:.2f} us (L2 flushed), inside the kernel times")
    return {"name": "frontier_step_blocks", "route": "cuda", "source": f"{CSRC}/fused_level.cu",
            "replaces": f"{FRONTIER_PY}:121", "launches": launches, "max_abs_err": max_err,
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None}


def plan_query_phase(q, g, placement, net, model, arrays, dg, staged, dev, rng) -> dict:
    """One Table-2 query through the planner, then on the same sampled
    starts through S1 (gather, dedup and device BFS timed apart, then
    ``s1_execute``) and through S2 on B1 under the query class's fast
    path; raises on any failed check."""
    expr = TABLE2_QUERIES[q]
    t0 = time.perf_counter()
    est = planner.estimate_query(expr, g, model=model, n_rollouts=PLAN_ROLLOUTS, seed=PLAN_SEED)
    plan = planner.decide_strategy(est, net)
    plan_ms = (time.perf_counter() - t0) * 1e3
    c, qc = plan.choice, est.query_class
    r = {"strategy": c.strategy, "reason": c.reason, "discr": c.discr, "k_over_d": c.k_over_d,
         "p_s2_optimal": plan.p_s2_optimal, "q_bc_p50_p90": [plan.q_bc_quantiles[x] for x in (0.5, 0.9)],
         "d_s2_p50_p90": [plan.d_s2_quantiles[x] for x in (0.5, 0.9)],
         "forecast": plan.forecast_symbols, "plan_ms": plan_ms, "query_class": [qc.kind, qc.length]}
    log("plan", f"{q}: {c.strategy} ({c.reason}); discr {c.discr:.6g}, k/d {c.k_over_d:.6g}, "
        f"p_s2_optimal {plan.p_s2_optimal:.4f}; Q_bc p50/p90 {r['q_bc_p50_p90']}, D_s2 p50/p90 "
        f"{r['d_s2_p50_p90']}; forecast S1 {plan.forecast_symbols['S1']:.1f}, S2 "
        f"{plan.forecast_symbols['S2']:.1f} symbols; class {qc.kind} (length {qc.length}); "
        f"{plan_ms:.1f} ms on the host ({PLAN_ROLLOUTS} rollouts)")
    ca = paa.compile_query(expr, g)
    starts = paa.valid_start_nodes(ca, g)
    if len(starts) == 0:
        log("plan", f"{q}: no valid start; executed on neither strategy")
        return r
    sample = np.sort(rng.choice(starts, size=min(N_PLAN_STARTS, len(starts)), replace=False))
    o_src, o_dst = paa.answers_multi_source(ca, dg, sample)
    oracle = [set(o_dst[o_src == s].tolist()) for s in sample]

    # S1: the pieces of s1_execute timed apart, then s1_execute itself
    ast = rx.parse(expr)
    lmask = strategies.query_label_mask(ast, g)
    want_cost = strategies.s1_costs(ast, g)
    truth = g.dedup().subgraph_with_labels(set(np.nonzero(lmask)[0].tolist()))
    truth_edges = set(zip(truth.src.tolist(), truth.lbl.tolist(), truth.dst.tolist()))
    max_e = arrays["src"].shape[1]
    gather_ms, dedup_ms, bfs_ms, exec_ms = [], [], [], []
    bfs_levels = bfs_syncs = 0
    for s, want in zip(sample.tolist(), oracle):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        src, lbl, dst, valid, overflow = strategies.s1_gather(arrays, lmask, max_e)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sub = strategies.gathered_subgraph(g, src, lbl, dst, valid)
        t2 = time.perf_counter()
        lev0, sync0 = paa.BFS_COUNTERS["levels"], paa.BFS_COUNTERS["host_syncs"]
        acc = paa.answers_single_source(ca, paa.device_form(sub, dev), s).cpu().numpy()
        t3 = time.perf_counter()
        bfs_levels += paa.BFS_COUNTERS["levels"] - lev0
        bfs_syncs += paa.BFS_COUNTERS["host_syncs"] - sync0
        gather_ms.append((t1 - t0) * 1e3)
        dedup_ms.append((t2 - t1) * 1e3)
        bfs_ms.append((t3 - t2) * 1e3)
        gathered = int(valid.sum())
        if overflow or set(zip(sub.src.tolist(), sub.lbl.tolist(), sub.dst.tolist())) != truth_edges \
                or sub.n_edges != truth.n_edges or sub.n_edges != want_cost.edges_retrieved:
            raise AssertionError(f"{q}: S1's deduped subgraph ({sub.n_edges} edges, overflow {overflow}) "
                                 f"is not the graph's {truth.n_edges} edges of the query's labels")
        t0 = time.perf_counter()
        answers, cost = strategies.s1_execute(placement, ast, ca, s, device_arrays=arrays)
        exec_ms.append((time.perf_counter() - t0) * 1e3)
        if answers != want or set(np.nonzero(acc)[0].tolist()) != want:
            raise AssertionError(f"{q} start {s}: S1 answers differ from the device-BFS oracle")
        if cost != want_cost:
            raise AssertionError(f"{q}: S1 cost {cost} != s1_costs {want_cost}")
    r["s1"] = {"starts": len(sample), "gathered": gathered, "edges": sub.n_edges, "gather_ms": gather_ms,
               "dedup_ms": dedup_ms, "bfs_ms": bfs_ms, "execute_ms": exec_ms,
               "bfs_levels": bfs_levels, "bfs_host_syncs": bfs_syncs}
    log("plan", f"{q}: S1 on {len(sample)} starts: gather {np.median(gather_ms):.2f} ms (median; "
        f"{gathered} matching copies from {placement.n_sites} sites), dedup {np.median(dedup_ms):.2f} ms "
        f"(host, to {sub.n_edges} edges == the graph's edges of its labels == s1_costs), device form + "
        f"BFS {np.median(bfs_ms):.2f} ms ({r['s1']['bfs_levels']} levels, {r['s1']['bfs_host_syncs']} "
        f"host syncs over the starts); s1_execute {np.median(exec_ms):.2f} ms; answers == oracle")

    # S2 on B1, at the query class's fast path
    exec_ca, cap = planner.reduce_automaton(ca, qc), planner.fast_path_max_levels(qc)
    reset_launches()
    fops.FIXPOINT_COUNTERS.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc2, costs = strategies.s2_execute(
        placement, exec_ca, sample, max_levels=cap, backend="frontier_kernel", tile_dtype="f32",
        staged=staged, device=dev)
    torch.cuda.synchronize()
    s2_ms = (time.perf_counter() - t0) * 1e3
    n = only_launched("fused_level_blocks", f"the plan phase's S2 leg of {q}")
    levels = fops.FIXPOINT_COUNTERS["levels"]
    check_loop_launches(n, f"the plan phase's S2 leg of {q}")
    for i, want in enumerate(oracle):
        if set(np.nonzero(acc2[i])[0].tolist()) != want:
            raise AssertionError(f"{q} start {sample[i]}: S2 answers differ from the oracle and S1")
    obs_s1 = cost_model.cost_of(net, want_cost)
    obs_s2 = [cost_model.cost_of(net, c2) for c2 in costs]
    cheaper = "S1" if obs_s1 < np.mean(obs_s2) else "S2"
    r["s2"] = {"levels": levels, "launches": n, "bodies": fops.FIXPOINT_COUNTERS["bodies"],
               "host_syncs": fops.FIXPOINT_COUNTERS["host_syncs"], "max_levels": cap,
               "states": exec_ca.n_states, "wall_ms": s2_ms}
    r["observed_cost"] = {"S1": obs_s1, "S2_mean": float(np.mean(obs_s2)), "S2_max": max(obs_s2),
                          "cheaper": cheaper, "choice_matches": cheaper == c.strategy}
    log("plan", f"{q}: S2 (frontier_kernel/f32, {exec_ca.n_states} states, max_levels {cap}) on the "
        f"same starts: {levels} levels, {r['s2']['bodies']} bodies = {n} B1 launches, no other kernel, "
        f"{r['s2']['host_syncs']} host syncs, {s2_ms:.1f} ms; answers == "
        f"oracle == S1; observed cost_of S1 {obs_s1:.1f}, S2 mean {np.mean(obs_s2):.1f} (max "
        f"{max(obs_s2):.1f}) against the forecast S1 {plan.forecast_symbols['S1']:.1f}, S2 "
        f"{plan.forecast_symbols['S2']:.1f}: cheaper observed {cheaper}, plan chose {c.strategy}")
    return r


def phase_plan(g, placement, dg, staged, dev, record) -> None:
    """The §6 workflow on the full twin: probe a 256-peer overlay, fit the
    Bayesian model once, plan each Table-2 query, and run both strategies
    on the card for 8 sampled starts of each."""
    rec = record["plan"] = {}
    t0 = time.perf_counter()
    overlay = random_overlay(placement.n_sites, PLAN_DEGREE, seed=PLAN_SEED)
    net = planner.probe_network(overlay, placement, seed=PLAN_SEED)
    model = planner.fit_model(g)
    fit_s = time.perf_counter() - t0
    arrays = strategies.stage_site_arrays(placement, dev)
    nbytes = sum(a.numel() * a.element_size() for a in arrays.values())
    rec["net"] = {"n_peers": net.n_peers, "n_connections": net.n_connections,
                  "replication_rate": net.replication_rate, "probe_and_fit_s": fit_s,
                  "site_array_bytes": nbytes}
    log("plan", f"overlay {net.n_peers} peers, {net.n_connections} connections (d = "
        f"{net.mean_degree:.3f}), probed k = {net.replication_rate:.6f}; probes and the Bayesian fit "
        f"{fit_s:.1f} s on the host; padded site arrays {tuple(arrays['src'].shape)} staged once: "
        f"{nbytes / 1e6:.1f} MB")
    rng = np.random.default_rng(PLAN_SEED)
    for q in TABLE2_QUERIES:
        rec[q] = plan_query_phase(q, g, placement, net, model, arrays, dg, staged, dev, rng)
    matches = sum(r["observed_cost"]["choice_matches"] for r in rec.values() if "observed_cost" in r)
    ran = sum("observed_cost" in r for r in rec.values())
    log("plan", f"{len(TABLE2_QUERIES)} queries planned, {ran} run on both strategies; the plan's "
        f"choice is the cheaper observed one on {matches} of {ran} (an estimate: not checked)")
    del arrays


def complete_graph(n: int) -> LabeledGraph:
    """Every ordered pair of n nodes joined by an l0 edge: every tile of
    the store is full."""
    s, d = np.meshgrid(np.arange(n, dtype=np.int32), np.arange(n, dtype=np.int32), indexing="ij")
    return LabeledGraph(n, s.ravel(), np.zeros(n * n, np.int32), d.ravel(), ["l0"])


def check_counts_at_bound(dev) -> float:
    """B1 on a count frontier at the edge of its contract: the complete
    digraph of COUNT_NODES nodes at block 128 gives every output block a
    run of 8 full tiles (8 chunks, added by atomics in no fixed order);
    the frontier's first query row sums to exactly 2^24 - 1, which every
    output of that row then holds, the other rows below it.  Must be
    ``torch.equal`` to the plain version; returns max |diff| (0)."""
    g = complete_graph(COUNT_NODES)
    plan = fops.build_level_schedule(paa.compile_query("l0", g), fops.stage_graph(g, 128, device=dev))
    rng = np.random.default_rng(SEED)
    rows = (plan.n_states + len(plan.union_members)) * plan.q_pad
    f = np.zeros((rows, plan.v_pad), np.float32)
    f[: plan.q_pad, :COUNT_NODES] = rng.integers(0, 2**24 // COUNT_NODES, (plan.q_pad, COUNT_NODES))
    f[0, :COUNT_NODES] = rng.multinomial(2**24 - 1, np.full(COUNT_NODES, 1 / COUNT_NODES))
    f = torch.from_numpy(f).to(dev)
    got = fkernel.fused_level_blocks(*level_args(plan, f), **level_kw(plan))
    want = fkernel.fused_level_blocks_plain(*level_args(plan, f), n_out_rows=plan.n_states * plan.q_pad)
    torch.cuda.synchronize()
    err = float((got.double() - want.double()).abs().max())
    top = float(got.max())
    if not torch.equal(got, want) or top != 2**24 - 1:
        raise AssertionError(f"B1 on counts: max |diff| {err} from plain, largest sum {top}")
    runs = runs_of(plan)
    log("witness", f"B1 on counts == plain: complete digraph of {COUNT_NODES} nodes, B=128, "
        f"{int((runs > 0).sum())} runs of {int(runs.max())} full tiles in {plan.work.shape[0]} chunks "
        f"(CTAs); largest output sum {top:.0f} = 2^24 - 1")
    return err


def witness_run(placement, ca, starts, dev, **kw) -> tuple:
    """One ``s2_execute`` of ``starts`` with its wall ms, levels, the
    launches its bodies of LEVELS_PER_CHECK levels must make, and its
    launches."""
    lev0, body0, launch0 = fops.FIXPOINT_COUNTERS["levels"], fops.FIXPOINT_COUNTERS["bodies"], launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = strategies.s2_execute(placement, ca, starts, device=dev, **kw)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    launched = {k: counts[k] - launch0[k] for k in counts if counts[k] != launch0[k]}
    bodies = fops.FIXPOINT_COUNTERS["bodies"] - body0
    return out, wall_ms, fops.FIXPOINT_COUNTERS["levels"] - lev0, bodies * fops.LEVELS_PER_CHECK, launched


def witness_breakdown(placement, ca, starts, backend, staged, dev) -> dict[str, float]:
    """A witness run taken apart: the executor's set-up (Stage B, the
    meters' degree vectors), its run until the level plane is ready on
    the card, and that plane's copy to the host as ``s2_execute`` makes
    it (pageable memory) and into pinned memory."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = strategies.make_s2_step_fn(
        ca, placement.graph.n_nodes, backend=backend, graph=placement.graph,
        replication_factor=placement.replication_factor, staged=staged, device=dev,
        semantics="witness")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    levels = step(starts)[4]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    levels.cpu()
    t3 = time.perf_counter()
    pinned = torch.empty(levels.shape, dtype=levels.dtype, pin_memory=True)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    pinned.copy_(levels)
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    return {"setup_ms": (t1 - t0) * 1e3, "executor_ms": (t2 - t1) * 1e3, "copy_ms": (t3 - t2) * 1e3,
            "pinned_copy_ms": (t5 - t4) * 1e3}


def check_witness_levels(q, ca, g, index, starts, answers, levels, rng, what) -> int:
    """A witness run's levels: answers must be the pairs reached in an
    accepting state; 4 sampled starts with answers must have the host
    product BFS's levels; 8 sampled (start, answer) pairs must walk back
    to witnesses that pass the label-store check and the automaton
    re-match.  Returns the total witness length."""
    reached = np.zeros_like(answers)
    for qf in ca.accepting:
        reached |= witness.reached(levels[:, qf])
    if not np.array_equal(reached, answers):
        raise AssertionError(f"{what} {q}: the levels' accepting pairs differ from the answers")
    with_answers = np.nonzero(answers.any(axis=1))[0]
    for i in rng.choice(with_answers, size=min(4, len(with_answers)), replace=False):
        if not np.array_equal(levels[i], witness.host_levels(ca, index, int(starts[i]))):
            raise AssertionError(f"{what} {q} start {starts[i]}: levels differ from host_levels")
    bs, vs = np.nonzero(answers)
    length = 0
    for j in rng.choice(len(bs), size=min(N_WITNESSES, len(bs)), replace=False):
        s, t = int(starts[bs[j]]), int(vs[j])
        path = witness.reconstruct_path(ca, index, levels[bs[j]], s, t)
        ok, why = witness.validate_witness(path, g)
        if not ok or not witness.nfa_accepts_symbols(ca, path.steps) or path.nodes[0] != s \
                or path.nodes[-1] != t:
            raise AssertionError(f"{what} {q}: the witness {path} of ({s}, {t}) fails: {why}")
        length += len(path)
    return length


def phase_witness(g, placement, cas, truth, staged, dev, record) -> dict[str, int]:
    """Witness semantics and bounded counting on the full twin: every
    valid start of q1, q9 and q12 through ``s2_execute(semantics=
    "witness")`` on B1 and on B2 over the f32 store, beside the pairs run
    of the same executor; q1 again asking for the uint32 store without a
    Stage A, which must restage f32 and launch B1; ``count_paths_bounded``
    on q1 against the host DP; B1 on counts at 2^24 - 1.  Returns each
    level kernel's launches on the path."""
    rec = record["witness"] = {}
    index = paa.HostIndex(g)
    rng = np.random.default_rng(SEED + 2)
    launches, f32_levels = {}, {}
    for name in ("fused_level_blocks", "packed_level_blocks"):
        backend = KERNELS[name]["backend"]
        reset_launches()
        fops.FIXPOINT_COUNTERS.clear()
        for q in QUERIES:
            ca, t = cas[q], truth[q]
            kw = {"backend": backend, "tile_dtype": "f32", "staged": staged}
            (p_ans, p_costs), pairs_ms, _, _, _ = witness_run(placement, ca, t["starts"], dev, **kw)
            (ans, costs, levels), wit_ms, levels_run, body_launches, launched = witness_run(
                placement, ca, t["starts"], dev, semantics="witness", **kw)
            bs, vs = np.nonzero(ans)
            got = np.unique(np.stack([t["starts"][bs], vs]).T, axis=0)
            if not np.array_equal(got, t["pairs"]) or not np.array_equal(ans, p_ans) or costs != p_costs:
                raise AssertionError(f"{backend} {q}: witness answers or meters differ from the pairs "
                                     "run or the device BFS")
            if launched != {name: body_launches}:
                raise AssertionError(f"{backend} {q}: the witness run launched {launched}, its bodies "
                                     f"{body_launches} levels ({levels_run} BFS levels)")
            if levels.shape != (len(t["starts"]), ca.n_states, g.n_nodes) or levels.dtype != np.float32:
                raise AssertionError(f"{backend} {q}: levels of shape {levels.shape} {levels.dtype}")
            if name == "fused_level_blocks":
                f32_levels[q] = levels
            elif not np.array_equal(levels, f32_levels[q]):
                raise AssertionError(f"{q}: the packed levels differ from the f32 executor's")
            length = check_witness_levels(q, ca, g, index, t["starts"], ans, levels, rng, backend)
            finite = levels[witness.reached(levels)]
            r = rec[f"{backend}/{q}"] = {
                "starts": len(t["starts"]), "levels": levels_run, "launches": launched[name],
                "pairs_ms": pairs_ms, "witness_ms": wit_ms, "level_bytes": levels.nbytes,
                "deepest_level": float(finite.max()), "witness_hops": length,
                **witness_breakdown(placement, ca, t["starts"], backend, staged, dev),
            }
            log("witness", f"{backend}/f32 {q}: {r['starts']} starts; witness run {wit_ms:.1f} ms against "
                f"{pairs_ms:.1f} ms for pairs ({r['levels']} BFS levels, {r['launches']} {name} launches = "
                f"bodies x {fops.LEVELS_PER_CHECK}, no other kernel); answers and meters == pairs run == "
                f"device BFS; levels "
                f"{levels.shape} ({levels.nbytes / 1e6:.1f} MB, deepest {r['deepest_level']:.0f})"
                f"{' == the f32 executor' if name != 'fused_level_blocks' else ''} == host_levels on 4 "
                f"starts with answers; {min(N_WITNESSES, len(bs))} witnesses ({length} hops) valid and "
                "accepted")
            log("witness", f"{backend}/f32 {q}, a third run taken apart: set-up {r['setup_ms']:.1f} ms, "
                f"executor to levels on the card {r['executor_ms']:.1f} ms, levels to pageable host "
                f"memory {r['copy_ms']:.1f} ms ({levels.nbytes / r['copy_ms'] / 1e6:.2f} GB/s), to pinned "
                f"host memory {r['pinned_copy_ms']:.1f} ms")
        launches[name] = only_launched(name, f"the witness phase on {backend}")
        check_loop_launches(launches[name], f"the witness phase on {backend}")

    # a uint32 request without a Stage A restages f32 and launches B1, not B3
    reset_launches()
    fops.FIXPOINT_COUNTERS.clear()
    (ans, _, levels), ms, levels_run, body_launches, launched = witness_run(
        placement, cas["q1"], truth["q1"]["starts"], dev, backend="frontier_kernel",
        tile_dtype="uint32", semantics="witness")
    if launched != {"fused_level_blocks": body_launches} or not np.array_equal(levels, f32_levels["q1"]):
        raise AssertionError(f"q1 asking for uint32 tiles: launched {launched} for {body_launches} body "
                             f"levels ({levels_run} BFS levels), or levels differ from the f32 store's")
    launches["fused_level_blocks"] += launched["fused_level_blocks"]
    rec["restaged_q1"] = {"ms": ms, "levels": levels_run}
    log("witness", f"frontier_kernel q1 asking for tile_dtype='uint32', no Stage A: restaged f32 and ran "
        f"{levels_run} BFS levels in {body_launches} B1 launches (bodies x {fops.LEVELS_PER_CHECK}), no B3, in "
        f"{ms:.1f} ms (Stage A of the f32 store inside); levels == the f32 run's")
    del ans, levels, f32_levels
    free()

    # bounded counting on q1 (8 levels) against the host DP
    ca = cas["q1"]
    with_answers = np.unique(truth["q1"]["pairs"][:, 0])
    sample = np.sort(rng.choice(with_answers, size=min(4, len(with_answers)), replace=False))
    plan = fops.build_level_schedule(ca, staged)
    masks = np.zeros((len(sample), g.n_nodes), np.float32)
    masks[np.arange(len(sample)), sample] = 1.0
    f0 = torch.from_numpy(fops.stack_start_masks(plan, ca.start, masks))
    reset_launches()
    fops.FIXPOINT_COUNTERS.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    counts = fops.count_paths_bounded(plan, f0.to(dev), ca.accepting, COUNT_LEVELS).cpu().numpy()
    count_ms = (time.perf_counter() - t0) * 1e3
    n = only_launched("fused_level_blocks", "count_paths_bounded")
    if n != COUNT_LEVELS:
        raise AssertionError(f"count_paths_bounded launched B1 {n} times for {COUNT_LEVELS} levels")
    launches["fused_level_blocks"] += n
    dedup = paa.HostIndex(g.dedup())  # the tile store holds each (src, label, dst) once
    for i, s in enumerate(sample.tolist()):
        host = witness.count_paths(ca, dedup, s, COUNT_LEVELS)
        if host.max() >= 2**24 or not np.array_equal(counts[i, : g.n_nodes], host.astype(np.float32)):
            raise AssertionError(f"q1 start {s}: count_paths_bounded differs from the host DP")
    top = float(counts[: len(sample)].max())
    rec["count_q1"] = {"starts": sample.tolist(), "levels": COUNT_LEVELS, "ms": count_ms, "largest": top}
    log("witness", f"count_paths_bounded q1, {COUNT_LEVELS} levels = {n} B1 launches, starts "
        f"{sample.tolist()}: == the host DP exactly; largest count {top:.0f}; {count_ms:.1f} ms")
    rec["b1_counts_at_bound_max_abs_err"] = check_counts_at_bound(dev)
    return launches


def mem_available_gb() -> float:
    """The host's MemAvailable, GB (``/proc/meminfo``)."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024 / 1e9
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def query_truth(ca, g, dg, rng) -> dict:
    """A query's valid starts, their device-BFS answer pairs and the host
    meter of N_METER_SAMPLES sampled starts (the path phase's ``truth``)."""
    starts = paa.valid_start_nodes(ca, g)
    o_src, o_dst = paa.answers_multi_source(ca, dg, starts)
    sample = rng.choice(len(starts), size=min(N_METER_SAMPLES, len(starts)), replace=False)
    index = paa.HostIndex(g)
    return {"starts": starts, "pairs": np.unique(np.stack([o_src, o_dst]).T, axis=0),
            "meters": {int(i): paa.run_instrumented(ca, index, int(starts[i])) for i in sample}}


def check_answers_and_meters(what, starts, t, answers, costs) -> int:
    """``answers`` of ``starts`` against the device BFS's pairs in ``t``,
    and the broadcast meters of ``t``'s sampled starts (indices into
    ``t["starts"]``) against the host meter.  Returns the answer pairs."""
    bs, vs = np.nonzero(answers)
    got = np.unique(np.stack([starts[bs], vs]).T, axis=0)
    want = t["pairs"][np.isin(t["pairs"][:, 0], starts)]
    if not np.array_equal(got, want):
        raise AssertionError(f"{what}: answers differ from the device-BFS oracle")
    pos = {int(s): i for i, s in enumerate(starts)}
    for i, tr in t["meters"].items():
        s = int(t["starts"][i])
        if s in pos and (costs[pos[s]].broadcast_symbols, costs[pos[s]].n_broadcasts) != (tr.q_bc, tr.n_broadcasts):
            raise AssertionError(f"{what} start {s}: q_bc/n_bc {costs[pos[s]]} != host {tr}")
    return len(got)


def sharded_run(what, placement, ca, starts, t, store, dev, axis_size, tile_dtype, **kw) -> tuple:
    """``s2_execute`` on the sharded backend over ``store``'s Stage A, with
    the launch counts set to 0 just before and read just after: answers
    and broadcast meters checked against ``t``, and the level kernel's
    launches == bodies x LEVELS_PER_CHECK x buckets, no other kernel
    launched."""
    name = "fused_level_blocks_u32" if tile_dtype == "uint32" else "fused_level_blocks"
    reset_launches()
    fops.FIXPOINT_COUNTERS.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = strategies.s2_execute(placement, ca, starts, backend="frontier_kernel_sharded",
                                tile_dtype=tile_dtype, plan_store=store, device=dev,
                                axis_size=axis_size, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    staged_dtype = "f32" if kw.get("semantics") == "witness" else tile_dtype
    n_buckets = len(store.tile_buckets(placement, 128, axis_size, tile_dtype=staged_dtype).buckets)
    levels = fops.FIXPOINT_COUNTERS["levels"]
    n = only_launched(name, what)
    check_loop_launches(n, what, n_buckets)
    pairs = check_answers_and_meters(what, starts, t, out[0], out[1])
    return out, {"kernel": name, "starts": len(starts), "pairs": pairs, "levels": levels,
                 "buckets": n_buckets, "launches": n, "bodies": fops.FIXPOINT_COUNTERS["bodies"],
                 "host_syncs": fops.FIXPOINT_COUNTERS["host_syncs"],
                 "wall_ms": wall * 1e3, "queries_per_s": len(starts) / wall}


def stage_sharded(store, placement, tile_dtype, axes) -> dict:
    """The sharded Stage A of ``placement`` through ``store``, each step
    timed: the per-site slabs (host), their merge into each of ``axes``
    groups (host) and the groups' shape buckets (device)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    staged = store.staged_sharded(placement, 128, tile_dtype=tile_dtype)
    rec = {"per_site_s": time.perf_counter() - t0, "per_site_tiles": sum(staged.site_n_tiles),
           "per_site_bytes": staged.tile_store_bytes}
    for ax in axes:
        t0 = time.perf_counter()
        merged = store.staged_merged(placement, 128, ax, tile_dtype=tile_dtype)
        t1 = time.perf_counter()
        tb = store.tile_buckets(placement, 128, ax, tile_dtype=tile_dtype)
        torch.cuda.synchronize()
        rec[f"axis_{ax}"] = {
            "merge_s": t1 - t0, "buckets_s": time.perf_counter() - t1,
            "group_tiles": list(merged.site_n_tiles), "group_bytes": merged.tile_store_bytes,
            "bucket_shapes": [(b.n_tiles, len(b.sites)) for b in tb.buckets],
            "device_bytes": sum(b.tiles.numel() * b.tiles.element_size() for b in tb.buckets)}
    return rec


def log_staging(tag: str, r: dict) -> None:
    log("sharded", f"{tag}: per-site Stage A {r['per_site_tiles']} tiles, {r['per_site_bytes'] / 1e9:.3f} GB "
        f"of host slabs in {r['per_site_s']:.1f} s")
    for k, a in r.items():
        if k.startswith("axis_"):
            log("sharded", f"{tag} {k}: merged into {len(a['group_tiles'])} grid(s) of {a['group_tiles']} "
                f"tiles ({a['group_bytes'] / 1e9:.3f} GB) in {a['merge_s']:.1f} s; buckets (n_tiles, rows) "
                f"{a['bucket_shapes']}, {a['device_bytes'] / 1e9:.3f} GB on the device in {a['buckets_s']:.1f} s")


def check_bucket_launch(what, store, placement, ca, axis_size, tile_dtype, dev, flush) -> dict:
    """B1 or B3 on one multi-row bucket's concatenated work list against
    the plain version (the members' plain levels summed), on a random
    {0,1} frontier: ``torch.equal``; both timed between events."""
    plan = fops.build_sharded_level_schedule(
        ca, store.staged_merged(placement, 128, axis_size, tile_dtype=tile_dtype),
        store.tile_buckets(placement, 128, axis_size, tile_dtype=tile_dtype), axis_size=axis_size)
    b = max(plan.buckets, key=lambda b: len(b.sites))
    if len(b.sites) < 2:
        raise AssertionError(f"{what}: no bucket of several rows at axis size {axis_size}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    f = (torch.rand((plan.n_states * plan.q_pad, plan.v_pad), generator=gen, device=dev) < 0.3).float()
    fre = fops.extend_frontier(f, plan.union_members, plan.n_states, plan.q_pad)
    seven = [getattr(b, n) for n in SCHEDULE]
    n_out = plan.n_states * plan.q_pad

    def kernel():
        return fkernel.bucket_level_blocks(
            fre, b.tiles, *seven, plan.block_size, plan.q_pad, run_ptr=b.run_ptr, work=b.work,
            flat_tile_ids=b.flat_tile_ids, n_out_rows=n_out)

    def plain():
        return fkernel.bucket_level_blocks_plain(fre, b.tiles, *seven, plan.block_size, plan.q_pad,
                                                 n_out_rows=n_out)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{what}: the bucket launch differs from the members' plain levels")
    r = {"rows": len(b.sites), "chunks": int(b.work.shape[0]), "max_sum": float(want.max()),
         "max_abs_err": float((got - want).abs().max()),
         "ms": events_ms(kernel, 10, flush), "plain_ms": events_ms(plain, 3, flush)}
    log("sharded", f"{what}: one {'B3' if tile_dtype == 'uint32' else 'B1'} launch over a bucket of "
        f"{r['rows']} rows ({r['chunks']} chunks, sums up to {r['max_sum']:.0f}) == the members' plain "
        f"levels summed; {r['ms'] * 1e3:.1f} us, plain {r['plain_ms'] * 1e3:.1f} us (events, L2 flushed)")
    return r


def phase_sharded(g, placement, cas, truth, dg, dev, flush, record) -> tuple[dict, dict]:
    """The site-sharded backend (B3 and B1 once per bucket and level) and
    the reference backend (no kernel): (i) the twin on 16 sites over the
    bit-plane store at axis sizes 1 and 4; (ii) an 8,000-node twin on 16
    sites over the f32 store, pairs and witness; (iii) the reference
    backend on the 256-site placement, and on (i)'s placement against
    the sharded per-site meters; (iv) the bucket launches against their
    plain versions, and the per-site meter with TF32 on.  Returns each
    level kernel's launches and what the mesh phase reuses: (i)'s
    placement and plan store, (ii)'s graph, placement and per-site
    slabs."""
    rec = record["sharded"] = {}
    launches = collections.Counter()
    rng = np.random.default_rng(SEED + 7)

    # (i) the twin on 16 sites, bit-plane tiles: B3
    pl16 = distribute(g, n_sites=SHARD_SITES, replication_rate=RPQ.replication_rate, seed=SEED)
    store = plans.GraphPlanStore(device=dev)
    rec["i_staging"] = stage_sharded(store, pl16, "uint32", SHARD_AXES)
    log_staging(f"(i) twin, {SHARD_SITES} sites, K = {pl16.replication_factor:.4f}, uint32", rec["i_staging"])
    site_meters = {}
    for ax in SHARD_AXES:
        for q in QUERIES:
            t = truth[q]
            (answers, costs), r = sharded_run(f"sharded (i) uint32 axis {ax} {q}", pl16, cas[q],
                                              t["starts"], t, store, dev, ax, "uint32")
            launches[r["kernel"]] += r["launches"]
            site_meters[(ax, q)] = [c.site_unicast_symbols for c in costs]
            rec[f"i_axis{ax}_{q}"] = r
            log("sharded", f"(i) uint32 axis {ax} {q}: {r['starts']} starts, {r['pairs']} pairs == oracle, "
                f"q_bc/n_bc == host on {len(t['meters'])}; {r['levels']} BFS levels, {r['bodies']} bodies x "
                f"{fops.LEVELS_PER_CHECK} x {r['buckets']} bucket(s) = {r['launches']} B3 launches, "
                f"{r['host_syncs']} host syncs, {r['wall_ms']:.1f} ms, "
                f"{r['queries_per_s']:.1f} queries/s")
    for q in QUERIES:
        if site_meters[(1, q)] != site_meters[(SHARD_AXES[-1], q)]:
            raise AssertionError(f"sharded (i) {q}: per-site meters differ between axis sizes")
    plan_pad = store.pad_stats()
    rec["i_pad"] = plan_pad
    log("sharded", f"(i) per-site meters equal at axis sizes {SHARD_AXES}; pad waste {plan_pad['pad_waste_ratio']:.4f} "
        f"({plan_pad['padded_steps']} executed / {plan_pad['useful_steps']} useful steps)")

    # (iv) B3 on a bucket of 4 rows; the per-site meter with TF32 on
    rec["iv_b3"] = check_bucket_launch("(iv) q1 axis 4 uint32", store, pl16, cas["q1"], SHARD_AXES[-1],
                                       "uint32", dev, flush)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        (_, costs), _ = sharded_run("sharded (iv) TF32 on", pl16, cas["q1"], truth["q1"]["starts"],
                                    truth["q1"], store, dev, 1, "uint32")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    if [c.site_unicast_symbols for c in costs] != site_meters[(1, "q1")]:
        raise AssertionError("sharded (iv): per-site meters changed with allow_tf32 = True")
    hub = max(int(np.bincount(g_s.src, minlength=g.n_nodes).max()) for g_s in store.local_graphs(pl16))
    log("sharded", f"(iv) q1's per-site meters with allow_tf32 = True == with it off (the largest "
        f"out-degree on one site is {hub}; TF32 holds integers exactly only to 2048)")

    # (iii) the reference backend on (i)'s placement: d_s2 == the sharded per-site sum
    arrays16 = strategies.stage_site_arrays(pl16, dev)
    for q in QUERIES:
        starts = truth[q]["starts"][:N_REFERENCE_STARTS]
        ref = strategies.make_s2_step_fn(cas[q], g.n_nodes, backend="reference")(starts, arrays16)
        shard = strategies.make_s2_step_fn(cas[q], g.n_nodes, backend="frontier_kernel_sharded",
                                           placement=pl16, tile_dtype="uint32", plan_store=store)(starts)
        if not torch.equal(ref[2], shard[4].sum(dim=0)) or not torch.equal(ref[0], shard[0]):
            raise AssertionError(f"reference on (i)'s placement {q}: d_s2 != the sharded per-site sum")
    log("sharded", f"(iii) reference on (i)'s {SHARD_SITES} sites: answers and d_s2 == the sharded "
        f"backend's answers and per-site meters summed, exactly, on {N_REFERENCE_STARTS} starts a query")
    handoff = {"pl16": pl16, "store16": store}
    del store, arrays16
    free()

    # (iii) the reference backend on the 256-site placement: no kernel
    t0 = time.perf_counter()
    arrays = strategies.stage_site_arrays(placement, dev)
    torch.cuda.synchronize()
    slots = arrays["src"].numel()
    log("sharded", f"(iii) the 256-site placement's padded site arrays: {slots} edge slots "
        f"({sum(a.numel() * a.element_size() for a in arrays.values()) / 1e9:.3f} GB) in "
        f"{time.perf_counter() - t0:.1f} s")
    for q in QUERIES:
        t = truth[q]
        metered = t["starts"][sorted(t["meters"])]
        rest = np.setdiff1d(t["starts"], metered)
        starts = np.concatenate([metered, rng.choice(rest, size=min(len(rest), N_REFERENCE_STARTS - len(metered)),
                                                     replace=False)]).astype(np.int32)
        reset_launches()
        fops.FIXPOINT_COUNTERS.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        answers, costs = strategies.s2_execute(placement, cas[q], starts, backend="reference",
                                               device_arrays=arrays, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if sum(launch_counts().values()):
            raise AssertionError(f"reference {q}: kernels launched: {launch_counts()}")
        pairs = check_answers_and_meters(f"reference {q}", starts, t, answers, costs)
        r = rec[f"iii_reference_{q}"] = {
            "starts": len(starts), "pairs": pairs, "levels": fops.FIXPOINT_COUNTERS["levels"],
            "host_syncs": fops.FIXPOINT_COUNTERS["host_syncs"], "wall_ms": wall * 1e3,
            "queries_per_s": len(starts) / wall}
        log("sharded", f"(iii) reference {q}: {r['starts']} starts, {r['pairs']} pairs == oracle, q_bc/n_bc "
            f"== host on {len(metered)}; {r['levels']} levels, {r['host_syncs']} host syncs, 0 kernel "
            f"launches, {r['wall_ms']:.1f} ms, {r['queries_per_s']:.1f} queries/s")
    del arrays
    free()

    # (ii) an 8,000-node twin on 16 sites, f32 tiles: B1, pairs and witness
    g2 = alibaba_like(n_nodes=SHARD_F32_NODES, n_edges=SHARD_F32_EDGES, seed=SEED)
    pl2 = distribute(g2, n_sites=SHARD_SITES, replication_rate=RPQ.replication_rate, seed=SEED)
    dg2 = to_device_graph(g2, dev)
    index2 = paa.HostIndex(g2)
    cas2 = {q: paa.compile_query(TABLE2_QUERIES[q], g2) for q in QUERIES}
    truth2 = {q: query_truth(cas2[q], g2, dg2, rng) for q in QUERIES}
    rec["ii_mem_available_gb"] = mem_available_gb()
    log("sharded", f"(ii) twin of {g2.n_nodes} nodes, {g2.n_edges} edges on {SHARD_SITES} sites, K = "
        f"{pl2.replication_factor:.4f}; MemAvailable {rec['ii_mem_available_gb']:.1f} GB before staging")
    store = plans.GraphPlanStore(device=dev)
    rec["ii_staging"] = stage_sharded(store, pl2, "f32", SHARD_AXES)
    log_staging("(ii) f32", rec["ii_staging"])
    for ax in SHARD_AXES:
        for q in QUERIES:
            t = truth2[q]
            (answers, costs), r = sharded_run(f"sharded (ii) f32 axis {ax} {q}", pl2, cas2[q], t["starts"], t,
                                              store, dev, ax, "f32")
            launches[r["kernel"]] += r["launches"]
            (w_answers, w_costs, levels), rw = sharded_run(
                f"sharded (ii) f32 witness axis {ax} {q}", pl2, cas2[q], t["starts"], t, store, dev, ax,
                "f32", semantics="witness")
            launches[rw["kernel"]] += rw["launches"]
            if not np.array_equal(w_answers, answers) or w_costs != costs:
                raise AssertionError(f"sharded (ii) axis {ax} {q}: the witness run differs from the pairs run")
            hops = check_witness_levels(q, cas2[q], g2, index2, t["starts"], answers, levels, rng,
                                        f"sharded (ii) axis {ax}")
            r["witness"] = {k: rw[k] for k in ("levels", "launches", "wall_ms")} | {"hops": hops}
            rec[f"ii_axis{ax}_{q}"] = r
            log("sharded", f"(ii) f32 axis {ax} {q}: {r['starts']} starts, {r['pairs']} pairs == oracle; "
                f"{r['levels']} BFS levels, {r['bodies']} bodies x {fops.LEVELS_PER_CHECK} x {r['buckets']} "
                f"bucket(s) = {r['launches']} B1 launches, {r['wall_ms']:.1f} ms, {r['queries_per_s']:.1f} "
                f"queries/s; witness run {rw['wall_ms']:.1f} ms, "
                f"levels == host_levels on 4 starts, {N_WITNESSES} witnesses ({hops} hops) valid")
    rec["ii_pad"] = store.pad_stats()
    rec["iv_b1"] = check_bucket_launch("(iv) q1 axis 4 f32", store, pl2, cas2["q1"], SHARD_AXES[-1], "f32",
                                       dev, flush)
    handoff.update(g2=g2, pl2=pl2, per_site2=store.staged_sharded(pl2, 128, tile_dtype="f32"))
    del store, dg2
    free()
    return dict(launches), handoff


# ---------------------------------------------------------------------------
# mesh: the mesh programs, per rank
# ---------------------------------------------------------------------------


def digest(*parts) -> str:
    """sha256 of arrays (dtype, shape and bytes; tensors copied to the
    host) and of other values by their JSON form: equal digests are equal
    bytes."""
    h = hashlib.sha256()
    for p in parts:
        if isinstance(p, torch.Tensor):
            p = p.detach().cpu().numpy()
        if isinstance(p, np.ndarray):
            h.update(f"{p.dtype.str}{p.shape}".encode())
            h.update(np.ascontiguousarray(p).tobytes())
        else:
            h.update(json.dumps(p, default=str).encode())
    return h.hexdigest()


def run_digest(out) -> str:
    """An ``s2_execute`` result's digest: answers, every cost field
    (per-site meters included) and witness levels."""
    return digest(out[0], [dataclasses.astuple(c) for c in out[1]], *out[2:])


def bucket_row_digest(b, row: int) -> str:
    """Row ``row`` of a one-card plan bucket, or a rank plan's one row: the
    seven step arrays and run offsets, and the row's work chunks and flat
    tile ids offset back to row 0 (its tiles: :func:`digest` of
    ``b.tiles[row]``, once per Stage A)."""
    work = b.work.cpu().numpy()
    of_row = np.where(work >= 0, work // b.n_steps, -1).max(axis=1) == row
    work = np.where(work[of_row] >= 0, work[of_row] - row * b.n_steps, -1)
    flat = b.flat_tile_ids.cpu().numpy().reshape(-1, b.n_steps)[row] - row * b.n_tiles
    return digest(b.n_steps, b.n_tiles, *(getattr(b, k)[row] for k in (*SCHEDULE, "run_ptr")),
                  work, flat.astype(np.int32))


def mesh_s2(what, placement, ca, starts, dev, backend, tile_dtype="f32", semantics="pairs", store=None,
            mesh=None, axis_size=None, arrays=None) -> tuple[str, dict]:
    """``s2_execute`` on the sharded or reference backend, on one card
    (``mesh=None``) or per rank, with the launch, level and wire counts set
    to 0 just before and read just after: the sharded path must launch its
    kernel once a level on a rank (one bucket), LEVELS_PER_CHECK times a
    body and bucket on one card, the reference path none.  Returns the result's digest and
    the counts."""
    name = "fused_level_blocks_u32" if tile_dtype == "uint32" else "fused_level_blocks"
    reset_launches()
    fops.FIXPOINT_COUNTERS.clear()
    collectives.WIRE_COUNTERS.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = strategies.s2_execute(placement, ca, starts, backend=backend, tile_dtype=tile_dtype,
                                semantics=semantics, plan_store=store, device=dev, mesh=mesh,
                                axis_size=axis_size, device_arrays=arrays)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    levels = fops.FIXPOINT_COUNTERS["levels"]
    # one level's pmax: the merged frontier as uint8, (n_states, QPAD, v_pad)
    # a chunk on the sharded path, (starts, n_states, n_nodes) on the reference
    v_pad = -(-placement.graph.n_nodes // 128) * 128
    frontier_bytes = (len(starts) * ca.n_states * placement.graph.n_nodes if backend == "reference"
                      else ca.n_states * fops.QPAD * v_pad)
    r = {"starts": len(starts), "levels": levels, "wall_ms": wall * 1e3,
         "all_reduces": collectives.WIRE_COUNTERS["all_reduces"], "wire_bytes": collectives.WIRE_COUNTERS["bytes"],
         "frontier_bytes_per_level": frontier_bytes if mesh is not None else 0}
    if backend == "reference":
        if sum(launch_counts().values()):
            raise AssertionError(f"{what}: kernels launched: {launch_counts()}")
        r["launches"] = 0
    else:
        n_buckets = 1 if mesh is not None else len(store.tile_buckets(
            placement, 128, axis_size, tile_dtype="f32" if semantics == "witness" else tile_dtype).buckets)
        r["launches"] = only_launched(name, what)
        if mesh is None:  # one card: the device loop, LEVELS_PER_CHECK levels a body
            check_loop_launches(r["launches"], what, n_buckets)
        elif r["launches"] != levels:  # a rank's host loop: one launch a level
            raise AssertionError(f"{what}: {r['launches']} {name} launches for {levels} levels")
        r["kernel"] = name
    return run_digest(out), r


def s1_digests(placement, cas_s1, arrays, mesh=None) -> dict[str, str]:
    """The plan phase's S1 gathers (every Table-2 query's label mask at the
    padded width) on one card or per rank: each digest covers the four
    (n_sites, cap) buffers and the overflow."""
    cap = placement.padded_width()
    return {q: digest(*strategies.s1_gather(arrays, lmask, cap, mesh)) for q, lmask in cas_s1.items()}


def mesh_cases(ctx: dict, dev, meshes: dict, tag: str, rec: dict, refs: dict | None) -> dict:
    """Every case of the mesh phase on one card (``meshes`` empty: the
    references, at the ranks' axis sizes) or per rank.  ``ctx`` holds the
    placements, automata, starts and the plan stores; with ``refs`` every
    digest must equal its reference.  Returns the digests and fills
    ``rec`` with each run's counts."""
    got = {}

    def check(key, value):
        got[key] = value
        if refs is not None and refs[key] != value:
            raise AssertionError(f"mesh {tag} {key}: differs from the one-card run")

    def record(key, r):
        rec[key] = r
        log("mesh", f"{tag} {key}: {r['starts']} starts, {r['levels']} levels, {r['launches']} launches, "
            f"{r['all_reduces']} all_reduces, {r['wire_bytes']} bytes all_reduced (the frontier "
            f"{r['frontier_bytes_per_level']} a level), {r['wall_ms']:.1f} ms")

    for part, placement, store_key, tile_dtype, sems in (
        ("i", ctx["pl16"], "store16", "uint32", ("pairs",)),
        ("ii", ctx["pl2"], "store2", "f32", ("pairs", "witness")),
    ):
        if part not in ctx["parts"]:
            continue
        mesh = meshes.get(part)
        axis = ctx["axis"][part] if mesh is None else collectives.axis_size(mesh, ("data",))
        store = ctx[store_key] if mesh is None else plans.GraphPlanStore(device=dev)
        for q in QUERIES:
            ca = ctx[f"cas_{part}"][q]
            for sem in sems:
                d, r = mesh_s2(f"mesh {tag} ({part}) {q} {sem}", placement, ca, ctx[f"starts_{part}"][q], dev,
                               "frontier_kernel_sharded", tile_dtype, sem, store, mesh,
                               axis if mesh is None else None)
                check(f"{part}/{q}/{sem}", d)
                record(f"{part}/{q}/{sem}", r)
        # Stage A and B: one-card rows, or this rank's row of them
        staged = store.staged_merged(placement, 128, axis, tile_dtype=tile_dtype, mesh=mesh)
        buckets = store.tile_buckets(placement, 128, axis, tile_dtype=tile_dtype, mesh=mesh)
        rows = (range(axis) if mesh is None else [collectives.axis_index(mesh, ("data",))])
        for q in (*QUERIES, "tiles"):
            if mesh is None:
                (b,) = (buckets.buckets if q == "tiles" else
                        fops.build_sharded_level_schedule(ctx[f"cas_{part}"][q], staged, buckets,
                                                          axis_size=axis).buckets)
                got[f"{part}/{q}/rows"] = [digest(b.tiles[row]) if q == "tiles" else bucket_row_digest(b, row)
                                           for row in rows]
                continue
            (b,) = (buckets.buckets if q == "tiles" else
                    fops.build_rank_level_schedule(ctx[f"cas_{part}"][q], staged, buckets, mesh).buckets)
            row = rows[0]
            mine = digest(b.tiles[0]) if q == "tiles" else bucket_row_digest(b, 0)
            if refs is not None and refs[f"{part}/{q}/rows"][row] != mine:
                raise AssertionError(f"mesh {tag} ({part}) {q}: the rank's Stage {'A' if q == 'tiles' else 'B'} "
                                     f"is not row {row} of the one-card one")
            got[f"{part}/{q}/row{row}"] = mine
        del store, staged, buckets
    if "ref" in ctx["parts"]:
        mesh = meshes.get("ref")
        arrays = strategies.stage_site_arrays(ctx["placement"], dev, mesh)
        for q in QUERIES:
            for sem in ("pairs", "witness"):
                d, r = mesh_s2(f"mesh {tag} reference {q} {sem}", ctx["placement"], ctx["cas_i"][q],
                               ctx["starts_ref"][q], dev, "reference", semantics=sem, mesh=mesh,
                               arrays=arrays)
                check(f"ref/{q}/{sem}", d)
                record(f"ref/{q}/{sem}", r)
        collectives.WIRE_COUNTERS.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for q, d in s1_digests(ctx["placement"], ctx["lmasks"], arrays, mesh).items():
            check(f"s1/{q}", d)
        torch.cuda.synchronize()
        rec["s1"] = {"gathers": len(ctx["lmasks"]), "wall_ms": (time.perf_counter() - t0) * 1e3,
                     "wire_bytes": collectives.WIRE_COUNTERS["bytes"]}
        log("mesh", f"{tag} S1: {len(ctx['lmasks'])} gathers at the padded width "
            f"{ctx['placement'].padded_width()}, {rec['s1']['wire_bytes']} bytes on the wire, "
            f"{rec['s1']['wall_ms']:.1f} ms")
        del arrays
    return got


def mesh_context(g, placement, cas, handoff, parts, n_starts=None) -> dict:
    """What every rank rebuilds from the seed, as the parent holds it;
    ``n_starts`` cuts (i)'s and (ii)'s valid starts to their first ones."""
    g2 = handoff["g2"] if "g2" in handoff else alibaba_like(n_nodes=SHARD_F32_NODES, n_edges=SHARD_F32_EDGES,
                                                            seed=SEED)
    cas2 = {q: paa.compile_query(TABLE2_QUERIES[q], g2) for q in QUERIES}
    return {
        "parts": parts, "placement": placement, "cas_i": cas, "cas_ii": cas2,
        "pl16": handoff.get("pl16") or distribute(g, n_sites=SHARD_SITES, replication_rate=RPQ.replication_rate,
                                                  seed=SEED),
        "pl2": handoff.get("pl2") or distribute(g2, n_sites=SHARD_SITES, replication_rate=RPQ.replication_rate,
                                                seed=SEED),
        "starts_i": {q: paa.valid_start_nodes(cas[q], g)[:n_starts] for q in QUERIES},
        "starts_ii": {q: paa.valid_start_nodes(cas2[q], g2)[:n_starts] for q in QUERIES},
        "starts_ref": {q: paa.valid_start_nodes(cas[q], g)[:N_REFERENCE_STARTS] for q in QUERIES},
        "lmasks": {q: strategies.query_label_mask(rx.parse(e), g) for q, e in TABLE2_QUERIES.items()},
        "axis": {"i": 1, "ii": 1},
    }


def mesh_rank(rank: int, world: int, tmp: str) -> None:
    """One of the MESH_RANKS ``gloo`` ranks that share the card: (i) on a
    (4, 1) mesh, (ii) on a (2, 2) mesh, the reference backend and S1 on a
    (4, 1) mesh, each digest held to the parent's one-card run; writes its
    counts to ``rank{rank}.json``."""
    torch.set_num_threads(2)
    dev = ranks.init_rank(rank, world, os.path.join(tmp, "store"), backend="gloo", timeout_s=MESH_TIMEOUT_S)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        with open(os.path.join(tmp, "refs.json")) as f:
            refs = json.load(f)
        meshes = {"i": mesh_lib.make_test_mesh(*MESH_I_SHAPE), "ii": mesh_lib.make_test_mesh(*MESH_II_SHAPE)}
        meshes["ref"] = meshes["i"]
        g = alibaba_like(seed=SEED)
        placement = distribute(g, n_sites=RPQ.n_sites, replication_rate=RPQ.replication_rate, seed=SEED)
        cas = {q: paa.compile_query(TABLE2_QUERIES[q], g) for q in QUERIES}
        ctx = mesh_context(g, placement, cas, {}, ("i", "ii", "ref"), MESH_B_STARTS)
        rec = {"rank": rank, "coords": {k: list(m.get_coordinate()) for k, m in meshes.items()}}
        t0 = time.perf_counter()
        mesh_cases(ctx, dev, meshes, f"(b) rank {rank}", rec, refs)
        rec["wall_s"] = time.perf_counter() - t0
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def phase_mesh(g, placement, cas, handoff, dev, record) -> dict[str, int]:
    """The mesh programs on the card: the one-card references (``mesh=None``
    at the ranks' axis sizes), then (a) a one-rank NCCL group in this
    process on (i), the reference backend and S1, (b) MESH_RANKS ``gloo``
    ranks spawned on the one card on (i), (ii), the reference backend and
    S1, each digest equal to the reference's.  Returns each level kernel's
    launches in the references, (a) and (b), every rank's summed.
    ``handoff`` loses its plan store and slabs once the references are
    made."""
    rec = record["mesh"] = {}
    launches = collections.Counter()
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # every rank is on this host
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    ctx = mesh_context(g, placement, cas, handoff, ("i", "ref"), MESH_B_STARTS)
    store2 = plans.GraphPlanStore(device=dev)
    store2.install_entry(("staged_sharded", 128, "f32"), ctx["pl2"], 0, handoff["per_site2"])
    ctx.update(store16=handoff["store16"], store2=store2)

    # references: (i) at axis 1 for (a), (i) at 4 and (ii) at 2 for (b)
    t0 = time.perf_counter()
    refs, rec["one_card_a"], rec["one_card_b"] = {}, {}, {}
    refs["a"] = mesh_cases(ctx, dev, {}, "one card", rec["one_card_a"], None)
    ctx.update(parts=("i", "ii"), axis={"i": MESH_I_SHAPE[0], "ii": MESH_II_SHAPE[0]})
    refs["b"] = {**refs["a"], **mesh_cases(ctx, dev, {}, "one card axis 4/2", rec["one_card_b"], None)}
    rec["references_s"] = time.perf_counter() - t0
    del store2, ctx["store2"], ctx["store16"]
    for k in ("store16", "per_site2"):  # the ranks stage their own shares
        handoff.pop(k)
    ctx["parts"] = ("i", "ref")
    free()

    # (a) one NCCL rank in this process, a (1, 1) mesh
    tmp = tempfile.mkdtemp(prefix="chip-smoke-mesh-")
    ranks.init_rank(0, 1, os.path.join(tmp, "nccl-store"), device=dev, timeout_s=MESH_TIMEOUT_S)
    try:
        if dist.get_backend() != ("nccl" if dev.type == "cuda" else "gloo"):
            raise AssertionError(f"(a) runs on {dist.get_backend()}, not NCCL")
        mesh = mesh_lib.make_test_mesh(1, 1)
        rec["a"] = {}
        t0 = time.perf_counter()
        mesh_cases(ctx, dev, {"i": mesh, "ref": mesh}, "(a) NCCL 1 rank", rec["a"], refs["a"])
        rec["a_s"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    for r in (*rec["one_card_a"].values(), *rec["one_card_b"].values(), *rec["a"].values()):
        if isinstance(r, dict) and r.get("kernel"):
            launches[r["kernel"]] += r["launches"]
    log("mesh", f"(a) one NCCL rank on a (1, 1) mesh: (i) on B3, the reference backend and S1 == the one-card "
        f"runs, bit for bit, bucket arrays == the one-card plan's; {rec['a_s']:.1f} s")
    free()

    # (b) MESH_RANKS gloo ranks sharing the card
    with open(os.path.join(tmp, "refs.json"), "w") as f:
        json.dump(refs["b"], f)
    t0 = time.perf_counter()
    ranks.run_ranks(mesh_rank, MESH_RANKS, (MESH_RANKS, tmp), timeout_s=MESH_TIMEOUT_S, device=dev)
    rec["b_s"] = time.perf_counter() - t0
    rec["b"] = []
    for rank in range(MESH_RANKS):
        with open(os.path.join(tmp, f"rank{rank}.json")) as f:
            rr = json.load(f)
        rec["b"].append(rr)
        for r in rr.values():
            if isinstance(r, dict) and r.get("kernel"):
                launches[r["kernel"]] += r["launches"]
    shutil.rmtree(tmp, ignore_errors=True)
    log("mesh", f"(b) {MESH_RANKS} gloo ranks sharing one card: (i) on a {MESH_I_SHAPE} mesh (B3), (ii) on a "
        f"{MESH_II_SHAPE} mesh (B1, pairs and witness), the reference backend and S1 on {MESH_I_SHAPE}: every "
        f"digest == the one-card run's, every rank's bucket arrays its rows of the one-card plan, launches == "
        f"levels on every rank; {rec['b_s']:.1f} s wall for 4 ranks sharing one card (spawn included; not a "
        "multi-card time)")
    return dict(launches)


# ---------------------------------------------------------------------------
# mesh (c): the service over ranks; mesh (d): the models over ranks
# ---------------------------------------------------------------------------


def serve_windows(svc, stream, first_window: dict | None = None) -> list:
    """``stream`` through ``svc`` as ``serve_sync`` sends it (windows of
    SERVE_WINDOW, ``first_window``'s keywords on the first), then the
    followers' stop order; on a follower rank, ``follow()`` of the
    leader's orders.  Every request's ``Answers`` (a failed one raises)."""
    if not svc.leader:
        return [t.result() for t in svc.follow()]
    tickets = []
    for lo in range(0, len(stream), SERVE_WINDOW):
        kw = (first_window or {}) if lo == 0 else {}
        tickets += [svc.enqueue(wq.query, wq.starts, **kw) for wq in stream[lo : lo + SERVE_WINDOW]]
        svc.flush()
    svc.stop_followers()
    return [t.result() for t in tickets]


def run_buckets(svc) -> int:
    """The sharded executor's buckets a level: the rank's one on a mesh,
    else the one-card plan's at the service's axis size."""
    if svc.mesh is not None:
        return 1
    cfg = svc.config
    return len(svc.plan_store.tile_buckets(svc.placement, cfg.s2_block_size, svc.axis_size, svc.stats_epoch,
                                           cfg.s2_bucket_floor, cfg.s2_tile_dtype).buckets)


def mesh_serve_run(what: str, svc, stream, refs: list | None, kernel: str | None,
                   first_window: dict | None = None) -> tuple[list, dict]:
    """One serve run of the mesh phase's (c), on one card or per rank, the
    launch, level and wire counts set to 0 just before and read just
    after: each request's digest must equal ``refs``' (when given), and
    ``kernel`` launch once a level on a rank, LEVELS_PER_CHECK times a body
    and bucket on one card (``None``: no kernel at all).  Returns the
    answers and the counts."""
    reset_launches()
    fops.FIXPOINT_COUNTERS.clear()
    collectives.WIRE_COUNTERS.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    answers = serve_windows(svc, stream, first_window)
    torch.cuda.synchronize()
    r = {"requests": len(answers), "wall_s": time.perf_counter() - t0,
         "levels": fops.FIXPOINT_COUNTERS["levels"], "flushes": -(-len(stream) // SERVE_WINDOW),
         "all_reduces": collectives.WIRE_COUNTERS["all_reduces"], "wire_bytes": collectives.WIRE_COUNTERS["bytes"],
         "strategies": dict(collections.Counter(a.strategy for a in answers))}
    if refs is not None:
        differ = sum(answer_digest(a) != d for a, d in zip(answers, refs, strict=True))
        if differ:
            raise AssertionError(f"mesh {what}: {differ} of {len(refs)} requests differ from the one-card service's")
    if kernel is None:
        if sum(launch_counts().values()):
            raise AssertionError(f"mesh {what}: kernels launched: {launch_counts()}")
        r["launches"] = 0
    else:
        r["kernel"], r["launches"] = kernel, only_launched(kernel, f"mesh {what}")
        if svc.mesh is None:  # one card: the device loop, LEVELS_PER_CHECK levels a body and bucket
            check_loop_launches(r["launches"], f"mesh {what}", run_buckets(svc))
        elif r["launches"] != r["levels"]:  # a rank's host loop: one launch a level
            raise AssertionError(f"mesh {what}: {r['launches']} {kernel} launches for {r['levels']} levels")
    log("mesh", f"{what}: {r['requests']} requests, strategies {r['strategies']}, {r['levels']} levels, "
        f"{r['launches']} {kernel or 'kernel'} launches, {r['all_reduces']} all_reduces, {r['wire_bytes']} bytes "
        f"all_reduced ({r['wire_bytes'] / r['flushes']:.0f} a flush), {r['wall_s']:.2f} s"
        + ("; every request == the one-card service's" if refs is not None else ""))
    return answers, r


def mesh_serve_rank(rank: int, world: int, tmp: str) -> None:
    """One of the MESH_RANKS ``gloo`` ranks of the mesh phase's (c): serve
    run (h) on MESH_I_SHAPE (with a per-rank snapshot restored into a
    fresh service) and on MESH_II_SHAPE, run (g) on MESH_I_SHAPE, and the
    async front end led by rank 0 on MESH_I_SHAPE, each request held to
    the one-card service's digest; writes its counts to ``rank{rank}.json``."""
    torch.set_num_threads(2)
    dev = ranks.init_rank(rank, world, os.path.join(tmp, "store"), backend="gloo", timeout_s=MESH_TIMEOUT_S)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        with open(os.path.join(tmp, "refs.json")) as f:
            refs = json.load(f)
        m41, m22 = mesh_lib.make_test_mesh(*MESH_I_SHAPE), mesh_lib.make_test_mesh(*MESH_II_SHAPE)
        g = alibaba_like(seed=SEED)
        placement = distribute(g, n_sites=RPQ.n_sites, replication_rate=RPQ.replication_rate, seed=SEED)
        pl16 = distribute(g, n_sites=SHARD_SITES, replication_rate=RPQ.replication_rate, seed=SEED)
        net16 = serve_net(pl16)
        prefix = serve_stream(g)[:SERVE_PREFIX]
        cfg_h = serve_config(s2_backend="frontier_kernel_sharded", s2_tile_dtype="uint32")
        b3 = "fused_level_blocks_u32"
        rec = {"rank": rank}
        t0 = time.perf_counter()

        svc = QueryService(pl16, net16, config=cfg_h, device=dev, mesh=m41)
        _, rec["h41"] = mesh_serve_run(f"(c) rank {rank} run (h) on {MESH_I_SHAPE}", svc, prefix, refs["h"], b3)
        path = os.path.join(tmp, "stage_a.pkl")
        rec["snapshot"] = {"manifest": svc.save_plan_store(path), "bytes": os.path.getsize(persist.rank_path(path, m41))}
        collectives.agree([False], m41)  # every rank's snapshot is written
        del svc
        fresh = QueryService(pl16, net16, config=cfg_h, device=dev, mesh=m41)
        if not fresh.restore_plan_store(path):
            raise AssertionError(f"mesh (c) rank {rank}: its per-rank snapshot did not restore")
        other = persist.rank_path(path, m41).replace(f".rank{rank}", f".rank{(rank + 1) % world}")
        if persist.load_stage_a(plans.GraphPlanStore(device=dev), pl16, other, 0, m41):
            raise AssertionError(f"mesh (c) rank {rank}: another rank's share restored")
        fops.reset_build_counters()
        _, r = mesh_serve_run(f"(c) rank {rank} run (h) restored", fresh, prefix[:1], [refs["h_first"]], b3,
                              {"strategy": "S2"})
        packed = {k: fops.BUILD_COUNTERS[k] for k in ("pack_blocks", "stage_sharded_graph")}
        if any(packed.values()):
            raise AssertionError(f"mesh (c) rank {rank}: the restored service packed tiles: {packed}")
        rec["snapshot"].update(first=r, build_counters=dict(fops.BUILD_COUNTERS))
        del fresh

        svc = QueryService(pl16, net16, config=cfg_h, device=dev, mesh=m22)
        _, rec["h22"] = mesh_serve_run(f"(c) rank {rank} run (h) on {MESH_II_SHAPE}", svc, prefix, refs["h"], b3)
        del svc
        svc = QueryService(placement, serve_net(placement), config=serve_config(), device=dev, mesh=m41)
        _, rec["g41"] = mesh_serve_run(f"(c) rank {rank} run (g) on {MESH_I_SHAPE}", svc, prefix, refs["g"], None,
                                       {"strategy": "S1"})
        del svc

        # the async front end on the leader at run (e)'s 1x rate; the others follow
        svc = QueryService(pl16, net16, config=cfg_h, device=dev, mesh=m41)
        reset_launches()
        fops.FIXPOINT_COUNTERS.clear()
        collectives.WIRE_COUNTERS.clear()
        t1 = time.perf_counter()
        if svc.leader:
            got, rejected, wall, stats = asyncio.run(serve_open_loop(svc, prefix, refs["rate"], SEED + 1))
            for i, a in enumerate(got):
                if a is not None and answers_digest(a) != refs["h_answers"][i]:
                    raise AssertionError(f"mesh (c) async: request {i}'s answers differ from the one-card service's")
            done = [a for a in got if a is not None]
            rec["async_stats"] = {"rejected": dict(rejected), "wall_s": wall, "batch_window": stats["batch_window"]}
        else:
            done = [t.result() for t in svc.follow()]
        r = {"requests": len(done), "wall_s": time.perf_counter() - t1, "levels": fops.FIXPOINT_COUNTERS["levels"],
             "launches": launch_counts()[b3], "all_reduces": collectives.WIRE_COUNTERS["all_reduces"],
             "wire_bytes": collectives.WIRE_COUNTERS["bytes"], "kernel": b3,
             "digests": sorted(answer_digest(a) for a in done)}
        if r["levels"] and r["launches"] != r["levels"]:
            raise AssertionError(f"mesh (c) rank {rank} async: {r['launches']} B3 launches for {r['levels']} levels")
        rec["async"] = r
        log("mesh", f"(c) rank {rank} async on {MESH_I_SHAPE}: {r['requests']} requests resolved, {r['levels']} "
            f"levels = B3 launches, {r['all_reduces']} all_reduces, {r['wall_s']:.2f} s")
        rec["wall_s"] = time.perf_counter() - t0
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def phase_mesh_serve(handoff: dict, pl16, dev, record) -> dict[str, int]:
    """The mesh phase's (c), the service over ranks: serve run (h)'s first
    SERVE_PREFIX requests on sharded/uint32 over the 16 sites, one card at
    the ranks' axis sizes (equal to run (h) at axis 1), one NCCL rank in
    this process on a (1, 1) mesh, then MESH_RANKS ``gloo`` ranks sharing
    the card (:func:`mesh_serve_rank`); every request's digest equal to
    the serve phase's.  Returns B3's launches, every rank's summed."""
    rec = record["mesh"]["c"] = {}
    launches = collections.Counter()
    net16, prefix = serve_net(pl16), handoff["prefix"]
    cfg_h = serve_config(s2_backend="frontier_kernel_sharded", s2_tile_dtype="uint32")
    b3 = "fused_level_blocks_u32"
    refs = {k: handoff[k] for k in ("h", "g", "h_first", "h_answers", "rate")}
    t0 = time.perf_counter()
    for axis in sorted({MESH_I_SHAPE[0], MESH_II_SHAPE[0]}):
        svc = QueryService(pl16, net16, config=cfg_h, device=dev, axis_size=axis)
        _, rec[f"one_card_axis{axis}"] = mesh_serve_run(f"(c) one card run (h) at axis {axis}", svc, prefix,
                                                        refs["h"], b3)
        launches[b3] += rec[f"one_card_axis{axis}"]["launches"]
        del svc
        free()
    rec["references_s"] = time.perf_counter() - t0

    tmp = tempfile.mkdtemp(prefix="chip-smoke-mesh-serve-")
    ranks.init_rank(0, 1, os.path.join(tmp, "nccl-store"), device=dev, timeout_s=MESH_TIMEOUT_S)
    try:
        svc = QueryService(pl16, net16, config=cfg_h, device=dev, mesh=mesh_lib.make_test_mesh(1, 1))
        _, rec["a"] = mesh_serve_run("(c) NCCL 1 rank run (h)", svc, prefix, refs["h"], b3)
        launches[b3] += rec["a"]["launches"]
        del svc
    finally:
        dist.destroy_process_group()
    free()

    with open(os.path.join(tmp, "refs.json"), "w") as f:
        json.dump(refs, f)
    t0 = time.perf_counter()
    ranks.run_ranks(mesh_serve_rank, MESH_RANKS, (MESH_RANKS, tmp), timeout_s=MESH_TIMEOUT_S, device=dev)
    rec["b_s"] = time.perf_counter() - t0
    rec["ranks"] = []
    for rank in range(MESH_RANKS):
        with open(os.path.join(tmp, f"rank{rank}.json")) as f:
            rr = json.load(f)
        rec["ranks"].append(rr)
        for key in ("h41", "h22", "g41", "async"):
            launches[b3] += rr[key]["launches"]
        launches[b3] += rr["snapshot"]["first"]["launches"]
    shutil.rmtree(tmp, ignore_errors=True)
    if len({tuple(rr["async"]["digests"]) for rr in rec["ranks"]}) != 1:
        raise AssertionError("mesh (c) async: the ranks resolved different requests or answers")
    log("mesh", f"(c) {MESH_RANKS} gloo ranks sharing one card: run (h) on {MESH_I_SHAPE} and {MESH_II_SHAPE}, "
        f"run (g) on {MESH_I_SHAPE}, every request == the one-card service's on every rank; per-rank snapshots "
        f"restored (0 tiles packed), another rank's refused; the async front end led by rank 0: "
        f"{rec['ranks'][0]['async']['requests']} requests, the same on every rank; {rec['b_s']:.1f} s wall "
        "(spawn included; 4 ranks share one card, not a multi-card time)")
    return dict(launches)


def dlrm_lookups(cfg, sparse: np.ndarray, rules, mesh, modes) -> list[int]:
    """Each table's lookups that the rank hands B6 in one step: its block's
    lookups in its rows for a sharded table, its whole block for the rest."""
    lo, hi, _ = collectives.batch_block(rules, sparse.shape[0])
    out = []
    for i, rows in enumerate(cfg.padded_table_sizes):
        ids = sparse[lo:hi, i].reshape(-1)
        if modes[i] == "shard" and rules.model_axis is not None:
            k = -(-rows // rules.model_size)
            m = collectives.axis_index(mesh, rules.model_axis)
            ids = ids[(ids >= m * k) & (ids < (m + 1) * k)]
        out.append(int(ids.shape[0]))
    return out


def mesh_dlrm_case(what: str, cfg, params: dict, batch: dict, mesh, want_embs: list, want_probs, rec: dict) -> int:
    """dlrm serve_p99 on ``mesh``: the rank's shard of ``params`` (cut by
    ``shard_params``), its block's bags equal to ``want_embs``' rows bit
    for bit (multi_hot 1), MESH_DLRM_STEPS steps timed by CUDA events with
    B6 26 times a step, each on the rank's lookups (:func:`dlrm_lookups`),
    and the gathered probabilities within 1e-6 of ``want_probs``' largest.
    Returns B6's launches."""
    with shd.use_mesh(mesh):
        rules = shd.Rules.from_mesh(mesh)
        B = batch["dense"].shape[0]
        mine = dlrm.shard_params(cfg, rules, params, B)
        modes = cfg.table_modes(math.prod(shd.mesh_sizes(mesh).values()), B)
        lo, hi, _ = collectives.batch_block(rules, B)
        seen = []
        real = dlrm.embedding_bag_local

        def counted(table, idx, bags, n):
            seen.append(int(idx.shape[0]))
            return real(table, idx, bags, n)

        dlrm.embedding_bag_local = counted
        try:
            reset_launches()
            embs = dlrm.embedding_bags(cfg, rules, mine, batch["sparse"])
            n_emb = only_launched("embedding_bag_sorted", f"mesh {what} bags")
            if n_emb != cfg.n_sparse:
                raise AssertionError(f"mesh {what}: {n_emb} B6 launches for {cfg.n_sparse} tables")
            for i, (e, w) in enumerate(zip(embs, want_embs, strict=True)):
                if not torch.equal(e, w[lo:hi]):
                    raise AssertionError(f"mesh {what}: table {i}'s bags of rows [{lo}, {hi}) != the one-card bags")
            want_seen = dlrm_lookups(cfg, batch["sparse"].cpu().numpy(), rules, mesh, modes)
            if seen != want_seen:
                raise AssertionError(f"mesh {what}: B6 got {seen} lookups, the rank's are {want_seen}")
            del embs
            collectives.WIRE_COUNTERS.clear()
            serve = dlrm.make_serve_step(cfg, rules)
            r, outs = timed_steps("mesh", what, lambda b: serve(mine, b), [batch] * (MESH_DLRM_STEPS + DLRM_WARMUP),
                                  "embedding_bag_sorted", cfg.n_sparse, DLRM_WARMUP)
        finally:
            dlrm.embedding_bag_local = real
    err = max(float((o - want_probs).abs().max()) for o in outs)
    scale = float(want_probs.abs().max())
    if err > 1e-6 * scale:
        raise AssertionError(f"mesh {what}: probabilities {err} from the one-card run's (limit 1e-6 x {scale})")
    per_step = {k: v // (MESH_DLRM_STEPS + DLRM_WARMUP) for k, v in collectives.WIRE_COUNTERS.items()}
    r.update({"batch_block": [lo, hi], "sharded_tables": modes.count("shard"), "lookups_per_table": seen,
              "max_abs_err": err, "bit_equal": all(torch.equal(o, want_probs) for o in outs),
              "all_reduces_per_step": per_step.get("all_reduces", 0), "bytes_per_step": per_step.get("bytes", 0)})
    rec[what] = r
    log("mesh", f"(d) {what}: rows [{lo}, {hi}) of {B}, {r['sharded_tables']} tables row-sharded, the rank's B6 "
        f"lookups {sum(seen)}; bags == the one-card bags bit for bit; {r['steps']} steps, {r['launches']} B6 "
        f"launches = 26 a step; median {r['median_ms']:.4f} ms, p99 {r['p99_ms']:.4f} ms; "
        f"{r['all_reduces_per_step']} all_reduces, {r['bytes_per_step']} bytes a step; probabilities within "
        f"{err} of the one-card run's (bit-equal: {r['bit_equal']})")
    return r["launches"] + n_emb


def phase_mesh_dlrm(params: dict, dev, record) -> int:
    """The mesh phase's (d) on one NCCL rank: dlrm-mlperf ``full()`` at
    serve_p99 on a (1, 1) mesh, on the dlrm phase's parameters (the rank's
    shard of every table is the whole table), against the one-card step.
    Returns B6's launches."""
    rec = record["mesh"].setdefault("d", {})
    batch = pipeline.dlrm_batch(DLRM.table_sizes, DLRM.n_dense, DLRM.multi_hot,
                                registry.RECSYS_SHAPES["serve_p99"].dims["batch"], 30_000, seed=SEED, device=dev)
    rules = shd.Rules.from_mesh(None)
    want_embs = dlrm.embedding_bags(DLRM, rules, params, batch["sparse"])
    want = dlrm.make_serve_step(DLRM, rules)(params, batch)
    reset_launches()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-mesh-dlrm-")
    ranks.init_rank(0, 1, os.path.join(tmp, "nccl-store"), device=dev, timeout_s=MESH_TIMEOUT_S)
    try:
        n = mesh_dlrm_case("dlrm serve_p99, NCCL 1 rank, full width", DLRM, params, batch,
                           mesh_lib.make_test_mesh(1, 1), want_embs, want, rec)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    del want_embs, want, batch
    free()
    return n


def mesh_retrieval_case(what: str, cfg, params: dict, batch: dict, mesh, want: tuple, rec: dict) -> int:
    """dlrm retrieval_cand on ``mesh``: the rank's shard of the tables at
    batch 1 and its block of the candidates over every axis, fitted as
    ``repro`` fits them (``collectives.flat_block``), handed as that block
    (``batch``, the whole query, is emptied);
    MESH_RETRIEVAL_STEPS steps timed by CUDA events, B6 26 times a step;
    the gathered top 64's scores within 1e-6 of the largest of ``want``'s
    (the one-card (scores, indices, every candidate's score)) and its
    indices equal up to ties.  Returns B6's launches."""
    n = batch["candidates"].shape[0]
    with shd.use_mesh(mesh):
        rules = shd.Rules.from_mesh(mesh)
        mine = dlrm.shard_params(cfg, rules, params, 1)
        lo, hi, axes = collectives.flat_block(rules, n)
        block = dict(batch, candidates=batch["candidates"][lo:hi].clone())
        batch.clear()  # the whole candidates: the rank holds its block alone
        free()
        step = dlrm.make_retrieval_step(cfg, rules, n)
        collectives.WIRE_COUNTERS.clear()
        r, outs = timed_steps("mesh", what, lambda b: step(mine, b), [block] * (MESH_RETRIEVAL_STEPS + DLRM_WARMUP),
                              "embedding_bag_sorted", cfg.n_sparse, DLRM_WARMUP)
    w_scores, w_idx, all_scores = (t.cpu() for t in want)
    scores, idx = (t.cpu() for t in outs[0])
    err, scale = float((scores - w_scores).abs().max()), float(w_scores.abs().max())
    gap = float((all_scores[idx] - all_scores[w_idx]).abs().max())
    if err > 1e-6 * scale or gap > 1e-6 * float(all_scores.abs().max()) or any(
            not torch.equal(o[1], outs[0][1]) for o in outs):
        raise AssertionError(f"mesh {what}: the top 64 differ from the one-card top 64 (scores {err}, tied "
                             f"scores {gap}; limit 1e-6 x {scale})")
    steps = MESH_RETRIEVAL_STEPS + DLRM_WARMUP
    free_b, total_b = torch.cuda.mem_get_info()
    r.update({"candidates": n, "block": [lo, hi], "axes": list(axes), "max_abs_err": err,
              "rank_peak_gb": torch.cuda.max_memory_allocated() / 1e9, "card_free_gb": free_b / 1e9,
              "card_gb": total_b / 1e9,
              "indices_equal": bool(torch.equal(idx, w_idx)),
              "all_gathers_per_step": collectives.WIRE_COUNTERS["all_gather"] // steps,
              "bytes_per_step": collectives.WIRE_COUNTERS["bytes"] // steps})
    rec[what] = r
    log("mesh", f"(d) {what}: candidates [{lo}, {hi}) of {n} over {list(axes)} (repro's fit of (data, model)); "
        f"{r['steps']} steps, {r['launches']} B6 launches = 26 a step, {r['all_gathers_per_step']} all_gathers and "
        f"{r['bytes_per_step']} bytes a step, median {r['median_ms']:.3f} ms; the top 64's scores within {err} of "
        f"the one-card top 64 (limit 1e-6 x {scale}), indices {'equal' if r['indices_equal'] else 'equal up to ties'}; "
        f"{r['rank_peak_gb']:.2f} GB peak allocated by the rank so far, {r['card_free_gb']:.2f} of the card's "
        f"{r['card_gb']:.2f} GB free after its steps (every process)")
    return r["launches"]


def mesh_model_inputs(dev) -> dict:
    """The (d) spawn's models, rebuilt from the seed on every rank and in
    the parent: dlrm-mlperf with tables capped at MESH_DLRM_CAP rows, a
    serve_p99 batch and a retrieval_cand query with its 1,000,000 f32
    candidates drawn from a generator seeded SEED + 23; gcn-cora at
    ogb_products on edges drawn from a generator seeded SEED + 11;
    schnet, nequip and equiformer-v2 ``full()`` at molecule."""
    cfg = dataclasses.replace(DLRM, table_sizes=tuple(min(r, MESH_DLRM_CAP) for r in DLRM.table_sizes))
    shape = registry.GNN_SHAPES["ogb_products"]
    gcn_cfg = gnn_common.gcn_for_shape(registry.get_arch("gcn-cora").full(), shape)
    n, e, _ = gnn_common.shape_counts(shape)
    e_pad = gnn_common.pad_edges(e)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 11)
    src = torch.randint(0, n, (e_pad,), generator=gen, device=dev, dtype=torch.int32)
    dst = torch.randint(0, n, (e_pad,), generator=gen, device=dev, dtype=torch.int32)
    src[e:], dst[e:] = 0, 0
    gcn_batch = {"node_feat": torch.randn((n, gcn_cfg.d_feat), generator=gen, device=dev),
                 "edge_src": src, "edge_dst": dst, "edge_mask": torch.arange(e_pad, device=dev) < e,
                 "node_mask": torch.ones(n, dtype=torch.bool, device=dev)}
    d = registry.GNN_SHAPES["molecule"].dims
    query = pipeline.dlrm_batch(cfg.table_sizes, cfg.n_dense, cfg.multi_hot, 1, 40_000, seed=SEED, device=dev)
    gen.manual_seed(SEED + 23)
    n_cand = registry.RECSYS_SHAPES["retrieval_cand"].dims["n_candidates"]
    query["candidates"] = torch.randn((n_cand, cfg.embed_dim), generator=gen, device=dev)
    return {
        "dlrm": (cfg, pipeline.dlrm_batch(cfg.table_sizes, cfg.n_dense, cfg.multi_hot,
                                          registry.RECSYS_SHAPES["serve_p99"].dims["batch"], 30_000, seed=SEED,
                                          device=dev)),
        "retrieval": query,
        "gcn": (gcn_cfg, gcn_batch),
        "molecule": pipeline.molecules_batch(d["batch"], d["n_nodes"], d["n_edges"], seed=SEED, device=dev),
    }


def equiformer_graph(cfg, n: int, e: int, seed: int, dev) -> dict:
    """A uniform graph for ``equiformer_energy_big``, drawn from ``seed``
    on the card: ``n`` nodes at positions uniform in a cube of side
    EQ_BOX, species uniform; ``e`` edges between uniform endpoints,
    padded with masked edges to whole chunks of ``gnn._BIG_CHUNK`` edges
    when ``e`` passes one chunk."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    chunk = gnn._BIG_CHUNK
    e_pad = e if e <= chunk else -(-e // chunk) * chunk
    return {"species": torch.randint(0, cfg.n_species, (n,), generator=gen, device=dev, dtype=torch.int32),
            "positions": torch.rand((n, 3), generator=gen, device=dev) * EQ_BOX,
            "node_mask": torch.ones(n, dtype=torch.bool, device=dev),
            "edge_src": torch.randint(0, n, (e_pad,), generator=gen, device=dev, dtype=torch.int32),
            "edge_dst": torch.randint(0, n, (e_pad,), generator=gen, device=dev, dtype=torch.int32),
            "edge_mask": torch.arange(e_pad, device=dev) < e}


def big_equiformer_against_plain(cfg, params: dict, rules, graphs: dict, out: dict) -> tuple[int, dict]:
    """On the installed (1, 1) mesh: ``equiformer_atoms_big`` on each of
    ``graphs`` (B6 launches 2 x chunks x layers) against its plain twin
    ``equiformer_atoms_big_plain`` on the same card: the energy within
    EQ_TOL of the twin's, every node's energy within EQ_ATOM_TOL of the
    twin's largest.  Returns (B6's launches, the energies)."""
    launches, energies = 0, {}
    for name, graph in graphs.items():
        chunks = graph["edge_src"].shape[0] // gnn._BIG_CHUNK or 1
        want = gnn.equiformer_atoms_big_plain(cfg, params, graph)
        collectives.WIRE_COUNTERS.clear()
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        atoms = gnn.equiformer_atoms_big(cfg, rules, params, graph)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = only_launched("embedding_bag_sorted", f"mesh (e) {name} graph")
        e, e_want = atoms.sum(dtype=torch.float64), want.sum(dtype=torch.float64)
        errs = {"energy": float((e - e_want).abs() / e_want.abs()),
                "atoms": float((atoms - want).abs().max() / want.abs().max())}
        if n != 2 * chunks * cfg.n_layers or atoms.shape != want.shape or not torch.isfinite(atoms).all():
            raise AssertionError(f"mesh (e) {name}: {n} B6 launches (expected 2 x {chunks} x {cfg.n_layers}), "
                                 f"atom energies {tuple(atoms.shape)} against {tuple(want.shape)}")
        limits = {"energy": EQ_TOL, "atoms": EQ_ATOM_TOL}
        if any(errs[k] > limits[k] for k in errs):
            raise AssertionError(f"mesh (e) {name}: the big path differs from its plain twin by {errs} of the "
                                 f"largest (limits {limits})")
        out[name] = {"nodes": graph["species"].shape[0], "edges": int(graph["edge_mask"].sum()),
                     "edges_padded": graph["edge_src"].shape[0], "chunks": chunks, "energy": float(e),
                     "plain_energy": float(e_want), "rel_err": errs, "limits": limits, "wall_s": wall,
                     "b6_launches": n}
        log("mesh", f"(e) {name} graph ({out[name]['nodes']} nodes, {out[name]['edges']} edges padded to "
            f"{out[name]['edges_padded']}, {chunks} chunk(s)): equiformer_atoms_big energy {float(e):.6f} against "
            f"the plain twin's {float(e_want):.6f} (rel {errs['energy']:.2e}, limit {EQ_TOL}), every node's "
            f"energy within {errs['atoms']:.2e} of the twin's largest (limit {EQ_ATOM_TOL}); {n} B6 launches, "
            f"{wall:.2f} s")
        launches += n
        energies[name] = atoms.sum()[None]
        del want, atoms
    return launches, energies


def mesh_big_equiformer(dev, tmp: str, rec: dict) -> tuple[int, torch.Tensor]:
    """The mesh_models phase's (e) on one NCCL rank in this process, a (1,
    1) mesh: equiformer-v2 ``full()`` through ``equiformer_energy`` on the
    EQ_BIG_NODES-node graph (it dispatches to ``equiformer_energy_big``: B6
    launches 2 x chunks x layers), then :func:`big_equiformer_against_plain`
    on the small graph (one chunk) and the multi graph (EQ_SMALL_NODES
    nodes, EQ_MULTI_EDGES edges: several chunks, the last padded with
    masked edges).  Returns (B6's launches, the small graph's energy)."""
    cfg = registry.get_arch("equiformer-v2").full()
    params = gnn.equiformer_init(cfg, seed=SEED, device=dev)
    small = equiformer_graph(cfg, EQ_SMALL_NODES, EQ_SMALL_EDGES, SEED + 13, dev)
    multi = equiformer_graph(cfg, EQ_SMALL_NODES, EQ_MULTI_EDGES, SEED + 19, dev)
    degree = OGB_EDGES / OGB_NODES
    big = equiformer_graph(cfg, EQ_BIG_NODES, round(EQ_BIG_NODES * degree), SEED + 17, dev)
    chunks = big["edge_src"].shape[0] // gnn._BIG_CHUNK
    out = rec.setdefault("e", {})
    ranks.init_rank(0, 1, os.path.join(tmp, "store_e"), device=dev, timeout_s=MESH_TIMEOUT_S)
    try:
        mesh = mesh_lib.make_test_mesh(1, 1)
        with shd.use_mesh(mesh):
            rules = shd.Rules.from_mesh(mesh)
            collectives.WIRE_COUNTERS.clear()
            reset_launches()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            e = gnn.equiformer_energy(cfg, rules, params, big)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = only_launched("embedding_bag_sorted", "mesh (e) big graph")
            if n != 2 * chunks * cfg.n_layers or e.shape != (1,) or not torch.isfinite(e).all():
                raise AssertionError(f"mesh (e) big: {n} B6 launches (expected 2 x {chunks} x {cfg.n_layers}), "
                                     f"energy {e}")
            out["big"] = {"nodes": EQ_BIG_NODES, "edges": int(big["edge_mask"].sum()),
                          "edges_padded": big["edge_src"].shape[0], "chunks": chunks, "energy": float(e),
                          "wall_s": wall, "b6_launches": n, "all_reduces": collectives.WIRE_COUNTERS["all_reduces"],
                          "bytes": collectives.WIRE_COUNTERS["bytes"],
                          "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
            del big
            free()
            plain_launches, energies = big_equiformer_against_plain(cfg, params, rules,
                                                                    {"small": small, "multi": multi}, out)
    finally:
        dist.destroy_process_group()
    b = out["big"]
    log("mesh", f"(e) equiformer-v2 full() on one NCCL rank, (1, 1): {b['nodes']} nodes, {b['edges']} uniform edges "
        f"(ogb_products' mean degree {degree:.2f}; {b['edges_padded']} padded, {chunks} chunks): equiformer_energy "
        f"took the big path, {b['b6_launches']} B6 launches = 2 x chunks x layers, energy {b['energy']:.4f}, "
        f"{b['wall_s']:.1f} s, {b['peak_gb']:.2f} GB peak")
    del params, small, multi
    free()
    return b["b6_launches"] + plain_launches, energies["small"].cpu()


def gnn_degrees(batch: dict, rules) -> tuple:
    """GCN's in- and out-degrees without the self loop, on the installed
    mesh over the rank's block of edges (2 B6 launches)."""
    src, dst, emask = gnn.edge_block(rules, batch["edge_src"], batch["edge_dst"], batch["edge_mask"])
    ones = emask.to(torch.float32)[:, None]
    n = batch["node_feat"].shape[0]
    return (gnn.scatter_sum(ones, gnn.sort_edges(dst), n, rules), gnn.scatter_sum(ones, gnn.sort_edges(src), n, rules))


MOLECULAR = ("schnet", "nequip", "equiformer-v2")


def mesh_gnn_case(what: str, cfg, params: dict, batch: dict, mesh, want, tol: float, rec: dict) -> int:
    """One GNN serve step on ``mesh`` (edges blocked over its ranks, one
    psum an axis a scatter): within ``tol`` of ``want``'s largest |output|,
    B6 launching its scatters a step; wall ms by CUDA events.  Returns
    B6's launches."""
    with shd.use_mesh(mesh):
        rules = shd.Rules.from_mesh(mesh)
        step = gnn.make_gnn_serve_step(cfg, rules)
        collectives.WIRE_COUNTERS.clear()
        r, outs = timed_steps("mesh", what, lambda _: step(params, batch), [None] * (1 + GNN_WARMUP),
                              "embedding_bag_sorted", gnn_scatters(cfg), GNN_WARMUP)
    err, scale = float((outs[0] - want).abs().max()), float(want.abs().max())
    if err > tol * scale:
        raise AssertionError(f"mesh {what}: max |diff| {err} from the one-card run > {tol} x {scale}")
    steps = 1 + GNN_WARMUP
    r.update({"max_abs_err": err, "limit": tol * scale,
              "all_reduces_per_step": collectives.WIRE_COUNTERS["all_reduces"] // steps,
              "bytes_per_step": collectives.WIRE_COUNTERS["bytes"] // steps})
    rec[what] = r
    log("mesh", f"(d) {what}: {r['launches']} B6 launches = {gnn_scatters(cfg)} scatters a step, "
        f"{r['all_reduces_per_step']} all_reduces and {r['bytes_per_step']} bytes a step, {r['median_ms']:.3f} ms; "
        f"within {err} of the one-card run (limit {tol} x {scale})")
    return r["launches"]


def wait_for(path: str, failed: str, timeout_s: float = MESH_TIMEOUT_S) -> str:
    """``path`` once another process has written it; raises if ``failed``
    appears first or after ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if os.path.exists(failed) or time.monotonic() > deadline:
            raise RuntimeError(f"{path} was not written: the process making it failed or took over {timeout_s} s")
        time.sleep(0.2)
    return path


def mesh_models_rank(rank: int, world: int, tmp: str) -> None:
    """One of the MESH_RANKS ``gloo`` ranks of the mesh phase's (d):
    dlrm-mlperf capped at serve_p99 on MESH_II_SHAPE, gcn-cora at
    ogb_products on MESH_I_SHAPE (its degrees exact), the molecular GNNs
    on MESH_II_SHAPE, each held to the parent's one-card run; writes its
    counts to ``rank{rank}.json``."""
    torch.set_num_threads(2)
    dev = ranks.init_rank(rank, world, os.path.join(tmp, "store"), backend="gloo", timeout_s=MESH_TIMEOUT_S)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        refs = torch.load(os.path.join(tmp, "refs.pt"), map_location=dev)
        m41, m22 = mesh_lib.make_test_mesh(*MESH_I_SHAPE), mesh_lib.make_test_mesh(*MESH_II_SHAPE)
        inputs = mesh_model_inputs(dev)
        rec = {"rank": rank}
        t0 = time.perf_counter()
        cfg, batch = inputs.pop("dlrm")
        params = dlrm.init_params(cfg, seed=SEED, device=dev)
        launches = mesh_dlrm_case(f"dlrm serve_p99 capped, rank {rank} of {MESH_II_SHAPE}", cfg, params, batch, m22,
                                  refs["dlrm_embs"], refs["dlrm_probs"], rec)
        launches += mesh_retrieval_case(f"dlrm retrieval_cand capped, rank {rank} of {MESH_II_SHAPE}", cfg, params,
                                        inputs.pop("retrieval"), m22, refs["retrieval"], rec)
        del batch, params
        free()
        cfg, batch = inputs.pop("gcn")
        params = gnn.gcn_init(cfg, seed=SEED, device=dev)
        with shd.use_mesh(m41):
            reset_launches()
            degs = gnn_degrees(batch, shd.Rules.from_mesh(m41))
            launches += only_launched("embedding_bag_sorted", "mesh gcn degrees")
        if not all(torch.equal(a, b) for a, b in zip(degs, refs["gcn_degrees"], strict=True)):
            raise AssertionError(f"mesh (d) rank {rank}: GCN's degrees over ranks != the one-card degrees")
        launches += mesh_gnn_case(f"gcn ogb_products, rank {rank} of {MESH_I_SHAPE}", cfg, params, batch, m41,
                                  refs["gcn"], GNN_TOL, rec)
        del batch, params, degs
        free()
        batch = inputs.pop("molecule")
        for arch in MOLECULAR:
            cfg = registry.get_arch(arch).full()
            launches += mesh_gnn_case(f"{arch} molecule, rank {rank} of {MESH_II_SHAPE}", cfg,
                                      gnn.INIT_FNS[arch](cfg, seed=SEED, device=dev), batch, m22, refs[arch],
                                      GNN_TOL_EQUIFORMER if arch == "equiformer-v2" else GNN_TOL, rec)
        del batch
        free()
        # (e) equiformer_energy_big on the small graph, node state over (data, model)
        cfg = registry.get_arch("equiformer-v2").full()
        small = equiformer_graph(cfg, EQ_SMALL_NODES, EQ_SMALL_EDGES, SEED + 13, dev)
        params = gnn.equiformer_init(cfg, seed=SEED, device=dev)
        with shd.use_mesh(m22):
            collectives.WIRE_COUNTERS.clear()
            reset_launches()
            t1 = time.perf_counter()
            e = gnn.equiformer_energy_big(cfg, shd.Rules.from_mesh(m22), params, small)
            torch.cuda.synchronize()
            n = only_launched("embedding_bag_sorted", f"mesh (e) rank {rank}")
        want = torch.load(wait_for(os.path.join(tmp, "big_small.pt"), os.path.join(tmp, "big_small.failed"))).to(dev)
        err, scale = float((e - want).abs()), float(want.abs())
        if n != 2 * cfg.n_layers or not torch.isfinite(e).all() or err > EQ_TOL * scale:
            raise AssertionError(f"mesh (e) rank {rank}: {n} B6 launches, energy {float(e)} against one NCCL "
                                 f"rank's {float(want)} (limit {EQ_TOL} of it)")
        rec["big_equiformer"] = {"energy": float(e), "rel_err": err / scale, "b6_launches": n,
                                 "wall_s": time.perf_counter() - t1,
                                 "all_reduces": collectives.WIRE_COUNTERS["all_reduces"],
                                 "bytes": collectives.WIRE_COUNTERS["bytes"]}
        launches += n
        rec.update(b6_launches=launches, wall_s=time.perf_counter() - t0,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def phase_mesh_models(dev, record) -> int:
    """The mesh phase's (d) over MESH_RANKS ``gloo`` ranks sharing the card
    (:func:`mesh_models_rank`): the one-card runs of its models here
    first, saved for the ranks; then the ranks and, beside them, (e) on
    one NCCL rank in this process (:func:`mesh_big_equiformer`), whose
    small-graph energy the ranks' own (e) is held to.  Returns B6's
    launches, every rank's summed."""
    rec = record["mesh"].setdefault("d", {})
    tmp = tempfile.mkdtemp(prefix="chip-smoke-mesh-models-")
    t0 = time.perf_counter()
    inputs = mesh_model_inputs(dev)
    none = shd.Rules.from_mesh(None)
    cfg, batch = inputs["dlrm"]
    params = dlrm.init_params(cfg, seed=SEED, device=dev)
    refs = {"dlrm_embs": [e.cpu() for e in dlrm.embedding_bags(cfg, none, params, batch["sparse"])],
            "dlrm_probs": dlrm.make_serve_step(cfg, none)(params, batch).cpu()}
    query = inputs.pop("retrieval")
    user = torch.stack([dlrm._mlp_apply(params["bot"], query["dense"])[0]] + [
        e[0].float() for e in dlrm.embedding_bags(cfg, none, params, query["sparse"][:1])]).mean(0)
    scores, idx = dlrm.make_retrieval_step(cfg, none)(params, query)
    refs["retrieval"] = (scores.cpu(), idx.cpu(), (query["candidates"] @ user).cpu())
    del query, user
    rec["dlrm_tables"] = {"rows": sum(cfg.padded_table_sizes), "bytes": tree_bytes(params["tables"]),
                          "cap": MESH_DLRM_CAP}
    del params
    cfg, batch = inputs["gcn"]
    params = gnn.gcn_init(cfg, seed=SEED, device=dev)
    with shd.use_mesh(None):
        refs["gcn_degrees"] = [d.cpu() for d in gnn_degrees(batch, none)]
    refs["gcn"] = gnn.make_gnn_serve_step(cfg, none)(params, batch).cpu()
    del params, inputs["gcn"], batch
    for arch in MOLECULAR:
        cfg = registry.get_arch(arch).full()
        refs[arch] = gnn.make_gnn_serve_step(cfg, none)(gnn.INIT_FNS[arch](cfg, seed=SEED, device=dev),
                                                        inputs["molecule"]).cpu()
    del inputs
    free()
    torch.save(refs, os.path.join(tmp, "refs.pt"))
    rec["references_s"] = time.perf_counter() - t0
    del refs
    # the ranks start on (d) while this process runs (e) on one NCCL rank,
    # whose small-graph energy they wait for at their own (e)
    t0 = time.perf_counter()
    spawn: dict = {}

    def run() -> None:
        try:
            ranks.run_ranks(mesh_models_rank, MESH_RANKS, (MESH_RANKS, tmp), timeout_s=MESH_TIMEOUT_S, device=dev)
        except BaseException as err:  # raised below, after this process's (e)
            spawn["err"] = err

    thread = threading.Thread(target=run, name="mesh_models ranks")
    thread.start()
    try:
        big_launches, big_small = mesh_big_equiformer(dev, tmp, record["mesh"])
        record["mesh"]["e"]["one_rank_s"] = time.perf_counter() - t0
        torch.save(big_small, os.path.join(tmp, "big_small.tmp"))
        os.rename(os.path.join(tmp, "big_small.tmp"), os.path.join(tmp, "big_small.pt"))
    except BaseException:
        open(os.path.join(tmp, "big_small.failed"), "w").close()  # the ranks stop waiting
        raise
    finally:
        thread.join()
    if "err" in spawn:
        raise spawn["err"]
    rec["b_s"] = time.perf_counter() - t0
    rec["ranks"] = []
    for rank in range(MESH_RANKS):
        with open(os.path.join(tmp, f"rank{rank}.json")) as f:
            rec["ranks"].append(json.load(f))
    shutil.rmtree(tmp, ignore_errors=True)
    launches = big_launches + sum(rr["b6_launches"] for rr in rec["ranks"])
    for rr in rec["ranks"]:
        be = rr["big_equiformer"]
        log("mesh", f"(e) rank {rr['rank']} of {MESH_II_SHAPE}: equiformer_energy_big on the small graph "
            f"{be['energy']:.6f} (rel {be['rel_err']:.2e} from one NCCL rank's, limit {EQ_TOL}); "
            f"{be['b6_launches']} B6 launches; {be['all_reduces']} all_reduces, {be['bytes']} bytes; "
            f"{be['wall_s']:.1f} s (not a multi-card time)")
    log("mesh", f"(d) {MESH_RANKS} gloo ranks sharing one card: dlrm serve_p99 and retrieval_cand capped at "
        f"{MESH_DLRM_CAP} rows on {MESH_II_SHAPE}, gcn ogb_products on {MESH_I_SHAPE} (degrees exact), schnet, nequip, "
        "equiformer-v2 at "
        f"molecule and (e) equiformer_energy_big on {MESH_II_SHAPE}: every output within tolerance of the one-card "
        f"run on every rank; {launches} B6 "
        f"launches; {rec['b_s']:.1f} s wall (spawn included; not a multi-card time); the ranks' peaks allocated "
        f"{[round(rr['peak_gb'], 2) for rr in rec['ranks']]} GB, this process's {torch.cuda.max_memory_allocated() / 1e9:.2f}")
    return launches


def check_schema(d: dict, schema: dict, path: str = "summary") -> None:
    """``d`` has exactly the keys of ``schema``, recursively where the
    schema holds keys (a None leaf is any value, {} any keys)."""
    if set(d) != set(schema):
        raise AssertionError(f"{path}: keys {sorted(d)} != repro's {sorted(schema)}")
    for k, sub in schema.items():
        if sub:
            check_schema(d[k], sub, f"{path}.{k}")


def serve_oracle(g, dg, stream) -> dict:
    """The device BFS's answer set of every (query, start) of ``stream``."""
    starts_of: dict[str, set] = {}
    for wq in stream:
        starts_of.setdefault(wq.query, set()).update(wq.starts.tolist())
    out = {}
    for q, starts in starts_of.items():
        s = np.array(sorted(starts), np.int32)
        src, dst = paa.answers_multi_source(paa.compile_query(q, g), dg, s)
        out.update({(q, v): set() for v in s.tolist()})
        for a, b in zip(src.tolist(), dst.tolist()):
            out[(q, a)].add(b)
    return out


def check_serve_answers(answers, stream, oracle, what: str) -> None:
    for wq, ans in zip(stream, answers, strict=True):
        for s, got in zip(wq.starts.tolist(), ans.answers, strict=True):
            if got != oracle[(wq.query, s)]:
                raise AssertionError(f"{what}: {wq.query!r} from {s} differs from the device BFS")


class ServeTimers:
    """Host ms of the service's layers over one run, by wrapping its
    calls: plan (``_plan``), Stage A (the plan store's ``staged_graph``
    and ``staged_sharded``, and the bytes of the distinct stagings they
    returned: the full store once, each out-of-core assembly, or the
    per-site slabs), S2 batching
    (``run_s2_group`` less the executions inside it), S2 execution
    (``s2_execute``), the S1 gather (``s1_collect``) and feedback
    (``calibrator.observe``)."""

    def __init__(self, svc):
        self.ms = collections.Counter()
        self.staged: dict[int, int] = {}
        self._undo = []
        self._wrap(svc, "_plan", "plan")
        self._wrap(svc.calibrator, "observe", "feedback")
        self._wrap(svc.plan_store, "staged_graph", "stage_a")
        self._wrap(svc.plan_store, "staged_sharded", "stage_a")
        self._wrap(strategies, "s2_execute", "s2_execute")
        self._wrap(strategies, "s1_collect", "s1_gather")
        self._wrap(batcher, "run_s2_group", "s2_group")

    def _wrap(self, obj, attr: str, key: str) -> None:
        fn = getattr(obj, attr)

        def timed_fn(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
            finally:
                self.ms[key] += (time.perf_counter() - t0) * 1e3
            if key == "stage_a":
                self.staged[id(out)] = out.tile_store_bytes
            return out

        self._undo.append((obj, attr, obj.__dict__.get(attr)))  # a module's own, or None
        setattr(obj, attr, timed_fn)

    def stop(self) -> dict:
        for obj, attr, own in self._undo:
            if own is None:
                delattr(obj, attr)  # the instance's method again
            else:
                setattr(obj, attr, own)
        out = {k: self.ms[k] for k in ("plan", "stage_a", "s2_execute", "s1_gather", "feedback")}
        out["s2_batch"] = self.ms["s2_group"] - self.ms["s2_execute"]
        out["staged_bytes"] = sum(self.staged.values())
        return out


def serve_stats(answers, wall_s: float) -> dict:
    lat = np.array([a.latency_s for a in answers]) * 1e3
    return {"requests": len(answers), "wall_s": wall_s, "queries_per_s": len(answers) / wall_s,
            "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
            "strategies": dict(collections.Counter(a.strategy for a in answers)),
            "plan_cache_hits": sum(a.plan_cache_hit for a in answers)}


def serve_sync(svc, stream, first_window: dict | None = None, **kw) -> tuple[list, dict]:
    """``stream`` through ``svc`` in windows of SERVE_WINDOW requests
    (enqueue the window, flush), timed and with its layers timed apart;
    the launch counts are set to 0 just before.  ``first_window`` adds
    its keywords to the first window's enqueues (``strategy="S1"``)."""
    timers = ServeTimers(svc)
    reset_launches()
    fops.FIXPOINT_COUNTERS.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    answers = []
    for lo in range(0, len(stream), SERVE_WINDOW):
        win_kw = {**kw, **(first_window or {})} if lo == 0 else kw
        tickets = [svc.enqueue(wq.query, wq.starts, **win_kw) for wq in stream[lo : lo + SERVE_WINDOW]]
        svc.flush()
        answers += [t.result() for t in tickets]
    torch.cuda.synchronize()
    r = serve_stats(answers, time.perf_counter() - t0)
    r["layers_ms"] = timers.stop()
    return answers, r


def serve_launched(name: str, what: str, buckets: int = 1) -> dict:
    """The run's launches of level kernel ``name``: nonzero,
    LEVELS_PER_CHECK per body of the one-card fixpoints (and per shape
    bucket, on the sharded backend), and no other kernel."""
    n = only_launched(name, what)
    check_loop_launches(n, what, buckets)
    c = fops.FIXPOINT_COUNTERS
    return {"kernel": name, "launches": n, "levels": c["levels"], "bodies": c["bodies"],
            "host_syncs": c["host_syncs"], "fixpoints": c["fixpoints"]}


def log_serve(run: str, r: dict) -> None:
    lay = r.get("layers_ms", {})
    log("serve", f"({run}): {r['requests']} requests in {r['wall_s']:.2f} s = {r['queries_per_s']:.2f} q/s, "
        f"latency p50 {r['p50_ms']:.1f} ms, p99 {r['p99_ms']:.1f} ms; strategies {r['strategies']}, "
        f"{r['plan_cache_hits']} plan-cache hits; {r.get('launches', 0)} {r.get('kernel', '-')} launches "
        f"({r.get('levels', 0)} BFS levels, {r.get('bodies', 0)} bodies of {fops.LEVELS_PER_CHECK}, "
        f"{r.get('host_syncs', 0)} host syncs); host ms: plan {lay.get('plan', 0):.1f}, Stage A "
        f"{lay.get('stage_a', 0):.1f} "
        f"({lay.get('staged_bytes', 0) / 1e9:.3f} GB staged), S2 batch {lay.get('s2_batch', 0):.1f}, "
        f"S2 execute {lay.get('s2_execute', 0):.1f}, S1 gather {lay.get('s1_gather', 0):.1f}, "
        f"feedback {lay.get('feedback', 0):.1f}")


async def serve_open_loop(svc, stream, rate_qps: float, seed: int) -> tuple:
    """``stream`` at Poisson arrivals of ``rate_qps`` through an
    ``AsyncQueryService`` (serve_async.py's tenants, SLO mix and knobs);
    the generator never waits for the server."""
    rng = np.random.default_rng(seed)
    answers, rejected = [None] * len(stream), collections.Counter()
    async with AsyncQueryService(svc, AioConfig(**SERVE_AIO)) as aio:

        async def one(i, wq, tenant, slo):
            try:
                answers[i] = await aio.submit(wq.query, wq.starts, tenant=tenant, slo=slo)
            except AdmissionRejected as e:
                rejected[e.reason] += 1

        tasks = []
        t0 = time.perf_counter()
        for i, wq in enumerate(stream):
            await asyncio.sleep(float(rng.exponential(1.0 / rate_qps)))
            slo = "latency" if rng.random() < SERVE_LATENCY_SHARE else "throughput"
            tasks.append(asyncio.ensure_future(one(i, wq, SERVE_TENANTS[i % len(SERVE_TENANTS)], slo)))
        await asyncio.gather(*tasks)
        wall = time.perf_counter() - t0
        stats = aio.aio_stats()
    return answers, rejected, wall, stats


def serve_config(**kw) -> ServeConfig:
    """The serve phase's ``ServeConfig``: SERVE_ROLLOUTS rollouts from SEED."""
    return ServeConfig(n_rollouts=SERVE_ROLLOUTS, seed=SEED, **kw)


def serve_stream(g) -> list:
    """The serve phase's seeded 144-request stream (serve_async.py's size)."""
    return generate(g, WorkloadConfig(n_queries=SERVE_QUERIES, hot_pool=8, hot_fraction=0.8,
                                      min_starts=1, max_starts=8, seed=SEED))


def serve_net(placement):
    """The network parameters probed on the plan phase's overlay for ``placement``."""
    return planner.probe_network(random_overlay(placement.n_sites, PLAN_DEGREE, seed=PLAN_SEED), placement,
                                 seed=PLAN_SEED)


def answer_digest(a) -> str:
    """A resolved request's digest: its query, strategy, semantics,
    answers, every cost field (per-site meters included) and witness
    levels."""
    return digest(a.query, a.strategy, a.semantics, [sorted(s) for s in a.answers],
                  [dataclasses.astuple(c) for c in a.observed], "none" if a.levels is None else a.levels)


def answers_digest(a) -> str:
    """A resolved request's answer sets alone."""
    return digest([sorted(s) for s in a.answers])


def load_example(name: str):
    """``examples/<name>.py`` of this checkout as a module (its
    ``main(argv)`` not run)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, Path(__file__).resolve().parent / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_examples(record) -> None:
    """The port's example scripts on the card (their default device):
    the quickstart, and the plan-and-serve driver at ``--small`` on q1 and
    q6, whose every start must print ``OK`` against the PAA oracle and
    none ``MISMATCH``.  Their output is logged line by line."""
    rec = record["examples"] = {}
    for name, argv in (("torch_quickstart", []),
                       ("torch_plan_and_serve_rpq", ["--small", "--queries", "q1,q6"])):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            load_example(name).main(argv)
        torch.cuda.synchronize()
        text = out.getvalue()
        for line in text.splitlines():
            log("examples", f"{name}: {line}")
        rec[name] = {"argv": argv, "wall_s": time.perf_counter() - t0, "ok": text.count("[OK]"),
                     "mismatch": text.count("MISMATCH")}
        if "MISMATCH" in text:
            raise AssertionError(f"{name} {argv}: an answer differs from the PAA oracle")
        if name == "torch_plan_and_serve_rpq" and text.count("[OK]") != 8:  # 2 queries x 2 starts x 2 replays
            raise AssertionError(f"{name}: {text.count('[OK]')} starts answered OK, want 8")
        if name == "torch_quickstart" and "pairs [(1, 5), (1, 8), (2, 7), (9, 5), (9, 8)]" not in text:
            raise AssertionError(f"{name}: Q2's pairs differ from the paper's worked example")
        log("examples", f"{name} {' '.join(argv)}: {rec[name]['ok']} OK, 0 MISMATCH, {rec[name]['wall_s']:.1f} s")


def phase_serve(g, placement, pl16, dg, dev, record) -> tuple[dict[str, int], dict]:
    """The serving runtime on the full twin (ROADMAP A10, A11, A12): a
    144-request stream through ``QueryService`` on B4, its first 48 on B1
    with the whole f32 store and again under a 1 GiB out-of-core budget,
    8 witness requests on B2, the async front end at 1x and 2x the sync
    rate, a warm restart from a Stage-A snapshot, the first 48 on the
    default config (the reference backend, no kernel, one window forced
    to S1), and the first 48 on the sharded backend over (i)'s 16-site
    placement (B3) with a warm restart from its per-site snapshot.
    Returns each level kernel's launches on the path, and what the mesh
    phase's (c) holds the service over ranks to: the digests of runs (g)
    and (h) and of (h)'s restored first request, (h)'s answer sets, and
    run (e)'s 1x rate, beside the first SERVE_PREFIX requests."""
    rec = record["serve"] = {}
    net = serve_net(placement)
    stream = serve_stream(g)
    prefix = stream[:SERVE_PREFIX]
    t0 = time.perf_counter()
    oracle = serve_oracle(g, dg, stream)
    log("serve", f"stream: {len(stream)} requests, {len({w.query for w in stream})} distinct queries, "
        f"{sum(len(w.starts) for w in stream)} starts, {sum(w.hot for w in stream)} hot; device-BFS "
        f"answers of its {len(oracle)} (query, start) pairs in {time.perf_counter() - t0:.1f} s")
    launches = collections.Counter()
    config = serve_config

    # (a) the whole stream on the packed backend over the bit-plane store: B4
    svc = QueryService(placement, net, config=config(s2_backend="frontier_kernel_packed",
                                                    s2_tile_dtype="uint32"), device=dev)
    cold, r = serve_sync(svc, stream)
    r.update(serve_launched("packed_level_blocks_u32", "serve run (a)"))
    check_serve_answers(cold, stream, oracle, "serve run (a)")
    check_schema(svc.summary(), SUMMARY_KEYS)
    rec["a_cold"] = r
    log_serve("a, packed/uint32, cold", r)
    warm, r = serve_sync(svc, stream)
    r.update(serve_launched("packed_level_blocks_u32", "serve run (a), warm"))
    check_serve_answers(warm, stream, oracle, "serve run (a), warm")
    rec["a_warm"] = r
    launches[r["kernel"]] += r["launches"] + rec["a_cold"]["launches"]
    log_serve("a, packed/uint32, warm", r)
    # a third warm run traced: how far the host holds the card back while serving
    reset_launches()
    fops.FIXPOINT_COUNTERS.clear()
    traced_answers = []
    tr = device_trace(lambda: traced_answers.extend(serve_sync(svc, stream)[0]))
    check_serve_answers(traced_answers, stream, oracle, "serve run (a), traced")
    b4 = [n for n in tr["kernels"] if all(p in n for p in KERNELS["packed_level_blocks_u32"]["symbol"])]
    lk = kernel_share(tr, tuple(b4))
    rec["a_traced"] = {"traced_ms": tr["traced_ms"], "device_busy_ms": tr["device_busy_ms"],
                       "idle_share": 1.0 - tr["device_busy_ms"] / tr["traced_ms"],
                       "idle_share_of_warm_run": 1.0 - tr["device_busy_ms"] / (rec["a_warm"]["wall_s"] * 1e3),
                       "level_kernel": lk, "kernels": dict(list(tr["kernels"].items())[:12])}
    launches["packed_level_blocks_u32"] += only_launched("packed_level_blocks_u32", "serve run (a), traced")
    log("serve", f"(a) warm, traced: {tr['traced_ms']:.1f} ms traced, device busy {tr['device_busy_ms']:.1f} ms, "
        f"idle share {rec['a_traced']['idle_share']:.4f} of the traced run, "
        f"{rec['a_traced']['idle_share_of_warm_run']:.4f} of the untraced warm run; B4 {lk['ms']:.3f} ms in "
        f"{lk['count']} launches ({100 * lk['share']:.2f}% of device time)")
    for kname, kt in list(tr["kernels"].items())[:6]:
        log("serve", f"  {kt['us'] / 1e3:9.3f} ms {kt['count']:6d}x  {kname[:90]}")

    # (d) witness requests on the packed backend: they restage f32 and run B2
    witness_stream = stream[:SERVE_WITNESS]
    wit, r = serve_sync(svc, witness_stream, strategy="S2", semantics="witness")
    r.update(serve_launched("packed_level_blocks", "serve run (d)"))
    check_serve_answers(wit, witness_stream, oracle, "serve run (d)")
    rng = np.random.default_rng(SEED + 3)
    walked = hops = 0
    for ans in wit:
        pairs = [(i, t) for i, ts in enumerate(ans.answers) for t in sorted(ts)]
        for j in rng.choice(len(pairs), size=min(SERVE_WALKS, len(pairs)), replace=False):
            i, t = pairs[j]
            path = svc.witness_path(ans, i, t)
            ok, why = witness.validate_witness(path, g)
            if not ok or not witness.nfa_accepts_symbols(ans.exec_ca, path.steps) \
                    or (path.nodes[0], path.nodes[-1]) != (int(ans.starts[i]), t):
                raise AssertionError(f"serve run (d): the witness {path} of {ans.query!r} fails: {why}")
            walked += 1
            hops += len(path)
    bytes_by_dtype = svc.plan_store.tile_store_stats()["bytes_by_dtype"]
    if bytes_by_dtype["f32"] == 0:
        raise AssertionError("serve run (d): the witness requests did not restage f32")
    r.update({"walked": walked, "hops": hops, "store_bytes": bytes_by_dtype})
    rec["d_witness"] = r
    launches[r["kernel"]] += r["launches"]
    log_serve("d, witness on packed", r)
    log("serve", f"(d): {walked} witnesses ({hops} hops) walked back, valid on the label store and "
        f"accepted; the store holds {bytes_by_dtype} bytes (f32 restaged for witness)")

    # (e) the async front end, open loop, at 1x and 2x run (a)'s warm rate
    sync_rate = rec["a_warm"]["queries_per_s"]
    for mult in (1, 2):
        reset_launches()
        fops.FIXPOINT_COUNTERS.clear()
        got, rejected, wall, stats = asyncio.run(serve_open_loop(svc, prefix, mult * sync_rate, SEED + mult))
        accepted = [(wq, a) for wq, a in zip(prefix, got) if a is not None]
        for wq, a, want in zip(prefix, got, warm):
            if a is not None and a.answers != want.answers:
                raise AssertionError(f"serve run (e) {mult}x: async answers of {wq.query!r} differ from sync")
        check_serve_answers([a for _, a in accepted], [wq for wq, _ in accepted], oracle,
                            f"serve run (e) {mult}x")
        r = {"offered_qps": mult * sync_rate, "offered": len(prefix), "completed": len(accepted),
             "goodput_qps": len(accepted) / wall, "reject_rate": sum(rejected.values()) / len(prefix),
             "rejected": dict(rejected), "wall_s": wall,
             "latency": {c: {k: stats["latency_hist"][c][k] for k in ("n", "p50_ms", "p99_ms", "p999_ms")}
                         for c in stats["latency_hist"]},
             "batch_window": stats["batch_window"]}
        if accepted and any(a.strategy == "S2" for _, a in accepted):
            r.update(serve_launched("packed_level_blocks_u32", f"serve run (e) {mult}x"))
            launches[r["kernel"]] += r["launches"]
        rec[f"e_async_{mult}x"] = r
        lat = r["latency"]
        log("serve", f"(e, async {mult}x = {r['offered_qps']:.2f} q/s offered): {r['completed']} of "
            f"{r['offered']} completed in {wall:.2f} s, goodput {r['goodput_qps']:.2f} q/s, reject rate "
            f"{r['reject_rate']:.4f} {r['rejected']}; latency class p50/p99/p999 ms "
            f"{lat['latency']['p50_ms']:.1f}/{lat['latency']['p99_ms']:.1f}/{lat['latency']['p999_ms']:.1f} "
            f"(n {lat['latency']['n']}), throughput class {lat['throughput']['p50_ms']:.1f}/"
            f"{lat['throughput']['p99_ms']:.1f}/{lat['throughput']['p999_ms']:.1f} (n {lat['throughput']['n']}); "
            f"{r.get('launches', 0)} B4 launches = levels; {stats['batch_window']['flushes']} flushes; "
            "answers == sync == device BFS")
    check_schema(svc.summary(), SUMMARY_KEYS)
    rec["summary_a"] = svc.summary()
    del svc, cold, warm, wit
    free()

    # (b) the first 48 on the f32 backend over the whole f32 store: B1
    svc = QueryService(placement, net, config=config(s2_backend="frontier_kernel"), device=dev)
    b_answers, r = serve_sync(svc, prefix)
    r.update(serve_launched("fused_level_blocks", "serve run (b)"))
    check_serve_answers(b_answers, prefix, oracle, "serve run (b)")
    check_schema(svc.summary(), SUMMARY_KEYS)
    rec["b_f32"] = r
    launches[r["kernel"]] += r["launches"]
    log_serve("b, f32/f32", r)

    # (f) a warm restart from (b)'s Stage-A snapshot: zero tiles packed
    with tempfile.TemporaryDirectory(prefix="repro-stage-a-") as tmp:
        path = os.path.join(tmp, "stage_a.pkl")
        t0 = time.perf_counter()
        manifest = svc.save_plan_store(path)
        save_s, size = time.perf_counter() - t0, os.path.getsize(path)
        del svc
        free()
        svc = QueryService(placement, net, config=config(s2_backend="frontier_kernel"), device=dev)
        t0 = time.perf_counter()
        if not svc.restore_plan_store(path):
            raise AssertionError("serve run (f): the snapshot of run (b) did not restore")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    fops.reset_build_counters()
    first, r = serve_sync(svc, stream[:1], strategy="S2")
    r.update(serve_launched("fused_level_blocks", "serve run (f)"))
    check_serve_answers(first, stream[:1], oracle, "serve run (f)")
    packed = {k: fops.BUILD_COUNTERS[k] for k in ("pack_blocks", "stage_graph")}
    if any(packed.values()):
        raise AssertionError(f"serve run (f): the restored service packed tiles: {packed}")
    r.update({"manifest": manifest, "snapshot_bytes": size, "save_s": save_s, "restore_s": restore_s,
              "build_counters": dict(fops.BUILD_COUNTERS)})
    rec["f_restore"] = r
    launches[r["kernel"]] += r["launches"]
    log("serve", f"(f): run (b)'s Stage A saved ({manifest['n_entries']} entries, {size / 1e9:.3f} GB) in "
        f"{save_s:.1f} s, restored into a fresh service in {restore_s:.1f} s; its first S2 request "
        f"packed 0 tiles ({dict(fops.BUILD_COUNTERS)}), {r['launches']} B1 launches = levels, "
        f"{r['wall_s'] * 1e3:.1f} ms; answers == device BFS")
    del svc, first
    free()

    # (c) run (b) again under a 1 GiB out-of-core budget
    svc = QueryService(placement, net, config=config(s2_backend="frontier_kernel",
                                                    tile_store_budget_bytes=SERVE_BUDGET), device=dev)
    c_answers, r = serve_sync(svc, prefix)
    r.update(serve_launched("fused_level_blocks", "serve run (c)"))
    check_serve_answers(c_answers, prefix, oracle, "serve run (c)")
    if [a.answers for a in c_answers] != [a.answers for a in b_answers]:
        raise AssertionError("serve run (c): budgeted answers differ from run (b)'s")
    ts = svc.plan_store.tile_store_stats()
    if not (ts["spills"] and ts["reloads"]):
        raise AssertionError(f"serve run (c): the budgeted store did not spill and reload: {ts}")
    r["tile_store"] = ts
    rec["c_budget"] = r
    launches[r["kernel"]] += r["launches"]
    log_serve("c, f32/f32 under a 1 GiB budget", r)
    log("serve", f"(c): answers == run (b)'s; {ts['spills']} spills, {ts['reloads']} reloads, "
        f"{ts['slabs_resident']} slabs resident ({ts['bytes_by_dtype']['f32'] / 1e9:.3f} GB of host "
        f"slabs), {ts['slabs_spilled']} spilled")
    check_schema(svc.summary(), SUMMARY_KEYS)
    del svc, b_answers, c_answers
    free()

    # (g) the first 48 on the default config: the reference backend, no kernel
    svc = QueryService(placement, net, config=config(), device=dev)
    g_answers, r = serve_sync(svc, prefix, first_window={"strategy": "S1"})
    handoff = {"prefix": prefix, "rate": sync_rate, "g": [answer_digest(a) for a in g_answers]}
    if sum(launch_counts().values()):
        raise AssertionError(f"serve run (g): the reference backend launched kernels: {launch_counts()}")
    check_serve_answers(g_answers, prefix, oracle, "serve run (g)")
    if not {"S1", "S2"} <= set(r["strategies"]):
        raise AssertionError(f"serve run (g): strategies {r['strategies']}, want S1 and S2 both")
    check_schema(svc.summary(), SUMMARY_KEYS)
    r["levels"] = fops.FIXPOINT_COUNTERS["levels"]
    rec["g_reference"] = r
    log_serve("g, default config = reference, first window S1", r)
    del svc, g_answers
    free()

    # (h) the first 48 on the sharded backend over (i)'s placement: B3
    net16 = serve_net(pl16)
    sharded_cfg = config(s2_backend="frontier_kernel_sharded", s2_tile_dtype="uint32")
    svc = QueryService(pl16, net16, config=sharded_cfg, device=dev)
    h_answers, r = serve_sync(svc, prefix)
    handoff.update(h=[answer_digest(a) for a in h_answers], h_answers=[answers_digest(a) for a in h_answers])
    n_buckets = len(svc.plan_store.tile_buckets(pl16, 128, 1, tile_dtype="uint32").buckets)
    r.update(serve_launched("fused_level_blocks_u32", "serve run (h)", n_buckets))
    check_serve_answers(h_answers, prefix, oracle, "serve run (h)")
    check_schema(svc.summary(), SUMMARY_KEYS)
    r["plan_pad_waste"] = svc.summary()["plan_pad_waste"]
    rec["h_sharded"] = r
    launches[r["kernel"]] += r["launches"]
    log_serve("h, sharded/uint32 on 16 sites", r)
    with tempfile.TemporaryDirectory(prefix="repro-stage-a-") as tmp:
        path = os.path.join(tmp, "stage_a.pkl")
        t0 = time.perf_counter()
        manifest = svc.save_plan_store(path)
        save_s, size = time.perf_counter() - t0, os.path.getsize(path)
        del svc
        free()
        svc = QueryService(pl16, net16, config=sharded_cfg, device=dev)
        t0 = time.perf_counter()
        if not svc.restore_plan_store(path):
            raise AssertionError("serve run (h): the per-site snapshot did not restore")
        restore_s = time.perf_counter() - t0
    fops.reset_build_counters()
    first, r = serve_sync(svc, stream[:1], strategy="S2")
    r.update(serve_launched("fused_level_blocks_u32", "serve run (h), restored", n_buckets))
    check_serve_answers(first, stream[:1], oracle, "serve run (h), restored")
    packed = {k: fops.BUILD_COUNTERS[k] for k in ("pack_blocks", "stage_sharded_graph")}
    if any(packed.values()):
        raise AssertionError(f"serve run (h): the restored service packed tiles: {packed}")
    r.update({"manifest": manifest, "snapshot_bytes": size, "save_s": save_s, "restore_s": restore_s,
              "build_counters": dict(fops.BUILD_COUNTERS)})
    rec["h_restore"] = r
    handoff["h_first"] = answer_digest(first[0])
    launches[r["kernel"]] += r["launches"]
    log("serve", f"(h): the per-site Stage A saved ({manifest['n_entries']} entries, {size / 1e9:.3f} GB) in "
        f"{save_s:.1f} s, restored into a fresh service in {restore_s:.1f} s; its first S2 request packed "
        f"0 tiles ({dict(fops.BUILD_COUNTERS)}), {r['launches']} B3 launches = levels x buckets, "
        f"{r['wall_s'] * 1e3:.1f} ms; answers == device BFS")
    del svc, first, h_answers
    free()
    return dict(launches), handoff


def gathered_sectors(idx: torch.Tensor, row_bytes: int) -> int:
    """The 32-byte sectors that the gathered rows span: row ``i`` lies at
    bytes ``i·row_bytes .. (i + 1)·row_bytes - 1`` of the table."""
    start = idx.long() * row_bytes
    return int(((start + row_bytes - 1) // 32 - start // 32 + 1).sum())


def embedbag_case(name, table, idx, bags, n_bags, entry, flush) -> dict:
    """One EmbeddingBag workload: the entry point once with the counts at
    0 (B6 must launch, nothing else), the kernel against its plain version
    on the same sorted lookups (``torch.equal``: the same adds in the same
    order), the launch geometry, the times, the bounds and
    F.embedding_bag."""
    reset_launches()
    out = entry(table, idx, bags, n_bags)
    torch.cuda.synchronize()
    launches = only_launched("embedding_bag_sorted", f"{entry.__name__} ({name})")
    sorted_bags, order = torch.sort(bags, stable=True)
    s_idx = idx[order]
    want = embedbag.embedding_bag_sorted_plain(table, s_idx, sorted_bags, n_bags)
    visited = torch.zeros(n_bags, dtype=torch.bool, device=table.device)
    visited[bags.long()] = True
    got = embedbag.embedding_bag_sorted(table, s_idx, sorted_bags, n_bags)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    if not torch.equal(out[~visited], torch.zeros_like(out[~visited])) or not torch.equal(
            out[visited], got[visited]):
        raise AssertionError(f"{name}: {entry.__name__} differs from the kernel on the sorted lookups")
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: B6 != plain, max |diff| {err} (largest |sum| {scale})")
    del out, got, want
    d, esize = table.shape[1], table.element_size()
    geo = embedbag.launch_geometry(d, esize, table.data_ptr(), idx.numel())
    t = timed(lambda: embedbag.embedding_bag_sorted(table, s_idx, sorted_bags, n_bags), 10, 5, flush)
    t["plain_ms"] = events_ms(lambda: embedbag.embedding_bag_sorted_plain(table, s_idx, sorted_bags, n_bags), 3, flush)
    offsets = embedbag.bag_offsets(sorted_bags, n_bags)[:-1]
    t["library_ms"] = events_ms(lambda: F.embedding_bag(s_idx, table, offsets, mode="sum"), 5, flush)
    rows = int(torch.unique(idx).numel())
    side = 2 * idx.numel() * 4 + n_bags * d * esize  # index arrays and the output
    nbytes = rows * d * esize + side
    t["bound_ms"], t["bound_by"] = bound(nbytes, idx.numel() * d, FP32_FLOPS)
    t["gathered_bound_ms"] = (idx.numel() * d * esize + side) / HBM_BYTES_PER_S * 1e3
    sectors = gathered_sectors(idx, d * esize)
    t["sector_bound_ms"] = (sectors * 32 + side) / HBM_BYTES_PER_S * 1e3
    units = idx.numel() // geo["per_unit"] + 1
    t.update({"launches": launches, "max_abs_err": err, "largest_abs_sum": scale,
              "distinct_rows": rows, "bytes": nbytes, "gathered_sectors": sectors, "geometry": geo,
              "lane_groups": units * geo["n_chunks"]})
    log("embedbag", f"{name}: table {tuple(table.shape)} {table.dtype} ({table.numel() * esize / 1e9:.2f} GB), "
        f"{idx.numel()} lookups into {n_bags} bags; {launches} B6 launch, no other kernel, no offsets "
        f"pass; kernel == plain (largest |sum| {scale:.3f}); schedule: table rows, {units} lane groups of "
        f"{geo['lanes']} lanes x {geo['n_chunks']} column chunk(s), {geo['vec_bytes']}-byte loads, "
        f"{geo['per_unit']} lookups a group; {t['ms']:.4f} ms (L2 flushed; {t['warm_ms']:.4f} warm; "
        f"{t['events_ms']:.4f} one call), plain {t['plain_ms']:.4f} ms, F.embedding_bag "
        f"{t['library_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms by {t['bound_by']} ({rows} distinct "
        f"rows once, {nbytes / 1e9:.3f} GB); every gathered row from HBM: {t['gathered_bound_ms']:.4f} "
        f"ms; at 32-byte sectors ({sectors} sectors, {sectors * 32 / 1e9:.3f} GB): "
        f"{t['sector_bound_ms']:.4f} ms")
    return t


def phase_embedbag(dev, gen, flush, record) -> dict:
    """B6 through ``embedding_bag`` at dlrm-mlperf's largest table and
    through ``gnn_aggregate`` at ogb_products."""
    rec = record["embedbag"] = {}
    table = torch.randn((DLRM_ROWS, DLRM_DIM), generator=gen, device=dev, dtype=torch.bfloat16)
    idx = torch.randint(0, DLRM_ROWS, (DLRM_LOOKUPS,), generator=gen, device=dev, dtype=torch.int32)
    bags = torch.randperm(DLRM_LOOKUPS, generator=gen, device=dev).to(torch.int32)
    rec["dlrm"] = embedbag_case("dlrm-mlperf table 20, serve_bulk", table, idx, bags, DLRM_LOOKUPS,
                                eb_ops.embedding_bag, flush)
    del table, idx, bags
    free()
    feats = torch.randn((OGB_NODES, OGB_FEAT), generator=gen, device=dev)
    src = torch.randint(0, OGB_NODES, (OGB_EDGES,), generator=gen, device=dev, dtype=torch.int32)
    dst = torch.randint(0, OGB_NODES, (OGB_EDGES,), generator=gen, device=dev, dtype=torch.int32)
    rec["ogb"] = embedbag_case("ogb_products, uniform edges", feats, src, dst, OGB_NODES,
                               eb_ops.gnn_aggregate, flush)
    del feats, src, dst
    free()
    t = rec["ogb"]
    return {"name": "embedding_bag_sorted", "route": "cuda",
            "source": "src/repro_torch/kernels/embedbag/csrc/embedbag.cu",
            "replaces": "src/repro/kernels/embedbag/embedbag.py:34",
            "launches": rec["dlrm"]["launches"] + t["launches"],
            "max_abs_err": max(rec["dlrm"]["max_abs_err"], t["max_abs_err"]), "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]}


def phase_decode(dev, gen, flush, record) -> dict:
    """B7 through ``decode_attention`` at qwen3-14b's attention widths, at
    decode_32k and long_500k, and at kimi-k2's (head dim 112) at
    decode_32k: kernel against plain version, times, bound, and
    F.scaled_dot_product_attention on the kv_len prefix."""
    rec = record["decode"] = {}
    for name, (batch, seq, heads, kv_heads, dh) in DECODE_CASES.items():
        kv = seq - 17
        q = torch.randn((batch, heads, dh), generator=gen, device=dev, dtype=torch.bfloat16)
        k = torch.randn((batch, seq, kv_heads, dh), generator=gen, device=dev, dtype=torch.bfloat16)
        v = torch.randn((batch, seq, kv_heads, dh), generator=gen, device=dev, dtype=torch.bfloat16)
        kv_len = torch.tensor(kv, dtype=torch.int32, device=dev)
        n_split, split_len = decode_attn.decode_splits(batch, kv_heads, seq)
        part_bytes = 0 if n_split == 1 else batch * heads * n_split * (dh + 2) * 4
        log("decode", f"{name}: {n_split} kv split(s) of {split_len} positions: a grid of "
            f"{batch * kv_heads} x {n_split} CTAs, {part_bytes} bytes of f32 partials")
        reset_launches()
        out = da_ops.decode_attention(q, k, v, kv_len)
        torch.cuda.synchronize()
        launches = only_launched("flash_decode_gqa", f"decode_attention ({name})")
        want = decode_attn.flash_decode_gqa_plain(q, k, v, kv_len)
        scale = float(want.float().abs().max())
        limit = BF16_TOL * scale

        def diff(got: torch.Tensor) -> float:
            return float((got.float() - want.float()).abs().max())

        err = diff(out)
        if out.dtype != torch.bfloat16 or not torch.isfinite(out.float()).all() or err > limit:
            raise AssertionError(f"{name}: B7 != plain: max |diff| {err} > {limit} "
                                 f"({BF16_TOL} of the largest |output| {scale})")
        half = decode_attn.flash_decode_gqa(q, k, v, torch.tensor(kv // 2, dtype=torch.int32, device=dev))
        controls = {"zeros": diff(torch.zeros_like(out)), "half_cache": diff(half)}
        del half
        if min(controls.values()) <= limit:
            raise AssertionError(f"{name}: a wrong output passes the B7 check: {controls} <= {limit}")
        t = rec[name] = timed(lambda: decode_attn.flash_decode_gqa(q, k, v, kv_len), 3, 3, flush)
        t["plain_ms"] = events_ms(lambda: decode_attn.flash_decode_gqa_plain(q, k, v, kv_len), 2, flush)
        nbytes = 2 * batch * kv * kv_heads * dh * 2 + 2 * q.numel() * 2
        ops = 4 * batch * heads * kv * dh
        t["bound_ms"], t["bound_by"] = bound(nbytes, ops, BF16_FLOPS)
        t.update({"n_split": n_split, "split_len": split_len, "partial_bytes": part_bytes,
                  "launches": launches, "max_abs_err": err, "limit": limit, "largest_abs_out": scale,
                  "rms_out": float(want.float().square().mean().sqrt()), "controls": controls,
                  "bytes": nbytes, "ops": ops})
        del want, out
        # the library call on its own layout: (B, G, kv_len, Dh) contiguous
        kt = k[:, :kv].transpose(1, 2).contiguous()
        del k
        vt = v[:, :kv].transpose(1, 2).contiguous()
        del v
        q4 = q.unsqueeze(2)
        t["library_ms"] = events_ms(
            lambda: F.scaled_dot_product_attention(q4, kt, vt, enable_gqa=True), 3, flush)
        del q, q4, kt, vt, kv_len
        free()
        t["shape"] = {"batch": batch, "seq": seq, "kv_len": kv, "heads": heads, "kv_heads": kv_heads, "dh": dh}
        log("decode", f"{name}: B={batch}, S={seq}, kv_len={kv}, H={heads}, G={kv_heads}, "
            f"Dh={dh} bf16 (K and V {nbytes / 1e9:.2f} GB); {launches} B7 launch, no other kernel; "
            f"kernel ~= plain (max |diff| {err} <= {limit} = {BF16_TOL} x largest |output| {scale}; "
            f"rms output {t['rms_out']}; controls miss it: all-zero {controls['zeros']}, half the "
            f"cache {controls['half_cache']}); {t['ms']:.4f} ms (L2 flushed; "
            f"{t['warm_ms']:.4f} warm; {t['events_ms']:.4f} one call), plain {t['plain_ms']:.4f} ms, "
            f"SDPA {t['library_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms by {t['bound_by']}")
    offset_err = check_b7_kv_head_offset(dev, gen, record)
    t = rec["decode_32k"]
    return {"name": "flash_decode_gqa", "route": "cuda",
            "source": "src/repro_torch/kernels/decode_attn/csrc/decode_attn.cu",
            "replaces": "src/repro/kernels/decode_attn/decode_attn.py:61",
            "launches": sum(r["launches"] for r in rec.values()),
            "max_abs_err": max(offset_err, *(r["max_abs_err"] for r in rec.values())), "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]}


def check_b7_kv_head_offset(dev, gen, record) -> float:
    """B7 on a kv-head offset at a granite rank's shapes in mesh_lm (c) (a
    (2, 2) mesh: the rank's GRANITE.n_q_heads / 2 q heads read kv groups
    [m * G / 2, (m + 1) * G / 2) of the whole cache, in place): decode_32k's
    batch block at kv_len S - 17 and the request run's block (LM_REQUESTS
    / 2 rows of S = LM_PROMPT + LM_NEW) at kv_len S - 10, block_kv as
    ``layers.decode_attention`` picks it, against ``flash_decode_gqa_plain`` at the same offset;
    max |diff| at most BF16_TOL of the largest |output|, which the other
    half's groups must miss.  Returns the largest max |diff|."""
    cfg, m = GRANITE, 2
    heads, groups = cfg.n_q_heads // m, cfg.n_kv_heads // m
    batch, seq = DECODE_SHAPES["decode_32k"]
    cases = {"decode_32k": (batch // m, seq, seq - 17),
             "request": (LM_REQUESTS // m, LM_PROMPT + LM_NEW, LM_PROMPT + LM_NEW - 10)}
    out = record["decode_kv_head_offset"] = {}
    for name, (b, s, kv) in cases.items():
        block = math.gcd(s, 512)
        q = torch.randn((b, heads, cfg.d_head), generator=gen, device=dev, dtype=cfg.dtype)
        k = torch.randn((b, s, cfg.n_kv_heads, cfg.d_head), generator=gen, device=dev, dtype=cfg.dtype)
        v = torch.randn((b, s, cfg.n_kv_heads, cfg.d_head), generator=gen, device=dev, dtype=cfg.dtype)
        kv_len = torch.tensor(kv, dtype=torch.int32, device=dev)
        got, want = {}, {}
        for off in (0, groups):
            got[off] = decode_attn.flash_decode_gqa(q, k, v, kv_len, block, off, groups)
            want[off] = decode_attn.flash_decode_gqa_plain(q, k, v, kv_len, block, off, groups)
        for off in got:
            scale = float(want[off].float().abs().max())
            err = float((got[off].float() - want[off].float()).abs().max())
            other = float((got[groups - off].float() - want[off].float()).abs().max())
            if not torch.isfinite(got[off].float()).all() or err > BF16_TOL * scale:
                raise AssertionError(f"B7 at kv-head offset {off} ({name}): max |diff| {err} > {BF16_TOL} x {scale}")
            if other <= BF16_TOL * scale:
                raise AssertionError(f"B7 at kv-head offset {off} ({name}): the other groups' output passes "
                                     f"({other} <= {BF16_TOL} x {scale})")
            out[f"{name}_off{off}"] = {"max_abs_err": err, "largest_abs_out": scale, "limit": BF16_TOL * scale,
                                       "other_groups_diff": other}
        log("decode", f"B7 on a kv-head offset, in place, at a granite (2, 2) rank's {name} shape (B {b}, S {s}, "
            f"kv_len {kv}, H {heads} on kv groups [0, {groups}) and [{groups}, {cfg.n_kv_heads}) of "
            f"{cfg.n_kv_heads}, Dh {cfg.d_head}, block_kv {block}, {cfg.dtype}) ~= plain at the same offset: "
            + "; ".join(f"offset {off}: max |diff| {out[f'{name}_off{off}']['max_abs_err']} <= "
                        f"{out[f'{name}_off{off}']['limit']}, the other groups' output "
                        f"{out[f'{name}_off{off}']['other_groups_diff']}" for off in got))
        del q, k, v, got, want
        free()
    return max(r["max_abs_err"] for r in out.values())


def timed_steps(phase: str, what: str, fn, inputs: list, kernel: str, per_step: int,
                warmup: int) -> tuple[dict, list]:
    """Untimed calls on the first ``warmup`` inputs, then one timed call
    on each of the others with the launch counts set to 0 just before and
    read just after: ``kernel`` must launch ``per_step`` times a step and
    no other kernel launch.  A step's time is its ms between CUDA events,
    host work inside, as a caller waits for it.  Returns the times and
    the timed outputs."""
    for x in inputs[:warmup]:
        fn(x)
    torch.cuda.synchronize()
    inputs = inputs[warmup:]
    reset_launches()
    times, outs = [], []
    for x in inputs:
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        outs.append(fn(x))
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    n = only_launched(kernel, f"{phase} {what}")
    if n != per_step * len(inputs):
        raise AssertionError(f"{phase} {what}: {n} {kernel} launches in {len(inputs)} steps, "
                             f"expected {per_step} a step")
    return {"steps": len(inputs), "launches": n, "median_ms": float(np.median(times)),
            "p99_ms": float(np.percentile(times, 99)), "mean_ms": float(np.mean(times)),
            "min_ms": float(np.min(times))}, outs


def log_trace(phase: str, what: str, tr: dict, share: dict, name: str) -> None:
    log(phase, f"{what} traced: {tr['traced_ms']:.3f} ms wall, device busy {tr['device_busy_ms']:.3f} ms "
        f"(idle share {1 - tr['device_busy_ms'] / tr['traced_ms']:.4f}); {name} {share['ms']:.3f} ms in "
        f"{share['count']} launches = {share['share']:.4f} of {share['device_ms']:.3f} ms device time")
    for kname, kt in list(tr["kernels"].items())[:8]:
        log(phase, f"  {kt['us'] / 1e3:9.3f} ms {kt['count']:6d}x  {kname[:90]}")


def tree_to(tree, device):
    """A tree of dictionaries and lists of tensors, copied to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def phase_dlrm(dev, gen, record) -> tuple[int, dict]:
    """dlrm-mlperf ``full()`` on one card, nothing cut: serve_p99,
    serve_bulk and retrieval_cand through ``models/dlrm.py``'s serve and
    retrieval steps, 26 B6 launches a step; one serve_bulk step's bags
    each ``torch.equal`` to the plain version, one retrieval's top 64 to
    plain bags; one serve_bulk step traced.  Returns B6's launches and
    the parameters, which the mesh phase's (d) serves again."""
    rec = record["dlrm"] = {"cut": "none: dlrm-mlperf full(), 26 tables, uniform ids (no Criteo data)"}
    rules = shd.Rules.from_mesh(None)
    t0 = time.perf_counter()
    params = dlrm.init_params(DLRM, seed=SEED, device=dev)
    torch.cuda.synchronize()
    rec["init_s"], rec["table_bytes"] = time.perf_counter() - t0, tree_bytes(params["tables"])
    log("dlrm", f"dlrm-mlperf full(): 26 tables, {sum(DLRM.padded_table_sizes)} rows x {DLRM.embed_dim} "
        f"{DLRM.table_dtype} = {rec['table_bytes'] / 1e9:.2f} GB, f32 MLPs {(DLRM.n_dense,) + DLRM.bot_mlp} "
        f"and {tuple(params['top'][0]['w'].shape[:1]) + DLRM.top_mlp}, initialised in {rec['init_s']:.1f} s; "
        f"allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}")
    serve_step, retrieval_step = dlrm.make_serve_step(DLRM, rules), dlrm.make_retrieval_step(DLRM, rules)

    def serve(b):
        return serve_step(params, b)

    def retrieve(b):
        return retrieval_step(params, b)

    def batches(shape: str, n: int, first: int) -> list[dict]:
        size = registry.RECSYS_SHAPES[shape].dims["batch"]
        return [pipeline.dlrm_batch(DLRM.table_sizes, DLRM.n_dense, DLRM.multi_hot, size, first + i,
                                    seed=SEED, device=dev) for i in range(n)]

    def check_probs(probs: list, what: str) -> None:
        for p in probs:
            if not (torch.isfinite(p).all() and (p >= 0).all() and (p <= 1).all()):
                raise AssertionError(f"dlrm {what}: a probability is not finite in [0, 1]")

    launches = 0
    for shape, n, first in (("serve_p99", DLRM_P99_STEPS, 0), ("serve_bulk", DLRM_BULK_STEPS, 10_000)):
        inputs = batches(shape, n + DLRM_WARMUP, first)
        r, probs = timed_steps("dlrm", shape, serve, inputs, "embedding_bag_sorted", DLRM.n_sparse,
                               DLRM_WARMUP)
        check_probs(probs, shape)
        size = inputs[0]["dense"].shape[0]
        r.update({"batch": size, "samples_per_s": size / r["median_ms"] * 1e3})
        rec[shape], launches = r, launches + r["launches"]
        log("dlrm", f"{shape}: batch {size}, {r['steps']} steps, {r['launches']} B6 launches = 26 a step, "
            f"no other kernel; median {r['median_ms']:.4f} ms, p99 {r['p99_ms']:.4f} ms, min "
            f"{r['min_ms']:.4f} ms a step (CUDA events) = {r['samples_per_s']:.1f} samples/s; every "
            "probability finite in [0, 1]")
        del probs
    bulk = inputs[0]
    del inputs

    # each bag of one serve_bulk step on B6 against the plain version
    embs = dlrm.embedding_bags(DLRM, rules, params, bulk["sparse"])
    n_bags = bulk["sparse"].shape[0]
    bags = torch.arange(n_bags, dtype=torch.int32, device=dev).repeat_interleave(DLRM.multi_hot)
    sorted_bags, order = torch.sort(bags, stable=True)
    for i, e in enumerate(embs):
        idx = bulk["sparse"][:, i, :].reshape(-1)[order]
        want = embedbag.embedding_bag_sorted_plain(params["tables"][f"t{i}"], idx, sorted_bags, n_bags)
        if not torch.equal(e, want):
            raise AssertionError(f"dlrm serve_bulk: table {i}'s B6 bags != plain")
    log("dlrm", f"serve_bulk: each of the 26 tables' B6 bags of one step == plain (torch.equal)")
    del embs

    # one serve_bulk step traced: B6's share of device time
    tr = device_trace(lambda: serve(bulk))
    share = kernel_share(tr, ("embedding_bag_kernel",))
    mlp_flops = 2 * n_bags * sum(l["w"].numel() for l in params["bot"] + params["top"])
    inter_flops = 2 * n_bags * (DLRM.n_sparse + 1) ** 2 * DLRM.embed_dim
    gemm = kernel_share(tr, ("gemm", "Gemm", "cutlass", "sm90_xmma", "ampere_sgemm"))
    rec["serve_bulk_trace"] = {**tr, "b6": share, "gemm": gemm, "mlp_flops": mlp_flops,
                               "interaction_flops": inter_flops,
                               "gemm_tflops": (mlp_flops + inter_flops) / gemm["ms"] / 1e9 if gemm["ms"] else None}
    log_trace("dlrm", "serve_bulk step", tr, share, "B6")
    log("dlrm", f"serve_bulk step: {(mlp_flops + inter_flops) / 1e12:.3f} TFLOP of f32 MLP and interaction "
        f"products; the GEMM kernels {gemm['ms']:.3f} ms ({gemm['share']:.4f} of device time) = "
        f"{rec['serve_bulk_trace']['gemm_tflops']} TFLOP/s")

    # retrieval_cand: one query against 1,000,000 candidates
    n_cand = registry.RECSYS_SHAPES["retrieval_cand"].dims["n_candidates"]
    cands = torch.randn((n_cand, DLRM.embed_dim), generator=gen, device=dev)
    inputs = [dict(b, candidates=cands) for b in batches("retrieval_cand", DLRM_RETRIEVAL_STEPS + DLRM_WARMUP, 20_000)]
    r, outs = timed_steps("dlrm", "retrieval_cand", retrieve, inputs, "embedding_bag_sorted",
                          DLRM.n_sparse, DLRM_WARMUP)
    b, (scores, top) = inputs[DLRM_WARMUP], outs[0]
    q = dlrm._mlp_apply(params["bot"], b["dense"])[0]
    hot0 = torch.zeros(DLRM.multi_hot, dtype=torch.int32, device=dev)
    user = torch.stack([q] + [
        embedbag.embedding_bag_sorted_plain(params["tables"][f"t{i}"], b["sparse"][0, i].contiguous(), hot0, 1)[0].float()
        for i in range(DLRM.n_sparse)]).mean(0)
    all_scores = cands @ user
    want = torch.topk(all_scores, 64)
    if not (torch.equal(scores, want.values) and torch.equal(all_scores[top], want.values)):
        raise AssertionError("dlrm retrieval_cand: the top 64 differ from plain bags' (beyond ties)")
    r.update({"n_candidates": n_cand, "top": 64})
    rec["retrieval_cand"], launches = r, launches + r["launches"]
    log("dlrm", f"retrieval_cand: {n_cand} candidates x {DLRM.embed_dim} f32, top 64; {r['steps']} steps, "
        f"{r['launches']} B6 launches = 26 a step, no other kernel; median {r['median_ms']:.4f} ms, p99 "
        f"{r['p99_ms']:.4f} ms; the top 64 of one == those of the plain bags (scores exact, indices up to ties)")
    del cands, inputs, outs, bulk, tr
    free()
    return launches, params


def lm_request_run(cfg, rules, params, prompts, fed=None):
    """The request run of the lm and moe phases: ``make_prefill`` on the
    prompts (B, LM_PROMPT), the cache copied into ``init_cache(max_len =
    LM_PROMPT + LM_NEW)``, then LM_NEW ``make_decode_step``s, each fed the
    greedy token of the last logits or, with ``fed``, that list's tokens.
    Returns (the prefill's logits, the last step's logits, the tokens)."""
    prefill, step = transformer.make_prefill(cfg, rules), transformer.make_decode_step(cfg, rules)
    logits, pre = prefill(params, prompts)
    first = logits
    # the prefill's rows: the prompts, or on a mesh this rank's block of them
    cache = transformer.init_cache(cfg, pre["k"].shape[1], LM_PROMPT + LM_NEW, device=prompts.device)
    cache["k"][:, :, :LM_PROMPT] = pre["k"]
    cache["v"][:, :, :LM_PROMPT] = pre["v"]
    cache["len"] = pre["len"]
    del pre
    tokens = []
    for i in range(LM_NEW):
        tok = fed[i] if fed is not None else logits[:, : cfg.vocab].float().argmax(-1).to(torch.int32)
        tokens.append(tok)
        logits, cache = step(params, cache, tok)
    if int(cache["len"]) != LM_PROMPT + LM_NEW:
        raise AssertionError(f"the cache ends at len {int(cache['len'])}")
    return first, logits, tokens


def check_b7_at_request_shape(phase: str, cfg, gen, dev, errs: dict) -> None:
    """B7 against its plain version at the request run's cache shape (B
    LM_REQUESTS, S = LM_PROMPT + LM_NEW = 1,040, which ends inside the
    kernel's 64-position tile and gives shorter splits than the rest) at
    kv_len S, S - 10 and LM_PROMPT + 1, on the config's head widths."""
    seq = LM_PROMPT + LM_NEW
    shape = (LM_REQUESTS, seq, cfg.n_kv_heads, cfg.d_head)
    q = torch.randn((LM_REQUESTS, cfg.n_q_heads, cfg.d_head), generator=gen, device=dev, dtype=cfg.dtype)
    k = torch.randn(shape, generator=gen, device=dev, dtype=cfg.dtype)
    v = torch.randn(shape, generator=gen, device=dev, dtype=cfg.dtype)
    block = math.gcd(seq, 512)
    for kv in (seq, seq - 10, LM_PROMPT + 1):
        kv_len = torch.tensor(kv, dtype=torch.int32, device=dev)
        got = decode_attn.flash_decode_gqa(q, k, v, kv_len, block_kv=block)
        want = decode_attn.flash_decode_gqa_plain(q, k, v, kv_len, block_kv=block)
        err, scale = float((got.float() - want.float()).abs().max()), float(want.float().abs().max())
        if err > BF16_TOL * scale:
            raise AssertionError(f"{phase}: B7 at S={seq}, Dh={cfg.d_head}, kv_len {kv}: max |diff| {err} > "
                                 f"{BF16_TOL} x {scale}")
        errs[f"b7_s{seq}_kv{kv}"] = {"max_abs_err": err, "largest_abs_out": scale}
    n_split, split_len = decode_attn.decode_splits(LM_REQUESTS, cfg.n_kv_heads, seq)
    log(phase, f"B7 at the request cache's shape (B {LM_REQUESTS}, S {seq}, H {cfg.n_q_heads}, G "
        f"{cfg.n_kv_heads}, Dh {cfg.d_head}: {n_split} splits of {split_len}) ~= plain at kv_len {seq}, "
        f"{seq - 10}, {LM_PROMPT + 1}: max |diff| {[errs[k]['max_abs_err'] for k in errs if k.startswith('b7')]}")
    del q, k, v, got, want
    free()


def phase_lm(dev, gen, record) -> int:
    """qwen3-14b at full width, ``n_layers`` cut to :data:`LM_LAYERS`:
    (a) a request run (prefill of 8 prompts, the cache copied into a
    longer buffer, 16 greedy decode steps) held to the port's CPU run of
    the same weights and tokens; (b) decode_32k steps on a random cache,
    one traced.  Returns B7's launches and ``finish()``, which holds (a)
    to its CPU replay, run in a thread beside the card's work until
    then."""
    cfg = dataclasses.replace(QWEN, n_layers=LM_LAYERS)
    rules = shd.Rules.from_mesh(None)
    rec = record["lm"] = {"cut": {"n_layers": [QWEN.n_layers, LM_LAYERS],
                                  "why": "the full decode_32k cache is 687 GB"}}
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    rec["init_s"], rec["weight_bytes"] = time.perf_counter() - t0, tree_bytes(params)
    log("lm", f"qwen3-14b at full width (d_model {cfg.d_model}, {cfg.n_q_heads} q-heads, {cfg.n_kv_heads} kv "
        f"heads, d_head {cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab} padded to {cfg.padded_vocab}, "
        f"{cfg.dtype}), {cfg.n_layers} of {QWEN.n_layers} layers: {rec['weight_bytes'] / 1e9:.2f} GB of "
        f"weights, initialised in {rec['init_s']:.1f} s")
    step = transformer.make_decode_step(cfg, rules)

    # (a) the request run, and its replay on the CPU
    def request_run(params, prompts, fed=None):
        return lm_request_run(cfg, rules, params, prompts, fed)

    prompts = pipeline.lm_batch(cfg.vocab, LM_REQUESTS, LM_PROMPT, step=0, seed=SEED, device=dev)["tokens"]
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first, last, fed = request_run(params, prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = only_launched("flash_decode_gqa", "lm request run")
    if n != LM_LAYERS * LM_NEW:
        raise AssertionError(f"lm request run: {n} B7 launches, expected {LM_LAYERS} x {LM_NEW}")
    launches = n
    # the CPU replay runs beside the rest of this phase and the next two;
    # finish() holds the logits to it
    replay = Background("lm CPU replay", functools.partial(request_run, tree_to(params, "cpu"), prompts.cpu(),
                                                           [t.cpu() for t in fed]))
    first, last = first.cpu(), last.cpu()
    del fed, prompts
    errs = {}
    rec["request"] = {"requests": LM_REQUESTS, "prompt": LM_PROMPT, "new_tokens": LM_NEW, "wall_s": wall,
                      "launches": n, "check": errs}
    check_b7_at_request_shape("lm", cfg, gen, dev, errs)

    def finish() -> None:
        c_first, c_last, _ = replay.result()
        for name, got, want in (("prefill", first, c_first), ("last_decode", last, c_last)):
            scale = float(want.float().abs().max())
            err = float((got.float() - want.float()).abs().max())
            errs[name] = {"max_abs_err": err, "largest_abs_logit": scale, "limit": BF16_TOL * scale}
            if got.dtype != cfg.dtype or not torch.isfinite(got.float()).all() or err > BF16_TOL * scale:
                raise AssertionError(f"lm request run: {name} logits differ from the CPU run: max |diff| {err} > "
                                     f"{BF16_TOL} x {scale}")
        rec["request"].update(cpu_s=replay.seconds, cpu_waited_s=replay.waited_s)
        log("lm", f"(a) {LM_REQUESTS} prompts of {LM_PROMPT} tokens (lm_batch), prefill, cache copied into "
            f"init_cache(max_len={LM_PROMPT + LM_NEW}), {LM_NEW} greedy decode steps: {wall:.3f} s wall, {n} B7 "
            f"launches = layers x steps, no other kernel; the CPU run of the same weights and tokens "
            f"({replay.seconds:.1f} s in a thread beside the card's work, {replay.waited_s:.1f} s waited for): "
            f"prefill logits max |diff| {errs['prefill']['max_abs_err']} (limit {errs['prefill']['limit']}), last "
            f"decode step {errs['last_decode']['max_abs_err']} (limit {errs['last_decode']['limit']} = {BF16_TOL} "
            "x largest |logit|)")

    # (b) decode_32k steps on a random cache
    batch, seq = DECODE_SHAPES["decode_32k"]
    kv_shape = (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.d_head)
    cache = {"k": lm_layers.normal(kv_shape, 1.0, cfg.dtype, gen), "v": lm_layers.normal(kv_shape, 1.0, cfg.dtype, gen),
             "len": torch.tensor(seq - 17, dtype=torch.int32, device=dev)}
    tokens = pipeline.lm_batch(cfg.vocab, batch, 1, step=1, seed=SEED, device=dev)["tokens"][:, 0].contiguous()
    cache_bytes = tree_bytes({"k": cache["k"], "v": cache["v"]})
    r, outs = timed_steps("lm", "decode_32k", lambda _: step(params, cache, tokens)[0],
                          [None] * (LM_DECODE_STEPS + LM_WARMUP), "flash_decode_gqa", LM_LAYERS, LM_WARMUP)
    for logits in outs:
        if logits.shape != (batch, cfg.padded_vocab) or not torch.isfinite(logits.float()).all():
            raise AssertionError("lm decode_32k: logits not finite or of the wrong shape")
    kv = seq - 17 + 1
    nbytes = (tree_bytes(params["layers"]) + tree_bytes(params["lm_head"])
              + 2 * cfg.n_layers * batch * kv * cfg.n_kv_heads * cfg.d_head * 2)
    r.update({"batch": batch, "seq": seq, "kv_len": kv, "cache_bytes": cache_bytes,
              "tokens_per_s": batch / r["median_ms"] * 1e3, "bytes": nbytes,
              "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3})
    launches += r["launches"]
    tr = device_trace(lambda: step(params, cache, tokens))
    share = kernel_share(tr, ("decode_bf16_kernel", "decode_combine_kernel"))
    r["trace"] = {**tr, "b7": share}
    rec["decode_32k"] = r
    log("lm", f"(b) decode_32k: batch {batch}, S {seq}, len {seq - 17} ({cache_bytes / 1e9:.2f} GB of K and V "
        f"for {cfg.n_layers} layers); {r['steps']} steps, {r['launches']} B7 launches = layers x steps, no "
        f"other kernel; median {r['median_ms']:.4f} ms, p99 {r['p99_ms']:.4f} ms a step (CUDA events) = "
        f"{r['tokens_per_s']:.1f} tokens/s; byte bound {r['bound_ms']:.4f} ms ({nbytes / 1e9:.2f} GB: layer "
        "weights, lm_head, K and V of the prefix)")
    log_trace("lm", "decode_32k step", tr, share, "B7")
    del params, cache, tokens, outs, tr
    free()
    return launches, finish


@contextlib.contextmanager
def patched(module, name: str, fn):
    """``module.name`` replaced by ``fn`` inside the block, but for the
    CPU references running beside the card's work (:class:`Background`),
    which still call the original.  Any other thread sees ``fn``: a CUDA
    backward runs on autograd's device thread, and a checkpointed layer's
    recompute there must call what its forward called."""
    old = getattr(module, name)

    def call(*args, **kwargs):
        return (old if in_background() else fn)(*args, **kwargs)

    setattr(module, name, call)
    try:
        yield
    finally:
        setattr(module, name, old)


_BACKGROUND: set[int] = set()  # the idents of the Background threads running


def in_background() -> bool:
    """Whether this thread is a :class:`Background` CPU reference."""
    return threading.get_ident() in _BACKGROUND


class Background:
    """``fn()``, a CPU reference, run in a thread while the card works on:
    the same inputs (host copies the caller no longer changes), the same
    arithmetic and the same limits as when it ran inline; :meth:`result`
    waits for it and raises what it raised.  Torch's CPU ops release the
    GIL, so the reference and the card's work overlap.  The thread runs at
    the lowest CPU priority (its nice value, which the OpenMP threads its
    ops start inherit), so it takes the cores the card's phases leave
    idle and slows them little."""

    def __init__(self, what: str, fn):
        self.what, self.out, self.err, self.seconds = what, None, None, None
        t0 = time.perf_counter()

        def run():
            _BACKGROUND.add(threading.get_ident())
            try:
                os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 19)
            except (AttributeError, OSError):  # not Linux: the ordinary priority
                pass
            try:
                self.out = fn()
            except BaseException as err:  # handed to result()
                self.err = err
            finally:
                _BACKGROUND.discard(threading.get_ident())
            self.seconds = time.perf_counter() - t0

        self.thread = threading.Thread(target=run, name=what, daemon=True)
        self.thread.start()

    def result(self):
        t0 = time.perf_counter()
        self.thread.join()
        self.waited_s = time.perf_counter() - t0
        if self.err is not None:
            raise AssertionError(f"{self.what}: {self.err!r}") from self.err
        return self.out


class RouteTape:
    """The experts that the MoE layers chose, call by call of
    ``layers._route``: :meth:`record` keeps each call's router logits
    and (weights, experts) on the card; :meth:`replay` feeds a CPU replay
    of batch row ``row`` those experts, call for call, with weights from
    the replay's own router logits, as the replay is fed the card's
    tokens.  Routing is a discontinuous choice: where a token's k-th and
    (k+1)-th logits are closer than the two devices' bf16 products round
    apart, the devices pick other experts, and that token's output, and
    through attention its sequence's, then differs by far more than any
    tolerance.  :meth:`check` audits a top k against the recorded one: a
    token may choose other experts only if its own gap between the k-th
    and (k+1)-th logit is at most twice its row's largest |logit
    difference| (beyond that no perturbation of that size reorders the
    boundary), and the logits must agree within BF16_TOL of the largest
    |logit|."""

    def __init__(self):
        self.calls: list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = []
        self.audit = {"calls": 0, "tokens": 0, "differ": 0, "max_abs_logit_diff": 0.0,
                      "largest_abs_logit": 0.0, "max_gap_where_differ": 0.0}

    @contextlib.contextmanager
    def record(self):
        route = lm_layers._route

        def rec(p, xt, top_k):
            w, idx = route(p, xt, top_k)
            self.calls.append((xt.float() @ p["router"], w, idx))
            return w, idx

        with patched(lm_layers, "_route", rec):
            yield self

    def check(self, logits: torch.Tensor, want: torch.Tensor, idx: torch.Tensor, top_k: int) -> None:
        """Audit the experts of ``logits``' own top k against ``idx``,
        chosen from ``want``, the recorded logits of the same tokens."""
        want = want.to(logits.device)
        vals, own = torch.topk(logits, min(top_k + 1, logits.shape[1]), dim=-1)
        differ = (own[:, :top_k].sort(-1).values != idx.sort(-1).values).any(-1)
        row_diff = (logits - want).abs().amax(-1)
        a = self.audit
        a["calls"] += 1
        a["tokens"] += int(idx.shape[0])
        a["differ"] += int(differ.sum())
        a["max_abs_logit_diff"] = max(a["max_abs_logit_diff"], float(row_diff.max()))
        a["largest_abs_logit"] = max(a["largest_abs_logit"], float(want.abs().max()))
        if a["max_abs_logit_diff"] > BF16_TOL * a["largest_abs_logit"]:
            raise AssertionError(f"router logits differ by {a['max_abs_logit_diff']}, more than {BF16_TOL} "
                                 f"of the largest |logit| {a['largest_abs_logit']}")
        if differ.any():
            if vals.shape[1] == top_k:
                raise AssertionError("a top k of every expert chose other experts")
            gap = (vals[:, top_k - 1] - vals[:, top_k])[differ]
            a["max_gap_where_differ"] = max(a["max_gap_where_differ"], float(gap.max()))
            if bool((gap > 2 * row_diff[differ]).any()):
                raise AssertionError("a token chose other experts than its logits' own top k allows")

    def replay(self, batch: int, row: int = 0):
        return self._feed(lambda t, xt: t.reshape(batch, -1, t.shape[-1])[row])

    def replay_blocks(self, rules, mesh, batch: int, n_experts: int):
        """:meth:`replay` on a rank of ``mesh``'s expert-parallel run: each
        call is fed the recorded experts of the rank's (batch, sequence)
        block of the whole batch's tokens (``layers.moe_plan``'s blocks)."""

        def mine(t, xt):
            seq = t.shape[0] // batch
            plan = lm_layers.moe_plan(rules, (batch, seq, xt.shape[1]), n_experts, t.shape[-1])
            b_lo, b_hi = collectives.block_of(batch, plan.batch_axes, mesh) if plan.batch_axes else (0, batch)
            s_lo, s_hi = collectives.block_of(seq, plan.seq_axes, mesh) if plan.seq_axes else (0, seq)
            return t.reshape(batch, seq, -1)[b_lo:b_hi, s_lo:s_hi].reshape(-1, t.shape[-1])

        return self._feed(mine)

    @contextlib.contextmanager
    def _feed(self, select):
        """``layers._route`` fed, call for call, ``select(recorded, xt)``:
        the recorded (tokens, k) experts and (tokens, experts) logits of
        the tokens ``xt`` holds."""
        calls = iter(self.calls)

        def fed(p, xt, top_k):
            want, _, idx = next(calls)
            idx = select(idx, xt).to(xt.device)
            logits = xt.float() @ p["router"]
            self.check(logits, select(want, xt), idx, top_k)
            return torch.softmax(torch.gather(logits, 1, idx), dim=-1), idx

        with patched(lm_layers, "_route", fed):
            yield self
        if next(calls, None) is not None:
            raise AssertionError("the replay made fewer MoE calls than the run it replays")


def moe_step_bytes(cfg, params: dict, touched: list[int], batch: int, kv: int) -> int:
    """Bytes a MoE decode step must move: each layer's attention weights,
    norms, router and the three tensors of each expert its tokens chose
    (``touched``: the count per layer, from this run's routing), the
    final norm and lm_head, the tokens' embedding rows, and the K and V
    of the kv prefix."""
    lay, moe = params["layers"], params["layers"]["moe"]
    per_expert = sum(moe[k][0, 0].numel() * moe[k].element_size() for k in ("w_gate", "w_up", "w_down"))
    fixed = (tree_bytes(lay["attn"]) + tree_bytes(lay["ln1"]) + tree_bytes(lay["ln2"])
             + tree_bytes(moe["router"]))
    kv_bytes = 2 * cfg.n_layers * batch * kv * cfg.n_kv_heads * cfg.d_head * 2
    return (fixed + per_expert * sum(touched) + tree_bytes(params["lm_head"])
            + tree_bytes(params["final_norm"]) + batch * cfg.d_model * 2 + kv_bytes)


def moe_decode_32k(phase: str, what: str, cfg, params, gen, dev) -> dict:
    """decode_32k on a random cache at len S - 17: ms a step by events
    (MOE_DECODE_STEPS after MOE_WARMUP), tokens/s, the byte bound from the
    experts this step's tokens chose, the MoE layers timed apart on the
    step's own inputs, and one step traced (B7's and the GEMMs' shares)."""
    rules = shd.Rules.from_mesh(None)
    step = transformer.make_decode_step(cfg, rules)
    batch, seq = DECODE_SHAPES["decode_32k"]
    kv_shape = (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.d_head)
    cache = {"k": lm_layers.normal(kv_shape, 1.0, cfg.dtype, gen), "v": lm_layers.normal(kv_shape, 1.0, cfg.dtype, gen),
             "len": torch.tensor(seq - 17, dtype=torch.int32, device=dev)}
    tokens = pipeline.lm_batch(cfg.vocab, batch, 1, step=1, seed=SEED, device=dev)["tokens"][:, 0].contiguous()
    cache_bytes = tree_bytes({"k": cache["k"], "v": cache["v"]})
    r, outs = timed_steps(phase, f"{what} decode_32k", lambda _: step(params, cache, tokens)[0],
                          [None] * (MOE_DECODE_STEPS + MOE_WARMUP), "flash_decode_gqa", cfg.n_layers, MOE_WARMUP)
    for logits in outs:
        if logits.shape != (batch, cfg.padded_vocab) or not torch.isfinite(logits.float()).all():
            raise AssertionError(f"{phase} {what} decode_32k: logits not finite or of the wrong shape")
    # every step writes the same position with the same tokens: one
    # step's routing and MoE inputs are every step's
    moe_in, tape = [], RouteTape()
    apply = lm_layers.apply_moe

    def keep(p, x, **kw):
        moe_in.append((p, x, kw))
        return apply(p, x, **kw)

    with patched(lm_layers, "apply_moe", keep), tape.record():
        step(params, cache, tokens)
    touched = [int(torch.unique(idx).numel()) for _, _, idx in tape.calls]
    moe_ms = events_ms(lambda: [apply(p, x, **kw) for p, x, kw in moe_in], 3,
                       torch.empty(16 * 2**20, dtype=torch.float32, device=dev))
    kv = seq - 17 + 1
    nbytes = moe_step_bytes(cfg, params, touched, batch, kv)
    r.update({"batch": batch, "seq": seq, "kv_len": kv, "cache_bytes": cache_bytes,
              "tokens_per_s": batch / r["median_ms"] * 1e3, "bytes": nbytes,
              "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "experts_touched": touched,
              "moe_layers_ms": moe_ms, "moe_share_of_step": moe_ms / r["median_ms"]})
    tr = device_trace(lambda: step(params, cache, tokens))
    share = kernel_share(tr, ("decode_bf16_kernel", "decode_combine_kernel"))
    gemm = kernel_share(tr, ("gemm", "Gemm", "cutlass", "sm90_xmma", "nvjet", "ampere_"))
    r["trace"] = {**tr, "b7": share, "gemm": gemm}
    log(phase, f"{what} decode_32k: batch {batch}, S {seq}, len {seq - 17} ({cache_bytes / 1e9:.2f} GB of K "
        f"and V for {cfg.n_layers} layers); {r['steps']} steps, {r['launches']} B7 launches = layers x "
        f"steps, no other kernel; median {r['median_ms']:.4f} ms, p99 {r['p99_ms']:.4f} ms a step (CUDA "
        f"events) = {r['tokens_per_s']:.1f} tokens/s; byte bound {r['bound_ms']:.4f} ms ({nbytes / 1e9:.2f} "
        f"GB: attention and router weights, the {touched} experts the step's tokens chose, lm_head, K and V "
        f"of the prefix); the MoE layers alone {moe_ms:.4f} ms ({r['moe_share_of_step']:.4f} of the step, "
        f"events, on the step's own inputs)")
    log_trace(phase, f"{what} decode_32k step", tr, share, "B7")
    log(phase, f"  GEMM kernels (projections, experts, lm_head) {gemm['ms']:.3f} ms in {gemm['count']} "
        f"launches = {gemm['share']:.4f} of device time")
    del cache, tokens, outs, tr, moe_in
    free()
    return r


def phase_moe(dev, gen, record) -> tuple[int, dict]:
    """granite-moe-1b-a400m whole and kimi-k2-1t-a32b at full width with
    one layer: a request run each, held to the port's CPU replay of one
    prompt (granite) or to a token-by-token recomputation of 64 routed
    MoE outputs and B7 at Dh 112 against plain (kimi), then decode_32k
    steps (granite cut to MOE_DECODE_LAYERS layers).  Returns B7's
    launches and granite's request run for mesh_lm (c) (host copies of
    its prefill and last logits, its tokens, and each MoE call's router
    logits and experts)."""
    rules = shd.Rules.from_mesh(None)
    rec = record["moe"] = {}
    launches = 0

    # (a) granite-moe-1b-a400m, 24 layers
    cfg = GRANITE
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    g = rec["granite"] = {"init_s": time.perf_counter() - t0, "weight_bytes": tree_bytes(params),
                          "cut": {"decode_32k n_layers": [cfg.n_layers, MOE_DECODE_LAYERS],
                                  "why": "a 24-layer decode_32k cache is 206 GB",
                                  "cpu_replay_prompts": [LM_REQUESTS, MOE_CPU_PROMPTS],
                                  "why_replay": "24 bf16 layers of 8 prompts on the host CPU take minutes"}}
    log("moe", f"granite-moe-1b-a400m whole ({cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_q_heads} q / "
        f"{cfg.n_kv_heads} kv heads, d_head {cfg.d_head}, {cfg.n_experts} experts top-{cfg.top_k}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}): {g['weight_bytes'] / 1e9:.2f} GB of weights, "
        f"initialised in {g['init_s']:.1f} s")
    prompts = pipeline.lm_batch(cfg.vocab, LM_REQUESTS, LM_PROMPT, step=0, seed=SEED, device=dev)["tokens"]
    tape = RouteTape()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with tape.record():
        first, last, fed = lm_request_run(cfg, rules, params, prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = only_launched("flash_decode_gqa", "moe granite request run")
    if n != cfg.n_layers * LM_NEW:
        raise AssertionError(f"moe granite request run: {n} B7 launches, expected {cfg.n_layers} x {LM_NEW}")
    launches += n
    rows = slice(0, MOE_CPU_PROMPTS)
    t0 = time.perf_counter()
    cpu_params = tree_to(params, "cpu")
    with tape.replay(LM_REQUESTS, row=0):
        c_first, c_last, _ = lm_request_run(cfg, rules, cpu_params, prompts[rows].cpu(),
                                            [t[rows].cpu() for t in fed])
    cpu_s = time.perf_counter() - t0
    del cpu_params
    errs = {}
    for name, got, want in (("prefill", first[rows], c_first), ("last_decode", last[rows], c_last)):
        scale = float(want.float().abs().max())
        err = float((got.float().cpu() - want.float()).abs().max())
        errs[name] = {"max_abs_err": err, "largest_abs_logit": scale, "limit": BF16_TOL * scale}
        if got.dtype != cfg.dtype or not torch.isfinite(got.float()).all() or err > BF16_TOL * scale:
            raise AssertionError(f"moe granite request run: {name} logits differ from the CPU replay: max "
                                 f"|diff| {err} > {BF16_TOL} x {scale}")
    g["request"] = {"requests": LM_REQUESTS, "prompt": LM_PROMPT, "new_tokens": LM_NEW, "wall_s": wall,
                    "launches": n, "cpu_s": cpu_s, "check": errs, "routing_audit": tape.audit}
    log("moe", f"granite (a) {LM_REQUESTS} prompts of {LM_PROMPT} tokens, prefill, {LM_NEW} greedy steps: "
        f"{wall:.3f} s wall (the routing kept on the card), {n} B7 launches = layers x steps, no other kernel; "
        f"the CPU replay of prompt 0 ({cpu_s:.1f} s; fed the card's tokens and experts): prefill logits max "
        f"|diff| {errs['prefill']['max_abs_err']} (limit {errs['prefill']['limit']}), last step "
        f"{errs['last_decode']['max_abs_err']} (limit {errs['last_decode']['limit']}); router logits within "
        f"{tape.audit['max_abs_logit_diff']:.5f} of the card's (largest |logit| "
        f"{tape.audit['largest_abs_logit']:.3f}); the replay's own top-{cfg.top_k} differs from the fed on "
        f"{tape.audit['differ']} of {tape.audit['tokens']} tokens, each a near tie (largest k-th to (k+1)-th "
        f"gap there {tape.audit['max_gap_where_differ']:.5f})")
    granite = {"first": first.cpu(), "last": last.cpu(), "fed": [t.cpu() for t in fed],
               "routes": [(w.cpu(), idx.cpu()) for w, _, idx in tape.calls]}
    del first, last, fed, c_first, c_last, prompts, tape
    free()
    # (b) decode_32k, n_layers cut: the first MOE_DECODE_LAYERS layers
    cut = dataclasses.replace(cfg, n_layers=MOE_DECODE_LAYERS)
    cut_params = dict(params, layers=_first_layers(params["layers"], MOE_DECODE_LAYERS))
    g["decode_32k"] = moe_decode_32k("moe", "granite", cut, cut_params, gen, dev)
    launches += g["decode_32k"]["launches"]
    del params, cut_params
    free()

    # (c) kimi-k2-1t-a32b at full width, one layer
    cfg = dataclasses.replace(KIMI, n_layers=KIMI_LAYERS)
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    k = rec["kimi"] = {"init_s": time.perf_counter() - t0, "weight_bytes": tree_bytes(params),
                       "experts_bytes": tree_bytes({w: params["layers"]["moe"][w]
                                                    for w in ("w_gate", "w_up", "w_down")}),
                       "cut": {"n_layers": [KIMI.n_layers, KIMI_LAYERS],
                               "why": "61 layers of 384 experts are ~2 TB; one is 33.82 GB"}}
    log("moe", f"kimi-k2-1t-a32b at full width (d_model {cfg.d_model}, {cfg.n_q_heads} q / {cfg.n_kv_heads} kv "
        f"heads, d_head {cfg.d_head}, {cfg.n_experts} experts top-{cfg.top_k}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}), {cfg.n_layers} of {KIMI.n_layers} layers: {k['weight_bytes'] / 1e9:.2f} GB of weights "
        f"({k['experts_bytes'] / 1e9:.2f} GB of experts), initialised in {k['init_s']:.1f} s")
    prompts = pipeline.lm_batch(cfg.vocab, LM_REQUESTS, LM_PROMPT, step=0, seed=SEED, device=dev)["tokens"]
    tape, seen = RouteTape(), {}
    apply = lm_layers.apply_moe

    def keep_first(p, x, **kw):
        out = apply(p, x, **kw)
        if not seen:
            seen.update(p=p, x=x, out=out)
        return out

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with patched(lm_layers, "apply_moe", keep_first), tape.record():
        first, last, _ = lm_request_run(cfg, rules, params, prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = only_launched("flash_decode_gqa", "moe kimi request run")
    if n != cfg.n_layers * LM_NEW:
        raise AssertionError(f"moe kimi request run: {n} B7 launches, expected {cfg.n_layers} x {LM_NEW}")
    launches += n
    for name, logits in (("prefill", first), ("last_decode", last)):
        if logits.shape != (LM_REQUESTS, cfg.padded_vocab) or not torch.isfinite(logits.float()).all():
            raise AssertionError(f"moe kimi request run: {name} logits not finite or of the wrong shape")
    # the prefill's routed MoE output of KIMI_CHECK_TOKENS sampled tokens,
    # recomputed token by token from the experts' weights gathered for it
    p, d = seen["p"], cfg.d_model
    x, out = seen["x"].reshape(-1, d), seen["out"].reshape(-1, d)
    logits, weights, idx = tape.calls[0]
    sample = torch.randperm(x.shape[0], generator=gen, device=dev)[:KIMI_CHECK_TOKENS]
    direct = []
    for t in sample.tolist():
        e = idx[t]
        h = lm_layers.silu(torch.einsum("d,kdf->kf", x[t], p["w_gate"][e])) * torch.einsum(
            "d,kdf->kf", x[t], p["w_up"][e])
        y = torch.einsum("kf,kfd->kd", h, p["w_down"][e])
        direct.append((y.float() * weights[t][:, None]).sum(0).to(x.dtype))
    direct = torch.stack(direct)
    audit = RouteTape()
    audit.check(x[sample].float() @ p["router"], logits[sample], idx[sample], cfg.top_k)
    scale = float(out[sample].float().abs().max())
    err = float((direct.float() - out[sample].float()).abs().max())
    if not torch.isfinite(out.float()).all() or err > BF16_TOL * scale:
        raise AssertionError(f"moe kimi: the routed MoE output differs from the token-by-token recomputation: "
                             f"max |diff| {err} > {BF16_TOL} x {scale}")
    k["request"] = {"requests": LM_REQUESTS, "prompt": LM_PROMPT, "new_tokens": LM_NEW, "wall_s": wall,
                    "launches": n, "moe_check": {"tokens": KIMI_CHECK_TOKENS, "max_abs_err": err,
                                                 "largest_abs_out": scale, "limit": BF16_TOL * scale,
                                                 "routing_audit": audit.audit}}
    log("moe", f"kimi (a) {LM_REQUESTS} prompts of {LM_PROMPT} tokens, prefill, {LM_NEW} greedy steps: {wall:.3f} "
        f"s wall, {n} B7 launches = layers x steps, no other kernel, logits finite; the prefill's routed MoE "
        f"output of {KIMI_CHECK_TOKENS} sampled tokens against their token-by-token recomputation from the "
        f"gathered experts: max |diff| {err} (limit {BF16_TOL * scale}); the router's top-{cfg.top_k} of those "
        f"tokens recomputed differs on {audit.audit['differ']} (near ties; logits within "
        f"{audit.audit['max_abs_logit_diff']:.5f})")
    del first, last, prompts, tape, seen, x, out, direct, logits, weights, idx, p
    free()
    errs = {}
    check_b7_at_request_shape("moe", cfg, gen, dev, errs)
    k["b7_at_request_shape"] = errs
    k["decode_32k"] = moe_decode_32k("moe", "kimi", cfg, params, gen, dev)
    launches += k["decode_32k"]["launches"]
    del params
    free()
    return launches, granite


DENSE_LEAVES = ("['wq']", "['wk']", "['wv']", "['wo']", "['w_gate']", "['w_up']", "['w_down']", "['embed']",
                "['lm_head']")


def dense_bytes(params: dict) -> int:
    """Bytes of an LM's dense weights, the leaves tensor parallelism cuts
    over the model axis: the attention projections, the dense FFN, embed
    and lm_head (not the experts or the norms)."""
    return sum(t.numel() * t.element_size() for path, t in leaves_with_paths(params)
               if path.endswith(DENSE_LEAVES) and "['moe']" not in path)


def check_dense_share(what: str, whole: dict, mine: dict, model_size: int) -> dict:
    """A rank's dense weights under tensor parallelism: every dense leaf
    of the LMs run here divides over the model axis, so the rank holds
    exactly the whole's bytes over ``model_size``."""
    held, total = dense_bytes(mine), dense_bytes(whole)
    if held * model_size != total:
        raise AssertionError(f"{what}: the rank holds {held} bytes of dense weights, not {total} / {model_size}")
    return {"dense_bytes": held, "dense_bytes_whole": total, "model_size": model_size}


def _first_layers(tree: dict, n: int) -> dict:
    """The first ``n`` layers of stacked per-layer leaves (views)."""
    return {key: _first_layers(v, n) if isinstance(v, dict) else v[:n] for key, v in tree.items()}


def long_cache_part(cfg, seq: int, lo: int, hi: int, dev) -> dict:
    """Positions ``[lo, hi)`` of the mesh_lm phase's random long_500k
    cache: k, v (layers, 1, hi - lo, G, Dh), each block of LONG_BLOCK
    positions of each layer and tensor drawn from its own generator, so
    that a rank draws its shard as the whole cache holds it."""
    shape = (cfg.n_layers, 1, hi - lo, cfg.n_kv_heads, cfg.d_head)
    out = {}
    for t, name in enumerate(("k", "v")):
        buf = torch.empty(shape, dtype=cfg.dtype, device=dev)
        for layer in range(cfg.n_layers):
            for b0 in range(lo, hi, LONG_BLOCK):
                g = torch.Generator(device=dev)
                g.manual_seed(SEED + 7919 * (2 * layer + t) + b0 // LONG_BLOCK)
                block = torch.randn((1, LONG_BLOCK, cfg.n_kv_heads, cfg.d_head), generator=g, device=dev)
                buf[layer, :, b0 - lo : b0 - lo + LONG_BLOCK] = block.to(cfg.dtype)
        out[name] = buf
    return out


def long_tokens(cfg, dev) -> list[torch.Tensor]:
    """The mesh_lm decode steps' tokens, one (1,) tensor a step."""
    toks = pipeline.lm_batch(cfg.vocab, 1, MESH_LM_STEPS + 1, step=2, seed=SEED, device=dev)["tokens"][0]
    return [toks[i : i + 1].contiguous() for i in range(MESH_LM_STEPS + 1)]


def long_steps(step, params: dict, cache: dict, tokens: list) -> tuple[list, list[float]]:
    """MESH_LM_STEPS decode steps from the cache's len, then one more with
    len set to MESH_LM_LOW: each step's logits and its ms between CUDA
    events."""
    outs, ms = [], []
    for i, tok in enumerate(tokens):
        if i == MESH_LM_STEPS:
            cache = dict(cache, len=torch.tensor(MESH_LM_LOW, dtype=torch.int32, device=tok.device))
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        logits, cache = step(params, cache, tok)
        t1.record()
        torch.cuda.synchronize()
        outs.append(logits)
        ms.append(t0.elapsed_time(t1))
    return outs, ms


def check_b7_entries(cfg, cache: dict, dev, flush) -> dict:
    """B7's partials and combine entries at the shapes of the mesh_lm
    phase's ranks (a long_500k shard of S / MESH_LM_SHAPE[1] positions,
    layer 0's K and V), on every shard with its offset, at kv_len S - 16
    and MESH_LM_LOW (three shards past it): the kernels' merge against the
    plain twins' and against ``flash_decode_gqa_plain`` on the whole cache
    (BF16_TOL of the largest |output|), a shard past kv_len (-1e30, 0, 0),
    one shard at offset 0 bit for bit ``flash_decode_gqa`` (B7's own
    launches); then the partials of one shard and the combine of all
    timed beside their plain twins and bounds.  No launch here counts."""
    seq = cache["k"].shape[2]
    M = MESH_LM_SHAPE[1]
    s_loc = seq // M
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    q = torch.randn((1, cfg.n_q_heads, cfg.d_head), generator=gen, device=dev).to(cfg.dtype)
    k, v = cache["k"][0], cache["v"][0]
    shards = [(k[:, i * s_loc : (i + 1) * s_loc].contiguous(), v[:, i * s_loc : (i + 1) * s_loc].contiguous())
              for i in range(M)]
    out = {}
    for kv in (seq - 16, MESH_LM_LOW):
        kv_len = torch.tensor(kv, dtype=torch.int32, device=dev)
        parts = [decode_attn.flash_decode_gqa_partials(q, ks, vs, kv_len, i * s_loc)
                 for i, (ks, vs) in enumerate(shards)]
        plains = [decode_attn.flash_decode_gqa_partials_plain(q, ks, vs, kv_len, i * s_loc)
                  for i, (ks, vs) in enumerate(shards)]

        def merge(ps):
            return decode_attn.ranks_major(torch.stack([p.buf for p in ps]), ps[0].shape)

        got = decode_attn.flash_decode_combine(merge(parts), cfg.dtype)
        plain = decode_attn.flash_decode_combine_plain(merge(plains), cfg.dtype)
        whole = decode_attn.flash_decode_gqa_plain(q, k, v, kv_len)
        scale = float(whole.float().abs().max())
        errs = {"vs_plain_twins": float((got.float() - plain.float()).abs().max()),
                "vs_whole_plain": float((got.float() - whole.float()).abs().max())}
        if not torch.isfinite(got.float()).all() or max(errs.values()) > BF16_TOL * scale:
            raise AssertionError(f"B7 partials + combine at kv_len {kv}: {errs} > {BF16_TOL} x {scale}")
        past = [i for i in range(M) if i * s_loc >= kv]
        if any(not ((parts[i].m == -1e30).all() and (parts[i].l == 0).all() and (parts[i].acc == 0).all())
               for i in past):
            raise AssertionError(f"B7 partials: a shard past kv_len {kv} wrote nonzero weight")
        one = decode_attn.flash_decode_combine(decode_attn.flash_decode_gqa_partials(q, k, v, kv_len, 0), cfg.dtype)
        if not torch.equal(one, decode_attn.flash_decode_gqa(q, k, v, kv_len)):
            raise AssertionError(f"B7 partials + combine on the whole cache != flash_decode_gqa at kv_len {kv}")
        out[f"kv{kv}"] = {**errs, "largest_abs_out": scale, "limit": BF16_TOL * scale, "shards_past": past}
    # times at kv_len S - 16: shard 0's partials (all its positions valid), the combine of the M shards
    kv_len = torch.tensor(seq - 16, dtype=torch.int32, device=dev)
    ks, vs = shards[0]
    n_split, split_len = decode_attn.decode_splits(1, cfg.n_kv_heads, s_loc)
    part_bytes = cfg.n_q_heads * n_split * (cfg.d_head + 2) * 4
    merged = decode_attn.ranks_major(torch.stack([p.buf for p in parts]), parts[0].shape)
    t = {"partials": timed(lambda: decode_attn.flash_decode_gqa_partials(q, ks, vs, kv_len, 0), 3, 3, flush),
         "combine": timed(lambda: decode_attn.flash_decode_combine(merged, cfg.dtype), 3, 3, flush)}
    t["partials"]["plain_ms"] = events_ms(
        lambda: decode_attn.flash_decode_gqa_partials_plain(q, ks, vs, kv_len, 0), 2, flush)
    t["combine"]["plain_ms"] = events_ms(lambda: decode_attn.flash_decode_combine_plain(merged, cfg.dtype), 2, flush)
    t["partials"]["bound_ms"], t["partials"]["bound_by"] = bound(
        2 * s_loc * cfg.n_kv_heads * cfg.d_head * 2 + q.numel() * 2 + part_bytes,
        4 * cfg.n_q_heads * s_loc * cfg.d_head, BF16_FLOPS)
    t["combine"]["bound_ms"], t["combine"]["bound_by"] = bound(
        M * part_bytes + q.numel() * 2, 3 * M * n_split * cfg.n_q_heads * (cfg.d_head + 2), FP32_FLOPS)
    out.update(times=t, n_split=n_split, split_len=split_len, partial_bytes=part_bytes, shard=s_loc)
    log("mesh_lm", f"B7's entries at the ranks' shard (S_loc {s_loc} of {seq}, {n_split} splits of {split_len}, "
        f"{part_bytes} bytes of partials a shard): the kernels' merge over {M} shards ~= the plain twins' and "
        f"flash_decode_gqa_plain on the whole cache at kv_len {seq - 16} and {MESH_LM_LOW} "
        f"({[out[k] for k in out if k.startswith('kv')]}); shards past kv_len write (-1e30, 0, 0); one shard at "
        f"offset 0 == flash_decode_gqa bit for bit; partials {t['partials']['ms']:.4f} ms flushed "
        f"({t['partials']['warm_ms']:.4f} warm, plain {t['partials']['plain_ms']:.4f}, bound "
        f"{t['partials']['bound_ms']:.4f} by {t['partials']['bound_by']}); combine of {M} x {n_split} splits "
        f"{t['combine']['ms']:.4f} ms (plain {t['combine']['plain_ms']:.4f}, bound {t['combine']['bound_ms']:.4f} "
        f"by {t['combine']['bound_by']})")
    return out


def check_long_logits(got: list, want: list, what: str, exact: bool) -> list[float]:
    """The mesh_lm steps' logits against the one-card run's: bit for bit
    with ``exact``, else within BF16_TOL of the largest |logit|; the max
    |diff| of each step."""
    errs = []
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        g, w = g.to(w.device), w
        err, scale = float((g.float() - w.float()).abs().max()), float(w.float().abs().max())
        if not torch.isfinite(g.float()).all() or (not torch.equal(g, w) if exact else err > BF16_TOL * scale):
            raise AssertionError(f"{what} step {i}: logits differ from one card's: max |diff| {err} (largest "
                                 f"|logit| {scale}{'' if exact else f', limit {BF16_TOL} x it'})")
        errs.append(err)
    return errs


class MoECheck:
    """``layers.apply_moe`` wrapped on a rank: each call at capacity factor
    ``cf``, its output held to ``moe_capacity_plain`` on the rank's own
    block (that block's routing over a (1, M) layout is the rank's share
    of the mesh's: the ``all_to_all``s run over the model axis only) with
    the layer's whole experts, and at a capacity that drops nothing also
    to the one-card layer; within BF16_TOL of the largest |value|.  Drops
    and assignments are summed per capacity."""

    def __init__(self, cfg, moe: dict, model_size: int, model_index: int):
        self.cfg, self.moe, self.model_index = cfg, moe, model_index
        self.rules = shd.Rules.from_mesh(mesh_lib.MeshLayout(("data", "model"), (1, model_size)))
        self.stats: dict = {}

    def wrap(self, cf: float):
        apply, calls = lm_layers.apply_moe, [0]
        st = self.stats.setdefault(cf, {"calls": 0, "assignments": 0, "dropped": 0, "max_abs_err": 0.0,
                                        "largest_abs_out": 0.0})

        def fn(p, x, **kw):
            out = apply(p, x, capacity_factor=cf, **kw)
            whole = {k: w[calls[0] % self.cfg.n_layers] for k, w in self.moe.items()}
            calls[0] += 1
            want, kept = lm_layers.moe_capacity_plain(whole, x, n_experts=self.cfg.n_experts, top_k=self.cfg.top_k,
                                                      rules=self.rules, capacity_factor=cf,
                                                      model_index=self.model_index)
            refs = [want]
            if cf == MESH_MOE_NO_DROP:
                if not kept.all():
                    raise AssertionError(f"capacity {cf} dropped {int((~kept).sum())} assignments")
                # the one-card layer on each block the ranks route apart, so
                # that its router logits are the ranks' bits (a near tie
                # between a token's k-th and (k+1)-th expert falls alike)
                plan = lm_layers.moe_plan(self.rules, tuple(x.shape), self.cfg.n_experts, self.cfg.top_k, cf)
                sb = x.shape[1] // plan.M if plan.seq_axes else x.shape[1]
                refs.append(torch.cat([apply(whole, x[:, s0 : s0 + sb], n_experts=self.cfg.n_experts,
                                             top_k=self.cfg.top_k, rules=shd.Rules.from_mesh(None))
                                       for s0 in range(0, x.shape[1], sb)], dim=1))
            for w in refs:
                err, scale = float((out.float() - w.float()).abs().max()), float(w.float().abs().max())
                if not torch.isfinite(out.float()).all() or err > BF16_TOL * scale:
                    raise AssertionError(f"the expert-parallel layer at capacity {cf}: max |diff| {err} > "
                                         f"{BF16_TOL} x {scale}")
                st["max_abs_err"] = max(st["max_abs_err"], err)
                st["largest_abs_out"] = max(st["largest_abs_out"], scale)
            st["calls"] += 1
            st["assignments"] += kept.numel()
            st["dropped"] += int((~kept).sum())
            return out

        return fn


def mesh_lm_rank(rank: int, world: int, tmp: str) -> None:
    """One of the MESH_RANKS ``gloo`` ranks of the mesh_lm phase's (b) and
    (c): (b) qwen3-14b long_500k on MESH_LM_SHAPE, the rank's
    tensor-parallel blocks of the weights (:func:`check_dense_share`) and
    its shard of the cache drawn from the seed, the steps' logits held to
    the parent's one-card run; (c) granite-moe-1b-a400m expert-parallel,
    its attention and vocab tensor-parallel, on MESH_II_SHAPE: the request
    run at capacity 1.25 and MESH_MOE_NO_DROP,
    every MoE call held by :class:`MoECheck`; at MESH_MOE_NO_DROP again,
    fed the moe phase's one-card tokens and experts (``RouteTape``: a
    token may take other experts only at a near tie), its prefill and
    last logits held to that run's within BF16_TOL of the largest |logit|
    with no assignment dropped; then decode_32k at
    MESH_MOE_DECODE_LAYERS layers on the rank's block of a random cache.
    Writes its counts to ``rank{rank}.json``."""
    torch.set_num_threads(2)
    dev = ranks.init_rank(rank, world, os.path.join(tmp, "store"), backend="gloo", timeout_s=MESH_TIMEOUT_S)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        refs = torch.load(os.path.join(tmp, "refs.pt"), map_location=dev)
        rec = {"rank": rank}
        # (b) the long_500k decode over the sequence
        cfg = dataclasses.replace(QWEN, n_layers=LM_LAYERS)
        _, seq = DECODE_SHAPES["long_500k"]
        mesh = mesh_lib.make_test_mesh(*MESH_LM_SHAPE)
        t0 = time.perf_counter()
        whole = transformer.init_params(cfg, seed=SEED, device=dev)
        with shd.use_mesh(mesh):
            rules = transformer.rules_for(cfg, mesh)
            m, M = collectives.axis_index(mesh, rules.model_axis), rules.model_size
            params = transformer.shard_params(cfg, rules, whole)  # the rank's tensor-parallel blocks
            dense = check_dense_share(f"mesh_lm (b) rank {rank}", whole, params, M)
            del whole
            free()
            shard = {**long_cache_part(cfg, seq, m * seq // M, (m + 1) * seq // M, dev),
                     "len": torch.tensor(seq - 17, dtype=torch.int32, device=dev)}
            step = transformer.make_decode_step(cfg, rules, seq_sharded=True)
            collectives.WIRE_COUNTERS.clear()
            reset_launches()
            got, ms = long_steps(step, params, shard, long_tokens(cfg, dev))
            counts = launched(B7_ENTRIES[1:], f"mesh_lm (b) rank {rank}")
        steps = len(got)
        if any(n != cfg.n_layers * steps for n in counts.values()):
            raise AssertionError(f"mesh_lm (b) rank {rank}: B7 entries {counts}, expected layers x steps")
        errs = check_long_logits(got, refs["long"], f"mesh_lm (b) rank {rank}", exact=False)
        largest = max(float(w.float().abs().max()) for w in refs["long"])
        rec["b"] = {"launches": counts, "max_abs_err": errs, "ms": ms, "wall_s": time.perf_counter() - t0,
                    "all_reduces_per_step": collectives.WIRE_COUNTERS["all_reduces"] / steps,
                    "bytes_per_step": collectives.WIRE_COUNTERS["bytes"] / steps,
                    "shard_positions": seq // M, "largest_abs_logit": largest, **dense}
        del params, shard, got, step
        free()
        # (c) granite-moe-1b-a400m, experts over the model axis
        cfg = GRANITE
        mesh = mesh_lib.make_test_mesh(*MESH_II_SHAPE)
        t0 = time.perf_counter()
        params = transformer.init_params(cfg, seed=SEED, device=dev)
        b7 = 0
        with shd.use_mesh(mesh):
            rules = transformer.rules_for(cfg, mesh)
            mine = transformer.shard_params(cfg, rules, params)
            dense = check_dense_share(f"mesh_lm (c) rank {rank}", params, mine, rules.model_size)
            check = MoECheck(cfg, params["layers"]["moe"], rules.model_size,
                             collectives.axis_index(mesh, rules.model_axis))
            prompts = pipeline.lm_batch(cfg.vocab, LM_REQUESTS, LM_PROMPT, step=0, seed=SEED, device=dev)["tokens"]
            for cf in (1.25, MESH_MOE_NO_DROP):
                collectives.WIRE_COUNTERS.clear()
                reset_launches()
                with patched(lm_layers, "apply_moe", check.wrap(cf)):
                    first, last, _ = lm_request_run(cfg, rules, mine, prompts)
                n = only_launched("flash_decode_gqa", f"mesh_lm (c) rank {rank} request run at {cf}")
                if n != cfg.n_layers * LM_NEW:
                    raise AssertionError(f"mesh_lm (c) rank {rank}: {n} B7 launches at {cf}")
                b7 += n
                for logits in (first, last):
                    if logits.shape != (LM_REQUESTS, cfg.padded_vocab) or not torch.isfinite(logits.float()).all():
                        raise AssertionError(f"mesh_lm (c) rank {rank}: logits not finite or of the wrong shape")
                check.stats[cf].update(all_to_alls=collectives.WIRE_COUNTERS["all_to_all"],
                                       bytes=collectives.WIRE_COUNTERS["bytes"])
            # the whole model through the tensor-parallel attention and vocab,
            # held to one card's: fed its tokens and its experts
            want = refs["granite"]
            tape, drops = RouteTape(), {}
            tape.calls = [(w, None, idx) for w, idx in want["routes"]]
            moe = functools.partial(lm_layers.apply_moe, capacity_factor=MESH_MOE_NO_DROP)
            reset_launches()
            with counted_drops(drops), patched(lm_layers, "apply_moe", moe), \
                    tape.replay_blocks(rules, mesh, LM_REQUESTS, cfg.n_experts):
                first, last, _ = lm_request_run(cfg, rules, mine, prompts, want["fed"])
            n = only_launched("flash_decode_gqa", f"mesh_lm (c) rank {rank} request run held to one card's")
            if n != cfg.n_layers * LM_NEW or drops["dropped"]:
                raise AssertionError(f"mesh_lm (c) rank {rank}: {n} B7 launches, {drops} at {MESH_MOE_NO_DROP}")
            b7 += n
            one_card = {"max_abs_err": check_long_logits([first, last], [want["first"], want["last"]],
                                                         f"mesh_lm (c) rank {rank} request run", exact=False),
                        "largest_abs_logit": [float(w.float().abs().max()) for w in (want["first"], want["last"])],
                        "route_audit": tape.audit, **drops}
            del want, tape
            # decode_32k on MESH_MOE_DECODE_LAYERS layers, the rank's block of the batch
            del first, last
            free()
            cut = dataclasses.replace(cfg, n_layers=MESH_MOE_DECODE_LAYERS)
            cut_params = dict(mine, layers=_first_layers(mine["layers"], MESH_MOE_DECODE_LAYERS))
            batch, seq = DECODE_SHAPES["decode_32k"]
            lo, hi, _ = collectives.batch_block(rules, batch)
            gen = torch.Generator(device=dev)
            gen.manual_seed(SEED + 100 + rank)
            kv_shape = (cut.n_layers, hi - lo, seq, cut.n_kv_heads, cut.d_head)
            cache = {"k": lm_layers.normal(kv_shape, 1.0, cut.dtype, gen),
                     "v": lm_layers.normal(kv_shape, 1.0, cut.dtype, gen),
                     "len": torch.tensor(seq - 17, dtype=torch.int32, device=dev)}
            tokens = pipeline.lm_batch(cut.vocab, batch, 1, step=1, seed=SEED, device=dev)["tokens"][:, 0].contiguous()
            step = transformer.make_decode_step(cut, rules)
            dcheck = MoECheck(cut, params["layers"]["moe"], rules.model_size, check.model_index)
            with patched(lm_layers, "apply_moe", dcheck.wrap(1.25)):
                step(cut_params, cache, tokens)
            collectives.WIRE_COUNTERS.clear()
            r, outs = timed_steps("mesh_lm", f"(c) rank {rank} decode_32k", lambda _: step(cut_params, cache, tokens)[0],
                                  [None] * (MOE_DECODE_STEPS + MOE_WARMUP), "flash_decode_gqa", cut.n_layers,
                                  MOE_WARMUP)
            for logits in outs:
                if logits.shape != (batch, cut.padded_vocab) or not torch.isfinite(logits.float()).all():
                    raise AssertionError(f"mesh_lm (c) rank {rank} decode_32k: logits not finite or of the wrong shape")
            steps = MOE_DECODE_STEPS + MOE_WARMUP
            r.update(check=dcheck.stats[1.25], block=[lo, hi], cap_send=lm_layers.moe_plan(
                rules, (batch, 1, cut.d_model), cut.n_experts, cut.top_k).cap_send,
                     all_to_alls_per_step=collectives.WIRE_COUNTERS["all_to_all"] / steps,
                     bytes_per_step=collectives.WIRE_COUNTERS["bytes"] / steps)
            b7 += r["launches"]
        rec["c"] = {"request": {str(cf): st for cf, st in check.stats.items()}, "one_card": one_card,
                    "decode_32k": r, "b7_launches": b7,
                    "wall_s": time.perf_counter() - t0, "peak_gb": torch.cuda.max_memory_allocated() / 1e9, **dense}
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def phase_mesh_lm(dev, flush, record, granite: dict) -> tuple[int, float]:
    """The models' last mesh programs on the card: qwen3-14b long_500k
    decode over a cache sharded along the sequence (B7's partials and
    combine entries, held to their plain twins first) on one NCCL rank (a)
    and MESH_RANKS ``gloo`` ranks (b); granite-moe-1b-a400m expert-parallel
    on MESH_RANKS ``gloo`` ranks (c); kimi-k2 at full width, one layer,
    expert-parallel with ``fsdp_experts`` on one NCCL rank (d).  ``granite``
    is the moe phase's one-card request run, which (c) is held to.  Returns
    (B7's launches over its entries, every rank's summed, and the entries'
    largest |diff| from plain)."""
    rec = record["mesh_lm"] = {}
    cfg = dataclasses.replace(QWEN, n_layers=LM_LAYERS)
    batch, seq = DECODE_SHAPES["long_500k"]
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, seed=SEED, device=dev)
    cache = {**long_cache_part(cfg, seq, 0, seq, dev), "len": torch.tensor(seq - 17, dtype=torch.int32, device=dev)}
    tokens = long_tokens(cfg, dev)
    rec["cache_bytes"] = tree_bytes({"k": cache["k"], "v": cache["v"]})
    entries = rec["b7_entries"] = check_b7_entries(cfg, cache, dev, flush)
    entries_err = max(max(v["vs_plain_twins"], v["vs_whole_plain"]) for k, v in entries.items() if k.startswith("kv"))
    one_card = {k: v.clone() for k, v in cache.items()}
    reset_launches()
    want, want_ms = long_steps(transformer.make_decode_step(cfg, shd.Rules.from_mesh(None)), params, one_card, tokens)
    launches = only_launched("flash_decode_gqa", "mesh_lm one-card long_500k decode")
    del one_card
    free()
    rec["one_card"] = {"ms": want_ms, "launches": launches, "setup_s": time.perf_counter() - t0}
    tmp = tempfile.mkdtemp(prefix="chip-smoke-mesh-lm-")
    ranks.init_rank(0, 1, os.path.join(tmp, "store1"), device=dev, timeout_s=MESH_TIMEOUT_S)
    try:
        mesh = mesh_lib.make_test_mesh(1, 1)
        # (a) the long_500k decode on one NCCL rank: B7's two entries, bit for bit one card's
        with shd.use_mesh(mesh):
            rules = transformer.rules_for(cfg, mesh)
            shard = transformer.cache_shard(cfg, rules, cache, seq_sharded=True)
            step = transformer.make_decode_step(cfg, rules, seq_sharded=True)
            collectives.WIRE_COUNTERS.clear()
            reset_launches()
            got, ms = long_steps(step, params, shard, tokens)
            counts = launched(B7_ENTRIES[1:], "mesh_lm (a)")
        steps = len(got)
        if any(n != cfg.n_layers * steps for n in counts.values()):
            raise AssertionError(f"mesh_lm (a): B7 entries {counts}, expected {cfg.n_layers} x {steps} each")
        check_long_logits(got, want, "mesh_lm (a)", exact=True)
        launches += sum(counts.values())
        rec["a"] = {"launches": counts, "ms": ms, "bytes_per_step": collectives.WIRE_COUNTERS["bytes"] / steps,
                    "all_reduces_per_step": collectives.WIRE_COUNTERS["all_reduces"] / steps}
        log("mesh_lm", f"(a) qwen3-14b long_500k ({cfg.n_layers} layers, batch {batch}, S {seq}, "
            f"{rec['cache_bytes'] / 1e9:.2f} GB of K and V) on one NCCL rank, (1, 1) mesh, seq_sharded: "
            f"{steps} steps (len {seq - 17}.. then {MESH_LM_LOW}), logits bit for bit one card's; B7 partials "
            f"{counts['flash_decode_gqa_partials']} and combine {counts['flash_decode_combine']} launches = "
            f"layers x steps, no other kernel; ms a step {[round(x, 4) for x in ms]} (one card "
            f"{[round(x, 4) for x in want_ms]}); {rec['a']['all_reduces_per_step']} all_reduces, "
            f"{rec['a']['bytes_per_step']:.0f} bytes a step")
        del params, cache, shard, got, step
        free()
        # (d) kimi-k2 at full width, one layer, its experts over the model axis with fsdp gathers
        launches += mesh_kimi(dev, mesh, rec)
    finally:
        dist.destroy_process_group()
    torch.save({"long": [w.cpu() for w in want], "granite": granite}, os.path.join(tmp, "refs.pt"))
    del want
    free()
    t0 = time.perf_counter()
    ranks.run_ranks(mesh_lm_rank, MESH_RANKS, (MESH_RANKS, tmp), timeout_s=MESH_TIMEOUT_S, device=dev)
    rec["bc_s"] = time.perf_counter() - t0
    rec["ranks"] = []
    for rank in range(MESH_RANKS):
        with open(os.path.join(tmp, f"rank{rank}.json")) as f:
            rec["ranks"].append(json.load(f))
    shutil.rmtree(tmp, ignore_errors=True)
    for rr in rec["ranks"]:
        b, c = rr["b"], rr["c"]
        launches += sum(b["launches"].values()) + c["b7_launches"]
        log("mesh_lm", f"(b) rank {rr['rank']} of {MESH_LM_SHAPE} ({b['shard_positions']} positions): logits "
            f"within {max(b['max_abs_err'])} of one card's (limit {BF16_TOL} x largest |logit| "
            f"{b['largest_abs_logit']}), the step at len "
            f"{MESH_LM_LOW} {b['max_abs_err'][-1]}; B7 entries {b['launches']}; {b['all_reduces_per_step']} "
            f"all_reduces, {b['bytes_per_step']:.0f} bytes a step; ms a step {[round(x, 2) for x in b['ms']]} "
            "(4 ranks on one card through gloo: not a multi-card time); tensor-parallel: "
            f"{b['dense_bytes']} bytes of dense weights = {b['dense_bytes_whole']} / {b['model_size']}")
        for cf, st in c["request"].items():
            log("mesh_lm", f"(c) rank {rr['rank']} of {MESH_II_SHAPE} granite request run at capacity {cf}: "
                f"{st['calls']} MoE calls held to moe_capacity_plain{' and the one-card layer' if float(cf) == MESH_MOE_NO_DROP else ''} "
                f"(max |diff| {st['max_abs_err']}, largest |out| {st['largest_abs_out']}); {st['dropped']} of "
                f"{st['assignments']} assignments dropped; {st['all_to_alls']} all_to_alls, {st['bytes']} bytes")
        o, a = c["one_card"], c["one_card"]["route_audit"]
        log("mesh_lm", f"(c) rank {rr['rank']} granite request run at capacity {MESH_MOE_NO_DROP}, fed one card's "
            f"tokens and experts: prefill and last-step logits within {o['max_abs_err']} of one card's (limit "
            f"{BF16_TOL} x largest |logit| {o['largest_abs_logit']}); {o['dropped']} of {o['slotted']} slotted "
            f"assignments dropped; router logits within {a['max_abs_logit_diff']:.5f} of one card's, the rank's own "
            f"top-{GRANITE.top_k} differs on {a['differ']} of {a['tokens']} tokens, each a near tie (largest gap "
            f"there {a['max_gap_where_differ']:.5f})")
        d = c["decode_32k"]
        log("mesh_lm", f"(c) rank {rr['rank']} decode_32k ({MESH_MOE_DECODE_LAYERS} layers, rows {d['block']}, cap_send "
            f"{d['cap_send']}): median {d['median_ms']:.3f} ms a step, {d['launches']} B7 launches = layers x "
            f"steps; {d['check']['dropped']} of {d['check']['assignments']} dropped in the checked step; "
            f"{d['all_to_alls_per_step']} all_to_alls, {d['bytes_per_step']:.0f} bytes a step; {c['peak_gb']:.2f} GB "
            f"peak on the rank; tensor-parallel attention and vocab: {c['dense_bytes']} bytes of dense weights = "
            f"{c['dense_bytes_whole']} / {c['model_size']}")
    log("mesh_lm", f"(b) and (c): {MESH_RANKS} gloo ranks sharing one card, {rec['bc_s']:.1f} s wall (spawn "
        "included; not a multi-card time)")
    return launches, entries_err


def mesh_kimi(dev, mesh, rec: dict) -> int:
    """The mesh_lm phase's (d) on the installed one-rank NCCL ``mesh``:
    kimi-k2-1t-a32b at full width with KIMI_LAYERS layer, its MoE layer
    expert-parallel with ``fsdp_experts``, the request run with every MoE
    call held by :class:`MoECheck`.  Returns B7's launches."""
    cfg = dataclasses.replace(KIMI, n_layers=KIMI_LAYERS)
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, seed=SEED, device=dev)
    with shd.use_mesh(mesh):
        rules = transformer.rules_for(cfg, mesh)
        mine = transformer.shard_params(cfg, rules, params)
        check = MoECheck(cfg, params["layers"]["moe"], rules.model_size, 0)
        prompts = pipeline.lm_batch(cfg.vocab, LM_REQUESTS, LM_PROMPT, step=0, seed=SEED, device=dev)["tokens"]
        collectives.WIRE_COUNTERS.clear()
        reset_launches()
        with patched(lm_layers, "apply_moe", check.wrap(1.25)):
            first, last, _ = lm_request_run(cfg, rules, mine, prompts)
        n = only_launched("flash_decode_gqa", "mesh_lm (d) kimi request run")
    if n != cfg.n_layers * LM_NEW:
        raise AssertionError(f"mesh_lm (d): {n} B7 launches, expected {cfg.n_layers} x {LM_NEW}")
    for logits in (first, last):
        if logits.shape != (LM_REQUESTS, cfg.padded_vocab) or not torch.isfinite(logits.float()).all():
            raise AssertionError("mesh_lm (d): kimi logits not finite or of the wrong shape")
    st = check.stats[1.25]
    rec["d"] = {**st, "launches": n, "wall_s": time.perf_counter() - t0,
                "all_to_alls": collectives.WIRE_COUNTERS["all_to_all"],
                "all_gathers": collectives.WIRE_COUNTERS["all_gather"], "bytes": collectives.WIRE_COUNTERS["bytes"]}
    log("mesh_lm", f"(d) kimi-k2 at full width, {cfg.n_layers} layer, on one NCCL rank, experts over the model axis "
        f"with fsdp_experts: the request run ({LM_REQUESTS} x {LM_PROMPT}, {LM_NEW} steps), {st['calls']} MoE calls "
        f"held to moe_capacity_plain (max |diff| {st['max_abs_err']}, largest |out| {st['largest_abs_out']}); "
        f"{st['dropped']} of {st['assignments']} assignments dropped at capacity 1.25; {n} B7 launches; "
        f"{rec['d']['all_to_alls']} all_to_alls, {rec['d']['all_gathers']} all_gathers (one-rank data axis: no "
        f"copy), {rec['d']['bytes']} bytes; {rec['d']['wall_s']:.1f} s")
    del params, mine, first, last, prompts
    free()
    return n


def gnn_scatters(cfg) -> int:
    """B6 launches in one serve step with graph ids: GCN's two degree
    scatters and one a layer; SchNet's one an interaction, NequIP's one a
    layer (its three irreps in one row), EquiformerV2's two a layer (the
    softmax denominators, the messages), each with one readout."""
    if isinstance(cfg, gnn.GCNConfig):
        return 2 + cfg.n_layers
    if isinstance(cfg, gnn.SchNetConfig):
        return cfg.n_interactions + 1
    if isinstance(cfg, gnn.NequIPConfig):
        return cfg.n_layers + 1
    return 2 * cfg.n_layers + 1


def gnn_case(what: str, cfg, params: dict, batch: dict, scatters: int, tol: float, rec: dict,
             pending: list | None = None) -> dict:
    """One GNN serve step on the card: GNN_STEPS steps timed by CUDA events
    after GNN_WARMUP, B6 launching ``scatters`` times a step and nothing
    else; the output finite and within ``tol`` of the largest |output| of
    the port's CPU run of the same weights and batch.  With ``pending``
    the CPU run goes to a :class:`Background` thread and the check to
    ``pending``, for the caller to call once the card's work is done."""
    step = gnn.make_gnn_serve_step(cfg, shd.Rules.from_mesh(None))
    r, outs = timed_steps("gnn", what, lambda _: step(params, batch), [None] * (GNN_STEPS + GNN_WARMUP),
                          "embedding_bag_sorted", scatters, GNN_WARMUP)
    out = outs[0]
    if not torch.isfinite(out).all() or any(not torch.equal(o, out) for o in outs[1:]):
        raise AssertionError(f"gnn {what}: outputs not finite or not the same from step to step")
    out = out.cpu()
    run = Background(f"gnn {what} CPU run", functools.partial(step, tree_to(params, "cpu"), tree_to(batch, "cpu")))
    del outs
    r.update({"scatters_per_step": scatters, "out_shape": list(out.shape)})
    rec[what] = r

    def check() -> None:
        want = run.result()
        scale = float(want.abs().max())
        err = float((out - want).abs().max())
        if out.shape != want.shape or err > tol * scale:
            raise AssertionError(f"gnn {what}: the card's output differs from the CPU run: max |diff| {err} > "
                                 f"{tol} x {scale}")
        r.update({"max_abs_err": err, "largest_abs_out": scale, "limit": tol * scale, "cpu_s": run.seconds,
                  "cpu_waited_s": run.waited_s})
        log("gnn", f"{what}: {r['steps']} steps, {r['launches']} B6 launches = {scatters} scatters a step, no "
            f"other kernel; median {r['median_ms']:.4f} ms, p99 {r['p99_ms']:.4f} ms a step (CUDA events); output "
            f"{tuple(out.shape)} within {err} of the CPU run ({run.seconds:.1f} s, {run.waited_s:.1f} s waited "
            f"for; limit {tol} x largest {scale})")

    if pending is None:
        check()
    else:
        pending.append(check)
    return r


def phase_gnn(dev, gen, record) -> int:
    """The four GNNs' serve steps, every scatter and readout on B6: (a)
    gcn-cora at ogb_products, (b) gcn-cora on a minibatch_lg block drawn
    by NeighborSampler, (c) schnet, nequip and equiformer-v2 at molecule;
    one equiformer-v2 step traced.  Returns B6's launches."""
    rec = record["gnn"] = {"data": "drawn from the seed: no dataset is in the repo"}
    gcn_full = registry.get_arch("gcn-cora").full()

    # (a) ogb_products: uniform edges, padded to pad_edges and masked
    shape = registry.GNN_SHAPES["ogb_products"]
    cfg = gnn_common.gcn_for_shape(gcn_full, shape)
    n, e, _ = gnn_common.shape_counts(shape)
    e_pad = gnn_common.pad_edges(e)
    src = torch.randint(0, n, (e_pad,), generator=gen, device=dev, dtype=torch.int32)
    dst = torch.randint(0, n, (e_pad,), generator=gen, device=dev, dtype=torch.int32)
    src[e:], dst[e:] = 0, 0
    batch = {"node_feat": torch.randn((n, cfg.d_feat), generator=gen, device=dev),
             "edge_src": src, "edge_dst": dst, "edge_mask": torch.arange(e_pad, device=dev) < e,
             "node_mask": torch.ones(n, dtype=torch.bool, device=dev)}
    params = gnn.gcn_init(cfg, seed=SEED, device=dev)
    pending: list = []  # (a)'s CPU run goes on beside (b) and (c)
    r = gnn_case("gcn ogb_products", cfg, params, batch, gnn_scatters(cfg), GNN_TOL, rec, pending)
    r.update({"nodes": n, "edges": e, "padded_edges": e_pad, "nodes_per_s": n / r["median_ms"] * 1e3})
    log("gnn", f"gcn ogb_products: {n} nodes x {cfg.d_feat} f32 features, {e} uniform edges padded to {e_pad} "
        f"(masked), {cfg.n_classes} classes = {r['nodes_per_s']:.4g} nodes/s")
    launches = r["launches"]
    del batch, src, dst, params
    free()

    # (b) minibatch_lg: a 1,024-seed block of a uniform graph of reddit's counts
    shape = registry.GNN_SHAPES["minibatch_lg"]
    cfg = gnn_common.gcn_for_shape(gcn_full, shape)
    n_graph, e_graph = shape.dims["n_nodes"], shape.dims["n_edges"]
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    graph = LabeledGraph(n_graph, rng.integers(0, n_graph, e_graph, dtype=np.int32),
                         np.zeros(e_graph, np.int32), rng.integers(0, n_graph, e_graph, dtype=np.int32), ["e"])
    sampler = NeighborSampler(graph)
    build_s = time.perf_counter() - t0
    del graph
    seeds = rng.choice(n_graph, MINIBATCH_SEEDS, replace=False)
    t0 = time.perf_counter()
    sub = sampler.sample(seeds, MINIBATCH_FANOUT, seed=SEED)
    sample_ms = (time.perf_counter() - t0) * 1e3
    del sampler
    want_n, want_e, _ = gnn_common.shape_counts(shape)
    if (sub.nodes.shape[0], sum(len(m) for m in sub.edge_mask)) != (want_n, want_e):
        raise AssertionError(f"gnn minibatch_lg: a block of {sub.nodes.shape[0]} nodes and "
                             f"{sum(len(m) for m in sub.edge_mask)} edges, shape_counts says {want_n}, {want_e}")
    pad = gnn_common.pad_edges(want_e) - want_e  # the layers' edges, then masked pads

    def edges(arrays: list, fill) -> torch.Tensor:
        return torch.from_numpy(np.concatenate(arrays + [np.full(pad, fill, arrays[0].dtype)])).to(dev)

    nodes = torch.from_numpy(sub.nodes).to(dev)
    table = torch.randn((n_graph, cfg.d_feat), generator=gen, device=dev)
    real = nodes >= 0
    batch = {"node_feat": table[nodes.clamp(min=0).long()] * real[:, None],
             "edge_src": edges(sub.edge_src, 0), "edge_dst": edges(sub.edge_dst, 0),
             "edge_mask": edges(sub.edge_mask, False), "node_mask": real}
    del table
    params = gnn.gcn_init(cfg, seed=SEED, device=dev)
    r = gnn_case("gcn minibatch_lg", cfg, params, batch, gnn_scatters(cfg), GNN_TOL, rec)
    r.update({"graph_nodes": n_graph, "graph_edges": e_graph, "graph_build_s": build_s, "sample_ms": sample_ms,
              "block_nodes": sub.n_real_nodes, "block_edges": int(batch["edge_mask"].sum()),
              "seeds_per_s": MINIBATCH_SEEDS / r["median_ms"] * 1e3})
    log("gnn", f"gcn minibatch_lg: NeighborSampler over {n_graph} nodes and {e_graph} uniform edges (built in "
        f"{build_s:.1f} s of host time); {MINIBATCH_SEEDS} seeds, fanout {MINIBATCH_FANOUT}: {sub.n_real_nodes} "
        f"nodes and {r['block_edges']} edges of a {want_n}-node, {want_e}-edge block, sampled in "
        f"{sample_ms:.1f} host ms; {cfg.d_feat} features, {cfg.n_classes} classes; serve {r['median_ms']:.4f} ms "
        f"= {r['seeds_per_s']:.4g} seeds/s")
    launches += r["launches"]
    del batch, nodes, real, params, sub
    free()

    # (c) the molecular GNNs at molecule
    shape = registry.GNN_SHAPES["molecule"]
    d = shape.dims
    batch = pipeline.molecules_batch(d["batch"], d["n_nodes"], d["n_edges"], seed=SEED, device=dev)
    for arch in ("schnet", "nequip", "equiformer-v2"):
        cfg = registry.get_arch(arch).full()
        params = gnn.INIT_FNS[arch](cfg, seed=SEED, device=dev)
        tol = GNN_TOL_EQUIFORMER if arch == "equiformer-v2" else GNN_TOL
        r = gnn_case(f"{arch} molecule", cfg, params, batch, gnn_scatters(cfg), tol, rec, pending)
        r["molecules_per_s"] = d["batch"] / r["median_ms"] * 1e3
        log("gnn", f"{arch} molecule: {d['batch']} molecules x {d['n_nodes']} atoms, {d['n_edges']} edges each = "
            f"{r['molecules_per_s']:.1f} molecules/s")
        launches += r["launches"]
        if arch == "equiformer-v2":
            step = gnn.make_gnn_serve_step(cfg, shd.Rules.from_mesh(None))
            tr = device_trace(lambda: step(params, batch))
            share = kernel_share(tr, ("embedding_bag_kernel",))
            r["trace"] = {**tr, "b6": share}
            log_trace("gnn", "equiformer-v2 molecule step", tr, share, "B6")
        del params
    del batch
    free()
    for check in pending:  # the CPU runs, each against its card output
        check()
    return launches


# ---------------------------------------------------------------------------
# train: GCN at ogb_products, DLRM at train_batch, qwen3-14b at train_4k
# ---------------------------------------------------------------------------


_RELU = torch.relu
_RELU_LOCAL = threading.local()  # a Background thread's own handler
_RELU_CARD = [None]  # the handler of every other thread


def _relu(x):
    handler = getattr(_RELU_LOCAL, "fn", None) if in_background() else _RELU_CARD[0]
    return _RELU(x) if handler is None else handler(x)


@contextlib.contextmanager
def relu_handler(fn):
    """``torch.relu`` calls handed to ``fn`` inside the block: a
    :class:`Background` thread's own calls, or else the calls of every
    thread but the Background ones (a CPU replay beside a card run keeps
    its handler, the card run its)."""
    torch.relu = _relu  # without a handler it is torch.relu
    local = in_background()
    old = getattr(_RELU_LOCAL, "fn", None) if local else _RELU_CARD[0]
    if local:
        _RELU_LOCAL.fn = fn
    else:
        _RELU_CARD[0] = fn
    try:
        yield
    finally:
        if local:
            _RELU_LOCAL.fn = old
        else:
            _RELU_CARD[0] = old


class ReluTape:
    """The card's ReLU decisions, call by call of ``torch.relu``:
    :meth:`record` keeps each call's input on the host; :meth:`replay`
    feeds a CPU run those decisions, call for call (``x * mask``, whose
    derivative is the mask, as ``relu``'s is).  A ReLU's derivative jumps
    at 0: where the two devices round a pre-activation to either side of
    it, a gradient that sums a batch's terms of either sign moves by a
    whole term (1-2% of a DLRM MLP leaf at 4,096 samples), far beyond
    rounding.  The audit lets the CPU's own decision differ from the
    card's only where |pre-activation| is at most twice the largest
    |difference| of that call's inputs between the two runs."""

    def __init__(self):
        self.inputs: list[torch.Tensor] = []
        self.audit = {"calls": 0, "elements": 0, "differ": 0, "max_abs_input_diff": 0.0,
                      "max_abs_where_differ": 0.0}

    @contextlib.contextmanager
    def record(self):
        def rec(x):
            self.inputs.append(x.detach().cpu())
            return _RELU(x)

        with relu_handler(rec):
            yield self

    @contextlib.contextmanager
    def replay(self):
        calls = iter(self.inputs)

        def rep(x):
            card = next(calls).to(x.dtype)
            mask = card > 0
            diff = float((x.detach() - card).abs().max())
            differ = (x.detach() > 0) != mask
            a = self.audit
            a["calls"], a["elements"] = a["calls"] + 1, a["elements"] + x.numel()
            a["max_abs_input_diff"] = max(a["max_abs_input_diff"], diff)
            if differ.any():
                where = float(x.detach()[differ].abs().max())
                if where > 2 * diff:
                    raise AssertionError(f"relu call {a['calls']}: a decision differs at |x| {where} > 2 x {diff}")
                a["differ"] += int(differ.sum())
                a["max_abs_where_differ"] = max(a["max_abs_where_differ"], where)
            return x * mask.to(x.dtype)

        with relu_handler(rep):
            yield self
        if next(calls, None) is not None:
            raise AssertionError("the CPU run made fewer relu calls than the card's")


class StepTimer:
    """A train step wrapped in CUDA events: each call's device-timeline ms,
    host work inside, as a caller waits for it."""

    def __init__(self, step):
        self.step, self.events = step, []

    def __call__(self, params, opt_state, batch):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        out = self.step(params, opt_state, batch)
        t1.record()
        self.events.append((t0, t1))
        return out

    def ms(self) -> list[float]:
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


class B6Calls:
    """Every ``embedding_bag_sorted`` call, with its inputs and output,
    while installed (``patched(embedbag, "embedding_bag_sorted", ...)``):
    the backward's launches come after the forward's."""

    def __init__(self):
        self.real, self.calls = embedbag.embedding_bag_sorted, []

    def __call__(self, table, idx, bags, n_bags):
        out = self.real(table, idx, bags, n_bags)
        self.calls.append((table, idx, bags, n_bags, out))
        return out


def grads_with_b6_calls(loss, params, n_forward: int, n_backward: int, what: str):
    """``value_and_grad(loss)(params)`` with B6's calls recorded: exactly
    ``n_forward`` then ``n_backward`` launches, each backward launch
    ``torch.equal`` to the plain version on its real cotangent and
    transposed lookups, and zero exactly on the rows no lookup reads.
    Returns (loss, grads, the backward calls)."""
    calls = B6Calls()
    with patched(embedbag, "embedding_bag_sorted", calls):
        value, grads = value_and_grad(loss)(params)
    torch.cuda.synchronize()
    if len(calls.calls) != n_forward + n_backward:
        raise AssertionError(f"{what}: {len(calls.calls)} B6 calls, expected {n_forward} + {n_backward}")
    backward = calls.calls[n_forward:]
    for i, (cot, idx_t, bags_t, n_rows, out) in enumerate(backward):
        want = embedbag.embedding_bag_sorted_plain(cot, idx_t, bags_t, n_rows)
        read = torch.zeros(n_rows, dtype=torch.bool, device=cot.device)
        read[bags_t.long()] = True
        if not torch.equal(out, want) or bool(out[~read].any()):
            raise AssertionError(f"{what}: backward B6 launch {i} != plain, or nonzero on an unread row")
    return value, grads, backward


def hold_tree(got, want, tol_of, what: str) -> dict:
    """Each leaf of ``got`` (the card's) within ``tol_of(path, leaf)`` x the
    largest |value| of the matching leaf of ``want`` (the CPU's).  Every
    leaf's error is kept (``leaves``) and logged before any raises;
    returns them with the worst."""
    out, bad = {"leaves": {}, "worst": {"ratio": 0.0}}, []
    for (path, g), (_, w) in zip(leaves_with_paths(got), leaves_with_paths(want)):
        tol = tol_of(path, g)
        scale = float(w.float().abs().max())
        err = float((g.float().cpu() - w.float()).abs().max())
        ratio = err / (tol * scale) if scale else (0.0 if err == 0 else math.inf)
        leaf = out["leaves"][path] = {"max_abs_err": err, "largest": scale, "tol": tol, "ratio": ratio}
        if ratio >= out["worst"]["ratio"]:
            out["worst"] = {"path": path, **leaf}
        if g.shape != w.shape or ratio > 1:
            bad.append(path)
    for path, leaf in out["leaves"].items():
        log("train", f"  {what} {path}: max |diff| {leaf['max_abs_err']:.3e} of largest {leaf['largest']:.3e} "
            f"({leaf['ratio']:.3f} of the limit {leaf['tol']} x largest)")
    if bad:
        raise AssertionError(f"{what}: {bad} beyond their limits")
    return out


def f64_cpu(tree):
    """A tree of tensors copied to the host, float32 leaves as float64."""
    return tree_map(lambda t: t.to("cpu", torch.float64) if t.dtype == torch.float32 else t.to("cpu"), tree)


def backward_case(name: str, call: tuple, flush) -> dict:
    """One backward B6 launch at its real shape: the kernel flushed / warm
    / one call, the plain version, F.embedding_bag's backward for the same
    gradient, and the bounds by distinct and by gathered cotangent rows."""
    cot, idx_t, bags_t, n_rows, _ = call
    d, esize, n = cot.shape[1], cot.element_size(), idx_t.numel()
    t = timed(lambda: embedbag.embedding_bag_sorted(cot, idx_t, bags_t, n_rows), 10, 5, flush)
    t["plain_ms"] = events_ms(lambda: embedbag.embedding_bag_sorted_plain(cot, idx_t, bags_t, n_rows), 3, flush)
    # the forward lookups (rows bags_t into bags idx_t), sorted by bag
    fwd_bags, order = torch.sort(idx_t, stable=True)
    weight = torch.zeros((n_rows, d), dtype=cot.dtype, device=cot.device, requires_grad=True)
    offsets = embedbag.bag_offsets(fwd_bags, cot.shape[0])[:-1]
    out = F.embedding_bag(bags_t[order], weight, offsets, mode="sum")
    t["library_ms"] = events_ms(lambda: torch.autograd.grad(out, weight, cot, retain_graph=True), 5, flush)
    rows = int(torch.unique(idx_t).numel())
    side = 2 * n * 4 + n_rows * d * esize  # the index arrays and the dense gradient written
    t["bound_ms"], t["bound_by"] = bound(rows * d * esize + side, n * d, FP32_FLOPS)
    t["gathered_bound_ms"] = (n * d * esize + side) / HBM_BYTES_PER_S * 1e3
    t.update({"cotangent": list(cot.shape), "dtype": str(cot.dtype), "lookups": n, "table_rows": n_rows,
              "distinct_cotangent_rows": rows})
    log("train", f"{name} backward B6 launch: cotangent {tuple(cot.shape)} {cot.dtype}, {n} lookups into "
        f"{n_rows} table rows; {t['ms']:.4f} ms (L2 flushed; {t['warm_ms']:.4f} warm; {t['events_ms']:.4f} one "
        f"call), plain {t['plain_ms']:.4f} ms, F.embedding_bag backward {t['library_ms']:.4f} ms; bound "
        f"{t['bound_ms']:.4f} ms by {t['bound_by']} ({rows} distinct cotangent rows once and the dense "
        f"gradient), {t['gathered_bound_ms']:.4f} ms every gathered row")
    del weight, out
    return t


def b6_launch_ms(fn, want: int, what: str) -> list[float]:
    """The device ms of each of ``fn()``'s ``want`` B6 launches, in launch
    order, between CUDA events recorded around it.  A trace is no count:
    late in a full run the tracer has lost a GCN step's first 2 of 6 B6
    launches and half its sorts, and 1 of a DLRM step's 52 on every
    retry."""
    events, real = [], embedbag.embedding_bag_sorted

    def timed_launch(table, idx, bags, n_bags):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        out = real(table, idx, bags, n_bags)
        t1.record()
        events.append((t0, t1))
        return out

    with patched(embedbag, "embedding_bag_sorted", timed_launch):
        fn()
    torch.cuda.synchronize()
    if len(events) != want:
        raise AssertionError(f"{what}: {len(events)} B6 launches in a step, expected {want}")
    return [a.elapsed_time(b) for a, b in events]


def train_gcn(dev, gen, flush, rec, pending: list) -> tuple[int, dict]:
    """(a) gcn-cora at ogb_products trained whole through ``loop.run``
    (AdamW): its first step's loss and gradients against the CPU (the
    check appended to ``pending``: the CPU run goes on in a thread), each
    backward B6 launch against plain, TRAIN_GCN_STEPS steps with 4 + 2 B6
    launches a step, a crash at TRAIN_CRASH_AT and a bit-identical resume,
    one step traced.  Returns B6's launches on the main path and the
    graph for the mesh_train phase."""
    rules = shd.Rules.from_mesh(None)
    shape = registry.GNN_SHAPES["ogb_products"]
    cfg = gnn_common.gcn_for_shape(registry.get_arch("gcn-cora").full(), shape)
    spec = gnn_common.gnn_input_specs(cfg, shape, needs_feat=True)
    n, e, _ = gnn_common.shape_counts(shape)
    e_pad = spec["edge_src"].shape[0]
    src = torch.randint(0, n, (e_pad,), generator=gen, device=dev, dtype=torch.int32)
    dst = torch.randint(0, n, (e_pad,), generator=gen, device=dev, dtype=torch.int32)
    src[e:], dst[e:] = 0, 0
    train_mask = torch.zeros(spec["train_mask"].shape, dtype=torch.bool, device=dev)
    train_mask[torch.randperm(n, generator=gen, device=dev)[:OGB_TRAIN_NODES]] = True
    batch = {"node_feat": torch.randn(spec["node_feat"].shape, generator=gen, device=dev),
             "edge_src": src, "edge_dst": dst, "edge_mask": torch.arange(e_pad, device=dev) < e,
             "node_mask": torch.ones(n, dtype=torch.bool, device=dev),
             "labels": torch.randint(0, cfg.n_classes, spec["labels"].shape, generator=gen, device=dev,
                                     dtype=spec["labels"].dtype),
             "train_mask": train_mask}
    optimizer = opt_lib.get(cfg.optimizer)

    def init_fn():
        params = gnn.gcn_init(cfg, seed=SEED, device=dev)
        return params, optimizer.init(params)

    def loss(p, b=batch):
        return gnn.gcn_loss(cfg, rules, p, b)

    per_step = 2 + 2 * cfg.n_layers  # two degree scatters, an aggregation a layer forward and backward
    r = rec["gcn"] = {"nodes": n, "edges": e, "padded_edges": e_pad, "train_nodes": OGB_TRAIN_NODES,
                      "classes": cfg.n_classes, "optimizer": cfg.optimizer}

    # (i) the first step's loss and gradients against the port's CPU run in
    # float64 (each f32 input exact), whose own rounding over sums of 2.4 M
    # terms of either sign drops out, fed the card's ReLU decisions; the CPU
    # run goes on in a thread beside the rest of the phase, checked at its end
    params0, _ = init_fn()
    relus = ReluTape()
    with relus.record():
        value, grads, backward = grads_with_b6_calls(loss, params0, 2 + cfg.n_layers, cfg.n_layers, "train gcn")
    def reference(cpu_params, cpu_batch):
        with relus.replay():
            return value_and_grad(lambda p: loss(p, cpu_batch))(cpu_params)

    run = Background("train gcn CPU float64", functools.partial(reference, f64_cpu(params0), f64_cpu(batch)))
    value0, grads0 = float(value), tree_to(grads, "cpu")
    del value, grads

    def check() -> None:
        c_value, c_grads = run.result()
        r["cpu_s"], r["cpu_waited_s"], r["relu_audit"] = run.seconds, run.waited_s, relus.audit
        if abs(value0 - float(c_value)) > GRAD_TOL * abs(float(c_value)):
            raise AssertionError(f"train gcn: loss {value0} against the CPU's {float(c_value)}")
        r["grad_check"] = hold_tree(grads0, c_grads, lambda p, g: GRAD_TOL, "train gcn gradient")
        r["loss0"], r["cpu_loss0"] = value0, float(c_value)
        log("train", f"(a) gcn-cora at ogb_products: {n} nodes x {cfg.d_feat} f32, {e} uniform edges padded to "
            f"{e_pad} (masked), {cfg.n_classes} classes, {OGB_TRAIN_NODES} train nodes; first step: loss "
            f"{value0:.6f} (CPU float64 {float(c_value):.6f}, {r['cpu_s']:.1f} s in a thread beside the card's "
            f"work, {r['cpu_waited_s']:.1f} s waited for; fed the card's ReLU decisions: {r['relu_audit']}), every "
            f"gradient leaf within {GRAD_TOL} x its largest (worst {r['grad_check']['worst']}); the "
            f"{cfg.n_layers} backward B6 launches == plain on their real cotangents, zero on unread rows")

    pending.append(check)
    r["b6_backward"] = backward_case("gcn ogb_products", backward[0], flush)
    del backward, params0

    # (ii) the main path: TRAIN_GCN_STEPS steps through loop.run
    step = gnn.make_gnn_train_step(cfg, rules)
    timer = StepTimer(step)
    reset_launches()
    ref = loop.run(init_fn=init_fn, train_step=timer, batch_fn=lambda s: batch, n_steps=TRAIN_GCN_STEPS)
    launches = only_launched("embedding_bag_sorted", "train gcn")
    if launches != per_step * TRAIN_GCN_STEPS:
        raise AssertionError(f"train gcn: {launches} B6 launches in {TRAIN_GCN_STEPS} steps, expected {per_step} a step")
    if not all(math.isfinite(x) for x in ref.losses):
        raise AssertionError(f"train gcn: losses {ref.losses}")
    ms = timer.ms()
    r.update({"steps": TRAIN_GCN_STEPS, "launches": launches, "losses": ref.losses, "step_ms": ms,
              "median_ms": float(np.median(ms[1:])), "nodes_per_s": n / float(np.median(ms[1:])) * 1e3})
    log("train", f"(a) {TRAIN_GCN_STEPS} steps through training.loop.run: {launches} B6 launches = {per_step} a "
        f"step (4 forward, 2 backward), no other kernel; losses {[round(x, 5) for x in ref.losses]}; "
        f"{r['median_ms']:.4f} ms a step after the first (CUDA events; first {ms[0]:.2f}) = "
        f"{r['nodes_per_s']:.4g} nodes/s")

    # (iii) a crash at step TRAIN_CRASH_AT, then a resume from the last checkpoint
    with tempfile.TemporaryDirectory(prefix="repro-train-") as ck:
        kw = dict(init_fn=init_fn, train_step=step, batch_fn=lambda s: batch, n_steps=TRAIN_GCN_STEPS,
                  ckpt_dir=ck, ckpt_every=TRAIN_CKPT_EVERY)
        try:
            loop.run(**kw, crash_at_step=TRAIN_CRASH_AT)
        except RuntimeError as err:
            if "simulated node failure" not in str(err):
                raise
        else:
            raise AssertionError("train gcn: the run did not crash")
        resumed = loop.run(**kw)
    if resumed.start_step != TRAIN_CRASH_AT // TRAIN_CKPT_EVERY * TRAIN_CKPT_EVERY:
        raise AssertionError(f"train gcn: resumed from step {resumed.start_step}")
    for (path, a), (_, b) in zip(leaves_with_paths((ref.params, ref.opt_state)),
                                 leaves_with_paths((resumed.params, resumed.opt_state))):
        if not torch.equal(a, b):
            raise AssertionError(f"train gcn: the resumed run's {path} differs from the uninterrupted run's")
    if resumed.losses != ref.losses[resumed.start_step:]:
        raise AssertionError(f"train gcn: resumed losses {resumed.losses} against {ref.losses}")
    r["resume"] = {"ckpt_every": TRAIN_CKPT_EVERY, "crash_at": TRAIN_CRASH_AT, "start_step": resumed.start_step}
    log("train", f"(a) crashed at step {TRAIN_CRASH_AT} (checkpoints every {TRAIN_CKPT_EVERY}), resumed from "
        f"step {resumed.start_step}: final parameters and AdamW state == the uninterrupted run's, bit for bit; "
        "losses equal")

    # (iv) one step traced: B6 forward and backward apart, the sorts
    params, state = ref.params, ref.opt_state
    tr = device_trace(lambda: step(params, state, batch))
    b6 = kernel_share(tr, ("embedding_bag_kernel",))
    sorts = kernel_share(tr, ("sort", "Sort", "radix", "Radix"))
    b6_each = b6_launch_ms(lambda: step(params, state, batch), per_step, "train gcn")
    fwd_ms, bwd_ms = sum(b6_each[:2 + cfg.n_layers]), sum(b6_each[2 + cfg.n_layers:])
    r["trace"] = {**tr, "b6": b6, "sorts": sorts, "b6_each_ms": b6_each, "b6_forward_ms": fwd_ms,
                  "b6_backward_ms": bwd_ms}
    log_trace("train", "gcn ogb_products train step", tr, b6, "B6")
    log("train", f"(a) B6 between events: forward {fwd_ms:.3f} ms ({2 + cfg.n_layers} launches), backward "
        f"{bwd_ms:.3f} ms ({cfg.n_layers}) = {(fwd_ms + bwd_ms) / r['median_ms']:.4f} of the median step; "
        f"traced sorts {sorts['ms']:.3f} ms in {sorts['count']} launches = {sorts['share']:.4f} of traced "
        f"device time; the trace holds {b6['count']} of {per_step} B6 launches")
    del ref, resumed, params, state, src, dst, train_mask, tr
    free()
    return launches, {"cfg": cfg, "batch": batch}


def train_dlrm(dev, gen, flush, rec, pending: list) -> int:
    """(b) dlrm-mlperf with every table capped at TRAIN_TABLE_CAP rows at
    train_batch: the loss and gradients of a TRAIN_DLRM_CHECK_BATCH batch
    against the CPU (the check goes to ``pending``, its run in a thread),
    one train_batch step's 26 backward B6 launches
    against plain, TRAIN_DLRM_STEPS steps with 52 B6 launches a step,
    AdamW on sampled rows against a CPU update, one step traced.
    Returns B6's launches on the main path."""
    rules = shd.Rules.from_mesh(None)
    cfg = dataclasses.replace(DLRM, table_sizes=tuple(min(s, TRAIN_TABLE_CAP) for s in DLRM.table_sizes))
    batch_size = registry.RECSYS_SHAPES["train_batch"].dims["batch"]
    capped = sum(s > TRAIN_TABLE_CAP for s in DLRM.table_sizes)
    r = rec["dlrm"] = {"table_cap": TRAIN_TABLE_CAP, "tables_capped": capped, "batch": batch_size,
                       "full_state_bytes": sum(DLRM.padded_table_sizes) * DLRM.embed_dim * 12}
    t0 = time.perf_counter()
    params = dlrm.init_params(cfg, seed=SEED, device=dev)
    optimizer = opt_lib.get(cfg.optimizer)
    state = optimizer.init(params)
    torch.cuda.synchronize()
    r.update({"init_s": time.perf_counter() - t0, "table_bytes": tree_bytes(params["tables"]),
              "state_bytes": tree_bytes(state)})
    log("train", f"(b) dlrm-mlperf, tables capped at {TRAIN_TABLE_CAP} rows ({capped} of 26 cut; the full "
        f"set's bf16 tables, gradients and f32 moments would be {r['full_state_bytes'] / 1e9:.1f} GB): "
        f"{sum(cfg.padded_table_sizes)} rows x {cfg.embed_dim} bf16 = {r['table_bytes'] / 1e9:.2f} GB, AdamW "
        f"state {r['state_bytes'] / 1e9:.2f} GB, initialised in {r['init_s']:.1f} s")

    def batch_at(step: int, size: int = batch_size) -> dict:
        return pipeline.dlrm_batch(cfg.table_sizes, cfg.n_dense, cfg.multi_hot, size, step, seed=SEED, device=dev)

    def loss(p, b):
        return dlrm.loss_fn(cfg, rules, p, b)

    def tol_of(path, g):
        return BF16_TOL if g.dtype == torch.bfloat16 else GRAD_TOL

    # (i) a small batch's loss and gradients against the port's CPU run, fed
    # the card's ReLU decisions; the CPU run goes on in a thread, checked by
    # the caller
    small = batch_at(10_000, TRAIN_DLRM_CHECK_BATCH)
    relus = ReluTape()
    with relus.record():
        value, grads = value_and_grad(lambda p: loss(p, small))(params)

    def reference(cpu_params, cpu_small):
        with relus.replay():
            return value_and_grad(lambda p: loss(p, cpu_small))(cpu_params)

    run = Background("train dlrm CPU run", functools.partial(reference, tree_to(params, "cpu"),
                                                              tree_to(small, "cpu")))
    value0, grads0 = float(value), tree_to(grads, "cpu")
    del value, grads

    def check() -> None:
        c_value, c_grads = run.result()
        r["cpu_s"], r["cpu_waited_s"], r["relu_audit"] = run.seconds, run.waited_s, relus.audit
        if abs(value0 - float(c_value)) > GRAD_TOL * abs(float(c_value)):
            raise AssertionError(f"train dlrm: loss {value0} against the CPU's {float(c_value)}")
        r["grad_check"] = hold_tree(grads0, c_grads, tol_of, "train dlrm gradient")
        log("train", f"(b) {TRAIN_DLRM_CHECK_BATCH}-sample batch: loss {value0:.6f} (CPU {float(c_value):.6f}, "
            f"{r['cpu_s']:.1f} s in a thread, {r['cpu_waited_s']:.1f} s waited for, fed the card's ReLU decisions: "
            f"{r['relu_audit']}); MLP gradients within {GRAD_TOL}, bf16 table gradients within {BF16_TOL} x their "
            f"largest (worst {r['grad_check']['worst']})")

    pending.append(check)

    # (ii) one train_batch step's backward launches against plain
    _, grads, backward = grads_with_b6_calls(lambda p: loss(p, batch_at(0)), params, cfg.n_sparse, cfg.n_sparse,
                                             "train dlrm")
    log("train", f"(b) train_batch ({batch_size}): each of the {len(backward)} backward B6 launches == plain "
        "on its real cotangent, every unread row exactly zero")
    big = max(range(len(backward)), key=lambda i: backward[i][3])
    r["b6_backward"] = backward_case(f"dlrm table of {backward[big][3]} rows", backward[big], flush)
    del grads, backward

    # (iii) the main path: TRAIN_DLRM_STEPS steps
    step = StepTimer(dlrm.make_train_step(cfg, rules))
    batches = [batch_at(1 + i) for i in range(TRAIN_DLRM_STEPS)]
    reset_launches()
    losses = []
    for b in batches:
        params, state, value = step(params, state, b)
        losses.append(float(value))
    launches = only_launched("embedding_bag_sorted", "train dlrm")
    if launches != 2 * cfg.n_sparse * TRAIN_DLRM_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"train dlrm: {launches} B6 launches in {TRAIN_DLRM_STEPS} steps, losses {losses}")
    ms = step.ms()
    r.update({"steps": TRAIN_DLRM_STEPS, "launches": launches, "losses": losses, "step_ms": ms,
              "median_ms": float(np.median(ms)), "samples_per_s": batch_size / float(np.median(ms)) * 1e3})
    log("train", f"(b) {TRAIN_DLRM_STEPS} steps at train_batch: {launches} B6 launches = 52 a step (26 forward, "
        f"26 backward), no other kernel; losses {[round(x, 5) for x in losses]}; {ms} ms a step (CUDA events) "
        f"= {r['samples_per_s']:.1f} samples/s at the median")

    # (iv) one more step taken apart: AdamW timed alone, sampled rows against a CPU AdamW
    b = batch_at(1 + TRAIN_DLRM_STEPS)
    _, grads = value_and_grad(lambda p: loss(p, b))(params)
    picks = {f"t{i}": torch.randint(0, n, (TRAIN_SAMPLED_ROWS,), generator=gen, device=dev)
             for i, n in enumerate(cfg.padded_table_sizes)}

    def sample(tree):
        return {"bot": tree_to(tree["bot"], "cpu"), "top": tree_to(tree["top"], "cpu"),
                "tables": {k: tree["tables"][k][picks[k]].cpu() for k in picks}}

    before = (sample(params), sample(grads), {"m": sample(state["m"]), "v": sample(state["v"]),
                                              "step": state["step"].cpu()})
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    params, state = optimizer.update(params, grads, state)
    t1.record()
    torch.cuda.synchronize()
    r["optimizer_ms"] = t0.elapsed_time(t1)
    c_params, c_state = opt_lib.adamw().update(*before)
    worst = 0
    for (path, g), (_, w) in zip(leaves_with_paths((sample(params), sample(state["m"]), sample(state["v"]))),
                                 leaves_with_paths((c_params, c_state["m"], c_state["v"]))):
        if g.dtype == torch.bfloat16:
            ulps = int((g.view(torch.int16).int() - w.view(torch.int16).int()).abs().max())
            worst = max(worst, ulps)
            if ulps > 1:
                raise AssertionError(f"train dlrm AdamW {path}: {ulps} bf16 ulps from the CPU update")
        elif float((g - w).abs().max()) > 1e-6 * float(w.abs().max()):
            raise AssertionError(f"train dlrm AdamW {path}: beyond 1e-6 of the CPU update")
    r["adamw_check"] = {"rows_per_table": TRAIN_SAMPLED_ROWS, "max_bf16_ulps": worst}
    log("train", f"(b) AdamW alone {r['optimizer_ms']:.3f} ms (CUDA events) = "
        f"{r['optimizer_ms'] / r['median_ms']:.4f} of the median step; {TRAIN_SAMPLED_ROWS} sampled rows of each "
        f"table and every MLP leaf against a CPU adamw on the same rows: f32 within 1e-6, bf16 at most "
        f"{worst} ulp apart")
    del grads, before, c_params, c_state

    # (v) one step traced
    b = batch_at(2 + TRAIN_DLRM_STEPS)
    tr = device_trace(lambda: step.step(params, state, b))
    b6 = kernel_share(tr, ("embedding_bag_kernel",))
    gemm = kernel_share(tr, ("gemm", "Gemm", "cutlass", "sm90_xmma", "sgemm", "nvjet"))
    b6_each = b6_launch_ms(lambda: step.step(params, state, b), 2 * cfg.n_sparse, "train dlrm")
    r["trace"] = {**tr, "b6": b6, "gemm": gemm, "b6_each_ms": b6_each}
    log_trace("train", "dlrm train_batch step", tr, b6, "B6")
    log("train", f"(b) B6 between events: forward {sum(b6_each[:cfg.n_sparse]):.3f} ms, backward "
        f"{sum(b6_each[cfg.n_sparse:]):.3f} ms = {sum(b6_each) / r['median_ms']:.4f} of the median step; traced "
        f"GEMMs {gemm['ms']:.3f} ms = {gemm['share']:.4f} of traced device time")
    del params, state, batches, b, tr
    free()
    return launches


def train_lm(dev, gen, rec, pending: list) -> None:
    """(c) qwen3-14b at full width, TRAIN_LM_LAYERS layers, train_4k cut to
    TRAIN_LM_SEQS sequences (the config's microbatches of one): the loss
    and the lm_head, embed and layer-0 gradients of 1 x TRAIN_LM_CHECK
    tokens against the CPU, TRAIN_LM_STEPS AdamW steps launching no kernel
    of the repo (no B7: training attends with chunked_attention), the
    attention and the optimizer timed apart, one step traced.  The CPU
    check goes to ``pending`` (its run in a thread meanwhile)."""
    rules = shd.Rules.from_mesh(None)
    cfg = dataclasses.replace(QWEN, n_layers=TRAIN_LM_LAYERS)
    seq = registry.LM_SHAPES["train_4k"].dims["seq"]
    r = rec["lm"] = {"cut": {"n_layers": [QWEN.n_layers, TRAIN_LM_LAYERS],
                             "batch": [registry.LM_SHAPES["train_4k"].dims["batch"], TRAIN_LM_SEQS]},
                     "seq": seq, "microbatches": cfg.microbatches}
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, seed=SEED, device=dev)
    optimizer = opt_lib.get(cfg.optimizer)
    state = optimizer.init(params)
    torch.cuda.synchronize()
    r.update({"init_s": time.perf_counter() - t0, "weight_bytes": tree_bytes(params),
              "state_bytes": tree_bytes(state)})

    def batch_at(step: int, n: int = TRAIN_LM_SEQS, s: int = seq) -> dict:
        return pipeline.lm_batch(cfg.vocab, n, s, step=step, seed=SEED, device=dev)

    # (i) 1 x TRAIN_LM_CHECK tokens against the port's CPU run
    small = batch_at(100, 1, TRAIN_LM_CHECK)

    def loss(p, b):
        return transformer.loss_fn(cfg, rules, p, b["tokens"], b["labels"])

    value, grads = value_and_grad(lambda p: loss(p, small))(params)
    def reference(cpu_params, cpu_small):
        return value_and_grad(lambda p: loss(p, cpu_small))(cpu_params)

    run = Background("train lm CPU run", functools.partial(reference, tree_to(params, "cpu"), tree_to(small, "cpu")))

    def checked(g):
        return {"lm_head": g["lm_head"], "embed": g["embed"], "layer0": transformer._layer(g["layers"], 0)}

    card, value0 = tree_to(checked(grads), "cpu"), float(value)

    def check() -> None:
        c_value, c_grads = run.result()
        r["cpu_s"], r["cpu_waited_s"] = run.seconds, run.waited_s
        if not math.isfinite(value0) or abs(value0 - float(c_value)) > BF16_TOL * abs(float(c_value)):
            raise AssertionError(f"train lm: loss {value0} against the CPU's {float(c_value)}")
        r["grad_check"] = hold_tree(card, checked(c_grads), lambda p, g: BF16_TOL, "train lm gradient")
        log("train", f"(c) qwen3-14b at full width (d_model {cfg.d_model}, {cfg.n_q_heads}/{cfg.n_kv_heads} heads, "
            f"d_head {cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab} padded to {cfg.padded_vocab}), {cfg.n_layers} "
            f"layers: {r['weight_bytes'] / 1e9:.2f} GB of bf16 weights, AdamW state {r['state_bytes'] / 1e9:.2f} GB; "
            f"1 x {TRAIN_LM_CHECK} tokens: loss {value0:.5f} (CPU {float(c_value):.5f}, {r['cpu_s']:.1f} s in a "
            f"thread, {r['cpu_waited_s']:.1f} s waited for), lm_head, embed and layer-0 gradients within {BF16_TOL} "
            f"x their largest (worst {r['grad_check']['worst']})")

    pending.append(check)

    # (ii) the main path: TRAIN_LM_STEPS steps of TRAIN_LM_SEQS x seq tokens
    step = StepTimer(transformer.make_train_step(cfg, rules))
    batches = [batch_at(i) for i in range(TRAIN_LM_STEPS)]
    reset_launches()
    losses = []
    for b in batches:
        params, state, value = step(params, state, b)
        losses.append(float(value))
    counts = launch_counts()
    if any(counts.values()) or not all(map(math.isfinite, losses)):
        raise AssertionError(f"train lm: launches {counts}, losses {losses}")
    ms = step.ms()
    tokens = TRAIN_LM_SEQS * seq
    # each weight's products, forward and backward (the remat recompute, the
    # loss's recomputed chunks and the attention's scores not counted)
    flops = 6 * tokens * (sum(t.numel() for t in leaves(params["layers"])) + params["lm_head"].numel())
    r.update({"steps": TRAIN_LM_STEPS, "losses": losses, "step_ms": ms, "median_ms": float(np.median(ms)),
              "tokens_per_s": tokens / float(np.median(ms)) * 1e3, "weight_flops": flops})
    log("train", f"(c) {TRAIN_LM_STEPS} steps of {TRAIN_LM_SEQS} x {seq} tokens ({cfg.microbatches} microbatches, "
        f"remat {cfg.remat}): no kernel of the repo launched (B7 0); losses {[round(x, 5) for x in losses]}; "
        f"{ms} ms a step (CUDA events) = {r['tokens_per_s']:.1f} tokens/s at the median; "
        f"{flops / 1e12:.1f} TFLOP of weight products a step")

    # (iii) the attention (forward, its remat recompute, backward) and AdamW timed apart
    q = torch.randn((1, seq, cfg.n_q_heads, cfg.d_head), generator=gen, device=dev).to(cfg.dtype)
    k = torch.randn((1, seq, cfg.n_kv_heads, cfg.d_head), generator=gen, device=dev).to(cfg.dtype)
    v = torch.randn((1, seq, cfg.n_kv_heads, cfg.d_head), generator=gen, device=dev).to(cfg.dtype)
    q.requires_grad_(), k.requires_grad_(), v.requires_grad_()

    def attention():
        out = lm_layers.chunked_attention(q, k, v, causal=True, q_chunk=min(cfg.q_chunk, seq),
                                          kv_chunk=min(cfg.kv_chunk, seq))
        torch.autograd.grad(out, (q, k, v), torch.ones_like(out))

    def attention_fwd():
        with torch.no_grad():
            lm_layers.chunked_attention(q, k, v, causal=True, q_chunk=min(cfg.q_chunk, seq),
                                        kv_chunk=min(cfg.kv_chunk, seq))

    no_flush = torch.empty(1, device=dev)  # as inside the step: its operands are not flushed from L2
    attn_ms = events_ms(attention, 2, no_flush) + events_ms(attention_fwd, 2, no_flush)
    g32 = tree_map(lambda g: g.float(), grads)
    del grads
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    params, state = optimizer.update(params, g32, state)
    t1.record()
    torch.cuda.synchronize()
    r["optimizer_ms"] = t0.elapsed_time(t1)
    per_step = attn_ms * cfg.n_layers * cfg.microbatches
    r["attention"] = {"one_layer_sequence_ms": attn_ms, "per_step_ms": per_step,
                      "share": per_step / r["median_ms"]}
    log("train", f"(c) chunked_attention at 1 x {seq}, one layer: forward + backward with its remat recompute "
        f"{attn_ms:.3f} ms (events) x {cfg.n_layers} layers x {cfg.microbatches} microbatches = {per_step:.1f} ms "
        f"= {r['attention']['share']:.4f} of the median step; AdamW alone {r['optimizer_ms']:.3f} ms = "
        f"{r['optimizer_ms'] / r['median_ms']:.4f}")
    del g32, q, k, v

    # (iv) one step traced
    b = batches[0]
    tr = device_trace(lambda: step.step(params, state, b))
    gemm = kernel_share(tr, ("gemm", "Gemm", "cutlass", "sm90_xmma", "nvjet", "xmma"))
    r["trace"] = {"traced_ms": tr["traced_ms"], "device_busy_ms": tr["device_busy_ms"], "gemm": gemm,
                  "top": dict(list(tr["kernels"].items())[:12])}
    log_trace("train", "qwen3-14b train_4k step", tr, gemm, "GEMMs")
    del params, state, batches, b, tr
    free()


def phase_train(dev, gen, flush, record) -> tuple[int, dict, list]:
    """Training on the card: (a) GCN at ogb_products whole through
    ``training.loop.run``, the slice's main path; (b) DLRM at train_batch
    with capped tables; (c) qwen3-14b at train_4k, full width.  (a)'s,
    (b)'s and (c)'s CPU references run in threads beside the card's work.  Returns
    B6's launches on the main paths (forward and backward), (a)'s graph
    for the mesh_train phase, and the checks that hold (a) and (c) to
    their references, for the caller to call."""
    rec = record["train"] = {"data": "drawn from the seed: no dataset is in the repo"}
    pending: list = []
    launches, handoff = train_gcn(dev, gen, flush, rec, pending)
    launches += train_dlrm(dev, gen, flush, rec, pending)
    train_lm(dev, gen, rec, pending)
    return launches, handoff, pending


# ---------------------------------------------------------------------------
# mesh_train: training over ranks
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def recorded_gradients(box: list):
    """``opt_lib.get`` patched (this thread): each optimizer made inside
    the block appends the gradient leaves its update is handed to
    ``box`` (on a rank, its reduced blocks)."""
    real = opt_lib.get

    def get(name, lr=3e-4):
        inner = real(name, lr)

        def update(params, grads, state, **kw):
            box.append([g.detach().clone() for g in leaves(grads)])
            return inner.update(params, grads, state, **kw)

        return opt_lib.Optimizer(inner.init, update, inner.state_spec)

    with patched(opt_lib, "get", get):
        yield box


@contextlib.contextmanager
def counted_drops(counts: dict):
    """``layers._dispatch`` patched (this thread): the assignments past
    each capacity that the expert-parallel layer drops, and the slotted
    ones, summed into ``counts``."""
    real = lm_layers._dispatch

    def dispatch(dest, n_dest, cap):
        order, dest_s, rank = real(dest, n_dest, cap)
        real_dest = dest_s < n_dest
        counts["slotted"] = counts.get("slotted", 0) + int(real_dest.sum())
        counts["dropped"] = counts.get("dropped", 0) + int((real_dest & (rank >= cap)).sum())
        return order, dest_s, rank

    with patched(lm_layers, "_dispatch", dispatch):
        yield counts


def leaf_error(got: torch.Tensor, want: torch.Tensor, floor: float) -> float:
    """max |got - want| over the larger of ``want``'s largest |value| and
    ``floor``."""
    diff = (got.float() - want.float()).abs()
    return float(diff.max()) / max(float(want.float().abs().max()), floor, 1e-30) if diff.numel() else 0.0


def grad_floor(tensors) -> float:
    """GRAD_FLOOR of the largest |value| over a model's leaves: a leaf whose
    gradient cancels to rounding noise has no scale of its own."""
    return GRAD_FLOOR * max(float(t.float().abs().max()) for t in tensors)


def mesh_train_lm_cfg():
    """granite at full width, MESH_TRAIN_LM_LAYERS layers, in f32: in bf16
    the expert-parallel step and one card round apart by 1.6% of a leaf's
    largest at (1, 1) and 2.4% between (2, 2) and one rank (on the card),
    a step's own rounding, which would leave a wrong reduction unseen
    below BF16_TOL."""
    return dataclasses.replace(GRANITE, n_layers=MESH_TRAIN_LM_LAYERS, dtype=torch.float32)


def mesh_train_lm_batch(cfg, dev) -> dict:
    return pipeline.lm_batch(cfg.vocab, MESH_TRAIN_LM_SEQS, MESH_TRAIN_LM_SEQ, step=30_000, seed=SEED, device=dev)


def lm_reference(dev) -> dict:
    """(a)'s granite on one card: one AdamW step of ``make_train_step``,
    the gradient recorded (host tensors) and the experts each MoE call
    chose (``RouteTape``: a near tie of the router that the two programs'
    rounding resolves apart moves a token by a whole expert term)."""
    cfg = mesh_train_lm_cfg()
    none = shd.Rules.from_mesh(None)
    params = transformer.init_params(cfg, seed=SEED, device=dev)
    state = opt_lib.get(cfg.optimizer).init(params)
    box, tape = [], RouteTape()
    with recorded_gradients(box), tape.record():
        params, state, loss = transformer.make_train_step(cfg, none)(params, state, mesh_train_lm_batch(cfg, dev))
    ref = {"loss": float(loss), "grads": [g.cpu() for g in box[0]], "tape": tape}
    del params, state, box
    free()
    return ref


def lm_rank_step(cfg, mesh, dev, counts: dict, tape: RouteTape):
    """One granite step on the one-rank ``mesh`` at MESH_TRAIN_NO_DROP, fed
    the experts ``tape`` recorded on one card (audited: a token may take
    other experts only at a near tie): (loss, the rank's reduced gradient
    leaves)."""
    rules = transformer.rules_for(cfg, mesh)
    with shd.use_mesh(mesh):
        params = transformer.shard_params(cfg, rules, transformer.init_params(cfg, seed=SEED, device=dev))
        state = transformer.optimizer_for(cfg, rules, params).init(params)
        box = []
        moe = functools.partial(lm_layers.apply_moe, capacity_factor=MESH_TRAIN_NO_DROP)
        with recorded_gradients(box), counted_drops(counts), patched(lm_layers, "apply_moe", moe), tape.replay(1):
            params, state, loss = transformer.make_train_step(cfg, rules)(params, state, mesh_train_lm_batch(cfg, dev))
    return float(loss), box[0]


def hold_lm_grads(got: list, want: list, what: str) -> tuple[float, int]:
    """Each of one rank's gradient leaves (whole: every axis one rank)
    within GRAD_TOL (f32; bf16 BF16_TOL) of ``want``'s (over the larger of
    its largest and GRAD_FLOOR of the model's); returns the worst ratio to
    the limit and its leaf."""
    floor, worst = grad_floor(want), (0.0, None)
    for i, (g, w) in enumerate(zip(got, want)):
        tol = BF16_TOL if g.dtype == torch.bfloat16 else GRAD_TOL
        err = leaf_error(g.cpu(), w, floor)
        worst = max(worst, (err / tol, i), key=lambda t: t[0])
        if g.shape != w.shape or not torch.isfinite(g).all() or err > tol:
            raise AssertionError(f"{what}: gradient leaf {i} {tuple(g.shape)} off the reference by {err} "
                                 f"(limit {tol})")
    return worst


def big_grads(cfg, params: dict, rules, graph: dict, what: str) -> tuple[float, list, int, float]:
    """``equiformer_energy_big``'s energy and gradient on the installed
    mesh: (energy, the gradient leaves, B6 launches forward, recompute
    and backward, wall s)."""
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    energy, grads = value_and_grad(lambda p: gnn.equiformer_energy_big(cfg, rules, p, graph)[0])(params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = only_launched("embedding_bag_sorted", what)
    grads = leaves(grads)
    if not math.isfinite(float(energy)) or not all(bool(torch.isfinite(g).all()) for g in grads):
        raise AssertionError(f"{what}: energy {float(energy)} or a gradient leaf not finite")
    return float(energy), grads, n, wall


def hold_grads(got: list, want: list, tol: float, what: str) -> float:
    """Every leaf within ``tol`` of its largest (or GRAD_FLOOR of the
    model's); returns the worst error over its scale."""
    floor, worst = grad_floor(want), 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        err = leaf_error(g, w, floor)
        worst = max(worst, err)
        if g.shape != w.shape or err > tol:
            raise AssertionError(f"{what}: gradient leaf {i} off by {err} of its scale (limit {tol})")
    return worst


def mesh_train_one_rank(dev, tmp: str, handoff: dict, rec: dict) -> int:
    """(a) and (c) on one NCCL rank in this process, a (1, 1) mesh: GCN
    at ogb_products (the train phase's graph) one AdamW step with ZeRO,
    every parameter and moment ``torch.equal`` to the one-card step's;
    granite at full width with MESH_TRAIN_LM_LAYERS layers in f32, expert-
    parallel at MESH_TRAIN_NO_DROP, 0 drops, its gradient within GRAD_TOL
    of the one-card step's; (c) ``equiformer_energy_big``'s gradient on
    the 4-chunk graph against ``equiformer_atoms_big_plain``'s.  Returns
    B6's launches."""
    none = shd.Rules.from_mesh(None)
    cfg, batch = handoff["cfg"], handoff["batch"]
    out = {}
    # the one-card runs first
    p1 = gnn.gcn_init(cfg, seed=SEED, device=dev)
    s1 = opt_lib.get(cfg.optimizer).init(p1)
    reset_launches()
    p1, s1, l1 = gnn.make_gnn_train_step(cfg, none)(p1, s1, batch)
    launches = only_launched("embedding_bag_sorted", "mesh_train (a) gcn one card")
    lm_ref = lm_reference(dev)
    lcfg = mesh_train_lm_cfg()
    ecfg = registry.get_arch("equiformer-v2").full()
    eparams = gnn.equiformer_init(ecfg, seed=SEED, device=dev)
    multi = equiformer_graph(ecfg, EQ_SMALL_NODES, EQ_MULTI_EDGES, SEED + 19, dev)
    t0 = time.perf_counter()
    _, plain = value_and_grad(lambda p: gnn.equiformer_atoms_big_plain(ecfg, p, multi).sum())(eparams)
    plain = leaves(plain)
    plain_s = time.perf_counter() - t0
    ranks.init_rank(0, 1, os.path.join(tmp, "store_a"), device=dev, timeout_s=MESH_TIMEOUT_S)
    try:
        mesh = mesh_lib.make_test_mesh(1, 1)
        rules = shd.Rules.from_mesh(mesh)
        with shd.use_mesh(mesh):
            p2 = gnn.gcn_init(cfg, seed=SEED, device=dev)
            opt = gnn.optimizer_for(cfg, rules, p2)
            s2 = opt.init(p2)
            reset_launches()
            p2, s2, l2 = gnn.make_gnn_train_step(cfg, rules)(p2, s2, batch)
            n = only_launched("embedding_bag_sorted", "mesh_train (a) gcn one rank")
        pairs = list(zip(leaves((l2, p2, s2["m"], s2["v"])), leaves((l1, p1, s1["m"], s1["v"]))))
        if n != 2 + 2 * cfg.n_layers or not all(torch.equal(a, b) for a, b in pairs):
            raise AssertionError(f"mesh_train (a) gcn: {n} B6 launches, or the one-rank step's loss, parameters "
                                 "or moments differ from the one-card step's")
        launches += n
        out["gcn"] = {"launches": n, "leaves": len(pairs), "zero_dims": opt.zero_dims, "loss": float(l2)}
        log("mesh_train", f"(a) gcn ogb_products, one AdamW step with ZeRO-1 on one NCCL rank (1, 1): loss, "
            f"{len(pairs) - 1} parameter and moment leaves torch.equal to the one-card step's; {n} B6 launches")
        del p1, s1, p2, s2
        drops: dict = {}
        tape = lm_ref.pop("tape")
        loss, grads = lm_rank_step(lcfg, mesh, dev, drops, tape)
        worst = hold_lm_grads(grads, lm_ref["grads"], "mesh_train (a) granite")
        if drops.get("dropped", 0) or abs(loss - lm_ref["loss"]) > GRAD_TOL * abs(lm_ref["loss"]):
            raise AssertionError(f"mesh_train (a) granite: {drops} drops, loss {loss} against {lm_ref['loss']}")
        out["granite"] = {"loss": loss, "one_card_loss": lm_ref["loss"], "drops": drops, "worst_of_limit": worst,
                          "route_audit": tape.audit}
        del tape
        log("mesh_train", f"(a) granite-moe-1b-a400m full width, {lcfg.n_layers} layers, {MESH_TRAIN_LM_SEQS} x "
            f"{MESH_TRAIN_LM_SEQ} tokens, expert-parallel at capacity {MESH_TRAIN_NO_DROP} on one NCCL rank: "
            f"{drops.get('dropped', 0)} of {drops.get('slotted', 0)} slots dropped; loss {loss:.5f} (one card "
            f"{lm_ref['loss']:.5f}); fed the one-card run's experts ({out['granite']['route_audit']}); every "
            f"gradient leaf within {worst[0]:.3f} of the limit {GRAD_TOL} (f32; leaf {worst[1]})")
        del grads
        free()
        with shd.use_mesh(mesh):
            energy, got, n, wall = big_grads(ecfg, eparams, rules, multi, "mesh_train (c)")
            worst = hold_grads(got, plain, EQ_GRAD_TOL, "mesh_train (c) equiformer_energy_big")
            launches += n
            chunks = multi["edge_src"].shape[0] // gnn._BIG_CHUNK
            out["c"] = {"nodes": EQ_SMALL_NODES, "edges": EQ_MULTI_EDGES, "chunks": chunks, "energy": energy,
                        "b6_launches": n, "wall_s": wall, "plain_s": plain_s, "worst": worst, "limit": EQ_GRAD_TOL,
                        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
            log("mesh_train", f"(c) equiformer_energy_big's gradient on one NCCL rank: {EQ_SMALL_NODES} nodes, "
                f"{EQ_MULTI_EDGES} edges in {chunks} chunks, every layer and chunk recomputed in the backward: "
                f"every leaf within {worst:.3e} of the plain twin's (limit {EQ_GRAD_TOL} of its largest, or "
                f"{GRAD_FLOOR} of the model's); {n} B6 launches, {wall:.1f} s (plain twin {plain_s:.1f} s)")
            del got, plain
    finally:
        dist.destroy_process_group()
    rec.update(out)
    del eparams, multi
    free()
    return launches


def phase_mesh_train(dev, handoff: dict, record) -> int:
    """Training over ranks on the card: (a) and (c) on one NCCL rank in
    this process (:func:`mesh_train_one_rank`), each held to the one-card
    run.  Returns B6's launches."""
    rec = record["mesh_train"] = {}
    tmp = tempfile.mkdtemp(prefix="chip-smoke-mesh-train-")
    t0 = time.perf_counter()
    try:
        launches = mesh_train_one_rank(dev, tmp, handoff, rec)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["one_rank_s"] = time.perf_counter() - t0
    log("mesh_train", f"(a) and (c) on one NCCL rank: {rec['one_rank_s']:.1f} s; {launches} B6 launches in the phase")
    return launches


def dryrun_sweep(rec: dict) -> None:
    """(a) The dry run over every cell of ``all_cells()`` but the left-out
    ones, at the (16, 16) and (2, 16, 16) layouts (``DRYRUN_MULTI_ONLY_CELLS``
    at the second only), on the meta device: the program rank 0 runs
    there, counted under a fake process group of the layout's ranks (no
    even split: the CLI reports it), one line a cell.  Any error raises."""
    t0 = time.perf_counter()
    todo = [(a, s) for a, s in dryrun.all_cells()
            if not (registry.get_arch(a).family == "lm" and s in DRYRUN_LEFT_OUT_SHAPES)]
    left_out = [f"{a} x {s}" for a, s in dryrun.all_cells() if (a, s) not in todo]
    out = rec["sweep"] = {"cells": {}, "left_out": left_out,
                          "multi_only": [f"{a} x {s}" for a, s in DRYRUN_MULTI_ONLY_CELLS]}
    for multi in (False, True):
        with mesh_lib.fake_mesh(mesh_lib.make_production_mesh(multi_pod=multi)) as fm:
            for arch, shape in todo:
                if not multi and (arch, shape) in DRYRUN_MULTI_ONLY_CELLS:
                    continue
                key = f"{arch}|{shape}|{'multi' if multi else 'single'}"
                st = dryrun.run_cell(arch, shape, multi, {}, verbose=False, mesh=fm, even_split=False)
                r, coll, c = st["roofline"], st["collectives"], st["cost"]
                out["cells"][key] = {"argument_bytes": st["memory"]["argument_bytes"],
                                     "rank_argument_bytes": c["rank_argument_bytes"],
                                     "peak_bytes": st["memory"]["program_peak_bytes"], "flops": c["flops"],
                                     "bytes": c["bytes"], "collectives": coll, "roofline": r,
                                     "count_s": st["times"]["count_s"]}
                coll_txt = "no collective" if coll is None else (
                    f"{coll['n_ops']} collectives, {coll['bytes'] / 2**20:.3f} MiB logical, "
                    f"{coll['wire_bytes'] / 2**20:.3f} MiB on the wire")
                coll_ms = "-" if r["collective_s"] is None else f"{r['collective_s'] * 1e3:.4f} ms"
                log("dryrun", f"(a) {key}: rank holds {c['rank_argument_bytes'] / 2**30:.3f} GiB; compute "
                    f"{r['compute_s'] * 1e3:.4f} ms, memory {r['memory_s'] * 1e3:.4f} ms, collective {coll_ms} -> "
                    f"{r['bottleneck']}-bound (H100, rank 0); {coll_txt}")
    out.update({"ok": len(out["cells"]), "seconds": time.perf_counter() - t0})
    n_todo = 2 * len(todo) - len(DRYRUN_MULTI_ONLY_CELLS)
    log("dryrun", f"(a) {len(out['cells'])} cells ok of {n_todo} in {out['seconds']:.1f} s on the meta "
        f"device; left out: {', '.join(left_out)}; at (2, 16, 16) only: {', '.join(out['multi_only'])}")


def requested_bytes() -> int:
    """The bytes the caching allocator's callers hold, as they asked for
    them.  ``memory_allocated`` counts its blocks: each rounded up to 512
    bytes, and a large one with the unsplit tail (up to 1 MiB) of the
    segment it came from."""
    return torch.cuda.memory_stats()["requested_bytes.all.current"]


def dryrun_case(what: str, step_of, meta_args: tuple, make_args, kernel: str, per_step: int,
                flops_differ=None) -> dict:
    """(b) One step counted on meta tensors, then made real on the card and
    counted again.  The FLOPs must be equal (``flops_differ(meta, card)``
    gives the difference a shape-only stand-in may make); the meta run's
    argument bytes must equal the growth of the allocator's requested
    bytes while ``make_args()`` builds the real arguments (the growth of
    ``memory_allocated`` is logged beside it).  Then the step's peak beyond its arguments beside the meta
    estimate, and its ms (CUDA events) beside the roofline bound of the
    meta count.  Returns the record, with the card's ``kernel`` launches."""
    launches0 = launch_counts()
    meta = analysis.count_step(step_of(), meta_args)
    if launch_counts() != launches0:
        raise AssertionError(f"dryrun {what}: the meta run launched a kernel")
    torch.cuda.synchronize()
    base, base_alloc = requested_bytes(), torch.cuda.memory_allocated()
    args = make_args()
    torch.cuda.synchronize()
    grown, grown_alloc = requested_bytes() - base, torch.cuda.memory_allocated() - base_alloc
    shapes = [(tuple(t.shape), t.dtype) for t in analysis.tensor_leaves(args)]
    if shapes != [(tuple(t.shape), t.dtype) for t in analysis.tensor_leaves(meta_args)]:
        raise AssertionError(f"dryrun {what}: the real arguments are not the meta twins' shapes")
    if grown != meta.argument_bytes:
        raise AssertionError(f"dryrun {what}: the arguments took {grown} requested bytes on the card "
                             f"({grown_alloc} allocated), the meta count {meta.argument_bytes}")
    reset_launches()
    card = analysis.count_step(step_of(), args)
    torch.cuda.synchronize()
    launches = only_launched(kernel, f"dryrun {what} (counted)")
    diff = meta.flops - card.flops
    allowed = flops_differ(meta, card) if flops_differ else 0.0
    if diff != allowed:
        raise AssertionError(f"dryrun {what}: {meta.flops} FLOPs on meta, {card.flops} on the card "
                             f"(a difference of {diff}, {allowed} allowed)")
    del card
    step = step_of()
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    a0 = torch.cuda.memory_allocated()
    step(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - a0
    launches += only_launched(kernel, f"dryrun {what} (peak)")
    r, _ = timed_steps("dryrun", what, lambda _: step(*args), [None] * DRYRUN_STEPS, kernel,
                       per_step, 0)
    launches += r["launches"]
    roof = meta.roofline()
    bound_ms = roof.bound_s * 1e3
    out = {"flops": meta.flops, "tensor_core_flops": meta.tensor_core_flops, "bytes": meta.bytes,
           "flops_difference": diff, "argument_bytes": meta.argument_bytes, "requested_growth": grown,
           "allocated_growth": grown_alloc,
           "meta_peak_bytes": meta.peak_bytes, "card_peak_bytes": peak, "roofline": roof.as_dict(),
           "median_ms": r["median_ms"], "bound_ms": bound_ms, "share": bound_ms / r["median_ms"],
           "launches": launches}
    log("dryrun", f"(b) {what}: {meta.flops:.6e} FLOPs on meta == on the card"
        + (f" less {diff:.0f} (the padded edges)" if diff else "")
        + f"; arguments {meta.argument_bytes} bytes on meta == {grown} requested on the card "
        f"({grown_alloc} allocated in the allocator's blocks); peak beyond them "
        f"{meta.peak_bytes / 1e9:.3f} GB estimated on meta (unfused), "
        f"{peak / 1e9:.3f} GB max_memory_allocated; {r['median_ms']:.4f} ms a step (median of "
        f"{r['steps']}, CUDA events) against a {bound_ms:.4f} ms {roof.bottleneck} bound "
        f"({meta.bytes / 1e9:.3f} GB unfused, {meta.flops / 1e12:.3f} TFLOP): share {out['share']:.4f}; "
        f"{launches} {kernel} launches")
    del args, step, meta
    free()
    return out


def phase_dryrun(dev, gen, record) -> dict[str, int]:
    """(a) the dry run's sweep of rank programs; (b) qwen3-14b decode_32k
    (LM_LAYERS layers, B7), DLRM serve_bulk (B6) and a GCN train step at
    ogb_products (B6 forward and backward), each counted on meta tensors
    and on the card; (c) that GCN step as rank 0 of a one-rank mesh, on
    meta under a fake group and on the card under NCCL; (d) the custom
    ops' host cost.  Returns the card's B6 and B7 launches."""
    rec = record["dryrun"] = {}
    dryrun_sweep(rec)
    rules = shd.Rules.from_mesh(None)
    steps = rec["steps"] = {}

    # qwen3-14b decode_32k, as the lm phase's (b)
    cfg = dataclasses.replace(QWEN, n_layers=LM_LAYERS)
    batch, seq = DECODE_SHAPES["decode_32k"]
    kv = (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.d_head)
    meta_cache = {"k": torch.empty(kv, dtype=cfg.dtype, device="meta"),
                  "v": torch.empty(kv, dtype=cfg.dtype, device="meta"),
                  "len": torch.tensor(seq - 17, dtype=torch.int32)}
    decode_meta = (transformer.param_shapes(cfg), meta_cache,
                   torch.empty(batch, dtype=torch.int32, device="meta"))

    def decode_args():
        params = transformer.init_params(cfg, seed=SEED, device=dev)
        cache = {"k": lm_layers.normal(kv, 1.0, cfg.dtype, gen),
                 "v": lm_layers.normal(kv, 1.0, cfg.dtype, gen),
                 "len": torch.tensor(seq - 17, dtype=torch.int32, device=dev)}
        tokens = pipeline.lm_batch(cfg.vocab, batch, 1, step=1, seed=SEED, device=dev)["tokens"]
        tokens = tokens[:, 0].contiguous()
        return params, cache, tokens

    steps["qwen3-14b decode_32k"] = dryrun_case(
        f"qwen3-14b decode_32k ({cfg.n_layers} layers)", lambda: transformer.make_decode_step(cfg, rules),
        decode_meta, decode_args, "flash_decode_gqa", cfg.n_layers)

    # dlrm-mlperf serve_bulk, as the dlrm phase's
    shape = registry.RECSYS_SHAPES["serve_bulk"]
    dlrm_meta = (dlrm.param_shapes(DLRM), dlrm_mlperf.input_specs(DLRM, shape))

    def dlrm_args():
        params = dlrm.init_params(DLRM, seed=SEED, device=dev)
        b = pipeline.dlrm_batch(DLRM.table_sizes, DLRM.n_dense, DLRM.multi_hot, shape.dims["batch"], 10_000,
                                seed=SEED, device=dev)
        return params, {"dense": b["dense"], "sparse": b["sparse"]}

    steps["dlrm-mlperf serve_bulk"] = dryrun_case(
        "dlrm-mlperf serve_bulk", lambda: dlrm.make_serve_step(DLRM, rules), dlrm_meta, dlrm_args,
        "embedding_bag_sorted", DLRM.n_sparse)

    # gcn-cora at ogb_products, one AdamW train step, as the train phase's (a)
    shape = registry.GNN_SHAPES["ogb_products"]
    gcfg = gnn_common.gcn_for_shape(registry.get_arch("gcn-cora").full(), shape)
    spec = gnn_common.gnn_input_specs(gcfg, shape, needs_feat=True)
    n, e, _ = gnn_common.shape_counts(shape)
    e_pad = spec["edge_src"].shape[0]
    optimizer = opt_lib.get(gcfg.optimizer)
    gparams_meta = tree_map(lambda t: t.to("meta"), gnn.gcn_init(gcfg, seed=SEED, device="cpu"))
    gcn_meta = (gparams_meta, optimizer.init(gparams_meta), spec)

    def gcn_args():
        params = gnn.gcn_init(gcfg, seed=SEED, device=dev)
        src = torch.randint(0, n, (e_pad,), generator=gen, device=dev, dtype=torch.int32)
        dst = torch.randint(0, n, (e_pad,), generator=gen, device=dev, dtype=torch.int32)
        src[e:], dst[e:] = 0, 0
        train_mask = torch.zeros(spec["train_mask"].shape, dtype=torch.bool, device=dev)
        train_mask[torch.randperm(n, generator=gen, device=dev)[:OGB_TRAIN_NODES]] = True
        b = {"edge_src": src, "edge_dst": dst, "edge_mask": torch.arange(e_pad, device=dev) < e,
             "node_mask": torch.ones(n, dtype=torch.bool, device=dev),
             "node_feat": torch.randn(spec["node_feat"].shape, generator=gen, device=dev),
             "labels": torch.randint(0, gcfg.n_classes, spec["labels"].shape, generator=gen, device=dev,
                                     dtype=spec["labels"].dtype),
             "train_mask": train_mask}
        return params, optimizer.init(params), b

    def padded_edges(meta, card) -> float:
        """The meta run keeps the e_pad - e padded edges that the card's
        mask drops: each aggregation launch over the kept edges adds their
        rows' width in FLOPs per padded edge."""
        extra = 0.0
        if len(meta.kernels) != len(card.kernels):
            raise AssertionError("dryrun gcn: another count of B6 calls on meta than on the card")
        for (_, fm, _, nm), (_, fc, _, nc) in zip(meta.kernels, card.kernels):
            if nm != nc:
                if nm - nc != e_pad - e or fm - fc != (e_pad - e) * (fm // nm):
                    raise AssertionError(f"dryrun gcn: a B6 call of {nm} lookups on meta, {nc} on the card")
                extra += fm - fc
        if extra == 0:
            raise AssertionError("dryrun gcn: no B6 call ran over the padded edges on meta")
        return extra

    steps["gcn-cora ogb_products train"] = dryrun_case(
        "gcn-cora ogb_products train step", lambda: gnn.make_gnn_train_step(gcfg, rules), gcn_meta, gcn_args,
        "embedding_bag_sorted", 2 + 2 * gcfg.n_layers, padded_edges)
    steps["gcn-cora ogb_products train, rank 0 of (1, 1)"] = dryrun_rank_case(
        "gcn-cora ogb_products train step, rank 0 of (1, 1)", gcfg, gparams_meta, spec, gcn_args, n,
        2 + 2 * gcfg.n_layers, padded_edges, dev)
    rec["op_overhead"] = op_overhead(dev)

    return {"embedding_bag_sorted": steps["dlrm-mlperf serve_bulk"]["launches"]
            + steps["gcn-cora ogb_products train"]["launches"]
            + steps["gcn-cora ogb_products train, rank 0 of (1, 1)"]["launches"],
            "flash_decode_gqa": steps["qwen3-14b decode_32k"]["launches"]}


def dryrun_rank_case(what: str, cfg, params_meta, spec: dict, make_args, n_nodes: int, per_step: int,
                     flops_differ, dev) -> dict:
    """(c) The GCN train step as rank 0 of a (1, 1) mesh: counted on meta
    twins under a fake process group, then on the card under a one-rank
    NCCL group.  The collectives must be the same by kind (logical bytes,
    wire bytes, one-rank calls), the card's c10d bytes must equal the
    growth of ``WIRE_COUNTERS`` over the count, the FLOPs equal but for
    ``flops_differ``'s padded edges, B6 launched ``per_step`` times and
    nothing else; then B6 on the rank's degree scatter against its plain
    version (that launch counts in no path).  Returns the record, with
    the count's B6 launches."""
    layout = mesh_lib.MeshLayout(("data", "model"), (1, 1))
    with mesh_lib.fake_mesh(layout) as fm:
        frules = shd.Rules.from_mesh(fm)
        with shd.use_mesh(fm):
            state = gnn.optimizer_for(cfg, frules, params_meta).init(params_meta)
        meta = analysis.count_step(cells.on_mesh(fm, gnn.make_gnn_train_step(cfg, frules)), (params_meta, state, spec))
    tmp = tempfile.mkdtemp(prefix="chip-smoke-dryrun-")
    ranks.init_rank(0, 1, os.path.join(tmp, "nccl-store"), device=dev, timeout_s=MESH_TIMEOUT_S)
    try:
        m = mesh_lib.make_test_mesh(1, 1)
        rules = shd.Rules.from_mesh(m)
        params, _, batch = make_args()
        with shd.use_mesh(m):
            state = gnn.optimizer_for(cfg, rules, params).init(params)
        torch.cuda.synchronize()
        reset_launches()
        w0, calls0 = collectives.WIRE_COUNTERS["bytes"], collectives.WIRE_COUNTERS["all_reduces"]
        card = analysis.count_step(cells.on_mesh(m, gnn.make_gnn_train_step(cfg, rules)), (params, state, batch))
        torch.cuda.synchronize()
        wire, calls = collectives.WIRE_COUNTERS["bytes"] - w0, collectives.WIRE_COUNTERS["all_reduces"] - calls0
        launches = only_launched("embedding_bag_sorted", f"dryrun {what}")
        if launches != per_step:
            raise AssertionError(f"dryrun {what}: {launches} B6 launches, {per_step} expected")
        if card.wire.get("allreduce_") != {"calls": calls, "bytes": wire, "one_rank_calls": calls} or not calls:
            raise AssertionError(f"dryrun {what}: the card's c10d ops {card.wire} against WIRE_COUNTERS "
                                 f"{calls} all_reduces of {wire} bytes")
        if (meta.collectives, meta.wire) != (card.collectives, card.wire):
            raise AssertionError(f"dryrun {what}: collectives {meta.collectives} {meta.wire} on meta, "
                                 f"{card.collectives} {card.wire} on the card")
        diff, allowed = meta.flops - card.flops, flops_differ(meta, card)
        if diff != allowed:
            raise AssertionError(f"dryrun {what}: {meta.flops} FLOPs on meta, {card.flops} on the card "
                                 f"(a difference of {diff}, {allowed} allowed)")
        with shd.use_mesh(m):
            _, dst, emask = gnn.edge_block(rules, batch["edge_src"], batch["edge_dst"], batch["edge_mask"])
        edges = gnn.sort_edges(dst)
        ones = emask.to(torch.float32)[:, None].contiguous()
        got = embedbag.embedding_bag_sorted(ones, edges.order, edges.sorted_dst, n_nodes)
        if not torch.equal(got, embedbag.embedding_bag_sorted_plain(ones, edges.order, edges.sorted_dst, n_nodes)):
            raise AssertionError(f"dryrun {what}: B6 on the rank's degree scatter differs from its plain version")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"flops": card.flops, "flops_difference": diff, "collectives": card.collectives, "wire": card.wire,
           "wire_counter_bytes": wire, "all_reduces": calls, "launches": launches}
    log("dryrun", f"(c) {what}: {card.flops:.6e} FLOPs on the card, on meta less {diff:.0f} (the padded "
        f"edges); collectives equal on meta and on the card: {calls} all_reduces over one rank, {wire} bytes "
        f"== WIRE_COUNTERS, logical {card.collective_bytes:.0f} bytes; {launches} B6 launches; B6 == plain on "
        "the rank's degree scatter")
    del params, state, batch, card, meta
    free()
    return out


def op_overhead(dev) -> dict:
    """(d) Each kernel entry's custom op, called as the path calls it,
    against its CUDA implementation called directly (the ctypes launch
    the op dispatches to) on the same small inputs, and B6's op also
    through its autograd kernel: DRYRUN_OP_CALLS calls, then one
    synchronize, twice each in turn; host µs a call, the lesser of the
    two.  Both must give equal outputs; the launches made here count in
    no path."""
    saved = launch_counts()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    table = torch.randn((4096, 64), generator=gen, device=dev)
    idx = torch.randint(0, 4096, (8192,), generator=gen, device=dev, dtype=torch.int32)
    bags = torch.sort(torch.randint(0, 1024, (8192,), generator=gen, device=dev, dtype=torch.int32)).values
    q = torch.randn((1, 16, 128), generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((1, 2048, 2, 128), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    kv_len = torch.tensor(2000, dtype=torch.int32, device=dev)
    part = decode_attn.flash_decode_gqa_partials(q, k, v, kv_len, 0)
    cases = {
        "embedding_bag_sorted": (lambda: embedbag.embedding_bag_sorted(table, idx, bags, 1024),
                                 lambda: embedbag._launch(table, idx, bags, 1024)),
        # the op called as a grad-recording call would be, through the
        # Python autograd kernel that the wrapper's calls without a
        # gradient go past
        "embedding_bag_sorted, autograd kernel": (
            lambda: torch.ops.repro_torch.embedding_bag_sorted(table, idx, bags, 1024),
            lambda: embedbag._launch(table, idx, bags, 1024)),
        "flash_decode_gqa": (lambda: decode_attn.flash_decode_gqa(q, k, v, kv_len),
                             lambda: decode_attn._launch(q, k, v, kv_len, 512)),
        "flash_decode_gqa_partials": (
            lambda: torch.ops.repro_torch.flash_decode_gqa_partials(q, k, v, kv_len, 0, 512),
            lambda: decode_attn._launch_partials(q, k, v, kv_len, 0, 512)),
        "flash_decode_combine": (
            lambda: torch.ops.repro_torch.flash_decode_combine(part.buf, *part.shape, torch.bfloat16),
            lambda: decode_attn._launch_combine(part.buf, *part.shape, torch.bfloat16)),
    }
    out = {}
    for name, (op, direct) in cases.items():
        if not torch.equal(op(), direct()):
            raise AssertionError(f"dryrun (d) {name}: the custom op and its CUDA implementation differ")
        us = {}
        for label, fn in (("direct", direct), ("op", op), ("direct", direct), ("op", op)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DRYRUN_OP_CALLS):
                fn()
            torch.cuda.synchronize()
            us[label] = min(us.get(label, math.inf), (time.perf_counter() - t0) / DRYRUN_OP_CALLS * 1e6)
        out[name] = {"op_us": us["op"], "direct_us": us["direct"], "overhead_us": us["op"] - us["direct"]}
        log("dryrun", f"(d) {name}: {us['op']:.2f} us a call through the custom op, {us['direct']:.2f} us "
            f"calling its CUDA implementation directly: {us['op'] - us['direct']:.2f} us of dispatch "
            f"({DRYRUN_OP_CALLS} calls, one synchronize)")
    embedbag.LAUNCHES = saved["embedding_bag_sorted"]
    decode_attn.LAUNCHES = saved["flash_decode_gqa"]
    decode_attn.PARTIAL_LAUNCHES = saved["flash_decode_gqa_partials"]
    decode_attn.COMBINE_LAUNCHES = saved["flash_decode_combine"]
    del table, idx, bags, q, k, v, part
    free()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the full record as JSON to this file")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' bmm in full f32
    record: dict = {"seconds": {}}
    t_start = t_phase = time.perf_counter()

    def phase_end(name: str) -> None:
        nonlocal t_phase
        torch.cuda.synchronize()
        now = time.perf_counter()
        record["seconds"][name] = now - t_phase
        log(name, f"phase took {now - t_phase:.1f} s; {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
            "peak allocated in it")
        torch.cuda.reset_peak_memory_stats()
        t_phase = now

    # ---- env -------------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    total_mem = torch.cuda.get_device_properties(0).total_memory
    log("env", f"device {kind}; torch {torch.__version__}; CUDA {torch.version.cuda}; "
        f"{torch.cuda.device_count()} card(s); {total_mem / 1e9:.2f} GB")
    record["env"] = {"kind": kind, "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda}
    phase_end("env")

    # ---- build -----------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    log("build", f"{len(_build.SOURCES)} sources in {time.perf_counter() - t0:.2f} s wall")
    for name in _build.SOURCES:
        info = _build.BUILD_LOG[name]
        took = "cached" if info["seconds"] is None else f"nvcc {info['seconds']:.2f} s"
        log("build", f"{name}: {took}")
        for line in info["ptxas"].splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log("build", f"  {line.strip()}")
    record["build"] = _build.BUILD_LOG
    phase_end("build")

    # ---- setup: the twin, its placement, both Stage-A stores -------------
    t0 = time.perf_counter()
    g = alibaba_like(seed=SEED)
    placement = distribute(g, n_sites=RPQ.n_sites, replication_rate=RPQ.replication_rate, seed=SEED)
    log("setup", f"twin: {g.n_nodes} nodes, {g.n_edges} edges, {g.n_labels} labels; "
        f"{RPQ.n_sites} sites, K = {placement.replication_factor:.4f} "
        f"({time.perf_counter() - t0:.1f} s)")
    stores, record["setup"] = {}, {"device_bytes": total_mem}
    for td in ("f32", "uint32"):
        t0 = time.perf_counter()
        stores[td] = fops.stage_graph(g, block_size=128, tile_dtype=td, device=dev)
        torch.cuda.synchronize()
        stage_s = time.perf_counter() - t0
        s = stores[td]
        log("setup", f"Stage A {td}: {s.tiles.shape[0]} tiles of {tuple(s.tiles.shape[1:])} "
            f"{s.tiles.dtype}, {s.tile_store_bytes / 1e9:.4f} GB = "
            f"{100 * s.tile_store_bytes / total_mem:.3f}% of device memory ({stage_s:.1f} s)")
        record["setup"][td] = {"tiles": int(s.tiles.shape[0]), "bytes": s.tile_store_bytes,
                               "stage_s": stage_s}
    s32, su = stores["f32"], stores["uint32"]
    if list(s32.offsets) != list(su.offsets) or any(
        (a[0], a[1].tobytes(), a[2].tobytes()) != (b[0], b[1].tobytes(), b[2].tobytes())
        for a, b in zip(s32.offsets.values(), su.offsets.values())
    ):
        raise AssertionError("the uint32 store's offsets differ from the f32 store's")
    cas = {q: paa.compile_query(TABLE2_QUERIES[q], g) for q in QUERIES}
    q1_tids = torch.unique(fops.build_level_schedule(cas["q1"], su).tile_ids).long()
    if not torch.equal(fkernel.unpack_tile_bits(su.tiles[q1_tids], 128), s32.tiles[q1_tids]):
        raise AssertionError("q1's uint32 tiles do not unpack to its f32 tiles")
    log("setup", f"uint32 offsets == f32 offsets; q1's {len(q1_tids)} tiles unpack to the f32 tiles")
    del s32, su  # so that `del stores` after the baseline phase frees both stores
    phase_end("setup")

    # ---- kernels: each CUDA level kernel against its plain version ---------
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    flush = torch.empty(16 * 2**20, dtype=torch.float32, device=dev)  # 64 MB > L2
    max_err = check_kernels(stores, cas, dev, gen)
    level_times = record["level_times"] = time_levels(stores, cas, gen, flush)
    phase_end("kernels")

    # ---- path: s2_execute on q1, q9, q12 for each (backend, tiles) -------
    dg = to_device_graph(g, dev)
    index = paa.HostIndex(g)
    rng = np.random.default_rng(SEED)
    truth = {}
    for q in QUERIES:
        starts = paa.valid_start_nodes(cas[q], g)
        o_src, o_dst = paa.answers_multi_source(cas[q], dg, starts)
        sample = rng.choice(len(starts), size=min(N_METER_SAMPLES, len(starts)), replace=False)
        truth[q] = {
            "starts": starts,
            "pairs": np.unique(np.stack([o_src, o_dst]).T, axis=0),
            "meters": {int(i): paa.run_instrumented(cas[q], index, int(starts[i])) for i in sample},
        }
    record["path"], launches = {}, {}
    for name, k in KERNELS.items():
        backend, td = k["backend"], k["tile_dtype"]
        per_query = record["path"][f"{backend}/{td}"] = {}
        reset_launches()
        fops.FIXPOINT_COUNTERS.clear()
        for q in QUERIES:
            ca, t = cas[q], truth[q]
            c0 = dict(fops.FIXPOINT_COUNTERS)
            launch0 = launch_counts()[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            answers, costs = strategies.s2_execute(
                placement, ca, t["starts"], backend=backend, tile_dtype=td,
                staged=stores[td], device=dev,
            )
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            r = per_query[q] = {
                "starts": len(t["starts"]),
                **{k: fops.FIXPOINT_COUNTERS[k] - c0.get(k, 0)
                   for k in ("levels", "host_syncs", "bodies", "fixpoints", "replays", "captures")},
                "launches": launch_counts()[name] - launch0,
                "wall_ms": wall * 1e3,
                "queries_per_s": len(t["starts"]) / wall,
            }
            # the per-level loop read the frontier before every level and once more at each fixpoint's end
            r["host_syncs_per_level_loop"] = r["levels"] + r["fixpoints"]
            bs, vs = np.nonzero(answers)
            got = np.unique(np.stack([t["starts"][bs], vs]).T, axis=0)
            if not np.array_equal(got, t["pairs"]):
                raise AssertionError(f"{backend}/{td} {q}: answers differ from the device-BFS oracle")
            for i, tr in t["meters"].items():
                c = costs[i]
                # unicast symbols went through f32 x K and float64 / K: exact after rounding
                if (c.broadcast_symbols, round(c.unicast_symbols), c.n_broadcasts) != (
                    tr.q_bc, tr.d_s2, tr.n_broadcasts
                ):
                    raise AssertionError(f"{backend}/{td} {q} start {t['starts'][i]}: meters {c} != host {tr}")
            r["pairs"] = int(len(got))
            paper_pairs, paper_starts = TABLE2_PAPER[q]
            log("path", f"{backend}/{td} {q}: {r['starts']} starts (paper {paper_starts}), {r['pairs']} "
                f"answer pairs (paper {paper_pairs}, for information); {r['levels']} BFS levels in "
                f"{r['fixpoints']} fixpoints, {r['bodies']} bodies of {fops.LEVELS_PER_CHECK} levels "
                f"({r['replays']} replayed, {r['captures']} capture) = {r['launches']} launches, "
                f"{r['host_syncs']} host syncs ({r['host_syncs_per_level_loop']} on the per-level loop: "
                f"levels + fixpoints), {r['wall_ms']:.1f} ms, {r['queries_per_s']:.1f} queries/s; answers "
                f"== oracle, meters == host meter on {len(t['meters'])} starts")
        n = only_launched(name, f"the {backend}/{td} path")
        check_loop_launches(n, f"the {backend}/{td} path")
        launches[name] = n
    record["captured_vs_eager"] = check_captured_against_eager(placement, cas["q1"], truth["q1"]["starts"],
                                                               stores, dev)
    phase_end("path")

    record["trace"] = {}
    for k in KERNELS.values():
        backend, td = k["backend"], k["tile_dtype"]
        for q in QUERIES:
            query_args = (placement, cas[q], truth[q]["starts"], stores[td], dev, backend, k["symbol"])
            tr, path_q = trace_query(*query_args), record["path"][f"{backend}/{td}"][q]
            if tr["level_kernel"]["count"] != path_q["launches"]:
                # the tracer may drop a few of a run's ~10^4 device records (a
                # chip run has traced 1,085 of q9's 1,088 B1 launches, which the
                # wrapper counted exactly): trace a second run, which must match
                lost = tr["level_kernel"]["count"]
                log("trace", f"{backend}/{td} {q}: the trace holds {lost} of {path_q['launches']} "
                    "level-kernel launches; tracing another run")
                tr = trace_query(*query_args)
                tr["first_trace_count"] = lost
            record["trace"][f"{backend}/{td}/{q}"] = tr
            lk = tr["level_kernel"]
            if not lk["count"] == path_q["launches"] == path_q["bodies"] * fops.LEVELS_PER_CHECK:
                raise AssertionError(f"{backend}/{td} {q}: the trace holds {lk['count']} launches of "
                                     f"the level kernel {lk['name']}, the path phase "
                                     f"{path_q['launches']} in {path_q['bodies']} bodies")
            log("trace", f"{backend}/{td} {q}: set-up {tr['setup_ms']:.1f} ms, first run (capture) "
                f"{tr['first_run_ms']:.1f} ms, warm run {tr['run_ms']:.1f} ms "
                f"= {len(truth[q]['starts']) / tr['run_ms'] * 1e3:.1f} queries/s "
                f"({tr['traced_ms']:.1f} ms traced); device busy {tr['device_busy_ms']:.1f} ms, "
                f"idle share {tr['idle_share']:.4f} of the traced run, "
                f"{tr['idle_share_of_untraced_run']:.4f} of the untraced one; level kernel "
                f"{lk['ms']:.3f} ms device time in {lk['count']} launches; fills "
                f"{tr['fills']['ms']:.3f} ms in {tr['fills']['count']}")
            for kname, kt in list(tr["kernels"].items())[:8]:
                log("trace", f"  {kt['us'] / 1e3:9.3f} ms {kt['count']:6d}x  {kname[:90]}")

    phase_end("trace")

    phase_plan(g, placement, dg, stores["f32"], dev, record)
    phase_end("plan")

    for name, n in phase_witness(g, placement, cas, truth, stores["f32"], dev, record).items():
        launches[name] += n
    max_err["fused_level_blocks"] = max(max_err["fused_level_blocks"],
                                        record["witness"]["b1_counts_at_bound_max_abs_err"])
    phase_end("witness")

    sharded_launches, handoff = phase_sharded(g, placement, cas, truth, dg, dev, flush, record)
    for name, n in sharded_launches.items():
        launches[name] += n
    for name, check in (("fused_level_blocks", "iv_b1"), ("fused_level_blocks_u32", "iv_b3")):
        max_err[name] = max(max_err[name], record["sharded"][check]["max_abs_err"])
    phase_end("sharded")

    for name, n in phase_mesh(g, placement, cas, handoff, dev, record).items():
        launches[name] += n
    pl16 = handoff["pl16"]
    del handoff
    free()
    phase_end("mesh")

    serve_launches, serve_handoff = phase_serve(g, placement, pl16, dg, dev, record)
    for name, n in serve_launches.items():
        launches[name] += n
    phase_end("serve")

    for name, n in phase_mesh_serve(serve_handoff, pl16, dev, record).items():
        launches[name] += n
    del serve_handoff, pl16
    phase_end("mesh_serve")
    phase_examples(record)
    phase_end("examples")

    new_kernels = [phase_baseline(g, cas, dg, stores, dev, gen, flush, record)]
    del stores, dg
    free()
    phase_end("baseline")
    new_kernels.append(phase_embedbag(dev, gen, flush, record))
    phase_end("embedbag")
    new_kernels.append(phase_decode(dev, gen, flush, record))
    phase_end("decode")
    dlrm_launches, dlrm_params = phase_dlrm(dev, gen, record)
    new_kernels[1]["launches"] += dlrm_launches
    phase_end("dlrm")
    new_kernels[1]["launches"] += phase_mesh_dlrm(dlrm_params, dev, record)
    del dlrm_params
    free()
    phase_end("mesh_dlrm")
    n, finish_lm = phase_lm(dev, gen, record)
    new_kernels[2]["launches"] += n
    phase_end("lm")
    n, granite = phase_moe(dev, gen, record)
    new_kernels[2]["launches"] += n
    phase_end("moe")
    n, err = phase_mesh_lm(dev, flush, record, granite)
    del granite
    new_kernels[2]["launches"] += n
    new_kernels[2]["max_abs_err"] = max(new_kernels[2]["max_abs_err"], err)
    phase_end("mesh_lm")
    new_kernels[1]["launches"] += phase_gnn(dev, gen, record)
    finish_lm()  # the lm phase's CPU replay, run beside moe, mesh_lm and gnn
    phase_end("gnn")
    new_kernels[1]["launches"] += phase_mesh_models(dev, record)
    phase_end("mesh_models")
    n, gcn_handoff, train_checks = phase_train(dev, gen, flush, record)
    new_kernels[1]["launches"] += n
    phase_end("train")
    new_kernels[1]["launches"] += phase_mesh_train(dev, gcn_handoff, record)
    del gcn_handoff
    free()
    for check in train_checks:  # the train phase's CPU references, run beside it and mesh_train
        check()
    phase_end("mesh_train")
    dry = phase_dryrun(dev, gen, record)
    new_kernels[1]["launches"] += dry["embedding_bag_sorted"]
    new_kernels[2]["launches"] += dry["flash_decode_gqa"]
    phase_end("dryrun")

    kernels = [{
        "name": name,
        "route": "cuda",
        "source": k["source"],
        "replaces": k["replaces"],
        "launches": launches[name],
        "max_abs_err": max_err[name],
        "ms": level_times[name]["q1"]["ms"],
        "plain_ms": level_times[name]["q1"]["plain_ms"],
        "bound_ms": level_times[name]["q1"]["bound_ms"],
        "bound_by": level_times[name]["q1"]["bound_by"],
        "library_ms": None,
    } for name, k in KERNELS.items()] + new_kernels
    record["kernels"] = kernels
    log("end", f"phases (s): {record['seconds']}; total {time.perf_counter() - t_start:.1f} s")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1, default=str))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
