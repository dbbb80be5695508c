#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --sweep    # only the fused_fog / tree_traverse
                                     # route, K and lane-count sweep
                                     # (SWEEP_GRID) and grove_aggregate's
                                     # lanes a block (AGG_SWEEP); every run
                                     # sweeps BOUNDARY_GRID, and times
                                     # grove_aggregate, with the same code
    python3 chip_smoke.py --sweep grove_aggregate   # AGG_SWEEP alone

Drives ``repro_torch``'s inference path at the bench field (penbased, 16
trees of depth 8 split into 8 groves x 2, the 1000-row test set, threshold
0.3) through ``FogEngine.eval`` on all three backends and precisions, then
its training path (the device trainer at the gate config of
``benchmarks/train_bench.py``), the ``FogClassifier`` facade (train ->
plan -> serve), the grove ring, Mamba-2 and attention (tinyllama) LM
serving with the FoG layer-grove exit, the serving plane (the registry
plane, the fused plane and the serve CLI's LM mode), the paper's
evaluation path (Table 1, Figures 4-5, the ablation), the fused
autotuner, the MLA, MoE and hybrid LM configs, LM training
(tinyllama-1.1b and mamba2-2.7b at full width through the train CLI) and
the sharding plan on a one-rank mesh, and:

1. prints the card (``nvidia-smi`` name and power limit) and versions;
2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc,
   counts the tensor-core (``HGMMA``) instructions of every instance of
   ``flash_attention_kernel_sm90``, the backward's
   ``flash_attention_bwd_sm90_dkdv`` / ``_dkdv_split`` / ``_dq``,
   ``ssd_chunk_kernel_sm90`` and the SSD backward's ``ssd_bwd_sm90_ds`` /
   ``_dx`` / ``_dbdc`` in the library's SASS (``cuobjdump``; each must
   have some) and checks that ptxas reported no spills in
   ``ssd_chunk_kernel_sm90``, the tensor-core attention kernels
   (forward and backward), the tensor-core SSD backward,
   ``fused_fog_group_kernel``, ``tree_traverse_spread_kernel`` and
   ``grove_aggregate_tile_kernel`` (every instance; their registers
   printed, and the SIMT attention forward's and backward's and the SIMT
   SSD forward's and backward's);
3. trains the forest with the port's numpy CART, packs it at fp32, bf16 and
   int8 on the card, checks that the card's packs equal the CPU's field for
   field, and checks the packed table bytes;
4. evaluates with the ``fused``, ``pallas`` and ``reference`` backends from
   the same seeded start draws (launch and route counts zeroed just before
   and read just after: one ``fused_fog`` launch per fused eval, each on a
   group route, and 8 ``grove_aggregate`` per per-hop eval, each on the
   tile route), checks that they agree with each other and with the plain
   path on the CPU, and holds each kernel against its plain version
   (``fused_fog`` on each of its routes, bit for bit, at B = 1000, 65,536
   and 997, one and two heads, the bench threshold and per-lane thresholds
   and budgets)
   (``top2_confidence`` also at the LM gates' shapes and with repeated
   maxima, bit for bit, on each of its two launches; ``grove_aggregate``
   on both routes, bit for bit on all four outputs, at a mid-loop state
   and every ``aggregate_case``, a row-offset view and B = 65,536);
5. reports accuracy, mean hops and pJ per classification;
6. times each kernel, its plain version and the end-to-end backends with
   CUDA events (median of 20 warm runs) at B=1000 and B=65,536 --
   ``fused_fog`` beside the first port's kernel (the lane route) on the
   same inputs, ``grove_aggregate`` likewise at the per-hop path's live
   shares (hop 1, hop 2, none live) -- and works out each kernel's bounds
   from these inputs
   (the bytes the data makes it move, its operations, and for fused_fog
   the latency of the chain the function needs, one tree's walk, and of
   the serial chain, from a timed pointer chase; for grove_aggregate an
   empty kernel's device time and one dependent load);
7. trains with the device trainer at the gate config (penbased, 4000 rows,
   16 features, depth 8, 16 thresholds, every feature with a linear
   feature cost, seed 0) at 32 trees with the launch counts zeroed just
   before and read just after (the histogram kernel runs once per level),
   holds the kernel against its plain version and the scatter twin at
   every level of that fit (bit for bit), checks that each level's call
   runs the kernel alone on the device (no fill), that same-seed fits are
   bit-equal, that
   an untied fit equals the host CART and that the device trainer's RF
   accuracy is within 0.005 of the host CART's, and times both trainers at
   8, 16 and 32 trees and the kernel, its plain version and
   ``torch.bincount`` at every level;
8. fits ``FogClassifier(n_trees=16, grove_size=2, max_depth=8,
   trainer="device")`` on the card (counts zeroed and read around it),
   pins an energy budget calibrated on the test set, checks ``profile()``
   reports it met, quantizes to int8, saves, loads and checks the labels;
9. runs the grove ring (``FogEngine(backend="ring")``) on the bench field:
   one eval on ``RingMesh(8)`` with ``use_kernels`` with the counts zeroed
   just before and read just after (8 ``tree_traverse`` launches, all on
   the spread route, and 8 ``grove_aggregate``, all on the tile route),
   then at every precision and
   B=1000 and
   B=65,536 the kernel path on ``RingMesh(8)`` and the gather path on
   ``RingMesh(4)`` and ``RingMesh(1)`` against the ``reference`` backend
   from the same stratified starts, and the kernel path against the same
   ring on the CPU; holds ``tree_traverse`` on each of its routes against
   its plain version on the ring's stacked inputs, on one grove and on an
   unaligned batch; prints the per-hop occupancy; times the ring evals, the
   kernel beside the first port's kernel and its plain version, and works
   out the kernel's bounds;
10. serves ``mamba2-2.7b`` at full width and depth in bf16 (weights from a
   seeded ``torch.Generator``): with the counts zeroed just before and read
   just after, ``make_prefill_step`` prefills 4 prompts of 2048 tokens from
   ``batch_at_step`` (64 ``ssd_chunk`` launches, one per layer, all on the
   tensor-core route ``ssd_chunk_kernel_sm90``), then
   ``make_serve_step`` decodes 32 tokens greedily, then 32 with FoG at
   per-lane thresholds (0.0, 2.0, t, 2.0) and 32 more under a hop budget
   of 2 (3 ``top2_confidence`` launches per step), where t is set from the
   third lane's margins at a first FoG step run before the counts are
   zeroed; holds ``top2_confidence`` against its plain version on every
   gate input of the main path and checks that the hops are those the
   plain version's margins give, that the third lane both went on and
   exited on its margin, and that the never-exit lanes equal the plain
   decode; holds ``ssd_chunk``
   against its plain version, each case on the route it must take and
   under that route's bar: layer 0's captured bf16 inputs and random bf16
   at full width and a ragged chunk on the tensor cores, random fp32 at
   full width, ragged and at the fp32 training shape on the SIMT kernel
   (each SIMT case twice, bit-equal); checks at fp32 with all 64
   layers that decode after prefill equals the forward at every position;
   times prefill, decode, FoG decode, ``ssd_chunk``, the SIMT kernel on
   the same bf16 inputs and the gate's ``top2_confidence`` and works out
   ``ssd_chunk``'s bounds (the function's and its design's);
11. serves ``tinyllama-1.1b`` at full width and depth in bf16 the same
   way (22 layers, d_model 2048, 32 query heads and 4 KV heads of 64,
   SwiGLU d_ff 5632, vocab 32,000, 4 layer-groves of 6/6/5/5): the prefill
   of 4 prompts of 2048 tokens into caches of 2048 + 32 positions runs 22
   ``flash_attention`` launches and no other; greedy decode, FoG decode
   and the gate's checks as in 10; checks that all 22 prefill launches
   took the tensor-core route (``flash_attention_kernel_sm90``); holds
   ``flash_attention`` against its plain version on layer 0's captured
   bf16 q/k/v and on random inputs: bf16 on the tensor-core route at full
   width, a ragged Sq = Sk = 200, Sq != Sk causal both ways, non-causal,
   MQA (K = 1) and chameleon's heads (D = Dv = 128, 64 query heads, 8 KV
   heads), and fp32 on the SIMT route at full width, ragged, Sq != Sk,
   non-causal, D = 192 with Dv = 128 and D = Dv = 256 (each SIMT case
   twice with its lse, bit-equal, the lse within ``LSE_BAR``), each case
   checked for the route it took; checks at fp32 with all 22 layers that
   decode after prefill equals the forward; times the steps,
   ``flash_attention``,
   the SIMT kernel at the same bf16 inputs, its plain version and SDPA
   (``enable_gqa``, a yardstick the port never calls: call and device
   time and the backend that ran), and works out its bounds;
12. serves through the serving plane (``serve/`` and ``registry/``):
   the registry plane at the setup of ``benchmarks/registry_bench.py``
   (rebuilt here: penbased, 16 trees of depth 9, 8 groves of 2; tenants
   alpha / beta / gamma at Zipf shares, std / gold / bulk tiers with fp32
   and int8 contracts, 64 slots, 1500 requests of two tokens on a fixed
   arrival schedule, a hot-swap of alpha at 45 %, an int8 canary on beta
   from 70 %, beta governed under a budget its fp32 rungs miss), sync and
   pipelined, with the launch counts zeroed just before each measured run
   and read just after (one ``fused_fog`` a dispatch); holds every request
   done, the swap's in-flight requests on v1, the two modes bit-equal
   (labels, hops, energy, shed set, transitions, pinned versions), every
   served lane, witnessed at dispatch, equal to
   ``_eval_core(..., "reference")`` on its request's own row and owed
   knobs and the start its replica drew, and the "pallas" backend (8
   ``grove_aggregate`` a dispatch) equal to "fused"; the fused plane at
   1 replica x 1024 slots and 4 stream replicas x 256, fp32 and int8,
   sync and pipelined: checked runs on shared start draws hold every lane
   to the reference and the layouts and modes to each other, then timed
   runs launch one ``fused_fog`` a dispatch (counts zeroed just before,
   read just after) with each pair equal; and the serve CLI's LM mode at
   full width (tinyllama-1.1b, fp32, FoG with the top-2 kernel, 8
   requests, 4 slots), each first token equal to ``forward``'s argmax;
13. runs the paper's evaluation path (``repro_torch.paper``) with the
   launch counts zeroed just before and read just after: ``fused_fog``
   at the five Table 1 fields (each dataset's host-CART forest of 16
   trees at ``paper.common.DEPTHS``, 8 x 2, packed on the card at every
   precision; thresholds 1.1 and 0.3 from seeded starts), Table 1 on the
   card (the four baselines trained in fp32 with TF32 off, RF, FoG_max,
   FoG_opt) and ``paper.run``'s Figure 4, Figure 5 and ablation sections:
   one ``fused_fog`` launch an eval and no other kernel; holds every
   eval of that run (each recorded at ``_eval_core``: the fields, the
   Table 1 sweeps and each topology the figures launch, 16 x 1 to 1 x 16)
   equal to ``reference`` on the card and to the plain path on the CPU
   from its own inputs and starts (hops and labels equal, proba within
   rtol 1e-6 / atol 1e-7); prints each field's route, its bytes bound and
   the call's time;
   prints Table 1's accuracy and nJ rows and the geomean energy ratios
   beside the paper's; times each classifier's prediction over each test
   set (classifications/s); and trains each baseline on segmentation on
   the card and on the CPU from the same init (accuracy within 0.01); and
   holds each baseline's params after 5 steps from 2 inits on every
   dataset, card against CPU (within 1e-4 of each leaf's scale on
   segmentation; the CNN with TF32 on must part by more), with cuDNN's
   convolutions on beside them;
14. reads each kernel's device time, each eval's, the gate fit's, each
   LM step's and each serving run's device idle share from
   ``torch.profiler`` (after every event timing: once CUPTI traces the
   process, every launch costs the host more), with the serving runs'
   launches and host ops per dispatch, and times ``fused_fog``'s "smem"
   and "l1" routes on the device where ``fused_fog.route``'s copy-bytes
   line falls (``BOUNDARY_GRID``, each output checked bit for bit),
   beside the route the rule picks, and ``fused_fog``'s at the five
   paper fields; and the seed's and the tuned pick's device ms at every
   key of 15, and the steps of every config of 16 (their weights drawn
   again) with the split of device time into products,
   ``flash_attention``, ``top2_confidence``, ``ssd_chunk`` and the rest;
   and the train steps of 17 and 18 (their weights drawn again) with
   their splits.  Each step, eval and kernel is profiled once (a kernel
   again only when CUPTI returned no record of it); even so the whole run
   takes most of its 1200 s time limit on a slow host (the kernels line
   printed at 876.4 and 891.3 s in two runs on an H100 whose host-bound
   phases ran 1.3-1.6x slower than in earlier runs, at 642.1 s before);
15. tunes the fused launch (``kernels/autotune.py::tune``: every route
   the shapes fit x K x 64-512 threads, and chunks where K stays at
   ``max_hops``, each candidate held bit for bit to the seed's output) at
   the bench field (B = 1000 and 65,536) and the five Table 1 fields, at
   every precision and threshold 0.3, into ``build/autotune.json``;
   prints the seed's and the tuned pick's route, K, threads, chunk and
   device time (CUDA events behind a sleeping kernel) and the bytes
   bound; holds every tuned pick bit for bit to ``fused_fog_ref``; then
   reruns phase 13's fused evals (the fields, Table 1's forest columns
   and the figure sections) with the file loaded, every eval held to
   ``reference`` on the card and the CPU;
16. (run before 10, while no other model holds the card's memory)
   serves ``MORE_LM`` at full width in bf16, depth cut to fit the card
   (minicpm3-4b at 62 layers, grok-1-314b at 4, deepseek-v3-671b at 5:
   its 3 dense layers and 2 MoE layers; jamba-1.5-large-398b at its smoke
   config; gemma-2b at 18 layers): with the counts zeroed just before and
   read just after, a prefill of 4 x 2048 (one ``flash_attention`` an
   attention or MLA layer, one ``ssd_chunk`` a Mamba layer, each on its
   rule's route; minicpm3's 62, deepseek's 5 and gemma's 18 all on the
   tensor cores, ``SM90_PREFILL``), 32 greedy decode steps and 32 FoG
   steps at per-lane thresholds; the gate held to its plain version and
   the hops to its margins; the prefill's logits with the kernels held to
   those with their plain versions (drop-free capacity for MoE); at the
   head pairs of minicpm3, deepseek and gemma ``flash_attention`` held to
   its plain version (layer 0's bf16 inputs and ``MLA_FLASH_CASES``:
   causal bf16 and fp32 at S = 2048, ragged S = 200, non-causal, Sq != Sk
   both ways, MQA; each case run twice, bit-equal, its lse within
   ``LSE_BAR``), the prefill's call timed beside the SIMT kernel those
   pairs took before; fp32 decode after prefill == the forward at a small
   depth;
17. (run before 16, while the card's memory is free) trains
   ``tinyllama-1.1b`` at full width in fp32 (22 layers, d_model 2048,
   32 / 4 heads of 64, d_ff 5632, vocab 32,000; weights from the port's
   generator) through ``launch.train.main`` for 4 steps of 8 x 256
   tokens, the counts zeroed just before and read just after each step
   (44 ``flash_attention`` on the SIMT route, the forward and its remat
   recompute, and 22 ``flash_attention_bwd``; nothing else); holds the
   next step's loss and every gradient with the kernels against the same
   step with their plain versions on the card; holds the backward kernel
   against its plain version on layer 0's captured q/k/v/dO and
   ``BWD_CASES`` (ragged, Sq != Sk both ways, non-causal, MQA, D = 192 /
   Dv = 128, D = Dv = 256, MLA at smoke width) and a fully masked row,
   each run twice bit-equal; holds the SIMT forward against its plain
   version on layer 0's captured q/k/v and ``SIMT_FLASH_CASES`` (each tile
   boundary of ``fwd_tiles``, G odd, Sq != Sk both ways, non-causal, MQA;
   fp32 and, where the tensor cores do not take the pair, bf16) and a row
   that sees no finite score (output 0, lse -inf), each twice with its
   lse, bit-equal, the lse within ``LSE_BAR``; resumes at
   ``examples/train_lm.py``'s config
   (4 steps straight == 2, save, restore, 2, bit for bit); holds 5 steps
   on the card against the CPU port at the tiny config and one step of
   ``deepseek-v3-671b``'s smoke config (MLA, MoE, MTP) against the plain
   versions; times the step (tokens/s), the backward kernel beside its
   bounds, its plain version and SDPA's backward, and the fp32 forward
   with lse beside its bounds, its plain version, SDPA's fp32 forward and
   SDPA forced to its memory-efficient backend (K/V expanded to the query
   heads outside the timed call; forward and backward) (call ms here,
   device ms and SDPA's backends in 14); the profiler's split of
   a step's device time (products, ``flash_attention``, its backward, the
   rest; the CE chunks and the optimizer alone) comes in 14; checks that
   the 4 losses equal, bit for bit, those of the same 4 steps run in this
   phase with the update that builds whole new trees
   (``whole_tree_losses``);
18. (run after 17) trains ``mamba2-2.7b`` at full width and depth in fp32
   (64 layers, d_model 2560, 80 heads of 64, state 128, vocab 50,280;
   weights from the port's generator) through ``launch.train.main`` for 4
   steps of 8 x 256 tokens under the update that frees as it goes, the
   counts zeroed just before and read just after each step (128
   ``ssd_chunk`` on the SIMT route, the forward and its remat recompute,
   and 64 ``ssd_chunk_bwd``; nothing else); prints the peak memory, step
   ms and tokens/s; holds the next step's loss and every gradient with
   the kernels against the same step with their plain versions on the
   card; holds the backward kernel against ``ssd_chunk_bwd_ref`` on layer
   0's captured inputs and output gradients, on ``SSD_BWD_CASES`` (the
   CPU tests' shapes, ragged chunks and tiles) and on decays whose cumsum
   reaches -64, each run twice bit-equal; resumes bit for bit at a narrow
   mamba2 (4 layers, d_model 256); holds 5 steps of mamba2's smoke config
   on the card against the CPU port, and one step of jamba's smoke config
   (Mamba, attention, MoE: 2 forward and 1 backward launch of each kernel
   a layer) against the plain versions; times the backward kernel and
   the SIMT forward beside their bounds and plain versions, a call and on
   the device kernel by kernel (the forward's prep and main kernels, the
   backward's five passes); the profiler's
   split of a step's device time (products, ``ssd_chunk``, its backward,
   the optimizer alone, the elementwise rest) and the idle share come in
   14;
19. (run after 18) trains in bf16, through ``make_train_step`` given a
   bf16 model from the port's generator, at ``train_4k``'s sequence
   length of 4096 with its batch cut to 2: ``tinyllama-1.1b`` at full
   width and depth for 4 steps (44 ``flash_attention`` on the tensor-core
   route with lse and 22 ``flash_attention_bwd_sm90`` a step, nothing
   else), ``mamba2-2.7b`` at full width and depth for 4 steps (128
   ``ssd_chunk`` on the tensor-core route and 64 ``ssd_chunk_bwd_sm90`` a
   step), ``minicpm3-4b`` at full width cut to 8 layers for 2 steps (16
   ``flash_attention`` on the tensor-core route and 8
   ``flash_attention_bwd_sm90`` at D = 96 / Dv = 64 a step), the counts
   zeroed just before and read just after each step, and one step of
   jamba's smoke config; prints each run's peak memory, step ms and
   tokens/s; holds tinyllama's and minicpm3's next step, and a step of
   mamba2 cut to ``BF16_MAMBA_ORACLE_LAYERS`` layers, with the kernels
   and with the plain versions to an fp32 oracle of the same bf16 params
   (the kernels' distance of each gradient no more than twice the plain
   versions' plus half a bf16 ulp); at each pair of ``PAIR_SHAPES``
   (96 / 64, 192 / 128, 256 / 256) holds the tensor-core forward, its lse
   and backward to their plain versions and times them beside the SIMT
   kernels those pairs took before, the plain versions and SDPA (its
   fused backends; v padded where none takes Dv != D); holds each bf16
   backward
   kernel against its plain version on layer 0's captured inputs and on
   ``BWD_BF16_CASES`` / ``SSD_BWD_CASES`` (``ssd_chunk_bwd_sm90``, at P =
   64 and N = 128, against the replay of its rounding and float64:
   ``ssd_bwd_check``), each run twice bit-equal, and the tensor-core
   forward's lse against the plain version's; resumes a bf16 model bit
   for bit through a checkpoint; times the backwards beside their bounds,
   their plain versions and SDPA's bf16 backward, and the SIMT SSD
   backward on the same bf16 inputs (was);
   the profiler's split of each step (products, the attention and SSD
   forwards, their backwards, the optimizer, the elementwise rest) and
   the idle share come in 14;
20. (run after 19, while the card's memory is free) trains
   ``tinyllama-1.1b`` in bf16 at full width and depth at ``train_4k``'s
   full batch, 256 x 4096 = 1,048,576 tokens, through
   ``make_train_step(accum_steps=8)`` (microbatches of 32 x 4096): one
   forward and backward of a microbatch to warm its shapes, then one
   step with the counts zeroed just before and read just after (8 x (44
   ``flash_attention`` on the tensor-core route and 22
   ``flash_attention_bwd_sm90``)); prints its ms, training tokens/s, peak
   memory, loss and MFU (6ND over the step at the dense bf16 rate); prints
   ``launch.dryrun``'s peak estimate on meta for that microbatch and for
   phase 19's 2 x 4096 step beside their measured peaks; holds
   ``accum_steps=2`` against ``accum_steps=1`` at phase 17's fp32 setup
   (tinyllama-1.1b, 8 x 256: the loss within 1e-6 relative, each
   accumulated gradient within 1e-5 of its leaf's scale, each updated
   parameter within 1e-5 of its leaf's scale plus 1e-7), ``accum_steps=2``
   bit-equal run to run, and an accumulated step of tinyllama's smoke
   config on the card against the CPU port (phase 17's 1e-4); runs
   ``examples/serve_fog_lm.py``'s ``main()`` on the card (8 requests in
   three QoS tiers) and holds every request's tokens and hops equal to
   the same parameters served on the CPU; after 14's eval profiles it
   prints a ``[roofline]`` line for each backend (fused, per-hop
   ``pallas``, the ring on ``RingMesh(8)``) x precision x B = 1000 and
   65,536 at the bench field: ``launch.roofline``'s modeled bytes, FLOPs,
   bound and ideal time, and the achieved share of the eval's call ms and
   device ms, raising over 100 % (the per-hop eval priced at the card's
   traffic, the tables once an iteration: the model's per-hop class
   re-reads each lane's grove slice, a TPU's traffic the card serves
   from L2);
21. (run after 20, while the card's memory is free) applies the sharding
   plan (``launch.sharding``): starts a one-rank NCCL group, builds
   ``launch.mesh.make_host_mesh()`` and a (1, 1, 1) ``("pod", "data",
   "model")`` ``DeviceMesh``, places ``tinyllama-1.1b`` at full width in
   bf16 on each by ``param_shardings`` through ``shard_tree`` (each
   ``to_local()`` and ``full_tensor()`` bit-equal to its leaf); with the
   counts zeroed just before and read just after, prefills 4 x 2048 with
   the model rebuilt from the local shards (22 ``flash_attention`` on the
   tensor-core route), its logits and cache bit-equal to the same prefill
   on the whole parameters; on both meshes, the mesh serving steps
   (``make_prefill_step`` / ``make_serve_step(..., mesh=)``,
   ``mesh_serve_check``): that prefill with a cache of 2056 positions, 4
   greedy decode steps and 4 FoG steps (``"pallas"`` margin) at per-lane
   thresholds and a budget, each step's counts zeroed just before and
   read just after (22 ``flash_attention`` on the tensor cores a
   prefill, 3 ``top2_confidence`` a FoG step), the logits, hops and every
   cache leaf bit-equal to the one-card steps', each step's ms beside
   theirs, and the tensor-core forward on the heads of rank 1 of 2 along
   ``model`` (q heads 16-31, KV heads 2-3 of layer 0) bit-equal to that
   slice of the whole call; places the K/V cache by ``cache_shardings``
   (the batch on ``pod`` and ``data``, the heads on ``model``); saves the
   model and restores it onto the mesh through ``train.checkpoint.restore(
   ..., shardings=, mesh=)``, bit-equal; destroys the group; prints each
   config's per-card parameter and state bytes under the plan at JAX's 16
   x 16 and 2 x 16 x 16 meshes (counted on meta, not timed) and the
   phase's seconds; then, on both meshes, two steps of the mesh train
   step (``make_train_step(..., mesh=)``) of ``tinyllama-1.1b`` in bf16
   at phase 19's 2 x 4096, the counts zeroed just before and read just
   after each step (44 ``flash_attention`` on the tensor-core route and
   22 ``flash_attention_bwd_sm90``), every parameter, moment, loss and
   grad norm bit-equal to two one-card steps from the same state, each
   step's ms beside the one-card step's; and the smoke config's state
   after two mesh steps saved from the mesh and restored on the card
   bit-equal.  Then, with the one-rank group destroyed, the serving
   steps tensor-parallel over ``model`` (``top2_block_checks``,
   ``tp_serve_check``): ``top2_confidence``'s partials and merge entries
   bit-equal to their plain versions on blocks of rows ([4, 16000],
   [4, 32000] and [1, 50280] in two blocks, [1000, 10]; maxima repeated
   across the blocks give 0) and to one call on the whole rows, a [4,
   16000] block's pair timed beside the whole [4, 32000] call; then two
   processes share the card over a ``gloo`` group (``file://``
   rendezvous; NCCL refuses two ranks on one device), each with a (1, 2)
   ``("data", "model")`` mesh, ``tinyllama-1.1b`` bf16 placed by the
   plan: each rank's step parameters the sum of its blocks (half the
   model), none redistributed; the prefill, 4 decode and 4 FoG steps
   run tensor-parallel (a rank's heads, ``d_ff`` columns and vocabulary
   block), each step's counts zeroed just before and read just after (22
   ``flash_attention_sm90`` a rank a prefill, 3 top-2 partials and 3
   merges a FoG step); every output (logits and cache leaves) within the
   bf16 bar of the one-card steps (relative L2 from an fp32 one-card run
   at most twice the bf16 one-card run's, plus 2^-9), greedy tokens and
   hops equal to the one card's but for lanes within the bar (printed);
   the residuals, margins and hops identical on the two ranks; each
   rank's peak memory and step ms beside the one card's;
22. prints a ``{"kernels": [...]}`` line, then ``{"ok": true, ...}`` last.

Every number is also written to ``build/chip_smoke.json``.  Without
a CUDA device it exits non-zero and prints no result.  Any failed check
raises.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import importlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import (get_arch, param_count,  # noqa: E402
                                 smoke_config)
from repro_torch.core import (FogEngine, FogPolicy,  # noqa: E402
                              GroveCollection, RingMesh, split)
from repro_torch.core.energy import EnergyModel  # noqa: E402
from repro_torch.core.engine import (DEFAULT_BLOCK_B,  # noqa: E402
                                     FUSED_BLOCK_B, _eval_core,
                                     confidence_margin, fused_eval,
                                     sample_starts)
from repro_torch.core.fog_ring import TRAVERSE_BLOCK_B  # noqa: E402
fog_engine = importlib.import_module("repro_torch.core.engine")
from repro_torch.core.policy import NO_BUDGET  # noqa: E402
from repro_torch.data import (DataConfig, batch_at_step,  # noqa: E402
                              make_dataset)
from repro_torch.forest import (ForestPack, TrainConfig,  # noqa: E402
                                bin_features, quantile_bin_edges, rf_predict,
                                train_random_forest)
from repro_torch.forest import grow  # noqa: E402
from repro_torch.kernels import (_build, autotune, histogram,  # noqa: E402
                                 ops, ref)
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import fused_fog as ff  # noqa: E402
from repro_torch.kernels import grove_aggregate as ga  # noqa: E402
from repro_torch.kernels import tree_traverse as tt  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_ref, route as flash_route)
from repro_torch.kernels.top2_confidence import row_blocks  # noqa: E402
from repro_torch.kernels.fused_fog import fused_fog_ref  # noqa: E402
from repro_torch.kernels import ssd_chunk as ssd_mod  # noqa: E402
from repro_torch.kernels.ssd_chunk import (  # noqa: E402
    route as ssd_chunk_route, ssd_chunk_ref, ssd_chunk_sm90_replay)
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
# the H100's rates and each kernel's work counted from its inputs
from repro_torch.launch.roofline import (  # noqa: E402
    BF16_OPS_PER_S, FP32_OPS_PER_S, H100_SXM_BF16, HBM_BYTES_PER_S,
    RooflineModel, bound_ms, bwd_work, bwd_work_sm90, flash_design_ops,
    flash_work, fused_work, ssd_bwd_work, ssd_work)
from repro_torch.models.fog_exit import (decode_step_fog,  # noqa: E402
                                         fog_flops_per_token,
                                         grove_boundaries)
from repro_torch.registry import ModelRegistry, PackCache  # noqa: E402
from repro_torch.serve.decode import (make_prefill_step,  # noqa: E402
                                      make_serve_step)
from repro_torch.serve.dispatch import (DeviceDispatcher,  # noqa: E402
                                        ForestReplicaServer)
from repro_torch.serve.governor import (EnergyGovernor,  # noqa: E402
                                        TenantLedger, default_ladder)
from repro_torch.serve.scheduler import (ContinuousBatcher,  # noqa: E402
                                         Request)
from repro_torch.sklearn import FogClassifier  # noqa: E402
from repro_torch.baselines import ALL_BASELINES  # noqa: E402
from repro_torch.baselines import train as bl_train  # noqa: E402
from repro_torch.optim import (adamw, clip_by_global_norm,  # noqa: E402
                               linear_warmup_cosine, tree_leaves)
from repro_torch.examples import serve_fog_lm, train_lm  # noqa: E402
from repro_torch.launch.cost import analytic_model_flops  # noqa: E402
from repro_torch.launch.dryrun import (MESHES,  # noqa: E402
                                       dryrun_cell, per_device_state)
from repro_torch.launch.mesh import (MeshShape, dp_rank,  # noqa: E402
                                     make_host_mesh)
from repro_torch.launch.sharding import (  # noqa: E402
    cache_shardings, local_block, param_shardings, placements, rebuild,
    shard_tree)
from repro_torch.models.layers import MetaDraws  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.train import step_batch  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.loop import (SHAPES,  # noqa: E402
                                    accumulated_grads, apply_update,
                                    loss_and_grads, make_train_step,
                                    trainable)
from repro_torch.paper import ablation_adaptive  # noqa: E402
from repro_torch.paper import common as paper_common  # noqa: E402
from repro_torch.paper import fig5_threshold, table1_accuracy  # noqa: E402
from repro_torch.paper import run as paper_run  # noqa: E402
from repro_torch.paper import table1_energy  # noqa: E402
from repro_torch.paper.table1_energy import PAPER_RATIOS  # noqa: E402

PRECISIONS = ("fp32", "bf16", "int8")
BACKENDS = ("fused", "pallas", "reference")
TABLE_BYTES = {"fp32": 196_608, "bf16": 106_528, "int8": 61_488}
THRESH, MAX_HOPS, SEED = 0.3, 8, 0
BIG_B = 65_536
# the matching bar (tests/test_engine_conformance.py::_assert_conforms)
RTOL, ATOL = 1e-6, 1e-7
INFERENCE_KERNELS = ("fused_fog", "grove_aggregate", "top2_confidence")
SOURCE = {k: "src/repro_torch/kernels/csrc/fog_kernels.cu"
          for k in INFERENCE_KERNELS}
SOURCE["histogram"] = "src/repro_torch/kernels/csrc/histogram.cu"
SOURCE["tree_traverse"] = "src/repro_torch/kernels/csrc/tree_traverse.cu"
# ssd_chunk and flash_attention have two routes each (kernels/ssd_chunk.py::
# route, kernels/flash_attention.py::route): the main paths' bf16 takes the
# tensor-core kernels
SOURCE["ssd_chunk"] = "src/repro_torch/kernels/csrc/ssd_chunk_sm90.cu"
SOURCE["flash_attention"] = ("src/repro_torch/kernels/csrc/"
                             "flash_attention_sm90.cu")
SIMT_SOURCE = {"ssd_chunk": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
               "flash_attention": "src/repro_torch/kernels/csrc/"
                                  "flash_attention.cu"}
REPLACES = {"fused_fog": "src/repro/kernels/fused_fog.py:138",
            "grove_aggregate": "src/repro/kernels/grove_aggregate.py:29",
            "top2_confidence": "src/repro/kernels/top2_confidence.py:16",
            "histogram": "src/repro/kernels/histogram.py:60",
            "tree_traverse": "src/repro/kernels/tree_traverse.py:83",
            "ssd_chunk": "src/repro/kernels/ssd_chunk.py:28",
            "flash_attention": "src/repro/kernels/flash_attention.py:28"}
# the trainer's gate config (benchmarks/train_bench.py) and its bound
GATE_TREES = (8, 16, 32)
GATE_DEPTH = 8
GATE_MAX_ACC_GAP = 0.005
# the facade's energy budget: an operating point inside the frontier of
# the 16-tree depth-8 field (its cheapest points cost ~0.2 nJ)
BUDGET_NJ = 0.3
# the ring's meshes: one grove per shard (the kernel path), then two and
# eight groves per shard (the gather path)
RING_MESHES = (8, 4, 1)
# an unaligned per-shard batch for the kernel check, and a ragged fused
# batch
RAGGED_B = 37
FUSED_RAGGED_B = 997
# the LM slice: mamba2-2.7b at full width and depth in bf16, B prompts of
# S tokens (8 chunks of 256), greedy decode; FoG lanes that exit after
# one grove (0.0) or never exit (2.0), and lane LM_GATE_LANE, whose
# threshold is set from the margins of a first FoG step (lm_gate_threshold)
# so that the kernel's margins decide its hops; then a hop budget
LM_ARCH = "mamba2-2.7b"
# the attention path: tinyllama-1.1b at full width and depth, the same
# prompts, steps and lanes
ATTN_ARCH = "tinyllama-1.1b"
LM_B, LM_S, LM_DECODE = 4, 2048, 32
LM_THRESH = (0.0, 2.0, None, 2.0)
LM_GATE_LANE = 2
LM_BUDGET = 2
# decode after prefill == forward at fp32 (tests/test_archs.py:72, rtol /
# atol 2e-2); never-exit FoG lanes == plain decode (tests/test_fog_exit.py,
# 1e-5)
CONSIST_B, CONSIST_S, CONSIST_TOL = 2, 512, 2e-2
FOG_TOL = 1e-5
# a ragged chunk at full width for the kernel check
SSD_RAGGED = (2, 3, 200, 80, 64, 128)
# mamba2-2.7b's fp32 training shape (8 x 256 tokens, one chunk a row): the
# SIMT kernels' main path
SSD_FP32_TRAIN = (8, 1, 256, 80, 64, 128)
# where each kernel is launched on the main path
CALLED_BY = {
    "fused_fog": "FogEngine.eval, backend 'fused' (one launch per eval)",
    "grove_aggregate": "FogEngine.eval, backend 'pallas' (one launch per "
                       "hop, 8 per eval), and backend 'ring' on RingMesh(8) "
                       "with use_kernels (one launch per hop over all 8 "
                       "stacked shards, 8 per eval); each on the tile "
                       "route",
    "top2_confidence": "engine.confidence_margin(backend='pallas'), the "
                       "margin the LM gate reads; FogEngine.eval never "
                       "launches it (grove_aggregate computes its own "
                       "margin)",
    "histogram": "forest.grow.grow_forest (train_random_forest / "
                 "FogClassifier.fit with trainer='device'), one launch "
                 "per tree level",
    "tree_traverse": "FogEngine.eval, backend 'ring' on RingMesh(8) with "
                     "use_kernels (one launch per hop over all 8 stacked "
                     "shards)",
    "ssd_chunk": "models.mamba2.ssd_chunked(use_kernels=True) in every "
                 "Mamba-2 layer of serve.decode.make_prefill_step's prefill "
                 "(one launch per layer, 64 per prefill, each on the "
                 "tensor-core route)",
    "flash_attention": "models.layers.flash_attention(use_kernels=True) in "
                       "every attention layer of serve.decode."
                       "make_prefill_step's prefill (one launch per layer, "
                       "22 per tinyllama-1.1b prefill, each on the "
                       "tensor-core route); in training, ops.FlashAttention "
                       "(fp32, the SIMT route with lse: 44 a tinyllama-1.1b "
                       "step, the forward and its remat recompute)"}

# grove_aggregate's checks (here, tests/test_torch_grove_aggregate.py on the
# CPU and tests/test_torch_cuda.py on the card): batches around a warp and
# the bench's, class counts from one to the forest path's most, and the
# kinds of aggregate_case
AGG_B = (1, 31, 32, 33, 777, 1000)
AGG_C = (1, 2, 10, 26)
AGG_KINDS = ("mixed", "dead", "live", "ties", "ulp", "negzero")


def aggregate_case(rng, B: int, C: int, kind: str) -> tuple:
    """One hop update's inputs as numpy arrays (prob [B, C], contrib
    [B, C], live [B] bool, hops [B] int32, thresh [B] float32): "mixed"
    has its first warp of lanes dead, its second live and the rest at
    random; "dead" and "live" every lane so; "ties" repeats each row's
    first entry (prob and contrib both, so the sums tie; every eighth row
    all equal); "ulp" makes each row's second entry the float next to its
    first (the larger first in every other row) over hops of 1-6, so
    that dividing by max(hops, 1) can round the two maxima together;
    "negzero" puts -0.0 into dead lanes' prob rows."""
    prob = rng.random((B, C), dtype=np.float32) * 3
    contrib = rng.random((B, C), dtype=np.float32)
    live = rng.random(B) < 0.5
    hops = rng.integers(0, 5, B, dtype=np.int32)
    thresh = rng.random(B, dtype=np.float32) * 0.5
    if kind == "mixed":
        live[:32], live[32:64] = False, True
    elif kind in ("dead", "live"):
        live[:] = kind == "live"
    elif kind == "ties":
        prob[:, 1:2] = prob[:, :1]
        contrib[:, 1:2] = contrib[:, :1]
        prob[::8], contrib[::8] = 0.5, 0.25
    elif kind == "ulp":
        up = np.nextafter(prob[:, 0], np.float32(np.inf))
        prob[:, 1:2] = up[:, None]
        prob[::2, :2] = prob[::2, 1::-1][:, :2]
        contrib[:, 1:2] = contrib[:, :1]
        prob[:, 2:] *= 0.1
        hops[:] = rng.integers(1, 7, B, dtype=np.int32)
    elif kind == "negzero":
        prob[~live, ::2] = -0.0
    else:
        raise ValueError(f"kind must be one of {AGG_KINDS}, got {kind!r}")
    return prob, contrib, live, hops, thresh


def check_close(what: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Raise unless ``got`` meets the matching bar; the max abs error."""
    got, want = got.float().cpu(), want.float().cpu()
    if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"{what}: max abs err "
                             f"{(got - want).abs().max().item()}")
    return float((got - want).abs().max()) if got.numel() else 0.0


def check_equal(what: str, got: torch.Tensor, want: torch.Tensor) -> None:
    if not torch.equal(got.cpu(), want.cpu()):
        n = int((got.cpu() != want.cpu()).sum())
        raise AssertionError(f"{what}: {n} of {got.numel()} entries differ")


def cuda_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Median milliseconds of ``fn`` between two CUDA events, warm."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_profile(fn, reps: int = 10, warm: bool = True,
                   host: bool = True) -> tuple[dict, float, dict]:
    """Profile ``reps`` calls of ``fn``, after one unprofiled call unless
    ``warm`` is False: (device-busy ms per call by kernel name, from
    CUPTI's kernel records; wall ms per call; device ms per recorded
    launch by kernel name).  The last does not depend on how many records
    CUPTI returned: a short profile can lose some, which lowers the
    first.  ``host`` records the host's ops too; only the device's
    records are read, and phase 19's full-size bf16 steps record the
    device alone (their host records are the bulk of the profile's
    post-processing)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if host:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    total: dict = {}
    records: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            total[e.name] = total.get(e.name, 0.0) + e.time_range.elapsed_us()
            records[e.name] = records.get(e.name, 0) + 1
    busy = {k: v / 1e3 / reps for k, v in total.items()}
    per_launch = {k: v / 1e3 / records[k] for k, v in total.items()}
    return busy, wall, per_launch


# calls of an eval under one profile (each eval is profiled once)
EVAL_PROFILE_REPS = 3


# the kernel each backend's eval launches, which its profile must record
# ("": the eval runs plain ops alone)
EVAL_KERNEL = {"fused": "fused_fog", "pallas": "grove_aggregate",
               "reference": "", "ring": "tree_traverse"}


def eval_profile(fn, kernel: str, swap_aggregate: bool = False) -> dict:
    """An eval under the profiler: wall and device-busy ms per call, the
    idle share, the distinct device kernels and the device ms per launch
    of grove_aggregate's tile kernel in it; with ``swap_aggregate`` the
    same again with ``ops.grove_aggregate`` on the first kernel (the lane
    route): the same path in the same process ("was_").  The profiles
    record the device alone (an eval's host records, thousands of ops,
    are the bulk of a profile's post-processing; no figure reads them).
    A profile is taken again until it records ``kernel``, the kernel the
    eval launches (``retried_profile``: CUPTI may keep no record of a
    short kernel, and a fused eval is one of ~0.012 ms); the device
    figures are None if no profile did."""
    def profiled(k: str) -> tuple[float | None, float, dict]:
        busy, wall, per = retried_profile(fn, k, reps=EVAL_PROFILE_REPS,
                                          host=False)
        total = sum(busy.values()) if any(k in n for n in per) else None
        return total, wall, per

    busy_ms, wall, per = profiled(kernel)
    out = {"wall_ms": wall, "device_busy_ms": busy_ms,
           "device_idle_share": (None if busy_ms is None
                                 else 1.0 - busy_ms / wall),
           "device_kernels": len(per),
           "grove_aggregate_ms": kernel_ms(per, "grove_aggregate_tile")}
    if swap_aggregate:
        real = ops.grove_aggregate
        ops.grove_aggregate = lambda *a, block_b=256: (
            ga.grove_aggregate_on_route(*a, block_b=block_b, route="lane"))
        try:
            busy_ms, wall, per = profiled("grove_aggregate")
        finally:
            ops.grove_aggregate = real
        out.update(was_wall_ms=wall, was_device_busy_ms=busy_ms,
                   was_grove_aggregate_ms=kernel_ms(per, "grove_aggregate"))
    return out


def was_text(prof: dict) -> str:
    """``eval_profile``'s grove_aggregate figures, for a [time] line."""
    if "was_device_busy_ms" not in prof:
        return ""
    return (f"; grove_aggregate {fmt(prof['grove_aggregate_ms'])} ms a "
            f"launch, with the first kernel swapped in device busy "
            f"{fmt(prof['was_device_busy_ms'])} ms and "
            f"{fmt(prof['was_grove_aggregate_ms'])} a launch")


def kernel_ms(per_launch: dict, kernel: str) -> float | None:
    """Device ms of one call of the CUDA kernel named ``<kernel>_kernel``
    (the sum over its template instances), from ``device_profile``'s ms per
    recorded launch."""
    hits = [v for k, v in per_launch.items() if f"{kernel}_kernel" in k]
    return sum(hits) if hits else None


def profiled_ms(fn, kernel: str, tries: int = 3) -> float | None:
    """``kernel_ms`` of ``fn`` from the first of at most ``tries``
    profiles of 10 calls each that recorded the kernel (CUPTI may return
    no record of a short kernel in a profile)."""
    for _ in range(tries):
        got = kernel_ms(device_profile(fn)[2], kernel)
        if got is not None:
            return got
    return None


def recorded_profile(fn, kernel: str, tries: int = 5
                     ) -> list[tuple[dict, float, dict]]:
    """``device_profile`` of ``fn`` repeated until one profile recorded a
    device kernel whose name holds ``kernel`` (any kernel for ``""``), at
    most ``tries`` times: CUPTI may return no record of a short kernel in a
    profile.  Returns every profile taken, the recording one last; raises
    if none recorded it."""
    taken = []
    for _ in range(tries):
        taken.append(device_profile(fn))
        if any(kernel in k for k in taken[-1][0]):
            return taken
    raise AssertionError(f"{tries} profiles recorded no device kernel "
                         f"named like {kernel!r}")


def retried_profile(fn, kernel: str, tries: int = 5, reps: int = 10,
                    host: bool = True) -> tuple[dict, float, dict]:
    """``device_profile`` of ``fn`` (``reps`` calls; ``host`` as there)
    repeated until one recorded a device kernel whose name holds
    ``kernel``, at most ``tries`` times (CUPTI may drop the records of a
    short profile); the last profile taken, which holds no such kernel
    only if every try lost it."""
    for _ in range(tries):
        got = device_profile(fn, reps=reps, host=host)
        if any(kernel in k for k in got[2]):
            break
    return got


def fmt(ms: float | None) -> str:
    return "(no profiler record)" if ms is None else f"{ms:.4f}"


def fmt_share(x: float | None) -> str:
    return "(no profiler record)" if x is None else f"{x:.3f}"


def library_profile(fn, part: int = 2) -> tuple[float | None, str, dict]:
    """A library call timed beside a kernel as its yardstick (SDPA) under
    the profiler: (its device ms, the SDPA backend that ran, its kernels'
    device ms), from the last of at most five profiles, ``part`` picking
    ``device_profile``'s ms per call (0) or per launch (2).  Late in a run
    CUPTI at times returns no record of a library's kernels in any try:
    then (None, "not recorded", {}), and the call's CUDA-event time stands
    alone.  The port's own kernels are profiled with
    :func:`recorded_profile`, which raises instead."""
    per = retried_profile(fn, "")[part]
    if not per:
        return None, "not recorded", {}
    return sum(per.values()), sdpa_backend(max(per, key=per.get)), per


def load_latency_ns(dev: torch.device, n_bytes: int) -> float:
    """Nanoseconds per dependent global load over a working set of
    ``n_bytes``: a one-thread pointer chase (``fog_chase``) that visits
    every 32-byte sector of the set in a random cycle, timed at two chain
    lengths so that the launch cost cancels."""
    stride = 8                                     # int32 per sector
    n = max(n_bytes // 32, 2)
    order = np.random.default_rng(SEED).permutation(n) * stride
    nxt = np.zeros(n * stride, np.int32)
    nxt[order] = np.roll(order, -1)
    nxt = torch.as_tensor(nxt, device=dev)
    out = torch.empty((1,), dtype=torch.int32, device=dev)
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def chase(steps: int) -> None:
        rc = lib.fog_chase(nxt.data_ptr(), steps, out.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"fog_chase launch failed: CUDA error {rc}")

    short, long_ = 1 << 12, 1 << 15
    ms = {s: cuda_ms(lambda s=s: chase(s), reps=7) for s in (short, long_)}
    return (ms[long_] - ms[short]) * 1e6 / (long_ - short)


def gate_cfg(n_trees: int, trainer: str = "device", **kw) -> TrainConfig:
    """The trainer gate config of benchmarks/train_bench.py."""
    return TrainConfig(n_trees=n_trees, max_depth=GATE_DEPTH, n_thresholds=16,
                       max_features="all",
                       feature_cost=np.linspace(1.0, 2.0, 16).astype(
                           np.float32),
                       cost_weight=0.01, seed=0, trainer=trainer, **kw)


def captured_levels(fn):
    """Run ``fn`` with the trainer's histogram call wrapped; returns (its
    result, the ``(node, y, w, bins, kwargs)`` of every level)."""
    levels = []
    real = grow.histogram_level

    def spy(node, y, w, bins, **kw):
        levels.append((node.clone(), y, w, bins, kw))
        return real(node, y, w, bins, **kw)

    grow.histogram_level = spy
    try:
        return fn(), levels
    finally:
        grow.histogram_level = real


def wall_s(fn, reps: int = 5) -> float:
    """Median seconds of ``fn`` between two synchronizes, after one warm
    call."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def accuracy(forest, x, y) -> float:
    return float((rf_predict(forest, x).cpu().numpy() == y).mean())


def level_work(node, y, w, bins, n_nodes, n_bins, n_classes) -> tuple:
    """The histogram's bytes (node, w, y and bins read once; the
    ``[T, R, F*bins]`` output written once) and operations (one add per
    weighted (tree, sample, feature)) for one level's inputs."""
    T, N = node.shape
    F = bins.shape[1]
    n_bytes = (2 * T * N * 4 + N * 4 + N * F
               + T * n_nodes * n_classes * F * n_bins * 4)
    return n_bytes, int((w != 0).sum()) * F


def bincount_call(node, y, w, bins, n_nodes, n_bins, n_classes):
    """The one PyTorch call that computes the same counts, over flat
    indices made beforehand: ``torch.bincount(index, weights=w,
    minlength=T*R*F*bins)``."""
    T, N = node.shape
    F = bins.shape[1]
    R = n_nodes * n_classes
    dev = node.device
    row = (torch.arange(T, device=dev)[:, None] * R
           + node.long() * n_classes + y.long()[None, :])          # [T, N]
    flat = ((row[:, :, None] * F + torch.arange(F, device=dev)) * n_bins
            + bins.long()[None]).reshape(-1)
    wf = w[:, :, None].expand(T, N, F).reshape(-1).contiguous()
    size = T * R * F * n_bins
    return lambda: torch.bincount(flat, weights=wf, minlength=size)


def train_phase(dev: torch.device, ds) -> dict:
    """Phase 7: the device trainer at the gate config."""
    x, y, C = ds.x_train, ds.y_train, ds.n_classes
    N = len(y)
    # the main path: one gate fit, counts zeroed just before, read after
    for k in ops.launches:
        ops.launches[k] = 0
    forest, levels = captured_levels(lambda: train_random_forest(
        x, y, C, gate_cfg(GATE_TREES[-1]), device=dev))
    torch.cuda.synchronize()
    fit_launches = dict(ops.launches)
    print(f"[train] device trainer, gate config at {GATE_TREES[-1]} trees: "
          f"kernel launches {fit_launches}")
    if fit_launches["histogram"] != GATE_DEPTH:
        raise AssertionError(f"histogram launched {fit_launches['histogram']}"
                             f" times in a depth-{GATE_DEPTH} fit")
    if forest.feature.device.type != dev.type:
        raise AssertionError(f"the device trainer trained on "
                             f"{forest.feature.device}, not {dev}")

    # the kernel against its plain version and the twin, at every level
    max_err = 0.0
    for lv, (node, yy, w, bins, kw) in enumerate(levels):
        shape = dict(n_nodes=kw["n_nodes"], n_bins=kw["n_bins"],
                     n_classes=kw["n_classes"])
        got = histogram.histogram_level_cuda(node, yy, w, bins, **shape)
        want = histogram.histogram_level_ref(node, yy, w, bins, **shape)
        check_equal(f"histogram level {lv}: kernel vs plain", got, want)
        check_equal(f"histogram level {lv}: kernel vs scatter twin", got,
                    histogram.histogram_level_scatter(node, yy, w, bins,
                                                      **shape))
        max_err = max(max_err, float((got - want).abs().max()))
    print(f"[train] histogram kernel == plain version == scatter twin at "
          f"all {len(levels)} levels of the gate fit")

    again = train_random_forest(x, y, C, gate_cfg(GATE_TREES[-1]),
                                device=dev)
    for f in ("feature", "threshold", "leaf"):
        check_equal(f"same-seed card fits: {f}", getattr(again, f),
                    getattr(forest, f))
    untied = train_random_forest(x, y, C, gate_cfg(4, bootstrap=False),
                                 device=dev)
    host_untied = train_random_forest(x, y, C,
                                      gate_cfg(4, "host", bootstrap=False))
    check_equal("untied card fit vs host CART: feature", untied.feature,
                host_untied.feature)
    check_equal("untied card fit vs host CART: threshold", untied.threshold,
                host_untied.threshold)
    if not torch.allclose(untied.leaf.cpu(), host_untied.leaf, rtol=0,
                          atol=1e-6):
        raise AssertionError("untied card fit vs host CART: leaf")
    print("[train] same-seed card fits bit-equal; untied card fit == host "
          "CART (feature, threshold; leaf within 1e-6)")

    # both trainers at 8, 16 and 32 trees
    fits = []
    for T in GATE_TREES:
        dev_s = wall_s(lambda T=T: train_random_forest(
            x, y, C, gate_cfg(T), device=dev))
        t0 = time.perf_counter()
        host_f = train_random_forest(x, y, C, gate_cfg(T, "host"))
        host_s = time.perf_counter() - t0
        dev_f = (forest if T == GATE_TREES[-1] else train_random_forest(
            x, y, C, gate_cfg(T), device=dev))
        row = {"n_trees": T, "device_s": dev_s, "host_s": host_s,
               "tree_samples_per_s": {"device": N * T / dev_s,
                                      "host": N * T / host_s},
               "acc_device": accuracy(dev_f, ds.x_test, ds.y_test),
               "acc_host": accuracy(host_f, ds.x_test, ds.y_test)}
        fits.append(row)
        print(f"[train] {T} trees: device {dev_s * 1e3:.2f} ms "
              f"({row['tree_samples_per_s']['device']:.4g} tree*samples/s), "
              f"host CART {host_s:.2f} s "
              f"({row['tree_samples_per_s']['host']:.4g}); RF accuracy "
              f"device {row['acc_device']:.3f}, host {row['acc_host']:.3f}")
    gate = fits[-1]
    gap = round(abs(gate["acc_host"] - gate["acc_device"]), 9)
    # the host's share of a fit: quantile edges and binning in numpy
    bin_s = wall_s(lambda: bin_features(x, quantile_bin_edges(x, 16)))
    print(f"[train] host binning (quantile edges + bins, numpy): "
          f"{bin_s * 1e3:.2f} ms per fit")
    # how far the accuracy of a small forest moves with the draws alone
    seeds = {T: [accuracy(train_random_forest(
        x, y, C, dataclasses.replace(gate_cfg(T), seed=sd), device=dev),
        ds.x_test, ds.y_test) for sd in range(8)] for T in GATE_TREES[:1]}
    print(f"[train] device-trainer RF accuracy at {GATE_TREES[0]} trees over "
          f"seeds 0..7: {seeds[GATE_TREES[0]]}")

    # the kernel at each level of the gate fit: call, plain, library, bound
    per_level, fns = [], {}
    for lv, (node, yy, w, bins, kw) in enumerate(levels):
        shape = dict(n_nodes=kw["n_nodes"], n_bins=kw["n_bins"],
                     n_classes=kw["n_classes"])
        call = lambda a=(node, yy, w, bins), k=shape: (
            histogram.histogram_level_cuda(*a, **k))
        lib = bincount_call(node, yy, w, bins, **shape)
        check_equal(f"histogram level {lv}: bincount vs kernel",
                    lib().to(torch.float32).view(
                        node.shape[0], shape["n_nodes"], shape["n_classes"],
                        bins.shape[1], shape["n_bins"]).permute(0, 1, 3, 4, 2),
                    call())
        n_bytes, n_ops = level_work(node, yy, w, bins, **shape)
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        plan = histogram.tile_plan(
            *node.shape, bins.shape[1], shape["n_bins"], shape["n_classes"],
            shape["n_nodes"], n_sm=_build.sm_count(dev),
            smem_limit=_build.smem_optin(dev))
        per_level.append({
            "level": lv, "n_nodes": shape["n_nodes"],
            "plan": {"nodes_per_block": plan.nodes_per_block,
                     "features_per_block": plan.features_per_block,
                     "cluster": plan.cluster, "grid": list(plan.grid)},
            "ms": cuda_ms(call),
            "plain_ms": cuda_ms(lambda a=(node, yy, w, bins), k=shape: (
                histogram.histogram_level_ref(*a, **k))),
            "library_ms": cuda_ms(lib), "bytes": n_bytes, "ops": n_ops,
            "bound_ms": b_ms, "bound_by": b_by})
        fns[lv] = call
    tuned = autotune.tune_histogram(
        GATE_TREES[-1], GATE_DEPTH, x.shape[1], 17, C, n_samples=N,
        persist=False, device=dev)
    autotune.clear_cache()      # the gate fits above used the analytic seed
    print(f"[train] tune_histogram at the gate signature (not used by the "
          f"fits): {tuned.to_dict()}")
    return {"launches": fit_launches, "max_abs_err": max_err, "fits": fits,
            "acc_gap": gap, "acc_device_over_seeds": seeds,
            "host_binning_s": bin_s,
            "levels": per_level, "level_fns": fns,
            "gate_fit": lambda: train_random_forest(
                x, y, C, gate_cfg(GATE_TREES[-1]), device=dev),
            "tuned": tuned.to_dict()}


def facade_phase(dev: torch.device, ds) -> dict:
    """Phase 8: train -> plan -> serve through ``FogClassifier``."""
    for k in ops.launches:
        ops.launches[k] = 0
    t0 = time.perf_counter()
    clf = FogClassifier(n_trees=16, grove_size=2, max_depth=8,
                        trainer="device").fit(ds.x_train, ds.y_train)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    clf.set_energy_budget(BUDGET_NJ, ds.x_test, ds.y_test)
    budget_s = time.perf_counter() - t0
    acc = clf.score(ds.x_test, ds.y_test)
    prof = clf.profile()
    if prof["within_budget"] is not True:
        raise AssertionError(f"facade profile not within budget: {prof}")
    clf.quantize("int8")
    want = clf.predict(ds.x_test)
    path = ROOT / "build" / "chip_smoke_model.npz"
    path.parent.mkdir(exist_ok=True)
    clf.save(path)
    loaded = FogClassifier.load(path)
    got = loaded.predict(ds.x_test)
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    check_equal("facade labels after save -> load", torch.as_tensor(got),
                torch.as_tensor(want))
    for k in ("histogram", "fused_fog"):
        if launches[k] < 1:
            raise AssertionError(f"kernel {k} was not launched by the facade")
    if clf.engine_.device.type != dev.type or \
            loaded.engine_.device.type != dev.type:
        raise AssertionError(f"the facade did not run on {dev}")
    predict_ms = cuda_ms(lambda: loaded.predict(ds.x_test))
    res = {"fit_s": fit_s, "set_energy_budget_s": budget_s,
           "predict_ms": predict_ms, "accuracy_pinned": acc,
           "profile": prof, "pinned_policy": clf.frontier_.under_budget(
               BUDGET_NJ).policy.to_dict(),
           "frontier_points": len(clf.frontier_),
           "accuracy_int8_loaded": float((got == ds.y_test).mean()),
           "launches": launches}
    print(f"[facade] FogClassifier(16 trees, 8 x 2, depth 8, device "
          f"trainer): fit {fit_s * 1e3:.1f} ms, set_energy_budget("
          f"{BUDGET_NJ} nJ) {budget_s * 1e3:.1f} ms over "
          f"{len(clf.frontier_)} frontier points; pinned "
          f"{res['pinned_policy']}, accuracy {acc:.3f}, "
          f"{prof['energy_nj_per_classification']:.4f} nJ/classification, "
          f"within budget; int8 save -> load labels identical (accuracy "
          f"{res['accuracy_int8_loaded']:.3f}), loaded predict "
          f"{predict_ms:.3f} ms; kernel launches {launches}")
    return res


def fused_checks(dev: torch.device, cases: list, x: torch.Tensor,
                 gen) -> dict:
    """fused_fog on each of its routes against its plain version, bit for
    bit (``torch.equal`` on proba and hops): every case (the bench field at
    each precision, two heads at int8 and fp32) at B = 1000, 65,536 and a
    ragged batch, at the bench threshold and at per-lane thresholds and
    budgets; the "smem" route wherever the field fits one block (not two
    fp32 heads).  Returns the routes checked per case."""
    rng = np.random.default_rng(SEED)
    checked: dict = {}
    for nb in (x.shape[0], BIG_B, FUSED_RAGGED_B):
        xb = x.repeat(-(-nb // x.shape[0]), 1)[:nb].contiguous()
        knobs = (("bench", torch.full((nb,), THRESH, device=dev),
                  torch.full((nb,), MAX_HOPS, dtype=torch.int32,
                             device=dev)),
                 ("per lane", torch.as_tensor(rng.random(nb, dtype=np.float32),
                                              device=dev),
                  torch.as_tensor(rng.integers(1, MAX_HOPS + 1, nb,
                                               dtype=np.int32), device=dev)))
        for label, pack in cases:
            lay = pack.layout("fused")
            O, G, t = lay[0].shape[:3]
            sb = sample_starts(gen.manual_seed(SEED + 1), nb, G)
            smem = ff.plan("smem", nb, O, G, t, pack.depth, pack.n_classes,
                           xb.shape[1], pack.threshold.element_size(),
                           MAX_HOPS, FUSED_BLOCK_B, _build.sm_count(dev))
            names = ["l1", "lane"] + (
                ["smem"] if smem["smem"] <= _build.smem_optin(dev) else [])
            for what, thr, bud in knobs:
                args = (*lay[:3], xb, sb, thr, bud, *lay[3:])
                pr, hr = fused_fog_ref(*args, max_hops=MAX_HOPS)
                for name in names:
                    pk, hk = ff.fused_fog_on_route(
                        *args, max_hops=MAX_HOPS, block_b=FUSED_BLOCK_B,
                        route=name)
                    tag = f"fused_fog {name} {label} B={nb} {what}"
                    check_equal(f"{tag} hops", hk, hr)
                    check_equal(f"{tag} proba", pk, pr)
            checked[f"B={nb} {label}"] = names
    print(f"[kernels] fused_fog == its plain version (torch.equal, proba "
          f"and hops) on every route, at the bench threshold and per-lane "
          f"thresholds and budgets: {checked}")
    return checked


def ring_inputs(pack: ForestPack, x: torch.Tensor, start: torch.Tensor,
                n: int = 8) -> tuple:
    """The tree_traverse inputs of one ring hop on ``RingMesh(n)`` with one
    grove per shard: the ring layout's tables ``[n, t, ...]`` and the lanes
    stably sorted onto their start grove's shard, ``[n, B/n, F]``."""
    tables = pack.layout("ring", n)
    perm = torch.argsort(start.long() % n, stable=True)
    return (*tables[:3], x[perm].reshape(n, -1, x.shape[1]), *tables[3:])


def traverse_work(pack: ForestPack, xs: torch.Tensor) -> dict:
    """The work of one tree_traverse call over ``xs [S, b, F]``, from these
    shapes: ``bytes`` each input read once (every shard's grove, x) and the
    output written once; ``ops`` per lane ``t*d`` compares, ``t*C`` leaf
    adds and ``C`` divides (int8 adds one multiply per threshold and leaf
    value dequantized); ``chain`` the dependent loads of one tree's walk:
    ``d`` levels of (node, then ``x[feature]``) and the leaf row."""
    S, b, F = xs.shape
    t, d, C = pack.grove_size, pack.depth, pack.n_classes
    grove = pack.table_bytes // pack.n_groves
    io = S * b * (F + C) * 4
    q = 2 if pack.precision == "int8" else 1
    return {"bytes": S * grove + io,
            "ops": S * b * (t * d * q + t * C * q + C),
            "grove_bytes": grove, "x_bytes": S * b * F * 4,
            "chain_per_tree": (d, d, 1), "trees": t}


def ring_phase(dev: torch.device, ds, packs: dict, gen) -> dict:
    """Phase 9: the grove ring on the bench field."""
    G = packs["fp32"].n_groves
    policy = FogPolicy(threshold=THRESH, max_hops=MAX_HOPS)
    x0 = torch.as_tensor(ds.x_test, device=dev)
    y = torch.as_tensor(ds.y_test, device=dev)
    B = x0.shape[0]
    xs = {nb: x0.repeat((nb + B - 1) // B, 1)[:nb].contiguous()
          for nb in (B, BIG_B)}
    starts = {nb: sample_starts(gen.manual_seed(SEED), nb, G, dev,
                                n_shards=RING_MESHES[0]) for nb in xs}
    engines = {(p, n): FogEngine(packs[p], backend="ring", mesh=RingMesh(n),
                                 use_kernels=n == G, device=dev)
               for p in PRECISIONS for n in RING_MESHES}
    refs = {p: FogEngine(packs[p], device=dev) for p in PRECISIONS}

    # the main path: one ring eval, counts zeroed just before, read after
    for k in ops.launches:
        ops.launches[k] = 0
    for k in _build.routes:
        _build.routes[k] = 0
    engines["fp32", G].eval(xs[B], start=starts[B], policy=policy)
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    routes = {k: _build.routes[k] for k in TRAVERSE_ROUTES + AGG_ROUTES}
    print(f"[ring] one eval on RingMesh({G}) with use_kernels, B={B}: "
          f"kernel launches {launches}; tree_traverse and grove_aggregate "
          f"by route {routes}")
    for k in ("tree_traverse", "grove_aggregate"):
        if launches[k] != MAX_HOPS:
            raise AssertionError(f"{k} launched {launches[k]} times in a "
                                 f"{MAX_HOPS}-hop ring eval")
    if routes["tree_traverse_spread"] != MAX_HOPS or routes["tree_traverse"]:
        raise AssertionError(f"want every tree_traverse launch of the ring "
                             f"eval on the spread route: {routes}")
    if routes["grove_aggregate_tile"] != MAX_HOPS or routes["grove_aggregate"]:
        raise AssertionError(f"want every grove_aggregate launch of the ring "
                             f"eval on the tile route: {routes}")

    # every mesh against the reference backend, and the card against the CPU
    results, max_err = {}, 0.0
    for nb, xb in xs.items():
        for p in PRECISIONS:
            want = refs[p].eval(xb, start=starts[nb], policy=policy)
            cpu = FogEngine(packs[p].to("cpu"), backend="ring",
                            mesh=RingMesh(G), use_kernels=True,
                            device="cpu").eval(xb.cpu(),
                                               start=starts[nb].cpu(),
                                               policy=policy)
            for n in RING_MESHES:
                got = engines[p, n].eval(xb, start=starts[nb], policy=policy)
                tag = f"ring B={nb} {p} RingMesh({n})"
                check_equal(f"{tag} hops", got.hops, want.hops)
                check_equal(f"{tag} labels", got.label, want.label)
                max_err = max(max_err, check_close(f"{tag} proba", got.proba,
                                                   want.proba))
                check_equal(f"{tag} energy", got.energy_pj,
                            got.model.lane_pj(got.hops))
                if n == G:
                    for f in ("hops", "label", "proba"):
                        check_equal(f"{tag} card vs cpu {f}",
                                    getattr(got, f), getattr(cpu, f))
                    hops = got.hops
            row = {"accuracy": float((want.label == y.repeat(
                       nb // B + 1)[:nb]).float().mean()),
                   "mean_hops": float(hops.float().mean()),
                   "occupancy": [float((hops > j).float().mean())
                                 for j in range(MAX_HOPS)]}
            results[nb, p] = row
            print(f"[ring] B={nb} {p}: RingMesh(8/4/1) == reference (hops, "
                  f"labels; proba max abs err {max_err:.3g}), kernel path on "
                  f"the card == on the CPU; accuracy {row['accuracy']:.3f}, "
                  f"mean hops {row['mean_hops']:.3f}; occupancy "
                  + " ".join(f"hop{j}:{v:.2f}"
                             for j, v in enumerate(row["occupancy"])))

    # the kernel against its plain version: the ring's stacked inputs,
    # one grove (the TPU signature) and an unaligned batch
    kernel_err = 0.0
    for p in PRECISIONS:
        for nb, xb in xs.items():
            stacked = ring_inputs(packs[p], xb, starts[nb], G)
            one = (*(a[0] for a in stacked[:3]), xb,
                   *(a[0] for a in stacked[4:]))
            ragged = (*stacked[:3], stacked[3][:, :RAGGED_B].contiguous(),
                      *stacked[4:])
            for what, args in (("stacked", stacked), ("one grove", one),
                               (f"b={RAGGED_B}", ragged)):
                want = ref.tree_traverse_ref(*args)
                for name in tt.ROUTES:
                    got = tt.tree_traverse_on_route(
                        *args, block_b=TRAVERSE_BLOCK_B, route=name)
                    check_equal(f"tree_traverse {name} {p} B={nb} {what}",
                                got, want)
                    kernel_err = max(kernel_err,
                                     float((got - want).abs().max()))
    print("[ring] tree_traverse == its plain version (torch.equal) on every "
          f"route {tt.ROUTES} at every precision: stacked [8, B/8], one "
          f"grove [B], unaligned [8, {RAGGED_B}]")

    # time: the ring evals, the kernel and its plain version, the bounds
    timing, kernel_fns, eval_fns = {}, {}, {}
    for nb, xb in xs.items():
        for p in PRECISIONS:
            row = results[nb, p]
            for n in RING_MESHES:
                ev = lambda e=engines[p, n], xx=xb: e.eval(
                    xx, gen.manual_seed(SEED), policy=policy)
                row[f"eval_ring{n}_ms"] = cuda_ms(ev)
                row[f"eval_ring{n}_classifications_per_s"] = (
                    nb / row[f"eval_ring{n}_ms"] * 1e3)
                eval_fns[nb, p, n] = ev
            args = ring_inputs(packs[p], xb, starts[nb], G)
            call = lambda a=args: ops.tree_traverse(
                *a, block_b=TRAVERSE_BLOCK_B)
            # the first port's kernel on the same inputs
            was = lambda a=args: tt.tree_traverse_on_route(
                *a, block_b=TRAVERSE_BLOCK_B, route="lane")
            before = dict(_build.routes)
            call()
            row["tree_traverse_route"] = [
                k for k in TRAVERSE_ROUTES if _build.routes[k] != before[k]]
            row["tree_traverse_ms"] = cuda_ms(call)
            row["tree_traverse_was_ms"] = cuda_ms(was)
            row["tree_traverse_plain_ms"] = cuda_ms(
                lambda a=args: ref.tree_traverse_ref(*a))
            kernel_fns[nb, p, "tree_traverse"] = call
            kernel_fns[nb, p, "tree_traverse_was"] = was
            work = traverse_work(packs[p], args[3])
            row["tree_traverse_work"] = work
            row["tree_traverse_bound_ms"], row["tree_traverse_bound_by"] = (
                bound_ms(work["bytes"], work["ops"]))
            timing[nb, p] = row
    return {"launches": launches, "routes": routes,
            "max_abs_err": kernel_err,
            "ring_max_abs_err_vs_reference": max_err, "timing": timing,
            "kernel_fns": kernel_fns, "eval_fns": eval_fns}


def redesign_rows(timing: dict, k: str) -> dict:
    """The redesigned kernel's numbers per batch and precision: its route,
    call and device ms, the first kernel's on the same inputs ("was"), the
    bounds and the plain version's ms."""
    keys = ("route", "ms", "device_ms", "was_ms", "was_device_ms",
            "bound_ms", "bound_by", "latency_bound_ms", "serial_chain_ms",
            "plain_ms")
    return {f"B={nb} {p}": {key: row[f"{k}_{key}"] for key in keys}
            for (nb, p), row in timing.items()}


def ring_latency_bounds(dev: torch.device, timing: dict) -> None:
    """tree_traverse's latency bound per row: the chain the function needs,
    one tree's walk -- ``d`` levels of (node load, then ``x[feature]``) and
    the leaf row; the t trees of a lane can be walked at once -- priced
    with ``load_latency_ns``: the node and leaf loads over a working set of
    one grove's bytes (the chase over so small a set hits L1), the ``x``
    gathers over the stacked ``x``'s bytes.  The serial chain, the t trees
    one after another as the first port's kernel walks them, is kept as a
    second figure."""
    for row in timing.values():
        w = row["tree_traverse_work"]
        grove_ns = load_latency_ns(dev, w["grove_bytes"])
        x_ns = load_latency_ns(dev, w["x_bytes"])
        nodes, xs, leaf = w["chain_per_tree"]
        tree_ms = ((nodes + leaf) * grove_ns + xs * x_ns) * 1e-6
        row["tree_traverse_latency_ns"] = {"grove": grove_ns, "x": x_ns}
        row["tree_traverse_latency_bound_ms"] = tree_ms
        row["tree_traverse_serial_chain_ms"] = w["trees"] * tree_ms


def bits(t: torch.Tensor) -> torch.Tensor:
    """A float32 tensor's bit patterns (so -0.0 != +0.0), others as is."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def aggregate_equal(what: str, got: tuple, want: tuple) -> None:
    """grove_aggregate's four outputs bit for bit."""
    for name, g, w in zip(("prob", "hops", "live", "margin"), got, want):
        if g.dtype != w.dtype:
            raise AssertionError(f"{what} {name}: {g.dtype} != {w.dtype}")
        check_equal(f"{what} {name}", bits(g), bits(w))


def aggregate_checks(dev: torch.device) -> int:
    """grove_aggregate on both routes against its plain version, bit for
    bit on all four outputs: every ``aggregate_case`` kind at every
    ``AGG_B`` x ``AGG_C``, scalar and per-lane thresholds; row-offset views
    (off a 16-byte boundary) with NaN in dead lanes' contrib; B = 65,536.
    Returns the number of cases."""
    cases = []
    for B in AGG_B:
        for C in AGG_C:
            for kind in AGG_KINDS:
                case = aggregate_case(np.random.default_rng(B + C), B, C,
                                      kind)
                args = [torch.as_tensor(a, device=dev) for a in case]
                cases.append((f"B={B} C={C} {kind}", (*args[:4], 0.2)))
                cases.append((f"B={B} C={C} {kind} per lane", tuple(args)))
    args = [torch.as_tensor(a, device=dev) for a in aggregate_case(
        np.random.default_rng(1), 1001, 10, "mixed")]
    args[1][~args[2]] = float("nan")
    cases.append(("row-offset view, NaN dead contrib",
                  tuple(a[1:] for a in args)))
    args = [torch.as_tensor(a, device=dev) for a in aggregate_case(
        np.random.default_rng(2), BIG_B, 10, "mixed")]
    cases.append((f"B={BIG_B}", tuple(args)))
    for what, args in cases:
        want = ref.grove_aggregate_ref(*args)
        for route in ga.ROUTES:
            aggregate_equal(f"grove_aggregate {route} {what}",
                            ga.grove_aggregate_on_route(*args, route=route),
                            want)
    return len(cases)


def aggregate_shares(pack: ForestPack, x: torch.Tensor,
                     start: torch.Tensor) -> dict:
    """The per-hop path's grove_aggregate inputs at the bench threshold, by
    live share: "all live" (hop 1: every lane live, the state zero), "hop
    2" (the state and lanes the plain loop leaves after hop 1, the second
    grove's contributions) and "none live" (the same with every lane
    dead)."""
    G = pack.n_groves
    thr = torch.full((x.shape[0],), THRESH, device=x.device)
    prob = torch.zeros((x.shape[0], pack.n_classes), device=x.device)
    live = torch.ones((x.shape[0],), dtype=torch.bool, device=x.device)
    hops = torch.zeros((x.shape[0],), dtype=torch.int32, device=x.device)
    first = (prob, pack.predict_proba(0, start.long() % G, x), live, hops,
             thr)
    prob, hops, live, _ = ref.grove_aggregate_ref(*first)
    second = pack.predict_proba(0, (start.long() + 1) % G, x)
    return {"all live": first, "hop 2": (prob, second, live, hops, thr),
            "none live": (prob, second, torch.zeros_like(live), hops, thr)}


def aggregate_work(args: tuple) -> dict:
    """The work of one hop update on ``args``: ``bytes`` prob read and
    written, contrib read for live lanes only, live, hops and thresh read
    and hops, live and margin written; ``ops`` an add per live entry and
    per entry a divide, two compares and the margin's share; ``working_set``
    the inputs' bytes, over which one dependent load is priced."""
    prob, _, live = args[:3]
    B, C = prob.shape
    n_live = int(live.sum())
    return {"live_lanes": n_live,
            "bytes": B * (2 * C * 4 + 2 * 1 + 4 * 4) + n_live * C * 4,
            "ops": B * 5 * C + n_live * C,
            "working_set": B * (2 * C * 4 + 1 + 4 + 4)}


def empty_launch(dev: torch.device):
    """A function that launches ``fog_empty`` once (not counted)."""
    lib = _build.library()

    def launch() -> None:
        rc = lib.fog_empty(torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"fog_empty launch failed: CUDA error {rc}")
    return launch


def aggregate_sweep(inputs: dict, lanes: tuple) -> list:
    """Device ms per launch (``profiled_ms``) of grove_aggregate's tile
    kernel at each of ``lanes`` a block (``None``: the plan's) and of the
    first kernel (the lane route, 256 lanes a block, as the engine runs
    it) on every ``(B, share) -> args`` of ``inputs``, each output checked
    bit for bit against the plain version.  Profiles, so no event timing
    may follow it."""
    rows = []
    for (nb, share), args in inputs.items():
        want = ref.grove_aggregate_ref(*args)
        for route, n in [("tile", n) for n in lanes] + [("lane", None)]:
            fn = lambda a=args, r=route, n=n: ga.grove_aggregate_on_route(
                *a, route=r, lanes=n, block_b=1024 if n else 256)
            aggregate_equal(f"sweep grove_aggregate {route} lanes={n} "
                            f"B={nb} {share}", fn(), want)
            ms = profiled_ms(fn, "grove_aggregate_tile" if route == "tile"
                             else "grove_aggregate")
            rows.append({"kernel": "grove_aggregate", "B": nb,
                         "share": share, "route": route, "lanes": n,
                         "device_ms": ms})
            print(f"[sweep] grove_aggregate B={nb} {share} {route} "
                  f"lanes={n}: {fmt(ms)} ms on the device")
    return rows


def bf16_ulp(scale: float) -> float:
    """One bf16 ulp at ``scale``'s binade (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(scale)) - 7) if scale > 0 else 0.0


def ssd_close(what: str, got: torch.Tensor, want: torch.Tensor,
              route: str = "simt") -> float:
    """Raise unless the kernel's output meets its route's bar against the
    plain version's; returns the max abs error.

    ``"simt"``, fp32: within 1e-4 of the output's largest magnitude (the
    sums run over up to 256 x 128 terms in another order); bf16: within 2
    bf16 ulps of the plain version's cast (rtol 2**-6), plus the same fp32
    allowance for values near a rounding boundary.

    ``"sm90"`` (bf16 on the tensor cores): within 2 bf16 ulps of the
    output's scale (its largest magnitude).  The kernel rounds W and the
    decay-scaled x to bf16 as its products' operands, where the plain
    version keeps fp32 until the one cast; y is a sum of up to 256 such
    terms, so an element where they cancel is off by more than 2 ulps of
    its own value.  The route's rounding replayed in PyTorch lies at most
    1 ulp of the scale from the plain version at full width, and nearer
    to a float64 oracle than JAX's bf16 einsum branch
    (tests/test_torch_ssd_chunk.py::test_sm90_rounding_replay_at_full_width):
    the bar is twice that."""
    g, w = got.float(), want.float()
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} vs "
                             f"{want.dtype} {tuple(want.shape)}")
    if not torch.isfinite(g).all():
        raise AssertionError(f"{what}: non-finite output")
    scale = float(w.abs().max())
    err = (g - w).abs()
    if route == "sm90":
        bad = int((err > 2.0 * bf16_ulp(scale)).sum())
    else:
        rtol = 0.0 if want.dtype == torch.float32 else 2.0**-6
        bad = int((err > 1e-4 * scale + rtol * w.abs()).sum())
    if bad:
        raise AssertionError(f"{what}: {bad} entries off, max abs err "
                             f"{float(err.max())} at scale {scale}")
    return float(err.max())


def ssd_inputs(rng, shape, dtype, dev) -> list:
    """Random x, a (negative log-decays), B, C for ssd_chunk."""
    B, nc, Q, H, P, N = shape
    arrays = (rng.normal(size=(B, nc, Q, H, P)),
              -rng.uniform(0.01, 0.5, size=(B, nc, H, Q)),
              rng.normal(size=(B, nc, Q, N)), rng.normal(size=(B, nc, Q, N)))
    return [torch.as_tensor(a.astype(np.float32), device=dev).to(dtype)
            for a in arrays]


def flash_close(what: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Raise unless the kernel's output meets its bar against the plain
    version's; returns the max abs error.  fp32: rtol/atol 2e-5 (the CPU
    tests' bar; the two are exact to ~1e-6).  bf16: within 2 bf16 ulps of
    the output's scale (its largest magnitude): the kernel rounds p to bf16
    against the running max before p.v, the plain version keeps p in fp32,
    and both round the output once."""
    g, w = got.float(), want.float()
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} vs "
                             f"{want.dtype} {tuple(want.shape)}")
    if not torch.isfinite(g).all():
        raise AssertionError(f"{what}: non-finite output")
    err = (g - w).abs()
    if want.dtype == torch.float32:
        bar = 2e-5 + 2e-5 * w.abs()
    else:
        scale = float(w.abs().max())
        bar = torch.full_like(w, 2.0 * 2.0**(np.floor(np.log2(scale)) - 7)
                              if scale > 0 else 0.0)
    bad = int((err > bar).sum())
    if bad:
        raise AssertionError(f"{what}: {bad} entries off, max abs err "
                             f"{float(err.max())} at scale "
                             f"{float(w.abs().max())}")
    return float(err.max())


def flash_inputs(rng, shape, dtype, dev) -> list:
    """Random q, k, v for flash_attention: shape (B, Sq, Sk, H, K, D, Dv)."""
    B, Sq, Sk, H, K, D, Dv = shape
    return [torch.as_tensor(rng.normal(size=sh).astype(np.float32),
                            device=dev).to(dtype)
            for sh in ((B, Sq, H, D), (B, Sk, K, D), (B, Sk, K, Dv))]


# the flash_attention checks on the card beyond layer 0's inputs:
# (label, (B, Sq, Sk, H, K, D, Dv), causal, dtype)
FLASH_CASES = (
    ("random bf16 at full width", (4, 2048, 2048, 32, 4, 64, 64), True,
     torch.bfloat16),
    ("Sq < Sk causal bf16", (2, 100, 300, 32, 4, 64, 64), True,
     torch.bfloat16),
    ("Sq > Sk causal bf16", (2, 300, 100, 32, 4, 64, 64), True,
     torch.bfloat16),
    ("D = Dv = 128, 64 query heads, 8 KV heads (chameleon's) bf16",
     (1, 1024, 1024, 64, 8, 128, 128), True, torch.bfloat16),
    ("random fp32 at full width", (4, 2048, 2048, 32, 4, 64, 64), True,
     torch.float32),
    ("ragged Sq = Sk = 200, fp32", (2, 200, 200, 32, 4, 64, 64), True,
     torch.float32),
    ("ragged Sq = Sk = 200, bf16", (2, 200, 200, 32, 4, 64, 64), True,
     torch.bfloat16),
    ("Sq < Sk causal", (2, 100, 300, 32, 4, 64, 64), True, torch.float32),
    ("Sq > Sk causal", (2, 300, 100, 32, 4, 64, 64), True, torch.float32),
    ("non-causal", (2, 256, 256, 32, 4, 64, 64), False, torch.float32),
    ("non-causal bf16", (2, 256, 256, 32, 4, 64, 64), False, torch.bfloat16),
    ("MQA (K = 1) bf16", (2, 256, 256, 32, 1, 64, 64), True, torch.bfloat16),
    ("D = 192, Dv = 128 (MLA's widths)", (1, 256, 256, 16, 16, 192, 128),
     True, torch.float32),
    ("D = Dv = 256 (the largest tiles)", (1, 130, 130, 4, 2, 256, 256), True,
     torch.float32))


# the SIMT forward (csrc/flash_attention.cu) at each tile boundary of
# flash_attention.fwd_tiles (max(D, Dv) 64 | 65, 128 | 129), G odd (a
# block's second unit empty), MQA, Sq != Sk both ways, non-causal:
# (label, (B, Sq, Sk, H, K, D, Dv), causal, dtypes); bf16 only where the
# tensor cores do not take the pair
SIMT_FLASH_CASES = (
    ("D = Dv = 32", (2, 200, 200, 8, 2, 32, 32), True,
     (torch.float32, torch.bfloat16)),
    ("D = Dv = 64", (2, 200, 200, 8, 2, 64, 64), True, (torch.float32,)),
    ("D = Dv = 65", (1, 130, 130, 6, 3, 65, 65), True,
     (torch.float32, torch.bfloat16)),
    ("D = Dv = 128", (1, 200, 200, 4, 2, 128, 128), True, (torch.float32,)),
    ("D = Dv = 129", (1, 100, 120, 4, 1, 129, 129), True,
     (torch.float32, torch.bfloat16)),
    ("D = Dv = 256", (1, 130, 130, 4, 2, 256, 256), True, (torch.float32,)),
    ("D = 48, Dv = 32 (MLA at smoke width)", (2, 64, 64, 4, 4, 48, 32), True,
     (torch.float32, torch.bfloat16)),
    ("G = 3 (an odd count of units)", (1, 150, 150, 6, 2, 64, 64), True,
     (torch.float32,)),
    ("Sq < Sk causal", (2, 100, 300, 8, 2, 64, 64), True, (torch.float32,)),
    ("Sq > Sk causal", (2, 300, 100, 8, 2, 64, 64), True, (torch.float32,)),
    ("non-causal", (2, 150, 170, 6, 2, 64, 64), False,
     (torch.float32,)),
    ("non-causal D = Dv = 32", (2, 150, 170, 6, 2, 32, 32), False,
     (torch.bfloat16,)),
    ("MQA (K = 1)", (2, 256, 256, 8, 1, 64, 64), True, (torch.float32,)))


def simt_flash_check(what: str, args, kw: dict) -> dict:
    """The SIMT forward twice with its lse (one launch each on the
    ``flash_attention`` route) against the plain version: the output
    within :func:`flash_close`'s bar, the lse within ``LSE_BAR`` of its
    magnitude (-inf where the plain version's is), the same bits on both
    runs."""
    before = dict(_build.routes)
    got, lse = fa.flash_attention_cuda(*args, with_lse=True, **kw)
    again, lse2 = fa.flash_attention_cuda(*args, with_lse=True, **kw)
    ran = {k: _build.routes[k] - before[k] for k in before
           if _build.routes[k] != before[k]}
    if ran != {"flash_attention": 2}:
        raise AssertionError(f"{what}: routes {ran}, want two launches of "
                             f"the SIMT kernel")
    if not (torch.equal(got, again) and torch.equal(lse, lse2)):
        raise AssertionError(f"{what}: another run gave other bits")
    want, want_lse = plain_flash_lse(*args, **kw)
    return {"out": flash_close(what, got, want),
            "lse": lse_close(what, lse, want_lse)}


def simt_flash_masked_row(dev: torch.device) -> dict:
    """The SIMT forward on a row whose every score is -inf (a q row of
    -inf against positive keys): the kernel's path for a row that sees no
    key, its output 0 and its lse -inf; the other rows against the plain
    version's (which gives NaN for that row: a softmax over no finite
    score)."""
    q, k, v = flash_inputs(np.random.default_rng(SEED),
                           (1, 130, 130, 4, 2, 64, 64), torch.float32, dev)
    k = k.abs()
    q[0, 5, 1] = -float("inf")
    out, lse = fa.flash_attention_cuda(q, k, v, with_lse=True)
    if out[0, 5, 1].abs().max() != 0 or lse[0, 1, 5] != -float("inf"):
        raise AssertionError(f"a row that sees no finite score: output "
                             f"{out[0, 5, 1]}, lse {lse[0, 1, 5]}")
    want, want_lse = plain_flash_lse(q, k, v)
    keep = torch.ones(out.shape[:3], dtype=torch.bool, device=dev)
    keep[0, 5, 1] = False
    return {"out": flash_close("flash_attention masked row", out[keep],
                               want[keep]),
            "lse": lse_close("flash_attention masked row", lse, want_lse)}


def simt_flash_checks(dev: torch.device, layer0: dict | None = None
                      ) -> dict:
    """The SIMT forward against its plain version (:func:`simt_flash_
    check`) on layer 0 of a train step (its captured q, k, v) and
    ``SIMT_FLASH_CASES``, and :func:`simt_flash_masked_row`."""
    rng = np.random.default_rng(SEED)
    errs = {}
    if layer0 is not None:
        errs["layer 0 of the step"] = simt_flash_check(
            "flash_attention layer 0", (layer0["q"], layer0["k"],
                                        layer0["v"]), layer0["kw"])
    for label, shape, causal, dtypes in SIMT_FLASH_CASES:
        for dtype in dtypes:
            name = f"{label} {list(shape)} {str(dtype)[6:]}"
            errs[name] = simt_flash_check(
                f"flash_attention {name}", flash_inputs(rng, shape, dtype, dev),
                {"causal": causal})
    errs["a row that sees no finite score"] = simt_flash_masked_row(dev)
    return errs


def simt(module, call, *args, **kw):
    """``call(*args, **kw)`` with ``module.route`` (``kernels.flash_attention``
    or ``kernels.ssd_chunk``) pointed at the SIMT kernel for this one call,
    to time that kernel beside the tensor-core one on the same bf16
    inputs."""
    real = module.route
    module.route = lambda *a: "simt"
    try:
        return call(*args, **kw)
    finally:
        module.route = real


# top2_confidence on the card beyond the main path's inputs: the LM gates'
# rows (blocks share a row, then the merge pass), one long row, and short
# rows (one thread per row)
TOP2_CASES = ((4, 32000), (4, 50280), (1, 50280), (4, 7), (1000, 10))


def top2_checks(dev: torch.device) -> dict:
    """top2_confidence == its plain version bit for bit on TOP2_CASES, with
    the maximum repeated in every fourth row (at columns 1 and C // 2, in
    different blocks of a long row) and the last row all equal; the blocks
    per row of each case's launch (0: one thread per row)."""
    rng = np.random.default_rng(SEED)
    out = {}
    for B, C in TOP2_CASES:
        p = torch.softmax(torch.as_tensor(
            rng.random((B, C), dtype=np.float32) * 8, device=dev), dim=-1)
        top = float(p.max()) + 1.0
        p[::4, 1] = top
        p[::4, C // 2] = top
        if B > 1:
            p[-1] = 1.0 / C
        got = ops.top2_confidence(p)
        check_equal(f"top2_confidence [{B}, {C}] with repeated maxima", got,
                    ref.top2_confidence_ref(p))
        if (got[::4] != 0).any():
            raise AssertionError(f"top2_confidence [{B}, {C}]: a repeated "
                                 "maximum gave a margin above 0")
        out[f"[{B}, {C}]"] = {"blocks_per_row": row_blocks(B, C)}
    return out


# the tensor-core kernels' template instances in the SASS, by mangled name
SM90_KERNELS = {
    "flash_attention_kernel_sm90": r"flash_attention_kernel_sm90ILi(\d+)ELi"
                                   r"(\d+)ELi(\d+)E",
    "flash_attention_bwd_sm90_dkdv": r"flash_attention_bwd_sm90_dkdvILi(\d+)"
                                     r"ELi(\d+)E",
    "flash_attention_bwd_sm90_dkdv_split": r"flash_attention_bwd_sm90_dkdv_"
                                           r"splitILi(\d+)ELi(\d+)E",
    "flash_attention_bwd_sm90_dq": r"flash_attention_bwd_sm90_dqILi(\d+)ELi"
                                   r"(\d+)E",
    "ssd_chunk_kernel_sm90": r"ssd_chunk_kernel_sm90ILi(\d+)E",
    "ssd_bwd_sm90": r"ssd_bwd_sm90_(ds|dx|dbdc)ILi(\d+)E"}
# the tensor-core attention kernels whose every instance must build
# without spills: the forward and the backward's passes
FLASH_SM90 = ("flash_attention_kernel_sm90", "flash_attention_bwd_sm90")


def hgmma_per_kernel(lib_path: Path) -> dict:
    """HGMMA (wgmma) instructions in the library's SASS per instance of
    each tensor-core kernel: flash_attention_kernel_sm90 by its (D, Dv,
    keys per tile), the backward's passes by (D, Dv),
    ssd_chunk_kernel_sm90 by its N."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, fn = {k: {} for k in SM90_KERNELS}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = None
            for kernel, pattern in SM90_KERNELS.items():
                m = re.search(pattern, line)
                if m:
                    fn = (kernel, "<{}>".format(", ".join(m.groups())))
                    counts[kernel][fn[1]] = 0
        elif fn and "HGMMA" in line:
            counts[fn[0]][fn[1]] += 1
    return counts


def ptxas_spills(log: str, kernel: str) -> dict:
    """Spill stores and loads ptxas reported (-Xptxas=-v) per instance of
    the kernel whose mangled name contains ``kernel``."""
    spills, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(_Z\w+)", line)
        if m:
            fn = m.group(1) if kernel in m.group(1) else None
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            spills[fn] = int(m.group(1)) + int(m.group(2))
    return spills


def ptxas_registers(log: str, kernel: str) -> dict:
    """Registers ptxas reported (-Xptxas=-v) per instance of the kernel
    whose mangled name contains ``kernel``."""
    regs, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(_Z\w+)", line)
        if m:
            fn = m.group(1) if kernel in m.group(1) else None
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            regs[fn] = int(m.group(1))
    return regs


def instance(mangled: str) -> str:
    """A readable name for an instance of the group or spread kernel:
    ``<table type[, smem|l1, accumulators]>``; ``<>`` for a kernel that is
    no template."""
    m = re.search(r"fog\d(Tab\w+?)E(?:Lb([01])ELi(\d+)E)?", mangled)
    if not m:
        return "<>"
    parts = [m.group(1)[3:]]
    if m.group(2):
        parts += ["smem" if m.group(2) == "1" else "l1", m.group(3)]
    return "<" + ", ".join(parts) + ">"


def ssd_bwd_instance(mangled: str) -> str:
    """A readable name for a kernel of the tensor-core SSD backward:
    ``<pass><N>`` (``cum``, ``da`` for its two untemplated kernels)."""
    m = re.search(r"ssd_bwd_sm90_(ds|dx|dbdc)ILi(\d+)E", mangled)
    if m:
        return f"{m.group(1)}<{m.group(2)}>"
    m = re.search(r"ssd_bwd_sm90_(\w+?)_kernel", mangled)
    return m.group(1) if m else mangled


def simt_bwd_instance(mangled: str) -> str:
    """A readable name for a kernel of the SIMT attention backward:
    ``<name><type, T, NC>``."""
    m = re.search(r"\dflash_attention_bwd_([a-z]+)_kernelI(f|13__nv_bfloat16)"
                  r"(?:Li(\d+)ELi(\d+)E)?", mangled)
    if not m:
        return mangled
    dtype = "fp32" if m.group(2) == "f" else "bf16"
    return m.group(1) + "<" + ", ".join(
        g for g in (dtype, m.group(3), m.group(4)) if g) + ">"


def simt_fwd_instance(mangled: str) -> str | None:
    """A readable name for an instance of the SIMT attention forward,
    ``fwd<type, RX, RY, NQ>`` (its register tiles), or None for any other
    kernel."""
    m = re.search(r"\dflash_attention_kernelI(f|13__nv_bfloat16)NS_5TilesILi"
                  r"(\d+)ELi(\d+)ELi(\d+)E", mangled)
    if not m:
        return None
    return (f"fwd<{'fp32' if m.group(1) == 'f' else 'bf16'}, {m.group(2)}, "
            f"{m.group(3)}, {m.group(4)}>")


def simt_ssd_instance(mangled: str) -> str | None:
    """A readable name for a kernel of the SIMT SSD forward or backward,
    ``<name><fp32|bf16>`` (``ssd_chunk_fwd<fp32>``, ``ssd_bwd_ds<bf16>``),
    or None for any other kernel."""
    m = re.search(r"\d(ssd_(?:chunk|bwd)_[a-z]+)_kernelI(f|13__nv_bfloat16)E",
                  mangled)
    if not m:
        return None
    return f"{m.group(1)}<{'fp32' if m.group(2) == 'f' else 'bf16'}>"


def flash_instance(mangled: str) -> str:
    """A readable name for an instance of a tensor-core attention kernel:
    ``<name><D, Dv[, keys]>`` (``delta`` for the backward's delta
    kernel)."""
    m = re.search(r"flash_attention_(?:kernel_sm90|bwd_sm90_(dkdv_split|dkdv"
                  r"|dq))ILi(\d+)ELi(\d+)E(?:Li(\d+)E)?", mangled)
    if not m:
        return "delta" if "delta" in mangled else mangled
    return (m.group(1) or "fwd") + "<" + ", ".join(
        g for g in m.groups()[1:] if g) + ">"


# the kernels this slice redesigned: each instance must build without
# spills; their device names in the profiler, and the first port's
NEW_KERNELS = {"fused_fog": "fused_fog_group_kernel",
               "tree_traverse": "tree_traverse_spread_kernel",
               "grove_aggregate": "grove_aggregate_tile_kernel"}
FUSED_ROUTES = ("fused_fog", "fused_fog_smem", "fused_fog_l1")
# the profiler's kernel name (``<name>_kernel``) of each timed call
DEVICE_NAME = {"fused_fog": "fused_fog_group", "fused_fog_was": "fused_fog",
               "tree_traverse": "tree_traverse_spread",
               "tree_traverse_was": "tree_traverse",
               "grove_aggregate": "grove_aggregate_tile",
               "grove_aggregate_was": "grove_aggregate"}
TRAVERSE_ROUTES = ("tree_traverse", "tree_traverse_spread")
AGG_ROUTES = ("grove_aggregate", "grove_aggregate_tile")


def ssd_route(args) -> str:
    """The C entry point ``kernels/ssd_chunk.py::route`` names for these
    inputs."""
    B, nc, Q, H, P = args[0].shape
    return {"sm90": "ssd_chunk_sm90", "simt": "ssd_chunk"}[ssd_chunk_route(
        args[0].dtype, Q, P, args[2].shape[-1])]


def ssd_kernel_checks(dev: torch.device, captured) -> tuple[dict, str]:
    """ssd_chunk against its plain version, each case on the route
    ``route`` names for it under that route's bar: layer 0's captured bf16
    inputs, random bf16 at full width and a ragged chunk on the tensor
    cores, random fp32 at full width, ragged and at the fp32 training
    shape on the SIMT kernel, each SIMT case run twice and bit-equal.  For
    a bf16 case also the distance from the route's rounding replayed in
    PyTorch, in bf16 ulps of the output's scale (reported, and held to 1
    ulp by tests/test_torch_cuda.py)."""
    args = captured[0][0]
    Bsz, nc, Q, H, P = args[0].shape
    full = (Bsz, nc, Q, H, P, args[2].shape[-1])
    rng = np.random.default_rng(SEED)
    cases = [("layer 0 of the prefill, bf16", args),
             (f"random bf16 {full}",
              ssd_inputs(rng, full, torch.bfloat16, dev)),
             (f"random bf16 ragged {SSD_RAGGED}",
              ssd_inputs(rng, SSD_RAGGED, torch.bfloat16, dev)),
             (f"random fp32 {full}",
              ssd_inputs(rng, full, torch.float32, dev)),
             (f"random fp32 ragged {SSD_RAGGED}",
              ssd_inputs(rng, SSD_RAGGED, torch.float32, dev)),
             (f"random fp32 {SSD_FP32_TRAIN}, the fp32 training shape",
              ssd_inputs(rng, SSD_FP32_TRAIN, torch.float32, dev))]
    errs = {}
    for label, a in cases:
        entry = ssd_route(a)
        before = dict(_build.routes)
        got = ops.ssd_chunk(*a)
        ran = {k: _build.routes[k] - before[k] for k in before}
        if ran != {k: int(k == entry) for k in ran}:
            raise AssertionError(f"ssd_chunk {label}: routes {ran}, want one "
                                 f"launch of {entry}")
        want = ssd_chunk_ref(*a)
        route = "sm90" if entry == "ssd_chunk_sm90" else "simt"
        if route == "simt":
            for n, g, g2 in zip(("y", "states"), got, ops.ssd_chunk(*a)):
                if not torch.equal(g, g2):
                    raise AssertionError(f"ssd_chunk {label}: {n} differs "
                                         f"from run to run")
        case = {n: ssd_close(f"ssd_chunk {label} {n} ({entry})", g, w, route)
                for n, g, w in zip(("y", "states"), got, want)}
        if route == "sm90":
            for n, g, rp in zip(("y", "states"), got,
                                ssd_chunk_sm90_replay(*a)):
                scale = float(rp.float().abs().max())
                case[f"{n}_ulps_from_replay"] = float(
                    (g.float() - rp.float()).abs().max()) / bf16_ulp(scale)
        errs[f"{label} ({entry})"] = case
        del got, want
    return errs, ("tensor cores (bf16): within 2 bf16 ulps of the output's "
                  "scale; SIMT fp32 within 1e-4 of the output's magnitude, "
                  "bit-equal run to run")


def flash_kernel_checks(dev: torch.device, captured) -> tuple[dict, str]:
    """flash_attention against its plain version on layer 0's captured
    inputs and on FLASH_CASES, each on the route ``route`` names for it
    (the SIMT cases by :func:`simt_flash_check`)."""
    rng = np.random.default_rng(SEED)
    errs = {}
    cases = [("layer 0 of the prefill, bf16", captured[0][0],
              captured[0][1]["causal"])]
    cases += [(f"{label} {list(shape)}", flash_inputs(rng, shape, dtype, dev),
               causal) for label, shape, causal, dtype in FLASH_CASES]
    for label, args, causal in cases:
        entry = {"sm90": "flash_attention_sm90", "simt": "flash_attention"}[
            flash_route(args[0].dtype, args[0].shape[3], args[2].shape[3])]
        if entry == "flash_attention":
            errs[f"{label} ({entry})"] = simt_flash_check(
                f"flash_attention {label}", args, {"causal": causal})
            continue
        before = dict(_build.routes)
        got = ops.flash_attention(*args, causal=causal)
        ran = {k: _build.routes[k] - before[k] for k in before}
        if ran != {k: int(k == entry) for k in ran}:
            raise AssertionError(f"flash_attention {label}: routes {ran}, "
                                 f"want one launch of {entry}")
        want = flash_attention_ref(*args, causal=causal)
        errs[f"{label} ({entry})"] = flash_close(f"flash_attention {label}",
                                                 got, want)
        del got, want
    return errs, ("fp32 within rtol/atol 2e-5; bf16 within 2 bf16 ulps of "
                  "the output's scale; the SIMT cases twice with their lse, "
                  "bit-equal, the lse within LSE_BAR of its magnitude")


def ssd_timing(t: dict, captured, fns: dict) -> str:
    """ssd_chunk's call and plain ms at the prefill's layer-0 inputs, and
    its bounds."""
    args = captured[0][0]
    Bsz, nc, Q, H, P = args[0].shape
    full = (Bsz, nc, Q, H, P, args[2].shape[-1])
    fns["ssd_chunk"] = lambda a=args: ops.ssd_chunk(*a)
    t["ssd_chunk_ms"] = cuda_ms(fns["ssd_chunk"])
    t["ssd_chunk_plain_ms"] = cuda_ms(lambda a=args: ssd_chunk_ref(*a),
                                      reps=5, warm=1)
    t["ssd_chunk_library_ms"] = None
    # the SIMT kernel (the fp32 route) on the same bf16 inputs, timed
    # beside the tensor-core kernel in one run
    fns["ssd_chunk_simt"] = lambda a=args: simt(ssd_mod, ops.ssd_chunk, *a)
    t["ssd_chunk_simt_ms"] = cuda_ms(fns["ssd_chunk_simt"], reps=5, warm=1)
    work = ssd_work(*full, args[0].element_size())
    t["ssd_chunk_work"] = work
    t["ssd_chunk_bytes_bound_ms"] = work["bytes"] / HBM_BYTES_PER_S * 1e3
    t["ssd_chunk_bf16_tensor_bound_ms"] = work["ops"] / BF16_OPS_PER_S * 1e3
    t["ssd_chunk_sm90_ops_bound_ms"] = (work["ops_sm90"] / BF16_OPS_PER_S
                                        * 1e3)
    t["ssd_chunk_fp32_core_bound_ms"] = (work["ops_full"] / FP32_OPS_PER_S
                                         * 1e3)
    t["ssd_chunk_bound_ms"], t["ssd_chunk_bound_by"] = bound_ms(
        work["bytes"], work["ops"], BF16_OPS_PER_S)
    t["ssd_chunk_design_bound_ms"], t["ssd_chunk_design_bound_by"] = (
        bound_ms(work["bytes"], work["ops_sm90"], BF16_OPS_PER_S))
    return (f"ssd_chunk {list(full)} bf16: {t['ssd_chunk_ms']:.4f} ms per "
            f"call (bound {t['ssd_chunk_bound_ms']:.4f} ms by "
            f"{t['ssd_chunk_bound_by']}: {work['bytes'] / 1e6:.1f} MB; "
            f"{work['ops'] / 1e9:.2f} GFLOP causal, "
            f"{t['ssd_chunk_bf16_tensor_bound_ms']:.4f} ms on the bf16 "
            f"tensor cores; the tensor-core design's "
            f"{work['ops_sm90'] / 1e9:.2f} GFLOP "
            f"{t['ssd_chunk_sm90_ops_bound_ms']:.4f} ms; "
            f"{work['ops_full'] / 1e9:.2f} GFLOP full, "
            f"{t['ssd_chunk_fp32_core_bound_ms']:.3f} ms at the fp32 CUDA-core "
            f"rate), plain {t['ssd_chunk_plain_ms']:.3f} ms, the SIMT kernel "
            f"{t['ssd_chunk_simt_ms']:.3f} ms")


def flash_timing(t: dict, captured, fns: dict) -> str:
    """flash_attention's call, plain and SDPA ms at the prefill's layer-0
    inputs, and its bounds.  SDPA (``enable_gqa``, causal: at Sq == Sk its
    bottom-right diagonal is the kernel's top-left one) is a yardstick the
    port never calls."""
    args, kw = captured[0]
    q, k, v = args
    Bsz, S, H, D = q.shape
    K, Dv = k.shape[2], v.shape[3]
    fns["flash_attention"] = lambda: ops.flash_attention(q, k, v, **kw)
    t["flash_attention_ms"] = cuda_ms(fns["flash_attention"])
    t["flash_attention_plain_ms"] = cuda_ms(
        lambda: flash_attention_ref(q, k, v, **kw), reps=5, warm=1)
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    t["flash_attention_library_ms"] = cuda_ms(sdpa)
    fns["sdpa"] = sdpa
    t["flash_attention_library_max_abs_diff"] = float(
        (sdpa().transpose(1, 2).float() - fns["flash_attention"]().float())
        .abs().max())
    # the SIMT kernel (the fp32 route) on the same bf16 inputs, timed
    # beside the tensor-core kernel in one run
    fns["flash_attention_simt"] = lambda: simt(fa, ops.flash_attention, q, k,
                                               v, **kw)
    t["flash_attention_simt_ms"] = cuda_ms(fns["flash_attention_simt"],
                                           reps=5, warm=1)
    work = flash_work(Bsz, S, S, H, K, D, Dv, q.element_size(), kw["causal"])
    t["flash_attention_work"] = work
    t["flash_attention_bytes_bound_ms"] = work["bytes"] / HBM_BYTES_PER_S * 1e3
    t["flash_attention_fp32_core_bound_ms"] = (work["ops"] / FP32_OPS_PER_S
                                               * 1e3)
    t["flash_attention_bound_ms"], t["flash_attention_bound_by"] = bound_ms(
        work["bytes"], work["ops"], BF16_OPS_PER_S)
    return (f"flash_attention [{Bsz}, {S}, {H}, {D}] / [{Bsz}, {S}, {K}, "
            f"{D}] bf16 causal: {t['flash_attention_ms']:.4f} ms per call "
            f"(bound {t['flash_attention_bound_ms']:.4f} ms by "
            f"{t['flash_attention_bound_by']}: {work['bytes'] / 1e6:.1f} MB, "
            f"{work['ops'] / 1e9:.2f} GFLOP over {work['pairs']:,} causal "
            f"pairs per head, {t['flash_attention_fp32_core_bound_ms']:.3f} "
            f"ms at the fp32 CUDA-core rate), plain "
            f"{t['flash_attention_plain_ms']:.3f} ms, the SIMT kernel "
            f"{t['flash_attention_simt_ms']:.3f} ms, SDPA "
            f"{t['flash_attention_library_ms']:.4f} ms (max abs diff from the "
            f"kernel {t['flash_attention_library_max_abs_diff']:.3g})")


# each LM path's prefill kernel: its checks and its timing
LM_KERNELS = {"ssd_chunk": (ssd_kernel_checks, ssd_timing),
              "flash_attention": (flash_kernel_checks, flash_timing)}


def describe(cfg) -> str:
    if cfg.ssm:
        return (f"{cfg.n_layers} layers, d_model {cfg.d_model}, "
                f"{cfg.ssm_heads} heads x {cfg.ssm_head_dim}, state "
                f"{cfg.ssm_state}, vocab {cfg.vocab_size}")
    return (f"{cfg.n_layers} layers, d_model {cfg.d_model}, "
            f"{cfg.n_heads} query heads and {cfg.n_kv_heads} KV heads of "
            f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
            f"{cfg.vocab_size}")


class GateSpy:
    """Within ``with``, keeps each ``ops.top2_confidence`` call's input and
    output (the wrapper itself still counts the launch)."""

    def __init__(self):
        self.calls, self.real = [], ops.top2_confidence

    def __call__(self, prob, **kw):
        margin = self.real(prob, **kw)
        self.calls.append((prob.clone(), margin.clone()))
        return margin

    def __enter__(self):
        ops.top2_confidence = self
        return self

    def __exit__(self, *exc):
        ops.top2_confidence = self.real


def gate_hops(margins: torch.Tensor, thresh: torch.Tensor,
              budget: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The hops ``decode_step_fog``'s gate gives from one step's margins
    ``[G-1, B]`` at each grove boundary, per-lane ``thresh`` and ``budget``;
    and per lane the live lanes' decisions to go on (``[0]``) and to exit
    on the margin (``[1]``)."""
    G, B = margins.shape[0] + 1, margins.shape[1]
    live = torch.ones(B, dtype=torch.bool)
    hops = torch.zeros(B, dtype=torch.int32)
    decided = torch.zeros((2, B), dtype=torch.int64)
    for g in range(G):
        hops += live.to(torch.int32)
        if g < G - 1:
            stay = margins[g] < thresh
            decided[0] += live & stay
            decided[1] += live & ~stay
            live = live & stay & (hops < budget)
    return hops, decided


def lm_gate_threshold(margins: torch.Tensor) -> float:
    """A threshold for one lane from its margins at the grove boundaries of
    one FoG step ``[G-1]``: halfway between the first boundary's and the
    largest later one's, so the lane goes on at the first boundary and
    exits at a later one when a later margin is larger, and exits at the
    first otherwise; the next steps' margins fall on either side."""
    m = margins.double()
    return float((m[0] + m[1:].max()) / 2)


def lm_phase(dev: torch.device, cfg=None, B: int = LM_B, S: int = LM_S,
             n_decode: int = LM_DECODE,
             consist: tuple = (CONSIST_B, CONSIST_S)) -> dict:
    """Phases 10 and 11: LM serving at full width and depth (prefill,
    greedy decode, FoG layer-grove decode) and its prefill's kernel
    (``ssd_chunk`` for a Mamba-2 config, ``flash_attention`` for an
    attention config).  Memory figures are above what the phase found
    allocated."""
    cfg = cfg or get_arch(LM_ARCH)
    kernel = "ssd_chunk" if cfg.ssm else "flash_attention"
    kernel_checks, kernel_timing = LM_KERNELS[kernel]
    G = len(grove_boundaries(cfg))
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                           torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    res = {"arch": cfg.name, "kernel": kernel, "n_params": n_params,
           "param_count": param_count(cfg)[0], "init_s": init_s,
           "weights_max_memory_allocated":
               torch.cuda.max_memory_allocated(dev) - base}
    print(f"[lm] {cfg.name}: {describe(cfg)}: {n_params:,} parameters "
          f"(param_count {res['param_count']:,}, which leaves out norms and "
          f"biases) in bf16 on the card in "
          f"{init_s:.1f} s; max_memory_allocated "
          f"{res['weights_max_memory_allocated'] / 1e9:.3f} GB")
    tokens = torch.as_tensor(batch_at_step(
        DataConfig(cfg.vocab_size, S, B, seed=SEED), 0)["tokens"],
        device=dev)
    prefill_fn, _ = make_prefill_step(cfg, dev, batch=B, seq_len=S,
                                      max_seq=S + n_decode)
    serve, _ = make_serve_step(cfg, dev, batch=B, max_seq=S + n_decode)
    fog, _ = make_serve_step(cfg, dev, batch=B, max_seq=S + n_decode,
                             fog=True, policy=FogPolicy(backend="pallas"))
    no_budget = torch.full((B,), NO_BUDGET, dtype=torch.int32, device=dev)
    budget = torch.full((B,), LM_BUDGET, dtype=torch.int32, device=dev)

    # lane LM_GATE_LANE's threshold, from its margins at the grove
    # boundaries of a first FoG step after a first prefill (before the
    # counts are zeroed)
    logits, cache = prefill_fn(params, tokens)
    with GateSpy() as cal:
        fog(params, cache, logits.argmax(-1).to(torch.int32), S,
            torch.full((B,), 2.0, dtype=torch.float32, device=dev), no_budget)
    del logits, cache
    lanes = torch.tensor([lm_gate_threshold(torch.stack(
        [m for _, m in cal.calls])[:, LM_GATE_LANE].cpu()) if t is None else t
        for t in LM_THRESH[:B]], dtype=torch.float32)
    thresh = lanes.to(dev)

    # the main path: prefill, greedy decode and FoG decode, counts zeroed
    # just before and read just after; layer 0's kernel inputs kept
    captured, real = [], getattr(ops, kernel)

    def spy(*args, **kw):
        if not captured:
            captured.append((tuple(a.clone() for a in args), kw))
        return real(*args, **kw)

    for k in ops.launches:
        ops.launches[k] = 0
    for k in _build.routes:
        _build.routes[k] = 0
    torch.cuda.reset_peak_memory_stats(dev)
    setattr(ops, kernel, spy)
    try:
        logits, cache = prefill_fn(params, tokens)
    finally:
        setattr(ops, kernel, real)
    torch.cuda.synchronize()
    prefill_launches = dict(ops.launches)
    res["prefill_routes"] = dict(_build.routes)
    res["prefill_max_memory_allocated"] = (
        torch.cuda.max_memory_allocated(dev) - base)

    def greedy(step, *knobs):
        tok, c = logits.argmax(-1).to(torch.int32), cache
        out, hops, gates = [], [], []
        for t in range(n_decode):
            before = ops.launches["top2_confidence"]
            r = step(params, c, tok, S + t, *knobs)
            gates.append(ops.launches["top2_confidence"] - before)
            out.append(r[0])
            c = r[1]
            if knobs:
                hops.append(r[2])
            tok = r[0].argmax(-1).to(torch.int32)
        return torch.stack(out), (torch.stack(hops) if hops else None), gates

    plain, _, _ = greedy(serve)
    with GateSpy() as gates:
        fog_logits, fog_hops, fog_gates = greedy(fog, thresh, no_budget)
        _, bud_hops, bud_gates = greedy(fog, thresh, budget)
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    res.update(prefill_launches=prefill_launches, launches=launches)
    print(f"[lm] main path (prefill B={B} x S={S}, {n_decode} greedy decode "
          f"steps, {n_decode} FoG steps at per-lane thresholds "
          f"{lanes.tolist()}, {n_decode} more under a hop budget of "
          f"{LM_BUDGET}): kernel launches {launches}; the prefill alone "
          f"{prefill_launches}, by route {res['prefill_routes']}; "
          f"max_memory_allocated in the prefill "
          f"{res['prefill_max_memory_allocated'] / 1e9:.3f} GB")
    want_prefill = {k: cfg.n_layers if k == kernel else 0
                    for k in prefill_launches}
    if prefill_launches != want_prefill or \
            launches[kernel] != cfg.n_layers:
        raise AssertionError(f"{kernel} launches: {prefill_launches} in a "
                             f"{cfg.n_layers}-layer prefill (want "
                             f"{want_prefill}), {launches} in the whole path")
    want_routes = {k: cfg.n_layers if k == f"{kernel}_sm90" else 0
                   for k in res["prefill_routes"]}
    if res["prefill_routes"] != want_routes:
        raise AssertionError(f"{kernel} routes in the prefill "
                             f"{res['prefill_routes']}: want all "
                             f"{cfg.n_layers} on the tensor cores "
                             f"({want_routes})")
    if any(n != G - 1 for n in fog_gates + bud_gates):
        raise AssertionError(f"top2_confidence launches per FoG step "
                             f"{fog_gates + bud_gates}, want {G - 1}")
    for what, t in (("prefill logits", logits), ("decode logits", plain),
                    ("FoG logits", fog_logits)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"{what} are not finite")
    if tuple(logits.shape) != (B, cfg.vocab_size):
        raise AssertionError(f"prefill logits {tuple(logits.shape)}")

    # the gate's kernel against its plain version on every input the main
    # path gave it, and the hops the plain version's margins give
    gate_err = max(check_close(f"top2_confidence at the LM gate {i}", m,
                               ref.top2_confidence_ref(p))
                   for i, (p, m) in enumerate(gates.calls))
    margins = torch.stack([m for _, m in gates.calls]).cpu().view(
        2, n_decode, G - 1, B)
    hops_cpu, bud_cpu = fog_hops.cpu(), bud_hops.cpu()
    decided = torch.zeros((2, B), dtype=torch.int64)
    for t in range(n_decode):
        for run, got, cap in ((0, hops_cpu, no_budget), (1, bud_cpu, budget)):
            want, d = gate_hops(margins[run, t], lanes, cap.cpu())
            if not torch.equal(got[t], want):
                raise AssertionError(
                    f"FoG step {t} hops {got[t].tolist()}, the plain "
                    f"version's margins {margins[run, t].tolist()} at "
                    f"thresholds {lanes.tolist()} give {want.tolist()}")
            if run == 0:
                decided += d
    if not (decided[:, LM_GATE_LANE] > 0).all():
        raise AssertionError(f"lane {LM_GATE_LANE} at threshold "
                             f"{float(lanes[LM_GATE_LANE])}: went on "
                             f"{int(decided[0, LM_GATE_LANE])} times and "
                             f"exited {int(decided[1, LM_GATE_LANE])} times "
                             "on its margin; the kernel decided nothing")
    never = lanes >= 1.0          # a margin never reaches 1
    if not ((hops_cpu[:, lanes == 0.0] == 1).all()
            and (hops_cpu[:, never] == G).all()
            and (hops_cpu >= 1).all() and (hops_cpu <= G).all()):
        raise AssertionError(f"FoG hops {hops_cpu.tolist()}")
    if not ((bud_cpu[:, lanes == 0.0] == 1).all()
            and (bud_cpu[:, never] == LM_BUDGET).all()
            and (bud_cpu <= LM_BUDGET).all()):
        raise AssertionError(f"FoG hops under a budget {bud_cpu.tolist()}")
    print(f"[lm] top2_confidence == its plain version on all "
          f"{len(gates.calls)} of the main path's gate inputs [{B}, "
          f"{cfg.vocab_size}] (max abs err {gate_err:.3g}); hops == the "
          f"plain version's margins through the gate at every step; lane "
          f"{LM_GATE_LANE} (threshold {float(lanes[LM_GATE_LANE]):.6g}, "
          f"set from its margins at a first step "
          f"{[float(m[LM_GATE_LANE]) for _, m in cal.calls]}) went on "
          f"{int(decided[0, LM_GATE_LANE])} times and exited "
          f"{int(decided[1, LM_GATE_LANE])} times on its margin; "
          f"margins seen: min {float(margins.min()):.4g}, max "
          f"{float(margins.max()):.4g}")
    del gates
    keep = never.to(dev)
    never_err = float((fog_logits[:, keep] - plain[:, keep]).abs().max())
    if not torch.allclose(fog_logits[:, keep], plain[:, keep], rtol=FOG_TOL,
                          atol=FOG_TOL):
        raise AssertionError(f"never-exit lanes' FoG logits differ from the "
                             f"plain decode's by {never_err}")
    mean_hops = float(hops_cpu.float().mean())
    res["fog"] = {
        "thresholds": lanes.tolist(),
        "gate_lane": LM_GATE_LANE,
        "gate_lane_decisions": {"went_on": int(decided[0, LM_GATE_LANE]),
                                "exited": int(decided[1, LM_GATE_LANE])},
        "top2_max_abs_err_vs_plain": gate_err,
        "margin_min": float(margins.min()),
        "margin_max": float(margins.max()),
        "hops_per_lane_mean": hops_cpu.float().mean(0).tolist(),
        "mean_groves_per_token": mean_hops,
        "fog_flops_per_token": fog_flops_per_token(cfg, mean_hops),
        "full_flops_per_token": fog_flops_per_token(cfg, float(G)),
        "budget": LM_BUDGET,
        "budget_mean_groves_per_token": float(bud_cpu.float().mean()),
        "top2_launches_per_step": G - 1,
        "never_exit_max_abs_err_vs_plain": never_err}
    f = res["fog"]
    print(f"[lm] FoG decode: hops per lane (mean of {n_decode} steps) "
          f"{[round(v, 3) for v in f['hops_per_lane_mean']]}; mean groves "
          f"per token {mean_hops:.4f} of {G}; fog_flops_per_token "
          f"{f['fog_flops_per_token']:.4g} (all groves "
          f"{f['full_flops_per_token']:.4g}); under the budget of "
          f"{LM_BUDGET}: {f['budget_mean_groves_per_token']:.4f} groves per "
          f"token; top2_confidence {G - 1} launches per step; never-exit "
          f"lanes == plain decode (max abs err {never_err:.3g})")

    # the kernel against its plain version, on the card
    errs, bar = kernel_checks(dev, captured)
    res[f"{kernel}_max_abs_err"] = errs
    print(f"[lm] {kernel} == its plain version on the card ({bar}): max abs "
          f"err {errs}")

    # decode after prefill == forward at full width, fp32 weights
    cb, cs = consist
    p32 = T.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 1),
                        torch.float32, device=dev)
    toks = torch.as_tensor(batch_at_step(
        DataConfig(cfg.vocab_size, cs, cb, seed=SEED), 1)["tokens"],
        device=dev)
    split = cs // 2
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    try:                  # fp32 products in fp32 for this check alone
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        with torch.no_grad():
            h, _ = T.forward(p32, cfg, toks)
            want = T.unembed(p32, cfg, h)
            lg, c = T.prefill(p32, cfg, tokens=toks[:, :split], max_seq=cs)
            pairs = [(lg, want[:, split - 1])]
            for t in range(split, cs):
                lg, c = T.decode_step(p32, cfg, toks[:, t], c, t)
                pairs.append((lg, want[:, t]))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    worst = max(float((a - b).abs().max()) for a, b in pairs)
    ok = all(torch.allclose(a, b, rtol=CONSIST_TOL, atol=CONSIST_TOL)
             for a, b in pairs)
    scale = float(want.abs().max())
    del p32, h, want, c, pairs
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"fp32 decode after prefill differs from the "
                             f"forward by {worst} (logit scale {scale})")
    res["consistency"] = {"batch": cb, "seq": cs, "max_abs_err": worst,
                          "logit_scale": scale, "tol": CONSIST_TOL}
    print(f"[lm] fp32, all {cfg.n_layers} layers, B={cb}, S={cs}: prefill "
          f"{split} + decode {cs - split} == forward at every position (max "
          f"abs err {worst:.3g} at logit scale {scale:.3g}; rtol/atol "
          f"{CONSIST_TOL})")

    # time with CUDA events (the profiler comes after every event timing)
    tok0 = logits.argmax(-1).to(torch.int32)
    exit_all = torch.zeros((B,), dtype=torch.float32, device=dev)
    probs = torch.softmax(logits, dim=-1)
    fns = {"prefill": lambda: prefill_fn(params, tokens),
           "decode": lambda: serve(params, cache, tok0, S),
           "fog": lambda: fog(params, cache, tok0, S, thresh, no_budget),
           "fog_all_exit": lambda: fog(params, cache, tok0, S, exit_all,
                                       no_budget),
           "top2_confidence": lambda: ops.top2_confidence(probs)}
    t = {"prefill_ms": cuda_ms(fns["prefill"], reps=5, warm=1)}
    t["prefill_tokens_per_s"] = B * S / t["prefill_ms"] * 1e3
    for k in ("decode", "fog", "fog_all_exit"):
        t[f"{k}_ms_per_step"] = cuda_ms(fns[k], reps=10, warm=2)
        t[f"{k}_tokens_per_s"] = B / t[f"{k}_ms_per_step"] * 1e3
    kernel_line = kernel_timing(t, captured, fns)
    V = cfg.vocab_size
    t["top2_confidence_ms"] = cuda_ms(fns["top2_confidence"])
    t["top2_confidence_plain_ms"] = cuda_ms(
        lambda: ref.top2_confidence_ref(probs))
    t["top2_confidence_library_ms"] = cuda_ms(
        lambda: torch.topk(probs, 2, dim=-1))
    t["top2_confidence_bound_ms"], t["top2_confidence_bound_by"] = bound_ms(
        B * (V + 1) * 4, B * 3 * V)
    res["timing"] = t
    print(f"[time] lm {cfg.name} prefill B={B} x S={S}: "
          f"{t['prefill_ms']:.2f} ms ({t['prefill_tokens_per_s']:.4g} "
          f"tokens/s); decode {t['decode_ms_per_step']:.2f} ms per step of "
          f"{B} tokens, FoG {t['fog_ms_per_step']:.2f} ms (every lane exits "
          f"after one grove: {t['fog_all_exit_ms_per_step']:.2f} ms)")
    print(f"[time] {kernel_line}; top2_confidence [{B}, {V}] "
          f"{t['top2_confidence_ms']:.4f} ms (bound "
          f"{t['top2_confidence_bound_ms']:.5f} ms), plain "
          f"{t['top2_confidence_plain_ms']:.4f} ms, torch.topk "
          f"{t['top2_confidence_library_ms']:.4f} ms")
    res["prof_fns"] = fns
    return res


def sdpa_backend(name: str) -> str:
    """Which of SDPA's backends a device kernel's name belongs to."""
    low = name.lower()
    if "cudnn" in low:
        return "cuDNN"
    if "flash" in low:
        return "flash"
    if "fmha" in low or "efficient" in low:
        return "memory-efficient"
    return "math"


def matmul_kernel(name: str) -> bool:
    """Whether a device kernel's name is one of cuBLAS's products (on
    Hopper cuBLAS names its own kernels ``nvjet_*``)."""
    return any(k in name.lower() for k in ("nvjet", "gemm", "xmma",
                                           "cutlass", "cublas", "gemv"))


def lm_profile(lm: dict) -> None:
    """Device times of an LM phase from torch.profiler: its prefill
    kernel's (ssd_chunk's kernels, or flash_attention's one) and the
    gate's top-2, and each step's busy and idle shares with the products'
    and the prefill kernel's parts of the busy time."""
    fns, t, kernel = lm.pop("prof_fns"), lm["timing"], lm["kernel"]
    busy, _, per_launch = retried_profile(fns[kernel], kernel)
    own = {k: v for k, v in per_launch.items() if kernel in k}
    t[f"{kernel}_device_ms"] = sum(own.values()) if own else None
    t[f"{kernel}_device_ms_by_kernel"] = own
    # the same from the records' sum over the calls: lower if records
    # were lost
    t[f"{kernel}_device_ms_from_busy"] = sum(v for k, v in busy.items()
                                             if kernel in k)
    t["top2_confidence_device_ms"] = kernel_ms(
        device_profile(fns["top2_confidence"])[2], "top2_confidence")
    if "sdpa" in fns:
        (t["flash_attention_library_device_ms"],
         t["flash_attention_library_backend"],
         t["flash_attention_library_kernels"]) = library_profile(fns["sdpa"])
    # the SIMT kernel on the same bf16 inputs (ssd_chunk's two launches)
    per_launch = retried_profile(fns[f"{kernel}_simt"], kernel)[2]
    t[f"{kernel}_simt_device_ms"] = sum(
        v for k, v in per_launch.items() if kernel in k) or None
    for k, reps in (("prefill", 1), ("decode", 2), ("fog", 2),
                    ("fog_all_exit", 2)):
        busy, wall, per_launch = device_profile(fns[k], reps=reps)
        total = sum(busy.values())
        t[f"{k}_profile"] = {
            "wall_ms": wall, "device_busy_ms": total,
            "device_idle_share": 1.0 - total / wall,
            "device_kernels": len(busy),
            f"{kernel}_ms": sum(v for n, v in busy.items() if kernel in n),
            f"{kernel}_ms_per_launch": sum(v for n, v in per_launch.items()
                                           if kernel in n),
            "matmul_ms": sum(v for n, v in busy.items() if matmul_kernel(n)),
            "top_device_ms": dict(sorted(busy.items(),
                                         key=lambda kv: -kv[1])[:8])}
    if "sdpa" in fns:
        print(f"[time] {lm['arch']}: SDPA on the device "
              f"{fmt(t['flash_attention_library_device_ms'])} ms per call "
              f"({t['flash_attention_library_backend']}: "
              f"{t['flash_attention_library_kernels']})")
    print(f"[time] {lm['arch']}: the SIMT {kernel} on the same bf16 inputs "
          f"{fmt(t[f'{kernel}_simt_device_ms'])} ms on the device")
    dev_ms = t[f"{kernel}_device_ms"]
    over = ("" if dev_ms is None
            else f", {dev_ms / t[f'{kernel}_bound_ms']:.1f}x its bound")
    if dev_ms is not None and f"{kernel}_design_bound_ms" in t:
        over += (f", {dev_ms / t[f'{kernel}_design_bound_ms']:.1f}x its "
                 f"design's")
    print(f"[time] {lm['arch']}: {kernel} on the device: {fmt(dev_ms)} ms per "
          f"call{over} (" + ", ".join(f"{k.split('(')[0]} {v:.4f}"
                                      for k, v in own.items())
          + f"); top2_confidence at the LM gate "
          f"{fmt(t['top2_confidence_device_ms'])} ms")
    for k in ("prefill", "decode", "fog", "fog_all_exit"):
        p = t[f"{k}_profile"]
        print(f"[time] lm {lm['arch']} {k} under the profiler: wall "
              f"{p['wall_ms']:.2f} ms, device busy {p['device_busy_ms']:.3f} "
              f"ms (products {p['matmul_ms']:.3f}, {kernel} "
              f"{p[f'{kernel}_ms']:.3f}), idle share "
              f"{p['device_idle_share']:.3f}, {p['device_kernels']} distinct "
              f"device kernels")


# ``--sweep``: the grid the rules in kernels/fused_fog.py,
# kernels/tree_traverse.py and kernels/grove_aggregate.py were chosen from
# -- the serving batch, two between, the big one; fused_fog's route x K
# (None: the rule's) x block_b; tree_traverse's route x lanes a block
# (None: the plan's); grove_aggregate's tile kernel at lanes a block
# (beside the first kernel) at its batches, each at the per-hop path's
# live shares.  ``--sweep grove_aggregate`` sweeps that kernel alone.
SWEEP_GRID = {
    "B": (1000, 4096, 16_384, BIG_B),
    "fused_fog": [("lane", None, 128)] + [
        (r, k, bb) for r in ("smem", "l1") for k in (1, 2, 4, 8)
        for bb in (128, 256, 1024)],
    "tree_traverse": [("lane", None)] + [
        ("spread", n) for n in (2, 3, 4, 7, 8, 16, 32, 128)]}
AGG_SWEEP = {"B": (1000, 16_384, BIG_B), "lanes": (32, 64, 128, 256)}
# every run: fused_fog's "smem" against "l1" at the rule's K and the
# engine's block, where fused_fog.route's copy-bytes line falls (the copies
# move 3.9 / 6.8 / 12.6 MB at B = 128, 7.7 / 13.3 / 24.6 MB at 1000 and
# 15.4 / 26.6 / 49.2 MB at 2000, int8 / bf16 / fp32)
BOUNDARY_GRID = {"B": (128, 1000, 2000),
                 "fused_fog": [("smem", None, FUSED_BLOCK_B),
                               ("l1", None, FUSED_BLOCK_B)],
                 "tree_traverse": []}


def bench_field(dev: torch.device) -> tuple:
    """The bench field: penbased, 16 trees of depth 8 split into 8 groves
    of 2, packed on the card at every precision; returns (dataset, the
    host grove collection, packs)."""
    ds = make_dataset("penbased")
    rf = train_random_forest(ds.x_train, ds.y_train, ds.n_classes,
                             TrainConfig(n_trees=16, max_depth=8, seed=1))
    gc = split(rf, 2)
    gc_card = GroveCollection(*(a.to(dev) for a in (
        gc.feature, gc.threshold, gc.leaf)))
    return ds, gc, {p: ForestPack.from_groves(gc_card, p) for p in PRECISIONS}


def sweep_phase(dev: torch.device, packs: dict, x0: torch.Tensor,
                grid: dict) -> list:
    """The device ms per launch (``torch.profiler``, ``profiled_ms``) of
    fused_fog and tree_traverse over ``grid``'s choices at the bench
    field, every precision, each output checked against the plain version
    (``torch.equal``); each fused_fog row also names the route the rule
    picks there.  Profiles, so no event timing may follow it."""
    G = packs["fp32"].n_groves
    gen = torch.Generator(device=dev)
    rows = []
    for nb in grid["B"]:
        xb = x0.repeat(-(-nb // x0.shape[0]), 1)[:nb].contiguous()
        sb = sample_starts(gen.manual_seed(SEED), nb, G)
        thr = torch.full((nb,), THRESH, device=dev)
        bud = torch.full((nb,), MAX_HOPS, dtype=torch.int32, device=dev)
        for p in PRECISIONS:
            lay = packs[p].layout("fused")
            args = (*lay[:3], xb, sb, thr, bud, *lay[3:])
            want = fused_fog_ref(*args, max_hops=MAX_HOPS)
            O, G, t = lay[0].shape[:3]
            for r, k, bb in grid["fused_fog"]:
                fn = lambda a=args, r=r, k=k, bb=bb: ff.fused_fog_on_route(
                    *a, max_hops=MAX_HOPS, block_b=bb, route=r,
                    hops_per_walk=k)
                got = fn()
                check_equal(f"sweep fused_fog {r} K={k} B={nb} {p} proba",
                            got[0], want[0])
                check_equal(f"sweep fused_fog {r} K={k} B={nb} {p} hops",
                            got[1], want[1])
                ms = profiled_ms(fn, "fused_fog" if r == "lane"
                                 else "fused_fog_group")
                rule = ff.route(nb, O, G, t, packs[p].depth,
                                packs[p].n_classes, xb.shape[1],
                                lay[1].element_size(), MAX_HOPS, bb,
                                _build.sm_count(dev), _build.smem_optin(dev))
                rows.append({"kernel": "fused_fog", "B": nb, "precision": p,
                             "route": r, "K": k, "block_b": bb,
                             "rule": rule, "device_ms": ms})
                print(f"[sweep] fused_fog B={nb} {p} {r} K={k} block_b={bb}:"
                      f" {fmt(ms)} ms on the device (the rule picks {rule})")
            if not grid["tree_traverse"]:
                continue
            stacked = ring_inputs(packs[p], xb, sb, RING_MESHES[0])
            want = ref.tree_traverse_ref(*stacked)
            S, b = stacked[3].shape[:2]
            for r, n in grid["tree_traverse"]:
                fn = lambda a=stacked, r=r, n=n: tt.tree_traverse_on_route(
                    *a, block_b=TRAVERSE_BLOCK_B, route=r, lanes=n)
                check_equal(f"sweep tree_traverse {r} lanes={n}", fn(), want)
                ms = profiled_ms(fn, "tree_traverse" if r == "lane"
                                 else "tree_traverse_spread")
                rows.append({"kernel": "tree_traverse", "B": nb,
                             "precision": p, "route": r, "lanes": n,
                             "device_ms": ms})
                print(f"[sweep] tree_traverse B={nb} [{S}, {b}] {p} {r} "
                      f"lanes={n}: {fmt(ms)} ms on the device")
    return rows


def route_boundary(rows: list) -> dict:
    """Per (B, precision) of a boundary sweep: fused_fog's device ms on
    "smem" and "l1", the rule's pick, and whether the pick was the faster
    (neither when the two lie within 3 % of each other)."""
    out = {}
    for r in rows:
        out.setdefault(f"B={r['B']} {r['precision']}", {"rule": r["rule"]})[
            r["route"]] = r["device_ms"]
    for row in out.values():
        sm, l1 = row.get("smem"), row.get("l1")
        if sm is None or l1 is None:
            row["faster"] = None
        elif abs(sm - l1) <= 0.03 * min(sm, l1):
            row["faster"] = "tie"
        else:
            row["faster"] = "smem" if sm < l1 else "l1"
    return out


# -- the serving plane (phase 12) ---------------------------------------------
# The registry plane at the setup of benchmarks/registry_bench.py, rebuilt
# here: the penbased field as benchmarks/common.py::forest_for trains it,
# three tenants at Zipf shares, QoS tiers, a hot-swap, a canary and a
# per-tenant governor ledger, 64 slots and 1500 requests of two tokens
SERVE_TREES, SERVE_DEPTH = 16, 9
TENANTS = (("alpha", 0.62), ("beta", 0.24), ("gamma", 0.14))
TIER_MIX = (("std", 0.60), ("gold", 0.20), ("bulk", 0.20))
BASE_THRESH, GOLD_THRESH, BULK_THRESH = 0.6, 0.9, 0.4
BUDGET_FACTOR = {"alpha": 1.6, "beta": 0.55, "gamma": 1.7}
SWAP_FRAC, CANARY_FRAC_AT, CANARY_FRACTION = 0.45, 0.70, 0.25
SERVE_SLOTS, SERVE_REQUESTS = 64, 1500
# the fixed arrival schedule: requests submitted before each step (the
# plane retires ~32 a step at two tokens each), so every mode serves the
# same schedule and sync and pipelined runs can be held bit-equal
ARRIVALS_PER_STEP = 24
# the fused plane: 1 replica x 1024 slots and 4 stream replicas x 256
FUSED_PLANES = ((1, 1024), (4, 256))
FUSED_REQUESTS = 32_768
# a checked run's requests after its warm batch (a whole number of
# 1024-slot waves, so every replica dispatches at every step)
FUSED_CHECKED = 4096
# the LM mode of the serve CLI at full width, fp32 as the JAX CLI makes it
LM_SERVE_ARGS = ["--arch", ATTN_ARCH, "--fog", "--fog-backend", "pallas",
                 "--requests", "8", "--slots", "4", "--max-seq", "160",
                 "--max-new", "16"]


def serve_field(dev: torch.device) -> dict:
    """The registry plane's field (host CART, 16 trees of depth 9, 8
    groves of 2) as a CPU pack, and the dataset."""
    ds = make_dataset("penbased")
    rf = train_random_forest(ds.x_train, ds.y_train, ds.n_classes,
                             TrainConfig(n_trees=SERVE_TREES,
                                         max_depth=SERVE_DEPTH, seed=0))
    return {"ds": ds, "pack": ForestPack.from_groves(split(rf, 2), "fp32"),
            "F": ds.x_test.shape[1]}


def request_mix(seed: int = SEED) -> tuple:
    """Per-request tenant, tier and beta-bulk draws (registry_bench's)."""
    rng = np.random.default_rng(seed)
    share = np.asarray([s for _, s in TENANTS])
    tiers = np.asarray([s for _, s in TIER_MIX])
    return (rng.choice(len(TENANTS), size=SERVE_REQUESTS, p=share / share.sum()),
            rng.choice([t for t, _ in TIER_MIX], size=SERVE_REQUESTS,
                       p=tiers / tiers.sum()),
            rng.random(SERVE_REQUESTS))


def make_request(field: dict, mix: tuple, rid: int) -> Request:
    tenants_of, tiers_of, beta_bulk = mix
    n = len(tenants_of)
    t = TENANTS[int(tenants_of[rid % n])][0]
    if t == "beta":
        # the squeezed tenant's traffic is governed lanes plus some bulk
        tier = "bulk" if beta_bulk[rid % n] < 0.1 else "std"
    else:
        tier = str(tiers_of[rid % n])
    pol = None
    if tier == "gold":
        pol = FogPolicy(threshold=GOLD_THRESH)
    elif tier == "bulk":
        pol = FogPolicy(threshold=BULK_THRESH, precision="int8")
    ds = field["ds"]
    return Request(rid=rid, prompt=ds.x_test[rid % len(ds.x_test)], model=t,
                   tier=tier, max_new_tokens=2, policy=pol)


def owed_lane(b: ContinuousBatcher, req: Request, default: FogPolicy,
              default_precision: str) -> tuple:
    """``(request, threshold, hop budget, precision)`` that one served lane
    is owed: the request's own policy, else its tenant's governor rung,
    else the step's default (the batcher's governor's rung when it has
    one).  An explicit policy without a budget means no budget; a precision
    left unset falls to the default's, then to the server's."""
    pol = req.policy
    if pol is None and b.ledger is not None:
        gov = b.ledger.governor_for(req.tenant)
        pol = None if gov is None else gov.current
    knobs = pol if pol is not None else default
    bud = knobs.hop_budget
    prec = pol.precision if pol is not None else None
    return (req, float(np.float32(knobs.threshold)),
            NO_BUDGET if bud is None else int(bud),
            prec or default.precision or default_precision)


def witness(b: ContinuousBatcher, default_precision: str) -> None:
    """Record on each packed dispatch, as ``b`` makes it, what each of its
    lanes is owed (:func:`owed_lane`), read from the batcher's slots and
    governors at that moment, for :func:`check_dispatches`."""
    disp = b.dispatcher
    inner = type(disp).dispatch_packed.__get__(disp)

    def dispatch_packed(lanes, *args, **kw):
        out = inner(lanes, *args, **kw)
        default = (b.governor.current if b.governor is not None
                   else b.default_policy)
        for p in out:
            p.owed = [owed_lane(b, b.slots[int(i)].request, default,
                                default_precision) for i in p.lanes]
        return out

    disp.dispatch_packed = dispatch_packed


def check_dispatches(pending: list, F: int) -> int:
    """Each packed dispatch recorded by :func:`witness` against what its
    lanes are owed: its registry bucket and pack precision are the
    requests', the knobs it resolved are the requests', its labels and
    hops equal ``_eval_core(..., "reference")`` on the requests' own rows,
    those knobs and the starts its replica drew, and its energy equals the
    model's price of its hops.  Returns the lanes checked."""
    n = 0
    for p in pending:
        start, thr, bud = p.inputs
        dev = start.device
        reqs, want_thr, want_bud, precs = zip(*p.owed)
        for r, prec in zip(reqs, precs):
            bucket = None if r.model is None else (r.model, r.version)
            if p.bucket != bucket or p.pack.precision != prec:
                raise AssertionError(
                    f"request {r.rid} served from {p.bucket} "
                    f"{p.pack.precision}, owed {bucket} {prec}")
        want_thr = torch.tensor(want_thr, dtype=torch.float32, device=dev)
        want_bud = torch.tensor(want_bud, dtype=torch.int32, device=dev)
        loc = torch.as_tensor(p.local)
        check_equal("resolved thresholds vs the requests'",
                    thr[loc.to(dev)], want_thr)
        check_equal("resolved budgets vs the requests'",
                    bud[loc.to(dev)], want_bud)
        xs = torch.as_tensor(np.stack([r.prompt for r in reqs]),
                             dtype=torch.float32, device=dev)
        res = _eval_core(p.pack, xs, start[loc.to(dev)], want_thr, want_bud,
                         p.pack.n_groves, "reference", DEFAULT_BLOCK_B, False)
        check_equal("served labels vs reference", p.nxt[loc], res.label)
        check_equal("served hops vs reference", p.hops[loc], res.hops)
        price = EnergyModel.from_pack(p.pack, F).lane_pj(p.hops[loc])
        check_equal("served energy vs lane_pj", p.energy[loc], price)
        n += len(p.local)
    return n


def checker(b: ContinuousBatcher, F: int):
    """A function that holds the dispatches ``b`` harvested since its last
    call to what their lanes are owed (:func:`check_dispatches`) and
    returns the lanes it checked."""
    seen = b.last_dispatches

    def harvested() -> int:
        nonlocal seen
        if b.last_dispatches is seen:
            return 0
        seen = b.last_dispatches
        return check_dispatches(seen, F)

    return harvested


def lane_draws(n_slots: int, seed: int = 5):
    """``draw_starts`` that gives every GLOBAL lane the same start whatever
    the replica count: the span's slice of one seeded draw per step."""
    def draw(index, step, span, n_groves):
        rng = np.random.default_rng(seed * 1_000_003 + step)
        full = rng.integers(0, n_groves, n_slots).astype(np.int32)
        return full[index * span:(index + 1) * span]
    return draw


def registry_setup(dev: torch.device, field: dict, root: Path, *,
                   backend: str = "fused") -> dict:
    """The registry plane before its measured run: three tenants published,
    the byte-budgeted cache, one packed replica, and a calibration run
    (six waves of the slots, synchronous) whose completions size each
    tenant's ledger budget from its measured mixed-traffic rung-0 cost."""
    shutil.rmtree(root, ignore_errors=True)
    pack, F = field["pack"], field["F"]
    registry = ModelRegistry(root)
    extra = {"n_features_in": F}
    for t, _ in TENANTS:
        registry.publish(t, pack, extra=extra)
    budget_bytes = 4 * pack.table_bytes + 3 * pack.astype("int8").table_bytes
    cache = PackCache(registry, budget_bytes=budget_bytes)
    server = ForestReplicaServer(None, F, backend=backend, registry=registry,
                                 cache=cache, seed=SEED)
    dispatcher = DeviceDispatcher(server.packed_factory, [dev])
    base = FogPolicy(threshold=BASE_THRESH)
    mix = request_mix()
    cal = ContinuousBatcher(SERVE_SLOTS, None, server.prefill, eos_id=-1,
                            default_policy=base, dispatcher=dispatcher,
                            registry=registry)
    for rid in range(6 * SERVE_SLOTS):
        cal.submit(make_request(field, mix, rid))
    cal.run()
    ledger = TenantLedger()
    budgets = {}
    for t, _ in TENANTS:
        m32 = server.energy_model(tenant=t)
        m8 = server.energy_model("int8", tenant=t)
        done = [r for r in cal.completed if r.model == t]
        pj = np.concatenate([
            np.asarray(m32.lane_pj(np.asarray(
                [r.hops[0] for r in done if r.tier != "bulk"]))),
            np.asarray(m8.lane_pj(np.asarray(
                [r.hops[0] for r in done if r.tier == "bulk"])))])
        budgets[t] = BUDGET_FACTOR[t] * float(pj.mean()) * 1e-3
        ledger.add(t, EnergyGovernor(default_ladder(base, m32, budgets[t]),
                                     budgets[t], model=m32, window=128,
                                     patience=2, cooldown=10**9))
        registry.stats_for(t, 1).reset()
    cache.stats.reset()
    return {"field": field, "pack": pack, "extra": extra,
            "registry": registry, "cache": cache, "server": server,
            "dispatcher": dispatcher, "base": base, "mix": mix,
            "ledger": ledger, "budgets": budgets,
            "budget_bytes": budget_bytes}


def registry_serve(ctx: dict, *, pipeline: bool,
                   checked: bool = False) -> dict:
    """The registry plane's measured run: SERVE_REQUESTS on the fixed
    schedule (ARRIVALS_PER_STEP before each step), a hot-swap of alpha at
    SWAP_FRAC and an int8 canary on beta from CANARY_FRAC_AT.  ``checked``
    holds every dispatch to what its lanes are owed
    (:func:`check_dispatches`)."""
    field, pack, extra = ctx["field"], ctx["pack"], ctx["extra"]
    registry, cache, ledger = ctx["registry"], ctx["cache"], ctx["ledger"]
    F = field["F"]
    b = ContinuousBatcher(SERVE_SLOTS, None, ctx["server"].prefill,
                          eos_id=-1, default_policy=ctx["base"],
                          governor=ledger, dispatcher=ctx["dispatcher"],
                          registry=registry, pipeline=pipeline)
    if checked:
        witness(b, ctx["server"].default_precision)
    swap_at = int(SWAP_FRAC * SERVE_REQUESTS)
    canary_at = int(CANARY_FRAC_AT * SERVE_REQUESTS)
    rid, inflight, n_checked = 0, [], 0
    dispatches0 = ctx["dispatcher"].n_dispatches
    harvested = checker(b, F) if checked else (lambda: 0)

    t0 = time.perf_counter()
    while rid < SERVE_REQUESTS or b.active or b.queue:
        for _ in range(ARRIVALS_PER_STEP):
            if rid >= SERVE_REQUESTS:
                break
            if rid in (swap_at, canary_at):
                # the control plane acts between harvests: a pipelined
                # step's dispatch is drained first, so both modes publish
                # (and reset beta's live telemetry) at the same point
                b.flush()
            if rid == swap_at:
                # control plane: the hot tenant's retrain-and-publish; in
                # flight or queued alpha requests keep their pinned version
                inflight = [s.request.rid for s in b.slots
                            if s.request is not None
                            and s.request.model == "alpha"]
                registry.publish("alpha", pack, extra=extra)
            if rid == canary_at:
                registry.stats_for("beta",
                                   registry.live_version("beta")).reset()
                registry.publish("beta", pack.astype("int8"), extra=extra,
                                 canary=CANARY_FRACTION)
            b.submit(make_request(field, ctx["mix"], rid))
            rid += 1
        b.step()
        n_checked += harvested()
    b.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_checked += harvested()
    done = {r.rid: r for r in b.completed}
    lat = np.asarray([(r.t_done - r.t_submit) * 1e3 for r in b.completed])
    judge = registry.judge_canary("beta")
    beta_post = [r for r in b.completed
                 if r.model == "beta" and r.rid >= canary_at]
    govs = {t: ledger.governor_for(t) for t, _ in TENANTS}
    return {
        "completed": len(b.completed), "shed": len(b.shed_requests),
        "served": {r.rid: (r.version, tuple(r.generated), tuple(r.hops))
                   for r in b.completed},
        "inflight_at_swap": inflight,
        "inflight_kept_v1": sum(1 for i in inflight
                                if i in done and done[i].version == 1),
        "transitions": {t: list(g.transitions) for t, g in govs.items()},
        "rung_precision": {t: g.current.precision for t, g in govs.items()},
        "rolling_nj": {t: g.rolling_nj for t, g in govs.items()},
        "budgets_nj": ctx["budgets"],
        "total_pj": b.stats.total_pj, "tiers": b.stats.tier_summary(),
        "versions": {f"{t} v{v}": (registry.stats_for(t, v).n_events,
                                   registry.stats_for(t, v).total_hops,
                                   registry.stats_for(t, v).total_pj)
                     for t, _ in TENANTS for v in registry.versions(t)},
        "canary_observed_fraction": len([
            r for r in beta_post if r.version == judge["canary_version"]])
        / max(1, len(beta_post)),
        "canary_delta_nj": judge["delta_nj"],
        "wall_s": wall, "requests_per_s": len(b.completed) / wall,
        "p50_ms": float(np.percentile(lat, 50)),
        "p99_ms": float(np.percentile(lat, 99)),
        "steps": b.n_steps,
        "dispatches": ctx["dispatcher"].n_dispatches - dispatches0,
        "host_ms_per_step": {k: v / 1e6 / b.n_steps
                             for k, v in b.phase_ns.items()},
        "cache": {"hits": cache.stats.hits, "misses": cache.stats.misses,
                  "evictions": cache.stats.evictions,
                  "peak_bytes": cache.peak_bytes,
                  "budget_bytes": ctx["budget_bytes"]},
        "checked_lanes": n_checked,
    }


def registry_plane(dev: torch.device, field: dict, root: Path, *,
                   pipeline: bool, checked: bool = False,
                   backend: str = "fused", counted: bool = False) -> dict:
    """:func:`registry_setup` then :func:`registry_serve`; with
    ``counted`` the launch and route counts are zeroed just before the
    measured run and read just after."""
    ctx = registry_setup(dev, field, root, backend=backend)
    if counted:
        zero_counts()
    out = registry_serve(ctx, pipeline=pipeline, checked=checked)
    if counted:
        out["launches"], out["routes"] = read_counts()
    return out


def zero_counts() -> None:
    torch.cuda.synchronize()
    for k in ops.launches:
        ops.launches[k] = 0
    for k in _build.routes:
        _build.routes[k] = 0


def read_counts() -> tuple[dict, dict]:
    torch.cuda.synchronize()
    return ({k: v for k, v in ops.launches.items() if v},
            {k: v for k, v in _build.routes.items() if v})


SERVED_KEYS = ("served", "transitions", "rung_precision", "total_pj",
               "tiers", "versions", "inflight_at_swap", "shed")


def same_serving(what: str, a: dict, b: dict,
                 keys: tuple = SERVED_KEYS) -> None:
    for k in keys:
        if a[k] != b[k]:
            raise AssertionError(f"{what}: {k} differs")


def fused_plane(dev: torch.device, pack: ForestPack, x: np.ndarray,
                replicas: int, span: int, pipeline: bool,
                n: int = FUSED_REQUESTS, checked: bool = False) -> dict:
    """The fused plane: ``replicas`` packed replicas of ``span`` slots on
    one card (one CUDA stream each), every request one token, all queued
    up front.  A warm batch first, then ``n`` requests timed, the launch
    counts zeroed just before them and read just after.  ``checked`` draws
    every global lane's start from :func:`lane_draws`, so layouts can be
    held to each other, and holds every dispatch to what its lanes are
    owed (:func:`check_dispatches`)."""
    n_slots, F = replicas * span, x.shape[1]
    server = ForestReplicaServer(
        pack, F, precisions=(pack.precision,), seed=SEED,
        draw_starts=lane_draws(n_slots) if checked else None)
    disp = DeviceDispatcher(server.packed_factory, [dev] * replicas)
    b = ContinuousBatcher(n_slots, None, server.prefill, eos_id=-1,
                          default_policy=FogPolicy(threshold=BASE_THRESH),
                          dispatcher=disp, pipeline=pipeline)
    n_checked = 0
    if checked:
        witness(b, server.default_precision)
        harvested = checker(b, F)

    def serve(count: int, first: int = 0) -> float:
        nonlocal n_checked
        for rid in range(first, first + count):
            b.submit(Request(rid=rid, prompt=x[rid % len(x)],
                             max_new_tokens=1))
        t0 = time.perf_counter()
        if checked:
            while b.queue or b.active:
                b.step()
                n_checked += harvested()
            b.flush()
            n_checked += harvested()
        else:
            b.run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    serve(n_slots)
    for k in b.phase_ns:
        b.phase_ns[k] = 0
    b.n_steps = 0
    d0 = disp.n_dispatches
    zero_counts()
    wall = serve(n, n_slots)
    launches, routes = read_counts()
    done = b.completed[n_slots:]
    lat = np.asarray([(r.t_done - r.t_submit) * 1e3 for r in done])
    return {"replicas": replicas, "span": span, "pipeline": pipeline,
            "precision": pack.precision, "requests": n, "wall_s": wall,
            "requests_per_s": n / wall, "steps": b.n_steps,
            "dispatches": disp.n_dispatches - d0, "launches": launches,
            "routes": routes, "checked_lanes": n_checked,
            "p99_ms": float(np.percentile(lat, 99)),
            "host_ms_per_step": {k: v / 1e6 / b.n_steps
                                 for k, v in b.phase_ns.items()},
            "served": {r.rid: (r.generated[0], r.hops[0])
                       for r in b.completed},
            "batcher": b, "serve": serve}


# the PyTorch op a device kernel of the serving path runs, by a piece of
# its name
KERNEL_OPS = (("random_from_to", "randint"), ("where_kernel", "where"),
              ("MulFunctor", "mul"), ("index_copy", "index_copy_"),
              ("ArgMax", "argmax"), ("clamp", "clamp"), ("CompareEq", "eq"),
              ("CUDAFunctorOnSelf_add", "add"), ("CUDAFunctor_add", "add"),
              ("compare_scalar", "compare"), ("direct_copy", "copy (cast)"))


def kernel_label(name: str) -> str:
    """A device kernel's name without its signature: this repo's kernels
    with their template arguments, PyTorch's as the op they run."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for piece, op in KERNEL_OPS:
        if piece in name:
            return f"torch {op}"
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return name.split(" (")[0]
    return name.split("(")[0]


def serving_profile(fn, n_dispatch_fn) -> dict:
    """``fn`` (one serving run) under ``torch.profiler``: wall ms, the
    device's busy ms as the union of its kernel and copy intervals over
    every stream, the idle share, device launches per dispatch by kernel
    name, the fused_fog kernel's device ms per launch, and the host's
    top-level PyTorch ops per dispatch by name.  ``n_dispatch_fn()`` gives
    the dispatches the run made."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    n = max(1, n_dispatch_fn())
    spans, kernels, fused_us, host_ops = [], {}, [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            if "Memcpy" not in e.name and "Memset" not in e.name:
                k = kernel_label(e.name)
                kernels[k] = kernels.get(k, 0) + 1
            if "fused_fog" in e.name:
                fused_us.append(e.time_range.elapsed_us())
        elif e.cpu_parent is None and e.name.startswith("aten::"):
            host_ops[e.name] = host_ops.get(e.name, 0) + 1
    busy, end = 0.0, -1.0
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    busy_ms = busy / 1e3
    return {"wall_ms": wall, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall,
            "dispatches": n,
            "launches_per_dispatch": {k: v / n for k, v in sorted(
                kernels.items())},
            "fused_fog_device_ms": (statistics.mean(fused_us) / 1e3
                                    if fused_us else None),
            "host_ops_per_dispatch": {k: v / n for k, v in sorted(
                host_ops.items(), key=lambda kv: -kv[1])}}


def lm_serve(dev: torch.device) -> dict:
    """The serve CLI's LM mode at full width (tinyllama-1.1b, fp32 weights
    as JAX's CLI makes them, FoG with the top-2 kernel), launch counts
    zeroed just before and read just after; then each request's first
    token against the argmax of ``forward`` on its prompt and last token
    (the batcher feeds a prompt's last token again at its first decode
    step, as JAX's does), whose logits must agree with the prefill +
    ``decode_step_fog`` path within CONSIST_TOL.  The gate at 0.3 never
    fires on random weights, so a first token is the whole model's."""
    zero_counts()
    out = serve_main(LM_SERVE_ARGS)
    launches, routes = read_counts()
    done, params, cfg = out["done"], out["params"], out["cfg"]
    G = out["n_groves"]
    if len(done) != 8 or any(len(r.generated) != 16 for r in done):
        raise AssertionError(f"LM serve: {len(done)} of 8 requests done")
    worst = 0.0
    for r in done:
        seq = torch.as_tensor(np.append(r.prompt, r.prompt[-1]),
                              device=dev)[None]
        with torch.no_grad():
            h, _ = T.forward(params, cfg, tokens=seq)
            want = T.unembed(params, cfg, h[:, -1]).float()
            _, c = T.prefill(params, cfg, tokens=seq[:, :-1],
                             max_seq=seq.shape[1])
            got, _, hops = decode_step_fog(
                params, cfg, seq[:, -1], c, seq.shape[1] - 1,
                FogPolicy(threshold=0.3, backend="pallas"))
        if r.hops[0] != G or int(hops[0]) != G:
            raise AssertionError(f"LM serve: request {r.rid} exited after "
                                 f"{r.hops[0]} of {G} groves at its first "
                                 "token")
        if not torch.allclose(got.float(), want, rtol=CONSIST_TOL,
                              atol=CONSIST_TOL):
            raise AssertionError(f"LM serve: request {r.rid}'s decode "
                                 "logits differ from forward's")
        worst = max(worst, float((got.float() - want).abs().max()))
        if r.generated[0] != int(torch.argmax(want, dim=-1)[0]):
            raise AssertionError(f"LM serve: request {r.rid}'s first token "
                                 f"{r.generated[0]} is not forward's argmax")
    hops = np.asarray([h for r in done for h in r.hops], np.float64)
    return {"arch": cfg.name, "requests": len(done), "tokens": out["tokens"],
            "seconds": out["seconds"],
            "tokens_per_s": out["tokens"] / out["seconds"],
            "groves_per_token": float(hops.mean()), "n_groves": G,
            "launches": launches, "routes": routes,
            "first_token_max_abs_err_vs_forward": worst}


def serve_phase(dev: torch.device) -> dict:
    """Phase 12: the serving plane on the card (see the module
    docstring's item 12); event timings only — ``serve_profile`` adds the
    profiler's figures after every event timing."""
    field = serve_field(dev)
    root = ROOT / "build" / "serve_registry"
    res: dict = {}
    # the registry plane: checked runs, then the timed main path with the
    # launch counts zeroed just before and read just after
    checks = {m: registry_plane(dev, field, root / f"check-{m}",
                                pipeline=m == "pipelined", checked=True)
              for m in ("sync", "pipelined")}
    same_serving("registry plane sync vs pipelined", checks["sync"],
                 checks["pipelined"])
    runs = {}
    for m in ("sync", "pipelined"):
        runs[m] = registry_plane(dev, field, root / m,
                                 pipeline=m == "pipelined", counted=True)
        same_serving(f"registry plane {m} vs its checked run", runs[m],
                     checks[m])
    pallas = registry_plane(dev, field, root / "pallas", pipeline=False,
                            backend="pallas", counted=True)
    same_serving("registry plane fused vs pallas backend", pallas,
                 runs["sync"], ("served", "transitions", "versions"))
    if pallas["launches"].get("grove_aggregate") != (
            MAX_HOPS * pallas["dispatches"]) or "fused_fog" in pallas[
                "launches"]:
        raise AssertionError(f"registry plane, backend pallas: launches "
                             f"{pallas['launches']} over "
                             f"{pallas['dispatches']} dispatches, want "
                             f"{MAX_HOPS} grove_aggregate a dispatch")
    for m, r in runs.items():
        if r["completed"] != SERVE_REQUESTS or r["shed"]:
            raise AssertionError(f"registry plane {m}: {r['completed']} of "
                                 f"{SERVE_REQUESTS} completed, {r['shed']} "
                                 "shed")
        if r["inflight_kept_v1"] != len(r["inflight_at_swap"]):
            raise AssertionError(f"registry plane {m}: the hot-swap moved "
                                 "in-flight requests off v1")
        if not r["transitions"]["beta"]:
            raise AssertionError(f"registry plane {m}: beta's governor "
                                 "never stepped down")
        if r["launches"] != {"fused_fog": r["dispatches"]}:
            raise AssertionError(f"registry plane {m}: launches "
                                 f"{r['launches']} over {r['dispatches']} "
                                 "dispatches, want one fused_fog each")
    res["registry"] = {m: {k: v for k, v in r.items() if k != "served"}
                       for m, r in runs.items()}
    res["registry_checked_lanes"] = {m: r["checked_lanes"]
                                     for m, r in checks.items()}
    res["registry_pallas"] = {k: pallas[k] for k in (
        "launches", "routes", "dispatches", "requests_per_s", "p99_ms")}
    for m, r in runs.items():
        print(f"[serve] registry plane {m}: {r['completed']}/"
              f"{SERVE_REQUESTS} requests, {r['requests_per_s']:.1f} "
              f"requests/s, completion p50 {r['p50_ms']:.3f} / p99 "
              f"{r['p99_ms']:.3f} ms, {r['steps']} steps, host ms per step "
              + ", ".join(f"{k} {v:.4f}"
                          for k, v in r["host_ms_per_step"].items())
              + f"; launches {r['launches']} by route {r['routes']}; cache "
              f"{r['cache']}; swap: {len(r['inflight_at_swap'])} alpha in "
              f"flight, all done on v1; beta governor {len(r['transitions']['beta'])} "
              f"transitions, settled at {r['rung_precision']['beta'] or 'fp32'} "
              f"(budget {r['budgets_nj']['beta']:.4f} nJ, rolling "
              f"{r['rolling_nj']['beta']:.4f}); canary split "
              f"{r['canary_observed_fraction']:.3f} of {CANARY_FRACTION}")
    print(f"[serve] registry plane: sync == pipelined (labels, hops, energy "
          f"bit for bit, shed set, governor transitions, pinned versions); "
          f"every served lane == _eval_core reference on its request's row, "
          f"bucket, precision and owed knobs and the drawn start "
          f"({res['registry_checked_lanes']} lanes); "
          f"backend pallas == fused")
    # the fused plane at 1024 slots: per precision, checked runs of each
    # layout and mode held to what their lanes are owed and, on the same
    # start draws, to each other; then the timed runs, one fused_fog a
    # dispatch, sync held to pipelined
    res["fused"], res["fused_checked_lanes"] = [], {}
    fused_runs = {}
    x = field["ds"].x_test
    for prec in ("fp32", "int8"):
        pack = field["pack"].astype(prec).to(dev)
        want = None
        for replicas, span in FUSED_PLANES:
            for pipe in (False, True):
                r = fused_plane(dev, pack, x, replicas, span, pipe,
                                n=FUSED_CHECKED, checked=True)
                tag = f"{replicas}x{span} {prec} " + (
                    "pipelined" if pipe else "sync")
                res["fused_checked_lanes"][tag] = r["checked_lanes"]
                if r["checked_lanes"] != FUSED_CHECKED + replicas * span:
                    raise AssertionError(f"fused plane {tag}: "
                                         f"{r['checked_lanes']} lanes checked")
                if want is None:
                    want = r["served"]
                elif r["served"] != want:
                    raise AssertionError(f"fused plane {tag} differs from "
                                         f"{FUSED_PLANES[0][0]}x"
                                         f"{FUSED_PLANES[0][1]} sync on the "
                                         "same start draws")
        for replicas, span in FUSED_PLANES:
            pair = {}
            for pipe in (False, True):
                r = fused_plane(dev, pack, x, replicas, span, pipe)
                pair[pipe] = r
                fused_runs[prec, replicas, pipe] = r
                if r["launches"] != {"fused_fog": r["dispatches"]}:
                    raise AssertionError(
                        f"fused plane {replicas}x{span} {prec}: launches "
                        f"{r['launches']} over {r['dispatches']} dispatches, "
                        "want one fused_fog each")
            if pair[False]["served"] != pair[True]["served"]:
                raise AssertionError(f"fused plane {replicas}x{span} {prec}: "
                                     "sync and pipelined differ")
            for pipe, r in pair.items():
                row = {k: v for k, v in r.items()
                       if k not in ("served", "batcher", "serve",
                                    "checked_lanes")}
                res["fused"].append(row)
                print(f"[serve] fused plane {replicas} x {span} slots {prec} "
                      f"{'pipelined' if pipe else 'sync'}: "
                      f"{r['requests_per_s']:.1f} requests/s, p99 "
                      f"{r['p99_ms']:.3f} ms, {r['steps']} steps, "
                      f"{r['dispatches']} dispatches, launches "
                      f"{r['launches']} by route {r['routes']}, host ms "
                      "per step " + ", ".join(
                          f"{k} {v:.4f}" for k, v in
                          r["host_ms_per_step"].items()))
    print(f"[serve] fused plane: every served lane == _eval_core reference "
          f"on its request's row and knobs and the drawn start "
          f"({res['fused_checked_lanes']} lanes); on the same draws 4 x 256 "
          f"== 1 x 1024, sync == pipelined")
    res["fused_runs"] = fused_runs
    # the LM mode
    res["lm"] = lm_serve(dev)
    lm = res["lm"]
    print(f"[serve] LM mode {lm['arch']} fp32: {lm['requests']} requests, "
          f"{lm['tokens']} tokens in {lm['seconds']:.2f} s "
          f"({lm['tokens_per_s']:.1f} tokens/s), {lm['groves_per_token']:.2f} "
          f"of {lm['n_groves']} groves per token; launches {lm['launches']} "
          f"by route {lm['routes']}; first tokens == forward's argmax, logits "
          f"within {lm['first_token_max_abs_err_vs_forward']:.2e}")
    res["field"] = field
    res["root"] = root
    return res


def serve_profile(serve: dict, dev: torch.device) -> None:
    """The profiler's figures of the serve phase, after every event
    timing: a registry-plane run and every fused-plane run under
    ``torch.profiler``."""
    field, root = serve["field"], serve["root"]
    for m in ("sync", "pipelined"):
        ctx = registry_setup(dev, field, root / f"prof-{m}")
        d0 = ctx["dispatcher"].n_dispatches
        prof = serving_profile(
            lambda c=ctx, m=m: registry_serve(c, pipeline=m == "pipelined"),
            lambda c=ctx: c["dispatcher"].n_dispatches - d0)
        serve["registry"][m]["profile"] = prof
        print(f"[serve] registry plane {m} under the profiler: wall "
              f"{prof['wall_ms']:.1f} ms, device busy "
              f"{prof['device_busy_ms']:.2f} ms, idle "
              f"{prof['device_idle_share']:.3f}; per dispatch: launches "
              f"{prof['launches_per_dispatch']}, fused_fog "
              f"{fmt(prof['fused_fog_device_ms'])} ms on the device, host "
              f"ops {prof['host_ops_per_dispatch']}")
    for (prec, replicas, pipe), r in serve.pop("fused_runs").items():
        disp = r["batcher"].dispatcher
        d0 = disp.n_dispatches
        prof = serving_profile(
            lambda r=r: r["serve"](FUSED_REQUESTS // 16, 10**6),
            lambda disp=disp, d0=d0: disp.n_dispatches - d0)
        row = next(x for x in serve["fused"]
                   if (x["precision"], x["replicas"], x["pipeline"])
                   == (prec, replicas, pipe))
        row["profile"] = prof
        print(f"[serve] fused plane {replicas} x {row['span']} {prec} "
              f"{'pipelined' if pipe else 'sync'} under the profiler: wall "
              f"{prof['wall_ms']:.1f} ms, idle {prof['device_idle_share']:.3f}"
              f", fused_fog {fmt(prof['fused_fog_device_ms'])} ms on the "
              f"device a launch, {prof['launches_per_dispatch']} per "
              "dispatch")
    serve.pop("field")
    serve.pop("root")


# -- the paper's evaluation path (phase 13) ------------------------------------
PAPER_THRESHOLDS = (1.1, 0.3)
PAPER_SECTIONS = ("fig4_topology", "fig5_threshold", "ablation_adaptive")
PAPER_ACC_BAR = 0.01      # card vs CPU accuracy of a trained baseline
# card vs CPU params after 5 steps on segmentation, over each leaf's
# scale: the port's setting (TF32 and cuDNN off) parts by at most 3.5e-6
# there over 6 inits, and TF32 on by at least 7.5e-4 for SVM_RBF, the MLP
# and the CNN (PERF.md)
FIVE_STEP_BAR = 1e-4


def five_steps(name: str, init, ds, dev: torch.device):
    """A baseline's trained tree after one epoch of ``ds``, as its
    ``train_*`` trains it (``fit_setup``, TF32 off)."""
    return bl_train.fit_setup(name, init, ds.n_features, dev).fit(
        ds, epochs=1, device=dev)


FIVE_STEP_SEEDS = 2
# the baselines' training setting: the port's (``fp32_products``), with
# cuDNN's convolutions back on, and with TF32 back on (the control)
FIVE_STEP_SETTINGS = ("port", "cudnn", "tf32")


@contextlib.contextmanager
def training_setting(setting: str):
    """``_fit`` inside the block trains under ``setting``."""
    real = bl_train.fp32_products

    @contextlib.contextmanager
    def products(cudnn: bool = True):
        with real(cudnn=cudnn or setting == "cudnn"):
            if setting == "tf32":
                torch.backends.cuda.matmul.allow_tf32 = True
                torch.backends.cudnn.allow_tf32 = True
            yield

    bl_train.fp32_products = products
    try:
        yield
    finally:
        bl_train.fp32_products = real


def leaf_names(tree, prefix: str = "") -> list:
    """Dotted names of a tree's leaves, in ``tree_leaves``' order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def five_step_checks(dev: torch.device) -> list:
    """Each baseline's params after 5 steps (one epoch of 640 rows) from
    ``FIVE_STEP_SEEDS`` inits on each dataset, on the card in every
    setting against the CPU: the largest gap over a leaf's scale and its
    leaf.  On segmentation the port's setting must stay within
    ``FIVE_STEP_BAR``, and the CNN with TF32 on must not (the bar sees
    that drift)."""
    rows = []
    for dname in paper_common.DATASETS:
        ds = paper_common.dataset(dname)
        five = dataclasses.replace(ds, x_train=ds.x_train[:640],
                                   y_train=ds.y_train[:640])
        for name in ALL_BASELINES:
            for seed in range(FIVE_STEP_SEEDS):
                init = bl_train.BASELINE_INIT[name](
                    torch.Generator().manual_seed(seed), ds.n_features,
                    ds.n_classes)
                cpu = five_steps(name, init, five, torch.device("cpu"))
                row = {"dataset": dname, "baseline": name, "seed": seed}
                for setting in FIVE_STEP_SETTINGS:
                    with training_setting(setting):
                        card = five_steps(name, init, five, dev)
                    row[setting] = max(
                        (float((a.cpu() - b).abs().max() / b.abs().max()), n)
                        for a, b, n in zip(tree_leaves(card),
                                           tree_leaves(cpu),
                                           leaf_names(cpu)))
                what = f"{dname} {name} seed {seed}: params after 5 steps"
                if dname == "segmentation" and row["port"][0] > FIVE_STEP_BAR:
                    raise AssertionError(
                        f"{what} part by {row['port'][0]:.3e} of the scale of "
                        f"{row['port'][1]} (bar {FIVE_STEP_BAR})")
                if name == "cnn" and row["tf32"][0] <= FIVE_STEP_BAR:
                    raise AssertionError(
                        f"{what} with TF32 on part by only "
                        f"{row['tf32'][0]:.3e} (bar {FIVE_STEP_BAR})")
                rows.append(row)
    for name in ALL_BASELINES:
        mine = [r for r in rows if r["baseline"] == name]
        seg = [r for r in mine if r["dataset"] == "segmentation"]

        def worst(rs, setting):
            r = max(rs, key=lambda r: r[setting][0])
            return (f"{r[setting][0]:.2e} ({r['dataset']} seed {r['seed']} "
                    f"{r[setting][1]})")

        print(f"[paper] {name} params after 5 steps, card vs CPU, largest "
              f"gap over a leaf's scale over {FIVE_STEP_SEEDS} inits: port "
              f"{worst(seg, 'port')} on segmentation (bar {FIVE_STEP_BAR}),"
              f" {worst(mine, 'port')} on all five; cuDNN on "
              f"{worst(mine, 'cudnn')}; TF32 on, the smallest "
              f"{min(r['tf32'][0] for r in mine):.2e}")
    return rows


def paper_fields(dev: torch.device) -> dict:
    """The five Table 1 fields (host CART at ``paper_common.DEPTHS``, 8 x
    2), packed on the card at every precision, with their test sets on
    the card and seeded start draws."""
    gen = torch.Generator(device=dev)
    fields = {}
    for name in paper_common.DATASETS:
        ds = paper_common.dataset(name)
        gc = split(paper_common.forest_for(name), paper_common.GROVE_SIZE)
        gc_card = GroveCollection(*(a.to(dev) for a in (
            gc.feature, gc.threshold, gc.leaf)))
        fields[name] = {
            "ds": ds, "gc": gc,
            "packs": {p: ForestPack.from_groves(gc_card, p)
                      for p in PRECISIONS},
            "x": torch.as_tensor(ds.x_test, device=dev),
            "start": sample_starts(gen.manual_seed(SEED), len(ds.y_test),
                                   gc.n_groves)}
    return fields


def paper_field_evals(dev: torch.device, fields: dict) -> dict:
    """``fused`` evals at every field, precision and threshold from the
    field's starts: {(name, precision, threshold): (report, route)}."""
    out = {}
    for name, f in fields.items():
        for p in PRECISIONS:
            engine = FogEngine(f["packs"][p], backend="fused", device=dev)
            for thr in PAPER_THRESHOLDS:
                before = dict(_build.routes)
                r = engine.eval(f["x"], policy=FogPolicy(threshold=thr),
                                start=f["start"])
                torch.cuda.synchronize()
                route = [k for k in FUSED_ROUTES
                         if _build.routes[k] != before[k]]
                out[name, p, thr] = (r, route)
    return out


@contextlib.contextmanager
def recorded_evals():
    """Every ``_eval_core`` call a ``FogEngine`` makes inside the block, as
    (pack, the call's other arguments, its result)."""
    calls: list = []
    core = fog_engine._eval_core

    def spy(pack, *args, **kw):
        out = core(pack, *args, **kw)
        calls.append((pack, args, out))
        return out

    fog_engine._eval_core = spy
    try:
        yield calls
    finally:
        fog_engine._eval_core = core


def check_paper_evals(calls: list, fields: dict) -> dict:
    """Hold each recorded eval, which must be ``fused`` at one threshold,
    to ``reference`` on the card and to the plain path on the CPU from
    the same inputs and starts: hops and labels equal, proba within RTOL /
    ATOL.  {(dataset, topology, precision, threshold): (evals, max abs
    err)}."""
    name_of = {(f["ds"].n_features, f["ds"].n_classes, len(f["ds"].y_test)):
               name for name, f in fields.items()}
    on_cpu: dict = {}
    out: dict = {}
    for pack, args, got in calls:
        x, start, thresh, budget, max_hops, backend, block_b, lazy = args
        thr = round(float(thresh[0]), 6)
        key = (name_of[x.shape[1], pack.n_classes, x.shape[0]],
               f"{pack.n_groves}x{pack.grove_size}", pack.precision, thr)
        what = "paper eval {} {} {} thresh {}".format(*key)
        if backend != "fused" or not bool((thresh == thresh[0]).all()):
            raise AssertionError(f"{what}: backend {backend}, want fused "
                                 "at one threshold")
        if id(pack) not in on_cpu:
            on_cpu[id(pack)] = pack.to("cpu")
        tail = (max_hops, "reference", block_b, lazy)
        want_card = _eval_core(pack, x, start, thresh, budget, *tail)
        want_cpu = _eval_core(on_cpu[id(pack)], *(a.cpu() for a in (
            x, start, thresh, budget)), *tail)
        err = 0.0
        for want, where in ((want_card, "reference on the card"),
                            (want_cpu, "the CPU")):
            check_equal(f"{what} hops vs {where}", got.hops, want.hops)
            check_equal(f"{what} labels vs {where}", got.label, want.label)
            err = max(err, check_close(f"{what} proba vs {where}",
                                       got.proba, want.proba))
        n, e = out.get(key, (0, 0.0))
        out[key] = (n + 1, max(e, err))
    return out


def paper_phase(dev: torch.device) -> dict:
    """Phase 13: the paper's evaluation path on the card (see the module
    docstring's item 13); event timings only -- ``paper_profile`` adds
    the kernel's device ms after every event timing."""
    t0 = time.perf_counter()
    fields = paper_fields(dev)
    setup_s = time.perf_counter() - t0
    print(f"[paper] five fields (host CART, 16 trees in 8 x 2) trained and "
          f"packed on the card in {setup_s:.1f} s")
    # the main path: the fields' fused evals, Table 1 and the figure
    # sections, with the counts zeroed just before and read just after
    t0 = time.perf_counter()
    zero_counts()
    with recorded_evals() as calls:
        evals = paper_field_evals(dev, fields)
        table1 = paper_common.evaluate_datasets(paper_common.DATASETS,
                                                device=dev)
        secs = paper_run.sections(device=dev)
        figures = {s: secs[s]() for s in PAPER_SECTIONS}
    launches, routes = read_counts()
    path_s = time.perf_counter() - t0
    # one launch an eval: the fields' evals; FoG_max and the 9-point
    # FoG_opt sweep per dataset; Figure 4's 5 topologies on its 2
    # datasets; Figure 5's 2 topologies x 9 thresholds on all 5; the
    # ablation's 4 thresholds on its 2
    n_sweep = len(fig5_threshold.THRESHOLDS)
    n_fog = (len(evals) + len(table1) * (1 + n_sweep) + 2 * 5
             + len(paper_common.DATASETS) * 2 * n_sweep
             + 2 * len(ablation_adaptive.THRESHOLDS))
    print(f"[paper] main path in {path_s:.1f} s: kernel launches "
          f"{launches} by route {routes}")
    if launches != {"fused_fog": n_fog} or routes.get("fused_fog"):
        raise AssertionError(
            f"paper path: launches {launches} by route {routes}, want "
            f"{n_fog} fused_fog launches (one an eval), each on a group "
            "route, and no other kernel")

    # 1. every eval of the main path (each topology the figures launch:
    # 16 x 1 to 1 x 16) == reference on the card == the plain path on the
    # CPU, from its own inputs and starts
    t0 = time.perf_counter()
    checked = check_paper_evals(calls, fields)
    n_checked = sum(n for n, _ in checked.values())
    if n_checked != n_fog:
        raise AssertionError(f"paper path: {n_checked} evals recorded and "
                             f"checked, {n_fog} fused_fog launches")
    res: dict = {"fields": {}, "evals_checked": [
        {"dataset": d, "topology": t, "precision": p, "threshold": thr,
         "evals": n, "max_abs_err": e}
        for (d, t, p, thr), (n, e) in checked.items()]}
    by_topology: dict = {}
    for (d, t, p, thr), (n, e) in checked.items():
        row = by_topology.setdefault(t, {"evals": 0, "datasets": set(),
                                         "thresholds": set(), "err": 0.0})
        row["evals"] += n
        row["datasets"].add(d)
        row["thresholds"].add(thr)
        row["err"] = max(row["err"], e)
    print(f"[paper] all {n_checked} evals of the main path == reference on "
          f"the card == the CPU (hops, labels; proba within rtol {RTOL} / "
          f"atol {ATOL}) in {time.perf_counter() - t0:.1f} s: " + "; ".join(
              f"{t} {r['evals']} evals, {len(r['datasets'])} datasets, "
              f"{len(r['thresholds'])} thresholds, max abs err "
              f"{r['err']:.2e}" for t, r in sorted(by_topology.items())))
    kernel_fns = {}
    for (name, p, thr), (r, route) in evals.items():
        f = fields[name]
        pack, x, start = f["packs"][p], f["x"], f["start"]
        what = f"paper {name} {p} thresh {thr}"
        err = checked[name, "8x2", p, thr][1]
        check_equal(f"{what} energy", r.energy_pj, r.model.lane_pj(r.hops))
        if len(route) != 1:
            raise AssertionError(f"{what}: one fused_fog launch on one "
                                 f"route, got {route}")
        ffa = pack.layout("fused")
        B = x.shape[0]
        args = (*ffa[:3], x, start, torch.full((B,), thr, device=dev),
                torch.full((B,), NO_BUDGET, dtype=torch.int32, device=dev),
                *ffa[3:])
        fn = lambda a=args, G=pack.n_groves: ops.fused_fog(
            *a, max_hops=G, block_b=FUSED_BLOCK_B)
        check_equal(f"{what} fused_fog call vs the eval", fn()[1], r.hops)
        work = fused_work(pack, x, start, r.hops)
        row = {"route": route[0], "launches_per_eval": 1,
               "accuracy": float((r.label.cpu().numpy()
                                  == f["ds"].y_test).mean()),
               "mean_hops": float(r.hops.float().mean()),
               "pj_per_classification": r.mean_energy_pj,
               "max_abs_err": err, "table_bytes": pack.table_bytes,
               "smem_table_bytes": ff.table_smem_bytes(
                   pack.n_heads, pack.n_groves, pack.grove_size,
                   pack.depth, pack.n_classes,
                   pack.threshold.element_size()),
               "B": B, "F": x.shape[1], "depth": pack.depth,
               "C": pack.n_classes, "ms": cuda_ms(fn),
               "plain_ms": cuda_ms(lambda a=args, G=pack.n_groves:
                                   fused_fog_ref(*a, max_hops=G))}
        row["bound_ms"], row["bound_by"] = bound_ms(work["bytes"],
                                                    work["ops"])
        res["fields"][f"{name} {p} {thr}"] = row
        kernel_fns[name, p, thr] = (fn, route[0])
    for key, row in res["fields"].items():
        print(f"[paper] fused_fog {key}: B={row['B']} F={row['F']} depth "
              f"{row['depth']} C={row['C']}, table {row['table_bytes']} B "
              f"({row['smem_table_bytes']} B staged); route {row['route']}, "
              f"1 launch an eval; accuracy {row['accuracy']:.3f}, mean hops "
              f"{row['mean_hops']:.3f}; {row['ms']:.4f} ms a call, bound "
              f"{row['bound_ms']:.6f} ms by {row['bound_by']}, plain "
              f"{row['plain_ms']:.3f} ms; fused == reference == CPU "
              f"(max abs err {row['max_abs_err']:.2e})")

    # 2. Table 1 and the ratios beside the paper's
    rows_acc = table1_accuracy.run(table1)
    rows_nj = table1_energy.run(table1)
    for line in rows_acc:
        print(f"[paper] table1 accuracy: {line}")
    for line in rows_nj:
        print(f"[paper] table1 nJ: {line}")
    ratios = table1_energy.geomean_ratios(table1)
    print("[paper] geomean energy / FoG_opt's (this run; the paper's): "
          + ", ".join(f"{c} {ratios[c]:.2f} ({PAPER_RATIOS[c]:.3g})"
                      for c in PAPER_RATIOS))
    res["table1"] = {name: {c: {"accuracy": r.accuracy,
                                "energy_nj": r.energy_nj}
                            for c, r in cols.items()}
                     for name, cols in table1.items()}
    res["geomean_ratio_vs_fog_opt"] = ratios
    res["paper_ratios"] = PAPER_RATIOS

    # 3. prediction over each test set, CUDA events, median of 20
    res["classifications_per_s"] = {}
    for name, cols in table1.items():
        x = fields[name]["x"]
        per = {c: x.shape[0] / cuda_ms(lambda r=r: r.predict(x), reps=5)
               * 1e3
               for c, r in cols.items()}
        res["classifications_per_s"][name] = per
        print(f"[paper] {name} classifications/s over the {x.shape[0]}-row "
              "test set: " + ", ".join(f"{c} {v:.4g}"
                                       for c, v in per.items()))

    # 4. segmentation: each baseline trained on the card and on the CPU
    # from the same init (the port's, drawn on the CPU); and the params
    # after one epoch of 5 minibatches from 2 inits on every dataset
    ds = paper_common.dataset("segmentation")
    res["segmentation_card_vs_cpu"] = {}
    for name, train in ALL_BASELINES.items():
        acc = {}
        for where, key in ((dev, "card"), (torch.device("cpu"), "cpu")):
            init = bl_train.BASELINE_INIT[name](
                torch.Generator().manual_seed(SEED), ds.n_features,
                ds.n_classes)
            acc[key] = train(ds, params=init, device=where).accuracy
        gap = abs(acc["card"] - acc["cpu"])
        res["segmentation_card_vs_cpu"][name] = {**acc, "gap": gap}
        if gap > PAPER_ACC_BAR:
            raise AssertionError(f"segmentation {name}: card accuracy "
                                 f"{acc['card']:.4f} vs CPU {acc['cpu']:.4f}"
                                 f" (bar {PAPER_ACC_BAR})")
    print("[paper] segmentation, card vs CPU from the same init: " + ", ".join(
        f"{k} {v['card']:.3f} / {v['cpu']:.3f}"
        for k, v in res["segmentation_card_vs_cpu"].items())
        + f" (within {PAPER_ACC_BAR})")
    res["five_steps"] = five_step_checks(dev)

    # 5. the figure sections, run on the card above
    for s, rows in figures.items():
        for line in rows:
            print(f"[paper] {s}: {line}")
    res["figures"] = figures
    res["launches"], res["routes"] = launches, routes
    res["main_path_s"], res["setup_s"] = path_s, setup_s
    res["kernel_fns"] = kernel_fns
    return res


def paper_profile(paper: dict) -> None:
    """fused_fog's device ms at each field, precision and threshold, after
    every event timing; None (printed "(no profiler record)") where no
    profile of ``retried_profile``'s recorded the kernel, as
    ``eval_profile``'s figures: CUPTI may keep no record of a short kernel
    late in a run, and these are timings, not checks (phase 13 holds
    every eval to the reference)."""
    for (name, p, thr), (fn, route) in paper.pop("kernel_fns").items():
        kernel = "fused_fog" if route == "fused_fog" else "fused_fog_group"
        per_launch = retried_profile(fn, kernel)[2]
        row = paper["fields"][f"{name} {p} {thr}"]
        row["device_ms"] = kernel_ms(per_launch, kernel)
        print(f"[time] paper fused_fog {name} {p} thresh {thr} on "
              f"{row['route']}: {fmt(row['device_ms'])} ms on the device "
              f"(bound {row['bound_ms']:.6f} ms by {row['bound_by']}; "
              f"{row['ms']:.4f} ms a call)")


# -- the fused autotuner (phase 15) -------------------------------------------
TUNE_THRESH = 0.3
TUNE_CACHE = ROOT / "build" / "autotune.json"


def tune_cases(dev: torch.device, packs: dict, x: torch.Tensor,
               fields: dict) -> list:
    """(label, pack, x, start) of every tuned key: the bench field at
    B = 1000 and BIG_B, the five Table 1 fields at their test sets, each at
    every precision."""
    gen = torch.Generator(device=dev)
    cases = []
    for nb in (x.shape[0], BIG_B):
        xb = x.repeat(-(-nb // x.shape[0]), 1)[:nb].contiguous()
        sb = sample_starts(gen.manual_seed(SEED), nb, packs["fp32"].n_groves)
        cases += [(f"bench B={nb} {p}", packs[p], xb, sb) for p in PRECISIONS]
    for name, f in fields.items():
        cases += [(f"{name} B={f['x'].shape[0]} {p}", f["packs"][p], f["x"],
                   f["start"]) for p in PRECISIONS]
    return cases


def fused_run(pack, x, start, thresh, budget, cfg):
    """The engine's fused evaluation on ``cfg``'s route, K, threads and
    chunk, at the pack's ``max_hops``."""
    return fused_eval(pack, x, start, thresh, budget, pack.n_groves, cfg)


def tune_phase(dev: torch.device, packs: dict, x: torch.Tensor) -> dict:
    """Phase 15: ``autotune.tune`` at every key of ``tune_cases`` into
    ``build/autotune.json``; each tuned pick held bit for bit to
    ``fused_fog_ref``; then phase 13's fused evals (the fields' evals,
    Table 1's forest columns and the figure sections; the baselines,
    which launch no kernel, are not trained again) with the cache file
    loaded, every eval held to ``reference`` on the card and the CPU.  Device times come after
    every event timing (``tune_profile``)."""
    TUNE_CACHE.parent.mkdir(exist_ok=True)
    TUNE_CACHE.unlink(missing_ok=True)
    os.environ[autotune.CACHE_ENV] = str(TUNE_CACHE)
    autotune.clear_cache()
    fields = paper_fields(dev)
    rows = {}
    t0 = time.perf_counter()
    for label, pack, xb, sb in tune_cases(dev, packs, x, fields):
        nb, nf = xb.shape
        thresh = torch.full((nb,), TUNE_THRESH, dtype=torch.float32,
                            device=dev)
        budget = torch.full((nb,), NO_BUDGET, dtype=torch.int32, device=dev)
        seed = autotune.best_config(pack, nf, nb, pack.n_groves, dev)
        if seed.source != "analytic":
            raise AssertionError(f"tune {label}: untuned lookup {seed}")
        report: list = []
        tuned = autotune.tune(pack, xb, sb, thresh, budget,
                              max_hops=pack.n_groves, report=report)
        if autotune.best_config(pack, nf, nb, pack.n_groves, dev) != tuned:
            raise AssertionError(f"tune {label}: the lookup does not return "
                                 f"the tuned pick {tuned}")
        got = fused_run(pack, xb, sb, thresh, budget, tuned)
        lay = pack.layout("fused")
        want_p, want_h = fused_fog_ref(*lay[:3], xb, sb, thresh, budget,
                                       *lay[3:], max_hops=pack.n_groves)
        check_equal(f"tune {label}: tuned pick's proba vs fused_fog_ref",
                    got.proba, want_p[:, 0] if pack.n_heads == 1 else want_p)
        check_equal(f"tune {label}: tuned pick's hops vs fused_fog_ref",
                    got.hops, want_h)
        work = fused_work(pack, xb, sb, got.hops)
        bound, by = bound_ms(work["bytes"], work["ops"])
        by_route = {}
        for cfg, t in report:
            name = cfg.route + (" chunked" if cfg.chunk_b else "")
            by_route[name] = min(by_route.get(name, t), t)
        rows[label] = {
            "seed": seed.to_dict(), "tuned": tuned.to_dict(),
            "seed_ms": report[0][1] * 1e3, "tuned_ms": tuned.measured_s * 1e3,
            "candidates": len(report),
            "best_ms_by_route": {k: v * 1e3 for k, v in by_route.items()},
            "bound_ms": bound, "bound_by": by, "bytes": work["bytes"],
            "mean_hops": float(got.hops.float().mean()),
            "fns": {"seed": lambda a=(pack, xb, sb, thresh, budget, seed):
                    fused_run(*a),
                    "tuned": lambda a=(pack, xb, sb, thresh, budget, tuned):
                    fused_run(*a)}}
        print(f"[tune] {label}: seed {seed.describe()} "
              f"{rows[label]['seed_ms']:.4f} ms, tuned {tuned.describe()} "
              f"{rows[label]['tuned_ms']:.4f} ms (events, best of 3; "
              f"{len(report)} candidates; best by route " + ", ".join(
                  f"{k} {v:.4f}" for k, v in
                  rows[label]["best_ms_by_route"].items())
              + f"); bytes bound {bound:.6f} ms by {by}; tuned == "
              f"fused_fog_ref bit for bit")
    tune_s = time.perf_counter() - t0
    raw = json.loads(TUNE_CACHE.read_text())
    if len([k for k in raw if not k.startswith("hist/")]) != len(rows):
        raise AssertionError(f"{TUNE_CACHE}: {len(raw)} entries for "
                             f"{len(rows)} tuned keys")
    print(f"[tune] {len(rows)} keys tuned in {tune_s:.1f} s into "
          f"{TUNE_CACHE.relative_to(ROOT)}")

    # phase 13's fused evals again, the cache read back from the file
    autotune.clear_cache()
    looked: list = []
    real = autotune.best_config

    def spy(*a):
        cfg = real(*a)
        looked.append(cfg.source)
        return cfg

    autotune.best_config = spy
    t0 = time.perf_counter()
    zero_counts()
    try:
        with recorded_evals() as calls:
            paper_field_evals(dev, fields)
            for name in paper_common.DATASETS:      # Table 1's FoG columns
                paper_common.evaluate_forest(name, device=dev)
            secs = paper_run.sections(device=dev)
            for sec in PAPER_SECTIONS:
                secs[sec]()
        launches, routes = read_counts()
    finally:
        autotune.best_config = real
    path_s = time.perf_counter() - t0
    if launches != {"fused_fog": len(calls)}:
        raise AssertionError(f"paper path under the cache: launches "
                             f"{launches} for {len(calls)} evals")
    checked = check_paper_evals(calls, fields)
    n_cached = looked.count("cache-file")
    print(f"[tune] phase 13's fused evals with {TUNE_CACHE.name} loaded in "
          f"{path_s:.1f} s: {len(calls)} evals, {n_cached} on a cached pick "
          f"(the rest untuned topologies), launches by route {routes}; all "
          f"{sum(n for n, _ in checked.values())} == reference on the card "
          f"== the CPU (max abs err "
          f"{max(e for _, e in checked.values()):.2e})")
    if not n_cached:
        raise AssertionError("no eval of the paper path took a cached pick")
    # the later phases measure the untuned engine, as before
    autotune.clear_cache()
    del os.environ[autotune.CACHE_ENV]
    return {"keys": rows, "tune_s": tune_s, "paper_evals": len(calls),
            "paper_evals_cached": n_cached, "paper_routes": routes}


def tune_profile(tuned: dict) -> None:
    """The seed's and the tuned pick's device ms per evaluation at every
    key, from torch.profiler."""
    for label, row in tuned["keys"].items():
        fns = row.pop("fns")
        for k in ("seed", "tuned"):
            busy, _, _ = recorded_profile(fns[k], "fused_fog")[-1]
            row[f"{k}_device_ms"] = sum(v for n, v in busy.items()
                                        if "fused_fog" in n)
        print(f"[time] tune {label}: seed {row['seed']['route']} "
              f"{row['seed_device_ms']:.4f} ms, tuned {row['tuned']['route']}"
              f" K={row['tuned']['hops_per_walk']} block_b="
              f"{row['tuned']['block_b']} chunk {row['tuned']['chunk_b']} "
              f"{row['tuned_device_ms']:.4f} ms on the device (bytes bound "
              f"{row['bound_ms']:.6f} ms)")


# -- the rest of the LM layers (phase 16) -------------------------------------
# (config, what the card run cuts): full width in bf16, depth cut to fit
MORE_LM = (
    ("minicpm3-4b", {}, "none: 62 layers, full depth (~8 GB of weights)"),
    ("grok-1-314b", {"n_layers": 4},
     "depth 64 -> 4 layers (~9.8 GB a layer)"),
    ("deepseek-v3-671b", {"n_layers": 5},
     "depth 61 -> 5 layers: the 3 dense layers, then 2 MoE layers "
     "(~23 GB a MoE layer)"),
    ("jamba-1.5-large-398b", "smoke",
     "its smoke config (16 layers, d_model 128, 8 experts of 256): one "
     "period at full width holds 4 MoE layers of ~19.3 GB and 7 Mamba "
     "layers, ~90 GB, over the card's 80 GB"),
    ("gemma-2b", {}, "none: 18 layers, full depth (~5 GB of weights)"))
# the configs whose every prefill launch of flash_attention must take the
# tensor-core route at a pair it gained for them: launches a prefill
SM90_PREFILL = {"minicpm3-4b": 62, "deepseek-v3-671b": 5, "gemma-2b": 18}
MORE_CONSIST = (2, 128)
# FoG steps whose first-gate margins set the calibrated lane's threshold
MORE_CALIBRATION = 8
# tokens a prompt of the drop-free kernels-vs-plain prefill (default LM_S)
PLAIN_S = {"deepseek-v3-671b": 128}
# flash_attention against its plain version at the head pair of each
# config in SM90_PREFILL (minicpm3's 96 / 64, deepseek's 192 / 128,
# gemma's 256 / 256): (label, B, Sq, Sk, KV heads (None: the config's),
# causal, dtype); bf16 on the tensor cores, fp32 on the SIMT kernel
MLA_FLASH_CASES = (
    ("causal bf16", 1, 2048, 2048, None, True, torch.bfloat16),
    ("causal fp32", 1, 2048, 2048, None, True, torch.float32),
    ("ragged S = 200 bf16", 2, 200, 200, None, True, torch.bfloat16),
    ("ragged S = 200 fp32", 2, 200, 200, None, True, torch.float32),
    ("non-causal bf16", 1, 256, 192, None, False, torch.bfloat16),
    ("Sq < Sk bf16", 1, 100, 300, None, True, torch.bfloat16),
    ("Sq > Sk bf16", 1, 300, 100, None, True, torch.bfloat16),
    ("MQA (K = 1) bf16", 2, 256, 256, 1, True, torch.bfloat16))
# the tensor-core forward's lse against the plain version's, of its
# magnitude (at least 1): an fp32 ulp or two of a log-sum-exp near 8
LSE_BAR = 2e-6


def more_config(name: str, over) -> "ArchConfig":
    return smoke_config(name) if over == "smoke" else get_arch(name).scaled(
        **over)


def plain_flash(q, k, v, **kw):
    """``flash_attention_ref`` one batch row at a time (deepseek's full
    score matrix for four rows would take 8.6 GB in fp32)."""
    return torch.cat([flash_attention_ref(q[i:i + 1], k[i:i + 1],
                                          v[i:i + 1], **kw)
                      for i in range(q.shape[0])])


def plain_flash_lse(q, k, v, **kw):
    """``flash_attention_ref_lse`` one batch row at a time: (out, lse)."""
    rows = [fa.flash_attention_ref_lse(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                       **kw) for i in range(q.shape[0])]
    return (torch.cat([o for o, _ in rows]),
            torch.cat([lse for _, lse in rows]))


def plain_bwd(q, k, v, o, do, lse, **kw):
    """``flash_attention_bwd_ref`` one batch row at a time."""
    rows = [fa.flash_attention_bwd_ref(*(t[i:i + 1] for t in (
        q, k, v, o, do, lse)), **kw) for i in range(q.shape[0])]
    return tuple(torch.cat(g) for g in zip(*rows))


def lse_close(what: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Raise unless the kernel's lse is -inf where the plain version's is
    and within ``LSE_BAR`` of its magnitude (at least 1) elsewhere; the
    largest error as a share of that."""
    fin = torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), fin):
        raise AssertionError(f"{what}: lse -inf at other rows")
    err = ((got[fin] - want[fin]).abs()
           / want[fin].abs().clamp_min(1.0)).max()
    if float(err) > LSE_BAR:
        raise AssertionError(f"{what}: lse off by {float(err)} of its "
                             f"magnitude (bar {LSE_BAR})")
    return float(err)


@contextlib.contextmanager
def plain_kernels():
    """The prefill's kernels swapped for their plain versions on the card
    (``use_kernels=False``'s counterpart: no kernel launches)."""
    saved = ops.flash_attention, ops.ssd_chunk
    ops.flash_attention, ops.ssd_chunk = plain_flash, ssd_chunk_ref
    try:
        yield
    finally:
        ops.flash_attention, ops.ssd_chunk = saved


def more_gate_threshold(margins: torch.Tensor) -> float:
    """A threshold for one lane from its first gate's margins over
    calibration steps ``[steps]``: their median, so the lane exits at some
    steps and goes on at others (at full width with random weights the
    margins sit near 1e-4 and move little from gate to gate, so
    ``lm_gate_threshold``'s one-step rule left every step on one side)."""
    return float(margins.double().median())


def expected_prefill(cfg) -> tuple[dict, dict]:
    """The prefill's launches per kernel and routes, from the layer plan
    and the route rules."""
    prefix, period, n_rep = T.layer_plan(cfg)
    specs = prefix + period * n_rep
    n_attn = sum(s.mixer != "mamba" for s in specs)
    n_ssd = len(specs) - n_attn
    launches = {k: 0 for k in ops.launches}
    routes = {k: 0 for k in _build.routes}
    if n_attn:
        launches["flash_attention"] = n_attn
        D = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim if cfg.mla
             else cfg.resolved_head_dim)
        Dv = cfg.v_head_dim if cfg.mla else D
        r = flash_route(torch.bfloat16, D, Dv)
        routes["flash_attention_sm90" if r == "sm90"
               else "flash_attention"] = n_attn
    if n_ssd:
        launches["ssd_chunk"] = n_ssd
        P, N, Q = cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk
        r = ssd_chunk_route(torch.bfloat16, Q, P, N)
        routes["ssd_chunk_sm90" if r == "sm90" else "ssd_chunk"] = n_ssd
    return launches, routes


def head_pair(cfg) -> tuple[int, int]:
    """The config's attention head pair (D, Dv): MLA's D = dn + dr."""
    if cfg.mla:
        return cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim
    return cfg.resolved_head_dim, cfg.resolved_head_dim


def mla_flash_checks(dev, cfg, captured) -> dict:
    """flash_attention_cuda against its plain version at the config's head
    pair: the prefill's layer-0 bf16 q/k/v and ``MLA_FLASH_CASES``, each
    on the route ``route`` names; bf16 also run twice (the same bits) and
    with its lse (the same output; the lse within ``LSE_BAR``), fp32 on
    the SIMT route as well."""
    H = cfg.n_heads
    D, Dv = head_pair(cfg)
    K0 = H if cfg.mla else cfg.n_kv_heads
    rng = np.random.default_rng(SEED)
    cases = [("layer 0 of the prefill, bf16", captured[0], captured[1])]
    for label, b, Sq, Sk, K, causal, dtype in MLA_FLASH_CASES:
        K = K or K0
        cases.append((f"{label} [{b}, {Sq}/{Sk}, {H}/{K}, {D}/{Dv}]",
                      flash_inputs(rng, (b, Sq, Sk, H, K, D, Dv), dtype,
                                   dev),
                      {"causal": causal, "scale": 1.0 / np.sqrt(D)}))
    errs = {}
    for label, args, kw in cases:
        before = dict(_build.routes)
        got = ops.flash_attention(*args, **kw)
        ran = {k: _build.routes[k] - before[k] for k in before if
               _build.routes[k] != before[k]}
        want_route = ("flash_attention_sm90" if flash_route(
            args[0].dtype, D, Dv) == "sm90" else "flash_attention")
        if ran != {want_route: 1}:
            raise AssertionError(f"flash_attention {label}: routes {ran}")
        what = f"flash_attention {cfg.name} {label}"
        want, want_lse = plain_flash_lse(*args, **kw)
        case = {"out": flash_close(what, got, want)}
        again, lse = fa.flash_attention_cuda(*args, with_lse=True, **kw)
        if not torch.equal(got, again):
            raise AssertionError(f"{what}: another run (with lse) gave "
                                 f"other bits")
        case["lse"] = lse_close(what, lse, want_lse)
        del again, lse
        errs[f"{label} ({want_route})"] = case
        del got, want, want_lse
    return errs


def lm_more_run(dev: torch.device, name: str, over, cut: str,
                B: int = LM_B, S: int = LM_S,
                n_decode: int = LM_DECODE) -> dict:
    """One config of phase 16 (see ``lm_more_phase``)."""
    cfg = more_config(name, over)
    G = len(grove_boundaries(cfg))
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                           torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    res = {"arch": cfg.name, "cut": cut, "n_params": n_params,
           "groves": G, "init_s": time.perf_counter() - t0,
           "weights_gb": (torch.cuda.max_memory_allocated(dev) - base) / 1e9}
    print(f"[lm+] {cfg.name}: {describe(cfg)}; cut: {cut}; {n_params:,} "
          f"parameters in bf16 ({res['weights_gb']:.2f} GB) in "
          f"{res['init_s']:.1f} s; {G} layer-groves")
    tokens = torch.as_tensor(batch_at_step(
        DataConfig(cfg.vocab_size, S, B, seed=SEED), 0)["tokens"], device=dev)
    prefill_fn, _ = make_prefill_step(cfg, dev, batch=B, seq_len=S,
                                      max_seq=S + n_decode)
    serve, _ = make_serve_step(cfg, dev, batch=B, max_seq=S + n_decode)
    fog, _ = make_serve_step(cfg, dev, batch=B, max_seq=S + n_decode,
                             fog=True, policy=FogPolicy(backend="pallas"))
    no_budget = torch.full((B,), NO_BUDGET, dtype=torch.int32, device=dev)

    # lane LM_GATE_LANE's threshold from calibration FoG steps (before the
    # counts are zeroed)
    logits, cache = prefill_fn(params, tokens)
    never = torch.full((B,), 2.0, dtype=torch.float32, device=dev)
    tok, cal = logits.argmax(-1).to(torch.int32), []
    for t in range(MORE_CALIBRATION):
        with GateSpy() as spy:
            lg, cache, _ = fog(params, cache, tok, S + t, never, no_budget)
        cal.append(spy.calls[0][1][LM_GATE_LANE])
        tok = lg.argmax(-1).to(torch.int32)
    del logits, cache
    cal = torch.stack(cal).cpu()
    lanes = torch.tensor([more_gate_threshold(cal) if t is None else t
                          for t in LM_THRESH[:B]], dtype=torch.float32)
    thresh = lanes.to(dev)

    # the main path: prefill, greedy decode, FoG decode; layer 0's
    # attention inputs kept
    captured, real = [], ops.flash_attention

    def spy_flash(*args, **kw):
        if not captured:
            captured.append((tuple(a.clone() for a in args), kw))
        return real(*args, **kw)

    zero_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.flash_attention = spy_flash
    try:
        logits, cache = prefill_fn(params, tokens)
    finally:
        ops.flash_attention = real
    torch.cuda.synchronize()
    pre_launches, pre_routes = dict(ops.launches), dict(_build.routes)
    res["prefill_max_gb"] = (torch.cuda.max_memory_allocated(dev) - base) / 1e9

    def greedy(step, *knobs):
        tk, c = logits.argmax(-1).to(torch.int32), cache
        out, hops = [], []
        for t in range(n_decode):
            r = step(params, c, tk, S + t, *knobs)
            out.append(r[0])
            c = r[1]
            if knobs:
                hops.append(r[2])
            tk = r[0].argmax(-1).to(torch.int32)
        return torch.stack(out), (torch.stack(hops) if hops else None)

    plain, _ = greedy(serve)
    with GateSpy() as gates:
        fog_logits, fog_hops = greedy(fog, thresh, no_budget)
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.launches.items() if v}
    want_l, want_r = expected_prefill(cfg)
    res.update(prefill_launches={k: v for k, v in pre_launches.items() if v},
               prefill_routes={k: v for k, v in pre_routes.items() if v},
               launches=launches)
    print(f"[lm+] {cfg.name} main path (prefill B={B} x S={S}, {n_decode} "
          f"greedy decode steps, {n_decode} FoG steps at per-lane "
          f"thresholds {lanes.tolist()}): kernel launches {launches}; the "
          f"prefill alone {res['prefill_launches']}, by route "
          f"{res['prefill_routes']}; max_memory_allocated in the prefill "
          f"{res['prefill_max_gb']:.2f} GB")
    if pre_launches != want_l or pre_routes != want_r:
        raise AssertionError(
            f"{cfg.name} prefill: launches {pre_launches} by route "
            f"{pre_routes}, want {want_l} by route {want_r}")
    if name in SM90_PREFILL and {k: v for k, v in pre_routes.items()
                                 if v} != {"flash_attention_sm90":
                                           SM90_PREFILL[name]}:
        raise AssertionError(
            f"{cfg.name} prefill: routes {pre_routes}, want all "
            f"{SM90_PREFILL[name]} flash_attention launches on the tensor "
            f"cores at {head_pair(cfg)}")
    if launches.get("top2_confidence") != n_decode * (G - 1):
        raise AssertionError(f"{cfg.name}: {launches} in the path, want "
                             f"{n_decode * (G - 1)} top2_confidence")
    for what, t in (("prefill", logits), ("decode", plain),
                    ("FoG", fog_logits)):
        if not torch.isfinite(t).all() or t.shape[-1] != cfg.vocab_size:
            raise AssertionError(f"{cfg.name} {what} logits: not finite or "
                                 f"{tuple(t.shape)}")

    # the gate: the kernel == plain on every input; the hops those margins
    # give; the calibrated lane decided both ways
    gate_err = max(check_close(f"{cfg.name} top2_confidence gate {i}", m,
                               ref.top2_confidence_ref(p))
                   for i, (p, m) in enumerate(gates.calls))
    margins = torch.stack([m for _, m in gates.calls]).cpu().view(
        n_decode, G - 1, B)
    hops_cpu = fog_hops.cpu()
    decided = torch.zeros((2, B), dtype=torch.int64)
    for t in range(n_decode):
        want, d = gate_hops(margins[t], lanes, no_budget.cpu())
        if not torch.equal(hops_cpu[t], want):
            raise AssertionError(f"{cfg.name} FoG step {t}: hops "
                                 f"{hops_cpu[t].tolist()}, the plain margins "
                                 f"give {want.tolist()}")
        decided += d
    if not (decided[:, LM_GATE_LANE] > 0).all():
        raise AssertionError(f"{cfg.name}: lane {LM_GATE_LANE} at threshold "
                             f"{float(lanes[LM_GATE_LANE])} went on "
                             f"{int(decided[0, LM_GATE_LANE])} and exited "
                             f"{int(decided[1, LM_GATE_LANE])} times")
    keep = (lanes >= 1.0).to(dev)
    never_err = float((fog_logits[:, keep] - plain[:, keep]).abs().max())
    if not torch.allclose(fog_logits[:, keep], plain[:, keep], rtol=FOG_TOL,
                          atol=FOG_TOL):
        raise AssertionError(f"{cfg.name}: never-exit lanes differ from the "
                             f"plain decode by {never_err}")
    res["fog"] = {"thresholds": lanes.tolist(),
                  "hops_per_lane_mean": hops_cpu.float().mean(0).tolist(),
                  "mean_groves_per_token": float(hops_cpu.float().mean()),
                  "top2_max_abs_err_vs_plain": gate_err,
                  "gate_lane_decisions": decided[:, LM_GATE_LANE].tolist(),
                  "never_exit_max_abs_err_vs_plain": never_err}
    print(f"[lm+] {cfg.name}: top2_confidence == plain on all "
          f"{len(gates.calls)} gate inputs (max abs err {gate_err:.3g}), hops "
          f"== the plain margins' at every step; hops per lane "
          f"{[round(v, 3) for v in res['fog']['hops_per_lane_mean']]} of {G}; "
          f"lane {LM_GATE_LANE} went on / exited "
          f"{res['fog']['gate_lane_decisions']}; never-exit lanes == plain "
          f"decode (max abs err {never_err:.3g})")
    del gates

    # the prefill with the kernels' plain versions on the card.  The
    # logits are bf16 products (an ulp is 2**-5 at a logit of 4), so the
    # bar is CONSIST_TOL of the logit scale.  An expert's capacity cut is a
    # step function of the hidden states: one bf16 ulp moves which tokens
    # it keeps, so MoE configs are held drop-free (capacity = every token,
    # at PLAIN_S tokens a prompt where the full prompt's [B, E, S, d]
    # dispatch would not fit beside the weights); the configured capacity's
    # difference is printed beside it
    with plain_kernels():
        zero_counts()
        plain_logits, _ = prefill_fn(params, tokens)
        if read_counts()[0]:
            raise AssertionError("the plain prefill launched a kernel")
    as_configured = float((logits - plain_logits).abs().max())
    ps = min(PLAIN_S.get(name, S), S)
    if cfg.moe:
        free = cfg.scaled(capacity_factor=float(cfg.n_experts))
        pre_free, _ = make_prefill_step(free, dev, batch=B, seq_len=ps)
        got = pre_free(params, tokens[:, :ps])[0]
        with plain_kernels():
            plain_logits = pre_free(params, tokens[:, :ps])[0]
    else:
        got = logits
    prefill_err = float((got - plain_logits).abs().max())
    scale = float(plain_logits.abs().max())
    del got, plain_logits
    if prefill_err > CONSIST_TOL * scale:
        raise AssertionError(f"{cfg.name}: prefill logits with the kernels "
                             f"differ from the plain versions' by "
                             f"{prefill_err} (scale {scale})")
    res["prefill_vs_plain"] = {"max_abs_err": prefill_err, "seq": ps,
                               "logit_scale": scale, "tol": CONSIST_TOL,
                               "drop_free": bool(cfg.moe),
                               "as_configured_max_abs_err": as_configured}
    print(f"[lm+] {cfg.name}: prefill logits with the kernels == with their "
          f"plain versions at B={B} x S={ps}"
          + (" with drop-free capacity" if cfg.moe else "")
          + f" (max abs err {prefill_err:.3g} at logit scale {scale:.3g}; "
          f"bar {CONSIST_TOL} of the scale); at the configured capacity "
          f"and S={S}: {as_configured:.3g}")
    if cfg.mla or name in SM90_PREFILL:
        res["flash_attention_max_abs_err"] = mla_flash_checks(
            dev, cfg, captured[0])
        print(f"[lm+] {cfg.name}: flash_attention == plain at "
              f"{head_pair(cfg)} (max abs err of the output; "
              f"bit-equal run to run, the lse's error of its magnitude): "
              f"{res['flash_attention_max_abs_err']}")

    # event timings
    tok0 = logits.argmax(-1).to(torch.int32)
    t = {"prefill_ms": cuda_ms(lambda: prefill_fn(params, tokens), reps=3,
                               warm=1)}
    t["prefill_tokens_per_s"] = B * S / t["prefill_ms"] * 1e3
    t["decode_ms_per_step"] = cuda_ms(lambda: serve(params, cache, tok0, S),
                                      reps=5, warm=1)
    t["fog_ms_per_step"] = cuda_ms(
        lambda: fog(params, cache, tok0, S, thresh, no_budget), reps=5,
        warm=1)
    if captured:
        (q, k, v), kw = captured[0]
        t["flash_attention_ms"] = cuda_ms(
            lambda: ops.flash_attention(q, k, v, **kw), reps=5, warm=1)
        t["flash_attention_plain_ms"] = cuda_ms(
            lambda: plain_flash(q, k, v, **kw), reps=3, warm=1)
        if name in SM90_PREFILL:
            # the SIMT kernel these pairs took before, on the same inputs
            t["flash_attention_simt_ms"] = cuda_ms(
                lambda: simt(fa, ops.flash_attention, q, k, v, **kw),
                reps=2, warm=1)
        work = flash_work(q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                          k.shape[2], q.shape[3], v.shape[3],
                          q.element_size())
        t["flash_attention_bound_ms"], t["flash_attention_bound_by"] = (
            bound_ms(work["bytes"], work["ops"], BF16_OPS_PER_S))
        t["flash_attention_shape"] = (f"{list(q.shape)} / {list(k.shape)} / "
                                      f"{list(v.shape)}")
    res["timing"] = t
    print(f"[time] lm+ {cfg.name}: prefill B={B} x S={S} "
          f"{t['prefill_ms']:.1f} ms ({t['prefill_tokens_per_s']:.4g} "
          f"tokens/s), decode {t['decode_ms_per_step']:.2f} ms per step of "
          f"{B} tokens, FoG {t['fog_ms_per_step']:.2f} ms" + (
              "" if not captured else
              f"; flash_attention {t['flash_attention_shape']} "
              f"{t['flash_attention_ms']:.3f} ms per call (bound "
              f"{t['flash_attention_bound_ms']:.4f} ms by "
              f"{t['flash_attention_bound_by']}), plain "
              f"{t['flash_attention_plain_ms']:.2f} ms" + (
                  "" if "flash_attention_simt_ms" not in t else
                  f", the SIMT kernel on the same inputs "
                  f"{t['flash_attention_simt_ms']:.3f} ms")))
    del params, cache, logits, plain, fog_logits, captured
    torch.cuda.empty_cache()

    # fp32 decode after prefill == forward, at a small depth, drop-free
    cb, cs = MORE_CONSIST
    small = cfg.scaled(
        n_layers=min(cfg.moe_first_k_dense, 1) + max(1, cfg.attn_layer_period),
        moe_first_k_dense=min(cfg.moe_first_k_dense, 1),
        capacity_factor=float(max(cfg.n_experts, 1)))
    p32 = T.init_params(small, torch.Generator(device=dev).manual_seed(SEED),
                        torch.float32, device=dev)
    toks = torch.as_tensor(batch_at_step(
        DataConfig(small.vocab_size, cs, cb, seed=SEED), 1)["tokens"],
        device=dev)
    split_at = cs // 2
    with bl_train.fp32_products():
        with torch.no_grad():
            h, _ = T.forward(p32, small, toks)
            want = T.unembed(p32, small, h)
            lg, c = T.prefill(p32, small, tokens=toks[:, :split_at],
                              max_seq=cs)
            pairs = [(lg, want[:, split_at - 1])]
            for i in range(split_at, cs):
                lg, c = T.decode_step(p32, small, toks[:, i], c, i)
                pairs.append((lg, want[:, i]))
    worst = max(float((a - b).abs().max()) for a, b in pairs)
    ok = all(torch.allclose(a, b, rtol=CONSIST_TOL, atol=CONSIST_TOL)
             for a, b in pairs)
    del p32, h, want, c, pairs
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"{cfg.name}: fp32 decode after prefill differs "
                             f"from the forward by {worst}")
    res["consistency"] = {"layers": small.n_layers, "batch": cb, "seq": cs,
                          "max_abs_err": worst, "tol": CONSIST_TOL}
    print(f"[lm+] {cfg.name}: fp32 at {small.n_layers} layers, drop-free "
          f"capacity, B={cb}, S={cs}: prefill {split_at} + decode "
          f"{cs - split_at} == forward (max abs err {worst:.3g}; rtol/atol "
          f"{CONSIST_TOL})")
    return res


def lm_more_phase(dev: torch.device) -> dict:
    """Phase 16: ``MORE_LM`` at full width in bf16 (depth cut as each
    entry says; weights from a seeded ``torch.Generator``): with the counts
    zeroed just before and read just after, prefill 4 x 2048 (one
    ``flash_attention`` a attention/MLA layer, one ``ssd_chunk`` a Mamba
    layer, each on the route its rule names), 32 greedy decode steps and
    32 FoG steps at per-lane thresholds (G - 1 ``top2_confidence`` a
    step); the gate held to its plain version and the hops to its
    margins; never-exit lanes == plain decode; the prefill's logits with
    the kernels == with their plain versions within CONSIST_TOL; at the
    MLA shapes ``flash_attention`` == plain (layer 0's bf16 inputs,
    causal bf16 and fp32 at S = 2048, ragged S = 200); fp32 decode after
    prefill == forward at a small depth with drop-free capacity."""
    out = {}
    for name, over, cut in MORE_LM:
        out[name] = lm_more_run(dev, name, over, cut)
    return out


def split_device_ms(busy: dict) -> dict:
    """A step's device ms by part: products, flash_attention,
    top2_confidence, ssd_chunk and the rest (elementwise, copies, sorts,
    reductions)."""
    parts = {"products": 0.0, "flash_attention": 0.0, "top2_confidence": 0.0,
             "ssd_chunk": 0.0, "elementwise_and_other": 0.0}
    for n, v in busy.items():
        if "flash_attention" in n:
            parts["flash_attention"] += v
        elif "top2" in n:
            parts["top2_confidence"] += v
        elif "ssd_chunk" in n:
            parts["ssd_chunk"] += v
        elif matmul_kernel(n):
            parts["products"] += v
        else:
            parts["elementwise_and_other"] += v
    return parts


def lm_more_profile(more: dict, dev: torch.device) -> None:
    """Each phase-16 config's steps under torch.profiler, its weights drawn
    again from the same seed (one config fits the card at a time): wall
    and device-busy ms per step, the idle share and the split of device
    time."""
    for name, over, _ in MORE_LM:
        res = more[name]
        cfg = more_config(name, over)
        params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(
            SEED), torch.bfloat16, device=dev)
        B, S = LM_B, LM_S
        tokens = torch.as_tensor(batch_at_step(
            DataConfig(cfg.vocab_size, S, B, seed=SEED), 0)["tokens"],
            device=dev)
        prefill_fn, _ = make_prefill_step(cfg, dev, batch=B, seq_len=S,
                                          max_seq=S + 1)
        serve, _ = make_serve_step(cfg, dev, batch=B, max_seq=S + 1)
        fog, _ = make_serve_step(cfg, dev, batch=B, max_seq=S + 1, fog=True,
                                 policy=FogPolicy(backend="pallas"))
        logits, cache = prefill_fn(params, tokens)
        tok = logits.argmax(-1).to(torch.int32)
        thresh = torch.tensor(res["fog"]["thresholds"], device=dev)
        budget = torch.full((B,), NO_BUDGET, dtype=torch.int32, device=dev)
        fns = {"prefill": (lambda: prefill_fn(params, tokens), 1),
               "decode": (lambda: serve(params, cache, tok, S), 2),
               "fog": (lambda: fog(params, cache, tok, S, thresh, budget), 2)}
        prof = {}
        for k, (fn, reps) in fns.items():
            busy, wall, _ = device_profile(fn, reps=reps)
            total = sum(busy.values())
            prof[k] = {"wall_ms": wall, "device_busy_ms": total,
                       "device_idle_share": 1.0 - total / wall,
                       "device_kernels": len(busy),
                       "split_ms": split_device_ms(busy)}
            print(f"[time] lm+ {name} {k} under the profiler: wall "
                  f"{wall:.2f} ms, device busy {total:.3f} ms, idle share "
                  f"{prof[k]['device_idle_share']:.3f}; device ms by part " +
                  ", ".join(f"{p} {v:.3f}" for p, v in
                            prof[k]["split_ms"].items()))
        res["timing"]["profile"] = prof
        del params, cache, logits, fns
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- 17 ---
# LM training at full width: tinyllama-1.1b in fp32 through the train CLI
TRAIN_ARCH = "tinyllama-1.1b"
TRAIN_STEPS, TRAIN_B, TRAIN_S = 4, 8, 256
# bars of the training checks: the loss with kernels against the plain
# versions (relative), every gradient leaf (of the leaf's scale, its
# largest magnitude), the backward kernel's dq, dk, dv against its plain
# version (of each gradient's scale), params after 5 steps on the card
# against the CPU port (of each leaf's scale, plus 1e-7 for the norm
# weights that start at 0; the CPU tests' reason, tests/test_torch_train.py)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_BAR = 1e-4
BWD_BAR = 1e-5
# a bf16 backward kernel against its plain version on the same bf16 inputs
# (of each gradient's scale): the tensor-core kernel rounds p and ds to
# bf16 before its last products, the plain version does not, and both
# store the gradients in bf16 (half an ulp, 2e-3 of an element); its
# numpy replay (tests/test_torch_flash_backward_bf16.py) and the card
# measured 6.5e-3 at most.  The SIMT kernel computes as the plain version
# does and parts from it by a stored ulp
BWD_BF16_BAR = 2e-2
CARD_CPU_BAR, CARD_CPU_ATOL = 1e-4, 1e-7
# the backward kernel against its plain version: (label, (B, Sq, Sk, H, K,
# D, Dv), causal)
BWD_CASES = (
    ("the training shape", (8, 256, 256, 32, 4, 64, 64), True),
    ("ragged Sq = Sk = 200", (2, 200, 200, 32, 4, 64, 64), True),
    ("Sq < Sk causal", (2, 100, 300, 32, 4, 64, 64), True),
    ("Sq > Sk causal", (2, 300, 100, 32, 4, 64, 64), True),
    ("non-causal", (2, 256, 256, 32, 4, 64, 64), False),
    ("MQA (K = 1)", (2, 256, 256, 32, 1, 64, 64), True),
    ("D = 192, Dv = 128 (deepseek's MLA)", (1, 256, 256, 16, 16, 192, 128),
     True),
    ("D = Dv = 256 (the largest tiles)", (1, 130, 130, 4, 2, 256, 256),
     True),
    ("D = 48, Dv = 32 (MLA at smoke width)", (2, 64, 64, 4, 4, 48, 32),
     True))
TRAIN_CKPT = ROOT / "build" / "train_resume_ckpt"


class PlainFlash(torch.autograd.Function):
    """flash_attention's plain versions with a gradient, on any device:
    ``flash_attention_ref_lse`` forward, ``flash_attention_bwd_ref``
    backward (the training path's kernels swapped out)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = fa.flash_attention_ref_lse(q, k, v, causal=causal,
                                              scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return (*fa.flash_attention_bwd_ref(q, k, v, out, do.contiguous(),
                                            lse, causal=ctx.causal,
                                            scale=ctx.scale), None, None)


@contextlib.contextmanager
def plain_training():
    """The training path's flash_attention and ssd_chunk on their plain
    versions (forward and backward) on the card: no kernel launches."""
    saved = ops.flash_attention, ops.ssd_chunk
    ops.flash_attention = lambda q, k, v, *, causal=True, scale=None: (
        PlainFlash.apply(q, k, v, causal, scale))
    ops.ssd_chunk = PlainSsd.apply
    try:
        yield
    finally:
        ops.flash_attention, ops.ssd_chunk = saved


@contextlib.contextmanager
def capture_first_flash(store: dict):
    """Record the first ``ops.flash_attention`` call's q, k, v and the
    gradient that reaches its output (layer 0 of the step)."""
    real = ops.flash_attention

    def wrapped(q, k, v, **kw):
        out = real(q, k, v, **kw)
        if "q" not in store:
            store.update(q=q.detach().clone(), k=k.detach().clone(),
                         v=v.detach().clone(), kw=kw)
            out.register_hook(lambda g: store.setdefault("do", g.clone()))
        return out

    ops.flash_attention = wrapped
    try:
        yield
    finally:
        ops.flash_attention = real


def leaf_error(got: dict, want: dict, bar: float, atol: float = 0.0,
               what: str = "") -> float:
    """Raise unless every tensor of ``got`` (by name) is within ``bar`` of
    the scale of ``want``'s (plus ``atol``); the largest error as a share
    of its leaf's scale."""
    if got.keys() != want.keys():
        raise AssertionError(f"{what}: other leaves")
    worst = 0.0
    for k, w in want.items():
        g, w = got[k].float(), w.float().to(got[k].device)
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        if not torch.isfinite(g).all() or err > bar * scale + atol:
            raise AssertionError(f"{what} {k}: max abs err {err} at scale "
                                 f"{scale} (bar {bar} of it + {atol})")
        worst = max(worst, err / scale if scale else err)
    return worst


def bwd_inputs(rng, shape, causal, dev, dtype=torch.float32) -> tuple:
    """q, k, v, the forward's output and lse (the kernel's, with_lse) and a
    random do, in ``dtype`` (lse fp32) on the card."""
    B, Sq, Sk, H, K, D, Dv = shape
    q, k, v = flash_inputs(rng, shape, dtype, dev)
    o, lse = fa.flash_attention_cuda(q, k, v, causal=causal, with_lse=True)
    do = torch.as_tensor(rng.normal(size=(B, Sq, H, Dv)).astype(np.float32),
                         device=dev).to(dtype)
    return q, k, v, o, do, lse


def bwd_check(what: str, args: tuple, causal: bool, scale=None) -> float:
    """The backward kernel twice (bit-equal: no atomics) against its plain
    version; the largest error of dq, dk, dv as a share of its scale."""
    kw = {"causal": causal, "scale": scale}
    got = fa.flash_attention_bwd_cuda(*args, **kw)
    again = fa.flash_attention_bwd_cuda(*args, **kw)
    want = fa.flash_attention_bwd_ref(*args, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, again):
        if not torch.equal(a, b):
            raise AssertionError(f"flash_attention_bwd {what}: {name} "
                                 f"differs from run to run")
    return leaf_error(dict(zip(("dq", "dk", "dv"), got)),
                      dict(zip(("dq", "dk", "dv"), want)), BWD_BAR,
                      what=f"flash_attention_bwd {what}")


def train_state(params) -> dict:
    return {k: p.detach() for k, p in params.named_parameters()}


def whole_tree_losses(cfg, dev, n: int, B: int, S: int, *,
                      lr: float = 3e-4, seed: int = 0) -> list:
    """The losses of the train CLI's ``n`` steps (its init, batches and
    schedule at ``--seed seed``) with the update that builds whole new
    trees: ``clip_by_global_norm`` over the gradients, then ``adamw``'s
    tree update, every new tensor made before any old one is let go.  The
    update that frees as it goes (``train.loop.apply_update``) must give
    these bits."""
    init, update = adamw(lr=linear_warmup_cosine(lr, 100, n), b1=0.9,
                         b2=0.95, weight_decay=0.1)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), torch.float32, device=dev)
    state = init(train_state(params))
    dcfg = DataConfig(cfg.vocab_size, S, B, seed=seed)
    losses = []
    for step in range(n):
        loss, grads = loss_and_grads(params, cfg,
                                     step_batch(cfg, dcfg, step, dev))
        with torch.no_grad(), bl_train.fp32_products():
            clipped, _ = clip_by_global_norm(grads, 1.0)
            new, state = update(clipped, state, train_state(params))
        for k, p in params.named_parameters():
            p.data = new[k]
        losses.append(float(loss))
        del grads, clipped, new
    del params, state
    torch.cuda.empty_cache()
    return losses


def steps_of(cfg, dev, params, opt_state, n, start=0, *, lr=3e-4, total=None,
             B=TRAIN_B, S=TRAIN_S):
    """``n`` train steps from ``start`` on ``batch_at_step``'s batches."""
    step_fn, _ = make_train_step(cfg, lr=lr, total_steps=total or n,
                                 device=dev)
    dcfg = DataConfig(cfg.vocab_size, S, B, seed=SEED)
    losses = []
    for s in range(start, start + n):
        params, opt_state, m = step_fn(params, opt_state,
                                       step_batch(cfg, dcfg, s, dev))
        losses.append(float(m["loss"]))
    return params, opt_state, losses


def same_training_state(what, a, b) -> None:
    (pa, oa), (pb, ob) = a, b
    for k, t in train_state(pa).items():
        check_equal(f"{what} param {k}", t, train_state(pb)[k])
    check_equal(f"{what} step", oa.step, ob.step)
    for m in ("mu", "nu"):
        for k, t in getattr(oa, m).items():
            check_equal(f"{what} {m} {k}", t, getattr(ob, m)[k])


def lm_train_phase(dev: torch.device) -> dict:
    """Phase 17: LM training on the card (see the module docstring)."""
    out: dict = {}
    t_phase = time.perf_counter()
    cfg = get_arch(TRAIN_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    # 1. full width through the CLI, counts zeroed and read around each
    # step
    run, per_step = counted_cli(["--arch", TRAIN_ARCH, "--steps",
                                 str(TRAIN_STEPS), "--batch", str(TRAIN_B),
                                 "--seq", str(TRAIN_S), "--log-every", "1"])
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    n_layers = cfg.n_layers
    want = ({"flash_attention": 2 * n_layers, "flash_attention_bwd":
             n_layers}, {"flash_attention": 2 * n_layers})
    for i, s in enumerate(per_step):
        if (s["launches"], s["routes"]) != want:
            raise AssertionError(
                f"train step {i}: launches {s['launches']} by route "
                f"{s['routes']}, want {want} (the forward and its remat "
                f"recompute on the SIMT route, one backward a layer; no "
                f"ssd_chunk or top2_confidence)")
    if not all(np.isfinite(run["losses"])):
        raise AssertionError(f"train losses {run['losses']}")
    whole = whole_tree_losses(cfg, dev, TRAIN_STEPS, TRAIN_B, TRAIN_S)
    if run["losses"] != whole:
        raise AssertionError(
            f"train losses {run['losses']}: the update that frees as it goes "
            f"must give the whole-tree update's {whole} bit for bit")
    out["losses_whole_tree"] = whole
    n_params = sum(p.numel() for p in run["params"].parameters())
    out.update(arch=TRAIN_ARCH, params=n_params, losses=run["losses"],
               grad_norms=run["grad_norms"], per_step=per_step,
               launches_per_step=per_step[-1]["launches"],
               routes_per_step=per_step[-1]["routes"])
    steady = [s["ms"] for s in per_step[1:]]
    out["step_ms"] = statistics.median(steady)
    out["tokens_per_s"] = TRAIN_B * TRAIN_S / out["step_ms"] * 1e3
    print(f"[train-lm] {TRAIN_ARCH} fp32 full width ({n_params:,} "
          f"parameters), B={TRAIN_B} S={TRAIN_S}, {TRAIN_STEPS} steps "
          f"through launch.train: losses {run['losses']} (== the "
          f"whole-tree update's in this run, bit for bit), grad norms "
          f"{[round(x, 3) for x in run['grad_norms']]}; per step "
          f"{per_step[-1]['launches']} by route {per_step[-1]['routes']}; "
          f"step ms {[round(s['ms'], 1) for s in per_step]} (median of "
          f"steps 2-{TRAIN_STEPS} {out['step_ms']:.1f}, "
          f"{out['tokens_per_s']:.0f} tokens/s); peak {out['peak_gb']:.1f} "
          f"GB", flush=True)

    # 2. the same step with the kernels and with the plain versions, from
    # the trained weights and the next batch
    params = run["params"]
    del run
    batch = step_batch(cfg, DataConfig(cfg.vocab_size, TRAIN_S, TRAIN_B,
                                       seed=SEED), TRAIN_STEPS, dev)
    layer0: dict = {}
    with capture_first_flash(layer0):
        loss_k, grads_k = loss_and_grads(params, cfg, batch)
    with plain_training():
        loss_p, grads_p = loss_and_grads(params, cfg, batch)
    rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    if rel > TRAIN_LOSS_RTOL:
        raise AssertionError(f"train loss kernels {float(loss_k)} vs plain "
                             f"{float(loss_p)}: rel {rel}")
    out["loss_rel_err_vs_plain"] = rel
    out["grad_err_vs_plain"] = leaf_error(grads_k, grads_p, TRAIN_GRAD_BAR,
                                          what="train gradient")
    del grads_k, grads_p, params, batch
    torch.cuda.empty_cache()
    print(f"[train-lm] one step's loss with the kernels == with the plain "
          f"versions on the card: rel err {rel:.3e} (bar "
          f"{TRAIN_LOSS_RTOL}); gradients: largest error "
          f"{out['grad_err_vs_plain']:.3e} of a leaf's scale (bar "
          f"{TRAIN_GRAD_BAR})", flush=True)

    # 3. the backward kernel against its plain version, twice each
    if "do" not in layer0:
        raise AssertionError("layer 0's flash_attention output got no "
                             "gradient")
    rng = np.random.default_rng(SEED)
    q0, k0, v0 = layer0["q"], layer0["k"], layer0["v"]
    o0, lse0 = fa.flash_attention_cuda(q0, k0, v0, with_lse=True,
                                       **layer0["kw"])
    errs = {"layer 0 of the step": bwd_check(
        "layer 0", (q0, k0, v0, o0, layer0["do"].contiguous(), lse0),
        layer0["kw"].get("causal", True), layer0["kw"].get("scale"))}
    for label, shape, causal in BWD_CASES:
        errs[f"{label} {shape}{'' if causal else ' non-causal'}"] = \
            bwd_check(label, bwd_inputs(rng, shape, causal, dev), causal)
    # a row that saw no key: lse -inf, its output 0 (as the kernel writes)
    q, k, v, o, do, lse = bwd_inputs(rng, (1, 64, 64, 4, 2, 64, 64), True,
                                     dev)
    lse[0, 1, 5] = -float("inf")
    o[0, 5, 1] = 0.0
    errs["a fully masked row"] = bwd_check("masked row",
                                           (q, k, v, o, do, lse), True)
    dq = fa.flash_attention_bwd_cuda(q, k, v, o, do, lse, causal=True)[0]
    if dq[0, 5, 1].abs().max() != 0:
        raise AssertionError("a fully masked row got a gradient")
    out["bwd_err"] = errs
    print(f"[train-lm] flash_attention_bwd == its plain version (largest "
          f"error of dq, dk, dv as a share of its scale; bar {BWD_BAR}), "
          f"bit-equal run to run: " + ", ".join(
              f"{k}: {v:.2e}" for k, v in errs.items()), flush=True)
    # the SIMT forward on layer 0's inputs and at its tile boundaries
    out["fwd_err"] = simt_flash_checks(dev, layer0)
    print(f"[train-lm] flash_attention's SIMT forward == its plain version "
          f"(max abs err of the output, fp32 bar rtol/atol 2e-5, bf16 2 "
          f"ulps of the scale; the lse's error of its magnitude, bar "
          f"{LSE_BAR}), twice with its lse, bit-equal: " + ", ".join(
              f"{k}: {v['out']:.2e} / {v['lse']:.1e}"
              for k, v in out["fwd_err"].items()), flush=True)

    # 4. resume on the card at examples/train_lm.py's config
    small = train_lm.config()
    gen = torch.Generator(device=dev)

    def fresh():
        p = T.init_params(small, gen.manual_seed(SEED), torch.float32,
                          device=dev)
        return p, make_train_step(small, device=dev)[1](p)

    straight = steps_of(small, dev, *fresh(), 4, total=4)[:2]
    half = steps_of(small, dev, *fresh(), 2, total=4)[:2]
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    ckpt.save(2, half, TRAIN_CKPT)
    restored, step = ckpt.restore(fresh(), TRAIN_CKPT)
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    same_training_state("restored", restored, half)
    resumed = steps_of(small, dev, *restored, 2, start=step, total=4)[:2]
    same_training_state("resumed vs straight", resumed, straight)
    del straight, half, restored, resumed
    print(f"[train-lm] {small.name}: 4 steps straight == 2 steps, save, "
          f"restore, 2 steps, bit for bit (params and optimizer state)",
          flush=True)

    # 5. card against the CPU at the tiny config, and deepseek's smoke
    # config (MLA, MoE, MTP) kernels against plain
    tiny = cfg.scaled(name="tiny-test", n_layers=2, d_model=64, n_heads=4,
                      n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256)
    cpu = torch.device("cpu")
    p_cpu = T.init_params(tiny, torch.Generator().manual_seed(SEED),
                          torch.float32, device="cpu")
    p_card = copy.deepcopy(p_cpu).to(dev)
    res = {}
    for key, d, p in (("cpu", cpu, p_cpu), ("card", dev, p_card)):
        res[key] = steps_of(tiny, d, p, make_train_step(tiny, device=d)[1](p),
                            5, lr=5e-3, B=4, S=64)
    out["card_vs_cpu_err"] = leaf_error(
        train_state(res["card"][0]), train_state(res["cpu"][0]),
        CARD_CPU_BAR, CARD_CPU_ATOL, "card vs CPU params after 5 steps")
    out["card_vs_cpu_losses"] = {k: v[2] for k, v in res.items()}
    deep = smoke_config("deepseek-v3-671b")
    p = T.init_params(deep, gen.manual_seed(SEED), torch.float32,
                      device=dev)
    db = step_batch(deep, DataConfig(deep.vocab_size, 64, 4, seed=SEED), 0,
                    dev)
    zero_counts()
    lk, gk = loss_and_grads(p, deep, db)
    deep_launches = read_counts()[0]
    with plain_training():
        lp, gp = loss_and_grads(p, deep, db)
    drel = abs(float(lk) - float(lp)) / abs(float(lp))
    if drel > TRAIN_LOSS_RTOL or deep_launches.get(
            "flash_attention_bwd", 0) != deep.n_layers:
        raise AssertionError(f"deepseek smoke: loss rel err {drel}, "
                             f"launches {deep_launches}")
    out["deepseek_smoke"] = {"loss_rel_err": drel, "launches": deep_launches,
                             "grad_err": leaf_error(gk, gp, TRAIN_GRAD_BAR,
                                                    what="deepseek smoke")}
    print(f"[train-lm] tiny config, 5 steps: card == CPU port within "
          f"{out['card_vs_cpu_err']:.2e} of a leaf's scale (bar "
          f"{CARD_CPU_BAR} + {CARD_CPU_ATOL}); losses card "
          f"{[round(x, 5) for x in res['card'][2]]}, CPU "
          f"{[round(x, 5) for x in res['cpu'][2]]}; deepseek-v3 smoke (MLA "
          f"D = 48 / Dv = 32, MoE, MTP) one step: launches {deep_launches}, "
          f"loss rel err {drel:.2e}, gradients "
          f"{out['deepseek_smoke']['grad_err']:.2e} of a leaf's scale vs "
          f"plain", flush=True)
    del res, p_cpu, p_card, p, gk, gp

    # 6. times (CUDA events; the profiler's split comes in phase 14)
    B, Sq, Sk, H, K, D, Dv = BWD_CASES[0][1]
    args = bwd_inputs(rng, BWD_CASES[0][1], True, dev)
    q, k, v, o, do, lse = args
    work = bwd_work(B, Sq, Sk, H, K, D, Dv)
    t = {"shape": f"q [{B}, {Sq}, {H}, {D}], k/v [{B}, {Sk}, {K}, {D}], "
                  f"causal, fp32"}
    t["bound_ms"], t["bound_by"] = bound_ms(work["bytes"], work["ops"])
    t["bytes_bound_ms"] = work["bytes"] / HBM_BYTES_PER_S * 1e3
    t["ops_bound_ms"] = work["ops"] / FP32_OPS_PER_S * 1e3
    t["ms"] = cuda_ms(lambda: fa.flash_attention_bwd_cuda(*args))
    t["plain_ms"] = cuda_ms(lambda: fa.flash_attention_bwd_ref(*args),
                            reps=5)
    t["fwd_lse_ms"] = cuda_ms(lambda: fa.flash_attention_cuda(
        q, k, v, with_lse=True))
    qs, ks, vs = (a.transpose(1, 2).contiguous().requires_grad_()
                  for a in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                              enable_gqa=True)
    dos = do.transpose(1, 2).contiguous()
    t["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
        sdpa_out, (qs, ks, vs), dos, retain_graph=True))

    # the fp32 forward (the SIMT route: TF32 stays off) beside SDPA's fp32
    # forward on the same inputs, a yardstick the port never calls
    def sdpa_fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                  enable_gqa=True)

    fwork = flash_work(B, Sq, Sk, H, K, D, Dv, 4)
    t["fwd_bound_ms"], t["fwd_bound_by"] = bound_ms(fwork["bytes"],
                                                    fwork["ops"])
    t["fwd_design_ops"] = flash_design_ops(B, Sq, Sk, H, D, Dv)
    t["fwd_design_ops_ms"] = t["fwd_design_ops"] / FP32_OPS_PER_S * 1e3
    t["fwd_library_ms"] = cuda_ms(sdpa_fwd)
    t["fwd_plain_ms"] = cuda_ms(lambda: fa.flash_attention_ref_lse(q, k, v),
                                reps=5)

    # SDPA's memory-efficient backend, forced: it takes fp32 but no
    # enable_gqa, so K and V are expanded to H heads outside the timed calls
    # (a yardstick the port never calls)
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qe = qs.detach().clone().requires_grad_()
    ke, ve = (a.repeat_interleave(H // K, dim=2).transpose(1, 2)
              .contiguous().requires_grad_() for a in (k, v))

    def eff_fwd():
        with torch.no_grad(), sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(qe, ke, ve, is_causal=True)

    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        eff_out = F.scaled_dot_product_attention(qe, ke, ve, is_causal=True)

    def eff_bwd():
        return torch.autograd.grad(eff_out, (qe, ke, ve), dos,
                                   retain_graph=True)

    t["fwd_efficient_max_abs_diff"] = float(
        (eff_fwd().transpose(1, 2) - fa.flash_attention_cuda(q, k, v))
        .abs().max())
    t["fwd_efficient_ms"] = cuda_ms(eff_fwd)
    t["efficient_ms"] = cuda_ms(eff_bwd)
    out["timing"] = t
    out["prof_fns"] = {
        "bwd": lambda: fa.flash_attention_bwd_cuda(*args),
        "sdpa_bwd": lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), dos,
                                                retain_graph=True),
        "fwd": lambda: fa.flash_attention_cuda(q, k, v, with_lse=True),
        "sdpa_fwd": sdpa_fwd}
    out["efficient_fns"] = {"fwd": eff_fwd, "bwd": eff_bwd}
    print(f"[time] train-lm flash_attention_bwd at {t['shape']}: "
          f"{t['ms']:.4f} ms a call (bound {t['bound_ms']:.4f} ms by "
          f"{t['bound_by']}: bytes {t['bytes_bound_ms']:.4f}, operations "
          f"{t['ops_bound_ms']:.4f}), plain {t['plain_ms']:.3f} ms, SDPA's "
          f"backward {t['library_ms']:.4f} ms; the forward with lse "
          f"{t['fwd_lse_ms']:.4f} ms a call (bound {t['fwd_bound_ms']:.4f} "
          f"ms by {t['fwd_bound_by']}; the design's "
          f"{t['fwd_design_ops'] / 1e9:.2f} GFLOP "
          f"{t['fwd_design_ops_ms']:.4f}), plain {t['fwd_plain_ms']:.3f} "
          f"ms, SDPA's fp32 forward {t['fwd_library_ms']:.4f}; SDPA's "
          f"memory-efficient backend (K/V expanded to {H} heads) forward "
          f"{t['fwd_efficient_ms']:.4f} (max abs diff from the kernel "
          f"{t['fwd_efficient_max_abs_diff']:.2e}), backward "
          f"{t['efficient_ms']:.4f}", flush=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[train-lm] phase 17 in {out['phase_s']:.1f} s", flush=True)
    return out


def efficient_sdpa_profile(train: dict) -> None:
    """Phase 17's SDPA forced to its memory-efficient backend under
    torch.profiler: the device ms of the forward and of the backward, and
    the backend that ran (:func:`library_profile`); a yardstick the port
    never calls, profiled last in phase 14 so that it disturbs no other
    profile."""
    fns, t = train.pop("efficient_fns"), train["timing"]
    for part, key in (("fwd", "fwd_efficient"), ("bwd", "efficient")):
        (t[f"{key}_device_ms"], t[f"{key}_backend"],
         t[f"{key}_device_ms_by_kernel"]) = library_profile(fns[part])
    print(f"[time] train-lm SDPA forced to its memory-efficient backend at "
          f"{t['shape']} (K/V expanded to the query heads): forward "
          f"{fmt(t['fwd_efficient_device_ms'])} ms on the device "
          f"({t['fwd_efficient_backend']}: "
          f"{t['fwd_efficient_device_ms_by_kernel']}), backward "
          f"{fmt(t['efficient_device_ms'])} ({t['efficient_backend']}: "
          f"{t['efficient_device_ms_by_kernel']}); the port's SIMT forward "
          f"{t['fwd_lse_device_ms']:.4f}, its backward "
          f"{t['device_ms']:.4f}", flush=True)


def lm_train_profile(train: dict, dev: torch.device) -> None:
    """Phase 17's step under torch.profiler, its weights drawn again: wall
    and device-busy ms, the idle share and the device time by part
    (products, flash_attention forward, its backward, the rest), with the
    CE chunks (forward and backward) and the optimizer (clip and AdamW)
    each profiled alone; the backward kernel's and SDPA's backward's
    device ms."""
    fns = train.pop("prof_fns")
    t = train["timing"]
    per = recorded_profile(fns["bwd"], "flash_attention_bwd")[-1][2]
    t["device_ms"] = sum(v for k, v in per.items()
                         if "flash_attention_bwd" in k)
    t["device_ms_by_kernel"] = {k: v for k, v in per.items()
                                if "flash_attention_bwd" in k}
    t["library_device_ms"], t["library_backend"], _ = library_profile(
        fns["sdpa_bwd"])
    per = recorded_profile(fns["fwd"], "flash_attention")[-1][2]
    t["fwd_lse_device_ms"] = sum(v for k, v in per.items()
                                 if "flash_attention" in k)
    t["fwd_library_device_ms"], t["fwd_library_backend"], per = (
        library_profile(fns["sdpa_fwd"]))
    print(f"[time] train-lm flash_attention's fp32 forward with lse at "
          f"{t['shape']}: {t['fwd_lse_device_ms']:.4f} ms on the device "
          f"({t['fwd_lse_device_ms'] / t['fwd_bound_ms']:.1f}x its "
          f"{t['fwd_bound_ms']:.4f} ms bound); SDPA's fp32 forward "
          f"{fmt(t['fwd_library_device_ms'])} "
          f"({t['fwd_library_backend']}: {per})", flush=True)
    del fns
    cfg = get_arch(TRAIN_ARCH)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED), torch.float32, device=dev)
    step_fn, init_opt = make_train_step(cfg, device=dev)
    state = {"p": params, "o": init_opt(params)}
    dcfg = DataConfig(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=SEED)
    batch = step_batch(cfg, dcfg, 0, dev)

    def step():
        state["p"], state["o"], _ = step_fn(state["p"], state["o"], batch)

    busy, wall, _ = device_profile(step, reps=1, host=False)
    parts = {"products": 0.0, "flash_attention": 0.0,
             "flash_attention_bwd": 0.0, "other": 0.0}
    for n, v in busy.items():
        key = ("flash_attention_bwd" if "flash_attention_bwd" in n else
               "flash_attention" if "flash_attention" in n else
               "products" if matmul_kernel(n) else "other")
        parts[key] += v
    total = sum(busy.values())
    prof = {"wall_ms": wall, "device_busy_ms": total,
            "device_idle_share": 1.0 - total / wall, "split_ms": parts}
    h = torch.randn((TRAIN_B, TRAIN_S, cfg.d_model), device=dev,
                    requires_grad=True)
    named = trainable(state["p"])
    head = [h, named["out_norm"], named["unembed"]]

    def ce():
        with bl_train.fp32_products():
            loss = T.chunked_ce(state["p"], cfg, h, batch["labels"])
            torch.autograd.grad(loss, head)

    busy, _, _ = device_profile(ce, reps=1, host=False)
    prof["ce_chunks_alone_ms"] = sum(busy.values())
    _, grads = loss_and_grads(state["p"], cfg, batch)
    prof["optimizer_alone_ms"] = optimizer_alone(dev, state["p"], state["o"],
                                                 grads, host=False)
    train["profile"] = prof
    print(f"[time] train-lm step under the profiler: wall {wall:.1f} ms, "
          f"device busy {total:.1f} ms, idle share "
          f"{prof['device_idle_share']:.3f}; device ms by part " + ", ".join(
              f"{k} {v:.2f}" for k, v in parts.items()) +
          f"; alone: the CE chunks (forward + backward) "
          f"{prof['ce_chunks_alone_ms']:.2f} ms, the optimizer (clip + "
          f"AdamW leaf by leaf) {prof['optimizer_alone_ms']:.2f} ms; "
          f"flash_attention_bwd {t['device_ms']:.4f} ms on the device "
          f"({t['device_ms_by_kernel']}), SDPA's backward "
          f"{fmt(t['library_device_ms'])} ({t['library_backend']})",
          flush=True)
    del state, grads, params, h, named, head
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- 18 ---
# Mamba training at full width: mamba2-2.7b in fp32 through the train CLI,
# all 64 layers (2,831,296,000 parameters: 45.3 GB of params, gradients
# and moments under the update that frees as it goes)
MAMBA_TRAIN_ARCH = "mamba2-2.7b"
# bars of the phase: the loss with kernels against the plain versions
# (relative); every gradient leaf against the plain versions' (of the
# leaf's scale): the Mamba leaves' gradients are ill-conditioned in fp32
# (tests/test_torch_train_mamba.py: JAX's own is 2.3e-5 of A_log's scale
# from float64 at smoke width), and at full width the decay cumsum reaches
# -64 at Q = 256 in every one of 64 layers (measured: A_log up to 2.2e-4);
# the backward kernel's four gradients: no farther from a float64 run of
# the plain version than twice the fp32 plain version is, plus
# SSD_BWD_FLOOR of the scale (the CPU tests' bar; kernel and plain sum up
# to 256 x 128 terms in other orders, and da is a reverse cumsum whose
# terms cancel: on layer 0's trained inputs kernel and plain part by
# 7.8e-5 of da's scale); params after 5 smoke steps, card against the
# CPU port (of each leaf's scale, plus 1e-7)
MAMBA_LOSS_RTOL = 1e-5
MAMBA_GRAD_BAR = 1e-3
SSD_BWD_FLOOR = 1e-6
# the tensor-core backward against its rounding replayed in PyTorch, in
# bf16 ulps of each gradient's scale: the two differ only in the order of
# fp32 sums and in exp's last bits (so, now and then, in the way an
# operand's bf16 rounding goes), and both store bf16; the forward's bar
# (ssd_close)
SSD_BWD_SM90_ULPS = 2
MAMBA_CARD_CPU_BAR = 1e-4
# the backward kernel against its plain version: the training shape, the
# CPU tests' shapes (tests/test_torch_ssd_backward.py::SHAPES: Q in {1, 7,
# 32, 256}, odd P and N), a ragged chunk at full width, and P, N over one
# tile: (label, (B, nc, Q, H, P, N))
SSD_BWD_CASES = (
    ("the training shape", (8, 1, 256, 80, 64, 128)),
    ("Q = 1", (1, 2, 1, 2, 3, 5)),
    ("Q = 7", (2, 2, 7, 3, 5, 3)),
    ("Q = 32", (1, 3, 32, 2, 9, 7)),
    ("Q = 256, odd P, N", (1, 2, 256, 2, 17, 9)),
    ("ragged Q = 200 at full width", (2, 2, 200, 80, 64, 128)),
    ("P = 130, N = 70 (ragged tiles)", (1, 2, 100, 3, 130, 70)))
MAMBA_CKPT = ROOT / "build" / "mamba_resume_ckpt"


def counted_cli(argv: list) -> tuple[dict, list]:
    """``launch.train.main(argv)`` with the launch and route counts zeroed
    just before and read just after each step; returns the run and each
    step's ``{"launches", "routes", "ms"}``."""
    per_step = []
    real_make = train_cli.make_train_step

    def counted_make(cfg_, **kw):
        step, init = real_make(cfg_, **kw)

        def counted(params, opt_state, batch):
            zero_counts()
            t0 = time.perf_counter()
            res = step(params, opt_state, batch)
            launched, routes = read_counts()
            per_step.append({"launches": launched, "routes": routes,
                             "ms": (time.perf_counter() - t0) * 1e3})
            return res
        return counted, init

    train_cli.make_train_step = counted_make
    try:
        run = train_cli.main(argv)
    finally:
        train_cli.make_train_step = real_make
    return run, per_step


class PlainSsd(torch.autograd.Function):
    """ssd_chunk's plain versions with a gradient, on any device:
    ``ssd_chunk_ref`` forward, ``ssd_chunk_bwd_ref`` backward."""

    @staticmethod
    def forward(ctx, xbar, a, Bm, Cm):
        ctx.save_for_backward(xbar, a, Bm, Cm)
        return ssd_chunk_ref(xbar, a, Bm, Cm)

    @staticmethod
    def backward(ctx, dy, dstates):
        return ssd_mod.ssd_chunk_bwd_ref(*ctx.saved_tensors, dy.contiguous(),
                                         dstates.contiguous())


@contextlib.contextmanager
def capture_first_ssd(store: dict):
    """Record the first ``ops.ssd_chunk`` call's inputs and the gradients
    that reach its two outputs (layer 0 of the step)."""
    real = ops.ssd_chunk

    def keep(name: str, like: torch.Tensor):
        # an output the loss does not reach (the states of a sequence of
        # one chunk) gets no gradient: zeros, as the Function's backward
        # sees it; the hook returns None (the gradient is not replaced)
        def hook(g):
            store.setdefault(name, torch.zeros_like(like) if g is None
                             else g.clone())
        return hook

    def wrapped(*args):
        y, st = real(*args)
        if "args" not in store:
            store["args"] = [t.detach().clone() for t in args]
            y.register_hook(keep("dy", y))
            st.register_hook(keep("dst", st))
        return y, st

    ops.ssd_chunk = wrapped
    try:
        yield
    finally:
        ops.ssd_chunk = real


def ssd_bwd_inputs(rng, shape, dev, dtype=torch.float32) -> list:
    """Random xbar, a, B, C (``ssd_inputs``) and dy, dstates in ``dtype``
    on the card."""
    B, nc, Q, H, P, N = shape
    return ssd_inputs(rng, shape, dtype, dev) + [
        torch.as_tensor(rng.normal(size=sh).astype(np.float32),
                        device=dev).to(dtype)
        for sh in ((B, nc, Q, H, P), (B, nc, H, P, N))]


def ssd_bwd_check(what: str, args: list) -> float:
    """The backward kernel of the route ``ssd_chunk.route`` names, twice
    (bit-equal: no atomics).  SIMT: held to a float64 run of its plain
    version on the same values, each gradient no farther from it than
    twice the plain version (fp32 inside, in the inputs' dtype) is, plus
    ``SSD_BWD_FLOOR`` of its scale for fp32 inputs and ``BF16_FLOOR`` for
    bf16 (half a bf16 ulp: the bf16 CPU tests' bar,
    tests/test_torch_ssd_backward_bf16.py).  Tensor cores (bf16 at P =
    64, N in {64, 128}): within ``SSD_BWD_SM90_ULPS`` bf16 ulps of each
    gradient's scale of ``ssd_chunk_bwd_sm90_replay`` (its rounding of W
    and dS replayed), and no farther from float64 than twice the replay
    is, plus ``BF16_FLOOR`` of its scale (the bar the CPU tests hold the
    replay to against JAX).  Returns the largest error against the plain
    version (SIMT) or the replay (tensor cores) as a share of each
    gradient's scale."""
    B, nc, Q, H, P = args[0].shape
    sm90 = ssd_mod.route(args[0].dtype, Q, P, args[2].shape[-1]) == "sm90"
    floor = SSD_BWD_FLOOR if args[0].dtype == torch.float32 else BF16_FLOOR
    got = ssd_mod.ssd_chunk_bwd_cuda(*args)
    again = ssd_mod.ssd_chunk_bwd_cuda(*args)
    want = (ssd_mod.ssd_chunk_bwd_sm90_replay if sm90
            else ssd_mod.ssd_chunk_bwd_ref)(*args)
    exact = ssd_mod.ssd_chunk_bwd_ref(*(t.double() for t in args))
    worst = 0.0
    for name, g, a, w, e in zip(("dxbar", "da", "dBm", "dCm"), got, again,
                                want, exact):
        if not torch.equal(g, a):
            raise AssertionError(f"ssd_chunk_bwd {what}: {name} differs "
                                 f"from run to run")
        scale = float(e.abs().max())
        err = float((g.double() - e).abs().max())
        ref_err = float((w.double() - e).abs().max())
        if (not torch.isfinite(g).all()
                or err > 2 * ref_err + floor * scale):
            raise AssertionError(
                f"ssd_chunk_bwd {what} {name}: {err} from float64, the "
                f"{'replay' if sm90 else 'plain version'} {ref_err}, at "
                f"scale {scale}")
        off = float((g.float() - w.float()).abs().max())
        if sm90 and off > SSD_BWD_SM90_ULPS * bf16_ulp(scale):
            raise AssertionError(
                f"ssd_chunk_bwd_sm90 {what} {name}: {off} from the replay, "
                f"over {SSD_BWD_SM90_ULPS} bf16 ulps of its scale {scale}")
        if scale:
            worst = max(worst, off / scale)
    return worst


def mamba_layers(cfg) -> tuple[int, int]:
    """(Mamba layers, attention layers) of ``cfg``'s plan."""
    prefix, period, n_rep = T.layer_plan(cfg)
    specs = list(prefix) + list(period) * n_rep
    n_mamba = sum(s.mixer == "mamba" for s in specs)
    return n_mamba, len(specs) - n_mamba


def mamba_train_phase(dev: torch.device) -> dict:
    """Phase 18: Mamba training on the card (see the module docstring)."""
    out: dict = {}
    t_phase = time.perf_counter()
    cfg = get_arch(MAMBA_TRAIN_ARCH)
    n_mamba = mamba_layers(cfg)[0]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    # 1. full width and depth through the CLI, counts around each step
    run, per_step = counted_cli([
        "--arch", MAMBA_TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch",
        str(TRAIN_B), "--seq", str(TRAIN_S), "--log-every", "1"])
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    want = ({"ssd_chunk": 2 * n_mamba, "ssd_chunk_bwd": n_mamba},
            {"ssd_chunk": 2 * n_mamba})
    for i, s in enumerate(per_step):
        if (s["launches"], s["routes"]) != want:
            raise AssertionError(
                f"mamba train step {i}: launches {s['launches']} by route "
                f"{s['routes']}, want {want} (the forward and its remat "
                f"recompute on the SIMT route, one backward a layer)")
    if not all(np.isfinite(run["losses"])):
        raise AssertionError(f"mamba train losses {run['losses']}")
    n_params = sum(p.numel() for p in run["params"].parameters())
    steady = [s["ms"] for s in per_step[1:]]
    out.update(arch=MAMBA_TRAIN_ARCH, layers=cfg.n_layers, params=n_params,
               losses=run["losses"], grad_norms=run["grad_norms"],
               per_step=per_step, step_ms=statistics.median(steady),
               launches_per_step=per_step[-1]["launches"],
               routes_per_step=per_step[-1]["routes"])
    out["tokens_per_s"] = TRAIN_B * TRAIN_S / out["step_ms"] * 1e3
    print(f"[train-mamba] {MAMBA_TRAIN_ARCH} fp32 full width and depth "
          f"({cfg.n_layers} layers, {n_params:,} parameters), B={TRAIN_B} "
          f"S={TRAIN_S}, {TRAIN_STEPS} steps through launch.train: losses "
          f"{[round(x, 4) for x in run['losses']]}, grad norms "
          f"{[round(x, 3) for x in run['grad_norms']]}; per step "
          f"{per_step[-1]['launches']} by route {per_step[-1]['routes']}; "
          f"step ms {[round(s['ms'], 1) for s in per_step]} (median of "
          f"steps 2-{TRAIN_STEPS} {out['step_ms']:.1f}, "
          f"{out['tokens_per_s']:.0f} tokens/s); peak {out['peak_gb']:.2f} "
          f"GB", flush=True)

    # 2. the next step with the kernels and with the plain versions, from
    # the trained weights (the optimizer state freed first)
    params = run["params"]
    del run
    torch.cuda.empty_cache()
    batch = step_batch(cfg, DataConfig(cfg.vocab_size, TRAIN_S, TRAIN_B,
                                       seed=SEED), TRAIN_STEPS, dev)
    layer0: dict = {}
    with capture_first_ssd(layer0):
        loss_k, grads_k = loss_and_grads(params, cfg, batch)
    with plain_training():
        loss_p, grads_p = loss_and_grads(params, cfg, batch)
    rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    if rel > MAMBA_LOSS_RTOL:
        raise AssertionError(f"mamba train loss kernels {float(loss_k)} vs "
                             f"plain {float(loss_p)}: rel {rel}")
    out["loss_rel_err_vs_plain"] = rel
    worst = {k: float((grads_k[k] - g).abs().max() / g.abs().max())
             for k, g in grads_p.items()}
    out["grad_err_vs_plain"] = leaf_error(grads_k, grads_p, MAMBA_GRAD_BAR,
                                          what="mamba train gradient")
    out["grad_err_worst_leaves"] = dict(sorted(
        worst.items(), key=lambda kv: -kv[1])[:4])
    del grads_k, grads_p, params, batch
    torch.cuda.empty_cache()
    print(f"[train-mamba] one step's loss with the kernels == with the plain "
          f"versions on the card: rel err {rel:.3e} (bar {MAMBA_LOSS_RTOL}); "
          f"gradients: largest error {out['grad_err_vs_plain']:.3e} of a "
          f"leaf's scale (bar {MAMBA_GRAD_BAR}); worst leaves "
          f"{ {k: f'{v:.2e}' for k, v in out['grad_err_worst_leaves'].items()} }",
          flush=True)

    # 3. the backward kernel against its plain version, twice each
    if "dy" not in layer0 or "dst" not in layer0:
        raise AssertionError("layer 0's ssd_chunk outputs got no gradient")
    rng = np.random.default_rng(SEED)
    errs = {"layer 0 of the step": ssd_bwd_check(
        "layer 0", [*layer0["args"], layer0["dy"].contiguous(),
                    layer0["dst"].contiguous()])}
    del layer0
    for label, shape in SSD_BWD_CASES:
        errs[f"{label} {shape}"] = ssd_bwd_check(
            label, ssd_bwd_inputs(rng, shape, dev))
    # decays whose cumsum reaches -64 at Q = 256
    args = ssd_bwd_inputs(rng, (1, 2, 256, 8, 64, 128), dev)
    args[1] = torch.full_like(args[1], -0.25)
    errs["cumsum to -64 (1, 2, 256, 8, 64, 128)"] = ssd_bwd_check("-64",
                                                                 args)
    out["bwd_err"] = errs
    print(f"[train-mamba] ssd_chunk_bwd == its plain version (each gradient "
          f"within twice the plain version's distance from float64 + "
          f"{SSD_BWD_FLOOR} of its scale; below, the largest error against "
          f"the fp32 plain version as a share of its scale), bit-equal run "
          f"to run: " + ", ".join(
              f"{k}: {v:.2e}" for k, v in errs.items()), flush=True)

    # 4. resume on the card at a narrow mamba2 (4 layers, d_model 256, Q =
    # 256, two chunks a row)
    small = cfg.scaled(name="mamba2-narrow", n_layers=4, d_model=256,
                       vocab_size=8192)
    gen = torch.Generator(device=dev)

    def fresh():
        p = T.init_params(small, gen.manual_seed(SEED), torch.float32,
                          device=dev)
        return p, make_train_step(small, device=dev)[1](p)

    kw = {"total": 4, "B": 2, "S": 512}
    straight = steps_of(small, dev, *fresh(), 4, **kw)[:2]
    half = steps_of(small, dev, *fresh(), 2, **kw)[:2]
    shutil.rmtree(MAMBA_CKPT, ignore_errors=True)
    ckpt.save(2, half, MAMBA_CKPT)
    restored, step = ckpt.restore(fresh(), MAMBA_CKPT)
    shutil.rmtree(MAMBA_CKPT, ignore_errors=True)
    same_training_state("mamba restored", restored, half)
    resumed = steps_of(small, dev, *restored, 2, start=step, **kw)[:2]
    same_training_state("mamba resumed vs straight", resumed, straight)
    del straight, half, restored, resumed
    print(f"[train-mamba] {small.name}: 4 steps straight == 2 steps, save, "
          f"restore, 2 steps, bit for bit (params and optimizer state)",
          flush=True)

    # 5. card against the CPU at mamba2's smoke config, 5 steps; jamba's
    # smoke config (Mamba, attention, MoE) kernels against plain
    smoke = smoke_config(MAMBA_TRAIN_ARCH)
    p_cpu = T.init_params(smoke, torch.Generator().manual_seed(SEED),
                          torch.float32, device="cpu")
    p_card = copy.deepcopy(p_cpu).to(dev)
    res = {}
    for key, d, p in (("cpu", torch.device("cpu"), p_cpu),
                      ("card", dev, p_card)):
        res[key] = steps_of(smoke, d, p, make_train_step(smoke, device=d)[1](
            p), 5, lr=5e-3, B=4, S=64)
    out["card_vs_cpu_err"] = leaf_error(
        train_state(res["card"][0]), train_state(res["cpu"][0]),
        MAMBA_CARD_CPU_BAR, CARD_CPU_ATOL,
        "mamba smoke card vs CPU params after 5 steps")
    out["card_vs_cpu_losses"] = {k: v[2] for k, v in res.items()}
    jamba = smoke_config("jamba-1.5-large-398b")
    jm, ja = mamba_layers(jamba)
    p = T.init_params(jamba, gen.manual_seed(SEED), torch.float32,
                      device=dev)
    jb = step_batch(jamba, DataConfig(jamba.vocab_size, 64, 4, seed=SEED), 0,
                    dev)
    zero_counts()
    lk, gk = loss_and_grads(p, jamba, jb)
    jamba_launches = read_counts()[0]
    with plain_training():
        lp, gp = loss_and_grads(p, jamba, jb)
    jrel = abs(float(lk) - float(lp)) / abs(float(lp))
    want = {"ssd_chunk": 2 * jm, "ssd_chunk_bwd": jm,
            "flash_attention": 2 * ja, "flash_attention_bwd": ja}
    if jrel > MAMBA_LOSS_RTOL or jamba_launches != want:
        raise AssertionError(f"jamba smoke: loss rel err {jrel}, launches "
                             f"{jamba_launches}, want {want}")
    out["jamba_smoke"] = {"loss_rel_err": jrel, "launches": jamba_launches,
                          "grad_err": leaf_error(gk, gp, MAMBA_GRAD_BAR,
                                                 what="jamba smoke")}
    print(f"[train-mamba] mamba2 smoke, 5 steps: card == CPU port within "
          f"{out['card_vs_cpu_err']:.2e} of a leaf's scale (bar "
          f"{MAMBA_CARD_CPU_BAR} + {CARD_CPU_ATOL}); losses card "
          f"{[round(x, 5) for x in res['card'][2]]}, CPU "
          f"{[round(x, 5) for x in res['cpu'][2]]}; jamba smoke ({jm} Mamba "
          f"and {ja} attention layers, MoE) one step: launches "
          f"{jamba_launches}, loss rel err {jrel:.2e}, gradients "
          f"{out['jamba_smoke']['grad_err']:.2e} of a leaf's scale vs plain",
          flush=True)
    del res, p_cpu, p_card, p, gk, gp

    # 6. times (CUDA events; the profiler's split comes in phase 14)
    shape = SSD_BWD_CASES[0][1]
    args = ssd_bwd_inputs(rng, shape, dev)
    work = ssd_bwd_work(*shape)
    t = {"shape": "xbar [{}, {}, {}, {}, {}], N = {}, fp32".format(*shape)}
    t["bound_ms"], t["bound_by"] = bound_ms(work["bytes"], work["ops"])
    t["bytes_bound_ms"] = work["bytes"] / HBM_BYTES_PER_S * 1e3
    t["ops_bound_ms"] = work["ops"] / FP32_OPS_PER_S * 1e3
    t["work"] = work
    t["ms"] = cuda_ms(lambda: ssd_mod.ssd_chunk_bwd_cuda(*args))
    t["plain_ms"] = cuda_ms(lambda: ssd_mod.ssd_chunk_bwd_ref(*args), reps=5)
    t["fwd_ms"] = cuda_ms(lambda: ssd_mod.ssd_chunk_cuda(*args[:4]))
    t["fwd_plain_ms"] = cuda_ms(lambda: ssd_chunk_ref(*args[:4]), reps=5)
    fwork = ssd_work(*shape, 4)
    t["fwd_bound_ms"], t["fwd_bound_by"] = bound_ms(fwork["bytes"],
                                                    fwork["ops"])
    t["fwd_design_ops"], t["design_ops"] = (fwork["ops_simt"],
                                            work["simt_ops"])
    # each kernel's device ms a call (the SIMT routes' launches: the
    # forward's prep and main kernels, the backward's five passes)
    for key, fn, name in (
            ("fwd_", lambda: ssd_mod.ssd_chunk_cuda(*args[:4]), "ssd_chunk"),
            ("", lambda: ssd_mod.ssd_chunk_bwd_cuda(*args), "ssd_bwd")):
        per = recorded_profile(fn, name)[-1][2]
        split = {re.search(r"(ssd_\w+?)_kernel", k).group(1): v
                 for k, v in per.items() if name in k}
        t[f"{key}device_ms_by_kernel"] = split
        t[f"{key}device_ms"] = sum(split.values())
    out["timing"] = t
    print(f"[time] train-mamba ssd_chunk_bwd at {t['shape']}: {t['ms']:.4f} "
          f"ms a call, {t['device_ms']:.4f} on the device (bound "
          f"{t['bound_ms']:.4f} ms by {t['bound_by']}: bytes "
          f"{t['bytes_bound_ms']:.4f}, operations {t['ops_bound_ms']:.4f}; "
          f"{t['device_ms'] / t['bound_ms']:.1f}x), plain "
          f"{t['plain_ms']:.3f} ms, no library call; by kernel " + ", ".join(
              f"{k} {v:.4f}" for k, v in t["device_ms_by_kernel"].items())
          + f"; the SIMT forward {t['fwd_ms']:.4f} ms a call, "
          f"{t['fwd_device_ms']:.4f} on the device (bound "
          f"{t['fwd_bound_ms']:.4f} ms by {t['fwd_bound_by']}; "
          f"{t['fwd_device_ms'] / t['fwd_bound_ms']:.1f}x), plain "
          f"{t['fwd_plain_ms']:.3f} ms; by kernel " + ", ".join(
              f"{k} {v:.4f}" for k, v in t["fwd_device_ms_by_kernel"].items()),
          flush=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[train-mamba] phase 18 in {out['phase_s']:.1f} s", flush=True)
    return out


def optimizer_alone(dev: torch.device, params, opt_state, grads,
                    host: bool = True) -> float:
    """Device ms of the step's update alone (``train.loop.apply_update``:
    clip and AdamW leaf by leaf) on ``grads`` (which it consumes) under
    the profiler (``device_profile``'s ``host``), once, without a warm
    call: the step just ran it."""
    _, update = adamw(lr=linear_warmup_cosine(3e-4, 100, TRAIN_STEPS),
                      b1=0.9, b2=0.95, weight_decay=0.1)
    named = trainable(params)
    busy, _, _ = device_profile(
        lambda: apply_update(named, grads, opt_state, update), reps=1,
        warm=False, host=host)
    return sum(busy.values())


def mamba_train_profile(train: dict, dev: torch.device) -> None:
    """Phase 18's step under torch.profiler, its weights drawn again: wall
    and device-busy ms, the idle share and the device time by part
    (products, ssd_chunk's forward, its backward, the rest) and the
    optimizer alone (the kernels' own device ms come from phase 18)."""
    t = train["timing"]
    cfg = get_arch(MAMBA_TRAIN_ARCH)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED), torch.float32, device=dev)
    step_fn, init_opt = make_train_step(cfg, device=dev)
    state = {"p": params, "o": init_opt(params)}
    batch = step_batch(cfg, DataConfig(cfg.vocab_size, TRAIN_S, TRAIN_B,
                                       seed=SEED), 0, dev)

    def step():
        state["p"], state["o"], _ = step_fn(state["p"], state["o"], batch)

    busy, wall, _ = device_profile(step, reps=1, host=False)
    parts = {"products": 0.0, "ssd_chunk": 0.0, "ssd_chunk_bwd": 0.0,
             "other": 0.0}
    for n, v in busy.items():
        key = ("ssd_chunk_bwd" if "ssd_bwd" in n else
               "ssd_chunk" if "ssd_chunk" in n else
               "products" if matmul_kernel(n) else "other")
        parts[key] += v
    total = sum(busy.values())
    prof = {"wall_ms": wall, "device_busy_ms": total,
            "device_idle_share": 1.0 - total / wall, "split_ms": parts}
    _, grads = loss_and_grads(state["p"], cfg, batch)
    prof["optimizer_alone_ms"] = optimizer_alone(dev, state["p"], state["o"],
                                                 grads, host=False)
    prof["elementwise_ms"] = parts["other"] - prof["optimizer_alone_ms"]
    train["profile"] = prof
    print(f"[time] train-mamba step under the profiler: wall {wall:.1f} ms, "
          f"device busy {total:.1f} ms, idle share "
          f"{prof['device_idle_share']:.3f}; device ms by part " + ", ".join(
              f"{k} {v:.2f}" for k, v in parts.items()) +
          f"; of the rest the optimizer (clip + AdamW leaf by leaf, alone) "
          f"{prof['optimizer_alone_ms']:.2f} ms and the elementwise passes "
          f"{prof['elementwise_ms']:.2f}; ssd_chunk_bwd {t['device_ms']:.4f} "
          f"ms on the device ({t['device_ms_by_kernel']})", flush=True)
    del state, grads, params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- 19 ---
# bf16 training at train_4k's sequence length (S = 4096; its batch cut
# from 256 to 2 sequences): tinyllama-1.1b and mamba2-2.7b at full width
# and depth, minicpm3-4b at full width cut to BF16_MLA_LAYERS layers (its
# MLA attention, D = 96 / Dv = 64, on the tensor-core forward and
# backward), jamba's smoke config; weights from the port's generator, in
# bf16
BF16_B, BF16_S, BF16_STEPS = 2, 4096, 4
BF16_ATTN_ARCH, BF16_MAMBA_ARCH, BF16_MLA_ARCH = (
    "tinyllama-1.1b", "mamba2-2.7b", "minicpm3-4b")
BF16_MLA_LAYERS, BF16_MLA_STEPS = 8, 2
# mamba2-2.7b's step held to an fp32 oracle at this depth (of 64 layers):
# the oracle's fp32 copy, its gradients and the plain versions' step at
# full depth would add ~20 s to the phase
BF16_MAMBA_ORACLE_LAYERS = 16
# half a bf16 ulp: the floor of the bf16 bars (tests/test_torch_*_bf16.py)
BF16_FLOOR = 2.0 ** -9
BF16_CKPT = ROOT / "build" / "bf16_resume_ckpt"
# the bf16 backward kernels against their plain versions beside layer 0's
# captured inputs: (label, (B, Sq, Sk, H, K, D, Dv), causal)
BWD_BF16_CASES = (
    ("ragged Sq = Sk = 200", (2, 200, 200, 32, 4, 64, 64), True),
    ("Sq < Sk causal", (2, 100, 300, 8, 2, 64, 64), True),
    ("Sq > Sk causal", (2, 300, 100, 8, 2, 64, 64), True),
    ("non-causal", (2, 256, 256, 8, 2, 64, 64), False),
    ("MQA (K = 1)", (2, 256, 256, 8, 1, 64, 64), True),
    ("D = Dv = 128", (1, 256, 256, 4, 4, 128, 128), True),
    ("D = 64, Dv = 128", (1, 130, 130, 4, 2, 64, 128), True),
    ("D = 128, Dv = 64 non-causal", (1, 130, 130, 4, 2, 128, 64), False),
    ("D = 96, Dv = 64 (minicpm3's MLA)", (2, 200, 200, 8, 8, 96, 64), True),
    ("D = 192, Dv = 128 (deepseek's MLA)", (1, 256, 256, 16, 16, 192, 128),
     True),
    ("D = Dv = 256 (gemma's)", (1, 130, 130, 4, 2, 256, 256), True),
    ("SIMT: D = Dv = 32 (jamba smoke)", (2, 64, 64, 4, 4, 32, 32), True),
    ("SIMT: D = 48, Dv = 32 (MLA at smoke width)", (2, 64, 64, 4, 4, 48, 32),
     True))
# the tensor-core pairs gained for MLA and gemma, timed forward and
# backward beside the SIMT kernels they replace, their plain versions and
# SDPA: (D, Dv) -> (B, S, H, K, whose shape): minicpm3 at train_4k's 2 x
# 4096 (layer 0 of phase 19's step), one row of deepseek's 4 x 2048
# prefill, gemma at 2 x 4096
PAIR_SHAPES = {(96, 64): (2, 4096, 40, 40, "minicpm3-4b at 2 x 4096"),
               (192, 128): (1, 2048, 128, 128,
                            "deepseek-v3-671b, one row of the prefill"),
               (256, 256): (2, 4096, 8, 1, "gemma-2b at 2 x 4096")}


def bwd_bf16_check(what: str, args: tuple, causal: bool, scale=None
                   ) -> float:
    """A bf16 backward kernel (the route ``flash_attention.route`` names)
    twice, bit-equal, against its plain version within ``BWD_BF16_BAR`` of
    each gradient's scale; the largest error as a share of its scale."""
    kw = {"causal": causal, "scale": scale}
    got = fa.flash_attention_bwd_cuda(*args, **kw)
    again = fa.flash_attention_bwd_cuda(*args, **kw)
    want = fa.flash_attention_bwd_ref(*args, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, again):
        if a.dtype != torch.bfloat16 or not torch.equal(a, b):
            raise AssertionError(f"bf16 backward {what}: {name} is {a.dtype} "
                                 f"or differs from run to run")
    return leaf_error(dict(zip(("dq", "dk", "dv"), got)),
                      dict(zip(("dq", "dk", "dv"), want)), BWD_BF16_BAR,
                      what=f"bf16 backward {what}")


def bf16_model(cfg, dev):
    return T.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         torch.bfloat16, device=dev)


def counted_steps(cfg, dev, n, params, B=BF16_B, S=BF16_S):
    """``n`` steps of ``make_train_step`` (JAX's defaults: lr 3e-4, warmup
    100) from ``params`` on ``batch_at_step``'s batches, the counts zeroed
    just before and read just after each step; returns (params, optimizer
    state, each step's {"launches", "routes", "ms"}, losses)."""
    step_fn, init_opt = make_train_step(cfg, total_steps=n, device=dev)
    opt = init_opt(params)
    dcfg = DataConfig(cfg.vocab_size, S, B, seed=SEED)
    per_step, losses = [], []
    for s in range(n):
        batch = step_batch(cfg, dcfg, s, dev)
        zero_counts()
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        launched, routes = read_counts()
        per_step.append({"launches": launched, "routes": routes,
                         "ms": (time.perf_counter() - t0) * 1e3})
    return params, opt, per_step, losses


def check_counts(what: str, per_step: list, want: tuple) -> None:
    for i, st in enumerate(per_step):
        if (st["launches"], st["routes"]) != want:
            raise AssertionError(f"{what} step {i}: launches "
                                 f"{st['launches']} by route {st['routes']}, "
                                 f"want {want}")


def rel_l2(a: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.double()
    return float((a.double() - ref).norm() / ref.norm().clamp_min(1e-300))


def bf16_run_line(what: str, cfg, run: dict) -> str:
    return (f"[train-bf16] {what} bf16 ({cfg.n_layers} layers, "
            f"{run['params']:,} parameters), B={BF16_B} S={BF16_S}, "
            f"{len(run['losses'])} steps through make_train_step: losses "
            f"{[round(x, 4) for x in run['losses']]}; per step "
            f"{run['launches_per_step']} by route {run['routes_per_step']}; "
            f"step ms {[round(x, 1) for x in run['step_ms_all']]} (median "
            f"of steps 2-{len(run['losses'])} {run['step_ms']:.1f}, "
            f"{run['tokens_per_s']:.0f} tokens/s); peak "
            f"{run['peak_gb']:.2f} GB")


def bf16_run(cfg, dev, n, want) -> tuple:
    """``counted_steps`` of a fresh bf16 model, the counts checked against
    ``want`` each step, the peak memory taken; returns (params, optimizer
    state, the run's record)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = bf16_model(cfg, dev)
    params, opt, per_step, losses = counted_steps(cfg, dev, n, params)
    check_counts(cfg.name, per_step, want)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{cfg.name} bf16 losses {losses}")
    ms = [st["ms"] for st in per_step]
    run = {"arch": cfg.name, "layers": cfg.n_layers, "losses": losses,
           "params": sum(p.numel() for p in params.parameters()),
           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "launches_per_step": per_step[-1]["launches"],
           "routes_per_step": per_step[-1]["routes"], "step_ms_all": ms,
           "step_ms": statistics.median(ms[1:])}
    run["tokens_per_s"] = BF16_B * BF16_S / run["step_ms"] * 1e3
    return params, opt, run


def oracle_step(cfg, params, batch, layer0: dict) -> dict:
    """One step's loss and gradients with the kernels (layer 0's attention
    inputs and output gradient captured into ``layer0``) and with their
    plain versions, each held to an fp32 oracle of the same bf16 params:
    the kernels' relative error of the loss and relative L2 of each
    gradient no more than twice the plain versions' plus ``BF16_FLOOR``."""
    with capture_first_flash(layer0):
        loss_k, grads_k = loss_and_grads(params, cfg, batch)
    with plain_training():
        loss_p, grads_p = loss_and_grads(params, cfg, batch)
    oracle_model = copy.deepcopy(params).float()
    loss_o, grads_o = loss_and_grads(oracle_model, cfg, batch)
    del oracle_model
    lo = float(loss_o)
    kern = {"loss": abs(float(loss_k) - lo) / abs(lo)}
    plain = {"loss": abs(float(loss_p) - lo) / abs(lo)}
    if kern["loss"] > 2 * plain["loss"] + BF16_FLOOR:
        raise AssertionError(f"{cfg.name} bf16 loss kernels "
                             f"{float(loss_k)}, plain {float(loss_p)}, fp32 "
                             f"oracle {lo}")
    worst = (0.0, "")
    for k, go in grads_o.items():
        dk, dp = rel_l2(grads_k[k], go), rel_l2(grads_p[k], go)
        if dk > 2 * dp + BF16_FLOOR:
            raise AssertionError(f"{cfg.name} bf16 gradient {k}: kernels "
                                 f"{dk:.3e} from the fp32 oracle, plain "
                                 f"{dp:.3e}")
        kern[k], plain[k] = dk, dp
        worst = max(worst, (dk / (2 * dp + BF16_FLOOR), k))
    del grads_k, grads_p, grads_o
    torch.cuda.empty_cache()
    return {"loss": {"kernels": float(loss_k), "plain": float(loss_p),
                     "fp32": lo},
            "kernels_max_dist": max(v for k, v in kern.items()
                                    if k != "loss"),
            "plain_max_dist": max(v for k, v in plain.items()
                                  if k != "loss"),
            "worst_ratio": worst[0], "worst_leaf": worst[1]}


def oracle_line(what: str, o: dict) -> str:
    return (f"[train-bf16] {what} one step against an fp32 oracle of the "
            f"same bf16 params: loss kernels {o['loss']['kernels']:.6f}, "
            f"plain {o['loss']['plain']:.6f}, fp32 {o['loss']['fp32']:.6f}; "
            f"gradients (relative L2 of each leaf): kernels at most "
            f"{o['kernels_max_dist']:.3e}, plain at most "
            f"{o['plain_max_dist']:.3e}; the closest to the bar (kernels <= "
            f"2 x plain + {BF16_FLOOR}) {o['worst_leaf']} at "
            f"{o['worst_ratio']:.2f} of it")


def sdpa_fns(q, k, v, do) -> tuple:
    """SDPA's forward and backward (causal; GQA where K < H) on q, k, v
    in [B, S, heads, D], a yardstick the port never calls, on its fused
    backends alone (flash, memory-efficient, cuDNN); where none takes Dv
    != D, v padded with zeros to D (and do with it).  Returns (forward,
    backward, padded)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    fused = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.CUDNN_ATTENTION]
    gqa = k.shape[2] != q.shape[2]
    D, Dv = q.shape[3], v.shape[3]
    for pad in (False, True):
        if pad and Dv == D:
            break
        qt, kt, vt, dt = (a.transpose(1, 2).contiguous()
                          for a in (q, k, v, do))
        if pad:
            vt, dt = F.pad(vt, (0, D - Dv)), F.pad(dt, (0, D - Dv))
        qt, kt, vt = (a.requires_grad_() for a in (qt, kt, vt))

        def fwd(qt=qt, kt=kt, vt=vt):
            with sdpa_kernel(fused):
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=gqa)

        try:
            with torch.no_grad():
                fwd()
            out = fwd()
        except RuntimeError:
            continue

        def bwd(out=out, qt=qt, kt=kt, vt=vt, dt=dt):
            return torch.autograd.grad(out, (qt, kt, vt), dt,
                                       retain_graph=True)

        bwd()
        return torch.no_grad()(fwd), bwd, pad
    raise AssertionError(f"no fused SDPA backend takes D={D}, Dv={Dv} "
                         f"(even with v padded)")


def pair_timing(dev: torch.device) -> dict:
    """At each pair of ``PAIR_SHAPES`` (causal bf16, random inputs from a
    seeded generator on the card: numpy's normals for these ~10^8 values
    took seconds of the script's time): the tensor-core forward and
    backward held to their plain versions (2 bf16 ulps of the output's
    scale; ``BWD_BF16_BAR`` of each gradient's, bit-equal run to run) and
    timed (CUDA events) beside the SIMT kernels these pairs took before,
    on the same inputs, the plain versions and SDPA; the bounds of each.
    The profiler's device ms come in 14."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    res: dict = {"prof_fns": {}}
    for (D, Dv), (B, S, H, K, whose) in PAIR_SHAPES.items():
        q, k, v, do = (torch.randn(sh, generator=gen, device=dev,
                                   dtype=torch.bfloat16)
                       for sh in ((B, S, H, D), (B, S, K, D), (B, S, K, Dv),
                                  (B, S, H, Dv)))
        o, lse = fa.flash_attention_cuda(q, k, v, with_lse=True)
        args = (q, k, v, o, do, lse)
        key = f"{D}/{Dv}"
        r = {"shape": f"q [{B}, {S}, {H}, {D}], k [{B}, {S}, {K}, {D}], v "
                      f"[.., {Dv}], causal, bf16 ({whose})"}
        want, want_lse = plain_flash_lse(q, k, v)
        r["fwd_max_abs_err"] = flash_close(f"flash_attention {key}", o, want)
        r["lse_err"] = lse_close(f"flash_attention {key}", lse, want_lse)
        del want, want_lse
        r["bwd_err"] = bwd_bf16_check(key, args, True)
        fwork = flash_work(B, S, S, H, K, D, Dv, 2)
        bwork = bwd_work_sm90(B, S, S, H, K, D, Dv)
        r["fwd_bound_ms"], r["fwd_bound_by"] = bound_ms(
            fwork["bytes"], fwork["ops"], BF16_OPS_PER_S)
        r["bwd_bound_ms"], r["bwd_bound_by"] = bound_ms(
            bwork["bytes"], bwork["ops"], BF16_OPS_PER_S)
        r["bwd_design_bound_ms"] = bwork["design_ops"] / BF16_OPS_PER_S * 1e3
        # bound to this pair's tensors, which stay alive for phase 14
        fwd = (lambda q=q, k=k, v=v: fa.flash_attention_cuda(q, k, v))
        bwd = (lambda a=args: fa.flash_attention_bwd_cuda(*a))
        r["fwd_ms"] = cuda_ms(fwd, reps=10)
        r["bwd_ms"] = cuda_ms(bwd, reps=5)
        r["fwd_simt_ms"] = cuda_ms(lambda: simt(fa, fwd), reps=2, warm=1)
        r["bwd_simt_ms"] = cuda_ms(lambda: simt(fa, bwd), reps=2, warm=1)
        r["fwd_plain_ms"] = cuda_ms(lambda: plain_flash(*args[:3]), reps=2,
                                    warm=1)
        r["bwd_plain_ms"] = cuda_ms(lambda: plain_bwd(*args), reps=2,
                                    warm=1)
        sfwd, sbwd, pad = sdpa_fns(q, k, v, do)
        r["library_padded_v"] = pad
        r["fwd_library_ms"] = cuda_ms(sfwd, reps=10)
        r["bwd_library_ms"] = cuda_ms(sbwd, reps=5)
        res[key] = r
        res["prof_fns"].update({f"pair {key} fwd": fwd,
                                f"pair {key} bwd": bwd,
                                f"pair {key} sdpa fwd": sfwd,
                                f"pair {key} sdpa bwd": sbwd})
        print(f"[time] train-bf16 pair {key} at {r['shape']}: forward "
              f"{r['fwd_ms']:.4f} ms (bound {r['fwd_bound_ms']:.4f} by "
              f"{r['fwd_bound_by']}; the SIMT kernel {r['fwd_simt_ms']:.3f}, "
              f"plain {r['fwd_plain_ms']:.3f}, SDPA {r['fwd_library_ms']:.4f}"
              f"), backward {r['bwd_ms']:.4f} ms (bound "
              f"{r['bwd_bound_ms']:.4f} by {r['bwd_bound_by']}, the design's "
              f"seven products {r['bwd_design_bound_ms']:.4f}; the SIMT "
              f"kernel {r['bwd_simt_ms']:.3f}, plain {r['bwd_plain_ms']:.3f}, "
              f"SDPA {r['bwd_library_ms']:.4f}" + (
                  ", v padded to D for SDPA" if pad else "") +
              f"); == plain: output {r['fwd_max_abs_err']:.3g}, lse "
              f"{r['lse_err']:.2e} of its magnitude, gradients "
              f"{r['bwd_err']:.2e} of their scale, bit-equal", flush=True)
        torch.cuda.empty_cache()
    return res


def bf16_train_phase(dev: torch.device) -> dict:
    """Phase 19: bf16 training on the card (see the module docstring)."""
    out: dict = {}
    t_phase = time.perf_counter()
    laps: dict = {}     # seconds into the phase at the end of each part
    rng = np.random.default_rng(SEED)

    # 1. tinyllama-1.1b, 22 layers, 2 x 4096: the tensor-core forward
    # with lse and the tensor-core backward
    cfg = get_arch(BF16_ATTN_ARCH)
    n = cfg.n_layers
    params, opt, run = bf16_run(cfg, dev, BF16_STEPS, (
        {"flash_attention": 2 * n, "flash_attention_bwd_sm90": n},
        {"flash_attention_sm90": 2 * n}))
    out["tinyllama"] = run
    print(bf16_run_line(BF16_ATTN_ARCH, cfg, run), flush=True)

    laps["tinyllama steps"] = time.perf_counter() - t_phase
    # 2. the next step with the kernels and with the plain versions, each
    # held to an fp32 oracle of the same bf16 params
    del opt
    torch.cuda.empty_cache()
    batch = step_batch(cfg, DataConfig(cfg.vocab_size, BF16_S, BF16_B,
                                       seed=SEED), BF16_STEPS, dev)
    layer0: dict = {}
    out["oracle"] = oracle_step(cfg, params, batch, layer0)
    del batch
    torch.cuda.empty_cache()
    print(oracle_line(BF16_ATTN_ARCH, out["oracle"]), flush=True)

    laps["tinyllama oracle"] = time.perf_counter() - t_phase
    # 3. the tensor-core backward against its plain version on layer 0's
    # inputs and the cases, twice each
    if "do" not in layer0:
        raise AssertionError("layer 0's flash_attention output got no "
                             "gradient")
    q0, k0, v0 = layer0["q"], layer0["k"], layer0["v"]
    kw0 = layer0["kw"]
    o0, lse0 = fa.flash_attention_cuda(q0, k0, v0, with_lse=True, **kw0)
    ro, rlse = fa.flash_attention_ref_lse(q0, k0, v0, **kw0)
    fin = torch.isfinite(rlse)
    out["lse_max_abs_err"] = float((lse0[fin] - rlse[fin]).abs().max())
    if (not torch.equal(torch.isfinite(lse0), fin)
            or out["lse_max_abs_err"] > 1e-4
            or not torch.equal(o0, fa.flash_attention_cuda(q0, k0, v0,
                                                           **kw0))):
        raise AssertionError(f"the tensor-core forward's lse: max abs err "
                             f"{out['lse_max_abs_err']} against the plain "
                             f"version, or its output moved")
    del ro, rlse
    errs = {"layer 0 of the step": bwd_bf16_check(
        "layer 0", (q0, k0, v0, o0, layer0["do"].contiguous(), lse0),
        kw0.get("causal", True), kw0.get("scale"))}
    args0 = (q0, k0, v0, o0, layer0["do"].contiguous(), lse0)
    del layer0
    for label, shape, causal in BWD_BF16_CASES:
        errs[f"{label} {shape}{'' if causal else ' non-causal'}"] = \
            bwd_bf16_check(label, bwd_inputs(rng, shape, causal, dev,
                                             torch.bfloat16), causal)
    out["bwd_err"] = errs
    print(f"[train-bf16] the bf16 backwards == their plain versions "
          f"(largest error of dq, dk, dv as a share of its scale; bar "
          f"{BWD_BF16_BAR}), bit-equal run to run: " + ", ".join(
              f"{k}: {v:.2e}" for k, v in errs.items()) +
          f"; the tensor-core forward's lse within "
          f"{out['lse_max_abs_err']:.2e} of the plain version's", flush=True)

    laps["tensor-core backward checks"] = time.perf_counter() - t_phase
    # 4. times of the tensor-core backward at layer 0's shape
    B, Sq, H, D = q0.shape
    Sk, K, Dv = k0.shape[1], k0.shape[2], v0.shape[3]
    work = bwd_work_sm90(B, Sq, Sk, H, K, D, Dv)
    t = {"shape": f"q [{B}, {Sq}, {H}, {D}], k/v [{B}, {Sk}, {K}, {D}], "
                  f"causal, bf16", "work": work}
    t["bound_ms"], t["bound_by"] = bound_ms(work["bytes"], work["ops"],
                                            BF16_OPS_PER_S)
    t["bytes_bound_ms"] = work["bytes"] / HBM_BYTES_PER_S * 1e3
    t["ops_bound_ms"] = work["ops"] / BF16_OPS_PER_S * 1e3
    t["design_ops_bound_ms"] = work["design_ops"] / BF16_OPS_PER_S * 1e3
    t["ms"] = cuda_ms(lambda: fa.flash_attention_bwd_cuda(*args0))
    t["plain_ms"] = cuda_ms(lambda: fa.flash_attention_bwd_ref(*args0),
                            reps=2, warm=1)
    t["fwd_lse_ms"] = cuda_ms(lambda: fa.flash_attention_cuda(
        q0, k0, v0, with_lse=True))
    t["fwd_ms"] = cuda_ms(lambda: fa.flash_attention_cuda(q0, k0, v0))
    qs, ks, vs = (a.transpose(1, 2).contiguous().requires_grad_()
                  for a in (q0, k0, v0))
    sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                              enable_gqa=True)
    dos = args0[4].transpose(1, 2).contiguous()
    t["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
        sdpa_out, (qs, ks, vs), dos, retain_graph=True))
    out["timing"] = t
    out["prof_fns"] = {
        "bwd": lambda: fa.flash_attention_bwd_cuda(*args0),
        "sdpa_bwd": lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), dos,
                                                retain_graph=True)}
    print(f"[time] train-bf16 flash_attention_bwd_sm90 at {t['shape']}: "
          f"{t['ms']:.4f} ms a call (bound {t['bound_ms']:.4f} ms by "
          f"{t['bound_by']}: bytes {t['bytes_bound_ms']:.4f}, five products "
          f"{t['ops_bound_ms']:.4f}; the design's seven "
          f"{t['design_ops_bound_ms']:.4f}), plain {t['plain_ms']:.3f} ms, "
          f"SDPA's bf16 backward {t['library_ms']:.4f} ms; the forward "
          f"with lse {t['fwd_lse_ms']:.4f} ms, without {t['fwd_ms']:.4f}",
          flush=True)

    laps["backward times"] = time.perf_counter() - t_phase
    # 5. a bf16 resume through a checkpoint, at examples/train_lm.py's
    # config (head size 64: the tensor-core routes)
    small = train_lm.config()
    gen = torch.Generator(device=dev)

    def fresh():
        p = T.init_params(small, gen.manual_seed(SEED), torch.bfloat16,
                          device=dev)
        return p, make_train_step(small, device=dev)[1](p)

    straight = steps_of(small, dev, *fresh(), 4, total=4)[:2]
    half = steps_of(small, dev, *fresh(), 2, total=4)[:2]
    shutil.rmtree(BF16_CKPT, ignore_errors=True)
    ckpt.save(2, half, BF16_CKPT)
    restored, step = ckpt.restore(fresh(), BF16_CKPT)
    shutil.rmtree(BF16_CKPT, ignore_errors=True)
    same_training_state("bf16 restored", restored, half)
    resumed = steps_of(small, dev, *restored, 2, start=step, total=4)[:2]
    same_training_state("bf16 resumed vs straight", resumed, straight)
    if next(resumed[0].parameters()).dtype != torch.bfloat16:
        raise AssertionError("the bf16 resume did not stay bf16")
    del straight, half, restored, resumed, params
    torch.cuda.empty_cache()
    print(f"[train-bf16] {small.name} in bf16: 4 steps straight == 2 steps, "
          f"save, restore, 2 steps, bit for bit (bf16 params, fp32 "
          f"moments)", flush=True)

    laps["bf16 resume"] = time.perf_counter() - t_phase
    # 6. mamba2-2.7b, 64 layers, 2 x 4096 (16 chunks a row): the
    # tensor-core forward and the tensor-core backward
    cfg = get_arch(BF16_MAMBA_ARCH)
    nm = mamba_layers(cfg)[0]
    params, opt, run = bf16_run(cfg, dev, BF16_STEPS, (
        {"ssd_chunk": 2 * nm, "ssd_chunk_bwd_sm90": nm},
        {"ssd_chunk_sm90": 2 * nm}))
    out["mamba2"] = run
    print(bf16_run_line(BF16_MAMBA_ARCH, cfg, run), flush=True)
    del opt
    torch.cuda.empty_cache()
    batch = step_batch(cfg, DataConfig(cfg.vocab_size, BF16_S, BF16_B,
                                       seed=SEED), BF16_STEPS, dev)
    layer0 = {}
    with capture_first_ssd(layer0):
        loss_and_grads(params, cfg, batch)
    del params, batch
    torch.cuda.empty_cache()
    if "dy" not in layer0 or "dst" not in layer0:
        raise AssertionError("layer 0's ssd_chunk outputs got no gradient")
    sargs = [*layer0.pop("args"), layer0.pop("dy").contiguous(),
             layer0.pop("dst").contiguous()]
    serrs = {"layer 0 of the step": ssd_bwd_check("bf16 layer 0", sargs)}
    for label, shape in SSD_BWD_CASES[1:]:
        args = ssd_bwd_inputs(rng, shape, dev, torch.bfloat16)
        route = ssd_mod.route(torch.bfloat16, shape[2], shape[4], shape[5])
        serrs[f"{label} {shape} ({route})"] = ssd_bwd_check(
            f"bf16 {label}", args)
        del args
    out["ssd_bwd_err"] = serrs
    print(f"[train-bf16] ssd_chunk_bwd on bf16, each case on its route: "
          f"the tensor cores within {SSD_BWD_SM90_ULPS} bf16 ulps of each "
          f"gradient's scale of the replay of their rounding and within "
          f"twice the replay's distance from float64 + {BF16_FLOOR} of the "
          f"scale; SIMT within twice the plain version's; bit-equal run to "
          f"run (below, the largest error against the replay or the plain "
          f"version as a share of its scale): " + ", ".join(
              f"{k}: {v:.2e}" for k, v in serrs.items()), flush=True)
    # the step at BF16_MAMBA_ORACLE_LAYERS layers held to an fp32 oracle
    # of the same params, as tinyllama's and minicpm3's are
    ocfg = cfg.scaled(n_layers=BF16_MAMBA_ORACLE_LAYERS)
    oparams = bf16_model(ocfg, dev)
    obatch = step_batch(ocfg, DataConfig(ocfg.vocab_size, BF16_S, BF16_B,
                                         seed=SEED), 0, dev)
    zero_counts()
    out["mamba2_oracle"] = oracle_step(ocfg, oparams, obatch, {})
    del oparams, obatch
    torch.cuda.empty_cache()
    print(oracle_line(f"{BF16_MAMBA_ARCH} cut to {BF16_MAMBA_ORACLE_LAYERS} "
                      f"layers", out["mamba2_oracle"]), flush=True)
    work = ssd_bwd_work(*sargs[0].shape[:5], sargs[2].shape[-1], itemsize=2)
    ts = {"shape": "xbar [{}, {}, {}, {}, {}], N = {}, bf16".format(
        *sargs[0].shape, sargs[2].shape[-1]), "work": work}
    ts["bound_ms"], ts["bound_by"] = bound_ms(work["bytes"], work["ops"],
                                              BF16_OPS_PER_S)
    ts["bytes_bound_ms"] = work["bytes"] / HBM_BYTES_PER_S * 1e3
    ts["ops_bound_ms"] = work["ops"] / BF16_OPS_PER_S * 1e3
    ts["design_ops_bound_ms"] = work["design_ops"] / BF16_OPS_PER_S * 1e3
    ts["fp32_core_ops_bound_ms"] = work["ops"] / FP32_OPS_PER_S * 1e3
    ts["ms"] = cuda_ms(lambda: ssd_mod.ssd_chunk_bwd_cuda(*sargs), reps=10)
    # the SIMT kernel (the route bf16 took before) on the same inputs
    ts["simt_ms"] = cuda_ms(lambda: simt(ssd_mod, ssd_mod.ssd_chunk_bwd_cuda,
                                         *sargs), reps=3, warm=1)
    ts["plain_ms"] = cuda_ms(lambda: ssd_mod.ssd_chunk_bwd_ref(*sargs),
                             reps=2, warm=1)
    out["ssd_timing"] = ts
    out["prof_fns"]["ssd_bwd"] = lambda: ssd_mod.ssd_chunk_bwd_cuda(*sargs)
    out["prof_fns"]["ssd_bwd_simt"] = lambda: simt(
        ssd_mod, ssd_mod.ssd_chunk_bwd_cuda, *sargs)
    print(f"[time] train-bf16 ssd_chunk_bwd_sm90 at {ts['shape']}: "
          f"{ts['ms']:.4f} ms a call (bound {ts['bound_ms']:.4f} ms by "
          f"{ts['bound_by']}: bytes {ts['bytes_bound_ms']:.4f}, operations "
          f"{ts['ops_bound_ms']:.4f} at the bf16 rate, the design's "
          f"{work['design_ops'] / 1e9:.1f} GFLOP "
          f"{ts['design_ops_bound_ms']:.4f}), was {ts['simt_ms']:.3f} ms "
          f"(the SIMT kernel on the same inputs), plain "
          f"{ts['plain_ms']:.3f} ms, no library call", flush=True)

    laps["mamba2 steps and checks"] = time.perf_counter() - t_phase
    # 7. minicpm3-4b at full width, BF16_MLA_LAYERS layers: the
    # tensor-core forward and backward at D = 96 / Dv = 64, the next step
    # held to an fp32 oracle as tinyllama's; then jamba's smoke config
    cfg = get_arch(BF16_MLA_ARCH).scaled(n_layers=BF16_MLA_LAYERS)
    n = cfg.n_layers
    params, opt, run = bf16_run(cfg, dev, BF16_MLA_STEPS, (
        {"flash_attention": 2 * n, "flash_attention_bwd_sm90": n},
        {"flash_attention_sm90": 2 * n}))
    out["minicpm3"] = run
    print(bf16_run_line(f"{BF16_MLA_ARCH} cut to {n} layers", cfg, run),
          flush=True)
    del opt
    torch.cuda.empty_cache()
    batch = step_batch(cfg, DataConfig(cfg.vocab_size, BF16_S, BF16_B,
                                       seed=SEED), BF16_MLA_STEPS, dev)
    layer0 = {}
    out["minicpm3_oracle"] = oracle_step(cfg, params, batch, layer0)
    print(oracle_line(f"{BF16_MLA_ARCH} cut to {n} layers",
                      out["minicpm3_oracle"]), flush=True)
    del params, batch
    torch.cuda.empty_cache()
    q0, k0, v0 = layer0["q"], layer0["k"], layer0["v"]
    kw0 = layer0["kw"]
    o0, lse0 = fa.flash_attention_cuda(q0, k0, v0, with_lse=True, **kw0)
    margs = (q0, k0, v0, o0, layer0.pop("do").contiguous(), lse0)
    out["mla_bwd_err"] = bwd_bf16_check(
        f"{BF16_MLA_ARCH} layer 0", margs, kw0.get("causal", True),
        kw0.get("scale"))
    del layer0, margs, q0, k0, v0, o0, lse0
    torch.cuda.empty_cache()
    print(f"[train-bf16] {BF16_MLA_ARCH} layer 0's tensor-core backward == "
          f"its plain version within {out['mla_bwd_err']:.2e} of each "
          f"gradient's scale (bar {BWD_BF16_BAR}), bit-equal", flush=True)
    jamba = smoke_config("jamba-1.5-large-398b")
    jm, ja = mamba_layers(jamba)
    p = bf16_model(jamba, dev)
    jb = step_batch(jamba, DataConfig(jamba.vocab_size, 64, 4, seed=SEED), 0,
                    dev)
    zero_counts()
    lk, gk = loss_and_grads(p, jamba, jb)
    jamba_launches = read_counts()
    with plain_training():
        lp, gp = loss_and_grads(p, jamba, jb)
    want = {"ssd_chunk": 2 * jm, "ssd_chunk_bwd": jm,
            "flash_attention": 2 * ja, "flash_attention_bwd": ja}
    if jamba_launches[0] != want or not np.isfinite(float(lk)):
        raise AssertionError(f"jamba smoke bf16: launches {jamba_launches}, "
                             f"want {want}, loss {float(lk)}")
    out["jamba_smoke"] = {"launches": jamba_launches[0],
                          "routes": jamba_launches[1],
                          "loss": float(lk), "plain_loss": float(lp),
                          "grad_max_dist_vs_plain": max(
                              rel_l2(gk[k], gp[k]) for k in gp)}
    del p, gk, gp
    print(f"[train-bf16] jamba smoke bf16 ({jm} Mamba and {ja} attention "
          f"layers, MoE) one step: launches {jamba_launches[0]} by route "
          f"{jamba_launches[1]}, loss {float(lk):.5f} (plain versions "
          f"{float(lp):.5f}), gradients at most "
          f"{out['jamba_smoke']['grad_max_dist_vs_plain']:.3e} from the "
          f"plain versions' (relative L2)", flush=True)

    laps["minicpm3 and jamba"] = time.perf_counter() - t_phase
    # 8. the pairs gained for MLA and gemma, forward and backward
    out["pairs"] = pair_timing(dev)
    out["prof_fns"].update(out["pairs"].pop("prof_fns"))
    laps["pairs"] = time.perf_counter() - t_phase
    out["phase_s"] = time.perf_counter() - t_phase
    out["laps_s"] = laps
    print(f"[train-bf16] phase 19 in {out['phase_s']:.1f} s (parts end at "
          + ", ".join(f"{k} {v:.1f}" for k, v in laps.items()) + " s)",
          flush=True)
    return out


def bf16_train_profile(train: dict, dev: torch.device) -> None:
    """Phase 19's steps under torch.profiler, their weights drawn again:
    for tinyllama and mamba2 at 2 x 4096, wall and device-busy ms, the
    idle share and the device time by part (products, the attention and
    SSD forwards, their backwards, the optimizer alone, the elementwise
    rest); the backward kernels' and SDPA's bf16 backward's device ms."""
    fns = train.pop("prof_fns")
    t, ts = train["timing"], train["ssd_timing"]
    per = recorded_profile(fns["bwd"], "flash_attention_bwd")[-1][2]
    t["device_ms_by_kernel"] = {k: v for k, v in per.items()
                                if "flash_attention_bwd" in k}
    t["device_ms"] = sum(t["device_ms_by_kernel"].values())
    t["library_device_ms"], t["library_backend"], _ = library_profile(
        fns["sdpa_bwd"])
    for key, fn in (("", fns["ssd_bwd"]), ("simt_", fns["ssd_bwd_simt"])):
        per = recorded_profile(fn, "ssd_bwd")[-1][2]
        ts[f"{key}device_ms_by_kernel"] = {
            re.search(r"ssd_bwd\w*", k).group(0): v for k, v in per.items()
            if "ssd_bwd" in k}
        ts[f"{key}device_ms"] = sum(
            ts[f"{key}device_ms_by_kernel"].values())
    for key, r in train["pairs"].items():
        for part, name in (("fwd", "flash_attention_kernel_sm90"),
                           ("bwd", "flash_attention_bwd_sm90")):
            busy = recorded_profile(fns[f"pair {key} {part}"], name)[-1][0]
            r[f"{part}_device_ms_by_kernel"] = {
                k: v for k, v in busy.items() if name in k}
            r[f"{part}_device_ms"] = sum(
                r[f"{part}_device_ms_by_kernel"].values())
            (r[f"{part}_library_device_ms"], r[f"{part}_library_backend"],
             _) = library_profile(fns[f"pair {key} sdpa {part}"], part=0)
        print(f"[time] train-bf16 pair {key} on the device: forward "
              f"{r['fwd_device_ms']:.4f} ms, backward "
              f"{r['bwd_device_ms']:.4f} ms (" + ", ".join(
                  f"{flash_instance(k)} {v:.4f}" for k, v in
                  r["bwd_device_ms_by_kernel"].items()) +
              f"); SDPA forward {fmt(r['fwd_library_device_ms'])} "
              f"({r['fwd_library_backend']}), backward "
              f"{fmt(r['bwd_library_device_ms'])} "
              f"({r['bwd_library_backend']})", flush=True)
    del fns
    for key, arch in (("tinyllama", BF16_ATTN_ARCH),
                      ("mamba2", BF16_MAMBA_ARCH)):
        cfg = get_arch(arch)
        params = bf16_model(cfg, dev)
        step_fn, init_opt = make_train_step(cfg, device=dev)
        state = {"p": params, "o": init_opt(params)}
        batch = step_batch(cfg, DataConfig(cfg.vocab_size, BF16_S, BF16_B,
                                           seed=SEED), 0, dev)

        def step():
            state["p"], state["o"], _ = step_fn(state["p"], state["o"],
                                                batch)

        t_prof = time.perf_counter()
        busy, wall, _ = device_profile(step, reps=1, host=False)
        parts = {"products": 0.0, "attention forward": 0.0,
                 "attention backward": 0.0, "ssd forward": 0.0,
                 "ssd backward": 0.0, "other": 0.0}
        for name, v in busy.items():
            part = ("attention backward" if "flash_attention_bwd" in name
                    else "attention forward" if "flash_attention" in name
                    else "ssd backward" if "ssd_bwd" in name
                    else "ssd forward" if "ssd_chunk" in name
                    else "products" if matmul_kernel(name) else "other")
            parts[part] += v
        total = sum(busy.values())
        prof = {"wall_ms": wall, "device_busy_ms": total,
                "device_idle_share": 1.0 - total / wall, "split_ms": parts}
        _, grads = loss_and_grads(state["p"], cfg, batch)
        prof["optimizer_alone_ms"] = optimizer_alone(
            dev, state["p"], state["o"], grads, host=False)
        prof["elementwise_ms"] = parts["other"] - prof["optimizer_alone_ms"]
        prof["seconds"] = time.perf_counter() - t_prof
        train[key]["profile"] = prof
        print(f"[time] train-bf16 {arch} step under the profiler: wall "
              f"{wall:.1f} ms, device busy {total:.1f} ms, idle share "
              f"{prof['device_idle_share']:.3f}; device ms by part " +
              ", ".join(f"{k} {v:.2f}" for k, v in parts.items()) +
              f"; of the rest the optimizer (alone) "
              f"{prof['optimizer_alone_ms']:.2f} ms and the elementwise "
              f"passes {prof['elementwise_ms']:.2f} ({prof['seconds']:.1f} "
              f"s to profile)", flush=True)
        del state, grads, params, batch, step
        torch.cuda.empty_cache()
    print(f"[time] train-bf16 on the device: flash_attention_bwd_sm90 "
          f"{t['device_ms']:.4f} ms ({t['device_ms_by_kernel']}), SDPA's "
          f"bf16 backward {fmt(t['library_device_ms'])} "
          f"({t['library_backend']}); ssd_chunk_bwd_sm90 "
          f"{ts['device_ms']:.4f} ms by pass " + ", ".join(
              f"{k} {v:.4f}" for k, v in ts["device_ms_by_kernel"].items())
          + f" (was {ts['simt_device_ms']:.4f}, the SIMT kernel: " + ", ".join(
              f"{k} {v:.4f}" for k, v in
              ts["simt_device_ms_by_kernel"].items()) + ")", flush=True)


# ---------------------------------------------------------------- 20 ---
# train_4k at its full batch (256 x 4096 = 1,048,576 tokens a step):
# tinyllama-1.1b in bf16 at full width and depth through
# ``make_train_step(accum_steps=FULL_ACCUM)``.  The microbatch is the
# largest a measured peak leaves room for: at 16 x 4096 one microbatch's
# forward and backward peaked at 28.10 GB (13.2 GB of bf16 parameters and
# gradients and fp32 moments, ~0.23 MB of activations a token) and the
# step at 32.50 GB with the fp32 accumulator, so 32 x 4096 takes ~48 GB
# and 64 x 4096 ~78 GB
FULL_ARCH, FULL_SHAPE, FULL_ACCUM = "tinyllama-1.1b", "train_4k", 8
# accum_steps=2 against 1 at phase 17's fp32 setup, where only the order
# of the sums differs: the loss (relative), each accumulated gradient (of
# its leaf's scale) and each updated parameter (of its leaf's scale, plus
# phase 17's absolute floor: a parameter that starts at 0, a norm weight,
# has one step's rate, 3e-6, as its scale, and AdamW's first step divides
# each gradient by its own magnitude, so a near-zero gradient's last
# digits reach that step whole)
ACCUM_LOSS_RTOL, ACCUM_GRAD_BAR, ACCUM_PARAM_BAR = 1e-6, 1e-5, 1e-5
# phase 19's step (2 x 4096) as a microbatch of train_4k's 256
BF16_AS_ACCUM = 256 // BF16_B


def one_fp32_step(cfg, dev, batch, k: int) -> dict:
    """One fp32 step of ``cfg`` from the port's generator (seed SEED) at
    ``accum_steps=k``, the counts zeroed just before and read just after:
    its accumulated gradients (taken before the step), updated
    parameters, loss and launches."""
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                           torch.float32, device=dev)
    grads = accumulated_grads(params, cfg, batch, k)[1]
    step_fn, init_opt = make_train_step(cfg, device=dev, accum_steps=k)
    opt = init_opt(params)
    zero_counts()
    params, opt, m = step_fn(params, opt, batch)
    launched, routes = read_counts()
    del opt
    return {"grads": grads, "params": train_state(params),
            "loss": float(m["loss"]), "launches": launched, "routes": routes}


def full_batch_phase(dev: torch.device, bf16_peak_gb: float) -> dict:
    """Phase 20 (see the module docstring)."""
    out: dict = {}
    cfg, sp = get_arch(FULL_ARCH), SHAPES[FULL_SHAPE]
    n, k = cfg.n_layers, FULL_ACCUM
    mb = sp.global_batch // k
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = bf16_model(cfg, dev)
    step_fn, init_opt = make_train_step(cfg, device=dev, accum_steps=k)
    opt = init_opt(params)
    batch = step_batch(cfg, DataConfig(cfg.vocab_size, sp.seq_len,
                                       sp.global_batch, seed=SEED), 0, dev)
    # warm the microbatch's shapes: one forward and backward of one
    t0 = time.perf_counter()
    loss_and_grads(params, cfg, {key: v[:mb] for key, v in batch.items()})
    torch.cuda.synchronize()
    out["warm_s"] = time.perf_counter() - t0
    out["microbatch_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    params, opt, m = step_fn(params, opt, batch)
    loss = float(m["loss"])
    step_s = time.perf_counter() - t0
    launched, routes = read_counts()
    out.update(
        arch=FULL_ARCH, accum_steps=k, microbatch=[mb, sp.seq_len],
        loss=loss, step_ms=step_s * 1e3,
        tokens_per_s=sp.global_batch * sp.seq_len / step_s,
        peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
        launches=launched, routes=routes,
        model_flops=analytic_model_flops(cfg, FULL_SHAPE))
    out["mfu"] = out["model_flops"] / (step_s * H100_SXM_BF16.peak_flops)
    check_counts(f"{FULL_ARCH} {FULL_SHAPE} k={k}",
                 [{"launches": launched, "routes": routes}],
                 ({"flash_attention": 2 * n * k,
                   "flash_attention_bwd_sm90": n * k},
                  {"flash_attention_sm90": 2 * n * k}))
    if not np.isfinite(loss) or out["peak_gb"] > 80.0:
        raise AssertionError(f"full-batch step: loss {loss}, peak "
                             f"{out['peak_gb']:.2f} GB")
    del params, opt, batch, m
    torch.cuda.empty_cache()
    print(f"[train-full] {FULL_ARCH} bf16 at {FULL_SHAPE}'s full batch "
          f"{sp.global_batch} x {sp.seq_len} ({sp.global_batch * sp.seq_len:,}"
          f" tokens), accum_steps={k} (microbatches of {mb} x "
          f"{sp.seq_len}): one step {out['step_ms']:.1f} ms "
          f"({out['tokens_per_s']:.0f} training tokens/s), loss {loss:.4f}, "
          f"peak {out['peak_gb']:.2f} GB (one microbatch's forward and "
          f"backward, warm-up: {out['microbatch_peak_gb']:.2f} GB in "
          f"{out['warm_s']:.1f} s); launches {launched} by route {routes} "
          f"= {k} x ({2 * n} + {n}); MFU {out['mfu']:.4f} "
          f"({out['model_flops']:.4g} model FLOP = 6ND over the step at "
          f"{H100_SXM_BF16.peak_flops:.3g} FLOP/s, dense bf16)", flush=True)

    # the dry run's peak (the card's path on meta: the attention kernels'
    # outputs, not the plain score matrices) beside the measured ones
    full = dryrun_cell(FULL_ARCH, FULL_SHAPE, accum_steps=k, verbose=False)
    two = dryrun_cell(FULL_ARCH, FULL_SHAPE, accum_steps=BF16_AS_ACCUM,
                      verbose=False)
    out["dryrun"] = {"full": full, "phase19": two}
    two_gb = (two["peak_bytes"] - two["accumulator_bytes"]) / 1e9
    print(f"[dryrun] {FULL_ARCH} {FULL_SHAPE} on meta (the card's path, "
          f"attention as its kernels' outputs): microbatch {mb} x "
          f"{sp.seq_len} with the accumulator "
          f"{full['peak_bytes'] / 1e9:.2f} GB against {out['peak_gb']:.2f} "
          f"GB measured (x{full['peak_bytes'] / 1e9 / out['peak_gb']:.3f}; "
          f"{full['seconds']:.1f} s); {BF16_B} x {BF16_S} without it "
          f"{two_gb:.2f} GB against phase 19's {bf16_peak_gb:.2f} GB "
          f"(x{two_gb / bf16_peak_gb:.3f}); counted FLOPs "
          f"{full['counted_flops']:.4g} against 6ND "
          f"{full['model_flops']:.4g} (ratio "
          f"{full['useful_flops_ratio']:.3f})", flush=True)

    # accum_steps=2 against 1 at phase 17's fp32 setup, and twice
    cfg32 = get_arch(TRAIN_ARCH)
    batch = step_batch(cfg32, DataConfig(cfg32.vocab_size, TRAIN_S, TRAIN_B,
                                         seed=SEED), 0, dev)
    one = one_fp32_step(cfg32, dev, batch, 1)
    two_a = one_fp32_step(cfg32, dev, batch, 2)
    two_b = one_fp32_step(cfg32, dev, batch, 2)
    n32 = cfg32.n_layers
    for what, run, kk in (("k=1", one, 1), ("k=2", two_a, 2),
                          ("k=2 again", two_b, 2)):
        check_counts(f"{TRAIN_ARCH} fp32 {what}", [run], (
            {"flash_attention": 2 * n32 * kk,
             "flash_attention_bwd": n32 * kk},
            {"flash_attention": 2 * n32 * kk}))
    rel = abs(two_a["loss"] - one["loss"]) / abs(one["loss"])
    if rel > ACCUM_LOSS_RTOL:
        raise AssertionError(f"accum_steps=2 loss {two_a['loss']} vs "
                             f"{one['loss']}: rel {rel}")
    out["accum2_vs_1"] = {
        "loss_rel": rel,
        "grad_err": leaf_error(two_a["grads"], one["grads"], ACCUM_GRAD_BAR,
                               what="accum_steps=2 vs 1 gradients"),
        "param_err": leaf_error(two_a["params"], one["params"],
                                ACCUM_PARAM_BAR, CARD_CPU_ATOL,
                                what="accum_steps=2 vs 1 params")}
    if two_a["loss"] != two_b["loss"]:
        raise AssertionError("accum_steps=2 loss moved run to run")
    for key, t in two_a["params"].items():
        check_equal(f"accum_steps=2 run to run {key}", t,
                    two_b["params"][key])
    del one, two_a, two_b, batch
    torch.cuda.empty_cache()

    # a smoke-config accumulated step, card against the CPU port
    smoke = smoke_config(TRAIN_ARCH)
    p_cpu = T.init_params(smoke, torch.Generator().manual_seed(SEED),
                          torch.float32, device="cpu")
    res = {}
    for key, d, p in (("cpu", torch.device("cpu"), p_cpu),
                      ("card", dev, copy.deepcopy(p_cpu).to(dev))):
        fn, init = make_train_step(smoke, lr=5e-3, device=d, accum_steps=2)
        b = step_batch(smoke, DataConfig(smoke.vocab_size, 64, 4, seed=SEED),
                       0, d)
        p, _, m = fn(p, init(p), b)
        res[key] = (train_state(p), float(m["loss"]))
    out["smoke_card_vs_cpu"] = leaf_error(
        res["card"][0], res["cpu"][0], CARD_CPU_BAR, CARD_CPU_ATOL,
        "accumulated smoke step, card vs CPU")
    print(f"[train-full] accum_steps=2 vs 1 ({TRAIN_ARCH} fp32, "
          f"{TRAIN_B} x {TRAIN_S}): loss rel {rel:.2e} (bar "
          f"{ACCUM_LOSS_RTOL}), gradients "
          f"{out['accum2_vs_1']['grad_err']:.2e} of a leaf's scale (bar "
          f"{ACCUM_GRAD_BAR}), params {out['accum2_vs_1']['param_err']:.2e}"
          f" (bar {ACCUM_PARAM_BAR} + {CARD_CPU_ATOL}); accum_steps=2 "
          f"bit-equal run to run; {smoke.name} smoke accumulated step card "
          f"== CPU within {out['smoke_card_vs_cpu']:.2e} (bar "
          f"{CARD_CPU_BAR} + {CARD_CPU_ATOL}), losses card "
          f"{res['card'][1]:.6f}, CPU {res['cpu'][1]:.6f}", flush=True)

    # the LM serving example on the card, held to the CPU port
    zero_counts()
    ex = serve_fog_lm.main([])
    launched = read_counts()[0]
    cpu_done = serve_fog_lm.serve(copy.deepcopy(ex["params"]).to("cpu"),
                                  ex["cfg"], "cpu")
    card = {r.rid: r for r in ex["done"]}
    cpu = {r.rid: r for r in cpu_done}
    if sorted(card) != sorted(cpu) or len(card) != serve_fog_lm.N_REQUESTS:
        raise AssertionError(f"example: requests {sorted(card)} on the "
                             f"card, {sorted(cpu)} on the CPU")
    for rid, r in card.items():
        if (list(map(int, r.generated)) != list(map(int, cpu[rid].generated))
                or list(map(int, r.hops)) != list(map(int, cpu[rid].hops))):
            raise AssertionError(
                f"example request {rid}: card tokens {r.generated} hops "
                f"{r.hops}, CPU {cpu[rid].generated} {cpu[rid].hops}")
    out["example"] = {"launches": launched, "hops": {
        rid: list(map(int, r.hops)) for rid, r in sorted(card.items())}}
    print(f"[example] serve_fog_lm on the card: {len(card)} requests, "
          f"tokens and hops == the CPU port's; launches "
          f"top2_confidence {launched.get('top2_confidence', 0)}, "
          f"flash_attention {launched.get('flash_attention', 0)} (all "
          f"{launched})", flush=True)
    return out


# phase 21: the sharding plan on one card, at the attention phase's model
# and prefill; the 3-D mesh names JAX's multi-pod axes
SHARD_ARCH = ATTN_ARCH
SHARD_AXES = ("pod", "data", "model")
# the mesh train step: two steps on each mesh at phase 19's shape
MESH_STEPS = 2
# the mesh serving steps: the attention phase's prefill, then this many
# greedy decode and as many FoG steps, on each mesh
MESH_DECODE = 4
# the head slice held on the tensor cores: rank 1 of 2 along model
HEAD_SLICE = (1, 2)


def mesh_train_check(dev: torch.device, cfg, meshes: dict, *, B: int,
                     S: int, steps: int = MESH_STEPS,
                     dtype=torch.bfloat16, want=None) -> dict:
    """``steps`` steps of ``make_train_step(..., mesh=)`` on each of
    ``meshes`` (name -> ``DeviceMesh`` of one rank, its model placed by
    the plan) from the same fresh model as ``steps`` one-device steps of
    ``make_train_step``; every parameter (``to_local()`` and
    ``full_tensor()``), moment, loss, grad norm and the step count
    bit-equal.  With ``want`` (launches, routes) each step's counts are
    zeroed just before it and checked just after (the one-device steps'
    too).  Returns each run's losses, step ms and counts."""
    counted = want is not None

    def fresh():
        return T.init_params(cfg, torch.Generator(device=dev).manual_seed(
            SEED), dtype, device=dev)

    def run(step_fn, params, opt, what):
        dcfg = DataConfig(cfg.vocab_size, S, B, seed=SEED)
        rec = {"losses": [], "norms": [], "ms": [], "per_step": []}
        for i in range(steps):
            batch = step_batch(cfg, dcfg, i, dev)
            if counted:
                zero_counts()
            t0 = time.perf_counter()
            params, opt, m = step_fn(params, opt, batch)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
            rec["losses"].append(m["loss"].clone())
            rec["norms"].append(m["grad_norm"].clone())
            if counted:
                launched, routes = read_counts()
                rec["per_step"].append({"launches": launched,
                                        "routes": routes})
        if counted:
            check_counts(what, rec["per_step"], want)
        return params, opt, rec

    step1, init1 = make_train_step(cfg, total_steps=steps, device=dev)
    p = fresh()
    p1, o1, one = run(step1, p, init1(p), f"{cfg.name} one-device step")
    whole = {"params": {k: t.detach() for k, t in p1.named_parameters()},
             "mu": o1.mu, "nu": o1.nu}
    out = {"one_device": {"losses": [float(x) for x in one["losses"]],
                          "ms": one["ms"]}}
    for name, mesh in meshes.items():
        if dp_rank(mesh) != (0, 1):
            raise AssertionError(f"{name}: dp rank {dp_rank(mesh)}")
        p = fresh()
        placed = shard_tree(p, mesh, param_shardings(cfg, mesh, p))
        del p
        stepm, initm = make_train_step(cfg, total_steps=steps, device=dev,
                                       mesh=mesh)
        pm, om, rec = run(stepm, placed, initm(placed),
                          f"{cfg.name} mesh step on {name}")
        for what in ("losses", "norms"):
            for a, b in zip(rec[what], one[what]):
                check_equal(f"mesh step on {name}: {what}", a, b)
        n = 0
        for what, tree in (("params", dict(pm.named_parameters())),
                           ("mu", om.mu), ("nu", om.nu)):
            for k, d in tree.items():
                if d.device_mesh != mesh:
                    raise AssertionError(f"{name} {what} {k} off the mesh")
                # compared on the device; check_equal (a host copy) only
                # to name a difference
                for part, t in (("local", d.to_local()),
                                ("whole", d.full_tensor())):
                    if not torch.equal(t, whole[what][k]):
                        check_equal(f"mesh step on {name}: {what} {k} "
                                    f"{part}", t, whole[what][k])
                n += 1
        if int(om.step.full_tensor()) != int(o1.step):
            raise AssertionError(f"mesh step on {name}: step count")
        out[name] = {"losses": [float(x) for x in rec["losses"]],
                     "ms": rec["ms"], "leaves": n,
                     "launches": rec["per_step"][-1]["launches"]
                     if counted else None,
                     "routes": rec["per_step"][-1]["routes"]
                     if counted else None}
        del pm, om, placed
    del p1, o1, whole
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def mesh_save_check(dev: torch.device, cfg, mesh, where: Path, *, B: int,
                    S: int, steps: int = MESH_STEPS,
                    dtype=torch.bfloat16) -> dict:
    """``steps`` mesh steps of ``cfg`` on ``mesh``, the state saved from
    the mesh (``train.checkpoint.save`` of ``DTensor``s) and restored on
    the device without a mesh: every leaf bit-equal to the mesh state's
    ``full_tensor()``.  Returns the leaves and the save and restore
    seconds."""
    p = T.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                      dtype, device=dev)
    placed = shard_tree(p, mesh, param_shardings(cfg, mesh, p))
    step_fn, init_opt = make_train_step(cfg, total_steps=steps, device=dev,
                                        mesh=mesh)
    opt = init_opt(placed)
    dcfg = DataConfig(cfg.vocab_size, S, B, seed=SEED)
    for i in range(steps):
        placed, opt, _ = step_fn(placed, opt, step_batch(cfg, dcfg, i, dev))
    shutil.rmtree(where, ignore_errors=True)
    t0 = time.perf_counter()
    ckpt.save(steps, (placed, opt), where)
    t1 = time.perf_counter()
    like = (p, make_train_step(cfg, device=dev)[1](p))
    (rp, ro), step = ckpt.restore(like, where)
    t2 = time.perf_counter()
    shutil.rmtree(where, ignore_errors=True)
    if step != steps or int(ro.step) != int(opt.step.full_tensor()):
        raise AssertionError(f"restored step {step}, {int(ro.step)}")
    n = 0
    for what, got, tree in (
            ("params", dict(rp.named_parameters()),
             dict(placed.named_parameters())),
            ("mu", ro.mu, opt.mu), ("nu", ro.nu, opt.nu)):
        for k, d in tree.items():
            if got[k].device.type != dev.type or got[k].dtype != d.dtype:
                raise AssertionError(f"restored {what} {k} on "
                                     f"{got[k].device} in {got[k].dtype}")
            check_equal(f"restored {what} {k}", got[k].detach(),
                        d.full_tensor())
            n += 1
    return {"leaves": n, "save_s": t1 - t0, "restore_s": t2 - t1}


def card_name(dev: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card, for a line of
    device numbers (a CPU rehearsal names the CPU)."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def mesh_serve_check(dev: torch.device, cfg, params, meshes: dict,
                     tokens: torch.Tensor, *,
                     n_decode: int = MESH_DECODE) -> dict:
    """``make_prefill_step`` / ``make_serve_step(..., mesh=)`` on each of
    ``meshes`` (name -> (``DeviceMesh`` of one rank, ``params`` placed on
    it by the plan)) held to the one-card steps from ``params``: a prefill
    of ``tokens [B, S]`` with a cache of ``S + 2 n_decode`` positions,
    ``n_decode`` greedy decode steps and ``n_decode`` FoG steps (the
    ``"pallas"`` margin) at per-lane thresholds ``LM_THRESH`` (lane
    ``LM_GATE_LANE``'s from a first FoG step's margins) with the last
    lane's budget ``LM_BUDGET``, so that the lanes exit at different
    groves.  Each step's logits, hops and every cache leaf
    (``to_local()`` and ``full_tensor()``) == the one-card step's bit for
    bit; the counts of each step zeroed just before it and read just
    after: ``n_layers`` ``flash_attention`` on the tensor cores a prefill,
    none a decode step, ``G - 1`` ``top2_confidence`` a FoG step, on the
    one card and on each mesh.  Then the tensor-core forward on
    ``HEAD_SLICE``'s heads of layer 0's q, k and v == that slice of the
    whole call bit for bit.  Returns each run's step ms and counts."""
    B, S = tokens.shape
    M = S + 2 * n_decode
    G = len(grove_boundaries(cfg))
    n = cfg.n_layers
    fog_policy = FogPolicy(backend="pallas")

    def factories(mesh=None):
        return (make_prefill_step(cfg, dev, batch=B, seq_len=S, max_seq=M,
                                  mesh=mesh)[0],
                make_serve_step(cfg, dev, batch=B, max_seq=M,
                                mesh=mesh)[0],
                make_serve_step(cfg, dev, batch=B, max_seq=M, fog=True,
                                policy=fog_policy, mesh=mesh)[0])

    one = factories()
    # lane LM_GATE_LANE's threshold from a first FoG step's margins, and
    # layer 0's q, k and v (both before any count is zeroed)
    captured, real = [], ops.flash_attention

    def spy(q, k, v, **kw):
        if not captured:
            captured.append((q.clone(), k.clone(), v.clone(), kw))
        return real(q, k, v, **kw)

    ops.flash_attention = spy
    try:
        logits, cache = one[0](params, tokens)
    finally:
        ops.flash_attention = real
    with GateSpy() as cal:
        one[2](params, cache, logits.argmax(-1).to(torch.int32), S,
               torch.full((B,), 2.0, dtype=torch.float32, device=dev),
               torch.full((B,), NO_BUDGET, dtype=torch.int32, device=dev))
    del logits, cache
    lanes = [lm_gate_threshold(torch.stack(
        [m for _, m in cal.calls])[:, LM_GATE_LANE].cpu()) if t is None
        else t for t in LM_THRESH[:B]]
    thresh = torch.tensor(lanes, dtype=torch.float32, device=dev)
    budget = torch.full((B,), NO_BUDGET, dtype=torch.int32, device=dev)
    budget[-1] = LM_BUDGET

    def run(fns, p, whole):
        """Each step's (what, logits, cache, hops, ms, counts)."""
        pre, dec, fog = fns
        steps = [("prefill", lambda c, t, i: pre(p, tokens))]
        steps += [("decode", lambda c, t, i: dec(p, c, t, S + i))] * n_decode
        steps += [("fog", lambda c, t, i: fog(p, c, t, S + i, thresh,
                                              budget))] * n_decode
        rec, cache, token = [], None, None
        for i, (what, fn) in enumerate(steps):
            zero_counts()
            t0 = time.perf_counter()
            res = fn(cache, token, i - 1)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launched, routes = read_counts()
            logits, cache = res[0], res[1]
            rec.append((what, logits, cache, res[2] if len(res) > 2
                        else None, ms, {"launches": launched,
                                        "routes": routes}))
            token = whole(logits).argmax(-1).to(torch.int32)
        return rec

    want = {"prefill": ({"flash_attention": n},
                        {"flash_attention_sm90": n}),
            "decode": ({}, {}),
            "fog": ({"top2_confidence": G - 1}, {})}

    def counted(name, rec):
        for what, *_, counts in rec:
            check_counts(f"{cfg.name} {what} on {name}", [counts],
                         want[what])
        return {"ms": {what: [r[4] for r in rec if r[0] == what]
                       for what in want},
                "counts": {what: next(r[5] for r in rec if r[0] == what)
                           for what in want}}

    ref = run(one, params, lambda t: t)
    out = {"one_card": counted("one card", ref), "thresh": lanes,
           "budget": budget.tolist(),
           "hops": [r[3].tolist() for r in ref if r[3] is not None]}
    for name, (mesh, placed) in meshes.items():
        got = run(factories(mesh), placed, lambda t: t.full_tensor())
        n_leaves = 0
        for (what, lg, cg, hg, _, _), (_, lw, cw, hw, _, _) in zip(
                got, ref, strict=True):
            pairs = [("logits", lg, lw)] + ([("hops", hg, hw)]
                                            if hw is not None else [])
            pairs += [(f"cache {i}", d, t) for i, (d, t) in enumerate(zip(
                tree_leaves(cg), tree_leaves(cw), strict=True))]
            for leaf, d, t in pairs:
                if d.device_mesh != mesh:
                    raise AssertionError(f"{name} {what} {leaf} off the "
                                         "mesh")
                # compared on the device; check_equal (a host copy) only
                # to name a difference
                for part, x in (("local", d.to_local()),
                                ("whole", d.full_tensor())):
                    if not torch.equal(x, t):
                        check_equal(f"mesh {what} on {name}: {leaf} {part}",
                                    x, t)
            n_leaves += len(pairs)
        out[name] = counted(name, got)
        out[name]["outputs"] = n_leaves
        del got
    del ref

    # the head slice of one rank of HEAD_SLICE[1] on the tensor cores
    q, k, v, kw = captured[0]
    m, parts = HEAD_SLICE
    H, K = q.shape[2], k.shape[2]
    hq = slice(m * H // parts, (m + 1) * H // parts)
    hk = slice(m * K // parts, (m + 1) * K // parts)
    zero_counts()
    whole = ops.flash_attention(q, k, v, **kw)
    part = ops.flash_attention(q[:, :, hq].contiguous(),
                               k[:, :, hk].contiguous(),
                               v[:, :, hk].contiguous(), **kw)
    _, routes = read_counts()
    if routes != {"flash_attention_sm90": 2}:
        raise AssertionError(f"head slice: routes {routes}")
    check_equal("flash_attention_sm90 on a head slice vs that slice of the "
                "whole call", part, whole[:, :, hq])
    out["head_slice"] = {"q_heads": [hq.start, hq.stop - 1],
                         "kv_heads": [hk.start, hk.stop - 1],
                         "shape": list(q.shape)}
    if dev.type == "cuda":
        # the kernel at a tensor-parallel rank's heads (phase 21's (1, 2)
        # mesh) beside the whole call, its plain version, SDPA and bound
        qs, ks, vs = (a[:, :, h].contiguous() for a, h in ((q, hq), (k, hk),
                                                           (v, hk)))
        ts = [a.transpose(1, 2).contiguous() for a in (qs, ks, vs)]
        work = flash_work(q.shape[0], q.shape[1], k.shape[1], qs.shape[2],
                          ks.shape[2], q.shape[3], v.shape[3],
                          q.element_size(), kw["causal"])
        out["head_slice"].update(
            ms=cuda_ms(lambda: ops.flash_attention(qs, ks, vs, **kw)),
            whole_ms=cuda_ms(lambda: ops.flash_attention(q, k, v, **kw)),
            plain_ms=cuda_ms(lambda: flash_attention_ref(qs, ks, vs, **kw),
                             reps=5, warm=1),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                *ts, is_causal=True, enable_gqa=True)),
            bound=bound_ms(work["bytes"], work["ops"], BF16_OPS_PER_S))
        del qs, ks, vs, ts
    del captured, whole, part
    return out


# the tensor-parallel part of phase 21: two processes on the card over a
# gloo group, a (1, 2) ("data", "model") mesh
TP_MESH = ((1, 2), ("data", "model"))
# seconds the two ranks may take, the build and their imports included
TP_TIMEOUT_S = 600
# (B, C, ranks): the gate's blocks the top-2 partials and merge are held
# to their plain versions at, the rank's [4, 16000] block of tinyllama's
# 32,000-entry rows first
TOP2_BLOCK_CASES = ((4, 16000, 1), (4, 32000, 2), (1, 50280, 2),
                    (1000, 10, 1))


def top2_block_checks(dev: torch.device) -> dict:
    """The top-2 kernel's partials and merge entries (a mesh rank's block
    of each row) on ``TOP2_BLOCK_CASES``: the rows cut into ``ranks``
    blocks, the maximum repeated in two blocks in every fourth row (in one
    block twice where there is one) and the last row all equal; each
    block's partials (the index offset by its first column) == the plain
    version's bit for bit, the merge of the blocks' partials in block
    order == its plain version's == ``top2_confidence`` of the whole rows
    bit for bit, 0 on the repeated maxima.  Then the partials and merge of
    a rank's [4, 16000] block timed beside the whole [4, 32000] call, its
    plain version, ``torch.topk`` on the block and the bound."""
    rng = np.random.default_rng(SEED + 1)
    out = {"cases": {}}
    for B, C, ranks in TOP2_BLOCK_CASES:
        p = torch.softmax(torch.as_tensor(
            rng.random((B, C), dtype=np.float32) * 8, device=dev), dim=-1)
        n = C // ranks
        top = float(p.max()) + 1.0
        p[::4, 1] = top
        p[::4, C - n + 2 if ranks > 1 else C // 2] = top
        if B > 1:
            p[-1] = 1.0 / C
        parts, plain = [], []
        for m in range(ranks):
            block = p[:, m * n:(m + 1) * n].contiguous()
            parts.append(ops.top2_partials(block, m * n))
            plain.append(ref.top2_partials_ref(block.cpu(), m * n,
                                               parts[-1].shape[2]))
            check_equal(f"top2 partials [{B}, {n}] block {m} of {ranks}",
                        parts[-1].cpu(), plain[-1])
        got = ops.top2_merge(torch.cat(parts, dim=-1))
        check_equal(f"top2 merge [{B}, {C}] of {ranks} blocks", got.cpu(),
                    ref.top2_merge_ref(torch.cat(plain, dim=-1)))
        check_equal(f"top2 merge [{B}, {C}] vs one call", got,
                    ops.top2_confidence(p))
        if (got[::4] != 0).any():
            raise AssertionError(f"top2 merge [{B}, {C}]: a maximum repeated "
                                 "across the blocks gave a margin above 0")
        out["cases"][f"[{B}, {C}] in {ranks}"] = {
            "runs_a_block": int(parts[0].shape[2])}
    if dev.type == "cuda":
        whole = torch.softmax(torch.as_tensor(
            rng.random((4, 32000), dtype=np.float32) * 8, device=dev), -1)
        block = whole[:, 16000:].contiguous()
        runs = ops.top2_partials(block, 16000).shape[2]
        two = torch.cat([ops.top2_partials(whole[:, :16000].contiguous()),
                         ops.top2_partials(block, 16000)], dim=-1)
        out["block_ms"] = cuda_ms(
            lambda: ops.top2_merge(ops.top2_partials(block, 16000)))
        out["partials_ms"] = cuda_ms(lambda: ops.top2_partials(block, 16000))
        out["merge_ms"] = cuda_ms(lambda: ops.top2_merge(two))
        out["whole_ms"] = cuda_ms(lambda: ops.top2_confidence(whole))
        out["plain_ms"] = cuda_ms(lambda: ref.top2_merge_ref(
            ref.top2_partials_ref(block, 16000, runs)))
        out["library_ms"] = cuda_ms(lambda: torch.topk(block, 2, dim=-1))
        out["bound_ms"], out["bound_by"] = bound_ms(
            4 * 16000 * 4 + 3 * 4 * 4 * runs * 3 + 4 * 4, 4 * 3 * 16000)
    return out


def rehearsal_stand_ins() -> None:
    """On the CPU (a rehearsal of the tensor-parallel ranks, which are
    spawned and so cannot be patched from outside) the kernels' wrappers
    run their plain versions and count nothing: wrap them to count a
    launch and its route as the card's wrappers do; and there is no card
    to synchronise."""
    torch.cuda.synchronize = lambda *a: None
    def counted(fn, kernel, route=None):
        def wrapper(*a, **kw):
            ops.launches[kernel] += 1
            if route is not None:
                _build.routes[route] += 1
            return fn(*a, **kw)
        return wrapper

    ops.flash_attention = counted(ops.flash_attention, "flash_attention",
                                  "flash_attention_sm90")
    ops.top2_partials = counted(ops.top2_partials, "top2_confidence",
                                "top2_partials")
    ops.top2_merge = counted(ops.top2_merge, "top2_confidence", "top2_merge")
    ops.top2_confidence = counted(ops.top2_confidence, "top2_confidence")


def tp_steps(cfg, dev, params, tokens, thresh, budget, n_decode, *,
             dtype=torch.bfloat16, mesh=None, feed=None, watch=None):
    """``make_prefill_step`` then ``n_decode`` greedy decode and
    ``n_decode`` FoG steps (the ``"pallas"`` margin, per-lane ``thresh``
    and ``budget``) on the card or on ``mesh``, each step's counts zeroed
    just before it and read just after; each step's token the last step's
    argmax, or ``feed[i]``.  ``watch`` (a list) collects each gate's
    margins.  Returns the steps' (logits, cache, hops), the tokens fed,
    each step's argmax, ms and counts."""
    from repro_torch.models import fog_exit

    B, S = tokens.shape
    L = S + 2 * n_decode
    kw = dict(param_dtype=dtype, mesh=mesh)
    pre = make_prefill_step(cfg, dev, batch=B, seq_len=S, max_seq=L, **kw)[0]
    dec = make_serve_step(cfg, dev, batch=B, max_seq=L, **kw)[0]
    fog = make_serve_step(cfg, dev, batch=B, max_seq=L, fog=True,
                          policy=FogPolicy(backend="pallas"), **kw)[0]
    steps = [lambda c, t, i: pre(params, tokens)]
    steps += [lambda c, t, i: dec(params, c, t, S + i)] * n_decode
    steps += [lambda c, t, i: fog(params, c, t, S + i, thresh,
                                  budget)] * n_decode
    rec = {"outputs": [], "fed": [], "argmax": [], "ms": [], "counts": []}
    gate = fog_exit._gate_margin
    if watch is not None:
        def spy(*a, **k):
            m = gate(*a, **k)
            watch.append(m.clone())
            return m
        fog_exit._gate_margin = spy
    try:
        cache, token = None, None
        for i, fn in enumerate(steps):
            zero_counts()
            t0 = time.perf_counter()
            res = fn(cache, token, i - 1)
            torch.cuda.synchronize()
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
            launched, routes = read_counts()
            rec["counts"].append({"launches": launched, "routes": routes})
            logits, cache = res[0], res[1]
            rec["outputs"].append((logits, cache,
                                   res[2] if len(res) > 2 else None))
            local = logits if mesh is None else logits.to_local()
            own = local.argmax(-1)
            if mesh is not None and logits.placements[-1].is_shard():
                # the argmax of the whole rows from the ranks' blocks
                vals = local.gather(1, own[:, None])[:, 0]
                g = mesh.get_group("model")
                M = mesh.size(1)
                allv = [torch.empty_like(vals) for _ in range(M)]
                alli = [torch.empty_like(own) for _ in range(M)]
                dist.all_gather(allv, vals, group=g)
                dist.all_gather(alli, own, group=g)
                best = torch.stack(allv).argmax(0)
                own = (torch.stack(alli).gather(0, best[None])[0]
                       + best * local.shape[1])
            rec["argmax"].append(own.to(torch.int32))
            token = (own.to(torch.int32) if feed is None
                     else feed[i]).contiguous()
            rec["fed"].append(token)
    finally:
        fog_exit._gate_margin = gate
    return rec


def block_sums(got, one, oracle) -> torch.Tensor:
    """[3] float64: the squared L2 distances of the rank's block ``got``
    and of the same block of ``one`` from that block of ``oracle``, and
    the block's squared norm of ``oracle``."""
    g = got.to_local().double()
    o = local_block(one, got).double()
    c = local_block(oracle, got).double()
    return torch.stack([(g - c).square().sum(), (o - c).square().sum(),
                        c.square().sum()])


def tp_rank_check(dev: torch.device, args: dict) -> dict:
    """One rank of the tensor-parallel serving check (``tp_serve_check``):
    on the (1, 2) mesh, the model placed by the plan, the steps run
    tensor-parallel once to warm up (a prefill, a decode and a FoG step:
    the rank's first cuBLAS calls and kernel loads), once timed (its own
    greedy tokens; the rank's peak memory), then the one-card references
    (bf16 from the whole model, and fp32 from it cast up, fed the bf16
    tokens), then once more fed the bf16 tokens and held to them."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.models import transformer as TT
    from repro_torch.serve.decode import step_params

    cfg, n_decode = args["cfg"], args["n_decode"]
    tokens = args["tokens"].to(dev)
    thresh = torch.tensor(args["thresh"], dtype=torch.float32, device=dev)
    budget = torch.tensor(args["budget"], dtype=torch.int32, device=dev)
    mesh = init_device_mesh(dev.type, TP_MESH[0],
                            mesh_dim_names=TP_MESH[1])
    group = mesh.get_group("model")
    M = mesh.size(1)
    out = {"rank": dist.get_rank()}
    moves = []
    redistribute = DTensor.redistribute

    def recorded(d, *a, **kw):
        moves.append((tuple(d.shape), tuple(d.placements)))
        return redistribute(d, *a, **kw)

    params = bf16_model(cfg, dev)
    specs = param_shardings(cfg, mesh, params)
    placed = shard_tree(params, mesh, specs)
    del params
    torch.cuda.empty_cache()
    DTensor.redistribute = recorded
    try:
        step = step_params(cfg, mesh, placed)
        out["param_bytes"] = sum(p.numel() * p.element_size()
                                 for p in step.parameters())
        out["param_bytes_want"] = sum(
            p.numel() * p.element_size() // (M if "model" in specs[k] else 1)
            for k, p in placed.named_parameters())
        out["whole_bytes"] = sum(p.numel() * p.element_size()
                                 for p in placed.parameters())
        del step
        warm = tp_steps(cfg, dev, placed, tokens, thresh, budget, 1,
                        mesh=mesh)
        out["warm_ms"] = warm["ms"]
        del warm
        torch.cuda.synchronize()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
        timed = tp_steps(cfg, dev, placed, tokens, thresh, budget, n_decode,
                         mesh=mesh)
        out["peak_bytes"] = (torch.cuda.max_memory_allocated()
                             if dev.type == "cuda" else 0)
        out["resident_bytes"] = base
        out["ms"], out["counts"] = timed["ms"], timed["counts"]
        out["own_tokens"] = [t.cpu() for t in timed["argmax"]]
        del timed
    finally:
        DTensor.redistribute = redistribute

    # the one-card references
    params = bf16_model(cfg, dev)
    with GateSpy() as spy:
        one = tp_steps(cfg, dev, params, tokens, thresh, budget, n_decode)
    one_m = [m for _, m in spy.calls]
    with GateSpy() as spy:
        orc = tp_steps(cfg, dev, cast_model(params, torch.float32), tokens,
                       thresh, budget, n_decode, dtype=torch.float32,
                       feed=one["fed"])
    orc_m = [m for _, m in spy.calls]
    del params
    torch.cuda.empty_cache()

    # the checked run: fed the bf16 one-card tokens, the residual after
    # each layer compared across the model ranks as it is made
    mismatched = [0, 0]
    layer, seq = TT._apply_layer_decode, TT._layer_seq

    def same_on_ranks(t):
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(M)]
        dist.all_gather(parts, t, group=group)
        mismatched[0] += 1
        mismatched[1] += not all(torch.equal(x, parts[0]) for x in parts)

    def on_layer(*a, **kw):
        res = layer(*a, **kw)
        same_on_ranks(res[0])
        return res

    def on_seq(*a, **kw):
        res = seq(*a, **kw)
        same_on_ranks(res[0])
        return res

    mesh_m = []
    TT._apply_layer_decode, TT._layer_seq = on_layer, on_seq
    DTensor.redistribute = recorded
    try:
        got = tp_steps(cfg, dev, placed, tokens, thresh, budget, n_decode,
                       mesh=mesh, feed=one["fed"], watch=mesh_m)
    finally:
        TT._apply_layer_decode, TT._layer_seq = layer, seq
        DTensor.redistribute = redistribute
    for m in mesh_m:
        same_on_ranks(m)
    hops_m = [o[2].to_local() for o in got["outputs"] if o[2] is not None]
    for h in hops_m:
        same_on_ranks(h)
    out["identical"] = mismatched
    out["moves"] = len(moves)
    out["checked_counts"] = got["counts"]

    # each output's relative L2 distances from the fp32 oracle, summed
    # over the ranks' blocks
    rows = []
    for i, ((lg, cg, _), (lo, co, _), (lc, cc, _)) in enumerate(zip(
            got["outputs"], one["outputs"], orc["outputs"], strict=True)):
        rows.append((f"step {i} logits", block_sums(lg, lo, lc)))
        for j, (d, t, c) in enumerate(zip(tree_leaves(cg), tree_leaves(co),
                                          tree_leaves(cc), strict=True)):
            rows.append((f"step {i} cache {j}", block_sums(d, t, c)))
    sums = torch.stack([r for _, r in rows])
    parts = [torch.empty_like(sums) for _ in range(M)]
    dist.all_gather(parts, sums.contiguous(), group=group)
    total = sum(p.cpu() for p in parts)
    bar = []
    for (what, _), (dg, do, cn) in zip(rows, total.tolist()):
        mesh_d, one_d = (dg / max(cn, 1e-300)) ** 0.5, (
            do / max(cn, 1e-300)) ** 0.5
        bar.append((what, mesh_d, one_d, mesh_d / (2 * one_d + 2 ** -9)))
    out["bar"] = bar
    # tokens and hops against the one card, each difference with its gap
    # or its margin's distance from the threshold and the bar
    flips = []
    for i, (mine, theirs) in enumerate(zip(out["own_tokens"], one["argmax"])):
        lo = one["outputs"][i][0]
        lc = orc["outputs"][i][0]
        step_bar = 3 * rel_l2(lo, lc) + 2 ** -9
        for lane in (mine != theirs.cpu()).nonzero()[:, 0].tolist():
            top = lo[lane].topk(2).values
            flips.append((i, lane, float(top[0] - top[1])
                          / float(lo[lane].abs().max()), step_bar))
    out["flips"] = flips
    G = len(grove_boundaries(cfg))
    n_gates = G - 1
    hop_rows = []
    one_hops = [o[2].cpu() for o in one["outputs"] if o[2] is not None]
    for k, (hm, hw) in enumerate(zip(hops_m, one_hops, strict=True)):
        for lane in (hm.cpu() != hw).nonzero()[:, 0].tolist():
            gates = range(k * n_gates, (k + 1) * n_gates)
            dist_bar = [(abs(float(one_m[g][lane]) - float(thresh[lane])),
                         3 * abs(float(one_m[g][lane]) - float(orc_m[g][lane]))
                         + 2 ** -9 * abs(float(orc_m[g][lane])))
                        for g in gates]
            hop_rows.append((n_decode + 1 + k, lane, int(hw[lane]),
                             int(hm[lane]), *min(dist_bar)))
    out["hop_rows"] = hop_rows
    out["hops"] = [h.cpu().tolist() for h in hops_m]
    out["one_hops"] = [h.tolist() for h in one_hops]
    return out


def cast_model(params, dtype):
    """``params`` in ``dtype`` (a new model), an MoE router kept as it
    is."""
    return rebuild(params, {k: p.detach() if k.endswith("router")
                            else p.detach().to(dtype)
                            for k, p in params.named_parameters()})


def _tp_rank(rank: int, world: int, init: str, args: dict,
             out_dir: str) -> None:
    """A spawned rank of ``tp_serve_check``."""
    from datetime import timedelta

    dev = torch.device(args["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    else:
        torch.set_num_threads(1)
        rehearsal_stand_ins()
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=TP_TIMEOUT_S))
    try:
        res = tp_rank_check(dev, args)
        torch.save(res, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def tp_serve_check(dev: torch.device, cfg, tokens: torch.Tensor,
                   thresh: list, budget: list, *,
                   n_decode: int = MESH_DECODE) -> dict:
    """The mesh serving steps tensor-parallel over ``model``: two
    processes share the card (NCCL refuses two ranks on one device) over a
    ``gloo`` group (``file://`` rendezvous), each with a (1, 2) ``("data",
    "model")`` ``DeviceMesh`` on the card, ``cfg`` at full width in bf16
    placed by the plan (``tp_rank_check``).  Held: the counts of each step
    (``n_layers`` ``flash_attention`` on the tensor cores a rank a
    prefill; ``G - 1`` top-2 partials and as many merges a FoG step); each
    rank's step parameters the sum of its blocks along ``model``, no
    parameter redistributed; the logits and every cache leaf of every step
    within the bf16 bar of the one-card steps (relative L2 from the fp32
    one-card steps at most twice the bf16 one-card steps' plus 2^-9);
    greedy tokens and hops equal to the one card's but where the one-card
    top two (or a lane's margin and its threshold) lie within the step's
    bar (each such lane printed); the residual after each layer, the
    margins and the hops identical on the two ranks.  No fallback: a
    rank's failure fails the check."""
    import tempfile

    import torch.multiprocessing as mp

    (ROOT / "build").mkdir(parents=True, exist_ok=True)
    where = Path(tempfile.mkdtemp(dir=ROOT / "build"))
    args = {"device": str(dev), "cfg": cfg, "tokens": tokens.cpu(),
            "thresh": list(thresh), "budget": list(budget),
            "n_decode": n_decode}
    t0 = time.perf_counter()
    ctx = mp.start_processes(
        _tp_rank, args=(2, str(where / "init"), args, str(where)), nprocs=2,
        join=False, start_method="spawn")
    deadline = time.monotonic() + TP_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise AssertionError(f"the two tensor-parallel ranks did not "
                                     f"finish in {TP_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(5)
    ranks = [torch.load(where / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    shutil.rmtree(where, ignore_errors=True)
    n, G = cfg.n_layers, len(grove_boundaries(cfg))
    want = ([({"flash_attention": n}, {"flash_attention_sm90": n})]
            + [({}, {})] * n_decode
            + [({"top2_confidence": 2 * (G - 1)},
                {"top2_partials": G - 1, "top2_merge": G - 1})] * n_decode)
    for r in ranks:
        for what, counts in (("timed", r["counts"]),
                             ("checked", r["checked_counts"])):
            for i, (c, w) in enumerate(zip(counts, want, strict=True)):
                if (c["launches"], c["routes"]) != w:
                    raise AssertionError(
                        f"rank {r['rank']} {what} step {i}: launches "
                        f"{c['launches']} by route {c['routes']}, want {w}")
        if r["param_bytes"] != r["param_bytes_want"]:
            raise AssertionError(f"rank {r['rank']}: step parameters "
                                 f"{r['param_bytes']} B, its blocks "
                                 f"{r['param_bytes_want']} B")
        if r["moves"]:
            raise AssertionError(f"rank {r['rank']}: {r['moves']} parameter "
                                 "redistributions in the steps")
        checked, bad = r["identical"]
        if bad or not checked:
            raise AssertionError(f"rank {r['rank']}: {bad} of {checked} "
                                 "residuals, margins and hops differ across "
                                 "the model ranks")
        over = [b for b in r["bar"] if b[3] > 1.0]
        if over:
            raise AssertionError(f"rank {r['rank']}: outside the bf16 bar "
                                 f"(what, mesh, one card, ratio): {over[:5]}")
        far = [f for f in r["flips"] if f[2] > f[3]]
        far += [h for h in r["hop_rows"] if h[4] > h[5]]
        if far:
            raise AssertionError(f"rank {r['rank']}: a token or hop differs "
                                 f"from the one card's outside the bar: "
                                 f"{far}")
    if ranks[0]["bar"] != ranks[1]["bar"] or ranks[0]["hops"] != ranks[1][
            "hops"]:
        raise AssertionError("the two ranks' comparisons differ")
    r0 = ranks[0]
    return {"ranks": [{k: r[k] for k in (
        "ms", "warm_ms", "peak_bytes", "resident_bytes", "param_bytes",
        "whole_bytes", "counts")} for r in ranks],
        "bar": max(b[3] for b in r0["bar"]), "outputs": len(r0["bar"]),
        "worst": max(r0["bar"], key=lambda b: b[3]),
        "flips": r0["flips"], "hop_rows": r0["hop_rows"],
        "hops": r0["hops"], "one_hops": r0["one_hops"],
        "identical": r0["identical"][0], "seconds": time.perf_counter() - t0}


def sharding_phase(dev: torch.device) -> dict:
    """Phase 21 (see the module docstring): a one-rank NCCL group on the
    card, the host mesh and a (1, 1, 1) mesh; the model placed by the plan
    and restored onto the mesh; a prefill through the placed parameters;
    the mesh serving steps on both meshes (``mesh_serve_check``); each
    config's per-card state under the plan at JAX's meshes; the mesh
    train step on both meshes (``mesh_train_check``) and a state saved
    from the mesh (``mesh_save_check``)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard

    out: dict = {}
    t0 = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", store=dist.HashStore(),
        rank=0, world_size=1,
        device_id=torch.device("cuda", 0) if dev.type == "cuda" else None)
    try:
        host = make_host_mesh()
        mesh = init_device_mesh(dev.type, (1, 1, 1),
                                mesh_dim_names=SHARD_AXES)
        if (MeshShape.of(host) != MeshShape(("data",), (1,))
                or host.device_type != dev.type):
            raise AssertionError(f"host mesh {host}")
        cfg = get_arch(SHARD_ARCH)
        params = bf16_model(cfg, dev)
        named = {k: p.detach() for k, p in params.named_parameters()}
        placed = {}
        for what, m in (("host", host), ("1x1x1", mesh)):
            specs = param_shardings(cfg, m, params)
            placed[what] = shard_tree(params, m, specs)
            for k, d in placed[what].named_parameters():
                check_equal(f"sharded {what} {k} local", d.to_local(),
                            named[k])
                check_equal(f"sharded {what} {k} full", d.full_tensor(),
                            named[k])
        out["leaves"] = len(named)

        # the main path: a prefill of the model rebuilt from the local
        # shards, counts zeroed just before and read just after
        tokens = torch.as_tensor(batch_at_step(
            DataConfig(cfg.vocab_size, LM_S, LM_B, seed=SEED), 0)["tokens"],
            device=dev)
        prefill_fn, _ = make_prefill_step(cfg, dev, batch=LM_B,
                                          seq_len=LM_S)
        local = rebuild(params, {k: d.to_local() for k, d in
                                 placed["1x1x1"].named_parameters()})
        want_logits, want_cache = prefill_fn(params, tokens)
        zero_counts()
        t1 = time.perf_counter()
        logits, cache = prefill_fn(local, tokens)
        torch.cuda.synchronize()
        out["prefill_ms"] = (time.perf_counter() - t1) * 1e3
        launched, routes = read_counts()
        n = cfg.n_layers
        check_counts(f"{SHARD_ARCH} prefill through sharded parameters",
                     [{"launches": launched, "routes": routes}],
                     ({"flash_attention": n}, {"flash_attention_sm90": n}))
        out["launches"], out["routes"] = launched, routes
        check_equal("prefill logits, sharded vs whole parameters", logits,
                    want_logits)
        # the mesh serving steps on both meshes, held to the one-card steps
        t1 = time.perf_counter()
        out["mesh_serve"] = mesh_serve_check(
            dev, cfg, params, {k: (m, placed[k]) for k, m in
                               (("host", host), ("1x1x1", mesh))}, tokens)
        out["mesh_serve"]["seconds"] = time.perf_counter() - t1
        cspecs = cache_shardings(cfg, mesh, cache)
        placed_cache = shard_tree(cache, mesh, cspecs)
        n_cache = 0
        for layer, want_layer, got_layer, spec_layer in zip(
                cache["stack"], want_cache["stack"], placed_cache["stack"],
                cspecs["stack"]):
            for k in ("k", "v"):
                t, d = layer["pos0"][k], got_layer["pos0"][k]
                check_equal(f"prefill cache {k}, sharded vs whole", t,
                            want_layer["pos0"][k])
                check_equal(f"cache {k} placed by the plan", d.to_local(), t)
                if (d.placements != (Shard(0), Shard(0), Shard(2))
                        or placements(spec_layer["pos0"][k], mesh)
                        != d.placements):
                    raise AssertionError(f"cache {k}: {d.placements}, want "
                                         "the batch on pod and data, the "
                                         "heads on model")
                n_cache += 1
        out["cache_leaves"] = n_cache
        del logits, cache, want_logits, want_cache, placed_cache, local

        # the model restored onto the mesh by the plan
        where = ROOT / "build" / "shard_ckpt"
        shutil.rmtree(where, ignore_errors=True)
        t1 = time.perf_counter()
        ckpt.save(0, params, where)
        specs = param_shardings(cfg, mesh, params)
        restored, _ = ckpt.restore(params, where, shardings=specs, mesh=mesh)
        out["save_restore_s"] = time.perf_counter() - t1
        for k, d in restored.named_parameters():
            check_equal(f"restored {k} on the mesh", d.to_local(), named[k])
            if d.device_mesh != mesh:
                raise AssertionError(f"restored {k} on {d.device_mesh}")
        shutil.rmtree(where, ignore_errors=True)
        del placed, restored, params, named
        torch.cuda.empty_cache()

        # the mesh train step: two steps on each mesh at phase 19's shape,
        # held to two one-card steps from the same state; the counts of
        # each step zeroed just before it and read just after
        t1 = time.perf_counter()
        n = cfg.n_layers
        out["mesh_step"] = mesh_train_check(
            dev, cfg, {"host": host, "1x1x1": mesh}, B=BF16_B, S=BF16_S,
            want=({"flash_attention": 2 * n, "flash_attention_bwd_sm90": n},
                  {"flash_attention_sm90": 2 * n}))
        out["mesh_step"]["seconds"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        out["mesh_save"] = mesh_save_check(
            dev, smoke_config(SHARD_ARCH), mesh,
            ROOT / "build" / "shard_train_ckpt", B=BF16_B, S=256)
        out["mesh_save"]["seconds"] = time.perf_counter() - t1
    finally:
        dist.destroy_process_group()
    # the tensor-parallel part, once the one-rank group is gone: the top-2
    # kernel's partials and merge, then two processes on the card
    torch.cuda.empty_cache()
    out["top2_blocks"] = top2_block_checks(dev)
    out["tp"] = tp_serve_check(dev, cfg, tokens, out["mesh_serve"]["thresh"],
                               out["mesh_serve"]["budget"])
    print(f"[shard] {SHARD_ARCH} bf16 ({out['leaves']} leaves) by the plan "
          f"on the host mesh (1 NCCL rank, ('data',)) and a (1, 1, 1) "
          f"{SHARD_AXES} mesh: each to_local() and full_tensor() == its leaf "
          f"bit for bit; prefill {LM_B} x {LM_S} of the model rebuilt from "
          f"the local shards {out['prefill_ms']:.1f} ms, launches "
          f"{out['launches']} by route {out['routes']}, logits and cache == "
          f"the whole parameters' bit for bit; {out['cache_leaves']} K/V "
          f"cache leaves placed by the plan (batch on pod and data, heads on "
          f"model), bit-equal; "
          f"save + restore onto the mesh {out['save_restore_s']:.1f} s, "
          f"every leaf bit-equal", flush=True)
    ms = out["mesh_step"]
    print(f"[shard] the mesh train step, {SHARD_ARCH} bf16 at {BF16_B} x "
          f"{BF16_S}, {MESH_STEPS} steps on the host mesh and on the "
          f"(1, 1, 1) mesh: every parameter, moment ({ms['host']['leaves']} "
          f"leaves), loss and grad norm == {MESH_STEPS} one-card steps from "
          f"the same state bit for bit; per step {ms['1x1x1']['launches']} "
          f"by route {ms['1x1x1']['routes']}; step ms host mesh "
          f"{[round(x, 1) for x in ms['host']['ms']]}, (1, 1, 1) "
          f"{[round(x, 1) for x in ms['1x1x1']['ms']]}, one card "
          f"{[round(x, 1) for x in ms['one_device']['ms']]}; losses "
          f"{[round(x, 4) for x in ms['one_device']['losses']]}; "
          f"{ms['seconds']:.1f} s", flush=True)
    sv_ = out["mesh_serve"]

    def ms_of(run, what):
        return [round(x, 2) for x in sv_[run]["ms"][what]]

    print(f"[shard] the mesh serving steps, {SHARD_ARCH} bf16: "
          f"make_prefill_step(mesh=) of {LM_B} x {LM_S} (a cache of "
          f"{LM_S + 2 * MESH_DECODE} positions), {MESH_DECODE} greedy "
          f"make_serve_step(mesh=) steps and {MESH_DECODE} FoG steps "
          f"('pallas' margin) at per-lane thresholds "
          f"{[round(x, 6) for x in sv_['thresh']]} and budgets "
          f"{sv_['budget']} (hops {sv_['hops']}), on the host mesh and on "
          f"the (1, 1, 1) mesh: logits, hops and every cache leaf "
          f"({sv_['1x1x1']['outputs']} outputs, to_local() and "
          f"full_tensor()) == the one-card steps bit for bit; launches a "
          f"step {sv_['1x1x1']['counts']}; {card_name(dev)}: prefill ms "
          f"host {ms_of('host', 'prefill')}, (1, 1, 1) "
          f"{ms_of('1x1x1', 'prefill')}, one card "
          f"{ms_of('one_card', 'prefill')}; decode ms host "
          f"{ms_of('host', 'decode')}, (1, 1, 1) {ms_of('1x1x1', 'decode')}, "
          f"one card {ms_of('one_card', 'decode')}; FoG ms host "
          f"{ms_of('host', 'fog')}, (1, 1, 1) {ms_of('1x1x1', 'fog')}, one "
          f"card {ms_of('one_card', 'fog')}; flash_attention_sm90 on q heads "
          f"{sv_['head_slice']['q_heads']} and KV heads "
          f"{sv_['head_slice']['kv_heads']} (rank {HEAD_SLICE[0]} of "
          f"{HEAD_SLICE[1]} along model) of layer 0's "
          f"{sv_['head_slice']['shape']} q == that slice of the whole call "
          f"bit for bit" + (
              f" ({sv_['head_slice']['ms']:.4f} ms a call on the rank's "
              f"heads, the whole call {sv_['head_slice']['whole_ms']:.4f}, "
              f"plain {sv_['head_slice']['plain_ms']:.3f}, SDPA "
              f"{sv_['head_slice']['library_ms']:.4f}, bound "
              f"{sv_['head_slice']['bound'][0]:.4f} ms by "
              f"{sv_['head_slice']['bound'][1]})"
              if "ms" in sv_["head_slice"] else "")
          + f"; {sv_['seconds']:.1f} s", flush=True)
    tb, tp = out["top2_blocks"], out["tp"]
    print(f"[shard] top2_confidence's partials and merge entries (a mesh "
          f"rank's block of each row): partials of each block and the merge "
          f"== their plain versions == one top2_confidence call on the whole "
          f"rows bit for bit, 0 where a maximum repeats across the blocks, "
          f"at {list(tb['cases'])}" + (
              f"; {card_name(dev)}: partials + merge of a rank's [4, 16000] "
              f"block {tb['block_ms']:.4f} ms (partials {tb['partials_ms']:.4f}"
              f", merge of 2 ranks' {tb['merge_ms']:.4f}), the one call on "
              f"the whole [4, 32000] {tb['whole_ms']:.4f}, plain "
              f"{tb['plain_ms']:.4f}, torch.topk on the block "
              f"{tb['library_ms']:.4f}, bound {tb['bound_ms']:.5f} ms by "
              f"{tb['bound_by']}" if "block_ms" in tb else ""), flush=True)

    def per_rank(what):
        return [[round(x, 2) for x in r["ms"][sl[what]]] for r in tp["ranks"]]

    sl = {"prefill": slice(0, 1), "decode": slice(1, 1 + MESH_DECODE),
          "fog": slice(1 + MESH_DECODE, None)}
    print(f"[shard] tensor-parallel serving over model: 2 processes on one "
          f"card over gloo, a {TP_MESH[0]} {TP_MESH[1]} mesh each, "
          f"{SHARD_ARCH} bf16 placed by the plan; per rank the step's "
          f"parameters {[r['param_bytes'] for r in tp['ranks']]} B (the sum "
          f"of its blocks; whole {tp['ranks'][0]['whole_bytes']} B), no "
          f"parameter redistributed; launches a step per rank "
          f"{tp['ranks'][0]['counts'][0]}, {tp['ranks'][0]['counts'][1]}, "
          f"{tp['ranks'][0]['counts'][-1]} (prefill, decode, FoG); "
          f"{tp['outputs']} outputs (logits and every cache leaf of each "
          f"step) within the bf16 bar of the one card (worst at "
          f"{tp['worst'][3]:.3f} of it: {tp['worst'][0]}, relative L2 "
          f"{tp['worst'][1]:.3e} vs the one card's {tp['worst'][2]:.3e}); "
          f"greedy tokens unlike the one card's (step, lane, top-2 gap / "
          f"scale, bar): {tp['flips']}; hops {tp['hops']} (one card "
          f"{tp['one_hops']}), lanes unlike it (step, lane, one card, mesh, "
          f"margin's distance from the threshold, bar): {tp['hop_rows']}; "
          f"{tp['identical']} residuals, margins and hops identical on both "
          f"ranks; {card_name(dev)}: per rank peak "
          f"{[round(r['peak_bytes'] / 1e9, 2) for r in tp['ranks']]} GB "
          f"(resident before the steps "
          f"{[round(r['resident_bytes'] / 1e9, 2) for r in tp['ranks']]} "
          f"GB); first steps (warm-up) ms per rank "
          f"{[[round(x, 1) for x in r['warm_ms']] for r in tp['ranks']]}; "
          f"prefill ms per rank {per_rank('prefill')}, one card "
          f"{ms_of('one_card', 'prefill')}; decode ms {per_rank('decode')}, "
          f"one card {ms_of('one_card', 'decode')}; FoG ms "
          f"{per_rank('fog')}, one card {ms_of('one_card', 'fog')}; "
          f"{tp['seconds']:.1f} s", flush=True)
    sv = out["mesh_save"]
    print(f"[shard] {SHARD_ARCH}'s smoke config trained {MESH_STEPS} mesh "
          f"steps on the (1, 1, 1) mesh, saved from the mesh "
          f"{sv['save_s']:.2f} s and restored on the card "
          f"{sv['restore_s']:.2f} s: {sv['leaves']} leaves bit-equal "
          f"({sv['seconds']:.1f} s with the steps)", flush=True)

    # each config's per-card state under the plan, counted on meta
    out["per_device"] = {}
    for arch in sorted(ARCHS):
        c = get_arch(arch)
        lm = T.init_params(c, MetaDraws(), torch.bfloat16, device="meta")
        moments = adamw()[0]({k: p.detach()
                              for k, p in lm.named_parameters()})
        for mesh_name in MESHES:
            pd = per_device_state(c, mesh_name, lm,
                                  {"moments": (moments.mu, moments.nu)})
            out["per_device"][f"{arch} {mesh_name}"] = pd
            print(f"[shard] {arch} on {mesh_name} (FSDP "
                  f"{'on' if pd['fsdp'] else 'off'}): a card holds params "
                  f"{pd['param_bytes']:,} B, state (params, bf16 grads, "
                  f"fp32 moments) {pd['state_bytes']:,} B", flush=True)
    out["seconds"] = time.perf_counter() - t0
    print(f"[shard] phase 21 in {out['seconds']:.1f} s on "
          f"{card_name(dev)}", flush=True)
    return out


def roofline_lines(timing: dict, eval_fns: dict, ring: dict, packs: dict,
                   F: int) -> dict:
    """The FoG roofline model (``launch.roofline``, one H100 SXM) of each
    backend's eval at the bench field beside its measured call ms (CUDA
    events, phase 6 / 9) and device ms (the profiler, phase 14): fused
    (tables once, each lane's row and outputs once; FLOPs over its hops),
    per-hop ``pallas`` and the ring on ``RingMesh(8)``.  The per-hop
    eval is priced at the card's HBM traffic, the tables once an
    iteration (the model's fused class at ``chunks = iters``): the
    model's own per-hop class re-reads each lane's grove slice every
    iteration, the TPU kernel's traffic, which the card serves from its
    50 MB L2.  A share over 100 % means a model the measurement beats: it
    raises.  Each eval's hops are those of one more call of the timed
    eval."""
    rows = {}
    for (nb, p), row in sorted(timing.items()):
        model = RooflineModel(packs[p], F)
        rrow = ring["timing"][nb, p]
        hops = eval_fns[nb, p, "fused"]().hops
        check_equal(f"roofline B={nb} {p}: per-hop eval hops",
                    eval_fns[nb, p, "pallas"]().hops, hops)
        ring_hops = ring["eval_fns"][nb, p, RING_MESHES[0]]().hops
        evals = {
            "fused": (model.estimate("fused", nb, iters=int(hops.max()),
                                     hops_total=float(hops.sum()),
                                     compact=True),
                      row["eval_fused_ms"],
                      row["eval_fused_profile"]["device_busy_ms"]),
            "pallas": (model.estimate("fused", nb, iters=MAX_HOPS,
                                      hops_total=float(hops.sum()),
                                      chunks=MAX_HOPS),
                       row["eval_pallas_ms"],
                       row["eval_pallas_profile"]["device_busy_ms"]),
            "ring": (model.estimate(f"ring-{RING_MESHES[0]}", nb,
                                    iters=MAX_HOPS,
                                    hops_total=float(ring_hops.sum())),
                     rrow[f"eval_ring{RING_MESHES[0]}_ms"],
                     rrow[f"eval_ring{RING_MESHES[0]}_profile"][
                         "device_busy_ms"])}
        for b, (est, call_ms, dev_ms) in evals.items():
            def pct(ms):
                """est's achieved share of ``ms`` (None: not recorded)."""
                return None if ms is None else 100 * est.achieved(ms * 1e-3)

            r = est.to_dict()
            r.update(call_ms=call_ms, device_ms=dev_ms,
                     achieved_call_pct=pct(call_ms),
                     achieved_device_pct=pct(dev_ms))
            rows[f"B={nb} {p} {b}"] = r
            print(f"[roofline] B={nb} {p} {b}: {est.bytes_moved:.4g} B, "
                  f"{est.flops:.4g} FLOP, {est.bound}-bound, ideal "
                  f"{est.ideal_s * 1e3:.6f} ms on {est.spec.name}; achieved "
                  f"{fmt_share(r['achieved_call_pct'])} % of the call "
                  f"({call_ms:.4f} ms), "
                  f"{fmt_share(r['achieved_device_pct'])} % of the device "
                  f"ms ({fmt(dev_ms)})", flush=True)
            over = [g for g in ("achieved_call_pct", "achieved_device_pct")
                    if r[g] is not None and r[g] > 100.0]
            if over:
                raise AssertionError(
                    f"roofline B={nb} {p} {b}: {over} over 100 % -- the "
                    f"model claims more work than the card needed: {r}")
    return rows


def stamp(what: str, t0: float) -> None:
    """Print the seconds since ``t0`` at which a phase starts."""
    print(f"[phase] {what} at {time.perf_counter() - t0:.1f} s", flush=True)


def main() -> int:
    t_main = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    out: dict = {}
    if "--sweep" in sys.argv[1:]:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip())
        _build.build()
        ds, gc, packs = bench_field(dev)
        x = torch.as_tensor(ds.x_test, device=dev)
        rows = ([] if "grove_aggregate" in sys.argv[2:] else
                sweep_phase(dev, packs, x, SWEEP_GRID))
        gen = torch.Generator(device=dev)
        inputs = {}
        for nb in AGG_SWEEP["B"]:
            xb = x.repeat(-(-nb // x.shape[0]), 1)[:nb].contiguous()
            sb = sample_starts(gen.manual_seed(SEED), nb, gc.n_groves)
            for share, a in aggregate_shares(packs["fp32"], xb, sb).items():
                inputs[nb, share] = a
        rows += aggregate_sweep(inputs, AGG_SWEEP["lanes"])
        empty_ms = profiled_ms(empty_launch(dev), "empty")
        rows.append({"kernel": "empty", "device_ms": empty_ms})
        print(f"[sweep] an empty kernel: {fmt(empty_ms)} ms on the device")
        (ROOT / "build").mkdir(exist_ok=True)
        (ROOT / "build" / "chip_sweep.json").write_text(
            json.dumps({"rows": rows}, indent=1))
        return 0

    # 1. device -------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    print(f"[device] {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}")
    out["device"] = {"nvidia_smi": smi, "name": name,
                     "torch": torch.__version__, "cuda": torch.version.cuda}

    # 2. build --------------------------------------------------------------
    stamp("2. build", t_main)
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    build_s = time.perf_counter() - t0
    print(f"[build] {lib_path.name} in {build_s:.1f} s (nvcc "
          f"{_build.build_info.get('seconds', 0.0):.1f} s)")
    for line in _build.build_info.get("log", "").splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling",
                                   "C75")):
            print(f"[build]   {line.strip()}")
    out["build_s"] = build_s
    hgmma = hgmma_per_kernel(lib_path)
    print(f"[build] SASS: HGMMA (wgmma) instructions per instance of "
          f"flash_attention_kernel_sm90<D, Dv, keys>, the backward's "
          f"flash_attention_bwd_sm90_dkdv / _dkdv_split / _dq<D, Dv>, "
          f"ssd_chunk_kernel_sm90<N> and the SSD backward's "
          f"ssd_bwd_sm90_ds / _dx / _dbdc<N>: {hgmma}")
    for kernel, counts in hgmma.items():
        if not counts or not all(counts.values()):
            raise AssertionError(f"an instance of {kernel} has no HGMMA "
                                 f"instruction in the SASS: {counts}")
    out["hgmma_per_kernel"] = hgmma
    spills = ptxas_spills(_build.build_info.get("log", ""),
                          "ssd_chunk_kernel_sm90")
    print(f"[build] ptxas spill bytes per ssd_chunk_kernel_sm90 instance: "
          f"{spills}")
    if _build.build_info.get("log") and (not spills or any(spills.values())):
        raise AssertionError(f"ptxas reports spills in ssd_chunk_kernel_sm90 "
                             f"(or no report): {spills}")
    out["ssd_chunk_sm90_spill_bytes"] = spills
    out["ptxas"] = {}
    log = _build.build_info.get("log", "")
    for kernel, name_of in ([(k, flash_instance) for k in FLASH_SM90]
                            + [("ssd_bwd_sm90", ssd_bwd_instance)]
                            + [(k, instance) for k in NEW_KERNELS.values()]):
        spills = {name_of(n): v for n, v in ptxas_spills(log, kernel).items()}
        regs = {name_of(n): v for n, v in ptxas_registers(log,
                                                          kernel).items()}
        print(f"[build] ptxas per {kernel} instance: registers {regs}, "
              f"spill bytes {spills}")
        if log and (not spills or any(spills.values())):
            raise AssertionError(f"ptxas reports spills in {kernel} (or no "
                                 f"report): {spills}")
        out["ptxas"][kernel] = {"registers": regs, "spill_bytes": spills}
    # the SIMT attention backward (CUDA cores, fp32 sums): its registers
    # and spills, reported
    spills = {simt_bwd_instance(n): v for n, v in ptxas_spills(
        log, "flash_attention_bwd_").items() if "sm90" not in n}
    regs = {simt_bwd_instance(n): v for n, v in ptxas_registers(
        log, "flash_attention_bwd_").items() if "sm90" not in n}
    print(f"[build] ptxas per flash_attention_bwd (SIMT) kernel: registers "
          f"{regs}, spill bytes {spills}")
    out["ptxas"]["flash_attention_bwd"] = {"registers": regs,
                                           "spill_bytes": spills}
    # the SIMT attention forward (CUDA cores, register tiles): the same,
    # reported
    spills = {simt_fwd_instance(n): v for n, v in ptxas_spills(
        log, "flash_attention_kernelI").items() if simt_fwd_instance(n)}
    regs = {simt_fwd_instance(n): v for n, v in ptxas_registers(
        log, "flash_attention_kernelI").items() if simt_fwd_instance(n)}
    print(f"[build] ptxas per flash_attention (SIMT forward) instance "
          f"<type, RX, RY, NQ>: registers {regs}, spill bytes {spills}")
    out["ptxas"]["flash_attention_simt"] = {"registers": regs,
                                            "spill_bytes": spills}
    # the SIMT SSD kernels, forward and backward: the same, reported
    spills = {simt_ssd_instance(n): v for n, v in ptxas_spills(
        log, "ssd_").items() if simt_ssd_instance(n)}
    regs = {simt_ssd_instance(n): v for n, v in ptxas_registers(
        log, "ssd_").items() if simt_ssd_instance(n)}
    print(f"[build] ptxas per SIMT ssd_chunk / ssd_chunk_bwd kernel: "
          f"registers {regs}, spill bytes {spills}")
    out["ptxas"]["ssd_simt"] = {"registers": regs, "spill_bytes": spills}

    # 3. train and pack -----------------------------------------------------
    stamp("3. train and pack", t_main)
    t0 = time.perf_counter()
    phase3_s = t0 - t_main
    ds, gc, packs = bench_field(dev)
    for p, pack in packs.items():
        cpu_pack = ForestPack.from_groves(gc, p)
        for f in ("feature", "threshold", "leaf", "thr_scale", "leaf_scale"):
            if getattr(pack, f).device.type != "cuda":
                raise AssertionError(f"{p} {f} was not packed on the card")
            check_equal(f"{p} {f} packed on the card vs the CPU",
                        getattr(pack, f), getattr(cpu_pack, f))
        if pack.table_bytes != TABLE_BYTES[p]:
            raise AssertionError(f"{p} table_bytes {pack.table_bytes} != "
                                 f"{TABLE_BYTES[p]}")
    print(f"[train] penbased 16 trees depth 8 -> {gc.n_groves} groves x "
          f"{gc.grove_size} in {time.perf_counter() - t0:.1f} s; table_bytes "
          + ", ".join(f"{p} {packs[p].table_bytes}" for p in PRECISIONS)
          + "; packed on the card == packed on the CPU")

    # 4. evaluate: the main path ---------------------------------------------
    stamp("4. evaluate", t_main)
    x = torch.as_tensor(ds.x_test, device=dev)
    y = torch.as_tensor(ds.y_test, device=dev)
    B, F = x.shape
    policy = FogPolicy(threshold=THRESH, max_hops=MAX_HOPS)
    engines = {(p, b): FogEngine(packs[p], backend=b, device=dev)
               for p in PRECISIONS for b in BACKENDS}
    gen = torch.Generator(device=dev)
    reports, margins = {}, {}
    for k in ops.launches:
        ops.launches[k] = 0
    for k in _build.routes:
        _build.routes[k] = 0
    for p in PRECISIONS:
        for b in BACKENDS:
            gen.manual_seed(SEED)      # the same start draws for each run
            reports[p, b] = engines[p, b].eval(x, gen, policy=policy)
        # the final confidence of each classification (top-2 kernel)
        margins[p] = confidence_margin(reports[p, "pallas"].proba,
                                       backend="pallas")
    torch.cuda.synchronize()
    main_launches = {k: ops.launches[k] for k in INFERENCE_KERNELS}
    print(f"[eval] kernel launches on the main path: {main_launches}")
    for k, n in main_launches.items():
        if n < 1:
            raise AssertionError(f"kernel {k} was not launched on the main "
                                 "path")
    fused_routes = {k: _build.routes[k] for k in FUSED_ROUTES}
    agg_routes = {k: _build.routes[k] for k in AGG_ROUTES}
    print(f"[eval] fused_fog by route: {fused_routes}; grove_aggregate by "
          f"route: {agg_routes}")
    if (agg_routes["grove_aggregate"]
            or agg_routes["grove_aggregate_tile"] != len(PRECISIONS) * MAX_HOPS
            or main_launches["grove_aggregate"] != len(PRECISIONS) * MAX_HOPS):
        raise AssertionError(
            f"want {MAX_HOPS} grove_aggregate launches per per-hop eval, each "
            f"on the tile route: {main_launches['grove_aggregate']} "
            f"launches, {agg_routes}")
    if (main_launches["fused_fog"] != len(PRECISIONS)
            or fused_routes["fused_fog"]
            or sum(fused_routes.values()) != len(PRECISIONS)):
        raise AssertionError(
            f"want one fused_fog launch per fused eval, each on a group "
            f"route: {main_launches['fused_fog']} launches, {fused_routes}")

    start = sample_starts(gen.manual_seed(SEED), B, gc.n_groves)
    errs = {"fused_fog": 0.0, "grove_aggregate": 0.0, "top2_confidence": 0.0}
    results = {}
    for p in PRECISIONS:
        want = reports[p, "reference"]
        for b in ("fused", "pallas"):
            got = reports[p, b]
            check_equal(f"{p} {b} hops", got.hops, want.hops)
            check_equal(f"{p} {b} labels", got.label, want.label)
            e = check_close(f"{p} {b} proba", got.proba, want.proba)
            errs["fused_fog" if b == "fused" else "grove_aggregate"] = max(
                errs["fused_fog" if b == "fused" else "grove_aggregate"], e)
        for b in BACKENDS:
            r = reports[p, b]
            check_equal(f"{p} {b} energy", r.energy_pj,
                        r.model.lane_pj(r.hops))
        errs["top2_confidence"] = max(errs["top2_confidence"], check_close(
            f"{p} top2 margins", margins[p],
            ref.top2_confidence_ref(reports[p, "pallas"].proba)))
        # the plain path on the CPU, from the same start draws
        cpu = FogEngine(packs[p].to("cpu"), device="cpu").eval(
            ds.x_test, policy=policy, start=start.cpu())
        check_equal(f"{p} cpu hops", reports[p, "fused"].hops, cpu.hops)
        check_equal(f"{p} cpu labels", reports[p, "fused"].label, cpu.label)
        check_close(f"{p} cpu proba", reports[p, "fused"].proba, cpu.proba)
        r = reports[p, "fused"]
        acc = float((r.label == y).float().mean())
        results[p] = {"accuracy": acc, "mean_hops": float(r.hops.float().mean()),
                      "pj_per_classification": r.mean_energy_pj}
        print(f"[eval] {p}: accuracy {acc:.3f}, mean hops "
              f"{results[p]['mean_hops']:.3f}, "
              f"{results[p]['pj_per_classification']:.2f} pJ/classification;"
              " fused == pallas == reference == cpu")
        if acc < 0.93:
            raise AssertionError(f"{p} accuracy {acc:.3f} < 0.93")
    out["eval"] = results
    out["main_launches"] = main_launches

    # each kernel against its plain version, on the card --------------------
    rng = np.random.default_rng(SEED)
    lane_thr = torch.as_tensor(rng.random(B, dtype=np.float32), device=dev)
    lane_bud = torch.as_tensor(rng.integers(1, MAX_HOPS + 1, B,
                                            dtype=np.int32), device=dev)
    rf2 = train_random_forest(ds.x_train, ds.y_train, ds.n_classes,
                              TrainConfig(n_trees=16, max_depth=8, seed=2))
    two = (gc, split(rf2, 2))
    cases = [(p, packs[p]) for p in PRECISIONS] + [
        ("int8 two heads", ForestPack.from_groves(two, "int8").to(dev)),
        ("fp32 two heads", ForestPack.from_groves(two, "fp32").to(dev))]
    out["fused_fog_checks"] = fused_checks(dev, cases, x, gen)
    # grove_aggregate at a mid-loop state (two plain hops, some lanes dead)
    # on both routes, then every case of aggregate_checks
    pack = packs["fp32"]
    prob = torch.zeros((B, ds.n_classes), device=dev)
    live = torch.ones((B,), dtype=torch.bool, device=dev)
    hops = torch.zeros((B,), dtype=torch.int32, device=dev)
    for j in range(3):
        contrib = pack.predict_proba(0, (start.long() + j) % gc.n_groves, x)
        args = (prob, contrib, live, hops, lane_thr)
        if j == 2:
            want = ref.grove_aggregate_ref(*args)
            for route in ga.ROUTES:
                aggregate_equal(f"grove_aggregate {route} mid-loop",
                                ga.grove_aggregate_on_route(*args,
                                                            route=route),
                                want)
        prob, hops, live, _ = ref.grove_aggregate_ref(*args)
    out["grove_aggregate_cases"] = aggregate_checks(dev)
    print(f"[kernels] grove_aggregate == its plain version bit for bit (all "
          f"four outputs) on both routes {ga.ROUTES}: a mid-loop state and "
          f"{out['grove_aggregate_cases']} cases (B {AGG_B}, C {AGG_C}, "
          f"kinds {AGG_KINDS}, scalar and per-lane thresholds; a row-offset "
          f"view with NaN dead contrib; B={BIG_B})")
    # top2 with ties at the max and below it
    ties = reports["fp32", "fused"].proba.clone()
    ties[:64, 3] = ties[:64, 7] = 2.0
    ties[64:128] = 0.1
    check_equal("top2 ties", ops.top2_confidence(ties),
                ref.top2_confidence_ref(ties))
    out["top2_checks"] = top2_checks(dev)
    print(f"[kernels] each kernel equals its plain version on the card; "
          f"max abs err {errs}; top2_confidence bit-equal with repeated "
          f"maxima at {out['top2_checks']} (blocks per row; 0: one thread "
          f"per row)")

    # 6. time: CUDA events first, then the profiler (once CUPTI has traced
    # the process, every launch costs the host more, so no event timing
    # may follow a profile) -----------------------------------------------
    timing, kernel_fns, eval_fns, agg_inputs = {}, {}, {}, {}
    C = ds.n_classes
    latency_ns = {p: load_latency_ns(dev, TABLE_BYTES[p]) for p in PRECISIONS}
    print("[time] dependent-load latency (fog_chase over a working set of "
          "the packed table): " + ", ".join(
              f"{p} {TABLE_BYTES[p]} B {latency_ns[p]:.2f} ns"
              for p in PRECISIONS))
    out["load_latency_ns"] = latency_ns
    for nb in (B, BIG_B):
        xb = x.repeat((nb + B - 1) // B, 1)[:nb].contiguous()
        sb = sample_starts(gen.manual_seed(SEED), nb, gc.n_groves)
        thr_b = torch.full((nb,), THRESH, device=dev)
        bud_b = torch.full((nb,), MAX_HOPS, dtype=torch.int32, device=dev)
        for p in PRECISIONS:
            pack = packs[p]
            args = (*pack.layout("fused")[:3], xb, sb, thr_b, bud_b,
                    *pack.layout("fused")[3:])
            fused = lambda a=args: ops.fused_fog(*a, max_hops=MAX_HOPS,
                                                 block_b=FUSED_BLOCK_B)
            # the first port's kernel as the engine ran it (128 threads)
            was = lambda a=args: ff.fused_fog_on_route(
                *a, max_hops=MAX_HOPS, block_b=128, route="lane")
            before = dict(_build.routes)
            _, hk = fused()
            route = [k for k in FUSED_ROUTES
                     if _build.routes[k] != before[k]]
            check_equal(f"fused_fog {p} B={nb}: the first kernel",
                        was()[1], hk)
            work = fused_work(pack, xb, sb, hk)
            row = {"mean_hops": float(hk.float().mean()),
                   "fused_fog_route": route,
                   "fused_fog_distinct": work["distinct"],
                   "fused_fog_bytes": work["bytes"],
                   "fused_fog_chain_loads": work["chain"],
                   "fused_fog_serial_chain_loads": work["serial_chain"],
                   "fused_fog_gather_bound_ms":
                       work["gathered"] / HBM_BYTES_PER_S * 1e3,
                   "fused_fog_latency_bound_ms":
                       work["chain"] * latency_ns[p] * 1e-6,
                   "fused_fog_serial_chain_ms":
                       work["serial_chain"] * latency_ns[p] * 1e-6}
            row["fused_fog_bound_ms"], row["fused_fog_bound_by"] = bound_ms(
                work["bytes"], work["ops"])
            row["fused_fog_ms"] = cuda_ms(fused)
            row["fused_fog_was_ms"] = cuda_ms(was)
            row["fused_fog_plain_ms"] = cuda_ms(
                lambda a=args: fused_fog_ref(*a, max_hops=MAX_HOPS))
            kernel_fns[nb, p, "fused_fog"] = fused
            kernel_fns[nb, p, "fused_fog_was"] = was
            for b in BACKENDS:
                ev = lambda e=engines[p, b], xx=xb: e.eval(
                    xx, gen.manual_seed(SEED), policy=policy)
                before = dict(ops.launches)
                routes = dict(_build.routes)
                ev()
                row[f"{b}_launches_per_eval"] = {
                    k: ops.launches[k] - before[k] for k in ops.launches}
                row[f"{b}_routes_per_eval"] = {
                    k: _build.routes[k] - routes[k] for k in _build.routes
                    if _build.routes[k] != routes[k]}
                if b == "fused" and (
                        row["fused_launches_per_eval"]["fused_fog"] != 1
                        or list(row["fused_routes_per_eval"]) != route):
                    raise AssertionError(
                        f"B={nb} {p}: a fused eval launched "
                        f"{row['fused_launches_per_eval']} by route "
                        f"{row['fused_routes_per_eval']}, want one fused_fog "
                        f"launch on {route}")
                if b == "pallas" and row["pallas_routes_per_eval"] != {
                        "grove_aggregate_tile": MAX_HOPS}:
                    raise AssertionError(
                        f"B={nb} {p}: a per-hop eval launched by route "
                        f"{row['pallas_routes_per_eval']}, want {MAX_HOPS} "
                        f"on grove_aggregate_tile")
                row[f"eval_{b}_ms"] = cuda_ms(ev)
                row[f"eval_{b}_classifications_per_s"] = (
                    nb / row[f"eval_{b}_ms"] * 1e3)
                eval_fns[nb, p, b] = ev
            timing[nb, p] = row
        # grove_aggregate at the per-hop path's live shares (the eval's own
        # start draws), the tile kernel beside the first kernel; one
        # dependent load priced over the inputs' bytes
        row = timing[nb, "fp32"]
        shares = aggregate_shares(packs["fp32"], xb, sb)
        chase_ns = load_latency_ns(dev, aggregate_work(
            shares["all live"])["working_set"])
        row["grove_aggregate_shares"] = {}
        for share, a in shares.items():
            agg_inputs[nb, share] = a
            work = aggregate_work(a)
            r = {"live_lanes": work["live_lanes"], "chase_ns": chase_ns,
                 "ms": cuda_ms(lambda a=a: ops.grove_aggregate(*a)),
                 "was_ms": cuda_ms(lambda a=a: ga.grove_aggregate_on_route(
                     *a, route="lane")),
                 "plain_ms": cuda_ms(
                     lambda a=a: ref.grove_aggregate_ref(*a))}
            r["bound_ms"], r["bound_by"] = bound_ms(work["bytes"],
                                                    work["ops"])
            row["grove_aggregate_shares"][share] = r
        # the per-hop kernels' row: the share of the path's hops 2-8
        row.update({f"grove_aggregate_{k}": v for k, v in
                    row["grove_aggregate_shares"]["hop 2"].items()})
        prob = torch.rand((nb, C), device=dev)
        kernel_fns[nb, "fp32", "top2_confidence"] = (
            lambda q=prob: ops.top2_confidence(q))
        row["top2_confidence_ms"] = cuda_ms(
            kernel_fns[nb, "fp32", "top2_confidence"])
        row["top2_confidence_plain_ms"] = cuda_ms(
            lambda q=prob: ref.top2_confidence_ref(q))
        row["top2_confidence_library_ms"] = cuda_ms(
            lambda q=prob: torch.topk(q, 2, dim=-1))
        row["top2_confidence_bound_ms"], row["top2_confidence_bound_by"] = (
            bound_ms(nb * (C + 1) * 4, nb * 3 * C))

    # 7. the device trainer, and 8. the facade (each its own main path) ----
    stamp("7-8. trainer and facade", t_main)
    (ROOT / "build").mkdir(exist_ok=True)
    train = train_phase(dev, ds)
    out["train"] = {k: v for k, v in train.items()
                    if k not in ("level_fns", "gate_fit")}
    out["facade"] = facade_phase(dev, ds)
    main_launches["histogram"] = train["launches"]["histogram"]

    # 9. the grove ring (its own main path) --------------------------------
    stamp("9. ring", t_main)
    ring = ring_phase(dev, ds, packs, gen)
    ring_latency_bounds(dev, ring["timing"])
    main_launches["tree_traverse"] = ring["launches"]["tree_traverse"]

    # 17. LM training (its own main path), while the card's memory is free
    stamp("17. LM training", t_main)
    train_lm_out = lm_train_phase(dev)
    main_launches["flash_attention_bwd"] = (
        train_lm_out["launches_per_step"]["flash_attention_bwd"] * TRAIN_STEPS)

    # 18. Mamba training (its own main path), while the card's memory is free
    stamp("18. Mamba training", t_main)
    train_mamba = mamba_train_phase(dev)
    main_launches["ssd_chunk_bwd"] = (
        train_mamba["launches_per_step"]["ssd_chunk_bwd"] * TRAIN_STEPS)

    # 19. bf16 training (its own main path), while the card's memory is free
    stamp("19. bf16 training", t_main)
    train_bf16 = bf16_train_phase(dev)
    main_launches["flash_attention_bwd_sm90"] = (
        train_bf16["tinyllama"]["launches_per_step"][
            "flash_attention_bwd_sm90"] * BF16_STEPS
        + train_bf16["minicpm3"]["launches_per_step"][
            "flash_attention_bwd_sm90"] * BF16_MLA_STEPS)
    main_launches["ssd_chunk_bwd_sm90"] = (
        train_bf16["mamba2"]["launches_per_step"]["ssd_chunk_bwd_sm90"]
        * BF16_STEPS)

    # 20. train_4k at its full batch (its own main path), the dry run, the
    # accumulation checks and the serving example, while memory is free
    stamp("20. full-batch train_4k", t_main)
    full = full_batch_phase(dev, train_bf16["tinyllama"]["peak_gb"])
    out["full_batch"] = full

    # 21. the sharding plan on the card (its own main path), while memory
    # is free
    stamp("21. sharding plan", t_main)
    out["sharding"] = sharding_phase(dev)

    # 16. the rest of the LM layers (its own main paths), before the LM
    # phases whose weights stay on the card for the profiler -------------
    stamp("16. MLA, MoE, hybrid LMs", t_main)
    more_lm = lm_more_phase(dev)

    # 10. Mamba-2 serving at full width and depth (its own main path) -------
    stamp("10. Mamba-2", t_main)
    lm = lm_phase(dev)
    main_launches["ssd_chunk"] = lm["launches"]["ssd_chunk"]

    # 11. attention serving at full width and depth (its own main path) -----
    stamp("11. attention", t_main)
    attn = lm_phase(dev, get_arch(ATTN_ARCH))
    main_launches["flash_attention"] = attn["launches"]["flash_attention"]

    # 12. the serving plane (its own main paths) ----------------------------
    stamp("12. serving plane", t_main)
    serve = serve_phase(dev)
    n_layers = T.layer_plan(get_arch(ATTN_ARCH))[2]
    lm_launches = serve["lm"]["launches"]
    if (lm_launches.get("flash_attention") != 8 * n_layers
            or lm_launches.get("top2_confidence", 0) < 1
            or set(lm_launches) != {"flash_attention", "top2_confidence"}):
        raise AssertionError(f"LM serve: launches {lm_launches}, want "
                             f"{n_layers} flash_attention a prefill and the "
                             "gate's top2_confidence")

    # 13. the paper's evaluation path (its own main path) -------------------
    stamp("13. paper", t_main)
    paper = paper_phase(dev)

    # 15. the fused autotuner (its own main path) ----------------------------
    stamp("15. autotuner", t_main)
    tuned = tune_phase(dev, packs, x)

    # 14. the profiler, after every event timing ----------------------------
    stamp("14. profiler", t_main)
    lm_train_profile(train_lm_out, dev)
    out["train_lm"] = train_lm_out
    stamp("14. profiler: Mamba training", t_main)
    mamba_train_profile(train_mamba, dev)
    out["train_mamba"] = train_mamba
    stamp("14. profiler: bf16 training", t_main)
    bf16_train_profile(train_bf16, dev)
    out["train_bf16"] = train_bf16
    stamp("14. profiler: tuner, LM+, paper", t_main)
    tune_profile(tuned)
    out["tune"] = tuned
    lm_more_profile(more_lm, dev)
    out["more_lm"] = more_lm
    paper_profile(paper)
    out["paper"] = paper
    stamp("14. profiler: LM serving", t_main)
    lm_profile(lm)
    lm_profile(attn)
    out["lm"], out["attn_lm"] = lm, attn
    stamp("14. profiler: serving plane", t_main)
    serve_profile(serve, dev)
    out["serve"] = serve
    stamp("14. profiler: trainer, kernels, evals, ring", t_main)
    for lv, fn in train["level_fns"].items():
        taken = recorded_profile(fn, "histogram_kernel")
        busy, _, per_launch = taken[-1]
        row = train["levels"][lv]
        row["device_ms"] = kernel_ms(per_launch, "histogram")
        row["call_device_ms"] = sum(busy.values())
        row["device_kernels"] = sorted(busy)
        row["profiles_taken"] = len(taken)
        # one launch per call: the kernel writes every cell, no fill runs;
        # a profile that recorded nothing shows no other kernel either
        for b, _, _ in taken:
            if b and (len(b) != 1 or "histogram_kernel" not in next(iter(b))):
                raise AssertionError(f"histogram level {lv}: device kernels "
                                     f"{sorted(b)}, want the kernel alone")
    busy, wall, _ = device_profile(train["gate_fit"], reps=1)
    out["train"]["gate_fit_profile"] = {
        "wall_ms": wall, "device_busy_ms": sum(busy.values()),
        "device_idle_share": 1.0 - sum(busy.values()) / wall,
        "device_kernels": len(busy),
        "histogram_kernel_ms": sum(v for k, v in busy.items()
                                   if "histogram_kernel" in k),
        "top_device_ms": dict(sorted(busy.items(), key=lambda kv: -kv[1])[:8])}
    for row in train["levels"]:
        print(f"[time] histogram level {row['level']} ({row['n_nodes']} "
              f"nodes, plan {row['plan']}): {row['ms']:.4f} ms per call, "
              f"{fmt(row['device_ms'])} ms on the device, the call's only "
              f"device kernel ({row['call_device_ms']:.4f} ms busy; bound "
              f"{row['bound_ms']:.5f} ms by {row['bound_by']}), plain "
              f"{row['plain_ms']:.3f} ms, torch.bincount "
              f"{row['library_ms']:.4f} ms")
    gp = out["train"]["gate_fit_profile"]
    print(f"[time] gate fit under the profiler: wall {gp['wall_ms']:.2f} ms, "
          f"device busy {gp['device_busy_ms']:.3f} ms, idle share "
          f"{gp['device_idle_share']:.3f}, {gp['device_kernels']} distinct "
          f"device kernels")
    if train["acc_gap"] > GATE_MAX_ACC_GAP:
        raise AssertionError(
            f"trainer gate: RF accuracy gap {train['acc_gap']:.4f} between "
            f"the host CART and the device trainer exceeds "
            f"{GATE_MAX_ACC_GAP} at {GATE_TREES[-1]} trees")
    print(f"[train] RF accuracy gap at {GATE_TREES[-1]} trees: "
          f"{train['acc_gap']:.4f} <= {GATE_MAX_ACC_GAP}")

    for (nb, p, k), fn in kernel_fns.items():
        timing[nb, p][f"{k}_device_ms"] = profiled_ms(fn,
                                                      DEVICE_NAME.get(k, k))
    for r in aggregate_sweep(agg_inputs, (None,)):
        timing[r["B"], "fp32"]["grove_aggregate_shares"][r["share"]][
            "device_ms" if r["route"] == "tile" else "was_device_ms"] = (
                r["device_ms"])
    empty_ms = profiled_ms(empty_launch(dev), "empty")
    out["empty_kernel_device_ms"] = empty_ms
    print(f"[time] an empty kernel (fog_empty, 1 block of 32 threads): "
          f"{fmt(empty_ms)} ms on the device")
    for nb in (B, BIG_B):
        row = timing[nb, "fp32"]
        for r in row["grove_aggregate_shares"].values():
            r["floor_ms"] = empty_ms
            r["latency_bound_ms"] = (None if empty_ms is None else
                                     empty_ms + r["chase_ns"] * 1e-6)
        row.update({f"grove_aggregate_{k}": v for k, v in
                    row["grove_aggregate_shares"]["hop 2"].items()})
    for (nb, p, b), fn in eval_fns.items():
        timing[nb, p][f"eval_{b}_profile"] = eval_profile(
            fn, EVAL_KERNEL[b], b == "pallas")
    for (nb, p), row in timing.items():
        print(f"[time] B={nb} {p}: fused_fog on {row['fused_fog_route']} "
              f"{row['fused_fog_ms']:.4f} ms per call, "
              f"{fmt(row['fused_fog_device_ms'])} ms on the device (was "
              f"{row['fused_fog_was_ms']:.4f} / "
              f"{fmt(row['fused_fog_was_device_ms'])}: the first kernel on "
              f"the same inputs; bound {row['fused_fog_bound_ms']:.6f} ms by "
              f"{row['fused_fog_bound_by']}; latency bound "
              f"{row['fused_fog_latency_bound_ms']:.5f} ms for "
              f"{row['fused_fog_chain_loads']} dependent loads, serial chain "
              f"{row['fused_fog_serial_chain_ms']:.5f} ms for "
              f"{row['fused_fog_serial_chain_loads']}; gathered bytes with "
              f"repeats {row['fused_fog_gather_bound_ms']:.5f} ms), plain "
              f"{row['fused_fog_plain_ms']:.3f} ms; distinct entries "
              f"{row['fused_fog_distinct']}")
        for b in BACKENDS:
            prof = row[f"eval_{b}_profile"]
            launched = {k: v for k, v in row[f"{b}_launches_per_eval"].items()
                        if v}
            print(f"[time] B={nb} {p}: eval {b} {row[f'eval_{b}_ms']:.3f} ms "
                  f"({row[f'eval_{b}_classifications_per_s']:.4g} "
                  f"classifications/s), kernel launches {launched} by route "
                  f"{row[f'{b}_routes_per_eval']}; under the profiler wall "
                  f"{prof['wall_ms']:.3f} ms, device busy "
                  f"{fmt(prof['device_busy_ms'])} ms, idle "
                  f"{fmt_share(prof['device_idle_share'])}{was_text(prof)}")
        if p == "fp32":
            for share, r in row["grove_aggregate_shares"].items():
                print(f"[time] B={nb} [B,{C}] {share} ({r['live_lanes']} "
                      f"live): grove_aggregate {r['ms']:.4f} ms per call, "
                      f"{fmt(r['device_ms'])} ms on the device (was "
                      f"{r['was_ms']:.4f} / {fmt(r['was_device_ms'])}: the "
                      f"first kernel on the same inputs; bound "
                      f"{r['bound_ms']:.6f} ms by {r['bound_by']}; latency "
                      f"bound {fmt(r['latency_bound_ms'])} ms: the empty "
                      f"kernel {fmt(r['floor_ms'])} + one load at "
                      f"{r['chase_ns']:.1f} ns), plain {r['plain_ms']:.4f} ms")
            k = "top2_confidence"
            print(f"[time] B={nb} [B,{C}]: {k} {row[f'{k}_ms']:.4f} ms "
                  f"per call, {fmt(row[f'{k}_device_ms'])} ms on the "
                  f"device (bound {row[f'{k}_bound_ms']:.5f} ms), plain "
                  f"{row[f'{k}_plain_ms']:.4f} ms, torch.topk "
                  f"{row[f'{k}_library_ms']:.4f} ms")
    out["timing"] = {f"B={nb} {p}": row for (nb, p), row in timing.items()}

    for (nb, p, k), fn in ring["kernel_fns"].items():
        ring["timing"][nb, p][f"{k}_device_ms"] = profiled_ms(fn,
                                                              DEVICE_NAME[k])
    for (nb, p, n), fn in ring["eval_fns"].items():
        # RingMesh(8) launches the kernels; 4 and 1 gather (plain ops)
        kernels = n == RING_MESHES[0]
        ring["timing"][nb, p][f"eval_ring{n}_profile"] = eval_profile(
            fn, EVAL_KERNEL["ring"] if kernels else "", kernels)
    for (nb, p), row in ring["timing"].items():
        print(f"[time] B={nb} {p}: tree_traverse [8, {nb // 8}] on "
              f"{row['tree_traverse_route']} {row['tree_traverse_ms']:.4f} ms "
              f"per call, {fmt(row['tree_traverse_device_ms'])} ms on the "
              f"device (was {row['tree_traverse_was_ms']:.4f} / "
              f"{fmt(row['tree_traverse_was_device_ms'])}: the first kernel "
              f"on the same inputs; bound {row['tree_traverse_bound_ms']:.6f}"
              f" ms by {row['tree_traverse_bound_by']}; latency bound "
              f"{row['tree_traverse_latency_bound_ms']:.5f} ms, serial chain "
              f"{row['tree_traverse_serial_chain_ms']:.5f} ms, at "
              f"{row['tree_traverse_latency_ns']['grove']:.2f} / "
              f"{row['tree_traverse_latency_ns']['x']:.2f} ns per grove / x "
              f"load), plain {row['tree_traverse_plain_ms']:.3f} ms")
        fused = timing[nb, p]["eval_fused_ms"]
        print(f"[time] B={nb} {p}: eval ring " + ", ".join(
            f"RingMesh({n}) {row[f'eval_ring{n}_ms']:.3f} ms (under the "
            f"profiler wall {row[f'eval_ring{n}_profile']['wall_ms']:.3f} ms,"
            f" device busy "
            f"{fmt(row[f'eval_ring{n}_profile']['device_busy_ms'])} ms, idle "
            f"{fmt_share(row[f'eval_ring{n}_profile']['device_idle_share'])}"
            f"{was_text(row[f'eval_ring{n}_profile'])})"
            for n in RING_MESHES) + f"; fused {fused:.3f} ms")
        row["eval_fused_ms"] = fused
    out["ring"] = {
        "launches": ring["launches"], "routes": ring["routes"],
        "max_abs_err": ring["max_abs_err"],
        "ring_max_abs_err_vs_reference":
            ring["ring_max_abs_err_vs_reference"],
        "timing": {f"B={nb} {p}": row
                   for (nb, p), row in ring["timing"].items()}}
    # the FoG roofline model of each backend's eval beside its times
    out["roofline"] = roofline_lines(timing, eval_fns, ring, packs, F)

    # fused_fog's route rule against both routes' device times where its
    # copy-bytes line falls (the sweep's code at BOUNDARY_GRID)
    stamp("14. profiler: route boundary", t_main)
    boundary = route_boundary(sweep_phase(dev, packs, x, BOUNDARY_GRID))
    out["fused_fog_route_boundary"] = boundary
    for key, row in boundary.items():
        print(f"[route] fused_fog {key}: smem {fmt(row['smem'])} ms, l1 "
              f"{fmt(row['l1'])} ms on the device; the rule picks "
              f"{row['rule']}, the faster (3 % ties) {row['faster']}")
    stamp("14. profiler: SDPA's memory-efficient backend", t_main)
    efficient_sdpa_profile(train_lm_out)

    # 22. the kernels line -----------------------------------------------------
    stamp(f"22. kernels line (phase 3 at {phase3_s:.1f} s)", t_main)
    row = timing[B, "fp32"]
    kernels = []
    for k in INFERENCE_KERNELS:
        lat = row.get(f"{k}_latency_bound_ms")
        kernels.append({
            "name": k, "route": "cuda", "source": SOURCE[k],
            "replaces": REPLACES[k], "launches": main_launches[k],
            "max_abs_err": errs[k], "ms": row[f"{k}_ms"],
            "device_ms": row[f"{k}_device_ms"],
            "plain_ms": row[f"{k}_plain_ms"], "bound_ms": row[f"{k}_bound_ms"],
            "bound_by": row[f"{k}_bound_by"],
            "latency_bound_ms": lat,
            "larger_bound": ("latency" if lat is not None
                             and lat > row[f"{k}_bound_ms"]
                             else row[f"{k}_bound_by"]),
            "library_ms": row.get(f"{k}_library_ms"),
            "called_by": CALLED_BY[k],
            "matches_plain": True, "shape": f"B={B} fp32"})
    fused = kernels[INFERENCE_KERNELS.index("fused_fog")]
    fused.update(
        routes=fused_routes,
        design="the group kernel (fused_fog_group_kernel)",
        serial_chain_ms=row["fused_fog_serial_chain_ms"],
        by_batch=redesign_rows(timing, "fused_fog"),
        paper_launches=paper["launches"]["fused_fog"],
        paper_fields={k: {f: r[f] for f in (
            "route", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "max_abs_err")} for k, r in paper["fields"].items()})
    agg = kernels[INFERENCE_KERNELS.index("grove_aggregate")]
    agg.update(
        routes=agg_routes, shape=f"B={B} fp32 [B, {C}], the per-hop "
        f"path's hop-2 state", design="the tile kernel "
        "(grove_aggregate_tile_kernel)", floor_ms=empty_ms,
        was_device_ms=row["grove_aggregate_was_device_ms"],
        by_share={f"B={nb} {share}": r for nb in (B, BIG_B)
                  for share, r in timing[nb, "fp32"][
                      "grove_aggregate_shares"].items()})
    top2 = kernels[INFERENCE_KERNELS.index("top2_confidence")]
    top2["lm_gates"] = [{
        "arch": r["arch"], "launches": r["launches"]["top2_confidence"],
        "shape": f"[{LM_B}, {get_arch(r['arch']).vocab_size}] fp32",
        "max_abs_err": r["fog"]["top2_max_abs_err_vs_plain"],
        "matches_plain": True,
        "blocks_per_row": row_blocks(LM_B, get_arch(r["arch"]).vocab_size),
        **{k: r["timing"][f"top2_confidence_{k}"] for k in (
            "ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by")}} for r in (lm, attn)]
    top2["max_abs_err"] = max([top2["max_abs_err"]] + [
        g["max_abs_err"] for g in top2["lm_gates"]])
    deep = train["levels"][-1]
    fit_sum = {k: sum(lv[k] for lv in train["levels"])
               for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    kernels.append({
        "name": "histogram", "route": "cuda", "source": SOURCE["histogram"],
        "replaces": REPLACES["histogram"],
        "launches": main_launches["histogram"],
        "max_abs_err": train["max_abs_err"], "ms": deep["ms"],
        "device_ms": deep["device_ms"], "plain_ms": deep["plain_ms"],
        "bound_ms": deep["bound_ms"], "bound_by": deep["bound_by"],
        "library_ms": deep["library_ms"], "called_by": CALLED_BY["histogram"],
        "matches_plain": True,
        "shape": (f"gate fit level {deep['level']}: T={GATE_TREES[-1]} "
                  f"N={len(ds.y_train)} F=16 bins=17 C={ds.n_classes} "
                  f"nodes={deep['n_nodes']}"),
        "per_fit": {f"{k}_sum_over_levels": v for k, v in fit_sum.items()}})
    row = ring["timing"][B, "fp32"]
    lat = row["tree_traverse_latency_bound_ms"]
    kernels.append({
        "name": "tree_traverse", "route": "cuda",
        "source": SOURCE["tree_traverse"],
        "replaces": REPLACES["tree_traverse"],
        "launches": main_launches["tree_traverse"],
        "max_abs_err": ring["max_abs_err"], "ms": row["tree_traverse_ms"],
        "device_ms": row["tree_traverse_device_ms"],
        "plain_ms": row["tree_traverse_plain_ms"],
        "bound_ms": row["tree_traverse_bound_ms"],
        "bound_by": row["tree_traverse_bound_by"],
        "latency_bound_ms": lat,
        "serial_chain_ms": row["tree_traverse_serial_chain_ms"],
        "routes": ring["routes"],
        "design": "the spread kernel (tree_traverse_spread_kernel)",
        "by_batch": redesign_rows(ring["timing"], "tree_traverse"),
        "larger_bound": ("latency" if lat > row["tree_traverse_bound_ms"]
                         else row["tree_traverse_bound_by"]),
        "library_ms": None, "called_by": CALLED_BY["tree_traverse"],
        "matches_plain": True,
        "shape": f"B={B} fp32, stacked [8, {B // 8}] (the ring's hop)"})
    shapes = {"ssd_chunk": (f"{LM_ARCH} prefill layer 0: B={LM_B} "
                            f"nc={LM_S // 256} Q=256 H=80 P=64 N=128 bf16"),
              "flash_attention": (f"{ATTN_ARCH} prefill layer 0: B={LM_B} "
                                  f"S={LM_S} H=32 K=4 D=Dv=64 causal bf16")}
    for r in (lm, attn):
        k, lt = r["kernel"], r["timing"]
        errs_lm = [e for case in r[f"{k}_max_abs_err"].values()
                   for n, e in (case.items() if isinstance(case, dict)
                                else (("", case),))
                   if not n.endswith("_from_replay")]
        kernels.append({
            "name": k, "route": "cuda", "source": SOURCE[k],
            "replaces": REPLACES[k], "launches": main_launches[k],
            "max_abs_err": max(errs_lm), "ms": lt[f"{k}_ms"],
            "device_ms": lt[f"{k}_device_ms"], "plain_ms": lt[f"{k}_plain_ms"],
            "bound_ms": lt[f"{k}_bound_ms"], "bound_by": lt[f"{k}_bound_by"],
            "fp32_core_bound_ms": lt[f"{k}_fp32_core_bound_ms"],
            "library_ms": lt[f"{k}_library_ms"], "called_by": CALLED_BY[k],
            "matches_plain": True, "shape": shapes[k],
            "routes": r["prefill_routes"], "simt_source": SIMT_SOURCE[k],
            "simt_ms": lt[f"{k}_simt_ms"],
            "simt_device_ms": lt[f"{k}_simt_device_ms"]})
        if k == "ssd_chunk":
            kernels[-1].update(
                design_bound_ms=lt["ssd_chunk_design_bound_ms"],
                design_bound_by=lt["ssd_chunk_design_bound_by"],
                design_ops=lt["ssd_chunk_work"]["ops_sm90"])
        if k == "flash_attention":
            kernels[-1].update(
                library_device_ms=lt["flash_attention_library_device_ms"],
                library_backend=lt["flash_attention_library_backend"])
    # the serve phase's launches beside each kernel's main-path count
    reg = serve["registry"]
    by_span = {64: reg["sync"]["profile"]["fused_fog_device_ms"]}
    for row in serve["fused"]:
        if row["precision"] == "fp32" and not row["pipeline"]:
            by_span[row["span"]] = row["profile"]["fused_fog_device_ms"]
    serve_launches = {
        "fused_fog": {"registry plane sync": reg["sync"]["launches"],
                      "registry plane pipelined":
                          reg["pipelined"]["launches"],
                      "dispatches": {m: reg[m]["dispatches"] for m in reg},
                      "launches_per_dispatch": {
                          m: reg[m]["launches"]["fused_fog"]
                          / reg[m]["dispatches"] for m in reg},
                      "fused_plane": {
                          f"{r['replicas']}x{r['span']} {r['precision']} "
                          + ("pipelined" if r["pipeline"] else "sync"):
                          r["launches"].get("fused_fog", 0)
                          / r["dispatches"] for r in serve["fused"]},
                      "device_ms_by_span": by_span},
        "grove_aggregate": {"registry plane, backend pallas":
                                serve["registry_pallas"]["launches"],
                            "dispatches":
                                serve["registry_pallas"]["dispatches"]},
        "top2_confidence": {"LM serve": serve["lm"]["launches"].get(
            "top2_confidence", 0)},
        "flash_attention": {"LM serve": serve["lm"]["launches"].get(
            "flash_attention", 0), "routes": serve["lm"]["routes"]}}
    for k in kernels:
        if k["name"] in serve_launches:
            k["serve_launches"] = serve_launches[k["name"]]
        if k["name"] == "flash_attention":
            k["tp_launches"] = {"per rank, prefill": out["sharding"]["tp"][
                "ranks"][0]["counts"][0]}
            k["tp_head_slice"] = out["sharding"]["mesh_serve"]["head_slice"]
            k["shard_launches"] = out["sharding"]["launches"]
            k["shard_train_launches"] = {
                m: {"launches": out["sharding"]["mesh_step"][m]["launches"],
                    "routes": out["sharding"]["mesh_step"][m]["routes"]}
                for m in ("host", "1x1x1")}
    # phase 15's tuned picks beside the seed, phase 16's launches
    fused.update(tuned={label: {
        "seed": row["seed"], "tuned": row["tuned"],
        **{f: row[f] for f in ("seed_ms", "tuned_ms", "seed_device_ms",
                               "tuned_device_ms", "bound_ms", "bound_by")}}
        for label, row in tuned["keys"].items()},
        tuned_paper_evals=tuned["paper_evals"])
    top2["tp_launches"] = {"per rank, FoG step": out["sharding"]["tp"][
        "ranks"][0]["counts"][-1]}
    top2["tp_block"] = out["sharding"]["top2_blocks"]
    top2["lm_more_gates"] = [{
        "arch": r["arch"], "launches": r["launches"]["top2_confidence"],
        "shape": f"[{LM_B}, {more_config(n, o).vocab_size}] fp32",
        "max_abs_err": r["fog"]["top2_max_abs_err_vs_plain"],
        "matches_plain": True} for (n, o, _), r in zip(
            MORE_LM, more_lm.values())]
    for k in kernels:
        if k["name"] in ("flash_attention", "ssd_chunk"):
            k["lm_more_launches"] = {
                r["arch"]: {"launches": r["prefill_launches"].get(
                    k["name"], 0), "routes": r["prefill_routes"]}
                for r in more_lm.values()
                if r["prefill_launches"].get(k["name"])}
        if k["name"] == "flash_attention":
            k["mla_max_abs_err"] = {
                r["arch"]: r["flash_attention_max_abs_err"]
                for r in more_lm.values()
                if "flash_attention_max_abs_err" in r}
            k["mla_ms"] = {r["arch"]: {f: r["timing"].get(f) for f in (
                "flash_attention_shape", "flash_attention_ms",
                "flash_attention_plain_ms", "flash_attention_bound_ms",
                "flash_attention_bound_by", "flash_attention_simt_ms")}
                for r in more_lm.values()
                if "flash_attention_max_abs_err" in r}
    tl, tt = train_lm_out, train_lm_out["timing"]
    kernels.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": REPLACES["flash_attention"],
        "replaces_note": "the gradient of that kernel; the JAX package "
                         "takes it with jax.grad of its blocked attention "
                         "(src/repro/models/layers.py:40)",
        "launches": main_launches["flash_attention_bwd"],
        "launches_per_step": tl["launches_per_step"]["flash_attention_bwd"],
        "max_abs_err": max(tl["bwd_err"].values()),
        "max_err_is": "the largest error of dq, dk, dv as a share of its "
                      "scale over the cases",
        "ms": tt["ms"], "device_ms": tt.get("device_ms"),
        "plain_ms": tt["plain_ms"], "bound_ms": tt["bound_ms"],
        "bound_by": tt["bound_by"], "library_ms": tt["library_ms"],
        "library_device_ms": tt.get("library_device_ms"),
        "library_backend": tt.get("library_backend"),
        "efficient_library_ms": tt["efficient_ms"],
        "efficient_library_device_ms": tt.get("efficient_device_ms"),
        "efficient_library_backend": tt.get("efficient_backend"),
        "called_by": "ops.FlashAttention.backward (training: "
                     "train/loop.py through models/layers.py)",
        "matches_plain": True, "deterministic": True, "shape": tt["shape"],
        "cases": tl["bwd_err"]})
    tm, tmt = train_mamba, train_mamba["timing"]
    kernels.append({
        "name": "ssd_chunk_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_chunk_bwd.cu",
        "replaces": REPLACES["ssd_chunk"],
        "replaces_note": "the gradient of that kernel; the JAX package "
                         "takes it with jax.grad of the einsum branch of "
                         "src/repro/models/mamba2.py::ssd_chunked "
                         "(src/repro/models/mamba2.py:107-118)",
        "launches": main_launches["ssd_chunk_bwd"],
        "launches_per_step": tm["launches_per_step"]["ssd_chunk_bwd"],
        "max_abs_err": max(tm["bwd_err"].values()),
        "max_err_is": "the largest error of dxbar, da, dB, dC as a share of "
                      "its scale over the cases",
        "ms": tmt["ms"], "device_ms": tmt.get("device_ms"),
        "device_ms_by_kernel": tmt.get("device_ms_by_kernel"),
        "plain_ms": tmt["plain_ms"], "bound_ms": tmt["bound_ms"],
        "bound_by": tmt["bound_by"], "library_ms": None,
        "called_by": "ops.SsdChunk.backward (training: train/loop.py "
                     "through models/mamba2.py::ssd_chunked)",
        "matches_plain": True, "deterministic": True, "shape": tmt["shape"],
        "cases": tm["bwd_err"]})
    tb, tbt, tbs = (train_bf16, train_bf16["timing"],
                    train_bf16["ssd_timing"])
    kernels.append({
        "name": "flash_attention_bwd_sm90", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cu",
        "replaces": REPLACES["flash_attention"],
        "replaces_note": "the gradient of that kernel on the tensor cores "
                         "(bf16 at the seven pairs of "
                         "flash_attention.SM90_PAIRS); the JAX package "
                         "takes it with jax.grad of its blocked attention "
                         "(src/repro/models/layers.py:40)",
        "launches": main_launches["flash_attention_bwd_sm90"],
        "launches_per_step": tb["tinyllama"]["launches_per_step"][
            "flash_attention_bwd_sm90"],
        # phase 20's one step of train_4k at its full batch, its own run
        "full_batch_launches": out["full_batch"]["launches"][
            "flash_attention_bwd_sm90"],
        "launches_per_step_by_arch": {
            r["arch"]: r["launches_per_step"]["flash_attention_bwd_sm90"]
            for r in (tb["tinyllama"], tb["minicpm3"])},
        "minicpm3_layer0_max_abs_err": tb["mla_bwd_err"],
        "pairs": {key: {f: v for f, v in r.items()
                        if not f.startswith("fwd")}
                  for key, r in tb["pairs"].items()},
        "max_abs_err": max(v for k, v in tb["bwd_err"].items()
                           if not k.startswith("SIMT")),
        "max_err_is": "the largest error of dq, dk, dv as a share of its "
                      "scale against the plain version on the same bf16 "
                      "inputs, over layer 0 and the cases",
        "ms": tbt["ms"], "device_ms": tbt.get("device_ms"),
        "device_ms_by_kernel": tbt.get("device_ms_by_kernel"),
        "plain_ms": tbt["plain_ms"], "bound_ms": tbt["bound_ms"],
        "bound_by": tbt["bound_by"],
        "design_ops_bound_ms": tbt["design_ops_bound_ms"],
        "library_ms": tbt["library_ms"],
        "library_device_ms": tbt.get("library_device_ms"),
        "library_backend": tbt.get("library_backend"),
        "called_by": "ops.FlashAttention.backward (bf16 training: "
                     "train/loop.py through models/layers.py)",
        "matches_plain": True, "deterministic": True, "shape": tbt["shape"],
        "cases": tb["bwd_err"]})
    kernels.append({
        "name": "ssd_chunk_bwd_sm90", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_chunk_bwd_sm90.cu",
        "replaces": REPLACES["ssd_chunk"],
        "replaces_note": "the gradient of that kernel on the tensor cores "
                         "(bf16 at P = 64, N in {64, 128}, the forward's "
                         "route rule); the JAX package takes it with "
                         "jax.grad of the einsum branch of "
                         "src/repro/models/mamba2.py::ssd_chunked",
        "launches": main_launches["ssd_chunk_bwd_sm90"],
        "launches_per_step": tb["mamba2"]["launches_per_step"][
            "ssd_chunk_bwd_sm90"],
        "max_abs_err": max(v for c, v in tb["ssd_bwd_err"].items()
                           if "simt" not in c),
        "max_err_is": "the largest error of dxbar, da, dB, dC as a share of "
                      "its scale against the replay of its rounding "
                      "(ssd_chunk_bwd_sm90_replay), over layer 0 and the "
                      "full-width cases",
        "ms": tbs["ms"], "device_ms": tbs.get("device_ms"),
        "device_ms_by_kernel": tbs.get("device_ms_by_kernel"),
        "was_ms": tbs["simt_ms"], "was_device_ms": tbs.get("simt_device_ms"),
        "was": "the SIMT kernel (csrc/ssd_chunk_bwd.cu) on the same bf16 "
               "inputs",
        "plain_ms": tbs["plain_ms"], "bound_ms": tbs["bound_ms"],
        "bound_by": tbs["bound_by"],
        "design_ops_bound_ms": tbs["design_ops_bound_ms"],
        "library_ms": None,
        "called_by": "ops.SsdChunk.backward (bf16 training: train/loop.py "
                     "through models/mamba2.py::ssd_chunked)",
        "mamba2_oracle": tb["mamba2_oracle"],
        "matches_plain": True, "deterministic": True, "shape": tbs["shape"],
        "cases": tb["ssd_bwd_err"]})
    for k in kernels:
        if k["name"] == "ssd_chunk_bwd":
            k["bf16"] = {
                "jamba_smoke_launches": tb["jamba_smoke"]["launches"].get(
                    "ssd_chunk_bwd", 0),
                "max_abs_err": max(v for c, v in tb["ssd_bwd_err"].items()
                                   if "simt" in c),
                "cases": {c: v for c, v in tb["ssd_bwd_err"].items()
                          if "simt" in c},
                "was_mamba2": "mamba2-2.7b's bf16 backward ran on this "
                              "kernel before ssd_chunk_bwd_sm90 took it"}
        if k["name"] == "flash_attention_bwd":
            k["bf16"] = {
                "jamba_smoke_launches": tb["jamba_smoke"]["launches"].get(
                    "flash_attention_bwd", 0),
                "max_abs_err": max(v for c, v in tb["bwd_err"].items()
                                   if c.startswith("SIMT")),
                "cases": {c: v for c, v in tb["bwd_err"].items()
                          if c.startswith("SIMT")},
                "was_minicpm3": "PR 25 ran minicpm3-4b's bf16 backward "
                                "(D = 96 / Dv = 64) here; it now takes "
                                "flash_attention_bwd_sm90"}
        if k["name"] == "flash_attention":
            k["train_bf16_launches_per_step"] = tb["tinyllama"][
                "launches_per_step"]["flash_attention"]
            k["full_batch_launches"] = out["full_batch"]["launches"][
                "flash_attention"]
            k["train_bf16_routes_per_step"] = tb["tinyllama"][
                "routes_per_step"]
            k["sm90_forward_with_lse_ms"] = tbt["fwd_lse_ms"]
            k["sm90_forward_ms"] = tbt["fwd_ms"]
            k["sm90_lse_max_abs_err"] = tb["lse_max_abs_err"]
            k["pairs"] = {key: {f: v for f, v in r.items()
                                if not f.startswith("bwd")}
                          for key, r in tb["pairs"].items()}
        if k["name"] == "ssd_chunk":
            k["train_bf16_launches_per_step"] = tb["mamba2"][
                "launches_per_step"]["ssd_chunk"]
            k["train_bf16_routes_per_step"] = tb["mamba2"]["routes_per_step"]
    for k in kernels:
        if k["name"] == "ssd_chunk":
            k["train_launches_per_step"] = tm["launches_per_step"][
                "ssd_chunk"]
            k["train_routes_per_step"] = tm["routes_per_step"]
            k["train_forward_ms"] = tmt["fwd_ms"]
            k["train_forward"] = {
                "shape": tmt["shape"], "route": "simt",
                "source": SIMT_SOURCE["ssd_chunk"], "ms": tmt["fwd_ms"],
                "device_ms": tmt["fwd_device_ms"],
                "device_ms_by_kernel": tmt["fwd_device_ms_by_kernel"],
                "plain_ms": tmt["fwd_plain_ms"],
                "bound_ms": tmt["fwd_bound_ms"],
                "bound_by": tmt["fwd_bound_by"],
                "design_ops": tmt["fwd_design_ops"], "library_ms": None}
        if k["name"] == "ssd_chunk_bwd":
            k["design_ops"] = tmt["design_ops"]
        if k["name"] == "flash_attention":
            k["train_launches_per_step"] = tl["launches_per_step"][
                "flash_attention"]
            k["train_routes_per_step"] = tl["routes_per_step"]
            k["train_forward_with_lse_ms"] = tt["fwd_lse_ms"]
            k["train_forward"] = {
                "shape": tt["shape"], "route": "simt",
                "source": SIMT_SOURCE["flash_attention"],
                "ms": tt["fwd_lse_ms"],
                "device_ms": tt.get("fwd_lse_device_ms"),
                "plain_ms": tt["fwd_plain_ms"],
                "bound_ms": tt["fwd_bound_ms"],
                "bound_by": tt["fwd_bound_by"],
                "design_ops": tt["fwd_design_ops"],
                "library_ms": tt["fwd_library_ms"],
                "library_device_ms": tt.get("fwd_library_device_ms"),
                "library_backend": tt.get("fwd_library_backend"),
                "efficient_library_ms": tt["fwd_efficient_ms"],
                "efficient_library_device_ms": tt.get(
                    "fwd_efficient_device_ms"),
                "efficient_library_backend": tt.get(
                    "fwd_efficient_backend"),
                "max_abs_err": max(v["out"]
                                   for v in tl["fwd_err"].values()),
                "cases": tl["fwd_err"]}
    for k in kernels:
        if not k["launches"]:
            raise AssertionError(f"kernel {k['name']} was not launched on "
                                 f"its main path")
    out["kernels"] = kernels
    (ROOT / "build" / "chip_smoke.json").write_text(
        json.dumps(out, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
