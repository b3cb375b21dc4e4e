#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. Card and build: prints the card's name and power limit (as nvidia-smi
   gives them), builds the CUDA kernels from ``src/repro_torch/csrc`` with
   nvcc into ``build/repro_torch/`` and prints the build seconds and the
   ptxas resource lines.
2. Kernels: counts the tensor-core instructions (``HMMA``, and Hopper's
   warpgroup ``HGMMA``) and TMA tile loads (``UTMALDG``) of the attention
   (forward in fp32 and bf16, and the backward's dk/dv and dq in fp32 and
   bf16), scan (forward in fp32 and bf16, and the backward's chunk kernel
   in fp32 and bf16) and both LSTM-cell kernels in the built library
   (``cuobjdump -sass``, where the toolkit has it): a kernel with no
   tensor-core instruction fails, and so does a kernel redesigned for
   Hopper (the bf16 forwards, and the bf16 backwards' dk/dv, dq and chunk
   kernels) with no ``HGMMA`` or no ``UTMALDG``. Times an empty kernel
   launched through the library in the same timer as the kernels (the
   ``launch floor:`` line). Then each kernel against its
   plain PyTorch version on the card at the path's shapes and edge cases
   (gather bit-equal; the others within 1e-4, TF32 off; the scan also
   from a random initial state), then timed cold (L2 flushed and left
   clean before every launch, CUDA events, median) beside the plain
   version and, where one
   PyTorch call computes the same function, that call
   (``torch.index_select``, ``torch._VF.lstm_cell``,
   ``scaled_dot_product_attention``, whose kernel names one profiled call
   prints; yardsticks the port never calls). The gather is timed cold and
   warm beside ``index_select`` at the path's shapes (``GATHER_TIMED``),
   both cells cold and warm at B = 1, 16, 32, attention and scan at both
   prefill shapes of their LM wave. The dense LSTM cell is also checked on
   gathered rows against the gather cell; no model path launches it, so
   its launches are those of its checks. Then the MoE layer
   (``check_moe``) at Granite-MoE-1B-A400M's and OLMoE-1B-7B's widths, at
   a wave's decode step (6 rows, one group), a 4 x 96 prefill and
   Granite's 8 x 128 train step: with the gather kernel against the same
   layer with the plain gathers, routing equal, outputs within 1e-6 of
   their largest |value|, two runs bit-equal, two gathers a call; the
   train shape's gradients (the gather backward's sort path) within 1e-6
   of the plain gathers'; the card's routing against the CPU's (tokens
   routed differently, smallest top-K gap); then the dispatch and combine
   gathers and their backwards timed cold at Granite's train shape and
   OLMoE's prefill shape beside ``index_select`` and ``zeros`` +
   ``index_add_`` (the backwards the CPU plain version's bits). Then the
   bf16 forward kernels of flash attention and the SSD scan
   (``check_flash_bf16``, ``check_ssd_bf16``) on bf16-exact inputs at the
   path's shapes and small odd ones, each on the one bf16 bar
   (``bf16_bar``: the error against the plain version in fp32 on the
   upcast inputs at most twice the plain bf16 version's, and within
   BF16_KERNEL_TOL, the reference's 3e-2, of the largest |value|), two
   runs of each case bit-equal, timed at their wave's prefill shapes
   beside the plain bf16 version and, for attention, bf16
   ``scaled_dot_product_attention``; attention also at the vision model's
   cross shape (q (2, 64, 32, 128), k/v (2, 1024, 8, 128), non-causal)
   beside bf16 ``scaled_dot_product_attention``, with its bound. Then the
   row gather's bf16 backward (``check_gather_backward_bf16``; each add
   rounded to bf16, as the reference's scatter-add of the gradient
   rounds) at Granite-MoE's bf16 train shapes (dispatch K = 10240 into
   (1344, 1024), combine 8192 into (11264, 1024), the sort path), on the
   one-launch path (K = 256, 2048), odd rows of 2-byte units on both
   paths, repeated and negative indices: bit-equal to the plain version
   on the card and the CPU, two runs bit-equal, on the bf16 bar against
   the fp32 sum; timed cold at both Granite shapes beside the fp32 kernel,
   the plain version and bf16 ``zeros`` + ``index_add_``.
3. The slice: BiLSTM-Tagger at model_size=512 on CUDA. An FSM policy is
   learned on small graphs, then fresh 16-sentence minibatches (and one
   repeat) run through the interpreted, per-topology and bucketed
   executors (the per-topology one captures each topology's plan, and the
   bucketed one each bucket signature, as a CUDA graph and replays it),
   and the per-topology plan with ``capture=False`` beside them. All must
   agree within 1e-4 on every tag logit ``y``, the replayed plan with its
   eager run within 1e-6; one more run of the captured plan must be one
   counted launch and one replay and move the kernels' counters by what
   its capture counted;
   the first minibatch must match a plain-PyTorch run of the same seed on
   the CPU, and the gather and fused-cell launch counters must rise during
   the slice. Prints steady-state ms per run for each executor, the plan
   stats, the gather's ``(K, row bytes)`` launch histogram, and the device
   us of the gather and cell kernels in the profiled bucketed run with
   their share of its device time.
4. The LM wave: Qwen2-0.5B, Mamba2-130m, Granite-MoE-1B-A400M and
   OLMoE-1B-7B, at full published width and depth (random weights from
   the seed, made on the CPU and copied to the card; OLMoE's made on the
   card) through the port's wave ``ServeEngine``: six requests, eight new
   tokens each. The flash-attention (Qwen2, the MoE models), SSD-scan
   (Mamba2) and row-gather (the MoE models' dispatch and combine) launch
   counters must rise during the wave. The engine captures its prefill
   (one graph per batch and length) and decode step (one per batch) at the
   first wave, whose steps are the captures' warm-ups, and replays them in
   a second wave; an engine with ``capture=False`` serves the same waves.
   The tokens must equal the eager engine's and the same wave's on the CPU
   (plain versions only), apart from a near-tie flip within the logit
   tolerance, and one prefill batch's logits must agree with the CPU
   within 2e-3 of the largest |logit|. OLMoE is held to the CPU at two
   layers (LM_CPU_REPEATS: its weights' first two repeats, on both). An
   MoE model's routing is recorded in an eager card wave and the CPU wave
   (``RoutingRecorder``): a token or logit beyond those bars is accepted
   only where the routings first differ at a top-K gap within
   ROUTING_TIE (1e-5) (in a bf16 run: the K-th and (K+1)-th logits within
   BF16_ROUTING_ULPS bf16 ulps of the larger), printed with the smallest
   gap of the wave. Prints
   tokens/s, ms per prefill
   batch and per decode wave (a replay, and the eager step), the batch
   counts, the peak memory of a repeat wave and a profiler summary (busy
   share, device events) for both engines. All four then serve the same
   wave in bf16 (BF16_WAVES, ``bf16_wave``): the fp32 weights rounded
   once (the fp32 ones freed), full width and depth, captured and eager,
   the bf16 kernels' counters (the MoE models' gather too, its shapes
   printed: 2048- and 4096-byte bf16 rows) must rise and the fp32
   kernel's not, the tokens of both engines bit-equal; tok/s, ms and peak
   memory beside the fp32 wave's; one prefill batch's logits at
   BF16_CPU_REPEATS repeats held to the CPU on the bf16 bar (an MoE model
   beyond it only at a bf16 routing tie); at full depth the tokens'
   agreement with the fp32 wave and the largest logit gap printed, not
   held.
5. Trees and lattices at model_size=512: TreeLSTM and LatticeLSTM as the
   tagger runs (two fresh 16-instance minibatches and a repeat through the
   three executors), TreeGRU, MV-RNN, TreeLSTM-2Type and LatticeGRU one
   minibatch through the interpreted and bucketed executors; each against
   the CPU plain run within 1e-4, but MV-RNN, whose float32 result is not
   resolved to 1e-4, against a float64 run (``run_slice``). The gather
   launch counter must rise in every workload and the fused-cell counter
   in LatticeLSTM. Prints ms per run, batches against their lower bound,
   plan stats, lowering seconds, the bucketed busy share and the gather's
   ``(K, row bytes)`` launch histogram.
6. The serve engine (``repro_torch.serve``) at model_size=512 for the
   three serve families (ChainLM, TreeLSTM, LatticeLSTM, an FSM learned
   for each), on two traces: the serve launcher's mixed defaults (24
   requests, 4 a round, 12 new tokens, 16 slots) and the LM benchmark's
   (32 requests, 20 new tokens, 32 slots). Each runs on the card through
   the default engine (bucketed, each bucket signature captured once as
   a CUDA graph and replayed, pipelined rounds), the same engine with
   eager buckets and the interpreted engine, each a first pass, a steady
   pass with every cache warm and a profiled pass; and on the CPU through
   the default engine. Every request must complete; lm tokens must equal
   the CPU's (a flip only at a near-tie, its margin printed) and tree and
   lattice outputs be within 1e-4 of it; the default engine must book no
   contained error, quarantine or round below its tier, capture at least
   one graph and replay more often than it captures, and the gather and
   gather-cell launch counters (replays included) must rise in its steady
   pass, and in each card engine's profiled pass they must rise by as
   many launches as the profiler counts of those kernels. Prints a ``serve <trace> <mode>:`` line per run (tok/s, rounds,
   ms per round median and p90, captures and replays, busy share and
   device events per round) and the replayed run beside the eager one.
7. The serve launcher (``repro_torch.launch.serve``) at its defaults
   (24 requests, 4 a round, 12 new tokens, 16 slots, lm,tree,lattice,
   bucketed plans with async compile: bucket graphs captured on background
   workers, pipelined rounds) at model_size=512 with phase 6's FSMs
   (through a policy registry under ``build/chip_smoke/``). (a) ``main()``
   in-process: exit 0, every request completed, its summary lines printed,
   the gather and gather-cell counters rising during it. (b) The engine as
   the launcher builds it, async, with ``--no-async-compile`` and on the
   CPU: a first, a steady and a profiled pass each on the card, and a
   first pass of a fresh async engine under the profiler. Tokens as in
   phase 6, tree and lattice outputs within 1e-4 of the CPU and 1e-6
   between the card engines; every steady round bucketed and replayed with
   no quarantine; the counters equal the profiler's kernel counts in every
   profiled pass. Prints first-pass wall, time to first token, loop and
   background lowering, jobs, hot-swaps and tiers, and steady ms per round,
   busy share and device events per round, async beside sync. (c)
   ``--checkpoint-dir C --inject-faults crash=8`` exits 1, ``--restore C``
   exits 0 with the uninterrupted run's tokens and outputs (within 1e-6,
   bit-equality printed) and the slot pool at the addresses it was made
   at. (d) A fresh engine prewarms the async engine's warm set: its first
   lm round runs bucketed; prints time to first token, cold and warm.
8. The sharded serve engine at model_size=512 with phase 6's FSMs on the
   mixed trace (24 requests, 4 a round, 12 new tokens, 16 slots in all):
   K = 1, 2 and 4 replicas on the card (one captured graph replay serves
   all K shards of a round), each a first, a steady, a profiled and a
   traced pass (the engine's host spans per round);
   then (a) K = 2 losing shard 1 at round 3 and regrowing at round 7, (b)
   K = 2 with ``steal_threshold=0`` on the reference's work-stealing trace
   (the mixed trace stays balanced), beside a clean run and the CPU, (c)
   the launcher with ``--devices 2 --inject-faults crash=8,shard_lost=5*1``
   (exit 1), then ``--restore`` (exit 0), (d) K = 4 with async compile
   (sharded captures on the workers). Every request completes; lm tokens
   equal the CPU's and K = 1's (a flip only at a near-tie, margin
   printed); tree and lattice outputs within 1e-4 of the CPU and 1e-6 of
   K = 1 on the card; steady sharded passes run every round sharded and
   replayed; the gather and gather-cell counters rise in the K = 4 steady
   pass and equal the profiler's counts in every profiled pass; (a) logs
   one shrink and one grow, (b) steals and keeps the tokens, (a) and (c)
   give the clean K = 2 run's outputs. Prints a ``serve sharded K=<k>:``
   line per run (tok/s, ms per round median and p90, busy share, device
   events per round, captures, replays, fallback rounds, sharded
   dispatches); writes under ``build/chip_smoke/sharded/``. Then the
   per-card placement (``launch/mesh.py``, one replica a card as the
   reference's ``shard_map`` places them): (e) K = 2 with both placements
   on cuda:0 (each its own graphs, slot pool and weight copy), a first,
   a steady and a profiled pass and a loss at round 3 with a regrowth at
   round 7, every output bit-equal to the stacked K = 2 run's and within
   1e-6 of K = 1's (``serve sharded placed K=2 devices=cuda:0,cuda:0:``
   line, with its seconds); (f) where the machine has two cards or more,
   K = min(4, cards) one a card with the same checks, else one line
   saying that (f) did not run.
9. The trainer. (a) Flash attention's backward kernel against autograd
   of the plain attention on the card, TF32 off, within 1e-4 of the
   largest |gradient| (the trainer's shape, q (8, 128, 14, 64) with k/v
   (8, 128, 2, 64); S = 1, 37, 200; G = 1, 3, 4, 7 and 16 (dk/dv
   clusters of 1, 3, 4, 7 ranks, and 8 ranks of two heads); D = 64 and
   128; a window with rows that see no key; cross attention at G = 2 and
   7; q/k/v strided in a packed projection); two runs at the trainer's
   shape must be bit-equal, and the forward with the lse must write the
   output without it bit for bit; at the trainer's shape the backward is
   timed cold, and its rowdot, dk/dv and dq kernels each alone, beside
   the plain backward and the backward of
   ``scaled_dot_product_attention`` with K/V expanded (a yardstick), and
   the forward with the lse beside the forward without. (b)
   ``repro_torch.launch.train.main`` in-process at the reference
   launcher's defaults (``--batch 8 --seq 128``) on Qwen2-0.5B at full
   width and depth, random weights from the seed, TRAIN_STEPS
   steps (10), the step captured as a CUDA graph (step 1 its warm-up, then
   replays): every loss finite, the flash forward and backward counters
   up by 24 a step; the same steps eagerly (``train(...,
   capture=False)``) from the same seed: each step's loss and, after the
   last, every parameter leaf bit-equal; the in-place multi-tensor AdamW held to the
   functional one (the reference's form) over the same ten steps at full
   width (``adamw_forms``): fed the same gradients, every leaf within
   1e-4 of its largest |value|; fed its own, the worst leaf and the worst
   over the elements whose gradient stayed above SCALE_FREE of their
   leaf's largest printed (no bar: the trajectory's feedback, not the
   update); prints ms per step (median of steps 2 on; host
   clock, each step ending in the loss read), tokens/s and peak memory of
   both, and one profiled replayed step's busy share and device events
   (``train (b)`` line). (c)
   Depth 2 at full width, batch 2 x 32, card against the CPU: the loss
   within 1e-4 relative and every gradient leaf within 2e-3 of its largest
   |gradient| after one step; three steps' losses within 1e-3 relative.
   (d) A reduced Qwen2 trained two steps on the card and saved
   (``--checkpoint``) restores bit-equal, and ``python -m
   repro_torch.launch.serve --legacy-arch qwen2-0.5b --checkpoint`` serves
   from it on the card and on the CPU: the served tokens must agree (a
   differing token only at a near-tie, as in phase 4) and the restored
   model's prefill logits on the card within 2e-3 of the largest |logit|
   of the CPU's (writes under ``build/chip_smoke/train/``). (e) The SSD
   scan's backward kernels (``csrc/ssd_scan_bwd.cu``) against autograd of
   the plain scan on the card, within 1e-4 of the largest |gradient| of
   each of dx, ddt, dA, dB, dC and the initial state's: the trainer's
   shape (x (8, 128, 24, 64), one chunk), two chunks from an initial state
   with a final-state gradient, two groups, n = 40 at l = chunk, x/B/C as
   views of a packed projection (its gradient), ragged tiles; two runs
   bit-equal each; the forward with the chunks' start states bit-equal to
   the forward without; timed cold at the trainer's shape beside the plain
   backward (no PyTorch call computes it). (f) ``launch.train.main`` on
   Mamba2-130m at full width and depth, ``--batch 8 --seq 128``,
   TRAIN_STEPS steps: losses finite and falling, the scan's forward and
   backward counters up by 24 a step; captured against eager, the AdamW
   forms and the ``train (f)`` line as (b)'s; then
   depth 2 at full width, batch 2 x 256 (two chunks carry the state),
   card against the CPU: loss within 1e-4, every gradient leaf within 2e-3
   of its largest |gradient|. (g) ``launch.train.main`` on
   Granite-MoE-1B-A400M at full width and depth, ``--batch 8 --seq 128``,
   TRAIN_STEPS steps, the step captured: losses finite and falling; flash
   attention's forward and backward once a layer a step, the row gather
   and its backward (on its sort path: K = 10240 and 8192) twice; the same
   steps eagerly, every loss and leaf bit-equal; ms per step, tokens/s,
   peak memory, a profiled replayed step (busy share, device events,
   launches by kernel); then depth 2 at full width, batch 2 x 32, card
   against the CPU (loss 1e-4, gradients 2e-3, or a routing near-tie).
   (h) bf16 training. First the two bf16 backward kernels through
   autograd on bf16-exact inputs, each gradient on the bf16 bar
   (``bf16_bar``: the truth autograd of the fp32 plain version on the
   upcast inputs, the plain one autograd of the plain bf16 forward) and
   two runs bit-equal: attention (``csrc/flash_attention_bwd_bf16.cu``)
   at FLASH_BWD_BF16_CASES (the trainer's shape, a window, the vision
   model's cross shape), timed cold at the first and the last beside the
   bf16 plain backward and bf16 ``scaled_dot_product_attention``'s
   backward with K/V expanded; the scan (``csrc/ssd_scan_bwd_bf16.cu``)
   at SSD_BWD_BF16_CASES (the trainer's shape; two chunks from an initial
   state with a final-state gradient), timed at the trainer's shape
   beside the plain backward. Then Qwen2-0.5B, Mamba2-130m and
   Granite-MoE-1B-A400M as ``TransformerLM(cfg, torch.bfloat16)`` at full
   width and depth (the launcher's weights rounded once), TRAIN_STEPS
   steps of ``train/loop.py:train`` at 8 x 128, the step captured, and
   the same steps eagerly: every loss and leaf bit-equal, losses finite
   and falling, the bf16 forward and backward kernels' counters up by 24
   a step (Granite's gather and its bf16 backward by 48), the fp32
   kernels' not at all; ms per step, tokens/s, peak memory and a profiled
   replayed step beside (b)'s, (f)'s and (g)'s fp32 step (phase 9 runs
   (g) before (h)), the bf16 losses beside the fp32 run's (reported, no
   bar); then depth 2 at full width, card against the CPU (Qwen2 and
   Granite 2 x 32, Mamba2 2 x 256 over two chunks): the bf16 loss and
   every gradient leaf on the bf16 bar against the CPU's fp32 model on
   the same bf16-exact weights, Granite's beyond it only at a bf16
   routing tie (``train (h)`` lines).
10. Gradients through the dynamic-graph executors. (b) TreeGRU at
   model_size=512, 16 trees a step, phase 5's FSM, EXEC_TRAIN_STEPS (5)
   SGD steps of ``examples/tree_classifier_torch.py``'s loss through
   ``DynamicExecutor`` on the card and on the CPU: losses within 1e-4,
   gradients within 2e-3 of their max; the gather backward's counter
   rises, and its (K, n_src, row bytes) histogram is printed; the same
   steps through ``CompiledPlan`` on the card (eagerly: autograd records
   them, and a replayed graph records nothing) give DynamicExecutor's
   gradients within 1e-4; prints ms per step and the launches. (a) Then
   the row gather's backward kernel (``csrc/gather_rows_bwd.cu``, one
   launch up to its threshold, the sort past it) against the plain
   version: bit-equal to the CPU's everywhere; on the card src (2048, 512)
   at K = 1, 16, 256, 512 bit-equal; repeated and negative indices,
   MV-RNN-like (d, d) rows, rows of 68 bytes (4-byte units), K = 2048 (the
   threshold) and 2049 (sorted) and a last block of fewer rows within 1e-6
   of the largest |gradient| (every index on one row and the trash row,
   whose sums the card's index_add_ orders anew each run, to the CPU's
   bits alone);
   K = 5000 (merged sort tiles) bit-equal; two runs bit-equal each; timed
   cold at K = 1, 16, 256, 512, 2048, 2049 and at (b)'s commonest shape,
   each beside ``zeros`` + ``index_add_`` (a yardstick), and the plain
   version at K = 256. (c) ``examples/tree_classifier_torch.py`` on the
   card: its loss improves.
11. Cross-attention: Llama-3.2-Vision-11B. (a) At full width and depth
   (weights made on the card from the seed), image embeddings drawn from
   the seed: a prefill of 2 prompts of 64 tokens, then eight greedy
   decode steps, eager, through ``prefill`` and ``decode_step`` (flash
   attention once a layer, the 8 cross layers' non-causal over 1024 image
   tokens); ms of a prefill and a decode step. (b) One pattern repeat (5
   layers) of the same weights on the card against the CPU, the CPU fed
   the card's tokens: logits of the prefill and every step within 2e-3 of
   the largest |logit|, a differing argmax only at a near-tie; one loss
   and its gradients at batch 1 x 32 within 1e-4 and 2e-3. (c) Five steps
   at one repeat, the launcher's batch (8 x 128, 1024 image tokens), the
   step captured, beside the same steps eagerly: losses finite and
   falling, bit-equal; flash attention's forward and backward once a layer
   a step; ms per step, tokens/s, peak memory. Each model is freed before
   the next. In bf16 (the fp32 weights rounded once, the fp32 ones freed
   before it runs): (a)'s prefill and decode at full depth, the bf16
   attention kernel once a layer (the cross layers at the cross shape)
   and the fp32 one never, ms beside fp32's, the logit gap and tokens
   against fp32's reported; (b) one repeat on the card against the CPU's
   plain bf16 model on the bf16 bar, logits of the prefill and every step
   and one loss and its gradients at 1 x 32; (c) five bf16 steps at one
   repeat, captured against eager bit-equal, the bf16 attention forward
   and backward once a layer a step (``vision ... bf16`` lines).
12. The launch analysis tools (``launch/dryrun.py``). (a) ``dryrun_dynamic``
   on the card at model_size=512, the reference's batch size 2 and seed 0:
   all eight Table-1 workloads' weights made on the card and their graphs
   drawn from one rng, and the per-topology plan of each workload whose
   plan no earlier phase builds (all but DRYRUN_PLANNED_EARLIER: the
   tagger, TreeLSTM and LatticeLSTM, planned and captured by phases 3
   and 5) lowered, captured and replayed once; every row
   ``ok``; one line per workload (steps, arenas, slice and gather reads,
   fallback steps, capture and wall seconds); the row gather must launch;
   every row's plan statistics equal to the JAX package's own
   ``--dynamic`` rows at its defaults (:data:`DRYRUN_REFERENCE`). (b)
   ``dryrun.main(["--all", "--out", ...])``: the ten configurations x four
   shapes on the 16x16 mesh, traced on the meta device at full width and
   depth, in a process of its own beside (a) (both are host work); 40
   ``ok`` rows, printed by ``report.render`` with the collective term;
   the process must exit 0 without having initialised CUDA; the sweep's
   seconds; every row's ``coll_bytes`` (the step placed on the mesh as
   DTensors over a fake process group) within :data:`DRYRUN_COLL_BAR` of
   the reference's own ``--all`` row (:data:`DRYRUN_COLL_REFERENCE`), or
   within :data:`DRYRUN_COLL_HELD_SLACK` of its ratio in
   :data:`DRYRUN_COLL_HELD` (rows PERF.md explains); every row's
   ``temp_bytes`` (the memory term) within :data:`DRYRUN_MEM_BAR` either
   way of the reference's own row less XLA:CPU's float32 copies of the
   step's bf16 arguments (:data:`DRYRUN_MEM_REFERENCE`, made by
   ``tests/reference_memory.py``), or within the same slack of its ratio
   in :data:`DRYRUN_MEM_HELD`, and its ``bytes_per_device`` the temp and
   argument bytes. A second host process beside them reckons the ten
   ``train_4k`` rows with ``--layer-remat``: each note ``+lremat``, its
   temp on the same bar against :data:`DRYRUN_MEM_LREMAT_REFERENCE`, and
   no more than the plain (remat) row's.
13. Remat. (a) For each (configuration, dtype) of :data:`REMAT_TRAIN`
   (Qwen2-0.5B fp32, Mamba2-130m bf16, Granite-MoE-1B-A400M bf16; full
   width and depth), ``train/loop.py:train`` runs :data:`REMAT_STEPS`
   captured steps at TRAIN_BATCH x TRAIN_SEQ from the seed-0 weights and
   the seed-0 batches with ``remat=False``, then with ``remat=True`` (and,
   for Qwen2, again with ``layer_remat``): the losses and every parameter
   leaf bit-equal to the run without remat; without remat each forward
   and backward kernel of the path launched as often a step as the
   layers hold it, with remat every forward kernel twice that (the
   backward's recomputation) and every backward kernel as often; ms a
   step (the median of steps 2 on) and the peak memory above the start,
   remat off and on (``remat (a)`` lines). (b) Qwen2-0.5B at TRAIN_BATCH
   x TRAIN_SEQ, fp32 and bf16, remat off and on, run eagerly on the card
   (the loss and its gradients, and the trainer's whole step): the bytes
   the step makes at their most (``max_memory_allocated`` less the start,
   on a second call) against the dry-run's reckoning of the same step on
   the meta device, unplaced (``dryrun.count_step``), within
   :data:`REMAT_MEM_TOL` either way (``remat (b)`` line). Phase 13's
   seconds are printed.

Phases 2 and 4 hold the fp32 kernels other than the gather to 1e-4 of the
largest magnitude of their plain versions' outputs and the bf16 ones to
the bf16 bar, phase 9 the fp32 backward kernels to 1e-4 of the largest
|gradient| and the bf16 ones to the bf16 bar. The line before the
last is ``{"kernels": [...]}`` (per kernel: launches in the phase that
drives its path, max abs error, kernel / plain / bound / library ms; the
five forward kernels, the two bf16 forward kernels (launches on the bf16
waves) and the six backward kernels: flash attention's and the scan's
over the training steps of phase 9, their bf16 forms over phase 9 (h)'s
bf16 training, the gather's over phase 10 (b), its bf16 form's over
Granite's bf16 training in phase 9 (h); ``launches_by_path`` each
kernel's launches on every path that drives it, the MoE waves, Granite's
training and the vision model's, in fp32 and bf16, included; the
gather's and its backward's ``moe_shapes`` the MoE timings of phase 2,
the bf16 backward's ``combine`` its second Granite shape);
phase 2 logs each bound's byte and operation times and the peak it
divides by (3xTF32 on the tensor cores for every fp32 kernel with
products, bf16 on the tensor cores for the bf16 ones) on
a ``<kernel> bound:`` line; the last line is ``{"ok": true, "device":
{...}}``. The total seconds are printed before them. Without CUDA, or
without the package beside it, the script exits non-zero and prints no
result. ``--phases`` and ``--workloads`` run a part (phase 1 always) and
then print no result lines.
"""

from __future__ import annotations

import gc
import json
import random
import statistics
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MEM_BW = 3.35e12        # H100 SXM HBM3 bytes/s (data sheet)
FP32_PEAK = 67e12       # H100 SXM fp32 FLOP/s outside the tensor cores
TF32X3_PEAK = 495e12 / 3   # fp32 products as 3xTF32 on the tensor cores
BF16_PEAK = 989e12      # bf16 products on the tensor cores, dense
BF16_KERNEL_TOL = 3e-2  # the reference's bf16 kernel test (test_kernels.py)
MODEL_SIZE = 512
BATCH = 16              # sentences per minibatch, as benchmarks/bench_plan.py
N_FRESH = 3             # fresh topologies, then one repeat of the first
SEED = 0
# (K, row bytes) at which the gather is timed beside index_select: the
# path's most frequent K (TreeLSTM 1, the tagger 16), K = 256 (timed since
# the first port) and the largest K of both (512), all rows of 2048 bytes
# (`gather shapes` lines of phases 3 and 5)
GATHER_TIMED = [(1, 2048), (16, 2048), (256, 2048), (512, 2048)]


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


# -- timing ---------------------------------------------------------------


class ColdTimer:
    """Times one call at a time on the card with the L2 cache flushed
    before each (``cold=True``) or not, and returns the median in ms. A
    spin kernel holds the stream while the host enqueues the call, so the
    events bracket device time and not the wrapper's host overhead.

    The flush writes 128 MB and then reads another 128 MB that is never
    written: the write evicts whatever the call left in the 50 MB L2, and
    the read evicts the write's dirty lines, so that the timed call writes
    back none of them and finds L2 clean."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
        self.clean = torch.zeros(32 * 2**20, dtype=torch.float32,
                                 device="cuda")

    def __call__(self, fn, reps: int = 30, warmup: int = 3,
                 cold: bool = True) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            if cold:
                self.flush.zero_()
                self.clean.sum()
            torch.cuda._sleep(1_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def timed(dev, fn, reps: int = 5) -> float:
    """Median host ms of ``fn`` ending in a device synchronise."""
    from repro_torch.core.device import block

    times = []
    for _ in range(reps):
        block(dev)
        t = time.perf_counter()
        fn()
        block(dev)
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


# -- phase 1 --------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def build_kernels() -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.build_info.get('seconds', 0.0):.2f} s)")
    for src, report in sorted(build.build_info.get("ptxas", {}).items()):
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {src}: {line.strip()}")


# SASS opcodes counted per kernel: the tensor-core steps of mma.sync
# (HMMA) and of wgmma (HGMMA), and TMA tile loads (UTMALDG)
SASS_OPS = ("HMMA", "HGMMA", "UTMALDG")
# the kernels redesigned for Hopper: each must hold HGMMA and UTMALDG
HOPPER_KERNELS = ("flash_attention_bf16_kernel", "ssd_scan_bf16_kernel",
                  "flash_attention_bwd_bf16_dkdv_kernel",
                  "flash_attention_bwd_bf16_dq_kernel",
                  "ssd_bwd_bf16_chunk_kernel")


def sass_counts(kernels: tuple[str, ...]) -> dict | None:
    """Each named kernel's count of each SASS_OPS opcode in the built
    library, summed over its template instances, from ``cuobjdump
    -sass``; None where the toolkit has no cuobjdump."""
    import os
    import re
    import shutil

    from repro_torch.kernels import build

    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin"
        / "cuobjdump")
    if not Path(tool).exists():
        return None
    out = subprocess.run([tool, "-sass", str(build.build())],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        fail(f"cuobjdump failed: {out.stderr.strip()[-500:]}")
    counts = {k: dict.fromkeys(SASS_OPS, 0) for k in kernels}
    current = None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            current = next((k for k in kernels if k in line), None)
        elif current:
            for op in re.findall(r"\b(HMMA|HGMMA|UTMALDG)\b", line):
                counts[current][op] += 1
    return counts


# -- phase 2 --------------------------------------------------------------


def rel_err(got, want) -> float:
    """Max abs error relative to the largest magnitude of the result."""
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


PEAKS = {"fp32 on the CUDA cores": FP32_PEAK,
         "3xTF32 on the tensor cores": TF32X3_PEAK,
         "bf16 on the tensor cores": BF16_PEAK}


def bound(name: str, nbytes: float, flops: float,
          units: str = "fp32 on the CUDA cores") -> dict:
    """The least time the card could take: bytes over its memory rate or
    operations over the fp32 rate of the ``units`` the kernel's arithmetic
    runs on, whichever is larger. Logs both times and the peak used."""
    peak = PEAKS[units]
    t_bytes, t_ops = nbytes / MEM_BW, flops / peak
    log(f"{name} bound: bytes {t_bytes * 1e6:.4f} us ({nbytes:.0f} B at "
        f"{MEM_BW / 1e12} TB/s), operations {t_ops * 1e6:.4f} us "
        f"({flops:.0f} FLOP at {peak / 1e12:.0f} TFLOP/s, {units})")
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def cost_bound(name: str, cost: tuple[int, int],
               units: str = "fp32 on the CUDA cores") -> dict:
    """:func:`bound` of a launch's ``(flops, bytes)`` as
    ``kernels/costs.py`` counts them (the dry-run counts the same)."""
    flops, nbytes = cost
    return bound(name, nbytes, flops, units)


def check_gather(torch, timer) -> dict:
    from repro_torch.kernels import costs, ref
    from repro_torch.kernels.gather_batch import gather_rows

    g = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [
        ("path K=256", (2048, MODEL_SIZE), torch.float32, 256),
        ("path K=16", (2048, MODEL_SIZE), torch.float32, 16),
        ("ragged D=17", (512, 17), torch.float32, 100),
        ("3-D rows", (300, 4, 24), torch.float32, 77),
        ("bf16", (1000, MODEL_SIZE), torch.bfloat16, 64),
        ("fp16 ragged", (257, 33), torch.float16, 40),
    ]
    worst = 0.0
    for label, shape, dtype, k in cases:
        src = torch.randn(shape, generator=g, device="cuda").to(dtype)
        idx = torch.randint(0, shape[0], (k,), generator=g, device="cuda",
                            dtype=torch.int32)
        idx[: k // 4] = idx[0]                      # duplicate indices
        idx[k // 4] = -1                            # counts from the end
        idx[k // 4 + 1] = -shape[0]
        out = gather_rows(src, idx)
        want = ref.gather_rows_ref(src, idx)
        torch.cuda.synchronize()
        err = float((out.float() - want.float()).abs().max())
        worst = max(worst, err)
        if not torch.equal(out, want):
            fail(f"gather_rows {label}: not bit-equal to the plain version "
                 f"(max abs err {err})")
        log(f"gather_rows {label}: {tuple(shape)} {dtype} K={k} bit-equal")

    timed_shapes = {}
    for K, row_bytes in GATHER_TIMED:
        src = torch.randn((max(2048, 2 * K), row_bytes // 4), generator=g,
                          device="cuda")
        idx = torch.randint(0, src.shape[0], (K,), generator=g,
                            device="cuda", dtype=torch.int32)
        idx_long = idx.long()
        t = {f"{how}_{regime}": timer(fn, cold=regime == "cold")
             for regime in ("cold", "warm")
             for how, fn in (("ms", lambda: gather_rows(src, idx)),
                             ("library_ms", lambda: torch.index_select(
                                 src, 0, idx_long)))}
        timed_shapes[f"K={K} row_bytes={row_bytes}"] = t
        log(f"gather_rows K={K} row_bytes={row_bytes} ms: cold kernel "
            f"{t['ms_cold']:.5f}, index_select {t['library_ms_cold']:.5f}; "
            f"warm kernel {t['ms_warm']:.5f}, index_select "
            f"{t['library_ms_warm']:.5f}")

    N, D, K = 2048, MODEL_SIZE, 256
    src = torch.randn((N, D), generator=g, device="cuda")
    idx = torch.randint(0, N, (K,), generator=g, device="cuda",
                        dtype=torch.int32)
    idx_long = idx.long()
    ms = timer(lambda: gather_rows(src, idx))
    plain_ms = timer(lambda: ref.gather_rows_ref(src, idx))
    library_ms = timer(lambda: torch.index_select(src, 0, idx_long))
    log(f"gather_rows warm ms (L2-resident): kernel "
        f"{timer(lambda: gather_rows(src, idx), cold=False):.4f}, plain "
        f"{timer(lambda: ref.gather_rows_ref(src, idx), cold=False):.4f}")
    return {"name": "gather_rows", "route": "cuda",
            "source": "src/repro_torch/csrc/gather_rows.cu",
            "replaces": "src/repro/kernels/gather_batch.py:26",
            "shape": f"src ({N}, {D}) float32, K={K}",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            **cost_bound("gather_rows", costs.gather_rows(K, 4 * D, 4)),
            "library_ms": library_ms,
            "timed_shapes": timed_shapes}


def launch_floor(torch, timer) -> dict:
    """The fixed cost of a launch through the kernel library: an empty
    one-warp kernel in the same timer as the kernels, cold and warm."""
    from repro_torch.kernels import build

    lib = build.library()

    def empty():
        build.check(lib.empty_kernel_launch(
            torch.cuda.current_stream().cuda_stream), "empty_kernel")
    floor = {"cold_ms": timer(empty), "warm_ms": timer(empty, cold=False)}
    log(f"launch floor: empty kernel ms cold {floor['cold_ms']:.5f}, warm "
        f"{floor['warm_ms']:.5f}")
    return floor


def check_fused(torch, timer) -> dict:
    from repro_torch.kernels import costs, ref
    from repro_torch.kernels.fused_gather_cell import fused_gather_lstm_cell

    E = H = MODEL_SIZE
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    Nx, Nh = 2048, 2048
    x_src = torch.randn((Nx, E), generator=g, device="cuda")
    h_src = torch.randn((Nh, H), generator=g, device="cuda")
    c_src = torch.randn((Nh, H), generator=g, device="cuda")
    w = 0.05 * torch.randn((E + H, 4 * H), generator=g, device="cuda")
    b = 0.1 * torch.randn((4 * H,), generator=g, device="cuda")

    def idx(n, B):
        return torch.randint(0, n, (B,), generator=g, device="cuda",
                             dtype=torch.int32)

    worst = 0.0
    cases = [(f"B={B}", idx(Nx, B), idx(Nh, B), idx(Nh, B))
             for B in (1, 16, 32)]
    ix = torch.tensor([0, 0, 0, 3, 3, 3] + [9] * 10, device="cuda",
                      dtype=torch.int32)
    cases.append(("duplicate and pad lanes", ix, ix.flip(0).contiguous(), ix))
    neg = torch.tensor([-1, -Nx, 5, -2], device="cuda", dtype=torch.int32)
    cases.append(("negative indices", neg, neg.flip(0).contiguous(), neg))
    for label, ix, ih, ic in cases:
        h2, c2 = fused_gather_lstm_cell(x_src, h_src, c_src, ix, ih, ic, w, b)
        hr, cr = ref.fused_gather_lstm_cell_ref(x_src, h_src, c_src, ix, ih,
                                                ic, w, b)
        torch.cuda.synchronize()
        err = max(float((h2 - hr).abs().max()), float((c2 - cr).abs().max()))
        if not err <= 1e-4:
            fail(f"fused_gather_lstm_cell {label}: max abs err {err} > 1e-4")
        worst = max(worst, err)
        log(f"fused_gather_lstm_cell {label}: max abs err {err:.3e}")

    B = BATCH
    ix, ih, ic = idx(Nx, B), idx(Nh, B), idx(Nh, B)
    ms = timer(lambda: fused_gather_lstm_cell(x_src, h_src, c_src, ix, ih, ic,
                                              w, b))
    plain_ms = timer(lambda: ref.fused_gather_lstm_cell_ref(
        x_src, h_src, c_src, ix, ih, ic, w, b))
    for Bt in (1, 16, 32):
        jx, jh, jc = idx(Nx, Bt), idx(Nh, Bt), idx(Nh, Bt)

        def call():
            return fused_gather_lstm_cell(x_src, h_src, c_src, jx, jh, jc, w, b)
        log(f"fused_gather_lstm_cell B={Bt} ms: cold {timer(call):.4f}, "
            f"warm (L2-resident) {timer(call, cold=False):.4f}")
    return {"name": "fused_gather_lstm_cell", "route": "cuda",
            "source": "src/repro_torch/csrc/fused_gather_lstm_cell.cu",
            "replaces": "src/repro/kernels/fused_gather_cell.py:47",
            "shape": f"E=H={E}, B={B}, float32",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            **cost_bound("fused_gather_lstm_cell",
                         costs.fused_gather_lstm_cell(B, E, H),
                         "3xTF32 on the tensor cores"),
            "library_ms": None}


def check_fused_dense(torch, timer) -> dict:
    """The dense cell against its plain version (within 1e-4 of the largest
    |output|) at the path's, table5's, the reference tests' and ragged
    shapes, and composed with the row gather against the gather cell. Its
    launches are those of these checks: no model path launches it."""
    from repro_torch.kernels import costs, ref
    from repro_torch.kernels.fused_cell import fused_lstm_cell
    from repro_torch.kernels.fused_gather_cell import fused_gather_lstm_cell

    g = torch.Generator(device="cuda").manual_seed(SEED + 4)

    def inputs(B, K, H):
        return (torch.randn((B, K), generator=g, device="cuda"),
                0.05 * torch.randn((K, 4 * H), generator=g, device="cuda"),
                0.1 * torch.randn((4 * H,), generator=g, device="cuda"),
                torch.randn((B, H), generator=g, device="cuda"))

    cases = [  # (label, B, K, H)
        ("path", BATCH, 2 * MODEL_SIZE, MODEL_SIZE),
        *((f"table5 H={H}", 16, 2 * H, H) for H in (64, 128, 256)),
        *((f"reference B={B} K={K} H={H}", B, K, H)
          for B, K, H in ((8, 64, 32), (4, 32, 32), (16, 128, 64))),
        ("B=1", 1, 2 * MODEL_SIZE, MODEL_SIZE),
        ("ragged B=37 K=333 H=100", 37, 333, 100),
        ("ragged B=5 K=7 H=13", 5, 7, 13),
        ("K=1 H=1", 3, 1, 1),
    ]
    fused_lstm_cell.launches = 0
    worst = worst_rel = 0.0
    for label, B, K, H in cases:
        xh, w, b, c = inputs(B, K, H)
        h2, c2 = fused_lstm_cell(xh, w, b, c)
        hr, cr = ref.fused_lstm_cell_ref(xh, w, b, c)
        torch.cuda.synchronize()
        err = max(rel_err(h2, hr), rel_err(c2, cr))
        if not err <= 1e-4:
            fail(f"fused_lstm_cell {label}: relative err {err} > 1e-4")
        worst_rel = max(worst_rel, err)
        worst = max(worst, float((h2 - hr).abs().max()),
                    float((c2 - cr).abs().max()))
        log(f"fused_lstm_cell {label} (B={B}, K={K}, H={H}): relative err "
            f"{err:.3e}")

    # the dense cell on gathered rows is the gather cell
    E = H = MODEL_SIZE
    n = 2048
    x_src, h_src, c_src = (torch.randn((n, E), generator=g, device="cuda")
                           for _ in range(3))
    _, w, b, _ = inputs(1, E + H, H)
    ix, ih, ic = (torch.randint(-n, n, (BATCH,), generator=g, device="cuda",
                                dtype=torch.int32) for _ in range(3))
    xh = torch.cat([x_src[ix.long()], h_src[ih.long()]], dim=1)
    h2, c2 = fused_lstm_cell(xh, w, b, c_src[ic.long()].contiguous())
    h3, c3 = fused_gather_lstm_cell(x_src, h_src, c_src, ix, ih, ic, w, b)
    torch.cuda.synchronize()
    err = max(rel_err(h2, h3), rel_err(c2, c3))
    if not err <= 1e-4:
        fail(f"fused_lstm_cell on gathered rows vs fused_gather_lstm_cell: "
             f"relative err {err} > 1e-4")
    log(f"fused_lstm_cell on gathered rows vs fused_gather_lstm_cell: "
        f"relative err {err:.3e}")
    launches = fused_lstm_cell.launches

    B, K, H = BATCH, 2 * MODEL_SIZE, MODEL_SIZE
    xh, w, b, c = inputs(B, K, H)
    ms = timer(lambda: fused_lstm_cell(xh, w, b, c))
    plain_ms = timer(lambda: ref.fused_lstm_cell_ref(xh, w, b, c))
    # yardstick only, the port never calls it: nn.LSTMCell's own call, with
    # xh split at E = K - H and the bias in b_ih
    E = K - H
    x, h = xh[:, :E].contiguous(), xh[:, E:].contiguous()
    w_ih, w_hh = w[:E].t().contiguous(), w[E:].t().contiguous()
    b_hh = torch.zeros_like(b)
    h4, c4 = torch._VF.lstm_cell(x, (h, c), w_ih, w_hh, b, b_hh)
    hr, cr = ref.fused_lstm_cell_ref(xh, w, b, c)
    err = max(rel_err(h4, hr), rel_err(c4, cr))
    if not err <= 1e-4:
        fail(f"torch._VF.lstm_cell does not compute the cell: {err}")
    library_ms = timer(
        lambda: torch._VF.lstm_cell(x, (h, c), w_ih, w_hh, b, b_hh))
    for Bt in (1, 16, 32):
        xt, _, _, ct = inputs(Bt, K, H)
        log(f"fused_lstm_cell B={Bt} ms: cold "
            f"{timer(lambda: fused_lstm_cell(xt, w, b, ct)):.4f}, warm "
            f"(L2-resident) "
            f"{timer(lambda: fused_lstm_cell(xt, w, b, ct), cold=False):.4f}")
    return {"name": "fused_lstm_cell", "route": "cuda",
            "source": "src/repro_torch/csrc/fused_lstm_cell.cu",
            "replaces": "src/repro/kernels/fused_cell.py:53",
            "shape": f"B={B}, K={K}, H={H}, float32",
            "launches": launches, "max_abs_err": worst,
            "max_rel_err": worst_rel, "ms": ms, "plain_ms": plain_ms,
            **cost_bound("fused_lstm_cell", costs.fused_lstm_cell(B, K, H),
                         "3xTF32 on the tensor cores"),
            "library_ms": library_ms}


def library_kernels(torch, fn) -> list:
    """Names of the device kernels one call of ``fn`` launches, from one
    profiled call (the window padded as ``profile_run``'s)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pad_profiler(torch)
        fn()
        torch.cuda.synchronize()
        pad_profiler(torch)
    return sorted({e.name for e in device_events(prof)})


# (label, B, Sq, Skv, H, KV, D, causal, window): the Qwen2 wave's prefill
# shapes and the kernels' tile edges, checked in fp32 and in bf16
FLASH_CASES = [
    ("path S=96 B=2", 2, 96, 96, 14, 2, 64, True, 0),
    ("path S=32 B=1", 1, 32, 32, 14, 2, 64, True, 0),
    ("path S=48 B=4", 4, 48, 48, 14, 2, 64, True, 0),
    ("path S=96 B=4", 4, 96, 96, 14, 2, 64, True, 0),
    ("ragged S=100", 2, 100, 100, 14, 2, 64, True, 0),
    ("window 16, S=130", 1, 130, 130, 4, 2, 64, True, 16),
    ("cross Sq=40 Skv=77", 2, 40, 77, 6, 3, 64, False, 0),
    ("D=128 MHA", 1, 70, 70, 4, 4, 128, True, 0),
    # tile edges: a warp's 16 rows, an 8-column mma tile, a K/V tile
    ("P V relayout D=16 Skv=8", 1, 8, 8, 2, 1, 16, True, 0),
    ("Sq=1 Skv=77 D=16 G=7", 2, 1, 77, 14, 2, 16, True, 0),
    ("Sq=15 Skv=8 D=128 G=7", 2, 15, 8, 14, 2, 128, True, 0),
    ("cross Sq=17 Skv=9 D=32", 2, 17, 9, 2, 2, 32, False, 0),
    ("window 8 Sq=100 Skv=77", 1, 100, 77, 2, 2, 64, True, 8),
    ("window 4 Sq=17 Skv=9, rows with no key", 1, 17, 9, 14, 2, 16,
     True, 4),
]


def check_flash(torch, timer) -> dict:
    from repro_torch.kernels import costs, ref
    from repro_torch.kernels.flash_attention import flash_attention

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    worst = 0.0
    for label, B, Sq, Skv, H, KV, D, causal, window in FLASH_CASES:
        q = torch.randn((B, Sq, H, D), generator=g, device="cuda")
        k = torch.randn((B, Skv, KV, D), generator=g, device="cuda")
        v = torch.randn((B, Skv, KV, D), generator=g, device="cuda")
        out = flash_attention(q, k, v, causal=causal, window=window)
        want = ref.flash_attention_ref(q, k, v, causal, window)
        torch.cuda.synchronize()
        err = rel_err(out, want)
        if not err <= 1e-4:
            fail(f"flash_attention {label}: relative err {err} > 1e-4")
        worst = max(worst, float((out - want).abs().max()))
        log(f"flash_attention {label}: relative err {err:.3e}")

    H, KV, D = 14, 2, 64
    sdpa = torch.nn.functional.scaled_dot_product_attention
    waves = {}
    for S, B in ((32, 2), (96, 4)):   # the Qwen2 wave's prefill shapes
        q = torch.randn((B, S, H, D), generator=g, device="cuda")
        k = torch.randn((B, S, KV, D), generator=g, device="cuda")
        v = torch.randn((B, S, KV, D), generator=g, device="cuda")
        # yardstick only: the port never calls it
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (t.repeat_interleave(H // KV, dim=2).transpose(1, 2)
                  .contiguous() for t in (k, v))
        waves[f"S={S} B={B}"] = {
            "ms": timer(lambda: flash_attention(q, k, v)),
            "library_ms": timer(lambda: sdpa(qt, kt, vt, is_causal=True)),
            "warm_ms": timer(lambda: flash_attention(q, k, v), cold=False)}
        log(f"flash_attention S={S} B={B} ms: cold kernel "
            f"{waves[f'S={S} B={B}']['ms']:.4f}, scaled_dot_product_attention "
            f"{waves[f'S={S} B={B}']['library_ms']:.4f}, warm kernel "
            f"{waves[f'S={S} B={B}']['warm_ms']:.4f}")
    # q, k, v, qt, kt, vt are the larger wave's from here on
    plain_ms = timer(lambda: ref.flash_attention_ref(q, k, v))
    log(f"scaled_dot_product_attention runs: "
        f"{library_kernels(torch, lambda: sdpa(qt, kt, vt, is_causal=True))}")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:65",
            "shape": f"q ({B}, {S}, {H}, {D}), k/v ({B}, {S}, {KV}, {D}) "
                     f"float32, causal",
            "max_abs_err": worst, "ms": waves[f"S={S} B={B}"]["ms"],
            "plain_ms": plain_ms,
            **cost_bound("flash_attention",
                         costs.flash_attention(B, S, S, H, KV, D, True, 0),
                         "3xTF32 on the tensor cores"),
            "library_ms": waves[f"S={S} B={B}"]["library_ms"],
            "waves": waves}


def bf16_bar(label: str, got, plain, truth, kernel: bool = True,
             routing: dict | None = None) -> dict:
    """The one bar of every bf16 comparison on the card: ``truth`` is the
    plain version in fp32 on the same bf16-exact inputs, upcast; ``got``
    (a kernel's or a model's output) must be within twice the plain bf16
    version's (``plain``) largest error against it, and a kernel also
    within BF16_KERNEL_TOL of the largest |truth|. An MoE model's output
    beyond it passes only where its routing and the plain model's
    (``routing``, :func:`routing_divergence`) first differ at a bf16 tie
    (:func:`routing_tie`). Returns both errors."""
    truth = truth.float()
    err = float((got.float() - truth).abs().max())
    plain_err = float((plain.float() - truth).abs().max())
    scale = float(truth.abs().max().clamp_min(1e-30))
    out = {"err": err, "plain_err": plain_err, "rel_err": err / scale}
    if not err <= 2 * plain_err:
        if not routing_tie(routing):
            fail(f"{label}: bf16 error {err} against the fp32 plain version "
                 f"is above twice the plain bf16 version's, {plain_err} "
                 f"(routing {routing})")
        log(f"{label}: bf16 error {err:.3e} above twice the plain bf16 "
            f"version's {plain_err:.3e}, accepted at a routing tie: "
            f"{routing_gap(routing)}")
        out["routing_tie"] = True
    if kernel and not err <= BF16_KERNEL_TOL * scale:
        fail(f"{label}: bf16 error {err} is above {BF16_KERNEL_TOL} of the "
             f"largest |value|, {scale}")
    return out


def check_flash_bf16(torch, timer) -> dict:
    """The bf16 forward kernel against its plain version on the bf16 bar
    (:func:`bf16_bar`), at FLASH_CASES and the vision model's cross
    shape, the log-sum-exp within 1e-4 of the fp32
    plain version's, two runs bit-equal; timed at the wave's two prefill
    shapes beside the plain bf16 version and bf16
    ``scaled_dot_product_attention``, and at the cross shape beside bf16
    ``scaled_dot_product_attention`` with its bound (the row's
    ``cross``)."""
    from repro_torch.kernels import costs, ref
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_forward)

    g = torch.Generator(device="cuda").manual_seed(SEED + 12)

    def bf16(shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()

    cases = FLASH_CASES + [("vision cross Sq=64 Skv=1024 D=128 G=4", 2,
                            64, 1024, 32, 8, 128, False, 0)]
    worst = 0.0
    for label, B, Sq, Skv, H, KV, D, causal, window in cases:
        q, k, v = bf16((B, Sq, H, D)), bf16((B, Skv, KV, D)), \
            bf16((B, Skv, KV, D))
        out, lse = flash_attention_forward(q, k, v, causal, window,
                                           with_lse=True)
        again, _ = flash_attention_forward(q, k, v, causal, window)
        truth = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                        causal, window)
        plain = ref.flash_attention_ref(q, k, v, causal, window)
        lse_err = rel_err(lse, ref.flash_attention_lse_ref(
            q.float(), k.float(), causal, window))
        torch.cuda.synchronize()
        if out.dtype != torch.bfloat16 or lse.dtype != torch.float32:
            fail(f"flash_attention_bf16 {label}: out {out.dtype}, lse "
                 f"{lse.dtype}")
        bar = bf16_bar(f"flash_attention_bf16 {label}", out, plain, truth)
        if not lse_err <= 1e-4:
            fail(f"flash_attention_bf16 {label}: lse relative err {lse_err}")
        if not torch.equal(again, out):
            fail(f"flash_attention_bf16 {label}: two runs differ")
        worst = max(worst, bar["err"])
        log(f"flash_attention_bf16 {label}: max abs err {bar['err']:.3e} "
            f"(plain bf16 {bar['plain_err']:.3e}; relative "
            f"{bar['rel_err']:.3e}), lse relative err {lse_err:.3e}")

    H, KV, D = 14, 2, 64
    sdpa = torch.nn.functional.scaled_dot_product_attention
    waves = {}
    for S, B in ((32, 2), (96, 4)):   # the Qwen2 wave's prefill shapes
        q, k, v = bf16((B, S, H, D)), bf16((B, S, KV, D)), bf16((B, S, KV, D))
        # yardstick only: the port never calls it
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (t.repeat_interleave(H // KV, dim=2).transpose(1, 2)
                  .contiguous() for t in (k, v))
        w = waves[f"S={S} B={B}"] = {
            "ms": timer(lambda: flash_attention(q, k, v)),
            "library_ms": timer(lambda: sdpa(qt, kt, vt, is_causal=True)),
            "warm_ms": timer(lambda: flash_attention(q, k, v), cold=False)}
        log(f"flash_attention_bf16 S={S} B={B} ms: cold kernel {w['ms']:.4f}"
            f", scaled_dot_product_attention bf16 {w['library_ms']:.4f}, "
            f"warm kernel {w['warm_ms']:.4f}")
    plain_ms = timer(lambda: ref.flash_attention_ref(q, k, v))
    log(f"scaled_dot_product_attention bf16 runs: "
        f"{library_kernels(torch, lambda: sdpa(qt, kt, vt, is_causal=True))}")
    # the vision model's cross shape: 4 query heads a KV head, 1024 keys
    cB, cSq, cSkv, cH, cKV, cD = 2, 64, 1024, 32, 8, 128
    cq, ck, cv = bf16((cB, cSq, cH, cD)), bf16((cB, cSkv, cKV, cD)), \
        bf16((cB, cSkv, cKV, cD))
    cqt = cq.transpose(1, 2).contiguous()
    ckt, cvt = (t.repeat_interleave(cH // cKV, dim=2).transpose(1, 2)
                .contiguous() for t in (ck, cv))
    cross = {"shape": f"q ({cB}, {cSq}, {cH}, {cD}), k/v ({cB}, {cSkv}, "
                      f"{cKV}, {cD}) bfloat16, non-causal",
             "ms": timer(lambda: flash_attention(cq, ck, cv, causal=False)),
             "library_ms": timer(lambda: sdpa(cqt, ckt, cvt)),
             "plain_ms": timer(lambda: ref.flash_attention_ref(
                 cq, ck, cv, False)),
             **cost_bound("flash_attention_bf16 cross",
                          costs.flash_attention(cB, cSq, cSkv, cH, cKV, cD,
                                                False, 0, False, 2),
                          "bf16 on the tensor cores")}
    log(f"flash_attention_bf16 cross ms: cold kernel {cross['ms']:.4f}, "
        f"scaled_dot_product_attention bf16 {cross['library_ms']:.4f}, "
        f"plain bf16 {cross['plain_ms']:.4f}, bound {cross['bound_ms']:.6f} "
        f"({cross['bound_by']})")
    return {"name": "flash_attention_bf16", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_bf16.cu",
            "replaces": "src/repro/kernels/flash_attention.py:65",
            "shape": f"q ({B}, {S}, {H}, {D}), k/v ({B}, {S}, {KV}, {D}) "
                     f"bfloat16, causal",
            "max_abs_err": worst, "ms": waves[f"S={S} B={B}"]["ms"],
            "plain_ms": plain_ms,
            **cost_bound("flash_attention_bf16", costs.flash_attention(
                B, S, S, H, KV, D, True, 0, False, 2),
                "bf16 on the tensor cores"),
            "library_ms": waves[f"S={S} B={B}"]["library_ms"],
            "waves": waves, "cross": cross}


def check_ssd_bf16(torch, timer) -> dict:
    """The bf16 forward kernel against its plain version on the bf16 bar
    (y; the fp32 final state and chunk start states on the same bar, the
    kernel's 3e-2 of their largest magnitude included), at the Mamba2
    wave's prefill shapes, from an initial state and at small odd
    shapes, two runs bit-equal; timed at the wave's two prefill shapes
    beside the plain bf16 version."""
    from repro_torch.kernels import costs, ref
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_forward

    g = torch.Generator(device="cuda").manual_seed(SEED + 13)

    def inputs(b, l, h, p, grp, n):
        return (torch.randn((b, l, h, p), generator=g,
                            device="cuda").bfloat16(),
                (torch.rand((b, l, h), generator=g, device="cuda")
                 * 0.5).bfloat16(),
                -torch.rand((h,), generator=g, device="cuda") * 0.5,
                torch.randn((b, l, grp, n), generator=g,
                            device="cuda").bfloat16(),
                torch.randn((b, l, grp, n), generator=g,
                            device="cuda").bfloat16())

    cases = [  # (label, b, l, h, p, groups, n, chunk, from a state)
        ("path l=128 B=3", 3, 128, 24, 64, 1, 128, 128, False),
        ("path l=256 B=3", 3, 256, 24, 64, 1, 128, 128, False),
        ("groups 2, chunk 16", 2, 64, 8, 16, 2, 16, 16, False),
        ("ragged p=24 n=40 chunk 32", 1, 96, 4, 24, 1, 40, 32, False),
        ("chunk 8 n=16 p=24 groups 2", 2, 24, 4, 24, 2, 16, 8, False),
        ("chunk 24 n=40 p=64", 2, 72, 4, 64, 1, 40, 24, False),
        ("chunk 24 n=128 p=24 groups 2", 1, 48, 4, 24, 2, 128, 24, False),
        ("chunk 40 n=8 p=8, one row tile short", 1, 120, 3, 8, 1, 8, 40,
         False),
        ("init state, path l=256 B=3", 3, 256, 24, 64, 1, 128, 128, True),
        ("init state, ragged p=24 n=40 chunk 24", 2, 48, 4, 24, 2, 40, 24,
         True),
        ("init state, chunk 96 n=64 p=64", 1, 192, 2, 64, 1, 64, 96, True),
    ]
    worst = 0.0
    for label, b, l, h, p, grp, n, chunk, from_state in cases:
        x, dt, A, B, C = inputs(b, l, h, p, grp, n)
        s0 = (torch.randn((b, h, p, n), generator=g, device="cuda")
              if from_state else None)
        y, final, states = ssd_scan_forward(x, dt, A, B, C, chunk, s0,
                                            with_states=True)
        y2, final2, _ = ssd_scan_forward(x, dt, A, B, C, chunk, s0)
        up = [t.float() for t in (x, dt, B, C)]
        y_t, final_t = ref.ssd_scan_ref(up[0], up[1], A, up[2], up[3], chunk,
                                        s0)
        states_t = ref.ssd_chunk_states(up[0], up[1], A, up[2], chunk, s0)
        y_p, final_p = ref.ssd_scan_ref(x, dt, A, B, C, chunk, s0)
        torch.cuda.synchronize()
        if (y.dtype, final.dtype, states.dtype) != (
                torch.bfloat16, torch.float32, torch.float32):
            fail(f"ssd_scan_bf16 {label}: y {y.dtype}, final {final.dtype}")
        bar = bf16_bar(f"ssd_scan_bf16 {label} y", y, y_p, y_t)
        fbar = bf16_bar(f"ssd_scan_bf16 {label} final state", final,
                        final_p, final_t)
        srel = rel_err(states, states_t)
        if not (torch.equal(y, y2) and torch.equal(final, final2)):
            fail(f"ssd_scan_bf16 {label}: two runs differ")
        if not srel <= BF16_KERNEL_TOL:
            fail(f"ssd_scan_bf16 {label}: chunk start states relative err "
                 f"{srel}")
        worst = max(worst, bar["err"])
        log(f"ssd_scan_bf16 {label}: y max abs err {bar['err']:.3e} (plain "
            f"bf16 {bar['plain_err']:.3e}; relative {bar['rel_err']:.3e}), "
            f"final state {fbar['err']:.3e} (plain {fbar['plain_err']:.3e})"
            f", start states relative {srel:.3e}")

    h, p, n, q = 24, 64, 128, 128
    waves = {}
    for l, b in ((128, 3), (256, 3)):   # the Mamba2 wave's prefill shapes
        x, dt, A, B, C = inputs(b, l, h, p, 1, n)
        w = waves[f"l={l} B={b}"] = {
            "ms": timer(lambda: ssd_scan(x, dt, A, B, C, q)),
            "warm_ms": timer(lambda: ssd_scan(x, dt, A, B, C, q),
                             cold=False)}
        log(f"ssd_scan_bf16 l={l} B={b} ms: cold {w['ms']:.4f}, warm "
            f"{w['warm_ms']:.4f}")
    plain_ms = timer(lambda: ref.ssd_scan_ref(x, dt, A, B, C, q))
    return {"name": "ssd_scan_bf16", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_scan_bf16.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:64",
            "shape": f"x ({b}, {l}, {h}, {p}), B/C ({b}, {l}, 1, {n}), "
                     f"chunk {q}, bfloat16",
            "max_abs_err": worst, "ms": waves[f"l={l} B={b}"]["ms"],
            "plain_ms": plain_ms,
            **cost_bound("ssd_scan_bf16", costs.ssd_scan(
                b, l, h, p, 1, n, q, False, False, 2),
                "bf16 on the tensor cores"),
            "library_ms": None, "waves": waves}


def check_ssd(torch, timer) -> dict:
    from repro_torch.kernels import costs, ref
    from repro_torch.kernels.ssd_scan import ssd_scan

    g = torch.Generator(device="cuda").manual_seed(SEED + 3)

    def inputs(b, l, h, p, grp, n):
        return (torch.randn((b, l, h, p), generator=g, device="cuda"),
                torch.rand((b, l, h), generator=g, device="cuda") * 0.5,
                -torch.rand((h,), generator=g, device="cuda") * 0.5,
                torch.randn((b, l, grp, n), generator=g, device="cuda"),
                torch.randn((b, l, grp, n), generator=g, device="cuda"))

    def packed(b, l, h, p, grp, n):
        """x, B and C as views into one (b, l, 1 + h p + 2 grp n)
        projection at an odd offset: no row of x or B starts on a 16-byte
        boundary, so the kernel stages them 4 bytes at a time."""
        xbc = torch.randn((b, l, 1 + h * p + 2 * grp * n), generator=g,
                          device="cuda")
        o = 1 + h * p
        _, dt, A, _, _ = inputs(b, l, h, 1, 1, 1)
        return (xbc[..., 1:o].view(b, l, h, p), dt, A,
                xbc[..., o:o + grp * n].view(b, l, grp, n),
                xbc[..., o + grp * n:].view(b, l, grp, n))

    cases = [  # (label, b, l, h, p, groups, n, chunk, from a state)
        ("path l=128 B=1", 1, 128, 24, 64, 1, 128, 128, False),
        ("path l=256 B=3", 3, 256, 24, 64, 1, 128, 128, False),
        ("path l=256 B=4", 4, 256, 24, 64, 1, 128, 128, False),
        ("groups 2, chunk 16", 2, 64, 8, 16, 2, 16, 16, False),
        ("ragged p=24 n=40 chunk 32", 1, 96, 4, 24, 1, 40, 32, False),
        # tile edges: one 8-row tile, half a 16-row tile, 5 column tiles
        ("chunk 8 n=16 p=24 groups 2", 2, 24, 4, 24, 2, 16, 8, False),
        ("chunk 24 n=40 p=64", 2, 72, 4, 64, 1, 40, 24, False),
        ("chunk 24 n=128 p=24 groups 2", 1, 48, 4, 24, 2, 128, 24, False),
        ("init state, path l=256 B=3", 3, 256, 24, 64, 1, 128, 128, True),
        ("init state, ragged p=24 n=40 chunk 24", 2, 48, 4, 24, 2, 40, 24,
         True),
        # 4-byte staging: rows of B (n = 33) or x (p = 21, 37) that are not
        # whole 16-byte chunks, and a packed projection at an odd offset
        ("4-byte B n=33 p=20 chunk 24", 2, 48, 4, 20, 1, 33, 24, False),
        ("4-byte x n=32 p=21 chunk 24, init state", 2, 48, 4, 21, 1, 32, 24,
         True),
        ("4-byte B and x n=33 p=37 chunk 24 groups 2", 2, 48, 4, 37, 2, 33,
         24, False),
        ("4-byte B and x n=33 p=37 chunk 24 groups 2, init state", 2, 48, 4,
         37, 2, 33, 24, True),
        ("packed at an odd offset, path l=256 B=2", 2, 256, 24, 64, 1, 128,
         128, False),
        ("packed at an odd offset, path l=256 B=2, init state", 2, 256, 24,
         64, 1, 128, 128, True),
    ]
    worst = 0.0
    for label, b, l, h, p, grp, n, chunk, from_state in cases:
        make = packed if label.startswith("packed") else inputs
        x, dt, A, B, C = make(b, l, h, p, grp, n)
        s0 = (torch.randn((b, h, p, n), generator=g, device="cuda")
              if from_state else None)
        y, final = ssd_scan(x, dt, A, B, C, chunk, s0)
        y_ref, final_ref = ref.ssd_scan_ref(x, dt, A, B, C, chunk, s0)
        torch.cuda.synchronize()
        err = max(rel_err(y, y_ref), rel_err(final, final_ref))
        if not err <= 1e-4:
            fail(f"ssd_scan {label}: relative err {err} > 1e-4")
        worst = max(worst, float((y - y_ref).abs().max()),
                    float((final - final_ref).abs().max()))
        log(f"ssd_scan {label}: relative err (y, final state) {err:.3e}")

    h, p, n, q = 24, 64, 128, 128
    waves = {}
    for l, b in ((128, 3), (256, 3)):   # the Mamba2 wave's prefill shapes
        x, dt, A, B, C = inputs(b, l, h, p, 1, n)
        waves[f"l={l} B={b}"] = {
            "ms": timer(lambda: ssd_scan(x, dt, A, B, C, q)),
            "warm_ms": timer(lambda: ssd_scan(x, dt, A, B, C, q),
                             cold=False)}
        log(f"ssd_scan l={l} B={b} ms: cold {waves[f'l={l} B={b}']['ms']:.4f}"
            f", warm {waves[f'l={l} B={b}']['warm_ms']:.4f}")
    # x, dt, A, B, C are the longer wave's from here on
    plain_ms = timer(lambda: ref.ssd_scan_ref(x, dt, A, B, C, q))
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:64",
            "shape": f"x ({b}, {l}, {h}, {p}), B/C ({b}, {l}, 1, {n}), "
                     f"chunk {q}, float32",
            "max_abs_err": worst, "ms": waves[f"l={l} B={b}"]["ms"],
            "plain_ms": plain_ms,
            **cost_bound("ssd_scan", costs.ssd_scan(
                b, l, h, p, 1, n, q, False, False),
                "3xTF32 on the tensor cores"),
            "library_ms": None, "waves": waves}


# -- phase 3 --------------------------------------------------------------


def y_logits(res):
    """Every output logit of a run, on the host in float64 (exact for a
    float32 run), and the number of y nodes."""
    ids = list(res.nodes_with_field("y"))
    return res.field("y", ids).double().cpu(), len(ids)


# Empty kernels launched at both edges of every profile window, each batch
# followed by a pause on the host, and left out of what the window reports.
# The profiler keeps only the device records that fall inside its window on
# its own clock, and drops a few kernels next to an edge: a serve pass saw
# 425 of the 428 gathers it launched with no padding, and 424 of them, late
# in a run, with the opening batch alone.
PROFILE_PAD = 256
PROFILE_GAP_S = 0.02


def pad_profiler(torch) -> None:
    """Launches PROFILE_PAD empty kernels, waits for them and pauses
    PROFILE_GAP_S; opens and closes every profile window."""
    from repro_torch.kernels import build

    lib = build.library()
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(PROFILE_PAD):
        build.check(lib.empty_kernel_launch(stream), "empty_kernel")
    torch.cuda.synchronize()
    time.sleep(PROFILE_GAP_S)


def device_events(prof) -> list:
    """The profiled window's events on the card, the padding left out."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and "empty_kernel" not in e.name]


def pads_seen(prof, events: list) -> list:
    """How many of the opening and of the closing PROFILE_PAD empty
    kernels the profiler kept: fewer than all says that it dropped
    records at that edge."""
    from torch.autograd import DeviceType

    pads = [e.time_range.start for e in prof.events()
            if e.device_type == DeviceType.CUDA and "empty_kernel" in e.name]
    if not events:
        return [len(pads), 0]
    first = min(e.time_range.start for e in events)
    return [sum(t < first for t in pads), sum(t >= first for t in pads)]


def busy_us(events) -> float:
    """Microseconds in which at least one of ``events`` ran on the card: the
    union of their intervals (kernels of one stream overlap only where one
    is launched as another's programmatic dependent, as flash attention's
    dq kernel is beside dk/dv)."""
    total, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in events):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def profile_run(torch, fn) -> dict:
    """One traced run: device time (the union of the kernel and copy events
    on the card) over the wall time, and the six
    event names that took the most device time, as [name, count, ms]. The
    wall time includes the profiler's own host cost, so the busy share is a
    lower bound. The window opens and closes with PROFILE_PAD empty
    kernels (``pad_profiler``), which are not counted; ``pads_seen`` says
    how many of each batch the profiler kept."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pad_profiler(torch)
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
        pad_profiler(torch)
    events = device_events(prof)
    device_us = busy_us(events)
    names: dict[str, list] = {}
    for e in events:
        entry = names.setdefault(e.name[:60], [0, 0.0])
        entry[0] += 1
        entry[1] += e.time_range.elapsed_us() / 1e3
    top = sorted(([n, c, ms] for n, (c, ms) in names.items()),
                 key=lambda t: -t[2])[:6]
    own = {}
    for kernel, names in OWN_KERNELS.items():
        mine = [e for e in events if any(n in e.name for n in names)]
        if mine:
            us = busy_us(mine)
            own[kernel] = {"launches": len(mine), "device_us": us,
                           "share": us / device_us}
    return {"wall_ms": wall_us / 1e3, "device_ms": device_us / 1e3,
            "busy_share": device_us / wall_us if events else None,
            "device_events": len(events), "top_events": top,
            "own_kernels": own, "pads_seen": pads_seen(prof, events)}


# wrapper -> the names of its device kernels
OWN_KERNELS = {"gather_rows": ("gather_rows_kernel",),
               "fused_gather_lstm_cell": ("fused_gather_lstm_cell_kernel",),
               "fused_lstm_cell": ("fused_lstm_cell_kernel",),
               "flash_attention": ("flash_attention_kernel",),
               "flash_attention_bf16": ("flash_attention_bf16_kernel",),
               # the backward's three kernels together (dq overlaps
               # dk/dv), then apart; the bf16 backward's together
               "flash_attention_backward": ("flash_attention_bwd_rowdot",
                                            "flash_attention_bwd_dkdv",
                                            "flash_attention_bwd_dq"),
               "flash_attention_bwd_rowdot": ("flash_attention_bwd_rowdot",),
               "flash_attention_bwd_dkdv": ("flash_attention_bwd_dkdv",),
               "flash_attention_bwd_dq": ("flash_attention_bwd_dq",),
               "flash_attention_backward_bf16": ("flash_attention_bwd_bf16_",),
               "ssd_scan": ("ssd_scan_kernel",),
               "ssd_scan_bf16": ("ssd_scan_bf16_kernel",),
               "ssd_scan_backward": ("ssd_bwd_state", "ssd_bwd_cb",
                                     "ssd_bwd_chunk", "ssd_bwd_sum"),
               "ssd_scan_backward_bf16": ("ssd_bwd_bf16_",),
               "gather_rows_backward": ("gather_bwd_",)}


# "per_topology" captures each topology's plan as a CUDA graph and replays
# it, "per_topology_eager" runs the same plan eagerly (capture=False)
EXECUTORS = ("interpreted", "per_topology", "per_topology_eager",
             "bucketed")
REPLAY_TOL = 1e-6     # a replayed plan against the same plan run eagerly


def run_slice(device: str, name: str = "BiLSTM-Tagger",
              model_size: int = MODEL_SIZE, batch: int = BATCH,
              n_fresh: int = N_FRESH, repeat: bool = True,
              executors: tuple[str, ...] = EXECUTORS, timed_reps: int = 5,
              graph_args: dict | None = None, rl_iters: int = 600,
              float64_reference: bool = False) -> dict:
    """The port's batched-execution path, as a user drives it: learn an
    FSM on small graphs of workload ``name``, then run minibatches of
    ``batch`` instances (drawn with ``graph_args``, the workload's own
    defaults if None; ``n_fresh`` topologies, then a repeat of the first)
    through ``executors`` and check that they agree. The first minibatch
    must also match the interpreted run of the same seed's workload on the
    CPU, where every kernel is its plain version.

    ``float64_reference`` is for a workload whose float32 result is not
    resolved to 1e-4 (MV-RNN at width 512). Its card and CPU runs are then
    held to each other in float64 (within 1e-9), and the card's float32
    run to the float64 result at least half as closely as the CPU's own
    float32 run, in place of the float32 card-vs-CPU bar."""
    import torch
    from repro_torch.core.batching import resolve_schedule
    from repro_torch.core.executor import DynamicExecutor, ExecStats
    from repro_torch.core.plan import BucketedPlanExecutor, PlanExecutor
    from repro_torch.core.rl import RLConfig, train_fsm
    from repro_torch.models.workloads import make_workload

    dev = torch.device(device)
    graph_args = graph_args or {}
    rng = random.Random(SEED)
    t0 = time.perf_counter()
    wl = make_workload(name, model_size, SEED, device=device)
    report = {"workload": name, "init_s": time.perf_counter() - t0}
    n_classes = wl.impls["O"].out_fields["y"][0]
    t0 = time.perf_counter()
    fsm = train_fsm([wl.sample_graph(rng, 2) for _ in range(3)],
                    RLConfig(max_iters=rl_iters, seed=SEED))
    report.update(rl_s=time.perf_counter() - t0, rl_iters=fsm.iters)
    policy = fsm.policy
    make = {
        "interpreted": lambda: DynamicExecutor(wl.impls, None, device=device),
        "per_topology": lambda: PlanExecutor(wl.impls, None, donate=True,
                                             device=device),
        "per_topology_eager": lambda: PlanExecutor(
            wl.impls, None, donate=True, device=device, capture=False),
        "bucketed": lambda: BucketedPlanExecutor(wl.impls, None,
                                                 device=device),
    }
    execs = {k: make[k]() for k in executors}
    stats = {k: ExecStats() for k in executors}
    graphs = [wl.sample_graph(rng, batch, **graph_args)
              for _ in range(n_fresh)]
    if repeat:
        graphs.append(graphs[0])                 # one repeat topology
    worst = replay_worst = 0.0
    for gi, g in enumerate(graphs):
        ys = {}
        for ename, ex in execs.items():
            y, n_y = y_logits(ex.run(g, policy, stats[ename]))
            if tuple(y.shape) != (n_y, n_classes) or \
                    not torch.isfinite(y).all():
                fail(f"{name} {ename} on minibatch {gi}: bad y "
                     f"{tuple(y.shape)}")
            ys[ename] = y
        for ename in executors[1:]:
            err = float((ys[ename] - ys[executors[0]]).abs().max())
            worst = max(worst, err)
            if not err <= 1e-4:
                fail(f"{name} {ename} vs {executors[0]} on minibatch {gi}: "
                     f"max abs err {err} > 1e-4")
        if {"per_topology", "per_topology_eager"} <= set(executors):
            err = float((ys["per_topology"]
                         - ys["per_topology_eager"]).abs().max())
            replay_worst = max(replay_worst, err)
            if not err <= REPLAY_TOL:
                fail(f"{name} per-topology replay vs its eager run on "
                     f"minibatch {gi}: max abs err {err} > {REPLAY_TOL}")
        if gi == 0:
            cpu_wl = make_workload(name, model_size, SEED, device="cpu")
            y_ref, _ = y_logits(DynamicExecutor(
                cpu_wl.impls, None, device="cpu").run(g, policy))
            errs = {k: float((y - y_ref).abs().max()) for k, y in ys.items()}
            report.update(max_abs_err_vs_cpu=errs[executors[0]],
                          max_abs_err_any_vs_cpu=max(errs.values()))
            if not float64_reference and not max(errs.values()) <= 1e-4:
                fail(f"{name} on {device} vs the CPU plain run: max abs err "
                     f"{errs}")
            y_first, y_cpu = ys, y_ref
        log(f"{name} minibatch {gi}: {len(g)} nodes, executors agree "
            f"(max abs err {worst:.3e})")
    report["max_abs_err_executors"] = worst
    if "per_topology_eager" in execs:
        report["max_abs_err_replay_vs_eager"] = replay_worst
    report["lower_s"] = {k: st.lower_time for k, st in stats.items()}

    g = graphs[0]
    report["ms_per_run"] = {ename: timed(dev, lambda: ex.run(g, policy),
                                         timed_reps)
                            for ename, ex in execs.items()}
    if dev.type == "cuda":
        report["profile"] = {
            ename: profile_run(torch, lambda: ex.run(g, policy))
            for ename, ex in execs.items()}
    report["graph_nodes"] = len(g)
    report["n_batches"] = len(resolve_schedule(g, policy))
    report["batch_lower_bound"] = g.batch_lower_bound()
    if "per_topology" in execs:
        plan = execs["per_topology"].plan_for(g, policy)
        report["plan_stats"] = plan.stats.as_dict()
        if dev.type == "cuda":
            report["per_topology_replay"] = check_plan_replay(
                name, execs["per_topology"], g, policy)
    if "bucketed" in execs:
        report["bucketed_stats"] = (execs["bucketed"].pack_for(g, policy)
                                    .stats.as_dict())
        report["bucket_compiles"] = execs["bucketed"].n_bucket_compiles
    if float64_reference:
        report["float64"] = check_float64(wl, cpu_wl, g, policy, execs,
                                          y_first, y_cpu)
    return report


def check_plan_replay(name: str, ex, g, policy) -> dict:
    """One more run of the captured per-topology plan on ``g``: it must be
    one counted launch and one graph replay, and move the kernels'
    counters by exactly the launches its capture counted."""
    from repro_torch.core.executor import ExecStats
    from repro_torch.kernels import launches

    plan = ex.plan_for(g, policy)
    entry = plan._exes.peek(plan.executable_key(None))
    if entry is None or entry.graph is None:
        fail(f"{name}: the per-topology plan was not captured")
    st, replays = ExecStats(), ex.n_replays
    before = launches.snapshot()
    ex.run(g, policy, st)
    moved = launches.delta(before, launches.snapshot())
    if (st.n_launches, ex.n_replays - replays) != (1, 1):
        fail(f"{name}: a per-topology run was {st.n_launches} launches and "
             f"{ex.n_replays - replays} replays, not one of each")
    if moved != entry.counts:
        fail(f"{name}: a replay moved the launch counters by {moved}, its "
             f"capture counted {entry.counts}")
    return {"captures": ex.n_captures, "replays": ex.n_replays,
            "launches_per_replay": {k: v for k, v in moved.items()
                                    if k != "gather_shapes" and v}}


def to_float64(wl) -> None:
    """Cast a tree workload's parameters to float64 in place, for a
    reference run: its floats all live in ``impl.params``, and its cells
    (``wl.cells``) then keep their state in float64."""
    import torch

    for impl in wl.impls.values():
        for k, t in impl.params.items():
            impl.params[k] = t.double()
    for cell in wl.cells.values():
        cell.dtype = torch.float64


def check_float64(wl, cpu_wl, g, policy, execs, ys, y_cpu) -> dict:
    """The first minibatch again in float64, on the card through every
    executor and on the CPU: the card must match the CPU within 1e-9, and
    the card's float32 logits ``ys`` must be no farther from the float64
    result than twice the CPU's float32 logits ``y_cpu`` are."""
    import torch
    from repro_torch.core.executor import DynamicExecutor

    to_float64(wl)
    to_float64(cpu_wl)
    y64, _ = y_logits(DynamicExecutor(cpu_wl.impls, None,
                                      device="cpu").run(g, policy))
    out = {"cpu32_vs_64": float((y_cpu - y64).abs().max())}
    for ename, ex in execs.items():
        res = ex.run(g, policy)
        arenas = res.bufs if hasattr(res, "bufs") else res.arenas
        if any(t.dtype != torch.float64 for t in arenas.values()):
            fail(f"{wl.name} {ename}: the float64 run kept a float32 buffer")
        y, _ = y_logits(res)
        out[f"{ename}64_vs_cpu64"] = float((y - y64).abs().max())
        out[f"{ename}32_vs_64"] = float((ys[ename] - y64).abs().max())
        if not out[f"{ename}64_vs_cpu64"] <= 1e-9:
            fail(f"{wl.name} {ename} in float64 vs the CPU: {out}")
        if not out[f"{ename}32_vs_64"] <= 2 * out["cpu32_vs_64"]:
            fail(f"{wl.name} {ename}: float32 on the card is farther from "
                 f"float64 than twice the CPU's float32: {out}")
    log(f"{wl.name} float64 reference: {out}")
    return out


# -- phase 4 --------------------------------------------------------------


# Full published width and depth; random weights from the seed.
LM_RUNS = {  # name: (prompt lengths to draw from, requests, max_new, cache)
    "qwen2-0.5b": ((32, 48, 96), 6, 8, 256),
    "mamba2-130m": ((128, 256), 6, 8, 256),
    "granite-moe-1b-a400m": ((32, 48, 96), 6, 8, 256),
    "olmoe-1b-7b": ((32, 48, 96), 6, 8, 256),
}
# Models whose weights are made on the card (from a CUDA generator): the
# CPU holds them at this many pattern repeats, and the card's wave and
# prefill are held to the CPU's at that depth (the full depth's tokens to
# the eager engine's).
LM_CPU_REPEATS = {"olmoe-1b-7b": 2}
LOGIT_TOL = 2e-3    # prefill vs forward bar of the reference's own tests
# The models whose wave also runs in bf16 (the fp32 wave's weights rounded
# once), with the kernels each must launch; the card's bf16 prefill logits
# are held to the CPU's at BF16_CPU_REPEATS repeats on the bf16 bar.
BF16_WAVES = {"qwen2-0.5b": ("flash_attention_bf16",),
              "mamba2-130m": ("ssd_scan_bf16",),
              "granite-moe-1b-a400m": ("flash_attention_bf16", "gather_rows"),
              "olmoe-1b-7b": ("flash_attention_bf16", "gather_rows")}
BF16_CPU_REPEATS = 2


def top2_margin(torch, model, params, prompt, prefix) -> tuple:
    """(top-1 minus top-2 logit, largest |logit|) of the step that follows
    ``prompt + prefix``, from a full forward pass."""
    toks = torch.tensor([list(prompt) + list(prefix)], device=model.device)
    with torch.no_grad():
        logits = model.forward(params, toks)[0][0, -1]
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1]), float(logits.abs().max())


def token_flips(torch, label: str, name: str, got: list, want: list,
                model, params, prompts, routing: dict | None = None) -> list:
    """Where two runs' token streams differ: each first differing token
    must be a near-tie of ``model`` (top-2 margin within the logit
    tolerance of the largest |logit|), or, for an MoE model, follow a
    routing that differs between the runs first at a near-tie
    (``routing``, from :func:`routing_divergence`: top-K gap within
    ROUTING_TIE); returns [request, token, margin] for each."""
    flips = []
    for r, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        t = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        margin, scale = top2_margin(torch, model, params, prompts[r], b[:t])
        log(f"{name} request {r}: token {t} is {a[t]} {label}, {b[t]} in "
            f"the reference run; top-2 margin {margin:.3e} (tolerance "
            f"{LOGIT_TOL * scale:.3e})")
        if margin > LOGIT_TOL * scale:
            if not routing_tie(routing):
                fail(f"{name}: request {r} differs {label} at token {t} "
                     f"beyond a near-tie (routing {routing})")
            log(f"{name} request {r}: accepted at a routing near-tie: MoE "
                f"call {routing['first_differing_call']} routes "
                f"{routing['tokens_differing']} tokens differently at "
                f"{routing_gap(routing)}")
        flips.append([r, t, margin])
    return flips


def wave_peak_gib(torch, fn) -> float:
    """Peak device memory allocated while ``fn`` runs, in GiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**30


def bf16_wave(name: str, wrappers: dict, cfg, p16, prompts: list,
              fp32_outs: list, fp32_logits, by_len: dict, cache_len: int,
              max_new: int) -> dict:
    """The wave of :func:`lm_wave` again in bf16 at full width and depth:
    the fp32 wave's weights rounded once to bf16 (``p16``, on the card;
    the fp32 ones freed, so that the peak memory compares), the same six
    requests through a captured engine (the counted
    first wave, a replayed repeat) and an eager one, whose tokens must be
    bit-equal; tok/s, prefill and decode-step ms and peak memory as for
    fp32. At BF16_CPU_REPEATS repeats one prefill batch's logits on the
    card are held to the CPU's on the bf16 bar (:func:`bf16_bar`: within
    twice the CPU's plain bf16 model's error against the fp32 plain model
    on the same bf16 weights). At full depth the bf16 tokens' agreement
    with the fp32 wave and the largest prefill logit gap are reported,
    not held (``fp32_logits``: the fp32 model's logits of that batch). An
    MoE model's logits beyond the bar pass only at a bf16 routing tie
    (:func:`routing_tie`), and its first wave's gather shapes are
    reported (bf16 rows)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.arch.model import TransformerLM, tree_map
    from repro_torch.core.device import block
    from repro_torch.kernels.gather_batch import gather_rows
    from repro_torch.serve.lm_wave import ServeEngine, ServeStats

    dev = torch.device("cuda")
    model = TransformerLM(cfg, torch.bfloat16, device=dev)
    engines = {"captured": ServeEngine(model, p16, cache_len=cache_len,
                                       device=dev),
               "eager": ServeEngine(model, p16, cache_len=cache_len,
                                    device=dev, capture=False)}
    eng = engines["captured"]
    for fn in wrappers.values():
        fn.launches = 0
    gather_rows.shapes.clear()
    stats = ServeStats()
    outs, _ = eng.generate(prompts, max_new=max_new, stats=stats)
    block(dev)
    report = {"launches": {k: fn.launches for k, fn in wrappers.items()},
              "gather_shapes": shape_histogram(gather_rows.shapes),
              "first_wave_graphs": [stats.n_captures, stats.n_replays]}
    if any(len(o) != max_new for o in outs):
        fail(f"{name} bf16: a request did not get {max_new} tokens")
    for mode, e in engines.items():
        warm = ServeStats()
        box = {}
        peak = wave_peak_gib(torch, lambda: box.update(out=e.generate(
            prompts, max_new=max_new, stats=warm)[0]))
        if box["out"] != outs:
            fail(f"{name} bf16: the {mode} repeat wave's tokens differ from "
                 f"the captured first wave's")
        if mode == "captured" and (warm.n_captures, warm.n_replays) != \
                (0, warm.n_batches):
            fail(f"{name} bf16: the repeat wave captured {warm.n_captures} "
                 f"and replayed {warm.n_replays} of {warm.n_batches} steps")
        scratch = ServeStats()
        with torch.no_grad():
            prefill_ms = {}
            for L_, group in sorted(by_len.items()):
                toks = np.asarray(group, np.int64)
                prefill_ms[f"L={L_} B={len(group)}"] = timed(
                    dev, lambda: e._prefill(len(group), L_).run(scratch, toks))
            tok = np.zeros(len(prompts), np.int64)
            pos = np.full(len(prompts), 100, np.int64)
            decode_ms = timed(dev, lambda: e._decode(len(prompts)).run(
                scratch, tok, pos))
        report[mode] = {"tok_per_s": warm.tok_per_s,
                        "wave_ms": warm.wall_s * 1e3,
                        "n_batches": warm.n_batches,
                        "prefill_ms": prefill_ms,
                        "decode_wave_ms": decode_ms, "peak_gib": peak}

    # full depth: against the fp32 wave, reported
    same = sum(a == b for o16, o32 in zip(outs, fp32_outs)
               for a, b in zip(o16, o32))
    first = [next((i for i, (a, b) in enumerate(zip(o16, o32)) if a != b),
                  None) for o16, o32 in zip(outs, fp32_outs)]
    group = by_len[len(prompts[0])]
    with torch.no_grad():
        lg16 = model.prefill(p16, torch.tensor(group, device=dev),
                             cache_len=cache_len)[0].float()
    report["vs_fp32"] = {
        "tokens_equal": same, "tokens": len(prompts) * max_new,
        "first_differing_token": first,
        "max_prefill_logit_gap": float((lg16 - fp32_logits).abs().max()),
        "max_abs_logit": float(fp32_logits.abs().max())}

    # at BF16_CPU_REPEATS repeats: the card against the CPU on the bf16 bar
    cut = dataclasses.replace(cfg, n_layers=BF16_CPU_REPEATS
                              * len(cfg.pattern))
    cut16 = cut_params(p16, BF16_CPU_REPEATS)
    cpu16 = tree_map(lambda t: t.cpu(), cut16)
    toks = torch.tensor(group)
    with torch.no_grad():
        with RoutingRecorder() as card_rec:
            card = TransformerLM(cut, torch.bfloat16, device=dev).prefill(
                cut16, toks.to(dev), cache_len=cache_len)[0].cpu()
        with RoutingRecorder() as cpu_rec:
            plain = TransformerLM(cut, torch.bfloat16, device="cpu").prefill(
                cpu16, toks, cache_len=cache_len)[0]
        truth = TransformerLM(cut, device="cpu").prefill(
            tree_map(lambda t: t.float(), cpu16), toks,
            cache_len=cache_len)[0]
    if tuple(card.shape) != (len(group), cfg.vocab) or \
            not torch.isfinite(card.float()).all():
        fail(f"{name} bf16: bad prefill logits {tuple(card.shape)}")
    report["routing_vs_cpu"] = routing = routing_divergence(card_rec,
                                                            cpu_rec)
    report["prefill_vs_cpu"] = bf16_bar(
        f"{name} bf16 prefill logits at {BF16_CPU_REPEATS} repeats", card,
        plain, truth, kernel=False, routing=routing)
    report["cpu_repeats"] = BF16_CPU_REPEATS
    return report


def lm_wave(name: str, wrappers: dict) -> dict:
    """One LM at full width through the port's wave server on the card,
    its prefill and decode steps captured as CUDA graphs: one counted wave
    (the kernels' launch counts are read around it; it captures each
    program once), a timed repeat (every step a replay) and a profiled
    one; the same waves through an engine with ``capture=False``; then the
    same first wave on the CPU, where every kernel is its plain version,
    with the same weights. The captured engine's tokens must equal the
    eager engine's and the CPU's (a differing token is accepted only at a
    near-tie, top-2 margin within the logit tolerance), and one prefill
    batch's logits must agree with the CPU within 2e-3 of the largest
    |logit|."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.arch.model import TransformerLM, tree_map
    from repro_torch.configs import get_config
    from repro_torch.core.device import block
    from repro_torch.serve.lm_wave import ServeEngine, ServeStats

    lengths, n_req, max_new, cache_len = LM_RUNS[name]
    cfg = get_config(name)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = TransformerLM(cfg, device=dev)
    repeats = LM_CPU_REPEATS.get(name)
    if repeats is None:
        cpu_model = TransformerLM(cfg, device="cpu")
        cpu_params = cpu_model.init_params(
            torch.Generator().manual_seed(SEED))
        params = tree_map(lambda t: t.to(dev), cpu_params)
        cmp_model, cmp_params = model, params
    else:
        params = model.init_params(
            torch.Generator(device=dev).manual_seed(SEED))
        cut = dataclasses.replace(cfg, n_layers=repeats * len(cfg.pattern))
        cmp_model = TransformerLM(cut, device=dev)
        cmp_params = cut_params(params, repeats)
        cpu_model = TransformerLM(cut, device="cpu")
        cpu_params = tree_map(lambda t: t.cpu(), cmp_params)
    sizes = []
    tree_map(lambda t: sizes.append(t.numel()), params)
    report = {"model": name, "n_layers": cfg.n_layers,
              "d_model": cfg.d_model, "n_params": sum(sizes),
              "init_s": time.perf_counter() - t0}
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, int(rng.choice(lengths))).tolist()
               for _ in range(n_req)]
    report["prompt_lengths"] = [len(p) for p in prompts]

    engines = {"captured": ServeEngine(model, params, cache_len=cache_len,
                                       device=dev),
               "eager": ServeEngine(model, params, cache_len=cache_len,
                                    device=dev, capture=False)}
    eng = engines["captured"]
    for fn in wrappers.values():
        fn.launches = 0
    stats = ServeStats()
    outs, _ = eng.generate(prompts, max_new=max_new, stats=stats)
    block(dev)
    report["launches"] = {k: fn.launches for k, fn in wrappers.items()}
    report["first_wave_s"] = stats.wall_s
    report["first_wave_graphs"] = [stats.n_captures, stats.n_replays]
    if any(len(o) != max_new for o in outs):
        fail(f"{name}: a request did not get {max_new} tokens")
    if stats.n_captures != stats.n_prefill_batches + 1:
        fail(f"{name}: the first wave captured {stats.n_captures} graphs, "
             f"not one a prefill length and one decode step")

    by_mode = {}
    for mode, e in engines.items():
        warm = ServeStats()
        box = {}
        peak = wave_peak_gib(torch, lambda: box.update(again=e.generate(
            prompts, max_new=max_new, stats=warm)[0]))
        again = box["again"]
        if mode == "captured" and again != outs:
            fail(f"{name}: a replayed repeat of the wave gave other tokens")
        if mode == "captured" and (warm.n_captures, warm.n_replays) != \
                (0, warm.n_batches):
            fail(f"{name}: the repeat wave captured {warm.n_captures} and "
                 f"replayed {warm.n_replays} of {warm.n_batches} steps")
        by_mode[mode] = {"outs": again, "tok_per_s": warm.tok_per_s,
                         "wave_ms": warm.wall_s * 1e3,
                         "n_batches": warm.n_batches,
                         "n_prefill_batches": warm.n_prefill_batches,
                         "n_decode_batches": warm.n_decode_batches,
                         "sched_cache_hits": warm.sched_cache_hits,
                         "peak_gib": peak}
    report["replay_vs_eager_flips"] = token_flips(
        torch, "replayed", name, outs, by_mode["eager"].pop("outs"),
        *((cpu_model, cpu_params) if repeats is None else (model, params)),
        prompts)
    by_mode["captured"].pop("outs")
    report.update(by_mode["captured"])
    report["eager"] = by_mode["eager"]

    # ms per prefill batch (each length bucket) and per decode wave: one
    # replay of the engine's program, and the same step run eagerly
    by_len: dict[int, list] = {}
    for p in prompts:
        by_len.setdefault(len(p), []).append(p)
    scratch = ServeStats()
    with torch.no_grad():
        prefill_ms, eager_prefill_ms = {}, {}
        for L_, group in sorted(by_len.items()):
            toks = np.asarray(group, np.int64)
            key = f"L={L_} B={len(group)}"
            prefill_ms[key] = timed(dev, lambda: eng._prefill(
                len(group), L_).run(scratch, toks))
            eager_prefill_ms[key] = timed(dev, lambda: engines["eager"]
                                          ._prefill(len(group), L_)
                                          .run(scratch, toks))
        tok = np.zeros(n_req, np.int64)
        pos = np.full(n_req, 100, np.int64)
        decode_ms = timed(dev, lambda: eng._decode(n_req).run(scratch, tok,
                                                              pos))
        eager_decode_ms = timed(dev, lambda: engines["eager"]._decode(
            n_req).run(scratch, tok, pos))
    report.update(prefill_ms=prefill_ms, decode_wave_ms=decode_ms)
    report["eager"].update(prefill_ms=eager_prefill_ms,
                           decode_wave_ms=eager_decode_ms)
    report["profile"] = profile_run(
        torch, lambda: eng.generate(prompts, max_new=max_new))
    report["eager"]["profile"] = profile_run(
        torch, lambda: engines["eager"].generate(prompts, max_new=max_new))

    # the same first wave on the CPU, plain versions only (at the CPU's
    # depth; the card's wave at that depth beside it where it is cut), an
    # eager card wave beside it recording the MoE layers' routing
    if repeats is None:
        cmp_outs = outs
    else:
        cmp_outs, _ = ServeEngine(cmp_model, cmp_params, cache_len=cache_len,
                                  device=dev).generate(prompts,
                                                       max_new=max_new)
    with RoutingRecorder() as card_rec:
        eager_outs, _ = ServeEngine(cmp_model, cmp_params,
                                    cache_len=cache_len, device=dev,
                                    capture=False).generate(
                                        prompts, max_new=max_new)
    if eager_outs != cmp_outs:
        fail(f"{name}: an eager wave gave other tokens than the captured")
    t0 = time.perf_counter()
    with RoutingRecorder() as cpu_rec:
        cpu_outs, cpu_stats = ServeEngine(cpu_model, cpu_params,
                                          cache_len=cache_len, device="cpu"
                                          ).generate(prompts, max_new=max_new)
    report["cpu_wave_s"] = time.perf_counter() - t0
    report["cpu_repeats"] = cpu_model.cfg.n_repeats
    routing = routing_divergence(card_rec, cpu_rec)
    report["routing_vs_cpu"] = routing
    if (cpu_stats.n_prefill_batches, cpu_stats.n_decode_batches) != \
            (stats.n_prefill_batches, stats.n_decode_batches):
        fail(f"{name}: batch counts differ from the CPU run")
    flips = token_flips(torch, "on the card", name, cmp_outs, cpu_outs,
                        cpu_model, cpu_params, prompts, routing)
    report["near_tie_flips"] = flips

    group = by_len[len(prompts[0])]
    with torch.no_grad():
        with RoutingRecorder() as card_rec:
            lg = cmp_model.prefill(cmp_params, torch.tensor(group, device=dev),
                                   cache_len=cache_len)[0].cpu()
        with RoutingRecorder() as cpu_rec:
            lg_cpu = cpu_model.prefill(cpu_params, torch.tensor(group),
                                       cache_len=cache_len)[0]
    if tuple(lg.shape) != (len(group), cfg.vocab) or \
            not torch.isfinite(lg).all():
        fail(f"{name}: bad prefill logits {tuple(lg.shape)}")
    err = rel_err(lg, lg_cpu)
    report["prefill_logits_rel_err_vs_cpu"] = err
    report["prefill_routing_vs_cpu"] = prefill_routing = routing_divergence(
        card_rec, cpu_rec)
    if not err <= LOGIT_TOL:
        if not routing_tie(prefill_routing):
            fail(f"{name}: prefill logits differ from the CPU run by {err} "
                 f"of the largest |logit| (routing {prefill_routing})")
        log(f"{name}: prefill logits {err:.3e} of the largest |logit| from "
            f"the CPU's, accepted at a routing near-tie: "
            f"{routing_gap(prefill_routing)}")
    report["tokens_equal_cpu"] = not flips
    report["tokens_equal_eager"] = not report["replay_vs_eager_flips"]
    if name in BF16_WAVES:
        group = by_len[len(prompts[0])]
        with torch.no_grad():
            lg32 = model.prefill(params, torch.tensor(group, device=dev),
                                 cache_len=cache_len)[0]
        p16 = tree_map(lambda t: t.to(torch.bfloat16), params)
        # the fp32 model's weights, engines and graphs go first
        del engines, eng, e, params, cmp_params
        gc.collect()
        torch.cuda.empty_cache()
        report["bf16"] = bf16_wave(name, wrappers, cfg, p16, prompts, outs,
                                   lg32, by_len, cache_len, max_new)
    return report


# -- phase 5 --------------------------------------------------------------


# Workload: RL iterations (the reference's own tests: 600 for trees, 800 for
# lattices) and the run. The serve families' defaults take the tagger's
# full run; the other four one minibatch through two executors. Graphs are
# the workloads' own: 6-18 leaves per tree, 10-26 characters per lattice.
# MV-RNN's float32 logits are not resolved to 1e-4 at width 512: each node
# multiplies two 512 x 512 matrices into its children's, up to 17 levels
# deep, and the CPU's own float32 run differs from float64 by about 2e-4;
# so it is held to a float64 reference (see ``run_slice``).
FULL = dict(n_fresh=2, repeat=True, executors=EXECUTORS, timed_reps=3)
SHORT = dict(n_fresh=1, repeat=False, executors=("interpreted", "bucketed"),
             timed_reps=3)
TREES_LATTICES = {
    "TreeLSTM": (600, FULL), "LatticeLSTM": (800, FULL),
    "TreeGRU": (600, SHORT), "MV-RNN": (600, dict(SHORT,
                                                  float64_reference=True)),
    "TreeLSTM-2Type": (600, SHORT), "LatticeGRU": (800, SHORT),
}


def shape_histogram(shapes) -> list:
    """A gather's ``(K, row bytes)`` (or its backward's ``(K, n_src, row
    bytes)``) launch counts, most frequent first."""
    return [[*shape, n] for shape, n in
            sorted(shapes.items(), key=lambda t: (-t[1], t[0]))]


# -- phase 6 --------------------------------------------------------------


# The serve engine's traces: name -> (families, requests, rate, max_new,
# max_slots, further synth_trace arguments). "mixed" is the serve
# launcher's defaults (src/repro/launch/serve.py), "lm" the LM trace of
# benchmarks/bench_serve.py; graph sizes are synth_trace's own.
SERVE_TRACES = {
    "mixed": (["lm", "tree", "lattice"], 24, 4.0, 12, 16, {}),
    "lm": (["lm"], 32, 4.0, 20, 32, dict(prompt_lo=5, prompt_hi=8)),
}
# The card's runs: the default engine (bucketed, each bucket signature
# captured once as a CUDA graph and replayed, pipelined rounds), the same
# engine with every bucket run eagerly, and the interpreted engine.
SERVE_MODES = {"replayed": {}, "eager": dict(capture=False),
               "interpreted": dict(compiled=False)}
SERVE_RL = {"lm": 600, "tree": 600, "lattice": 800}   # RL iterations


def serve_workloads(device) -> dict:
    from repro_torch.models.workloads import SERVE_FAMILIES, make_workload

    return {fam: make_workload(name, MODEL_SIZE, SEED, device=device)
            for fam, name in SERVE_FAMILIES.items()}


def serve_policies(wls) -> dict:
    """An FSM per family, learned as phase 5 learns one (three 2-instance
    graphs of the family's workload)."""
    from repro_torch.core.rl import RLConfig, train_fsm

    out = {}
    for fam, iters in SERVE_RL.items():
        rng = random.Random(SEED)
        out[fam] = train_fsm([wls[fam].sample_graph(rng, 2) for _ in range(3)],
                             RLConfig(max_iters=iters, seed=SEED)).policy
    return out


SERVE_PASSES = ("first", "steady", "profiled", "traced")
# The engine's host spans, summed over a traced pass (each inclusive of
# the spans inside it).
SERVE_SPANS = ("serve.round", "round.schedule", "round.feed_stage",
               "round.pack", "plan.pack", "plan.h2d", "plan.dispatch",
               "plan.block", "round.scatter", "round.feed", "round.single",
               "interp.exec")


def serve_passes(torch, wls, policies, trace: str, caches: dict,
                 drive=None, passes=SERVE_PASSES, **kw) -> dict:
    """``trace`` once for each of ``passes`` through one engine on the
    workloads' device, each pass's arrivals after the previous pass's end:
    a first pass that lowers, builds and captures; a steady pass with
    every cache warm (run under ``drive`` if given, for the kernels'
    launch counts; one engine keeps one slot pool, so it replays the
    graphs the first captured); a profiled pass; and a pass with the
    engine's tracer on. Per pass: the requests, the deltas of the engine's
    stats and its rounds' seconds (``serve.round_s``); the profiled pass's
    profile and the launch counts' deltas over it (``counted``); the
    traced pass's ms per round in each of ``SERVE_SPANS``."""
    import torch
    from repro_torch.kernels import launches as launch_counts
    from repro_torch.obs import Obs, Tracer
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.serve import ServeEngine, synth_trace

    fams, n, rate, max_new, slots, args = SERVE_TRACES[trace]
    device = wls["lm"].device
    metrics = MetricsRegistry()
    rounds_s = metrics.histogram("serve.round_s")
    tracer = Tracer(enabled=False)
    eng = ServeEngine(dict(wls), policies=policies, max_slots=slots,
                      obs=Obs(metrics=metrics, tracer=tracer), device=device,
                      **caches, **kw)
    fields = ("tokens_out", "n_rounds", "wall_s", "lower_s",
              "n_graph_captures", "n_graph_replays", "n_contained_errors",
              "n_quarantine_events", "n_sharded_dispatches",
              "n_shard_fallback_rounds")
    out = {}
    for name in passes:
        reqs = synth_trace(fams, n, rate, max_new, wls, SEED, **args)
        for r in reqs:
            r.arrival += eng._now
        before = {f: getattr(eng.stats, f) for f in fields}
        tiers = dict(eng.stats.tier_rounds)
        n_rounds = rounds_s.count
        build_s = sum(getattr(ex, "compile_time_s", 0.0)
                      for ex in eng._executors.values())
        eng.submit_many(reqs)
        run = {"reqs": reqs}
        if name == "steady" and drive is not None:
            _, run["launches"] = drive(eng.run)
        elif name == "profiled":
            counted = launch_counts.snapshot()
            run["profile"] = profile_run(torch, eng.run)
            run["counted"] = launch_counts.delta(counted,
                                                 launch_counts.snapshot())
        elif name == "traced":
            tracer.clear()
            tracer.enabled = True
            eng.run()
            tracer.enabled = False
        else:
            eng.run()
        if device.type == "cuda":
            torch.cuda.synchronize()
        bad = [r.status for r in reqs if r.status != "COMPLETED"]
        if bad:
            fail(f"serve {trace} {kw} {name} pass: {len(bad)} requests "
                 f"ended {set(bad)}")
        run.update({f: getattr(eng.stats, f) - before[f] for f in fields})
        run["tier_rounds"] = {t: k - tiers.get(t, 0)
                              for t, k in eng.stats.tier_rounds.items()
                              if k > tiers.get(t, 0)}
        run["round_s"] = rounds_s.samples[n_rounds:]
        run["build_s"] = sum(getattr(ex, "compile_time_s", 0.0)
                             for ex in eng._executors.values()) - build_s
        run["tok_per_s"] = run["tokens_out"] / max(run["wall_s"], 1e-9)
        if name == "traced":
            run["span_ms_per_round"] = {
                span: sum(e["dur"] for e in tracer.spans(span)) / 1e3
                / max(run["n_rounds"], 1) for span in SERVE_SPANS
                if tracer.spans(span)}
        out[name] = run
    return out


def chainlm_margin(cpu_wl, req, t: int) -> tuple:
    """(top-1 minus top-2 logit, largest |logit|) of the CPU's logits for
    token ``t`` of lm request ``req``: its left-padded prompt and first
    ``t`` tokens fed through the cell from a zero state, as the engine
    feeds them."""
    from repro_torch.core.batching import SufficientConditionPolicy
    from repro_torch.core.executor import DynamicExecutor
    from repro_torch.core.graph import Graph, Node
    from repro_torch.serve.scheduler import bucket_len

    pad = bucket_len(len(req.prompt), 4) - len(req.prompt)
    nodes = [Node(id=0, type="S")]
    prev = 0
    for tok in [0] * pad + list(req.prompt) + list(req.out[:t]):
        nodes.append(Node(id=len(nodes), type="E", attrs={"aux": tok}))
        nodes.append(Node(id=len(nodes), type="C",
                          inputs=(prev, len(nodes) - 1)))
        prev = len(nodes) - 1
    nodes.append(Node(id=len(nodes), type="O", inputs=(prev,)))
    res = DynamicExecutor(cpu_wl.impls, None, device="cpu").run(
        Graph(nodes), SufficientConditionPolicy())
    logits = res.field("y", [len(nodes) - 1])[0]
    top = logits.topk(2).values
    return float(top[0] - top[1]), float(logits.abs().max())


def serve_agrees(label: str, got: list, want: list, cpu_wl) -> dict:
    """Hold a card run's requests to the CPU run's: lm tokens equal but
    for a flip at a near-tie (the CPU's top-2 margin within LOGIT_TOL of
    the largest |logit|), tree and lattice outputs within 1e-4."""
    flips, worst = [], 0.0
    for a, b in zip(got, want):
        if a.family != "lm":
            err = float(abs(a.result - b.result).max())
            worst = max(worst, err)
            if a.result.shape != b.result.shape or not err <= 1e-4:
                fail(f"serve {label}: {a.family} request {a.rid} differs "
                     f"from the CPU run by {err}")
            continue
        if a.out == b.out:
            continue
        t = next(i for i, (x, y) in enumerate(zip(a.out, b.out)) if x != y)
        margin, scale = chainlm_margin(cpu_wl, b, t)
        log(f"serve {label}: lm request {a.rid} token {t} is {a.out[t]} on "
            f"the card, {b.out[t]} on the CPU; CPU top-2 margin {margin:.3e} "
            f"(tolerance {LOGIT_TOL * scale:.3e})")
        if margin > LOGIT_TOL * scale:
            fail(f"serve {label}: lm request {a.rid} differs from the CPU "
                 f"run at token {t} beyond a near-tie")
        flips.append([a.rid, t, margin])
    return {"near_tie_flips": flips, "max_abs_err_vs_cpu": worst}


def serve_phase(torch, drive, card: str, policies: dict) -> dict:
    """Both traces through the card's three engines and the CPU's default
    engine (section 6 of the module docstring) with ``policies``; returns
    the launches of the row gather and the gather cell during the replayed
    engine's steady pass of each trace."""
    from repro_torch.core.cache import FIFOCache, LRUCache
    from repro_torch.obs.metrics import percentile

    wls = serve_workloads("cuda")
    cpu_wls = serve_workloads("cpu")
    launches = {}
    for trace in SERVE_TRACES:
        t_trace = time.perf_counter()
        cpu = serve_passes(torch, cpu_wls, policies, trace, {},
                           passes=("first",))["first"]
        want = cpu["reqs"]
        # packs and schedules are host artifacts the card's engines share
        host = dict(plan_cache=FIFOCache(256), schedule_cache=FIFOCache(512))
        lines = {}
        for mode, kw in SERVE_MODES.items():
            runs = serve_passes(torch, wls, policies, trace,
                                dict(host, bucket_cache=LRUCache(256)),
                                drive if mode == "replayed" else None, **kw)
            agree = {"near_tie_flips": [], "max_abs_err_vs_cpu": 0.0}
            for name, run in runs.items():
                a = serve_agrees(f"{trace} {mode} {name} pass", run["reqs"],
                                 want, cpu_wls["lm"])
                agree["near_tie_flips"] += [[name] + f
                                            for f in a["near_tie_flips"]]
                agree["max_abs_err_vs_cpu"] = max(
                    agree["max_abs_err_vs_cpu"], a["max_abs_err_vs_cpu"])
                if mode == "replayed" and (
                        run["n_contained_errors"]
                        or run["n_quarantine_events"]
                        or set(run["tier_rounds"]) - {"bucketed"}):
                    fail(f"serve {trace} replayed {name} pass: contained "
                         f"{run['n_contained_errors']}, quarantined "
                         f"{run['n_quarantine_events']}, tiers "
                         f"{run['tier_rounds']}")
            first, steady = runs["first"], runs["steady"]
            prof = runs["profiled"]["profile"]
            # The counters of a replayed run are bookkeeping (each replay
            # adds its capture's counts): hold them to the kernels the
            # profiler saw run on the card in the same pass.
            for kernel in ("gather_rows", "fused_gather_lstm_cell"):
                seen = prof["own_kernels"].get(kernel, {}).get("launches", 0)
                if runs["profiled"]["counted"][kernel] != seen:
                    fail(f"serve {trace} {mode} profiled pass: {kernel} "
                         f"counted {runs['profiled']['counted'][kernel]} "
                         f"launches, the profiler saw {seen}")
            rounds = steady["n_rounds"]
            line = {
                "tok_per_s": steady["tok_per_s"], "rounds": rounds,
                "ms_per_round_median": percentile(steady["round_s"], 50) * 1e3,
                "ms_per_round_p90": percentile(steady["round_s"], 90) * 1e3,
                "wall_ms": steady["wall_s"] * 1e3,
                "captures_first": first["n_graph_captures"],
                "replays_first": first["n_graph_replays"],
                "captures_steady": steady["n_graph_captures"],
                "replays_steady": steady["n_graph_replays"],
                "first_pass_ms": first["wall_s"] * 1e3,
                "first_pass_tok_per_s": first["tok_per_s"],
                "first_pass_lower_s": first["lower_s"],
                "first_pass_build_s": first["build_s"],
                "busy_share": prof["busy_share"],
                "device_events_per_round": (prof["device_events"]
                                            / runs["profiled"]["n_rounds"]),
                "device_ms_per_round": (prof["device_ms"]
                                        / runs["profiled"]["n_rounds"]),
                "top_events": prof["top_events"],
                "host_span_ms_per_round": runs["traced"]["span_ms_per_round"],
                "tier_rounds": steady["tier_rounds"],
                "requests": len(want), **agree}
            lines[mode] = line
            if mode == "replayed":
                launches[trace] = steady["launches"]
            log(f"serve {trace} {mode}: {line['tok_per_s']:.1f} tok/s, "
                f"{rounds} rounds, ms per round median "
                f"{line['ms_per_round_median']:.3f} p90 "
                f"{line['ms_per_round_p90']:.3f}, captures "
                f"{line['captures_first']} replays {line['replays_first']} "
                f"(first pass; steady {line['captures_steady']}, "
                f"{line['replays_steady']}), busy share "
                f"{line['busy_share']:.3f}, device events per round "
                f"{line['device_events_per_round']:.1f}; profiled pass "
                f"gathers and gather cells counted "
                f"{runs['profiled']['counted']['gather_rows']}, "
                f"{runs['profiled']['counted']['fused_gather_lstm_cell']}, "
                f"seen as many ({card})")
            log(f"serve {trace} {mode} host ms per round (traced pass): "
                + ", ".join(f"{k} {v:.3f}" for k, v in
                            line["host_span_ms_per_round"].items()))
            log(f"serve {trace} {mode} detail: "
                f"{json.dumps(line, default=str)}")
        rep = lines["replayed"]
        if not (rep["captures_first"] >= 1
                and rep["replays_first"] > rep["captures_first"]
                and rep["captures_steady"] == 0
                and rep["replays_steady"] > 0):
            fail(f"serve {trace}: captures and replays {rep}")
        for kernel in ("gather_rows", "fused_gather_lstm_cell"):
            if launches[trace][kernel] <= 0:
                fail(f"{kernel} was not launched during serve {trace}")
        eager = lines["eager"]
        log(f"serve {trace}: replayed beside eager, ms per round median "
            f"{rep['ms_per_round_median']:.3f} / "
            f"{eager['ms_per_round_median']:.3f}, tok/s "
            f"{rep['tok_per_s']:.1f} / {eager['tok_per_s']:.1f}, busy share "
            f"{rep['busy_share']:.3f} / {eager['busy_share']:.3f}, device "
            f"events per round {rep['device_events_per_round']:.1f} / "
            f"{eager['device_events_per_round']:.1f}; launches in the "
            f"replayed steady pass {launches[trace]}; CPU run "
            f"{cpu['wall_s']:.1f} s; "
            f"{time.perf_counter() - t_trace:.1f} s ({card})")
    return launches


# -- phase 7 --------------------------------------------------------------


# The launcher at its defaults (24 requests, 4 a round, 12 new tokens, 16
# slots, lm,tree,lattice, bucketed plans, async compile, pipelined rounds)
# at phase 6's width, with phase 6's FSMs through a policy registry.
LAUNCHER_DIR = ROOT / "build" / "chip_smoke"


def launcher_args(*extra: str) -> list[str]:
    return ["--model-size", str(MODEL_SIZE), "--seed", str(SEED),
            "--registry", str(LAUNCHER_DIR / "registry"), *extra]


def first_token_s(reqs, t0: float) -> float:
    """Seconds from ``t0`` to the first lm token of ``reqs``."""
    return min(r.t_first for r in reqs if r.family == "lm" and r.out) - t0


def launcher_passes(torch, launcher, argv: list[str], names=("first",),
                    wls=None) -> dict:
    """Build the engine as the launcher does for ``argv`` and run its trace
    once for each of ``names``, each pass's arrivals after the previous
    pass's end: "first" (cold caches: lowering, builds, captures), "steady"
    (every cache warm), "profiled" (steady, under the profiler, with the
    launch counts' deltas) and "profiled_first" (a first pass under the
    profiler). Per pass: the requests, deltas of the engine's stats, its
    rounds' seconds and the time to the first lm token."""
    from repro_torch.kernels import launches as launch_counts
    from repro_torch.obs.metrics import default_registry
    from repro_torch.serve import PolicyRegistry

    args = launcher.parse_args(argv)
    wls = wls if wls is not None else launcher.make_workloads(args)
    eng = launcher.make_engine(args, wls, PolicyRegistry(args.registry))
    rounds_s = default_registry().histogram("serve.round_s")
    fields = ("tokens_out", "n_rounds", "wall_s", "lower_s", "lower_bg_s",
              "compile_jobs_submitted", "compile_jobs_landed", "n_hotswaps",
              "n_graph_captures", "n_graph_replays", "n_contained_errors",
              "n_quarantine_events")
    out = {"engine": eng, "workloads": wls}
    for name in names:
        reqs = launcher.make_trace(args, wls)
        for r in reqs:
            r.arrival += eng._now
        before = {f: getattr(eng.stats, f) for f in fields}
        tiers = dict(eng.stats.tier_rounds)
        n_rounds = rounds_s.count
        eng.submit_many(reqs)
        run = {"reqs": reqs}
        t0 = time.perf_counter()
        if name.startswith("profiled"):
            counted = launch_counts.snapshot()
            run["profile"] = profile_run(torch, eng.run)
            run["counted"] = launch_counts.delta(counted,
                                                 launch_counts.snapshot())
        else:
            eng.run()
        if args.device == "cuda":
            torch.cuda.synchronize()
        bad = [r.status for r in reqs if r.status != "COMPLETED"]
        if bad:
            fail(f"launcher {argv} {name} pass: {len(bad)} requests ended "
                 f"{set(bad)}")
        run.update({f: getattr(eng.stats, f) - before[f] for f in fields})
        run["tier_rounds"] = {t: k - tiers.get(t, 0)
                              for t, k in eng.stats.tier_rounds.items()
                              if k > tiers.get(t, 0)}
        run["round_s"] = rounds_s.samples[n_rounds:]
        run["ttft_s"] = first_token_s(reqs, t0)
        out[name] = run
    eng.close()
    return out


def outputs_agree(label: str, got: list, want: list, cpu_wl,
                  tol: float) -> dict:
    """Tokens as :func:`serve_agrees` holds them; tree and lattice outputs
    within ``tol``. Returns the largest difference, whether all are
    bit-equal, and the near-tie flips."""
    worst, exact = 0.0, True
    for a, b in zip(got, want):
        if a.family == "lm":
            continue
        err = float(abs(a.result - b.result).max())
        worst = max(worst, err)
        exact = exact and bool((a.result == b.result).all())
        if a.result.shape != b.result.shape or not err <= tol:
            fail(f"launcher {label}: {a.family} request {a.rid} differs "
                 f"by {err} (tolerance {tol})")
    lm_only = [r for r in got if r.family == "lm"]
    flips = serve_agrees(label, lm_only, [r for r in want
                                          if r.family == "lm"],
                         cpu_wl)["near_tie_flips"]
    return {"max_abs_err": worst, "bit_equal": exact, "near_tie_flips": flips}


def own_counts_seen(label: str, run: dict) -> dict:
    """Fail unless the gather and gather-cell counters moved by as many
    launches as the profiler saw of those kernels in ``run``."""
    seen = {}
    for kernel in ("gather_rows", "fused_gather_lstm_cell"):
        seen[kernel] = run["profile"]["own_kernels"].get(kernel, {}).get(
            "launches", 0)
        if run["counted"][kernel] != seen[kernel]:
            fail(f"launcher {label}: {kernel} counted "
                 f"{run['counted'][kernel]} launches, the profiler saw "
                 f"{seen[kernel]} (and of the {PROFILE_PAD} empty kernels "
                 f"at each edge, {run['profile']['pads_seen']})")
    return seen


def launcher_phase(torch, drive, card: str, policies: dict) -> dict:
    """The serve launcher (section 7 of the module docstring); returns the
    launches of the row gather and the gather cell during its run (a)."""
    import shutil

    from repro_torch.launch import serve as launcher
    from repro_torch.obs.metrics import percentile
    from repro_torch.serve import PolicyRegistry
    from repro_torch.serve.checkpoint import (decode_array, latest_checkpoint,
                                              read_checkpoint)

    shutil.rmtree(LAUNCHER_DIR, ignore_errors=True)
    registry = PolicyRegistry(str(LAUNCHER_DIR / "registry"))
    for fam, policy in policies.items():
        registry.save(fam, policy)

    # (a) the launcher as a user starts it
    stats_path = LAUNCHER_DIR / "stats.json"
    t0 = time.perf_counter()
    code, counts = drive(lambda: launcher.main(
        launcher_args("--out", str(stats_path))))
    stats = json.loads(stats_path.read_text())
    if code != 0 or stats["requests_done"] != 24 or any(
            stats[k] for k in ("requests_failed", "requests_timed_out",
                               "requests_rejected")):
        fail(f"launcher (a): exit {code}, {json.dumps(stats)}")
    for kernel in ("gather_rows", "fused_gather_lstm_cell"):
        if counts[kernel] <= 0:
            fail(f"{kernel} was not launched during the launcher's run")
    log(f"launcher (a): exit 0, 24 requests completed, "
        f"{time.perf_counter() - t0:.1f} s; launches {counts} ({card})")

    # (b) the engine as the launcher builds it: async, sync, and the CPU
    runs = {
        "async": launcher_passes(torch, launcher, launcher_args(),
                                 ("first", "steady", "profiled")),
        "sync": launcher_passes(torch, launcher,
                                launcher_args("--no-async-compile"),
                                ("first", "steady", "profiled")),
        "async_cold_profiled": launcher_passes(
            torch, launcher, launcher_args(), ("profiled_first",)),
        "cpu": launcher_passes(torch, launcher,
                               launcher_args("--device", "cpu")),
    }
    cpu_wl = runs["cpu"]["workloads"]["lm"]
    want = runs["cpu"]["first"]["reqs"]
    agree = {}
    for mode in ("async", "sync"):
        for name in ("first", "steady", "profiled"):
            agree[mode, name] = outputs_agree(
                f"(b) {mode} {name} pass against the CPU",
                runs[mode][name]["reqs"], want, cpu_wl, 1e-4)
        agree[mode, "vs"] = outputs_agree(
            f"(b) {mode} first pass against the other card engine",
            runs[mode]["first"]["reqs"],
            runs["sync" if mode == "async" else "async"]["first"]["reqs"],
            cpu_wl, 1e-6)
    seen = {mode: own_counts_seen(f"(b) {mode} {name} pass",
                                  runs[mode][name])
            for mode, name in (("async", "profiled"), ("sync", "profiled"),
                               ("async_cold_profiled", "profiled_first"))}
    lines = {}
    for mode in ("async", "sync"):
        first, steady = runs[mode]["first"], runs[mode]["steady"]
        prof = runs[mode]["profiled"]
        if (steady["n_contained_errors"] or steady["n_quarantine_events"]
                or set(steady["tier_rounds"]) != {"bucketed"}
                or steady["n_graph_captures"] or not steady["n_graph_replays"]):
            fail(f"launcher (b) {mode} steady pass: tiers "
                 f"{steady['tier_rounds']}, contained "
                 f"{steady['n_contained_errors']}, quarantined "
                 f"{steady['n_quarantine_events']}, captures "
                 f"{steady['n_graph_captures']}, replays "
                 f"{steady['n_graph_replays']}")
        lines[mode] = {
            "first_pass_ms": first["wall_s"] * 1e3,
            "first_pass_ttft_ms": first["ttft_s"] * 1e3,
            "first_pass_lower_s": first["lower_s"],
            "first_pass_lower_bg_s": first["lower_bg_s"],
            "jobs_submitted": first["compile_jobs_submitted"],
            "jobs_landed": first["compile_jobs_landed"],
            "hotswaps": first["n_hotswaps"],
            "first_pass_tier_rounds": first["tier_rounds"],
            "first_pass_captures": first["n_graph_captures"],
            "rounds": steady["n_rounds"],
            "ms_per_round_median": percentile(steady["round_s"], 50) * 1e3,
            "ms_per_round_p90": percentile(steady["round_s"], 90) * 1e3,
            "steady_tok_per_s": steady["tokens_out"] / max(steady["wall_s"],
                                                           1e-9),
            "busy_share": prof["profile"]["busy_share"],
            "device_events_per_round": (prof["profile"]["device_events"]
                                        / prof["n_rounds"]),
            "device_ms_per_round": (prof["profile"]["device_ms"]
                                    / prof["n_rounds"]),
            "profiled_launches_seen": seen[mode],
            "agree": {k[1]: v for k, v in agree.items() if k[0] == mode}}
        log(f"launcher (b) {mode} detail: {json.dumps(lines[mode])}")
    a, s = lines["async"], lines["sync"]
    cold = runs["async_cold_profiled"]["profiled_first"]
    log(f"launcher (b) first pass, async / sync: "
        f"{a['first_pass_ms']:.1f} / {s['first_pass_ms']:.1f} ms, time to "
        f"first token {a['first_pass_ttft_ms']:.1f} / "
        f"{s['first_pass_ttft_ms']:.1f} ms, lower_s on the loop "
        f"{a['first_pass_lower_s']:.3f} / {s['first_pass_lower_s']:.3f}, "
        f"lower_bg_s {a['first_pass_lower_bg_s']:.3f} / "
        f"{s['first_pass_lower_bg_s']:.3f}, jobs submitted "
        f"{a['jobs_submitted']} landed {a['jobs_landed']}, hot-swaps "
        f"{a['hotswaps']}, tier rounds {a['first_pass_tier_rounds']} / "
        f"{s['first_pass_tier_rounds']} ({card})")
    log(f"launcher (b) steady pass, async / sync: ms per round median "
        f"{a['ms_per_round_median']:.3f} / {s['ms_per_round_median']:.3f}, "
        f"p90 {a['ms_per_round_p90']:.3f} / {s['ms_per_round_p90']:.3f}, "
        f"busy share {a['busy_share']:.3f} / {s['busy_share']:.3f}, device "
        f"events per round {a['device_events_per_round']:.1f} / "
        f"{s['device_events_per_round']:.1f}; every round bucketed and "
        f"replayed, no quarantine ({card})")
    log(f"launcher (b) outputs: async vs sync max abs err "
        f"{a['agree']['vs']['max_abs_err']:.3e} (bit-equal "
        f"{a['agree']['vs']['bit_equal']}), vs the CPU "
        f"{max(v['max_abs_err'] for k, v in a['agree'].items() if k != 'vs'):.3e}"
        f" / {max(v['max_abs_err'] for k, v in s['agree'].items() if k != 'vs'):.3e}"
        f"; near-tie flips "
        f"{[f for v in agree.values() for f in v['near_tie_flips']]}; "
        f"cold async pass under the profiler: counted = seen "
        f"{seen['async_cold_profiled']}, tiers {cold['tier_rounds']}, "
        f"busy share {cold['profile']['busy_share']:.3f}")

    # (c) crash at round 8 with a checkpoint, then --restore
    ckpt = LAUNCHER_DIR / "ckpt"
    code, _ = launcher.serve(launcher.parse_args(launcher_args(
        "--checkpoint-dir", str(ckpt), "--inject-faults", "crash=8")))
    if code != 1:
        fail(f"launcher (c): the injected crash exited {code}, not 1")
    path = latest_checkpoint(str(ckpt))
    saved = read_checkpoint(path)["pool"]
    args = launcher.parse_args(launcher_args("--restore", str(ckpt)))
    wls = launcher.make_workloads(args)
    made = {}
    init_slots = wls["lm"].init_slots

    def recording(n):
        pool = init_slots(n)
        made.update({f: t.data_ptr() for f, t in pool.items()})
        return pool

    wls["lm"].init_slots = recording
    code, restored = launcher.serve(args, wls)
    if code != 0:
        fail(f"launcher (c): --restore exited {code}")
    pool = restored._pool
    ptrs = {f: t.data_ptr() for f, t in pool.items()}
    if ptrs != made:
        fail(f"launcher (c): the restored pool moved ({made} -> {ptrs})")
    clean = runs["async"]["first"]["reqs"]
    led = [restored.requests[rid] for rid in sorted(restored.requests)]
    if [r.status for r in led] != ["COMPLETED"] * len(clean):
        fail(f"launcher (c): restored statuses {[r.status for r in led]}")
    for a_req, b_req in zip(led, clean):
        if a_req.family == "lm" and a_req.out != b_req.out:
            fail(f"launcher (c): lm request {a_req.rid} tokens "
                 f"{a_req.out} != {b_req.out}")
    res = outputs_agree("(c) restored against the uninterrupted run", led,
                        clean, cpu_wl, 1e-6)
    log(f"launcher (c): crash exit 1 at round 8 ({Path(path).name}), "
        f"--restore exit 0 from round {read_checkpoint(path)['clock']['round']}"
        f", {restored.stats.n_restores} restore; tokens equal the "
        f"uninterrupted run's, outputs max abs err {res['max_abs_err']:.3e} "
        f"(bit-equal {res['bit_equal']}); the pool kept its addresses "
        f"({len(ptrs)} fields, {len(saved)} in the checkpoint)")

    # (d) warm start: a second engine prewarms the first's warm set
    ws = runs["async"]["engine"].warmset()
    args = launcher.parse_args(launcher_args())
    wls = launcher.make_workloads(args)
    eng = launcher.make_engine(args, wls, PolicyRegistry(args.registry))
    t0 = time.perf_counter()
    n_jobs = eng.prewarm(ws)
    eng._compiler.drain()
    prewarm_s = time.perf_counter() - t0
    reqs = launcher.make_trace(args, wls)
    eng.submit_many(reqs)
    t0 = time.perf_counter()
    eng.step()        # round 0 admits the trace's first request, an lm one
    # a pipelined round is an lm round served at tier bucketed
    first_lm_bucketed = (reqs[0].family == "lm" and reqs[0].admit_round == 0
                         and eng.stats.n_pipelined_rounds == 1)
    eng.run()
    eng.close()
    warm_ttft = first_token_s(reqs, t0)
    if not first_lm_bucketed or eng.stats.n_hotswaps:
        fail(f"launcher (d): the warm engine's first lm round ran below "
             f"tier bucketed ({eng.stats.tier_rounds}, hot-swaps "
             f"{eng.stats.n_hotswaps})")
    log(f"launcher (d): warm set {ws}, {n_jobs} job(s) prewarmed in "
        f"{prewarm_s:.2f} s; the first lm round ran bucketed; time to first "
        f"token cold {a['first_pass_ttft_ms']:.1f} ms, warm "
        f"{warm_ttft * 1e3:.1f} ms ({card})")
    return counts


# -- phase 8 --------------------------------------------------------------


# The sharded engine on phase 6's mixed trace (the launcher's defaults),
# K replicas at the same 16 slots in all; phase 6's FSMs.
SHARDED_KS = (1, 2, 4)
SHARDED_DIR = ROOT / "build" / "chip_smoke" / "sharded"


def steal_trace(mod):
    """The reference's work-stealing trace (``tests/test_resilience.py``):
    staggered lm lengths leave the later wave imbalanced across two
    shards. The mixed trace stays balanced, so it steals nothing."""
    return [mod.lm_request([i + 1, i + 2], 3 + (i % 3) * 2,
                           arrival=float(i)) for i in range(10)]


def sharded_line(label: str, k: int, run: dict, prof: dict | None,
                 card: str, head: str | None = None,
                 seconds: float | None = None) -> dict:
    """Log one ``serve sharded K=<k>`` line (or ``head``) for ``run`` (a
    pass of :func:`serve_passes`) and return its numbers; ``prof`` is a
    profiled pass of the same engine, or None (busy share not measured);
    ``seconds`` the wall of the runs the line stands for, if given."""
    from repro_torch.obs.metrics import percentile

    line = {
        "k": k, "tok_per_s": run["tok_per_s"], "rounds": run["n_rounds"],
        "ms_per_round_median": percentile(run["round_s"], 50) * 1e3,
        "ms_per_round_p90": percentile(run["round_s"], 90) * 1e3,
        "ms_per_round_max": max(run["round_s"]) * 1e3,
        "wall_ms": run["wall_s"] * 1e3,
        "captures": run["n_graph_captures"],
        "replays": run["n_graph_replays"],
        "fallback_rounds": run["n_shard_fallback_rounds"],
        "sharded_dispatches": run["n_sharded_dispatches"],
        "lower_s": run["lower_s"], "tier_rounds": run["tier_rounds"]}
    if prof is not None:
        line["busy_share"] = prof["profile"]["busy_share"]
        line["device_events_per_round"] = (prof["profile"]["device_events"]
                                           / prof["n_rounds"])
        line["device_ms_per_round"] = (prof["profile"]["device_ms"]
                                       / prof["n_rounds"])
    busy = (f"busy share {line['busy_share']:.3f}, device events per round "
            f"{line['device_events_per_round']:.1f}" if prof is not None
            else "busy share not measured")
    if seconds is not None:
        line["seconds"] = seconds
    log(f"{head or f'serve sharded K={k}'}: {label}: "
        f"{line['tok_per_s']:.1f} tok/s, "
        f"{line['rounds']} rounds, ms per round median "
        f"{line['ms_per_round_median']:.3f} p90 "
        f"{line['ms_per_round_p90']:.3f} max {line['ms_per_round_max']:.3f}"
        f" (wall {line['wall_ms']:.1f} ms), {busy}, captures "
        f"{line['captures']}, replays {line['replays']}, fallback rounds "
        f"{line['fallback_rounds']}, sharded dispatches "
        f"{line['sharded_dispatches']}, lowering on the loop "
        f"{line['lower_s']:.3f} s, tiers {line['tier_rounds']}"
        + (f", {seconds:.1f} s" if seconds is not None else "")
        + f" ({card})")
    return line


def same_outputs(label: str, got: list, want: list) -> None:
    """Fail unless every request of ``got`` completed with ``want``'s lm
    tokens and bit-equal tree and lattice outputs."""
    for a, b in zip(got, want):
        if a.status != "COMPLETED" or b.status != "COMPLETED":
            fail(f"serve sharded {label}: request {a.rid} {a.status}, "
                 f"{b.status}")
        if a.family == "lm" and a.out != b.out:
            fail(f"serve sharded {label}: lm request {a.rid} tokens "
                 f"{a.out} != {b.out}")
        if a.family != "lm" and not (a.result.shape == b.result.shape
                                     and (a.result == b.result).all()):
            fail(f"serve sharded {label}: {a.family} request {a.rid} is "
                 f"not bit-equal")


def placed_runs(torch, wls, policies, card: str, host: dict, label: str,
                k: int, devices, stacked: dict | None, stacked_loss,
                base: list, cpu_wl, one_pass, mixed) -> dict:
    """Phase 8 (e) and (f): K replicas placed one a card of ``devices``
    (None: every card) through the engine: a first, a steady and a
    profiled pass, then a loss of shard 1 at round 3 and a regrowth at
    round 7. The passes bit-equal to ``stacked`` (the stacked K run's
    passes) where given, and within 1e-6 of K = 1's (``base``); the loss
    and regrowth within 1e-6 of the clean K run, as (a) holds the stack's,
    and bit-equal to ``stacked_loss`` (the stack's own, (a)) where given;
    the steady pass all sharded, replayed and uncontained. Logs the
    line."""
    from repro_torch.core.cache import LRUCache
    from repro_torch.serve.faults import FaultInjector

    t0 = time.perf_counter()
    place = dict(devices=devices) if devices is not None else dict(
        placement="cards")
    runs = serve_passes(torch, wls, policies, "mixed",
                        dict(host, bucket_cache=LRUCache(256)),
                        passes=("first", "steady", "profiled"), n_shards=k,
                        **place)
    for name in ("first", "steady", "profiled"):
        if stacked is not None:
            same_outputs(f"{label} {name} pass against stacked K={k}",
                         runs[name]["reqs"], stacked[name]["reqs"])
        outputs_agree(f"sharded {label} {name} pass against K=1",
                      runs[name]["reqs"], base, cpu_wl, 1e-6)
    own_counts_seen(f"sharded {label} profiled pass", runs["profiled"])
    steady = runs["steady"]
    if (steady["n_contained_errors"] or steady["n_quarantine_events"]
            or set(steady["tier_rounds"]) != {"sharded"}
            or steady["n_graph_captures"] or not steady["n_graph_replays"]
            or not steady["n_sharded_dispatches"]):
        fail(f"serve sharded {label} steady pass: {steady['tier_rounds']}, "
             f"contained {steady['n_contained_errors']}, captures "
             f"{steady['n_graph_captures']}, replays "
             f"{steady['n_graph_replays']}")
    reqs = mixed()
    eng, _ = one_pass(f"{label} loss at round 3, regrowth at round 7", k,
                      reqs, fault_injector=FaultInjector(
                          shard_lost={3: 1}, shard_back_rounds=[7]),
                      **place)
    if [(e["old"], e["new"]) for e in eng.resize_log] != [(k, k - 1),
                                                         (k - 1, k)]:
        fail(f"serve sharded {label}: resize log {eng.resize_log}")
    if stacked_loss is not None:
        same_outputs(f"{label} loss and regrowth against the stack's (a)",
                     reqs, stacked_loss)
    outputs_agree(f"sharded {label} loss and regrowth against the clean "
                  f"K={k} run", reqs, runs["first"]["reqs"], cpu_wl, 1e-6)
    outputs_agree(f"sharded {label} loss and regrowth against K=1", reqs,
                  base, cpu_wl, 1e-6)
    cards = ",".join(str(d) for d in eng._data_mesh().cards)
    line = sharded_line("steady", k, steady, runs["profiled"], card,
                        head=f"serve sharded placed K={k} devices={cards}",
                        seconds=time.perf_counter() - t0)
    line["first"] = sharded_line("first", k, runs["first"], None, card,
                                 head=f"serve sharded placed K={k} "
                                      f"devices={cards}")
    line["loss_and_regrowth"] = {"resize_log": eng.resize_log,
                                 "evacuated": eng.stats.n_entries_evacuated}
    return line


def sharded_phase(torch, drive, card: str, policies: dict) -> dict:
    """The sharded serve engine (section 8 of the module docstring);
    returns the launches of the row gather and the gather cell during the
    K = 4 steady pass."""
    import shutil

    from repro_torch import serve as tserve
    from repro_torch.core.cache import FIFOCache, LRUCache
    from repro_torch.launch import serve as launcher
    from repro_torch.serve import PolicyRegistry, ServeEngine
    from repro_torch.serve.checkpoint import latest_checkpoint, read_checkpoint
    from repro_torch.serve.faults import FaultInjector

    wls = serve_workloads("cuda")
    cpu_wls = serve_workloads("cpu")
    cpu_wl = cpu_wls["lm"]
    want = serve_passes(torch, cpu_wls, policies, "mixed", {},
                        passes=("first",))["first"]["reqs"]
    # room for every engine's packs: K = 1, 2 and 4 pack other topologies
    host = dict(plan_cache=FIFOCache(2048), schedule_cache=FIFOCache(2048))
    runs, lines = {}, {}
    for k in SHARDED_KS:
        runs[k] = serve_passes(torch, wls, policies, "mixed",
                               dict(host, bucket_cache=LRUCache(256)),
                               drive if k == 4 else None,
                               passes=("first", "steady", "profiled",
                                       "traced"),
                               n_shards=k)
        vs_cpu = max(serve_agrees(f"sharded K={k} {name} pass",
                                  runs[k][name]["reqs"], want,
                                  cpu_wl)["max_abs_err_vs_cpu"]
                     for name in ("first", "steady", "profiled"))
        seen = own_counts_seen(f"sharded K={k} profiled pass",
                               runs[k]["profiled"])
        steady = runs[k]["steady"]
        tier = "sharded" if k > 1 else "bucketed"
        if (steady["n_contained_errors"] or steady["n_quarantine_events"]
                or set(steady["tier_rounds"]) != {tier}
                or steady["n_graph_captures"] or not steady["n_graph_replays"]
                or (k > 1 and not steady["n_sharded_dispatches"])):
            fail(f"serve sharded K={k} steady pass: {steady['tier_rounds']}, "
                 f"contained {steady['n_contained_errors']}, captures "
                 f"{steady['n_graph_captures']}, replays "
                 f"{steady['n_graph_replays']}, sharded dispatches "
                 f"{steady['n_sharded_dispatches']}")
        lines[k] = sharded_line("steady", k, steady, runs[k]["profiled"],
                                card)
        lines[k]["first"] = sharded_line("first", k, runs[k]["first"], None,
                                         card)
        lines[k]["profiled_launches_seen"] = seen
        lines[k]["max_abs_err_vs_cpu"] = vs_cpu
        lines[k]["host_span_ms_per_round"] = runs[k]["traced"][
            "span_ms_per_round"]
        log(f"serve sharded K={k} host ms per round (traced pass): "
            + ", ".join(f"{n} {v:.3f}" for n, v in
                        lines[k]["host_span_ms_per_round"].items()))
    base = runs[1]["first"]["reqs"]
    for k in SHARDED_KS[1:]:
        for name in ("first", "steady", "profiled"):
            lines[k].setdefault("vs_k1", {})[name] = outputs_agree(
                f"sharded K={k} {name} pass against K=1 on the card",
                runs[k][name]["reqs"], base, cpu_wl, 1e-6)
    launches = runs[4]["steady"]["launches"]
    for kernel in ("gather_rows", "fused_gather_lstm_cell"):
        if launches[kernel] <= 0:
            fail(f"{kernel} was not launched during serve sharded K=4")

    def one_pass(label, k, reqs, **kw):
        eng = ServeEngine(dict(wls), policies=policies, max_slots=16,
                          n_shards=k, device="cuda", **host, **kw)
        eng.submit_many(reqs)
        t0 = time.perf_counter()
        stats = eng.run()
        torch.cuda.synchronize()
        eng.close()
        bad = [r.status for r in reqs if r.status != "COMPLETED"]
        if bad:
            fail(f"serve sharded {label}: {len(bad)} requests ended "
                 f"{set(bad)}")
        log(f"serve sharded K={k}: {label}: {stats.tokens_out / stats.wall_s:.1f}"
            f" tok/s, {stats.n_rounds} rounds, {time.perf_counter() - t0:.2f}"
            f" s, busy share not measured, captures {stats.n_graph_captures}"
            f", lowering on the loop {stats.lower_s:.3f} s, in the "
            f"background {stats.lower_bg_s:.3f} s"
            f", replays {stats.n_graph_replays}, fallback rounds "
            f"{stats.n_shard_fallback_rounds}, sharded dispatches "
            f"{stats.n_sharded_dispatches}, tiers {stats.tier_rounds} "
            f"({card})")
        return eng, stats

    from repro_torch.serve import synth_trace
    fams, n, rate, max_new, _, args = SERVE_TRACES["mixed"]

    def mixed():
        return synth_trace(fams, n, rate, max_new, wls, SEED, **args)

    # (a) shard loss at round 3 and regrowth at round 7
    reqs = mixed()
    eng, _ = one_pass("(a) loss at round 3, regrowth at round 7", 2, reqs,
                      fault_injector=FaultInjector(shard_lost={3: 1},
                                                   shard_back_rounds=[7]))
    log_ = [(e["old"], e["new"]) for e in eng.resize_log]
    if log_ != [(2, 1), (1, 2)]:
        fail(f"serve sharded (a): resize log {eng.resize_log}")
    outputs_agree("sharded (a) against the clean K=2 run", reqs,
                  runs[2]["first"]["reqs"], cpu_wl, 1e-6)
    lines["a"] = {"resize_log": eng.resize_log,
                  "evacuated": eng.stats.n_entries_evacuated}
    lossy = reqs

    # (b) work stealing, beside a clean run of the same trace
    clean = steal_trace(tserve)
    eng_c = ServeEngine({"lm": wls["lm"]}, policies=policies, max_slots=4,
                        n_shards=2, device="cuda")
    eng_c.submit_many(clean)
    eng_c.run()
    stolen = steal_trace(tserve)
    eng_s = ServeEngine({"lm": wls["lm"]}, policies=policies, max_slots=4,
                        n_shards=2, device="cuda", steal_threshold=0)
    eng_s.submit_many(stolen)
    st = eng_s.run()
    torch.cuda.synchronize()
    if st.n_entries_stolen < 1 or any(r.status != "COMPLETED"
                                      for r in stolen + clean):
        fail(f"serve sharded (b): stolen {st.n_entries_stolen}")
    for a, b in zip(stolen, clean):
        if a.out != b.out:
            fail(f"serve sharded (b): lm request {a.rid} tokens {a.out} "
                 f"!= {b.out} without stealing")
    cpu_steal = steal_trace(tserve)
    eng_cpu = ServeEngine({"lm": cpu_wls["lm"]}, policies=policies,
                          max_slots=4, n_shards=2, device="cpu",
                          steal_threshold=0)
    eng_cpu.submit_many(cpu_steal)
    eng_cpu.run()
    flips = serve_agrees("sharded (b) against the CPU", stolen, cpu_steal,
                         cpu_wl)["near_tie_flips"]
    log(f"serve sharded K=2: (b) steal_threshold=0: {st.n_entries_stolen} "
        f"entries stolen, {st.n_rounds} rounds, tokens equal the clean "
        f"run's, near-tie flips against the CPU {flips}, captures "
        f"{st.n_graph_captures}, replays {st.n_graph_replays}, sharded "
        f"dispatches {st.n_sharded_dispatches} ({card})")
    lines["b"] = {"stolen": st.n_entries_stolen}

    # (c) a crash on a shrunken mesh through the launcher, then --restore
    shutil.rmtree(SHARDED_DIR, ignore_errors=True)
    registry = PolicyRegistry(str(SHARDED_DIR / "registry"))
    for fam, policy in policies.items():
        registry.save(fam, policy)
    ckpt = SHARDED_DIR / "ckpt"
    common = ["--model-size", str(MODEL_SIZE), "--seed", str(SEED),
              "--registry", str(SHARDED_DIR / "registry")]
    code = launcher.main(common + [
        "--devices", "2", "--checkpoint-dir", str(ckpt),
        "--inject-faults", "crash=8,shard_lost=5*1"])
    if code != 1:
        fail(f"serve sharded (c): the injected crash exited {code}, not 1")
    path = latest_checkpoint(str(ckpt))
    doc = read_checkpoint(path)
    code, restored = launcher.serve(launcher.parse_args(
        common + ["--restore", str(ckpt)]))
    if code != 0:
        fail(f"serve sharded (c): --restore exited {code}")
    led = [restored.requests[rid] for rid in sorted(restored.requests)]
    if [r.status for r in led] != ["COMPLETED"] * len(want):
        fail(f"serve sharded (c): restored statuses "
             f"{[r.status for r in led]}")
    res = outputs_agree("sharded (c) restored against the uninterrupted "
                        "K=2 run", led, runs[2]["first"]["reqs"], cpu_wl,
                        1e-6)
    log(f"serve sharded K=2: (c) crash exit 1 at round "
        f"{doc['clock']['round']} on a mesh of {doc['config']['n_shards']} "
        f"(excluded {doc['config']['excluded_devices']}), --restore exit 0 "
        f"on {restored.n_shards} replica(s) of {restored._n_shards0}; tokens "
        f"equal the uninterrupted run's, outputs max abs err "
        f"{res['max_abs_err']:.3e} (bit-equal {res['bit_equal']}) ({card})")
    lines["c"] = {"crash_round": doc["clock"]["round"],
                  "n_shards_at_crash": doc["config"]["n_shards"]}

    # (d) K = 4 with async compile: sharded builds on the workers
    runs_d = serve_passes(torch, wls, policies, "mixed",
                          dict(host, bucket_cache=LRUCache(256)),
                          passes=("first", "steady"), n_shards=4,
                          async_compile=True)
    for name in ("first", "steady"):
        outputs_agree(f"sharded (d) async {name} pass against K=1",
                      runs_d[name]["reqs"], base, cpu_wl, 1e-6)
    d = runs_d["steady"]
    if (not d["n_graph_replays"] or d["n_graph_captures"]
            or set(d["tier_rounds"]) != {"sharded"}):
        fail(f"serve sharded (d) steady pass: {d['tier_rounds']}, captures "
             f"{d['n_graph_captures']}, replays {d['n_graph_replays']}")
    lines["d"] = sharded_line("(d) async compile, first pass", 4,
                              runs_d["first"], None, card)
    sharded_line("(d) async compile, steady pass", 4, d, None, card)

    # (e) one replica a card, both placements on cuda:0; (f) on distinct
    # cards where the machine has them
    lines["e"] = placed_runs(torch, wls, policies, card, host, "(e)", 2,
                             ("cuda:0", "cuda:0"), runs[2], lossy, base,
                             cpu_wl, one_pass, mixed)
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        k = min(4, n_cards)
        lines["f"] = placed_runs(torch, wls, policies, card, host, "(f)", k,
                                 None, runs.get(k), lossy if k == 2 else None,
                                 base, cpu_wl, one_pass, mixed)
    else:
        log(f"serve sharded (f): not run: the machine has {n_cards} card, "
            f"so no replica could be placed on a second one ({card})")
    log(f"serve sharded detail: {json.dumps(lines, default=str)}")
    one, two, four = (lines[k] for k in SHARDED_KS)
    log(f"serve sharded K=1/2/4 steady: ms per round median "
        f"{one['ms_per_round_median']:.3f} / {two['ms_per_round_median']:.3f}"
        f" / {four['ms_per_round_median']:.3f}, busy share "
        f"{one['busy_share']:.3f} / {two['busy_share']:.3f} / "
        f"{four['busy_share']:.3f}, device events per round "
        f"{one['device_events_per_round']:.1f} / "
        f"{two['device_events_per_round']:.1f} / "
        f"{four['device_events_per_round']:.1f}; K=4 steady launches "
        f"{launches} ({card})")
    return launches


# -- phase 9 --------------------------------------------------------------


# The trainer at the reference launcher's defaults (--batch 8 --seq 128,
# src/repro/launch/train.py:31-32) on full-width, full-depth Qwen2-0.5B.
TRAIN_BATCH, TRAIN_SEQ = 8, 128
# phase 9's AdamW forms: a gradient element below this share of its leaf's
# largest |entry| still takes an lr-sized Adam step (the closed-loop reading)
SCALE_FREE = 1e-3
TRAIN_ARGS = ["--arch", "qwen2-0.5b", "--batch", str(TRAIN_BATCH),
              "--seq", str(TRAIN_SEQ)]
TRAIN_STEPS = 10
TRAIN_DIR = ROOT / "build" / "chip_smoke" / "train"
# phase 9 (b) and (f)'s reports by model, read beside the bf16 steps of (h)
FP32_TRAIN: dict = {}
GRAD_TOL = 1e-4       # backward kernel vs its plain version, of max |grad|


def grad_rel_err(got, want) -> float:
    """Max abs error over the largest |gradient| of the plain version."""
    return float((got - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def grad_rel_errs(got: list, want: list) -> list:
    """:func:`grad_rel_err` of each of (dq, dk, dv); a gradient that is
    zero in the plain version (one key: the softmax is constant) is held
    to the largest |gradient| of the three."""
    top = max(float(w.abs().max()) for w in want)
    return [float((g - w).abs().max()) / (float(w.abs().max()) or top)
            for g, w in zip(got, want)]


def check_flash_backward(torch, timer) -> dict:
    """Phase 9 (a): the backward kernel against autograd of the plain
    attention on the card, at the trainer's shape and the edge cases, then
    timed cold beside the plain backward and the backward of
    ``scaled_dot_product_attention`` (K/V expanded; a yardstick the port
    never calls), and the forward with the lse beside the forward
    without."""
    from repro_torch.kernels import costs, ref
    from repro_torch.kernels.flash_attention import (
        BACKWARD_PARTS, backward_kernels, flash_attention,
        flash_attention_backward, flash_attention_forward)

    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    cases = [  # (label, B, Sq, Skv, H, KV, D, causal, window, packed)
        ("trainer B=8 S=128 G=7", 8, 128, 128, 14, 2, 64, True, 0, False),
        ("S=1 G=7", 2, 1, 1, 14, 2, 64, True, 0, False),
        ("S=37 G=1", 2, 37, 37, 4, 4, 64, True, 0, False),
        ("S=200 G=7", 1, 200, 200, 14, 2, 64, True, 0, False),
        ("S=37 D=128 G=7", 1, 37, 37, 14, 2, 128, True, 0, False),
        ("S=200 D=128 G=1", 1, 200, 200, 2, 2, 128, True, 0, False),
        ("window 16 S=200 G=7", 1, 200, 200, 14, 2, 64, True, 16, False),
        ("window 4 Sq=17 Skv=9, rows with no key", 1, 17, 9, 14, 2, 16,
         True, 4, False),
        ("cross Sq=40 Skv=77", 2, 40, 77, 6, 3, 64, False, 0, False),
        ("packed q/k/v S=128 G=7", 2, 128, 128, 14, 2, 64, True, 0, True),
        # dk/dv clusters of 3 and 4 ranks (phi4-mini's head map), beyond
        # one cluster (16 heads: 8 ranks of 2), and cross attention at G = 7
        ("G=3 D=128 S=128", 2, 128, 128, 24, 8, 128, True, 0, False),
        ("G=4 D=128 S=128", 1, 128, 128, 32, 8, 128, True, 0, False),
        ("G=16 S=128", 1, 128, 128, 16, 1, 64, True, 0, False),
        ("cross G=7 Sq=40 Skv=77", 2, 40, 77, 14, 2, 64, False, 0, False),
    ]
    worst = 0.0
    for label, B, Sq, Skv, H, KV, D, causal, window, packed in cases:
        if packed:
            qkv = torch.randn((B, Sq, (H + 2 * KV) * D), generator=g,
                              device="cuda")
            q = qkv[..., :H * D].view(B, Sq, H, D)
            k = qkv[..., H * D:(H + KV) * D].view(B, Sq, KV, D)
            v = qkv[..., (H + KV) * D:].view(B, Sq, KV, D)
        else:
            q = torch.randn((B, Sq, H, D), generator=g, device="cuda")
            k = torch.randn((B, Skv, KV, D), generator=g, device="cuda")
            v = torch.randn((B, Skv, KV, D), generator=g, device="cuda")
        dout = torch.randn((B, Sq, H, D), generator=g, device="cuda")
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        flash_attention(*leaves, causal=causal, window=window).backward(dout)
        want = ref.flash_attention_backward_ref(q, k, v, dout, causal, window)
        torch.cuda.synchronize()
        errs = grad_rel_errs([t.grad for t in leaves], want)
        if not all(e <= GRAD_TOL for e in errs):
            fail(f"flash_attention_backward {label}: relative err (dq, dk, "
                 f"dv) {errs} > {GRAD_TOL}")
        worst = max([worst] + [float((t.grad - w).abs().max())
                               for t, w in zip(leaves, want)])
        log(f"flash_attention_backward {label}: relative err dq "
            f"{errs[0]:.3e}, dk {errs[1]:.3e}, dv {errs[2]:.3e}")

    B, S, H, KV, D = 8, 128, 14, 2, 64     # the trainer's attention
    q = torch.randn((B, S, H, D), generator=g, device="cuda")
    k = torch.randn((B, S, KV, D), generator=g, device="cuda")
    v = torch.randn((B, S, KV, D), generator=g, device="cuda")
    dout = torch.randn((B, S, H, D), generator=g, device="cuda")
    out, lse = flash_attention_forward(q, k, v, True, 0, with_lse=True)
    plain_out, _ = flash_attention_forward(q, k, v, True, 0)
    torch.cuda.synchronize()
    if not torch.equal(out, plain_out):
        fail("flash_attention: the output with the lse differs from the "
             "output without it")
    first = flash_attention_backward(q, k, v, out, dout, lse)
    again = flash_attention_backward(q, k, v, out, dout, lse)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        fail("flash_attention_backward: two runs at the trainer's shape "
             "differ")
    ms = timer(lambda: flash_attention_backward(q, k, v, out, dout, lse))
    # each kernel alone, cold, into fresh buffers a full run filled first
    # (dk/dv and dq read rowdot's D); they must end as the full run's
    buffers = (torch.empty((B, H, S), device="cuda"),
               *(torch.empty_like(t) for t in first))
    backward_kernels(q, k, v, out, dout, lse, True, 0, buffers)
    parts_ms = {name: timer(lambda: backward_kernels(
        q, k, v, out, dout, lse, True, 0, buffers, part))
        for name, part in BACKWARD_PARTS.items()}
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, buffers[1:])):
        fail("flash_attention_backward: the kernels run apart differ from "
             "a full run")
    log(f"flash_attention_backward trainer shape: two runs bit-equal; "
        f"kernels apart cold ms {parts_ms} (sum "
        f"{sum(parts_ms.values()):.4f})")
    plain_ms = timer(lambda: ref.flash_attention_backward_ref(q, k, v, dout))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt = q.transpose(1, 2).contiguous().requires_grad_(True)
    kt, vt = (t.repeat_interleave(H // KV, dim=2).transpose(1, 2)
              .contiguous().requires_grad_(True) for t in (k, v))
    ot = sdpa(qt, kt, vt, is_causal=True)
    dt = dout.transpose(1, 2).contiguous()

    def library():
        torch.autograd.grad(ot, (qt, kt, vt), dt, retain_graph=True)

    library_ms = timer(library)
    log(f"scaled_dot_product_attention backward runs: "
        f"{library_kernels(torch, library)}")
    fwd_ms = timer(lambda: flash_attention_forward(q, k, v, True, 0))
    fwd_lse_ms = timer(lambda: flash_attention_forward(q, k, v, True, 0,
                                                       with_lse=True))
    log(f"flash_attention_backward trainer shape ms: cold kernel {ms:.4f}, "
        f"plain autograd {plain_ms:.4f}, scaled_dot_product_attention "
        f"backward {library_ms:.4f}; forward cold {fwd_ms:.4f} without lse, "
        f"{fwd_lse_ms:.4f} with")
    return {"name": "flash_attention_backward", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/kernels/flash_attention.py:65",
            "shape": f"q/o/dO ({B}, {S}, {H}, {D}), k/v ({B}, {S}, {KV}, "
                     f"{D}) float32, causal",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            # q, o, dO, lse read and dq written; k, v read, dk, dv written
            **cost_bound("flash_attention_backward",
                         costs.flash_attention_backward(B, S, S, H, KV, D,
                                                        True, 0),
                         "3xTF32 on the tensor cores"),
            "library_ms": library_ms, "forward_ms": fwd_ms,
            "forward_lse_ms": fwd_lse_ms,
            **{f"{name}_ms": t for name, t in parts_ms.items()}}


def eager_train(torch, arch: str, steps: int, log_fn):
    """``launch.train.main``'s run at its defaults (seed 0, --lr 1e-3,
    batch TRAIN_BATCH x TRAIN_SEQ) with the step run eagerly
    (``train(..., capture=False)``): the same weights, batches and
    schedule as the launcher's captured run. Returns (state, peak bytes
    above what was allocated at its start, ms per logged step)."""
    from repro_torch.arch.model import TransformerLM, tree_map
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig, SyntheticCorpus
    from repro_torch.train.loop import train
    from repro_torch.train.optimizer import AdamWConfig

    cfg = get_config(arch)
    model = TransformerLM(cfg, device="cuda")
    params = tree_map(lambda t: t.to("cuda"), TransformerLM(
        cfg, device="cpu").init_params(torch.Generator().manual_seed(0)))
    pipe = SyntheticCorpus(PipelineConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH, seed=0,
        n_image_tokens=cfg.n_image_tokens, d_model=cfg.d_model))
    opt = AdamWConfig(lr=1e-3, warmup_steps=max(steps // 20, 5),
                      total_steps=steps)
    stamps = []

    def record(line):
        stamps.append(time.perf_counter())
        log_fn(line)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    state = train(model, params, iter(pipe), steps, opt, log_every=1,
                  log_fn=record, capture=False)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    return state, peak, [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]


def leaf_names(tree, path: str = "") -> list[str]:
    """The paths of a tree's leaves, in ``train.optimizer.leaves`` order."""
    if isinstance(tree, dict):
        return [n for key in sorted(tree)
                for n in leaf_names(tree[key], f"{path}/{key}")]
    if isinstance(tree, (tuple, list)):
        return [n for i, sub in enumerate(tree)
                for n in leaf_names(sub, f"{path}/{i}")]
    return [path.lstrip("/")]


def adamw_forms(torch, label: str, arch: str, steps: int) -> dict:
    """The trainer's in-place multi-tensor AdamW (``adamw_update_``) held
    to the functional one (``adamw_update``, the reference's form) at full
    width, from ``launch.train.main``'s weights, batches and schedule.
    Open loop: both take the same gradients, those at the functional
    run's parameters, for ``steps`` steps; every parameter leaf must stay
    within 1e-4 of its largest |value| (the worst leaf is named). Closed
    loop, a reading with no bar: the in-place form takes the gradients at
    its own parameters, as the trainer does, so step 1's rounding feeds
    back through the model. Adam's step is about lr whatever a gradient's
    size, so an element whose gradient is a small share of its leaf's
    largest moves with its gradient's small changes, and a leaf that
    starts at zero (a bias) spans only a few lr steps: the worst leaf is
    named with its largest |value|, beside the worst over the elements
    whose |gradient| stayed above SCALE_FREE of their leaf's largest at
    every step. Returns the report."""
    from repro_torch.arch.model import TransformerLM, tree_map
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig, SyntheticCorpus
    from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                             adamw_update_, init_opt_state,
                                             leaves, unflatten)

    cfg = get_config(arch)
    model = TransformerLM(cfg, device="cuda")
    tree = tree_map(lambda t: t.to("cuda"), TransformerLM(
        cfg, device="cpu").init_params(torch.Generator().manual_seed(0)))
    names = leaf_names(tree)
    corpus = SyntheticCorpus(PipelineConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH, seed=0,
        n_image_tokens=cfg.n_image_tokens, d_model=cfg.d_model))
    opt = AdamWConfig(lr=1e-3, warmup_steps=max(steps // 20, 5),
                      total_steps=steps)

    def grads_at(flat, batch):
        flat = [p.detach().requires_grad_(True) for p in flat]
        with torch.enable_grad():
            loss = model.loss(unflatten(tree, flat), batch)
            return list(torch.autograd.grad(loss, flat))

    def moments(flat):
        return ([torch.zeros_like(p) for p in flat],
                [torch.zeros_like(p) for p in flat],
                torch.zeros((), dtype=torch.int32, device="cuda"))

    fun, fun_state = tree, init_opt_state(tree)
    open_p = [p.clone() for p in leaves(tree)]
    closed_p = [p.clone() for p in leaves(tree)]
    open_m, closed_m = moments(open_p), moments(closed_p)
    small = [torch.zeros_like(p, dtype=torch.bool) for p in open_p]
    with torch.no_grad():
        for t in range(steps):
            batch = {k: torch.as_tensor(v).to("cuda")
                     for k, v in corpus.batch(t).items()}
            g = grads_at(leaves(fun), batch)
            for below, x in zip(small, g):
                below |= x.abs() <= SCALE_FREE * x.abs().max()
            adamw_update_(opt, open_p, [x.clone() for x in g], *open_m)
            adamw_update_(opt, closed_p, grads_at(closed_p, batch),
                          *closed_m)
            fun, fun_state, _ = adamw_update(opt, fun, unflatten(tree, g),
                                             fun_state)
            del g
    want = leaves(fun)
    scale = [float(b.abs().max().clamp_min(1e-30)) for b in want]

    def worst(got, drop=None):
        e = [float(((a - b).abs() if d is None
                    else (a - b).abs() * ~d).max()) / m
             for a, b, m, d in zip(got, want, scale,
                                   drop or [None] * len(got))]
        i = max(range(len(e)), key=e.__getitem__)
        return {"leaf": names[i], "err": e[i], "leaf_max": scale[i]}

    out = {"open": worst(open_p), "closed": worst(closed_p),
           "closed_above_scale_free": worst(closed_p, small),
           "scale_free_share": sum(int(d.sum()) for d in small)
           / sum(d.numel() for d in small)}
    o, c, a = out["open"], out["closed"], out["closed_above_scale_free"]
    log(f"{label} AdamW forms, {steps} steps at full width: open loop "
        f"(same gradients) worst leaf {o['leaf']} {o['err']:.3e} of its "
        f"max; closed loop (own gradients) worst leaf {c['leaf']} "
        f"{c['err']:.3e} of its max {c['leaf_max']:.3e}, over elements "
        f"whose |gradient| stayed above {SCALE_FREE} of their leaf's max "
        f"({1 - out['scale_free_share']:.4f} of all) worst leaf "
        f"{a['leaf']} {a['err']:.3e} (bar 1e-4 on the open loop)")
    if not o["err"] <= 1e-4:
        fail(f"{label}: adamw_update_ against adamw_update on the same "
             f"gradients, leaf {o['leaf']} {o['err']} of its max (bar 1e-4)")
    return out


def captured_vs_eager(torch, label: str, arch: str, state, steps: int,
                      kernels: dict, forms: bool = True) -> dict:
    """Phase 9's comparison of the launcher's captured run (``state``)
    with the same steps run eagerly over the same static buffers: every
    step's loss and, after the last step, every parameter leaf bit-equal;
    with ``forms``, the AdamW forms held to each other
    (:func:`adamw_forms`; it holds nine copies of the parameters, so
    Granite-MoE's 5.5 GB leaves skip it: the optimizer is the same code).
    Then one replayed step of a ``StaticTrainStep`` over the trained
    state, profiled: its busy share and device events, and each of
    ``kernels``' counters moved by its launches a step (``{name:
    launches}``). Returns the report."""
    from repro_torch.arch.model import TransformerLM
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig, SyntheticCorpus
    from repro_torch.kernels.launches import WRAPPERS
    from repro_torch.train.loop import StaticTrainStep
    from repro_torch.train.optimizer import AdamWConfig, leaves

    cfg = get_config(arch)
    eager, peak, step_ms = eager_train(torch, arch, steps,
                                       lambda line: None)
    loss_errs = [abs(a - b) / abs(b)
                 for a, b in zip(state.history, eager.history)]
    leaf_errs = [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                 for a, b in zip(leaves(state.params), leaves(eager.params))]
    if len(loss_errs) != steps or max(loss_errs) != 0 or \
            max(leaf_errs) != 0:
        fail(f"{label}: captured against eager steps, losses "
             f"{state.history} against {eager.history} (worst relative "
             f"{max(loss_errs)}), worst parameter leaf {max(leaf_errs)} of "
             f"its max (want bit-equal)")
    del eager
    ms = statistics.median(step_ms)
    out = {"loss_rel_err_max": max(loss_errs),
           "param_leaf_rel_err_max": max(leaf_errs),
           "eager_step_ms": step_ms, "eager_ms_per_step": ms,
           "eager_tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / ms * 1e3,
           "eager_peak_bytes": peak,
           "adamw_forms": adamw_forms(torch, label, arch, steps)
           if forms else None}
    model = TransformerLM(cfg, device="cuda")
    step = StaticTrainStep(model, AdamWConfig(lr=1e-3, warmup_steps=5,
                                              total_steps=steps),
                           state.params, state.opt)
    corpus = SyntheticCorpus(PipelineConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH, seed=SEED))
    batch = corpus.batch(steps)
    step(batch)                                  # warm-up and capture
    before = {k: WRAPPERS[k].launches for k in kernels}
    prof = profile_run(torch, lambda: step(batch))
    moved = {k: WRAPPERS[k].launches - before[k] for k in kernels}
    if moved != kernels:
        fail(f"{label}: the profiled replayed step moved the counters by "
             f"{moved}, not {kernels}")
    out.update(replayed_step_profile=prof, replayed_step_launches=moved)
    return out


def train_phase(torch, drive, card: str, steps: int) -> dict:
    """Phase 9 (b)-(d) (module docstring); returns the flash forward and
    backward launches of (b)'s run."""
    import contextlib
    import dataclasses
    import io

    import numpy as np

    from repro_torch.arch.model import TransformerLM, tree_map
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig, SyntheticCorpus
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch import train as launcher
    from repro_torch.serve import lm_wave
    from repro_torch.train.checkpoint import load_checkpoint
    from repro_torch.train.loop import train
    from repro_torch.train.optimizer import AdamWConfig, leaves, unflatten

    cfg = get_config("qwen2-0.5b")
    # (b) the launcher in-process at full width and depth
    stamps = []

    def record(line):
        stamps.append(time.perf_counter())
        log(f"train (b): {line}")

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    state, counts = drive(lambda: launcher.main(
        TRAIN_ARGS + ["--steps", str(steps), "--log-every", "1"],
        log_fn=record))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    losses = state.history
    if len(losses) != steps or not all(np.isfinite(losses)):
        fail(f"train (b): losses {losses} (want {steps} finite)")
    per_step = cfg.n_layers * steps
    for name in ("flash_attention", "flash_attention_backward"):
        if counts[name] != per_step:
            fail(f"train (b): {name} launched {counts[name]} times in "
                 f"{steps} steps, not {cfg.n_layers} a step")
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    ms = statistics.median(step_ms)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_params = sum(t.numel() for t in leaves(state.params))

    cmp = captured_vs_eager(torch, "train (b)", "qwen2-0.5b", state, steps,
                            {"flash_attention": cfg.n_layers,
                             "flash_attention_backward": cfg.n_layers})
    prof = cmp["replayed_step_profile"]
    own_us = {k: round(v["device_us"], 1)
              for k, v in prof["own_kernels"].items()}
    report = {"n_params": n_params, "steps": steps, "losses": losses,
              "step_ms": step_ms, "ms_per_step": ms,
              "tokens_per_s": tokens / ms * 1e3, "peak_bytes": peak,
              "peak_bytes_above_start": peak - base,
              "launches": counts, "profile": prof, "eager": cmp}
    FP32_TRAIN["qwen2-0.5b"] = report
    log(f"train (b) qwen2-0.5b full width and depth ({n_params} params), "
        f"batch {TRAIN_BATCH} x {TRAIN_SEQ}, the step captured (step 1 its "
        f"warm-up, then replays): {ms:.2f} ms per step (median of steps "
        f"2-{steps}), {tokens / ms * 1e3:.1f} tokens/s, peak memory "
        f"{peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} above its "
        f"start), losses {[round(x, 4) for x in losses]}; eager: "
        f"{cmp['eager_ms_per_step']:.2f} ms per step, "
        f"{cmp['eager_tokens_per_s']:.1f} tokens/s, peak above its start "
        f"{cmp['eager_peak_bytes'] / 2**30:.2f} GiB; captured against "
        f"eager: losses within {cmp['loss_rel_err_max']:.3e} relative, "
        f"worst parameter leaf {cmp['param_leaf_rel_err_max']:.3e} of its "
        f"max; profiled replayed step: busy share "
        f"{prof['busy_share']:.3f} ({prof['device_ms']:.2f} ms device of "
        f"{prof['wall_ms']:.2f} wall), {prof['device_events']} device "
        f"events, top {prof['top_events']}; flash kernels' device us "
        f"{own_us}; flash launches {counts} ({card})")
    del state

    # (c) card against CPU at depth 2, full width, a small batch
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    cpu_model = TransformerLM(cfg2, device="cpu")
    card_model = TransformerLM(cfg2, device="cuda")
    params = cpu_model.init_params(torch.Generator().manual_seed(SEED))
    corpus = SyntheticCorpus(PipelineConfig(vocab=cfg2.vocab, seq_len=32,
                                            batch_size=2, seed=SEED))
    batches = [corpus.batch(i) for i in range(3)]

    def grads(model, device):
        flat = [t.detach().to(device).requires_grad_(True)
                for t in leaves(params)]
        loss = model.loss(unflatten(params, flat),
                          {k: torch.as_tensor(a, device=device)
                           for k, a in batches[0].items()})
        gs = torch.autograd.grad(loss, flat)
        return float(loss.detach()), [g.cpu() for g in gs]

    card_loss, card_grads = grads(card_model, "cuda")
    t0 = time.perf_counter()
    cpu_loss, cpu_grads = grads(cpu_model, "cpu")
    cpu_grad_s = time.perf_counter() - t0
    loss_err = abs(card_loss - cpu_loss) / abs(cpu_loss)
    grad_errs = [grad_rel_err(a, b) for a, b in zip(card_grads, cpu_grads)]
    if not loss_err <= 1e-4 or not max(grad_errs) <= 2e-3:
        fail(f"train (c): card against CPU, loss {loss_err}, gradients "
             f"{max(grad_errs)} (bars 1e-4, 2e-3)")
    opt = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=3)
    card_hist = train(card_model, tree_map(lambda t: t.to("cuda"), params),
                      iter(batches), 3, opt, log_every=1,
                      log_fn=lambda line: None).history
    t0 = time.perf_counter()
    cpu_hist = train(cpu_model, params, iter(batches), 3, opt, log_every=1,
                     log_fn=lambda line: None).history
    cpu_train_s = time.perf_counter() - t0
    hist_err = max(abs(a - b) / abs(b) for a, b in zip(card_hist, cpu_hist))
    if not hist_err <= 1e-3:
        fail(f"train (c): three steps' losses {card_hist} on the card, "
             f"{cpu_hist} on the CPU: relative {hist_err} > 1e-3")
    report["card_vs_cpu"] = {"loss_rel_err": loss_err,
                             "grad_rel_err_max": max(grad_errs),
                             "losses_card": card_hist, "losses_cpu": cpu_hist,
                             "loss_rel_err_3_steps": hist_err,
                             "cpu_grad_s": cpu_grad_s,
                             "cpu_train_s": cpu_train_s}
    log(f"train (c) depth 2, full width, batch 2 x 32: loss relative err "
        f"{loss_err:.3e}, worst gradient leaf {max(grad_errs):.3e} of its "
        f"max |grad|, three steps {card_hist} (card) against {cpu_hist} "
        f"(CPU), relative {hist_err:.3e}; CPU gradients {cpu_grad_s:.1f} s, "
        f"three CPU steps {cpu_train_s:.1f} s")
    del params, cpu_grads, card_grads

    # (d) a checkpoint written on the card, restored by the serve launcher
    TRAIN_DIR.mkdir(parents=True, exist_ok=True)
    path = str(TRAIN_DIR / "qwen2-0.5b-reduced.npz")
    small = launcher.main(["--arch", "qwen2-0.5b", "--reduced", "--steps",
                           "2", "--batch", "2", "--seq", "32", "--log-every",
                           "1", "--checkpoint", path],
                          log_fn=lambda line: log(f"train (d): {line}"))
    p2, o2, step, _ = load_checkpoint(path, small.params, small.opt)
    same = all(torch.equal(a, b) for a, b in zip(
        leaves(p2) + leaves(o2), leaves(small.params) + leaves(small.opt)))
    if step != 2 or not same:
        fail(f"train (d): the checkpoint gave step {step}, equal {same}")
    served = {}
    generate = lm_wave.ServeEngine.generate

    def recording(self, prompts, max_new, *a, **kw):
        res = generate(self, prompts, max_new, *a, **kw)
        served[str(self.device)] = (self, prompts, res[0])
        return res

    lm_wave.ServeEngine.generate = recording
    try:
        for device in ("cuda", "cpu"):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = serve_launcher.main(
                    ["--legacy-arch", "qwen2-0.5b", "--checkpoint", path,
                     "--requests", "3", "--max-new", "4", "--device", device])
            text = out.getvalue()
            log(f"train (d) serve on {device}: {text.strip()}")
            if rc != 0 or f"restored step 2 from {path}" not in text:
                fail(f"train (d): --legacy-arch --checkpoint on {device} "
                     f"exited {rc}")
    finally:
        lm_wave.ServeEngine.generate = generate
    # the restored weights served on the card against the CPU, as phase 4
    (eng, prompts, outs), (cpu_eng, _, cpu_outs) = served["cuda"], \
        served["cpu"]
    flips = []
    for r, (got, want) in enumerate(zip(outs, cpu_outs)):
        if got == want:
            continue
        t = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        margin, scale = top2_margin(torch, cpu_eng.model, cpu_eng.params,
                                    prompts[r], want[:t])
        log(f"train (d) request {r}: token {t} is {got[t]} on the card, "
            f"{want[t]} on the CPU; CPU top-2 margin {margin:.3e} "
            f"(tolerance {LOGIT_TOL * scale:.3e})")
        if margin > LOGIT_TOL * scale:
            fail(f"train (d): request {r} differs from the CPU serve at "
                 f"token {t} beyond a near-tie")
        flips.append([r, t, margin])
    with torch.no_grad():
        lg = eng.model.prefill(eng.params, torch.tensor([prompts[0]],
                                                        device="cuda"),
                               cache_len=eng.cache_len)[0].cpu()
        lg_cpu = cpu_eng.model.prefill(cpu_eng.params,
                                       torch.tensor([prompts[0]]),
                                       cache_len=cpu_eng.cache_len)[0]
    err = rel_err(lg, lg_cpu)
    if not torch.isfinite(lg).all() or not err <= LOGIT_TOL:
        fail(f"train (d): the restored model's prefill logits differ from "
             f"the CPU's by {err} of the largest |logit| (bar {LOGIT_TOL})")
    report["checkpoint"] = {"path": path, "bit_equal": same,
                            "prefill_logits_rel_err_vs_cpu": err,
                            "near_tie_flips": flips,
                            "tokens_equal_cpu": not flips}
    log(f"train (d): checkpoint restored bit-equal; served from it, prefill "
        f"logits within {err:.3e} of the CPU's, tokens equal the CPU's: "
        f"{not flips}")
    log(f"train: {json.dumps(report, default=str)}")
    return counts


def check_ssd_backward(torch, timer) -> dict:
    """Phase 9 (e): the scan's backward kernels against autograd of the
    plain scan on the card at the trainer's shape and the edge cases, two
    runs bit-equal, the forward with the chunks' start states bit-equal to
    the forward without, then timed cold at the trainer's shape beside the
    plain backward (``ref.ssd_scan_bwd_ref``); no single PyTorch call
    computes it."""
    from repro_torch.kernels import costs, ref
    from repro_torch.kernels.ssd_scan import (ssd_scan, ssd_scan_backward,
                                              ssd_scan_forward)

    g = torch.Generator(device="cuda").manual_seed(SEED + 21)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    def inputs(b, l, h, p, grp, n):
        dt = torch.rand((b, l, h), generator=g, device="cuda") * 0.5
        A = -torch.rand((h,), generator=g, device="cuda") * 0.5
        return randn(b, l, h, p), dt, A, randn(b, l, grp, n), \
            randn(b, l, grp, n)

    def unpack(xbc, h, p, grp, n):
        """x, B and C as views of one projection at an odd offset."""
        b, l, o = xbc.shape[0], xbc.shape[1], 1 + h * p
        return (xbc[..., 1:o].view(b, l, h, p),
                xbc[..., o:o + grp * n].view(b, l, grp, n),
                xbc[..., o + grp * n:].view(b, l, grp, n))

    cases = [  # (label, b, l, h, p, groups, n, chunk, init, dfinal, packed)
        ("trainer b=8 l=128", 8, 128, 24, 64, 1, 128, 128, False, False,
         False),
        ("two chunks, init state, final grad (3, 256)", 3, 256, 24, 64, 1,
         128, 128, True, True, False),
        ("groups 2", 2, 256, 24, 64, 2, 128, 128, True, True, False),
        ("n=40 l=chunk", 2, 128, 24, 64, 1, 40, 128, False, False, False),
        ("packed projection, two chunks", 2, 256, 24, 64, 1, 128, 128,
         False, True, True),
        ("ragged p=21 n=33 chunk 24 groups 2, init", 2, 48, 4, 21, 2, 33,
         24, True, False, False),
    ]
    worst = 0.0
    for label, b, l, h, p, grp, n, q, init, dfin, packed in cases:
        x, dt, A, B, C = inputs(b, l, h, p, grp, n)
        s0 = randn(b, h, p, n) if init else None
        dy = randn(b, l, h, p)
        dfinal = randn(b, h, p, n) if dfin else None
        # the leaves: x, B and C, or the projection they are views of
        xbc = randn(b, l, 1 + h * p + 2 * grp * n) if packed else None
        ins = [t.detach().clone().requires_grad_(True)
               for t in ((xbc,) if packed else (x, B, C)) + (dt, A)
               + ((s0,) if init else ())]

        def grads(fn):
            x_, B_, C_ = unpack(ins[0], h, p, grp, n) if packed else ins[:3]
            dt_, A_ = ins[-2 - init:len(ins) - init]
            y, final = fn(x_, dt_, A_, B_, C_, q, ins[-1] if init else None)
            outs = [y] + ([final] if dfin else [])
            return torch.autograd.grad(outs, ins, [dy] + (
                [dfinal] if dfin else []))
        got = grads(ssd_scan)
        want = grads(ref.ssd_scan_ref)
        again = grads(ssd_scan)
        torch.cuda.synchronize()
        errs = grad_rel_errs(got, want)
        names = (("dxbc",) if packed else ("dx", "dB", "dC")) + (
            "ddt", "dA") + (("dinit",) if init else ())
        if not all(e <= GRAD_TOL for e in errs):
            fail(f"ssd_scan_backward {label}: relative err "
                 f"{dict(zip(names, errs))} > {GRAD_TOL}")
        if not all(torch.equal(a, c) for a, c in zip(got, again)):
            fail(f"ssd_scan_backward {label}: two runs differ")
        worst = max([worst] + [float((a - w).abs().max())
                               for a, w in zip(got, want)])
        log(f"ssd_scan_backward {label}: relative err "
            + ", ".join(f"{k} {e:.3e}" for k, e in zip(names, errs))
            + "; two runs bit-equal")

    b, l, h, p, n, q = 3, 256, 24, 64, 128, 128
    x, dt, A, B, C = inputs(b, l, h, p, 1, n)
    s0 = randn(b, h, p, n)
    y0, f0, _ = ssd_scan_forward(x, dt, A, B, C, q, s0)
    y1, f1, _ = ssd_scan_forward(x, dt, A, B, C, q, s0, with_states=True)
    torch.cuda.synchronize()
    if not (torch.equal(y0, y1) and torch.equal(f0, f1)):
        fail("ssd_scan: the forward with the chunks' states differs from "
             "the forward without")

    b, l = TRAIN_BATCH, TRAIN_SEQ             # the trainer's scan
    x, dt, A, B, C = inputs(b, l, h, p, 1, n)
    dy = randn(b, l, h, p)
    ms = timer(lambda: ssd_scan_backward(x, dt, A, B, C, q, None, dy))
    plain_ms = timer(lambda: ref.ssd_scan_bwd_ref(x, dt, A, B, C, q, None,
                                                  dy))
    fwd_ms = timer(lambda: ssd_scan(x, dt, A, B, C, q))
    log(f"ssd_scan_backward trainer shape ms: cold kernels {ms:.4f}, plain "
        f"{plain_ms:.4f}; forward cold {fwd_ms:.4f}")
    return {"name": "ssd_scan_backward", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_scan_bwd.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:64",
            "shape": f"x/dy ({b}, {l}, {h}, {p}), B/C ({b}, {l}, 1, {n}), "
                     f"chunk {q}, float32",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            # x, dt, B, C, dy read; dx, ddt, dB, dC, dA written
            **cost_bound("ssd_scan_backward", costs.ssd_scan_backward(
                b, l, h, p, 1, n, q, False, False, False),
                "3xTF32 on the tensor cores"),
            "library_ms": None, "forward_ms": fwd_ms}


SSM_TRAIN_ARGS = ["--arch", "mamba2-130m", "--batch", str(TRAIN_BATCH),
                  "--seq", str(TRAIN_SEQ)]


def train_ssm_phase(torch, drive, card: str, steps: int) -> dict:
    """Phase 9 (f): ``launch.train.main`` on Mamba2-130m at full width and
    depth (losses finite and falling, the scan's forward and backward
    kernels 24 a step; ms per step, tokens/s, peak memory, a profiled
    step), and the card against the CPU at depth 2, batch 2 x 256 (two
    chunks carry the state). Returns (b)'s launch counts."""
    import dataclasses

    import numpy as np

    from repro_torch.arch.model import TransformerLM
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig, SyntheticCorpus
    from repro_torch.launch import train as launcher
    from repro_torch.train.optimizer import leaves, unflatten

    cfg = get_config("mamba2-130m")
    stamps = []

    def record(line):
        stamps.append(time.perf_counter())
        log(f"train (f): {line}")

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    state, counts = drive(lambda: launcher.main(
        SSM_TRAIN_ARGS + ["--steps", str(steps), "--log-every", "1"],
        log_fn=record))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    losses = state.history
    if len(losses) != steps or not all(np.isfinite(losses)):
        fail(f"train (f): losses {losses} (want {steps} finite)")
    if not losses[-1] < losses[0]:
        fail(f"train (f): the loss did not fall: {losses}")
    for name in ("ssd_scan", "ssd_scan_backward"):
        if counts[name] != cfg.n_layers * steps:
            fail(f"train (f): {name} launched {counts[name]} times in "
                 f"{steps} steps, not {cfg.n_layers} a step")
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    ms = statistics.median(step_ms)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_params = sum(t.numel() for t in leaves(state.params))
    cmp = captured_vs_eager(torch, "train (f)", "mamba2-130m", state, steps,
                            {"ssd_scan": cfg.n_layers,
                             "ssd_scan_backward": cfg.n_layers})
    prof = cmp["replayed_step_profile"]
    own_us = {k: round(v["device_us"], 1)
              for k, v in prof["own_kernels"].items()}
    report = {"n_params": n_params, "steps": steps, "losses": losses,
              "step_ms": step_ms, "ms_per_step": ms,
              "tokens_per_s": tokens / ms * 1e3, "peak_bytes": peak,
              "peak_bytes_above_start": peak - base,
              "launches": counts, "profile": prof, "eager": cmp}
    FP32_TRAIN["mamba2-130m"] = report
    log(f"train (f) mamba2-130m full width and depth ({n_params} params), "
        f"batch {TRAIN_BATCH} x {TRAIN_SEQ}, the step captured (step 1 its "
        f"warm-up, then replays): {ms:.2f} ms per step (median of steps "
        f"2-{steps}), {tokens / ms * 1e3:.1f} tokens/s, peak memory "
        f"{peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} above its "
        f"start), losses {[round(x, 4) for x in losses]}; eager: "
        f"{cmp['eager_ms_per_step']:.2f} ms per step, "
        f"{cmp['eager_tokens_per_s']:.1f} tokens/s, peak above its start "
        f"{cmp['eager_peak_bytes'] / 2**30:.2f} GiB; captured against "
        f"eager: losses within {cmp['loss_rel_err_max']:.3e} relative, "
        f"worst parameter leaf {cmp['param_leaf_rel_err_max']:.3e} of its "
        f"max; profiled replayed step: busy share "
        f"{prof['busy_share']:.3f} ({prof['device_ms']:.2f} ms device of "
        f"{prof['wall_ms']:.2f} wall), {prof['device_events']} device "
        f"events, top {prof['top_events']}; scan kernels' device us "
        f"{own_us}; scan launches {counts['ssd_scan']}, "
        f"{counts['ssd_scan_backward']} ({card})")
    del state

    # card against CPU at depth 2, full width, two chunks of 128
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    cpu_model = TransformerLM(cfg2, device="cpu")
    card_model = TransformerLM(cfg2, device="cuda")
    params = cpu_model.init_params(torch.Generator().manual_seed(SEED))
    corpus = SyntheticCorpus(PipelineConfig(vocab=cfg2.vocab, seq_len=256,
                                            batch_size=2, seed=SEED))
    batch = corpus.batch(0)

    def grads(model, device):
        flat = [t.detach().to(device).requires_grad_(True)
                for t in leaves(params)]
        loss = model.loss(unflatten(params, flat),
                          {k: torch.as_tensor(a, device=device)
                           for k, a in batch.items()})
        gs = torch.autograd.grad(loss, flat)
        return float(loss.detach()), [g.cpu() for g in gs]

    card_loss, card_grads = grads(card_model, "cuda")
    cpu_loss, cpu_grads = grads(cpu_model, "cpu")
    loss_err = abs(card_loss - cpu_loss) / abs(cpu_loss)
    grad_errs = [grad_rel_err(a, b) for a, b in zip(card_grads, cpu_grads)]
    if not loss_err <= 1e-4 or not max(grad_errs) <= 2e-3:
        fail(f"train (f): card against CPU at depth 2, loss {loss_err}, "
             f"gradients {max(grad_errs)} (bars 1e-4, 2e-3)")
    report["card_vs_cpu"] = {"loss_rel_err": loss_err,
                             "grad_rel_err_max": max(grad_errs)}
    log(f"train (f) depth 2, full width, batch 2 x 256 (two chunks): loss "
        f"relative err {loss_err:.3e}, worst gradient leaf "
        f"{max(grad_errs):.3e} of its max |grad|")
    log(f"train ssm: {json.dumps(report, default=str)}")
    return counts


# -- phase 9 (h): bf16 training ------------------------------------------


# (label, B, Sq, Skv, H, KV, D, causal, window): the trainer's attention
# (Qwen2-0.5B at 8 x 128), a window, and the vision model's cross shape,
# which the next slice trains; the first and the last are timed
FLASH_BWD_BF16_CASES = [
    ("trainer B=8 S=128 G=7", 8, 128, 128, 14, 2, 64, True, 0),
    ("window 16 S=200 G=7", 1, 200, 200, 14, 2, 64, True, 16),
    ("vision cross Sq=128 Skv=1024 D=128 G=4", 8, 128, 1024, 32, 8, 128,
     False, 0),
]


def check_flash_backward_bf16(torch, timer) -> dict:
    """Phase 9 (h): the bf16 backward kernels
    (``csrc/flash_attention_bwd_bf16.cu``) through autograd at
    FLASH_BWD_BF16_CASES on bf16-exact inputs: dq, dk and dv bf16, each on
    the bf16 bar (:func:`bf16_bar`; the truth the fp32 plain backward on
    the upcast inputs, the plain one autograd of the plain bf16 forward),
    two runs bit-equal; timed cold at the trainer's and the cross shape
    beside the bf16 plain backward and the backward of bf16
    ``scaled_dot_product_attention`` with K/V expanded (a yardstick the
    port never calls), with each shape's bound."""
    from repro_torch.kernels import costs, ref
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_backward, flash_attention_forward)

    g = torch.Generator(device="cuda").manual_seed(SEED + 28)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def bf16(shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()

    def grads(fn, q, k, v, dout, causal, window):
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        fn(*leaves, causal, window).backward(dout)
        return [t.grad for t in leaves]

    worst, timed_shapes = 0.0, {}
    for label, B, Sq, Skv, H, KV, D, causal, window in FLASH_BWD_BF16_CASES:
        q, k, v = bf16((B, Sq, H, D)), bf16((B, Skv, KV, D)), \
            bf16((B, Skv, KV, D))
        dout = bf16((B, Sq, H, D))
        got = grads(flash_attention, q, k, v, dout, causal, window)
        again = grads(flash_attention, q, k, v, dout, causal, window)
        plain = grads(ref.flash_attention_ref, q, k, v, dout, causal, window)
        truth = ref.flash_attention_backward_ref(
            q.float(), k.float(), v.float(), dout.float(), causal, window)
        torch.cuda.synchronize()
        if any(t.dtype != torch.bfloat16 for t in got):
            fail(f"flash_attention_backward_bf16 {label}: gradients "
                 f"{[t.dtype for t in got]}")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"flash_attention_backward_bf16 {label}: two runs differ")
        bars = [bf16_bar(f"flash_attention_backward_bf16 {label} {n}", a, p,
                         t)
                for n, a, p, t in zip(("dq", "dk", "dv"), got, plain, truth)]
        worst = max([worst] + [b["err"] for b in bars])
        log(f"flash_attention_backward_bf16 {label}: "
            + ", ".join(f"{n} max abs err {b['err']:.3e} (plain bf16 "
                        f"{b['plain_err']:.3e}; relative {b['rel_err']:.3e})"
                        for n, b in zip(("dq", "dk", "dv"), bars))
            + "; two runs bit-equal")
        if window:
            continue
        out, lse = flash_attention_forward(q, k, v, causal, window,
                                           with_lse=True)
        qt = q.transpose(1, 2).contiguous().requires_grad_(True)
        kt, vt = (t.repeat_interleave(H // KV, dim=2).transpose(1, 2)
                  .contiguous().requires_grad_(True) for t in (k, v))
        ot = sdpa(qt, kt, vt, is_causal=causal)
        dt_ = dout.transpose(1, 2).contiguous()

        def library():
            torch.autograd.grad(ot, (qt, kt, vt), dt_, retain_graph=True)

        w = timed_shapes[label] = {
            "shape": f"q/o/dO ({B}, {Sq}, {H}, {D}), k/v ({B}, {Skv}, {KV}, "
                     f"{D}) bfloat16, {'causal' if causal else 'non-causal'}",
            "ms": timer(lambda: flash_attention_backward(
                q, k, v, out, dout, lse, causal, window)),
            "plain_ms": timer(lambda: ref.flash_attention_backward_ref(
                q, k, v, dout, causal, window)),
            "library_ms": timer(library),
            **cost_bound(f"flash_attention_backward_bf16 {label}",
                         costs.flash_attention_backward(
                             B, Sq, Skv, H, KV, D, causal, window, 2),
                         "bf16 on the tensor cores")}
        log(f"flash_attention_backward_bf16 {label} ms: cold kernel "
            f"{w['ms']:.4f}, plain bf16 autograd {w['plain_ms']:.4f}, "
            f"scaled_dot_product_attention bf16 backward "
            f"{w['library_ms']:.4f}, bound {w['bound_ms']:.6f} "
            f"({w['bound_by']})")
        if label.startswith("trainer"):
            log(f"scaled_dot_product_attention bf16 backward runs: "
                f"{library_kernels(torch, library)}")
        del ot, qt, kt, vt
    row, cross = timed_shapes[FLASH_BWD_BF16_CASES[0][0]], \
        timed_shapes[FLASH_BWD_BF16_CASES[-1][0]]
    return {"name": "flash_attention_backward_bf16", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_bwd_bf16.cu",
            "replaces": "src/repro/kernels/flash_attention.py:65",
            "max_abs_err": worst, **row, "cross": cross}


# (label, b, l, h, p, groups, n, chunk, init, dfinal): the trainer's scan
# (Mamba2-130m at 8 x 128, one chunk; timed) and two chunks carrying the
# state from an initial state with a final-state gradient
SSD_BWD_BF16_CASES = [
    ("trainer b=8 l=128", 8, 128, 24, 64, 1, 128, 128, False, False),
    ("two chunks, init state, final grad (3, 256)", 3, 256, 24, 64, 1, 128,
     128, True, True),
]


def check_ssd_backward_bf16(torch, timer) -> dict:
    """Phase 9 (h): the bf16 backward kernels (``csrc/ssd_scan_bwd_bf16.cu``)
    through autograd at SSD_BWD_BF16_CASES on bf16-exact inputs: dx, ddt,
    dB, dC bf16 and dA, dinit fp32, each on the bf16 bar (the truth autograd
    of the fp32 plain scan on the upcast inputs, the plain one autograd of
    the plain bf16 scan), two runs bit-equal; timed cold at the trainer's
    shape beside the plain backward on the same bf16 inputs
    (``ref.ssd_scan_bwd_ref``; no PyTorch call computes it)."""
    from repro_torch.kernels import costs, ref
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_backward

    g = torch.Generator(device="cuda").manual_seed(SEED + 29)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    worst = 0.0
    for label, b, l, h, p, grp, n, q, init, dfin in SSD_BWD_BF16_CASES:
        x, B, C, dy = randn(b, l, h, p), randn(b, l, grp, n), \
            randn(b, l, grp, n), randn(b, l, h, p)
        dt = (torch.rand((b, l, h), generator=g, device="cuda")
              * 0.5).bfloat16()
        A = -torch.rand((h,), generator=g, device="cuda") * 0.5
        s0 = randn(b, h, p, n, dtype=torch.float32) if init else None
        dfinal = randn(b, h, p, n, dtype=torch.float32) if dfin else None

        def grads(fn, up=False):
            ins = [t.detach().clone().float() if up and t.dtype ==
                   torch.bfloat16 else t.detach().clone()
                   for t in (x, dt, A, B, C) + ((s0,) if init else ())]
            for t in ins:
                t.requires_grad_(True)
            y, final = fn(*ins[:5], q, ins[5] if init else None)
            outs, gs = [y], [dy.float() if up else dy]
            if dfin:
                outs.append(final)
                gs.append(dfinal)
            return torch.autograd.grad(outs, ins, gs)

        got, again = grads(ssd_scan), grads(ssd_scan)
        plain, truth = grads(ref.ssd_scan_ref), grads(ref.ssd_scan_ref, True)
        torch.cuda.synchronize()
        names = ("dx", "ddt", "dA", "dB", "dC") + (("dinit",) if init else ())
        want = [torch.bfloat16, torch.bfloat16, torch.float32,
                torch.bfloat16, torch.bfloat16] + [torch.float32] * init
        if [t.dtype for t in got] != want:
            fail(f"ssd_scan_backward_bf16 {label}: gradients "
                 f"{[t.dtype for t in got]}")
        if not all(torch.equal(a, c) for a, c in zip(got, again)):
            fail(f"ssd_scan_backward_bf16 {label}: two runs differ")
        bars = [bf16_bar(f"ssd_scan_backward_bf16 {label} {nm}", a, pl, t)
                for nm, a, pl, t in zip(names, got, plain, truth)]
        worst = max([worst] + [bar["err"] for bar in bars])
        log(f"ssd_scan_backward_bf16 {label}: "
            + ", ".join(f"{nm} {bar['err']:.3e} (plain bf16 "
                        f"{bar['plain_err']:.3e}; relative "
                        f"{bar['rel_err']:.3e})"
                        for nm, bar in zip(names, bars))
            + "; two runs bit-equal")

    b, l, h, p, grp, n, q = SSD_BWD_BF16_CASES[0][1:8]
    x, B, C, dy = randn(b, l, h, p), randn(b, l, grp, n), \
        randn(b, l, grp, n), randn(b, l, h, p)
    dt = (torch.rand((b, l, h), generator=g, device="cuda") * 0.5).bfloat16()
    A = -torch.rand((h,), generator=g, device="cuda") * 0.5
    ms = timer(lambda: ssd_scan_backward(x, dt, A, B, C, q, None, dy))
    plain_ms = timer(lambda: ref.ssd_scan_bwd_ref(x, dt, A, B, C, q, None,
                                                  dy))
    log(f"ssd_scan_backward_bf16 trainer shape ms: cold kernels {ms:.4f}, "
        f"plain {plain_ms:.4f}")
    return {"name": "ssd_scan_backward_bf16", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_scan_bwd_bf16.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:64",
            "shape": f"x/dy ({b}, {l}, {h}, {p}), B/C ({b}, {l}, {grp}, "
                     f"{n}), chunk {q}, bfloat16",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            **cost_bound("ssd_scan_backward_bf16", costs.ssd_scan_backward(
                b, l, h, p, grp, n, q, False, False, False, 2),
                "bf16 on the tensor cores"),
            "library_ms": None}


# model -> (its kernels' wrappers and each one's launches a layer a step,
# the depth-2 card-against-CPU batch (B, S): Mamba2's over two chunks of
# 128); the last kernel named is the bf16 backward the model's path
# reports
BF16_TRAIN = {"qwen2-0.5b": ({"flash_attention_bf16": 1,
                              "flash_attention_backward_bf16": 1}, (2, 32)),
              "mamba2-130m": ({"ssd_scan_bf16": 1,
                               "ssd_scan_backward_bf16": 1}, (2, 256)),
              "granite-moe-1b-a400m": ({"flash_attention_bf16": 1,
                                        "flash_attention_backward_bf16": 1,
                                        "gather_rows": 2,
                                        "gather_rows_backward_bf16": 2},
                                       (2, 32))}
FP32_KERNELS = ("flash_attention", "flash_attention_backward", "ssd_scan",
                "ssd_scan_backward", "gather_rows_backward")


def train_bf16_phase(torch, drive, card: str, steps: int) -> dict:
    """Phase 9 (h): Qwen2-0.5B and Mamba2-130m as ``TransformerLM(cfg,
    torch.bfloat16)`` at full width and depth (the launcher's seed-0 fp32
    weights rounded once), ``steps`` steps of ``train/loop.py:train`` at
    TRAIN_BATCH x TRAIN_SEQ with the launcher's schedule, the step captured
    (step 1 its warm-up), then the same steps eagerly: every loss and, after
    the last step, every parameter leaf bit-equal; losses finite and
    falling; the bf16 forward and backward kernels' counters up by the
    layers a step each, the fp32 kernels' not at all; ms per step (median
    of steps 2 on), tokens/s and peak memory of both, one profiled replayed
    step (busy share, device events, launches by kernel), each beside (b)'s
    or (f)'s fp32 step; the full-depth bf16 losses against the fp32 run's,
    reported. Then depth 2 at full width, card against the CPU (BF16_TRAIN's
    batch): the card's bf16 loss and every gradient leaf on the bf16 bar
    against the CPU's fp32 model on the same bf16-exact weights (within
    twice the CPU's plain bf16 model's error). Returns each model's launch
    counts of its captured run."""
    import dataclasses

    import numpy as np

    from repro_torch.arch.model import TransformerLM, tree_map
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig, SyntheticCorpus
    from repro_torch.kernels.launches import WRAPPERS
    from repro_torch.train.loop import StaticTrainStep, train
    from repro_torch.train.optimizer import AdamWConfig, leaves, unflatten

    out = {}
    for arch, (kernels, (cB, cS)) in BF16_TRAIN.items():
        cfg = get_config(arch)
        opt = AdamWConfig(lr=1e-3, warmup_steps=max(steps // 20, 5),
                          total_steps=steps)
        p16 = tree_map(lambda t: t.to("cuda", torch.bfloat16), TransformerLM(
            cfg, device="cpu").init_params(torch.Generator().manual_seed(0)))
        model = TransformerLM(cfg, torch.bfloat16, device="cuda")
        runs = {}
        for capture in (True, False):
            stamps = []

            def record(line, capture=capture):
                stamps.append(time.perf_counter())
                if capture:
                    log(f"train (h) {arch} bf16: {line}")

            pipe = SyntheticCorpus(PipelineConfig(
                vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH,
                seed=0))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            state, counts = drive(lambda: train(
                model, p16, iter(pipe), steps, opt, log_every=1,
                log_fn=record, capture=capture))
            torch.cuda.synchronize()
            runs[capture] = {
                "state": state, "counts": counts,
                "peak_bytes_above_start":
                    torch.cuda.max_memory_allocated() - base,
                "ms_per_step": statistics.median(
                    (b - a) * 1e3 for a, b in zip(stamps, stamps[1:]))}
        cap, eager = runs[True], runs[False]
        losses = cap["state"].history
        if len(losses) != steps or not all(np.isfinite(losses)) or \
                not losses[-1] < losses[0]:
            fail(f"train (h) {arch} bf16: losses {losses} (want {steps} "
                 f"finite and falling)")
        if losses != eager["state"].history or not all(
                torch.equal(a, b) for a, b in zip(
                    leaves(cap["state"].params),
                    leaves(eager["state"].params))):
            fail(f"train (h) {arch} bf16: the captured steps differ from "
                 f"the eager ones (losses {losses} against "
                 f"{eager['state'].history})")
        if {t.dtype for t in leaves(cap["state"].params)} != {torch.bfloat16}:
            fail(f"train (h) {arch} bf16: a parameter leaf is not bf16")
        want = {k: kernels.get(k, 0) * cfg.n_layers * steps
                for k in tuple(kernels) + FP32_KERNELS}
        for run in (cap, eager):
            got = {k: run["counts"][k] for k in want}
            if got != want:
                fail(f"train (h) {arch} bf16: launches {got}, not {want}")
        # one replayed step over the trained state, profiled
        step = StaticTrainStep(model, opt, cap["state"].params,
                               cap["state"].opt)
        corpus = SyntheticCorpus(PipelineConfig(
            vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH,
            seed=SEED))
        batch = corpus.batch(steps)
        step(batch)                                  # warm-up and capture
        before = {k: WRAPPERS[k].launches for k in kernels}
        prof = profile_run(torch, lambda: step(batch))
        moved = {k: WRAPPERS[k].launches - before[k] for k in kernels}
        if moved != {k: n * cfg.n_layers for k, n in kernels.items()}:
            fail(f"train (h) {arch} bf16: the profiled replayed step moved "
                 f"the counters by {moved}")
        eager_ms, eager_peak = eager["ms_per_step"], \
            eager["peak_bytes_above_start"]
        del step, runs, eager
        fp32 = FP32_TRAIN.get(arch, {})
        tokens = TRAIN_BATCH * TRAIN_SEQ
        own = {k: [v["launches"], round(v["device_us"], 1)]
               for k, v in prof["own_kernels"].items()}
        f_prof = fp32.get("profile", {})
        f_eager = (fp32.get("eager") or {}).get("eager_ms_per_step",
                                                float("nan"))
        report = {
            "steps": steps, "losses": losses,
            "ms_per_step": cap["ms_per_step"],
            "tokens_per_s": tokens / cap["ms_per_step"] * 1e3,
            "peak_bytes_above_start": cap["peak_bytes_above_start"],
            "eager_ms_per_step": eager_ms,
            "eager_peak_bytes_above_start": eager_peak,
            "launches": cap["counts"], "profile": prof,
            "fp32": {k: fp32.get(k) for k in ("ms_per_step", "tokens_per_s",
                                              "peak_bytes_above_start",
                                              "losses")}}
        out[arch] = report
        log(f"train (h) {arch} bf16 full width and depth, batch "
            f"{TRAIN_BATCH} x {TRAIN_SEQ}, the step captured: "
            f"{cap['ms_per_step']:.2f} ms per step (fp32 "
            f"{fp32.get('ms_per_step', float('nan')):.2f}), "
            f"{report['tokens_per_s']:.1f} tokens/s (fp32 "
            f"{fp32.get('tokens_per_s', float('nan')):.1f}), peak above its "
            f"start {cap['peak_bytes_above_start'] / 2**30:.2f} GiB (fp32 "
            f"{fp32.get('peak_bytes_above_start', float('nan')) / 2**30:.2f}"
            f"); eager {eager_ms:.2f} ms per step (fp32 {f_eager:.2f}), "
            f"peak {eager_peak / 2**30:.2f} GiB; captured against eager "
            f"bit-equal (losses and every leaf); profiled replayed step: "
            f"busy share {prof['busy_share']:.3f} (fp32 "
            f"{f_prof.get('busy_share', float('nan')):.3f}), "
            f"{prof['device_events']} device events (fp32 "
            f"{f_prof.get('device_events')}), {prof['device_ms']:.2f} ms "
            f"device of {prof['wall_ms']:.2f} wall; launches by kernel "
            f"[launches, device us] {own}; bf16 losses "
            f"{[round(x, 4) for x in losses]} against fp32 "
            f"{[round(x, 4) for x in fp32.get('losses') or []]} (a report, "
            f"no bar); launches {({k: cap['counts'][k] for k in want})} "
            f"({card})")
        del p16, cap, model
        gc.collect()
        torch.cuda.empty_cache()

        # depth 2 at full width: card against the CPU on the bf16 bar
        cfg2 = dataclasses.replace(cfg, n_layers=2)
        w16 = tree_map(lambda t: t.to(torch.bfloat16), TransformerLM(
            cfg2, device="cpu").init_params(
                torch.Generator().manual_seed(SEED)))
        corpus = SyntheticCorpus(PipelineConfig(vocab=cfg2.vocab, seq_len=cS,
                                                batch_size=cB, seed=SEED))
        batch = corpus.batch(0)

        def grads(model, params, device):
            flat = [t.detach().to(device).requires_grad_(True)
                    for t in leaves(params)]
            with RoutingRecorder() as rec:
                loss = model.loss(unflatten(params, flat),
                                  {k: torch.as_tensor(a, device=device)
                                   for k, a in batch.items()})
            gs = torch.autograd.grad(loss, flat)
            return [loss.detach().cpu()] + [g.cpu() for g in gs], rec

        got, card_rec = grads(TransformerLM(cfg2, torch.bfloat16,
                                            device="cuda"), w16, "cuda")
        plain, cpu_rec = grads(TransformerLM(cfg2, torch.bfloat16,
                                             device="cpu"), w16, "cpu")
        truth, _ = grads(TransformerLM(cfg2, device="cpu"),
                         tree_map(lambda t: t.float(), w16), "cpu")
        routing = routing_divergence(card_rec, cpu_rec)
        names = ["loss"] + leaf_names(w16)
        bars = {nm: bf16_bar(f"train (h) {arch} bf16 depth 2 {nm}", a, p_, t,
                             kernel=False, routing=routing)
                for nm, a, p_, t in zip(names, got, plain, truth)}
        ratio = {nm: b["err"] / b["plain_err"] if b["plain_err"] else 0.0
                 for nm, b in bars.items()}
        top = max(ratio, key=ratio.get)
        report["card_vs_cpu"] = {"loss": bars["loss"],
                                 "worst_leaf": [top, ratio[top]],
                                 "routing_vs_cpu": routing}
        log(f"train (h) {arch} bf16 depth 2, full width, batch {cB} x {cS}: "
            f"loss error against the CPU fp32 model {bars['loss']['err']:.3e}"
            f" (CPU plain bf16 {bars['loss']['plain_err']:.3e}); worst leaf "
            f"{top}: {ratio[top]:.3f} of the CPU plain bf16 model's error "
            f"(bar 2)"
            + (f"; routing against the CPU's bf16 model: {routing['calls']} "
               f"MoE calls, {routing_summary(routing)}"
               if routing["calls"] else ""))
        log(f"train bf16 {arch}: {json.dumps(report, default=str)}")
    return out


# -- phase 10 -------------------------------------------------------------


# TreeGRU at phase 5's width on 16-instance minibatches, trained as
# examples/tree_classifier_torch.py trains it (its internal cell's buffer,
# SGD at lr 0.05), five steps.
EXEC_TRAIN_STEPS = 5


def check_gather_backward(torch, timer, path_shape) -> dict:
    """Phase 10 (a): the gather's backward kernel against the plain
    version on the card (bit-equal to the plain version on the CPU, whose
    ``index_add_`` sums in ascending k as both of the kernel's paths do),
    at the path's shapes, the one-launch path's edges and past them; then
    timed cold at the path's rows (K = 1, 16, 256, 512, and 2048 and 2049,
    the threshold's edges) and at ``path_shape``, the commonest (K, n_src,
    row bytes) of phase 10 (b), each beside ``torch.zeros(...).index_add_``
    (a yardstick the port never calls)."""
    from repro_torch.kernels import costs, ref
    from repro_torch.kernels.gather_batch import (backward_geometry,
                                                  gather_rows_backward)

    g = torch.Generator(device="cuda").manual_seed(SEED + 10)
    cases = [  # (label, src shape, K, indices)
        ("path K=1", (2048, MODEL_SIZE), 1, "perm"),
        ("path K=16", (2048, MODEL_SIZE), 16, "perm"),
        ("path K=256", (2048, MODEL_SIZE), 256, "perm"),
        ("path K=512", (2048, MODEL_SIZE), 512, "perm"),
        ("K=256 repeated and negative", (2048, MODEL_SIZE), 256, "repeats"),
        ("flat (d, d) rows", (512, 32, 32), 128, "repeats"),
        ("4-byte units D=17", (512, 17), 100, "repeats"),
        ("K=2048, the one-launch threshold", (2048, MODEL_SIZE), 2048,
         "random"),
        ("K=2049, one above: sorted", (2048, MODEL_SIZE), 2049, "random"),
        ("n_src not a multiple of a block's rows", (2047, MODEL_SIZE), 300,
         "repeats"),
        ("every index on one row", (2048, MODEL_SIZE), 256, "one row"),
        ("trash row (-1)", (1001, MODEL_SIZE), 256, "trash"),
        ("K=5000, past one sort tile", (8192, 16), 5000, "perm"),
    ]

    def indices(n, K, kind):
        if kind == "perm":
            return torch.randperm(n, generator=g, device="cuda")[:K].to(
                torch.int32)
        idx = torch.randint(0, n, (K,), generator=g, device="cuda",
                            dtype=torch.int32)
        if kind == "one row":
            idx[:] = idx[0]
        elif kind == "trash":
            idx[torch.rand((K,), generator=g, device="cuda") < 0.5] = -1
        elif kind == "repeats":
            idx[: K // 3] = idx[0]
            idx[K // 3] = -1
            idx[K // 3 + 1] = -n
        return idx

    def path_of(K, n, row_bytes):
        plan = backward_geometry(K, n, row_bytes, 16 if row_bytes % 16 == 0
                                 else 4)
        return plan["path"] + (f", {plan['rows_per_block']} rows a block"
                               if plan["path"] == "one pass" else "")

    worst = 0.0
    for label, shape, K, kind in cases:
        idx = indices(shape[0], K, kind)
        dout = torch.randn((K,) + shape[1:], generator=g, device="cuda")
        got = gather_rows_backward(dout, idx, shape[0])
        again = gather_rows_backward(dout, idx, shape[0])
        want = ref.gather_rows_bwd_ref(dout, idx, shape[0])
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail(f"gather_rows_backward {label}: two runs differ")
        if not torch.equal(got.cpu(), ref.gather_rows_bwd_ref(
                dout.cpu(), idx.cpu(), shape[0])):
            fail(f"gather_rows_backward {label}: not bit-equal to the plain "
                 f"version on the CPU")
        err = grad_rel_err(got, want)
        worst = max(worst, float((got - want).abs().max()))
        # the card's index_add_ sums repeats in another order each run: a
        # pile of hundreds on one row (one row, trash) moves its sum by up
        # to about 1e-6, so those are held to the CPU's bits alone
        repeats = kind != "perm"
        if kind in ("repeats", "random") and not err <= 1e-6:
            fail(f"gather_rows_backward {label}: relative err {err} > 1e-6")
        if not repeats and not torch.equal(got, want):
            fail(f"gather_rows_backward {label}: not bit-equal to the plain "
                 f"version (relative err {err})")
        row_bytes = 4 * dout[0].numel()
        log(f"gather_rows_backward {label}: {tuple(shape)} K={K} "
            f"({path_of(K, shape[0], row_bytes)}): bit-equal to the CPU; "
            + (f"relative err {err:.3e} to the card's index_add_"
               if repeats else "bit-equal to the card's index_add_")
            + "; two runs bit-equal")

    N, D = 2048, MODEL_SIZE
    timed = [(K, N, 4 * D) for K in (1, 16, 256, 512, 2048, 2049)]
    if path_shape is not None and path_shape not in timed:
        timed.append(path_shape)
    times = {}
    for K, n, row_bytes in timed:
        idx = torch.randint(0, n, (K,), generator=g, device="cuda",
                            dtype=torch.int32)
        idx_long = idx.long()
        dout = torch.randn((K, row_bytes // 4), generator=g, device="cuda")
        ms = timer(lambda: gather_rows_backward(dout, idx, n))
        library_ms = timer(lambda: torch.zeros(
            (n, row_bytes // 4), device="cuda").index_add_(0, idx_long, dout))
        times[(K, n, row_bytes)] = (ms, library_ms)
        log(f"gather_rows_backward timed K={K} into ({n}, {row_bytes // 4}) "
            f"({path_of(K, n, row_bytes)}"
            + (", the path's commonest" if (K, n, row_bytes) == path_shape
               else "")
            + f"): cold kernel {ms:.5f} ms, zeros + index_add_ "
            f"{library_ms:.5f} ms")
    K = 256
    idx = torch.randint(0, N, (K,), generator=g, device="cuda",
                        dtype=torch.int32)
    dout = torch.randn((K, D), generator=g, device="cuda")
    plain_ms = timer(lambda: ref.gather_rows_bwd_ref(dout, idx, N))
    ms, library_ms = times[(K, N, 4 * D)]
    log(f"gather_rows_backward ({N}, {D}) K={K} ms: cold kernel {ms:.5f}, "
        f"plain {plain_ms:.5f}, zeros + index_add_ {library_ms:.5f}")
    return {"name": "gather_rows_backward", "route": "cuda",
            "source": "src/repro_torch/csrc/gather_rows_bwd.cu",
            "replaces": "src/repro/kernels/gather_batch.py:26",
            "shape": f"dout ({K}, {D}) float32 into dsrc ({N}, {D})",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            # dout and idx read once, dsrc written once
            **cost_bound("gather_rows_backward",
                         costs.gather_rows_backward(K, N, 4 * D, 4)),
            "library_ms": library_ms}


def executor_train_phase(torch, drive, card: str) -> dict:
    """Phase 10 (b) and (c): TreeGRU at width 512 trained through
    DynamicExecutor on the card against the CPU, CompiledPlan's gradients
    against DynamicExecutor's on the card, and the tree_classifier example
    on the card. Returns (b)'s launch counts."""
    import contextlib
    import importlib.util
    import io

    import numpy as np

    from repro_torch.core.batching import resolve_schedule
    from repro_torch.core.executor import DynamicExecutor
    from repro_torch.core.plan import CompiledPlan
    from repro_torch.core.rl import RLConfig, train_fsm
    from repro_torch.models.workloads import make_workload

    spec = importlib.util.spec_from_file_location(
        "tree_classifier_torch", ROOT / "examples" / "tree_classifier_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    rl_iters = TREES_LATTICES["TreeGRU"][0]
    rng = random.Random(SEED)
    cpu_wl = make_workload("TreeGRU", MODEL_SIZE, SEED, device="cpu")
    card_wl = make_workload("TreeGRU", MODEL_SIZE, SEED, device="cuda")
    policy = train_fsm([cpu_wl.sample_graph(rng, 2) for _ in range(3)],
                       RLConfig(max_iters=rl_iters, seed=SEED)).policy
    graphs = [cpu_wl.sample_graph(rng, BATCH)
              for _ in range(EXEC_TRAIN_STEPS)]
    init = cpu_wl.cells["TreeGRU-Internal"].init_params(
        np.random.default_rng(1), device="cpu")

    def steps(wl, device, executor):
        """EXEC_TRAIN_STEPS SGD steps; losses, gradients and ms a step."""
        params = init.to(device)
        losses, grads, ms = [], [], []
        for g in graphs:
            roots, labels = example.labelled_roots(g)
            leaf = params.detach().requires_grad_(True)
            t = time.perf_counter()
            out = executor(wl, g)({"I": leaf})
            logp = torch.log_softmax(out.field("y", roots), dim=-1)
            labels = torch.as_tensor(labels, device=device)
            loss = -logp[torch.arange(len(roots), device=device),
                         labels].mean()
            gr, = torch.autograd.grad(loss, [leaf])
            params = leaf.detach() - 0.05 * gr
            losses.append(float(loss.detach()))
            ms.append((time.perf_counter() - t) * 1e3)
            grads.append(gr.cpu())
        return losses, grads, ms

    def dynamic(wl, g):
        ex = DynamicExecutor(wl.impls, None, device=wl_device(wl))
        return lambda p: ex.run(g, policy, params=p)

    def compiled(wl, g):
        plan = CompiledPlan(g, resolve_schedule(g, policy), wl.impls,
                            device=wl_device(wl))
        return lambda p: plan.execute(g, params=p)

    def wl_device(wl):
        return "cpu" if wl is cpu_wl else "cuda"

    from repro_torch.kernels.gather_batch import gather_rows_backward

    (card_l, card_g, card_ms), counts = drive(
        lambda: steps(card_wl, "cuda", dynamic))
    if counts["gather_rows_backward"] <= 0:
        fail("gather_rows_backward was not launched while TreeGRU trained "
             "through DynamicExecutor")
    bwd_shapes = gather_rows_backward.shapes.most_common()
    log(f"gather backward shapes TreeGRU [K, n_src, row bytes, launches]: "
        f"{[list(k) + [v] for k, v in bwd_shapes]}")
    counts["commonest_backward_shape"] = bwd_shapes[0][0]
    cpu_l, cpu_g, cpu_ms = steps(cpu_wl, "cpu", dynamic)
    loss_errs = [abs(a - b) / abs(b) for a, b in zip(card_l, cpu_l)]
    grad_errs = [grad_rel_err(a, b) for a, b in zip(card_g, cpu_g)]
    if not max(loss_errs) <= 1e-4 or not max(grad_errs) <= 2e-3:
        fail(f"train (10b): card against CPU, losses {max(loss_errs)}, "
             f"gradients {max(grad_errs)} (bars 1e-4, 2e-3)")
    plan_l, plan_g, plan_ms = steps(card_wl, "cuda", compiled)
    plan_errs = [grad_rel_err(a, b) for a, b in zip(plan_g, card_g)]
    if not max(plan_errs) <= 1e-4:
        fail(f"train (10b): CompiledPlan's gradients {max(plan_errs)} of "
             f"DynamicExecutor's (bar 1e-4)")
    log(f"train (10b) TreeGRU width {MODEL_SIZE}, {BATCH} trees a step, "
        f"{EXEC_TRAIN_STEPS} SGD steps through DynamicExecutor: losses "
        f"{[round(x, 5) for x in card_l]} (card), relative to the CPU "
        f"{max(loss_errs):.3e}, gradients {max(grad_errs):.3e} of their max; "
        f"ms per step (forward and backward, host clock) card "
        f"{[round(x, 2) for x in card_ms]}, CPU {[round(x, 1) for x in cpu_ms]}"
        f"; CompiledPlan on the card {[round(x, 2) for x in plan_ms]} ms "
        f"(each step lowers its graph, and runs eagerly: autograd records "
        f"it, and a replayed graph records nothing), gradients "
        f"{max(plan_errs):.3e} of "
        f"DynamicExecutor's; launches {counts} ({card})")

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        losses = example.main(["--device", "cuda"])
    log("train (10c) examples/tree_classifier_torch.py on the card: "
        + " | ".join(out.getvalue().strip().splitlines()))
    if not losses[-1] < losses[0]:
        fail(f"train (10c): the example's loss did not improve: "
             f"{losses[0]} -> {losses[-1]}")
    return counts


# -- MoE and cross-attention (phases 2, 4, 9 and 11) -------------------------


# The MoE layer's shapes on the slice's paths: (label, tokens N, groups G)
# at a wave's decode step (one group of its six rows), a prefill of 4 x 96
# prompts and, for Granite, the train step at batch 8 x 128.
MOE_SHAPES = {
    "granite-moe-1b-a400m": [("decode B=6", 6, 1), ("prefill 4 x 96", 384, 4),
                             ("train 8 x 128", 1024, 8)],
    "olmoe-1b-7b": [("decode B=6", 6, 1), ("prefill 4 x 96", 384, 4)],
}
# A routing that differs between the card and the CPU is accepted only
# where the first layer it differs in chose between two experts whose
# router probabilities (the K-th and (K+1)-th of a token) were this close.
ROUTING_TIE = 1e-5
# In a bf16 model the router's logits are bf16 GEMM outputs, which the card
# and the CPU may each round one ulp apart: there the bar is the logit gap
# (log p_K - log p_(K+1)) within this many bf16 ulps of the larger logit,
# 2^(floor(log2 |l|) - 7) each.
BF16_ROUTING_ULPS = 2


def bf16_ulp(torch, logit):
    """One bf16 ulp at each |logit| (8 bits of significand)."""
    return torch.exp2(torch.floor(torch.log2(logit.abs().clamp_min(
        2.0 ** -126))) - 7)


class RoutingRecorder:
    """While active, records every MoE routing (``moe_route``) on the
    host, in call order: each token's experts, sorted, the gap between its
    K-th and (K+1)-th router probability (inf where K = E), and, for a bf16
    router, the gap between those two logits in bf16 ulps of the larger
    (:data:`BF16_ROUTING_ULPS`). Eager runs only: a replayed graph runs no
    Python."""

    def __init__(self):
        self.calls = []
        self.bf16 = False

    def __enter__(self):
        import torch
        from repro_torch.arch import layers

        self._route = route = layers.moe_route
        calls = self.calls

        def recording(p, x, cfg, n_groups=1):
            r = route(p, x, cfg, n_groups)
            K = cfg.experts_per_token
            top = r["probs"].detach().sort(dim=-1, descending=True).values
            gap = (top[:, K - 1] - top[:, K] if K < cfg.n_experts
                   else torch.full_like(top[:, 0], float("inf")))
            ulps = None
            if p["router"].dtype == torch.bfloat16:
                self.bf16 = True
                lg = (x.detach() @ p["router"].detach()).float().sort(
                    dim=-1, descending=True).values
                if K < cfg.n_experts:
                    a, b = lg[:, K - 1], lg[:, K]
                    ulps = (a - b) / bf16_ulp(torch, torch.maximum(
                        a.abs(), b.abs()))
                else:
                    ulps = torch.full_like(lg[:, 0], float("inf"))
                ulps = ulps.cpu()
            calls.append((r["expert_idx"].sort(dim=-1).values.cpu(),
                          gap.cpu(), ulps))
            return r

        layers.moe_route = recording
        return self

    def __exit__(self, *exc):
        from repro_torch.arch import layers

        layers.moe_route = self._route

    def min_gap(self):
        return min((float(g.min()) for _, g, _ in self.calls), default=None)

    def min_ulps(self):
        return min((float(u.min()) for _, _, u in self.calls
                    if u is not None), default=None)

    def within_bar(self) -> int:
        """Tokens of every call whose logit gap is within the bf16 bar."""
        return sum(int((u <= BF16_ROUTING_ULPS).sum())
                   for _, _, u in self.calls if u is not None)


def routing_divergence(card: RoutingRecorder, cpu: RoutingRecorder) -> dict:
    """Where two runs of the same schedule first route differently: the
    index of the first MoE call whose experts differ for some token, how
    many tokens, and the largest of their gaps on the CPU (None where the
    routings agree throughout); with the smallest gap of the CPU run. A
    bf16 run (``bf16``) also gives the gaps in ulps: the smallest, the
    largest at the first differing call and the tokens within the bar."""
    out = {"calls": len(cpu.calls), "min_gap": cpu.min_gap(),
           "first_differing_call": None, "tokens_differing": 0,
           "gap_at_flip": None, "bf16": cpu.bf16}
    if cpu.bf16:
        out.update(min_gap_ulps=cpu.min_ulps(), ulps_at_flip=None,
                   tokens_within_bar=cpu.within_bar())
    if len(card.calls) != len(cpu.calls):
        fail(f"routing: {len(card.calls)} MoE calls on the card, "
             f"{len(cpu.calls)} on the CPU")
    for i, ((a, _, _), (b, gap, ulps)) in enumerate(zip(card.calls,
                                                        cpu.calls)):
        rows = (a != b).any(-1)
        if bool(rows.any()):
            out.update(first_differing_call=i,
                       tokens_differing=int(rows.sum()),
                       gap_at_flip=float(gap[rows].max()))
            if ulps is not None:
                out["ulps_at_flip"] = float(ulps[rows].max())
            break
    return out


def routing_tie(routing: dict | None) -> bool:
    """The routings differ, first at a near-tie: within ROUTING_TIE of
    probability, or in a bf16 run within BF16_ROUTING_ULPS of the logit."""
    if not routing or routing["first_differing_call"] is None:
        return False
    if routing["bf16"]:
        return routing["ulps_at_flip"] <= BF16_ROUTING_ULPS
    return routing["gap_at_flip"] <= ROUTING_TIE


def routing_gap(routing: dict) -> str:
    """The gap at the first differing call, in the run's own terms."""
    if routing["bf16"]:
        return (f"a logit gap of {routing['ulps_at_flip']:.3f} bf16 ulps "
                f"(bar {BF16_ROUTING_ULPS})")
    return f"a top-K gap of {routing['gap_at_flip']:.3e}"


def routing_summary(routing: dict) -> str:
    """The smallest gap and, in bf16, the tokens within the bar."""
    if routing["bf16"]:
        flip = routing["first_differing_call"]
        return (f"smallest logit gap {routing['min_gap_ulps']:.3f} bf16 "
                f"ulps, {routing['tokens_within_bar']} tokens within "
                f"{BF16_ROUTING_ULPS} ulps, first differing call {flip}"
                + ("" if flip is None else
                   f" ({routing['tokens_differing']} tokens, the largest "
                   f"logit gap among them {routing['ulps_at_flip']:.3f} "
                   f"ulps)"))
    return f"smallest top-K gap {routing['min_gap']:.3e}"


def cut_params(params, repeats: int):
    """The first ``repeats`` repeats of every block leaf (views)."""
    from repro_torch.arch.model import tree_map

    return dict(params, blocks=tuple(tree_map(lambda a: a[:repeats], blk)
                                     for blk in params["blocks"]))


def check_moe(torch, timer) -> dict:
    """Phase 2, the MoE layer at Granite's and OLMoE's widths (random
    layer weights from the seed, fp32, TF32 off) at each of MOE_SHAPES:
    the layer with the gather kernel against the same layer with the plain
    gathers (``ref.gather_rows_ref``): routing equal, outputs within 1e-6
    of their largest |value|, two runs bit-equal; the card's routing
    against the CPU's on the same inputs (tokens routed differently and
    the smallest top-K gap). Granite's train shape also runs backward: the
    gradient through the kernels' backward (its sort path) against the
    plain gathers'. Then the dispatch and combine gathers and their
    backwards are timed cold at Granite's train shape and OLMoE's prefill
    shape beside ``index_select`` and ``zeros`` + ``index_add_``.
    Returns {"layer": per case, "gather": timed rows, "backward": ...}."""
    import dataclasses

    from repro_torch.arch import layers as L
    from repro_torch.configs import get_config
    from repro_torch.kernels import costs, ref
    from repro_torch.kernels.gather_batch import (backward_geometry,
                                                  gather_rows,
                                                  gather_rows_backward)

    out = {"layer": {}, "gather": {}, "backward": {}}
    for name, shapes in MOE_SHAPES.items():
        cfg = get_config(name)
        g = torch.Generator(device="cuda").manual_seed(SEED + 20)
        p = L.init_moe(g, cfg, device="cuda")
        for label, N, G in shapes:
            x = torch.randn((N, cfg.d_model), generator=g, device="cuda")
            train = label.startswith("train")
            if train:
                x.requires_grad_(True)
                for t in p.values():
                    t.requires_grad_(True)
            with torch.set_grad_enabled(train):
                r = L.moe_route(p, x, cfg, G)
                before = gather_rows.launches
                y, aux = L.moe(p, x, cfg, G)
                y2, aux2 = L.moe(p, x, cfg, G)
                y_plain, aux_plain = L.moe(p, x, cfg, G,
                                           gather=ref.gather_rows_ref)
                launched = gather_rows.launches - before
                r_plain = L.moe_route(p, x, cfg, G)
            same_route = all(torch.equal(r[k], r_plain[k]) for k in (
                "expert_idx", "order", "dest", "keep", "dispatch_idx",
                "combine_idx"))
            err = rel_err(y.detach(), y_plain.detach())
            case = {"tokens": N, "groups": r["groups"],
                    "capacity": r["capacity"],
                    "slots": int(r["dispatch_idx"].numel()),
                    "kept": int(r["keep"].sum()),
                    "assignments": int(r["keep"].numel()),
                    "rel_err_vs_plain": err,
                    "runs_bit_equal": torch.equal(y, y2)
                    and torch.equal(aux, aux2),
                    "gather_launches": launched}
            if not same_route or not err <= 1e-6 or \
                    not case["runs_bit_equal"] or launched != 4:
                fail(f"moe {name} {label}: routing equal {same_route}, "
                     f"{err} of the largest |y| from the plain gathers "
                     f"(bar 1e-6), runs bit-equal {case['runs_bit_equal']}, "
                     f"{launched} gather launches (want 4)")
            if train:
                w = torch.randn(y.shape, generator=g, device="cuda")
                leaves = [x] + list(p.values())
                bwd = gather_rows_backward.launches
                got = torch.autograd.grad((y * w).sum() + aux, leaves)
                case["backward_launches"] = gather_rows_backward.launches - bwd
                want = torch.autograd.grad((y_plain * w).sum() + aux_plain,
                                           leaves)
                case["grad_rel_err_vs_plain"] = max(
                    grad_rel_err(a, b) for a, b in zip(got, want))
                if case["backward_launches"] != 2 or \
                        not case["grad_rel_err_vs_plain"] <= 1e-6:
                    fail(f"moe {name} {label}: {case['backward_launches']} "
                         f"backward launches (want 2), gradients "
                         f"{case['grad_rel_err_vs_plain']} of their max "
                         f"from the plain gathers' (bar 1e-6)")
                x = x.detach()
                for t in p.values():
                    t.requires_grad_(False)
            # the CPU's routing on the same inputs
            cpu_p = {k: t.detach().cpu() for k, t in p.items()}
            with RoutingRecorder() as on_card:
                L.moe_route(p, x.detach(), cfg, G)
            with RoutingRecorder() as on_cpu:
                L.moe_route(cpu_p, x.detach().cpu(), cfg, G)
            case["routing_vs_cpu"] = routing_divergence(on_card, on_cpu)
            out["layer"][f"{name} {label}"] = case
            log(f"moe {name} {label}: N={N}, G={case['groups']}, "
                f"C={case['capacity']}, {case['slots']} slots, "
                f"{case['kept']} of {case['assignments']} assignments kept; "
                f"kernel gathers against plain: routing equal, "
                f"{err:.3e} of max |y|, two runs bit-equal"
                + (f", gradients {case['grad_rel_err_vs_plain']:.3e} of "
                   f"their max ({case['backward_launches']} backward "
                   f"launches)" if train else "")
                + f"; against the CPU's routing: "
                f"{case['routing_vs_cpu']['tokens_differing']} tokens "
                f"differ, smallest top-K gap "
                f"{case['routing_vs_cpu']['min_gap']:.3e}")

    # the dispatch and combine gathers and their backwards, cold
    for name, label, N, G in (("granite-moe-1b-a400m", "train 8 x 128",
                               1024, 8),
                              ("olmoe-1b-7b", "prefill 4 x 96", 384, 4)):
        cfg = get_config(name)
        g = torch.Generator(device="cuda").manual_seed(SEED + 21)
        D = cfg.d_model
        router = L.init_moe(g, dataclasses.replace(cfg, d_ff_expert=1),
                            device="cuda")["router"]
        x = torch.randn((N, D), generator=g, device="cuda")
        r = L.moe_route({"router": router}, x, cfg, G)
        slots = r["dispatch_idx"].numel()
        for part, n_src, idx in (("dispatch", N + slots // cfg.n_experts,
                                  r["dispatch_idx"]),
                                 ("combine", slots + N, r["combine_idx"])):
            K = idx.numel()
            src = torch.randn((n_src, D), generator=g, device="cuda")
            dout = torch.randn((K, D), generator=g, device="cuda")
            idx_long = idx.long()
            key = f"{name} {label} {part}: K={K} of ({n_src}, {D})"
            # the rows this run's indices name, each read once
            rows_read = int(torch.unique(idx).numel())
            fwd = {"ms": timer(lambda: gather_rows(src, idx)),
                   "library_ms": timer(lambda: torch.index_select(
                       src, 0, idx_long)),
                   **bound(f"gather_rows {part}",
                           (rows_read + K) * D * 4 + K * 4, 0)}
            bwd = {"path": backward_geometry(K, n_src, D * 4, 16)["path"],
                   "ms": timer(lambda: gather_rows_backward(dout, idx,
                                                            n_src)),
                   "library_ms": timer(lambda: torch.zeros(
                       (n_src, D), device="cuda").index_add_(0, idx_long,
                                                             dout)),
                   **cost_bound(f"gather_rows_backward {part}",
                                costs.gather_rows_backward(K, n_src, D * 4,
                                                           4))}
            bits = torch.equal(gather_rows_backward(dout, idx, n_src).cpu(),
                               ref.gather_rows_bwd_ref(dout.cpu(), idx.cpu(),
                                                       n_src))
            if not bits:
                fail(f"gather_rows_backward {key}: not the CPU plain "
                     f"version's bits")
            out["gather"][key] = fwd
            out["backward"][key] = bwd
            log(f"moe gather {key}: cold kernel {fwd['ms']:.5f} ms, "
                f"index_select {fwd['library_ms']:.5f}, bound "
                f"{fwd['bound_ms']:.5f}; backward ({bwd['path']} path, "
                f"the CPU's bits) {bwd['ms']:.5f} ms, zeros + index_add_ "
                f"{bwd['library_ms']:.5f}, bound {bwd['bound_ms']:.5f}")
    return out


def check_gather_backward_bf16(torch, timer) -> dict:
    """Phase 2, the row gather's bf16 backward (``csrc/gather_rows_bwd.cu``,
    each add rounded to bf16 as the reference's scatter-add rounds) against
    its plain version (``ref.gather_rows_bwd_ref``): at Granite-MoE's bf16
    train shapes (the dispatch, K = 10240 into (1344, 1024), and the
    combine, 8192 into (11264, 1024), 2048-byte rows on the sort path), on
    the one-launch path at K = 256 and 2048, an odd row (2-byte units) and
    repeated and negative indices: bit-equal to the plain version on the
    card and on the CPU, two runs bit-equal, and on the bf16 bar
    (:func:`bf16_bar`) against the fp32 sum of the same bf16 rows. Timed
    cold at both Granite shapes beside the fp32 kernel at the same shapes,
    the plain version and bf16 ``zeros`` + ``index_add_`` (a yardstick the
    port never calls), with each shape's bound."""
    import dataclasses

    from repro_torch.arch import layers as L
    from repro_torch.configs import get_config
    from repro_torch.kernels import costs, ref
    from repro_torch.kernels.gather_batch import (backward_geometry,
                                                  gather_rows_backward,
                                                  gather_rows_backward_bf16)

    cfg = get_config("granite-moe-1b-a400m")
    D = cfg.d_model
    g = torch.Generator(device="cuda").manual_seed(SEED + 30)
    router = L.init_moe(g, dataclasses.replace(cfg, d_ff_expert=1),
                        device="cuda")["router"]
    x = torch.randn((TRAIN_BATCH * TRAIN_SEQ, D), generator=g, device="cuda")
    r = L.moe_route({"router": router}, x, cfg, TRAIN_BATCH)
    N, slots = x.shape[0], r["dispatch_idx"].numel()
    moe = {"dispatch": (N + slots // cfg.n_experts, r["dispatch_idx"]),
           "combine": (slots + N, r["combine_idx"])}

    def indices(n, K, kind):
        idx = torch.randint(0, n, (K,), generator=g, device="cuda",
                            dtype=torch.int32)
        if kind == "repeats":
            idx[: K // 3] = idx[0]
            idx[K // 3] = -1
            idx[K // 3 + 1] = -n
        return idx

    # (label, dsrc shape, indices, kind); a third of "repeats" piles on one
    # row, whose sum rounded at each add is the reference's own and not
    # within BF16_KERNEL_TOL of the fp32 sum: those take the bar's first
    # half only (beside the plain version's bits)
    cases = [(f"Granite train {part}", (n, D), idx, "moe")
             for part, (n, idx) in moe.items()]
    cases += [(label, (n, d), indices(n, K, kind), kind)
              for label, n, d, K, kind in (
                  ("K=256, one launch", 2048, D, 256, "random"),
                  ("K=2048, one launch at the threshold", 2048, D, 2048,
                   "random"),
                  ("K=256 repeated and negative", 2048, D, 256, "repeats"),
                  ("odd row D=1023 (2-byte units)", 513, 1023, 300,
                   "repeats"),
                  ("odd row D=1023 sorted", 513, 1023, 3000, "random"))]
    worst, out = 0.0, {}
    for label, shape, idx, kind in cases:
        K = idx.numel()
        dout = torch.randn((K,) + shape[1:], generator=g,
                           device="cuda").bfloat16()
        before = gather_rows_backward_bf16.launches
        got = gather_rows_backward(dout, idx, shape[0])
        again = gather_rows_backward(dout, idx, shape[0])
        plain = ref.gather_rows_bwd_ref(dout, idx, shape[0])
        truth = ref.gather_rows_bwd_ref(dout.float(), idx, shape[0])
        torch.cuda.synchronize()
        if gather_rows_backward_bf16.launches != before + 2 or \
                got.dtype != torch.bfloat16:
            fail(f"gather_rows_backward_bf16 {label}: "
                 f"{gather_rows_backward_bf16.launches - before} bf16 "
                 f"launches, dsrc {got.dtype}")
        if not torch.equal(got, again):
            fail(f"gather_rows_backward_bf16 {label}: two runs differ")
        if not torch.equal(got, plain) or not torch.equal(
                got.cpu(), ref.gather_rows_bwd_ref(dout.cpu(), idx.cpu(),
                                                   shape[0])):
            fail(f"gather_rows_backward_bf16 {label}: not bit-equal to the "
                 f"plain version")
        bar = bf16_bar(f"gather_rows_backward_bf16 {label}", got, plain,
                       truth, kernel=kind != "repeats")
        worst = max(worst, bar["err"])
        row_bytes = 2 * dout[0].numel()
        unit = 16 if row_bytes % 16 == 0 else 2
        path = backward_geometry(K, shape[0], row_bytes, unit)["path"]
        log(f"gather_rows_backward_bf16 {label}: K={K} into {tuple(shape)} "
            f"({path} path, {unit}-byte units): bit-equal to the plain "
            f"version on the card and the CPU, two runs bit-equal; against "
            f"the fp32 sum {bar['err']:.3e} (relative {bar['rel_err']:.3e})")
        if not label.startswith("Granite"):
            continue
        dout32 = dout.float()
        idx_long = idx.long()
        n = shape[0]
        t = {"shape": f"dout ({K}, {D}) bfloat16 into dsrc ({n}, {D})",
             "path": path,
             "ms": timer(lambda: gather_rows_backward(dout, idx, n)),
             "fp32_ms": timer(lambda: gather_rows_backward(dout32, idx, n)),
             "plain_ms": timer(lambda: ref.gather_rows_bwd_ref(dout, idx, n)),
             "library_ms": timer(lambda: torch.zeros(
                 (n, D), dtype=torch.bfloat16, device="cuda").index_add_(
                     0, idx_long, dout)),
             **cost_bound(f"gather_rows_backward_bf16 {label}",
                          costs.gather_rows_backward(K, n, 2 * D, 4))}
        out[label.split()[-1]] = t
        log(f"gather_rows_backward_bf16 {label} ms: cold kernel "
            f"{t['ms']:.5f}, fp32 kernel {t['fp32_ms']:.5f}, plain "
            f"{t['plain_ms']:.4f}, bf16 zeros + index_add_ "
            f"{t['library_ms']:.5f}, bound {t['bound_ms']:.5f} "
            f"({t['bound_by']})")
    return {"name": "gather_rows_backward_bf16", "route": "cuda",
            "source": "src/repro_torch/csrc/gather_rows_bwd.cu",
            "replaces": "src/repro/kernels/gather_batch.py:26",
            "max_abs_err": worst, **out["dispatch"],
            "combine": out["combine"]}


MOE_TRAIN_ARGS = ["--arch", "granite-moe-1b-a400m", "--batch",
                  str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ)]


def card_vs_cpu_grads(torch, label: str, cfg, params, batch) -> dict:
    """One loss and its gradients of ``cfg`` at ``params`` (a CPU tree) on
    the card and on the CPU, on ``batch``: the loss within 1e-4 relative
    and every gradient leaf within 2e-3 of its largest |gradient|, or an
    MoE routing that differs first at a near-tie (ROUTING_TIE)."""
    from repro_torch.arch.model import TransformerLM
    from repro_torch.train.optimizer import leaves, unflatten

    def grads(device):
        model = TransformerLM(cfg, device=device)
        flat = [t.detach().to(device).requires_grad_(True)
                for t in leaves(params)]
        with RoutingRecorder() as rec:
            loss = model.loss(unflatten(params, flat),
                              {k: torch.as_tensor(a, device=device)
                               for k, a in batch.items()})
        gs = torch.autograd.grad(loss, flat)
        return float(loss.detach()), [g.cpu() for g in gs], rec

    card_loss, card_grads, card_rec = grads("cuda")
    t0 = time.perf_counter()
    cpu_loss, cpu_grads, cpu_rec = grads("cpu")
    cpu_s = time.perf_counter() - t0
    loss_err = abs(card_loss - cpu_loss) / abs(cpu_loss)
    grad_errs = [grad_rel_err(a, b) for a, b in zip(card_grads, cpu_grads)]
    routing = routing_divergence(card_rec, cpu_rec)
    if not loss_err <= 1e-4 or not max(grad_errs) <= 2e-3:
        if not routing_tie(routing):
            fail(f"{label}: card against CPU, loss {loss_err}, gradients "
                 f"{max(grad_errs)} (bars 1e-4, 2e-3; routing {routing})")
        log(f"{label}: accepted at a routing near-tie "
            f"({routing_gap(routing)})")
    return {"loss_rel_err": loss_err, "grad_rel_err_max": max(grad_errs),
            "cpu_s": cpu_s, "routing_vs_cpu": routing}


# Granite-MoE-1B-A400M's attention at the trainer's batch (8 x 128): 16
# query heads over 8 KV heads, head dim 64, causal
GRANITE_BWD_SHAPE = (8, 128, 16, 8, 64)


def time_granite_backwards(torch, timer, card: str) -> dict:
    """Phase 9 (g): flash attention's fp32 and bf16 backward kernels timed
    cold at GRANITE_BWD_SHAPE, the shape Granite's training launches them
    at, each beside the backward of ``scaled_dot_product_attention`` in its
    dtype (K/V expanded; a yardstick the port never calls) and with its
    bound. Returns each kernel's numbers by its name."""
    from repro_torch.kernels import costs
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward, flash_attention_forward)

    B, S, H, KV, D = GRANITE_BWD_SHAPE
    g = torch.Generator(device="cuda").manual_seed(SEED + 31)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for name, dtype, units in (
            ("flash_attention_backward", torch.float32,
             "3xTF32 on the tensor cores"),
            ("flash_attention_backward_bf16", torch.bfloat16,
             "bf16 on the tensor cores")):
        q, dout = (torch.randn((B, S, H, D), generator=g,
                               device="cuda").to(dtype) for _ in range(2))
        k, v = (torch.randn((B, S, KV, D), generator=g,
                            device="cuda").to(dtype) for _ in range(2))
        o, lse = flash_attention_forward(q, k, v, True, 0, with_lse=True)
        qt = q.transpose(1, 2).contiguous().requires_grad_(True)
        kt, vt = (t.repeat_interleave(H // KV, dim=2).transpose(1, 2)
                  .contiguous().requires_grad_(True) for t in (k, v))
        ot = sdpa(qt, kt, vt, is_causal=True)
        dt_ = dout.transpose(1, 2).contiguous()

        def library():
            torch.autograd.grad(ot, (qt, kt, vt), dt_, retain_graph=True)

        w = out[name] = {
            "shape": f"q/o/dO ({B}, {S}, {H}, {D}), k/v ({B}, {S}, {KV}, "
                     f"{D}) {str(dtype).removeprefix('torch.')}, causal",
            "ms": timer(lambda: flash_attention_backward(
                q, k, v, o, dout, lse, True, 0)),
            "library_ms": timer(library),
            **cost_bound(f"{name} Granite training shape",
                         costs.flash_attention_backward(
                             B, S, S, H, KV, D, True, 0,
                             dtype.itemsize), units)}
        log(f"{name} Granite training shape {w['shape']} ms: cold kernel "
            f"{w['ms']:.4f}, scaled_dot_product_attention backward "
            f"{w['library_ms']:.4f}, bound {w['bound_ms']:.6f} "
            f"({w['bound_by']}) ({card})")
        del ot, qt, kt, vt
    return out


def train_moe_phase(torch, drive, card: str, steps: int) -> dict:
    """Phase 9 (g): ``launch.train.main`` on Granite-MoE-1B-A400M at full
    width and depth, ``--batch 8 --seq 128``, ``steps`` steps, the step
    captured: losses finite and falling; a step launches flash attention's
    forward and backward once a layer and the row gather and its backward
    twice (the MoE's dispatch and combine); the same steps eagerly,
    bit-equal (losses and every leaf); ms per step, tokens/s, peak memory,
    a profiled replayed step. Then depth 2 at full width, batch 2 x 32,
    card against the CPU. Returns (g)'s launch counts."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig, SyntheticCorpus
    from repro_torch.kernels.gather_batch import gather_rows_backward
    from repro_torch.launch import train as launcher
    from repro_torch.train.optimizer import leaves

    cfg = get_config("granite-moe-1b-a400m")
    per_step = {"flash_attention": cfg.n_layers,
                "flash_attention_backward": cfg.n_layers,
                "gather_rows": 2 * cfg.n_layers,
                "gather_rows_backward": 2 * cfg.n_layers}
    stamps = []

    def record(line):
        stamps.append(time.perf_counter())
        log(f"train (g): {line}")

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    state, counts = drive(lambda: launcher.main(
        MOE_TRAIN_ARGS + ["--steps", str(steps), "--log-every", "1"],
        log_fn=record))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    shapes = dict(gather_rows_backward.shapes)
    losses = state.history
    if len(losses) != steps or not all(np.isfinite(losses)):
        fail(f"train (g): losses {losses} (want {steps} finite)")
    if not losses[-1] < losses[0]:
        fail(f"train (g): the loss did not fall: {losses}")
    for name, n in per_step.items():
        if counts[name] != n * steps:
            fail(f"train (g): {name} launched {counts[name]} times in "
                 f"{steps} steps, not {n} a step")
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    ms = statistics.median(step_ms)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_params = sum(t.numel() for t in leaves(state.params))
    cmp = captured_vs_eager(torch, "train (g)", cfg.name, state, steps,
                            per_step, forms=False)
    prof = cmp["replayed_step_profile"]
    own_us = {k: round(v["device_us"], 1)
              for k, v in prof["own_kernels"].items()}
    report = {"n_params": n_params, "steps": steps, "losses": losses,
              "step_ms": step_ms, "ms_per_step": ms,
              "tokens_per_s": tokens / ms * 1e3, "peak_bytes": peak,
              "peak_bytes_above_start": peak - base,
              "launches": counts,
              "backward_gather_shapes": shape_histogram(shapes),
              "profile": prof, "eager": cmp}
    FP32_TRAIN[cfg.name] = report
    log(f"train (g) {cfg.name} full width and depth ({n_params} params), "
        f"batch {TRAIN_BATCH} x {TRAIN_SEQ}, the step captured (step 1 its "
        f"warm-up, then replays): {ms:.2f} ms per step (median of steps "
        f"2-{steps}), {tokens / ms * 1e3:.1f} tokens/s, peak memory "
        f"{peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} above its "
        f"start), losses {[round(x, 4) for x in losses]}; eager: "
        f"{cmp['eager_ms_per_step']:.2f} ms per step, "
        f"{cmp['eager_tokens_per_s']:.1f} tokens/s, peak above its start "
        f"{cmp['eager_peak_bytes'] / 2**30:.2f} GiB; captured against "
        f"eager: bit-equal losses and leaves; profiled replayed step: busy "
        f"share {prof['busy_share']:.3f} ({prof['device_ms']:.2f} ms device "
        f"of {prof['wall_ms']:.2f} wall), {prof['device_events']} device "
        f"events, top {prof['top_events']}; own kernels' device us "
        f"{own_us}; launches {counts}; backward gather (K, n_src, row "
        f"bytes): {shape_histogram(shapes)} ({card})")
    del state, cmp

    # card against CPU at depth 2, full width, a small batch
    from repro_torch.arch.model import TransformerLM

    cfg2 = dataclasses.replace(cfg, n_layers=2)
    params = TransformerLM(cfg2, device="cpu").init_params(
        torch.Generator().manual_seed(SEED))
    batch = SyntheticCorpus(PipelineConfig(vocab=cfg2.vocab, seq_len=32,
                                           batch_size=2, seed=SEED)).batch(0)
    report["card_vs_cpu"] = c = card_vs_cpu_grads(torch, "train (g)", cfg2,
                                                  params, batch)
    log(f"train (g) depth 2, full width, batch 2 x 32: loss relative err "
        f"{c['loss_rel_err']:.3e}, worst gradient leaf "
        f"{c['grad_rel_err_max']:.3e} of its max |grad|; routing against "
        f"the CPU: {c['routing_vs_cpu']['tokens_differing']} tokens differ, "
        f"smallest top-K gap {c['routing_vs_cpu']['min_gap']:.3e}")
    log(f"train moe: {json.dumps(report, default=str)}")
    return counts


# -- phase 11 -------------------------------------------------------------


# Llama-3.2-Vision-11B: a prefill of VISION_BATCH prompts of VISION_LEN
# tokens with image embeddings drawn from the seed, then VISION_DECODE
# decode steps, at full width and depth; trained VISION_STEPS steps at
# full width with one pattern repeat (5 layers) at the launcher's batch.
VISION = "llama-3.2-vision-11b"
VISION_BATCH, VISION_LEN, VISION_DECODE = 2, 64, 8
VISION_STEPS = 5


def check_cross_attention(torch, timer) -> dict:
    """Phase 11's shapes of flash attention's forward (the vision model's
    2 x 64 prefill) and backward (its 8 x 128 train step), non-causal onto
    1024 image tokens, 32 query heads over 8 kv heads of 128: each against
    its plain version within 1e-4, then timed cold beside
    ``scaled_dot_product_attention`` with K/V expanded (a yardstick).
    Returns {"forward": ..., "backward": ...}, each with its bound."""
    from repro_torch.kernels import costs, ref
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward, flash_attention_forward)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device="cuda").manual_seed(SEED + 12)
    H, KV, D, Skv = 32, 8, 128, 1024
    out = {}
    for part, B, Sq in (("forward", 2, 64), ("backward", 8, 128)):
        q = torch.randn((B, Sq, H, D), generator=g, device="cuda")
        k, v = (torch.randn((B, Skv, KV, D), generator=g, device="cuda")
                for _ in range(2))
        qt = q.transpose(1, 2).contiguous().requires_grad_(True)
        kt, vt = (t.repeat_interleave(H // KV, dim=2).transpose(1, 2)
                  .contiguous().requires_grad_(True) for t in (k, v))
        if part == "forward":
            o = flash_attention_forward(q, k, v, False, 0)[0]
            err = rel_err(o, ref.flash_attention_ref(q, k, v, causal=False))
            ms = timer(lambda: flash_attention_forward(q, k, v, False, 0))
            with torch.no_grad():
                library_ms = timer(lambda: sdpa(qt, kt, vt))
            cost = costs.flash_attention(B, Sq, Skv, H, KV, D, False, 0)
        else:
            dout = torch.randn((B, Sq, H, D), generator=g, device="cuda")
            o, lse = flash_attention_forward(q, k, v, False, 0,
                                             with_lse=True)
            got = flash_attention_backward(q, k, v, o, dout, lse, False)
            want = ref.flash_attention_backward_ref(q, k, v, dout,
                                                    causal=False)
            err = max(grad_rel_err(a, b) for a, b in zip(got, want))
            ms = timer(lambda: flash_attention_backward(q, k, v, o, dout,
                                                        lse, False))
            ot = sdpa(qt, kt, vt)
            dt = dout.transpose(1, 2).contiguous()
            library_ms = timer(lambda: torch.autograd.grad(
                ot, (qt, kt, vt), dt, retain_graph=True))
            cost = costs.flash_attention_backward(B, Sq, Skv, H, KV, D,
                                                  False, 0)
        if not err <= 1e-4:
            fail(f"flash_attention {part} at the vision shape: {err} of "
                 f"the plain version's largest magnitude (bar 1e-4)")
        out[part] = {"shape": f"q ({B}, {Sq}, {H}, {D}), k/v ({B}, {Skv}, "
                              f"{KV}, {D}) float32, non-causal",
                     "rel_err": err, "ms": ms, "library_ms": library_ms,
                     **cost_bound(f"flash_attention {part} (vision)", cost,
                                  "3xTF32 on the tensor cores")}
        log(f"flash_attention {part} at the vision shape "
            f"{out[part]['shape']}: {err:.3e} of the plain version's max; "
            f"cold kernel {ms:.4f} ms, scaled_dot_product_attention "
            f"{library_ms:.4f}, bound {out[part]['bound_ms']:.4f} "
            f"({out[part]['bound_by']})")
    return out


def vision_generate(torch, model, params, toks, img, forced=None):
    """Prefill ``toks`` (with ``img``), then VISION_DECODE decode steps
    through the model's entry points, each fed the previous step's argmax
    (or ``forced[:, t]``). Returns (logits of the prefill and of each
    step, the tokens fed)."""
    L_ = toks.shape[1]
    with torch.no_grad():
        lg, caches = model.prefill(params, toks, img,
                                   cache_len=L_ + VISION_DECODE)
        logits, fed = [lg], []
        for t in range(VISION_DECODE):
            nxt = lg.argmax(-1) if forced is None else forced[:, t]
            fed.append(nxt)
            lg, caches = model.decode_step(params, nxt, caches, L_ + t)
            logits.append(lg)
    return logits, torch.stack(fed, 1)


def vision_phase(torch, drive, card: str) -> dict:
    """Phase 11 (module docstring); returns the launches of (a) and (c),
    fp32 and bf16."""
    import dataclasses
    import gc

    import numpy as np

    from repro_torch.arch.model import TransformerLM, tree_map
    from repro_torch.configs import get_config
    from repro_torch.core.device import block
    from repro_torch.data.pipeline import PipelineConfig, SyntheticCorpus
    from repro_torch.train.optimizer import leaves

    cfg = get_config(VISION)
    dev = torch.device("cuda")
    report = {}
    # (a) full width and depth: a prefill and eight decode steps
    t0 = time.perf_counter()
    model = TransformerLM(cfg, device=dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(SEED))
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    toks = torch.randint(0, cfg.vocab, (VISION_BATCH, VISION_LEN),
                         generator=g, device=dev)
    img = torch.randn((VISION_BATCH, cfg.n_image_tokens, cfg.d_model),
                      generator=g, device=dev)
    block(dev)
    n_params = sum(t.numel() for t in leaves(params))
    report["init_s"] = time.perf_counter() - t0
    (logits, fed), counts = drive(lambda: vision_generate(
        torch, model, params, toks, img))
    block(dev)
    if any(not torch.isfinite(x).all() or tuple(x.shape) != (
            VISION_BATCH, cfg.vocab) for x in logits):
        fail(f"vision (a): bad logits")
    if counts["flash_attention"] != cfg.n_layers:
        fail(f"vision (a): flash_attention launched "
             f"{counts['flash_attention']} times, not once a layer")
    with torch.no_grad():
        prefill_ms = timed(dev, lambda: model.prefill(
            params, toks, img, cache_len=VISION_LEN + VISION_DECODE))
        _, caches = model.prefill(params, toks, img,
                                  cache_len=VISION_LEN + VISION_DECODE)
        decode_ms = timed(dev, lambda: model.decode_step(
            params, fed[:, 0], caches, VISION_LEN))
    del caches
    report.update(n_params=n_params, launches=counts, prefill_ms=prefill_ms,
                  decode_step_ms=decode_ms, peak_bytes=
                  torch.cuda.max_memory_allocated())
    log(f"vision (a) {VISION} full width and depth ({n_params} params), "
        f"B={VISION_BATCH}, {VISION_LEN} tokens, {cfg.n_image_tokens} image "
        f"tokens: prefill {prefill_ms:.2f} ms, a decode step "
        f"{decode_ms:.2f} ms (eager), tokens {fed.tolist()}, launches "
        f"{counts} ({card})")

    # (a) in bf16: the same weights rounded once (fp32 and bf16 copies
    # coexist here, about 66 GB), the fp32 ones freed before it runs
    cut = dataclasses.replace(cfg, n_layers=len(cfg.pattern))
    one = tree_map(lambda t: t.clone(), cut_params(params, 1))
    lg32 = logits[0]
    p16 = tree_map(lambda t: t.to(torch.bfloat16), params)
    del params, model, logits
    gc.collect()
    torch.cuda.empty_cache()
    report["bf16"], counts16 = vision_bf16_full(torch, drive, card, cfg, p16,
                                                toks, img, lg32, fed)
    del p16, lg32
    gc.collect()
    torch.cuda.empty_cache()

    # (b) one pattern repeat, card against the CPU, teacher-forced with
    # the card's tokens: logits within 2e-3, tokens under the near-tie rule
    card_model = TransformerLM(cut, device=dev)
    cpu_model = TransformerLM(cut, device="cpu")
    cpu_params = tree_map(lambda t: t.cpu(), one)
    card_logits, card_fed = vision_generate(torch, card_model, one, toks, img)
    t0 = time.perf_counter()
    cpu_logits, _ = vision_generate(torch, cpu_model, cpu_params, toks.cpu(),
                                    img.cpu(), forced=card_fed.cpu())
    cpu_s = time.perf_counter() - t0
    errs, flips = [], []
    for t, (a, b) in enumerate(zip(card_logits, cpu_logits)):
        a = a.cpu()
        errs.append(rel_err(a, b))
        for r in range(VISION_BATCH):
            if int(a[r].argmax()) != int(b[r].argmax()):
                top = torch.topk(b[r], 2).values
                margin = float(top[0] - top[1])
                flips.append([r, t, margin])
                if margin > LOGIT_TOL * float(b[r].abs().max()):
                    fail(f"vision (b): row {r} step {t} picks another "
                         f"token on the card beyond a near-tie ({margin})")
    if not max(errs) <= LOGIT_TOL:
        fail(f"vision (b): logits {max(errs)} of the largest |logit| from "
             f"the CPU's (bar {LOGIT_TOL})")
    report["one_repeat_vs_cpu"] = {"logit_rel_err_max": max(errs),
                                   "near_tie_flips": flips, "cpu_s": cpu_s}
    log(f"vision (b) one repeat ({cut.n_layers} layers), card against the "
        f"CPU over the prefill and {VISION_DECODE} steps: logits within "
        f"{max(errs):.3e} of the largest |logit|, near-tie flips {flips}; "
        f"CPU {cpu_s:.1f} s")
    # one loss and its gradients, batch 1 x 32
    batch = SyntheticCorpus(PipelineConfig(
        vocab=cut.vocab, seq_len=32, batch_size=1, seed=SEED,
        n_image_tokens=cut.n_image_tokens, d_model=cut.d_model)).batch(0)
    c = card_vs_cpu_grads(torch, "vision (b)", cut, cpu_params, batch)
    report["one_repeat_vs_cpu"]["train"] = c
    log(f"vision (b) one repeat, batch 1 x 32: loss relative err "
        f"{c['loss_rel_err']:.3e}, worst gradient leaf "
        f"{c['grad_rel_err_max']:.3e} of its max |grad|; CPU "
        f"{c['cpu_s']:.1f} s")
    del cpu_params, card_logits, cpu_logits
    gc.collect()

    # (c) VISION_STEPS steps at one repeat, the launcher's batch, captured;
    # the same steps eagerly, bit-equal
    (losses, final, ms, peak), counts_c = drive(
        lambda: vision_train(torch, card_model, one, True))
    gc.collect()
    torch.cuda.empty_cache()
    e_losses, e_final, e_ms, e_peak = vision_train(torch, card_model, one,
                                                   False)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"vision (c): losses {losses} (want finite and falling)")
    for name in ("flash_attention", "flash_attention_backward"):
        if counts_c[name] != cut.n_layers * VISION_STEPS:
            fail(f"vision (c): {name} launched {counts_c[name]} times, not "
                 f"once a layer a step")
    if losses != e_losses or not all(torch.equal(a, b)
                                     for a, b in zip(final, e_final)):
        fail(f"vision (c): captured steps {losses} differ from eager "
             f"{e_losses}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    report["train"] = {"losses": losses, "ms_per_step": ms,
                       "tokens_per_s": tokens / ms * 1e3,
                       "peak_bytes_above_start": peak, "launches": counts_c,
                       "eager_ms_per_step": e_ms,
                       "eager_peak_bytes_above_start": e_peak}
    log(f"vision (c) one repeat ({sum(t.numel() for t in final)} params), "
        f"batch {TRAIN_BATCH} x {TRAIN_SEQ} with {cut.n_image_tokens} image "
        f"tokens, {VISION_STEPS} steps captured: {ms:.2f} ms per step, "
        f"{tokens / ms * 1e3:.1f} tokens/s, peak {peak / 2**30:.2f} GiB "
        f"above its start, losses {[round(x, 4) for x in losses]}; eager "
        f"{e_ms:.2f} ms per step, peak {e_peak / 2**30:.2f} GiB, bit-equal; "
        f"launches {counts_c} ({card})")
    del card_model, final, e_final
    gc.collect()
    torch.cuda.empty_cache()

    # (b) and (c) in bf16, at one repeat of the same weights rounded once
    one16 = tree_map(lambda t: t.to(torch.bfloat16), one)
    del one
    train16 = vision_bf16_cut(torch, drive, card, cut, one16, toks, img,
                              report)
    log(f"vision: {json.dumps(report, default=str)}")
    return {"prefill and decode": counts, "train": counts_c,
            "bf16 prefill and decode": counts16, "bf16 train": train16}


def vision_train(torch, model, params, capture: bool):
    """VISION_STEPS steps of ``train/loop.py:train`` of ``model`` (one
    repeat) from ``params`` at the launcher's batch with image embeddings,
    the step captured or eager: (losses, final leaves on the CPU, ms a step
    (median of steps 2 on), peak bytes above the start)."""
    from repro_torch.data.pipeline import PipelineConfig, SyntheticCorpus
    from repro_torch.train.loop import train
    from repro_torch.train.optimizer import AdamWConfig, leaves

    cfg = model.cfg
    corpus = SyntheticCorpus(PipelineConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH,
        seed=SEED, n_image_tokens=cfg.n_image_tokens, d_model=cfg.d_model))
    # the corpus's fp32 image embeddings in the model's dtype (a bf16
    # model refuses fp32 ones, as the reference's does)
    batches = [dict(b, image_embeds=torch.as_tensor(b["image_embeds"]).to(
        model.dtype)) for b in map(corpus.batch, range(VISION_STEPS))]
    opt = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=VISION_STEPS)
    stamps = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    state = train(model, params, iter(batches), VISION_STEPS, opt,
                  log_every=1, capture=capture,
                  log_fn=lambda line: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    ms = statistics.median(b - a for a, b in zip(stamps, stamps[1:]))
    return (state.history, [t.cpu() for t in leaves(state.params)],
            ms * 1e3, peak)


def vision_bf16_full(torch, drive, card: str, cfg, p16, toks, img, lg32,
                     fed32) -> tuple:
    """Phase 11 (a) in bf16: the full-depth prefill of VISION_BATCH x
    VISION_LEN tokens with the image embeddings and VISION_DECODE decode
    steps, eager, on ``p16`` (the fp32 weights rounded once): flash
    attention's bf16 kernel once a layer (the cross layers' at the vision
    cross shape) and the fp32 kernel never; ms of a prefill and a decode
    step beside fp32's; the prefill logits' gap to fp32's (``lg32``) and
    the greedy tokens' agreement with fp32's (``fed32``), reported, not
    held. Returns (its report, the launches)."""
    from repro_torch.arch.model import TransformerLM
    from repro_torch.core.device import block

    dev = torch.device("cuda")
    model = TransformerLM(cfg, torch.bfloat16, device=dev)
    img16 = img.to(torch.bfloat16)
    (logits, fed), counts = drive(lambda: vision_generate(
        torch, model, p16, toks, img16))
    block(dev)
    if any(not torch.isfinite(x.float()).all() or x.dtype != torch.bfloat16
           or tuple(x.shape) != (VISION_BATCH, cfg.vocab) for x in logits):
        fail("vision (a) bf16: bad logits")
    if counts["flash_attention_bf16"] != cfg.n_layers or \
            counts["flash_attention"]:
        fail(f"vision (a) bf16: flash_attention_bf16 launched "
             f"{counts['flash_attention_bf16']} times (want once a layer), "
             f"flash_attention {counts['flash_attention']}")
    cache_len = VISION_LEN + VISION_DECODE
    with torch.no_grad():
        prefill_ms = timed(dev, lambda: model.prefill(
            p16, toks, img16, cache_len=cache_len))
        _, caches = model.prefill(p16, toks, img16, cache_len=cache_len)
        decode_ms = timed(dev, lambda: model.decode_step(
            p16, fed[:, 0], caches, VISION_LEN))
    del caches
    gap = float((logits[0].float() - lg32.float()).abs().max())
    report = {"launches": counts, "prefill_ms": prefill_ms,
              "decode_step_ms": decode_ms,
              "peak_bytes": torch.cuda.max_memory_allocated(),
              "max_prefill_logit_gap_to_fp32": gap,
              "max_abs_logit_fp32": float(lg32.abs().max()),
              "tokens_equal_fp32": int((fed == fed32).sum()),
              "tokens": int(fed.numel())}
    log(f"vision (a) bf16 {VISION} full width and depth, the fp32 weights "
        f"rounded once: prefill {prefill_ms:.2f} ms, a decode step "
        f"{decode_ms:.2f} ms (eager); prefill logits {gap:.3e} from fp32's "
        f"(largest |logit| {report['max_abs_logit_fp32']:.3e}; a report, no "
        f"bar), {report['tokens_equal_fp32']} of {report['tokens']} greedy "
        f"tokens equal fp32's; launches {counts} ({card})")
    return report, counts


def vision_bf16_cut(torch, drive, card: str, cut, one16, toks, img,
                    report: dict) -> dict:
    """Phase 11 (b) and (c) in bf16 at one pattern repeat (``one16``): the
    prefill and VISION_DECODE steps on the card against the CPU's plain
    bf16 model, teacher-forced with the card's tokens, every logit on the
    bf16 bar (:func:`bf16_bar`; the truth the CPU's fp32 model on the same
    bf16-exact weights); one loss and its gradients at batch 1 x 32 on the
    same bar; then VISION_STEPS bf16 steps at the launcher's batch, the
    step captured, against the same steps eagerly: losses finite and
    falling, bit-equal with every leaf; flash attention's bf16 forward and
    backward once a layer a step and the fp32 kernels never. Returns (c)'s
    launches."""
    import numpy as np

    from repro_torch.arch.model import TransformerLM, tree_map
    from repro_torch.data.pipeline import PipelineConfig, SyntheticCorpus
    from repro_torch.train.optimizer import leaves, unflatten

    dev = torch.device("cuda")
    card_model = TransformerLM(cut, torch.bfloat16, device=dev)
    cpu16 = tree_map(lambda t: t.cpu(), one16)
    cpu32 = tree_map(lambda t: t.float(), cpu16)
    img16 = img.to(torch.bfloat16)
    card_logits, card_fed = vision_generate(torch, card_model, one16, toks,
                                            img16)
    t0 = time.perf_counter()
    args = (toks.cpu(), img16.cpu())
    plain, _ = vision_generate(torch, TransformerLM(
        cut, torch.bfloat16, device="cpu"), cpu16, *args,
        forced=card_fed.cpu())
    truth, _ = vision_generate(torch, TransformerLM(cut, device="cpu"),
                               cpu32, args[0], args[1].float(),
                               forced=card_fed.cpu())
    bars = [bf16_bar(f"vision (b) bf16 step {t}", a.cpu(), p, w,
                     kernel=False)
            for t, (a, p, w) in enumerate(zip(card_logits, plain, truth))]
    worst = max(bars, key=lambda b: b["err"] / max(b["plain_err"], 1e-30))
    # one loss and its gradients, batch 1 x 32
    batch = SyntheticCorpus(PipelineConfig(
        vocab=cut.vocab, seq_len=32, batch_size=1, seed=SEED,
        n_image_tokens=cut.n_image_tokens, d_model=cut.d_model)).batch(0)

    def grads(model, params, device):
        flat = [t.detach().to(device).requires_grad_(True)
                for t in leaves(params)]
        on = {k: torch.as_tensor(a, device=device)
              for k, a in batch.items()}
        # the batch's fp32 image embeddings in the model's dtype: a model
        # refuses another, as the reference's does
        on["image_embeds"] = on["image_embeds"].to(model.dtype)
        loss = model.loss(unflatten(params, flat), on)
        gs = torch.autograd.grad(loss, flat)
        return [loss.detach().cpu()] + [g.cpu() for g in gs]

    got = grads(card_model, cpu16, "cuda")
    plain_g = grads(TransformerLM(cut, torch.bfloat16, device="cpu"), cpu16,
                    "cpu")
    truth_g = grads(TransformerLM(cut, device="cpu"), cpu32, "cpu")
    gbars = {nm: bf16_bar(f"vision (b) bf16 {nm}", a, p, w, kernel=False)
             for nm, a, p, w in zip(["loss"] + leaf_names(cpu16), got,
                                    plain_g, truth_g)}
    ratio = {nm: b["err"] / b["plain_err"] if b["plain_err"] else 0.0
             for nm, b in gbars.items()}
    top = max(ratio, key=ratio.get)
    cpu_s = time.perf_counter() - t0
    report["bf16_one_repeat_vs_cpu"] = {
        "worst_logits": worst, "loss": gbars["loss"],
        "worst_leaf": [top, ratio[top]], "cpu_s": cpu_s}
    log(f"vision (b) bf16 one repeat, card against the CPU over the prefill "
        f"and {VISION_DECODE} steps: worst logits {worst['err']:.3e} from "
        f"the CPU's fp32 model (CPU plain bf16 {worst['plain_err']:.3e}; bar "
        f"twice it); batch 1 x 32: loss {gbars['loss']['err']:.3e} (CPU "
        f"plain bf16 {gbars['loss']['plain_err']:.3e}), worst leaf {top}: "
        f"{ratio[top]:.3f} of the CPU plain bf16 model's error (bar 2); CPU "
        f"{cpu_s:.1f} s")
    del cpu16, cpu32, got, plain_g, truth_g
    gc.collect()

    (losses, final, ms, peak), counts = drive(
        lambda: vision_train(torch, card_model, one16, True))
    gc.collect()
    torch.cuda.empty_cache()
    e_losses, e_final, e_ms, e_peak = vision_train(torch, card_model, one16,
                                                   False)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"vision (c) bf16: losses {losses} (want finite and falling)")
    want = {"flash_attention_bf16": cut.n_layers * VISION_STEPS,
            "flash_attention_backward_bf16": cut.n_layers * VISION_STEPS,
            "flash_attention": 0, "flash_attention_backward": 0}
    if {k: counts[k] for k in want} != want:
        fail(f"vision (c) bf16: launches {counts}, want {want}")
    if losses != e_losses or not all(torch.equal(a, b)
                                     for a, b in zip(final, e_final)):
        fail(f"vision (c) bf16: captured steps {losses} differ from eager "
             f"{e_losses}")
    if {t.dtype for t in final} != {torch.bfloat16}:
        fail("vision (c) bf16: a parameter leaf is not bf16")
    fp32 = report["train"]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    report["bf16_train"] = {"losses": losses, "ms_per_step": ms,
                            "tokens_per_s": tokens / ms * 1e3,
                            "peak_bytes_above_start": peak,
                            "launches": counts, "eager_ms_per_step": e_ms,
                            "eager_peak_bytes_above_start": e_peak}
    log(f"vision (c) bf16 one repeat, batch {TRAIN_BATCH} x {TRAIN_SEQ} with "
        f"{cut.n_image_tokens} image tokens, {VISION_STEPS} steps captured: "
        f"{ms:.2f} ms per step (fp32 {fp32['ms_per_step']:.2f}), "
        f"{tokens / ms * 1e3:.1f} tokens/s, peak {peak / 2**30:.2f} GiB above "
        f"its start (fp32 {fp32['peak_bytes_above_start'] / 2**30:.2f}), "
        f"losses {[round(x, 4) for x in losses]} (fp32 "
        f"{[round(x, 4) for x in fp32['losses']]}; a report); eager "
        f"{e_ms:.2f} ms per step (fp32 {fp32['eager_ms_per_step']:.2f}), "
        f"bit-equal; launches {counts} ({card})")
    return counts


# -- phase 12 -------------------------------------------------------------


DRYRUN_BATCH = 2     # the reference's --dynamic default


# The plan statistics of ``python -m repro.launch.dryrun --dynamic`` (the
# JAX package on the CPU at its defaults: width 16, batch 2, seed 0, one
# rng across the eight workloads); the plans do not depend on the width.
DRYRUN_FIELDS = ("nodes", "n_steps", "n_arenas", "layout", "n_slice_reads",
                 "n_gather_reads", "n_broadcast_reads", "n_slice_writes",
                 "n_scatter_writes", "n_gather_fallback_steps",
                 "n_pq_planned_batches", "n_pq_erased_batches",
                 "n_pq_chunks", "pq_skipped", "bucketed", "n_pad_steps",
                 "n_operands")
DRYRUN_REFERENCE = {
    "BiLSTM-Tagger": (124, 43, 4, "pq", 62, 0, 60, 84, 0, 0, 43, 0, 0, "",
                      False, 0, 206),
    "LSTM-NMT": (165, 40, 4, "pq", 85, 0, 24, 77, 0, 0, 40, 0, 0, "", False, 0,
                 186),
    "TreeLSTM": (111, 10, 4, "pq", 13, 5, 12, 14, 4, 2, 8, 2, 0, "", False, 0,
                 48),
    "TreeGRU": (111, 9, 3, "pq", 8, 4, 2, 7, 2, 2, 7, 2, 0, "", False, 0, 23),
    "MV-RNN": (44, 7, 3, "pq", 9, 4, 8, 13, 0, 1, 6, 1, 0, "", False, 0, 34),
    "TreeLSTM-2Type": (121, 12, 4, "pq", 15, 16, 4, 18, 3, 4, 8, 4, 0, "",
                       False, 0, 56),
    "LatticeLSTM": (173, 48, 4, "pq", 66, 12, 65, 81, 6, 4, 44, 4, 0, "",
                    False, 0, 230),
    "LatticeGRU": (86, 29, 3, "pq", 19, 5, 27, 29, 0, 2, 27, 2, 0, "", False,
                   0, 80),
}


# Workloads whose per-topology plans phases 3 and 5 build and capture at
# this width: (a) draws their graphs, so that the other rows stay the full
# sweep's, and builds only the other plans. LatticeLSTM's joint PQ planning
# alone took 128.9-261.8 s of (a) (PERF.md).
DRYRUN_PLANNED_EARLIER = ("BiLSTM-Tagger", "TreeLSTM", "LatticeLSTM")


# Each single-pod row's collective bytes by kind, per device, of ``python
# -m repro.launch.dryrun --all`` (the JAX package on the CPU, 512 host
# devices; its repeats' collectives added by block_cost): the yardstick of
# the port's collective term. Keys are (arch, shape) with the shape's
# sliding-window note dropped.
DRYRUN_COLL_REFERENCE = {
    ("musicgen-medium", "train_4k"): {
        "all-gather": 10158053376, "all-reduce": 98590439512,
        "collective-permute": 50688},
    ("musicgen-medium", "prefill_32k"): {
        "all-gather": 7348420608, "all-reduce": 39057358848},
    ("musicgen-medium", "decode_32k"): {
        "all-gather": 83558400, "all-reduce": 7495680},
    ("musicgen-medium", "long_500k"): {
        "all-gather": 995328, "all-reduce": 936960},
    ("moonshot-v1-16b-a3b", "train_4k"): {
        "all-gather": 20192174080, "all-to-all": 25212223488,
        "all-reduce": 427409056604, "collective-permute": 285376512},
    ("moonshot-v1-16b-a3b", "prefill_32k"): {
        "all-gather": 12884901888, "all-to-all": 24160763904,
        "all-reduce": 180925497344, "collective-permute": 11796480},
    ("moonshot-v1-16b-a3b", "decode_32k"): {
        "all-gather": 8110080, "all-to-all": 47972352,
        "all-reduce": 607485952, "collective-permute": 5898240},
    ("moonshot-v1-16b-a3b", "long_500k"): {
        "all-to-all": 3932160, "all-reduce": 2785664,
        "collective-permute": 3538944},
    ("llama-3.2-vision-11b", "train_4k"): {
        "all-gather": 7981514752, "all-to-all": 3825205248,
        "all-reduce": 307875037528, "collective-permute": 1375993856},
    ("llama-3.2-vision-11b", "prefill_32k"): {
        "all-gather": 2619342848, "all-to-all": 1442840576,
        "all-reduce": 86973087744, "collective-permute": 721420288},
    ("llama-3.2-vision-11b", "decode_32k"): {
        "all-gather": 41877504, "all-to-all": 131072, "all-reduce": 21184512,
        "collective-permute": 65536},
    ("llama-3.2-vision-11b", "long_500k"): {
        "all-gather": 1048576, "all-reduce": 2689024,
        "collective-permute": 8192},
    ("qwen2-7b", "train_4k"): {
        "all-gather": 28681074688, "all-to-all": 8589934592,
        "all-reduce": 217056474724, "collective-permute": 9563275264},
    ("qwen2-7b", "prefill_32k"): {
        "all-gather": 13153337344, "all-to-all": 3774873600,
        "all-reduce": 79859548160, "collective-permute": 4718592000},
    ("qwen2-7b", "decode_32k"): {
        "all-gather": 19898368, "all-to-all": 57344, "all-reduce": 10601472,
        "collective-permute": 71680},
    ("qwen2-7b", "long_500k"): {
        "all-gather": 659456, "all-reduce": 1325184,
        "collective-permute": 8960},
    ("phi4-mini-3.8b", "train_4k"): {
        "all-gather": 14199631872, "all-to-all": 9529458688,
        "all-reduce": 185126695000, "collective-permute": 4362338304},
    ("phi4-mini-3.8b", "prefill_32k"): {
        "all-gather": 6442450944, "all-to-all": 4328521728,
        "all-reduce": 65229815808, "collective-permute": 2164260864},
    ("phi4-mini-3.8b", "decode_32k"): {
        "all-gather": 39518208, "all-to-all": 131072, "all-reduce": 9977856,
        "collective-permute": 65536},
    ("phi4-mini-3.8b", "long_500k"): {
        "all-gather": 753664, "all-reduce": 1247232,
        "collective-permute": 8192},
    ("jamba-v0.1-52b", "train_4k"): {
        "all-gather": 15993858048, "all-to-all": 30994071552,
        "all-reduce": 243877716320, "collective-permute": 29275536256},
    ("jamba-v0.1-52b", "prefill_32k"): {
        "all-gather": 2281701376, "all-to-all": 5537234944,
        "all-reduce": 86980427776, "collective-permute": 23227531264},
    ("jamba-v0.1-52b", "decode_32k"): {
        "all-gather": 5349376, "all-to-all": 10878976,
        "all-reduce": 141730688, "collective-permute": 6764544},
    ("jamba-v0.1-52b", "long_500k"): {
        "all-gather": 126976, "all-to-all": 901120, "all-reduce": 1463408,
        "collective-permute": 1140480},
    ("qwen2-0.5b", "train_4k"): {
        "all-gather": 11666869760, "all-to-all": 1879048192,
        "all-reduce": 80957565284, "collective-permute": 2055471104},
    ("qwen2-0.5b", "prefill_32k"): {
        "all-gather": 5637144576, "all-to-all": 809500672,
        "all-reduce": 34057748480, "collective-permute": 1011875840},
    ("qwen2-0.5b", "decode_32k"): {
        "all-gather": 4521984, "all-to-all": 12288, "all-reduce": 2458624,
        "collective-permute": 15360},
    ("qwen2-0.5b", "long_500k"): {
        "all-gather": 172032, "all-reduce": 307328,
        "collective-permute": 1920},
    ("mamba2-130m", "train_4k"): {
        "all-gather": 4784073808, "all-to-all": 4051697664,
        "all-reduce": 6698631292, "collective-permute": 25600863972},
    ("mamba2-130m", "prefill_32k"): {
        "all-gather": 2824863744, "all-reduce": 4838129664,
        "collective-permute": 17221287936},
    ("mamba2-130m", "decode_32k"): {
        "all-gather": 25509888, "all-reduce": 590592,
        "collective-permute": 33558528},
    ("mamba2-130m", "long_500k"): {
        "all-gather": 3188736, "all-reduce": 73824,
        "collective-permute": 4194816},
    ("granite-moe-1b-a400m", "train_4k"): {
        "all-gather": 5726498816, "all-to-all": 9213968384,
        "all-reduce": 134566983636, "collective-permute": 507979264},
    ("granite-moe-1b-a400m", "prefill_32k"): {
        "all-gather": 4026531840, "all-to-all": 8472887296,
        "all-reduce": 57982058496, "collective-permute": 212664320},
    ("granite-moe-1b-a400m", "decode_32k"): {
        "all-gather": 14893056, "all-to-all": 15974400,
        "all-reduce": 203907072, "collective-permute": 1499136},
    ("granite-moe-1b-a400m", "long_500k"): {
        "all-gather": 227328, "all-to-all": 589824, "all-reduce": 1090560,
        "collective-permute": 494592},
    ("olmoe-1b-7b", "train_4k"): {
        "all-gather": 6301294592, "all-to-all": 11412963328,
        "all-reduce": 183737426780, "collective-permute": 97980416},
    ("olmoe-1b-7b", "prefill_32k"): {
        "all-gather": 4294967296, "all-to-all": 10737942528,
        "all-reduce": 77846282240, "collective-permute": 3932160},
    ("olmoe-1b-7b", "decode_32k"): {
        "all-gather": 2719744, "all-to-all": 21233664,
        "all-reduce": 269680640, "collective-permute": 1966080},
    ("olmoe-1b-7b", "long_500k"): {
        "all-to-all": 1310720, "all-reduce": 1196160,
        "collective-permute": 1179648},
}

# The bar: a row's collective bytes within this factor of the reference's
# total, either way ...
DRYRUN_COLL_BAR = 8.0
# ... or, for the rows PERF.md explains (choices of XLA's the port does not
# make), within DRYRUN_COLL_HELD_SLACK of the ratio (port / reference)
# recorded here: decode steps where XLA gathers each step's new K/V rows
# in fp32 for the cache write (MusicGen, Phi-4-mini) or permutes the SSM
# state between layouts (Mamba2), and the port writes them where they lie.
DRYRUN_COLL_HELD = {
    ("musicgen-medium", "decode_32k"): 0.06586,
    ("phi4-mini-3.8b", "decode_32k"): 0.11902,
    ("mamba2-130m", "decode_32k"): 0.01648,
    ("mamba2-130m", "long_500k"): 0.01648,
}
DRYRUN_COLL_HELD_SLACK = 0.25


# Each single-pod row's (temp_bytes, output_bytes, peak_bytes) of the
# reference's own ``--all`` run (XLA's memory analysis of the compiled step
# on the CPU backend, one device's bytes), with the bytes of the float32
# copies of whole bf16 step arguments that XLA:CPU makes in its temp; and
# each train_4k row's (temp_bytes, copies) under ``--layer-remat``: the
# yardstick of the port's memory term, printed by
# ``tests/reference_memory.py``. XLA:CPU's peak is its arguments and
# outputs without its temp, so it is kept and not compared.
DRYRUN_MEM_REFERENCE = {
    ("musicgen-medium", "train_4k"): (30191912712, 214614096,
        429759692, 341409792),
    ("musicgen-medium", "prefill_32k"): (1772986904, 2415919640,
        2587876036, 341409792),
    ("musicgen-medium", "decode_32k"): (10312534712, 4831840280,
        9835378902, 10005086208),
    ("musicgen-medium", "long_500k"): (360171376, 9437464,
        190570950, 359497728),
    ("moonshot-v1-16b-a3b", "train_4k"): (53995658960, 4399273296,
        8799076360, 6954942464),
    ("moonshot-v1-16b-a3b", "prefill_32k"): (14514129080, 1610653720,
        5130337628, 6954942464),
    ("moonshot-v1-16b-a3b", "decode_32k"): (20384114224, 6442614808,
        16404491630, 19839844352),
    ("moonshot-v1-16b-a3b", "long_500k"): (7035469032, 12603416,
        3544610338, 6896222208),
    ("llama-3.2-vision-11b", "train_4k"): (60894227896, 1528147096,
        3191042464, 2313682944),
    ("llama-3.2-vision-11b", "prefill_32k"): (6199708880, 541097368,
        1780657210, 2313682944),
    ("llama-3.2-vision-11b", "decode_32k"): (6682203272, 2164389208,
        5542787158, 6625427456),
    ("llama-3.2-vision-11b", "long_500k"): (2339163720, 4341496,
        1222800902, 2305556480),
    ("qwen2-7b", "train_4k"): (52270227368, 1190479744,
        2381493292, 1768406528),
    ("qwen2-7b", "prefill_32k"): (5116052440, 234919064,
        1187522804, 1768406528),
    ("qwen2-7b", "decode_32k"): (3802428544, 939676184,
        2831546246, 3647454720),
    ("qwen2-7b", "long_500k"): (1636047552, 1854040,
        956031926, 1635827200),
    ("phi4-mini-3.8b", "train_4k"): (39982533720, 695877432,
        1392288692, 959741952),
    ("phi4-mini-3.8b", "prefill_32k"): (3813967008, 536920952,
        1093891236, 959741952),
    ("phi4-mini-3.8b", "decode_32k"): (5477422536, 2147683736,
        4851879894, 5254709248),
    ("phi4-mini-3.8b", "long_500k"): (814895112, 4219336,
        565123062, 814481408),
    ("jamba-v0.1-52b", "train_4k"): (178609902192, 8046540512,
        16093613768, 12805501312),
    ("jamba-v0.1-52b", "prefill_32k"): (24798157176, 70970120,
        6508032060, 12805501312),
    ("jamba-v0.1-52b", "decode_32k"): (13823701792, 283880072,
        7224702474, 13343769984),
    ("jamba-v0.1-52b", "long_500k"): (13319941320, 35485128,
        6535289070, 12872784896),
    ("qwen2-0.5b", "train_4k"): (27172318504, 98579904,
        197693404, 123669248),
    ("qwen2-0.5b", "prefill_32k"): (2181431896, 50369656,
        129491460, 123669248),
    ("qwen2-0.5b", "decode_32k"): (554920576, 201478552,
        481669046, 526322432),
    ("qwen2-0.5b", "long_500k"): (90474496, 412232,
        79666262, 90422016),
    ("mamba2-130m", "train_4k"): (45244169776, 352251192,
        705036816, 161665536),
    ("mamba2-130m", "prefill_32k"): (5112601224, 2592696,
        284571034, 161665536),
    ("mamba2-130m", "decode_32k"): (204804752, 10370712,
        367713422, 161923584),
    ("mamba2-130m", "long_500k"): (24308112, 1296360,
        292465858, 7237632),
    ("granite-moe-1b-a400m", "train_4k"): (45954193704, 454305616,
        909143048, 525545472),
    ("granite-moe-1b-a400m", "prefill_32k"): (5395134592, 201523236,
        565235048, 525545472),
    ("granite-moe-1b-a400m", "decode_32k"): (2250198616, 806092872,
        1974854174, 2136158208),
    ("granite-moe-1b-a400m", "long_500k"): (340059032, 1671198,
        366695076, 327352320),
    ("olmoe-1b-7b", "train_4k"): (40101093008, 1086182736,
        2172896264, 1712128000),
    ("olmoe-1b-7b", "prefill_32k"): (11421943992, 536883512,
        1406094972, 1712128000),
    ("olmoe-1b-7b", "decode_32k"): (6513816112, 2147533976,
        5163971054, 6007095296),
    ("olmoe-1b-7b", "long_500k"): (1796263144, 4200616,
        877346482, 1694760960),
}
DRYRUN_MEM_LREMAT_REFERENCE = {
    "musicgen-medium": (30191945416, 341409792),
    "moonshot-v1-16b-a3b": (53995658896, 6954942464),
    "llama-3.2-vision-11b": (61998380216, 2313682944),
    "qwen2-7b": (52270227304, 1768406528),
    "phi4-mini-3.8b": (39982533720, 959741952),
    "jamba-v0.1-52b": (178969825160, 12805501312),
    "qwen2-0.5b": (27172318440, 123669248),
    "mamba2-130m": (45244169712, 161665536),
    "granite-moe-1b-a400m": (45953931432, 525545472),
    "olmoe-1b-7b": (40101092944, 1712128000),
}

# The memory bar: a row's temp_bytes within this factor, either way, of the
# reference's less its float32 copies (XLA's CPU backend computes bf16 in
# float32: a decode step's temp is 79-100% such copies of the weights and
# caches, which neither a device with bf16 arithmetic nor the port
# makes) ...
DRYRUN_MEM_BAR = 8.0
# ... or, for the rows PERF.md explains, within DRYRUN_COLL_HELD_SLACK of
# the ratio recorded here. MusicGen's prefill: the port makes each layer's
# caches and stacks them at the end, where XLA's scan writes the stacked
# output in place. The decode rows: at the peak of XLA:CPU's temp (its
# buffer assignment) 94.7-100% of the live bytes are float32 converts,
# whole stacks of the layers' weights that the count of argument copies
# misses (through a second convert, or a fusion that does not read the
# argument itself), bigger than the port's whole step at one token. The
# bar is advisory: phase 13 (b) holds the reckoning to the card.
DRYRUN_MEM_HELD = {
    ("musicgen-medium", "prefill_32k"): 8.2975,
    ("moonshot-v1-16b-a3b", "long_500k"): 0.0044396,
    ("llama-3.2-vision-11b", "long_500k"): 0.0033111,
    ("jamba-v0.1-52b", "decode_32k"): 0.087802,
    ("jamba-v0.1-52b", "long_500k"): 0.012084,
    ("mamba2-130m", "long_500k"): 0.11583,
    ("granite-moe-1b-a400m", "long_500k"): 0.013421,
    ("olmoe-1b-7b", "long_500k"): 0.0061417,
}


def memory_ratio(arch: str, shape: str, temp_bytes: float,
                 layer_remat: bool = False) -> float:
    """A row's ``temp_bytes`` over the reference's less its float32 copies
    (:data:`DRYRUN_MEM_REFERENCE`, or with ``layer_remat``
    :data:`DRYRUN_MEM_LREMAT_REFERENCE`)."""
    if layer_remat:
        temp, copies = DRYRUN_MEM_LREMAT_REFERENCE[arch]
    else:
        temp, _, _, copies = DRYRUN_MEM_REFERENCE[(arch, shape)]
    return temp_bytes / (temp - copies)


def memory_ratio_ok(arch: str, shape: str, temp_bytes: float,
                    layer_remat: bool = False) -> bool:
    """:func:`memory_ratio` within the bar, or within the slack of the
    row's held ratio."""
    ratio = memory_ratio(arch, shape, temp_bytes, layer_remat)
    held = None if layer_remat else DRYRUN_MEM_HELD.get((arch, shape))
    if held is not None:
        return abs(ratio / held - 1) <= DRYRUN_COLL_HELD_SLACK
    return 1 / DRYRUN_MEM_BAR <= ratio <= DRYRUN_MEM_BAR


def collective_ratio_ok(arch: str, shape: str, coll_bytes: float) -> bool:
    """A row's ``coll_bytes`` against :data:`DRYRUN_COLL_REFERENCE`: within
    the bar, or within the slack of its held ratio."""
    ratio = coll_bytes / sum(DRYRUN_COLL_REFERENCE[(arch, shape)].values())
    held = DRYRUN_COLL_HELD.get((arch, shape))
    if held is not None:
        return abs(ratio / held - 1) <= DRYRUN_COLL_HELD_SLACK
    return 1 / DRYRUN_COLL_BAR <= ratio <= DRYRUN_COLL_BAR


def host_process(code: str):
    """``code`` in a Python process of its own on ``src/``, its output
    piped; it exits 3 if it initialised CUDA, else with its own code."""
    import os

    return subprocess.Popen(
        [sys.executable, "-c", "import sys, time\nimport torch\n" + code
         + "sys.exit(3 if torch.cuda.is_initialized() else rc)\n"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))


def dryrun_phase(torch, drive, card: str) -> dict:
    """Phase 12 (module docstring); returns (a)'s launches. (b) is host
    work alone, so it runs beside (a), in processes of its own that must
    not so much as initialise CUDA: the ``--all`` sweep, and the ten
    train_4k rows with ``--layer-remat``."""
    import tempfile

    from repro_torch.launch import dryrun, report

    with tempfile.TemporaryDirectory() as tmp:
        out, lremat_out = Path(tmp) / "rows.json", Path(tmp) / "lremat.json"
        procs = {
            "--all": host_process(
                "from repro_torch.launch.dryrun import main\n"
                "t0 = time.perf_counter()\n"
                f"rc = main(['--all', '--out', {str(out)!r}])\n"
                "print(f'sweep seconds {time.perf_counter() - t0:.1f}')\n"),
            "--layer-remat": host_process(
                "import json\n"
                "from repro_torch.configs import ARCHS\n"
                "from repro_torch.launch.dryrun import dryrun_one\n"
                "t0 = time.perf_counter()\n"
                "rows = [dryrun_one(a, 'train_4k', layer_remat=True)\n"
                "        for a in ARCHS]\n"
                f"json.dump(rows, open({str(lremat_out)!r}, 'w'))\n"
                "print(f'layer-remat seconds "
                "{time.perf_counter() - t0:.1f}')\n"
                "rc = 0\n")}
        logs = {}
        try:
            t0 = time.perf_counter()
            rows, counts = drive(lambda: dryrun.dryrun_dynamic(
                model_size=MODEL_SIZE, batch_size=DRYRUN_BATCH, seed=SEED,
                verbose=False, skip=DRYRUN_PLANNED_EARLIER))
            dyn_s = time.perf_counter() - t0
            for name, proc in procs.items():
                logs[name], _ = proc.communicate(timeout=900)
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        bad = [r for r in rows if not r["ok"]]
        want_rows = len(DRYRUN_REFERENCE) - len(DRYRUN_PLANNED_EARLIER)
        if bad or len(rows) != want_rows:
            fail(f"dryrun --dynamic: {len(rows)} rows, failed {bad}")
        for r in rows:
            log(f"dryrun --dynamic {r['workload']}: {r['nodes']} nodes, "
                f"{r['n_steps']} steps, {r['n_arenas']} arenas "
                f"({r['layout']} layout), {r['n_slice_reads']} slice / "
                f"{r['n_gather_reads']} gather reads, "
                f"{r['n_gather_fallback_steps']} fallback steps, lowering "
                f"{r['lower_time_s']:.3f} s, {r['n_compiles']} capture "
                f"{r['compile_time_s']:.3f} s, wall {r['wall_s']} s ({card})")
            got = tuple(r[k] for k in DRYRUN_FIELDS)
            want = DRYRUN_REFERENCE[r["workload"]]
            if got != want:
                fail(f"dryrun --dynamic {r['workload']}: "
                     f"{dict(zip(DRYRUN_FIELDS, got))}, the reference's "
                     f"{dict(zip(DRYRUN_FIELDS, want))}")
        log(f"dryrun --dynamic: {want_rows} rows ok at model_size="
            f"{MODEL_SIZE}, batch {DRYRUN_BATCH} (the graphs of "
            f"{', '.join(DRYRUN_PLANNED_EARLIER)} drawn, their plans left "
            f"to phases 3 and 5), in {dyn_s:.1f} s, each plan's statistics "
            f"the reference's; launches {counts} ({card})")
        for name, proc in procs.items():
            for line in logs[name].splitlines():
                if line.startswith(("[dryrun]", "sweep seconds",
                                    "layer-remat seconds")):
                    log(line)
            if proc.returncode != 0:
                fail(f"dryrun {name} exited {proc.returncode} (3: it "
                     f"initialised CUDA):\n{logs[name][-4000:]}")
        with open(out) as f:
            rows = json.load(f)
        with open(lremat_out) as f:
            lremat = json.load(f)
    bad = [r for r in rows if not r["ok"]]
    if len(rows) != 40 or bad:
        fail(f"dryrun --all: {len(rows)} rows, failed {bad}")
    log(report.render(rows))
    ratios, temp_ratios, plain_temp = {}, {}, {}
    for r in rows:
        key = (r["arch"], r["shape"].split("(")[0])
        if r.get("coll_bytes") is None or \
                not collective_ratio_ok(*key, r["coll_bytes"]):
            fail(f"dryrun --all {key}: coll_bytes {r.get('coll_bytes')}, "
                 f"the reference's {DRYRUN_COLL_REFERENCE[key]}: off the "
                 f"bar (x{DRYRUN_COLL_BAR:g}) and not a held row")
        ratios[key] = r["coll_bytes"] / sum(
            DRYRUN_COLL_REFERENCE[key].values())
        if r["temp_bytes"] is None or \
                r["bytes_per_device"] != r["temp_bytes"] + r["arg_bytes"] \
                or not memory_ratio_ok(*key, r["temp_bytes"]):
            fail(f"dryrun --all {key}: temp_bytes {r['temp_bytes']} "
                 f"(bytes_per_device {r['bytes_per_device']}), the "
                 f"reference's {DRYRUN_MEM_REFERENCE[key]}: off the bar "
                 f"(x{DRYRUN_MEM_BAR:g}) and not a held row")
        temp_ratios[key] = memory_ratio(*key, r["temp_bytes"])
        plain_temp[key] = r["temp_bytes"]
    free = [v for k, v in ratios.items() if k not in DRYRUN_COLL_HELD]
    log(f"dryrun --all: 40 rows ok on the meta device (16x16 mesh), its "
        f"process never initialised CUDA; beside (a) on the host of {card}; "
        f"collective bytes / the reference's: {min(free):.3f} to "
        f"{max(free):.3f} over {len(free)} rows (bar x{DRYRUN_COLL_BAR:g}), "
        + ", ".join(f"{a} {sh} {ratios[(a, sh)]:.4f} (held at {h:.4f})"
                    for (a, sh), h in DRYRUN_COLL_HELD.items()))
    for shape in dryrun.SHAPES:
        got = [v for k, v in temp_ratios.items()
               if k[1] == shape and k not in DRYRUN_MEM_HELD]
        log(f"dryrun --all temp_bytes / the reference's less its float32 "
            f"copies, {shape} rows: {min(got):.4f} to {max(got):.4f} over "
            f"{len(got)} rows (bar x{DRYRUN_MEM_BAR:g}); "
            + ", ".join(f"{a} {v:.4f}" for (a, sh), v in temp_ratios.items()
                        if sh == shape))
    log("dryrun --all held memory rows: " + ", ".join(
        f"{a} {sh} {temp_ratios[(a, sh)]:.5g} (held at {h:.5g})"
        for (a, sh), h in DRYRUN_MEM_HELD.items()))
    if len(lremat) != len(DRYRUN_MEM_LREMAT_REFERENCE) or \
            not all(r["ok"] for r in lremat):
        fail(f"dryrun --layer-remat: {len(lremat)} rows, "
             f"{[r for r in lremat if not r['ok']]}")
    parts = []
    for r in lremat:
        key = (r["arch"], "train_4k")
        if not r["shape"].endswith("+lremat") or \
                not memory_ratio_ok(*key, r["temp_bytes"], True) or \
                r["temp_bytes"] > plain_temp[key]:
            fail(f"dryrun --layer-remat {key}: shape {r['shape']}, "
                 f"temp_bytes {r['temp_bytes']} against the reference's "
                 f"{DRYRUN_MEM_LREMAT_REFERENCE[r['arch']]} (bar "
                 f"x{DRYRUN_MEM_BAR:g}) and the plain row's "
                 f"{plain_temp[key]} (want no more)")
        ratio = memory_ratio(*key, r["temp_bytes"], True)
        parts.append(f"{r['arch']} {ratio:.4f} "
                     f"({r['temp_bytes'] / plain_temp[key]:.4f} of remat)")
    log(f"dryrun --layer-remat: 10 train_4k rows ok, temp_bytes / the "
        f"reference's +lremat row less its float32 copies (and of the "
        f"plain remat row's): " + ", ".join(parts))
    return counts


# -- phase 13 -------------------------------------------------------------


REMAT_STEPS = 3
# (arch, dtype) -> each kernel its training path launches and its launches
# a layer a step without remat (every layer of these models runs each of
# them), and the layer_remat settings of its remat runs
REMAT_TRAIN = {
    ("qwen2-0.5b", "float32"): ({"flash_attention": 1,
                                 "flash_attention_backward": 1},
                                (False, True)),
    ("mamba2-130m", "bfloat16"): ({"ssd_scan_bf16": 1,
                                   "ssd_scan_backward_bf16": 1}, (False,)),
    ("granite-moe-1b-a400m", "bfloat16"): ({"flash_attention_bf16": 1,
                                            "flash_attention_backward_bf16": 1,
                                            "gather_rows": 2,
                                            "gather_rows_backward_bf16": 2},
                                           (False,)),
}
REMAT_MEM_TOL = 0.15     # (b): the reckoned peak against the card's


def remat_train_phase(torch, drive, card: str, on_path) -> None:
    """Phase 13 (a) (module docstring): per (arch, dtype) of REMAT_TRAIN, a
    remat=False run and its remat runs, REMAT_STEPS steps each of
    ``train/loop.py:train`` at TRAIN_BATCH x TRAIN_SEQ from the seed-0
    weights and the same batches, the step captured."""
    import numpy as np

    from repro_torch.arch.model import TransformerLM, tree_map
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig, SyntheticCorpus
    from repro_torch.train.loop import train
    from repro_torch.train.optimizer import AdamWConfig, leaves

    for (arch, dt_name), (kernels, lremats) in REMAT_TRAIN.items():
        dtype = getattr(torch, dt_name)
        cfg = get_config(arch)
        params = tree_map(lambda t: t.to("cuda", dtype), TransformerLM(
            cfg, device="cpu").init_params(torch.Generator().manual_seed(0)))
        opt = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=REMAT_STEPS)
        runs = {}
        for variant in [None] + list(lremats):
            model = TransformerLM(cfg, dtype, device="cuda",
                                  remat=variant is not None)
            model.layer_remat = bool(variant)
            pipe = SyntheticCorpus(PipelineConfig(
                vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH,
                seed=0))
            stamps = []
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            state, counts = drive(lambda: train(
                model, params, iter(pipe), REMAT_STEPS, opt, log_every=1,
                log_fn=lambda line: stamps.append(time.perf_counter())))
            torch.cuda.synchronize()
            runs[variant] = {
                "state": state, "counts": counts,
                "peak": torch.cuda.max_memory_allocated() - base,
                "ms": statistics.median(
                    (b - a) * 1e3 for a, b in zip(stamps, stamps[1:]))}
            del model
        plain = runs.pop(None)
        losses = plain["state"].history
        if len(losses) != REMAT_STEPS or not all(np.isfinite(losses)):
            fail(f"remat (a) {arch} {dt_name}: losses {losses}")
        per_step = {k: n * cfg.n_layers for k, n in kernels.items()}
        if {k: plain["counts"][k] for k in kernels} != \
                {k: n * REMAT_STEPS for k, n in per_step.items()}:
            fail(f"remat (a) {arch} {dt_name}: without remat, launches "
                 f"{ {k: plain['counts'][k] for k in kernels} } in "
                 f"{REMAT_STEPS} steps, not {per_step} a step")
        label = f"{arch} {dt_name} training"
        on_path(label, plain["counts"], kernels)
        parts = []
        for lremat, run in runs.items():
            name = "remat" + (" + layer remat" if lremat else "")
            # the backward recomputes every forward kernel once
            want = {k: n * REMAT_STEPS * (1 if "backward" in k else 2)
                    for k, n in per_step.items()}
            got = {k: run["counts"][k] for k in kernels}
            if got != want:
                fail(f"remat (a) {arch} {dt_name} {name}: launches {got}, "
                     f"not {want}")
            if run["state"].history != losses or not all(
                    torch.equal(a, b) for a, b in zip(
                        leaves(run["state"].params),
                        leaves(plain["state"].params))):
                fail(f"remat (a) {arch} {dt_name} {name}: losses "
                     f"{run['state'].history} against {losses} without "
                     f"remat, or a parameter leaf differs (want bit-equal)")
            on_path(f"{label} with {name}", run["counts"], kernels)
            parts.append(f"{name} {run['ms']:.2f} ms per step, peak "
                         f"{run['peak'] / 2**30:.3f} GiB, launches {got}")
        log(f"remat (a) {arch} {dt_name}, batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
            f"{REMAT_STEPS} steps captured: remat off {plain['ms']:.2f} ms "
            f"per step (median of steps 2 on), peak above the start "
            f"{plain['peak'] / 2**30:.3f} GiB, launches "
            f"{ {k: plain['counts'][k] for k in kernels} }; "
            + "; ".join(parts)
            + f"; losses and every parameter leaf bit-equal to remat off "
            f"({card})")
        del params, runs, plain
        gc.collect()
        torch.cuda.empty_cache()


def card_peak(torch, fn) -> int:
    """The bytes ``fn()`` allocates on the card at its most: after a
    warm-up call (workspaces), ``max_memory_allocated()`` over a second
    call less what was allocated before it."""
    fn()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak


def remat_memory_phase(torch, card: str) -> None:
    """Phase 13 (b) (module docstring): Qwen2-0.5B at TRAIN_BATCH x
    TRAIN_SEQ, fp32 and bf16, remat off and on, two steps each: the loss
    and its gradients (``dryrun._value_and_grad``, whose peak falls in the
    backward), and the trainer's whole step (``StaticTrainStep`` run
    eagerly: with the in-place AdamW), each run on the card and reckoned on
    meta by the dry-run's counter, unplaced: the reckoned high-water mark
    of the storages the step makes within REMAT_MEM_TOL of the card's
    (:func:`card_peak`)."""
    from repro_torch.arch.model import TransformerLM, tree_map
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig, SyntheticCorpus
    from repro_torch.launch import dryrun
    from repro_torch.train.loop import StaticTrainStep
    from repro_torch.train.optimizer import AdamWConfig

    cfg = get_config("qwen2-0.5b")
    weights = TransformerLM(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    batch = {k: torch.as_tensor(v) for k, v in SyntheticCorpus(
        PipelineConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                       batch_size=TRAIN_BATCH, seed=0)).batch(0).items()}
    opt = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=REMAT_STEPS)
    parts = []
    for dtype in (torch.float32, torch.bfloat16):
        for remat in (False, True):
            label = (f"{str(dtype).removeprefix('torch.')} remat "
                     f"{'on' if remat else 'off'}")
            for what in ("loss and gradients", "whole step"):
                sides = {}
                for dev in ("cuda", "meta"):
                    model = TransformerLM(cfg, dtype, device=dev,
                                          remat=remat)
                    params = tree_map(lambda t: torch.empty_like(
                        t, device=dev, dtype=dtype) if dev == "meta"
                        else t.to(dev, dtype), weights)
                    data = {k: v.to(dev) for k, v in batch.items()}
                    if what == "whole step":
                        step = StaticTrainStep(model, opt, params,
                                               capture=False)
                        args = (data,)
                    else:
                        step = partial(dryrun._value_and_grad, model)
                        args = (params, data)
                    sides[dev] = (card_peak(torch, lambda: step(*args))
                                  if dev == "cuda" else
                                  dryrun.count_step(step, *args).high_water)
                    del model, params, step, args
                    gc.collect()
                    torch.cuda.empty_cache()
                err = sides["meta"] / sides["cuda"] - 1
                parts.append(f"{label} {what}: reckoned "
                             f"{sides['meta'] / 2**30:.3f} GiB, the card "
                             f"{sides['cuda'] / 2**30:.3f} GiB ({err:+.2%})")
                if abs(err) > REMAT_MEM_TOL:
                    fail(f"remat (b) Qwen2-0.5B {label} {what}: the "
                         f"reckoned peak {sides['meta']} against the card's "
                         f"{sides['cuda']} (bar {REMAT_MEM_TOL:.0%} either "
                         f"way)")
    log(f"remat (b) Qwen2-0.5B, batch {TRAIN_BATCH} x {TRAIN_SEQ}, run "
        f"eagerly, the bytes it makes at their most, reckoned on meta "
        f"against max_memory_allocated on the card: " + "; ".join(parts)
        + f" (bar {REMAT_MEM_TOL:.0%}; {card})")


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6,7,8,9,10,11,12,13",
                    help="phases to run after phase 1 (comma-separated); "
                         "the result lines are printed only for all "
                         "thirteen")
    ap.add_argument("--workloads", default=",".join(TREES_LATTICES),
                    help="phase 5's workloads (comma-separated)")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")} | {1}
    workloads = args.workloads.split(",")
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch is not beside this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    build_kernels()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    timer = ColdTimer(torch)
    sass = sass_counts(("flash_attention_kernel",
                        "flash_attention_bf16_kernel",
                        "ssd_scan_bf16_kernel",
                        "flash_attention_bwd_dkdv_kernel",
                        "flash_attention_bwd_dq_kernel",
                        "flash_attention_bwd_bf16_dkdv_kernel",
                        "flash_attention_bwd_bf16_dq_kernel",
                        "ssd_scan_kernel",
                        "ssd_bwd_chunk_kernel", "ssd_bwd_bf16_chunk_kernel",
                        "fused_gather_lstm_cell_kernel",
                        "fused_lstm_cell_kernel"))
    if sass is None:
        log("SASS: not counted (no cuobjdump in the toolkit)")
    else:
        log(f"SASS {'/'.join(SASS_OPS)} instructions: "
            f"{ {k: [v[op] for op in SASS_OPS] for k, v in sass.items()} }")
        if not all(v["HMMA"] + v["HGMMA"] for v in sass.values()):
            fail(f"a tensor-core kernel has no HMMA or HGMMA instruction: "
                 f"{sass}")
        for k in HOPPER_KERNELS:
            if not (sass[k]["HGMMA"] and sass[k]["UTMALDG"]):
                fail(f"{k} lacks HGMMA or UTMALDG (a Hopper kernel runs "
                     f"wgmma on TMA-loaded tiles): {sass[k]}")
    rows = []
    if 2 in phases:
        launch_floor(torch, timer)
        rows = [check_gather(torch, timer), check_fused(torch, timer),
                check_fused_dense(torch, timer), check_flash(torch, timer),
                check_ssd(torch, timer), check_flash_bf16(torch, timer),
                check_ssd_bf16(torch, timer)]
        moe_report = check_moe(torch, timer)
        rows[0]["moe_shapes"] = moe_report["gather"]
        rows.append(check_gather_backward_bf16(torch, timer))
        log(f"kernel checks done: {time.perf_counter() - t_start:.1f} s")

    from repro_torch.kernels.gather_batch import (gather_rows,
                                                  gather_rows_backward)
    from repro_torch.kernels.launches import WRAPPERS as wrappers

    def drive(fn):
        """Run ``fn`` with every launch count (and the gather's shape
        counts) set to 0 just before it; returns its result and the counts
        read just after."""
        for w in wrappers.values():
            w.launches = 0
        gather_rows.shapes.clear()
        gather_rows_backward.shapes.clear()
        out = fn()
        return out, {name: w.launches for name, w in wrappers.items()}

    launches = {"fused_lstm_cell": rows[2]["launches"]} if rows else {}
    # launches by kernel on each path that drives it, this slice's included
    by_path: dict[str, dict] = {}

    def on_path(path: str, counts: dict, kernels) -> None:
        for kernel in kernels:
            if counts[kernel] <= 0:
                fail(f"{kernel} was not launched during {path}")
            by_path.setdefault(kernel, {})[path] = counts[kernel]

    if 3 in phases:
        report, slice_counts = drive(lambda: run_slice("cuda"))
        on_path("the tagger slice", slice_counts,
                ("gather_rows", "fused_gather_lstm_cell"))
        for name in ("gather_rows", "fused_gather_lstm_cell"):
            launches[name] = slice_counts[name]
        log(f"slice: {json.dumps(report, default=str)}")
        log(f"slice ms per run: {report['ms_per_run']} ({card})")
        log("slice per executor (ms per run, busy share, device events): "
            + "; ".join(
                f"{ename} {report['ms_per_run'][ename]:.3f} ms, busy "
                f"{prof['busy_share']:.3f}, {prof['device_events']} events"
                for ename, prof in report["profile"].items())
            + f"; per-topology replay vs eager max abs err "
            f"{report['max_abs_err_replay_vs_eager']:.3e}, "
            f"{report['per_topology_replay']} ({card})")
        log(f"gather shapes BiLSTM-Tagger [K, row bytes, launches]: "
            f"{shape_histogram(gather_rows.shapes)}")
        prof = report["profile"]["bucketed"]
        log(f"tagger bucketed run device time: {prof['device_ms'] * 1e3:.2f} "
            f"us of {prof['wall_ms'] * 1e3:.1f} us wall; "
            + "; ".join(f"{k} {v['launches']} launches {v['device_us']:.2f} "
                        f"us, share {v['share']:.3f}"
                        for k, v in prof["own_kernels"].items())
            + f" ({card})")
        log(f"slice done: {time.perf_counter() - t_start:.1f} s")

    for name, kernels in (("qwen2-0.5b", ("flash_attention",)),
                          ("mamba2-130m", ("ssd_scan",)),
                          ("granite-moe-1b-a400m",
                           ("flash_attention", "gather_rows")),
                          ("olmoe-1b-7b", ("flash_attention", "gather_rows"))):
        if 4 not in phases:
            break
        lm = lm_wave(name, wrappers)
        on_path(f"the {name} wave", lm["launches"], kernels)
        if name in ("qwen2-0.5b", "mamba2-130m"):
            launches[kernels[0]] = lm["launches"][kernels[0]]
        if name in BF16_WAVES:
            b16, bf16_kernels = lm["bf16"], BF16_WAVES[name]
            on_path(f"the {name} bf16 wave", b16["launches"], bf16_kernels)
            if name in ("qwen2-0.5b", "mamba2-130m"):
                launches[bf16_kernels[0]] = b16["launches"][bf16_kernels[0]]
            for fp32_kernel in ("flash_attention", "ssd_scan"):
                if b16["launches"][fp32_kernel]:
                    fail(f"the {name} bf16 wave launched {fp32_kernel}")
            for mode in ("captured", "eager"):
                r, f = b16[mode], (lm if mode == "captured" else lm["eager"])
                log(f"lm wave {name} bf16 {mode}: {r['tok_per_s']:.1f} tok/s "
                    f"(fp32 {f['tok_per_s']:.1f}), {r['wave_ms']:.1f} ms per "
                    f"wave of {r['n_batches']} batches, prefill ms "
                    f"{r['prefill_ms']} (fp32 {f['prefill_ms']}), decode "
                    f"wave ms {r['decode_wave_ms']:.3f} (fp32 "
                    f"{f['decode_wave_ms']:.3f}), peak "
                    f"{r['peak_gib']:.3f} GiB (fp32 {f['peak_gib']:.3f}) "
                    f"({card})")
            vs, cpu = b16["vs_fp32"], b16["prefill_vs_cpu"]
            log(f"lm wave {name} bf16: first wave captured, replayed "
                f"{b16['first_wave_graphs']}; tokens equal the eager "
                f"engine's; prefill logits at {b16['cpu_repeats']} repeats "
                f"against the CPU's fp32 plain model: card {cpu['err']:.3e}, "
                f"CPU bf16 {cpu['plain_err']:.3e} (bar: twice it); full "
                f"depth against the fp32 wave (a report, no bar): "
                f"{vs['tokens_equal']} of {vs['tokens']} tokens equal, first "
                f"differing token per request {vs['first_differing_token']}, "
                f"largest prefill logit gap {vs['max_prefill_logit_gap']:.3e}"
                f" of {vs['max_abs_logit']:.3e}; launches "
                f"{b16['launches']}"
                + (f"; gather shapes [K, row bytes, launches] "
                   f"{b16['gather_shapes']}; routing against the CPU's "
                   f"bf16 model: {b16['routing_vs_cpu']['calls']} MoE "
                   f"calls, {routing_summary(b16['routing_vs_cpu'])}"
                   if b16["routing_vs_cpu"]["calls"] else ""))
        log(f"lm wave {name}: {json.dumps(lm, default=str)}")
        for mode, r in (("captured", lm), ("eager", lm["eager"])):
            log(f"lm wave {name} {mode}: {r['tok_per_s']:.1f} tok/s, "
                f"{r['wave_ms']:.1f} ms per wave of {r['n_batches']} batches "
                f"({r['n_prefill_batches']} prefill, "
                f"{r['n_decode_batches']} decode), prefill ms "
                f"{r['prefill_ms']}, decode wave ms "
                f"{r['decode_wave_ms']:.3f}; profiled wave: busy share "
                f"{r['profile']['busy_share']:.3f}, "
                f"{r['profile']['device_events']} device events, "
                f"{r['profile']['device_ms']:.2f} ms device of "
                f"{r['profile']['wall_ms']:.2f} wall ({card})")
        routing = lm["routing_vs_cpu"]
        log(f"lm wave {name}: first wave captured, replayed "
            f"{lm['first_wave_graphs']}; tokens equal the eager engine's: "
            f"{lm['tokens_equal_eager']}, the CPU run's "
            f"({lm['cpu_repeats']} repeats): {lm['tokens_equal_cpu']}; "
            f"prefill logits {lm['prefill_logits_rel_err_vs_cpu']:.3e} of "
            f"the largest |logit| from the CPU's"
            + (f"; routing against the CPU: {routing['calls']} MoE calls, "
               f"first differing call {routing['first_differing_call']}, "
               f"smallest top-K gap {routing['min_gap']:.3e}"
               if routing["calls"] else "")
            + f"; launches {lm['launches']}")
        del lm
        gc.collect()
        torch.cuda.empty_cache()
    log(f"lm waves done: {time.perf_counter() - t_start:.1f} s")

    for name, (rl_iters, run) in TREES_LATTICES.items():
        if 5 not in phases or name not in workloads:
            continue
        t0 = time.perf_counter()
        tl, counts = drive(lambda: run_slice("cuda", name, rl_iters=rl_iters,
                                             **run))
        tl["launches"] = counts
        needed = ["gather_rows"] + (["fused_gather_lstm_cell"]
                                    if name == "LatticeLSTM" else [])
        for kernel in needed:
            if counts[kernel] <= 0:
                fail(f"{kernel} was not launched during {name}")
        busy = tl["profile"]["bucketed"]["busy_share"]
        log(f"gather shapes {name} [K, row bytes, launches]: "
            f"{shape_histogram(gather_rows.shapes)}")
        log(f"workload {name}: {json.dumps(tl, default=str)}")
        log(f"workload {name}: {tl['graph_nodes']} nodes, "
            f"{tl['n_batches']} batches (lower bound "
            f"{tl['batch_lower_bound']}), ms per run {tl['ms_per_run']}, "
            f"lowering s {tl['lower_s']}, bucketed busy share {busy:.3f}, "
            f"launches {counts}, {time.perf_counter() - t0:.1f} s ({card})")
    if phases & {6, 7, 8}:
        t0 = time.perf_counter()
        policies = serve_policies(serve_workloads("cpu"))
        log(f"serve policies learned: {time.perf_counter() - t0:.1f} s")
    if 6 in phases:
        t0 = time.perf_counter()
        serve_launches = serve_phase(torch, drive, card, policies)
        log(f"serve launches of the row gather and the gather cell (replayed "
            f"steady passes): "
            + "; ".join(f"{trace} {c['gather_rows']}, "
                        f"{c['fused_gather_lstm_cell']}"
                        for trace, c in serve_launches.items())
            + f"; serve done: {time.perf_counter() - t0:.1f} s")
    if 7 in phases:
        t0 = time.perf_counter()
        launcher_launches = launcher_phase(torch, drive, card, policies)
        log(f"launcher launches of the row gather and the gather cell (run "
            f"(a)): {launcher_launches['gather_rows']}, "
            f"{launcher_launches['fused_gather_lstm_cell']}; launcher done: "
            f"{time.perf_counter() - t0:.1f} s")
    if 8 in phases:
        t0 = time.perf_counter()
        sharded_launches = sharded_phase(torch, drive, card, policies)
        log(f"sharded launches of the row gather and the gather cell (K=4 "
            f"steady pass): {sharded_launches['gather_rows']}, "
            f"{sharded_launches['fused_gather_lstm_cell']}; sharded done: "
            f"{time.perf_counter() - t0:.1f} s")
    if 9 in phases:
        t0 = time.perf_counter()
        rows.append(check_flash_backward(torch, timer))
        train_launches = train_phase(torch, drive, card, TRAIN_STEPS)
        launches["flash_attention_backward"] = \
            train_launches["flash_attention_backward"]
        on_path("Qwen2-0.5B training", train_launches,
                ("flash_attention", "flash_attention_backward"))
        log(f"train launches of the flash forward and backward kernels (run "
            f"(b)): {train_launches['flash_attention']}, "
            f"{train_launches['flash_attention_backward']}; train done: "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        rows.append(check_ssd_backward(torch, timer))
        ssm_launches = train_ssm_phase(torch, drive, card, TRAIN_STEPS)
        launches["ssd_scan_backward"] = ssm_launches["ssd_scan_backward"]
        on_path("Mamba2-130m training", ssm_launches,
                ("ssd_scan", "ssd_scan_backward"))
        gc.collect()
        torch.cuda.empty_cache()
        log(f"train launches of the scan's forward and backward kernels (run "
            f"(f)): {ssm_launches['ssd_scan']}, "
            f"{ssm_launches['ssd_scan_backward']}; ssm train done: "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        moe_launches = train_moe_phase(torch, drive, card, TRAIN_STEPS)
        on_path("Granite-MoE training", moe_launches,
                ("flash_attention", "flash_attention_backward",
                 "gather_rows", "gather_rows_backward"))
        granite_bwd = time_granite_backwards(torch, timer, card)
        log(f"moe train done: {time.perf_counter() - t0:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        rows.append(check_flash_backward_bf16(torch, timer))
        for row in rows:
            if row["name"] in granite_bwd:
                row["granite_train_shape"] = granite_bwd[row["name"]]
        rows.append(check_ssd_backward_bf16(torch, timer))
        bf16_train = train_bf16_phase(torch, drive, card, TRAIN_STEPS)
        for arch, (kernels, _) in BF16_TRAIN.items():
            on_path(f"{arch} bf16 training", bf16_train[arch]["launches"],
                    kernels)
            backward = list(kernels)[-1]
            launches[backward] = bf16_train[arch]["launches"][backward]
        log(f"train launches of the bf16 backward kernels (run (h)): "
            + ", ".join(f"{a} {list(k)[-1]} "
                        f"{bf16_train[a]['launches'][list(k)[-1]]}"
                        for a, (k, _) in BF16_TRAIN.items())
            + f"; bf16 train done: {time.perf_counter() - t1:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
    if 10 in phases:
        t0 = time.perf_counter()
        exec_launches = executor_train_phase(torch, drive, card)
        launches["gather_rows_backward"] = \
            exec_launches["gather_rows_backward"]
        on_path("TreeGRU training", exec_launches,
                ("gather_rows", "gather_rows_backward"))
        rows.append(check_gather_backward(
            torch, timer, exec_launches["commonest_backward_shape"]))
        if 2 in phases:
            rows[-1]["moe_shapes"] = moe_report["backward"]
        log(f"executor training launches of the gather and its backward "
            f"(run (10b)): {exec_launches['gather_rows']}, "
            f"{exec_launches['gather_rows_backward']}; done: "
            f"{time.perf_counter() - t0:.1f} s")
    if 11 in phases:
        t0 = time.perf_counter()
        cross = check_cross_attention(torch, timer)
        for row in rows:
            if row["name"] in ("flash_attention", "flash_attention_backward"):
                row["vision_shape"] = cross["forward" if row["name"] ==
                                            "flash_attention" else "backward"]
        vision = vision_phase(torch, drive, card)
        on_path("the vision model's prefill and decode",
                vision["prefill and decode"], ("flash_attention",))
        on_path("the vision model's training", vision["train"],
                ("flash_attention", "flash_attention_backward"))
        on_path("the vision model's bf16 prefill and decode",
                vision["bf16 prefill and decode"], ("flash_attention_bf16",))
        on_path("the vision model's bf16 training", vision["bf16 train"],
                ("flash_attention_bf16", "flash_attention_backward_bf16"))
        log(f"vision done: {time.perf_counter() - t0:.1f} s")
    if 12 in phases:
        t0 = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        dry_launches = dryrun_phase(torch, drive, card)
        on_path("dryrun --dynamic", dry_launches, ("gather_rows",))
        log(f"dryrun done: {time.perf_counter() - t0:.1f} s ({card})")
    if 13 in phases:
        t0 = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        remat_train_phase(torch, drive, card, on_path)
        remat_memory_phase(torch, card)
        log(f"remat done: {time.perf_counter() - t0:.1f} s ({card})")
    log(f"launches by path: {json.dumps(by_path)}")
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    if phases != set(range(1, 14)) or set(workloads) != set(TREES_LATTICES):
        log(f"partial run (phases {sorted(phases)}, workloads {workloads}): "
            f"no result lines")
        return 0
    for row in rows:
        row["launches"] = launches[row["name"]]
        row["launches_by_path"] = by_path.get(row["name"], {})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
