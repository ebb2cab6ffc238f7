#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; it puts ``src`` on ``sys.path`` itself,
builds the CUDA kernels from the checkout's sources, and needs one card.
Phases, one JSON line each:

1. device: the card's name and power limit (``nvidia-smi``), the build
   time of the CUDA library, and per instance of the flash-attention
   kernels (K1/B2, B3, B4), of B6, K2 and K3 the HMMA (tensor-core)
   instructions in the library's SASS (``cuobjdump -sass``) and its
   registers and spills (``-Xptxas -v``): fails unless every f32
   flash-attention instance at D=128 (K1/B2's and B4's split instances
   too) and every B6 instance has HMMA, every f32 K1/B2 instance has TMA
   loads and no cp.async (``_f32_fwd_problems``), every bf16 K1/B2, B3 and
   B4 instance at D64 and D128 has HGMMA and TMA loads and no HMMA or
   cp.async, and none of those and no K2 or K3 instance spills; it
   reports, without a gate, the registers and spilled bytes of every
   K1/B2, B3 and B4 instance at D128 and at stablelm-12b's D160;
2. kernels against their plain PyTorch versions at the shapes of the
   serving path (K1 and K3 at granite-3-8b's and at hymba-1.5b's, K1 with
   hymba's 1024-token window at S128 and S1100; K2 at the paged engine's
   decode batch of 4 and at batch 1, with 160 tokens in a 256-page table
   as the engine's tables are, and at 4096 tokens; K2 also through the
   prefix cache's tables, 4 rows sharing the pages of a 16-token system
   prompt at page size 8 and 16, and at 8 with one row's last prefix page
   a copy-on-write duplicate; K1 and K2 also at every shape phase 9's
   engines give them, ``SERVING_K1`` and ``SERVING_K2``: 8-token prefills
   of 1 and 4 prompts, and 8, 2 and 1 decode lanes at page sizes 4, 8
   and 16 over the engines' pools and tables, up to 88 tokens, with
   shared, never-admitted and retired rows; K1 and K2 also at every shape
   phase 10 gives them, ``FAMILY_K1`` and ``FAMILY_K2``: whisper's
   bidirectional encoder (B1 and B4 S1500 Hq20 D64), its decoder prompt
   and cross attention (Sq4 and Sq128 against Sk1500, and a ragged
   Sk1499), qwen2-vl's and arctic's prefills (Hq64 and Hq56, Hkv8 D128,
   S128 and S125) and paged decode at phase 3's table; K3 also at a
   decode step's 4 rows and a training microbatch's 4096; and at every
   shape and dtype phase 11 gives them: in bf16 K1 at llama4's one-prompt
   prefills (Hq40 Hkv8 D128, S128 and S125, ``LLAMA4_K1``) and K2 at its
   heads on phase 3's table; K3 at d_model 5120 (``SLICE_K3``): 11b's
   microbatches in f32 (128 to 4096 rows) and bf16 (1024), llama4's
   prompts, decode steps and head (128, 125, 4 and 1 rows) in bf16); and
   at the shapes of phases 6e, 10e, 10f and 11e, from their own stream
   (``_config_kernels``): K1 at stablelm-12b's one-prompt prefills (Hq32
   Hkv8 D160, S128 and S125) and K2 at its heads on phase 3's table, in
   f32 and bf16, B2-B4 (as phase 2b) at its training microbatch (B1
   S4096 Hq32 Hkv8 D160 causal, f32), K3 at qwen1.5-110b's d_model (128
   x 8192, f32): in
   f32 the max abs error (tolerance 5e-4); in bf16 the error against the plain version computed
   in f32 from the same bf16 inputs, in units of bf16 rounding at each
   element's magnitude (at most 1, ``_held``; a line first shows that an
   output 2 units off fails); the device time of the kernel, of the plain version and of one library
   call where PyTorch has one (each from a CUDA graph of back-to-back
   calls), the kernel's eager call time (host included), and the bound
   (the larger of the kernel's operations over the card's peak rate for
   the input type and its bytes over the card's memory rate: the
   kernel's function in ``kernels/work.py``, the peaks of
   ``core/roofline.py``'s H100), for K1 in f32 also the 3xTF32 bound
   (three passes at the TF32 peak: K1 runs on the tensor cores); before them
   the floor, a one-element in-place add timed the same way, which K3's
   lines also give as ``max(floor, bound)``;
2b. the training path's attention kernels (B2 forward with lse, B3 dq,
   B4 dk/dv) through their wrapper as training calls it (q, k, v that
   require grad through ``ops.flash_attention``, then
   ``torch.autograd.grad``; one launch of each) against their plain
   versions on the same inputs at the training shape (B1 S4096 Hq32 Hkv8
   D128 causal) and a ragged length (S4000), and at whisper's (B1 S1500
   Hq20 Hkv20 D64, non-causal as its encoder and cross attention run
   them, and causal as its decoder does), in f32 and bf16: max abs
   error and that error over the plain result's max magnitude (tolerance
   5e-4 f32, 2e-2 bf16, on the relative error), times and bounds as in
   phase 2, in f32 also the 3xTF32 bound; library: ATen's attention forward with logsumexp beside B2
   and its backward (dq, dk and dv in one call) beside B3 and B4
   (efficient attention in f32, flash attention in bf16, K and V
   expanded to the q heads outside the timed call), and SDPA's forward
   plus backward beside B2 + B3 + B4; also at each of 11b's microbatches
   (S128 Hq40 Hkv8 D128 causal, ``DEPLOY_ATTN``: B1-32 in f32, B8 in
   bf16); each line carries its launch's ``cluster`` (the C plan query:
   where the grid underfills the card, f32 B2 splits its key range and
   f32 B4 its GQA group), as phase 2's K1 lines do;
2c. kernel B6 (chunked WKV6) against its plain version on the same
   inputs: rwkv6 mode at rwkv6-3b's prefill shape (B1 T128 H40 K64 V64,
   with u, mild decay: every chunk on the rescaled product), the same at
   a ragged T125, SSD mode at hymba-1.5b's (B1 T128 H25 K16 V64, its
   per-head decay a broadcast view, past the range bound: the per-pair
   fallback), and B1 T4096 H40 K64 V64 in both decay regimes, in f32 and
   bf16: error over the plain result's max magnitude (tolerance 5e-4
   f32, 2e-2 bf16), times and the bound as in phase 2 (operations and
   branch counted from this run's decays), and at T128 the error against
   the exact per-token recurrence (``wkv6_ref``; 1e-3 f32, 5e-2 bf16);
   SSD mode also at T1100, the long prompts of phase 3c, against both;
3. serving at full width and full depth: granite-3-8b, 40 layers, f32,
   random weights from a seeded ``torch.Generator``, through the port's
   ``build_engine`` for the continuous and the paged scheduler on one
   workload, with each kernel's launch count over each run;
4. parity: per-request greedy tokens of the two engines are identical;
   full-width prefill logits through the kernels agree with the plain
   attention path;
5. (no longer run: the two engines' profiles under ``torch.profiler``
   went to keep the script inside its time limit; phases 3b, 3c and 6
   still profile their engines and steps);
3b/3c. serving at full width and full depth: rwkv6-3b (32 layers,
   d_model 2560, 40 heads of 64, LayerNorm) and hymba-1.5b (32 layers,
   d_model 1600, GQA 25:5, sliding window 1024, SSD heads with N=16),
   f32, seeded random weights, through the static and the continuous
   engine on phase 3's request mix (hymba's adds two prompts of 1100
   tokens, past its window, so K1's window mask, the prefill ring and
   decode's ring slot run). Timed in this process with cuBLAS's default
   workspace: per engine each kernel's launches (B6 32 per prefill; K1 32
   per prefill in hymba, none in rwkv6; K3 once per norm), latencies and
   peak memory, then the continuous engine's first four requests under
   the profiler. Then, in a child process without a cuBLAS workspace
   (``_serve_ssm_in_child``), the same runs again with identical greedy
   tokens per rid across the engines, and on the longest prompt every
   layer through the kernels against the plain path (dense attention,
   chunked linear attention) on the same input, within 1e-3 of the
   layer's update (its output minus its input, max magnitude); the
   prefill logits of the kernels, the plain path and the exact per-token
   recurrence pairwise within ``LOGIT_CEILING`` of their max magnitude
   (hymba 1e-3; rwkv6-3b's random init is chaotic over its depth in f32),
   the kernels within 1e-3 of the plain path or, where larger, within
   what the plain path and the recurrence differ by;
6. train: granite-3-8b at full width cut to 8 layers (f32 params,
   gradients, master copy and AdamW moments of 40 layers do not fit one
   80 GB card). First (6a) the gradient of every parameter leaf at the
   seeded params on step 0's first microbatch, through the kernels and
   through the plain attention path: each leaf within 1e-4 relative in L2
   norm. Then 3 steps of 2 x 4096 tokens in 2 microbatches with remat,
   through ``build_train_step`` and ``train_loop.run``, on the kernels;
   per step loss, grad_norm, seconds, tokens/s and each kernel's
   launches, the peak memory and the reckoning of the training state's
   bytes. Then the same 3 steps from the same seeded params and batches
   on the plain attention path: per-step loss and grad_norm within 1e-5
   (relative) of the kernel run; B3 and B4 at one launch per layer and
   microbatch (16 per step), B2 and K3 in every step, B6 in none.
   One more kernel step, after the counts are read, runs under
   ``torch.profiler`` (device time by kernel group, busy share);
6b. hymba-1.5b at full width and full depth (32 layers, its 1024-token
   window inside the 4096-token sequence): 6a's per-leaf gradients,
   reported (over 32 layers the plain path against itself, q moved by one
   ulp, differs by as much); each layer's gradients through the kernels
   and the plain path, from the plain path's own input to the layer and
   gradient at its output, within 1e-4; 3 steps through the kernels, each
   held to the plain path's step from the same params and batch (loss and
   grad_norm within 1e-5); B3 and B4 at 64 launches a step;
6c. rwkv6-3b at full width cut to 8 of its 32 layers: 3 clean steps with
   finite loss and grad_norm, every kernel's launch count 0 (LayerNorm,
   and the plain chunked ssm form that training pins: no port kernel on
   its path, so no kernel-vs-plain gate), step seconds, tokens/s and
   peak memory;
6e. stablelm-12b (LayerNorm, head dim 160) at full width cut to 4 of
   its 40 layers, as phase 6 (``TRAIN["6e"]``): 6a's per-leaf gradients
   within 1e-4, the kernels' and the plain path's 3-step trajectories
   within 1e-5; every step launches B2, B3 and B4 (the mma.sync
   instances at D160) and neither K1 nor K3 (``_step_launch_problems``);
6d. both families reduced (the reference's reduced configs: 2 layers,
   window 64, chunks of 16) at 2 x 128 tokens: 3 steps on the card
   through the kernels, each held to the same step on this machine's CPU
   through their plain versions, from the same params and batch: every
   leaf's gradient within 1e-4, the loss within 1e-5, and hymba's
   grad_norm within 1e-5 (rwkv6's carries its largest leaves' f32 error,
   2-3e-5 at step 2, and is reported);
   phases 6, 6b and 6c each count one more kernel step under
   ``core/cost.py``'s counter for their Tier-1 report (phase 8);
8. bench: the port's harness (``repro_torch.bench``) through its own API
   on the card, every launch count set to 0 before it: the structural
   suites (``allocation/*``, ``load_balance/{layers,hidden}``) with the
   H100's constants, ``load_balance/moe`` (the experts' LI of a reduced
   arctic block's routed forward), ``efficiency/measured`` (granite-3-8b
   at full width, 1, 2, 4 and 8 layers, 1 x 4096 tokens, f32, loss
   forward and backward through B2, B3, B4 and K3) and
   ``roofline/measured`` (the 8-layer step counted, its B2-B4 and K3
   work held to their launches times the per-call work), one line of
   their records; then the Tier-1 report (``Tier1Report.to_dict()``) of
   each training phase (6, 6b, 6c, 10a): its sections, the roofline of
   its counted step and its measured step
   seconds. Fails when a scenario raises or gives no record, when any
   ``mfu`` or ``mfu_measured`` exceeds 1.05, or when a training step's
   ``useful_flops_ratio`` exceeds 1.05 (granite's also at or below 0.5);
9. serving suite: the port's nine Tier-2 serving scenarios
   (``repro_torch.bench``'s ``serving/*``, the reference's shapes) through
   the harness's runner, every engine on one parameter set of
   granite-3-8b at full width and depth (40 layers, f32, seeded random
   weights), every launch count set to 0 before each scenario: one line
   per record (TTFT, per-token latency p50/p95, the derived fields) and
   one per scenario (seconds, launches); then the gates: greedy tokens
   equal per rid with the prefix cache on and off (shared burst,
   multi-turn replay, and the burst with rid 0's prompt sent again, which
   copies a page on write), higher peak concurrency and prefill tokens
   saved with the cache; no shared page's bytes changed while shared
   (``SharedPageWatch``); under the default fault plan every fault
   injected and recovered, no page leaked, completed requests
   token-identical to the fault-free run; the disaggregated engine
   token-identical to the interleaved one, one handoff per request that
   reached decode, a lower decode-step p95 stall;
10a. (phases 10a-10d run after 6d, before 8) whisper-large-v3 at full
   width and depth (32 encoder and 32 decoder layers, f32, seeded random
   weights): 4 requests of 1500 audio frames
   (the audio stub's embeddings) with 4-token decoder prompts and 64
   greedy tokens through ``serve_loop.generate``, on the kernels (K1: the
   encoder's and the cross attention's non-causal launches, the decoder
   prompt's causal ones) and on the plain path from the same parameters:
   greedy tokens identical per request, prefill logits within 1e-3; then
   training as phase 6 (``TRAIN["10a"]``): ``SyntheticLM(batch=2,
   seq=1500)`` in 2 microbatches with remat and AdamW, B2-B4 three times a
   layer pair (encoder self, decoder self, cross), 6a's leaves and the
   plain path's own trajectory, and beside them the plain path against
   itself with q moved by one ulp in every attention (what 64 layers make
   of one rounding);
10b. qwen2-vl-72b at full width cut to 8 of 80 layers: phase 3's request
   mix through the continuous and the paged engine on the kernels and
   the continuous engine on the plain path, greedy tokens identical
   across the three; and one prefill of vision-stub embeddings on a
   (t, h, w) = (2, 8, 8) position grid, so M-RoPE's three streams differ,
   against the plain path (logits within 1e-3);
10c. arctic-480b at full width cut to 1 of 35 layers (128 experts top-2,
   expert ff 4864, a dense residual MLP of 4864): as 10b's serving, and
   the experts' load summed over the kernel runs with its LI
   (``core/metrics.expert_load_imbalance``) and the smallest router
   margin of each engine's run; a token that differs is reported with
   both paths' top-2 logit margins and router margins;
10d. reduced arctic-480b and qwen2-vl-72b trained on the card and on the
   CPU as 6d;
10e. stablelm-12b at full width and full depth (40 layers, f32, 48.6 GB
   of weights) served as 10b: greedy tokens identical across the three
   runs, K1 in the continuous engine and K2 in the paged one (its
   attention at D160 on the mma.sync kernels), and K3 in no run of any
   of the three (LayerNorm; ``_norm_launches``);
10f. qwen1.5-110b (QKV bias, rope theta 1e6) at full width cut to 6 of 80
   layers (42.6 GB; the cut's reason in its weights line) served as 10b:
   tokens identical, K1 and K3 in the continuous engine, K2 and K3 in the
   paged one;
11a. (phases 11a-11d run after 10d, before 8) granite-3-8b as phase 6 (8
   layers, 2 x 4096 tokens, 2 microbatches, remat) with bf16 params, an
   f32 master, f32 moments and f32 gradient sums (``TRAIN["11a"]``):
   6a's per-leaf gradients and the 3-step trajectories, kernels against
   the plain path, within 2e-2; beside them the plain path against itself
   with q one bf16 ulp up; both paths profiled (device time by kernel
   group) with ``mfu_measured`` against the bf16 peak;
11b. the port's batch/precision suite (``deploy/batch`` B1-32 in f32,
   ``deploy/precision`` f32 and bf16 at B8, S128; the loss gradient of
   qwen2.5-32b at its published width cut to 4 layers) through the
   harness's runner: a record with a finite tok_s for every workload, B2,
   B3, B4 and K3 launched, the bf16/f32 tok_s ratio (Table IV);
11c. llama4-maverick-400b-a17b at full width cut to 1 of 48 layers in
   bf16 (36.5 GB; the init's peak reported): phase 3's request mix
   through the continuous and paged engines (one-chunk prefills) on the
   kernels and the continuous engine on the plain path (``_serve_family``
   in bf16); each prompt's prefill logits at every position, kernels
   against plain, within LOGIT_UNITS units of bf16 rounding at the
   largest logit (``_prefill_logits``: where the plain path lies within
   that of the plain path with its attention in f32, as 11e's does not),
   where both paths routed the tokens alike (a token sent
   to other experts, or dropped otherwise, is left out with what it
   reaches: its own position in the last layer), at least
   LOGIT_HELD_SHARE of the positions held; tokens per rid under the flip
   rule
   (``_flip_check``: identical up to the first differing step, where the
   plain path's top-2 logit margin must not exceed the largest prefill
   logit difference), the paged engine against the continuous one and the
   kernels against the plain path; TTFT and per-token p50/p95, peak
   memory, expert load and LI, and the smallest router margin over the
   run;
11e. (after 11c, before 11d) stablelm-12b at full width and full depth in
   bf16 (24.3 GB) as 11c: tokens under the flip rule, K1 and K2 on their
   mma.sync instances at D160 and no K3 in any run; its prefill logits
   through the same gate as 11c's, which takes the other measure where
   the run finds the plain path itself more than LOGIT_UNITS from the
   plain path with its attention in f32 (``_f32_attention``; 40 bf16
   layers grow its bf16 score roundings past that): the kernels no
   farther from that path than EXACT_RATIO (sqrt 2) times the plain path,
   and each of REJECTED_FAULTS, planted in the kernels' attention
   output, failing that gate (every fault of PLANTED_FAULTS reported);
11d. checkpoint and resume: granite-3-8b at full width, 1 layer, bf16
   params with an f32 master, 4 steps unbroken twice, then 2 steps
   saving, the state rebuilt from another seed and resumed through
   ``train_loop.run`` to step 4: the resumed steps' losses and grad norms
   equal the unbroken run's bit for bit (or within the two unbroken runs'
   difference); a save's bytes, save and restore seconds;
12a. (phases 12a-12e run after 11d, before 8) the kernel micro-benchmarks
   through the harness (``kernels/*``: K1, B6 and K3 against their plain
   versions and the library call, at the reference's shapes and the
   serving path's): every kernel record launched its kernel and holds
   phase 2's f32 gate, its time printed beside phase 2's at the path
   shape;
12b. a world-size-1 NCCL process group (a ``FileStore`` under ``build/``)
   and a (1, 1) data x model mesh: granite-3-8b at full width, 2 layers,
   f32, ``SyntheticLM(batch=2, seq=4096)``, 2 steps of the sharded step
   in the resident and the streaming mode against the unsharded step
   from the same params and batches (losses and grad norms within
   TRAIN_TOL), and every collective wrapper once on the card's tensors;
   without NCCL the phase fails (no gloo on the card);
12c. partitioned decode at qwen1.5-110b's heads (Hq64 Hkv8 D128), B4,
   f32, 32,768 cached tokens cut into 1, 2, 4 and 8 shards and combined
   (``combine_partials``), at cache_len 32,768 and at per-row lengths:
   within 1e-5 of the plain decode, each P's device time; over the
   one-rank mesh too; against K2 at 4,096 tokens within phase 2's gate;
12d. the reduced arctic-480b's ``moe_ffn_shardmap`` over the mesh on
   the card against the same function on the CPU: outputs within 1e-5,
   ``expert_load`` equal;
12e. the scalability suite (``scalability/*``) on the card: its one-rank
   point (dp1) runs over NCCL in a fresh process, every other point is
   recorded as not run for want of cards;
13a. (phases 13a-13c run after 12e, before 8) the dry run on the card's
   machine: ``launch/dryrun.py``'s ``run_cell`` for granite-3-8b
   ``train_4k`` on (16, 16) and arctic-480b ``decode_32k`` on (2, 16, 16),
   on ``meta`` over fake ranks (per-device flops, dot flops and bytes,
   collective bytes by opcode, the peak against 80 GB, the dominant
   roofline term, the count's seconds); then its gate: 12b's step
   (granite-3-8b at full width, 2 layers, f32, batch 2 x 4096, the
   resident sharded step on a (1, 1) mesh) counted on ``meta`` by the
   dry run and on the card's real tensors by ``count_cost``: flops, dot
   flops, bytes and collective bytes within COUNT_TOL relative, the
   kernels' calls equal (and equal to their launches), the dry run's
   peak within PEAK_TOL of the card's (``max_memory_allocated`` over the
   step above what the process held before its inputs);
13b. remesh on the card, over a world-size-1 NCCL group: 12b's step 4
   steps unbroken (twice), then 2 steps saving a sharded checkpoint,
   ``remesh`` onto a fresh (1, 1) mesh and 2 more: losses, grad norms and
   the final params equal bit for bit (or within the unbroken runs'
   difference, as 11d); then, in processes of their own,
   ``launch/train.py`` under one ``torchrun`` rank with
   ``--ckpt-dir`` (the reduced granite), 2 steps and then on to 4: the
   second launch prints ``resumed_from=1`` (the last step the first
   saved); those two run from the start of 13a, beside it and 13b;
13c. ``python -m repro_torch.bench --only scaling_matrix,trace_replay``
   through the harness's API on the card: the one-card points run (dp1,
   over NCCL in a fresh process, granite-3-8b at full width, 2 layers,
   8 x 1024 tokens), the others are named as not run; the 1x1 trace's
   identity replay within TRACE_GATE of its measured median (it is scaled
   to it) and its calibration ratio (that median over the roofline's
   longest lane) inside CALIBRATION_BAND; halving its compute lane
   predicts no longer a step; ``trace_replay/serve`` (the
   paged engine of full-width granite-3-8b, 8-token prompts, under
   ``TracingClock(WallClock)``) replays to the engine's busy time within
   1e-9; the trace's counted collective bytes printed (no link bytes at
   one rank);
14. (after phase 9, before the kernels line; no earlier phase sees a
   tuned cache) the launch parameters and the static analysis. 14a: the
   H100 launch limits of ``core/roofline.py`` (shared memory a block and an
   SM, threads a block, grid, warp, SMs, the runtime's reserve) equal the
   card's ``cudaDeviceGetAttribute`` and ``get_device_properties``, K2
   takes a cluster of 8; at every launch phases 2-13 made (each distinct
   kernel, shape and launch parameter, ``LaunchRecorder``) the wrapper
   passed the heuristic's Python mirror and the C plan query of today's
   launch (the parameter 0) equals ``analysis/kernel_lint.py``'s plan
   field by field; ``check_defaults`` clean. 14b: K2 at every split
   count, B6 at every V slice and K3 at every thread count their
   ``bench/tune.py`` candidates give at the path shapes (granite's
   decode B4 ctx160 Hq32 Hkv8 D128; rwkv6-3b's layer T128 H40 K64 V64
   with u; 128 x 4096), f32 and bf16: phase 2's gates against the plain
   version, two calls the same bits, the plan query equal to the lint's,
   device ms (a CUDA graph of calls) and the bound. 14c: ``tune/*``
   through the harness with ``REPRO_TUNED_DIR`` a fresh directory
   (removed, and the variable reset, after): each winner resolved and
   launched once by an ``ops`` call at its shape (the launcher's argument,
   the plan query and the counter show it) within phase 2's gates,
   ``check_all`` clean on the new cache, the resolvers' warm cost per
   call over 10,000 calls. 14d: ``graph_audit.audit_all`` on CUDA tensors
   clean. Phase 14 prints its own seconds (target: under 60);
7. the ``kernels`` summary line, with the launch counts of the serving
   (phases 3, 3b, 3c, 9, 10a-c, 10e-f, 11c, 11e), training (phases 6,
   6b, 6c, 6e, 6d, 10a, 10d, 11a, 11d, 12b) and bench (phases 8, 11b)
   runs; fails unless
   phase 8's steps launched
   B2, B3, B4 and K3, each scenario of phase 9 launched K3, K2 if it
   decodes from pages and K1 if it prefills in one shot
   (``SERVING_SCENARIOS``), whisper's prefill launched K1 three times a
   decoder layer and its training B2-B4 likewise, 10b's and 10c's
   engines launched K1, K2 and K3, 6e's steps B2, B3 and B4, 10e's and
   11e's engines K1 and K2, 10f's K1, K2 and K3, 11a's and 11b's steps
   B2, B3, B4 and K3, llama4's engines K1, K2 and K3, 12b's sharded
   steps B2, B3, B4 and K3, 12c K2, 13a's and 13b's steps B2, B3, B4 and
   K3, and 13c's served engines K2 and K3 (stablelm-12b's paths, 6e, 10e
   and 11e, fail their own phases if they launch K3, and every training
   step its phase if it launches K1: ``_norm_launches``,
   ``_step_launch_problems``).

Any failure raises and exits non-zero. Without a CUDA device, or outside a
checkout, it exits non-zero before printing any result. The last line of
standard output is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

ARCH = "granite-3-8b"
SSM_ARCHS = {"rwkv6-3b": 0, "hymba-1.5b": 1100}   # arch -> long prompt
SSM_CHILD_FLAG = "--serve-ssm"   # runs phase 3b or 3c alone, in a child
EXACT_TOL = {"float32": 1e-3, "bfloat16": 5e-2}   # B6 vs the recurrence
LOGIT_TOL = 1e-3    # kernels vs plain path, over the logits' max magnitude
# Ceiling on the difference of the prefill logits, over their max magnitude,
# between any two of the kernels, the plain path and the exact per-token
# recurrence. rwkv6-3b at its random init amplifies last-bit differences over
# its 32 layers in f32: on the H100 the two exact plain methods differ by
# 4.5e-2 (PERF.md, Findings), hymba-1.5b's by 7.2e-5.
LOGIT_CEILING = {"rwkv6-3b": 0.1, "hymba-1.5b": LOGIT_TOL}
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 3, 2, 4096
REDUCED_TRAIN_SEQ = 128   # phase 6d: past the reduced window of 64
# Training phases: the arch; a cut of its depth (0: all of it; 6d, 10d: the
# reduced config's); its sequence length (TRAIN_SEQ unless "seq"); why the
# depth was cut; how the run is held:
# "free" - two free-running trajectories, the kernels' and the plain
#   path's, per-step loss and grad_norm within TRAIN_TOL, and every leaf's
#   step-0 gradient within GRAD_TOL (6a);
# "forced" - each step of the kernels' run against a reference step from
#   the same params and batch (the plain path on the card, or 6d's CPU),
#   the reference's update not taken, within TRAIN_TOL; each layer's
#   step-0 gradients within GRAD_TOL on the plain path's own input and
#   output gradient (6b). For models whose depth and random init amplify
#   last-bit differences past the tolerances in a whole model or a free
#   trajectory (PERF.md, Findings);
# "none" - no port kernel on the path: clean steps, finite metrics, every
#   launch count 0.
# "held": the per-step metrics a trajectory holds within TRAIN_TOL. rwkv6's
# grad_norm after a few steps carries its largest leaves' f32 error (card
# against CPU from the same params: 2-3e-5 in embed.tok, wr, wk, PERF.md,
# Findings), so 6d holds its loss and, like 6a, each leaf within GRAD_TOL.
TRAIN = {
    "6": dict(arch="granite-3-8b", layers=8, gate="free",
              held=("loss", "grad_norm"),
              cut="f32 params, grads, master and two AdamW moments of 40 "
                  "layers (~164 GB) exceed one 80 GB card"),
    "6b": dict(arch="hymba-1.5b", layers=0, gate="forced",
               held=("loss", "grad_norm"), cut=None),
    "6c": dict(arch="rwkv6-3b", layers=8, gate="none", held=(),
               cut="f32 params, grads, master and two AdamW moments of 32 "
                   "layers (3.08 B params, ~62 GB) and the plain chunked "
                   "form's per-chunk decay tensors exceed one 80 GB card"),
    "6d-rwkv6": dict(arch="rwkv6-3b", layers=2, gate="forced",
                     held=("loss",), cut=None),
    "6d-hymba": dict(arch="hymba-1.5b", layers=2, gate="forced",
                     held=("loss", "grad_norm"), cut=None),
    "10a": dict(arch="whisper-large-v3", layers=0, seq=1500, gate="free",
                held=("loss", "grad_norm"), cut=None, one_ulp=True),
    "10d-arctic": dict(arch="arctic-480b", layers=2, gate="forced",
                       held=("loss", "grad_norm"), cut=None),
    "10d-qwen2-vl": dict(arch="qwen2-vl-72b", layers=2, gate="forced",
                         held=("loss", "grad_norm"), cut=None),
    # bf16 params with an f32 master, f32 moments and f32 gradient sums,
    # held at TOL["bfloat16"] (``_train_tol``); both paths profiled
    "11a": dict(arch="granite-3-8b", layers=8, gate="free",
                held=("loss", "grad_norm"), one_ulp=True, dtype="bfloat16",
                cut="bf16 params, f32 gradient sums, master and two AdamW "
                    "moments of 40 layers (18 B a parameter, ~147 GB) "
                    "exceed one 80 GB card"),
    # phase 11d's checkpointed run (``_ckpt_resume``, not ``_train``)
    "11d": dict(arch="granite-3-8b", layers=1, dtype="bfloat16",
                cut="a checkpoint a layer deep: 0.40 B parameters, 5.6 GB "
                    "a save"),
    # stablelm-12b: LayerNorm (no K3 on its path) and head dim 160, whose
    # B2-B4 run the mma.sync kernels
    "6e": dict(arch="stablelm-12b", layers=4, gate="free",
               held=("loss", "grad_norm"),
               cut="f32 params, grads, master and two AdamW moments of 40 "
                   "layers (12.14 B params, ~243 GB) exceed one 80 GB card; "
                   "4 layers reckon 2.14 B params, ~43 GB of state, and "
                   "leave room for the 100,352-row logits and the plain "
                   "path's S4096 scores"),
}
TRAIN_TOL = {"loss": 1e-5, "grad_norm": 1e-5}   # relative, kernel vs plain
GRAD_TOL = 1e-4   # per leaf, |g_kernel - g_plain| / |g_plain| (L2 norms)
# leaves whose gradient is zero in exact arithmetic where keys are not
# rotated: a key bias adds q . bk to every score of a query's row, which the
# softmax ignores. Both paths
# give rounding noise there, which no relative gate can hold (whisper's
# kernel and plain bk gradients differ by up to 28x, and the plain path's
# by 1.6x from itself with q one ulp up; PERF.md, Findings, PR 20), so
# these are held absolutely: norm over the global gradient norm
ZERO_GRAD_LEAVES = (".bk",)
TOL = {"float32": 5e-4, "bfloat16": 2e-2}
# phase 8: the harness's scenarios it runs, efficiency/measured's depths,
# the kernels its training steps must launch, and its gates
BENCH_SCENARIOS = ("allocation/layers", "allocation/hidden",
                   "allocation/archs", "load_balance/layers",
                   "load_balance/hidden", "load_balance/moe",
                   "efficiency/measured", "roofline/measured")
BENCH_LAYERS = (1, 2, 4, 8)
BENCH_KERNELS = ("flash_attention_lse", "flash_attention_dq",
                 "flash_attention_dkv", "rmsnorm")
MFU_CEILING = 1.05      # no card gives more than its peak
USEFUL_CEILING = 1.05   # above it, the counter missed work the model does
GRANITE_USEFUL_FLOOR = 0.5
TIER1_ARCHS = ("granite-3-8b", "hymba-1.5b", "rwkv6-3b", "whisper-large-v3")
SYSTEM_LEN = 16   # the prefix cache's shared system prompt (phases 2, 9)
# phase 9: the serving suite's scenarios, in the suite's order, and the
# kernels each must launch: K1 in every continuous or static prefill, K2 in
# every paged and disaggregated decode step, K3 in every norm
SERVING_SCENARIOS = {
    "serving/goodput_vs_load": ("flash_attention", "rmsnorm"),
    "serving/static_vs_continuous": ("flash_attention", "rmsnorm"),
    "serving/paged_vs_monolithic": ("flash_attention", "paged_attention",
                                    "rmsnorm"),
    "serving/paged_page_size": ("paged_attention", "rmsnorm"),
    "serving/prefix_shared_burst": ("paged_attention", "rmsnorm"),
    "serving/multi_turn_replay": ("paged_attention", "rmsnorm"),
    "serving/chaos_soak": ("paged_attention", "rmsnorm"),
    "serving/pd_disaggregation": ("paged_attention", "rmsnorm"),
    "serving/slot_balance": ("flash_attention", "rmsnorm"),
}
# phase 2 holds K1 and K2 at the shapes phase 9's engines give them. K1:
# (batch, prompt) of the continuous engine's one-prompt and the static
# engine's four-prompt 8-token prefills, causal at Hq32 Hkv8 D128. K2:
# (lanes, page size, table width, pool pages) of each paged or
# disaggregated engine, with lengths at the longest contexts its
# scenarios reach (a length of 1 is a lane never admitted), the first
# ``shared`` table entries common to every live row (a shared system
# prompt) and the rows in ``retired`` stale lanes whose table is null
SERVING_K1 = ((1, 8), (4, 8))
SERVING_K2 = (
    # B, ps, npag, P, lens, shared, retired      scenarios
    (8, 8, 4, 16, (32, 32, 32, 32, 30, 30, 1, 1), 2, ()),  # paged_vs_mono,
    #                                                        prefix burst
    (8, 8, 11, 45, (88, 56, 40, 33, 1, 1, 1, 1), 0, (3,)),  # replay
    (8, 4, 8, 32, (17, 20, 12, 20, 12, 20, 12, 1), 0, ()),  # paged_ps4
    (8, 16, 2, 8, (20, 13, 12, 20, 12, 1, 1, 1), 0, ()),    # paged_ps16
    (2, 4, 6, 13, (15, 11), 0, (1,)),                       # chaos_soak
    (2, 4, 7, 15, (28, 26), 0, ()),                         # pd interleaved
    (2, 4, 7, 15, (28, 17), 0, (1,)),                       # pd interleaved
    (1, 4, 7, 15, (27,), 0, ()),                            # pd disagg
)
# phase 2 holds K1 and K2 at the shapes phase 10 gives them. K1: (batch,
# Sq, Sk, Hq, Hkv, D, causal) of whisper's served prefill (B4: encoder,
# decoder prompt, cross attention), a training microbatch's encoder (B1),
# a 128-token prompt's cross attention and a ragged key length; then
# qwen2-vl's and arctic's one-prompt prefills of phase 3's mix (the
# vision-stub prefill of 10b is the S128 line). K2: (Hq, Hkv) of qwen2-vl
# and arctic at phase 3's paged table (B4 ctx160 ps16 table 10), with
# their head dim. qwen1.5-110b's prefills and decode (10f) have qwen2-vl's
# heads, Hq64 Hkv8 D128, so its lines are qwen2-vl's; stablelm-12b's (10e,
# 11e) are STABLELM_K1 and STABLELM_K2
FAMILY_K1 = (
    (4, 1500, 1500, 20, 20, 64, False), (4, 4, 4, 20, 20, 64, True),
    (4, 4, 1500, 20, 20, 64, False), (1, 1500, 1500, 20, 20, 64, False),
    (1, 128, 1500, 20, 20, 64, False), (1, 128, 1499, 20, 20, 64, False),
    (1, 128, 128, 64, 8, 128, True), (1, 125, 125, 64, 8, 128, True),
    (1, 128, 128, 56, 8, 128, True), (1, 125, 125, 56, 8, 128, True),
)
FAMILY_K2 = ((64, 8, 128), (56, 8, 128))
# phase 2b's attention shapes: (B, S, Hq, Hkv, D, causal), granite's
# training microbatch and a ragged length, then whisper's (non-causal:
# its encoder and cross attention; causal: its decoder)
TRAIN_ATTN = ((1, TRAIN_SEQ, 32, 8, 128, True), (1, 4000, 32, 8, 128, True),
              (1, 1500, 20, 20, 64, False), (1, 1500, 20, 20, 64, True))
# phase 11b: the port's batch/precision suite, its batches (deploy/batch's
# in f32; deploy/precision's B8 in f32 and bf16) and the records it must
# give; phase 2 holds B2-B4 at each of its microbatches in each dtype it
# runs them in (S128, qwen2.5's GQA 40:8 at D128)
DEPLOY_SCENARIOS = ("deploy/batch", "deploy/precision")
DEPLOY_BATCHES = (1, 2, 4, 8, 16, 32)
DEPLOY_RECORDS = tuple(f"deploy/batch{b}" for b in DEPLOY_BATCHES) + (
    "deploy/precision_float32", "deploy/precision_bfloat16")
DEPLOY_ATTN = {
    "float32": tuple((b, 128, 40, 8, 128, True) for b in DEPLOY_BATCHES),
    "bfloat16": ((8, 128, 40, 8, 128, True),)}
# phase 11c: llama4-maverick at full width cut to 1 of 48 layers, bf16
# (18.24 B parameters: 72.96 GB in f32, 36.5 GB in bf16); its prefill
# logits through the kernels within LOGIT_UNITS units of bf16 rounding at
# the plain logits' largest magnitude, at every position whose token the
# router sent to the same expert, kept, on both paths; at least
# LOGIT_HELD_SHARE of the positions. Phase 2 holds K1 at its one-prompt
# prefills (causal, Hq40 Hkv8 D128) and K2 at its heads on phase 3's
# paged table, in bf16; and K3 at d_model 5120 (both models') per dtype:
# 11b's microbatches (128 rows a sequence), llama4's prompts (128 and 125
# rows), its decode steps (4) and its head's last position (1)
LLAMA4 = "llama4-maverick-400b-a17b"
STABLELM, QWEN15 = "stablelm-12b", "qwen1.5-110b"   # phases 6e, 10e-f, 11e
LOGIT_UNITS = 4
LOGIT_HELD_SHARE = 0.9
# The prefill logits of 11c and 11e also go through a third path, the
# plain one with its attention computed in f32 from the same bf16 q, k and
# v and rounded once ("exact": ``_f32_attention``, phase 2's bf16
# reference). Where the run finds the plain path within LOGIT_UNITS of
# exact, the kernels are held to the plain path within LOGIT_UNITS (11c).
# Where it finds it farther (over stablelm-12b's 40 bf16 layers any
# rounding difference grows to 5-6 units; PERF.md, Findings), that measure
# cannot tell the kernels from the plain path's own roundings, and they
# are held no farther from exact than EXACT_RATIO times the plain path
# (two independent roundings of one size differ by sqrt(2) times either,
# as tests/test_torch_bf16.py holds the port's bf16 to JAX's). That gate
# must then reject each fault of REJECTED_FAULTS planted in the kernels'
# attention (``_planted_fault``); every fault of PLANTED_FAULTS is run and
# reported: ("ulps", k) moves each element of K1's output k units of its
# own bf16 rounding in every layer, ("p_bf16", 0) rounds the softmax
# weights once to bf16 before their product with v. On stablelm-12b's 40
# layers the ratio went 1.30-1.60 at k = 1, 1.67-2.09 at 2, 2.82-3.51 at 4
# and 0.90-1.11 for "p_bf16" (PERF.md): the gate sees two units an element
# on every prompt, one on some, and not P kept in one bf16 term, which
# phase 2's bf16 K1 lines hold within one unit of the f32 attention
EXACT_RATIO = math.sqrt(2.0)
PLANTED_FAULTS = (("ulps", 1), ("ulps", 2), ("ulps", 4), ("ulps", 8),
                  ("p_bf16", 0))
REJECTED_FAULTS = (("ulps", 2), ("ulps", 4), ("ulps", 8))
LLAMA4_K1 = ((1, 128, 128, 40, 8, 128, True), (1, 125, 125, 40, 8, 128, True))
LLAMA4_K2 = ((40, 8, 128),)
SLICE_K3 = {"float32": tuple((128 * b, 5120) for b in DEPLOY_BATCHES),
            "bfloat16": ((128, 5120), (125, 5120), (4, 5120), (1, 5120),
                         (1024, 5120))}
# the kernels each of phase 11's paths must launch: B2-B4 and K3 in 11a's
# bf16 training and 11b's suite, K1 and K3 in llama4's continuous engine,
# K2 and K3 in its paged one
BF16_PATHS = {
    **{p: ("flash_attention_lse", "flash_attention_dq", "flash_attention_dkv",
           "rmsnorm") for p in ("train:11a", "deploy")},
    f"{LLAMA4}:continuous": ("flash_attention", "rmsnorm"),
    f"{LLAMA4}:paged": ("paged_attention", "rmsnorm"),
    # 11e: stablelm-12b in bf16, whose attention at head dim 160 runs the
    # mma.sync kernels; LayerNorm, so no K3 (``_norm_launches``)
    f"{STABLELM}:continuous:bf16": ("flash_attention",),
    f"{STABLELM}:paged:bf16": ("paged_attention",),
}
# phase 12: the sharded step's arch, depth and batch (12b); partitioned
# decode at qwen1.5-110b's heads over 32,768 cached tokens, cut into P
# shards, with per-row lengths too, and against K2 at 4,096 tokens (12c);
# the kernels each of its paths must launch
SHARDED = dict(arch="granite-3-8b", layers=2, batch=2, seq=4096, steps=2)
DECODE = dict(B=4, Hq=64, Hkv=8, D=128, S=32768, K2_S=4096, ps=16)
DECODE_SHARDS = (1, 2, 4, 8)
DECODE_ROWS = (32768, 20000, 37, 5)
PHASE12_PATHS = {
    **{f"train:12b-{m}": ("flash_attention_lse", "flash_attention_dq",
                          "flash_attention_dkv", "rmsnorm")
       for m in ("resident", "streaming")},
    "12c": ("paged_attention",)}
SCAL_TIMEOUT = 300      # 12e: seconds a point's ranks may take
# phase 13: the dry run's cells (arch, shape, multi-pod) on the card's
# machine (13a); its gate on 12b's step counted on meta and on the card
# (flops, dot flops, bytes, collective bytes relative; peaks relative);
# remesh's unbroken steps and the step it saves after (13b); the 1x1
# trace's identity replay against its measured median (13c, the
# reference's trace-replay-error bound); the kernels each path launches
DRYRUN_CELLS = (("granite-3-8b", "train_4k", False),
                ("arctic-480b", "decode_32k", True))
COUNT_TOL, PEAK_TOL = 1e-9, 0.10
REMESH_STEPS, REMESH_SPLIT = 4, 2
TRACE_GATE = 0.25
# 13c: the 1x1 trace's measured step over its roofline's longest lane (f32
# at the FMA units' peak, HBM at its rate): below 1 the card beat its
# roofline, so the count or the rates are wrong; above 2 the step lost more
# than half its time to what no lane holds (1.43 on the H100, PERF.md)
CALIBRATION_BAND = (1.0, 2.0)
PHASE13_PATHS = {
    **{f"train:13{p}": ("flash_attention_lse", "flash_attention_dq",
                        "flash_attention_dkv", "rmsnorm") for p in "ab"},
    "13c": ("paged_attention", "rmsnorm")}
CKPT_STEPS, CKPT_EVERY = 4, 2   # phase 11d: the unbroken run, the save
# phase 10: whisper's served requests; the depth each served model runs
# at (0: all of it) and why it was cut; and 11c's llama4 (1 of 48 layers,
# bf16: 36.5 GB). stablelm-12b whole in f32 (10e) and bf16 (11e): 12.14 B
# parameters, 48.6 and 24.3 GB
WHISPER = dict(requests=4, frames=1500, prompt=4, new_tokens=64)
FAMILY_LAYERS = {"qwen2-vl-72b": 8, "arctic-480b": 1, STABLELM: 0,
                 QWEN15: 6}
SERVED_LAYERS = {**FAMILY_LAYERS, LLAMA4: 1}
SERVED_CUT = {
    "qwen2-vl-72b": "f32 params of 80 layers (~290 GB) exceed one 80 GB "
                    "card",
    "arctic-480b": "f32 params of 35 layers (~1.9 TB) exceed one 80 GB card",
    LLAMA4: "params of 48 layers (~1.6 TB in bf16) exceed one 80 GB card",
    QWEN15: "f32 params of 80 layers (111 B params, ~445 GB) exceed one 80 "
            "GB card; 6 layers reckon 10.65 B params, 42.6 GB, and an init "
            "peak near 56 GB",
}
FAMILY_PHASE = {"qwen2-vl-72b": "10b", "arctic-480b": "10c", STABLELM: "10e",
                QWEN15: "10f"}
MROPE_GRID = (2, 8, 8)     # 10b's vision prefill: (t, h, w) patches
PAGED_CHUNK = {"qwen2-vl-72b": 64, "arctic-480b": 0, LLAMA4: 0,
               STABLELM: 64, QWEN15: 64}  # 0: one chunk
# the kernels each of phase 10's paths must launch: K1 in whisper's
# prefill, B2-B4 in its training, K1 in the continuous engines' and K2 in
# the paged engines' runs of 10b, 10c, 10e and 10f, and K3 in both where
# the model's norm is RMSNorm: stablelm-12b's LayerNorm launches none
# (``_norm_launches``)
FAMILY_PATHS = {
    "whisper:serve": ("flash_attention",),
    "train:10a": ("flash_attention_lse", "flash_attention_dq",
                  "flash_attention_dkv"),
    **{f"{a}:{e}": k for a in ("qwen2-vl-72b", "arctic-480b", QWEN15)
       for e, k in (("continuous", ("flash_attention", "rmsnorm")),
                    ("paged", ("paged_attention", "rmsnorm")))},
    f"{STABLELM}:continuous": ("flash_attention",),
    f"{STABLELM}:paged": ("paged_attention",),
}
# phase 2's lines at the shapes stablelm-12b and qwen1.5-110b give the
# kernels, from their own stream (8): K1 at stablelm's one-prompt prefills
# of phase 3's mix (Hq32 Hkv8 D160, S128 and S125) in f32 and bf16 (10e,
# 11e), K2 at its heads on phase 3's paged table in both, B2-B4 at its
# training microbatch (6e, f32) and K3 at qwen1.5's d_model 8192 for a
# 128-token prompt (10f, f32)
STABLELM_K1 = ((1, 128, 128, 32, 8, 160, True),
               (1, 125, 125, 32, 8, 160, True))
STABLELM_K2 = ((32, 8, 160),)
STABLELM_ATTN = ((1, TRAIN_SEQ, 32, 8, 160, True),)
QWEN15_K3 = ((128, 8192),)
KERNELS = {
    "flash_attention": dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:40"),
    "flash_attention_lse": dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:97"),
    "flash_attention_dq": dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention.py:183"),
    "flash_attention_dkv": dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention.py:225"),
    "paged_attention": dict(
        route="cuda", source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:46"),
    "rmsnorm": dict(
        route="cuda", source="src/repro_torch/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm.py:19"),
    "wkv6": dict(
        route="cuda", source="src/repro_torch/csrc/wkv6.cu",
        replaces="src/repro/kernels/rwkv6.py:46"),
}


PYCACHE = ROOT / "build" / "pycache"


def emit(obj) -> None:
    print(json.dumps({**obj, "elapsed_s": time.perf_counter() - T0}),
          flush=True)


def bound(flops: float, nbytes: float, dtype: str):
    """(ms, what bounds it) of the larger of ``flops`` over the H100's peak
    for ``dtype`` and ``nbytes`` over its memory rate
    (``repro_torch.core.roofline.H100``)."""
    from repro_torch.core.roofline import H100
    t_ops = flops / H100.peak(dtype)
    t_bytes = nbytes / H100.hbm_bw
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def bound_3xtf32(flops: float, nbytes: float) -> float:
    """The bound of f32 work done on the tensor cores as three TF32 passes
    (K1-B4 in f32), in ms."""
    from repro_torch.core.roofline import H100
    return max(3 * flops / H100.peak("tf32"), nbytes / H100.hbm_bw) * 1e3


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside this script; "
              "run it from the root of a checkout", file=sys.stderr)
        return 2
    # the bytecode of every module this run imports goes under build/, so
    # the processes it starts (phases 3b/3c, 12e, 13b, 13c), each a fresh
    # interpreter, load torch's modules from it instead of compiling their
    # sources again: an installation without bytecode beside its sources
    # spent about 10 s a process on that
    sys.pycache_prefix = os.environ["PYTHONPYCACHEPREFIX"] = str(PYCACHE)
    sys.dont_write_bytecode = False
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is false; this "
              "smoke test needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    if sys.argv[1:2] == [SSM_CHILD_FLAG]:      # phase 3b or 3c, see below
        dev = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _serve_ssm_parity(dev, sys.argv[2])
        return 0
    import torch.nn.functional as F

    from repro_torch.kernels import _build, ops, ref, work

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ------------------------------------------------------------ 1 device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    lib_path = _build.build_library()
    build_s = time.perf_counter() - t0
    _build.library()
    ptxas = _ptxas_summary(lib_path.parent / "build.log")
    attn = _attn_build_report(lib_path)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "cuda_library_build_s": build_s, "ptxas": ptxas,
          "attention_sass": attn,
          # f32 K1/B2's and B4's registers, unsplit and split
          "f32_d128_registers": {
              n: attn.get(n, {}).get("registers") for n in F32_D128},
          # registers and spilled bytes of every flash-attention instance
          # at the head dims the models run on mma.sync and wgmma: 128,
          # and stablelm-12b's 160 (reported, not gated)
          "d128_d160_registers_spills": _head_dim_report(attn, (128, 160))})
    # the flash-attention kernels run on the tensor cores without spilling
    # at the serving and training paths' head dim, in both dtypes: K1/B2,
    # B3 and B4 (and K1/B2's and B4's instances that split their work)
    # in f32 on mma.sync (HMMA; K1/B2 fed by TMA, _f32_fwd_problems), and
    # in bf16 at D64 and D128 on wgmma fed by TMA (_wgmma_problems)
    short = [n for n in F32_D128
             if attn.get(n, {}).get("hmma", 0) <= 0
             or attn[n].get("spill_bytes", 1) != 0]
    if short:
        raise AssertionError(f"no HMMA or spills in {short}: {attn}")
    short = _f32_fwd_problems(attn)
    if short:
        raise AssertionError(f"the f32 forward's instances: {short}: {attn}")
    short = [p for kernel in WGMMA_KERNELS
             for p in _wgmma_problems(attn, kernel)]
    if short:
        raise AssertionError(f"the bf16 wgmma instances: {short}: {attn}")
    # B6 runs on the tensor cores, and neither B6 nor K2 spills, in every
    # instance the launchers can pick
    b6 = [n for n in attn if n.startswith("B6 ")]
    k2 = [n for n in attn if n.startswith("K2 ")]
    short = [n for n in b6 if attn[n].get("hmma", 0) <= 0] + [
        n for n in b6 + k2 if attn[n].get("spill_bytes", 1) != 0]
    if not b6 or not k2 or short:
        raise AssertionError(f"B6/K2 instances missing, without HMMA or "
                             f"spilling ({short}): {attn}")
    # K3 (no products, so no HMMA): every instance, none spilling
    k3 = [n for n in attn if n.startswith("K3 ")]
    short = [n for n in k3 if attn[n].get("spill_bytes", 1) != 0]
    if not k3 or short:
        raise AssertionError(f"K3 instances missing or spilling ({short}): "
                             f"{attn}")

    # ----------------------------------------------------------- 2 kernels
    gen = torch.Generator(device=dev).manual_seed(0)
    gen_hymba = torch.Generator(device=dev).manual_seed(1)
    gen_k2 = torch.Generator(device=dev).manual_seed(2)
    gen_k3 = torch.Generator(device=dev).manual_seed(3)
    gen_share = torch.Generator(device=dev).manual_seed(4)
    gen_serve = torch.Generator(device=dev).manual_seed(5)
    gen_family = torch.Generator(device=dev).manual_seed(6)
    gen_slice = torch.Generator(device=dev).manual_seed(7)
    gen_config = torch.Generator(device=dev).manual_seed(8)

    def rand(shape, dtype, hymba=False, stream=0):
        # the lines at hymba-1.5b's shapes (stream 1), K2's wide-table lines
        # (stream 2) and K3's decode and training lines (stream 3) draw from
        # their own streams, as do K2's shared-table lines (stream 4), the
        # K1 and K2 lines at phase 9's shapes (stream 5) and at phase 10's
        # and phase 2b's whisper lines (stream 6), at phase 11's (stream
        # 7) and at stablelm-12b's and qwen1.5-110b's (stream 8), so the
        # other lines keep the inputs they had before those were added
        g = (gen_hymba if hymba or stream == 1 else gen_k2 if stream == 2
             else gen_k3 if stream == 3 else gen_share if stream == 4
             else gen_serve if stream == 5 else gen_family if stream == 6
             else gen_slice if stream == 7 else gen_config if stream == 8
             else gen)
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    # the floor under any one-kernel call: a one-element in-place add,
    # timed as the kernels are
    one = torch.zeros(1, device=dev)
    floor_ms, floor_call_ms = _time_ms(lambda: one.add_(1.0))
    emit({"phase": "floor", "op": "one-element in-place add_",
          "ms": floor_ms, "call_ms": floor_call_ms})

    summary = {}   # kernel -> its f32 line at the serving path's shape
    failures = []
    recorder = LaunchRecorder().install()   # phases 2-13's launches (14a)

    def record(line, main_path):
        # phase 2's bf16 lines are held in units of bf16 rounding
        # (``_held``); the training kernels and B6 to an error relative to
        # the plain result's largest magnitude, and to one launch each
        # through their wrapper; the rest to an absolute error
        if "max_ulp_err" in line:
            close = line["max_ulp_err"] <= line["ulp_tol"]
        else:
            close = line.get("rel_err", line["max_abs_err"]) <= line["tol"]
        line["ok"] = close and line.get("launches_in_one_call", 1) == 1
        emit(line)
        if not line["ok"]:
            failures.append(line)
        if main_path:
            summary[line["kernel"]] = line

    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        # K1: one-shot prefill, granite's GQA 32:8 at head dim 128, and
        # hymba-1.5b's GQA 25:5 at head dim 64 with its 1024-token window
        # (S1100: the long prompts of phase 3c, past the window); then
        # (their own stream) phase 9's 8-token prefills
        for B, S, Hq, Hkv, D, W in (
                (1, 128, 32, 8, 128, 0), (1, 125, 32, 8, 128, 0),
                (1, 2048, 32, 8, 128, 0), (1, 128, 25, 5, 64, 1024),
                (1, 1100, 25, 5, 64, 1024),
                *((b, s, 32, 8, 128, 0) for b, s in SERVING_K1)):
            serve = (B, S) in SERVING_K1
            kw = dict(causal=True, window=W)
            q, k, v = (rand((B, S, h, D), dtype, hymba=bool(W),
                            stream=5 if serve else 0)
                       for h in (Hq, Hkv, Hkv))
            out = ops.flash_attention(q, k, v, **kw)
            want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                           **kw)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            pos = torch.arange(S, device=dev)
            keep = pos[:, None] >= pos[None, :]
            if W:
                keep &= pos[:, None] - pos[None, :] < W
            flops, nbytes = work.flash_forward(q, k, **kw)
            b_ms, b_by = bound(flops, nbytes, dname)
            if dname == "float32":
                b_ms3 = {"bound_3xtf32_ms": bound_3xtf32(flops, nbytes)}
            else:
                b_ms3 = {}
            record({
                "phase": "kernel", "kernel": "flash_attention",
                "shape": f"B{B} S{S} Hq{Hq} Hkv{Hkv} D{D} causal"
                         + (f" window{W}" if W else ""),
                "dtype": dname, **_held(out, want, dname),
                **_times(lambda: ops.flash_attention(q, k, v, **kw),
                         lambda: ref.flash_attention_ref(q, k, v, **kw),
                         lambda: F.scaled_dot_product_attention(
                             qt, kt, vt, is_causal=not W,
                             attn_mask=keep if W else None, enable_gqa=True)),
                "library": "scaled_dot_product_attention("
                           + ("attn_mask" if W else "is_causal")
                           + ", enable_gqa=True)",
                "bound_ms": b_ms, "bound_by": b_by, **b_ms3,
                "cluster": _fwd_cluster(B, S, S, Hq, Hkv, D, dname)},
                main_path=(S == 128 and Hq == 32 and dname == "float32"))
        # K2: paged decode, 16-token pages in shuffled order: 4 rows in a
        # table as wide as their pages (ctx160, ctx4096), then (their own
        # stream) 1 and 4 rows of 160 tokens in a 256-page table
        for B, ctx, npag in ((4, 160, 10), (4, 4096, 256), (1, 160, 256),
                             (4, 160, 256)):
            Hq, Hkv, D, ps = 32, 8, 128, 16
            wide = npag * ps > ctx
            P = B * npag + 1
            draw = (lambda shape: rand(shape, dtype, stream=2)) if wide \
                else (lambda shape: rand(shape, dtype))
            q = draw((B, 1, Hq, D))
            kp, vp = draw((P, ps, Hkv, D)), draw((P, ps, Hkv, D))
            perm = torch.randperm(P - 1, generator=gen_k2 if wide else gen,
                                  device=dev) + 1
            bt = perm.reshape(B, npag).to(torch.int32).contiguous()
            lens = torch.tensor([ctx, ctx - 1, ctx - 5, ctx - 15][:B],
                                dtype=torch.int32, device=dev)
            out = ops.paged_attention(q, kp, vp, bt, lens)
            want = ref.paged_decode_attention_ref(q.float(), kp.float(),
                                                  vp.float(), bt, lens)
            b_ms, b_by = bound(*work.paged_decode(q, kp, lens, ps), dname)
            record({
                "phase": "kernel", "kernel": "paged_attention",
                "shape": f"B{B} ctx{ctx} ps{ps} Hq{Hq} Hkv{Hkv} D{D}"
                         + (f" table{npag}" if wide else ""),
                "dtype": dname, **_held(out, want, dname),
                **_times(lambda: ops.paged_attention(q, kp, vp, bt, lens),
                         lambda: ref.paged_decode_attention_ref(
                             q, kp, vp, bt, lens),
                         None),
                "library": "none: no single PyTorch call",
                "bound_ms": b_ms, "bound_by": b_by},
                main_path=(B == 4 and ctx == 160 and not wide
                           and dname == "float32"))
        # K2 through the prefix cache's block tables (their own stream):
        # four rows share the physical pages of a 16-token system prompt
        # (page size 8: two pages, 16: one), then each has its own; and,
        # at page size 8, row 0's last prefix page a copy-on-write
        # duplicate of row 1's
        for ps, cow in ((8, False), (16, False), (8, True)):
            q, kp, vp, bt, lens = _shared_tables(
                lambda shape: rand(shape, dtype, stream=4), ps, cow, dev)
            out = ops.paged_attention(q, kp, vp, bt, lens)
            want = ref.paged_decode_attention_ref(q.float(), kp.float(),
                                                  vp.float(), bt, lens)
            b_ms, b_by = bound(*work.paged_decode(q, kp, lens, ps), dname)
            record({
                "phase": "kernel", "kernel": "paged_attention",
                "shape": f"B4 ctx{int(lens.max())} ps{ps} Hq32 Hkv8 D128 "
                         f"shared{SYSTEM_LEN // ps}" + (" cow" if cow else ""),
                "dtype": dname, **_held(out, want, dname),
                **_times(lambda: ops.paged_attention(q, kp, vp, bt, lens),
                         lambda: ref.paged_decode_attention_ref(
                             q, kp, vp, bt, lens),
                         None),
                "library": "none: no single PyTorch call",
                "bound_ms": b_ms, "bound_by": b_by}, main_path=False)
        # K2 at each of phase 9's engines' tables (their own stream)
        for B, ps, npag, P, lens, shared, retired in SERVING_K2:
            q, kp, vp, bt, lens_t = _serving_tables(
                lambda shape: rand(shape, dtype, stream=5), gen_serve,
                B, ps, npag, P, lens, shared, retired, dev)
            out = ops.paged_attention(q, kp, vp, bt, lens_t)
            want = ref.paged_decode_attention_ref(q.float(), kp.float(),
                                                  vp.float(), bt, lens_t)
            b_ms, b_by = bound(*work.paged_decode(q, kp, lens_t, ps), dname)
            record({
                "phase": "kernel", "kernel": "paged_attention",
                "shape": f"B{B} ctx{max(lens)} ps{ps} Hq32 Hkv8 D128 "
                         f"table{npag} pool{P} serving"
                         + (f" shared{shared}" if shared else "")
                         + (f" retired{len(retired)}" if retired else ""),
                "dtype": dname, **_held(out, want, dname),
                **_times(lambda: ops.paged_attention(q, kp, vp, bt, lens_t),
                         lambda: ref.paged_decode_attention_ref(
                             q, kp, vp, bt, lens_t),
                         None),
                "library": "none: no single PyTorch call",
                "bound_ms": b_ms, "bound_by": b_by}, main_path=False)
        # K3: RMSNorm at granite's width (128 rows = one prompt's prefill)
        # and at hymba-1.5b's (a 128-token and an 1100-token prefill); then,
        # from their own stream, a decode step's 4 rows at both widths and
        # a training microbatch's 4096 rows
        for rows, d in ((128, 4096), (512, 4096), (128, 1600), (1100, 1600),
                        (4, 4096), (4, 1600), (4096, 4096)):
            stream = 3 if rows in (4, 4096) else 1 if d == 1600 else 0
            x = rand((rows, d), dtype, stream=stream)
            scale = rand((d,), torch.float32, stream=stream)
            if dname == "bfloat16" and rows == 512:
                _check_ulp_gate(ops.rmsnorm(x, scale),
                                ref.rmsnorm_ref(x.float(), scale))
            record(_rmsnorm_line(x, scale, floor_ms), main_path=(
                rows == 128 and d == 4096 and dname == "float32"))
    _family_kernels(rand, record, gen_family)
    _train_kernels(rand, record)
    _wkv6_kernels(rand, record)
    _slice_kernels(rand, record, gen_slice, floor_ms)
    t0 = time.perf_counter()
    _config_kernels(rand, record, gen_config, floor_ms)
    emit({"phase": "2-configs", "seconds": time.perf_counter() - t0})
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{[(f['kernel'], f['shape'], f['dtype']) for f in failures]}")

    launches = _serve(dev)     # phases 3 to 5; frees the served model
    gc.collect()
    torch.cuda.empty_cache()
    for arch in SSM_ARCHS:                       # phases 3b, 3c
        launches.update(_serve_ssm(dev, arch))   # timed; frees its model
        gc.collect()
        torch.cuda.empty_cache()
        _serve_ssm_in_child(arch)                # tokens and logits

    tier1 = {}
    for phase in ("6", "6b", "6c", "6e"):     # training at full width
        t0 = time.perf_counter()
        launches[f"train:{phase}"], tier1[phase] = _train(dev, phase)
        emit({"phase": phase, "seconds": time.perf_counter() - t0})
        gc.collect()
        torch.cuda.empty_cache()
    for phase in ("6d-rwkv6", "6d-hymba"):   # reduced, card against CPU
        launches[f"train:{phase}"] = _train_on_cpu_too(dev, phase)
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ 10 families
    family_launches, tier1["10a"] = _families(dev)
    launches.update(family_launches)
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ 11 bf16
    bf16_launches, tier1["11a"] = _bf16_phases(dev)
    launches.update(bf16_launches)
    gc.collect()
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- 12 inter-chip
    launches.update(_inter_chip(dev, summary))
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ 13 dry run
    launches.update(_dry_run(dev))
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------------------------------- 8 bench
    ops.reset_launches()
    _bench(dev, tier1)
    launches["bench"] = dict(ops.LAUNCHES)
    gc.collect()
    torch.cuda.empty_cache()

    # ----------------------------------------------------------- 9 serving
    launches.update(_serve_suite(dev))
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------------- 14 tuning and the analysis
    _tuning_and_analysis(dev, recorder)

    # ----------------------------------------------------------- 7 kernels
    total = {k: sum(launches[e][k] for e in launches) for k in KERNELS}
    line = {"kernels": [
        {"name": name, **meta, "launches": total[name],
         "max_abs_err": summary[name]["max_abs_err"],
         "ms": summary[name]["kernel_ms"],
         "plain_ms": summary[name]["plain_ms"],
         "bound_ms": summary[name]["bound_ms"],
         "bound_by": summary[name]["bound_by"],
         "library_ms": summary[name]["library_ms"]}
        for name, meta in KERNELS.items()]}
    print(json.dumps(line), flush=True)
    missing = _missing(launches)
    if missing:
        raise AssertionError(f"a serving, training or bench path never "
                             f"launched a kernel it must, or launched one "
                             f"it must not: {missing}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _missing(launches: dict) -> list:
    """The kernels a path of the run never launched, from each path's
    counts (``launches``: path -> kernel -> launches): the serving phases'
    (3, 3b, 3c), the training phases' (6, 6b, 6e), phase 8's
    (BENCH_KERNELS), every scenario of phase 9's (SERVING_SCENARIOS),
    phase 10's paths (FAMILY_PATHS), phase 11's (BF16_PATHS), phase 12's
    (PHASE12_PATHS) and phase 13's (PHASE13_PATHS)."""
    need = {"flash_attention": launches["continuous"]["flash_attention"],
            "paged_attention": launches["paged"]["paged_attention"],
            **{k: min(launches[e][k] for e in ("train:6", "train:6b",
                                               "train:6e"))
               for k in ("flash_attention_lse", "flash_attention_dq",
                         "flash_attention_dkv")},
            "rmsnorm": min(launches[e]["rmsnorm"] for e in (
                "continuous", "paged", "train:6", "train:6b",
                "hymba-1.5b:static", "hymba-1.5b:continuous")),
            "wkv6": min(launches[f"{a}:{e}"]["wkv6"] for a in SSM_ARCHS
                        for e in ("static", "continuous"))}
    return [k for k, n in need.items() if n <= 0] + [
        f"{k} in phase 8" for k in BENCH_KERNELS
        if launches["bench"][k] <= 0] + [
        f"{k} in {scen}" for scen, kernels in SERVING_SCENARIOS.items()
        for k in kernels if launches[f"serving:{scen}"][k] <= 0] + [
        f"{k} in {path}" for path, kernels in {**FAMILY_PATHS,
                                               **BF16_PATHS,
                                               **PHASE12_PATHS,
                                               **PHASE13_PATHS}.items()
        for k in kernels if launches[path][k] <= 0]


def _serve(dev) -> dict:
    """Phases 3 and 4: serve full-width granite-3-8b through the
    continuous and the paged engine, check parity. Returns each engine's
    launch counts; the model, engines and caches go with its frame."""
    import torch

    from repro_torch.kernels import ops

    # ------------------------------------------------------------- 3 serve
    from repro_torch._tree import tree_leaves
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import build_engine
    from repro_torch.models import Runtime, build

    cfg = get_arch(ARCH)
    model = build(cfg, Runtime(attention_backend="kernel"), device=dev)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    leaves = tree_leaves(params)
    emit({"phase": "weights", "arch": ARCH, "layers": cfg.num_layers,
          "params": sum(t.numel() for t in leaves), "dtype": "float32",
          "bytes": sum(t.numel() * t.element_size() for t in leaves),
          "init_s": time.perf_counter() - t0})

    prompt_len, budget_max = 128, 32
    reqs = _request_mix(cfg)
    common = dict(batch=4, prompt_len=prompt_len, max_new_tokens=budget_max,
                  use_reduced=False, params=params, device=dev)
    engines = {
        "continuous": build_engine(ARCH, scheduler="continuous", **common)[0],
        "paged": build_engine(ARCH, scheduler="paged", page_size=16,
                              prefill_chunk_tokens=64, **common)[0],
    }
    reports, launches = {}, {}
    for name, eng in engines.items():
        eng.warmup(prompt_len)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        reports[name] = eng.run(reqs)
        launches[name] = dict(ops.LAUNCHES)
        s = reports[name].summary()
        emit({"phase": "serve", "scheduler": name,
              "requests": len(reqs), "lanes": eng.slots,
              **{k: s[k] for k in (
                  "completed", "total_new_tokens", "makespan_s",
                  "goodput_rps", "goodput_tps", "decode_steps", "prefills",
                  "ttft_p50_s", "ttft_p95_s", "tok_p50_s", "tok_p95_s",
                  "peak_concurrency")},
              "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
              "launches": launches[name]})
        if s["completed"] != len(reqs):
            raise AssertionError(f"{name}: {s['completed']}/{len(reqs)} "
                                 "requests completed")

    # ------------------------------------------------------------ 4 parity
    toks = {name: {m.rid: [int(t) for t in m.tokens] for m in rep.metrics}
            for name, rep in reports.items()}
    budget = {r.rid: r.max_new_tokens for r in reqs}
    for name, tk in toks.items():
        for rid, seq in tk.items():
            if len(seq) != budget[rid] or not all(
                    0 <= t < cfg.vocab_size for t in seq):
                raise AssertionError(f"{name} rid {rid}: bad tokens {seq}")
    mismatch = _first_mismatch(toks["continuous"], toks["paged"])
    dense = build(cfg, Runtime(attention_backend="dense"), device=dev)
    prompt = torch.as_tensor(reqs[0].prompt[None], device=dev)
    lk, _ = model.prefill(params, {"tokens": prompt}, prompt_len)
    ld, _ = dense.prefill(params, {"tokens": prompt}, prompt_len)
    logit_err = _err(lk, ld)
    parity = {"phase": "parity", "rids": len(toks["paged"]),
              "tokens_identical": mismatch is None,
              "prefill_logits_shape": list(lk.shape),
              "prefill_logits_finite": bool(torch.isfinite(lk).all()),
              "kernel_vs_dense_prefill_max_abs_err": logit_err,
              "tol": 1e-3}
    if mismatch is not None:
        rid, step = mismatch
        req = next(r for r in reqs if r.rid == rid)
        seq = list(req.prompt) + toks["continuous"][rid][:step]
        lg, _ = dense.prefill(params, {"tokens": torch.as_tensor(
            [seq], dtype=torch.int32, device=dev)}, len(seq))
        top2 = torch.topk(lg[0, -1], 2).values
        parity.update(first_mismatch_rid=rid, first_mismatch_step=step,
                      top2_margin=float(top2[0] - top2[1]))
    emit(parity)
    if mismatch is not None:
        raise AssertionError(f"greedy tokens differ between engines: {parity}")
    if not parity["prefill_logits_finite"] or logit_err > parity["tol"]:
        raise AssertionError(f"full-width prefill check failed: {parity}")
    return launches


def _request_mix(cfg, long_len: int = 0) -> list:
    """The serving phases' burst: 8 prompts of 128 tokens with decode
    budgets cycling (2, 32), 4 of 125 tokens with budget 5 and, with
    ``long_len``, 2 of ``long_len`` tokens with budgets (8, 16). Sorted
    by rid, each group fills whole lockstep batches of 4 (the static
    engine needs one prompt length per batch) or ends the run."""
    from repro_torch.data.pipeline import synth_requests
    reqs = synth_requests(cfg, 8, 128, max_new_tokens=(2, 32))
    groups = [(4, 125, 5)] + ([(2, long_len, (8, 16))] if long_len else [])
    for g, (n, plen, budget) in enumerate(groups, start=1):
        more = synth_requests(cfg, n, plen, max_new_tokens=budget, seed=g)
        for r in more:
            r.rid += 100 * g
        reqs += more
    return reqs


def _families(dev) -> tuple:
    """Phases 10a-10f: whisper-large-v3 served and trained, qwen2-vl-72b
    and arctic-480b served, both reduced trained on the card and the CPU
    (10d), stablelm-12b (10e) and qwen1.5-110b (10f) served. Each phase
    frees its model before the next. Returns (launch counts per path,
    10a's Tier-1 report)."""
    import torch
    launches = _serve_whisper(dev)
    gc.collect()
    torch.cuda.empty_cache()
    launches["train:10a"], tier1 = _train(dev, "10a")
    gc.collect()
    torch.cuda.empty_cache()
    for arch in FAMILY_LAYERS:                      # 10b, 10c, 10e, 10f
        t0 = time.perf_counter()
        launches.update(_serve_family(dev, arch))
        emit({"phase": FAMILY_PHASE[arch],
              "seconds": time.perf_counter() - t0})
        gc.collect()
        torch.cuda.empty_cache()
    for phase in ("10d-arctic", "10d-qwen2-vl"):
        launches[f"train:{phase}"] = _train_on_cpu_too(dev, phase)
    return launches, tier1


def _weights_line(arch: str, cfg, params, t0: float, dtype="float32",
                  **more) -> None:
    from repro_torch._tree import tree_leaves
    leaves = tree_leaves(params)
    emit({"phase": "weights", "arch": arch, "layers": cfg.num_layers,
          "encoder_layers": cfg.encoder_layers,
          "params": sum(t.numel() for t in leaves), "dtype": dtype,
          "bytes": sum(t.numel() * t.element_size() for t in leaves),
          "init_s": time.perf_counter() - t0, **more})


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def _peak(dev) -> int:
    import torch
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def _serve_whisper(dev, use_reduced: bool = False) -> dict:
    """Phase 10a's serving: whisper-large-v3 at full width and depth
    (``use_reduced``: the reference's reduced config, for tests on the
    CPU), WHISPER's requests of audio frames and decoder prompts through
    ``serve_loop.generate`` on the kernels and on the plain path from the
    same seeded params: greedy tokens identical per request, the prefill
    logits within LOGIT_TOL, K1 once per attention of the one prefill
    (the encoder's and the cross attention's non-causal), nothing else
    launched. Returns the kernel run's counts as ``whisper:serve``."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch, reduced
    from repro_torch.data.pipeline import synth_requests
    from repro_torch.kernels import ops
    from repro_torch.models import Runtime, build
    from repro_torch.models.frontends import synth_batch
    from repro_torch.runtime.serve_loop import generate

    arch, w = "whisper-large-v3", WHISPER
    cfg = get_arch(arch)
    if use_reduced:
        cfg = reduced(cfg)
    models = {b: build(cfg, Runtime(attention_backend=b), device=dev)
              for b in ("kernel", "dense")}
    t0 = time.perf_counter()
    params = models["kernel"].init_params(
        torch.Generator(device=dev).manual_seed(0))
    _sync(dev)
    _weights_line(arch, cfg, params, t0)
    frames = synth_batch(cfg, w["requests"], w["frames"], seed=0,
                         kind="prefill", device=dev)["audio_embeds"]
    prompts = np.stack([r.prompt for r in synth_requests(
        cfg, w["requests"], w["prompt"])])
    batch = {"audio_embeds": frames,
             "tokens": torch.as_tensor(prompts, device=dev)}
    span = w["prompt"] + w["new_tokens"]
    toks, counts = {}, {}
    for backend, m in models.items():
        generate(m.prefill, m.decode_step, params, batch,
                 prompt_len=w["prompt"], max_new_tokens=2)      # warm-up
        _sync(dev)
        ops.reset_launches()
        res = generate(m.prefill, m.decode_step, params, batch,
                       prompt_len=w["prompt"], max_new_tokens=w["new_tokens"])
        counts[backend] = dict(ops.LAUNCHES)
        toks[backend] = res.tokens
        emit({"phase": "serve", "arch": arch, "backend": backend,
              "via": "serve_loop.generate", "requests": w["requests"],
              "audio_frames": w["frames"], "prompt_len": w["prompt"],
              "new_tokens": w["new_tokens"], "prefill_s": res.prefill_s,
              "decode_s": res.decode_s, "tokens_per_s": res.tokens_per_s,
              "peak_memory_bytes": _peak(dev), "launches": counts[backend]})
    mismatch = _first_mismatch(
        {i: list(t) for i, t in enumerate(toks["kernel"])},
        {i: list(t) for i, t in enumerate(toks["dense"])})
    lk, _ = models["kernel"].prefill(params, batch, span)
    lp, _ = models["dense"].prefill(params, batch, span)
    err = _err(lk, lp)
    want = {k: 0 for k in ops.KERNELS}
    want["flash_attention"] = _attention_calls(cfg)
    parity = {"phase": "parity", "arch": arch,
              "requests": w["requests"],
              "tokens_identical": mismatch is None,
              "prefill_logits_shape": list(lk.shape),
              "prefill_logits_finite": bool(torch.isfinite(lk).all()),
              "kernel_vs_plain_prefill_max_abs_err": err, "tol": LOGIT_TOL,
              "launches_expected": want}
    if mismatch is not None:
        row, step = mismatch
        one = {"audio_embeds": frames[row:row + 1], "tokens": torch.as_tensor(
            [list(prompts[row]) + list(toks["dense"][row][:step])],
            device=dev)}
        lg, _ = models["dense"].prefill(params, one, span)
        top2 = torch.topk(lg[0, -1], 2).values
        parity.update(first_mismatch_request=row, first_mismatch_step=step,
                      top2_margin=float(top2[0] - top2[1]))
    emit(parity)
    on_card = dev.type == "cuda"
    if (mismatch is not None or not parity["prefill_logits_finite"]
            or err > LOGIT_TOL or (on_card and counts["kernel"] != want)
            or any(counts["dense"].values())):
        raise AssertionError(f"phase 10a serving failed: {parity}, "
                             f"launches {counts}")
    return {"whisper:serve": counts["kernel"]}


class _expert_load:
    """Within it, the MoE FFN (``models/moe.py::moe_ffn``) records each
    call: its ``expert_load`` summed into ``total``, and in ``calls`` its
    tokens' routes (``_token_routes``: router margin, routed experts and
    which (token, k) pairs the capacity kept). ``smallest`` is the
    smallest router margin over the calls (None before one)."""

    def __enter__(self):
        from repro_torch.models import moe as moe_mod
        self.mod, self.orig = moe_mod, moe_mod.moe_ffn
        self.total, self.calls = None, []

        def counted(p, x, cfg, rt=None):
            y, aux = self.orig(p, x, cfg, rt)
            load = aux["expert_load"]
            self.total = load if self.total is None else self.total + load
            self.calls.append(_token_routes(x.detach(), p["router"],
                                            cfg.moe.top_k, aux["capacity"]))
            return y, aux

        moe_mod.moe_ffn = counted
        return self

    def __exit__(self, *exc) -> None:
        self.mod.moe_ffn = self.orig

    @property
    def smallest(self):
        if not self.calls:
            return None
        return min(float(c["margin"].min()) for c in self.calls)

    def last_token(self) -> dict:
        """The last call's last token: its routed experts and margin."""
        c = self.calls[-1]
        return {"experts": c["experts"][-1].tolist(),
                "margin": float(c["margin"][-1])}


def _token_routes(x, router, k: int, capacity: int) -> dict:
    """Per token of ``x`` (..., d), as ``moe_ffn`` routes it: ``margin``
    (T,), the router probability of its k-th (last routed) expert less
    the (k+1)-th's; ``experts`` (T, k), its routed experts; ``keep`` (T,
    k), whether each (token, k) pair fits its expert's ``capacity`` (its
    place in the expert's queue in token order, as the stable sort by
    expert orders it)."""
    import torch
    import torch.nn.functional as F
    probs = torch.softmax(x.reshape(-1, x.shape[-1]).float() @ router, dim=-1)
    top = torch.topk(probs, k + 1, dim=-1)
    experts = top.indices[:, :k]
    flat = experts.reshape(-1)
    place = (F.one_hot(flat, router.shape[1]).cumsum(0) - 1).gather(
        1, flat[:, None])[:, 0]
    return {"margin": top.values[:, k - 1] - top.values[:, k],
            "experts": experts, "keep": (place < capacity).reshape(-1, k)}


def _rerouted(a: list, b: list, last_pointwise: bool):
    """The positions (S,) of a one-prompt forward whose output two paths'
    routes (``_expert_load().calls``, one per MoE layer) let differ: a
    token routed to other experts or kept otherwise changes its own
    position in that layer and, through the next layers' causal attention,
    every later one; in the last layer (``last_pointwise``: every layer is
    an MoE layer) only its own."""
    import torch
    out = None
    for i, (ca, cb) in enumerate(zip(a, b)):
        d = ((ca["experts"] != cb["experts"]) | (ca["keep"] != cb["keep"]))
        d = d.any(-1)
        if not (last_pointwise and i == len(a) - 1):
            d = torch.cummax(d.int(), 0).values.bool()
        out = d if out is None else out | d
    return out


def _all_logits(params, cfg, x):
    """The head's f32 logits at every position of the stack's output ``x``
    (B, S, d), as the model's head computes them at the last."""
    from repro_torch.models.layers import apply_norm, lm_logits
    x = apply_norm(params["final_norm"], x.contiguous(), cfg.norm)
    return lm_logits(params["embed"], x, cfg.tie_embeddings,
                     true_vocab=cfg.vocab_size).float()[..., :cfg.vocab_size]


class _stack_output:
    """Within it, ``transformer.stack_prefill`` keeps its output hidden
    states (B, S, d) in ``x``: a prefill's every position, where the model
    returns the last one's logits."""

    def __enter__(self):
        from repro_torch.models import transformer as tfm
        self.mod, self.orig, self.x = tfm, tfm.stack_prefill, None

        def kept(*args, **kw):
            x, caches = self.orig(*args, **kw)
            self.x = x
            return x, caches

        tfm.stack_prefill = kept
        return self

    def __exit__(self, *exc) -> None:
        self.mod.stack_prefill = self.orig


def _prefill_logits(dev, arch: str, cfg, models, params, reqs,
                    span: int) -> tuple:
    """Phase 11c's and 11e's gate 1: each prompt's prefill, logits at every
    position (``_all_logits``), through the kernels, the plain path, the
    plain path with its attention in f32 ("exact", ``_f32_attention``) and
    the kernels with each of PLANTED_FAULTS (``_planted_fault``); held
    where the kernels and the plain path routed the tokens alike
    (``_rerouted``), at least LOGIT_HELD_SHARE of all positions, every
    logit finite; distances from exact over the held positions that exact
    routed as the plain path (a fault's, over those its run routed so
    too). The gate (``held_by``), chosen by what the
    run measures: where every prompt's plain path lies within LOGIT_UNITS
    units (of bf16 rounding at the plain logits' largest magnitude there)
    of exact, the kernels' largest difference from the plain path within
    LOGIT_UNITS units; else the kernels no farther from exact than
    EXACT_RATIO times the plain path, and each of REJECTED_FAULTS failing
    that gate on some prompt (whether each fault fails the gate chosen is
    reported either way). The smallest router margin reported.
    Returns (the largest held difference between the kernels and the
    plain path: the flip rule's bound, problems)."""
    import torch
    per, problems, margins = [], [], []
    every_layer = None
    runs = [("kernel", models["kernel"], False, None),
            ("dense", models["dense"], False, None),
            ("exact", models["dense"], True, None)] + [
        (f"{kind}:{k}", models["kernel"], False, (kind, k))
        for kind, k in PLANTED_FAULTS]
    faulty = [name for name, _, _, fault in runs if fault is not None]
    for r in reqs:
        batch = {"tokens": torch.as_tensor(r.prompt[None], device=dev)}
        got = {}
        for name, m, f32, fault in runs:
            with _expert_load() as seen, _stack_output() as out, \
                    _f32_attention(f32), _planted_fault(fault, dev):
                m.prefill(params, batch, span)
            got[name] = (_all_logits(params, cfg, out.x)[0], seen.calls)
            if seen.calls and fault is None:
                margins.append(seen.smallest)
        (lk, ck), (lp, cp), (le, ce) = (got[n] for n in ("kernel", "dense",
                                                         "exact"))
        every_layer = len(ck) == cfg.num_layers
        held = ~_rerouted(ck, cp, every_layer) if ck else torch.ones(
            lk.shape[0], dtype=torch.bool, device=lk.device)
        near = held & ~_rerouted(ce, cp, every_layer) if ce else held

        def off(a, b, at):
            return float((a[at] - b[at]).abs().max()) if at.any() else 0.0

        def alike(f):
            # the positions a planted fault's run routed as the plain path
            return ~_rerouted(got[f][1], cp, every_layer) if cp else held

        unit = _bf16_unit(lp[held]) if held.any() else float("nan")
        diff, plain = off(lk, lp, held), off(lp, le, near)
        per.append({"rid": r.rid, "positions": int(held.numel()),
                    "held": int(held.sum()), "max_abs_diff": diff,
                    "units": diff / unit,
                    "finite": bool(torch.isfinite(lk).all()),
                    "exact_positions": int(near.sum()),
                    "kernel_vs_exact": off(lk, le, near),
                    "plain_vs_exact": plain,
                    "plain_units_from_exact": plain / unit,
                    "faults_vs_exact": {
                        f: off(got[f][0], le, near & alike(f))
                        for f in faulty},
                    "faults_units": {
                        f: off(got[f][0], lp, held & alike(f)) / unit
                        for f in faulty}})
        del got, lk, lp, le
    n, held_n = sum(p["positions"] for p in per), sum(p["held"] for p in per)
    bound = max(p["max_abs_diff"] for p in per)
    worst = max(per, key=lambda p: p["units"])
    ratio = max(p["plain_units_from_exact"] for p in per) > LOGIT_UNITS

    def within(p, fault=None):
        # the gate of ``held_by``, for the kernels or a planted fault
        if not ratio:
            return (p["faults_units"][fault] if fault else p["units"]) \
                <= LOGIT_UNITS
        return (p["faults_vs_exact"][fault] if fault
                else p["kernel_vs_exact"]) <= EXACT_RATIO * p[
                    "plain_vs_exact"]

    faults = {f"{kind}:{k}": {
        "max_over_plain_vs_exact": max(
            p["faults_vs_exact"][f"{kind}:{k}"] / max(p["plain_vs_exact"],
                                                      1e-30) for p in per),
        "max_units": max(p["faults_units"][f"{kind}:{k}"] for p in per),
        "rejected": not all(within(p, f"{kind}:{k}") for p in per),
        "must_be_rejected": ratio and (kind, k) in REJECTED_FAULTS}
        for kind, k in PLANTED_FAULTS}
    line = {"phase": "prefill_logits", "arch": arch, "dtype": "bfloat16",
            "prompts": len(reqs), "positions": n, "held": held_n,
            "held_share": held_n / n, "held_share_min": LOGIT_HELD_SHARE,
            "last_layer_pointwise": every_layer,
            "max_units": worst["units"], "units_tol": LOGIT_UNITS,
            "unit": "bf16 rounding at the plain logits' largest magnitude "
            "over a prompt's held positions", "worst": worst,
            "max_plain_units_from_exact": max(
                p["plain_units_from_exact"] for p in per),
            "held_by": "exact_ratio" if ratio else "units",
            "exact_ratio": EXACT_RATIO,
            "max_kernel_over_plain_vs_exact": max(
                p["kernel_vs_exact"] / max(p["plain_vs_exact"], 1e-30)
                for p in per),
            "planted_faults": faults,
            "flip_bound": bound,
            "smallest_router_margin": min(margins, default=None),
            "per_prompt": per}
    emit(line)
    if held_n < LOGIT_HELD_SHARE * n:
        problems.append(f"prefill: {held_n} of {n} positions routed alike")
    problems += [f"prefill rid {p['rid']}: {p}" for p in per
                 if not p["finite"] or not within(p)]
    problems += [f"the {line['held_by']} gate does not see the planted "
                 f"fault {f}: {v}" for f, v in faults.items()
                 if v["must_be_rejected"] and not v["rejected"]]
    return bound, problems


class _planted_fault:
    """Within it (unless ``fault`` is None), the kernels' attention
    (``models/attention.py``'s ``attention`` with backend "kernel") gives
    a wrong output, as the controls of ``_prefill_logits`` plant it:
    ("ulps", k) moves each nonzero element of K1's output k units of its
    own bf16 rounding, up or down by a sign drawn anew each call from one
    seeded generator; ("p_bf16", 0) computes it in f32 from the same q, k
    and v with the softmax weights rounded once to bf16 before their
    product with v (``_p_bf16_attention``), as a kernel that kept P in one
    bf16 term would."""

    def __init__(self, fault, dev) -> None:
        self.fault, self.dev = fault, dev

    def __enter__(self):
        if self.fault is None:
            return self
        import torch

        from repro_torch.models import attention as attn_mod
        self.mod, self.orig = attn_mod, attn_mod.attention
        kind, k = self.fault
        gen = torch.Generator(device=self.dev).manual_seed(9)

        def faulty(q, kk, v, *, backend, causal, window=0):
            if backend != "kernel":
                return self.orig(q, kk, v, backend=backend, causal=causal,
                                 window=window)
            if kind == "p_bf16":
                return _p_bf16_attention(q, kk, v, causal=causal,
                                         window=window)
            o = self.orig(q, kk, v, backend=backend, causal=causal,
                          window=window)
            _, e = torch.frexp(o.float())
            step = torch.ldexp(torch.ones_like(o, dtype=torch.float32),
                               e - 8)
            sign = torch.randint(0, 2, o.shape, generator=gen,
                                 device=o.device) * 2 - 1
            return torch.where(o == 0, o, (o.float() + k * sign * step)
                               .to(o.dtype))

        attn_mod.attention = faulty
        return self

    def __exit__(self, *exc) -> None:
        if self.fault is not None:
            self.mod.attention = self.orig


def _p_bf16_attention(q, k, v, *, causal: bool, window: int = 0):
    """Attention (q (B, Sq, Hq, D), k and v (B, Sk, Hkv, D)) in f32 with
    its softmax weights rounded once to q's dtype before their product
    with v, and its output rounded once to q's dtype."""
    import torch
    from repro_torch.kernels.ref import NEG_INF
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Sq, Hkv, Hq // Hkv, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / math.sqrt(D)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= qpos - kpos < window
    w = torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w.to(q.dtype).float(), v.float())
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


class _f32_attention:
    """Within it (when ``on``), every plain attention call of the models
    (``models/attention.py``'s ``dense_attention``) computes in f32 from
    its q, k and v and rounds its output once to their dtype: the plain
    path's attention without its bf16 roundings of the scores and the
    softmax weights, as phase 2's bf16 lines compute their reference."""

    def __init__(self, on: bool) -> None:
        self.on = on

    def __enter__(self):
        if self.on:
            from repro_torch.models import attention as attn_mod
            self.mod, self.orig = attn_mod, attn_mod.dense_attention

            def f32(q, k, v, **kw):
                return self.orig(q.float(), k.float(), v.float(),
                                 **kw).to(q.dtype)

            attn_mod.dense_attention = f32
        return self

    def __exit__(self, *exc) -> None:
        if self.on:
            self.mod.dense_attention = self.orig


def _serve_family(dev, arch: str, use_reduced: bool = False,
                  param_dtype: str = "float32") -> dict:
    """Phases 10b (qwen2-vl-72b), 10c (arctic-480b), 10e (stablelm-12b),
    10f (qwen1.5-110b), 11c (llama4-maverick in bf16) and 11e
    (stablelm-12b in bf16): the arch at full width, cut to
    SERVED_LAYERS[arch] layers where that is not 0 (``use_reduced``: the
    reference's reduced config, for tests on the CPU), seeded random
    weights in ``param_dtype`` (the init's peak memory reported), phase
    3's request mix through the continuous and the paged engine (prefill
    chunks of PAGED_CHUNK[arch] tokens) on the kernels and the continuous
    engine on the plain path: every request completed, K1 launched by the
    continuous engine and K2 by the paged one, and K3 by both where the
    model's norm is RMSNorm, by no run where it is LayerNorm; the paged
    engine's greedy tokens against the continuous one's and the plain
    path's against the kernels', per rid under ``_flip_check``. In f32 its bound
    is -inf: tokens identical. In bf16 (11c), where a 202,048-row head
    gives near-ties, it is the largest prefill logit difference of
    ``_prefill_logits``, which holds the logits too. A flip is reported
    with both paths' top-2 logit margins and router margins. qwen2-vl:
    one prefill of vision-stub embeddings on a MROPE_GRID position grid
    against the plain path (LOGIT_TOL). An MoE: the experts' load over
    the kernel runs and its LI, and the smallest router margin of each
    run. Returns each engine's counts, keyed ``<arch>:<name>``."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.metrics import expert_load_imbalance
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_engine
    from repro_torch.models import Runtime, build

    prompt_len, budget = 128, 32
    common = dict(batch=4, prompt_len=prompt_len, max_new_tokens=budget,
                  use_reduced=use_reduced, device=dev,
                  param_dtype=param_dtype,
                  num_layers=0 if use_reduced else SERVED_LAYERS[arch])
    _sync(dev)
    t0 = time.perf_counter()
    eng, cfg = build_engine(arch, scheduler="continuous", **common)
    params = eng.params
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    full = get_arch(arch).num_layers
    _weights_line(arch, cfg, params, t0, dtype=param_dtype,
                  init_peak_memory_bytes=_peak(dev),
                  reduced=("the reference's reduced config" if use_reduced
                           else f"depth {cfg.num_layers} of {full} layers: "
                           f"{SERVED_CUT[arch]}" if cfg.num_layers < full
                           else "none: full width and full depth"))
    common["params"] = params
    engines = {
        "continuous": eng,
        # an MoE's capacity makes a token's output depend on the tokens
        # routed beside it: an MoE's paged engine prefills each prompt in
        # one chunk, so every engine gives the experts the same batches
        "paged": build_engine(arch, scheduler="paged", page_size=16,
                              prefill_chunk_tokens=PAGED_CHUNK[arch],
                              **common)[0],
        "plain": build_engine(arch, scheduler="continuous",
                              attention_backend="dense", **common)[0]}
    models = {b: build(cfg, Runtime(attention_backend=b),
                       param_dtype=getattr(torch, param_dtype), device=dev)
              for b in ("kernel", "dense")}
    reqs = _request_mix(cfg)
    toks, launches, load, smallest = {}, {}, None, {}
    for name, e in engines.items():
        e.warmup(prompt_len)
        _sync(dev)
        ops.reset_launches()
        with _expert_load() as seen:
            rep = e.run(reqs)
        if cfg.moe is not None and name != "plain":
            load = seen.total if load is None else load + seen.total
        smallest[name] = seen.smallest
        launches[f"{arch}:{name}"] = n = dict(ops.LAUNCHES)
        toks[name] = _tokens_of(rep)
        s = rep.summary()
        emit({"phase": "serve", "arch": arch, "scheduler": name,
              "backend": "dense" if name == "plain" else "kernel",
              "param_dtype": param_dtype, "layers": cfg.num_layers,
              "requests": len(reqs), "lanes": e.slots,
              **{k: s[k] for k in (
                  "completed", "total_new_tokens", "makespan_s",
                  "goodput_tps", "decode_steps", "prefills", "ttft_p50_s",
                  "ttft_p95_s", "tok_p50_s", "tok_p95_s",
                  "peak_concurrency")},
              "peak_memory_bytes": _peak(dev), "launches": n})
        if s["completed"] != len(reqs):
            raise AssertionError(f"{arch} {name}: {s['completed']}/"
                                 f"{len(reqs)} requests completed")
    problems = _engine_launch_problems(arch, cfg, launches,
                                       dev.type == "cuda")
    if param_dtype == "bfloat16":
        bound, bad = _prefill_logits(dev, arch, cfg, models, params, reqs,
                                     prompt_len + budget)
        problems += bad
    else:
        bound = -math.inf

    def margin_at(rid, step):
        # both paths' top-2 logit margins (and routers') after the
        # continuous engine's first ``step`` tokens; the plain path's rules
        req = next(r for r in reqs if r.rid == rid)
        prefix = {"tokens": torch.as_tensor(
            [list(req.prompt) + toks["continuous"][rid][:step]],
            dtype=torch.int32, device=dev)}
        paths = {}
        for name, m in models.items():
            with _expert_load() as seen:
                lg, _ = m.prefill(params, prefix, prefix["tokens"].shape[1])
            top2 = torch.topk(lg[0, -1], 2).values
            paths[name] = {"top2_logit_margin": float(top2[0] - top2[1])}
            if seen.calls:
                paths[name]["router"] = seen.last_token()
        return {"margin": paths["dense"]["top2_logit_margin"],
                "paths": paths}

    line = {"phase": "engines_agree", "arch": arch, "engines": list(engines),
            "rule": "identical" if bound == -math.inf else
            "identical up to the first differing step; there the plain "
            "path's top-2 logit margin at most the largest prefill logit "
            "difference"}
    for other in ("paged", "plain"):
        flips, bad = _flip_check(toks["continuous"], toks[other], margin_at,
                                 bound)
        line[f"continuous_vs_{other}"] = {
            "identical": not flips and not bad, "flips": flips}
        problems += [f"continuous vs {other}: {b}" for b in bad]
    if load is not None:
        total = load.cpu().numpy()
        line.update(expert_load=total.tolist(),
                    expert_load_LI=float(expert_load_imbalance(total)),
                    smallest_router_margin=smallest)
    emit(line)
    if arch == "qwen2-vl-72b":
        problems += _vision_prefill(dev, models, params, prompt_len + budget)
    if problems:
        raise AssertionError(f"{arch} serving failed: {problems}")
    return launches


def _vision_prefill(dev, models, params, span: int) -> list:
    """One prefill of vision-stub embeddings (seeded, N(0, 0.02^2), bf16
    as the stub makes them) at M-RoPE positions of a MROPE_GRID (t, h, w)
    patch grid, through the kernels and the plain path: logits within
    LOGIT_TOL. Returns its problems."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models.frontends import synth_batch

    cfg = models["kernel"].cfg
    t, h, w = MROPE_GRID
    grid = np.stack([g.ravel() for g in np.meshgrid(
        np.arange(t), np.arange(h), np.arange(w), indexing="ij")])
    embeds = synth_batch(cfg, 1, grid.shape[1], seed=1, kind="prefill",
                         device=dev)["embeds"]
    batch = {"embeds": embeds,
             "positions": torch.as_tensor(grid[None], dtype=torch.int32,
                                          device=dev)}
    ops.reset_launches()
    lk, _ = models["kernel"].prefill(params, batch, span)
    n = dict(ops.LAUNCHES)
    lp, _ = models["dense"].prefill(params, batch, span)
    err = _err(lk, lp)
    line = {"phase": "vision_prefill", "arch": cfg.name,
            "grid_thw": list(MROPE_GRID), "patches": grid.shape[1],
            "streams_differ": bool((grid[0] != grid[1]).any()
                                   and (grid[1] != grid[2]).any()),
            "logits_finite": bool(torch.isfinite(lk).all()),
            "kernel_vs_plain_max_abs_err": err, "tol": LOGIT_TOL,
            "launches": n}
    emit(line)
    want_k1 = cfg.num_layers if dev.type == "cuda" else 0
    if (not line["logits_finite"] or err > LOGIT_TOL
            or n["flash_attention"] != want_k1):
        return [f"vision prefill: {line}"]
    return []


def _slice_kernels(rand, record, gen, floor_ms: float) -> None:
    """Phase 2's lines at phase 11's new shapes, from their own stream (7;
    ``gen`` draws K2's block tables), each against its plain version as
    the other lines are: K1 at llama4's one-prompt prefills (LLAMA4_K1),
    K2 at its heads on phase 3's paged table (LLAMA4_K2) and K3 at its
    d_model 5120 (SLICE_K3); B2-B4 at 11b's microbatches (DEPLOY_ATTN);
    K3, B2-B4 in each dtype its paths run them in."""
    import torch

    _family_kernels(rand, record, gen, k1=LLAMA4_K1, k2=LLAMA4_K2,
                    dtypes=("bfloat16",), stream=7)
    for dname, shapes in SLICE_K3.items():
        for rows, d in shapes:
            record(_rmsnorm_line(
                rand((rows, d), getattr(torch, dname), stream=7),
                rand((d,), torch.float32, stream=7), floor_ms),
                main_path=False)
    for dname, shapes in DEPLOY_ATTN.items():
        _train_kernels(rand, record, shapes=shapes, stream=7,
                       dtypes=(dname,))


def _config_kernels(rand, record, gen, floor_ms: float) -> None:
    """Phase 2's lines at stablelm-12b's and qwen1.5-110b's shapes, from
    their own stream (8; ``gen`` draws K2's block tables), each against
    its plain version as the other lines are: K1 at stablelm's one-prompt
    prefills (STABLELM_K1, Hq32 Hkv8 D160: the mma.sync forward in both
    dtypes; each line names the backend SDPA picks at D160) and K2 at its
    heads on phase 3's paged table (STABLELM_K2), in f32 and bf16; B2-B4 at its training microbatch (STABLELM_ATTN, f32);
    K3 at qwen1.5's d_model 8192 (QWEN15_K3, f32)."""
    import torch

    _family_kernels(rand, record, gen, k1=STABLELM_K1, k2=STABLELM_K2,
                    stream=8)
    _train_kernels(rand, record, shapes=STABLELM_ATTN, stream=8,
                   dtypes=("float32",))
    for rows, d in QWEN15_K3:
        record(_rmsnorm_line(rand((rows, d), torch.float32, stream=8),
                             rand((d,), torch.float32, stream=8), floor_ms),
               main_path=False)


def _rmsnorm_line(x, scale, floor_ms: float) -> dict:
    """Phase 2's K3 line: ``ops.rmsnorm`` of rows ``x`` (its dtype) with
    an f32 ``scale`` against its plain version, times, the bound (and the
    floor under it), library ``F.rms_norm``."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref, work

    rows, d = x.shape
    dname = str(x.dtype).split(".")[1]
    scale_lib = scale.to(x.dtype)
    out = ops.rmsnorm(x, scale)
    want = ref.rmsnorm_ref(x.float(), scale)
    b_ms, b_by = bound(*work.rmsnorm(rows, d, x.element_size()), dname)
    return {
        "phase": "kernel", "kernel": "rmsnorm", "shape": f"rows{rows} d{d}",
        "dtype": dname, **_held(out, want, dname),
        **_times(lambda: ops.rmsnorm(x, scale),
                 lambda: ref.rmsnorm_ref(x, scale),
                 lambda: F.rms_norm(x, (d,), weight=scale_lib, eps=1e-5)),
        "library": "rms_norm", "bound_ms": b_ms, "bound_by": b_by,
        "floor_ms": floor_ms, "floor_or_bound_ms": max(floor_ms, b_ms)}


def _bf16_phases(dev) -> tuple:
    """Phases 11a-11e: granite-3-8b's bf16 training held to its plain path
    (``TRAIN["11a"]``), the batch/precision suite at qwen2.5-32b's width
    (``_deploy``), llama4-maverick (11c) and stablelm-12b (11e, its paths
    keyed ``<arch>:<engine>:bf16``) served in bf16 (``_serve_family``) and
    checkpoint/resume (11d, ``_ckpt_resume``). Returns (launch counts per
    path, 11a's Tier-1 report)."""
    import torch
    launches = {}
    t0 = time.perf_counter()
    launches["train:11a"], tier1 = _train(dev, "11a")
    emit({"phase": "11a", "seconds": time.perf_counter() - t0})
    def llama4(dev):
        return _serve_family(dev, LLAMA4, param_dtype="bfloat16")

    for name, fn in (("11b", _deploy), ("11c", llama4),
                     ("11e", _serve_stablelm_bf16), ("11d", _ckpt_resume)):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        launches.update(fn(dev))
        emit({"phase": name, "seconds": time.perf_counter() - t0})
    return launches, tier1


def _serve_stablelm_bf16(dev, use_reduced: bool = False) -> dict:
    """Phase 11e: stablelm-12b served in bf16 by ``_serve_family``, its
    paths' counts keyed ``<arch>:<engine>:bf16`` beside 10e's f32 ones."""
    return {f"{k}:bf16": n for k, n in _serve_family(
        dev, STABLELM, use_reduced=use_reduced,
        param_dtype="bfloat16").items()}


# ============================================================ 12 inter-chip
def _inter_chip(dev, summary=None, use_reduced: bool = False) -> dict:
    """Phase 12, the paper's inter-chip half on one card: 12a the kernel
    micro-benchmarks through the harness (the card only); 12b-12d over a
    process group of one rank (NCCL on the card, gloo on the CPU where
    the tests run it) and a (1, 1) data x model mesh; 12e the scalability
    suite's one-rank points (the card only). ``use_reduced``: the
    reference's reduced configs and small shapes. Returns the launch
    counts of 12b's steps and 12c."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.configs import MeshConfig
    from repro_torch.launch.mesh import init_world, make_mesh

    on_card = dev.type == "cuda"
    launches = {}
    if on_card:
        t0 = time.perf_counter()
        _kernel_suite(summary or {})
        emit({"phase": "12a", "seconds": time.perf_counter() - t0})
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix=".dist-",
                                     dir=ROOT / "build") as store:
        init_world(dev.type, store_dir=store, rank=0, world_size=1)
        try:
            backend = dist.get_backend()
            mesh = make_mesh(MeshConfig(shape=(1, 1),
                                        axes=("data", "model")), dev.type)
            for name, fn in (("12b", _sharded_steps), ("12c", _decode_shards),
                             ("12d", _moe_ep)):
                gc.collect()
                if on_card:
                    torch.cuda.empty_cache()
                t0 = time.perf_counter()
                launches.update(fn(dev, mesh, use_reduced))
                emit({"phase": name, "seconds": time.perf_counter() - t0,
                      "backend": backend})
        finally:
            dist.destroy_process_group()
    if on_card:
        t0 = time.perf_counter()
        _scalability_suite()
        emit({"phase": "12e", "seconds": time.perf_counter() - t0})
    return launches


def _kernel_suite(summary: dict) -> None:
    """12a: ``python -m repro_torch.bench --only kernels`` through the
    harness's API on the card. Every ``kernel`` record launched its kernel
    and is within phase 2's gate of ``plain`` at its shape (K1 and K3 by
    the absolute error, B6 relative to the plain result's magnitude);
    each line prints phase 2's time beside the suite's at the path shape
    (phase 2: device time of a CUDA graph of calls; the suite: wall-clock
    per call, the card synchronised)."""
    from repro_torch.bench import BenchRunner, ListSink, select
    from repro_torch.bench.__main__ import with_device
    from repro_torch.bench.suites.kernels import KERNEL_OF

    sink = ListSink()
    out = BenchRunner(sinks=[sink]).run(
        [with_device(sc, "cuda") for sc in select(only="kernels")])
    problems = [f"{n}: {e}" for n, e in out.failures]
    for rec in sink.records:
        d = rec.derived
        kernel = KERNEL_OF[rec.scenario]
        line = {"phase": "12a", "record": rec.name,
                "us_per_call": float(rec.us_per_call),
                "p50_us": rec.p50_us, "max_abs_err": d.get("max_abs_err"),
                "rel_err": d.get("rel_err"), "flops": d["flops"],
                "bytes": d["bytes"]}
        if "_kernel_" in rec.name:
            err = d.get("rel_err" if kernel == "wkv6" else "max_abs_err")
            line.update(launches=d.get("launches"), tol=TOL["float32"])
            if not d.get("launches") or err is None or err > TOL["float32"]:
                problems.append(f"{rec.name}: launches {d.get('launches')}, "
                                f"error {err}")
            if rec.name.endswith("_path") and kernel in summary:
                line.update(phase2_shape=summary[kernel]["shape"],
                            phase2_kernel_ms=summary[kernel]["kernel_ms"],
                            phase2_call_ms=summary[kernel].get(
                                "kernel_call_ms"))
        if "not_run" in d or rec.status != "ok":
            problems.append(f"{rec.name}: {rec.status} {d.get('not_run')}")
        emit(line)
    if problems or len(sink.records) != 18:
        raise AssertionError(f"phase 12a failed ({len(sink.records)} "
                             f"records): {problems}")


def _knobs(scen, **knobs):
    """``scen`` with ``knobs`` added to each of its workloads."""
    return dataclasses.replace(scen, workloads=tuple(
        dataclasses.replace(wl, knobs={**wl.knobs, **knobs})
        for wl in scen.workloads))


def _sharded_steps(dev, mesh, use_reduced: bool) -> dict:
    """12b: granite-3-8b at full width, SHARDED["layers"] layers, f32,
    SyntheticLM(batch=2, seq=4096) (reduced: the reference's reduced
    granite at seq 128): SHARDED["steps"] steps of the unsharded port
    step, then of the sharded step over the (1, 1) mesh in the resident
    and the streaming mode, each from the same seeded params and batches.
    Each step's loss and grad norm within TRAIN_TOL (relative) of the
    unsharded step's; the sharded step's time beside it. Then every
    collective wrapper once on the device's tensors. Returns the sharded
    runs' launch counts."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.train import build_trainer

    seq = REDUCED_TRAIN_SEQ if use_reduced else SHARDED["seq"]
    kw = dict(steps=SHARDED["steps"], batch=SHARDED["batch"], seq=seq,
              use_reduced=use_reduced,
              num_layers=0 if use_reduced else SHARDED["layers"],
              device=dev)
    runs, launches = {}, {}
    for mode in ("unsharded", "resident", "streaming"):
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        extra = {} if mode == "unsharded" else dict(mesh=mesh,
                                                    exec_mode=mode)
        step, params, opt_state, data, rcfg = build_trainer(
            SHARDED["arch"], **kw, **extra)
        ops.reset_launches()
        metrics = []
        for i in range(SHARDED["steps"]):
            batch = data.batch_at(i)
            _sync(dev)
            t0 = time.perf_counter()
            _, _, m = step(params, opt_state, batch)
            _sync(dev)
            metrics.append({"loss": float(m["loss"]),
                            "grad_norm": float(m["grad_norm"]),
                            "step_s": time.perf_counter() - t0})
        if mode != "unsharded":
            launches[f"train:12b-{mode}"] = dict(ops.LAUNCHES)
        runs[mode] = metrics
        del step, params, opt_state, data
    worst = {}
    for mode in ("resident", "streaming"):
        for a, b in zip(runs[mode], runs["unsharded"]):
            for k in TRAIN_TOL:
                rel = abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                worst[f"{mode}:{k}"] = max(worst.get(f"{mode}:{k}", 0.0), rel)
    cfg = rcfg.model
    line = {"phase": "12b", "arch": SHARDED["arch"],
            "layers": cfg.num_layers, "d_model": cfg.d_model,
            "batch": SHARDED["batch"], "seq": seq, "dtype": "float32",
            "mesh": [1, 1], "steps": runs, "max_rel_diff": worst,
            "tol": TRAIN_TOL}
    line["collectives"] = _collective_wrappers(dev, mesh)
    line["ok"] = (all(v <= TRAIN_TOL[k.split(":")[1]]
                      for k, v in worst.items())
                  and all(line["collectives"].values()))
    emit(line)
    if not line["ok"]:
        raise AssertionError(f"phase 12b failed: {worst}, "
                             f"{line['collectives']}")
    return launches


def _collective_wrappers(dev, mesh) -> dict:
    """Every collective wrapper of ``parallel/collectives.py`` once on the
    device's tensors over the one-rank mesh, forward and (for the
    autograd regions) backward, each equal to what one rank gives: the
    identity, the int8 all-reduce within half a quantisation step."""
    import torch

    from repro_torch.parallel import collectives as coll

    g = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn((8, 64), generator=g, device=dev)
    ok = {}
    for name, fn in (("all_reduce", lambda t: coll.all_reduce(t, mesh,
                                                              "data")),
                     ("all_gather", lambda t: coll.all_gather(t, mesh,
                                                              "model", 1)),
                     ("reduce_scatter", lambda t: coll.reduce_scatter(
                         t, mesh, "data", 0))):
        ok[name] = bool(torch.equal(fn(x), x))
    for name, fn in (("copy_to", coll.copy_to),
                     ("reduce_from", coll.reduce_from),
                     ("gather_data", lambda t, m: coll.gather_data(
                         t, m, "data", 1)),
                     ("gather_model", coll.gather_model),
                     ("mean_over", lambda t, m: coll.mean_over(t, m,
                                                               "data"))):
        t = x.clone().requires_grad_()
        y = fn(t, mesh)
        (y * x).sum().backward()
        ok[name] = bool(torch.equal(y.detach(), x)
                        and torch.equal(t.grad, x))
    out, res = coll.compressed_psum_grads({"w": x}, {"w": torch.zeros(
        x.numel(), device=dev)}, mesh, ("data",))
    step = float(x.abs().max()) / 127
    ok["compressed_psum_grads"] = bool(
        (out["w"] - x).abs().max() <= step
        and (out["w"].reshape(-1) + res["w"] - x.reshape(-1)).abs().max()
        <= 1e-5)
    return ok


def _decode_shards(dev, mesh, use_reduced: bool) -> dict:
    """12c: decode attention at qwen1.5-110b's heads (Hq64 Hkv8 D128), B4,
    f32, over a cache of 32,768 tokens cut into P = 1, 2, 4, 8 sequence
    shards in this process (``decode_partials`` per shard, then
    ``combine_partials``), at cache_len 32,768 and at per-row lengths
    (32,768, 20,000, 37, 5): within 1e-5 (absolute) of the plain
    unsharded decode, with each P's time a call (the card's, by CUDA
    events; on the CPU the host's clock). The same over the one-rank mesh
    (``partitioned_decode_attention``). Against kernel K2 at 4,096
    tokens in 16-token pages: P = 8 shards of those tokens within phase
    2's f32 gate. Returns K2's launch counts."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.parallel import collectives as coll

    d = dict(DECODE, S=256, K2_S=128, Hq=8, Hkv=2, D=32) if use_reduced \
        else DECODE
    B, S, Hq, Hkv, D = d["B"], d["S"], d["Hq"], d["Hkv"], d["D"]
    g = torch.Generator(device=dev).manual_seed(12)
    q = torch.randn((B, 1, Hq, D), generator=g, device=dev)
    k = torch.randn((B, S, Hkv, D), generator=g, device=dev)
    v = torch.randn((B, S, Hkv, D), generator=g, device=dev)
    rows = torch.tensor([min(n, S) for n in DECODE_ROWS] if not use_reduced
                        else [S, S * 5 // 8, 37, 5], device=dev)

    def sharded(n_shards, lens, q=q, k=k, v=v):
        n = k.shape[1] // n_shards
        return coll.combine_partials([coll.decode_partials(
            q, k[:, i * n:(i + 1) * n], v[:, i * n:(i + 1) * n], lens,
            i * n) for i in range(n_shards)])

    line = {"phase": "12c", "B": B, "Hq": Hq, "Hkv": Hkv, "D": D,
            "cached": S, "dtype": "float32", "tol": 1e-5, "errors": {},
            "ms": {}, "timer": ("CUDA events" if dev.type == "cuda"
                                else "host clock")}
    for label, lens in (("full", S), ("rows", rows)):
        want = ref.decode_attention_simple(q, k, v, lens)
        for n_shards in DECODE_SHARDS:
            err = float((sharded(n_shards, lens) - want).abs().max())
            line["errors"][f"{label}:P{n_shards}"] = err
            if label == "full":
                line["ms"][f"P{n_shards}"] = _decode_ms(
                    dev, lambda n_shards=n_shards: sharded(n_shards, lens))
        err = float((coll.partitioned_decode_attention(
            q, k, v, lens, mesh, "model") - want).abs().max())
        line["errors"][f"{label}:mesh"] = err
    line["plain_ms"] = _decode_ms(
        dev, lambda: ref.decode_attention_simple(q, k, v, S))
    # K2 over the first K2_S tokens in pages of ps, tables in order
    n2, ps = d["K2_S"], d["ps"]
    kp, vp = (torch.cat([t.new_zeros((1, ps, Hkv, D)), t[:, :n2].reshape(
        B * (n2 // ps), ps, Hkv, D)]) for t in (k, v))
    bt = (1 + torch.arange(B * (n2 // ps), device=dev, dtype=torch.int32)
          ).reshape(B, n2 // ps)
    lens2 = torch.full((B,), n2, dtype=torch.int32, device=dev)
    ops.reset_launches()
    k2 = ops.paged_attention(q, kp, vp, bt, lens2)
    launches = {"12c": dict(ops.LAUNCHES)}
    line["k2_err"] = float((sharded(8, n2, k=k[:, :n2], v=v[:, :n2])
                            - k2).abs().max())
    line["k2_tol"] = TOL["float32"]
    line["ok"] = (max(line["errors"].values()) <= 1e-5
                  and line["k2_err"] <= TOL["float32"])
    emit(line)
    if not line["ok"]:
        raise AssertionError(f"phase 12c failed: {line}")
    return launches


def _decode_ms(dev, fn) -> float:
    """ms a call: CUDA events around 5 calls after a warm one on the
    card, the host's clock on the CPU."""
    import torch
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        return _events_ms(fn, 5)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def _moe_ep(dev, mesh, use_reduced: bool) -> dict:
    """12d: the reference's reduced arctic-480b's ``moe_ffn_shardmap``
    over the one-rank mesh on the device, against the same function on
    the CPU with no mesh, from the same CPU-seeded params and input:
    outputs within 1e-5, ``expert_load`` equal."""
    import torch

    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import moe
    from repro_torch.models.transformer import Runtime

    cfg = reduced(get_arch("arctic-480b"), experts=8)
    g = torch.Generator().manual_seed(12)
    p = moe.moe_init(g, cfg, torch.float32)
    x = torch.randn((8, 16, cfg.d_model), generator=g) * 0.5
    on_dev = Runtime(mesh_batch_axes=("data",), moe_shardmap=True,
                     mesh=mesh)
    with torch.no_grad():
        y, aux = moe.moe_ffn({n: t.to(dev) if not isinstance(t, dict) else
                              {m: u.to(dev) for m, u in t.items()}
                              for n, t in p.items()}, x.to(dev), cfg, on_dev)
        y_cpu, aux_cpu = moe.moe_ffn(p, x, cfg, Runtime(moe_shardmap=True))
    line = {"phase": "12d", "arch": cfg.name, "experts": 8,
            "tokens": x.shape[0] * x.shape[1],
            "max_abs_err": float((y.cpu() - y_cpu).abs().max()),
            "tol": 1e-5, "expert_load": aux["expert_load"].tolist(),
            "loads_equal": bool(torch.equal(aux["expert_load"].cpu(),
                                            aux_cpu["expert_load"])),
            "capacity": aux["capacity"]}
    line["ok"] = line["max_abs_err"] <= 1e-5 and line["loads_equal"]
    emit(line)
    if not line["ok"]:
        raise AssertionError(f"phase 12d failed: {line}")
    return {}


def _scalability_suite() -> None:
    """12e: ``python -m repro_torch.bench --only scalability`` on the
    card: the points whose ranks this machine's cards hold run (over
    NCCL, a fresh process a rank), every other point's record names it as
    not run for want of cards."""
    import torch

    from repro_torch.bench import BenchRunner, ListSink, select
    from repro_torch.bench.__main__ import with_device
    import repro_torch.bench.suites  # noqa: F401  (registers them)

    sink = ListSink()
    out = BenchRunner(sinks=[sink]).run([_knobs(
        with_device(sc, "cuda"), timeout=SCAL_TIMEOUT)
        for sc in select(only="scalability")])
    cards = torch.cuda.device_count()
    problems = [f"{n}: {e}" for n, e in out.failures]
    for rec in sink.records:
        d = rec.derived
        emit({"phase": "12e", "record": rec.name, "status": rec.status,
              "us_per_call": float(rec.us_per_call), **d})
        runs = d.get("ranks", 0) <= cards
        if runs and not (rec.us_per_call > 0 and d.get("backend") == "nccl"):
            problems.append(f"{rec.name} did not run: {d}")
        if not runs and "not_run" not in d:
            problems.append(f"{rec.name} ran without its cards: {d}")
    if problems or not any(r.us_per_call > 0 for r in sink.records):
        raise AssertionError(f"phase 12e failed: {problems}")


# ------------------------------------------------------------ phase 13
def count_problems(meta: dict, real: dict, tol: float = COUNT_TOL) -> list:
    """What disagrees between two counts of one step (``flops``,
    ``dot_flops``, ``bytes``, ``collectives`` by opcode, ``kernels``
    calls): the totals and collective bytes beyond ``tol`` relative, a
    kernel's calls at all."""
    out = []

    def off(a, b):
        return abs(a - b) > tol * max(abs(a), abs(b))

    for key in ("flops", "dot_flops", "bytes"):
        if off(meta[key], real[key]):
            out.append(f"{key}: {meta[key]} vs {real[key]}")
    for op in sorted(set(meta["collectives"]) | set(real["collectives"])):
        a, b = meta["collectives"].get(op, 0.0), real["collectives"].get(
            op, 0.0)
        if off(a, b):
            out.append(f"{op} bytes: {a} vs {b}")
    if meta["kernels"] != real["kernels"]:
        out.append(f"kernel calls: {meta['kernels']} vs {real['kernels']}")
    return out


def resume_problems(unbroken: list, again: list, resumed: list,
                    split: int, params_diff: float = 0.0,
                    params_noise: float = 0.0) -> list:
    """What differs between a run resumed after ``split`` steps and the
    unbroken run it continues, as phase 11d holds a resume: each later
    step's (loss, grad norm) bit for bit, or, where two unbroken runs
    (``unbroken``, ``again``) differ, within their difference; as many
    steps; the final params' largest difference within the two unbroken
    runs' (``params_noise``: 0 on a deterministic device)."""
    out = []
    want, twice = unbroken[split:], again[split:]
    noise = max((abs(a - b) for x, y in zip(want, twice)
                 for a, b in zip(x, y)), default=0.0)
    if len(resumed) != len(want):
        out.append(f"{len(resumed)} resumed steps, {len(want)} wanted")
    for i, (a, b) in enumerate(zip(resumed, want)):
        if max(abs(x - y) for x, y in zip(a, b)) > noise:
            out.append(f"step {split + i}: {a} vs {b} (noise {noise})")
    if params_diff > params_noise:
        out.append(f"final params differ by {params_diff} (noise "
                   f"{params_noise})")
    return out


def _count_summary(report) -> dict:
    return {"flops": report.flops, "dot_flops": report.dot_flops,
            "bytes": report.bytes,
            "collectives": report.collective_summary(),
            "kernels": {k: v["calls"] for k, v in report.kernels.items()}}


def _gate_config(dev, use_reduced: bool = False):
    """13a/13b's step: 12b's (granite-3-8b at full width, 2 layers, f32,
    batch 2 x 4096; reduced: the reference's reduced granite at
    REDUCED_TRAIN_SEQ), the resident sharded step over a (1, 1) mesh,
    through the kernels."""
    import dataclasses

    from repro_torch.configs import (MeshConfig, RunConfig, ShapeConfig,
                                     get_arch, reduced)
    cfg = get_arch(SHARDED["arch"])
    cfg = (reduced(cfg) if use_reduced
           else dataclasses.replace(cfg, num_layers=SHARDED["layers"]))
    seq = REDUCED_TRAIN_SEQ if use_reduced else SHARDED["seq"]
    return RunConfig(model=cfg, shape=ShapeConfig(
        "gate", "train", seq, SHARDED["batch"]),
        mesh=MeshConfig(shape=(1, 1), axes=("data", "model")),
        param_dtype="float32", attention_backend="kernel",
        exec_mode="resident", warmup_steps=10)


def _gate_state(rcfg, dev, mesh, seed: int = 0):
    """(step, opt, params, opt state, data) of the gate's run on
    ``mesh``, params from a seeded generator."""
    import torch

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.parallel.sharding import shard_tree
    from repro_torch.runtime.steps import build_train_step

    step, model, opt = build_train_step(rcfg, total_steps=REMESH_STEPS,
                                        device=dev, mesh=mesh)
    params = shard_tree(model.init_params(torch.Generator(
        device=dev).manual_seed(seed)), model.rt.param_specs, mesh)
    data = SyntheticLM(rcfg.model, rcfg.shape.global_batch,
                       rcfg.shape.seq_len, seed=0, device=str(dev))
    return step, opt, params, opt.init(params), data


def _dry_run(dev, use_reduced: bool = False) -> dict:
    """Phase 13, one part after another: 13a the dry run's cells (the
    card's machine only) and its gate, 13b remesh and (the card only) the
    launcher, its processes started first (``_Launcher``), 13c the scaling
    matrix and the traces (the card only). 13a's
    real count and 13b run over a world-size-1 process group (NCCL on the
    card, gloo on the CPU where the tests run it). Returns the launch
    counts of 13a's real step, 13b's resumed steps and 13c."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_world, make_mesh

    on_card = dev.type == "cuda"
    launches = {}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix=".dist-",
                                     dir=ROOT / "build") as store, \
            _Launcher(Path(store) / "launcher", on_card) as launcher:
        if not use_reduced:
            _dry_run_cells()
        rcfg = _gate_config(dev, use_reduced)
        t0 = time.perf_counter()
        meta = _gate_on_meta(rcfg)
        init_world(dev.type, store_dir=store, rank=0, world_size=1)
        try:
            mesh = make_mesh(rcfg.mesh, dev.type)
            launches["train:13a"] = _gate_on_device(rcfg, dev, mesh, meta,
                                                    t0)
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()
            t0 = time.perf_counter()
            launches["train:13b"] = _remesh_phase(rcfg, dev, mesh, store)
        finally:
            dist.destroy_process_group()
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
            line = {"phase": "13b", "launcher": launcher.result()}
            emit(line)
            if line["launcher"]["resumed_from"] != REMESH_SPLIT - 1:
                raise AssertionError(f"phase 13b's launcher failed: {line}")
        emit({"phase": "13b", "seconds": time.perf_counter() - t0})
    if on_card:
        t0 = time.perf_counter()
        launches["13c"] = _matrix_and_traces()
        emit({"phase": "13c", "seconds": time.perf_counter() - t0})
    return launches


def _dry_run_cells() -> None:
    """13a's cells: ``launch/dryrun.py``'s ``run_cell`` on ``meta`` over
    fake ranks, for DRYRUN_CELLS; each line: per-device flops, dot flops
    and bytes, collective bytes by opcode, the peak against the card's
    memory, the dominant roofline term and the count's seconds. The
    fake world is torn down after the last."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    for arch, shape, multi_pod in DRYRUN_CELLS:
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, multi_pod=multi_pod, save=False)
        h = rec["hlo"]
        emit({"phase": "13a", "arch": arch, "shape": shape,
              "mesh": rec["mesh"], "devices": rec["devices"],
              "counts_of": rec["counts_of"],
              "flops_per_device": h["flops_per_device"],
              "dot_flops_per_device": h["dot_flops_per_device"],
              "bytes_per_device": h["bytes_per_device"],
              "collective_bytes": h["collective_breakdown"],
              "peak_gb": rec["memory"]["peak_gb"],
              "hbm_gb": rec["memory"]["hbm_gb"],
              "dominant": rec["roofline"]["dominant"],
              "count_s": rec["count_s"],
              "seconds": time.perf_counter() - t0})
    dist.destroy_process_group()


def _gate_on_meta(rcfg) -> dict:
    """The gate's step counted by the dry run on ``meta`` over a fake
    world of one rank: its count, its peak and seconds."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    mesh = dryrun.fake_mesh(rcfg.mesh)
    try:
        _, report, mem, count_s = dryrun.count_cell(rcfg, mesh)
    finally:
        dist.destroy_process_group()
    return {"count": _count_summary(report), "peak_gb": mem.peak_bytes / 1e9,
            "count_s": count_s}


def _gate_on_device(rcfg, dev, mesh, meta: dict, t0: float) -> dict:
    """13a's gate: the same step on the device's real tensors, counted by
    ``count_cost`` (the real ``train_step``); flops, dot flops, bytes and
    collective bytes within COUNT_TOL of the dry run's, kernel calls
    equal (and, on the card, equal to the launches); the dry run's peak
    within PEAK_TOL of the device's peak over the step (its bytes
    allocated above what the process held before the step's inputs).
    Returns the step's launches."""
    import torch

    from repro_torch.core.cost import count_cost
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import warm_constants

    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev) if on_card else 0
    step, _, params, state, data = _gate_state(rcfg, dev, mesh)
    batch = data.batch_at(0)
    warm_constants(rcfg.model, dev)
    _sync(dev)                   # also resets the peak
    ops.reset_launches()
    _, report = count_cost(step, params, state, batch)
    counts = dict(ops.LAUNCHES)
    real_peak = (_peak(dev) - base) / 1e9 if on_card else None
    real = _count_summary(report)
    problems = count_problems(meta["count"], real)
    if on_card:
        launched = {k: n for k, n in counts.items() if n}
        if launched != real["kernels"]:
            problems.append(f"launches {launched} vs counted calls "
                            f"{real['kernels']}")
        rel = abs(meta["peak_gb"] - real_peak) / real_peak
        if rel > PEAK_TOL:
            problems.append(f"peak {meta['peak_gb']} GB vs "
                            f"{real_peak} GB on the card")
    emit({"phase": "13a", "gate": "meta against the device",
          "arch": rcfg.model.name, "layers": rcfg.model.num_layers,
          "batch": rcfg.shape.global_batch, "seq": rcfg.shape.seq_len,
          "mesh": list(rcfg.mesh.shape), "meta": meta["count"],
          "device": real, "count_tol": COUNT_TOL,
          "meta_peak_gb": meta["peak_gb"], "device_peak_gb": real_peak,
          "peak_tol": PEAK_TOL, "meta_count_s": meta["count_s"],
          "launches": counts, "problems": problems,
          "seconds": time.perf_counter() - t0})
    del step, params, state
    if problems:
        raise AssertionError(f"phase 13a failed: {problems}")
    return counts


def _remesh_phase(rcfg, dev, mesh, where) -> dict:
    """13b: REMESH_STEPS steps of the gate's step unbroken, twice (is the
    step deterministic?); then REMESH_SPLIT steps saving a sharded
    checkpoint (``train_loop.run`` with ``sharding``), ``remesh`` onto a
    fresh (1, 1) mesh, and the rest from the restored shards; losses,
    grad norms and the final params equal bit for bit (or within the two
    unbroken runs' difference, :func:`resume_problems`). Returns the
    resumed steps' launches."""
    import torch

    from repro_torch._tree import tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.runtime import train_loop
    from repro_torch.runtime.elastic import remesh, train_state_specs
    from repro_torch.runtime.steps import build_train_step

    def run(step, params, state, data, steps):
        out = []
        for i in steps:
            _, _, m = step(params, state, data.batch_at(i))
            out.append((float(m["loss"]), float(m["grad_norm"])))
        return out

    def max_diff(a, b):
        return max(float((x.cpu().double() - y.double()).abs().max())
                   for x, y in zip(a, b))

    unbroken, finals = [], []
    for _ in range(2):          # twice: is the step deterministic here?
        step, _, params, state, data = _gate_state(rcfg, dev, mesh)
        unbroken.append(run(step, params, state, data, range(REMESH_STEPS)))
        finals.append([t.detach().cpu() for t in tree_leaves(params)])
        del step, params, state
        gc.collect()
    params_noise = max_diff(finals[1], finals[0])
    specs, template = train_state_specs(rcfg)
    ckpt_dir = Path(where) / "ckpt"
    step, _, params, state, data = _gate_state(rcfg, dev, mesh)
    t0 = time.perf_counter()
    first = train_loop.run(step, params, state, data.batch_at,
                           total_steps=REMESH_SPLIT, ckpt_dir=str(ckpt_dir),
                           ckpt_every=REMESH_STEPS, sharding=(specs, mesh))
    first_s = time.perf_counter() - t0
    before = [(m["loss"], m["grad_norm"]) for m in first.metrics]
    del step, params, state
    gc.collect()
    t0 = time.perf_counter()
    mesh2, out = remesh(str(ckpt_dir), template, rcfg.mesh, specs,
                        device=dev.type)
    restore_s = time.perf_counter() - t0
    step, _, _ = build_train_step(rcfg, total_steps=REMESH_STEPS, device=dev,
                                  mesh=mesh2)
    params, state = out["tree"]["params"], out["tree"]["opt"]
    ops.reset_launches()
    resumed = run(step, params, state, data,
                  range(REMESH_SPLIT, REMESH_STEPS))
    counts = dict(ops.LAUNCHES)
    got = tree_leaves(params)
    params_diff = (max_diff(got, finals[0]) if len(got) == len(finals[0])
                   else float("inf"))
    problems = resume_problems(unbroken[0], unbroken[1], before + resumed,
                               0, params_diff, params_noise)
    nbytes = sum(f.stat().st_size for f in ckpt_dir.rglob("*.npy"))
    line = {"phase": "13b", "arch": rcfg.model.name,
            "layers": rcfg.model.num_layers, "mesh": list(rcfg.mesh.shape),
            "restored_step": out["step"], "saved_steps": first.checkpoints,
            "unbroken": unbroken[0], "unbroken_again": unbroken[1],
            "resumed": before + resumed,
            "step_deterministic": unbroken[0] == unbroken[1],
            "params_max_diff": params_diff,
            "params_max_diff_unbroken_runs": params_noise,
            "checkpoint_bytes": nbytes,
            "steps_and_save_s": first_s, "restore_s": restore_s,
            "launches": counts,
            "problems": problems}
    if out["step"] != REMESH_SPLIT - 1:
        problems.append(f"restored step {out['step']}")
    del step, params, state, out
    gc.collect()
    emit(line)
    if problems:
        raise AssertionError(f"phase 13b failed: {problems}")
    return counts


class _Launcher:
    """13b's launcher (``_launcher_resume``) on the card, in a thread of
    its own from the start of phase 13: its two launches are processes of
    their own (torch's import, a first step and ``torchrun``'s rendezvous,
    about half a minute each), so they run while 13a counts on ``meta``
    and 13b steps in this process. Leaving the block kills a launch still
    running (``torchrun`` and its rank: each launch leads a process group
    of its own), and starts no other."""

    def __init__(self, ckpt_dir: Path, on_card: bool):
        import threading
        self.ckpt_dir, self.on_card = ckpt_dir, on_card
        self.lock, self.stopped = threading.Lock(), False
        self.procs, self.out = [], None
        self.thread = threading.Thread(target=self._run, daemon=True)

    def __enter__(self):
        if self.on_card:
            self.thread.start()
        return self

    def __exit__(self, *exc):
        with self.lock:
            self.stopped = True
            for proc in self.procs:
                _kill_group(proc)
        if self.thread.is_alive():
            self.thread.join()
        return False

    def _start(self, cmd, **kw):
        with self.lock:
            if self.stopped:
                return None
            proc = subprocess.Popen(cmd, **kw)
            self.procs.append(proc)
            return proc

    def _run(self):
        try:
            self.out = _launcher_resume(self.ckpt_dir, self._start)
        except Exception as e:          # re-raised by result()
            self.out = e

    def result(self) -> dict:
        self.thread.join()
        if isinstance(self.out, Exception):
            raise self.out
        return self.out


def _kill_group(proc) -> None:
    """Kill the process group ``proc`` leads, unless it has ended."""
    if proc.poll() is None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass


def _launcher_resume(ckpt_dir: Path, start=subprocess.Popen) -> dict:
    """``launch/train.py`` under one ``torchrun`` rank with ``--ckpt-dir``
    (the reduced granite): REMESH_SPLIT steps, then a second launch on to
    REMESH_STEPS, which resumes; its ``resumed_from`` and losses. ``start``
    starts a launch (returns its ``Popen``, or None: stop)."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = {}
    t0 = time.perf_counter()
    for steps in (REMESH_SPLIT, REMESH_STEPS):
        proc = start(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "1", "-m", "repro_torch.launch.train",
             "--arch", SHARDED["arch"], "--batch", "2", "--seq", "128",
             "--steps", str(steps), "--ckpt-dir", str(ckpt_dir),
             "--ckpt-every", "100", "--log-every", "1"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, start_new_session=True)
        if proc is None:
            raise AssertionError("13b launcher stopped")
        try:
            stdout, stderr = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            _kill_group(proc)
            proc.communicate()
            raise AssertionError("13b launcher ran past 300 s") from None
        if proc.returncode:
            raise AssertionError(f"13b launcher failed: {stderr[-2000:]}")
        out[steps] = stdout
    final = re.search(r"resumed_from=(\S+)", out[REMESH_STEPS]).group(1)
    return {"resumed_from": None if final == "None" else int(final),
            "last_line": out[REMESH_STEPS].strip().splitlines()[-1],
            "seconds": time.perf_counter() - t0}


def _matrix_and_traces() -> dict:
    """13c: ``python -m repro_torch.bench --only scaling_matrix,
    trace_replay`` through the harness's API on the card. The 1x1 train
    trace's identity replay within TRACE_GATE of its measured median, its
    calibration ratio inside CALIBRATION_BAND; halving the compute lane predicts no longer a step; the served
    burst's trace replays to the engine's busy time within 1e-9; the
    points wider than the machine's cards named as not run. Returns the
    launches in this process (the served engines')."""
    from repro_torch.bench import BenchRunner, ListSink, select
    from repro_torch.bench.__main__ import with_device
    from repro_torch.bench.suites import scaling_matrix as sm
    from repro_torch.bench.suites import serving
    from repro_torch.kernels import ops
    from repro_torch.trace import replay, scale_kind
    import repro_torch.bench.suites  # noqa: F401  (registers them)

    sink = ListSink()
    ops.reset_launches()
    out = BenchRunner(sinks=[sink]).run(
        [with_device(sc, "cuda") for sc in
         select(only="scaling_matrix,trace_replay")])
    counts = dict(ops.LAUNCHES)
    problems = [f"{n}: {e}" for n, e in out.failures]
    recs = {r.name: r for r in sink.records}
    for rec in sink.records:
        emit({"phase": "13c", "record": rec.name, "status": rec.status,
              "us_per_call": float(rec.us_per_call), "derived": rec.derived})
    one = sm.mesh_traces(1, "cuda")["1x1"]
    base = replay(one).predicted_s
    halved = replay(one, edits=[scale_kind("compute", 0.5)]).predicted_s
    cell = recs.get("trace_replay/dp1")
    serve = recs.get("trace_replay/serve_paged")
    if cell is None or cell.derived["rel_err"] > TRACE_GATE:
        problems.append(f"trace_replay/dp1: {cell and cell.derived}")
    ratio = one.meta["calibration_ratio"]
    if not CALIBRATION_BAND[0] <= ratio <= CALIBRATION_BAND[1]:
        problems.append(f"calibration ratio {ratio} outside "
                        f"{CALIBRATION_BAND}")
    if halved > base:
        problems.append(f"halved compute predicts {halved} > {base}")
    if serve is None or serve.derived["rel_err"] > 1e-9:
        problems.append(f"serve_paged: {serve and serve.derived}")
    if not counts["paged_attention"] or not counts["rmsnorm"]:
        problems.append(f"the served engines launched {counts}")
    emit({"phase": "13c", "trace": one.name,
          "measured_s": one.measured_step_s, "identity_s": base,
          "compute_halved_s": halved, "calibration_ratio": ratio,
          "calibration_band": CALIBRATION_BAND,
          "collective_bytes": one.meta.get("collective_bytes"),
          "collective_ici_bytes": one.meta.get("ici_bytes"),
          "kernels": one.meta.get("kernels"),
          "records": len(sink.records), "problems": problems})
    serving._params.cache_clear()      # phase 9 builds its own again
    if problems:
        raise AssertionError(f"phase 13c failed: {problems}")
    return counts


def _deploy_problems(records: list, failures: list, launches: dict,
                     on_card: bool) -> list:
    """Phase 11b's gates: no workload failed; every record of
    DEPLOY_RECORDS is there with a finite, positive ``tok_s``; on the card
    B2, B3, B4 and K3 each launched."""
    out = [f"{name}: {err}" for name, err in failures]
    ok = {r.name: r for r in records if r.status == "ok"}
    for name in DEPLOY_RECORDS:
        tok = ok[name].derived.get("tok_s") if name in ok else None
        if tok is None or not math.isfinite(tok) or tok <= 0:
            out.append(f"{name}: no record with a finite tok_s ({tok})")
    if on_card:
        out += [f"deploy launched no {k}" for k in BF16_PATHS["deploy"]
                if launches.get(k, 0) <= 0]
    return out


def _deploy(dev, use_reduced: bool = False) -> dict:
    """Phase 11b: the port's batch/precision suite (``deploy/batch`` B1-32
    in f32, ``deploy/precision`` f32 and bf16 at B8; qwen2.5-32b at its
    published width cut to 4 layers, or under ``use_reduced`` the
    reference's reduced block) through the harness's runner, every launch
    count set to 0 before it; one line of its records with the bf16/f32
    tok_s ratio; fails on ``_deploy_problems``. Returns its counts as
    ``deploy``."""
    import repro_torch.bench.suites  # noqa: F401  (registers the scenarios)
    from repro_torch.bench import (BenchRunner, ListSink, env_fingerprint,
                                   select)
    from repro_torch.bench.suites import batch_precision
    from repro_torch.kernels import ops

    def on(scen):
        return dataclasses.replace(scen, workloads=tuple(
            dataclasses.replace(w, knobs={**w.knobs, "device": dev.type,
                                          "reduced": use_reduced})
            for w in scen.workloads))

    t0 = time.perf_counter()
    ops.reset_launches()
    sink = ListSink()
    try:
        summary = BenchRunner(sinks=[sink],
                              env=env_fingerprint(dev.type)).run(
            [on(s) for s in select(only=",".join(DEPLOY_SCENARIOS))])
    finally:
        batch_precision._grad_fn.cache_clear()
    counts = dict(ops.LAUNCHES)
    tok = {r.name: r.derived.get("tok_s") for r in sink.records
           if r.status == "ok"}
    f32, bf16 = (tok.get(f"deploy/precision_{d}")
                 for d in ("float32", "bfloat16"))
    cfg = batch_precision.config(use_reduced)
    emit({"phase": "deploy", "arch": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "params": cfg.param_count(),
          "seq": batch_precision.SEQ, "seconds": time.perf_counter() - t0,
          "failures": summary.failures,
          "records": [{"name": r.name, "status": r.status,
                       "us_per_call": r.us_per_call, "derived": r.derived}
                      for r in sink.records],
          "bf16_over_f32_tok_s": bf16 / f32 if f32 and bf16 else None,
          "launches": counts})
    problems = _deploy_problems(sink.records, summary.failures, counts,
                                dev.type == "cuda")
    if problems:
        raise AssertionError(f"phase 11b failed: {problems}")
    return {"deploy": counts}


def _bf16_unit(x) -> float:
    """One unit of bf16 rounding at ``x``'s largest magnitude."""
    import torch
    _, e = torch.frexp(x.float().abs().max())
    return math.ldexp(1.0, int(e) - 8)


def _flip_check(a: dict, b: dict, margin_at, bound: float) -> tuple:
    """Greedy tokens of two paths per rid (``a``, ``b``) under the flip
    rule: identical up to the first step where they differ; at that step
    the plain path's top-1/top-2 logit margin there (``margin_at(rid,
    step)["margin"]``; its other keys are reported) must not exceed
    ``bound`` (11c: the largest logit difference between the paths at
    prefill; -inf: no flip at all); nothing after it is compared. Returns
    (flips: [{rid, step, margin, bound, ok, ...}], problems)."""
    flips, problems = [], []
    for rid in sorted(a):
        x, y = a[rid], b.get(rid)
        if y is None:
            problems.append(f"rid {rid} missing")
            continue
        step = next((i for i, (s, t) in enumerate(zip(x, y)) if s != t),
                    None)
        if step is None:
            if len(x) != len(y):
                problems.append(f"rid {rid}: {len(x)} against {len(y)} "
                                "tokens")
            continue
        at = margin_at(rid, step)
        margin = float(at["margin"])
        flips.append({**at, "rid": rid, "step": step, "margin": margin,
                      "bound": bound, "ok": margin <= bound})
        if margin > bound:
            problems.append(f"rid {rid} flips at step {step} with margin "
                            f"{margin} > {bound}")
    return flips, problems


def _ckpt_config(use_reduced: bool):
    """Phase 11d's RunConfig: ``TRAIN["11d"]`` (granite-3-8b at full width,
    1 layer, bf16 params with an f32 master) on the kernels, or under
    ``use_reduced`` the reference's reduced granite at 1 layer and 2 x 128
    tokens."""
    from repro_torch.configs import ShapeConfig, get_arch, reduced
    rcfg = _train_config("11d", "kernel")
    if use_reduced:
        rcfg = dataclasses.replace(
            rcfg, model=reduced(get_arch(ARCH), layers=1),
            shape=ShapeConfig("train", "train", REDUCED_TRAIN_SEQ,
                              TRAIN_BATCH))
    return rcfg


def _ckpt_resume(dev, use_reduced: bool = False, where=None) -> dict:
    """Phase 11d: CKPT_STEPS steps of ``_ckpt_config`` unbroken, twice
    (whether the step is deterministic); then CKPT_EVERY steps saving with
    ``ckpt_every=CKPT_EVERY``, the state rebuilt from another seed, and a
    resume through ``train_loop.run`` to CKPT_STEPS. Gate: the resumed
    steps' losses and grad norms equal the unbroken run's bit for bit (or,
    if the two unbroken runs differ, within their difference), resumed
    from step CKPT_EVERY - 1. Reports a save's bytes and its save and
    restore seconds. Writes under a temporary directory of ``where``
    (default ``build/``) and removes it. Returns the resumed run's counts
    as ``train:11d``."""
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.runtime import train_loop
    from repro_torch.runtime.steps import build_train_step

    rcfg = _ckpt_config(use_reduced)
    data = SyntheticLM(rcfg.model, TRAIN_BATCH, rcfg.shape.seq_len, seed=0,
                       device=str(dev))

    def state(seed: int):
        step, model, opt = build_train_step(rcfg, total_steps=CKPT_STEPS,
                                            device=dev)
        params = model.init_params(
            torch.Generator(device=dev).manual_seed(seed))
        return step, params, opt.init(params)

    def metrics(res):
        return [(m["loss"], m["grad_norm"]) for m in res.metrics]

    unbroken = []
    for _ in range(2):
        unbroken.append(metrics(train_loop.run(
            *state(0), data.batch_at, total_steps=CKPT_STEPS)))
        gc.collect()
    base = Path(where) if where is not None else ROOT / "build"
    base.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=".ckpt-", dir=base))
    try:
        first = train_loop.run(*state(0), data.batch_at,
                               total_steps=CKPT_EVERY, ckpt_dir=str(tmp),
                               ckpt_every=CKPT_EVERY)
        gc.collect()
        step, params, opt_state = state(1)       # another seed
        ops.reset_launches()
        resumed = train_loop.run(step, params, opt_state, data.batch_at,
                                 total_steps=CKPT_STEPS, ckpt_dir=str(tmp),
                                 ckpt_every=CKPT_EVERY)
        counts = dict(ops.LAUNCHES)
        # one save and one restore of the resumed run's state, timed
        tree = {"params": params, "opt": opt_state}
        _sync(dev)
        t0 = time.perf_counter()
        ckpt.save(tmp / "timed", 0, tree)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ckpt.restore(tmp / "timed", 0, tree)
        _sync(dev)
        restore_s = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size
                     for f in (tmp / "timed" / "step_0").iterdir())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    got, want, again = metrics(resumed), unbroken[0][CKPT_EVERY:], \
        unbroken[1][CKPT_EVERY:]
    noise = max((abs(a - b) for x, y in zip(want, again)
                 for a, b in zip(x, y)), default=0.0)
    off = max((abs(a - b) for x, y in zip(got, want) for a, b in zip(x, y)),
              default=float("inf"))
    line = {"phase": "checkpoint", "arch": rcfg.model.name,
            "layers": rcfg.model.num_layers, "param_dtype": rcfg.param_dtype,
            "reduced": TRAIN["11d"]["cut"] if not use_reduced else
            "the reference's reduced config",
            "saved_steps": first.checkpoints,
            "resumed_from": resumed.resumed_from,
            "final_step": resumed.final_step,
            "resumed_saves": resumed.checkpoints,
            "unbroken": unbroken[0], "unbroken_again": unbroken[1],
            "resumed": got, "step_deterministic": noise == 0.0,
            "max_diff_resumed": off, "max_diff_unbroken_runs": noise,
            "bytes": nbytes, "save_s": save_s, "restore_s": restore_s,
            "launches": counts}
    emit(line)
    if (first.checkpoints != [CKPT_EVERY - 1]
            or resumed.resumed_from != CKPT_EVERY - 1
            or resumed.final_step != CKPT_STEPS
            or len(got) != CKPT_STEPS - CKPT_EVERY or off > noise):
        raise AssertionError(f"phase 11d: resume differs: {line}")
    return {"train:11d": counts}


def _shared_tables(draw, ps: int, cow: bool, dev) -> tuple:
    """K2's inputs as the prefix cache lays them out: 4 rows of a
    SYSTEM_LEN-token shared prompt plus 8 tokens each and a few decoded
    (lengths 32, 31, 28, 25), the system prompt's pages shared by all
    four block tables, the rest each row's own, in pool order. With
    ``cow``, row 0's first page past the shared ones is a copy-on-write
    duplicate of row 1's (equal bytes, another physical page). Returns
    (q, k pages, v pages, block tables, lengths)."""
    import torch
    B, Hq, Hkv, D = 4, 32, 8, 128
    lens = torch.tensor([32, 31, 28, 25], dtype=torch.int32, device=dev)
    n_sys, npag = SYSTEM_LEN // ps, -(-32 // ps)
    P = 1 + n_sys + B * (npag - n_sys) + int(cow)
    q = draw((B, 1, Hq, D))
    kp, vp = draw((P, ps, Hkv, D)), draw((P, ps, Hkv, D))
    own = torch.arange(1 + n_sys, 1 + n_sys + B * (npag - n_sys),
                       device=dev).reshape(B, npag - n_sys)
    shared = torch.arange(1, 1 + n_sys, device=dev).expand(B, n_sys)
    bt = torch.cat([shared, own], 1).to(torch.int32).contiguous()
    if cow:
        src, dst = int(bt[1, n_sys]), P - 1
        kp[dst].copy_(kp[src])
        vp[dst].copy_(vp[src])
        bt[0, n_sys] = dst
    return q, kp, vp, bt, lens


def _serving_tables(draw, gen, B: int, ps: int, npag: int, P: int,
                    lens: tuple, shared: int, retired: tuple, dev) -> tuple:
    """K2's inputs as one of phase 9's engines lays them out (a line of
    ``SERVING_K2``): ``B`` lanes at Hq32 Hkv8 D128 over a pool of ``P``
    pages of ``ps`` tokens and tables ``npag`` wide. Each live row holds
    the pages its length needs, in shuffled pool order: the first
    ``shared`` of them common to every live row, the rest its own, and
    the null page 0 past them. A lane never admitted (length 1) or
    ``retired`` has an all-null table, as the engine leaves it. Returns
    (q, k pages, v pages, block tables, lengths)."""
    import torch
    Hq, Hkv, D = 32, 8, 128
    q = draw((B, 1, Hq, D))
    kp, vp = draw((P, ps, Hkv, D)), draw((P, ps, Hkv, D))
    perm = (torch.randperm(P - 1, generator=gen, device=dev) + 1).tolist()
    bt = torch.zeros((B, npag), dtype=torch.int32)
    nxt = shared
    for b, n in enumerate(lens):
        if n == 1 or b in retired:
            continue
        own = -(-n // ps) - shared
        bt[b, :shared + own] = torch.tensor(perm[:shared]
                                            + perm[nxt:nxt + own])
        nxt += own
    if nxt > P - 1:
        raise ValueError(f"{nxt} pages do not fit a pool of {P}")
    return (q, kp, vp, bt.to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


def _serve_ssm_in_child(arch: str) -> None:
    """Runs the parity half of phase 3b or 3c (``_serve_ssm_parity``) in a
    child process without a cuBLAS workspace, so without split-K, which
    cuBLAS chooses by row count: the static engine (prefills of 4 rows)
    and the continuous one (of 1 row) then split their products alike.
    rwkv6-3b at its random init is chaotic over its 32 layers in f32 (two
    exact plain methods differ by a few percent in its logits, see the
    parity line), enough to flip greedy tokens between the two (PERF.md,
    Findings). The setting must precede cuBLAS's first use, hence the
    child; the timed runs stay in this process, with the default setting
    that the port's users run. Echoes the child's phase lines."""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":0:0")
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          SSM_CHILD_FLAG, arch], env=env, cwd=ROOT,
                         stdout=subprocess.PIPE, text=True, timeout=900)
    for line in out.stdout.splitlines():
        print(line, flush=True)
    if out.returncode != 0:
        raise AssertionError(f"phase {arch} failed (exit {out.returncode})")


def _ssm_serving(dev, arch: str, workspace: str) -> dict:
    """Serves ``arch`` at full width and depth through the static and the
    continuous engine, with B6 in every prefill, on phase 3's request mix
    (plus two prompts past hymba's window). Emits one ``serve`` line per
    engine, with ``workspace`` naming the cuBLAS setting, and checks the
    completions and each kernel's launches. Returns the model, its
    params, the requests, engines, reports, launch counts and greedy
    tokens per engine."""
    import torch

    from repro_torch._tree import tree_leaves
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_engine
    from repro_torch.models import Runtime, build

    cfg = get_arch(arch)
    L, long_len = cfg.num_layers, SSM_ARCHS[arch]
    model = build(cfg, Runtime(), device=dev)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    leaves = tree_leaves(params)
    emit({"phase": "weights", "arch": arch, "layers": L,
          "params": sum(t.numel() for t in leaves), "dtype": "float32",
          "bytes": sum(t.numel() * t.element_size() for t in leaves),
          "init_s": time.perf_counter() - t0})
    reqs = _request_mix(cfg, long_len)
    common = dict(batch=4, prompt_len=max(128, long_len), max_new_tokens=32,
                  use_reduced=False, params=params, device=dev)
    engines = {s: build_engine(arch, scheduler=s, **common)[0]
               for s in ("static", "continuous")}
    hybrid = cfg.family == "hybrid"
    reports, launches = {}, {}
    for name, eng in engines.items():
        eng.warmup(128)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        reports[name] = rep = eng.run(reqs)
        n = launches[f"{arch}:{name}"] = dict(ops.LAUNCHES)
        s = rep.summary()
        forwards = s["prefills"] + s["decode_steps"]
        want = {"wkv6": L * s["prefills"],
                "flash_attention": L * s["prefills"] if hybrid else 0,
                "paged_attention": 0,
                "rmsnorm": (2 * L + 1) * forwards if hybrid else 0}
        emit({"phase": "serve", "arch": arch, "scheduler": name,
              "cublas_workspace": workspace,
              "requests": len(reqs), "lanes": eng.slots,
              "cache_span": eng.cache_span,
              **{k: s[k] for k in (
                  "completed", "total_new_tokens", "makespan_s",
                  "goodput_rps", "goodput_tps", "decode_steps", "prefills",
                  "ttft_p50_s", "ttft_p95_s", "tok_p50_s", "tok_p95_s",
                  "peak_concurrency")},
              "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
              "launches": n, "launches_expected": want})
        if s["completed"] != len(reqs):
            raise AssertionError(f"{arch} {name}: {s['completed']}/"
                                 f"{len(reqs)} requests completed")
        if any(n[k] != v for k, v in want.items()):
            raise AssertionError(f"{arch} {name}: launches {n}, expected "
                                 f"{want}")
    toks = {name: {m.rid: [int(t) for t in m.tokens] for m in rep.metrics}
            for name, rep in reports.items()}
    budget = {r.rid: r.max_new_tokens for r in reqs}
    for name, tk in toks.items():
        for rid, seq in tk.items():
            if len(seq) != budget[rid] or not all(
                    0 <= t < cfg.vocab_size for t in seq):
                raise AssertionError(f"{arch} {name} rid {rid}: bad tokens "
                                     f"{seq}")
    return dict(cfg=cfg, model=model, params=params, reqs=reqs,
                engines=engines, launches=launches, toks=toks)


def _serve_ssm(dev, arch: str) -> dict:
    """Phases 3b (rwkv6-3b) and 3c (hymba-1.5b), the timed half, in this
    process with cuBLAS's default workspace as users of the port run it:
    serve through both engines (``_ssm_serving``), then the continuous
    engine's first four requests again under the profiler. Whether the
    engines' tokens agree here is reported, not gated (split-K, see
    ``_serve_ssm_in_child``). Returns each engine's launch counts under
    ``"<arch>:<scheduler>"``."""
    from repro_torch.core.profile import profile_run

    run = _ssm_serving(dev, arch, "default")
    emit({"phase": "engines_agree", "arch": arch,
          "cublas_workspace": "default", "gated": False,
          "tokens_identical": _first_mismatch(
              run["toks"]["continuous"], run["toks"]["static"]) is None})
    # the first four requests only: tracing the whole mix takes longer
    # than serving it (about a minute per arch on the H100)
    emit({"phase": "profile", "arch": arch, "requests": 4,
          "cublas_workspace": "default",
          **profile_run(run["engines"]["continuous"], run["reqs"][:4])})
    return run["launches"]


def _serve_ssm_parity(dev, arch: str) -> None:
    """Phases 3b and 3c, the parity half, run by the child without a
    cuBLAS workspace: serve through both engines again; greedy tokens
    identical per rid; on the longest prompt (hymba: past the window)
    every layer through the kernels within LOGIT_TOL of the plain layer's
    update, and the prefill logits of the kernels, the plain path
    (dense attention, chunked linear attention) and the exact per-token
    recurrence pairwise within LOGIT_CEILING[arch], the kernels within
    LOGIT_TOL of the plain path or, where larger, within what the plain
    path and the recurrence differ by."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import Runtime, build

    run = _ssm_serving(dev, arch, "none (CUBLAS_WORKSPACE_CONFIG=:0:0)")
    cfg, model, params, reqs, toks = (run[k] for k in (
        "cfg", "model", "params", "reqs", "toks"))
    mismatch = _first_mismatch(toks["continuous"], toks["static"])
    plain, exact = (build(cfg, Runtime(attention_backend="dense",
                                       ssm_backend=b), device=dev)
                    for b in ("chunked", "recurrent"))
    req = max(reqs, key=lambda r: r.prompt_len)   # hymba: past the window
    prompt = torch.as_tensor(req.prompt[None], device=dev)
    span = run["engines"]["continuous"].cache_span
    layer_errs = _layer_errors(model, plain, params, prompt)
    ops.reset_launches()
    lk, _ = model.prefill(params, {"tokens": prompt}, span)
    through = dict(ops.LAUNCHES)
    lp, _ = plain.prefill(params, {"tokens": prompt}, span)
    lx, _ = exact.prefill(params, {"tokens": prompt}, span)
    top = float(lp.abs().max())
    rel, rel_exact, floor = (_err(a, b) / top
                             for a, b in ((lk, lp), (lk, lx), (lp, lx)))
    ceiling = LOGIT_CEILING[arch]
    tol = max(LOGIT_TOL, floor)
    parity = {"phase": "parity", "arch": arch, "rids": len(toks["static"]),
              "cublas_workspace": "none (CUBLAS_WORKSPACE_CONFIG=:0:0)",
              "tokens_identical": mismatch is None,
              "prefill_prompt_len": req.prompt_len,
              "layer_update_rel_err_max": max(layer_errs),
              "layer_update_rel_err": layer_errs,
              "layer_tol": LOGIT_TOL,
              "prefill_logits_shape": list(lk.shape),
              "prefill_logits_finite": bool(torch.isfinite(lk).all()),
              "prefill_launches": through,
              "kernel_vs_plain_prefill_rel_err": rel,
              "kernel_vs_recurrent_prefill_rel_err": rel_exact,
              "plain_vs_recurrent_prefill_rel_err": floor,
              "tol": tol, "ceiling": ceiling}
    if mismatch is not None:
        rid, step = mismatch
        r = next(r for r in reqs if r.rid == rid)
        seq = list(r.prompt) + toks["continuous"][rid][:step]
        lg, _ = plain.prefill(params, {"tokens": torch.as_tensor(
            [seq], dtype=torch.int32, device=dev)}, len(seq))
        top2 = torch.topk(lg[0, -1], 2).values
        parity.update(first_mismatch_rid=rid, first_mismatch_step=step,
                      top2_margin=float(top2[0] - top2[1]))
    emit(parity)
    if mismatch is not None:
        raise AssertionError(f"{arch}: greedy tokens differ between "
                             f"engines: {parity}")
    if (not parity["prefill_logits_finite"] or max(layer_errs) > LOGIT_TOL
            or max(floor, rel_exact) > ceiling or rel > tol
            or through["wkv6"] != cfg.num_layers):
        raise AssertionError(f"{arch}: full-width prefill check failed: "
                             f"{parity}")


def _layer_errors(model, plain, params, prompt) -> list:
    """Each layer of ``model`` (the kernels) against the same layer of
    ``plain`` on the same input, the plain path's own activations: the
    max difference of the outputs over the max magnitude of the plain
    layer's update (output minus input). Comparing layer by layer keeps
    the check at the kernels' own error where the model's depth would
    amplify it."""
    import torch

    from repro_torch._tree import layer_at
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import embed_tokens

    cfg = model.cfg
    x = embed_tokens(params["embed"], prompt)
    positions = torch.arange(prompt.shape[1], device=x.device)[None]
    errs = []
    for i in range(cfg.num_layers):
        p = layer_at(params["layers"], i)
        yk = tfm.layer_apply(p, x, cfg, model.rt, positions)[0]
        yp = tfm.layer_apply(p, x, cfg, plain.rt, positions)[0]
        errs.append(_err(yk, yp) / float((yp - x).abs().max()))
        x = yp
    return errs


def _fwd_cluster(B, Sq, Sk, Hq, Hkv, D, dname) -> int:
    """The cluster of K1's launch at these sizes, from the C plan query
    (f32 splits the key range where the grid underfills the card)."""
    from repro_torch.kernels import _build
    return _build.plan("flash_attention_fwd", B, Sq, Sk, Hq, Hkv, D,
                       0 if dname == "float32" else 1)["cluster"]


def _sdpa_backend(q, k, v, causal: bool) -> str:
    """The backend ``F.scaled_dot_product_attention(q, k, v, is_causal=
    causal, enable_gqa=True)`` dispatches these inputs to, asked of its
    dispatcher without a run. A profiled call would also name it, but
    with one in phase 2 phase 3's host-bound serving read some 30% slower
    in turns, and not without it (PERF.md, PR 29; ``host_turns.py``)."""
    import torch
    from torch.nn.attention import SDPBackend
    return SDPBackend(torch._fused_sdp_choice(
        q, k, v, is_causal=causal, enable_gqa=True)).name


def _family_kernels(rand, record, gen, k1=FAMILY_K1, k2=FAMILY_K2,
                    dtypes=("float32", "bfloat16"),
                    stream: int = 6) -> None:
    """Phase 2's lines at phase 10's shapes, in f32 and bf16, from their own
    stream (6; ``gen`` draws its block tables): K1 at FAMILY_K1 (whisper's
    bidirectional encoder, its cross attention at Sq != Sk, its decoder
    prompt, qwen2-vl's and arctic's prefills) against the plain version,
    library SDPA with the same mask; K2 at FAMILY_K2's heads on phase 3's
    paged table, (Hq, Hkv, D). Phase 11's and stablelm-12b's lines pass
    their own shapes, dtypes and stream. Each K1 line names the backend
    SDPA dispatched its inputs to (``_sdpa_backend``)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref, work

    for dname in dtypes:
        dtype = getattr(torch, dname)
        # K1 at phase 10's shapes (their own stream): whisper's
        # bidirectional encoder and cross attention (Sq != Sk), its decoder
        # prompt, and qwen2-vl's and arctic's prefills
        for B, Sq, Sk, Hq, Hkv, D, causal in k1:
            kw = dict(causal=causal, window=0)
            q = rand((B, Sq, Hq, D), dtype, stream=stream)
            k, v = (rand((B, Sk, Hkv, D), dtype, stream=stream)
                    for _ in "kv")
            out = ops.flash_attention(q, k, v, **kw)
            want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                           **kw)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            flops, nbytes = work.flash_forward(q, k, **kw)
            b_ms, b_by = bound(flops, nbytes, dname)
            b_ms3 = ({"bound_3xtf32_ms": bound_3xtf32(flops, nbytes)}
                     if dname == "float32" else {})
            record({
                "phase": "kernel", "kernel": "flash_attention",
                "shape": f"B{B} Sq{Sq} Sk{Sk} Hq{Hq} Hkv{Hkv} D{D} "
                         + ("causal" if causal else "non-causal"),
                "dtype": dname, **_held(out, want, dname),
                **_times(lambda: ops.flash_attention(q, k, v, **kw),
                         lambda: ref.flash_attention_ref(q, k, v, **kw),
                         lambda: F.scaled_dot_product_attention(
                             qt, kt, vt, is_causal=causal,
                             enable_gqa=True)),
                "library": f"scaled_dot_product_attention(is_causal="
                           f"{causal}, enable_gqa=True)",
                "bound_ms": b_ms, "bound_by": b_by, **b_ms3,
                "cluster": _fwd_cluster(B, Sq, Sk, Hq, Hkv, D, dname),
                "library_backend": _sdpa_backend(qt, kt, vt, causal)},
                main_path=False)
            del q, k, v, out, want, qt, kt, vt
        # K2 at qwen2-vl's and arctic's heads on phase 3's paged table
        # (their own stream): 4 rows of 160 tokens, 16-token pages
        for Hq, Hkv, D in k2:
            B, ctx, npag, ps = 4, 160, 10, 16
            P = B * npag + 1
            q = rand((B, 1, Hq, D), dtype, stream=stream)
            kp, vp = (rand((P, ps, Hkv, D), dtype, stream=stream)
                      for _ in "kv")
            perm = torch.randperm(P - 1, generator=gen,
                                  device=gen.device) + 1
            bt = perm.reshape(B, npag).to(torch.int32).contiguous()
            lens = torch.tensor([ctx, ctx - 1, ctx - 5, ctx - 15],
                                dtype=torch.int32, device=gen.device)
            out = ops.paged_attention(q, kp, vp, bt, lens)
            want = ref.paged_decode_attention_ref(q.float(), kp.float(),
                                                  vp.float(), bt, lens)
            b_ms, b_by = bound(*work.paged_decode(q, kp, lens, ps), dname)
            record({
                "phase": "kernel", "kernel": "paged_attention",
                "shape": f"B{B} ctx{ctx} ps{ps} Hq{Hq} Hkv{Hkv} D{D}",
                "dtype": dname, **_held(out, want, dname),
                **_times(lambda: ops.paged_attention(q, kp, vp, bt, lens),
                         lambda: ref.paged_decode_attention_ref(
                             q, kp, vp, bt, lens),
                         None),
                "library": "none: no single PyTorch call",
                "bound_ms": b_ms, "bound_by": b_by}, main_path=False)


def _wkv6_kernels(rand, record) -> None:
    """Phase 2c: B6 through ``ops.wkv6`` against ``wkv6_chunked_ref`` on
    the same inputs, and at T128 and T1100 against the exact recurrence."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref, work

    # (mode, B, T, H, K, V, decay); the first is rwkv6-3b's prefill
    cases = [("rwkv6", 1, 128, 40, 64, 64, "mild"),
             ("rwkv6", 1, 125, 40, 64, 64, "mild"),
             ("ssd", 1, 128, 25, 16, 64, "per_head"),
             ("ssd", 1, 1100, 25, 16, 64, "per_head"),
             ("rwkv6", 1, 4096, 40, 64, 64, "mild"),
             ("rwkv6", 1, 4096, 40, 64, 64, "strong")]
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        for mode, B, T, H, K, V, decay in cases:
            def draw(shape, dtype):
                return rand(shape, dtype, hymba=T == 1100)

            q, k = draw((B, T, H, K), dtype), draw((B, T, H, K), dtype)
            v = draw((B, T, H, V), dtype)
            if decay == "mild":      # rwkv6's init: w0 = -6, |ld| ~ 0.0025
                ld = -torch.exp(-6.0 + 0.5 * draw((B, T, H, K),
                                                  torch.float32))
            elif decay == "strong":  # |ld| ~ e^N(0,1): every chunk > 30
                ld = -torch.exp(draw((B, T, H, K), torch.float32))
            else:                    # SSD: softplus(dt) per head, broadcast
                ld = (-F.softplus(draw((B, T, H, 1), torch.float32))
                      ).expand(B, T, H, K)
            ld = ld.clamp(-12.0, -1e-4) if decay != "per_head" else ld
            u = (0.1 * draw((H, K), torch.float32) if mode == "rwkv6"
                 else None)
            before = dict(ops.LAUNCHES)
            o, s = ops.wkv6(q, k, v, ld, u)
            launched = ops.LAUNCHES["wkv6"] - before["wkv6"]
            want_o, want_s = ref.wkv6_chunked_ref(q, k, v, ld, u)
            errs = [_err(g, w) for g, w in ((o, want_o), (s, want_s))]
            rel = max(e / max(float(w.float().abs().max()), 1e-30)
                      for e, w in zip(errs, (want_o, want_s)))
            # operations as this run's decays need them (work.wkv6)
            b_ms, b_by = bound(*work.wkv6(q, v, ld, u), dname)
            share = float(work.wkv6_rescaled(ld, T).mean())
            line = {
                "phase": "kernel", "kernel": "wkv6",
                "shape": f"B{B} T{T} H{H} K{K} V{V} {mode}", "decay": decay,
                "rescaled_share": share, "dtype": dname,
                "launches_in_one_call": launched,
                "max_abs_err": max(errs), "rel_err": rel,
                "tol": TOL[dname],
                **_times(lambda: ops.wkv6(q, k, v, ld, u),
                         lambda: ref.wkv6_chunked_ref(q, k, v, ld, u), None),
                "library": "none: no PyTorch call computes chunked WKV",
                "bound_ms": b_ms, "bound_by": b_by}
            exact_ok = True
            if T in (128, 1100):
                ex_o, ex_s = ref.wkv6_ref(q, k, v, ld, u)
                ex = max(_err(g, w) / float(w.abs().max())
                         for g, w in ((o, ex_o), (s, ex_s)))
                exact_ok = ex <= EXACT_TOL[dname]
                line.update(exact_rel_err=ex, exact_tol=EXACT_TOL[dname],
                            matches_exact=exact_ok)
            record(line, main_path=(mode == "rwkv6" and T == 128
                                    and dname == "float32"))
            if not exact_ok:
                raise AssertionError(f"B6 disagrees with the exact "
                                     f"recurrence: {line}")
            del q, k, v, ld, o, s, want_o, want_s
        torch.cuda.empty_cache()


def _train_kernels(rand, record, shapes=TRAIN_ATTN, stream=None,
                   dtypes=("float32", "bfloat16")) -> None:
    """Phase 2b: kernels B2 (forward with lse), B3 (dq) and B4 (dk, dv)
    through their wrapper as the training path calls it: q, k and v that
    require grad go through ``ops.flash_attention`` (B2, with the lse rows
    it saves for the backward) and ``torch.autograd.grad`` of its output
    (B3 and B4, on the delta of the kernel's own o), each launched exactly
    once. o, lse, dq, dk and dv are held against the plain versions on the
    same inputs, at each shape of ``TRAIN_ATTN``. Times are of the
    launchers alone, B3 and B4 reading the plain forward's lse and delta
    = rowsum(dO * O). Bounds count the (q, k) pairs these inputs need, S
    (S + 1) / 2 per head causal and S^2 non-causal: 2, 3 and 4 products
    of D multiply-adds each (QK^T and PV; + dO V^T and ds K; + p^T dO and
    ds^T q), and every input read and output written once
    (``kernels/work.py``). Phase 11's lines pass their own shapes, stream
    and dtypes. Each line carries its launch's cluster (the C plan query:
    f32 B2 splits its key range and f32 B4 its GQA group where the grid
    underfills the card), and B4's the sum of the two kernels' times
    beside ATen's backward, which computes dq, dk and dv in one call."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build, ops, ref, work
    from repro_torch.kernels.flash_attention import (
        flash_attention_dkv_cuda, flash_attention_dq_cuda,
        flash_attention_lse_cuda)

    for dname in dtypes:
        dtype = getattr(torch, dname)
        for B, S, Hq, Hkv, D, causal in shapes:
            kw = dict(causal=causal, window=0)
            # whisper's lines from their own stream (6): the others keep
            # their inputs
            st = stream if stream is not None else 6 if D == 64 else 0
            q, do = (rand((B, S, Hq, D), dtype, stream=st) for _ in "qo")
            k, v = (rand((B, S, Hkv, D), dtype, stream=st) for _ in "kv")
            # the wrapper, differentiated as the training step does
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            before = dict(ops.LAUNCHES)
            o = ops.flash_attention(*leaves, **kw)
            lse = o.grad_fn.saved_tensors[4]    # the rows B2 saved
            dq, dk, dv = torch.autograd.grad(o, leaves, do)
            torch.cuda.synchronize()
            rose = {n: ops.LAUNCHES[n] - before[n] for n in ops.KERNELS}
            o, lse = o.detach(), lse.clone()
            del leaves
            o_ref, lse_ref = ref.flash_attention_lse_ref(q, k, v, **kw)
            delta = ref.attention_delta(o_ref, do)
            held = {
                "flash_attention_lse": ((o, lse), (o_ref, lse_ref)),
                "flash_attention_dq": ((dq,), (ref.flash_attention_dq_ref(
                    q, k, v, do, lse_ref, delta, **kw),)),
                "flash_attention_dkv": ((dk, dv), ref.flash_attention_dkv_ref(
                    q, k, v, do, lse_ref, delta, **kw)),
            }
            args = (q, k, v, do, lse_ref, delta)
            cases = {
                "flash_attention_lse": (
                    lambda: flash_attention_lse_cuda(q, k, v, **kw),
                    lambda: ref.flash_attention_lse_ref(q, k, v, **kw),
                    *work.flash_forward(q, k, lse=True, **kw)),
                "flash_attention_dq": (
                    lambda: flash_attention_dq_cuda(*args, **kw),
                    lambda: ref.flash_attention_dq_ref(*args, **kw),
                    *work.flash_dq(q, k, **kw)),
                "flash_attention_dkv": (
                    lambda: flash_attention_dkv_cuda(*args, **kw),
                    lambda: ref.flash_attention_dkv_ref(*args, **kw),
                    *work.flash_dkv(q, k, **kw)),
            }
            shape = (f"B{B} S{S} Hq{Hq} Hkv{Hkv} D{D} "
                     + ("causal" if causal else "non-causal"))
            lib_fwd, lib_bwd, lib_name = _attention_library(q, k, v, do,
                                                            causal)
            library = {"flash_attention_lse": (lib_fwd, lib_name[0]),
                       "flash_attention_dq": (lib_bwd, lib_name[1]),
                       "flash_attention_dkv": (lib_bwd, lib_name[1])}
            group_ms = 0.0
            plan_args = (B, S, S, Hq, Hkv, D, 0 if dname == "float32" else 1)
            for name, (kernel, plain, flops, nbytes) in cases.items():
                got, want = held[name]
                errs = [_err(g, w) for g, w in zip(got, want)]
                rel = max(e / max(float(w.float().abs().max()), 1e-30)
                          for e, w in zip(errs, want))
                b_ms, b_by = bound(flops, nbytes, dname)
                times = _times(kernel, plain, library[name][0])
                group_ms += times["kernel_ms"]
                line = {
                    "phase": "train_kernel", "kernel": name, "shape": shape,
                    "dtype": dname, "via": "ops.flash_attention + "
                                           "torch.autograd.grad",
                    "launches_in_one_call": rose[name],
                    "max_abs_err": max(errs),
                    "rel_err": rel, "tol": TOL[dname], **times,
                    "library": library[name][1],
                    "bound_ms": b_ms, "bound_by": b_by}
                if dname == "float32":
                    line["bound_3xtf32_ms"] = bound_3xtf32(flops, nbytes)
                line["cluster"] = _build.plan(
                    "flash_attention_fwd" if name == "flash_attention_lse"
                    else name, *plan_args)["cluster"]
                if name == "flash_attention_dkv":
                    line["b3_b4_ms"] = dq_ms + times["kernel_ms"]
                    line["aten_backward_ms"] = times["library_ms"]
                    line["b3_b4_over_aten"] = (line["b3_b4_ms"]
                                               / times["library_ms"])
                dq_ms = times["kernel_ms"]
                record(line, main_path=(S == TRAIN_SEQ and stream is None
                                        and dname == "float32"))
            if rose["flash_attention"]:
                raise AssertionError(f"the differentiated wrapper launched "
                                     f"K1: {rose} at {shape} {dname}")
            del held, o, lse, dq, dk, dv
            # SDPA forward + backward: the nearest library yardstick
            qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                          for t in (q, k, v))
            dot = do.transpose(1, 2).contiguous()

            def sdpa_fwd_bwd():
                o = F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=causal,
                                                   enable_gqa=True)
                torch.autograd.grad(o, (qt, kt, vt), dot)

            emit({"phase": "train_kernel_group", "shape": shape,
                  "dtype": dname, "b2_b3_b4_ms": group_ms,
                  "sdpa_fwd_bwd_ms": _eager_ms(sdpa_fwd_bwd),
                  "library": f"scaled_dot_product_attention(is_causal="
                             f"{causal}, enable_gqa=True) forward + "
                             "backward, eager"})
            del q, k, v, do, o_ref, lse_ref, delta, args, cases, qt, kt, vt
            del library, lib_fwd, lib_bwd
            torch.cuda.empty_cache()


def _attention_library(q, k, v, do, causal: bool = True) -> tuple:
    """PyTorch's own calls for B2's function and for B3 + B4's together
    on the same inputs, K and V expanded to the q heads and all four
    moved to (B, H, S, D) outside the timed calls: (forward fn, backward
    fn, their names). f32: the memory-efficient attention forward with its
    logsumexp rows and its backward; bf16: the flash-attention forward and
    backward. Timed by ``chip_smoke.py`` as yardsticks only; the port
    never calls them."""
    import torch
    aten = torch.ops.aten
    g = q.shape[2] // k.shape[2]
    qt, dot = (t.transpose(1, 2).contiguous() for t in (q, do))
    kt, vt = (t.transpose(1, 2).repeat_interleave(g, dim=1).contiguous()
              for t in (k, v))
    if q.dtype == torch.float32:
        def fwd():
            return aten._scaled_dot_product_efficient_attention(
                qt, kt, vt, None, True, 0.0, causal)
        o, lse, seed, offset = fwd()

        def bwd():
            return aten._scaled_dot_product_efficient_attention_backward(
                dot, qt, kt, vt, None, o, lse, seed, offset, 0.0,
                [True, True, True, False], causal)
        names = ("aten._scaled_dot_product_efficient_attention("
                 "compute_log_sumexp=True), K/V expanded to Hq",
                 "aten._scaled_dot_product_efficient_attention_backward: "
                 "dq, dk and dv together (B3 + B4), K/V expanded to Hq")
    else:
        def fwd():
            return aten._scaled_dot_product_flash_attention(
                qt, kt, vt, 0.0, causal)
        r = fwd()

        def bwd():
            return aten._scaled_dot_product_flash_attention_backward(
                dot, qt, kt, vt, r[0], r[1], r[2], r[3], r[4], r[5], 0.0,
                causal, r[6], r[7])
        names = ("aten._scaled_dot_product_flash_attention, K/V expanded "
                 "to Hq",
                 "aten._scaled_dot_product_flash_attention_backward: dq, dk "
                 "and dv together (B3 + B4), K/V expanded to Hq")
    return fwd, bwd, names


def _train_config(phase: str, backend: str):
    """The RunConfig of training phase ``phase`` (``TRAIN``): its arch at
    full width, cut to its depth, f32 (or its ``dtype``: bf16 params with
    an f32 master, f32 moments and f32 gradient sums), on the attention
    ``backend``;
    2 x 4096 tokens (whisper: 2 x 1500) in 2 microbatches with remat, lr
    1e-3, 2 warmup steps. Phases 6d's and 10d's reduced configs keep the
    reference's reduced widths (hymba's 64-token window and chunks of 16),
    at 2 x 128 tokens."""
    from repro_torch.configs import RunConfig, ShapeConfig, get_arch, reduced
    spec = TRAIN[phase]
    cfg = get_arch(spec["arch"])
    seq = spec.get("seq", TRAIN_SEQ)
    if phase.startswith(("6d", "10d")):
        cfg, seq = reduced(cfg, layers=spec["layers"]), REDUCED_TRAIN_SEQ
    elif spec["layers"]:
        cfg = dataclasses.replace(cfg, num_layers=spec["layers"])
    return RunConfig(
        model=cfg, shape=ShapeConfig("train", "train", seq, TRAIN_BATCH),
        microbatches=2, remat=True, attention_backend=backend,
        learning_rate=1e-3, warmup_steps=2, opt_state_dtype="float32",
        opt_master=True, param_dtype=spec.get("dtype", "float32"))


def _reference_metrics(rcfg, device, keep_grads: bool = False):
    """(params, batch) -> {"loss", "grad_norm"} of one training step of
    ``rcfg`` on ``device`` (params and batch copied there when they lie
    elsewhere), without its update: the reference a "forced" trajectory
    holds each step to; with ``keep_grads`` also "grads", the named
    leaves' gradients on the CPU."""
    import torch

    from repro_torch._tree import tree_map
    from repro_torch.optim.adamw import global_norm
    from repro_torch.runtime.steps import accumulate_grads, make_model

    model = make_model(rcfg, device=device)
    acc_dt = getattr(torch, rcfg.grad_accum_dtype)

    def metrics(params, batch):
        p = tree_map(lambda t: t.detach().to(device), params)
        b = {k: v.to(device) for k, v in batch.items()}
        grads, loss, _ = accumulate_grads(model, p, b, rcfg.microbatches,
                                          acc_dt)
        out = {"loss": float(loss), "grad_norm": float(global_norm(grads))}
        if keep_grads:
            out["grads"] = {n: t.cpu() for n, t in _named_leaves(grads)}
        return out
    return metrics


def _train_steps(rcfg, dev, params=None, reference=None) -> dict:
    """TRAIN_STEPS steps of ``rcfg`` on ``dev`` through
    ``build_train_step`` and ``train_loop.run``, from the seeded params
    (or a copy of ``params``) and SyntheticLM(seed=0) batches; before each
    step, ``reference`` (``_reference_metrics``) of the same params and
    batch. Returns the loop's metrics, the references', the run's and
    each step's kernel launches, the peak memory and the step, params and
    state for one more step."""
    import torch

    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.runtime import train_loop
    from repro_torch.runtime.steps import build_train_step

    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)     # the context exists before the reset
        torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev) if cuda else 0
    t0 = time.perf_counter()
    step, model, opt = build_train_step(rcfg, total_steps=TRAIN_STEPS,
                                        device=dev)
    if params is None:
        params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    else:
        params = tree_map(lambda t: t.to(dev, copy=True), params)
    opt_state = opt.init(params)
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    data = SyntheticLM(rcfg.model, TRAIN_BATCH, rcfg.shape.seq_len, seed=0,
                       device=str(dev))
    per_step, refs = [], []

    def batch_at(i):
        # the reference of step i, from the params the step will update in
        # place, before the loop starts the step's clock
        batch = data.batch_at(i)
        if reference is not None:
            refs.append(reference(params, batch))
        return batch

    def counted(p, o, batch):
        ops.reset_launches()
        out = step(p, o, batch)
        per_step.append(dict(ops.LAUNCHES))
        return out

    res = train_loop.run(counted, params, opt_state, batch_at,
                         total_steps=TRAIN_STEPS)
    # the steps' own launches (a reference may launch kernels between them)
    launches = {k: sum(c[k] for c in per_step) for k in ops.KERNELS}
    tokens = TRAIN_BATCH * rcfg.shape.seq_len
    return dict(
        res=res, refs=refs, launches=launches, per_step=per_step,
        setup_s=setup_s, held=held,
        peak=torch.cuda.max_memory_allocated(dev) if cuda else 0,
        n_params=sum(t.numel() for t in tree_leaves(params)),
        steps=[{**m, "tokens_per_s": tokens / m["step_s"],
                "launches": per_step[i]} for i, m in enumerate(res.metrics)],
        step=step, params=params, opt_state=opt_state, data=data)


def _memory_reckoning(n_params: int, rcfg) -> dict:
    """The bytes the training state needs before activations: the params
    (4 bytes a parameter in f32, 2 in bf16), the f32 gradient accumulator,
    the f32 master copy and two f32 AdamW moments (20 bytes a parameter in
    f32, 18 in bf16), plus one microbatch's gradients (the params'
    dtype)."""
    isz = 2 if rcfg.param_dtype == "bfloat16" else 4
    per = isz + 4 * (4 if rcfg.opt_master else 3)
    return {"params": n_params, "state_bytes_per_param": per,
            "state_bytes": per * n_params,
            "microbatch_grad_bytes": isz * n_params}


def _train(dev, phase: str) -> dict:
    """Training phases at full width (``TRAIN``): 6 (granite-3-8b, 8
    layers, "free": 6a's per-leaf gradients, then TRAIN_STEPS steps on the
    kernels and on the plain attention path from the same seeded params
    and batches), 6b (hymba-1.5b, all 32 layers, "forced": 6a's per-leaf
    gradients reported, each layer's gradients gated, TRAIN_STEPS steps
    on the kernels each held to the plain path's step from the same
    params), 6c (rwkv6-3b, 8 layers, "none": no port kernel runs on its
    path, LayerNorm and the plain chunked ssm form that training pins, so
    TRAIN_STEPS clean steps with finite metrics and every kernel's count
    at 0) and 10a (whisper-large-v3, 32 + 32 layers, "free", as 6, with the
    one-ulp comparison beside 6a's). Where kernels run: B3 and B4 at one
    launch per attention (``_attention_calls``) and microbatch, B2 in
    every step, K3 too where the model's norm is RMSNorm, B6 in none; one
    more kernel step
    under the profiler, and one more under the cost counter for the
    phase's Tier-1 report (``_tier1_report``), its counted kernel calls
    held to its launches. Returns the kernel run's launch counts and that
    report."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.cost import count_cost
    from repro_torch.core.profile import profile_device
    from repro_torch.kernels import ops

    spec = TRAIN[phase]
    arch, gate = spec["arch"], spec["gate"]
    if gate != "none":
        _train_grads(dev, phase, gated=gate == "free",    # 6a
                     one_ulp=spec.get("one_ulp", False))
    if gate == "forced":
        _layer_grads(dev, phase)
    reference = (_reference_metrics(_train_config(phase, "dense"), dev)
                 if gate == "forced" else None)
    runs = {}
    for backend in ("kernel", "dense") if gate == "free" else ("kernel",):
        rcfg = _train_config(phase, backend)
        run = _train_steps(rcfg, dev, reference=reference)
        # a bf16 run profiles the plain path too: its products' share
        if backend == "kernel" or spec.get("dtype") == "bfloat16":
            # one more step, traced, after the count; [1]: keep only the
            # summary, not the step's (params, state)
            prof = profile_device(lambda: run["step"](
                run["params"], run["opt_state"],
                run["data"].batch_at(TRAIN_STEPS)))[1]
            emit({"phase": "train_profile", "train_phase": phase,
                  "arch": arch, "backend": backend, "step": TRAIN_STEPS,
                  "param_dtype": rcfg.param_dtype,
                  "mfu_measured": _mfu_measured(rcfg, run["res"].metrics),
                  **prof})
        if backend == "kernel":
            # and one more, counted: the roofline of phase 8's report; each
            # kernel's counted calls equal its launches in that step
            ops.reset_launches()
            cost = count_cost(lambda: run["step"](
                run["params"], run["opt_state"],
                run["data"].batch_at(TRAIN_STEPS + 1)))[1]
            counted = {k: int(cost.kernels.get(k, {}).get("calls", 0))
                       for k in ops.KERNELS}
            if counted != ops.LAUNCHES:
                raise AssertionError(f"{arch}: counted kernel calls "
                                     f"{counted} differ from launches "
                                     f"{ops.LAUNCHES}")
            tier1 = _tier1_report(phase, rcfg, run["res"].metrics, prof,
                                  cost)
        res = run["res"]
        emit({"phase": "train", "train_phase": phase, "backend": backend,
              "arch": arch, "layers": rcfg.model.num_layers,
              "param_dtype": rcfg.param_dtype,
              "reduced": (f"depth {rcfg.model.num_layers} of "
                          f"{get_arch(arch).num_layers} layers: "
                          f"{spec['cut']}"
                          if spec["cut"] else
                          "none: full width and full depth"),
              "memory_reckoning": _memory_reckoning(run["n_params"], rcfg),
              "params": run["n_params"], "batch": TRAIN_BATCH,
              "seq": rcfg.shape.seq_len, "microbatches": rcfg.microbatches,
              "remat": rcfg.remat, "setup_s": run["setup_s"],
              "allocated_before_bytes": run["held"],
              "retries": res.retries, "steps": run["steps"],
              "peak_memory_bytes": run["peak"],
              "launches": run["launches"]})
        runs[backend] = (res.metrics, run["refs"], run["launches"],
                         run["per_step"], res.retries)
        del run, res
        gc.collect()
        torch.cuda.empty_cache()

    km, refs, launches, per_step, k_retries = runs["kernel"]
    if len(km) != TRAIN_STEPS or k_retries:
        raise AssertionError(f"{arch} did not take {TRAIN_STEPS} clean "
                             f"steps: {km}, retries {k_retries}")
    if gate == "none":
        bad = [m for m in km if not (math.isfinite(m["loss"])
                                     and math.isfinite(m["grad_norm"]))]
        nonzero = {k: n for k, n in launches.items() if n}
        emit({"phase": "train_check", "train_phase": phase, "arch": arch,
              "steps": len(km), "finite": not bad,
              "launches": launches, "launches_expected": "0 for every "
              "kernel: LayerNorm, and the plain chunked ssm form"})
        if bad or nonzero:
            raise AssertionError(f"{arch}: non-finite steps {bad} or kernel "
                                 f"launches {nonzero}")
        return launches, tier1
    if gate == "free":
        dm, _, _, _, d_retries = runs["dense"]
        if len(dm) != TRAIN_STEPS or d_retries:
            raise AssertionError(f"{arch} on the plain path did not take "
                                 f"{TRAIN_STEPS} clean steps")
        _check_trajectories(phase, km, dm, "free: the plain path's own run")
    else:
        _check_trajectories(phase, km, refs, "forced: the plain path's step "
                            "from the kernel run's params, no update")
    rcfg = _train_config(phase, "kernel")
    off = _step_launch_problems(per_step, rcfg.model, rcfg.microbatches)
    if off:
        raise AssertionError(f"{arch} training steps' launches: {off}")
    return launches, tier1


def _norm_launches(cfg) -> tuple:
    """The norm's kernel on ``cfg``'s paths: (what they must launch, what
    they must not). K3 where the norm is RMSNorm; where it is LayerNorm
    (stablelm-12b) no K3, so that a norm routed through K3 by mistake
    shows."""
    k3 = ("rmsnorm",)
    return (k3, ()) if cfg.norm == "rmsnorm" else ((), k3)


def _engine_launch_problems(arch: str, cfg, launches: dict,
                            on_card: bool) -> list:
    """What ``_serve_family``'s runs (``launches``: ``<arch>:<engine>`` ->
    kernel -> launches) break: on the card K1 in the continuous engine, K2
    in the paged one and the norm's kernel in both (``_norm_launches``);
    anywhere, a kernel the norm rules out in any run."""
    need, none = _norm_launches(cfg)
    return [f"{name} launched no {k}"
            for name, kernels in (("continuous", ("flash_attention", *need)),
                                  ("paged", ("paged_attention", *need)))
            for k in kernels
            if on_card and launches[f"{arch}:{name}"][k] <= 0] + [
        f"{path} launched {k} {counts[k]} times on a {cfg.norm} model"
        for path, counts in launches.items() for k in none if counts[k]]


def _step_launch_problems(per_step: list, cfg, microbatches: int) -> list:
    """What a training run's per-step launch counts (``per_step``: one
    dict a step, kernel -> launches) break: B2, B3 and B4 in every step,
    and the norm's kernel (``_norm_launches``); B3 and B4 once per
    attention (``_attention_calls``) and microbatch; no K1 (the training
    forward is B2), no B6, and none the norm rules out."""
    norm_need, norm_none = _norm_launches(cfg)
    need = ("flash_attention_lse", "flash_attention_dq", "flash_attention_dkv",
            *norm_need)
    none = ("flash_attention", "wkv6", *norm_none)
    per_layer = _attention_calls(cfg) * microbatches
    return [f"step {i} launched no {k}" for i, c in enumerate(per_step)
            for k in need if c[k] < 1] + [
        f"step {i} launched {k} {c[k]} times, not {per_layer}"
        for i, c in enumerate(per_step)
        for k in ("flash_attention_dq", "flash_attention_dkv")
        if c[k] != per_layer] + [
        f"step {i} launched {k} {c[k]} times" for i, c in enumerate(per_step)
        for k in none if c[k]]


def _attention_calls(cfg) -> int:
    """Full-sequence attention calls in one forward of ``cfg``: one a
    decoder layer; an encoder-decoder's encoder layers and cross
    attention add one a layer each."""
    return cfg.num_layers + (cfg.encoder_layers + cfg.num_layers
                             if cfg.is_enc_dec else 0)


def _tier1_report(phase: str, rcfg, metrics: list, prof: dict,
                  cost) -> dict:
    """The Tier-1 report (``core/profiler.py``) of training phase
    ``phase`` on one H100 in its params' dtype: sections of its config at
    the phase's
    2 x seq tokens, the roofline of one counted step (``cost``), and the
    measured part from the phase's own run: its median step seconds and
    the profiled step's device summary (``prof``)."""
    import statistics

    from repro_torch.configs import MeshConfig, ShapeConfig
    from repro_torch.core.profiler import profile
    shape = ShapeConfig("train", "train", rcfg.shape.seq_len, TRAIN_BATCH)
    step_s = statistics.median(m["step_s"] for m in metrics)
    rep = profile(rcfg.model, shape, MeshConfig((1, 1)), cost=cost,
                  measured={"step_s": step_s, **prof},
                  dtype=rcfg.param_dtype)
    return {"train_phase": phase, **rep.to_dict(), "counted": cost.to_dict()}


def _mfu_measured(rcfg, metrics: list) -> float:
    """Model flops of a training phase's step over the H100's peak for its
    params' dtype times its median step seconds (``core/profiler.py``'s
    ``mfu_measured``)."""
    import statistics

    from repro_torch.configs import MeshConfig, ShapeConfig
    from repro_torch.core.profiler import profile
    shape = ShapeConfig("train", "train", rcfg.shape.seq_len, TRAIN_BATCH)
    step_s = statistics.median(m["step_s"] for m in metrics)
    rep = profile(rcfg.model, shape, MeshConfig((1, 1)),
                  measured={"step_s": step_s}, dtype=rcfg.param_dtype)
    return rep.to_dict()["measured"]["mfu_measured"]


def _mfu_problems(where: str, mfu, mfu_measured, useful, arch: str) -> list:
    """Phase 8's gates on one training step: no MFU above MFU_CEILING (no
    card beats its peak); the useful share of the counted FLOPs at most
    USEFUL_CEILING (above it the counter missed work the model must do)
    and, for granite, above GRANITE_USEFUL_FLOOR."""
    out = [f"{where}: {name} {v} > {MFU_CEILING}"
           for name, v in (("mfu", mfu), ("mfu_measured", mfu_measured))
           if v is not None and v > MFU_CEILING]
    if useful is None or useful > USEFUL_CEILING:
        out.append(f"{where}: useful_flops_ratio {useful} > "
                   f"{USEFUL_CEILING} or missing")
    elif arch == ARCH and useful <= GRANITE_USEFUL_FLOOR:
        out.append(f"{where}: useful_flops_ratio {useful} <= "
                   f"{GRANITE_USEFUL_FLOOR}")
    return out


def _tier1_problems(report: dict) -> list:
    """``_mfu_problems`` of one training phase's Tier-1 report."""
    rl = report.get("roofline") or {}
    return _mfu_problems(f"tier1 {report.get('train_phase')}",
                         rl.get("mfu"),
                         report.get("measured", {}).get("mfu_measured"),
                         rl.get("useful_flops_ratio"), report["arch"])


def _bench_problems(records: list, failures: list) -> list:
    """Phase 8's gates on the harness's run: no scenario failed; every
    scenario of BENCH_SCENARIOS gave records, efficiency/measured one per
    depth of BENCH_LAYERS; ``_mfu_problems`` of roofline/measured."""
    out = [f"{name}: {err}" for name, err in failures]
    ok = [r for r in records if r.status == "ok"]
    for scen in BENCH_SCENARIOS:
        if not any(r.scenario == scen for r in ok):
            out.append(f"{scen}: no record")
    got = {r.name for r in ok}
    out += [f"efficiency/layers{L}/measured: no record" for L in BENCH_LAYERS
            if f"efficiency/layers{L}/measured" not in got]
    for r in ok:
        if r.scenario == "roofline/measured":
            d = r.derived
            out += _mfu_problems(r.name, d.get("mfu"), d.get("mfu_measured"),
                                 d.get("useful_flops_ratio"), r.arch)
    return out


def _bench(dev, tier1: dict) -> None:
    """Phase 8: the port's harness through its own API on the card (the
    structural suites, efficiency/measured and roofline/measured), one
    line of its records, one of the sections of the training phases'
    archs at train_4k on one H100 in f32, one per Tier-1 report of the
    training phases; fails on any of ``_bench_problems`` and
    ``_tier1_problems``."""
    import repro_torch.bench.suites  # noqa: F401  (registers the scenarios)
    from repro_torch.bench import (BenchRunner, ListSink, env_fingerprint,
                                   select)
    from repro_torch.configs import SHAPES, MeshConfig, get_arch
    from repro_torch.core import sections
    from repro_torch.core.roofline import H100

    t0 = time.perf_counter()
    sink = ListSink()
    summary = BenchRunner(sinks=[sink], env=env_fingerprint(str(dev))).run(
        select(only=",".join(BENCH_SCENARIOS)))
    emit({"phase": "bench", "seconds": time.perf_counter() - t0,
          "failures": summary.failures,
          "records": [{"name": r.name, "status": r.status,
                       "us_per_call": r.us_per_call, "derived": r.derived}
                      for r in sink.records]})
    problems = _bench_problems(sink.records, summary.failures)
    emit({"phase": "sections", "shape": "train_4k", "mesh": "1x1",
          "dtype": "float32", "chip": H100.name,
          "by_arch": {arch: {m: sections.analyze(
              get_arch(arch), SHAPES["train_4k"], MeshConfig((1, 1)), m,
              H100, "float32").to_dict() for m in ("O0", "O1", "O3")}
              for arch in TIER1_ARCHS}})
    for phase, report in tier1.items():
        emit({"phase": "tier1", **report})
        problems += _tier1_problems(report)
    if problems:
        raise AssertionError(f"phase 8 failed: {problems}")


def _serve_suite(dev, use_reduced: bool = False) -> dict:
    """Phase 9: the port's serving suite (``repro_torch.bench``'s
    ``serving/*``, the nine Tier-2 scenarios) through the harness's runner
    on ``dev``, on the suite's one parameter set (granite-3-8b at full
    width and depth, f32; ``use_reduced``: the reference's reduced cell,
    for tests on the CPU). Every launch count is set to 0 before each
    scenario and read after it. One line per record; then the prefix
    cache's copy-on-write run (``_cow_run``) and the gates
    (``_serving_problems``), with the prefix-cached engines' shared pages
    held to their bytes by ``SharedPageWatch``. Returns the counts per
    scenario, keyed ``serving:<scenario>``."""
    import repro_torch.bench.suites  # noqa: F401  (registers the scenarios)
    from repro_torch._tree import tree_leaves
    from repro_torch.bench import BenchRunner, ListSink, env_fingerprint, select
    from repro_torch.bench.__main__ import with_device
    from repro_torch.bench.suites import serving
    from repro_torch.kernels import ops
    from repro_torch.serving.roles import sync

    device = dev.type
    t0 = time.perf_counter()
    leaves = tree_leaves(serving._params(device, use_reduced))
    sync(dev)
    emit({"phase": "serving_weights", "arch": serving.ARCH,
          "reduced": use_reduced,
          "params": sum(t.numel() for t in leaves), "dtype": "float32",
          "bytes": sum(t.numel() * t.element_size() for t in leaves),
          "init_s": time.perf_counter() - t0})
    watch = SharedPageWatch()
    for span, pages in ((serving.BURST_SPAN, serving.BURST_PAGES),
                        (serving.REPLAY_SPAN, serving.REPLAY_PAGES)):
        watch.attach(serving._prefix_engine(True, span, pages, device,
                                            use_reduced)[0])
    env = env_fingerprint(device)
    launches, failures = {}, []
    for scen in select(only=",".join(SERVING_SCENARIOS)):
        sink = ListSink()
        t_s = time.perf_counter()
        ops.reset_launches()
        scen = with_device(scen, device)
        if use_reduced:
            scen = dataclasses.replace(scen, workloads=tuple(
                dataclasses.replace(wl, knobs={**wl.knobs, "reduced": True})
                for wl in scen.workloads))
        failures += BenchRunner(sinks=[sink], env=env).run([scen]).failures
        launches[f"serving:{scen.name}"] = dict(ops.LAUNCHES)
        for r in sink.records:
            emit({"phase": "serving", "scenario": scen.name,
                  "name": r.name, "status": r.status, "ttft_us": r.ttft_us,
                  "p50_us": r.p50_us, "p95_us": r.p95_us,
                  "derived": r.derived})
        emit({"phase": "serving_scenario", "scenario": scen.name,
              "seconds": time.perf_counter() - t_s,
              "launches": launches[f"serving:{scen.name}"]})
    cow = _cow_run(serving, device, use_reduced)
    problems = _serving_problems(serving.REPORTS, failures, cow, watch)
    emit({"phase": "serving_gates", "seconds": time.perf_counter() - t0,
          "shared_page_checks": watch.checks,
          "shared_pages_watched": watch.watched,
          "cow_cached_prompt_tokens": cow["cached"],
          "problems": problems})
    if problems:
        raise AssertionError(f"phase 9 failed: {problems}")
    return launches


class SharedPageWatch:
    """Holds the KV pages a prefix-cached paged engine shares to their
    bytes (phase 9's gate 2: the port writes its pools in place). Wraps
    the engine's chunked prefill and pool step: a warm prefill from
    ``start`` attaches its block table's first ``start // page_size``
    pages read-only; a page's checksum (over both pools, on the device) is
    taken when it is first attached, and after every prefill chunk and
    every decode step each watched page that a live block table (a decode
    lane's or the prefill's) still holds must give the same checksum. A
    page that no table holds may be evicted and reissued: it leaves the
    watch until it is attached again."""

    def __init__(self) -> None:
        self.sums = {}           # (engine id, page) -> checksum
        self.checks = 0          # page comparisons made
        self.watched = 0         # pages ever recorded
        self.violations = []     # (page, when)

    def attach(self, eng) -> None:
        prefill, step = eng._chunked_prefill, eng._pool_step
        lanes = {}

        def live(extra=()):
            held = set(extra)
            state = lanes.get("state")
            if state is not None:
                held.update(int(p) for p in state["btab"].unique().tolist())
            held.discard(0)
            return held

        def chunked_prefill(prompt, btab_dev, clock, *, start=0):
            shared = [int(p) for p in
                      btab_dev[0, :start // eng.page_size].tolist()]
            new = [p for p in shared if (id(eng), p) not in self.sums]
            for p, c in zip(new, self._sums(eng, new)):
                self.sums[id(eng), p] = c
            self.watched += len(new)
            self._check(eng, live(shared), "before a warm prefill")
            out = prefill(prompt, btab_dev, clock, start=start)
            self._check(eng, live(shared), "after a prefill")
            return out

        def pool_step(params, caches, state, gen):
            lanes["state"] = state
            held = live()        # the tables this step reads and writes
            out = step(params, caches, state, gen)
            self._check(eng, held, "after a decode step")
            return out

        eng._chunked_prefill = chunked_prefill
        eng._pool_step = pool_step

    @staticmethod
    def _sums(eng, pages) -> list:
        """A position-weighted sum of each page's bits over both pools."""
        import torch
        if not pages:
            return []
        out = []
        for pool in eng._caches["layers"].values():
            idx = torch.as_tensor(pages, device=pool.device)
            bits = pool[:, idx].transpose(0, 1).reshape(len(pages), -1)
            bits = bits.contiguous().view(torch.int32).to(torch.int64)
            w = torch.arange(1, bits.shape[1] + 1, device=pool.device)
            out.append((bits * w).sum(1))
        return [tuple(x) for x in torch.stack(out, 1).tolist()]

    def _check(self, eng, held: set, when: str) -> None:
        mine = [p for (e, p) in self.sums if e == id(eng)]
        for p in mine:
            if p not in held:
                del self.sums[id(eng), p]
        kept = [p for p in mine if p in held]
        for p, c in zip(kept, self._sums(eng, kept)):
            self.checks += 1
            if c != self.sums[id(eng), p]:
                self.violations.append((p, when))


def _cow_run(serving, device: str, use_reduced: bool) -> dict:
    """The prefix cache's copy-on-write path: the shared burst plus rid 8
    re-sending rid 0's prompt at t=1 (the whole prompt cached, so its last
    matched page is copied before the one-token prefill), through the
    suite's burst engines with the cache off and on. Returns each side's
    greedy tokens per rid and the cached prompt tokens per rid."""
    from repro_torch.serving import Request

    toks, cached = {}, {}
    for pc in (False, True):
        eng, cfg = serving._prefix_engine(pc, serving.BURST_SPAN,
                                          serving.BURST_PAGES, device,
                                          use_reduced)
        reqs = serving._shared_burst(cfg)
        reqs.append(Request(rid=8, prompt=reqs[0].prompt.copy(),
                            max_new_tokens=8, arrival_s=1.0))
        rep = eng.run(reqs)
        toks[pc] = _tokens_of(rep)
        cached = {m.rid: m.cached_prompt_tokens for m in rep.metrics}
    return {"tokens": toks, "cached": cached,
            "prompt_len": len(reqs[0].prompt)}


def _tokens_of(report) -> dict:
    return {m.rid: [int(t) for t in m.tokens] for m in report.metrics
            if m.tokens is not None}


def _serving_problems(reports: dict, failures: list, cow: dict,
                      watch: "SharedPageWatch") -> list:
    """Phase 9's gates on the suite's reports (record name -> ServeReport):
    no scenario failed; (1) prefix parity: greedy tokens equal per rid
    with the cache on and off on the shared burst, the multi-turn replay
    and the copy-on-write run (whose rid 8 must have taken the
    copy-on-write path), higher peak concurrency with the cache and
    prefill tokens saved; (2) no shared page changed while shared, with
    pages checked; (3) chaos parity: every scheduled fault injected and
    recovered, no page leaked on either record, and every request that
    completes under chaos token-identical to the fault-free run; (4) P/D
    parity: tokens equal per rid across the interleaved and the
    disaggregated engine, one handoff per request that reached decode,
    and a strictly lower decode-step p95 stall disaggregated."""
    from repro_torch.serving import FaultPlan

    out = [f"{name}: {err}" for name, err in failures]
    need = ("prefix_burst_off", "prefix_burst_on", "replay_off", "replay_on",
            "chaos_off", "chaos_on", "pd_interleaved", "pd_disaggregated")
    missing = [n for n in need if f"serving/{n}" not in reports]
    if missing:
        return out + [f"no report of serving/{n}" for n in missing]
    rep = {n: reports[f"serving/{n}"] for n in need}
    tok = {n: _tokens_of(r) for n, r in rep.items()}
    for a, b in (("prefix_burst_off", "prefix_burst_on"),
                 ("replay_off", "replay_on"),
                 ("pd_interleaved", "pd_disaggregated")):
        if tok[a] != tok[b]:
            out.append(f"greedy tokens differ between {a} and {b}")
    if cow["tokens"][False] != cow["tokens"][True]:
        out.append("greedy tokens differ with the cache on the "
                   "copy-on-write run")
    if cow["cached"].get(8) != cow["prompt_len"] - 1:
        out.append(f"rid 8 took no copy-on-write path: {cow['cached']}")
    if not (rep["prefix_burst_on"].peak_concurrency
            > rep["prefix_burst_off"].peak_concurrency):
        out.append("peak_concurrency not higher with the prefix cache")
    if not rep["prefix_burst_on"].prefill_tokens_saved > 0:
        out.append("prefix cache on, no prefill tokens saved")
    if watch.violations or not watch.checks:
        out.append(f"shared pages changed {watch.violations} "
                   f"({watch.checks} checks)")
    planned = len(FaultPlan.default(0).faults)
    on = rep["chaos_on"]
    if not on.faults_injected == on.fault_recoveries == planned:
        out.append(f"faults injected/recovered {on.faults_injected}/"
                   f"{on.fault_recoveries} of {planned}")
    for n in ("chaos_off", "chaos_on"):
        if rep[n].pages_leaked:
            out.append(f"{n}: {rep[n].pages_leaked} pages leaked")
    for m in on.metrics:
        if m.outcome == "completed" and (
                tok["chaos_on"][m.rid] != tok["chaos_off"].get(m.rid)):
            out.append(f"chaos rid {m.rid}: tokens differ from fault-free")
    dis = rep["pd_disaggregated"]
    decoded = sum(1 for m in dis.metrics if m.decode_worker >= 0)
    if not dis.handoffs == decoded == len(dis.handoff_latencies_s) > 0:
        out.append(f"{dis.handoffs} handoffs for {decoded} requests that "
                   "reached decode")
    p95 = {n: rep[n].summary().get("decode_stall_p95_s", 0.0)
           for n in ("pd_interleaved", "pd_disaggregated")}
    if not p95["pd_disaggregated"] < p95["pd_interleaved"]:
        out.append(f"decode-step p95 stall not lower disaggregated: {p95}")
    return out


def _train_tol(phase: str, f32_tol: float) -> float:
    """A training phase's tolerance: ``f32_tol`` for f32 params, the bf16
    tolerance of ``tests/test_kernels.py::_tol`` (TOL) for bf16."""
    if TRAIN[phase].get("dtype") == "bfloat16":
        return TOL["bfloat16"]
    return f32_tol


def _check_trajectories(phase: str, km: list, dm: list, against: str) -> None:
    """Per-step loss and grad_norm of a run (``km``) and its reference
    (``dm``), relative to the reference; those of ``TRAIN[phase]["held"]``
    within TRAIN_TOL (``_train_tol``)."""
    held = TRAIN[phase]["held"]
    tol = {k: _train_tol(phase, t) for k, t in TRAIN_TOL.items()}
    rel = {key: [abs(a[key] - b[key]) / abs(b[key]) for a, b in zip(km, dm)]
           for key in TRAIN_TOL}
    parity = {"phase": "train_parity", "train_phase": phase,
              "arch": TRAIN[phase]["arch"], "against": against,
              "steps": len(km), "losses": [m["loss"] for m in km],
              "losses_reference": [m["loss"] for m in dm],
              "grad_norms": [m["grad_norm"] for m in km],
              "grad_norms_reference": [m["grad_norm"] for m in dm],
              "rel_diff": rel, "held": held, "tol": tol}
    emit(parity)
    if len(dm) != len(km) or any(max(rel[key]) > tol[key] for key in held):
        raise AssertionError(f"phase {phase}: trajectories disagree: {parity}")


def _train_on_cpu_too(dev, phase: str) -> dict:
    """Phases 6d and 10d: the reduced arch of ``phase`` trained TRAIN_STEPS
    steps on the card through the kernels from params initialised on the
    CPU from a seeded generator, each step held ("forced") to the same step
    on this machine's CPU through the kernels' plain versions, from the same
    params and batch: each leaf's gradient within GRAD_TOL, the metrics of
    ``TRAIN[phase]["held"]`` within TRAIN_TOL. The CPU side is what the
    tier-1 tests hold to the JAX package. Returns the card run's launch
    counts."""
    import torch

    from repro_torch.runtime.steps import make_model

    rcfg = _train_config(phase, "kernel")
    params = make_model(rcfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    on_card = _reference_metrics(rcfg, dev, keep_grads=True)
    on_cpu = _reference_metrics(rcfg, "cpu", keep_grads=True)
    leaves = []

    def reference(p, batch):
        # each leaf's gradient, card against CPU, at this step's params
        a, b = on_card(p, batch), on_cpu(p, batch)
        # the vision stub's embeds leave the token table's gradient 0
        rel = {n: float((a["grads"][n] - w).norm() / w.norm().clamp(
            min=1e-30)) for n, w in b["grads"].items()}
        worst = max(rel, key=rel.get)
        leaves.append({"max_rel_diff": rel[worst], "worst_leaf": worst})
        return {"loss": b["loss"], "grad_norm": b["grad_norm"]}

    card = _train_steps(rcfg, dev, params, reference=reference)
    arch = TRAIN[phase]["arch"]
    emit({"phase": "train", "train_phase": phase, "backend": "kernel",
          "arch": arch,
          "reduced": f"the reference's reduced {arch}: "
                     f"{rcfg.model.num_layers} layers, d_model "
                     f"{rcfg.model.d_model}"
                     + (f", window {rcfg.model.window}"
                        if rcfg.model.window else "")
                     + (f", chunks of {rcfg.model.ssm.chunk_size}"
                        if rcfg.model.ssm else "")
                     + (f", {rcfg.model.moe.num_experts} experts"
                        if rcfg.model.moe else ""),
          "params": card["n_params"], "batch": TRAIN_BATCH,
          "seq": rcfg.shape.seq_len, "retries": card["res"].retries,
          "steps": card["steps"], "launches": card["launches"]})
    if card["res"].retries or len(card["res"].metrics) != TRAIN_STEPS:
        raise AssertionError(f"phase {phase}: not {TRAIN_STEPS} clean steps")
    emit({"phase": "train_leaf_grads", "train_phase": phase, "arch": arch,
          "against": "the CPU's gradients at each step's params",
          "steps": leaves, "tol": GRAD_TOL})
    _check_trajectories(phase, card["res"].metrics, card["refs"],
                        "forced: the CPU's step from the card run's params, "
                        "no update")
    off = [(i, s) for i, s in enumerate(leaves)
           if not s["max_rel_diff"] <= GRAD_TOL]
    if off:
        raise AssertionError(f"phase {phase}: card and CPU gradients "
                             f"disagree at steps {off}")
    return card["launches"]


def _first_microbatch(rcfg, dev) -> dict:
    """Step 0's first microbatch of a training phase's batches."""
    from repro_torch.data.pipeline import SyntheticLM
    return {k: v[:TRAIN_BATCH // rcfg.microbatches] for k, v in SyntheticLM(
        rcfg.model, TRAIN_BATCH, rcfg.shape.seq_len, seed=0,
        device=str(dev)).batch_at(0).items()}


def _stacks_as_leaves(params) -> dict:
    """The params as the training step differentiates them: each leaf
    detached into one of its own, each layer of the decoder's (and an
    encoder-decoder's encoder's) stack a list entry of its own."""
    from repro_torch._tree import tree_map
    stacks = ("layers", "enc_layers")
    tree = {k: tree_map(lambda a: a.detach().requires_grad_(), v)
            for k, v in params.items() if k not in stacks}
    for k in stacks:
        if k in params:
            n = next(iter(_named_leaves(params[k])))[1].shape[0]
            tree[k] = [tree_map(lambda a: a[i].detach().requires_grad_(),
                                params[k]) for i in range(n)]
    return tree


def _train_grads(dev, phase: str, gated: bool = True,
                 one_ulp: bool = False) -> None:
    """Phase 6a (and 6b's and 10a's gradients): the gradient of every
    parameter leaf (each layer's slice its own leaf, as in the training
    step) at the seeded initial params on the first microbatch of step 0,
    through the kernels and through the plain attention path. Where
    ``gated``, every leaf's gradient must agree within GRAD_TOL
    (``_train_tol``), relative
    in L2 norm: a global loss or grad norm cannot see a gradient that is
    wrong in one leaf or only in direction. The leaves of
    ZERO_GRAD_LEAVES, whose gradient is zero in exact arithmetic, are held
    absolutely instead: each one's norm, on every path, within GRAD_TOL of
    the plain path's global gradient norm. With ``one_ulp``, also the
    plain path against itself with q moved one ulp up in every attention
    call (``_one_ulp_q``): what the model's depth makes of one rounding,
    reported beside."""
    import torch

    from repro_torch.runtime.steps import make_model

    rcfg = _train_config(phase, "kernel")
    cfg, n_mb = rcfg.model, rcfg.microbatches
    tol = _train_tol(phase, GRAD_TOL)
    models = {b: make_model(_train_config(phase, b), device=dev)
              for b in ("kernel", "dense")}
    params = models["kernel"].init_params(
        torch.Generator(device=dev).manual_seed(0))
    batch = _first_microbatch(rcfg, dev)
    grads, losses = {}, {}
    runs = [(b, m, False) for b, m in models.items()]
    if one_ulp:
        runs.append(("dense_q_one_ulp", models["dense"], True))
    for backend, model, nudged in runs:
        tree = _stacks_as_leaves(params)
        named = _named_leaves(tree)
        with _one_ulp_q(nudged):
            loss, _ = model.loss(tree, batch)
            # the vision stub's embeds bypass the token table
            g = torch.autograd.grad(loss, [t for _, t in named],
                                    allow_unused=True)
        grads[backend] = {n: torch.zeros_like(t) if x is None else x
                          for (n, t), x in zip(named, g)}
        losses[backend] = float(loss.detach())
        del tree, named, loss, g
    kg, dg = grads["kernel"], grads["dense"]
    # (rotary positions rotate bk by the key's position: no longer zero)
    zero = ([n for n in dg if n.endswith(ZERO_GRAD_LEAVES)]
            if cfg.rope not in ("rope", "mrope") else [])

    def rel_by_leaf(a):
        return {n: float((a[n] - dg[n]).norm() / dg[n].norm().clamp(
            min=1e-30)) for n in dg if n not in zero}

    def norm(g):
        return float(torch.stack([t.norm() for t in g.values()]).norm())

    rel = rel_by_leaf(kg)
    worst = max(rel, key=rel.get)
    # the zero-gradient leaves' norms over the plain path's global norm
    zero_norm = {n: max(float(a[n].norm()) for a in grads.values())
                 / norm(dg) for n in zero}
    z_worst = max(zero_norm, key=zero_norm.get, default=None)
    line = {"phase": "train_grads", "train_phase": phase,
            "arch": TRAIN[phase]["arch"], "layers": cfg.num_layers,
            "encoder_layers": cfg.encoder_layers,
            "tokens": rcfg.shape.seq_len * TRAIN_BATCH // n_mb,
            "leaves": len(rel), "losses": losses,
            "grad_norm": {"kernel": norm(kg), "dense": norm(dg)},
            "max_rel_diff": rel[worst], "worst_leaf": worst,
            "median_rel_diff": sorted(rel.values())[len(rel) // 2],
            "tol": tol, "gated": gated, "rel_diff_by_leaf": rel}
    if zero:
        line["zero_gradient_leaves"] = {
            "leaves": len(zero), "held": "norm over the global gradient "
            "norm, on every path, within tol",
            "max_norm_over_global": zero_norm[z_worst], "worst_leaf": z_worst,
            "max_rel_diff_kernel_vs_plain": max(
                float((kg[n] - dg[n]).norm() / dg[n].norm().clamp(min=1e-30))
                for n in zero)}
    if one_ulp:
        ulp = rel_by_leaf(grads["dense_q_one_ulp"])
        u_worst = max(ulp, key=ulp.get)
        line["plain_vs_plain_q_one_ulp"] = {
            "max_rel_diff": ulp[u_worst], "worst_leaf": u_worst,
            "median_rel_diff": sorted(ulp.values())[len(ulp) // 2]}
    emit(line)
    del grads, kg, dg, params, models
    gc.collect()
    torch.cuda.empty_cache()
    if gated and not rel[worst] <= tol:
        raise AssertionError(f"kernel and plain gradients disagree: leaf "
                             f"{worst} at {rel[worst]} > {tol}")
    if gated and zero and not zero_norm[z_worst] <= tol:
        raise AssertionError(f"a gradient that is zero in exact arithmetic "
                             f"is not: {line['zero_gradient_leaves']}")


class _one_ulp_q:
    """Within it (when ``on``), every plain attention call of the models
    (``models/attention.py``'s ``dense_attention``) gets q moved one ulp
    of its dtype away from zero: the smallest change of an input, to show
    what a model's depth makes of one rounding."""

    def __init__(self, on: bool) -> None:
        self.on = on

    def __enter__(self):
        if self.on:
            import torch

            from repro_torch.models import attention as attn_mod
            self.mod, self.orig = attn_mod, attn_mod.dense_attention

            def nudged(q, k, v, **kw):
                # the gradient passes through as through q itself; a bf16
                # value's bits plus one are the next value away from zero
                if q.dtype == torch.float32:
                    step = (torch.nextafter(q, q * 2) - q).detach()
                else:
                    qd = q.detach()
                    step = (qd.view(torch.int16) + 1).view(q.dtype) - qd
                return self.orig(q + step, k, v, **kw)

            attn_mod.dense_attention = nudged
        return self

    def __exit__(self, *exc) -> None:
        if self.on:
            self.mod.dense_attention = self.orig


def _layer_grads(dev, phase: str) -> None:
    """Phase 6b's gradient gate, a layer at a time: on step 0's first
    microbatch, each layer's gradients (its parameters and its input)
    through the kernels against the plain path's, both from the plain
    path's own input to the layer and its own gradient at the layer's
    output (the head's, then each layer's input gradient going down), each
    within GRAD_TOL relative in L2 norm. Held this way a layer's kernels
    are held at their own error, where the model's depth amplifies last-bit
    differences (6a's whole-model numbers, reported beside)."""
    import torch

    from repro_torch._tree import layer_at, tree_map
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import apply_norm, embed_tokens, lm_logits
    from repro_torch.runtime.steps import make_model

    rcfg = _train_config(phase, "kernel")
    cfg = rcfg.model
    models = {b: make_model(_train_config(phase, b), device=dev)
              for b in ("kernel", "dense")}
    plain = models["dense"]
    params = plain.init_params(torch.Generator(device=dev).manual_seed(0))
    batch = _first_microbatch(rcfg, dev)
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
    with torch.no_grad():
        xs = [embed_tokens(params["embed"], tokens)]
        for i in range(cfg.num_layers):
            xs.append(tfm.layer_apply(layer_at(params["layers"], i), xs[-1],
                                      cfg, plain.rt, positions)[0])
    # the plain path's gradient at the last layer's output: Model.loss's head
    x = xs[-1].requires_grad_()
    logits = lm_logits(params["embed"], apply_norm(params["final_norm"], x,
                                                   cfg.norm),
                       cfg.tie_embeddings, true_vocab=cfg.vocab_size).float()
    nll = (torch.logsumexp(logits, dim=-1) - logits.gather(
        -1, batch["labels"].long()[..., None])[..., 0]).mean()
    (g,) = torch.autograd.grad(nll, [x])
    del logits, nll, x
    per_layer = {}
    for i in reversed(range(cfg.num_layers)):
        got = {}
        for backend, model in models.items():
            p = tree_map(lambda a: a[i].detach().requires_grad_(),
                         params["layers"])
            xi = xs[i].detach().requires_grad_()
            y = tfm.layer_apply(p, xi, cfg, model.rt, positions)[0]
            named = _named_leaves({"input": xi, **p})
            got[backend] = dict(zip((n for n, _ in named), torch.autograd.grad(
                y, [t for _, t in named], g)))
        rel = {n: float((got["kernel"][n] - w).norm() / w.norm())
               for n, w in got["dense"].items()}
        worst = max(rel, key=rel.get)
        per_layer[i] = (worst, rel[worst])
        g = got["dense"]["input"]
        xs[i + 1] = None
        del got
    worst = max(per_layer, key=lambda i: per_layer[i][1])
    line = {"phase": "train_layer_grads", "train_phase": phase,
            "arch": TRAIN[phase]["arch"], "layers": cfg.num_layers,
            "max_rel_diff": per_layer[worst][1],
            "worst": f"layer {worst} {per_layer[worst][0]}", "tol": GRAD_TOL,
            "rel_diff_by_layer": {i: per_layer[i][1] for i in sorted(per_layer)}}
    emit(line)
    del xs, g, params, models
    gc.collect()
    torch.cuda.empty_cache()
    if not per_layer[worst][1] <= GRAD_TOL:
        raise AssertionError(f"kernel and plain layer gradients disagree: "
                             f"{line}")


def _named_leaves(tree, prefix: str = "") -> list:
    """[(dotted name, leaf)] of nested dicts and lists, in tree order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return [(prefix[:-1], tree)]
    return [kv for k, v in items for kv in _named_leaves(v, f"{prefix}{k}.")]


# ======================================================= 14 tuning, analysis
# phase 14: the card's attributes that core/roofline.py's H100 limits hold
# (cudaDeviceGetAttribute: MaxThreadsPerBlock, MaxGridDimX/Y/Z, WarpSize,
# MultiProcessorCount, MaxSharedMemoryPerMultiprocessor,
# MaxSharedMemoryPerBlockOptin, ReservedSharedMemoryPerBlock), and the
# fields of torch.cuda.get_device_properties that hold some of them where
# this torch has them
DEVICE_ATTRS = {"threads_per_block": (1,), "grid_x": (5,),
                "grid_yz": (6, 7), "warp": (10,), "sms": (16,),
                "smem_per_sm": (81,), "smem_per_block": (97,),
                "smem_reserved": (111,)}
DEVICE_PROPS = {"sms": "multi_processor_count",
                "threads_per_block": "max_threads_per_block",
                "smem_per_block": "shared_memory_per_block_optin",
                "smem_per_sm": "shared_memory_per_multiprocessor",
                "warp": "warp_size"}
# 14b's sweep shapes, the serving path's at full width: K2 at granite's
# decode (B, ctx, ps, Hq, Hkv, D, table pages), B6 at rwkv6-3b's layer
# (B, T, H, K, V, with u), K3 at 128 x 4096 (rows, d)
SWEEP_K2 = (4, 160, 16, 32, 8, 128, 10)
SWEEP_B6 = (1, 128, 40, 64, 64, True)
SWEEP_K3 = (128, 4096)
RESOLVE_CALLS = 10000       # 14c: warm resolver calls timed
PHASE14_S = 60              # 14's own time limit, in seconds


class LaunchRecorder:
    """What the launchers of ``kernels/*`` were called with, once per
    distinct (kernel, dims, launch parameter), recorded from the start of
    phase 2 to phase 14a: the shapes phases 2-13 launch each kernel at in
    this process. It wraps the launcher modules' functions, which the
    wrappers of ``kernels/ops.py`` look up at each call."""

    def __init__(self):
        self.seen = set()
        self._saved = []

    def _wrap(self, module, name, key):
        real = getattr(module, name)

        def launcher(*args, **kwargs):
            self.seen.add(key(*args, **kwargs))
            return real(*args, **kwargs)
        self._saved.append((module, name, real))
        setattr(module, name, launcher)

    def install(self):
        from repro_torch.kernels import (flash_attention, paged_attention,
                                         rmsnorm, wkv6)

        def attn(q, k, *rest, **kw):
            B, Sq, Hq, D = q.shape
            return ("flash_attention", (("B", B), ("Sq", Sq),
                                        ("Sk", k.shape[1]), ("Hq", Hq),
                                        ("Hkv", k.shape[2]), ("D", D),
                                        ("dtype", _dname(q))), None)

        def paged(q, kp, vp, bt, lens, splits=0):
            B, _, Hq, D = q.shape
            P, ps, Hkv, _ = kp.shape
            return ("paged_attention_fwd", (
                ("B", B), ("Hq", Hq), ("Hkv", Hkv), ("D", D), ("P", P),
                ("ps", ps), ("npag", bt.shape[1]), ("dtype", _dname(q))),
                ("splits", int(splits)))

        def wkv(q, k, v, ld, u, v_slice=0):
            B, T, H, K = q.shape
            return ("wkv6_fwd", (("B", B), ("T", T), ("H", H), ("K", K),
                                 ("V", v.shape[-1]), ("dtype", _dname(q)),
                                 ("ld", _dname(ld))),
                    ("v_slice", int(v_slice)))

        def norm(x2d, scale, eps, threads=0):
            rows, d = x2d.shape
            aligned = int((x2d.data_ptr() | scale.data_ptr()) % 16 == 0)
            return ("rmsnorm_fwd", (("rows", rows), ("d", d),
                                    ("dtype", _dname(x2d)),
                                    ("aligned", aligned)),
                    ("threads", int(threads)))

        for name in ("flash_attention_cuda", "flash_attention_lse_cuda",
                     "flash_attention_dq_cuda", "flash_attention_dkv_cuda"):
            self._wrap(flash_attention, name, attn)
        self._wrap(paged_attention, "paged_attention_cuda", paged)
        self._wrap(wkv6, "wkv6_cuda", wkv)
        self._wrap(rmsnorm, "rmsnorm_cuda", norm)
        return self

    def remove(self):
        for module, name, real in reversed(self._saved):
            setattr(module, name, real)
        self._saved.clear()


def _dname(t) -> str:
    return str(t.dtype).split(".")[1]


def limits_problems(limits, attrs: dict, props: dict,
                    max_cluster: int) -> list:
    """Where ``core/roofline.py``'s H100 launch limits differ from the
    card's attributes (``DEVICE_ATTRS`` -> values), from its
    ``get_device_properties`` fields (``DEVICE_PROPS``, those this torch
    has) or from the largest portable cluster K2 takes."""
    out = []
    for field, values in attrs.items():
        want = getattr(limits, field)
        if any(v != want for v in values):
            out.append(f"{field}: H100 {want}, attribute {values}")
    for field, value in props.items():
        if value != getattr(limits, field):
            out.append(f"{field}: H100 {getattr(limits, field)}, "
                       f"get_device_properties {value}")
    if max_cluster < limits.cluster:
        out.append(f"cluster: H100 {limits.cluster}, K2's largest "
                   f"{max_cluster}")
    return out


def plan_problems(records, query) -> tuple:
    """(problems, plans checked): at each recorded launch (kernel, dims,
    launch parameter), the lint's plan with the heuristic's mirror equals
    the C plan query of the launch of today (the parameter 0: the C
    heuristic) field by field, the wrapper passed the mirror's value (no
    tuned cache), and the lint finds nothing. ``query(name, *args)`` is the
    C plan query (``_build.plan``)."""
    from repro_torch.analysis import kernel_lint

    problems, n = [], 0
    for kernel, dims, passed in sorted(records, key=repr):
        dims = dict(dims)
        config = kernel_lint.default_config(kernel, dims)
        if passed is not None and config != dict([passed]):
            problems.append(f"{kernel} {dims}: passed {passed}, the "
                            f"heuristic's mirror {config}")
        for p in kernel_lint.plans(kernel, dims, config):
            n += 1
            args = p.query_args
            if kernel != "flash_attention":
                args = args[:-1] + (0,)
            c_plan = query(p.query, *args)
            if c_plan != p.launch():
                problems.append(f"{p.kernel} {dims}: C {c_plan}, lint "
                                f"{p.launch()}")
        findings = kernel_lint.check_config(kernel, dims, config)
        problems += [str(f) for f in findings]
    return problems, n


def _tuning_and_analysis(dev, recorder) -> None:
    """Phase 14 (after phase 9, before the kernels line; no earlier phase
    sees a tuned cache). 14a: the H100 launch limits against the card;
    at every launch phases 2-13 made (``recorder``) the C plan query of
    today's launch equals the lint's plan with the heuristic's mirror, and
    ``check_defaults`` is clean. 14b: K2 at every split count, B6 at every
    V slice, K3 at every thread count their ``*_candidates`` give at the
    path shapes (``SWEEP_*``), f32 and bf16, each held to its plain version
    by phase 2's gates, deterministic, its plan query equal to the lint's,
    with its device ms and bound. 14c: ``tune/*`` through the harness
    with ``REPRO_TUNED_DIR`` a fresh directory (cleared and reset after),
    each winner resolved, launched once by an ``ops`` call at its shape
    (the launcher's argument, the plan query and a counter) and equal to
    the plain version, ``check_all`` clean on the new cache, the
    resolvers' warm cost per call. 14d: ``graph_audit`` on CUDA tensors
    clean."""
    import ctypes
    import shutil
    import tempfile

    import torch

    from repro_torch.analysis import graph_audit, kernel_lint
    from repro_torch.kernels import _build, tuning
    from repro_torch.core.roofline import H100

    t_phase = time.perf_counter()
    lim = H100.limits
    # ---------------------------------------------------------------- 14a
    attrs = {}
    for field, codes in DEVICE_ATTRS.items():
        values = []
        for code in codes:
            v = ctypes.c_int(0)
            _build.check(_build.library().repro_device_attribute(
                code, ctypes.byref(v)), "device attribute")
            values.append(v.value)
        attrs[field] = tuple(values)
    props_obj = torch.cuda.get_device_properties(dev)
    props = {f: getattr(props_obj, name)
             for f, name in DEVICE_PROPS.items() if hasattr(props_obj, name)}
    clusters = _k2_clusters(8)
    problems = limits_problems(lim, attrs, props, clusters[1])
    if clusters[0] <= 0:
        problems.append(f"K2 at 8 splits: no cluster resident ({clusters})")
    recorder.remove()
    plan_bad, n_plans = plan_problems(recorder.seen, _build.plan)
    static = kernel_lint._build_static()
    defaults = [str(f) for f in kernel_lint.check_defaults()]
    line = {"phase": "14a", "attributes": attrs, "properties": props,
            "k2_clusters_at_8": clusters, "limits_problems": problems,
            "launch_shapes": len(recorder.seen), "plans_checked": n_plans,
            "plan_problems": plan_bad[:20], "n_plan_problems": len(plan_bad),
            "static_smem": {f"{k} {d}": v for (k, d), v in static.items()},
            "check_defaults": defaults}
    emit(line)
    if problems or plan_bad or defaults:
        raise AssertionError(f"phase 14a failed: {line}")

    # ---------------------------------------------------------------- 14b
    _sweep_lines(dev)

    # ---------------------------------------------------------------- 14c
    saved = os.environ.get(tuning.ENV_VAR)
    tdir = Path(tempfile.mkdtemp(prefix=".tune-", dir=ROOT / "build"))
    os.environ[tuning.ENV_VAR] = str(tdir)
    tuning.clear_cache()
    try:
        _tuned_winners(dev)
    finally:
        if saved is None:
            os.environ.pop(tuning.ENV_VAR, None)
        else:
            os.environ[tuning.ENV_VAR] = saved
        tuning.clear_cache()
        shutil.rmtree(tdir, ignore_errors=True)

    # ---------------------------------------------------------------- 14d
    t0 = time.perf_counter()
    findings = graph_audit.audit_all(device=dev)
    # the audit sees this process's CUDA operations: a planted host read
    # and a planted copy to the host are flagged
    x = torch.ones(4, device=dev)
    planted = {rule: sorted({f.rule for f in graph_audit.audit_function(
        "planted", fn, x)}) for rule, fn in (
            ("RG001", lambda t: t * float(t.sum().item())),
            ("RG005", lambda t: t.cpu() + t.sum().to("cpu")))}
    line = {"phase": "14d", "findings": [str(f) for f in findings],
            "planted": planted, "seconds": time.perf_counter() - t0}
    emit(line)
    if findings or planted != {"RG001": ["RG001"], "RG005": ["RG005"]}:
        raise AssertionError(f"phase 14d failed: {line}")
    emit({"phase": "14", "seconds": time.perf_counter() - t_phase,
          "limit_s": PHASE14_S})


def _k2_clusters(splits: int) -> tuple:
    """(clusters of ``splits`` blocks resident at once, K2's largest
    portable cluster) at 14b's K2 shape in f32."""
    import ctypes

    from repro_torch.kernels import _build
    B, ctx, ps, Hq, Hkv, D, npag = SWEEP_K2
    out = (ctypes.c_int64 * 2)()
    _build.check(_build.library().repro_paged_attention_clusters(
        B, B * npag + 1, ps, Hq, Hkv, D, npag, 0, splits,
        ctypes.addressof(out)), "paged_attention clusters")
    return int(out[0]), int(out[1])


def _sweep_inputs(kernel: str, dtype, dev, dims: dict):
    """Seeded inputs of one kernel at ``dims`` on ``dev``: the arguments
    of its ``ops`` wrapper."""
    import torch
    g = torch.Generator(device=dev).manual_seed(14)

    def rand(*shape, dt=dtype):
        return torch.randn(shape, generator=g, device=dev).to(dt)

    if kernel == "paged_attention_fwd":
        B, P, ps, npag = dims["B"], dims["P"], dims["ps"], dims["npag"]
        q = rand(B, 1, dims["Hq"], dims["D"])
        kp, vp = (rand(P, ps, dims["Hkv"], dims["D"]) for _ in range(2))
        if B * npag <= P - 1:      # each row its own pages
            bt = (torch.randperm(P - 1, generator=g, device=dev) + 1)[
                :B * npag].reshape(B, npag)
        else:                      # the reference's table: any pages
            bt = torch.randint(1, P, (B, npag), generator=g, device=dev)
        bt = bt.to(torch.int32).contiguous()
        ctx = dims.get("ctx", npag * ps)
        lens = torch.tensor([max(1, ctx - i) for i in (0, 1, 5, 15)][:B]
                            + [ctx] * max(0, B - 4), dtype=torch.int32,
                            device=dev)
        return (q, kp, vp, bt, lens)
    if kernel == "wkv6_fwd":
        B, T, H, K, V = (dims[k] for k in ("B", "T", "H", "K", "V"))
        q, k = rand(B, T, H, K), rand(B, T, H, K)
        v = rand(B, T, H, V)
        # rwkv6's init (phase 2c's "mild" decay): w0 = -6, |ld| ~ 0.0025
        ld = -torch.exp(-6.0 + 0.5 * rand(B, T, H, K, dt=torch.float32))
        ld = ld.clamp(-12.0, -1e-4)
        u = 0.1 * rand(H, K, dt=torch.float32) if dims.get("u") else None
        return (q, k, v, ld.to(getattr(torch, dims.get("ld", "float32"))),
                u)
    return (rand(dims["rows"], dims["d"]),
            rand(dims["d"], dt=torch.float32))


def _plain(kernel: str, args):
    """The plain version of a kernel's wrapper on ``args`` (in f32 for
    bf16 inputs, as phase 2's gates take it) and its call."""
    from repro_torch.kernels import ref
    if kernel == "paged_attention_fwd":
        q, kp, vp, bt, lens = args
        return (ref.paged_decode_attention_ref(q.float(), kp.float(),
                                               vp.float(), bt, lens),
                lambda: ref.paged_decode_attention_ref(*args))
    if kernel == "wkv6_fwd":
        return (ref.wkv6_chunked_ref(*args),
                lambda: ref.wkv6_chunked_ref(*args))
    x, scale = args
    return (ref.rmsnorm_ref(x.float(), scale),
            lambda: ref.rmsnorm_ref(x, scale))


def _call(kernel: str, args, value=None):
    from repro_torch.kernels import ops
    if kernel == "paged_attention_fwd":
        return ops.paged_attention(*args, splits=value)
    if kernel == "wkv6_fwd":
        return ops.wkv6(*args, v_slice=value)
    return ops.rmsnorm(*args, threads=value)


_OPS_NAME = {"paged_attention_fwd": "paged_attention", "wkv6_fwd": "wkv6",
             "rmsnorm_fwd": "rmsnorm"}


def _held_line(kernel: str, out, want, dname: str) -> dict:
    """Phase 2's gate of a kernel's output: B6 by its error over the plain
    result's largest magnitude (output and state), K2 and K3 by
    ``_held``; with "ok"."""
    if kernel == "wkv6_fwd":
        errs = [_err(g, w) for g, w in zip(out, want)]
        rel = max(e / max(float(w.float().abs().max()), 1e-30)
                  for e, w in zip(errs, want))
        return {"max_abs_err": max(errs), "rel_err": rel,
                "tol": TOL[dname], "ok": rel <= TOL[dname]}
    line = _held(out, want, dname)
    ok = (line["max_ulp_err"] <= line["ulp_tol"] if "max_ulp_err" in line
          else line["max_abs_err"] <= line["tol"])
    return {**line, "ok": ok}


def _same(a, b) -> bool:
    import torch
    if isinstance(a, tuple):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def _sweep_dims(dname: str) -> dict:
    B, ctx, ps, Hq, Hkv, D, npag = SWEEP_K2
    Bw, T, H, K, V, u = SWEEP_B6
    rows, d = SWEEP_K3
    return {
        "paged_attention_fwd": dict(B=B, Hq=Hq, Hkv=Hkv, D=D, P=B * npag + 1,
                                    ps=ps, npag=npag, ctx=ctx, dtype=dname),
        "wkv6_fwd": dict(B=Bw, T=T, H=H, K=K, V=V, u=int(u), dtype=dname,
                         ld="float32"),
        "rmsnorm_fwd": dict(rows=rows, d=d, dtype=dname)}


def _candidates_at(kernel: str, dims: dict):
    from repro_torch.bench import tune
    if kernel == "paged_attention_fwd":
        return tune.paged_candidates(dims["B"], dims["Hq"], dims["Hkv"],
                                     dims["D"], dims["P"], dims["ps"],
                                     dims["npag"], dims["dtype"])
    if kernel == "wkv6_fwd":
        return tune.wkv6_candidates(dims["B"], dims["T"], dims["H"],
                                    dims["K"], dims["V"], dims["dtype"],
                                    dims["ld"])
    return tune.rmsnorm_candidates(dims["rows"], dims["d"], dims["dtype"])


def _sweep_lines(dev) -> None:
    """14b: each candidate of each kernel at the path shape, in f32 and
    bf16, against the plain version, twice (the same bits), with its plan
    query against the lint's plan, its device ms and its bound."""
    import torch

    from repro_torch.analysis import kernel_lint
    from repro_torch.kernels import _build, ops, tuning, work

    failures = []
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        for kernel, dims in _sweep_dims(dname).items():
            args = _sweep_inputs(kernel, dtype, dev, dims)
            want, plain = _plain(kernel, args)
            plain_ms = _time_ms(plain)[0]
            if kernel == "paged_attention_fwd":
                flops, nbytes = work.paged_decode(args[0], args[1], args[4],
                                                  dims["ps"])
            elif kernel == "wkv6_fwd":
                flops, nbytes = work.wkv6(args[0], args[2], args[3], args[4])
            else:
                flops, nbytes = work.rmsnorm(dims["rows"], dims["d"],
                                             args[0].element_size())
            b_ms, b_by = bound(flops, nbytes, dname)
            cands, rejected, dflt = _candidates_at(kernel, dims)
            param = tuning.PARAMS[kernel]
            for cfg in cands:
                value = cfg[param]
                before = ops.LAUNCHES[_OPS_NAME[kernel]]
                out = _call(kernel, args, value)
                again = _call(kernel, args, value)
                launched = ops.LAUNCHES[_OPS_NAME[kernel]] - before
                plan = kernel_lint.plans(kernel, dims, cfg)[0]
                c_plan = _build.plan(plan.query, *plan.query_args)
                line = {"phase": "14b", "kernel": _OPS_NAME[kernel],
                        "shape": {k: v for k, v in dims.items()
                                  if k != "dtype"},
                        "dtype": dname, param: value,
                        "heuristic": cfg == dflt,
                        **_held_line(kernel, out, want, dname),
                        "deterministic": _same(out, again),
                        "launches": launched, "plan": c_plan,
                        "plan_held": c_plan == plan.launch(),
                        "ms": _time_ms(lambda: _call(kernel, args,
                                                     value))[0],
                        "plain_ms": plain_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "rejected": rejected}
                line["ok"] = (line["ok"] and line["deterministic"]
                              and line["plan_held"] and launched == 2)
                emit(line)
                if not line["ok"]:
                    failures.append(line)
            del args, want
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"phase 14b failed: {failures}")


def _tuned_winners(dev) -> None:
    """14c: ``tune/*`` through the harness's runner on the card, then each
    winner resolved and launched at its shape, ``check_all`` on the new
    cache, and the resolvers' warm cost."""
    import torch

    import repro_torch.bench.suites  # noqa: F401  (registers the scenarios)
    from repro_torch.analysis import kernel_lint
    from repro_torch.bench import BenchRunner, ListSink, env_fingerprint, select
    from repro_torch.bench.__main__ import with_device
    from repro_torch.kernels import _build, ops, tuning

    t0 = time.perf_counter()
    sink = ListSink()
    summary = BenchRunner(sinks=[sink], env=env_fingerprint("cuda")).run(
        [with_device(s, "cuda") for s in select(only="tune/")])
    problems = [f"{n}: {e}" for n, e in summary.failures]
    if not tuning.cache_path().is_file():
        problems.append("the sweeps wrote no cache")
    recorder = LaunchRecorder().install()
    winners = []
    try:
        for rec in sink.records:
            d = rec.derived
            kernel = {v: k for k, v in _OPS_NAME.items()}[
                rec.name.split("/")[1]]
            dims = kernel_lint.sig_dims(kernel, d["signature"])
            param = tuning.PARAMS[kernel]
            winner = rec.knobs[param]
            dtype = getattr(torch, dims["dtype"])
            args = _sweep_inputs(kernel, dtype, dev, dims)
            resolved = _resolve(kernel, dims, args)
            recorder.seen.clear()
            before = ops.LAUNCHES[_OPS_NAME[kernel]]
            out = _call(kernel, args)
            launched = ops.LAUNCHES[_OPS_NAME[kernel]] - before
            passed = [p for _, _, p in recorder.seen]
            plan = kernel_lint.plans(kernel, dims, {param: winner})[0]
            c_plan = _build.plan(plan.query, *plan.query_args)
            want, _ = _plain(kernel, args)
            line = {"phase": "14c", "record": rec.name, param: winner,
                    "tuned_us": d["tuned_us"], "default_us": d["default_us"],
                    "speedup": d["speedup"], "timings": d["timings"],
                    "n_candidates": d["n_candidates"],
                    "rejected_smem": d["rejected_smem"],
                    "resolved": resolved, "passed": passed,
                    "launches": launched, "plan": c_plan,
                    "plan_held": c_plan == plan.launch(),
                    **_held_line(kernel, out, want, dims["dtype"])}
            line["ok"] = (line["ok"] and resolved == winner
                          and passed == [(param, winner)] and launched == 1
                          and line["plan_held"])
            emit(line)
            if not line["ok"]:
                problems.append(line)
            winners.append((rec.name, kernel, dims, args))
    finally:
        recorder.remove()
    findings = [str(f) for f in kernel_lint.check_all()]
    us = {}
    for name, kernel, dims, args in winners:
        tuning.clear_cache()
        _resolve(kernel, dims, args)            # cold: loads the cache
        t1 = time.perf_counter()
        for _ in range(RESOLVE_CALLS):
            _resolve(kernel, dims, args)
        us[name] = (time.perf_counter() - t1) / RESOLVE_CALLS * 1e6
    line = {"phase": "14c", "records": len(sink.records),
            "cache_entries": len(json.loads(tuning.cache_path().read_text())
                                 ["entries"]) if tuning.cache_path().is_file()
            else 0,
            "check_all": findings, "resolve_us_per_call": us,
            "resolve_calls": RESOLVE_CALLS,
            "seconds": time.perf_counter() - t0}
    emit(line)
    if problems or findings or len(sink.records) != 7:
        raise AssertionError(f"phase 14c failed: {problems} {line}")


def _resolve(kernel: str, dims: dict, args) -> int:
    """What the wrapper resolves at ``args`` with no explicit value."""
    from repro_torch.kernels import tuning
    if kernel == "paged_attention_fwd":
        q, kp, _, bt, _ = args
        return tuning.resolve_paged_splits(
            None, q_shape=q.shape, pages_shape=kp.shape,
            n_pages=bt.shape[1], dtype=q.dtype)
    if kernel == "wkv6_fwd":
        q, _, v, ld, u = args
        return tuning.resolve_wkv_v_slice(
            None, q_shape=q.shape, v_head=v.shape[-1], dtype=q.dtype,
            use_u=u is not None, ld_dtype=ld.dtype)
    x, _ = args
    return tuning.resolve_rmsnorm_threads(None, rows=x.shape[0],
                                          d=x.shape[-1], dtype=x.dtype)


def _eager_ms(fn, iters: int = 5) -> float:
    """Device and host time of one eager call, CUDA events around a run of
    calls after a warm-up; for calls of milliseconds, where the host's
    share is small."""
    for _ in range(2):
        fn()
    return _events_ms(fn, iters)


def _err(out, want) -> float:
    import torch
    if out.is_cuda:
        torch.cuda.synchronize()
    return float((out.float() - want.float()).abs().max())


# Phase 2's bf16 gate: each bf16 output element against the plain version
# computed in f32 from the same bf16 inputs, in units of bf16's spacing at
# that element's own magnitude (2^(e-8) for |x| in [2^(e-1), 2^e)), at least
# ULP_FLOOR for outputs near zero. A kernel that computes in f32 and rounds
# once is within half a unit plus its f32 error; one unit is the gate.
ULP_TOL = 1.0
ULP_FLOOR = 2.0 ** -16


def _ulp_err(out, want) -> float:
    """max |out - want| in units of bf16 rounding at want's magnitude."""
    import torch
    w = want.float()
    _, e = torch.frexp(w)
    ulp = torch.ldexp(torch.ones_like(w), e - 8).clamp(min=ULP_FLOOR)
    ulp = torch.where(w == 0, ULP_FLOOR, ulp)   # frexp(0) gives e = 0
    return float(((out.float() - w).abs() / ulp).max())


def _held(out, want, dname: str) -> dict:
    """Phase 2's error fields: f32 outputs by the absolute error against
    the plain version (TOL), bf16 outputs in units of bf16 rounding against
    the plain version in f32 (``_ulp_err``)."""
    line = {"max_abs_err": _err(out, want)}
    if dname == "bfloat16":
        return {**line, "max_ulp_err": _ulp_err(out, want),
                "ulp_tol": ULP_TOL, "ulp_floor": ULP_FLOOR,
                "plain_in": "float32"}
    return {**line, "tol": TOL[dname]}


def _check_ulp_gate(out, want) -> None:
    """The bf16 gate catches an output two units off: each element of a
    kernel's bf16 output moved two representable values away from zero."""
    import torch
    off = (out.view(torch.int16) + 2).view(torch.bfloat16)
    err = _ulp_err(off, want)
    emit({"phase": "ulp_gate_check", "shifted_by_ulps": 2,
          "max_ulp_err": err, "ulp_tol": ULP_TOL, "caught": err > ULP_TOL})
    if not err > ULP_TOL:
        raise AssertionError(f"the bf16 gate missed an output 2 ulps off "
                             f"({err} <= {ULP_TOL})")


def _times(kernel, plain, library) -> dict:
    """Times of one call of the kernel's wrapper, its plain version and the
    library call (``None``: there is none)."""
    k_dev, k_call = _time_ms(kernel)
    return {"kernel_ms": k_dev, "kernel_call_ms": k_call,
            "plain_ms": _time_ms(plain)[0],
            "library_ms": _time_ms(library)[0] if library else None}


def _events_ms(fn, iters: int) -> float:
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _time_ms(fn) -> tuple:
    """(device ms, call ms) of one call of ``fn``, after a warm-up.

    The call time is CUDA events around a run of eager calls sized to take
    about 100 ms, so where the host's cost per call (Python, the argument
    checks, the launch) exceeds the device's, it measures the host. The
    device time replays a CUDA graph that captured the same run, which
    leaves the host out: it is what the card spends on the call's
    kernels."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):      # warm-up off the capture's stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    once = _events_ms(fn, 1)
    iters = int(min(200, max(5, 100.0 / max(once, 1e-3))))
    call = _events_ms(fn, iters)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    device = _events_ms(graph.replay, 3) / iters
    del graph
    return device, call


def _first_mismatch(a: dict, b: dict):
    for rid in sorted(a):
        x, y = a[rid], b.get(rid, [])
        for step in range(max(len(x), len(y))):
            if step >= len(x) or step >= len(y) or x[step] != y[step]:
                return rid, step
    return None


def _ptxas_summary(log: Path) -> list:
    """Registers, shared memory and spills per compiled kernel, from the
    ``-Xptxas -v`` report the build keeps."""
    if not log.is_file():
        return []
    out = []
    fn = None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
        elif fn and ("Used" in line or "spill" in line):
            out.append(f"{fn}: {line.split('info    :')[-1].strip()}")
    return out


ATTN_INSTANCE = re.compile(
    r"attn_(fwd|dq|dkv)_kernelI(f|13__nv_bfloat16)Li(\d+)E(?:Lb([01])E)?"
    r"(?:Lb([01])E)?")
ATTN_KERNEL = {"fwd": "K1/B2", "dq": "B3", "dkv": "B4"}
# the f32 D128 instances phase 1 requires on the tensor cores, unspilled:
# K1/B2's (unsplit, as rank of a cluster, with two warp groups), B3's, B4's
F32_FWD_D128 = ("K1/B2 float32 D128", "K1/B2 float32 D128 cluster",
                "K1/B2 float32 D128 halves")
F32_D128 = F32_FWD_D128 + ("B3 float32 D128", "B4 float32 D128",
                           "B4 float32 D128 cluster")
# K1/B2, B3 and B4 in bf16 at D64/D128: kernel, head dim, consumer
# warpgroups (64 rows each: q rows of K1/B2 and B3, key rows of B4)
WGMMA_INSTANCE = re.compile(r"attn_(fwd|dq|dkv)_kernel_wgmmaILi(\d+)ELi(\d+)E")
WGMMA_ROWS = {"fwd": "BQ", "dq": "BQ", "dkv": "BK"}
WGMMA_DIMS = (64, 128)
WGMMA_KERNELS = ("K1/B2", "B3", "B4")
# the decay type mangles as a substitution (S<n>_) when it repeats the input's
WKV6_INSTANCE = re.compile(
    r"wkv6_kernelI(f|13__nv_bfloat16)(f|13__nv_bfloat16|S\d*_)Li(\d+)E")
PAGED_INSTANCE = re.compile(r"paged_decode_kernelI(f|13__nv_bfloat16)Li(\d+)E")
RMSNORM_INSTANCE = re.compile(r"rmsnorm_kernelI(f|13__nv_bfloat16)Li(\d+)EE")


def _dtype_name(mangled_type: str) -> str:
    return "float32" if mangled_type == "f" else "bfloat16"


def _attn_instance(mangled: str):
    """The kernel instance a mangled name stands for, else None: 'B3
    float32 D128' (or 'K1/B2 ...', 'B4 ...') for the flash-attention
    kernels ('B4 float32 D128 cluster' for f32 B4's instance that splits
    its GQA group over a cluster, 'K1/B2 float32 D128 cluster' and '...
    halves' for f32 K1/B2's that split the key range over a cluster or
    two warp groups), 'K1/B2 bfloat16 D128 BQ128', 'B3
    bfloat16 D128 BQ128' and 'B4 bfloat16 D64 BK64' for their bf16 wgmma
    kernels (q rows a block, or key rows for B4), 'B6 float32 ld float32
    VS32' for B6 (input
    and decay types, V columns per block), 'K2 bfloat16 D<=128' for K2
    (the head dims the instance takes), 'K3 bfloat16 vec8' for K3
    (elements a load: 16 bytes' worth, or 1 for rows not on a 16-byte
    boundary)."""
    m = ATTN_INSTANCE.search(mangled)
    if m:
        kernel, dtype, d, cluster, halves = m.groups()
        return (f"{ATTN_KERNEL[kernel]} {_dtype_name(dtype)} D{d}"
                + (" cluster" if cluster == "1" else "")
                + (" halves" if halves == "1" else ""))
    m = WGMMA_INSTANCE.search(mangled)
    if m:
        kernel, d, nc = m.groups()
        return (f"{ATTN_KERNEL[kernel]} bfloat16 D{d} "
                f"{WGMMA_ROWS[kernel]}{64 * int(nc)}")
    m = WKV6_INSTANCE.search(mangled)
    if m:
        dtype, ld_dtype, nv = m.groups()
        ld_dtype = dtype if ld_dtype.startswith("S") else ld_dtype
        return (f"B6 {_dtype_name(dtype)} ld {_dtype_name(ld_dtype)} "
                f"VS{8 * int(nv)}")
    m = PAGED_INSTANCE.search(mangled)
    if m:
        dtype, nc = m.groups()
        return f"K2 {_dtype_name(dtype)} D<={128 * int(nc)}"
    m = RMSNORM_INSTANCE.search(mangled)
    if m:
        dtype, vec = m.groups()
        return f"K3 {_dtype_name(dtype)} vec{vec}"
    return None


def _cuobjdump() -> str:
    """The CUDA toolkit's cuobjdump, beside nvcc."""
    from repro_torch.kernels import _build
    path = Path(_build.nvcc_path()).parent / "cuobjdump"
    if not path.is_file():
        raise AssertionError(f"no cuobjdump beside nvcc ({path})")
    return str(path)


# SASS opcodes phase 1 counts per instance, by lower-case name: warp-level
# mma.sync (HMMA), warpgroup wgmma (HGMMA), TMA tensor loads (UTMALDG) and
# cp.async (LDGSTS)
SASS_COUNTS = ("HMMA", "HGMMA", "UTMALDG", "LDGSTS")


def _count_sass(sass: str) -> dict:
    """Per instance (``_attn_instance``) of a ``cuobjdump -sass`` listing:
    the count of each opcode of SASS_COUNTS, keyed in lower case."""
    report, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = _attn_instance(m.group(1))
            if name:
                report[name] = {op.lower(): 0 for op in SASS_COUNTS}
            continue
        if name is None:
            continue
        m = re.search(r"\b(HMMA|HGMMA|UTMALDG|LDGSTS)\b", line)
        if m:
            report[name][m.group(1).lower()] += 1
    return report


def _wgmma_problems(attn: dict, kernel: str = "K1/B2") -> list:
    """What phase 1 finds wrong with one kernel's bf16 wgmma instances
    (``kernel`` of WGMMA_KERNELS: the forward K1/B2 by default, or B3, B4;
    bf16 at D64 and D128, each block size): missing, no HGMMA, no TMA
    loads, any HMMA or cp.async left, or spills."""
    out = []
    for d in WGMMA_DIMS:
        names = [n for n in attn if n.startswith(f"{kernel} bfloat16 D{d} ")]
        if not names:
            out.append(f"no {kernel} bfloat16 D{d} instance")
        for n in names:
            r = attn[n]
            if r.get("hgmma", 0) <= 0 or r.get("utmaldg", 0) <= 0:
                out.append(f"{n}: no HGMMA or no TMA load")
            if r.get("hmma", 0) or r.get("ldgsts", 0):
                out.append(f"{n}: HMMA or cp.async left")
            if r.get("spill_bytes", 1) != 0:
                out.append(f"{n}: spills")
    return out


def _f32_fwd_problems(attn: dict) -> list:
    """What phase 1 finds wrong with the f32 forward's instances (K1/B2 on
    mma.sync, every head dim, unsplit, as rank of a cluster and with two
    warp groups): one of F32_FWD_D128 missing, or any without HMMA or TMA
    loads, with cp.async left, or spilling."""
    names = [n for n in attn if n.startswith("K1/B2 float32 ")]
    out = [f"no {n} instance" for n in F32_FWD_D128 if n not in names]
    for n in names:
        r = attn[n]
        if r.get("hmma", 0) <= 0 or r.get("utmaldg", 0) <= 0:
            out.append(f"{n}: no HMMA or no TMA load")
        if r.get("ldgsts", 0):
            out.append(f"{n}: cp.async left")
        if r.get("spill_bytes", 1) != 0:
            out.append(f"{n}: spills")
    return out


def _head_dim_report(attn: dict, dims: tuple) -> dict:
    """Phase 1's report of the flash-attention instances (K1/B2, B3, B4;
    ``attn``: ``_attn_build_report``'s) at head dims ``dims``: name ->
    [registers, spilled bytes], in name order."""
    want = {f"D{d}" for d in dims}
    return {n: [a.get("registers"), a.get("spill_bytes")]
            for n, a in sorted(attn.items())
            if n.split()[0] in ("K1/B2", "B3", "B4")
            and n.split()[2] in want}


def _attn_build_report(lib: Path) -> dict:
    """Per instance of K1/B2, B3, B4, B6, K2 and K3 (``_attn_instance``): the
    HMMA, HGMMA, UTMALDG and LDGSTS instructions in the library's SASS
    (``cuobjdump -sass``, ``_count_sass``), and registers and spilled bytes
    from the build's ``-Xptxas -v`` report."""
    sass = subprocess.run([_cuobjdump(), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    report = _count_sass(sass)
    log = lib.parent / "build.log"
    name = None
    for line in log.read_text().splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?([^' ]+)", line)
        if m:
            name = _attn_instance(m.group(1))
            continue
        if name is None or name not in report:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            report[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[name]["registers"] = int(m.group(1))
    return dict(sorted(report.items()))


if __name__ == "__main__":
    sys.exit(main())
